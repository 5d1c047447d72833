"""Scale pyramid construction + box smoothing.

Reference parity: CUDALERP (src/CUDALERP.cu:153-183) — bilinear downscale of
the base image to 8 levels at 1.2x steps, one CUDA stream per level
(GPUDetector.hpp:250-255). Here the per-level resizes are just XLA ops in
one fused graph; the CPU/GPU overlap the reference needed (KFAST on host while
GPU resizes) disappears because detection also runs on device.

Level sizes are static functions of the config so everything stays jittable.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp


def level_shapes(
    height: int, width: int, num_levels: int, scale_factor: float
) -> List[Tuple[int, int]]:
    """Static (H_l, W_l) per level; level 0 is full resolution."""
    shapes = []
    for l in range(num_levels):
        f = scale_factor ** l
        shapes.append((max(int(round(height / f)), 8), max(int(round(width / f)), 8)))
    return shapes


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int):
    """Dense (n_out, n_in) bilinear resample matrix (numpy, trace-time const).

    Same sample positions as jax.image.resize(method="linear",
    antialias=False): output i samples input at (i+0.5)*n_in/n_out - 0.5,
    triangle kernel radius 1, edge clamped.
    """
    import numpy as np

    pos = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (pos - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.arange(n_out), lo), 1.0 - f)
    np.add.at(m, (np.arange(n_out), hi), f)
    return m


def resize_bilinear(image: jnp.ndarray, shape: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize via two dense matmuls (CUDALERP semantics).

    Two static-weight matmuls instead of jax.image.resize's gather-based
    path (~1 GFLOP for an 8-level 752x480 pyramid). HIGHEST precision keeps
    the resample exact in f32 (pixel values feed threshold comparisons
    downstream).
    """
    h, w = image.shape
    mh = jnp.asarray(_resize_matrix(h, shape[0]))
    mw = jnp.asarray(_resize_matrix(w, shape[1]))
    out = jnp.dot(mh, image, precision=jax.lax.Precision.HIGHEST)
    return jnp.dot(out, mw.T, precision=jax.lax.Precision.HIGHEST)


def build_pyramid(
    image: jnp.ndarray, num_levels: int, scale_factor: float
) -> List[jnp.ndarray]:
    """image (H, W) float32 -> list of (H_l, W_l) float32, bilinear resampled.

    Successive resampling: each level resizes from the PREVIOUS level, not
    from the base image — total resample work is a geometric series instead
    of num_levels full-resolution passes (and the mild extra low-pass per
    step is desirable for detection stability)."""
    h, w = image.shape
    shapes = level_shapes(h, w, num_levels, scale_factor)
    levels = [image]
    for l in range(1, num_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def build_pyramid_batch(
    images: jnp.ndarray, num_levels: int, scale_factor: float
) -> List[jnp.ndarray]:
    """(B, H, W) -> list of (B, H_l, W_l): build_pyramid with a batch axis
    (the resize matmuls batch trivially under vmap)."""
    _, h, w = images.shape
    shapes = level_shapes(h, w, num_levels, scale_factor)
    levels = [images]
    for l in range(1, num_levels):
        levels.append(
            jax.vmap(lambda im, s=shapes[l]: resize_bilinear(im, s))(
                levels[-1]
            )
        )
    return levels


def box_blur(image: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Separable box blur (descriptor pre-smoothing; replaces the implicit
    smoothing that patch-SSD comparisons give CLATCH). Edge-replicated."""
    k = 2 * radius + 1
    pad = ((radius, radius),)
    x = jnp.pad(image, pad + ((0, 0),), mode="edge")
    x = _running_mean(x, k, axis=0)
    x = jnp.pad(x, ((0, 0),) + pad, mode="edge")
    x = _running_mean(x, k, axis=1)
    return x


def _running_mean(x: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    """Mean over k consecutive entries along axis (output length n-k+1).

    Small k (the descriptor pre-smooth uses k=5): direct shifted adds — k-1
    adds, fully fusable. Large k: cumsum prefix difference.
    """
    n = x.shape[axis]
    if k <= 7:
        acc = jax.lax.slice_in_dim(x, 0, n - k + 1, axis=axis)
        for s in range(1, k):
            acc = acc + jax.lax.slice_in_dim(x, s, n - k + 1 + s, axis=axis)
        return acc / k
    csum = jnp.cumsum(x, axis=axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(csum, 0, 1, axis=axis))
    csum = jnp.concatenate([zero, csum], axis=axis)
    hi = jax.lax.slice_in_dim(csum, k, n + 1, axis=axis)
    lo = jax.lax.slice_in_dim(csum, 0, n - k + 1, axis=axis)
    return (hi - lo) / k
