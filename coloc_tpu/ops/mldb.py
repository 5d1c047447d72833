"""M-LDB binary descriptor (486 bits) + AKAZE main orientation.

Reference parity: the AKAZE-MLDB describer the reference's CPU path uses
(AKAZE.hpp:14-80, ComputeMLDBDescriptor — 486-bit Modified Local Difference
Binary). Semantics:

  - main orientation: dominant gradient direction — vector sums of (Lx, Ly)
    samples in a disc of radius 6*sigma, swept by a sliding 60-degree window,
    argmax window wins (KAZE/SURF style). Implemented as a 30-bin circular
    histogram built with one-hot matmuls (batched over keypoints).
  - descriptor: three grids (2x2, 3x3, 4x4) over a rotated square patch of
    half-size 5*sigma... each cell averages three channels (L, rotated Lx,
    rotated Ly); every cell PAIR per grid per channel contributes one
    comparison bit: (6+36+120)*3 = 486 bits, zero-padded to 512 in the packed
    bank so the Hamming kernel is shared with TRIP-512.

Sampling rides the window + one-hot path
(ops/patches.sample_raster_flat): the L/Lx/Ly evolution rasters (plus
64-column-shifted copies, see akaze.py's window selection) stack into one
row-stacked buffer, one narrow 64x128 window per keypoint is sliced out,
and every disc/grid sample is a one-hot matmul column. Sample
reach fits the window: descriptor 5*sigma_px*sqrt(2) <= 19.1 px,
orientation disc 6*sigma_px <= 16.2 px (sigma_px in [1.6, 2.69] for every
octave's sublevels), both under the 26 px margin the window selection in
akaze.py guarantees.
"""

from __future__ import annotations

from typing import Tuple

import functools

import numpy as np
import jax.numpy as jnp

from coloc_tpu.ops.hamming import pack_bits

_ORI_BINS = 30
_PATCH_HALF = 5.0   # patch half-size in units of sigma
# sample points per cell axis: 4x4 per cell densely covers each MLDB cell at
# the NORMAL preset's sigma range (cells span ~3-8 px), approximating the
# reference's full-cell integer-pixel integration (AKAZE.hpp:29-78) within
# the diffusion smoothing scale while keeping a fixed shape
_CELL_SAMPLES = 4


def _disc_offsets(radius: float = 6.0, rings: int = 3):
    """Fixed disc sampling pattern (unit-sigma units), (P, 2) float32."""
    pts = [(0.0, 0.0)]
    for r in range(1, rings + 1):
        rad = radius * r / rings
        n = 8 * r
        for k in range(n):
            a = 2 * np.pi * k / n
            pts.append((rad * np.cos(a), rad * np.sin(a)))
    return np.asarray(pts, np.float32)


_DISC = _disc_offsets()


def orientation(
    sampler,                     # (lx, ly) -> (2, K, NS) Lx/Ly samples
    kp_x, kp_y, kp_sigma_px,     # (K,) level-local coords / sigma
    w_l, h_l,                    # (K,) level extents (float, for clamping)
    col0, row0_local,            # (K,) window origins (level-local)
) -> jnp.ndarray:
    """Dominant-gradient orientation per keypoint, (K,) radians.

    `sampler` is the window + one-hot sampling closure built
    by the caller (patches.sample_raster_flat over the Lx/Ly stack only —
    the orientation disc reaches 6*sigma <= 16.2 px, so the caller gives
    this pass NARROW 48-row 2-channel windows: the window DMA traffic is
    what dominates the sampling kernel at K=5000, and dropping L + 16 rows
    cuts it 3x vs sharing describe_mldb's 3-channel 64-row call).
    """
    disc = jnp.asarray(_DISC)                    # (P, 2)
    sx = kp_x[:, None] + kp_sigma_px[:, None] * disc[None, :, 0]
    sy = kp_y[:, None] + kp_sigma_px[:, None] * disc[None, :, 1]
    sx = jnp.clip(sx, 0.0, (w_l - 1.0)[:, None])
    sy = jnp.clip(sy, 0.0, (h_l - 1.0)[:, None])
    lx = sx - col0.astype(jnp.float32)[:, None]
    ly = sy - row0_local.astype(jnp.float32)[:, None]
    gx, gy = sampler(lx, ly)                     # (K, P)

    ang = jnp.arctan2(gy, gx)                    # (K, P)
    bins = jnp.floor((ang + jnp.pi) / (2 * jnp.pi) * _ORI_BINS).astype(jnp.int32)
    bins = jnp.clip(bins, 0, _ORI_BINS - 1)
    onehot = (bins[:, :, None] == jnp.arange(_ORI_BINS)[None, None, :]).astype(
        jnp.float32
    )                                            # (K, P, B)
    sum_x = jnp.einsum("kp,kpb->kb", gx, onehot)
    sum_y = jnp.einsum("kp,kpb->kb", gy, onehot)

    # sliding 60-degree window = 5 consecutive 12-degree bins (circular)
    def win(a):
        return sum(jnp.roll(a, -s, axis=1) for s in range(5))

    wx, wy = win(sum_x), win(sum_y)
    norm = wx * wx + wy * wy
    best = jnp.argmax(norm, axis=1)              # (K,)
    bx = jnp.take_along_axis(wx, best[:, None], axis=1)[:, 0]
    by = jnp.take_along_axis(wy, best[:, None], axis=1)[:, 0]
    return jnp.arctan2(by, bx)


@functools.lru_cache(maxsize=None)
def _grid_cells(cell_samples: int = _CELL_SAMPLES):
    """Static sample layout: per grid {2,3,4}, per cell, per sample point ->
    normalized patch coords in [-1, 1]. Returns (coords (N,2), cell_id (N,),
    pair tables per grid). `cell_samples` is the per-cell n x n sample grid
    (4 = the dense default; 3/2 trade descriptor robustness for a smaller
    sampling matmul)."""
    coords, cell_of = [], []
    cell_base = 0
    grids = []
    for g in (2, 3, 4):
        cells_this = []
        for cy in range(g):
            for cx in range(g):
                cid = cell_base + cy * g + cx
                cells_this.append(cid)
                for iy in range(cell_samples):
                    for ix in range(cell_samples):
                        u = (cx + (ix + 0.5) / cell_samples) / g * 2 - 1
                        v = (cy + (iy + 0.5) / cell_samples) / g * 2 - 1
                        coords.append((u, v))
                        cell_of.append(cid)
        pairs = []
        for a in range(len(cells_this)):
            for b in range(a + 1, len(cells_this)):
                pairs.append((cells_this[a], cells_this[b]))
        grids.append(pairs)
        cell_base += g * g
    all_pairs = [p for g in grids for p in g]  # 6 + 36 + 120 = 162 pairs
    return (
        np.asarray(coords, np.float32),
        np.asarray(cell_of, np.int64),
        np.asarray(all_pairs, np.int64),
        cell_base,
    )


def describe_mldb(
    sampler,                     # (lx, ly) -> (3, K, NS) L/Lx/Ly samples
    kp_x, kp_y, kp_sigma_px, kp_angle,
    w_l, h_l, col0, row0_local,
    cell_samples: int = _CELL_SAMPLES,
) -> jnp.ndarray:
    """-> (K, 16) uint32: 486 MLDB bits + 26 zero padding bits."""
    # ONE source of truth for the sample layout: the lru_cached per-
    # cell_samples tables (no module-level copies to drift from)
    _COORDS, _CELL_OF, _PAIRS, _NUM_CELLS = _grid_cells(cell_samples)
    coords = jnp.asarray(_COORDS)                       # (N, 2) in [-1,1]
    ca, sa = jnp.cos(kp_angle), jnp.sin(kp_angle)

    half = _PATCH_HALF * kp_sigma_px                    # (K,)
    u = coords[None, :, 0] * half[:, None]
    v = coords[None, :, 1] * half[:, None]
    rx = ca[:, None] * u - sa[:, None] * v
    ry = sa[:, None] * u + ca[:, None] * v
    sx = jnp.clip(kp_x[:, None] + rx, 0.0, (w_l - 1.0)[:, None])
    sy = jnp.clip(kp_y[:, None] + ry, 0.0, (h_l - 1.0)[:, None])
    lx = sx - col0.astype(jnp.float32)[:, None]
    ly = sy - row0_local.astype(jnp.float32)[:, None]

    L, Gx, Gy = sampler(lx, ly)                         # (K, N)
    # steered derivatives (rotate the gradient into the patch frame)
    Dx = ca[:, None] * Gx + sa[:, None] * Gy
    Dy = -sa[:, None] * Gx + ca[:, None] * Gy

    # cell means via one-hot matmul: (N, C) pooling matrix
    cell_onehot = (
        jnp.asarray(_CELL_OF)[:, None] == jnp.arange(_NUM_CELLS)[None, :]
    ).astype(jnp.float32)
    cell_onehot = cell_onehot / jnp.sum(cell_onehot, axis=0, keepdims=True)
    mL = L @ cell_onehot                                # (K, C)
    mX = Dx @ cell_onehot
    mY = Dy @ cell_onehot

    pa = jnp.asarray(_PAIRS[:, 0])
    pb = jnp.asarray(_PAIRS[:, 1])
    bits = jnp.concatenate(
        [
            mL[:, pa] > mL[:, pb],                      # (K, 162)
            mX[:, pa] > mX[:, pb],
            mY[:, pa] > mY[:, pb],
        ],
        axis=1,
    )                                                   # (K, 486)
    bits = jnp.pad(bits, ((0, 0), (0, 512 - bits.shape[1])))
    return pack_bits(bits)
