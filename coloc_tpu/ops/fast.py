"""FAST-9 corner detection, fully vectorized.

Reference parity: KFAST.h — multi-scale FAST-9 with (a) 2-of-4 cardinal
pretest, (b) >=9-consecutive-of-16 ring test, (c) per-corner score = max over
all 16 9-pixel arcs of the minimum absolute center deviation within the arc
(KFAST.h:272-376), (d) 3x3 non-max suppression (KFAST.h:464-496). The
reference parallelizes by row-sharding across CPU threads with AVX2; here the
whole image is one vector computation — the ring test is 16 shifted
comparisons and the consecutive-arc tests use a doubling (AND/MIN) cascade, so
the entire detector is ~150 elementwise ops that XLA fuses into a few passes.

The host-side std::vector keypoint accumulation becomes an exact top-k over
the masked score map (fixed capacity, SURVEY.md §7.1.2).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx)
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_ARC = 9  # FAST-9: at least 9 consecutive salient ring pixels


def _ring_stack(image: jnp.ndarray) -> jnp.ndarray:
    """(16, H, W): ring pixel k at each center (edges replicate-padded)."""
    padded = jnp.pad(image, 3, mode="edge")
    h, w = image.shape
    return jnp.stack(
        [padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in RING_OFFSETS]
    )


def _arc_min9(vals: jnp.ndarray) -> jnp.ndarray:
    """vals (16, H, W) -> (16, H, W): min over the 9-arc starting at k."""
    def rot(a, s):
        return jnp.roll(a, -s, axis=0)

    m2 = jnp.minimum(vals, rot(vals, 1))
    m4 = jnp.minimum(m2, rot(m2, 2))
    m8 = jnp.minimum(m4, rot(m4, 4))
    return jnp.minimum(m8, rot(vals, 8))


def fast_score_map(image: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Per-pixel FAST-9 corner score (0 where not a corner).

    Score = max over accepted arcs of (min |deviation| in arc) - the KFAST
    SIMD score semantics (max deviation sustaining the corner test).
    """
    ring = _ring_stack(image)
    dev = ring - image[None, :, :]

    # arc minimums double as the consecutive-9 test (min over the 9-arc of
    # dev > t <=> all 9 exceed t), and the per-arc threshold select folds
    # into one test on the max: max_s(arc_min[s]) > t <=> some arc qualifies,
    # and that max IS the best qualifying arc's score
    sb = jnp.max(_arc_min9(dev), axis=0)
    sd = jnp.max(_arc_min9(-dev), axis=0)
    score = jnp.maximum(sb, sd)
    score = jnp.where(score > threshold, score, 0.0)
    # kill the replicate-padded border (3 ring + safety)
    h, w = image.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inb = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return jnp.where(inb, score, 0.0)


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-max suppression; ties broken toward the top-left pixel."""
    h, w = score.shape
    p = jnp.pad(score, 1, mode="constant")
    stack = jnp.stack(
        [p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
         for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    )
    neighborhood_max = jnp.max(stack, axis=0)
    is_max = score >= neighborhood_max
    # strict-on-earlier-neighbors tie break: a pixel survives only if no
    # earlier (raster-order) neighbor has an equal score
    earlier = jnp.stack(
        [p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
         for (dy, dx) in ((-1, -1), (-1, 0), (-1, 1), (0, -1))]
    )
    tie_earlier = jnp.max(earlier, axis=0) >= score
    return jnp.where(is_max & ~tie_earlier, score, 0.0)


def top_k_sorted(x: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k along the last axis by one stable sort: (values, indices),
    values descending, ties to the lowest index (`lax.top_k`'s contract).

    A sort rather than `lax.top_k`/`approx_max_k`: on the GPU, XLA's TopK
    path exhausts the host's memory while compiling k ~ 1000 over the ~1.7M
    pixels of a stacked 752x480 pyramid raster; a sort compiles in seconds.
    """
    idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    neg, idx = jax.lax.sort((-x, idx), dimension=x.ndim - 1, num_keys=1,
                            is_stable=True)
    return -neg[..., :k], idx[..., :k]


def topk_keypoints(
    score: jnp.ndarray, k: int, border: int = 0
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Top-k peaks of a score map -> (x (k,), y (k,), score (k,), valid (k,))."""
    h, w = score.shape
    if border > 0:
        yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inb = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
        score = jnp.where(inb, score, 0.0)
    vals, idx = top_k_sorted(score.reshape(-1), k)
    y = (idx // w).astype(jnp.float32)
    x = (idx % w).astype(jnp.float32)
    valid = vals > 0
    return x, y, vals, valid


def subpixel_offsets(
    score: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Parabolic 3x3 subpixel offsets (dx, dy) on the (pre-NMS) score map.

    Integer FAST peaks carry ~0.5 px of grid-locked, *biased* localization
    error that does not average out across matches and visibly corrupts
    small-baseline translation direction (the AKAZE reference path refines
    subpixel for the same reason). Standard 1-D parabola per axis:
    dx = 0.5 (s[-1] - s[+1]) / (s[-1] - 2 s[0] + s[+1]), clamped to +-0.5.

    Returned as OFFSETS so callers on batched / stacked rasters can add them
    to image-local coordinates directly: `local + dy` is bit-identical for
    every batch position, while `(global + dy) - batch_offset` rounds in
    f32 at large row magnitudes (and occasionally flips a descriptor bit
    downstream of the nearest-sample rounding).
    """
    h, w = score.shape
    flat = score.reshape(-1)
    xi = jnp.clip(x.astype(jnp.int32), 1, w - 2)
    yi = jnp.clip(y.astype(jnp.int32), 1, h - 2)
    c = yi * w + xi

    s0 = flat[c]
    sl = flat[c - 1]
    sr = flat[c + 1]
    su = flat[c - w]
    sd = flat[c + w]

    def offset(minus, center, plus):
        denom = minus - 2.0 * center + plus
        off = 0.5 * (minus - plus) / jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
        return jnp.clip(off, -0.5, 0.5)

    return offset(sl, s0, sr), offset(su, s0, sd)


def subpixel_refine(
    score: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Refined absolute peak positions (see subpixel_offsets)."""
    dx, dy = subpixel_offsets(score, x, y)
    return x + dx, y + dy


def detect(
    image: jnp.ndarray, threshold: float, k: int, border: int = 0
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full single-level FAST: score -> NMS -> top-k -> subpixel refine."""
    score_raw = fast_score_map(image, threshold)
    score_nms = nms3(score_raw)
    x, y, s, v = topk_keypoints(score_nms, k, border)
    x, y = subpixel_refine(score_raw, x, y)
    return x, y, s, v
