"""Feature frontend: multi-scale detect + orient + describe, one jit graph.

Reference parity: GPUDetector.hpp detectAndDescribe (:216-291) — the KORAL
pipeline (CUDALERP pyramid -> KFAST per level -> featureAngle -> CLATCH 512
bits, 4 host<->device hops per frame). This design keeps the whole frontend
on device in a single trace:

  1. Pyramid + box pre-smooth (matmul resize, ops/pyramid.py).
  2. Levels stacked vertically into ONE raster (ops/patches.stack_levels) so
     FAST + NMS is a single pass and keypoint selection is a single exact
     top-k (ops/fast.top_k_sorted) over the whole stacked score map — not 8
     per-level top-k calls.
  3. Per-keypoint (64, 256) patches sliced from the smoothed stack (one
     descriptor-aligned window per keypoint); orientation moments and the
     steered TRIP-512 sample pool both read the patches through the one-hot
     sampling path (ops/patches.py).

Keypoint coords are rescaled to full resolution by scale_factor**level
exactly like GPUDetector.hpp:172-182 (coords *1.2^s).

Output is a fixed-capacity `Features` bank (max_keypoints entries + validity
mask), the device-friendly replacement for AKAZE_Binary_Regions.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from coloc_tpu.config import DetectorOptions
from coloc_tpu.ops import descriptor as desc_ops
from coloc_tpu.ops import fast as fast_ops
from coloc_tpu.ops import orientation as orient_ops
from coloc_tpu.ops import patches as patch_ops
from coloc_tpu.ops import pyramid as pyr_ops
from coloc_tpu.types import Features

_MIN_BORDER = 8  # floor: the 7x7 orientation window must fit


def detect_and_describe(image: jnp.ndarray, opts: DetectorOptions) -> Features:
    """image (H, W) uint8/float32 grayscale -> Features (fixed capacity).

    Backend dispatch (replacing the reference's #ifdef USE_CUDA template
    policy, FeatureDetector.hpp): "trip" = the KORAL-equivalent FAST+TRIP-512
    path below; "akaze" = the AKAZE-MLDB parity path (coloc_tpu/akaze.py).
    """
    if opts.backend == "akaze":
        from coloc_tpu.akaze import detect_and_describe_akaze

        return detect_and_describe_akaze(image, opts)
    return _detect_and_describe_trip(image, opts)


@functools.lru_cache(maxsize=32)
def _detection_mask(row_base, heights, widths, wp, total_rows,
                    border, scale_factor, batch=1):
    """Static (batch * R, WP) keep mask: per-level borders (reference
    keep-out border scaled per level with the _MIN_BORDER floor) double as
    the guard against cross-level — and, in the batched raster, cross-image
    — ring contamination in the stacked FAST pass."""
    mask = np.zeros((total_rows, wp), np.float32)
    for l, (rb, h, w) in enumerate(zip(row_base, heights, widths)):
        b = max(_MIN_BORDER, int(round(border / scale_factor ** l)))
        if h > 2 * b and w > 2 * b:
            mask[rb + b : rb + h - b, b : w - b] = 1.0
    return np.tile(mask, (batch, 1)) if batch > 1 else mask


@functools.partial(jax.jit, static_argnames=("opts",))
def _detect_and_describe_trip(image: jnp.ndarray, opts: DetectorOptions) -> Features:
    return jax.tree_util.tree_map(
        lambda a: a[0], _detect_and_describe_trip_batch(image[None], opts)
    )


@functools.partial(jax.jit, static_argnames=("opts",))
def _detect_and_describe_trip_batch(
    images: jnp.ndarray, opts: DetectorOptions
) -> Features:
    """(B, H, W) -> Features with leading batch axis, ONE kernel per stage.

    The batch rides the same trick as the pyramid levels: per-image stacked
    rasters concatenate VERTICALLY into one (B * R, WP) buffer
    (ops/patches.stack_levels_batch), so the FAST+NMS pass and the
    per-keypoint patch extraction each run once for the whole batch — the
    graph no longer contains B unrolled frontend copies (a D-drone
    session step or an F-frame scan body is one detector instance). The
    per-image top-k sorts along the last axis of a (B, R * WP) view.
    """
    images = images.astype(jnp.float32)
    B = images.shape[0]
    k = opts.max_keypoints

    if B == 1:
        # single-frame specialization: plain 2-D resize matmuls and blur
        # (the vmapped batch forms lower to batched dot_generals; results
        # are identical)
        lv = pyr_ops.build_pyramid(
            images[0], opts.num_levels, opts.scale_factor
        )
        levels = [l[None] for l in lv]
        smoothed = [
            pyr_ops.box_blur(l, opts.smoothing_radius)[None] for l in lv
        ]
    else:
        levels = pyr_ops.build_pyramid_batch(
            images, opts.num_levels, opts.scale_factor
        )
        smoothed = [
            jax.vmap(
                lambda im: pyr_ops.box_blur(im, opts.smoothing_radius)
            )(lvl)
            for lvl in levels
        ]

    sp_raw = patch_ops.stack_levels_batch(levels)
    sp_sm = patch_ops.stack_levels_batch(smoothed)
    wp = sp_raw.wp
    R = sp_raw.img_rows
    rb = jnp.asarray(sp_raw.row_base)
    heights = jnp.asarray(sp_raw.heights)
    widths = jnp.asarray(sp_raw.widths)

    # --- detection: FAST + NMS over the batched raster, per-image top-k ----
    raw = fast_ops.fast_score_map(sp_raw.stacked, opts.fast_threshold)
    nms = fast_ops.nms3(raw)
    mask = _detection_mask(
        tuple(int(r) for r in sp_raw.row_base),
        tuple(int(h) for h in sp_raw.heights),
        tuple(int(w) for w in sp_raw.widths),
        wp, R, opts.border, opts.scale_factor, batch=B,
    )
    nms = nms * jnp.asarray(mask)

    # per-image reduction; B == 1 keeps the rank-1 form the single-frame
    # path always used (the batched form is equivalent but may lower to a
    # different reduction schedule)
    flat = nms.reshape(-1) if B == 1 else nms.reshape(B, R * wp)
    top_s, top_i = fast_ops.top_k_sorted(flat, k)
    # flatten the (B, k) keypoint grid; all per-keypoint stages below are
    # batch-agnostic given raster-global rows
    boff = jnp.repeat(jnp.arange(B, dtype=jnp.int32) * R, k)   # (B*k,)
    top_s = top_s.reshape(B * k)
    top_i = top_i.reshape(B * k)
    valid = top_s > 0
    row_img = top_i // wp            # within-image stacked row
    col = top_i % wp

    # level id from the stacked row (static level boundaries)
    kp_l = jnp.sum(row_img[:, None] >= rb[None, 1:], axis=1).astype(jnp.int32)

    # subpixel refinement on the raster-global raw score map; offsets add to
    # LOCAL coordinates so results are bit-identical at every batch position
    dx, dy = fast_ops.subpixel_offsets(raw, col, row_img + boff)
    kp_x = col.astype(jnp.float32) + dx
    kp_y = (row_img - rb[kp_l]).astype(jnp.float32) + dy   # level-local y

    # --- per-keypoint patches from the smoothed stack ------------------------
    w_l = widths[kp_l].astype(jnp.float32)
    h_l = heights[kp_l].astype(jnp.float32)
    row0, col0 = patch_ops.patch_origins(sp_sm, kp_x, kp_y, kp_l)
    P = patch_ops.extract_patches(sp_sm.stacked, row0 + boff, col0)
    row0_local = row0 - rb[kp_l]

    # --- orientation: 7x7 weighted intensity centroid ------------------------
    kp_angle = orient_ops.orientation_from_patches(
        P, kp_x, kp_y, w_l, h_l, col0, row0_local
    )

    # --- description: steered triplets on the smoothed patches --------------
    desc = desc_ops.describe_from_patches(
        P, kp_x, kp_y, kp_angle, w_l, h_l, col0, row0_local
    )

    # --- full-resolution coordinates (GPUDetector.hpp:172-182 parity) -------
    scale = jnp.power(opts.scale_factor, kp_l.astype(jnp.float32))
    xy = jnp.stack([kp_x * scale, kp_y * scale], axis=-1)

    zero = jnp.zeros_like(top_s)
    feats = Features(
        xy=jnp.where(valid[:, None], xy, 0.0),
        score=jnp.where(valid, top_s, zero),
        scale=jnp.where(valid, kp_l, 0),
        angle=jnp.where(valid, kp_angle, 0.0),
        desc=desc,
        valid=valid,
    )
    return jax.tree_util.tree_map(
        lambda a: a.reshape((B, k) + a.shape[1:]), feats
    )


def detect_and_describe_batch(images: jnp.ndarray, opts: DetectorOptions) -> Features:
    """(B, H, W) -> Features with leading batch axis.

    Both backends run one kernel per stage for the whole batch: TRIP stacks
    the per-image rasters vertically (_detect_and_describe_trip_batch);
    AKAZE batches its FED diffusion through the octave kernel's grid and
    stacks the evolution rasters the same way
    (akaze.detect_and_describe_akaze_batch)."""
    if opts.backend == "akaze":
        from coloc_tpu.akaze import detect_and_describe_akaze_batch

        return detect_and_describe_akaze_batch(images, opts)
    return _detect_and_describe_trip_batch(images, opts)
