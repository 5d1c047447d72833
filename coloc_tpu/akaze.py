"""AKAZE-MLDB frontend (the reference's CPU detector backend).

Reference parity: CPUDetector.hpp + AKAZE.hpp — OpenMVG AKAZE with the
MLDB binary describer (NORMAL preset): nonlinear diffusion scale space,
sigma^2-normalized Hessian-determinant detection with subpixel refinement,
dominant-gradient main orientation, 486-bit MLDB descriptor bit-packed into
the shared 64-byte binary bank. Downstream (matching with Lowe ratio 0.8,
RANSAC, mapping) is identical to the TRIP-512 path — both emit `Features`.

Device shape: FED diffusion is fused stencil work (ops/diffusion.py);
detection is per-level NMS + CROSS-SCALE suppression + fixed-capacity
top-k; orientation and MLDB sampling ride the per-keypoint window + one-hot
sampling path (ops/patches.py + ops/mldb.py).

Cross-scale extrema (AKAZE.hpp:29-78 / OpenMVG Find_Scale_Space_Extrema
parity): a candidate is suppressed when a STRONGER response exists within its
sigma radius at an adjacent evolution level (the reference dedups each level's
keypoints against the previous level's list). Without this, the same corner
surfaces at several adjacent sublevels, and the near-identical duplicate
descriptors later fail the Lowe-ratio test against each other — so the
suppression measurably INCREASES downstream accepted matches. Here the
suppression runs entirely in RASTER space (upsample + max-dilate + compare,
see inline comment) and keypoint selection is ONE top-k over the stacked
level rasters — no per-level top-ks, no scatter/gather candidate lists.

Batching: the whole frontend is batch-first (detect_and_describe_akaze_batch)
the same way the TRIP path is — diffusion is vmapped over the batch
(ops/diffusion.build_scale_space_batch), the per-image stacked rasters
concatenate VERTICALLY into one (B * R, WP) buffer, and every per-keypoint
stage runs once over the flattened (B * k) keypoint bank. A D-drone session
step or B-stream serving dispatch with backend="akaze" therefore compiles ONE
FED pipeline instance, not D/B unrolled copies.

Remaining deviation (documented, measured-equivalent): MLDB cell means use a
dense fixed 4x4 point-sample grid per cell rather than the reference's
per-sigma variable integer-pixel integration — at the NORMAL preset's sigma
range the 4x4 grid covers the cell to within the diffusion smoothing scale
(downstream inlier equivalence pinned by tests/test_akaze.py).
Select with DetectorOptions(backend="akaze").
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from coloc_tpu.config import DetectorOptions
from coloc_tpu.ops import diffusion, fast as fast_ops, mldb
from coloc_tpu.ops import patches as patch_ops
from coloc_tpu.types import Features

_DETECT_BORDER = 10


@functools.lru_cache(maxsize=16)
def _akaze_mask(row_base, heights, widths, wp, rows, border, batch=1):
    """Static keep mask for the stacked NMS raster: zero outside each level's
    per-level detection border and on inter-level padding rows. In the
    batched raster the mask tiles per image; the >= border-row margins also
    guard against cross-image NMS/suppression leakage, exactly as between
    levels inside one image."""
    import numpy as np

    m = np.zeros((rows, wp), np.float32)
    for rb, h, w in zip(row_base, heights, widths):
        m[rb + border : rb + h - border, border : w - border] = 1.0
    return np.tile(m, (batch, 1)) if batch > 1 else m


@functools.partial(jax.jit, static_argnames=("opts",))
def detect_and_describe_akaze(image: jnp.ndarray, opts: DetectorOptions) -> Features:
    """image (H, W) grayscale -> Features (fixed capacity, packed MLDB)."""
    return jax.tree_util.tree_map(
        lambda a: a[0], detect_and_describe_akaze_batch(image[None], opts)
    )


@functools.partial(jax.jit, static_argnames=("opts",))
def detect_and_describe_akaze_batch(
    images: jnp.ndarray, opts: DetectorOptions
) -> Features:
    """(B, H, W) grayscale -> Features with leading batch axis, ONE kernel
    per stage (see module docstring)."""
    B = images.shape[0]
    k = opts.max_keypoints
    num_octaves = min(opts.num_levels // 2, 4) if opts.num_levels >= 4 else 2
    num_sub = opts.akaze_sublevels
    # knob validation: the orientation sampler's 48-row window covers a
    # 6*sigma disc only while the max LEVEL-LOCAL sigma stays <= 17/6 px;
    # sigma_local max = sigma0 * 2^((n-1)/n), which crosses that bound at
    # n = 6 (2.85 * 6 = 17.1 px). cell_samples must give a non-empty table.
    if not 1 <= num_sub <= 5:
        raise ValueError(
            f"akaze_sublevels must be in [1, 5] (got {num_sub}); >= 6 "
            "violates the orientation window margin (see sampler2 note)"
        )
    if not 1 <= opts.akaze_cell_samples <= 8:
        raise ValueError(
            f"akaze_cell_samples must be in [1, 8] "
            f"(got {opts.akaze_cell_samples})"
        )

    levels = diffusion.build_scale_space_batch(
        images, num_octaves=num_octaves, num_sublevels=num_sub,
        tau_max=opts.akaze_fed_tau_max,
    )

    # --- detection: per-level threshold + NMS ------------------------------
    thresh = 1e-4  # AKAZE default response threshold (normalized image)
    nms = [
        jax.vmap(fast_ops.nms3)(
            jnp.where(ev.response > thresh, ev.response, 0.0)
        )
        for ev in levels
    ]

    # --- cross-scale extrema suppression, raster form ----------------------
    # The reference dedups each level's candidate LIST against the adjacent
    # level's within a sigma radius. List forms need scatters/gathers; this
    # form stays in raster space: level
    # li+1's NMS peak raster is upsampled to li's resolution, max-dilated by
    # the suppression radius (two 1-D reduce_windows), and compared
    # pointwise — a peak is suppressed iff a STRICTLY stronger adjacent-level
    # peak lies within radius r (ties kill the coarser level). The square
    # dilation window over-reaches Euclidean r by sqrt(2) in the corners
    # (+1 px cross-octave upsample slack) — mild deliberate over-suppression;
    # the weaker of two corners that close is redundant anyway.
    def _maxpool(x, rad):
        if rad <= 0:
            return x
        w = 2 * rad + 1
        x = jax.lax.reduce_window(
            x, 0.0, jax.lax.max, (1, w, 1), (1, 1, 1), "SAME"
        )
        return jax.lax.reduce_window(
            x, 0.0, jax.lax.max, (1, 1, w), (1, 1, 1), "SAME"
        )

    def _up2(x, h, w):
        return jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)[:, :h, :w]

    for li in range(len(levels) - 1):
        a, b = nms[li], nms[li + 1]
        oa, ob = levels[li].octave, levels[li + 1].octave
        r_base = max(levels[li].sigma, levels[li + 1].sigma)  # base px
        ra_px = math.ceil(r_base / (2.0 ** oa)) + (1 if ob > oa else 0)
        ha, wa = a.shape[1:]
        b_at_a = _up2(b, ha, wa) if ob > oa else b
        # suppress the weaker of a close pair; ties suppress the coarser level
        sup_a = _maxpool(b_at_a, ra_px) > a
        dil_a = _maxpool(a, ra_px)
        if ob > oa:  # 2x2 max-downsample back to b's grid
            hb, wb = b.shape[1:]
            dil_a = jax.lax.reduce_window(
                jnp.pad(dil_a, ((0, 0), (0, 2 * hb - ha), (0, 2 * wb - wa))),
                0.0, jax.lax.max, (1, 2, 2), (1, 2, 2), "VALID")
        sup_b = dil_a >= b
        nms[li] = jnp.where(sup_a, 0.0, a)
        nms[li + 1] = jnp.where(sup_b, 0.0, b)

    # --- single stacked top-k over all levels (TRIP-frontend structure) ----
    sp_nms = patch_ops.stack_levels_batch(nms)
    sp_resp = patch_ops.stack_levels_batch([ev.response for ev in levels])
    wp = sp_nms.wp
    R = sp_nms.img_rows
    rb = jnp.asarray(sp_nms.row_base)
    mask = _akaze_mask(tuple(int(r) for r in sp_nms.row_base),
                       tuple(int(h) for h in sp_nms.heights),
                       tuple(int(w) for w in sp_nms.widths),
                       wp, R, _DETECT_BORDER, batch=B)
    masked = sp_nms.stacked * jnp.asarray(mask)
    flat = masked.reshape(-1) if B == 1 else masked.reshape(B, R * wp)
    top_s, top_i = fast_ops.top_k_sorted(flat, k)
    # flatten the (B, k) keypoint grid; all per-keypoint stages below are
    # batch-agnostic given raster-global rows
    boff = jnp.repeat(jnp.arange(B, dtype=jnp.int32) * R, k)   # (B*k,)
    top_s = top_s.reshape(B * k)
    top_i = top_i.reshape(B * k)
    valid = top_s > 0
    row = top_i // wp            # within-image stacked row
    col = top_i % wp
    kp_l = jnp.sum(row[:, None] >= rb[None, 1:], axis=1).astype(jnp.int32)

    # subpixel refinement on the raster-global raw response raster; offsets
    # add to LOCAL coordinates so results are bit-identical at every batch
    # position (see ops/fast.subpixel_offsets)
    dx, dy = fast_ops.subpixel_offsets(sp_resp.stacked, col, row + boff)
    kp_x = col.astype(jnp.float32) + dx
    kp_y = (row - rb[kp_l]).astype(jnp.float32) + dy     # level-local y
    sig_table = jnp.asarray(
        [ev.sigma / (2.0 ** ev.octave) for ev in levels], jnp.float32
    )
    kp_sig = sig_table[kp_l]      # sigma in level-local pixels

    # --- per-keypoint sampling from stacked evolution rasters --------------
    # L/Lx/Ly stack into one row-stacked buffer; orientation and MLDB
    # samples ride the window + one-hot sampling path
    # (ops/patches.sample_raster_flat). Windows are NARROW (64 x 128): a
    # 128-wide window at a
    # 128-aligned column cannot always cover [x-26, x+26], so the buffer
    # also holds 64-column-shifted copies of each channel and a keypoint
    # whose span crosses its tile boundary reads the shifted copy instead
    # (selection below) — this halves both the window traffic and the
    # one-hot matmul MACs vs full (64, 256) windows. Sample reach from
    # round(kp_x) is <= 20.1 px (descriptor 5*sigma*sqrt(2) <= 19.1 + 0.5px
    # rounding; see ops/mldb.py), so every clamped sample stays inside the
    # selected window: max local col = 46.1 + (a mod 128) <= 121.1 (normal,
    # a mod 128 <= 75) or (a mod 128) - 17.9 <= 109.1 (shifted).
    sp_l = patch_ops.stack_levels_batch([ev.L for ev in levels])
    sp_lx = patch_ops.stack_levels_batch([ev.Lx for ev in levels])
    sp_ly = patch_ops.stack_levels_batch([ev.Ly for ev in levels])
    R_tot = sp_l.stacked.shape[0]            # = B * R rows per channel

    def shift64(x):  # drop the first 64 columns, zero-pad the tail
        return jnp.pad(x[:, 64:], ((0, 0), (0, 64)))

    # bf16 raster stack: sample_nearest quantizes window values to bf16
    # before its matmul anyway, so casting BEFORE the per-keypoint windows
    # are sliced is value-identical and halves their traffic
    # (K=5000 x C channels x (ph, 128) windows)
    src6 = jnp.concatenate([
        sp_l.stacked, sp_lx.stacked, sp_ly.stacked,
        shift64(sp_l.stacked), shift64(sp_lx.stacked),
        shift64(sp_ly.stacked),
    ], axis=0).astype(jnp.bfloat16)
    rb = jnp.asarray(sp_l.row_base)
    w_l = jnp.asarray(sp_l.widths)[kp_l].astype(jnp.float32)
    h_l = jnp.asarray(sp_l.heights)[kp_l].astype(jnp.float32)
    row0, _ = patch_ops.patch_origins(sp_l, kp_x, kp_y, kp_l)
    row0_local = row0 - rb[kp_l]
    # narrow-window column selection: leftmost needed column a, normal copy
    # iff the 52-px span fits its 128-tile, else the 64-shifted copy
    xi = jnp.round(kp_x).astype(jnp.int32)
    a = jnp.maximum(xi - 26, 0)
    m = a % 128
    shift = m > 75
    c0 = jnp.where(shift, ((a - 64) // 128) * 128, (a // 128) * 128)
    col0_eff = c0 + jnp.where(shift, 64, 0)     # window col 0 in level coords
    row0_dma = row0 + boff + jnp.where(shift, 3 * R_tot, 0)

    def sampler3(lx, ly):
        return patch_ops.sample_raster_flat(
            src6, R_tot, row0_dma, c0, lx, ly, C=3, pw=128
        )

    # orientation-only sampler: the disc reaches 6*sigma <= 16.7 px from
    # round(kp_y), so a 48-row window suffices; its 8-aligned offset inside
    # the 64-row patch covers [y-17, y+17] in every patch_origins clamp case
    # (normal offset in [27,34] -> ro in [8,16]; top clamp -> ro=0; bottom
    # clamp -> ro=16 with samples clamped to the level edge at local 63).
    # Channels are Lx/Ly only (base offset +R_tot skips L): DMA volume is
    # 2/3 * 48/64 = half of a 3-channel 64-row pass.
    yi_rel = jnp.round(kp_y).astype(jnp.int32) - row0_local
    ro = jnp.clip(((yi_rel - 17) // 8) * 8, 0, 16)
    row0_ori = row0_dma + R_tot + ro

    def sampler2(lx, ly):
        return patch_ops.sample_raster_flat(
            src6, R_tot, row0_ori, c0, lx, ly, C=2, ph=48, pw=128
        )

    kp_angle = mldb.orientation(
        sampler2, kp_x, kp_y, kp_sig, w_l, h_l, col0_eff, row0_local + ro
    )
    desc = mldb.describe_mldb(
        sampler3, kp_x, kp_y, kp_sig, kp_angle,
        w_l, h_l, col0_eff, row0_local,
        cell_samples=opts.akaze_cell_samples,
    )

    # --- base-resolution coordinates (octave upsampling) -------------------
    octave_of_level = jnp.asarray([ev.octave for ev in levels], jnp.int32)
    oct_k = octave_of_level[kp_l]
    up = jnp.power(2.0, oct_k.astype(jnp.float32))
    xy = jnp.stack([kp_x * up, kp_y * up], axis=-1)

    feats = Features(
        xy=jnp.where(valid[:, None], xy, 0.0),
        score=jnp.where(valid, top_s, 0.0),
        scale=jnp.where(valid, kp_l, 0),
        angle=jnp.where(valid, kp_angle, 0.0),
        desc=desc,
        valid=valid,
    )
    return jax.tree_util.tree_map(
        lambda a: a.reshape((B, k) + a.shape[1:]), feats
    )
