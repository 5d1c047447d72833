"""Per-keypoint patch extraction + one-hot sampling.

The reference's per-keypoint work (FeatureAngle.h orientation window, CLATCH.cu
rotated-ROI descriptor sampling) is random access into the image pyramid — one
CUDA block per keypoint. Here this stage is:

  1. EXTRACT: one aligned (PH, PW) window per keypoint around its location
     (a vmapped dynamic_slice; origins rounded down to an (8, 128) grid).
  2. SAMPLE: all per-keypoint samples (orientation window + steered descriptor
     pool) become one-hot row/column weight matrices contracted against the
     patches — einsum('krc,kic->kir') then a row-weighted reduce.
     Nearest-neighbor semantics = exact one-hot selection; weights and patch
     values ride bf16 (integer-ish pixel values; one-hots are exact in bf16).

Whether direct gathers beat this on the GPU is not measured yet.

Levels of the pyramid are stacked vertically into one (sum H_l, PW_stack)
raster so a single buffer serves every level (flattened-pyramid analog with
2-D structure preserved for windowed slicing).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

PH = 64           # patch rows (8-aligned; covers +-26 around any row-in-8 kp)
PW = 256          # patch cols (128-aligned; covers +-26 around any lane kp)
_MARGIN = 26      # max sample offset from the keypoint the patch must cover


class StackedPyramid:
    """Vertically stacked pyramid levels + static geometry tables.

    For a BATCH of images (stack_levels_batch), `stacked` is (B * R, WP)
    with image b's raster occupying rows [b * R, (b + 1) * R); the geometry
    tables (row_base/heights/widths) describe ONE image and `img_rows` = R.
    """

    def __init__(self, stacked, row_base, heights, widths, img_rows=None):
        self.stacked = stacked          # (R_total, WP) f32
        self.row_base = row_base        # np (L,) first stacked row per level
        self.heights = heights          # np (L,)
        self.widths = widths            # np (L,)
        self.img_rows = (
            img_rows if img_rows is not None else stacked.shape[0]
        )

    @property
    def wp(self) -> int:
        return self.stacked.shape[1]


def stack_levels(levels: Sequence[jnp.ndarray]) -> StackedPyramid:
    """Stack pyramid levels vertically, zero-padded to a shared lane width.

    The shared width is max(W_0, PW) rounded up to 128 so any patch window
    fits; per-level heights are padded to a multiple of 8 so level
    boundaries stay on the patch-origin grid.
    """
    wmax = max(max(lvl.shape[1] for lvl in levels), PW)
    wp = ((wmax + 127) // 128) * 128
    rows, row_base, heights, widths = [], [], [], []
    off = 0
    for lvl in levels:
        h, w = lvl.shape
        hp = ((max(h, PH) + 7) // 8) * 8
        rows.append(jnp.pad(lvl, ((0, hp - h), (0, wp - w))))
        row_base.append(off)
        heights.append(h)
        widths.append(w)
        off += hp
    return StackedPyramid(
        jnp.concatenate(rows, axis=0),
        np.asarray(row_base, np.int32),
        np.asarray(heights, np.int32),
        np.asarray(widths, np.int32),
    )


def stack_levels_batch(levels: Sequence[jnp.ndarray]) -> StackedPyramid:
    """Batched stack_levels: levels are (B, H_l, W_l); the B per-image
    rasters stack VERTICALLY into one (B * R, WP) buffer so the fused
    FAST+NMS pass and the patch extraction each run ONCE for the whole
    batch (no per-image unroll). Per-level
    keep-out borders (>= 8 rows, frontend._detection_mask) already mask
    every pixel the 3-px ring/NMS neighborhoods could leak across level —
    and therefore image — boundaries, exactly as they do between levels
    inside one image."""
    wmax = max(max(lvl.shape[2] for lvl in levels), PW)
    wp = ((wmax + 127) // 128) * 128
    rows, row_base, heights, widths = [], [], [], []
    off = 0
    for lvl in levels:
        b, h, w = lvl.shape
        hp = ((max(h, PH) + 7) // 8) * 8
        rows.append(jnp.pad(lvl, ((0, 0), (0, hp - h), (0, wp - w))))
        row_base.append(off)
        heights.append(h)
        widths.append(w)
        off += hp
    stacked = jnp.concatenate(rows, axis=1).reshape(-1, wp)
    return StackedPyramid(
        stacked,
        np.asarray(row_base, np.int32),
        np.asarray(heights, np.int32),
        np.asarray(widths, np.int32),
        img_rows=off,
    )


def patch_origins(
    sp: StackedPyramid,
    kp_x: jnp.ndarray,       # (K,) level-local float
    kp_y: jnp.ndarray,
    kp_level: jnp.ndarray,   # (K,) int32
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (row0 (K,), col0 (K,)) tile-aligned patch origins in stacked coords.

    Guarantees: for any sample at level-local (x + dx, y + dy) with
    |dx|,|dy| <= _MARGIN (after clamping to the level bounds), the stacked
    coords fall inside [row0, row0+PH) x [col0, col0+PW).
    """
    rb = jnp.asarray(sp.row_base)
    hs = jnp.asarray(sp.heights)
    xi = jnp.round(kp_x).astype(jnp.int32)
    yi = jnp.round(kp_y).astype(jnp.int32)
    h_l = hs[kp_level]
    # 8-aligned row origin covering [y - 26.5, y + 26.5]: floor8(y - 27)
    # <= y - 26.5, and floor8(y - 27) + PH >= y - 34 + 64 = y + 30.
    r0_local = ((yi - 27) >> 3) << 3
    r0_max = jnp.maximum(((h_l - PH + 7) >> 3) << 3, 0)  # stay inside padded level
    r0_local = jnp.clip(r0_local, 0, r0_max)
    row0 = rb[kp_level] + r0_local
    # 128-aligned col origin: floor128(x - _MARGIN); clamp to buffer
    c0 = (jnp.maximum(xi - _MARGIN, 0) >> 7) << 7
    col0 = jnp.clip(c0, 0, sp.wp - PW)
    return row0, col0


def extract_patches(src: jnp.ndarray, row0: jnp.ndarray, col0: jnp.ndarray
                    ) -> jnp.ndarray:
    """(R, WP) source + (K,) aligned origins -> (K, PH, PW) patches."""
    return jax.vmap(
        lambda r, c: jax.lax.dynamic_slice(src, (r, c), (PH, PW))
    )(row0, col0)


def sample_raster_flat(
    src2: jnp.ndarray,       # (n_rasters * stride, WP) row-stacked rasters
    stride: int,             # rows per raster; channel c reads row0+c*stride
    row0: jnp.ndarray,       # (K,) 8-aligned window origins (may pre-add a
    col0: jnp.ndarray,       # raster offset, e.g. the lane-shifted copies)
    lx: jnp.ndarray,         # (K, NS) window-local float col coords
    ly: jnp.ndarray,         # (K, NS) window-local float row coords
    C: int = 1,
    ph: int = PH,            # window rows (8-multiple)
    pw: int = PW,            # window width (128-multiple)
) -> jnp.ndarray:
    """Nearest samples of C channels at shared coords -> (C, K, NS) f32:
    a per-channel dynamic-slice + one-hot sample composition."""
    outs = []
    for c in range(C):
        P = jax.vmap(
            lambda r, cc, c=c: jax.lax.dynamic_slice(
                src2, (r + c * stride, cc), (ph, pw))
        )(row0, col0)
        outs.append(sample_nearest(P, lx, ly))
    return jnp.stack(outs)


def sample_raster(
    srcs: jnp.ndarray,       # (C, R, WP) channel-stacked rasters
    row0: jnp.ndarray,       # (K,) aligned window origins (stacked rows)
    col0: jnp.ndarray,       # (K,)
    lx: jnp.ndarray,         # (K, NS) window-local float col coords
    ly: jnp.ndarray,         # (K, NS) window-local float row coords
) -> jnp.ndarray:
    """sample_raster_flat over a (C, R, WP) channel stack, full-width
    windows — same values as extract_patches + sample_nearest per channel."""
    C, R, WP_ = srcs.shape
    return sample_raster_flat(
        srcs.reshape(-1, WP_), R, row0, col0, lx, ly, C=C, pw=PW
    )


def sample_nearest(
    patches: jnp.ndarray,    # (K, PH, PW)
    lx: jnp.ndarray,         # (K, NS) patch-local float col coords
    ly: jnp.ndarray,         # (K, NS) patch-local float row coords
) -> jnp.ndarray:
    """Nearest-neighbor samples via one-hot contraction -> (K, NS) f32.

    Coords are expected pre-clamped to valid image area by the caller; they
    are additionally clamped to the patch so out-of-range indices can't wrap.

    Precision: one-hot WEIGHTS are exact in bf16, but the patch VALUES are
    deliberately quantized to bf16 for the matmul — box-smoothed
    intensities are non-integer with magnitude up to 255, where bf16 ulp is
    1.0, so samples carry up to ~0.5 intensity (~0.2% relative) of
    quantization vs a true nearest sample. This is a speed trade: an exact
    f32 column contraction needs a >=2x-slower matmul precision. Measured
    effect: only descriptor triplet comparisons whose contrast is within
    ~1 intensity of zero can flip, and downstream inlier counts are
    indistinguishable (tests/test_frontend.py descriptor-stability checks);
    orientation moments absorb the same noise far below the 7x7 window's
    discretization error.
    """
    K, NS = lx.shape
    ph, pw = patches.shape[1], patches.shape[2]
    ci = jnp.round(jnp.clip(lx, 0, pw - 1))
    ri = jnp.round(jnp.clip(ly, 0, ph - 1))
    col_iota = jax.lax.broadcasted_iota(jnp.float32, (1, 1, pw), 2)
    row_iota = jax.lax.broadcasted_iota(jnp.float32, (1, 1, ph), 2)
    cw = (col_iota == ci[:, :, None]).astype(jnp.bfloat16)     # (K, NS, PW)
    rw = (row_iota == ri[:, :, None]).astype(jnp.float32)      # (K, NS, PH)
    q = jnp.einsum(
        "krc,kic->kir", patches.astype(jnp.bfloat16), cw,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )                                                          # (K, NS, PH)
    return jnp.sum(q * rw, axis=2)
