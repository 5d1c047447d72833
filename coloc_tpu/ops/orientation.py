"""Keypoint orientation by weighted intensity centroid.

Reference parity: FeatureAngle.h:197-246 — 7x7 weighted intensity-centroid
gradient (SSE) + polynomial fastAtan2 (:160-177). Device shape: the 7x7
integer window is sampled from per-keypoint patches via the one-hot path
(ops/patches.py) and the centroid moments are two (K, 49) @ (49,) dots,
followed by an elementwise atan2. Documented deviation: the window reads the box-smoothed
pyramid (the same buffer the descriptor samples) rather than the raw level —
the intensity centroid is a low-pass statistic, so the pre-smoothing shifts
angles only marginally and identically for all frames.
"""

from __future__ import annotations

import jax.numpy as jnp

from coloc_tpu.ops import patches as patch_ops

_RADIUS = 3  # 7x7 window


def moment_tables(radius: int = _RADIUS):
    """Static (49,) window offsets + weighted moment vectors.

    Weights w = radius+1-max(|dx|,|dy|) (FeatureAngle's distance taper);
    moment vectors are wx = dx*w, wy = dy*w.
    """
    r = radius
    ys, xs = jnp.mgrid[-r : r + 1, -r : r + 1]
    wgt = (r + 1 - jnp.maximum(jnp.abs(xs), jnp.abs(ys))).astype(jnp.float32)
    offs_x = xs.reshape(-1).astype(jnp.float32)
    offs_y = ys.reshape(-1).astype(jnp.float32)
    wx = (xs * wgt).reshape(-1).astype(jnp.float32)
    wy = (ys * wgt).reshape(-1).astype(jnp.float32)
    return offs_x, offs_y, wx, wy


def orientation_from_patches(
    patches: jnp.ndarray,    # (K, PH, PW) per-keypoint windows
    kp_x: jnp.ndarray,       # (K,) level-local float
    kp_y: jnp.ndarray,
    w_l: jnp.ndarray,        # (K,) level width/height (float, for clamping)
    h_l: jnp.ndarray,
    col0: jnp.ndarray,       # (K,) patch origins (level-local col,
    row0_local: jnp.ndarray, #  level-local row)
) -> jnp.ndarray:
    """Intensity-centroid angle per keypoint -> (K,) radians."""
    offs_x, offs_y, wx, wy = moment_tables()
    gx = jnp.clip(jnp.round(kp_x)[:, None] + offs_x[None, :], 0.0,
                  (w_l - 1.0)[:, None])
    gy = jnp.clip(jnp.round(kp_y)[:, None] + offs_y[None, :], 0.0,
                  (h_l - 1.0)[:, None])
    vals = patch_ops.sample_nearest(
        patches,
        gx - col0.astype(jnp.float32)[:, None],
        gy - row0_local.astype(jnp.float32)[:, None],
    )                                                   # (K, 49)
    m10 = vals @ wx
    m01 = vals @ wy
    return jnp.arctan2(m01, m10)
