"""TRIP-512: steered triplet binary descriptor (512 bits) with a shared
sample pool.

Reference parity: CLATCH (src/CLATCH.cu) computes 512-bit LATCH — per
keypoint, a rotated 64x64 ROI and 512 patch-triplet SSD comparisons against a
learned triplet table, one CUDA block per keypoint. We keep the *semantics*
(oriented triplet comparisons -> sign bits -> 512-bit binary string matched
under Hamming margin) but redesign for fixed-shape device code:

  - Patch SSDs become point samples on a box-pre-smoothed pyramid level
    (smoothing ≈ patch aggregation, the steered-BRIEF/ORB trick).
  - Like LATCH's patch reuse, triplets draw from a shared POOL of sample
    points: only `POOL_SIZE` rotated samples are taken per keypoint, and the
    512 triplets index into that pool with a static table. Samples come from
    per-keypoint patches via one-hot contraction (ops/patches.py);
    triplet comparisons on the sampled (K, P) matrix are elementwise.
  - The pool and triplet tables are generated from a fixed PRNG seed (not the
    learned LATCH table — deliberately not copied from the reference); pool
    points live in a disc of radius 24 px matching LATCH's spatial support.

Bit layout matches coloc_tpu.ops.hamming.pack_bits/unpack_bipolar.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from coloc_tpu.ops import patches as patch_ops
from coloc_tpu.ops.hamming import pack_bits

DESC_BITS = 512
POOL_SIZE = 192
_TABLE_SEED = 20240816
_SUPPORT_RADIUS = 24.0  # spatial support, px (LATCH uses a 48x48 window)
_MIN_SEP = 3.0          # keep compared pool points distinct


def _make_tables(seed: int = _TABLE_SEED):
    """Returns (pool (P, 2) float32 offsets, triplets (512, 3) int32 indices).

    Pool: Gaussian-concentrated toward the center, clipped to the support
    disc. Triplets: random distinct pool indices with a minimum separation
    between the two comparison points (p1, p2) so bits aren't degenerate.
    """
    rng = np.random.default_rng(seed)
    pool = np.zeros((POOL_SIZE, 2), np.float32)
    i = 0
    while i < POOL_SIZE:
        p = rng.normal(0.0, _SUPPORT_RADIUS / 2.5, size=2)
        if np.linalg.norm(p) > _SUPPORT_RADIUS:
            continue
        pool[i] = p
        i += 1

    triplets = np.zeros((DESC_BITS, 3), np.int64)
    seen = set()
    i = 0
    while i < DESC_BITS:
        a, p1, p2 = rng.integers(0, POOL_SIZE, 3)
        if len({a, p1, p2}) < 3:
            continue
        if np.linalg.norm(pool[p1] - pool[p2]) < _MIN_SEP:
            continue
        key = (a, min(p1, p2), max(p1, p2))
        if key in seen:
            continue
        seen.add(key)
        triplets[i] = (a, p1, p2)
        i += 1
    return pool, triplets.astype(np.int32)


_POOL, _TRIPLETS = _make_tables()  # module-level constants, baked into traces


def describe_from_patches(
    patches: jnp.ndarray,       # (K, PH, PW) box-smoothed per-keypoint windows
    kp_x: jnp.ndarray,          # (K,) level-local x
    kp_y: jnp.ndarray,          # (K,) level-local y
    kp_angle: jnp.ndarray,      # (K,) radians
    w_l: jnp.ndarray,           # (K,) level width/height (float, clamping)
    h_l: jnp.ndarray,
    col0: jnp.ndarray,          # (K,) patch origin (level-local col / row)
    row0_local: jnp.ndarray,
) -> jnp.ndarray:
    """-> (K, 16) uint32 packed 512-bit descriptors.

    Nearest sampling: the pool reads a box-smoothed pyramid, so the <=0.5px
    rounding is well below the smoothing scale. Samples route through the
    one-hot path (ops/patches.py) instead of elementwise gathers.
    """
    pool = jnp.asarray(_POOL)                              # (P, 2)

    ca, sa = jnp.cos(kp_angle), jnp.sin(kp_angle)          # (K,)
    ox, oy = pool[:, 0], pool[:, 1]                        # (P,)
    # steer pool offsets by keypoint angle: (K, P)
    rx = ca[:, None] * ox[None] - sa[:, None] * oy[None]
    ry = sa[:, None] * ox[None] + ca[:, None] * oy[None]

    gx = jnp.clip(kp_x[:, None] + rx, 0.0, (w_l - 1.0)[:, None])
    gy = jnp.clip(kp_y[:, None] + ry, 0.0, (h_l - 1.0)[:, None])
    vals = patch_ops.sample_nearest(
        patches,
        gx - col0.astype(jnp.float32)[:, None],
        gy - row0_local.astype(jnp.float32)[:, None],
    )                                                      # (K, P)

    tri = jnp.asarray(_TRIPLETS)                           # (512, 3)
    va = vals[:, tri[:, 0]]                                # (K, 512)
    v1 = vals[:, tri[:, 1]]
    v2 = vals[:, tri[:, 2]]
    bits = (va - v1) ** 2 > (va - v2) ** 2                 # (K, 512) bool
    return pack_bits(bits)
