"""Batched DLT triangulation.

Reference parity: OpenMVG `TriangulateDLT` call sites —
Reconstructor.hpp:225 (two-view bootstrap, gates depth>0 and |Z|<100) and
:378-380 (resection-time triangulation, gates ray angle > 2 deg, depth > 0,
|Z| < 1000); chirality testing in RobustMatcher.hpp:70-72.

Device shape: the per-track host loop becomes one vmapped 4x4 symmetric
eigensolve per track (smallest eigenvector of A^T A), all in normalized
(undistorted, unit-focal) coordinates for f32 conditioning.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _projection_rows(R: jnp.ndarray, C: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Two DLT rows for one view. xy: normalized undistorted coords (2,)."""
    t = -R @ C
    P = jnp.concatenate([R, t[:, None]], axis=1)  # (3, 4)
    return jnp.stack([xy[0] * P[2] - P[0], xy[1] * P[2] - P[1]])  # (2, 4)


def triangulate_two_view(
    R1, C1, xy1, R2, C2, xy2
) -> jnp.ndarray:
    """DLT for a single correspondence; returns euclidean X (3,).

    xy1/xy2 are normalized undistorted image coords.
    """
    A = jnp.concatenate(
        [_projection_rows(R1, C1, xy1), _projection_rows(R2, C2, xy2)], axis=0
    )  # (4, 4)
    _, vecs = jnp.linalg.eigh(A.T @ A)
    Xh = vecs[:, 0]  # smallest eigenvalue eigenvector
    w = Xh[3]
    w = jnp.where(jnp.abs(w) < 1e-12, jnp.sign(w) * 1e-12 + (w == 0) * 1e-12, w)
    return Xh[:3] / w


# vmap over correspondences (shared poses)
triangulate_points = jax.vmap(
    triangulate_two_view, in_axes=(None, None, 0, None, None, 0)
)


def triangulate_nview(
    Rs: jnp.ndarray,   # (V, 3, 3)
    Cs: jnp.ndarray,   # (V, 3)
    xys: jnp.ndarray,  # (V, 2) normalized undistorted observations
    mask: jnp.ndarray, # (V,) bool — which views observe the point
) -> jnp.ndarray:
    """Masked N-view DLT: accumulate A^T A only over valid views."""
    rows = jax.vmap(_projection_rows)(Rs, Cs, xys)        # (V, 2, 4)
    rows = rows * mask[:, None, None]
    A = rows.reshape(-1, 4)                               # (2V, 4)
    _, vecs = jnp.linalg.eigh(A.T @ A)
    Xh = vecs[:, 0]
    w = jnp.where(jnp.abs(Xh[3]) < 1e-12, 1e-12, Xh[3])
    return Xh[:3] / w


def ray_angle_deg(C1: jnp.ndarray, C2: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Angle between viewing rays at X, degrees (Reconstructor gate: > 2 deg)."""
    r1 = X - C1
    r2 = X - C2
    c = jnp.sum(r1 * r2, axis=-1) / (
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1) + 1e-12
    )
    return jnp.degrees(jnp.arccos(jnp.clip(c, -1.0, 1.0)))


def depth_in_view(R: jnp.ndarray, C: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    return ((X - C) @ R.T)[..., 2]
