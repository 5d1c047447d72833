"""Inverse Covariance Intersection (ICI) fusion of two position estimates.

Reference parity: CovIntersection.hpp — despite the class name, the reference
implements INVERSE covariance intersection:
  C_fused(w) = (CA^-1 + CB^-1 - (w CA + (1-w) CB)^-1)^-1            (:27,42)
  w* = argmin_{w in [0,1]} tr(C_fused(w))  via dlib
       find_min_single_variable (eps 1e-3, <=100 iters, search radius 0.01)
       (:34-38,58-63)
  K = C_f (CA^-1 - w* (w CA + (1-w) CB)^-1),
  L = C_f (CB^-1 - (1-w*) (...)^-1),  x_fused = K a + L b            (:40-49)

Device shape: the 1-D bounded minimization becomes a fixed-iteration
golden-section search inside the jit (40 iterations, bracket width < 1e-9 —
comfortably below the reference's 1e-3 eps), fully differentiable-free and
branch-free. The reference's static-member global state is gone: this is a
pure function.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

_GOLDEN = 0.6180339887498949  # 1/phi
_ITERS = 40


class FusionResult(NamedTuple):
    cov: jnp.ndarray    # (3, 3) fused covariance
    pos: jnp.ndarray    # (3,) fused position
    omega: jnp.ndarray  # () optimal weight
    trace: jnp.ndarray  # () minimized trace


def _fused_cov(w, CA_inv, CB_inv, CA, CB):
    M = jnp.linalg.inv(w * CA + (1.0 - w) * CB)
    return jnp.linalg.inv(CA_inv + CB_inv - M)


def fuse(
    CA: jnp.ndarray,  # (3, 3)
    CB: jnp.ndarray,  # (3, 3)
    a: jnp.ndarray,   # (3,)
    b: jnp.ndarray,   # (3,)
) -> FusionResult:
    """ICI fusion (loadData + optimize + computeFusedValues parity)."""
    CA_inv = jnp.linalg.inv(CA)
    CB_inv = jnp.linalg.inv(CB)

    def objective(w):
        return jnp.trace(_fused_cov(w, CA_inv, CB_inv, CA, CB))

    # golden-section search on [0, 1]
    def body(_, state):
        lo, hi = state
        m1 = hi - _GOLDEN * (hi - lo)
        m2 = lo + _GOLDEN * (hi - lo)
        f1 = objective(m1)
        f2 = objective(m2)
        lo = jnp.where(f1 < f2, lo, m1)
        hi = jnp.where(f1 < f2, m2, hi)
        return (lo, hi)

    lo, hi = jax.lax.fori_loop(
        0, _ITERS, body, (jnp.float32(0.0), jnp.float32(1.0))
    )
    w = (lo + hi) / 2.0

    M = jnp.linalg.inv(w * CA + (1.0 - w) * CB)
    C_f = jnp.linalg.inv(CA_inv + CB_inv - M)
    K = C_f @ (CA_inv - w * M)
    L = C_f @ (CB_inv - (1.0 - w) * M)
    pos = K @ a + L @ b
    return FusionResult(cov=C_f, pos=pos, omega=w, trace=jnp.trace(C_f))
