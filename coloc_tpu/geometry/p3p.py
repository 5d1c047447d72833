"""Batched P3P absolute-pose solver (Grunert) + 3-point alignment.

Reference parity: OpenMVG SfM_Localizer::Localize(P3P_KE_CVPR17) used for
resection (Reconstructor.hpp:306) and map localization (Localizer.hpp:93).
Ke's CVPR17 solver is rotation-algebraic; here we use the classical Grunert
formulation because it reduces to (a) a quartic whose coefficients come from
pure polynomial arithmetic and (b) a 3-point Horn alignment — both of which
batch/vmap cleanly with no data-dependent branching.

The quartic is solved in closed form (Ferrari resolvent, branchless via
discriminant selects) + 2 Newton polish steps — no iterative root finder
and no nonsymmetric eigensolve.

Each minimal sample yields up to 4 pose candidates with a validity mask; the
RANSAC harness scores all of them.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from coloc_tpu.types import Pose


def _polymul(p, q):
    """Coefficient convolution, ascending order."""
    n = len(p) + len(q) - 1
    out = [0.0] * n
    res = [jnp.zeros(()) for _ in range(n)]
    for i, a in enumerate(p):
        for j, b in enumerate(q):
            res[i + j] = res[i + j] + a * b
    return res


def _quartic_real_roots(coeffs: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form (Ferrari) real roots of c0 + c1 v + ... + c4 v^4.

    Returns (roots (4,), is_real (4,)). Branchless: the resolvent cubic is
    solved with both the trigonometric (three-real-root) and Cardano
    (one-real-root) formulas and the discriminant selects; quadratic factors
    with negative discriminants mark their root pair invalid. Replaces a
    24-step Durand-Kerner fori_loop — 24 sequential tiny complex ops — and
    keeps the
    same 2-step Newton polish to shave the f32 formula noise.
    """
    lead = coeffs[4]
    lead = jnp.where(jnp.abs(lead) < 1e-20, 1e-20, lead)
    c = coeffs / lead
    a3, a2, a1, a0 = c[3], c[2], c[1], c[0]

    # depressed quartic y^4 + p y^2 + q y + r with v = y - a3/4
    sh = a3 / 4.0
    p = a2 - 3.0 * a3 * a3 / 8.0
    q = a1 - a3 * a2 / 2.0 + a3 ** 3 / 8.0
    r = a0 - a3 * a1 / 4.0 + a3 * a3 * a2 / 16.0 - 3.0 * a3 ** 4 / 256.0

    # resolvent cubic  m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0; its largest
    # real root is >= 0 and yields the factorization parameter s = sqrt(2 m)
    cb = p
    cc = p * p / 4.0 - r
    cd = -q * q / 8.0
    # depressed cubic w^3 + P w + Q, m = w - cb/3
    P = cc - cb * cb / 3.0
    Q = cd - cb * cc / 3.0 + 2.0 * cb ** 3 / 27.0
    disc = (Q / 2.0) ** 2 + (P / 3.0) ** 3

    # trig branch (disc <= 0: three real roots; largest at k = 0)
    Pn = jnp.minimum(P, -1e-20)
    theta = jnp.arccos(jnp.clip(
        (3.0 * Q) / (2.0 * Pn) * jnp.sqrt(-3.0 / Pn), -1.0, 1.0))
    w_trig = 2.0 * jnp.sqrt(-Pn / 3.0) * jnp.cos(theta / 3.0)
    # Cardano branch (disc > 0: one real root)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))

    def cbrt(x):
        return jnp.sign(x) * jnp.abs(x) ** (1.0 / 3.0)

    w_card = cbrt(-Q / 2.0 + sq) + cbrt(-Q / 2.0 - sq)
    w = jnp.where(disc > 0.0, w_card, w_trig)
    m = w - cb / 3.0
    # Newton-polish the resolvent root: f32 cancellation in the cubic
    # formulas is the main source of lost quartic roots downstream
    for _ in range(2):
        f_m = ((m + cb) * m + cc) * m + cd
        df_m = (3.0 * m + 2.0 * cb) * m + cc
        m = m - f_m / jnp.where(jnp.abs(df_m) < 1e-12, 1e-12, df_m)
    m = jnp.maximum(m, 0.0)

    s = jnp.sqrt(2.0 * m + 1e-20)
    half = (p + 2.0 * m) / 2.0
    qs = q / (2.0 * s)
    A = half - qs          # y^2 + s y + A
    B = half + qs          # y^2 - s y + B
    dA = s * s - 4.0 * A
    dB = s * s - 4.0 * B
    rA = jnp.sqrt(jnp.maximum(dA, 0.0))
    rB = jnp.sqrt(jnp.maximum(dB, 0.0))
    roots_y = jnp.stack([
        (-s + rA) / 2.0, (-s - rA) / 2.0,
        (s + rB) / 2.0, (s - rB) / 2.0,
    ])
    # loose realness gate (like the DK version): marginal pairs survive to
    # the Newton polish; clearly-complex pairs are masked
    tol = 1e-3 * (1.0 + s * s + jnp.abs(half) + jnp.abs(qs))
    is_real = jnp.stack([dA > -tol, dA > -tol, dB > -tol, dB > -tol])
    x = roots_y - sh

    # Newton polish on the original quartic
    def poly(v):
        return ((((v + c[3]) * v + c[2]) * v + c[1]) * v) + c[0]

    def dpoly(v):
        return ((4.0 * v + 3.0 * c[3]) * v + 2.0 * c[2]) * v + c[1]

    for _ in range(2):
        x = x - poly(x) / (dpoly(x) + 1e-12)
    is_real = is_real & jnp.isfinite(x)
    return x, is_real


def _triad(p1, p2, p3):
    """Orthonormal frame from 3 points (right-handed)."""
    u1 = p2 - p1
    u1 = u1 / (jnp.linalg.norm(u1) + 1e-12)
    u2 = jnp.cross(u1, p3 - p1)
    u2 = u2 / (jnp.linalg.norm(u2) + 1e-12)
    u3 = jnp.cross(u1, u2)
    return jnp.stack([u1, u2, u3], axis=1)  # (3, 3) columns


def _horn_3pt(P: jnp.ndarray, X: jnp.ndarray) -> Pose:
    """Rigid alignment world->camera from 3 point pairs: X_i = R (P_i - C).

    Triad construction, no SVD: P3P distances satisfy the inter-point
    distance constraints by construction, so the two 3-point clouds are
    exactly congruent and R = triad(X) @ triad(P)^T is exact. (The SVD-based
    Kabsch alignment costs ~1000 batched tiny SVDs per RANSAC call — this
    is the hot path of absolute-pose RANSAC.)
    """
    A = _triad(P[0], P[1], P[2])
    B = _triad(X[0], X[1], X[2])
    R = B @ A.T
    C = jnp.mean(P, axis=0) - R.T @ jnp.mean(X, axis=0)
    return Pose(R=R, C=C)


def p3p_grunert(
    X_world: jnp.ndarray,   # (3, 3) world points
    bearings: jnp.ndarray,  # (3, 3) unit bearing vectors in camera frame
) -> Tuple[Pose, jnp.ndarray]:
    """-> (poses stacked as Pose of (4,3,3)/(4,3), valid (4,) bool)."""
    P1, P2, P3 = X_world[0], X_world[1], X_world[2]
    f1, f2, f3 = bearings[0], bearings[1], bearings[2]

    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.sum((P1 - P3) ** 2)
    c2 = jnp.sum((P1 - P2) ** 2)
    cos_a = jnp.dot(f2, f3)
    cos_b = jnp.dot(f1, f3)
    cos_g = jnp.dot(f1, f2)

    b2 = jnp.maximum(b2, 1e-12)
    ab = a2 / b2
    cb = c2 / b2

    # u = N(v) / D(v); quartic Q(v) = N^2 - 2 cos_g N D + K1 D^2 = 0
    # N(v) = (1 - ab + cb) v^2 + 2 cos_b (ab - cb) v - (1 + ab - cb)
    # D(v) = 2 (cos_a v - cos_g)
    # K1(v) = -cb v^2 + 2 cb cos_b v + (1 - cb)
    N = [-(1.0 + ab - cb), 2.0 * cos_b * (ab - cb), (1.0 - ab + cb)]
    Dp = [-2.0 * cos_g, 2.0 * cos_a]
    K1 = [(1.0 - cb), 2.0 * cb * cos_b, -cb]

    NN = _polymul(N, N)                       # deg 4
    ND = _polymul(N, Dp)                      # deg 3
    DD = _polymul(Dp, Dp)                     # deg 2
    K1DD = _polymul(K1, DD)                   # deg 4
    q = [
        NN[0] - 2.0 * cos_g * ND[0] + K1DD[0],
        NN[1] - 2.0 * cos_g * ND[1] + K1DD[1],
        NN[2] - 2.0 * cos_g * ND[2] + K1DD[2],
        NN[3] - 2.0 * cos_g * ND[3] + K1DD[3],
        NN[4] + K1DD[4],
    ]
    coeffs = jnp.stack(q)

    v_roots, is_real = _quartic_real_roots(coeffs)

    def solution(v):
        Nv = (N[2] * v + N[1]) * v + N[0]
        Dv = Dp[1] * v + Dp[0]
        u = Nv / jnp.where(jnp.abs(Dv) < 1e-9, 1e-9, Dv)
        s1sq = b2 / jnp.maximum(1.0 + v * v - 2.0 * v * cos_b, 1e-12)
        s1 = jnp.sqrt(s1sq)
        s2 = u * s1
        s3 = v * s1
        Xc = jnp.stack([s1 * f1, s2 * f2, s3 * f3])
        pose = _horn_3pt(X_world, Xc)
        ok = (v > 0) & (u > 0) & (s1 > 0)
        return pose, ok

    poses, oks = jax.vmap(solution)(v_roots)
    valid = oks & is_real
    return poses, valid


p3p_grunert_batch = jax.vmap(p3p_grunert)
