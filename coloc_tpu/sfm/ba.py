"""Bundle adjustment: Levenberg-Marquardt with Schur complement + pose
covariance.

Reference parity: Refiner.hpp — Ceres problem with angle-axis+translation
pose blocks (:62-105), optional constant intrinsics/rotation/translation/
structure subsets (:87-120), Huber loss delta^2=16 (:122), SPARSE_SCHUR
(:158-173), and ceres::Covariance extracting the 6x6 pose covariance block
(:177-202); poses written back as Pose3(R, -R^T t) (:226-236); returns
reprojection RMSE (:223). Call-site patterns replicated:
  - full BA, first pose fixed (Reconstructor.hpp:150-161)
  - pose-only, structure fixed (Localizer.hpp:132-133)
  - poses-only multi-view (inter-drone refinement, coloc.hpp:339)

Device shape: scenes here are tiny (<=8 views, <=4096 landmarks), so the
"sparse" Schur solve is a dense (6V x 6V) solve after eliminating landmark
blocks — all fixed-shape, jit/vmap-friendly. Robustness = Huber IRLS weights.
LM damping handled with a fixed-iteration accept/reject scan (no
data-dependent trip counts). Pose covariance = inverse of the damped-free
Schur complement, matching the Ceres covariance semantics.

Parameter convention (documented deviation from Ceres's (angle-axis, t)):
pose perturbations are (w, dC) — rotation tangent and CENTER shift. The 6x6
covariance is returned in this (w, dC) ordering: rotation block [0:3,0:3],
center block [3:6,3:6]. Downstream consumers (KF measurement noise, CI
fusion, CSV logs) all use this one convention consistently.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from coloc_tpu.config import RefinerOptions
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import so3


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem.

    V views, L landmarks (static). obs[v, l] is the observed distorted pixel
    of landmark l in view v where obs_mask[v, l] else ignored.
    """

    Rs: jnp.ndarray        # (V, 3, 3)
    Cs: jnp.ndarray        # (V, 3)
    X: jnp.ndarray         # (L, 3)
    obs: jnp.ndarray       # (V, L, 2)
    obs_mask: jnp.ndarray  # (V, L) bool
    Ks: jnp.ndarray        # (V, 3, 3) intrinsics (always held constant)
    dists: jnp.ndarray     # (V, 3) radial k1,k2,k3


class BAResult(NamedTuple):
    Rs: jnp.ndarray
    Cs: jnp.ndarray
    X: jnp.ndarray
    cov: jnp.ndarray       # (6, 6) pose covariance of `cov_view`
    rmse: jnp.ndarray      # () float32
    n_obs: jnp.ndarray     # () int32


def _project_residual(R, C, K, dist, X, uv):
    cam = cam_ops.Camera(K=K, dist=dist)
    pred = cam_ops.project(cam, R, C, X)
    return pred - uv


def _huber_weights(res_sq: jnp.ndarray, delta_sq: float) -> jnp.ndarray:
    """IRLS sqrt-weights for the Huber loss (delta^2 = 16, Refiner.hpp:122)."""
    w = jnp.where(res_sq <= delta_sq, 1.0, jnp.sqrt(delta_sq / jnp.maximum(res_sq, 1e-12)))
    return jnp.sqrt(w)


# Marquardt-damping diagonal clamp (Ceres min_diagonal/max_diagonal parity)
_DIAG_MIN = 1e-6
_DIAG_MAX = 1e32
# relative parameter tolerance for the small-step convergence exit. Ceres's
# parameter_tolerance default is 1e-8 in DOUBLE precision; 1e-5 sits safely
# above the f32 rounding floor (~1e-7 relative) while resolving pose far
# beyond the pipeline's accuracy envelope (~0.05 deg / 1 cm).
_STEP_TOL = 1e-5


def _diag3(M: jnp.ndarray, n: int) -> jnp.ndarray:
    """Batched diagonal of (..., n, n) -> (..., n)."""
    return M[..., jnp.arange(n), jnp.arange(n)]


def _spd_inv(M: jnp.ndarray, rel_floor: float = 1e-6) -> jnp.ndarray:
    """Inverse of symmetric PSD blocks via eigh with a RELATIVE eigenvalue
    floor. f32 LU-based `inv` NaNs out on the nearly-rank-deficient landmark
    blocks (cond ~1e11) that parallel-ray landmarks produce; an absolute
    regularizer can't track the 1e5-spread of block scales. Works on (..., n, n)."""
    evals, evecs = jnp.linalg.eigh(M)
    floor = rel_floor * jnp.max(jnp.abs(evals), axis=-1, keepdims=True) + 1e-12
    inv_evals = 1.0 / jnp.maximum(evals, floor)
    return jnp.einsum("...ij,...j,...kj->...ik", evecs, inv_evals, evecs)


def _apply_pose_delta(Rs, Cs, dp):
    """dp (V, 6): (w, dC) tangent update per view."""
    Rn = jax.vmap(lambda w, R: so3.exp(w) @ R)(dp[:, :3], Rs)
    Cn = Cs + dp[:, 3:]
    return Rn, Cn


@functools.partial(
    jax.jit,
    static_argnames=("opts", "optimize_structure", "cov_view"),
)
def refine(
    problem: BAProblem,
    opts: RefinerOptions,
    fix_pose: jnp.ndarray,          # (V,) bool — poses held constant
    optimize_structure: bool = True,
    cov_view: int = 1,              # Refiner.hpp:188: pose block 1 (or 0)
) -> BAResult:
    """LM bundle adjustment. Returns refined poses/structure + covariance."""
    V = problem.Rs.shape[0]
    L = problem.X.shape[0]
    delta_sq = opts.huber_delta_sq

    obs_mask_f = problem.obs_mask.astype(jnp.float32)
    n_obs = jnp.sum(problem.obs_mask.astype(jnp.int32))

    def residuals(Rs, Cs, X):
        """(V, L, 2) raw reprojection residuals (masked entries zeroed)."""
        def per_view(R, C, K, dist, obs_v, mask_v):
            r = _project_residual(R, C, K, dist, X, obs_v)
            return r * mask_v[:, None]
        return jax.vmap(per_view)(
            Rs, Cs, problem.Ks, problem.dists, problem.obs, obs_mask_f,
        )

    def build_normal_eqs(Rs, Cs, X, lm_lambda):
        """One robust GN linearization; returns (dp (V,6), dX (L,3), cost)."""
        # jacobians per observation wrt pose (6) and point (3)
        def jac_obs(R, C, K, dist, Xl, uv):
            def f(p, dx):
                Rp = so3.exp(p[:3]) @ R
                Cp = C + p[3:]
                return _project_residual(Rp, Cp, K, dist, Xl + dx, uv)
            Jp = jax.jacfwd(f, argnums=0)(jnp.zeros(6), jnp.zeros(3))  # (2, 6)
            Jx = jax.jacfwd(f, argnums=1)(jnp.zeros(6), jnp.zeros(3))  # (2, 3)
            r = f(jnp.zeros(6), jnp.zeros(3))
            return Jp, Jx, r

        def per_view(R, C, K, dist, obs_v):
            return jax.vmap(
                lambda Xl, uv: jac_obs(R, C, K, dist, Xl, uv)
            )(X, obs_v)

        Jp, Jx, r = jax.vmap(per_view)(
            Rs, Cs, problem.Ks, problem.dists, problem.obs
        )  # (V, L, 2, 6), (V, L, 2, 3), (V, L, 2)

        res_sq = jnp.sum(r * r, axis=-1)                      # (V, L)
        w = _huber_weights(res_sq, delta_sq) * obs_mask_f     # (V, L)
        Jp = Jp * w[..., None, None]
        Jx = Jx * w[..., None, None]
        rw = r * w[..., None]

        # fixed poses contribute no pose jacobian
        free = (~fix_pose).astype(jnp.float32)
        Jp = Jp * free[:, None, None, None]

        cost = jnp.sum(rw * rw)

        # normal equation blocks
        U = jnp.einsum("vlri,vlrj->vij", Jp, Jp)              # (V, 6, 6)
        Wb = jnp.einsum("vlri,vlrj->vlij", Jp, Jx)            # (V, L, 6, 3)
        Vb = jnp.einsum("vlri,vlrj->lij", Jx, Jx)             # (L, 3, 3)
        gp = -jnp.einsum("vlri,vlr->vi", Jp, rw)              # (V, 6)
        gx = -jnp.einsum("vlri,vlr->li", Jx, rw)              # (L, 3)

        # Marquardt scaling (Ceres LEVENBERG_MARQUARDT parity: the damping
        # term is lam * diag(J^T J), clamped — NOT lam * I). The Hessian
        # diagonal here is ~1e6-1e8 (focal-scaled jacobians over thousands
        # of observations), so an absolute lam*I with lam <= 1e4 never
        # actually damps: rejected-step escalation was a no-op and the loop
        # burned ~14 dead iterations riding lam to its cap after converging.
        lam = lm_lambda
        dU = jnp.clip(_diag3(U, 6), _DIAG_MIN, _DIAG_MAX)     # (V, 6)
        dV = jnp.clip(_diag3(Vb, 3), _DIAG_MIN, _DIAG_MAX)    # (L, 3)
        U_d = U + lam * jax.vmap(jnp.diag)(dU)
        Vb_d = Vb + lam * jax.vmap(jnp.diag)(dV)

        if optimize_structure:
            Vinv = _spd_inv(Vb_d)  # (L, 3, 3)
            # Schur: S = U_full - sum_l W V^-1 W^T  (cross-view coupling)
            WVinv = jnp.einsum("vlij,ljk->vlik", Wb, Vinv)         # (V, L, 6, 3)
            S_blocks = jnp.einsum("vlik,wljk->vwij", WVinv, Wb)    # (V, V, 6, 6)
            S = -S_blocks
            S = S.at[jnp.arange(V), jnp.arange(V)].add(U_d)
            rhs = gp - jnp.einsum("vlik,lk->vi", WVinv, gx)        # (V, 6)

            S_full = S.transpose(0, 2, 1, 3).reshape(6 * V, 6 * V)
            # fixed poses: identity rows/cols so the solve stays well-posed
            free_mask = jnp.repeat(free, 6)
            S_full = S_full * free_mask[:, None] * free_mask[None, :]
            S_full = S_full + jnp.diag(jnp.where(free_mask > 0, 0.0, 1.0))
            rhs_full = rhs.reshape(-1) * free_mask

            dp = (_spd_inv(S_full) @ rhs_full).reshape(V, 6)
            dX = jnp.einsum(
                "lij,lj->li", Vinv,
                gx - jnp.einsum("vlij,vi->lj", Wb, dp),
            )
        else:
            U_full = jax.scipy.linalg.block_diag(
                *[U_d[i] for i in range(V)]
            )
            free_mask = jnp.repeat(free, 6)
            U_full = U_full * free_mask[:, None] * free_mask[None, :]
            U_full = U_full + jnp.diag(jnp.where(free_mask > 0, 0.0, 1.0))
            dp = (_spd_inv(U_full) @ (gp.reshape(-1) * free_mask)).reshape(V, 6)
            dX = jnp.zeros_like(X)

        return dp, dX, cost

    def current_cost(Rs, Cs, X):
        r = residuals(Rs, Cs, X)
        res_sq = jnp.sum(r * r, axis=-1)
        w = _huber_weights(res_sq, delta_sq) * obs_mask_f
        return jnp.sum((r * w[..., None]) ** 2)

    # LM loop as lax.while_loop with a convergence exit: Ceres-style early
    # stopping (function_tolerance semantics, Refiner.hpp:167-169). A fixed
    # scan of max_iterations wastes most of its steps after convergence —
    # the per-frame pose refinement converges in <10 iterations while the
    # reference budget (and our cap) is much larger.
    def lm_cond(state):
        _, _, _, _, _, it, done = state
        return (it < opts.max_iterations) & ~done

    def lm_body(state):
        Rs, Cs, X, lam, nu, it, _ = state
        dp, dX, cost = build_normal_eqs(Rs, Cs, X, lam)
        if not optimize_structure:
            dX = jnp.zeros_like(X)
        Rn, Cn = _apply_pose_delta(Rs, Cs, dp)
        Xn = X + dX
        new_cost = current_cost(Rn, Cn, Xn)
        accept = new_cost < cost
        rel_improve = (cost - new_cost) / jnp.maximum(cost, 1e-12)
        done = accept & (rel_improve < opts.tolerance * 10.0 + 1e-6)
        # parameter tolerance (Ceres semantics): a step below the relative
        # floor can't move the solution meaningfully whether accepted or
        # rejected (more damping only shrinks it further) — converged.
        step_norm = jnp.sqrt(jnp.sum(dp * dp) + jnp.sum(dX * dX))
        state_norm = jnp.sqrt(
            jnp.sum(Cs * Cs) + jnp.sum(X * X) + Rs.shape[0]
        )
        done = done | (step_norm <= _STEP_TOL * (state_norm + _STEP_TOL))
        Rs = jnp.where(accept, Rn, Rs)
        Cs = jnp.where(accept, Cn, Cs)
        X = jnp.where(accept, Xn, X)
        # Nielsen-style escalation: consecutive rejections raise lam by a
        # DOUBLING factor (4, 8, 16, ...) so a stalled solver reaches the
        # heavily-damped regime in a handful of steps, not ~14.
        lam_new = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-8),
                            jnp.minimum(lam * nu, 1e8))
        nu = jnp.where(accept, jnp.float32(4.0), jnp.minimum(nu * 2.0, 1e4))
        done = done | (lam_new >= 1e8)  # step rejection exhausted
        return (Rs, Cs, X, lam_new, nu, it + 1, done)

    init = (problem.Rs, problem.Cs, problem.X, jnp.float32(1e-3),
            jnp.float32(4.0), jnp.int32(0), jnp.asarray(False))
    Rs, Cs, X, _lam, _nu, _it, _done = jax.lax.while_loop(
        lm_cond, lm_body, init
    )

    # ---- covariance at the solution (undamped Schur complement inverse) ----
    cov = _pose_covariance(
        problem, Rs, Cs, X, fix_pose, optimize_structure, cov_view, delta_sq,
        obs_mask_f,
    )

    r = residuals(Rs, Cs, X)
    rmse = jnp.sqrt(
        jnp.sum(jnp.sum(r * r, axis=-1)) / jnp.maximum(n_obs, 1)
    )
    return BAResult(Rs=Rs, Cs=Cs, X=X, cov=cov, rmse=rmse, n_obs=n_obs)


def _pose_covariance(
    problem, Rs, Cs, X, fix_pose, optimize_structure, cov_view, delta_sq,
    obs_mask_f,
):
    """6x6 covariance of pose `cov_view` = corresponding block of the inverse
    reduced camera system (ceres::Covariance parity, Refiner.hpp:177-202)."""
    V = Rs.shape[0]

    def jacs(R, C, K, dist, obs_v):
        def f_obs(Xl, uv):
            def f(p, dx):
                Rp = so3.exp(p[:3]) @ R
                Cp = C + p[3:]
                return _project_residual(Rp, Cp, K, dist, Xl + dx, uv)
            Jp = jax.jacfwd(f, argnums=0)(jnp.zeros(6), jnp.zeros(3))
            Jx = jax.jacfwd(f, argnums=1)(jnp.zeros(6), jnp.zeros(3))
            r = f(jnp.zeros(6), jnp.zeros(3))
            return Jp, Jx, r
        return jax.vmap(f_obs)(X, obs_v)

    Jp, Jx, r = jax.vmap(jacs)(
        Rs, Cs, problem.Ks, problem.dists, problem.obs
    )
    res_sq = jnp.sum(r * r, axis=-1)
    w = _huber_weights(res_sq, delta_sq) * obs_mask_f
    Jp = Jp * w[..., None, None]
    Jx = Jx * w[..., None, None]
    free = (~fix_pose).astype(jnp.float32)
    Jp = Jp * free[:, None, None, None]

    U = jnp.einsum("vlri,vlrj->vij", Jp, Jp)
    if optimize_structure:
        Wb = jnp.einsum("vlri,vlrj->vlij", Jp, Jx)
        Vb = jnp.einsum("vlri,vlrj->lij", Jx, Jx)
        Vinv = _spd_inv(Vb)
        WVinv = jnp.einsum("vlij,ljk->vlik", Wb, Vinv)
        S_blocks = jnp.einsum("vlik,wljk->vwij", WVinv, Wb)
        S = -S_blocks
        S = S.at[jnp.arange(V), jnp.arange(V)].add(U)
    else:
        S = jnp.zeros((V, V, 6, 6))
        S = S.at[jnp.arange(V), jnp.arange(V)].add(U)

    S_full = S.transpose(0, 2, 1, 3).reshape(6 * V, 6 * V)
    free_mask = jnp.repeat(free, 6)
    S_full = S_full * free_mask[:, None] * free_mask[None, :]
    S_full = S_full + jnp.diag(jnp.where(free_mask > 0, 0.0, 1.0))
    Sinv = _spd_inv(S_full)
    i = cov_view * 6
    return jax.lax.dynamic_slice(Sinv, (i, i), (6, 6))


@functools.partial(jax.jit, static_argnames=("opts",))
def refine_pose_only(
    R0: jnp.ndarray,        # (3, 3) initial rotation
    C0: jnp.ndarray,        # (3,) initial center
    X: jnp.ndarray,         # (L, 3) fixed structure
    uv: jnp.ndarray,        # (L, 2) distorted pixel observations
    inliers: jnp.ndarray,   # (L,) bool
    K: jnp.ndarray,
    dist: jnp.ndarray,
    opts: RefinerOptions,
) -> BAResult:
    """Single-pose refinement with structure fixed (Localizer.hpp:132-133 /
    resection-polish pattern).

    Specialized LM: this is the per-frame hot path (SURVEY §3.5), so instead
    of routing through the generic multi-view `refine` (which would carry a
    dummy fixed view and invert the stacked 12x12 system by eigh every LM
    iteration), the single 6x6 damped normal system is solved by Cholesky
    per iteration; the eigh-based PSD-robust inverse runs ONCE at the end
    for the covariance (ceres::Covariance parity, Refiner.hpp:177-202).

    Returns a BAResult shaped like the generic path: Rs/Cs stack a fixed
    identity view 0 with the refined pose at index 1 (cov_view=1 convention,
    Refiner.hpp:188)."""
    delta_sq = opts.huber_delta_sq
    mask_f = inliers.astype(jnp.float32)
    n_obs = jnp.sum(inliers.astype(jnp.int32))
    cam = cam_ops.Camera(K=K, dist=dist)

    def jac_res(R, C):
        def f_obs(Xl, uv_l):
            def f(p):
                Rp = so3.exp(p[:3]) @ R
                Cp = C + p[3:]
                return _project_residual(Rp, Cp, K, dist, Xl, uv_l)
            return jax.jacfwd(f)(jnp.zeros(6)), f(jnp.zeros(6))
        return jax.vmap(f_obs)(X, uv)        # (L, 2, 6), (L, 2)

    def weighted_cost(R, C):
        r = jax.vmap(lambda Xl, uv_l: _project_residual(R, C, K, dist, Xl, uv_l))(X, uv)
        res_sq = jnp.sum(r * r, axis=-1)
        w = _huber_weights(res_sq, delta_sq) * mask_f
        return jnp.sum((r * w[:, None]) ** 2)

    def lm_cond(state):
        _, _, _, _, _, it, done = state
        return (it < opts.max_iterations) & ~done

    def lm_body(state):
        R, C, lam, nu, g0_norm, it, _ = state
        J, r = jac_res(R, C)
        res_sq = jnp.sum(r * r, axis=-1)
        w = _huber_weights(res_sq, delta_sq) * mask_f
        Jw = J * w[:, None, None]
        rw = r * w[:, None]
        cost = jnp.sum(rw * rw)
        U = jnp.einsum("lri,lrj->ij", Jw, Jw)          # (6, 6)
        g = -jnp.einsum("lri,lr->i", Jw, rw)           # (6,)
        # Marquardt scaling (see refine()): damping must be RELATIVE to the
        # Hessian diagonal (~1e6-1e8 here) or rejections never damp.
        dU = jnp.clip(jnp.diag(U), _DIAG_MIN, _DIAG_MAX)
        U_d = U + lam * jnp.diag(dU)
        # 6x6 damped solve: Cholesky with a tiny jitter (U_d is PD by damping)
        cf = jax.scipy.linalg.cho_factor(U_d + 1e-12 * jnp.eye(6))
        dp = jax.scipy.linalg.cho_solve(cf, g)
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
        Rn = so3.exp(dp[:3]) @ R
        Cn = C + dp[3:]
        new_cost = weighted_cost(Rn, Cn)
        accept = new_cost < cost
        rel_improve = (cost - new_cost) / jnp.maximum(cost, 1e-12)
        done = accept & (rel_improve < opts.tolerance * 10.0 + 1e-6)
        # gradient tolerance: at a (local) optimum g -> f32 rounding noise
        # regardless of residual size; relative to the FIRST iteration's
        # gradient. Fires immediately on already-converged inputs — the
        # common case when P3P + inlier re-fit hands over a tight pose.
        g_norm = jnp.max(jnp.abs(g))
        g0_norm = jnp.where(it == 0, g_norm, g0_norm)
        done = done | (g_norm <= 1e-6 * g0_norm + 1e-12)
        # parameter tolerance (Ceres semantics): step below the relative
        # floor -> converged whether accepted or rejected.
        step_norm = jnp.sqrt(jnp.sum(dp * dp))
        done = done | (
            step_norm
            <= _STEP_TOL * (jnp.sqrt(jnp.sum(C * C) + 1.0) + _STEP_TOL)
        )
        R = jnp.where(accept, Rn, R)
        C = jnp.where(accept, Cn, C)
        # Nielsen-style escalation (see refine())
        lam_new = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-8),
                            jnp.minimum(lam * nu, 1e8))
        nu = jnp.where(accept, jnp.float32(4.0), jnp.minimum(nu * 2.0, 1e4))
        done = done | (lam_new >= 1e8)  # step rejection exhausted
        return (R, C, lam_new, nu, g0_norm, it + 1, done)

    init = (R0, C0, jnp.float32(1e-3), jnp.float32(4.0), jnp.float32(0.0),
            jnp.int32(0), jnp.asarray(False))
    R, C, _lam, _nu, _g0, _it, _done = jax.lax.while_loop(
        lm_cond, lm_body, init
    )

    # covariance + rmse at the solution (undamped; PSD-robust inverse once)
    J, r = jac_res(R, C)
    res_sq = jnp.sum(r * r, axis=-1)
    w = _huber_weights(res_sq, delta_sq) * mask_f
    Jw = J * w[:, None, None]
    U = jnp.einsum("lri,lrj->ij", Jw, Jw)
    cov = _spd_inv(U)
    rmse = jnp.sqrt(jnp.sum(res_sq * mask_f) / jnp.maximum(n_obs, 1))

    return BAResult(
        Rs=jnp.stack([jnp.eye(3), R]),
        Cs=jnp.stack([jnp.zeros(3), C]),
        X=X,
        cov=cov,
        rmse=rmse,
        n_obs=n_obs,
    )
