"""Robust two-view and absolute pose estimation (RobustMatcher parity layer).

Reference parity: RobustMatcher.hpp —
  computeRelativePose (:372-424): undistort matched coords, dispatch on
    params.model 'E'/'F'/'H', AC-RANSAC, accept iff inliers >= 2.5 x minimal
    sample (:147,175,210), produce RelativePose_Info.
  filterMatches/filterMatchesPair (:426-483): store inlier matches + relative
    pose per pair.
Plus the P3P absolute-pose kernel shared with Localizer.hpp:77-108.

Everything is jit-compatible: failure is a `success` flag, not an exception
(masked failure semantics, SURVEY.md §5 failure handling).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from coloc_tpu.config import RansacOptions
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import essential as ess
from coloc_tpu.geometry import fivept
from coloc_tpu.geometry import homography as homog
from coloc_tpu.geometry import p3p as p3p_ops
from coloc_tpu.ransac import RansacResult, ransac
from coloc_tpu.types import Pose, TwoViewGeometry


def _mean_focal(cam: cam_ops.Camera) -> jnp.ndarray:
    return (cam.fx + cam.fy) * 0.5


def _point_log_alpha0(cam: cam_ops.Camera) -> jnp.ndarray:
    """log10 constant for POINT error in pixels: alpha_k = (pi / A) e_k^2."""
    A = (2.0 * cam.cx) * (2.0 * cam.cy)
    return jnp.log10(jnp.pi / A)


@functools.partial(jax.jit, static_argnames=("opts",))
def relative_pose_essential(
    key: jax.Array,
    uv1: jnp.ndarray,      # (M, 2) distorted pixels, camera 1
    uv2: jnp.ndarray,      # (M, 2) distorted pixels, camera 2
    mask: jnp.ndarray,     # (M,) bool valid correspondences
    cam1: cam_ops.Camera,
    cam2: cam_ops.Camera,
    opts: RansacOptions,
) -> TwoViewGeometry:
    """Model 'E' path: batched Nistér 5-point RANSAC + decomposition +
    Gauss-Newton polish on the essential manifold.

    The 5-point minimal solver (vs 8-point) is required for plane-dominant
    scenes — the common MAV case — where the linear solver degenerates
    (geometry/fivept.py docstring)."""
    x1 = cam_ops.undistort(cam1, cam_ops.normalize(cam1, uv1))
    x2 = cam_ops.undistort(cam2, cam_ops.normalize(cam2, uv2))

    # residuals in PIXELS with each side scaled by its own camera's focal
    # (drones may carry different lenses); threshold stays in pixels
    f1_sq = _mean_focal(cam1) ** 2
    f2_sq = _mean_focal(cam2) ** 2
    thr_sq = opts.essential_threshold ** 2

    def solver(s1, s2):
        return fivept.five_point(s1, s2)  # (30, 3, 3), (30,)

    def scorer(E, a1, a2):
        return ess.symmetric_epipolar_distance_sq(E, a1, a2, f1_sq, f2_sq)

    def batch_scorer(Es, a1, a2):
        return ess.symmetric_epipolar_distance_sq_batch(
            Es, a1, a2, f1_sq, f2_sq
        )

    def rank_scorer(Es, a1, a2):
        # DEFAULT-precision matmuls (TF32 on the GPU): feeds only the
        # NFA candidate pre-rank ladder
        return ess.symmetric_epipolar_distance_sq_batch(
            Es, a1, a2, f1_sq, f2_sq, precision=jax.lax.Precision.DEFAULT
        )


    # log_alpha0 for point-to-line error in PIXEL units
    A_px = (2.0 * cam1.cx) * (2.0 * cam1.cy)
    D_px = jnp.sqrt((2.0 * cam1.cx) ** 2 + (2.0 * cam1.cy) ** 2)
    res = ransac(
        key, (x1, x2), mask, solver, scorer,
        sample_size=5, num_hypotheses=opts.num_hypotheses,
        threshold_sq=thr_sq, inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=jnp.log10(2.0 * D_px / A_px),
        error_dim=1.0, batch_scorer=batch_scorer, rank_scorer=rank_scorer,
    )

    R, t = ess.decompose_essential(res.model, x1, x2, res.inliers)
    # manifold-respecting local optimization on the inlier set (plays the
    # role of ACRANSAC's refinement; planar-safe, unlike a linear re-fit)
    R, t = ess.refine_relative_pose(
        R, t, x1, x2, res.inliers.astype(jnp.float32)
    )
    E_ref = ess.hat3(t) @ R
    refined_inl = (scorer(E_ref, x1, x2) < res.threshold_sq) & mask
    keep = jnp.sum(refined_inl) >= res.n_inliers
    # if the refinement landed in a worse basin, revert BOTH the inlier set
    # and the model (returning a pose from a rejected model would make the
    # reported inliers inconsistent with the returned (R, t))
    inliers = jnp.where(keep, refined_inl, res.inliers)
    n_inliers = jnp.sum(inliers.astype(jnp.int32))
    E_final = jnp.where(keep, E_ref, res.model)
    # The Sampson objective is blind to the +-t / twisted-pair ambiguity, so
    # from a poor seed the GN can land in the antipodal basin (all depths
    # negative). Re-run the cheirality vote on the final E to pick the
    # physically-consistent motion (RelativePoseFromEssential semantics).
    R, t = ess.decompose_essential(E_final, x1, x2, inliers)
    return TwoViewGeometry(
        R=R, t=t, inliers=inliers,
        n_inliers=n_inliers, success=res.success,
    )


@functools.partial(jax.jit, static_argnames=("opts",))
def relative_pose_fundamental(
    key: jax.Array,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    cam1: cam_ops.Camera,
    cam2: cam_ops.Camera,
    opts: RansacOptions,
) -> TwoViewGeometry:
    """Model 'F' path: 7-point fundamental RANSAC on pixel coords, then
    E = K2^T F K1 and the same decomposition (RobustMatcher.hpp:134-150)."""
    u1 = cam_ops.undistort_pixel(cam1, uv1)
    u2 = cam_ops.undistort_pixel(cam2, uv2)

    def solver(s1, s2):
        return ess.seven_point(s1, s2)  # (3, 3, 3), (3,)

    def scorer(F, a1, a2):
        return ess.symmetric_epipolar_distance_sq(F, a1, a2)

    def batch_scorer(Fs, a1, a2):
        return ess.symmetric_epipolar_distance_sq_batch(Fs, a1, a2)

    def rank_scorer(Fs, a1, a2):
        # DEFAULT-precision matmuls (TF32 on the GPU): feeds only the
        # NFA candidate pre-rank ladder
        return ess.symmetric_epipolar_distance_sq_batch(
            Fs, a1, a2, precision=jax.lax.Precision.DEFAULT
        )

    thr_sq = opts.essential_threshold ** 2

    # log_alpha0 for point-to-line error in PIXEL units
    A_px = (2.0 * cam1.cx) * (2.0 * cam1.cy)
    D_px = jnp.sqrt((2.0 * cam1.cx) ** 2 + (2.0 * cam1.cy) ** 2)
    res = ransac(
        key, (u1, u2), mask, solver, scorer,
        sample_size=7, num_hypotheses=opts.num_hypotheses,
        threshold_sq=thr_sq,
        inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=jnp.log10(2.0 * D_px / A_px),
        error_dim=1.0, batch_scorer=batch_scorer, rank_scorer=rank_scorer,
    )
    # least-squares re-fit over the inlier set (see essential path)
    F_refit = ess.fundamental_8pt(u1, u2, weights=res.inliers.astype(jnp.float32))
    refit_inl = (scorer(F_refit, u1, u2) < res.threshold_sq) & mask
    better = jnp.sum(refit_inl) >= res.n_inliers
    res = res._replace(
        model=jnp.where(better, F_refit, res.model),
        inliers=jnp.where(better, refit_inl, res.inliers),
        n_inliers=jnp.where(
            better, jnp.sum(refit_inl.astype(jnp.int32)), res.n_inliers
        ),
    )
    E = cam2.K.T @ res.model @ cam1.K
    x1 = cam_ops.normalize(cam1, u1)
    x2 = cam_ops.normalize(cam2, u2)
    R, t = ess.decompose_essential(E, x1, x2, res.inliers)
    return TwoViewGeometry(
        R=R, t=t, inliers=res.inliers,
        n_inliers=res.n_inliers, success=res.success,
    )


def _p3p_batch_residuals(
    flats: jnp.ndarray,     # (Hm, 12) row-major R | C per model
    Xw: jnp.ndarray,        # (M, 3)
    bearings: jnp.ndarray,  # (M, 3)
    focal: jnp.ndarray,
    precision=None,
) -> jnp.ndarray:
    """All-models P3P reprojection residuals as 3 matmuls + epilogue, (Hm, M).

    vmap of the per-model scorer lowers the camera transform to Hm tiny K=3
    contractions (~0.17 ms at Hm=1024, M=1024 — the single biggest slice of
    the per-frame P3P budget); instead, with t_m = R_m C_m and the residual
    cleared of the per-element division:
      err = f^2 ((Xc_x - ox z)^2 + (Xc_y - oy z)^2) / z^2,
      Xc_k[m, l] = [X_l, -1] . [rowk(R_m), t_mk]
    so each camera-frame coordinate plane is one (Hm, 4) x (4, M) matmul —
    model side on the LEFT so the result lands directly in the (Hm, M)
    output layout (no (M, Hm, 3) intermediate, no final transpose).
    Values match the per-model scorer to f32 rounding
    (tests/test_robust.py::TestBatchScorerParity pins this).

    precision: None inherits the library-wide HIGHEST; pass
    jax.lax.Precision.DEFAULT for single-pass (TF32 on the GPU) matmuls
    when the residuals only feed the RANSAC pre-rank ladder.
    """
    Hm = flats.shape[0]
    R = flats[:, :9].reshape(Hm, 3, 3)
    C = flats[:, 9:]
    t = jnp.einsum("mkd,md->mk", R, C)                # (Hm, 3) = R_m C_m
    E = jnp.concatenate([R, t[:, :, None]], axis=2)   # (Hm, 3, 4)
    Xh = jnp.concatenate([Xw, -jnp.ones_like(Xw[:, :1])], axis=-1).T  # (4, M)
    A0 = jnp.matmul(E[:, 0], Xh, precision=precision)  # (Hm, M) = Xc_x
    A1 = jnp.matmul(E[:, 1], Xh, precision=precision)  # Xc_y
    Z = jnp.matmul(E[:, 2], Xh, precision=precision)   # Xc_z
    obs = bearings[:, :2] / jnp.maximum(bearings[:, 2:3], 1e-9)  # (M, 2)
    u = A0 - obs[:, 0][None, :] * Z
    v = A1 - obs[:, 1][None, :] * Z
    zc = jnp.maximum(Z, 1e-9)
    err = (u * u + v * v) / (zc * zc) * focal ** 2
    return jnp.where(Z <= 0, 1e12, err)               # (Hm, M)


@functools.partial(jax.jit, static_argnames=("opts",))
def absolute_pose_p3p(
    key: jax.Array,
    X_world: jnp.ndarray,  # (M, 3) landmark positions
    uv: jnp.ndarray,       # (M, 2) distorted pixel observations
    mask: jnp.ndarray,     # (M,) bool
    cam: cam_ops.Camera,
    opts: RansacOptions,
) -> Tuple[Pose, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """P3P RANSAC (Localizer.hpp:77-108 / resection parity).

    Returns (pose, inliers (M,), n_inliers, success).
    """
    b = cam_ops.bearing(cam, uv)  # (M, 3)

    def solver(Xs, bs):
        poses, valid = p3p_ops.p3p_grunert(Xs, bs)
        flat = jnp.concatenate(
            [poses.R.reshape(4, 9), poses.C.reshape(4, 3)], axis=1
        )  # (4, 12)
        return flat, valid

    def scorer(flat, Xw, bearings):
        R = flat[:9].reshape(3, 3)
        C = flat[9:]
        Xc = (Xw - C) @ R.T
        # residual between observed bearing and predicted direction, scaled to
        # pixels: angle ~ tan(angle) * focal
        proj = Xc / jnp.maximum(Xc[:, 2:3], 1e-9)
        obs = bearings / jnp.maximum(bearings[:, 2:3], 1e-9)
        err = jnp.sum((proj[:, :2] - obs[:, :2]) ** 2, axis=-1)
        err = err * _mean_focal(cam) ** 2
        behind = Xc[:, 2] <= 0
        return jnp.where(behind, 1e12, err)

    def batch_scorer(flats, Xw, bearings):
        return _p3p_batch_residuals(flats, Xw, bearings, _mean_focal(cam))

    def rank_scorer(flats, Xw, bearings):
        # DEFAULT-precision matmuls (TF32 on the GPU): feeds only the
        # NFA candidate pre-rank ladder
        return _p3p_batch_residuals(
            flats, Xw, bearings, _mean_focal(cam),
            precision=jax.lax.Precision.DEFAULT,
        )

    res = ransac(
        key, (X_world, b), mask, solver, scorer,
        sample_size=3, num_hypotheses=opts.num_hypotheses,
        threshold_sq=opts.p3p_threshold ** 2,
        inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=_point_log_alpha0(cam),
        error_dim=2.0, batch_scorer=batch_scorer, rank_scorer=rank_scorer,
    )
    pose = Pose(R=res.model[:9].reshape(3, 3), C=res.model[9:])
    return pose, res.inliers, res.n_inliers, res.success


@functools.partial(jax.jit, static_argnames=("opts",))
def relative_pose_homography(
    key: jax.Array,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    mask: jnp.ndarray,
    cam1: cam_ops.Camera,
    cam2: cam_ops.Camera,
    opts: RansacOptions,
) -> TwoViewGeometry:
    """Model 'H' path: 4-point homography RANSAC + Euclidean decomposition +
    chirality disambiguation (RobustMatcher.hpp:188-206, :39-126)."""
    x1 = cam_ops.undistort(cam1, cam_ops.normalize(cam1, uv1))
    x2 = cam_ops.undistort(cam2, cam_ops.normalize(cam2, uv2))
    # forward transfer error lives in IMAGE 2 -> scale by camera 2's focal
    # (per-camera normalization; drones may carry different lenses)
    f2_sq = _mean_focal(cam2) ** 2
    thr_sq = opts.homography_threshold ** 2

    def solver(s1, s2):
        H = homog.four_point(s1, s2)
        return H[None], jnp.ones((1,), bool)

    def scorer(H, a1, a2):
        return f2_sq * homog.transfer_error_sq(H, a1, a2)

    def batch_scorer(Hs, a1, a2):
        return f2_sq * homog.transfer_error_sq_batch(Hs, a1, a2)

    def rank_scorer(Hs, a1, a2):
        # DEFAULT-precision matmuls (TF32 on the GPU): feeds only the
        # NFA candidate pre-rank ladder
        return f2_sq * homog.transfer_error_sq_batch(
            Hs, a1, a2, precision=jax.lax.Precision.DEFAULT
        )

    # log_alpha0 for POINT transfer error in image-2 PIXEL units
    A_px = (2.0 * cam2.cx) * (2.0 * cam2.cy)
    res = ransac(
        key, (x1, x2), mask, solver, scorer,
        sample_size=4, num_hypotheses=opts.num_hypotheses,
        threshold_sq=thr_sq, inlier_multiple=opts.inlier_multiple,
        scoring=opts.scoring, log_alpha0=jnp.log10(jnp.pi / A_px),
        error_dim=2.0, batch_scorer=batch_scorer, rank_scorer=rank_scorer,
    )
    # least-squares re-fit over the inlier set before decomposition (the
    # minimal 4-point H limits translation-direction accuracy; same
    # keep-if-better pattern as the E/F paths)
    H_refit = homog.four_point(x1, x2, weights=res.inliers.astype(jnp.float32))
    refit_inl = (scorer(H_refit, x1, x2) < res.threshold_sq) & mask
    better = jnp.sum(refit_inl) >= res.n_inliers
    res = res._replace(
        model=jnp.where(better, H_refit, res.model),
        inliers=jnp.where(better, refit_inl, res.inliers),
        n_inliers=jnp.where(
            better, jnp.sum(refit_inl.astype(jnp.int32)), res.n_inliers
        ),
    )
    R, t, _n, chirality_ok = homog.decompose_homography(
        res.model, x1, x2, res.inliers, opts.chirality_ratio
    )
    return TwoViewGeometry(
        R=R, t=t, inliers=res.inliers,
        n_inliers=res.n_inliers, success=res.success & chirality_ok,
    )
