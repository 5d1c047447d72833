"""Robust geometry tests: minimal solvers on synthetic minimal sets + full
RANSAC pipelines with outliers (SURVEY.md §4: '5-pt/P3P minimal solvers on
synthetic minimal sets', golden two-view configs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import RansacOptions
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import essential as ess
from coloc_tpu.geometry import homography as homog
from coloc_tpu.geometry import p3p as p3p_ops
from coloc_tpu.geometry import so3
from coloc_tpu.robust import (
    absolute_pose_p3p,
    relative_pose_essential,
    relative_pose_fundamental,
    relative_pose_homography,
)

K = jnp.asarray(
    [[458.0, 0.0, 376.0], [0.0, 457.0, 240.0], [0.0, 0.0, 1.0]], jnp.float32
)
CAM = cam_ops.Camera(K=K, dist=jnp.zeros(3, jnp.float32))


def make_two_view(rng, n=200, n_outliers=80, planar=False):
    """Synthetic two-view scene. Returns pixels uv1, uv2, GT (R, C), X."""
    R = jnp.asarray(so3.exp(jnp.asarray([0.03, -0.25, 0.02], jnp.float32)))
    C = jnp.asarray([1.0, 0.15, 0.05], jnp.float32)
    if planar:
        X = np.c_[rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 8.0)]
        # tilt the plane a bit
        X = X @ np.asarray(so3.exp(jnp.asarray([0.2, 0.1, 0.0]))).T
        X[:, 2] += 8.0
    else:
        X = np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(5, 15, (n, 1))]
    X = jnp.asarray(X, jnp.float32)
    uv1 = cam_ops.project(CAM, jnp.eye(3), jnp.zeros(3), X)
    uv2 = cam_ops.project(CAM, R, C, X)
    # corrupt the last n_outliers with random pixels
    bad = jnp.asarray(
        rng.uniform(50, 600, (n_outliers, 2)), jnp.float32
    )
    uv2 = uv2.at[n - n_outliers :].set(bad)
    inlier_gt = np.arange(n) < n - n_outliers
    return uv1, uv2, R, C, X, inlier_gt


def rot_err_deg(Ra, Rb):
    cos = (np.trace(np.asarray(Ra).T @ np.asarray(Rb)) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def dir_err_deg(a, b):
    a = np.asarray(a) / np.linalg.norm(a)
    b = np.asarray(b) / np.linalg.norm(b)
    return np.degrees(np.arccos(np.clip(abs(a @ b), -1, 1)))


class TestEightPoint:
    def test_exact_minimal(self, rng):
        uv1, uv2, R, C, X, _ = make_two_view(rng, n=8, n_outliers=0)
        x1 = cam_ops.normalize(CAM, uv1)
        x2 = cam_ops.normalize(CAM, uv2)
        E = ess.eight_point(x1, x2)
        # epipolar residuals must vanish (up to f32 eigh conditioning)
        res = ess.symmetric_epipolar_distance_sq(E, x1, x2)
        assert np.asarray(res).max() < 1e-5

    def test_decomposition_recovers_motion(self, rng):
        uv1, uv2, R, C, X, _ = make_two_view(rng, n=50, n_outliers=0)
        x1 = cam_ops.normalize(CAM, uv1)
        x2 = cam_ops.normalize(CAM, uv2)
        E = ess.eight_point(x1, x2)
        Rr, tr = ess.decompose_essential(E, x1, x2, jnp.ones(50, bool))
        assert rot_err_deg(Rr, R) < 0.5
        t_gt = -np.asarray(R) @ np.asarray(C)
        assert dir_err_deg(tr, t_gt) < 0.5


class TestFivePoint:
    def _make(self, rng, n, planar):
        R = jnp.asarray(so3.exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)))
        C = jnp.asarray(rng.normal(0, 0.5, 3), jnp.float32)
        if planar:
            X = np.c_[rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 8.0)]
        else:
            X = np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(5, 15, (n, 1))]
        X = jnp.asarray(X, jnp.float32)
        x1 = X[:, :2] / X[:, 2:]
        Xc = (X - C) @ R.T
        x2 = Xc[:, :2] / Xc[:, 2:]
        return x1, x2

    @pytest.mark.parametrize("planar", [False, True])
    def test_minimal_solves(self, rng, planar):
        """Every synthetic minimal set must yield a candidate E that nulls
        the epipolar residual on held-out points — including PLANAR sets,
        the case the 8-point solver cannot handle."""
        from coloc_tpu.geometry import fivept

        for _ in range(10):
            x1, x2 = self._make(rng, 8, planar)
            Es, valid = fivept.five_point(x1[:5], x2[:5])
            best = 1e9
            for i in range(len(valid)):
                if bool(valid[i]):
                    r = float(np.asarray(
                        ess.symmetric_epipolar_distance_sq(Es[i], x1, x2)
                    ).max())
                    best = min(best, r)
            assert best < 1e-4, f"5pt failed: residual {best}"


class TestEssentialRansac:
    def test_plane_dominant_scene(self, rng):
        """90% of points on one plane + 10% off-plane: 8-point degenerates
        here; the 5-point path must stay accurate (the MAV-camera case)."""
        R = jnp.asarray(so3.exp(jnp.asarray([0.01, -0.06, 0.005], jnp.float32)))
        C = jnp.asarray([0.5, 0.08, 0.0], jnp.float32)
        n_plane, n_off = 180, 20
        Xp = np.c_[rng.uniform(-4, 4, (n_plane, 2)), np.full((n_plane, 1), 12.0)]
        Xo = np.c_[rng.uniform(-2, 2, (n_off, 2)), rng.uniform(5, 9, (n_off, 1))]
        X = jnp.asarray(np.vstack([Xp, Xo]), jnp.float32)
        uv1 = cam_ops.project(CAM, jnp.eye(3), jnp.zeros(3), X)
        uv2 = cam_ops.project(CAM, R, C, X)
        rng2 = np.random.default_rng(1)
        uv1 = uv1 + jnp.asarray(rng2.normal(0, 0.3, uv1.shape), jnp.float32)
        uv2 = uv2 + jnp.asarray(rng2.normal(0, 0.3, uv2.shape), jnp.float32)
        geo = relative_pose_essential(
            jax.random.PRNGKey(0), uv1, uv2, jnp.ones(200, bool), CAM, CAM,
            RansacOptions(),
        )
        assert bool(geo.success)
        assert rot_err_deg(geo.R, R) < 0.5
        t_gt = -np.asarray(R) @ np.asarray(C)
        assert dir_err_deg(geo.t, t_gt) < 3.0

    def test_with_outliers(self, rng):
        uv1, uv2, R, C, X, inl_gt = make_two_view(rng, n=200, n_outliers=80)
        geo = relative_pose_essential(
            jax.random.PRNGKey(0), uv1, uv2, jnp.ones(200, bool), CAM, CAM,
            RansacOptions(),
        )
        assert bool(geo.success)
        assert rot_err_deg(geo.R, R) < 1.0
        t_gt = -np.asarray(R) @ np.asarray(C)
        assert dir_err_deg(geo.t, t_gt) < 1.0
        inl = np.asarray(geo.inliers)
        # recovered inlier set must essentially equal ground truth
        assert (inl & ~inl_gt).sum() <= 3
        assert inl[inl_gt].mean() > 0.9

    def test_insufficient_inliers_fails(self, rng):
        uv1, uv2, *_ = make_two_view(rng, n=24, n_outliers=20)
        geo = relative_pose_essential(
            jax.random.PRNGKey(0), uv1, uv2, jnp.ones(24, bool), CAM, CAM,
            RansacOptions(),
        )
        assert not bool(geo.success)


class TestFundamentalRansac:
    def test_with_outliers(self, rng):
        uv1, uv2, R, C, X, _ = make_two_view(rng, n=200, n_outliers=60)
        geo = relative_pose_fundamental(
            jax.random.PRNGKey(1), uv1, uv2, jnp.ones(200, bool), CAM, CAM,
            RansacOptions(),
        )
        assert bool(geo.success)
        assert rot_err_deg(geo.R, R) < 1.5


class TestP3P:
    def test_minimal_exact(self, rng):
        R = jnp.asarray(so3.exp(jnp.asarray([0.1, 0.4, -0.2], jnp.float32)))
        C = jnp.asarray([0.5, -0.3, 0.2], jnp.float32)
        X = jnp.asarray(rng.uniform(-2, 2, (3, 3)) + [0, 0, 8], jnp.float32)
        Xc = (X - C) @ R.T
        b = Xc / jnp.linalg.norm(Xc, axis=1, keepdims=True)
        poses, valid = p3p_ops.p3p_grunert(X, b)
        found = False
        for i in range(4):
            if not bool(valid[i]):
                continue
            if rot_err_deg(poses.R[i], R) < 0.5 and np.linalg.norm(
                np.asarray(poses.C[i] - C)
            ) < 0.05:
                found = True
        assert found, "no P3P candidate matched ground truth"

    def test_ransac_with_outliers(self, rng):
        R = jnp.asarray(so3.exp(jnp.asarray([0.05, 0.3, -0.1], jnp.float32)))
        C = jnp.asarray([0.4, -0.2, 0.3], jnp.float32)
        n, n_out = 150, 50
        X = jnp.asarray(
            np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(5, 14, (n, 1))],
            jnp.float32,
        )
        uv = cam_ops.project(CAM, R, C, X)
        uv = uv.at[n - n_out :].set(
            jnp.asarray(rng.uniform(50, 600, (n_out, 2)), jnp.float32)
        )
        pose, inliers, n_inl, success = absolute_pose_p3p(
            jax.random.PRNGKey(2), X, uv, jnp.ones(n, bool), CAM, RansacOptions()
        )
        assert bool(success)
        assert rot_err_deg(pose.R, R) < 0.5
        assert np.linalg.norm(np.asarray(pose.C - C)) < 0.05
        assert int(n_inl) >= n - n_out - 5


class TestHomography:
    def test_four_point_exact(self, rng):
        uv1, uv2, R, C, X, _ = make_two_view(rng, n=4, n_outliers=0, planar=True)
        x1 = cam_ops.normalize(CAM, uv1)
        x2 = cam_ops.normalize(CAM, uv2)
        H = homog.four_point(x1, x2)
        err = homog.transfer_error_sq(H, x1, x2)
        assert np.asarray(err).max() < 1e-4  # f32 eigh precision

    def test_ransac_planar_scene(self, rng):
        uv1, uv2, R, C, X, _ = make_two_view(rng, n=120, n_outliers=30, planar=True)
        geo = relative_pose_homography(
            jax.random.PRNGKey(3), uv1, uv2, jnp.ones(120, bool), CAM, CAM,
            RansacOptions(),
        )
        assert bool(geo.success)
        assert rot_err_deg(geo.R, R) < 2.0
        t_gt = -np.asarray(R) @ np.asarray(C)
        assert dir_err_deg(geo.t, t_gt) < 2.0


class TestSampleIndices:
    def test_no_duplicates_within_sample(self):
        from coloc_tpu import ransac as rs

        for m, n_valid, s, seed in [(64, 64, 5, 0), (256, 40, 7, 1), (32, 9, 3, 2)]:
            valid = jnp.arange(m) < n_valid
            idx = np.asarray(
                rs.sample_indices(jax.random.PRNGKey(seed), valid, 512, s)
            )
            # all drawn indices point at valid entries
            assert (idx < n_valid).all()
            # distinct within every sample (n_valid >= s in all cases)
            n_unique = np.array([len(set(row)) for row in idx])
            assert (n_unique == s).all()

    def test_marginal_roughly_uniform(self):
        from coloc_tpu import ransac as rs

        m, s = 50, 5
        valid = jnp.ones(m, bool)
        idx = np.asarray(
            rs.sample_indices(jax.random.PRNGKey(7), valid, 4000, s)
        ).ravel()
        counts = np.bincount(idx, minlength=m)
        expect = len(idx) / m  # 400
        assert counts.min() > 0.6 * expect and counts.max() < 1.4 * expect

    def test_fewer_valid_than_sample_size_stays_in_range(self):
        from coloc_tpu import ransac as rs

        valid = jnp.arange(32) < 2
        idx = np.asarray(rs.sample_indices(jax.random.PRNGKey(0), valid, 16, 5))
        assert (idx < 2).all() and (idx >= 0).all()


class TestNfaAdaptiveThreshold:
    """ACRANSAC parity (RobustMatcher.hpp:142,170,206): the reference passes
    initial_residual_tolerance = INFINITY, so the inlier threshold is fully
    data-adaptive. On noisy-but-consistent data the adaptive threshold opens
    past a too-tight fixed gate and recovers inliers fixed-threshold scoring
    misses, while far (statistically meaningless) junk is still rejected."""

    def _noisy_p3p(self, rng, noise_px, n_junk):
        n = 256
        X = jnp.asarray(
            np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(5, 12, (n, 1))],
            jnp.float32,
        )
        R = jnp.asarray(so3.exp(jnp.asarray([0.02, -0.1, 0.03], jnp.float32)))
        C = jnp.asarray([0.4, -0.1, 0.1], jnp.float32)
        uv = np.array(cam_ops.project(CAM, R, C, X))
        uv += rng.normal(0.0, noise_px, uv.shape)
        # far junk: uniform over the image, nowhere near the model
        uv[:n_junk] = rng.uniform(20, 700, (n_junk, 2))
        return X, jnp.asarray(uv, jnp.float32), np.arange(n) < n_junk

    def test_nfa_recovers_inliers_fixed_threshold_misses(self, rng):
        # observation noise sigma = 4 px: most true residuals exceed the
        # fixed 4 px gate, so count-scoring keeps only the lucky sub-gate
        # fraction; the adaptive threshold opens to the real noise level
        X, uv, junk = self._noisy_p3p(rng, noise_px=4.0, n_junk=40)
        mask = jnp.ones(X.shape[0], bool)
        key = jax.random.PRNGKey(3)

        _, inl_c, n_c, ok_c = absolute_pose_p3p(
            key, X, uv, mask, CAM, RansacOptions(scoring="count")
        )
        _, inl_n, n_n, ok_n = absolute_pose_p3p(
            key, X, uv, mask, CAM, RansacOptions(scoring="nfa")
        )
        assert bool(ok_n)
        true_inl = (~junk).sum()  # 216
        # fixed gate misses a large share of the true inliers ...
        assert int(np.asarray(inl_c)[~junk].sum()) < 0.8 * true_inl
        # ... the adaptive threshold recovers nearly all of them
        assert int(np.asarray(inl_n)[~junk].sum()) > 0.9 * true_inl
        # and still rejects the far junk (statistically meaningless)
        assert int(np.asarray(inl_n)[junk].sum()) < 8

    def test_prerank_winner_equals_exhaustive_nfa(self):
        """The count-ladder pre-rank (exact NFA only on the top-32
        candidates, ransac.py) must pick the SAME winner as exhaustive NFA
        over all models — across 50 seeded scenes at reference capacity
        shapes (Hm=1024 models, M=5000 correspondences) spanning the
        regimes NFA exists for: inlier ratios 0.15-0.9, noise 0.3-12 px vs
        a 4 px seed gate (incl. adaptive-up where the static ladder rungs
        are blind). Uses a cheap synthetic model family (2-D lines,
        sample_size=2) so the property runs at full capacity — the pre-rank
        operates purely on the (Hm, M) residual matrix, independent of the
        model family that produced it."""
        from coloc_tpu.ransac import (
            _NFA_CANDIDATES, nfa_scores, ransac, sample_indices,
        )

        M, B = 5000, 1024
        S = 2
        log_alpha0 = float(np.log10(2.0 * 900.0 / (640.0 * 480.0)))

        def solver(s1, s2):
            # s1: the 2 sampled points (S=2, 2); line through them
            p1, p2 = s1[0], s1[1]
            d = p2 - p1
            n = jnp.stack([-d[1], d[0]])
            norm = jnp.linalg.norm(n)
            ok = norm > 1e-6
            n = n / jnp.maximum(norm, 1e-9)
            c = -jnp.dot(n, p1)
            return jnp.concatenate([n, c[None]])[None, :], ok[None]

        def scorer(model, a1, a2):
            return (a1 @ model[:2] + model[2]) ** 2

        mismatches = 0
        for seed in range(50):
            r = np.random.default_rng(seed)
            ratio = float(r.uniform(0.15, 0.9))
            sigma = float(r.uniform(0.3, 12.0))
            n_in = int(M * ratio)
            t = r.uniform(-300, 300, n_in)
            line_n = r.normal(size=2)
            line_n /= np.linalg.norm(line_n)
            p0 = r.uniform(100, 500, 2)
            tang = np.array([-line_n[1], line_n[0]])
            pts_in = p0 + t[:, None] * tang + (
                r.normal(size=(n_in, 1)) * sigma * line_n
            )
            pts_out = r.uniform(0, (640, 480), (M - n_in, 2))
            pts = np.concatenate([pts_in, pts_out]).astype(np.float32)
            data = (jnp.asarray(pts), jnp.asarray(pts))
            valid = jnp.ones(M, bool)
            key = jax.random.PRNGKey(1000 + seed)

            res = ransac(
                key, data, valid, solver, scorer, sample_size=S,
                num_hypotheses=B, threshold_sq=16.0, scoring="nfa",
                log_alpha0=log_alpha0, error_dim=1.0,
            )

            # exhaustive reference: same samples -> same model set; score ALL
            idx = sample_indices(key, valid, B, S)
            g = tuple(d[idx] for d in data)
            models, mvalid = jax.vmap(solver)(*g)
            flat = models.reshape(-1, 3)
            fvalid = mvalid.reshape(-1)
            all_res = jax.vmap(lambda m: scorer(m, *data))(flat)
            score, thr = nfa_scores(all_res, valid, S, log_alpha0, 1.0)
            score = jnp.where(fvalid, score, jnp.inf)
            best = int(jnp.argmin(score))
            best_score = float(score[best])

            # production winner must achieve the exhaustive-minimum NFA
            # (ties in NFA may legitimately pick a different but equal model)
            prod_res = scorer(res.model, *data)
            prod_score, _ = nfa_scores(
                prod_res[None], valid, S, log_alpha0, 1.0
            )
            if not np.isclose(float(prod_score[0]), best_score,
                              rtol=1e-5, atol=1e-5):
                mismatches += 1
        assert mismatches == 0, (
            f"pre-rank missed the exhaustive-NFA winner on {mismatches}/50 "
            f"seeds (widen _NFA_CANDIDATES={_NFA_CANDIDATES})"
        )

    def test_nfa_matches_count_on_clean_data(self, rng):
        # sub-gate noise: both scorings find essentially the same inlier set
        X, uv, junk = self._noisy_p3p(rng, noise_px=0.3, n_junk=40)
        mask = jnp.ones(X.shape[0], bool)
        key = jax.random.PRNGKey(4)
        _, inl_c, n_c, ok_c = absolute_pose_p3p(
            key, X, uv, mask, CAM, RansacOptions(scoring="count")
        )
        _, inl_n, n_n, ok_n = absolute_pose_p3p(
            key, X, uv, mask, CAM, RansacOptions(scoring="nfa")
        )
        assert bool(ok_c) and bool(ok_n)
        assert int(np.asarray(inl_n)[~junk].sum()) > 0.9 * int(
            np.asarray(inl_c)[~junk].sum()
        )
        assert int(np.asarray(inl_n)[junk].sum()) < 8


class TestBatchScorerParity:
    """The matmul-batched all-models scorers must agree with the per-model
    scorers they replace (ransac() classifies the winner's inliers with the
    single-model scorer, so any disagreement silently shifts NFA ranks)."""

    def test_pack_valid_first_matches_stable_argsort(self):
        from coloc_tpu.ransac import _pack_valid_first

        rng = np.random.default_rng(3)
        for n, p in [(64, 0.5), (1024, 0.9), (1024, 0.1), (17, 1.0), (8, 0.0)]:
            valid = jnp.asarray(rng.random(n) < p)
            got = np.asarray(_pack_valid_first(valid))
            want = np.argsort(np.asarray(~valid), kind="stable")
            np.testing.assert_array_equal(got, want)

    def test_epipolar_batch_matches_vmap(self, rng):
        Es = jnp.asarray(rng.normal(size=(37, 3, 3)), jnp.float32)
        x1 = jnp.asarray(rng.normal(size=(211, 2)), jnp.float32)
        x2 = jnp.asarray(rng.normal(size=(211, 2)), jnp.float32)
        got = ess.symmetric_epipolar_distance_sq_batch(Es, x1, x2, 1.3, 0.7)
        want = jax.vmap(
            lambda E: ess.symmetric_epipolar_distance_sq(E, x1, x2, 1.3, 0.7)
        )(Es)
        # rtol 2e-3: the batch form's quadratic-form denominators lose ~3
        # digits to cancellation exactly where the denominator is small
        # relative to ||E||*||h|| — i.e. on LARGE (far-outlier) residuals,
        # where neither inlier classification (threshold sits at small
        # residuals) nor NFA ranking (log-domain) is sensitive.
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=2e-3, atol=1e-4
        )

    def test_p3p_batch_scorer_matches_vmap(self, rng):
        from coloc_tpu.robust import _mean_focal, _p3p_batch_residuals

        Hm, M = 29, 97
        Rs = np.stack([so3.exp(jnp.asarray(v, jnp.float32))
                       for v in rng.normal(size=(Hm, 3))])
        Cs = rng.normal(size=(Hm, 3)).astype(np.float32)
        flats = jnp.asarray(
            np.concatenate([Rs.reshape(Hm, 9), Cs], axis=1), jnp.float32
        )
        Xw = jnp.asarray(rng.uniform(-3, 3, (M, 3)) + [0, 0, 8], jnp.float32)
        bear = jnp.asarray(rng.normal(size=(M, 3)), jnp.float32)
        bear = bear.at[:, 2].set(jnp.abs(bear[:, 2]) + 0.5)
        focal = _mean_focal(CAM)

        def one(flat):  # the per-model scorer form in absolute_pose_p3p
            R = flat[:9].reshape(3, 3)
            C = flat[9:]
            Xc = (Xw - C) @ R.T
            proj = Xc / jnp.maximum(Xc[:, 2:3], 1e-9)
            obs = bear / jnp.maximum(bear[:, 2:3], 1e-9)
            err = jnp.sum((proj[:, :2] - obs[:, :2]) ** 2, axis=-1)
            err = err * focal ** 2
            return jnp.where(Xc[:, 2] <= 0, 1e12, err)

        want = np.asarray(jax.vmap(one)(flats))
        got = np.asarray(_p3p_batch_residuals(flats, Xw, bear, focal))
        keep = (want < 1e11) & (got < 1e11)  # same behind-camera set
        np.testing.assert_array_equal(want < 1e11, got < 1e11)
        np.testing.assert_allclose(got[keep], want[keep], rtol=3e-4, atol=1e-3)

    def test_five_point_pallas_captures_vmap_solutions(self, rng):
        """The batched 5-point solver (vmap of five_point, the path every
        backend runs) must solve the minimal samples, judged by the float64
        oracle (tests/oracle.py): in general position some valid candidate
        matches the true essential matrix in direction and fits all eight
        points of its sample within 0.5 px (the 5 solved + 3 held out). On
        a plane the solution comes in twins that fit the plane equally, so
        there only the fit is judged, and f32 polishing loses a few
        near-double roots (RANSAC's other samples absorb them): at least
        three in four planar samples must be solved."""
        import oracle

        from coloc_tpu.geometry import fivept

        B = 37
        X = np.c_[rng.uniform(-3, 3, (B * 8, 2)),
                  rng.uniform(5, 15, (B * 8, 1))].reshape(B, 8, 3)
        X[B // 2:, :, 2] = 8.0  # planar half: twin-solution regime
        C2 = np.array([0.3, 0.05, 0.0])
        E_gt = oracle.essential_from_pose(np.eye(3), np.zeros(3), np.eye(3),
                                          C2)
        E_gt /= np.linalg.norm(E_gt)
        x1 = X[..., :2] / X[..., 2:]
        Xc = X - C2
        x2 = Xc[..., :2] / Xc[..., 2:]

        Es, val = jax.vmap(fivept.five_point)(
            jnp.asarray(x1[:, :5], jnp.float32),
            jnp.asarray(x2[:, :5], jnp.float32))
        Es, val = np.asarray(Es, np.float64), np.asarray(val)
        Es /= np.linalg.norm(Es.reshape(B, 30, 9), axis=2)[..., None, None]

        def solved(b, k):
            return val[b, k] and oracle.symmetric_epipolar_inliers(
                Es[b, k], x1[b], x2[b], 0.5, 458.0, 458.0).all()

        general = [any(solved(b, k) and abs(np.sum(Es[b, k] * E_gt)) > 1 - 1e-4
                       for k in range(30)) for b in range(B // 2)]
        planar = [any(solved(b, k) for k in range(30))
                  for b in range(B // 2, B)]
        assert all(general), np.flatnonzero(~np.asarray(general))
        assert sum(planar) >= 0.75 * len(planar), sum(planar)

    def test_p3p_pallas_captures_vmap_solutions(self, rng):
        """The batched P3P solver (vmap of p3p_grunert, the path every
        backend runs) must recover the true rotation, within 0.1 deg by the
        float64 oracle's angle metric, on at least 90% of minimal samples
        (ill-conditioned triads and merged quartic double roots lose f32
        accuracy; RANSAC votes such candidates out)."""
        import oracle

        B = 77
        X = jnp.asarray(rng.uniform(-3, 3, (B, 3, 3)) + [0, 0, 8],
                        jnp.float32)
        Rg = np.stack([np.asarray(so3.exp(jnp.asarray(v, jnp.float32)))
                       for v in rng.normal(0, 0.3, (B, 3))])
        Cg = rng.normal(0, 0.5, (B, 3)).astype(np.float32)
        Xc = np.einsum("bij,bkj->bki", Rg, np.asarray(X) - Cg[:, None])
        bear = jnp.asarray(
            Xc / np.linalg.norm(Xc, axis=-1, keepdims=True), jnp.float32
        )

        poses, valid = jax.vmap(p3p_ops.p3p_grunert)(X, bear)
        R, v = np.asarray(poses.R, np.float64), np.asarray(valid)
        captured = [
            any(v[b, i] and oracle.rot_angle_deg(R[b, i], Rg[b]) < 0.1
                for i in range(4))
            for b in range(B)
        ]
        assert sum(captured) >= 0.9 * B, sum(captured)

    def test_homography_batch_scorer_matches_vmap(self, rng):
        from coloc_tpu.geometry import homography as homog

        Hm, M = 31, 113
        Hs = jnp.asarray(rng.normal(size=(Hm, 3, 3)), jnp.float32)
        Hs = Hs.at[:, 2, 2].set(1.0 + jnp.abs(Hs[:, 2, 2]))
        x1 = jnp.asarray(rng.normal(size=(M, 2)), jnp.float32)
        x2 = jnp.asarray(rng.normal(size=(M, 2)), jnp.float32)
        want = np.asarray(jax.vmap(
            lambda H: homog.transfer_error_sq(H, x1, x2)
        )(Hs))
        got = np.asarray(homog.transfer_error_sq_batch(Hs, x1, x2))
        keep = (want < 1e11) & (got < 1e11)  # same degenerate-w set
        np.testing.assert_array_equal(want < 1e11, got < 1e11)
        # division-cleared form: same cancellation caveat as the epipolar
        # batch scorer (error concentrates on huge far-outlier residuals)
        np.testing.assert_allclose(got[keep], want[keep], rtol=2e-3, atol=1e-4)


def _exhaustive_ladder(res_sq, valid, thr_sq):
    """numpy ladder: per model, the number of (rung, valid residual) pairs
    with residual < thr * 4^j over every rung j, counted one by one."""
    from coloc_tpu.ransac import LADDER_JMAX, LADDER_RUNGS

    r = np.asarray(res_sq, np.float64)
    out = np.zeros(r.shape[0])
    for j in range(LADDER_JMAX - LADDER_RUNGS + 1, LADDER_JMAX + 1):
        out += ((r < thr_sq * 4.0 ** j) & np.asarray(valid)[None, :]).sum(1)
    return out


class TestFusedLadderRank:
    def test_matches_xla_ladder(self, rng):
        """The pre-rank ladder (ransac.ladder_rank, one log2 + clip pass)
        must count exactly the rungs an exhaustive per-rung numpy ladder
        counts over P3P residuals: masks applied, behind-camera residuals
        (1e12) on no rung, any model count."""
        from coloc_tpu import robust
        from coloc_tpu.ransac import ladder_rank

        Hm, M = 64, 200
        flats = []
        for _ in range(Hm):
            Q, _r = np.linalg.qr(rng.normal(size=(3, 3)))
            flats.append(
                np.concatenate([Q.reshape(9), rng.normal(0, 0.5, 3)])
            )
        flats = jnp.asarray(np.stack(flats), jnp.float32)
        Xw = jnp.asarray(
            rng.uniform(-3, 3, (M, 3)) + np.array([0, 0, 6.0]), jnp.float32
        )
        b = Xw / jnp.linalg.norm(Xw, axis=1, keepdims=True)
        mask = jnp.asarray(rng.random(M) > 0.2)
        focal, thr_sq = 451.0, 16.0

        rr = robust._p3p_batch_residuals(flats, Xw, b, focal)
        assert (np.asarray(rr) >= 1e12).any()   # behind-camera entries
        got = ladder_rank(rr, mask, thr_sq)
        np.testing.assert_array_equal(
            np.asarray(got), _exhaustive_ladder(rr, mask, thr_sq))
        got2 = ladder_rank(rr[:37], mask, thr_sq)
        assert got2.shape == (37,)
        np.testing.assert_array_equal(np.asarray(got2), np.asarray(got[:37]))

    def test_epipolar_rank_matches_xla_ladder(self, rng):
        """Epipolar (E and F) ladder rank vs the exhaustive numpy ladder,
        for both the focal-scaled essential case and the pixel-coordinate
        fundamental case."""
        from coloc_tpu.geometry import essential as e_ops
        from coloc_tpu.ransac import ladder_rank

        Hm, M = 90, 300
        Es = jnp.asarray(rng.normal(size=(Hm, 3, 3)), jnp.float32)
        Es = Es / jnp.linalg.norm(Es.reshape(Hm, 9), axis=1)[:, None, None]
        x1 = jnp.asarray(rng.normal(0, 0.5, (M, 2)), jnp.float32)
        x2 = jnp.asarray(rng.normal(0, 0.5, (M, 2)), jnp.float32)
        mask = jnp.asarray(rng.random(M) > 0.25)
        thr_sq = 16.0

        for s1_sq, s2_sq, a1, a2 in (
            (451.0 ** 2, 380.0 ** 2, x1, x2),     # essential, mixed lenses
            (1.0, 1.0, x1 * 500, x2 * 500),       # fundamental, pixel coords
        ):
            rr = e_ops.symmetric_epipolar_distance_sq_batch(
                Es, a1, a2, s1_sq, s2_sq
            )
            got = ladder_rank(rr, mask, thr_sq)
            np.testing.assert_array_equal(
                np.asarray(got), _exhaustive_ladder(rr, mask, thr_sq))

    def test_homography_rank_matches_xla_ladder(self, rng):
        """Homography ladder rank over f2^2-scaled forward transfer errors
        (negative-W points included) vs the exhaustive numpy ladder."""
        from coloc_tpu.geometry import homography as h_ops
        from coloc_tpu.ransac import ladder_rank

        Hm, M = 48, 200
        Hs = jnp.asarray(rng.normal(size=(Hm, 3, 3)), jnp.float32)
        x1 = jnp.asarray(rng.normal(0, 0.5, (M, 2)), jnp.float32)
        x2 = jnp.asarray(rng.normal(0, 0.5, (M, 2)), jnp.float32)
        mask = jnp.asarray(rng.random(M) > 0.25)
        f2_sq, thr_sq = 380.0 ** 2, 16.0

        rr = f2_sq * h_ops.transfer_error_sq_batch(Hs, x1, x2)
        got = ladder_rank(rr, mask, thr_sq)
        np.testing.assert_array_equal(
            np.asarray(got), _exhaustive_ladder(rr, mask, thr_sq))
