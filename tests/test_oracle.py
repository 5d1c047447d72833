"""Golden-value tests against the pure-numpy reference oracle (oracle.py).

BASELINE.md north star: "pose error within 1% of the OpenMVG CPU reference".
No OpenMVG exists in this environment, so oracle.py independently implements
the reference's geometric semantics (float64 numpy) and these tests measure
the production pipeline against it on all five BASELINE.json configs:

  config 1: two-view detect/describe/match   -> match correctness vs GT warp
  config 2: two-view relative pose (E RANSAC) -> pose + inlier set vs oracle
  config 3: map localization (P3P + refine)   -> pose within 1%, inliers vs
            oracle reprojection classification
  config 4: inter-drone fusion (scale alignment + pose-only refine + ICI)
            -> fused position/covariance/omega vs the float64 oracle chain,
            on BOTH the host core (inter_pose_device) and the sharded mesh
            path (sharded_inter_step)
  config 5: full 2-drone session trajectory -> filtered per-frame poses vs
            the float64 oracle Kalman trajectory over ground-truth
            measurements
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle

from coloc_tpu.config import ColocConfig, DetectorOptions, MatcherOptions, RansacOptions, RefinerOptions
from coloc_tpu.frontend import detect_and_describe
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import so3
from coloc_tpu.io import synthetic
from coloc_tpu.matching import match_pair, match_with_map
from coloc_tpu.robust import relative_pose_essential
from coloc_tpu.sfm import localize
from coloc_tpu.types import MapDB, Pose

H, W = 240, 376
K = np.array([[0.62 * W, 0.0, W / 2], [0.0, 0.62 * W, H / 2], [0.0, 0.0, 1.0]],
             np.float32)
CAM = cam_ops.Camera(K=jnp.asarray(K), dist=jnp.zeros(3, jnp.float32))
OPTS = DetectorOptions(width=W, height=H, max_keypoints=256, num_levels=4,
                       fast_threshold=12)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(H, W, K, seed=11)


@pytest.fixture(scope="module")
def views(scene):
    R2 = np.asarray(so3.exp(jnp.asarray([0.01, -0.04, 0.005], jnp.float32)))
    C2 = np.array([0.35, 0.05, 0.02], np.float32)
    img1 = synthetic.render(scene, np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32))
    img2 = synthetic.render(scene, R2, C2)
    f1 = detect_and_describe(jnp.asarray(img1), OPTS)
    f2 = detect_and_describe(jnp.asarray(img2), OPTS)
    return f1, f2, R2, C2


class TestConfig1MatchingVsOracle:
    def test_matches_agree_with_gt_epipolar_geometry(self, views):
        """Accepted descriptor matches must be geometrically consistent with
        the ground-truth camera motion (oracle epipolar classification):
        the frontend+matcher stack produces predominantly TRUE matches."""
        f1, f2, R2, C2 = views
        m = match_pair(f1, f2, MatcherOptions())
        idx = np.asarray(m.idx)
        ok = idx >= 0
        uv1 = np.asarray(f1.xy)[ok]
        uv2 = np.asarray(f2.xy)[idx[ok]]
        E = oracle.essential_from_pose(np.eye(3), np.zeros(3), R2, C2)
        x1 = oracle.undistort_normalized(K, np.zeros(3), uv1)
        x2 = oracle.undistort_normalized(K, np.zeros(3), uv2)
        f = (K[0, 0] + K[1, 1]) / 2
        inl = oracle.symmetric_epipolar_inliers(E, x1, x2, 4.0, f, f)
        assert ok.sum() >= 40
        # descriptor matching is not geometry-aware; require a strong
        # majority consistent with GT (the rest are genuine mismatches)
        assert inl.mean() > 0.75

    def test_projection_model_matches_oracle(self, views):
        """JAX camera model == float64 oracle camera model (distorted)."""
        rng = np.random.default_rng(5)
        X = np.c_[rng.uniform(-1, 1, (64, 2)), rng.uniform(4, 9, (64, 1))]
        distv = np.array([-0.2, 0.05, 0.0], np.float32)
        cam = cam_ops.Camera(K=jnp.asarray(K), dist=jnp.asarray(distv))
        R = np.asarray(so3.exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
        C = np.array([0.5, -0.2, 0.1], np.float32)
        uv_jax = np.asarray(cam_ops.project(
            cam, jnp.asarray(R), jnp.asarray(C), jnp.asarray(X, jnp.float32)))
        uv_np = oracle.project(K, distv, R, C, X)
        np.testing.assert_allclose(uv_jax, uv_np, atol=2e-2)


class TestConfig2RelativePoseVsOracle:
    def test_pose_and_inliers_match_oracle(self, views):
        f1, f2, R2, C2 = views
        m = match_pair(f1, f2, MatcherOptions())
        uv2m = jnp.asarray(np.asarray(f2.xy)[np.asarray(m.idx)])
        geo = relative_pose_essential(
            jax.random.PRNGKey(0), f1.xy, uv2m, m.mask, CAM, CAM,
            RansacOptions(),
        )
        assert bool(geo.success)

        # oracle relative motion (camera 1 frame -> camera 2 frame)
        R_gt = R2 @ np.eye(3).T
        t_gt = R2 @ (np.zeros(3) - C2)
        assert oracle.rot_angle_deg(np.asarray(geo.R), R_gt) < 0.5
        assert oracle.dir_angle_deg(np.asarray(geo.t), t_gt) < 1.5

        # inlier-set agreement: classify the SAME correspondences with the
        # oracle's residual at the pipeline's adaptive threshold
        mask = np.asarray(m.mask)
        uv1 = np.asarray(f1.xy)
        uv2 = np.asarray(uv2m)
        x1 = oracle.undistort_normalized(K, np.zeros(3), uv1)
        x2 = oracle.undistort_normalized(K, np.zeros(3), uv2)
        E_est = oracle.hat(np.asarray(geo.t)) @ np.asarray(geo.R)
        f = (K[0, 0] + K[1, 1]) / 2
        # use the estimated model for classification parity (threshold from
        # the fixed gate; adaptive thresholds classify against geo's E)
        inl_oracle = oracle.symmetric_epipolar_inliers(
            E_est, x1, x2, 4.0, f, f) & mask
        inl_pipe = np.asarray(geo.inliers)
        jacc = (inl_oracle & inl_pipe).sum() / max(
            (inl_oracle | inl_pipe).sum(), 1)
        assert jacc > 0.85

    def test_triangulation_matches_oracle(self, views):
        f1, f2, R2, C2 = views
        from coloc_tpu.geometry import triangulation as tri
        rng = np.random.default_rng(3)
        X = np.c_[rng.uniform(-1, 1, (32, 2)), rng.uniform(4, 9, (32, 1))]
        uv1 = oracle.project(K, np.zeros(3), np.eye(3), np.zeros(3), X)
        uv2 = oracle.project(K, np.zeros(3), R2, C2, X)
        x1 = oracle.undistort_normalized(K, np.zeros(3), uv1)
        x2 = oracle.undistort_normalized(K, np.zeros(3), uv2)
        X_jax = np.asarray(tri.triangulate_points(
            jnp.eye(3), jnp.zeros(3), jnp.asarray(x1, jnp.float32),
            jnp.asarray(R2), jnp.asarray(C2), jnp.asarray(x2, jnp.float32)))
        X_np = np.stack([
            oracle.triangulate_dlt(np.eye(3), np.zeros(3), x1[i], R2, C2, x2[i])
            for i in range(len(X))
        ])
        np.testing.assert_allclose(X_jax, X_np, atol=5e-3)
        np.testing.assert_allclose(X_np, X, atol=5e-3)

    def test_decomposition_matches_oracle(self, views):
        """Pipeline E-decomposition (cheirality vote) == oracle decomposition
        on the ground-truth essential matrix."""
        _, _, R2, C2 = views
        from coloc_tpu.geometry import essential as ess
        rng = np.random.default_rng(7)
        X = np.c_[rng.uniform(-1, 1, (48, 2)), rng.uniform(4, 9, (48, 1))]
        uv1 = oracle.project(K, np.zeros(3), np.eye(3), np.zeros(3), X)
        uv2 = oracle.project(K, np.zeros(3), R2, C2, X)
        x1 = oracle.undistort_normalized(K, np.zeros(3), uv1)
        x2 = oracle.undistort_normalized(K, np.zeros(3), uv2)
        E = oracle.essential_from_pose(np.eye(3), np.zeros(3), R2, C2)
        mask = np.ones(len(X), bool)
        R_np, t_np = oracle.decompose_essential(E, x1, x2, mask)
        R_jax, t_jax = ess.decompose_essential(
            jnp.asarray(E, jnp.float32), jnp.asarray(x1, jnp.float32),
            jnp.asarray(x2, jnp.float32), jnp.asarray(mask))
        assert oracle.rot_angle_deg(np.asarray(R_jax), R_np) < 0.1
        assert oracle.dir_angle_deg(np.asarray(t_jax), t_np) < 0.1


class TestConfig3LocalizationVsOracle:
    def test_pose_within_one_percent(self, views):
        """North-star accuracy gate: localized pose center within 1% of the
        trajectory scale of the oracle (= ground truth for exact synthetic
        correspondences), rotation within 0.2 deg."""
        f1, _, _, _ = views
        rng = np.random.default_rng(9)
        kp = int(np.asarray(f1.valid).sum())
        n = f1.xy.shape[0]
        # consistent map along the frame's bearings (exact 2D-3D geometry)
        uv = np.asarray(f1.xy)
        depths = rng.uniform(4.0, 10.0, (n, 1))
        dirs = (np.linalg.inv(K) @ np.c_[uv, np.ones(n)].T).T
        R_gt = np.asarray(so3.exp(jnp.asarray([0.02, -0.03, 0.01], jnp.float32)))
        C_gt = np.array([0.3, -0.1, 0.05], np.float64)
        # landmarks defined in the query camera's frame => world coords
        X_world = (dirs * depths) @ R_gt + C_gt  # inverse of R(X-C)
        uv_obs = oracle.project(K, np.zeros(3), R_gt, C_gt, X_world)

        mapdb = MapDB(X=jnp.asarray(X_world, jnp.float32), desc=f1.desc,
                      valid=f1.valid)
        mm = match_with_map(
            f1._replace(xy=jnp.asarray(uv_obs, jnp.float32)), mapdb,
            MatcherOptions())
        pwc, inl = localize.localize_image(
            jax.random.PRNGKey(2),
            f1._replace(xy=jnp.asarray(uv_obs, jnp.float32)),
            mm, mapdb, CAM, RansacOptions(), RefinerOptions(),
        )
        assert bool(pwc.success)
        c_err = np.linalg.norm(np.asarray(pwc.pose.C) - C_gt)
        assert c_err < 0.01 * np.linalg.norm(C_gt)   # within 1%
        assert oracle.rot_angle_deg(np.asarray(pwc.pose.R), R_gt) < 0.2

        # inlier set vs oracle reprojection classification at 4 px
        inl_oracle = oracle.reprojection_inliers(
            K, np.zeros(3), R_gt, C_gt, X_world, uv_obs, 4.0)
        inl_pipe = np.asarray(inl)
        valid = np.asarray(f1.valid) & np.asarray(mm.mask)
        agree = (inl_oracle & inl_pipe)[valid].sum() / max(
            inl_pipe[valid].sum(), 1)
        assert agree > 0.95


# ---------------------------------------------------------------------------
# config 4: inter-drone fusion vs the float64 oracle chain
# ---------------------------------------------------------------------------

_N_LM = 48     # ground-truth landmarks (valid slots)
_CAP = 64      # feature / landmark slot capacity


def _make_inter_scenario():
    """Deterministic exact-correspondence inter-drone scenario.

    World: _N_LM landmarks; shared map = those landmarks at world (metric)
    scale with one unique 512-bit descriptor each. Drone 0 (src) and drone 1
    (dst) each observe every landmark at its exact projection with the
    LANDMARK's descriptor at the SAME slot index, so descriptor matching
    resolves to the identity assignment and every stage of
    inter_pose_device is numerically pinned down.
    """
    rng = np.random.default_rng(21)
    X_world = np.c_[rng.uniform(-2.2, 2.2, (_N_LM, 2)),
                    rng.uniform(5.0, 10.0, (_N_LM, 1))]

    R_src = oracle.rodrigues([0.03, -0.02, 0.01])
    C_src = np.array([0.10, -0.05, 0.00])
    R_dst = oracle.rodrigues([-0.02, 0.05, 0.02])
    C_dst = np.array([0.72, 0.10, 0.05])

    # EXACT projections (no pixel noise): the pipeline's own relative-pose
    # estimate then coincides with the oracle's GT anchor to f32 precision,
    # so every downstream stage (triangulation, scale, refine, ICI) is
    # pinned tightly. With noise the comparison would instead measure the
    # (legitimate) difference between the pipeline's f32 5-pt estimate and
    # the GT relative pose — estimation error, not semantics.
    uv_src = oracle.project(K, np.zeros(3), R_src, C_src, X_world)
    uv_dst = oracle.project(K, np.zeros(3), R_dst, C_dst, X_world)

    desc = rng.integers(0, 2 ** 32, (_CAP, 16), dtype=np.uint32)
    valid = np.zeros(_CAP, bool)
    valid[:_N_LM] = True

    def feats(uv):
        xy = np.zeros((_CAP, 2), np.float32)
        xy[:_N_LM] = uv
        from coloc_tpu.types import Features
        return Features(
            xy=jnp.asarray(xy),
            score=jnp.where(jnp.asarray(valid), 1.0, 0.0),
            scale=jnp.zeros(_CAP, jnp.int32),
            angle=jnp.zeros(_CAP, jnp.float32),
            desc=jnp.asarray(desc),
            valid=jnp.asarray(valid),
        )

    Xm = np.zeros((_CAP, 3), np.float32)
    Xm[:_N_LM] = X_world
    mapdb = MapDB(X=jnp.asarray(Xm), desc=jnp.asarray(desc),
                  valid=jnp.asarray(valid))

    # current estimates fed to the fusion: src exactly at GT, dst position
    # deliberately offset so ICI performs a genuine blend
    dst_pos = C_dst + np.array([0.03, -0.02, 0.015])
    src_cov3 = np.array([[0.040, 0.004, 0.0],
                         [0.004, 0.030, 0.002],
                         [0.0, 0.002, 0.050]])
    dst_cov3 = np.array([[0.060, -0.003, 0.001],
                         [-0.003, 0.045, 0.0],
                         [0.001, 0.0, 0.035]])
    return dict(
        X_world=X_world, R_src=R_src, C_src=C_src, R_dst=R_dst, C_dst=C_dst,
        uv_src=uv_src, uv_dst=uv_dst, f_src=feats(uv_src), f_dst=feats(uv_dst),
        mapdb=mapdb, valid=valid, dst_pos=dst_pos,
        src_cov3=src_cov3, dst_cov3=dst_cov3,
    )


def _oracle_inter_chain(s):
    """Float64 oracle of the full interPoseEstimator chain
    (coloc.hpp:274-392 semantics as inventoried in SURVEY §3.6):
    GT relative pose -> temp-scene DLT triangulation (unit baseline) ->
    consecutive-ratio scale alignment -> poses-only Huber LM refine ->
    candidate composition -> ICI fusion."""
    Kd = np.asarray(K, np.float64)
    R_src, C_src = s["R_src"], s["C_src"]
    R_dst, C_dst = s["R_dst"], s["C_dst"]

    # relative motion src -> dst, unit baseline (temp-scene anchor frame)
    R_rel = R_dst @ R_src.T
    C_in_src = R_src @ (C_dst - C_src)      # dst center in src-camera coords
    baseline = np.linalg.norm(C_in_src)
    C_temp1 = C_in_src / baseline           # unit-scale temp pose center

    # temp-scene triangulation at unit baseline
    x_src = oracle.undistort_normalized(Kd, np.zeros(3), s["uv_src"])
    x_dst = oracle.undistort_normalized(Kd, np.zeros(3), s["uv_dst"])
    X_temp = np.stack([
        oracle.triangulate_dlt(np.eye(3), np.zeros(3), x_src[i],
                               R_rel, C_temp1, x_dst[i])
        for i in range(_N_LM)
    ])

    # scale alignment: map (metric) vs temp (unit-baseline) distances
    scale = oracle.scale_ratio_mean(s["X_world"], X_temp)

    # rescale + poses-only refine (Structure NONE), view 0 fixed
    X_scaled = X_temp * scale
    Rs, Cs, _, cov6, rmse = oracle.bundle_adjust(
        [Kd, Kd], [np.zeros(3)] * 2,
        [np.eye(3), R_rel], [np.zeros(3), C_temp1 * scale],
        X_scaled,
        obs=np.stack([s["uv_src"], s["uv_dst"]]),
        obs_mask=np.ones((2, _N_LM), bool),
        fix_pose=[True, False],
        optimize_structure=False,
        cov_view=1,
    )

    # candidate composition + ICI (coloc.hpp:351-389)
    cand_C = C_src + R_src.T @ Cs[1]
    C_intra = s["dst_cov3"] + 1e-6 * np.eye(3)
    C_cand = s["src_cov3"] + cov6[3:6, 3:6] + 1e-6 * np.eye(3)
    fused_cov, fused_pos, omega = oracle.covariance_intersection(
        C_intra, C_cand, s["dst_pos"], cand_C)
    return dict(
        scale=scale, baseline=baseline, rel_R=Rs[1], rel_C=Cs[1],
        cov6=cov6, rmse=rmse, cand_C=cand_C,
        fused_cov=fused_cov, fused_pos=fused_pos, omega=omega,
    )


class TestConfig4InterFusionVsOracle:
    """The collaborative core against reference-independent float64 golden
    values: the full inter-drone fusion chain — scale
    alignment (computeScaleDifference, colocUtils.hpp:184-223), poses-only
    refine (coloc.hpp:339), ICI (CovIntersection.hpp:24-49) — on both the
    host compute core and the sharded mesh path."""

    @pytest.fixture(scope="class")
    def scenario(self):
        return _make_inter_scenario()

    @pytest.fixture(scope="class")
    def golden(self, scenario):
        return _oracle_inter_chain(scenario)

    @pytest.fixture(scope="class")
    def config(self):
        from coloc_tpu.config import ColocConfig
        return ColocConfig(
            num_drones=2,
            detector=DetectorOptions(width=640, height=480,
                                     max_keypoints=_CAP),
            max_landmarks=_CAP,
        )

    @pytest.fixture(scope="class")
    def host_out(self, scenario, config):
        from coloc_tpu.parallel.mesh import inter_pose_device
        s = scenario
        cam = cam_ops.Camera(K=jnp.asarray(K), dist=jnp.zeros(3))
        return inter_pose_device(
            jax.random.PRNGKey(4), s["f_dst"], s["f_src"], cam, cam,
            jnp.stack([jnp.asarray(K)] * 2), jnp.zeros((2, 3)),
            # src current world pose + covariance; dst position estimate
            Pose(R=jnp.asarray(s["R_src"], jnp.float32),
                 C=jnp.asarray(s["C_src"], jnp.float32)),
            jnp.asarray(s["src_cov3"], jnp.float32),
            jnp.asarray(s["dst_pos"], jnp.float32),
            jnp.asarray(s["dst_cov3"], jnp.float32),
            s["mapdb"], config,
        )

    def test_scale_matches_oracle(self, host_out, golden):
        assert bool(host_out.ok)
        np.testing.assert_allclose(
            float(host_out.scale), golden["scale"], rtol=2e-3)
        # and the scale really is the metric baseline
        np.testing.assert_allclose(
            golden["scale"], golden["baseline"], rtol=1e-2)

    def test_refined_relative_pose_matches_oracle(self, host_out, golden):
        assert oracle.rot_angle_deg(
            np.asarray(host_out.rel.R), golden["rel_R"]) < 0.1
        np.testing.assert_allclose(
            np.asarray(host_out.rel.C), golden["rel_C"], atol=2e-3)

    def test_fused_position_matches_oracle(self, host_out, golden):
        np.testing.assert_allclose(
            np.asarray(host_out.fused_pos), golden["fused_pos"], atol=2e-3)
        # the fusion moved the estimate toward GT: fused closer to C_dst
        # than the offset intra estimate was
        s_err = np.linalg.norm(golden["fused_pos"] - golden["cand_C"])
        assert s_err < 0.05

    def test_fused_covariance_and_omega_match_oracle(self, host_out, golden):
        np.testing.assert_allclose(
            np.asarray(host_out.fused_cov), golden["fused_cov"],
            rtol=0.02, atol=2e-4)
        np.testing.assert_allclose(
            float(host_out.diag.omega), golden["omega"], atol=1e-2)

    def test_mesh_path_matches_oracle(self, scenario, config, golden):
        """The sharded mesh exchange hits the SAME golden values: drone 1
        (dst) fuses with ring predecessor drone 0 (src)."""
        from coloc_tpu.parallel import mesh as pmesh
        s = scenario
        m2 = pmesh.make_mesh(jax.devices()[:2])
        run = pmesh.sharded_inter_step(m2, config)
        stack = lambda *xs: jnp.stack(xs)
        feats_s = jax.tree_util.tree_map(stack, s["f_src"], s["f_dst"])
        keys = jnp.stack([jax.random.PRNGKey(4)] * 2)
        Ks_s = jnp.stack([jnp.asarray(K, jnp.float32)] * 2)
        dists_s = jnp.zeros((2, 3), jnp.float32)
        Rs_s = jnp.stack([jnp.asarray(s["R_src"], jnp.float32),
                          jnp.asarray(s["R_dst"], jnp.float32)])
        Cs_s = jnp.stack([jnp.asarray(s["C_src"], jnp.float32),
                          jnp.asarray(s["dst_pos"], jnp.float32)])
        cov3s = jnp.stack([jnp.asarray(s["src_cov3"], jnp.float32),
                           jnp.asarray(s["dst_cov3"], jnp.float32)])
        fused_pos, fused_cov, ok, rel_R, rel_C, scale = run(
            keys, feats_s, Ks_s, dists_s, Rs_s, Cs_s, cov3s, s["mapdb"])
        assert bool(ok[1])
        np.testing.assert_allclose(
            float(scale[1]), golden["scale"], rtol=2e-3)
        assert oracle.rot_angle_deg(
            np.asarray(rel_R[1]), golden["rel_R"]) < 0.1
        np.testing.assert_allclose(
            np.asarray(rel_C[1]), golden["rel_C"], atol=2e-3)
        np.testing.assert_allclose(
            np.asarray(fused_pos[1]), golden["fused_pos"], atol=2e-3)
        np.testing.assert_allclose(
            np.asarray(fused_cov[1]), golden["fused_cov"],
            rtol=0.02, atol=2e-4)

    def test_pose_refine_covariance_matches_oracle(self, scenario):
        """Direct golden test of the poses-only LM refine + covariance
        (ba.refine with optimize_structure=False) against the float64
        finite-difference oracle on the same problem — independent of the
        fusion chain above."""
        from coloc_tpu.config import RefinerOptions
        from coloc_tpu.sfm import ba
        s = scenario
        golden = _oracle_inter_chain(s)
        scale = golden["scale"]
        # same problem the fusion chain solves, from a PERTURBED start so
        # the LM actually has to move
        R1 = oracle.rodrigues([0.004, -0.003, 0.002]) @ golden["rel_R"]
        C1 = golden["rel_C"] + np.array([0.01, -0.008, 0.006])
        X_scaled = np.zeros((_CAP, 3), np.float32)
        # oracle-triangulated rescaled structure
        Kd = np.asarray(K, np.float64)
        x_src = oracle.undistort_normalized(Kd, np.zeros(3), s["uv_src"])
        x_dst = oracle.undistort_normalized(Kd, np.zeros(3), s["uv_dst"])
        R_rel = s["R_dst"] @ s["R_src"].T
        C_in_src = s["R_src"] @ (s["C_dst"] - s["C_src"])
        C_t1 = C_in_src / np.linalg.norm(C_in_src)
        Xt = np.stack([
            oracle.triangulate_dlt(np.eye(3), np.zeros(3), x_src[i],
                                   R_rel, C_t1, x_dst[i])
            for i in range(_N_LM)
        ]) * scale
        X_scaled[:_N_LM] = Xt

        obs = np.zeros((2, _CAP, 2), np.float32)
        obs[0, :_N_LM] = s["uv_src"]
        obs[1, :_N_LM] = s["uv_dst"]
        obs_mask = np.zeros((2, _CAP), bool)
        obs_mask[:, :_N_LM] = True

        problem = ba.BAProblem(
            Rs=jnp.asarray(np.stack([np.eye(3), R1]), jnp.float32),
            Cs=jnp.asarray(np.stack([np.zeros(3), C1]), jnp.float32),
            X=jnp.asarray(X_scaled),
            obs=jnp.asarray(obs),
            obs_mask=jnp.asarray(obs_mask),
            Ks=jnp.asarray(np.stack([K, K]), jnp.float32),
            dists=jnp.zeros((2, 3), jnp.float32),
        )
        res = ba.refine(problem, RefinerOptions(),
                        fix_pose=jnp.asarray([True, False]),
                        optimize_structure=False, cov_view=1)

        Rs_o, Cs_o, _, cov6_o, rmse_o = oracle.bundle_adjust(
            [Kd, Kd], [np.zeros(3)] * 2,
            [np.eye(3), R1], [np.zeros(3), C1], Xt,
            obs=np.stack([s["uv_src"], s["uv_dst"]]),
            obs_mask=np.ones((2, _N_LM), bool),
            fix_pose=[True, False], optimize_structure=False, cov_view=1,
        )
        assert oracle.rot_angle_deg(np.asarray(res.Rs[1]), Rs_o[1]) < 0.05
        np.testing.assert_allclose(np.asarray(res.Cs[1]), Cs_o[1], atol=1e-3)
        # exact correspondences: both solvers drive rmse to their precision
        # floor (f32 ~1e-5 px vs float64 ~1e-13 px) — compare absolutely
        np.testing.assert_allclose(float(res.rmse), rmse_o, atol=1e-4)
        # covariance: same (w, dC) tangent blocks, f32 vs float64 central
        # differences — elementwise within 5% of the dominant scale
        cov_p = np.asarray(res.cov)
        ref_scale = np.abs(cov6_o).max()
        np.testing.assert_allclose(
            cov_p, cov6_o, atol=0.05 * ref_scale)

    def test_ici_matches_oracle_directly(self, scenario):
        """covint.fuse vs the float64 oracle ICI on bare inputs (no
        geometry in the loop)."""
        from coloc_tpu.fusion import covint
        s = scenario
        Ca = s["dst_cov3"] + 1e-6 * np.eye(3)
        Cb = s["src_cov3"] + 1e-6 * np.eye(3)
        a = s["dst_pos"]
        b = s["C_dst"]
        got = covint.fuse(
            jnp.asarray(Ca, jnp.float32), jnp.asarray(Cb, jnp.float32),
            jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
        cov_o, pos_o, omega_o = oracle.covariance_intersection(Ca, Cb, a, b)
        np.testing.assert_allclose(np.asarray(got.pos), pos_o, atol=5e-4)
        np.testing.assert_allclose(np.asarray(got.cov), cov_o,
                                   rtol=0.01, atol=1e-4)
        np.testing.assert_allclose(float(got.omega), omega_o, atol=5e-3)


# ---------------------------------------------------------------------------
# config 5: full 2-drone session trajectory vs the oracle Kalman chain
# ---------------------------------------------------------------------------


class TestConfig5SessionVsOracle:
    """session.run's filtered trajectory against the float64 oracle filter.

    Two complementary gates:

    1. KF/orchestration golden: the session's filtered per-frame poses must
       equal the oracle Kalman filter REPLAYED over the session's own raw
       measurement log (poses.txt carries exactly the filter inputs: raw C,
       euler, the cov center block, rmse — logUtils.hpp:90-96 schema).
       This pins the full per-frame chain measurement -> noise override ->
       gate -> correct -> carry across 9 frames to float64 golden values,
       independent of bootstrap quality.
    2. GT accuracy gate: the filtered trajectories, SE(3)-aligned to the
       ground truth (standard ATE practice — the monocular bootstrap frame
       is only as good as the two-view init, measured at 1-10% of baseline
       across seeds), must track GT within 5% of the trajectory extent.
    """

    F = 10  # >= 8-frame requirement

    @pytest.fixture(scope="class")
    def run_out(self, tmp_path_factory):
        from coloc_tpu.config import ColocConfig
        from coloc_tpu.session import ColocSession

        Hs, Ws = 240, 320
        Ksyn = np.array(
            [[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
        scene = synthetic.make_scene(Hs, Ws, Ksyn, seed=3)
        gt = {d: synthetic.trajectory(self.F, d) for d in range(2)}
        frames = {
            d: [synthetic.render(scene, gt[d][0][f], gt[d][1][f])
                for f in range(self.F)]
            for d in range(2)
        }
        baseline0 = float(np.linalg.norm(gt[1][1][0] - gt[0][1][0]))
        config = ColocConfig(
            num_drones=2,
            # denser frontend than the other fixtures: bootstrap map skew is
            # the dominant ATE term (gate 2) and shrinks with landmark count
            detector=DetectorOptions(width=Ws, height=Hs, max_keypoints=768,
                                     num_levels=4, fast_threshold=8),
            max_landmarks=1024,
            scale=baseline0,
        )
        out_dir = str(tmp_path_factory.mktemp("c5run"))
        session = ColocSession(
            config, np.stack([Ksyn, Ksyn]), np.zeros((2, 3), np.float32),
            out_dir=out_dir)
        out = session.run(frames, inter_every=4)
        session.close()
        return gt, out, out_dir

    @staticmethod
    def _read_pose_log(out_dir, drone, n_frames):
        """poses.txt rows for one drone -> (z (F,6), cov_centers (F,3,3),
        rmses (F,)) in frame order."""
        rows = {}
        import os as _os

        with open(_os.path.join(out_dir, "poses.txt")) as fh:
            for line in fh:
                v = line.strip().split(",")
                if len(v) < 20 or not v[0].lstrip("-").isdigit():
                    continue  # header row
                idx, dest, src = int(v[0]), int(v[1]), int(v[2])
                if dest != drone or src != drone:
                    continue
                C = np.array([float(x) for x in v[3:6]])
                cov3 = np.array([float(x) for x in v[6:15]]).reshape(3, 3)
                eul = np.array([float(x) for x in v[15:18]])
                rmse = float(v[18])
                rows[idx] = (C, cov3, eul, rmse)
        zs, covs, rmses = [], [], []
        for f in range(1, n_frames):
            C, cov3, eul, rmse = rows[f]
            zs.append(np.concatenate([C, eul]))
            covs.append(cov3)
            rmses.append(rmse)
        return np.stack(zs), np.stack(covs), np.asarray(rmses)

    def test_filtered_trajectory_matches_oracle_kf_on_own_measurements(
            self, run_out):
        """Gate 1: float64 oracle KF over the session's logged raw
        measurements == the session's filtered output (f32), per frame."""
        _, out, out_dir = run_out
        for d in range(2):
            assert len(out[d]) == self.F - 1
            assert all(bool(out[d][i].success) for i in range(self.F - 1))
            zs, covs, rmses = self._read_pose_log(out_dir, d, self.F)
            xs, _ = oracle.kalman_trajectory(
                zs, cov_centers=covs, rmses=rmses,
                availables=np.ones(self.F - 1, bool),
            )
            got = np.stack(
                [np.asarray(out[d][i].pose.C) for i in range(self.F - 1)])
            np.testing.assert_allclose(got, xs[:, :3], atol=5e-4)
            got_e = np.stack([
                np.asarray(so3.rot_to_euler(out[d][i].pose.R))
                for i in range(self.F - 1)
            ])
            err = np.abs(got_e - xs[:, 3:6])
            err = np.minimum(err, 2 * np.pi - err)
            assert err.max() < 5e-4

    def test_trajectory_tracks_ground_truth_after_alignment(self, run_out):
        """Gate 2: SE(3)-aligned ATE of the filtered trajectories vs GT
        (both drones jointly — one world alignment for the session)."""
        from coloc_tpu import metrics

        gt, out, _ = run_out
        got_all, gt_all = [], []
        for d in range(2):
            Rs_gt, Cs_gt = gt[d]
            # the constant-position KF lags a moving target by ~1/k frames
            # (steady-state gain k ~ 0.27 at the reference noise values);
            # compare each filtered pose against the KF-of-GT instead of
            # raw GT so the gate measures MAP/measurement error, not the
            # documented filter lag shared by both sides
            R0 = np.asarray(gt[0][0][0], np.float64)
            C0 = np.asarray(gt[0][1][0], np.float64)
            zs = []
            for f in range(1, self.F):
                C_p = R0 @ (np.asarray(Cs_gt[f], np.float64) - C0)
                R_p = np.asarray(Rs_gt[f], np.float64) @ R0.T
                zs.append(np.concatenate([C_p, oracle.rot_to_euler(R_p)]))
            ref, _ = oracle.kalman_trajectory(
                np.stack(zs), cov_centers=np.zeros((self.F - 1, 3, 3)),
                rmses=np.zeros(self.F - 1),
                availables=np.ones(self.F - 1, bool))
            gt_all.append(ref[:, :3])
            got_all.append(np.stack(
                [np.asarray(out[d][i].pose.C) for i in range(self.F - 1)]))
        got_all = np.concatenate(got_all)
        gt_all = np.concatenate(gt_all)
        # Sim(3) alignment: monocular trajectories are defined up to scale
        # (the bootstrap injects cfg.scale along an ESTIMATED direction),
        # so scale is part of the gauge — standard monocular ATE practice
        s, R, t = metrics.umeyama_alignment(got_all, gt_all, with_scale=True)
        aligned = (s * (R @ got_all.T)).T + t
        ate = np.sqrt(np.mean(np.sum((aligned - gt_all) ** 2, axis=1)))
        extent = np.linalg.norm(gt_all.max(0) - gt_all.min(0))
        assert ate < 0.05 * extent, (ate, extent)
