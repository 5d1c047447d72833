"""Multi-chip drone-axis sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: 'multi-chip tests using JAX's CPU multi-device simulation')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import ColocConfig, DetectorOptions
from coloc_tpu.fusion import kalman
from coloc_tpu.parallel import mesh as pmesh
from coloc_tpu.types import empty_mapdb


def tiny_config(h=64, w=96, kp=64, landmarks=128, drones=8, hyps=32):
    from coloc_tpu.config import RansacOptions

    return ColocConfig(
        num_drones=drones,
        detector=DetectorOptions(
            width=w, height=h, max_keypoints=kp, num_levels=2,
            fast_threshold=20,
        ),
        ransac=RansacOptions(num_hypotheses=hyps),
        max_landmarks=landmarks,
    )


class TestMesh:
    def test_devices_available(self):
        assert len(jax.devices()) == 8, (
            "conftest must provide 8 virtual CPU devices"
        )

    def test_collaborative_step_compiles_and_runs(self, rng):
        D, H, W = 8, 64, 96
        config = tiny_config(H, W)
        m = pmesh.make_mesh()
        step = pmesh.collaborative_step(m, config)

        keys = jax.random.split(jax.random.PRNGKey(0), D)
        images = jnp.asarray(rng.uniform(0, 255, (D, H, W)), jnp.float32)
        K = jnp.asarray([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]], jnp.float32)
        Ks = jnp.broadcast_to(K, (D, 3, 3))
        dists = jnp.zeros((D, 3))
        fb = kalman.init(D, config.filter)
        mapdb = empty_mapdb(config.max_landmarks)._replace(
            X=jnp.asarray(rng.uniform(-3, 3, (config.max_landmarks, 3)), jnp.float32),
            desc=jnp.asarray(
                rng.integers(0, 2**32, (config.max_landmarks, 16), dtype=np.uint64)
                .astype(np.uint32)
            ),
            valid=jnp.ones(config.max_landmarks, bool),
        )

        args = pmesh.shard_inputs(m, keys, images, Ks, dists, fb, mapdb)
        fb2, pos, cov, fused_pos, fused_cov, inter_ok = step(*args)
        jax.block_until_ready(fb2)

        assert pos.shape == (D, 3)
        assert cov.shape == (D, 3, 3)
        assert fused_pos.shape == (D, 3)
        assert inter_ok.shape == (D,)
        assert np.isfinite(np.asarray(fused_pos)).all()
        assert np.isfinite(np.asarray(fused_cov)).all()
        # filter bank advanced independently per drone
        assert fb2.x.shape == (D, 6)

    def test_collaborative_step_scan(self, rng):
        """Chunked mesh stepping: F frames scanned through the per-drone
        step inside one shard_map (KF carry on device), full inter exchange
        at the chunk boundary — BASELINE config 5 as one mesh program."""
        D, H, W, F = 8, 64, 96, 3
        config = tiny_config(H, W)
        m = pmesh.make_mesh()
        run = pmesh.collaborative_step_scan(m, config)

        from jax.sharding import NamedSharding, PartitionSpec as P

        keys = jax.random.split(jax.random.PRNGKey(1), F * D).reshape(F, D, 2)
        images = jnp.asarray(rng.uniform(0, 255, (F, D, H, W)), jnp.float32)
        K = jnp.asarray([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]], jnp.float32)
        Ks = jnp.broadcast_to(K, (D, 3, 3))
        dists = jnp.zeros((D, 3))
        fb = kalman.init(D, config.filter)
        mapdb = empty_mapdb(config.max_landmarks)._replace(
            X=jnp.asarray(
                rng.uniform(-3, 3, (config.max_landmarks, 3)), jnp.float32
            ),
            desc=jnp.asarray(
                rng.integers(0, 2**32, (config.max_landmarks, 16),
                             dtype=np.uint64).astype(np.uint32)
            ),
            valid=jnp.ones(config.max_landmarks, bool),
        )
        fsh = NamedSharding(m, P(None, pmesh.DRONE_AXIS))
        dsh = NamedSharding(m, P(pmesh.DRONE_AXIS))
        rsh = NamedSharding(m, P())
        fb = kalman.FilterBank(
            x=jax.device_put(fb.x, dsh), P=jax.device_put(fb.P, dsh),
            steps=jax.device_put(fb.steps, dsh),
        )
        from coloc_tpu.types import MapDB
        mapdb = MapDB(*[jax.device_put(l, rsh) for l in mapdb])
        out = run(
            jax.device_put(keys, fsh), jax.device_put(images, fsh),
            jax.device_put(Ks, dsh), jax.device_put(dists, dsh), fb, mapdb,
        )
        fb2, pos, cov, ok, fused_pos, fused_cov, iok = out
        jax.block_until_ready(fb2)
        assert pos.shape == (F, D, 3)
        assert cov.shape == (F, D, 3, 3)
        assert ok.shape == (F, D)
        assert fused_pos.shape == (D, 3)
        assert iok.shape == (D,)
        assert np.isfinite(np.asarray(pos)).all()
        assert np.isfinite(np.asarray(fused_pos)).all()

    def test_sharded_inter_pose_matches_host(self, tmp_path):
        """The sharded interPoseEstimator (descriptor exchange over the
        mesh + relative pose + temp reconstruction + scale alignment +
        pose-only refine + ICI) must reproduce host-side
        session.inter_pose on identical inputs."""
        from coloc_tpu.config import ColocConfig, DetectorOptions
        from coloc_tpu.io import synthetic
        from coloc_tpu.session import ColocSession
        from coloc_tpu.types import MapDB

        H, W = 240, 320
        K = np.array(
            [[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32
        )
        scene = synthetic.make_scene(H, W, K, seed=3)
        frames = {}
        for d in range(2):
            Rs, Cs = synthetic.trajectory(2, d)
            frames[d] = [synthetic.render(scene, Rs[f], Cs[f])
                         for f in range(2)]

        config = ColocConfig(
            num_drones=2,
            detector=DetectorOptions(
                width=W, height=H, max_keypoints=512, num_levels=4,
                fast_threshold=10,
            ),
            max_landmarks=512,
        )
        Ks = np.stack([K, K])
        dists = np.zeros((2, 3), np.float32)
        session = ColocSession(config, Ks, dists)
        assert session.init_map({d: frames[d][0] for d in range(2)})
        session.intra_pose_all({d: frames[d][1] for d in range(2)})

        imgs = {d: frames[d][1] for d in range(2)}
        feats = {d: session.detect(imgs[d]) for d in range(2)}
        key = jax.random.PRNGKey(7)
        host = session.inter_pose(0, 1, imgs, feats=feats, key=key)
        assert host is not None

        # sharded path on a 2-device mesh: drone 1 fuses with ring
        # predecessor 0 == the host's inter_pose(0, 1)
        m2 = pmesh.make_mesh(jax.devices()[:2])
        run = pmesh.sharded_inter_step(m2, config)
        stack = lambda *xs: jnp.stack(xs)
        feats_s = jax.tree_util.tree_map(stack, feats[0], feats[1])
        lp = session.last_pose
        Rs_s = jnp.stack([lp[0].pose.R, lp[1].pose.R])
        Cs_s = jnp.stack([lp[0].pose.C, lp[1].pose.C])
        cov3 = jnp.stack([lp[0].cov[3:6, 3:6], lp[1].cov[3:6, 3:6]])
        keys = jnp.stack([key, key])
        fused_pos, fused_cov, ok, rel_R, rel_C, scale = run(
            keys, feats_s, jnp.asarray(Ks), jnp.asarray(dists),
            Rs_s, Cs_s, cov3, session.mapdb,
        )
        assert bool(ok[1])
        # SEMANTIC parity, not bit parity: host and mesh share ONE compute
        # core (inter_pose_device), but the shard_map program is a separate
        # XLA compilation whose reduction/fusion schedules round f32
        # differently. Rather than a hard-coded absolute tolerance, the
        # fused-position gate below is DERIVED in-test from the measured
        # pre-ICI drift between the two paths propagated through the ICI's
        # float64 sensitivities.
        from coloc_tpu.geometry import camera as cam_ops

        cam = cam_ops.Camera(K=jnp.asarray(K), dist=jnp.zeros(3))
        core = pmesh.inter_pose_device(
            key, feats[1], feats[0], cam, cam,
            jnp.stack([jnp.asarray(K)] * 2), jnp.zeros((2, 3)),
            lp[0].pose, lp[0].cov[3:6, 3:6],
            lp[1].pose.C, lp[1].cov[3:6, 3:6],
            session.mapdb, config,
        )
        # TIGHT GATES on quantities upstream of the ICI: monocular scale
        # (pre-refine; measured drift ~3e-6 rel) and the refined relative
        # pose (post-LM, pre-ICI).
        np.testing.assert_allclose(
            float(scale[1]), float(core.scale), rtol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(rel_R[1]), np.asarray(core.rel.R), atol=2e-3
        )
        np.testing.assert_allclose(
            np.asarray(rel_C[1]), np.asarray(core.rel.C), atol=2e-3
        )

        # ---- derived fused-position bound -------------------------------
        # fused = K a + L b where a = dst intra position (IDENTICAL input to
        # both paths), b = cand_C = src_C + src_R^T rel_C, and the gains
        # K, L depend on (C_intra, C_cand). The host-mesh drift enters only
        # through (1) rel_C (LM output; measured directly above) and
        # (2) C_cand = src_cov3 + cov_rel (LM covariance; drift measured via
        # the fused-covariance outputs, same order as the input drift since
        # the ICI's cov map has O(1) gains). Propagate both through FLOAT64
        # finite-difference sensitivities of the ICI evaluated at the host
        # operating point:
        #   |Δfused| <= S_b |Δb| + S_C |ΔC_cand| + eps_f32
        import oracle as _oracle

        C_intra = np.asarray(lp[1].cov[3:6, 3:6], np.float64) + 1e-6 * np.eye(3)
        C_cand = (np.asarray(lp[0].cov[3:6, 3:6], np.float64)
                  + np.asarray(core.diag.cov_rel, np.float64)
                  + 1e-6 * np.eye(3))
        a_in = np.asarray(lp[1].pose.C, np.float64)
        b_in = (np.asarray(lp[0].pose.C, np.float64)
                + np.asarray(lp[0].pose.R, np.float64).T
                @ np.asarray(core.rel.C, np.float64))

        _, pos0, _ = _oracle.covariance_intersection(
            C_intra, C_cand, a_in, b_in)
        h = 1e-5
        # S_b: max directional sensitivity of fused pos to the candidate
        S_b = max(
            np.linalg.norm(
                (_oracle.covariance_intersection(
                    C_intra, C_cand, a_in, b_in + h * e)[1] - pos0) / h)
            for e in np.eye(3)
        )
        # S_C: sensitivity to the candidate covariance (worst diagonal and
        # one off-diagonal direction, symmetric perturbation)
        dirs = [np.diag(v) for v in np.eye(3)]
        E01 = np.zeros((3, 3)); E01[0, 1] = E01[1, 0] = 1.0
        dirs.append(E01)
        S_C = max(
            np.linalg.norm(
                (_oracle.covariance_intersection(
                    C_intra, C_cand + h * D, a_in, b_in)[1] - pos0) / h)
            for D in dirs
        )
        delta_b = float(np.linalg.norm(
            np.asarray(rel_C[1], np.float64)
            - np.asarray(core.rel.C, np.float64)))  # rotation preserves norm
        delta_covF = float(np.linalg.norm(
            np.asarray(fused_cov[1], np.float64)
            - np.asarray(host.cov, np.float64)))
        eps_f32 = 3e-6 * (1.0 + np.linalg.norm(a_in) + np.linalg.norm(b_in))
        tol = S_b * delta_b + S_C * (2.0 * delta_covF) + eps_f32
        # the derived bound must itself be sharp enough that an injected
        # 2e-3 error INSIDE the ICI stage (which moves fused_pos without
        # moving rel_C or the covariances) cannot hide under it
        assert tol < 2e-3, f"derived parity bound {tol:.2e} too loose"
        np.testing.assert_allclose(
            np.asarray(fused_pos[1]), np.asarray(host.pos), atol=tol
        )
        np.testing.assert_allclose(
            np.asarray(fused_cov[1]), np.asarray(host.cov), atol=1e-4
        )

    def test_sharded_map_match_equals_single_device(self, rng):
        """Map-sharded 2-NN (bank split over 8 devices + collective merge)
        must reproduce the single-device matcher exactly."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from coloc_tpu.config import MatcherOptions
        from coloc_tpu.ops import hamming
        from coloc_tpu.types import Matches

        Q, L = 96, 1024  # L divisible by 8 devices
        qd = jnp.asarray(
            rng.integers(0, 2**32, (Q, 16), dtype=np.uint64).astype(np.uint32)
        )
        td = jnp.asarray(
            rng.integers(0, 2**32, (L, 16), dtype=np.uint64).astype(np.uint32)
        )
        # plant exact matches so accepts exist
        qd = qd.at[:32].set(td[100:132])
        qv = jnp.ones(Q, bool)
        tv = jnp.asarray(rng.random(L) > 0.1)

        opts = MatcherOptions(mode="margin", margin_threshold=60)
        m = pmesh.make_mesh()
        run = pmesh.sharded_map_match(m, opts)
        dsh = NamedSharding(m, P(pmesh.DRONE_AXIS))
        out = run(qd, qv, jax.device_put(td, dsh), jax.device_put(tv, dsh))

        ridx, rbest, rsecond = hamming.hamming_2nn_plain(qd, td, qv, tv)
        np.testing.assert_array_equal(np.asarray(out.best), np.asarray(rbest))
        np.testing.assert_array_equal(
            np.asarray(out.second), np.asarray(rsecond)
        )
        # accepted matches agree with the single-device accept logic
        ok_ref = ((rsecond - rbest) > 60) & qv & (rbest <= 512)
        np.testing.assert_array_equal(np.asarray(out.mask), np.asarray(ok_ref))
        # indices achieve the best distance
        for q in np.nonzero(np.asarray(out.mask))[0]:
            d = int(hamming.hamming_distance(qd[q], td[int(out.idx[q])]))
            assert d == int(rbest[q])

    def test_2d_mesh_drone_and_map_sharded(self, rng):
        """Drone axis AND map axis sharded SIMULTANEOUSLY on a (2, 4) mesh:
        queries split over the drone rows, the bank over the map columns,
        merge collective over the map axis only — results must equal the
        single-device matcher (closes the r2 axis-reuse limitation)."""
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from coloc_tpu.config import MatcherOptions
        from coloc_tpu.ops import hamming

        Q, L = 64, 512
        qd = jnp.asarray(
            rng.integers(0, 2**32, (Q, 16), dtype=np.uint64).astype(np.uint32)
        )
        td = jnp.asarray(
            rng.integers(0, 2**32, (L, 16), dtype=np.uint64).astype(np.uint32)
        )
        qd = qd.at[:16].set(td[40:56])
        qv = jnp.ones(Q, bool)
        tv = jnp.asarray(rng.random(L) > 0.1)

        devs = np.asarray(jax.devices()).reshape(2, 4)
        m2d = Mesh(devs, axis_names=("drone", "map"))
        opts = MatcherOptions(mode="margin", margin_threshold=60)
        run = pmesh.sharded_map_match(m2d, opts, axis="map",
                                      query_axis="drone")
        out = run(
            jax.device_put(qd, NamedSharding(m2d, P("drone"))),
            jax.device_put(qv, NamedSharding(m2d, P("drone"))),
            jax.device_put(td, NamedSharding(m2d, P("map"))),
            jax.device_put(tv, NamedSharding(m2d, P("map"))),
        )
        ridx, rbest, rsecond = hamming.hamming_2nn_plain(qd, td, qv, tv)
        np.testing.assert_array_equal(np.asarray(out.best), np.asarray(rbest))
        np.testing.assert_array_equal(
            np.asarray(out.second), np.asarray(rsecond)
        )
        ok_ref = ((rsecond - rbest) > 60) & qv & (rbest <= 512)
        np.testing.assert_array_equal(np.asarray(out.mask), np.asarray(ok_ref))

    def test_sharded_map_match_uneven_bank(self, rng):
        """L=100 landmarks over 8 devices (100 % 8 != 0):
        the wrapper pads the bank to the next multiple with INVALID entries,
        so results — including the GLOBAL winner indices — must equal the
        single-device matcher on the unpadded bank."""
        from coloc_tpu.config import MatcherOptions
        from coloc_tpu.ops import hamming

        Q, L = 41, 100
        qd = jnp.asarray(
            rng.integers(0, 2**32, (Q, 16), dtype=np.uint64).astype(np.uint32)
        )
        td = jnp.asarray(
            rng.integers(0, 2**32, (L, 16), dtype=np.uint64).astype(np.uint32)
        )
        # plant exact matches, including in the LAST (ragged) shard region
        qd = qd.at[:8].set(td[92:100])
        qd = qd.at[8:16].set(td[3:11])
        qv = jnp.ones(Q, bool)
        tv = jnp.asarray(rng.random(L) > 0.1)
        # planted targets must be valid for the planted-found assertion
        tv = tv.at[92:100].set(True).at[3:11].set(True)

        opts = MatcherOptions(mode="margin", margin_threshold=60)
        m = pmesh.make_mesh()
        run = pmesh.sharded_map_match(m, opts)
        # unsharded host inputs: the jitted wrapper pads, then reshards
        out = run(qd, qv, td, tv)

        ridx, rbest, rsecond = hamming.hamming_2nn_plain(qd, td, qv, tv)
        np.testing.assert_array_equal(np.asarray(out.best), np.asarray(rbest))
        np.testing.assert_array_equal(
            np.asarray(out.second), np.asarray(rsecond)
        )
        ok_ref = ((rsecond - rbest) > 60) & qv & (rbest <= 512)
        np.testing.assert_array_equal(np.asarray(out.mask), np.asarray(ok_ref))
        mask = np.asarray(out.mask)
        assert mask[:16].all()  # planted matches all found
        for q in np.nonzero(mask)[0]:
            assert 0 <= int(out.idx[q]) < L
            d = int(hamming.hamming_distance(qd[q], td[int(out.idx[q])]))
            assert d == int(rbest[q])

    def test_sharded_map_match_uneven_query_axis(self, rng):
        """(2, 4) drone x map mesh with Q=10 queries (10 % 2 != 0) and
        L=100 (100 % 4 != 0): both axes pad-and-mask, outputs slice back."""
        from jax.sharding import Mesh

        from coloc_tpu.config import MatcherOptions
        from coloc_tpu.ops import hamming

        Q, L = 10, 100
        qd = jnp.asarray(
            rng.integers(0, 2**32, (Q, 16), dtype=np.uint64).astype(np.uint32)
        )
        td = jnp.asarray(
            rng.integers(0, 2**32, (L, 16), dtype=np.uint64).astype(np.uint32)
        )
        qd = qd.at[:4].set(td[96:100])
        qv = jnp.ones(Q, bool)
        tv = jnp.ones(L, bool)

        devs = np.asarray(jax.devices()).reshape(2, 4)
        m2d = Mesh(devs, axis_names=("drone", "map"))
        opts = MatcherOptions(mode="margin", margin_threshold=60)
        run = pmesh.sharded_map_match(m2d, opts, axis="map",
                                      query_axis="drone")
        out = run(qd, qv, td, tv)
        assert out.idx.shape == (Q,)
        ridx, rbest, rsecond = hamming.hamming_2nn_plain(qd, td, qv, tv)
        np.testing.assert_array_equal(np.asarray(out.best), np.asarray(rbest))
        np.testing.assert_array_equal(
            np.asarray(out.second), np.asarray(rsecond)
        )
        assert np.asarray(out.mask)[:4].all()
