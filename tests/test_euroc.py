"""EuRoC-layout ingest tests (mock sequence written in ASL directory form) +
patch-coverage property test for the frontend sampling machinery."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
from PIL import Image

from coloc_tpu.io import euroc, synthetic


H, W = 96, 128
K = np.array([[100.0, 0, 64], [0, 101.0, 48], [0, 0, 1]], np.float32)


def _write_sequence(root, t0_ns, n, scene, drone,
                    dist="[-0.28, 0.07, 0.0002, 0.00002]"):
    cam = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam, "data"))
    with open(os.path.join(cam, "sensor.yaml"), "w") as f:
        f.write(
            "sensor_type: camera\n"
            "intrinsics: [100.0, 101.0, 64.0, 48.0]\n"
            "distortion_model: radial-tangential\n"
            f"distortion_coefficients: {dist}\n"
            f"resolution: [{W}, {H}]\n"
        )
    from coloc_tpu.io.synthetic import trajectory, render

    Rs, Cs = trajectory(n, drone)
    for i in range(n):
        img = render(scene, Rs[i], Cs[i]).astype(np.uint8)
        ts = t0_ns + i * 50_000_000  # 20 Hz
        Image.fromarray(img, mode="L").save(
            os.path.join(cam, "data", f"{ts}.png"))


class TestEurocIngest:
    def test_load_two_sequences(self, tmp_path, rng):
        scene = synthetic.make_scene(H, W, K, seed=4)
        # drone 1's clock offset by 20 ms: nearest-timestamp alignment
        _write_sequence(str(tmp_path / "seq0"), 1_000_000_000, 5, scene, 0)
        _write_sequence(str(tmp_path / "seq1"), 1_020_000_000, 5, scene, 1)

        frames, Ks, dists, size = euroc.load_dataset(
            [str(tmp_path / "seq0"), str(tmp_path / "seq1")], num_frames=4)
        assert size == (W, H)
        assert Ks.shape == (2, 3, 3) and abs(Ks[0, 0, 0] - 100.0) < 1e-6
        # radial terms kept, tangential dropped
        np.testing.assert_allclose(dists[0], [-0.28, 0.07, 0.0], atol=1e-6)
        assert len(frames[0]) == len(frames[1]) == 4
        assert frames[0][0].shape == (H, W)
        # alignment: drone 1's first kept frame is its own t=1.02s image
        # (nearest to drone 0's 1.00s), not a copy of drone 0's
        assert not np.array_equal(frames[0][0], frames[1][0])

    def test_sensor_yaml_missing_key(self, tmp_path):
        p = tmp_path / "sensor.yaml"
        p.write_text("sensor_type: camera\n")
        with pytest.raises(ValueError):
            euroc.read_sensor_yaml(str(p))

    def test_groundtruth_load_and_association(self, tmp_path):
        """ASL ground-truth csv ingest + nearest-timestamp association
        (the --euroc ATE/RPE runpath)."""
        scene = synthetic.make_scene(H, W, K, seed=4)
        root = str(tmp_path / "seq0")
        _write_sequence(root, 1_000_000_000, 4, scene, 0)
        assert euroc.load_groundtruth(root) is None  # absent -> gated off

        gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
        os.makedirs(gt_dir)
        with open(os.path.join(gt_dir, "data.csv"), "w") as f:
            f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m],"
                    " q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
            for i in range(40):
                ts = 995_000_000 + i * 5_000_000  # 200 Hz
                f.write(f"{ts},{0.1 * i},{0.2 * i},{-0.05 * i},"
                        "1.0,0.0,0.0,0.0\n")
        gt = euroc.load_groundtruth(root)
        assert gt is not None
        ts_gt, pos_gt = gt
        assert ts_gt.shape == (40,) and pos_gt.shape == (40, 3)

        frames, Ks, dists, size, stamps = euroc.load_dataset(
            [root], num_frames=3, with_timestamps=True)
        assert len(stamps[0]) == 3
        at = euroc.groundtruth_at(ts_gt, pos_gt, stamps[0])
        assert at.shape == (3, 3)
        # frame at t=1.0 s -> gt row i=1 (ts 1_000_000_000) = (0.1, 0.2, -.05)
        np.testing.assert_allclose(at[0], [0.1, 0.2, -0.05])


class TestCliEurocRunpath:
    def test_cli_euroc_with_groundtruth_reports_ate(self, tmp_path, capsys):
        """End-to-end --euroc runpath: two mock ASL sequences with ground
        truth -> session runs -> per-drone ATE/RPE lines print (the
        BASELINE 'within 1%' claim is checkable the moment real data is
        mounted)."""
        from coloc_tpu import cli
        from coloc_tpu.io.synthetic import trajectory

        scene = synthetic.make_scene(H, W, K, seed=4)
        roots = []
        for d in range(2):
            root = str(tmp_path / f"seq{d}")
            # undistorted yaml: the mock renderer projects pinhole-only, so
            # the calib must agree for localization to succeed
            _write_sequence(root, 1_000_000_000, 6, scene, d,
                            dist="[0.0, 0.0, 0.0, 0.0]")
            # ground truth from the same trajectory generator, 200 Hz
            Rs, Cs = trajectory(6, d)
            gt_dir = os.path.join(root, "mav0",
                                  "state_groundtruth_estimate0")
            os.makedirs(gt_dir)
            with open(os.path.join(gt_dir, "data.csv"), "w") as f:
                f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m],"
                        " p_RS_R_z [m], q_RS_w [], ...\n")
                for i in range(6):
                    ts = 1_000_000_000 + i * 50_000_000
                    f.write(f"{ts},{Cs[i][0]},{Cs[i][1]},{Cs[i][2]},"
                            "1,0,0,0\n")
            roots.append(root)

        out = str(tmp_path / "run_out")
        cli.main(["--euroc", *roots, "--out", out, "--maxkp", "256",
                  "--fast-threshold", "10", "--inter-every", "0"])
        text = capsys.readouterr().out
        assert "ATE=" in text, text
        assert "drone 0:" in text and "drone 1:" in text
    def test_ate_invariant_to_similarity(self, rng):
        """ATE after Umeyama alignment is ~0 for a rotated+scaled+shifted
        copy, and equals injected noise RMS otherwise."""
        from coloc_tpu import metrics
        from coloc_tpu.geometry import so3

        gt = rng.uniform(-5, 5, (50, 3))
        Rm = np.asarray(so3.exp(jnp.asarray([0.3, -0.2, 0.9], jnp.float32)))
        est = (2.5 * (Rm @ gt.T)).T + np.array([10.0, -3.0, 4.0])
        ate, res = metrics.ate_rmse(est, gt)
        assert ate < 1e-6
        # with noise, ATE ~ noise RMS
        noise = rng.normal(scale=0.05, size=gt.shape)
        ate_n, _ = metrics.ate_rmse(est + noise, gt)
        assert 0.02 < ate_n < 0.12

    def test_rpe_catches_drift_ate_absorbs(self, rng):
        """A linearly drifting estimate: similarity alignment absorbs much
        of the drift in ATE, but RPE per-step error reflects the drift
        rate."""
        from coloc_tpu import metrics

        t = np.linspace(0, 1, 60)
        gt = np.stack([np.cos(4 * t), np.sin(4 * t), t], 1)
        drift = np.stack([0.5 * t ** 2, np.zeros_like(t),
                          np.zeros_like(t)], 1)
        est = gt + drift
        rpe, _ = metrics.rpe_translation(est, gt)
        assert rpe > 0.0
        ate, _ = metrics.ate_rmse(est, gt)
        assert np.isfinite(ate)


class TestPatchCoverageInvariant:
    def test_all_samples_land_inside_patch(self, rng):
        """patch_origins' guarantee: every clamped sample within _MARGIN of
        the keypoint falls inside the (PH, PW) window — fuzzed over random
        keypoints, levels, and edge positions."""
        from coloc_tpu.ops import patches as patch_ops
        from coloc_tpu.ops import pyramid as pyr_ops

        img = jnp.asarray(rng.uniform(0, 255, (120, 200)), jnp.float32)
        levels = pyr_ops.build_pyramid(img, 4, 1.2)
        sp = patch_ops.stack_levels(levels)

        n = 512
        kp_l = jnp.asarray(rng.integers(0, 4, n), jnp.int32)
        hs = np.asarray(sp.heights)[np.asarray(kp_l)]
        ws = np.asarray(sp.widths)[np.asarray(kp_l)]
        # include exact borders and corners
        kp_x = jnp.asarray(rng.uniform(0, ws - 1) * rng.choice([0, 1, 1], n)
                           + (ws - 1) * (rng.random(n) < 0.1), jnp.float32)
        kp_y = jnp.asarray(np.clip(rng.uniform(0, hs - 1), 0, None),
                           jnp.float32)
        kp_x = jnp.clip(kp_x, 0, jnp.asarray(ws - 1, jnp.float32))

        row0, col0 = patch_ops.patch_origins(sp, kp_x, kp_y, kp_l)
        row0n, col0n = np.asarray(row0), np.asarray(col0)
        rbn = np.asarray(sp.row_base)[np.asarray(kp_l)]

        d = patch_ops._MARGIN
        for dx, dy in [(-d, 0), (d, 0), (0, -d), (0, d), (-d, -d), (d, d)]:
            gx = np.clip(np.asarray(kp_x) + dx, 0, ws - 1)
            gy = np.clip(np.asarray(kp_y) + dy, 0, hs - 1)
            lx = gx - col0n
            ly = (rbn + gy) - row0n
            assert (lx >= -1e-3).all() and (lx <= patch_ops.PW - 1 + 1e-3).all()
            assert (ly >= -1e-3).all() and (ly <= patch_ops.PH - 1 + 1e-3).all()
