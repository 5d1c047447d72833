"""Tests for SVG overlays, stream interface, and 7-point F path."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import ColocConfig, DetectorOptions, RansacOptions
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import so3
from coloc_tpu.io import stream, svg
from coloc_tpu.robust import relative_pose_fundamental


class TestSVG:
    def test_draw_features(self, tmp_path, rng):
        img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
        xy = rng.uniform(5, 50, (10, 2)).astype(np.float32)
        valid = np.ones(10, bool)
        valid[5:] = False
        p = str(tmp_path / "features.svg")
        svg.draw_features(p, img, xy, valid)
        content = open(p).read()
        assert content.count("<circle") == 5
        assert "<image" in content

    def test_draw_matches(self, tmp_path, rng):
        img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
        xy1 = rng.uniform(5, 50, (8, 2)).astype(np.float32)
        xy2 = rng.uniform(5, 50, (8, 2)).astype(np.float32)
        idx = np.arange(8, dtype=np.int32)
        mask = np.zeros(8, bool)
        mask[:3] = True
        p = str(tmp_path / "matches.svg")
        svg.draw_matches(p, img, img, xy1, xy2, idx, mask)
        content = open(p).read()
        assert content.count("<line") == 3


class TestStream:
    def test_push_pop(self):
        fs = stream.FrameStream(2)
        img = np.zeros((4, 4), np.float32)
        fs.push(0, img, timestamp=1.0)
        ts, out = fs.pop(0, timeout=0.1)
        assert ts == 1.0
        assert fs.pop(1, timeout=0.05) is None

    def test_drop_oldest_when_full(self):
        fs = stream.FrameStream(1, maxsize=2)
        for i in range(5):
            fs.push(0, np.full((2, 2), i, np.float32), timestamp=float(i))
        ts, img = fs.pop(0, timeout=0.1)
        assert ts == 3.0  # 0..2 dropped

    def test_approximate_sync(self):
        fs = stream.FrameStream(2)
        sync = stream.ApproximateTimeSync(fs, 0, 1, slop=0.05)
        # drone 0 frame at t=0 has no partner (drone1 at 0.2) -> dropped
        fs.push(0, np.zeros((2, 2), np.float32), timestamp=0.0)
        fs.push(0, np.ones((2, 2), np.float32), timestamp=0.21)
        fs.push(1, np.full((2, 2), 2, np.float32), timestamp=0.2)
        pair = sync.next_pair(timeout=0.5)
        assert pair is not None
        (ta, ia), (tb, ib) = pair
        assert abs(ta - tb) <= 0.05
        assert ia[0, 0] == 1.0

    def test_live_feed_thread(self):
        """Producer thread + consumer: frames flow through."""
        fs = stream.FrameStream(1)

        def producer():
            for i in range(5):
                fs.push(0, np.full((2, 2), i, np.float32))
                time.sleep(0.005)

        t = threading.Thread(target=producer)
        t.start()
        got = []
        for _ in range(5):
            item = fs.pop(0, timeout=1.0)
            if item:
                got.append(int(item[1][0, 0]))
        t.join()
        assert got == [0, 1, 2, 3, 4]


class TestSevenPointPath:
    def test_fundamental_ransac_7pt(self, rng):
        K = jnp.asarray([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], jnp.float32)
        CAM = cam_ops.Camera(K=K, dist=jnp.zeros(3, jnp.float32))
        R = jnp.asarray(so3.exp(jnp.asarray([0.03, -0.25, 0.02], jnp.float32)))
        C = jnp.asarray([1.0, 0.15, 0.05], jnp.float32)
        n, n_out = 200, 60
        X = jnp.asarray(
            np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(5, 15, (n, 1))],
            jnp.float32,
        )
        uv1 = cam_ops.project(CAM, jnp.eye(3), jnp.zeros(3), X)
        uv2 = cam_ops.project(CAM, R, C, X)
        uv2 = uv2.at[n - n_out:].set(
            jnp.asarray(rng.uniform(50, 600, (n_out, 2)), jnp.float32)
        )
        geo = relative_pose_fundamental(
            jax.random.PRNGKey(1), uv1, uv2, jnp.ones(n, bool), CAM, CAM,
            RansacOptions(),
        )
        assert bool(geo.success)
        cos = (np.trace(np.asarray(geo.R).T @ np.asarray(R)) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.5
        assert int(geo.n_inliers) >= n - n_out - 10


class TestNFAScoring:
    def test_nfa_essential_adaptive(self, rng):
        """ACRANSAC scoring: recovers pose AND adapts the inlier threshold
        to the noise level (tighter at low noise)."""
        from coloc_tpu.robust import relative_pose_essential

        K = jnp.asarray([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], jnp.float32)
        CAM = cam_ops.Camera(K=K, dist=jnp.zeros(3, jnp.float32))
        R = jnp.asarray(so3.exp(jnp.asarray([0.03, -0.25, 0.02], jnp.float32)))
        C = jnp.asarray([1.0, 0.15, 0.05], jnp.float32)
        n, n_out = 200, 60
        X = jnp.asarray(
            np.c_[rng.uniform(-3, 3, (n, 2)), rng.uniform(5, 15, (n, 1))],
            jnp.float32,
        )
        uv1 = np.array(cam_ops.project(CAM, jnp.eye(3), jnp.zeros(3), X))
        uv2 = np.array(cam_ops.project(CAM, R, C, X))
        uv1 += rng.normal(0, 0.2, uv1.shape)
        uv2 += rng.normal(0, 0.2, uv2.shape)
        uv2[n - n_out:] = rng.uniform(50, 600, (n_out, 2))
        geo = relative_pose_essential(
            jax.random.PRNGKey(0), jnp.asarray(uv1, jnp.float32),
            jnp.asarray(uv2, jnp.float32), jnp.ones(n, bool), CAM, CAM,
            RansacOptions(scoring="nfa"),
        )
        assert bool(geo.success)
        cos = (np.trace(np.asarray(geo.R).T @ np.asarray(R)) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0
        inl = np.asarray(geo.inliers)
        # all true inliers found, almost no false ones
        assert inl[: n - n_out].mean() > 0.9
        assert inl[n - n_out:].sum() <= 3

    def test_nfa_rejects_pure_noise(self, rng):
        """Random correspondences: NFA must declare nothing meaningful."""
        from coloc_tpu.robust import relative_pose_essential

        K = jnp.asarray([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], jnp.float32)
        CAM = cam_ops.Camera(K=K, dist=jnp.zeros(3, jnp.float32))
        n = 60
        uv1 = jnp.asarray(rng.uniform(50, 600, (n, 2)), jnp.float32)
        uv2 = jnp.asarray(rng.uniform(50, 600, (n, 2)), jnp.float32)
        geo = relative_pose_essential(
            jax.random.PRNGKey(0), uv1, uv2, jnp.ones(n, bool), CAM, CAM,
            RansacOptions(scoring="nfa"),
        )
        assert not bool(geo.success)


class TestPGM:
    def test_pgm_round_trip(self, tmp_path):
        """Binary PGM written and read back with numpy alone: uint8 values
        survive exactly, floats truncate like a uint8 cast, out-of-range
        values clip, and a comment line in the header is skipped."""
        from coloc_tpu.io import disk

        rng = np.random.default_rng(0)
        img = rng.uniform(-20, 280, (37, 53)).astype(np.float32)
        path = str(tmp_path / "x.pgm")
        disk.write_pgm(path, img)
        back = disk.load_image(path)
        assert back.dtype == np.float32 and back.shape == (37, 53)
        np.testing.assert_array_equal(
            back, np.clip(img, 0, 255).astype(np.uint8).astype(np.float32))
        raw = open(path, "rb").read()
        with open(path, "wb") as fh:
            fh.write(raw.replace(b"P5\n", b"P5\n# made by a test\n", 1))
        np.testing.assert_array_equal(disk.read_pgm(path), back)
