"""Live viz streamer tests (rosUtils.hpp analog)."""

import json
import urllib.request

import numpy as np

from coloc_tpu.io.liveviz import LiveViz


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


class TestLiveViz:
    def test_serves_page_and_state(self):
        viz = LiveViz(port=0)  # ephemeral port
        try:
            page = _get(viz.url)
            assert "coloc_tpu live" in page
            state = json.loads(_get(viz.url + "state.json"))
            assert state == {"poses": {}, "map": [], "frame": None}

            viz.publish_pose(0, np.array([1.0, 2.0, 3.0]),
                             cov3=np.eye(3) * 0.01, success=True, frame=7)
            viz.publish_pose(1, np.array([-1.0, 0.5, 2.0]), success=False)
            viz.publish_map(np.array([[0, 0, 5], [1, 1, 6], [2, 0, 7]],
                                     np.float32),
                            valid=np.array([True, True, False]))

            state = json.loads(_get(viz.url + "state.json"))
            assert state["frame"] == 7
            assert state["poses"]["0"]["C"] == [1.0, 2.0, 3.0]
            assert state["poses"]["0"]["success"] is True
            assert state["poses"]["1"]["success"] is False
            assert len(state["map"]) == 2  # invalid landmark dropped
        finally:
            viz.close()

    def test_view_config_served_and_overridable(self, tmp_path):
        """The coloc.rviz analog: the repo-default coloc.view.json is
        picked up automatically, /view.json serves the layout, and dict /
        file / invalid-file configurations behave as documented."""
        # default: repo-root coloc.view.json
        viz = LiveViz(port=0)
        try:
            view = json.loads(_get(viz.url + "view.json"))
            assert view["views"] == ["xz", "xy"]
            assert view["trail"] == 500
            assert "view.json" in _get(viz.url)  # page fetches the config
        finally:
            viz.close()

        # dict override
        viz = LiveViz(port=0, view_config={"trail": 100, "views": ["zy"]})
        try:
            view = json.loads(_get(viz.url + "view.json"))
            assert view["trail"] == 100 and view["views"] == ["zy"]
            assert view["point_size"] == 2  # unset keys keep defaults
        finally:
            viz.close()

        # file override
        p = tmp_path / "v.json"
        p.write_text(json.dumps({"bounds": [-2, 2, -1, 1]}))
        viz = LiveViz(port=0, view_config=str(p))
        try:
            view = json.loads(_get(viz.url + "view.json"))
            assert view["bounds"] == [-2, 2, -1, 1]
        finally:
            viz.close()

        # invalid file: warn + defaults, never crash the operator view
        import pytest

        with pytest.warns(RuntimeWarning, match="view config"):
            viz = LiveViz(port=0, view_config=str(tmp_path / "missing.json"))
        try:
            view = json.loads(_get(viz.url + "view.json"))
            assert view["trail"] == 500
        finally:
            viz.close()

    def test_map_downsampling(self):
        viz = LiveViz(port=0, max_map_points=100)
        try:
            viz.publish_map(np.random.default_rng(0).normal(size=(1000, 3)))
            state = json.loads(_get(viz.url + "state.json"))
            assert 50 <= len(state["map"]) <= 100
        finally:
            viz.close()

    def test_session_pushes_poses_and_map(self):
        """End-to-end: a synthetic session with a viz sink attached publishes
        the map after init and a pose per intra step."""
        import jax.numpy as jnp
        from coloc_tpu.config import ColocConfig, DetectorOptions
        from coloc_tpu.io import synthetic
        from coloc_tpu.session import ColocSession

        h, w = 96, 128
        K = np.array([[80.0, 0, 64], [0, 80.0, 48], [0, 0, 1]], np.float32)
        scene = synthetic.make_scene(h, w, K, seed=2)
        cfg = ColocConfig(
            detector=DetectorOptions(width=w, height=h, max_keypoints=128,
                                     num_levels=2, fast_threshold=10),
            max_landmarks=256,
        )
        viz = LiveViz(port=0)
        try:
            sess = ColocSession(cfg, np.stack([K] * 2),
                                np.zeros((2, 3), np.float32), viz=viz)
            frames = {}
            for d in range(2):
                Rs, Cs = synthetic.trajectory(2, d)
                frames[d] = [synthetic.render(scene, Rs[f], Cs[f])
                             for f in range(2)]
            assert sess.init_map({0: frames[0][0], 1: frames[1][0]})
            sess.intra_pose(0, frames[0][1])
            state = json.loads(_get(viz.url + "state.json"))
            assert len(state["map"]) > 0
            assert "0" in state["poses"]
        finally:
            viz.close()
