"""Multi-view incremental reconstruction tests (reconstructScene parity:
seed pair + P3P resection + new-landmark triangulation + final BA —
BASELINE config 5's reconstruction core)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import RansacOptions, RefinerOptions
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import so3
from coloc_tpu.robust import relative_pose_essential
from coloc_tpu.sfm import reconstruct
from coloc_tpu.types import Matches, TwoViewGeometry, empty_features

K = jnp.asarray([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]], jnp.float32)
CAM = cam_ops.Camera(K=K, dist=jnp.zeros(3, jnp.float32))


def make_multiview(rng, V=4, n=256):
    """V views of a 3D point cloud with perfect correspondences keyed to
    view-0 feature order (plus per-view visibility dropout)."""
    Rs = [jnp.eye(3)]
    Cs = [jnp.zeros(3)]
    for v in range(1, V):
        Rs.append(jnp.asarray(so3.exp(jnp.asarray(
            [0.02 * v, -0.12 * v, 0.01 * v], jnp.float32))))
        Cs.append(jnp.asarray([0.8 * v, 0.1 * v, 0.05 * v], jnp.float32))
    X = jnp.asarray(
        np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(6, 16, (n, 1))],
        jnp.float32,
    )
    feats, vis = [], []
    for v in range(V):
        uv = cam_ops.project(CAM, Rs[v], Cs[v], X)
        visible = jnp.asarray(rng.random(n) > 0.15)
        feats.append(empty_features(n)._replace(xy=uv, valid=visible))
        vis.append(visible)
    # pairwise identity matches masked by joint visibility
    pair_matches = {}
    for a in range(V):
        for b in range(a + 1, V):
            mask = vis[a] & vis[b]
            pair_matches[(a, b)] = Matches(
                idx=jnp.where(mask, jnp.arange(n, dtype=jnp.int32), -1),
                best=jnp.zeros(n, jnp.int32),
                second=jnp.full((n,), 100, jnp.int32),
            )
    return feats, pair_matches, Rs, Cs, X


class TestMultiViewReconstruction:
    def test_four_view_scene(self, rng):
        V = 4
        feats, pair_matches, Rs, Cs, X = make_multiview(rng, V=V)
        # robust two-view geometry for every pair
        pair_geo = {}
        for (a, b), m in pair_matches.items():
            geo = relative_pose_essential(
                jax.random.PRNGKey(a * 10 + b), feats[a].xy,
                feats[b].xy[m.idx], m.mask, CAM, CAM, RansacOptions(),
            )
            pair_geo[(a, b)] = geo

        scale = float(jnp.linalg.norm(Cs[1]))  # seed likely (0,1); see below
        seed = max(pair_geo, key=lambda p: int(pair_geo[p].n_inliers))
        i, j = seed
        rel_gt_C = jnp.asarray(Rs[i]) @ (Cs[j] - Cs[i])
        scale = float(jnp.linalg.norm(rel_gt_C))

        cams = [CAM] * V
        Ks = jnp.tile(K[None], (V, 1, 1))
        dists = jnp.zeros((V, 3))
        scene, res = reconstruct.reconstruct_scene(
            jax.random.PRNGKey(0), feats, pair_matches, pair_geo, cams,
            Ks, dists, scale, num_landmarks=256,
            refiner_opts=RefinerOptions(max_iterations=20),
            ransac_opts=RansacOptions(),
        )
        assert float(res.rmse) < 0.5
        # all V poses resected: compare each view's pose against GT expressed
        # in the seed-i frame
        order = [i, j] + [v for v in range(V) if v not in (i, j)]
        Ri = jnp.asarray(Rs[i])
        Ci = jnp.asarray(Cs[i])
        for r, v in enumerate(order):
            R_gt = jnp.asarray(Rs[v]) @ Ri.T
            C_gt = Ri @ (jnp.asarray(Cs[v]) - Ci)
            cos = (np.trace(np.asarray(scene.Rs[r]).T @ np.asarray(R_gt)) - 1) / 2
            assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0, f"view {v}"
            assert np.linalg.norm(np.asarray(scene.Cs[r]) - np.asarray(C_gt)) < 0.15, f"view {v}"
        # structure: every valid landmark lies on a GT point in the seed
        # frame (slots are track-keyed, so match by position not index)
        X_gt = np.asarray((X - Ci) @ Ri.T)
        inl = np.asarray(scene.X_valid)
        Xs = np.asarray(scene.X)[inl]
        d = np.linalg.norm(Xs[:, None, :] - X_gt[None, :, :], axis=-1)
        err = d.min(axis=1)
        assert np.median(err) < 0.05
        assert np.percentile(err, 90) < 0.1
        assert inl.sum() > 150

    def test_new_landmarks_grow_beyond_seed(self, rng):
        """Regression (review finding): points INVISIBLE to the seed pair but
        seen by resected views must be added by new-landmark triangulation —
        an earlier gate conjunction made this path unconditionally dead."""
        feats, pair_matches, Rs, Cs, X = make_multiview(rng, V=4, n=256)
        hide = np.zeros(256, bool)
        hide[:60] = True
        feats[1] = feats[1]._replace(
            valid=jnp.asarray(np.asarray(feats[1].valid) & ~hide)
        )
        for key in [k for k in pair_matches if 1 in k]:
            m = pair_matches[key]
            keep = (np.asarray(m.idx) >= 0) & ~hide
            pair_matches[key] = m._replace(
                idx=jnp.where(jnp.asarray(keep), m.idx, -1)
            )
        geo01 = relative_pose_essential(
            jax.random.PRNGKey(1), feats[0].xy,
            feats[1].xy[pair_matches[(0, 1)].idx],
            pair_matches[(0, 1)].mask, CAM, CAM, RansacOptions(),
        )
        pair_geo = {(0, 1): geo01}  # force the blind seed pair
        rel_C = np.asarray(Rs[0]) @ (np.asarray(Cs[1]) - np.asarray(Cs[0]))
        scene, _ = reconstruct.reconstruct_scene(
            jax.random.PRNGKey(0), feats, pair_matches, pair_geo,
            [CAM] * 4, jnp.tile(K[None], (4, 1, 1)), jnp.zeros((4, 3)),
            float(np.linalg.norm(rel_C)), num_landmarks=256,
            refiner_opts=RefinerOptions(max_iterations=20),
            ransac_opts=RansacOptions(),
        )
        # slots are track-keyed: check recovery by position (world == view-0
        # frame; the hidden GT points are X[:60])
        Xs = np.asarray(scene.X)[np.asarray(scene.X_valid)]
        d = np.linalg.norm(
            Xs[None, :, :] - np.asarray(X[:60])[:, None, :], axis=-1
        )
        recovered = (d.min(axis=1) < 0.05).sum()
        assert recovered > 30, f"only {recovered}/60 hidden landmarks recovered"

    def test_landmark_invisible_to_seed_views(self, rng):
        """A landmark NEVER seen by EITHER
        seed view must still be reconstructed via tracks through other views
        (old seed-keyed design could not represent these at all)."""
        V = 4
        feats, pair_matches, Rs, Cs, X = make_multiview(rng, V=V, n=256)
        # hide features 0..59 from both seed views (0 and 1) — tracks
        # between views 2 and 3 are their only source
        hide = np.zeros(256, bool)
        hide[:60] = True
        for v in (0, 1):
            feats[v] = feats[v]._replace(
                valid=jnp.asarray(np.asarray(feats[v].valid) & ~hide)
            )
        for (a, b) in list(pair_matches):
            if a in (0, 1) or b in (0, 1):
                m = pair_matches[(a, b)]
                keep = (np.asarray(m.idx) >= 0) & ~hide
                pair_matches[(a, b)] = m._replace(
                    idx=jnp.where(jnp.asarray(keep), m.idx, -1)
                )
        geo01 = relative_pose_essential(
            jax.random.PRNGKey(1), feats[0].xy,
            feats[1].xy[pair_matches[(0, 1)].idx],
            pair_matches[(0, 1)].mask, CAM, CAM, RansacOptions(),
        )
        pair_geo = {(0, 1): geo01}  # force the blind seed pair
        rel_C = np.asarray(Rs[0]) @ (np.asarray(Cs[1]) - np.asarray(Cs[0]))
        scene, _ = reconstruct.reconstruct_scene(
            jax.random.PRNGKey(0), feats, pair_matches, pair_geo,
            [CAM] * V, jnp.tile(K[None], (V, 1, 1)), jnp.zeros((V, 3)),
            float(np.linalg.norm(rel_C)), num_landmarks=512,
            refiner_opts=RefinerOptions(max_iterations=20),
            ransac_opts=RansacOptions(),
        )
        # verify a healthy count of reconstructed landmarks matches the GT of
        # the seed-invisible points (world frame == view-0 frame here)
        Xs = np.asarray(scene.X)[np.asarray(scene.X_valid)]
        d = np.linalg.norm(
            Xs[None, :, :] - np.asarray(X[:60])[:, None, :], axis=-1
        )
        recovered = (d.min(axis=1) < 0.05).sum()
        assert recovered > 30, f"only {recovered}/60 seed-invisible landmarks"
