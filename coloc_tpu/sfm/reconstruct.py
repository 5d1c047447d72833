"""Scene reconstruction: two-view bootstrap, resection, map database.

Reference parity: Reconstructor.hpp —
  reconstructScene (:102-164): seed pair = argmax geometric matches, tracks,
    per-camera intrinsics, DLT triangulation with world origin at the seed
    view and the relative pose scaled by `scale` (:185-239; depth > 0 and
    |Z| < 100 gates :227-231), P3P resection of remaining views
    (resectionCamera :259-415: ray-angle > 2 deg, depth > 0, |Z| < 1000
    gates for newly triangulated points), final BA via PoseRefiner.
  interReconstruct (:80-100): seed-pair-only variant for the inter-drone
    temporary scene.
Plus colocData.hpp:89-121 setupMapDatabase: flat descriptor bank from the
FIRST observation of each landmark + landmark index.

Device shape: the scene is a fixed-capacity pytree; triangulation gates become
validity-mask updates; landmark slots are keyed by seed-view feature index.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from coloc_tpu.config import ColocConfig, RefinerOptions
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import se3
from coloc_tpu.geometry import triangulation as tri
from coloc_tpu.sfm.ba import BAProblem, BAResult, refine
from coloc_tpu.types import Features, MapDB, Matches, Pose

_MAX_Z_BOOTSTRAP = 100.0   # Reconstructor.hpp:227-231
_MAX_Z_RESECTION = 1000.0  # Reconstructor.hpp:383
_MIN_RAY_ANGLE_DEG = 2.0   # Reconstructor.hpp:380


class Scene(NamedTuple):
    """Fixed-capacity SfM scene (OpenMVG SfM_Data equivalent).

    V views, L landmark slots. Landmark slot l corresponds to seed-view
    feature l where valid.
    """

    Rs: jnp.ndarray        # (V, 3, 3)
    Cs: jnp.ndarray        # (V, 3)
    X: jnp.ndarray         # (L, 3)
    X_valid: jnp.ndarray   # (L,) bool
    obs: jnp.ndarray       # (V, L, 2) distorted pixel observations
    obs_mask: jnp.ndarray  # (V, L) bool
    desc: jnp.ndarray      # (L, 16) uint32 first-observation descriptors

    @property
    def num_views(self) -> int:
        return self.Rs.shape[0]

    @property
    def capacity(self) -> int:
        return self.X.shape[0]


@functools.partial(jax.jit, static_argnames=("num_landmarks",))
def two_view_scene(
    feats_i: Features,
    feats_j: Features,
    matches: Matches,         # query = view i, train = view j
    inliers: jnp.ndarray,     # (K,) bool from robust geometry
    rel_R: jnp.ndarray,       # relative motion i -> j (x_j = R (x_i - C_rel))
    rel_t: jnp.ndarray,       # unit translation of relative pose
    pose_i: Pose,             # world pose of view i (origin at bootstrap)
    scale: float,
    cam_i: cam_ops.Camera,
    cam_j: cam_ops.Camera,
    num_landmarks: int,
) -> Scene:
    """Bootstrap a two-view scene by DLT triangulation of the inlier matches.

    Landmark slot l = feature l of view i (first-observation convention, so
    the descriptor bank is just feats_i.desc masked to surviving landmarks).
    """
    K = feats_i.capacity
    L = num_landmarks

    rel = Pose(R=rel_R, C=-rel_R.T @ rel_t)
    pose_j = se3.relative_to_absolute(rel, pose_i, scale=scale)

    uv_i = feats_i.xy                              # (K, 2)
    uv_j = feats_j.xy[matches.idx]                 # (K, 2) (idx<0 garbage, masked)
    x_i = cam_ops.undistort(cam_i, cam_ops.normalize(cam_i, uv_i))
    x_j = cam_ops.undistort(cam_j, cam_ops.normalize(cam_j, uv_j))

    X = tri.triangulate_points(pose_i.R, pose_i.C, x_i, pose_j.R, pose_j.C, x_j)

    d_i = tri.depth_in_view(pose_i.R, pose_i.C, X)
    d_j = tri.depth_in_view(pose_j.R, pose_j.C, X)
    gates = (
        (d_i > 0.0) & (d_j > 0.0)
        & (jnp.abs(X[:, 2]) < _MAX_Z_BOOTSTRAP)
    )
    valid = matches.mask & inliers & feats_i.valid & gates

    # fixed capacity: slots beyond L dropped (K <= L in all default configs)
    def fit(a):
        return a[:L] if a.shape[0] >= L else jnp.pad(
            a, ((0, L - a.shape[0]),) + ((0, 0),) * (a.ndim - 1)
        )

    X_valid = fit(valid)
    Xl = jnp.where(X_valid[:, None], fit(X), 0.0)

    obs = jnp.stack([fit(uv_i), fit(uv_j)])        # (2, L, 2)
    obs_mask = jnp.stack([X_valid, X_valid])

    return Scene(
        Rs=jnp.stack([pose_i.R, pose_j.R]),
        Cs=jnp.stack([pose_i.C, pose_j.C]),
        X=Xl,
        X_valid=X_valid,
        obs=obs,
        obs_mask=obs_mask,
        desc=fit(feats_i.desc),
    )


def refine_scene(
    scene: Scene,
    cams_K: jnp.ndarray,     # (V, 3, 3)
    cams_dist: jnp.ndarray,  # (V, 3)
    opts: RefinerOptions,
    fix_pose: jnp.ndarray,
    cov_view: int = 1,
    optimize_structure: bool = True,
) -> Tuple[Scene, BAResult]:
    """BA over the scene (Reconstructor.hpp:150-161 pattern).

    `optimize_structure=False` is the reference's poses-only call-site
    pattern (Optimize_Options with Structure_Parameter_Type::NONE,
    coloc.hpp:339): landmarks held constant, covariance = inverse pose
    Hessian without Schur marginalization (ceres::Covariance on the
    pose-only problem)."""
    problem = BAProblem(
        Rs=scene.Rs, Cs=scene.Cs, X=scene.X,
        obs=scene.obs,
        obs_mask=scene.obs_mask & scene.X_valid[None, :],
        Ks=cams_K, dists=cams_dist,
    )
    res = refine(problem, opts, fix_pose,
                 optimize_structure=optimize_structure, cov_view=cov_view)
    out = scene._replace(Rs=res.Rs, Cs=res.Cs, X=res.X)
    return out, res


def scene_to_mapdb(scene: Scene) -> MapDB:
    """setupMapDatabase parity (colocData.hpp:89-121): descriptor bank =
    first observation of each landmark; here that is scene.desc by
    construction (slots keyed by seed-view features)."""
    return MapDB(X=scene.X, desc=scene.desc, valid=scene.X_valid)


@jax.jit
def _triangulate_pair(
    Ra, Ca, Rb, Cb,
    cam_a: cam_ops.Camera,
    cam_b: cam_ops.Camera,
    uv_a: jnp.ndarray,        # (L, 2) distorted pixels in view a
    uv_b: jnp.ndarray,        # (L, 2) distorted pixels in view b
    vis: jnp.ndarray,         # (L,) bool candidate mask
    max_z,                    # |Z| gate (100 bootstrap / 1000 resection)
    min_angle_deg,            # ray-angle gate (0 bootstrap / 2 resection)
    reproj_max_sq,            # reprojection gate in px^2 (inf bootstrap / 16)
):
    """Masked DLT of one view pair with the Reconstructor gates
    (Reconstructor.hpp:225-237 bootstrap, :354-412 resection).
    Returns (X (L, 3), ok (L,) bool)."""
    x_a = cam_ops.undistort(cam_a, cam_ops.normalize(cam_a, uv_a))
    x_b = cam_ops.undistort(cam_b, cam_ops.normalize(cam_b, uv_b))
    X = tri.triangulate_points(Ra, Ca, x_a, Rb, Cb, x_b)
    d_a = tri.depth_in_view(Ra, Ca, X)
    d_b = tri.depth_in_view(Rb, Cb, X)
    ang = tri.ray_angle_deg(Ca, Cb, X)
    reproj_a = jnp.sum((cam_ops.project(cam_a, Ra, Ca, X) - uv_a) ** 2, -1)
    reproj_b = jnp.sum((cam_ops.project(cam_b, Rb, Cb, X) - uv_b) ** 2, -1)
    ok = (
        vis
        & (d_a > 0.0) & (d_b > 0.0)
        & (ang >= min_angle_deg)
        & (jnp.abs(X[:, 2]) < max_z)
        & (reproj_a < reproj_max_sq) & (reproj_b < reproj_max_sq)
    )
    return jnp.where(ok[:, None], X, 0.0), ok


def reconstruct_scene(
    key,
    features: list,            # V Features banks
    pair_matches: dict,        # (i, j) -> Matches
    pair_geo: dict,            # (i, j) -> TwoViewGeometry
    cams: list,                # V Camera
    Ks: jnp.ndarray,           # (V, 3, 3)
    dists: jnp.ndarray,        # (V, 3)
    scale: float,
    num_landmarks: int,
    refiner_opts,
    ransac_opts,
) -> Tuple[Scene, "BAResult"]:
    """Full multi-view TRACK-BASED incremental reconstruction
    (reconstructScene parity, Reconstructor.hpp:102-164).

    Host-orchestrated events over jitted device steps:
      1. union-find tracks over ALL geometric-inlier pairwise matches
         (TracksBuilder, Reconstructor.hpp:166-173) — landmark slots are
         keyed by TRACK id, so a point never seen by the seed view can still
         become a landmark
      2. seed pair = argmax geometric-inlier count (:112-118); two-view
         triangulation with world origin at the seed-first view and the
         relative translation scaled by `scale` (:185-239)
      3. remaining views in best-track-overlap order: P3P resection from the
         track-keyed 2D-3D intersection with the current map (:262-306),
         pose-only polish (SfM_Localizer refine step), then new-landmark
         triangulation against EVERY already-posed partner view with the
         resection gates (:354-412)
      4. final bundle adjustment, seed pose fixed (:150-161)
    """
    import numpy as np

    from coloc_tpu.robust import absolute_pose_p3p
    from coloc_tpu.sfm import tracks as tracks_mod
    from coloc_tpu.sfm.ba import refine_pose_only

    V = len(features)
    cap = features[0].capacity
    L = num_landmarks

    # 1. tracks over geometric-inlier-gated matches
    gated = {}
    for (a, b), m in pair_matches.items():
        idx = np.asarray(m.idx)
        ok = idx >= 0
        if (a, b) in pair_geo:
            ok &= np.asarray(pair_geo[(a, b)].inliers)
        gated[(a, b)] = np.where(ok, idx, -1)
    table, tvalid = tracks_mod.build_tracks(gated, V, cap, L)  # (L, V), (L,)

    # 2. seed pair
    seed = max(pair_geo, key=lambda p: int(pair_geo[p].n_inliers))
    i, j = seed
    geo = pair_geo[seed]
    order = [i, j] + [v for v in range(V) if v not in (i, j)]

    # per-slot observations from the track table (scene row r = view order[r])
    dw = features[0].desc.shape[-1]
    obs = np.zeros((V, L, 2), np.float32)
    obs_mask = np.zeros((V, L), bool)
    desc = np.zeros((L, dw), np.uint32)
    desc_set = np.zeros(L, bool)
    for r, v in enumerate(order):
        fi = table[:, v]
        safe = np.clip(fi, 0, cap - 1)
        has = tvalid & (fi >= 0) & np.asarray(features[v].valid)[safe]
        obs[r] = np.where(has[:, None], np.asarray(features[v].xy)[safe], 0.0)
        obs_mask[r] = has
        newly = has & ~desc_set  # first-observation descriptor convention
        desc[newly] = np.asarray(features[v].desc)[safe[newly]]
        desc_set |= newly

    # seed poses: world origin at view i, rel pose scaled by `scale`
    pose_j = se3.relative_to_absolute(
        Pose(R=geo.R, C=-geo.R.T @ geo.t),
        Pose(R=jnp.eye(3), C=jnp.zeros(3)), scale=scale,
    )
    Rs = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
    Cs = np.zeros((V, 3), np.float32)
    Rs[1] = np.asarray(pose_j.R)
    Cs[1] = np.asarray(pose_j.C)

    # seed triangulation: tracks observed by both seed views
    X, ok = _triangulate_pair(
        Rs[0], Cs[0], Rs[1], Cs[1], cams[i], cams[j],
        obs[0], obs[1], jnp.asarray(obs_mask[0] & obs_mask[1]),
        _MAX_Z_BOOTSTRAP, 0.0, jnp.inf,
    )
    X = np.array(X)          # writable host copies (np.asarray of a JAX
    X_valid = np.array(ok)   # array is read-only)
    posed = [True, True] + [False] * (V - 2)

    # 3. resect remaining views, best track-overlap with the map first
    remaining = list(range(2, V))
    while remaining:
        r = max(remaining, key=lambda rr: int((obs_mask[rr] & X_valid).sum()))
        remaining.remove(r)
        v = order[r]
        corr = jnp.asarray(obs_mask[r] & X_valid)
        key, sub = jax.random.split(key)
        pose_v, inl, n_inl, success = absolute_pose_p3p(
            sub, jnp.asarray(X), jnp.asarray(obs[r]), corr, cams[v],
            ransac_opts,
        )
        if not bool(success):
            obs_mask[r] = False  # failed view contributes nothing to BA
            continue
        res_v = refine_pose_only(
            pose_v.R, pose_v.C, jnp.asarray(X), jnp.asarray(obs[r]), inl,
            cams[v].K, cams[v].dist, refiner_opts,
        )
        Rs[r] = np.asarray(res_v.Rs[1])
        Cs[r] = np.asarray(res_v.Cs[1])
        posed[r] = True
        # new landmarks: still-empty tracks shared with ANY posed partner
        for w in [rw for rw in range(V) if posed[rw] and rw != r]:
            vis = obs_mask[w] & obs_mask[r] & ~X_valid
            if not vis.any():
                continue
            Xn, okn = _triangulate_pair(
                Rs[w], Cs[w], Rs[r], Cs[r], cams[order[w]], cams[v],
                obs[w], obs[r], jnp.asarray(vis),
                _MAX_Z_RESECTION, _MIN_RAY_ANGLE_DEG, 16.0,
            )
            okn = np.asarray(okn)
            X = np.where(okn[:, None], np.asarray(Xn), X)
            X_valid |= okn

    # 4. final BA (seed pose fixed; failed views pinned with no observations)
    scene = Scene(
        Rs=jnp.asarray(Rs), Cs=jnp.asarray(Cs),
        X=jnp.asarray(X), X_valid=jnp.asarray(X_valid),
        obs=jnp.asarray(obs), obs_mask=jnp.asarray(obs_mask),
        desc=jnp.asarray(desc),
    )
    order_idx = jnp.asarray(order)
    fix = jnp.asarray([True] + [not posed[r] for r in range(1, V)])
    scene, res = refine_scene(
        scene, Ks[order_idx], dists[order_idx], refiner_opts, fix,
        cov_view=1,
    )
    return scene, res
