"""Drone-axis mesh parallelism.

Reference parity: the reference "parallelizes" N robots as a sequential loop
in one process (coloc.hpp:128-148) and exchanges descriptors/poses/covariances
over ROS topics or a shared folder (SURVEY.md §2.2). Mesh-native redesign:
the drone axis IS a `jax.sharding.Mesh` axis —
  - each device runs its drone's whole intra-localization step
    (detect -> map match -> P3P -> refine -> KF) locally;
  - what the robots exchange in-algorithm is tiny (poses + 3x3 covariances +
    descriptor banks), so inter-drone steps become device collectives:
    `all_gather` over the drone axis replaces ROS publish/subscribe;
  - the map descriptor bank is replicated (every drone matches against the
    shared map — the reference's resident `setMapData` bank).

`collaborative_step` is the shard_mapped step the multi-device dry-run
(__graft_entry__.dryrun_multichip) compiles: a full per-drone localization
plus an all-gather + pairwise ICI fusion across the mesh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from coloc_tpu import matching, robust, utils
from coloc_tpu.config import ColocConfig
from coloc_tpu.frontend import detect_and_describe
from coloc_tpu.fusion import covint, kalman
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.matching import match_with_map
from coloc_tpu.sfm import localize, reconstruct
from coloc_tpu.types import Features, MapDB, Pose

DRONE_AXIS = "drone"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(devices, axis_names=(DRONE_AXIS,))


def _per_drone_step(
    key, image, K, dist, fb_x, fb_P, fb_steps, mapdb, config: ColocConfig
):
    """One drone's full frame step (runs on one device inside shard_map).

    All leading axes are the local shard (size 1); returns updated filter
    state + pose + covariance + the detected features (reused by the
    inter-drone exchange).
    """
    cam = cam_ops.Camera(K=K[0], dist=dist[0])
    feats = detect_and_describe(image[0], config.detector)
    mm = match_with_map(feats, mapdb, config.matcher)
    pwc, _ = localize.localize_image(
        key, feats, mm, mapdb, cam, config.ransac, config.refiner
    )

    bank = kalman.FilterBank(x=fb_x, P=fb_P, steps=fb_steps)
    z = kalman.fill_measurement(pwc.pose)
    bank, filtered, gate_dist, _rej = kalman.update(
        bank, jnp.int32(0), z, pwc.cov[3:6, 3:6], pwc.rmse, pwc.success,
        config.filter,
    )
    return bank, filtered, pwc, feats


class InterDiag(NamedTuple):
    """Diagnostics from inter_pose_device for host-side logging (guided
    epipolar residuals, CSV rows) — everything session.inter_pose needs so
    host and mesh paths share ONE compute core."""

    geo_R: jnp.ndarray        # (3, 3) robust relative rotation (pre-refine)
    geo_t: jnp.ndarray        # (3,) robust unit translation
    n_inliers: jnp.ndarray    # () int32 geometric inliers
    n_common: jnp.ndarray     # () int32 common landmarks map<->temp
    rmse: jnp.ndarray         # () refine reprojection RMSE
    omega: jnp.ndarray        # () ICI weight
    trace: jnp.ndarray        # () fused covariance trace
    obs_src: jnp.ndarray      # (L, 2) temp src-view obs per map landmark
    obs_dst: jnp.ndarray      # (L, 2) temp dst-view obs per map landmark
    guided_mask: jnp.ndarray  # (L,) bool valid guided-residual entries
    cov_rel: jnp.ndarray      # (3, 3) refine covariance CENTER block — the
    #                           `cov` the reference adds to the source
    #                           covariance before ICI (coloc.hpp:366-367)


class InterPoseOut(NamedTuple):
    fused_pos: jnp.ndarray    # (3,)
    fused_cov: jnp.ndarray    # (3, 3)
    ok: jnp.ndarray           # () bool
    rel: Pose                 # refined relative pose (dst in src frame)
    scale: jnp.ndarray        # () monocular scale factor applied
    diag: InterDiag


def inter_pose_device(
    key,
    f_dst: Features,          # my (destination) frame features
    f_src: Features,          # partner (source) frame features — exchanged
    cam_src: cam_ops.Camera,
    cam_dst: cam_ops.Camera,
    Ks_pair: jnp.ndarray,     # (2, 3, 3) [src, dst]
    dists_pair: jnp.ndarray,  # (2, 3)
    src_pose: Pose,           # partner's current (filtered) world pose
    src_cov3: jnp.ndarray,    # (3, 3) partner's intra position covariance
    dst_pos: jnp.ndarray,     # (3,) my current position estimate
    dst_cov3: jnp.ndarray,    # (3, 3) my intra position covariance
    mapdb: MapDB,             # replicated shared map
    config: ColocConfig,
) -> InterPoseOut:
    """interPoseEstimator stage-for-stage as ONE device computation
    (coloc.hpp:274-392), fully masked — no host branching. This is the
    SINGLE compute core for both paths: session.inter_pose (host events)
    and the sharded mesh exchange (_inter_exchange_step) both call it, so
    the two can never diverge semantically.

      1. pairwise match src->dst            (:287  computeMatchesPair)
      2. robust relative pose               (:296  filterMatchesPair)
      3. temp two-view reconstruction       (:306  interReconstruct)
      4. map-to-map descriptor match        (:317-323 setupMapDatabase(1)
                                                   + matchMapFeatures)
      5. monocular scale alignment          (:331-336 computeScaleDifference
                                                   + rescaleMap)
      6. pose-only refine -> covariance     (:339-341 refinePose)
      7. compose src o rel candidate + ICI  (:351-389 CovIntersection)

    Failure semantics (reference: early returns) become a mask: if the
    relative pose fails or too few common landmarks exist, the fused output
    is the drone's own intra estimate.
    """
    cfg = config
    # 1. pairwise putative match (query = src, train = dst)
    m = matching.match_pair(f_src, f_dst, cfg.matcher)

    # 2. robust relative pose src -> dst (model dispatch is static)
    rel_fn = {
        "E": robust.relative_pose_essential,
        "F": robust.relative_pose_fundamental,
        "H": robust.relative_pose_homography,
    }[cfg.model]
    geo = rel_fn(
        key, f_src.xy, f_dst.xy[m.idx], m.mask, cam_src, cam_dst, cfg.ransac
    )

    # 3. temporary two-view scene, src-anchored (interReconstruct parity)
    temp = reconstruct.two_view_scene(
        f_src, f_dst, m, geo.inliers, geo.R, geo.t,
        Pose(R=jnp.eye(3), C=jnp.zeros(3)), 1.0,
        cam_src, cam_dst, num_landmarks=cfg.max_landmarks,
    )
    temp_db = reconstruct.scene_to_mapdb(temp)   # setupMapDatabase(inter=1)

    # 4. map-to-map descriptor match against the replicated shared map
    mm = matching.match_maps(mapdb, temp_db, cfg.matcher)
    n_common = jnp.sum((mm.mask & mapdb.valid).astype(jnp.int32))

    # 5. monocular scale alignment between the maps
    scale = utils.compute_scale_difference(mapdb, temp_db, mm)
    Xs, Cs = utils.rescale_map(temp.X, temp.Cs, scale)
    temp = temp._replace(X=Xs, Cs=Cs)

    # 6. pose-only refinement of the scaled relative pose -> 6x6 covariance.
    #    Structure is CONSTANT, matching the reference's Optimize_Options
    #    (Extrinsic ADJUST_ALL + Structure NONE, coloc.hpp:339); we keep the
    #    src anchor view fixed instead of adjusting both poses — with
    #    structure held, the anchor is already at its optimum, so this is
    #    the same problem up to gauge and keeps rel = (Rs[1], Cs[1]) exact.
    temp, ba_res = reconstruct.refine_scene(
        temp, Ks_pair, dists_pair, cfg.refiner,
        fix_pose=jnp.asarray([True, False]), cov_view=1,
        optimize_structure=False,
    )

    # 7. compose the fused candidate and ICI-fuse with my intra estimate
    rel = Pose(R=temp.Rs[1], C=temp.Cs[1])
    cand_C = src_pose.C + src_pose.R.T @ rel.C
    C_intra = dst_cov3 + 1e-6 * jnp.eye(3)
    C_cand = src_cov3 + ba_res.cov[3:6, 3:6] + 1e-6 * jnp.eye(3)
    fused = covint.fuse(C_intra, C_cand, dst_pos, cand_C)

    ok = geo.success & (n_common >= 2)
    fused_pos = jnp.where(ok, fused.pos, dst_pos)
    fused_cov = jnp.where(ok, fused.cov, C_intra)
    diag = InterDiag(
        geo_R=geo.R, geo_t=geo.t, n_inliers=geo.n_inliers,
        n_common=n_common, rmse=ba_res.rmse,
        omega=fused.omega, trace=fused.trace,
        obs_src=temp.obs[0][mm.idx], obs_dst=temp.obs[1][mm.idx],
        guided_mask=mm.mask & mapdb.valid & temp.X_valid[mm.idx],
        cov_rel=ba_res.cov[3:6, 3:6],
    )
    return InterPoseOut(
        fused_pos=fused_pos, fused_cov=fused_cov, ok=ok, rel=rel,
        scale=scale, diag=diag,
    )


def _inter_exchange_step(
    key, feats: Features, K, dist, myR, myC, cov3, mapdb: MapDB,
    config: ColocConfig,
):
    """Ring exchange + full inter-drone step (runs INSIDE shard_map; all
    per-shard leading axes already stripped).

    Drone d ships its frame bundle — descriptor bank, keypoints, camera,
    filtered pose, covariance — to drone (d+1)%D via ppermute, so
    each drone receives its ring predecessor's bundle and runs
    inter_pose_device(src=(d-1)%D, dst=d) locally. The payload is
    ~64 B/keypoint + a few hundred bytes of pose state: exactly what the
    reference shipped over ROS topics (SURVEY §2.2).
    """
    n = jax.lax.axis_size(DRONE_AXIS)
    perm = [(i, (i + 1) % n) for i in range(n)]
    shift = lambda x: jax.lax.ppermute(x, DRONE_AXIS, perm)
    f_src = jax.tree_util.tree_map(shift, feats)
    K_src = shift(K)
    dist_src = shift(dist)
    src_R = shift(myR)
    src_C = shift(myC)
    src_cov3 = shift(cov3)
    return inter_pose_device(
        key, feats, f_src,
        cam_ops.Camera(K=K_src, dist=dist_src),
        cam_ops.Camera(K=K, dist=dist),
        jnp.stack([K_src, K]),
        jnp.stack([dist_src, dist]),
        Pose(R=src_R, C=src_C), src_cov3,
        myC, cov3, mapdb, config,
    )


def sharded_inter_step(mesh: Mesh, config: ColocConfig):
    """Standalone sharded interPoseEstimator over precomputed per-drone
    state (the session path detects features + runs intra localization
    first; this is the inter-drone event as one mesh collective program).

    Returns a jitted fn:
      (keys (D, 2) uint32, feats: Features (D, ...), Ks (D, 3, 3),
       dists (D, 3), Rs (D, 3, 3), Cs (D, 3), cov3s (D, 3, 3),
       mapdb: MapDB (replicated))
      -> (fused_pos (D, 3), fused_cov (D, 3, 3), ok (D,) bool,
          rel_R (D, 3, 3), rel_C (D, 3), scale (D,))
    where drone d's outputs fuse it (dst) with ring predecessor (d-1)%D
    (src) — for D=2, drone 1's row reproduces the reference's
    interPoseEstimator(0, 1).
    """
    dspec = P(DRONE_AXIS)
    rep = P()

    def step(keys, f_leaves, Ks, dists, Rs, Cs, cov3s,
             map_X, map_desc, map_valid):
        mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
        feats = Features(*[l[0] for l in f_leaves])
        out = _inter_exchange_step(
            keys[0], feats, Ks[0], dists[0], Rs[0], Cs[0], cov3s[0],
            mapdb, config,
        )
        return (out.fused_pos[None], out.fused_cov[None], out.ok[None],
                out.rel.R[None], out.rel.C[None], out.scale[None])

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(
            dspec, (dspec,) * 6, dspec, dspec, dspec, dspec, dspec,
            rep, rep, rep,
        ),
        out_specs=(dspec,) * 6,
        check_vma=False,
    )

    @jax.jit
    def run(keys, feats: Features, Ks, dists, Rs, Cs, cov3s, mapdb: MapDB):
        return sharded(
            keys, tuple(feats), Ks, dists, Rs, Cs, cov3s,
            mapdb.X, mapdb.desc, mapdb.valid,
        )

    return run


def collaborative_step(
    mesh: Mesh,
    config: ColocConfig,
    inter: str = "full",
):
    """Build the jitted multi-drone step function over `mesh`.

    Signature of the returned fn:
      (keys (D,2) uint32, images (D,H,W) f32, Ks (D,3,3), dists (D,3),
       fb: FilterBank (D,...), mapdb: MapDB (replicated))
      -> (fb', positions (D,3), covs (D,3,3), fused_pos (D,3),
          fused_cov (D,3,3), inter_ok (D,) bool)

    `inter` selects the inter-drone exchange that replaces ROS topics:
      - "full" (default): the complete interPoseEstimator on the mesh.
        Each drone ppermutes its FEATURE BANK (descriptors + keypoints +
        camera + pose + covariance) to its ring successor, so every
        drone receives its predecessor's frame data and runs pairwise match
        -> relative pose -> temp reconstruction -> scale alignment ->
        pose-only refine -> ICI fusion locally (inter_pose_device). This is
        the descriptor-bank exchange SURVEY §2.2 calls for — the collective
        carries ~64 B/keypoint, exactly what the reference shipped over ROS.
      - "ici": cheap pose+covariance all_gather with ring-neighbor ICI
        fusion only (no relative-pose estimation) — a low-rate fallback for
        bandwidth-constrained meshes.
    """
    dspec = P(DRONE_AXIS)
    rep = P()

    def step(keys, images, Ks, dists, fb_x, fb_P, fb_steps, map_X, map_desc, map_valid):
        mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
        k_loc, k_inter = jax.random.split(keys[0])
        bank, filtered, pwc, feats = _per_drone_step(
            k_loc, images, Ks, dists, fb_x, fb_P, fb_steps, mapdb, config
        )
        pos = filtered.C
        cov = pwc.cov[3:6, 3:6] + 1e-5 * jnp.eye(3)

        n = jax.lax.axis_size(DRONE_AXIS)
        if inter == "full":
            # full interPoseEstimator over the mesh: descriptor-bank
            # exchange + relative pose + temp reconstruction + scale
            # alignment + pose-only refine + ICI (see _inter_exchange_step)
            iout = _inter_exchange_step(
                k_inter, feats, Ks[0], dists[0], filtered.R, pos, cov,
                mapdb, config,
            )
            fused_pos, fused_cov, ok = iout.fused_pos, iout.fused_cov, iout.ok
        elif inter == "ici":
            all_pos = jax.lax.all_gather(pos, DRONE_AXIS)      # (D, 3)
            all_cov = jax.lax.all_gather(cov, DRONE_AXIS)      # (D, 3, 3)
            me = jax.lax.axis_index(DRONE_AXIS)
            # ring PREDECESSOR, matching inter="full"'s partner choice so
            # the cheap fallback approximates the full mode drone-for-drone
            other = (me - 1) % n
            fused = covint.fuse(cov, all_cov[other], pos, all_pos[other])
            fused_pos, fused_cov = fused.pos, fused.cov
            ok = pwc.success
        else:
            raise ValueError(f"unknown inter mode {inter!r}")

        return (
            bank.x, bank.P, bank.steps,
            pos[None], cov[None],
            fused_pos[None], fused_cov[None], ok[None],
        )

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(dspec, dspec, dspec, dspec, dspec, dspec, dspec,
                  rep, rep, rep),
        out_specs=(dspec,) * 8,
        check_vma=False,
    )

    @jax.jit
    def run(keys, images, Ks, dists, fb: kalman.FilterBank, mapdb: MapDB):
        out = sharded(
            keys, images, Ks, dists, fb.x, fb.P, fb.steps,
            mapdb.X, mapdb.desc, mapdb.valid,
        )
        fb2 = kalman.FilterBank(x=out[0], P=out[1], steps=out[2])
        return fb2, out[3], out[4], out[5], out[6], out[7]

    return run


def collaborative_step_scan(mesh: Mesh, config: ColocConfig):
    """Multi-frame multi-drone stepping as ONE mesh program: lax.scan F
    frames through the per-drone intra step (KF bank carried on device),
    then the FULL inter-drone exchange (descriptor ppermute + relative pose
    + scale alignment + ICI, _inter_exchange_step) once at the chunk
    boundary — the cadence session.run_chunked uses, now entirely on the
    mesh. This is BASELINE config 5 (full multi-drone collaborative
    session) as a single compiled collective program per chunk.

    Returns a jitted fn:
      (keys (F, D, 2), images (F, D, H, W), Ks (D, 3, 3), dists (D, 3),
       fb: FilterBank (D, ...), mapdb (replicated))
      -> (fb', positions (F, D, 3), covs (F, D, 3, 3), success (F, D),
          fused_pos (D, 3), fused_cov (D, 3, 3), inter_ok (D,))
    """
    dspec1 = P(None, DRONE_AXIS)   # (F, D, ...) frame-major inputs
    dspec = P(DRONE_AXIS)
    rep = P()

    def step(keys, images, Ks, dists, fb_x, fb_P, fb_steps,
             map_X, map_desc, map_valid):
        from coloc_tpu.types import empty_features

        mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)

        def body(carry, inp):
            # the latest frame's features/pose ride the CARRY (only the
            # final frame feeds the inter exchange) so the scan does not
            # materialize (F, kp, ...) feature banks it never reads
            fb_x, fb_P, fb_steps, _f, _R, _k = carry
            key, img = inp               # (1, 2), (1, H, W) — local shard
            k_loc, k_inter = jax.random.split(key[0])
            bank, filtered, pwc, feats = _per_drone_step(
                k_loc, img, Ks, dists, fb_x, fb_P, fb_steps, mapdb, config
            )
            cov = pwc.cov[3:6, 3:6] + 1e-5 * jnp.eye(3)
            return (
                (bank.x, bank.P, bank.steps, feats, filtered.R, k_inter),
                (filtered.C, cov, pwc.success),
            )

        init = (
            fb_x, fb_P, fb_steps,
            empty_features(config.detector.max_keypoints),
            jnp.eye(3), jnp.zeros((2,), jnp.uint32),
        )
        carry, outs = jax.lax.scan(body, init, (keys, images))
        fbx, fbP, fbs, feats_last, R_last, k_last = carry
        pos_s, cov_s, ok_s = outs

        # inter-drone event on the chunk's final frame
        iout = _inter_exchange_step(
            k_last, feats_last, Ks[0], dists[0],
            R_last, pos_s[-1], cov_s[-1], mapdb, config,
        )
        fused_pos, fused_cov, iok = iout.fused_pos, iout.fused_cov, iout.ok
        return (
            fbx, fbP, fbs,
            pos_s[:, None], cov_s[:, None], ok_s[:, None],
            fused_pos[None], fused_cov[None], iok[None],
        )

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(dspec1, dspec1, dspec, dspec, dspec, dspec, dspec,
                  rep, rep, rep),
        out_specs=(dspec, dspec, dspec, dspec1, dspec1, dspec1,
                   dspec, dspec, dspec),
        check_vma=False,
    )

    @jax.jit
    def run(keys, images, Ks, dists, fb: kalman.FilterBank, mapdb: MapDB):
        out = sharded(
            keys, images, Ks, dists, fb.x, fb.P, fb.steps,
            mapdb.X, mapdb.desc, mapdb.valid,
        )
        fb2 = kalman.FilterBank(x=out[0], P=out[1], steps=out[2])
        return fb2, out[3], out[4], out[5], out[6], out[7], out[8]

    return run


def sharded_map_match(mesh: Mesh, opts, axis: str = DRONE_AXIS,
                      query_axis: str = None):
    """2-NN matching against a MAP-SHARDED descriptor bank.

    SURVEY.md §5 (long-context analog): when the landmark bank outgrows one
    chip, shard it across the mesh. Each device runs the fused Hamming 2-NN
    2-NN over its shard of the bank; the per-shard (best, second, idx)
    triples merge with the same two-smallest logic the kernel uses
    internally, via an all_gather over the map axis — O(devices * queries)
    bytes between devices instead of moving any descriptors.

    `axis`: mesh axis the bank is sharded over. The default reuses the
    1-D drone axis (bank sharded across ALL devices, queries replicated).
    To shard drones AND the map SIMULTANEOUSLY, build a 2-D Mesh (axes
    ("drone", "map")) and pass axis="map", query_axis="drone": each drone
    row holds one query shard, the bank splits over the map columns, and
    the merge collective runs over the map axis only — per-drone results
    come out drone-sharded. Tested on a (2, 4) virtual mesh.

    Returns a jitted fn:
      (q_desc (Q,16) [replicated, or drone-sharded with query_axis],
       q_valid (Q,), shard_desc (L,16) sharded on axis 0, shard_valid (L,))
      -> Matches with GLOBAL landmark indices and CUDAK2NN semantics.

    Shapes need NOT divide the mesh axes: a bank with L % n_devices != 0
    (or, with query_axis, Q % n_query_devices != 0) is zero-padded to the
    next multiple inside the jitted wrapper, with padded entries marked
    invalid — an invalid entry carries an _INVALID_DIST distance in the
    kernel and best > 512 is rejected by matching._accept, so padding can
    never win a match; padded query rows are sliced off the output.
    """
    from coloc_tpu.matching import _accept
    from coloc_tpu.ops import hamming

    def step(q_desc, q_valid, shard_desc, shard_valid):
        idx, best, second = hamming.hamming_2nn(
            q_desc, shard_desc, q_valid, shard_valid
        )
        me = jax.lax.axis_index(axis)
        shard_size = shard_desc.shape[0]
        # globalize within my shard; -1 (no valid row) stays -1
        gidx = jnp.where(idx >= 0, idx + me * shard_size, -1)

        all_best = jax.lax.all_gather(best, axis)      # (D, Q)
        all_second = jax.lax.all_gather(second, axis)  # (D, Q)
        all_idx = jax.lax.all_gather(gidx, axis)       # (D, Q)

        # merge D sorted-pairs: global best = min of bests; global second =
        # min of (all seconds, all non-argmin bests)
        d_best = jnp.argmin(all_best, axis=0)          # (Q,)
        q_ar = jnp.arange(best.shape[0])
        g_best = all_best[d_best, q_ar]
        g_idx = all_idx[d_best, q_ar]
        masked_bests = jnp.where(
            jnp.arange(all_best.shape[0])[:, None] == d_best[None, :],
            jnp.int32(hamming._INVALID_DIST), all_best,
        )
        g_second = jnp.minimum(
            jnp.min(all_second, axis=0), jnp.min(masked_bests, axis=0)
        )
        return g_idx, g_best, g_second

    qspec = P(query_axis) if query_axis else P()
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(qspec, qspec, P(axis), P(axis)),
        out_specs=(qspec, qspec, qspec),
        check_vma=False,
    )

    n_map = mesh.shape[axis]
    n_query = mesh.shape[query_axis] if query_axis else 1

    @jax.jit
    def run(q_desc, q_valid, map_desc, map_valid):
        Q, L = q_desc.shape[0], map_desc.shape[0]
        Lp = -(-L // n_map) * n_map
        if Lp != L:
            map_desc = jnp.pad(map_desc, ((0, Lp - L), (0, 0)))
            map_valid = jnp.pad(map_valid, (0, Lp - L))   # padded -> invalid
        Qp = -(-Q // n_query) * n_query
        if Qp != Q:
            q_desc = jnp.pad(q_desc, ((0, Qp - Q), (0, 0)))
            q_valid = jnp.pad(q_valid, (0, Qp - Q))
        idx, best, second = sharded(q_desc, q_valid, map_desc, map_valid)
        if Qp != Q:
            idx, best, second = idx[:Q], best[:Q], second[:Q]
            q_valid = q_valid[:Q]
        # single source of truth for accept semantics (matching._accept)
        return _accept(idx, best, second, q_valid, opts, opts.margin_threshold)

    return run


def shard_inputs(mesh: Mesh, keys, images, Ks, dists, fb, mapdb):
    """Place inputs: drone-sharded data vs replicated map."""
    dsh = NamedSharding(mesh, P(DRONE_AXIS))
    rsh = NamedSharding(mesh, P())
    put = lambda x, s: jax.device_put(x, s)
    fb = kalman.FilterBank(
        x=put(fb.x, dsh), P=put(fb.P, dsh), steps=put(fb.steps, dsh)
    )
    mapdb = MapDB(
        X=put(mapdb.X, rsh), desc=put(mapdb.desc, rsh),
        valid=put(mapdb.valid, rsh),
    )
    return (
        put(keys, dsh), put(images, dsh), put(Ks, dsh), put(dists, dsh),
        fb, mapdb,
    )
