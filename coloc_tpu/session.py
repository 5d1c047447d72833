"""Collaborative-localization session orchestrator.

Reference parity: coloc.hpp class ColoC —
  mainThread (:96-148): bootstrap the map from the first frame pair
    (initMap :151), then per-frame per-drone intra localization
    (intraPoseEstimator :201) with periodic inter-drone relative pose +
    fusion (interPoseEstimator :274) and map maintenance (updateMap :394).

Execution shape: the host drives EVENTS (bootstrap, per-frame, inter-drone,
map update) while all per-event math runs as the jitted device functions
built in the other modules. Data-dependent *control* (did localization
succeed? is the map degraded?) reads back scalar flags — everything tensor-
shaped stays on device. Failure semantics follow the reference: localization
failure logs identity pose + identity covariance and the KF coasts
(coloc.hpp:246-257).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from coloc_tpu import matching, robust, utils
from coloc_tpu.config import ColocConfig
from coloc_tpu.frontend import detect_and_describe
from coloc_tpu.fusion import covint, kalman
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.geometry import se3, so3
from coloc_tpu.io import loggers
from coloc_tpu.sfm import localize, reconstruct
from coloc_tpu.types import Features, MapDB, Matches, Pose, PoseWithCov


def _intra_all_device_step(cfg: ColocConfig, keys, images, mapdb: MapDB,
                           bank, Ks, dists, fb: "kalman.FilterBank"):
    """Device-side all-drones frame step (pure function shared by the
    per-frame jit and the multi-frame lax.scan chain): batched detect ->
    one resident-bank 2-NN over the concatenated queries -> vmapped
    localization -> vmapped KF bank update.

    keys (D, 2), images (D, H, W). Returns
    (pwcs, fb', filtered, gate_dist, rej, eulers, sup_inc) with leading
    drone axes; sup_inc is the per-landmark inlier-support increment
    (L,) int32 — how many drones used each landmark as a refinement
    inlier this frame (landmark-quality signal for cull_map).
    """
    D = cfg.num_drones
    kp = cfg.detector.max_keypoints
    # batched frontend: all drones' rasters stack vertically so detection +
    # description are ONE kernel per stage for the whole drone axis
    # (frontend._detect_and_describe_trip_batch; no D-fold graph unroll)
    from coloc_tpu.frontend import detect_and_describe_batch

    feats = detect_and_describe_batch(images, cfg.detector)
    # single resident-bank 2-NN call over all drones' queries
    q = feats.desc.reshape(D * kp, -1)
    qv = feats.valid.reshape(-1)
    idx, best, second = matching.hamming.hamming_2nn_bank(q, qv, bank)
    m_flat = matching._accept(
        idx, best, second, qv, cfg.matcher, cfg.matcher.margin_threshold,
    )
    mm = Matches(
        idx=m_flat.idx.reshape(D, kp),
        best=m_flat.best.reshape(D, kp),
        second=m_flat.second.reshape(D, kp),
    )

    def loc_one(key, f, m, K, dist):
        cam = cam_ops.Camera(K=K, dist=dist)
        pwc, inl = localize.localize_image(
            key, f, m, mapdb, cam, cfg.ransac, cfg.refiner
        )
        return pwc, inl

    pwcs, inls = jax.vmap(loc_one)(keys, feats, mm, Ks, dists)

    # landmark support: one count per (drone, landmark) refinement inlier,
    # gated on that drone's localization succeeding. Non-hits scatter to an
    # out-of-range slot and drop; D*kp updates into (L,) is a small
    # scatter.
    hit = inls & mm.mask & pwcs.success[:, None]
    L = mapdb.X.shape[0]
    sup_inc = (
        jnp.zeros(L, jnp.int32)
        .at[jnp.where(hit, mm.idx, L).reshape(-1)]
        .add(1, mode="drop")
    )

    zs = jax.vmap(kalman.fill_measurement)(pwcs.pose)
    fb, filtered, dist_g, rej = kalman.update_all(
        fb, zs, pwcs.cov[:, 3:6, 3:6], pwcs.rmse, pwcs.success, cfg.filter,
    )
    eulers = jax.vmap(so3.rot_to_euler)(pwcs.pose.R)
    return pwcs, fb, filtered, dist_g, rej, eulers, sup_inc


class ColocSession:
    """One collaborative-localization session over N drones (class ColoC)."""

    def __init__(
        self,
        config: ColocConfig,
        Ks: np.ndarray,          # (D, 3, 3)
        dists: np.ndarray,       # (D, 3)
        out_dir: str = "",
        seed: int = 0,
        profile: bool = False,
        viz=None,
        debug_dir: str = "",
    ):
        self.config = config
        self.cams = [
            cam_ops.Camera(K=jnp.asarray(Ks[d]), dist=jnp.asarray(dists[d]))
            for d in range(config.num_drones)
        ]
        self.Ks = jnp.asarray(Ks)
        self.dists = jnp.asarray(dists)
        self.filter_bank = kalman.init(config.num_drones, config.filter)
        self.mapdb: Optional[MapDB] = None
        self.scene: Optional[reconstruct.Scene] = None
        self.map_ready = False
        self.frame = 0
        self.key = jax.random.PRNGKey(seed)
        self.last_pose: Dict[int, PoseWithCov] = {}
        self._pending_logs: list = []   # deferred CSV entries (flush_logs)
        # landmark-support bookkeeping (cull_map): career inlier count and
        # frame of last inlier per MapDB slot; (re)built lazily against the
        # current map capacity by _ensure_support
        self.lm_support = None          # (L,) int32
        self.lm_last_seen = None        # (L,) int32, creation frame if unhit
        # optional live visualization sink (io/liveviz.LiveViz — the
        # rosUtils.hpp pose/map publisher analog); pushes are no-ops when None
        self.viz = viz

        # per-stage tracing (reference: chrono spans printed around every
        # stage, coloc.hpp:113-144; here device-synchronized spans)
        from coloc_tpu.profiling import StageProfiler

        self.profiler = StageProfiler(
            enabled=profile, printer=print if profile else None
        )

        # stage-wired SVG debug artifacts (the reference's #ifdef DEBUG
        # overlays, coloc.hpp:153-159, 171-176, 189-192, 203-209, 232-239,
        # 298-300; drawing impls colocUtils.hpp:148-182). When set, every
        # pipeline stage on the HOST event path emits a feature/match
        # overlay into debug_dir — like the reference's DEBUG build, this
        # costs extra work per frame (a second detection pass for the fused
        # intra step) and is strictly an inspection mode.
        self.debug_dir = debug_dir
        if debug_dir:
            os.makedirs(debug_dir, exist_ok=True)

        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.pose_log = loggers.PoseLogger(os.path.join(out_dir, "poses.txt"))
            self.filtered_log = loggers.PoseLogger(
                os.path.join(out_dir, "poses_filtered.txt")
            )
            self.gate_log = loggers.GateLogger(
                os.path.join(out_dir, "mahalanobis.txt")
            )
        else:
            self.pose_log = self.filtered_log = self.gate_log = None

    # ------------------------------------------------------------------ util
    def _next_key(self) -> jax.Array:
        self.key, sub = jax.random.split(self.key)
        return sub

    # ------------------------------------------------------- debug overlays
    def _debug_features(self, name: str, image, feats: Features,
                        color: str = "green") -> None:
        """drawFeatures-parity overlay (coloc.hpp:153-159 / :203-209)."""
        if not self.debug_dir:
            return
        from coloc_tpu.io import svg

        svg.draw_features(
            os.path.join(self.debug_dir, name), np.asarray(image),
            np.asarray(feats.xy), np.asarray(feats.valid), color=color,
        )

    def _debug_intra(self, drone: int, image) -> None:
        """Per-frame intra overlays: the frame's features and its accepted
        map matches (coloc.hpp:203-209, 232-239). The fused device step
        hides both, so debug mode runs a second detect+match pass purely
        for the artifacts."""
        if not self.debug_dir:
            return
        f_dbg = self.detect(image)
        self._debug_features(
            f"frame{self.frame:04d}_d{drone}_features.svg", image, f_dbg
        )
        mm_dbg = matching.match_with_map(
            f_dbg, self.mapdb, self.config.matcher
        )
        self._debug_features(
            f"frame{self.frame:04d}_d{drone}_map_matches.svg", image,
            f_dbg._replace(valid=mm_dbg.mask), color="red",
        )

    def _debug_matches(self, name: str, img1, img2, xy1, xy2, idx, mask,
                       color: str = "yellow") -> None:
        """drawMatches-parity overlay (coloc.hpp:171-176 / :189-192 /
        :232-239 / :298-300)."""
        if not self.debug_dir:
            return
        from coloc_tpu.io import svg

        svg.draw_matches(
            os.path.join(self.debug_dir, name), np.asarray(img1),
            np.asarray(img2), np.asarray(xy1), np.asarray(xy2),
            np.asarray(idx), np.asarray(mask), color=color,
        )

    def detect(self, image: np.ndarray) -> Features:
        return detect_and_describe(jnp.asarray(image), self.config.detector)

    def _relative_pose(self, key, uv1, uv2, mask, cam1, cam2):
        model = self.config.model
        if model == "E":
            return robust.relative_pose_essential(
                key, uv1, uv2, mask, cam1, cam2, self.config.ransac
            )
        if model == "F":
            return robust.relative_pose_fundamental(
                key, uv1, uv2, mask, cam1, cam2, self.config.ransac
            )
        if model == "H":
            return robust.relative_pose_homography(
                key, uv1, uv2, mask, cam1, cam2, self.config.ransac
            )
        raise ValueError(f"unknown geometric model {model!r}")

    # -------------------------------------------------------------- init map
    def init_map(self, images: Dict[int, np.ndarray]) -> bool:
        """Bootstrap the shared map from one frame of every drone
        (ColoC::initMap, coloc.hpp:151-199). Two drones use the two-view
        bootstrap; more drones run the full incremental reconstruction
        (seed pair + P3P resection, reconstructScene parity)."""
        cfg = self.config
        feats = {d: self.detect(images[d]) for d in range(cfg.num_drones)}
        for d in range(cfg.num_drones):
            self._debug_features(f"init_features_d{d}.svg", images[d],
                                 feats[d])

        if cfg.num_drones > 2:
            pair_matches, pair_geo = {}, {}
            for (a, b) in utils.exhaustive_pairs(cfg.num_drones):
                m = matching.match_pair(feats[a], feats[b], cfg.matcher)
                geo = self._relative_pose(
                    self._next_key(), feats[a].xy, feats[b].xy[m.idx],
                    m.mask, self.cams[a], self.cams[b],
                )
                if self.debug_dir:
                    self._debug_matches(
                        f"init_putative_{a}_{b}.svg", images[a], images[b],
                        feats[a].xy, feats[b].xy, m.idx, m.mask,
                    )
                    self._debug_matches(
                        f"init_inlier_{a}_{b}.svg", images[a], images[b],
                        feats[a].xy, feats[b].xy, m.idx,
                        np.asarray(m.mask) & np.asarray(geo.inliers),
                        color="lime",
                    )
                if bool(geo.success):
                    pair_matches[(a, b)] = m
                    pair_geo[(a, b)] = geo
            if not pair_geo:
                return False
            scene, ba_res = reconstruct.reconstruct_scene(
                self._next_key(), [feats[d] for d in range(cfg.num_drones)],
                pair_matches, pair_geo, self.cams, self.Ks, self.dists,
                cfg.scale, cfg.max_landmarks, cfg.refiner, cfg.ransac,
            )
            if int(jnp.sum(scene.X_valid)) < 8:
                return False
            self.scene = scene
            self.mapdb = reconstruct.scene_to_mapdb(scene)
            self.map_ready = True
            # wholesale (re)build: every slot is a fresh landmark
            self.lm_support = None
            self.lm_last_seen = None
            if self.viz is not None:
                self.viz.publish_map(np.asarray(self.mapdb.X),
                                     np.asarray(self.mapdb.valid))
            if self.out_dir:
                loggers.write_ply(
                    os.path.join(self.out_dir, "map.ply"),
                    np.asarray(scene.X), np.asarray(scene.X_valid),
                    np.asarray(scene.Cs),
                )
            return True

        f0, f1 = feats[0], feats[1]
        m = matching.match_pair(f0, f1, cfg.matcher)
        geo = self._relative_pose(
            self._next_key(), f0.xy, f1.xy[m.idx], m.mask,
            self.cams[0], self.cams[1],
        )
        if self.debug_dir:
            self._debug_matches(
                "init_putative_0_1.svg", images[0], images[1],
                f0.xy, f1.xy, m.idx, m.mask,
            )
            self._debug_matches(
                "init_inlier_0_1.svg", images[0], images[1],
                f0.xy, f1.xy, m.idx,
                np.asarray(m.mask) & np.asarray(geo.inliers), color="lime",
            )
        if not bool(geo.success):
            return False

        scene = reconstruct.two_view_scene(
            f0, f1, m, geo.inliers, geo.R, geo.t,
            Pose(R=jnp.eye(3), C=jnp.zeros(3)), cfg.scale,
            self.cams[0], self.cams[1], num_landmarks=cfg.max_landmarks,
        )
        scene, ba_res = reconstruct.refine_scene(
            scene, self.Ks[:2], self.dists[:2], cfg.refiner,
            fix_pose=jnp.asarray([True, False]),
        )
        if int(jnp.sum(scene.X_valid)) < 8:
            return False
        self.scene = scene
        self.mapdb = reconstruct.scene_to_mapdb(scene)  # setupMapDatabase
        self.map_ready = True
        # wholesale (re)build: every slot is a fresh landmark
        self.lm_support = None
        self.lm_last_seen = None
        if self.viz is not None:
            self.viz.publish_map(np.asarray(self.mapdb.X),
                                 np.asarray(self.mapdb.valid))
        if self.out_dir:
            loggers.write_ply(
                os.path.join(self.out_dir, "map.ply"),
                np.asarray(scene.X), np.asarray(scene.X_valid),
                np.asarray(scene.Cs),
            )
        return True

    # ------------------------------------------------------------ intra pose
    def _fused_intra(self):
        """One jitted frame step: detect -> map match -> localize -> KF.

        A single dispatch instead of four — the host only reads back the
        final scalars/pose (SURVEY §7.4.6: ~1 device round-trip per frame).
        Built lazily per (config, camera) and cached on the session.
        """
        if getattr(self, "_fused_intra_fn", None) is not None:
            return self._fused_intra_fn

        cfg = self.config
        import functools

        @functools.partial(jax.jit, static_argnames=("drone",))
        def step(key, image, map_X, map_desc, map_valid, bank_st, bank_pen,
                 fb_x, fb_P, fb_steps, lm_sup, lm_last, frame, drone: int):
            mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
            feats = detect_and_describe(image, cfg.detector)
            # resident unpacked bank (setMapData parity) — skips the per-call
            # unpack of the full landmark bank
            bank = (bank_st, bank_pen, map_X.shape[0])
            mm = matching.match_with_map(feats, mapdb, cfg.matcher, bank=bank)
            pwc, inl = localize.localize_image(
                key, feats, mm, mapdb, self.cams[drone], cfg.ransac,
                cfg.refiner,
            )
            # landmark-support bookkeeping (see _intra_all_device_step)
            hit = inl & mm.mask & pwc.success
            L = map_X.shape[0]
            sup_inc = (
                jnp.zeros(L, jnp.int32)
                .at[jnp.where(hit, mm.idx, L)]
                .add(1, mode="drop")
            )
            lm_sup2 = lm_sup + sup_inc
            lm_last2 = jnp.where(sup_inc > 0, frame, lm_last)
            bank = kalman.FilterBank(x=fb_x, P=fb_P, steps=fb_steps)
            z = kalman.fill_measurement(pwc.pose)
            bank, filtered, dist, rej = kalman.update(
                bank, jnp.int32(drone), z, pwc.cov[3:6, 3:6], pwc.rmse,
                pwc.success, cfg.filter,
            )
            euler = so3.rot_to_euler(pwc.pose.R)
            return pwc, bank, filtered, dist, rej, euler, lm_sup2, lm_last2

        self._fused_intra_fn = step
        return step

    def _map_bank(self):
        """Resident unpacked map bank, rebuilt when the map changes."""
        if getattr(self, "_map_bank_src", None) is not self.mapdb:
            self._map_bank_cached = matching.pack_map_bank(self.mapdb)
            self._map_bank_src = self.mapdb
        return self._map_bank_cached

    def _ensure_support(self):
        """(Re)build the landmark-support arrays when absent or when the map
        was rebuilt at a different capacity. Valid slots start with zero
        support and `lm_last_seen = current frame` (a creation timestamp, so
        cull_map's staleness window doubles as a new-landmark grace period);
        free slots carry -1."""
        L = self.mapdb.X.shape[0]
        if self.lm_support is None or self.lm_support.shape[0] != L:
            self.lm_support = jnp.zeros(L, jnp.int32)
            self.lm_last_seen = jnp.where(
                self.mapdb.valid, jnp.int32(self.frame), jnp.int32(-1)
            )

    def _fused_intra_all(self):
        """One jitted frame step for ALL drones: batched detect -> one 2-NN
        kernel call over the concatenated queries -> vmapped localization ->
        vmapped KF bank update. The reference loops drones sequentially on
        the host (coloc.hpp:128-148); batching the drone axis into a single
        dispatch halves (at D=2) the per-frame dispatch count and lets the
        per-drone work share the device."""
        if getattr(self, "_fused_intra_all_fn", None) is not None:
            return self._fused_intra_all_fn

        cfg = self.config

        @jax.jit
        def step(keys, images, map_X, map_desc, map_valid, bank_st, bank_pen,
                 Ks, dists, fb_x, fb_P, fb_steps, lm_sup, lm_last, frame):
            mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
            bank = (bank_st, bank_pen, map_X.shape[0])
            fb = kalman.FilterBank(x=fb_x, P=fb_P, steps=fb_steps)
            out = _intra_all_device_step(
                cfg, keys, images, mapdb, bank, Ks, dists, fb
            )
            sup_inc = out[6]
            # fold the support bookkeeping into the same dispatch (a second
            # tiny launch per frame would cost a full dispatch round trip)
            lm_sup2 = lm_sup + sup_inc
            lm_last2 = jnp.where(sup_inc > 0, frame, lm_last)
            return out[:6] + (lm_sup2, lm_last2)

        self._fused_intra_all_fn = step
        return step

    def _fused_intra_scan(self):
        """Multi-frame DEVICE-RESIDENT stepping: lax.scan F frames through
        the all-drones step with the KF bank as carry (frames pre-staged on
        device). One dispatch per F-frame chunk instead of per frame — the
        host-driven per-frame loop pays the full dispatch round-trip each
        frame; the reference's mainThread is likewise a per-frame host loop
        (coloc.hpp:96-148)."""
        if getattr(self, "_fused_intra_scan_fn", None) is not None:
            return self._fused_intra_scan_fn

        cfg = self.config

        @jax.jit
        def chain(keys, images, map_X, map_desc, map_valid, bank_st,
                  bank_pen, Ks, dists, fb_x, fb_P, fb_steps,
                  lm_sup, lm_last, frame0):
            mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
            bank = (bank_st, bank_pen, map_X.shape[0])

            def body(carry, inp):
                fb_x, fb_P, fb_steps, sup, last, frame = carry
                fb = kalman.FilterBank(fb_x, fb_P, fb_steps)
                k, imgs = inp
                pwcs, fb2, filtered, dist_g, rej, eulers, sup_inc = (
                    _intra_all_device_step(
                        cfg, k, imgs, mapdb, bank, Ks, dists, fb
                    )
                )
                return (
                    (fb2.x, fb2.P, fb2.steps, sup + sup_inc,
                     jnp.where(sup_inc > 0, frame, last), frame + 1),
                    (pwcs, fb2.P, filtered, dist_g, eulers),
                )

            carry, outs = jax.lax.scan(
                body, (fb_x, fb_P, fb_steps, lm_sup, lm_last, frame0),
                (keys, images),
            )
            return carry, outs

        self._fused_intra_scan_fn = chain
        return chain

    def intra_pose_chunk(self, images) -> Dict[int, list]:
        """Process an (F, D, H, W) chunk of frames in ONE device dispatch
        (lax.scan over the fused all-drones step, KF bank carried on
        device). Returns dict drone -> [PoseWithCov per frame]. Logging is
        deferred exactly like intra_pose_all; self.frame advances by F."""
        cfg = self.config
        D = cfg.num_drones
        images = jnp.asarray(images)
        F = images.shape[0]
        bank_st, bank_pen, _ = self._map_bank()
        keys = jax.random.split(self._next_key(), F * D).reshape(F, D, -1)
        self._ensure_support()
        with self.profiler.stage("intra_chunk"):
            carry, outs = self._fused_intra_scan()(
                keys, images,
                self.mapdb.X, self.mapdb.desc, self.mapdb.valid,
                bank_st, bank_pen, self.Ks, self.dists,
                self.filter_bank.x, self.filter_bank.P,
                self.filter_bank.steps,
                self.lm_support, self.lm_last_seen, jnp.int32(self.frame),
            )
        self.filter_bank = kalman.FilterBank(*carry[:3])
        self.lm_support, self.lm_last_seen = carry[3], carry[4]
        pwcs_s, fbP_s, filtered_s, dist_s, eulers_s = outs
        if self.pose_log or self.filtered_log or self.gate_log:
            for f in range(F):
                self._pending_logs.append((
                    self.frame + f,
                    jax.tree_util.tree_map(lambda a: a[f], pwcs_s),
                    fbP_s[f],
                    jax.tree_util.tree_map(lambda a: a[f], filtered_s),
                    dist_s[f], eulers_s[f],
                ))
        out = {d: [] for d in range(D)}
        for f in range(F):
            for d in range(D):
                filt_d = Pose(R=filtered_s.R[f, d], C=filtered_s.C[f, d])
                result = PoseWithCov(
                    pose=filt_d, cov=pwcs_s.cov[f, d], rmse=pwcs_s.rmse[f, d],
                    n_tracks=pwcs_s.n_tracks[f, d],
                    success=pwcs_s.success[f, d],
                )
                out[d].append(result)
                if f == F - 1:
                    self.last_pose[d] = result
                if self.viz is not None:
                    # replay every chunk frame to the live viewer so it
                    # matches intra_pose_all's per-frame publishing (the
                    # conversions force a host sync — viz is interactive
                    # tooling, not the steady-state perf path)
                    Pd = np.asarray(fbP_s[f, d])
                    self.viz.publish_pose(
                        d, np.asarray(filt_d.C), cov3=Pd[:3, :3],
                        success=bool(result.success),
                        frame=self.frame + f,
                    )
        self.frame += F
        return out

    def intra_pose_all(self, images) -> Dict[int, PoseWithCov]:
        """Per-frame localization for every drone in one dispatch.

        `images`: dict drone -> (H, W) array. Returns dict drone ->
        PoseWithCov (filtered pose, covariance, rmse, success). Logging and
        viz match intra_pose's per-drone behavior, EXCEPT that CSV entries
        are queued (see below) — callers driving intra_pose_all directly
        (outside run(), which flushes for you) must call flush_logs() or
        close() before reading the log files."""
        cfg = self.config
        D = cfg.num_drones
        if self.debug_dir:
            for d in range(D):
                self._debug_intra(d, images[d])
        bank_st, bank_pen, _ = self._map_bank()
        keys = jax.random.split(self._next_key(), D)
        imgs = jnp.stack([jnp.asarray(images[d]) for d in range(D)])
        self._ensure_support()
        with self.profiler.stage("intra_step_all"):
            (pwcs, fb, filtered, dist_g, rej, eulers, lm_sup,
             lm_last) = self._fused_intra_all()(
                keys, imgs,
                self.mapdb.X, self.mapdb.desc, self.mapdb.valid,
                bank_st, bank_pen, self.Ks, self.dists,
                self.filter_bank.x, self.filter_bank.P,
                self.filter_bank.steps,
                self.lm_support, self.lm_last_seen, jnp.int32(self.frame),
            )
        self.filter_bank = fb
        self.lm_support, self.lm_last_seen = lm_sup, lm_last
        # DEFERRED logging: pose/gate CSV conversion forces a host<->device
        # sync; queueing the device outputs and flushing in bulk keeps the
        # steady-state frame loop free of per-frame syncs so consecutive
        # frames pipeline (run() flushes at the end; flush_logs() any time)
        if self.pose_log or self.filtered_log or self.gate_log:
            self._pending_logs.append(
                (self.frame, pwcs, fb.P, filtered, dist_g, eulers)
            )
        out = {}
        for d in range(D):
            filt_d = Pose(R=filtered.R[d], C=filtered.C[d])
            result = PoseWithCov(
                pose=filt_d, cov=pwcs.cov[d], rmse=pwcs.rmse[d],
                n_tracks=pwcs.n_tracks[d], success=pwcs.success[d],
            )
            self.last_pose[d] = result
            if self.viz is not None:
                Pd = np.asarray(fb.P[d])
                self.viz.publish_pose(
                    d, np.asarray(filt_d.C), cov3=Pd[:3, :3],
                    success=bool(pwcs.success[d]), frame=self.frame,
                )
            out[d] = result
        return out

    def close(self):
        """Flush any queued log entries. Safe to call repeatedly; sessions
        used as context managers flush on exit."""
        self.flush_logs()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def flush_logs(self):
        """Write queued per-frame log entries (see intra_pose_all)."""
        pending, self._pending_logs = self._pending_logs, []
        for frame, pwcs, fbP, filtered, dist_g, eulers in pending:
            D = self.config.num_drones
            for d in range(D):
                if self.pose_log:
                    self.pose_log.log(
                        frame, d, d, np.asarray(pwcs.pose.C[d]),
                        np.asarray(pwcs.cov[d]), np.asarray(eulers[d]),
                        float(pwcs.rmse[d]), int(pwcs.n_tracks[d]),
                    )
                if self.gate_log:
                    self.gate_log.log(d, float(dist_g[d]))
                if self.filtered_log:
                    P = np.asarray(fbP[d])
                    cov6 = np.zeros((6, 6))
                    cov6[:3, :3] = P[3:6, 3:6]
                    cov6[3:6, 3:6] = P[:3, :3]
                    filt_d = Pose(R=filtered.R[d], C=filtered.C[d])
                    self.filtered_log.log(
                        frame, d, d, np.asarray(filt_d.C), cov6,
                        np.asarray(so3.rot_to_euler(filt_d.R)),
                        float(pwcs.rmse[d]), int(pwcs.n_tracks[d]),
                    )

    def intra_pose(self, drone: int, image: np.ndarray) -> PoseWithCov:
        """Per-frame map-based localization + KF (intraPoseEstimator,
        coloc.hpp:201-271). Single fused device dispatch."""
        cfg = self.config
        self._debug_intra(drone, image)
        bank_st, bank_pen, _ = self._map_bank()
        self._ensure_support()
        with self.profiler.stage("intra_step"):
            (pwc, bank, filtered, dist, rej, euler, lm_sup,
             lm_last) = self._fused_intra()(
                self._next_key(), jnp.asarray(image),
                self.mapdb.X, self.mapdb.desc, self.mapdb.valid,
                bank_st, bank_pen,
                self.filter_bank.x, self.filter_bank.P,
                self.filter_bank.steps,
                self.lm_support, self.lm_last_seen, jnp.int32(self.frame),
                drone=drone,
            )
        self.filter_bank = bank
        self.lm_support, self.lm_last_seen = lm_sup, lm_last
        if self.pose_log:
            self.pose_log.log(
                self.frame, drone, drone, np.asarray(pwc.pose.C),
                np.asarray(pwc.cov), np.asarray(euler),
                float(pwc.rmse), int(pwc.n_tracks),
            )
        if self.gate_log:
            self.gate_log.log(drone, float(dist))
        if self.filtered_log:
            P = np.asarray(self.filter_bank.P[drone])
            cov6 = np.zeros((6, 6))
            cov6[:3, :3] = P[3:6, 3:6]
            cov6[3:6, 3:6] = P[:3, :3]
            self.filtered_log.log(
                self.frame, drone, drone, np.asarray(filtered.C), cov6,
                np.asarray(so3.rot_to_euler(filtered.R)),
                float(pwc.rmse), int(pwc.n_tracks),
            )
        result = PoseWithCov(
            pose=filtered, cov=pwc.cov, rmse=pwc.rmse,
            n_tracks=pwc.n_tracks, success=pwc.success,
        )
        self.last_pose[drone] = result
        if self.viz is not None:
            P = np.asarray(self.filter_bank.P[drone])
            self.viz.publish_pose(
                drone, np.asarray(filtered.C), cov3=P[:3, :3],
                success=bool(pwc.success), frame=self.frame,
            )
        return result

    # ------------------------------------------------------------ inter pose
    def inter_pose_round(
        self, images: Dict[int, np.ndarray], policy: str = "auto"
    ) -> Dict[int, Optional[covint.FusionResult]]:
        """One inter-drone fusion round over all drones (pair policy).

        The reference hardcodes interPoseEstimator(0, 1) for its 2-drone demo
        (coloc.hpp:141); this generalizes the schedule:
          - policy="auto": D==2 -> the reference's single (0, 1) fusion;
            D>2 -> "ring".
          - policy="ring": every drone d is fused with partner (d-1) mod D —
            each drone is a fusion destination exactly once per round.
          - policy="best": every drone is fused with the OTHER drone whose
            current intra position covariance has the smallest trace (the
            best-informed partner), skipping itself.
        Features are detected once per drone and shared across the round's
        pairs. Returns {dst: FusionResult-or-None}.
        """
        cfg = self.config
        D = cfg.num_drones
        if D < 2:
            return {}
        if policy == "auto":
            policy = "reference" if D == 2 else "ring"
        feats = {d: self.detect(images[d]) for d in range(D)}
        if policy == "reference":
            pairs = [(0, 1)]
        elif policy == "ring":
            pairs = [((d - 1) % D, d) for d in range(D)]
        elif policy == "best":
            traces = {
                d: float(jnp.trace(self.last_pose[d].cov[3:6, 3:6]))
                if d in self.last_pose else float("inf")
                for d in range(D)
            }
            pairs = []
            for dst in range(D):
                src = min(
                    (d for d in range(D) if d != dst),
                    key=lambda d: traces[d],
                )
                pairs.append((src, dst))
        else:
            raise ValueError(f"unknown inter-pose policy {policy!r}")
        out: Dict[int, Optional[covint.FusionResult]] = {}
        for src, dst in pairs:
            out[dst] = self.inter_pose(src, dst, images, feats=feats)
        return out

    def inter_pose(
        self, src: int, dst: int, images: Dict[int, np.ndarray],
        feats: Optional[Dict[int, Features]] = None,
        key: Optional[jax.Array] = None,
    ) -> Optional[covint.FusionResult]:
        """Inter-drone relative localization + ICI fusion
        (interPoseEstimator, coloc.hpp:274-392). `feats`: optional detected-
        feature cache (inter_pose_round shares one detection per drone
        across the round's pairs). `key`: optional explicit RANSAC key (the
        mesh-parity tests drive host and sharded paths with one key).

        The compute is the SHARED masked device core
        (parallel.mesh.inter_pose_device — the same function the sharded
        exchange runs), so the host and mesh paths cannot diverge; this
        wrapper adds the host concerns: early returns, guided-residual
        logging, CSV rows."""
        cfg = self.config
        if src not in self.last_pose or dst not in self.last_pose:
            return None
        feats = feats or {}
        f_src = feats[src] if src in feats else self.detect(images[src])
        f_dst = feats[dst] if dst in feats else self.detect(images[dst])
        if self.debug_dir:
            # inter-drone pairwise matches (coloc.hpp:298-300); the fused
            # core hides the putative stage, so recompute it for the overlay
            m_dbg = matching.match_pair(f_src, f_dst, cfg.matcher)
            self._debug_matches(
                f"inter{self.frame:04d}_s{src}_d{dst}_putative.svg",
                images[src], images[dst], f_src.xy, f_dst.xy,
                m_dbg.idx, m_dbg.mask,
            )

        from coloc_tpu.parallel.mesh import inter_pose_device

        pose_src = self.last_pose[src]
        pose_dst = self.last_pose[dst]
        out = inter_pose_device(
            key if key is not None else self._next_key(),
            f_dst, f_src, self.cams[src], self.cams[dst],
            jnp.stack([self.Ks[src], self.Ks[dst]]),
            jnp.stack([self.dists[src], self.dists[dst]]),
            pose_src.pose, pose_src.cov[3:6, 3:6],
            pose_dst.pose.C, pose_dst.cov[3:6, 3:6],
            self.mapdb, cfg,
        )
        if not bool(out.ok):
            return None
        if self.debug_dir:
            # guided map-to-map matches: each matched landmark's observation
            # in the temp scene's two views (RobustMatcher::matchMaps
            # parity, the matches the reference logs to guidedmatches2.txt)
            d = out.diag
            self._debug_matches(
                f"inter{self.frame:04d}_s{src}_d{dst}_guided.svg",
                images[src], images[dst], d.obs_src, d.obs_dst,
                np.arange(np.asarray(d.obs_dst).shape[0]), d.guided_mask,
                color="lime",
            )

        # epipolar-guided residual diagnostics under the known relative pose
        # (RobustMatcher::matchMaps parity, guidedmatches2.txt log). The F
        # matrix is built from the robust src->dst motion, so the
        # geometrically consistent pixel pair for each matched landmark is
        # its observation in the TEMP scene's two views.
        if self.out_dir:
            d = out.diag
            res = utils.guided_match_residuals(
                self.cams[src].K, self.cams[dst].K, d.geo_R, d.geo_t,
                d.obs_src, d.obs_dst, d.guided_mask,
            )
            res_np = np.asarray(res)
            with open(
                os.path.join(self.out_dir, "guidedmatches2.txt"), "a"
            ) as fh:
                for r in res_np[np.asarray(d.guided_mask)]:
                    fh.write(f"{float(r)}\n")

        fused = covint.FusionResult(
            cov=out.fused_cov, pos=out.fused_pos,
            omega=out.diag.omega, trace=out.diag.trace,
        )
        if self.filtered_log:
            self.filtered_log.log(
                self.frame, dst, src, np.asarray(fused.pos),
                np.asarray(
                    jnp.zeros((6, 6)).at[3:6, 3:6].set(fused.cov)
                ),
                np.asarray(so3.rot_to_euler(pose_dst.pose.R)),
                float(out.diag.rmse), int(out.diag.n_inliers),
            )
        return fused

    # ------------------------------------------------------------ map update
    def update_map(self, images: Dict[int, np.ndarray]) -> bool:
        """Rebuild the map from the current frames and re-align scale
        (ColoC::updateMap, coloc.hpp:394-459)."""
        old_db = self.mapdb
        ok = self.init_map(images)
        if not ok or old_db is None:
            return ok
        mm = matching.match_maps(self.mapdb, old_db, self.config.matcher)
        n_common = int(jnp.sum(mm.mask & self.mapdb.valid))
        if n_common >= 2:
            # scale of NEW map relative to OLD -> divide to match old scale
            scale = utils.compute_scale_difference(self.mapdb, old_db, mm)
            inv = 1.0 / jnp.maximum(scale, 1e-6)
            X, Cs = utils.rescale_map(self.scene.X, self.scene.Cs, inv)
            self.scene = self.scene._replace(X=X, Cs=Cs)
            self.mapdb = reconstruct.scene_to_mapdb(self.scene)
        if self.viz is not None:
            self.viz.publish_map(np.asarray(self.mapdb.X),
                                 np.asarray(self.mapdb.valid))
        return True

    def extend_map(self, images: Dict[int, np.ndarray],
                   novelty_min_dist: int = 64) -> int:
        """Incremental map GROWTH: triangulate NEW landmarks from the current
        frames into free MapDB slots.

        Beyond-reference capability: the reference's only map maintenance is
        updateMap's wholesale rebuild (coloc.hpp:394-459), which throws away
        every landmark; its in-algorithm precedent for *adding* gated new
        points to an existing map is resectionCamera's new-landmark
        triangulation (Reconstructor.hpp:354-412), which we apply to the live
        session map here:

          1. detect features per drone, match against the resident map bank,
             P3P-localize each drone (poses in the current map's world frame)
          2. candidates = valid features that did NOT match the map AND whose
             best map Hamming distance exceeds `novelty_min_dist` (the margin
             test alone under-reports novelty when two map descriptors are
             mutually similar — the distance floor blocks duplicates)
          3. per localized drone pair: margin-match the candidates, enforce
             one-landmark-per-train-feature injectivity, DLT-triangulate with
             the absolute poses under the resection gates (ray angle >= 2 deg,
             positive depth, |Z| < 1000, reprojection < 4 px in both views,
             Reconstructor.hpp:380-391)
          4. write survivors into FREE map slots (first-observation descriptor
             convention, colocData.hpp:111-119), up to capacity

        Returns the number of landmarks added. The bootstrap Scene keeps its
        original slots — extended landmarks exist only in the MapDB, and a
        later update_map() rebuild replaces them like everything else.
        """
        cfg = self.config
        if not self.map_ready or self.mapdb is None:
            return 0
        valid_np = np.array(self.mapdb.valid)
        free = np.flatnonzero(~valid_np)
        if free.size == 0:
            return 0
        bank = self._map_bank()
        D = cfg.num_drones

        feats: Dict[int, Features] = {}
        poses: Dict[int, Pose] = {}
        loc_ok: Dict[int, bool] = {}
        cand: Dict[int, np.ndarray] = {}
        for d in range(D):
            f = self.detect(images[d])
            mm = matching.match_with_map(f, self.mapdb, cfg.matcher, bank=bank)
            pwc, _ = localize.localize_image(
                self._next_key(), f, mm, self.mapdb, self.cams[d],
                cfg.ransac, cfg.refiner,
            )
            feats[d], poses[d] = f, pwc.pose
            loc_ok[d] = bool(pwc.success)
            cand[d] = (
                np.asarray(f.valid)
                & ~np.asarray(mm.mask)
                & (np.asarray(mm.best) > novelty_min_dist)
            )

        X_np = np.array(self.mapdb.X)
        desc_np = np.array(self.mapdb.desc)
        added = 0

        for (a, b) in utils.exhaustive_pairs(D):
            if added >= free.size or not (loc_ok[a] and loc_ok[b]):
                continue
            if not cand[a].any() or not cand[b].any():
                continue
            fa = feats[a]._replace(valid=jnp.asarray(cand[a]))
            fb = feats[b]._replace(valid=jnp.asarray(cand[b]))
            m = matching.match_pair(fa, fb, cfg.matcher)
            idx = np.asarray(m.idx)
            safe = np.clip(idx, 0, feats[b].capacity - 1)
            ok = (idx >= 0) & cand[a] & cand[b][safe]
            # injectivity: one new landmark per train feature (lowest query)
            seen: set = set()
            for q in np.flatnonzero(ok):
                t = int(idx[q])
                if t in seen:
                    ok[q] = False
                else:
                    seen.add(t)
            if not ok.any():
                continue

            Xn, okn = reconstruct._triangulate_pair(
                poses[a].R, poses[a].C, poses[b].R, poses[b].C,
                self.cams[a], self.cams[b],
                feats[a].xy, feats[b].xy[jnp.asarray(safe)],
                jnp.asarray(ok),
                reconstruct._MAX_Z_RESECTION,
                reconstruct._MIN_RAY_ANGLE_DEG, 16.0,
            )
            okn = np.asarray(okn)
            take = np.flatnonzero(okn)[: free.size - added]
            if take.size == 0:
                continue
            slots = free[added : added + take.size]
            X_np[slots] = np.asarray(Xn)[take]
            desc_np[slots] = np.asarray(feats[a].desc)[take]
            valid_np[slots] = True
            # consume the features so later pairs can't re-add the same point
            cand[a][take] = False
            cand[b][idx[take]] = False
            added += take.size

        if added:
            self.mapdb = MapDB(
                X=jnp.asarray(X_np), desc=jnp.asarray(desc_np),
                valid=jnp.asarray(valid_np),
            )
            self._stamp_new_slots(free[:added])
            if self.viz is not None:
                self.viz.publish_map(X_np, valid_np)
        return added

    def merge_map_from(self, other: MapDB, novelty_min_dist: int = 64,
                       min_matches: int = 12) -> int:
        """Merge ANOTHER session's map into this one (multi-session map
        fusion). Beyond-reference capability: the reference aligns two maps
        only transiently inside interPoseEstimator (matchMaps +
        computeScaleDifference + rescaleMap, coloc.hpp:334-370) and discards
        the alignment after fusing poses; here the alignment persists as map
        content:

          1. map-to-map 2-NN descriptor match (matchMapFeatures parity)
          2. Sim(3) alignment of `other` into this map's frame from the
             matched 3D-3D landmark pairs (utils.align_maps — full
             similarity, since independent sessions share neither scale nor
             orientation)
          3. matched landmarks are duplicates (this map's copy wins,
             first-observation convention); `other`'s unmatched landmarks
             whose best Hamming distance to this map exceeds
             `novelty_min_dist` are transformed into this frame and written
             to free slots, up to capacity

        Returns the number of landmarks added (0 when the maps share fewer
        than `min_matches` landmarks — no reliable alignment exists)."""
        cfg = self.config
        if not self.map_ready or self.mapdb is None:
            return 0
        aln = utils.align_maps(self.mapdb, other, cfg.matcher, min_matches)
        if aln is None:
            return 0
        s, R, t, _, matched_b = aln
        valid_np = np.array(self.mapdb.valid)
        free = np.flatnonzero(~valid_np)
        if free.size == 0:
            return 0
        # novelty gate from other's side: unmatched in the reverse direction
        # AND far from every resident descriptor (same floor as extend_map)
        mrev = matching.match_maps(other, self.mapdb, cfg.matcher)
        novel = (
            np.asarray(other.valid)
            & ~matched_b
            & ~np.asarray(mrev.mask)
            & (np.asarray(mrev.best) > novelty_min_dist)
        )
        take = np.flatnonzero(novel)[: free.size]
        if take.size == 0:
            return 0
        Xb = np.asarray(other.X)[take]
        Xt = ((s * (R @ Xb.T)).T + t).astype(np.float32)
        X_np = np.array(self.mapdb.X)
        desc_np = np.array(self.mapdb.desc)
        slots = free[: take.size]
        X_np[slots] = Xt
        desc_np[slots] = np.asarray(other.desc)[take]
        valid_np[slots] = True
        self.mapdb = MapDB(
            X=jnp.asarray(X_np), desc=jnp.asarray(desc_np),
            valid=jnp.asarray(valid_np),
        )
        self._stamp_new_slots(slots)
        if self.viz is not None:
            self.viz.publish_map(X_np, valid_np)
        return int(take.size)

    def _stamp_new_slots(self, slots) -> None:
        """Reset the support bookkeeping for freshly written MapDB slots:
        zero career support, creation timestamp = current frame (grace
        window against cull_map)."""
        if len(slots) == 0:
            return
        self._ensure_support()
        slots = jnp.asarray(np.asarray(slots, np.int32))
        self.lm_support = self.lm_support.at[slots].set(0)
        self.lm_last_seen = self.lm_last_seen.at[slots].set(
            jnp.int32(self.frame)
        )

    def cull_map(self, max_age: int = 64, min_support: int = 8,
                 keep_min: int = 32) -> int:
        """Retire landmarks that stopped earning localization inliers,
        freeing their MapDB slots for extend_map / merge_map_from.

        Beyond-reference capability, completing the map lifecycle (grow:
        extend_map; fuse: merge_map_from; retire: here). The reference's only
        retirement is updateMap's wholesale rebuild (coloc.hpp:394-459),
        which discards well-proven landmarks along with the dead ones.

        Every localization step already accumulates, on device and inside
        the same dispatch, each landmark's career inlier count
        (`lm_support`) and last-inlier frame (`lm_last_seen`, initialized to
        the creation frame). A landmark is culled when BOTH hold:

          - stale:   `frame - lm_last_seen > max_age` (new landmarks get a
                     `max_age`-frame grace window via the creation stamp)
          - unproven: `lm_support < min_support` — landmarks with a long
                     inlier career survive temporary occlusion droughts

        If culling would leave fewer than `keep_min` valid landmarks, the
        strongest candidates (highest support, then most recent) are
        retained. Returns the number of slots freed. Host-side map
        maintenance, like extend_map — not on the per-frame hot path.
        """
        if not self.map_ready or self.mapdb is None:
            return 0
        self._ensure_support()
        valid = np.array(self.mapdb.valid)
        sup = np.asarray(self.lm_support)
        last = np.asarray(self.lm_last_seen)
        cull = valid & (self.frame - last > max_age) & (sup < min_support)
        n_valid = int(valid.sum())
        n_cull = int(cull.sum())
        if n_cull == 0:
            return 0
        if n_valid - n_cull < keep_min:
            # spare the strongest candidates to hold the keep_min floor
            spare = min(keep_min - (n_valid - n_cull), n_cull)
            cand = np.flatnonzero(cull)
            order = np.lexsort((-last[cand], -sup[cand]))  # strongest first
            cull[cand[order[:spare]]] = False
            n_cull -= spare
            if n_cull == 0:
                return 0
        valid &= ~cull
        self.mapdb = self.mapdb._replace(valid=jnp.asarray(valid))
        freed = jnp.asarray(np.flatnonzero(cull).astype(np.int32))
        self.lm_support = self.lm_support.at[freed].set(0)
        self.lm_last_seen = self.lm_last_seen.at[freed].set(-1)
        if self.viz is not None:
            self.viz.publish_map(np.asarray(self.mapdb.X), valid)
        return n_cull

    # ------------------------------------------------------------- main loop
    def run(
        self,
        frames: Dict[int, list],       # drone -> list of images
        inter_every: int = 10,
        update_map_every: int = 0,
        auto_update_map: bool = False,
        auto_update_patience: int = 3,
        extend_map_every: int = 0,
        cull_map_every: int = 0,
        cull_max_age: int = 64,
        cull_min_support: int = 8,
    ) -> Dict[int, list]:
        """mainThread parity (coloc.hpp:96-148). Returns per-drone pose lists.

        `auto_update_map` (opt-in; the reference never auto-triggers
        updateMap): rebuild the map from the current frames after
        `auto_update_patience` CONSECUTIVE frames where every drone failed to
        localize — map-degradation recovery in the spirit of updateMap
        (coloc.hpp:394-459) without discarding a good map on one bad frame
        (the KF coasts through transients).

        `extend_map_every` (opt-in; beyond-reference): every N frames grow
        the map with newly triangulated landmarks (extend_map) instead of
        replacing it wholesale — free MapDB capacity fills as drones see new
        parts of the scene.

        `cull_map_every` (opt-in; beyond-reference): every N frames retire
        landmarks with no recent inlier support (cull_map with
        `cull_max_age`/`cull_min_support`), so a capacity-full map keeps
        turning over slots for extend_map instead of freezing."""
        cfg = self.config
        num_frames = min(len(v) for v in frames.values())
        out = {d: [] for d in range(cfg.num_drones)}

        f = 0
        while not self.map_ready and f < num_frames:
            self.init_map({d: frames[d][f] for d in range(cfg.num_drones)})
            f += 1
        if not self.map_ready:
            return out

        consecutive_failures = 0
        # finally-flush: a crash mid-run must not lose the <=64 queued frames
        # of deferred CSV entries (the reference wrote synchronously)
        try:
            for frame_idx in range(f, num_frames):
                self.frame = frame_idx
                res_all = self.intra_pose_all(
                    {d: frames[d][frame_idx] for d in range(cfg.num_drones)}
                )
                results = [res_all[d] for d in range(cfg.num_drones)]
                for d in range(cfg.num_drones):
                    out[d].append(res_all[d])
                if inter_every and frame_idx % inter_every == 0 and cfg.num_drones >= 2:
                    self.inter_pose_round(
                        {d: frames[d][frame_idx] for d in range(cfg.num_drones)}
                    )
                trigger = update_map_every and frame_idx % update_map_every == 0
                if auto_update_map:
                    # note: reading success forces a host sync — only done when
                    # the auto-recovery feature is enabled
                    if not any(bool(r.success) for r in results):
                        consecutive_failures += 1
                    else:
                        consecutive_failures = 0
                    if consecutive_failures >= auto_update_patience:
                        trigger = True
                        consecutive_failures = 0
                if trigger:
                    self.update_map(
                        {d: frames[d][frame_idx] for d in range(cfg.num_drones)}
                    )
                elif (extend_map_every
                      and frame_idx % extend_map_every == 0
                      and cfg.num_drones >= 2):
                    self.extend_map(
                        {d: frames[d][frame_idx] for d in range(cfg.num_drones)}
                    )
                if cull_map_every and frame_idx % cull_map_every == 0:
                    self.cull_map(max_age=cull_max_age,
                                  min_support=cull_min_support)
                # periodic flush bounds queued device pytrees without breaking
                # steady-state pipelining (64 frames of pose/cov tuples ~ KBs)
                if len(self._pending_logs) >= 64:
                    self.flush_logs()
        finally:
            self.flush_logs()
        return out

    def run_chunked(
        self,
        frames: Dict[int, list],
        chunk: int = 16,
        inter_every: int = 0,
        update_map_every: int = 0,
        auto_update_map: bool = False,
        auto_update_patience: int = 3,
    ) -> Dict[int, list]:
        """mainThread with DEVICE-RESIDENT stepping: frames are staged in
        (chunk, D, H, W) blocks and each block runs as one lax.scan dispatch
        (intra_pose_chunk). Inter-drone fusion rounds and map maintenance
        run at chunk boundaries — `inter_every`/`update_map_every` are
        rounded UP to a whole number of chunks (a documented deviation from
        run()'s exact per-frame schedule; the reference's cadences are soft
        rates, coloc.hpp:141). `auto_update_map` counts chunks in which NO
        drone localized on any frame, and rebuilds the map after
        `auto_update_patience` consecutive dead chunks (updateMap recovery,
        coloc.hpp:394-459; reading the success flags forces one host sync
        per chunk, only when enabled). The last partial chunk falls back to
        per-frame stepping so no frame is dropped."""
        cfg = self.config
        D = cfg.num_drones
        num_frames = min(len(v) for v in frames.values())
        out = {d: [] for d in range(D)}

        f = 0
        while not self.map_ready and f < num_frames:
            self.init_map({d: frames[d][f] for d in range(D)})
            f += 1
        if not self.map_ready:
            return out

        inter_chunks = max(1, -(-inter_every // chunk)) if inter_every else 0
        update_chunks = (
            max(1, -(-update_map_every // chunk)) if update_map_every else 0
        )
        dead_chunks = 0
        chunks_done = 0
        try:
            while f < num_frames:
                n = min(chunk, num_frames - f)
                if n == chunk:
                    block = np.stack(
                        [[np.asarray(frames[d][f + i]) for d in range(D)]
                         for i in range(n)]
                    )
                    self.frame = f
                    res = self.intra_pose_chunk(block)
                else:
                    res = {d: [] for d in range(D)}
                    for i in range(n):
                        self.frame = f + i
                        r = self.intra_pose_all(
                            {d: frames[d][f + i] for d in range(D)}
                        )
                        for d in range(D):
                            res[d].append(r[d])
                for d in range(D):
                    out[d].extend(res[d])
                f += n
                chunks_done += 1
                if inter_chunks and chunks_done % inter_chunks == 0 and D >= 2:
                    # log fusion rows against the frame actually fused
                    # (intra_pose_chunk advanced self.frame to f == one
                    # past the chunk's last frame)
                    self.frame = f - 1
                    self.inter_pose_round(
                        {d: frames[d][f - 1] for d in range(D)}
                    )
                    self.frame = f
                trigger = (
                    update_chunks and chunks_done % update_chunks == 0
                )
                if auto_update_map:
                    chunk_ok = any(
                        bool(p.success)
                        for d in range(D) for p in res[d]
                    )
                    dead_chunks = 0 if chunk_ok else dead_chunks + 1
                    if dead_chunks >= auto_update_patience:
                        trigger = True
                        dead_chunks = 0
                if trigger:
                    self.update_map(
                        {d: frames[d][f - 1] for d in range(D)}
                    )
                if len(self._pending_logs) >= 64:
                    self.flush_logs()
        finally:
            self.flush_logs()
        return out
