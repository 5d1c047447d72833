"""Batched multi-stream serving: localize B independent camera streams
against one resident map in a single device dispatch.

Beyond-reference capability: the reference serves exactly two drones from
ROS callbacks, one frame at a time (coloc_node.cpp:59, coloc.hpp:96-148) —
its unit of work is one frame on one GPU stream. A single match+localize
op leaves the device underfilled: the P3P RANSAC + pose-only refinement
stages run tiny per-hypothesis matrices, and one frame's worth of queries
fills few of the 2-NN kernel's tiles. Batching B streams shares ONE 2-NN
Hamming pass over the B*K concatenated query descriptors against the
device-resident bank, then vmaps P3P RANSAC + refinement across streams.
Its rate on the GPU is not measured yet.

Two entry layers:

- `make_serve_step(config, cam)` — the pure, jittable step function
  (key, feats_b, mapdb, bank) -> (PoseWithCov[B], inliers[B,K],
  Matches[B,K]). This is what bench.py chains and what power users embed
  in their own jit graphs (e.g. a lax.scan serving loop).
- `ServingEngine` — the stateful wrapper: packs the map bank once,
  compiles the step (and optionally the batched frontend) once, and
  serves `localize_features` / `localize_frames` calls; `set_map`
  swaps the resident map without recompiling.

Per-stream intrinsics are supported by passing a batched Camera pytree
(K: (B,3,3), dist: (B,3)); a single Camera is broadcast to all streams.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import matching
from .config import ColocConfig
from .frontend import detect_and_describe_batch
from .geometry import camera as cam_ops
from .matching import pack_map_bank
from .ops import hamming
from .sfm import localize
from .types import Features, MapDB, Matches, PoseWithCov


def _cam_axes(cam: cam_ops.Camera):
    """vmap in_axes spec for a Camera: 0 for batched leaves, None shared."""
    if cam.K.ndim == 3:
        return cam_ops.Camera(K=0, dist=0)
    return None


def make_serve_step(config: ColocConfig, cam: cam_ops.Camera):
    """Build the pure batched serving step for a fixed option set.

    Returns step(key, feats_b, mapdb, bank) ->
      (PoseWithCov with (B,...) leaves, inliers (B, K) bool, Matches with
       (B, K) leaves — idx into mapdb landmark slots, -1 where rejected).

    `feats_b` is a Features pytree with leading batch axis (B, K, ...) —
    the shape detect_and_describe_batch returns. `bank` must be
    pack_map_bank(mapdb) for the SAME mapdb. The function is jit-safe and
    shape-stable: recompiles only when B or K changes.
    """
    matcher, ransac, refiner = config.matcher, config.ransac, config.refiner
    axes = _cam_axes(cam)

    def step(key, feats_b: Features, mapdb: MapDB, bank):
        B, kp = feats_b.xy.shape[:2]
        # one 2-NN pass over all streams' queries against the resident bank
        q = feats_b.desc.reshape(B * kp, -1)
        qv = feats_b.valid.reshape(B * kp)
        idx, best, second = hamming.hamming_2nn_bank(q, qv, bank)
        m = matching._accept(idx, best, second, qv, matcher,
                             matcher.margin_threshold)
        mm = Matches(idx=m.idx.reshape(B, kp), best=m.best.reshape(B, kp),
                     second=m.second.reshape(B, kp))

        def loc_one(k, f, m_row, c):
            return localize.localize_image(k, f, m_row, mapdb, c,
                                           ransac, refiner)

        keys = jax.random.split(key, B)
        pwc, inl = jax.vmap(loc_one, in_axes=(0, 0, 0, axes))(
            keys, feats_b, mm, cam)
        return pwc, inl, mm

    return step


def make_sharded_serve_step(mesh, config: ColocConfig, axis: str = None):
    """Scale-out serving over a device mesh: B streams shard across `axis`
    (B = n_devices * b_local), the resident map bank is replicated, and
    there are ZERO collectives — serving is embarrassingly parallel, so N
    chips serve N*b streams at the single-chip batched rate. The win over
    N independent processes is one host dispatch, one compiled program,
    and one map update point (re-pack the bank, device_put replicated).

    Per-stream cameras are REQUIRED here (K: (B,3,3), dist: (B,3)) so each
    shard carries its own streams' intrinsics; broadcast a shared camera
    with jnp.broadcast_to if all streams match.

    Returns a jitted fn:
      (key, feats_b: Features (B, K, ...) sharded on the leading axis,
       cams: Camera (B,...), mapdb: MapDB (replicated),
       bank_st, bank_penr: pack_map_bank(mapdb)[:2] (replicated))
      -> (PoseWithCov (B,...), inliers (B, K), Matches (B, K)),
    all sharded over `axis` on the leading stream dimension. The per-shard
    RNG is key folded with the device's axis index.
    """
    from jax.sharding import PartitionSpec as P

    axis = axis if axis is not None else mesh.axis_names[0]
    dspec, rep = P(axis), P()

    def local(key, f_leaves, camK, camdist, map_X, map_desc, map_valid,
              st, penr):
        feats_b = Features(*f_leaves)
        cam = cam_ops.Camera(K=camK, dist=camdist)   # (b_local, ...)
        serve = make_serve_step(config, cam)
        mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
        bank = (st, penr, map_X.shape[0])
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        return serve(key, feats_b, mapdb, bank)

    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(rep, (dspec,) * 6, dspec, dspec, rep, rep, rep, rep, rep),
        out_specs=(dspec, dspec, dspec),
        check_vma=False,
    )

    @jax.jit
    def run(key, feats_b: Features, cams: cam_ops.Camera, mapdb: MapDB,
            bank_st, bank_penr):
        return sharded(key, tuple(feats_b), cams.K, cams.dist,
                       mapdb.X, mapdb.desc, mapdb.valid, bank_st, bank_penr)

    return run


class ServingEngine:
    """Stateful batched-serving front: resident map bank + compiled step.

    >>> eng = ServingEngine(mapdb, cam, config)
    >>> poses, inliers, matches = eng.localize_frames(images, key)  # (B,H,W)

    The map bank is packed once at construction (setMapData parity,
    GPUMatcher.hpp:110-117) and lives in HBM across calls; `set_map`
    replaces it (e.g. after a session's update_map/extend_map) without
    recompiling the step. Compilation is cached per (B, K) shape by jit.
    """

    def __init__(self, mapdb: MapDB, cam: cam_ops.Camera,
                 config: Optional[ColocConfig] = None):
        self.config = config if config is not None else ColocConfig()
        self.cam = cam
        self.mapdb = mapdb
        self.bank = pack_map_bank(mapdb)
        serve = make_serve_step(self.config, cam)
        det = self.config.detector

        # The packed bank's third element is the PYTHON-int true bank size
        # (used for static slicing inside the matcher) — it must not become
        # a traced jit argument. Pass the two arrays and rebuild the size
        # from mapdb.X's static shape, exactly like session._intra_all's
        # device step does (session.py:256-263).
        def step(key, feats_b, map_X, map_desc, map_valid, st, penr):
            mapdb = MapDB(X=map_X, desc=map_desc, valid=map_valid)
            bank = (st, penr, map_X.shape[0])
            return serve(key, feats_b, mapdb, bank)

        self._step = jax.jit(step)

        # full-pipeline step: batched frontend fused into the same dispatch
        def full(key, images, map_X, map_desc, map_valid, st, penr):
            feats_b = detect_and_describe_batch(images, det)
            return step(key, feats_b, map_X, map_desc, map_valid, st, penr)

        self._full = jax.jit(full)

    def set_map(self, mapdb: MapDB) -> None:
        """Swap the resident map (no recompile — mapdb/bank are traced)."""
        self.mapdb = mapdb
        self.bank = pack_map_bank(mapdb)

    def localize_features(
        self, feats_b: Features, key: jax.Array
    ) -> Tuple[PoseWithCov, jnp.ndarray, Matches]:
        """Match+localize pre-extracted features for B streams.

        feats_b: Features pytree with (B, K, ...) leaves."""
        return self._step(key, feats_b, self.mapdb.X, self.mapdb.desc,
                          self.mapdb.valid, self.bank[0], self.bank[1])

    def localize_frames(
        self, images: jnp.ndarray, key: jax.Array
    ) -> Tuple[PoseWithCov, jnp.ndarray, Matches]:
        """Full pipeline for B raw frames (B, H, W): batched
        detect+describe (one kernel per stage for all streams,
        frontend.detect_and_describe_batch) + match+localize, all in one
        device dispatch."""
        return self._full(key, images, self.mapdb.X, self.mapdb.desc,
                          self.mapdb.valid, self.bank[0], self.bank[1])
