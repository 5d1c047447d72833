"""Peer-to-peer collaborative localization: one robot per process.

The reference simulates its robot fleet inside ONE process (a sequential
drone loop, coloc.hpp:128-148) and leaves multi-process deployment to ROS
topics it never exercises. This module is that deployment: each robot runs
a `DronePeer` in its own process (its own host/device), localizing against a
shared map locally, and the collaborative step happens OVER THE WIRE —
peers publish their feature bundles (keypoints + packed descriptors +
camera + filtered pose + covariance, io/transport.encode_feature_bundle)
on the TCP topic bus, and a receiving peer runs the full
interPoseEstimator (pairwise match -> relative pose -> temp two-view
reconstruction -> scale alignment -> pose-only refine -> covariance
intersection) against the freshest bundle it pulled.

The compute core is parallel.mesh.inter_pose_device — the SAME function
the in-process session path (session.inter_pose) and the on-mesh sharded
exchange (mesh._inter_exchange_step) run, so all three deployment shapes
(one process, one mesh, N processes on a bus) cannot diverge
semantically. What moves on the wire is exactly what the reference's
ROS design shipped between robots: ~84 B/keypoint of descriptors plus a
few hundred bytes of pose state (SURVEY §2.2).

Typical peer process::

    node = transport.Node(broker_port)
    peer = DronePeer(drone_id, config, K, dist, mapdb, node,
                     peers=[other_id, ...])
    for image in frames:
        pwc = peer.step(image)            # intra localization + pose publish
        peer.publish_bundle()             # share features for the others
        fused = peer.inter_fuse(other_id) # collaborative fusion (event)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from coloc_tpu.config import ColocConfig
from coloc_tpu.fusion import covint
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.io import transport
from coloc_tpu.session import ColocSession
from coloc_tpu.types import Features, MapDB, Pose, PoseWithCov


class DronePeer:
    """One robot's half of a multi-process collaborative session.

    Wraps a single-drone `ColocSession` (local intra localization + Kalman
    filtering against a shared map, typically loaded from
    checkpoint.load_mapdb) and speaks the topic-bus protocol:

      - publishes `coloc/drone{id}/pose` after every step (ROSUtils parity)
      - publishes `coloc/drone{id}/features` on demand (the inter-drone
        exchange payload)
      - subscribes to its peers' feature topics and runs the inter-drone
        relative localization + ICI fusion locally when asked

    `mapdb` must be the SAME map in every peer (same landmark slots — the
    map is the shared world frame, exactly like the reference's shared
    map database after initMap).
    """

    def __init__(
        self,
        drone: int,
        config: ColocConfig,
        K: np.ndarray,
        dist: np.ndarray,
        mapdb: MapDB,
        node: Optional[transport.Node] = None,
        peers: Sequence[int] = (),
        out_dir: str = "",
        seed: Optional[int] = None,
        bundle_depth: int = 2,
        bundle_max_age: Optional[float] = 60.0,
    ):
        self.drone = int(drone)
        self.config = config
        self.node = node
        # staleness bound on consumed feature bundles (seconds of wall
        # clock, sender-stamped at encode time): a bundle that sat in a
        # queue — or predates a broker restart — past this window describes
        # a pose the sender has long since moved away from, so fusing it
        # would inject a phantom relative constraint. None disables the
        # gate. The 60 s default rides out a peer's first-launch jit warmup
        # (run_peer's re-offer loop keeps republishing FRESH bundles, so
        # live peers are never gated — only bundles whose sender stopped
        # offering). Peers are assumed roughly NTP-synced (same assumption
        # ROS header stamps make).
        self.bundle_max_age = bundle_max_age
        # local session: one drone, the shared map injected (no bootstrap)
        cfg1 = dataclasses.replace(config, num_drones=1)
        self.session = ColocSession(
            cfg1, np.asarray(K, np.float32)[None],
            np.asarray(dist, np.float32)[None],
            out_dir=out_dir,
            seed=self.drone if seed is None else seed,
        )
        self.session.mapdb = mapdb
        self.session.map_ready = True
        self.K = np.asarray(K, np.float64)
        self.dist = np.asarray(dist, np.float64)
        self._last_image: Optional[np.ndarray] = None
        self._last_feats: Optional[Features] = None
        self._feats_frame = -1
        self.frame = 0
        self._inter_fn = None
        self._bundle_depth = bundle_depth
        for p in peers:
            self.subscribe_peer(p)

    # ------------------------------------------------------------ local step
    def step(self, image: np.ndarray, publish: bool = True) -> PoseWithCov:
        """One frame: intra localization + KF locally, pose on the bus."""
        pwc = self.session.intra_pose(0, image)
        self._last_image = image
        self.frame += 1
        self.session.frame = self.frame
        if publish and self.node is not None:
            try:
                self.node.publish(
                    transport.pose_topic(self.drone),
                    transport.encode_pose(
                        self.drone, self.frame - 1, time.time(),
                        np.asarray(pwc.pose.C),
                        rpy=None, cov3=np.asarray(pwc.cov[3:6, 3:6]),
                        success=bool(pwc.success),
                    ),
                )
            except OSError:
                # pose telemetry is advisory: a bus outage must not stop
                # LOCAL localization (reconnect-enabled nodes redial on the
                # next publish/receive)
                pass
        return pwc

    # ----------------------------------------------------------- feature bus
    def _current_feats(self) -> Features:
        """Features of the latest stepped frame (detected once, cached)."""
        if self._last_image is None:
            raise RuntimeError("step() an image before exchanging features")
        if self._feats_frame != self.frame:
            self._last_feats = self.session.detect(self._last_image)
            self._feats_frame = self.frame
        return self._last_feats

    def publish_bundle(self) -> None:
        """Ship this peer's inter-drone exchange payload: latest frame's
        feature bank + camera + current filtered pose + position cov."""
        if self.node is None:
            raise RuntimeError("offline peer (node=None) cannot publish")
        feats = self._current_feats()
        last = self.session.last_pose.get(0)
        if last is None:
            raise RuntimeError("no localized pose yet — step() first")
        payload = transport.encode_feature_bundle(
            self.drone, self.frame - 1, time.time(),
            np.asarray(feats.xy), np.asarray(feats.score),
            np.asarray(feats.scale), np.asarray(feats.angle),
            np.asarray(feats.desc), np.asarray(feats.valid),
            self.K, self.dist,
            np.asarray(last.pose.R), np.asarray(last.pose.C),
            np.asarray(last.cov[3:6, 3:6]),
        )
        self.node.publish(transport.features_topic(self.drone), payload)

    def subscribe_peer(self, drone: int) -> None:
        if self.node is not None:
            self.node.subscribe(transport.features_topic(int(drone)),
                                depth=self._bundle_depth)

    def receive_bundle(self, src: int, timeout: float = 2.0,
                       freshest: bool = True) -> Optional[dict]:
        """Pull a peer's feature bundle off the bus (None on timeout).
        `freshest=True` drains the queue and keeps the newest bundle."""
        if self.node is None:
            return None
        topic = transport.features_topic(int(src))
        try:
            payload = self.node.receive(topic, timeout=timeout,
                                        max_bytes=64 << 20)
        except (transport.TransportClosed, TimeoutError):
            return None
        if payload is None:
            return None
        if freshest:
            while True:
                try:
                    nxt = self.node.receive(topic, timeout=0.0,
                                            max_bytes=64 << 20)
                except (transport.TransportClosed, TimeoutError):
                    break
                if nxt is None:
                    break
                payload = nxt
        return transport.decode_feature_bundle(payload)

    # --------------------------------------------------------- collaborative
    def _inter(self):
        """Jitted interPoseEstimator core (shared with session/mesh paths)."""
        if self._inter_fn is None:
            from coloc_tpu.parallel.mesh import inter_pose_device

            cfg = self.config

            @jax.jit
            def run(key, f_dst: Features, f_src: Features, K_src, dist_src,
                    K_dst, dist_dst, src_R, src_C, src_cov3, dst_pos,
                    dst_cov3, map_X, map_desc, map_valid):
                return inter_pose_device(
                    key, f_dst, f_src,
                    cam_ops.Camera(K=K_src, dist=dist_src),
                    cam_ops.Camera(K=K_dst, dist=dist_dst),
                    jnp.stack([K_src, K_dst]),
                    jnp.stack([dist_src, dist_dst]),
                    Pose(R=src_R, C=src_C), src_cov3,
                    dst_pos, dst_cov3,
                    MapDB(X=map_X, desc=map_desc, valid=map_valid), cfg,
                )

            self._inter_fn = run
        return self._inter_fn

    def inter_fuse(
        self, src: int, timeout: float = 2.0,
        bundle: Optional[dict] = None, publish: bool = True,
        key: Optional[jax.Array] = None,
        max_age: Optional[float] = None,
    ) -> Optional[covint.FusionResult]:
        """interPoseEstimator(src, me) over the wire: pull drone `src`'s
        freshest feature bundle off the bus and fuse it with my intra
        estimate (coloc.hpp:274-392, peer-to-peer deployment shape).

        Returns None when no bundle arrives in `timeout`, the bundle is
        older than the staleness window (`max_age`, defaulting to the
        peer's `bundle_max_age`), the peer's keypoint capacity differs
        from mine, or the relative-pose/common-landmark gates fail (the
        reference's early-return semantics)."""
        if bundle is None:
            bundle = self.receive_bundle(src, timeout=timeout)
        if bundle is None:
            return None
        # staleness gate: timestamp 0.0 means "unstamped" (synthetic /
        # replayed bundles) and is exempt; publish_bundle always stamps
        window = self.bundle_max_age if max_age is None else max_age
        if window is not None and bundle.get("timestamp"):
            age = time.time() - float(bundle["timestamp"])
            if age > window:
                return None  # stale: sender has moved on since stamping
        last = self.session.last_pose.get(0)
        if last is None:
            return None
        f_dst = self._current_feats()
        if bundle["xy"].shape[0] != f_dst.xy.shape[0]:
            return None  # capacity mismatch — peers must share a config
        f_src = Features(
            xy=jnp.asarray(bundle["xy"]),
            score=jnp.asarray(bundle["score"]),
            scale=jnp.asarray(bundle["scale"]),
            angle=jnp.asarray(bundle["angle"]),
            desc=jnp.asarray(bundle["desc"]),
            valid=jnp.asarray(bundle["valid"]),
        )
        out = self._inter()(
            key if key is not None else self.session._next_key(),
            f_dst, f_src,
            jnp.asarray(bundle["K"], jnp.float32),
            jnp.asarray(bundle["dist"], jnp.float32),
            jnp.asarray(self.K, jnp.float32),
            jnp.asarray(self.dist, jnp.float32),
            jnp.asarray(bundle["R"], jnp.float32),
            jnp.asarray(bundle["C"], jnp.float32),
            jnp.asarray(bundle["cov3"], jnp.float32),
            last.pose.C, last.cov[3:6, 3:6],
            self.session.mapdb.X, self.session.mapdb.desc,
            self.session.mapdb.valid,
        )
        if not bool(out.ok):
            return None
        fused = covint.FusionResult(
            cov=out.fused_cov, pos=out.fused_pos,
            omega=out.diag.omega, trace=out.diag.trace,
        )
        if publish and self.node is not None:
            try:
                self.node.publish(
                    transport.pose_topic(self.drone),
                    transport.encode_pose(
                        self.drone, self.frame - 1, time.time(),
                        np.asarray(fused.pos), cov3=np.asarray(fused.cov),
                        success=True,
                    ),
                )
            except OSError:
                # the FUSION is the product; the pose topic is telemetry —
                # a bus outage here must not discard a computed result
                pass
        return fused

    # ---------------------------------------------------------------- admin
    def close(self):
        self.session.close()


def run_peer(
    drone: int,
    config: ColocConfig,
    K: np.ndarray,
    dist: np.ndarray,
    mapdb: MapDB,
    broker_port: int,
    frames: Sequence[np.ndarray],
    peers: Sequence[int],
    inter_every: int = 0,
    host: str = "127.0.0.1",
    bundle_every: int = 1,
    inter_timeout: float = 10.0,
) -> Dict[str, list]:
    """Convenience driver for one peer process: step every frame, publish a
    bundle every `bundle_every` frames, and run inter_fuse against each
    peer every `inter_every` frames (0 = never). Returns per-frame results
    for the caller to assert on / log.

    The fusion phase is a RE-OFFER loop: until every peer fused (or
    `inter_timeout` elapses), this peer republishes its own bundle and
    retries each pending peer with a short receive timeout. Peers can join
    the bus minutes apart (slow start, staggered deployment, one host
    hogging a small machine) — a bundle published before a late peer's
    subscription reached the broker is gone, so one-shot publish+wait
    deadlocks exactly when fleets are least synchronized. Re-offering makes
    the exchange eventually consistent as long as the peers' fusion windows
    overlap."""
    results = {"pose": [], "success": [], "fused": []}
    # reconnect=True: a broker restart mid-run redials + resubscribes
    # transparently; the re-offer loop below then repopulates the lost
    # bundle queues, so fleets ride out a broker bounce
    with transport.Node(broker_port, host=host, reconnect=True) as node:
        peer = DronePeer(drone, config, K, dist, mapdb, node, peers=peers)

        def offer():
            # a broker outage longer than the node's reconnect window makes
            # publish raise; localization is LOCAL and must keep going — the
            # next offer retries (and the node redials) once the broker is
            # back
            try:
                peer.publish_bundle()
                return True
            except OSError:
                return False

        for f, image in enumerate(frames):
            pwc = peer.step(image)
            results["pose"].append(np.asarray(pwc.pose.C))
            results["success"].append(bool(pwc.success))
            if bundle_every and f % bundle_every == 0:
                offer()
            if inter_every and (f + 1) % inter_every == 0:
                deadline = time.monotonic() + inter_timeout
                pending = set(int(s) for s in peers)
                while pending:
                    offer()  # re-offer for late subscribers
                    for src in sorted(pending):
                        fused = peer.inter_fuse(src, timeout=2.0)
                        if fused is not None:
                            results["fused"].append(
                                (f, src, np.asarray(fused.pos),
                                 np.asarray(fused.cov)))
                            pending.discard(src)
                    if time.monotonic() >= deadline:
                        break
        peer.close()
    return results


def main(argv=None) -> int:
    """One robot's peer process over the reference disk dataset layout::

        # terminal 1 (also starts the broker)
        python -m coloc_tpu.distributed --drone 0 --peers 1 \\
            --map map.npz --calib calib.txt --folder data/ --broker 7777
        # terminal 2 (any machine that reaches the broker)
        python -m coloc_tpu.distributed --drone 1 --peers 0 \\
            --map map.npz --calib calib.txt --folder data/ \\
            --broker HOST:7777

    Maps come from `checkpoint.save_mapdb` (e.g. a bootstrap session or
    `cli.py --out`'s checkpoint).

    One JAX process per card is the rule: a JAX process reserves three
    quarters of a GPU's memory when it first uses it. Peers on separate
    cards pick theirs with CUDA_VISIBLE_DEVICES=<index>; peers that share
    one card each need an explicit XLA_PYTHON_CLIENT_MEM_FRACTION share,
    the shares summing to at most 0.9."""
    import argparse

    from coloc_tpu import checkpoint
    from coloc_tpu.config import DetectorOptions
    from coloc_tpu.io import disk

    ap = argparse.ArgumentParser(
        description="Peer-to-peer collaborative localization: one drone "
                    "per process over the TCP topic bus")
    ap.add_argument("--drone", type=int, required=True)
    ap.add_argument("--peers", type=int, nargs="+", required=True)
    ap.add_argument("--map", required=True, help="map .npz (save_mapdb)")
    ap.add_argument("--calib", required=True)
    ap.add_argument("--folder", required=True,
                    help="dataset folder (img__Quad{d}_{frame:04d}.png)")
    ap.add_argument("--broker", required=True,
                    help="PORT to start a broker here, or HOST:PORT to join")
    ap.add_argument("--frames", type=int, default=0, help="0 = all on disk")
    ap.add_argument("--maxkp", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--fast-threshold", type=int, default=12)
    ap.add_argument("--inter-every", type=int, default=4)
    ap.add_argument("--bundle-every", type=int, default=1)
    args = ap.parse_args(argv)

    from coloc_tpu import compile_cache

    compile_cache.enable()   # GPU only; a relaunch reuses compiled graphs
    n_drones = max([args.drone] + args.peers) + 1
    (w, h), Ks, dists = disk.read_calib(args.calib, n_drones)
    config = ColocConfig(
        num_drones=n_drones,
        detector=DetectorOptions(width=w, height=h,
                                 max_keypoints=args.maxkp,
                                 num_levels=args.levels,
                                 fast_threshold=args.fast_threshold),
    )
    mapdb = checkpoint.load_mapdb(args.map)
    n = args.frames or disk.num_frames(args.folder, args.drone)
    frames = [disk.load_frame(args.folder, args.drone, f) for f in range(n)]

    broker = None
    if ":" in args.broker:
        host, port = args.broker.rsplit(":", 1)
        port = int(port)
    else:
        broker = transport.Broker(int(args.broker))
        host, port = "127.0.0.1", broker.port
        print(f"broker listening on {port}")
    try:
        res = run_peer(
            args.drone, config, Ks[args.drone], dists[args.drone], mapdb,
            port, frames, peers=args.peers, inter_every=args.inter_every,
            host=host, bundle_every=args.bundle_every,
        )
    finally:
        if broker is not None:
            broker.close()
    ok = sum(res["success"])
    print(f"drone {args.drone}: localized {ok}/{len(frames)} frames, "
          f"{len(res['fused'])} inter-drone fusions")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
