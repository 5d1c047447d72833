"""Production serving runner: ServingEngine fed by the native TCP topic bus.

    python -m coloc_tpu.serve --map map.npz --calib calib.txt \
        --streams 8 --publish 7777            # start a broker here
    python -m coloc_tpu.serve --map map.npz --calib calib.txt \
        --streams 8 --publish host:7777       # join a remote broker

Deployment shape with no reference equivalent (the reference runs one
coloc_node per 2-drone session, coloc_node.cpp:59): one device serves B
robot streams against a shared resident map. Robots publish mono8 frames
on ``coloc/drone{i}/image`` (transport.encode_image); each dispatch
batches the freshest frame per stream through ServingEngine (one 2-NN
pass + vmapped P3P/refine) and publishes every fresh stream's pose on
``coloc/drone{i}/pose`` (transport.encode_pose, ROSUtils message parity).

The batch shape is static: streams with no new frame since the last
dispatch keep their previous frame in the batch, but their pose is not
re-published — a stale stream costs compute, never a wrong output. Maps
come from checkpoint.save_mapdb / session checkpoints and can be hot-
swapped (ServingEngine.set_map) without recompiling.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import ColocConfig, DetectorOptions
from .geometry import camera as cam_ops
from .geometry import so3
from .io import transport
from .serving import ServingEngine
from .types import MapDB


class ServeRunner:
    """Poll image topics -> batched dispatch -> publish poses.

    `node` must be a connected transport.Node; the runner subscribes to
    the B image topics itself (depth 4, drop-oldest: a slow dispatch
    never backs up the bus)."""

    def __init__(self, mapdb: MapDB, config: ColocConfig, Ks: np.ndarray,
                 dists: np.ndarray, node: transport.Node, streams: int,
                 seed: int = 0):
        det = config.detector
        self.config = config
        self.node = node
        self.B = streams
        cams = cam_ops.Camera(
            K=jnp.asarray(np.broadcast_to(np.asarray(Ks, np.float32),
                                          (streams, 3, 3))),
            dist=jnp.asarray(np.broadcast_to(np.asarray(dists, np.float32),
                                             (streams, 3))),
        )
        self.engine = ServingEngine(mapdb, cams, config)
        self.frames = np.zeros((streams, det.height, det.width), np.float32)
        self.have = np.zeros(streams, bool)       # ever seen a frame
        self.frame_ids = np.zeros(streams, np.int64)
        self.timestamps = np.zeros(streams, np.float64)
        self.key = jax.random.PRNGKey(seed)
        for i in range(streams):
            node.subscribe(transport.image_topic(i), depth=4)

    def poll(self, timeout: float = 0.05) -> np.ndarray:
        """Drain every image topic to its NEWEST frame. Returns the fresh
        mask (streams that delivered at least one new frame)."""
        fresh = np.zeros(self.B, bool)
        deadline = time.monotonic() + timeout
        for i in range(self.B):
            # block only for the remaining budget on the first message,
            # then drain whatever is already queued without waiting
            budget = max(0.0, deadline - time.monotonic())
            while True:
                p = self.node.receive(transport.image_topic(i),
                                      timeout=0.0 if fresh[i] else budget)
                if p is None:
                    break
                _, img, ts = transport.decode_image(p)
                self.frames[i] = img.astype(np.float32)
                self.timestamps[i] = ts
                fresh[i] = True
        self.have |= fresh
        return fresh

    def step(self, fresh: np.ndarray) -> Dict[int, dict]:
        """One batched dispatch; publish + return poses for the fresh,
        successfully localized streams."""
        if not fresh.any():
            return {}
        self.key, k = jax.random.split(self.key)
        pwc, _, _ = self.engine.localize_frames(jnp.asarray(self.frames), k)
        C = np.asarray(pwc.pose.C)
        R = np.asarray(pwc.pose.R)
        cov = np.asarray(pwc.cov)
        ok = np.asarray(pwc.success)
        out: Dict[int, dict] = {}
        for i in np.flatnonzero(fresh):
            self.frame_ids[i] += 1
            rpy = np.asarray(so3.rot_to_euler(jnp.asarray(R[i])))
            self.node.publish(
                transport.pose_topic(i),
                transport.encode_pose(
                    int(i), int(self.frame_ids[i]),
                    float(self.timestamps[i]), C[i], rpy=rpy,
                    cov3=cov[i, 3:6, 3:6], success=bool(ok[i]),
                ),
            )
            out[int(i)] = {"C": C[i], "rpy": rpy, "success": bool(ok[i])}
        return out

    def run(self, max_steps: Optional[int] = None,
            poll_timeout: float = 0.05,
            idle_timeout: Optional[float] = None) -> int:
        """Serve until max_steps dispatches (None = forever), or until no
        stream has delivered a frame for idle_timeout seconds (None =
        wait forever). Returns the number of dispatches executed."""
        steps = 0
        last_fresh = time.monotonic()
        while max_steps is None or steps < max_steps:
            fresh = self.poll(poll_timeout)
            if fresh.any():
                last_fresh = time.monotonic()
            elif (idle_timeout is not None
                  and time.monotonic() - last_fresh > idle_timeout):
                break
            if self.step(fresh):
                steps += 1
        return steps


def main(argv=None) -> int:
    import argparse

    from . import checkpoint, compile_cache
    from .io import disk

    # persistent XLA compile cache, on by default (COLOC_COMPILE_CACHE=0
    # to opt out) — a serving relaunch reuses the compiled runner graphs
    compile_cache.enable()

    ap = argparse.ArgumentParser(
        description="Serve B robot streams against a resident map "
                    "(map from checkpoint.save_mapdb / --save-map)")
    ap.add_argument("--map", required=True, help="map .npz (save_mapdb)")
    ap.add_argument("--calib", required=True, help="calib.txt (shared "
                    "intrinsics; first drone's K is broadcast to all streams)")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--publish", required=True,
                    help="PORT to start a broker, or HOST:PORT to join one")
    ap.add_argument("--maxkp", type=int, default=1024)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--fast-threshold", type=int, default=12)
    ap.add_argument("--steps", type=int, default=0,
                    help="stop after N dispatches (0 = run forever)")
    args = ap.parse_args(argv)

    (w, h), Ks, dists = disk.read_calib(args.calib, 1)
    config = ColocConfig(
        detector=DetectorOptions(width=w, height=h,
                                 max_keypoints=args.maxkp,
                                 num_levels=args.levels,
                                 fast_threshold=args.fast_threshold),
    )
    mapdb = checkpoint.load_mapdb(args.map)

    broker = None
    if ":" in args.publish:
        host, port = args.publish.rsplit(":", 1)
        port = int(port)
    else:
        broker = transport.Broker(int(args.publish))
        host, port = "127.0.0.1", broker.port
    try:
        with transport.Node(port, host) as node:
            runner = ServeRunner(mapdb, config, Ks[0], dists[0], node,
                                 args.streams)
            n = runner.run(max_steps=args.steps or None)
            print(f"served {n} dispatches")
    finally:
        if broker is not None:
            broker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
