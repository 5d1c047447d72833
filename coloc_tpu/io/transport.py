"""Native TCP topic transport — the ROS pub/sub runtime analog.

Reference parity: inter-robot communication in the reference is ROS topics —
`ROSUtils` publishes per-drone `coloc/drone{i}/pose` PoseStamped messages and
a `coloc/map` point cloud (rosUtils.hpp:21-94), and `InterfaceROS` ingests
camera frames from image topics with message_filters approximate-time sync
(InterfaceROS.hpp:7-44). ROS is absent from the target environment; the
native runtime equivalent is `coloc_tpu/native/transport.cpp` — a
broker-routed TCP topic bus with named topics, bounded drop-oldest
subscriber queues, and many-to-many fan-out — bound here via ctypes.

This module provides:
  - `Broker` / `Node`: the bus primitives (start a broker, connect nodes,
    publish/subscribe raw payloads on named topics).
  - pose / image / point-cloud codecs (fixed little-endian layouts).
  - `TransportPublisher`: ROSUtils-parity session sink — drop-in for the
    session's `viz=` slot (same `publish_pose` / `publish_map` surface as
    io/liveviz.LiveViz), publishing to `coloc/drone{i}/pose` + `coloc/map`.
  - `ImageStreamBridge`: subscribes `coloc/drone{i}/image` topics and feeds
    a `FrameStream`, so `StreamInterface` + `ApproximateTimeSync`
    (io/stream.py) run unchanged over the network — the InterfaceROS path.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
import warnings
from typing import Optional, Sequence

import numpy as np

class TransportClosed(OSError):
    """The node's connection to the broker is gone."""


class PayloadTooLarge(OSError):
    """A received payload exceeded max_bytes (the message is consumed and
    truncated by the C side; the full length is reported)."""


_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcoloc_transport.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        # make on every first load: it rebuilds the library whenever the
        # committed sources are newer, so a stale copied .so never loads
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, "libcoloc_transport.so"],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.coloc_broker_start.restype = ctypes.c_void_p
        lib.coloc_broker_start.argtypes = [ctypes.c_int]
        lib.coloc_broker_port.restype = ctypes.c_int
        lib.coloc_broker_port.argtypes = [ctypes.c_void_p]
        lib.coloc_broker_stop.argtypes = [ctypes.c_void_p]
        lib.coloc_node_connect.restype = ctypes.c_void_p
        lib.coloc_node_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.coloc_node_publish.restype = ctypes.c_int
        lib.coloc_node_publish.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.coloc_node_subscribe.restype = ctypes.c_int
        lib.coloc_node_subscribe.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.coloc_node_unsubscribe.restype = ctypes.c_int
        lib.coloc_node_unsubscribe.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.coloc_node_receive.restype = ctypes.c_int
        lib.coloc_node_receive.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_double,
        ]
        lib.coloc_node_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load_library() is not None


class Broker:
    """Topic router (the rosmaster analog; data flows through it)."""

    def __init__(self, port: int = 0):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("native transport unavailable (build failed)")
        self._lib = lib
        self._handle = lib.coloc_broker_start(port)
        if not self._handle:
            raise OSError(f"failed to start broker on port {port}")

    @property
    def port(self) -> int:
        return self._lib.coloc_broker_port(self._handle)

    def close(self):
        if self._handle:
            self._lib.coloc_broker_stop(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Node:
    """One bus endpoint: publish/subscribe raw payloads on named topics.

    `reconnect=True` makes the node survive a broker restart (roscpp
    reconnects implicitly; the native bus should not be weaker): on a dead
    connection, publish/receive transparently redial
    `host:port` (retrying up to `reconnect_timeout` seconds) and replay
    every live subscription before retrying the operation once. Messages
    published while the broker was down are gone — topic-bus semantics,
    same as ROS; the peer layer's re-offer loop (distributed.run_peer)
    restores eventual consistency on top.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 reconnect: bool = False, reconnect_timeout: float = 10.0,
                 reconnect_interval: float = 0.25):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("native transport unavailable (build failed)")
        self._lib = lib
        self._host = host
        self._port = port
        self._reconnect = reconnect
        self._reconnect_timeout = reconnect_timeout
        self._reconnect_interval = reconnect_interval
        self._handle = lib.coloc_node_connect(host.encode(), port)
        if not self._handle:
            raise OSError(f"failed to connect to broker at {host}:{port}")
        # receive() buffers are per-thread (ImageStreamBridge runs one pump
        # thread per drone on a shared node) and reused across calls — a
        # fresh create_string_buffer per call zero-fills max_bytes (16 MB
        # default) on EVERY 0.1 s poll timeout.
        self._tls = threading.local()
        # topic -> depth, replayed on reconnect; mutations hold _conn_lock
        # (reconnect's replay loop iterates a snapshot under the same lock,
        # so a concurrent subscribe_peer can never resize it mid-iteration)
        self._subs: dict = {}
        self._conn_lock = threading.Lock()
        self._gen = 0                  # bumped on every successful redial
        # old handles are NEVER freed: a thread may be blocked inside
        # coloc_node_receive on one at ANY later point (including during
        # close()), and coloc_node_close frees the struct under it. A dead
        # handle holds one closed fd + a small struct; reconnects are rare
        # events, so the deliberate leak is bounded and safe. Kept only for
        # accounting/debugging.
        self._dead_handles: list = []

    def _recv_buf(self, max_bytes: int):
        buf = getattr(self._tls, "buf", None)
        if buf is None or len(buf) < max_bytes:
            buf = ctypes.create_string_buffer(max_bytes)
            self._tls.buf = buf
        return buf

    def _try_reconnect(self, gen_seen: int) -> bool:
        """Redial the broker and replay subscriptions. Returns True when the
        node has a live connection newer than `gen_seen` (whether this
        thread redialed or another beat it to the lock)."""
        if not self._reconnect:
            return False
        import time as _time

        with self._conn_lock:
            if self._handle is None:
                return False                      # close()d deliberately
            if self._gen != gen_seen:
                return True                       # another thread redialed
            deadline = _time.monotonic() + self._reconnect_timeout
            while _time.monotonic() < deadline:
                h = self._lib.coloc_node_connect(
                    self._host.encode(), self._port)
                if h:
                    self._dead_handles.append(self._handle)
                    self._handle = h
                    for topic, depth in list(self._subs.items()):
                        self._lib.coloc_node_subscribe(
                            self._handle, topic.encode(), depth)
                    self._gen += 1
                    warnings.warn(
                        f"transport node: reconnected to broker at "
                        f"{self._host}:{self._port} and resubscribed "
                        f"{len(self._subs)} topics", RuntimeWarning)
                    return True
                _time.sleep(self._reconnect_interval)
            return False

    def publish(self, topic: str, payload: bytes) -> None:
        gen = self._gen
        rc = self._lib.coloc_node_publish(
            self._handle, topic.encode(), payload, len(payload))
        if rc != 0 and self._try_reconnect(gen):
            rc = self._lib.coloc_node_publish(
                self._handle, topic.encode(), payload, len(payload))
        if rc != 0:
            raise OSError(f"publish to {topic!r} failed")

    def subscribe(self, topic: str, depth: int = 16) -> None:
        rc = self._lib.coloc_node_subscribe(self._handle, topic.encode(),
                                            depth)
        if rc != 0:
            raise OSError(f"subscribe to {topic!r} failed")
        with self._conn_lock:
            self._subs[topic] = depth

    def unsubscribe(self, topic: str) -> None:
        self._lib.coloc_node_unsubscribe(self._handle, topic.encode())
        with self._conn_lock:
            self._subs.pop(topic, None)

    def receive(self, topic: str, timeout: float = 1.0,
                max_bytes: int = 16 << 20) -> Optional[bytes]:
        """Next payload on `topic`, or None on timeout.

        Raises KeyError on unsubscribed topics, TransportClosed on closed
        nodes (the C ABI's -2 / -3), PayloadTooLarge past max_bytes. With
        reconnect=True a dead connection is redialed instead of raising;
        the receive is then retried once on the fresh connection (normally
        a timeout -> None, since queued messages died with the broker)."""
        buf = self._recv_buf(max_bytes)
        gen = self._gen
        n = self._lib.coloc_node_receive(
            self._handle, topic.encode(), buf, max_bytes, timeout)
        if n == -3 and self._try_reconnect(gen):
            n = self._lib.coloc_node_receive(
                self._handle, topic.encode(), buf, max_bytes, timeout)
        if n == -1:
            return None
        if n == -2:
            raise KeyError(f"not subscribed to {topic!r}")
        if n == -3:
            raise TransportClosed("transport connection closed")
        if n > max_bytes:
            raise PayloadTooLarge(
                f"payload ({n} B) exceeds max_bytes ({max_bytes})")
        return buf.raw[:n]

    def close(self):
        with self._conn_lock:
            if self._handle:
                self._lib.coloc_node_close(self._handle)
                self._handle = None
            # dead (pre-reconnect) handles stay allocated on purpose — see
            # the __init__ comment; freeing them here would race a thread
            # still blocked in coloc_node_receive on one
            self._dead_handles = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Message codecs (fixed little-endian layouts)
# ---------------------------------------------------------------------------

_POSE_HDR = struct.Struct("<iid")  # drone, frame, timestamp


def encode_pose(drone: int, frame: int, timestamp: float, C,
                rpy=None, cov3=None, success: bool = True) -> bytes:
    """PoseStamped-analog: position + roll/pitch/yaw + 3x3 position cov.

    Mirrors ROSUtils::loadPoseIntoMsg (rosUtils.hpp:70-84: position + Euler
    orientation) plus the covariance the reference logs alongside
    (logUtils.hpp:90-96)."""
    C = np.asarray(C, np.float64).reshape(3)
    rpy = (np.zeros(3) if rpy is None
           else np.asarray(rpy, np.float64).reshape(3))
    cov3 = (np.zeros((3, 3)) if cov3 is None
            else np.asarray(cov3, np.float64).reshape(3, 3))
    return (_POSE_HDR.pack(drone, frame, timestamp)
            + struct.pack("<b", 1 if success else 0)
            + C.tobytes() + rpy.tobytes() + cov3.tobytes())


def decode_pose(payload: bytes) -> dict:
    drone, frame, ts = _POSE_HDR.unpack_from(payload, 0)
    off = _POSE_HDR.size
    success = struct.unpack_from("<b", payload, off)[0] == 1
    off += 1
    vals = np.frombuffer(payload, np.float64, count=3 + 3 + 9, offset=off)
    return {
        "drone": drone, "frame": frame, "timestamp": ts, "success": success,
        "C": vals[:3].copy(), "rpy": vals[3:6].copy(),
        "cov3": vals[6:].reshape(3, 3).copy(),
    }


_IMAGE_HDR = struct.Struct("<iiid")  # drone, height, width, timestamp


def encode_image(drone: int, image: np.ndarray, timestamp: float) -> bytes:
    """sensor_msgs::Image (mono8) analog; float inputs are clipped to u8
    (the reference converts incoming frames to mono8, InterfaceROS.hpp:18)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    return _IMAGE_HDR.pack(drone, h, w, timestamp) + img.tobytes()


def decode_image(payload: bytes):
    drone, h, w, ts = _IMAGE_HDR.unpack_from(payload, 0)
    img = np.frombuffer(payload, np.uint8, count=h * w,
                        offset=_IMAGE_HDR.size).reshape(h, w).copy()
    return drone, img, ts


def encode_map_points(X) -> bytes:
    """coloc/map point-cloud analog (rosUtils.hpp:43-59)."""
    X = np.ascontiguousarray(np.asarray(X, np.float32).reshape(-1, 3))
    return struct.pack("<i", len(X)) + X.tobytes()


def decode_map_points(payload: bytes) -> np.ndarray:
    n = struct.unpack_from("<i", payload, 0)[0]
    return np.frombuffer(payload, np.float32, count=3 * n,
                         offset=4).reshape(n, 3).copy()


_BUNDLE_HDR = struct.Struct("<iidi")  # drone, frame, timestamp, n_keypoints
# fixed f64 block after the header: K (9) + dist (3) + R (9) + C (3) + cov3 (9)
_BUNDLE_F64 = 9 + 3 + 9 + 3 + 9


def encode_feature_bundle(drone: int, frame: int, timestamp: float,
                          xy, score, scale, angle, desc, valid,
                          K, dist, R, C, cov3) -> bytes:
    """The inter-drone exchange payload: one frame's feature bank
    (keypoints + packed binary descriptors) plus the sender's camera
    intrinsics and current filtered pose + position covariance.

    This is exactly what the reference's robots conceptually ship for
    interPoseEstimator (SURVEY §2.2: descriptor banks, relative pose,
    covariance — "all small"): ~84 B/keypoint, so a 1024-keypoint bundle is
    ~86 KB on the wire. The receiver feeds it straight into
    parallel.mesh.inter_pose_device as the `src` side."""
    xy = np.ascontiguousarray(np.asarray(xy, np.float32).reshape(-1, 2))
    n = len(xy)
    score = np.ascontiguousarray(np.asarray(score, np.float32).reshape(n))
    scale = np.ascontiguousarray(np.asarray(scale, np.int32).reshape(n))
    angle = np.ascontiguousarray(np.asarray(angle, np.float32).reshape(n))
    desc = np.ascontiguousarray(np.asarray(desc, np.uint32).reshape(n, -1))
    valid = np.ascontiguousarray(np.asarray(valid, bool).reshape(n))
    f64 = np.concatenate([
        np.asarray(K, np.float64).reshape(9),
        np.asarray(dist, np.float64).reshape(3),
        np.asarray(R, np.float64).reshape(9),
        np.asarray(C, np.float64).reshape(3),
        np.asarray(cov3, np.float64).reshape(9),
    ])
    return (_BUNDLE_HDR.pack(drone, frame, timestamp, n)
            + struct.pack("<i", desc.shape[1])
            + f64.tobytes() + xy.tobytes() + score.tobytes()
            + scale.tobytes() + angle.tobytes() + desc.tobytes()
            + valid.astype(np.uint8).tobytes())


def decode_feature_bundle(payload: bytes) -> dict:
    drone, frame, ts, n = _BUNDLE_HDR.unpack_from(payload, 0)
    off = _BUNDLE_HDR.size
    words = struct.unpack_from("<i", payload, off)[0]
    off += 4
    f64 = np.frombuffer(payload, np.float64, count=_BUNDLE_F64, offset=off)
    off += _BUNDLE_F64 * 8
    take = lambda dtype, count, shape: (
        np.frombuffer(payload, dtype, count=count, offset=off)
        .reshape(shape).copy()
    )
    xy = take(np.float32, 2 * n, (n, 2)); off += 8 * n
    score = take(np.float32, n, (n,)); off += 4 * n
    scale = take(np.int32, n, (n,)); off += 4 * n
    angle = take(np.float32, n, (n,)); off += 4 * n
    desc = take(np.uint32, words * n, (n, words)); off += 4 * words * n
    valid = take(np.uint8, n, (n,)).astype(bool)
    return {
        "drone": drone, "frame": frame, "timestamp": ts,
        "xy": xy, "score": score, "scale": scale, "angle": angle,
        "desc": desc, "valid": valid,
        "K": f64[0:9].reshape(3, 3), "dist": f64[9:12].copy(),
        "R": f64[12:21].reshape(3, 3), "C": f64[21:24].copy(),
        "cov3": f64[24:33].reshape(3, 3),
    }


# ---------------------------------------------------------------------------
# Session integration
# ---------------------------------------------------------------------------

def pose_topic(drone: int) -> str:
    return f"coloc/drone{drone}/pose"


def features_topic(drone: int) -> str:
    return f"coloc/drone{drone}/features"


def image_topic(drone: int) -> str:
    return f"coloc/drone{drone}/image"


MAP_TOPIC = "coloc/map"


class TransportPublisher:
    """ROSUtils-parity session sink over the native bus.

    Presents the same surface as io/liveviz.LiveViz (`publish_pose`,
    `publish_map`, `close`) so it drops into ColocSession's `viz=` slot —
    poses go out per-update (queue depth 1 per topic matches ROSUtils'
    advertise(topic, 1)), the map cloud on map (re)build."""

    def __init__(self, node: Node, max_map_points: int = 20000):
        self._node = node
        self._max_map_points = max_map_points
        self._frame = 0
        self._dead = False

    def _publish(self, topic: str, payload: bytes):
        # Telemetry is advisory: a dying broker/bus must degrade this sink,
        # not abort the localization session (LiveViz, the drop-in sibling
        # for the viz slot, never raises either).
        if self._dead:
            return
        try:
            self._node.publish(topic, payload)
        except OSError:
            self._dead = True
            warnings.warn(
                "transport publisher: bus connection lost; telemetry "
                "disabled for the rest of the session", RuntimeWarning)

    def publish_pose(self, drone: int, C, cov3=None, success: bool = True,
                     frame: Optional[int] = None):
        if frame is not None:
            self._frame = int(frame)
        self._publish(
            pose_topic(int(drone)),
            encode_pose(int(drone), self._frame, 0.0, C, cov3=cov3,
                        success=success))

    def publish_map(self, X, valid=None):
        from coloc_tpu.io import decimate_map_points

        X = decimate_map_points(X, valid, self._max_map_points)
        self._publish(MAP_TOPIC, encode_map_points(X))

    def close(self):
        pass  # node lifetime is the caller's


class ImageStreamBridge:
    """Subscribes `coloc/drone{i}/image` and feeds a FrameStream.

    The receiving side of the InterfaceROS path: frames arriving on the bus
    land in per-drone queues that `StreamInterface` / `ApproximateTimeSync`
    (io/stream.py) consume unchanged."""

    def __init__(self, node: Node, stream, drones: Sequence[int],
                 depth: int = 4, max_bytes: int = 16 << 20):
        self._node = node
        self._stream = stream
        self._max_bytes = max_bytes
        self._drones = list(drones)
        for d in self._drones:
            node.subscribe(image_topic(d), depth=depth)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._pump, args=(d,), daemon=True)
            for d in self._drones
        ]
        for t in self._threads:
            t.start()

    def _pump(self, drone: int):
        topic = image_topic(drone)
        while not self._stop.is_set():
            try:
                payload = self._node.receive(topic, timeout=0.1,
                                             max_bytes=self._max_bytes)
            except PayloadTooLarge as e:
                # that one frame is lost (consumed + truncated by the C
                # side), but the feed survives
                warnings.warn(f"image bridge drone {drone}: dropped "
                              f"oversized frame ({e})", RuntimeWarning)
                continue
            except (TransportClosed, KeyError) as e:
                # unrecoverable: close the stream so consumers see EOF
                # instead of blocking forever on a silently-dead feed
                if not self._stop.is_set():
                    warnings.warn(f"image bridge drone {drone}: feed ended "
                                  f"({e!r}); closing stream", RuntimeWarning)
                    self._stream.close()
                return
            if payload is None:
                continue
            d, img, ts = decode_image(payload)
            self._stream.push(d, img, timestamp=ts)

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
