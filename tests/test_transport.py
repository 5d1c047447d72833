"""Native TCP transport tests: bus semantics, codecs, the ROSUtils-parity
session sink, and the InterfaceROS-parity networked image path — including a
genuine two-process pub/sub round trip."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from coloc_tpu.io import stream as stream_mod
from coloc_tpu.io import transport

pytestmark = pytest.mark.skipif(
    not transport.available(), reason="native toolchain unavailable"
)


@pytest.fixture()
def broker():
    with transport.Broker() as b:
        yield b


def test_pub_sub_roundtrip_and_ordering(broker):
    with transport.Node(broker.port) as sub, transport.Node(broker.port) as pub:
        sub.subscribe("t/x", depth=16)
        time.sleep(0.05)  # let the SUBSCRIBE land before publishing
        for i in range(5):
            pub.publish("t/x", f"msg{i}".encode())
        got = [sub.receive("t/x", timeout=2.0) for _ in range(5)]
        assert got == [f"msg{i}".encode() for i in range(5)]
        # nothing else pending
        assert sub.receive("t/x", timeout=0.05) is None


def test_topic_isolation_and_fanout(broker):
    with transport.Node(broker.port) as a, transport.Node(broker.port) as b, \
            transport.Node(broker.port) as pub:
        a.subscribe("t/a")
        b.subscribe("t/a")
        b.subscribe("t/b")
        time.sleep(0.05)
        pub.publish("t/a", b"on-a")
        pub.publish("t/b", b"on-b")
        # fan-out: both subscribers of t/a get the message
        assert a.receive("t/a", timeout=2.0) == b"on-a"
        assert b.receive("t/a", timeout=2.0) == b"on-a"
        # isolation: only b sees t/b
        assert b.receive("t/b", timeout=2.0) == b"on-b"
        with pytest.raises(KeyError):
            a.receive("t/b", timeout=0.05)


def test_drop_oldest_when_queue_full(broker):
    with transport.Node(broker.port) as sub, transport.Node(broker.port) as pub:
        sub.subscribe("t/q", depth=2)
        time.sleep(0.05)
        for i in range(6):
            pub.publish("t/q", bytes([i]))
        time.sleep(0.2)  # let the reader thread drain the socket
        # only the 2 newest survive (live-stream semantics)
        assert sub.receive("t/q", timeout=1.0) == bytes([4])
        assert sub.receive("t/q", timeout=1.0) == bytes([5])


def test_pose_codec_roundtrip():
    C = np.array([1.5, -2.0, 3.25])
    rpy = np.array([0.1, -0.2, 0.3])
    cov = np.arange(9, dtype=np.float64).reshape(3, 3)
    msg = transport.decode_pose(
        transport.encode_pose(1, 7, 12.5, C, rpy=rpy, cov3=cov,
                              success=False))
    assert msg["drone"] == 1 and msg["frame"] == 7
    assert msg["timestamp"] == 12.5 and msg["success"] is False
    np.testing.assert_array_equal(msg["C"], C)
    np.testing.assert_array_equal(msg["rpy"], rpy)
    np.testing.assert_array_equal(msg["cov3"], cov)


def test_image_and_map_codec_roundtrip():
    img = (np.arange(20 * 30) % 251).astype(np.uint8).reshape(20, 30)
    d, out, ts = transport.decode_image(transport.encode_image(3, img, 9.0))
    assert d == 3 and ts == 9.0
    np.testing.assert_array_equal(out, img)
    # float input clips to u8 (mono8 conversion parity)
    fimg = img.astype(np.float32) + 0.4
    _, out2, _ = transport.decode_image(transport.encode_image(0, fimg, 0.0))
    np.testing.assert_array_equal(out2, img)

    X = np.random.default_rng(0).normal(size=(17, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        transport.decode_map_points(transport.encode_map_points(X)), X)


def test_transport_publisher_rosutils_parity(broker):
    """TransportPublisher speaks the session's viz surface and lands
    decodable PoseStamped/map analogs on the ROSUtils topic names."""
    with transport.Node(broker.port) as rx, transport.Node(broker.port) as tx:
        rx.subscribe(transport.pose_topic(0), depth=1)
        rx.subscribe(transport.MAP_TOPIC, depth=1)
        time.sleep(0.05)
        sink = transport.TransportPublisher(tx)
        C = np.array([0.5, 1.0, -2.0])
        cov = np.eye(3) * 0.01
        sink.publish_pose(0, C, cov3=cov, success=True, frame=4)
        X = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
        sink.publish_map(X, valid=np.ones(50, bool))

        msg = transport.decode_pose(
            rx.receive(transport.pose_topic(0), timeout=2.0))
        assert msg["frame"] == 4 and msg["success"]
        np.testing.assert_allclose(msg["C"], C)
        np.testing.assert_allclose(msg["cov3"], cov)
        pts = transport.decode_map_points(
            rx.receive(transport.MAP_TOPIC, timeout=2.0))
        np.testing.assert_array_equal(pts, X)

        # depth=1 pose topic keeps only the latest (ROS advertise(topic, 1))
        sink.publish_pose(0, C + 1.0, frame=5)
        sink.publish_pose(0, C + 2.0, frame=6)
        time.sleep(0.2)
        last = transport.decode_pose(
            rx.receive(transport.pose_topic(0), timeout=2.0))
        assert last["frame"] == 6
        np.testing.assert_allclose(last["C"], C + 2.0)


def test_image_bridge_feeds_time_sync(broker):
    """Networked frames flow through ImageStreamBridge -> FrameStream ->
    ApproximateTimeSync exactly like the InterfaceROS pair path."""
    fs = stream_mod.FrameStream(num_drones=2)
    with transport.Node(broker.port) as rx, transport.Node(broker.port) as tx:
        bridge = transport.ImageStreamBridge(rx, fs, drones=[0, 1])
        time.sleep(0.05)
        img0 = np.full((8, 8), 10, np.uint8)
        img1 = np.full((8, 8), 20, np.uint8)
        tx.publish(transport.image_topic(0),
                   transport.encode_image(0, img0, 1.00))
        tx.publish(transport.image_topic(1),
                   transport.encode_image(1, img1, 1.02))
        sync = stream_mod.ApproximateTimeSync(fs, 0, 1, slop=0.05)
        pair = sync.next_pair(timeout=3.0)
        bridge.close()
    assert pair is not None
    (ta, a), (tb, b) = pair
    assert abs(ta - tb) <= 0.05
    np.testing.assert_array_equal(a, img0)
    np.testing.assert_array_equal(b, img1)


def test_receive_survives_concurrent_unsubscribe(broker):
    """A blocked receive() whose topic is unsubscribed from another thread
    must surface KeyError (the C side re-finds the queue after every wait;
    a held iterator would dangle into freed map-node memory)."""
    import threading

    with transport.Node(broker.port) as node:
        node.subscribe("t/gone", depth=4)
        time.sleep(0.05)
        result = {}

        def rx():
            try:
                result["value"] = node.receive("t/gone", timeout=5.0)
            except Exception as e:  # noqa: BLE001 - recording for assert
                result["error"] = e

        t = threading.Thread(target=rx)
        t.start()
        time.sleep(0.2)  # let rx block inside the native wait
        node.unsubscribe("t/gone")
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert isinstance(result.get("error"), KeyError)


def test_oversized_payload_raises_and_feed_survives(broker):
    """PayloadTooLarge on a too-big message; the NEXT receive still works
    (the C side consumed + truncated the oversized frame)."""
    with transport.Node(broker.port) as sub, transport.Node(broker.port) as pub:
        sub.subscribe("t/big", depth=4)
        time.sleep(0.05)
        pub.publish("t/big", b"x" * 4096)
        pub.publish("t/big", b"ok")
        with pytest.raises(transport.PayloadTooLarge):
            sub.receive("t/big", timeout=2.0, max_bytes=64)
        assert sub.receive("t/big", timeout=2.0) == b"ok"


def test_image_bridge_drops_oversized_frame_and_continues(broker):
    """One oversized frame must not silently kill a drone's pump thread."""
    fs = stream_mod.FrameStream(num_drones=1)
    with transport.Node(broker.port) as rx, transport.Node(broker.port) as tx:
        bridge = transport.ImageStreamBridge(rx, fs, drones=[0],
                                             max_bytes=1024)
        time.sleep(0.05)
        big = np.zeros((64, 64), np.uint8)      # 4 KB > max_bytes
        small = np.full((8, 8), 5, np.uint8)    # fits
        with pytest.warns(RuntimeWarning, match="oversized"):
            tx.publish(transport.image_topic(0),
                       transport.encode_image(0, big, 1.0))
            tx.publish(transport.image_topic(0),
                       transport.encode_image(0, small, 2.0))
            got = fs.pop(0, timeout=5.0)
        bridge.close()
    assert got is not None
    ts, img = got
    assert ts == 2.0
    np.testing.assert_array_equal(img, small)


def test_publisher_degrades_when_bus_dies():
    """TransportPublisher must swallow bus loss (advisory telemetry), not
    abort the session — LiveViz-parity for the viz slot."""
    b = transport.Broker()
    node = transport.Node(b.port)
    sink = transport.TransportPublisher(node)
    sink.publish_pose(0, np.zeros(3))
    b.close()  # kill the bus under the publisher
    time.sleep(0.1)
    with pytest.warns(RuntimeWarning, match="bus connection lost"):
        for _ in range(20):  # socket buffering may absorb the first sends
            sink.publish_pose(0, np.ones(3))
            if sink._dead:
                break
            time.sleep(0.05)
    assert sink._dead
    sink.publish_pose(0, np.ones(3))  # no raise once degraded
    node.close()


def test_node_reconnects_after_broker_restart():
    """reconnect=True nodes must survive a broker bounce on the same port:
    redial, resubscribe, and deliver traffic again.
    Messages in flight during the outage are lost (topic-bus semantics);
    the test asserts EVENTUAL recovery via republish."""
    b = transport.Broker()
    port = b.port
    sub = transport.Node(port, reconnect=True, reconnect_timeout=15.0)
    pub = transport.Node(port, reconnect=True, reconnect_timeout=15.0)
    sub.subscribe("t/r", depth=4)
    time.sleep(0.05)
    pub.publish("t/r", b"before")
    assert sub.receive("t/r", timeout=5.0) == b"before"

    b.close()          # bounce the broker
    time.sleep(0.2)
    b2 = transport.Broker(port)  # same port (SO_REUSEADDR on the listener)
    try:
        # recovery loop: publishes into the dead socket may be silently
        # absorbed by TCP buffering before the RST arrives, so republish
        # until the redialed subscription delivers
        got = None
        deadline = time.monotonic() + 30.0
        with pytest.warns(RuntimeWarning, match="reconnected to broker"):
            while got is None and time.monotonic() < deadline:
                try:
                    pub.publish("t/r", b"after")
                except OSError:
                    pass
                got = sub.receive("t/r", timeout=1.0)
        assert got == b"after"
    finally:
        sub.close()
        pub.close()
        b2.close()


def test_node_without_reconnect_still_raises():
    """Default nodes keep the explicit failure semantics: a dead broker
    surfaces TransportClosed, never a silent hang or hidden redial."""
    b = transport.Broker()
    n = transport.Node(b.port)
    n.subscribe("t/x", depth=2)
    b.close()
    time.sleep(0.2)
    with pytest.raises(transport.TransportClosed):
        for _ in range(50):  # first receives may drain the closing window
            n.receive("t/x", timeout=0.1)
    n.close()


def test_broker_stop_with_live_clients_is_clean():
    """Stopping a broker with connected clients must join its reader
    threads (not free the broker under them) and unblock receivers."""
    b = transport.Broker()
    nodes = [transport.Node(b.port) for _ in range(4)]
    for i, n in enumerate(nodes):
        n.subscribe(f"t/{i}", depth=2)
    time.sleep(0.05)
    b.close()
    # nodes observe the closed bus rather than hanging
    for i, n in enumerate(nodes):
        with pytest.raises(transport.TransportClosed):
            n.receive(f"t/{i}", timeout=5.0)
    for n in nodes:
        n.close()


_CHILD = r"""
import sys, time
import numpy as np
from coloc_tpu.io import transport

port = int(sys.argv[1])
with transport.Node(port) as node:
    node.subscribe("two/ack", depth=4)
    # announce readiness, then echo-and-transform whatever arrives
    node.publish("two/hello", b"ready")
    payload = node.receive("two/ack", timeout=10.0)
    assert payload is not None
    img = transport.decode_image(payload)[1]
    node.publish("two/hello", transport.encode_image(9, img[::-1], 2.0))
"""


def test_two_process_roundtrip(broker, tmp_path):
    """A real second OS process joins the bus, receives an image, and
    publishes a transformed reply."""
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    with transport.Node(broker.port) as node:
        node.subscribe("two/hello", depth=4)
        child = subprocess.Popen([sys.executable, str(script),
                                  str(broker.port)], env=env)
        try:
            assert node.receive("two/hello", timeout=15.0) == b"ready"
            img = (np.arange(16 * 16) % 256).astype(np.uint8).reshape(16, 16)
            node.publish("two/ack", transport.encode_image(0, img, 1.0))
            reply = node.receive("two/hello", timeout=15.0)
            assert reply is not None
            d, out, ts = transport.decode_image(reply)
            assert d == 9 and ts == 2.0
            np.testing.assert_array_equal(out, img[::-1])
        finally:
            child.wait(timeout=20)
    assert child.returncode == 0
