"""Peer-to-peer multi-process collaborative localization
(coloc_tpu.distributed): the reference's sequential in-process drone loop
(coloc.hpp:128-148) deployed as one robot per process over the topic bus.

Three layers:
  1. the feature-bundle wire codec round-trips bit-exactly;
  2. inter_fuse over a decoded bundle reproduces host-side
     session.inter_pose on identical inputs (the three deployment shapes —
     one process, one mesh, N processes — share one compute core);
  3. two genuine OS processes, each owning one drone, bootstrap from a
     shared map checkpoint and fuse each other's bundles over a real
     broker (skipped when the native transport isn't built).
"""

import pathlib
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest

from coloc_tpu.config import ColocConfig, DetectorOptions
from coloc_tpu.distributed import DronePeer
from coloc_tpu.io import synthetic, transport
from coloc_tpu.session import ColocSession

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)


def make_config():
    return ColocConfig(
        num_drones=2,
        detector=DetectorOptions(width=W, height=H, max_keypoints=512,
                                 num_levels=4, fast_threshold=10),
        max_landmarks=512,
    )


@pytest.fixture(scope="module")
def dataset():
    scene = synthetic.make_scene(H, W, K, seed=3)
    frames = {}
    for d in range(2):
        Rs, Cs = synthetic.trajectory(3, d)
        frames[d] = [synthetic.render(scene, Rs[f], Cs[f]) for f in range(3)]
    return frames


class TestBundleCodec:
    def test_roundtrip_bit_exact(self, rng):
        n = 100
        xy = rng.uniform(0, 320, (n, 2)).astype(np.float32)
        score = rng.uniform(0, 255, n).astype(np.float32)
        scale = rng.integers(0, 8, n).astype(np.int32)
        angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        desc = rng.integers(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)
        valid = rng.random(n) > 0.3
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        C = rng.normal(size=3)
        cov3 = np.diag(rng.uniform(0.01, 1, 3))
        payload = transport.encode_feature_bundle(
            drone=1, frame=7, timestamp=123.25,
            xy=xy, score=score, scale=scale, angle=angle, desc=desc,
            valid=valid, K=K, dist=np.array([0.1, -0.05, 0.0]),
            R=R, C=C, cov3=cov3,
        )
        b = transport.decode_feature_bundle(payload)
        assert b["drone"] == 1 and b["frame"] == 7
        assert b["timestamp"] == 123.25
        np.testing.assert_array_equal(b["xy"], xy)
        np.testing.assert_array_equal(b["score"], score)
        np.testing.assert_array_equal(b["scale"], scale)
        np.testing.assert_array_equal(b["angle"], angle)
        np.testing.assert_array_equal(b["desc"], desc)
        np.testing.assert_array_equal(b["valid"], valid)
        np.testing.assert_array_equal(b["K"], np.asarray(K, np.float64))
        np.testing.assert_array_equal(b["R"], R)
        np.testing.assert_array_equal(b["C"], C)
        np.testing.assert_array_equal(b["cov3"], cov3)
        # wire size is the documented ~84 B/keypoint + fixed overhead
        assert len(payload) < 90 * n + 400


class TestPeerEquivalence:
    def test_inter_fuse_matches_session(self, dataset):
        """Wire-path interPoseEstimator == in-process session.inter_pose
        on identical inputs (same features, poses, map, RANSAC key)."""
        frames = dataset
        config = make_config()
        Ks = np.stack([K, K])
        dists = np.zeros((2, 3), np.float32)
        session = ColocSession(config, Ks, dists)
        assert session.init_map({d: frames[d][0] for d in range(2)})
        session.intra_pose_all({d: frames[d][1] for d in range(2)})

        imgs = {d: frames[d][1] for d in range(2)}
        feats = {d: session.detect(imgs[d]) for d in range(2)}
        key = jax.random.PRNGKey(7)
        host = session.inter_pose(0, 1, imgs, feats=feats, key=key)
        assert host is not None

        # offline peer for drone 1 sharing the session's map; mirror its
        # post-intra state, then fuse drone 0's bundle from the wire codec
        peer = DronePeer(1, config, K, dists[1], session.mapdb, node=None)
        peer._last_image = imgs[1]
        peer.frame = 1
        peer.session.last_pose[0] = session.last_pose[1]

        lp0 = session.last_pose[0]
        f0 = feats[0]
        payload = transport.encode_feature_bundle(
            0, 0, 0.0,
            np.asarray(f0.xy), np.asarray(f0.score), np.asarray(f0.scale),
            np.asarray(f0.angle), np.asarray(f0.desc), np.asarray(f0.valid),
            K, dists[0], np.asarray(lp0.pose.R), np.asarray(lp0.pose.C),
            np.asarray(lp0.cov[3:6, 3:6]),
        )
        bundle = transport.decode_feature_bundle(payload)
        fused = peer.inter_fuse(0, bundle=bundle, key=key, publish=False)
        assert fused is not None
        np.testing.assert_allclose(
            np.asarray(fused.pos), np.asarray(host.pos), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(fused.cov), np.asarray(host.cov), atol=1e-5
        )

        # staleness gate: the SAME bundle stamped an
        # hour ago must be refused before any compute; stamped fresh it
        # fuses; timestamp 0.0 (unstamped) is exempt (used above)
        import time as _time

        stale = dict(bundle, timestamp=_time.time() - 3600.0)
        assert peer.inter_fuse(0, bundle=stale, key=key,
                               publish=False) is None
        fresh = dict(bundle, timestamp=_time.time())
        assert peer.inter_fuse(0, bundle=fresh, key=key,
                               publish=False) is not None
        # per-call override beats the constructor window
        assert peer.inter_fuse(0, bundle=fresh, key=key, publish=False,
                               max_age=1e-9) is None

    def test_capacity_mismatch_rejected(self, dataset):
        """A peer with a different keypoint capacity is refused cleanly."""
        frames = dataset
        config = make_config()
        session = ColocSession(config, np.stack([K, K]),
                               np.zeros((2, 3), np.float32))
        assert session.init_map({d: frames[d][0] for d in range(2)})
        peer = DronePeer(1, config, K, np.zeros(3), session.mapdb, node=None)
        peer._last_image = frames[1][1]
        peer.frame = 1
        pwc = peer.session.intra_pose(0, frames[1][1])
        peer.session.last_pose[0] = pwc
        n = 64  # != config capacity 512
        bundle = transport.decode_feature_bundle(
            transport.encode_feature_bundle(
                0, 0, 0.0, np.zeros((n, 2), np.float32), np.zeros(n),
                np.zeros(n, np.int32), np.zeros(n),
                np.zeros((n, 16), np.uint32), np.zeros(n, bool),
                K, np.zeros(3), np.eye(3), np.zeros(3), np.eye(3),
            )
        )
        assert peer.inter_fuse(0, bundle=bundle, publish=False) is None


_PEER_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np

    state = np.load(sys.argv[1], allow_pickle=True)
    drone = int(sys.argv[2])
    broker_port = int(sys.argv[3])
    out_path = sys.argv[4]

    import jax
    jax.config.update("jax_platforms", "cpu")

    from coloc_tpu import checkpoint
    from coloc_tpu.config import ColocConfig, DetectorOptions
    from coloc_tpu.distributed import run_peer

    mapdb = checkpoint.load_mapdb(str(state["mapdb_path"]))
    config = ColocConfig(
        num_drones=2,
        detector=DetectorOptions(
            width=int(state["W"]), height=int(state["H"]),
            max_keypoints=512, num_levels=4, fast_threshold=10,
        ),
        max_landmarks=512,
    )
    frames = [state[f"frame{i}"] for i in range(int(state["n_frames"]))]
    res = run_peer(
        drone, config, state["K"], np.zeros(3, np.float32), mapdb,
        broker_port, frames, peers=[1 - drone],
        inter_every=2, bundle_every=1, inter_timeout=300.0,
    )
    np.savez(
        out_path,
        pos=np.stack(res["pose"]),
        success=np.asarray(res["success"]),
        n_fused=len(res["fused"]),
        fused_pos=(res["fused"][0][2] if res["fused"]
                   else np.full(3, np.nan)),
    )
    print("peer", drone, "done:", len(res["fused"]), "fusions")
""")


@pytest.mark.skipif(not transport.available(),
                    reason="native transport library not built")
def test_two_process_peers(dataset, tmp_path):
    """Two OS processes, one drone each: shared map from a checkpoint,
    frames stepped locally, feature bundles + poses over a real broker,
    inter-drone fusion on each side (the full deployment shape)."""
    from coloc_tpu import checkpoint

    frames = dataset
    config = make_config()
    session = ColocSession(config, np.stack([K, K]),
                           np.zeros((2, 3), np.float32))
    assert session.init_map({d: frames[d][0] for d in range(2)})
    map_path = tmp_path / "map.npz"
    checkpoint.save_mapdb(str(map_path), session.mapdb)

    script = tmp_path / "peer.py"
    script.write_text(_PEER_SCRIPT)

    with transport.Broker() as broker:
        procs = []
        for d in range(2):
            state_path = tmp_path / f"state{d}.npz"
            np.savez(
                state_path, mapdb_path=str(map_path), K=K, H=H, W=W,
                n_frames=2,
                **{f"frame{i}": frames[d][i + 1] for i in range(2)},
            )
            out_path = tmp_path / f"out{d}.npz"
            import os
            repo = str(pathlib.Path(__file__).resolve().parent.parent)
            env = {"JAX_PLATFORMS": "cpu",
                   "PATH": "/usr/bin:/bin", "PYTHONPATH": repo}
            env.update({k: v for k, v in os.environ.items()
                        if k not in env and k != "XLA_FLAGS"})
            procs.append((d, out_path, subprocess.Popen(
                [sys.executable, str(script), str(state_path), str(d),
                 str(broker.port), str(out_path)],
                cwd=str(pathlib.Path(__file__).resolve().parent.parent),
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )))
        for d, out_path, proc in procs:
            stdout, stderr = proc.communicate(timeout=1200)
            assert proc.returncode == 0, (
                f"peer {d} failed:\n{stdout}\n{stderr}"
            )
        for d, out_path, _ in procs:
            out = np.load(out_path)
            assert out["success"].all(), f"peer {d} lost localization"
            assert int(out["n_fused"]) >= 1, f"peer {d} never fused"
            assert np.isfinite(out["fused_pos"]).all()


_RESTART_PEER_SCRIPT = textwrap.dedent("""
    import os
    import sys
    import time

    import numpy as np

    state = np.load(sys.argv[1], allow_pickle=True)
    drone = int(sys.argv[2])
    broker_port = int(sys.argv[3])
    out_path = sys.argv[4]
    sync_dir = sys.argv[5]

    import jax
    jax.config.update("jax_platforms", "cpu")

    from coloc_tpu import checkpoint
    from coloc_tpu.config import ColocConfig, DetectorOptions
    from coloc_tpu.distributed import DronePeer
    from coloc_tpu.io import transport

    mapdb = checkpoint.load_mapdb(str(state["mapdb_path"]))
    config = ColocConfig(
        num_drones=2,
        detector=DetectorOptions(
            width=int(state["W"]), height=int(state["H"]),
            max_keypoints=512, num_levels=4, fast_threshold=10,
        ),
        max_landmarks=512,
    )
    frames = [state[f"frame{i}"] for i in range(int(state["n_frames"]))]
    other = 1 - drone

    def fuse_round(peer, deadline_s):
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            try:
                peer.publish_bundle()
            except OSError:
                pass  # broker down: the node redials on a later attempt
            fused = peer.inter_fuse(other, timeout=2.0)
            if fused is not None:
                return fused
        return None

    with transport.Node(broker_port, reconnect=True,
                        reconnect_timeout=60.0) as node:
        peer = DronePeer(drone, config, state["K"],
                         np.zeros(3, np.float32), mapdb, node,
                         peers=[other], bundle_max_age=300.0)
        # phase 1: two frames + one fusion on the ORIGINAL broker
        for f in range(2):
            peer.step(frames[f])
        fused1 = fuse_round(peer, 300.0)
        open(os.path.join(sync_dir, f"fused1_{drone}"), "w").close()
        # wait for the harness to bounce the broker
        resume = os.path.join(sync_dir, "resume")
        while not os.path.exists(resume):
            time.sleep(0.2)
        # phase 2: two frames + one fusion over the RESTARTED broker —
        # the reconnect-enabled node must redial + resubscribe on its own
        for f in range(2, 4):
            peer.step(frames[f])
        fused2 = fuse_round(peer, 300.0)
        peer.close()
    np.savez(
        out_path,
        fused_before=fused1 is not None,
        fused_after=fused2 is not None,
        pos_after=(np.asarray(fused2.pos) if fused2 is not None
                   else np.full(3, np.nan)),
    )
    print("peer", drone, "done:", fused1 is not None, fused2 is not None)
""")


@pytest.mark.skipif(not transport.available(),
                    reason="native transport library not built")
def test_two_process_peers_survive_broker_restart(tmp_path):
    """Fleet resilience: two peer processes fuse once,
    the harness KILLS the broker and restarts it on the same port, and the
    peers — via Node(reconnect=True) redial + resubscribe and the bundle
    re-offer loop — fuse again over the fresh broker."""
    from coloc_tpu import checkpoint

    scene = synthetic.make_scene(H, W, K, seed=3)
    frames = {}
    for d in range(2):
        Rs, Cs = synthetic.trajectory(5, d)
        frames[d] = [synthetic.render(scene, Rs[f], Cs[f]) for f in range(5)]

    config = make_config()
    session = ColocSession(config, np.stack([K, K]),
                           np.zeros((2, 3), np.float32))
    assert session.init_map({d: frames[d][0] for d in range(2)})
    map_path = tmp_path / "map.npz"
    checkpoint.save_mapdb(str(map_path), session.mapdb)

    script = tmp_path / "peer_restart.py"
    script.write_text(_RESTART_PEER_SCRIPT)
    sync_dir = tmp_path / "sync"
    sync_dir.mkdir()

    import os

    broker = transport.Broker()
    port = broker.port
    broker2 = None
    procs = []
    try:
        for d in range(2):
            state_path = tmp_path / f"rstate{d}.npz"
            np.savez(
                state_path, mapdb_path=str(map_path), K=K, H=H, W=W,
                n_frames=4,
                **{f"frame{i}": frames[d][i + 1] for i in range(4)},
            )
            out_path = tmp_path / f"rout{d}.npz"
            repo = str(pathlib.Path(__file__).resolve().parent.parent)
            env = {"JAX_PLATFORMS": "cpu",
                   "PATH": "/usr/bin:/bin", "PYTHONPATH": repo}
            env.update({k: v for k, v in os.environ.items()
                        if k not in env and k != "XLA_FLAGS"})
            procs.append((d, out_path, subprocess.Popen(
                [sys.executable, str(script), str(state_path), str(d),
                 str(port), str(out_path), str(sync_dir)],
                cwd=repo, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )))
        # wait until BOTH peers finished their first fusion round
        deadline = time.time() + 1200
        while time.time() < deadline:
            if all((sync_dir / f"fused1_{d}").exists() for d in range(2)):
                break
            for d, _, p in procs:
                assert p.poll() is None or p.returncode == 0, (
                    f"peer {d} died early:\n{p.communicate()[1]}")
            time.sleep(0.5)
        else:
            raise AssertionError("peers never reached first fusion")

        # bounce the broker on the same port, then release the peers
        broker.close()
        time.sleep(0.5)
        broker2 = transport.Broker(port)
        (sync_dir / "resume").touch()

        for d, out_path, proc in procs:
            stdout, stderr = proc.communicate(timeout=1200)
            assert proc.returncode == 0, (
                f"peer {d} failed:\n{stdout}\n{stderr}")
        for d, out_path, _ in procs:
            out = np.load(out_path)
            assert bool(out["fused_before"]), f"peer {d}: no pre-bounce fuse"
            assert bool(out["fused_after"]), (
                f"peer {d}: never fused after broker restart")
            assert np.isfinite(out["pos_after"]).all()
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
        if broker2 is not None:
            broker2.close()
        broker.close()
