"""Peer-to-peer collaborative localization: one robot per OS process.

The parent process bootstraps a shared map (saved as a checkpoint), starts
a broker, and spawns one child process per drone. Each child loads the map,
steps its own camera frames locally (intra localization + Kalman filter),
publishes pose + feature bundles on the topic bus, and runs the full
inter-drone relative localization + covariance-intersection fusion against
its peer's bundle pulled off the wire — `coloc_tpu.distributed.DronePeer`.

This is the deployment the reference's ROS design gestured at but never
ran (it loops both drones inside one process, coloc.hpp:128-148).

All three JAX processes share one GPU here, and a JAX process reserves
three quarters of a card's memory when it first uses it unless told
otherwise. So every process, the parent included, gets an explicit
XLA_PYTHON_CLIENT_MEM_FRACTION share of 0.3 (0.9 in all). Peers on
separate cards would instead pick their card with CUDA_VISIBLE_DEVICES.

The transport library builds from coloc_tpu/native on first use.
"""

import os as _os
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root (no install needed)
# this process's share of the card; set before JAX touches the device
_os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.3")


import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np

from coloc_tpu import checkpoint
from coloc_tpu.config import ColocConfig, DetectorOptions
from coloc_tpu.io import synthetic, transport
from coloc_tpu.session import ColocSession

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)

PEER = textwrap.dedent("""
    import sys
    import numpy as np
    state = np.load(sys.argv[1], allow_pickle=True)
    drone, port = int(sys.argv[2]), int(sys.argv[3])

    from coloc_tpu import checkpoint
    from coloc_tpu.config import ColocConfig, DetectorOptions
    from coloc_tpu.distributed import run_peer

    config = ColocConfig(
        num_drones=2,
        detector=DetectorOptions(width=int(state["W"]), height=int(state["H"]),
                                 max_keypoints=512, num_levels=4,
                                 fast_threshold=10),
        max_landmarks=512,
    )
    mapdb = checkpoint.load_mapdb(str(state["mapdb_path"]))
    frames = [state[f"frame{i}"] for i in range(int(state["n_frames"]))]
    res = run_peer(drone, config, state["K"], np.zeros(3, np.float32), mapdb,
                   port, frames, peers=[1 - drone], inter_every=2,
                   inter_timeout=600.0)
    ok = sum(res["success"])
    print(f"peer {drone}: localized {ok}/{len(res['success'])} frames, "
          f"{len(res['fused'])} inter-drone fusions", flush=True)
    for f, src, pos, cov in res["fused"]:
        print(f"peer {drone}: fused with drone {src} at frame {f}: "
              f"pos={pos.round(3)} cov trace={np.trace(cov):.5f}", flush=True)
""")


def main():
    if not transport.available():
        print("native transport library not built - run: make -C coloc_tpu/native")
        return

    scene = synthetic.make_scene(H, W, K, seed=3)
    frames = {}
    for d in range(2):
        Rs, Cs = synthetic.trajectory(3, d)
        frames[d] = [synthetic.render(scene, Rs[f], Cs[f]) for f in range(3)]

    config = ColocConfig(
        num_drones=2,
        detector=DetectorOptions(width=W, height=H, max_keypoints=512,
                                 num_levels=4, fast_threshold=10),
        max_landmarks=512,
    )
    session = ColocSession(config, np.stack([K, K]), np.zeros((2, 3), np.float32))
    assert session.init_map({d: frames[d][0] for d in range(2)})
    print(f"shared map bootstrapped: "
          f"{int(np.asarray(session.mapdb.valid).sum())} landmarks")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        checkpoint.save_mapdb(str(tmp / "map.npz"), session.mapdb)
        (tmp / "peer.py").write_text(PEER)

        import os
        repo = Path(__file__).resolve().parent.parent
        env = dict(os.environ)
        env["PYTHONPATH"] = (str(repo) + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else str(repo))
        # each peer's share of the card (parent 0.3 + 2 x 0.3 = 0.9)
        env["XLA_PYTHON_CLIENT_MEM_FRACTION"] = "0.3"

        with transport.Broker() as broker:
            procs = []
            for d in range(2):
                np.savez(tmp / f"state{d}.npz", mapdb_path=str(tmp / "map.npz"),
                         K=K, H=H, W=W, n_frames=2,
                         **{f"frame{i}": frames[d][i + 1] for i in range(2)})
                procs.append(subprocess.Popen(
                    [sys.executable, str(tmp / "peer.py"),
                     str(tmp / f"state{d}.npz"), str(d), str(broker.port)],
                    cwd=str(repo), env=env,
                ))
            rc = [p.wait(timeout=1800) for p in procs]
            assert rc == [0, 0], rc
    print("both peers exited cleanly")


if __name__ == "__main__":
    main()
