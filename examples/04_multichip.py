"""The drone axis as a device-mesh axis: run the full collaborative step
(per-drone intra localization + Kalman update, then the complete
inter-drone exchange — descriptor-bank ppermute, pairwise match,
relative pose, temporary reconstruction, scale alignment, pose-only
refine, covariance intersection) sharded over an 8-device mesh.

With fewer than 8 devices this re-execs itself onto 8 virtual CPU devices
(the same mechanism the test suite and the multi-device dry-run use); on 8
GPUs the identical program runs its collectives over NVLink.

Reference analog: the robots' ROS topic exchange (SURVEY §2.2) — here the
collective carries ~64 B/keypoint of descriptors plus pose + covariance.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root (no install needed)


import os
import subprocess
import sys

N_DEVICES = 8


def run_mesh():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from coloc_tpu.config import ColocConfig, DetectorOptions, RansacOptions
    from coloc_tpu.fusion import kalman
    from coloc_tpu.io import synthetic
    from coloc_tpu.parallel import mesh as pmesh
    from coloc_tpu.sfm import reconstruct
    from coloc_tpu.session import ColocSession

    H, W = 120, 160
    K = np.array([[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]], np.float32)

    # one shared scene; each mesh device is one drone with its own viewpoint
    scene = synthetic.make_scene(H, W, K, seed=3)
    config = ColocConfig(
        num_drones=N_DEVICES,
        detector=DetectorOptions(width=W, height=H, max_keypoints=256,
                                 num_levels=3, fast_threshold=10),
        ransac=RansacOptions(num_hypotheses=128),
        max_landmarks=512,
    )

    # bootstrap a shared map from drones 0+1, host-side (the per-event path)
    import dataclasses
    boot = ColocSession(
        dataclasses.replace(config, num_drones=2),
        np.broadcast_to(K, (2, 3, 3)), np.zeros((2, 3), np.float32),
    )
    views = {}
    for d in range(N_DEVICES):
        Rs, Cs = synthetic.trajectory(2, d % 4)
        views[d] = [synthetic.render(scene, Rs[f], Cs[f]) for f in range(2)]
    boot.init_map({0: views[0][0], 1: views[1][0]})
    mapdb = boot.mapdb
    print(f"shared map: {int(np.asarray(mapdb.valid).sum())} landmarks")

    # the sharded collaborative step: drone-sharded frames, replicated map
    m = pmesh.make_mesh(jax.devices()[:N_DEVICES])
    step = pmesh.collaborative_step(m, config, inter="full")

    images = jnp.asarray(np.stack([views[d][1] for d in range(N_DEVICES)]),
                         jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), N_DEVICES)
    fb = kalman.init(N_DEVICES, config.filter)
    args = pmesh.shard_inputs(
        m, keys, images, jnp.broadcast_to(jnp.asarray(K), (N_DEVICES, 3, 3)),
        jnp.zeros((N_DEVICES, 3)), fb, mapdb,
    )
    fb2, pos, cov, fused_pos, fused_cov, inter_ok = step(*args)
    jax.block_until_ready(fused_pos)

    print(f"mesh: {m.shape}  devices: {[str(d) for d in m.devices.flat][:2]}...")
    for d in range(N_DEVICES):
        print(f"drone {d}: pos={np.asarray(pos[d]).round(2)}  "
              f"inter_ok={bool(inter_ok[d])}  "
              f"fused cov trace={float(np.trace(np.asarray(fused_cov[d]))):.4f}")


def main():
    import jax

    if len(jax.devices()) >= N_DEVICES:
        run_mesh()
        return
    # too few devices: re-exec with a virtual CPU mesh (env must be set
    # before the JAX backend initializes)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={N_DEVICES}").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["COLOC_EXAMPLE_MESH_CHILD"] = "1"
    print(f"(single device found - re-running on {N_DEVICES} virtual CPU devices)")
    sys.exit(subprocess.run([sys.executable, os.path.abspath(__file__)],
                            env=env).returncode)


if __name__ == "__main__":
    if os.environ.get("COLOC_EXAMPLE_MESH_CHILD"):
        import jax
        jax.config.update("jax_platforms", "cpu")
        run_mesh()
    else:
        main()
