"""Batched map-localization serving: B independent camera streams
matched + localized against ONE device-resident map bank per dispatch.

This is the deployment shape for "many cameras, one map": the bank is
packed once (the reference's resident `setMapData` pattern,
GPUMatcher.hpp:110-117), and each call runs the batched frontend + 2-NN +
P3P + refine for all B streams fused into a single device program.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root (no install needed)


import jax
import numpy as np

from coloc_tpu import serving
from coloc_tpu.config import ColocConfig, DetectorOptions
from coloc_tpu.geometry import camera as cam_ops
from coloc_tpu.io import synthetic
from coloc_tpu.session import ColocSession

H, W = 240, 320
K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
B = 4  # streams per dispatch


def main():
    # --- build a map once with a 2-drone session --------------------------
    scene = synthetic.make_scene(H, W, K, seed=3)
    config = ColocConfig(
        num_drones=2,
        detector=DetectorOptions(width=W, height=H, max_keypoints=512,
                                 num_levels=4, fast_threshold=10),
        max_landmarks=512,
    )
    Rs0, Cs0 = synthetic.trajectory(2, 0)
    Rs1, Cs1 = synthetic.trajectory(2, 1)
    session = ColocSession(config, np.stack([K, K]), np.zeros((2, 3), np.float32))
    session.init_map({0: synthetic.render(scene, Rs0[0], Cs0[0]),
                      1: synthetic.render(scene, Rs1[0], Cs1[0])})
    print(f"map: {int(np.asarray(session.mapdb.valid).sum())} landmarks")

    # --- serve B query streams against the resident bank ------------------
    cam = cam_ops.Camera(K=K, dist=np.zeros(3, np.float32))
    engine = serving.ServingEngine(session.mapdb, cam, config)

    # B frames along drone 0's trajectory (novel viewpoints near the map)
    Rs, Cs = synthetic.trajectory(B, 0)
    images = np.stack([synthetic.render(scene, Rs[i], Cs[i])
                       for i in range(B)])

    pwc, _, _ = engine.localize_frames(images, jax.random.PRNGKey(0))
    C_est = np.asarray(pwc.pose.C)
    for i in range(B):
        err = np.linalg.norm(C_est[i] - Cs[i])
        print(f"stream {i}: success={bool(pwc.success[i])}  "
              f"inliers={int(pwc.n_tracks[i])}  center error={err:.3f}")


if __name__ == "__main__":
    main()
