"""Synthetic multi-drone dataset generator.

The reference is driven by recorded image sequences on disk
(`img__Quad{id}_{frame:04d}.png`, InterfaceDisk.hpp:13-14); the generator
writes the same names as binary PGM. For tests and
benchmarks without dataset downloads (zero-egress environment) we generate
photometrically-consistent multi-view sequences: textured 3D planes (a
fenestrated near plane over a far plane) rendered with exact projective
warps, giving genuine parallax, stable FAST corners, and known ground-truth
poses — the same scene family used by the end-to-end verification drives.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from coloc_tpu.geometry import so3


class SyntheticScene(NamedTuple):
    textures: List[np.ndarray]   # per-plane texture (H, W)
    alphas: List[np.ndarray]     # per-plane visibility mask (H, W)
    depths: List[float]          # plane depths (z = const in world frame)
    K: np.ndarray                # (3, 3)


def smooth_texture(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Multi-octave value-noise texture with FAST-detectable structure."""
    img = np.zeros((h, w), np.float32)
    for cell, amp in [(8, 120.0), (16, 80.0), (32, 60.0)]:
        c = rng.uniform(0, 1, (h // cell + 2, w // cell + 2)).astype(np.float32)
        up = np.asarray(
            jax.image.resize(jnp.asarray(c), (h + cell, w + cell), method="linear")
        )
        img += amp * up[:h, :w]
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def make_scene(
    height: int, width: int, K: np.ndarray, seed: int = 0,
    depths: Tuple[float, float] = (6.0, 12.0), near_coverage: float = 0.45,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    tex = [smooth_texture(height, width, rng) for _ in depths]
    mask_coarse = (rng.uniform(0, 1, (6, 8)) < near_coverage).astype(np.float32)
    near_alpha = np.asarray(
        jax.image.resize(jnp.asarray(mask_coarse), (height, width), method="nearest")
    )
    alphas = [near_alpha] + [np.ones((height, width), np.float32)] * (len(depths) - 1)
    return SyntheticScene(textures=tex, alphas=alphas, depths=list(depths),
                          K=np.asarray(K, np.float32))


def _bilinear(img, x, y):
    h, w = img.shape
    x = np.clip(x, 0, w - 1.001)
    y = np.clip(y, 0, h - 1.001)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def render(scene: SyntheticScene, R: np.ndarray, C: np.ndarray) -> np.ndarray:
    """Render the scene from pose (R, C); z-buffered over the planes."""
    K = scene.K
    h, w = scene.textures[0].shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w, np.float32)])
    img = np.zeros(h * w, np.float32)
    best_z = np.full(h * w, 1e9, np.float32)
    n = np.array([0, 0, 1.0])
    t = -R @ C
    Kinv = np.linalg.inv(K)
    for tex, alpha, Z in zip(scene.textures, scene.alphas, scene.depths):
        Hm = K @ (R + np.outer(t, n) / Z) @ Kinv   # plane homography view1->this
        Hinv = np.linalg.inv(Hm)
        src = Hinv @ pts
        s = src[:2] / src[2]
        w1 = Kinv @ np.vstack([s, np.ones(h * w)]) * Z
        zc = (R @ (w1 - C[:, None]))[2]
        a = _bilinear(alpha, np.clip(s[0], 0, w - 1.01), np.clip(s[1], 0, h - 1.01))
        vis = (
            (s[0] >= 0) & (s[0] < w - 1) & (s[1] >= 0) & (s[1] < h - 1)
            & (zc > 0) & (zc < best_z) & (a > 0.5)
        )
        vals = _bilinear(tex, s[0], s[1])
        img = np.where(vis, vals, img)
        best_z = np.where(vis, zc, best_z)
    return img.reshape(h, w)


def trajectory(num_frames: int, drone: int, seed: int = 7):
    """Smooth per-drone ground-truth trajectory: (R (F,3,3), C (F,3))."""
    rng = np.random.default_rng(seed + drone)
    base = np.array([0.6 * drone, 0.1 * drone, 0.0], np.float32)
    Rs, Cs = [], []
    for f in range(num_frames):
        tpar = f / max(num_frames - 1, 1)
        w = np.array([
            0.02 * np.sin(2 * np.pi * tpar + drone),
            -0.05 * tpar,
            0.01 * np.cos(2 * np.pi * tpar),
        ], np.float32)
        C = base + np.array([0.5 * tpar, 0.1 * np.sin(2 * np.pi * tpar), 0.05 * tpar],
                            np.float32)
        Rs.append(np.asarray(so3.exp(jnp.asarray(w))))
        Cs.append(C)
    return np.stack(Rs), np.stack(Cs)


def write_dataset(
    folder: str, scene: SyntheticScene, num_drones: int, num_frames: int,
) -> dict:
    """Write `img__Quad{id}_{frame:04d}.pgm` sequences (InterfaceDisk
    naming, binary PGM so no image library is needed) + ground-truth poses.
    Returns {'Rs': (D,F,3,3), 'Cs': (D,F,3)}."""
    from coloc_tpu.io import disk

    os.makedirs(folder, exist_ok=True)
    gt_R = np.zeros((num_drones, num_frames, 3, 3), np.float32)
    gt_C = np.zeros((num_drones, num_frames, 3), np.float32)
    for d in range(num_drones):
        Rs, Cs = trajectory(num_frames, d)
        for f in range(num_frames):
            disk.write_pgm(disk.frame_path(folder, d, f, "pgm"),
                           render(scene, Rs[f], Cs[f]))
            gt_R[d, f] = Rs[f]
            gt_C[d, f] = Cs[f]
    np.savez(os.path.join(folder, "groundtruth.npz"), Rs=gt_R, Cs=gt_C)
    return {"Rs": gt_R, "Cs": gt_C}


def consistent_mapdb(feats, K: np.ndarray, num_landmarks: int,
                     rng: np.random.Generator,
                     depth_range: Tuple[float, float] = (5.0, 14.0)):
    """Geometrically CONSISTENT MapDB for a detected frame: the first kp
    landmarks sit on the frame's feature bearings at random depths
    (X = d * K^-1 [u, v, 1]) carrying the frame's own descriptors, and the
    remaining capacity is random far-away landmarks with random
    descriptors. Localizing the frame against this map runs the honest
    convergent P3P+LM path (a map whose 3D points contradict the matches
    makes LM burn its full reject budget instead — unrepresentative of
    per-frame localization against a real map). ONE recipe for every bench
    (bench.py main/_bench_akaze/_bench_capacity/_bench_map_scaling) and
    chip_smoke.py's serving map."""
    from coloc_tpu.types import MapDB

    kp = int(feats.xy.shape[0])
    L = int(num_landmarks)
    pad = max(L - kp, 0)
    uv = np.asarray(feats.xy)
    depths = rng.uniform(*depth_range, (kp, 1)).astype(np.float32)
    dirs = (np.linalg.inv(np.asarray(K))
            @ np.c_[uv, np.ones(kp)].T).T.astype(np.float32)
    X = np.concatenate(
        [dirs * depths, rng.uniform(-3, 3, (pad, 3)).astype(np.float32)],
        axis=0,
    )[:L]
    desc = jnp.concatenate([
        feats.desc,
        jnp.asarray(rng.integers(0, 2 ** 32, (pad, 16), dtype=np.uint64)
                    .astype(np.uint32)),
    ])[:L]
    return MapDB(X=jnp.asarray(X, jnp.float32), desc=desc,
                 valid=jnp.ones(L, bool))
