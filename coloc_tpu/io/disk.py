"""Disk ingest + calibration parsing.

Reference parity:
  InterfaceDisk.hpp — builds filename `img__Quad{id}_{frame:04d}.png` from
    folder + frame counter (:13-14), reads, runs detection, registers views.
  coloc_node.cpp:5-51 readCalibData — calib.txt CSV: first line image size
    `w,h`, then per-drone 9 values of K (row-major), then per-drone 3 radial
    distortion values.

Host-side on purpose: image decode and filename logic stay off-device
(SURVEY.md §7.4.6 — keep the per-frame device round-trip count at ~1).
Binary PGM (P5) is read and written with numpy alone; PNG and JPEG (real
datasets) go through Pillow.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def frame_path(folder: str, drone: int, frame: int, ext: str = "png") -> str:
    return os.path.join(folder, f"img__Quad{drone}_{frame:04d}.{ext}")


def write_pgm(path: str, image: np.ndarray) -> None:
    """Write a grayscale image as 8-bit binary PGM (P5), values clipped to
    [0, 255] and truncated like a uint8 cast."""
    img = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P5\n{w} {h}\n255\n".encode("ascii"))
        fh.write(img.tobytes())


def read_pgm(path: str) -> np.ndarray:
    """8-bit binary PGM (P5) -> (H, W) uint8 array."""
    with open(path, "rb") as fh:
        data = fh.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":            # comment to end of line
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    w, h, maxval = (int(f) for f in fields[1:])
    if fields[0] != b"P5" or maxval > 255:
        raise ValueError(f"{path}: not an 8-bit binary PGM")
    pix = np.frombuffer(data, np.uint8, count=w * h, offset=pos + 1)
    return pix.reshape(h, w)


def load_image(path: str) -> np.ndarray:
    """Grayscale float32 (H, W) in [0, 255]."""
    if path.endswith(".npy"):
        img = np.load(path)
    elif path.endswith(".pgm"):
        img = read_pgm(path)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"))
    return img.astype(np.float32)


def load_frame(folder: str, drone: int, frame: int) -> np.ndarray:
    for ext in ("pgm", "png", "npy", "jpg"):
        p = frame_path(folder, drone, frame, ext)
        if os.path.exists(p):
            return load_image(p)
    raise FileNotFoundError(frame_path(folder, drone, frame))


def num_frames(folder: str, drone: int = 0) -> int:
    f = 0
    while True:
        if not any(
            os.path.exists(frame_path(folder, drone, f, ext))
            for ext in ("png", "pgm", "npy", "jpg")
        ):
            return f
        f += 1


def read_calib(path: str, num_drones: int) -> Tuple[Tuple[int, int], np.ndarray, np.ndarray]:
    """calib.txt -> ((width, height), Ks (D,3,3), dists (D,3)).

    Format (readCalibData parity, coloc_node.cpp:5-51): comma-separated
    values; line 1 = image size, next D lines = 9 K entries each, next D
    lines = 3 distortion entries each.
    """
    with open(path) as fh:
        rows = [
            [float(x) for x in line.replace(",", " ").split()]
            for line in fh
            if line.strip()
        ]
    size = (int(rows[0][0]), int(rows[0][1]))
    Ks = np.stack(
        [np.asarray(rows[1 + d], np.float32).reshape(3, 3) for d in range(num_drones)]
    )
    dists = np.stack(
        [np.asarray(rows[1 + num_drones + d], np.float32) for d in range(num_drones)]
    )
    return size, Ks, dists


def write_calib(path: str, size: Tuple[int, int], Ks: np.ndarray, dists: np.ndarray):
    with open(path, "w") as fh:
        fh.write(f"{size[0]},{size[1]}\n")
        for K in Ks:
            fh.write(",".join(str(float(v)) for v in np.asarray(K).reshape(-1)) + "\n")
        for d in dists:
            fh.write(",".join(str(float(v)) for v in np.asarray(d)) + "\n")
