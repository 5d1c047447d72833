"""ctypes binding for the native C++ prefetching image loader.

Reference parity: the reference ingests frames with native C++ (OpenCV
imread, GPUDetector.hpp:161) synchronously; `coloc_tpu/native/loader.cpp`
is this framework's native ingest — PNG (zlib) / PGM decode plus an
asynchronous multi-threaded prefetcher so host decode overlaps device
compute.

Runs `make` on the first load of each process (g++ + zlib), which rebuilds
the shared library from the committed sources whenever they are newer;
callers fall back to the python path (io/disk) if the toolchain is
unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcoloc_loader.so")
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
                ["make", "-C", _NATIVE_DIR],
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
        lib.coloc_loader_open.restype = ctypes.c_void_p
        lib.coloc_loader_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.coloc_loader_get.restype = ctypes.c_int
        lib.coloc_loader_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.coloc_loader_close.argtypes = [ctypes.c_void_p]
        lib.coloc_decode_image.restype = ctypes.c_int
        lib.coloc_decode_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load_library() is not None


def decode_image(path: str, height: int, width: int) -> Optional[np.ndarray]:
    """Single-image native decode; None if unavailable/unsupported."""
    lib = _load_library()
    if lib is None:
        return None
    out = np.zeros((height, width), np.float32)
    rc = lib.coloc_decode_image(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width,
    )
    return out if rc == 0 else None


class NativeLoader:
    """Prefetching dataset loader over img__Quad{d}_{f:04d}.{png,pgm}.

    Frames are decoded ahead by worker threads in sequential order
    (frame-major, all drones per frame) — the session's access pattern.
    """

    def __init__(self, folder: str, num_drones: int, num_frames: int,
                 height: int, width: int, prefetch_depth: int = 8,
                 num_threads: int = 2):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable (build failed)")
        self._lib = lib
        self._h, self._w = height, width
        self._handle = lib.coloc_loader_open(
            folder.encode(), num_drones, num_frames, height, width,
            prefetch_depth, num_threads,
        )

    def get(self, drone: int, frame: int) -> np.ndarray:
        out = np.zeros((self._h, self._w), np.float32)
        rc = self._lib.coloc_loader_get(
            self._handle, drone, frame,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise IOError(f"failed to load drone={drone} frame={frame}")
        return out

    def close(self):
        if self._handle:
            self._lib.coloc_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
