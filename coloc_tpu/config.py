"""Declarative session configuration.

Reference parity: `colocParams.hpp:21-37` (per-drone K, distortion, geometric
model selector 'E'/'F'/'H', image size, folder) and the option structs in
`colocData.hpp:29-42` (DetectorOptions / MatcherOptions), whose values are
hardcoded in `src/coloc_node.cpp:73-89` (maxkp=5000, 8 levels @ 1.2x, FAST
threshold 40, Lowe ratio 0.8, Hamming margin 60, model 'E', 2 drones).

The reference selects CPU/GPU backends at compile time via #ifdef USE_CUDA;
here the detector backend is a runtime option, and every knob lives in
one frozen dataclass that hashes (so it can be a static jit argument).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DetectorOptions:
    """Feature frontend knobs (reference: colocData.hpp:29-36)."""

    width: int = 752
    height: int = 480
    max_keypoints: int = 1024          # reference maxkp=5000 (coloc_node.cpp:78)
    scale_factor: float = 1.2          # pyramid factor (coloc_node.cpp:79)
    num_levels: int = 8                # pyramid levels (coloc_node.cpp:80)
    fast_threshold: int = 40           # KFAST threshold (coloc_node.cpp:81)
    descriptor_bits: int = 512         # CLATCH-equivalent 512-bit binary descriptor
    smoothing_radius: int = 2          # box pre-smooth for triplet sampling
    border: int = 16                   # full-res keep-out border (scaled per level, floor 8)
    backend: str = "trip"              # "trip" (KORAL-equivalent) | "akaze" (AKAZE-MLDB parity)
    # AKAZE accuracy-vs-work frontier knobs (defaults = the reference
    # NORMAL preset, AKAZE.hpp:14-80). Octave count rides num_levels (num_levels // 2,
    # capped at 4 — so num_levels=6 gives 3 octaves).
    akaze_sublevels: int = 4           # sublevels per octave
    akaze_cell_samples: int = 4        # MLDB per-cell sample grid (n x n)
    akaze_fed_tau_max: float = 0.25    # FED base step (0.25 = 2-D stability
    #                                    bound; larger = fewer, coarser steps)


@dataclasses.dataclass(frozen=True)
class MatcherOptions:
    """Descriptor matching knobs (reference: colocData.hpp:38-42).

    `margin_threshold` implements CUDAK2NN's accept criterion
    `second_best - best > threshold` (CUDAK2NN.cu:16-21,75); `dist_ratio`
    implements the CPU path's Lowe ratio (CPUMatcher.hpp:58-59).
    """

    margin_threshold: int = 60         # coloc_node.cpp:85 (map match); pairwise default 40
    pair_margin_threshold: int = 40    # GPUMatcher.hpp pairwise default
    dist_ratio: float = 0.8            # Lowe ratio, CPU parity path
    mode: str = "margin"               # "margin" (KORAL parity) | "ratio" (AKAZE parity)


@dataclasses.dataclass(frozen=True)
class RansacOptions:
    """Robust-estimation budgets (reference: RobustMatcher.hpp:34, Localizer.hpp:84)."""

    num_hypotheses: int = 256          # RANSAC iteration budget
    inlier_multiple: float = 2.5       # accept iff inliers >= 2.5 x minimal sample
    # "nfa" = a-contrario adaptive-threshold scoring, the reference's
    # unconditional ACRANSAC path (RobustMatcher.hpp:161-171, Localizer.hpp:93);
    # "count" = fixed-threshold fallback (~2x cheaper P3P when latency-bound)
    scoring: str = "nfa"
    essential_threshold: float = 4.0   # px, symmetric epipolar distance
    p3p_threshold: float = 4.0         # px, reprojection
    homography_threshold: float = 4.0  # px, transfer error
    chirality_ratio: float = 0.7       # homography candidate disambiguation (RobustMatcher.hpp:100-103)


@dataclasses.dataclass(frozen=True)
class RefinerOptions:
    """Bundle-adjustment budgets (reference: Refiner.hpp:34-44,158-169)."""

    max_iterations: int = 100          # reference allows <=500 Ceres iters; GN converges far sooner
    tolerance: float = 1e-8
    huber_delta_sq: float = 16.0       # Huber loss delta^2 (Refiner.hpp:122)


@dataclasses.dataclass(frozen=True)
class FilterOptions:
    """Kalman filter bank knobs (reference: KalmanFilter.hpp:98-119)."""

    dt: float = 0.066
    process_noise: float = 1e-2
    measurement_noise: float = 1e-1
    initial_covariance: float = 1.0
    chi2_gate: float = 10.0            # gate threshold (KalmanFilter.hpp:155)
    # "energy" = reference-parity innv^T S innv (KalmanFilter.hpp:134-136
    # multiplies by S, not S^-1; at the reference noise values this only
    # rejects ~8 m teleports); "mahalanobis" = true chi-square innv^T S^-1
    # innv, where 10 ~ chi2(6) 88th percentile. See fusion/kalman.py.
    gate_mode: str = "energy"


@dataclasses.dataclass(frozen=True)
class ColocConfig:
    """Top-level session config (reference: colocParams.hpp + coloc_node.cpp main)."""

    num_drones: int = 2
    model: str = "E"                   # geometric model: 'E' / 'F' / 'H' (colocParams.hpp:24)
    image_folder: str = ""
    detector: DetectorOptions = dataclasses.field(default_factory=DetectorOptions)
    matcher: MatcherOptions = dataclasses.field(default_factory=MatcherOptions)
    ransac: RansacOptions = dataclasses.field(default_factory=RansacOptions)
    refiner: RefinerOptions = dataclasses.field(default_factory=RefinerOptions)
    filter: FilterOptions = dataclasses.field(default_factory=FilterOptions)
    max_landmarks: int = 4096          # fixed landmark-bank capacity
    max_tracks: int = 4096
    scale: float = 1.0                 # bootstrap baseline scale (Reconstructor.hpp:221)

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.detector.height, self.detector.width)


def default_intrinsics(config: ColocConfig) -> np.ndarray:
    """Per-drone K matrices, (num_drones, 3, 3). EuRoC-like defaults."""
    k = np.array(
        [[458.654, 0.0, 367.215],
         [0.0, 457.296, 248.375],
         [0.0, 0.0, 1.0]], dtype=np.float32)
    return np.broadcast_to(k, (config.num_drones, 3, 3)).copy()


def default_distortion(config: ColocConfig) -> np.ndarray:
    """Per-drone radial distortion (k1,k2,k3), (num_drones, 3)."""
    return np.zeros((config.num_drones, 3), dtype=np.float32)
