"""Fixed-capacity pytree data model.

Reference parity: `colocData.hpp` — the shared blackboard holding per-drone
feature regions, putative/geometric matches, relative poses, the SfM scene,
and the map descriptor database (`setupMapDatabase`, colocData.hpp:89-121).

Fixed-shape redesign: every variable-length container becomes a fixed-capacity
array plus a validity mask (SURVEY.md §7.1.1). Matches use the CUDAK2NN
convention of an int32 index per query with -1 for "no match"
(CUDAK2NN.cu:75), which is already fixed-shape.
All structures are registered pytrees so they flow through jit/vmap/shard_map.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

DESC_WORDS = 16  # 512-bit binary descriptors as 16 x uint32 lanes


class Features(NamedTuple):
    """Detected keypoints + binary descriptors for one image.

    Reference: AKAZE_Binary_Regions / KORAL keypoint output
    (GPUDetector.hpp:167-182 — coords rescaled by 1.2^scale, size 7*scale).
    """

    xy: jnp.ndarray        # (K, 2) float32, full-resolution pixel coords
    score: jnp.ndarray     # (K,) float32 detector response
    scale: jnp.ndarray     # (K,) int32 pyramid level
    angle: jnp.ndarray     # (K,) float32 orientation, radians
    desc: jnp.ndarray      # (K, DESC_WORDS) uint32 packed binary descriptor
    valid: jnp.ndarray     # (K,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


class Matches(NamedTuple):
    """2-NN match result, one entry per query descriptor.

    Reference: CUDAK2NN output (int per query, train index or -1,
    CUDAK2NN.cu:75) plus best/second distances for ratio-mode filtering.
    """

    idx: jnp.ndarray       # (Q,) int32 train index, -1 if rejected
    best: jnp.ndarray      # (Q,) int32 best Hamming distance
    second: jnp.ndarray    # (Q,) int32 second-best Hamming distance

    @property
    def mask(self) -> jnp.ndarray:
        return self.idx >= 0


class Pose(NamedTuple):
    """SE(3) pose stored as (rotation, center) — OpenMVG Pose3 convention.

    x_cam = R @ (X_world - C); translation t = -R @ C. The center-vs-
    translation duality is used throughout the reference (Refiner.hpp:234,
    Reconstructor.hpp:247-257) — we keep the same convention.
    """

    R: jnp.ndarray         # (3, 3)
    C: jnp.ndarray         # (3,)

    @property
    def t(self) -> jnp.ndarray:
        return -self.R @ self.C


class PoseWithCov(NamedTuple):
    """Pose + 6x6 covariance (rx,ry,rz,tx,ty,tz blocks) + fit quality.

    Reference: Cov6 = std::array<double,36> (colocData.hpp:19), filled from
    ceres::Covariance in Refiner.hpp:177-202; rmse + track count ride along
    in the CSV log schema (logUtils.hpp:90-96).
    """

    pose: Pose
    cov: jnp.ndarray       # (6, 6)
    rmse: jnp.ndarray      # () float32 reprojection RMSE
    n_tracks: jnp.ndarray  # () int32 inlier/track count
    success: jnp.ndarray   # () bool


class MapDB(NamedTuple):
    """Landmark map + resident descriptor bank.

    Reference: colocData.hpp:89-121 `setupMapDatabase` — flat descriptor bank
    built from the FIRST observation of each landmark plus a parallel
    landmark-id index; GPUMatcher keeps it device-resident (setMapData,
    GPUMatcher.hpp:110-117). Here the bank lives in HBM permanently.
    """

    X: jnp.ndarray         # (L, 3) float32 landmark positions
    desc: jnp.ndarray      # (L, DESC_WORDS) uint32 first-observation descriptors
    valid: jnp.ndarray     # (L,) bool

    @property
    def capacity(self) -> int:
        return self.X.shape[-2]

    @property
    def count(self) -> jnp.ndarray:
        return jnp.sum(self.valid.astype(jnp.int32))


class TwoViewGeometry(NamedTuple):
    """Output of robust two-view estimation (reference: RelativePose_Info)."""

    R: jnp.ndarray         # (3,3) relative rotation (cam1 <- cam2 frame motion)
    t: jnp.ndarray         # (3,) unit translation
    inliers: jnp.ndarray   # (M,) bool inlier mask over input matches
    n_inliers: jnp.ndarray # () int32
    success: jnp.ndarray   # () bool — inliers >= 2.5 x minimal sample gate


def empty_features(capacity: int) -> Features:
    return Features(
        xy=jnp.zeros((capacity, 2), jnp.float32),
        score=jnp.zeros((capacity,), jnp.float32),
        scale=jnp.zeros((capacity,), jnp.int32),
        angle=jnp.zeros((capacity,), jnp.float32),
        desc=jnp.zeros((capacity, DESC_WORDS), jnp.uint32),
        valid=jnp.zeros((capacity,), bool),
    )


def empty_mapdb(capacity: int) -> MapDB:
    return MapDB(
        X=jnp.zeros((capacity, 3), jnp.float32),
        desc=jnp.zeros((capacity, DESC_WORDS), jnp.uint32),
        valid=jnp.zeros((capacity,), bool),
    )
