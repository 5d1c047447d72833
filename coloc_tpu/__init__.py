"""coloc_tpu — collaborative visual localization framework in JAX.

A greenfield JAX/XLA/Pallas re-design of the capabilities of saihv/coloc
(CoLoC: collaborative localization for micro aerial vehicles). The reference
is a host-driven C++/CUDA pipeline; this framework keeps all per-frame math
resident on device with fixed shapes and validity masks, batches every
irregular loop (RANSAC hypotheses, keypoints, landmarks, drones), and shards
the drone axis over a `jax.sharding.Mesh`.

Module map (reference parity noted per module docstring):
  config      — declarative session config (reference: colocParams.hpp, colocData.hpp options)
  types       — fixed-capacity pytree data model (reference: colocData.hpp)
  geometry/   — SO3/SE3, cameras, triangulation, minimal solvers
  ransac      — batched AC-RANSAC harness (reference: RobustMatcher.hpp)
  ops/        — XLA ops + the Pallas (Triton) Hamming 2-NN kernel: pyramid, FAST, descriptors
  frontend    — detect+describe pipeline (reference: GPUDetector.hpp / KORAL)
  matching    — descriptor matching APIs (reference: FeatureMatcher/CPUMatcher/GPUMatcher)
  sfm/        — tracks, triangulation, bundle adjustment, localization
  fusion/     — Kalman filter bank, inverse covariance intersection
  parallel/   — drone-axis mesh sharding and collectives
  io/         — disk ingest, calibration parsing, CSV/PLY logging
  session     — orchestrator (reference: coloc.hpp ColoC)
  serving     — batched multi-stream localization server (ServingEngine)
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry code is precision-critical: on the GPU, float32 matmuls/einsums
# may run in TF32 (about three decimal digits) under the DEFAULT matmul
# precision, which degrades triangulation, P3P triads and BA normal
# equations. Force full f32, which holds the geometry to CPU-grade results.
# The Hamming matcher is unaffected: its int8 dot_general with int32
# accumulation passes its own precision.
_jax.config.update("jax_default_matmul_precision", "highest")

# The persistent compilation cache (coloc_tpu/compile_cache.py) is turned on
# by the entry points once the platform is chosen: enabling it here would
# initialize the backend on import.
from coloc_tpu.config import (  # noqa: F401
    ColocConfig,
    DetectorOptions,
    MatcherOptions,
)
