"""Per-stage tracing / profiling.

Reference parity: the reference sprinkles std::chrono spans around every
stage and prints them to stdout (coloc.hpp:113-144, GPUDetector.hpp:162-165,
GPUMatcher.hpp:204-223 — SURVEY.md §5 'tracing'). This module provides the
same per-stage wall-time lines plus structured accumulation, and hooks into
`jax.profiler` for device traces.

Usage:
    prof = StageProfiler(enabled=True)
    with prof.stage("detect"):
        feats = detect_and_describe(img, opts)   # blocks on exit
    prof.report()

    with trace_to("/tmp/tpu_trace"):             # jax.profiler trace
        run_session(...)
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import jax


class StageProfiler:
    """Wall-clock spans per named stage; device-synchronized on exit."""

    def __init__(self, enabled: bool = True, sync: bool = True,
                 printer=None):
        self.enabled = enabled
        self.sync = sync
        self.printer = printer
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, result=None) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with jax.profiler.TraceAnnotation(name):
            yield
        if self.sync:
            # Flush the device queue: dispatch a trivial computation and block
            # on it — on a single device XLA executes enqueued computations in
            # order, so this waits for everything the stage dispatched.
            # (jax.effects_barrier only syncs EFFECTFUL computations and would
            # miss ordinary async dispatch.)
            import jax.numpy as _jnp

            jax.block_until_ready(_jnp.zeros(()) + 0.0)
        dt = time.perf_counter() - t0
        self.times[name].append(dt)
        if self.printer:
            self.printer(f"[{name}] {dt * 1e3:.2f} ms")

    def block_on(self, value):
        """Explicitly synchronize on a device value inside a stage."""
        jax.block_until_ready(value)
        return value

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            arr = sorted(ts)
            n = len(arr)
            out[name] = {
                "count": n,
                "total_ms": sum(arr) * 1e3,
                "mean_ms": sum(arr) / n * 1e3,
                "p50_ms": arr[n // 2] * 1e3,
                "max_ms": arr[-1] * 1e3,
            }
        return out

    def report(self, printer=print):
        for name, s in sorted(self.summary().items()):
            printer(
                f"{name:>24}: n={s['count']:4d} mean={s['mean_ms']:8.2f}ms "
                f"p50={s['p50_ms']:8.2f}ms max={s['max_ms']:8.2f}ms"
            )


@contextlib.contextmanager
def trace_to(log_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace context (viewable in TensorBoard/XProf)."""
    if not log_dir:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
