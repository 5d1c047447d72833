"""Persistent XLA compilation cache — ONE implementation for the library.

JAX's persistent compilation cache turns a repeat launch's jit compiles
(the session and serving graphs take tens of seconds cold) into disk reads.
The entry points (`cli.py`, `serve.py`, `bench.py`, `chip_smoke.py`) call
`enable()` once the platform is chosen; it is idempotent.

Policy:
  - GPU only. `enable()` asks JAX for the initialized backend and turns the
    cache on only when it is the GPU. CPU sessions always compile fresh:
    cached XLA:CPU AOT results can reload with mismatched machine-feature
    baselines.
  - JAX_COMPILATION_CACHE_DIR set (or jax_compilation_cache_dir configured
    in code): JAX uses that directory and this module sets no other.
  - Otherwise: `<checkout>/.jax_cache`, one fixed directory inside the
    checkout (listed in .gitignore), so repeat launches find their entries.
  - COLOC_COMPILE_CACHE=0 opts out.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str | None:
    """Turn on JAX's persistent compilation cache on a GPU backend.

    Initializes the JAX backend. Returns the cache directory in use, or None
    when disabled or not on a GPU."""
    if os.environ.get("COLOC_COMPILE_CACHE", "1") in ("0", "false", "no"):
        return None

    import jax

    if jax.default_backend() != "gpu":
        return None
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or jax.config.jax_compilation_cache_dir)
    if not path:
        path = CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program: the session/serving graphs are all worth
    # keeping, and small entries are cheap
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
