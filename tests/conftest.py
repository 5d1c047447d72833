"""Test harness: run on CPU with 8 virtual devices so multi-device sharding
paths are exercised without GPUs (SURVEY.md §4 test plan). Kernels run in
the Pallas interpreter where a test passes interpret=True; tests marked
`gpu` need a card and skip elsewhere:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# jax may already be imported by a plugin, so env vars alone can be too
# late — set the platform through the config as well.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran before it
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """Skip unless JAX runs on a GPU; decided when the test runs, never at
    import or collection time."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
