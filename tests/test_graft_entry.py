"""The driver-facing entry points must never rot: entry() must jit on one
device and dryrun_multichip() must pass both on an existing 8-device mesh
and on a 1-device host (the bench-machine scenario, via subprocess re-exec).
"""

import os
import subprocess
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_jits_single_chip():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    C, R, cov, success = out
    assert C.shape == (3,) and R.shape == (3, 3) and cov.shape == (6, 6)
    assert np.isfinite(np.asarray(C)).all()


def test_dryrun_multichip_inline_8dev():
    # conftest provisions 8 virtual CPU devices -> runs the inline path
    graft.dryrun_multichip(8)


def test_dryrun_multichip_reexec_from_one_device():
    # Simulate the 1-chip bench machine: a subprocess with no virtual-device
    # flag sees 1 CPU device, so dryrun_multichip(8) must take the re-exec
    # branch and still succeed.
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) == 1, jax.devices()\n"
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
        "print('REEXEC_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=1800,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "REEXEC_OK" in proc.stdout


def test_cpu_env_gives_n_cpu_devices():
    """The re-exec child environment is a plain CPU one: a process started
    with it sees exactly n virtual CPU devices."""
    env = graft._cpu_env(8)
    assert env["JAX_PLATFORMS"] == "cpu"
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices(); print(len(d), d[0].platform)"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["8", "cpu"], proc.stdout
