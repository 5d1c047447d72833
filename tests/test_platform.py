"""Platform policy: the persistent compile cache follows the initialized
backend, and chip_smoke.py refuses to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from coloc_tpu import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("COLOC_COMPILE_CACHE", raising=False)
    return calls


class TestCompileCache:
    def test_cpu_stays_uncached(self, config_updates):
        assert jax.default_backend() == "cpu"
        assert compile_cache.enable() is None
        assert config_updates == {}

    def test_gpu_uses_env_dir_and_sets_no_other(self, config_updates,
                                                monkeypatch, tmp_path):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in config_updates
        assert config_updates["jax_persistent_cache_min_compile_time_secs"] == 0

    def test_gpu_default_is_fixed_dir_in_checkout(self, config_updates,
                                                  monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        path = compile_cache.enable()
        assert path == os.path.join(REPO, ".jax_cache")
        assert config_updates["jax_compilation_cache_dir"] == path
        ignored = open(os.path.join(REPO, ".gitignore")).read().split()
        assert ".jax_cache/" in ignored

    def test_opt_out(self, config_updates, monkeypatch):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setenv("COLOC_COMPILE_CACHE", "0")
        assert compile_cache.enable() is None
        assert config_updates == {}


class TestChipSmoke:
    def _run(self, cwd):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=600,
        )

    @staticmethod
    def _printed_result(stdout):
        for line in stdout.splitlines():
            try:
                if "ok" in json.loads(line):
                    return True
            except ValueError:
                pass
        return False

    def test_refuses_cpu(self):
        proc = self._run(REPO)
        assert proc.returncode != 0
        assert "no GPU found" in proc.stderr
        assert not self._printed_result(proc.stdout)

    def test_refuses_without_the_repository(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = self._run(str(tmp_path))
        assert proc.returncode != 0
        assert not self._printed_result(proc.stdout)
