"""Process set-up shared by the entry points (openkeonspark_tpu/runtime.py)
and the refusal of every timing entry point to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from openkeonspark_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's cache directory after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_config, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets nothing."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    cache_config):
    """Unset: a fixed directory inside the checkout, listed in
    .gitignore."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache") == runtime.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def _run(script_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    """On the CPU the smoke test exits non-zero and prints no result."""
    out = _run(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no GPU" in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, it fails
    and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0 and '"ok"' not in out.stdout
