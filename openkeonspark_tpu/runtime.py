"""Process set-up shared by the entry points: the persistent XLA
compilation cache, and the device check of every code path that times
the device.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
sets nothing. Otherwise the cache goes to ``<checkout>/.jax_cache``: a
fixed path, because the directory is part of what the cache is keyed
on, so a path that moves between runs never hits."""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR


def require_gpu() -> dict:
    """Fail unless JAX's devices are GPUs: a timing taken elsewhere is not
    a device number. Returns the device as JAX reports it."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {len(devs)} {devs[0].platform} device(s) "
            f"({devs[0].device_kind}); refusing to time them")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
