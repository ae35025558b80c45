"""Test environment.

On the CPU (how the suite normally runs, with ``JAX_PLATFORMS=cpu``):
JAX gets 8 virtual CPU devices, so the sharding logic runs without
several accelerators, and Pallas kernels run through the interpreter.
Without ``JAX_PLATFORMS`` the tests also default to the CPU.

Tests marked ``gpu`` need the compiled kernels and skip elsewhere (the
``gpu`` fixture decides, at run time). They run on a GPU either with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` or from
``chip_smoke.py``, which runs them in its own process after JAX already
holds the card; this file then leaves JAX's set-up alone."""

import os

import jax
import pytest
from jax._src import xla_bridge

if not xla_bridge.backends_are_initialized():
    if "JAX_PLATFORMS" not in os.environ:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """Skip unless JAX's devices are GPUs (CUDA kernels have no CPU
    lowering)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: the compiled Triton kernel has "
                    "no CPU lowering (its interpret-mode twin runs here)")
