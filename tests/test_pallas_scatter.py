"""Row scatter-add of the optimizers (train/optim.py::scatter_add_rows):
wide and narrow rows against a sorted-order NumPy oracle, sentinel
discards, duplicates, and which route a table takes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openkeonspark_tpu.train.optim import (MATMUL_SCATTER_MAX_ROWS,
                                           scatter_add_rows)


def oracle(table, ids, delta):
    out = np.asarray(table).copy()
    for i in np.argsort(np.asarray(ids), kind="stable"):
        if ids[i] < table.shape[0]:
            out[ids[i]] += np.asarray(delta)[i]
    return out


@pytest.mark.parametrize("R,W,N", [(537, 256, 200), (611, 4096, 5),
                                   (64, 384, 1), (16, 200, 64),
                                   (700, 20000, 33)])
def test_scatter_matches_oracle(R, W, N):
    """Duplicates sum; sentinel ids (≥ R) are discarded; both routes
    (one-hot matmul below MATMUL_SCATTER_MAX_ROWS rows, scatter above)
    and TransR-wide rows (20 000) included."""
    rng = np.random.default_rng(R + N)
    table = jnp.asarray(rng.normal(size=(R, W)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, R + 1, size=N), jnp.int32)
    delta = jnp.asarray(rng.normal(size=(N, W)), jnp.float32)
    out = scatter_add_rows(table, ids, delta)
    np.testing.assert_allclose(np.asarray(out), oracle(table, ids, delta),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("R", [9, 900])
def test_scatter_all_sentinel_is_noop(R):
    table = jnp.ones((R, 128), jnp.float32)
    ids = jnp.full((17,), R, jnp.int32)
    delta = jnp.full((17, 128), 5.0, jnp.float32)
    out = scatter_add_rows(table, ids, delta)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(table))


def test_scatter_heavy_duplicates():
    """One hot row taking most of the stream plus singles, on wide rows."""
    rng = np.random.default_rng(3)
    R, W, N = 800, 4096, 100
    table = jnp.zeros((R, W), jnp.float32)
    ids = np.full(N, 2, np.int32)
    ids[::10] = rng.integers(0, R, size=len(ids[::10]))
    ids = jnp.asarray(ids)
    delta = jnp.asarray(rng.normal(size=(N, W)), jnp.float32)
    out = scatter_add_rows(table, ids, delta)
    np.testing.assert_allclose(np.asarray(out), oracle(table, ids, delta),
                               rtol=1e-5, atol=1e-5)


def test_scatter_route_by_rows():
    """Tables up to MATMUL_SCATTER_MAX_ROWS rows take the one-hot matmul,
    larger ones the scatter, whatever the row width."""
    def prims(rows, width):
        jaxpr = jax.make_jaxpr(scatter_add_rows)(
            jnp.zeros((rows, width)), jnp.zeros((8,), jnp.int32),
            jnp.zeros((8, width)))
        return {e.primitive.name for e in jaxpr.jaxpr.eqns}

    small = prims(MATMUL_SCATTER_MAX_ROWS, 8)
    assert "dot_general" in small and "scatter-add" not in small
    for width in (8, 20000):
        big = prims(MATMUL_SCATTER_MAX_ROWS + 1, width)
        assert "scatter-add" in big and "dot_general" not in big
