"""Fused rank kernel (ops/pallas_rank.py): interpret-mode counts vs NumPy,
its scoring mirror, the full link-prediction kernel paths vs the plain
path, and the explicit choice between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval import link_prediction
from openkeonspark_tpu.models import get_model
from openkeonspark_tpu.ops.pallas_rank import (count_better,
                                               count_better_ref,
                                               residual_scores)
from openkeonspark_tpu.train.step import init_state


def _numpy_counts(s, gold, gold_ids):
    s = s.copy()
    s[np.arange(len(gold)), gold_ids] = np.inf  # gold masked in-kernel
    return (s < gold[:, None]).sum(1)


@pytest.mark.parametrize("transd", [False, True])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_count_kernel_matches_numpy_interpret(sign, p, transd):
    """Residual ``q + s·(e + c·u)``; 17 queries and 300 entities leave
    ragged tails in both tile axes, and table rows past n_ent (here 5)
    are never counted."""
    rng = np.random.default_rng(0)
    E, D, C = 300, 20, 17
    table = rng.normal(size=(E + 5, D)).astype(np.float32)
    q = rng.normal(size=(C, D)).astype(np.float32)
    u = rng.normal(size=(C, D)).astype(np.float32)
    cv = rng.normal(size=(E + 5,)).astype(np.float32)
    gold = rng.uniform(5, 15, size=C).astype(np.float32)
    gold_ids = rng.integers(0, E, C).astype(np.int32)
    got = np.asarray(count_better(
        jnp.asarray(q), jnp.asarray(table), jnp.asarray(gold),
        jnp.asarray(gold_ids), jnp.asarray(u) if transd else None,
        jnp.asarray(cv) if transd else None, sign=sign, p=p, n_ent=E,
        interpret=True, bq=16, be=64))
    e = table[None, :E]
    if transd:
        e = e + cv[None, :E, None] * u[:, None, :]
    r = q[:, None, :] + sign * e
    s = np.abs(r).sum(-1) if p == 1 else (r ** 2).sum(-1)
    np.testing.assert_array_equal(got, _numpy_counts(s, gold, gold_ids))
    ref = count_better_ref(
        jnp.asarray(q), jnp.asarray(table), jnp.asarray(gold),
        jnp.asarray(gold_ids), jnp.asarray(u) if transd else None,
        jnp.asarray(cv) if transd else None, sign=sign, p=p, n_ent=E,
        block=128)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_rotate_kernel_matches_numpy_interpret(sign):
    """RotatE modulus sweep: re|im halves, per-lane √(re² + im² + ε)."""
    rng = np.random.default_rng(5)
    E, d, C = 260, 10, 13
    table = rng.normal(size=(E, 2 * d)).astype(np.float32)
    q = rng.normal(size=(C, 2 * d)).astype(np.float32)
    gold = rng.uniform(8, 14, size=C).astype(np.float32)
    gold_ids = rng.integers(0, E, C).astype(np.int32)
    got = np.asarray(count_better(
        jnp.asarray(q), jnp.asarray(table), jnp.asarray(gold),
        jnp.asarray(gold_ids), sign=sign, p=1, n_ent=E, modulus=True,
        interpret=True, bq=16, be=64))
    r = q[:, None, :] + sign * table[None]
    s = np.sqrt(r[..., :d] ** 2 + r[..., d:] ** 2 + 1e-12).sum(-1)
    np.testing.assert_array_equal(got, _numpy_counts(s, gold, gold_ids))
    ref = count_better_ref(
        jnp.asarray(q), jnp.asarray(table), jnp.asarray(gold),
        jnp.asarray(gold_ids), sign=sign, p=1, n_ent=E, modulus=True,
        block=128)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("C,E", [(1, 1), (64, 64), (65, 129), (200, 1000)])
def test_count_kernel_tile_tails(C, E):
    """Query and candidate counts on, below and past tile edges (bq=64,
    be=64): the masked tails count exactly what the reference counts."""
    rng = np.random.default_rng(C + E)
    D = 12
    table = jnp.asarray(rng.normal(size=(E, D)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(C, D)).astype(np.float32))
    gold_ids = jnp.asarray(rng.integers(0, E, C).astype(np.int32))
    gold = residual_scores(q, jnp.take(table, gold_ids, 0), 1.0, 1)
    got = count_better(q, table, gold, gold_ids, sign=1.0, p=1, n_ent=E,
                       interpret=True, bq=64, be=64)
    ref = count_better_ref(q, table, gold, gold_ids, sign=1.0, p=1,
                           n_ent=E, block=64)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert int(np.asarray(got).max(initial=0)) <= E - 1


def test_residual_scores_match_dense():
    """The kernel's scoring mirror on [C] and [C, K] candidate rows."""
    rng = np.random.default_rng(3)
    C, K, D = 9, 5, 24
    q = rng.normal(size=(C, D)).astype(np.float32)
    u = rng.normal(size=(C, D)).astype(np.float32)
    rows1 = rng.normal(size=(C, D)).astype(np.float32)
    rows2 = rng.normal(size=(C, K, D)).astype(np.float32)
    c1 = rng.normal(size=(C,)).astype(np.float32)
    c2 = rng.normal(size=(C, K)).astype(np.float32)
    for sign in (-1.0, 1.0):
        got = residual_scores(jnp.asarray(q), jnp.asarray(rows2), sign, 1)
        want = np.abs(q[:, None] + sign * rows2).sum(-1)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)
        got = residual_scores(jnp.asarray(q), jnp.asarray(rows1), sign, 2,
                              jnp.asarray(u), jnp.asarray(c1))
        want = ((q + sign * (rows1 + c1[:, None] * u)) ** 2).sum(-1)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)
        got = residual_scores(jnp.asarray(q), jnp.asarray(rows2), sign, 1,
                              jnp.asarray(u), jnp.asarray(c2))
        want = np.abs(q[:, None] + sign * (rows2 + c2[..., None]
                                           * u[:, None])).sum(-1)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


def _setup(model_name, seed=3, n_ent=91, **kw):
    ds = random_kg(n_ent=n_ent, n_rel=7, n_triples=900, n_valid=40,
                   n_test=40, seed=seed)
    cfg = Config(model=model_name, eval_chunk=16, eval_block=32, **kw)
    idx = build_kg_index(ds, for_eval=True)
    state = init_state(get_model(model_name), cfg, ds.n_ent, ds.n_rel,
                       jax.random.key(8))
    return ds, cfg, idx, state.params


@pytest.mark.parametrize("model_name,kw", [
    ("transe", dict(hidden_size=16)),
    ("transe", dict(hidden_size=16, p_norm=2)),
    ("transd", dict(hidden_size=16)),
    ("rotate", dict(hidden_size=12)),
    ("transr", dict(hidden_size=16, ent_size=16, rel_size=8)),
    ("transh", dict(hidden_size=16)),
])
def test_kernel_path_matches_generic(model_name, kw):
    """Full evaluator through the kernel routes (interpret on CPU: the
    direct sweep for TransE/TransD/RotatE, the relation-grouped route for
    TransR/TransH) vs the plain XLA path — identical ranks."""
    ds, cfg, idx, params = _setup(model_name, **kw)
    res_generic = link_prediction(params, cfg, ds, idx)
    res_kernel = link_prediction(params, cfg, ds, idx, interpret=True)
    for k in res_generic.ranks:
        np.testing.assert_array_equal(res_kernel.ranks[k],
                                      res_generic.ranks[k],
                                      err_msg=f"{model_name}/{k}")


@pytest.mark.parametrize("model_name", ["transr", "transh"])
def test_grouped_path_bf16_close_to_f32(model_name):
    """eval_dtype='bfloat16' runs the grouped path's per-chunk projection
    matmul in bf16; ranks may move where scores are within bf16 noise but
    must stay CLOSE — mean absolute rank drift bounded at a few % of the
    candidate count."""
    ds, cfg, idx, params = _setup(model_name, seed=11, n_ent=89,
                                  hidden_size=16, ent_size=16, rel_size=8)
    res_f32 = link_prediction(params, cfg, ds, idx, interpret=True)
    res_bf16 = link_prediction(params, cfg.replace(eval_dtype="bfloat16"),
                               ds, idx, interpret=True)
    for k in res_f32.ranks:
        drift = np.abs(res_bf16.ranks[k].astype(np.int64)
                       - res_f32.ranks[k].astype(np.int64))
        assert drift.mean() <= 0.05 * ds.n_ent, (
            f"{model_name}/{k}: mean rank drift {drift.mean():.2f} "
            f"exceeds 5% of {ds.n_ent} candidates")


@pytest.mark.parametrize("interpret,use_pallas_eval,expect", [
    (False, True, False),    # CPU without interpret: plain path
    (True, True, True),      # interpret: kernel path
    (True, False, False),    # the config selects the plain path anywhere
])
def test_kernel_choice_is_explicit(monkeypatch, interpret, use_pallas_eval,
                                   expect):
    """The kernel runs only on the GPU or with ``interpret=True``; on the
    CPU the plain path runs, and no environment variable changes that."""
    import importlib
    lp = importlib.import_module("openkeonspark_tpu.eval.link_prediction")
    from openkeonspark_tpu.ops import pallas_rank
    calls = []
    real = pallas_rank.count_better

    def spy(*a, **k):
        calls.append(k["interpret"])
        return real(*a, **k)

    monkeypatch.setattr(pallas_rank, "count_better", spy)
    ds, cfg, idx, params = _setup("transe", hidden_size=8)
    cfg = cfg.replace(use_pallas_eval=use_pallas_eval)
    assert lp._use_kernel(cfg, interpret) == expect
    link_prediction(params, cfg, ds, idx, interpret=interpret)
    assert bool(calls) == expect and all(calls)


def test_near_tie_counts():
    """A candidate whose row equals the gold row ties exactly and counts;
    with distinct random rows at this size nothing else is that close."""
    from openkeonspark_tpu.eval.link_prediction import near_tie_counts
    ds, cfg, idx, params = _setup("transe", hidden_size=16)
    tri = ds.test[:8]
    base = near_tie_counts(params, cfg, tri, "tail")
    assert (base == 0).all(), base
    E = params["ent_embeddings"]
    twin = (int(tri[0, 1]) + 1) % ds.n_ent
    params = dict(params, ent_embeddings=E.at[twin].set(E[int(tri[0, 1])]))
    near = near_tie_counts(params, cfg, tri, "tail")
    assert near[0] >= 1 and (near[1:] <= base[1:] + 1).all(), near
