"""Card-only checks: the rank kernel as compiled for the GPU against its
plain-XLA references. On the CPU these skip (the ``gpu`` fixture); their
interpret-mode twins are in test_pallas_rank.py.

Tolerances. Kernel vs its same-order reference: ranks identical on
≥ 99.9% of queries and never more than 1 apart. Evaluator vs the plain
path, whose sums run in another order: every rank difference explained
by float near-ties (``near_tie_counts``), MRR and Hits@10 within 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval import link_prediction
from openkeonspark_tpu.eval.link_prediction import near_tie_counts
from openkeonspark_tpu.models import get_model
from openkeonspark_tpu.ops.pallas_rank import (count_better,
                                               count_better_ref,
                                               residual_scores)
from openkeonspark_tpu.train.step import init_state

pytestmark = pytest.mark.gpu


def _agree(a, b):
    d = np.abs(np.asarray(a).astype(np.int64) - np.asarray(b))
    assert (d == 0).mean() >= 0.999 and d.max(initial=0) <= 1, (
        float((d == 0).mean()), int(d.max(initial=0)))


@pytest.mark.parametrize("form", ["transe", "transd", "rotate"])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_compiled_kernel_matches_reference(gpu, form, sign):
    """A 256-query chunk against 14,541 entities at d=200 (RotatE: 100
    complex lanes): compiled kernel vs the same-order XLA reference."""
    rng = np.random.default_rng(1)
    E, D, C = 14541, 200, 256
    table = jnp.asarray(rng.normal(size=(E, D)).astype(np.float32))
    q = jnp.asarray(rng.normal(size=(C, D)).astype(np.float32))
    gid = jnp.asarray(rng.integers(0, E, C).astype(np.int32))
    u = cv = None
    if form == "transd":
        u = jnp.asarray(rng.normal(size=(C, D)).astype(np.float32))
        cv = jnp.asarray(rng.normal(size=(E,)).astype(np.float32))
    kw = dict(sign=sign, p=1, n_ent=E, modulus=form == "rotate")
    gold = residual_scores(q, jnp.take(table, gid, 0), sign, 1, u,
                           None if cv is None else jnp.take(cv, gid),
                           kw["modulus"])
    got = count_better(q, table, gold, gid, u, cv, **kw)
    ref = count_better_ref(q, table, gold, gid, u, cv, **kw)
    _agree(got, ref)


@pytest.mark.parametrize("model_name", ["transe", "transd", "rotate",
                                        "transr", "transh"])
def test_compiled_kernel_paths_match_plain(gpu, model_name):
    """Full evaluator: kernel routes vs the plain sweep on the card."""
    ds = random_kg(n_ent=500, n_rel=7, n_triples=5000, n_valid=100,
                   n_test=200, seed=3)
    cfg = Config(model=model_name, hidden_size=32, ent_size=32,
                 rel_size=16, eval_chunk=64)
    idx = build_kg_index(ds, for_eval=True)
    params = init_state(get_model(model_name), cfg, ds.n_ent, ds.n_rel,
                        jax.random.key(8)).params
    plain = cfg.replace(use_pallas_eval=False)
    res_k = link_prediction(params, cfg, ds, idx)
    res_p = link_prediction(params, plain, ds, idx)
    for direction in ("head", "tail"):
        near = near_tie_counts(params, plain, ds.test, direction)
        for mode in ("raw", "filt"):
            k = f"{mode}_{direction}"
            delta = np.abs(res_k.ranks[k] - res_p.ranks[k])
            assert (delta <= near).all(), (k, delta.max(), near.max())
    assert abs(res_k.filt_avg.mrr - res_p.filt_avg.mrr) <= 1e-3
    assert abs(res_k.filt_avg.hits10 - res_p.filt_avg.hits10) <= 1e-3
