"""Hierarchical two-stage relay exchange (parallel/hier.py): parity with
the legacy psum step (and hence the flat exchange, which has its own
parity suite), exactness under forced bucket overflow at either stage,
dedup/microbatch invariance, and the DCN-byte drop that is the whole point
(VERDICT r3 next #1)."""

import jax
import numpy as np
import pytest

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.models import get_model, strip_padding
from openkeonspark_tpu.parallel import (build_exchange_train_step,
                                        build_hier_train_step,
                                        build_sharded_train_step, make_mesh,
                                        shard_sampler, shard_state)
from openkeonspark_tpu.parallel.comm import collective_bytes
from openkeonspark_tpu.sampling.device import DeviceSampler
from openkeonspark_tpu.train.step import init_state

from test_exchange import LR, assert_match


@pytest.fixture(scope="module")
def kg_big():
    """Entity table > SMALL_TABLE_ROWS so entities ride the two-stage
    relay route (the production path)."""
    ds = random_kg(n_ent=2000, n_rel=6, n_triples=4000, n_valid=30,
                   n_test=30, seed=3)
    idx = build_kg_index(ds, for_eval=False)
    return ds, idx


@pytest.fixture(scope="module")
def kg_small():
    ds = random_kg(n_ent=100, n_rel=6, n_triples=1000, n_valid=30,
                   n_test=30, seed=2)
    idx = build_kg_index(ds, for_eval=False)
    return ds, idx


def run_pair(ds, idx, hier_shape, batch, model_name="transe", opt="sgd",
             steps=3, **cfg_kw):
    """Run the legacy psum step on the equivalent FLAT (H·Di, M) mesh and
    the hier step on the (H, Di, M) mesh with identical keys (the hier
    step folds keys by the global data index, so draws coincide)."""
    cfg_kw.setdefault("exchange_wire_dtype", "float32")
    h, di, m = hier_shape
    n = h * di * m
    cfg = Config(model=model_name, hidden_size=16, alpha=LR,
                 negative_ent=2, negative_rel=1, opt_method=opt, **cfg_kw)
    model = get_model(cfg.model)
    sampler = DeviceSampler.build(ds, idx)
    state = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                       pad_to_multiple=n)
    mesh_f = make_mesh((h * di, m))
    mesh_h = make_mesh(hier_shape)
    ss_f = shard_sampler(sampler, mesh_f)
    ss_h = shard_sampler(sampler, mesh_h)
    legacy = jax.jit(build_sharded_train_step(model, cfg, ss_f, batch,
                                              mesh_f))
    hier = jax.jit(build_hier_train_step(model, cfg, ss_h, batch, mesh_h))
    a = shard_state(state, mesh_f, flat=False)
    b = shard_state(state, mesh_h, flat=True)
    la = lb = None
    for i in range(steps):
        a, la = legacy(a, ss_f, jax.random.key(i))
        b, lb = hier(b, ss_h, jax.random.key(i))
    specs = model.tables(cfg, ds.n_ent, ds.n_rel)

    def out(st, loss):
        m_ = (strip_padding(st.opt_state["m"], specs)
              if opt == "adam" else None)
        return float(loss), strip_padding(st.params, specs), m_

    return out(a, la), out(b, lb)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("hier_shape", [(2, 2, 2), (2, 1, 4), (4, 1, 2)])
def test_hier_matches_legacy(kg_big, hier_shape, opt):
    """Identical draws ⇒ identical gathered rows / per-row gradients; only
    duplicate-id summation order differs (the relay pre-aggregates the
    host's update rows). (4,1,2) = 4 hosts of 2 chips; (2,1,4) has no
    inner data axis."""
    ds, idx = kg_big
    steps = 1 if opt == "adam" else 3
    (la, pa, ma), (lb, pb, _) = run_pair(ds, idx, hier_shape, batch=64,
                                         opt=opt, steps=steps)
    assert la == pytest.approx(lb, rel=1e-6)
    assert_match(pa, pb, ma, msg=f"{opt}/{hier_shape}")


def test_hier_small_table_path_matches_legacy(kg_small):
    """Tiny KG: both tables ride the grid-wide all_gather + dense psum
    route on the 3-axis grid."""
    ds, idx = kg_small
    (la, pa, _), (lb, pb, _) = run_pair(ds, idx, (2, 2, 2), batch=64)
    assert la == pytest.approx(lb, rel=1e-6)
    assert_match(pa, pb, msg="small-table")


@pytest.mark.parametrize("model_name", ["transr", "complex"])
def test_hier_matches_legacy_other_models(kg_big, model_name):
    ds, idx = kg_big
    (la, pa, _), (lb, pb, _) = run_pair(ds, idx, (2, 2, 2), batch=64,
                                        model_name=model_name)
    assert la == pytest.approx(lb, rel=1e-6)
    assert_match(pa, pb, msg=model_name)


def test_hier_overflow_fallback_is_exact(kg_big):
    """slack → 0 forces overflow at both relay stages: the success-flag
    propagation plus the grid-wide cond fallbacks must reproduce the
    legacy step exactly (gather re-serve + update fold-in)."""
    ds, idx = kg_big
    (la, pa, ma), (lb, pb, _) = run_pair(ds, idx, (2, 2, 2), batch=512,
                                         opt="adam", steps=1,
                                         exchange_slack=0.01)
    assert la == pytest.approx(lb, rel=1e-6)
    assert_match(pa, pb, ma, msg="overflow")


@pytest.mark.parametrize("dedup", ["off", "both"])
def test_hier_dedup_modes_match_legacy(kg_big, dedup):
    ds, idx = kg_big
    (la, pa, _), (lb, pb, _) = run_pair(ds, idx, (2, 2, 2), batch=64,
                                        exchange_dedup=dedup)
    assert la == pytest.approx(lb, rel=1e-6)
    assert_match(pa, pb, msg=f"dedup={dedup}")


def test_hier_microbatch_invariance(kg_big):
    ds, idx = kg_big
    (_, p1, _), (_, p2, _) = (
        run_pair(ds, idx, (2, 1, 4), batch=64,
                 exchange_microbatches=mb)[1]
        for mb in (1, 4))
    for k in p1:
        np.testing.assert_allclose(p1[k], p2[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_hier_dcn_bytes_drop_vs_flat(kg_big):
    """The point of the hierarchy: per-device DCN-classified wire bytes on
    an 8-device 2-host grid must drop ≥2.5× vs the flat exchange (rows
    cross DCN once per host, not once per device), while total wire may
    grow (cheap ICI absorbs the relay hops). The batch must be large
    relative to the table for the host-level dedup to bite (measured
    ratios on this KG: 1.2× at batch 256, 3.2× at 2048)."""
    ds, idx = kg_big
    cfg = Config(model="transe", hidden_size=64, negative_ent=2,
                 negative_rel=1, exchange_microbatches=1,
                 exchange_wire_dtype="float32")
    model = get_model(cfg.model)
    sampler = DeviceSampler.build(ds, idx)
    state = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                       pad_to_multiple=8)
    batch = 2048
    mesh_f = make_mesh((4, 2))
    mesh_h = make_mesh((2, 2, 2))
    ss_f = shard_sampler(sampler, mesh_f)
    ss_h = shard_sampler(sampler, mesh_h)
    flat = jax.jit(build_exchange_train_step(model, cfg, ss_f, batch,
                                             mesh_f))
    hier = jax.jit(build_hier_train_step(model, cfg, ss_h, batch, mesh_h))
    b_flat = collective_bytes(flat, shard_state(state, mesh_f, flat=True),
                              ss_f, jax.random.key(0), chips_per_host=4)
    b_hier = collective_bytes(hier, shard_state(state, mesh_h, flat=True),
                              ss_h, jax.random.key(0), chips_per_host=4)
    assert b_hier["wire_dcn"] * 2.5 <= b_flat["wire_dcn"], (b_flat, b_hier)
    assert b_hier["wire_dcn"] > 0          # it does cross hosts
    assert b_hier["wire_ici"] > 0          # relay hops ride ICI


def test_hier_ici_bf16_stage1_close_to_f32(kg_big):
    """exchange_ici_wire_dtype=bfloat16 quantizes the stage-1 (intra-host)
    update route; after 3 SGD steps the tables must track the f32 run at
    bf16 resolution (same bound family as the flat step's bf16-wire test)
    and the ICI collective bytes must drop."""
    ds, idx = kg_big
    (_, pf, _) = run_pair(ds, idx, (2, 2, 2), batch=64)[1]
    (_, pb, _) = run_pair(ds, idx, (2, 2, 2), batch=64,
                          exchange_ici_wire_dtype="bfloat16")[1]
    from test_exchange import LR, STEPS
    for k in pf:
        diff = np.abs(pf[k] - pb[k])
        rows, dim = pf[k].shape[0], pf[k].size // pf[k].shape[0]
        row_cap = max(2, int(0.01 * rows))
        tol = 0.02 * np.abs(pf[k]) + 0.01
        frac_out = float(np.mean(diff > tol))
        assert frac_out <= row_cap * dim / diff.size + 0.01, (k, frac_out)
        assert float(diff.max()) <= 2.0 * STEPS * LR, (k, float(diff.max()))
