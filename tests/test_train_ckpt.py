"""Training loop, early stopping, checkpoint/resume, incremental warm
start, export — end-to-end on small synthetic KGs."""

import json
import os

import jax
import numpy as np
import pytest

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import planted_kg, random_kg
from openkeonspark_tpu.models import get_model, strip_padding
from openkeonspark_tpu.train.loop import train
from openkeonspark_tpu.train.step import init_state


def small_cfg(**kw):
    base = dict(model="transe", hidden_size=16, alpha=0.05, margin=1.0,
                negative_ent=2, negative_rel=0, nbatches=10, train_times=5,
                steps_per_scan=4, log_every=100)
    base.update(kw)
    return Config(**base)


def test_train_loss_decreases():
    ds = random_kg(n_ent=120, n_rel=8, n_triples=1500, n_valid=50, n_test=50,
                   seed=5)
    cfg = small_cfg(train_times=8)
    res = train(cfg, ds, echo=lambda *_: None)
    assert len(res.history) == 8
    assert res.history[-1].loss < res.history[0].loss
    assert res.history[-1].triples_per_sec > 0


def test_planted_structure_is_learned():
    """End-to-end quality oracle: on a KG generated by a hidden TransE
    model, training must push filtered Hits@10 far above chance."""
    ds = planted_kg(n_ent=300, n_rel=8, n_triples=6000, n_valid=200,
                    n_test=200, dim=8, noise=0.0, seed=1)
    cfg = small_cfg(hidden_size=32, train_times=30, alpha=0.1, margin=2.0,
                    nbatches=20, eval_chunk=32, eval_block=64)
    res = train(cfg, ds, echo=lambda *_: None)

    from openkeonspark_tpu.eval import link_prediction
    idx = build_kg_index(ds, for_eval=True)
    lp = link_prediction(res.state.params, cfg, ds, idx)
    chance = 10.0 / ds.n_ent  # ≈ 0.033
    assert lp.filt_avg.hits10 > 10 * chance, lp.format_table()


def test_early_stopping_fires():
    ds = random_kg(n_ent=80, n_rel=6, n_triples=800, n_valid=60, n_test=40,
                   seed=9)
    calls = []

    def fake_valid(state):
        calls.append(1)
        return 0.5  # never improves after the first check

    cfg = small_cfg(train_times=50, valid_every=1, early_stop_patience=2)
    res = train(cfg, ds, valid_fn=fake_valid, echo=lambda *_: None)
    assert res.stopped_early
    assert len(res.history) < 50
    assert len(calls) >= 3


def test_checkpoint_roundtrip(tmp_path):
    ds = random_kg(n_ent=60, n_rel=5, n_triples=600, n_valid=20, n_test=20,
                   seed=4)
    cfg = small_cfg(train_times=2, opt_method="adam")
    ck = str(tmp_path / "ck")
    res = train(cfg, ds, checkpoint_dir=ck, echo=lambda *_: None)

    from openkeonspark_tpu.ckpt import CheckpointManager, latest_step
    model = get_model(cfg.model)
    step = latest_step(ck)
    assert step == int(res.state.step)
    fresh = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(99))
    restored, manifest = CheckpointManager(ck).restore(fresh)
    assert int(restored.step) == step
    for k in res.state.params:
        np.testing.assert_array_equal(np.asarray(restored.params[k]),
                                      np.asarray(res.state.params[k]))
    for mv in ("m", "v"):
        for k in res.state.opt_state[mv]:
            np.testing.assert_array_equal(
                np.asarray(restored.opt_state[mv][k]),
                np.asarray(res.state.opt_state[mv][k]))


def test_export_import_roundtrip(tmp_path):
    ds = random_kg(n_ent=50, n_rel=4, n_triples=400, n_valid=10, n_test=10,
                   seed=3)
    cfg = small_cfg(train_times=1)
    model = get_model(cfg.model)
    state = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0))

    from openkeonspark_tpu.ckpt import export_parameters, import_parameters
    for fmt, name in (("json", "embedding.vec.json"), ("npz", "emb.npz")):
        path = str(tmp_path / name)
        export_parameters(state.params, model, cfg, ds.n_ent, ds.n_rel,
                          path, fmt=fmt)
        back = import_parameters(path)
        want = strip_padding(state.params,
                             model.tables(cfg, ds.n_ent, ds.n_rel))
        assert set(back) == set(want)
        for k in want:
            np.testing.assert_allclose(back[k], want[k], rtol=1e-6)
        # reference table names present for TransE
        assert "ent_embeddings" in back and "rel_embeddings" in back


def test_incremental_warm_start(tmp_path):
    """Batch 1 (more entities) must start from batch 0's trained rows."""
    ds0 = random_kg(n_ent=60, n_rel=5, n_triples=500, n_valid=20, n_test=20,
                    seed=11)
    cfg = small_cfg(train_times=2)
    model = get_model(cfg.model)
    ck0 = str(tmp_path / "0")
    res0 = train(cfg, ds0, checkpoint_dir=ck0, echo=lambda *_: None)
    # cli/train.py writes n_ent/n_rel into the final manifest; emulate
    from openkeonspark_tpu.ckpt import (CheckpointManager, warm_start_from,
                                        warm_start_path)
    CheckpointManager(ck0).save(int(res0.state.step), res0.state,
                                extra={"n_ent": ds0.n_ent,
                                       "n_rel": ds0.n_rel})

    assert warm_start_path(str(tmp_path), 1) == ck0
    assert warm_start_path(str(tmp_path), 0) is None

    n_ent1 = 80  # vocab grew
    def init_fn(m, c, ne, nr):
        return init_state(m, c, ne, nr, jax.random.key(c.seed))
    fresh = init_state(model, cfg, n_ent1, ds0.n_rel, jax.random.key(1))
    warm, manifest = warm_start_from(fresh, ck0, model, cfg, init_fn)
    assert manifest["n_ent"] == ds0.n_ent

    specs0 = model.tables(cfg, ds0.n_ent, ds0.n_rel)
    old = strip_padding(res0.state.params, specs0)
    got_ent = np.asarray(warm.params["ent_embeddings"])
    np.testing.assert_array_equal(got_ent[:ds0.n_ent],
                                  old["ent_embeddings"])
    # grown rows keep the fresh init, not zeros
    assert np.abs(got_ent[ds0.n_ent:n_ent1]).sum() > 0
    assert int(warm.step) == int(res0.state.step)


def test_host_sampler_mode_trains():
    from openkeonspark_tpu.sampling.host import HostSampler
    if not HostSampler.available():
        pytest.skip("no native toolchain")
    ds = random_kg(n_ent=100, n_rel=6, n_triples=1000, n_valid=30, n_test=30,
                   seed=2)
    cfg = small_cfg(train_times=4, sampler="host", work_threads=3)
    res = train(cfg, ds, echo=lambda *_: None)
    assert res.history[-1].loss < res.history[0].loss


def test_host_sampler_exact_resume_data_order():
    """Host-sampler resume must continue the uninterrupted seed chain:
    HostPipeline is seeded from the restored global step (ADVICE r1 #3),
    mirroring the device sampler's step-derived keys."""
    import numpy as np
    from openkeonspark_tpu.sampling.host import HostSampler
    if not HostSampler.available():
        pytest.skip("no native toolchain")
    ds = random_kg(n_ent=100, n_rel=6, n_triples=1000, n_valid=30, n_test=30,
                   seed=2)
    cfg = small_cfg(train_times=4, sampler="host", work_threads=2,
                    nbatches=7, steps_per_scan=3, valid_every=0)

    full = train(cfg, ds, echo=lambda *_: None)
    first = train(cfg.replace(train_times=2), ds, echo=lambda *_: None)
    resumed = train(cfg.replace(train_times=2), ds, state=first.state,
                    echo=lambda *_: None)

    for k in full.state.params:
        np.testing.assert_array_equal(
            np.asarray(full.state.params[k]),
            np.asarray(resumed.state.params[k]), err_msg=k)
    assert int(full.state.step) == int(resumed.state.step)


def test_jsonl_logging(tmp_path):
    ds = random_kg(n_ent=50, n_rel=4, n_triples=400, n_valid=10, n_test=10,
                   seed=6)
    log = str(tmp_path / "log.jsonl")
    cfg = small_cfg(train_times=2, log_every=1, log_path=log)
    train(cfg, ds, echo=lambda *_: None)
    lines = [json.loads(l) for l in open(log)]
    assert len(lines) == 2
    assert {"epoch", "loss", "triples_per_sec"} <= set(lines[0])


def test_exact_resume_data_order(tmp_path):
    """Interrupted training resumed from its state must reproduce the
    uninterrupted run's parameters EXACTLY: sampling keys derive from the
    restored global step (reference parity: MonitoredTrainingSession
    restores global_step, SURVEY.md §5 checkpoint/resume)."""
    import jax
    import numpy as np
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.train.loop import train

    ds = random_kg(n_ent=80, n_rel=5, n_triples=800, n_valid=30, n_test=30,
                   seed=3)
    cfg = Config(model="transe", hidden_size=8, alpha=0.05, margin=1.0,
                 negative_ent=1, nbatches=7, steps_per_scan=3,
                 train_times=4, valid_every=0, log_every=100)

    full = train(cfg, ds, echo=lambda *_: None)

    first = train(cfg.replace(train_times=2), ds, echo=lambda *_: None)
    resumed = train(cfg.replace(train_times=2), ds, state=first.state,
                    echo=lambda *_: None)

    for k in full.state.params:
        np.testing.assert_array_equal(
            np.asarray(full.state.params[k]),
            np.asarray(resumed.state.params[k]), err_msg=k)
    assert int(full.state.step) == int(resumed.state.step)


def test_restore_across_padding_layouts(tmp_path):
    """A checkpoint written with grid padding (mesh training) must restore
    into a template with different padding (e.g. single-device eval):
    logical rows are a common prefix; restore() prefix-copies
    (the r4 sharded-evaluate CLI path)."""
    from openkeonspark_tpu.ckpt import CheckpointManager
    from openkeonspark_tpu.train.step import init_state
    cfg = Config(model="transe", hidden_size=8, opt_method="adam")
    model = get_model(cfg.model)
    st8 = init_state(model, cfg, 61, 5, jax.random.key(1), pad_to_multiple=8)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, st8)
    tmpl = init_state(model, cfg, 61, 5, jax.random.key(2))
    back, _ = mgr.restore(tmpl, step=3)
    specs = model.tables(cfg, 61, 5)
    a = strip_padding({k: np.asarray(v) for k, v in st8.params.items()}, specs)
    b = strip_padding({k: np.asarray(v) for k, v in back.params.items()}, specs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for mv in ("m", "v"):
        for k in back.opt_state[mv]:
            assert back.opt_state[mv][k].shape == tmpl.opt_state[mv][k].shape
    assert int(back.step) == int(st8.step)


def test_restore_vocab_mismatch_refused(tmp_path):
    """r4 advisor: restoring a checkpoint into a template whose LOGICAL
    row count exceeds the stored one (a newer dataset with more
    entities) must re-raise, not silently zero-fill — vocab growth goes
    through warm_start_from. Grid-padding-only mismatches still pass."""
    from openkeonspark_tpu.ckpt import CheckpointManager
    from openkeonspark_tpu.train.step import init_state
    cfg = Config(model="transe", hidden_size=8)
    model = get_model(cfg.model)
    st = init_state(model, cfg, 61, 5, jax.random.key(1))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, st)

    # padding-only difference: allowed (with the guard supplied)
    tmpl = init_state(model, cfg, 61, 5, jax.random.key(2),
                      pad_to_multiple=16)
    logical = {n: s.rows for n, s in model.tables(cfg, 61, 5).items()}
    back, _ = mgr.restore(tmpl, step=1, logical_rows=logical)
    np.testing.assert_array_equal(
        np.asarray(back.params["ent_embeddings"])[:61],
        np.asarray(st.params["ent_embeddings"])[:61])

    # vocabulary growth: refused
    big = init_state(model, cfg, 100, 5, jax.random.key(2))
    logical_big = {n: s.rows for n, s in model.tables(cfg, 100, 5).items()}
    with pytest.raises(ValueError, match="vocabulary mismatch"):
        mgr.restore(big, step=1, logical_rows=logical_big)


def test_checkpoint_npz_layout_and_overwrite(tmp_path):
    """One state.npz per step_N directory, no temporary directory left
    behind, a re-save of the same step replaces it, and gc keeps the
    last ``keep`` steps."""
    from openkeonspark_tpu.ckpt import CheckpointManager
    from openkeonspark_tpu.ckpt.checkpoint import all_steps
    from openkeonspark_tpu.train.step import init_state
    cfg = Config(model="transe", hidden_size=8, opt_method="adagrad")
    model = get_model(cfg.model)
    st = init_state(model, cfg, 30, 4, jax.random.key(1))
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3, 3):
        mgr.save(s, st, extra={"tag": s})
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names == ["manifest_2.json", "manifest_3.json", "step_2",
                     "step_3"], names
    assert sorted(all_steps(str(tmp_path / "ck"))) == [2, 3]
    with np.load(tmp_path / "ck" / "step_3" / "state.npz") as z:
        keys = set(z.files)
    assert keys == {"step", "params/ent_embeddings", "params/rel_embeddings",
                    "opt_state/accum/ent_embeddings",
                    "opt_state/accum/rel_embeddings"}
    back, manifest = mgr.restore(init_state(model, cfg, 30, 4,
                                            jax.random.key(5)))
    assert manifest == {"step": 3, "tag": 3}
    np.testing.assert_array_equal(np.asarray(back.params["ent_embeddings"]),
                                  np.asarray(st.params["ent_embeddings"]))


@pytest.mark.parametrize("save_pad,load_pad", [(8, 8), (8, 1), (1, 8)])
def test_checkpoint_sharded_8_devices(tmp_path, save_pad, load_pad):
    """A state row-sharded over all 8 (virtual) devices saves and
    restores: into the same sharded layout exactly, and across a
    grid-padding change into a single-device or sharded template."""
    from openkeonspark_tpu.ckpt import CheckpointManager
    from openkeonspark_tpu.parallel import make_mesh, shard_state
    from openkeonspark_tpu.train.step import init_state
    cfg = Config(model="transe", hidden_size=8, opt_method="adam")
    model = get_model(cfg.model)
    mesh = make_mesh((4, 2))

    def make(pad, key):
        st = init_state(model, cfg, 61, 5, jax.random.key(key),
                        pad_to_multiple=pad)
        return shard_state(st, mesh, flat=True) if pad == 8 else st

    st = make(save_pad, 1)
    if save_pad == 8:
        assert len(st.params["ent_embeddings"].sharding.device_set) == 8
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(7, st)
    tmpl = make(load_pad, 2)
    logical = {n: s.rows for n, s in model.tables(cfg, 61, 5).items()}
    back, _ = mgr.restore(tmpl, step=7, logical_rows=logical)
    assert int(back.step) == int(st.step)
    for k, v in back.params.items():
        assert v.shape == tmpl.params[k].shape
        assert v.sharding == tmpl.params[k].sharding, k
        np.testing.assert_array_equal(
            np.asarray(v)[:logical[k]],
            np.asarray(st.params[k])[:logical[k]], err_msg=k)
    for mv in ("m", "v"):
        for k, v in back.opt_state[mv].items():
            assert v.sharding == tmpl.opt_state[mv][k].sharding
