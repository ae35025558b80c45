"""Smoke test on the GPU: the system's main path at full width, every
hand-written kernel against its plain reference, and the card-only
tests, in one process that holds the card.

    python chip_smoke.py             # one card: phases a-d
    python chip_smoke.py --cards 4   # four cards: the sharded path only

Phases (one card):
  a. train → eval → checkpoint through ``cli/train.py::run``: TransE
     d=200 on an FB15K-237-shaped KG (14,541 entities, 237 relations,
     272,115 train, 1,000 valid, 1,000 test triples, generated from a
     seed and written to disk), bern sampling, 2 epochs of 100 batches,
     SGD, validation every epoch, raw and filtered link prediction in
     both directions, triple classification; then restore the
     checkpoint, check the exported ``embedding.vec.json``, and rank
     again from the restored state: the ranks must be identical.
  b. the fused rank kernel (``ops/pallas_rank.py``) at 14,541 entities
     for TransE d=200 p=1, TransD d=200 and RotatE d=100: against its
     same-order XLA reference on a 256-query chunk, then the whole
     evaluator against the plain path (``use_pallas_eval=False``).
  c. TransR at FB15K shape (d_e=200, d_r=100, 14,951 entities, 1,345
     relations, 483,142 train triples): a few scans of the training step,
     and the wide-row scatter of its ``transfer_matrix`` update.
  d. the tests marked ``gpu``, run by pytest inside this process.

Phase with ``--cards 4`` (and nothing else): TransE d=256 on a 2M-entity,
600-relation, 10M-triple KG through ``cli/train.py::run`` on a (2, 2)
flat-exchange mesh with a float32 wire, against the same steps emulated
on one card, and the sharded ranks against single-card ranks.

Tolerances. Kernel vs reference: ranks identical on ≥ 99.9% of queries
and never more than 1 apart. Against the plain evaluator, whose f32 sums
run in another order: filtered MRR and Hits@10 within 1e-3, and every
rank that differs is explained by float near-ties — at least as many
candidates lie within the f32 summation error bound of the gold score
as the ranks differ (``link_prediction.near_tie_counts``). Sharded losses: rtol 1e-4.

Each phase prints its set-up time (first call, compilation included),
its steady time and the process's ``peak_bytes_in_use`` so far. The last
line of standard output is one JSON object; with no GPU the script exits
non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 7


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    """Name and power limit, read by a process that does not use JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def peak(dev=None) -> int:
    import jax
    return (dev or jax.devices()[0]).memory_stats()["peak_bytes_in_use"]


def timed(f, repeats=3):
    """(first-call seconds, median steady seconds, result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(f())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    return first, statistics.median(ts), out


def report(phase, setup_s, steady_s, **extra):
    fields = " ".join(f"{k}={v}" for k, v in extra.items())
    log(f"[{phase}] setup_s={setup_s:.3f} steady_s={steady_s:.4f} "
        f"peak_bytes_in_use={peak()} {fields}".rstrip())


def assert_ranks_agree(a, b, what):
    """≥ 99.9% identical, none more than 1 apart."""
    import numpy as np
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    same, worst = float((d == 0).mean()), int(d.max(initial=0))
    assert same >= 0.999 and worst <= 1, (what, same, worst)
    return same, worst


# --------------------------------------------------------------------------
# phase a: the main path


def fb15k237_shape(tmp, n_ent=14541, n_rel=237, n_train=272115,
                   n_split=1000):
    from openkeonspark_tpu.data.dataset import save_dataset
    from openkeonspark_tpu.data.synth import random_kg
    path = os.path.join(tmp, "kg")
    save_dataset(random_kg(n_ent=n_ent, n_rel=n_rel, n_triples=n_train,
                           n_valid=n_split, n_test=n_split, seed=SEED), path)
    return path


def phase_main_path(tmp, kg_dir, d=200, nbatches=100, interpret=False):
    import numpy as np
    import jax
    from openkeonspark_tpu.ckpt import (CheckpointManager,
                                        import_parameters)
    from openkeonspark_tpu.cli.train import run
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.dataset import load_dataset
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.eval import link_prediction
    from openkeonspark_tpu.models import get_model, strip_padding
    from openkeonspark_tpu.train.step import init_state

    cfg = Config(model="transe", hidden_size=d, alpha=0.01, margin=1.0,
                 negative_ent=1, bern=True, nbatches=nbatches,
                 train_times=2, valid_every=1, opt_method="sgd",
                 test_link_prediction=True, test_triple_classification=True,
                 in_path=kg_dir, seed=SEED)
    quiet = lambda *_: None
    times, summaries = [], []
    for i in range(2):     # first run compiles; the second is steady
        out_dir = os.path.join(tmp, f"out{i}")
        t0 = time.perf_counter()
        summaries.append(run(cfg.replace(out_path=out_dir), echo=quiet))
        times.append(time.perf_counter() - t0)
    s = summaries[1]
    lp = s["link_prediction"]
    log(f"[a] steps={s['steps']} final_loss={s['final_loss']:.6g} "
        f"best_valid_accuracy={s['best_valid_accuracy']} "
        f"filtered_mrr={lp['filtered_mrr']:.6g} "
        f"filtered_hits10={lp['filtered_hits10']:.6g} "
        f"triple_classification={s['triple_classification']}")
    assert s["steps"] == 2 * nbatches and np.isfinite(s["final_loss"])
    assert 0.0 < lp["filtered_mrr"] <= 1.0
    assert 0.0 <= s["triple_classification"]["accuracy"] <= 1.0

    # restore → export check → rank again from the restored state
    ds = load_dataset(kg_dir)
    model = get_model(cfg.model)
    logical = {n: t.rows for n, t in
               model.tables(cfg, ds.n_ent, ds.n_rel).items()}
    tmpl = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(99))
    state, manifest = CheckpointManager(out_dir).restore(
        tmpl, logical_rows=logical)
    assert int(state.step) == s["steps"] == manifest["step"], manifest
    exported = import_parameters(os.path.join(out_dir, "embedding.vec.json"))
    stripped = strip_padding(state.params,
                             model.tables(cfg, ds.n_ent, ds.n_rel))
    for k, v in stripped.items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      exported[k], err_msg=k)
    res = link_prediction(state.params, cfg, ds,
                          build_kg_index(ds, for_eval=True),
                          interpret=interpret)
    for k, v in res.ranks.items():
        np.testing.assert_array_equal(v, lp["ranks"][k], err_msg=k)
    log("[a] restored checkpoint: identical ranks on "
        f"{sum(len(v) for v in res.ranks.values())} rank entries; "
        "embedding.vec.json matches the restored tables")
    report("a main_path", times[0], times[1])


# --------------------------------------------------------------------------
# phase b: the rank kernel against its references


KERNEL_FORMS = (("transe", 200), ("transd", 200), ("rotate", 100))


def phase_kernel_chunks(n_ent=14541, chunk=256, interpret=False):
    """Compiled kernel vs the same-order XLA reference on one chunk."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from openkeonspark_tpu.ops.pallas_rank import (count_better,
                                                   count_better_ref,
                                                   residual_scores)
    rng = np.random.default_rng(SEED)
    for form, d in KERNEL_FORMS:
        D = 2 * d if form == "rotate" else d
        table = jnp.asarray(rng.normal(size=(n_ent, D)).astype(np.float32))
        q = jnp.asarray(rng.normal(size=(chunk, D)).astype(np.float32))
        gid = jnp.asarray(rng.integers(0, n_ent, chunk).astype(np.int32))
        u = cv = None
        if form == "transd":
            u = jnp.asarray(rng.normal(size=(chunk, D)).astype(np.float32))
            cv = jnp.asarray(rng.normal(size=(n_ent,)).astype(np.float32))
        for sign in (-1.0, 1.0):
            kw = dict(sign=sign, p=1, n_ent=n_ent, modulus=form == "rotate")
            gold = residual_scores(q, jnp.take(table, gid, 0), sign, 1, u,
                                   None if cv is None else jnp.take(cv, gid),
                                   kw["modulus"])
            k_first, k_s, got = timed(lambda: count_better(
                q, table, gold, gid, u, cv, interpret=interpret, **kw), 5)
            r_first, r_s, ref = timed(lambda: count_better_ref(
                q, table, gold, gid, u, cv, **kw), 5)
            same, worst = assert_ranks_agree(got, ref, (form, sign))
            pairs = chunk * n_ent * d
            report(f"b kernel {form} d={d} sign={sign:+.0f}", k_first, k_s,
                   reference_setup_s=round(r_first, 3),
                   reference_steady_s=round(r_s, 5),
                   identical=same, max_rank_diff=worst,
                   kernel_pair_columns_per_s=f"{pairs / k_s:.4g}")


def phase_kernel_eval(kg_dir, interpret=False):
    """Whole evaluator, kernel path vs plain path, at full width."""
    import numpy as np
    import jax
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.dataset import load_dataset
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.eval import link_prediction
    from openkeonspark_tpu.eval.link_prediction import near_tie_counts
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.train.step import init_state
    ds = load_dataset(kg_dir)
    idx = build_kg_index(ds, for_eval=True)
    n = len(ds.test)
    for model, d in KERNEL_FORMS:
        cfg = Config(model=model, hidden_size=d, eval_chunk=256)
        params = init_state(get_model(model), cfg, ds.n_ent, ds.n_rel,
                            jax.random.key(SEED)).params
        k_first, k_s, rk = timed(lambda: link_prediction(
            params, cfg, ds, idx, interpret=interpret))
        plain = cfg.replace(use_pallas_eval=False)
        p_first, p_s, rp = timed(lambda: link_prediction(
            params, plain, ds, idx))
        assert abs(rk.filt_avg.mrr - rp.filt_avg.mrr) <= 1e-3
        assert abs(rk.filt_avg.hits10 - rp.filt_avg.hits10) <= 1e-3
        stats = {}
        for direction in ("head", "tail"):
            for mode in ("raw", "filt"):
                key = f"{mode}_{direction}"
                diff = np.abs(rk.ranks[key] - rp.ranks[key])
                stats[key] = (float((diff == 0).mean()), int(diff.max()))
            bad = np.nonzero((rk.ranks[f"raw_{direction}"]
                              != rp.ranks[f"raw_{direction}"])
                             | (rk.ranks[f"filt_{direction}"]
                                != rp.ranks[f"filt_{direction}"]))[0]
            if len(bad):
                near = near_tie_counts(params, plain, ds.test[bad],
                                       direction)
                for mode in ("raw", "filt"):
                    key = f"{mode}_{direction}"
                    delta = np.abs(rk.ranks[key][bad] - rp.ranks[key][bad])
                    assert (delta <= near).all(), (model, key, delta, near)
        report(f"b eval {model} d={d} kernel", k_first, k_s,
               test_triples_per_s=round(n / k_s, 1))
        report(f"b eval {model} d={d} plain", p_first, p_s,
               test_triples_per_s=round(n / p_s, 1),
               kernel_speedup=round(p_s / k_s, 3),
               identical_and_max_diff=stats,
               mrr_diff=f"{abs(rk.filt_avg.mrr - rp.filt_avg.mrr):.3g}",
               hits10_diff=abs(rk.filt_avg.hits10 - rp.filt_avg.hits10))


# --------------------------------------------------------------------------
# phase c: TransR training at FB15K shape


def phase_transr(n_ent=14951, n_rel=1345, n_train=483142, de=200, dr=100,
                 nbatches=100, steps=20):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.sampling.device import DeviceSampler
    from openkeonspark_tpu.train.step import (build_scan_steps,
                                              build_train_step, init_state)
    ds = random_kg(n_ent=n_ent, n_rel=n_rel, n_triples=n_train, n_valid=100,
                   n_test=100, seed=SEED)
    # alpha 0.001: at 0.01 this sum-over-batch loss diverges within 40
    # steps at this shape, on the CPU as on the GPU
    cfg = Config(model="transr", hidden_size=de, ent_size=de, rel_size=dr,
                 alpha=0.001, negative_ent=1, nbatches=nbatches)
    B = ds.n_train // nbatches
    model = get_model("transr")
    sampler = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False))
    run = build_scan_steps(build_train_step(model, cfg, sampler, B), steps)
    holder = [init_state(model, cfg, ds.n_ent, ds.n_rel,
                         jax.random.key(SEED))]
    losses = []

    def go():
        key = jax.random.fold_in(jax.random.key(1), len(losses))
        holder[0], loss = run(holder[0], sampler, key)
        losses.append(loss)
        return holder[0], loss

    first, steady, _ = timed(go)
    losses = [float(v) for v in losses]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    report("c transr train", first, steady, batch=B, steps_per_scan=steps,
           ms_per_step=round(steady / steps * 1e3, 4),
           triples_per_s=round(steps * B / steady, 1),
           scan_mean_losses=[round(v, 4) for v in losses])

    # the wide-row update of transfer_matrix: XLA's scatter-add
    rng = np.random.default_rng(SEED)
    ids = jnp.asarray(rng.integers(0, n_rel, B).astype(np.int32))
    delta = jnp.asarray(rng.normal(size=(B, de * dr)).astype(np.float32))
    scatter = jax.jit(lambda t, i, x: t.at[i].add(x), donate_argnums=(0,))
    table = [jnp.zeros((n_rel, de * dr), jnp.float32)]

    def sc():
        table[0] = scatter(table[0], ids, delta)
        return table[0]

    first, steady, _ = timed(sc, 10)
    uniq = len(np.unique(np.asarray(ids)))
    nbytes = (B + 2 * uniq) * de * dr * 4
    report("c transr wide-row scatter", first, steady,
           bytes=nbytes, gb_per_s=round(nbytes / steady / 1e9, 1),
           share_of_3_35_tb_per_s=round(nbytes / steady / 3.35e12, 3))


# --------------------------------------------------------------------------
# phase d: card-only tests


def phase_gpu_tests():
    import pytest
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")])
    dt = time.perf_counter() - t0
    report("d gpu-marked tests", dt, dt, pytest_exit=int(rc))
    assert rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})"


# --------------------------------------------------------------------------
# four cards: the sharded path


def emulate_sharded_epochs(ds, idx, cfg, batch, epochs, params):
    """The flat-exchange steps of ``run`` replayed on the default card
    (the first): each data
    shard d draws from its slice with ``fold_in(step_key, d)``, and one
    optimizer step applies the union of the shards' row gradients.
    Returns the per-epoch mean losses."""
    import jax
    import jax.numpy as jnp
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.sampling.device import DeviceSampler
    from openkeonspark_tpu.train.optim import make_optimizer
    from openkeonspark_tpu.train.step import loss_and_row_grads
    model = get_model(cfg.model)
    opt = make_optimizer(cfg)
    n_data = cfg.mesh_shape[0]
    sampler = DeviceSampler.build(ds, idx)
    base = ds.n_train // n_data
    sps = max(1, min(cfg.scan_group_size(batch), cfg.nbatches))
    assert cfg.nbatches % sps == 0

    @jax.jit
    def step(params, opt_state, it, key, sampler):
        total = jnp.zeros((), jnp.float32)
        ups = {}
        for d in range(n_data):
            size = base if d < n_data - 1 else ds.n_train - d * base
            b = sampler.sample(jax.random.fold_in(key, d), batch // n_data,
                               cfg.negative_ent, cfg.negative_rel, cfg.bern,
                               partition=(jnp.int32(d * base),
                                          jnp.int32(size)))
            loss, u = loss_and_row_grads(model, cfg, params, b)
            total = total + loss
            for k, pairs in u.items():
                ups.setdefault(k, []).extend(pairs)
        params, opt_state = opt.apply(params, opt_state, ups, it)
        return params, opt_state, total

    opt_state = opt.init(params)
    key_base = jax.random.key(cfg.seed + 17)
    it, out = 0, []
    for _ in range(epochs):
        losses = []
        for g in range(cfg.nbatches // sps):
            keys = jax.random.split(jax.random.fold_in(key_base, it), sps)
            for k in keys:
                params, opt_state, loss = step(params, opt_state,
                                               jnp.int32(it), k, sampler)
                losses.append(float(loss))
                it += 1
        out.append(sum(losses) / len(losses))
    return out


def phase_sharded(tmp, n_ent=2_000_000, n_rel=600, n_train=10_000_000,
                  d=256, nbatches=4, batch=10000, n_test=1000):
    import numpy as np
    import jax
    from openkeonspark_tpu.ckpt import CheckpointManager
    from openkeonspark_tpu.cli.train import run
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.dataset import Dataset, load_dataset
    from openkeonspark_tpu.data.dataset import save_dataset
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import dbpedia_like
    from openkeonspark_tpu.eval import link_prediction
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.train.step import init_state

    devs = jax.devices()
    assert len(devs) >= 4, f"--cards 4 needs four devices, found {devs}"
    t0 = time.perf_counter()
    full = dbpedia_like(n_ent=n_ent, n_rel=n_rel, n_triples=n_train,
                        seed=SEED)
    kg_dir = os.path.join(tmp, "kg5")
    save_dataset(Dataset(n_ent=full.n_ent, n_rel=full.n_rel,
                         train=full.train, valid=full.valid[:n_test],
                         test=full.test[:n_test]), kg_dir)
    del full
    log(f"[e] dataset written in {time.perf_counter() - t0:.1f}s")
    cfg = Config(model="transe", hidden_size=d, alpha=0.01, margin=1.0,
                 negative_ent=1, bern=True, nbatches=nbatches,
                 batch_size=batch, train_times=2, seed=SEED,
                 mesh_shape=(2, 2), sharded_step="exchange",
                 exchange_wire_dtype="float32", test_link_prediction=True,
                 in_path=kg_dir, out_path=os.path.join(tmp, "out5"),
                 log_path=os.path.join(tmp, "train5.jsonl"))
    # export as .npz: the reference's JSON layout of a 2M-row table is
    # gigabytes of text (cli/train.py's --export_format sets the same)
    object.__setattr__(cfg, "export_format", "npz")
    lines = []
    t0 = time.perf_counter()
    s = run(cfg, echo=lines.append)
    dt = time.perf_counter() - t0
    for ln in lines:
        if ln.startswith(("dataset:", "mesh:", "epoch=")):
            log(f"[e] {ln}")
    with open(cfg.log_path) as f:
        records = [json.loads(ln) for ln in f]
    epoch_losses = [r["loss"] for r in records if "loss" in r]
    peaks = [peak(dv) for dv in devs[:4]]
    log(f"[e] per-card peak_bytes_in_use={peaks}")
    table_bytes = n_ent * d * 4
    assert min(peaks) > table_bytes // 8, (peaks, table_bytes)
    report("e sharded run (2,2)", dt, dt, steps=s["steps"],
           epoch_losses=epoch_losses)

    # where the tables live: the checkpoint restored into a sharded
    # template, the same placement the run trains in
    from openkeonspark_tpu.parallel import make_mesh, shard_state
    model = get_model(cfg.model)
    ds = load_dataset(kg_dir)
    mesh = make_mesh(cfg.mesh_shape)
    tmpl = shard_state(init_state(model, cfg, ds.n_ent, ds.n_rel,
                                  jax.random.key(SEED), pad_to_multiple=4),
                       mesh, flat=True)
    restored, _ = CheckpointManager(cfg.out_path).restore(tmpl)
    for k, v in restored.params.items():
        ids = sorted(dv.id for dv in v.sharding.device_set)
        log(f"[e] table {k} {v.shape} on devices {ids}")
        assert len(ids) == 4, (k, ids)

    # the same steps on one card from the same seed
    idx = build_kg_index(ds, for_eval=True)
    init = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(SEED),
                      pad_to_multiple=4).params
    t0 = time.perf_counter()
    ref = emulate_sharded_epochs(ds, idx, cfg, batch, cfg.train_times, init)
    log(f"[e] one-card epoch losses {ref} vs sharded {epoch_losses} "
        f"({time.perf_counter() - t0:.1f}s)")
    np.testing.assert_allclose(epoch_losses, ref, rtol=1e-4)

    # sharded ranks (from run) vs one-card ranks of the restored state
    one = jax.device_put(restored.params, devs[0])
    t0 = time.perf_counter()
    r1 = link_prediction(one, cfg.replace(use_pallas_eval=False,
                                          mesh_shape=(1, 1)), ds, idx)
    for k, v in s["link_prediction"]["ranks"].items():
        same, worst = assert_ranks_agree(v, r1.ranks[k], k)
        log(f"[e] ranks {k}: identical={same} max_diff={worst}")
    report("e one-card ranks", time.perf_counter() - t0,
           time.perf_counter() - t0, queries=len(ds.test))


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"no GPU: JAX found {devs[0].platform} ({devs[0].device_kind})")
        return 1
    from openkeonspark_tpu.runtime import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    with tempfile.TemporaryDirectory() as tmp:
        if args.cards == 4:
            phase_sharded(tmp)
        else:
            kg_dir = fb15k237_shape(tmp)
            phase_main_path(tmp, kg_dir)
            phase_kernel_chunks()
            phase_kernel_eval(kg_dir)
            phase_transr()
            phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
