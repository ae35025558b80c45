"""Real-data acceptance runbook (VERDICT r4 missing #4 / next #7).

"Match reference Hits@10 on FB15K-237" is unverifiable in this sandbox
(no network, no benchmark splits on disk). This script encodes the day-1
protocol for when the splits ARE available: all 5 BASELINE.json configs
end-to-end — train, evaluate, gate filtered MRR/Hits@10 against the
literature anchor ranges of BASELINE.md §0 — and emit one pass/fail
table. Until then, ``--stand-in`` generates planted-structure synthetic
stand-ins in the same OpenKE text layout and runs the identical pipeline
with ceiling-aware gates, so the harness itself is tested NOW
(tests/test_acceptance.py) and real parity becomes one command:

    python tools/acceptance.py --data-root /data/kge
      # expects <root>/fb15k237, <root>/wn18rr, <root>/fb15k,
      #         <root>/fb15k237_subset (optional), <root>/dbpedia (cfg 5)
      # each in OpenKE layout: entity2id.txt relation2id.txt
      #         train2id.txt valid2id.txt test2id.txt

Gates (BASELINE.md §0 literature anchors, lower bounds set one notch
under the published low end to absorb run variance; "—" = structural
gate only):

| cfg | dataset | model | gate |
|---|---|---|---|
| 1 | FB15K-237 subset | TransE d=64 | loss decreases ≥3× (parity cfg) |
| 2 | FB15K-237 | TransE d=200 | filt MRR ≥ 0.26, Hits@10 ≥ 0.42 |
| 3 | WN18RR | TransH d=200 | filt Hits@10 ≥ 0.35 |
| 4 | FB15K | TransR 200/100 | filt Hits@10 ≥ 0.55 |
| 5 | DBpedia-scale | TransE d=256 | multi-device train runs; ≥1M t/s |
"""

from __future__ import annotations

# Runnable from a clean shell without installing the package.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import os
import time


CONFIGS = [
    dict(n=1, dataset="fb15k237_subset", model="transe", d=64,
         alpha=0.01, margin=1.0, neg=1, bern=False, epochs=50, nbatches=50,
         gates={}, note="per-step parity config; gate = loss falls >=3x"),
    dict(n=2, dataset="fb15k237", model="transe", d=200,
         alpha=0.01, margin=1.0, neg=1, bern=True, epochs=500, nbatches=100,
         gates={"filt_mrr": 0.26, "filt_hits10": 0.42},
         note="lit. anchors 0.28-0.31 MRR / 0.44-0.47 H@10 (BASELINE 0)"),
    dict(n=3, dataset="wn18rr", model="transh", d=200,
         alpha=0.01, margin=2.0, neg=1, bern=True, epochs=500, nbatches=100,
         gates={"filt_hits10": 0.35},
         note="TransE-family WN18RR reproductions land ~0.40-0.50 H@10"),
    dict(n=4, dataset="fb15k", model="transr", d=200, d_rel=100,
         alpha=0.01, margin=1.0, neg=1, bern=True, epochs=500, nbatches=100,
         gates={"filt_hits10": 0.55},
         note="TransR paper FB15K filtered H@10 0.687"),
    dict(n=5, dataset="dbpedia", model="transe", d=256,
         alpha=0.01, margin=1.0, neg=1, bern=True, epochs=3, nbatches=100,
         gates={"min_tps": 1e6}, multi_device=True,
         note="edge-partitioned >=2 devices; throughput gate, no lit "
              "quality anchor exists for arbitrary DBpedia snapshots"),
]


def make_stand_ins(root: str, quick: bool):
    """Planted-structure stand-ins in the real text layout. Sizes are
    compact (the point is to exercise the harness, not to re-anchor
    quality — tools/quality_anchors.py owns that)."""
    from openkeonspark_tpu.data.dataset import save_dataset
    from openkeonspark_tpu.data.synth import planted_kg, random_kg
    s = 0.25 if quick else 1.0
    specs = {
        "fb15k237_subset": dict(n_ent=300, n_rel=8, n_triples=6000),
        "fb15k237": dict(n_ent=int(2000 * s) or 400, n_rel=30,
                         n_triples=int(40000 * s) or 8000),
        "wn18rr": dict(n_ent=int(2000 * s) or 400, n_rel=11,
                       n_triples=int(30000 * s) or 6000),
        "fb15k": dict(n_ent=int(2000 * s) or 400, n_rel=30,
                      n_triples=int(40000 * s) or 8000),
        "dbpedia": dict(),
    }
    for name, sp in specs.items():
        d = os.path.join(root, name)
        if os.path.exists(os.path.join(d, "train2id.txt")):
            continue
        if name == "dbpedia":
            ds = random_kg(n_ent=3000, n_rel=40, n_triples=60000,
                           n_valid=500, n_test=500, seed=11)
        else:
            ds = planted_kg(**sp, n_valid=300, n_test=300, dim=8,
                            noise=0.0, seed=5)
        save_dataset(ds, d)
    return root


def run_config(spec, data_root: str, stand_in: bool, quick: bool,
               echo=print):
    import numpy as np
    import jax
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.dataset import load_dataset
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.eval.link_prediction import link_prediction
    from openkeonspark_tpu.train.loop import train

    path = os.path.join(data_root, spec["dataset"])
    if not os.path.exists(os.path.join(path, "train2id.txt")):
        return dict(config=spec["n"], dataset=spec["dataset"],
                    status="SKIP", reason=f"no dataset at {path}")
    ds = load_dataset(path)
    epochs = spec["epochs"]
    if stand_in and spec["n"] != 1:   # cfg 1 is tiny; full epochs keep
        epochs = max(3, epochs // (20 if quick else 1))  # its loss gate
    cfg = Config(model=spec["model"], hidden_size=spec["d"],
                 ent_size=spec.get("d_rel") and spec["d"],
                 rel_size=spec.get("d_rel"),
                 alpha=spec["alpha"], margin=spec["margin"],
                 negative_ent=spec["neg"], bern=spec["bern"],
                 train_times=epochs, nbatches=spec["nbatches"],
                 log_every=0)

    t0 = time.perf_counter()
    if spec.get("multi_device"):
        n_dev = jax.device_count()
        if n_dev < 2:
            return dict(config=spec["n"], dataset=spec["dataset"],
                        status="SKIP",
                        reason=f"needs >=2 devices, have {n_dev}")
        from openkeonspark_tpu.models import get_model
        from openkeonspark_tpu.parallel import (make_mesh, hier_shape,
                                                shard_state)
        from openkeonspark_tpu.parallel.exchange import \
            make_exchange_step_builder
        from openkeonspark_tpu.train.step import init_state
        shape = hier_shape((n_dev // 2, 2), n_dev // 2) or (n_dev // 2, 2)
        mesh = make_mesh(shape)
        bs = cfg.resolve_batch_size(ds.n_train)
        bs -= bs % (2 * n_dev)
        cfg = cfg.replace(batch_size=max(2 * n_dev, bs))
        st = init_state(get_model(cfg.model), cfg, ds.n_ent, ds.n_rel,
                        jax.random.key(cfg.seed), pad_to_multiple=n_dev)
        st = shard_state(st, mesh, flat=True)
        res = train(cfg, ds, state=st,
                    step_builder=make_exchange_step_builder(mesh),
                    echo=lambda *_: None)
    else:
        res = train(cfg, ds, echo=lambda *_: None)
    wall = time.perf_counter() - t0
    tps = float(np.median([h.triples_per_sec for h in res.history]))

    out = dict(config=spec["n"], dataset=spec["dataset"],
               model=spec["model"], epochs=epochs,
               final_loss=round(res.final_loss, 3),
               triples_per_sec=round(tps, 1), wall_s=round(wall, 1))
    checks = {}
    first_loss = res.history[0].loss if res.history else float("nan")
    if spec["n"] == 1:
        checks["loss_falls_3x"] = res.final_loss * 3 <= first_loss
    gates = dict(spec["gates"])
    if "min_tps" in gates:
        min_tps = gates.pop("min_tps")
        # stand-in runs on a virtual CPU mesh: gate = the multi-device
        # pipeline runs and makes progress, not CPU throughput
        checks["throughput"] = (tps >= min_tps if not stand_in
                                else tps > 0 and np.isfinite(
                                    res.final_loss))
    if gates:
        index = build_kg_index(ds, for_eval=True)
        lp = link_prediction(res.state.params, cfg, ds, index)
        out["filt_mrr"] = round(lp.filt_avg.mrr, 4)
        out["filt_hits10"] = round(lp.filt_avg.hits10, 4)
        if stand_in:
            # stand-in gates: planted structure must be genuinely
            # recovered (well off the random floor), not match literature
            # numbers that belong to the real splits
            floor = 10.0 / ds.n_ent
            checks["filt_hits10_recovered"] = \
                lp.filt_avg.hits10 >= max(0.15, 5 * floor)
        else:
            for k, lo in gates.items():
                checks[k] = out[k] >= lo
    out["checks"] = {k: bool(v) for k, v in checks.items()}
    out["status"] = "PASS" if all(checks.values()) else "FAIL"
    if not checks:
        out["status"] = "PASS"
    out["note"] = spec["note"]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default="",
                    help="directory holding the real splits (OpenKE text "
                         "layout, one subdir per dataset)")
    ap.add_argument("--stand-in", action="store_true",
                    help="generate planted synthetic stand-ins (harness "
                         "self-test; gates switch to recovery thresholds)")
    ap.add_argument("--quick", action="store_true",
                    help="stand-in mode at reduced sizes/epochs")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="force the CPU backend with N virtual devices "
                         "(harness self-test)")
    args = ap.parse_args()

    if args.cpu_devices:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)

    root = args.data_root
    if args.stand_in:
        root = root or os.path.join("/tmp", "okst_acceptance_standin")
        os.makedirs(root, exist_ok=True)
        make_stand_ins(root, args.quick)
    elif not root:
        ap.error("--data-root required (or use --stand-in)")

    want = {int(x) for x in args.configs.split(",")}
    rows = []
    for spec in CONFIGS:
        if spec["n"] not in want:
            continue
        r = run_config(spec, root, args.stand_in, args.quick)
        rows.append(r)
        print(json.dumps(r), flush=True)

    print("\n| cfg | dataset | model | status | filt MRR | filt H@10 "
          "| t/s |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['config']} | {r['dataset']} | {r.get('model', '-')} "
              f"| **{r['status']}** | {r.get('filt_mrr', '-')} "
              f"| {r.get('filt_hits10', '-')} "
              f"| {r.get('triples_per_sec', '-')} |")
    bad = [r for r in rows if r["status"] == "FAIL"]
    print(json.dumps({"metric": "acceptance",
                      "mode": "stand_in" if args.stand_in else "real",
                      "pass": sum(r["status"] == "PASS" for r in rows),
                      "fail": len(bad),
                      "skip": sum(r["status"] == "SKIP" for r in rows)}))
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
