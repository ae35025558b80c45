"""Measure every BASELINE.md config (triples/s/chip) on the local GPU
(exits non-zero when JAX finds no GPU).

Usage: python tools/bench_all.py [--configs 1,2,3,4,5] [--steps 200]

Configs (BASELINE.json "measurement configs"; shapes stand in for the
real splits, which cannot be fetched in this sandbox — the compute and
memory profile is what the meter needs):

1. TransE d=64, FB15K-237 subset (3k ents / 40k triples), 1 neg
2. TransE d=200, FB15K-237 shape (14.5k ents / 237 rels / 272k triples)
3. TransH d=200, WN18RR shape (41k ents / 11 rels / 87k triples)
4. TransR d_e=200 d_r=100, FB15K shape (15k ents / 1345 rels / 483k triples)
5. TransE d=256, DBpedia scale (2M ents / 600 rels / 10M triples),
   edge-partitioned draw (single-chip here; multi-host via cli/launch.py)
6. DistMult d=200, FB15K-237 shape (beyond-parity model)
7. ComplEx d=100 (2·100 table lanes), FB15K-237 shape (beyond-parity)
8. RotatE d=100 (2·100 entity lanes, phase relations), FB15K-237 shape

Prints one JSON line per config.
"""

from __future__ import annotations

# Runnable from a clean shell without installing the package.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time


CONFIGS = {
    1: dict(model="transe", d=64, n_ent=3000, n_rel=100, n_train=40000,
            nbatches=100),
    2: dict(model="transe", d=200, n_ent=14541, n_rel=237, n_train=272115,
            nbatches=100),
    3: dict(model="transh", d=200, n_ent=40943, n_rel=11, n_train=86835,
            nbatches=100),
    4: dict(model="transr", d=200, d_rel=100, n_ent=14951, n_rel=1345,
            n_train=483142, nbatches=100),
    5: dict(model="transe", d=256, n_ent=2_000_000, n_rel=600,
            n_train=10_000_000, nbatches=1000),
    6: dict(model="distmult", d=200, n_ent=14541, n_rel=237,
            n_train=272115, nbatches=100),
    7: dict(model="complex", d=100, n_ent=14541, n_rel=237,
            n_train=272115, nbatches=100),
    8: dict(model="rotate", d=100, n_ent=14541, n_rel=237,
            n_train=272115, nbatches=100),
}


def bench_config(i: int, spec: dict, steps: int, repeats: int = 5) -> dict:
    import jax

    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.sampling.device import DeviceSampler
    from openkeonspark_tpu.train.step import (build_scan_steps,
                                              build_train_step, init_state)

    ds = random_kg(n_ent=spec["n_ent"], n_rel=spec["n_rel"],
                   n_triples=spec["n_train"], n_valid=100, n_test=100,
                   seed=7)
    cfg = Config(model=spec["model"], hidden_size=spec["d"], alpha=0.01,
                 margin=1.0, negative_ent=1, negative_rel=0, bern=True,
                 nbatches=spec["nbatches"])
    if spec["model"] == "transr":
        cfg = cfg.replace(ent_size=spec["d"], rel_size=spec["d_rel"])
    batch = spec["n_train"] // spec["nbatches"]

    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=False)
    sampler = DeviceSampler.build(ds, index)
    state = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(7))
    # measure at the fusion depth training actually uses (adaptive group:
    # small batches fuse deeper to amortize dispatch latency)
    steps = max(steps, cfg.scan_group_size(batch))
    run = build_scan_steps(build_train_step(model, cfg, sampler, batch),
                           steps)
    key = jax.random.key(1)
    # compile, then one more warm call before the timed window
    for k in (key, jax.random.fold_in(key, 999)):
        state, loss = jax.block_until_ready(run(state, sampler, k))
    # median-of-N + relative spread (the bench.py protocol)
    import numpy as _np
    rates = []
    for r in range(repeats):
        t0 = time.perf_counter()
        state, loss = jax.block_until_ready(
            run(state, sampler, jax.random.fold_in(key, r)))
        rates.append(steps * batch / (time.perf_counter() - t0))
    med = float(_np.median(rates))
    return {"config": i, "model": spec["model"], "d": spec["d"],
            "n_ent": spec["n_ent"], "n_train": spec["n_train"],
            "batch": batch, "triples_per_sec": round(med, 1),
            "spread": round((max(rates) - min(rates)) / med, 3)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    from openkeonspark_tpu.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    require_gpu()
    for i in [int(x) for x in args.configs.split(",")]:
        print(json.dumps(bench_config(i, CONFIGS[i], args.steps)),
              flush=True)


if __name__ == "__main__":
    main()
