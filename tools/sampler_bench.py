"""Standalone C++ host-sampler generation rate (VERDICT r4 weak #6 /
next #8).

The host-sampler niche claim (DESIGN.md crossover table: ~100M-triple
stores must use ``--sampler host``) rested on one end-to-end 78k t/s
number dominated by a remote device link; nothing showed what
``native/sampler.cpp`` itself can GENERATE. This benchs ``okst_sample``
host-side only — no device_put, no JAX — across thread counts, on the
flagship-shaped store, so the crossover table can state whether a
co-located host can feed a chip at the multi-M t/s the niche implies.

Usage: python tools/sampler_bench.py [--batch 2721] [--threads 1,2,4,8,16]
Prints one JSON line per thread count + a summary line.
"""

from __future__ import annotations

# Runnable from a clean shell without installing the package.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2721)
    ap.add_argument("--negative-ent", type=int, default=1)
    ap.add_argument("--threads", default="1,2,4,8,16")
    ap.add_argument("--n-ent", type=int, default=14541)
    ap.add_argument("--n-train", type=int, default=272115)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()

    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.sampling.host import HostSampler

    ds = random_kg(n_ent=args.n_ent, n_rel=237, n_triples=args.n_train,
                   n_valid=1000, n_test=1000, seed=7)
    index = build_kg_index(ds, for_eval=False)

    ncpu = _os.cpu_count()
    results = {}
    for nt in [int(x) for x in args.threads.split(",")]:
        host = HostSampler(ds, index, n_threads=nt)
        # warm (page in the index arrays)
        host.sample_flat(0, args.batch, args.negative_ent, 0, True)
        rates = []
        for run in range(5):
            t0 = time.perf_counter()
            for s in range(args.steps):
                host.sample_flat(run * args.steps + s + 1, args.batch,
                                 args.negative_ent, 0, True)
            rates.append(args.steps * args.batch
                         / (time.perf_counter() - t0))
        med = float(np.median(rates))
        spread = float((max(rates) - min(rates)) / med)
        results[nt] = med
        print(json.dumps({"threads": nt,
                          "positives_per_sec": round(med, 1),
                          "spread": round(spread, 3)}), flush=True)
        del host

    best_nt = max(results, key=results.get)
    print(json.dumps({
        "metric": "host_sampler_generation_rate",
        "batch": args.batch, "negative_ent": args.negative_ent,
        "n_ent": args.n_ent, "n_train": args.n_train,
        "host_cpus": ncpu,
        "best_threads": best_nt,
        "best_positives_per_sec": round(results[best_nt], 1),
        "per_thread_scaling": {str(k): round(v / results[min(results)], 2)
                               for k, v in sorted(results.items())},
    }), flush=True)


if __name__ == "__main__":
    main()
