"""Link-prediction evaluation throughput per model (test-triples/s).

Measures the full evaluator (both directions, raw+filtered) at the
BASELINE.md eval shape — d=200, FB15K-237-sized entity set, 20k test
triples — including the relation-grouped route for TransR/TransH and
the ``eval_dtype`` knob, on the local GPU (exits non-zero when JAX finds
no GPU).

Protocol: ``--repeats`` timed runs (default 5) after one same-shape
warm-up; the reported number is the **median**, with min/max spread.

Usage: python tools/eval_bench.py [--models transe,transh,transr,transd]
                                  [--dtypes float32,bfloat16]
                                  [--repeats 5]
Prints one JSON line per (model, dtype).
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import statistics
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models",
                    default="transe,transh,transr,transd,rotate")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--n_test", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--eval-chunk", type=int, default=None,
                    help="override cfg.eval_chunk (sweep knob)")
    ap.add_argument("--eval-block", type=int, default=None)
    ap.add_argument("--no-pallas", action="store_true",
                    help="disable the Pallas rank kernel (sweep knob)")
    args = ap.parse_args()

    import jax

    from openkeonspark_tpu.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    require_gpu()
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.eval.link_prediction import link_prediction
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.train.step import init_state

    ds = random_kg(n_ent=14541, n_rel=237, n_triples=272115,
                   n_valid=1000, n_test=args.n_test, seed=7)
    idx = build_kg_index(ds, for_eval=True)

    for name in args.models.split(","):
        cfg0 = Config(model=name, hidden_size=200)
        if name == "transr":
            cfg0 = cfg0.replace(ent_size=200, rel_size=100)
        if args.eval_chunk is not None:
            cfg0 = cfg0.replace(eval_chunk=args.eval_chunk)
        if args.eval_block is not None:
            cfg0 = cfg0.replace(eval_block=args.eval_block)
        if args.no_pallas:
            cfg0 = cfg0.replace(use_pallas_eval=False)
        model = get_model(name)
        state = init_state(model, cfg0, ds.n_ent, ds.n_rel,
                           jax.random.key(3))
        for dt in args.dtypes.split(","):
            cfg = cfg0.replace(eval_dtype=dt)
            # warm with the SAME shape as the timed call — a shorter
            # warm slice changes the scan length, so the timed region
            # would include recompilation (first r3 run: TransE f32
            # "3.7k t/s" was compile time; its bf16 twin hit the cache
            # because eval_dtype doesn't change the TransE program)
            res = link_prediction(state.params, cfg, ds, idx,
                                  triples=ds.test)
            rates = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                res = link_prediction(state.params, cfg, ds, idx,
                                      triples=ds.test)
                rates.append(len(ds.test) / (time.perf_counter() - t0))
            med = statistics.median(rates)
            rec = {
                "model": name, "eval_dtype": dt,
                "n_test": int(len(ds.test)), "n_ent": ds.n_ent,
                "triples_per_sec": round(med, 1),
                "spread": [round(min(rates), 1), round(max(rates), 1)],
                "repeats": args.repeats,
                # random embeddings → MR should hover near n_ent/2; a
                # wildly smaller value would flag a counting bug
                "filt_mr": round(res.filt_avg.mr, 1),
            }
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
