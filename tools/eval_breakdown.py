"""Per-stage eval-time breakdown of the TransE kernel evaluator on the
local GPU (exits non-zero when JAX finds no GPU).

This tool attributes the time the way ``tools/step_breakdown.py`` does
for training: cumulative prefixes of the per-chunk eval pipeline (filter
windows → query prep → gold scores → candidate sweep → known-true
filter), each its own scan-fused jitted program over the same chunk
inputs, plus the isolated fused kernel at the evaluator's exact shapes
and the end-to-end ``link_prediction`` wall time (host prep + device +
host pulls).

Usage: python tools/eval_breakdown.py [--n-test 2048] [--chunk 256]
Prints one JSON line per measurement + a summary line.
"""

from __future__ import annotations

# Runnable from a clean shell without installing the package.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _timed(fn, *args, repeats=3):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--n-ent", type=int, default=14541)
    ap.add_argument("--d", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=256, help="eval chunk")
    args = ap.parse_args()

    from openkeonspark_tpu.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    require_gpu()

    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.eval.link_prediction import (_known_window,
                                                        link_prediction)
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.eval.scoring import build_queries
    from openkeonspark_tpu.ops.pallas_rank import (count_better,
                                                   residual_scores)
    from openkeonspark_tpu.train.step import init_state

    ds = random_kg(n_ent=args.n_ent, n_rel=237, n_triples=272115,
                   n_valid=1000, n_test=max(1000, args.n_test), seed=7)
    cfg = Config(model="transe", hidden_size=args.d, eval_chunk=args.chunk)
    model = get_model("transe")
    index = build_kg_index(ds, for_eval=True)
    state = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0))
    params = state.params
    triples = ds.test[: args.n_test]
    n = len(triples)
    chunk = cfg.eval_chunk

    from openkeonspark_tpu.data.dataset import H, R, T
    from openkeonspark_tpu.ops.gather import Packed1D
    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    offt, cntt = index.hr_all.lookup(h_all, r_all)
    k_max = int(max(cntt.max() if n else 0, 1))
    k_max = -(-k_max // 64) * 64
    kvals = Packed1D.build(index.hr_all.sorted_vals.astype(np.int32),
                           pad_value=ds.n_ent)
    table_t = params["ent_embeddings"]

    pad = (-n) % chunk
    ext = lambda a: np.concatenate([a, np.repeat(a[:1], pad)]) if pad else a
    nc = (n + pad) // chunk
    c2 = lambda a: jnp.asarray(ext(a).reshape(nc, chunk))
    hq, tq, rq = c2(h_all), c2(t_all), c2(r_all)
    ot, ct = c2(offt), c2(cntt)
    p = cfg.p_norm

    # --- cumulative prefixes of the tail-direction chunk pipeline ------
    def scan_chunks(stage):
        @jax.jit
        def run(params_, table_t_, kv, h_, t_, r_, ot_, ct_):
            def body(acc, inp):
                return acc + stage(params_, table_t_, kv, *inp), None
            acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32),
                                  (h_, t_, r_, ot_, ct_))
            return acc
        return run

    def st_windows(params_, table_t_, kv, h_, t_, r_, ko, kc):
        kn = _known_window(kv, ko, kc, k_max, ds.n_ent)
        return jnp.sum(kn).astype(jnp.float32)

    def st_queries(params_, table_t_, kv, h_, t_, r_, ko, kc):
        acc = st_windows(params_, table_t_, kv, h_, t_, r_, ko, kc)
        q = build_queries("transe", params_, h_, t_, r_, "tail", cfg)["q"]
        return acc + jnp.sum(q).astype(jnp.float32)

    def st_gold(params_, table_t_, kv, h_, t_, r_, ko, kc):
        acc = st_windows(params_, table_t_, kv, h_, t_, r_, ko, kc)
        q = build_queries("transe", params_, h_, t_, r_, "tail", cfg)["q"]
        gold_s = residual_scores(q, jnp.take(table_t_, t_, 0), -1.0, p)
        return acc + jnp.sum(gold_s)

    def st_sweep(params_, table_t_, kv, h_, t_, r_, ko, kc):
        acc = st_windows(params_, table_t_, kv, h_, t_, r_, ko, kc)
        q = build_queries("transe", params_, h_, t_, r_, "tail", cfg)["q"]
        gold_s = residual_scores(q, jnp.take(table_t_, t_, 0), -1.0, p)
        raw = count_better(q, table_t_, gold_s, t_, sign=-1.0, p=p,
                           n_ent=ds.n_ent)
        return acc + jnp.sum(raw).astype(jnp.float32)

    def st_known(params_, table_t_, kv, h_, t_, r_, ko, kc):
        acc = st_windows(params_, table_t_, kv, h_, t_, r_, ko, kc)
        q = build_queries("transe", params_, h_, t_, r_, "tail", cfg)["q"]
        gold_s = residual_scores(q, jnp.take(table_t_, t_, 0), -1.0, p)
        raw = count_better(q, table_t_, gold_s, t_, sign=-1.0, p=p,
                           n_ent=ds.n_ent)
        known = _known_window(kv, ko, kc, k_max, ds.n_ent)
        kn = jnp.minimum(known, jnp.int32(params_["ent_embeddings"].shape[0]
                                          - 1))
        ks = residual_scores(q, jnp.take(table_t_, kn, 0), -1.0, p)
        kvalid = (known < ds.n_ent) & (known != t_[:, None])
        kb = jnp.sum((ks < gold_s[:, None]) & kvalid, axis=1)
        return acc + jnp.sum(raw - kb).astype(jnp.float32)

    stages = [("filter_windows", st_windows), ("query_prep", st_queries),
              ("gold_scores", st_gold), ("candidate_sweep", st_sweep),
              ("known_filter", st_known)]
    cum = {}
    for name, fn in stages:
        t = _timed(scan_chunks(fn), params, table_t, kvals, hq, tq, rq,
                   ot, ct)
        cum[name] = t
        print(json.dumps({"stage": name, "ms_per_direction":
                          round(t * 1e3, 2)}), flush=True)

    # --- isolated fused kernel at the evaluator's exact shapes ---------
    q0 = build_queries("transe", params, hq[0], tq[0], rq[0], "tail",
                       cfg)["q"]
    gold0 = residual_scores(q0, jnp.take(table_t, tq[0], 0), -1.0, p)

    @jax.jit
    def iso_kernel(q_, table_t_, gold_s_, gold_):
        def body(acc, _):
            raw = count_better(q_, table_t_, gold_s_, gold_, sign=-1.0,
                               p=p, n_ent=ds.n_ent)
            return acc + jnp.sum(raw).astype(jnp.float32), None
        acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32), None,
                              length=nc)
        return acc

    t_iso = _timed(iso_kernel, q0, table_t, gold0, tq[0])
    kernel_scores_s = nc * chunk * ds.n_ent / t_iso
    print(json.dumps({"stage": "isolated_kernel_same_shapes",
                      "ms_per_direction": round(t_iso * 1e3, 2),
                      "scores_per_sec": round(kernel_scores_s / 1e9, 2)}),
          flush=True)

    # --- end-to-end: full link_prediction (host prep + both directions +
    # host pulls) ------------------------------------------------------
    link_prediction(params, cfg, ds, index, triples=triples)  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        link_prediction(params, cfg, ds, index, triples=triples)
        best = min(best, time.perf_counter() - t0)
    e2e_tps = n / best
    e2e_scores = e2e_tps * 2 * ds.n_ent

    prev, attr = 0.0, {}
    for name, _ in stages:
        attr[name] = cum[name] - prev
        prev = cum[name]
    # both directions run the same pipeline; host side = e2e − 2×device
    host = best - 2 * cum["known_filter"]
    print(json.dumps({
        "model": "transe", "d": args.d, "n_ent": ds.n_ent,
        "n_test": n, "chunk": chunk, "k_max": k_max,
        "ms_attributed_per_direction": {k: round(v * 1e3, 2)
                                        for k, v in attr.items()},
        "ms_host_and_dispatch": round(host * 1e3, 2),
        "end_to_end_triples_per_sec": round(e2e_tps, 1),
        "end_to_end_scores_per_sec_G": round(e2e_scores / 1e9, 2),
        "isolated_kernel_scores_per_sec_G": round(kernel_scores_s / 1e9, 2),
        "kernel_share_of_direction": round(
            attr["candidate_sweep"] / cum["known_filter"], 3),
    }), flush=True)


if __name__ == "__main__":
    main()
