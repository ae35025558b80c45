"""Per-stage step-time breakdown for a bench_all config (VERDICT r2 #3/#7).

Times cumulative prefixes of the training step — sampling → +gather →
+score → +grad → full step — each as its own scan-fused jitted program,
plus the isolated hot ops (the wide-row scatter, the m_r gather, the
projection einsum for TransR). Differences between consecutive prefixes
attribute the step time; the isolated ops cross-check the attribution.

Usage: python tools/step_breakdown.py [--config 4] [--steps 50]
Prints one JSON line per measurement.
"""

from __future__ import annotations

# Runnable from a clean shell without installing the package.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import functools
import json
import time

import jax
import jax.numpy as jnp

from tools.bench_all import CONFIGS


def _timed(fn, *args, repeats=3):
    """Best of ``repeats`` timed calls after one warm call, each ended by
    ``block_until_ready``."""
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=4)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    spec = CONFIGS[args.config]

    from openkeonspark_tpu.runtime import enable_compile_cache, require_gpu
    enable_compile_cache()
    require_gpu()
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.sampling.device import DeviceSampler
    from openkeonspark_tpu.train.optim import make_optimizer
    from openkeonspark_tpu.train.step import (gather_slots_structured,
                                              init_state, loss_and_row_grads,
                                              slot_loss_and_grads)

    ds = random_kg(n_ent=spec["n_ent"], n_rel=spec["n_rel"],
                   n_triples=spec["n_train"], n_valid=100, n_test=100,
                   seed=7)
    cfg = Config(model=spec["model"], hidden_size=spec["d"], alpha=0.01,
                 margin=1.0, negative_ent=1, negative_rel=0, bern=True,
                 nbatches=spec["nbatches"])
    if spec["model"] == "transr":
        cfg = cfg.replace(ent_size=spec["d"], rel_size=spec["d_rel"])
    B = spec["n_train"] // spec["nbatches"]
    S = args.steps

    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=False)
    sampler = DeviceSampler.build(ds, index)
    state = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(7))
    opt = make_optimizer(cfg)

    from openkeonspark_tpu.sampling.device import DeviceSampler as _DS
    bits_shape = (S, B, _DS.bits_cols(cfg.negative_ent, cfg.negative_rel))

    def scan_over_keys(stage_fn):
        """Scan ``stage_fn(params, sampler, key, bits) -> scalar`` S times
        with a running-sum carry (defeats DCE without carrying table
        state). Random bits are pre-drawn in ONE batched call exactly like
        the bench path (``build_scan_steps``) — the r5 re-run showed the
        old per-step threefry draws inflating the 'sampling' stage vs
        what training actually pays."""
        @jax.jit
        def run(params, sampler_, key):
            bits = jax.random.bits(key, bits_shape, dtype=jnp.uint32)
            def body(acc, b):
                return acc + stage_fn(params, sampler_, key, b), None
            acc, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32), bits)
            return acc
        return run

    def stage_sample(params, sampler_, key, bits=None):
        b = sampler_.sample(key, B, cfg.negative_ent, cfg.negative_rel,
                            cfg.bern, bits=bits)
        acc = (jnp.sum(b.h) + jnp.sum(b.t) + jnp.sum(b.r)).astype(jnp.float32)
        if b.neg_h is not None:
            acc += (jnp.sum(b.neg_h) + jnp.sum(b.neg_t)).astype(jnp.float32)
        return acc

    def stage_gather(params, sampler_, key, bits=None):
        b = sampler_.sample(key, B, cfg.negative_ent, cfg.negative_rel,
                            cfg.bern, bits=bits)
        slots, _ = gather_slots_structured(model, params, b)
        return sum(jnp.sum(v).astype(jnp.float32) for v in slots.values())

    def stage_score(params, sampler_, key, bits=None):
        b = sampler_.sample(key, B, cfg.negative_ent, cfg.negative_rel,
                            cfg.bern, bits=bits)
        slots, n_neg = gather_slots_structured(model, params, b)
        shaped = {k: v.reshape(v.shape[0] // B, B, v.shape[-1])
                  for k, v in slots.items()}
        return jnp.sum(model.score(shaped, cfg)).astype(jnp.float32)

    def stage_grad(params, sampler_, key, bits=None):
        b = sampler_.sample(key, B, cfg.negative_ent, cfg.negative_rel,
                            cfg.bern, bits=bits)
        loss, updates = loss_and_row_grads(model, cfg, params, b)
        acc = loss
        for pairs in updates.values():
            for ids, g in pairs:
                acc += jnp.sum(g).astype(jnp.float32)
        return acc

    # full step carries real state (donated) — matches bench_all exactly
    @functools.partial(jax.jit, donate_argnums=(0,))
    def full(state_, sampler_, key):
        bits = jax.random.bits(key, bits_shape, dtype=jnp.uint32)
        def body(st, bb):
            b = sampler_.sample(key, B, cfg.negative_ent, cfg.negative_rel,
                                cfg.bern, bits=bb)
            loss, updates = loss_and_row_grads(model, cfg, st.params, b)
            params, opt_state = opt.apply(st.params, st.opt_state, updates,
                                          st.step)
            return type(st)(params, opt_state, st.step + 1), loss
        st, losses = jax.lax.scan(body, state_, bits)
        return st, jnp.mean(losses)

    key = jax.random.key(3)
    results = {}
    stages = [("sampling", stage_sample), ("gather", stage_gather),
              ("score", stage_score), ("grad", stage_grad)]
    for name, fn in stages:
        t, _ = _timed(scan_over_keys(fn), state.params, sampler, key)
        results[name] = t / S
        print(json.dumps({"stage": name, "ms": round(t / S * 1e3, 3)}),
              flush=True)

    # full donates its state: chain the returned state through the calls
    # (re-passing a donated buffer is a use-after-free on the device)
    state, loss = jax.block_until_ready(full(state, sampler, key))
    best = float("inf")
    for r in range(3):
        t0 = time.perf_counter()
        state, loss = jax.block_until_ready(
            full(state, sampler, jax.random.fold_in(key, r)))
        best = min(best, time.perf_counter() - t0)
    results["full"] = best / S

    prev = 0.0
    attributed = {}
    for name, _ in stages:
        attributed[name] = results[name] - prev
        prev = results[name]
    attributed["update"] = results["full"] - prev

    out = {
        "config": args.config, "model": spec["model"], "batch": B,
        "steps_per_call": S,
        "ms_per_step_cumulative": {k: round(v * 1e3, 3)
                                   for k, v in results.items()},
        "ms_per_step_attributed": {k: round(v * 1e3, 3)
                                   for k, v in attributed.items()},
        "triples_per_sec": round(B / results["full"], 1),
    }
    print(json.dumps(out), flush=True)

    # isolated hot ops (TransR: the wide transfer_matrix traffic)
    if spec["model"] == "transr":
        from openkeonspark_tpu.train.optim import scatter_add_rows
        de, dr = cfg.d_ent, cfg.d_rel
        T = state.params["transfer_matrix"]
        rng = jax.random.PRNGKey(0)
        ids = jax.random.randint(rng, (B,), 0, spec["n_rel"], jnp.int32)
        delta = jax.random.normal(rng, (B, de * dr), jnp.float32)

        @jax.jit
        def iso_scatter(T_, ids_, delta_):
            def body(acc, _):
                return scatter_add_rows(acc, ids_, delta_), None
            out, _ = jax.lax.scan(body, T_, None, length=S)
            return jnp.sum(out, dtype=jnp.float32)

        t, _ = _timed(iso_scatter, T, ids, delta)
        print(json.dumps({"op": "wide_scatter_B_rows",
                          "ms": round(t / S * 1e3, 3),
                          "gb_per_s": round(B * de * dr * 4 / (t / S) / 1e9,
                                            1)}), flush=True)

        @jax.jit
        def iso_gather(T_, ids_):
            def body(acc, _):
                return acc + jnp.sum(jnp.take(T_, ids_, axis=0),
                                     dtype=jnp.float32), None
            out, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32), None,
                                  length=S)
            return out

        t, _ = _timed(iso_gather, T, ids)
        print(json.dumps({"op": "m_r_gather_B_rows",
                          "ms": round(t / S * 1e3, 3),
                          "gb_per_s": round(B * de * dr * 4 / (t / S) / 1e9,
                                            1)}), flush=True)

        h_e = jax.random.normal(rng, (2, B, de), jnp.float32)
        m = jax.random.normal(rng, (B, de, dr), jnp.float32)

        @jax.jit
        def iso_einsum(h_, m_):
            def body(acc, _):
                y = jnp.einsum("sbe,ber->sbr", h_, m_,
                               preferred_element_type=jnp.float32)
                return acc + jnp.sum(y), None
            out, _ = jax.lax.scan(body, jnp.zeros((), jnp.float32), None,
                                  length=S)
            return out

        t, _ = _timed(iso_einsum, h_e, m)
        print(json.dumps({"op": "proj_einsum_2seg",
                          "ms": round(t / S * 1e3, 3)}), flush=True)


if __name__ == "__main__":
    main()
