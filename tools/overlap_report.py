"""Overlap evidence for the exchange step's microbatching (VERDICT r2 #5).

Single-chip sandboxes cannot watch a real multi-chip schedule, so this
tool pins the two halves of the overlap story that ARE checkable here:

1. **Chain independence (HLO def-use reachability).** For each
   ``exchange_microbatches`` setting, lower the exchange step on an
   8-virtual-device CPU mesh, build the def-use graph of the entry
   computation, and count collective pairs with NO path between them.
   Chains that are mutually unreachable are exactly what XLA's
   latency-hiding scheduler is free to overlap on an accelerator (it cannot overlap
   data-dependent ops no matter what we wish). CPU lowers collectives
   synchronously (verified: zero ``-start``/``-done`` pairs in the
   compiled module), so the *schedule* itself is not evidence — the
   dependency structure is.
2. **The microbatch overhead curve.** Wall-clock per step on the CPU
   mesh (overlap-free backend → pure cost of splitting), plus the
   per-device wire bytes from the payload accounting. More chunks =
   more, smaller collectives + more program; the default should pay
   that only while it buys hideable comm.

Usage: python tools/overlap_report.py [--mesh 2,4] [--mbs 1,2,4,8]
Prints one JSON line per setting.
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import re
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

_COLLECTIVES = ("all-to-all", "all-gather", "all-reduce", "reduce-scatter",
                "collective-permute")
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\S+\s+([\w\-]+)\((.*)$")


def _computations(hlo_text: str):
    """(name, body-lines) per computation — headers are 'name ... {' lines
    at zero indent, bodies end at a lone '}'."""
    name, buf = None, []
    for ln in hlo_text.splitlines():
        if name is None:
            s = ln.strip()
            if s.endswith("{") and not ln.startswith(" "):
                name = s.split()[0].lstrip("%").split("(")[0]
                buf = []
        else:
            if ln.strip() == "}":
                yield name, buf
                name = None
            else:
                buf.append(ln)


def entry_dependency_stats(hlo_text: str) -> dict:
    """Def-use reachability between collective ops in the computation that
    holds them (the shard_map body). Returns counts of ordered collective
    pairs (i before j) split into dependent (a path i→j exists) vs
    independent (none — schedulable concurrently by a latency-hiding
    scheduler)."""
    def is_coll(op):
        return any(op.startswith(k) for k in _COLLECTIVES)

    # pick the computation with the most collective ops
    best_body, best_n = [], -1
    for _, body in _computations(hlo_text):
        n = sum(1 for ln in body
                if (m := _DEF_RE.match(ln)) and is_coll(m.group(2)))
        if n > best_n:
            best_body, best_n = body, n

    defs = {}          # name -> (index, op_kind, operand names)
    order = []
    for ln in best_body:
        m = _DEF_RE.match(ln)
        if not m:
            continue
        name, op, rest = m.group(1), m.group(2), m.group(3)
        # operands: bare names up to the closing paren of the operand list
        oplist = rest.split(")")[0]
        operands = [o for o in re.findall(r"[\w.\-]+", oplist) if o != name]
        defs[name] = (len(order), op, operands)
        order.append(name)

    # transitive reachability via DFS from each collective (graphs here
    # are a few hundred nodes; fine)
    coll = [n for n in order if is_coll(defs[n][1])]
    children = {n: [] for n in order}
    for n in order:
        for o in defs[n][2]:
            if o in defs:
                children[o].append(n)

    def reachable_from(src):
        seen, stack = set(), [src]
        while stack:
            x = stack.pop()
            for c in children[x]:
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen

    reach = {n: reachable_from(n) for n in coll}
    dep = indep = 0
    for i, a in enumerate(coll):
        for b in coll[i + 1:]:
            if b in reach[a] or a in reach.get(b, ()):
                dep += 1
            else:
                indep += 1
    return {"collectives": len(coll), "dependent_pairs": dep,
            "independent_pairs": indep}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2,4",
                    help="2 ints = flat exchange; 3 = hierarchical "
                         "(host,data,model), e.g. 2,2,2")
    ap.add_argument("--mbs", default="1,2,4,8")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--hot-rows", type=int, default=0)
    ap.add_argument("--capacity", default="uniform",
                    choices=["uniform", "stats"])
    args = ap.parse_args()
    mesh_shape = tuple(int(x) for x in args.mesh.split(","))

    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.index import build_kg_index
    from openkeonspark_tpu.data.synth import random_kg
    from openkeonspark_tpu.models import get_model
    from openkeonspark_tpu.parallel import make_mesh, shard_state
    from openkeonspark_tpu.parallel.comm import hlo_collective_bytes
    from openkeonspark_tpu.parallel import sync_hot_cache
    from openkeonspark_tpu.parallel.exchange import build_train_step_for
    from openkeonspark_tpu.sampling.device import DeviceSampler
    from openkeonspark_tpu.train.step import init_state

    ds = random_kg(n_ent=4096, n_rel=64, n_triples=40000, n_valid=100,
                   n_test=100, seed=0)
    model_name = "transe"
    B = 2048
    mesh = make_mesh(mesh_shape)
    n_grid = 1
    for x in mesh_shape:
        n_grid *= x
    model = get_model(model_name)
    index = build_kg_index(ds, for_eval=False)
    sampler = DeviceSampler.build(ds, index)

    for mb in [int(x) for x in args.mbs.split(",")]:
        cfg = Config(model=model_name, hidden_size=128, negative_ent=4,
                     exchange_microbatches=mb,
                     exchange_hot_rows=args.hot_rows,
                     exchange_capacity=args.capacity)
        state = init_state(model, cfg, ds.n_ent, ds.n_rel, jax.random.key(0),
                           pad_to_multiple=n_grid)
        state = shard_state(state, mesh, flat=True)
        if args.hot_rows:
            state = sync_hot_cache(state, model, cfg, sampler)
        step = build_train_step_for(model, cfg, sampler, B, mesh)
        jitted = jax.jit(step)
        lowered = jitted.lower(state, sampler, jax.random.key(1))
        hlo = lowered.compiler_ir(dialect="hlo").as_hlo_text()
        stats = entry_dependency_stats(hlo)
        payload = hlo_collective_bytes(hlo)

        run = jitted  # execute for the overhead curve
        st, loss = run(state, sampler, jax.random.key(2))
        float(loss)
        best = float("inf")
        for r in range(3):
            t0 = time.perf_counter()
            for s in range(args.steps):
                st, loss = run(st, sampler,
                               jax.random.fold_in(jax.random.key(3),
                                                  r * args.steps + s))
            float(loss)
            best = min(best, (time.perf_counter() - t0) / args.steps)

        print(json.dumps({
            "microbatches": mb, "mesh": list(mesh_shape),
            **stats,
            "wire_bytes_per_device": payload["wire"],
            "cpu_mesh_ms_per_step": round(best * 1e3, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
