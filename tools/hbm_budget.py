"""Per-device memory budget audit.

BASELINE.json config #5 ("TransE d=256, 10M+-triple DBpedia-scale KG,
edge-partitioned") needs its memory story stated, not assumed: this
prints the per-device ledger — sharded tables, optimizer slots,
replicated sampler store, hot companions, exchange workspace — for a
(model, shape, mesh) triple. These are byte counts from formulas; what
a run really takes is ``memory_stats()["peak_bytes_in_use"]`` on the
device.

Sizes are exact formulas from the implementation:
- tables: ``model.tables(cfg, n_ent, n_rel)`` rows padded to the grid,
  rows/grid per device, x4 bytes (cfg.dtype), x(1 + optimizer slots).
- sampler store: measured 76 B/triple at FB15K-237 shape
  (``DeviceSampler.store_bytes`` — 36 B packed record + ~2x4 B adjacency
  per triple), REPLICATED per device (every data shard draws from its
  partition of the same resident store).
- exchange workspace: the a2a buffers (caps x d x wire bytes, both
  stages, x microbatches) + dedup scratch (sort keys) — the peak live
  set, conservatively summed.
- hot companions: K x d x 4 x (1 + slots), replicated.

Usage: python tools/hbm_budget.py [--config 5] [--mesh 2x2x2]
"""

from __future__ import annotations

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json

CONFIG5 = dict(model="transe", d=256, n_ent=2_000_000, n_rel=4000,
               n_train=10_000_000, batch_per_dev=10000)
CONFIG2 = dict(model="transe", d=200, n_ent=14541, n_rel=237,
               n_train=272115, batch_per_dev=2721)

STORE_B_PER_TRIPLE = 76    # measured, DESIGN.md "Host-sampler crossover"
OPT_SLOTS = {"sgd": 0, "adam": 2, "adagrad": 1, "adadelta": 2}


def budget(spec, mesh, opt="sgd", hot_rows=0, wire_bytes=2,
           microbatches=2, slack_rows=1.25):
    n_grid = 1
    for s in mesh:
        n_grid *= s
    if len(mesh) == 3:
        H, Di, M = mesh
        L = Di * M
    else:
        H, (Di, M) = 1, mesh
        L = Di * M
    d = spec["d"]
    rows = -(-spec["n_ent"] // n_grid) * n_grid
    slots = OPT_SLOTS[opt]
    ent_table = rows * d * 4 / n_grid * (1 + slots)
    rel_table = spec["n_rel"] * d * 4 * (1 + slots) / min(n_grid,
                                                          spec["n_rel"])
    store = spec["n_train"] * STORE_B_PER_TRIPLE
    hot = hot_rows * d * 4 * (1 + slots)
    # exchange workspace: per microbatch chunk, gather + update streams
    # of ~4*b_sub ids each -> dedup scratch (2 sorts x 8 B) + bucketed
    # a2a buffers (<= stream x d x wire both stages) — peak, not sum of
    # all chunks (chunks are sequential)
    d_glob = H * Di
    b_sub = spec["batch_per_dev"] * n_grid // d_glob // M // microbatches
    stream = 4 * b_sub
    workspace = (stream * 16                      # dedup sort scratch
                 + 2 * stream * d * wire_bytes    # stage-1 a2a in+out
                 + 2 * stream * d * wire_bytes    # stage-2 a2a in+out
                 + stream * d * 4) * slack_rows   # f32 accum copies
    total = ent_table + rel_table + store + hot + workspace
    return {
        "mesh": "x".join(map(str, mesh)), "devices": n_grid, "opt": opt,
        "ent_table_MB": round(ent_table / 1e6, 1),
        "rel_table_MB": round(rel_table / 1e6, 1),
        "sampler_store_MB": round(store / 1e6, 1),
        "hot_companions_MB": round(hot / 1e6, 1),
        "exchange_workspace_MB": round(workspace / 1e6, 1),
        "total_MB": round(total / 1e6, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=5, choices=[2, 5])
    ap.add_argument("--mesh", default="")
    ap.add_argument("--opt", default="sgd",
                    choices=sorted(OPT_SLOTS))
    ap.add_argument("--hot-rows", type=int, default=4096)
    args = ap.parse_args()
    spec = CONFIG5 if args.config == 5 else CONFIG2

    meshes = ([tuple(int(x) for x in args.mesh.split("x"))] if args.mesh
              else [(1, 1), (2, 2), (2, 2, 2), (4, 2, 2)])
    rows = [budget(spec, m, opt=args.opt, hot_rows=args.hot_rows
                   if len(m) == 3 else 0) for m in meshes]
    print("| mesh | devices | ent tbl | rel tbl | store | hot | "
          "workspace | total |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['mesh']} | {r['devices']} | {r['ent_table_MB']} | "
              f"{r['rel_table_MB']} | {r['sampler_store_MB']} | "
              f"{r['hot_companions_MB']} | {r['exchange_workspace_MB']} | "
              f"{r['total_MB']} MB |")
    print(json.dumps({"config": args.config, "opt": args.opt,
                      "rows": rows}))


if __name__ == "__main__":
    main()
