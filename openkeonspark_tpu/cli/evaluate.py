"""Evaluation CLI — the reference's ``Config.test()`` /
``show_link_prediction`` / ``show_triple_classification`` driven from a
saved checkpoint (SURVEY.md §3.3–3.5).

Usage:
    python -m openkeonspark_tpu.cli.evaluate --input data/FB15K237 \
        --checkpoint out/ --model transe --hidden_size 200 \
        --link_prediction --triple_classification
    python -m openkeonspark_tpu.cli.evaluate ... --predict_tail 123,7
"""

from __future__ import annotations

import sys

import jax

from openkeonspark_tpu.cli.args import build_parser, config_from_args
from openkeonspark_tpu.data.dataset import load_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.models.base import get_model
from openkeonspark_tpu.train.step import init_state


def main(argv=None):
    from openkeonspark_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    p = build_parser(__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir written by cli.train")
    p.add_argument("--link_prediction", action="store_true")
    p.add_argument("--triple_classification", action="store_true")
    p.add_argument("--predict_tail", default=None, metavar="H,R",
                   help="top-k tails for (h, r, ?)")
    p.add_argument("--predict_head", default=None, metavar="T,R")
    p.add_argument("--predict_rel", default=None, metavar="H,T")
    p.add_argument("--topk", type=int, default=10)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    ds = load_dataset(cfg.in_path)
    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=True)

    from openkeonspark_tpu.ckpt import CheckpointManager
    # pad tables to the eval grid so the sharded evaluators divide evenly;
    # restore() prefix-copies checkpoints written with a different padding
    grid = cfg.mesh_shape[0] * cfg.mesh_shape[1]
    state = init_state(model, cfg, ds.n_ent, ds.n_rel,
                       jax.random.key(cfg.seed),
                       pad_to_multiple=max(1, grid))
    logical = {n: s.rows for n, s in
               model.tables(cfg, ds.n_ent, ds.n_rel).items()}
    state, manifest = CheckpointManager(args.checkpoint).restore(
        state, logical_rows=logical)
    print(f"restored step {int(state.step)} from {args.checkpoint}")

    # multi-device evaluation when a mesh is configured: candidate axis
    # over 'model', queries/triples over 'data' (VERDICT r3 next #6 —
    # the secondary evaluators shard through the same machinery)
    mesh = None
    if cfg.mesh_shape[0] * cfg.mesh_shape[1] > 1:
        from openkeonspark_tpu.parallel import make_mesh, shard_state
        mesh = make_mesh(cfg.mesh_shape)
        state = shard_state(state, mesh)   # rows over 'model'
        print(f"eval mesh: {cfg.mesh_shape} "
              f"({len(mesh.devices.flat)} devices)")

    if args.link_prediction:
        if mesh is not None:
            from openkeonspark_tpu.parallel.eval import \
                sharded_link_prediction
            res = sharded_link_prediction(state.params, cfg, ds, index,
                                          mesh)
        else:
            from openkeonspark_tpu.eval import link_prediction
            res = link_prediction(state.params, cfg, ds, index)
        print(res.format_table())
        if cfg.type_constrain:
            from openkeonspark_tpu.data.type_constrain import maybe_load
            tc = maybe_load(cfg.in_path)
            if tc is None:
                print("type_constrain.txt not found in dataset dir")
            elif mesh is not None:
                from openkeonspark_tpu.parallel.eval import \
                    sharded_type_constrained_link_prediction
                rc = sharded_type_constrained_link_prediction(
                    state.params, cfg, ds, index, tc, mesh)
                print("type-constrained (sharded):")
                print(rc.format_table())
            else:
                from openkeonspark_tpu.eval import (
                    type_constrained_link_prediction)
                rc = type_constrained_link_prediction(state.params, cfg, ds,
                                                      index, tc)
                print("type-constrained:")
                print(rc.format_table())
    if args.triple_classification:
        from openkeonspark_tpu.eval import triple_classification
        score_fn = None
        if mesh is not None:
            from openkeonspark_tpu.parallel.eval import ShardedTripleScorer
            score_fn = ShardedTripleScorer(cfg, mesh)
        print("triple classification:",
              triple_classification(state.params, cfg, ds, index,
                                    score_fn=score_fn))
    if args.predict_tail:
        from openkeonspark_tpu.eval import predict_tail_entity
        h, r = map(int, args.predict_tail.split(","))
        ids, scores = predict_tail_entity(state.params, cfg, ds.n_ent,
                                          ds.n_rel, h, r, k=args.topk)
        print(f"top-{args.topk} tails for ({h}, r={r}, ?):")
        for i, s in zip(ids, scores):
            print(f"  {i}\t{s:.4f}")
    if args.predict_head:
        from openkeonspark_tpu.eval import predict_head_entity
        t, r = map(int, args.predict_head.split(","))
        ids, scores = predict_head_entity(state.params, cfg, ds.n_ent,
                                          ds.n_rel, t, r, k=args.topk)
        print(f"top-{args.topk} heads for (?, r={r}, {t}):")
        for i, s in zip(ids, scores):
            print(f"  {i}\t{s:.4f}")
    if args.predict_rel:
        from openkeonspark_tpu.eval import predict_relation
        h, t = map(int, args.predict_rel.split(","))
        ids, scores = predict_relation(state.params, cfg, ds.n_ent,
                                       ds.n_rel, h, t, k=args.topk)
        print(f"top-{args.topk} relations for ({h}, ?, {t}):")
        for i, s in zip(ids, scores):
            print(f"  {i}\t{s:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
