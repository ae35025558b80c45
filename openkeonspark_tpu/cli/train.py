"""Training CLI — the reference's ``main_spark.py`` + per-executor
``distribute_training.main_fun`` collapsed into one launcher (SURVEY.md
§3.1): no Spark, no parameter servers; multi-host runs are one process per
host joined via ``jax.distributed`` (see ``cli/launch.py``), single-host
runs are just this script.

Usage (single host):
    python -m openkeonspark_tpu.cli.train --input data/FB15K237 \
        --model transe --hidden_size 200 --alpha 0.01 --train_times 50 \
        --valid_every 5 --test_link_prediction

Incremental mode (reference batch folders ``<input>/0/ 1/ …``):
    python -m openkeonspark_tpu.cli.train --input data/KG --batch_number 2 …
    → trains on data/KG/2/, warm-starting from data/KG-out/1/'s checkpoint.
"""

from __future__ import annotations

import os
import sys

import jax

from openkeonspark_tpu.cli.args import build_parser, config_from_args
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import load_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.models.base import get_model
from openkeonspark_tpu.train.loop import train
from openkeonspark_tpu.train.step import init_state


def run(cfg: Config, echo=print) -> dict:
    """Programmatic entry (the CLI is a thin wrapper). Returns a summary
    dict with final metrics."""
    data_dir = cfg.in_path
    out_dir = cfg.out_path
    if cfg.batch_number is not None:
        data_dir = os.path.join(cfg.in_path, str(cfg.batch_number))
        out_dir = os.path.join(cfg.out_path, str(cfg.batch_number))

    if cfg.coordinator:
        jax.distributed.initialize(coordinator_address=cfg.coordinator,
                                   num_processes=cfg.num_processes,
                                   process_id=cfg.process_id)

    ds = load_dataset(data_dir)
    echo(f"dataset: {ds.n_ent} entities, {ds.n_rel} relations, "
         f"{ds.n_train} train / {ds.n_valid} valid / {ds.n_test} test")
    model = get_model(cfg.model)
    index = build_kg_index(ds, for_eval=(cfg.test_link_prediction or
                                         cfg.test_triple_classification))

    d_axis, m_axis = cfg.mesh_shape
    use_mesh = d_axis * m_axis > 1
    # pad to the full grid size: valid for BOTH sharded-step layouts
    # (flat exchange needs rows % (D·M) == 0, psum needs rows % M == 0)
    pad = d_axis * m_axis if use_mesh else 1
    state = init_state(model, cfg, ds.n_ent, ds.n_rel,
                       jax.random.key(cfg.seed), pad_to_multiple=pad)

    # crash recovery (reference: MonitoredTrainingSession auto-restores
    # the latest checkpoint in checkpoint_dir on restart, SURVEY.md §5):
    # if THIS run's output dir already has a checkpoint, resume from it
    # and only train the remaining epochs — data order replays exactly
    # (train/loop keys derive from the restored global step)
    from openkeonspark_tpu.ckpt import (CheckpointManager, latest_step,
                                        warm_start_from, warm_start_path)
    ls = latest_step(out_dir) if out_dir else None
    if ls is not None:
        logical = {n: s.rows for n, s in
                   model.tables(cfg, ds.n_ent, ds.n_rel).items()}
        state, _ = CheckpointManager(out_dir).restore(
            state, step=ls, logical_rows=logical)
        resumed = int(state.step)
        # epochs completed IN THIS RUN: global step minus the warm-start
        # baseline (incremental batches carry the step counter across)
        base = 0
        if cfg.batch_number is not None:
            prev = warm_start_path(cfg.out_path, cfg.batch_number)
            if prev:
                base = latest_step(prev) or 0
        done = max(0, resumed - base) // max(cfg.nbatches, 1)
        cfg = cfg.replace(train_times=max(0, cfg.train_times - done))
        echo(f"resumed from {out_dir} step {resumed} "
             f"({done} epochs done, {cfg.train_times} remaining)")
    else:
        # incremental warm start from the previous batch's checkpoint
        prev = warm_start_path(cfg.out_path, cfg.batch_number) \
            if cfg.batch_number is not None else None
        if prev:
            def init_fn(m, c, ne, nr):
                return init_state(m, c, ne, nr, jax.random.key(c.seed),
                                  pad_to_multiple=pad)
            state, manifest = warm_start_from(state, prev, model, cfg,
                                              init_fn)
            echo(f"warm start from {prev} (step {int(state.step)})")

    step_builder = None
    if use_mesh:
        from openkeonspark_tpu.parallel import (hier_shape,
                                                make_exchange_step_builder,
                                                make_mesh, shard_state)
        from openkeonspark_tpu.parallel.exchange import plan_sharded_step
        # topology-aware factorization: when the grid spans multiple hosts
        # (cfg.chips_per_host), run the hierarchical two-stage exchange so
        # rows cross DCN once per host (parallel/hier.py)
        hshape = (hier_shape((d_axis, m_axis), cfg.chips_per_host)
                  if cfg.chips_per_host and cfg.sharded_step == "exchange"
                  else None)
        mesh = make_mesh(hshape if hshape else (d_axis, m_axis))
        # round the batch down to a grid multiple so the exchange step's
        # geometry constraint (B/D divisible by M) always holds — the
        # reference's batch is itself a rounding (train_total // nbatches)
        bs = cfg.resolve_batch_size(ds.n_train)
        grid = d_axis * m_axis
        if bs % grid:
            bs = max(grid, bs - bs % grid)
            cfg = cfg.replace(batch_size=bs)
        # owner-directed boundary exchange (cfg.sharded_step='exchange');
        # falls back to the psum step when geometry requires. The state
        # layout must match the step kind: flat full-grid row sharding
        # for the exchange steps, 'model'-only for psum.
        kind = plan_sharded_step(cfg, bs, mesh)
        state = shard_state(state, mesh, flat=(kind != "psum"))
        step_builder = make_exchange_step_builder(mesh)
        echo(f"mesh: data={d_axis} model={m_axis} "
             f"({len(mesh.devices.flat)} devices"
             + (f", {len(mesh.devices.flat) // cfg.chips_per_host} hosts"
                if hshape else "")
             + f") step={kind}")

    # early-stop validation on a mesh goes through the sharded triple
    # scorer (triples over 'data', rows via masked-take+psum over 'model')
    # — the single-device scorer would pull sharded rows through auto-SPMD
    # gathers and cannot run at all once tables exceed one device
    valid_fn = None
    if step_builder is not None and cfg.valid_every and ds.valid is not None \
            and len(ds.valid):
        from openkeonspark_tpu.eval.classification import fit_thresholds
        from openkeonspark_tpu.parallel.eval import ShardedTripleScorer
        scorer = ShardedTripleScorer(cfg, mesh)

        def valid_fn(st):
            _, acc = fit_thresholds(st.params, cfg, ds, index,
                                    seed=cfg.seed + 1, score_fn=scorer)
            return acc

    result = train(cfg, ds, index=index, state=state,
                   step_builder=step_builder, checkpoint_dir=out_dir,
                   valid_fn=valid_fn, echo=echo)
    state = result.state

    # export embeddings (reference Config.save_parameters → vec.json)
    from openkeonspark_tpu.ckpt import CheckpointManager, export_parameters
    fmt = getattr(cfg, "export_format", "json")
    export_name = "embedding.vec.json" if fmt == "json" else "embedding.npz"
    export_parameters(state.params, model, cfg, ds.n_ent, ds.n_rel,
                      os.path.join(out_dir, export_name), fmt=fmt)
    # final manifest records vocab sizes for future warm starts
    CheckpointManager(out_dir).save(
        int(state.step), state,
        extra={"n_ent": ds.n_ent, "n_rel": ds.n_rel, "model": cfg.model,
               "hidden_size": cfg.hidden_size,
               "final_loss": result.final_loss})

    summary = {"final_loss": result.final_loss,
               "stopped_early": result.stopped_early,
               "best_valid_accuracy": result.best_valid_accuracy,
               "steps": int(state.step)}

    if cfg.test_link_prediction and ds.n_test:
        if use_mesh:
            from openkeonspark_tpu.parallel.eval import (
                sharded_link_prediction)
            res = sharded_link_prediction(state.params, cfg, ds, index,
                                          mesh, log=echo)
        else:
            from openkeonspark_tpu.eval import link_prediction
            res = link_prediction(state.params, cfg, ds, index, log=echo)
        echo(res.format_table())
        summary["link_prediction"] = {
            "filtered_mrr": res.filt_avg.mrr,
            "filtered_hits10": res.filt_avg.hits10,
            "raw_mrr": res.raw_avg.mrr,
            "ranks": res.ranks,
        }
        if cfg.type_constrain:
            from openkeonspark_tpu.data.type_constrain import maybe_load
            tc = maybe_load(data_dir)
            if tc is None:
                echo("type_constrain.txt not found; skipping constrained "
                     "eval (generate with tools/gen_type_constrain.py)")
            else:
                from openkeonspark_tpu.eval import (
                    type_constrained_link_prediction)
                rc = type_constrained_link_prediction(state.params, cfg, ds,
                                                      index, tc, log=echo)
                echo("type-constrained:")
                echo(rc.format_table())
                summary["type_constrained"] = {
                    "filtered_mrr": rc.filt_avg.mrr,
                    "filtered_hits10": rc.filt_avg.hits10,
                }
    if cfg.test_triple_classification and ds.n_valid and ds.n_test:
        from openkeonspark_tpu.eval import triple_classification
        out = triple_classification(state.params, cfg, ds, index)
        echo(f"triple classification: {out}")
        summary["triple_classification"] = out
    return summary


def main(argv=None):
    from openkeonspark_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    args = build_parser(__doc__).parse_args(argv)
    cfg = config_from_args(args)
    # export_format isn't part of Config; stash it on the instance dict
    object.__setattr__(cfg, "export_format", args.export_format)
    run(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
