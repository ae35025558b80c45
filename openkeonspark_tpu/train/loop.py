"""Training driver: epochs × batches with validation-accuracy early
stopping, checkpointing, warm start, and a first-class triples/s meter.

Replaces the reference's two training drivers (SURVEY.md §3.1–3.2):
``Config.run()``'s local epoch loop (``Config.py:~300–400`` reconstructed)
and ``distribute_training.py``'s per-worker loop with periodic
triple-classification validation and early stopping (``~1–320``). The
reference pays a host↔device round trip per batch (C++ ``sampling()`` +
``sess.run``); here ``steps_per_scan`` whole steps (sampling included) are
fused into one ``lax.scan`` so the host only sees per-epoch boundaries.

The throughput meter reports **positive triples consumed per second** —
the north-star metric of BASELINE.md — measured over device-synchronized
wall time."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax
import numpy as np

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import Dataset
from openkeonspark_tpu.data.index import KGIndex, build_kg_index
from openkeonspark_tpu.models.base import get_model
from openkeonspark_tpu.sampling.device import DeviceSampler
from openkeonspark_tpu.train.step import (TrainState, build_scan_steps,
                                          build_train_step, init_state)


@dataclass
class EpochStats:
    epoch: int
    loss: float
    seconds: float
    triples_per_sec: float
    valid_accuracy: Optional[float] = None


@dataclass
class TrainResult:
    state: TrainState
    history: List[EpochStats] = field(default_factory=list)
    stopped_early: bool = False
    best_valid_accuracy: Optional[float] = None
    best_epoch: Optional[int] = None

    @property
    def final_loss(self) -> float:
        return self.history[-1].loss if self.history else float("nan")


class _Logger:
    def __init__(self, cfg: Config, echo: Callable[[str], None] = print):
        self.echo = echo
        self.f = None
        if cfg.log_path:
            os.makedirs(os.path.dirname(os.path.abspath(cfg.log_path)) or ".",
                        exist_ok=True)
            self.f = open(cfg.log_path, "a")

    def __call__(self, record: Dict):
        if self.f is not None:
            self.f.write(json.dumps(record) + "\n")
            self.f.flush()
        msg = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items())
        self.echo(msg)

    def close(self):
        if self.f is not None:
            self.f.close()


def train(cfg: Config, ds: Dataset, index: Optional[KGIndex] = None,
          state: Optional[TrainState] = None,
          step_builder: Optional[Callable] = None,
          checkpoint_dir: Optional[str] = None,
          valid_fn: Optional[Callable] = None,
          epoch_callback: Optional[Callable] = None,
          echo: Callable[[str], None] = print) -> TrainResult:
    """Run the full training schedule.

    - ``state``: resume/warm-start state (default: fresh init).
    - ``step_builder(model, cfg, sampler, batch_size) -> step_fn``: override
      to inject the sharded multi-device step (``parallel/``); default is
      the single-device fused step.
    - ``valid_fn(state) -> float``: validation metric for early stopping
      (default: triple-classification accuracy on the valid split, the
      reference's signal); higher is better.
    - ``checkpoint_dir``: save ``step_N`` checkpoints on improvement + at
      the end (reference: MonitoredTrainingSession + chief export).
    - ``epoch_callback(epoch, state)``: invoked after every epoch (the
      compat facade's periodic ``set_export_files(..., steps)`` export,
      reference ``export_steps`` semantics).
    """
    model = get_model(cfg.model)
    if index is None:
        index = build_kg_index(ds, for_eval=False)
    batch_size = cfg.resolve_batch_size(ds.n_train)

    if state is None:
        state = init_state(model, cfg, ds.n_ent, ds.n_rel,
                           jax.random.key(cfg.seed))

    host_pipe = None
    if cfg.sampler == "host":
        # C++ host sampler + prefetch pipeline (sampling/host.py): groups
        # of steps_per_scan batches ship as ONE stacked transfer and scan
        # on device — the per-step host→device round trip dominated
        # otherwise
        from openkeonspark_tpu.sampling.host import HostPipeline, HostSampler
        from openkeonspark_tpu.train.step import build_host_scan_steps
        host = HostSampler(ds, index, n_threads=cfg.work_threads)
        sps_h = max(1, min(cfg.scan_group_size(batch_size), cfg.nbatches))
        nf_h, rem_h = divmod(cfg.nbatches, sps_h)
        host_groups = [sps_h] * nf_h + ([rem_h] if rem_h else [])
        # exact-resume data order for the host sampler too: the worker's
        # seed chain is seed + batch_index, so starting it at the RESTORED
        # global step continues the uninterrupted run's order (same
        # contract the device sampler gets from step-derived keys below)
        host_pipe = HostPipeline(host, batch_size, cfg.negative_ent,
                                 cfg.negative_rel, cfg.bern,
                                 seed=cfg.seed + int(state.step),
                                 group_sizes=host_groups)
        host_step = build_host_scan_steps(model, cfg)
    else:
        sampler = DeviceSampler.build(ds, index)
        if cfg.exchange_hot_rows:
            # refresh the replicated hot companions from the authoritative
            # sharded tables (fresh init, warm start, or restore) before
            # the hierarchical step reads them (parallel/hot.py)
            from openkeonspark_tpu.parallel.hot import sync_hot_cache
            state = sync_hot_cache(state, model, cfg, sampler)
        build = step_builder or build_train_step
        step_fn = build(model, cfg, sampler, batch_size)
        sps = max(1, min(cfg.scan_group_size(batch_size), cfg.nbatches))
        n_full, rem = divmod(cfg.nbatches, sps)
        run_full = build_scan_steps(step_fn, sps)
        run_rem = build_scan_steps(step_fn, rem) if rem else None

    if cfg.valid_every and valid_fn is None and ds.valid is not None \
            and len(ds.valid):
        eval_index = build_kg_index(ds, for_eval=True)

        def valid_fn(st):
            from openkeonspark_tpu.eval.classification import fit_thresholds
            _, acc = fit_thresholds(st.params, cfg, ds, eval_index,
                                    seed=cfg.seed + 1)
            return acc

    ckpt = None
    if checkpoint_dir:
        from openkeonspark_tpu.ckpt import CheckpointManager
        ckpt = CheckpointManager(checkpoint_dir)

    log = _Logger(cfg, echo)
    result = TrainResult(state=state)
    best_acc, best_epoch, bad_checks = -np.inf, None, 0
    # keys derive from the RESTORED global step, not a fresh split chain:
    # resuming from a checkpoint replays the exact data order the
    # uninterrupted run would have seen (the reference gets this from
    # MonitoredTrainingSession restoring global_step, SURVEY.md §5)
    key_base = jax.random.key(cfg.seed + 17)
    step0 = int(state.step)
    scan_step = 0

    try:
        for epoch in range(cfg.train_times):
            # profiling subsystem (SURVEY.md §5 "Tracing"): capture a
            # device trace of the SECOND epoch (first is compile-skewed)
            tracing = bool(cfg.trace_dir) and epoch == 1
            if tracing:
                jax.profiler.start_trace(cfg.trace_dir)
            t0 = time.perf_counter()
            losses = []
            if host_pipe is not None:
                for size in host_groups:
                    state, loss = host_step(state, host_pipe.next())
                    # group mean weighted to an epoch mean over nbatches
                    losses.extend([loss] * size)
            else:
                for _ in range(n_full):
                    sub = jax.random.fold_in(key_base, step0 + scan_step)
                    scan_step += sps
                    state, loss = run_full(state, sampler, sub)
                    losses.append(loss)
                if run_rem is not None:
                    sub = jax.random.fold_in(key_base, step0 + scan_step)
                    scan_step += rem
                    state, loss = run_rem(state, sampler, sub)
                    losses.append(loss)
            # wait for the device before reading the clock; the losses
            # are then read without a further wait
            jax.block_until_ready((state.params, losses))
            mean_loss = float(np.mean([float(l) for l in losses]))
            if tracing:
                jax.profiler.stop_trace()
                log({"event": "trace_written", "dir": cfg.trace_dir})
            dt = time.perf_counter() - t0
            tps = cfg.nbatches * batch_size / dt

            stats = EpochStats(epoch=epoch, loss=mean_loss, seconds=dt,
                               triples_per_sec=tps)

            if cfg.valid_every and valid_fn is not None \
                    and (epoch + 1) % cfg.valid_every == 0:
                acc = float(valid_fn(state))
                stats.valid_accuracy = acc
                if acc > best_acc + cfg.early_stop_min_delta:
                    best_acc, best_epoch, bad_checks = acc, epoch, 0
                    if ckpt is not None:
                        ckpt.save(int(state.step), state,
                                  extra={"valid_accuracy": acc,
                                         "epoch": epoch})
                else:
                    bad_checks += 1

            result.history.append(stats)
            if epoch_callback is not None:
                epoch_callback(epoch, state)
            # log_every=0 silences per-epoch records (compat set_log_on(0))
            if cfg.log_every and (epoch + 1) % cfg.log_every == 0:
                rec = {"epoch": epoch, "loss": mean_loss,
                       "triples_per_sec": round(tps, 1),
                       "seconds": round(dt, 3)}
                if stats.valid_accuracy is not None:
                    rec["valid_accuracy"] = stats.valid_accuracy
                log(rec)

            if cfg.valid_every and bad_checks >= cfg.early_stop_patience:
                result.stopped_early = True
                log({"event": "early_stop", "epoch": epoch,
                     "best_valid_accuracy": best_acc,
                     "best_epoch": best_epoch})
                break

        result.state = state
        result.best_valid_accuracy = None if best_epoch is None else best_acc
        result.best_epoch = best_epoch
        if ckpt is not None:
            ckpt.save(int(state.step), state,
                      extra={"final": True,
                             "loss": result.final_loss})
    finally:
        log.close()
        if host_pipe is not None:
            host_pipe.close()
    return result
