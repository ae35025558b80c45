"""The fused training step: sample → gather → score → loss → sparse update,
all inside one XLA program, with a ``lax.scan`` wrapper that runs many steps
per host call.

Replaces the reference's hot loop (SURVEY.md §3.1): C++ ``sampling()`` into
host buffers + ``sess.run(train_op, feed_dict)`` per step with a gRPC
round-trip to the parameter servers. Here one jitted call advances
``steps_per_scan`` steps with zero host involvement.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import KGEModel, init_tables
from openkeonspark_tpu.sampling.device import DeviceSampler, SampledBatch
from openkeonspark_tpu.train.loss import margin_ranking_loss
from openkeonspark_tpu.train.optim import Updates, make_optimizer


@jax.tree_util.register_pytree_node_class
@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: jax.Array   # int32 global step

    def tree_flatten(self):
        return (self.params, self.opt_state, self.step), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def init_state(model: KGEModel, cfg: Config, n_ent: int, n_rel: int,
               key: jax.Array, pad_to_multiple: int = 1) -> TrainState:
    specs = model.tables(cfg, n_ent, n_rel)
    params = init_tables(key, specs, dtype=jnp.dtype(cfg.dtype),
                         pad_to_multiple=pad_to_multiple)
    if cfg.exchange_hot_rows:
        from openkeonspark_tpu.parallel.hot import init_hot_params
        params = init_hot_params(params, model, cfg, n_ent,
                                 jnp.dtype(cfg.dtype))
    opt = make_optimizer(cfg)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=jnp.zeros((), jnp.int32))


def _batch_ids(batch: SampledBatch) -> Tuple[jax.Array, jax.Array, jax.Array, int]:
    """Flatten positives + negatives into one id stream per anchor, positives
    first (reference slot layout, ``Model.py`` get_*_instance)."""
    B = batch.h.shape[0]
    hs, ts, rs = [batch.h], [batch.t], [batch.r]
    n_neg = 0
    if batch.neg_h is not None:
        k = batch.neg_h.shape[1]
        # transpose to [k, B] then flatten → slot j + B*(1+i) layout
        hs.append(batch.neg_h.T.reshape(-1))
        ts.append(batch.neg_t.T.reshape(-1))
        rs.append(jnp.tile(batch.r, (k,)))
        n_neg += k
    if batch.neg_rel is not None:
        k = batch.neg_rel.shape[1]
        hs.append(jnp.tile(batch.h, (k,)))
        ts.append(jnp.tile(batch.t, (k,)))
        rs.append(batch.neg_rel.T.reshape(-1))
        n_neg += k
    return (jnp.concatenate(hs), jnp.concatenate(ts), jnp.concatenate(rs),
            n_neg)


def slot_loss_and_grads(model: KGEModel, cfg: Config, slots: dict,
                        B: int, n_neg: int):
    """Scalar loss + gradients w.r.t. the gathered row bundle ``slots`` —
    shared by the single-device and sharded (``parallel/``) steps.

    Slots may be flat [(1+n_neg)·B, d] or — for slots whose segments are
    all identical, e.g. relation-anchored rows when every negative shares
    the positive's r — a single [B, d] block. Everything is viewed as
    [S, B, d] and the models' broadcast-polymorphic score fns do the rest:
    an S=1 slot is *read once* per batch row (for TransR's [dₑ×dᵣ]
    projection matrices that read is the step's dominant traffic)."""

    def loss_fn(slots_):
        shaped = {k: v.reshape(v.shape[0] // B, B, v.shape[-1])
                  for k, v in slots_.items()}
        scores = model.score(shaped, cfg)          # [S, B] (S = 1 + n_neg)
        scores = jnp.broadcast_to(scores, (1 + n_neg, B))
        return margin_ranking_loss(scores[0], scores[1:].T, cfg.margin,
                                   cfg.loss_mode)

    return jax.value_and_grad(loss_fn)(slots)


def merged_row_updates(model: KGEModel, batch: SampledBatch,
                       g_slots: dict) -> Updates:
    """(table → [(ids, row-grads)]) with structurally duplicate id streams
    merged — exact dense math, fewer scattered rows.

    The slot layout (``_batch_ids``) repeats anchor ids: an entity-corrupted
    negative keeps its *uncorrupted* side equal to the positive's id, and
    relation-corrupted negatives reuse both entity ids. Merging those
    segments into the positive stream shrinks the entity update from
    ``B(2+2·negE+2·negR)`` to ``B(2+negE)`` rows and the relation update to
    ``B(1+negR)`` — scatter cost grows with the scattered rows, and the
    sharded step all_gathers one stream less per merge."""
    B = batch.h.shape[0]
    nE = batch.neg_h.shape[1] if batch.neg_h is not None else 0
    nR = batch.neg_rel.shape[1] if batch.neg_rel is not None else 0
    ch = [(batch.neg_h[:, k] != batch.h)[:, None] for k in range(nE)]
    corrupted = [jnp.where(ch[k][:, 0], batch.neg_h[:, k], batch.neg_t[:, k])
                 for k in range(nE)]

    def seg(g, i):  # negative segment i of a slot's grad stream
        return g[B * (1 + i):B * (2 + i)]

    by_table: dict = {}
    for slot, table, anchor in model.gathers():
        by_table.setdefault(table, {})[anchor] = g_slots[slot]

    updates: Updates = {}
    for table, a in by_table.items():
        out = updates.setdefault(table, [])
        if "r" in a:
            g = a["r"]
            if g.shape[0] == B:                 # untiled [B, d] slot: the
                out.append((batch.r, g))        # broadcast grad is already
                continue                        # the merged sum
            base = g[:B]
            for k in range(nE):
                base = base + seg(g, k)         # ent-negs reuse r exactly
            for k in range(nR):
                out.append((batch.neg_rel[:, k], seg(g, nE + k)))
            out.append((batch.r, base))
        else:  # entity-kind table: one h-anchored and one t-anchored slot
            gh, gt = a["h"], a["t"]
            base_h, base_t = gh[:B], gt[:B]
            for k in range(nE):
                sh, st = seg(gh, k), seg(gt, k)
                base_h = base_h + jnp.where(ch[k], 0.0, sh)
                base_t = base_t + jnp.where(ch[k], st, 0.0)
                out.append((corrupted[k], jnp.where(ch[k], sh, st)))
            for k in range(nE, nE + nR):        # rel-negs reuse h AND t
                base_h = base_h + seg(gh, k)
                base_t = base_t + seg(gt, k)
            out.append((batch.h, base_h))
            out.append((batch.t, base_t))
    return updates


def gather_slots_structured(model: KGEModel, params: dict,
                            batch: SampledBatch) -> Tuple[dict, int]:
    """Slot row bundles in ``_batch_ids`` layout, but gathering each
    *distinct* id stream once: relation-anchored rows are gathered for the
    positives only and tiled across entity-negative segments (they share
    r exactly), and entity rows are reused across relation-negative
    segments. For TransR this gathers each batch row's [d_e×d_r]
    projection matrix once instead of (1+negE) times — that table's rows
    are 100× wider than the embeddings, and its gather dominated the
    step."""
    nE = batch.neg_h.shape[1] if batch.neg_h is not None else 0
    nR = batch.neg_rel.shape[1] if batch.neg_rel is not None else 0
    slots = {}
    for slot, table, anchor in model.gathers():
        T = params[table]
        if anchor == "r":
            base = jnp.take(T, batch.r, axis=0)
            if nR == 0:
                # every segment shares r: keep ONE [B, d] block — the
                # score layer broadcasts it (never materialized S times)
                slots[slot] = base
                continue
            parts = [base] * (1 + nE)
            parts += [jnp.take(T, batch.neg_rel[:, k], axis=0)
                      for k in range(nR)]
        elif anchor == "h":
            base = jnp.take(T, batch.h, axis=0)
            parts = [base]
            parts += [jnp.take(T, batch.neg_h[:, k], axis=0)
                      for k in range(nE)]
            parts += [base] * nR
        else:
            base = jnp.take(T, batch.t, axis=0)
            parts = [base]
            parts += [jnp.take(T, batch.neg_t[:, k], axis=0)
                      for k in range(nE)]
            parts += [base] * nR
        slots[slot] = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    return slots, nE + nR


def loss_and_row_grads(model: KGEModel, cfg: Config, params: dict,
                       batch: SampledBatch):
    """Scalar loss + gradients w.r.t. the *gathered rows* (never the dense
    tables), plus the merged (table → [(ids, row-grads)]) update list."""
    B = batch.h.shape[0]
    slots, n_neg = gather_slots_structured(model, params, batch)
    loss, g_slots = slot_loss_and_grads(model, cfg, slots, B, n_neg)
    return loss, merged_row_updates(model, batch, g_slots)


def build_train_step(model: KGEModel, cfg: Config, sampler: DeviceSampler,
                     batch_size: int,
                     partition: Optional[Tuple[jax.Array, jax.Array]] = None
                     ) -> Callable:
    """Single-device step fn: (state, sampler, key) → (state, loss).

    The sampler is a **runtime argument**, not a closure: closed-over
    device arrays become executable-embedded constants, which bloat every
    compiled program with the whole triple store. The
    ``sampler`` passed here is used only for its static metadata (sizes,
    search depths, pytree structure)."""
    opt = make_optimizer(cfg)
    del sampler  # static metadata travels inside the runtime argument

    def step_fn(state: TrainState, sampler_: DeviceSampler, key: jax.Array,
                bits: Optional[jax.Array] = None):
        batch = sampler_.sample(key, batch_size, cfg.negative_ent,
                                cfg.negative_rel, cfg.bern,
                                partition=partition, bits=bits)
        loss, updates = loss_and_row_grads(model, cfg, state.params, batch)
        params, opt_state = opt.apply(state.params, state.opt_state, updates,
                                      state.step)
        return TrainState(params, opt_state, state.step + 1), loss

    # scan-fused callers pre-draw the whole group's random bits in one
    # batched PRNG call (per-call threefry dispatch was 66% of the step
    # at B=400, BASELINE.md config #1)
    step_fn.bits_shape = (batch_size,
                          DeviceSampler.bits_cols(cfg.negative_ent,
                                                  cfg.negative_rel))
    return step_fn


def build_host_batch_step(model: KGEModel, cfg: Config) -> Callable:
    """Step fn fed by externally sampled batches (the C++ host sampler's
    pipeline, ``sampling/host.py``): (state, batch) → (state, loss)."""
    opt = make_optimizer(cfg)

    @jax.jit
    def step_fn(state: TrainState, batch: SampledBatch):
        loss, updates = loss_and_row_grads(model, cfg, state.params, batch)
        params, opt_state = opt.apply(state.params, state.opt_state, updates,
                                      state.step)
        return TrainState(params, opt_state, state.step + 1), loss

    return step_fn


def build_host_scan_steps(model: KGEModel, cfg: Config) -> Callable:
    """Scan over a pre-sampled batch group ([S, …]-stacked SampledBatch
    from ``HostPipeline(group_sizes=…)``): (state, batches) → (state,
    mean_loss). One host call and one transfer advance S steps."""
    opt = make_optimizer(cfg)

    @partial(jax.jit, donate_argnums=(0,))
    def run(state: TrainState, batches: SampledBatch):
        def body(st, b):
            loss, updates = loss_and_row_grads(model, cfg, st.params, b)
            params, opt_state = opt.apply(st.params, st.opt_state, updates,
                                          st.step)
            return TrainState(params, opt_state, st.step + 1), loss

        state, losses = jax.lax.scan(body, state, batches)
        return state, jnp.mean(losses)

    return run


def build_scan_steps(step_fn: Callable, steps: int) -> Callable:
    """Fuse ``steps`` train steps into one jitted host call via lax.scan.
    Returns (state, sampler, key) → (state, mean_loss); the sampler rides
    along as a traced argument (see ``build_train_step``).

    When ``step_fn`` advertises ``bits_shape``, the whole group's random
    bits are drawn in ONE batched PRNG call and sliced per step by the
    scan — per-step threefry dispatch was the config-#1 throughput floor."""
    bits_shape = getattr(step_fn, "bits_shape", None)

    @partial(jax.jit, donate_argnums=(0,))
    def run(state: TrainState, sampler: DeviceSampler, key: jax.Array):
        if bits_shape is not None:
            bits = jax.random.bits(key, (steps,) + bits_shape,
                                   dtype=jnp.uint32)
            state, losses = jax.lax.scan(
                lambda s, b: step_fn(s, sampler, key, bits=b), state, bits)
        else:
            keys = jax.random.split(key, steps)
            state, losses = jax.lax.scan(lambda s, k: step_fn(s, sampler, k),
                                         state, keys)
        return state, jnp.mean(losses)

    return run
