"""The sharded SPMD training step (shard_map over the ('data','model')
mesh).

What the reference does per step (SURVEY.md §3.1): each async worker runs
``embedding_lookup`` gathers against PS-hosted tables over gRPC, computes
the margin loss on its triple partition, and sends ``IndexedSlices``
updates back to the PS — the gather/update round trip is the scaling
bottleneck. Re-design here, one XLA program per step:

- **Positives**: each data shard draws its batch from its own contiguous
  triple slice (edge partitioning; same slice convention as the
  reference's per-worker partitions).
- **Gather** from row-sharded tables: every model shard takes its locally
  owned rows (mask + clamp), then one ``psum`` over 'model' assembles full
  rows on all devices — the "PS gather" as a single ICI all-reduce.
- **Update**: the per-shard (ids, row-grads) lists are ``all_gather``ed
  over 'data'; each model shard maps global ids to local rows (non-owned →
  the optimizer's discard sentinel) and applies its masked sparse update.
  Gradients **sum** across data shards — the global batch is the union of
  shard batches, exactly the dense-math gradient of the summed loss.
- Loss is ``psum``ed over 'data' → the global summed loss, replicated.

Synchronous replacement for Hogwild-async PS training; single-shard
numerics are bit-comparable to the single-device step (same sample draw
when mesh=(1,1))."""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import KGEModel
from openkeonspark_tpu.parallel.mesh import DATA, MODEL
from openkeonspark_tpu.sampling.device import DeviceSampler
from openkeonspark_tpu.train.optim import Updates, make_optimizer
from openkeonspark_tpu.train.step import (TrainState, _batch_ids,
                                          slot_loss_and_grads)

try:  # JAX ≥ 0.8 module layout
    from jax import shard_map
except ImportError:  # pragma: no cover - older layout
    from jax.experimental.shard_map import shard_map  # type: ignore


def _state_specs(model: KGEModel, cfg: Config, flat: bool = False,
                 axes=None) -> TrainState:
    """Pytree of PartitionSpecs matching TrainState structure: 2-D tables
    row-sharded over 'model' (``flat=False``) or over the whole device
    grid (``flat=True``, the exchange steps' layout; ``axes`` overrides
    the (data, model) default for hierarchical meshes), scalars
    replicated."""
    spec = P(axes or (DATA, MODEL), None) if flat else P(MODEL, None)
    tables = {name: spec for name in model.tables(cfg, 1, 1)}
    if cfg.exchange_hot_rows:
        from openkeonspark_tpu.parallel.hot import (HOT_SUFFIX,
                                                    entity_table_names)
        for t in entity_table_names(model):
            if t in tables:
                tables[t + HOT_SUFFIX] = P()   # replicated companion
    opt = {s: dict(tables)
           for s in make_optimizer(cfg).state_slots}
    return TrainState(params=tables, opt_state=opt, step=P())


def _sampler_specs(sampler: DeviceSampler):
    children, aux = sampler.tree_flatten()
    return DeviceSampler.tree_unflatten(aux, tuple(P() for _ in children))


def build_sharded_train_step(model: KGEModel, cfg: Config,
                             sampler: DeviceSampler, batch_size: int,
                             mesh: Mesh) -> Callable:
    """(state, sampler, key) → (state, loss): one synchronous global step.

    ``batch_size`` is the **global** batch; each data shard draws
    ``batch_size // data_axis`` positives. Requires table rows padded to a
    multiple of the model axis (``init_state(..., pad_to_multiple=M)``).
    The sampler is a runtime argument, never a closure — closure arrays
    embed the triple store as executable constants (see
    ``train.step.build_train_step``)."""
    D = mesh.shape[DATA]
    M = mesh.shape[MODEL]
    B_local = max(1, batch_size // D)
    n_train = sampler.n_train
    opt = make_optimizer(cfg)
    gathers = model.gathers()

    def step(state: TrainState, sampler_: DeviceSampler, key: jax.Array):
        d_idx = jax.lax.axis_index(DATA)
        m_idx = jax.lax.axis_index(MODEL)
        # same draw across 'model'; D==1 keeps the single-device key path
        # so a (1,1) mesh is bit-identical to build_train_step
        key_d = jax.random.fold_in(key, d_idx) if D > 1 else key

        base = n_train // D
        start = d_idx * base
        size = jnp.where(d_idx == D - 1, n_train - start, base)
        batch = sampler_.sample(key_d, B_local, cfg.negative_ent,
                                cfg.negative_rel, cfg.bern,
                                partition=(start.astype(jnp.int32),
                                           size.astype(jnp.int32)))
        h_all, t_all, r_all, n_neg = _batch_ids(batch)
        ids = {"h": h_all, "t": t_all, "r": r_all}

        # --- sharded gather: masked local take + psum over 'model' ------
        slots = {}
        for slot, table, anchor in gathers:
            local = state.params[table]              # [Lp, dim] local shard
            Lp = local.shape[0]
            lid = ids[anchor] - m_idx * Lp
            owned = (lid >= 0) & (lid < Lp)
            rows = jnp.take(local, jnp.clip(lid, 0, Lp - 1), axis=0)
            rows = jnp.where(owned[:, None], rows, 0)
            slots[slot] = jax.lax.psum(rows, MODEL)

        loss, g_slots = slot_loss_and_grads(model, cfg, slots, B_local,
                                            n_neg)

        # --- update exchange: all_gather the MERGED (ids, grads) streams
        # over 'data' (duplicate id streams already folded —
        # train.step.merged_row_updates — so less ICI traffic), apply
        # locally with non-owned rows mapped to the discard sentinel ------
        from openkeonspark_tpu.train.step import merged_row_updates
        updates: Updates = {}
        for table, pairs in merged_row_updates(model, batch,
                                               g_slots).items():
            Lp = state.params[table].shape[0]
            for uid, ug in pairs:
                gid = jax.lax.all_gather(uid, DATA, tiled=True)
                gg = jax.lax.all_gather(ug, DATA, tiled=True)
                lid = gid - m_idx * Lp
                owned = (lid >= 0) & (lid < Lp)
                lid = jnp.where(owned, lid, Lp)      # Lp = discard sentinel
                gg = jnp.where(owned[:, None], gg, 0.0)
                updates.setdefault(table, []).append(
                    (lid.astype(jnp.int32), gg))

        params, opt_state = opt.apply(state.params, state.opt_state, updates,
                                      state.step)
        global_loss = jax.lax.psum(loss, DATA)
        return (TrainState(params, opt_state, state.step + 1), global_loss)

    sspec = _state_specs(model, cfg)
    mapped = shard_map(
        step, mesh=mesh,
        in_specs=(sspec, _sampler_specs(sampler), P()),
        out_specs=(sspec, P()),
        check_vma=False,
    )

    def step_fn(state: TrainState, sampler_: DeviceSampler, key: jax.Array):
        return mapped(state, sampler_, key)

    return step_fn


def make_sharded_step_builder(mesh: Mesh) -> Callable:
    """Adapter for ``train.loop.train(step_builder=...)``."""

    def builder(model, cfg, sampler, batch_size):
        return build_sharded_train_step(model, cfg, sampler, batch_size,
                                        mesh)

    return builder
