"""Sparse optimizers: per-step updates touch only the sampled rows.

The reference's updates are TF ``IndexedSlices`` applied on the parameter
servers — only gathered rows move (SURVEY.md §2.3 "gradient-sparsity
parallelism"). Here:

- **SGD** (reference default, exact semantics): scatter-add
  ``table[ids] -= α · g`` — duplicate ids sum, matching dense-math SGD.
- **lazy Adam / Adagrad / Adadelta** (the reference ``set_opt_method``
  family): state tables updated *only at touched rows*; in-batch duplicate
  ids are aggregated (summed) first so each touched row gets exactly one
  read-modify-write; Adam's bias correction uses the global step. These
  are sparse/"lazy" variants — the dense forms would also decay/accumulate
  state of untouched rows; the delta vs the reference's TF sparse applies
  (which have the same laziness) is documented in DESIGN.md.

Row-id convention: ids in ``[logical_rows, physical_rows)`` address padding
rows (see ``models/base.py``) and are harmless scatter sinks. Ids **equal to
``physical_rows``** (one past the end) mean "discard this update" — the
sharded step (``parallel/``) marks rows owned by other model shards this
way. Both optimizers implement discards with *collision-safe* masked
delta-adds (never ``.set``), so clamped invalid lanes are exact no-ops even
when they collide with a real row's update.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config


class DenseUpdate(NamedTuple):
    """A full-table gradient (untouched rows exactly zero) + the touched
    mask, produced by paths that aggregate densely instead of scattering
    (the hierarchical step's hot-row companions, ``parallel/hier.py``).
    SGD applies it as one streaming add; lazy Adam updates moments only at
    ``touched`` rows — identical semantics to the sparse pairs form."""
    grad: jax.Array      # [rows, dim] f32
    touched: jax.Array   # [rows] bool


# updates: table name -> list of (ids [N], row_grads [N, dim]), or a
# DenseUpdate for tables whose gradient is produced dense
Updates = Dict[str, Union[List[Tuple[jax.Array, jax.Array]], DenseUpdate]]

# Tables of at most this many rows take a one-hot matmul instead of the
# row scatter: exact for our masking (sentinel ids match no table row),
# and run at HIGHEST precision so the sum stays float32. Whether it beats
# the scatter on the GPU is not measured yet (ROADMAP Queue 1 item 4).
MATMUL_SCATTER_MAX_ROWS = 512


def scatter_add_rows(table: jax.Array, ids: jax.Array,
                     delta: jax.Array) -> jax.Array:
    """``table[ids] += delta`` where ids ≥ table rows are discarded.

    Small tables take the one-hot matmul; everything else the masked
    scatter-add (duplicates sum in both)."""
    rows = table.shape[0]
    if rows <= MATMUL_SCATTER_MAX_ROWS:
        onehot = (ids[None, :] ==
                  jnp.arange(rows, dtype=ids.dtype)[:, None])
        return table + jax.lax.dot(
            onehot.astype(table.dtype), delta.astype(table.dtype),
            precision=jax.lax.Precision.HIGHEST)
    valid = (ids < rows)[:, None]
    idc = jnp.minimum(ids, rows - 1)
    return table.at[idc].add(
        jnp.where(valid, delta, 0.0).astype(table.dtype))


def aggregate_duplicates(ids: jax.Array, grads: jax.Array,
                         sentinel: int) -> Tuple[jax.Array, jax.Array]:
    """Sum gradient rows with equal ids. Returns (uids [N], agg [N, d])
    where slots past the number of unique ids hold ``sentinel`` / zeros —
    fixed shapes, jit-safe."""
    n = ids.shape[0]
    order = jnp.argsort(ids)
    s_ids = ids[order]
    s_g = grads[order]
    first = jnp.concatenate([jnp.ones((1,), bool), s_ids[1:] != s_ids[:-1]])
    seg = jnp.cumsum(first) - 1
    agg = jax.ops.segment_sum(s_g, seg, num_segments=n)
    uids = jnp.full((n,), sentinel, dtype=ids.dtype).at[seg].set(s_ids)
    return uids, agg


class SparseSGD:
    """α-scaled scatter-add; no state (reference ``opt_method='SGD'``)."""

    state_slots: Tuple[str, ...] = ()

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha

    def init(self, params):
        return {}

    def apply(self, params, state, updates: Updates, step):
        new_params = dict(params)
        for table, pairs in updates.items():
            t = new_params[table]
            if isinstance(pairs, DenseUpdate):
                # streaming dense add: untouched rows carry exact zeros
                new_params[table] = t - (self.lr * pairs.grad).astype(t.dtype)
                continue
            # one fused scatter-add per table (not one per id-stream)
            if len(pairs) == 1:
                ids, g = pairs[0]
            else:
                ids = jnp.concatenate([i for i, _ in pairs])
                g = jnp.concatenate([gg for _, gg in pairs])
            new_params[table] = scatter_add_rows(t, ids, -self.lr * g)
        return new_params, state


class _LazyRowOptimizer:
    """Shared machinery for stateful optimizers with *lazy* (touched-rows-
    only) semantics — the reference's TF sparse ``IndexedSlices`` apply
    (``Config.py`` opt-method dispatch, reconstructed: Adagrad with
    ``initial_accumulator_value=1e-20``, Adadelta, Adam). Duplicate batch
    ids are aggregated (summed) first so each touched row gets exactly one
    read-modify-write, matching TF's ``_apply_sparse_duplicate_indices``.

    Subclasses declare ``state_slots`` (state-table names, one zeros/
    const-initialized table per param table each) and implement
    ``_row_update(G, rows, step) -> (delta, new_rows)`` — the per-row
    math at touched rows, where ``rows``/``new_rows`` map slot name →
    row block aligned with ``G``.

    Three application paths, identical semantics (tested against each
    other and the dense oracle):
    - ``DenseUpdate``: gradient already dense + touched mask (hot-row
      companions) — one masked elementwise pass.
    - dense-G two-pass (tables ≤ ``DENSE_MOMENT_MAX_ELEMS`` elements):
      scatter-sum gradients and a touched mask, then one dense masked
      update. Avoids argsort+segment_sum (segment_sum is itself a
      scatter) — the whole lazy update is two scatters + streaming
      elementwise over the tables.
    - sort-aggregation (huge tables): ``aggregate_duplicates`` then
      collision-safe masked delta-adds at the unique rows, bounding
      scratch memory to the update stream."""

    state_slots: Tuple[str, ...] = ()
    slot_init: Dict[str, float] = {}    # slot -> init constant (default 0)

    # tables up to this many elements take the dense-G path (the scratch
    # gradient table costs rows·dim f32 — 256 MB at the cap); bigger
    # tables fall back to sort-aggregation to bound memory
    DENSE_MOMENT_MAX_ELEMS = 64 * 1024 * 1024

    def init(self, params):
        return {s: {k: jnp.full_like(v, self.slot_init.get(s, 0.0))
                    for k, v in params.items()}
                for s in self.state_slots}

    def _row_update(self, G, rows: Dict[str, jax.Array], step):
        raise NotImplementedError

    def apply(self, params, state, updates: Updates, step):
        new_params = dict(params)
        slot_state = {s: dict(state[s]) for s in self.state_slots}
        for table, pairs in updates.items():
            p = params[table]
            if isinstance(pairs, DenseUpdate):
                # dense lazy update, gradient already aggregated
                touched = pairs.touched[:, None]
                old = {s: slot_state[s][table] for s in self.state_slots}
                delta, new_rows = self._row_update(pairs.grad, old, step)
                for s in self.state_slots:
                    slot_state[s][table] = jnp.where(touched, new_rows[s],
                                                     old[s])
                new_params[table] = p + jnp.where(touched, delta,
                                                  0.0).astype(p.dtype)
                continue
            if len(pairs) == 1:
                ids, g = pairs[0]
            else:
                ids = jnp.concatenate([i for i, _ in pairs])
                g = jnp.concatenate([gg for _, gg in pairs])
            rows = p.shape[0]

            if p.size <= self.DENSE_MOMENT_MAX_ELEMS:
                # dense-G two-pass
                valid = (ids < rows)[:, None]
                idc = jnp.minimum(ids, rows - 1)
                G = jnp.zeros_like(p, shape=(rows,) + p.shape[1:],
                                   dtype=jnp.float32)
                G = G.at[idc].add(jnp.where(valid, g, 0.0))
                touched = jnp.zeros((rows, 1), jnp.float32).at[idc].add(
                    jnp.where(valid[:, :1], 1.0, 0.0)) > 0
                old = {s: slot_state[s][table] for s in self.state_slots}
                delta, new_rows = self._row_update(G, old, step)
                for s in self.state_slots:
                    slot_state[s][table] = jnp.where(touched, new_rows[s],
                                                     old[s])
                new_params[table] = p + jnp.where(touched, delta,
                                                  0.0).astype(p.dtype)
                continue

            # sort-aggregation path; `rows` itself is the discard sentinel
            # (also used by aggregate_duplicates for empty slots)
            uids, agg = aggregate_duplicates(ids, g, sentinel=rows)
            valid = (uids < rows)[:, None]
            uc = jnp.minimum(uids, rows - 1)
            old = {s: jnp.take(slot_state[s][table], uc, axis=0)
                   for s in self.state_slots}
            delta, new_rows = self._row_update(agg, old, step)
            # collision-safe masked delta-adds: invalid lanes add exact 0
            for s in self.state_slots:
                slot_state[s][table] = slot_state[s][table].at[uc].add(
                    jnp.where(valid, new_rows[s] - old[s], 0.0))
            new_params[table] = new_params[table].at[uc].add(
                jnp.where(valid, delta, 0.0).astype(p.dtype))
        return new_params, slot_state


class SparseAdam(_LazyRowOptimizer):
    """Lazy Adam over touched rows (reference ``opt_method='Adam'``);
    bias correction uses the global step."""

    state_slots = ("m", "v")

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha
        self.b1 = cfg.adam_beta1
        self.b2 = cfg.adam_beta2
        self.eps = cfg.adam_eps

    def _row_update(self, G, rows, step):
        t = (step + 1).astype(jnp.float32)
        lr_t = self.lr * jnp.sqrt(1.0 - self.b2 ** t) / (1.0 - self.b1 ** t)
        m_new = self.b1 * rows["m"] + (1.0 - self.b1) * G
        v_new = self.b2 * rows["v"] + (1.0 - self.b2) * (G * G)
        delta = -lr_t * m_new / (jnp.sqrt(v_new) + self.eps)
        return delta, {"m": m_new, "v": v_new}


class SparseAdagrad(_LazyRowOptimizer):
    """Lazy Adagrad (reference ``opt_method='Adagrad'``): TF1
    ``AdagradOptimizer(alpha, initial_accumulator_value=1e-20)`` semantics
    — ``accum += G²; param -= α·G/√accum`` at touched rows (no epsilon;
    the tiny accumulator init is the reference's division guard)."""

    state_slots = ("accum",)

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha
        self.slot_init = {"accum": cfg.adagrad_init_acc}

    def _row_update(self, G, rows, step):
        a_new = rows["accum"] + G * G
        delta = -self.lr * G / jnp.sqrt(a_new)
        return delta, {"accum": a_new}


class SparseAdadelta(_LazyRowOptimizer):
    """Lazy Adadelta (reference ``opt_method='Adadelta'``): TF1
    ``AdadeltaOptimizer(alpha)`` defaults ρ=0.95, ε=1e-8. At touched rows:
    ``accum = ρ·accum + (1−ρ)G²``; ``u = G·√(accum_update+ε)/√(accum+ε)``;
    ``param -= α·u``; ``accum_update = ρ·accum_update + (1−ρ)u²``."""

    state_slots = ("accum", "accum_update")

    def __init__(self, cfg: Config):
        self.lr = cfg.alpha
        self.rho = cfg.adadelta_rho
        self.eps = cfg.adadelta_eps

    def _row_update(self, G, rows, step):
        a_new = self.rho * rows["accum"] + (1.0 - self.rho) * (G * G)
        u = (G * jnp.sqrt(rows["accum_update"] + self.eps)
             / jnp.sqrt(a_new + self.eps))
        delta = -self.lr * u
        return delta, {"accum": a_new,
                       "accum_update": self.rho * rows["accum_update"]
                       + (1.0 - self.rho) * (u * u)}


_OPTIMIZERS = {"sgd": SparseSGD, "adam": SparseAdam,
               "adagrad": SparseAdagrad, "adadelta": SparseAdadelta}


def make_optimizer(cfg: Config):
    return _OPTIMIZERS[cfg.opt_method.lower()](cfg)
