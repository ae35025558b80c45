"""Hot-row replication + frequency-aware exchange capacities.

SURVEY.md §7 "hard parts" mandates locality-aware table sharding — "shard
tables so that most gathers are local (sort/cluster entities by degree,
mirror the ``freqEnt`` idea)" (reconstructed ``Reader.h:~120–160``: the
reference keeps per-entity frequency tables ``freqEnt``). The r4 review
(VERDICT missing #2 / next #1) found the rebuild degree-blind: every row
placed by ``id // lp``, so cross-host traffic scaled with the host-deduped
remote fraction (H−1)/H and the 4-host (4,2,2) prediction collapsed to
60.1% at bf16 wire. This module is the numerics-exact fix:

- **Hot-row replication.** The top-K highest-degree entity rows (KG entity
  traffic is Zipf: on the flagship synthetic the top 1024 of 14 541
  entities carry ~89% of endpoint occurrences) live in a small
  **replicated companion table** ``<table>#hot`` ([K, d], plus one
  companion per optimizer slot). Gathers of hot ids are a local cache
  read — zero wire bytes; hot-row gradients accumulate into one dense
  [K, d+1] buffer and cross the grid as a single ``psum`` (hierarchical:
  intra-host ICI reduce, one DCN crossing per host) instead of per-row
  routed traffic. Updates are applied **identically on every device**
  from the replicated gradient + replicated optimizer slots, so replicas
  stay bit-identical with no broadcast step; the owning shard mirrors its
  hot rows back into the sharded table each step (a K-row local scatter),
  so the sharded tables are never stale — eval/checkpoint/export read
  them as before. Numerics: the summed hot gradient equals the routed
  path's owner-side sum (float summation order differs, same bound the
  exchange parity tests pin); the wire quantization point (``psum`` in
  ``exchange_wire_dtype``) matches the routed path's.

- **Frequency-aware capacities** (``Config.exchange_capacity='stats'``).
  The uniform birthday estimate (``exchange.expected_unique``) ignores
  both degree skew and placement skew; with contiguous ``id // lp``
  placement a Zipf head concentrated at low ids makes host 0's buckets
  several times the mean — exactly the hot-spot the r4 review called out.
  Here every owner-bucket capacity is sized from the dataset's measured
  degree tables: P(row i touched by a stream) = 1 − exp(−λ_i) with
  λ_i = m_h·deg_h(i)/T + m_t·deg_t(i)/T + m_u/n_ent (positives are
  degree-weighted draws from the triple store; Bernoulli corruption draws
  replacement entities uniformly), and capacity = the **maximum** over
  buckets of (expected load + ``CAP_Z``·σ) — honest about placement
  skew, tight where the uniform bound's blanket slack was loose.
  Overflow beyond the capacity still takes the exchange steps'
  cond-gated exact fallbacks, so a mis-estimate costs speed, never
  correctness.

Its effect on multi-host scaling was only ever predicted by an analytic
model (since removed); it has not been measured.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import KGEModel

# params/opt_state key suffix of the replicated hot companion of a sharded
# table. Companions are ordinary tables to the optimizer (DenseUpdate
# applies); mesh.shard_state / sharded._state_specs replicate them.
HOT_SUFFIX = "#hot"


def is_hot_key(name: str) -> bool:
    return name.endswith(HOT_SUFFIX)


def entity_table_names(model: KGEModel) -> Tuple[str, ...]:
    """Tables gathered through entity anchors (h/t) — the tables whose id
    space is the entity id space and which share one hot set."""
    return tuple(sorted({table for _, table, anchor in model.gathers()
                         if anchor in ("h", "t")}))


def hot_k(cfg: Config, n_ent: int) -> int:
    """Effective hot-set size: ``cfg.exchange_hot_rows`` clamped to the
    entity count and floored to a multiple of 8 (aligned dense
    buffers); 0 disables."""
    k = min(cfg.exchange_hot_rows, n_ent)
    k -= k % 8
    return max(0, k)


def degree_stats(sampler) -> Tuple[np.ndarray, np.ndarray, int]:
    """(head_degree[n_ent], tail_degree[n_ent], n_train) from the device
    sampler's packed triple store — the ``freqEnt`` statistics, host-side.
    Reads fields 0/1 (h/t) of the interleaved ``PackedRecords`` layout
    (``ops/gather.py``)."""
    rec = np.asarray(sampler.trip.rows).reshape(
        -1, sampler.trip.STRIDE)[: sampler.n_train]
    h, t = rec[:, 0], rec[:, 1]
    n = sampler.n_ent
    return (np.bincount(h, minlength=n).astype(np.float64),
            np.bincount(t, minlength=n).astype(np.float64),
            int(sampler.n_train))


def choose_hot_ids(dh: np.ndarray, dt: np.ndarray, k: int) -> np.ndarray:
    """Ascending int32 ids of the ``k`` highest-total-degree entities
    (ties broken by id for determinism across processes)."""
    if k <= 0:
        return np.zeros((0,), np.int32)
    deg = dh + dt
    top = np.argpartition(-deg, min(k, len(deg) - 1))[:k] if k < len(deg) \
        else np.arange(len(deg))
    # deterministic: exact top-k by (degree desc, id asc)
    top = top[np.lexsort((top, -deg[top]))][:k]
    return np.sort(top).astype(np.int32)


def expected_counts(dh: np.ndarray, dt: np.ndarray, n_train: int,
                    n_ent: int, m_h: float, m_t: float, m_u: float,
                    rows_phys: int) -> np.ndarray:
    """Expected number of stream entries hitting each entity row, for a
    stream of ``m_h`` head-degree draws, ``m_t`` tail-degree draws and
    ``m_u`` uniform corruption draws. Sizes capacities of NON-deduplicated
    streams (duplicates occupy bucket slots). Length ``rows_phys``;
    padding rows are never hit."""
    lam = np.zeros(rows_phys, np.float64)
    T = max(1, n_train)
    lam[:n_ent] = m_h * dh / T + m_t * dt / T + m_u / n_ent
    return lam


def touch_probs(dh: np.ndarray, dt: np.ndarray, n_train: int, n_ent: int,
                m_h: float, m_t: float, m_u: float,
                rows_phys: int) -> np.ndarray:
    """P(entity row touched) by the same stream — 1 − exp(−λ) Poissonized,
    exact in expectation for DEDUPLICATED stream capacities."""
    return 1.0 - np.exp(-expected_counts(dh, dt, n_train, n_ent, m_h, m_t,
                                         m_u, rows_phys))


def _cap(load_max: float, slack: float, n_ids: int,
         local_rows: Optional[int] = None) -> int:
    """slack × max expected bucket load, rounded up to a multiple of 8,
    clamped to [8, n_ids] (and the owner's row count when given) — same
    clamps as ``exchange.capacity_for``."""
    c = int(np.ceil(slack * load_max))
    c = -(-c // 8) * 8
    c = max(8, min(n_ids, c))
    if local_rows is not None:
        c = min(c, local_rows)
    return max(1, c)


def stream_mix(model: KGEModel, table: str, b: int,
               negative_ent: int) -> Tuple[float, float, float]:
    """(m_h, m_t, m_u) of one per-device gather/update stream for
    ``table`` at sub-batch ``b``: one degree draw per h/t-anchored slot's
    positives; Bernoulli corruption contributes ONE uniform draw per
    (positive, entity-negative) — the uncorrupted side duplicates the
    positive id and adds no unique touches."""
    nh = sum(1 for _, tb, a in model.gathers() if tb == table and a == "h")
    nt = sum(1 for _, tb, a in model.gathers() if tb == table and a == "t")
    return (float(nh * b), float(nt * b),
            float(min(1, nh + nt) * negative_ent * b))


# Statistical headroom over the expected max bucket load: capacity =
# max_bucket(mean + CAP_Z·σ). Bucket loads are sums of independent row
# indicators (σ² = Σ p(1−p), Poisson σ² ≈ mean for raw count streams), so
# z = 3.5 puts per-bucket overflow probability at ~2e-4 — a cond-gated
# exact-fallback step every few thousand steps, amortized noise. This
# replaces the uniform mode's blunt ``slack×mean``: the mean here is the
# honest per-bucket maximum already, so multiplicative slack would double-
# charge skew.
CAP_Z = 3.5


def bucket_cap(weights: np.ndarray, cold: np.ndarray, groups: np.ndarray,
               n_groups: int, slack: float, n_ids: int,
               local_rows: Optional[int] = None,
               var: Optional[np.ndarray] = None) -> int:
    """max over buckets of (mean + CAP_Z·σ) expected load: ``weights`` is
    the per-row expected mass (touch probability for deduplicated streams,
    expected count for raw streams), ``var`` the per-row load variance
    (defaults to the Poisson ``weights``), ``groups`` the bucket of each
    row (owner device, relay position, …), ``cold`` masks out replicated
    hot rows (never routed). ``slack`` is unused (kept for signature
    parity with the uniform path) — see ``CAP_Z``."""
    w = weights * cold
    mean = np.bincount(groups, weights=w, minlength=n_groups)
    v = np.bincount(groups, weights=(var if var is not None else weights)
                    * cold, minlength=n_groups)
    load = (mean + CAP_Z * np.sqrt(v)).max()
    return _cap(load, 1.0, n_ids, local_rows)


class HotPlan:
    """Build-time hot/capacity plan for one (model, cfg, sampler, mesh
    geometry). Holds the hot id set, per-table stage capacities
    (``caps[table] = {'g1', 'u1', 'c2'}`` — gather stage-1, update
    stage-1, shared stage-2), and the replicated-companion names;
    ``None``-like (k == 0, caps empty) when both features are off.

    Dedup-aware weighting: deduplicated streams (gather by default, the
    relay's stage-2 always) are sized on touch probabilities; raw streams
    (the update route unless ``exchange_dedup='both'``) on expected
    counts, since duplicates occupy bucket slots."""

    def __init__(self, model: KGEModel, cfg: Config, sampler,
                 b_sub: int, lp_by_table: Dict[str, int],
                 L: int, H: int):
        self.k = hot_k(cfg, sampler.n_ent)
        self.use_stats = cfg.exchange_capacity == "stats"
        self.hot_tables = tuple(t for t in entity_table_names(model)
                                if t in lp_by_table) if self.k else ()
        self.hot_ids_np = np.zeros((0,), np.int32)
        self.caps: Dict[str, Dict[str, int]] = {}
        if not (self.k or self.use_stats):
            return
        dh, dt, T = degree_stats(sampler)
        n_ent = sampler.n_ent
        if self.k:
            self.hot_ids_np = choose_hot_ids(dh, dt, self.k)
        if not self.use_stats:
            return
        slack = cfg.exchange_slack
        neg = cfg.negative_ent
        dg = cfg.exchange_dedup in ("gather", "both")
        du = cfg.exchange_dedup == "both"
        for table, lp in lp_by_table.items():
            rows_phys = lp * L * H
            owner = np.arange(rows_phys) // lp
            relay = owner % L
            cold = np.ones(rows_phys, bool)
            if self.k and table in self.hot_tables:
                cold[self.hot_ids_np] = False
            m_h, m_t, m_u = stream_mix(model, table, b_sub, neg)
            if m_h + m_t + m_u == 0:
                continue
            n_g = int(np.ceil((m_h + m_t) * (1 + neg)))  # raw gather len
            n_u = int(np.ceil(m_h + m_t + m_u))          # update len

            def w(mh, mt, mu, dedup):
                f = touch_probs if dedup else expected_counts
                return f(dh, dt, T, n_ent, mh, mt, mu, rows_phys)

            # gather stage-1 (per-device stream → relay buckets). Raw
            # streams count every neg slot conservatively as a fresh draw
            # on both sides.
            wg = (w(m_h, m_t, m_u, True) if dg else
                  w(m_h * (1 + neg), m_t * (1 + neg), m_u, False))
            g1 = bucket_cap(wg, cold, relay, L, slack, n_g,
                            local_rows=H * lp if dg else None,
                            var=wg * (1 - wg) if dg else None)
            # update stage-1 (merged per-row grads → relay buckets)
            wu = w(m_h, m_t, m_u, du)
            u1 = bucket_cap(wu, cold, relay, L, slack, n_u,
                            var=wu * (1 - wu) if du else None)
            # stage-2 (relay's host-deduped union → owner-host buckets;
            # the relay at position ρ serves exactly device (O·L+ρ)'s lp
            # rows, so the bucket load is the per-device owned cold mass —
            # where contiguous placement skew shows up, and what hot-row
            # replication flattens)
            wh = w(L * m_h, L * m_t, L * m_u, True)
            c2 = bucket_cap(wh, cold, owner, H * L, slack,
                            L * max(n_g, n_u), local_rows=lp,
                            var=wh * (1 - wh))
            self.caps[table] = {"g1": g1, "u1": u1, "c2": c2}

    @property
    def hot_ids(self):
        import jax.numpy as jnp
        return jnp.asarray(self.hot_ids_np)


def flat_stats_caps(model: KGEModel, cfg: Config, sampler, b_sub: int,
                    lp: int, n_grid: int) -> Dict[str, Dict[str, int]]:
    """Frequency-aware owner-bucket capacities for the FLAT exchange:
    ``{table: {'g': gather_cap, 'u': update_cap}}`` over the ``n_grid``
    owner buckets (same dedup-aware weighting as :class:`HotPlan`)."""
    import numpy as np
    out: Dict[str, Dict[str, int]] = {}
    dh, dt, T = degree_stats(sampler)
    n_ent = sampler.n_ent
    slack = cfg.exchange_slack
    neg = cfg.negative_ent
    dg = cfg.exchange_dedup in ("gather", "both")
    du = cfg.exchange_dedup == "both"
    rows_phys = lp * n_grid
    owner = np.arange(rows_phys) // lp
    cold = np.ones(rows_phys, bool)
    for table in entity_table_names(model):
        m_h, m_t, m_u = stream_mix(model, table, b_sub, neg)
        if m_h + m_t + m_u == 0:
            continue
        n_g = int(np.ceil((m_h + m_t) * (1 + neg)))
        n_u = int(np.ceil(m_h + m_t + m_u))

        def w(mh, mt, mu, dedup):
            f = touch_probs if dedup else expected_counts
            return f(dh, dt, T, n_ent, mh, mt, mu, rows_phys)

        wg = (w(m_h, m_t, m_u, True) if dg else
              w(m_h * (1 + neg), m_t * (1 + neg), m_u, False))
        wu = w(m_h, m_t, m_u, du)
        out[table] = {
            "g": bucket_cap(wg, cold, owner, n_grid, slack, n_g,
                            local_rows=lp if dg else None,
                            var=wg * (1 - wg) if dg else None),
            "u": bucket_cap(wu, cold, owner, n_grid, slack, n_u,
                            local_rows=lp if du else None,
                            var=wu * (1 - wu) if du else None),
        }
    return out


def init_hot_params(params: Dict, model: KGEModel, cfg: Config,
                    n_ent: int, dtype) -> Dict:
    """Add zero-filled replicated companions ``<table>#hot`` for every
    entity-anchored table (``train.step.init_state`` calls this before
    optimizer init, so each optimizer slot gets a companion too). Values
    are synced from the sharded tables by :func:`sync_hot_cache` once the
    hot id set is known (it needs the dataset's degree statistics)."""
    k = hot_k(cfg, n_ent)
    if k <= 0:
        return params
    import jax.numpy as jnp
    for t in entity_table_names(model):
        if t in params:
            params[t + HOT_SUFFIX] = jnp.zeros((k, params[t].shape[1]),
                                               dtype)
    return params


def sync_hot_cache(state, model: KGEModel, cfg: Config, sampler):
    """Refresh every replicated hot companion (values + optimizer slots)
    from the authoritative sharded tables. Call after init or checkpoint
    restore, before running the hierarchical step; no-op when hot rows are
    off or the state carries no companions."""
    names = [t for t in entity_table_names(model)
             if t + HOT_SUFFIX in state.params]
    if not names:
        return state
    import jax
    import jax.numpy as jnp
    dh, dt, _ = degree_stats(sampler)
    k = state.params[names[0] + HOT_SUFFIX].shape[0]
    ids = jnp.asarray(choose_hot_ids(dh, dt, k))

    params = dict(state.params)
    opt_state = {s: dict(v) for s, v in state.opt_state.items()}
    for t in names:
        params[t + HOT_SUFFIX] = _take_like(params[t], ids,
                                            params[t + HOT_SUFFIX])
        for s in opt_state:
            opt_state[s][t + HOT_SUFFIX] = _take_like(
                opt_state[s][t], ids, opt_state[s][t + HOT_SUFFIX])
    from openkeonspark_tpu.train.step import TrainState
    return TrainState(params=params, opt_state=opt_state, step=state.step)


def _take_like(table, ids, template):
    """``table[ids]`` with the companion template's sharding (replicated).
    Mesh-placed states go through jit with an explicit out-sharding so the
    refresh is one compiled gather that is also multi-process-safe; plain
    single-device arrays take the eager path."""
    import jax
    import jax.numpy as jnp
    sh = getattr(template, "sharding", None)
    if sh is not None and getattr(sh, "mesh", None) is not None:
        return jax.jit(
            lambda tb: jnp.take(tb, ids, axis=0).astype(template.dtype),
            out_shardings=sh)(table)
    return jnp.take(table, ids, axis=0).astype(template.dtype)
