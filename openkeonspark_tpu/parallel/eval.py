"""Multi-device link-prediction evaluation: the candidate-entity axis
sharded over 'model', query chunks over 'data'.

This is the rebuild's "sequence-parallel equivalent" (SURVEY.md §5
"Long-context"): the reference scores one test triple against all
N entities in one process (``Test.h``); at 10M+ entities a single chip
can neither hold nor sweep the table, so each model shard counts
better-scoring candidates among **its own rows** of the row-sharded
entity table and one ``psum`` over 'model' combines the rank counts.

ONE fused shard_map program per direction does everything (r1 ran query
prep under auto-SPMD outside the shard_map — an extra resharding boundary
per direction, VERDICT.md r1 weak #6):

- query rows come from the row-sharded tables via masked-take + psum
  (small: chunk-sized row sets);
- gold and known-true scores are computed LOCALLY by the owning shard and
  ``psum``ed — scores cross the wire, not rows (a [C] / [C, K] f32 psum
  instead of row payloads);
- each shard sweeps its own candidate rows block-by-block and the rank
  counts ``psum`` over 'model'.

Two device dispatches per evaluation (one per direction). Tie handling
matches ops/pallas_rank.py: the gold id is masked out of the count, so
the gold score's arithmetic path can't perturb its own rank."""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.eval.scoring import (CANDIDATE_TABLES, build_queries,
                                            score_block)
from openkeonspark_tpu.ops.gather import Packed1D
from openkeonspark_tpu.parallel.mesh import DATA, MODEL

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


def _drop_hot(params):
    """Evaluation reads the authoritative sharded tables only — the
    replicated ``#hot`` companions (parallel/hot.py, kept coherent by the
    hier step's owner mirror) are dropped so pspecs stay table-shaped."""
    from openkeonspark_tpu.parallel.hot import is_hot_key
    return {k: v for k, v in params.items() if not is_hot_key(k)}


class ShardedRanker:
    """Jitted, cached fused rank programs for one (cfg, mesh): each
    program scans every chunk, sharding queries over 'data' and the
    candidate rows over 'model'. With ``masks`` (type-constrained
    protocol, VERDICT r3 next #6) the per-relation allowed masks are
    sharded over 'model' along the ENTITY axis — at 10M+ entities the
    dense [R, E] mask no longer fits one device, so each shard holds only
    its own rows' columns and conjoins them locally before the psum."""

    def __init__(self, cfg: Config, mesh: Mesh, n_ent: int, k_max: int):
        self.cfg = cfg
        self.mesh = mesh
        self.n_ent = n_ent
        self.k_max = k_max
        self.block = cfg.eval_block
        self._mapped: Dict[tuple, callable] = {}

    def _body(self, replace: str, with_mask: bool):
        cfg, n_ent, block, k_max = (self.cfg, self.n_ent, self.block,
                                    self.k_max)
        model_name = cfg.model

        def fused(params, kvals, h, t, r, gold, koff, kcnt, masks):
            from openkeonspark_tpu.eval.link_prediction import _known_window
            m_idx = jax.lax.axis_index(MODEL)
            cand_local = {name: params[name].astype(jnp.dtype(cfg.eval_dtype))
                          for name in CANDIDATE_TABLES[model_name]}
            Lp = cand_local["ent_embeddings"].shape[0]
            rows_phys = Lp * jax.lax.axis_size(MODEL)
            nblocks = -(-Lp // block)
            padded = {k: jnp.pad(v, ((0, nblocks * block - Lp), (0, 0)))
                      for k, v in cand_local.items()}
            mask_pad = (jnp.pad(masks, ((0, 0),
                                        (0, nblocks * block - Lp)))
                        if with_mask else None)
            row0 = m_idx * Lp

            def take(table, ids):
                # full rows for sharded-table gathers inside query build
                lp = table.shape[0]
                lid = ids - m_idx * lp
                ok = (lid >= 0) & (lid < lp)
                rows = jnp.take(table, jnp.clip(lid, 0, lp - 1), 0)
                return jax.lax.psum(
                    jnp.where(ok[..., None], rows, 0), MODEL)

            def local_scores(qv, ids, am=None):
                """[C, K] scores of candidate ``ids``, each scored by its
                owning shard (masked), psum'd — same vmapped score_block
                arithmetic as the candidate sweep. With ``am`` also
                returns each id's allowed bit from its owning shard."""
                lid = ids - m_idx * Lp
                ok = (lid >= 0) & (lid < Lp)
                lc = jnp.clip(lid, 0, Lp - 1)
                cand = {name: jnp.take(padded[name], lc, 0)
                        for name in CANDIDATE_TABLES[model_name]}
                s = jax.vmap(lambda qq, cc: score_block(
                    model_name, qq, cc, replace, cfg))(qv, cand)
                s = s[:, 0, :].astype(jnp.float32)
                s = jax.lax.psum(jnp.where(ok, s, 0.0), MODEL)
                if am is None:
                    return s
                bit = jnp.take_along_axis(am, lc, axis=1)
                bit = jax.lax.psum(
                    jnp.where(ok, bit, 0).astype(jnp.int32), MODEL)
                return s, bit

            def chunk(_, inp):
                hq, tq, rq, g, ko, kc = inp
                C = g.shape[0]
                q = build_queries(model_name, params, hq, tq, rq, replace,
                                  cfg, take=take)
                qv = jax.tree_util.tree_map(lambda x: x[:, None], q)
                am = (jnp.take(mask_pad, rq, axis=0) if with_mask
                      else None)  # [C, nblocks·block] LOCAL columns
                gold_s = local_scores(qv, g[:, None])[:, 0]
                known = _known_window(kvals, ko, kc, k_max, n_ent)
                kn = jnp.minimum(known, jnp.int32(rows_phys - 1))
                kvalid = (known < n_ent) & (known != g[:, None])
                if with_mask:
                    ks, kbit = local_scores(qv, kn, am)
                    kvalid = kvalid & (kbit > 0)
                else:
                    ks = local_scores(qv, kn)
                known_better = jnp.sum((ks < gold_s[:, None]) & kvalid,
                                       axis=1).astype(jnp.int32)

                def body(acc, b):
                    cand0 = b * block
                    blk = {k: jax.lax.dynamic_slice_in_dim(v, cand0, block,
                                                           0)
                           for k, v in padded.items()}
                    s = score_block(model_name, q, blk, replace, cfg)
                    local = cand0 + jnp.arange(block,
                                               dtype=jnp.int32)[None, :]
                    ids = row0 + local
                    ok = ((s.astype(jnp.float32) < gold_s[:, None])
                          & (ids < n_ent) & (ids != g[:, None])
                          & (local < Lp))
                    if with_mask:
                        ok = ok & (jax.lax.dynamic_slice_in_dim(
                            am, cand0, block, 1) > 0)
                    return acc + jnp.sum(ok, axis=1).astype(jnp.int32), None

                acc, _ = jax.lax.scan(body, jnp.zeros((C,), jnp.int32),
                                      jnp.arange(nblocks))
                return None, (jax.lax.psum(acc, MODEL), known_better)

            _, out = jax.lax.scan(chunk, None, (h, t, r, gold, koff, kcnt))
            return out

        return fused

    def run(self, params, kvals, h, t, r, gold, koff, kcnt, replace: str,
            masks=None):
        """All arrays [NC, C_global(, ...)] — queries shard over 'data' on
        axis 1; params row-sharded over 'model'; optional ``masks``
        [R, rows_phys] uint8 sharded over 'model' on the entity axis.
        Returns (raw counts, known-better counts)."""
        key = (replace, masks is not None)
        if key not in self._mapped:
            pspecs = {name: P(MODEL, None) for name in params}
            q_spec = P(None, DATA)
            self._mapped[key] = jax.jit(shard_map(
                self._body(replace, masks is not None), mesh=self.mesh,
                in_specs=(pspecs, P(), q_spec, q_spec, q_spec, q_spec,
                          q_spec, q_spec,
                          P(None, MODEL) if masks is not None else P()),
                out_specs=(q_spec, q_spec),
                check_vma=False,
            ))
        return self._mapped[key](params, kvals, h, t, r, gold, koff,
                                 kcnt,
                                 masks if masks is not None
                                 else jnp.zeros((), jnp.uint8))


def sharded_link_prediction(params, cfg: Config, ds, index, mesh: Mesh,
                            triples=None, log=None):
    """Drop-in multi-device variant of ``eval.link_prediction`` for
    row-sharded params. Global chunk = ``cfg.eval_chunk × data_axis``;
    2 device dispatches total (one fused program per direction)."""
    from openkeonspark_tpu.data.dataset import H, R, T
    from openkeonspark_tpu.eval.link_prediction import (DirectionMetrics,
                                                        LinkPredictionResult,
                                                        guard_finite_params)
    if triples is None:
        triples = ds.test
    assert index.hr_all is not None and index.tr_all is not None
    params = _drop_hot(params)
    guard_finite_params(params)
    D = mesh.shape[DATA]
    chunk = cfg.eval_chunk * D

    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    n = len(triples)
    offt, cntt = index.hr_all.lookup(h_all, r_all)
    offh, cnth = index.tr_all.lookup(t_all, r_all)
    k_max = int(max(cntt.max() if n else 0, cnth.max() if n else 0, 1))
    k_max = -(-k_max // 64) * 64
    ranker = ShardedRanker(cfg, mesh, ds.n_ent, k_max)
    kvals_t = Packed1D.build(index.hr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)
    kvals_h = Packed1D.build(index.tr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)

    pad = (-n) % chunk
    ext = lambda a: np.concatenate([a, np.repeat(a[:1], pad)]) if pad else a
    nc = (n + pad) // chunk
    c2 = lambda a: jnp.asarray(ext(a).reshape(nc, chunk))
    hq, tq, rq = c2(h_all), c2(t_all), c2(r_all)
    ot, ct, oh, ch = c2(offt), c2(cntt), c2(offh), c2(cnth)

    ranks = {}
    for replace, gold, kv, ko, kc, rk, fk in (
            ("tail", tq, kvals_t, ot, ct, "raw_tail", "filt_tail"),
            ("head", hq, kvals_h, oh, ch, "raw_head", "filt_head")):
        raw, known_better = ranker.run(params, kv, hq, tq, rq, gold,
                                       ko, kc, replace)
        ranks[rk] = np.asarray(raw).reshape(-1)[:n].astype(np.int64)
        ranks[fk] = (np.asarray(raw).reshape(-1)
                     - np.asarray(known_better).reshape(-1))[:n].astype(
                         np.int64)
        if log:
            log(f"sharded link-pred {replace} done ({n} triples)")

    return LinkPredictionResult(
        raw_head=DirectionMetrics.from_ranks(ranks["raw_head"]),
        raw_tail=DirectionMetrics.from_ranks(ranks["raw_tail"]),
        filt_head=DirectionMetrics.from_ranks(ranks["filt_head"]),
        filt_tail=DirectionMetrics.from_ranks(ranks["filt_tail"]),
        ranks=ranks,
    )


def sharded_type_constrained_link_prediction(params, cfg: Config, ds, index,
                                             tc, mesh: Mesh, triples=None,
                                             log=None):
    """Multi-device variant of ``eval.type_constrained_link_prediction``
    (VERDICT r3 next #6): per-relation allowed masks are sharded over
    'model' along the entity axis, so the dense [R, E] mask that caps the
    single-device path at ~1e9 elements is divided by the model-axis size
    — the 10M+-entity config-#5 scale keeps a runnable type-constrained
    evaluator. Ranks are identical to the single-device path (parity test
    on the 8-device CPU mesh)."""
    from openkeonspark_tpu.data.dataset import H, R, T
    from openkeonspark_tpu.eval.link_prediction import (DirectionMetrics,
                                                        LinkPredictionResult,
                                                        guard_finite_params)
    from jax.sharding import NamedSharding
    if triples is None:
        triples = ds.test
    assert index.hr_all is not None and index.tr_all is not None
    params = _drop_hot(params)
    guard_finite_params(params)
    D = mesh.shape[DATA]
    M = mesh.shape[MODEL]
    chunk = cfg.eval_chunk * D
    rows_phys = params["ent_embeddings"].shape[0]
    assert rows_phys % M == 0

    hm = np.zeros((ds.n_rel, rows_phys), np.uint8)
    tm = np.zeros((ds.n_rel, rows_phys), np.uint8)
    hm[:, :ds.n_ent] = tc.head_mask(ds.n_ent)
    tm[:, :ds.n_ent] = tc.tail_mask(ds.n_ent)
    mspec = NamedSharding(mesh, P(None, MODEL))
    hm_dev = jax.device_put(hm, mspec)
    tm_dev = jax.device_put(tm, mspec)

    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    n = len(triples)
    offt, cntt = index.hr_all.lookup(h_all, r_all)
    offh, cnth = index.tr_all.lookup(t_all, r_all)
    k_max = int(max(cntt.max() if n else 0, cnth.max() if n else 0, 1))
    k_max = -(-k_max // 64) * 64
    ranker = ShardedRanker(cfg, mesh, ds.n_ent, k_max)
    kvals_t = Packed1D.build(index.hr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)
    kvals_h = Packed1D.build(index.tr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)

    pad = (-n) % chunk
    ext = lambda a: np.concatenate([a, np.repeat(a[:1], pad)]) if pad else a
    nc = (n + pad) // chunk
    c2 = lambda a: jnp.asarray(ext(a).reshape(nc, chunk))
    hq, tq, rq = c2(h_all), c2(t_all), c2(r_all)
    ot, ct, oh, ch = c2(offt), c2(cntt), c2(offh), c2(cnth)

    ranks = {}
    for replace, gold, kv, ko, kc, mask, rk, fk in (
            ("tail", tq, kvals_t, ot, ct, tm_dev, "raw_tail", "filt_tail"),
            ("head", hq, kvals_h, oh, ch, hm_dev, "raw_head", "filt_head")):
        raw, known_better = ranker.run(params, kv, hq, tq, rq, gold,
                                       ko, kc, replace, masks=mask)
        ranks[rk] = np.asarray(raw).reshape(-1)[:n].astype(np.int64)
        ranks[fk] = (np.asarray(raw).reshape(-1)
                     - np.asarray(known_better).reshape(-1))[:n].astype(
                         np.int64)
        if log:
            log(f"sharded type-constrained {replace} done ({n} triples)")

    return LinkPredictionResult(
        raw_head=DirectionMetrics.from_ranks(ranks["raw_head"]),
        raw_tail=DirectionMetrics.from_ranks(ranks["raw_tail"]),
        filt_head=DirectionMetrics.from_ranks(ranks["filt_head"]),
        filt_tail=DirectionMetrics.from_ranks(ranks["filt_tail"]),
        ranks=ranks,
    )


class ShardedTripleScorer:
    """Score explicit (h, t, r) id triples against row-sharded tables,
    using the FLAT training layout: tables row-sharded over ALL mesh axes
    (the exchange/hier steps' ``shard_state(..., flat=True)`` placement),
    each slot's rows via masked-take + psum over the full axis tuple —
    mirroring hier.py's take, so validation during sharded training
    reuses the training sharding with NO resharding (the r4 advisor found
    the old P('model') spec replicated every table across the host/data
    axes on each call, data-degree× per-device memory — defeating the
    scorer at exactly the table scales that motivated it). Triples are
    replicated (the valid split is small); scoring arithmetic is the
    model's ordinary ``score(slots)`` — bitwise the values of
    ``score_triples`` on dense tables. Backs the sharded
    classification-threshold path (VERDICT r3 next #6)."""

    def __init__(self, cfg: Config, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh
        self._mapped = None

    def _build(self, params):
        from openkeonspark_tpu.models.base import get_model
        model = get_model(self.cfg.model)
        cfg_ = self.cfg
        grid = 1
        for s in self.mesh.shape.values():
            grid *= s
        # flat layout when every table divides over the full grid (the
        # exchange/hier contract); legacy 'model'-only rows otherwise
        flat = all(v.shape[0] % grid == 0 for v in params.values()
                   if getattr(v, "ndim", 0) == 2)
        axes = tuple(self.mesh.axis_names) if flat else (MODEL,)

        def body(params_, h, t, r):
            n_idx = jnp.zeros((), jnp.int32)
            for ax in axes:
                n_idx = n_idx * jax.lax.axis_size(ax) \
                    + jax.lax.axis_index(ax)

            def take(table, ids):
                lp = table.shape[0]
                lid = ids - n_idx * lp
                ok = (lid >= 0) & (lid < lp)
                rows = jnp.take(table, jnp.clip(lid, 0, lp - 1), 0)
                return jax.lax.psum(jnp.where(ok[..., None], rows, 0),
                                    axes)

            anchors = {"h": h, "t": t, "r": r}
            slots = {slot: take(params_[table], anchors[anchor])
                     for slot, table, anchor in model.gathers()}
            return model.score(slots, cfg_)

        pspecs = {name: P(axes, None) for name in params}
        return jax.jit(shard_map(
            body, mesh=self.mesh,
            in_specs=(pspecs, P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        ))

    def __call__(self, params, triples: np.ndarray,
                 batch: int = 65536) -> np.ndarray:
        from openkeonspark_tpu.data.dataset import H, R, T
        params = _drop_hot(params)
        if self._mapped is None:
            self._mapped = self._build(params)
        outs = []
        for s in range(0, len(triples), batch):
            e = min(s + batch, len(triples))
            chunk = triples[s:e]
            sc = np.asarray(self._mapped(params,
                                         jnp.asarray(chunk[:, H]),
                                         jnp.asarray(chunk[:, T]),
                                         jnp.asarray(chunk[:, R])))
            outs.append(sc)
        return (np.concatenate(outs) if outs
                else np.empty(0, np.float32))
