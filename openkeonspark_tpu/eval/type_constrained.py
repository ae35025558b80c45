"""Type-constrained link prediction.

Reference ``Test.h``'s optional type-constrained protocol (SURVEY.md §2.2
[M]): candidates for the head (tail) slot are restricted to the entities
allowed for the relation by ``type_constrain.txt``. Ranks and metrics are
otherwise identical (raw + filtered, head/tail).

Implementation: dense per-relation allowed masks [R, Epad] (uint8) are
shipped to the device ONCE; each chunk gathers its queries' mask rows by
relation id on device, and the whole evaluation is one ``lax.scan``
dispatch per direction (mirroring ``link_prediction``) with the known-true
filter windows also built on device. The gold entity needs no special
"always allowed" handling: rank counts are strict ``<`` against the gold
score, so the gold candidate never counts regardless of its mask bit, and
the known-true correction excludes it explicitly."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import Dataset, H, R, T
from openkeonspark_tpu.data.index import KGIndex
from openkeonspark_tpu.data.type_constrain import TypeConstraints
from openkeonspark_tpu.eval.link_prediction import (DirectionMetrics,
                                                    LinkPredictionResult,
                                                    _known_window,
                                                    _pad_entity_tables)
from openkeonspark_tpu.eval.scoring import candidate_scores
from openkeonspark_tpu.models.base import get_model
from openkeonspark_tpu.ops.gather import Packed1D


def _rank_chunk_constrained(params, h, t, r, gold, known, allowed,
                            model_name: str, replace: str, block: int,
                            nblocks: int, n_ent: int, cfg: Config):
    """Like link_prediction._rank_chunk but with an ``allowed`` [C, Epad]
    uint8 mask conjoined into the count. Traceable core."""
    C = h.shape[0]

    def gold_body(acc, b):
        cand0 = b * block
        s = candidate_scores(model_name, params, h, t, r, cand0, block,
                             replace, cfg)
        ids = cand0 + jnp.arange(block, dtype=jnp.int32)[None, :]
        acc = acc + jnp.sum(
            jnp.where(ids == gold[:, None], s, 0.0).astype(jnp.float32),
            axis=1)
        return acc, None

    gold_score, _ = jax.lax.scan(gold_body, jnp.zeros((C,), jnp.float32),
                                 jnp.arange(nblocks))

    def count_body(raw, b):
        cand0 = b * block
        s = candidate_scores(model_name, params, h, t, r, cand0, block,
                             replace, cfg)
        ids = cand0 + jnp.arange(block, dtype=jnp.int32)[None, :]
        amask = jax.lax.dynamic_slice_in_dim(allowed, cand0, block, 1) > 0
        ok = ((s.astype(jnp.float32) < gold_score[:, None])
              & (ids < n_ent) & amask)
        return raw + jnp.sum(ok, axis=1).astype(jnp.int32), None

    raw_better, _ = jax.lax.scan(count_body, jnp.zeros((C,), jnp.int32),
                                 jnp.arange(nblocks))

    model = get_model(model_name)
    kshape = known.shape
    kn = jnp.minimum(known, jnp.int32(n_ent))
    pp = {k: v.astype(jnp.dtype(cfg.eval_dtype)) for k, v in params.items()}
    if replace == "tail":
        ks = model.score_triples(pp, jnp.broadcast_to(h[:, None], kshape),
                                 kn, jnp.broadcast_to(r[:, None], kshape),
                                 cfg)
    else:
        ks = model.score_triples(pp, kn,
                                 jnp.broadcast_to(t[:, None], kshape),
                                 jnp.broadcast_to(r[:, None], kshape), cfg)
    kallowed = jnp.take_along_axis(
        allowed, jnp.minimum(known, allowed.shape[1] - 1), axis=1) > 0
    kvalid = (known < n_ent) & (known != gold[:, None]) & kallowed
    known_better = jnp.sum((ks.astype(jnp.float32) < gold_score[:, None])
                           & kvalid, axis=1).astype(jnp.int32)
    return raw_better, raw_better - known_better


@partial(jax.jit, static_argnames=("model_name", "replace", "block",
                                   "nblocks", "n_ent", "k_max", "cfg"))
def _rank_scan_constrained(params, masks, kvals, h, t, r, gold, koff, kcnt,
                           model_name: str, replace: str, block: int,
                           nblocks: int, n_ent: int, k_max: int,
                           cfg: Config):
    """One dispatch for all chunks: masks [R, Epad] gathered per chunk by
    relation id; known windows built on device (see link_prediction)."""

    def body(_, inp):
        hq, tq, rq, g, ko, kc = inp
        kn = _known_window(kvals, ko, kc, k_max, n_ent)
        amask = jnp.take(masks, rq, axis=0)
        return None, _rank_chunk_constrained(
            params, hq, tq, rq, g, kn, amask, model_name, replace, block,
            nblocks, n_ent, cfg)

    _, (raw, filt) = jax.lax.scan(body, None, (h, t, r, gold, koff, kcnt))
    return raw, filt


def type_constrained_link_prediction(params, cfg: Config, ds: Dataset,
                                     index: KGIndex, tc: TypeConstraints,
                                     triples=None,
                                     log=None) -> LinkPredictionResult:
    if triples is None:
        triples = ds.test
    assert index.hr_all is not None and index.tr_all is not None
    if ds.n_ent * ds.n_rel > 1_000_000_000:
        raise ValueError("dense type-constraint masks too large for this "
                         "dataset; use unconstrained eval")
    model = get_model(cfg.model)
    block = cfg.eval_block
    chunk = cfg.eval_chunk
    params_pad, nblocks = _pad_entity_tables(model, params, cfg, ds.n_ent,
                                             ds.n_rel, block)
    Epad = nblocks * block
    hm = np.zeros((ds.n_rel, Epad), np.uint8)
    tm = np.zeros((ds.n_rel, Epad), np.uint8)
    hm[:, :ds.n_ent] = tc.head_mask(ds.n_ent)
    tm[:, :ds.n_ent] = tc.tail_mask(ds.n_ent)
    hm_dev, tm_dev = jnp.asarray(hm), jnp.asarray(tm)

    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    n = len(triples)
    offt, cntt = index.hr_all.lookup(h_all, r_all)
    offh, cnth = index.tr_all.lookup(t_all, r_all)
    k_max = int(max(cntt.max() if n else 0, cnth.max() if n else 0, 1))
    k_max = -(-k_max // 64) * 64
    kvals_t = Packed1D.build(index.hr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)
    kvals_h = Packed1D.build(index.tr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)

    ranks = {k: np.empty(n, np.int64) for k in
             ("raw_head", "raw_tail", "filt_head", "filt_tail")}
    group_q = max(chunk, cfg.eval_group_elems // max(k_max, 1) // chunk
                  * chunk)
    for s0 in range(0, n, group_q):
        e = min(s0 + group_q, n)
        m = e - s0
        pad = (-m) % chunk
        ext = lambda a: np.concatenate([a[s0:e],
                                        np.repeat(a[s0:s0 + 1], pad)])
        nc = (m + pad) // chunk
        c2 = lambda a: jnp.asarray(ext(a).reshape(nc, chunk))
        hq, tq, rq = c2(h_all), c2(t_all), c2(r_all)
        ot, ct = c2(offt), c2(cntt)
        oh, ch = c2(offh), c2(cnth)

        raw_t, filt_t = _rank_scan_constrained(
            params_pad, tm_dev, kvals_t, hq, tq, rq, tq, ot, ct,
            model_name=cfg.model, replace="tail", block=block,
            nblocks=nblocks, n_ent=ds.n_ent, k_max=k_max, cfg=cfg)
        raw_h, filt_h = _rank_scan_constrained(
            params_pad, hm_dev, kvals_h, hq, tq, rq, hq, oh, ch,
            model_name=cfg.model, replace="head", block=block,
            nblocks=nblocks, n_ent=ds.n_ent, k_max=k_max, cfg=cfg)
        sl = slice(s0, e)
        ranks["raw_tail"][sl] = np.asarray(raw_t).reshape(-1)[:m]
        ranks["filt_tail"][sl] = np.asarray(filt_t).reshape(-1)[:m]
        ranks["raw_head"][sl] = np.asarray(raw_h).reshape(-1)[:m]
        ranks["filt_head"][sl] = np.asarray(filt_h).reshape(-1)[:m]
        if log:
            log(f"type-constrained link-pred {e}/{n}")

    return LinkPredictionResult(
        raw_head=DirectionMetrics.from_ranks(ranks["raw_head"]),
        raw_tail=DirectionMetrics.from_ranks(ranks["raw_tail"]),
        filt_head=DirectionMetrics.from_ranks(ranks["filt_head"]),
        filt_tail=DirectionMetrics.from_ranks(ranks["filt_tail"]),
        ranks=ranks,
    )
