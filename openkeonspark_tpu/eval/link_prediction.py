"""Link-prediction evaluation: raw + filtered MR / MRR / Hits@1/3/10,
head / tail / averaged.

Replaces the reference's ``base/Test.h`` ranking protocol driven by
``Config.test`` (reconstructed ``Test.h:~1–400``, ``Config.py:~450–560``
per SURVEY.md §3.3). The reference loops one test triple at a time,
materializes N_entity candidate triples (``getHeadBatch``/``getTailBatch``),
scores them in one ``sess.run``, and walks the score array in C++ counting
candidates that beat the gold triple, skipping known-true triples found by
binary search over the sorted ``tripleList`` (→ filtered rank).

Design:

- **Chunked queries × blocked candidates**: ``eval_chunk`` test triples are
  ranked at once against entity blocks of ``eval_block`` — one
  ``lax.scan`` over blocks bounds the [C, E, d] residual intermediates
  while the compare/count reduction stays fused with scoring. On the GPU
  the translational families (and RotatE) sweep with the fused Pallas
  kernel of ``ops/pallas_rank.py`` instead.
- **Rank = count, not sort**: the rank of the gold entity is
  ``1 + #{candidates with score < gold}`` — an O(E) vectorized compare
  (the reference counts the same way, ``Test.h`` ``testHead``/``testTail``).
- **Exact filtering without a membership probe per candidate**: filtered
  rank = raw count − #{*known-true* candidates scoring better}. The known
  tails of (h, r) (resp. heads of (t, r)) come from the all-splits group
  index (the reference's ``tripleList``); they are gathered into a padded
  [C, K] block and scored directly — K is the max known-group size over
  the test set, so the whole evaluation is one compiled program.
- The gold score is extracted *from the candidate sweep itself* (masked
  sum over the block containing it), so gold and candidates go through
  bit-identical arithmetic and ties are exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import Dataset, H, R, T
from openkeonspark_tpu.data.index import GroupIndex, KGIndex
from openkeonspark_tpu.eval.scoring import build_queries, candidate_scores
from openkeonspark_tpu.models.base import get_model
from openkeonspark_tpu.ops.gather import Packed1D


@dataclass
class DirectionMetrics:
    mr: float
    mrr: float
    hits1: float
    hits3: float
    hits10: float

    @staticmethod
    def from_ranks(ranks: np.ndarray) -> "DirectionMetrics":
        r = ranks.astype(np.float64) + 1.0  # ranks stored 0-based (count of better)
        return DirectionMetrics(
            mr=float(r.mean()),
            mrr=float((1.0 / r).mean()),
            hits1=float((r <= 1).mean()),
            hits3=float((r <= 3).mean()),
            hits10=float((r <= 10).mean()),
        )


@dataclass
class LinkPredictionResult:
    """All 2 (raw/filter) × 2 (head/tail) metric sets + averages, plus the
    per-triple ranks for downstream analysis."""

    raw_head: DirectionMetrics
    raw_tail: DirectionMetrics
    filt_head: DirectionMetrics
    filt_tail: DirectionMetrics
    ranks: Dict[str, np.ndarray]  # raw_head/raw_tail/filt_head/filt_tail

    @staticmethod
    def _avg(a: DirectionMetrics, b: DirectionMetrics) -> DirectionMetrics:
        return DirectionMetrics(*[(x + y) / 2 for x, y in
                                  zip(a.__dict__.values(), b.__dict__.values())])

    @property
    def raw_avg(self) -> DirectionMetrics:
        return self._avg(self.raw_head, self.raw_tail)

    @property
    def filt_avg(self) -> DirectionMetrics:
        return self._avg(self.filt_head, self.filt_tail)

    def format_table(self) -> str:
        """Human-readable table in the spirit of the reference's
        ``test_link_prediction`` stdout block."""
        rows = [
            ("metric", "MR", "MRR", "hit@1", "hit@3", "hit@10"),
        ]
        for label, m in [
            ("l(raw)", self.raw_head), ("r(raw)", self.raw_tail),
            ("averaged(raw)", self.raw_avg),
            ("l(filter)", self.filt_head), ("r(filter)", self.filt_tail),
            ("averaged(filter)", self.filt_avg),
        ]:
            rows.append((label, f"{m.mr:.2f}", f"{m.mrr:.4f}",
                         f"{m.hits1:.4f}", f"{m.hits3:.4f}", f"{m.hits10:.4f}"))
        widths = [max(len(r[i]) for r in rows) for i in range(6)]
        return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                         for r in rows)


def _pad_entity_tables(model, params: Dict[str, jax.Array], cfg: Config,
                       n_ent: int, n_rel: int, block: int):
    """Zero-pad entity tables so candidate blocks slice in-bounds; returns
    (padded params, number of blocks)."""
    specs = model.tables(cfg, n_ent, n_rel)
    rows = max(v.shape[0] for k, v in params.items() if specs[k].kind == "ent")
    nblocks = -(-rows // block)
    target = nblocks * block
    out = dict(params)
    for k, spec in specs.items():
        if spec.kind == "ent" and params[k].shape[0] < target:
            pad = target - params[k].shape[0]
            out[k] = jnp.concatenate(
                [params[k], jnp.zeros((pad, params[k].shape[1]),
                                      params[k].dtype)], axis=0)
    return out, nblocks


def _known_window(kvals: Packed1D, off: jax.Array, cnt: jax.Array,
                  k_max: int, pad: int) -> jax.Array:
    """Device-side known-true ids for each query: the group lists are
    contiguous runs of the all-splits value array (the reference's sorted
    ``tripleList`` ranges), so ≤ (k_max+127)/128 + 1 *row* gathers of the
    Packed1D view cover every window; out-of-window lanes become ``pad``.
    The result is an unordered cover of the group — downstream only scores
    and counts it, so alignment is irrelevant. Replaces a host-side NumPy
    gather that cost more than the whole device pass at 20k-query scale."""
    nrows = (k_max + 127) // 128 + 1
    row0 = off >> 7
    parts = [jnp.take(kvals.rows, row0 + i, axis=0) for i in range(nrows)]
    w = jnp.concatenate(parts, axis=1)                     # [C, nrows*128]
    pos = ((row0[:, None] << 7)
           + jnp.arange(nrows * 128, dtype=off.dtype)[None, :])
    ok = (pos >= off[:, None]) & (pos < (off + cnt)[:, None])
    return jnp.where(ok, w, pad)


def _rank_chunk(params, h, t, r, gold, known, model_name: str, replace: str,
                block: int, nblocks: int, n_ent: int, cfg: Config):
    """One query chunk, both rank modes (traceable core — jitted callers
    ``lax.scan`` it over many chunks so the whole evaluation is ONE device
    dispatch per direction, not one per chunk).

    gold  [C]    — true id of the replaced slot
    known [C,K]  — all-splits known ids for the replaced slot (pad = n_ent)
    Returns (raw_better [C], filt_better [C]) int32 counts of strictly
    better candidates (raw) and better-and-unknown candidates (filtered).
    """
    C = h.shape[0]

    # pass 1: extract the gold scores from the candidate-path arithmetic
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
        valid = ids < n_ent
        raw = raw + jnp.sum((s.astype(jnp.float32) < gold_score[:, None])
                            & valid, axis=1).astype(jnp.int32)
        return raw, None

    raw_better, _ = jax.lax.scan(count_body, jnp.zeros((C,), jnp.int32),
                                 jnp.arange(nblocks))

    # known-true candidates: score them directly through the model's
    # triple path and subtract the better-scoring ones
    model = get_model(model_name)
    kshape = known.shape
    kn = jnp.minimum(known, jnp.int32(n_ent))  # pad id n_ent → pad row (zeros)
    if replace == "tail":
        ks = model.score_triples(
            {k: v.astype(jnp.dtype(cfg.eval_dtype)) for k, v in params.items()},
            jnp.broadcast_to(h[:, None], kshape), kn,
            jnp.broadcast_to(r[:, None], kshape), cfg)
    else:
        ks = model.score_triples(
            {k: v.astype(jnp.dtype(cfg.eval_dtype)) for k, v in params.items()},
            kn, jnp.broadcast_to(t[:, None], kshape),
            jnp.broadcast_to(r[:, None], kshape), cfg)
    kvalid = (known < n_ent) & (known != gold[:, None])
    known_better = jnp.sum((ks.astype(jnp.float32) < gold_score[:, None])
                           & kvalid, axis=1).astype(jnp.int32)
    return raw_better, raw_better - known_better


def _rank_chunk_kernel(params, cvec, h, t, r, gold, known,
                       model_name: str, replace: str, n_ent: int,
                       cfg: Config, interpret: bool):
    """Kernel path (TransE/TransD/RotatE): the fused sweep of
    ``ops/pallas_rank.py`` counts better candidates in one pass with
    nothing materialized; gold and known-true scores go through its
    column-sequential mirror, and the gold id is masked inside the
    kernel. ``cvec`` is TransD's per-entity transfer dot (None
    otherwise)."""
    from openkeonspark_tpu.ops.pallas_rank import (count_better,
                                                   residual_scores)
    qd = build_queries(model_name, params, h, t, r, replace, cfg)
    q, u = qd["q"], qd.get("rp")
    sign = -1.0 if replace == "tail" else 1.0
    modulus = model_name == "rotate"
    E = params["ent_embeddings"]

    def score(ids):
        crow = None if cvec is None else jnp.take(cvec, ids)
        return residual_scores(q, jnp.take(E, ids, axis=0), sign,
                               cfg.p_norm, u, crow, modulus)

    gold_s = score(gold)
    raw = count_better(q, E, gold_s, gold, u, cvec, sign=sign,
                       p=cfg.p_norm, n_ent=n_ent, modulus=modulus,
                       interpret=interpret)
    ks = score(jnp.minimum(known, jnp.int32(E.shape[0] - 1)))
    kvalid = (known < n_ent) & (known != gold[:, None])
    known_better = jnp.sum((ks < gold_s[:, None]) & kvalid,
                           axis=1).astype(jnp.int32)
    return raw, raw - known_better


@partial(jax.jit, static_argnames=("model_name", "replace", "block",
                                   "nblocks", "n_ent", "k_max", "cfg"))
def _rank_scan(params, kvals, h, t, r, gold, koff, kcnt, model_name: str,
               replace: str, block: int, nblocks: int, n_ent: int,
               k_max: int, cfg: Config):
    """Rank many chunks in one dispatch: [NC, C] inputs scanned over the
    leading axis; known-true ids materialize on device per chunk."""

    def body(_, inp):
        hq, tq, rq, g, ko, kc = inp
        kn = _known_window(kvals, ko, kc, k_max, n_ent)
        return None, _rank_chunk(params, hq, tq, rq, g, kn, model_name,
                                 replace, block, nblocks, n_ent, cfg)

    _, (raw, filt) = jax.lax.scan(body, None, (h, t, r, gold, koff, kcnt))
    return raw, filt


@partial(jax.jit, static_argnames=("model_name", "replace", "n_ent",
                                   "k_max", "cfg", "interpret"))
def _rank_scan_kernel(params, cvec, kvals, h, t, r, gold, koff, kcnt,
                      model_name: str, replace: str, n_ent: int, k_max: int,
                      cfg: Config, interpret: bool):
    def body(_, inp):
        hq, tq, rq, g, ko, kc = inp
        kn = _known_window(kvals, ko, kc, k_max, n_ent)
        return None, _rank_chunk_kernel(
            params, cvec, hq, tq, rq, g, kn, model_name, replace, n_ent,
            cfg, interpret)

    _, (raw, filt) = jax.lax.scan(body, None, (h, t, r, gold, koff, kcnt))
    return raw, filt


def _count_projected(proj, q, gold, koff, kcnt, kvals, sign: float, p: int,
                     n_ent: int, k_max: int, interpret: bool):
    """TransE-form rank count over an (already projected) candidate table
    ``proj`` [E, d]: the fused kernel sweeps it; gold and known-true
    scores use the kernel's mirror on rows gathered from the same table
    — tie-exact within the path."""
    from openkeonspark_tpu.ops.pallas_rank import (count_better,
                                                   residual_scores)
    gold_s = residual_scores(q, jnp.take(proj, gold, axis=0), sign, p)
    raw = count_better(q, proj, gold_s, gold, sign=sign, p=p, n_ent=n_ent,
                       interpret=interpret)
    known = _known_window(kvals, koff, kcnt, k_max, n_ent)
    kn = jnp.minimum(known, jnp.int32(proj.shape[0] - 1))
    ks = residual_scores(q, jnp.take(proj, kn, axis=0), sign, p)
    kvalid = (known < n_ent) & (known != gold[:, None])
    known_better = jnp.sum((ks < gold_s[:, None]) & kvalid,
                           axis=1).astype(jnp.int32)
    return raw, raw - known_better


@partial(jax.jit, static_argnames=("model_name", "n_ent", "k_max", "p",
                                   "de", "dr", "interpret", "eval_dtype"))
def _rank_scan_grouped(params, kvals_t, kvals_h, rel, h, t, ot, ct, oh,
                       ch, model_name: str, n_ent: int, k_max: int, p: int,
                       de: int, dr: int, interpret: bool,
                       eval_dtype: str = "float32"):
    """Relation-grouped ranking for models whose candidate projection
    depends only on the relation (TransR: e·Mᵣ; TransH: e − (wᵣ·e)wᵣ):
    every chunk shares ONE relation, so the whole entity table is
    projected once per chunk (one matmul / matvec) and the sweep
    becomes TransE-form over the projected table — handled by the fused
    kernel. Removes the O(C·E·proj) per-(query, candidate) redundancy of
    the generic path (the reference's per-triple protocol has the same
    redundancy). Both directions reuse the chunk's projection.

    ``eval_dtype`` sets the *projection* dtype (the per-chunk
    [E, de]·[de, dr] matmul, at HIGHEST precision so a float32
    projection is not run in TF32). Ranks stay tie-exact within the path
    either way: gold/known scores are computed from the SAME projected
    table the kernel sweeps (accumulation is always f32)."""
    ed = jnp.dtype(eval_dtype)
    E = params["ent_embeddings"].astype(ed)

    def project(rho):
        if model_name == "transr":
            M = params["transfer_matrix"][rho].reshape(de, dr).astype(ed)
            return jnp.dot(E, M, preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
        from openkeonspark_tpu.models.transh import unit
        w = unit(params["normal_vectors"][rho]).astype(ed)
        return (E - jnp.dot(E, w, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)[:, None]
                * w.astype(jnp.float32)).astype(jnp.float32)

    def body(_, inp):
        rho, hq, tq, kot, kct, koh, kch = inp
        proj = project(rho)
        rvec = params["rel_embeddings"][rho].astype(jnp.float32)
        q_t = jnp.take(proj, hq, axis=0) + rvec[None, :]
        q_h = rvec[None, :] - jnp.take(proj, tq, axis=0)
        raw_t, filt_t = _count_projected(proj, q_t, tq, kot, kct, kvals_t,
                                         -1.0, p, n_ent, k_max, interpret)
        raw_h, filt_h = _count_projected(proj, q_h, hq, koh, kch, kvals_h,
                                         1.0, p, n_ent, k_max, interpret)
        return None, (raw_t, filt_t, raw_h, filt_h)

    _, out = jax.lax.scan(body, None, (rel, h, t, ot, ct, oh, ch))
    return out


def _grouped_link_prediction(params, cfg: Config, ds, index,
                             triples: np.ndarray, interpret: bool,
                             log=None):
    """Driver for the relation-grouped path (TransR, TransH): sort test
    triples by relation, emit fixed-size single-relation chunks (the last
    chunk of each relation padded with its first triple), one scan
    dispatch per group of chunks."""
    chunk = min(cfg.eval_chunk, 64)  # small chunks bound padding waste

    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    n = len(triples)
    order = np.argsort(r_all, kind="stable")
    offt, cntt = index.hr_all.lookup(h_all, r_all)
    offh, cnth = index.tr_all.lookup(t_all, r_all)
    k_max = int(max(cntt.max() if n else 0, cnth.max() if n else 0, 1))
    k_max = -(-k_max // 64) * 64
    kvals_t = Packed1D.build(index.hr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)
    kvals_h = Packed1D.build(index.tr_all.sorted_vals.astype(np.int32),
                             pad_value=ds.n_ent)

    # single-relation chunk list over the sorted order
    chunks = []  # (rel, positions[chunk] into the original arrays)
    s = 0
    while s < n:
        rho = r_all[order[s]]
        e = s
        while e < n and r_all[order[e]] == rho and e - s < chunk:
            e += 1
        pos = order[s:e]
        pad = chunk - len(pos)
        chunks.append((rho, np.concatenate([pos, np.repeat(pos[:1], pad)])))
        s = e
    NC = len(chunks)
    rel = np.array([c[0] for c in chunks], np.int32)
    posm = np.stack([c[1] for c in chunks])              # [NC, chunk]
    g = lambda a: jnp.asarray(a[posm])
    out = _rank_scan_grouped(
        params, kvals_t, kvals_h, jnp.asarray(rel),
        g(h_all), g(t_all), g(offt), g(cntt), g(offh), g(cnth),
        model_name=cfg.model, n_ent=ds.n_ent, k_max=k_max, p=cfg.p_norm,
        de=cfg.d_ent, dr=cfg.d_rel, eval_dtype=cfg.eval_dtype,
        interpret=interpret)

    ranks = {k: np.empty(n, np.int64) for k in
             ("raw_head", "raw_tail", "filt_head", "filt_tail")}
    names = ("raw_tail", "filt_tail", "raw_head", "filt_head")
    for name, arr in zip(names, out):
        arr = np.asarray(arr)                            # [NC, chunk]
        for ci, (_, pos) in enumerate(chunks):
            # pad slots repeat the chunk's first triple, so duplicate
            # assignments write identical values
            ranks[name][pos] = arr[ci]
    if log is not None:
        log(f"link-pred ({cfg.model} grouped) {n}/{n}")
    return ranks


# families the fused sweep kernel covers directly, and those it covers
# through one table projection per relation
KERNEL_MODELS = ("transe", "transd", "rotate")
GROUPED_MODELS = ("transr", "transh")


def _use_kernel(cfg: Config, interpret: bool) -> bool:
    """The sweep kernel runs where it is compiled for (the GPU) or, in
    tests, through the Pallas interpreter; on the CPU the plain path
    runs. ``cfg.use_pallas_eval=False`` selects the plain path anywhere."""
    return cfg.use_pallas_eval and (interpret
                                    or jax.default_backend() == "gpu")


def _known_matrix(gi: Optional[GroupIndex], a: np.ndarray, b: np.ndarray,
                  k_max: int, pad: int) -> np.ndarray:
    """[C, k_max] known-value ids for anchor pairs, padded with ``pad``
    (vectorized gather from the flat group array)."""
    C = len(a)
    if gi is None or len(gi.sorted_vals) == 0:
        return np.full((C, k_max), pad, dtype=np.int32)
    off, cnt = gi.lookup(a, b)
    lane = np.arange(k_max, dtype=np.int64)[None, :]
    valid = lane < cnt[:, None].astype(np.int64)
    src = np.minimum(off[:, None].astype(np.int64) + lane,
                     len(gi.sorted_vals) - 1)
    out = gi.sorted_vals[src].astype(np.int32)
    out[~valid] = pad
    return out


def near_tie_counts(params, cfg: Config, triples: np.ndarray,
                    replace: str) -> np.ndarray:
    """Per triple: how many other candidates' plain-path scores lie within
    the float32 error bound of the gold score — the candidates whose order
    against the gold one two correct summation orders may disagree on
    (each sum of D non-negative terms is within D·2⁻²⁴·score of exact).
    Two evaluators whose ranks differ by at most this count agree up to
    float near-ties. Dense over all candidates: for checks, not for
    production evaluation."""
    h, t, r = (jnp.asarray(triples[:, c]) for c in (H, T, R))
    gold = np.asarray(triples[:, T if replace == "tail" else H])
    rows = params["ent_embeddings"].shape[0]
    s = np.asarray(candidate_scores(cfg.model, params, h, t, r,
                                    jnp.int32(0), rows, replace, cfg))
    g = s[np.arange(len(gold)), gold]
    bound = 2 * params["ent_embeddings"].shape[1] * 2.0 ** -24 * np.abs(g)
    near = np.abs(s - g[:, None]) <= bound[:, None]
    near[np.arange(len(gold)), gold] = False
    return near.sum(axis=1)


@jax.jit
def _nonfinite_total(params):
    return sum(jnp.sum(~jnp.isfinite(t)) for t in params.values())


def guard_finite_params(params) -> None:
    """Refuse to rank with non-finite embeddings: NaN scores compare False
    against everything, so a diverged model would silently report a
    PERFECT Hits@10 of 1.0 (every rank 0). Fail loudly instead.

    ONE fused reduction + ONE host pull for the whole pytree, instead of
    one pull per table. The offending table is only named on the rare
    failure path."""
    if int(_nonfinite_total(dict(params))):
        for name, table in params.items():
            if not bool(jnp.all(jnp.isfinite(table))):
                raise ValueError(
                    f"param table {name!r} contains non-finite values — "
                    "training diverged (lower alpha?); refusing to evaluate")


def link_prediction(params: Dict[str, jax.Array], cfg: Config, ds: Dataset,
                    index: KGIndex, triples: Optional[np.ndarray] = None,
                    log=None, interpret: bool = False
                    ) -> LinkPredictionResult:
    """Evaluate link prediction over ``triples`` (default: the test split).

    ``index`` must be built with ``for_eval=True`` (all-splits group lists,
    the reference's ``importTestFiles`` ``tripleList``). ``interpret``
    runs the kernel paths through the Pallas interpreter (CPU tests)."""
    if triples is None:
        triples = ds.test
    if triples is None or len(triples) == 0:
        raise ValueError("no test triples")
    assert index.hr_all is not None and index.tr_all is not None, \
        "link_prediction needs an eval index (build_kg_index(for_eval=True))"
    guard_finite_params(params)

    kernel = _use_kernel(cfg, interpret)
    if kernel and cfg.model in GROUPED_MODELS:
        ranks = _grouped_link_prediction(params, cfg, ds, index, triples,
                                         interpret, log=log)
        return LinkPredictionResult(
            raw_head=DirectionMetrics.from_ranks(ranks["raw_head"]),
            raw_tail=DirectionMetrics.from_ranks(ranks["raw_tail"]),
            filt_head=DirectionMetrics.from_ranks(ranks["filt_head"]),
            filt_tail=DirectionMetrics.from_ranks(ranks["filt_tail"]),
            ranks=ranks,
        )
    kernel = kernel and cfg.model in KERNEL_MODELS
    chunk = cfg.eval_chunk
    if kernel:
        cvec = None
        if cfg.model == "transd":
            cvec = jnp.sum(params["ent_embeddings"].astype(jnp.float32)
                           * params["ent_transfer"].astype(jnp.float32), -1)
    else:
        block = cfg.eval_block
        params_pad, nblocks = _pad_entity_tables(get_model(cfg.model),
                                                 params, cfg, ds.n_ent,
                                                 ds.n_rel, block)

    h_all, t_all, r_all = triples[:, H], triples[:, T], triples[:, R]
    n = len(triples)
    # host side: only the (off, cnt) window lookups (one searchsorted per
    # direction); the known-id windows themselves materialize on device
    # (_known_window) from Packed1D views of the all-splits group arrays
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

    # one device dispatch per direction per group: chunks are stacked on a
    # leading axis and lax.scan'ed inside the jit. Groups bound the
    # per-dispatch query count for huge test sets.
    group_q = max(chunk, cfg.eval_group_elems // max(k_max, 1) // chunk
                  * chunk)
    for s in range(0, n, group_q):
        e = min(s + group_q, n)
        m = e - s
        pad = (-m) % chunk
        ext = lambda a: np.concatenate([a[s:e], np.repeat(a[s:s + 1], pad)])
        nc = (m + pad) // chunk
        c2 = lambda a: jnp.asarray(ext(a).reshape(nc, chunk))
        hq, tq, rq = c2(h_all), c2(t_all), c2(r_all)
        ot, ct = c2(offt), c2(cntt)
        oh, ch = c2(offh), c2(cnth)

        if kernel:
            raw_t, filt_t = _rank_scan_kernel(
                params, cvec, kvals_t, hq, tq, rq, tq, ot, ct,
                model_name=cfg.model, replace="tail", n_ent=ds.n_ent,
                k_max=k_max, cfg=cfg, interpret=interpret)
            raw_h, filt_h = _rank_scan_kernel(
                params, cvec, kvals_h, hq, tq, rq, hq, oh, ch,
                model_name=cfg.model, replace="head", n_ent=ds.n_ent,
                k_max=k_max, cfg=cfg, interpret=interpret)
        else:
            raw_t, filt_t = _rank_scan(params_pad, kvals_t, hq, tq, rq, tq,
                                       ot, ct, model_name=cfg.model,
                                       replace="tail", block=block,
                                       nblocks=nblocks, n_ent=ds.n_ent,
                                       k_max=k_max, cfg=cfg)
            raw_h, filt_h = _rank_scan(params_pad, kvals_h, hq, tq, rq, hq,
                                       oh, ch, model_name=cfg.model,
                                       replace="head", block=block,
                                       nblocks=nblocks, n_ent=ds.n_ent,
                                       k_max=k_max, cfg=cfg)
        sl = slice(s, e)
        ranks["raw_tail"][sl] = np.asarray(raw_t).reshape(-1)[:m]
        ranks["filt_tail"][sl] = np.asarray(filt_t).reshape(-1)[:m]
        ranks["raw_head"][sl] = np.asarray(raw_h).reshape(-1)[:m]
        ranks["filt_head"][sl] = np.asarray(filt_h).reshape(-1)[:m]
        if log is not None:
            log(f"link-pred {e}/{n}")

    return LinkPredictionResult(
        raw_head=DirectionMetrics.from_ranks(ranks["raw_head"]),
        raw_tail=DirectionMetrics.from_ranks(ranks["raw_tail"]),
        filt_head=DirectionMetrics.from_ranks(ranks["filt_head"]),
        filt_tail=DirectionMetrics.from_ranks(ranks["filt_tail"]),
        ranks=ranks,
    )
