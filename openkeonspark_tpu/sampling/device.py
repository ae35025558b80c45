"""On-device negative sampling — the accelerator replacement for the
reference's C++ sampler (``base/Base.cpp::sampling`` + ``base/Corrupt.h`` +
``base/Random.h``, reconstructed per SURVEY.md §2.2).

The reference fills host buffers with pthreads and feeds them through
``feed_dict`` every step. Here sampling is part of the jitted training step
itself: uniform positive draws, Bernoulli corrupt-head/tail choice, and
**exact filtered** corruption (negatives never collide with a known train
triple) all run on the device as pure vector ops, so the table gathers that
follow never wait on the host.

Filtered corruption keeps ``Corrupt.h``'s complement "offset trick"
(``Corrupt.h:~40–90``): to sample uniformly from entities **not** in the
sorted group list ``g[0..cnt)``, draw ``x ~ U[0, n − cnt)`` and return
``x + |{i : g[i] − i ≤ x}|``. The count is an ``upper_bound`` over the
precomputed strictly-increasing ``adj[i] = g[i] − i`` window — evaluated
here as a *batched bitwise binary search*: a ``fori_loop`` of
``ceil(log2(max_cnt))`` rounds of pure vector compares/gathers, no
data-dependent control flow, identical cost for every lane (XLA-friendly,
no warp-divergence analog).

Every 1-D array the sampler touches is stored in the ``Packed1D``
row-gather layout (``ops/gather.py``), built for an accelerator whose
scalar 1-D gather path was slow; its cost on the GPU is not measured yet.

Randomness: ``jax.random`` threefry bits with modulo range reduction —
the same reduction the reference's per-thread LCG uses
(``Random.h::rand_max`` = ``rand() % x``), so the (negligible) modulo bias
is parity rather than a regression.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from openkeonspark_tpu.data.dataset import Dataset
from openkeonspark_tpu.data.index import KGIndex
from openkeonspark_tpu.ops.gather import Packed1D, PackedRecords


def _ceil_log2(n: int) -> int:
    n = max(int(n), 1)
    return max(1, (n - 1).bit_length())


def _take(arr: Union[jax.Array, Packed1D], idx: jax.Array) -> jax.Array:
    return arr.take(idx) if isinstance(arr, Packed1D) else jnp.take(arr, idx)


def _window_count_le(arr: Packed1D, start: jax.Array, lo: jax.Array,
                     hi: jax.Array, x: jax.Array) -> jax.Array:
    """``|{i in [lo,hi): arr[start+i] <= x}|`` for windows of width ≤ 128.

    Two *independent* (pipelineable) row gathers cover the ≤128-element
    window wherever it straddles a row boundary; the count is then one
    vectorized masked reduction — this replaces the last 7 rounds of
    binary search, whose probes form a serial dependence chain."""
    shape = lo.shape
    p0 = (start + lo).reshape(-1)                       # window start, flat
    row0 = p0 >> 7
    r0 = jnp.take(arr.rows, row0, axis=0)               # [M, 128]
    r1 = jnp.take(arr.rows, row0 + 1, axis=0)           # clip pads the tail
    vals = jnp.concatenate([r0, r1], axis=1)            # [M, 256]
    pos = (row0[:, None] << 7) + jnp.arange(256, dtype=p0.dtype)[None, :]
    win_lo = p0[:, None]
    win_hi = (start + hi).reshape(-1)[:, None]
    ok = (pos >= win_lo) & (pos < win_hi) & (vals <= x.reshape(-1)[:, None])
    return (lo + jnp.sum(ok, axis=1).astype(lo.dtype).reshape(shape))


def batched_upper_bound(arr: Union[jax.Array, Packed1D], off: jax.Array,
                        cnt: jax.Array, x: jax.Array,
                        iters: int) -> jax.Array:
    """For each lane: ``|{i in [0,cnt): arr[off+i] <= x}|``.

    ``arr`` holds per-group sorted windows back to back (plain 1-D or
    ``Packed1D``); ``iters`` must be a static bound ≥ ceil(log2(max cnt +
    1)). Hybrid search: ``max(0, iters − 7)`` statically-unrolled rounds of
    vector binary search narrow every window to ≤ 128 elements, then one
    vectorized two-row count finishes exactly (``_window_count_le``). The
    binary rounds' probes are a serial gather chain — the hybrid keeps that
    chain short regardless of group size.

    (Earlier measurements on another accelerator: a k-ary variant — one
    [lanes, k−1] probe gather per round — lost to flat rounds, and a
    lax.fori_loop lost to static unrolling; not re-measured on the GPU.)"""
    shape = jnp.broadcast_shapes(jnp.shape(cnt), jnp.shape(x),
                                 jnp.shape(off))
    lo = jnp.zeros(shape, dtype=cnt.dtype)
    hi = jnp.broadcast_to(cnt, shape)

    packed = isinstance(arr, Packed1D)
    rounds = max(0, iters - 7) if packed else iters
    for _ in range(rounds):
        mid = (lo + hi) >> 1
        probe = _take(arr, off + jnp.minimum(mid, jnp.maximum(cnt - 1, 0)))
        go_right = (mid < hi) & (probe <= x)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    if packed:
        lo = _window_count_le(arr, off, lo, hi, x)
    return lo


def _mod_range(bits: jax.Array, bound: jax.Array) -> jax.Array:
    """Uniform int in [0, bound) from 32 random bits mod bound — the
    reference's ``rand_max`` reduction (``Random.h:~20–40``)."""
    return (bits % jnp.maximum(bound, 1).astype(jnp.uint32)).astype(jnp.int32)


def _complement_sample(bits: jax.Array, arr: Union[jax.Array, Packed1D],
                       off: jax.Array, cnt: jax.Array, n_vals: int,
                       iters: int, avoid: jax.Array) -> jax.Array:
    """Uniform draw from ``[0, n_vals) \\ group`` via the offset trick;
    ``bits`` are pre-drawn u32 random bits of the output shape (one
    batched PRNG call per step covers every draw — at small batches the
    per-HLO-op cost of separate threefry calls was 82% of the whole
    sampling stage, BASELINE.md config #1).

    Degenerate case the reference never hits at KG scale but we must
    (``Corrupt.h`` would spin forever): when the group already contains
    *every* value the complement is empty — fall back to uniform over the
    domain minus the positive's own value ``avoid`` (a collision with some
    *other* train triple is then unavoidable, but the negative never equals
    its positive)."""
    full = cnt >= jnp.int32(n_vals)
    space = jnp.where(full, jnp.int32(max(n_vals - 1, 1)),
                      jnp.maximum(jnp.int32(n_vals) - cnt, 1))
    x = _mod_range(bits, space)
    k = batched_upper_bound(arr, off, cnt, x, iters)
    fallback = x + (x >= avoid).astype(x.dtype)
    return jnp.where(jnp.broadcast_to(full, x.shape), fallback, x + k)


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceSampler:
    """Device-resident triple store + corruption indexes.

    The arrays live in HBM for the whole run (10M triples ≈ a few hundred
    MB); every ``sample`` call is traceable and fuses into the train step.
    **Always pass the sampler into jitted code as an argument** — closing
    over it embeds the triple store as executable constants (bloated
    programs)."""

    # one interleaved record per train triple: (h, t, r, hr_off, hr_cnt,
    # tr_off, tr_cnt, ht_off, ht_cnt) — all nine fields of a positive come
    # from a single 128-lane row gather (ops/gather.py PackedRecords)
    trip: PackedRecords
    ent_adj: Packed1D     # concat(hr.adj, tr.adj) — tr_off pre-shifted
    rel_adj: Packed1D
    p_corrupt_head: Packed1D  # [R] float32 (bern); 0.5 used when bern=False
    # static metadata
    n_ent: int
    n_rel: int
    n_train: int
    ent_iters: int
    rel_iters: int

    def tree_flatten(self):
        children = (self.trip, self.ent_adj, self.rel_adj,
                    self.p_corrupt_head)
        aux = (self.n_ent, self.n_rel, self.n_train, self.ent_iters,
               self.rel_iters)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    def store_bytes(self) -> int:
        """HBM footprint of the sampler's device-resident arrays (packed
        triple records + complement adjacencies + bern table). Compare
        against the chip's HBM budget (minus tables/optimizer/workspace)
        when choosing ``sampler='device'`` vs ``'host'`` — the host
        pipeline (``sampling/host.py``) exists precisely for stores that
        do not fit (measured ≈48 B/triple + 4 B/adjacency entry; see
        DESIGN.md "host-sampler crossover")."""
        import numpy as _np
        return int(sum(_np.asarray(leaf).nbytes for leaf in
                       jax.tree_util.tree_leaves(self.tree_flatten()[0])))

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, ds: Dataset, index: KGIndex) -> "DeviceSampler":
        rows = index.train_row_tables(ds.train, with_rel=True)
        hr_adj = index.hr.adj
        tr_adj = index.tr.adj
        ent_adj = np.concatenate([hr_adj, tr_adj]) if len(tr_adj) else hr_adj
        tr_off = rows["tr_off"].astype(np.int64) + len(hr_adj)
        max_ent_cnt = max(index.hr.max_cnt, index.tr.max_cnt, 1)
        max_rel_cnt = max(index.ht.max_cnt, 1)
        trip = PackedRecords.build([
            rows["train_h"], rows["train_t"], rows["train_r"],
            rows["hr_off"], rows["hr_cnt"],
            tr_off.astype(np.int32), rows["tr_cnt"],
            rows["ht_off"], rows["ht_cnt"]])
        return cls(
            trip=trip,
            ent_adj=Packed1D.build(ent_adj.astype(np.int32)),
            rel_adj=Packed1D.build(index.ht.adj.astype(np.int32)),
            p_corrupt_head=Packed1D.build(
                index.p_corrupt_head.astype(np.float32)),
            n_ent=ds.n_ent, n_rel=ds.n_rel, n_train=len(ds.train),
            ent_iters=_ceil_log2(max_ent_cnt + 1),
            rel_iters=_ceil_log2(max_rel_cnt + 1),
        )

    # ------------------------------------------------------------------
    @staticmethod
    def bits_cols(negative_ent: int, negative_rel: int) -> int:
        """u32 columns one step's draws consume (see ``sample``)."""
        return 1 + 2 * negative_ent + negative_rel

    def sample(self, key: jax.Array, batch_size: int, negative_ent: int,
               negative_rel: int, bern: bool,
               partition: Optional[Tuple[jax.Array, jax.Array]] = None,
               bits: Optional[jax.Array] = None) -> "SampledBatch":
        """Draw a batch: ``batch_size`` uniform positives + per-positive
        corrupted negatives (``Base.cpp::getBatch`` semantics).

        ``partition=(start, size)`` restricts positive draws to a contiguous
        triple slice — edge partitioning for data-parallel shards."""
        # ONE batched PRNG call serves every draw of the step: positive
        # index (col 0), bern flip (cols 1..negE), entity corruption
        # (next negE cols), relation corruption (last negR cols). The
        # previous split+4-draws design cost ~0.083 ms/step in threefry
        # dispatch alone at B=400 — 66% of the whole step (config #1).
        # Scan-fused callers amortize further by pre-drawing the whole
        # step group's bits [S, B, cols] and passing per-step slices.
        n_e, n_r = negative_ent, negative_rel
        if bits is None:
            bits = jax.random.bits(key, (batch_size, 1 + 2 * n_e + n_r),
                                   dtype=jnp.uint32)

        if partition is None:
            idx = _mod_range(bits[:, 0], jnp.int32(self.n_train))
        else:
            start, size = partition
            idx = start + _mod_range(bits[:, 0], size)

        (h, t, r, hr_off, hr_cnt, tr_off, tr_cnt,
         ht_off, ht_cnt) = self.trip.take(idx)

        neg_h = neg_t = None
        if n_e > 0:
            if bern:
                p_head = self.p_corrupt_head.take(r)[:, None]
            else:
                p_head = jnp.float32(0.5)
            # flip bits → uniform [0,1) with 2^-24 granularity (the
            # reference's rand()/RAND_MAX has coarser, 2^-31-biased
            # granularity, so this is within parity)
            u = ((bits[:, 1:1 + n_e] >> 8).astype(jnp.float32)
                 * jnp.float32(1.0 / (1 << 24)))
            corrupt_head = u < p_head

            # one fused complement search over the concatenated adj array:
            # head-corruption uses the (t,r)→heads window, tail-corruption
            # the (h,r)→tails window
            off = jnp.where(corrupt_head, tr_off[:, None], hr_off[:, None])
            cnt = jnp.where(corrupt_head, tr_cnt[:, None], hr_cnt[:, None])
            avoid = jnp.where(corrupt_head, h[:, None], t[:, None])
            corrupted = _complement_sample(bits[:, 1 + n_e:1 + 2 * n_e],
                                           self.ent_adj, off, cnt,
                                           self.n_ent, self.ent_iters,
                                           avoid)
            neg_h = jnp.where(corrupt_head, corrupted, h[:, None])
            neg_t = jnp.where(corrupt_head, t[:, None], corrupted)

        neg_rel = None
        if n_r > 0:
            neg_rel = _complement_sample(bits[:, 1 + 2 * n_e:],
                                         self.rel_adj, ht_off[:, None],
                                         ht_cnt[:, None], self.n_rel,
                                         self.rel_iters, r[:, None])

        return SampledBatch(h=h, t=t, r=r, neg_h=neg_h, neg_t=neg_t,
                            neg_rel=neg_rel)


@jax.tree_util.register_pytree_node_class
@dataclass
class SampledBatch:
    """Positives [B] and structured negatives ([B, negE] entity-corrupted
    triples sharing r; [B, negR] corrupted relations sharing (h, t))."""

    h: jax.Array
    t: jax.Array
    r: jax.Array
    neg_h: Optional[jax.Array] = None
    neg_t: Optional[jax.Array] = None
    neg_rel: Optional[jax.Array] = None

    def tree_flatten(self):
        return (self.h, self.t, self.r, self.neg_h, self.neg_t,
                self.neg_rel), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def flatten_reference_layout(b: SampledBatch) -> Dict[str, jax.Array]:
    """Reference buffer-layout parity (``Model.py`` slot convention,
    SURVEY.md §2.1): slot j<B = positive j; negatives at j + B*(1+k);
    y = +1 for positives, −1 for negatives. Used by the host-sampler
    interop tests and anywhere layout parity with ``Base.so`` matters."""
    B = b.h.shape[0]
    hs, ts, rs = [b.h], [b.t], [b.r]
    if b.neg_h is not None:
        for k in range(b.neg_h.shape[1]):
            hs.append(b.neg_h[:, k])
            ts.append(b.neg_t[:, k])
            rs.append(b.r)
    if b.neg_rel is not None:
        for k in range(b.neg_rel.shape[1]):
            hs.append(b.h)
            ts.append(b.t)
            rs.append(b.neg_rel[:, k])
    batch_h = jnp.concatenate(hs)
    batch_t = jnp.concatenate(ts)
    batch_r = jnp.concatenate(rs)
    n_neg = batch_h.shape[0] // B - 1
    batch_y = jnp.concatenate([jnp.ones((B,), jnp.float32),
                               -jnp.ones((B * n_neg,), jnp.float32)])
    return {"batch_h": batch_h, "batch_t": batch_t, "batch_r": batch_r,
            "batch_y": batch_y}
