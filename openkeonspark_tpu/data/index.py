"""CSR-style group indexes, Bernoulli statistics, and complement arrays.

Replaces the index half of ``base/Reader.h`` (reconstructed
``Reader.h:~60–180`` per SURVEY.md §2.2): the reference sorts the train
triples three ways (``trainHead`` by (h,r,t), ``trainTail`` by (t,r,h),
``trainRel``), keeps per-anchor contiguous ranges (``lefHead/rigHead`` …)
and per-relation ``left_mean``/``right_mean`` (tph/hpt) Bernoulli stats.

Here each sorted view becomes a :class:`GroupIndex`: triples grouped by an
anchor *pair* key with the grouped value column stored sorted **and
deduplicated**, plus the precomputed ``adj[i] = value[i] - rank_in_group(i)``
array that makes exact complement sampling a single ``upper_bound``
(``Corrupt.h:~40–90``'s offset trick, vectorized on the device in
``sampling/device.py``). All arrays are flat int32 so they can live in
device memory
and be consumed by jitted code without host round trips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from openkeonspark_tpu.data.dataset import Dataset, H, R, T


@dataclass
class GroupIndex:
    """Triples grouped by int64 key ``a * n_b + b``; per-group sorted unique
    value lists in one flat array."""

    keys: np.ndarray         # [G] int64, sorted unique group keys
    group_off: np.ndarray    # [G] int32 offset of each group in sorted_vals
    group_cnt: np.ndarray    # [G] int32 group sizes
    sorted_vals: np.ndarray  # [M] int32, unique values, sorted within groups
    adj: np.ndarray          # [M] int32, sorted_vals[i] - rank_in_group(i);
                             # strictly increasing within a group
    n_b: int                 # stride used in the key encoding
    n_values: int            # value-domain size (complement sampled from it)

    @property
    def max_cnt(self) -> int:
        return 0 if len(self.group_cnt) == 0 else int(self.group_cnt.max())

    def lookup(self, a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized (off, cnt) lookup for anchor pairs; cnt=0 when the
        pair never occurs (off is then arbitrary but in-range)."""
        q = np.asarray(a, dtype=np.int64) * self.n_b + np.asarray(b, dtype=np.int64)
        pos = np.searchsorted(self.keys, q)
        pos = np.minimum(pos, max(len(self.keys) - 1, 0))
        if len(self.keys) == 0:
            z = np.zeros_like(pos, dtype=np.int32)
            return z, z
        hit = self.keys[pos] == q
        off = np.where(hit, self.group_off[pos], 0).astype(np.int32)
        cnt = np.where(hit, self.group_cnt[pos], 0).astype(np.int32)
        return off, cnt

    def contains(self, a: np.ndarray, b: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorized membership test — NumPy oracle for the device-side
        binary search (tests + ad-hoc prediction filtering)."""
        off, cnt = self.lookup(a, b)
        v = np.asarray(v)
        out = np.zeros(v.shape, dtype=bool)
        flat_off, flat_cnt, flat_v = off.ravel(), cnt.ravel(), v.ravel()
        flat_out = out.ravel()
        for i in range(flat_v.size):
            o, c = int(flat_off[i]), int(flat_cnt[i])
            if c:
                j = np.searchsorted(self.sorted_vals[o:o + c], flat_v[i])
                flat_out[i] = j < c and self.sorted_vals[o + j] == flat_v[i]
        return flat_out.reshape(v.shape)


def build_group_index(a: np.ndarray, b: np.ndarray, v: np.ndarray,
                      n_b: int, n_values: int) -> GroupIndex:
    """Group ``v`` by the pair ``(a, b)``, sort + dedup within groups, and
    precompute the complement-sampling ``adj`` array."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    key = a * n_b + b
    # sort by (key, value), then drop duplicate (key, value) rows
    order = np.lexsort((v, key))
    key_s, v_s = key[order], v[order]
    if len(key_s):
        keep = np.ones(len(key_s), dtype=bool)
        keep[1:] = (key_s[1:] != key_s[:-1]) | (v_s[1:] != v_s[:-1])
        key_s, v_s = key_s[keep], v_s[keep]
    keys, group_off, group_cnt = np.unique(key_s, return_index=True, return_counts=True)
    # rank of each row within its group
    ranks = np.arange(len(v_s), dtype=np.int64)
    if len(keys):
        ranks -= np.repeat(group_off, group_cnt)
    adj = (v_s - ranks).astype(np.int32)
    return GroupIndex(
        keys=keys.astype(np.int64),
        group_off=group_off.astype(np.int32),
        group_cnt=group_cnt.astype(np.int32),
        sorted_vals=v_s.astype(np.int32),
        adj=adj,
        n_b=n_b,
        n_values=n_values,
    )


def bern_stats(train: np.ndarray, n_rel: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-relation (tph, hpt): average tails-per-head and heads-per-tail.

    Mirrors ``Reader.h``'s ``left_mean``/``right_mean`` computation
    (reconstructed ``Reader.h:~120–160``): tph[r] = #triples(r) / #distinct
    heads(r); hpt[r] = #triples(r) / #distinct tails(r). Relations absent
    from train get tph = hpt = 1 (⇒ p_corrupt_head = 0.5)."""
    tph = np.ones(n_rel, dtype=np.float32)
    hpt = np.ones(n_rel, dtype=np.float32)
    if len(train) == 0:
        return tph, hpt
    r = train[:, R].astype(np.int64)
    n_r = np.bincount(r, minlength=n_rel).astype(np.float64)
    hr = np.unique(np.stack([train[:, H].astype(np.int64), r], axis=1), axis=0)
    tr = np.unique(np.stack([train[:, T].astype(np.int64), r], axis=1), axis=0)
    distinct_heads = np.bincount(hr[:, 1], minlength=n_rel).astype(np.float64)
    distinct_tails = np.bincount(tr[:, 1], minlength=n_rel).astype(np.float64)
    present = n_r > 0
    tph[present] = (n_r[present] / distinct_heads[present]).astype(np.float32)
    hpt[present] = (n_r[present] / distinct_tails[present]).astype(np.float32)
    return tph, hpt


@dataclass
class KGIndex:
    """Everything the samplers and evaluators need, built once on host.

    ``hr`` / ``tr`` / ``ht`` follow the reference's three sorted views of the
    *train* split (corruption filters against train only, matching
    ``Corrupt.h``); ``hr_all`` / ``tr_all`` are built over train+valid+test —
    the reference's ``tripleList`` from ``importTestFiles`` — for filtered
    ranking."""

    n_ent: int
    n_rel: int
    hr: GroupIndex               # (h, r) -> sorted tails   [train]
    tr: GroupIndex               # (t, r) -> sorted heads   [train]
    ht: GroupIndex               # (h, t) -> sorted rels    [train]
    tph: np.ndarray              # [R] float32
    hpt: np.ndarray              # [R] float32
    hr_all: Optional[GroupIndex] = None   # (h, r) -> tails  [all splits]
    tr_all: Optional[GroupIndex] = None   # (t, r) -> heads  [all splits]

    @property
    def p_corrupt_head(self) -> np.ndarray:
        """Bernoulli prob of corrupting the *head* slot: tph/(tph+hpt)
        (``Base.cpp::getBatch`` reconstructed ``Base.cpp:~90–120``; Wang et
        al. 2014). Higher tails-per-head ⇒ corrupt the head more often."""
        return (self.tph / (self.tph + self.hpt)).astype(np.float32)

    def train_row_tables(self, train: np.ndarray,
                         with_rel: bool = True) -> Dict[str, np.ndarray]:
        """Per-train-triple (off, cnt) into each group index — precomputed so
        the on-device sampler never has to do a key search (positives always
        come from the train split)."""
        h, t, r = train[:, H], train[:, T], train[:, R]
        hr_off, hr_cnt = self.hr.lookup(h, r)
        tr_off, tr_cnt = self.tr.lookup(t, r)
        out = {
            "train_h": h.astype(np.int32),
            "train_t": t.astype(np.int32),
            "train_r": r.astype(np.int32),
            "hr_off": hr_off, "hr_cnt": hr_cnt,
            "tr_off": tr_off, "tr_cnt": tr_cnt,
        }
        if with_rel:
            ht_off, ht_cnt = self.ht.lookup(h, t)
            out["ht_off"], out["ht_cnt"] = ht_off, ht_cnt
        return out


def build_kg_index(ds: Dataset, for_eval: bool = True) -> KGIndex:
    train = ds.train
    hr = build_group_index(train[:, H], train[:, R], train[:, T], ds.n_rel, ds.n_ent)
    tr = build_group_index(train[:, T], train[:, R], train[:, H], ds.n_rel, ds.n_ent)
    ht = build_group_index(train[:, H], train[:, T], train[:, R], ds.n_ent, ds.n_rel)
    tph, hpt = bern_stats(train, ds.n_rel)
    hr_all = tr_all = None
    if for_eval:
        allt = ds.all_triples()
        hr_all = build_group_index(allt[:, H], allt[:, R], allt[:, T], ds.n_rel, ds.n_ent)
        tr_all = build_group_index(allt[:, T], allt[:, R], allt[:, H], ds.n_rel, ds.n_ent)
    return KGIndex(n_ent=ds.n_ent, n_rel=ds.n_rel, hr=hr, tr=tr, ht=ht,
                   tph=tph, hpt=hpt, hr_all=hr_all, tr_all=tr_all)
