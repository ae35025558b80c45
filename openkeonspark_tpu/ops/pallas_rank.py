"""Fused candidate sweep + rank count for link-prediction evaluation: a
Pallas kernel on the Triton route.

For query ``c`` and candidate entity ``e`` the score is the p-norm of the
residual

    r = q_c + s·(E[e] + cvec[e]·u_c)          p ∈ {1, 2}

or, with ``modulus=True`` (RotatE, ``E`` rows laid out re|im), the sum of
complex-lane moduli ``Σ_l √(r_re,l² + r_im,l² + ε)`` of ``q_c + s·E[e]``.
TransE uses ``cvec = 0``; TransD ``cvec[e] = E[e]·P[e]`` with ``u`` the
relation's transfer vector; the relation-grouped TransR/TransH eval
sweeps a table projected once per relation, with ``cvec = 0``.

The kernel counts, per query, the candidates that score strictly below
the query's gold score; the gold id and ids ≥ ``n_ent`` never count.
The plain path (``eval/link_prediction.py::_rank_chunk``) sweeps the
table twice (gold, then count), and XLA lowers each sweep as a
broadcast-reduce that re-reads both d-vectors for every (query,
candidate) pair. Here a 2-D grid of (query tile, candidate tile) blocks
runs in parallel; each block walks the d axis one column at a time with
a ``[bq, be]`` accumulator in registers, so every loaded element is
reused across the other tile. Each block writes its partial counts to
``[C, n_tiles]`` and XLA sums them. Tiles are powers of two; the tails
at ``C`` and ``n_ent`` are masked, so tables are neither padded nor
transposed.

Tie exactness: :func:`residual_scores` scores explicit (query, candidate)
pairs with the same column-sequential accumulation, so the gold and
known-true scores the caller compares against the kernel's counts come
from the same arithmetic. On the CPU (interpret mode) the two agree bit
for bit. On the GPU the compiler may contract a multiply-add into one
FMA in one of them and not the other, so a pair within a rounding error
of the gold score can flip: a filtered rank then moves by one.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# ε under the per-lane modulus sqrt, as in models/rotate.py
ROT_EPS = 1e-12

# (query tile, candidate tile, warps) of the sweep: the fastest of seven
# shapes tried on an H100 at a 256-query chunk over 14,541 entities, d=200
BLOCK_Q = 128
BLOCK_E = 64
NUM_WARPS = 4


def _residual(qk, ek, sign: float, uk=None, ck=None):
    """``q + s·(e + c·u)`` for one column; ``s`` is applied as an add or a
    subtract so no multiply by ±1 reaches the compiler."""
    if uk is not None:
        ek = ek + ck * uk
    return qk - ek if sign < 0 else qk + ek


def _count_kernel(*refs, sign: float, p: int, modulus: bool, has_u: bool,
                  n_q: int, n_ent: int, d: int, bq: int, be: int):
    if has_u:
        q_ref, u_ref, tab_ref, c_ref, gold_ref, gid_ref, out_ref = refs
    else:
        q_ref, tab_ref, gold_ref, gid_ref, out_ref = refs
    i = pl.program_id(0)
    j = pl.program_id(1)
    qi = i * bq + jnp.arange(bq, dtype=jnp.int32)
    ej = j * be + jnp.arange(be, dtype=jnp.int32)
    qm = qi < n_q
    em = ej < n_ent
    qrow = qi * d
    erow = ej * d
    cv = (plgpu.load(c_ref.at[ej], mask=em, other=0.0)[None, :]
          if has_u else None)

    def q_col(k):
        return plgpu.load(q_ref.at[qrow + k], mask=qm, other=0.0)[:, None]

    def e_col(k):
        return plgpu.load(tab_ref.at[erow + k], mask=em, other=0.0)[None, :]

    if modulus:
        half = d // 2

        def body(k, acc):
            re = _residual(q_col(k), e_col(k), sign)
            im = _residual(q_col(k + half), e_col(k + half), sign)
            return acc + jnp.sqrt(re * re + im * im + ROT_EPS)

        n_cols = half
    else:
        def body(k, acc):
            uk = (plgpu.load(u_ref.at[qrow + k], mask=qm,
                             other=0.0)[:, None] if has_u else None)
            r = _residual(q_col(k), e_col(k), sign, uk, cv)
            return acc + (jnp.abs(r) if p == 1 else r * r)

        n_cols = d

    acc = jax.lax.fori_loop(0, n_cols, body,
                            jnp.zeros((bq, be), jnp.float32))
    gold = plgpu.load(gold_ref.at[qi], mask=qm, other=0.0)
    gid = plgpu.load(gid_ref.at[qi], mask=qm, other=-1)
    better = ((acc < gold[:, None]) & em[None, :]
              & (ej[None, :] != gid[:, None]))
    counts = jnp.sum(better.astype(jnp.int32), axis=1)
    plgpu.store(out_ref.at[qi * pl.num_programs(1) + j], counts, mask=qm)


@functools.partial(jax.jit, static_argnames=(
    "sign", "p", "n_ent", "modulus", "interpret", "bq", "be", "num_warps"))
def count_better(q: jax.Array, table: jax.Array, gold: jax.Array,
                 gold_ids: jax.Array, u: Optional[jax.Array] = None,
                 cvec: Optional[jax.Array] = None, *, sign: float, p: int,
                 n_ent: int, modulus: bool = False, interpret: bool = False,
                 bq: int = BLOCK_Q, be: int = BLOCK_E,
                 num_warps: int = NUM_WARPS) -> jax.Array:
    """#{e < n_ent, e ≠ gold_ids[c] : score(c, e) < gold[c]} per query.

    ``q`` [C, D]; ``table`` [≥n_ent, D] (rows past ``n_ent`` are never
    read); ``gold`` [C] f32; ``gold_ids`` [C] int32; ``u`` [C, D] and
    ``cvec`` [≥n_ent] together or not at all. ``interpret`` runs the
    kernel through the Pallas interpreter (CPU tests)."""
    C, D = q.shape
    assert table.shape[1] == D and table.shape[0] >= n_ent, table.shape
    has_u = u is not None
    assert has_u == (cvec is not None) and not (has_u and modulus)
    nq, ne = pl.cdiv(C, bq), pl.cdiv(n_ent, be)
    f32 = lambda x: x.astype(jnp.float32).reshape(-1)
    args = [f32(q)]
    if has_u:
        args.append(f32(u))
    args.append(f32(table))
    if has_u:
        args.append(f32(cvec))
    args += [f32(gold), gold_ids.astype(jnp.int32)]
    counts = pl.pallas_call(
        functools.partial(_count_kernel, sign=sign, p=p, modulus=modulus,
                          has_u=has_u, n_q=C, n_ent=n_ent, d=D, bq=bq,
                          be=be),
        out_shape=jax.ShapeDtypeStruct((C * ne,), jnp.int32),
        grid=(nq, ne),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="rank_count",
    )(*args)
    return jnp.sum(counts.reshape(C, ne), axis=1)


def residual_scores(q: jax.Array, rows: jax.Array, sign: float, p: int,
                    u: Optional[jax.Array] = None,
                    crow: Optional[jax.Array] = None,
                    modulus: bool = False) -> jax.Array:
    """Scores of explicit (query, candidate) pairs in the kernel's
    column-sequential order. ``q`` (and ``u``) [C, D]; ``rows`` [C, D]
    or [C, K, D] with ``crow`` [C] or [C, K] → scores [C] or [C, K]."""
    q = q.astype(jnp.float32)
    rows = rows.astype(jnp.float32)
    if rows.ndim == 3:
        q = q[:, None, :]
        u = None if u is None else u[:, None, :]
    if u is not None:
        u = u.astype(jnp.float32)
        crow = crow.astype(jnp.float32)
    D = rows.shape[-1]
    acc = jnp.zeros(rows.shape[:-1], jnp.float32)
    if modulus:
        half = D // 2
        for k in range(half):
            re = _residual(q[..., k], rows[..., k], sign)
            im = _residual(q[..., k + half], rows[..., k + half], sign)
            acc = acc + jnp.sqrt(re * re + im * im + ROT_EPS)
        return acc
    for k in range(D):
        r = _residual(q[..., k], rows[..., k], sign,
                      None if u is None else u[..., k], crow)
        acc = acc + (jnp.abs(r) if p == 1 else r * r)
    return acc


@functools.partial(jax.jit, static_argnames=("sign", "p", "n_ent", "modulus",
                                             "block"))
def count_better_ref(q: jax.Array, table: jax.Array, gold: jax.Array,
                     gold_ids: jax.Array, u: Optional[jax.Array] = None,
                     cvec: Optional[jax.Array] = None, *, sign: float,
                     p: int, n_ent: int, modulus: bool = False,
                     block: int = 1024) -> jax.Array:
    """Plain-XLA reference of :func:`count_better`: the same counts from
    :func:`residual_scores` over candidate blocks, in the kernel's
    column order (so the two agree exactly wherever the compilers form
    the same float operations)."""
    nb = -(-n_ent // block)
    rows = nb * block
    tab = jnp.zeros((rows, table.shape[1]), jnp.float32).at[:n_ent].set(
        table[:n_ent].astype(jnp.float32))
    cv = (None if cvec is None else jnp.zeros((rows,), jnp.float32)
          .at[:n_ent].set(cvec[:n_ent].astype(jnp.float32)))

    def body(acc, b):
        blk = jax.lax.dynamic_slice_in_dim(tab, b * block, block, 0)
        crow = (None if cv is None else
                jax.lax.dynamic_slice_in_dim(cv, b * block, block, 0)[None])
        s = residual_scores(q, blk[None], sign, p, u, crow, modulus)
        ids = b * block + jnp.arange(block, dtype=jnp.int32)[None, :]
        better = ((s < gold[:, None]) & (ids < n_ent)
                  & (ids != gold_ids[:, None]))
        return acc + jnp.sum(better, axis=1, dtype=jnp.int32), None

    acc, _ = jax.lax.scan(body, jnp.zeros(q.shape[0], jnp.int32),
                          jnp.arange(nb))
    return acc
