"""Blocked candidate scoring: a chunk of queries against a block of
candidate entities, per model.

This is the compute core of link prediction (reference ``Test.h``'s
``getHeadBatch``/``getTailBatch`` + ``Config.test``'s ``sess.run(predict)``
over N_entity candidates, SURVEY.md §3.3). The reference materializes
N_entity candidate triples per test triple and scores them one test triple
at a time; here scoring is [C queries × E candidates] tiles, and the
caller ``lax.scan``s over entity blocks so the [C, E, d] broadcast
intermediates stay small.

Two-stage contract (so the multi-device evaluator in ``parallel/eval.py``
can score *local shards* of the candidate axis):

- ``build_queries(model_name, params, h, t, r, replace, cfg)`` → a small
  per-query pytree (gathered/projected rows), replicated everywhere;
- ``score_block(model_name, q, cand, cfg)`` → scores [C, E_blk] where
  ``cand`` is a dict of the *entity-kind* table rows for the candidate
  block (``ent_embeddings`` always; ``ent_transfer`` too for TransD).

``candidate_scores`` composes the two for the single-device path.
Scores follow the lower-is-better convention; p=2 paths use matmul
identities so the C×E work becomes one matrix product.

Every matrix product here runs at ``Precision.HIGHEST``: a default
float32 product may run in TF32 on the GPU (about three decimal
digits), while the known-true filter scores its ids through the
elementwise triple path — the mismatch would flip filtered ranks."""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import pnorm

_HIGHEST = jax.lax.Precision.HIGHEST

# tables whose rows form the candidate axis, per model
CANDIDATE_TABLES = {
    "transe": ("ent_embeddings",),
    "transh": ("ent_embeddings",),
    "transr": ("ent_embeddings",),
    "transd": ("ent_embeddings", "ent_transfer"),
    "distmult": ("ent_embeddings",),
    "complex": ("ent_embeddings",),
    "rotate": ("ent_embeddings",),
}


def _slice_rows(table: jax.Array, start: jax.Array, size: int) -> jax.Array:
    return jax.lax.dynamic_slice_in_dim(table, start, size, axis=0)


# --------------------------------------------------------------------------
# stage 1: per-query tensors


def build_queries(model_name: str, params: Dict[str, jax.Array],
                  h: jax.Array, t: jax.Array, r: jax.Array, replace: str,
                  cfg: Config, take=None) -> Dict[str, jax.Array]:
    """``take(table, ids) -> rows`` defaults to a plain row gather; the
    multi-device evaluator passes a masked-take+psum so the same query
    recipes work on row-sharded tables inside its shard_map."""
    if take is None:
        take = lambda X, ids: jnp.take(X, ids, 0)
    dt = jnp.dtype(cfg.eval_dtype)
    E = params["ent_embeddings"].astype(dt)
    R = params["rel_embeddings"].astype(dt)
    if model_name == "transe":
        if replace == "tail":
            return {"q": take(E, h) + take(R, r)}
        return {"q": take(R, r) - take(E, t)}
    if model_name == "transh":
        from openkeonspark_tpu.models.transh import unit
        w = unit(take(params["normal_vectors"].astype(dt), r))
        if replace == "tail":
            eh = take(E, h)
            q = eh - jnp.sum(eh * w, -1, keepdims=True) * w + take(R, r)
        else:
            et = take(E, t)
            q = take(R, r) - (et - jnp.sum(et * w, -1,
                                                  keepdims=True) * w)
        return {"q": q, "w": w}
    if model_name == "transr":
        de, dr = cfg.d_ent, cfg.d_rel
        m = take(params["transfer_matrix"].astype(dt), r
                 ).reshape(-1, de, dr)
        if replace == "tail":
            ph = jnp.einsum("cd,cdk->ck", take(E, h), m,
                            preferred_element_type=jnp.float32,
                            precision=_HIGHEST).astype(dt)
            q = ph + take(R, r)
        else:
            pt = jnp.einsum("cd,cdk->ck", take(E, t), m,
                            preferred_element_type=jnp.float32,
                            precision=_HIGHEST).astype(dt)
            q = take(R, r) - pt
        return {"q": q, "m": m}
    if model_name == "distmult":
        # score = −Σ h·r·t: both directions reduce to q·e_c with
        # q = (anchor ⊙ r) — the sweep is one matrix product
        if replace == "tail":
            return {"q": take(E, h) * take(R, r)}
        return {"q": take(E, t) * take(R, r)}
    if model_name == "complex":
        # Re⟨h, r, t̄⟩ is bilinear in the raw [2d] entity rows of the
        # swept slot: q·e_c with the q below (eval/scoring convention:
        # first d lanes real, last d imaginary)
        d = E.shape[1] // 2
        rr, ri = take(R, r)[:, :d], take(R, r)[:, d:]
        if replace == "tail":
            hr, hi = take(E, h)[:, :d], take(E, h)[:, d:]
            q = jnp.concatenate([hr * rr - hi * ri, hi * rr + hr * ri], -1)
        else:
            tr, ti = take(E, t)[:, :d], take(E, t)[:, d:]
            q = jnp.concatenate([rr * tr + ri * ti, rr * ti - ri * tr], -1)
        return {"q": q}
    if model_name == "rotate":
        # rotations are unitary: ‖rot(h,θ) − t‖ = ‖h − rot(t,−θ)‖, so
        # both directions sweep raw candidate rows against one per-query
        # constant (TransE's sweep form). score_block computes
        # modulus_sum(q + sign·e_c); head queries carry −rot(t,−θ) so
        # sign=+1 yields e_c − rot(t,−θ)
        th = take(R, r)
        cos, sin = jnp.cos(th), jnp.sin(th)
        if replace == "tail":
            eh = take(E, h)
            d = eh.shape[-1] // 2
            hr, hi = eh[..., :d], eh[..., d:]
            q = jnp.concatenate([hr * cos - hi * sin,
                                 hr * sin + hi * cos], -1)
        else:
            et = take(E, t)
            d = et.shape[-1] // 2
            tr_, ti = et[..., :d], et[..., d:]
            # −rot(t, −θ)
            q = -jnp.concatenate([tr_ * cos + ti * sin,
                                  ti * cos - tr_ * sin], -1)
        return {"q": q}
    if model_name == "transd":
        rp = take(params["rel_transfer"].astype(dt), r)
        EP = params["ent_transfer"].astype(dt)
        if replace == "tail":
            eh = take(E, h)
            ehp = take(EP, h)
            q = eh + jnp.sum(eh * ehp, -1, keepdims=True) * rp \
                + take(R, r)
        else:
            et = take(E, t)
            etp = take(EP, t)
            q = take(R, r) - (et + jnp.sum(et * etp, -1,
                                                  keepdims=True) * rp)
        return {"q": q, "rp": rp}
    raise ValueError(model_name)


# --------------------------------------------------------------------------
# stage 2: score a candidate block given its table rows


def score_block(model_name: str, q: Dict[str, jax.Array],
                cand: Dict[str, jax.Array], replace: str,
                cfg: Config) -> jax.Array:
    """[C, E_blk] scores; ``cand['ent_embeddings']`` [E_blk, d] (+
    ``ent_transfer`` for TransD). ``replace`` fixes the residual sign."""
    dt = jnp.dtype(cfg.eval_dtype)
    ce = cand["ent_embeddings"].astype(dt)
    sign = -1.0 if replace == "tail" else 1.0
    p = cfg.p_norm

    if model_name == "transe":
        if p == 2:
            # ‖q + s·ce‖² = ‖q‖² + 2s(q·ce) + ‖ce‖², one matrix product
            qq = jnp.sum(q["q"] * q["q"], -1, keepdims=True)
            cc = jnp.sum(ce * ce, -1)[None, :]
            cross = jnp.dot(q["q"], ce.T, preferred_element_type=jnp.float32,
                            precision=_HIGHEST).astype(dt)
            return qq + 2.0 * sign * cross + cc
        return pnorm(q["q"][:, None, :] + sign * ce[None, :, :], 1)

    if model_name == "transh":
        w = q["w"]
        dots = jnp.dot(w, ce.T, preferred_element_type=jnp.float32,
                       precision=_HIGHEST).astype(dt)     # [C, E]
        proj = sign * ce[None, :, :] - sign * dots[:, :, None] * w[:, None, :]
        return pnorm(q["q"][:, None, :] + proj, p)

    if model_name == "transr":
        pce = jnp.einsum("ed,cdk->cek", ce, q["m"],
                         preferred_element_type=jnp.float32,
                         precision=_HIGHEST).astype(dt)
        return pnorm(q["q"][:, None, :] + sign * pce, p)

    if model_name == "rotate":
        from openkeonspark_tpu.models.rotate import modulus_sum
        res = q["q"][:, None, :] + sign * ce[None, :, :]
        d = res.shape[-1] // 2
        return modulus_sum(res[..., :d], res[..., d:])

    if model_name in ("distmult", "complex"):
        # −(q @ e_cᵀ), one matrix product for the whole block
        return -jnp.dot(q["q"], ce.T, preferred_element_type=jnp.float32,
                        precision=_HIGHEST).astype(dt)

    if model_name == "transd":
        cep = cand["ent_transfer"].astype(dt)
        cdot = jnp.sum(ce * cep, -1)                      # [E]
        proj = (sign * ce[None, :, :]
                + sign * cdot[None, :, None] * q["rp"][:, None, :])
        return pnorm(q["q"][:, None, :] + proj, p)

    raise ValueError(model_name)


# --------------------------------------------------------------------------
# composed single-device path (back-compat surface)


def candidate_scores(model_name: str, params: dict, h: jax.Array,
                     t: jax.Array, r: jax.Array, cand0: jax.Array,
                     block: int, replace: str, cfg: Config) -> jax.Array:
    """Scores [C, block] of queries (h,t,r) with the ``replace`` slot swept
    over entities [cand0, cand0+block). Padding candidates are NOT masked
    here — the caller masks ids ≥ n_ent."""
    q = build_queries(model_name, params, h, t, r, replace, cfg)
    cand = {name: _slice_rows(params[name].astype(jnp.dtype(cfg.eval_dtype)),
                              cand0, block)
            for name in CANDIDATE_TABLES[model_name]}
    return score_block(model_name, q, cand, replace, cfg)
