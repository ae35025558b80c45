"""TransR: per-relation projection matrix into relation space.

Functional re-design of the reference's ``TransR.py`` (reconstructed
``TransR.py:~1–130`` per SURVEY.md §2.1): entities live in R^{d_e},
relations in R^{d_r}; ``transfer_matrix [nR, d_e*d_r]`` holds M_r;
``e_r = e · M_r`` then the TransE residual in relation space. The batched
``e · M_r`` contraction is the model's hot matmul — expressed as an einsum
so XLA emits one batched matrix product."""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import (KGEModel, Slots, TableSpec, pnorm,
                                           register)


@register
class TransR(KGEModel):
    name = "transr"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        de, dr = cfg.d_ent, cfg.d_rel
        return {
            "ent_embeddings": TableSpec(n_ent, de, "ent"),
            "rel_embeddings": TableSpec(n_rel, dr, "rel"),
            "transfer_matrix": TableSpec(n_rel, de * dr, "rel"),
        }

    @staticmethod
    def gathers() -> Tuple:
        return (
            ("h_e", "ent_embeddings", "h"),
            ("t_e", "ent_embeddings", "t"),
            ("r_e", "rel_embeddings", "r"),
            ("m_r", "transfer_matrix", "r"),
        )

    @staticmethod
    def score(slots: Slots, cfg: Config) -> jax.Array:
        de, dr = cfg.d_ent, cfg.d_rel
        m = slots["m_r"].reshape(slots["m_r"].shape[:-1] + (de, dr))
        h_e, t_e = slots["h_e"], slots["t_e"]
        if m.ndim == h_e.ndim + 1 and m.shape[0] == 1 and h_e.shape[0] != 1:
            # untiled [1, B, de·dr] slot (all negative segments share r):
            # contract each entity segment against the single matrix set —
            # the ellipsis form would broadcast-materialize the matrices
            # S× (~155 MB/step at FB15K shapes) before the dot
            h = jnp.einsum("sbe,ber->sbr", h_e, m[0],
                           preferred_element_type=jnp.float32)
            t = jnp.einsum("sbe,ber->sbr", t_e, m[0],
                           preferred_element_type=jnp.float32)
        else:
            # batched row-vector × matrix; f32 accumulation
            h = jnp.einsum("...e,...er->...r", h_e, m,
                           preferred_element_type=jnp.float32)
            t = jnp.einsum("...e,...er->...r", t_e, m,
                           preferred_element_type=jnp.float32)
        return pnorm(h + slots["r_e"] - t, cfg.p_norm)
