"""TransD: dynamic per-pair mapping built from transfer vectors.

Functional re-design of the reference's ``TransD.py`` (reconstructed
``TransD.py:~1–130`` per SURVEY.md §2.1): transfer tables
``ent_transfer [nE,d]`` and ``rel_transfer [nR,d]``; the mapping
``M_re = r_p e_pᵀ + I`` is never materialized — ``e' = e + (e·e_p) r_p``
(vector ops only, the reference's trick kept because it is also the right
shape for the device: pure elementwise + reduction)."""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import (KGEModel, Slots, TableSpec, pnorm,
                                           register)


def _transfer(e: jax.Array, e_p: jax.Array, r_p: jax.Array) -> jax.Array:
    return e + jnp.sum(e * e_p, axis=-1, keepdims=True) * r_p


@register
class TransD(KGEModel):
    name = "transd"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        d = cfg.hidden_size
        return {
            "ent_embeddings": TableSpec(n_ent, d, "ent"),
            "rel_embeddings": TableSpec(n_rel, d, "rel"),
            "ent_transfer": TableSpec(n_ent, d, "ent"),
            "rel_transfer": TableSpec(n_rel, d, "rel"),
        }

    @staticmethod
    def gathers() -> Tuple:
        return (
            ("h_e", "ent_embeddings", "h"),
            ("t_e", "ent_embeddings", "t"),
            ("r_e", "rel_embeddings", "r"),
            ("h_p", "ent_transfer", "h"),
            ("t_p", "ent_transfer", "t"),
            ("r_p", "rel_transfer", "r"),
        )

    @staticmethod
    def score(slots: Slots, cfg: Config) -> jax.Array:
        r_p = slots["r_p"]
        h = _transfer(slots["h_e"], slots["h_p"], r_p)
        t = _transfer(slots["t_e"], slots["t_p"], r_p)
        return pnorm(h + slots["r_e"] - t, cfg.p_norm)
