"""DistMult: score(h, r, t) = −Σ_d e_h·v_r·e_t (lower = better).

Beyond-parity addition (the reference ships only the translational
family, SURVEY.md §2.1): the simplest bilinear model. The framework keeps
a lower-is-better score convention throughout (margin loss, ranking,
thresholds), so the bilinear product is negated. Evaluation reduces to a
single [C, d]·[d, E] matmul per direction."""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import (KGEModel, Slots, TableSpec,
                                           register)


@register
class DistMult(KGEModel):
    name = "distmult"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        d = cfg.hidden_size
        return {
            "ent_embeddings": TableSpec(n_ent, d, "ent"),
            "rel_embeddings": TableSpec(n_rel, d, "rel"),
        }

    @staticmethod
    def gathers() -> Tuple:
        return (
            ("h_e", "ent_embeddings", "h"),
            ("t_e", "ent_embeddings", "t"),
            ("r_e", "rel_embeddings", "r"),
        )

    @staticmethod
    def score(slots: Slots, cfg: Config) -> jax.Array:
        return -jnp.sum(slots["h_e"] * slots["r_e"] * slots["t_e"], axis=-1)
