"""ComplEx: score(h, r, t) = −Re⟨e_h, v_r, conj(e_t)⟩ (lower = better).

Beyond-parity addition (the reference ships only the translational
family). Embeddings are complex vectors stored as [*, 2d] tables — the
first d lanes real, the last d imaginary. Expanded:

    Re⟨h, r, t̄⟩ = Σ (h_re·r_re·t_re + h_im·r_re·t_im
                    + h_re·r_im·t_im − h_im·r_im·t_re)

Evaluation factors per direction into ONE [C, 2d]·[2d, E] matmul against
the raw entity table (see eval/scoring.py), so the full-entity sweep is
one matrix product. ``hidden_size`` is the complex dimension d; tables have 2d
columns."""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import (KGEModel, Slots, TableSpec,
                                           register)


def _halves(x: jax.Array):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


@register
class ComplEx(KGEModel):
    name = "complex"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        d2 = 2 * cfg.hidden_size
        return {
            "ent_embeddings": TableSpec(n_ent, d2, "ent"),
            "rel_embeddings": TableSpec(n_rel, d2, "rel"),
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
        hr, hi = _halves(slots["h_e"])
        rr, ri = _halves(slots["r_e"])
        tr, ti = _halves(slots["t_e"])
        return -jnp.sum(hr * rr * tr + hi * rr * ti + hr * ri * ti
                        - hi * ri * tr, axis=-1)
