"""RotatE: score(h, r, t) = Σ_d |h_d ∘ r_d − t_d| over complex lanes
(lower = better) — relations are rotations in the complex plane.

Beyond-parity addition (the reference ships only the translational
family; RotatE is the other widely reproduced distance model). Entities
are complex vectors stored as [*, 2d] tables (first d lanes real, last d
imaginary — the ComplEx lane convention); relations are **phase** vectors
θ ∈ [*, d], applied as unit rotations r_d = (cos θ_d, sin θ_d), so the
relation table is d lanes, not 2d, and ‖r_d‖ = 1 by construction (the
paper's modulus constraint is structural here, not a soft penalty).

Shape of the eval sweep: rotations are unitary, so
``‖rot(h,θ) − t‖ = ‖h − rot(t,−θ)‖`` — BOTH link-prediction directions
reduce to a per-query constant vector minus the raw candidate row
(exactly TransE's sweep form, one elementwise block scan; no per-query
rotation of the candidate table is ever materialized). See
``eval/scoring.py``.

The per-lane modulus ``sqrt(re² + im² + 1e-12)`` carries a tiny epsilon:
the gradient of sqrt at exactly 0 is infinite, and a corrupted negative
equal to a perfectly-fit positive would poison the step (the
translational models share one sqrt per SCORE at p=2; RotatE takes one
per complex lane, so the guard matters here)."""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import (KGEModel, Slots, TableSpec,
                                           register)

_EPS = 1e-12


def _halves(x: jax.Array):
    d = x.shape[-1] // 2
    return x[..., :d], x[..., d:]


def rotate_residual(h_e: jax.Array, theta: jax.Array, t_e: jax.Array):
    """(re, im) of ``rot(h, θ) − t`` with broadcasting."""
    hr, hi = _halves(h_e)
    tr_, ti = _halves(t_e)
    cos, sin = jnp.cos(theta), jnp.sin(theta)
    return (hr * cos - hi * sin - tr_, hr * sin + hi * cos - ti)


def modulus_sum(re: jax.Array, im: jax.Array) -> jax.Array:
    return jnp.sum(jnp.sqrt(re * re + im * im + _EPS), axis=-1)


@register
class RotatE(KGEModel):
    name = "rotate"

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        return {
            "ent_embeddings": TableSpec(n_ent, 2 * cfg.hidden_size, "ent"),
            "rel_embeddings": TableSpec(n_rel, cfg.hidden_size, "rel"),
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
        re, im = rotate_residual(slots["h_e"], slots["r_e"], slots["t_e"])
        return modulus_sum(re, im)
