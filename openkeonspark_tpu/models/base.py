"""Model contract.

Replaces the reference's ``Model.py`` template-method base class
(reconstructed ``Model.py:~1–90`` per SURVEY.md §2.1: placeholders +
``input_def/embedding_def/loss_def/predict_def``). The TF-1.x graph-class
pattern becomes a purely functional contract designed for sparse-gradient
training on an accelerator:

- ``tables(cfg, n_ent, n_rel)`` — name → :class:`TableSpec` (embedding
  matrices; every table gets **one extra padding row** so masked/sharded
  scatters have a safe sink and row counts can be padded to the mesh).
- ``gathers()`` — tuple of ``(slot, table, anchor)`` where anchor ∈
  {"h","t","r"}: which table is gathered with which id stream to produce
  the per-triple row bundle ("slots").
- ``score(slots, cfg)`` — distance-style score, **lower = better** (the
  reference convention: ranks count candidates with smaller score,
  ``Test.h:~120–200``; thresholds classify ``score < thresh`` as true).

Training takes ``jax.grad`` w.r.t. the *gathered rows* and scatter-adds —
the dense tables never see a dense gradient (TF ``IndexedSlices`` parity,
SURVEY.md §2.3 "gradient-sparsity parallelism").
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openkeonspark_tpu.config import Config

Params = Dict[str, jax.Array]
Slots = Dict[str, jax.Array]
Gather = Tuple[str, str, str]  # (slot, table, anchor)


@dataclass(frozen=True)
class TableSpec:
    rows: int          # logical rows (entities or relations) — pad row excluded
    dim: int
    kind: str          # "ent" | "rel" (drives sharding + export naming)


def xavier_uniform(key: jax.Array, rows: int, dim: int,
                   dtype=jnp.float32) -> jax.Array:
    """TF ``xavier_initializer(uniform=True)`` semantics on a [rows, dim]
    variable (fan_in=rows, fan_out=dim) — the reference's init for every
    embedding table (``TransE.py:~20–30`` reconstructed)."""
    limit = math.sqrt(6.0 / (rows + dim))
    return jax.random.uniform(key, (rows, dim), dtype, -limit, limit)


def init_tables(key: jax.Array, specs: Dict[str, TableSpec],
                dtype=jnp.float32, pad_to_multiple: int = 1) -> Params:
    """Initialize all tables with one zero padding row appended (and row
    count rounded up to ``pad_to_multiple`` for even mesh sharding). Row ids
    ≥ spec.rows are padding: gathers return 0, scatters are discarded."""
    params: Params = {}
    names = sorted(specs)
    keys = jax.random.split(key, len(names))
    for k, name in zip(keys, names):
        spec = specs[name]
        body = xavier_uniform(k, spec.rows, spec.dim, dtype)
        total = padded_rows(spec.rows, pad_to_multiple)
        pad = jnp.zeros((total - spec.rows, spec.dim), dtype)
        params[name] = jnp.concatenate([body, pad], axis=0)
    return params


def padded_rows(rows: int, multiple: int = 1) -> int:
    """Physical row count: logical rows + ≥1 pad row, rounded up."""
    total = rows + 1
    return ((total + multiple - 1) // multiple) * multiple


def strip_padding(params: Params, specs: Dict[str, TableSpec]) -> Dict[str, np.ndarray]:
    """Drop padding rows — for export (``embedding.vec.json`` parity) and
    parity tests against the oracle."""
    return {name: np.asarray(params[name][: specs[name].rows])
            for name in specs}


def pnorm(x: jax.Array, p: int, axis: int = -1) -> jax.Array:
    """Reference score reduction: p=1 → Σ|x| (TF ``reduce_sum(abs(...))``,
    ``TransE.py::_calc`` reconstructed); p=2 → Σx² (squared L2)."""
    if p == 1:
        return jnp.sum(jnp.abs(x), axis=axis)
    return jnp.sum(x * x, axis=axis)


class KGEModel:
    """Base for the four translational models; subclasses fill in the class
    attrs / static methods (the functional analog of the reference's
    ``embedding_def``/``loss_def``/``predict_def`` template methods)."""

    name: str = ""

    @staticmethod
    def tables(cfg: Config, n_ent: int, n_rel: int) -> Dict[str, TableSpec]:
        raise NotImplementedError

    @staticmethod
    def gathers() -> Tuple[Gather, ...]:
        raise NotImplementedError

    @staticmethod
    def score(slots: Slots, cfg: Config) -> jax.Array:
        raise NotImplementedError

    # --- generic machinery shared by all models ------------------------

    @classmethod
    def gather_slots(cls, params: Params, h: jax.Array, t: jax.Array,
                     r: jax.Array) -> Slots:
        ids = {"h": h, "t": t, "r": r}
        return {slot: jnp.take(params[table], ids[anchor], axis=0)
                for slot, table, anchor in cls.gathers()}

    @classmethod
    def score_triples(cls, params: Params, h: jax.Array, t: jax.Array,
                      r: jax.Array, cfg: Config) -> jax.Array:
        """predict_def parity: score arbitrary id triples (lower=better)."""
        return cls.score(cls.gather_slots(params, h, t, r), cfg)


_REGISTRY: Dict[str, type] = {}


def register(model_cls: type) -> type:
    _REGISTRY[model_cls.name] = model_cls
    return model_cls


def get_model(name: str) -> type:
    from openkeonspark_tpu.models import (transe, transh, transr,  # noqa: F401
                                          transd, distmult, complexe,
                                          rotate)
    return _REGISTRY[name]
