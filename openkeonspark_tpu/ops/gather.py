"""1-D integer gather as row-gather + lane-select.

Instead of gathering scalars from a 1-D array, this gathers whole
128-lane *rows* of a reshaped ``[ceil(N/128), 128]`` view and selects the
wanted lane with a compare+sum over the minor axis. The layout was built
for an accelerator whose scalar gather path was slow; whether it beats a
plain ``jnp.take`` on the GPU is not measured yet (ROADMAP Queue 1
item 3, Design debt 2).

``Packed1D`` wraps a 1-D int array in that layout; ``take`` has
``jnp.take(arr, idx)`` semantics for any index shape. Used by the on-device
sampler (``sampling/device.py``), whose complement binary search is built
from exactly these scalar gathers (the device-side equivalent of the
reference's pointer-chasing in ``base/Corrupt.h``, reconstructed per
SURVEY.md §2.2)."""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

LANES = 128


@jax.tree_util.register_pytree_node_class
@dataclass
class Packed1D:
    """A 1-D integer array stored as [ceil(N/128), 128] for fast gathers."""

    rows: jax.Array  # [ceil(N/128), 128]
    n: int           # logical length

    def tree_flatten(self):
        return (self.rows,), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    @classmethod
    def build(cls, arr: np.ndarray, pad_value: int = 0) -> "Packed1D":
        arr = np.asarray(arr)
        n = arr.shape[0]
        pad = (-n) % LANES
        if n == 0:
            flat = np.full((LANES,), pad_value, dtype=arr.dtype)
        elif pad:
            flat = np.concatenate(
                [arr, np.full((pad,), pad_value, dtype=arr.dtype)])
        else:
            flat = arr
        return cls(jnp.asarray(flat.reshape(-1, LANES)), n)

    def take(self, idx: jax.Array) -> jax.Array:
        """``jnp.take(arr, idx)`` (clip mode) for any index shape."""
        shape = idx.shape
        flat = jnp.clip(idx.reshape(-1), 0, max(self.n - 1, 0))
        rows = jnp.take(self.rows, flat >> 7, axis=0)          # [M, 128]
        lane = (flat & (LANES - 1))[:, None]
        picked = jnp.sum(
            jnp.where(jnp.arange(LANES, dtype=flat.dtype)[None, :] == lane,
                      rows, 0), axis=1, dtype=rows.dtype)
        return picked.reshape(shape)


@jax.tree_util.register_pytree_node_class
@dataclass
class PackedRecords:
    """K ≤ 16 parallel 1-D arrays of equal length interleaved as 16-lane
    records, so *all fields of one index* come back from a single
    128-lane row gather (8 records per row) — one vectorized gather where
    a field-per-array layout needs K.

    Used for the sampler's per-triple record (h, t, r + the four
    complement-window offsets/counts + the relation window): the
    reference reads the same record from its ``trainList`` array of
    ``Triple`` structs (``base/Reader.h``, SURVEY.md §2.2)."""

    rows: jax.Array   # [ceil(N/8), 128] — 8 stride-16 records per row
    n: int            # logical record count
    k: int            # fields per record

    STRIDE = 16
    PER_ROW = LANES // STRIDE  # 8

    def tree_flatten(self):
        return (self.rows,), (self.n, self.k)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    @classmethod
    def build(cls, fields) -> "PackedRecords":
        fields = [np.asarray(f) for f in fields]
        k = len(fields)
        assert 0 < k <= cls.STRIDE
        n = fields[0].shape[0]
        assert all(f.shape == (n,) for f in fields)
        dtype = np.result_type(*[f.dtype for f in fields]) if n else np.int32
        n_pad = max(-(-n // cls.PER_ROW) * cls.PER_ROW, cls.PER_ROW)
        rec = np.zeros((n_pad, cls.STRIDE), dtype=dtype)
        for j, f in enumerate(fields):
            rec[:n, j] = f
        return cls(jnp.asarray(rec.reshape(-1, LANES)), n, k)

    def take(self, idx: jax.Array):
        """Gather records at ``idx`` [B] → tuple of K field arrays [B]."""
        flat = jnp.clip(idx.reshape(-1), 0, max(self.n - 1, 0))
        rows = jnp.take(self.rows, flat >> 3, axis=0)           # [B, 128]
        # one select over the 8 records per row (not one per field)
        recs = rows.reshape(-1, self.PER_ROW, self.STRIDE)      # [B, 8, 16]
        slot = (flat & (self.PER_ROW - 1))[:, None]
        sel = jnp.arange(self.PER_ROW, dtype=flat.dtype)[None, :] == slot
        rec = jnp.sum(jnp.where(sel[:, :, None], recs, 0), axis=1,
                      dtype=rows.dtype)                         # [B, 16]
        return tuple(rec[:, j].reshape(idx.shape) for j in range(self.k))
