"""Device mesh + sharding layouts.

Replaces the reference's distribution substrate (SURVEY.md §2.3/§2.4):
Spark/TensorFlowOnSpark placed TF parameter servers (whole embedding tables
on PS tasks, gRPC gather/update traffic) and async workers. The
equivalent here: a ``jax.sharding.Mesh`` with axes ``('data', 'model')`` —

- **'model'**: embedding tables are **row-sharded** (each shard owns a
  contiguous row range); the PS gather becomes a masked local gather +
  ``psum`` over 'model' riding ICI.
- **'data'**: the training triples are edge-partitioned; each data shard
  draws positives from its own contiguous triple slice (the reference
  gave each Spark worker a triple partition) and gradients flow back with
  an ``all_gather`` of (ids, row-grads) over 'data'.

Synchronous SPMD replaces the reference's Hogwild-async PS updates — the
per-step math matches the single-worker reference exactly; the
multi-worker numerics delta (sync vs async) is by design (DESIGN.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openkeonspark_tpu.sampling.device import DeviceSampler
from openkeonspark_tpu.train.step import TrainState

DATA, MODEL = "data", "model"
HOST = "host"   # outer axis of hierarchical (ICI-within / DCN-across) meshes


def make_mesh(shape: Tuple[int, ...] = (1, 1),
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh of shape (data, model) — or (host, data, model) for the
    hierarchical exchange step (``parallel/hier.py``), where 'host' is the
    DCN-connected outer axis and (data, model) the ICI-local grid of one
    host. ``shape=(−1, m)`` uses all devices. Devices are taken in
    ``jax.devices()`` order, which JAX guarantees groups same-process
    (same-host) devices contiguously — so a (host, data, model) reshape
    puts each host's chips in one 'host' slice."""
    devices = list(devices if devices is not None else jax.devices())
    shape = tuple(shape)
    if shape[0] == -1:
        rest = 1
        for s in shape[1:]:
            rest *= s
        shape = (len(devices) // rest,) + shape[1:]
    n = 1
    for s in shape:
        n *= s
    if n != len(devices):
        devices = devices[:n]
    arr = np.array(devices).reshape(shape)
    names = (HOST, DATA, MODEL) if len(shape) == 3 else (DATA, MODEL)
    return Mesh(arr, names)


def hier_shape(mesh_shape: Tuple[int, int],
               chips_per_host: int) -> Optional[Tuple[int, int, int]]:
    """(host, data, model) factorization of a (data, model) grid whose
    ``data×model`` devices span multiple hosts of ``chips_per_host`` chips,
    or None when the grid fits one host / does not factor. Requires the
    model axis to fit within a host (``chips_per_host % model == 0``) so
    each data row's model group rides ICI."""
    d, m = mesh_shape
    n = d * m
    if chips_per_host <= 0 or n <= chips_per_host:
        return None
    if chips_per_host % m or n % chips_per_host:
        return None
    return (n // chips_per_host, chips_per_host // m, m)


def table_spec(flat: bool = False, mesh: Optional[Mesh] = None) -> P:
    """Embedding-table row sharding. ``flat=False``: rows over 'model',
    replicated over every other axis (the legacy psum step's layout).
    ``flat=True``: rows over the WHOLE device grid (all mesh axes,
    host-major) — the owner-directed exchange steps' layout, where every
    update row crosses the wire exactly once and per-device table memory
    shrinks by the full grid factor."""
    if not flat:
        return P(MODEL, None)
    axes = tuple(mesh.axis_names) if mesh is not None else (DATA, MODEL)
    return P(axes, None)


def _put_global(x, sharding: NamedSharding):
    """Place process-local data as a global array on a (possibly
    multi-process) mesh. ``jax.device_put`` requires an addressable
    sharding, so true multi-host runs (cli/launch.py) need the
    callback form — every process holds identical full copies (fresh
    init with the same seed, or a checkpoint restore), so slicing locally
    yields a consistent global array."""
    x = np.asarray(x)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def shard_state(state: TrainState, mesh: Mesh,
                flat: bool = False) -> TrainState:
    """Place params + opt state row-sharded per :func:`table_spec`. Table
    row counts must be divisible by the sharded axis size (init with
    ``pad_to_multiple=M`` for the legacy layout, ``=grid size`` for
    ``flat``; padding to the grid size always is safe for both)."""
    from openkeonspark_tpu.parallel.hot import is_hot_key
    tspec = NamedSharding(mesh, table_spec(flat, mesh))
    rspec = NamedSharding(mesh, P())

    def put_tables(tree):
        # replicated hot companions (parallel/hot.py) stay replicated;
        # every other 2-D array is a row-sharded table
        return {k: _put_global(v, rspec if (is_hot_key(k)
                                            or getattr(v, "ndim", 0) != 2)
                               else tspec)
                for k, v in tree.items()}

    return TrainState(params=put_tables(state.params),
                      opt_state={s: put_tables(v)
                                 for s, v in state.opt_state.items()},
                      step=_put_global(state.step, rspec))


def shard_sampler(sampler: DeviceSampler, mesh: Mesh) -> DeviceSampler:
    """Replicate the triple store + CSR indexes on every device.

    The store is modest (a 10M-triple KG ≈ a few hundred MB) and every
    data shard needs global complement windows, so full replication is the
    right trade at this scale; row-sharding the store itself is a
    larger-scale follow-up (DESIGN.md)."""
    rspec = NamedSharding(mesh, P())
    children, aux = sampler.tree_flatten()
    placed = jax.tree_util.tree_map(lambda c: _put_global(c, rspec),
                                    children)
    return DeviceSampler.tree_unflatten(aux, placed)
