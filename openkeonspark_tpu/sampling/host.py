"""ctypes wrapper around the native C++ host sampler
(``native/sampler.cpp``) — the reference's ``Base.so``-over-ctypes path
(``Config.py:~10–60`` reconstructed per SURVEY.md §2.1) rebuilt for the
accelerator input pipeline.

Two uses:
1. **Host-pipeline mode** (``Config.sampler='host'``): a background thread
   keeps N+1 batches prefetched and ``jax.device_put`` in flight so the
   device never waits on sampling — the mode to use when the on-device
   sampler's device-resident triple store doesn't fit.
2. **Parity oracle**: the reference's exact buffer layout
   (``batch_h/t/r/y``) for cross-checking the device sampler's statistics.

The library is built from ``native/sampler.cpp`` with ``make`` (g++) the
first time a process needs it (``make`` rebuilds only when the source is
newer); ``HostSampler.available()`` reports whether a toolchain exists.
No built library is kept in the repository."""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from openkeonspark_tpu.data.dataset import Dataset
from openkeonspark_tpu.data.index import KGIndex

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libokst_sampler.so")

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def _build_library() -> str:
    """Run ``make`` under an exclusive file lock, so processes that start
    at once (test workers) never load a half-written library."""
    import fcntl
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    _build_library()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.okst_create.restype = ctypes.c_void_p
    lib.okst_create.argtypes = (
        _i32p, _i32p, _i32p, ctypes.c_int64,
        _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
        _i32p, ctypes.c_int64, _i32p, ctypes.c_int64,
        _f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32)
    lib.okst_destroy.argtypes = (ctypes.c_void_p,)
    lib.okst_sample.argtypes = (
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        _i32p, _i32p, _i32p, _f32p)
    lib.okst_version.restype = ctypes.c_int32
    return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


class HostSampler:
    """Threaded native sampler over the shared CSR indexes."""

    def __init__(self, ds: Dataset, index: KGIndex, n_threads: int = 4):
        self.n_ent = ds.n_ent
        self.n_rel = ds.n_rel
        self.n_train = ds.n_train
        self._lib = _load()
        rows = index.train_row_tables(ds.train, with_rel=True)
        hr_adj = index.hr.adj.astype(np.int32)
        tr_adj = index.tr.adj.astype(np.int32)
        ent_adj = np.concatenate([hr_adj, tr_adj]) if len(tr_adj) else hr_adj
        tr_off = (rows["tr_off"].astype(np.int64) + len(hr_adj)).astype(np.int32)
        rel_adj = index.ht.adj.astype(np.int32)
        p = index.p_corrupt_head.astype(np.float32)
        c = np.ascontiguousarray
        args = [c(rows["train_h"]), c(rows["train_t"]), c(rows["train_r"]),
                c(rows["hr_off"]), c(rows["hr_cnt"]), c(tr_off),
                c(rows["tr_cnt"]), c(rows["ht_off"]), c(rows["ht_cnt"]),
                c(ent_adj), c(rel_adj), c(p)]
        self._keepalive = args
        (h, t, r, hr_off, hr_cnt, tr_off, tr_cnt, ht_off, ht_cnt,
         ent_adj, rel_adj, p) = args
        self._handle = self._lib.okst_create(
            _ptr(h, _i32p), _ptr(t, _i32p), _ptr(r, _i32p),
            ctypes.c_int64(self.n_train),
            _ptr(hr_off, _i32p), _ptr(hr_cnt, _i32p),
            _ptr(tr_off, _i32p), _ptr(tr_cnt, _i32p),
            _ptr(ht_off, _i32p), _ptr(ht_cnt, _i32p),
            _ptr(ent_adj, _i32p), ctypes.c_int64(len(ent_adj)),
            _ptr(rel_adj, _i32p), ctypes.c_int64(len(rel_adj)),
            _ptr(p, _f32p), self.n_ent, self.n_rel, n_threads)

    @staticmethod
    def available() -> bool:
        try:
            _load()
            return True
        except Exception:
            return False

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.okst_destroy(handle)

    def sample_flat(self, seed: int, batch_size: int, negative_ent: int,
                    negative_rel: int, bern: bool,
                    partition: Optional[Tuple[int, int]] = None
                    ) -> Dict[str, np.ndarray]:
        """Reference buffer layout: batch_h/t/r [B*(1+negs)], batch_y ±1
        (``Base.cpp::sampling`` output contract)."""
        n = batch_size * (1 + negative_ent + negative_rel)
        h = np.empty(n, np.int32)
        t = np.empty(n, np.int32)
        r = np.empty(n, np.int32)
        y = np.empty(n, np.float32)
        ps, sz = partition if partition else (0, 0)
        self._lib.okst_sample(
            self._handle, ctypes.c_uint64(seed), batch_size, negative_ent,
            negative_rel, int(bern), ctypes.c_int64(ps), ctypes.c_int64(sz),
            _ptr(h, _i32p), _ptr(t, _i32p), _ptr(r, _i32p), _ptr(y, _f32p))
        return {"batch_h": h, "batch_t": t, "batch_r": r, "batch_y": y}

    def sample(self, seed: int, batch_size: int, negative_ent: int,
               negative_rel: int, bern: bool,
               partition: Optional[Tuple[int, int]] = None):
        """Structured layout matching ``DeviceSampler.sample`` (a
        :class:`SampledBatch` of NumPy arrays)."""
        from openkeonspark_tpu.sampling.device import SampledBatch
        flat = self.sample_flat(seed, batch_size, negative_ent, negative_rel,
                                bern, partition)
        B = batch_size
        h, t, r = flat["batch_h"], flat["batch_t"], flat["batch_r"]
        neg_h = neg_t = neg_rel = None
        if negative_ent:
            neg_h = h[B:B * (1 + negative_ent)].reshape(negative_ent, B).T
            neg_t = t[B:B * (1 + negative_ent)].reshape(negative_ent, B).T
        if negative_rel:
            o = B * (1 + negative_ent)
            neg_rel = r[o:].reshape(negative_rel, B).T
        return SampledBatch(h=h[:B], t=t[:B], r=r[:B], neg_h=neg_h,
                            neg_t=neg_t, neg_rel=neg_rel)


class HostPipeline:
    """Double-buffered prefetch: a worker thread keeps ``depth`` sampled
    batches device-resident ahead of the consumer (SURVEY.md §7 "Host
    sampler ↔ device overlap").

    With ``group_sizes`` the worker stacks that many consecutive batches
    per item (cycling through the list) and ships ONE [S, …] pytree per
    transfer — the consumer scans the group on device in a single step
    call, amortizing the host→device round trip S× (it dominated the
    host-sampler mode's step time on remote-attached devices)."""

    def __init__(self, sampler: HostSampler, batch_size: int,
                 negative_ent: int, negative_rel: int, bern: bool,
                 seed: int = 0, depth: int = 2,
                 partition: Optional[Tuple[int, int]] = None,
                 group_sizes: Optional[list] = None):
        import jax
        import numpy as _np
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def one(s):
            return sampler.sample(s, batch_size, negative_ent,
                                  negative_rel, bern, partition)

        def worker():
            s = seed
            gi = 0
            while not self._stop.is_set():
                if group_sizes:
                    size = group_sizes[gi % len(group_sizes)]
                    gi += 1
                    singles = [one(s + k) for k in range(size)]
                    s += size
                    batch = jax.tree_util.tree_map(
                        lambda *xs: _np.stack(xs), *singles)
                else:
                    batch = one(s)
                    s += 1
                batch = jax.tree_util.tree_map(
                    lambda x: jax.device_put(x) if x is not None else None,
                    batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
