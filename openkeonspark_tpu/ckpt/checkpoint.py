"""Checkpoint / resume / export.

Replaces the reference's persistence layer (SURVEY.md §5 "Checkpoint /
resume"): ``tf.train.Saver`` inside ``MonitoredTrainingSession`` saved graph
variables + optimizer slots + global_step to ``checkpoint_dir``, restarts
auto-restored the latest checkpoint, incremental mode warm-started batch
*i* from batch *i−1*'s directory, and ``Config.save_parameters`` exported
the tables to ``embedding.vec.json`` (reconstructed ``Config.py:~200–260``).

Shape here: one ``state.npz`` per ``step_N/`` directory holding the
params/opt-state pytree and the global step, written under a temporary
name and renamed into place, a tiny manifest for step/metadata, and the
same ``embedding.vec.json`` export format so downstream consumers of the
reference's files can switch without changes."""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.models.base import strip_padding

_STEP_DIR = re.compile(r"^step_(\d+)$")
_STATE_FILE = "state.npz"


def _flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    """Nested dict → {"a/b/c": leaf} (table names hold no '/')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _host_array(x) -> np.ndarray:
    """A host copy of ``x``; arrays sharded across processes are gathered
    first, so every process holds the whole value."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def _place(template, arr: np.ndarray):
    """Put ``arr`` where the template leaf lives (its sharding, which may
    span devices of several processes); non-array templates → default
    device."""
    if isinstance(template, jax.Array):
        return jax.make_array_from_callback(arr.shape, template.sharding,
                                            lambda idx: arr[idx])
    return jnp.asarray(arr)


class CheckpointManager:
    """Numbered ``step_N`` checkpoints under a directory, keeping the last
    ``keep`` (the reference's Saver default kept 5)."""

    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, state, extra: Optional[dict] = None):
        """Save the TrainState pytree (params + opt_state + step) and a
        JSON manifest with ``extra`` metadata (e.g. best valid accuracy).
        Every process takes part (sharded arrays are gathered); process 0
        writes."""
        path = self._path(int(step))
        tree = {"params": state.params, "opt_state": state.opt_state,
                "step": state.step}
        arrays = {k: _host_array(v) for k, v in _flatten(tree).items()}
        if jax.process_index() == 0:
            tmp = f"{path}.tmp-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, _STATE_FILE), **arrays)
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            with open(os.path.join(self.directory,
                                   f"manifest_{int(step)}.json"), "w") as f:
                json.dump({"step": int(step), **(extra or {})}, f)
            self._gc()
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices(f"ckpt_save_{int(step)}")

    def restore(self, state, step: Optional[int] = None,
                logical_rows: Optional[Dict[str, int]] = None):
        """Restore into the TrainState template; returns (state, manifest
        dict). Arrays land on the template's devices and shardings.

        A stored table whose row count differs from the template's was
        written with a different grid padding (e.g. trained on an
        8-device mesh, restored for single-device eval). Logical rows are
        always a common prefix — padding rows are scatter sinks stripped
        at use — so the stored rows are prefix-copied into the template's
        shape. ``logical_rows`` (table name → logical row count, from
        ``model.tables(cfg, n_ent, n_rel)``) guards that copy: a stored
        table that does not cover the template's logical rows is a
        *vocabulary* mismatch (e.g. a newer dataset with more entities)
        and raises instead of silently zero-filling the extra rows —
        vocabulary growth goes through :func:`warm_start_from`, which
        copies old rows and keeps the fresh init for new ones."""
        if step is None:
            step = latest_step(self.directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        tree = {"params": state.params, "opt_state": state.opt_state,
                "step": state.step}
        with np.load(os.path.join(self._path(step), _STATE_FILE)) as z:
            stored = {k: z[k] for k in z.files}

        def fit(key, tmpl):
            arr = stored[key]
            name = key.rsplit("/", 1)[-1]
            shape = tuple(np.shape(tmpl))
            if shape != arr.shape and arr.ndim:
                need = (logical_rows or {}).get(name)
                if need is not None and arr.shape[0] < need:
                    raise ValueError(
                        f"checkpoint table {name!r} holds {arr.shape[0]} "
                        f"rows but the template needs {need} logical rows "
                        f"— a vocabulary mismatch, not grid padding; use "
                        f"warm_start_from for incremental vocab growth")
                if need is None and shape[0] > arr.shape[0]:
                    print(f"[ckpt] note: extending {name} "
                          f"{arr.shape[0]} -> {shape[0]} rows (assumed "
                          f"grid-padding difference; extra rows zero)")
                out = np.zeros(shape, arr.dtype)
                n = min(shape[0], arr.shape[0])
                out[:n] = arr[:n]
                arr = out
            return _place(tmpl, arr)

        restored = {
            "params": {k: fit(f"params/{k}", v)
                       for k, v in tree["params"].items()},
            "opt_state": {s: {k: fit(f"opt_state/{s}/{k}", v)
                              for k, v in tree["opt_state"][s].items()}
                          for s in tree["opt_state"]},
            "step": fit("step", tree["step"]),
        }
        manifest_path = os.path.join(self.directory, f"manifest_{step}.json")
        manifest = {}
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
        new_state = type(state)(params=restored["params"],
                                opt_state=restored["opt_state"],
                                step=restored["step"])
        return new_state, manifest

    def _gc(self):
        steps = sorted(all_steps(self.directory))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)
            m = os.path.join(self.directory, f"manifest_{s}.json")
            if os.path.exists(m):
                os.remove(m)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_DIR.match(name)
        if m:
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def warm_start_path(out_path: str, batch_number: int) -> Optional[str]:
    """Incremental mode (SURVEY.md §5): training on dataset batch *i*
    resumes from batch *i−1*'s checkpoint dir if it has any checkpoint."""
    if batch_number is None or batch_number <= 0:
        return None
    prev = os.path.join(out_path, str(batch_number - 1))
    return prev if latest_step(prev) is not None else None


def warm_start_from(new_state, ckpt_dir: str, model, cfg: Config,
                    init_state_fn) -> Tuple[object, dict]:
    """Incremental-mode warm start: copy the previous batch's trained rows
    into a (possibly larger) fresh state.

    The reference warm-starts batch *i* from batch *i−1*'s checkpoint
    (SURVEY.md §5); between batches the vocab can grow, so only the old
    logical rows are copied — new entities/relations keep their fresh
    init. Optimizer slots and global step carry over the same way.
    Requires the old manifest to record ``n_ent``/``n_rel`` (written by
    ``cli/train.py``)."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"manifest_{step}.json")) as f:
        manifest = json.load(f)
    old_n_ent, old_n_rel = manifest["n_ent"], manifest["n_rel"]
    old_state = init_state_fn(model, cfg, old_n_ent, old_n_rel)
    mgr = CheckpointManager(ckpt_dir)
    old_state, _ = mgr.restore(old_state, step=step)

    specs = model.tables(cfg, old_n_ent, old_n_rel)

    def copy_rows(new_tree, old_tree):
        out = dict(new_tree)
        for name, spec in specs.items():
            if name in new_tree and name in old_tree:
                n = min(spec.rows, new_tree[name].shape[0])
                out[name] = new_tree[name].at[:n].set(old_tree[name][:n])
        return out

    params = copy_rows(new_state.params, old_state.params)
    opt_state = new_state.opt_state
    if opt_state and old_state.opt_state:
        opt_state = {k: copy_rows(opt_state[k], old_state.opt_state[k])
                     for k in opt_state}
    return (type(new_state)(params=params, opt_state=opt_state,
                            step=old_state.step), manifest)


def export_parameters(params: Dict[str, jax.Array], model, cfg: Config,
                      n_ent: int, n_rel: int, path: str,
                      fmt: str = "json"):
    """Export stripped tables.

    ``fmt='json'`` writes the reference's ``embedding.vec.json`` layout
    (``Config.save_parameters``: {table_name: [[row floats] …]});
    ``fmt='npz'`` writes compressed NumPy (the fast path)."""
    tables = strip_padding(params, model.tables(cfg, n_ent, n_rel))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if fmt == "json":
        with open(path, "w") as f:
            json.dump({k: np.asarray(v, np.float32).tolist()
                       for k, v in tables.items()}, f)
    elif fmt == "npz":
        np.savez_compressed(path, **{k: np.asarray(v, np.float32)
                                     for k, v in tables.items()})
    else:
        raise ValueError(f"unknown export format {fmt!r}")


def import_parameters(path: str) -> Dict[str, np.ndarray]:
    """Load an export back (either format) — table name → [rows, dim]."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    with open(path) as f:
        return {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}
