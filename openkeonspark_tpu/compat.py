"""Reference-style API facade.

The reference's user surface is an imperative ``Config`` object
(``Config.py:~1–760`` reconstructed per SURVEY.md §2.1):

    con = Config()
    con.set_in_path("./benchmarks/FB15K/")
    con.set_work_threads(4); con.set_train_times(500); con.set_nbatches(100)
    con.set_alpha(0.001); con.set_margin(1.0); con.set_bern(1)
    con.set_dimension(100); con.set_ent_neg_rate(1); con.set_rel_neg_rate(0)
    con.set_opt_method("SGD")
    con.init()
    con.set_model(TransE)
    con.run()
    con.test()
    con.predict_tail_entity(h, r, k)
    con.save_parameters("embedding.vec.json")

This module reproduces that surface 1:1 on top of this JAX stack so
reference scripts port by changing one import. New code should prefer the
functional API (``openkeonspark_tpu.config.Config`` + ``train.loop.train``
+ ``eval.*``); this facade exists for drop-in migration parity.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from openkeonspark_tpu.config import Config as _Cfg

# model markers so reference code can keep `con.set_model(TransE)`
TransE, TransH, TransR, TransD = "transe", "transh", "transr", "transd"
DistMult, ComplEx = "distmult", "complex"
_MODEL_NAMES = {"transe", "transh", "transr", "transd", "distmult",
                "complex"}


class Config:
    """Imperative facade with the reference ``Config``'s method surface."""

    def __init__(self):
        self._kw: Dict = {}
        self._ds = None
        self._index = None
        self._eval_index = None
        self._state = None
        self._result = None
        self._thresholds = None
        self._import_path: Optional[str] = None
        self._export_path: Optional[str] = None
        self._export_steps: int = 0

    # --- reference setters (Config.py set_* family) --------------------

    def set_in_path(self, path: str):
        self._kw["in_path"] = path

    def set_out_path(self, path: str):
        self._kw["out_path"] = path

    # reference: set_import_files / set_export_files point at checkpoints.
    # set_import_files arms a restore: set_model() loads the latest
    # checkpoint from this directory (the reference's test-only workflow —
    # set_import_files → init → set_model → test/predict_* — evaluates the
    # TRAINED tables, never a fresh init).
    def set_import_files(self, path: str):
        self._kw["out_path"] = path
        self._import_path = path

    def set_export_files(self, path: str, steps: int = 0):
        """Reference semantics: periodic model export every ``steps``
        epochs during ``run()`` (``export_steps``), plus the final export
        location; ``steps=0`` exports only at the end (r3 advisor: the
        ``steps`` argument used to be ignored)."""
        self._kw["out_path"] = path
        self._export_path = path
        self._export_steps = int(steps)

    def set_export_steps(self, steps: int):
        """Reference alias for the periodic-export interval."""
        self._export_steps = int(steps)

    def set_log_on(self, flag: int):
        """Reference: per-epoch loss printing on/off (log_every 1/0)."""
        self._kw["log_every"] = 1 if flag else 0

    def set_work_threads(self, n: int):
        self._kw["work_threads"] = int(n)

    def set_train_times(self, n: int):
        self._kw["train_times"] = int(n)

    def set_nbatches(self, n: int):
        self._kw["nbatches"] = int(n)

    def set_alpha(self, a: float):
        self._kw["alpha"] = float(a)

    def set_margin(self, m: float):
        self._kw["margin"] = float(m)

    def set_bern(self, flag: int):
        self._kw["bern"] = bool(flag)

    def set_dimension(self, d: int):
        self._kw["hidden_size"] = int(d)

    def set_ent_dimension(self, d: int):
        self._kw["ent_size"] = int(d)

    def set_rel_dimension(self, d: int):
        self._kw["rel_size"] = int(d)

    # reference names the negative rates this way
    def set_ent_neg_rate(self, n: int):
        self._kw["negative_ent"] = int(n)

    def set_rel_neg_rate(self, n: int):
        self._kw["negative_rel"] = int(n)

    # aliases used in some reference forks
    set_negative_ent = set_ent_neg_rate
    set_negative_rel = set_rel_neg_rate

    def set_opt_method(self, m: str):
        self._kw["opt_method"] = m.lower()

    def set_test_link_prediction(self, flag: bool):
        self._kw["test_link_prediction"] = bool(flag)

    def set_test_triple_classification(self, flag: bool):
        self._kw["test_triple_classification"] = bool(flag)

    def set_valid_steps(self, n: int):
        self._kw["valid_every"] = int(n)

    def set_early_stopping_patience(self, n: int):
        self._kw["early_stop_patience"] = int(n)

    def set_seed(self, n: int):
        self._kw["seed"] = int(n)

    def set_p_norm(self, p: int):
        self._kw["p_norm"] = int(p)

    # --- lifecycle ------------------------------------------------------

    @property
    def cfg(self) -> _Cfg:
        return _Cfg(**self._kw)

    def init(self):
        """Load the dataset + build indexes (reference: ctypes
        ``importTrainFiles`` via ``lib.setInPath``/``init``)."""
        from openkeonspark_tpu.data.dataset import load_dataset
        from openkeonspark_tpu.data.index import build_kg_index
        path = self._kw.get("in_path", "")
        bn = self._kw.get("batch_number")
        if bn is not None:
            import os
            path = os.path.join(path, str(bn))
        self._ds = load_dataset(path)
        self._index = build_kg_index(self._ds, for_eval=False)
        return self

    def set_model(self, model: Union[str, type]):
        """Accepts the model name, this module's markers (``TransE`` …), or
        a class whose lowercase name matches (reference passes the class)."""
        name = model if isinstance(model, str) else model.__name__.lower()
        if name not in _MODEL_NAMES:
            raise ValueError(f"unknown model {model!r}")
        self._kw["model"] = name
        from openkeonspark_tpu.models.base import get_model
        from openkeonspark_tpu.train.step import init_state
        import jax
        cfg = self.cfg
        self._state = init_state(get_model(name), cfg, self._ds.n_ent,
                                 self._ds.n_rel, jax.random.key(cfg.seed))
        if self._import_path is not None:
            # reference semantics: an armed import path MUST restore — a
            # silent fall-through would evaluate random embeddings
            from openkeonspark_tpu.ckpt.checkpoint import (CheckpointManager,
                                                           latest_step)
            if latest_step(self._import_path) is None:
                raise FileNotFoundError(
                    f"set_import_files({self._import_path!r}): no "
                    f"step_N checkpoint found there")
            mgr = CheckpointManager(self._import_path)
            self._state, _ = mgr.restore(self._state)
        return self

    def _require(self, what: str):
        if self._ds is None:
            raise RuntimeError(f"call init() before {what}")
        if self._state is None:
            raise RuntimeError(f"call set_model(...) before {what}")

    def run(self, echo=print):
        """Train (reference ``Config.run``): epochs × nbatches with optional
        validation early stopping; checkpoints to out_path if set."""
        self._require("run()")
        from openkeonspark_tpu.train.loop import train
        cfg = self.cfg
        cb = None
        if self._export_path and self._export_steps > 0:
            # reference export_steps: periodic vec.json export during
            # training (Config.py train loop's export hook)
            import os
            from openkeonspark_tpu.ckpt.checkpoint import export_parameters
            from openkeonspark_tpu.models.base import get_model
            model = get_model(cfg.model)
            dest = os.path.join(self._export_path, "embedding.vec.json") \
                if not self._export_path.endswith(".json") \
                else self._export_path

            def cb(epoch, state):
                if (epoch + 1) % self._export_steps == 0:
                    export_parameters(state.params, model, cfg,
                                      self._ds.n_ent, self._ds.n_rel,
                                      dest, fmt="json")
        self._result = train(cfg, self._ds, index=self._index,
                             state=self._state,
                             checkpoint_dir=cfg.out_path or None,
                             epoch_callback=cb, echo=echo)
        self._state = self._result.state
        return self._result

    # --- evaluation (reference Config.test / show_* family) -------------

    def _eval_idx(self):
        if self._eval_index is None:
            from openkeonspark_tpu.data.index import build_kg_index
            self._eval_index = build_kg_index(self._ds, for_eval=True)
        return self._eval_index

    def test(self, echo=print):
        """Reference ``Config.test``: link prediction (and triple
        classification when enabled) on the test split, printed in the
        reference's table format."""
        self._require("test()")
        cfg = self.cfg
        out = {}
        if cfg.test_link_prediction or not cfg.test_triple_classification:
            from openkeonspark_tpu.eval.link_prediction import link_prediction
            res = link_prediction(self._state.params, cfg, self._ds,
                                  self._eval_idx())
            echo(res.format_table())
            out["link_prediction"] = res
        if cfg.test_triple_classification:
            from openkeonspark_tpu.eval.classification import (
                triple_classification)
            metrics = triple_classification(self._state.params, cfg,
                                            self._ds, self._eval_idx())
            echo(f"triple classification: {metrics}")
            out["triple_classification"] = metrics
        return out

    show_link_prediction = test

    def show_triple_classification(self, echo=print):
        self._require("show_triple_classification()")
        from openkeonspark_tpu.eval.classification import (
            triple_classification)
        metrics = triple_classification(self._state.params, self.cfg,
                                        self._ds, self._eval_idx())
        echo(f"triple classification: {metrics}")
        return metrics

    # --- ad-hoc prediction (reference predict_* family) -----------------

    def predict_tail_entity(self, h: int, r: int, k: int = 10):
        self._require("predict_tail_entity()")
        from openkeonspark_tpu.eval.predict import predict_tail_entity
        ids, _ = predict_tail_entity(self._state.params, self.cfg,
                                     self._ds.n_ent, self._ds.n_rel, h, r, k)
        return ids

    def predict_head_entity(self, t: int, r: int, k: int = 10):
        self._require("predict_head_entity()")
        from openkeonspark_tpu.eval.predict import predict_head_entity
        ids, _ = predict_head_entity(self._state.params, self.cfg,
                                     self._ds.n_ent, self._ds.n_rel, t, r, k)
        return ids

    def predict_relation(self, h: int, t: int, k: int = 10):
        self._require("predict_relation()")
        from openkeonspark_tpu.eval.predict import predict_relation
        ids, _ = predict_relation(self._state.params, self.cfg,
                                  self._ds.n_ent, self._ds.n_rel, h, t, k)
        return ids

    def predict_triple(self, h: int, t: int, r: int,
                       thresh: Optional[float] = None):
        self._require("predict_triple()")
        from openkeonspark_tpu.eval.predict import predict_triple
        if thresh is None and self._thresholds is None:
            from openkeonspark_tpu.eval.classification import fit_thresholds
            self._thresholds, _ = fit_thresholds(self._state.params,
                                                 self.cfg, self._ds,
                                                 self._eval_idx())
        return predict_triple(self._state.params, self.cfg, h, t, r,
                              thresholds=self._thresholds, threshold=thresh)

    # --- parameter export (reference get_parameters/save_parameters) ----

    def get_parameters(self) -> Dict[str, np.ndarray]:
        self._require("get_parameters()")
        from openkeonspark_tpu.models.base import get_model, strip_padding
        cfg = self.cfg
        model = get_model(cfg.model)
        return strip_padding(self._state.params,
                             model.tables(cfg, self._ds.n_ent,
                                          self._ds.n_rel))

    def save_parameters(self, path: str = "embedding.vec.json"):
        self._require("save_parameters()")
        from openkeonspark_tpu.ckpt.checkpoint import export_parameters
        from openkeonspark_tpu.models.base import get_model
        cfg = self.cfg
        export_parameters(self._state.params, get_model(cfg.model), cfg,
                          self._ds.n_ent, self._ds.n_rel, path, fmt="json")
