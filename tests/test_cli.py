"""CLI end-to-end: argparse parity, single-device and mesh runs through
``cli.train.run``, evaluate from checkpoint."""

import json
import os

import numpy as np
import pytest

from openkeonspark_tpu.cli.args import build_parser, config_from_args
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.synth import random_kg


def make_args(tmp_path, *extra):
    ds = random_kg(n_ent=100, n_rel=5, n_triples=900, n_valid=50, n_test=40,
                   seed=4)
    save_dataset(ds, str(tmp_path / "kg"))
    argv = ["--input", str(tmp_path / "kg"), "--output",
            str(tmp_path / "out"), "--model", "transe", "--hidden_size",
            "16", "--alpha", "0.05", "--train_times", "2", "--nbatches",
            "8", "--negative_ent", "2", "--eval_chunk", "8",
            "--eval_block", "32", *extra]
    args = build_parser("t").parse_args(argv)
    cfg = config_from_args(args)
    object.__setattr__(cfg, "export_format", args.export_format)
    return ds, cfg


def test_config_from_args_reference_flags(tmp_path):
    _, cfg = make_args(tmp_path, "--bern", "0", "--opt_method", "adam",
                       "--margin", "4.5", "--work_threads", "7",
                       "--sampler", "host")
    assert not cfg.bern and cfg.opt_method == "adam"
    assert cfg.margin == 4.5 and cfg.work_threads == 7
    assert cfg.sampler == "host"


def test_cli_train_run_single(tmp_path):
    from openkeonspark_tpu.cli.train import run
    ds, cfg = make_args(tmp_path, "--test_link_prediction",
                        "--test_triple_classification", "--valid_every", "1")
    out = run(cfg, echo=lambda *_: None)
    assert "link_prediction" in out and "triple_classification" in out
    assert os.path.exists(str(tmp_path / "out" / "embedding.vec.json"))
    with open(str(tmp_path / "out" / "embedding.vec.json")) as f:
        exp = json.load(f)
    assert np.asarray(exp["ent_embeddings"]).shape == (ds.n_ent, 16)


def test_cli_train_run_mesh(tmp_path):
    from openkeonspark_tpu.cli.train import run
    _, cfg = make_args(tmp_path, "--mesh_data", "4", "--mesh_model", "2",
                       "--test_link_prediction")
    out = run(cfg, echo=lambda *_: None)
    assert out["steps"] == 16
    assert 0.0 <= out["link_prediction"]["filtered_mrr"] <= 1.0


def test_cli_evaluate_from_checkpoint(tmp_path, capsys):
    from openkeonspark_tpu.cli.evaluate import main as eval_main
    from openkeonspark_tpu.cli.train import run
    _, cfg = make_args(tmp_path)
    run(cfg, echo=lambda *_: None)
    eval_main(["--input", str(tmp_path / "kg"), "--checkpoint",
               str(tmp_path / "out"), "--model", "transe", "--hidden_size",
               "16", "--eval_chunk", "8", "--eval_block", "32",
               "--link_prediction", "--predict_tail", "3,1", "--topk", "4"])
    out = capsys.readouterr().out
    assert "restored step" in out
    assert "averaged(filter)" in out
    assert "top-4 tails" in out


def test_cli_auto_resume_matches_uninterrupted(tmp_path):
    """Crash recovery (reference: MonitoredTrainingSession restores the
    latest checkpoint in checkpoint_dir): a run interrupted after 2 epochs
    and re-launched with the same flags must end EXACTLY where the
    uninterrupted run ends — same step, same exported embeddings."""
    import json
    import numpy as np
    from openkeonspark_tpu.cli.train import run
    from openkeonspark_tpu.config import Config
    from openkeonspark_tpu.data.dataset import save_dataset
    from openkeonspark_tpu.data.synth import random_kg

    kg_dir = str(tmp_path / "kg")
    save_dataset(random_kg(n_ent=70, n_rel=4, n_triples=700, n_valid=30,
                           n_test=30, seed=6), kg_dir)
    base = dict(model="transe", hidden_size=8, alpha=0.05, margin=1.0,
                negative_ent=1, nbatches=5, steps_per_scan=5,
                in_path=kg_dir, log_every=100)

    full = Config(**base, train_times=4, out_path=str(tmp_path / "full"))
    run(full, echo=lambda *_: None)

    # "crash" after 2 epochs, then re-launch with the original flags
    part = Config(**base, train_times=2, out_path=str(tmp_path / "re"))
    run(part, echo=lambda *_: None)
    msgs = []
    again = Config(**base, train_times=4, out_path=str(tmp_path / "re"))
    out = run(again, echo=msgs.append)
    assert any("resumed from" in str(m) for m in msgs), msgs[:3]
    assert out["steps"] == 4 * 5

    a = json.load(open(tmp_path / "full" / "embedding.vec.json"))
    b = json.load(open(tmp_path / "re" / "embedding.vec.json"))
    for k in a:
        np.testing.assert_array_equal(np.array(a[k]), np.array(b[k]),
                                      err_msg=k)


def test_cli_incremental_batches_on_mesh(tmp_path):
    """Incremental batch-folder training chained through MESH runs: batch 0
    trains on an 8-device exchange grid, batch 1 warm-starts from batch
    0's checkpoint (vocab growth handled) and keeps training sharded —
    the reference's incremental mode composed with the sharded
    distribution layer."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from split_incremental import split_incremental
    from openkeonspark_tpu.cli.args import build_parser, config_from_args
    from openkeonspark_tpu.cli.train import run

    ds = random_kg(n_ent=120, n_rel=5, n_triples=1200, n_valid=40,
                   n_test=40, seed=8)
    for i, snap in split_incremental(ds, 2, seed=3):
        save_dataset(snap, str(tmp_path / "kg" / str(i)))

    outs = {}
    for bn in (0, 1):
        argv = ["--input", str(tmp_path / "kg"), "--output",
                str(tmp_path / "out"), "--batch_number", str(bn),
                "--model", "transe", "--hidden_size", "16",
                "--alpha", "0.05", "--train_times", "2", "--nbatches", "6",
                "--negative_ent", "1", "--mesh_data", "4",
                "--mesh_model", "2", "--eval_chunk", "8",
                "--eval_block", "32"]
        args = build_parser("t").parse_args(argv)
        cfg = config_from_args(args)
        object.__setattr__(cfg, "export_format", args.export_format)
        msgs = []
        outs[bn] = run(cfg, echo=msgs.append)
        if bn == 1:
            assert any("warm start" in str(m) for m in msgs), msgs
        assert any("step=exchange" in str(m) for m in msgs), msgs
    # batch 1 continued the global step counter across the chain
    assert outs[1]["steps"] > outs[0]["steps"]
