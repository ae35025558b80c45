#!/usr/bin/env python
"""Split a dataset dir into numbered incremental batch folders ``0..n-1``.

Reference parity (SURVEY.md §2.1 "Dataset tooling", L0 layout): the
reference's incremental mode expects ``<root>/0/ 1/ 2/ …`` where each
folder is a *growing snapshot* — batch i's train2id.txt contains all
triples of batches 0..i; valid/test grow the same way. Training on batch i
warm-starts from batch i−1's checkpoint.

Usage:
    python tools/split_incremental.py --input data/KG --output data/KG_inc \
        --num_batches 4 [--seed 0]
"""

# Runnable from a clean shell without installing the package.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openkeonspark_tpu.data.dataset import Dataset, load_dataset, save_dataset


def split_incremental(ds: Dataset, n_batches: int, seed: int = 0):
    """Yield (batch_number, cumulative Dataset)."""
    rng = np.random.default_rng(seed)

    def increments(arr):
        if arr is None or len(arr) == 0:
            return [np.empty((0, 3), np.int32)] * n_batches
        perm = rng.permutation(len(arr))
        return [arr[np.sort(chunk)] for chunk in
                np.array_split(perm, n_batches)]

    tr = increments(ds.train)
    va = increments(ds.valid)
    te = increments(ds.test)
    for i in range(n_batches):
        yield i, Dataset(
            n_ent=ds.n_ent, n_rel=ds.n_rel,
            train=np.concatenate(tr[:i + 1]),
            valid=np.concatenate(va[:i + 1]) if ds.valid is not None else None,
            test=np.concatenate(te[:i + 1]) if ds.test is not None else None,
            ent_names=ds.ent_names, rel_names=ds.rel_names,
        )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--num_batches", type=int, required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    ds = load_dataset(args.input, load_names=True)
    for i, snap in split_incremental(ds, args.num_batches, args.seed):
        out = os.path.join(args.output, str(i))
        save_dataset(snap, out)
        print(f"batch {i}: {snap.n_train} train / {snap.n_valid} valid / "
              f"{snap.n_test} test -> {out}")


if __name__ == "__main__":
    main()
