#!/usr/bin/env python
"""Generate ``type_constrain.txt`` for a dataset dir (upstream OpenKE's
``n-n.py`` equivalent, SURVEY.md §2.1 "Dataset tooling").

Usage:
    python tools/gen_type_constrain.py --input data/KG [--splits all|train]
"""

# Runnable from a clean shell without installing the package.
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from openkeonspark_tpu.data.dataset import load_dataset
from openkeonspark_tpu.data.type_constrain import (build_type_constraints,
                                                   save_type_constraints)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--splits", default="all", choices=["all", "train"])
    args = p.parse_args(argv)

    ds = load_dataset(args.input)
    tc = build_type_constraints(ds, splits=args.splits)
    out = os.path.join(args.input, "type_constrain.txt")
    save_type_constraints(tc, out)
    n_h = sum(len(v) for v in tc.heads.values())
    n_t = sum(len(v) for v in tc.tails.values())
    print(f"wrote {out}: {ds.n_rel} relations, {n_h} head / {n_t} tail "
          f"constraint entries")


if __name__ == "__main__":
    main()
