"""The A/B runner the ``*_ab.py`` scripts share: one card, two checkouts.

``main(measure, script, doc)`` parses ``--trees A B [--order ABBA]
[--seed 0]`` and runs ``script`` once per letter of the order, each time in
a fresh interpreter whose ``PYTHONPATH`` is that tree's ``src/`` and whose
kernels build into that tree's ``build/`` (``REPRO_TORCH_BUILD_DIR``).  The
child (``--one TREE``) prints ``measure(seed)`` as one JSON line; the
parent prints it again with the run's letter and tree, and at the end the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path


def main(measure, script: str, doc: str) -> int:
    name = Path(script).stem
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", help=argparse.SUPPRESS)   # a child run's tree
    args = ap.parse_args()

    if args.one is not None:
        import torch
        if not torch.cuda.is_available():
            print(f"{name}: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(measure(args.seed)), flush=True)
        return 0

    if not args.trees:
        ap.error("--trees A B is required")
    trees = {"A": Path(args.trees[0]).resolve(),
             "B": Path(args.trees[1]).resolve()}
    for label in args.order:
        tree = trees[label]
        env = dict(os.environ, PYTHONPATH=str(tree / "src"),
                   REPRO_TORCH_BUILD_DIR=str(tree / "build"))
        proc = subprocess.run(
            [sys.executable, str(Path(script).resolve()), "--one",
             str(tree), "--seed", str(args.seed)],
            env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, "tree": str(tree), **row}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0
