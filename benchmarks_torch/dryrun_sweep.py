"""The dry run's cells of several archs, traced side by side on the host.

Runs ``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M
--force --out OUT`` for every (arch, shape, mesh) cell asked for, ``--jobs``
processes at a time, each on one thread with every GPU hidden (the dry run
traces on fake and meta tensors and never touches a card), the cells of a
kind in order: decode, train, prefill (the longest last).  A cell that
outlives ``--timeout`` is killed and recorded ``timeout``.  Prints one
JSON line a cell, its record read back from OUT: status (``ok``,
``skip``, ``fail`` with its error), rank 0's ``dot_flops``,
``replication``, the collectives by kind (calls, contributed bytes, and
the reference's ring-factored bytes by op), ``temp_bytes``, argument
bytes a device, ``fits_hbm``, the trace seconds (whole step and rank 0)
and the process's seconds; then a summary line.

    PYTHONPATH=src python benchmarks_torch/dryrun_sweep.py \\
        --archs gemma2-9b granite-moe-1b-a400m --shapes train_4k decode_32k \\
        --meshes pod --jobs 8 --out results/dryrun_sweep
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs.base import LM_SHAPES, shape_applicable
from repro_torch.configs.registry import get_config

ROOT = Path(__file__).resolve().parent.parent
# the archs whose KV heads the pod's 16-way model axis does not divide
# while it divides their query heads
GROUPED = ("jamba-v0.1-52b", "deepseek-67b", "qwen1.5-110b", "qwen2-vl-72b",
           "kimi-k2-1t-a32b", "gemma2-9b", "granite-moe-1b-a400m")
ORDER = {"decode": 0, "train": 1, "prefill": 2}


def cells(archs, shapes, meshes) -> list[tuple]:
    """(arch, shape, mesh) of every cell, applicable or not (the dry run
    records a ``skip``), decode cells first and prefill cells last."""
    out = [(a, s, m) for a in archs for s in shapes for m in meshes]
    return sorted(out, key=lambda c: (ORDER[LM_SHAPES[c[1]].kind],
                                      c[2] != "pod"))


def summary(arch: str, shape: str, mesh: str, out: Path) -> dict:
    """A cell's record as the dry run wrote it, cut to what a sweep
    compares."""
    path = out / f"{arch}__{shape}__{mesh}.json"
    rec = json.loads(path.read_text()) if path.exists() else {}
    mem, coll = rec.get("memory") or {}, rec.get("collectives") or {}
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "status": rec.get("status"), "error": rec.get("error"),
            "reason": rec.get("reason"),
            "dot_flops": rec.get("dot_flops"),
            "flops_global": rec.get("flops_global"),
            "replication": rec.get("replication"),
            "calls": coll.get("calls"),
            "contributed_bytes": coll.get("contributed_bytes"),
            "per_op_bytes": coll.get("per_op_bytes"),
            "collective_bytes": coll.get("total_bytes"),
            "temp_bytes": mem.get("temp_bytes"),
            "argument_bytes": mem.get("argument_bytes"),
            "output_bytes": mem.get("output_bytes"),
            "fits_hbm": rec.get("fits_hbm"),
            "trace_s": rec.get("trace_s"),
            "rank_trace_s": rec.get("rank_trace_s")}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python benchmarks_torch/dryrun_sweep.py")
    ap.add_argument("--archs", nargs="+", default=list(GROUPED))
    ap.add_argument("--shapes", nargs="+", default=list(LM_SHAPES),
                    choices=list(LM_SHAPES))
    ap.add_argument("--meshes", nargs="+", default=["pod"],
                    choices=["pod", "multipod"])
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds a cell's process may run")
    ap.add_argument("--out", default="results/dryrun_sweep")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    todo = cells(args.archs, args.shapes, args.meshes)
    running: dict = {}
    rows = []

    def finish(cell, t0, proc, timed_out=False):
        row = summary(*cell, out)
        if timed_out:
            row["status"] = "timeout"
        row["seconds"] = time.perf_counter() - t0
        row["returncode"] = proc.returncode
        rows.append(row)
        print(json.dumps(row), flush=True)

    t_all = time.perf_counter()
    while todo or running:
        while todo and len(running) < args.jobs:
            cell = todo.pop(0)
            ok, _ = shape_applicable(get_config(cell[0]), LM_SHAPES[cell[1]])
            if not ok:
                rows.append(summary(*cell, out) | {"status": "skip"})
                continue
            running[cell] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
                 "--force", "--out", str(out)], cwd=ROOT, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        time.sleep(0.5)
        for cell, (t0, proc) in list(running.items()):
            late = (proc.poll() is None
                    and time.perf_counter() - t0 > args.timeout)
            if proc.poll() is None and not late:
                continue
            if late:
                proc.kill()
                proc.wait()
            del running[cell]
            finish(cell, t0, proc, timed_out=late)
    counts: dict = {}
    for r in rows:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    print(json.dumps({"cells": len(rows), "by_status": counts,
                      "seconds": time.perf_counter() - t_all}), flush=True)
    return rows


if __name__ == "__main__":
    main()
