#!/usr/bin/env python3
"""A/B of the dense resident kernel K3 between two checkouts on one card.

    python3 benchmarks_torch/k3_ab.py --trees A B [--order ABBA] [--seed 0]

Needs one CUDA device and ``nvcc``.  Each tree is a checkout of this
repository (its ``src/`` and kernel sources); every run starts a fresh
interpreter that imports that tree's port, builds its kernels into the
tree's own ``build/`` and measures, at the shapes of ``chip_smoke.py``:

* K3 on the 440-spin chip, 256 chains, S=1000 (counter anneal, no
  moments): one call (CUDA events, median of 3) and the K3 kernels' device
  time (`torch.profiler`);
* the training path's CD phase (the first positive phase of full-adder CD,
  S=10, 8 measured sweeps, clamped): call and device time, and
  ``torch.matmul(m.T, m)`` once per measured sweep as a yardstick;
* the workloads' tempering launch (16 replicas, S=10): call and device;
* ms per ``fused`` CD epoch (host clock, 5 epochs and one evaluation, / 5);
* in a tree whose plan has cluster sizes (``CLUSTER_SIZES``): the N=440
  call again with clusters of 4 and of 8 CTAs, forced by narrowing
  ``CLUSTER_SIZES`` to one size for the call.

Runs go in the order given (``ABBA``: A, B, B, A), one JSON line each,
then the card's name and power limit.  Compare two trees only inside one
call of this script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K3_KERNELS = ("sweep_fused_kernel", "reduce_partials", "k3_")


def device_ms(fn, repeats: int = 5):
    """Device time per call of ``fn`` summed over the kernels whose names
    hold one of `K3_KERNELS` (the K3 launch of either tree)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0)
                for e in prof.key_averages()
                if any(k in e.key for k in K3_KERNELS))
    return total / repeats / 1e3 if total > 0 else None


def measure(seed: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import (B, DEVICE, cuda_ms, dense_operands,
                            kernel_operands, sk_codes)
    from repro_torch import api
    from repro_torch.core import tasks
    from repro_torch.core.annealing import sk_instance
    from repro_torch.core.cd import CDConfig, PBitMachine, train_cd
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.core.hardware import HardwareConfig
    from repro_torch.core.tempering import PTConfig, parallel_tempering
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import sweep_fused as sf
    from repro_torch.kernels.sweep_fused import sweep_fused

    t0 = time.perf_counter()
    build.build_all()
    out = {"src": str(Path(build.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t0}

    # K3 at N=440, B=256, S=1000
    g = make_chip_graph()
    S = 1000
    mach = PBitMachine.create(g, seed, noise="counter", device=DEVICE)
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=S), chains=B)
    J, h = sk_codes(g, np.random.default_rng(seed + 200))
    chip = ses.program(J.astype(np.int32), h.astype(np.int32))
    args, kw = kernel_operands(ses, chip, ses.generator(seed + 3),
                               n_sweeps=S)
    args = dense_operands(args, chip)
    args[9] = ses.default_betas[:, None].expand(S, B).contiguous()
    anneal = lambda: sweep_fused(*args, **kw)  # noqa: E731
    out["N440_S1000"] = {"ms": cuda_ms(anneal), "device_ms": device_ms(
        anneal, 3)}
    sizes = getattr(sf, "CLUSTER_SIZES", None)
    if sizes is not None:
        for k in (4, 8):
            sf.CLUSTER_SIZES = (k,)
            try:
                out[f"N440_S1000_k{k}"] = {"ms": cuda_ms(anneal),
                                           "device_ms": device_ms(anneal, 3)}
            finally:
                sf.CLUSTER_SIZES = sizes

    # the launches of a fused CD epoch and of tempering, recorded
    calls = []

    def record(*a, **k):
        calls.append((a, k))
        return sweep_fused(*a, **k)

    task = tasks.full_adder_task(g)
    cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B,
                   epochs=5)
    cd = PBitMachine.create(g, seed, noise="counter", backend="fused",
                            device=DEVICE)
    ops.sweep_fused = record
    try:
        train_cd(cd, task.visible_idx, task.target_dist,
                 dataclasses.replace(cfg, epochs=1), seed + 1,
                 eval_every=1)
        cd_args, cd_kw = next(c for c in calls if c[1].get("accumulate"))
        calls.clear()
        J2, h2 = sk_instance(g, seed + 1)
        parallel_tempering(
            PBitMachine.create(g, seed, HardwareConfig(), beta=1.0,
                               w_scale=0.02, noise="counter",
                               backend="fused", device=DEVICE),
            J2, h2, PTConfig(n_replicas=16, n_sweeps=20, swap_every=10),
            seed + 2)
        pt_args, pt_kw = calls[0]
    finally:
        ops.sweep_fused = sweep_fused
    phase = lambda: sweep_fused(*cd_args, **cd_kw)  # noqa: E731
    meas = int((cd_kw["measured"] != 0).sum())
    m = cd_args[0]
    out["cd_phase"] = {
        "S": cd_args[9].shape[0], "measured_sweeps": meas,
        "ms": cuda_ms(phase), "device_ms": device_ms(phase),
        "gram_matmul_ms": cuda_ms(
            lambda: [torch.matmul(m.T, m) for _ in range(meas)])}
    temper = lambda: sweep_fused(*pt_args, **pt_kw)  # noqa: E731
    out["tempering"] = {"B": pt_args[0].shape[0], "S": pt_args[9].shape[0],
                        "ms": cuda_ms(temper), "device_ms": device_ms(temper)}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_cd(cd, task.visible_idx, task.target_dist, cfg, seed + 1,
             eval_every=cfg.epochs)
    torch.cuda.synchronize()
    out["fused_cd_epoch_ms"] = (time.perf_counter() - t0) / cfg.epochs * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", help=argparse.SUPPRESS)   # a child run's tree
    args = ap.parse_args()

    if args.one is not None:
        import torch
        if not torch.cuda.is_available():
            print("k3_ab: no CUDA device", file=sys.stderr)
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
            [sys.executable, str(Path(__file__).resolve()), "--one",
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


if __name__ == "__main__":
    sys.exit(main())
