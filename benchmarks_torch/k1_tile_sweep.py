#!/usr/bin/env python3
"""Diagnostic: the sweep-resident kernel K1 against its body and chains per
block.

    python3 benchmarks_torch/k1_tile_sweep.py [--seed 0] [--ptxas]

Needs one CUDA device and ``nvcc``.  Times `sweep_sparse` (256 chains
unless named) and prints one JSON line of rows, each with the plan it ran
under (`sparse_plan`: body, chains per block, threads), the call (CUDA
events, median of 3) and the kernel's device time (`torch.profiler`):

* ``tile`` rows: the 8192- and 32768-spin lattices at 100 sweeps (strided
  body) for 1, 2, 4 and 8 chains per block;
* ``bodies`` rows: the 440-spin chip graph at 1000 sweeps, counter and
  LFSR noise, through the resident body at every chains per block its plan
  can take and through the strided body at 1, 2, 4 and 8; 16 chains (one
  block a chain); and a 1024-spin Chimera graph (the resident body's
  largest N) at 200 sweeps through both bodies.  The strided body is
  forced by setting ``MAX_RESIDENT_N`` to 0 for the call.

``--ptxas`` first compiles the kernel source once more with ``-Xptxas -v``
into a temporary file and prints the compiler's register / spill report.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (B, DEVICE, K1_KERNELS, cuda_ms,  # noqa: E402
                        device_kernel_ms, emit, kernel_operands,
                        nvidia_smi_line, sparse_plan_of)


def ptxas_report() -> str:
    from repro_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "probe.so"),
             str(build.CSRC / "sweep_sparse.cu")],
            capture_output=True, text=True, check=True)
    return proc.stderr


def operands(graph, S, chains, noise, seed, rng):
    from repro_torch import api
    from repro_torch.core.cd import PBitMachine

    mach = PBitMachine.create(graph, seed, sparse=True, noise=noise,
                              device=DEVICE)
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=S),
                       chains=chains)
    chip = ses.program_edges(
        np.clip(np.round(rng.normal(size=graph.n_edges) * 32.0), -128,
                127).astype(np.int32), np.zeros(graph.n_nodes, np.int32))
    args, kw = kernel_operands(ses, chip, ses.generator(seed), n_sweeps=S)
    args[10] = ses.default_betas[:, None].expand(S, chains).contiguous()
    return args, kw


def timed_row(args, kw, **what) -> dict:
    from repro_torch.kernels.sweep_fused import sweep_sparse

    plan = sparse_plan_of(args, kw)
    run = lambda: sweep_sparse(*args, **kw)  # noqa: E731
    ms = cuda_ms(run)
    m = args[0]
    Bc, N, S = m.shape[0], m.shape[1], args[10].shape[0]
    return {**what, "N": N, "B": Bc, "S": S, "body": plan.body,
            "tb": plan.chains, "threads": plan.threads, "ms": ms,
            "device_ms": device_kernel_ms(run, K1_KERNELS, 3),
            "flips_per_ns": Bc * N * S / (ms * 1e6)}


def tile_rows(seed: int) -> list[dict]:
    from repro_torch.core.chimera import make_chimera

    rng = np.random.default_rng(seed)
    rows = []
    for g in (make_chimera(32, 32), make_chimera(64, 64)):
        args, kw = operands(g, 100, B, "counter", seed, rng)
        for block_b in (1, 2, 4, 8):
            rows.append(timed_row(args, dict(kw, block_b=block_b),
                                  kind="tile", noise="counter"))
    return rows


def body_rows(seed: int) -> list[dict]:
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.kernels import sweep_fused as sf

    rng = np.random.default_rng(seed + 1)
    limit = sf.MAX_RESIDENT_N
    rows = []

    def row(args, kw, strided=False, **what):
        sf.MAX_RESIDENT_N = 0 if strided else limit
        try:
            rows.append(timed_row(args, kw, kind="bodies", **what))
        finally:
            sf.MAX_RESIDENT_N = limit

    chip = make_chip_graph()
    tb_max = min(sf.MAX_RESIDENT_CHAINS,
                 sf.MAX_RESIDENT_THREADS // sf.resident_lanes(chip.n_nodes))
    for noise in ("counter", "lfsr"):
        args, kw = operands(chip, 1000, B, noise, seed, rng)
        for tb in range(1, tb_max + 1):
            row(args, dict(kw, block_b=tb), noise=noise)
        for tb in (1, 2, 4, 8):
            row(args, dict(kw, block_b=tb), strided=True, noise=noise)
    args, kw = operands(chip, 1000, 16, "counter", seed, rng)
    row(args, kw, noise="counter")
    row(args, kw, strided=True, noise="counter")
    big = make_chimera(8, 16)            # 1024 spins, degree 6
    args, kw = operands(big, 200, B, "counter", seed, rng)
    row(args, kw, noise="counter")
    row(args, kw, strided=True, noise="counter")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas' register / spill report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    if args.ptxas:
        print(ptxas_report(), flush=True)
    emit({"phase": "tile_sweep", "card": nvidia_smi_line(), "B": B,
          "rows": body_rows(args.seed) + tile_rows(args.seed)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
