#!/usr/bin/env python3
"""Diagnostic: the sweep-resident kernel's time against chains per block.

    python3 benchmarks_torch/k1_tile_sweep.py [--seed 0] [--ptxas]

Needs one CUDA device and ``nvcc``.  Times `sweep_sparse` (counter noise,
256 chains) on the 440-spin chip graph at 1000 sweeps and on the 8192- and
32768-spin lattices at 100 sweeps, for 1, 2, 4 and 8 chains per block, and
prints one JSON line.  ``--ptxas`` first compiles the kernel source once
more with ``-Xptxas -v`` into a temporary file and prints the compiler's
register / shared-memory report.  To compare two versions of the kernel,
run the script in both checkouts on the same card.
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

from chip_smoke import (B, DEVICE, cuda_ms, emit, kernel_operands,  # noqa: E402
                        nvidia_smi_line)


def ptxas_report() -> str:
    from repro_torch.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "probe.so"),
             str(build.CSRC / "sweep_sparse.cu")],
            capture_output=True, text=True, check=True)
    return proc.stderr


def tile_sweep(seed: int) -> list[dict]:
    from repro_torch import api
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.core.cd import PBitMachine
    from repro_torch.kernels.sweep_fused import sweep_sparse

    rng = np.random.default_rng(seed)
    rows = []
    for g, S in ((make_chip_graph(), 1000), (make_chimera(32, 32), 100),
                 (make_chimera(64, 64), 100)):
        mach = PBitMachine.create(g, seed, sparse=True, noise="counter",
                                  device=DEVICE)
        ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=S),
                           chains=B)
        chip = ses.program_edges(
            np.clip(np.round(rng.normal(size=g.n_edges) * 32.0), -128,
                    127).astype(np.int32), np.zeros(g.n_nodes, np.int32))
        args, kw = kernel_operands(ses, chip, ses.generator(seed), n_sweeps=S)
        args[10] = ses.default_betas[:, None].expand(S, B).contiguous()
        for block_b in (1, 2, 4, 8):
            ms = cuda_ms(lambda: sweep_sparse(*args, block_b=block_b, **kw))
            rows.append({"N": g.n_nodes, "S": S, "block_b": block_b,
                         "blocks": -(-B // block_b), "ms": ms,
                         "flips_per_ns": B * g.n_nodes * S / (ms * 1e6)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas' register / shared-memory report")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    if args.ptxas:
        print(ptxas_report(), flush=True)
    emit({"phase": "tile_sweep", "card": nvidia_smi_line(), "B": B,
          "rows": tile_sweep(args.seed)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
