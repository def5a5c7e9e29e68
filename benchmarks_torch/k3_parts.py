#!/usr/bin/env python3
"""Diagnostic: where a half-sweep of K3's cluster body spends its time.

    python3 benchmarks_torch/k3_parts.py [--seed 0]

Needs one CUDA device and ``nvcc``.  Prints one JSON line per row:

* ``scaling``: µs per half-sweep of `sweep_fused` (counter anneal, S=200,
  the plan `dense_plan` picks) on Chimera graphs of 72, 200, 280, 440 and
  600 spins at 16 and 256 chains — the slope over N is the eqn-1 loop,
  the intercept the per-half-sweep costs that do not grow with N;
* ``bodies``: at N = 440 to 864 and 16 to 256 chains, the body
  `dense_plan` picks, the cluster body (its best cluster size, with
  `MAX_CLUSTER_WAVES` lifted) and the streamed body (W read from L2 every
  half-sweep, forced by emptying ``CLUSTER_SIZES``) — the crossover
  between the two;
* ``parts``: the same at N=440 (16 and 256 chains) for copies of
  ``csrc/sweep_fused.cu`` that each leave one part of the half-sweep out —
  the cluster barrier (a block barrier instead), the stores into the
  other CTAs' shared memory, the eqn-2 decision, the copy of the nodes
  outside the colour, the eqn-1 loop past its first step.  The copies
  compute wrong spins; they are built into a temporary directory, timed,
  and never used elsewhere.  The difference to ``base`` is what the part
  costs.

Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (cuda_ms, dense_operands, kernel_operands,  # noqa: E402
                        nvidia_smi_line, sk_codes)

S = 200
# part left out -> (text of csrc/sweep_fused.cu, its replacement)
PARTS = {
    "cluster_barrier": ("    cluster.sync();\n    float* t = cur;",
                        "    __syncthreads();\n    float* t = cur;"),
    "remote_stores": (
        "        cluster.map_shared_rank(nxt4, r)[(size_t)g * N4 + i] = o;",
        "        if (r == rank) nxt4[(size_t)g * N4 + i] = o;"),
    "decision": (
        "      const float4 o = make_float4(spin(a0, 0), spin(a1, 1), "
        "spin(a2, 2),\n                                   spin(a3, 3));",
        "      const float4 o = make_float4(a0 < 0.f ? -1.f : 1.f, "
        "a1 < 0.f ? -1.f : 1.f, a2 < 0.f ? -1.f : 1.f, "
        "a3 < 0.f ? -1.f : 1.f);"),
    "colour_copy": ("        for (int g = 0; g < G; ++g)\n          nxt4",
                    "        for (int g = 0; g < 0; ++g)\n          nxt4"),
    "eqn1_loop": ("const float4* const w_end = w4 + N4 / 4 - 1;",
                  "const float4* const w_end = w4;"),
}


def operands(graph, chains, seed):
    from repro_torch import api
    from repro_torch.core.cd import PBitMachine

    mach = PBitMachine.create(graph, seed, noise="counter", device="cuda")
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=S),
                       chains=chains)
    J, h = sk_codes(graph, np.random.default_rng(seed + 3))
    chip = ses.program(J.astype(np.int32), h.astype(np.int32))
    args, kw = kernel_operands(ses, chip, ses.generator(seed + 5),
                               n_sweeps=S)
    return dense_operands(args, chip), kw


def us_per_half(sweep_fused, args, kw) -> float:
    return cuda_ms(lambda: sweep_fused(*args, **kw), 5) * 1e3 / (2 * S)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("k3_parts: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.kernels import build
    from repro_torch.kernels import sweep_fused as sf

    build.build_all()
    graphs = {72: make_chimera(3, 3), 200: make_chimera(5, 5),
              280: make_chimera(5, 7), 440: make_chip_graph(),
              600: make_chimera(5, 15)}
    cases = {(n, b): operands(g, b, args.seed)
             for n, g in graphs.items() for b in (16, 256)}

    def plan(n, b):
        p = sf.dense_plan(n, b, 0, sf.card_limits("cuda"),
                          resident=lambda p: sf.resident_clusters(p, "cuda"))
        return {"body": p.body, "cluster_size": p.cluster_size,
                "chains_per_tile": p.chains}

    for (n, b), (a, kw) in cases.items():
        print(json.dumps({"row": "scaling", "N": n, "B": b, "S": S,
                          **plan(n, b),
                          "us_per_half": us_per_half(sf.sweep_fused, a,
                                                     kw)}), flush=True)

    graphs.update({800: make_chimera(10, 10), 864: make_chimera(12, 9)})
    sizes, waves = sf.CLUSTER_SIZES, sf.MAX_CLUSTER_WAVES
    for n, b in ((440, 256), (600, 256), (800, 256), (864, 256), (600, 64),
                 (800, 64), (864, 64), (864, 16)):
        a, kw = cases.get((n, b)) or operands(graphs[n], b, args.seed)
        row = {"row": "bodies", "N": n, "B": b, "S": S, "picked": plan(n, b)}
        for name in ("cluster", "streamed"):
            sf.CLUSTER_SIZES = sizes if name == "cluster" else ()
            sf.MAX_CLUSTER_WAVES = 10 ** 9
            try:
                row[name] = {**plan(n, b), "us_per_half": us_per_half(
                    sf.sweep_fused, a, kw)}
            finally:
                sf.CLUSTER_SIZES, sf.MAX_CLUSTER_WAVES = sizes, waves
        print(json.dumps(row), flush=True)

    src = (build.CSRC / "sweep_fused.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (old, new) in PARTS.items():
            if old not in src:
                raise AssertionError(f"{name}: csrc/sweep_fused.cu changed")
            cu = Path(tmp) / f"{name}.cu"
            cu.write_text(src.replace(old, new))
            procs[name] = subprocess.Popen(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-o", str(Path(tmp) / f"{name}.so"), str(cu)],
                stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            err = proc.communicate()[1]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}: {err[-2000:]}")
        base = sf._dense_library()
        libs = {"base": base}
        for name in PARTS:
            lib = ctypes.CDLL(str(Path(tmp) / f"{name}.so"))
            for fn in ("sweep_fused_launch", "sweep_fused_max_clusters",
                       "sweep_fused_error_string"):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
            libs[f"without_{name}"] = lib
        try:
            for name, lib in libs.items():
                sf._dense_library = lambda lib=lib: lib
                row = {"row": "parts", "variant": name}
                for b in (16, 256):
                    a, kw = cases[(440, b)]
                    row[f"N440_B{b}"] = us_per_half(sf.sweep_fused, a, kw)
                print(json.dumps(row), flush=True)
        finally:
            sf._dense_library = lambda: base
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
