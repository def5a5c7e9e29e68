#!/usr/bin/env python3
"""Diagnostic: where a half-sweep of K1's resident body spends its time.

    python3 benchmarks_torch/k1_parts.py [--seed 0] [--sass]

Needs one CUDA device and ``nvcc``.  Prints one JSON line per variant: µs
of device time (`torch.profiler`) per half-sweep of `sweep_sparse` on the
440-spin chip graph (S=1000; 16 chains, one an SM, and 256, two an SM;
counter noise and LFSR noise) for copies of ``csrc/sweep_sparse.cu`` that
each leave one part of the resident half-sweep out — the chain's barrier,
the spin gather of eqn 1 (the weights are summed instead), tanhf, the
counter hash, the draw of the next half-sweep's noise, the spin's store.
The copies compute wrong spins; they are built into a temporary directory,
timed, and never used elsewhere.  The difference to ``base`` is what the
part costs (parts overlap, so the differences need not add up).  ``--sass`` first prints the instruction
mix of the resident kernel's SASS (``cuobjdump``): counts of shared,
generic and global loads and stores and of barriers.  Then the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (device_kernel_ms, kernel_operands,  # noqa: E402
                        nvidia_smi_line)

S = 1000
# part left out -> (text of csrc/sweep_sparse.cu, its replacement)
PARTS = {
    "chain_barrier": (
        'asm volatile("bar.sync %0, %1;" ::"r"(lb + 1), "r"(P) : "memory");',
        "(void)lb; (void)P;"),
    "gather": ("acc = __fadd_rn(acc, __fmul_rn(t.w[d], sp[t.idx[d]]));",
               "acc = __fadd_rn(acc, t.w[d]);"),
    "tanh": ("      tanhf(__fmul_rn(bg, __fadd_rn(__fadd_rn(acc, t.h), "
             "t.off)));",
             "      __fmul_rn(bg, __fadd_rn(__fadd_rn(acc, t.h), t.off));"),
    "counter_hash": ("pbit::mix32(key ^ t[Cc].key) & 0xFFu);",
                     "(key ^ t[Cc].key) & 0xFFu);"),
    "noise_draw": ("    if (!Lfsr || j + 1 < p.n_half) draw<1 - Cc>(j + 1);",
                   "    (void)0;"),
    "store": ("      sp[t[Cc].node] = flip(sp, t[Cc], bg[Cc], ru[Cc]);",
              "      if (flip(sp, t[Cc], bg[Cc], ru[Cc]) == 7.0f) "
              "sp[t[Cc].node] = 0.0f;"),
}


def operands(graph, chains, noise, seed):
    from repro_torch import api
    from repro_torch.core.cd import PBitMachine

    mach = PBitMachine.create(graph, seed, noise=noise, device="cuda")
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=S),
                       chains=chains)
    rng = np.random.default_rng(seed + 3)
    chip = ses.program_edges(
        np.clip(np.round(rng.normal(size=graph.n_edges) * 32.0), -128,
                127).astype(np.int32), np.zeros(graph.n_nodes, np.int32))
    args, kw = kernel_operands(ses, chip, ses.generator(seed + 5),
                               n_sweeps=S)
    args[10] = ses.default_betas[:, None].expand(S, chains).contiguous()
    return args, kw


def sass_mix(lib_path: str) -> dict:
    """Instruction counts of the resident kernel's SASS by opcode class."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "resident" not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in
            re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                        block))
        out[name] = {k: ops[k] for k in ("LDS", "STS", "LD", "ST", "LDG",
                                         "STG", "LDL", "STL", "BAR", "MUFU",
                                         "FADD", "FMUL", "FFMA", "IMAD")}
        out[name]["total"] = sum(ops.values())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("k1_parts: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.kernels import build
    from repro_torch.kernels import sweep_fused as sf

    build.build_all()
    if args.sass:
        print(json.dumps({"sass": sass_mix(str(
            build.library_path("sweep_sparse")))}), flush=True)
    g = make_chip_graph()
    cases = {(b, noise): operands(g, b, noise, args.seed)
             for b in (16, 256) for noise in ("counter", "lfsr")}

    src = (build.CSRC / "sweep_sparse.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (old, new) in PARTS.items():
            if old not in src:
                raise AssertionError(f"{name}: csrc/sweep_sparse.cu changed")
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
        base = sf._library()
        libs = {"base": base}
        for name in PARTS:
            lib = ctypes.CDLL(str(Path(tmp) / f"{name}.so"))
            for fn in ("sweep_sparse_launch", "sweep_sparse_smem_bytes",
                       "sweep_sparse_error_string"):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
            libs[f"without_{name}"] = lib
        try:
            for name, lib in libs.items():
                sf._library = lambda lib=lib: lib
                row = {"variant": name}
                for (b, noise), (a, kw) in cases.items():
                    row[f"B{b}_{noise}"] = device_kernel_ms(
                        lambda: sf.sweep_sparse(*a, **kw),
                        "sweep_sparse_kernel", 3) * 1e3 / (2 * S)
                print(json.dumps(row), flush=True)
        finally:
            sf._library = lambda: base
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
