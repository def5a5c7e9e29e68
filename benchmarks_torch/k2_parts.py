#!/usr/bin/env python3
"""Diagnostic: where a launch of the dense half-sweep kernel K2 spends its
time, and what each block tile costs.

    python3 benchmarks_torch/k2_parts.py [--seed 0]

Needs one CUDA device and ``nvcc``.  On the 440-spin chip (its W, one
colour class updated, beta a 0-d view of a schedule), at 256 chains (the
training path's shape) and 32 (the workloads'), prints one JSON line per
row, each the kernel's mean device time over 200 launches.  The rows of a
table run in turn, three rounds, inside one `torch.profiler` session (many
sessions in one process starve the later ones of events), blocks of
launches told apart by a 5 ms idle gap between them (the profiler may drop
a few events, so nothing is counted by position); the medians and all
rounds are printed — a short kernel's time moves with the card's state:

* ``tiles``: every tile of ``HALF_SWEEP_TILES`` (`tile_plan`), the one
  `half_sweep_plan` picks marked;
* ``parts``: the plan's launch for copies of ``csrc/pbit_update.cu`` that
  each leave one part out — the staging copies, the ascending sum, the
  copy of the nodes outside the update set, the eqn-2 decision (the sum
  plus u is stored instead), and everything (the kernel returns at once:
  what a launch costs).  The copies compute wrong spins; they are built
  into a temporary directory, timed, and never used elsewhere.  The
  difference to ``base`` is what the part costs.

Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import DEVICE, nvidia_smi_line  # noqa: E402

K2_KERNEL = "pbit_half_sweep_kernel"
REPEATS = 200
ROUNDS = 3     # every row is timed in each round, in turn; medians kept
GAP_S = 0.005  # the card idles this long between blocks of launches
# part left out -> [(text of csrc/pbit_update.cu, its replacement), ...]
PARTS = {
    # no copies, and so no wait for them
    "stage": [("  if (busy) {\n    if (!Tiled) {",
               "  if (false) {\n    if (!Tiled) {"),
              ("    mbar_wait(bar, 0);", "    (void)bar;")],
    "sum": [("    accumulate<RN, RB>(acc, wr, mr, 0, N);",
             "    (void)wr;\n    (void)mr;")],
    "keep_copy": [("    for (int e = e_lo + lane; e < e_hi; e += 32) {\n"
                   "      const int k = e == e_lo + lane ? kept0 : s.keep[e];\n"
                   "#pragma unroll 4\n      for (int r = warp; r < rows; r += n_warps)\n"
                   "        out[(size_t)(b0 + r) * N + k] = rows_smem",
                   "    for (int e = e_hi; e < e_hi; e += 32) {\n"
                   "      const int k = e == e_lo + lane ? kept0 : s.keep[e];\n"
                   "#pragma unroll 4\n      for (int r = warp; r < rows; r += n_warps)\n"
                   "        out[(size_t)(b0 + r) * N + k] = rows_smem")],
    "decision": [(
        "      const float d = pbit::decision_u(acc[r][c], h_r[r], beta_c[c],\n"
        "                                       gain_r[r], off_r[r], rg_r[r], "
        "co_r[r],\n                                       u_rc[r][c]);",
        "      const float d = __fadd_rn(acc[r][c], u_rc[r][c]);")],
    "everything": [(
        "  const bool busy = p0 < s.n_upd;  // uniform across the block",
        "  if (s.N > 0) return;\n  const bool busy = p0 < s.n_upd;")],
}


def build_variant(name: str, edits, tmp: Path):
    from repro_torch.kernels import build
    from repro_torch.kernels.pbit_update import declare

    src = (build.CSRC / "pbit_update.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"part {name!r}: its text is not in the "
                               f"source exactly once")
        src = src.replace(old, new)
    d = tmp / name
    d.mkdir()
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    (d / "pbit_update.cu").write_text(src)
    out = d / "libk2.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(d / "pbit_update.cu")], check=True)
    return declare(ctypes.CDLL(str(out)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("k2_parts: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.kernels import pbit_update as k2

    dev = torch.device(DEVICE)
    g = make_chip_graph()
    rng = np.random.default_rng(args.seed + 300)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 301)
    color = torch.as_tensor(g.color, device=dev)
    beta = torch.linspace(0.3, 2.0, 10, device=dev)[3]
    limits = k2.card_limits(dev)

    shapes = {}
    for chains in (256, 32):
        mach = PBitMachine.create(g, args.seed, noise="counter",
                                  device=DEVICE)
        ses = mach.session(chains=chains)
        chip = ses.program_master(rng.normal(size=g.n_edges) * 40.0,
                                  rng.normal(size=g.n_nodes) * 20.0)
        m = ses.random_spins(gen)
        u = (torch.randint(0, 256, m.shape, generator=gen, device=dev)
             .to(torch.float32) - 127.5) / 128.0
        ops = (m, chip.W, chip.h, chip.tanh_gain, chip.tanh_offset,
               chip.rand_gain, chip.comp_offset, color == 1, beta, u)
        shapes[chains] = ops

    def launcher(ops, prep):
        return lambda: k2.pbit_half_sweep(*ops, prepared=prep)

    def rounds(fns):
        """Each fn launched REPEATS times in turn, ROUNDS times, in one
        profiler session, the card idle for GAP_S between blocks: (median
        ms per launch, each round's) per fn.  Blocks are told apart by
        the widest gaps, and a block's mean is over the launches the profiler
        recorded (it may drop a few)."""
        from torch.profiler import ProfilerActivity, profile

        for fn in fns:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ROUNDS):
                for fn in fns:
                    for _ in range(REPEATS):
                        fn()
                    torch.cuda.synchronize()
                    time.sleep(GAP_S)
        k2_events = sorted(
            (e.time_range.start, e.time_range.elapsed_us())
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and K2_KERNEL in e.name)
        # the widest gaps between launches start the blocks: a host stall
        # inside a block, shorter than the idle gap, does not split it
        n_blocks = ROUNDS * len(fns)
        gaps = sorted((ev[0] - prev[0], i + 1) for i, (prev, ev) in
                      enumerate(zip(k2_events, k2_events[1:])))
        cuts = gaps[max(0, len(gaps) - n_blocks + 1):]
        starts = [0, *sorted(i for _, i in cuts), len(k2_events)]
        blocks = [k2_events[a:b] for a, b in zip(starts, starts[1:])]
        if (len(blocks) != n_blocks
                or min(g for g, _ in cuts) < GAP_S * 1e6 / 2     # µs
                or min(map(len, blocks)) < REPEATS // 2):
            raise RuntimeError(f"the profiler's K2 launches fall into "
                               f"{len(blocks)} blocks of "
                               f"{sorted(map(len, blocks))[:3]}..., not "
                               f"{ROUNDS * len(fns)} of {REPEATS}")
        per = np.zeros((len(fns), ROUNDS))
        for b, block in enumerate(blocks):
            per[b % len(fns), b // len(fns)] = np.mean(
                [t for _, t in block]) / 1e3
        return ([float(np.median(t)) for t in per],
                [[float(x) for x in t] for t in per])

    for chains, ops in shapes.items():
        chosen = k2.PreparedHalfSweep(*ops[1:8], chains).plan
        preps = []
        for tile in k2.HALF_SWEEP_TILES:
            prep = k2.PreparedHalfSweep(*ops[1:8], chains)
            prep.plan = k2.tile_plan(g.n_nodes, chains, prep.n_upd, tile,
                                     limits)
            prep._bind(prep.operands[6].view(torch.uint8))
            preps.append(prep)
        med, every = rounds([launcher(ops, p) for p in preps])
        for tile, prep, t, ts in zip(k2.HALF_SWEEP_TILES, preps, med, every):
            print(json.dumps({
                "row": "tiles", "B": chains, "tile": list(tile),
                "nodes": prep.plan.nodes, "chains": prep.plan.chains,
                "grid": list(prep.plan.grid), "body": prep.plan.body,
                "picked": prep.plan == chosen, "device_ms": t,
                "rounds": ts}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build_variant(name, edits, Path(tmp))
                for name, edits in PARTS.items()}
        for chains, ops in shapes.items():
            base = k2.PreparedHalfSweep(*ops[1:8], chains)
            preps = {"base": base}
            for name, lib in libs.items():
                prep = k2.PreparedHalfSweep(*ops[1:8], chains)
                prep._lib = lib
                lib.pbit_half_sweep_prepare(ctypes.byref(prep._static),
                                            prep.plan.smem_bytes)
                preps[f"without_{name}"] = prep
            med, every = rounds([launcher(ops, p) for p in preps.values()])
            row = {"row": "parts", "B": chains, "plan": base.plan._asdict()}
            for name, t, ts in zip(preps, med, every):
                row[f"{name}_ms"] = t
                row[f"{name}_rounds"] = ts
            print(json.dumps(row), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
