#!/usr/bin/env python3
"""Diagnostic: where a launch of the in-kernel halo exchange K5 spends its
time, and what each chain tile costs.

    python3 benchmarks_torch/k5_parts.py [--seed 0] [--ptxas] [--sass]
    python3 benchmarks_torch/k5_parts.py --trees _parent .

Needs one CUDA device and ``nvcc``.  At the sharded path's shape — the
64x64-cell Chimera lattice (32768 spins) on 8 row bands, 256 chains, 4608
extended columns a band, S=4, barrier, exchange points 0, 2, 4, 6 (one
launch as ``chip_smoke.py``'s helper makes it) — prints one JSON line per
table, each launch's mean device time over 50 launches.  The rows of a
table run in turn, three rounds, inside one `torch.profiler` session
(many sessions in one process starve the later ones of events), blocks of
launches told apart by a 5 ms idle gap between them; the medians and all
rounds are printed:

* ``parts``: the plan's launch (``base``), the same with one exchange
  point (``one_point``: the half-sweeps alone, no exchange past point 0)
  and with moments (``moments``: every sweep measured), and copies of
  ``csrc/sweep_exchange.cu`` that each leave parts of the cluster body
  out — everything (``empty``: the kernel returns at once, what a launch
  costs), the exchanges and half-sweeps (``load_store``: the tile loaded
  and stored), the half-sweeps (``exchanges``, also at one exchange
  point), and with them the publish or the install of each exchange.  The
  copies compute wrong spins; they are built into a temporary directory,
  timed, and never used elsewhere.  Derived: an exchange (publish,
  cluster barrier, install) is ``(exchanges - exchanges_one_point) / 3``,
  its publish ``(exchanges - no_publish) / 4``, its install ``(exchanges
  - no_install) / 4``;
* ``chains``: the cluster body at 4 to 32 chains a CTA, the one
  `exchange_plan` picks marked, each with the card's resident-cluster
  count and its waves; and the mailbox body (the kernel every launch ran
  before the cluster body) at the plan it would take.

``--ptxas`` first prints ``nvcc -Xptxas -v``'s lines for each kernel of the
library (registers, spills, shared memory); ``--sass`` the instruction mix
of each cluster-body kernel's SASS (``cuobjdump``).  Then the card's name
and power limit.

``--trees`` needs ``nvcc`` alone (no card) and prints nothing else: for
each tree given, a checkout of this repository, one JSON line of its
``csrc/sweep_exchange.cu``'s kernel instances (the cluster body's
``sweep_exchange_cluster_kernel<NQ, stream|plain>``, the mailbox body's
``sweep_exchange_kernel<D, stream|plain>``, the reductions), each with its
registers and spill stores and loads in bytes.
"""
from __future__ import annotations

import argparse
import json
import re
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

K5_KERNELS = ("sweep_exchange_kernel", "sweep_exchange_cluster_kernel")
REPEATS = 50
ROUNDS = 3     # every row is timed in each round, in turn; medians kept
GAP_S = 0.005  # the card idles this long between blocks of launches
_NO_SWEEPS = ("      cluster_half_sweep<NQ>(",
              "      if (p.S < 0) cluster_half_sweep<NQ>(")
# part left out -> [(text of csrc/sweep_exchange.cu, its replacement), ...]
PARTS = {
    "empty": [("  extern __shared__ __align__(16) unsigned char smem[];\n"
               "  constexpr int TB = 4 * NQ;",
               "  extern __shared__ __align__(16) unsigned char smem[];\n"
               "  constexpr int TB = 4 * NQ;\n  if (p.S >= 0) return;")],
    "load_store": [("  for (int e = 0; e < p.n_ex; ++e) {\n"
                    "    const int h0 = p.ex_pts[e];\n"
                    "    const int h1 = e + 1 < p.n_ex ? p.ex_pts[e + 1] : "
                    "2 * p.S;\n    publish_rows<NQ>",
                    "  for (int e = 0; e < 0; ++e) {\n"
                    "    const int h0 = p.ex_pts[e];\n"
                    "    const int h1 = e + 1 < p.n_ex ? p.ex_pts[e + 1] : "
                    "2 * p.S;\n    publish_rows<NQ>")],
    "exchanges": [_NO_SWEEPS],
    "no_publish": [_NO_SWEEPS,
                   ("    publish_rows<NQ>(sp, outbox",
                    "    if (p.S < 0) publish_rows<NQ>(sp, outbox")],
    "no_install": [_NO_SWEEPS,
                   ("    if (!p.async_mode)\n"
                    "      install_rows<NQ>(cluster, sp, outbox, e % kSlots",
                    "    if (p.S < 0)\n"
                    "      install_rows<NQ>(cluster, sp, outbox, e % kSlots")],
}


def build_variant(name: str, edits, tmp: Path):
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.sweep_fused import declare_exchange

    src = (build.CSRC / "sweep_exchange.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"part {name!r}: its text is not in the "
                               f"source exactly once")
        src = src.replace(old, new)
    d = tmp / name
    d.mkdir()
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, d)
    (d / "sweep_exchange.cu").write_text(src)
    out = d / "libk5.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(d / "sweep_exchange.cu")], check=True)
    return declare_exchange(ctypes.CDLL(str(out)))


def ptxas_lines(src: Path | None = None) -> list[str]:
    """``nvcc -Xptxas -v`` on ``src`` (default this tree's
    csrc/sweep_exchange.cu): its per-kernel register, spill and
    shared-memory lines."""
    from repro_torch.kernels import build

    src = build.CSRC / "sweep_exchange.cu" if src is None else src
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(src)],
            capture_output=True, text=True, check=True)
    return [ln.strip() for ln in proc.stderr.splitlines()
            if "ptxas info" in ln or "spill" in ln]


def register_table(lines: list[str]) -> dict:
    """`ptxas_lines` -> {kernel instance: {"registers", "spill_stores",
    "spill_loads"}}."""
    table, name = {}, None
    for line in lines:
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            short = re.search(r"(sweep_exchange_cluster_kernel|"
                              r"sweep_exchange_kernel|reduce_\w*kernel)"
                              r"(ILi(\d+)ELb(\d))?", entry.group(1))
            name = (f"{short.group(1)}<{short.group(3)}, "
                    f"{'stream' if short.group(4) == '1' else 'plain'}>"
                    if short.group(2) else short.group(1))
            table[name] = {}
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and name:
            table[name].update(spill_stores=int(spill.group(1)),
                               spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            table[name]["registers"] = int(regs.group(1))
    return table


def sass_mix(lib_path: str) -> dict:
    """Instruction counts of the cluster-body kernels' SASS by opcode."""
    import collections
    import re

    from repro_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "cluster_kernel" not in name:
            continue
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in
            re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z0-9_.]+)", block))
        out[name] = dict(ops.most_common(40))
        out[name]["total"] = sum(ops.values())
    return out


def rounds(fns) -> tuple[list, list]:
    """Each fn launched REPEATS times in turn, ROUNDS times, in one profiler
    session, the card idle for GAP_S between blocks: (median ms per launch,
    each round's) per fn.  Blocks are told apart by the widest gaps, and a
    block's mean is over the K5 launches the profiler recorded."""
    import torch
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
    events = sorted(
        (e.time_range.start, e.time_range.elapsed_us())
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and any(k in e.name for k in K5_KERNELS))
    n_blocks = ROUNDS * len(fns)
    gaps = sorted((ev[0] - prev[0], i + 1) for i, (prev, ev) in
                  enumerate(zip(events, events[1:])))
    cuts = gaps[max(0, len(gaps) - n_blocks + 1):]
    starts = [0, *sorted(i for _, i in cuts), len(events)]
    blocks = [events[a:b] for a, b in zip(starts, starts[1:])]
    if (len(blocks) != n_blocks
            or min(g for g, _ in cuts) < GAP_S * 1e6 / 2     # µs
            or min(map(len, blocks)) < REPEATS // 2):
        raise RuntimeError(f"the profiler's K5 launches fall into "
                           f"{len(blocks)} blocks of "
                           f"{sorted(map(len, blocks))[:3]}..., not "
                           f"{n_blocks} of {REPEATS}")
    per = np.zeros((len(fns), ROUNDS))
    for b, block in enumerate(blocks):
        per[b % len(fns), b // len(fns)] = np.mean([t for _, t in block]) / 1e3
    return ([float(np.median(t)) for t in per],
            [[float(x) for x in t] for t in per])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--trees", nargs="+", metavar="TREE")
    args = ap.parse_args()
    if args.trees:
        for tree in args.trees:
            src = (ROOT / tree / "src/repro_torch/kernels/csrc"
                   / "sweep_exchange.cu")
            print(json.dumps({"tree": tree, "kernels": register_table(
                ptxas_lines(src))}), flush=True)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("k5_parts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.chimera import make_chimera
    from repro_torch.kernels import build
    from repro_torch.kernels import sweep_fused as sf

    build.build_all()
    if args.ptxas:
        print(json.dumps({"ptxas": ptxas_lines()}), flush=True)
    if args.sass:
        print(json.dumps({"sass": sass_mix(str(
            build.library_path("sweep_exchange")))}), flush=True)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 19)
    rng = np.random.default_rng(args.seed + 19)
    (a, kw, _), plan = cs.exchange_launch(
        make_chimera(64, 64), cs.SHARD_BANDS, cs.B, gen, rng,
        mode="barrier", halo_every=2, S=4, sparse=True)
    R, B, N = a[0].shape
    S = a[10].shape[0]
    ones = torch.ones(S, device=dev)

    def tables(ex_pts=None, block_b=None):
        return sf.ExchangeTables(
            *a[1:10], a[12], a[13], a[14], a[15], chains=B,
            n_loc=kw["n_loc"], halo=kw["halo"],
            ex_pts=kw["ex_pts"] if ex_pts is None else ex_pts,
            mode=kw["mode"], col0=a[17][1], block_b=block_b)

    def launcher(t, measured=None):
        b = list(a)
        b[16] = measured
        kwargs = dict(n_loc=kw["n_loc"], halo=kw["halo"], ex_pts=t.ex_pts,
                      mode=t.mode, prepared=t)
        return lambda: sf.sweep_sparse_exchange(*b, **kwargs)

    base, one = tables(), tables(ex_pts=(0,))
    with tempfile.TemporaryDirectory() as tmp:
        variants = {name: build_variant(name, edits, Path(tmp))
                    for name, edits in PARTS.items()}
        fns = {"base": launcher(base), "one_point": launcher(one),
               "moments": launcher(base, ones)}
        keep = sf._exchange_library
        try:
            for name, lib in variants.items():
                sf._exchange_library = lambda lib=lib: lib
                fns[name] = launcher(tables())
                if name == "exchanges":
                    fns["exchanges_one_point"] = launcher(tables((0,)))
        finally:
            sf._exchange_library = keep
        med, every = rounds(list(fns.values()))
    t = dict(zip(fns, med))
    n_ex = len(kw["ex_pts"])
    row = {"table": "parts", "plan": base.plan._asdict(),
           "shape": {"bands": R, "B": B, "N_ext": N, "S": S,
                     "ex_pts": list(kw["ex_pts"])},
           "ms": t, "rounds": dict(zip(fns, every)),
           "derived_ms": {
               "half_sweeps": t["one_point"] - t["load_store"]
               - (t["exchanges"] - t["exchanges_one_point"]) / (n_ex - 1),
               "per_exchange": (t["exchanges"] - t["exchanges_one_point"])
               / (n_ex - 1),
               "per_publish": (t["exchanges"] - t["no_publish"]) / n_ex,
               "per_install": (t["exchanges"] - t["no_install"]) / n_ex,
               "moments": t["moments"] - t["base"],
               "load_store_beyond_empty": t["load_store"] - t["empty"]}}
    print(json.dumps(row), flush=True)

    # chains a CTA, and the mailbox body at the same shape
    rows = {}
    for tb in (4, 8, 12, 16, 20, 24, 32):
        rows[f"cluster_{tb}"] = tables(block_b=tb)
    limit = sf.MAX_EXCHANGE_CLUSTER
    try:
        sf.MAX_EXCHANGE_CLUSTER = 0      # no cluster body: the mailbox's
        rows["mailbox"] = tables()
    finally:
        sf.MAX_EXCHANGE_CLUSTER = limit
    med, every = rounds([launcher(x) for x in rows.values()])
    lib = sf._exchange_library()
    out = []
    for (name, x), ms, ts in zip(rows.items(), med, every):
        p = x.plan
        held = (sf._card_fit(lib, dev, ("clusters", p.chains, 0, p.cluster,
                                         p.threads, p.smem_bytes))
                if p.body == "cluster" else None)
        tiles = -(-B // p.chains)
        out.append({"row": name, "plan": p._asdict(),
                    "picked": p == base.plan, "clusters_held": held,
                    "waves": -(-tiles // held) if held else None,
                    "device_ms": ms, "rounds": ts})
    print(json.dumps({"table": "chains", "rows": out}), flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
