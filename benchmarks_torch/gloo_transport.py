#!/usr/bin/env python3
"""Diagnostic: what two gloo ranks sharing one card can move, and which
collectives they survive.

    python3 benchmarks_torch/gloo_transport.py [--mb 300] [--reps 50]
        [--device cpu]

Starts two processes, ranks of one gloo group (a ``FileStore`` in a
temporary directory), on the one card (or the CPU with ``--device cpu``),
and prints one JSON line per table:

* ``times``: seconds (two rounds each) to move ``--mb`` MB of bfloat16
  between the card and the host (pageable and page-locked, both ways),
  and of gloo's all-reduce (bfloat16, float32, int32), all-gather (into
  one tensor, and into a list) and reduce-scatter on host tensors of that
  size, and its all-reduce and all-gather on CUDA tensors (gloo stages
  those itself) — the parts `core.ranks.MeshComm`'s host-staged transport
  is made of;
* ``staging``: milliseconds a call (the median of ``--reps``) at the
  sizes of a decode token's collectives (4 KB to 4 MB of bfloat16 on the
  card), for `core.ranks.MeshComm`'s all-reduce and all-gather over the
  two ranks (page-locked buffers, the gather an int32 all-reduce of a
  zeroed whole) against the same collectives staged through pageable
  copies (``.cpu()``) and against gloo's own all-gather: which of the
  two choices costs what at small sizes;
* ``survives``: each one-tensor collective of ``torch.distributed``
  (c10d) and of its functional twins (``_functional_collectives``, what
  ``DTensor`` redistributes with) on small CUDA tensors, each in a fresh
  pair of processes: the exit codes (-11: a segmentation fault).

Then the card's name and power limit.  No kernel is built.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

_RANK = r"""
import json, os, sys, time
import torch, torch.distributed as dist
rank, store, mode, device, mb, reps = (
    int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]),
    int(sys.argv[6]))
if device == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("gloo", rank=rank, world_size=2,
                        store=dist.FileStore(store, 2))

def sync():
    if device == "cuda":
        torch.cuda.synchronize()

def timed(fn):
    out = []
    for _ in range(2):
        dist.barrier(); sync()
        t0 = time.perf_counter(); fn(); sync()
        out.append(time.perf_counter() - t0)
    return out

if mode == "times":
    n = mb * 500_000                      # bfloat16 elements of mb MB
    host = torch.ones(n, dtype=torch.bfloat16)
    res = {}
    if device == "cuda":
        dev = host.cuda()
        pinned = torch.empty(n, dtype=torch.bfloat16, pin_memory=True)
        res["to_host_pageable"] = timed(lambda: dev.cpu())
        res["to_host_pinned"] = timed(lambda: pinned.copy_(dev))
        res["to_card_pageable"] = timed(lambda: host.to("cuda"))
        res["to_card_pinned"] = timed(lambda: dev.copy_(pinned))
    f32 = torch.ones(n // 2, dtype=torch.float32)
    i32 = torch.ones(n // 2, dtype=torch.int32)
    whole = torch.empty(2 * n, dtype=torch.bfloat16)
    res["all_reduce_bf16"] = timed(lambda: dist.all_reduce(host))
    res["all_reduce_f32"] = timed(lambda: dist.all_reduce(f32))
    res["all_reduce_i32"] = timed(lambda: dist.all_reduce(i32))
    res["all_gather_into_tensor"] = timed(
        lambda: dist.all_gather_into_tensor(whole, host))
    res["all_gather_list"] = timed(
        lambda: dist.all_gather(list(whole.chunk(2)), host))
    res["reduce_scatter_tensor"] = timed(
        lambda: dist.reduce_scatter_tensor(host, whole))
    if device == "cuda":
        dwhole = torch.empty(2 * n, dtype=torch.bfloat16, device="cuda")
        res["cuda_all_reduce"] = timed(lambda: dist.all_reduce(dev))
        res["cuda_all_gather_into_tensor"] = timed(
            lambda: dist.all_gather_into_tensor(dwhole, dev))
    if rank == 0:
        print(json.dumps(res), flush=True)
elif mode == "staging":
    import statistics
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    from repro_torch.core import ranks
    from repro_torch.core.distributed import make_rank_mesh

    comm = ranks.rank_comm(make_rank_mesh((1, 2), ("data", "model")),
                           device)
    group = comm.groups["model"]

    def per_call(fn):
        out = []
        for _ in range(reps):
            dist.barrier(); sync()
            t0 = time.perf_counter(); fn(); sync()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    def pageable_all_reduce(x):
        h = x.cpu()
        dist.all_reduce(h, group=group)
        return h.to(x.device)

    def pageable_all_gather(x):
        h = x.cpu()
        out = h.new_empty((2 * h.shape[0],) + tuple(h.shape[1:]))
        dist.all_gather_into_tensor(out, h, group=group)
        return out.to(x.device)

    res = {}
    for kb in (4, 64, 512, 4096):
        x = torch.ones(kb * 512, dtype=torch.bfloat16, device=device)
        res[f"{kb}KB"] = {
            "meshcomm_all_reduce": per_call(
                lambda: comm.all_reduce(x, ("model",))),
            "pageable_all_reduce": per_call(lambda: pageable_all_reduce(x)),
            "meshcomm_all_gather": per_call(
                lambda: comm.all_gather(x, 0, ("model",))),
            "pageable_all_gather": per_call(lambda: pageable_all_gather(x)),
        }
    if rank == 0:
        print(json.dumps(res), flush=True)
else:
    import torch.distributed._functional_collectives as fc
    x = torch.arange(8, dtype=torch.float32, device=device) + rank
    g = dist.group.WORLD
    calls = {
        "c10d.all_reduce": lambda: dist.all_reduce(x.clone()),
        "c10d.all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(16), x),
        "c10d.reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(4), x),
        "c10d.all_to_all_single": lambda: dist.all_to_all_single(
            x.new_empty(8), x),
        "functional.all_reduce": lambda: fc.all_reduce(x, "sum", g).sum()
        .item(),
        "functional.all_gather_tensor": lambda: fc.all_gather_tensor(
            x, 0, g).sum().item(),
        "functional.reduce_scatter_tensor": lambda: fc.reduce_scatter_tensor(
            x, "sum", 0, g).sum().item(),
        "functional.all_to_all_single": lambda: fc.all_to_all_single(
            x, None, None, g).sum().item(),
    }
    calls[mode]()
    sync()
dist.destroy_process_group()
"""

SURVIVES = ("c10d.all_reduce", "c10d.all_gather_into_tensor",
            "c10d.reduce_scatter_tensor", "c10d.all_to_all_single",
            "functional.all_reduce", "functional.all_gather_tensor",
            "functional.reduce_scatter_tensor",
            "functional.all_to_all_single")


def pair(mode: str, device: str, mb: int, reps: int = 1,
         timeout: float = 300) -> list:
    """Run the rank script as ranks 0 and 1 from the repo's root; (exit
    code, stdout) each."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK, str(r), os.path.join(d, "store"),
             mode, device, str(mb), str(reps)], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            for r in range(2)]
        out = []
        for p in procs:
            try:
                o, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                o, _ = p.communicate()
            out.append((p.returncode, o))
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=300)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    for table, key in (("times", "seconds"), ("staging", "ms_per_call")):
        (rc, out), _ = pair(table, args.device, args.mb, args.reps)
        if rc != 0:
            print(f"the {table} ranks exited {rc}", file=sys.stderr)
            return 1
        print(json.dumps({"table": table, "mb": args.mb, "reps": args.reps,
                          "device": args.device,
                          key: json.loads(out.strip().splitlines()[-1])}),
              flush=True)
    print(json.dumps({"table": "survives", "device": args.device,
                      "exit_codes": {m: [rc for rc, _ in pair(
                          m, args.device, 1, timeout=120)]
                          for m in SURVIVES}}),
          flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
