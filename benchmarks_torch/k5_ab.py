#!/usr/bin/env python3
"""A/B of the in-kernel halo exchange K5 between two checkouts on one card.

    python3 benchmarks_torch/k5_ab.py --trees A B [--order ABBA] [--seed 0]

Needs one CUDA device and ``nvcc``.  Each tree is a checkout of this
repository (its ``src/`` and kernel sources); every run starts a fresh
interpreter that imports that tree's port, builds its libraries into the
tree's own ``build/`` and measures the sharded path of ``chip_smoke.py``
(the 64x64-cell Chimera lattice, 32768 spins, on 8 row bands; 256 chains;
SK couplings and the 100-sweep anneal from this script's ``chip_smoke``
helpers; operands from the same seed in both trees):

* the Session call (ms on CUDA events around one synchronised call, median
  of 3 after a warm-up) of each sharded policy ``chip_smoke.py`` runs
  through ``auto``: ``Sync(halo_every=2, sweeps_per_launch=4)`` barrier
  (``k2_L4_barrier``) and async (``k2_L4_async``), and
  ``Sync(halo_every=inf, sweeps_per_launch=4)`` (``inf_L4``), with the
  launches each call made of K5 and of K1, and the device time of every
  kernel of one call (`torch.profiler`; the rest of the call is the card
  waiting for the host);
* K5's device time (`torch.profiler`, 20 launches) of the first launch of
  the barrier and the async call — 8 bands x 256 chains x 4608 columns,
  S=4, exchange points 0, 2, 4, 6 — with the tree's plan where it has one,
  and the host's time a call of K5's wrapper (a loop of 50 launches on the
  host clock, then one synchronise);
* guards: K1 at N=440 S=1000 (the sample path's launch) and K3 at N=440,
  256 chains, S=100, device time each.

Runs go in the order given (``ABBA``: A, B, B, A; the runner is
``_ab.py``), one JSON line each, then the card's name and power limit.
Compare two trees only inside one call of this script.
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K5_KERNELS = ("sweep_exchange_kernel", "sweep_exchange_cluster_kernel")


def measure(seed: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from chip_smoke import B, DEVICE, K1_KERNELS, cuda_ms, device_kernel_ms
    from repro_torch import api
    from repro_torch.core import distributed as dist
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.kernels import build
    from repro_torch.kernels import sweep_fused as sf

    def all_kernels_ms(fn):
        """Device time of every kernel of one ``fn()`` (after a warm-up)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
                   for e in prof.key_averages()) / 1e3

    def host_us(fn, n=50):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return host / n * 1e6

    t0 = time.perf_counter()
    build.build_all()
    out = {"src": str(Path(build.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t0}

    # the sharded path, as chip_smoke.py's sharded phase builds it
    g = make_chimera(64, 64)
    rng = np.random.default_rng(seed + 400)
    mach = PBitMachine.create(g, seed + 400, sparse=True, noise="counter",
                              device=DEVICE)
    sched = api.Anneal(0.05, 3.0, n_sweeps=cs.SHARD_SWEEPS)
    ses0 = mach.session(schedule=sched, chains=B)
    chip = ses0.program_edges(*cs.sk_edge_codes(g, rng))
    st = ses0.init_state(ses0.generator(seed + 401))
    mesh = dist.make_mesh((cs.SHARD_BANDS,), ("data",))
    policies = {
        "k2_L4_barrier": api.Sync(halo_every=2, sweeps_per_launch=4),
        "k2_L4_async": api.Sync(halo_every=2, mode="async",
                                sweeps_per_launch=4),
        "inf_L4": api.Sync(halo_every=math.inf, sweeps_per_launch=4)}
    for name, sync in policies.items():
        ses = api.Session(mach.sampler_spec(
            schedule=sched, chains=B, mesh=mesh, sync=sync).replace(
                backend="auto"))
        call = lambda: ses.sample(chip, st.m, st.noise_state)  # noqa: E731
        _, counts, calls = cs.drive(call)
        row = {"backend": ses.backend,
               "loop_shape": ses._engine.loop_shape,
               "call_ms": cuda_ms(call),
               "call_device_ms": all_kernels_ms(call),
               "k5_launches": counts["sweep_sparse_exchange"],
               "k1_launches": counts["sweep_sparse"]}
        if name != "inf_L4":
            args, kwargs, _ = calls["sweep_sparse_exchange"][0]
            launch = lambda: sf.sweep_sparse_exchange(  # noqa: E731
                *args, **kwargs)
            row["k5_device_ms"] = device_kernel_ms(launch, K5_KERNELS, 20)
            row["k5_call_host_us"] = host_us(launch)
            plan = getattr(sf.sweep_sparse_exchange, "last_plan", None)
            if plan is not None:
                row["plan"] = plan._asdict()
        out[name] = row

    # guards: K1 (the sample path's launch) and K3 at N=440
    gc = make_chip_graph()
    rng = np.random.default_rng(seed + 300)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 301)
    _, _, kcalls = cs.drive(lambda: cs.anneal_chip("counter", seed, rng))
    a, kw, _ = kcalls["sweep_sparse"][0]
    out["guard_k1_N440_S1000_device_ms"] = device_kernel_ms(
        lambda: sf.sweep_sparse(*a, **kw), K1_KERNELS, 5)
    mach = PBitMachine.create(gc, seed, noise="counter", device=DEVICE)
    ses = mach.session(chains=B)
    chip = ses.program_master(rng.normal(size=gc.n_edges) * 40.0,
                              rng.normal(size=gc.n_nodes) * 20.0)
    a, kw = cs.kernel_operands(ses, chip, gen, n_sweeps=100)
    a = cs.dense_operands(a, chip)
    out["guard_k3_N440_S100_device_ms"] = device_kernel_ms(
        lambda: sf.sweep_fused(*a, **kw), "k3_", 5)
    return out


if __name__ == "__main__":
    import _ab
    sys.exit(_ab.main(measure, __file__, __doc__))
