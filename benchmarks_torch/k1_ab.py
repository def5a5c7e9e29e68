#!/usr/bin/env python3
"""A/B of the slot-layout kernel K1 (and K4, its stream instance) between two
checkouts on one card.

    python3 benchmarks_torch/k1_ab.py --trees A B [--order ABBA] [--seed 0]

Needs one CUDA device and ``nvcc``.  Each tree is a checkout of this
repository (its ``src/`` and kernel sources); every run starts a fresh
interpreter that imports that tree's port, builds its kernels into the
tree's own ``build/`` and measures, at the shapes of ``chip_smoke.py``
(operands from this script's ``chip_smoke`` helpers, launches recorded from
the paths with ``chip_smoke.drive``):

* K1 on the 440-spin chip, 256 chains, S=1000 (the sample path's launch),
  counter and LFSR noise: one call (CUDA events, median of 3) and the
  kernel's device time (`torch.profiler`), and ms per `Session.sample`
  call that makes it;
* K1 on the 8192- and 32768-spin lattices, S=100: call and device;
* the ``fused_sparse`` CD phase (the first K1 launch with moments of
  full-adder CD on the chip, 256 chains): call and device (with the
  reduction of the moment partials), and ms per ``fused_sparse`` CD epoch
  (host clock, 5 epochs and one evaluation, / 5);
* one K4 launch, N=440, S=100, staging the next program: call and device;
* one per-band K1 launch of the sharded path (64x64-cell lattice on 8 row
  bands, ``Sync(halo_every=inf, sweeps_per_launch=4)``, its engine with
  ``resident_exchange=False``: K1 per band) and one K5 launch
  (``Sync(halo_every=2, sweeps_per_launch=4)``): call and device.

Where the tree has `sparse_plan`, each K1/K4 row names the plan's body,
chains per block and threads.  Runs go in the order given (``ABBA``: A, B,
B, A; the runner is ``_ab.py``), one JSON line each, then the card's name
and power limit.  Compare two trees only inside one call of this script.
"""
from __future__ import annotations

import dataclasses
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
    from repro_torch.core import tasks
    from repro_torch.core.cd import CDConfig, PBitMachine, train_cd
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.kernels import build
    from repro_torch.kernels import sweep_fused as sf

    t0 = time.perf_counter()
    build.build_all()
    out = {"src": str(Path(build.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t0}

    def timed(wrapper, call, names=K1_KERNELS):
        args, kwargs, _ = call
        run = lambda: wrapper(*args, **kwargs)  # noqa: E731
        row = {"ms": cuda_ms(run), "device_ms": device_kernel_ms(run, names,
                                                                 5)}
        if hasattr(sf, "sparse_plan") and wrapper is not sf.sweep_sparse_exchange:
            plan = cs.sparse_plan_of(args, kwargs)
            row.update(body=plan.body, tb=plan.chains, threads=plan.threads)
        return row

    # the sample path's K1 launch at N=440 and its Session.sample call
    rng = np.random.default_rng(seed + 100)
    for noise in ("counter", "lfsr"):
        res, _, calls = cs.drive(lambda: cs.anneal_chip(noise, seed, rng))
        out[f"N440_S1000_{noise}"] = {
            **timed(sf.sweep_sparse, calls["sweep_sparse"][0]),
            "sample_call_ms": cuda_ms(res["_again"])}

    # the lattices through K1
    for rows, cols in ((32, 32), (64, 64)):
        g = make_chimera(rows, cols)
        _, _, calls = cs.drive(lambda: cs.lattice(rows, cols, seed, rng))
        out[f"lattice_{g.n_nodes}_S100"] = timed(sf.sweep_sparse,
                                                 calls["sweep_sparse"][0])

    # the fused_sparse CD phase and epoch
    gc = make_chip_graph()
    task = tasks.full_adder_task(gc)
    cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B,
                   epochs=5)
    cd = PBitMachine.create(gc, seed, noise="counter",
                            backend="fused_sparse", device=DEVICE)
    _, _, calls = cs.drive(lambda: train_cd(
        cd, task.visible_idx, task.target_dist,
        dataclasses.replace(cfg, epochs=1), seed + 1, eval_every=1))
    phase = next(c for c in calls["sweep_sparse"] if c[1].get("accumulate"))
    out["cd_phase"] = {"S": phase[0][10].shape[0], **timed(sf.sweep_sparse,
                                                           phase)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_cd(cd, task.visible_idx, task.target_dist, cfg, seed + 1,
             eval_every=cfg.epochs)
    torch.cuda.synchronize()
    out["fused_sparse_cd_epoch_ms"] = ((time.perf_counter() - t0)
                                       / cfg.epochs * 1e3)

    # one K4 launch at N=440, S=100
    mach = PBitMachine.create(gc, seed, noise="counter", device=DEVICE)
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=100),
                       chains=B)
    chip, nxt = (ses.program_edges(*cs.sk_edge_codes(gc, rng))
                 for _ in range(2))
    args, _ = cs.kernel_operands(ses, chip, ses.generator(seed), n_sweeps=100)
    k4 = (args[:12] + [nxt.nbr_w, nxt.h], {}, None)
    out["k4_N440_S100"] = timed(sf.sweep_sparse_stream, k4)

    # one per-band K1 launch and one K5 launch of the sharded path
    g = make_chimera(64, 64)
    mach = PBitMachine.create(g, seed + 400, sparse=True, noise="counter",
                              device=DEVICE)
    sched = api.Anneal(0.05, 3.0, n_sweeps=cs.SHARD_SWEEPS)
    ses0 = mach.session(schedule=sched, chains=B)
    chip = ses0.program_edges(*cs.sk_edge_codes(g, rng))
    st = ses0.init_state(ses0.generator(seed + 401))
    mesh = dist.make_mesh((cs.SHARD_BANDS,), ("data",))
    # the launch-boundary policy's K1 launches: its engine forced off K5
    band = dist.ShardedEngine(
        g, mesh, api.Partition(), "counter", 8, B,
        sync=api.Sync(halo_every=float("inf"), sweeps_per_launch=4),
        backend="fused_sparse", device=DEVICE, resident_exchange=False)
    _, _, calls = cs.drive(lambda: band.sample(chip, st.m, st.noise_state,
                                               ses0.default_betas))
    out["band_k1"] = timed(sf.sweep_sparse, calls["sweep_sparse"][0])
    ses = api.Session(mach.sampler_spec(
        schedule=sched, chains=B, mesh=mesh,
        sync=api.Sync(halo_every=2, sweeps_per_launch=4)).replace(
            backend="auto"))
    _, _, calls = cs.drive(lambda: ses.sample(chip, st.m, st.noise_state))
    out["k5"] = timed(sf.sweep_sparse_exchange,
                      calls["sweep_sparse_exchange"][0], K5_KERNELS)
    return out


if __name__ == "__main__":
    import _ab
    sys.exit(_ab.main(measure, __file__, __doc__))
