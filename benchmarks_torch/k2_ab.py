#!/usr/bin/env python3
"""A/B of the dense half-sweep kernel K2 between two checkouts on one card.

    python3 benchmarks_torch/k2_ab.py --trees A B [--order ABBA] [--seed 0]

Needs one CUDA device and ``nvcc``.  Each tree is a checkout of this
repository (its ``src/`` and kernel sources); every run starts a fresh
interpreter that imports that tree's port, builds its K1, K2 and K3
libraries into the tree's own ``build/`` and measures, on the 440-spin
chip (operands from this script's ``chip_smoke`` helpers):

* K2 at 256 chains (the training path's shape) and 32 (the workloads'),
  each on the chip's W and on a dense Gaussian W, one colour class
  updated, beta a 0-d view of a schedule: one call through
  ``kernels.ops.make_kernel_half_sweep`` — the sweep function the
  ``pallas`` backend builds — on CUDA events (median of 3), its host time
  (a loop of 200 calls on the host clock, then one synchronise), the
  kernel's device time (`torch.profiler`, 100 calls), whether it equals
  the plain version, the tree's plan where it has one, and
  ``torch.matmul(m, W.T)`` on the same operands as a yardstick;
* the ``pallas`` anneal call of ``chip_smoke.py``'s workloads (300 sweeps,
  32 chains), host clock around a synchronised call, twice after a warm-up;
* the ``pallas`` CD epoch as ``chip_smoke.py``'s training path runs it
  (full adder, 256 chains, 5 epochs and one evaluation, / 5): host clock
  after a warm-up; and the split of one CD step with its evaluation (40 +
  400 half-sweeps): K2 calls and their host time, the noise draws' host
  time and the rest (host clock, no profiler), then K2's and every
  kernel's device time over one more (`torch.profiler`);
* guards: K1 at N=440 S=1000 (the sample path's launch) and K3 at N=440,
  256 chains, S=100, device time each.

Runs go in the order given (``ABBA``: A, B, B, A; the runner is
``_ab.py``), one JSON line each, then the card's name and power limit.
Compare two trees only inside one call of this script.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
K2_KERNEL = "pbit_half_sweep_kernel"
HOST_CALLS = 200


def measure(seed: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from chip_smoke import DEVICE, K1_KERNELS, cuda_ms, device_kernel_ms
    from repro_torch.core import pbit as pbit_mod
    from repro_torch.core import tasks
    from repro_torch.core.annealing import AnnealConfig, anneal, sk_instance
    from repro_torch.core.cd import CDConfig, PBitMachine, train_cd
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.core.hardware import HardwareConfig
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import pbit_update as k2_mod
    from repro_torch.kernels import sweep_fused as sf

    t0 = time.perf_counter()
    build.build_all(("sweep_sparse", "pbit_update", "sweep_fused"))
    out = {"src": str(Path(build.__file__).resolve().parents[2]),
           "build_s": time.perf_counter() - t0}
    dev = torch.device(DEVICE)
    g = make_chip_graph()
    rng = np.random.default_rng(seed + 300)
    gen = torch.Generator(device=dev).manual_seed(seed + 301)
    color = torch.as_tensor(g.color, device=dev)
    schedule = torch.linspace(0.3, 2.0, 10, device=dev)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        host = (time.perf_counter() - t) / HOST_CALLS * 1e3
        torch.cuda.synchronize()
        return host

    # K2 at both path shapes, on the chip's W and a dense Gaussian W
    for chains in (256, 32):
        mach = PBitMachine.create(g, seed, noise="counter", device=DEVICE)
        ses = mach.session(chains=chains)
        chip = ses.program_master(rng.normal(size=g.n_edges) * 40.0,
                                  rng.normal(size=g.n_nodes) * 20.0)
        for kind in ("chip_W", "dense_W"):
            c = chip if kind == "chip_W" else cs.intra_colour_chip(
                chip, gen, scale=1.0)
            m = ses.random_spins(gen)
            u = (torch.randint(0, 256, m.shape, generator=gen, device=dev)
                 .to(torch.float32) - 127.5) / 128.0
            mask, beta = color == 1, schedule[3]
            hs = ops.make_kernel_half_sweep()
            run = lambda: hs(m, c, mask, beta, u)  # noqa: E731
            want = k2_mod.pbit_half_sweep_ref(
                m, c.W, c.h, c.tanh_gain, c.tanh_offset, c.rand_gain,
                c.comp_offset, mask, beta, u)
            row = {"equal_to_plain": bool(torch.equal(run(), want)),
                   "ms": cuda_ms(run), "host_ms": host_ms(run),
                   "device_ms": device_kernel_ms(run, K2_KERNEL, 100),
                   "matmul_ms": cuda_ms(lambda: torch.matmul(m, c.W.T))}
            plan = getattr(k2_mod.pbit_half_sweep, "last_plan", None)
            if plan is not None:
                row["plan"] = [plan.body, plan.nodes, plan.chains]
            out[f"k2_B{chains}_{kind}"] = row

    # the pallas anneal call of the workloads path
    J, h = sk_instance(g, seed + 4)
    ann = PBitMachine.create(g, seed + 3, HardwareConfig(), beta=1.0,
                             w_scale=0.02, noise="counter", backend="pallas",
                             device=DEVICE)
    acfg = AnnealConfig(n_sweeps=300, beta_start=0.02, beta_end=2.0,
                        chains=32)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        anneal(ann, J, h, acfg, seed + 5, record_every=30)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out["pallas_anneal_ms"] = times[1:]

    # the pallas CD epoch and its split
    task = tasks.full_adder_task(g)
    cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=cs.B,
                   epochs=5)
    cd = PBitMachine.create(g, seed, noise="counter", backend="pallas",
                            device=DEVICE)
    one = dataclasses.replace(cfg, epochs=1)
    epoch = lambda: train_cd(cd, task.visible_idx,  # noqa: E731
                             task.target_dist, one, seed + 1, eval_every=1)
    epoch()
    torch.cuda.synchronize()
    t = time.perf_counter()
    train_cd(cd, task.visible_idx, task.target_dist, cfg, seed + 1,
             eval_every=cfg.epochs)
    torch.cuda.synchronize()
    out["pallas_cd_epoch_ms"] = (time.perf_counter() - t) / cfg.epochs * 1e3

    split = {"k2_calls": 0, "k2_host_s": 0.0, "noise_host_s": 0.0}
    k2_wrapper, make_sweep_fn = ops.pbit_half_sweep, pbit_mod.make_sweep_fn

    def timed_k2(*args, **kwargs):
        t = time.perf_counter()
        res = k2_wrapper(*args, **kwargs)
        split["k2_host_s"] += time.perf_counter() - t
        split["k2_calls"] += 1
        return res

    def timed_sweep_fn(chip, color, noise_fn, *args, **kwargs):
        def noise(ns):
            t = time.perf_counter()
            res = noise_fn(ns)
            split["noise_host_s"] += time.perf_counter() - t
            return res
        return make_sweep_fn(chip, color, noise, *args, **kwargs)

    ops.pbit_half_sweep, pbit_mod.make_sweep_fn = timed_k2, timed_sweep_fn
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        ops.pbit_half_sweep, pbit_mod.make_sweep_fn = k2_wrapper, \
            make_sweep_fn
    calls = split["k2_calls"]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epoch()
        torch.cuda.synchronize()
    k2_dev = all_dev = 0.0
    for evt in prof.key_averages():
        # self time: a kernel's own, zero for the host ops that launch it
        t_dev = getattr(evt, "self_device_time_total",
                        getattr(evt, "self_cuda_time_total", 0.0))
        all_dev += t_dev
        if K2_KERNEL in evt.key:
            k2_dev += t_dev
    out["pallas_epoch_split"] = {
        "epoch_ms": wall * 1e3, "k2_calls": calls,
        "k2_call_host_ms": split["k2_host_s"] * 1e3,
        "noise_host_ms": split["noise_host_s"] * 1e3,
        "rest_ms": (wall - split["k2_host_s"] - split["noise_host_s"]) * 1e3,
        "per_half_sweep_us": {
            "k2_call_host": split["k2_host_s"] / calls * 1e6,
            "noise_host": split["noise_host_s"] / calls * 1e6,
            "rest": (wall - split["k2_host_s"] - split["noise_host_s"])
            / calls * 1e6},
        "profiled_epoch_k2_device_ms": k2_dev / 1e3,
        "profiled_epoch_all_kernels_device_ms": all_dev / 1e3}

    # guards: K1 (the sample path's launch) and K3 at N=440
    res, _, kcalls = cs.drive(lambda: cs.anneal_chip("counter", seed, rng))
    a, kw, _ = kcalls["sweep_sparse"][0]
    out["guard_k1_N440_S1000_device_ms"] = device_kernel_ms(
        lambda: sf.sweep_sparse(*a, **kw), K1_KERNELS, 5)
    mach = PBitMachine.create(g, seed, noise="counter", device=DEVICE)
    ses = mach.session(chains=cs.B)
    chip = ses.program_master(rng.normal(size=g.n_edges) * 40.0,
                              rng.normal(size=g.n_nodes) * 20.0)
    a, kw = cs.kernel_operands(ses, chip, gen, n_sweeps=100)
    a = cs.dense_operands(a, chip)
    out["guard_k3_N440_S100_device_ms"] = device_kernel_ms(
        lambda: sf.sweep_fused(*a, **kw), "k3_", 5)
    return out


if __name__ == "__main__":
    import _ab
    sys.exit(_ab.main(measure, __file__, __doc__))
