#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA device, ``nvcc`` and the sources of this checkout; imports
nothing of JAX or of the JAX package.  It builds the five CUDA kernel
libraries from ``src/repro_torch/kernels/csrc`` into ``build/`` (one
``nvcc`` each, in parallel) and holds every kernel against its plain
PyTorch version on the card.  Then it drives the port's paths, each with
the kernels' launch counts set to 0 just before it and read just after:

* sample: program a mismatched 440-spin Chimera chip and sample it through
  `PBitMachine` -> `Session` -> the slot-layout kernel K1, also at 8192 and
  32768 spins;
* training: in-situ CD of the full adder on the 440-spin chip, 256 chains,
  through the dense resident kernel K3 ("fused"), the dense half-sweep
  kernel K2 ("pallas") and K1 ("fused_sparse"), which must give the same
  master weights bit for bit;
* learning: the AND gate on one cell through K3, ideal and mismatched chip,
  and the transferred weights;
* workloads: annealing and Max-Cut through K2, parallel tempering through
  K3, on the 440-spin chip.
* streaming: programs as runtime operands on the 440-spin chip through
  K1 (`sample_program`, `sample_fleet`, fleet CD of the full adder on four
  virtual chips, each equal to its sequential counterpart), and a program
  chain through the double-buffered stream kernel K4; then the program
  swap and the K4 chain against serialized K1 launches are timed;
* lattice_soa: vertical Gibbs half-steps of a 32768-spin SoA Chimera
  lattice through K6;
* sharded: the 32768-spin lattice on 8 row bands of the card (256 chains,
  100 annealing sweeps): the barrier policy on the scan path equals the
  unsharded K1 Session bit for bit, two launch-resident policies run
  through the in-kernel halo exchange K5 (25 launches a call) and equal
  the same launches emulated as K1 windows per band, the
  launch-boundary policy through K1 per band; the sharded lattice anneal
  and a CD step on a 2x2 rows x chains mesh equal their unsharded runs.

Every launch of every path is recorded with its operands and replayed
through the plain version.  Any failed phase raises and the exit code is
non-zero; without a GPU it exits 1 and prints no result.

Output: one JSON object per line —
  {"phase": "env", ...}            versions, card name, power limit, limits
  {"phase": "build", ...}          seconds to build each library
  {"phase": "kernel_checks", ...}  one line per kernel (and dense_vs_sparse)
  {"phase": "main_path", ...}      the sample path: launches, replays, times
  {"phase": "training", ...}       the CD path through three backends
  {"phase": "learning", ...}       AND-gate KLs
  {"phase": "workloads", ...}      anneal, Max-Cut, tempering
  {"phase": "streaming", ...}      program operand, fleet, fleet CD, K4 chain
  {"phase": "lattice_soa", ...}    K6 half-steps
  {"phase": "sharded", ...}        row bands: policies, K5, lattice, CD
  {"kernels": [...]}               one record per kernel (see PERF.md)
  <name, power limit>              as nvidia-smi prints them
  {"ok": true, "device": {...}}    last line
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet): the roofline's rates
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12   # int8 on the tensor cores, dense

DEVICE = "cuda"    # the script has no CPU mode: main() refuses without a GPU
B = 256            # chains everywhere on the main path
CHECK_SWEEPS = 8   # sweeps per mode in the kernel_checks phase
KERNELS = ("sweep_sparse", "pbit_half_sweep", "sweep_fused",
           "sweep_sparse_stream", "lattice_vertical_update",
           "sweep_sparse_exchange")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, repeats: int = 3) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def device_kernel_ms(fn, kernel: str, repeats: int = 20):
    """Device time per call of the CUDA kernels whose name contains
    ``kernel``, from `torch.profiler` over ``repeats`` calls of ``fn``
    (after a warm-up): the kernel alone, without the host's gaps between
    launches.  None when the profiler records no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0))
    return total / repeats / 1e3 if total > 0 else None


def timed_once(fn):
    """(result, device ms) of one ``fn()``, no warm-up."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


# ---------------------------------------------------------------------------
# phase: kernels held against their plain versions
# ---------------------------------------------------------------------------
def kernel_operands(session, chip, gen, *, n_sweeps, tempered=False,
                    clamp=False):
    """Positional operands of `sweep_sparse` for a programmed chip."""
    dev = session.device
    g = session.graph
    n = g.n_nodes
    chains = session.spec.chains
    color = torch.as_tensor(g.color, device=dev)
    clamp_mask = clamp_values = None
    mask0, mask1 = color == 0, color == 1
    if clamp:
        clamp_mask = torch.rand(n, generator=gen, device=dev) < 0.1
        clamp_values = session.random_spins(gen)
        mask0, mask1 = mask0 & ~clamp_mask, mask1 & ~clamp_mask
    if tempered:
        betas = 0.2 + 1.6 * torch.rand((n_sweeps, chains), generator=gen,
                                       device=dev)
    else:
        betas = torch.linspace(0.3, 2.0, n_sweeps, device=dev)[:, None] \
            .expand(n_sweeps, chains).contiguous()
    state = session.init_state(gen)
    args = [state.m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
            chip.tanh_offset, chip.rand_gain, chip.comp_offset, mask0,
            mask1, betas, state.noise_state, clamp_mask, clamp_values]
    spec = session._noise_step.spec
    kw = dict(noise_mode=spec.kind, decimation=spec.decimation,
              gather_perm=spec.gather_perm)
    return args, kw


def compare_outputs(got, want) -> tuple[float, int]:
    """(largest absolute difference over all outputs, differing spins)."""
    if len(got) != len(want):
        raise AssertionError("kernel and plain version return different "
                             "numbers of outputs")
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output mismatch: {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        worst = max(worst, float((a.double() - b.double()).abs().max()))
    return worst, int((got[0] != want[0]).sum())


def check_kernels(seed: int) -> dict:
    """K1 against `sweep_sparse_ref` on the card, mode by mode.

    tanhf in the library equals torch.tanh bit for bit on this card (the
    probe below fails the run if that ever stops holding), and every
    statistic is an integer sum below 2^24, so the rule is equality:
    spins, noise state, s_sum, c_slots and hist must match exactly.
    """
    from repro_torch import api
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.core.cd import PBitMachine
    from repro_torch.kernels.sweep_fused import (
        sweep_sparse, sweep_sparse_ref, tanh_probe)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)

    x = torch.cat([
        (torch.rand(1 << 22, generator=gen, device=dev) * 2 - 1) * s
        for s in (0.01, 1.0, 4.0, 20.0)])
    tanh_mismatches = int((tanh_probe(x) != torch.tanh(x)).sum())
    if tanh_mismatches:
        raise AssertionError(
            f"tanhf differs from torch.tanh on {tanh_mismatches} of "
            f"{x.numel()} inputs: the bit-for-bit rule does not hold")

    S = CHECK_SWEEPS
    rng = np.random.default_rng(seed)
    results = []

    def run_case(name, noise, graph, chains, *, tempered=False, clamp=False,
                 measured=None, visible=None, coord_offset=None,
                 block_b=None, windows=None, sparse=False):
        mach = PBitMachine.create(graph, gen, noise=noise, sparse=sparse,
                                  device=DEVICE)
        ses = mach.session(schedule=api.Constant(n_sweeps=S), chains=chains)
        chip = ses.program_master(rng.normal(size=graph.n_edges) * 40.0,
                                  rng.normal(size=graph.n_nodes) * 20.0)
        args, kw = kernel_operands(ses, chip, gen, n_sweeps=S,
                                   tempered=tempered, clamp=clamp)
        meas = None
        if measured is not None:
            meas = torch.as_tensor(measured, dtype=torch.float32, device=dev)
        vis = None
        if visible is not None:
            vis = torch.as_tensor(
                rng.choice(graph.n_nodes, visible, replace=False),
                device=dev)
        kw.update(accumulate=meas is not None and visible is None,
                  collect_hist=visible is not None,
                  n_visible=visible or 0)
        tail = [meas, vis, coord_offset]
        want = sweep_sparse_ref(*args, *tail, **kw)
        got = sweep_sparse(*args, *tail, block_b=block_b, **kw)
        torch.cuda.synchronize()
        diff, spins = compare_outputs(got, want)
        if windows is not None:
            # the same launch split into half-sweep windows: thread m and
            # the noise state, sum the moment partials
            m_w, ns_w = args[0], args[11]
            parts = None
            for h0, nh in windows:
                w_args = list(args)
                w_args[0], w_args[11] = m_w, ns_w
                out = sweep_sparse(*w_args, *tail, half_offset=h0, n_half=nh,
                                   block_b=block_b, **kw)
                m_w, ns_w = out[0], out[1]
                parts = (list(out[2:]) if parts is None
                         else [p + o for p, o in zip(parts, out[2:])])
            torch.cuda.synchronize()
            d2, s2 = compare_outputs((m_w, ns_w, *parts), want)
            diff, spins = max(diff, d2), spins + s2
        results.append({"case": name, "noise": noise, "N": graph.n_nodes,
                        "B": chains, "max_abs_diff": diff,
                        "spins_differing": spins})

    chip_graph = make_chip_graph()          # 440 spins, one masked cell
    burn = (np.arange(S) >= 2).astype(np.float32)
    for noise in ("counter", "lfsr"):
        run_case("plain", noise, chip_graph, B)
        run_case("clamped", noise, chip_graph, B, clamp=True)
        run_case("moments_burn_in", noise, chip_graph, B, measured=burn)
        run_case("moments_clamped", noise, chip_graph, B, measured=burn,
                 clamp=True)
        run_case("hist_nv3", noise, chip_graph, B, measured=burn, visible=3)
        run_case("hist_nv12", noise, chip_graph, B, measured=burn,
                 visible=12)
        run_case("tempered_betas", noise, chip_graph, B, tempered=True)
        run_case("split_window", noise, chip_graph, B, measured=burn,
                 windows=[(0, 5), (5, 6), (11, 5)])
        run_case("ragged_tiles", noise, make_chimera(
            4, 4, masked_cells=[(1, 2)]), 5, measured=burn, block_b=3)
        run_case("one_cell_degree4", noise, make_chimera(1, 1), B,
                 measured=burn)
        # the main path's lattice sizes (sparse-native chips; 32768 spins
        # need more than 48 KB of shared memory per block)
        run_case("lattice_8192_moments", noise, make_chimera(32, 32), B,
                 measured=burn, sparse=True)
        run_case("lattice_32768", noise, make_chimera(64, 64), B,
                 sparse=True)
    run_case("coord_offset", "counter", chip_graph, B,
             coord_offset=(1000, 77))
    run_case("coord_offset_wrap", "counter", chip_graph, B,
             coord_offset=(2 ** 32 - 3, 2 ** 32 - 100))

    bad = [r for r in results
           if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0]
    out = {"phase": "kernel_checks", "kernel": "sweep_sparse",
           "rule": "bit for bit (spins, noise state, s_sum, c_slots, hist)",
           "tanh_probe_inputs": x.numel(),
           "tanh_probe_mismatches": tanh_mismatches,
           "max_abs_diff": max(r["max_abs_diff"] for r in results),
           "spins_differing": sum(r["spins_differing"] for r in results),
           "cases": results}
    emit(out)
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
    return out


def dense_operands(args, chip):
    """`sweep_fused`'s positional operands from `sweep_sparse`'s: the dense
    W in place of the slot tables."""
    return [args[0], chip.W] + list(args[3:])


def intra_colour_chip(chip, gen, scale: float = 0.05):
    """The chip with a dense random W that also couples nodes of one
    colour (any (n, n) codes can be programmed), zero diagonal."""
    n = chip.n_nodes
    W = torch.randn((n, n), generator=gen, device=chip.W.device) * scale
    W.fill_diagonal_(0.0)
    return dataclasses.replace(chip, W=W.contiguous())


def check_dense_kernels(seed: int) -> list[dict]:
    """K3 and K2 against `sweep_fused_ref` / `pbit_half_sweep_ref` on the
    card, mode by mode, and the dense kernels against the slot-layout ones
    on the same chip.  Rule: equality (as for K1), in every output."""
    from repro_torch import api
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.kernels.pbit_update import (pbit_half_sweep,
                                                 pbit_half_sweep_ref)
    from repro_torch.kernels.ref import pbit_sparse_half_sweep_ref
    from repro_torch.kernels.sweep_fused import (card_limits, dense_plan,
                                                 resident_clusters,
                                                 sweep_fused, sweep_fused_ref,
                                                 sweep_sparse)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    S = CHECK_SWEEPS
    rng = np.random.default_rng(seed + 7)
    chip_graph = make_chip_graph()
    burn = torch.as_tensor((np.arange(S) >= 2).astype(np.float32),
                           device=dev)

    def programmed(graph, noise, chains):
        mach = PBitMachine.create(graph, gen, noise=noise, device=DEVICE)
        ses = mach.session(schedule=api.Constant(n_sweeps=S), chains=chains)
        chip = ses.program_master(rng.normal(size=graph.n_edges) * 40.0,
                                  rng.normal(size=graph.n_nodes) * 20.0)
        return ses, chip

    # K3, mode by mode
    k3 = []

    def k3_case(name, noise, graph, chains, *, tempered=False, clamp=False,
                measured=False, visible=None, coord_offset=None,
                block_b=None, intra=False, weights=None, sweeps=S,
                overlap=False):
        ses, chip = programmed(graph, noise, chains)
        if intra:
            chip = intra_colour_chip(chip, gen)
        args, kw = kernel_operands(ses, chip, gen, n_sweeps=sweeps,
                                   tempered=tempered, clamp=clamp)
        args = dense_operands(args, chip)
        if overlap:
            # a fifth of the nodes in both update sets: more rows than a
            # CTA holds, read from device memory
            both = torch.rand(graph.n_nodes, generator=gen, device=dev) < 0.2
            args[7], args[8] = args[7] | both, args[8] | both
        vis = None
        if visible is not None:
            vis = torch.as_tensor(
                rng.choice(graph.n_nodes, visible, replace=False),
                device=dev)
        meas = None
        if measured or visible is not None:
            meas = burn if weights is None else torch.tensor(
                weights, dtype=torch.float32, device=dev)
        kw.update(accumulate=measured, collect_hist=visible is not None,
                  n_visible=visible or 0)
        tail = [meas, vis, coord_offset]
        want = sweep_fused_ref(*args, *tail, **kw)
        got = sweep_fused(*args, *tail, block_b=block_b, **kw)
        torch.cuda.synchronize()
        diff, spins = compare_outputs(got, want)
        C = args[10].shape[1] if noise == "lfsr" else 0
        plan = dense_plan(graph.n_nodes, chains, C, card_limits(dev),
                          block_b=block_b,
                          resident=lambda p: resident_clusters(p, dev))
        k3.append({"case": name, "noise": noise, "N": graph.n_nodes,
                   "B": chains, "S": sweeps, "body": plan.body,
                   "cluster_size": plan.cluster_size,
                   "chains_per_tile": plan.chains, "max_abs_diff": diff,
                   "spins_differing": spins})

    for noise in ("counter", "lfsr"):
        k3_case("plain", noise, chip_graph, B)
        k3_case("clamped", noise, chip_graph, B, clamp=True)
        k3_case("moments_burn_in", noise, chip_graph, B, measured=True)
        k3_case("moments_clamped", noise, chip_graph, B, measured=True,
                clamp=True)
        k3_case("hist_nv3", noise, chip_graph, B, visible=3)
        k3_case("hist_nv12", noise, chip_graph, B, visible=12)
        k3_case("tempered_betas", noise, chip_graph, B, tempered=True)
        k3_case("ragged_tiles", noise, make_chimera(
            4, 4, masked_cells=[(1, 2)]), 5, measured=True, block_b=3)
        k3_case("one_cell_N8", noise, make_chimera(1, 1), B, measured=True)
        k3_case("intra_colour_W", noise, chip_graph, B, measured=True,
                intra=True)
    k3_case("coord_offset", "counter", chip_graph, B,
            coord_offset=(1000, 77))
    k3_case("coord_offset_wrap", "counter", chip_graph, B,
            coord_offset=(2 ** 32 - 3, 2 ** 32 - 100))
    # the statistics in the plain version's order: any float weights
    frac = [0.0, 0.37, 1.25, 0.0, 0.37, 1.25, 0.37, 1.25][:S]
    for noise in ("counter", "lfsr"):
        k3_case("moments_fractional_weights", noise, chip_graph, B,
                measured=True, weights=frac)
    k3_case("hist_fractional_weights", "counter", chip_graph, B, visible=5,
            weights=frac)
    # each body and cluster size the plan can pick
    k3_case("streamed_W_N1152", "counter", make_chimera(12, 12), 64,
            measured=True)
    k3_case("cluster_k2_N280", "counter", make_chimera(5, 7), B,
            measured=True)
    k3_case("cluster_k16_N600", "counter", make_chimera(5, 15), B,
            measured=True, visible=4)
    # W fits a cluster, but its clusters would take 10 waves
    k3_case("streamed_waves_N864", "counter", make_chimera(12, 9), B,
            measured=True)
    k3_case("tempering_B16", "counter", chip_graph, 16, tempered=True,
            sweeps=10)
    k3_case("overlapping_masks", "counter", chip_graph, B, measured=True,
            intra=True, overlap=True)

    # K2, one half-sweep per case
    k2 = []

    def k2_case(name, graph, chains, *, per_chain_beta=False,
                random_mask=False, intra=False):
        ses, chip = programmed(graph, "counter", chains)
        if intra:
            chip = intra_colour_chip(chip, gen)
        n = graph.n_nodes
        m = ses.random_spins(gen)
        u = (torch.randint(0, 256, (chains, n), generator=gen, device=dev)
             .to(torch.float32) - 127.5) / 128.0
        color = torch.as_tensor(graph.color, device=dev)
        mask = (torch.rand(n, generator=gen, device=dev) < 0.5
                if random_mask else color == 1)
        beta = (0.2 + 1.6 * torch.rand(chains, generator=gen, device=dev)
                if per_chain_beta else 0.8)
        ops_ = (m, chip.W, chip.h, chip.tanh_gain, chip.tanh_offset,
                chip.rand_gain, chip.comp_offset, mask, beta, u)
        want = pbit_half_sweep_ref(*ops_)
        got = pbit_half_sweep(*ops_)
        torch.cuda.synchronize()
        diff, spins = compare_outputs((got,), (want,))
        k2.append({"case": name, "N": n, "B": chains, "max_abs_diff": diff,
                   "spins_differing": spins})

    k2_case("scalar_beta", chip_graph, B)
    k2_case("per_chain_beta", chip_graph, B, per_chain_beta=True)
    k2_case("random_mask", chip_graph, B, random_mask=True)
    k2_case("ragged_B37", chip_graph, 37, per_chain_beta=True)
    k2_case("intra_colour_W", chip_graph, B, random_mask=True, intra=True)
    k2_case("one_cell_N8", make_chimera(1, 1), 5)

    # dense == sparse on one attach_sparse chip
    ds = []
    e = torch.as_tensor(chip_graph.edges, device=dev).to(torch.int64)
    nbr_idx, _ = chip_graph.neighbor_table()
    slot_ij = torch.as_tensor(chip_graph.edge_slots(nbr_idx)[0],
                              device=dev).to(torch.int64)
    for noise in ("counter", "lfsr"):
        ses, chip = programmed(chip_graph, noise, B)
        args, kw = kernel_operands(ses, chip, gen, n_sweeps=S, clamp=True)
        vis = torch.as_tensor(rng.choice(chip_graph.n_nodes, 5,
                                         replace=False), device=dev)
        sp = sweep_sparse(*args, burn, accumulate=True, **kw)
        dn = sweep_fused(*dense_operands(args, chip), burn, accumulate=True,
                         **kw)
        hs = sweep_sparse(*args, burn, vis, collect_hist=True, n_visible=5,
                          **kw)
        hd = sweep_fused(*dense_operands(args, chip), burn, vis,
                         collect_hist=True, n_visible=5, **kw)
        torch.cuda.synchronize()
        gram_vs_slots = dn[3][e[:, 0], e[:, 1]] - sp[3][slot_ij, e[:, 0]]
        diff, spins = compare_outputs(
            (dn[0], dn[1], dn[2], hd[2]), (sp[0], sp[1], sp[2], hs[2]))
        diff = max(diff, float(gram_vs_slots.abs().max()))
        ds.append({"case": f"K3_vs_K1_{noise}", "max_abs_diff": diff,
                   "spins_differing": spins,
                   "outputs": ["m", "noise_state", "s_sum", "hist_nv5",
                               "Gram[e0,e1] vs c_slots[slot,e0]"]})
    m = ses.random_spins(gen)
    u = (torch.randint(0, 256, m.shape, generator=gen, device=dev)
         .to(torch.float32) - 127.5) / 128.0
    mask = torch.as_tensor(chip_graph.color, device=dev) == 0
    got = pbit_half_sweep(m, chip.W, chip.h, chip.tanh_gain,
                          chip.tanh_offset, chip.rand_gain, chip.comp_offset,
                          mask, 1.3, u)
    want = pbit_sparse_half_sweep_ref(
        m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
        chip.tanh_offset, chip.rand_gain, chip.comp_offset, mask, 1.3, u)
    torch.cuda.synchronize()
    diff, spins = compare_outputs((got,), (want,))
    ds.append({"case": "K2_vs_plain_sparse_half_sweep",
               "max_abs_diff": diff, "spins_differing": spins})

    lines = [
        {"phase": "kernel_checks", "kernel": "sweep_fused",
         "rule": "bit for bit (spins, noise state, s_sum, Gram, hist)",
         "max_abs_diff": max(r["max_abs_diff"] for r in k3),
         "spins_differing": sum(r["spins_differing"] for r in k3),
         "cases": k3},
        {"phase": "kernel_checks", "kernel": "pbit_half_sweep",
         "rule": "bit for bit (spins)",
         "max_abs_diff": max(r["max_abs_diff"] for r in k2),
         "spins_differing": sum(r["spins_differing"] for r in k2),
         "cases": k2},
        {"phase": "kernel_checks", "kernel": "dense_vs_sparse",
         "rule": "dense kernels equal the slot-layout ones on one chip",
         "max_abs_diff": max(r["max_abs_diff"] for r in ds),
         "spins_differing": sum(r["spins_differing"] for r in ds),
         "cases": ds},
    ]
    for line in lines:
        emit(line)
    bad = [(line["kernel"], r) for line in lines for r in line["cases"]
           if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0]
    if bad:
        raise AssertionError(f"a dense kernel disagrees: {bad}")
    return lines


def sk_edge_codes(graph, rng, scale: float = 32.0):
    """An SK-style program in the edge-list layout: Gaussian coupling codes
    (E,) and zero bias codes (N,), int32."""
    J = np.clip(np.round(rng.normal(size=graph.n_edges) * scale), -128, 127)
    return J.astype(np.int32), np.zeros(graph.n_nodes, np.int32)


def check_stream_kernel(seed: int) -> dict:
    """K4 against `sweep_sparse_stream_ref` on the card, case by case, and
    an 8-program chain through K4 (over a two-slot ring) against 8
    serialized K1 launches with the program swapped between them.  Rule:
    equality in every output (spins, noise state, staged weights and
    biases)."""
    from repro_torch import api
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.kernels.sweep_fused import (
        sweep_sparse, sweep_sparse_stream, sweep_sparse_stream_ref)

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    rng = np.random.default_rng(seed + 11)
    S = CHECK_SWEEPS
    cases = []

    def programmed(graph, chains, sparse, n_programs):
        mach = PBitMachine.create(graph, gen, noise="counter", sparse=sparse,
                                  device=DEVICE)
        ses = mach.session(schedule=api.Constant(n_sweeps=S), chains=chains)
        return ses, [ses.program_edges(*sk_edge_codes(graph, rng))
                     for _ in range(n_programs)]

    def case(name, graph, chains, *, sparse=False, clamp=False,
             coord_offset=None, window=None, block_b=None):
        ses, (chip, nxt) = programmed(graph, chains, sparse, 2)
        args, _ = kernel_operands(ses, chip, gen, n_sweeps=S, tempered=True,
                                  clamp=clamp)
        head, clamps = args[:12], args[12:]
        tail = [nxt.nbr_w, nxt.h, *clamps, coord_offset]
        kw = dict(window or {})
        want = sweep_sparse_stream_ref(*head, *tail, **kw)
        got = sweep_sparse_stream(*head, *tail, block_b=block_b, **kw)
        torch.cuda.synchronize()
        diff, spins = compare_outputs(got, want)
        cases.append({"case": name, "N": graph.n_nodes, "B": chains,
                      "max_abs_diff": diff, "spins_differing": spins})

    chip_graph = make_chip_graph()
    case("plain", chip_graph, B)
    case("clamped", chip_graph, B, clamp=True)
    case("coord_offset", chip_graph, B, coord_offset=(1000, 77))
    case("clamped_coord_offset", chip_graph, B, clamp=True,
         coord_offset=(2 ** 32 - 3, 2 ** 32 - 100))
    case("window", chip_graph, B, clamp=True,
         window=dict(half_offset=5, n_half=6))
    case("ragged_B5", chip_graph, 5, block_b=2)
    case("lattice_8192", make_chimera(32, 32), B, sparse=True)
    case("lattice_8192_clamped", make_chimera(32, 32), B, sparse=True,
         clamp=True)

    # the chain: launch i runs program i and stages program i+1 into the
    # free slot of a two-slot ring; serialized K1 runs the same programs
    L = 8
    ses, chips = programmed(chip_graph, B, False, L)
    args, _ = kernel_operands(ses, chips[0], gen, n_sweeps=S, tempered=True)
    m0, ns0 = args[0], args[11]
    rest = args[4:11]                     # the instance's rows, masks, betas
    ring = [(chips[0].nbr_w.clone(), chips[0].h.clone()),
            (torch.empty_like(chips[0].nbr_w), torch.empty_like(chips[0].h))]
    m_d, ns_d = m0, ns0
    m_s, ns_s = m0, ns0
    staged_equal = True
    for i, chip in enumerate(chips):
        nxt = chips[(i + 1) % L]
        cur, free = ring[i % 2], ring[(i + 1) % 2]
        m_d, ns_d, _, _ = sweep_sparse_stream(
            m_d, chip.nbr_idx, cur[0], cur[1], *rest, ns_d, nxt.nbr_w,
            nxt.h, staged=free)
        m_s, ns_s = sweep_sparse(m_s, chip.nbr_idx, chip.nbr_w, chip.h,
                                 *rest, ns_s)
        torch.cuda.synchronize()
        staged_equal &= bool(torch.equal(free[0], nxt.nbr_w)
                             and torch.equal(free[1], nxt.h))
    diff, spins = compare_outputs((m_d, ns_d), (m_s, ns_s))
    ctr = int(ns_d[1]) & 0xFFFFFFFF
    ctr_want = (int(ns0[1]) + L * 2 * S) & 0xFFFFFFFF
    chain = {"case": f"chain_{L}_programs_vs_serialized_K1", "N": 440,
             "B": B, "max_abs_diff": diff, "spins_differing": spins,
             "staged_equal_next": staged_equal,
             "noise_counter_advanced_by": L * 2 * S,
             "noise_counter_ok": ctr == ctr_want}
    out = {"phase": "kernel_checks", "kernel": "sweep_sparse_stream",
           "rule": "bit for bit (spins, noise state, staged_w, staged_h)",
           "max_abs_diff": max(r["max_abs_diff"] for r in cases + [chain]),
           "spins_differing": sum(r["spins_differing"]
                                  for r in cases + [chain]),
           "cases": cases, "chain": chain}
    emit(out)
    bad = [r for r in cases + [chain]
           if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0]
    if bad or not (staged_equal and chain["noise_counter_ok"]):
        raise AssertionError(f"sweep_sparse_stream disagrees: {bad} "
                             f"{chain}")
    return out


def soa_lattice(chains, R, C, gen, *, gain_scale=1.0):
    """A chain-batched SoA Chimera lattice at random: (B, R, C, 4) spin
    planes, couplings, biases, gains (beta folded in) and the global cell
    parity, on the card."""
    k = 4
    dev = torch.device(DEVICE)

    def spins():
        return (torch.randint(0, 2, (chains, R, C, k), generator=gen,
                              device=dev) * 2 - 1).to(torch.float32)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rc = torch.arange(R, device=dev)[:, None] + torch.arange(C, device=dev)
    return dict(m_v=spins(), m_h=spins(), W_vh=normal(R, C, k, k) * 0.5,
                wv_up=normal(R, C, k), wv_dnin=normal(R, C, k),
                h=normal(R, C, k) * 0.3,
                gain=gain_scale * (1 + 0.1 * normal(R, C, k)),
                parity=(rc % 2).to(torch.int32).contiguous())


def neighbour_planes(m_v):
    """The vertical spins of the cells above (r-1) and below (r+1), zero
    past the lattice's edge."""
    up = torch.zeros_like(m_v)
    dn = torch.zeros_like(m_v)
    up[:, 1:] = m_v[:, :-1]
    dn[:, :-1] = m_v[:, 1:]
    return up, dn


def lattice_args(lat, m_v, u):
    up, dn = neighbour_planes(m_v)
    return (m_v, lat["m_h"], up, dn, lat["W_vh"], lat["wv_up"],
            lat["wv_dnin"], lat["h"], lat["gain"], u, lat["parity"])


def check_lattice_kernel(seed: int) -> dict:
    """K6 against `lattice_vertical_update_ref` on the card: both colours
    at B=256, R=C=64, k=4 (the 32768-spin lattice in SoA form) and on a
    ragged small shape.  Rule: equality."""
    from repro_torch.kernels.lattice_update import (
        lattice_vertical_update, lattice_vertical_update_ref)

    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(seed + 13)
    cases = []
    for name, (b, r, c) in (("lattice_32768", (B, 64, 64)),
                            ("ragged_B3_R5_C3", (3, 5, 3))):
        lat = soa_lattice(b, r, c, gen)
        u = torch.rand(lat["m_v"].shape, generator=gen, device=DEVICE) * 2 - 1
        args = lattice_args(lat, lat["m_v"], u)
        for color in (0, 1):
            got = lattice_vertical_update(*args, color)
            want = lattice_vertical_update_ref(*args, color)
            torch.cuda.synchronize()
            diff, spins = compare_outputs((got,), (want,))
            cases.append({"case": f"{name}_color{color}", "B": b, "R": r,
                          "C": c, "k": 4, "max_abs_diff": diff,
                          "spins_differing": spins})
    out = {"phase": "kernel_checks", "kernel": "lattice_vertical_update",
           "rule": "bit for bit (vertical spins)",
           "max_abs_diff": max(r["max_abs_diff"] for r in cases),
           "spins_differing": sum(r["spins_differing"] for r in cases),
           "cases": cases}
    emit(out)
    if out["max_abs_diff"] != 0.0 or out["spins_differing"] != 0:
        raise AssertionError(f"lattice_vertical_update disagrees: {cases}")
    return out


def exchange_launch(graph, bands, chains, gen, rng, *, mode, halo_every, S,
                    clamp=False, moments=False, stream=False, block_b=None,
                    sparse=False):
    """One K5 launch as the sharded engine makes it: a programmed chip cut
    into ``bands`` row bands (`ShardedEngine`'s plan and layout), its halos
    exchanged once before the launch, through
    `shard_sweep.fused_shard_exchange_resident`.  Returns the recorded
    wrapper call (args, kwargs, outputs)."""
    from repro_torch import api
    from repro_torch.core import distributed as dist
    from repro_torch.core.cd import PBitMachine
    from repro_torch.kernels import shard_sweep

    mach = PBitMachine.create(graph, gen, noise="counter", sparse=sparse,
                              device=DEVICE)
    ses = mach.session(chains=chains)
    chip = ses.program_edges(*sk_edge_codes(graph, rng))
    sync = api.Sync(halo_every=halo_every, mode=mode, sweeps_per_launch=S)
    eng = dist.ShardedEngine(graph, dist.make_mesh((bands,), ("data",)),
                             api.Partition(), "counter", 8, chains,
                             sync=sync, backend="fused_sparse", device=DEVICE)
    d, parts = eng._dev, eng._chip_parts(chip)
    st = ses.init_state(gen)
    m = eng._m_parts(st.m)
    halo_up, halo_dn = shard_sweep.halo_exchange(m, d["send_up"],
                                                 d["send_dn"])
    masks = [d["upd"][:, c] for c in (0, 1)]
    kw = {}
    if clamp:
        cm = eng._part_cols(torch.rand(graph.n_nodes, generator=gen,
                                       device=DEVICE) < 0.1)
        masks = [mk & ~cm for mk in masks]
        kw.update(clamp_mask=cm,
                  clamp_values=eng._m_parts(ses.random_spins(gen)))
    if moments:   # the 0/1 burn-in mask of a stats phase
        kw["measured"] = (torch.arange(S, device=DEVICE) >= 1).to(
            torch.float32)
    if stream:
        kw.update(next_nbr_w=parts["w"].flip(0).contiguous(),
                  next_h=parts["h"].flip(0).contiguous())
    betas = 0.2 + 1.6 * torch.rand((S, chains), generator=gen, device=DEVICE)
    recorder = LaunchRecorder(shard_sweep.sweep_sparse_exchange)
    shard_sweep.sweep_sparse_exchange = recorder
    try:
        shard_sweep.fused_shard_exchange_resident(
            m, halo_up, halo_dn, d["nbr32"], parts["w"], parts["h"],
            parts["gain"], parts["off"], parts["rg"], parts["co"], masks[0],
            masks[1], betas, st.noise_state, 0, d["cols"][:, 0].tolist(),
            d["send_up"], d["send_dn"], ex_pts=sync.exchange_points(),
            mode=mode, block_b=block_b, **kw)
    finally:
        shard_sweep.sweep_sparse_exchange = recorder.wrapper
    return recorder.calls[0]


def check_exchange_kernel(seed: int) -> dict:
    """K5 against `sweep_sparse_exchange_ref` on the card, barrier and
    async, case by case: plain, clamped, moments with a 0/1 burn-in mask,
    a staged next program, ``halo_every=3`` (windows that open and close on
    half sweeps), ragged B=5 with 2 chains per block, 2 and 7 bands of the
    440-spin chip, 8 bands of the 32768-spin lattice.  Rule: equality in
    every output (spins with their halo columns, noise state, moments,
    staged program)."""
    from repro_torch.core.chimera import make_chimera, make_chip_graph

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    rng = np.random.default_rng(seed + 19)
    chip_graph, lattice_graph = make_chip_graph(), make_chimera(64, 64)
    cases = []
    for mode in ("barrier", "async"):
        for name, graph, bands, chains, kw in (
                ("plain_k1", chip_graph, 2, B, dict(halo_every=1, S=2)),
                ("clamped", chip_graph, 2, B, dict(halo_every=2, S=4,
                                                   clamp=True)),
                ("moments", chip_graph, 2, B, dict(halo_every=2, S=4,
                                                   moments=True)),
                ("moments_clamped", chip_graph, 2, B,
                 dict(halo_every=4, S=4, moments=True, clamp=True)),
                ("stream", chip_graph, 2, B, dict(halo_every=2, S=4,
                                                  stream=True)),
                ("odd_windows_k3", chip_graph, 2, B,
                 dict(halo_every=3, S=4, moments=True, clamp=True)),
                ("ragged_B5", chip_graph, 2, 5, dict(halo_every=2, S=4,
                                                     moments=True,
                                                     block_b=2)),
                ("chip_7_bands", chip_graph, 7, B, dict(halo_every=2, S=4,
                                                        moments=True)),
                ("lattice_32768_8_bands", lattice_graph, 8, B,
                 dict(halo_every=2, S=4, sparse=True)),
                ("lattice_32768_8_bands_moments", lattice_graph, 8, B,
                 dict(halo_every=2, S=4, sparse=True, moments=True,
                      clamp=True))):
            args, kwargs, got = exchange_launch(graph, bands, chains, gen,
                                                rng, mode=mode, **kw)
            kwargs = {k: v for k, v in kwargs.items() if k != "block_b"}
            want = _plain("sweep_sparse_exchange")(*args, **kwargs)
            torch.cuda.synchronize()
            diff, spins = compare_outputs(got, want)
            cases.append({"case": name, "mode": mode, "N": graph.n_nodes,
                          "bands": bands, "B": chains,
                          "ex_pts": list(kwargs["ex_pts"]),
                          "outputs": len(got), "max_abs_diff": diff,
                          "spins_differing": spins})
    out = {"phase": "kernel_checks", "kernel": "sweep_sparse_exchange",
           "rule": "bit for bit (spins incl. halo columns, noise state, "
                   "s_sum, c_slots, staged_w, staged_h)",
           "max_abs_diff": max(r["max_abs_diff"] for r in cases),
           "spins_differing": sum(r["spins_differing"] for r in cases),
           "cases": cases}
    emit(out)
    if out["max_abs_diff"] != 0.0 or out["spins_differing"] != 0:
        raise AssertionError(f"sweep_sparse_exchange disagrees: {cases}")
    return out


# ---------------------------------------------------------------------------
# the paths: launch counts and recorded launches
# ---------------------------------------------------------------------------
class LaunchRecorder:
    """Stands between a path and one kernel wrapper while the path runs:
    passes every call through and keeps its operands and outputs, so each
    launch can be replayed through the plain version."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.calls = []

    def __call__(self, *args, **kwargs):
        out = self.wrapper(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out

    # a wrapper whose own module is the seam (K6) counts through its module
    # name, which then names the recorder: the count stays the wrapper's
    @property
    def launches(self) -> int:
        return self.wrapper.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapper.launches = n


def _seams() -> dict:
    """Each kernel's wrapper and the modules through which the paths reach
    it: `kernels.ops` for the sampling engines, `kernels.shard_sweep` for
    the sharded engine's per-band K1 / K4 launches and for K5, its own
    module for K6."""
    from repro_torch.kernels import lattice_update, ops, shard_sweep
    from repro_torch.kernels.pbit_update import pbit_half_sweep
    from repro_torch.kernels.sweep_fused import (sweep_fused, sweep_sparse,
                                                 sweep_sparse_exchange,
                                                 sweep_sparse_stream)
    return {"sweep_sparse": (sweep_sparse, (ops, shard_sweep)),
            "pbit_half_sweep": (pbit_half_sweep, (ops,)),
            "sweep_fused": (sweep_fused, (ops,)),
            "sweep_sparse_stream": (sweep_sparse_stream, (ops, shard_sweep)),
            "lattice_vertical_update": (
                lattice_update.lattice_vertical_update, (lattice_update,)),
            "sweep_sparse_exchange": (sweep_sparse_exchange,
                                      (shard_sweep,))}


def _plain(name: str):
    from repro_torch.kernels.pbit_update import pbit_half_sweep_ref
    from repro_torch.kernels.ref import lattice_vertical_update_ref
    from repro_torch.kernels.sweep_fused import (sweep_fused_ref,
                                                 sweep_sparse_exchange_ref,
                                                 sweep_sparse_ref,
                                                 sweep_sparse_stream_ref)
    return {"sweep_sparse": sweep_sparse_ref,
            "pbit_half_sweep": pbit_half_sweep_ref,
            "sweep_fused": sweep_fused_ref,
            "sweep_sparse_stream": sweep_sparse_stream_ref,
            "lattice_vertical_update": lattice_vertical_update_ref,
            "sweep_sparse_exchange": sweep_sparse_exchange_ref}[name]


def drive(path_fn):
    """Run ``path_fn()`` with every kernel's launch count set to 0 just
    before and read just after, and every launch recorded.  Returns
    (result, counts, recorded calls per kernel)."""
    seams = _seams()
    recorders = {k: LaunchRecorder(w) for k, (w, _) in seams.items()}
    for k, (_, modules) in seams.items():
        for module in modules:
            setattr(module, k, recorders[k])
    try:
        for w, _ in seams.values():
            w.launches = 0
        result = path_fn()
        torch.cuda.synchronize()
        counts = {k: w.launches for k, (w, _) in seams.items()}
    finally:
        for k, (w, modules) in seams.items():
            for module in modules:
                setattr(module, k, w)
    for k in KERNELS:
        if counts[k] != len(recorders[k].calls):
            raise AssertionError(
                f"{k} launched {counts[k]} times through "
                f"{len(recorders[k].calls)} calls of its wrapper")
    return result, counts, {k: recorders[k].calls for k in KERNELS}


_SWEEP_OUTPUTS = {"sweep_sparse": ("m", "noise_state"),
                  "sweep_fused": ("m", "noise_state"),
                  "sweep_sparse_stream": ("m", "noise_state", "staged_w",
                                          "staged_h")}


def replay_through_plain_version(name: str, calls) -> list[dict]:
    """Each recorded launch of kernel ``name`` against its plain version on
    the same operands."""
    plain = _plain(name)
    rows = []
    for args, kwargs, got in calls:
        # the plain versions have no tiling to choose
        kw = {k: v for k, v in kwargs.items() if k != "block_b"}
        want, plain_ms = timed_once(lambda: plain(*args, **kw))
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        diff, spins = compare_outputs(got, want)
        row = {"N": args[0][0].numel(), "B": args[0].shape[0],
               "max_abs_diff": diff, "spins_differing": spins,
               "plain_ms": plain_ms}
        if name == "sweep_sparse_exchange":
            outputs = ["m", "noise_state"] + (
                ["s_sum", "c_slots"] if args[16] is not None else
                ["staged_w", "staged_h"] if len(got) == 4 else [])
            row.update(bands=args[0].shape[0], B=args[0].shape[1],
                       N=args[0].shape[2], S=args[10].shape[0],
                       ex_pts=list(kwargs["ex_pts"]),
                       mode=kwargs.get("mode", "barrier"), outputs=outputs)
        elif name in _SWEEP_OUTPUTS:
            outputs = list(_SWEEP_OUTPUTS[name])
            if kwargs.get("accumulate"):
                outputs += ["s_sum", "c_slots" if name == "sweep_sparse"
                            else "Gram"]
            if kwargs.get("collect_hist"):
                outputs.append(f"hist_nv{kwargs['n_visible']}")
            betas = args[9] if name == "sweep_fused" else args[10]
            row.update(S=betas.shape[0],
                       noise=kwargs.get("noise_mode", "counter"),
                       outputs=outputs)
        rows.append(row)
    return rows


def replay_all(calls: dict) -> tuple[dict, float]:
    """Replays of every recorded launch of every kernel: (summary per
    kernel, the largest difference); raises on any difference."""
    summary, worst, bad = {}, 0.0, []
    for name in KERNELS:
        rows = replay_through_plain_version(name, calls[name])
        summary[name] = {
            "launches": len(rows),
            "max_abs_diff": max([r["max_abs_diff"] for r in rows],
                                default=0.0),
            "spins_differing": sum(r["spins_differing"] for r in rows),
            "plain_ms_total": sum(r["plain_ms"] for r in rows)}
        worst = max(worst, summary[name]["max_abs_diff"])
        bad += [(name, r) for r in rows
                if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0]
    if bad:
        raise AssertionError(f"a recorded launch disagrees with its plain "
                             f"version: {bad[:3]}")
    return summary, worst


# ---------------------------------------------------------------------------
# phase: the sample path (K1)
# ---------------------------------------------------------------------------
def sk_codes(graph, rng, scale: float = 64.0):
    """Sherrington-Kirkpatrick-style Gaussian couplings on the Chimera
    edge set as 8-bit DAC codes (J symmetric, h = 0)."""
    e = graph.edges
    vals = rng.normal(size=e.shape[0]) * scale / 2.0
    J = np.zeros((graph.n_nodes, graph.n_nodes), np.float32)
    J[e[:, 0], e[:, 1]] = vals
    J[e[:, 1], e[:, 0]] = vals
    return np.clip(np.round(J), -128, 127), np.zeros(graph.n_nodes,
                                                    np.float32)


def anneal_chip(noise: str, seed: int, rng) -> dict:
    """Program an SK instance on the 440-spin chip and anneal it."""
    from repro_torch import api
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.energy import ising_energy

    g = make_chip_graph()
    mach = PBitMachine.create(g, seed, noise=noise, device=DEVICE)
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=1000),
                       chains=B)
    J, h = sk_codes(g, rng)
    chip = ses.program(J.astype(np.int32), h.astype(np.int32))
    state = ses.init_state(ses.generator(seed + 1))
    m, ns, _ = ses.sample(chip, state.m, state.noise_state)
    torch.cuda.synchronize()
    Jt = torch.as_tensor(J, device=ses.device)
    ht = torch.as_tensor(h, device=ses.device)
    e0 = float(ising_energy(state.m, Jt, ht).mean())
    e1 = float(ising_energy(m, Jt, ht).mean())
    if not (torch.isfinite(m).all() and m.shape == (B, g.n_nodes)
            and bool((m.abs() == 1).all())):
        raise AssertionError("anneal returned spins that are not ±1")
    if not e1 < e0:
        raise AssertionError(f"anneal did not lower the energy: {e0} -> {e1}")
    return {"noise": noise, "backend": ses.backend, "N": g.n_nodes, "B": B,
            "sweeps": 1000, "energy_initial": e0, "energy_final": e1,
            "_again": lambda: ses.sample(chip, state.m, state.noise_state)}


def one_cell(noise: str, seed: int, rng) -> dict:
    """stats and visible_hist on a programmed 8-spin cell; the histogram of
    an ideal cell is held against the exact Boltzmann distribution."""
    from repro_torch import api
    from repro_torch.core import energy
    from repro_torch.core.chimera import make_chimera
    from repro_torch.core.cd import PBitMachine, sample_visible_dist
    from repro_torch.core.hardware import HardwareConfig

    g = make_chimera(1, 1)
    w_scale = 0.02
    codes = np.clip(np.round(rng.normal(size=g.n_edges) * 35.0), -128, 127)
    h_codes = np.clip(np.round(rng.normal(size=8) * 15.0), -128, 127)
    ideal = PBitMachine.create(g, seed, hw=HardwareConfig.ideal(),
                               noise=noise, w_scale=w_scale, device=DEVICE)
    emp = sample_visible_dist(ideal, codes, h_codes, np.arange(8), seed + 2,
                              chains=B, sweeps=200, burn_in=20)
    J = np.zeros((8, 8), np.float32)
    J[g.edges[:, 0], g.edges[:, 1]] = codes * w_scale
    J[g.edges[:, 1], g.edges[:, 0]] = codes * w_scale
    exact = energy.exact_boltzmann(J, (h_codes * w_scale).astype(np.float32),
                                   1.0)
    kl = energy.kl_divergence(exact, emp)
    if not kl < 0.08:
        raise AssertionError(f"one-cell histogram is off the exact Boltzmann "
                             f"distribution: KL={kl}")

    mach = PBitMachine.create(g, seed + 3, noise=noise,    # mismatched cell
                              device=DEVICE)
    ses = mach.session(schedule=api.Constant(n_sweeps=200), chains=B)
    chip = ses.program_master(codes, h_codes)
    st = ses.init_state(ses.generator(seed + 4))
    s, c, m, ns = ses.stats(chip, st.m, st.noise_state, 200, 20)
    hist, m, ns = ses.visible_hist(chip, m, ns, np.array([0, 1, 4]), 20)
    torch.cuda.synchronize()
    ok = (s.shape == (8,) and c.shape == (g.n_edges,)
          and hist.shape == (8,) and bool(torch.isfinite(s).all())
          and bool(torch.isfinite(c).all()) and float(s.abs().max()) <= 1.0
          and float(c.abs().max()) <= 1.0
          and float(hist.sum()) == B * 180.0)
    if not ok:
        raise AssertionError("stats / visible_hist returned malformed "
                             "moments or counts")
    return {"noise": noise, "backend": ses.backend, "kl_vs_exact": kl,
            "hist_total": float(hist.sum()),
            "mean_abs_spin": float(s.abs().mean())}


def lattice(rows: int, cols: int, seed: int, rng) -> dict:
    """A sparse-native lattice at 256 chains, 100 sweeps."""
    from repro_torch import api
    from repro_torch.core.chimera import make_chimera
    from repro_torch.core.cd import PBitMachine

    g = make_chimera(rows, cols)
    mach = PBitMachine.create(g, seed, sparse=True, noise="counter",
                              device=DEVICE)
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=100),
                       chains=B)
    chip = ses.program_edges(
        np.clip(np.round(rng.normal(size=g.n_edges) * 32.0), -128,
                127).astype(np.int32),
        np.zeros(g.n_nodes, np.int32))
    st = ses.init_state(ses.generator(seed + 1))
    m, _, _ = ses.sample(chip, st.m, st.noise_state)
    torch.cuda.synchronize()
    if not (m.shape == (B, g.n_nodes) and bool((m.abs() == 1).all())):
        raise AssertionError("lattice sample returned spins that are not ±1")
    return {"N": g.n_nodes, "B": B, "sweeps": 100, "backend": ses.backend,
            "_again": lambda: ses.sample(chip, st.m, st.noise_state)}


def main_path(seed: int) -> tuple[dict, list]:
    """Drive the sample path once (`drive`); then hold every launch it made
    against the plain version and time the `Session.sample` calls."""
    rng = np.random.default_rng(seed + 100)

    def path():
        anneals = [anneal_chip(noise, seed, rng)
                   for noise in ("counter", "lfsr")]
        cells = [one_cell(noise, seed, rng) for noise in ("counter", "lfsr")]
        lattices = [lattice(32, 32, seed, rng), lattice(64, 64, seed, rng)]
        return anneals, cells, lattices

    (anneals, cells, lattices), counts, calls = drive(path)
    backends = {r["backend"] for r in anneals + cells + lattices}
    if backends != {"fused_sparse"}:
        raise AssertionError(f"main path resolved to {backends}, not the "
                             f"sweep-resident kernel")
    if counts["sweep_sparse"] <= 0:
        raise AssertionError("the sample path never launched sweep_sparse")

    replays = replay_through_plain_version("sweep_sparse",
                                           calls["sweep_sparse"])
    bad = [r for r in replays
           if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0]

    for r in anneals + lattices:
        ms = cuda_ms(r.pop("_again"))
        r["ms_per_launch"] = ms
        r["flips_per_ns"] = r["B"] * r["N"] * r["sweeps"] / (ms * 1e6)
    out = {"phase": "main_path", "backend": "fused_sparse",
           "launches": counts,
           "launches_vs_plain_version": replays,
           "anneal_440": anneals, "one_cell": cells, "lattices": lattices}
    emit(out)
    if bad:
        raise AssertionError(f"a main-path launch disagrees with the plain "
                             f"version: {bad}")
    return out, calls["sweep_sparse"]


# ---------------------------------------------------------------------------
# phase: CD training through three backends (this slice's main path)
# ---------------------------------------------------------------------------
TRAIN_BACKENDS = ("fused", "pallas", "fused_sparse")


def training(seed: int) -> tuple[dict, dict]:
    """In-situ CD of the full adder on the 440-spin chip, 256 chains, the
    same seeds through K3, K2 and K1.  256 chains and 10 - 2 = 8 measured
    sweeps per phase are powers of two, so every moment is an exact
    dyadic number in all three and the master weights must be equal."""
    from repro_torch.core import tasks
    from repro_torch.core.cd import CDConfig, PBitMachine, train_cd
    from repro_torch.core.chimera import make_chip_graph

    g = make_chip_graph()
    task = tasks.full_adder_task(g)
    cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B,
                   epochs=5)

    def path():
        runs = {}
        for backend in TRAIN_BACKENDS:
            mach = PBitMachine.create(g, seed, noise="counter",
                                      backend=backend, device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = train_cd(mach, task.visible_idx, task.target_dist, cfg,
                           seed + 1, eval_every=cfg.epochs)
            torch.cuda.synchronize()
            runs[backend] = (res, time.perf_counter() - t0,
                             mach.session(chains=B).backend)
        return runs

    runs, counts, calls = drive(path)
    ref_res = runs["fused"][0]
    same = {}
    for backend in TRAIN_BACKENDS:
        res, _, resolved = runs[backend]
        if resolved != backend:
            raise AssertionError(f"{backend} resolved to {resolved}")
        same[backend] = {
            "Jm": bool(np.array_equal(res.J_edges, ref_res.J_edges)),
            "hm": bool(np.array_equal(res.hm, ref_res.hm)),
            "metric_history": res.metric_history == ref_res.metric_history,
            "kl_history": res.kl_history == ref_res.kl_history}
    summary, worst = replay_all(calls)
    out = {"phase": "training", "graph": "make_chip_graph", "N": g.n_nodes,
           "task": task.name, "config": dataclasses.asdict(cfg),
           "noise": "counter", "launches": counts,
           "launches_vs_plain_version": summary,
           "equal_to_fused": same,
           "ms_per_epoch": {b: runs[b][1] / cfg.epochs * 1e3
                            for b in TRAIN_BACKENDS},
           "kl_final": ref_res.kl_history[-1][1],
           "corr_err_first_last": [ref_res.metric_history[0]["corr_err"],
                                   ref_res.metric_history[-1]["corr_err"]],
           "max_abs_Jm": float(np.abs(ref_res.J_edges).max())}
    emit(out)
    if not all(all(v.values()) for v in same.values()):
        raise AssertionError(f"the backends trained different weights: "
                             f"{same}")
    if not (np.isfinite(ref_res.J_edges).all()
            and np.abs(ref_res.J_edges).max() > 0):
        raise AssertionError("training left the master weights untouched "
                             "or not finite")
    for k in ("sweep_sparse", "pbit_half_sweep", "sweep_fused"):
        if counts[k] <= 0:
            raise AssertionError(f"the training path never launched {k}")
    out["_worst"] = worst
    return out, calls


# ---------------------------------------------------------------------------
# phase: learning (the paper's thesis on one cell) and the workloads
# ---------------------------------------------------------------------------
def learning(seed: int) -> dict:
    """The AND gate on one cell through K3, with the `tests/test_cd.py`
    config: the ideal chip's KL is gated; the mismatched chip's and the
    transferred weights' KLs are reported."""
    from repro_torch.core import energy, tasks
    from repro_torch.core.cd import (CDConfig, PBitMachine,
                                     sample_visible_dist, train_cd)
    from repro_torch.core.chimera import make_chimera
    from repro_torch.core.hardware import HardwareConfig

    g = make_chimera(1, 1)
    task = tasks.and_gate_task(g)
    cfg = CDConfig(lr=6.0, cd_k=15, pos_sweeps=15, burn_in=3, chains=B,
                   epochs=50)

    def path():
        mk = lambda hw: PBitMachine.create(  # noqa: E731
            g, seed + 42, hw, beta=1.0, w_scale=0.05, noise="counter",
            backend="fused", device=DEVICE)
        ideal, real = mk(HardwareConfig.ideal()), mk(HardwareConfig())
        res_ideal = train_cd(ideal, task.visible_idx, task.target_dist, cfg,
                             seed + 7, eval_every=cfg.epochs)
        res_real = train_cd(real, task.visible_idx, task.target_dist, cfg,
                            seed + 7, eval_every=cfg.epochs)
        kl = lambda res: energy.kl_divergence(  # noqa: E731
            task.target_dist, sample_visible_dist(
                real, res.J_edges, res.hm, task.visible_idx, seed + 3))
        return res_ideal, res_real, kl(res_ideal), kl(res_real)

    (res_ideal, res_real, kl_transfer, kl_insitu), counts, calls = \
        drive(path)
    summary, worst = replay_all(calls)
    out = {"phase": "learning", "task": task.name, "graph": "make_chimera(1, 1)",
           "backend": "fused", "config": dataclasses.asdict(cfg),
           "launches": counts, "launches_vs_plain_version": summary,
           "kl_ideal_chip": res_ideal.kl_history[-1][1],
           "kl_mismatched_chip": res_real.kl_history[-1][1],
           "kl_transferred_to_mismatched": kl_transfer,
           "kl_insitu_on_mismatched": kl_insitu,
           "gate": "kl_ideal_chip < 0.25"}
    emit(out)
    if not out["kl_ideal_chip"] < 0.25:
        raise AssertionError(f"the ideal chip did not learn the AND gate: "
                             f"KL={out['kl_ideal_chip']}")
    if counts["sweep_fused"] <= 0:
        raise AssertionError("the learning path never launched sweep_fused")
    out["_worst"] = worst
    return out


def workloads(seed: int) -> dict:
    """Annealing and Max-Cut through K2, parallel tempering through K3, on
    the 440-spin chip, with the reference tests' settings and gates."""
    from repro_torch.core.annealing import AnnealConfig, anneal, sk_instance
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.core.hardware import HardwareConfig
    from repro_torch.core.maxcut import random_chimera_maxcut, solve_maxcut
    from repro_torch.core.tempering import PTConfig, parallel_tempering

    g = make_chip_graph()
    mk = lambda s, w, backend: PBitMachine.create(  # noqa: E731
        g, seed + s, HardwareConfig(), beta=1.0, w_scale=w, noise="counter",
        backend=backend, device=DEVICE)

    def path():
        J, h = sk_instance(g, seed + 4)
        ann = anneal(mk(3, 0.02, "pallas"), J, h,
                     AnnealConfig(n_sweeps=300, beta_start=0.02,
                                  beta_end=2.0, chains=32), seed + 5,
                     record_every=30)
        prob = random_chimera_maxcut(g, seed + 1, edge_prob=0.8)
        mc = solve_maxcut(mk(0, 0.03, "pallas"), prob,
                          AnnealConfig(n_sweeps=300, beta_start=0.05,
                                       beta_end=3.0, chains=32), seed + 2)
        J2, h2 = sk_instance(g, seed + 1)
        pt = parallel_tempering(mk(0, 0.02, "fused"), J2, h2,
                                PTConfig(n_replicas=16, n_sweeps=1000,
                                         swap_every=10), seed + 2)
        return ann, prob, mc, pt

    (ann, prob, mc, pt), counts, calls = drive(path)
    summary, worst = replay_all(calls)
    rng = np.random.default_rng(seed)
    rand_cut = max(prob.cut_value(rng.choice([-1.0, 1.0], size=g.n_nodes))
                   for _ in range(32))
    e = ann["energy_mean"]
    gates = {
        "anneal_energy_decreases": bool(e[-1] < e[0] * 1.05 and e[-1] < 0
                                        and ann["best_energy"] <= e[-1]),
        "maxcut_beats_random": bool(mc["cut_polished"] > rand_cut * 1.15),
        "maxcut_within_bound": bool(mc["cut"] <= mc["cut_polished"]
                                    <= mc["upper_bound"]),
        "tempering_swap_rate_in_0_1": bool(0.0 < pt["swap_rate"] < 1.0)}
    out = {"phase": "workloads", "N": g.n_nodes, "launches": counts,
           "launches_vs_plain_version": summary,
           "anneal": {"backend": "pallas", "chains": 32, "sweeps": 300,
                      "energy_mean_first_last": [float(e[0]), float(e[-1])],
                      "best_energy": ann["best_energy"]},
           "maxcut": {"backend": "pallas", "cut": mc["cut"],
                      "cut_polished": mc["cut_polished"],
                      "random_cut": rand_cut,
                      "upper_bound": mc["upper_bound"]},
           "tempering": {"backend": "fused", "replicas": 16, "sweeps": 1000,
                         "swap_rate": pt["swap_rate"],
                         "best_energy": pt["best_energy"]},
           "gates": gates}
    emit(out)
    if not all(gates.values()):
        raise AssertionError(f"a workload gate failed: {gates}")
    if counts["pbit_half_sweep"] <= 0 or counts["sweep_fused"] <= 0:
        raise AssertionError(f"the workloads missed a dense kernel: {counts}")
    out["_worst"] = worst
    return out, calls


# ---------------------------------------------------------------------------
# phase: programs as runtime operands (K1, K4) and the SoA lattice (K6)
# ---------------------------------------------------------------------------
STREAM_SWEEPS = 100   # sweeps per program on the streaming path
STREAM_PROGRAMS = 8   # SK programs, fleet members and chain length
FLEET_CHIPS = 4       # virtual chips of the fleet CD
FLEET_EPOCHS = 3


def _host_ms(fn, repeats: int = 5) -> float:
    """Median host-clock ms of ``fn()`` ending in a synchronise (after a
    warm-up): what a caller waits for one call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _fleet_cd(mach, task, seed):
    """Fleet CD of the full adder on FLEET_CHIPS virtual chips, and the same
    epochs chip by chip through ``make_cd_step(...).with_mismatch``: (the
    fleet's final state and metrics, whether every epoch's master weights,
    chains, noise, velocities and metrics were equal)."""
    from repro_torch.api import fleet_member
    from repro_torch.core import energy
    from repro_torch.core.cd import CDConfig, make_cd_fleet_step

    cfg = CDConfig(cd_k=10, pos_sweeps=10, burn_in=2, chains=B,
                   epochs=FLEET_EPOCHS)
    K = FLEET_CHIPS
    ses = mach.session(chains=B)
    dev = ses.device
    mms = mach.fleet_mismatch(seed + 320, K)
    fleet = make_cd_fleet_step(mach, cfg, task.visible_idx)
    single = ses.make_cd_step(cfg, task.visible_idx).with_mismatch
    gen = ses.generator(seed + 321)
    states = [ses.init_state(gen) for _ in range(K)]
    E, n = mach.graph.n_edges, mach.graph.n_nodes
    zeros = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    f_state = [zeros(K, E), zeros(K, n), torch.stack([s.m for s in states]),
               torch.stack([s.noise_state for s in states]),
               (zeros(K, E), zeros(K, n))]
    s_state = [[zeros(E), zeros(n), s.m, s.noise_state, (zeros(E), zeros(n))]
               for s in states]
    vis_codes = torch.as_tensor(energy.all_states(len(task.visible_idx)),
                                dtype=torch.float32, device=dev)
    target = torch.as_tensor(task.target_dist, dtype=torch.float64,
                             device=dev)
    equal, history = True, []
    for _ in range(cfg.epochs):
        data = vis_codes[torch.multinomial(target, B, replacement=True,
                                           generator=gen)]
        Jm, hm, m, ns, vel, metrics = fleet(
            mms, f_state[0], f_state[1], data, f_state[2], f_state[3],
            f_state[4])
        f_state = [Jm, hm, m, ns, vel]
        for k in range(K):
            st = s_state[k]
            out = single(fleet_member(mms, k), st[0], st[1], data, st[2],
                         st[3], st[4])
            s_state[k] = list(out[:5])
            equal &= all(bool(torch.equal(a[k], b))
                         for a, b in zip((Jm, hm, m, ns, *vel),
                                         (*out[:4], *out[4])))
            equal &= all(bool(torch.equal(metrics[name][k], v))
                         for name, v in out[5].items())
        history.append({name: v.tolist() for name, v in metrics.items()})
    return f_state, history, equal, cfg


def streaming(seed: int) -> tuple[dict, dict]:
    """Programs as runtime operands on the 440-spin chip, counter noise,
    `fused_sparse`, 256 chains, `Anneal(0.05, 3.0, n_sweeps=100)`, 8 SK
    programs from seeds, driven once (`drive`): (a) `sample_program` ==
    `program_edges` + `sample`; (b) `sample_fleet` of the 8 == 8 sequential
    `sample_program` calls; (c) fleet CD of the full adder on 4 virtual
    chips, 3 epochs == the chips' epochs one by one; (d) an 8-program chain
    through K4 (`ops.stream_sweeps`, each launch staging the next program)
    == 8 `sample` calls.  Every K1 / K4 launch is replayed through its plain
    version.  Then, outside the driven run, the program swap and the K4
    chain against serialized K1 launches are timed."""
    from repro_torch import api
    from repro_torch.core import tasks
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.kernels import ops

    g = make_chip_graph()
    rng = np.random.default_rng(seed + 300)
    mach = PBitMachine.create(g, seed + 300, noise="counter", device=DEVICE)
    ses = mach.session(schedule=api.Anneal(0.05, 3.0,
                                           n_sweeps=STREAM_SWEEPS), chains=B)
    codes = [sk_edge_codes(g, rng) for _ in range(STREAM_PROGRAMS)]
    color = torch.as_tensor(g.color, device=ses.device)
    spec = ses._noise_step.spec
    betas = ses.default_betas

    def chain(chips, m, ns, first, stage):
        """Launch i runs program i from the buffers the previous launch
        staged (``first`` for launch 0) and stages program i+1 into
        ``stage(i)`` (None: new buffers)."""
        w, h = first
        for i, chip in enumerate(chips):
            nxt = chips[(i + 1) % len(chips)]
            cur = dataclasses.replace(chip, nbr_w=w, h=h)
            m, ns, w, h = ops.stream_sweeps(m, cur, color, betas, ns, spec,
                                            nxt.nbr_w, nxt.h,
                                            staged=stage(i))
        return m, ns

    def path():
        st = ses.init_state(ses.generator(seed + 301))
        progs, operand = [], []
        for J, h in codes:                                        # (a)
            prog = ses.make_program(J, h)
            progs.append(prog)
            m_o, ns_o, _ = ses.sample_program(prog, st.m, st.noise_state)
            m_c, ns_c, _ = ses.sample(ses.program_edges(J, h), st.m,
                                      st.noise_state)
            operand.append(bool(torch.equal(m_o, m_c)
                                and torch.equal(ns_o, ns_c)))
        states = [ses.init_state(ses.generator(seed + 310 + k))   # (b)
                  for k in range(STREAM_PROGRAMS)]
        m0 = torch.stack([s.m for s in states])
        ns0 = torch.stack([s.noise_state for s in states])
        m_f, ns_f, _ = ses.sample_fleet(api.stack_programs(progs), m0, ns0)
        fleet = []
        for k in range(STREAM_PROGRAMS):
            m_k, ns_k, _ = ses.sample_program(progs[k], m0[k], ns0[k])
            fleet.append(bool(torch.equal(m_f[k], m_k)
                              and torch.equal(ns_f[k], ns_k)))
        cd = _fleet_cd(mach, tasks.full_adder_task(g), seed)      # (c)
        chips = [ses.program_edges(J, h) for J, h in codes]       # (d)
        m_d, ns_d = chain(chips, st.m, st.noise_state,
                          (chips[0].nbr_w, chips[0].h), lambda i: None)
        m_s, ns_s = st.m, st.noise_state
        for chip in chips:
            m_s, ns_s, _ = ses.sample(chip, m_s, ns_s)
        chain_equal = bool(torch.equal(m_d, m_s) and torch.equal(ns_d, ns_s))
        return operand, m_f, fleet, cd, chips, chain_equal, st

    (operand, m_f, fleet, cd, chips, chain_equal, st), counts, calls = \
        drive(path)
    summary, worst = replay_all(calls)
    (Jm, hm, _, _, _), cd_history, cd_equal, cfg = cd

    # (d) times, outside the driven run
    J, h = codes[0]
    chip0 = chips[0]
    swap_ms = _host_ms(lambda: ses.sample_program(ses.make_program(J, h),
                                                  st.m, st.noise_state))
    resident_ms = _host_ms(lambda: ses.sample(chip0, st.m, st.noise_state))
    ring = [(chip0.nbr_w.clone(), chip0.h.clone()),
            (torch.empty_like(chip0.nbr_w), torch.empty_like(chip0.h))]
    resident = (chip0.nbr_w.clone(), chip0.h.clone())

    def double_buffered():    # a two-slot ring: run one, stage the other
        ring[0][0].copy_(chip0.nbr_w)
        ring[0][1].copy_(chip0.h)
        return chain(chips, st.m, st.noise_state, ring[0],
                     lambda i: ring[(i + 1) % 2])

    def serialized():
        m, ns = st.m, st.noise_state
        for chip in chips:        # the host swaps the program in, then K1
            resident[0].copy_(chip.nbr_w)
            resident[1].copy_(chip.h)
            cur = dataclasses.replace(chip, nbr_w=resident[0],
                                      h=resident[1])
            m, ns = ops.fused_sweeps(m, cur, color, betas, ns, spec,
                                     sparse=True)
        return m, ns

    ab = {"double_buffered": [], "serialized": []}
    for name in ("serialized", "double_buffered", "double_buffered",
                 "serialized"):
        fn = double_buffered if name == "double_buffered" else serialized
        ab[name].append(cuda_ms(fn) / len(chips))
    same_chain = compare_outputs(double_buffered(), serialized())
    staged_bytes = 4 * (chip0.nbr_w.numel() + chip0.h.numel())

    out = {"phase": "streaming", "graph": "make_chip_graph", "N": g.n_nodes,
           "B": B, "S": STREAM_SWEEPS, "backend": ses.backend,
           "programs": STREAM_PROGRAMS, "launches": counts,
           "launches_vs_plain_version": summary,
           "operand_equals_constant": operand,
           "fleet_equals_sequential": fleet,
           "fleet_cd": {"chips": FLEET_CHIPS, "task": "full_adder",
                        "config": dataclasses.asdict(cfg),
                        "equal_to_sequential": cd_equal,
                        "metrics_per_epoch": cd_history,
                        "max_abs_Jm": float(Jm.abs().max())},
           "chain_equals_sample": chain_equal,
           "program_swap_ms": swap_ms,
           "preprogrammed_sample_ms": resident_ms,
           "ms_per_launch": {k: float(np.mean(v)) for k, v in ab.items()},
           "ms_per_launch_runs": ab,
           "ab_order": "serialized, double_buffered x2, serialized",
           "ab_chains_equal": same_chain == (0.0, 0),
           "staged_bytes_per_launch": staged_bytes}
    emit(out)
    if not (all(operand) and all(fleet) and cd_equal and chain_equal
            and out["ab_chains_equal"]):
        raise AssertionError("a streaming path disagrees with its "
                             "sequential counterpart")
    if not (bool((m_f.abs() == 1).all()) and bool(torch.isfinite(Jm).all())
            and float(Jm.abs().max()) > 0):
        raise AssertionError("streaming returned malformed spins or left the "
                             "fleet's master weights untouched")
    for k in ("sweep_sparse", "sweep_sparse_stream"):
        if counts[k] <= 0:
            raise AssertionError(f"the streaming path never launched {k}")
    out["_worst"] = worst
    return out, calls


def lattice_soa(seed: int, steps: int = 20) -> tuple[dict, dict]:
    """Vertical Gibbs half-steps of a 32768-spin SoA Chimera lattice (B=256
    chains, 64 x 64 cells, k=4, couplings from a seed, gain 2 with beta
    folded in, the horizontal spins held fixed) through K6, colours
    alternating, driven once (`drive`) and replayed through the plain
    version.  Gate: the vertical spins' mean alignment with their local
    field, m_v · I, rises from its random start and ends positive."""
    from repro_torch.kernels import lattice_update

    gen = torch.Generator(device=torch.device(DEVICE)).manual_seed(seed + 17)
    lat = soa_lattice(B, 64, 64, gen, gain_scale=2.0)

    def alignment(m_v):
        up, dn = neighbour_planes(m_v)
        I = (torch.einsum("rcij,brcj->brci", lat["W_vh"], lat["m_h"])
             + lat["wv_dnin"] * up + lat["wv_up"] * dn + lat["h"])
        return float((m_v * I).mean())

    def path():
        m_v = lat["m_v"]
        for t in range(steps):
            u = torch.rand(m_v.shape, generator=gen, device=DEVICE) * 2 - 1
            m_v = lattice_update.lattice_vertical_update(
                *lattice_args(lat, m_v, u), t % 2)
        return m_v

    m_v, counts, calls = drive(path)
    summary, worst = replay_all(calls)
    a0, a1 = alignment(lat["m_v"]), alignment(m_v)
    out = {"phase": "lattice_soa", "B": B, "R": 64, "C": 64, "k": 4,
           "spins": 64 * 64 * 8, "half_steps": steps, "launches": counts,
           "launches_vs_plain_version": summary,
           "alignment_first_last": [a0, a1]}
    emit(out)
    if not (bool((m_v.abs() == 1).all()) and a1 > a0 and a1 > 0):
        raise AssertionError(f"the SoA half-steps did not align the vertical "
                             f"spins with their field: {a0} -> {a1}")
    if counts["lattice_vertical_update"] != steps:
        raise AssertionError(f"K6 launched {counts} times for {steps} "
                             f"half-steps")
    out["_worst"] = worst
    return out, calls


SHARD_BANDS = 8       # row bands of the 32768-spin lattice on the card
SHARD_SWEEPS = 100    # annealing sweeps per call (25 launches of 4)


def sharded(seed: int) -> tuple[dict, dict]:
    """The row-band sharded engine on the card, driven once (`drive`): the
    64x64-cell Chimera lattice (32768 spins, sparse-native, SK couplings
    from a seed) on 8 row bands, 256 chains, counter noise,
    `Anneal(0.05, 3.0, n_sweeps=100)`:

    (a) ``Sync()`` on ``sparse`` (the scan over the bands) equals the
        unsharded Session (`fused_sparse`: K1) bit for bit, spins and noise;
    (b) ``Sync(halo_every=2, sweeps_per_launch=4)``, barrier and async,
        resolves through ``auto`` to ``fused_sparse`` with the exchange
        inside K5 (25 launches a call); each is run twice (equal), equals
        the engine's emulation of the same launches (K1 windows per band,
        spins and noise state) and differs from (a);
    (c) ``Sync(halo_every=inf, sweeps_per_launch=4)`` runs K1 per band;
    (d) `make_lattice_anneal` at 64x64 cells, 256 chains: 8 bands == 1;
    (e) one CD step of the full adder on the 440-spin chip on a 2x2
        rows x chains mesh (``fused_sparse``: K1 windows per band) equals
        the unsharded step.
    Every launch is replayed through its plain version.  Then, outside the
    driven run, each policy's call and K5's launch are timed against the
    same schedule as K1 windows per band (the emulation) and against the
    launch-boundary shape (K1 per band)."""
    from repro_torch import api
    from repro_torch.core import distributed as dist
    from repro_torch.core import energy, tasks
    from repro_torch.core.cd import CDConfig, PBitMachine, make_cd_step
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.core.hardware import HardwareConfig

    g = make_chimera(64, 64)
    rng = np.random.default_rng(seed + 400)
    mach = PBitMachine.create(g, seed + 400, sparse=True, noise="counter",
                              device=DEVICE)
    sched = api.Anneal(0.05, 3.0, n_sweeps=SHARD_SWEEPS)
    ses0 = mach.session(schedule=sched, chains=B)
    chip = ses0.program_edges(*sk_edge_codes(g, rng))
    mesh = dist.make_mesh((SHARD_BANDS,), ("data",))
    policies = {
        "barrier_sparse": (api.Sync(), "sparse"),
        "k2_L4_barrier": (api.Sync(halo_every=2, sweeps_per_launch=4),
                          "auto"),
        "k2_L4_async": (api.Sync(halo_every=2, mode="async",
                                 sweeps_per_launch=4), "auto"),
        "inf_L4": (api.Sync(halo_every=math.inf, sweeps_per_launch=4),
                   "auto")}
    sessions = {name: api.Session(mach.sampler_spec(
        schedule=sched, chains=B, mesh=mesh, sync=sync).replace(
            backend=backend)) for name, (sync, backend) in policies.items()}
    resident = ("k2_L4_barrier", "k2_L4_async")

    lat_spec = dist.LatticeSpec(64, 64, chains=B)
    lat = dist.make_sk_lattice(
        lat_spec, torch.Generator(device=DEVICE).manual_seed(seed + 402),
        HardwareConfig.ideal(), device=DEVICE)
    lat_betas = torch.linspace(0.1, 2.0, 20, device=DEVICE)

    gc = make_chip_graph()
    task = tasks.full_adder_task(gc)
    cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B)
    base = PBitMachine.create(gc, seed + 403, noise="counter",
                              backend="fused_sparse", device=DEVICE)
    grid = dataclasses.replace(
        base, mesh=dist.make_mesh((2, 2), ("r", "c")),
        partition=api.Partition(rows="r", chains="c"))

    def cd_epoch(machine):
        step = make_cd_step(machine, cfg, task.visible_idx)
        ses = machine.session(chains=B)
        st = ses.init_state(ses.generator(seed + 404))
        gen = ses.generator(seed + 405)
        Jm = torch.randn(gc.n_edges, generator=gen, device=DEVICE) * 20.0
        hm = torch.randn(gc.n_nodes, generator=gen, device=DEVICE) * 10.0
        codes = torch.as_tensor(energy.all_states(len(task.visible_idx)),
                                device=DEVICE)
        data = codes[torch.multinomial(
            torch.as_tensor(task.target_dist, device=DEVICE), B,
            replacement=True, generator=gen)]
        vel = (torch.zeros_like(Jm), torch.zeros_like(hm))
        return step(Jm, hm, data, st.m, st.noise_state, vel), ses.backend

    def path():
        st = ses0.init_state(ses0.generator(seed + 401))
        unsharded = ses0.sample(chip, st.m, st.noise_state)
        runs = {}
        for name, ses in sessions.items():
            out = ses.sample(chip, st.m, st.noise_state)
            again = (ses.sample(chip, st.m, st.noise_state)
                     if name in resident else None)
            runs[name] = (out, again)
        anneals = [dist.make_lattice_anneal(
            lat_spec, m_, n_sweeps=20, record_every=10, device=DEVICE)(
                lat, torch.Generator(device=DEVICE).manual_seed(seed + 406),
                lat_betas) for m_ in (None, mesh)]
        cds = [cd_epoch(base), cd_epoch(grid)]
        return st, unsharded, runs, anneals, cds

    (st, unsharded, runs, anneals, cds), counts, calls = drive(path)
    summary, worst = replay_all(calls)

    def same(a, b):
        return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))

    per_spin = {name: float(dist.sparse_energy(chip, out[0]).mean())
                / g.n_nodes for name, (out, _) in runs.items()}
    per_spin["unsharded"] = float(dist.sparse_energy(
        chip, unsharded[0]).mean()) / g.n_nodes
    per_spin["initial"] = float(dist.sparse_energy(chip, st.m).mean()) \
        / g.n_nodes
    (cd0, backend0), (cd1, backend1) = cds
    cd_equal = all(bool(torch.equal(a, b)) for a, b in zip(
        (*cd0[:4], *cd0[4]), (*cd1[:4], *cd1[4])))
    checks = {
        "barrier_equals_unsharded_k1": same(runs["barrier_sparse"][0],
                                            unsharded),
        "resident_deterministic": {n: same(*runs[n]) for n in resident},
        "resident_differs_from_barrier": {
            n: not same(runs[n][0], runs["barrier_sparse"][0])
            for n in resident},
        "lattice_anneal_sharded_equals_unsharded": same(*anneals),
        "cd_step_2x2_equals_unsharded": cd_equal,
        "spins_are_pm1": all(bool((out[0].abs() == 1).all())
                             for out, _ in runs.values())}
    shapes = {n: (ses.backend, ses._engine.loop_shape)
              for n, ses in sessions.items()}

    # each K5 policy's Session call against the engine's emulation of the
    # same launches (K1 windows per band, the exchanges between them): the
    # engine code around K5 (the async halo priming, the drained halos,
    # the extended tables) held at full width.  Outside the driven run:
    # comparisons, not the path
    def emulation(sync):
        eng = dist.ShardedEngine(g, mesh, api.Partition(), "counter", 8, B,
                                 sync=sync, backend="fused_sparse",
                                 device=DEVICE, resident_exchange=False)
        return lambda: eng.sample(chip, st.m, st.noise_state,
                                  ses0.default_betas)

    emus = {n: emulation(policies[n][0]) for n in resident}
    checks["resident_equals_k1_windows"] = {
        n: same(runs[n][0], emus[n]()) for n in resident}

    # timings, outside the driven run: ms per call (25 launches of 4
    # sweeps) on the same inputs, alternating the two halves of a pair
    def call(ses):
        return lambda: ses.sample(chip, st.m, st.noise_state)

    emu = emus["k2_L4_barrier"]
    ab = {"k5": [], "k1_windows": []}
    for name in ("k1_windows", "k5", "k5", "k1_windows"):
        fn = emu if name == "k1_windows" else call(sessions["k2_L4_barrier"])
        ab[name].append(cuda_ms(fn))
    times = {"unsharded_k1": cuda_ms(call(ses0)),
             **{n: cuda_ms(call(ses)) for n, ses in sessions.items()}}
    out = {"phase": "sharded", "graph": "make_chimera(64, 64)",
           "N": g.n_nodes, "bands": SHARD_BANDS, "B": B,
           "S": SHARD_SWEEPS, "n_loc": sessions["inf_L4"].partition_plan.n_loc,
           "halo": sessions["inf_L4"].partition_plan.halo,
           "backend_and_loop_shape": shapes, "launches": counts,
           "launches_vs_plain_version": summary, "checks": checks,
           "energy_per_spin": per_spin,
           "cd_backends": [backend0, backend1],
           "ms_per_call": times,
           "k5_vs_k1_windows_ms_per_call": {
               k: float(np.mean(v)) for k, v in ab.items()},
           "k5_vs_k1_windows_runs": ab,
           "ab_order": "k1_windows, k5, k5, k1_windows"}
    emit(out)
    flat = [checks["barrier_equals_unsharded_k1"],
            checks["lattice_anneal_sharded_equals_unsharded"],
            checks["cd_step_2x2_equals_unsharded"], checks["spins_are_pm1"],
            *checks["resident_deterministic"].values(),
            *checks["resident_equals_k1_windows"].values(),
            *checks["resident_differs_from_barrier"].values()]
    if not all(flat):
        raise AssertionError(f"a sharded check failed: {checks}")
    want = {"barrier_sparse": ("sparse", "unrolled launch"),
            "k2_L4_barrier": ("fused_sparse", "fused-resident-exchange"),
            "k2_L4_async": ("fused_sparse", "fused-resident-exchange"),
            "inf_L4": ("fused_sparse", "fused")}
    if shapes != want:
        raise AssertionError(f"policies resolved to {shapes}, not {want}")
    n_k5 = 2 * len(resident) * SHARD_SWEEPS // 4
    if counts["sweep_sparse_exchange"] != n_k5:
        raise AssertionError(f"K5 launched {counts['sweep_sparse_exchange']}"
                             f" times, {n_k5} expected")
    if counts["sweep_sparse"] <= 0:
        raise AssertionError("the sharded path never launched K1")
    out["_worst"] = worst
    out["_times"] = {"k5_call_ms": float(np.mean(ab["k5"])),
                     "k1_windows_call_ms": float(np.mean(ab["k1_windows"])),
                     "fused_call_ms": times["inf_L4"]}
    return out, calls


# ---------------------------------------------------------------------------
# the kernel records
# ---------------------------------------------------------------------------
def _bound(moved: int, ops: int, int8_ops: int = 0) -> dict:
    """The roofline bound: bytes at the HBM rate against operations, each
    type at its own peak (``ops`` at the float32 rate, ``int8_ops`` at the
    int8 tensor-core rate; the two times add)."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = (ops / FP32_OPS_PER_S + int8_ops / INT8_TC_OPS_PER_S) * 1e3
    out = {"bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
           "bytes_moved": moved, "operations": ops}
    if int8_ops:
        out["int8_tensor_core_operations"] = int8_ops
    return out


def _moved(args, kwargs, outs) -> int:
    """Bytes of every tensor operand read once and every output written
    once."""
    return sum(t.numel() * t.element_size()
               for t in (*args, *kwargs.values(), *outs)
               if isinstance(t, torch.Tensor))


# per flip beyond eqn 1: the decision (bias add, offset add, two multiplies,
# tanhf counted as one, noise multiply, two adds, compare: 9), byte ->
# uniform (2) and the counter hash (row multiply, two xors, mix32's 8: 11);
# integer operations are charged at the fp32 rate, which flatters the card
DECISION_OPS, UNIFORM_OPS, HASH_OPS = 9, 2, 11


def kernel_record(checks: dict, path: dict, calls: list,
                  launches_by_path: dict) -> dict:
    """K1's record at the sample path's first launch: the counter-noise
    anneal, N=440, B=256, S=1000."""
    from repro_torch.kernels.sweep_fused import sweep_sparse

    args, kwargs, outs = calls[0]
    replay = path["launches_vs_plain_version"][0]
    Bc, n = args[0].shape
    S, D = args[10].shape[0], args[1].shape[0]
    ms = cuda_ms(lambda: sweep_sparse(*args, **kwargs))
    # D multiply-adds per flip (2D) on a Chimera chip
    ops = Bc * n * S * (2 * D + DECISION_OPS + UNIFORM_OPS + HASH_OPS)
    worst = max([checks["max_abs_diff"]]
                + [r["max_abs_diff"]
                   for r in path["launches_vs_plain_version"]])
    return {"name": "sweep_sparse", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep_sparse.cu",
            "replaces": "src/repro/kernels/sweep_fused.py:599",
            "launches": path["launches"]["sweep_sparse"],
            "launches_by_path": launches_by_path,
            "max_abs_err": worst,
            "ms": ms, "plain_ms": replay["plain_ms"],
            "device_ms": device_kernel_ms(
                lambda: sweep_sparse(*args, **kwargs), "sweep_sparse_kernel",
                3),
            **_bound(_moved(args, kwargs, outs), ops),
            "library_ms": None,
            "shape": {"N": n, "B": Bc, "S": S, "D": D,
                      "noise": kwargs["noise_mode"]}}


def dense_kernel_records(seed: int, dense_checks: list, train: dict,
                         train_calls: dict, work_calls: dict,
                         launches_by_path: dict,
                         worst_by_path: dict) -> list[dict]:
    """K2 and K3 records.  K3 at N=440, B=256, S=1000 (counter noise, no
    moments: the shape of K1's record); at the training path's CD phase
    (S=10, Gram), split into the sweeps and the statistics kernel; and at the workloads' tempering launch (B=16,
    S=10).  K2 at the training path's half-sweep, N=440, B=256.
    Operations: the dense 2·N per updated (chain, node) — on a Chimera chip
    K1 needs only 2·D of them for the same sum."""
    from repro_torch import api
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.kernels.pbit_update import (pbit_half_sweep,
                                                 pbit_half_sweep_ref)
    from repro_torch.kernels.sweep_fused import (card_limits, dense_plan,
                                                 resident_clusters,
                                                 sweep_fused, sweep_fused_ref)

    check_worst = {line["kernel"]: line["max_abs_diff"]
                   for line in dense_checks}
    path_worst = max(worst_by_path.values())
    limits = card_limits(DEVICE)

    def plan_of(args, kw):
        C = args[10].shape[1] if kw.get("noise_mode") == "lfsr" else 0
        plan = dense_plan(args[1].shape[0], args[0].shape[0], C, limits,
                          block_b=kw.get("block_b"),
                          resident=lambda p: resident_clusters(p, DEVICE))
        out = {"body": plan.body, "cluster_size": plan.cluster_size,
               "chains_per_cluster": plan.chains, "threads": plan.threads,
               "smem_bytes": plan.smem_bytes}
        if plan.body == "cluster":
            out["resident_clusters"] = resident_clusters(plan, DEVICE)
        return out

    # K3, the resident shape
    g = make_chip_graph()
    n = g.n_nodes
    S = 1000
    mach = PBitMachine.create(g, seed, noise="counter", device=DEVICE)
    ses = mach.session(schedule=api.Anneal(0.05, 3.0, n_sweeps=S), chains=B)
    rng = np.random.default_rng(seed + 200)
    J, h = sk_codes(g, rng)
    chip = ses.program(J.astype(np.int32), h.astype(np.int32))
    gen = ses.generator(seed + 3)
    args, kw = kernel_operands(ses, chip, gen, n_sweeps=S)
    args = dense_operands(args, chip)
    args[9] = ses.default_betas[:, None].expand(S, B).contiguous()
    outs = sweep_fused(*args, **kw)
    want, plain_ms = timed_once(lambda: sweep_fused_ref(*args, **kw))
    diff, spins = compare_outputs(outs, want)
    if diff != 0.0 or spins != 0:
        raise AssertionError("sweep_fused disagrees with its plain version "
                             "at the timed shape")
    ms = cuda_ms(lambda: sweep_fused(*args, **kw))
    m, W = args[0], args[1]
    matmul_ms = cuda_ms(lambda: [torch.matmul(m, W.T) for _ in range(2 * S)])
    ops = B * n * S * (2 * n + DECISION_OPS + UNIFORM_OPS + HASH_OPS)

    # K3, the CD phase shape: the training path's first positive phase
    cd_args, cd_kw, cd_outs = next(
        c for c in train_calls["sweep_fused"] if c[1].get("accumulate"))
    cd_fn = lambda: sweep_fused(*cd_args, **cd_kw)  # noqa: E731
    cd_ms = cuda_ms(cd_fn)
    # the same launch without moments: what the statistics cost
    no_moments = {k: v for k, v in cd_kw.items()
                  if k not in ("measured", "accumulate")}
    cd_sweeps_ms = cuda_ms(lambda: sweep_fused(*cd_args, **no_moments))
    _, cd_plain_ms = timed_once(lambda: sweep_fused_ref(*cd_args, **cd_kw))
    cd_B = cd_args[0].shape[0]
    cd_S = cd_args[9].shape[0]
    meas = int((cd_kw["measured"] != 0).sum())
    # the yardstick of the statistics kernel's Gram: one library product
    # per recorded sweep on the same shape (the port never calls it)
    cd_m = cd_outs[0]
    gram_matmul_ms = cuda_ms(
        lambda: [torch.matmul(cd_m.T, cd_m) for _ in range(meas)])
    # per measured sweep: s_sum's B·N adds and, for each of the Gram's
    # N(N+1)/2 distinct entries (mᵀm is symmetric), a multiply-add per
    # chain on the int8 tensor cores and the weighted float add (2)
    cd_ops = (cd_B * n * cd_S
              * (2 * n + DECISION_OPS + UNIFORM_OPS + HASH_OPS)
              + meas * (cd_B * n + n * (n + 1)))
    gram_ops = meas * cd_B * n * (n + 1)
    cd_device = device_kernel_ms(cd_fn, "k3_")
    cd_stats = device_kernel_ms(cd_fn, "k3_stats")

    # K3, the workloads' tempering launch: 16 replicas, S=10
    pt_args, pt_kw, _ = work_calls["sweep_fused"][0]
    pt_fn = lambda: sweep_fused(*pt_args, **pt_kw)  # noqa: E731

    k3 = {"name": "sweep_fused", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/sweep_fused.cu",
          "replaces": "src/repro/kernels/sweep_fused.py:545",
          "launches": train["launches"]["sweep_fused"],
          "launches_by_path": {p: c["sweep_fused"]
                               for p, c in launches_by_path.items()},
          "max_abs_err": max(check_worst["sweep_fused"],
                             check_worst["dense_vs_sparse"], diff,
                             path_worst),
          "ms": ms, "plain_ms": plain_ms,
          **_bound(_moved(args, kw, outs), ops),
          "library_ms": None,
          "matmul_ms": matmul_ms,
          "matmul_what": "torch.matmul(m, W.T) 2*S times: the product alone",
          "shape": {"N": n, "B": B, "S": S, "noise": "counter"},
          **plan_of(args, kw),
          "device_ms": device_kernel_ms(
              lambda: sweep_fused(*args, **kw), "k3_", 3),
          "cd_phase": {"S": cd_S, "measured_sweeps": meas, "ms": cd_ms,
                       "ms_without_moments": cd_sweeps_ms,
                       "device_ms": cd_device,
                       "stats_device_ms": cd_stats,
                       "gram_matmul_ms": gram_matmul_ms,
                       "gram_matmul_what": "torch.matmul(m.T, m) once per "
                                           "recorded sweep: a yardstick",
                       "plain_ms": cd_plain_ms, "clamped": True,
                       **plan_of(cd_args, cd_kw),
                       **_bound(_moved(cd_args, cd_kw, cd_outs), cd_ops,
                                gram_ops)},
          "tempering": {"B": pt_args[0].shape[0], "N": pt_args[1].shape[0],
                        "S": pt_args[9].shape[0], "ms": cuda_ms(pt_fn),
                        "device_ms": device_kernel_ms(pt_fn, "k3_"),
                        **plan_of(pt_args, pt_kw)}}

    # K2, the training path's half-sweep at N=440, B=256
    k2_args, k2_kw, k2_out = train_calls["pbit_half_sweep"][0]
    ms2 = cuda_ms(lambda: pbit_half_sweep(*k2_args, **k2_kw))
    _, plain2 = timed_once(lambda: pbit_half_sweep_ref(*k2_args, **k2_kw))
    m2, W2, mask2 = k2_args[0], k2_args[1], k2_args[7]
    n_upd = int(mask2.sum())
    ops2 = m2.shape[0] * n_upd * (2 * W2.shape[0] + DECISION_OPS)
    k2 = {"name": "pbit_half_sweep", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/pbit_update.cu",
          "replaces": "src/repro/kernels/pbit_update.py:76",
          "launches": train["launches"]["pbit_half_sweep"],
          "launches_by_path": {p: c["pbit_half_sweep"]
                               for p, c in launches_by_path.items()},
          "max_abs_err": max(check_worst["pbit_half_sweep"],
                             check_worst["dense_vs_sparse"], path_worst),
          "ms": ms2, "plain_ms": plain2,
          "device_ms": device_kernel_ms(
              lambda: pbit_half_sweep(*k2_args, **k2_kw),
              "pbit_half_sweep_kernel", 100),
          "ms_what": "one wrapper call, CUDA events around it: the host's "
                     "enqueue gap included, as the Python loop pays it",
          **_bound(_moved(k2_args, k2_kw, (k2_out,)), ops2),
          "library_ms": None,
          "matmul_ms": cuda_ms(lambda: torch.matmul(m2, W2.T)),
          "matmul_what": "torch.matmul(m, W.T) once: the product alone",
          "shape": {"N": W2.shape[0], "B": m2.shape[0],
                    "updated_nodes": n_upd}}
    return [k2, k3]


def stream_kernel_record(checks: dict, stream: dict, calls: dict,
                         launches_by_path: dict, worst: float) -> dict:
    """K4's record at the streaming path's first chain launch: N=440,
    B=256, S=100, counter noise.  Operations as K1's; the bytes include the
    next program read and the staged program written.  ``k1_ms`` is K1 on
    the same operands without the stage, timed in the same call."""
    from repro_torch.kernels.sweep_fused import (sweep_sparse,
                                                 sweep_sparse_stream,
                                                 sweep_sparse_stream_ref)

    args, kwargs, outs = calls["sweep_sparse_stream"][0]
    Bc, n = args[0].shape
    S, D = args[10].shape[0], args[1].shape[0]
    run = lambda: sweep_sparse_stream(*args, **kwargs)  # noqa: E731
    k1 = lambda: sweep_sparse(*args[:12], *args[14:16],  # noqa: E731
                              noise_mode=kwargs["noise_mode"])
    _, plain_ms = timed_once(
        lambda: sweep_sparse_stream_ref(*args, **kwargs))
    ops = Bc * n * S * (2 * D + DECISION_OPS + UNIFORM_OPS + HASH_OPS)
    times = {"k4": [], "k1": []}
    for name in ("k1", "k4", "k4", "k1"):
        times[name].append(cuda_ms(run if name == "k4" else k1))
    return {"name": "sweep_sparse_stream", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep_sparse.cu",
            "replaces": "src/repro/kernels/sweep_fused.py:662",
            "launches": stream["launches"]["sweep_sparse_stream"],
            "launches_by_path": launches_by_path,
            "max_abs_err": max(checks["max_abs_diff"], worst),
            "ms": float(np.mean(times["k4"])), "plain_ms": plain_ms,
            "device_ms": device_kernel_ms(run, "sweep_sparse_kernel", 3),
            **_bound(_moved(args, kwargs, outs), ops),
            "library_ms": None,
            "k1_ms": float(np.mean(times["k1"])), "ab_runs": times,
            "ab_order": "k1, k4, k4, k1",
            "staged_bytes": 4 * (outs[2].numel() + outs[3].numel()),
            "shape": {"N": n, "B": Bc, "S": S, "D": D, "noise": "counter"}}


def lattice_kernel_record(checks: dict, soa: dict, calls: dict,
                          launches_by_path: dict, worst: float) -> dict:
    """K6's record at the lattice_soa path's first launch: B=256, R=C=64,
    k=4.  Bound by bytes (six planes); operations per node: 2k for the
    in-cell sum, 4 for the vertical couplers, 1 for h, 1 for the gain,
    tanhf as 1, 1 add and 1 compare.  ``library_ms`` is the in-cell
    product alone as `torch.einsum`."""
    from repro_torch.kernels.lattice_update import (
        lattice_vertical_update, lattice_vertical_update_ref)

    args, kwargs, out = calls["lattice_vertical_update"][0]
    m_v, m_h, W_vh = args[0], args[1], args[4]
    k = m_v.shape[-1]
    run = lambda: lattice_vertical_update(*args, **kwargs)  # noqa: E731
    _, plain_ms = timed_once(
        lambda: lattice_vertical_update_ref(*args, **kwargs))
    return {"name": "lattice_vertical_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lattice_update.cu",
            "replaces": "src/repro/kernels/lattice_update.py:66",
            "launches": soa["launches"]["lattice_vertical_update"],
            "launches_by_path": launches_by_path,
            "max_abs_err": max(checks["max_abs_diff"], worst),
            "ms": cuda_ms(run), "plain_ms": plain_ms,
            "device_ms": device_kernel_ms(
                run, "lattice_vertical_update_kernel", 20),
            **_bound(_moved(args, kwargs, (out,)),
                     m_v.numel() * (2 * k + 9)),
            "library_ms": cuda_ms(
                lambda: torch.einsum("rcij,brcj->brci", W_vh, m_h)),
            "library_what": 'torch.einsum("rcij,brcj->brci", W_vh, m_h): '
                            "the in-cell product alone",
            "shape": {"B": m_v.shape[0], "R": m_v.shape[1],
                      "C": m_v.shape[2], "k": k}}


def exchange_kernel_record(checks: dict, shard: dict, calls: dict,
                           launches_by_path: dict, worst: float) -> dict:
    """K5's record at the sharded path's first launch: 8 bands of the
    32768-spin lattice, B=256, S=4, ``halo_every=2`` barrier (exchange
    points 0, 2, 4, 6).  Operations as K1's per update, over every band's
    local nodes once per sweep (n_row·B·n_loc·S updates, half the nodes in
    each half-sweep); bytes: the operands and outputs once.  The mailbox
    (each exchange writes and reads 2·B·H int8 per band) is this
    implementation's, not the function's, and stays out of the bound: it
    is reported beside it as ``mailbox_bytes``.
    ``emulation_ms`` / ``fused_shape_ms`` are per launch of the same path:
    the same 100-sweep schedule as K1 windows per band with the exchanges
    between them, and the launch-boundary policy (K1 per band, one
    exchange per launch)."""
    from repro_torch.kernels import sweep_fused
    from repro_torch.kernels.sweep_fused import (sweep_sparse_exchange,
                                                 sweep_sparse_exchange_ref)

    args, kwargs, outs = calls["sweep_sparse_exchange"][0]
    R, Bc, N = args[0].shape
    S, D = args[10].shape[0], args[1].shape[1]
    n_loc, H = kwargs["n_loc"], kwargs["halo"]
    n_ex = len(kwargs["ex_pts"])
    plain_kw = {k: v for k, v in kwargs.items() if k != "block_b"}
    run = lambda: sweep_sparse_exchange(*args, **kwargs)  # noqa: E731
    _, plain_ms = timed_once(lambda: sweep_sparse_exchange_ref(*args,
                                                               **plain_kw))
    ops = R * Bc * n_loc * S * (2 * D + DECISION_OPS + UNIFORM_OPS
                                + HASH_OPS)
    mailbox = n_ex * R * 2 * Bc * H * 2
    launches = shard["launches"]["sweep_sparse_exchange"]
    per_launch = SHARD_SWEEPS // S
    t = shard["_times"]
    return {"name": "sweep_sparse_exchange", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep_exchange.cu",
            "replaces": "src/repro/kernels/sweep_fused.py:953",
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max(checks["max_abs_diff"], worst),
            "ms": cuda_ms(run), "plain_ms": plain_ms,
            "device_ms": device_kernel_ms(run, "sweep_exchange_kernel", 20),
            **_bound(_moved(args, kwargs, outs), ops),
            "library_ms": None,
            "library_what": "none: no single PyTorch call computes it",
            "mailbox_bytes": mailbox,
            "session_ms_per_launch": t["k5_call_ms"] / per_launch,
            "emulation_ms_per_launch": t["k1_windows_call_ms"] / per_launch,
            "fused_shape_ms_per_launch": t["fused_call_ms"] / per_launch,
            "chains_per_block": [tb for key, tb in
                                 sweep_fused._EXCHANGE_TILES.items()
                                 if key[1:4] == (R, Bc, N)],
            "shape": {"bands": R, "B": Bc, "N_ext": N, "n_loc": n_loc,
                      "halo": H, "S": S, "D": D,
                      "ex_pts": list(kwargs["ex_pts"]),
                      "mode": kwargs.get("mode", "barrier")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.sweep_fused import H100, card_limits

    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    limits = card_limits(DEVICE)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-2].strip(),
          "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          # what the dense engine's tiling and feasibility model read here,
          # and whether it is the H100 model a CPU-resolved spec uses
          "card_limits": limits._asdict(),
          "card_limits_equal_h100_model": limits == H100})

    t0 = time.perf_counter()
    seconds = build.build_all()
    emit({"phase": "build", "seconds": seconds,
          "wall_seconds": time.perf_counter() - t0,
          "libraries": {n: str(build.library_path(n))
                        for n in build.LIBRARIES}})

    t_run = time.perf_counter()
    checks = check_kernels(args.seed)
    dense_checks = check_dense_kernels(args.seed)
    stream_checks = check_stream_kernel(args.seed)
    lattice_checks = check_lattice_kernel(args.seed)
    exchange_checks = check_exchange_kernel(args.seed)
    path, calls = main_path(args.seed)
    train, train_calls = training(args.seed)
    learn = learning(args.seed)
    work, work_calls = workloads(args.seed)
    stream, stream_calls = streaming(args.seed)
    soa, soa_calls = lattice_soa(args.seed)
    shard, shard_calls = sharded(args.seed)
    by_path = {"sample": path["launches"], "training": train["launches"],
               "learning": learn["launches"], "workloads": work["launches"],
               "streaming": stream["launches"], "lattice_soa": soa["launches"],
               "sharded": shard["launches"]}
    worst = {"training": train.pop("_worst"), "learning": learn.pop("_worst"),
             "workloads": work.pop("_worst"),
             "streaming": stream.pop("_worst"),
             "lattice_soa": soa.pop("_worst"),
             "sharded": shard.pop("_worst")}
    per_path = lambda k: {p: c[k] for p, c in by_path.items()}  # noqa: E731
    records = [kernel_record(checks, path, calls, per_path("sweep_sparse"))]
    records += dense_kernel_records(args.seed, dense_checks, train,
                                    train_calls, work_calls, by_path, worst)
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"],
                                    *worst.values())
    records.append(stream_kernel_record(
        stream_checks, stream, stream_calls, per_path("sweep_sparse_stream"),
        worst["streaming"]))
    records.append(lattice_kernel_record(
        lattice_checks, soa, soa_calls, per_path("lattice_vertical_update"),
        worst["lattice_soa"]))
    records.append(exchange_kernel_record(
        exchange_checks, shard, shard_calls,
        per_path("sweep_sparse_exchange"), worst["sharded"]))
    emit({"kernels": records})
    emit({"phase": "timing", "run_seconds": time.perf_counter() - t_run})

    print(smi, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
