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
  unsharded K1 Session bit for bit; two launch-resident policies and the
  launch-boundary policy run through the in-kernel halo exchange K5 (25
  launches a call; the last with one exchange point a launch) and equal
  the same launches emulated as K1 windows per band (K1 per band for the
  launch-boundary policy); the sharded lattice anneal and a CD step on a
  2x2 rows x chains mesh equal their unsharded runs;
* faults: `api.Faults` on the 440-spin chip (stuck spins, dead and
  saturated couplers) through K1 against the scan, through K3 and K2
  against ``ref``, a two-program K4 chain, the faulted 8-band lattice
  through K5, flips on the scan and on 2 bands; crash-safe CD of the full
  adder through K1, killed and resumed in processes of its own, bit for
  bit.

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
  {"phase": "faults", ...}         faulted chips on every kernel, resume
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


def device_kernel_ms(fn, kernel, repeats: int = 20):
    """Device time per call of the CUDA kernels whose name contains
    ``kernel`` (a string, or a tuple of strings any of which may match),
    from `torch.profiler` over ``repeats`` calls of ``fn`` (after a
    warm-up): the kernels alone, without the host's gaps between launches.
    Each kernel a call launches once counts its mean over the launches the
    profiler recorded (it may drop a few).  None when the profiler records
    no device time for them."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
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
        if any(n in evt.key for n in names) and evt.count:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0.0)) / evt.count
    return total / 1e3 if total > 0 else None


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


def clamp_colour0(args, graph, gen):
    """Clamp about a third of colour 0 only: the colour lists the kernel
    builds come out unequal."""
    dev = args[0].device
    color = torch.as_tensor(graph.color, device=dev)
    cm = (color == 0) & (torch.rand(graph.n_nodes, generator=gen,
                                    device=dev) < 0.33)
    args[12] = cm
    args[13] = torch.where(torch.rand(args[0].shape, generator=gen,
                                      device=dev) < 0.5, -1.0, 1.0)
    args[8], args[9] = (color == 0) & ~cm, (color == 1) & ~cm


def clamps_in_masks(args, graph, gen):
    """Clamps whose nodes the colour masks still update: the kernel must
    re-impose them at every sweep's start, as the plain version does."""
    dev = args[0].device
    color = torch.as_tensor(graph.color, device=dev)
    args[12] = torch.rand(graph.n_nodes, generator=gen, device=dev) < 0.1
    args[13] = torch.where(torch.rand(args[0].shape, generator=gen,
                                      device=dev) < 0.5, -1.0, 1.0)
    args[8], args[9] = color == 0, color == 1


def colour_overflow(args, graph, gen, moved: int = 12):
    """Colour 0 grows past the resident body's lanes: ``moved`` colour-1
    nodes join it, with their couplings to colour 0 set to zero (each mask
    stays an independent set of the nonzero couplings).  The kernel takes
    the ranks past its lanes from device memory."""
    dev = args[0].device
    color = torch.as_tensor(graph.color, device=dev)
    moved_mask = torch.zeros(graph.n_nodes, dtype=torch.bool, device=dev)
    moved_mask[torch.nonzero(color == 1)[:moved, 0]] = True
    idx, w = args[1].long(), args[2].clone()
    nbr_moved = moved_mask[idx]                       # (D, N)
    nbr_c0 = (color == 0)[idx]
    w[(moved_mask[None, :] & nbr_c0) | ((color == 0)[None, :] & nbr_moved)] = 0
    args[2] = w
    args[8], args[9] = (color == 0) | moved_mask, (color == 1) & ~moved_mask


def check_kernels(seed: int) -> dict:
    """K1 against `sweep_sparse_ref` on the card, mode by mode, through
    both bodies (`sparse_plan`): each case records the plan its launch ran
    (the wrapper's ``last_plan``) and fails if its body is not the one the
    case is there to reach.

    tanhf in the library equals torch.tanh bit for bit on this card (the
    probe below fails the run if that ever stops holding), and every
    statistic is an integer sum below 2^24, so the rule is equality:
    spins, noise state, s_sum, c_slots and hist must match exactly.
    """
    from repro_torch import api
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.core.cd import PBitMachine
    from repro_torch.kernels import sweep_fused as sf
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
                 block_b=None, windows=None, sparse=False, prepare=None,
                 expect=None):
        mach = PBitMachine.create(graph, gen, noise=noise, sparse=sparse,
                                  device=DEVICE)
        ses = mach.session(schedule=api.Constant(n_sweeps=S), chains=chains)
        chip = ses.program_master(rng.normal(size=graph.n_edges) * 40.0,
                                  rng.normal(size=graph.n_nodes) * 20.0)
        args, kw = kernel_operands(ses, chip, gen, n_sweeps=S,
                                   tempered=tempered, clamp=clamp)
        if prepare is not None:
            prepare(args, graph, gen)
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
        sweep_sparse.last_plan = None
        got = sweep_sparse(*args, *tail, block_b=block_b, **kw)
        plan = sweep_sparse.last_plan
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
                out = sweep_sparse(*w_args, *tail, half_offset=h0,
                                   n_half=nh, block_b=block_b, **kw)
                m_w, ns_w = out[0], out[1]
                parts = (list(out[2:]) if parts is None
                         else [p + o for p, o in zip(parts, out[2:])])
            torch.cuda.synchronize()
            d2, s2 = compare_outputs((m_w, ns_w, *parts), want)
            diff, spins = max(diff, d2), spins + s2
        results.append({"case": name, "noise": noise, "N": graph.n_nodes,
                        "B": chains, "body": plan.body, "tb": plan.chains,
                        "threads": plan.threads,
                        "expected_body": expect or plan.body,
                        "max_abs_diff": diff, "spins_differing": spins})

    chip_graph = make_chip_graph()          # 440 spins, one masked cell
    burn = (np.arange(S) >= 2).astype(np.float32)
    # the resident body's edges: every chains-per-block its plan can take
    # at N=440, and the largest N it takes / the smallest it leaves
    P440 = sf.resident_lanes(chip_graph.n_nodes)
    tb_max = min(sf.MAX_RESIDENT_CHAINS, sf.MAX_RESIDENT_THREADS // P440)
    largest = make_chimera(1, sf.MAX_RESIDENT_N // 8)
    past = make_chimera(1, sf.MAX_RESIDENT_N // 8 + 1)
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
                 measured=burn, expect="strided")
        # the main path's lattice sizes (sparse-native chips; 32768 spins
        # need more than 48 KB of shared memory per block)
        run_case("lattice_8192_moments", noise, make_chimera(32, 32), B,
                 measured=burn, sparse=True, expect="strided")
        run_case("lattice_32768", noise, make_chimera(64, 64), B,
                 sparse=True, expect="strided")
        for tb in range(1, tb_max + 1):
            run_case(f"resident_tb{tb}", noise, chip_graph, B, block_b=tb,
                     measured=burn, expect="resident")
        run_case(f"resident_ragged_B13_tb{tb_max}", noise, chip_graph, 13,
                 block_b=tb_max, measured=burn, clamp=True,
                 expect="resident")
        run_case("clamps_unequal_colours", noise, chip_graph, B,
                 measured=burn, prepare=clamp_colour0, expect="resident")
        run_case("window_odd_clamped", noise, chip_graph, B, measured=burn,
                 clamp=True, windows=[(0, 3), (3, 4), (7, 9)],
                 expect="resident")
        run_case("clamped_nodes_in_masks", noise, chip_graph, B,
                 measured=burn, prepare=clamps_in_masks, expect="resident")
        run_case("colour_overflow", noise, chip_graph, B, measured=burn,
                 prepare=colour_overflow, expect="resident")
        run_case(f"resident_largest_N{largest.n_nodes}", noise, largest, B,
                 measured=burn, sparse=True, expect="resident")
        run_case(f"strided_smallest_N{past.n_nodes}", noise, past, B,
                 measured=burn, sparse=True, expect="strided")
    run_case("coord_offset", "counter", chip_graph, B,
             coord_offset=(1000, 77), expect="resident")
    run_case("coord_offset_wrap", "counter", chip_graph, B,
             coord_offset=(2 ** 32 - 3, 2 ** 32 - 100))

    bad = [r for r in results
           if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0
           or r["body"] != r["expected_body"]]
    out = {"phase": "kernel_checks", "kernel": "sweep_sparse",
           "rule": "bit for bit (spins, noise state, s_sum, c_slots, hist); "
                   "each case in the body it is there to reach",
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

    # K2, one half-sweep per case, each in the plan (tile, body) it is
    # there to reach, read from the wrapper's `last_plan`
    k2 = []

    def k2_case(name, graph, chains, want_plan, *, per_chain_beta=False,
                random_mask=False, intra=False, dense=False, mask="colour",
                beta=None, cut=None):
        ses, chip = programmed(graph, "counter", chains)
        if intra:
            chip = intra_colour_chip(chip, gen)
        if dense:       # a dense Gaussian W: every term of eqn 1 nonzero
            chip = intra_colour_chip(chip, gen, scale=1.0)
        n = graph.n_nodes
        m = ses.random_spins(gen)
        W, rows = chip.W, [chip.h, chip.tanh_gain, chip.tanh_offset,
                           chip.rand_gain, chip.comp_offset]
        if cut is not None:      # N not a multiple of 4
            n = cut
            m, W = m[:, :n].contiguous(), W[:n, :n].contiguous()
            rows = [r[:n].contiguous() for r in rows]
        u = (torch.randint(0, 256, (chains, n), generator=gen, device=dev)
             .to(torch.float32) - 127.5) / 128.0
        color = torch.as_tensor(graph.color[:n], device=dev)
        upd = {"colour": color == 1,
               "random": torch.rand(n, generator=gen, device=dev) < 0.5,
               "none": torch.zeros(n, dtype=torch.bool, device=dev),
               "all": torch.ones(n, dtype=torch.bool, device=dev)}[
            "random" if random_mask else mask]
        if beta is None:
            beta = (0.2 + 1.6 * torch.rand(chains, generator=gen, device=dev)
                    if per_chain_beta else 0.8)
        ops_ = (m, W, *rows, upd, beta, u)
        want = pbit_half_sweep_ref(*ops_)
        got = pbit_half_sweep(*ops_)
        torch.cuda.synchronize()
        plan = pbit_half_sweep.last_plan
        diff, spins = compare_outputs((got,), (want,))
        k2.append({"case": name, "N": n, "B": chains,
                   "n_upd": int(upd.sum()), "max_abs_diff": diff,
                   "spins_differing": spins, **k2_plan_fields(plan),
                   "plan_wanted": list(want_plan)})

    schedule = torch.linspace(0.3, 2.0, 10, device=dev)
    # (body, list entries, chains) per block
    k2_case("scalar_beta", chip_graph, B, ("staged", 16, 32))
    k2_case("per_chain_beta", chip_graph, B, ("staged", 16, 32),
            per_chain_beta=True)
    k2_case("random_mask", chip_graph, B, ("staged", 16, 32),
            random_mask=True)
    k2_case("ragged_B37", chip_graph, 37, ("staged", 8, 8),
            per_chain_beta=True)
    k2_case("intra_colour_W", chip_graph, B, ("staged", 16, 32),
            random_mask=True, intra=True)
    k2_case("one_cell_N8", make_chimera(1, 1), 5, ("staged", 4, 8))
    k2_case("workloads_B32", chip_graph, 32, ("staged", 8, 8),
            beta=schedule[3])
    k2_case("B128", chip_graph, 128, ("staged", 16, 16))
    k2_case("B64", chip_graph, 64, ("staged", 8, 16))
    k2_case("dense_gaussian_W", chip_graph, B, ("staged", 16, 32),
            dense=True)
    k2_case("dense_gaussian_W_B32", chip_graph, 32, ("staged", 8, 8),
            dense=True)
    k2_case("schedule_view_beta", chip_graph, B, ("staged", 16, 32),
            beta=schedule[7])
    k2_case("strided_chain_beta", chip_graph, B, ("staged", 16, 32),
            beta=(0.2 + 1.6 * torch.rand((B, 3), generator=gen,
                                         device=dev))[:, 1])
    k2_case("empty_list", chip_graph, B, ("staged", 4, 8), mask="none")
    k2_case("full_list", chip_graph, B, ("staged", 16, 32), mask="all")
    # rows not 16-byte aligned: the tiled body's 4-byte copies
    k2_case("odd_N437", chip_graph, 32, ("tiled", 8, 8), cut=437)
    # the largest staged N at 256 chains is 1188 (PERF.md); 1152 stages
    # 48 rows whole, 1248 takes the double-buffered column tiles
    k2_case("staged_N1152", make_chimera(12, 12), B, ("staged", 16, 32))
    k2_case("tiled_N1248", make_chimera(13, 12), B, ("tiled", 16, 32))
    k2_case("tiled_N2048_B32", make_chimera(16, 16), 32, ("tiled", 16, 16))

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
    off_plan = [r for r in k2 if r["plan_wanted"]
                != [r["body"], r["nodes"], r["chains"]]]
    if off_plan:
        raise AssertionError(f"a K2 case ran outside its plan: {off_plan}")
    return lines


def k2_plan_fields(plan) -> dict:
    """A `HalfSweepPlan` as a record's fields."""
    return {"body": plan.body, "nodes": plan.nodes, "chains": plan.chains,
            "reg_tile": [plan.reg_nodes, plan.reg_chains],
            "threads": plan.threads, "grid": list(plan.grid),
            "smem_bytes": plan.smem_bytes}


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
             coord_offset=None, window=None, block_b=None, expect=None):
        ses, (chip, nxt) = programmed(graph, chains, sparse, 2)
        args, _ = kernel_operands(ses, chip, gen, n_sweeps=S, tempered=True,
                                  clamp=clamp)
        head, clamps = args[:12], args[12:]
        tail = [nxt.nbr_w, nxt.h, *clamps, coord_offset]
        kw = dict(window or {})
        want = sweep_sparse_stream_ref(*head, *tail, **kw)
        sweep_sparse_stream.last_plan = None
        got = sweep_sparse_stream(*head, *tail, block_b=block_b, **kw)
        plan = sweep_sparse_stream.last_plan
        torch.cuda.synchronize()
        diff, spins = compare_outputs(got, want)
        cases.append({"case": name, "N": graph.n_nodes, "B": chains,
                      "body": plan.body, "tb": plan.chains,
                      "threads": plan.threads,
                      "expected_body": expect or plan.body,
                      "max_abs_diff": diff, "spins_differing": spins})

    chip_graph = make_chip_graph()
    case("plain", chip_graph, B, expect="resident")
    case("clamped", chip_graph, B, clamp=True)
    case("coord_offset", chip_graph, B, coord_offset=(1000, 77))
    case("clamped_coord_offset", chip_graph, B, clamp=True,
         coord_offset=(2 ** 32 - 3, 2 ** 32 - 100))
    case("window", chip_graph, B, clamp=True,
         window=dict(half_offset=5, n_half=6))
    case("ragged_B5", chip_graph, 5, block_b=2)
    case("lattice_8192", make_chimera(32, 32), B, sparse=True,
         expect="strided")
    case("lattice_8192_clamped", make_chimera(32, 32), B, sparse=True,
         clamp=True)
    case("resident_ragged_B13_tb2_odd_window", chip_graph, 13, clamp=True,
         window=dict(half_offset=3, n_half=10), block_b=2,
         expect="resident")

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
           if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0
           or r.get("body") != r.get("expected_body")]
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
    wrapper call (args, kwargs, outputs) and the `ExchangePlan` it ran."""
    from repro_torch import api
    from repro_torch.core import distributed as dist
    from repro_torch.core.cd import PBitMachine
    from repro_torch.kernels import shard_sweep, sweep_fused

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
    return recorder.calls[0], sweep_fused.sweep_sparse_exchange.last_plan


def check_exchange_kernel(seed: int) -> dict:
    """K5 against `sweep_sparse_exchange_ref` on the card, barrier and
    async, case by case, each in the body it is there to reach (read from
    the wrapper's `last_plan`): the cluster body at 2 and 7 bands of the
    440-spin chip and at 8 and 16 bands of the 32768-spin lattice (plain,
    clamped, moments with a 0/1 burn-in mask, a staged next program,
    ``halo_every=3`` — windows that open and close on half sweeps — ragged
    B=5 with 2 chains per block, ``halo_every=inf`` — one exchange point);
    the mailbox body at 17 bands of the lattice (plain with moments, and
    ragged B=5).  Rule: equality in every output (spins with their halo
    columns, noise state, moments, staged program)."""
    from repro_torch.core.chimera import make_chimera, make_chip_graph

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    rng = np.random.default_rng(seed + 19)
    chip_graph, lattice_graph = make_chip_graph(), make_chimera(64, 64)
    cases = []
    for mode in ("barrier", "async"):
        for name, graph, bands, chains, body, kw in (
                ("plain_k1", chip_graph, 2, B, "cluster",
                 dict(halo_every=1, S=2)),
                ("clamped", chip_graph, 2, B, "cluster",
                 dict(halo_every=2, S=4, clamp=True)),
                ("moments", chip_graph, 2, B, "cluster",
                 dict(halo_every=2, S=4, moments=True)),
                ("moments_clamped", chip_graph, 2, B, "cluster",
                 dict(halo_every=4, S=4, moments=True, clamp=True)),
                ("stream", chip_graph, 2, B, "cluster",
                 dict(halo_every=2, S=4, stream=True)),
                ("odd_windows_k3", chip_graph, 2, B, "cluster",
                 dict(halo_every=3, S=4, moments=True, clamp=True)),
                ("ragged_B5", chip_graph, 2, 5, "cluster",
                 dict(halo_every=2, S=4, moments=True, block_b=2)),
                ("one_exchange_point", chip_graph, 2, B, "cluster",
                 dict(halo_every=math.inf, S=4, moments=True, clamp=True)),
                ("chip_7_bands", chip_graph, 7, B, "cluster",
                 dict(halo_every=2, S=4, moments=True)),
                ("lattice_32768_8_bands", lattice_graph, 8, B, "cluster",
                 dict(halo_every=2, S=4, sparse=True)),
                ("lattice_32768_8_bands_moments", lattice_graph, 8, B,
                 "cluster", dict(halo_every=2, S=4, sparse=True,
                                 moments=True, clamp=True)),
                ("lattice_32768_8_bands_one_exchange_point", lattice_graph,
                 8, B, "cluster", dict(halo_every=math.inf, S=4,
                                       sparse=True)),
                ("lattice_32768_16_bands", lattice_graph, 16, B, "cluster",
                 dict(halo_every=2, S=4, sparse=True, moments=True)),
                ("lattice_32768_17_bands", lattice_graph, 17, B, "mailbox",
                 dict(halo_every=2, S=4, sparse=True, moments=True)),
                ("lattice_32768_17_bands_ragged_B5", lattice_graph, 17, 5,
                 "mailbox", dict(halo_every=3, S=4, sparse=True,
                                 block_b=2))):
            (args, kwargs, got), plan = exchange_launch(
                graph, bands, chains, gen, rng, mode=mode, **kw)
            kwargs = {k: v for k, v in kwargs.items()
                      if k not in ("block_b", "prepared")}
            want = _plain("sweep_sparse_exchange")(*args, **kwargs)
            torch.cuda.synchronize()
            diff, spins = compare_outputs(got, want)
            cases.append({"case": name, "mode": mode, "N": graph.n_nodes,
                          "bands": bands, "B": chains,
                          "ex_pts": list(kwargs["ex_pts"]),
                          "body": plan.body, "want_body": body,
                          "cluster": plan.cluster, "chains": plan.chains,
                          "outputs": len(got), "max_abs_diff": diff,
                          "spins_differing": spins})
    out = {"phase": "kernel_checks", "kernel": "sweep_sparse_exchange",
           "rule": "bit for bit (spins incl. halo columns, noise state, "
                   "s_sum, c_slots, staged_w, staged_h), each case in its "
                   "body",
           "max_abs_diff": max(r["max_abs_diff"] for r in cases),
           "spins_differing": sum(r["spins_differing"] for r in cases),
           "bodies": sorted({r["body"] for r in cases}),
           "cases": cases}
    emit(out)
    wrong = [r["case"] for r in cases if r["body"] != r["want_body"]]
    if wrong:
        raise AssertionError(f"sweep_sparse_exchange ran outside the body a "
                             f"case is there to reach: {wrong}")
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
        # the plain versions have no tiling to choose and nothing to prepare
        kw = {k: v for k, v in kwargs.items()
              if k not in ("block_b", "prepared")}
        want, plain_ms = timed_once(lambda: plain(*args, **kw))
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        diff, spins = compare_outputs(got, want)
        row = {"N": args[0][0].numel(), "B": args[0].shape[0],
               "max_abs_diff": diff, "spins_differing": spins,
               "plain_ms": plain_ms}
        if name == "pbit_half_sweep":
            # the plan the launch ran: its preparation's
            plan = kwargs["prepared"].plan
            row["plan"] = [plan.body, plan.nodes, plan.chains]
        elif name == "sweep_sparse_exchange":
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
        if name == "pbit_half_sweep" and rows:
            plans = sorted({tuple(r["plan"]) for r in rows})
            summary[name]["plans"] = [list(p) for p in plans]
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
    (c) ``Sync(halo_every=inf, sweeps_per_launch=4)`` (loop shape
        "fused") runs each launch as one K5 launch with one exchange point,
        twice (equal), equal to its K1-per-band launches and different
        from (a);
    (d) `make_lattice_anneal` at 64x64 cells, 256 chains: 8 bands == 1;
    (e) one CD step of the full adder on the 440-spin chip on a 2x2
        rows x chains mesh (``fused_sparse``: K1 windows per band) equals
        the unsharded step.
    Every launch is replayed through its plain version.  Then, outside the
    driven run, each policy's call is timed, the barrier policy's against
    the same schedule as K1 windows per band (the emulation) and the
    launch-boundary policy's against its K1-per-band launches."""
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
    resident = ("k2_L4_barrier", "k2_L4_async", "inf_L4")   # through K5

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
    # same launches (K1 windows per band, the exchanges between them; K1
    # per band for inf_L4): the engine code around K5 (the async halo
    # priming, the drained halos, the extended block kept between
    # launches) held at full width.  Outside the driven run: comparisons,
    # not the path
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

    ab = {"k5": [], "k1_windows": [], "k5_one_point": [], "k1_per_band": []}
    for name in ("k1_windows", "k5", "k5", "k1_windows", "k1_per_band",
                 "k5_one_point", "k5_one_point", "k1_per_band"):
        fn = {"k1_windows": emus["k2_L4_barrier"],
              "k5": call(sessions["k2_L4_barrier"]),
              "k1_per_band": emus["inf_L4"],
              "k5_one_point": call(sessions["inf_L4"])}[name]
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
           "k5_vs_k1_ms_per_call": {
               k: float(np.mean(v)) for k, v in ab.items()},
           "k5_vs_k1_runs": ab,
           "ab_order": "k1_windows, k5, k5, k1_windows, k1_per_band, "
                       "k5_one_point, k5_one_point, k1_per_band"}
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
    n_k5 = 2 * len(resident) * SHARD_SWEEPS // 4    # each policy twice
    if counts["sweep_sparse_exchange"] != n_k5:
        raise AssertionError(f"K5 launched {counts['sweep_sparse_exchange']}"
                             f" times, {n_k5} expected")
    if counts["sweep_sparse"] <= 0:
        raise AssertionError("the sharded path never launched K1")
    out["_worst"] = worst
    out["_times"] = {"k5_call_ms": float(np.mean(ab["k5"])),
                     "k1_windows_call_ms": float(np.mean(ab["k1_windows"])),
                     "k5_one_point_call_ms": float(np.mean(
                         ab["k5_one_point"])),
                     "k1_per_band_call_ms": float(np.mean(
                         ab["k1_per_band"]))}
    return out, calls


# ---------------------------------------------------------------------------
# phase: faults and resilience
# ---------------------------------------------------------------------------
FAULT_RATES = dict(stuck_rate=0.02, dead_rate=0.02, saturated_rate=0.01)
RESILIENT_EPOCHS = 10  # full-adder CD epochs of the crash-safe run
KILL_AT = 7            # the killed run dies entering this epoch (after 6)
FAULT_SHARD_SWEEPS = 20  # the faulted 8-band lattice: 5 K5 launches of 4

# one crash-safe training run in a process of its own:
#   python -c <this> <ckpt_dir> <kill_at or -1> <seed>
_RESILIENT_RUN = """
import json, os, sys
sys.path.insert(0, {src!r})
from repro_torch import api
from repro_torch.core import tasks
from repro_torch.core.cd import CDConfig, PBitMachine, train_cd_resilient
from repro_torch.core.chimera import make_chip_graph
from repro_torch.kernels.sweep_fused import sweep_sparse

ckpt_dir, kill_at, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
g = make_chip_graph()
task = tasks.full_adder_task(g)
faults = api.sample_faults(seed + 520, g, exclude_nodes=task.visible_idx,
                           **{rates!r})
mach = PBitMachine.create(g, seed + 520, noise="counter",
                          backend="fused_sparse", device="cuda",
                          faults=faults)
cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains={B},
               epochs={epochs})

def maybe_kill(epoch):
    if epoch == kill_at:
        os._exit(3)     # a hard kill: no cleanup, no final save

sweep_sparse.launches = 0
res = train_cd_resilient(mach, task.visible_idx, task.target_dist, cfg,
                         seed + 521, ckpt_dir=ckpt_dir, save_every=3,
                         eval_every=cfg.epochs, on_epoch_start=maybe_kill)
print(json.dumps({{"J": res.J_edges.tolist(), "h": res.hm.tolist(),
                   "kl": res.kl_history[-1][1],
                   "k1_launches": sweep_sparse.launches}}))
"""


def _resilient_children(seed: int, root: Path) -> dict:
    """The crash-safe run three ways, each a process of its own: to the
    end; killed with ``os._exit(3)`` entering epoch KILL_AT; resumed from
    the killed run's checkpoints.  The first two run side by side."""
    code = _RESILIENT_RUN.format(src=str(ROOT / "src"), rates=FAULT_RATES,
                                 B=B, epochs=RESILIENT_EPOCHS)

    def start(name, kill_at):
        return subprocess.Popen(
            [sys.executable, "-c", code, str(root / name), str(kill_at),
             str(seed)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=ROOT)

    def finish(proc):
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        return proc.returncode, out, err

    procs = {"uninterrupted": start("clean", -1),
             "killed": start("crash", KILL_AT)}
    done = {name: finish(p) for name, p in procs.items()}
    from repro_torch.checkpoint import checkpoint as ckpt
    latest_after_kill = ckpt.latest_step(root / "crash")
    done["resumed"] = finish(start("crash", -1))
    runs = {"latest_step_after_kill": latest_after_kill}
    for name, (rc, out, err) in done.items():
        want = 3 if name == "killed" else 0
        if rc != want:
            raise AssertionError(f"the {name} training process exited {rc}, "
                                 f"not {want}: {err[-2000:]}")
        runs[name] = json.loads(out.strip().splitlines()[-1]) if rc == 0 \
            else None
    return runs


def faults_phase(seed: int) -> dict:
    """`api.Faults` compiled into every backend on the card, driven once
    (`drive`), every launch replayed through its plain version:

    (a) the 440-spin chip with `sample_faults` at 2 % stuck spins, 2 % dead
        and 1 % saturated couplers, counter noise, ``auto`` (->
        ``fused_sparse``, K1), 256 chains, an S=1000 anneal: the stuck
        spins hold in every chain, the dead couplers' ``nbr_w`` entries are
        0 and the saturated ones are the chip programmed at ±127; the spins
        equal ``sparse`` (the scan) bit for bit; the same with LFSR noise
        and stuck spins only;
    (b) the dense chip with the same faults through ``fused`` (K3) and
        ``pallas`` (K2), S=100, equal to ``ref``; one CD step on ``fused``
        equal to ``ref``'s, its faulty couplers' velocity 0;
    (c) crash-safe CD of the full adder on the 440-spin chip through
        ``fused_sparse``, 256 chains, 10 epochs, checkpoints every 3, the
        visible nodes kept fault-free: in this process with one injected
        `TransientError` (retried), and three times in processes of their
        own (uninterrupted, killed entering epoch 7, resumed from epoch
        6): all four end with the same master weights and KL, bit for bit,
        the dead and saturated couplers' weights exactly 0.0; the run's KL
        evaluation is one K1 histogram launch, stuck spins as the clamp;
    (d) a two-program chain through K4 on the faulted spec (stuck spins as
        the clamp) equals `sample_program` program by program;
    (e) the 64x64-cell lattice on 8 bands with stuck spins and dead
        couplers under ``Sync(halo_every=2, sweeps_per_launch=4)``
        (``auto`` -> K5); the 440-spin chip with flips on 2 bands under
        ``Sync()`` equals the unsharded scan bit for bit;
    (f) with flips ``auto`` resolves to ``sparse`` and an explicit
        ``fused_sparse`` raises; flips are equal on ``ref`` and ``sparse``.
    The launches of (c)'s own processes are counted there, not replayed:
    the driven run in this process makes the same launches, replayed, and
    the three runs must end where it does."""
    import tempfile

    from repro_torch import api
    from repro_torch.core import distributed as dist
    from repro_torch.core import energy, tasks
    from repro_torch.core.cd import (CDConfig, PBitMachine, make_cd_step,
                                     train_cd_resilient)
    from repro_torch.core.chimera import make_chimera, make_chip_graph
    from repro_torch.kernels import ops
    from repro_torch.runtime.fault_tolerance import TransientError

    t_phase = time.perf_counter()
    g = make_chip_graph()
    rng = np.random.default_rng(seed + 500)
    faults = api.sample_faults(seed + 500, g, **FAULT_RATES)
    stuck = torch.as_tensor(faults.stuck_nodes, device=DEVICE)
    stuck_v = torch.as_tensor(faults.stuck_values, dtype=torch.float32,
                              device=DEVICE)

    def holds(m):
        return bool((m[..., stuck] == stuck_v).all())

    anneal = api.Anneal(0.05, 3.0, n_sweeps=1000)
    mach = PBitMachine.create(g, seed + 500, noise="counter", device=DEVICE,
                              faults=faults)
    mach_lfsr = PBitMachine.create(
        g, seed + 502, noise="lfsr", device=DEVICE,
        faults=api.Faults(stuck_nodes=faults.stuck_nodes,
                          stuck_values=faults.stuck_values))
    sessions = {
        "counter": mach.session(schedule=anneal, chains=B),
        "counter_scan": dataclasses.replace(mach, backend="sparse").session(
            schedule=anneal, chains=B),
        "lfsr": mach_lfsr.session(schedule=anneal, chains=B),
        "lfsr_scan": dataclasses.replace(
            mach_lfsr, backend="sparse").session(schedule=anneal, chains=B),
        "healthy": dataclasses.replace(mach, faults=None).session(
            schedule=anneal, chains=B)}
    J_e, h_e = sk_edge_codes(g, rng)

    dense_sched = api.Anneal(0.05, 3.0, n_sweeps=100)
    J_d, h_d = sk_codes(g, rng)
    dense = {b: dataclasses.replace(mach, backend=b).session(
        schedule=dense_sched, chains=B) for b in ("fused", "pallas", "ref")}
    task = tasks.full_adder_task(g)
    cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B)

    res_task_faults = api.sample_faults(seed + 520, g,
                                        exclude_nodes=task.visible_idx,
                                        **FAULT_RATES)
    res_mach = PBitMachine.create(g, seed + 520, noise="counter",
                                  backend="fused_sparse", device=DEVICE,
                                  faults=res_task_faults)
    res_cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B,
                       epochs=RESILIENT_EPOCHS)

    prog_ses = mach.session(schedule=dense_sched, chains=B)
    prog_codes = [sk_edge_codes(g, rng) for _ in range(2)]

    g64 = make_chimera(64, 64)
    faults64 = api.sample_faults(seed + 530, g64, stuck_rate=0.02,
                                 dead_rate=0.02)
    mach64 = PBitMachine.create(g64, seed + 530, sparse=True,
                                noise="counter", device=DEVICE,
                                faults=faults64)
    shard_sched = api.Anneal(0.05, 3.0, n_sweeps=FAULT_SHARD_SWEEPS)
    policy = api.Sync(halo_every=2, sweeps_per_launch=4)
    ses64 = api.Session(mach64.sampler_spec(
        schedule=shard_sched, chains=B,
        mesh=dist.make_mesh((SHARD_BANDS,), ("data",)), sync=policy))
    stuck64 = torch.as_tensor(faults64.stuck_nodes, device=DEVICE)
    stuck64_v = torch.as_tensor(faults64.stuck_values, dtype=torch.float32,
                                device=DEVICE)

    flip_faults = api.Faults(stuck_nodes=faults.stuck_nodes,
                             stuck_values=faults.stuck_values,
                             dead_edges=faults.dead_edges,
                             flip_prob=0.05, flip_seed=seed + 540)
    mach_flip = dataclasses.replace(mach, faults=flip_faults)
    flip_sched = api.Anneal(0.05, 3.0, n_sweeps=20)
    flips = {"auto": mach_flip.session(schedule=flip_sched, chains=B),
             "ref": dataclasses.replace(mach_flip, backend="ref").session(
                 schedule=flip_sched, chains=B),
             "two_bands": api.Session(mach_flip.sampler_spec(
                 schedule=flip_sched, chains=B,
                 mesh=dist.make_mesh((2,), ("data",)), sync=api.Sync()))}

    def chip_checks(ses, chip):
        """Dead couplers 0 in both views; saturated ones as programmed at
        full scale on the healthy chip."""
        ix = lambda a: torch.as_tensor(a, device=DEVICE)  # noqa: E731
        _, _, slot_ij, slot_ji = map(ix, mach.neighbor_tables())
        e = ix(g.edges)
        dead = ix(np.asarray(faults.dead_edges, np.int64))
        sat_np = np.asarray(faults.saturated_edges, np.int64)
        sat = ix(sat_np)
        full = J_e.copy()
        full[sat_np] = np.where(J_e[sat_np] < 0, -127, 127)
        want = sessions["healthy"].program_edges(full, h_e)
        out = {"dead_nbr_w_zero": bool(
            (chip.nbr_w[slot_ij[dead], e[dead, 0]] == 0).all()
            and (chip.nbr_w[slot_ji[dead], e[dead, 1]] == 0).all()),
            "dead_W_zero": bool((chip.W[e[dead, 0], e[dead, 1]] == 0).all()),
            "saturated_equal_full_scale": bool(
                torch.equal(chip.nbr_w[slot_ij[sat], e[sat, 0]],
                            want.nbr_w[slot_ij[sat], e[sat, 0]])
                and torch.equal(chip.W[e[sat, 0], e[sat, 1]],
                                want.W[e[sat, 0], e[sat, 1]]))}
        return out

    def path():
        out = {}
        # (a) the 440-spin chip, K1 against the scan
        for noise in ("counter", "lfsr"):
            ses, scan = sessions[noise], sessions[noise + "_scan"]
            chip = ses.program_edges(J_e, h_e)
            st = ses.init_state(ses.generator(seed + 501))
            m, ns, _ = ses.sample(chip, st.m, st.noise_state)
            m_s, ns_s, _ = scan.sample(scan.program_edges(J_e, h_e), st.m,
                                       st.noise_state)
            out[noise] = {"backend": [ses.backend, scan.backend],
                          "stuck_hold": holds(m),
                          "equal_to_scan": bool(torch.equal(m, m_s)
                                                and torch.equal(ns, ns_s)),
                          "spins_pm1": bool((m.abs() == 1).all())}
            if noise == "counter":
                out[noise].update(chip_checks(ses, chip))
                out["_k1"] = (ses, chip, st)
        # (b) the dense chip through K3 and K2, against ref
        st = dense["ref"].init_state(dense["ref"].generator(seed + 511))
        runs = {b: s.sample(s.program(J_d, h_d), st.m, st.noise_state)
                for b, s in dense.items()}
        steps = {}
        for b in ("fused", "ref"):
            step = make_cd_step(dataclasses.replace(mach, backend=b), cfg,
                                task.visible_idx)
            ses = dense[b]
            gen = ses.generator(seed + 512)
            data = torch.as_tensor(energy.all_states(len(task.visible_idx)),
                                   dtype=torch.float32, device=DEVICE)[
                torch.multinomial(torch.as_tensor(
                    task.target_dist, device=DEVICE), B, replacement=True,
                    generator=gen)]
            Jm = torch.randn(g.n_edges, generator=gen, device=DEVICE) * 20.0
            hm = torch.zeros(g.n_nodes, device=DEVICE)
            vel = (torch.zeros_like(Jm), torch.zeros_like(hm))
            steps[b] = (step(Jm, hm, data, st.m, st.noise_state, vel), Jm)
        bad = list(faults.faulty_edges)
        (cd_f, Jm0), (cd_r, _) = steps["fused"], steps["ref"]
        out["dense"] = {
            "backends": {b: s.backend for b, s in dense.items()},
            "equal_to_ref": {b: bool(torch.equal(runs[b][0], runs["ref"][0])
                                     and torch.equal(runs[b][1],
                                                     runs["ref"][1]))
                             for b in ("fused", "pallas")},
            "stuck_hold": all(holds(r[0]) for r in runs.values()),
            "cd_step_fused_equals_ref": all(
                bool(torch.equal(a, b)) for a, b in zip(
                    (*cd_f[:4], *cd_f[4]), (*cd_r[:4], *cd_r[4]))),
            "cd_faulty_couplers_unmoved": bool(
                torch.equal(cd_f[0][bad], Jm0[bad])
                and (cd_f[4][0][bad] == 0).all()),
            "cd_stuck_hold": holds(cd_f[2])}
        # (c) crash-safe CD, in this process with one retried error
        left = {"errors": 1}

        def hiccup(epoch):
            if epoch == 4 and left["errors"]:
                left["errors"] -= 1
                raise TransientError("injected")

        with tempfile.TemporaryDirectory() as tmp:
            res = train_cd_resilient(
                res_mach, task.visible_idx, task.target_dist, res_cfg,
                seed + 521, ckpt_dir=tmp, save_every=3,
                eval_every=res_cfg.epochs, on_epoch_start=hiccup,
                backoff_s=0.0, sleep=lambda s: None)
        out["resilient_in_process"] = {"J": res.J_edges.tolist(),
                                       "h": res.hm.tolist(),
                                       "kl": res.kl_history[-1][1],
                                       "transient_errors_left":
                                           left["errors"]}
        # (d) a two-program chain through K4 against sample_program
        st = prog_ses.init_state(prog_ses.generator(seed + 513))
        progs = [prog_ses.make_program(J, h) for J, h in prog_codes]
        m_seq, ns_seq = st.m, st.noise_state
        for prog in progs:
            m_seq, ns_seq, _ = prog_ses.sample_program(prog, m_seq, ns_seq)
        chips = [prog_ses.program_edges(J, h) for J, h in prog_codes]
        cm = torch.zeros(g.n_nodes, dtype=torch.bool, device=DEVICE)
        cm[stuck] = True
        m_c = st.m.clone()
        m_c[:, stuck] = stuck_v
        ns_c = st.noise_state
        color = torch.as_tensor(g.color, device=DEVICE)
        w, h = chips[0].nbr_w, chips[0].h
        for i, chip in enumerate(chips):
            nxt = chips[(i + 1) % 2]
            m_c, ns_c, w, h = ops.stream_sweeps(
                m_c, dataclasses.replace(chip, nbr_w=w, h=h), color,
                prog_ses.default_betas, ns_c, prog_ses._noise_step.spec,
                nxt.nbr_w, nxt.h, clamp_mask=cm)
        out["programs"] = {"chain_equals_sample_program": bool(
            torch.equal(m_c, m_seq) and torch.equal(ns_c, ns_seq)),
            "stuck_hold": holds(m_c)}
        # (e) sharded: K5 with stuck spins and dead couplers; flips on 2 bands
        chip64 = ses64.program_edges(*sk_edge_codes(g64, rng))
        st = ses64.init_state(ses64.generator(seed + 531))
        m64, _, _ = ses64.sample(chip64, st.m, st.noise_state)
        st = flips["auto"].init_state(flips["auto"].generator(seed + 541))
        chip_f = flips["auto"].program_edges(J_e, h_e)
        one = flips["auto"].sample(chip_f, st.m, st.noise_state)
        two = flips["two_bands"].sample(chip_f, st.m, st.noise_state)
        ref = flips["ref"].sample(flips["ref"].program_edges(J_e, h_e), st.m,
                                  st.noise_state)
        healthy = dataclasses.replace(   # the same faults without flips
            mach_flip, faults=dataclasses.replace(flip_faults, flip_prob=0.0),
            backend="sparse").session(schedule=flip_sched, chains=B)
        m_h, _, _ = healthy.sample(healthy.program_edges(J_e, h_e), st.m,
                                   st.noise_state)
        out["sharded"] = {
            "backend_and_loop_shape": [ses64.backend,
                                       ses64._engine.loop_shape],
            "stuck_hold": bool((m64[:, stuck64] == stuck64_v).all()),
            "flips_two_bands_equal_unsharded": bool(
                torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])),
            "flips_two_bands_backend": flips["two_bands"].backend,
            "flips_stuck_hold": holds(two[0])}
        # (f) host hooks
        try:
            api.Session(mach_flip.sampler_spec(
                schedule=flip_sched, chains=B).replace(
                    backend="fused_sparse"))
            raised = False
        except ValueError:
            raised = True
        out["host_hooks"] = {
            "auto_backend": flips["auto"].backend,
            "explicit_fused_sparse_raises": raised,
            "flips_ref_equal_sparse": bool(torch.equal(one[0], ref[0])
                                           and torch.equal(one[1], ref[1])),
            "flips_act": not bool(torch.equal(one[0], m_h))}
        return out

    out, counts, calls = drive(path)
    summary, worst = replay_all(calls)
    # the crash-safe run's KL evaluation (its only histogram) is a K1
    # launch with the stuck spins out of both colour masks, replayed above
    res_stuck = list(res_task_faults.stuck_nodes)
    hist_calls = [(a, kw) for a, kw, _ in calls["sweep_sparse"]
                  if kw.get("collect_hist")]
    eval_k1 = {"hist_launches": len(hist_calls),
               "stuck_out_of_masks": all(
                   not bool(a[8][res_stuck].any() or a[9][res_stuck].any())
                   for a, _ in hist_calls)}
    k1_ses, k1_chip, k1_st = out.pop("_k1")
    with tempfile.TemporaryDirectory() as tmp:
        children = _resilient_children(seed, Path(tmp))
    inproc = out.pop("resilient_in_process")
    res_bad = list(res_task_faults.faulty_edges)
    resilient = {
        "epochs": RESILIENT_EPOCHS, "save_every": 3, "kill_at": KILL_AT,
        "latest_step_after_kill": children["latest_step_after_kill"],
        "resumed_equals_uninterrupted": all(
            children["resumed"][k] == children["uninterrupted"][k]
            for k in ("J", "h", "kl")),
        "in_process_equals_uninterrupted": all(
            inproc[k] == children["uninterrupted"][k]
            for k in ("J", "h", "kl")),
        "transient_error_retried": inproc["transient_errors_left"] == 0,
        "faulty_couplers_exactly_zero": all(
            inproc["J"][q] == 0.0 and children["resumed"]["J"][q] == 0.0
            for q in res_bad),
        "n_faulty_couplers": len(res_bad),
        "kl": inproc["kl"],
        "evaluation_k1": eval_k1,
        "k1_launches_in_child_processes": {
            k: children[k]["k1_launches"]
            for k in ("uninterrupted", "resumed")}}

    # K1's device time on the faulted chip and the healthy one, in turns
    healthy = sessions["healthy"]
    h_chip = healthy.program_edges(J_e, h_e)
    k1_ms = {"faulted": [], "healthy": []}
    for name in ("healthy", "faulted", "faulted", "healthy"):
        ses, chip = ((k1_ses, k1_chip) if name == "faulted"
                     else (healthy, h_chip))
        k1_ms[name].append(device_kernel_ms(
            lambda: ses.sample(chip, k1_st.m, k1_st.noise_state),
            K1_KERNELS, 20))
    seconds = time.perf_counter() - t_phase
    result = {"phase": "faults", "graph": "make_chip_graph", "N": g.n_nodes,
              "B": B, "rates": FAULT_RATES,
              "faults": {"stuck": len(faults.stuck_nodes),
                         "dead": len(faults.dead_edges),
                         "saturated": len(faults.saturated_edges)},
              "launches": counts, "launches_vs_plain_version": summary,
              **out, "resilient": resilient,
              "k1_device_ms": k1_ms, "k1_ab_order":
                  "healthy, faulted, faulted, healthy (S=1000, counter)",
              "seconds": seconds}
    emit(result)
    flat = [out["counter"]["stuck_hold"], out["counter"]["equal_to_scan"],
            out["counter"]["spins_pm1"], out["counter"]["dead_nbr_w_zero"],
            out["counter"]["dead_W_zero"],
            out["counter"]["saturated_equal_full_scale"],
            out["lfsr"]["stuck_hold"], out["lfsr"]["equal_to_scan"],
            *out["dense"]["equal_to_ref"].values(),
            out["dense"]["stuck_hold"],
            out["dense"]["cd_step_fused_equals_ref"],
            out["dense"]["cd_faulty_couplers_unmoved"],
            out["dense"]["cd_stuck_hold"],
            *out["programs"].values(),
            out["sharded"]["stuck_hold"],
            out["sharded"]["flips_two_bands_equal_unsharded"],
            out["sharded"]["flips_stuck_hold"],
            out["host_hooks"]["explicit_fused_sparse_raises"],
            out["host_hooks"]["flips_ref_equal_sparse"],
            out["host_hooks"]["flips_act"],
            resilient["latest_step_after_kill"] == KILL_AT - 1,
            resilient["resumed_equals_uninterrupted"],
            resilient["in_process_equals_uninterrupted"],
            resilient["transient_error_retried"],
            resilient["faulty_couplers_exactly_zero"],
            eval_k1["hist_launches"] == 1, eval_k1["stuck_out_of_masks"]]
    if not all(flat):
        raise AssertionError(f"a faults check failed: {result}")
    want = {"counter": ["fused_sparse", "sparse"],
            "lfsr": ["fused_sparse", "sparse"]}
    if {k: out[k]["backend"] for k in want} != want:
        raise AssertionError("the faulted chip did not resolve to K1")
    if out["dense"]["backends"] != {"fused": "fused", "pallas": "pallas",
                                    "ref": "ref"}:
        raise AssertionError(f"dense backends {out['dense']['backends']}")
    if out["sharded"]["backend_and_loop_shape"] != [
            "fused_sparse", "fused-resident-exchange"] or \
            out["sharded"]["flips_two_bands_backend"] != "sparse" or \
            out["host_hooks"]["auto_backend"] != "sparse":
        raise AssertionError(f"faulted specs resolved wrongly: {result}")
    for k in ("sweep_sparse", "pbit_half_sweep", "sweep_fused"):
        if counts[k] <= 0:
            raise AssertionError(f"the faults path never launched {k}")
    if counts["sweep_sparse_stream"] != 2:
        raise AssertionError("the program chain did not run two K4 launches")
    if counts["sweep_sparse_exchange"] != FAULT_SHARD_SWEEPS // 4:
        raise AssertionError(f"K5 launched {counts['sweep_sparse_exchange']}"
                             f" times, {FAULT_SHARD_SWEEPS // 4} expected")
    result["_worst"] = worst
    return result


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


def k2_moved(m, W, n_upd: int, beta) -> int:
    """Bytes one dense half-sweep must move: the W rows of the ``n_upd``
    updated nodes, their five per-node rows and list entries, u at the
    updated nodes, beta, and the spins read and written whole (the kept
    ones are copied)."""
    B, N = m.shape
    n_beta = beta.numel() if isinstance(beta, torch.Tensor) else 1
    return 4 * (n_upd * N + 6 * n_upd + B * n_upd + 2 * B * N + n_beta)


# K1's and K4's kernels as the profiler names them: either body, and the
# reduction of the per-block moment partials where moments are taken
K1_KERNELS = ("sweep_sparse_kernel", "reduce_partials")


def sparse_plan_of(args, kwargs):
    """The `sparse_plan` a recorded K1 / K4 launch ran under."""
    from repro_torch.kernels.sweep_fused import card_limits, sparse_plan

    m, noise = args[0], args[11]
    mode = kwargs.get("noise_mode", "counter")
    return sparse_plan(m.shape[1], m.shape[0], args[1].shape[0],
                       noise.shape[-1] if mode == "lfsr" else 0, mode,
                       card_limits(m.device), kwargs.get("block_b"))


def kernel_record(checks: dict, path: dict, calls: list,
                  launches_by_path: dict) -> dict:
    """K1's record at the sample path's first launch: the counter-noise
    anneal, N=440, B=256, S=1000."""
    from repro_torch.kernels.sweep_fused import sweep_sparse

    args, kwargs, outs = calls[0]
    replay = path["launches_vs_plain_version"][0]
    Bc, n = args[0].shape
    S, D = args[10].shape[0], args[1].shape[0]
    plan = sparse_plan_of(args, kwargs)
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
                lambda: sweep_sparse(*args, **kwargs), K1_KERNELS, 3),
            **_bound(_moved(args, kwargs, outs), ops),
            "library_ms": None,
            "body": plan.body, "tb": plan.chains, "threads": plan.threads,
            "shape": {"N": n, "B": Bc, "S": S, "D": D,
                      "noise": kwargs["noise_mode"]}}


def dense_kernel_records(seed: int, dense_checks: list, train: dict,
                         train_calls: dict, work_calls: dict,
                         launches_by_path: dict,
                         worst_by_path: dict) -> list[dict]:
    """K2 and K3 records.  K3 at N=440, B=256, S=1000 (counter noise, no
    moments: the shape of K1's record); at the training path's CD phase
    (S=10, Gram), split into the sweeps and the statistics kernel; and at the workloads' tempering launch (B=16,
    S=10).  K2 at the training path's half-sweep, N=440, B=256, and at
    the workloads' (the anneal's first), B=32, each with its plan.
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

    # K2 at the training path's half-sweep (N=440, B=256) and at the
    # workloads' (anneal, B=32)
    def k2_shape(call):
        args, kw, out = call
        plain_kw = {k: v for k, v in kw.items() if k != "prepared"}
        run = lambda: pbit_half_sweep(*args, **kw)  # noqa: E731
        _, plain = timed_once(lambda: pbit_half_sweep_ref(*args, **plain_kw))
        m2, W2, mask2 = args[0], args[1], args[7]
        n_upd = int(mask2.sum())
        ops2 = m2.shape[0] * n_upd * (2 * W2.shape[0] + DECISION_OPS)
        return {"ms": cuda_ms(run), "plain_ms": plain,
                "device_ms": device_kernel_ms(run, "pbit_half_sweep_kernel",
                                              100),
                **_bound(k2_moved(m2, W2, n_upd, args[8]), ops2),
                "matmul_ms": cuda_ms(lambda: torch.matmul(m2, W2.T)),
                "shape": {"N": W2.shape[0], "B": m2.shape[0],
                          "updated_nodes": n_upd},
                **k2_plan_fields(kw["prepared"].plan)}

    k2 = {"name": "pbit_half_sweep", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/pbit_update.cu",
          "replaces": "src/repro/kernels/pbit_update.py:76",
          "launches": train["launches"]["pbit_half_sweep"],
          "launches_by_path": {p: c["pbit_half_sweep"]
                               for p, c in launches_by_path.items()},
          "max_abs_err": max(check_worst["pbit_half_sweep"],
                             check_worst["dense_vs_sparse"], path_worst),
          **k2_shape(train_calls["pbit_half_sweep"][0]),
          "ms_what": "one wrapper call through the sweep function's "
                     "preparation, CUDA events around it: the host's "
                     "enqueue gap included, as the Python loop pays it",
          "library_ms": None,
          "matmul_what": "torch.matmul(m, W.T) once: the product alone",
          "workloads_B32": k2_shape(work_calls["pbit_half_sweep"][0])}
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
    plan = sparse_plan_of(args, kwargs)
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
            "device_ms": device_kernel_ms(run, K1_KERNELS, 3),
            **_bound(_moved(args, kwargs, outs), ops),
            "library_ms": None,
            "body": plan.body, "tb": plan.chains, "threads": plan.threads,
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


K5_KERNELS = ("sweep_exchange_kernel", "sweep_exchange_cluster_kernel",
              "reduce_band_partials")   # the mailbox body, the cluster body


def exchange_kernel_record(checks: dict, shard: dict, calls: dict,
                           launches_by_path: dict, worst: float) -> dict:
    """K5's record at the sharded path's first launch: 8 bands of the
    32768-spin lattice, B=256, S=4, ``halo_every=2`` barrier (exchange
    points 0, 2, 4, 6), in the body, cluster size and chains per block of
    its plan.  Operations as K1's per update, over every band's local
    nodes once per sweep (n_row·B·n_loc·S updates, half the nodes in each
    half-sweep); bytes: the operands and outputs once (the boundary rows
    each exchange moves are this implementation's, not the function's, and
    stay out of the bound).  The ``*_ms_per_launch``
    are per launch of the same path's Session calls (25 launches): K5 and
    the same schedule as K1 windows per band, and the launch-boundary
    policy through K5 (one exchange point) and as K1 per band."""
    from repro_torch.kernels.sweep_fused import (sweep_sparse_exchange,
                                                 sweep_sparse_exchange_ref)

    args, kwargs, outs = calls["sweep_sparse_exchange"][0]
    plan = kwargs["prepared"].plan
    R, Bc, N = args[0].shape
    S, D = args[10].shape[0], args[1].shape[1]
    n_loc, H = kwargs["n_loc"], kwargs["halo"]
    plain_kw = {k: v for k, v in kwargs.items()
                if k not in ("block_b", "prepared")}
    run = lambda: sweep_sparse_exchange(*args, **kwargs)  # noqa: E731
    _, plain_ms = timed_once(lambda: sweep_sparse_exchange_ref(*args,
                                                               **plain_kw))
    ops = R * Bc * n_loc * S * (2 * D + DECISION_OPS + UNIFORM_OPS
                                + HASH_OPS)
    moved = _moved(args, {k: v for k, v in kwargs.items()
                          if k != "prepared"}, outs)
    launches = shard["launches"]["sweep_sparse_exchange"]
    per_launch = SHARD_SWEEPS // S
    t = shard["_times"]
    return {"name": "sweep_sparse_exchange", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep_exchange.cu",
            "replaces": "src/repro/kernels/sweep_fused.py:953",
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max(checks["max_abs_diff"], worst),
            "ms": cuda_ms(run), "plain_ms": plain_ms,
            "device_ms": device_kernel_ms(run, K5_KERNELS, 20),
            **_bound(moved, ops),
            "library_ms": None,
            "library_what": "none: no single PyTorch call computes it",
            "body": plan.body, "cluster": plan.cluster,
            "chains_per_block": plan.chains,
            "session_ms_per_launch": t["k5_call_ms"] / per_launch,
            "emulation_ms_per_launch": t["k1_windows_call_ms"] / per_launch,
            "one_point_ms_per_launch": t["k5_one_point_call_ms"] / per_launch,
            "k1_per_band_ms_per_launch": (t["k1_per_band_call_ms"]
                                          / per_launch),
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
    fault = faults_phase(args.seed)
    by_path = {"sample": path["launches"], "training": train["launches"],
               "learning": learn["launches"], "workloads": work["launches"],
               "streaming": stream["launches"], "lattice_soa": soa["launches"],
               "sharded": shard["launches"], "faults": fault["launches"]}
    worst = {"training": train.pop("_worst"), "learning": learn.pop("_worst"),
             "workloads": work.pop("_worst"),
             "streaming": stream.pop("_worst"),
             "lattice_soa": soa.pop("_worst"),
             "sharded": shard.pop("_worst"), "faults": fault.pop("_worst")}
    per_path = lambda k: {p: c[k] for p, c in by_path.items()}  # noqa: E731
    records = [kernel_record(checks, path, calls, per_path("sweep_sparse"))]
    records += dense_kernel_records(args.seed, dense_checks, train,
                                    train_calls, work_calls, by_path, worst)
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"],
                                    *worst.values())
    records.append(stream_kernel_record(
        stream_checks, stream, stream_calls, per_path("sweep_sparse_stream"),
        max(worst["streaming"], worst["faults"])))
    records.append(lattice_kernel_record(
        lattice_checks, soa, soa_calls, per_path("lattice_vertical_update"),
        worst["lattice_soa"]))
    records.append(exchange_kernel_record(
        exchange_checks, shard, shard_calls,
        per_path("sweep_sparse_exchange"),
        max(worst["sharded"], worst["faults"])))
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
