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
  bit;
* psl: the PSL compiler on the 440-spin chip graph through K1's clamp path
  (`psl.compile_circuit` -> `CompiledCircuit.run_*`, one clamped K1 launch
  a run): AND forward and inverse, the 2-bit ripple adder forward and
  inverse, `tasks.full_adder_inference`, and factorization with the 2-bit
  multiplier at 128 chains and 800 sweeps;
* serve: the multi-tenant sampling service (`repro_torch.serve`) at 256
  chains: 32 tenants' clamped requests on the 440-spin chip graph,
  embedded into the 7x8 bucket (one K1 launch a program), a program swap,
  an unclamped program and small-bucket requests; each tenant's spins
  equal a Session rebuilt from its result; the same traffic on a 4-band
  logical mesh under a fault plan (a link flap, two shards killed, a
  straggler) through K5 equals the clean run bit for bit; then the split
  of a served launch (model load, S=1, steady state, cache hit / program
  swap / recompile, K1's device time, ms on 4, 3 and 2 bands);
* lm_serve: the language-model serving path (`repro_torch.launch.serve`)
  at gemma2-2b's full width in bf16, weights drawn on the card: prefill,
  the graft into the decode cache and sampled decode steps, held against
  the model's own forward; flash against direct attention at 8192 tokens;
  an 8192-token prompt; the reduced float32 model on the CPU and on the
  card.  It launches none of the six kernels;
* lm_train: language-model training (`repro_torch.launch.train`) at
  gemma2-2b's full width in bf16, hardware-aware: the entry point's 12
  steps, the step measured (ms, tokens/s, peak memory, device profile,
  operation bound), a fixed batch's falling loss, B=1 S=4096 with remat
  on and off, 8-bit moments; the reduced float32 model's steps on the CPU
  and on the card, a bit-equal resume on the card, and the flash backward
  against autograd through direct attention at 8192 tokens.  It launches
  none of the six kernels;
* lm_families: the other language-model families at full width —
  granite-moe-1b-a400m, rwkv6-3b and whisper-tiny at full depth, jamba
  cut to one period (8 layers) and kimi-k2 to its dense prefix and one
  MoE layer — each served (prefill == forward, decode continues prefill,
  a 1024-token prompt; whisper's decode against its teacher-forced
  forward) and the first three trained hardware-aware; the reduced
  float32 models on the CPU and on the card, Mamba's custom scan backward
  against autograd at jamba's width, granite's MoE layer chunked against
  one shot.  It launches none of the six kernels;
* mesh: many devices as logical devices of the card, and the dry run —
  gemma2-2b at full width: a hardware-aware train step under a 2 x 4
  mesh equal to the unmeshed step bit for bit, the dry run's argument
  bytes on a 1 x 1 mesh equal to the real state's, the prefill and serve
  steps under the production mesh equal to `launch.serve.generate`'s
  logits, ``REPRO_REMAT=dots`` against the default at S = 4096 (bit-equal
  gradients; ms and peak memory), int8 gradient compression of the
  whole gradient tree, `launch.train --mesh host --data-model 2 4`; the
  dry run of four gemma2-2b cells (train_4k, prefill_32k and decode_32k
  on the pod mesh, train_4k on the multipod mesh), each traced as rank 0
  of the production rank mesh under a process group that moves nothing,
  on the host's CPU beside the card's work from the kernel checks on:
  rank 0's FLOPs and their replication, its collectives by kind, its
  temporaries; `examples_torch/pbit_lattice_pod.py` at
  full size under three sync policies on 4 logical bands (barrier equal
  to one band), through K1 and K5;
* ranks: the sharded engine across processes, each world a group of
  child processes: NCCL at world size 1 (8 bands on one rank), 2 and 4
  gloo ranks sharing the card (boundary rows staged through host
  memory), ``Sync()``, ``halo_every=4`` and its async twin at 100 sweeps
  a call — K5 per card with ``edge_halos="block"``, the rank's edge halos
  from the process group between windows — every rank equal to the
  one-process engine bit for bit, every K5 launch replayed in its rank;
  two NCCL ranks on the one card tried and their refusal recorded;
* lm_ranks: the language models' steps across processes (`launch.steps`
  on a rank mesh: FSDP over data x tensor, expert, channel and head
  parallel over model), each world a group of child processes: NCCL at
  world size 1 (every model's one-process reference, and gemma2-2b,
  granite-moe, rwkv6-3b and whisper-tiny on a 1 x 1 rank mesh, bit-equal
  to it), 2 and 4 gloo ranks sharing the card (gemma2-2b, granite-moe,
  rwkv6-3b, jamba's period, kimi-k2's cut and qwen2-vl-72b cut to 2
  layers on 1 x 2 or 2 x 1; gemma2-2b, granite-moe and whisper-tiny on
  2 x 2, whisper-tiny on 1 x 4): train steps or a loss and its
  gradients, prefill and greedy decode, each held to one process's, each
  rank's blocks to the specs'; the dry run of gemma2-2b's 1 x 2 train
  steps (full depth, 2 layers with 8-bit moments, 2 layers under the
  fsdp preset), traced on the host: each rank's collectives equal the
  gloo rank's by kind, calls and bytes; the 1 x 1 step's traced argument
  and temporary bytes beside the card's peak.  It launches none of the
  six kernels.

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
  {"phase": "psl", ...}            compiled circuits: rows, factors, ms
  {"phase": "serve", ...}          the service: checks, health, the split
  {"phase": "lm_serve", ...}       the LM path: checks, ms, memory, bounds
  {"phase": "lm_train", ...}       LM training: checks, ms, memory, bound
  {"phase": "lm_families", ...}    MoE, Mamba hybrid, RWKV, Whisper: checks,
                                   ms, memory, bounds, splits
  {"phase": "mesh", ...}           meshed steps, remat, compression, dry
                                   run, the lattice twin: checks, ms, GB
  {"phase": "ranks", ...}          worlds of processes: checks, routes,
                                   ms a call, halo bytes, NCCL on one card
  {"phase": "lm_ranks", ...}       LM steps on rank meshes: checks, ms,
                                   bytes a rank, collectives, the dry
                                   run's against them
  {"kernels": [...]}               one record per kernel (see PERF.md)
  <name, power limit>              as nvidia-smi prints them
  {"ok": true, "device": {...}}    last line
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet): the roofline's rates
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_TC_OPS_PER_S = 1979e12   # int8 on the tensor cores, dense
BF16_TC_OPS_PER_S = 989e12    # bf16 on the tensor cores, dense

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
                    sparse=False, edge_halos="zero"):
    """One K5 launch as the sharded engine makes it: a programmed chip cut
    into ``bands`` row bands (`ShardedEngine`'s plan and layout), its halos
    exchanged once before the launch, through
    `shard_sweep.fused_shard_exchange_resident`.  With ``edge_halos=
    "block"`` the first band's halo_up and the last band's halo_dn hold
    random spins, what neighbouring ranks would supply, and the launch
    keeps them.  Returns the recorded wrapper call (args, kwargs, outputs)
    and the `ExchangePlan` it ran."""
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
    if edge_halos == "block":
        outer = ses.random_spins(gen)[:, :2 * halo_up.shape[2]]
        halo_up = torch.cat([outer[None, :, :halo_up.shape[2]], halo_up[1:]])
        halo_dn = torch.cat([halo_dn[:-1], outer[None, :, halo_up.shape[2]:]])
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
            mode=mode, block_b=block_b, edge_halos=edge_halos, **kw)
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
    ragged B=5); ``edge_halos="block"`` (the outer edge halos kept as
    given, random spins) on 2 bands of the chip, on the ranks phase's 4
    and 2 bands of the lattice a card (one exchange point, S=2) and in the
    mailbox body.  Rule: equality in every output (spins with their halo
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
                                 block_b=2)),
                ("block_edges", chip_graph, 2, B, "cluster",
                 dict(halo_every=2, S=4, moments=True, clamp=True,
                      edge_halos="block")),
                ("lattice_32768_4_bands_block", lattice_graph, 4, B,
                 "cluster", dict(halo_every=math.inf, S=2, sparse=True,
                                 edge_halos="block")),
                ("lattice_32768_2_bands_block_moments", lattice_graph, 2, B,
                 "cluster", dict(halo_every=math.inf, S=2, sparse=True,
                                 moments=True, edge_halos="block")),
                ("lattice_32768_17_bands_block", lattice_graph, 17, B,
                 "mailbox", dict(halo_every=2, S=4, sparse=True,
                                 edge_halos="block"))):
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
                          "edge_halos": kwargs.get("edge_halos", "zero"),
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
    passes every call through and keeps its operands and a copy of its
    outputs, so each launch can be replayed through the plain version.
    The outputs are copied because a path may write into an output it owns
    (the sharded engine sets a rank's edge halos in the block a K5 window
    returned before the next window reads it)."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.calls = []

    def __call__(self, *args, **kwargs):
        out = self.wrapper(*args, **kwargs)
        kept = (tuple(_copy(x) for x in out) if isinstance(out, tuple)
                else _copy(out))
        self.calls.append((args, kwargs, kept))
        return out

    # a wrapper whose own module is the seam (K6) counts through its module
    # name, which then names the recorder: the count stays the wrapper's
    @property
    def launches(self) -> int:
        return self.wrapper.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.wrapper.launches = n


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


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
# phase: the PSL compiler through K1's clamp path
# ---------------------------------------------------------------------------
FACTOR_CHAINS, FACTOR_SWEEPS = 128, 800   # examples/factorize.py, full mode
FACTOR_PRODUCTS = (2, 3, 4, 6, 9)
ADDER_PAIRS = {(0, 2), (1, 1), (2, 0)}    # the preimage of sum = 2


def _factor_pairs(r) -> dict:
    """Clause-valid (a, b) samples of a multiplier's inverse run."""
    valid = r.valid_mask()
    pairs: dict = {}
    for a, b in zip(r.port_values("a")[valid].tolist(),
                    r.port_values("b")[valid].tolist()):
        pairs[(a, b)] = pairs.get((a, b), 0) + 1
    return pairs


def _k1_plan(calls, chains: int) -> dict:
    """The `sparse_plan` of the recorded K1 launches at ``chains``."""
    args, kwargs, _ = next(c for c in calls if c[0][0].shape[0] == chains)
    plan = sparse_plan_of(args, kwargs)
    return {"body": plan.body, "chains_per_block": plan.chains,
            "threads": plan.threads,
            "blocks": -(-chains // plan.chains), "S": args[10].shape[0]}


def psl_phase(seed: int) -> dict:
    """The PSL compiler on the 440-spin chip graph, through
    `psl.compile_circuit` and `CompiledCircuit.run_*` (``auto`` + counter
    noise -> ``fused_sparse``: every run is one clamped K1 launch), driven
    once (`drive`), every launch replayed through the plain version:

    (a) AND at `compile_circuit`'s defaults (64 chains, 300 sweeps): the 4
        forward rows give y = a & b; inverse y = 1 gives (1, 1); inverse
        y = 0 has clause-valid samples, all with a & b = 0;
    (b) the 2-bit ripple adder: 16 forward rows give sum + 4 cout = a + b;
        inverse sum = 2, cout = 0 gives valid pairs within {(0,2), (1,1),
        (2,0)};
    (c) `tasks.full_adder_inference` on the chip graph: >= 7 of 8 rows,
        broken chains < 0.2;
    (d) factorization with the 2-bit multiplier at `examples/factorize.py`'s
        full-mode sizes (128 chains, 800 sweeps, products 2, 3, 4, 6, 9):
        every clause-valid sample a true factorization, each product one.
    Then ms per `run` (CUDA events, median of 3 after a warm-up) and K1's
    device ms at 64 and 128 chains."""
    from repro_torch import psl
    from repro_torch.core import tasks
    from repro_torch.core.chimera import make_chip_graph

    t_phase = time.perf_counter()
    g = make_chip_graph()

    def path():
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        gate = psl.compile_circuit(psl.and_circuit(), g, device=DEVICE)
        forward = {(a, b): gate.run_forward(gen, {"a": a, "b": b}).infer("y")
                   for a in (0, 1) for b in (0, 1)}
        inv1 = gate.run_inverse(gen, {"y": 1})
        inv0 = gate.run_inverse(gen, {"y": 0})
        valid0 = inv0.valid_mask()
        and_out = {
            "forward_rows_correct": sum(y == (a & b)
                                        for (a, b), y in forward.items()),
            "inverse_y1": [inv1.infer("a"), inv1.infer("b")],
            "inverse_y0_valid": int(valid0.sum()),
            "inverse_y0_and_zero": bool(np.all(
                (inv0.port_values("a")[valid0]
                 & inv0.port_values("b")[valid0]) == 0))}

        adder = psl.compile_circuit(psl.ripple_adder_circuit(2), g,
                                    device=DEVICE)
        rows = 0
        for a in range(4):
            for b in range(4):
                r = adder.run_forward(gen, {"a": a, "b": b})
                rows += r.infer("sum") + (r.infer("cout") << 2) == a + b
        inv = adder.run_inverse(gen, {"sum": 2, "cout": 0})
        adder_out = {"forward_rows_correct": rows,
                     "inverse_pairs": sorted(_factor_pairs(inv)),
                     "broken_chain_fraction": inv.broken_chain_fraction}

        fa = tasks.full_adder_inference(
            g, gen=torch.Generator(device=DEVICE).manual_seed(seed + 3),
            device=DEVICE)

        mult = psl.compile_circuit(psl.multiplier_circuit(2), g,
                                   chains=FACTOR_CHAINS,
                                   n_sweeps=FACTOR_SWEEPS, device=DEVICE)
        factors = {}
        for product in FACTOR_PRODUCTS:
            r = mult.run_inverse(gen, {"prod": product})
            pairs = _factor_pairs(r)
            factors[product] = {
                "pairs": {f"{a}x{b}": c
                          for (a, b), c in sorted(pairs.items())},
                "wrong": [f"{a}x{b}" for a, b in pairs if a * b != product],
                "valid_fraction": float(r.valid_mask().mean()),
                "broken_chain_fraction": r.broken_chain_fraction}
        backends = {c.session().backend for c in (gate, adder, mult)}
        return (gate, mult, and_out, adder_out, fa, factors, backends,
                mult.embedding.stats())

    (gate, mult, and_out, adder_out, fa, factors, backends, mult_stats), \
        counts, calls = drive(path)
    summary, worst = replay_all(calls)
    plans = {str(b): _k1_plan(calls["sweep_sparse"], b)
             for b in (gate.spec.chains, FACTOR_CHAINS)}

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    runs = {str(gate.spec.chains): lambda: gate.run_forward(
                gen, {"a": 1, "b": 1}),
            str(FACTOR_CHAINS): lambda: mult.run_inverse(gen, {"prod": 6})}
    run_ms = {b: cuda_ms(fn) for b, fn in runs.items()}
    k1_ms = {b: device_kernel_ms(fn, K1_KERNELS, 5) for b, fn in runs.items()}
    out = {"phase": "psl", "graph": "make_chip_graph", "N": g.n_nodes,
           "backends": sorted(backends), "launches": counts,
           "launches_vs_plain_version": summary,
           "and_gate": and_out, "ripple_adder_2bit": adder_out,
           "full_adder_inference": {
               "rows_correct": fa["rows_correct"],
               "broken_chain_fraction": fa["broken_chain_fraction"],
               "rows": {f"{a}{b}{c}": list(v)
                        for (a, b, c), v in sorted(fa["rows"].items())}},
           "factorize": {"multiplier": mult_stats, "chains": FACTOR_CHAINS,
                         "sweeps": FACTOR_SWEEPS,
                         "products": {str(k): v for k, v in factors.items()}},
           "k1_plans": plans, "run_ms": run_ms, "k1_device_ms": k1_ms,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    expected = 6 + 17 + 8 + len(FACTOR_PRODUCTS)
    checks = {
        "backends": backends == {"fused_sparse"},
        "k1_launches": counts["sweep_sparse"] == expected,
        "other_kernels_idle": all(counts[k] == 0 for k in KERNELS
                                  if k != "sweep_sparse"),
        "and_forward": and_out["forward_rows_correct"] == 4,
        "and_inverse_y1": and_out["inverse_y1"] == [1, 1],
        "and_inverse_y0": (and_out["inverse_y0_valid"] > 0
                           and and_out["inverse_y0_and_zero"]),
        "adder_forward": adder_out["forward_rows_correct"] == 16,
        "adder_inverse": (bool(adder_out["inverse_pairs"]) and set(
            map(tuple, adder_out["inverse_pairs"])) <= ADDER_PAIRS),
        "full_adder_rows": fa["rows_correct"] >= 7,
        "full_adder_broken": fa["broken_chain_fraction"] < 0.2,
        "factorize": all(v["pairs"] and not v["wrong"]
                         for v in factors.values())}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"a psl check failed: {failed}")
    out["_worst"] = worst
    return out


# ---------------------------------------------------------------------------
# phase: the sampling service (K1; K5 on the meshed rungs)
# ---------------------------------------------------------------------------
SERVE_CHAINS = 256      # capacity_chains: 32 tenants x 8 chains, one launch
SERVE_TENANTS = 32
SERVE_SWEEPS = 100
SERVE_BANDS = 4         # the logical row-band mesh of the faulted run
SERVE_STEADY = 10       # warm launches of the steady-state timing
SERVE_STRAGGLER_S = 2.0  # the injected straggler's delay


def _serve_traffic(seed: int) -> list:
    """The phase's requests in submission order: 32 tenants x 8 chains
    clamped on one SK program of the 440-spin chip (one mask, each tenant
    its own values), the same tenants on fresh codes (a program swap in
    the warm 7x8 bucket), a third program unclamped, then the traffic of
    ``python -m repro_torch.serve`` on 1x1 and 2x2 graphs.  Every launch
    of the chip graph anneals over the same explicit betas."""
    from repro_torch.core.chimera import make_chip_graph
    from repro_torch.serve import SampleRequest
    from repro_torch.serve.__main__ import build_requests

    g = make_chip_graph()
    rng = np.random.default_rng(seed)
    betas = np.linspace(0.1, 2.0, SERVE_SWEEPS, dtype=np.float32)
    mask = rng.random(g.n_nodes) < 0.25
    per = SERVE_CHAINS // SERVE_TENANTS
    reqs = []
    for clamped in (True, True, False):
        J, _ = sk_edge_codes(g, rng)
        h = rng.integers(-10, 11, size=g.n_nodes, dtype=np.int32)
        for t in range(SERVE_TENANTS):
            kw = {}
            if clamped:
                kw = dict(clamp_mask=mask, clamp_values=np.where(
                    rng.random((per, g.n_nodes)) < 0.5, -1.0,
                    1.0).astype(np.float32))
            reqs.append(SampleRequest(
                tenant=f"tenant-{t}", graph=g, J_codes=J, h_codes=h,
                chains=per, betas=betas, timeout_s=600.0, **kw))
    return reqs + build_requests(4, 3, 2, 8, rng)


def _serve_service(seed: int, **kw):
    from repro_torch.core.hardware import HardwareConfig
    from repro_torch.serve import SamplerService
    return SamplerService(hw=HardwareConfig(), seed=seed, mismatch_seed=seed,
                          capacity_chains=SERVE_CHAINS, noise="counter",
                          backoff_s=0.01, max_backoff_s=0.1,
                          default_timeout_s=600.0, max_queue=128,
                          device=DEVICE, **kw)


def _serve(svc, reqs) -> list:
    tickets = [svc.submit(r) for r in reqs]
    svc.drain()
    return [t.result() for t in tickets]


def _launch_operands(svc, reqs, results):
    """One launch rebuilt from its results' metadata (`bucket_spec`, the
    launch seed, the chain offsets): (Session, program, m0, noise state,
    betas) on a Session of its own."""
    from repro_torch import api
    from repro_torch.serve import embed_graph, embed_program

    head, r0 = reqs[0], results[0]
    sess = api.Session(svc.bucket_spec(head.graph))
    bn = sess.graph.n_nodes
    emb = embed_graph(head.graph, sess.graph)
    Jb, hb = embed_program(emb, head.J_codes, head.h_codes)
    cm = cv = None
    if head.clamp_mask is not None:
        cm = np.zeros(bn, bool)
        cm[emb.node_map] = head.clamp_mask
        cv = np.zeros((SERVE_CHAINS, bn), np.float32)
        for req, res in zip(reqs, results):
            cv[res.chain_offset:res.chain_offset + req.chains,
               emb.node_map] = req.clamp_values
    gen = sess.generator(r0.launch_key)
    m0, ns = sess.random_spins(gen), sess.noise_state(gen)
    prog = sess.make_program(Jb, hb, clamp_mask=cm, clamp_values=cv)
    betas = (head.betas if head.betas is not None
             else np.full(head.n_sweeps, head.beta, np.float32))
    return sess, prog, m0, ns, betas, emb


def _median_exec_ms(svc, reqs, repeats: int) -> float:
    return float(np.median([_serve(svc, reqs)[0].exec_s * 1e3
                            for _ in range(repeats)]))


def _launch_split(svc, reqs) -> dict:
    """Host-clock ms (median of 5 after a warm-up, each ending in a
    synchronise) of the stages of one warm served launch of ``reqs`` on
    ``svc``'s cached bucket Session, in the order `SamplerService` runs
    them: admission (every request's embedding and digest), the batch's
    clamp arrays (numpy), the launch draws, the program's codes and clamps
    copied to the card, the chip programmed from the codes, the `sample`
    call (its eager host work and the one K1 launch), and the spins'
    copy back with every tenant's slice."""
    from repro_torch import api

    def admit():
        tickets = [svc.submit(r) for r in reqs]
        svc._queue.clear()
        return tickets

    batch = admit()
    head = batch[0]
    fp, entry = svc._entry_for(head.bshape)
    sess = entry.session
    key = 12345
    cm, cv = svc._assemble_clamps(batch, entry.embeddable)
    m0, ns = svc._launch_state(sess, key)
    prog = sess.make_program(head.Jb, head.hb, clamp_mask=cm,
                             clamp_values=cv)
    chip = api.program_chip(sess.spec, prog, tables=sess._nbr)
    m = sess.sample(chip, m0, ns, head.betas, clamp_mask=prog.clamp_mask,
                    clamp_values=prog.clamp_values)[0]

    def copy_back():
        host = m.cpu().numpy()
        return [host[i * t.req.chains:(i + 1) * t.req.chains][
            :, t.emb.node_map] for i, t in enumerate(batch)]

    stages = {
        "admission": admit,
        "clamp_arrays": lambda: svc._assemble_clamps(batch,
                                                     entry.embeddable),
        "draws": lambda: svc._launch_state(sess, key),
        "program_operand": lambda: sess.make_program(
            head.Jb, head.hb, clamp_mask=cm, clamp_values=cv),
        "program_chip": lambda: api.program_chip(sess.spec, prog,
                                                 tables=sess._nbr),
        "sample_call": lambda: sess.sample(
            chip, m0, ns, head.betas, clamp_mask=prog.clamp_mask,
            clamp_values=prog.clamp_values),
        "copy_back": copy_back}
    return {k: _host_ms(fn) for k, fn in stages.items()}


def serve_phase(seed: int) -> dict:
    """The multi-tenant sampling service (`repro_torch.serve`) on the
    paper's chip bucket, driven once (`drive`), every launch replayed
    through the plain version:

    (a) the clean run: `_serve_traffic` through a `SamplerService` at
        256 chains, counter noise, the default `HardwareConfig()`: the
        three 440-spin programs embed into the 7x8 bucket (448 spins), one
        K1 launch of 256 chains each, and four 1x1 / 2x2 requests land in
        the small buckets, one K1 launch each; every tenant's spins equal
        a direct `Session.sample_program` of `bucket_spec` rebuilt from
        its `RequestResult` (launch seed, chain offset), bit for bit;
    (b) the same traffic on a logical 4-band mesh under a `FaultPlan`: a
        2-flap link flap on launch 0, band 1 killed on launch 1 and band 3
        on launch 2 (both 7x8 launches, replayed on 3 and 2 bands), a
        straggler on the last launch: zero drops, every result equal to
        the clean run's bit for bit, `healthz()` degraded with dead shards
        [1, 3], 2 replays, 2 transient retries, the straggler flagged.
    Then (outside the drive) the split of a served launch: model load,
    a warm launch at S=1, the steady state at S=100, the Session cache's
    hit / program swap / recompile, K1's device ms and plan, and ms per
    launch on 4, 3 and 2 bands against unsharded."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels.sweep_fused import (sweep_sparse,
                                                 sweep_sparse_exchange)
    from repro_torch.serve import (FaultEvent, FaultInjector, FaultPlan,
                                   ShardHealthMonitor)

    t_phase = time.perf_counter()
    reqs = _serve_traffic(seed)
    plan = FaultPlan.make([
        FaultEvent(step=0, kind="link_flap", flaps=2),
        FaultEvent(step=1, kind="kill_shard", shard=1),
        FaultEvent(step=2, kind="kill_shard", shard=3),
        FaultEvent(step=6, kind="straggler", delay_s=SERVE_STRAGGLER_S)])

    def path():
        clean = _serve_service(seed)
        res_clean = _serve(clean, reqs)
        faulted = _serve_service(
            seed, mesh=make_mesh((SERVE_BANDS,), ("rows",)),
            monitor=ShardHealthMonitor(), injector=FaultInjector(plan))
        meshed_backend = faulted.bucket_spec(reqs[0].graph).backend
        return clean, res_clean, faulted, _serve(faulted, reqs), \
            meshed_backend

    (clean, res_clean, faulted, res_faulted, meshed_backend), counts, \
        calls = drive(path)
    t_replay = time.perf_counter()
    summary, worst = replay_all(calls)
    replay_s = time.perf_counter() - t_replay

    # each launch rebuilt from its results' metadata, outside the drive
    groups: dict = {}
    for req, res in zip(reqs, res_clean):
        groups.setdefault(res.launch_seq, []).append((req, res))
    rebuilt_equal = []
    for seq, members in sorted(groups.items()):
        g_reqs, g_res = zip(*members)
        sess, prog, m0, ns, betas, emb = _launch_operands(clean, g_reqs,
                                                          g_res)
        m = sess.sample_program(prog, m0, ns, betas)[0].cpu().numpy()
        rebuilt_equal.append(all(
            np.array_equal(res.spins, m[res.chain_offset:res.chain_offset
                                        + req.chains][:, emb.node_map])
            for req, res in members))
    k1_recorded = [sparse_plan_of(a, k) for a, k, _ in calls["sweep_sparse"]
                   if tuple(a[0].shape) == (SERVE_CHAINS, 448)]
    first = res_clean[0]
    clean_launches = clean.metrics["launches"]
    cache_after_drive = clean.cache.stats()
    build_ms = clean.cache.get(first.bucket_fingerprint).build_s * 1e3
    hz = faulted.healthz()

    # the split of a served launch (host clock, each launch ending in
    # the spins' copy to the host)
    p1, p2 = reqs[:SERVE_TENANTS], reqs[SERVE_TENANTS:2 * SERVE_TENANTS]
    s1 = [dataclasses.replace(r, betas=r.betas[:1]) for r in p1]
    invocation_ms = _median_exec_ms(clean, s1, 5)
    _serve(clean, p1)
    t0 = time.perf_counter()
    for _ in range(SERVE_STEADY):
        _serve(clean, p1)
    steady_s = time.perf_counter() - t0
    hit_ms = _median_exec_ms(clean, p1, 5)
    swap = []
    for _ in range(3):
        swap.append(_serve(clean, p2)[0].exec_s * 1e3)
        swap.append(_serve(clean, p1)[0].exec_s * 1e3)
    recompile = []
    for _ in range(3):
        clean.cache.invalidate(lambda fp, e: True)
        recompile.append(_serve(clean, p1)[0].exec_s * 1e3)
    sess, prog, m0, ns, betas, _ = _launch_operands(
        clean, p1, res_clean[:SERVE_TENANTS])
    k1_device_ms = device_kernel_ms(
        lambda: sess.sample_program(prog, m0, ns, betas), K1_KERNELS, 5)
    k1_plan = sweep_sparse.last_plan
    split = _launch_split(clean, p1)
    bands_ms, k5_plans = {}, {}
    for bands in (None, 4, 3, 2):
        svc = _serve_service(seed, mesh=None if bands is None else
                             make_mesh((bands,), ("rows",)))
        _serve(svc, p1)
        name = "unsharded" if bands is None else f"{bands}_bands"
        bands_ms[name] = _median_exec_ms(svc, p1, 3)
        if bands is not None:
            plan5 = sweep_sparse_exchange.last_plan
            k5_plans[name] = {"body": plan5.body, "cluster": plan5.cluster,
                              "chains_per_block": plan5.chains}
    ms_per_launch = steady_s / SERVE_STEADY * 1e3
    seconds = time.perf_counter() - t_phase
    out = {"phase": "serve", "bucket": [7, 8], "N": 448,
           "chains": SERVE_CHAINS, "tenants": SERVE_TENANTS,
           "sweeps": SERVE_SWEEPS, "requests": len(reqs),
           "backends": {"unsharded":
                        clean.bucket_spec(reqs[0].graph).backend,
                        "meshed": meshed_backend},
           "launches": counts, "launches_vs_plain_version": summary,
           "clean": {"launches": clean_launches,
                     "rebuilt_equal": rebuilt_equal},
           "faulted": {"healthz": hz,
                       "equal_to_clean": sum(
                           np.array_equal(a.spins, b.spins)
                           and a.launch_seq == b.launch_seq
                           and a.chain_offset == b.chain_offset
                           for a, b in zip(res_faulted, res_clean))},
           "model_load_ms": first.exec_s * 1e3,
           "model_load_build_ms": build_ms,
           "invocation_ms": invocation_ms,
           "steady": {"ms_per_launch": ms_per_launch,
                      "requests_per_s": SERVE_TENANTS * SERVE_STEADY
                      / steady_s,
                      "chain_sweeps_per_s": SERVE_CHAINS * SERVE_SWEEPS
                      * SERVE_STEADY / steady_s},
           "compile_cache": {"hit_ms": hit_ms,
                             "program_swap_ms": float(np.median(swap)),
                             "recompile_ms": float(np.median(recompile)),
                             "counters_after_drive": cache_after_drive,
                             "counters": clean.cache.stats()},
           "k1_device_ms": k1_device_ms,
           "launch_split_ms": split,
           "k5_plans": k5_plans,
           "k1_plan": {"body": k1_plan.body,
                       "chains_per_block": k1_plan.chains,
                       "threads": k1_plan.threads,
                       "blocks": -(-SERVE_CHAINS // k1_plan.chains)},
           "ms_per_launch_by_mesh": bands_ms,
           "replay_seconds": replay_s, "seconds": seconds,
           "replay_share": replay_s / seconds}
    emit(out)
    ok = [r.status == "ok" and not r.deadline_missed
          for r in res_clean + res_faulted]
    m = hz["metrics"]
    others = [k for k in KERNELS
              if k not in ("sweep_sparse", "sweep_sparse_exchange")]
    checks = {
        "all_ok": all(ok),
        "no_failures": "failed" not in m and "failed" not in clean.metrics,
        "backends": (out["backends"] == {"unsharded": "fused_sparse",
                                         "meshed": "fused_sparse"}),
        "rebuilt_equal": all(rebuilt_equal) and len(rebuilt_equal) == 7,
        "k1_plan": set(k1_recorded) == {k1_plan},
        "faulted_equal": out["faulted"]["equal_to_clean"] == len(reqs),
        "zero_drops": m["admitted"] == m["completed"] == len(reqs),
        "degraded": (hz["state"] == "degraded"
                     and hz["dead_shards"] == [1, 3]
                     and hz["mesh_devices"] == [0, 2]),
        "replays": m.get("replays", 0) >= 2,
        "transient_retries": m.get("transient_retries", 0) == 2,
        "straggler_flagged": m.get("stragglers_flagged", 0) >= 1,
        # the clean run's 7 launches are K1; the faulted run's meshed
        # rungs run K5, or K1 per band where K5 has no body
        "k1_launches": counts["sweep_sparse"] >= clean_launches,
        "meshed_launches": (counts["sweep_sparse"]
                            + counts["sweep_sparse_exchange"]
                            > 2 * clean_launches),
        "other_kernels_idle": all(counts[k] == 0 for k in others)}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"a serve check failed: {failed}")
    out["_worst"] = worst
    return out


# ---------------------------------------------------------------------------
# phase: the language-model serving path (no kernel of K1-K6)
# ---------------------------------------------------------------------------
LM_ARCH = "gemma2-2b"   # launch.serve's default, at full width in bf16
LM_BATCH, LM_PROMPT, LM_GEN, LM_MAX_SEQ = 4, 32, 32, 128
LM_LONG = 8192          # the long prompt and the flash check's length


def _named_leaves(tree):
    """(key, tensor) over a tree of dicts and lists (a list's entries
    under its own key)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v)
        elif isinstance(v, (list, tuple)):
            for item in v:
                yield from _named_leaves({k: item})
        else:
            yield k, v


def _tree_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _named_leaves(tree))


def _tree_to(tree, device):
    """A copy of ``tree`` (dicts and lists of tensors) on ``device`` (a
    copy on the same device too)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device, copy=True)


def _device_busy(fn, repeats: int = 5) -> dict:
    """Device operations a call of ``fn`` and their summed device time
    (`torch.profiler`, ``repeats`` calls after a warm-up): how busy the
    card is during a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    ops = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_ops_per_call": len(ops) / repeats,
            "device_busy_ms": sum(ops) / repeats / 1e3}


def _tf32_off() -> dict:
    """The float32 matmul settings, asserted off TF32 (the card's float32
    matmuls are then float32)."""
    tf32 = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if tf32 != {"matmul_allow_tf32": False,
                "float32_matmul_precision": "highest"}:
        raise AssertionError(f"TF32 is on for float32 matmuls: {tf32}")
    return tf32


def _lm_f32_cross_check(seed: int) -> dict:
    """The seeded reduced gemma2-2b (float32) drawn on the CPU, its
    parameters copied to the card: forward logits and a prefill + graft +
    decode step on the card agree with the CPU's to 1e-4, with TF32 off
    (asserted: the card's float32 matmuls are float32)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    tf32 = _tf32_off()
    cfg = get_reduced_config(LM_ARCH)
    cpu, card = (build_model(cfg, device=d) for d in ("cpu", DEVICE))
    params = cpu.init(seed)
    pcard = _tree_to(params, DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(seed))
    errs = {}
    with torch.inference_mode():
        for name, m, p, t in (("cpu", cpu, params, toks),
                              ("card", card, pcard, toks.to(DEVICE))):
            fwd, _ = transformer.forward(p, cfg, t)
            _, pre = transformer.prefill(p, cfg, t[:, :48])
            cache = lm_serve.graft(m.init_cache(2, 64), pre)
            dec, _ = m.decode_step(p, t[:, 48:49], 48, cache)
            errs[name] = (fwd.cpu(), dec.cpu())
    e_fwd = (errs["cpu"][0] - errs["card"][0]).abs().max().item()
    e_dec = (errs["cpu"][1] - errs["card"][1]).abs().max().item()
    return {"tf32": tf32, "forward_max_abs_err": e_fwd,
            "decode_max_abs_err": e_dec, "tolerance": 1e-4,
            "ok": max(e_fwd, e_dec) <= 1e-4}


def _lm_flash_vs_direct(seed: int, cfg) -> dict:
    """`flash_attention` against `_attend_direct` at gemma2-2b's head shape
    (8 heads over 4 KV heads, head_dim 256, softcap 50), B = 1, S = 8192,
    with the local layers' window 4096 and with none (the triangular
    schedule's skip), in float32 (TF32 off; |flash - direct| <= 1e-4) and
    in bf16 (the direct path rounds its QK product to bf16 first, flash
    keeps it in float32: |flash - direct| <= 2^-7 |direct| plus 0.25 of
    the direct output's RMS, about 0.05 here, where most outputs average
    thousands of values).  ``worst`` is the largest gap over its limit."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import flash as flash_mod

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 23)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    shape = lambda n: (1, LM_LONG, n, hd)  # noqa: E731
    q32, k32, v32 = (torch.randn(shape(n), generator=gen, device=DEVICE)
                     for n in (H, KV, KV))
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(LM_LONG, device=DEVICE)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        for window in (cfg.window, None):
            def flash():
                return flash_mod.flash_attention(
                    q, k, v, num_kv_heads=KV, scale=scale,
                    softcap=cfg.attn_softcap, causal=True, window=window)

            def direct():
                return attn_mod._attend_direct(q, k, v, cfg, scale, pos,
                                               pos, True, window)
            torch.cuda.reset_peak_memory_stats()
            got, want = flash(), direct()
            gap = (got.float() - want.float()).abs()
            rms = want.float().square().mean().sqrt().item()
            if dtype == torch.float32:
                rule, limit = "1e-4", torch.full_like(gap, 1e-4)
            else:
                rule = "2^-7 |direct| + 0.25 rms(direct)"
                limit = 2 ** -7 * want.float().abs() + 0.25 * rms
            worst = (gap / limit).max().item()
            rows.append({
                "dtype": str(dtype).split(".")[-1], "window": window,
                "max_abs_err": gap.max().item(), "tolerance": rule,
                "worst": worst, "ok": worst <= 1.0, "rms_out": rms,
                "max_abs_out": want.float().abs().max().item(),
                "finite": bool(torch.isfinite(got).all()),
                "flash_ms": cuda_ms(flash), "direct_ms": cuda_ms(direct),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            del got, want, gap, limit
    return rows


def lm_serve_phase(seed: int) -> dict:
    """The language-model serving path (`repro_torch.launch.serve`, the
    port of ``python -m repro.launch.serve``) at gemma2-2b's full width in
    bf16, weights drawn on the card from ``seed``, driven once (`drive`):
    `build_model` -> `init` -> `launch.serve.generate` (prefill of 4
    prompts of 32 tokens, the graft into a 128-token cache, 31 sampled
    decode steps).  It launches none of K1-K6 (asserted: every count 0).
    Checks: the parameter count against `cfg.param_count()`; prefill's
    last logits against forward's (2e-3 absolute plus one bf16 ulp, 2^-7
    relative: the two unembed products have other shapes); decode after
    the graft against the teacher-forced forward at position 32 (0.25 of
    the forward logits' RMS, about 0.083 here: the reference's 3e-2 rule
    was set at its reduced width's logits of about 0.5 and would pass a
    wrong decode at this width); flash against direct attention at S = 8192, with
    and without the window; one 8192-token prompt through the whole model;
    the float32 reduced model on the CPU and on the card (1e-4, TF32 off).
    Then the served loop timed again (prefill ms, graft ms, decode ms a
    token, tokens/s) and the decode step beside its byte bound."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    def path():
        t0 = time.perf_counter()
        params = model.init(seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                                generator=gen, device=DEVICE)
        out = lm_serve.generate(model, params, prompts, LM_GEN, LM_MAX_SEQ,
                                1.0, gen)
        return params, prompts, out, init_s

    (params, prompts, first, init_s), counts, _ = drive(path)
    tokens = first["tokens"]
    n_params = sum(t.numel() for _, t in _named_leaves(params))
    uncounted = sum(v.numel() for k, v in _named_leaves(params)
                    if "norm" in k or k in ("bq", "bk", "bv"))
    param_bytes = _tree_nbytes(params)
    peak_serve = torch.cuda.max_memory_allocated() - mem0

    with torch.inference_mode():
        fwd, _ = transformer.forward(params, cfg, prompts)
        pre, pcache = transformer.prefill(params, cfg, prompts)
        diff = (pre[:, 0] - fwd[:, -1]).abs()
        ref = fwd[:, -1].abs()
        prefill_fwd = {
            "max_abs_err": diff.max().item(),
            "logits_differing": int((diff > 0).sum()),
            "ok": bool((diff <= 2e-3 + 2 ** -7 * ref).all())}
        ext = torch.cat([prompts, prompts[:, :1]], dim=1)
        fwd_ext, _ = transformer.forward(params, cfg, ext)
        cache = lm_serve.graft(model.init_cache(LM_BATCH, LM_MAX_SEQ), pcache)
        dec, cache = model.decode_step(params, prompts[:, :1], LM_PROMPT,
                                       cache)
        diff = (dec[:, 0] - fwd_ext[:, LM_PROMPT]).abs()
        rms = fwd_ext[:, LM_PROMPT].square().mean().sqrt().item()
        decode_fwd = {
            "max_abs_err": diff.max().item(), "rms_logits": rms,
            "tolerance": 0.25 * rms,
            "ok": diff.max().item() <= 0.25 * rms,
            "finite": bool(torch.isfinite(dec).all())}
        del fwd, fwd_ext, pre, pcache, cache

        # one long prompt through the whole model: flash in every layer
        long = torch.randint(0, cfg.vocab_size, (1, LM_LONG), generator=gen,
                             device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        mem1 = torch.cuda.memory_allocated()
        (long_logits, long_cache), long_ms = timed_once(
            lambda: transformer.prefill(params, cfg, long))
        long_ms_warm = cuda_ms(lambda: transformer.prefill(params, cfg, long))
        long_peak = torch.cuda.max_memory_allocated() - mem1
        long_busy = _device_busy(
            lambda: transformer.prefill(params, cfg, long), repeats=1)
        # its operations at the bf16 tensor-core peak: the projections and
        # MLPs (2 per weight a token), the last token's unembed, and the
        # attention's QK and PV over the keys each query's mask keeps
        kept = 0
        for p in transformer.period_plan(cfg):
            w = p.window or LM_LONG
            kept += sum(min(i + 1, w) for i in range(LM_LONG))
        kept *= transformer.n_groups(cfg)
        layer_w = n_params - uncounted - cfg.vocab_size * cfg.d_model
        long_ops = (2 * layer_w * LM_LONG + 2 * cfg.vocab_size * cfg.d_model
                    + 4 * kept * cfg.num_heads * cfg.hd())
        long_prefill = {
            "tokens": LM_LONG, "ms_first": long_ms, "ms": long_ms_warm,
            "tokens_per_s": LM_LONG / long_ms_warm * 1e3,
            "bound_ms": long_ops / BF16_TC_OPS_PER_S * 1e3,
            "bound_by": "operations", "ops": long_ops,
            "peak_gb": long_peak / 1e9, **long_busy,
            "finite": bool(torch.isfinite(long_logits).all()),
            "cache_shape": list(long_cache["blocks"]["layer_0"]["k"].shape)}
        del long_logits, long_cache

    flash_rows = _lm_flash_vs_direct(seed, cfg)
    cross = _lm_f32_cross_check(seed)

    # the served loop again, warm: the numbers users see
    out = lm_serve.generate(model, params, prompts, LM_GEN, LM_MAX_SEQ, 1.0,
                            gen)
    steps = out["decode_step_s"]
    with torch.inference_mode():
        # the prefill and one decode step alone: device time and launches
        # against their time; the step beside its byte bound, every weight
        # read once (the tied table by the unembed) and the whole K/V cache
        prefill_busy = _device_busy(
            lambda: transformer.prefill(params, cfg, prompts))
        _, pcache = transformer.prefill(params, cfg, prompts)
        cache = lm_serve.graft(model.init_cache(LM_BATCH, LM_MAX_SEQ), pcache)
        tok = tokens[:, -1:]

        def step():
            return model.decode_step(params, tok, LM_PROMPT, cache)
        decode_ms = cuda_ms(step, repeats=10)
        decode_busy = _device_busy(step)
        cache_bytes = _tree_nbytes(cache)
        moved = param_bytes + cache_bytes
        decode_bound_ms = moved / HBM_BYTES_PER_S * 1e3
        del pcache, cache
    seconds = time.perf_counter() - t_phase
    res = {
        "phase": "lm_serve", "arch": LM_ARCH, "dtype": cfg.dtype,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
        "max_seq": LM_MAX_SEQ,
        "kernel_launches": {k: counts[k] for k in KERNELS},
        "params": {"elements": n_params, "param_count": cfg.param_count(),
                   "norms_and_biases": uncounted,
                   "bytes_on_card": param_bytes, "init_s": init_s},
        "peak_gb": {"serve": peak_serve / 1e9,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()
                    / 1e9},
        "prefill_vs_forward": prefill_fwd, "decode_vs_forward": decode_fwd,
        "flash_vs_direct": flash_rows, "long_prefill": long_prefill,
        "f32_cpu_vs_card": cross,
        "served": {
            "first_prefill_ms": first["prefill_s"] * 1e3,
            "prefill_ms": out["prefill_s"] * 1e3,
            "prefill_device": prefill_busy,
            "graft_ms": out["graft_s"] * 1e3,
            "decode_ms_per_token": float(np.median(steps)) * 1e3,
            "decode_ms_min": min(steps) * 1e3,
            "tokens_per_s": LM_BATCH * len(steps) / sum(steps),
            "tokens_in_vocab": bool(((tokens >= 0)
                                     & (tokens < cfg.vocab_size)).all()),
            "sample_tokens": tokens[0, :8].tolist()},
        "decode_step": {"ms": decode_ms, "bound_ms": decode_bound_ms,
                        "bound_by": "bytes", "bytes": moved,
                        "cache_bytes": cache_bytes,
                        "gap": decode_ms / decode_bound_ms, **decode_busy,
                        "device_idle_share":
                        1.0 - decode_busy["device_busy_ms"] / decode_ms},
        "seconds": seconds}
    emit(res)
    checks = {
        "no_kernel_launched": all(c == 0 for c in counts.values()),
        "param_count": n_params - uncounted == cfg.param_count(),
        "prefill_vs_forward": prefill_fwd["ok"],
        "decode_vs_forward": decode_fwd["ok"] and decode_fwd["finite"],
        "flash_vs_direct": all(r["ok"] and r["finite"] for r in flash_rows),
        "long_prefill": long_prefill["finite"],
        "f32_cpu_vs_card": cross["ok"],
        "tokens": res["served"]["tokens_in_vocab"]
        and tuple(tokens.shape) == (LM_BATCH, LM_GEN)}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"an lm_serve check failed: {failed}")
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase: language-model training (no kernel of K1-K6)
# ---------------------------------------------------------------------------
LM_TRAIN_B, LM_TRAIN_S = 8, 256   # launch.train's defaults
LM_TRAIN_STEPS = 12               # the entry point's run
LM_TRAIN_TIMED = 5                # timed steps, after 2 warm ones
LM_TRAIN_LONG = 4096              # one step that reaches flash and CE chunks


def _loss_and_grads(model, params, batch):
    """The loss and its gradient leaves (in `adamw.tree_leaves` order)."""
    from repro_torch.optim import adamw

    live = [p.detach().requires_grad_() for p in adamw.tree_leaves(params)]
    loss = model.loss(adamw.tree_unflatten(params, live), batch)
    return loss.detach(), torch.autograd.grad(loss, live)


def _quiet(fn, *args):
    """(result, printed lines) of ``fn(*args)`` with its stdout captured:
    the script's own stdout carries JSON lines only."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def _opt_to(opt, device):
    """A copy of an `OptState` on ``device`` (8-bit moments kept)."""
    from repro_torch.optim import adamw

    def one(m):
        if isinstance(m, adamw.QTensor):
            return adamw.QTensor(m.q.to(device, copy=True),
                                 m.scale.to(device, copy=True), m.shape)
        return m.to(device, copy=True)
    return adamw.OptState(opt.step.to(device, copy=True),
                          adamw.tree_map(one, opt.mu),
                          adamw.tree_map(one, opt.nu))


def _apply_gap(got, want) -> dict:
    """Largest gap between two (params, OptState) pairs: parameters and
    float32 moments and scales over each leaf's max |x|, and the 8-bit
    payload entries that differ."""
    from repro_torch.optim import adamw

    def flat(pair):
        out = []
        for t in adamw.tree_leaves((pair[0], pair[1].mu, pair[1].nu)):
            out += [t.q, t.scale] if isinstance(t, adamw.QTensor) else [t]
        return out
    rel, q_diff = 0.0, 0
    for a, b in zip(flat(got), flat(want)):
        a, b = a.cpu(), b.cpu()
        if b.dtype == torch.int8:
            q_diff += int((a != b).sum())
        else:
            den = max(b.abs().max().item(), 1e-30)
            rel = max(rel, (a.float() - b.float()).abs().max().item() / den)
    return {"max_err_over_leaf_max": rel, "q_entries_differing": q_diff}


def _lm_train_cpu_vs_card(seed: int) -> dict:
    """Reduced gemma2-2b in float32, hardware-aware (8 bits, gain sigma 0:
    the CPU's and the card's generators draw other gains), the same
    parameters and batches on the CPU and on the card, TF32 off
    (asserted): three steps of `make_train_step` with float32 and with
    8-bit moments.  Step-1 loss and grad norm to 1e-4 relative, step-1
    gradients leaf by leaf to 1e-4 of the leaf's max |g|, and the
    optimizer on the same gradients: at each step of the CPU's run its
    parameters, state and gradients carried to the card and
    `adamw.apply` run on both (parameters, moments and scales within
    1e-6 of the leaf max, at most 10 8-bit entries differing).  The
    three-step losses to 1e-4 with float32 moments only: 8-bit moments
    quantize ν to 0 where μ is not (ν's block scale comes from the
    block's largest g²), the update there is μ / eps, and a gradient
    that differs in its 7th digit flips which entries (ROADMAP Queue 3
    item 19); their losses are reported."""
    from repro_torch.configs import ShapeCfg, get_reduced_config
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw

    tf32 = _tf32_off()
    cfg = get_reduced_config(LM_ARCH)
    hw = HwAwareConfig(bits=8, sigma_gain=0.0, min_size=256)
    src = make_source(DataConfig(seed=seed, vocab_size=cfg.vocab_size))
    init = build_model(cfg, device="cpu").init(seed)
    rows = []
    for bits in (32, 8):
        ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=3,
                                 state_bits=bits)
        runs, applies = {}, []
        for dev in ("cpu", DEVICE):
            step = make_train_step(cfg, ShapeCfg("cross", 64, 2, "train"),
                                   None, ocfg, hw_aware=hw, device=dev)
            params = _tree_to(init, dev)
            opt = adamw.init(params, bits)
            grads = None
            metrics = []
            for s in range(3):
                batch = src.batch(s, 2, 64, device=dev)
                if dev == "cpu":
                    _, g = _loss_and_grads(step.model, params, batch)
                    g = adamw.tree_unflatten(params, g)
                    grads = grads or g
                    card = adamw.apply(ocfg, _tree_to(g, DEVICE),
                                       _opt_to(opt, DEVICE),
                                       _tree_to(params, DEVICE))
                    want = adamw.apply(ocfg, g, _opt_to(opt, "cpu"),
                                       _tree_to(params, "cpu"))
                    applies.append(_apply_gap(card[:2], want[:2]))
                elif grads is None:
                    _, grads = _loss_and_grads(step.model, params, batch)
                    grads = adamw.tree_unflatten(params, grads)
                params, opt, m = step.fn(params, opt, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs[dev] = (np.array(metrics),
                         [g.cpu() for g in adamw.tree_leaves(grads)])
        (mc, gc), (md, gd) = runs["cpu"], runs[DEVICE]
        rel = np.abs(mc - md) / np.abs(mc)
        grad_err = max(((a - b).abs().max() / a.abs().max()).item()
                       for a, b in zip(gc, gd))
        gated = rel if bits == 32 else rel[:1]
        apply_ok = all(a["max_err_over_leaf_max"] <= 1e-6
                       and a["q_entries_differing"] <= 10 for a in applies)
        rows.append({"state_bits": bits, "losses_cpu": mc[:, 0].tolist(),
                     "losses_card": md[:, 0].tolist(),
                     "loss_gnorm_rel_err_by_step": rel.max(1).tolist(),
                     "steps_gated": len(gated),
                     "grad_max_err_over_leaf_max": grad_err,
                     "apply_same_grads": applies,
                     "ok": float(gated.max()) <= 1e-4 and grad_err <= 1e-4
                     and apply_ok})
    return {"tf32": tf32, "tolerance": 1e-4, "runs": rows,
            "ok": all(r["ok"] for r in rows)}


def _lm_train_resume(seed: int) -> dict:
    """`launch.train.main` on the card (reduced gemma2-2b, hardware-aware):
    6 steps with a checkpoint every 2; with steps 4 and 6 deleted, the
    same command resumes from step 2 and must end bit-equal to the first
    run's step 6 (parameters, moments, step).  Under
    ``torch.use_deterministic_algorithms(True)`` for this check alone:
    the embedding's and the gold logit's backward add with atomics
    otherwise (``CUBLAS_WORKSPACE_CONFIG`` is set by `main` before the
    first cuBLAS call)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch import train as lm_train

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            argv = ["--reduced", "--steps", "6", "--batch", "2", "--seq",
                    "64", "--ckpt-every", "2", "--log-every", "1",
                    "--hardware-aware", "--seed", str(seed), "--ckpt-dir", d]
            _quiet(lm_train.main, argv)
            _, first, _ = ckpt.load(d, 6)
            for s in (6, 4):
                shutil.rmtree(Path(d) / f"step_{s:09d}")
            _, log = _quiet(lm_train.main, argv)
            _, second, _ = ckpt.load(d, 6)
    finally:
        torch.use_deterministic_algorithms(prev)
    differing = [k for k in first
                 if not torch.equal(torch.as_tensor(first[k]),
                                    torch.as_tensor(second[k]))]
    resumed = "resumed from step 2" in log
    return {"leaves": len(first), "differing": differing,
            "resumed_from_step_2": resumed,
            "ok": resumed and not differing and len(first) > 0}


def _lm_flash_backward(seed: int, cfg) -> list:
    """dq, dk, dv of `flash_attention` (its custom backward) against
    autograd through `_attend_direct`, at gemma2-2b's head shape (8 heads
    over 4 KV heads, head_dim 256, softcap 50), B = 1, S = 8192, window
    4096 and none, with a random cotangent.  float32 (TF32 off): each
    gradient within 1e-4 of its max |g|.  bf16: within 2^-7 |direct| +
    0.25 rms(direct), the forward's rule (``worst`` is the largest gap
    over its limit).  fwd+bwd ms and peak GB of each path."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import flash as flash_mod

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 29)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd()
    shape = lambda n: (1, LM_LONG, n, hd)  # noqa: E731
    base = [torch.randn(shape(n), generator=gen, device=DEVICE)
            for n in (H, KV, KV, H)]
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(LM_LONG, device=DEVICE)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.detach().to(dtype) for t in base)
        qkv = [t.requires_grad_() for t in (q, k, v)]
        for window in (cfg.window, None):
            def flash():
                out = flash_mod.flash_attention(
                    *qkv, num_kv_heads=KV, scale=scale,
                    softcap=cfg.attn_softcap, causal=True, window=window)
                return torch.autograd.grad(out, qkv, do)

            def direct():
                out = attn_mod._attend_direct(*qkv, cfg, scale, pos, pos,
                                              True, window)
                return torch.autograd.grad(out, qkv, do)
            peaks = {}
            for name, fn in (("flash", flash), ("direct", direct)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                m0 = torch.cuda.memory_allocated()
                out = fn()
                torch.cuda.synchronize()
                peaks[name] = (torch.cuda.max_memory_allocated() - m0) / 1e9
                if name == "flash":
                    got = out
                else:
                    want = out
            grads = []
            for n, a, w in zip("qkv", got, want):
                gap = (a.float() - w.float()).abs()
                w32 = w.float()
                rms = w32.square().mean().sqrt().item()
                if dtype == torch.float32:
                    worst = gap.max().item() / (1e-4 * w32.abs().max().item())
                else:
                    worst = (gap / (2 ** -7 * w32.abs() + 0.25 * rms)
                             ).max().item()
                grads.append({"grad": "d" + n, "max_abs_err": gap.max().item(),
                              "rms_direct": rms, "worst": worst,
                              "finite": bool(torch.isfinite(a).all())})
            del got, want
            rows.append({
                "dtype": str(dtype).split(".")[-1], "window": window,
                "tolerance": ("1e-4 max|g|" if dtype == torch.float32
                              else "2^-7 |direct| + 0.25 rms(direct)"),
                "grads": grads,
                "ok": all(g["worst"] <= 1.0 and g["finite"] for g in grads),
                "flash_fwd_bwd_ms": cuda_ms(flash),
                "direct_fwd_bwd_ms": cuda_ms(direct),
                "flash_peak_gb": peaks["flash"],
                "direct_peak_gb": peaks["direct"]})
    return rows


def _train_flops(cfg, batch: int, seq: int) -> dict:
    """The step's model operations from the shapes: 6 per counted
    parameter a token (forward 2, backward 4) plus causal attention's QK
    and PV over the keys each query's mask keeps (x3 for the backward);
    the remat recompute (the layers' forward and the CE chunks' unembed
    forward again) beside it."""
    from repro_torch.models import transformer

    kept = 0
    for p in transformer.period_plan(cfg):
        w = p.window or seq
        kept += sum(min(i + 1, w) for i in range(seq))
    kept *= transformer.n_groups(cfg) * batch
    attn_fwd = 4 * kept * cfg.num_heads * cfg.hd()
    tokens = batch * seq
    n = cfg.param_count()
    embed = cfg.vocab_size * cfg.d_model
    model = 6 * n * tokens + 3 * attn_fwd
    remat = 2 * (n - embed) * tokens + attn_fwd + 2 * embed * tokens
    return {"model_flops": model, "remat_recompute_flops": remat,
            "bound_ms": model / BF16_TC_OPS_PER_S * 1e3,
            "bound_by": "operations",
            "bound_with_remat_ms": (model + remat) / BF16_TC_OPS_PER_S * 1e3}


def _device_profile(fn, top: int = 8) -> dict:
    """One call of ``fn`` under `torch.profiler` (after a warm-up): its
    device operations, their summed device time and the ``top`` device
    operations by time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    n_ops = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": n_ops, "device_busy_ms": busy,
            "profiled_wall_ms": wall,
            "top_device_ops": [{"name": k[:80], "ms": v} for k, v in ranked]}


def _fwd_bwd(model, params, batch, repeats: int = 3) -> dict:
    """Median ms (CUDA events, after a warm-up) and peak memory above the
    resident state of the loss and its gradients."""
    _loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = [timed_once(lambda: _loss_and_grads(model, params, batch))[1]
          for _ in range(repeats)]
    return {"ms": float(np.median(ms)), "ms_all": ms,
            "peak_gb_above_state":
            (torch.cuda.max_memory_allocated() - base) / 1e9}


def _full_width_step(seed: int, cfg, src) -> dict:
    """The full-width step measured (B = 8, S = 256, hardware-aware, bf16,
    float32 moments): median ms a step over `LM_TRAIN_TIMED` steps after
    2 warm ones (CUDA events), tokens/s, peak memory, the device profile
    of one step, the host ms of `SyntheticLM.batch`, the operation bound;
    then the loss and its gradients alone (`_fwd_bwd`) with the groups
    taken by `unbind_groups` and by per-group indexing (`group_slice`).
    """
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.optim import adamw

    B, S = LM_TRAIN_B, LM_TRAIN_S
    host_ms = []
    batches = []
    for i in range(2 + LM_TRAIN_TIMED):
        t0 = time.perf_counter()
        batches.append(src.batch(i, B, S, device=DEVICE))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    step = make_train_step(cfg, ShapeCfg("train_cli", S, B, "train"), None,
                           adamw.AdamWConfig(total_steps=100,
                                             warmup_steps=10),
                           hw_aware=HwAwareConfig())
    params = step.model.init(seed)
    opt = adamw.init(params)
    state_gb = (_tree_nbytes(params) + sum(
        t.numel() * t.element_size()
        for t in adamw.tree_leaves((opt.mu, opt.nu)))) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i, b in enumerate(batches):
        (params, opt, m), t = timed_once(lambda: step.fn(params, opt, b))
        losses.append(float(m["loss"]))
        if i >= 2:
            ms.append(t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _device_profile(lambda: step.fn(params, opt, batches[0]))
    step_ms = float(np.median(ms))

    backward = {"unbind_groups": _fwd_bwd(step.model, params, batches[0])}
    unbind = transformer.unbind_groups
    transformer.unbind_groups = lambda tree, G: [
        transformer.group_slice(tree, g) for g in range(G)]
    try:
        backward["group_slice"] = _fwd_bwd(step.model, params, batches[0])
    finally:
        transformer.unbind_groups = unbind
    flops = _train_flops(cfg, B, S)
    return {
        "batch": B, "seq": S, "tokens": B * S, "ms_per_step": step_ms,
        "ms_steps": ms, "tokens_per_s": B * S / step_ms * 1e3,
        "losses": losses, "peak_gb": peak, "state_gb": state_gb,
        **flops, "gap_to_bound": step_ms / flops["bound_ms"],
        "device_profile": prof,
        "device_busy_share": prof["device_busy_ms"] / step_ms,
        "synthetic_batch_host_ms": float(np.median(host_ms)),
        "loss_and_grads": backward,
        "finite": bool(np.isfinite(losses).all())}


def _fixed_batch(seed: int, cfg, src) -> dict:
    """8 steps on one batch at lr 1e-3, warmup 0, hardware-aware: the
    loss falls by more than 0.1 (the reference's own test's rule)."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    step = make_train_step(cfg, ShapeCfg("fixed", LM_TRAIN_S, LM_TRAIN_B,
                                         "train"), None,
                           adamw.AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=8),
                           hw_aware=HwAwareConfig())
    params = step.model.init(seed)
    opt = adamw.init(params)
    batch = src.batch(0, LM_TRAIN_B, LM_TRAIN_S, device=DEVICE)
    losses = []
    for _ in range(8):
        params, opt, m = step.fn(params, opt, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "fall": losses[0] - losses[-1],
            "ok": bool(np.isfinite(losses).all())
            and losses[-1] < losses[0] - 0.1}


def _long_step(seed: int, cfg, src) -> dict:
    """Steps at B = 1, S = 4096 (flash in every layer, 8 CE chunks), with
    remat on and off from the same state and batch: the step-1 loss must
    be bit-equal and the grad norms equal to 1e-3 relative; the second
    step's ms and each run's peak beside."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    batch = src.batch(0, 1, LM_TRAIN_LONG, device=DEVICE)
    out = {}
    for remat in (True, False):
        step = make_train_step(
            dataclasses.replace(cfg, remat=remat),
            ShapeCfg("long", LM_TRAIN_LONG, 1, "train"), None,
            adamw.AdamWConfig(total_steps=100, warmup_steps=10),
            hw_aware=HwAwareConfig())
        params = step.model.init(seed)
        opt = adamw.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (params, opt, m), first_ms = timed_once(
            lambda: step.fn(params, opt, batch))
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        # the step's outputs are its state: bound to the names deleted
        # below, or the next run would measure this one's state too
        (params, opt, m), ms = timed_once(
            lambda: step.fn(params, opt, batch))
        out["remat" if remat else "no_remat"] = {
            "loss": loss, "grad_norm": gnorm, "first_ms": first_ms,
            "ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, opt, step
        torch.cuda.empty_cache()
    on, off = out["remat"], out["no_remat"]
    gn_rel = abs(on["grad_norm"] - off["grad_norm"]) / off["grad_norm"]
    return {**out, "batch": 1, "seq": LM_TRAIN_LONG,
            "loss_bit_equal": on["loss"] == off["loss"],
            "grad_norm_rel_diff": gn_rel,
            "ok": on["loss"] == off["loss"] and gn_rel <= 1e-3
            and math.isfinite(on["loss"])}


def _eight_bit_moments(seed: int, cfg, src) -> dict:
    """3 full-width steps with 8-bit moments (B = 8, S = 256,
    hardware-aware): finite losses, and the peak memory and the state's
    bytes."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    step = make_train_step(cfg, ShapeCfg("q8", LM_TRAIN_S, LM_TRAIN_B,
                                         "train"), None,
                           adamw.AdamWConfig(total_steps=100, warmup_steps=10,
                                             state_bits=8),
                           hw_aware=HwAwareConfig())
    params = step.model.init(seed)
    opt = adamw.init(params, 8)
    state_gb = (_tree_nbytes(params) + sum(
        x.numel() * x.element_size()
        for t in adamw.tree_leaves((opt.mu, opt.nu)) for x in (t.q, t.scale)
    )) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(3):
        b = src.batch(i, LM_TRAIN_B, LM_TRAIN_S, device=DEVICE)
        (params, opt, m), t = timed_once(lambda: step.fn(params, opt, b))
        losses.append(float(m["loss"]))
        ms.append(t)
    return {"losses": losses, "ms_steps": ms, "state_gb": state_gb,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "ok": bool(np.isfinite(losses).all())}


def lm_train_phase(seed: int) -> dict:
    """Language-model training (`repro_torch.launch.train`, the port of
    ``python -m repro.launch.train``) at gemma2-2b's full width in bf16,
    hardware-aware, weights drawn on the card from ``seed``: the entry
    point driven once (`drive`) for `LM_TRAIN_STEPS` steps of B = 8,
    S = 256 (every logged loss and grad norm finite; the first loss beside
    ln(vocab)).  It launches none of K1-K6 (asserted: every count 0).
    Then: the reduced float32 model on the CPU and on the card (losses,
    grad norms, step-1 gradients; 32- and 8-bit moments); resume on the
    card, bit-equal; the flash backward at S = 8192; the full-width step
    measured; a fixed batch's falling loss; B = 1, S = 4096 with remat on
    and off; 8-bit moments at full width."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import train as lm_train

    t_phase = time.perf_counter()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(LM_ARCH)
    argv = ["--arch", LM_ARCH, "--steps", str(LM_TRAIN_STEPS), "--batch",
            str(LM_TRAIN_B), "--seq", str(LM_TRAIN_S), "--hardware-aware",
            "--log-every", "1", "--seed", str(seed)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (rows, log), counts, _ = drive(lambda: _quiet(lm_train.main, argv))
    entry = {"argv": argv, "seconds": time.perf_counter() - t0,
             "log_first": log[:2], "log_last": log[-1:],
             "losses": [r["loss"] for r in rows],
             "grad_norms": [r["grad_norm"] for r in rows],
             "first_loss": rows[0]["loss"],
             "ln_vocab": math.log(cfg.vocab_size),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    entry["finite"] = bool(np.isfinite(entry["losses"]).all()
                           and np.isfinite(entry["grad_norms"]).all()
                           and len(rows) == LM_TRAIN_STEPS)
    torch.cuda.empty_cache()

    cross = _lm_train_cpu_vs_card(seed)
    resume = _lm_train_resume(seed)
    flash_rows = _lm_flash_backward(seed, cfg)
    torch.cuda.empty_cache()
    src = make_source(DataConfig(seed=seed, vocab_size=cfg.vocab_size))
    measured = _full_width_step(seed, cfg, src)
    torch.cuda.empty_cache()
    fixed = _fixed_batch(seed, cfg, src)
    torch.cuda.empty_cache()
    long = _long_step(seed, cfg, src)
    eight = _eight_bit_moments(seed, cfg, src)
    eight["peak_gb_float32_moments"] = measured["peak_gb"]
    torch.cuda.empty_cache()
    res = {"phase": "lm_train", "arch": LM_ARCH, "dtype": cfg.dtype,
           "kernel_launches": {k: counts[k] for k in KERNELS},
           "resident_gb_at_start": resident_gb,
           "entry_point": entry, "f32_cpu_vs_card": cross,
           "resume_on_card": resume, "flash_backward": flash_rows,
           "step": measured, "fixed_batch": fixed, "long_step": long,
           "eight_bit_moments": eight,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    checks = {
        "no_kernel_launched": all(c == 0 for c in counts.values()),
        "entry_point_finite": entry["finite"],
        "f32_cpu_vs_card": cross["ok"], "resume_bit_equal": resume["ok"],
        "flash_backward": all(r["ok"] for r in flash_rows),
        "step_finite": measured["finite"], "fixed_batch_falls": fixed["ok"],
        "remat_on_off": long["ok"], "eight_bit_moments": eight["ok"]}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"an lm_train check failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# phase: the other language-model families (no kernel of K1-K6)
# ---------------------------------------------------------------------------
LMF_MODELS = (     # arch, depth (None: the config's), trained here
    ("granite-moe-1b-a400m", None, True),
    ("rwkv6-3b", None, True),
    ("whisper-tiny", None, True),
    ("jamba-v0.1-52b", 8, False),    # one period: 7 Mamba, 1 attention, 4 MoE
    ("kimi-k2-1t-a32b", 2, False),   # the dense prefix + one MoE layer
)
LMF_LONG = 1024        # one prompt past TOK_CHUNK, SEQ_CHUNK, 16 WKV chunks
LMF_WHISPER_S = 448    # whisper's decoder context: the teacher-forced pass
LMF_TRAIN_STEPS = 8    # steps on one fixed batch (B = 8, S = 256)
LMF_WHISPER_TOL = 1e-3  # decode vs forward logits, float32, TF32 off


def _lmf_config(arch: str, depth):
    """The full-width config, its depth cut to ``depth`` layers where
    given (the card cannot hold jamba's 32 or kimi's 61)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         num_layers=depth)


def _ample(cfg):
    """``cfg`` with a capacity factor E / k: every expert's capacity holds
    every token, so a teacher-forced pass drops none (decode never
    does)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _last_logits_rule(pre, fwd) -> dict:
    """Prefill's last logits against the forward's: 2e-3 absolute plus one
    bf16 ulp (2^-7) of |forward| (`lm_serve`'s rule)."""
    diff = (pre.float() - fwd.float()).abs()
    return {"max_abs_err": diff.max().item(),
            "ok": bool((diff <= 2e-3 + 2 ** -7 * fwd.float().abs()).all())
            and bool(torch.isfinite(pre).all())}


def _rms_rule(got, want) -> dict:
    """Decode against the teacher-forced forward: within 0.25 of the
    forward logits' RMS (`lm_serve`'s bf16 rule)."""
    gap = (got.float() - want.float()).abs().max().item()
    rms = want.float().square().mean().sqrt().item()
    return {"max_abs_err": gap, "rms_logits": rms, "tolerance": 0.25 * rms,
            "ok": gap <= 0.25 * rms and bool(torch.isfinite(got).all())}


def _moe_split(p: dict, m, x) -> dict:
    """One MoE layer's call on ``x`` in one shot, timed whole and by part
    (CUDA events, median of 5): the router (logits, top-k, ranks and the
    one-hot dispatch mask, `moe._route`), the dispatch einsum, the expert
    GEMMs (`moe._experts`, every expert on its C slots) and the combine
    (weights and einsum)."""
    from repro_torch.models import moe as moe_mod

    C = moe_mod._capacity(x.shape[1], m)
    disp, gate_e, _, _ = moe_mod._route(p, m, x, C)
    buf = torch.einsum("btec,btd->becd", disp, x)
    out = moe_mod._experts(p, buf)

    def combine():
        comb = disp * gate_e[..., None].to(x.dtype)
        return torch.einsum("btec,becd->btd", comb, out)
    parts = {
        "router_ms": cuda_ms(lambda: moe_mod._route(p, m, x, C), 5),
        "dispatch_einsum_ms": cuda_ms(
            lambda: torch.einsum("btec,btd->becd", disp, x), 5),
        "expert_gemms_ms": cuda_ms(lambda: moe_mod._experts(p, buf), 5),
        "combine_ms": cuda_ms(combine, 5)}
    whole = cuda_ms(lambda: moe_mod.moe_layer(p, m, x), 5)
    return {"shape": list(x.shape), "capacity": C, **parts,
            "layer_ms": whole,
            "expert_share": parts["expert_gemms_ms"] / whole,
            "one_hot_share": (parts["dispatch_einsum_ms"]
                              + parts["combine_ms"]) / whole}


def _recurrence_share(cfg, calls: dict) -> dict:
    """The WKV / selective-scan share of each call in ``calls`` (name ->
    fn): its time (CUDA events, median of 5) with the recurrence, and
    with the recurrence swapped for a stand-in that returns its inputs
    (`rwkv._wkv_chunked` -> zeros and S0; `mamba._selective_scan` -> bx
    and h0); share = 1 - without / with.  Both times of a call are taken
    back to back under the same host load."""
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import rwkv as rwkv_mod

    if cfg.rwkv is not None:
        mod, name = rwkv_mod, "_wkv_chunked"
        stand_in = lambda r, k, v, w, u, S0: (torch.zeros_like(r), S0)  # noqa: E731
    else:
        mod, name = mamba_mod, "_selective_scan"
        stand_in = lambda a, bx, h0: (bx, h0)  # noqa: E731
    out = {"recurrence": name}
    real = getattr(mod, name)
    for call, fn in calls.items():
        with_ms = cuda_ms(fn, 5)
        setattr(mod, name, stand_in)
        try:
            without_ms = cuda_ms(fn, 5)
        finally:
            setattr(mod, name, real)
        out[call] = {"ms": with_ms, "without_ms": without_ms,
                     "share": 1.0 - without_ms / with_ms}
    return out


def _lmf_step_flops(cfg, params, batch: int, seq: int) -> dict:
    """A train step's model operations from the shapes: 6 per matrix
    entry a token meets (forward 2, backward 4; a MoE layer's experts at
    k / E, the tied unembed's table once; gathers, norms and elementwise
    leaves not counted), plus attention's QK and PV over the keys each
    query's mask keeps and RWKV's intra-chunk products (x3 for the
    backward); the bound at the dtype's peak (bf16 tensor cores, or
    float32 outside them)."""
    from repro_torch.models import transformer

    elementwise = ("A_log", "conv_w", "mu", "u_bonus")

    def entries(tree, path=""):
        if isinstance(tree, dict):
            return sum(entries(v, f"{path}/{k}") for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return sum(entries(v, path) for v in tree)
        name = path.rsplit("/", 1)[-1]
        if tree.ndim < 2 or "embed" in name or name in elementwise:
            return 0
        n = tree.numel()
        if name.startswith("we_"):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        return n

    hd, H = cfg.hd(), cfg.num_heads
    tied = cfg.vocab_size * cfg.d_model if cfg.tie_embeddings else 0
    if cfg.enc_dec is not None:
        E = cfg.enc_dec.enc_seq
        enc = entries(params["encoder"])
        dec_kv = sum(p["xattn"][w].numel() for p in params["decoder"]
                     for w in ("wk", "wv"))
        dec = entries(params["decoder"]) - dec_kv
        mat = (enc + dec_kv) * batch * E + (dec + tied) * batch * seq
        attn = batch * H * hd * 4 * (
            cfg.enc_dec.enc_layers * E * E + cfg.num_layers * (
                seq * (seq + 1) // 2 + seq * E))
    else:
        mat = (entries(params) + tied) * batch * seq
        attn = 0
        for p in transformer.period_plan(cfg):
            if p.kind == "attn":
                attn += 4 * H * hd * batch * seq * (seq + 1) // 2
            elif p.kind == "rwkv":
                c = min(64, seq)
                attn += batch * seq * cfg.d_model * (4 * c + 4 * hd)
        attn *= transformer.n_groups(cfg)
    flops = 6 * mat + 3 * attn
    peak = FP32_OPS_PER_S if cfg.dtype == "float32" else BF16_TC_OPS_PER_S
    return {"model_flops": flops, "bound_ms": flops / peak * 1e3,
            "bound_by": "operations",
            "peak": "float32" if cfg.dtype == "float32" else "bf16"}


def _lmf_train(seed: int, cfg) -> dict:
    """`make_train_step` (hardware-aware, `HwAwareConfig()`; remat as the
    config has it; float32 moments) for `LMF_TRAIN_STEPS` steps on one
    fixed `SyntheticLM` batch (B = 8, S = 256; whisper also 8 x 1500
    frames) at lr 1e-3, warmup 0: every loss and grad norm finite, the
    loss falls by more than 0.1 (`lm_train`'s fixed-batch rule); ms a
    step (median of the last 6), tokens/s, peak memory, one step's
    device profile and its operation bound."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    B, S = LM_TRAIN_B, LM_TRAIN_S
    step = make_train_step(cfg, ShapeCfg("lmf", S, B, "train"), None,
                           adamw.AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=LMF_TRAIN_STEPS),
                           hw_aware=HwAwareConfig(), device=DEVICE)
    params = step.model.init(seed)
    opt = adamw.init(params)
    src = make_source(DataConfig(seed=seed, vocab_size=cfg.vocab_size))
    batch = src.batch(0, B, S, device=DEVICE)
    if cfg.enc_dec is not None:
        gen = torch.Generator(device=DEVICE).manual_seed(seed + 41)
        batch["frontend_embeds"] = 0.02 * torch.randn(
            (B, cfg.enc_dec.enc_seq, cfg.d_model), generator=gen,
            device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, ms = [], [], []
    for _ in range(LMF_TRAIN_STEPS):
        (params, opt, m), t = timed_once(lambda: step.fn(params, opt, batch))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        ms.append(t)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _device_profile(lambda: step.fn(params, opt, batch), top=6)
    step_ms = float(np.median(ms[2:]))
    flops = _lmf_step_flops(cfg, params, B, S)
    out = {"batch": B, "seq": S, "hw_aware": True, "remat": cfg.remat,
           "losses": losses, "grad_norms": gnorms,
           "fall": losses[0] - losses[-1], "ms_steps": ms,
           "ms_per_step": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
           "peak_gb": peak, **flops, "gap_to_bound": step_ms
           / flops["bound_ms"], "device_profile": prof,
           "device_busy_share": prof["device_busy_ms"] / step_ms}
    out["ok"] = bool(np.isfinite(losses).all() and np.isfinite(gnorms).all()
                     and losses[-1] < losses[0] - 0.1)
    del params, opt, step, batch
    torch.cuda.empty_cache()
    return out


def _lmf_decoder(seed: int, arch: str, depth, trained: bool) -> dict:
    """One decoder-only family at full width: parameters drawn on the card
    from ``seed``, `launch.serve.generate` driven once (`drive`: prefill
    of B=4 x P=32, the graft into a 128-token cache, 31 sampled decode
    steps) and again warm for its times; prefill == forward's last
    logits; decode continues prefill (with every expert's capacity
    ample, `_ample`; the config's own capacity reported beside); a
    1024-token prompt (not kimi); a decode step's device profile and
    byte bound (every parameter, the one-hot MoE reading every expert,
    and the cache); the MoE split or the recurrence share; training
    where ``trained``."""
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    cfg = _lmf_config(arch, depth)
    model = build_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def path():
        t1 = time.perf_counter()
        params = model.init(seed)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                                generator=gen, device=DEVICE)
        out = lm_serve.generate(model, params, prompts, LM_GEN, LM_MAX_SEQ,
                                1.0, gen)
        return params, prompts, out, init_s

    (params, prompts, first, init_s), counts, _ = drive(path)
    peak_serve = torch.cuda.max_memory_allocated() / 1e9
    tokens = first["tokens"]
    n_params = sum(t.numel() for _, t in _named_leaves(params))
    param_bytes = _tree_nbytes(params)
    res = {"arch": arch, "dtype": cfg.dtype, "layers": cfg.num_layers,
           "reduced": None if depth is None else
           f"depth {depth} of {_lmf_config(arch, None).num_layers} layers",
           "plans": [f"{p.kind}+{p.mlp}" for p in
                     transformer.prefix_plans(cfg)
                     + transformer.period_plan(cfg)],
           "kernel_launches": {k: counts[k] for k in KERNELS},
           "params": {"elements": n_params, "bytes_on_card": param_bytes,
                      "init_s": init_s}}
    with torch.inference_mode():
        fwd, aux = transformer.forward(params, cfg, prompts)
        pre, _ = transformer.prefill(params, cfg, prompts)
        res["prefill_vs_forward"] = _last_logits_rule(pre[:, 0], fwd[:, -1])
        res["aux_loss"] = float(aux)
        del fwd, pre
        ext = torch.cat([prompts, prompts[:, :1]], dim=1)
        for name, c in (("decode_vs_forward", _ample(cfg)),
                        ("decode_vs_forward_own_capacity", cfg)):
            if name.endswith("own_capacity") and cfg.moe is None:
                continue
            fwd_ext, _ = transformer.forward(params, c, ext)
            _, pc = transformer.prefill(params, c, prompts)
            cache = lm_serve.graft(transformer.init_cache(
                c, LM_BATCH, LM_MAX_SEQ, DEVICE), pc)
            dec, _ = transformer.decode_step(params, c, prompts[:, :1],
                                             LM_PROMPT, cache)
            res[name] = _rms_rule(dec[:, 0], fwd_ext[:, LM_PROMPT])
            del fwd_ext, pc, cache, dec
        if cfg.moe is not None:
            res["decode_vs_forward"]["capacity_factor"] = \
                _ample(cfg).moe.capacity_factor

        served = lm_serve.generate(model, params, prompts, LM_GEN,
                                   LM_MAX_SEQ, 1.0, gen)
        steps = served["decode_step_s"]
        _, pcache = transformer.prefill(params, cfg, prompts)
        cache = lm_serve.graft(model.init_cache(LM_BATCH, LM_MAX_SEQ), pcache)
        del pcache
        tok = tokens[:, -1:]

        def step():
            return model.decode_step(params, tok, LM_PROMPT, cache)
        decode_ms = cuda_ms(step, repeats=10)
        busy = _device_busy(step)
        cache_bytes = _tree_nbytes(cache)
        moved = param_bytes + cache_bytes
        res["served"] = {
            "first_prefill_ms": first["prefill_s"] * 1e3,
            "prefill_ms": served["prefill_s"] * 1e3,
            "graft_ms": served["graft_s"] * 1e3,
            "decode_ms_per_token": float(np.median(steps)) * 1e3,
            "tokens_per_s": LM_BATCH * len(steps) / sum(steps),
            "tokens_in_vocab": bool(((tokens >= 0)
                                     & (tokens < cfg.vocab_size)).all())
            and tuple(tokens.shape) == (LM_BATCH, LM_GEN),
            "peak_gb": peak_serve}
        res["decode_step"] = {
            "ms": decode_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": moved, "cache_bytes": cache_bytes,
            "gap": decode_ms / (moved / HBM_BYTES_PER_S * 1e3), **busy,
            "device_idle_share": 1.0 - busy["device_busy_ms"] / decode_ms}
        calls = {"prefill": lambda: transformer.prefill(params, cfg,
                                                        prompts),
                 "decode": step}
        if arch != "kimi-k2-1t-a32b":
            long = torch.randint(0, cfg.vocab_size, (1, LMF_LONG),
                                 generator=gen, device=DEVICE)
            torch.cuda.reset_peak_memory_stats()
            (ll, _), first_ms = timed_once(
                lambda: transformer.prefill(params, cfg, long))
            long_ms = cuda_ms(lambda: transformer.prefill(params, cfg, long),
                              repeats=1)
            lf, _ = transformer.forward(params, cfg, long)
            res["long_prefill"] = {
                "tokens": LMF_LONG, "ms_first": first_ms, "ms": long_ms,
                "tokens_per_s": LMF_LONG / long_ms * 1e3,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "vs_forward": _last_logits_rule(ll[:, 0], lf[:, -1])}
            calls["long_prefill"] = lambda: transformer.prefill(
                params, cfg, long)
            del ll, lf
        if cfg.moe is not None:
            slot = next(f"layer_{i}" for i, p in
                        enumerate(transformer.period_plan(cfg))
                        if p.mlp == "moe")
            lp = transformer.group_slice(params["blocks"][slot]["moe"], 0)
            dt = getattr(torch, cfg.dtype)
            res["moe_split"] = [
                _moe_split(lp, cfg.moe, torch.randn(
                    (b, s, cfg.d_model), generator=gen, device=DEVICE
                ).to(dt)) for b, s in ((LM_BATCH, 1), (LM_BATCH, LM_PROMPT))
                + (((LM_TRAIN_B, LM_TRAIN_S),) if trained else ())]
            del lp     # views of the stacked experts: free them with params
        if cfg.rwkv is not None or cfg.hybrid is not None:
            res["recurrence_share"] = _recurrence_share(cfg, calls)
        del calls, cache
    del params
    torch.cuda.empty_cache()
    if trained:
        res["train"] = _lmf_train(seed, cfg)
    res["seconds"] = time.perf_counter() - t0
    res["checks"] = {
        "no_kernel_launched": all(c == 0 for c in counts.values()),
        "param_count": n_params > 0,
        "prefill_vs_forward": res["prefill_vs_forward"]["ok"],
        "decode_vs_forward": res["decode_vs_forward"]["ok"],
        "tokens": res["served"]["tokens_in_vocab"],
        "long_prefill": res.get("long_prefill", {"vs_forward": {"ok": True}}
                                )["vs_forward"]["ok"],
        "train": res["train"]["ok"] if trained else True}
    torch.cuda.empty_cache()
    return res


def _lmf_whisper(seed: int) -> dict:
    """whisper-tiny at full width and depth (float32, TF32 off): drawn on
    the card, driven once (`drive`): `encode` of 4 x 1500 frames, each
    decoder layer's cross cache filled by `cross_kv`, then 448 decode
    steps teacher-forced on the tokens; the teacher-forced `forward` at
    S = 448 beside them, position by position within
    `LMF_WHISPER_TOL`; encode / forward / decode times, a decode step's
    device profile and byte bound (every parameter and the self and
    cross caches); training."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import whisper
    from repro_torch.models.model import build_model

    t0 = time.perf_counter()
    tf32 = _tf32_off()
    cfg = _lmf_config("whisper-tiny", None)
    model = build_model(cfg, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    B, S = LM_BATCH, LMF_WHISPER_S
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def fill(params, cache, enc):
        for p, cx in zip(params["decoder"], cache["cross"]):
            k, v = attn_mod.cross_kv(p["xattn"], cfg, enc)
            cx["k"].copy_(k)
            cx["v"].copy_(v)
        return cache

    def path():
        params = model.init(seed)
        frames = 0.02 * torch.randn((B, cfg.enc_dec.enc_seq, cfg.d_model),
                                    generator=gen, device=DEVICE)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=DEVICE)
        with torch.inference_mode():
            cache = fill(params, model.init_cache(B, S),
                         whisper.encode(params, cfg, frames))
            logits, step_s = [], []
            for pos in range(S):
                ts = time.perf_counter()
                lg, cache = model.decode_step(params, toks[:, pos:pos + 1],
                                              pos, cache)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - ts)
                logits.append(lg)
        return params, frames, toks, cache, torch.cat(logits, 1), step_s

    (params, frames, toks, cache, dec, step_s), counts, _ = drive(path)
    with torch.inference_mode():
        fwd, _ = whisper.forward(params, cfg, toks, frames)
        gap = (dec - fwd).abs()
        per_pos = gap.amax(dim=(0, 2))
        enc_ms = cuda_ms(lambda: whisper.encode(params, cfg, frames))
        fwd_ms = cuda_ms(lambda: whisper.forward(params, cfg, toks, frames))

        def step():
            return model.decode_step(params, toks[:, :1], S - 1, cache)
        decode_ms = cuda_ms(step, repeats=10)
        busy = _device_busy(step)
    param_bytes = _tree_nbytes(params)
    moved = param_bytes + _tree_nbytes(cache)
    res = {"arch": "whisper-tiny", "dtype": cfg.dtype, "tf32": tf32,
           "layers": {"encoder": cfg.enc_dec.enc_layers,
                      "decoder": cfg.num_layers},
           "reduced": None, "enc_seq": cfg.enc_dec.enc_seq, "batch": B,
           "decoder_seq": S,
           "kernel_launches": {k: counts[k] for k in KERNELS},
           "params": {"elements": sum(t.numel()
                                      for _, t in _named_leaves(params)),
                      "bytes_on_card": param_bytes},
           "decode_vs_forward": {
               "positions": S, "max_abs_err": gap.max().item(),
               "worst_position": int(per_pos.argmax()),
               "rms_logits": fwd.square().mean().sqrt().item(),
               "tolerance": LMF_WHISPER_TOL,
               "ok": gap.max().item() <= LMF_WHISPER_TOL
               and bool(torch.isfinite(dec).all())},
           "encode_ms": enc_ms, "forward_ms": fwd_ms,
           "served": {"decode_ms_per_token": float(np.median(step_s)) * 1e3,
                      "tokens_per_s": B * len(step_s) / sum(step_s),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
           "decode_step": {
               "ms": decode_ms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "bytes": moved,
               "gap": decode_ms / (moved / HBM_BYTES_PER_S * 1e3), **busy,
               "device_idle_share": 1.0 - busy["device_busy_ms"]
               / decode_ms}}
    del params, cache, dec, fwd, gap
    torch.cuda.empty_cache()
    res["train"] = _lmf_train(seed, cfg)
    res["seconds"] = time.perf_counter() - t0
    res["checks"] = {
        "no_kernel_launched": all(c == 0 for c in counts.values()),
        "decode_vs_forward": res["decode_vs_forward"]["ok"],
        "train": res["train"]["ok"]}
    return res


def _lmf_cpu_vs_card(seed: int) -> dict:
    """Each family's reduced float32 model drawn on the CPU and copied to
    the card (TF32 off, asserted): `Model.loss`, the forward logits and,
    for the decoder-only ones, a prefill + graft + decode step's logits
    agree to 1e-4."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import transformer, whisper
    from repro_torch.models.model import build_model

    _tf32_off()
    rows = {}
    for arch, _, _ in LMF_MODELS:
        cfg = get_reduced_config(arch)
        cpu, card = (build_model(cfg, device=d) for d in ("cpu", DEVICE))
        params = cpu.init(seed)
        g = torch.Generator().manual_seed(seed)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        if cfg.enc_dec is not None:
            batch["frontend_embeds"] = 0.02 * torch.randn(
                (2, cfg.enc_dec.enc_seq, cfg.d_model), generator=g)
        out = {}
        with torch.inference_mode():
            for name, m, p, b in (("cpu", cpu, params, batch),
                                  ("card", card, _tree_to(params, DEVICE),
                                   {k: v.to(DEVICE)
                                    for k, v in batch.items()})):
                loss = m.loss(p, b)
                if cfg.enc_dec is not None:
                    fwd, _ = whisper.forward(p, cfg, b["tokens"],
                                             b["frontend_embeds"])
                    dec = fwd[:, :1]
                else:
                    fwd, _ = transformer.forward(p, cfg, b["tokens"])
                    _, pre = transformer.prefill(p, cfg, b["tokens"][:, :48])
                    cache = lm_serve.graft(m.init_cache(2, 64), pre)
                    dec, _ = m.decode_step(p, b["tokens"][:, 48:49], 48,
                                           cache)
                out[name] = (loss.cpu(), fwd.cpu(), dec.cpu())
        errs = [(a - b).abs().max().item()
                for a, b in zip(out["cpu"], out["card"])]
        rows[arch] = {"loss_err": errs[0], "forward_max_abs_err": errs[1],
                      "decode_max_abs_err": errs[2],
                      "ok": max(errs) <= 1e-4}
    return {"tolerance": 1e-4, "rows": rows,
            "ok": all(r["ok"] for r in rows.values())}


def _lmf_scan_backward(seed: int) -> dict:
    """Mamba's closed-form scan backward (`mamba._SelectiveScan`) against
    autograd through the chunked scan (`mamba._scan_impl`), at jamba's
    width: B = 1, S = 1024, d_inner 8192, N 16, float32, the decay
    a = exp(dt·A) with dt in [1e-3, 1e-1] and A = -1..-16; gradients of
    sum(h · w) in a, bx and h0 within 1e-5 of each one's max; each way's
    ms (forward + backward) and peak memory."""
    from repro_torch.models import mamba as mamba_mod

    hc = _lmf_config("jamba-v0.1-52b", 8).hybrid
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 31)
    B, S = 1, LMF_LONG
    d, N = hc.expand * _lmf_config("jamba-v0.1-52b", 8).d_model, hc.d_state
    dt = 1e-3 + (0.1 - 1e-3) * torch.rand((B, S, d, 1), generator=gen,
                                          device=DEVICE)
    A = torch.arange(1, N + 1, device=DEVICE, dtype=torch.float32)
    a = torch.exp(-dt * A)
    del dt
    bx = 0.1 * torch.randn((B, S, d, N), generator=gen, device=DEVICE)
    h0 = torch.randn((B, d, N), generator=gen, device=DEVICE)
    w = torch.randn((B, S, d, N), generator=gen, device=DEVICE)
    rows, grads = {}, {}
    for name, fn in (("custom", mamba_mod._selective_scan),
                     ("autograd", mamba_mod._scan_impl)):
        def run():
            ts = [t.detach().requires_grad_() for t in (a, bx, h0)]
            h_all, _ = fn(*ts)
            return torch.autograd.grad((h_all * w).sum(), ts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads[name], ms = timed_once(run)
        rows[name] = {"ms_first": ms, "ms": cuda_ms(run, repeats=1),
                      "peak_gb_above_inputs":
                      (torch.cuda.max_memory_allocated() - base) / 1e9}
    rel = [(g1 - g2).abs().max().item() / g2.abs().max().item()
           for g1, g2 in zip(grads["custom"], grads["autograd"])]
    del grads, a, bx, h0, w
    torch.cuda.empty_cache()
    return {"shape": [B, S, d, N], **rows,
            "max_err_over_max": dict(zip(("a", "bx", "h0"), rel)),
            "tolerance": 1e-5, "ok": max(rel) <= 1e-5}


def _lmf_moe_chunked(seed: int) -> dict:
    """granite's MoE layer (32 experts, top 8, d_model 1024) in float32
    (TF32 off) on 2 x 1024 tokens with every capacity ample (factor
    E / k = 4): in two chunks of `TOK_CHUNK` and in one shot, outputs
    within 1e-5 of their max, the aux losses within 1e-6."""
    from repro_torch.models import moe as moe_mod

    _tf32_off()
    cfg = _ample(_lmf_config("granite-moe-1b-a400m", None))
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 37)
    p = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, torch.float32)
    x = torch.randn((2, LMF_LONG, cfg.d_model), generator=gen, device=DEVICE)
    chunked, aux_c = moe_mod.moe_layer(p, cfg.moe, x)
    keep = moe_mod.TOK_CHUNK
    moe_mod.TOK_CHUNK = 4 * LMF_LONG
    try:
        shot, aux_s = moe_mod.moe_layer(p, cfg.moe, x)
    finally:
        moe_mod.TOK_CHUNK = keep
    err = (chunked - shot).abs().max().item() / shot.abs().max().item()
    aux_err = abs(aux_c.item() - aux_s.item())
    return {"shape": list(x.shape), "chunks": LMF_LONG // keep,
            "max_err_over_max": err, "aux_chunked": aux_c.item(),
            "aux_one_shot": aux_s.item(), "aux_err": aux_err,
            "ok": err <= 1e-5 and aux_err <= 1e-6}


def lm_families_phase(seed: int) -> dict:
    """The other language-model families at full width on the card (the
    ports of `repro.models.moe`, `mamba`, `rwkv` and `whisper`; no kernel
    of K1-K6, asserted: every count 0): granite-moe-1b-a400m, rwkv6-3b
    and whisper-tiny at full depth, jamba-v0.1-52b cut to one period (8
    layers) and kimi-k2 to its dense prefix and one MoE layer, each
    served (`_lmf_decoder`, `_lmf_whisper`) and, the first three,
    trained; each model freed before the next, kimi last.  Then the
    reduced float32 models on the CPU and the card, Mamba's custom
    backward against autograd at jamba's width, granite's MoE layer
    chunked against one shot."""
    t_phase = time.perf_counter()
    models = []
    for arch, depth, trained in LMF_MODELS:
        if arch == "whisper-tiny":
            models.append(_lmf_whisper(seed))
        else:
            models.append(_lmf_decoder(seed, arch, depth, trained))
        torch.cuda.empty_cache()
    cross = _lmf_cpu_vs_card(seed)
    scan = _lmf_scan_backward(seed)
    chunked = _lmf_moe_chunked(seed)
    res = {"phase": "lm_families", "models": models,
           "f32_cpu_vs_card": cross, "mamba_scan_backward": scan,
           "moe_chunked_vs_one_shot": chunked,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    failed = [f"{m['arch']}:{k}" for m in models
              for k, v in m["checks"].items() if not v]
    failed += [k for k, v in (("f32_cpu_vs_card", cross["ok"]),
                              ("mamba_scan_backward", scan["ok"]),
                              ("moe_chunked_vs_one_shot", chunked["ok"]))
               if not v]
    if failed:
        raise AssertionError(f"an lm_families check failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# phase: many devices and the dry run (K1 and K5 through the lattice twin)
# ---------------------------------------------------------------------------
# the dry run's cells: gemma2-2b at full width, each traced as rank 0 of
# the production rank mesh (`launch.dryrun.rank_trace`), CPU only
MESH_DRYRUN_CELLS = (("train_4k", "pod"), ("prefill_32k", "pod"),
                     ("decode_32k", "pod"), ("train_4k", "multipod"))
# the cells start with the language-model phases and trace beside them
# (prefill_32k's two traces take ~5 minutes on one core)
MESH_DRYRUN_TIMEOUT_S = 900
MESH_REMAT_S = 4096           # REPRO_REMAT=dots against the default, B = 1


def _start_dry_runs(out_dir: Path) -> dict:
    """`python -m repro_torch.launch.dryrun` for gemma2-2b at each of
    `MESH_DRYRUN_CELLS`, one process each on one thread, started together
    and with every GPU hidden: the dry run traces on fake and meta tensors
    and must not touch the card.  They run while the script drives the
    card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    return {f"{shape}/{mesh}": (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         LM_ARCH, "--shape", shape, "--mesh", mesh, "--force", "--out",
         str(out_dir)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
        for shape, mesh in MESH_DRYRUN_CELLS}


def _stop(procs: dict) -> None:
    """Kill what is left of the processes of ``procs`` ({name: (anything,
    process)}: `_start_dry_runs`', `_start_lmr_dry`')."""
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _finish_dry_runs(procs: dict, out_dir: Path) -> dict:
    """Each dry-run cell's record: status, the seconds it took to build
    the step and to trace it (whole, and as rank 0), argument bytes a
    device, the unsharded step's FLOPs, rank 0's FLOPs, their
    replication, its collectives by the reference's op names and by
    kind, its temporaries; a process that outlives
    `MESH_DRYRUN_TIMEOUT_S` is killed and its cell fails."""
    out = {}
    for cell, (t0, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=max(
                1.0, MESH_DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            out[cell] = {"status": "timeout", "ok": False}
            continue
        shape, mesh = cell.split("/")
        path = out_dir / f"{LM_ARCH}__{shape}__{mesh}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        mem, coll = rec.get("memory", {}), rec.get("collectives") or {}
        out[cell] = {
            "status": rec.get("status"), "returncode": proc.returncode,
            "seconds": time.perf_counter() - t0,
            "trace_s": rec.get("trace_s"),
            "build_s": rec.get("build_s"),
            "rank_trace_s": rec.get("rank_trace_s"),
            "argument_bytes_per_device": mem.get("argument_bytes"),
            "output_bytes_per_device": mem.get("output_bytes"),
            "temp_bytes": mem.get("temp_bytes"),
            "flops_global": rec.get("flops_global"),
            "dot_flops": rec.get("dot_flops"),
            "replication": rec.get("replication"),
            "per_op_bytes": coll.get("per_op_bytes"),
            "collective_bytes": coll.get("total_bytes"),
            "collective_calls": coll.get("calls"),
            "fits_hbm": rec.get("fits_hbm"),
            "ok": (proc.returncode == 0 and rec.get("status") == "ok"
                   and bool(coll.get("per_op_bytes"))
                   and isinstance(mem.get("temp_bytes"), int)),
            "stderr_tail": err[-400:] if proc.returncode else ""}
    return out


def _free() -> float:
    """Collect the garbage (an autograd graph under checkpointing holds
    its state in reference cycles), empty the allocator's cache, and
    return the GB still allocated on the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def _host_copy(tree) -> dict:
    """Every leaf of a tree on the host, keyed as the checkpoint keys."""
    from repro_torch.models.sharding import leaves_with_path
    return {k: t.detach().to("cpu", copy=True)
            for k, t in leaves_with_path(tree)}


def _leaves_equal(tree, host: dict) -> list:
    """Keys of the leaves of ``tree`` (on the card) that differ from
    their host copies in ``host``, bit for bit (leaf by leaf: no second
    state on the card)."""
    from repro_torch.models.sharding import leaves_with_path
    got = dict(leaves_with_path(tree))
    if set(got) != set(host):
        return sorted(set(got) ^ set(host))
    return [k for k, t in got.items()
            if not torch.equal(t.detach(), host[k].to(t.device))]


def _mesh_train(seed: int, cfg, src) -> dict:
    """Hardware-aware train steps at B = 8, S = 256 under
    `make_host_mesh(2, 4)` and with ``mesh=None``, from the same state and
    batches, under deterministic algorithms: the losses, grad norms and
    every updated leaf after 2 steps equal bit for bit (the first run's
    state copied to the host: two states do not fit on the card at
    once).  And the dry run's reckoning on a 1 x 1 mesh: its argument
    bytes equal the bytes the real state and batch occupy on the card."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.sharding import leaves_with_path
    from repro_torch.optim import adamw

    shape = ShapeCfg("mesh", LM_TRAIN_S, LM_TRAIN_B, "train")
    ocfg = adamw.AdamWConfig(total_steps=100, warmup_steps=10)
    batches = [src.batch(i, LM_TRAIN_B, LM_TRAIN_S, device=DEVICE)
               for i in range(2)]
    runs, host = {}, None
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for tag, mesh in (("mesh_2x4", make_host_mesh(2, 4)),
                          ("no_mesh", None)):
            step = make_train_step(cfg, shape, mesh, ocfg,
                                   hw_aware=HwAwareConfig())
            params = step.model.init(seed)
            opt = adamw.init(params)
            metrics, ms = [], []
            for b in batches:
                (params, opt, m), t = timed_once(
                    lambda: step.fn(params, opt, b))
                metrics.append({"loss": m["loss"].item(),
                                "grad_norm": m["grad_norm"].item()})
                ms.append(t)
            runs[tag] = {"metrics": metrics, "ms_steps": ms}
            if mesh is not None:
                runs[tag]["argument_bytes_per_device"] = sum(
                    dryrun.device_bytes(a, s, mesh)
                    for a, s in zip(step.abstract_args, step.in_specs))
                host = _host_copy((params, opt))
            else:
                differing = _leaves_equal((params, opt), host)
                one = make_host_mesh(1, 1)
                step11 = make_train_step(cfg, shape, one, ocfg,
                                         hw_aware=HwAwareConfig())
                reckoned = sum(
                    dryrun.device_bytes(a, s, one)
                    for a, s in zip(step11.abstract_args, step11.in_specs))
                real = sum(t.numel() * t.element_size() for _, t in
                           leaves_with_path((params, opt, batches[0])))
            del params, opt, step
            runs[tag]["gb_left_after"] = _free()
    finally:
        torch.use_deterministic_algorithms(prev)
    del host
    equal_metrics = runs["mesh_2x4"]["metrics"] == runs["no_mesh"]["metrics"]
    return {**runs, "batch": LM_TRAIN_B, "seq": LM_TRAIN_S,
            "leaves_differing": differing, "metrics_equal": equal_metrics,
            "argument_bytes_1x1_reckoned": reckoned,
            "argument_bytes_1x1_on_card": real,
            "ok": equal_metrics and not differing and reckoned == real
            and all(math.isfinite(m["loss"])
                    for m in runs["no_mesh"]["metrics"])}


def _mesh_serve(seed: int, cfg) -> dict:
    """`make_prefill_step` and `make_serve_step` under the production mesh
    against `launch.serve.generate` (B = 4 x P = 32, 31 greedy decode
    steps, the same parameters): the prefill logits and every decode
    step's logits bit for bit, fed the tokens generate chose."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model

    model = build_model(cfg, device=DEVICE)
    params = model.init(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=DEVICE)
    seen = {"prefill": None, "decode": []}
    prefill = transformer.prefill

    def prefill_seen(*a, **k):
        out = prefill(*a, **k)
        seen["prefill"] = out[0].clone()
        return out

    def decode_seen(p, tok, pos, cache):
        logits, cache = model.decode_step(p, tok, pos, cache)
        seen["decode"].append((tok.clone(), pos, logits.clone()))
        return logits, cache

    transformer.prefill = prefill_seen
    try:
        lm_serve.generate(dataclasses.replace(model, decode_step=decode_seen),
                          params, prompts, LM_GEN, LM_MAX_SEQ, 0.0)
    finally:
        transformer.prefill = prefill
    mesh = make_production_mesh()
    pstep = make_prefill_step(
        cfg, ShapeCfg("mesh_prefill", LM_PROMPT, LM_BATCH, "prefill"), mesh)
    sstep = make_serve_step(
        cfg, ShapeCfg("mesh_decode", LM_MAX_SEQ, LM_BATCH, "decode"), mesh)
    with torch.inference_mode():
        logits, pcache = pstep.fn(params, {"tokens": prompts})
        prefill_equal = torch.equal(logits, seen["prefill"])
        cache = lm_serve.graft(sstep.model.init_cache(LM_BATCH, LM_MAX_SEQ),
                               pcache)
        del pcache
        decode_equal = []
        for tok, pos, want in seen["decode"]:
            got, cache = sstep.fn(params, tok, pos, cache)
            decode_equal.append(bool(torch.equal(got, want)))
    return {"batch": LM_BATCH, "prompt": LM_PROMPT,
            "decode_steps": len(decode_equal), "mesh": dict(mesh.shape),
            "prefill_equal": bool(prefill_equal),
            "decode_steps_equal": sum(decode_equal),
            "ok": bool(prefill_equal) and len(decode_equal) == LM_GEN - 1
            and all(decode_equal)}


def _mesh_remat_dots(seed: int, cfg, src) -> dict:
    """Remat's two policies at B = 1, S = 4096, hardware-aware, from the
    same parameters and batch: the loss and every gradient leaf under
    ``REPRO_REMAT=dots`` equal the default's bit for bit (deterministic
    algorithms; the default's gradients copied to the host), and each
    policy's second train step timed with its peak memory."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.core.hwaware import HwAwareConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    batch = src.batch(0, 1, MESH_REMAT_S, device=DEVICE)
    out, host = {}, None
    saved = os.environ.get("REPRO_REMAT")
    try:
        for policy in ("default", "dots"):
            if policy == "dots":
                os.environ["REPRO_REMAT"] = "dots"
            else:
                os.environ.pop("REPRO_REMAT", None)
            step = make_train_step(
                dataclasses.replace(cfg, remat=True),
                ShapeCfg("remat", MESH_REMAT_S, 1, "train"), None,
                adamw.AdamWConfig(total_steps=100, warmup_steps=10),
                hw_aware=HwAwareConfig())
            params = step.model.init(seed)
            prev = torch.are_deterministic_algorithms_enabled()
            torch.use_deterministic_algorithms(True)
            try:
                loss, grads = _loss_and_grads(step.model, params, batch)
            finally:
                torch.use_deterministic_algorithms(prev)
            if host is None:
                host = _host_copy({"loss": loss, "grads": list(grads)})
                differing = None
            else:
                differing = _leaves_equal({"loss": loss,
                                           "grads": list(grads)}, host)
            del grads
            held = _free()
            opt = adamw.init(params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (params, opt, m), first_ms = timed_once(
                lambda: step.fn(params, opt, batch))
            (params, opt, m), ms = timed_once(
                lambda: step.fn(params, opt, batch))
            out[policy] = {"loss": loss.item(), "first_ms": first_ms,
                           "ms": ms, "grad_norm": m["grad_norm"].item(),
                           "gb_held_before": held,
                           "peak_gb": torch.cuda.max_memory_allocated()
                           / 1e9}
            del params, opt, step, m
            _free()
    finally:
        if saved is None:
            os.environ.pop("REPRO_REMAT", None)
        else:
            os.environ["REPRO_REMAT"] = saved
    return {**out, "batch": 1, "seq": MESH_REMAT_S,
            "grad_leaves_differing": differing,
            "extra_peak_gb": out["dots"]["peak_gb"] - out["default"]["peak_gb"],
            "ok": differing == [] and math.isfinite(out["dots"]["loss"])}


def _mesh_lattice(seed: int) -> tuple:
    """`examples_torch/pbit_lattice_pod.py` at full size (32 x 32 cells,
    8192 p-bits, 16 chains, 400 sweeps), in process, driven once
    (`drive`): ``barrier``, ``halo4`` and ``async`` on 4 logical bands and
    ``barrier`` on one; every K1 and K5 launch replayed through its plain
    version.  ``barrier`` on 4 bands equals one band bit for bit (spins
    and energy trace); sweeps/s, the energy-trace gaps and the napkin
    figure under the H100's constants."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "pbit_lattice_pod", ROOT / "examples_torch" / "pbit_lattice_pod.py")
    pod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pod)
    size = pod.sizes(False)

    def path():
        runs = {name: pod.anneal(name, 4, DEVICE, **size)
                for name in ("barrier", "halo4", "async")}
        runs["one_band"] = pod.anneal("barrier", 1, DEVICE, **size)
        return runs

    runs, counts, calls = drive(path)
    summary, worst = replay_all(calls)
    base, one = runs["barrier"], runs["one_band"]
    barrier_equal = bool(torch.equal(base["m"], one["m"])) and \
        np.array_equal(base["trace"], one["trace"])
    res = {"size": size, "bands": 4, "launches": counts, "replay": summary,
           "barrier_equals_one_band": barrier_equal, "_worst": worst}
    for name, r in runs.items():
        res[name] = {
            "backend": r["backend"], "sweeps_per_s": r["sweeps_per_s"],
            "seconds": r["seconds"],
            "energy_best": float(r["energy"].min()) / r["n_nodes"],
            "energy_mean": float(r["energy"].mean()) / r["n_nodes"],
            **({"halo_bytes_per_sweep": r["halo_bytes_per_sweep"],
                "napkin": r["napkin"]} if "napkin" in r else {})}
        if name in ("halo4", "async"):
            gap = np.abs(r["trace"] - base["trace"])
            res[name].update(trace_gap_mean=float(gap.mean()),
                             trace_gap_max=float(gap.max()))
    res["ok"] = barrier_equal and counts["sweep_sparse_exchange"] > 0 \
        and all(math.isfinite(runs[n]["sweeps_per_s"]) for n in runs)
    return res, calls


def _mesh_compression(seed: int, cfg, src) -> dict:
    """`runtime.compression.ef_compress_tree` over gemma2-2b's whole
    gradient tree (B = 8, S = 256, carried in float32) with a zero error:
    decompress + error == the gradient exactly, leaf for leaf; ms of the
    call (first and warm) and the payload's bytes against the bf16
    gradient's."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import compression as comp

    model = build_model(cfg, device=DEVICE)
    params = model.init(seed)
    batch = src.batch(0, LM_TRAIN_B, LM_TRAIN_S, device=DEVICE)
    _, grads = _loss_and_grads(model, params, batch)
    grad_bytes = sum(g.numel() * g.element_size() for g in grads)
    tree = adamw.tree_unflatten(params, [g.float() for g in grads])
    del grads, params
    _free()
    err = comp.init_error(tree)
    (packed, new_err), first_ms = timed_once(
        lambda: comp.ef_compress_tree(tree, err))
    del packed, new_err
    (packed, new_err), ms = timed_once(
        lambda: comp.ef_compress_tree(tree, err))
    leaves = []       # the `Compressed` leaves, in `tree_leaves` order
    comp._map_compressed(leaves.append, packed)
    exact = all(bool(torch.equal(comp.decompress(c) + e, g)) for c, e, g in
                zip(leaves, adamw.tree_leaves(new_err),
                    adamw.tree_leaves(tree)))
    payload = sum(c.q.numel() + 4 * c.scale.numel() for c in leaves)
    n = sum(g.numel() for g in adamw.tree_leaves(tree))
    del tree, err, packed, new_err, leaves
    _free()
    return {"elements": n, "first_ms": first_ms, "ms": ms,
            "payload_bytes": payload, "bf16_grad_bytes": grad_bytes,
            "payload_over_bf16": payload / grad_bytes,
            "decompress_plus_error_equals_grad": exact, "ok": exact}


def mesh_phase(seed: int, dry: tuple | None = None) -> tuple:
    """Many devices and the dry run (the ports of `repro.launch.mesh`,
    `models.sharding`, the step functions under a mesh, `launch.dryrun`,
    `runtime.compression`, ``REPRO_REMAT=dots`` and the lattice pod
    example).  The mesh is logical devices of this card: a step under any
    mesh must equal the ``mesh=None`` step bit for bit.  gemma2-2b at full
    width in bf16: a train step under `make_host_mesh(2, 4)` (and the 1 x
    1 reckoning of the argument bytes against the card), the prefill and
    serve steps under the production mesh against `launch.serve.generate`,
    remat's ``dots`` policy against the default at S = 4096, int8
    gradient compression of the whole gradient tree; the dry run's four
    cells (`MESH_DRYRUN_CELLS`), traced on the host's CPU while the card
    works (``dry``: (their processes, their directory) started earlier
    by `_start_dry_runs`, else started here); then the lattice twin
    through K1 and K5, every launch replayed.  Returns (the phase's line,
    the lattice's recorded launches)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import train as lm_train

    t_phase = time.perf_counter()
    gb_at_start = _free()
    cfg = get_config(LM_ARCH)
    src = make_source(DataConfig(seed=seed, vocab_size=cfg.vocab_size))
    with tempfile.TemporaryDirectory() as d:
        procs, dry_dir = dry or (_start_dry_runs(Path(d)), Path(d))
        try:
            t = time.perf_counter()
            train = _mesh_train(seed, cfg, src)
            train["seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            serve = _mesh_serve(seed, cfg)
            serve["seconds"] = time.perf_counter() - t
            serve["gb_left_after"] = _free()
            t = time.perf_counter()
            remat = _mesh_remat_dots(seed, cfg, src)
            remat["seconds"] = time.perf_counter() - t
            t = time.perf_counter()
            packed = _mesh_compression(seed, cfg, src)
            packed["seconds"] = time.perf_counter() - t
            rows, log = _quiet(lm_train.main, [
                "--reduced", "--steps", "2", "--log-every", "1", "--batch",
                "8", "--seq", "64", "--mesh", "host", "--data-model", "2",
                "4"])
            cli = {"start_line": next(ln for ln in log if "mesh=" in ln),
                   "losses": [r["loss"] for r in rows]}
            cli["ok"] = "(logical, cuda" in cli["start_line"]
            t = time.perf_counter()
            lattice, calls = _mesh_lattice(seed)
            lattice["seconds"] = time.perf_counter() - t
            dry = _finish_dry_runs(procs, dry_dir)
        finally:
            _stop(procs)
    res = {"phase": "mesh", "arch": LM_ARCH, "gb_at_start": gb_at_start,
           "card": nvidia_smi_line(),
           "train": train, "serve": serve,
           "remat_dots": remat, "compression": packed, "train_cli": cli,
           "dry_run": dry, "lattice_pod": lattice,
           "seconds": time.perf_counter() - t_phase}
    emit({k: v for k, v in res.items() if k != "lattice_pod"}
         | {"lattice_pod": {k: v for k, v in lattice.items()
                            if k != "_worst"}})
    failed = [k for k, v in (("train", train), ("serve", serve),
                             ("remat_dots", remat), ("compression", packed),
                             ("train_cli", cli), ("lattice_pod", lattice))
              if not v["ok"]]
    failed += [f"dry_run:{s}" for s, v in dry.items() if not v["ok"]]
    if failed:
        raise AssertionError(f"a mesh check failed: {failed}")
    return res, calls


# ---------------------------------------------------------------------------
# phase: the sharded engine across processes (K5 per card, boundary rows
# through torch.distributed)
# ---------------------------------------------------------------------------
RANKS_CELLS = 64        # the lattice's cell rows and columns: 32768 spins
RANKS_SWEEPS = 100      # sweeps a call (25 launches of 4 for the fused ones)
RANKS_WORLDS = (("nccl", 1), ("gloo", 2), ("gloo", 4))
RANKS_TIMEOUT_S = 300   # a rank's whole run, and its wait for a peer
RANKS_TIMED = 2         # timed calls a policy, after a warm one

# one rank of the ranks phase: python -c <this> backend rank world store out
_RANK_RUN = """
import sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.ranks_child(*sys.argv[1:])
"""

# NCCL with two ranks on the one card: python -c <this> rank store
_NCCL_SHARED_CARD = """
import datetime, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("nccl", store=dist.FileStore(sys.argv[2], 2),
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=30))
x = torch.ones(1, device="cuda:0")
dist.all_reduce(x)
torch.cuda.synchronize()
print("all_reduce", float(x))
dist.destroy_process_group()
"""


def _ranks_policies():
    from repro_torch import api
    return {"barrier": (api.Sync(), "sparse"),
            "halo4": (api.Sync(halo_every=4, sweeps_per_launch=4), "auto"),
            "async": (api.Sync(halo_every=4, mode="async",
                               sweeps_per_launch=4), "auto"),
            # exchange points inside a sweep: K5 in one process, K1
            # windows across ranks (a K5 window is whole sweeps)
            "halo1": (api.Sync(halo_every=1, sweeps_per_launch=4),
                      "fused_sparse")}


def _ranks_problem(seed: int):
    """The sharded phase's lattice (64x64 cells, 32768 spins, SK codes from
    the seed), its 256-chain state and schedule, the same in every
    process: (graph, machine, schedule, unsharded Session, chip, state)."""
    from repro_torch import api
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chimera

    g = make_chimera(RANKS_CELLS, RANKS_CELLS)
    rng = np.random.default_rng(seed + 400)
    mach = PBitMachine.create(g, seed + 400, sparse=True, noise="counter",
                              device=DEVICE)
    sched = api.Anneal(0.05, 3.0, n_sweeps=RANKS_SWEEPS)
    ses0 = mach.session(schedule=sched, chains=B)
    chip = ses0.program_edges(*sk_edge_codes(g, rng))
    st = ses0.init_state(ses0.generator(seed + 401))
    return g, mach, sched, ses0, chip, st


def _ranks_sessions(mach, sched, mesh):
    from repro_torch import api
    return {name: api.Session(mach.sampler_spec(
        schedule=sched, chains=B, mesh=mesh, sync=sync).replace(
            backend=backend))
        for name, (sync, backend) in _ranks_policies().items()}


def ranks_child(backend: str, rank: str, world: str, store: str,
                out: str, seed: str) -> None:
    """One rank of the ranks phase: join the group, build the problem,
    drive the four policies' Session calls once (`drive`: launch counts
    from 0, every K1 and K5 launch replayed through its plain version),
    time them, and leave the spins (int8) and noise states in ``out``.npz and a
    JSON record on stdout."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import ranks

    rank, world, seed = int(rank), int(world), int(seed)
    os.environ["RANK"] = str(rank)
    os.environ["LOCAL_RANK"] = "0" if backend == "nccl" else str(rank)
    ranks.init_rank(backend, rank, world, store_path=store,
                    timeout_s=RANKS_TIMEOUT_S)
    try:
        _, mach, sched, _, chip, st = _ranks_problem(seed)
        mesh = dist_mod.make_rank_mesh((SHARD_BANDS,), ("data",))
        sessions = _ranks_sessions(mach, sched, mesh)
        engines = {n: ses._engine for n, ses in sessions.items()}

        def path():
            return {n: ses.sample(chip, st.m, st.noise_state)
                    for n, ses in sessions.items()}

        sent0 = {n: e.comm.bytes_sent for n, e in engines.items()}
        outs, counts, calls = drive(path)
        sent = {n: e.comm.bytes_sent - sent0[n] for n, e in engines.items()}
        comm_s0 = {n: e.comm.seconds for n, e in engines.items()}
        summary, worst = replay_all(calls)
        k5 = calls["sweep_sparse_exchange"]
        ms = {n: cuda_ms(lambda ses=ses: ses.sample(chip, st.m,
                                                    st.noise_state),
                         RANKS_TIMED)
              for n, ses in sessions.items()}
        # host ms a call inside the transport (swaps and gathers, staging
        # included), over the timed calls and their warm-up
        comm_ms = {n: 1e3 * (e.comm.seconds - comm_s0[n]) / (RANKS_TIMED + 1)
                   for n, e in engines.items()}
        np.savez(out, **{f"{n}/m": o[0].to(torch.int8).cpu().numpy()
                         for n, o in outs.items()},
                 **{f"{n}/ns": o[1].cpu().numpy() for n, o in outs.items()})
        print(json.dumps({
            "rank": rank, "world": world, "backend": backend,
            "transport": {n: e.transport for n, e in engines.items()},
            "route": {n: e.route for n, e in engines.items()},
            "bands": engines["barrier"].R_loc,
            "launches": counts, "replay": summary, "worst": worst,
            "edge_block_launches": sum(
                kw.get("edge_halos") == "block" for _, kw, _ in k5),
            "bytes_sent_driven": sent,
            "ms_per_call": ms, "transport_host_ms_per_call": comm_ms}),
            flush=True)
    finally:
        import torch.distributed as tdist
        tdist.destroy_process_group()


def _start_ranks(code: str, world: int, argv, env=None) -> list:
    """``world`` processes running ``code`` with ``argv(rank)``; ``env``:
    variables set for them (before they import the port)."""
    env = dict(os.environ, **(env or {}))
    return [subprocess.Popen(
        [sys.executable, "-c", code, *argv(rank)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        for rank in range(world)]


def _finish_ranks(procs, timeout: float) -> list:
    """(exit code, stdout, stderr) of each rank; every process ends here:
    when one rank fails, or at the deadline, the others are killed."""
    import threading

    outs = [None] * len(procs)

    def read(i, proc):
        outs[i] = proc.communicate()

    readers = [threading.Thread(target=read, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(p.poll() is None
                                              for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for t in readers:
        t.join()
    return [(p.returncode, *outs[i]) for i, p in enumerate(procs)]


def _nccl_shared_card(tmp: Path) -> dict:
    """Two NCCL ranks on the one card: does NCCL refuse, and in what
    words?"""
    store = str(tmp / "nccl_shared_store")
    done = _finish_ranks(_start_ranks(_NCCL_SHARED_CARD, 2,
                                      lambda r: [str(r), store]), 60)
    said = [ln.strip() for _, _, err in done for ln in err.splitlines()
            if "Duplicate GPU" in ln or "ncclInvalidUsage" in ln
            or "Error" in ln]
    return {"exit_codes": [rc for rc, _, _ in done],
            "refused": any(rc != 0 for rc, _, _ in done),
            "stdout": [o.strip()[-200:] for _, o, _ in done],
            "said": said[:4]}


def ranks_phase(seed: int) -> dict:
    """The sharded engine across processes on the card, each world a
    group of child processes (one rank each; the libraries already built
    by this process, so the ranks load them): NCCL at world size 1 (8
    bands on one rank), then 2 and 4 gloo ranks sharing the card (4 and 2
    bands a rank, the boundary rows staged through host memory), each
    under four policies at 100 sweeps a call — ``Sync()`` (the scan),
    ``halo_every=4`` and its async twin (K5 per card: every launch two K5
    windows with ``edge_halos="block"``, the rank's edge halos from the
    process group between them), and ``halo_every=1`` on the fused
    kernels (K5 on one rank; across ranks K1 windows, a half-sweep each).
    Every rank of every world returns the one-process engine's spins and
    noise state bit for bit (the barrier and ``halo_every=1`` also the
    unsharded Session's), each rank's driven run launched K1 and K5 where
    its route says so, and every launch equals its plain version.  Two
    NCCL ranks on the one card are tried once and their refusal
    recorded."""
    import tempfile

    from repro_torch.core import distributed as dist_mod

    t_phase = time.perf_counter()
    _, mach, sched, ses0, chip, st = _ranks_problem(seed)
    unsharded = ses0.sample(chip, st.m, st.noise_state)
    logical = _ranks_sessions(mach, sched,
                              dist_mod.make_mesh((SHARD_BANDS,), ("data",)))
    want = {n: ses.sample(chip, st.m, st.noise_state)
            for n, ses in logical.items()}
    one_ms = {n: cuda_ms(lambda ses=ses: ses.sample(chip, st.m,
                                                    st.noise_state),
                         RANKS_TIMED) for n, ses in logical.items()}
    torch.cuda.synchronize()
    code = _RANK_RUN.format(src=str(ROOT / "src"), root=str(ROOT))
    worlds, failed = {}, []
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        nccl_shared = _nccl_shared_card(tmp)
        for backend, world in RANKS_WORLDS:
            tag = f"{backend}{world}"
            store = str(tmp / f"{tag}_store")
            t = time.perf_counter()
            done = _finish_ranks(_start_ranks(
                code, world, lambda r: [backend, str(r), str(world), store,
                                        str(tmp / f"{tag}_{r}"),
                                        str(seed)]), RANKS_TIMEOUT_S)
            recs = []
            for r, (rc, out, err) in enumerate(done):
                if rc != 0:
                    raise AssertionError(f"rank {r} of {tag} exited {rc}: "
                                         f"{err[-3000:]}")
                rec = json.loads(out.strip().splitlines()[-1])
                with np.load(tmp / f"{tag}_{r}.npz") as got:
                    rec["equal_one_process"] = {
                        n: bool(np.array_equal(
                            got[f"{n}/m"],
                            w[0].to(torch.int8).cpu().numpy())
                            and np.array_equal(got[f"{n}/ns"],
                                               w[1].cpu().numpy()))
                        for n, w in want.items()}
                recs.append(rec)
            worlds[tag] = {"seconds": time.perf_counter() - t,
                           "ranks": recs}
    same = lambda a, b: bool(torch.equal(a[0], b[0])  # noqa: E731
                             and torch.equal(a[1], b[1]))
    checks = {
        "barrier_equals_unsharded": same(want["barrier"], unsharded),
        "halo1_equals_unsharded": same(want["halo1"], unsharded),
        "relaxed_differ_from_barrier": {
            n: not same(want[n], want["barrier"]) for n in ("halo4",
                                                           "async")},
        "ranks_equal_one_process": {
            tag: all(all(r["equal_one_process"].values())
                     for r in w["ranks"]) for tag, w in worlds.items()}}
    launches = {k: 0 for k in KERNELS}
    worst = 0.0
    summary = {}
    for tag, w in worlds.items():
        routes = w["ranks"][0]["route"]
        cross = int(tag[-1]) > 1
        want_route = {"barrier": "scan",
                      "halo4": "k5 per card" if cross else "k5",
                      "async": "k5 per card" if cross else "k5",
                      "halo1": "k1 windows" if cross else "k5"}
        # launches of 4 sweeps: halo4 and async two K5 windows each across
        # ranks (with edge_halos="block"), one K5 launch each on one rank;
        # halo1 one K5 launch on one rank, across ranks a K1 launch a band
        # each half-sweep
        k5_block = 2 * 2 * RANKS_SWEEPS // 4 if cross else 0
        want_counts = {
            "sweep_sparse_exchange": k5_block if cross
            else 3 * RANKS_SWEEPS // 4,
            "sweep_sparse": 2 * RANKS_SWEEPS * w["ranks"][0]["bands"]
            if cross else 0}
        for r in w["ranks"]:
            for k, c in r["launches"].items():
                launches[k] += c
            worst = max(worst, r["worst"])
            if r["route"] != want_route:
                failed.append(f"{tag} rank {r['rank']} took {r['route']}")
            for k, n in want_counts.items():
                if r["launches"][k] != n:
                    failed.append(f"{tag} rank {r['rank']} launched {k} "
                                  f"{r['launches'][k]} times, {n} expected")
            if r["edge_block_launches"] != k5_block:
                failed.append(f"{tag} rank {r['rank']}: "
                              f"{r['edge_block_launches']} K5 launches with "
                              f"edge_halos='block'")
        summary[tag] = {
            "bands_a_rank": w["ranks"][0]["bands"],
            "transport": w["ranks"][0]["transport"]["barrier"],
            "routes": routes, "seconds": w["seconds"],
            "ms_per_call": {n: [r["ms_per_call"][n] for r in w["ranks"]]
                            for n in want},
            "transport_host_ms_per_call": {
                n: [r["transport_host_ms_per_call"][n] for r in w["ranks"]]
                for n in want},
            # boundary bytes that crossed ranks in the driven call, all
            # ranks, a sweep
            "halo_bytes_per_sweep": {
                n: sum(r["bytes_sent_driven"][n] for r in w["ranks"])
                / RANKS_SWEEPS for n in want},
            "launches": [r["launches"] for r in w["ranks"]],
            "edge_block_launches": sum(r["edge_block_launches"]
                                       for r in w["ranks"]),
            "replayed": sum(sum(s["launches"] for s in r["replay"].values())
                            for r in w["ranks"])}
    res = {"phase": "ranks", "card": nvidia_smi_line(),
           "graph": f"make_chimera({RANKS_CELLS}, {RANKS_CELLS})", "B": B,
           "bands": SHARD_BANDS, "S": RANKS_SWEEPS,
           "policies": {n: str(p[0]) for n, p in _ranks_policies().items()},
           "one_process_ms_per_call": one_ms, "worlds": summary,
           "nccl_two_ranks_one_card": nccl_shared, "checks": checks,
           "launches": launches, "max_abs_diff": worst,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    flat = [checks["barrier_equals_unsharded"],
            checks["halo1_equals_unsharded"],
            *checks["relaxed_differ_from_barrier"].values(),
            *checks["ranks_equal_one_process"].values()]
    if not all(flat) or failed or worst != 0.0:
        raise AssertionError(f"a ranks check failed: {checks} {failed} "
                             f"(worst replay difference {worst})")
    res["_worst"] = worst
    return res


# ---------------------------------------------------------------------------
# phase: the language models' steps across processes
# ---------------------------------------------------------------------------
LMR_STEPS = 3                     # train steps, B = 8, S = 256
LMR_B, LMR_PROMPT, LMR_GEN, LMR_MAX_SEQ = 4, 32, 5, 64   # 4 decode tokens
LMR_DEPTH = 2                     # the FSDP meshes' layers, rwkv6-3b's
# jamba's gradient check: loss and gradients without the optimizer (its
# float32 moments alone would be ~106 GB), at B = 2 so that one process's
# parameters, gradients and activations fit the card (~60 GB)
LMR_GRADS_B = 2
# the ranks add partial sums in another order than one process (the
# row-parallel products' bf16 partials, the batch mean, the gradient
# norm): a step's loss is held to one process's within 1e-3, its gradient
# norm within 1e-2 relative, the logits of every decode step whose inputs
# are one process's within 0.05, and a greedy token must equal one
# process's where its top-2 logit margin exceeds 0.05.  Loss and logits
# stated first as 0.05 and 0.5 (one bf16 ulp of the loss's magnitude,
# four of the logits'); tightened to 16x and 5x the largest differences
# an H100 showed (6.3e-5 and 0.0098, the same in four runs; PERF.md).  The
# gradient norm's is 4.5x the largest relative difference those runs
# showed (2.2e-3, 1 x 2's third step): the loss alone cannot see a
# gradient scaled wrongly, as AdamW divides it by its RMS
# The logit gate is gemma2-2b's 0.05 at its logits' scale: a model whose
# one-process logits have a larger RMS than gemma2-2b's (no final softcap:
# jamba's and kimi-k2's) is held to 0.05 times the ratio.  bf16 rounding
# moves logits in proportion to their size: on 1 x 2 they sit as far from
# one process's as one process's bf16 logits from its float32 ones
# (`benchmarks_torch/lm_ranks_logits.py`; PERF.md)
LMR_LOSS_TOL = 1e-3
LMR_GRAD_RTOL = 1e-2
LMR_LOGIT_TOL = 0.05
# 8-bit moments across ranks, after one step against one process's first
# step, gathered whole: the largest code difference of any ``q`` and the
# largest relative difference of any ``scale``.  The moments quantize the
# bf16 gradients, which the ranks sum in another order: a block whose
# largest gradient is a sum that nearly cancels moves its scale by some
# percent, and every code of the block with it (127 codes a full scale).
# Stated loose first at 8 codes and 0.1 relative; an H100 showed 9 and
# 7 codes, 0.057 and 0.059 (1 x 2, 2 x 1 at 2 layers; PERF.md), so the
# gates are twice the largest
LMR_Q8_CODE_TOL = 18
LMR_Q8_SCALE_RTOL = 0.12
LMR_TIMEOUT_S = 600
GRANITE, JAMBA, KIMI = ("granite-moe-1b-a400m", "jamba-v0.1-52b",
                        "kimi-k2-1t-a32b")
RWKV, WHISPER, VLM = "rwkv6-3b", "whisper-tiny", "qwen2-vl-72b"
# (backend, world, parallelism preset, runs); a run is (arch, depth: None
# for the config's, rank mesh, train: "steps" (`LMR_STEPS`), "step" (the
# first of them), "steps8" / "step8" (the same with 8-bit moments),
# "grads" (loss and gradients, no optimizer) or None, decode tokens + 1,
# or None: no serving).  World 1 also runs every model's one-process
# reference.  The preset is `REPRO_PARALLELISM`, set in the ranks'
# environment before they import the port ("fsdp": the batch over both
# axes, every weight gathered over both, no tensor parallelism).  FSDP
# gathers every weight for every decode token, which gloo carries
# through the host at ~1 GB/s: FSDP meshes decode 2 tokens, run at
# `LMR_DEPTH` layers and take one train step (at full depth gemma2-2b's
# 2 x 1 took 100-125 s, granite-moe's 9.3-10.5 s a step; at 2 layers
# gemma2-2b's 2 x 1 and 2 x 2 took 56 and 50 s with three steps and 4
# tokens, of a script that took 1,115-1,140 of its 1,200 s).  The
# 8-bit and fsdp runs are paid by the earlier paths: every one-process
# reference, NCCL and tensor-parallel run serves 4 decode tokens (16
# before), gemma2-2b's and granite-moe's 1 x 2 and granite-moe's 2 x 1
# and whisper-tiny's 2 x 2 take one train step (three before; NCCL 1 x 1
# keeps three, the bit-equal state after them).  jamba is cut to one
# period (7 Mamba, 1 attention, 4 MoE layers) and kimi-k2 to its dense
# prefix and one MoE layer: the card holds neither whole.
# rwkv6-3b runs all 32 layers on 1 x 1, and one step at `LMR_DEPTH`
# layers on 1 x 2 and 2 x 1: at random weights it amplifies rounding
# with depth — one process's bf16 gradient norm sits 3.6 % from its
# float32 one at 2 layers, 37 % at 4, its logits 2.77 apart at 32, and in
# float32 the ranks' gradient norm sits 1.3e-5 from one process's at 2
# layers and 25 % at 32 (`benchmarks_torch/lm_ranks_depth.py`, PERF.md)
# — so today's gates hold bf16 at 2 layers, and at the first step (at
# the second its 1 x 2 gradient norm sat 0.99e-2 from one process's,
# bf16's noise carried through AdamW).  qwen2-vl-72b is cut to 2 layers
# (8.49 GB) and checked by its loss and gradients at `LMR_GRADS_SHAPE`,
# its 1024 patch rows in front of the text; whisper-tiny runs whole, its
# 6 heads split 2 ways on 2 x 2 and whole on 1 x 4
# gemma2-2b with 8-bit moments (blockwise int8, their blocks split over
# data x model): three steps at full depth on NCCL 1 x 1, bit-equal to
# one process's; one step at `LMR_DEPTH` layers on 1 x 2 and 2 x 1
# (there the norms' 117 and 9 blocks stay whole), its moments gathered
# and held to one process's first step by `LMR_Q8_CODE_TOL` and
# `LMR_Q8_SCALE_RTOL`
LMR_WORLDS = (
    ("nccl", 1, "2d", ((LM_ARCH, None, (1, 1), "steps", LMR_GEN),
                       (LM_ARCH, None, (1, 1), "steps8", None),
                       (GRANITE, None, (1, 1), "steps", LMR_GEN),
                       (RWKV, None, (1, 1), "steps", LMR_GEN),
                       (WHISPER, None, (1, 1), "steps", LMR_GEN))),
    ("gloo", 2, "2d", ((LM_ARCH, None, (1, 2), "step", LMR_GEN),
                       (LM_ARCH, LMR_DEPTH, (2, 1), "step", 3),
                       (LM_ARCH, LMR_DEPTH, (1, 2), "step8", None),
                       (LM_ARCH, LMR_DEPTH, (2, 1), "step8", None),
                       (GRANITE, None, (1, 2), "step", LMR_GEN),
                       (GRANITE, LMR_DEPTH, (2, 1), "step", 3),
                       (JAMBA, 8, (1, 2), "grads", LMR_GEN),
                       (KIMI, 2, (1, 2), None, LMR_GEN),
                       (RWKV, LMR_DEPTH, (1, 2), "step", LMR_GEN),
                       (RWKV, LMR_DEPTH, (2, 1), "step", 3),
                       (VLM, 2, (1, 2), "grads", LMR_GEN))),
    ("gloo", 2, "fsdp", ((LM_ARCH, LMR_DEPTH, (1, 2), "step", 3),
                         (GRANITE, LMR_DEPTH, (1, 2), "step", 2))),
    ("gloo", 4, "2d", ((LM_ARCH, LMR_DEPTH, (2, 2), "step", 3),
                       (GRANITE, LMR_DEPTH, (2, 2), "step", 3),
                       (WHISPER, None, (2, 2), "step", 5),
                       (WHISPER, None, (1, 4), "steps", 5))),
)
# drawn a piece at a time (`_lmr_pieces`): too large for every rank
# sharing the card to draw the whole tree
LMR_PIECEWISE = (JAMBA, KIMI, VLM)
# (B, S) of a "grads" run (default (`LMR_GRADS_B`, 256)): qwen2-vl's
# sequence holds the vision stub's 1024 patch rows and 256 text tokens
LMR_GRADS_SHAPE = {VLM: (2, 1280)}
# (B, prompt, max_seq) of a model's serving (default (`LMR_B`,
# `LMR_PROMPT`, `LMR_MAX_SEQ`)): qwen2-vl's prompt is its 1024 patch rows
# and 32 text tokens; whisper-tiny's is its decoder's 4 task tokens (start
# of transcript, language, task, no timestamps), teacher-forced into the
# self cache after the cross cache is filled from 1500 frames (on 2 x 2
# a decode step gathers the cross cache's positions: 1.9 s a step)
LMR_SERVE_SHAPE = {VLM: (2, 1056, 1088), WHISPER: (LMR_B, 4, LMR_MAX_SEQ)}
LMR_PIECES = 2                    # pieces a leaf, along its model-split dim

_LM_RANK_RUN = """
import sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.lm_ranks_child(*sys.argv[1:])
"""
# the dry run of runs of `LMR_WORLDS` (`launch.dryrun.rank_trace`: each
# rank's step on meta tensors under a process group that moves nothing,
# on the host with the card hidden): (preset, arch, depth, rank mesh,
# moment bits).  Each rank's traced collectives must equal, call for call
# and byte for byte by kind, those its real gloo rank recorded in the
# run's train step; the 1 x 1 one's argument and temporary bytes are
# printed beside the NCCL run's peak on the card
LMR_DRY_RUNS = (("2d", LM_ARCH, None, (1, 2), 32),
                ("2d", LM_ARCH, LMR_DEPTH, (1, 2), 8),
                ("fsdp", LM_ARCH, LMR_DEPTH, (1, 2), 32),
                ("2d", LM_ARCH, None, (1, 1), 32))
LMR_DRY_TIMEOUT_S = 300

# the dry run's traces of `LMR_DRY_RUNS` of one preset: python -c <this>
# out runs
_LM_RANK_DRY = """
import sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.lm_ranks_dry_child(*sys.argv[1:])
"""


def _lmr_cfg(arch: str, depth):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         num_layers=depth)


def _lmr_tag(arch: str, depth) -> str:
    return f"{arch}@{'full' if depth is None else depth}"


def _lmr_bits(train) -> int:
    """The moments' bits of a run's train kind: 8 for "steps8" / "step8"."""
    return 8 if train in ("steps8", "step8") else 32


def _lmr_references() -> dict:
    """(arch, depth, bits) -> the train kind its one-process reference
    runs ("steps" covers "step", "steps8" "step8"; a float32 reference
    also serves), from every run of `LMR_WORLDS`."""
    refs: dict = {}
    for _, _, _, runs in LMR_WORLDS:
        for arch, depth, _, train, _ in runs:
            bits = _lmr_bits(train)
            kind = {"step": "steps", "step8": "steps8"}.get(train, train)
            if refs.setdefault((arch, depth, bits), kind) != kind:
                raise ValueError(f"{arch} at depth {depth} trains two ways")
    return refs


def _lmr_ref_path(tmp: Path, arch: str, depth, bits: int) -> Path:
    q8 = "_q8" if bits == 8 else ""
    return tmp / f"one_{_lmr_tag(arch, depth)}{q8}.pt"


def _lmr_digest(tree) -> dict:
    """Two int64 checksums of every leaf's bits (their sum, and their sum
    weighted by position mod 1021): equal trees give equal digests, and
    any difference of bits changes them but by a chance not worth
    counting."""
    out = {}
    from repro_torch.models.sharding import leaves_with_path, local_block

    for key, t in leaves_with_path(tree):
        flat = local_block(t).detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32)
        plain = weighted = 0
        for i in range(0, bits.numel(), 1 << 24):
            c = bits[i:i + (1 << 24)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 1021 + 1
            plain += int(c.sum())
            weighted += int((c * w).sum())
        out[key] = [plain, weighted]
    return out


def _lmr_piece_dim(key: str, ndim: int):
    """The dim of a leaf the model axis splits (its "heads", "kv_heads",
    "mlp", "experts" or "vocab" name), or None."""
    from repro_torch.models import sharding as shd

    names = shd._leaf_axes(key, ndim)
    dims = [d for d, n in enumerate(names)
            if n is not None and "model" in shd.LOGICAL_RULES[n]]
    return dims[0] if dims else None


def _lmr_piece(key: str, like, shape, piece: int, seed: int):
    """Piece ``piece`` (of shape ``shape``) of the leaf ``like`` (a fake
    tensor of the whole), drawn on the card from its own generator: the
    model's constants where its init has them (norms and biases 0,
    ``D_skip`` 1, ``A_log`` log 1..N, ``dt_b`` the inverse softplus of a
    log-uniform step), else a normal clipped to [-2, 2] over sqrt(fan in)
    of the whole leaf (the model's fan in: the dims up to the input axis,
    1 for ``wo``, the experts' and the convolution's, else 0)."""
    import zlib

    name = key.rsplit("['", 1)[1].rstrip("']")
    gen = torch.Generator(device=DEVICE).manual_seed(
        seed * 1_000_003 + zlib.crc32(key.encode()) * 16 + piece)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    if "norm" in name or name in ("conv_b", "bq", "bk", "bv"):
        z = torch.zeros(shape, **f32)
    elif name == "D_skip":
        z = torch.ones(shape, **f32)
    elif name == "A_log":
        z = torch.log(torch.arange(1, shape[-1] + 1, **f32)).expand(
            shape).contiguous()
    elif name == "dt_b":
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(shape, generator=gen, **f32) * (hi - lo) + lo
        z = torch.log(torch.expm1(torch.clamp(torch.exp(u), min=1e-4)))
    else:
        from repro_torch.models import sharding as shd
        base = next(len(n) for k, n in shd._PARAM_RULES
                    if key.endswith(f"['{k}']"))
        whole = tuple(like.shape)[like.ndim - base:]
        in_axis = 1 if name in ("wo", "we_gate", "we_up", "we_down",
                                "conv_w") else 0
        z = torch.randn(shape, generator=gen, **f32).clamp_(-2.0, 2.0)
        z.mul_(1.0 / math.sqrt(math.prod(whole[:in_axis + 1])))
    return z.to(like.dtype)


def _lmr_pieces(cfg, seed: int, mesh=None, pspec=None):
    """Seed's parameters of a model too large for every rank sharing the
    card to draw whole (`LMR_PIECEWISE`): each leaf in `LMR_PIECES` pieces
    along its model-split dim (`_lmr_piece`), so a rank of a 1 x M mesh
    draws only its own.  Whole tensors off a rank mesh, else the rank's
    DTensors by ``pspec``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import steps
    from repro_torch.models import sharding as shd

    like_tree = steps._abstract_params(cfg)
    ranked = shd.is_rank_mesh(mesh)
    if ranked:
        comm = shd.rank_comm(mesh, DEVICE)
        if comm.sizes["data"] != 1 or LMR_PIECES % comm.sizes["model"]:
            raise ValueError(f"pieces of {LMR_PIECES} on mesh {comm.sizes}")
        specs = dict(shd.leaves_with_path(pspec))

    def one(key, like):
        dim = _lmr_piece_dim(key, like.ndim)
        n = LMR_PIECES if dim is not None and \
            like.shape[dim] % LMR_PIECES == 0 else 1
        rows = like.shape[dim] // n if n > 1 else None
        if not ranked:
            whole = torch.empty(tuple(like.shape), dtype=like.dtype,
                                device=DEVICE)
            for p in range(n):
                dst = whole.narrow(dim, p * rows, rows) if n > 1 else whole
                dst.copy_(_lmr_piece(key, like, tuple(dst.shape), p, seed))
            return whole
        sp = specs[key]
        axes = shd._spec_axes(sp[dim]) if dim is not None and \
            dim < len(sp) else ()
        if not axes:           # whole on every rank: every piece
            blk_dims, mine = tuple(like.shape), range(n)
        else:
            per = n // comm.sizes["model"]
            mine = range(comm.coord["model"] * per,
                         (comm.coord["model"] + 1) * per)
            blk_dims = list(like.shape)
            blk_dims[dim] //= comm.sizes["model"]
        blk = torch.empty(tuple(blk_dims), dtype=like.dtype, device=DEVICE)
        for i, p in enumerate(mine):
            dst = blk.narrow(dim, i * rows, rows) if n > 1 else blk
            dst.copy_(_lmr_piece(key, like, tuple(dst.shape), p, seed))
        return DTensor.from_local(blk, comm.dm, shd.placements(sp, mesh),
                                  run_check=False,
                                  shape=torch.Size(like.shape),
                                  stride=torch.empty(
                                      tuple(like.shape),
                                      device="meta").stride())

    return shd.map_with_path(one, like_tree)


def _lmr_params(cfg, arch: str, seed: int, mesh, pspec):
    """Seed's parameters: the model's own init (on a rank mesh each rank
    draws the whole tree and keeps its blocks), or `_lmr_pieces` for the
    models in `LMR_PIECEWISE`."""
    from repro_torch.models import sharding as shd
    from repro_torch.models.model import build_model

    if arch in LMR_PIECEWISE:
        return _lmr_pieces(cfg, seed, mesh, pspec)
    params = build_model(cfg, device=DEVICE).init(seed)
    if shd.is_rank_mesh(mesh):
        params = shd.shard_tree(params, pspec, mesh, DEVICE)
        torch.cuda.empty_cache()
    return params


def _lmr_resident(mesh, trees) -> dict:
    """A rank's bytes of each tree against the specs' shard shapes, and
    whether every leaf's block has the spec's shape: {tag: {"held",
    "specs", "whole", "shapes_equal_specs"}}; ``trees`` {tag: (tree,
    specs)}."""
    from repro_torch.models import sharding as shd

    logical = dataclasses.replace(mesh, ranks=None, group=None)
    out = {}
    for tag, (tree, specs) in trees.items():
        by_key = dict(shd.leaves_with_path(specs))
        held = spec_bytes = whole = 0
        shapes_ok = True
        for key, leaf in shd.leaves_with_path(tree):
            blk = shd.local_block(leaf)
            want = shd.NamedSharding(logical, by_key[key]).shard_shape(
                leaf.shape)
            shapes_ok &= tuple(blk.shape) == tuple(want)
            held += blk.numel() * blk.element_size()
            spec_bytes += math.prod(want) * blk.element_size()
            whole += leaf.numel() * blk.element_size()
        out[tag] = {"held": held, "specs": spec_bytes, "whole": whole,
                    "shapes_equal_specs": bool(shapes_ok)}
    return out


class _LayerCollectives:
    """The collectives each layer call makes in its forward, counted by
    wrapping `models.moe.moe_layer`, `models.mamba.mamba_forward`,
    `models.rwkv.rwkv_time_mix` / `rwkv_channel_mix`,
    `models.attention.attention` / `decode_attention` and
    `models.whisper.encode` (whose count holds its layers'; the
    backward's are the step's): calls, and the collectives' counts and
    bytes by kind summed over them."""

    def __init__(self, comm):
        self.comm = comm
        self.tally = {}

    def __enter__(self):
        from repro_torch.models import attention, mamba, moe, rwkv, whisper

        self.saved = [(moe, "moe_layer", moe.moe_layer),
                      (mamba, "mamba_forward", mamba.mamba_forward),
                      (rwkv, "rwkv_time_mix", rwkv.rwkv_time_mix),
                      (rwkv, "rwkv_channel_mix", rwkv.rwkv_channel_mix),
                      (attention, "attention", attention.attention),
                      (attention, "decode_attention",
                       attention.decode_attention),
                      (whisper, "encode", whisper.encode)]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def counted(*a, **k):
            before = (dict(self.comm.counts), dict(self.comm.nbytes))
            out = fn(*a, **k)
            t = self.tally.setdefault(name, {"calls": 0, "counts": {},
                                             "bytes": {}})
            t["calls"] += 1
            for kind in self.comm.KINDS:
                for field, now, was in (("counts", self.comm.counts,
                                         before[0]),
                                        ("bytes", self.comm.nbytes,
                                         before[1])):
                    t[field][kind] = (t[field].get(kind, 0)
                                      + now[kind] - was[kind])
            return out
        return counted

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _lmr_train(cfg, arch: str, mesh, seed: int, n_steps: int,
               bits: int = 32, first_moments: bool = False) -> dict:
    """``n_steps`` train steps (B = 8, S = 256; float32 moments, or 8-bit
    with ``bits``) on the pipeline's batches from seed's parameters: each
    step's loss, gradient norm and ms (CUDA events), the peak memory, the
    final state's digest, with ``first_moments`` the moments after the
    first step gathered whole on the host ({key: tensor}); on a rank mesh
    also the rank's resident bytes against the specs' (and the bytes its
    float32 moments would hold), the last step's collectives and its MoE
    layers' and Mamba blocks'."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _stub_inputs
    from repro_torch.models import sharding as shd
    from repro_torch.optim import adamw

    ranked = shd.is_rank_mesh(mesh)
    shape = ShapeCfg("train_cli", LM_TRAIN_S, LM_TRAIN_B, "train")
    step = make_train_step(cfg, shape, mesh,
                           adamw.AdamWConfig(total_steps=100,
                                             warmup_steps=10,
                                             state_bits=bits),
                           device=DEVICE)
    pspec, ospec, bspec = step.in_specs
    src = make_source(DataConfig(seed=seed, vocab_size=cfg.vocab_size))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = _lmr_params(cfg, arch, seed, mesh, pspec)
    opt = adamw.init(params, bits)
    out = {"losses": [], "grad_norms": [], "ms": []}
    comm = shd.rank_comm(mesh, DEVICE) if ranked else None
    layers = None
    for i in range(n_steps):
        batch = src.batch(i, LM_TRAIN_B, LM_TRAIN_S, device=DEVICE)
        batch.update(_stub_inputs(cfg, shape, i, seed, DEVICE))
        if ranked:
            batch = shd.shard_tree(batch, bspec, mesh, DEVICE)
            comm.reset()
            layers = _LayerCollectives(comm)
        with layers or contextlib.nullcontext():
            (params, opt, m), ms = timed_once(lambda: step.fn(params, opt,
                                                              batch))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["ms"].append(ms)
        if ranked:      # the step's own, before any gather of the moments
            out["step_collectives"] = comm.record()
        if first_moments and i == 0:
            moments = (opt.mu, opt.nu)
            if ranked:
                with shd.use_mesh(mesh, DEVICE):
                    moments = shd.full_tree(moments)
            out["first_moments"] = {k: v.to("cpu", copy=True) for k, v in
                                    shd.leaves_with_path(moments)}
            del moments
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["digest"] = _lmr_digest((params, opt.mu, opt.nu))
    if ranked:
        out["layer_collectives"] = layers.tally
        out["resident_bytes"] = _lmr_resident(mesh, {
            "params": (params, pspec),
            "moments": ((opt.mu, opt.nu), (ospec.mu, ospec.nu))})
        out["resident_bytes"]["moments"]["float32_held"] = 8 * sum(
            shd.local_block(p).numel() for p in adamw.tree_leaves(params))
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lmr_grads(cfg, arch: str, mesh, seed: int) -> dict:
    """`Model.loss` and its gradients (no optimizer) on the pipeline's
    first batch at B x S = `LMR_GRADS_SHAPE` (default `LMR_GRADS_B` x
    256; the modality stub's inputs with it), as the train step takes
    them: the loss, the gradients' global norm, ms (CUDA events), the
    peak memory; on a rank mesh also the resident parameter and gradient
    bytes against the specs' and the collectives, the MoE layers', the
    Mamba blocks' and the attention's among them."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import steps
    from repro_torch.launch.train import _stub_inputs
    from repro_torch.models import sharding as shd
    from repro_torch.optim import adamw

    ranked = shd.is_rank_mesh(mesh)
    Bg, Sg = LMR_GRADS_SHAPE.get(arch, (LMR_GRADS_B, LM_TRAIN_S))
    shape = ShapeCfg("grads", Sg, Bg, "train")
    st = steps.make_train_step(cfg, shape, mesh, device=DEVICE)
    pspec, _, bspec = st.in_specs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = _lmr_params(cfg, arch, seed, mesh, pspec)
    batch = make_source(DataConfig(seed=seed, vocab_size=cfg.vocab_size)
                        ).batch(0, Bg, Sg, device=DEVICE)
    batch.update(_stub_inputs(cfg, shape, 0, seed, DEVICE))
    baxes = ()
    comm = layers = None
    if ranked:
        batch = shd.shard_tree(batch, bspec, mesh, DEVICE)
        baxes = steps._batch_axes(bspec)
        comm = shd.rank_comm(mesh, DEVICE)
        comm.reset()
        layers = _LayerCollectives(comm)

    def run():
        with shd.use_mesh(mesh, DEVICE, baxes), \
                (layers or contextlib.nullcontext()):
            live = [p.detach().requires_grad_()
                    for p in adamw.tree_leaves(params)]
            loss = st.model.loss(adamw.tree_unflatten(params, live),
                                 shd.local_tree(batch))
            grads = adamw.tree_unflatten(params, list(
                torch.autograd.grad(loss, live)))
            return loss.detach(), grads, adamw.global_norm(grads)

    (loss, grads, gnorm), ms = timed_once(run)
    out = {"losses": [float(loss)], "grad_norms": [float(gnorm)],
           "ms": [ms], "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "batch": [Bg, Sg]}
    if ranked:
        out["step_collectives"] = comm.record()
        out["layer_collectives"] = layers.tally
        out["resident_bytes"] = _lmr_resident(mesh, {
            "params": (params, pspec), "grads": (grads, pspec)})
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _lmr_serve(cfg, arch: str, mesh, seed: int, gen: int = LMR_GEN
               ) -> dict:
    """Prefill B x P prompts (`LMR_SERVE_SHAPE`, default `LMR_B` x
    `LMR_PROMPT`; qwen2-vl's led by its patch rows, whisper-tiny's frames
    encoded into the cross cache and the prompt teacher-forced into the
    self cache) and ``gen`` - 1 greedy decode tokens from seed's
    parameters: the tokens, each step's logits (B, V) on the host, ms a
    decode token (host clock, synchronised); on a rank mesh also the
    decode run's collectives, its layers' among them, and the
    parameters' and the decode cache's resident bytes against the
    specs'."""
    from repro_torch.launch import serve
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer, whisper
    from repro_torch.models.model import VLM_PATCHES, build_model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=DEVICE)
    Bs, P, max_seq = LMR_SERVE_SHAPE.get(arch, (LMR_B, LMR_PROMPT,
                                                LMR_MAX_SEQ))
    cpu = torch.Generator().manual_seed(seed + 5)
    prompts = torch.randint(0, cfg.vocab_size, (Bs, P), generator=cpu
                            ).to(DEVICE)
    frames = None
    if cfg.frontend != "none":
        rows = (cfg.enc_dec.enc_seq if cfg.enc_dec is not None
                else min(VLM_PATCHES, P))
        frames = (0.02 * torch.randn((Bs, rows, cfg.d_model),
                                     generator=cpu)).to(DEVICE)
    if shd.is_rank_mesh(mesh):
        from repro_torch.configs import ShapeCfg
        from repro_torch.launch import steps
        pspec = steps.make_prefill_step(
            cfg, ShapeCfg("prefill", P, Bs, "prefill"), mesh,
            device=DEVICE).in_specs[0]
        cspec = steps.make_serve_step(
            cfg, ShapeCfg("decode", max_seq, Bs, "decode"), mesh,
            device=DEVICE).in_specs[3]
        params = _lmr_params(cfg, arch, seed, mesh, pspec)
        with _LayerCollectives(shd.rank_comm(mesh, DEVICE)) as layers:
            got = serve.generate_ranked(cfg, mesh, params, prompts, gen,
                                        max_seq, DEVICE, temperature=0.0,
                                        frontend_embeds=frames)
        logits = [x.cpu() for x in got["logits"]]
        res = {"decode_collectives": got["decode_comm"],
               "layer_collectives": layers.tally,
               "serve_bytes": _lmr_resident(mesh, {
                   "params": (params, pspec),
                   "cache": (got["cache"], cspec)})}
        del got["cache"]
    else:
        params = _lmr_params(cfg, arch, seed, None, None)
        with torch.no_grad():
            t0 = time.perf_counter()
            if cfg.enc_dec is not None:
                lg, _ = whisper.forward(params, cfg, prompts, frames)
                cache = whisper.fill_cross(params, cfg, frames,
                                           model.init_cache(Bs, max_seq))
                for i in range(P):
                    model.decode_step(params, prompts[:, i:i + 1], i, cache)
            else:
                lg, pcache = transformer.prefill(params, cfg, prompts,
                                                 frontend_embeds=frames)
                cache = serve.graft(model.init_cache(Bs, max_seq), pcache)
                del pcache
            logits = [lg[:, -1].float().cpu()]
            tok = lg[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            step_s = []
            t_pre = time.perf_counter() - t0
            for i in range(gen - 1):
                ts = time.perf_counter()
                lg, cache = model.decode_step(params, tok, P + i, cache)
                tok = lg[:, -1].argmax(-1)[:, None]
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - ts)
                logits.append(lg[:, -1].float().cpu())
            got = {"prefill_s": t_pre, "decode_step_s": step_s}
            del cache
        res = {}
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res.update({"tokens": torch.stack([x.argmax(-1) for x in logits], 1),
                "logits": torch.stack(logits, 1),
                "prefill_ms": got["prefill_s"] * 1e3,
                "ms_per_token": float(np.median(got["decode_step_s"])) * 1e3})
    return res


def _lmr_tokens_agree(got, want, got_logits, logits,
                      tol: float = LMR_LOGIT_TOL) -> dict:
    """Greedy tokens against one process's, step by step per row, while
    the row's earlier tokens agree (after a parting the inputs differ):
    a token must be equal where one process's top-2 margin exceeds
    ``tol``, and may part where it does not.  Also the largest logit
    difference over the steps compared."""
    top2 = logits.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    agree, held, steps, worst = True, 0, 0, 0.0
    for b in range(got.shape[0]):
        for t in range(got.shape[1]):
            steps += 1
            worst = max(worst, float((got_logits[b, t]
                                      - logits[b, t]).abs().max()))
            if got[b, t] != want[b, t]:
                agree &= bool(margin[b, t] <= tol)
                break
            held += bool(margin[b, t] > tol)
    return {"agree": agree, "steps_compared": steps,
            "held_over_margin": held, "max_logit_diff": worst,
            "min_margin": float(margin.min())}


def _lmr_one_process(arch: str, depth, kind, seed: int, tmp: Path) -> dict:
    """One model's one-process reference: its training (``kind``), its
    serving, saved to ``tmp`` for the later worlds; returns the record.
    With 8-bit moments ("steps8") its training alone, and the moments
    after the first step where the config is cut (the gloo runs')."""
    cfg = _lmr_cfg(arch, depth)
    t0 = time.perf_counter()
    if kind == "steps8":
        train = _lmr_train(cfg, arch, None, seed, LMR_STEPS, bits=8,
                           first_moments=depth is not None)
        torch.save({k: train.get(k) for k in ("losses", "grad_norms",
                                              "digest", "first_moments")},
                   _lmr_ref_path(tmp, arch, depth, 8))
        rec = {k: v for k, v in train.items()
               if k not in ("digest", "first_moments")}
        rec["seconds"] = time.perf_counter() - t0
        return rec
    one = {"serve": _lmr_serve(cfg, arch, None, seed)}
    if kind == "steps":
        one["train"] = _lmr_train(cfg, arch, None, seed, LMR_STEPS)
    elif kind == "grads":
        one["train"] = _lmr_grads(cfg, arch, None, seed)
    saved = {"tokens": one["serve"]["tokens"],
             "logits": one["serve"]["logits"],
             "logit_rms": float(one["serve"]["logits"].pow(2).mean()
                                .sqrt())}
    rec = {k: one["serve"][k] for k in ("prefill_ms", "ms_per_token")}
    rec["logit_rms"] = saved["logit_rms"]
    rec["serve_peak_gb"] = one["serve"]["peak_gb"]
    if "train" in one:
        saved.update({k: one["train"].get(k) for k in ("losses",
                                                       "grad_norms",
                                                       "digest")})
        rec.update({k: v for k, v in one["train"].items() if k != "digest"})
    torch.save(saved, _lmr_ref_path(tmp, arch, depth, 32))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def _lmr_logit_tol(arch: str, rms: float, tmp: Path) -> float:
    """`LMR_LOGIT_TOL` at ``arch``'s logits' scale: times the ratio of
    their RMS to gemma2-2b's (full depth, one process) where it exceeds 1;
    gemma2-2b's own runs are held to it as it is."""
    if arch == LM_ARCH:
        return LMR_LOGIT_TOL
    ref = torch.load(_lmr_ref_path(tmp, LM_ARCH, None, 32))
    return LMR_LOGIT_TOL * max(1.0, rms / ref["logit_rms"])


def _lmr_moment_gaps(got: dict, want: dict, mesh) -> dict:
    """8-bit moments gathered whole against one process's: the largest
    code difference of any ``q``, the largest relative difference of any
    ``scale``, and how many ``q`` leaves each rank holds whole on
    ``mesh`` (their block count not split by the ``opt_blocks`` axes)."""
    from repro_torch.models import sharding as shd

    code = scale = 0.0
    q_leaves = whole = 0
    for key, w in want.items():
        g = got[key]
        if w.dtype == torch.int8:
            code = max(code, float((g.int() - w.int()).abs().max()))
            q_leaves += 1
            sp = shd.spec(tuple(w.shape), ("opt_blocks", None), mesh)
            whole += shd.NamedSharding(mesh, sp).shard_shape(
                w.shape)[0] == w.shape[0]
        else:
            scale = max(scale, float(((g - w).abs() / w.abs()).max()))
    return {"max_code_diff": code, "max_scale_rel_diff": scale,
            "q_leaves": q_leaves, "q_leaves_whole": whole}


def _lmr_run(run, seed: int, tmp: Path) -> tuple:
    """One run of `LMR_WORLDS` on its rank mesh, against its one-process
    reference: (name, record)."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.models import sharding as shd

    arch, depth, shape, train, gen = run
    t0 = time.perf_counter()
    bits = _lmr_bits(train)
    want = torch.load(_lmr_ref_path(tmp, arch, depth, bits))
    cfg = _lmr_cfg(arch, depth)
    mesh = dist_mod.make_rank_mesh(tuple(shape), ("data", "model"))
    rec = {"arch": arch, "layers": cfg.num_layers, "train": train,
           "parallelism": shd.PARALLELISM}
    if train in ("steps", "step", "steps8", "step8"):
        rec.update(_lmr_train(cfg, arch, mesh, seed,
                              LMR_STEPS if train.startswith("steps") else 1,
                              bits=bits, first_moments=train == "step8"))
    elif train == "grads":
        rec.update(_lmr_grads(cfg, arch, mesh, seed))
    if train is not None:
        n = len(rec["losses"])
        rec["loss_diffs"] = [abs(a - b) for a, b in zip(
            rec["losses"], want["losses"][:n])]
        rec["grad_norm_rel_diffs"] = [abs(a - b) / b for a, b in zip(
            rec["grad_norms"], want["grad_norms"][:n])]
        digest = rec.pop("digest", None)
        rec["state_bit_equal"] = (digest == want["digest"]
                                  if train.startswith("steps") else None)
    if train == "step8":
        rec["moments"] = _lmr_moment_gaps(rec.pop("first_moments"),
                                          want["first_moments"], mesh)
    rec["finite"] = bool(np.isfinite(rec.get("losses", [0.0])).all())
    name = _lmr_run_name(arch, depth, shape, bits)
    if gen is None:
        rec["seconds"] = time.perf_counter() - t0
        return name, rec
    want = torch.load(_lmr_ref_path(tmp, arch, depth, 32))
    sv = _lmr_serve(cfg, arch, mesh, seed, gen)
    w_tok, w_log = want["tokens"][:, :gen], want["logits"][:, :gen]
    tol = _lmr_logit_tol(arch, want["logit_rms"], tmp)
    tokens = _lmr_tokens_agree(sv["tokens"], w_tok, sv["logits"], w_log,
                               tol)
    rec.update({
        "decode_tokens": gen - 1, "tokens": tokens, "logit_tol": tol,
        "logit_rms": want["logit_rms"],
        "tokens_equal": bool(torch.equal(sv["tokens"], w_tok)),
        "logits_bit_equal": bool(torch.equal(sv["logits"], w_log)),
        "prefill_ms": sv["prefill_ms"], "ms_per_token": sv["ms_per_token"],
        "serve_peak_gb": sv["peak_gb"],
        "decode_collectives": sv["decode_collectives"],
        "decode_layer_collectives": sv["layer_collectives"],
        "serve_bytes": sv["serve_bytes"],
        "transport": shd.rank_comm(mesh, DEVICE).transport,
        "finite": bool(rec["finite"] and torch.isfinite(sv["logits"]).all()),
        "seconds": time.perf_counter() - t0})
    return name, rec


def lm_ranks_child(backend: str, rank: str, world: str, store: str,
                   tmp: str, seed: str, runs: str) -> None:
    """One rank of the lm_ranks phase (see `lm_ranks_phase`): world 1 also
    runs the one-process references of every model and writes them to
    ``tmp`` for the later worlds; every rank prints a JSON record.  The
    launch counts of K1-K6 are read around the whole run."""
    from repro_torch.core import ranks

    rank, world, seed = int(rank), int(world), int(seed)
    os.environ["RANK"] = str(rank)
    os.environ["LOCAL_RANK"] = "0" if backend == "nccl" else str(rank)
    ranks.init_rank(backend, rank, world, store_path=store,
                    timeout_s=LMR_TIMEOUT_S)
    torch.cuda.set_device(0)
    tmp = Path(tmp)

    def run():
        rec = {"rank": rank, "world": world, "backend": backend,
               "one_process": {}, "meshes": {}}
        if world == 1:
            for (arch, depth, bits), kind in _lmr_references().items():
                tag = _lmr_tag(arch, depth) + ("/q8" if bits == 8 else "")
                rec["one_process"][tag] = _lmr_one_process(
                    arch, depth, kind, seed, tmp)
        for r in json.loads(runs):
            name, m = _lmr_run(r, seed, tmp)
            rec["meshes"][name] = m
        return rec

    try:
        rec, counts, _ = drive(run)
        rec["launches"] = counts
        print(json.dumps(rec), flush=True)
    finally:
        import torch.distributed as tdist
        tdist.destroy_process_group()


def _lmr_run_name(arch: str, depth, shape, bits: int) -> str:
    """A run's name in a rank's record (`_lmr_run`)."""
    name = f"{_lmr_tag(arch, depth)}/{'x'.join(map(str, shape))}"
    return name + ("/q8" if bits == 8 else "")


def lm_ranks_dry_child(out: str, runs: str) -> None:
    """`launch.dryrun.rank_trace` of every rank of each run of ``runs``
    (`LMR_DRY_RUNS` entries of the preset this process imported the port
    under) at the train step's shape, B = 8, S = 256; writes {run name:
    [each rank's trace]} to ``out`` as JSON."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch import dryrun

    shape = ShapeCfg("train_cli", LM_TRAIN_S, LM_TRAIN_B, "train")
    recs = {}
    for _, arch, depth, dims, bits in json.loads(runs):
        cfg = _lmr_cfg(arch, depth)
        recs[_lmr_run_name(arch, depth, dims, bits)] = [
            dryrun.rank_trace(cfg, shape, dict(zip(("data", "model"), dims)),
                              r, opt_bits=bits)
            for r in range(math.prod(dims))]
    Path(out).write_text(json.dumps(recs))


def _start_lmr_dry(tmp: Path) -> dict:
    """One CPU-only process a preset of `LMR_DRY_RUNS` (the preset is read
    at import), on one thread, with every GPU hidden: {preset: (its JSON
    file, the process)}."""
    code = _LM_RANK_DRY.format(src=str(ROOT / "src"), root=str(ROOT))
    procs = {}
    for preset in sorted({r[0] for r in LMR_DRY_RUNS}):
        runs = [r for r in LMR_DRY_RUNS if r[0] == preset]
        out = tmp / f"dry_{preset}.json"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   REPRO_PARALLELISM=preset)
        procs[preset] = (out, subprocess.Popen(
            [sys.executable, "-c", code, str(out), json.dumps(runs)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _lmr_dry_gate(procs: dict, worlds: dict) -> tuple[dict, list]:
    """Each dry-run rank against the same rank of the real run: calls and
    contributed bytes by kind of its train step (the gate; a 1 x 1 mesh
    moves nothing), and the traced argument + temporary bytes beside the
    rank's peak on the card (printed, not gated).  Returns (the record,
    what failed)."""
    rec, failed = {}, []
    for preset, (out, proc) in procs.items():
        try:
            _, err = proc.communicate(timeout=LMR_DRY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failed.append(f"dry run {preset}: timed out")
            continue
        if proc.returncode != 0:
            failed.append(f"dry run {preset} exited {proc.returncode}: "
                          f"{err[-2000:]}")
            continue
        for name, traces in json.loads(out.read_text()).items():
            world = len(traces)
            tag = (("nccl" if world == 1 else "gloo") + str(world)
                   + ("" if preset == "2d" else f"_{preset}"))
            real = [r["meshes"][name] for r in worlds[tag]["ranks"]]
            one = {"preset": preset, "world": tag, "ranks": []}
            for r, (t, m) in enumerate(zip(traces, real)):
                got, want = t["collectives"], m["step_collectives"]
                equal = (got["calls"] == want["calls"]
                         and got["bytes"] == want["bytes"])
                one["ranks"].append({
                    "calls": got["calls"], "bytes": got["bytes"],
                    "equal_to_the_rank": equal,
                    "per_op_bytes": got["reference"]["per_op_bytes"],
                    "dot_flops": t["flops"], "trace_s": t["trace_s"],
                    "argument_bytes": t["argument_bytes"],
                    "temp_bytes": t["temp_bytes"],
                    # the card's peak spans the run's steps and drawing
                    # its parameters (a whole copy, then the block)
                    "dry_argument_plus_temp_bytes": t["peak_bytes"],
                    "card_max_memory_allocated_bytes":
                        m["peak_gb"] * 1e9})
                if world > 1 and not equal:
                    failed.append(f"dry run {name} rank {r} ({tag}): "
                                  f"{got['calls']} {got['bytes']} against "
                                  f"{want['calls']} {want['bytes']}")
            rec[name] = one
    return rec, failed


def _lmr_checks(tag: str, m: dict) -> dict:
    """A run's checks: NCCL world 1 bit-equal to one process, the gloo
    worlds within the tolerances (8-bit moments by `LMR_Q8_CODE_TOL` and
    `LMR_Q8_SCALE_RTOL`); every block as the specs say."""
    checks = {}
    if "moments" in m:
        checks["moment_codes_within_tol"] = (
            m["moments"]["max_code_diff"] <= LMR_Q8_CODE_TOL)
        checks["moment_scales_within_tol"] = (
            m["moments"]["max_scale_rel_diff"] <= LMR_Q8_SCALE_RTOL)
    if m["train"] is not None:
        if tag == "nccl1":
            checks["losses_bit_equal"] = m["loss_diffs"] == [0.0] * len(
                m["loss_diffs"])
            if m["state_bit_equal"] is not None:
                checks["state_bit_equal"] = m["state_bit_equal"]
        else:
            checks["losses_within_tol"] = max(m["loss_diffs"]) \
                <= LMR_LOSS_TOL
            checks["grad_norms_within_tol"] = max(
                m["grad_norm_rel_diffs"]) <= LMR_GRAD_RTOL
        for t, v in m["resident_bytes"].items():
            checks[f"{t}_bytes_equal_specs"] = v["held"] == v["specs"]
            checks[f"{t}_shapes_equal_specs"] = v["shapes_equal_specs"]
    checks["finite"] = m["finite"]
    if "tokens" not in m:       # not served
        return checks
    if tag == "nccl1":
        checks["tokens_equal"] = m["tokens_equal"]
        checks["logits_bit_equal"] = m["logits_bit_equal"]
    else:
        checks["logits_within_tol"] = (m["tokens"]["max_logit_diff"]
                                       <= m["logit_tol"])
        checks["tokens_agree"] = m["tokens"]["agree"]
    for t, v in m["serve_bytes"].items():
        checks[f"serve_{t}_bytes_equal_specs"] = v["held"] == v["specs"]
        checks[f"serve_{t}_shapes_equal_specs"] = v["shapes_equal_specs"]
    return checks


def lm_ranks_phase(seed: int) -> dict:
    """The language models' steps across processes on the card
    (`launch.steps` on a rank mesh: FSDP over data x tensor and expert
    parallel over model, or the ``fsdp`` preset), each world a group of
    child processes run in turn, never together (`LMR_WORLDS`): NCCL at
    world size 1 first — it also runs every model's one-process reference
    (3 train steps at B = 8, S = 256 in bf16 with float32 moments, and
    gemma2-2b's with 8-bit moments, or a loss and its gradients at
    `LMR_GRADS_SHAPE`; a B = 4 prefill of 32 tokens with 4 greedy decode
    tokens, qwen2-vl's at `LMR_SERVE_SHAPE`) — gemma2-2b (also with
    8-bit moments), granite-moe, rwkv6-3b and whisper-tiny on a 1 x 1
    rank mesh, bit-equal to them; then 2 gloo ranks sharing the card:
    gemma2-2b, granite-moe (all 24 layers, 16 experts a rank) and
    rwkv6-3b (`LMR_DEPTH` layers, 20 heads a rank) on 1 x 2 (one step,
    4 decode tokens) and 2 x 1 (FSDP at `LMR_DEPTH` layers, one step, 2
    decode tokens), gemma2-2b's 8-bit step at `LMR_DEPTH` layers on 1 x 2
    and 2 x 1 (its moments gathered against one process's first step),
    jamba's period (its loss and gradients, serving), kimi-k2's cut
    (serving, 192 experts a rank) and qwen2-vl-72b's 2 layers (its loss
    and gradients at B = 2 x S = 1280, serving) on 1 x 2; 2 gloo ranks
    under ``REPRO_PARALLELISM=fsdp`` on 1 x 2: gemma2-2b and granite-moe
    at `LMR_DEPTH` layers (one step; 2 and 1 decode tokens); then 4
    gloo ranks: gemma2-2b and granite-moe (one step and 2 tokens each)
    at `LMR_DEPTH` layers and whisper-tiny (one step, 4 tokens) on 2 x 2,
    whisper-tiny on 1 x 4 (its heads whole; three steps).
    Each step's loss within
    `LMR_LOSS_TOL` of one process's and its gradient norm within
    `LMR_GRAD_RTOL`, 8-bit moments' codes and scales within
    `LMR_Q8_CODE_TOL` and `LMR_Q8_SCALE_RTOL`, the logits within
    `LMR_LOGIT_TOL` (at the logits' scale, `_lmr_logit_tol`) while the
    tokens agree, the greedy tokens equal where the margin exceeds it.
    Each rank holds the specs' blocks of parameters, moments (or
    gradients) and the decode cache, and
    launches none of K1-K6."""
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    code = _LM_RANK_RUN.format(src=str(ROOT / "src"), root=str(ROOT))
    worlds, failed = {}, []
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        dry_procs = _start_lmr_dry(tmp)
        atexit.register(_stop, dry_procs)
        for backend, world, preset, runs in LMR_WORLDS:
            tag = f"{backend}{world}" + ("" if preset == "2d"
                                         else f"_{preset}")
            store = str(tmp / f"{tag}_store")
            argv = lambda r: [backend, str(r), str(world), store, str(tmp),  # noqa: E731
                              str(seed), json.dumps(runs)]
            t = time.perf_counter()
            done = _finish_ranks(_start_ranks(
                code, world, argv, {"REPRO_PARALLELISM": preset}),
                LMR_TIMEOUT_S)
            recs = []
            for r, (rc, out, err) in enumerate(done):
                if rc != 0:
                    raise AssertionError(f"lm_ranks: rank {r} of {tag} "
                                         f"exited {rc}: {err[-3000:]}")
                recs.append(json.loads(out.strip().splitlines()[-1]))
            worlds[tag] = {"seconds": time.perf_counter() - t, "ranks": recs}
        dry, dry_failed = _lmr_dry_gate(dry_procs, worlds)
    failed += dry_failed
    launches = {k: 0 for k in KERNELS}
    checks = {}
    for tag, w in worlds.items():
        for r in w["ranks"]:
            for k, c in r["launches"].items():
                launches[k] += c
            for name, m in r["meshes"].items():
                checks[f"{tag}/{name}/rank{r['rank']}"] = _lmr_checks(tag, m)
    if any(launches.values()):
        failed.append(f"the rank steps launched kernels: {launches}")
    failed += [f"{k}: {n}" for k, c in checks.items()
               for n, ok in c.items() if not ok]
    res = {"phase": "lm_ranks", "card": nvidia_smi_line(),
           "train": {"B": LM_TRAIN_B, "S": LM_TRAIN_S, "steps": LMR_STEPS,
                     "grads_B": LMR_GRADS_B},
           "serve": {"B": LMR_B, "prompt": LMR_PROMPT,
                     "max_seq": LMR_MAX_SEQ},
           "runs": [[b, w, p, *r] for b, w, p, runs in LMR_WORLDS
                    for r in runs],
           "tolerances": {"loss": LMR_LOSS_TOL, "grad_norm": LMR_GRAD_RTOL,
                          "logit": LMR_LOGIT_TOL,
                          "q8_code": LMR_Q8_CODE_TOL,
                          "q8_scale": LMR_Q8_SCALE_RTOL,
                          "logit_scaled_by_rms": "over gemma2-2b's"},
           "worlds": worlds, "checks": checks, "launches": launches,
           "dry_run": dry, "seconds": time.perf_counter() - t_phase}
    emit(res)
    if failed:
        raise AssertionError(f"an lm_ranks check failed: {failed}")
    return res


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
    # before the first cuBLAS call: the lm_train phase's bit-equal resume
    # runs under deterministic algorithms, which need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # the dry run's cells trace on the host's CPU beside the card's work
    # from here to the mesh phase, which reads them
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dry_procs = _start_dry_runs(dry_dir)
    atexit.register(shutil.rmtree, dry_dir, True)
    atexit.register(_stop, dry_procs)
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
    logic = psl_phase(args.seed)
    served = serve_phase(args.seed)
    by_path = {"sample": path["launches"], "training": train["launches"],
               "learning": learn["launches"], "workloads": work["launches"],
               "streaming": stream["launches"], "lattice_soa": soa["launches"],
               "sharded": shard["launches"], "faults": fault["launches"],
               "psl": logic["launches"], "serve": served["launches"]}
    worst = {"training": train.pop("_worst"), "learning": learn.pop("_worst"),
             "workloads": work.pop("_worst"),
             "streaming": stream.pop("_worst"),
             "lattice_soa": soa.pop("_worst"),
             "sharded": shard.pop("_worst"), "faults": fault.pop("_worst"),
             "psl": logic.pop("_worst"), "serve": served.pop("_worst")}
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
        max(worst["sharded"], worst["faults"], worst["serve"])))
    # the recorded launches hold their operands on the card: free them
    # before the language-model phases, whose full-width steps need it
    del calls, train_calls, work_calls, stream_calls, soa_calls, shard_calls
    torch.cuda.empty_cache()
    lm_serve_phase(args.seed)
    lm_train_phase(args.seed)
    lm_families_phase(args.seed)
    mesh, mesh_calls = mesh_phase(args.seed, (dry_procs, dry_dir))
    del mesh_calls
    # the mesh phase's lattice twin launches K1 and K5 (replayed there)
    lattice = mesh["lattice_pod"]
    for rec in records:
        rec["launches_by_path"]["mesh"] = lattice["launches"][rec["name"]]
        if lattice["launches"][rec["name"]]:
            rec["max_abs_err"] = max(rec["max_abs_err"], lattice["_worst"])
    # the ranks' launches, counted and replayed in each rank's process
    across = ranks_phase(args.seed)
    for rec in records:
        rec["launches_by_path"]["ranks"] = across["launches"][rec["name"]]
        if across["launches"][rec["name"]]:
            rec["max_abs_err"] = max(rec["max_abs_err"], across["_worst"])
    k5 = next(r for r in records if r["name"] == "sweep_sparse_exchange")
    k5["edge_block_launches"] = sum(
        w["edge_block_launches"] for w in across["worlds"].values())
    # the language model's steps across processes launch no kernel
    lm_across = lm_ranks_phase(args.seed)
    for rec in records:
        rec["launches_by_path"]["lm_ranks"] = lm_across["launches"][
            rec["name"]]
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
