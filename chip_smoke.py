#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA device, ``nvcc`` and the sources of this checkout; imports
nothing of JAX or of the JAX package.  It builds the CUDA kernel library
from ``src/repro_torch/kernels/csrc`` into ``build/``, holds every kernel
against its plain PyTorch version on the card, then programs a mismatched
440-spin Chimera chip and samples it through `PBitMachine` -> `Session`
-> the sweep-resident kernel, and times the kernel at 440, 8192 and 32768
spins.  Every launch the main path makes is recorded with its operands and
replayed through the plain version, so the kernel is also held to it at
the main path's own shapes.  Any failed phase raises and the exit code is
non-zero; without a GPU it exits 1 and prints no result.

Output: one JSON object per line —
  {"phase": "env", ...}            versions, card name and power limit
  {"phase": "build", ...}          seconds to build the library
  {"phase": "kernel_checks", ...}  kernel vs plain version, every mode
  {"phase": "main_path", ...}      backend, launches, each launch against
                                   the plain version, energies, times
  {"kernels": [...]}               one record per kernel (see PERF.md)
  <name, power limit>              as nvidia-smi prints them
  {"ok": true, "device": {...}}    last line
"""
from __future__ import annotations

import argparse
import json
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

DEVICE = "cuda"    # the script has no CPU mode: main() refuses without a GPU
B = 256            # chains everywhere on the main path
CHECK_SWEEPS = 8   # sweeps per mode in the kernel_checks phase


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


# ---------------------------------------------------------------------------
# phase: the main path
# ---------------------------------------------------------------------------
class LaunchRecorder:
    """Stands between `kernels.ops` and the `sweep_sparse` wrapper while
    the main path runs: passes every call through and keeps its operands
    and outputs, so each launch can be replayed through the plain version."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.calls = []

    def __call__(self, *args, **kwargs):
        out = self.wrapper(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


def replay_through_plain_version(calls) -> list[dict]:
    """Each recorded launch against `sweep_sparse_ref` on the same operands."""
    from repro_torch.kernels.sweep_fused import sweep_sparse_ref

    rows = []
    for args, kwargs, got in calls:
        want, plain_ms = timed_once(lambda: sweep_sparse_ref(*args, **kwargs))
        diff, spins = compare_outputs(got, want)
        outputs = ["m", "noise_state"]
        if kwargs.get("accumulate"):
            outputs += ["s_sum", "c_slots"]
        if kwargs.get("collect_hist"):
            outputs.append(f"hist_nv{kwargs['n_visible']}")
        rows.append({"N": args[0].shape[1], "B": args[0].shape[0],
                     "S": args[10].shape[0], "noise": kwargs["noise_mode"],
                     "outputs": outputs, "max_abs_diff": diff,
                     "spins_differing": spins, "plain_ms": plain_ms})
    return rows


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
    """Drive the main path once with the launch count at 0 before and read
    just after; then hold every launch it made against the plain version
    and time the `Session.sample` calls."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sweep_fused import sweep_sparse

    rng = np.random.default_rng(seed + 100)
    recorder = LaunchRecorder(sweep_sparse)
    ops.sweep_sparse = recorder
    sweep_sparse.launches = 0
    try:
        anneals = [anneal_chip(noise, seed, rng)
                   for noise in ("counter", "lfsr")]
        cells = [one_cell(noise, seed, rng) for noise in ("counter", "lfsr")]
        lattices = [lattice(32, 32, seed, rng), lattice(64, 64, seed, rng)]
        launches = sweep_sparse.launches
    finally:
        ops.sweep_sparse = sweep_sparse
    backends = {r["backend"] for r in anneals + cells + lattices}
    if backends != {"fused_sparse"}:
        raise AssertionError(f"main path resolved to {backends}, not the "
                             f"sweep-resident kernel")
    if launches <= 0 or launches != len(recorder.calls):
        raise AssertionError(
            f"the main path launched sweep_sparse {launches} times through "
            f"{len(recorder.calls)} calls of its wrapper")

    replays = replay_through_plain_version(recorder.calls)
    bad = [r for r in replays
           if r["max_abs_diff"] != 0.0 or r["spins_differing"] != 0]

    for r in anneals + lattices:
        ms = cuda_ms(r.pop("_again"))
        r["ms_per_launch"] = ms
        r["flips_per_ns"] = r["B"] * r["N"] * r["sweeps"] / (ms * 1e6)
    out = {"phase": "main_path", "backend": "fused_sparse",
           "launches": {"sweep_sparse": launches},
           "launches_vs_plain_version": replays,
           "anneal_440": anneals, "one_cell": cells, "lattices": lattices}
    emit(out)
    if bad:
        raise AssertionError(f"a main-path launch disagrees with the plain "
                             f"version: {bad}")
    return out, recorder.calls


# ---------------------------------------------------------------------------
# the kernel record
# ---------------------------------------------------------------------------
def kernel_record(checks: dict, path: dict, calls: list) -> dict:
    """K1's record at the main path's first launch: the counter-noise
    anneal, N=440, B=256, S=1000."""
    from repro_torch.kernels.sweep_fused import sweep_sparse

    args, kwargs, outs = calls[0]
    replay = path["launches_vs_plain_version"][0]
    Bc, n = args[0].shape
    S, D = args[10].shape[0], args[1].shape[0]
    ms = cuda_ms(lambda: sweep_sparse(*args, **kwargs))
    # bound: every input read once, every output written once ...
    moved = sum(t.numel() * t.element_size()
                for t in (*args, *kwargs.values(), *outs)
                if isinstance(t, torch.Tensor))
    # ... against the operations of one flip: D multiply-adds (2D), the
    # decision (bias add, offset add, two multiplies, tanhf counted as one,
    # noise multiply, two adds, compare: 9), byte -> uniform (2), and the
    # counter hash (row multiply, two xors, mix32's 8: 11); integer
    # operations are charged at the fp32 rate, which flatters the card
    ops = Bc * n * S * (2 * D + 9 + 2 + 11)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    worst = max([checks["max_abs_diff"]]
                + [r["max_abs_diff"]
                   for r in path["launches_vs_plain_version"]])
    return {"name": "sweep_sparse", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sweep_sparse.cu",
            "replaces": "src/repro/kernels/sweep_fused.py:599",
            "launches": path["launches"]["sweep_sparse"],
            "max_abs_err": worst,
            "ms": ms, "plain_ms": replay["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": None,
            "shape": {"N": n, "B": Bc, "S": S, "D": D,
                      "noise": kwargs["noise_mode"]},
            "bytes_moved": moved, "operations": ops}


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

    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-2].strip(),
          "card": torch.cuda.get_device_name(0), "nvidia_smi": smi})

    t0 = time.perf_counter()
    lib = build.build("sweep_sparse")
    emit({"phase": "build", "library": str(lib),
          "seconds": time.perf_counter() - t0})

    checks = check_kernels(args.seed)
    path, calls = main_path(args.seed)
    emit({"kernels": [kernel_record(checks, path, calls)]})

    print(smi, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
