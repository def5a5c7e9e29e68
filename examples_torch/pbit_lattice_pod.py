"""The paper's chip at lattice scale: anneal a large Chimera p-bit fabric
through a mesh-sharded `api.Session` — cell rows partition over a line
mesh of row bands and only the O(√N) chain-coupler boundary spins move
between bands, exactly the chip's inter-cell wires.

Nothing O(N²) is ever built: the machine is sparse-native
(`SparseMismatch`, O(D·N)) and the sharded engine keeps per-band slot
tables.  Under the default barrier policy a sharded run reproduces the
one-band spin trajectory bit for bit.  The bands are logical devices of
one card (`repro_torch.launch.mesh.make_line_mesh`): on the GPU the
launch-resident policies run the in-kernel halo exchange (K5) over all of
them in one launch.

``--sync`` demos the synchronization policies (`api.Sync`):

  * ``barrier`` — per-half-sweep halo exchange, the bit-exact default;
  * ``halo4``   — exchange every 4th half-sweep, 4-sweep launches;
  * ``async``   — PASS-style: launch-resident bands, double-buffered
                  exchanges at launch boundaries only.

With a relaxed policy the script runs the barrier baseline too and prints
the measured sweeps/sec for both plus the energy-trace gap — the
sampling-quality cost is measured, never assumed away.  Beside them it
prints the napkin figure of `halo_vs_hbm_seconds` under the H100's
constants.  Twin of ``examples/pbit_lattice_pod.py`` on the PyTorch/CUDA
port.

Run:  PYTHONPATH=src python examples_torch/pbit_lattice_pod.py --sync async [--device cpu]
(on the GPU unless ``--device cpu``; REPRO_EXAMPLE_QUICK=1 shrinks the
lattice for a smoke job.)
"""
import argparse
import math
import os
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.cd import PBitMachine
from repro_torch.core.chimera import make_chimera
from repro_torch.core.distributed import halo_bytes_per_sweep, sparse_energy
from repro_torch.core.hardware import HardwareConfig
from repro_torch.launch.mesh import halo_vs_hbm_seconds, make_line_mesh

SYNCS = {
    "barrier": api.Sync(),
    "halo4": api.Sync(halo_every=4, sweeps_per_launch=4),
    "async": api.Sync(halo_every=math.inf, mode="async",
                      sweeps_per_launch=4),
}


def sizes(quick: bool) -> dict:
    """The run's size: 32x32 cells (8192 p-bits), 400 sweeps, 16 chains;
    ``quick`` shrinks it."""
    return dict(side=8 if quick else 32,
                n_sweeps=60 if quick else 400,
                rec=12 if quick else 40,   # energy-trace segment (4 | rec)
                chains=4 if quick else 16)


def anneal(sync_name: str, bands: int, device, side: int, n_sweeps: int,
           rec: int, chains: int, repeats: int = 3) -> dict:
    """Anneal one SK instance on ``bands`` logical row bands (1: no mesh)
    under one Sync policy: the final spins, the energy trace (one Session
    call per ``rec``-sweep segment) and the median of ``repeats`` timed
    whole-schedule calls."""
    graph = make_chimera(side, side)
    mesh = make_line_mesh(bands) if bands > 1 else None
    # sparse-native chip instance: process variation sampled straight into
    # the O(D·N) slot layout; mesh+partition+sync ride the machine into
    # every Session
    machine = PBitMachine.create(
        graph, 0, HardwareConfig(), sparse=True, noise="counter",
        w_scale=0.05, mesh=mesh, device=device,
        partition=api.Partition(rows="data") if mesh is not None else None)
    sync = SYNCS[sync_name]
    session = api.Session(machine.sampler_spec(
        chains=chains, sync=sync if mesh is not None else None))

    # random SK instance on the physical couplers (one 8-bit code per edge)
    rng = np.random.default_rng(1)
    codes = torch.as_tensor(rng.integers(-100, 101, graph.n_edges),
                            dtype=torch.int32)
    chip = session.program_edges(codes, torch.zeros(graph.n_nodes,
                                                    dtype=torch.int32))
    betas = torch.as_tensor(api.Anneal(0.05, 2.5, n_sweeps=n_sweeps).betas(),
                            device=session.device)
    state = session.init_state(session.generator(2))

    m, ns = state.m, state.noise_state
    trace = []
    for seg in betas.reshape(n_sweeps // rec, rec):
        m, ns, _ = session.sample(chip, m, ns, seg)
        trace.append(float(sparse_energy(chip, m).mean()) / graph.n_nodes)
    e = sparse_energy(chip, m)

    def sync_dev():
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)

    # throughput: median of fresh whole-schedule calls
    session.sample(chip, state.m, state.noise_state, betas)
    sync_dev()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        session.sample(chip, state.m, state.noise_state, betas)
        sync_dev()
        ts.append(time.perf_counter() - t0)
    dt = sorted(ts)[len(ts) // 2]

    out = {"sync": sync_name, "bands": bands, "backend": session.backend,
           "n_nodes": graph.n_nodes, "chains": chains, "sweeps": n_sweeps,
           "m": m, "trace": np.asarray(trace), "energy": e.cpu().numpy(),
           "seconds": dt, "sweeps_per_s": n_sweeps / dt}
    plan = session.partition_plan
    if plan is not None:
        halo = halo_bytes_per_sweep(plan, chains, sync=sync)
        # local HBM traffic/sweep/band: slot weights + spins once per sweep
        hbm = (2 * 6 * graph.n_nodes * 4
               + 2 * chains * graph.n_nodes * 4) // bands
        out.update(halo_bytes_per_sweep=halo, n_boundary=plan.n_boundary,
                   exchanges_per_sweep=sync.exchanges_per_sweep(),
                   napkin=halo_vs_hbm_seconds(
                       halo // max(bands - 1, 1), hbm,
                       exchanges=sync.exchanges_per_sweep()))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sync", choices=sorted(SYNCS), default="barrier",
                    help="shard synchronization policy (api.Sync)")
    ap.add_argument("--bands", type=int, default=4,
                    help="logical row bands of the line mesh")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    size = sizes(bool(os.environ.get("REPRO_EXAMPLE_QUICK")))

    res = anneal(args.sync, args.bands, args.device, **size)
    n = res["n_nodes"]
    print(f"lattice: {size['side']}x{size['side']} cells = {n} p-bits on "
          f"{args.bands} logical band(s) of {args.device}, sync={args.sync}, "
          f"backend={res['backend']}")
    e = res["energy"]
    print(f"energy/spin after anneal: best {e.min() / n:+.3f}, "
          f"mean {e.mean() / n:+.3f} over {res['chains']} chains")
    print(f"{size['n_sweeps'] * res['chains'] * n / res['seconds'] / 1e6:.1f}"
          f"M spin-updates/s ({res['sweeps_per_s']:.1f} sweeps/s, "
          f"{res['seconds']:.3f}s for {size['n_sweeps']} sweeps)")
    if args.sync != "barrier":
        base = anneal("barrier", args.bands, args.device, **size)
        gap = np.abs(res["trace"] - base["trace"])
        res["baseline"] = base
        res["trace_gap_mean"], res["trace_gap_max"] = gap.mean(), gap.max()
        print(f"vs barrier baseline: {base['sweeps_per_s']:.1f} sweeps/s "
              f"({res['sweeps_per_s'] / base['sweeps_per_s']:.2f}x), "
              f"energy-trace gap mean {gap.mean():.4f} / max {gap.max():.4f} "
              f"per spin (baseline best {base['energy'].min() / n:+.3f})")
    if "napkin" in res:
        nap = res["napkin"]
        print(f"halo traffic under sync={args.sync}: "
              f"{res['halo_bytes_per_sweep']:.0f} B/sweep total "
              f"({res['n_boundary']} boundary spins, "
              f"{res['exchanges_per_sweep']:.2f} exchanges/sweep); "
              f"H100 napkin: NVLink/HBM time ratio {nap['ici_over_hbm']:.3f} "
              f"per band, {nap['ici_latency_share']:.0%} of link time is "
              f"per-exchange latency (the cost the kernel-resident exchange "
              f"amortizes)")
    return res


if __name__ == "__main__":
    main()
