"""The sharded engine's cases that `test_torch_ranks.py` runs twice: in
gloo ranks, each on a rank mesh (`make_rank_mesh`), and in one process on
the logical mesh of the same shape (`make_mesh`).  Every case builds its
problem from seeds with the port alone, so both runs see the same inputs,
and hands its outputs to ``save(name, *tensors)``; ``info(name, text)``
records what may differ between the two (the route, the transport).

No jax here: the ranks import this module.
"""
import json
import math

import numpy as np
import torch

from repro_torch import api, convert
from repro_torch.core import tasks
from repro_torch.core.cd import CDConfig, PBitMachine, make_cd_step
from repro_torch.core.chimera import make_chimera
from repro_torch.core.distributed import (LatticeSpec, ShardedEngine,
                                          make_lattice_anneal,
                                          make_sk_lattice)
from repro_torch.core.energy import all_states
from repro_torch.core.hardware import HardwareConfig

B = 8
BETAS = torch.linspace(0.3, 1.5, 8)
ANNEAL = LatticeSpec(4, 2, chains=4)   # the two-rank lattice anneal,
ANNEAL_SWEEPS, ANNEAL_EVERY = 20, 10   # its sweeps and a record every 10
RELAXED = {   # name: Sync fields
    "k4": dict(halo_every=4, sweeps_per_launch=4),
    "inf_async": dict(halo_every=math.inf, mode="async", sweeps_per_launch=4),
    "k2_async": dict(halo_every=2, mode="async", sweeps_per_launch=2),
    "k1_L2": dict(halo_every=1, sweeps_per_launch=2),
}


def masked():
    """4 cell rows, cell (3, 1) masked: bands of unequal node counts."""
    return make_chimera(4, 2, masked_cells=((3, 1),))


def problem(ses, g, seed: int):
    """A programmed chip and a state drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    chip = ses.program_edges(
        torch.as_tensor(rng.integers(-60, 60, g.n_edges), dtype=torch.int32),
        torch.as_tensor(rng.integers(-15, 15, g.n_nodes), dtype=torch.int32))
    st = ses.init_state(ses.generator(seed + 1))
    return chip, st.m, st.noise_state


def clamps(g):
    cm = torch.zeros(g.n_nodes, dtype=torch.bool)
    cm[[0, 5, g.n_nodes - 1]] = True
    return cm, torch.ones((B, g.n_nodes))


def session(mach, mesh, sync=None, backend=None, **kw):
    sp = mach.sampler_spec(chains=B, mesh=mesh, sync=sync, **kw)
    return api.Session(sp if backend is None else sp.replace(backend=backend))


def barrier_suite(save, name, ses, chip, m, ns, *, hist=True):
    """sample (with the trajectory), clamped stats three ways, and
    visible_hist through one Session."""
    g = ses.graph
    save(f"{name}/sample", *ses.sample(chip, m, ns, BETAS, collect=True))
    cm, cv = clamps(g)
    for tag, kw in (("cv", dict(clamp_mask=cm, clamp_values=cv)),
                    ("cm", dict(clamp_mask=cm)), ("free", {})):
        save(f"{name}/stats_{tag}", *ses.stats(chip, m, ns, 8, 2, **kw))
    if hist:
        save(f"{name}/hist", *ses.visible_hist(chip, m, ns,
                                               np.array([0, 3, 9, 11]), 2,
                                               BETAS))


def engine_runs(save, info, name, g, mesh, chip, m, ns, stats=()):
    """Each relaxed policy on ``mesh`` straight through the engine: the
    scan (``sparse``), K1 windows (``fused_sparse`` without K5) and K5's
    plain version (``resident_exchange=True``)."""
    for pol, fields in RELAXED.items():
        sync = api.Sync(**fields)
        for route, backend, resident in (("scan", "sparse", None),
                                         ("k1", "fused_sparse", False),
                                         ("k5", "fused_sparse", True)):
            eng = ShardedEngine(g, mesh, api.Partition(), "counter", 8, B,
                                sync=sync, backend=backend, device="cpu",
                                resident_exchange=resident)
            key = f"{name}/{pol}/{route}"
            info(key, f"{eng.route}|{eng.transport}")
            save(key, *eng.sample(chip, m, ns, BETAS)[:2])
            if (pol, route) in stats:
                save(key + "/stats",
                     *eng.stats(chip, m, ns, 1.0, 8, 2))


def two_rank_cases(mesh_of, save, info, inputs):
    """What the 2-rank spawn runs.  ``inputs``: the reference's problem
    (the chip's fields, m0, ns, betas) for the rows case."""
    g = masked()
    mach = PBitMachine.create(g, 0, noise="counter", device="cpu")

    # the reference's 2-device problem: rows over 2 ranks, Sync()
    chip = convert.chip_from_numpy(
        [inputs[f"chip{i}"] for i in range(int(inputs["n_chip"]))], "cpu")
    m0 = convert.spins_from_numpy(inputs["m0"], "cpu")
    ns0 = convert.noise_state_from_numpy(inputs["ns"], "cpu")
    betas = torch.from_numpy(inputs["betas"])
    ses = session(mach, mesh_of((2,), ("data",)), backend="sparse")
    info("rows2/transport", str(ses._engine.transport))
    save("rows2/sample", *ses.sample(chip, m0, ns0, betas, collect=True))
    cm, cv = clamps(g)
    for tag, kw in (("cv", dict(clamp_mask=cm, clamp_values=cv)),
                    ("cm", dict(clamp_mask=cm)), ("free", {})):
        save(f"rows2/stats_{tag}", *ses.stats(chip, m0, ns0, 8, 2, **kw))
    save("rows2/hist", *ses.visible_hist(chip, m0, ns0,
                                         np.array([0, 3, 9, 11]), 2, betas))

    # 4 bands on 2 ranks, lfsr noise: the in-card gather and the ranks
    lf = PBitMachine.create(g, 1, noise="lfsr", device="cpu")
    ses = session(lf, mesh_of((4,), ("data",)), backend="sparse")
    barrier_suite(save, "rows4_lfsr", ses, *problem(ses, g, 7))

    # the relaxed policies and their routes, on 4 bands and on 2
    base = session(mach, None)
    chip, m, ns = problem(base, g, 11)
    engine_runs(save, info, "rows4", g, mesh_of((4,), ("data",)), chip, m,
                ns, stats={("k4", "k5"), ("k2_async", "k5"),
                           ("k1_L2", "k1")})
    engine_runs(save, info, "rows2", g, mesh_of((2,), ("data",)), chip, m,
                ns)

    # what ``auto`` resolves, beside the route the engine takes for the
    # fused kernels on the card (both ask `k5_runs`)
    for pol, fields in (("k4_L4", dict(halo_every=4, sweeps_per_launch=4)),
                        ("k1_L4", dict(halo_every=1, sweeps_per_launch=4))):
        sync = api.Sync(**fields)
        mesh = mesh_of((4,), ("data",))
        info(f"auto/{pol}/backend", session(mach, mesh, sync=sync).backend)
        info(f"auto/{pol}/route", ShardedEngine(
            g, mesh, api.Partition(), "counter", 8, B, sync=sync,
            backend="fused_sparse", device="cpu",
            resident_exchange=True).route)

    # a program swap on a sharded Session: two programs, chained
    ses = session(mach, mesh_of((4,), ("data",)),
                  sync=api.Sync(halo_every=2, sweeps_per_launch=2))
    rng = np.random.default_rng(13)
    progs = [ses.make_program(
        torch.as_tensor(rng.integers(-60, 60, g.n_edges), dtype=torch.int32),
        torch.as_tensor(rng.integers(-15, 15, g.n_nodes), dtype=torch.int32),
        clamp_mask=clamps(g)[0] if k else None) for k in range(2)]
    out = ses.sample_program(progs[0], m, ns, BETAS)
    save("swap/first", *out[:2])
    save("swap/second", *ses.sample_program(progs[1], out[0], out[1],
                                            BETAS)[:2])

    # stuck spins and transient flips on the scan shapes
    faults = api.Faults(stuck_nodes=(2, 17, 40), stuck_values=(1, -1, 1),
                        flip_prob=0.05, flip_seed=3)
    fm = PBitMachine.create(g, 2, noise="counter", device="cpu",
                            faults=faults)
    for pol, sync in (("barrier", api.Sync()),
                      ("k3", api.Sync(halo_every=3, sweeps_per_launch=2))):
        ses = session(fm, mesh_of((4,), ("data",)), sync=sync)
        info(f"faults/{pol}/backend", ses.backend)
        chip, m, ns = problem(ses, g, 17)
        save(f"faults/{pol}/sample", *ses.sample(chip, m, ns, BETAS)[:2])
        save(f"faults/{pol}/stats", *ses.stats(chip, m, ns, 8, 2))

    # the lattice anneal on two ranks (spins exact, energies to rounding),
    # and a rank's collectives in it (`comm_counts`)
    spec = ANNEAL
    lat = make_sk_lattice(spec, torch.Generator().manual_seed(5),
                          HardwareConfig.ideal(), device="cpu")
    run = make_lattice_anneal(spec, mesh_of((2,), ("data",)),
                              n_sweeps=ANNEAL_SWEEPS,
                              record_every=ANNEAL_EVERY, device="cpu")
    m, e = run(lat, torch.Generator().manual_seed(6),
               torch.linspace(0.1, 2.0, 20))
    save("anneal/m", m)
    save("approx/anneal/energies", e)
    if run.session._engine.comm is not None:
        info("anneal/comm", json.dumps(comm_counts(
            run.session._engine.comm.record())))


def comm_counts(record: dict) -> dict:
    """A `RankComm` / `MeshComm` record without what a transport may
    change (its name, its seconds): calls and bytes by kind and the
    reference's reading of them."""
    return {k: record[k] for k in ("calls", "bytes", "reference")}


def four_rank_cases(mesh_of, save, info):
    """What the 4-rank spawn runs: 2 rows x 2 chains, and one band a
    rank."""
    g = masked()
    mach = PBitMachine.create(g, 0, noise="counter", device="cpu")
    part = api.Partition(rows="r", chains="c")
    ses = session(mach, mesh_of((2, 2), ("r", "c")), backend="sparse",
                  partition=part)
    info("grid/transport", str(ses._engine.transport))
    barrier_suite(save, "grid", ses, *problem(ses, g, 3))
    lf = PBitMachine.create(g, 1, noise="lfsr", device="cpu")
    ses = session(lf, mesh_of((2, 2), ("r", "c")), backend="sparse",
                  partition=part)
    barrier_suite(save, "grid_lfsr", ses, *problem(ses, g, 5), hist=False)

    # one CD epoch of the full adder, twice, on the 2 x 2 mesh
    gc = make_chimera(2, 2)
    task = tasks.full_adder_task(gc)
    cfg = CDConfig(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B)
    for backend in ("sparse", "fused_sparse"):
        cm = PBitMachine.create(gc, 4, noise="counter", backend=backend,
                                device="cpu",
                                mesh=mesh_of((2, 2), ("r", "c")),
                                partition=part)
        step = make_cd_step(cm, cfg, task.visible_idx)
        rng = np.random.default_rng(4)
        Jm = torch.as_tensor(rng.normal(size=gc.n_edges) * 20.0,
                             dtype=torch.float32)
        hm = torch.as_tensor(rng.normal(size=gc.n_nodes) * 10.0,
                             dtype=torch.float32)
        st = cm.session(chains=B).init_state(torch.Generator().manual_seed(5))
        state = [Jm, hm, None, st.m, st.noise_state,
                 (torch.zeros_like(Jm), torch.zeros_like(hm))]
        for epoch in range(2):
            data = torch.as_tensor(np.asarray(all_states(5), np.float32)[
                rng.integers(0, 32, size=B)])
            out = step(state[0], state[1], data, *state[3:])
            save(f"cd_{backend}/{epoch}", *out[:4], *out[4])
            state = [out[0], out[1], None, *out[2:5]]

    # one band a rank: K5 per card with a single band, and the scan
    base = session(mach, None)
    chip, m, ns = problem(base, g, 11)
    engine_runs(save, info, "rows4", g, mesh_of((4,), ("data",)), chip, m,
                ns, stats={("k4", "k5")})

