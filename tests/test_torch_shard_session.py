"""Port vs reference: row-band sharded Sessions.

* The barrier policy (``Sync()``, the default): the port's sharded
  Sessions — 2 and 4 row bands and a 2x2 rows x chains mesh — equal the
  reference's *unsharded* Session bit for bit (its own contract), through
  `sample` (with the trajectory), clamped `stats`, `visible_hist` and a CD
  step, with counter and lfsr noise.  Chips and states cross as numpy.
* Relaxed policies (``halo_every`` 2, 3, 4, ``mode="async"`` and
  ``halo_every=inf`` with ``sweeps_per_launch=4``) on ``sparse`` and
  ``fused_sparse``: the port's Sessions equal the reference's sharded
  engine itself, run once per file on forced host devices (see
  `_torch_port.run_forced_reference` for the mesh it needs).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import cd as ref_cd
from repro.core import tasks as ref_tasks
from repro.core.chimera import make_chimera, make_chip_graph
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import cd as port_cd
from repro_torch.core import energy as port_energy
from repro_torch.core.distributed import make_mesh
from repro_torch.core.hardware import HardwareConfig as PortHW

from _torch_port import port_chip, port_mismatch, run_forced_reference

B = 8
MESHES = {   # name: (mesh shape, axis names, partition)
    "rows2": ((2,), ("data",), dict(rows="data")),
    "rows4": ((4,), ("data",), dict(rows="data")),
    "rows2_x_chains2": ((2, 2), ("r", "c"), dict(rows="r", chains="c")),
}


def _graph(name):
    return {"chip": make_chip_graph,
            "masked": lambda: make_chimera(4, 2, masked_cells=((3, 1),))}[
        name]()


def _machines(g, noise, backend="sparse", seed=0):
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(seed),
                                    noise=noise, backend=backend)
    port = port_cd.PBitMachine(graph=g, hw=PortHW(),
                               mismatch=port_mismatch(ref.mismatch),
                               noise=noise, backend=backend, device="cpu")
    return ref, port


def _sharded(port, mesh_name, **kw):
    shape, names, part = MESHES[mesh_name]
    return port_api.Session(port.sampler_spec(
        chains=B, mesh=make_mesh(shape, names),
        partition=port_api.Partition(**part), **kw))


def _ref_problem(ref, g, seed):
    ses = ref.session(chains=B)
    rng = np.random.default_rng(seed)
    chip = ses.program_edges(
        jnp.asarray(rng.integers(-60, 60, g.n_edges), jnp.int32),
        jnp.asarray(rng.integers(-15, 15, g.n_nodes), jnp.int32))
    m0 = ses.random_spins(jax.random.PRNGKey(seed + 1))
    ns = ses.noise_state(jax.random.PRNGKey(seed + 2))
    return ses, chip, m0, ns


def _port_state(chip, m0, ns):
    return (port_chip(chip), convert.spins_from_numpy(np.asarray(m0), "cpu"),
            convert.noise_state_from_numpy(np.asarray(ns), "cpu"))


def _equal(port_out, ref_out):
    for a, b in zip(port_out, ref_out):
        if a is None:
            assert b is None
            continue
        got = (convert.noise_state_to_numpy(a) if a.dtype == torch.int32
               else a.numpy())
        np.testing.assert_array_equal(got, np.asarray(b))


# ---------------------------------------------------------------------------
# the barrier policy: sharded == the reference's single-device Session
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_barrier_policy_equals_unsharded_reference(noise, mesh_name):
    g = _graph("masked")
    ref, port = _machines(g, noise)
    ref_ses, ref_chip, m0, ns = _ref_problem(ref, g, 1)
    ses = _sharded(port, mesh_name)
    assert ses.backend == "sparse" and ses.partition_plan is not None
    chip, pm0, pns = _port_state(ref_chip, m0, ns)
    betas = np.linspace(0.3, 1.5, 5).astype(np.float32)

    _equal(ses.sample(chip, pm0, pns, betas, collect=True),
           ref_ses.sample(ref_chip, m0, ns, jnp.asarray(betas),
                          collect=True))
    cm = np.zeros(g.n_nodes, bool)
    cm[[0, 5, g.n_nodes - 1]] = True
    cv = np.ones((B, g.n_nodes), np.float32)
    for kw in (dict(clamp_mask=cm, clamp_values=cv), dict(clamp_mask=cm),
               {}):
        ref_kw = {k: jnp.asarray(v) for k, v in kw.items()}
        port_kw = {k: torch.as_tensor(v) for k, v in kw.items()}
        _equal(ses.stats(chip, pm0, pns, 8, 2, **port_kw),
               ref_ses.stats(ref_chip, m0, ns, 8, 2, **ref_kw))
    vis = np.array([0, 3, 9, 11])
    _equal(ses.visible_hist(chip, pm0, pns, vis, 2, betas),
           ref_ses.visible_hist(ref_chip, m0, ns, vis, 2, jnp.asarray(betas)))


@pytest.mark.parametrize("backend", ["sparse", "fused_sparse"])
def test_barrier_policy_on_the_chip_graph(backend):
    """The 440-spin chip (7 cell rows, cell (6, 7) masked) on 2 and 7 bands,
    through the scan path and through K1 windows with exchanges between
    them (``fused_sparse`` under ``Sync()``)."""
    g = _graph("chip")
    ref, port = _machines(g, "counter", backend=backend)
    ref_ses, ref_chip, m0, ns = _ref_problem(ref, g, 4)
    chip, pm0, pns = _port_state(ref_chip, m0, ns)
    betas = np.linspace(0.3, 1.5, 4).astype(np.float32)
    want = ref_ses.sample(ref_chip, m0, ns, jnp.asarray(betas))
    want_stats = ref_ses.stats(ref_chip, m0, ns, 6, 2)
    for n in (2, 7):
        ses = port_api.Session(port.sampler_spec(
            chains=B, mesh=make_mesh((n,), ("data",))))
        assert ses.backend == backend
        _equal(ses.sample(chip, pm0, pns, betas)[:2], want[:2])
        _equal(ses.stats(chip, pm0, pns, 6, 2), want_stats)


@pytest.mark.parametrize("port_backend,noise", [
    ("sparse", "counter"), ("fused_sparse", "counter"), ("sparse", "lfsr")])
def test_cd_step_on_rows_x_chains_equals_unsharded_reference(port_backend,
                                                            noise):
    """One CD epoch of the full adder, twice, on a 2x2 rows x chains mesh:
    the master weights, chains and noise state equal the reference's
    unsharded step (8 chains and 8 measured sweeps: exact moments)."""
    g = make_chimera(2, 2)
    task = ref_tasks.full_adder_task(g)
    cfg = dict(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=B)
    ref, _ = _machines(g, noise, backend="fused_sparse", seed=3)
    port = port_cd.PBitMachine(
        graph=g, hw=PortHW(), mismatch=port_mismatch(ref.mismatch),
        noise=noise, backend=port_backend, device="cpu",
        mesh=make_mesh((2, 2), ("r", "c")),
        partition=port_api.Partition(rows="r", chains="c"))
    ref_step = ref_cd.make_cd_step(ref, ref_cd.CDConfig(**cfg),
                                   task.visible_idx)
    port_step = port_cd.make_cd_step(port, port_cd.CDConfig(**cfg),
                                     task.visible_idx)
    assert port.session(chains=B)._engine is not None
    rng = np.random.default_rng(4)
    Jm = (rng.normal(size=g.n_edges) * 20.0).astype(np.float32)
    hm = (rng.normal(size=g.n_nodes) * 10.0).astype(np.float32)
    st = ref.session(chains=B).init_state(jax.random.PRNGKey(5))
    m, ns = np.asarray(st.m), np.asarray(st.noise_state)
    vel = (np.zeros(g.n_edges, np.float32), np.zeros(g.n_nodes, np.float32))
    r_state = [jnp.asarray(Jm), jnp.asarray(hm), None, jnp.asarray(m),
               jnp.asarray(ns), tuple(map(jnp.asarray, vel))]
    p_state = [torch.from_numpy(Jm), torch.from_numpy(hm), None,
               convert.spins_from_numpy(m, "cpu"),
               convert.noise_state_from_numpy(ns, "cpu"),
               tuple(map(torch.from_numpy, vel))]
    for _ in range(2):
        data = port_energy.all_states(5)[rng.integers(0, 32, size=B)]
        r_state[2], p_state[2] = jnp.asarray(data), torch.from_numpy(data)
        r_out = ref_step(*r_state)
        p_out = port_step(*p_state)
        _equal(p_out[:4], r_out[:4])
        _equal(p_out[4], r_out[4])
        r_state = [r_out[0], r_out[1], None, *r_out[2:5]]
        p_state = [p_out[0], p_out[1], None, *p_out[2:5]]


def test_one_band_mesh_is_bit_exact_under_every_policy():
    """One row band: halos are structurally zero, so every policy — the
    fused shapes included — equals the unsharded Session (port only)."""
    g = make_chimera(3, 2, masked_cells=((1, 1),))
    mach = port_cd.PBitMachine.create(g, 0, noise="counter", device="cpu")
    ses0 = port_api.Session(mach.sampler_spec(chains=B).replace(
        backend="sparse"))
    rng = np.random.default_rng(1)
    chip = ses0.program_edges(rng.integers(-50, 50, g.n_edges),
                              rng.integers(-10, 10, g.n_nodes))
    st = ses0.init_state(ses0.generator(2))
    betas = torch.linspace(0.3, 1.5, 8)
    want = ses0.sample(chip, st.m, st.noise_state, betas)
    want_stats = ses0.stats(chip, st.m, st.noise_state, 8, 2)
    for sync in (port_api.Sync(halo_every=1, sweeps_per_launch=4),
                 port_api.Sync(halo_every=2, sweeps_per_launch=2),
                 port_api.Sync(halo_every=4, mode="async",
                               sweeps_per_launch=4),
                 port_api.Sync(halo_every=math.inf, sweeps_per_launch=4)):
        for backend in ("sparse", "fused_sparse"):
            ses = port_api.Session(mach.sampler_spec(
                chains=B, mesh=make_mesh((1,), ("data",)),
                sync=sync).replace(backend=backend))
            got = ses.sample(chip, st.m, st.noise_state, betas)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            for a, b in zip(ses.stats(chip, st.m, st.noise_state, 8, 2),
                            want_stats):
                assert torch.equal(a, b)


def test_sharded_session_refuses_fleets_and_bad_schedules():
    g = make_chimera(2, 2)
    mach = port_cd.PBitMachine.create(g, 0, noise="counter", device="cpu")
    ses = port_api.Session(mach.sampler_spec(
        chains=B, mesh=make_mesh((2,), ("data",)),
        sync=port_api.Sync(halo_every=2, sweeps_per_launch=4)))
    assert ses.backend == "fused_sparse"
    assert ses.partition_plan.n_shards == 2
    assert port_api.Session(mach.sampler_spec(chains=B)).partition_plan \
        is None
    prog = ses.make_program(np.zeros(g.n_edges, np.int32),
                            np.zeros(g.n_nodes, np.int32))
    progs = port_api.stack_programs([prog, prog])
    st = ses.init_state(ses.generator(0))
    with pytest.raises(ValueError, match="single-device"):
        ses.sample_fleet(progs, torch.stack([st.m] * 2),
                         torch.stack([st.noise_state] * 2))
    cfg = port_cd.CDConfig(chains=B)
    with pytest.raises(ValueError, match="single-device"):
        ses.make_cd_fleet_step(cfg, np.arange(3))
    chip = ses.program_edges(np.zeros(g.n_edges, np.int32),
                             np.zeros(g.n_nodes, np.int32))
    with pytest.raises(ValueError, match="sweeps_per_launch=4"):
        ses.sample(chip, st.m, st.noise_state, torch.ones(6))
    # a program through the sharded Session equals programming + sample
    a = ses.sample_program(prog, st.m, st.noise_state, torch.ones(8))
    b = ses.sample(chip, st.m, st.noise_state, torch.ones(8))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# relaxed policies: the port's Sessions against the reference's engine
# ---------------------------------------------------------------------------
POLICIES = {
    "k2": dict(halo_every=2, sweeps_per_launch=2),
    "k3": dict(halo_every=3, sweeps_per_launch=4),
    "k4": dict(halo_every=4, sweeps_per_launch=4),
    "k4_async": dict(halo_every=4, mode="async", sweeps_per_launch=4),
    "inf": dict(halo_every=math.inf, sweeps_per_launch=4),
}
RELAXED = [("sparse", name, 2) for name in POLICIES] + [
    ("sparse", "k4_async", 4), ("fused_sparse", "k4", 2),
    ("fused_sparse", "k4_async", 2), ("fused_sparse", "inf", 2)]
STATS = {("sparse", "k3", 2), ("fused_sparse", "k4_async", 2)}


def _case(backend, name, n_dev):
    return f"{backend}-{name}-rows{n_dev}"


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Every relaxed case through the reference's engine, in one run."""
    cases = [(backend, name, n, POLICIES[name], (backend, name, n) in STATS)
             for backend, name, n in RELAXED]
    return run_forced_reference(f"""
    import math
    import jax.numpy as jnp
    from repro import api
    from repro.core.cd import PBitMachine
    from repro.core.chimera import make_chimera
    from repro.core.hardware import HardwareConfig

    inf = math.inf
    g = make_chimera(4, 2, masked_cells=((3, 1),))
    mach = PBitMachine.create(g, jax.random.PRNGKey(0), HardwareConfig(),
                              noise="counter", backend="sparse")
    ses0 = api.Session(mach.sampler_spec(chains={B}))
    rng = np.random.default_rng(5)
    chip = ses0.program_edges(
        jnp.asarray(rng.integers(-60, 60, g.n_edges), jnp.int32),
        jnp.asarray(rng.integers(-15, 15, g.n_nodes), jnp.int32))
    m0 = ses0.random_spins(jax.random.PRNGKey(2))
    ns = ses0.noise_state(jax.random.PRNGKey(3))
    betas = jnp.linspace(0.3, 1.5, 8)
    save("problem", m0, ns, betas, *jax.tree_util.tree_leaves(chip))
    save("unsharded", *ses0.sample(chip, m0, ns, betas)[:2])
    for backend, name, n, sync, stats in {cases!r}:
        mesh = auto_mesh((n,), ("data",))
        sp = mach.sampler_spec(chains={B}, mesh=mesh,
                               partition=api.Partition(rows="data"),
                               sync=api.Sync(**sync))
        ses = api.Session(sp.replace(backend=backend))
        case = f"{{backend}}-{{name}}-rows{{n}}"
        save(case, *ses.sample(chip, m0, ns, betas)[:2])
        if stats:
            save(case + "/stats", *ses.stats(chip, m0, ns, 8, 2))
    """, 4, tmp_path_factory.mktemp("shard_session"))


def _port_problem(runs):
    m0, ns, betas, *chip = runs["problem"]
    return (convert.chip_from_numpy(chip, "cpu"),
            convert.spins_from_numpy(m0, "cpu"),
            convert.noise_state_from_numpy(ns, "cpu"), torch.from_numpy(betas))


@pytest.mark.parametrize("backend,name,n_dev", RELAXED,
                         ids=[_case(*c) for c in RELAXED])
def test_relaxed_policy_matches_reference_engine(reference_runs, backend,
                                                 name, n_dev):
    runs = reference_runs
    chip, m0, ns, betas = _port_problem(runs)
    g = make_chimera(4, 2, masked_cells=((3, 1),))
    mach = port_cd.PBitMachine.create(g, 0, noise="counter", device="cpu")
    ses = port_api.Session(mach.sampler_spec(
        chains=B, mesh=make_mesh((n_dev,), ("data",)),
        sync=port_api.Sync(**POLICIES[name])).replace(backend=backend))
    assert ses.backend == backend
    case = _case(backend, name, n_dev)
    got = ses.sample(chip, m0, ns, betas)
    _equal(got[:2], runs[case])
    if (backend, name, n_dev) in STATS:
        _equal(ses.stats(chip, m0, ns, 8, 2), runs[case + "/stats"])
    # a relaxed policy samples against stale halos: not the barrier run
    assert not np.array_equal(got[0].numpy(), runs["unsharded"][0])
