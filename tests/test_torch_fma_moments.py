"""Port vs reference: moments and CD updates at chain counts that are not
powers of two.

The reference's compiled moment accumulation and CD update fuse a multiply
that feeds an add into one FMA (ROADMAP Queue 3 item 13); the port rounds
them once too (`core.pbit.fma32`).  At 5, 6 and 12 chains ``1/B`` is not
dyadic, so a second rounding would show: the moments of ``stats`` (scan
path and slot-layout engine, unsharded and on two row bands) and the master
weights of three CD epochs (with and without momentum and weight decay)
must equal the reference's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cd as ref_cd
from repro.core import tasks as ref_tasks
from repro.core.chimera import make_chimera
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import cd as port_cd
from repro_torch.core import energy as port_energy
from repro_torch.core import pbit as port_pbit
from repro_torch.core.distributed import make_mesh
from repro_torch.core.hardware import HardwareConfig as PortHW

from _torch_port import port_chip, port_mismatch, run_forced_reference


def _masked():
    return make_chimera(4, 2, masked_cells=((3, 1),))


def _machines(g, backend, seed=0):
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(seed),
                                    noise="counter", backend=backend)
    port = port_cd.PBitMachine(graph=g, hw=PortHW(),
                               mismatch=port_mismatch(ref.mismatch),
                               noise="counter", backend=backend,
                               device="cpu")
    return ref, port


def _problem(ses, g, seed):
    rng = np.random.default_rng(seed)
    chip = ses.program_edges(
        jnp.asarray(rng.integers(-60, 60, g.n_edges), jnp.int32),
        jnp.asarray(rng.integers(-15, 15, g.n_nodes), jnp.int32))
    return (chip, ses.random_spins(jax.random.PRNGKey(seed + 1)),
            ses.noise_state(jax.random.PRNGKey(seed + 2)))


def _equal(port_out, ref_out):
    for a, b in zip(port_out, ref_out):
        got = (convert.noise_state_to_numpy(a) if a.dtype == torch.int32
               else a.numpy())
        np.testing.assert_array_equal(got, np.asarray(b))


def test_fma32_rounds_once():
    """One rounding of the exact a·b + c, ties included; two roundings
    differ on these inputs."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=4096).astype(np.float32)
    b = np.float32(1.0) / np.float32(6.0) * np.ones(4096, np.float32)
    c = rng.normal(size=4096).astype(np.float32)
    got = port_pbit.fma32(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c)).numpy()
    exact = [float(np.float32(x)) for x in
             (np.array(a, np.longdouble) * np.array(b, np.longdouble)
              + np.array(c, np.longdouble))]
    np.testing.assert_array_equal(got, np.asarray(exact, np.float32))
    assert (got != (a * b + c)).any()
    # (1 + 2^-13)(1 - 2^-12) = 1 - 2^-13 - 2^-25, a float32 midpoint; the
    # exact sum with -2^-80 lies below it, its float64 rounding on it
    x = port_pbit.fma32(torch.tensor([1.0 + 2.0 ** -13]),
                        torch.tensor([1.0 - 2.0 ** -12]),
                        torch.tensor([-2.0 ** -80]))
    assert float(x) == 1.0 - 2.0 ** -13 - 2.0 ** -24


@pytest.mark.parametrize("chains", [5, 6, 12])
@pytest.mark.parametrize("backend", ["sparse", "fused_sparse"])
def test_stats_moments_equal_reference(backend, chains):
    g = _masked()
    ref, port = _machines(g, backend)
    ref_ses = ref.session(chains=chains)
    chip, m0, ns = _problem(ref_ses, g, 1)
    ses = port.session(chains=chains)
    assert ses.backend == backend
    got = ses.stats(port_chip(chip), convert.spins_from_numpy(
        np.asarray(m0), "cpu"), convert.noise_state_from_numpy(
        np.asarray(ns), "cpu"), 8, 2)
    _equal(got, ref_ses.stats(chip, m0, ns, 8, 2))


CD_CASES = {
    "6_chains": dict(chains=6),
    "8_chains_momentum_decay": dict(chains=8, momentum=0.5,
                                    weight_decay=0.01),
}


@pytest.mark.parametrize("case", sorted(CD_CASES))
@pytest.mark.parametrize("backend", ["ref", "sparse", "fused_sparse"])
def test_cd_epochs_equal_reference(backend, case):
    """Three CD epochs of the full adder: master weights, velocities,
    chains and noise state equal the reference's bit for bit."""
    g = make_chimera(1, 2)
    task = ref_tasks.full_adder_task(g)
    cfg = dict(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, **CD_CASES[case])
    B = cfg["chains"]
    ref, port = _machines(g, backend, seed=3)
    ref_step = ref_cd.make_cd_step(ref, ref_cd.CDConfig(**cfg),
                                   task.visible_idx)
    port_step = port_cd.make_cd_step(port, port_cd.CDConfig(**cfg),
                                     task.visible_idx)
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
    for _ in range(3):
        data = port_energy.all_states(5)[rng.integers(0, 32, size=B)]
        r_state[2], p_state[2] = jnp.asarray(data), torch.from_numpy(data)
        r_out = ref_step(*r_state)
        p_out = port_step(*p_state)
        _equal(p_out[:4], r_out[:4])
        _equal(p_out[4], r_out[4])
        r_state = [r_out[0], r_out[1], None, *r_out[2:5]]
        p_state = [p_out[0], p_out[1], None, *p_out[2:5]]
    assert np.abs(p_state[0].numpy() - Jm).max() > 0


SHARDED = {"barrier": dict(), "k4": dict(halo_every=4, sweeps_per_launch=4)}
SHARD_CHAINS = 6


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    """The reference's engine on two row bands (forced host devices)."""
    return run_forced_reference(f"""
    from repro import api
    from repro.core.cd import PBitMachine
    from repro.core.chimera import make_chimera
    from repro.core.hardware import HardwareConfig

    g = make_chimera(4, 2, masked_cells=((3, 1),))
    mach = PBitMachine.create(g, jax.random.PRNGKey(0), HardwareConfig(),
                              noise="counter", backend="sparse")
    ses0 = api.Session(mach.sampler_spec(chains={SHARD_CHAINS}))
    rng = np.random.default_rng(5)
    chip = ses0.program_edges(
        jax.numpy.asarray(rng.integers(-60, 60, g.n_edges), jax.numpy.int32),
        jax.numpy.asarray(rng.integers(-15, 15, g.n_nodes), jax.numpy.int32))
    m0 = ses0.random_spins(jax.random.PRNGKey(2))
    ns = ses0.noise_state(jax.random.PRNGKey(3))
    save("problem", m0, ns, *jax.tree_util.tree_leaves(chip))
    for name, sync in {SHARDED!r}.items():
        sp = mach.sampler_spec(chains={SHARD_CHAINS},
                               mesh=auto_mesh((2,), ("data",)),
                               partition=api.Partition(rows="data"),
                               sync=api.Sync(**sync))
        save(name, *api.Session(sp.replace(backend="sparse")).stats(
            chip, m0, ns, 8, 2))
    """, 2, tmp_path_factory.mktemp("fma_moments"))


@pytest.mark.parametrize("policy", sorted(SHARDED))
def test_sharded_rows_moments_equal_reference(sharded_reference, policy):
    runs = sharded_reference
    m0, ns, *chip = runs["problem"]
    mach = port_cd.PBitMachine.create(_masked(), 0, noise="counter",
                                      device="cpu")
    ses = port_api.Session(mach.sampler_spec(
        chains=SHARD_CHAINS, mesh=make_mesh((2,), ("data",)),
        partition=port_api.Partition(rows="data"),
        sync=port_api.Sync(**SHARDED[policy])).replace(backend="sparse"))
    got = ses.stats(convert.chip_from_numpy(chip, "cpu"),
                    convert.spins_from_numpy(m0, "cpu"),
                    convert.noise_state_from_numpy(ns, "cpu"), 8, 2)
    _equal(got, runs[policy])
