"""Port vs reference: the paper's workloads — Boltzmann tasks, annealing,
Max-Cut and parallel tempering.

Task targets, Max-Cut codes, cut values and flip gains are pure numpy and
array-equal to the reference.  Instances and samplers draw from
`torch.Generator`s, so annealing, Max-Cut and tempering are held to the
behaviour the reference's tests require (``tests/test_system.py``,
``tests/test_tempering.py``) at reduced sweeps, through the dense backends
("pallas" for the trajectory-collecting anneal, "fused" for tempering).
"""
import jax
import numpy as np
import pytest

from repro import api as ref_api
from repro.core import maxcut as ref_maxcut
from repro.core import tasks as ref_tasks
from repro.core import tempering as ref_tempering
from repro.core.chimera import make_chimera, make_chip_graph
from repro_torch.core import annealing as port_annealing
from repro_torch.core import cd as port_cd
from repro_torch.core import maxcut as port_maxcut
from repro_torch.core import tasks as port_tasks
from repro_torch.core import tempering as port_tempering
from repro_torch.core.hardware import HardwareConfig


@pytest.mark.parametrize("name", ["and_gate", "xor_gate", "full_adder"])
@pytest.mark.parametrize("graph", ["1x2", "chip"])
def test_task_targets_match_reference(name, graph):
    g = make_chimera(1, 2) if graph == "1x2" else make_chip_graph()
    want = getattr(ref_tasks, f"{name}_task")(g)
    got = getattr(port_tasks, f"{name}_task")(g)
    assert got.name == want.name and got.n_visible == want.n_visible
    np.testing.assert_array_equal(got.visible_idx, want.visible_idx)
    np.testing.assert_array_equal(got.target_dist, want.target_dist)
    q = np.random.default_rng(0).dirichlet(np.ones(2 ** got.n_visible))
    assert got.kl_to_target(q) == want.kl_to_target(q)
    assert port_tasks.full_adder_rows() == ref_tasks.full_adder_rows()
    assert port_tasks.and_gate_rows() == ref_tasks.and_gate_rows()


@pytest.mark.parametrize("weighted", [False, True])
def test_maxcut_codes_cuts_and_gains_match_reference(weighted):
    g = make_chip_graph()
    ref_prob = ref_maxcut.random_chimera_maxcut(
        g, jax.random.PRNGKey(1), edge_prob=0.8, weighted=weighted)
    prob = port_maxcut.MaxCutProblem(edges=np.asarray(ref_prob.edges),
                                     weights=np.asarray(ref_prob.weights))
    assert prob.n_edges == ref_prob.n_edges
    for a, b in zip(port_maxcut.maxcut_codes(prob, g.n_nodes),
                    ref_maxcut.maxcut_codes(ref_prob, g.n_nodes)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    for _ in range(3):
        m = rng.choice([-1.0, 1.0], size=g.n_nodes).astype(np.float32)
        assert prob.cut_value(m) == ref_prob.cut_value(m)
        np.testing.assert_array_equal(port_maxcut._flip_gains(prob, m),
                                      ref_maxcut._flip_gains(ref_prob, m))
    own = port_maxcut.random_chimera_maxcut(g, 1, edge_prob=0.8,
                                            weighted=weighted)
    assert own.weights.dtype == np.float32 and own.edges.dtype == np.int32
    assert 0.7 < own.n_edges / g.n_edges < 0.9
    assert set(np.unique(own.weights)) <= ({1.0, 2.0, 3.0} if weighted
                                           else {1.0})


def test_sk_instance_is_chip_native():
    g = make_chip_graph()
    J, h = port_annealing.sk_instance(g, 4)
    assert (J == J.T).all() and (J[~g.adjacency()] == 0).all()
    assert J.min() >= -128 and J.max() <= 127 and (J == np.round(J)).all()
    assert (h == 0).all() and np.abs(J).max() > 30
    again, _ = port_annealing.sk_instance(g, 4)
    np.testing.assert_array_equal(J, again)


def _chip_machine(seed, w_scale, backend):
    return port_cd.PBitMachine.create(
        make_chip_graph(), seed, HardwareConfig(), beta=1.0, w_scale=w_scale,
        noise="counter", backend=backend, device="cpu")


def test_sk_annealing_energy_decreases():
    """test_system.py::test_sk_annealing_energy_decreases at 150 sweeps,
    through the dense half-sweep backend."""
    mach = _chip_machine(3, 0.02, "pallas")
    J, h = port_annealing.sk_instance(mach.graph, 4)
    cfg = port_annealing.AnnealConfig(n_sweeps=150, beta_start=0.02,
                                      beta_end=2.0, chains=16)
    out = port_annealing.anneal(mach, J, h, cfg, 5, record_every=30)
    e = out["energy_mean"]
    assert e.shape == (5,) and out["best_state"].shape == (440,)
    assert e[-1] < e[0] * 1.05 and e[-1] < 0
    assert out["best_energy"] <= e[-1]
    with pytest.raises(ValueError, match="sweeps"):
        port_annealing.anneal(mach, J, h, cfg, 5, session=mach.session(
            schedule=port_annealing.AnnealConfig(n_sweeps=10).to_schedule(),
            chains=16))
    lin = port_annealing.AnnealConfig(n_sweeps=9, schedule="linear")
    np.testing.assert_array_equal(
        port_annealing.beta_schedule(lin),
        np.asarray(ref_api.Anneal(
            0.05, 3.0, n_sweeps=9, kind="linear").betas()))


def test_maxcut_beats_random():
    """test_system.py::test_maxcut_beats_random at 150 sweeps."""
    mach = _chip_machine(0, 0.03, "pallas")
    prob = port_maxcut.random_chimera_maxcut(mach.graph, 1, edge_prob=0.8)
    out = port_maxcut.solve_maxcut(
        mach, prob, port_annealing.AnnealConfig(
            n_sweeps=150, beta_start=0.05, beta_end=3.0, chains=16), 2)
    rng = np.random.default_rng(0)
    rand_cut = max(prob.cut_value(rng.choice([-1.0, 1.0], size=440))
                   for _ in range(32))
    assert out["cut_polished"] > rand_cut * 1.15
    assert out["cut_polished"] >= out["cut"]
    assert out["cut_polished"] <= out["upper_bound"]


def test_beta_ladder_matches_reference():
    cfg = dict(n_replicas=5, beta_min=0.1, beta_max=1.6)
    got = port_tempering.beta_ladder(port_tempering.PTConfig(**cfg))
    want = np.asarray(ref_tempering.beta_ladder(
        ref_tempering.PTConfig(**cfg)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(0.1) and abs(got[-1] - 1.6) < 1e-6


def test_pt_finds_lower_or_equal_energy_than_sa():
    """test_tempering.py's check, with tempering through the dense resident
    engine ("fused") and annealing through the dense half-sweep."""
    g = make_chimera(3, 3)
    J, h = port_annealing.sk_instance(g, 1)
    mk = lambda backend: port_cd.PBitMachine.create(  # noqa: E731
        g, 0, HardwareConfig(), w_scale=0.02, noise="counter",
        backend=backend, device="cpu")
    sa = port_annealing.anneal(
        mk("pallas"), J, h, port_annealing.AnnealConfig(
            n_sweeps=300, beta_start=0.05, beta_end=3.0, chains=16), 2)
    pt = port_tempering.parallel_tempering(
        mk("fused"), J, h, port_tempering.PTConfig(
            n_replicas=16, n_sweeps=300, swap_every=10), 2)
    assert 0.05 < pt["swap_rate"] <= 1.0
    assert pt["e_min_per_round"].shape == (30,)
    assert sorted(pt["final_order"].tolist()) == list(range(16))
    assert pt["best_energy"] <= sa["best_energy"] + abs(
        sa["best_energy"]) * 0.07
