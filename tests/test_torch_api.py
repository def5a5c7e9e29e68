"""Port vs reference: schedules, energies, backend and device resolution,
and sampling held by distribution (a one-cell chip against the exact
Boltzmann law) — the parts of the slice that need no reference kernel."""
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import energy as ref_energy
from repro.core import pbit as ref_pbit
from repro.core.chimera import make_chimera
from repro_torch import api as port_api
from repro_torch.core import cd as port_cd
from repro_torch.core import energy as port_energy
from repro_torch.core import hardware as port_hw
from repro_torch.core import pbit as port_pbit

CHAINS = 8


@pytest.mark.parametrize("kind", ["constant", "linear", "geometric",
                                  "tempered"])
@pytest.mark.parametrize("n_sweeps", [1, 2, 7, 100, 1000])
def test_schedule_betas_match_reference(kind, n_sweeps):
    if kind == "constant":
        r, p = ref_api.Constant(beta=1.7, n_sweeps=n_sweeps), \
            port_api.Constant(beta=1.7, n_sweeps=n_sweeps)
    elif kind == "tempered":
        r = ref_api.Tempered.geometric(0.1, 3.0, 16, n_sweeps=n_sweeps)
        p = port_api.Tempered.geometric(0.1, 3.0, 16, n_sweeps=n_sweeps)
    else:
        r = ref_api.Anneal(0.05, 3.0, n_sweeps=n_sweeps, kind=kind)
        p = port_api.Anneal(0.05, 3.0, n_sweeps=n_sweeps, kind=kind)
    chains = 16 if kind == "tempered" else None
    want, got = np.asarray(r.betas(chains)), p.betas(chains)
    assert got.dtype == np.float32 and got.shape == want.shape
    if kind == "geometric":
        # the reference's compiled float32 power and numpy's differ in the
        # last place on under 0.1% of entries: hold to 1 ulp, and count
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
        assert (got != want).mean() <= 0.005
    else:
        np.testing.assert_array_equal(got, want)


def test_tempered_ladder_length_is_checked():
    with pytest.raises(ValueError, match="rungs"):
        port_api.Tempered(ladder=(0.5, 1.0), n_sweeps=3).betas(chains=4)
    with pytest.raises(ValueError, match="geometric"):
        port_api.Anneal(0.1, 1.0, kind="cosine")


@pytest.mark.parametrize("noise,limit", [("philox", 0.05), ("counter", 0.05),
                                         ("lfsr", 0.08)])
def test_one_cell_samples_the_boltzmann_distribution(noise, limit):
    """Philox noise is held by distribution only (the draws are a torch
    generator's); the integer streams get the same check for scale."""
    g = make_chimera(1, 1)
    rng = np.random.default_rng(0)
    codes = np.round(rng.normal(size=g.n_edges) * 35.0)
    h_codes = np.round(rng.normal(size=8) * 15.0)
    mach = port_cd.PBitMachine.create(
        g, 0, hw=port_hw.HardwareConfig.ideal(), noise=noise, w_scale=0.02,
        device="cpu")
    emp = port_cd.sample_visible_dist(mach, codes, h_codes, np.arange(8), 1,
                                      chains=256, sweeps=120, burn_in=20)
    J = np.zeros((8, 8), np.float32)
    J[g.edges[:, 0], g.edges[:, 1]] = codes * 0.02
    J[g.edges[:, 1], g.edges[:, 0]] = codes * 0.02
    h = (h_codes * 0.02).astype(np.float32)
    exact = port_energy.exact_boltzmann(J, h, 1.0)
    np.testing.assert_allclose(exact, ref_energy.exact_boltzmann(J, h, 1.0),
                               rtol=1e-5)
    assert port_energy.kl_divergence(exact, emp) < limit
    assert mach.session(chains=4).backend == (
        "sparse" if noise == "philox" else "fused_sparse")


def test_energy_module_matches_reference():
    g = make_chimera(1, 2)
    rng = np.random.default_rng(1)
    n = g.n_nodes
    J = np.zeros((n, n), np.float32)
    J[g.edges[:, 0], g.edges[:, 1]] = rng.normal(size=g.n_edges)
    J = J + J.T
    h = rng.normal(size=n).astype(np.float32)
    m = (rng.integers(0, 2, size=(5, 3, n)) * 2 - 1).astype(np.float32)
    np.testing.assert_allclose(
        port_energy.ising_energy(torch.from_numpy(m), torch.from_numpy(J),
                                 torch.from_numpy(h)).numpy(),
        np.asarray(ref_energy.ising_energy(m, J, h)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port_energy.all_states(5),
                                  ref_energy.all_states(5))
    vis = np.array([1, 4, 9])
    np.testing.assert_allclose(
        port_energy.exact_visible_marginal(J, h, 0.7, vis),
        ref_energy.exact_visible_marginal(J, h, 0.7, vis), rtol=1e-5)
    samples = m.reshape(-1, n)
    np.testing.assert_array_equal(
        port_energy.empirical_visible_dist(samples, vis),
        ref_energy.empirical_visible_dist(samples, vis))
    p, q = rng.dirichlet(np.ones(8)), rng.dirichlet(np.ones(8))
    assert port_energy.kl_divergence(p, q) == ref_energy.kl_divergence(p, q)


def test_backend_resolution(monkeypatch):
    g = make_chimera(1, 1)
    mk = lambda **kw: port_cd.PBitMachine.create(g, 0, device="cpu", **kw)
    monkeypatch.delenv("REPRO_PBIT_BACKEND", raising=False)
    assert mk(noise="counter").session(chains=2).backend == "fused_sparse"
    assert mk(noise="philox").session(chains=2).backend == "sparse"
    # the env var is a construction-time default ...
    monkeypatch.setenv("REPRO_PBIT_BACKEND", "sparse")
    ses = mk(noise="counter").session(chains=2)
    assert ses.backend == "sparse"
    # ... and is never read again
    monkeypatch.setenv("REPRO_PBIT_BACKEND", "fused_sparse")
    assert ses.backend == "sparse"
    assert port_pbit.resolve_backend(None) == "fused_sparse"
    monkeypatch.delenv("REPRO_PBIT_BACKEND")
    with pytest.raises(ValueError, match="counter"):
        mk(noise="philox", backend="fused_sparse").session(chains=2)
    for dense in ("ref", "pallas", "fused"):
        assert mk(noise="counter", backend=dense).session(
            chains=2).backend == dense
        with pytest.raises(ValueError, match="sparse-native"):
            port_cd.PBitMachine.create(g, 0, device="cpu", sparse=True,
                                       noise="counter", backend=dense
                                       ).session(chains=2)
    with pytest.raises(ValueError, match="counter"):
        mk(noise="philox", backend="fused").session(chains=2)
    # a dense-only spec: the dense resident engine when the noise is
    # in-kernel (and Hopper's model admits it), else the plain loop
    assert port_api.Session(mk(noise="counter").sampler_spec(
        attach_sparse=False)).backend == "fused"
    assert port_api.Session(mk(noise="philox").sampler_spec(
        attach_sparse=False)).backend == "ref"
    with pytest.raises(ValueError, match="schedule"):
        s = mk(noise="counter").session(chains=2)
        st = s.init_state(s.generator(0))
        s.sample(s.program_master(np.zeros(g.n_edges), np.zeros(8)), st.m,
                 st.noise_state)


def test_default_backend_is_ref(monkeypatch):
    """The engine layer's default is the reference's: the plain dense loop
    "ref", a bit-exact sibling of the slot-layout backends on Chimera."""
    monkeypatch.delenv("REPRO_PBIT_BACKEND", raising=False)
    assert port_pbit.resolve_backend(None) == "ref"
    assert port_pbit.resolve_backend("auto") == "ref"
    assert port_pbit.resolve_backend(None) == ref_pbit.resolve_backend(None)
    monkeypatch.setenv("REPRO_PBIT_BACKEND", "pallas")
    assert port_pbit.resolve_backend(None) == "pallas"
    with pytest.raises(ValueError, match="unknown backend"):
        port_pbit.resolve_backend("dense")


def test_init_state_is_seeded_and_typed():
    g = make_chimera(2, 2)
    for noise, shape in (("counter", (2,)), ("lfsr", (CHAINS, 4))):
        ses = port_cd.PBitMachine.create(g, 0, noise=noise, device="cpu") \
            .session(chains=CHAINS)
        a, b = ses.init_state(ses.generator(3)), ses.init_state(
            ses.generator(3))
        assert torch.equal(a.m, b.m) and torch.equal(a.noise_state,
                                                     b.noise_state)
        assert a.m.dtype == torch.float32 and a.m.shape == (CHAINS, 32)
        assert bool((a.m.abs() == 1).all())
        assert a.noise_state.dtype == torch.int32
        assert tuple(a.noise_state.shape) == shape
    ses = port_cd.PBitMachine.create(g, 0, noise="philox", device="cpu") \
        .session(chains=CHAINS)
    assert isinstance(ses.noise_state(ses.generator(0)), torch.Generator)
