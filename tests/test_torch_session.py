"""Port vs reference: the slice as a whole.

`PBitMachine` -> `session` -> `program_master` -> `sample` / `stats` /
`visible_hist` through both packages with the same mismatch arrays, spins
and noise state (carried across as numpy by `repro_torch.convert`), for
the `fused_sparse` and `sparse` backends.  The reference's fused kernel
runs in interpret mode, the port's wrapper (CPU tensors) runs its plain
version.  Spins, noise state, moments and histograms are equal at these
seeds; programmed chips agree to 1e-6 relative.
"""
import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import cd as ref_cd
from repro.core.chimera import make_chimera
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import cd as port_cd
from repro_torch.core import hardware as port_hw

from _torch_port import assert_chip_close, port_mismatch

CHAINS = 8
GRAPHS = {"2x2": dict(rows=2, cols=2),
          "masked": dict(rows=3, cols=3, masked_cells=[(0, 2)])}


def _machines(graph, noise, backend, *, sparse=False, seed=0):
    g = make_chimera(**GRAPHS[graph])
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(seed),
                                    sparse=sparse, noise=noise,
                                    backend=backend)
    port = port_cd.PBitMachine(
        graph=g, hw=port_hw.HardwareConfig(),
        mismatch=port_mismatch(ref.mismatch), noise=noise, backend=backend,
        device="cpu")
    return g, ref, port


def _masters(g, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=g.n_edges) * 40.0).astype(np.float32),
            (rng.normal(size=g.n_nodes) * 15.0).astype(np.float32))


def _state(ref_ses, seed):
    st = ref_ses.init_state(jax.random.PRNGKey(seed))
    m, ns = np.asarray(st.m), np.asarray(st.noise_state)
    return st, convert.spins_from_numpy(m, "cpu"), \
        convert.noise_state_from_numpy(ns, "cpu")


def _same_noise(port_ns, ref_ns):
    np.testing.assert_array_equal(convert.noise_state_to_numpy(port_ns),
                                  np.asarray(ref_ns))


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
@pytest.mark.parametrize("backend", ["fused_sparse", "sparse"])
@pytest.mark.parametrize("graph,sparse", [("2x2", False), ("masked", True)])
def test_sample_stats_hist_match_reference(graph, sparse, backend, noise):
    g, ref, port = _machines(graph, noise, backend, sparse=sparse)
    # a linear ramp: its float32 betas are bit-equal in both packages
    ref_ses = ref.session(
        schedule=ref_api.Anneal(0.2, 2.0, n_sweeps=10, kind="linear"),
        chains=CHAINS)
    port_ses = port.session(
        schedule=port_api.Anneal(0.2, 2.0, n_sweeps=10, kind="linear"),
        chains=CHAINS)
    assert port_ses.backend == ref_ses.backend == backend
    Jm, hm = _masters(g, 1)
    ref_chip = ref_ses.program_master(Jm, hm)
    chip = port_ses.program_master(Jm, hm)
    assert_chip_close(chip, ref_chip)
    assert (chip.W is None) == sparse

    st, m0, ns0 = _state(ref_ses, 2)
    r_m, r_ns, _ = ref_ses.sample(ref_chip, st.m, st.noise_state)
    p_m, p_ns, traj = port_ses.sample(chip, m0, ns0)
    assert traj is None
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(r_m))
    _same_noise(p_ns, r_ns)

    r_s, r_c, r_m2, r_ns2 = ref_ses.stats(ref_chip, r_m, r_ns, 12, 3)
    p_s, p_c, p_m2, p_ns2 = port_ses.stats(chip, p_m, p_ns, 12, 3)
    np.testing.assert_array_equal(p_m2.numpy(), np.asarray(r_m2))
    _same_noise(p_ns2, r_ns2)
    # the raw sums are integers; the reference's compiled
    # "/ (chains * measured sweeps)" is a multiply by the float32
    # reciprocal, and so is the port's: equal at 8 chains x 9 sweeps, where
    # a true division would differ in the last place
    for got, want in ((p_s, r_s), (p_c, r_c)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    vis = np.array([0, 5, 9, 12])
    r_h, r_m3, r_ns3 = ref_ses.visible_hist(ref_chip, r_m2, r_ns2, vis, 2)
    p_h, p_m3, p_ns3 = port_ses.visible_hist(chip, p_m2, p_ns2, vis, 2)
    np.testing.assert_array_equal(p_h.numpy(), np.asarray(r_h))
    np.testing.assert_array_equal(p_m3.numpy(), np.asarray(r_m3))
    _same_noise(p_ns3, r_ns3)
    assert float(p_h.sum()) == CHAINS * 8


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_clamped_stats_and_collect_match_reference(noise):
    """The CD positive-phase shape (clamp mask + values) through the fused
    backend, and collect=True falling back to the half-sweep loop."""
    g, ref, port = _machines("2x2", noise, "fused_sparse", seed=3)
    ref_ses = ref.session(chains=CHAINS)
    port_ses = port.session(chains=CHAINS)
    Jm, hm = _masters(g, 4)
    ref_chip, chip = ref_ses.program_master(Jm, hm), \
        port_ses.program_master(Jm, hm)
    st, m0, ns0 = _state(ref_ses, 5)
    rng = np.random.default_rng(6)
    cm = np.zeros(g.n_nodes, bool)
    cm[[0, 5, 9]] = True
    cv = (rng.integers(0, 2, size=(CHAINS, g.n_nodes)) * 2 - 1).astype(
        np.float32)
    r = ref_ses.stats(ref_chip, st.m, st.noise_state, 10, 2,
                      clamp_mask=jax.numpy.asarray(cm),
                      clamp_values=jax.numpy.asarray(cv), beta=0.8)
    p = port_ses.stats(chip, m0, ns0, 10, 2, clamp_mask=torch.from_numpy(cm),
                       clamp_values=torch.from_numpy(cv), beta=0.8)
    for a, b in zip(p[:3], r[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _same_noise(p[3], r[3])
    np.testing.assert_array_equal(p[2].numpy()[:, cm], cv[:, cm])

    betas = np.asarray(ref_api.Anneal(0.1, 2.5, n_sweeps=7).betas())
    r_m, r_ns, r_traj = ref_ses.sample(ref_chip, st.m, st.noise_state,
                                       jax.numpy.asarray(betas), collect=True)
    p_m, p_ns, p_traj = port_ses.sample(chip, m0, ns0, betas, collect=True)
    np.testing.assert_array_equal(p_traj.numpy(), np.asarray(r_traj))
    _same_noise(p_ns, r_ns)
    # and the fused engine reaches the same end state as the loop
    f_m, f_ns, _ = port_ses.sample(chip, m0, ns0, betas)
    assert torch.equal(f_m, p_m) and torch.equal(f_ns, p_ns)


def test_tempered_ladder_and_to_sparse_match_reference():
    g, ref, port = _machines("2x2", "counter", "fused_sparse", seed=7)
    ladder = ref_api.Tempered.geometric(0.3, 2.0, CHAINS, n_sweeps=6)
    p_ladder = port_api.Tempered.geometric(0.3, 2.0, CHAINS, n_sweeps=6)
    assert ladder.ladder == p_ladder.ladder
    ref_ses = ref.to_sparse().session(schedule=ladder, chains=CHAINS)
    port_twin = port.to_sparse()
    assert port_twin.sparse_native and port_twin.to_sparse() is port_twin
    port_ses = port_twin.session(schedule=p_ladder, chains=CHAINS)
    Jm, hm = _masters(g, 8)
    ref_chip, chip = ref_ses.program_master(Jm, hm), \
        port_ses.program_master(Jm, hm)
    assert_chip_close(chip, ref_chip)
    # the sparse twin programs the dense machine's couplings, bit for bit
    dense_chip = port.session(chains=CHAINS).program_master(Jm, hm)
    assert torch.equal(dense_chip.nbr_w, chip.nbr_w)
    st, m0, ns0 = _state(ref_ses, 9)
    r_m, r_ns, _ = ref_ses.sample(ref_chip, st.m, st.noise_state)
    p_m, p_ns, _ = port_ses.sample(chip, m0, ns0)
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(r_m))
    _same_noise(p_ns, r_ns)
