"""Port vs reference: contrastive-divergence training.

One CD step through both packages from the same mismatch arrays, master
weights, data rows, spins and counter-noise state (carried across as
numpy), with 8 chains x 8 measured sweeps per phase: at these powers of
two every moment is an exact dyadic number, so the updated master weights
are equal.  Programmed chips agree to 1e-6 relative only
(`tests/_torch_port.py`); no decision of these seeds falls inside that
margin (ROADMAP Queue 3 item 3 is the rule if one ever does).  Inside the
port, five epochs of `train_cd` are equal across the five backends, and the
AND gate is learned under the thresholds of ``tests/test_cd.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cd as ref_cd
from repro.core import tasks as ref_tasks
from repro.core.chimera import make_chimera
from repro_torch import convert
from repro_torch.core import cd as port_cd
from repro_torch.core import energy as port_energy
from repro_torch.core import hardware as port_hw
from repro_torch.core import tasks as port_tasks

from _torch_port import port_mismatch

CHAINS = 8
CFG = dict(lr=6.0, cd_k=10, pos_sweeps=10, burn_in=2, chains=CHAINS)
BACKENDS = ("ref", "pallas", "fused", "sparse", "fused_sparse")


@pytest.mark.parametrize("port_backend,ref_backend", [
    ("fused", "fused"), ("ref", "ref"), ("fused_sparse", "fused_sparse"),
    ("pallas", "fused_sparse"), ("sparse", "fused_sparse")])
def test_cd_step_matches_reference(port_backend, ref_backend):
    g = make_chimera(1, 2)
    task = ref_tasks.full_adder_task(g)
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(3),
                                    noise="counter", backend=ref_backend)
    port = port_cd.PBitMachine(
        graph=g, hw=port_hw.HardwareConfig(),
        mismatch=port_mismatch(ref.mismatch), noise="counter",
        backend=port_backend, device="cpu")
    ref_step = ref_cd.make_cd_step(ref, ref_cd.CDConfig(**CFG),
                                   task.visible_idx)
    port_step = port_cd.make_cd_step(port, port_cd.CDConfig(**CFG),
                                     task.visible_idx)
    rng = np.random.default_rng(4)
    Jm = (rng.normal(size=g.n_edges) * 20.0).astype(np.float32)
    hm = (rng.normal(size=g.n_nodes) * 10.0).astype(np.float32)
    st = ref.session(chains=CHAINS).init_state(jax.random.PRNGKey(5))
    m, ns = np.asarray(st.m), np.asarray(st.noise_state)
    vel = (np.zeros(g.n_edges, np.float32), np.zeros(g.n_nodes, np.float32))
    r_state = [jnp.asarray(Jm), jnp.asarray(hm), None, jnp.asarray(m),
               jnp.asarray(ns), tuple(map(jnp.asarray, vel))]
    p_state = [torch.from_numpy(Jm), torch.from_numpy(hm), None,
               convert.spins_from_numpy(m, "cpu"),
               convert.noise_state_from_numpy(ns, "cpu"),
               tuple(map(torch.from_numpy, vel))]
    for epoch in range(2):
        idx = rng.integers(0, 32, size=CHAINS)
        data = port_energy.all_states(5)[idx]
        r_state[2], p_state[2] = jnp.asarray(data), torch.from_numpy(data)
        r_out = ref_step(*r_state)
        p_out = port_step(*p_state)
        for k, (a, b) in enumerate(zip(p_out[:4], r_out[:4])):
            if k == 3:
                np.testing.assert_array_equal(
                    convert.noise_state_to_numpy(a), np.asarray(b))
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(p_out[4], r_out[4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for name, v in r_out[5].items():
            np.testing.assert_allclose(float(p_out[5][name]), float(v),
                                       rtol=1e-6, atol=1e-7)
        assert float(p_out[5]["update_skipped"]) == 0.0
        r_state = [r_out[0], r_out[1], None, r_out[2], r_out[3], r_out[4]]
        p_state = [p_out[0], p_out[1], None, p_out[2], p_out[3], p_out[4]]
    assert np.abs(p_state[0].numpy() - Jm).max() > 0   # it learned


def test_cd_step_checks_chains_and_guards_non_finite():
    """A bad data batch (NaN rows) gives non-finite moments: the update is
    skipped and reported, the weights, velocity and chains stay as they
    were — the reference's skip-and-log guard."""
    g = make_chimera(1, 1)
    mach = port_cd.PBitMachine.create(g, 0, noise="counter", backend="fused",
                                      device="cpu")
    task = port_tasks.and_gate_task(g)
    with pytest.raises(ValueError, match="chains"):
        mach.session(chains=4).make_cd_step(
            port_cd.CDConfig(**dict(CFG, chains=8)), task.visible_idx)
    step = port_cd.make_cd_step(mach, port_cd.CDConfig(**CFG),
                                task.visible_idx)
    ses = mach.session(chains=CHAINS)
    st = ses.init_state(ses.generator(0))
    Jm, hm = torch.full((g.n_edges,), 3.0), torch.full((8,), -2.0)
    vel = (torch.full((g.n_edges,), 0.5), torch.zeros(8))
    bad = torch.full((CHAINS, 3), float("nan"))
    out = step(Jm, hm, bad, st.m, st.noise_state, vel)
    assert float(out[5]["update_skipped"]) == 1.0
    assert torch.equal(out[0], Jm) and torch.equal(out[1], hm)
    assert torch.equal(out[4][0], vel[0]) and torch.equal(out[2], st.m)
    out = step(Jm, hm, torch.ones((CHAINS, 3)), st.m, st.noise_state, vel)
    assert float(out[5]["update_skipped"]) == 0.0
    assert not torch.equal(out[0], Jm)
    assert step.with_mismatch is not None


def test_five_epochs_equal_across_the_five_backends():
    """Same seeds through ref / pallas / fused / sparse / fused_sparse:
    master weights, metric and KL histories equal bit for bit."""
    g = make_chimera(1, 2)
    task = port_tasks.full_adder_task(g)
    cfg = port_cd.CDConfig(**dict(CFG, epochs=5))
    results = {}
    for backend in BACKENDS:
        mach = port_cd.PBitMachine.create(g, 11, noise="counter",
                                          backend=backend, device="cpu")
        results[backend] = port_cd.train_cd(
            mach, task.visible_idx, task.target_dist, cfg, 12,
            eval_every=cfg.epochs)
    want = results["ref"]
    assert np.abs(want.J_edges).max() > 0
    for backend, res in results.items():
        np.testing.assert_array_equal(res.J_edges, want.J_edges)
        np.testing.assert_array_equal(res.hm, want.hm)
        assert res.metric_history == want.metric_history, backend
        assert res.kl_history == want.kl_history, backend
        assert res.Jm.shape == (g.n_nodes, g.n_nodes)


def test_and_gate_learning_under_mismatch():
    """Paper Fig 7: the thresholds of tests/test_cd.py, through the dense
    resident engine's plain version — the ideal chip learns (KL < 0.25),
    the mismatched chip learns in situ (KL < 0.3), the correlation error
    falls, and in-situ weights beat ideal-chip weights transferred onto the
    mismatched chip."""
    g = make_chimera(1, 1)
    task = port_tasks.and_gate_task(g)
    cfg = port_cd.CDConfig(lr=6.0, cd_k=15, pos_sweeps=15, burn_in=3,
                           chains=256, epochs=50)
    mk = lambda hw: port_cd.PBitMachine.create(  # noqa: E731
        g, 42, hw, beta=1.0, w_scale=0.05, noise="counter", backend="fused",
        device="cpu")
    ideal, real = mk(port_hw.HardwareConfig.ideal()), \
        mk(port_hw.HardwareConfig())
    res_ideal = task.train(ideal, cfg, 7, eval_every=cfg.epochs)
    res_real = task.train(real, cfg, 7, eval_every=cfg.epochs)
    assert res_ideal.kl_history[-1][1] < 0.25, res_ideal.kl_history
    assert res_real.kl_history[-1][1] < 0.3, res_real.kl_history
    first = np.mean([m["corr_err"] for m in res_real.metric_history[:5]])
    last = np.mean([m["corr_err"] for m in res_real.metric_history[-5:]])
    assert last < first
    kl_transfer = task.kl_to_target(
        task.sample_dist(real, res_ideal.J_edges, res_ideal.hm, 3))
    kl_insitu = task.kl_to_target(
        task.sample_dist(real, res_real.J_edges, res_real.hm, 3))
    assert kl_insitu < kl_transfer + 0.05, (kl_insitu, kl_transfer)
    assert kl_insitu < 0.3
    codes = port_hw.quantize_codes(torch.as_tensor(res_real.Jm)).numpy()
    assert codes.min() >= -128 and codes.max() <= 127
    assert (res_real.Jm[~g.adjacency()] == 0).all()


def test_pcd_momentum_decay_smoke():
    """Persistent chains, momentum, weight decay and a separate bias rate
    (tests/test_tempering.py::test_pcd_momentum_smoke's options, plus the
    two rates) train without divergence, within the DAC range."""
    g = make_chimera(1, 1)
    task = port_tasks.and_gate_task(g)
    mach = port_cd.PBitMachine.create(g, 0, noise="counter", backend="fused",
                                      w_scale=0.05, device="cpu")
    cfg = port_cd.CDConfig(lr=3.0, cd_k=10, pos_sweeps=10, chains=128,
                           epochs=30, persistent=True, momentum=0.5,
                           weight_decay=0.01, h_lr_scale=0.5)
    res = task.train(mach, cfg, 1, eval_every=30)
    assert np.isfinite(res.kl_history[-1][1])
    assert np.abs(res.Jm).max() <= 127.0 and np.abs(res.hm).max() <= 127.0
    assert not any(m["update_skipped"] for m in res.metric_history)
    plain = task.train(mach, port_cd.CDConfig(lr=3.0, cd_k=10, pos_sweeps=10,
                                              chains=128, epochs=30), 1,
                       eval_every=30)
    assert not np.array_equal(plain.J_edges, res.J_edges)
