"""Port vs reference: `api.Faults` compiled into every backend.

The same numpy inputs (the reference's mismatch, spins and noise state,
carried across by `repro_torch.convert`) go through both packages with
the same fault draw:

  * `sample_faults` names the same `Faults` in both, tuple for tuple;
  * faulted chips (dense W and slot layout) agree with the reference's
    programmed chips, dead couplers exactly 0 in both views;
  * faulted `sample` / `stats` spins and noise states are equal on every
    backend (the port's kernels run their plain versions on the CPU, the
    reference's Pallas kernels run in interpret mode): the margin rule of
    ROADMAP Queue 3 item 3 holds with no decision inside the margin at
    these seeds, so the spins are compared for equality;
  * counter-noise flips and stuck LFSR bits are bit-exact across
    packages; philox flips agree by rate;
  * the faulted CD step equals the reference's bit for bit at 8 chains,
    masks dead and saturated couplers, and a NaN on a dead edge still
    skips the update.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import cd as ref_cd
from repro.core import pbit as ref_pbit
from repro.core import tasks as ref_tasks
from repro.core.chimera import make_chimera
from repro.core.hardware import HardwareConfig as RefHardwareConfig
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import cd as port_cd
from repro_torch.core import hardware as port_hw
from repro_torch.core import pbit as port_pbit

from _torch_port import assert_chip_close, port_mismatch

CHAINS = 8
FIELDS = dict(stuck_nodes=(1, 6, 19), stuck_values=(1, -1, 1),
              dead_edges=(3, 30), saturated_edges=(9, 41))


def _faults(**kw):
    """The same fault draw in both packages."""
    fields = dict(FIELDS, **kw)
    return ref_api.Faults(**fields), port_api.Faults(**fields)


def _machines(faults, noise="counter", backend="ref", *, sparse=False,
              graph=(2, 2), seed=0, hw=None):
    g = make_chimera(*graph)
    rf, pf = faults
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(seed),
                                    hw or RefHardwareConfig(), sparse=sparse,
                                    noise=noise, backend=backend, faults=rf)
    port = port_cd.PBitMachine(
        graph=g, hw=port_hw.HardwareConfig(**dataclasses.asdict(ref.hw)),
        mismatch=port_mismatch(ref.mismatch), noise=noise, backend=backend,
        device="cpu", faults=pf)
    return g, ref, port


def _masters(g, seed=1):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=g.n_edges) * 40.0).astype(np.float32),
            (rng.normal(size=g.n_nodes) * 15.0).astype(np.float32))


def _sessions(ref, port, n_sweeps=10):
    # a linear ramp: its float32 betas are bit-equal in both packages
    return (ref.session(ref_api.Anneal(0.2, 2.0, n_sweeps=n_sweeps,
                                       kind="linear"), chains=CHAINS),
            port.session(port_api.Anneal(0.2, 2.0, n_sweeps=n_sweeps,
                                         kind="linear"), chains=CHAINS))


def _state(ref_ses, seed=2):
    st = ref_ses.init_state(jax.random.PRNGKey(seed))
    return (st, convert.spins_from_numpy(np.asarray(st.m), "cpu"),
            convert.noise_state_from_numpy(np.asarray(st.noise_state), "cpu"))


def _same_noise(port_ns, ref_ns):
    np.testing.assert_array_equal(convert.noise_state_to_numpy(port_ns),
                                  np.asarray(ref_ns))


# -- the value object ------------------------------------------------------

def test_faults_validation():
    with pytest.raises(ValueError, match="pair up"):
        port_api.Faults(stuck_nodes=(0,))
    with pytest.raises(ValueError, match="±1"):
        port_api.Faults(stuck_nodes=(0,), stuck_values=(2,))
    with pytest.raises(ValueError, match="duplicates"):
        port_api.Faults(stuck_nodes=(3, 3), stuck_values=(1, 1))
    with pytest.raises(ValueError, match="dead_edges and"):
        port_api.Faults(dead_edges=(1,), saturated_edges=(1,))
    with pytest.raises(ValueError, match="flip_prob"):
        port_api.Faults(flip_prob=1.0)
    with pytest.raises(ValueError, match="overlap"):
        port_api.Faults(lfsr_stuck=((0, 0b110, 0b010),))
    f = port_api.Faults(**FIELDS)
    assert f.any and not f.needs_host_hooks
    assert f.faulty_edges == (3, 30, 9, 41)
    assert port_api.Faults(flip_prob=0.1).needs_host_hooks
    assert not port_api.Faults().any


def test_faults_validated_against_graph_and_noise():
    def session(noise="counter", backend="ref", **kw):
        g = make_chimera(1, 1)
        mach = port_cd.PBitMachine.create(g, 0, noise=noise,
                                          backend=backend, device="cpu",
                                          faults=port_api.Faults(**kw))
        return mach.session()

    with pytest.raises(ValueError, match="out of range"):
        session(stuck_nodes=(99,), stuck_values=(1,))
    with pytest.raises(ValueError, match="out of range"):
        session(dead_edges=(999,))
    with pytest.raises(ValueError, match="lfsr"):
        session(noise="philox", lfsr_stuck=((0, 1, 0),))
    with pytest.raises(ValueError, match="flip"):
        session(noise="lfsr", flip_prob=0.1)
    with pytest.raises(ValueError, match="out of range"):
        session(noise="lfsr", lfsr_stuck=((5, 1, 0),))
    # host-hook faults cannot run on an explicitly fused backend
    for backend in ("fused", "fused_sparse"):
        with pytest.raises(ValueError, match="fused"):
            session(backend=backend, flip_prob=0.1)
        with pytest.raises(ValueError, match="fused"):
            session(noise="lfsr", backend=backend,
                    lfsr_stuck=((0, 1, 0),))
    with pytest.raises(ValueError, match="Faults instance"):
        port_api.SamplerSpec(
            graph=make_chimera(1, 1), hw=port_hw.HardwareConfig(),
            mismatch=port_cd.PBitMachine.create(
                make_chimera(1, 1), 0, device="cpu").mismatch,
            faults={"stuck_nodes": (1,)}, device="cpu").validate()


@pytest.mark.parametrize("seed,rates,exclude", [
    (0, dict(stuck_rate=0.02, dead_rate=0.02, saturated_rate=0.01), ()),
    (5, dict(stuck_rate=0.3, dead_rate=0.2), (0, 4)),
    (7, dict(stuck_rate=0.1, dead_rate=0.3, saturated_rate=0.3,
             flip_prob=0.05), (1, 2, 3)),
    (2 ** 40 + 3, dict(saturated_rate=0.5), ()),
])
@pytest.mark.parametrize("graph", [(1, 1), (4, 4)])
def test_sample_faults_equals_the_reference(seed, rates, exclude, graph):
    """Same numpy draws in the same order: the same virtual chip."""
    g = make_chimera(*graph)
    ref = ref_api.sample_faults(seed, g, exclude_nodes=exclude, **rates)
    port = port_api.sample_faults(seed, g, exclude_nodes=exclude, **rates)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port == convert.faults_from_reference_fields(
        dataclasses.asdict(ref))
    assert repr(port) == repr(ref)


def test_sample_faults_is_deterministic_and_excludes():
    g = make_chimera(1, 1)
    f1 = port_api.sample_faults(5, g, stuck_rate=0.3, dead_rate=0.2,
                                exclude_nodes=(0, 4))
    f2 = port_api.sample_faults(5, g, stuck_rate=0.3, dead_rate=0.2,
                                exclude_nodes=np.array([0, 4]))
    assert f1 == f2
    assert not ({0, 4} & set(f1.stuck_nodes))
    assert not (set(f1.dead_edges) & set(f1.saturated_edges))
    with pytest.raises(ValueError, match="not fields"):
        convert.faults_from_reference_fields({"stuck": ()})


# -- programming -----------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "slots"])
@pytest.mark.parametrize("route", ["master", "edges", "dense_codes"])
def test_faulted_chips_equal_the_reference(sparse, route):
    g, ref, port = _machines(_faults(), sparse=sparse,
                             backend="sparse" if sparse else "ref")
    rng = np.random.default_rng(3)
    if route == "master":
        Jm, hm = _masters(g)
        r = ref.program_master(Jm, hm)
        p = port.program_master(Jm, hm)
    else:
        codes = rng.integers(-90, 90, g.n_edges).astype(np.int32)
        codes[41] = 0                     # saturates positive
        codes[9] = -3                     # saturates negative
        h = rng.integers(-20, 20, g.n_nodes).astype(np.int32)
        if route == "edges":
            r = ref.program_edges(jnp.asarray(codes), jnp.asarray(h))
            p = port.program_edges(codes, h)
        else:
            J = np.zeros((g.n_nodes, g.n_nodes), np.int32)
            J[g.edges[:, 0], g.edges[:, 1]] = codes
            J[g.edges[:, 1], g.edges[:, 0]] = codes
            r = ref.program(jnp.asarray(J), jnp.asarray(h))
            p = port.program(J, h)
    assert_chip_close(p, r)
    _, _, slot_ij, slot_ji = port.neighbor_tables()
    for q in FIELDS["dead_edges"]:
        i, j = g.edges[q]
        if p.W is not None:
            assert p.W[i, j] == 0.0 and p.W[j, i] == 0.0
        assert p.nbr_w[slot_ij[q], i] == 0.0
        assert p.nbr_w[slot_ji[q], j] == 0.0


def test_saturated_coupler_is_full_scale():
    faults = _faults(stuck_nodes=(), stuck_values=(), dead_edges=())
    g, _, port = _machines(faults, hw=RefHardwareConfig.ideal())
    healthy = dataclasses.replace(port, faults=None)
    codes = np.full((g.n_edges,), -5, np.int32)
    zeros = np.zeros((g.n_nodes,), np.int32)
    chip = port.program_edges(codes, zeros)
    full = codes.copy()
    full[[9, 41]] = -127
    want = healthy.program_edges(full, zeros)
    for q in (9, 41):
        i, j = g.edges[q]
        assert chip.W[i, j] == want.W[i, j] != 0.0
    chip0 = port.program_edges(np.zeros_like(codes), zeros)
    full0 = np.zeros_like(codes)
    full0[[9, 41]] = 127
    want0 = healthy.program_edges(full0, zeros)
    i, j = g.edges[9]
    assert chip0.W[i, j] == want0.W[i, j] > 0.0


# -- sampling on every backend ---------------------------------------------

@pytest.mark.parametrize("backend,sparse", [
    ("ref", False), ("pallas", False), ("fused", False),
    ("sparse", False), ("fused_sparse", False),
    ("sparse", True), ("fused_sparse", True)])
@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_faulted_sample_and_stats_equal_the_reference(backend, sparse,
                                                      noise):
    g, ref, port = _machines(_faults(), noise, backend, sparse=sparse)
    ref_ses, port_ses = _sessions(ref, port)
    assert port_ses.backend == ref_ses.backend == backend
    Jm, hm = _masters(g)
    r_chip = ref_ses.program_master(Jm, hm)
    chip = port_ses.program_master(Jm, hm)
    st, m0, ns0 = _state(ref_ses)
    r_m, r_ns, _ = ref_ses.sample(r_chip, st.m, st.noise_state)
    p_m, p_ns, _ = port_ses.sample(chip, m0, ns0)
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(r_m))
    _same_noise(p_ns, r_ns)
    stuck = list(FIELDS["stuck_nodes"])
    np.testing.assert_array_equal(
        p_m[:, stuck].numpy(),
        np.broadcast_to(FIELDS["stuck_values"], (CHAINS, 3)))

    r_out = ref_ses.stats(r_chip, r_m, r_ns, 12, 3)
    p_out = port_ses.stats(chip, p_m, p_ns, 12, 3)
    for got, want in zip(p_out[:3], r_out[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_noise(p_out[3], r_out[3])

    vis = np.array([0, 5, 9, 19])        # node 19 is stuck
    r_h, r_m3, _ = ref_ses.visible_hist(r_chip, r_out[2], r_out[3], vis, 2)
    p_h, p_m3, _ = port_ses.visible_hist(chip, p_out[2], p_out[3], vis, 2)
    np.testing.assert_array_equal(p_h.numpy(), np.asarray(r_h))
    np.testing.assert_array_equal(p_m3.numpy(), np.asarray(r_m3))


def test_stuck_spins_ride_the_kernels_clamp_path(monkeypatch):
    """Stuck spins alone keep fused_sparse in the sweep-resident kernel
    (its wrapper sees the stuck nodes out of both colour masks); the
    collected trajectory holds them in every sweep."""
    from repro_torch.kernels import ops

    g, _, port = _machines(_faults(), backend="fused_sparse")
    ses = port.session(port_api.Constant(n_sweeps=6), chains=CHAINS)
    assert ses.backend == "fused_sparse"
    chip = ses.program_master(*_masters(g))
    st = ses.init_state(ses.generator(4))
    seen = []
    real = ops.sweep_sparse

    def spy(*args, **kw):
        seen.append((args[8], args[9]))   # the two colour update masks
        return real(*args, **kw)

    monkeypatch.setattr(ops, "sweep_sparse", spy)
    m, _, _ = ses.sample(chip, st.m, st.noise_state)
    assert len(seen) == 1
    stuck = list(FIELDS["stuck_nodes"])
    assert not seen[0][0][stuck].any() and not seen[0][1][stuck].any()
    monkeypatch.setattr(ops, "sweep_sparse", real)
    _, _, traj = ses.sample(chip, st.m, st.noise_state, collect=True)
    assert (traj[:, :, stuck] == torch.tensor(
        FIELDS["stuck_values"], dtype=torch.float32)).all()
    assert traj[:, :, 0].std() > 0
    np.testing.assert_array_equal(traj[-1].numpy(), m.numpy())


@pytest.mark.parametrize("backend,scan,sparse", [
    ("fused", "ref", False), ("fused_sparse", "sparse", True)])
@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_stuck_spins_histogram_rides_the_kernel(monkeypatch, backend, scan,
                                                sparse, noise):
    """A faulted chip's visible histogram stays in the sweep-resident
    kernel (one launch, the stuck nodes out of both colour masks) and
    equals the half-sweep loop's histogram, spins and noise state."""
    from repro_torch.kernels import ops

    g, _, port = _machines(_faults(), noise, backend, sparse=sparse)
    sched = port_api.Constant(n_sweeps=12)
    ses = port.session(sched, chains=CHAINS)
    loop = dataclasses.replace(port, backend=scan).session(sched,
                                                           chains=CHAINS)
    assert ses.backend == backend
    chip = ses.program_master(*_masters(g))
    st = ses.init_state(ses.generator(5))
    vis = np.array([0, 5, 9, 19])        # node 19 is stuck
    wrapper = "sweep_sparse" if sparse else "sweep_fused"
    seen = []
    real = getattr(ops, wrapper)

    def spy(*args, **kw):
        masks = (args[8], args[9]) if sparse else (args[7], args[8])
        seen.append((masks, kw.get("collect_hist")))
        return real(*args, **kw)

    monkeypatch.setattr(ops, wrapper, spy)
    hist, m, ns = ses.visible_hist(chip, st.m, st.noise_state, vis, 3)
    assert len(seen) == 1 and seen[0][1]
    stuck = list(FIELDS["stuck_nodes"])
    assert not seen[0][0][0][stuck].any() and not seen[0][0][1][stuck].any()
    want = loop.visible_hist(loop.program_master(*_masters(g)), st.m,
                             st.noise_state, vis, 3)
    assert len(seen) == 1                 # the loop launched no kernel
    for got, exp in zip((hist, m, ns), want):
        np.testing.assert_array_equal(got.numpy(), exp.numpy())
    assert hist.sum() == CHAINS * 9
    assert (m[:, stuck] == torch.tensor(FIELDS["stuck_values"],
                                        dtype=torch.float32)).all()


def test_make_lfsr_noise_forces_stuck_bits():
    """The degraded-RNG fault lives in the noise step: the stuck bits are
    forced at seeding and after every decimated clock, and the uniforms
    are read from the forced registers."""
    from repro_torch.core import lfsr as lfsr_mod

    g = make_chimera(2, 2)
    s0 = np.array([0b1010, 0, 0, 0xF0000000], np.int64)
    s1 = np.array([0b0101, 0, 0, 0x0000000F], np.int64)
    init, step = port_pbit.make_lfsr_noise(g, 4, 3, device="cpu",
                                           stuck=(s0, s1))
    init0, step0 = port_pbit.make_lfsr_noise(g, 4, 3, device="cpu")
    st = init(torch.Generator().manual_seed(3))
    st0 = init0(torch.Generator().manual_seed(3))
    s0t, s1t = torch.as_tensor(s0), torch.as_tensor(s1)

    def forced(x):
        return lfsr_mod.from_u64((lfsr_mod.to_u64(x) & ~s0t) | s1t)

    assert torch.equal(st, forced(st0))
    assert not torch.equal(st, st0)
    perm = torch.as_tensor(np.asarray(step.spec.gather_perm, np.int64))
    for _ in range(3):
        prev = st
        st, u = step(prev)
        assert torch.equal(st, forced(lfsr_mod.from_u64(
            lfsr_mod.lfsr_step_n(lfsr_mod.to_u64(prev), 3))))
        assert torch.equal(u, lfsr_mod.flat_cell_uniforms(
            lfsr_mod.to_u64(st)).index_select(-1, perm))
        _, u0 = step0(prev)
        assert not torch.equal(u, u0)


def test_stuck_faults_merge_with_user_clamps():
    """User clamps and fault clamps compose; faults win on their nodes."""
    g, ref, port = _machines(_faults(), backend="fused_sparse")
    ref_ses = ref.session(ref_api.Constant(beta=1.0, n_sweeps=5), chains=4)
    port_ses = port.session(port_api.Constant(beta=1.0, n_sweeps=5),
                            chains=4)
    zc, zh = np.zeros((g.n_edges,), np.float32), np.zeros((g.n_nodes,))
    r_chip = ref_ses.program_master(zc, zh)
    chip = port_ses.program_master(zc, zh)
    st = ref_ses.init_state(jax.random.PRNGKey(0))
    cm = np.zeros((g.n_nodes,), bool)
    cm[[0, 1]] = True                     # node 1 is stuck at +1
    cv = np.zeros((4, g.n_nodes), np.float32)
    cv[:, 0] = -1.0
    cv[:, 1] = -1.0
    r_m, _, _ = ref_ses.sample(r_chip, st.m, st.noise_state,
                               clamp_mask=jnp.asarray(cm),
                               clamp_values=jnp.asarray(cv))
    p_m, _, _ = port_ses.sample(
        chip, convert.spins_from_numpy(np.asarray(st.m), "cpu"),
        convert.noise_state_from_numpy(np.asarray(st.noise_state), "cpu"),
        clamp_mask=torch.as_tensor(cm), clamp_values=torch.as_tensor(cv))
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(r_m))
    assert (p_m[:, 0] == -1.0).all()      # user clamp honoured
    assert (p_m[:, 1] == 1.0).all()       # the fault wins on its node
    assert (p_m[:, 6] == -1.0).all()      # fault clamp alongside


# -- host hooks: flips and stuck LFSR bits ----------------------------------

@pytest.mark.parametrize("backend,sparse", [("ref", False), ("pallas", False),
                                            ("sparse", True)])
def test_counter_flips_are_bit_exact_across_packages(backend, sparse):
    faults = _faults(flip_prob=0.2, flip_seed=11)
    g, ref, port = _machines(faults, "counter", backend, sparse=sparse)
    ref_ses, port_ses = _sessions(ref, port, n_sweeps=6)
    Jm, hm = _masters(g)
    st, m0, ns0 = _state(ref_ses)
    r_m, r_ns, r_tr = ref_ses.sample(ref_ses.program_master(Jm, hm), st.m,
                                     st.noise_state, collect=True)
    p_m, p_ns, p_tr = port_ses.sample(port_ses.program_master(Jm, hm), m0,
                                      ns0, collect=True)
    np.testing.assert_array_equal(p_tr.numpy(), np.asarray(r_tr))
    _same_noise(p_ns, r_ns)
    # the flips act, and the stuck spins never flip
    clean = dataclasses.replace(port, faults=port_api.Faults(**FIELDS))
    c_ses = clean.session(port_api.Anneal(0.2, 2.0, n_sweeps=6,
                                          kind="linear"), chains=CHAINS)
    c_m, c_ns, _ = c_ses.sample(c_ses.program_master(Jm, hm), m0, ns0)
    assert not torch.equal(c_m, p_m)
    _same_noise(c_ns, r_ns)               # flips consume no sampling noise
    stuck = list(FIELDS["stuck_nodes"])
    assert (p_tr[:, :, stuck] == torch.tensor(
        FIELDS["stuck_values"], dtype=torch.float32)).all()


def test_counter_flips_in_the_cd_phases_match_the_reference():
    """stats with flips (the CD phases' shape) on the scan path."""
    faults = _faults(flip_prob=0.1, flip_seed=3)
    g, ref, port = _machines(faults, "counter", "sparse")
    ref_ses, port_ses = _sessions(ref, port)
    Jm, hm = _masters(g)
    st, m0, ns0 = _state(ref_ses)
    r = ref_ses.stats(ref_ses.program_master(Jm, hm), st.m, st.noise_state,
                      12, 3)
    p = port_ses.stats(port_ses.program_master(Jm, hm), m0, ns0, 12, 3)
    for got, want in zip(p[:3], r[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["ref", "sparse"])
def test_stuck_lfsr_bits_are_bit_exact_across_packages(backend):
    stuck0, stuck1 = 0b1010, 0b0101
    faults = _faults(lfsr_stuck=((0, stuck0, stuck1),
                                 (3, 0xF0000000, 0x0000000F)))
    g, ref, port = _machines(faults, "lfsr", backend)
    ref_ses, port_ses = _sessions(ref, port, n_sweeps=6)
    Jm, hm = _masters(g)
    key = jax.random.PRNGKey(9)
    r_ns0 = ref_ses.noise_state(key)
    # the port's seeding is its own (a torch generator): force the bits of
    # the reference's seeds and carry them across
    ns0 = convert.noise_state_from_numpy(np.asarray(r_ns0), "cpu")
    m0 = convert.spins_from_numpy(np.asarray(ref_ses.random_spins(key)),
                                  "cpu")
    r_m, r_ns, r_tr = ref_ses.sample(ref_ses.program_master(Jm, hm),
                                     ref_ses.random_spins(key), r_ns0,
                                     collect=True)
    p_m, p_ns, p_tr = port_ses.sample(port_ses.program_master(Jm, hm), m0,
                                      ns0, collect=True)
    np.testing.assert_array_equal(p_tr.numpy(), np.asarray(r_tr))
    _same_noise(p_ns, r_ns)
    st = convert.noise_state_to_numpy(p_ns)
    assert (st[:, 0] & stuck0).max() == 0
    assert (st[:, 0] & stuck1 == stuck1).all()
    assert (st[:, 3] & 0xF0000000).max() == 0
    # the port's own seeding is forced too
    seeded = convert.noise_state_to_numpy(
        port_ses.noise_state(port_ses.generator(0)))
    assert (seeded[:, 0] & stuck1 == stuck1).all()
    assert (seeded[:, 0] & stuck0).max() == 0


def test_philox_flips_hold_by_rate_and_replay():
    """Philox flips: the rate is flip_prob, the sampling generator is not
    consumed, and a run from the same generator state replays them."""
    p_flip = 0.25
    g = make_chimera(2, 2)
    mach = port_cd.PBitMachine.create(
        g, 0, noise="philox", backend="sparse", device="cpu",
        faults=port_api.Faults(flip_prob=p_flip, flip_seed=5))
    ses = mach.session(port_api.Constant(n_sweeps=1), chains=256)
    flip = ses._flip_fn
    gen = ses.generator(3)
    before = gen.get_state().clone()
    draws = torch.stack([flip(gen) for _ in range(2)])
    assert torch.equal(gen.get_state(), before)
    assert torch.equal(draws[0], draws[1])
    rate = draws[0].float().mean().item()
    assert abs(rate - p_flip) < 0.02      # 8192 draws: ~5 sigma
    other = port_cd.PBitMachine.create(
        g, 0, noise="philox", backend="sparse", device="cpu",
        faults=port_api.Faults(flip_prob=p_flip, flip_seed=6))
    assert not torch.equal(
        other.session(port_api.Constant(n_sweeps=1), chains=256
                      )._flip_fn(gen), draws[0])
    chip = ses.program_master(*_masters(g))
    m0 = ses.random_spins(ses.generator(1))
    runs = [ses.sample(chip, m0, ses.generator(2))[0] for _ in range(2)]
    assert torch.equal(*runs)


def test_auto_demotion_and_explicit_fused_raise():
    """auto + host-hook faults resolves to the half-sweep loop; stuck
    spins alone stay on the kernels."""
    g = make_chimera(1, 1)
    for faults, want in ((port_api.Faults(flip_prob=0.1), "sparse"),
                         (port_api.Faults(stuck_nodes=(2,),
                                          stuck_values=(1,)),
                          "fused_sparse")):
        mach = port_cd.PBitMachine.create(g, 0, noise="counter",
                                          device="cpu", faults=faults)
        assert mach.session().backend == want
        ref_mach = ref_cd.PBitMachine.create(
            g, jax.random.PRNGKey(0), noise="counter",
            faults=ref_api.Faults(**dataclasses.asdict(faults)))
        assert ref_mach.session().backend == want
    lfsr = port_cd.PBitMachine.create(
        g, 0, noise="lfsr", device="cpu",
        faults=port_api.Faults(lfsr_stuck=((0, 1, 0),)))
    assert lfsr.session().backend == "sparse"
    dense = port_cd.PBitMachine.create(
        g, 0, noise="counter", device="cpu",
        faults=port_api.Faults(flip_prob=0.1))
    spec = dense.sampler_spec(chains=4).replace(attach_sparse=False)
    assert port_api.resolve_backend(spec) == "ref"
    with pytest.raises(ValueError, match="fault hooks"):
        port_api.Session(spec.replace(backend="fused"))


def test_env_fused_backend_with_hooks_raises(monkeypatch):
    monkeypatch.setenv("REPRO_PBIT_BACKEND", "fused_sparse")
    g = make_chimera(1, 1)
    mach = port_cd.PBitMachine.create(g, 0, noise="counter", device="cpu",
                                      faults=port_api.Faults(flip_prob=0.1))
    with pytest.raises(ValueError, match="REPRO_PBIT_BACKEND"):
        mach.session()


def test_fingerprint_keys_the_faults():
    g = make_chimera(1, 1)
    mach = port_cd.PBitMachine.create(g, 0, noise="counter", device="cpu")
    spec = mach.sampler_spec(chains=8)
    stuck = port_api.Faults(stuck_nodes=(1,), stuck_values=(1,))
    assert spec.fingerprint()[-1] is None
    a = spec.replace(faults=stuck).fingerprint()
    assert a[-1] == repr(stuck)
    assert a == spec.replace(faults=port_api.Faults(
        stuck_nodes=(1,), stuck_values=(1,))).fingerprint()
    assert a != spec.fingerprint()
    assert a != spec.replace(faults=port_api.Faults(
        stuck_nodes=(1,), stuck_values=(-1,))).fingerprint()
    flips = spec.replace(faults=port_api.Faults(flip_prob=0.1)).fingerprint()
    assert "sparse" in flips and "fused_sparse" not in flips
    ref_mach = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(0),
                                         noise="counter")
    assert ref_mach.sampler_spec(chains=8).replace(
        faults=ref_api.Faults(stuck_nodes=(1,), stuck_values=(1,))
    ).fingerprint()[-1] == a[-1]


# -- CD under faults -------------------------------------------------------

def _cd(backend, faults, *, chains=CHAINS, data_seed=0, **cfg_kw):
    g = make_chimera(1, 1)
    task = ref_tasks.and_gate_task(g)
    _, ref, port = _machines(faults, "counter", backend, graph=(1, 1),
                             seed=1)
    cfg_kw = dict(dict(epochs=3, chains=chains, cd_k=3, pos_sweeps=3,
                       burn_in=1), **cfg_kw)
    ref_step = ref.session(chains=chains).make_cd_step(
        ref_cd.CDConfig(**cfg_kw), task.visible_idx)
    port_step = port.session(chains=chains).make_cd_step(
        port_cd.CDConfig(**cfg_kw), task.visible_idx)
    ref_ses = ref.session(chains=chains)
    st = ref_ses.init_state(jax.random.PRNGKey(2))
    data = np.sign(np.random.default_rng(data_seed).normal(
        size=(chains, len(task.visible_idx)))).astype(np.float32)
    rng = np.random.default_rng(4)
    tree = {"Jm": (rng.normal(size=g.n_edges) * 10).astype(np.float32),
            "hm": (rng.normal(size=g.n_nodes) * 5).astype(np.float32),
            "m": np.asarray(st.m), "noise_state": np.asarray(st.noise_state),
            "vel_J": np.zeros((g.n_edges,), np.float32),
            "vel_h": np.zeros((g.n_nodes,), np.float32)}
    return g, ref_step, port_step, tree, data


def _ref_epochs(step, tree, data, n):
    Jm, hm = jnp.asarray(tree["Jm"]), jnp.asarray(tree["hm"])
    m, ns = jnp.asarray(tree["m"]), jnp.asarray(tree["noise_state"])
    vel = (jnp.asarray(tree["vel_J"]), jnp.asarray(tree["vel_h"]))
    for _ in range(n):
        Jm, hm, m, ns, vel, metrics = step(Jm, hm, jnp.asarray(data), m, ns,
                                           vel)
    return Jm, hm, m, ns, vel, metrics


def _port_epochs(step, tree, data, n):
    s = convert.cd_state_from_numpy(tree, device="cpu")
    Jm, hm, m, ns, vel = s.Jm, s.hm, s.m, s.noise_state, (s.vel_J, s.vel_h)
    for _ in range(n):
        Jm, hm, m, ns, vel, metrics = step(Jm, hm, torch.as_tensor(data), m,
                                           ns, vel)
    return Jm, hm, m, ns, vel, metrics


@pytest.mark.parametrize("backend", ["ref", "sparse", "fused_sparse",
                                     "fused"])
def test_faulted_cd_step_equals_the_reference(backend):
    faults = _faults(stuck_nodes=(5,), stuck_values=(-1,), dead_edges=(3,),
                     saturated_edges=(9,))
    g, ref_step, port_step, tree, data = _cd(backend, faults,
                                             momentum=0.5)
    r = _ref_epochs(ref_step, tree, data, 3)
    p = _port_epochs(port_step, tree, data, 3)
    for got, want in zip(p[:3] + p[4], r[:3] + r[4]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_noise(p[3], r[3])
    assert float(p[5]["update_skipped"]) == 0.0
    for name in ("corr_err", "mean_err"):
        np.testing.assert_allclose(float(p[5][name]), float(r[5][name]),
                                   rtol=1e-6)
    # masked couplers never move from their start; the rest learn
    np.testing.assert_array_equal(p[0].numpy()[[3, 9]], tree["Jm"][[3, 9]])
    np.testing.assert_array_equal(p[4][0].numpy()[[3, 9]], 0.0)
    assert np.abs(p[0].numpy() - tree["Jm"]).sum() > 0
    assert (p[2][:, 5] == -1.0).all()


def test_nonfinite_gradient_skips_update():
    faults = _faults(stuck_nodes=(5,), stuck_values=(-1,), dead_edges=(3,),
                     saturated_edges=(9,))
    g, ref_step, port_step, tree, data = _cd("sparse", faults)
    bad = data.copy()
    bad[:, 0] = np.nan
    m_in = tree["m"].copy()
    m_in[:, 5] = -1.0          # the chains come back with the latch applied
    for step, run in ((ref_step, _ref_epochs), (port_step, _port_epochs)):
        Jm, hm, m, _, vel, metrics = run(step, tree, bad, 1)
        assert float(metrics["update_skipped"]) == 1.0
        np.testing.assert_array_equal(np.asarray(Jm), tree["Jm"])
        np.testing.assert_array_equal(np.asarray(hm), tree["hm"])
        np.testing.assert_array_equal(np.asarray(m), m_in)
        assert np.isfinite(np.asarray(vel[0])).all()


def test_nan_on_a_dead_edge_still_skips_the_update(monkeypatch):
    """The alive mask multiplies the gradient (NaN * 0 is NaN), as the
    reference's does, so a non-finite correlation on a dead coupler still
    trips the guard; a where-mask would hide it.  The NaN is injected into
    the positive phase's correlation of dead edge 3 alone."""
    faults = _faults(stuck_nodes=(), stuck_values=(), dead_edges=(3,),
                     saturated_edges=(9,))

    def poisoned(real, nan_at):
        def stats(*args, **kw):
            out = list(real(*args, **kw))
            if kw.get("clamp_values") is not None:   # the positive phase
                c = out[1]
                out[1] = (c.clone().index_fill_(0, torch.tensor([nan_at]),
                                                float("nan"))
                          if isinstance(c, torch.Tensor)
                          else c.at[nan_at].set(jnp.nan))
            return tuple(out)
        return stats

    monkeypatch.setattr(port_pbit, "gibbs_stats",
                        poisoned(port_pbit.gibbs_stats, 3))
    monkeypatch.setattr(ref_pbit, "gibbs_stats",
                        poisoned(ref_pbit.gibbs_stats, 3))
    g, ref_step, port_step, tree, data = _cd("sparse", faults)
    for step, run in ((ref_step, _ref_epochs), (port_step, _port_epochs)):
        Jm, hm, _, _, vel, metrics = run(step, tree, data, 1)
        assert float(metrics["update_skipped"]) == 1.0
        np.testing.assert_array_equal(np.asarray(Jm), tree["Jm"])
        np.testing.assert_array_equal(np.asarray(hm), tree["hm"])
    monkeypatch.undo()
    g, ref_step, port_step, tree, data = _cd("sparse", faults)
    _, _, _, _, _, metrics = _port_epochs(port_step, tree, data, 1)
    assert float(metrics["update_skipped"]) == 0.0


def test_fleet_cd_step_carries_the_faults():
    """The fleet CD step masks the same couplers and holds the same stuck
    spins, member by member equal to the single-chip step."""
    faults = _faults(stuck_nodes=(5,), stuck_values=(-1,), dead_edges=(3,),
                     saturated_edges=(9,))
    g, _, port = _machines(faults, "counter", "sparse", graph=(1, 1))
    task = ref_tasks.and_gate_task(g)
    cfg = port_cd.CDConfig(chains=CHAINS, cd_k=3, pos_sweeps=3, burn_in=1)
    ses = port.session(chains=CHAINS)
    mms = port.fleet_mismatch(0, 2)
    fleet = ses.make_cd_fleet_step(cfg, task.visible_idx)
    single = ses.make_cd_step(cfg, task.visible_idx).with_mismatch
    sts = [ses.init_state(ses.generator(k)) for k in range(2)]
    Jm = torch.ones((2, g.n_edges))
    hm = torch.zeros((2, g.n_nodes))
    data = torch.ones((CHAINS, len(task.visible_idx)))
    vel = (torch.zeros_like(Jm), torch.zeros_like(hm))
    out = fleet(mms, Jm, hm, data, torch.stack([s.m for s in sts]),
                torch.stack([s.noise_state for s in sts]), vel)
    from repro_torch.api.program import fleet_member
    for k in range(2):
        one = single(fleet_member(mms, k), Jm[k], hm[k], data, sts[k].m,
                     sts[k].noise_state, (vel[0][k], vel[1][k]))
        assert torch.equal(out[0][k], one[0])
        assert torch.equal(out[2][k], one[2])
    assert (out[0][:, [3, 9]] == 1.0).all()
    assert (out[2][:, :, 5] == -1.0).all()
