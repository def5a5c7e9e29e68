"""Port vs reference: the program as an operand, the fleet axis, and the
double-buffered program stream (K4).

Mirrors the single-device cases of ``tests/test_streaming.py``.  Each case
holds the port against itself (an `api.Program` is invisible to the
physics: `sample_program` equals `program_edges` + `sample`, a K-fleet
equals K sequential calls, a K4 chain equals serialized K1 launches) and
against the JAX package on the same inputs: the reference's mismatch
draws, spins and noise state cross into the port as numpy through
`repro_torch.convert`, its Pallas kernels run in interpret mode and the
port's wrappers (CPU tensors) run their plain versions.  Spins and noise
states are equal at these seeds; programmed chips agree to 1e-6 relative
(`tests/_torch_port.py`), and CD metrics, sums over edges in each
framework's order, to 1e-6.  Philox noise draws from a `torch.Generator`
in the port and agrees with the reference in distribution only (ROADMAP
Queue 3 item 5): its cases hold the port against itself alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import cd as ref_cd
from repro.core.chimera import make_chimera
from repro.kernels.sweep_fused import sweep_sparse_stream_pallas
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import cd as port_cd
from repro_torch.core import hardware as port_hw
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels.sweep_fused import (
    sweep_sparse,
    sweep_sparse_stream,
    sweep_sparse_stream_ref,
)

from _torch_port import leaves, port_chip, port_mismatch

BETAS5 = np.linspace(0.3, 1.5, 5, dtype=np.float32)
BETAS4 = np.linspace(0.3, 1.5, 4, dtype=np.float32)


def _codes(g, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-60, 60, g.n_edges).astype(np.int32),
            rng.integers(-15, 15, g.n_nodes).astype(np.int32))


def _port_machine(g, mismatch, noise, backend="auto"):
    return port_cd.PBitMachine(graph=g, hw=port_hw.HardwareConfig(),
                               mismatch=mismatch, noise=noise,
                               backend=backend, device="cpu")


def _pair(backend, noise, seed=0, rows=2, cols=2, chains=4):
    """The reference's and the port's Session on one mismatch draw."""
    g = make_chimera(rows, cols)
    sparse = backend in ("sparse", "fused_sparse")
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(seed),
                                    sparse=sparse, noise=noise,
                                    backend=backend)
    port = _port_machine(g, port_mismatch(ref.mismatch), noise, backend)
    ref_ses = ref_api.Session(ref.sampler_spec(chains=chains,
                                               interpret=True))
    return g, ref, port, ref_ses, port.session(chains=chains)


def _state(ref_ses, m_seed, ns_seed):
    """Spins and noise state drawn by the reference, and the port's copy
    (philox: a port generator of its own)."""
    m = ref_ses.random_spins(jax.random.PRNGKey(m_seed))
    ns = ref_ses.noise_state(jax.random.PRNGKey(ns_seed))
    p_m = convert.spins_from_numpy(np.asarray(m), "cpu")
    if ref_ses.spec.noise == "philox":
        return m, ns, p_m, None
    return m, ns, p_m, convert.noise_state_from_numpy(np.asarray(ns), "cpu")


def _port_ns(port_ses, ns, seed):
    """The port's noise state: the converted one, or a fresh generator."""
    return port_ses.generator(seed) if ns is None else ns


def _equal(port_t, ref_a):
    if port_t.dtype == torch.int32:          # noise-state bit patterns
        np.testing.assert_array_equal(convert.noise_state_to_numpy(port_t),
                                      np.asarray(ref_a))
    else:
        np.testing.assert_array_equal(port_t.numpy(), np.asarray(ref_a))


def _same(a, b):
    """Port against port: tensors equal, generators in the same state."""
    if isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    else:
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# operand == constant, per backend x noise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,noise", [
    ("ref", "philox"), ("ref", "counter"), ("ref", "lfsr"),
    ("sparse", "counter"), ("fused", "counter"),
    ("fused_sparse", "counter"),
])
def test_program_operand_matches_constant(backend, noise):
    """sample_program == program_edges + sample, bit for bit, for two
    programs on one Session; and == the reference's sample_program."""
    g, ref, port, ref_ses, ses = _pair(backend, noise)
    assert ses.backend == backend
    m0, ns0, p_m0, p_ns0 = _state(ref_ses, 2, 3)
    for seed in (1, 2):
        J, h = _codes(g, seed)
        m_c, ns_c, _ = ses.sample(ses.program_edges(J, h), p_m0,
                                  _port_ns(ses, p_ns0, 3), BETAS5)
        m_o, ns_o, _ = ses.sample_program(ses.make_program(J, h), p_m0,
                                          _port_ns(ses, p_ns0, 3), BETAS5)
        _same(m_o, m_c)
        _same(ns_o, ns_c)
        if noise == "philox":
            continue
        r_m, r_ns, _ = ref_ses.sample_program(
            ref_ses.make_program(jnp.asarray(J), jnp.asarray(h)), m0, ns0,
            jnp.asarray(BETAS5))
        _equal(m_o, r_m)
        _equal(ns_o, r_ns)


def test_program_collect_and_program_borne_betas():
    """collect=True trajectories match, a program-borne schedule is
    honoured and an explicit betas argument still wins — in the port and
    against the reference."""
    g, ref, port, ref_ses, ses = _pair("ref", "counter")
    J, h = _codes(g, 4)
    chip = ses.program_edges(J, h)
    m0, ns0, p_m0, p_ns0 = _state(ref_ses, 2, 3)
    betas = np.linspace(0.2, 1.2, 4, dtype=np.float32)
    a = ses.sample(chip, p_m0, p_ns0, betas, collect=True)
    prog = ses.make_program(J, h, betas=betas)
    b = ses.sample_program(prog, p_m0, p_ns0, collect=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    r = ref_ses.sample_program(
        ref_ses.make_program(jnp.asarray(J), jnp.asarray(h),
                             betas=jnp.asarray(betas)),
        m0, ns0, collect=True)
    for x, y in zip(b, r):
        _equal(x, y)
    override = np.linspace(0.5, 0.9, 4, dtype=np.float32)
    m_ov, _, _ = ses.sample_program(prog, p_m0, p_ns0, override)
    m_ex, _, _ = ses.sample(chip, p_m0, p_ns0, override)
    assert torch.equal(m_ov, m_ex)
    assert not torch.equal(m_ov, b[0])


def test_program_clamps_match_sample_clamps():
    """Clamps riding in the Program == clamps passed to sample, and the
    reference's clamped sample_program."""
    g, ref, port, ref_ses, ses = _pair("sparse", "counter")
    J, h = _codes(g, 5)
    B = 4
    m0, ns0, p_m0, p_ns0 = _state(ref_ses, 2, 3)
    cm = np.zeros(g.n_nodes, bool)
    cm[[0, 7, 13]] = True
    cv = -np.ones((B, g.n_nodes), np.float32)
    m_c, ns_c, _ = ses.sample(ses.program_edges(J, h), p_m0, p_ns0, BETAS5,
                              clamp_mask=torch.from_numpy(cm),
                              clamp_values=torch.from_numpy(cv))
    prog = ses.make_program(J, h, clamp_mask=cm, clamp_values=cv)
    m_o, ns_o, _ = ses.sample_program(prog, p_m0, p_ns0, BETAS5)
    assert torch.equal(m_o, m_c) and torch.equal(ns_o, ns_c)
    assert bool((m_o[:, [0, 7, 13]] == -1.0).all())
    r_m, r_ns, _ = ref_ses.sample_program(
        ref_ses.make_program(jnp.asarray(J), jnp.asarray(h),
                             clamp_mask=jnp.asarray(cm),
                             clamp_values=jnp.asarray(cv)),
        m0, ns0, jnp.asarray(BETAS5))
    _equal(m_o, r_m)
    _equal(ns_o, r_ns)


def test_program_mismatch_operand_matches_baked():
    """A mismatch draw streamed through the Program equals a machine with
    that draw in its spec, the two specs share a fingerprint, and the
    reference's sample_program with the same draw agrees."""
    g = make_chimera(2, 2)
    ref_a = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(0), sparse=True,
                                      noise="counter")
    ref_b = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(1), sparse=True,
                                      noise="counter")
    port_a = _port_machine(g, port_mismatch(ref_a.mismatch), "counter")
    port_b = _port_machine(g, port_mismatch(ref_b.mismatch), "counter")
    ses_a, ses_b = port_a.session(chains=4), port_b.session(chains=4)
    assert ses_a.spec.fingerprint() == ses_b.spec.fingerprint()
    ref_ses = ref_api.Session(ref_a.sampler_spec(chains=4, interpret=True))
    J, h = _codes(g, 6)
    m0, ns0, p_m0, p_ns0 = _state(ref_ses, 2, 3)
    m_baked, ns_baked, _ = ses_b.sample(ses_b.program_edges(J, h), p_m0,
                                        p_ns0, BETAS5)
    prog = ses_a.make_program(J, h, mismatch=port_b.mismatch)
    m_op, ns_op, _ = ses_a.sample_program(prog, p_m0, p_ns0, BETAS5)
    assert torch.equal(m_op, m_baked) and torch.equal(ns_op, ns_baked)
    r_m, r_ns, _ = ref_ses.sample_program(
        ref_ses.make_program(jnp.asarray(J), jnp.asarray(h),
                             mismatch=ref_b.mismatch),
        m0, ns0, jnp.asarray(BETAS5))
    _equal(m_op, r_m)
    _equal(ns_op, r_ns)


# ---------------------------------------------------------------------------
# the fleet axis: K stacked == K sequential, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend,noise", [
    ("sparse", "counter"), ("ref", "philox"), ("fused_sparse", "counter"),
])
def test_fleet_k8_matches_sequential(backend, noise):
    g, ref, port, ref_ses, ses = _pair(backend, noise)
    K = 8
    codes = [_codes(g, 10 + k) for k in range(K)]
    states = [_state(ref_ses, 20 + k, 40 + k) for k in range(K)]
    p_m0 = torch.stack([s[2] for s in states])
    fresh = lambda: (  # noqa: E731
        [ses.generator(40 + k) for k in range(K)] if noise == "philox"
        else torch.stack([s[3] for s in states]))
    progs = [ses.make_program(*c) for c in codes]
    m_f, ns_f, none = ses.sample_fleet(port_api.stack_programs(progs), p_m0,
                                       fresh(), BETAS4)
    assert none is None and m_f.shape == (K, 4, g.n_nodes)
    seq_ns = fresh()
    for k in range(K):
        m_k, ns_k, _ = ses.sample_program(progs[k], p_m0[k], seq_ns[k],
                                          BETAS4)
        _same(m_f[k], m_k)
        _same(ns_f[k], ns_k)
    if noise == "philox":
        return
    r_progs = ref_api.stack_programs([
        ref_ses.make_program(jnp.asarray(J), jnp.asarray(h))
        for J, h in codes])
    r_m, r_ns, _ = ref_ses.sample_fleet(
        r_progs, jnp.stack([s[0] for s in states]),
        jnp.stack([s[1] for s in states]), jnp.asarray(BETAS4))
    _equal(m_f, r_m)
    _equal(ns_f, r_ns)


def test_fleet_mismatch_axis_matches_standalone_machines():
    """fleet_mismatch draw k == the k-th consecutive draw of one generator;
    a K-chip fleet of one shared program equals per-machine sampling; the
    reference's stacked draw crosses into the port member by member, and
    the fleet through it equals the reference's fleet."""
    g = make_chimera(2, 2)
    K = 3
    port = port_cd.PBitMachine.create(g, 0, sparse=True, noise="counter",
                                      device="cpu")
    D = g.neighbor_table()[0].shape[0]
    draws = port.fleet_mismatch(7, K)
    assert isinstance(draws, port_hw.SparseMismatch)
    assert draws.edge_gain.shape == (K, D, g.n_nodes)
    gen = torch.Generator().manual_seed(7)
    for k in range(K):
        one = port_hw.sample_mismatch_sparse(gen, g.n_nodes, D,
                                             port_hw.HardwareConfig(),
                                             device="cpu")
        member = port_api.fleet_member(draws, k)
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(member, f.name), getattr(one, f.name))
    dense = port_cd.PBitMachine.create(g, 0, noise="counter", device="cpu")
    assert dense.fleet_mismatch(1, 2).edge_gain.shape == (2, g.n_nodes,
                                                          g.n_nodes)

    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(0), sparse=True,
                                    noise="counter")
    ref_ses = ref_api.Session(ref.sampler_spec(chains=4, interpret=True))
    r_draws = ref.fleet_mismatch(jax.random.PRNGKey(7), K)
    p_draws = convert.mismatch_from_numpy(leaves(r_draws), "cpu")
    ses = _port_machine(g, port_mismatch(ref.mismatch), "counter"
                        ).session(chains=4)
    J, h = _codes(g, 8)
    m0, ns0, p_m0, p_ns0 = _state(ref_ses, 2, 3)
    progs = port_api.stack_programs([
        ses.make_program(J, h, mismatch=port_api.fleet_member(p_draws, k))
        for k in range(K)])
    m_f, ns_f, _ = ses.sample_fleet(progs, torch.stack([p_m0] * K),
                                    torch.stack([p_ns0] * K), BETAS4)
    for k in range(K):
        member = port_api.fleet_member(p_draws, k)
        single = port_mismatch(jax.tree_util.tree_map(lambda x: x[k],
                                                      r_draws))
        for f in dataclasses.fields(single):
            assert torch.equal(getattr(member, f.name),
                               getattr(single, f.name))
        sk = _port_machine(g, member, "counter").session(chains=4)
        m_k, _, _ = sk.sample(sk.program_edges(J, h), p_m0, p_ns0, BETAS4)
        assert torch.equal(m_f[k], m_k)
    r_progs = ref_api.stack_programs([
        ref_ses.make_program(jnp.asarray(J), jnp.asarray(h),
                             mismatch=jax.tree_util.tree_map(
                                 lambda x: x[k], r_draws))
        for k in range(K)])
    r_m, r_ns, _ = ref_ses.sample_fleet(r_progs, jnp.stack([m0] * K),
                                        jnp.stack([ns0] * K),
                                        jnp.asarray(BETAS4))
    _equal(m_f, r_m)
    _equal(ns_f, r_ns)


def test_fleet_cd_matches_sequential():
    """K=2 hardware-aware CD fleet == two sequential per-chip epochs, and
    == the reference's fleet step on the same draws and state."""
    g = make_chimera(1, 2)
    ref = ref_cd.PBitMachine.create(g, jax.random.PRNGKey(0), sparse=True,
                                    noise="counter")
    port = _port_machine(g, port_mismatch(ref.mismatch), "counter")
    kw = dict(chains=4, cd_k=2, pos_sweeps=2, burn_in=1, momentum=0.5)
    cfg = port_cd.CDConfig(**kw)
    vis = np.arange(6)
    K = 2
    r_mms = ref.fleet_mismatch(jax.random.PRNGKey(5), K)
    mms = convert.mismatch_from_numpy(leaves(r_mms), "cpu")
    rng = np.random.default_rng(0)
    Jm = (rng.normal(size=(K, g.n_edges)) * 8).astype(np.float32)
    hm = (rng.normal(size=(K, g.n_nodes)) * 2).astype(np.float32)
    data = (rng.integers(0, 2, (cfg.chains, len(vis))) * 2 - 1).astype(
        np.float32)
    ref_ses = ref.session(chains=cfg.chains)
    states = [_state(ref_ses, 30 + k, 50 + k) for k in range(K)]
    m0 = torch.stack([s[2] for s in states])
    ns0 = torch.stack([s[3] for s in states])
    vel = (torch.zeros((K, g.n_edges)), torch.zeros((K, g.n_nodes)))
    fleet = port_cd.make_cd_fleet_step(port, cfg, vis)
    out_f = fleet(mms, torch.from_numpy(Jm), torch.from_numpy(hm),
                  torch.from_numpy(data), m0, ns0, vel)
    step = port.session(chains=cfg.chains).make_cd_step(cfg, vis)
    for k in range(K):
        out_k = step.with_mismatch(
            port_api.fleet_member(mms, k), torch.from_numpy(Jm[k]),
            torch.from_numpy(hm[k]), torch.from_numpy(data), m0[k], ns0[k],
            (vel[0][k], vel[1][k]))
        for i in range(4):
            assert torch.equal(out_f[i][k], out_k[i])
        for a, b in zip(out_f[4], out_k[4]):
            assert torch.equal(a[k], b)
        for name, v in out_k[5].items():
            assert torch.equal(out_f[5][name][k], v)
    r_out = ref_cd.make_cd_fleet_step(ref, ref_cd.CDConfig(**kw), vis)(
        r_mms, jnp.asarray(Jm), jnp.asarray(hm), jnp.asarray(data),
        jnp.stack([s[0] for s in states]), jnp.stack([s[1] for s in states]),
        (jnp.zeros((K, g.n_edges)), jnp.zeros((K, g.n_nodes))))
    for i in range(4):
        _equal(out_f[i], r_out[i])
    for a, b in zip(out_f[4], r_out[4]):
        _equal(a, b)
    for name, v in r_out[5].items():
        np.testing.assert_allclose(out_f[5][name].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7)
    assert np.abs(out_f[0].numpy() - Jm).max() > 0   # it learned


# ---------------------------------------------------------------------------
# the double-buffered program stream (K4's plain version)
# ---------------------------------------------------------------------------
def test_stream_kernel_chain_matches_serialized():
    """A 4-program chain through `sweep_sparse_stream` (each launch runs
    program i while staging program i+1) equals four serialized
    `sweep_sparse` launches, every staged output is exactly the next
    program, and each launch equals the reference's
    `sweep_sparse_stream_pallas` on the same operands."""
    g, ref, port, ref_ses, ses = _pair("fused_sparse", "counter", chains=6)
    r_chips = [ref_ses.program_edges(*map(jnp.asarray, _codes(g, 60 + i)))
               for i in range(4)]
    chips = [port_chip(c) for c in r_chips]
    c0 = chips[0]
    masks = (torch.from_numpy(g.color == 0), torch.from_numpy(g.color == 1))
    r_masks = (jnp.asarray(g.color == 0), jnp.asarray(g.color == 1))
    m0 = ref_ses.random_spins(jax.random.PRNGKey(2))
    ramp = np.linspace(0.3, 1.5, 3, dtype=np.float32)
    betas = np.broadcast_to(ramp[:, None], (3, 6)).copy()
    ns0 = np.asarray([42, 2 ** 32 - 2], np.uint32)   # wraps inside the chain
    p_m0 = convert.spins_from_numpy(np.asarray(m0), "cpu")
    p_ns0 = convert.noise_state_from_numpy(ns0, "cpu")

    def rest(chip):
        return (chip.tanh_gain, chip.tanh_offset, chip.rand_gain,
                chip.comp_offset, *masks, torch.from_numpy(betas))

    m_s, ns_s = p_m0, p_ns0
    for chip in chips:
        m_s, ns_s = sweep_sparse(m_s, c0.nbr_idx, chip.nbr_w, chip.h,
                                 *rest(chip), ns_s)

    m_d, ns_d = p_m0, p_ns0
    r_m, r_ns = m0, jnp.asarray(ns0)
    w, h = chips[0].nbr_w, chips[0].h
    for i, chip in enumerate(chips):
        nxt = chips[(i + 1) % 4]
        m_d, ns_d, w_next, h_next = sweep_sparse_stream(
            m_d, c0.nbr_idx, w, h, *rest(chip), ns_d, nxt.nbr_w.clone(),
            nxt.h.clone())
        assert torch.equal(w_next, nxt.nbr_w) and torch.equal(h_next, nxt.h)
        rc, rn = r_chips[i], r_chips[(i + 1) % 4]
        r_m, r_ns, r_w, r_h = sweep_sparse_stream_pallas(
            r_m, rc.nbr_idx, rc.nbr_w, rc.h, rc.tanh_gain, rc.tanh_offset,
            rc.rand_gain, rc.comp_offset, *r_masks, jnp.asarray(betas),
            r_ns, rn.nbr_w, rn.h, block_b=8, interpret=True)
        _equal(m_d, r_m)
        _equal(ns_d, r_ns)
        np.testing.assert_array_equal(np.asarray(r_w), nxt.nbr_w.numpy())
        np.testing.assert_array_equal(np.asarray(r_h), nxt.h.numpy())
        w, h = w_next, h_next
    assert torch.equal(m_d, m_s) and torch.equal(ns_d, ns_s)
    # 4 launches x 3 sweeps x 2 halves past 2^32 - 2, modulo 2^32
    assert convert.noise_state_to_numpy(ns_d)[1] == 22


def test_stream_window_clamps_coords_and_ring():
    """K4 with clamps, a coord offset and a half-sweep window equals K1 on
    the current program; the chip-view wrapper `ops.stream_sweeps` runs a
    chain over a two-slot ring and equals `fused_sweeps` per launch."""
    g, ref, port, ref_ses, ses = _pair("fused_sparse", "counter", chains=5)
    chip, nxt = (ses.program_edges(*_codes(g, s)) for s in (70, 71))
    st = ses.init_state(ses.generator(3))
    rng = np.random.default_rng(4)
    cm = torch.from_numpy(rng.random(g.n_nodes) < 0.2)
    cv = torch.from_numpy((rng.integers(0, 2, (5, g.n_nodes)) * 2 - 1)
                          .astype(np.float32))
    mask0 = torch.from_numpy(g.color == 0) & ~cm
    mask1 = torch.from_numpy(g.color == 1) & ~cm
    betas = torch.from_numpy(rng.uniform(0.2, 1.8, (4, 5)).astype(np.float32))
    args = (st.m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
            chip.tanh_offset, chip.rand_gain, chip.comp_offset, mask0, mask1,
            betas, st.noise_state)
    for window in (dict(), dict(half_offset=3, n_half=4)):
        want = sweep_sparse(*args, cm, cv, None, None, (1000, 77), **window)
        got = sweep_sparse_stream(*args, nxt.nbr_w, nxt.h, cm, cv,
                                  (1000, 77), **window)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2], nxt.nbr_w) and torch.equal(got[3], nxt.h)

    programs = [ses.program_edges(*_codes(g, 80 + i)) for i in range(4)]
    color = torch.from_numpy(g.color)
    spec = ses._noise_step.spec
    ring = [(programs[0].nbr_w.clone(), programs[0].h.clone()),
            (torch.empty_like(chip.nbr_w), torch.empty_like(chip.h))]
    m_d, ns_d = st.m, st.noise_state
    m_s, ns_s = st.m, st.noise_state
    for i, prog in enumerate(programs):
        cur = dataclasses.replace(prog, nbr_w=ring[i % 2][0],
                                  h=ring[i % 2][1])
        nxt = programs[(i + 1) % 4]
        m_d, ns_d, _, _ = port_ops.stream_sweeps(
            m_d, cur, color, betas, ns_d, spec, nxt.nbr_w, nxt.h,
            staged=ring[(i + 1) % 2])
        m_s, ns_s = port_ops.fused_sweeps(m_s, prog, color, betas, ns_s,
                                          spec, sparse=True)
        assert torch.equal(m_d, m_s) and torch.equal(ns_d, ns_s)
        assert torch.equal(ring[(i + 1) % 2][0], nxt.nbr_w)


def test_stream_refusals():
    """LFSR noise, moments, the histogram, a shared storage between the
    current, next and staged programs: refused with the reference's
    messages (and the port's own for aliasing)."""
    g, ref, port, ref_ses, ses = _pair("fused_sparse", "counter")
    chip, nxt = (ses.program_edges(*_codes(g, s)) for s in (1, 2))
    st = ses.init_state(ses.generator(0))
    args = (st.m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
            chip.tanh_offset, chip.rand_gain, chip.comp_offset,
            torch.from_numpy(g.color == 0), torch.from_numpy(g.color == 1),
            torch.ones((2, 4)), st.noise_state)
    with pytest.raises(ValueError, match="counter-noise"):
        sweep_sparse_stream(*args, nxt.nbr_w, nxt.h, noise_mode="lfsr")
    with pytest.raises(ValueError, match="accumulation"):
        sweep_sparse_stream(*args, nxt.nbr_w, nxt.h,
                            measured=torch.ones(2), accumulate=True)
    with pytest.raises(ValueError, match="accumulation"):
        sweep_sparse_stream_ref(*args, nxt.nbr_w, nxt.h, collect_hist=True)
    with pytest.raises(ValueError, match="next_h"):
        sweep_sparse_stream(*args, nxt.nbr_w, None)
    with pytest.raises(ValueError, match="storage"):
        sweep_sparse_stream(*args, chip.nbr_w, nxt.h)
    with pytest.raises(ValueError, match="storage"):
        sweep_sparse_stream(*args, nxt.nbr_w, nxt.h,
                            staged=(chip.nbr_w, torch.empty_like(nxt.h)))
    with pytest.raises(ValueError, match="storage"):
        sweep_sparse_stream(*args, nxt.nbr_w, nxt.h,
                            staged=(torch.empty_like(nxt.nbr_w), nxt.h))


# ---------------------------------------------------------------------------
# construction / fingerprint contracts
# ---------------------------------------------------------------------------
def test_make_program_validation():
    g, ref, port, ref_ses, ses = _pair("sparse", "counter")
    J, h = _codes(g, 9)
    with pytest.raises(ValueError, match="edge-list"):
        ses.make_program(np.zeros(g.n_nodes, np.int32), h)
    with pytest.raises(ValueError, match="h_codes"):
        ses.make_program(J, np.zeros(g.n_edges, np.int32))
    with pytest.raises(ValueError, match="clamp_values"):
        ses.make_program(J, h, clamp_values=np.zeros((4, g.n_nodes)))
    dense = port_cd.PBitMachine.create(g, 0, device="cpu")
    with pytest.raises(ValueError, match="mismatch type"):
        ses.make_program(J, h, mismatch=dense.mismatch)
    # the reference raises on the same inputs
    with pytest.raises(ValueError, match="edge-list"):
        ref_ses.make_program(jnp.zeros((g.n_nodes,), jnp.int32), h)
    prog = ses.make_program(J, h, clamp_mask=[True] + [False] * 31,
                            betas=BETAS4)
    assert prog.clamp_mask.dtype == torch.bool
    assert prog.betas.dtype == torch.float32 and prog.clamp_values is None
    with pytest.raises(ValueError, match="schedule"):
        ses.sample_program(ses.make_program(J, h), *ses.init_state(
            ses.generator(0)))


def test_stack_programs_requires_same_structure():
    g, ref, port, ref_ses, ses = _pair("sparse", "counter")
    J, h = _codes(g, 9)
    a = ses.make_program(J, h)
    b = ses.make_program(J, h, betas=BETAS4)
    with pytest.raises(ValueError, match="structure"):
        port_api.stack_programs([a, b])
    with pytest.raises(ValueError, match="at least one"):
        port_api.stack_programs([])
    c = ses.make_program(J, h, mismatch=port.mismatch)
    with pytest.raises(ValueError, match="structure"):
        port_api.stack_programs([a, c])
    both = port_api.stack_programs([c, c])
    assert both.J_codes.shape == (2, g.n_edges)
    assert both.mismatch.edge_gain.shape == (2, *port.mismatch.edge_gain.shape)
    assert both.clamp_mask is None
    # a reference Program crosses into the port field by field
    r = ref_ses.make_program(jnp.asarray(J), jnp.asarray(h),
                             betas=jnp.asarray(BETAS4),
                             mismatch=ref.mismatch)
    crossed = convert.program_from_numpy(
        {"J_codes": r.J_codes, "h_codes": r.h_codes, "betas": r.betas,
         "mismatch": leaves(r.mismatch)}, "cpu")
    assert torch.equal(crossed.J_codes, torch.from_numpy(J))
    assert torch.equal(crossed.betas, torch.from_numpy(BETAS4))
    assert torch.equal(crossed.mismatch.edge_gain, port.mismatch.edge_gain)
    assert crossed.clamp_mask is None


def test_fingerprint_is_shape_bucket_key():
    """The fingerprint ignores mismatch values (two chip instances share a
    key) but keys on mismatch structure, graph shape, device and the
    resolved backend — `auto` and the name it resolves to share one."""
    g = make_chimera(2, 2)
    mk = lambda seed, **kw: port_cd.PBitMachine.create(  # noqa: E731
        g, seed, noise="counter", device="cpu", **kw).sampler_spec(chains=4)
    a, b = mk(0, sparse=True), mk(1, sparse=True)
    assert a.fingerprint() == b.fingerprint()
    assert hash(a.fingerprint()) == hash(b.fingerprint())
    assert a.fingerprint() == a.replace(backend="fused_sparse").fingerprint()
    assert a.fingerprint() != a.replace(backend="sparse").fingerprint()
    assert a.fingerprint() != mk(0).fingerprint()          # dense mismatch
    assert a.fingerprint() != a.replace(chains=8).fingerprint()
    assert a.fingerprint() != a.replace(device="cuda").fingerprint()
    other = port_cd.PBitMachine.create(make_chimera(1, 2), 0, sparse=True,
                                       noise="counter", device="cpu"
                                       ).sampler_spec(chains=4)
    assert a.fingerprint() != other.fingerprint()
    sched = a.replace(schedule=port_api.Anneal(0.1, 2.0, n_sweeps=5))
    assert sched.fingerprint() != a.fingerprint()
    assert sched.fingerprint() == b.replace(
        schedule=port_api.Anneal(0.1, 2.0, n_sweeps=5)).fingerprint()
