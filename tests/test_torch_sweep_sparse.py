"""Port vs reference: the sweep-resident sparse engine.

The reference kernel runs as its own tests run it on the CPU
(``sweep_sparse_pallas(interpret=True)``); the port's wrapper, given CPU
tensors, runs its plain version `sweep_sparse_ref`.  Both get the same
programmed chip, spins and noise state, carried across as numpy.

Integer streams are bit-exact, so the two sides see identical noise; the
float path differs only in `tanh`'s last place.  Step-locked half-sweeps
therefore hold the pre-comparator decision to 1e-6 and the spins wherever
|decision| > 1e-5; whole launches are equal in every output at the
seeds used here (no decision of these runs falls inside that margin).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hardware as ref_hw
from repro.core import pbit as ref_pbit
from repro.core.chimera import make_chimera
from repro.kernels import ref as ref_kernels
from repro.kernels.sweep_fused import sweep_sparse_pallas
from repro_torch import convert
from repro_torch.core import pbit as port_pbit
from repro_torch.kernels import ref as port_kernels
from repro_torch.kernels.sweep_fused import sweep_sparse, sweep_sparse_ref

from _torch_port import port_chip

S = 6
GRAPHS = {"2x2": dict(rows=2, cols=2),
          "masked": dict(rows=3, cols=3, masked_cells=[(1, 1)])}


class Problem:
    """One programmed chip + initial state, in both packages' types."""

    def __init__(self, graph_name, noise, B, seed, *, tempered=False,
                 clamp=False):
        g = make_chimera(**GRAPHS[graph_name])
        self.g, self.B, self.noise = g, B, noise
        n = g.n_nodes
        rng = np.random.default_rng(seed)
        cfg = ref_hw.HardwareConfig()
        nbr_idx, _ = g.neighbor_table()
        mism = ref_hw.sample_mismatch(jax.random.PRNGKey(seed), n, cfg)
        J = np.zeros((n, n), np.int32)
        vals = rng.integers(-100, 101, size=g.n_edges)
        J[g.edges[:, 0], g.edges[:, 1]] = vals
        J[g.edges[:, 1], g.edges[:, 0]] = vals
        h = rng.integers(-40, 41, size=n).astype(np.int32)
        chip = ref_hw.program_weights(
            jnp.asarray(J), jnp.asarray(h), jnp.asarray(np.abs(J) > 0), mism,
            cfg, adjacency=jnp.asarray(g.adjacency()),
            neighbors=jnp.asarray(nbr_idx))
        self.ref_chip = ref_hw.EffectiveChip(
            W=None, h=chip.h * 0.05, tanh_gain=chip.tanh_gain,
            tanh_offset=chip.tanh_offset, rand_gain=chip.rand_gain,
            comp_offset=chip.comp_offset, nbr_idx=chip.nbr_idx,
            nbr_w=chip.nbr_w * 0.05)
        self.port_chip = port_chip(self.ref_chip)

        self.m0 = (rng.integers(0, 2, size=(B, n)) * 2 - 1).astype(np.float32)
        if tempered:
            self.betas = rng.uniform(0.2, 1.8, (S, B)).astype(np.float32)
        else:
            self.betas = np.broadcast_to(
                np.linspace(0.3, 2.0, S, dtype=np.float32)[:, None],
                (S, B)).copy()
        self.clamp_mask = self.clamp_values = None
        mask0, mask1 = g.color == 0, g.color == 1
        if clamp:
            self.clamp_mask = np.zeros(n, bool)
            self.clamp_mask[rng.choice(n, 5, replace=False)] = True
            self.clamp_values = (rng.integers(0, 2, size=(B, n)) * 2
                                 - 1).astype(np.float32)
            mask0, mask1 = mask0 & ~self.clamp_mask, mask1 & ~self.clamp_mask
        self.masks = (mask0, mask1)
        if noise == "counter":
            self.ref_step = ref_pbit.make_counter_noise(B, n)[1]
            self.state = np.array(
                [rng.integers(0, 2 ** 32), 2 ** 32 - 5], np.uint32)
        else:
            self.ref_step = ref_pbit.make_lfsr_noise(g, B)[1]
            n_cells = n // 8
            self.state = rng.integers(
                1, 2 ** 32, size=(B, n_cells), dtype=np.uint64).astype(
                    np.uint32)
        spec = self.ref_step.spec
        self.kw = dict(noise_mode=spec.kind, decimation=spec.decimation,
                       gather_perm=spec.gather_perm)

    def ref_args(self, m=None, state=None):
        c = self.ref_chip
        opt = lambda a: None if a is None else jnp.asarray(a)
        return [jnp.asarray(self.m0 if m is None else m), c.nbr_idx, c.nbr_w,
                c.h, c.tanh_gain, c.tanh_offset, c.rand_gain, c.comp_offset,
                jnp.asarray(self.masks[0]), jnp.asarray(self.masks[1]),
                jnp.asarray(self.betas),
                jnp.asarray(self.state if state is None else state),
                opt(self.clamp_mask), opt(self.clamp_values)]

    def port_args(self, m=None, state=None):
        c = self.port_chip
        opt = lambda a: None if a is None else torch.from_numpy(a)
        return [convert.spins_from_numpy(self.m0 if m is None else m, "cpu"),
                c.nbr_idx, c.nbr_w, c.h, c.tanh_gain, c.tanh_offset,
                c.rand_gain, c.comp_offset,
                torch.from_numpy(self.masks[0]),
                torch.from_numpy(self.masks[1]),
                torch.from_numpy(self.betas),
                convert.noise_state_from_numpy(
                    self.state if state is None else state, "cpu"),
                opt(self.clamp_mask), opt(self.clamp_values)]


def _run_both(p, measured=None, visible=None, coord_offset=None, **win):
    kw = dict(p.kw, accumulate=measured is not None and visible is None,
              collect_hist=visible is not None,
              n_visible=0 if visible is None else len(visible), **win)
    j = lambda a, dt: None if a is None else jnp.asarray(a, dt)
    t = lambda a, dt: None if a is None else torch.as_tensor(
        np.asarray(a), dtype=dt)
    want = sweep_sparse_pallas(
        *p.ref_args(), j(measured, jnp.float32), j(visible, jnp.int32),
        j(coord_offset, jnp.uint32), interpret=True, **kw)
    got = sweep_sparse(
        *p.port_args(), t(measured, torch.float32), t(visible, torch.int32),
        coord_offset, **kw)
    return got, want


def _assert_equal(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(convert.noise_state_to_numpy(got[1]),
                                  np.asarray(want[1]))
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


BURN = (np.arange(S) >= 2).astype(np.float32)
CASES = {
    "plain": dict(),
    "clamped": dict(clamp=True),
    "tempered": dict(tempered=True),
    "moments": dict(measured=BURN),
    "moments_clamped": dict(measured=BURN, clamp=True),
    "hist": dict(measured=BURN, visible=[0, 5, 9]),
}


# every mode on the 2x2 graph at B=8; the masked graph with a ragged B=5
# for the modes whose bookkeeping depends on the tile's real chain count
LAUNCHES = [("2x2", 8, case) for case in CASES] + [
    ("masked", 5, case) for case in ("plain", "moments_clamped", "hist")]


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
@pytest.mark.parametrize("graph,B,case", LAUNCHES)
def test_whole_launch_equals_reference_kernel(graph, B, case, noise):
    opts = dict(CASES[case])
    run = {k: opts.pop(k) for k in ("measured", "visible") if k in opts}
    p = Problem(graph, noise, B, seed=11, **opts)
    got, want = _run_both(p, **run)
    _assert_equal(got, want)


def test_coord_offset_equals_reference_kernel():
    p = Problem("2x2", "counter", 8, seed=12)
    got, want = _run_both(p, coord_offset=(7, 2 ** 32 - 9))
    _assert_equal(got, want)
    plain = sweep_sparse(*p.port_args(), **p.kw)
    assert not torch.equal(plain[0], got[0])


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_split_windows_chain_to_the_whole_launch(noise):
    """Windows starting on an odd half, threaded noise state, per-window
    moment partials summing to the whole — against the reference's own
    windows and against the unsplit launch."""
    p = Problem("2x2", noise, 8, seed=13, clamp=True)
    kw = dict(p.kw, accumulate=True)
    meas_t, meas_j = torch.from_numpy(BURN), jnp.asarray(BURN)
    whole = sweep_sparse(*p.port_args(), meas_t, **kw)
    m, st = p.m0, p.state
    s_sum = c_sum = 0.0
    for h0, nh in ((0, 5), (5, 4), (9, 3)):
        want = sweep_sparse_pallas(*p.ref_args(m, st), meas_j,
                                   interpret=True, half_offset=h0, n_half=nh,
                                   **kw)
        got = sweep_sparse(*p.port_args(m, st), meas_t, half_offset=h0,
                           n_half=nh, **kw)
        _assert_equal(got, want)
        m, st = got[0].numpy(), convert.noise_state_to_numpy(got[1])
        s_sum, c_sum = s_sum + got[2], c_sum + got[3]
    np.testing.assert_array_equal(m, whole[0].numpy())
    np.testing.assert_array_equal(st, convert.noise_state_to_numpy(whole[1]))
    assert torch.equal(s_sum, whole[2]) and torch.equal(c_sum, whole[3])


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
@pytest.mark.parametrize("graph,B", [("2x2", 8), ("masked", 5)])
def test_step_locked_half_sweeps(graph, B, noise):
    """Each half-sweep from the reference's spins: decision within 1e-6,
    spins equal wherever |decision| > 1e-5."""
    p = Problem(graph, noise, B, seed=14, tempered=True)
    rc, pc = p.ref_chip, p.port_chip
    if noise == "counter":
        port_step = port_pbit.make_counter_noise(B, p.g.n_nodes,
                                                 device="cpu")[1]
    else:
        port_step = port_pbit.make_lfsr_noise(p.g, B, device="cpu")[1]
    m_ref = jnp.asarray(p.m0)
    st_ref = jnp.asarray(p.state)
    st_port = convert.noise_state_from_numpy(p.state, "cpu")
    checked = 0
    for s in range(S):
        for c in (0, 1):
            st_ref, u_ref = p.ref_step(st_ref)
            st_port, u_port = port_step(st_port)
            np.testing.assert_array_equal(np.asarray(u_ref), u_port.numpy())
            np.testing.assert_array_equal(
                np.asarray(st_ref), convert.noise_state_to_numpy(st_port))
            beta = p.betas[s]
            I_ref = ref_kernels.sparse_neuron_input(m_ref, rc.nbr_idx,
                                                    rc.nbr_w, rc.h)
            dec_ref = (jnp.tanh(jnp.asarray(beta)[:, None] * rc.tanh_gain
                                * (I_ref + rc.tanh_offset))
                       + rc.rand_gain * u_ref + rc.comp_offset)
            new_ref = ref_kernels.field_decision_update(
                m_ref, I_ref, rc.tanh_gain, rc.tanh_offset, rc.rand_gain,
                rc.comp_offset, jnp.asarray(p.masks[c]), jnp.asarray(beta),
                u_ref)
            m_in = convert.spins_from_numpy(np.asarray(m_ref), "cpu")
            I_port = port_kernels.sparse_neuron_input(m_in, pc.nbr_idx,
                                                      pc.nbr_w, pc.h)
            np.testing.assert_array_equal(np.asarray(I_ref), I_port.numpy())
            dec_port = port_kernels.decision_value(
                I_port, pc.tanh_gain, pc.tanh_offset, pc.rand_gain,
                pc.comp_offset, torch.from_numpy(beta), u_port)
            new_port = port_kernels.pbit_sparse_half_sweep_ref(
                m_in, pc.nbr_idx, pc.nbr_w, pc.h, pc.tanh_gain,
                pc.tanh_offset, pc.rand_gain, pc.comp_offset,
                torch.from_numpy(p.masks[c]), torch.from_numpy(beta), u_port)
            d = np.asarray(dec_ref)
            np.testing.assert_allclose(dec_port.numpy(), d, rtol=0, atol=1e-6)
            sure = np.abs(d) > 1e-5
            np.testing.assert_array_equal(new_port.numpy()[sure],
                                          np.asarray(new_ref)[sure])
            checked += int(sure.sum())
            m_ref = new_ref
    assert checked > 0.99 * 2 * S * B * p.g.n_nodes


def test_empty_window_is_the_identity():
    p = Problem("2x2", "counter", 8, seed=15)
    args = p.port_args()
    out = sweep_sparse(*args, torch.from_numpy(BURN), half_offset=4,
                       n_half=0, accumulate=True, **p.kw)
    assert torch.equal(out[0], args[0]) and torch.equal(out[1], args[11])
    assert float(out[2].abs().sum()) == 0.0 and out[3].shape == tuple(args[1].shape)
    empty = list(args)
    empty[10] = torch.zeros((0, 8))
    out = sweep_sparse(*empty, **p.kw)
    assert torch.equal(out[0], args[0]) and torch.equal(out[1], args[11])
    with pytest.raises(ValueError, match="window"):
        sweep_sparse(*args, half_offset=3, n_half=2 * S, **p.kw)


def test_wrapper_rejects_what_the_engine_does_not_take():
    p = Problem("2x2", "lfsr", 8, seed=16)
    args = p.port_args()
    with pytest.raises(ValueError, match="gather_perm"):
        sweep_sparse(*args, noise_mode="lfsr")
    with pytest.raises(ValueError, match="coord_offset"):
        sweep_sparse(*args, None, None, (1, 2), **p.kw)
    with pytest.raises(ValueError, match="noise_mode"):
        sweep_sparse(*args, noise_mode="philox")
    with pytest.raises(ValueError, match="visible"):
        sweep_sparse(*args, torch.from_numpy(BURN), torch.arange(13),
                     collect_hist=True, n_visible=13, **p.kw)
    assert sweep_sparse.launches == 0      # CPU tensors never launch
    assert sweep_sparse_ref is not sweep_sparse
