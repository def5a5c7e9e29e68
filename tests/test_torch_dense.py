"""Port vs reference: the dense backends (`ref`, `pallas`, `fused`).

The reference's Pallas kernels run as its own tests run them on the CPU
(``pbit_half_sweep_pallas`` / ``sweep_fused_pallas`` with
``interpret=True``, N <= 64); the port's wrappers, given CPU tensors, run
their plain versions.  Couplings are dyadic (multiples of 2^-8), so every
partial sum of eqn 1 is exact in float32 in any order: the reference's
``m @ W.T`` and the port's ascending row reduction give the same input, and
the float path differs only in `tanh`'s last place.  Step-locked
half-sweeps therefore hold the decision to 1e-6 and the spins wherever
|decision| > 1e-5 (ROADMAP Queue 3 item 3); whole launches are equal in
every output at the seeds used here.

Inside the port the five backends are bit-exact siblings on a programmed
Chimera chip, and the dense resident engine's limits on Hopper are a model
(`dense_resident_feasible`) tested at its boundary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chimera import make_chimera
from repro.kernels.pbit_update import pbit_half_sweep_pallas
from repro.kernels.sweep_fused import sweep_fused_pallas
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import cd as port_cd
from repro_torch.core import hardware as port_hw
from repro_torch.core import lfsr as port_lfsr
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import sweep_fused as port_sf
from repro_torch.kernels.pbit_update import pbit_half_sweep
from repro_torch.kernels.sweep_fused import sweep_fused, sweep_fused_ref

S = 6
GRAPHS = {"2x2": dict(rows=2, cols=2),
          "masked": dict(rows=3, cols=3, masked_cells=[(1, 1)]),
          "cell": dict(rows=1, cols=1)}


def _dyadic(rng, shape, scale=64):
    """Random float32 multiples of 2^-8 in [-scale/256, scale/256]."""
    return (rng.integers(-scale, scale + 1, size=shape) / 256.0).astype(
        np.float32)


class DenseProblem:
    """A dense chip (Chimera couplings, or W coupling nodes of one colour
    too) + spins, betas, masks and noise state, as numpy."""

    def __init__(self, graph, noise, B, seed, *, intra=False,
                 tempered=False, clamp=False):
        g = make_chimera(**GRAPHS[graph])
        n = g.n_nodes
        rng = np.random.default_rng(seed)
        self.g, self.B, self.noise = g, B, noise
        if intra:
            W = _dyadic(rng, (n, n), 16)
        else:
            W = np.zeros((n, n), np.float32)
            W[g.edges[:, 0], g.edges[:, 1]] = _dyadic(rng, g.n_edges)
            W[g.edges[:, 1], g.edges[:, 0]] = _dyadic(rng, g.n_edges)
        np.fill_diagonal(W, 0.0)
        self.W = W
        self.rows = [_dyadic(rng, n, 32),                       # h
                     (1.0 + 0.1 * rng.normal(size=n)).astype(np.float32),
                     (0.05 * rng.normal(size=n)).astype(np.float32),
                     (1.0 + 0.05 * rng.normal(size=n)).astype(np.float32),
                     (0.02 * rng.normal(size=n)).astype(np.float32)]
        self.m0 = (rng.integers(0, 2, size=(B, n)) * 2 - 1).astype(np.float32)
        if tempered:
            self.betas = rng.uniform(0.2, 1.8, (S, B)).astype(np.float32)
        else:
            self.betas = np.broadcast_to(
                np.linspace(0.3, 2.0, S, dtype=np.float32)[:, None],
                (S, B)).copy()
        mask0, mask1 = g.color == 0, g.color == 1
        self.clamp_mask = self.clamp_values = None
        if clamp:
            self.clamp_mask = np.zeros(n, bool)
            self.clamp_mask[rng.choice(n, 3, replace=False)] = True
            self.clamp_values = (rng.integers(0, 2, size=(B, n)) * 2
                                 - 1).astype(np.float32)
            mask0, mask1 = mask0 & ~self.clamp_mask, mask1 & ~self.clamp_mask
        self.masks = (mask0, mask1)
        if noise == "counter":
            self.state = np.array([rng.integers(0, 2 ** 32), 2 ** 32 - 3],
                                  np.uint32)
            self.kw = dict(noise_mode="counter")
        else:
            from repro.core import pbit as ref_pbit
            spec = ref_pbit.make_lfsr_noise(g, B)[1].spec
            self.state = rng.integers(1, 2 ** 32, size=(B, n // 8),
                                      dtype=np.uint64).astype(np.uint32)
            self.kw = dict(noise_mode="lfsr", decimation=spec.decimation,
                           gather_perm=spec.gather_perm)

    def ref_args(self):
        opt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
        return [jnp.asarray(self.m0), jnp.asarray(self.W),
                *(jnp.asarray(r) for r in self.rows),
                jnp.asarray(self.masks[0]), jnp.asarray(self.masks[1]),
                jnp.asarray(self.betas), jnp.asarray(self.state),
                opt(self.clamp_mask), opt(self.clamp_values)]

    def port_args(self):
        opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa
        return [torch.from_numpy(self.m0), torch.from_numpy(self.W),
                *(torch.from_numpy(r) for r in self.rows),
                torch.from_numpy(self.masks[0]),
                torch.from_numpy(self.masks[1]),
                torch.from_numpy(self.betas),
                convert.noise_state_from_numpy(self.state, "cpu"),
                opt(self.clamp_mask), opt(self.clamp_values)]


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
    "hist_nv3": dict(measured=BURN, visible=[0, 5, 9]),
    "hist_nv12": dict(measured=BURN, visible=list(range(0, 24, 2))),
    "intra_colour": dict(intra=True, measured=BURN),
}
LAUNCHES = [("2x2", 8, case) for case in CASES] + [
    ("masked", 5, "moments_clamped"), ("masked", 5, "hist_nv3"),
    ("cell", 8, "moments")]


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
@pytest.mark.parametrize("graph,B,case", LAUNCHES)
def test_whole_launch_equals_reference_kernel(graph, B, case, noise):
    opts = dict(CASES[case])
    measured, visible = opts.pop("measured", None), opts.pop("visible", None)
    p = DenseProblem(graph, noise, B, seed=21, **opts)
    kw = dict(p.kw, accumulate=measured is not None and visible is None,
              collect_hist=visible is not None,
              n_visible=0 if visible is None else len(visible))
    j = lambda a, dt: None if a is None else jnp.asarray(a, dt)  # noqa
    t = lambda a, dt: None if a is None else torch.as_tensor(  # noqa
        np.asarray(a), dtype=dt)
    want = sweep_fused_pallas(*p.ref_args(), j(measured, jnp.float32),
                              j(visible, jnp.int32), block_b=8,
                              interpret=True, **kw)
    got = sweep_fused(*p.port_args(), t(measured, torch.float32),
                      t(visible, torch.int32), **kw)
    _assert_equal(got, want)
    if kw["accumulate"]:
        assert got[3].shape == (p.g.n_nodes, p.g.n_nodes)   # the Gram matrix


def test_coord_offset_equals_reference_kernel():
    p = DenseProblem("2x2", "counter", 8, seed=22)
    want = sweep_fused_pallas(*p.ref_args(), None, None,
                              jnp.asarray([5, 2 ** 32 - 7], jnp.uint32),
                              block_b=8, interpret=True, **p.kw)
    got = sweep_fused(*p.port_args(), None, None, (5, 2 ** 32 - 7), **p.kw)
    _assert_equal(got, want)
    plain = sweep_fused(*p.port_args(), **p.kw)
    assert not torch.equal(plain[0], got[0])


@pytest.mark.parametrize("beta", ["scalar", "per_chain"])
@pytest.mark.parametrize("graph,B,intra", [("2x2", 8, False),
                                           ("masked", 5, False),
                                           ("2x2", 7, True)])
def test_half_sweep_matches_reference_kernel(graph, B, intra, beta):
    """K2's plain version against `pbit_half_sweep_pallas`: decision within
    1e-6, spins equal wherever |decision| > 1e-5; the masks are a colour
    class and a random subset."""
    p = DenseProblem(graph, "counter", B, seed=23, intra=intra)
    rng = np.random.default_rng(24)
    n = p.g.n_nodes
    u = ((rng.integers(0, 256, (B, n)) - 127.5) / 128.0).astype(np.float32)
    b = (np.float32(0.9) if beta == "scalar"
         else rng.uniform(0.3, 1.8, B).astype(np.float32))
    h, g_, o, rg, co = p.rows
    for mask in (p.masks[1], rng.integers(0, 2, n).astype(bool)):
        want = pbit_half_sweep_pallas(
            jnp.asarray(p.m0), jnp.asarray(p.W), *map(jnp.asarray, p.rows),
            jnp.asarray(mask), jnp.asarray(b), jnp.asarray(u), block_b=8,
            block_n=128, block_k=128, interpret=True)
        I = p.m0 @ p.W.T + h       # exact: dyadic couplings, ±1 spins
        bb = np.asarray(b).reshape(-1, 1)
        d_ref = np.tanh(bb * g_ * (I + o)) + rg * u + co
        tm = torch.from_numpy
        I_port = port_ref.dense_neuron_input(tm(p.m0), tm(p.W), tm(h))
        np.testing.assert_array_equal(I_port.numpy(), I)
        d_port = port_ref.decision_value(I_port, tm(g_), tm(o), tm(rg),
                                         tm(co), torch.as_tensor(b), tm(u))
        np.testing.assert_allclose(d_port.numpy(), d_ref, rtol=0, atol=1e-6)
        got = pbit_half_sweep(tm(p.m0), tm(p.W), *map(tm, p.rows),
                              tm(mask), torch.as_tensor(b), tm(u))
        sure = np.abs(d_ref) > 1e-5
        assert sure.mean() > 0.99
        np.testing.assert_array_equal(got.numpy()[sure],
                                      np.asarray(want)[sure])
        np.testing.assert_array_equal(got.numpy()[:, ~mask], p.m0[:, ~mask])


def test_intra_colour_update_is_synchronous():
    """A W that couples nodes of one colour: the engine computes every
    input from the spins before the half-sweep (not in place), exactly a
    loop of plain half-sweeps."""
    p = DenseProblem("2x2", "counter", 6, seed=25, intra=True)
    args = p.port_args()
    m, W, rows = args[0], args[1], args[2:7]
    n = p.g.n_nodes
    got = sweep_fused(*args, **p.kw)
    seed, ctr = args[10][0], port_lfsr.to_u64(args[10][1])
    r, c = torch.arange(6)[:, None], torch.arange(n)[None, :]
    for half in range(2 * S):
        u = port_lfsr.counter_uniform(seed, ctr + half, r, c)
        m = port_ref.pbit_half_sweep_ref(m, W, *rows, args[7 + half % 2],
                                         args[9][half // 2], u)
    assert torch.equal(got[0], m)
    # an in-place (sequential) sweep of the same colour differs
    same = torch.from_numpy(p.masks[0])
    assert (W[same][:, same] != 0).any()


def _port_machine(graph, noise, backend, seed=0):
    g = make_chimera(**GRAPHS[graph])
    return g, port_cd.PBitMachine.create(g, seed, noise=noise,
                                         backend=backend, device="cpu")


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_five_backends_are_bit_exact_siblings(noise):
    """`ref`/`pallas`/`fused` == `sparse`/`fused_sparse` on one programmed
    Chimera chip: sample, stats (Gram read-out vs slot read-out) and the
    visible histogram."""
    outs = {}
    for backend in ("ref", "pallas", "fused", "sparse", "fused_sparse"):
        g, mach = _port_machine("masked", noise, backend, seed=4)
        ses = mach.session(schedule=port_api.Anneal(
            0.2, 2.0, n_sweeps=7, kind="linear"), chains=8)
        assert ses.backend == backend
        chip = ses.program_master(
            np.random.default_rng(5).normal(size=g.n_edges) * 40.0,
            np.random.default_rng(6).normal(size=g.n_nodes) * 15.0)
        st = ses.init_state(ses.generator(7))
        m, ns, _ = ses.sample(chip, st.m, st.noise_state)
        s, c, m2, ns2 = ses.stats(chip, m, ns, 10, 2)
        hist, m3, ns3 = ses.visible_hist(chip, m2, ns2, np.array([1, 6, 30]),
                                         2)
        outs[backend] = [m, ns, s, c, m2, ns2, hist, m3, ns3]
    for backend, out in outs.items():
        for a, b in zip(out, outs["ref"]):
            assert torch.equal(a, b), backend


def test_dense_kernels_equal_slot_layout_plain_versions():
    """The plain dense half-sweep equals the plain slot-layout half-sweep on
    an attach_sparse chip, and the engine's Gram read-out equals the slot
    table's, bit for bit (ascending sums; zeros are additive identities)."""
    g, mach = _port_machine("2x2", "counter", "fused", seed=8)
    ses = mach.session(chains=8)
    chip = ses.program_master(np.random.default_rng(9).normal(
        size=g.n_edges) * 50.0, np.zeros(g.n_nodes))
    st = ses.init_state(ses.generator(1))
    u = port_lfsr.counter_uniform(3, 5, torch.arange(8)[:, None],
                                  torch.arange(g.n_nodes)[None, :])
    mask = torch.as_tensor(g.color == 1)
    rows = (chip.h, chip.tanh_gain, chip.tanh_offset, chip.rand_gain,
            chip.comp_offset)
    dense = port_ref.pbit_half_sweep_ref(st.m, chip.W, *rows, mask, 1.1, u)
    slots = port_ref.pbit_sparse_half_sweep_ref(st.m, chip.nbr_idx,
                                                chip.nbr_w, *rows, mask, 1.1,
                                                u)
    assert torch.equal(dense, slots)
    args = [st.m, chip.W, *rows, torch.as_tensor(g.color == 0), mask,
            torch.full((4, 8), 0.9), st.noise_state]
    meas = torch.tensor([0.0, 1.0, 1.0, 1.0])
    d = sweep_fused(*args, None, None, meas, accumulate=True)
    sp = port_sf.sweep_sparse(args[0], chip.nbr_idx, chip.nbr_w,
                              *args[2:], None, None, meas, accumulate=True)
    e = torch.as_tensor(g.edges).long()
    slot = torch.as_tensor(g.edge_slots(chip.nbr_idx.numpy())[0]).long()
    assert torch.equal(d[0], sp[0]) and torch.equal(d[2], sp[2])
    assert torch.equal(d[3][e[:, 0], e[:, 1]], sp[3][slot, e[:, 0]])
    assert torch.equal(d[3], d[3].T)


def test_hopper_feasibility_boundary():
    """W must fit the L2; a chain tiling must fit a block's shared memory
    with the Gram partials within an eighth of device memory — the H100's
    limits off the card, any card's when they are given."""
    f = port_sf.dense_resident_feasible
    h100 = port_sf.H100
    assert port_sf.card_limits("cpu") is h100
    # few chains: W in L2 binds (4 * 3620^2 <= 50 MiB < 4 * 3621^2)
    assert f(3620, 8) and not f(3621, 8)
    assert f(3620, 256) and not f(3621, 256)
    assert f(440, 256) and port_sf.dense_tile_chains(440, 256) == 2
    # many chains: the Gram partials bind first (a card of 80 GiB, whose
    # eighth is 10 GiB: tiles of up to 17 chains fit at N ~ 1600)
    card = h100._replace(memory_bytes=80 * 2 ** 30)
    assert f(3620, 1428, card) and not f(3620, 1429, card)
    assert f(1619, 16384, card) and not f(1620, 16384, card)
    tb = port_sf.dense_tile_chains(1619, 16384, gram=True, limits=card)
    assert -(-16384 // tb) * 4 * 1619 ** 2 <= card.gram_partial_bytes
    assert port_sf.dense_smem_bytes(tb, 1619) <= card.smem_per_block
    # a card with a smaller L2 and less memory
    small = h100._replace(l2_bytes=40 * 2 ** 20, memory_bytes=40 * 2 ** 30)
    assert f(3300, 256) and not f(3300, 256, small)
    assert f(1500, 16384) and not f(1500, 16384, small)
    with pytest.raises(ValueError, match="shared memory"):
        port_sf.dense_tile_chains(29100, 1)
    with pytest.raises(ValueError, match="Gram"):
        port_sf.dense_tile_chains(2048, 16384, gram=True)


def test_auto_resolution_of_dense_only_specs(monkeypatch):
    """A dense-only spec (no slot layout) with in-kernel noise resolves to
    the dense resident engine exactly where the Hopper model admits it."""
    monkeypatch.delenv("REPRO_PBIT_BACKEND", raising=False)
    small = port_hw.sample_mismatch(torch.Generator().manual_seed(0), 8,
                                    port_hw.HardwareConfig(), device="cpu")

    def resolve(rows, cols, chains, noise="counter"):
        # resolution reads the graph and chain count only
        spec = port_api.SamplerSpec(
            graph=make_chimera(rows, cols), hw=port_hw.HardwareConfig(),
            mismatch=small, noise=noise, chains=chains, attach_sparse=False,
            device="cpu")
        return port_api.resolve_backend(spec)

    assert resolve(7, 8, 256) == "fused"            # 448 spins
    assert resolve(7, 8, 256, "philox") == "ref"
    assert resolve(15, 15, 256) == "fused"          # 1800 spins
    assert resolve(15, 16, 256) == "fused"          # 1920
    assert resolve(15, 16, 16384) == "ref"          # ... Gram partials
    assert resolve(21, 21, 256) == "fused"          # 3528
    assert resolve(29, 29, 8) == "ref"              # 6728: W exceeds L2
    assert resolve(7, 8, 256) == port_api.resolve_backend(
        port_api.SamplerSpec(graph=make_chimera(7, 8),
                             hw=port_hw.HardwareConfig(), mismatch=small,
                             noise="lfsr", attach_sparse=False,
                             device="cpu"))


def test_dense_wrappers_reject_what_the_engine_does_not_take():
    p = DenseProblem("2x2", "counter", 4, seed=26)
    args = p.port_args()
    with pytest.raises(ValueError, match="gather_perm"):
        sweep_fused(*args, noise_mode="lfsr")
    with pytest.raises(ValueError, match="visible"):
        sweep_fused(*args, torch.ones(S), torch.arange(13),
                    collect_hist=True, n_visible=13)
    empty = list(args)
    empty[9] = torch.zeros((0, 4))
    out = sweep_fused(*empty, torch.zeros(0), accumulate=True)
    assert torch.equal(out[0], args[0]) and out[3].shape == (32, 32)
    assert sweep_fused.launches == 0 and pbit_half_sweep.launches == 0
    assert sweep_fused_ref is not sweep_fused
