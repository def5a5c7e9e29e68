"""K5, the in-kernel halo exchange: its plain version on the CPU.

`sweep_sparse_exchange` runs every row band of the sharded engine in one
launch and refreshes the halo columns inside it; on a CPU tensor the
wrapper runs `sweep_sparse_exchange_ref`, whose contract is the
reference's fused-resident-exchange emulation (half-sweep windows of K1
with an exchange between them, `src/repro/core/distributed.py`).  Held
here, bit for bit:

* against the reference's sharded engine itself (``fused_sparse``,
  ``halo_every`` 2 and 3, async, 2 and 4 bands, clamped moments), run
  once on forced host devices, with the port's engine forced through K5;
* against the port's own emulation (K1 windows per band) over a grid of
  policies, band counts, clamps and moments;
* in the stream mode the engine never calls (a next program staged during
  the launch), with a ragged chain count;
* against K1 where they must agree: a launch with no mid-launch exchange.
The kernel itself is held against this plain version on the card by
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import distributed as port_dist
from repro_torch.core.cd import PBitMachine
from repro_torch.core.chimera import make_chimera
from repro_torch.kernels import shard_sweep
from repro_torch.kernels.ref import halo_exchange_segments
from repro_torch.kernels.sweep_fused import (
    sweep_sparse_exchange,
    sweep_sparse_exchange_ref,
    sweep_sparse_ref,
)

from _torch_port import run_forced_reference

B = 8


def _engine(g, n_bands, sync, chains=B, resident=True):
    return port_dist.ShardedEngine(
        g, port_dist.make_mesh((n_bands,), ("data",)),
        port_api.Partition(rows="data"), "counter", 8, chains,
        sync=port_api.Sync(**sync), backend="fused_sparse", device="cpu",
        resident_exchange=resident)


class _Calls:
    """Counts the calls that reach K5's wrapper from the engine."""

    def __init__(self, monkeypatch):
        self.n = 0
        wrapped = shard_sweep.sweep_sparse_exchange

        def counting(*args, **kwargs):
            self.n += 1
            return wrapped(*args, **kwargs)
        monkeypatch.setattr(shard_sweep, "sweep_sparse_exchange", counting)


# ---------------------------------------------------------------------------
# against the reference's engine
# ---------------------------------------------------------------------------
CASES = {   # name: (bands, sync, stats with clamps)
    "k2-rows2": (2, dict(halo_every=2, sweeps_per_launch=2), False),
    "k3-rows2": (2, dict(halo_every=3, sweeps_per_launch=4), True),
    "k2_async-rows2": (2, dict(halo_every=2, mode="async",
                               sweeps_per_launch=2), False),
    "k4-rows4": (4, dict(halo_every=4, sweeps_per_launch=4), False),
}


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    cases = [(name, *CASES[name]) for name in sorted(CASES)]
    return run_forced_reference(f"""
    import jax.numpy as jnp
    from repro import api
    from repro.core.cd import PBitMachine
    from repro.core.chimera import make_chimera
    from repro.core.hardware import HardwareConfig

    g = make_chimera(4, 2, masked_cells=((0, 1),))
    mach = PBitMachine.create(g, jax.random.PRNGKey(1), HardwareConfig(),
                              noise="counter", backend="fused_sparse")
    ses0 = api.Session(mach.sampler_spec(chains={B}))
    rng = np.random.default_rng(11)
    chip = ses0.program_edges(
        jnp.asarray(rng.integers(-60, 60, g.n_edges), jnp.int32),
        jnp.asarray(rng.integers(-15, 15, g.n_nodes), jnp.int32))
    m0 = ses0.random_spins(jax.random.PRNGKey(12))
    ns = ses0.noise_state(jax.random.PRNGKey(13))
    betas = jnp.linspace(0.3, 1.5, 8)
    cm = np.zeros(g.n_nodes, bool)
    cm[[1, 9, 30]] = True
    cv = np.where(rng.random(({B}, g.n_nodes)) < 0.5, -1.0, 1.0)
    save("problem", m0, ns, betas, cm, cv, *jax.tree_util.tree_leaves(chip))
    for name, n, sync, stats in {cases!r}:
        sp = mach.sampler_spec(chains={B}, mesh=auto_mesh((n,), ("data",)),
                               partition=api.Partition(rows="data"),
                               sync=api.Sync(**sync))
        ses = api.Session(sp)
        save(name, *ses.sample(chip, m0, ns, betas)[:2])
        if stats:
            save(name + "/stats", *ses.stats(
                chip, m0, ns, 8, 2, clamp_mask=jnp.asarray(cm),
                clamp_values=jnp.asarray(cv, jnp.float32)))
    """, 4, tmp_path_factory.mktemp("halo_kernel"))


def _same(got, want):
    for a, b in zip(got, want):
        a = (convert.noise_state_to_numpy(a) if a.dtype == torch.int32
             else a.numpy())
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k5_plain_version_matches_reference_engine(reference_runs, name,
                                                   monkeypatch):
    runs = reference_runs
    m0, ns, betas, cm, cv, *chip = runs["problem"]
    chip = convert.chip_from_numpy(chip, "cpu")
    m0 = convert.spins_from_numpy(m0, "cpu")
    ns = convert.noise_state_from_numpy(ns, "cpu")
    g = make_chimera(4, 2, masked_cells=((0, 1),))
    n_bands, sync, stats = CASES[name]
    eng = _engine(g, n_bands, sync)
    assert eng.loop_shape == "fused-resident-exchange" and eng._resident
    calls = _Calls(monkeypatch)
    _same(eng.sample(chip, m0, ns, torch.from_numpy(betas))[:2], runs[name])
    assert calls.n == 8 // sync["sweeps_per_launch"]   # one per launch
    if stats:
        _same(eng.stats(chip, m0, ns, 1.0, 8, 2,
                        torch.from_numpy(cm), torch.from_numpy(cv)),
              runs[name + "/stats"])


# ---------------------------------------------------------------------------
# against the port's emulation: K1 windows per band
# ---------------------------------------------------------------------------
GRID = [(n_bands, k, mode, L)
        for n_bands in (2, 3)
        for k, L in ((1, 1), (1, 2), (2, 2), (3, 2), (3, 4), (4, 4))
        for mode in ("barrier", "async")]


@pytest.mark.parametrize("n_bands,k,mode,L", GRID,
                         ids=[f"rows{n}-k{k}-{m}-L{L}" for n, k, m, L in GRID])
def test_k5_plain_version_equals_k1_window_emulation(n_bands, k, mode, L):
    """The engine forced through K5's plain version equals its emulation
    (half-sweep windows of K1 per band): spins, noise state, and the
    in-kernel moments of a clamped stats phase (the bit-exact barrier's
    moments run the emulation either way)."""
    g = make_chimera(3, 2, masked_cells=((2, 1),))
    mach = PBitMachine.create(g, n_bands + k, noise="counter", device="cpu")
    ses = port_api.Session(mach.sampler_spec(chains=5))
    rng = np.random.default_rng(10 * k + L)
    chip = ses.program_edges(rng.integers(-60, 60, g.n_edges),
                             rng.integers(-15, 15, g.n_nodes))
    st = ses.init_state(ses.generator(k))
    S = 2 * L
    betas = torch.as_tensor(rng.uniform(0.2, 1.8, (S, 5)), dtype=torch.float32)
    sync = dict(halo_every=k, mode=mode, sweeps_per_launch=L)
    k5 = _engine(g, n_bands, sync, chains=5)
    emu = _engine(g, n_bands, sync, chains=5, resident=False)
    a = k5.sample(chip, st.m, st.noise_state, betas)
    b = emu.sample(chip, st.m, st.noise_state, betas)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    cm = torch.as_tensor(rng.random(g.n_nodes) < 0.1)
    cv = torch.as_tensor(np.where(rng.random((5, g.n_nodes)) < 0.5, -1.0,
                                  1.0), dtype=torch.float32)
    for x, y in zip(k5.stats(chip, st.m, st.noise_state, 0.8, S, 1, cm, cv),
                    emu.stats(chip, st.m, st.noise_state, 0.8, S, 1, cm, cv)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the function itself
# ---------------------------------------------------------------------------
def _operands(n_bands, chains, seed, *, clamp=False, S=4):
    """Every band's extended operands from a real plan of a 6x2 lattice."""
    g = make_chimera(6, 2)
    p = port_dist.plan_row_partition(g, n_bands)
    rng = np.random.default_rng(seed)
    R, n_loc, H = n_bands, p.n_loc, p.halo
    N = n_loc + 2 * H
    D = p.nbr_idx.shape[1]
    pad = ((0, 0), (0, 0), (0, 2 * H))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    m = np.where(rng.random((R, chains, N)) < 0.5, -1.0, 1.0)
    m[:, :, n_loc:] = np.where(rng.random((R, chains, 2 * H)) < 0.2, 0.0,
                               m[:, :, n_loc:])                # some zeros
    upd = np.pad(p.upd_masks, pad)
    ops = dict(
        m=f32(m),
        nbr_idx=torch.as_tensor(np.pad(p.nbr_idx, pad), dtype=torch.int32),
        nbr_w=f32(np.pad(rng.normal(size=(R, D, n_loc)), pad)),
        h=f32(rng.normal(size=(R, N)) * 0.3),
        gain=f32(1 + 0.1 * rng.normal(size=(R, N))),
        off=f32(0.05 * rng.normal(size=(R, N))),
        rand_gain=f32(1 + 0.1 * rng.normal(size=(R, N))),
        comp_off=f32(0.05 * rng.normal(size=(R, N))),
        mask0=torch.as_tensor(upd[:, 0]), mask1=torch.as_tensor(upd[:, 1]),
        betas=f32(rng.uniform(0.3, 2.0, (S, chains))),
        noise_state=convert.noise_state_from_numpy(
            np.array([rng.integers(2 ** 32), 7], np.uint32), "cpu"),
        send_up=torch.as_tensor(p.send_up), send_dn=torch.as_tensor(p.send_dn))
    if clamp:
        cm = np.zeros((R, N), bool)
        cm[:, :n_loc] = rng.random((R, n_loc)) < 0.15
        ops.update(clamp_mask=torch.as_tensor(cm),
                   clamp_values=f32(np.where(rng.random((R, chains, N)) < 0.5,
                                             -1.0, 1.0)))
    return ops, dict(n_loc=n_loc, halo=H)


def _call(fn, ops, kw, **extra):
    names = ("m", "nbr_idx", "nbr_w", "h", "gain", "off", "rand_gain",
             "comp_off", "mask0", "mask1", "betas", "noise_state", "send_up",
             "send_dn")
    rest = {k: v for k, v in ops.items() if k not in names}
    return fn(*(ops[n] for n in names), **rest, **kw, **extra)


@pytest.mark.parametrize("mode", ["barrier", "async"])
def test_stream_mode_stages_the_next_program_with_ragged_chains(mode):
    """Stream mode (no engine caller): a next program staged during the
    launch; spins and noise state equal the launch without it, the staged
    pair equals the next program.  B = 5 chains."""
    ops, kw = _operands(3, 5, 21, clamp=True)
    R, D, N = ops["nbr_w"].shape
    rng = np.random.default_rng(22)
    nxt_w = torch.as_tensor(rng.normal(size=(R, D, N)), dtype=torch.float32)
    nxt_h = torch.as_tensor(rng.normal(size=(R, N)), dtype=torch.float32)
    pts = dict(ex_pts=(0, 3, 5), mode=mode)
    plain = _call(sweep_sparse_exchange_ref, ops, kw, **pts)
    staged = _call(sweep_sparse_exchange, ops, kw, **pts,
                   next_nbr_w=nxt_w, next_h=nxt_h)
    assert len(staged) == 4
    assert torch.equal(staged[0], plain[0]) and torch.equal(staged[1],
                                                            plain[1])
    assert torch.equal(staged[2], nxt_w) and torch.equal(staged[3], nxt_h)
    # into given buffers, through the band-batched helper too
    bufs = (torch.empty_like(nxt_w), torch.empty_like(nxt_h))
    out = _call(sweep_sparse_exchange_ref, ops, kw, **pts,
                next_nbr_w=nxt_w, next_h=nxt_h, staged=bufs)
    assert out[2] is bufs[0] and torch.equal(bufs[1], nxt_h)
    n_loc, H = kw["n_loc"], kw["halo"]
    helper = shard_sweep.fused_shard_exchange_resident(
        ops["m"][:, :, :n_loc], ops["m"][:, :, n_loc:n_loc + H],
        ops["m"][:, :, n_loc + H:], ops["nbr_idx"][:, :, :n_loc],
        ops["nbr_w"][:, :, :n_loc],
        *(ops[x][:, :n_loc] for x in ("h", "gain", "off", "rand_gain",
                                      "comp_off", "mask0", "mask1")),
        ops["betas"], ops["noise_state"], 0, [0] * R, ops["send_up"],
        ops["send_dn"], ops["clamp_mask"][:, :n_loc],
        ops["clamp_values"][:, :, :n_loc],
        next_nbr_w=nxt_w[:, :, :n_loc], next_h=nxt_h[:, :n_loc], **pts)
    assert torch.equal(helper[0], plain[0][:, :, :n_loc])
    assert torch.equal(helper[2], plain[0][:, :, n_loc:n_loc + H])
    assert torch.equal(helper[4], nxt_w[:, :, :n_loc])


@pytest.mark.parametrize("coords", [None, (1000, [77, 500, 9000]),
                                    (2 ** 32 - 3, [2 ** 32 - 100] * 3)],
                         ids=["origin", "offset", "wrapping"])
def test_launch_without_mid_launch_exchange_is_k1_per_band(coords):
    """``ex_pts=(0,)``: the halos are exchanged once, then each band runs
    K1's launch on its extended block — the plain versions agree, noise
    coordinates (wrapping past 2^32) and moments included."""
    ops, kw = _operands(3, 4, 5)
    meas = torch.tensor([0.0, 1.0, 1.0, 1.0])
    got = _call(sweep_sparse_exchange_ref, ops, kw, ex_pts=(0,),
                measured=meas, coord_offset=coords)
    n_loc, H = kw["n_loc"], kw["halo"]
    up, dn = shard_sweep.halo_exchange(ops["m"][:, :, :n_loc],
                                       ops["send_up"].long(),
                                       ops["send_dn"].long())
    row0, col0 = coords if coords is not None else (0, [0, 0, 0])
    for r in range(3):
        m_ext = torch.cat([ops["m"][r, :, :n_loc], up[r], dn[r]], dim=1)
        want = sweep_sparse_ref(
            m_ext, ops["nbr_idx"][r], ops["nbr_w"][r],
            *(ops[x][r] for x in ("h", "gain", "off", "rand_gain",
                                  "comp_off", "mask0", "mask1")),
            ops["betas"], ops["noise_state"], measured=meas,
            coord_offset=(row0, col0[r]), accumulate=True)
        assert torch.equal(got[0][r], want[0])
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[2][r], want[2])
        assert torch.equal(got[3][r], want[3])


def test_edge_bands_read_zeros_and_async_drains_the_last_exchange():
    ops, kw = _operands(2, 3, 8)
    n_loc, H = kw["n_loc"], kw["halo"]
    bar = _call(sweep_sparse_exchange_ref, ops, kw, ex_pts=(0, 2, 5))
    asy = _call(sweep_sparse_exchange_ref, ops, kw, ex_pts=(0, 2, 5),
                mode="async")
    for out in (bar, asy):
        assert torch.all(out[0][0, :, n_loc:n_loc + H] == 0)    # no band
        assert torch.all(out[0][1, :, n_loc + H:] == 0)         # above/below
    assert not torch.equal(bar[0], asy[0])
    assert int(bar[1][1]) == int(asy[1][1]) == 7 + 2 * 4
    # one exchange point: barrier installs the boundary of the spins it
    # was given, async runs on the given halos and drains that same
    # boundary into the output
    up, dn = shard_sweep.halo_exchange(ops["m"][:, :, :n_loc],
                                       ops["send_up"].long(),
                                       ops["send_dn"].long())
    for mode in ("barrier", "async"):
        out = _call(sweep_sparse_exchange_ref, ops, kw, ex_pts=(0,),
                    mode=mode)
        assert torch.equal(out[0][:, :, n_loc:n_loc + H], up)
        assert torch.equal(out[0][:, :, n_loc + H:], dn)


def test_wrapper_dispatches_cpu_tensors_to_the_plain_version():
    ops, kw = _operands(2, 4, 3, clamp=True)
    before = sweep_sparse_exchange.launches
    a = _call(sweep_sparse_exchange, ops, kw, ex_pts=(0, 1, 4),
              measured=torch.ones(4))
    b = _call(sweep_sparse_exchange_ref, ops, kw, ex_pts=(0, 1, 4),
              measured=torch.ones(4))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == 4
    assert sweep_sparse_exchange.launches == before   # no kernel ran


@pytest.mark.parametrize("bad,match", [
    (dict(mode="eventual"), "mode"),
    (dict(ex_pts=(1, 3)), "start at 0"),
    (dict(ex_pts=(0, 9)), "outside"),
    (dict(halo=1), "columns per band"),
    (dict(next_nbr_w=torch.zeros(1)), "next_h"),
    (dict(next_nbr_w=torch.zeros(1), next_h=torch.zeros(1),
          measured=torch.ones(4)), "streaming excludes")])
def test_exchange_refusals(bad, match):
    ops, kw = _operands(2, 2, 4)
    args = dict(kw, ex_pts=(0, 2), mode="barrier")
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        _call(sweep_sparse_exchange_ref, ops, {}, **args)


def test_exchange_segments_helper():
    assert halo_exchange_segments((0,), 8) == ((0, 8),)
    assert halo_exchange_segments((0, 3, 6), 8) == ((0, 3), (3, 6), (6, 8))
    assert port_api.Sync(halo_every=3, sweeps_per_launch=4
                         ).exchange_points() == (0, 3, 6)
    assert port_api.Sync(halo_every=math.inf).exchange_points() == (0,)
