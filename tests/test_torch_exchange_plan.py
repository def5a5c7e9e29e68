"""K5's plan and prepared launch on Hopper, on the CPU.

`exchange_plan` picks K5's body by shape: the cluster body (a thread-block
cluster is the R bands of one tile of chains, the halos exchanged through
distributed shared memory) for D = 6 and up to 16 bands, where the card
holds such a cluster; the mailbox body (the grid-wide kernel, all blocks
resident) for everything else.  `ExchangeTables` prepares a call's
launches once: each band's per-colour update lists and the cluster body's
node tables in list order.  The kernels run only on the card
(``chip_smoke.py`` holds both bodies against the plain version there);
these tests pin the plan, the lists and tables the cluster body reads, and
the engine's route through K5 for the launch-boundary policies.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import api as port_api
from repro_torch.core import distributed as port_dist
from repro_torch.core import lfsr as lfsr_mod
from repro_torch.core.cd import PBitMachine
from repro_torch.core.chimera import make_chimera, make_chip_graph
from repro_torch.kernels import shard_sweep
from repro_torch.kernels import sweep_fused as sf
from repro_torch.kernels.ref import decision_value

H100 = sf.H100


def _band_shape(graph, R):
    p = port_dist.plan_row_partition(graph, R)
    return p, p.n_loc + 2 * p.halo, p.halo


def _smem(tb, N, H):
    """The cluster CTA's shared memory as csrc/sweep_exchange.cu lays it
    out: int8 spins [N][row], the outbox [3][2][H][row] (each padded to 16
    bytes) and a float beta a chain of the row, row = 4, 8, 16 or 32
    bytes."""
    row = 4 if tb <= 4 else (8 if tb <= 8 else (16 if tb <= 16 else 32))
    return (-(-N * row // 16) * 16 + -(-6 * H * row // 16) * 16 + 4 * row)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("graph,R,B,tb", [
    ("chip", 2, 256, 4), ("chip", 7, 256, 4), ("lattice", 8, 256, 16),
    ("lattice", 16, 256, 32), ("lattice", 8, 32, 4), ("chip", 2, 5, 4),
    ("chip", 2, 3, 3)])
def test_cluster_body_up_to_sixteen_bands(graph, R, B, tb):
    """The cluster body takes a cluster of R CTAs; its tile is the fewest
    chains, at least 4 (or B), whose tiles run in the fewest waves of the
    clusters the card holds (the model holds sms // R clusters of the
    lattice's bands: 512 threads at up to 128 registers is one CTA an
    SM)."""
    g = make_chip_graph() if graph == "chip" else make_chimera(64, 64)
    p, N, H = _band_shape(g, R)
    plan = sf.exchange_plan(R, B, N, 6, halo=H)
    assert plan.body == "cluster" and plan.cluster == R
    assert plan.chains == min(tb, B)
    assert plan.smem_bytes == sf.exchange_cluster_smem_bytes(
        plan.chains, N, H) == _smem(plan.chains, N, H)
    assert plan.smem_bytes <= H100.smem_per_block
    assert plan.threads == min(512, 32 * -(-(-(-N // 2)) // 32))
    assert plan.threads >= max(int(p.upd_masks[r, c].sum())
                               for r in range(R) for c in (0, 1)) or \
        plan.threads == 512
    if graph == "lattice":
        held = H100.sms // R
        tiles = -(-B // plan.chains)
        assert tiles <= held                    # one wave
        if plan.chains > 4:                     # and one fewer does not
            assert -(-B // (plan.chains - 1)) > held
    if (graph, R, B) == ("lattice", 8, 256):
        # the sharded path's launch on the model: 16 tiles of 16 chains,
        # one wave of 128 CTAs
        assert (plan.threads, held) == (512, 16)
        assert plan.smem_bytes == 4608 * 16 + 6 * 256 * 16 + 64
    if (graph, R) == ("lattice", 16):
        # non-portable clusters: 8 held, 8 tiles of 32 chains
        assert plan.smem_bytes == 2560 * 32 + 6 * 256 * 32 + 128


def test_mailbox_body_above_sixteen_bands():
    """17 bands of the 64x64-cell lattice: no cluster of 17 CTAs, so the
    mailbox body, the fewest chains a block whose grid is resident at once
    (one 1024-thread block an SM by the model's registers)."""
    g = make_chimera(64, 64)
    _, N, H = _band_shape(g, 17)
    plan = sf.exchange_plan(17, 256, N, 6, halo=H)
    tb = next(t for t in range(1, 257) if 17 * -(-256 // t) <= H100.sms)
    assert plan == sf.ExchangePlan("mailbox", 1, tb, 1024,
                                   sf.exchange_smem_bytes(tb, N))
    assert tb == 37
    # a slot count other than 6 takes the mailbox body at any band count
    _, N8, H8 = _band_shape(g, 8)
    assert sf.exchange_plan(8, 256, N8, 5, halo=H8).body == "mailbox"
    # asked-for chains are checked, not chosen
    assert sf.exchange_plan(17, 256, N, 6, halo=H, block_b=40).chains == 40
    with pytest.raises(ValueError, match="no body"):
        sf.exchange_plan(17, 256, N, 6, halo=H, block_b=20)


def test_card_counts_decide():
    """The card's own resident-cluster count (`resident`) drives the tile
    and the body: a card that holds no cluster of R CTAs takes the mailbox
    body; the fewest chains whose tiles run in the fewest waves of the
    clusters held."""
    g = make_chimera(64, 64)
    _, N, H = _band_shape(g, 8)
    asked = []

    def none(plan):
        asked.append(plan.chains)
        return 0
    plan = sf.exchange_plan(8, 256, N, 6, halo=H, resident=none)
    assert plan.body == "mailbox" and asked == list(range(4, 33))
    assert plan == sf.exchange_plan(8, 256, N, 6, halo=H, resident=none,
                                    mailbox_blocks=lambda tb: 132)
    # 15 clusters of 8 held (the H100's count at the path shape): 16 tiles
    # of 16 chains would take two waves, 15 tiles of 18 take one
    plan = sf.exchange_plan(8, 256, N, 6, halo=H, resident=lambda p: 15)
    assert plan.chains == 18 and plan.smem_bytes == _smem(18, N, H)
    # 7 held: no tile runs in one wave; the fewest chains in two, 14 tiles
    plan = sf.exchange_plan(8, 256, N, 6, halo=H, resident=lambda p: 7)
    assert plan.chains == 19
    # the count may differ by shape: 12 clusters up to 16 chains, 20 above
    plan = sf.exchange_plan(8, 256, N, 6, halo=H,
                            resident=lambda p: 20 if p.chains > 16 else 12)
    assert plan.chains == 17
    # chains asked for: clipped to 1..32, and to B
    for want, got in ((2, 2), (40, 32), (0, 1)):
        assert sf.exchange_plan(8, 256, N, 6, halo=H,
                                block_b=want).chains == got
    assert sf.exchange_plan(2, 3, N, 6, halo=H).chains == 3


@pytest.mark.parametrize("tb,words", [(1, 1), (4, 1), (5, 2), (8, 2),
                                      (9, 4), (16, 4), (17, 8), (32, 8)])
def test_chain_words(tb, words):
    assert sf.chain_words(tb) == words
    assert sf.exchange_cluster_smem_bytes(tb, 4608, 256) == _smem(tb, 4608,
                                                                  256)


# ---------------------------------------------------------------------------
# the lists and node tables
# ---------------------------------------------------------------------------
def _extended_operands(R, chains, seed, clamp=False):
    """A 6x2 lattice cut into R bands, on the extended block, as the engine
    hands them to `exchange_tables`."""
    g = make_chimera(6, 2)
    p = port_dist.plan_row_partition(g, R)
    rng = np.random.default_rng(seed)
    D, n_loc, H = p.nbr_idx.shape[1], p.n_loc, p.halo

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    ops = dict(nbr_idx=torch.as_tensor(p.nbr_idx),
               nbr_w=f32(R, D, n_loc), h=f32(R, n_loc),
               gain=1 + 0.1 * f32(R, n_loc), off=0.05 * f32(R, n_loc),
               rand_gain=1 + 0.1 * f32(R, n_loc),
               comp_off=0.05 * f32(R, n_loc),
               mask0=torch.as_tensor(p.upd_masks[:, 0]),
               mask1=torch.as_tensor(p.upd_masks[:, 1]),
               col0=[int(c) for c in p.part_ids[:, 0]],
               send_up=torch.as_tensor(p.send_up),
               send_dn=torch.as_tensor(p.send_dn))
    if clamp:
        cm = torch.as_tensor(rng.random((R, n_loc)) < 0.15)
        ops.update(mask0=ops["mask0"] & ~cm, mask1=ops["mask1"] & ~cm,
                   clamp_mask=cm, clamp_values=torch.as_tensor(
                       np.where(rng.random((R, chains, n_loc)) < 0.5, -1.0,
                                1.0), dtype=torch.float32))
    return ops, p


def _tables(ops, chains, **kw):
    return shard_sweep.exchange_tables(
        *(ops[k] for k in ("nbr_idx", "nbr_w", "h", "gain", "off",
                           "rand_gain", "comp_off", "mask0", "mask1",
                           "col0", "send_up", "send_dn")),
        ops.get("clamp_mask"), ops.get("clamp_values"), chains=chains, **kw)


@pytest.mark.parametrize("R", [1, 2, 3])
def test_lists_follow_the_masks(R):
    """Every column a colour updates once, in ascending order; no halo
    column; zeros past a list's count."""
    ops, p = _extended_operands(R, 4, R, clamp=True)
    t = _tables(ops, 4, ex_pts=(0, 2))
    n_loc = p.n_loc
    for r in range(R):
        for c in (0, 1):
            mask = t.masks[c][r]
            n = int(t.counts[r, c])
            got = t.lists[r, c, :n].tolist()
            assert got == torch.nonzero(mask).reshape(-1).tolist()
            assert got == sorted(set(got)) and all(i < n_loc for i in got)
            assert bool((t.lists[r, c, n:] == 0).all())
    assert t.lists.shape[-1] == t.idx.shape[2]        # every column


def test_empty_colour_and_all_empty():
    m0 = torch.tensor([[1, 0, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0]], dtype=torch.bool)
    m1 = torch.tensor([[0, 1, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0]], dtype=torch.bool)
    lists, counts = sf.exchange_lists(m0, m1)
    assert counts.tolist() == [[2, 1], [0, 0]]
    assert lists.tolist() == [[[0, 2, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0]],
                              [[0] * 6, [0] * 6]]
    z = torch.zeros((2, 6), dtype=torch.bool)
    lists, counts = sf.exchange_lists(z, z)
    assert lists.shape == (2, 2, 6) and int(counts.sum()) == 0


def test_node_tables_hold_each_entrys_operands_in_list_order():
    ops, p = _extended_operands(3, 4, 7, clamp=True)
    t = _tables(ops, 4, ex_pts=(0,))
    R, D, N = t.idx.shape
    tab = t.tab
    assert tab.dtype == torch.int32 and tab.shape == (R, 2, 2 * D + 7,
                                                      t.lists.shape[-1])
    col0 = lfsr_mod.to_u64(t.col0)
    for r in range(R):
        for c in (0, 1):
            n = int(t.counts[r, c])
            node = t.lists[r, c, :n]
            f = tab[r, c, :, :n]
            assert torch.equal(f[0].long(), node)
            assert torch.equal(f[1:1 + D], t.idx[r][:, node])
            assert torch.equal(f[1 + D:1 + 2 * D].view(torch.float32),
                               t.w[r][:, node])
            for k, row in enumerate(t.rows):
                assert torch.equal(f[1 + 2 * D + k].view(torch.float32),
                                   row[r, node])
            want = lfsr_mod._mul32((node + col0[r]) & 0xFFFFFFFF,
                                   0xC2B2AE3D)
            assert torch.equal(lfsr_mod.to_u64(f[-1]), want)


def _list_order_launch(t, m_ext, betas, noise_state):
    """One launch with one exchange point, barrier, computed the way the
    cluster body reads its tables: each list entry's node from its slots,
    weights and rows, chain by chain, noise from the entry's column key."""
    R, B, N = m_ext.shape
    n_loc, H = t.n_loc, t.halo
    up, dn = shard_sweep.halo_exchange(m_ext[:, :, :n_loc],
                                       t.send_up.long(), t.send_dn.long())
    m = torch.cat([m_ext[:, :, :n_loc], up, dn], dim=2).clone()
    D = t.idx.shape[1]
    seed = int(noise_state[0]) & 0xFFFFFFFF
    ctr0 = int(noise_state[1]) & 0xFFFFFFFF
    rows = torch.arange(B, dtype=torch.int64)
    for g in range(2 * betas.shape[0]):
        s, c = divmod(g, 2)
        if t.clamp_mask is not None and c == 0:
            m = torch.where(t.clamp_mask[:, None, :], t.clamp_values, m)
        hk = lfsr_mod.mix32(torch.tensor(seed) ^ lfsr_mod._mul32(
            torch.tensor((ctr0 + g) & 0xFFFFFFFF), 0x9E3779B9))
        for r in range(R):
            n = int(t.counts[r, c])
            f = t.tab[r, c, :, :n]
            node, idx = f[0].long(), f[1:1 + D].long()
            w = f[1 + D:1 + 2 * D].view(torch.float32)
            h, gain, off, rg, co = (f[1 + 2 * D + k].view(torch.float32)
                                    for k in range(5))
            key = lfsr_mod.to_u64(f[-1])
            acc = torch.zeros((B, n))
            for d in range(D):
                acc = acc + w[d] * m[r][:, idx[d]]
            byte = lfsr_mod.mix32(hk ^ lfsr_mod._mul32(rows, 0x85EBCA77)[:, None]
                                  ^ key[None, :]) & 0xFF
            u = lfsr_mod.byte_to_uniform(byte)
            dec = decision_value(acc + h, gain, off, rg, co, betas[s], u)
            m[r][:, node] = torch.where(dec >= 0.0, 1.0, -1.0)
    return m


@pytest.mark.parametrize("clamp", [False, True], ids=["free", "clamped"])
def test_tables_reproduce_the_plain_version(clamp):
    """The tables are what the kernel needs: a launch computed from them
    alone, entry by entry, equals `sweep_sparse_exchange_ref`."""
    R, B = 3, 5
    ops, p = _extended_operands(R, B, 3, clamp=clamp)
    t = _tables(ops, B, ex_pts=(0,))
    rng = np.random.default_rng(4)
    m = torch.as_tensor(np.where(rng.random((R, B, t.idx.shape[2])) < 0.5,
                                 -1.0, 1.0), dtype=torch.float32)
    betas = torch.as_tensor(rng.uniform(0.3, 2.0, (2, B)),
                            dtype=torch.float32)
    ns = lfsr_mod.from_u64(torch.tensor([12345, 2 ** 32 - 3]))
    want = shard_sweep.exchange_launch(m, t, betas, ns, 0)
    got = _list_order_launch(t, m, betas, ns)
    assert torch.equal(got, want[0])


def test_prepared_tables_refuse_other_operands():
    ops, _ = _extended_operands(2, 4, 5)
    t = _tables(ops, 4, ex_pts=(0, 2))
    m = torch.ones((2, 4, t.idx.shape[2]))
    betas = torch.ones((2, 4))
    ns = torch.zeros(2, dtype=torch.int32)
    out = shard_sweep.exchange_launch(m, t, betas, ns, 0)
    assert out[0].shape == m.shape
    for bad in (dict(ex_pts=(0, 3)), dict(mode="async"),
                dict(coord_offset=(0, [1, 2]))):
        kw = dict(n_loc=t.n_loc, halo=t.halo, ex_pts=t.ex_pts, mode=t.mode,
                  coord_offset=(0, t.col0), prepared=t)
        kw.update(bad)
        with pytest.raises(ValueError, match="prepared for other"):
            sf.sweep_sparse_exchange(
                m, t.idx, t.w, *t.rows, *t.masks, betas, ns, t.send_up,
                t.send_dn, **kw)
    with pytest.raises(ValueError, match="prepared for other"):
        sf.sweep_sparse_exchange(
            m, t.idx.clone(), t.w, *t.rows, *t.masks, betas, ns, t.send_up,
            t.send_dn, n_loc=t.n_loc, halo=t.halo, ex_pts=t.ex_pts,
            coord_offset=(0, t.col0), prepared=t)


# ---------------------------------------------------------------------------
# the engine: launch-boundary policies through K5
# ---------------------------------------------------------------------------
class _Recorder:
    """Stands between the engine and K5's wrapper, as chip_smoke.py's
    recorder does, and keeps every call."""

    def __init__(self, monkeypatch):
        self.calls = []
        wrapped = shard_sweep.sweep_sparse_exchange

        def record(*args, **kwargs):
            out = wrapped(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out
        monkeypatch.setattr(shard_sweep, "sweep_sparse_exchange", record)


def _engine(g, R, sync, chains, resident):
    return port_dist.ShardedEngine(
        g, port_dist.make_mesh((R,), ("data",)),
        port_api.Partition(rows="data"), "counter", 8, chains,
        sync=sync, backend="fused_sparse", device="cpu",
        resident_exchange=resident)


@pytest.mark.parametrize("mode", ["barrier", "async"])
@pytest.mark.parametrize("R", [2, 3])
def test_launch_boundary_policy_runs_through_k5(R, mode, monkeypatch):
    """``halo_every=inf`` keeps its loop shape ("fused"); forced through K5
    (``resident_exchange=True``) each launch is ONE K5 call with
    ``ex_pts=(0,)`` for every band, and equals the K1-per-band launches
    (``resident_exchange=False``) bit for bit: spins, noise state, and the
    moments of a clamped stats phase."""
    g = make_chimera(3, 2, masked_cells=((2, 1),))
    chains, L = 5, 2
    mach = PBitMachine.create(g, R, noise="counter", device="cpu")
    ses = port_api.Session(mach.sampler_spec(chains=chains))
    rng = np.random.default_rng(R + 10 * (mode == "async"))
    chip = ses.program_edges(rng.integers(-60, 60, g.n_edges),
                             rng.integers(-15, 15, g.n_nodes))
    st = ses.init_state(ses.generator(R))
    sync = port_api.Sync(halo_every=math.inf, mode=mode, sweeps_per_launch=L)
    k5 = _engine(g, R, sync, chains, True)
    k1 = _engine(g, R, sync, chains, False)
    assert k5.loop_shape == k1.loop_shape == "fused"
    assert k5._resident and not k1._resident
    S = 3 * L
    betas = torch.as_tensor(rng.uniform(0.2, 1.8, (S, chains)),
                            dtype=torch.float32)
    rec = _Recorder(monkeypatch)
    a = k5.sample(chip, st.m, st.noise_state, betas)
    assert len(rec.calls) == S // L
    assert all(kw["ex_pts"] == (0,) and kw["mode"] == mode
               and isinstance(kw["prepared"], sf.ExchangeTables)
               for _, kw, _ in rec.calls)
    assert len({id(kw["prepared"]) for _, kw, _ in rec.calls}) == 1
    b = k1.sample(chip, st.m, st.noise_state, betas)
    assert len(rec.calls) == S // L       # K1 per band: no K5 call
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    cm = torch.as_tensor(rng.random(g.n_nodes) < 0.1)
    cv = torch.as_tensor(np.where(rng.random((chains, g.n_nodes)) < 0.5,
                                  -1.0, 1.0), dtype=torch.float32)
    got = k5.stats(chip, st.m, st.noise_state, 0.8, S, 1, cm, cv)
    assert len(rec.calls) == 2 * S // L
    assert rec.calls[-1][0][16] is not None          # moments in K5
    want = k1.stats(chip, st.m, st.noise_state, 0.8, S, 1, cm, cv)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_kernel_fusible_policy_takes_k1_per_band_where_k5_has_no_body():
    """17 bands of the 64x64-cell lattice at 631 chains: no cluster of 17
    CTAs and no resident mailbox grid, so the launch-boundary policy runs
    K1 per band even with ``resident_exchange=True``; 630 chains fit."""
    g = make_chimera(64, 64)
    sync = port_api.Sync(halo_every=math.inf, sweeps_per_launch=4)
    assert _engine(g, 17, sync, 630, True)._resident
    assert not _engine(g, 17, sync, 631, True)._resident
