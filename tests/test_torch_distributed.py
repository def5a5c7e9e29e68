"""Port vs reference: the row-band partition plan, the sharding value
objects and the SK lattice.

Everything here is integer or numpy bookkeeping, or pure gathers, so the
rule is equality: `plan_row_partition` (node bands, neighbour tables,
boundary send lists, edge bands, LFSR cell bands) array-equal to the
reference's for the 440-spin chip at 1-7 bands and for 4x4 / 8x2
lattices; `halo_bytes_per_sweep`, `Sync` and `Partition` over a property
grid; the spec's validation errors and the sharded backend resolution;
`lattice_to_chip` on the reference's `make_sk_lattice` arrays.
`sparse_energy` sums over nodes in each framework's own order: bit-equal
where every order is exact (dyadic couplings), to float32 rounding on the
reference's Gaussian arrays.  `make_sk_lattice` draws from a
`torch.Generator` and agrees in distribution only.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import distributed as ref_dist
from repro.core.cd import PBitMachine as RefMachine
from repro.core.chimera import make_chimera, make_chip_graph
from repro.core.hardware import HardwareConfig as RefHW
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch.core import distributed as port_dist
from repro_torch.core.cd import PBitMachine as PortMachine
from repro_torch.core.hardware import HardwareConfig as PortHW

from _torch_port import leaves, port_chip

PLAN_FIELDS = [f.name for f in dataclasses.fields(port_dist.RowPartition)]


def _assert_plans_equal(p, r):
    for name in PLAN_FIELDS:
        a, b = getattr(p, name), getattr(r, name)
        assert (a is None) == (b is None), name
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("with_lfsr", [False, True], ids=["counter", "lfsr"])
@pytest.mark.parametrize("n_shards", range(1, 8))
def test_chip_plan_matches_reference(n_shards, with_lfsr):
    """The 440-spin chip (7x8 cells, cell (6, 7) masked) cut into 1..7
    bands: every table of the plan equals the reference's."""
    g = make_chip_graph()
    assert (6, 7) in g.masked_cells
    _assert_plans_equal(port_dist.plan_row_partition(g, n_shards, with_lfsr),
                        ref_dist.plan_row_partition(g, n_shards, with_lfsr))


@pytest.mark.parametrize("rows,cols,n_shards",
                         [(4, 4, 1), (4, 4, 2), (4, 4, 4), (8, 2, 2),
                          (8, 2, 3), (8, 2, 8)])
def test_lattice_plans_match_reference(rows, cols, n_shards):
    g = make_chimera(rows, cols)
    for with_lfsr in (False, True):
        _assert_plans_equal(
            port_dist.plan_row_partition(g, n_shards, with_lfsr),
            ref_dist.plan_row_partition(g, n_shards, with_lfsr))


def test_plan_covers_the_graph_through_its_halos():
    """Each band's extended table names the same global neighbours as the
    graph's own table (the reference's coverage test, on the port's plan)."""
    g = make_chimera(5, 3, masked_cells=((2, 1),))
    for n_shards in (2, 3, 5):
        p = port_dist.plan_row_partition(g, n_shards, with_lfsr=True)
        assert sorted(p.part_ids[p.valid].tolist()) == list(range(g.n_nodes))
        assert np.array_equal(p.part_ids.reshape(-1)[p.inv_ids],
                              np.arange(g.n_nodes))
        nbr_g, _ = g.neighbor_table()
        H, n_loc = p.halo, p.n_loc
        for d in range(n_shards):
            ext = np.full((n_loc + 2 * H,), -1, np.int64)
            ext[:n_loc] = p.part_ids[d]
            if d > 0:
                ext[n_loc:n_loc + H] = p.part_ids[d - 1][p.send_dn[d - 1]]
            if d < n_shards - 1:
                ext[n_loc + H:] = p.part_ids[d + 1][p.send_up[d + 1]]
            got = ext[p.nbr_idx[d][:, p.valid[d]]]
            np.testing.assert_array_equal(
                got, nbr_g[:, p.part_ids[d][p.valid[d]]])
        assert np.unique(p.edge_inv).size == g.n_edges


def test_plan_memo_and_invalid_band_counts():
    g = make_chimera(6, 2)
    port_dist.clear_plan_cache()
    p3 = port_dist.plan_row_partition(g, 3)
    p2 = port_dist.plan_row_partition(g, 2)
    assert port_dist.plan_cache_stats() == {"hits": 0, "misses": 2}
    assert port_dist.plan_row_partition(g, 2) is p2
    assert port_dist.plan_row_partition(g, 3) is p3
    assert port_dist.plan_cache_stats() == {"hits": 2, "misses": 2}
    port_dist.plan_row_partition(g, 2, with_lfsr=True)
    port_dist.plan_row_partition(make_chimera(6, 2, masked_cells=((1, 1),)),
                                 2)
    assert port_dist.plan_cache_stats()["misses"] == 4
    for bad in (0, 7):
        with pytest.raises(ValueError, match="cell rows"):
            port_dist.plan_row_partition(g, bad)
    assert port_dist.plan_cache_stats()["misses"] == 4
    port_dist.clear_plan_cache()
    assert port_dist.plan_cache_stats() == {"hits": 0, "misses": 0}


SYNC_GRID = [(k, mode, S) for S in range(1, 7)
             for k in list(range(1, 10)) + [math.inf]
             for mode in ("barrier", "async")]


def _sync_facts(sync):
    return (sync.exchange_points(), sync.kernel_fusible,
            sync.fused_compatible, sync.bit_exact, sync.launch_resident,
            sync.exchanges_per_sweep(), sync.exchanges_per_sweep(True))


def test_sync_property_grid_matches_reference():
    for k, mode, S in SYNC_GRID:
        p = port_api.Sync(halo_every=k, mode=mode, sweeps_per_launch=S)
        r = ref_api.Sync(halo_every=k, mode=mode, sweeps_per_launch=S)
        assert _sync_facts(p) == _sync_facts(r), (k, mode, S)
        assert p.exchange_points()[0] == 0


@pytest.mark.parametrize("kw,match", [
    (dict(halo_every=0), "halo_every"), (dict(halo_every=2.5), "halo_every"),
    (dict(mode="eventual"), "mode"), (dict(sweeps_per_launch=0),
                                      "sweeps_per_launch")])
def test_sync_validation_matches_reference(kw, match):
    with pytest.raises(ValueError) as want:
        ref_api.Sync(**kw)
    with pytest.raises(ValueError, match=match) as got:
        port_api.Sync(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rows,chains", [
    ("data", None), (("a", "b"), None), (None, "c"), ("r", ("c", "d")),
    (None, None)])
def test_partition_axes_match_reference(rows, chains):
    p = port_api.Partition(rows=rows, chains=chains)
    r = ref_api.Partition(rows=rows, chains=chains)
    assert (p.rows_axes, p.chain_axes) == (r.rows_axes, r.chain_axes)
    assert port_api.Partition() == port_api.Partition(rows="data")


@pytest.mark.parametrize("refresh", [False, True])
def test_halo_bytes_per_sweep_matches_reference(refresh):
    for rows, cols, n_shards in ((16, 16, 4), (7, 8, 3), (4, 4, 2)):
        g = make_chimera(rows, cols)
        p = port_dist.plan_row_partition(g, n_shards)
        r = ref_dist.plan_row_partition(g, n_shards)
        for k, mode, S in SYNC_GRID[::7]:
            got = port_dist.halo_bytes_per_sweep(
                p, 64, refresh, port_api.Sync(halo_every=k, mode=mode,
                                              sweeps_per_launch=S))
            want = ref_dist.halo_bytes_per_sweep(
                r, 64, refresh, ref_api.Sync(halo_every=k, mode=mode,
                                             sweeps_per_launch=S))
            assert got == want
        assert port_dist.halo_bytes_per_sweep(p, 64, refresh) == \
            ref_dist.halo_bytes_per_sweep(r, 64, refresh)


class FakeMesh:
    """The parts of a mesh the spec's validation reads."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


def _specs(g, mesh, **kw):
    """The same spec in both packages (the reference's mismatch arrays)."""
    kw.setdefault("noise", "counter")
    kw.setdefault("backend", "sparse")
    chains = kw.pop("chains", 8)
    ref = RefMachine.create(g, jax.random.PRNGKey(0), RefHW(),
                            noise=kw["noise"], backend=kw["backend"])
    port = PortMachine(graph=g, hw=PortHW(),
                       mismatch=convert.mismatch_from_numpy(
                           leaves(ref.mismatch), "cpu"),
                       noise=kw["noise"], backend=kw["backend"],
                       device="cpu")
    extra = {k: v for k, v in kw.items() if k not in ("noise", "backend")}
    sync = extra.pop("sync", None)
    partition = extra.pop("partition", None)
    r = ref.sampler_spec(chains=chains, mesh=mesh, **extra,
                         partition=None if partition is None
                         else ref_api.Partition(**partition),
                         sync=None if sync is None
                         else ref_api.Sync(**sync))
    p = port.sampler_spec(chains=chains, mesh=mesh, **extra,
                          partition=None if partition is None
                          else port_api.Partition(**partition),
                          sync=None if sync is None
                          else port_api.Sync(**sync))
    return p, r


VALIDATION_CASES = {   # mesh, spec fields, what both errors name
    "partition_without_mesh": (None, dict(partition=dict()), "mesh=None"),
    "sync_without_mesh": (None, dict(sync=dict()), "mesh=None"),
    "axis_not_in_mesh": ("data", dict(partition=dict(rows="rows")),
                         "not in mesh axes"),
    "philox": ("data", dict(noise="philox"), "counter"),
    "infeasible_window": ("data", dict(backend="fused_sparse", sync=dict(
        halo_every=6, sweeps_per_launch=4)), "nearest legal Sync"),
    "fused_lfsr": ("data", dict(backend="fused_sparse", noise="lfsr",
                                sync=dict(halo_every=2,
                                          sweeps_per_launch=2)),
                   "noise='counter'"),
    "axes_not_disjoint": ("data", dict(partition=dict(rows="data",
                                                      chains="data")),
                          "disjoint"),
    "shards_nothing": ("data", dict(partition=dict(rows=None,
                                                   chains=None)),
                       "shards nothing"),
    "dense_backend": ("data", dict(backend="fused"),
                      "backend must be 'sparse', 'fused_sparse', or 'auto'"),
    "chains_not_divisible": ("data2", dict(partition=dict(
        rows=None, chains="data"), chains=7), "not divisible"),
    "too_many_bands": ("data3", dict(), "cannot shard 2 cell rows"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_spec_validation_errors_match_reference(case):
    mesh_kind, kw, phrase = VALIDATION_CASES[case]
    mesh = {None: None, "data": FakeMesh(data=1),
            "data2": FakeMesh(data=2), "data3": FakeMesh(data=3)}[mesh_kind]
    p, r = _specs(make_chimera(2, 2), mesh, **kw)
    with pytest.raises(ValueError) as want:
        r.validate()
    with pytest.raises(ValueError) as got:
        p.validate()
    assert phrase in str(want.value) and phrase in str(got.value)


def test_legal_sharded_specs_validate():
    g = make_chimera(2, 2)
    for kw in (dict(), dict(backend="fused_sparse"),
               dict(backend="fused_sparse",
                    sync=dict(halo_every=2, sweeps_per_launch=4)),
               dict(partition=dict(rows=None, chains="data")),
               dict(noise="lfsr")):
        p, r = _specs(g, FakeMesh(data=2), **kw)
        r.validate()
        p.validate()


@pytest.mark.parametrize("noise", ["counter", "lfsr"])
@pytest.mark.parametrize("backend", ["auto", "sparse", "fused_sparse",
                                     "fused", "ref"])
def test_sharded_backend_resolution_matches_reference(noise, backend,
                                                      monkeypatch):
    monkeypatch.delenv("REPRO_PBIT_BACKEND", raising=False)
    g = make_chimera(2, 2)
    for k, mode, S in SYNC_GRID[::5]:
        p, r = _specs(g, FakeMesh(data=2), noise=noise, backend=backend,
                      sync=dict(halo_every=k, mode=mode,
                                sweeps_per_launch=S))
        try:
            want = ref_api.resolve_backend(r)
        except ValueError:
            with pytest.raises(ValueError):
                port_api.resolve_backend(p)
            continue
        assert port_api.resolve_backend(p) == want, (k, mode, S)


def test_auto_picks_the_exchange_kernel_for_launch_resident_policies():
    g = make_chimera(2, 2)
    mesh = port_dist.make_mesh((2,), ("data",))
    mach = PortMachine.create(g, 0, noise="counter", device="cpu")
    resolve = port_api.resolve_backend
    assert resolve(mach.sampler_spec(mesh=mesh)) == "sparse"
    assert resolve(mach.sampler_spec(mesh=mesh, sync=port_api.Sync(
        halo_every=2, sweeps_per_launch=4))) == "fused_sparse"
    assert resolve(mach.sampler_spec(mesh=mesh, sync=port_api.Sync(
        halo_every=math.inf, sweeps_per_launch=4))) == "fused_sparse"
    assert resolve(mach.sampler_spec(mesh=mesh, sync=port_api.Sync(
        halo_every=6, sweeps_per_launch=4))) == "sparse"


def test_auto_takes_the_scan_when_the_exchange_grid_does_not_fit():
    """K5 has two bodies.  The mailbox body's blocks wait for each other, so
    all of them must be resident: the 64x64-cell lattice on 8 bands has
    4608 extended columns a band, 1024 threads a block, one block per SM by
    the model's registers, at most 50 chains a block (shared memory), so
    16 tiles a band on 132 SMs hold 800 chains and 801 do not.  The cluster
    body (up to 16 bands, a cluster the R bands of a chain tile) waits only
    inside a cluster, so it runs any chain count in waves: 8 and 16 bands
    take it at 801 chains.  17 bands take the mailbox body (2560 columns,
    at most 90 chains a block, 7 tiles a band): 630 chains fit and 631 do
    not, and ``auto`` then picks the scan; a policy without mid-launch
    exchange stays fused (K5 with one exchange point where it fits, else
    K1 per band)."""
    from repro_torch.kernels import sweep_fused as port_sf

    g = make_chimera(64, 64)
    plan = port_dist.plan_row_partition(g, 8)
    N, H = plan.n_loc + 2 * plan.halo, plan.halo
    assert N == 4608
    # the mailbox body's model: the smallest tiling that fits is the one
    # the card's occupancy API chose at 256 chains, 16 chains a block
    per_sm = [port_sf.exchange_blocks_per_sm(tb, N) for tb in (15, 16, 50,
                                                               51)]
    assert per_sm == [1, 1, 1, 0]
    assert 8 * -(-256 // 15) > port_sf.H100.sms >= 8 * -(-256 // 16)
    # a slot count other than 6 leaves only the mailbox body
    def mailbox_fits(B, limits=port_sf.H100):
        return port_sf.exchange_resident_feasible(8, B, N, H, limits, D=5)
    assert mailbox_fits(800) and not mailbox_fits(801)
    # a card with half the SMs holds half the chains
    half = port_sf.H100._replace(sms=66)
    assert mailbox_fits(400, half) and not mailbox_fits(401, half)
    # the cluster body takes 8 and 16 bands at any chain count, on either
    # card
    for R, B, limits in ((8, 801, port_sf.H100), (8, 100_000, half),
                         (16, 801, port_sf.H100)):
        p = port_dist.plan_row_partition(g, R)
        Nr = p.n_loc + 2 * p.halo
        assert port_sf.exchange_resident_feasible(R, B, Nr, p.halo, limits)
        assert port_sf.exchange_plan(R, B, Nr, 6, limits=limits,
                                     halo=p.halo).body == "cluster"
    p17 = port_dist.plan_row_partition(g, 17)
    N17 = p17.n_loc + 2 * p17.halo
    assert (N17, p17.halo) == (2560, 256)
    assert port_sf.exchange_plan(17, 630, N17, 6, halo=256) \
        == port_sf.ExchangePlan("mailbox", 1, 90, 1024, 230400)
    assert port_sf.exchange_resident_feasible(17, 630, N17, 256)
    assert not port_sf.exchange_resident_feasible(17, 631, N17, 256)

    mach = PortMachine.create(g, 0, sparse=True, noise="counter",
                              device="cpu")
    k2 = port_api.Sync(halo_every=2, sweeps_per_launch=4)
    inf = port_api.Sync(halo_every=math.inf, sweeps_per_launch=4)
    resolve = port_api.resolve_backend
    for bands, fits, over in ((8, 800, 801), (17, 630, 631)):
        mesh = port_dist.make_mesh((bands,), ("data",))
        assert resolve(mach.sampler_spec(chains=fits, mesh=mesh, sync=k2)) \
            == "fused_sparse"
        assert resolve(mach.sampler_spec(chains=over, mesh=mesh, sync=k2)) \
            == ("fused_sparse" if bands <= 16 else "sparse")
        assert resolve(mach.sampler_spec(chains=over, mesh=mesh, sync=inf)) \
            == "fused_sparse"


def test_fingerprint_keys_mesh_partition_and_sync():
    g = make_chimera(2, 2)
    mach = PortMachine.create(g, 0, noise="counter", device="cpu")
    mesh2 = port_dist.make_mesh((2,), ("data",))
    base = mach.sampler_spec().fingerprint()
    a = mach.sampler_spec(mesh=mesh2).fingerprint()
    assert a != base
    assert a == mach.sampler_spec(
        mesh=port_dist.make_mesh((2,), ("data",)),
        partition=port_api.Partition(rows="data"),
        sync=port_api.Sync()).fingerprint()
    assert a != mach.sampler_spec(
        mesh=mesh2, sync=port_api.Sync(halo_every=2)).fingerprint()
    assert a != mach.sampler_spec(
        mesh=port_dist.make_mesh((2,), ("rows",)),
        partition=port_api.Partition(rows="rows")).fingerprint()
    assert a != mach.sampler_spec(
        mesh=port_dist.make_mesh((2,), ("data",), devices=[3, 4])
    ).fingerprint()


def test_make_mesh_mirrors_jax_make_mesh():
    mesh = port_dist.make_mesh((2, 3), ("r", "c"))
    ref = jax.make_mesh((1, 1), ("r", "c"))
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.shape == {"r": 2, "c": 3}
    assert mesh.devices.shape == (2, 3)
    np.testing.assert_array_equal(mesh.devices.reshape(-1), np.arange(6))
    one_card = port_dist.make_mesh((2,), ("data",),
                                   devices=["cuda:0", "cuda:0"])
    assert one_card.shape == {"data": 2}
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        port_dist.make_mesh((2,), ("data",), devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="devices"):
        port_dist.make_mesh((2,), ("data",), devices=[0])
    with pytest.raises(ValueError, match="axis"):
        port_dist.make_mesh((2, 2), ("data",))


def test_surviving_mesh_replans_over_survivors():
    mesh = port_dist.make_mesh((4,), ("data",))
    left = port_dist.surviving_mesh(mesh, [1])
    assert left.axis_names == ("data",) and left.shape == {"data": 3}
    np.testing.assert_array_equal(left.devices, [0, 2, 3])
    assert port_dist.surviving_mesh(mesh, [0, 1, 2]) is None
    with pytest.raises(RuntimeError, match="no devices survive"):
        port_dist.surviving_mesh(mesh, range(4))
    # the survivors' plan is the plan of the smaller band count
    g = make_chimera(6, 2)
    assert port_dist.plan_row_partition(g, left.shape["data"]) is \
        port_dist.plan_row_partition(g, 3)


# ---------------------------------------------------------------------------
# SK lattices
# ---------------------------------------------------------------------------
def _ref_lattice(R, C, seed=0, dyadic=False):
    spec = ref_dist.LatticeSpec(R, C, chains=4)
    lat = ref_dist.make_sk_lattice(spec, jax.random.PRNGKey(seed))
    arrays = {f.name: np.asarray(getattr(lat, f.name))
              for f in dataclasses.fields(lat)}
    if dyadic:   # every partial sum of such values is exact in float32
        arrays = {k: np.round(v * 16.0).astype(np.float32) / 16.0
                  for k, v in arrays.items()}
        lat = ref_dist.LatticeChip(**{k: jax.numpy.asarray(v)
                                      for k, v in arrays.items()})
    return spec, lat, arrays


@pytest.mark.parametrize("R,C", [(4, 4), (3, 5), (8, 2)])
def test_lattice_to_chip_matches_reference(R, C):
    spec, lat, arrays = _ref_lattice(R, C, seed=R * C)
    want = port_chip(ref_dist.lattice_to_chip(spec, lat))
    port_spec = port_dist.LatticeSpec(R, C, chains=4)
    got = port_dist.lattice_to_chip(
        port_spec, convert.lattice_from_numpy(arrays, "cpu"))
    for name in ("h", "tanh_gain", "tanh_offset", "rand_gain",
                 "comp_offset", "nbr_idx", "nbr_w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(), name)
    assert got.W is None and got.nbr_idx.dtype == torch.int32
    # leaves in field order convert the same way
    again = convert.lattice_from_numpy(leaves(lat), "cpu")
    for f in dataclasses.fields(again):
        np.testing.assert_array_equal(getattr(again, f.name).numpy(),
                                      arrays[f.name])


@pytest.mark.parametrize("dyadic", [True, False],
                         ids=["dyadic_exact", "gaussian"])
def test_sparse_energy_matches_reference(dyadic):
    """Dyadic couplings: every sum order is exact and the energies are
    equal bit for bit.  The reference's Gaussian arrays: the per-chain sum
    over nodes runs in each framework's own order, so equal to float32
    rounding (1e-6 relative)."""
    spec, lat, arrays = _ref_lattice(4, 4, seed=7, dyadic=dyadic)
    ref_chip = ref_dist.lattice_to_chip(spec, lat)
    chip = port_dist.lattice_to_chip(
        port_dist.LatticeSpec(4, 4, chains=4),
        convert.lattice_from_numpy(arrays, "cpu"))
    m = np.where(np.random.default_rng(3).random((6, spec.n_spins)) < 0.5,
                 -1.0, 1.0).astype(np.float32)
    want = np.asarray(ref_dist.sparse_energy(ref_chip, jax.numpy.asarray(m)))
    got = port_dist.sparse_energy(chip, torch.from_numpy(m)).numpy()
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_make_sk_lattice_shapes_and_distribution():
    spec = port_dist.LatticeSpec(16, 16, chains=2)
    gen = torch.Generator().manual_seed(0)
    lat = port_dist.make_sk_lattice(spec, gen, device="cpu")
    ref = ref_dist.make_sk_lattice(ref_dist.LatticeSpec(16, 16, chains=2),
                                   jax.random.PRNGKey(0))
    for f in dataclasses.fields(lat):
        a, b = getattr(lat, f.name), np.asarray(getattr(ref, f.name))
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        # same formula: equal spreads (to sampling error), same zero pattern
        np.testing.assert_allclose(float(a.std()), float(b.std()),
                                   rtol=0.15, atol=1e-6)
        assert torch.equal(a == 0, torch.from_numpy(b == 0)) or \
            f.name.startswith("W")
    assert float(lat.Wv_dn[-1].abs().max()) == 0.0      # no coupler past
    assert float(lat.Wh_rt[:, -1].abs().max()) == 0.0   # the lattice edge


def test_lattice_anneal_sharded_matches_single():
    """`make_lattice_anneal` through the shared engine: the 2-band run is
    bit-identical to the unsharded run (same generator seed, same counter
    stream), and the anneal lowers the energy."""
    spec = port_dist.LatticeSpec(4, 4, chains=2)
    lat = port_dist.make_sk_lattice(spec, torch.Generator().manual_seed(0),
                                    PortHW.ideal(), device="cpu")
    betas = torch.linspace(0.1, 2.0, 20)
    runs = []
    for mesh in (None, port_dist.make_mesh((2,), ("data",)),
                 port_dist.make_mesh((4,), ("data",))):
        run = port_dist.make_lattice_anneal(spec, mesh, n_sweeps=20,
                                            record_every=10, device="cpu")
        runs.append(run(lat, torch.Generator().manual_seed(1), betas))
    for m, e in runs[1:]:
        assert torch.equal(m, runs[0][0]) and torch.equal(e, runs[0][1])
    assert runs[0][1].shape == (2,) and float(runs[0][1][-1]) < 0
    with pytest.raises(ValueError, match="record_every"):
        port_dist.make_lattice_anneal(spec, None, n_sweeps=25,
                                      record_every=10, device="cpu")
