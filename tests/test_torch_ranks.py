"""The port's sharded p-bit engine across processes, held on the CPU by
gloo ranks.

* Two and four ranks (`_torch_port.run_ranks`: one spawn of each world
  size per module) run the cases of `_torch_ranks_cases.py` on rank meshes
  (`core.distributed.make_rank_mesh`); this process runs the same cases on
  the logical mesh of the same shape.  Every output is equal bit for bit
  on every rank — spins, noise state, moments, histograms, a program
  swap, faults, the CD step's weights — under the barrier and the relaxed
  policies, through the scan, K1 windows and K5's plain version on
  windows with the rank's edge halos supplied (``edge_halos="block"``).
  The lattice anneal's energies are summed across the ranks
  (`sparse_energy` with the engine): equal to one process's to 1e-6
  relative, float32 association (ROADMAP Queue 3 item 10).  Each rank's
  `RankComm` record of that anneal equals the dry run's trace of the same
  rank (`launch.dryrun.pbit_trace`, on meta under a fake group).
* The rows case with counter noise equals the reference's own 2-device
  engine (`run_forced_reference`), as
  `test_torch_shard_session.py::test_barrier_policy_equals_unsharded_reference`
  holds the logical mesh to the reference.
* K5's plain version on windows between exchange points, two groups of
  bands with ``edge_halos="block"`` and their edges swapped between
  windows, equals one launch over the joined bands.
* Every refusal: no process group, a world size that does not divide the
  mesh, ranks that split an axis the partition does not shard, NCCL with
  fewer cards than ranks.
"""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import ranks as ranks_mod
from repro_torch.core.cd import PBitMachine
from repro_torch.core.chimera import make_chimera
from repro_torch.core.distributed import (LatticeSpec, ShardedEngine,
                                          make_lattice_anneal, make_mesh,
                                          make_rank_mesh, make_sk_lattice)
from repro_torch.core.hardware import HardwareConfig
from repro_torch.kernels.ref import halo_exchange_segments
from repro_torch.kernels.shard_sweep import halo_exchange
from repro_torch.kernels.sweep_fused import sweep_sparse_exchange
from repro_torch.launch import dryrun

import _torch_ranks_cases as cases
from _torch_port import run_forced_reference, run_ranks

TESTS = str(Path(__file__).resolve().parent)

_RANK_SCRIPT = """
import sys
sys.path.insert(0, {tests!r})
import _torch_ranks_cases as cases
from repro_torch import api
from repro_torch.core.distributed import make_rank_mesh

def info(name, text):
    save("info/" + name, np.array(str(text)))

{body}

def refused(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""

info("refusal/world", refused(lambda: make_rank_mesh((WORLD + 1,), ("data",))))
g = cases.masked()
mach = cases.PBitMachine.create(g, 0, noise="counter", device="cpu")
info("refusal/axis", refused(lambda: cases.session(
    mach, make_rank_mesh((1, WORLD), ("data", "model")),
    partition=api.Partition(rows="data"))))
"""


def _one_process(run):
    """``run(make_mesh, save, info)`` in this process: (outputs, info)."""
    out, notes = {}, {}

    def save(name, *xs):
        out[name] = [x.detach().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x) for x in xs]

    run(make_mesh, save, lambda name, text: notes.__setitem__(name,
                                                              str(text)))
    return out, notes


def _notes(rank_out) -> dict:
    return {k[len("info/"):]: str(v[0]) for k, v in rank_out.items()
            if k.startswith("info/")}


def _assert_equal(got: dict, want: dict, prefix: str):
    keys = sorted(k for k in want if k.startswith(prefix)
                  and not k.startswith("approx/"))
    assert keys, prefix
    for k in keys:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# the spawns (one per world size) and the reference's 2-device run
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's row-sharded engine on 2 forced host devices."""
    return run_forced_reference(f"""
    import jax.numpy as jnp
    from repro import api
    from repro.core.cd import PBitMachine
    from repro.core.chimera import make_chimera

    g = make_chimera(4, 2, masked_cells=((3, 1),))
    mach = PBitMachine.create(g, jax.random.PRNGKey(0), noise="counter",
                              backend="sparse")
    ses0 = api.Session(mach.sampler_spec(chains={cases.B}))
    rng = np.random.default_rng(1)
    chip = ses0.program_edges(
        jnp.asarray(rng.integers(-60, 60, g.n_edges), jnp.int32),
        jnp.asarray(rng.integers(-15, 15, g.n_nodes), jnp.int32))
    m0 = ses0.random_spins(jax.random.PRNGKey(2))
    ns = ses0.noise_state(jax.random.PRNGKey(3))
    betas = jnp.linspace(0.3, 1.5, 5)
    save("problem", m0, ns, betas, *jax.tree_util.tree_leaves(chip))
    ses = api.Session(mach.sampler_spec(
        chains={cases.B}, mesh=auto_mesh((2,), ("data",)),
        partition=api.Partition(rows="data")))
    save("rows2/sample", *ses.sample(chip, m0, ns, betas, collect=True))
    cm = np.zeros(g.n_nodes, bool)
    cm[[0, 5, g.n_nodes - 1]] = True
    cv = np.ones(({cases.B}, g.n_nodes), np.float32)
    for tag, kw in (("cv", dict(clamp_mask=jnp.asarray(cm),
                                clamp_values=jnp.asarray(cv))),
                    ("cm", dict(clamp_mask=jnp.asarray(cm))), ("free", {{}})):
        save("rows2/stats_" + tag, *ses.stats(chip, m0, ns, 8, 2, **kw))
    save("rows2/hist", *ses.visible_hist(chip, m0, ns,
                                         np.array([0, 3, 9, 11]), 2, betas))
    """, 2, tmp_path_factory.mktemp("ranks_reference"))


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    """(each rank's outputs, this process's outputs, this process's info)
    of `two_rank_cases`."""
    m0, ns, betas, *chip = reference["problem"]
    inputs = {"m0": m0, "ns": ns, "betas": betas.astype(np.float32),
              "n_chip": np.array(len(chip)),
              **{f"chip{i}": a for i, a in enumerate(chip)}}
    body = "cases.two_rank_cases(make_rank_mesh, save, info, INPUTS)"
    ranks = run_ranks(_RANK_SCRIPT.format(tests=TESTS, body=body), 2,
                      tmp_path_factory.mktemp("two_ranks"), inputs)
    one, notes = _one_process(
        lambda mk, save, info: cases.two_rank_cases(mk, save, info, inputs))
    return ranks, one, notes


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    body = "cases.four_rank_cases(make_rank_mesh, save, info)"
    ranks = run_ranks(_RANK_SCRIPT.format(tests=TESTS, body=body), 4,
                      tmp_path_factory.mktemp("four_ranks"))
    one, notes = _one_process(cases.four_rank_cases)
    return ranks, one, notes


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------
TWO_RANK_GROUPS = (
    ["rows2/sample", "rows2/stats", "rows2/hist", "rows4_lfsr/"]
    + [f"rows{n}/{pol}/{route}" for n in (4, 2) for pol in cases.RELAXED
       for route in ("scan", "k1", "k5")]
    + ["swap/", "faults/barrier/", "faults/k3/", "anneal/"])


@pytest.mark.parametrize("prefix", TWO_RANK_GROUPS)
def test_two_ranks_equal_one_process(two_ranks, prefix):
    ranks, one, _ = two_ranks
    for rank_out in ranks:
        _assert_equal(rank_out, one, prefix)


def test_rows_counter_noise_equals_reference_two_devices(two_ranks,
                                                         reference):
    """2 gloo ranks, one band each, Sync(): sample with its trajectory,
    clamped stats three ways and visible_hist equal the reference's engine
    on 2 devices (spins, noise state, moments, histogram)."""
    ranks, _, _ = two_ranks
    want = {k: v for k, v in reference.items() if k != "problem"}
    assert len(want) == 5
    for rank_out in ranks:
        got = dict(rank_out)
        got["rows2/sample"] = list(got["rows2/sample"])
        # the noise state crosses as uint32 bit patterns
        got = {k: [a.view(np.uint32) if a.dtype == np.int32 else a
                   for a in v] for k, v in got.items()}
        _assert_equal(got, want, "rows2/")


def test_routes_and_transport(two_ranks, four_ranks):
    """The ranks carry boundary rows over gloo; a policy whose windows are
    whole sweeps runs K5 per card, one that splits a sweep K1 windows; the
    one-process engine runs one K5 launch where the ranks run windows."""
    for ranks, one_notes in ((two_ranks[0], two_ranks[2]),
                             (four_ranks[0], four_ranks[2])):
        for rank_out in ranks:
            notes = _notes(rank_out)
            for pol in ("k4", "inf_async", "k2_async"):
                assert notes[f"rows4/{pol}/k5"] == "k5 per card|gloo"
                assert one_notes[f"rows4/{pol}/k5"] == "k5|None"
            assert notes["rows4/k1_L2/k5"] == "k1 windows|gloo"
            for pol in cases.RELAXED:
                assert notes[f"rows4/{pol}/scan"] == "scan|gloo"
    notes = _notes(two_ranks[0][1])
    assert notes["rows2/transport"] == "gloo"
    assert notes["faults/barrier/backend"] == "sparse"


def test_auto_takes_the_fused_kernels_where_k5_runs_the_launch(two_ranks):
    """``auto`` and the engine's route ask one rule (`k5_runs`): across
    ranks a launch whose exchange points split a sweep runs K1 windows, so
    ``auto`` takes the scan there; one process runs that launch in one K5
    launch and takes the fused kernels; whole-sweep windows take them in
    both."""
    ranks, _, one_notes = two_ranks
    for rank_out in ranks:
        notes = _notes(rank_out)
        assert notes["auto/k1_L4/route"] == "k1 windows"
        assert notes["auto/k1_L4/backend"] == "sparse"
        assert notes["auto/k4_L4/route"] == "k5 per card"
        assert notes["auto/k4_L4/backend"] == "fused_sparse"
    assert one_notes["auto/k1_L4/route"] == "k5"
    assert one_notes["auto/k1_L4/backend"] == "fused_sparse"
    assert one_notes["auto/k4_L4/route"] == "k5"
    assert one_notes["auto/k4_L4/backend"] == "fused_sparse"


def test_relaxed_policies_are_not_the_barrier(two_ranks):
    """The relaxed policies sample against stale halos: their spins part
    from the barrier's (so the equalities above are not vacuous)."""
    ranks, one, _ = two_ranks
    barrier = ranks[0]["rows4/k1_L2/scan"][0]
    for pol in ("k4", "inf_async", "k2_async"):
        assert not np.array_equal(ranks[0][f"rows4/{pol}/k5"][0], barrier)


def test_lattice_anneal_on_two_ranks_equals_one_rank(two_ranks):
    """`make_lattice_anneal` on 2 ranks: the spins of the unsharded run;
    the energies, summed across the ranks, to 1e-6 relative."""
    ranks, one, _ = two_ranks
    spec = LatticeSpec(4, 2, chains=4)
    lat = make_sk_lattice(spec, torch.Generator().manual_seed(5),
                          HardwareConfig.ideal(), device="cpu")
    m, e = make_lattice_anneal(spec, None, n_sweeps=20, record_every=10,
                               device="cpu")(
        lat, torch.Generator().manual_seed(6), torch.linspace(0.1, 2.0, 20))
    for rank_out in ranks:
        np.testing.assert_array_equal(rank_out["anneal/m"][0], m.numpy())
        np.testing.assert_allclose(rank_out["approx/anneal/energies"][0],
                                   e.numpy(), rtol=1e-6)
    np.testing.assert_allclose(one["approx/anneal/energies"][0], e.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("rank", [0, 1])
def test_lattice_anneal_collectives_equal_the_dry_runs_trace(two_ranks,
                                                            rank):
    """Each gloo rank's `RankComm` record of the anneal above equals
    `launch.dryrun.pbit_trace` of the same rank, lattice and mesh (on
    meta, under a fake group) call for call and byte for byte by kind:
    its edge swaps as ``exchange`` and its gathers as ``all_gather``,
    though gloo moves a gather as an all-reduce."""
    ranks, _, _ = two_ranks
    got = json.loads(_notes(ranks[rank])["anneal/comm"])
    traced = dryrun.pbit_trace(cases.ANNEAL, {"data": 2}, ("data",), rank,
                               cases.ANNEAL_SWEEPS, cases.ANNEAL_EVERY)
    assert got == cases.comm_counts(traced["collectives"])
    assert got["calls"]["exchange"] == 2 * cases.ANNEAL_SWEEPS
    assert got["calls"]["all_gather"] == \
        2 * cases.ANNEAL_SWEEPS // cases.ANNEAL_EVERY


def test_refusals_inside_a_group(two_ranks, four_ranks):
    for ranks, world in ((two_ranks[0], 2), (four_ranks[0], 4)):
        for rank_out in ranks:
            notes = _notes(rank_out)
            assert "does not divide the mesh" in notes["refusal/world"]
            assert "does not shard" in notes["refusal/axis"]


# ---------------------------------------------------------------------------
# four ranks: 2 rows x 2 chains, and one band a rank
# ---------------------------------------------------------------------------
FOUR_RANK_GROUPS = (
    ["grid/sample", "grid/stats", "grid/hist", "grid_lfsr/",
     "cd_sparse/", "cd_fused_sparse/"]
    + [f"rows4/{pol}/{route}" for pol in cases.RELAXED
       for route in ("scan", "k1", "k5")])


@pytest.mark.parametrize("prefix", FOUR_RANK_GROUPS)
def test_four_ranks_equal_one_process(four_ranks, prefix):
    ranks, one, _ = four_ranks
    for rank_out in ranks:
        _assert_equal(rank_out, one, prefix)


def test_four_ranks_grid_transport(four_ranks):
    ranks, _, notes = four_ranks
    assert notes["grid/transport"] == "None"
    for rank_out in ranks:
        assert _notes(rank_out)["grid/transport"] == "gloo"


# ---------------------------------------------------------------------------
# K5's plain version: windows with edge_halos="block" == one launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["barrier", "async"])
@pytest.mark.parametrize("k", [2, 4, math.inf])
def test_windowed_block_k5_equals_one_launch(mode, k):
    """4 bands as two groups of 2 (two cards): each window of the policy's
    exchange points is one launch of each group with ``ex_pts=(0,)`` and
    ``edge_halos="block"``, the groups' facing edge halos swapped before
    it (async: the swap before; after the last window, the last one).
    The extended blocks, halo columns included, and the noise state equal
    one launch over all 4 bands."""
    g = make_chimera(4, 2)
    L, B = 4, cases.B
    sync = api.Sync(halo_every=k, mode=mode, sweeps_per_launch=L)
    ex_pts = sync.exchange_points()
    mach = PBitMachine.create(g, 3, noise="counter", device="cpu")
    eng = ShardedEngine(g, make_mesh((4,), ("data",)), api.Partition(),
                        "counter", 8, B, sync=sync, backend="fused_sparse",
                        device="cpu")
    chip, m, ns = cases.problem(api.Session(mach.sampler_spec(chains=B)), g,
                                21)
    p, d = eng._chip_parts(chip), eng._dev
    masks = d["upd"][:, 0], d["upd"][:, 1]
    m_loc = eng._m_parts(m)
    n_loc, H = eng.plan.n_loc, eng.plan.halo
    betas = torch.linspace(0.4, 1.2, L)[:, None].expand(L, B).contiguous()
    halos = halo_exchange(m_loc, d["send_up"], d["send_dn"])
    if mode == "barrier":
        halos = tuple(torch.zeros_like(x) for x in halos)
    m_ext = torch.cat([m_loc, *halos], dim=2)

    def launch(bands, m_e, b, noise, pts, edges):
        sel = slice(*bands)
        return sweep_sparse_exchange(
            m_e, _ext(d["nbr32"], 2 * H)[sel], *(x[sel] for x in (
                _ext(p["w"], 2 * H), *(_ext(p[n], 2 * H)
                                       for n in ("h", "gain", "off", "rg",
                                                 "co")),
                *(_ext(mk, 2 * H) for mk in masks))),
            b, noise, d["send_up"][sel].to(torch.int32),
            d["send_dn"][sel].to(torch.int32),
            coord_offset=(0, eng._col0[sel]), n_loc=n_loc, halo=H,
            ex_pts=pts, mode=mode, edge_halos=edges)

    want = launch((0, 4), m_ext, betas, ns, ex_pts, "zero")

    def facing(a, b):
        """What group a's last band and group b's first band swap."""
        last = a[-1].index_select(1, d["send_dn"][1])
        first = b[0].index_select(1, d["send_up"][2])
        return first, last     # a's new halo_dn, b's new halo_up

    def install(a, b, edges):
        a, b = a.clone(), b.clone()
        a[-1, :, n_loc + H:] = edges[0]
        b[0, :, n_loc:n_loc + H] = edges[1]
        return a, b

    a, b = m_ext[:2], m_ext[2:]
    noise, pend = ns, None
    for e, (h0, h1) in enumerate(halo_exchange_segments(ex_pts, 2 * L)):
        fresh = facing(a, b)
        if mode == "barrier":
            a, b = install(a, b, fresh)
        elif e > 0:
            a, b = install(a, b, pend)
        pend = fresh
        win = betas[h0 // 2:h1 // 2]
        a, na = launch((0, 2), a, win, noise, (0,), "block")[:2]
        b, nb = launch((2, 4), b, win, noise, (0,), "block")[:2]
        assert torch.equal(na, nb)
        noise = na
    if mode == "async":
        a, b = install(a, b, pend)
    got = torch.cat([a, b])
    assert torch.equal(got, want[0])
    assert torch.equal(noise, want[1])
    # the facing halos carry spins, the outer ones the lattice's zeros
    assert (got[1, :, n_loc + H:].abs() == 1).all()
    assert (got[0, :, n_loc:n_loc + H] == 0).all()


def _ext(x, pad):
    return torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], dim=-1)


def test_block_edges_keep_the_given_halos_and_zero_replaces_them():
    """One band, one launch: ``"zero"`` writes zeros into both halos at its
    exchange point; ``"block"`` keeps the columns it was given."""
    g = make_chimera(2, 2)
    B = 4
    mach = PBitMachine.create(g, 1, noise="counter", device="cpu")
    eng = ShardedEngine(g, make_mesh((1,), ("data",)), api.Partition(),
                        "counter", 8, B, backend="fused_sparse",
                        device="cpu")
    chip, m, ns = cases.problem(api.Session(mach.sampler_spec(chains=B)), g,
                                2)
    p, d = eng._chip_parts(chip), eng._dev
    n_loc, H = eng.plan.n_loc, eng.plan.halo
    given = torch.ones((1, B, 2 * H))
    m_ext = torch.cat([eng._m_parts(m), given], dim=2)
    outs = {}
    for edges in ("zero", "block"):
        outs[edges] = sweep_sparse_exchange(
            m_ext, _ext(d["nbr32"], 2 * H), _ext(p["w"], 2 * H),
            *(_ext(p[n], 2 * H) for n in ("h", "gain", "off", "rg", "co")),
            *(_ext(d["upd"][:, c], 2 * H) for c in (0, 1)),
            torch.ones((2, B)), ns, d["send_up"].to(torch.int32),
            d["send_dn"].to(torch.int32), n_loc=n_loc, halo=H, ex_pts=(0,),
            edge_halos=edges)[0]
    assert torch.equal(outs["zero"][..., n_loc:], torch.zeros_like(given))
    assert torch.equal(outs["block"][..., n_loc:], given)
    assert not torch.equal(outs["zero"], outs["block"])
    with pytest.raises(ValueError, match="edge_halos"):
        sweep_sparse_exchange(
            m_ext, _ext(d["nbr32"], 2 * H), _ext(p["w"], 2 * H),
            *(_ext(p[n], 2 * H) for n in ("h", "gain", "off", "rg", "co")),
            *(_ext(d["upd"][:, c], 2 * H) for c in (0, 1)),
            torch.ones((2, B)), ns, d["send_up"].to(torch.int32),
            d["send_dn"].to(torch.int32), n_loc=n_loc, halo=H, ex_pts=(0,),
            edge_halos="wrap")


# ---------------------------------------------------------------------------
# refusals without a group
# ---------------------------------------------------------------------------
def test_rank_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_rank_mesh((2,), ("data",))


@pytest.mark.parametrize("shape,world,grid", [
    ((4,), 2, (2,)), ((2, 2), 4, (2, 2)), ((4, 2), 2, (2, 1)),
    ((2, 3), 3, (1, 3)), ((6, 2), 4, (2, 2)), ((8,), 1, (1,))])
def test_rank_grid_splits_the_axes_in_order(shape, world, grid):
    assert ranks_mod.rank_grid(shape, world) == grid
    ids = ranks_mod.rank_ids(shape, grid)
    assert ids.shape == shape
    assert sorted(set(ids.reshape(-1).tolist())) == list(range(world))
    # each rank holds the same number of positions
    assert np.all(np.bincount(ids.reshape(-1)) == np.prod(shape) // world)


@pytest.mark.parametrize("shape,world", [((3,), 2), ((2, 2), 8), ((6,), 4)])
def test_a_world_that_does_not_divide_the_mesh_raises(shape, world):
    with pytest.raises(ValueError, match="does not divide the mesh"):
        ranks_mod.rank_grid(shape, world)


def test_nccl_with_fewer_cards_than_ranks_raises():
    """No card here: NCCL refuses before any group exists, and the pod
    example refuses with it (never a quiet turn to gloo)."""
    with pytest.raises(RuntimeError, match="NCCL runs one card a rank"):
        ranks_mod.require_cards("nccl", 2)
    ranks_mod.require_cards("gloo", 2)
    sys.path.insert(0, str(Path(TESTS).parent / "examples_torch"))
    try:
        import pbit_lattice_pod
    finally:
        sys.path.pop(0)
    with pytest.raises(RuntimeError, match="NCCL runs one card a rank"):
        pbit_lattice_pod.main(["--ranks", "2", "--backend", "nccl"])


def test_fingerprint_keys_the_ranks():
    """A spec on a rank mesh keys apart from the same shape's logical mesh
    and from another split of the ranks."""
    import dataclasses

    g = make_chimera(4, 2)
    mach = PBitMachine.create(g, 0, noise="counter", device="cpu")
    logical = make_mesh((4,), ("data",))
    prints = [mach.sampler_spec(chains=8, mesh=mesh).fingerprint()
              for mesh in (logical,
                           dataclasses.replace(logical,
                                               ranks=np.array([0, 0, 1, 1])),
                           dataclasses.replace(logical,
                                               ranks=np.array([0, 1, 2, 3])))]
    assert len(set(prints)) == 3
