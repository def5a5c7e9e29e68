"""The dense engine's plan on Hopper and its statistics, on the CPU.

* `dense_plan` picks K3's body by shape: the cluster body (W's rows in the
  shared memory of a thread-block cluster) at the smallest cluster that
  holds them, the streamed body (W from L2) beyond; ``block_b`` keeps its
  meaning (chains per tile), narrowing `CLUSTER_SIZES` narrows the choice
  and a shape that fits nowhere raises.
* `dense_record_windows` splits a launch whose spin record would outgrow
  its memory into windows of sweeps; chained through `run_windows` with
  the plain version they give the same bits as one window.
* The plain version with fractional ``measured`` weights against the
  reference's `sweep_fused_pallas` (interpret mode): float tolerance, since
  the reference's compiled accumulation may fuse a multiply and an add;
  the kernel's equality with the plain version for such weights is
  checked on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sweep_fused import sweep_fused_pallas
from repro_torch import convert
from repro_torch.kernels import sweep_fused as port_sf
from repro_torch.kernels.sweep_fused import sweep_fused_ref

from test_torch_dense import S, DenseProblem

H100 = port_sf.H100


@pytest.mark.parametrize("N,k,chains,ctas", [
    (8, 1, 2, 128), (440, 8, 16, 128), (600, 8, 8, 256)])
def test_plan_takes_the_smallest_cluster_that_covers_the_chains(N, k, chains,
                                                               ctas):
    plan = port_sf.dense_plan(N, 256)
    assert plan.body == "cluster"
    assert (plan.cluster_size, plan.chains) == (k, chains)
    assert plan.smem_bytes == port_sf.cluster_smem_bytes(k, chains, N)
    assert plan.smem_bytes <= H100.smem_per_block
    assert plan.threads % 32 == 0 and 256 <= plan.threads <= 512
    assert -(-256 // chains) * k == ctas
    # up to N = 440 one wave covers the card; at N = 600 no cluster size
    # covers 256 chains at once (the float spins leave room for 8 chains
    # a cluster of 8), so the smallest of the fewest waves
    if N == 440:
        limit = H100.smem_per_block
        assert port_sf.cluster_smem_bytes(4, 1, N) <= limit
        # 4 CTAs hold W, but only 4 chains a cluster: 64 clusters > 33
        assert port_sf.cluster_smem_bytes(4, 5, N) > limit
        assert port_sf.cluster_smem_bytes(2, 1, N) > limit


def test_plan_takes_the_cluster_the_card_holds_in_one_wave(monkeypatch):
    """With the clusters an H100 holds at once (30 of 4 CTAs, 15 of 8, 7
    of 16 at these shapes, fewer than ``sms // k``), 8 chains per 4-CTA
    cluster would take two waves at N = 440: 8-CTA clusters of 18 chains
    take one.  Where no size covers the chains in one wave, the fewest
    waves win; a few chains keep the smallest cluster."""
    held = {1: 1056, 2: 60, 4: 30, 8: 15, 16: 7}
    resident = lambda plan: held[plan.cluster_size]  # noqa: E731
    plan = port_sf.dense_plan(440, 256, resident=resident)
    assert (plan.cluster_size, plan.chains) == (8, 18)
    assert -(-256 // 18) <= 15
    plan = port_sf.dense_plan(600, 256, resident=resident)
    assert (plan.cluster_size, plan.chains) == (16, 24)   # 2 waves, not 3
    assert port_sf.dense_plan(440, 16, resident=resident).cluster_size == 4
    monkeypatch.setattr(port_sf, "CLUSTER_SIZES", (4,))
    four = port_sf.dense_plan(440, 256, resident=resident)
    # 9 chains would be one wave, but the spins pad to 4 chains: 5..8 take
    # the room of 8, which does not fit
    assert four.chains == 4


@pytest.mark.parametrize("N,B,body,k", [
    (600, 256, "cluster", 16), (800, 256, "streamed", 1),
    (864, 256, "streamed", 1), (864, 64, "cluster", 16),
    (864, 16, "cluster", 16)])
def test_plan_streams_w_where_clusters_take_many_waves(N, B, body, k):
    """With the clusters an H100 holds at once, the cluster body covers
    256 chains at N = 600 in 2 waves, at N = 800 in 5 and at N = 864 in
    10: past `MAX_CLUSTER_WAVES` the streamed body runs; 64 and 16 chains
    at N = 864 take 3 waves and 1."""
    held = {1: 1056, 2: 60, 4: 30, 8: 15, 16: 7}
    resident = lambda plan: held[plan.cluster_size]  # noqa: E731
    plan = port_sf.dense_plan(N, B, resident=resident)
    assert (plan.body, plan.cluster_size) == (body, k)
    if body == "cluster":
        waves = -(-(-(-B // plan.chains)) // held[k])
        assert waves <= port_sf.MAX_CLUSTER_WAVES
    assert port_sf.dense_resident_feasible(N, B)


@pytest.mark.parametrize("N", [1152, 3620])
def test_plan_streams_w_beyond_the_largest_cluster(N):
    plan = port_sf.dense_plan(N, 256)
    assert plan.body == "streamed" and plan.cluster_size == 1
    assert plan.smem_bytes == port_sf.dense_smem_bytes(plan.chains, N)
    assert port_sf.cluster_smem_bytes(16, 1, N) > H100.smem_per_block
    assert port_sf.dense_resident_feasible(N, 256)


def test_plan_block_b_and_cluster_size(monkeypatch):
    # block_b: chains per tile, of a cluster or of a block
    assert port_sf.dense_plan(440, 256, block_b=3).chains == 3
    assert port_sf.dense_plan(1152, 256, block_b=3).chains == 3
    assert port_sf.dense_plan(440, 5, block_b=8).chains == 5
    # a card with less shared memory needs a larger cluster
    small = H100._replace(smem_per_block=100 * 1024)
    assert port_sf.dense_plan(440, 256, limits=small).cluster_size == 16
    # the sizes are read at each call: a diagnostic narrows them; the
    # chains of another cluster size cover the SMs again
    monkeypatch.setattr(port_sf, "CLUSTER_SIZES", (16,))
    plan = port_sf.dense_plan(440, 256)
    assert (plan.body, plan.cluster_size, plan.chains) == ("cluster", 16, 32)
    # LFSR registers take room: the tile shrinks where it must
    monkeypatch.setattr(port_sf, "CLUSTER_SIZES", (4,))
    lfsr = port_sf.dense_plan(440, 256, C=1000)
    assert lfsr.smem_bytes <= H100.smem_per_block and lfsr.chains == 3
    # no cluster size that holds W (or none at all): the streamed body
    for sizes in ((2,), ()):
        monkeypatch.setattr(port_sf, "CLUSTER_SIZES", sizes)
        plan = port_sf.dense_plan(440, 256)
        assert (plan.body, plan.cluster_size) == ("streamed", 1)


def test_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        port_sf.dense_plan(29100, 1)
    # a tile of one chain that no cluster and no streamed block holds
    tiny = H100._replace(smem_per_block=16 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        port_sf.dense_plan(2048, 1, limits=tiny)
    tiny = H100._replace(memory_bytes=8 * 1000)
    with pytest.raises(ValueError, match="record"):
        port_sf.dense_record_windows(10, 440, 256, tiny)


def test_record_windows_cover_the_launch():
    N, B = 440, 256
    per = N * port_sf.record_chains(B)
    assert port_sf.record_chains(B) == 256 and port_sf.record_chains(5) == 32
    assert port_sf.dense_record_windows(1000, N, B) == [(0, 1000)]
    card = H100._replace(memory_bytes=8 * (3 * per + 7))
    assert port_sf.dense_record_windows(10, N, B, card) == [
        (0, 3), (3, 6), (6, 9), (9, 10)]
    assert port_sf.dense_record_windows(0, N, B) == []


WEIGHTS = np.array([0.0, 0.37, 1.25, 0.0, 0.37, 1.25], np.float32)


def _stats_kw(p, what):
    if what == "moments":
        return dict(p.kw, accumulate=True), None
    return dict(p.kw, collect_hist=True, n_visible=3), [0, 5, 9]


@pytest.mark.parametrize("what", ["moments", "hist"])
@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_record_windows_equal_one_window(noise, what):
    """Three windows of two sweeps (a card whose record room holds two)
    through the plain version equal the unsplit launch bit for bit:
    spins, noise state and the carried statistics."""
    p = DenseProblem("masked", noise, 5, seed=31, clamp=True)
    kw, vis = _stats_kw(p, what)
    args = p.port_args()
    meas = torch.from_numpy(WEIGHTS)
    vis_t = None if vis is None else torch.tensor(vis, dtype=torch.int32)
    want = sweep_fused_ref(*args, meas, vis_t, **kw)
    n = p.g.n_nodes
    card = H100._replace(memory_bytes=8 * 2 * n * port_sf.record_chains(5))
    windows = port_sf.dense_record_windows(S, n, 5, card)
    assert windows == [(0, 2), (2, 4), (4, 6)]

    def launch(m, ns, betas, measured, stats_in):
        a = list(args)
        a[0], a[9], a[10] = m, betas, ns
        return sweep_fused_ref(*a, measured, vis_t, stats_in=stats_in, **kw)

    got = port_sf.run_windows(launch, windows, args[0], args[10], args[9],
                              meas)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["moments", "hist"])
@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_fractional_weights_match_reference_kernel(noise, what):
    """Weights 0.37 / 1.25 / 0: spins and noise state equal, statistics
    to float32 rounding."""
    p = DenseProblem("2x2", noise, 8, seed=33)
    kw, vis = _stats_kw(p, what)
    want = sweep_fused_pallas(
        *p.ref_args(), jnp.asarray(WEIGHTS),
        None if vis is None else jnp.asarray(vis, jnp.int32), block_b=8,
        interpret=True, **kw)
    got = sweep_fused_ref(
        *p.port_args(), torch.from_numpy(WEIGHTS),
        None if vis is None else torch.tensor(vis, dtype=torch.int32), **kw)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(convert.noise_state_to_numpy(got[1]),
                                  np.asarray(want[1]))
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    # the weights are fractional: the sums are not integers
    assert (got[2].numpy() % 1 != 0).any()
