"""The slot-layout engine's plan on Hopper (K1 and K4), on the CPU.

`sparse_plan` picks K1's body by shape: the resident body (one thread per
(chain, node) of a colour, node tables in registers, a barrier per chain)
for D = 6 up to `MAX_RESIDENT_N` spins, the strided body, tiled exactly as
before the resident body existed, for everything else.  The kernels
themselves run only on the card (``chip_smoke.py`` holds both bodies
against the plain version there); these tests pin the plan.
"""
import numpy as np
import pytest

from repro_torch.core.chimera import make_chimera, make_chip_graph
from repro_torch.kernels import sweep_fused as sf

H100 = sf.H100


def strided_before(N, B, C=0, block_b=None):
    """The strided tiling as the wrappers computed it before `sparse_plan`:
    enough blocks to cover the SMs at up to 8 chains each, one thread a
    node up to 1024."""
    tb = min(8, -(-B // H100.sms)) if block_b is None else block_b
    tb = max(1, min(tb, B))
    while ((tb * N + 15) & ~15) + 4 * tb * C > H100.smem_per_block:
        tb -= 1
    return tb, min(1024, max(64, 32 * -(-N // 32)))


@pytest.mark.parametrize("B", [5, 16, 256])
@pytest.mark.parametrize("noise", ["counter", "lfsr"])
def test_chip_shapes_take_the_resident_body(B, noise):
    g = make_chip_graph()
    C = 56 if noise == "lfsr" else 0
    plan = sf.sparse_plan(g.n_nodes, B, 6, C, noise)
    assert plan.body == "resident"
    assert 1 <= plan.chains <= sf.MAX_RESIDENT_CHAINS
    # whole warps per chain, every node of the larger colour in a lane
    lanes = plan.threads // plan.chains
    assert plan.threads == plan.chains * lanes
    assert lanes % 32 == 0
    assert lanes >= max(int((g.color == c).sum()) for c in (0, 1))
    assert lanes == sf.resident_lanes(g.n_nodes) == 224
    assert plan.threads <= sf.MAX_RESIDENT_THREADS <= 1024
    assert plan.chains == min(-(-B // H100.sms),
                              sf.MAX_RESIDENT_THREADS // 224)
    assert plan.smem_bytes == sf.resident_smem_bytes(
        plan.chains, g.n_nodes, C, noise == "lfsr")


@pytest.mark.parametrize("N,B,C", [
    (8192, 256, 0), (32768, 256, 0), (4608, 256, 0), (8192, 5, 0),
    (32768, 256, 4096)])
def test_lattices_and_bands_keep_the_strided_tiling(N, B, C):
    """The 8192- and 32768-spin lattices and the sharded engine's bands
    (4608 extended columns) launch exactly as before."""
    noise = "lfsr" if C else "counter"
    plan = sf.sparse_plan(N, B, 6, C, noise)
    assert plan.body == "strided"
    assert (plan.chains, plan.threads) == strided_before(N, B, C)
    assert plan.smem_bytes == sf.strided_smem_bytes(plan.chains, N, C)


@pytest.mark.parametrize("N,B,block_b,body,tb", [
    (440, 256, 1, "resident", 1),
    (440, 256, 2, "resident", 2),
    (440, 256, 8, "resident", 2),      # capped: 2 chains of 224 lanes
    (120, 5, 3, "resident", 3),
    (440, 2, 8, "resident", 2),        # no more chains than there are
    (8192, 256, 5, "strided", 5),
    (4608, 256, 1, "strided", 1),
])
def test_block_b_asks_for_the_chains_per_block(N, B, block_b, body, tb):
    plan = sf.sparse_plan(N, B, 6, block_b=block_b)
    assert (plan.body, plan.chains) == (body, tb)
    if body == "strided":
        assert (plan.chains, plan.threads) == strided_before(
            N, B, block_b=block_b)


def test_resident_chains_stay_within_the_named_barriers():
    # 64 spins: P = 32 lanes, so 16 chains would fit 512 threads; a block
    # has 15 named barriers for its chains
    plan = sf.sparse_plan(64, 4096, 6, block_b=64)
    assert plan.body == "resident"
    assert plan.chains == sf.MAX_RESIDENT_CHAINS
    assert plan.threads == sf.MAX_RESIDENT_CHAINS * 32


@pytest.mark.parametrize("D", [4, 5, 7])
def test_other_slot_counts_take_the_strided_body(D):
    """The resident body compiles its tables for D = 6; any other slot
    count (the one-cell graph has 4) takes the strided body."""
    for N in (8, 440):
        plan = sf.sparse_plan(N, 256, D)
        assert plan.body == "strided"
        assert (plan.chains, plan.threads) == strided_before(N, 256)
    g = make_chimera(1, 1)
    assert g.neighbor_table()[0].shape[0] == 4


def test_the_resident_limit_in_n():
    at = sf.sparse_plan(sf.MAX_RESIDENT_N, 256, 6)
    past = sf.sparse_plan(sf.MAX_RESIDENT_N + 8, 256, 6)
    assert at.body == "resident"
    assert at.chains == 1 and at.threads == sf.MAX_RESIDENT_THREADS
    assert past.body == "strided"
    assert (past.chains, past.threads) == strided_before(
        sf.MAX_RESIDENT_N + 8, 256)
    # the graphs chip_smoke.py reaches the two sides with are degree 6
    for cols in (sf.MAX_RESIDENT_N // 8, sf.MAX_RESIDENT_N // 8 + 1):
        assert make_chimera(1, cols).neighbor_table()[0].shape[0] == 6


def test_lfsr_registers_count_in_shared_memory():
    g = make_chip_graph()
    N, C = g.n_nodes, 56
    counter = sf.sparse_plan(N, 256, 6, 0, "counter", block_b=2)
    lfsr = sf.sparse_plan(N, 256, 6, C, "lfsr", block_b=2)
    # the eight-step table and two buffers of two chains' registers
    assert lfsr.smem_bytes - counter.smem_bytes == 4 * (256 + 2 * 2 * C)
    # a card where two chains fit with counter noise but not with their
    # registers: the LFSR plan takes one
    tight = H100._replace(smem_per_block=counter.smem_bytes + 1024)
    assert sf.sparse_plan(N, 256, 6, 0, "counter", tight, 2).chains == 2
    assert sf.sparse_plan(N, 256, 6, C, "lfsr", tight, 2).chains == 1
    assert (sf.resident_smem_bytes(1, N, C, True) <= tight.smem_per_block
            < sf.resident_smem_bytes(2, N, C, True))
    # strided: 4 bytes a register a chain
    s0 = sf.sparse_plan(8192, 256, 6, 0, "counter")
    s1 = sf.sparse_plan(8192, 256, 6, 1024, "lfsr")
    assert s1.smem_bytes - s0.smem_bytes == 4 * s1.chains * 1024


@pytest.mark.parametrize("N,C,body", [
    (64, 32, "resident"), (64, 33, "strided"),
    (440, 56, "resident"), (440, 224, "resident"), (440, 225, "strided")])
def test_lfsr_registers_take_at_most_one_lane_each(N, C, body):
    """The resident body steps each of a chain's LFSR registers in one of
    its P lanes; more registers than lanes take the strided body.  The
    chip graph's 56 registers (one a cell) fit its 224 lanes."""
    plan = sf.sparse_plan(N, 256, 6, C, "lfsr")
    assert plan.body == body
    if body == "strided":
        assert (plan.chains, plan.threads) == strided_before(N, 256, C)
    assert sf.sparse_plan(N, 256, 6, 0, "counter").body == "resident"


@pytest.mark.parametrize("noise,C,message", [
    ("counter", 0, "N=8192 spins is too large for one block; shard the "
                   "lattice"),
    ("lfsr", 1024, "N=8192 spins (plus 1024 LFSR registers) is too large "
                   "for one block; shard the lattice"),
])
def test_a_chain_that_does_not_fit_raises(noise, C, message):
    small = H100._replace(smem_per_block=4096)
    with pytest.raises(ValueError) as err:
        sf.sparse_plan(8192, 256, 6, C, noise, small)
    want = 8192 + 4 * C
    assert str(err.value) == (
        f"one chain needs {want} bytes of shared memory, a block can use "
        f"4096 on this card: {message}")


@pytest.mark.parametrize("N", [8, 120, 440, 1024, 1025])
def test_resident_lanes_cover_half_the_nodes_in_whole_warps(N):
    P = sf.resident_lanes(N)
    assert P % 32 == 0 and P >= -(-N // 2) and P - 32 < max(-(-N // 2), 1)
    assert np.all([sf.resident_lanes(n) <= sf.resident_lanes(N)
                   for n in range(1, N)])
