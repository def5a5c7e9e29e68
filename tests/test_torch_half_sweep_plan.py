"""K2's launch plan and its per-sweep-function preparation, on the CPU.

`half_sweep_plan` (``kernels/pbit_update.py``) picks the dense half-sweep's
block tile, body and grid from (N, B, n_upd) and the card's limits; the
CUDA source (``csrc/pbit_update.cu``) launches what it says.  These tests
pin the plan at the paths' shapes (N=440 at 256 chains for training, 32
for the workloads), at ragged and tiny shapes, at empty and full update
lists, at the largest N whose rows stage whole and at rows that are not
16-byte aligned.  `PreparedHalfSweep`,
which ``kernels/ops.py::make_kernel_half_sweep`` builds once per colour
mask of a sweep function, holds the compacted update list; a CPU tensor
takes the plain version with or without it, and the result equals the
reference's Pallas kernel in interpret mode (dyadic couplings, so every
order of eqn 1's sum is exact; decisions within ``tanh``'s last place,
ROADMAP Queue 3 item 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pbit_update import pbit_half_sweep_pallas
from repro_torch.core import cd as port_cd
from repro_torch.core.chimera import make_chimera, make_chip_graph
from repro_torch.kernels import ops
from repro_torch.kernels.pbit_update import (
    MIN_WAVE_FILL,
    PreparedHalfSweep,
    half_sweep_plan,
    half_sweep_smem_bytes,
    pbit_half_sweep,
    pbit_half_sweep_ref,
    row_stride,
)
from repro_torch.kernels.sweep_fused import H100

CHIP_N = 440
CHIP_COLOUR = 220     # nodes of each colour of the 440-spin chip


def _grid_blocks(plan):
    return plan.grid[0] * plan.grid[1]


@pytest.mark.parametrize("B,tile,body", [
    (256, (16, 32, 2, 2, 128), "staged"),  # training
    (32, (8, 8, 2, 1, 32), "staged"),      # anneal and Max-Cut
    (37, (8, 8, 2, 1, 32), "staged"),      # a ragged chain tile
    (128, (16, 16, 2, 2, 64), "staged"),
    (64, (8, 16, 2, 2, 32), "staged"),
])
def test_plan_at_the_chip_size(B, tile, body):
    """Every block has updates (the grid comes from the list, not from N)
    and the grid covers `MIN_WAVE_FILL` of the card's SMs at both path
    shapes."""
    plan = half_sweep_plan(CHIP_N, B, CHIP_COLOUR)
    assert (plan.nodes, plan.chains, plan.reg_nodes, plan.reg_chains,
            plan.threads) == tile
    assert plan.body == body
    assert plan.grid == (-(-CHIP_COLOUR // plan.nodes), -(-B // plan.chains))
    assert (plan.grid[0] - 1) * plan.nodes < CHIP_COLOUR
    assert _grid_blocks(plan) >= MIN_WAVE_FILL * H100.sms
    assert plan.smem_bytes == half_sweep_smem_bytes(
        "staged", plan.nodes + plan.chains, CHIP_N) <= H100.smem_per_block
    # the tile the kernel derives from threads and warps_b
    warps = plan.threads // 32
    assert plan.nodes == 4 * plan.reg_nodes * (warps // plan.warps_b)
    assert plan.chains == 8 * plan.reg_chains * plan.warps_b


def test_the_path_shapes_spread_their_outputs():
    """At 32 chains the 7,040 outputs still reach most SMs; at both path
    shapes the largest tile whose grid covers `MIN_WAVE_FILL` of them is
    taken (112 blocks on 132 SMs), not a smaller one that would put more
    rows on an SM, nor a larger one that would leave SMs idle."""
    small = half_sweep_plan(CHIP_N, 32, CHIP_COLOUR)
    big = half_sweep_plan(CHIP_N, 256, CHIP_COLOUR)
    assert _grid_blocks(small) == 112 and _grid_blocks(big) == 112
    assert (small.nodes, small.chains) == (8, 8)
    assert (big.nodes, big.chains) == (16, 32)
    # the next larger tile at 32 chains, 8 x 16: 56 blocks
    assert -(-CHIP_COLOUR // 8) * (32 // 16) < MIN_WAVE_FILL * H100.sms
    more_sms = H100._replace(sms=160)
    assert half_sweep_plan(CHIP_N, 256, CHIP_COLOUR,
                           more_sms).chains == 16


def test_plan_at_tiny_and_edge_lists():
    tiny = half_sweep_plan(8, 5, 4)
    assert (tiny.nodes, tiny.chains, tiny.grid) == (4, 8, (1, 1))
    assert tiny.body == "staged"
    # an empty list still launches one block per chain tile: it copies
    empty = half_sweep_plan(CHIP_N, 256, 0)
    assert empty.grid == (1, 256 // empty.chains)
    full = half_sweep_plan(CHIP_N, 256, CHIP_N)
    assert (full.nodes, full.chains, full.threads) == (16, 32, 128)
    assert full.grid == (CHIP_N // 16 + 1, 8)


def test_largest_n_that_stages_whole():
    """At 256 chains and half the nodes updated the 16 x 32 tile stages 48
    rows; a row of N=1188 floats (stride 1188, 4 mod 32) fits a block's
    227 KB, one of 1189 (stride 1220) does not, so the plan takes the
    double-buffered column tiles there."""
    last = half_sweep_plan(1188, 256, 594)
    assert last.body == "staged" and last.nodes + last.chains == 48
    assert row_stride("staged", 1188) == 1188
    assert last.smem_bytes == 16 + 48 * 1188 * 4 <= H100.smem_per_block
    over = half_sweep_plan(1189, 256, 594)
    assert over.body == "tiled"
    assert row_stride("staged", 1189) == 1220
    assert half_sweep_smem_bytes("staged", 48, 1189) > H100.smem_per_block
    assert over.smem_bytes == 2 * 48 * (128 + 4) * 4
    for N in (1, 8, 437, 440, 441, 1152, 2048):
        assert row_stride("staged", N) % 32 == 4
        assert row_stride("staged", N) >= N


def test_unaligned_rows_take_the_tiled_body():
    """The staged body copies whole rows with 16-byte bulk copies: where N
    is not a multiple of 4, or W does not start at a 16-byte aligned
    address, the plan takes the tiled body, whose copies handle any
    alignment."""
    odd = half_sweep_plan(437, 32, 217)
    assert odd.body == "tiled" and (odd.nodes, odd.chains) == (8, 8)
    assert odd.smem_bytes == 2 * 16 * (128 + 4) * 4
    assert half_sweep_plan(436, 32, 217).body == "staged"
    assert half_sweep_plan(CHIP_N, 32, CHIP_COLOUR,
                           aligned=False).body == "tiled"
    m, W, rows, mask, u = _torch(*_operands(40, 6, 7))
    offset = torch.zeros(40 * 40 + 1)[1:].view(40, 40)
    offset.copy_(W)
    assert offset.data_ptr() % 16 != 0
    prep = PreparedHalfSweep(offset, *rows, mask, 6)
    assert prep.plan.body == "tiled"
    assert PreparedHalfSweep(W, *rows, mask, 6).plan.body == "staged"
    got = pbit_half_sweep(m, offset, *rows, mask, 0.9, u, prepared=prep)
    assert torch.equal(got, pbit_half_sweep_ref(m, W, *rows, mask, 0.9, u))


def _dyadic(rng, shape, scale):
    return (rng.integers(-scale, scale + 1, size=shape) / 256.0).astype(
        np.float32)


def _operands(N, B, seed, mask_kind="random"):
    """A dense W coupling any nodes, dyadic; rows, spins, noise, a mask."""
    rng = np.random.default_rng(seed)
    W = _dyadic(rng, (N, N), 16)
    np.fill_diagonal(W, 0.0)
    rows = [_dyadic(rng, N, 32),
            (1.0 + 0.1 * rng.normal(size=N)).astype(np.float32),
            (0.05 * rng.normal(size=N)).astype(np.float32),
            (1.0 + 0.05 * rng.normal(size=N)).astype(np.float32),
            (0.02 * rng.normal(size=N)).astype(np.float32)]
    m = (rng.integers(0, 2, size=(B, N)) * 2 - 1).astype(np.float32)
    u = ((rng.integers(0, 256, (B, N)) - 127.5) / 128.0).astype(np.float32)
    mask = {"random": rng.integers(0, 2, N).astype(bool),
            "none": np.zeros(N, bool), "all": np.ones(N, bool)}[mask_kind]
    return m, W, rows, mask, u


def _torch(m, W, rows, mask, u):
    tm = torch.from_numpy
    return tm(m), tm(W), [tm(r) for r in rows], tm(mask), tm(u)


@pytest.mark.parametrize("mask_kind", ["random", "none", "all"])
def test_prepared_list_and_plan(mask_kind):
    """The list is the mask's nodes in ascending order, its length the
    plan's n_upd, for an empty and a full update set too."""
    m, W, rows, mask, u = _torch(*_operands(40, 6, 1, mask_kind))
    prep = PreparedHalfSweep(W, *rows, mask, 6)
    want = torch.nonzero(mask).reshape(-1).to(torch.int32)
    assert prep.index.dtype == torch.int32
    assert torch.equal(prep.index, want)
    assert prep.n_upd == int(mask.sum())
    assert prep.plan == half_sweep_plan(40, 6, prep.n_upd)
    got = pbit_half_sweep(m, W, *rows, mask, 0.9, u, prepared=prep)
    assert torch.equal(got, pbit_half_sweep_ref(m, W, *rows, mask, 0.9, u))
    if mask_kind == "none":
        assert torch.equal(got, m)


def test_plain_version_with_and_without_preparation():
    m, W, rows, mask, u = _torch(*_operands(48, 7, 2))
    beta = torch.tensor(1.1)
    prep = PreparedHalfSweep(W, *rows, mask, 7)
    with_prep = pbit_half_sweep(m, W, *rows, mask, beta, u, prepared=prep)
    without = pbit_half_sweep(m, W, *rows, mask, beta, u)
    assert torch.equal(with_prep, without)
    assert (with_prep[:, mask] != m[:, mask]).any()
    assert pbit_half_sweep.launches == 0      # CPU tensors launch nothing
    # a preparation answers only for the operands it was built for
    with pytest.raises(ValueError, match="other chip operands"):
        pbit_half_sweep(m, W.clone(), *rows, mask, beta, u, prepared=prep)
    with pytest.raises(ValueError, match="other chip operands"):
        pbit_half_sweep(m, W, *rows, ~mask, beta, u, prepared=prep)


def test_scalar_and_vector_beta_give_equal_spins():
    """A scalar beta (a Python float, a 0-d view of a schedule) and the
    same value for every chain as a (B,) vector: the same spins."""
    m, W, rows, mask, u = _torch(*_operands(40, 9, 3))
    schedule = torch.linspace(0.3, 1.7, 5)
    prep = PreparedHalfSweep(W, *rows, mask, 9)
    for beta in schedule:
        vec = beta.expand(9).clone()
        a = pbit_half_sweep(m, W, *rows, mask, beta, u, prepared=prep)
        b = pbit_half_sweep(m, W, *rows, mask, vec, u, prepared=prep)
        c = pbit_half_sweep(m, W, *rows, mask, float(beta), u,
                            prepared=prep)
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("beta_kind", ["scalar", "per_chain"])
def test_prepared_half_sweep_matches_reference_kernel(beta_kind):
    """Through a preparation, a half-sweep holds against the reference's
    Pallas kernel (interpret mode): spins equal wherever |decision| >
    1e-5, kept nodes untouched."""
    N, B = 40, 8
    m, W, rows, mask, u = _operands(N, B, 4)
    rng = np.random.default_rng(5)
    beta = (np.float32(0.8) if beta_kind == "scalar"
            else rng.uniform(0.3, 1.8, B).astype(np.float32))
    want = np.asarray(pbit_half_sweep_pallas(
        jnp.asarray(m), jnp.asarray(W), *map(jnp.asarray, rows),
        jnp.asarray(mask), jnp.asarray(beta), jnp.asarray(u), block_b=8,
        block_n=128, block_k=128, interpret=True))
    tm, tW, trows, tmask, tu = _torch(m, W, rows, mask, u)
    prep = PreparedHalfSweep(tW, *trows, tmask, B)
    got = pbit_half_sweep(tm, tW, *trows, tmask, torch.as_tensor(beta), tu,
                          prepared=prep).numpy()
    h, g, o, rg, co = rows
    I = m @ W.T + h                  # exact: dyadic couplings, ±1 spins
    d = np.tanh(np.reshape(beta, (-1, 1)) * g * (I + o)) + rg * u + co
    sure = np.abs(d) > 1e-5
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[sure], want[sure])
    np.testing.assert_array_equal(got[:, ~mask], m[:, ~mask])


def test_sweep_function_prepares_each_mask_once():
    """`make_kernel_half_sweep` prepares each (colour mask, chip, chain
    count) once, its list equal to ``nonzero(mask)``, and the pallas loop
    through it equals the ref loop bit for bit."""
    g = make_chimera(2, 2)
    mach = port_cd.PBitMachine.create(g, 3, noise="counter",
                                      backend="pallas", device="cpu")
    rng = np.random.default_rng(6)
    ses = mach.session(chains=5)
    chip = ses.program_master(rng.normal(size=g.n_edges) * 30.0,
                              rng.normal(size=g.n_nodes) * 10.0)
    color = torch.as_tensor(g.color)
    kernel = ops.make_kernel_half_sweep()
    masks = [color == 0, color == 1]
    m = torch.from_numpy(
        (rng.integers(0, 2, (5, g.n_nodes)) * 2 - 1).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-1, 1, (5, g.n_nodes)).astype(
        np.float32))
    want = m
    for _ in range(3):
        for mk in masks:
            m = kernel(m, chip, mk, 0.7, u)
            want = ops.ref_half_sweep(want, chip, mk, 0.7, u)
    assert torch.equal(m, want)
    assert len(kernel.prepared) == 2
    for prep, mk, held in kernel.prepared.values():
        assert held is chip
        assert torch.equal(prep.index,
                           torch.nonzero(mk).reshape(-1).to(torch.int32))
        assert prep.plan == half_sweep_plan(g.n_nodes, 5, prep.n_upd)


def test_chip_colours_plan_as_the_paths_run_them():
    """The 440-spin chip's colour classes are the lists the paths prepare:
    220 nodes each, planned as `test_plan_at_the_chip_size` pins."""
    g = make_chip_graph()
    assert g.n_nodes == CHIP_N
    counts = np.bincount(np.asarray(g.color))
    assert counts.tolist() == [CHIP_COLOUR, CHIP_COLOUR]
