"""Dense chromatic-Gibbs half-sweep: CUDA kernel + plain version.

`pbit_half_sweep` computes one half-sweep of eqns 1 + 2 on the dense
(N, N) couplings: ``I = Σ_j W[i, j] m[:, j] + h`` for every node of the
update mask, tanh with a per-chain beta, ``+ rand_gain·u + comp_off``,
sign, masked write.  ``u`` is an input (the host step function draws it),
so the kernel runs with any noise kind.

It replaces the TPU kernel ``repro.kernels.pbit_update.pbit_half_sweep_pallas``;
the CUDA source is ``csrc/pbit_update.cu``.  The product is the sequential
ascending-j float32 row reduction (see `kernels/ref.py`), so kernel and
plain version agree bit for bit.  Each (chain, node) is a chain of N
dependent adds, so the kernel spreads the updates over the card: a block
takes a tile of the update list's nodes and a tile of chains, stages
their rows in shared memory once and sums from there.  `half_sweep_plan`
picks the tile and the body; `PreparedHalfSweep` holds what every launch
of one sweep function shares (the compacted update list, the plan, the
checked operands), so a call does little more than launch.

`pbit_half_sweep_ref` (kernels/ref.py) is the plain PyTorch version.  The
wrapper uses it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pbit_half_sweep_ref
from repro_torch.kernels.sweep_fused import H100, CardLimits, _want, card_limits

__all__ = ["pbit_half_sweep", "pbit_half_sweep_ref", "half_sweep_plan",
           "HalfSweepPlan", "PreparedHalfSweep"]

# csrc/pbit_update.cu: a warp is LANE_NODES x LANE_CHAINS lanes, each lane a
# register tile of (nodes x chains); the tiled body stages TILE_K columns
# at a time; shared rows are padded to ROW_PAD mod 32 floats; the staged
# body's mbarrier takes BAR_BYTES in front of its rows
LANE_NODES, LANE_CHAINS = 4, 8
TILE_K = 128
ROW_PAD = 4
BAR_BYTES = 16
# the block tiles the plan may pick, largest first: (register nodes,
# register chains, warps along the nodes, warps along the chains)
HALF_SWEEP_TILES = ((2, 2, 2, 2), (2, 2, 2, 1), (2, 2, 1, 1), (2, 1, 1, 1),
                    (1, 1, 1, 1))
HALF_SWEEP_BODIES = {"staged": 0, "tiled": 1}
# the least share of the SMs a tile's grid must cover to be taken
# (benchmarks_torch/k2_parts.py on an H100: at 256 chains the 16 x 32
# tile's 112 blocks, 0.85 of the 132 SMs, ran 6-9 % faster than the 16 x
# 16 tile's 224; at 32 chains the 8 x 8 tile's 112 tied the 4 x 8's 220)
MIN_WAVE_FILL = 0.8


class HalfSweepPlan(NamedTuple):
    """How one K2 launch runs: the block tile, the body and the grid."""

    body: str            # "staged" (whole rows) or "tiled" (column tiles)
    nodes: int           # update-list entries per block
    chains: int          # chains per block
    reg_nodes: int       # a lane's register tile
    reg_chains: int
    warps_b: int         # warps of a block along its chains
    threads: int
    grid: tuple          # (list tiles, chain tiles)
    smem_bytes: int


def row_stride(body: str, N: int) -> int:
    """Floats between two staged rows (``csrc/pbit_update.cu::row_stride``):
    the row's columns, or a column tile, padded to `ROW_PAD` mod 32."""
    if body == "tiled":
        return TILE_K + ROW_PAD
    n4 = -(-N // 4) * 4
    return n4 + (ROW_PAD - n4) % 32


def half_sweep_smem_bytes(body: str, rows: int, N: int) -> int:
    """Shared memory of one block: ``rows`` staged rows (the block's list
    entries and chains), once behind an mbarrier (staged) or in two
    buffers (tiled)."""
    if body == "tiled":
        return 2 * rows * row_stride(body, N) * 4
    return BAR_BYTES + rows * row_stride(body, N) * 4


def half_sweep_plan(N: int, B: int, n_upd: int,
                    limits: CardLimits = H100,
                    aligned: bool = True) -> HalfSweepPlan:
    """The tile, body and grid of a K2 launch over ``B`` chains of ``N``
    spins with ``n_upd`` nodes in the update list.

    The tile is the largest of `HALF_SWEEP_TILES` whose grid — sized from
    ``n_upd``, so every block has updates — covers at least
    `MIN_WAVE_FILL` of the SMs (each (chain, node) is a chain of N
    dependent adds: the card is filled by spreading the outputs, not by
    lengthening a block's work); if none does, the smallest.  The staged
    body holds the block's rows whole, each copied by one TMA bulk copy,
    where they fit a block's shared memory and are 16-byte aligned (N a
    multiple of 4 and W ``aligned``), else the tiled body stages them in
    double-buffered column tiles of `TILE_K`."""
    for tile in HALF_SWEEP_TILES:
        plan = tile_plan(N, B, n_upd, tile, limits, aligned)
        if plan.grid[0] * plan.grid[1] >= MIN_WAVE_FILL * limits.sms:
            break
    return plan


def tile_plan(N: int, B: int, n_upd: int, tile: tuple,
              limits: CardLimits = H100,
              aligned: bool = True) -> HalfSweepPlan:
    """The plan of one of `HALF_SWEEP_TILES`: its grid over the list and
    the chains, and the staged body where the rows fit and are 16-byte
    aligned, else the tiled."""
    rn, rb, wn, wb = tile
    tn, tb = LANE_NODES * rn * wn, LANE_CHAINS * rb * wb
    grid = (max(1, -(-n_upd // tn)), -(-B // tb))
    body = "staged"
    if (not aligned or N % 4
            or half_sweep_smem_bytes(body, tn + tb, N)
            > limits.smem_per_block):
        body = "tiled"
    return HalfSweepPlan(body, tn, tb, rn, rb, wb, 32 * wn * wb, grid,
                         half_sweep_smem_bytes(body, tn + tb, N))


_VP, _I = ctypes.c_void_p, ctypes.c_int


class _HalfStatic(ctypes.Structure):
    """``csrc/pbit_update.cu::HalfStatic``, field for field."""

    _fields_ = [(n, _VP) for n in ("W", "h", "gain", "off", "rg", "co",
                                   "index", "keep")] + [
        (n, _I) for n in ("N", "B", "n_upd", "n_keep", "reg_nodes",
                          "reg_chains", "warps_b", "threads", "grid_x",
                          "grid_y", "tiled")]


def _library() -> ctypes.CDLL:
    return declare(build.load("pbit_update"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a K2 library's entry points."""
    if lib.pbit_half_sweep_launch.argtypes is None:
        static = ctypes.POINTER(_HalfStatic)
        lib.pbit_half_sweep_launch.argtypes = [static, _VP, _VP, _VP, _VP,
                                               _I, _VP]
        lib.pbit_half_sweep_launch.restype = _I
        lib.pbit_half_sweep_prepare.argtypes = [static, _I]
        lib.pbit_half_sweep_prepare.restype = _I
        lib.pbit_half_sweep_smem_bytes.argtypes = [_I, _I, _I]
        lib.pbit_half_sweep_smem_bytes.restype = _I
        lib.pbit_half_sweep_error_string.argtypes = [_I]
        lib.pbit_half_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.pbit_half_sweep_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


class PreparedHalfSweep:
    """What every half-sweep of one chip, update mask and chain count
    shares, built once: the compacted update list (``index``, int32,
    ascending; its length ``n_upd`` costs one host sync) and the list of
    the other nodes (``keep``), the `plan` and, on the card, the checked
    chip operands and the kernel's static arguments.  ``operands`` are the
    tensors it was built for; a call with other ones raises."""

    def __init__(self, W, h, gain, off, rand_gain, comp_off, update_mask,
                 B: int):
        N = W.shape[0]
        self.operands = (W, h, gain, off, rand_gain, comp_off, update_mask)
        self.shape = (int(B), N)
        mask = (update_mask.view(torch.uint8)
                if update_mask.dtype == torch.bool else update_mask)
        self.index = torch.nonzero(mask).reshape(-1).to(torch.int32)
        self.keep = torch.nonzero(mask == 0).reshape(-1).to(torch.int32)
        self.n_upd = int(self.index.numel())
        self.plan = half_sweep_plan(N, int(B), self.n_upd,
                                    card_limits(W.device),
                                    W.data_ptr() % 16 == 0)
        self.device = W.device
        self._static = None
        if W.is_cuda:
            self._bind(mask)

    def _bind(self, mask) -> None:
        W, *rows = self.operands[:6]
        B, N = self.shape
        f32 = torch.float32
        _want("W", W, f32, (N, N))
        for name, t in zip(("h", "gain", "off", "rand_gain", "comp_off"),
                           rows):
            _want(name, t, f32, (N,))
        _want("update_mask", mask, torch.uint8, (N,))
        if any(t.device != self.device for t in (*rows, mask)):
            raise ValueError("the chip's operands lie on different devices")
        lib = _library()
        plan = self.plan
        body = HALF_SWEEP_BODIES[plan.body]
        smem = lib.pbit_half_sweep_smem_bytes(body, plan.nodes + plan.chains,
                                              N)
        if smem != plan.smem_bytes:
            raise RuntimeError(
                f"half_sweep_plan counts {plan.smem_bytes} bytes of shared "
                f"memory for {plan}, the kernel {smem}")
        st = _HalfStatic(
            *(t.data_ptr() for t in (W, *rows, self.index, self.keep)),
            N, B, self.n_upd, N - self.n_upd, plan.reg_nodes,
            plan.reg_chains, plan.warps_b, plan.threads, *plan.grid, body)
        with torch.cuda.device(self.device):
            _raise(lib, lib.pbit_half_sweep_prepare(ctypes.byref(st),
                                                    plan.smem_bytes),
                   "pbit_half_sweep prepare")
        self._lib, self._static = lib, st

    def check(self, W, h, gain, off, rand_gain, comp_off, update_mask) -> None:
        if any(a is not b for a, b in zip(
                (W, h, gain, off, rand_gain, comp_off, update_mask),
                self.operands)):
            raise ValueError("this PreparedHalfSweep was built for other chip "
                             "operands or another update mask")


def _beta_operand(beta, B: int, device):
    """(tensor, chain stride) of a scalar or (B,) beta on ``device``: a
    float32 CUDA tensor there (a 0-d view of a schedule included) is used
    as it is; anything else is copied there once."""
    if not (isinstance(beta, torch.Tensor) and beta.dtype == torch.float32
            and beta.device == device):
        beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
    if beta.numel() == 1:
        return beta, 0
    if tuple(beta.shape) != (B,):
        raise ValueError(f"beta must be a scalar or have shape ({B},), got "
                         f"{tuple(beta.shape)}")
    return beta, beta.stride(0)


def pbit_half_sweep(m, W, h, gain, off, rand_gain, comp_off, update_mask,
                    beta, u, *, prepared: PreparedHalfSweep | None = None):
    """One dense half-sweep; shapes and semantics of `pbit_half_sweep_ref`.

    m: (B, N) float32 ±1;  W: (N, N) float32;  h/gain/off/rand_gain/
    comp_off: (N,) float32;  update_mask: (N,) bool;  beta: scalar or (B,);
    u: (B, N) float32.  Returns the new (B, N) spins.  ``prepared``: a
    `PreparedHalfSweep` of these chip operands, mask and chain count (built
    here when not given).  CPU tensors go to `pbit_half_sweep_ref`; a CUDA
    tensor launches the kernel or raises; ``pbit_half_sweep.launches``
    counts the launches and ``pbit_half_sweep.last_plan`` is the
    `HalfSweepPlan` of the latest one.
    """
    if prepared is not None:
        prepared.check(W, h, gain, off, rand_gain, comp_off, update_mask)
    if not m.is_cuda:
        return pbit_half_sweep_ref(m, W, h, gain, off, rand_gain, comp_off,
                                   update_mask, beta, u)
    if prepared is None:
        prepared = PreparedHalfSweep(W, h, gain, off, rand_gain, comp_off,
                                     update_mask, m.shape[0])
    dev = prepared.device
    if m.device != dev or u.device != dev:
        raise ValueError(f"m and u must lie on {dev}, the chip's device")
    _want("m", m, torch.float32, prepared.shape)
    _want("u", u, torch.float32, prepared.shape)
    if prepared.plan.body == "staged" and m.data_ptr() % 16:
        raise ValueError("the staged body copies m's rows in 16-byte "
                         "aligned bulk copies: pass m at an aligned address")
    beta, stride = _beta_operand(beta, prepared.shape[0], dev)
    out = torch.empty_like(m)
    lib = prepared._lib
    args = (ctypes.byref(prepared._static), m.data_ptr(), out.data_ptr(),
            u.data_ptr(), beta.data_ptr(), stride)
    if dev.index == torch.cuda.current_device():
        rc = lib.pbit_half_sweep_launch(
            *args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.pbit_half_sweep_launch(
                *args, torch.cuda.current_stream().cuda_stream)
    _raise(lib, rc, "pbit_half_sweep launch")
    pbit_half_sweep.launches += 1
    pbit_half_sweep.last_plan = prepared.plan
    return out


pbit_half_sweep.launches = 0
pbit_half_sweep.last_plan = None
