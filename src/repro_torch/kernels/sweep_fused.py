"""Sweep-resident sampling engines: CUDA kernels + plain versions.

Two layouts, one launch per S chromatic sweeps: spins stay in shared
memory, noise is generated in the kernel from the reference's own integer
streams, and CD moments and the visible-pattern histogram accumulate in the
launch.

* `sweep_sparse` — the Chimera-native fixed-degree slot layout.  Replaces
  the TPU kernel ``repro.kernels.sweep_fused.sweep_sparse_pallas`` (body
  ``_kernel`` with ``sparse=True``); CUDA source ``csrc/sweep_sparse.cu``.
  Bound by operations (per flip: D gathers with a multiply-add, two 32-bit
  hashes, one tanhf), not by bytes; the design keeps the spins, the tile's
  LFSR registers and a node's weights on chip across all half-sweeps and
  pays one block-wide barrier per half-sweep.
* `sweep_sparse_stream` — K1 with the double-buffered program stream (K4):
  counter noise, no statistics; while the current program sweeps, the
  next program's ``(nbr_w, h)`` is copied into staged output buffers.
  Replaces ``repro.kernels.sweep_fused.sweep_sparse_stream_pallas``
  (``_kernel`` with ``stream=True``); the same CUDA kernel, instantiated
  with ``Stream = true``.  Bound as K1, plus the staged bytes.
* `sweep_sparse_exchange` — K1 on every row band of the sharded engine
  in one launch, with the halo exchange inside it (K5): at every exchange
  point each band publishes its boundary spins and reads its neighbours'
  into its halo columns, through a mailbox in device memory and a grid
  barrier (a cooperative launch).  Replaces
  ``repro.kernels.sweep_fused.sweep_sparse_exchange_pallas``; CUDA source
  ``csrc/sweep_exchange.cu``.  Bound as K1, plus one grid barrier per
  exchange point.
* `sweep_fused` — the dense (N, N) couplings.  Replaces
  ``repro.kernels.sweep_fused.sweep_fused_pallas`` (``_kernel`` with
  ``sparse=False``); CUDA source ``csrc/sweep_fused.cu``.  Two bodies,
  chosen by shape in `dense_plan`: where W fits the shared memory of a
  thread-block cluster, each CTA of a cluster holds the rows of W of its
  share of each colour and the spins travel between the CTAs through
  distributed shared memory (bound by the dependent float32 add chain of
  eqn 1); otherwise W is read from L2 every half-sweep.  A dense W may
  couple nodes of one colour, so the update is synchronous
  (double-buffered spins).  The statistics come from an int8 record of the
  measured sweeps' spins, reduced after the sweeps in sweep order (the
  Gram matrix Σ mᵀm on the int8 tensor cores), so they equal the plain
  version's bit for bit; `dense_record_windows` splits a launch whose
  record would outgrow its memory.  `dense_resident_feasible` models the
  limits on Hopper.

`sweep_sparse_ref` / `sweep_sparse_stream_ref` /
`sweep_sparse_exchange_ref` / `sweep_fused_ref` are the plain PyTorch
versions of the same functions: a Python loop of half-sweeps
(`kernels/ref.py`) with noise from `core.lfsr`.  A wrapper uses its plain version only for tensors
that lie on the CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import lfsr as lfsr_mod
from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    field_decision_update,
    halo_exchange_segments,
    row_tables,
    sparse_neuron_input,
)

NOISE_COUNTER = "counter"
NOISE_LFSR = "lfsr"
_NOISE_CODE = {NOISE_COUNTER: 0, NOISE_LFSR: 1}

MAX_HIST_VISIBLE = 12   # 2^nv histogram bins per block partial
MAX_TILE_CHAINS = 8     # chains per block the tile heuristic will pick


class CardLimits(NamedTuple):
    """What bounds the resident engines' tiling on one card."""

    smem_per_block: int   # opt-in shared memory of one block
    sms: int              # streaming multiprocessors
    l2_bytes: int         # L2 cache, from which K3 reads W
    memory_bytes: int     # device memory
    smem_per_sm: int      # shared memory of one SM (K5's residency)
    threads_per_sm: int   # resident threads of one SM
    regs_per_sm: int      # 32-bit registers of one SM

    @property
    def record_bytes(self) -> int:
        """Room for one K3 launch's spin record: an eighth of device
        memory, the rest left to the chips, the chains and the caching
        allocator."""
        return self.memory_bytes // 8


# NVIDIA H100 80GB HBM3 (SXM, sm_90a), the card the port targets, as
# `torch.cuda.get_device_properties` reports it
H100 = CardLimits(smem_per_block=232448, sms=132, l2_bytes=52428800,
                  memory_bytes=85_017_493_504, smem_per_sm=233472,
                  threads_per_sm=2048, regs_per_sm=65536)


def card_limits(device) -> CardLimits:
    """The limits of the CUDA card ``device``.  Any other device (a spec
    resolved on the CPU, or a CUDA device where there is none) gets the
    H100's, so a spec resolves as it would on the port's target card."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return H100
    props = torch.cuda.get_device_properties(dev)
    return CardLimits(smem_per_block=props.shared_memory_per_block_optin,
                      sms=props.multi_processor_count,
                      l2_bytes=props.L2_cache_size,
                      memory_bytes=props.total_memory,
                      smem_per_sm=props.shared_memory_per_multiprocessor,
                      threads_per_sm=props.max_threads_per_multi_processor,
                      regs_per_sm=props.regs_per_multiprocessor)


# ---------------------------------------------------------------------------
# argument plumbing shared by the kernel wrapper and the plain version
# ---------------------------------------------------------------------------
def _window(S: int, half_offset: int, n_half: int | None) -> int:
    n_half = 2 * S - half_offset if n_half is None else n_half
    if not (0 <= half_offset and 0 <= n_half
            and half_offset + n_half <= 2 * S):
        raise ValueError(
            f"half-sweep window [{half_offset}, {half_offset + n_half}) "
            f"falls outside the launch's 2*S={2 * S} half-sweeps")
    return n_half


def _check_modes(noise_mode, gather_perm, coord_offset, accumulate,
                 collect_hist, measured, visible_idx, n_visible):
    if noise_mode not in _NOISE_CODE:
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if noise_mode == NOISE_LFSR and gather_perm is None:
        raise ValueError("lfsr noise_mode needs gather_perm "
                         "(see core/lfsr.py::node_gather_perm)")
    if coord_offset is not None and noise_mode != NOISE_COUNTER:
        raise ValueError(
            "coord_offset shifts the counter hash's (chain, node) "
            "coordinates; the lfsr mode carries its cell band in the "
            "state instead")
    accumulate = accumulate and measured is not None
    collect_hist = collect_hist and measured is not None
    if collect_hist:
        if visible_idx is None:
            raise ValueError("collect_hist needs visible_idx")
        if not (0 < n_visible <= MAX_HIST_VISIBLE):
            raise ValueError(
                f"collect_hist supports 1..{MAX_HIST_VISIBLE} visible "
                f"nodes, got {n_visible}")
    return accumulate, collect_hist


def _identity_result(m, noise_state, N, c_shape, accumulate, collect_hist,
                     n_visible):
    """An empty window: spins and noise state unchanged, zero statistics."""
    outs = [m, noise_state]
    if accumulate:
        outs += [m.new_zeros((N,)), m.new_zeros(c_shape)]
    if collect_hist:
        outs.append(m.new_zeros((2 ** n_visible,)))
    return tuple(outs)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------
def sweep_sparse_ref(
    m, nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off, mask0, mask1,
    betas, noise_state, clamp_mask=None, clamp_values=None, measured=None,
    visible_idx=None, coord_offset=None, *, noise_mode=NOISE_COUNTER,
    decimation=8, gather_perm=None, accumulate=False, collect_hist=False,
    n_visible=0, half_offset=0, n_half=None,
):
    """`sweep_sparse` in plain PyTorch, any device: same arguments, same
    return tuple, the same arithmetic one half-sweep at a time."""
    B, N = m.shape
    D = nbr_idx.shape[0]
    S = betas.shape[0]
    n_half = _window(S, half_offset, n_half)
    accumulate, collect_hist = _check_modes(
        noise_mode, gather_perm, coord_offset, accumulate, collect_hist,
        measured, visible_idx, n_visible)
    if n_half == 0:
        return _identity_result(m, noise_state, N, (D, N), accumulate,
                                collect_hist, n_visible)
    return _sweeps_ref(
        m, lambda mm: sparse_neuron_input(mm, nbr_idx, nbr_w, h),
        lambda mm: torch.stack([(mm * mm.index_select(1, nbr_idx[d])).sum(0)
                                for d in range(D)]),
        (D, N), gain, off, rand_gain, comp_off, mask0, mask1, betas,
        noise_state, clamp_mask, clamp_values, measured, visible_idx,
        coord_offset, noise_mode=noise_mode, decimation=decimation,
        gather_perm=gather_perm, accumulate=accumulate,
        collect_hist=collect_hist, n_visible=n_visible,
        half_offset=half_offset, n_half=n_half)


def _check_stream(noise_mode, measured, accumulate, collect_hist, next_h):
    """The program stream's refusals, with the reference's messages."""
    if noise_mode != NOISE_COUNTER:
        raise ValueError(
            "program streaming runs on the sparse counter-noise engine (the "
            "launch-resident serving configuration)")
    if next_h is None:
        raise ValueError("next_nbr_w without next_h")
    if accumulate or collect_hist or measured is not None:
        raise ValueError(
            "program streaming excludes in-kernel moment/histogram "
            "accumulation — a swapped program invalidates the accumulators "
            "mid-grid")


def _same_storage(a, b) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _check_stream_buffers(nbr_w, h, next_nbr_w, next_h, staged):
    """The next program and the staged outputs are buffers of their own:
    one storage may not be both the current and the next program, or a
    staged output (a two-slot ring that the caller swaps is the idiom)."""
    current = {"nbr_w": nbr_w, "h": h}
    for name, t in (("next_nbr_w", next_nbr_w), ("next_h", next_h)):
        for cname, c in current.items():
            if _same_storage(t, c):
                raise ValueError(
                    f"{name} shares its storage with the current program's "
                    f"{cname}; stage the next program from a buffer of its "
                    f"own")
    if staged is not None:
        others = {**current, "next_nbr_w": next_nbr_w, "next_h": next_h}
        for name, t in zip(("staged_w", "staged_h"), staged):
            for oname, o in others.items():
                if _same_storage(t, o):
                    raise ValueError(
                        f"{name} shares its storage with {oname}; the "
                        f"staged outputs must be the free slot of a "
                        f"two-slot ring")


def sweep_sparse_stream_ref(
    m, nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off, mask0, mask1,
    betas, noise_state, next_nbr_w, next_h, clamp_mask=None,
    clamp_values=None, coord_offset=None, *, noise_mode=NOISE_COUNTER,
    measured=None, accumulate=False, collect_hist=False, staged=None,
    half_offset=0, n_half=None,
):
    """`sweep_sparse_stream` in plain PyTorch, any device: `sweep_sparse_ref`
    on the current program (counter noise), and the next program copied into
    ``staged`` (a ``(staged_w, staged_h)`` pair) or into new tensors."""
    _check_stream(noise_mode, measured, accumulate, collect_hist, next_h)
    _check_stream_buffers(nbr_w, h, next_nbr_w, next_h, staged)
    m_out, ns = sweep_sparse_ref(
        m, nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off, mask0, mask1,
        betas, noise_state, clamp_mask, clamp_values, None, None,
        coord_offset, noise_mode=NOISE_COUNTER, half_offset=half_offset,
        n_half=n_half)
    if staged is None:
        staged = (torch.empty_like(next_nbr_w, dtype=torch.float32),
                  torch.empty_like(next_h, dtype=torch.float32))
    staged[0].copy_(next_nbr_w)
    staged[1].copy_(next_h)
    return m_out, ns, staged[0], staged[1]


def sweep_fused_ref(
    m, W, h, gain, off, rand_gain, comp_off, mask0, mask1, betas,
    noise_state, clamp_mask=None, clamp_values=None, measured=None,
    visible_idx=None, coord_offset=None, *, noise_mode=NOISE_COUNTER,
    decimation=8, gather_perm=None, accumulate=False, collect_hist=False,
    n_visible=0, stats_in=None,
):
    """`sweep_fused` in plain PyTorch, any device: same arguments, same
    return tuple.  Eqn 1 is `kernels/ref.py`'s ascending row reduction (on
    each row's nonzero entries: the same sum); the Gram matrix of a sweep is
    ``mᵀm`` by `torch.matmul`, exact because its entries are integers.
    ``stats_in`` (the statistics a previous window returned) continues
    their sums instead of starting from zero, as a windowed launch does
    (`dense_record_windows`)."""
    B, N = m.shape
    S = betas.shape[0]
    accumulate, collect_hist = _check_modes(
        noise_mode, gather_perm, coord_offset, accumulate, collect_hist,
        measured, visible_idx, n_visible)
    if S == 0:
        if stats_in is not None:
            return (m, noise_state, *stats_in)
        return _identity_result(m, noise_state, N, (N, N), accumulate,
                                collect_hist, n_visible)
    idx, w = row_tables(W)
    return _sweeps_ref(
        m, lambda mm: sparse_neuron_input(mm, idx, w, h),
        lambda mm: torch.matmul(mm.T, mm), (N, N), gain, off, rand_gain,
        comp_off, mask0, mask1, betas, noise_state, clamp_mask, clamp_values,
        measured, visible_idx, coord_offset, noise_mode=noise_mode,
        decimation=decimation, gather_perm=gather_perm,
        accumulate=accumulate, collect_hist=collect_hist,
        n_visible=n_visible, half_offset=0, n_half=2 * S, stats_in=stats_in)


def _sweeps_ref(
    m, neuron_input, pair_sums, c_shape, gain, off, rand_gain, comp_off,
    mask0, mask1, betas, noise_state, clamp_mask, clamp_values, measured,
    visible_idx, coord_offset, *, noise_mode, decimation, gather_perm,
    accumulate, collect_hist, n_visible, half_offset, n_half, stats_in=None,
):
    """The plain half-sweep loop of both engines: ``neuron_input(m)`` is
    eqn 1, ``pair_sums(m)`` a sweep's second-moment sums over chains;
    ``stats_in`` holds statistics to continue (``(s_sum, c_sum)`` and/or
    ``(hist,)``, in the order they are returned)."""
    B, N = m.shape
    dev = m.device
    has_clamp = clamp_mask is not None and clamp_values is not None
    masks = (mask0.to(torch.bool), mask1.to(torch.bool))
    if noise_mode == NOISE_COUNTER:
        row0, col0 = (0, 0) if coord_offset is None else coord_offset
        rows = torch.arange(B, device=dev)[:, None] + int(row0)
        cols = torch.arange(N, device=dev)[None, :] + int(col0)
        seed, ctr0 = noise_state[0], lfsr_mod.to_u64(noise_state[1])
    else:
        perm = torch.as_tensor(np.asarray(gather_perm, np.int64), device=dev)
        st = lfsr_mod.to_u64(noise_state)
    carried = list(stats_in) if stats_in is not None else None
    if accumulate:
        s_sum = torch.zeros((N,), dtype=torch.float32, device=dev)
        c_sum = torch.zeros(c_shape, dtype=torch.float32, device=dev)
        if carried:
            s_sum, c_sum = carried.pop(0).clone(), carried.pop(0).clone()
    if collect_hist:
        vis = torch.as_tensor(visible_idx, device=dev).to(torch.int64)
        pow2 = 2 ** torch.arange(n_visible, device=dev)
        hist = torch.zeros((2 ** n_visible,), dtype=torch.float32, device=dev)
        if carried:
            hist = carried.pop(0).clone()

    for j in range(n_half):
        g = half_offset + j
        s, c = g // 2, g % 2
        if has_clamp and (c == 0 or j == 0):
            m = torch.where(clamp_mask.to(torch.bool), clamp_values, m)
        if noise_mode == NOISE_COUNTER:
            u = lfsr_mod.counter_uniform(seed, ctr0 + j, rows, cols)
        else:
            st = lfsr_mod.lfsr_step_n(st, decimation)
            u = lfsr_mod.flat_cell_uniforms(st).index_select(-1, perm)
        I = neuron_input(m)
        m = field_decision_update(m, I, gain, off, rand_gain, comp_off,
                                  masks[c], betas[s], u)
        if c == 1 and (accumulate or collect_hist):
            w = measured[s]
            if accumulate:
                s_sum = s_sum + w * m.sum(dim=0)
                c_sum = c_sum + w * pair_sums(m)
            if collect_hist:
                codes = ((m.index_select(1, vis) > 0).to(torch.int64)
                         * pow2).sum(dim=1)
                hist = hist + w * torch.bincount(
                    codes, minlength=2 ** n_visible).to(torch.float32)

    if noise_mode == NOISE_COUNTER:
        ns = torch.stack([lfsr_mod.to_u64(noise_state[0]),
                          (ctr0 + n_half) & 0xFFFFFFFF])
        noise_out = lfsr_mod.from_u64(ns)
    else:
        noise_out = lfsr_mod.from_u64(st)
    outs = [m, noise_out]
    if accumulate:
        outs += [s_sum, c_sum]
    if collect_hist:
        outs.append(hist)
    return tuple(outs)


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------
_VP, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
_LAUNCH_ARGTYPES = (
    [_VP, _VP, _I, _I, _I, _I]          # m_in, m_out, B, N, D, S
    + [_VP] * 10                        # idx, w, h, gain, off, rg, co, masks, betas
    + [_VP, _VP, _VP, _VP, _I]          # clamp mask/values, measured, vis, nv
    + [_I, _VP, _VP, _I, _VP, _I]       # noise mode/in/out, C, perm, decimation
    + [_U, _U, _I, _I]                  # row0, col0, half_offset, n_half
    + [_VP] * 6                         # part_s, part_c, out_s, out_c, part_h, out_h
    + [_I, _I, _VP]                     # tb, threads, stream
)


def _library() -> ctypes.CDLL:
    lib = build.load("sweep_sparse")
    if lib.sweep_sparse_launch.argtypes is None:
        lib.sweep_sparse_launch.argtypes = _LAUNCH_ARGTYPES
        lib.sweep_sparse_launch.restype = _I
        lib.sweep_sparse_stream_launch.argtypes = _STREAM_ARGTYPES
        lib.sweep_sparse_stream_launch.restype = _I
        lib.sweep_sparse_smem_bytes.argtypes = [_I, _I, _I, _I]
        lib.sweep_sparse_smem_bytes.restype = _I
        lib.tanh_probe.argtypes = [_VP, _VP, _I, _VP]
        lib.tanh_probe.restype = _I
        lib.sweep_sparse_error_string.argtypes = [_I]
        lib.sweep_sparse_error_string.restype = ctypes.c_char_p
    return lib


def _raise_cuda(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sweep_sparse_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _want(name, t, dtype, shape):
    """Check a kernel operand: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on the CUDA device of m, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t


def _mask_u8(name, t, N):
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return _want(name, t, torch.uint8, (N,))


def _tile_chains(B, tile_bytes, limits: CardLimits, block_b, what: str):
    """Chains per block: enough blocks to cover the SMs (at most
    `MAX_TILE_CHAINS` chains each), within the shared memory a block may
    opt in to.  ``tile_bytes(tb)`` is one block's shared memory at ``tb``
    chains; ``what`` ends the error raised when one chain does not fit."""
    limit = limits.smem_per_block
    if tile_bytes(1) > limit:
        raise ValueError(
            f"one chain needs {tile_bytes(1)} bytes of shared memory, a "
            f"block can use {limit} on this card: {what}")
    if block_b is None:
        block_b = min(MAX_TILE_CHAINS, -(-B // limits.sms))
    tb = max(1, min(int(block_b), B))
    while tile_bytes(tb) > limit:
        tb -= 1
    return tb


class _Operands(NamedTuple):
    """The operands both engines take beyond the weights, checked."""

    rows: list           # h, gain, off, rand_gain, comp_off
    mask0: torch.Tensor
    mask1: torch.Tensor
    clamp_mask: torch.Tensor | None     # None unless clamps are imposed
    clamp_values: torch.Tensor | None
    measured: torch.Tensor | None       # None unless statistics are taken
    visible_idx: torch.Tensor | None    # None unless the histogram is
    noise_code: int
    C: int                              # LFSR cells per chain (0: counter)
    perm: torch.Tensor | None           # (N,) gather permutation (lfsr)
    row0: int
    col0: int


def _operands(m, rows, mask0, mask1, betas, noise_state, clamp_mask,
              clamp_values, measured, visible_idx, coord_offset, *,
              noise_mode, gather_perm, accumulate, collect_hist,
              n_visible) -> _Operands:
    """Check the shared operands of a launch (CUDA, dtype, shape,
    contiguity) and convert masks and indices to what the kernels read."""
    B, N = m.shape
    S = betas.shape[0]
    dev = m.device
    f32 = torch.float32
    _want("m", m, f32, (B, N))
    rows = [_want(n, t, f32, (N,)) for n, t in zip(
        ("h", "gain", "off", "rand_gain", "comp_off"), rows)]
    mask0 = _mask_u8("mask0", mask0, N)
    mask1 = _mask_u8("mask1", mask1, N)
    _want("betas", betas, f32, (S, B))
    if clamp_mask is not None and clamp_values is not None:
        clamp_mask = _mask_u8("clamp_mask", clamp_mask, N)
        _want("clamp_values", clamp_values, f32, (B, N))
    else:
        clamp_mask = clamp_values = None
    if accumulate or collect_hist:
        _want("measured", measured, f32, (S,))
    else:
        measured = None
    if collect_hist:
        visible_idx = torch.as_tensor(visible_idx, device=dev).to(
            torch.int32).contiguous()
        _want("visible_idx", visible_idx, torch.int32, (n_visible,))
    else:
        visible_idx = None
    row0 = col0 = C = 0
    perm = None
    if noise_mode == NOISE_COUNTER:
        _want("noise_state", noise_state, torch.int32, (2,))
        if coord_offset is not None:
            row0, col0 = (int(x) & 0xFFFFFFFF for x in coord_offset)
    else:
        if noise_state.ndim != 2:
            raise ValueError("lfsr noise_state must be (B, C)")
        C = noise_state.shape[1]
        _want("noise_state", noise_state, torch.int32, (B, C))
        perm = torch.as_tensor(np.asarray(gather_perm, np.int32), device=dev)
        _want("gather_perm", perm, torch.int32, (N,))
    return _Operands(rows, mask0, mask1, clamp_mask, clamp_values, measured,
                     visible_idx, _NOISE_CODE[noise_mode], C, perm, row0,
                     col0)


def _outputs(m, noise_state, n_blocks, c_shape, accumulate, collect_hist,
             n_visible) -> dict:
    """Output and per-block partial buffers of a launch (None where a
    statistic is not taken)."""
    dev, f32, N = m.device, torch.float32, m.shape[1]
    out = dict(m=torch.empty_like(m), noise=torch.empty_like(noise_state),
               part_s=None, part_c=None, s=None, c=None, part_h=None,
               h=None)
    if accumulate:
        out.update(part_s=torch.empty((n_blocks, N), dtype=f32, device=dev),
                   part_c=torch.empty((n_blocks, *c_shape), dtype=f32,
                                      device=dev),
                   s=torch.empty((N,), dtype=f32, device=dev),
                   c=torch.empty(c_shape, dtype=f32, device=dev))
    if collect_hist:
        out.update(part_h=torch.empty((n_blocks, 2 ** n_visible), dtype=f32,
                                      device=dev),
                   h=torch.empty((2 ** n_visible,), dtype=f32, device=dev))
    return out


def _result(out: dict) -> tuple:
    """``(m', noise_state'[, s_sum, c_sum][, hist])`` from `_outputs`."""
    keep = [out["m"], out["noise"]]
    if out["s"] is not None:
        keep += [out["s"], out["c"]]
    if out["h"] is not None:
        keep.append(out["h"])
    return tuple(keep)


def _ptr(t):
    return None if t is None else t.data_ptr()


def sweep_sparse(
    m: torch.Tensor,              # (B, N) float32 spins in {-1, +1}
    nbr_idx: torch.Tensor,        # (D, N) int32 neighbor table
    nbr_w: torch.Tensor,          # (D, N) float32 per-slot couplings
    h: torch.Tensor,              # (N,) float32 rows
    gain: torch.Tensor,
    off: torch.Tensor,
    rand_gain: torch.Tensor,
    comp_off: torch.Tensor,
    mask0: torch.Tensor,          # (N,) bool — colour-0 update set
    mask1: torch.Tensor,          # (N,) bool — colour-1 update set
    betas: torch.Tensor,          # (S, B) float32
    noise_state: torch.Tensor,    # int32 bits: counter (2,), lfsr (B, C)
    clamp_mask: torch.Tensor | None = None,      # (N,) bool
    clamp_values: torch.Tensor | None = None,    # (B, N) float32, ±1
    measured: torch.Tensor | None = None,        # (S,) float32 weights
    visible_idx: torch.Tensor | None = None,     # (n_visible,) histogram nodes
    coord_offset=None,            # (row0, col0) Python ints, counter mode
    *,
    noise_mode: str = NOISE_COUNTER,
    decimation: int = 8,
    gather_perm=None,             # node -> flat LFSR column (length N)
    accumulate: bool = False,
    collect_hist: bool = False,
    n_visible: int = 0,
    block_b: int | None = None,   # chains per block; None -> fill the SMs
    half_offset: int = 0,
    n_half: int | None = None,
):
    """Run S resident sweeps on the Chimera-native fixed-degree layout.

    Returns ``(m', noise_state'[, s_sum, c_slots][, hist])``.  s_sum: (N,)
    sum of spins over (chains x measured sweeps); ``c_slots[d, i] = Σ m_i ·
    m_{nbr_idx[d, i]}`` — read edge (i, j) at ``c_slots[slot_of(i→j), i]``
    (`ChimeraGraph.edge_slots`); hist: (2^n_visible,) weighted counts of
    visible bit patterns (`energy.empirical_visible_dist` code order).  All
    need dividing by their sample counts.

    ``half_offset``/``n_half`` select a half-sweep window of the launch
    (betas/measured stay indexed by whole-launch sweep); chaining windows
    while threading ``noise_state`` equals the unsplit launch, and
    per-window moment partials sum to the whole-launch moments.
    ``coord_offset`` shifts the counter hash to global (chain, node)
    coordinates.

    Preconditions the kernel relies on (the caller's to keep; `ops` does):
    spins are exactly ±1 (or 0 in a column no mask updates, such as a halo
    column past the lattice's edge), clamp values exactly ±1, and ``mask0`` / ``mask1`` are
    each an independent set of the slot graph — no node of a mask has a
    non-padding slot pointing at another node of the same mask — because a
    colour's nodes are updated in place.  Both hold for the colour classes
    of a `ChimeraGraph` with any clamped nodes removed.

    With integer-valued ``measured`` (the 0/1 burn-in mask of the main
    path) every partial sum is an integer below 2^24 and the statistics
    equal `sweep_sparse_ref`'s bit for bit.  Fractional weights are summed
    per block and then over blocks, the plain version over all chains at
    once: expect agreement to float32 rounding (about 1e-6 relative).

    CPU tensors go to `sweep_sparse_ref`.  A CUDA tensor launches the
    kernel or raises; ``sweep_sparse.launches`` counts the launches.
    """
    if not m.is_cuda:
        return sweep_sparse_ref(
            m, nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off, mask0,
            mask1, betas, noise_state, clamp_mask, clamp_values, measured,
            visible_idx, coord_offset, noise_mode=noise_mode,
            decimation=decimation, gather_perm=gather_perm,
            accumulate=accumulate, collect_hist=collect_hist,
            n_visible=n_visible, half_offset=half_offset, n_half=n_half)

    B, N = m.shape
    D = nbr_idx.shape[0]
    S = betas.shape[0]
    n_half = _window(S, half_offset, n_half)
    accumulate, collect_hist = _check_modes(
        noise_mode, gather_perm, coord_offset, accumulate, collect_hist,
        measured, visible_idx, n_visible)
    if n_half == 0:
        return _identity_result(m, noise_state, N, (D, N), accumulate,
                                collect_hist, n_visible)

    _want("nbr_idx", nbr_idx, torch.int32, (D, N))
    _want("nbr_w", nbr_w, torch.float32, (D, N))
    op = _operands(m, (h, gain, off, rand_gain, comp_off), mask0, mask1,
                   betas, noise_state, clamp_mask, clamp_values, measured,
                   visible_idx, coord_offset, noise_mode=noise_mode,
                   gather_perm=gather_perm, accumulate=accumulate,
                   collect_hist=collect_hist, n_visible=n_visible)
    dev = m.device
    lib = _library()
    tb = _tile_chains(
        B, lambda t: lib.sweep_sparse_smem_bytes(t, N, op.C, op.noise_code),
        card_limits(dev), block_b,
        f"N={N} spins (plus {op.C} LFSR registers) is too large for one "
        f"block; shard the lattice")
    n_blocks = -(-B // tb)
    threads = min(1024, max(64, 32 * (-(-N // 32))))
    out = _outputs(m, noise_state, n_blocks, (D, N), accumulate,
                   collect_hist, n_visible)
    with torch.cuda.device(dev):
        rc = lib.sweep_sparse_launch(
            _ptr(m), _ptr(out["m"]), B, N, D, S, _ptr(nbr_idx), _ptr(nbr_w),
            *map(_ptr, op.rows), _ptr(op.mask0), _ptr(op.mask1), _ptr(betas),
            _ptr(op.clamp_mask), _ptr(op.clamp_values), _ptr(op.measured),
            _ptr(op.visible_idx), n_visible if collect_hist else 0,
            op.noise_code, _ptr(noise_state), _ptr(out["noise"]), op.C,
            _ptr(op.perm), int(decimation), op.row0, op.col0,
            int(half_offset), int(n_half), _ptr(out["part_s"]),
            _ptr(out["part_c"]), _ptr(out["s"]), _ptr(out["c"]),
            _ptr(out["part_h"]), _ptr(out["h"]), tb, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_cuda(lib, rc, "sweep_sparse launch")
    sweep_sparse.launches += 1
    return _result(out)


sweep_sparse.launches = 0


_STREAM_ARGTYPES = (
    [_VP, _VP, _I, _I, _I, _I]          # m_in, m_out, B, N, D, S
    + [_VP] * 10                        # idx, w, h, gain, off, rg, co, masks, betas
    + [_VP, _VP, _VP, _VP]              # clamp mask/values, noise in/out
    + [_U, _U, _I, _I]                  # row0, col0, half_offset, n_half
    + [_VP] * 4                         # next_w, next_h, staged_w, staged_h
    + [_I, _I, _VP]                     # tb, threads, stream
)


def sweep_sparse_stream(
    m: torch.Tensor,              # (B, N) float32 spins in {-1, +1}
    nbr_idx: torch.Tensor,        # (D, N) int32 neighbor table
    nbr_w: torch.Tensor,          # (D, N) float32 CURRENT program's slots
    h: torch.Tensor,              # (N,)   float32 CURRENT program's biases
    gain: torch.Tensor,
    off: torch.Tensor,
    rand_gain: torch.Tensor,
    comp_off: torch.Tensor,
    mask0: torch.Tensor,          # (N,) bool — colour-0 update set
    mask1: torch.Tensor,          # (N,) bool — colour-1 update set
    betas: torch.Tensor,          # (S, B) float32
    noise_state: torch.Tensor,    # (2,) int32 counter state
    next_nbr_w: torch.Tensor,     # (D, N) float32 NEXT program's slots
    next_h: torch.Tensor,         # (N,)   float32 NEXT program's biases
    clamp_mask: torch.Tensor | None = None,      # (N,) bool
    clamp_values: torch.Tensor | None = None,    # (B, N) float32, ±1
    coord_offset=None,            # (row0, col0) Python ints
    *,
    noise_mode: str = NOISE_COUNTER,
    measured=None,
    accumulate: bool = False,
    collect_hist: bool = False,
    staged=None,                  # (staged_w, staged_h) buffers, or None
    block_b: int | None = None,
    half_offset: int = 0,
    n_half: int | None = None,
):
    """`sweep_sparse` with a double-buffered program upload: run the
    CURRENT program's sweeps while the NEXT program is copied into the
    staged buffers.

    Returns ``(m', noise_state', staged_w, staged_h)``: spins and noise
    state equal `sweep_sparse`'s on the current program bit for bit
    (``noise_state'`` is ``ctr0 + n_half``), and the staged pair equals
    ``(next_nbr_w, next_h)`` exactly — feed it back as the next launch's
    ``(nbr_w, h)``.  ``staged`` names the output buffers (the free slot of
    a two-slot ring the caller swaps); None allocates them.  No buffer may
    share its storage with another role (current, next, staged): the
    wrapper raises.  Counter noise only, no moments or histogram (the
    ``noise_mode`` / ``measured`` / ``accumulate`` / ``collect_hist``
    arguments exist to be refused, as the reference refuses them).

    CPU tensors go to `sweep_sparse_stream_ref`.  A CUDA tensor launches
    the kernel or raises; ``sweep_sparse_stream.launches`` counts the
    launches.
    """
    if not m.is_cuda:
        return sweep_sparse_stream_ref(
            m, nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off, mask0,
            mask1, betas, noise_state, next_nbr_w, next_h, clamp_mask,
            clamp_values, coord_offset, noise_mode=noise_mode,
            measured=measured, accumulate=accumulate,
            collect_hist=collect_hist, staged=staged,
            half_offset=half_offset, n_half=n_half)

    _check_stream(noise_mode, measured, accumulate, collect_hist, next_h)
    _check_stream_buffers(nbr_w, h, next_nbr_w, next_h, staged)
    B, N = m.shape
    D = nbr_idx.shape[0]
    S = betas.shape[0]
    n_half = _window(S, half_offset, n_half)
    _want("nbr_idx", nbr_idx, torch.int32, (D, N))
    _want("nbr_w", nbr_w, torch.float32, (D, N))
    _want("next_nbr_w", next_nbr_w, torch.float32, (D, N))
    _want("next_h", next_h, torch.float32, (N,))
    if staged is None:
        staged = (torch.empty_like(next_nbr_w), torch.empty_like(next_h))
    _want("staged_w", staged[0], torch.float32, (D, N))
    _want("staged_h", staged[1], torch.float32, (N,))
    op = _operands(m, (h, gain, off, rand_gain, comp_off), mask0, mask1,
                   betas, noise_state, clamp_mask, clamp_values, None, None,
                   coord_offset, noise_mode=NOISE_COUNTER, gather_perm=None,
                   accumulate=False, collect_hist=False, n_visible=0)
    dev = m.device
    lib = _library()
    tb = _tile_chains(
        B, lambda t: lib.sweep_sparse_smem_bytes(t, N, 0, 0),
        card_limits(dev), block_b,
        f"N={N} spins is too large for one block; shard the lattice")
    threads = min(1024, max(64, 32 * (-(-N // 32))))
    m_out = torch.empty_like(m)
    ns_out = torch.empty_like(noise_state)
    with torch.cuda.device(dev):
        rc = lib.sweep_sparse_stream_launch(
            _ptr(m), _ptr(m_out), B, N, D, S, _ptr(nbr_idx), _ptr(nbr_w),
            *map(_ptr, op.rows), _ptr(op.mask0), _ptr(op.mask1), _ptr(betas),
            _ptr(op.clamp_mask), _ptr(op.clamp_values), _ptr(noise_state),
            _ptr(ns_out), op.row0, op.col0, int(half_offset), int(n_half),
            _ptr(next_nbr_w), _ptr(next_h), _ptr(staged[0]),
            _ptr(staged[1]), tb, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_cuda(lib, rc, "sweep_sparse_stream launch")
    sweep_sparse_stream.launches += 1
    return m_out, ns_out, staged[0], staged[1]


sweep_sparse_stream.launches = 0


# ---------------------------------------------------------------------------
# K5: every row band of the card in one launch, halos refreshed inside it
# ---------------------------------------------------------------------------
def _check_exchange(m, n_loc, halo, mode, measured, next_nbr_w, next_h):
    if mode not in ("barrier", "async"):
        raise ValueError(f"mode must be 'barrier' or 'async', got {mode!r}")
    if m.ndim != 3:
        raise ValueError(f"m must be (bands, chains, n_loc + 2*halo), got "
                         f"shape {tuple(m.shape)}")
    if m.shape[2] != n_loc + 2 * halo:
        raise ValueError(
            f"m has {m.shape[2]} columns per band, the extended block "
            f"[local | halo_up | halo_dn] has n_loc + 2*halo = "
            f"{n_loc + 2 * halo}")
    if next_nbr_w is not None:
        if next_h is None:
            raise ValueError("next_nbr_w without next_h")
        if measured is not None:
            raise ValueError(
                "program streaming excludes in-kernel moment accumulation "
                "— a swapped program invalidates the accumulators mid-launch")


def _band_coords(coord_offset, R, device):
    """(row0, col0): row0 a Python int in [0, 2**32), col0 each band's
    global column 0 as an int32 tensor of uint32 bit patterns on
    ``device``.  ``coord_offset`` names col0 as Python ints, or as that
    tensor already (nothing to upload)."""
    if coord_offset is None:
        return 0, torch.zeros(R, dtype=torch.int32, device=device)
    row0, col0 = coord_offset
    if isinstance(col0, torch.Tensor):
        if col0.dtype != torch.int32 or col0.device != torch.device(device):
            raise ValueError(
                f"coord_offset's band columns must be int32 bit patterns on "
                f"{device}, got {col0.dtype} on {col0.device}")
    else:
        col0 = lfsr_mod.from_u64(torch.tensor(
            [int(c) & 0xFFFFFFFF for c in col0], dtype=torch.int64,
            device=device))
    if tuple(col0.shape) != (R,):
        raise ValueError(f"coord_offset names {tuple(col0.shape)} band "
                         f"columns for {R} bands")
    return int(row0) & 0xFFFFFFFF, col0


def sweep_sparse_exchange_ref(
    m, nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off, mask0, mask1,
    betas, noise_state, send_up, send_dn, clamp_mask=None, clamp_values=None,
    measured=None, coord_offset=None, next_nbr_w=None, next_h=None, *,
    n_loc, halo, ex_pts, ex_pts_device=None, mode="barrier", staged=None,
):
    """`sweep_sparse_exchange` in plain PyTorch, any device: same
    arguments (``ex_pts_device`` unused: it reads ``ex_pts``), same
    return tuple.  Every band at once, one half-sweep at a
    time (the arithmetic of `sweep_sparse_ref` with a band axis), the
    exchanges as index gathers over the band axis."""
    _check_exchange(m, n_loc, halo, mode, measured, next_nbr_w, next_h)
    R, B, N = m.shape
    D = nbr_idx.shape[1]
    S = betas.shape[0]
    dev = m.device
    H = halo
    segments = halo_exchange_segments(ex_pts, 2 * S)
    row0, col0 = _band_coords(coord_offset, R, dev)
    rows = torch.arange(B, device=dev)[:, None] + row0
    cols = (torch.arange(N, device=dev)[None, None, :]
            + lfsr_mod.to_u64(col0)[:, None, None])
    seed, ctr0 = noise_state[0], lfsr_mod.to_u64(noise_state[1])
    idx = [nbr_idx[:, d].to(torch.int64)[:, None, :].expand(R, B, N)
           for d in range(D)]
    up_cols = send_up.to(torch.int64)[:, None, :].expand(R, B, H)
    dn_cols = send_dn.to(torch.int64)[:, None, :].expand(R, B, H)
    rows_of = [x[:, None, :] for x in (h, gain, off, rand_gain, comp_off)]
    masks = (mask0.to(torch.bool)[:, None, :],
             mask1.to(torch.bool)[:, None, :])
    has_clamp = clamp_mask is not None and clamp_values is not None
    if has_clamp:
        cmask = clamp_mask.to(torch.bool)[:, None, :]
    accumulate = measured is not None
    if accumulate:
        s_sum = torch.zeros((R, N), dtype=torch.float32, device=dev)
        c_sum = torch.zeros((R, D, N), dtype=torch.float32, device=dev)

    def boundaries(m):
        """What each band's neighbours send it: (halo_up, halo_dn)."""
        last = m.gather(2, dn_cols)     # a band's last row -> the one below
        first = m.gather(2, up_cols)    # its first row -> the one above
        zero = m.new_zeros((1, B, H))
        return (torch.cat([zero, last[:-1]]), torch.cat([first[1:], zero]))

    def install(m, halos):
        return torch.cat([m[:, :, :n_loc], halos[0], halos[1]], dim=2)

    pend = None
    for e, (h0, h1) in enumerate(segments):
        sent = boundaries(m)
        if mode == "barrier":
            m = install(m, sent)
        elif e > 0:
            m = install(m, pend)
        pend = sent
        for g in range(h0, h1):
            s, c = g // 2, g % 2
            if has_clamp and (c == 0 or g == h0):
                m = torch.where(cmask, clamp_values, m)
            u = lfsr_mod.counter_uniform(seed, ctr0 + g, rows, cols)
            acc = torch.zeros((R, B, N), dtype=torch.float32, device=dev)
            for d in range(D):
                acc = acc + nbr_w[:, d][:, None, :] * m.gather(2, idx[d])
            m = field_decision_update(m, acc + rows_of[0], *rows_of[1:],
                                      masks[c], betas[s], u)
            if c == 1 and accumulate:
                w = measured[s]
                s_sum = s_sum + w * m.sum(dim=1)
                c_sum = c_sum + w * torch.stack(
                    [(m * m.gather(2, idx[d])).sum(dim=1)
                     for d in range(D)], dim=1)
    if mode == "async":
        m = install(m, pend)

    ns = torch.stack([lfsr_mod.to_u64(noise_state[0]),
                      (ctr0 + 2 * S) & 0xFFFFFFFF])
    outs = [m, lfsr_mod.from_u64(ns)]
    if accumulate:
        outs += [s_sum, c_sum]
    elif next_nbr_w is not None:
        if staged is None:
            staged = (torch.empty_like(next_nbr_w, dtype=torch.float32),
                      torch.empty_like(next_h, dtype=torch.float32))
        staged[0].copy_(next_nbr_w)
        staged[1].copy_(next_h)
        outs += list(staged)
    return tuple(outs)


_EXCHANGE_ARGTYPES = (
    [_VP, _VP] + [_I] * 7               # m_in, m_out, R, B, N, D, S, n_loc, H
    + [_VP] * 10                        # idx, w, h, gain, off, rg, co, masks, betas
    + [_VP] * 5                         # send_up/dn, clamp mask/values, measured
    + [_VP, _VP, _U, _VP]               # noise in/out, row0, col0
    + [_VP, _I, _I]                     # ex_pts, n_ex, async
    + [_VP] * 4                         # part_s, part_c, out_s, out_c
    + [_VP] * 4                         # next_w, next_h, staged_w, staged_h
    + [_VP, _VP, _I, _I, _VP]           # mailbox, barrier, tb, threads, stream
)
_MAILBOX_SLOTS = 3
_EXCHANGE_TILES: dict = {}   # launch shape on a card -> chains per block


def _exchange_library() -> ctypes.CDLL:
    lib = build.load("sweep_exchange")
    if lib.sweep_sparse_exchange_launch.argtypes is None:
        lib.sweep_sparse_exchange_launch.argtypes = _EXCHANGE_ARGTYPES
        lib.sweep_sparse_exchange_launch.restype = _I
        lib.sweep_exchange_max_blocks.argtypes = [
            _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
        lib.sweep_exchange_max_blocks.restype = _I
        lib.sweep_exchange_error_string.argtypes = [_I]
        lib.sweep_exchange_error_string.restype = ctypes.c_char_p
    return lib


# K5's residency model, for resolving ``auto`` without the card: a block
# takes the tile's spins plus the runtime's reserved kilobyte of shared
# memory, and the kernel's __launch_bounds__(1024) lets the compiler use up
# to 64 registers a thread, which the model assumes it does — so the model
# never promises more resident blocks than the occupancy API finds.
EXCHANGE_REGS_PER_THREAD = 64
SMEM_RESERVED_PER_BLOCK = 1024
MAX_BLOCKS_PER_SM = 32


def exchange_threads(N: int) -> int:
    """Threads of one K5 block over ``N`` extended columns."""
    return min(1024, max(64, 32 * (-(-N // 32))))


def exchange_smem_bytes(tb: int, N: int) -> int:
    """Shared memory of one K5 block: ``tb`` chains of ``N`` int8 spins,
    padded to 16 bytes (``pbit::tile_spin_bytes``)."""
    return (tb * N + 15) & ~15


def exchange_blocks_per_sm(tb: int, N: int,
                           limits: CardLimits = H100) -> int:
    """The model's resident K5 blocks per SM at ``tb`` chains per block (0
    when one block's spins exceed a block's shared memory)."""
    smem = exchange_smem_bytes(tb, N)
    if smem > limits.smem_per_block:
        return 0
    threads = exchange_threads(N)
    return min(MAX_BLOCKS_PER_SM, limits.threads_per_sm // threads,
               limits.regs_per_sm // (EXCHANGE_REGS_PER_THREAD * threads),
               limits.smem_per_sm // (smem + SMEM_RESERVED_PER_BLOCK))


def exchange_resident_feasible(R: int, B: int, N: int,
                               limits: CardLimits = H100) -> bool:
    """Whether some chain tiling lets all ``R·ceil(B/tb)`` blocks of one
    K5 launch (``R`` bands, ``B`` chains, ``N`` extended columns) be
    resident at once, by the model above."""
    for tb in range(1, B + 1):
        per_sm = exchange_blocks_per_sm(tb, N, limits)
        if per_sm == 0:       # wider tiles take more shared memory still
            return False
        if R * -(-B // tb) <= per_sm * limits.sms:
            return True
    return False


def _exchange_tile_chains(lib, R, B, N, D, stream, threads, limits,
                         block_b=None) -> int:
    """Chains per K5 block: the fewest that let all ``R·ceil(B/tb)``
    blocks be resident at once (the blocks wait for each other at every
    exchange point), within a block's shared memory.  ``block_b`` is
    checked instead of chosen.  Raises ValueError when no tiling fits."""
    def resident(tb):
        smem = exchange_smem_bytes(tb, N)
        if smem > limits.smem_per_block:
            return None
        out = ctypes.c_int(0)
        rc = lib.sweep_exchange_max_blocks(D, int(stream), threads, smem,
                                           ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(
                f"occupancy query: CUDA error {rc} "
                f"({lib.sweep_exchange_error_string(rc).decode()})")
        return out.value

    candidates = [int(block_b)] if block_b is not None else range(1, B + 1)
    for tb in candidates:
        fits = resident(tb)
        if fits is None:
            break
        if R * -(-B // tb) <= fits:
            return tb
    raise ValueError(
        f"the halo-exchange kernel needs all its blocks resident at once: "
        f"{R} bands x {B} chains of {N} columns do not fit the card at any "
        f"tiling (block_b={block_b}); use fewer bands or chains, or "
        f"backend='sparse'")


def sweep_sparse_exchange(
    m: torch.Tensor,              # (R, B, N) float32, N = n_loc + 2*halo
    nbr_idx: torch.Tensor,        # (R, D, N) int32 extended-local table
    nbr_w: torch.Tensor,          # (R, D, N) float32
    h: torch.Tensor,              # (R, N) float32 rows
    gain: torch.Tensor,
    off: torch.Tensor,
    rand_gain: torch.Tensor,
    comp_off: torch.Tensor,
    mask0: torch.Tensor,          # (R, N) bool — halo columns excluded
    mask1: torch.Tensor,
    betas: torch.Tensor,          # (S, B) float32
    noise_state: torch.Tensor,    # (2,) int32 counter state
    send_up: torch.Tensor,        # (R, H) int32 first-row columns
    send_dn: torch.Tensor,        # (R, H) int32 last-row columns
    clamp_mask: torch.Tensor | None = None,      # (R, N) bool
    clamp_values: torch.Tensor | None = None,    # (R, B, N) float32, ±1
    measured: torch.Tensor | None = None,        # (S,) float32 weights
    coord_offset=None,            # (row0, col0 per band), see below
    next_nbr_w: torch.Tensor | None = None,      # (R, D, N) next program
    next_h: torch.Tensor | None = None,          # (R, N)
    *,
    n_loc: int,
    halo: int,
    ex_pts: tuple,                # launch-relative half-sweep indices
    ex_pts_device: torch.Tensor | None = None,   # ex_pts as int32 on m's card
    mode: str = "barrier",
    staged=None,                  # (staged_w, staged_h) buffers, or None
    block_b: int | None = None,   # chains per block; None -> fit the card
):
    """S resident sweeps of every row band in one launch, the halos
    refreshed inside it at every exchange point — K5.

    ``m`` holds each band's extended block ``[local | halo_up | halo_dn]``
    (``halo`` columns each, never updated: keep them out of the masks).  At
    each point of ``ex_pts`` every band publishes its columns ``send_up`` /
    ``send_dn``; under ``mode="barrier"`` the next half-sweeps read the
    fresh values, under ``"async"`` the previous exchange's (the first
    window runs on the halo columns given) and the last exchange is
    installed at the end.  Edge bands read zeros.  Counter noise at
    ``(chain + row0, column + col0[band])``; ``coord_offset`` gives row0 as
    a Python int and col0 as Python ints or as an int32 (R,) tensor of
    uint32 bit patterns on m's device.  A caller that launches the same
    shape many times passes col0 and ``ex_pts_device`` as tensors built
    once, so a launch uploads nothing.

    Returns ``(m', noise_state'[, s_sum (R, N), c_slots (R, D, N)])`` or,
    with a next program, ``(m', noise_state', staged_w, staged_h)``;
    ``noise_state'`` is ``ctr0 + 2S``.  With 0/1 ``measured`` the moments
    are integer sums and equal `sweep_sparse_exchange_ref`'s bit for bit.

    CPU tensors go to `sweep_sparse_exchange_ref`.  A CUDA tensor launches
    the kernel (a cooperative launch: the grid must be resident at once,
    or the wrapper raises) or raises; ``sweep_sparse_exchange.launches``
    counts the launches.
    """
    if not m.is_cuda:
        return sweep_sparse_exchange_ref(
            m, nbr_idx, nbr_w, h, gain, off, rand_gain, comp_off, mask0,
            mask1, betas, noise_state, send_up, send_dn, clamp_mask,
            clamp_values, measured, coord_offset, next_nbr_w, next_h,
            n_loc=n_loc, halo=halo, ex_pts=ex_pts, mode=mode, staged=staged)

    _check_exchange(m, n_loc, halo, mode, measured, next_nbr_w, next_h)
    R, B, N = m.shape
    D = nbr_idx.shape[1]
    S = betas.shape[0]
    H = halo
    pts = halo_exchange_segments(ex_pts, 2 * S)
    dev = m.device
    f32, i32 = torch.float32, torch.int32
    _want("m", m, f32, (R, B, N))
    _want("nbr_idx", nbr_idx, i32, (R, D, N))
    _want("nbr_w", nbr_w, f32, (R, D, N))
    rows = [_want(n, t, f32, (R, N)) for n, t in zip(
        ("h", "gain", "off", "rand_gain", "comp_off"),
        (h, gain, off, rand_gain, comp_off))]
    masks = [_want(n, t.to(torch.uint8) if t.dtype == torch.bool else t,
                   torch.uint8, (R, N))
             for n, t in (("mask0", mask0), ("mask1", mask1))]
    _want("betas", betas, f32, (S, B))
    _want("noise_state", noise_state, i32, (2,))
    _want("send_up", send_up, i32, (R, H))
    _want("send_dn", send_dn, i32, (R, H))
    cm = cv = None
    if clamp_mask is not None and clamp_values is not None:
        cm = _want("clamp_mask", clamp_mask.to(torch.uint8)
                   if clamp_mask.dtype == torch.bool else clamp_mask,
                   torch.uint8, (R, N))
        cv = _want("clamp_values", clamp_values, f32, (R, B, N))
    if measured is not None:
        _want("measured", measured, f32, (S,))
    stream = next_nbr_w is not None
    if stream:
        _want("next_nbr_w", next_nbr_w, f32, (R, D, N))
        _want("next_h", next_h, f32, (R, N))
        if staged is None:
            staged = (torch.empty_like(next_nbr_w), torch.empty_like(next_h))
        _want("staged_w", staged[0], f32, (R, D, N))
        _want("staged_h", staged[1], f32, (R, N))
        _check_stream_buffers(nbr_w, h, next_nbr_w, next_h, staged)
    row0, col0_t = _band_coords(coord_offset, R, dev)
    if ex_pts_device is None:
        ex_pts_device = torch.tensor([p0 for p0, _ in pts], dtype=i32,
                                     device=dev)
    _want("ex_pts_device", ex_pts_device, i32, (len(pts),))

    lib = _exchange_library()
    threads = exchange_threads(N)
    with torch.cuda.device(dev):
        key = (dev.index, R, B, N, D, stream, threads, block_b)
        tb = _EXCHANGE_TILES.get(key)
        if tb is None:
            tb = _exchange_tile_chains(lib, R, B, N, D, stream, threads,
                                      card_limits(dev), block_b)
            _EXCHANGE_TILES[key] = tb
        n_blocks = R * -(-B // tb)
        m_out = torch.empty_like(m)
        ns_out = torch.empty_like(noise_state)
        part_s = part_c = s_out = c_out = None
        if measured is not None:
            part_s = torch.empty((n_blocks, N), dtype=f32, device=dev)
            part_c = torch.empty((n_blocks, D, N), dtype=f32, device=dev)
            s_out = torch.empty((R, N), dtype=f32, device=dev)
            c_out = torch.empty((R, D, N), dtype=f32, device=dev)
        mailbox = torch.empty((_MAILBOX_SLOTS, R, 2, B, H), dtype=torch.int8,
                              device=dev)
        barrier = torch.empty((1,), dtype=i32, device=dev)
        rc = lib.sweep_sparse_exchange_launch(
            _ptr(m), _ptr(m_out), R, B, N, D, S, int(n_loc), H,
            _ptr(nbr_idx), _ptr(nbr_w), *map(_ptr, rows), _ptr(masks[0]),
            _ptr(masks[1]), _ptr(betas), _ptr(send_up), _ptr(send_dn),
            _ptr(cm), _ptr(cv), _ptr(measured), _ptr(noise_state),
            _ptr(ns_out), row0, _ptr(col0_t), _ptr(ex_pts_device), len(pts),
            int(mode == "async"), _ptr(part_s), _ptr(part_c), _ptr(s_out),
            _ptr(c_out), _ptr(next_nbr_w), _ptr(next_h),
            _ptr(staged[0] if stream else None),
            _ptr(staged[1] if stream else None), _ptr(mailbox),
            _ptr(barrier), tb, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.sweep_exchange_error_string(rc).decode()
        raise RuntimeError(f"sweep_sparse_exchange launch: CUDA error {rc} "
                           f"({msg})")
    sweep_sparse_exchange.launches += 1
    outs = [m_out, ns_out]
    if measured is not None:
        outs += [s_out, c_out]
    elif stream:
        outs += list(staged)
    return tuple(outs)


sweep_sparse_exchange.launches = 0


# ---------------------------------------------------------------------------
# the dense engine: its plan on Hopper, the record windows, the wrapper
# ---------------------------------------------------------------------------
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # CTAs a cluster of the dense engine may have
MAX_CLUSTER_WAVES = 4             # more waves: the streamed body (measured)
CHAINS_PER_THREAD = 4             # csrc/sweep_fused.cu kChainsPerThread
MAX_CLUSTER_THREADS = 512         # its __launch_bounds__ (128 registers)
MIN_CLUSTER_THREADS = 256         # enough warps to load W's rows quickly
RECORD_CHAIN_ALIGN = 32           # the int8 mma's depth: the record's chains


class DensePlan(NamedTuple):
    """How one K3 launch runs: which body, CTAs per cluster, chains per tile
    and the launch geometry the CUDA source expects."""

    body: str           # "cluster" (W in a cluster's shared memory) or
    #                     "streamed" (W read from L2 every half-sweep)
    cluster_size: int   # CTAs per cluster (1 for the streamed body)
    chains: int         # chains per tile: per cluster, or per block
    rows_cap: int       # rows of W one CTA holds (cluster body; else 0)
    threads: int
    smem_bytes: int


def dense_smem_bytes(tb: int, N: int, C: int = 0) -> int:
    """Shared memory of one block of the streamed body, the layout
    ``csrc/sweep_fused.cu::k3_streamed_sweeps`` carves up: two float32 spin
    buffers of the tile, its LFSR registers, the two colours' update lists
    and the compaction scratch."""
    return 2 * tb * N * 4 + tb * C * 4 + 2 * N * 4 + 33 * 4


def cluster_rows(N: int, k: int) -> int:
    """Rows of W one CTA of a k-CTA cluster holds: its pieces of both
    colours' update lists, ``ceil(n0/k) + ceil(n1/k) <= ceil(N/k) + 1``
    for disjoint colours (rows past it are read from device memory)."""
    return -(-N // k) + 1


def w_row_words(N: int) -> int:
    """Stride of a row of W in the cluster body's shared memory: N rounded
    up to 4 (zeros past N) and then to 4 mod 32, so that eight lanes
    reading 16 bytes of eight consecutive rows hit 32 distinct banks
    (``csrc/sweep_fused.cu::w_row_words``)."""
    n4 = -(-N // 4) * 4
    return -(-(n4 - 4) // 32) * 32 + 4


def cluster_smem_bytes(k: int, tb: int, N: int, C: int = 0) -> int:
    """Shared memory of one CTA of the cluster body
    (``csrc/sweep_fused.cu::k3_cluster_sweeps``): two float32 spin buffers
    of N rounded up to 4 rows by ``tb`` chains padded to
    `CHAINS_PER_THREAD`, the rows of W (`w_row_words` each), the tile's
    LFSR registers, the update lists, the compaction scratch and a byte
    of colour bits per node."""
    tbp = CHAINS_PER_THREAD * -(-tb // CHAINS_PER_THREAD)
    n4 = -(-N // 4) * 4
    return 4 * (2 * n4 * tbp + cluster_rows(N, k) * w_row_words(N)
                + tb * C + 2 * N + 33) + N


def _cluster_threads(N: int, k: int, tb: int) -> int:
    """One thread per (row of a colour piece, group of four chains), at
    least `MIN_CLUSTER_THREADS` (to load W's rows at the start) and at
    most `MAX_CLUSTER_THREADS` (threads then stride over the pairs)."""
    pairs = -(-N // k) * -(-tb // CHAINS_PER_THREAD)
    return min(MAX_CLUSTER_THREADS,
               max(MIN_CLUSTER_THREADS, 32 * -(-pairs // 32)))


def _cluster_plan(N: int, k: int, tb: int, C: int) -> DensePlan:
    return DensePlan("cluster", k, tb, cluster_rows(N, k),
                     _cluster_threads(N, k, tb),
                     cluster_smem_bytes(k, tb, N, C))


def dense_plan(N: int, B: int, C: int = 0, limits: CardLimits = H100, *,
               block_b: int | None = None, resident=None) -> DensePlan:
    """The body, cluster size and chains per tile of a K3 launch.

    The cluster body runs where the rows of W fit the shared memory of a
    cluster and its clusters cover the chains in at most
    `MAX_CLUSTER_WAVES` waves.  Of the cluster sizes (`CLUSTER_SIZES`) whose CTAs hold their
    rows, it takes the smallest whose clusters the card holds at once
    cover the B chains in one wave — ``ceil(B / resident)`` chains a
    cluster, as far as they fit — and, where none does, the one with the
    fewest waves.  ``resident(plan)`` is the number of clusters of
    ``plan``'s shape the card holds at once: the wrapper asks the card
    (`resident_clusters`); without it the model is ``sms // k``.
    Otherwise the streamed body, with `_tile_chains`' blocks.  On an H100
    (``benchmarks_torch/k3_parts.py``) the cluster body takes 5 % less
    time at 2 waves (N=600, 256 chains) and 41 % less at 3 (N=864, 64
    chains); the two are within 7 % of each other at 5 (N=800, 256
    chains), and the streamed body takes 32 % less at 10 (N=864).
    ``block_b`` asks for the chains per tile (a cluster's or a block's):
    the smallest cluster that holds that many, else as many as fit.
    `CLUSTER_SIZES` is read at each call, so a diagnostic may narrow it
    (``()`` takes the streamed body).  Raises ValueError when one chain
    does not fit."""
    limit = limits.smem_per_block
    if resident is None:
        resident = lambda plan: max(1, limits.sms // plan.cluster_size)  # noqa: E731
    best = None
    for k in CLUSTER_SIZES:
        if cluster_smem_bytes(k, 1, N, C) > limit:
            continue
        if block_b is not None:
            # the smallest cluster that holds the asked chains, else the
            # largest that holds W, with as many chains as fit
            tb = max(1, min(int(block_b), B))
            fits = cluster_smem_bytes(k, tb, N, C) <= limit
            while cluster_smem_bytes(k, tb, N, C) > limit:
                tb -= 1
            best = (0, _cluster_plan(N, k, tb, C))
            if fits:
                break
            continue
        held = max(1, resident(_cluster_plan(N, k, 1, C)))
        tb = max(1, min(B, -(-B // held)))
        while cluster_smem_bytes(k, tb, N, C) > limit:
            tb -= 1
        plan = _cluster_plan(N, k, tb, C)
        waves = -(-(-(-B // tb)) // max(1, resident(plan)))
        if best is None or waves < best[0]:
            best = (waves, plan)
        if waves == 1:
            break
    if best is not None and best[0] <= MAX_CLUSTER_WAVES:
        return best[1]
    tb = _tile_chains(B, lambda t: dense_smem_bytes(t, N, C), limits,
                      block_b, f"N={N} spins in the dense engine; use the "
                      f"slot layout (fused_sparse)")
    threads = min(1024, max(64, 32 * (-(-tb * (-(-N // 2)) // 32))))
    return DensePlan("streamed", 1, tb, 0, threads,
                     dense_smem_bytes(tb, N, C))


def record_chains(B: int) -> int:
    """Chains of a record row: B rounded up to `RECORD_CHAIN_ALIGN`."""
    return RECORD_CHAIN_ALIGN * -(-B // RECORD_CHAIN_ALIGN)


def dense_record_windows(S: int, N: int, B: int,
                         limits: CardLimits = H100) -> list[tuple[int, int]]:
    """The windows ``[s0, s1)`` of sweeps one K3 call with statistics runs
    as consecutive launches, so that its spin record — ``(s1 - s0, N,
    record_chains(B))`` int8 — stays within ``limits.record_bytes``.
    Spins, noise state and the running statistics carry from one window
    into the next (`run_windows`), so the result is the same bits as one
    window.  Raises ValueError when one sweep's record does not fit."""
    per_sweep = N * record_chains(B)
    cap = limits.record_bytes
    if per_sweep > cap:
        raise ValueError(
            f"one sweep's spin record of N={N} spins over {B} chains takes "
            f"{per_sweep} bytes, more than the {cap} a launch may hold")
    step = max(1, min(S, cap // per_sweep))
    return [(s0, min(S, s0 + step)) for s0 in range(0, S, step)]


def run_windows(launch, windows, m, noise_state, betas, measured):
    """Chain ``launch(m, noise_state, betas_w, measured_w, stats_in)`` over
    ``windows`` (`dense_record_windows`): spins and noise state flow from
    one window into the next, and each continues the statistics the one
    before returned (``stats_in`` None for the first).  Returns the last
    window's ``(m', noise_state', *stats)``."""
    stats = None
    for s0, s1 in windows:
        out = launch(m, noise_state, betas[s0:s1],
                     None if measured is None else measured[s0:s1], stats)
        m, noise_state, stats = out[0], out[1], tuple(out[2:])
    return (m, noise_state, *(stats or ()))


def dense_resident_feasible(N: int, B: int,
                            limits: CardLimits = H100) -> bool:
    """The model of the dense resident engine's limits (K3) on a Hopper
    card: one chain of the tile fits shared memory, and either the rows of
    W fit a cluster's shared memory (the cluster body) or W (4·N² bytes)
    fits the L2 from which the streamed body reads it every half-sweep.
    The statistics do not bind at any chain count: their record runs in
    windows.  The TPU's model (``repro.api.spec.dense_vmem_feasible``)
    asked whether W fits 16 MB of VMEM instead, which depends on N
    alone."""
    try:
        plan = dense_plan(N, B, limits=limits)
    except ValueError:
        return False
    return plan.body == "cluster" or 4 * N * N <= limits.l2_bytes


_DENSE_ARGTYPES = (
    [_VP, _VP, _I, _I, _I, _VP, _VP]    # m_in, m_out, B, N, S, W, WT
    + [_VP] * 8                         # h, gain, off, rg, co, masks, betas
    + [_VP, _VP, _VP, _VP, _I]          # clamp mask/values, measured, vis, nv
    + [_I, _VP, _VP, _I, _VP, _I]       # noise mode/in/out, C, perm, decimation
    + [_U, _U]                          # row0, col0
    + [_VP, _I, _VP, _VP, _VP, _I]      # rec, B_pad, out_s, out_c, out_h, carry
    + [_I] * 6                          # body, k, tb, rows_cap, threads, smem
    + [_VP]                             # stream
)


def _dense_library() -> ctypes.CDLL:
    lib = build.load("sweep_fused")
    if lib.sweep_fused_launch.argtypes is None:
        lib.sweep_fused_launch.argtypes = _DENSE_ARGTYPES
        lib.sweep_fused_launch.restype = _I
        lib.sweep_fused_max_clusters.argtypes = [
            _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
        lib.sweep_fused_max_clusters.restype = _I
        lib.sweep_fused_error_string.argtypes = [_I]
        lib.sweep_fused_error_string.restype = ctypes.c_char_p
    return lib


def _raise_dense(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sweep_fused_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


_CLUSTER_FIT: dict = {}


def resident_clusters(plan: DensePlan, device) -> int:
    """Clusters of ``plan``'s shape the card can hold at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot run)."""
    dev = torch.device(device)
    key = (dev.index, plan.cluster_size, plan.threads, plan.smem_bytes)
    if key not in _CLUSTER_FIT:
        lib = _dense_library()
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = lib.sweep_fused_max_clusters(
                plan.cluster_size, plan.threads, plan.smem_bytes,
                ctypes.byref(out))
        _raise_dense(lib, rc, "cudaOccupancyMaxActiveClusters")
        _CLUSTER_FIT[key] = out.value
    return _CLUSTER_FIT[key]


def sweep_fused(
    m: torch.Tensor,              # (B, N) float32 spins in {-1, +1}
    W: torch.Tensor,              # (N, N) float32 directional couplings
    h: torch.Tensor,              # (N,) float32 rows
    gain: torch.Tensor,
    off: torch.Tensor,
    rand_gain: torch.Tensor,
    comp_off: torch.Tensor,
    mask0: torch.Tensor,          # (N,) bool — colour-0 update set
    mask1: torch.Tensor,          # (N,) bool — colour-1 update set
    betas: torch.Tensor,          # (S, B) float32
    noise_state: torch.Tensor,    # int32 bits: counter (2,), lfsr (B, C)
    clamp_mask: torch.Tensor | None = None,      # (N,) bool
    clamp_values: torch.Tensor | None = None,    # (B, N) float32, ±1
    measured: torch.Tensor | None = None,        # (S,) float32 weights
    visible_idx: torch.Tensor | None = None,     # (n_visible,) histogram nodes
    coord_offset=None,            # (row0, col0) Python ints, counter mode
    *,
    noise_mode: str = NOISE_COUNTER,
    decimation: int = 8,
    gather_perm=None,             # node -> flat LFSR column (length N)
    accumulate: bool = False,
    collect_hist: bool = False,
    n_visible: int = 0,
    block_b: int | None = None,   # chains per tile; None -> fill the SMs
):
    """Run S resident sweeps on the dense (N, N) couplings.

    Returns ``(m', noise_state'[, s_sum, c_sum][, hist])``: s_sum (N,) and
    the Gram matrix c_sum (N, N) ``= Σ mᵀm`` over (chains x measured
    sweeps) — read edge (i, j) at ``c_sum[i, j]``; hist (2^n_visible,) as
    in `sweep_sparse`.  All need dividing by their sample counts.
    ``coord_offset`` shifts the counter hash to global (chain, node)
    coordinates.

    The update within a half-sweep is synchronous: every input is computed
    from the spins before the half-sweep, so ``mask0`` / ``mask1`` may hold
    nodes that W couples.  The statistics are summed over all chains of a
    sweep, then over sweeps in order, as `sweep_fused_ref` sums them: they
    equal the plain version's bit for bit for any float ``measured``.
    `dense_plan` picks the body and the cluster size (``block_b``
    overrides its chains per tile); a cluster shape the card cannot hold
    raises.

    CPU tensors go to `sweep_fused_ref`.  A CUDA tensor launches the kernels
    or raises; ``sweep_fused.launches`` counts the calls that launch (a
    call whose record runs in several windows counts once).
    """
    if not m.is_cuda:
        return sweep_fused_ref(
            m, W, h, gain, off, rand_gain, comp_off, mask0, mask1, betas,
            noise_state, clamp_mask, clamp_values, measured, visible_idx,
            coord_offset, noise_mode=noise_mode, decimation=decimation,
            gather_perm=gather_perm, accumulate=accumulate,
            collect_hist=collect_hist, n_visible=n_visible)

    B, N = m.shape
    S = betas.shape[0]
    accumulate, collect_hist = _check_modes(
        noise_mode, gather_perm, coord_offset, accumulate, collect_hist,
        measured, visible_idx, n_visible)
    if S == 0:
        return _identity_result(m, noise_state, N, (N, N), accumulate,
                                collect_hist, n_visible)

    _want("W", W, torch.float32, (N, N))
    op = _operands(m, (h, gain, off, rand_gain, comp_off), mask0, mask1,
                   betas, noise_state, clamp_mask, clamp_values, measured,
                   visible_idx, coord_offset, noise_mode=noise_mode,
                   gather_perm=gather_perm, accumulate=accumulate,
                   collect_hist=collect_hist, n_visible=n_visible)
    dev = m.device
    limits = card_limits(dev)
    plan = dense_plan(N, B, op.C, limits, block_b=block_b,
                      resident=lambda p: resident_clusters(p, dev))
    lib = _dense_library()
    if plan.body == "cluster" and resident_clusters(plan, dev) == 0:
        raise ValueError(
            f"no cluster of {plan.cluster_size} CTAs x {plan.threads} "
            f"threads x {plan.smem_bytes} bytes of shared memory can run on "
            f"this card")
    cluster = plan.body == "cluster"
    WT = None if cluster else W.t().contiguous()
    record = accumulate or collect_hist
    windows = (dense_record_windows(S, N, B, limits) if record
               else [(0, S)])
    B_pad = record_chains(B)
    rec = (torch.empty((max(b - a for a, b in windows), N, B_pad),
                       dtype=torch.int8, device=dev) if record else None)
    f32 = torch.float32
    stats = [torch.empty((N,), dtype=f32, device=dev) if accumulate else None,
             torch.empty((N, N), dtype=f32, device=dev) if accumulate
             else None,
             torch.empty((2 ** n_visible,), dtype=f32, device=dev)
             if collect_hist else None]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(m_w, ns_w, betas_w, meas_w, stats_in):
        m_out = torch.empty_like(m_w)
        ns_out = torch.empty_like(ns_w)
        with torch.cuda.device(dev):
            rc = lib.sweep_fused_launch(
                _ptr(m_w), _ptr(m_out), B, N, betas_w.shape[0], _ptr(W),
                _ptr(WT), *map(_ptr, op.rows), _ptr(op.mask0),
                _ptr(op.mask1), _ptr(betas_w), _ptr(op.clamp_mask),
                _ptr(op.clamp_values), _ptr(meas_w), _ptr(op.visible_idx),
                n_visible if collect_hist else 0, op.noise_code, _ptr(ns_w),
                _ptr(ns_out), op.C, _ptr(op.perm), int(decimation), op.row0,
                op.col0, _ptr(rec), B_pad, *map(_ptr, stats),
                int(stats_in is not None), int(cluster), plan.cluster_size,
                plan.chains, plan.rows_cap, plan.threads, plan.smem_bytes,
                stream)
        _raise_dense(lib, rc, "sweep_fused launch")
        return (m_out, ns_out, *(t for t in stats if t is not None))

    out = run_windows(launch, windows, m, noise_state, betas, op.measured)
    sweep_fused.launches += 1
    return out


sweep_fused.launches = 0


def tanh_probe(x: torch.Tensor) -> torch.Tensor:
    """``tanhf`` as the kernel library's build computes it (diagnostic:
    held against `torch.tanh` to decide how kernel and plain version may
    be compared)."""
    x = _want("x", x, torch.float32, x.shape)
    y = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.tanh_probe(x.data_ptr(), y.data_ptr(), x.numel(),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_cuda(lib, rc, "tanh_probe launch")
    return y
