"""Sweep-resident block-sparse sampling engine: CUDA kernel + plain version.

`sweep_sparse` runs S chromatic sweeps (or a half-sweep window of them) of
the p-bit update on the Chimera-native fixed-degree slot layout in ONE
kernel launch: spins stay in shared memory, noise is generated in the
kernel from the reference's own integer streams, and CD moments and the
visible-pattern histogram accumulate in the launch.

It replaces the TPU kernel ``repro.kernels.sweep_fused.sweep_sparse_pallas``
(body ``_kernel`` with ``sparse=True``); the CUDA source is
``csrc/sweep_sparse.cu``.  On an H100 the kernel is bound by operations
(per flip: D gathers with a multiply-add, two 32-bit hashes, one tanhf),
not by bytes — every input is read once per launch — so the design keeps
the spins, the tile's LFSR registers and a node's weights on chip across
all half-sweeps and pays one block-wide barrier per half-sweep.

`sweep_sparse_ref` is the plain PyTorch version of the same function: a
Python loop of `sparse_neuron_input` + `field_decision_update` with noise
from `core.lfsr`.  The wrapper uses it only for tensors that lie on the
CPU; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import lfsr as lfsr_mod
from repro_torch.kernels import build
from repro_torch.kernels.ref import field_decision_update, sparse_neuron_input

NOISE_COUNTER = "counter"
NOISE_LFSR = "lfsr"
_NOISE_CODE = {NOISE_COUNTER: 0, NOISE_LFSR: 1}

MAX_HIST_VISIBLE = 12   # 2^nv histogram bins per block partial
MAX_TILE_CHAINS = 8     # chains per block the tile heuristic will pick
SMEM_LIMIT_FALLBACK = 232448  # 227 KB: Hopper's opt-in limit per block


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


def _identity_result(m, noise_state, N, D, accumulate, collect_hist,
                     n_visible):
    """An empty window: spins and noise state unchanged, zero statistics."""
    outs = [m, noise_state]
    if accumulate:
        outs += [m.new_zeros((N,)), m.new_zeros((D, N))]
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
        return _identity_result(m, noise_state, N, D, accumulate,
                                collect_hist, n_visible)
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
    if accumulate:
        s_sum = torch.zeros((N,), dtype=torch.float32, device=dev)
        c_slots = torch.zeros((D, N), dtype=torch.float32, device=dev)
    if collect_hist:
        vis = torch.as_tensor(visible_idx, device=dev).to(torch.int64)
        pow2 = 2 ** torch.arange(n_visible, device=dev)
        hist = torch.zeros((2 ** n_visible,), dtype=torch.float32, device=dev)

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
        I = sparse_neuron_input(m, nbr_idx, nbr_w, h)
        m = field_decision_update(m, I, gain, off, rand_gain, comp_off,
                                  masks[c], betas[s], u)
        if c == 1 and (accumulate or collect_hist):
            w = measured[s]
            if accumulate:
                s_sum = s_sum + w * m.sum(dim=0)
                c_slots = c_slots + w * torch.stack([
                    (m * m.index_select(1, nbr_idx[d])).sum(dim=0)
                    for d in range(D)])
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
        outs += [s_sum, c_slots]
    if collect_hist:
        outs.append(hist)
    return tuple(outs)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
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


def _tile_chains(lib, B, N, C, noise_code, dev, block_b):
    """Chains per block: enough blocks to cover the SMs, within the
    shared-memory limit a block may opt in to."""
    props = torch.cuda.get_device_properties(dev)
    limit = getattr(props, "shared_memory_per_block_optin",
                    SMEM_LIMIT_FALLBACK)
    if lib.sweep_sparse_smem_bytes(1, N, C, noise_code) > limit:
        raise ValueError(
            f"one chain of N={N} spins (plus {C} LFSR registers) does not "
            f"fit the {limit} bytes of shared memory a block can use on "
            f"this card; shard the lattice")
    if block_b is None:
        block_b = min(MAX_TILE_CHAINS,
                      -(-B // props.multi_processor_count))
    tb = max(1, min(int(block_b), B))
    while lib.sweep_sparse_smem_bytes(tb, N, C, noise_code) > limit:
        tb -= 1
    return tb


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
    spins and clamp values are exactly ±1, and ``mask0`` / ``mask1`` are
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
        return _identity_result(m, noise_state, N, D, accumulate,
                                collect_hist, n_visible)

    dev = m.device
    f32 = torch.float32
    _want("m", m, f32, (B, N))
    _want("nbr_idx", nbr_idx, torch.int32, (D, N))
    _want("nbr_w", nbr_w, f32, (D, N))
    rows = [_want(n, t, f32, (N,)) for n, t in (
        ("h", h), ("gain", gain), ("off", off), ("rand_gain", rand_gain),
        ("comp_off", comp_off))]
    mask0 = _mask_u8("mask0", mask0, N)
    mask1 = _mask_u8("mask1", mask1, N)
    _want("betas", betas, f32, (S, B))
    has_clamp = clamp_mask is not None and clamp_values is not None
    if has_clamp:
        clamp_mask = _mask_u8("clamp_mask", clamp_mask, N)
        _want("clamp_values", clamp_values, f32, (B, N))
    if accumulate or collect_hist:
        _want("measured", measured, f32, (S,))
    if collect_hist:
        visible_idx = torch.as_tensor(visible_idx, device=dev).to(
            torch.int32).contiguous()
        _want("visible_idx", visible_idx, torch.int32, (n_visible,))
    noise_code = _NOISE_CODE[noise_mode]
    row0 = col0 = 0
    C = 0
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

    lib = _library()
    tb = _tile_chains(lib, B, N, C, noise_code, dev, block_b)
    n_blocks = -(-B // tb)
    threads = min(1024, max(64, 32 * (-(-N // 32))))

    m_out = torch.empty_like(m)
    noise_out = torch.empty_like(noise_state)
    part_s = part_c = out_s = out_c = part_h = out_h = None
    if accumulate:
        part_s = torch.empty((n_blocks, N), dtype=f32, device=dev)
        part_c = torch.empty((n_blocks, D, N), dtype=f32, device=dev)
        out_s = torch.empty((N,), dtype=f32, device=dev)
        out_c = torch.empty((D, N), dtype=f32, device=dev)
    if collect_hist:
        part_h = torch.empty((n_blocks, 2 ** n_visible), dtype=f32,
                             device=dev)
        out_h = torch.empty((2 ** n_visible,), dtype=f32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.sweep_sparse_launch(
            ptr(m), ptr(m_out), B, N, D, S, ptr(nbr_idx), ptr(nbr_w),
            *(ptr(r) for r in rows), ptr(mask0), ptr(mask1), ptr(betas),
            ptr(clamp_mask) if has_clamp else None,
            ptr(clamp_values) if has_clamp else None,
            ptr(measured) if (accumulate or collect_hist) else None,
            ptr(visible_idx) if collect_hist else None,
            n_visible if collect_hist else 0,
            noise_code, ptr(noise_state), ptr(noise_out), C, ptr(perm),
            int(decimation), row0, col0, int(half_offset), int(n_half),
            ptr(part_s), ptr(part_c), ptr(out_s), ptr(out_c), ptr(part_h),
            ptr(out_h), tb, threads,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_cuda(lib, rc, "sweep_sparse launch")
    sweep_sparse.launches += 1

    outs = [m_out, noise_out]
    if accumulate:
        outs += [out_s, out_c]
    if collect_hist:
        outs.append(out_h)
    return tuple(outs)


sweep_sparse.launches = 0


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
