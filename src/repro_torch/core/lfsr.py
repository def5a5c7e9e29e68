"""LFSR and counter-hash random number generation, faithful to the chip.

The chip drives each Chimera unit cell with a 32-bit LFSR.  Each register
exposes 4 unique bytes per cycle; the four *vertical* nodes of a cell read
the bytes in normal bit order while the four *horizontal* nodes read the
bit-reversed bytes (the paper's area-saving trick).  The Galois LFSR uses
the maximal-length polynomial x^32 + x^22 + x^2 + x + 1 (mask 0x80200003).

Counterpart of ``repro.core.lfsr``; every integer stream here is bit-exact
against it.

**Which torch dtype holds the 32-bit state.**  Eager PyTorch has almost no
``uint32`` arithmetic, so:

* *public* noise state (what `Session.noise_state` returns, what
  `sweep_sparse` takes and returns) is ``torch.int32`` carrying the uint32
  **bit pattern** (two's complement).  It round-trips with a numpy
  ``uint32`` array bit for bit through ``ndarray.view(np.int32)`` — see
  `state_from_numpy` / `state_to_numpy` — and the CUDA kernel reads the
  same bytes as native ``uint32``.
* *inside* the plain functions below values are ``torch.int64`` in
  ``[0, 2**32)`` (`to_u64` / `from_u64` convert), masked with
  ``0xFFFFFFFF`` after every multiply, xor and shift, which reproduces the
  reference's wrapping uint32 arithmetic exactly.
"""
from __future__ import annotations

import numpy as np
import torch

GALOIS_MASK_32 = 0x80200003  # x^32 + x^22 + x^2 + x + 1
_M32 = 0xFFFFFFFF
_BYTE_REV = np.array(
    [int(f"{b:08b}"[::-1], 2) for b in range(256)], dtype=np.int64)


# ---------------------------------------------------------------------------
# uint32 <-> torch
# ---------------------------------------------------------------------------
def to_u64(state: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any integer tensor) -> int64 in [0, 2**32)."""
    return state.to(torch.int64) & _M32


def from_u64(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 carrying the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def state_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """numpy uint32 array -> public int32 bit-pattern tensor on ``device``
    (the card unless the caller asks for another)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def state_to_numpy(state: torch.Tensor) -> np.ndarray:
    """Public int32 bit-pattern tensor -> numpy uint32 array."""
    return state.detach().cpu().contiguous().numpy().view(np.uint32).copy()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without ever leaving
    the int64 range: the 16-bit halves' products stay below 2**48."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


# ---------------------------------------------------------------------------
# Galois LFSR
# ---------------------------------------------------------------------------
def seed_states(gen: torch.Generator, shape: tuple[int, ...],
                device=None) -> torch.Tensor:
    """Nonzero LFSR states of the given shape (public int32 bit pattern),
    on ``gen``'s device unless ``device`` names it (a `torch.Generator` is
    bound to one device, which must be ``device``)."""
    if device is None:
        device = gen.device
    bits = torch.randint(0, 2 ** 32, shape, generator=gen, device=device,
                         dtype=torch.int64)
    bits = torch.where(bits == 0, torch.full_like(bits, 0xDEADBEEF), bits)
    return from_u64(bits)


def lfsr_step(state: torch.Tensor) -> torch.Tensor:
    """One Galois LFSR clock.  state: int64 in [0, 2**32)."""
    lsb = state & 1
    shifted = state >> 1
    return torch.where(lsb == 1, shifted ^ GALOIS_MASK_32, shifted)


def lfsr_step_n(state: torch.Tensor, n: int) -> torch.Tensor:
    """Advance every state by ``n`` clocks.  int64 in, int64 out."""
    for _ in range(n):
        state = lfsr_step(state)
    return state


def cell_bytes(state: torch.Tensor) -> torch.Tensor:
    """The 4 bytes of each 32-bit state, low byte first.
    int64[...] in [0, 2**32) -> int64[..., 4]."""
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64,
                          device=state.device)
    return (state[..., None] >> shifts) & 0xFF


def reverse_bytes_bits(b: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each byte (integer values in [0, 256)) through the
    256-entry table; int64 out."""
    table = torch.from_numpy(_BYTE_REV).to(b.device)
    return table[b.to(torch.int64)]


def byte_to_uniform(b: torch.Tensor) -> torch.Tensor:
    """Map a byte to a mid-tread uniform in (-1, 1), as the 8-bit RNG DAC
    does: ``(b - 127.5) / 128`` in float32 (both steps are exact)."""
    return (b.to(torch.float32) - 127.5) / 128.0


def reverse_byte_bits_swar(b: torch.Tensor) -> torch.Tensor:
    """Bit-reverse each byte with shift/mask ops only."""
    b = ((b & 0xF0) >> 4) | ((b & 0x0F) << 4)
    b = ((b & 0xCC) >> 2) | ((b & 0x33) << 2)
    b = ((b & 0xAA) >> 1) | ((b & 0x55) << 1)
    return b


def cell_uniforms(state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell uniforms for (vertical[..., 4], horizontal[..., 4]) nodes.
    state: int64[...] in [0, 2**32)."""
    by = cell_bytes(state)
    return byte_to_uniform(by), byte_to_uniform(reverse_bytes_bits(by))


def next_uniforms(state: torch.Tensor, decimation: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance states ``decimation`` clocks and emit fresh cell uniforms.

    state: int64[...] in [0, 2**32).  Returns (new_state int64,
    vert_u[..., 4], horiz_u[..., 4]); decimation=8 refreshes one
    byte-worth of entropy per sample, as the chip's decimated clock does.
    """
    state = lfsr_step_n(state, decimation)
    v, h = cell_uniforms(state)
    return state, v, h


def flat_cell_uniforms(state: torch.Tensor) -> torch.Tensor:
    """Uniforms in the flat byte-major layout [v0..v3, h0..h3] x cells.

    state: int64[..., C] in [0, 2**32).  Returns float32[..., 8*C] where
    column ``k*C + cell`` is vertical byte k of ``cell`` and
    ``(4+k)*C + cell`` is the bit-reversed (horizontal) byte k.
    """
    parts = []
    for k in range(4):
        parts.append(byte_to_uniform((state >> (8 * k)) & 0xFF))
    for k in range(4):
        parts.append(byte_to_uniform(
            reverse_byte_bits_swar((state >> (8 * k)) & 0xFF)))
    return torch.cat(parts, dim=-1)


def node_gather_perm(vert_scatter, horiz_scatter, n_nodes: int) -> np.ndarray:
    """Inverse permutation: node id -> column of `flat_cell_uniforms`."""
    vert = np.asarray(vert_scatter)
    horiz = np.asarray(horiz_scatter)
    n_cells, k = vert.shape
    perm = np.zeros(n_nodes, dtype=np.int32)
    cells = np.arange(n_cells, dtype=np.int32)
    for kk in range(k):
        perm[vert[:, kk]] = kk * n_cells + cells
        perm[horiz[:, kk]] = (k + kk) * n_cells + cells
    return perm


def force_stuck_bits(state: torch.Tensor, stuck) -> torch.Tensor:
    """Force the register bits a degraded LFSR has stuck at 0 and at 1.

    state: int64 in [0, 2**32); stuck: None (returns ``state``) or a pair
    (stuck0, stuck1) of int64 bit masks that broadcast against it
    (`api.faults.lfsr_stuck_masks`).
    """
    if stuck is None:
        return state
    s0, s1 = stuck
    return (state & ~s0) | s1


def lfsr_uniform_for_graph(state: torch.Tensor, gather_perm: torch.Tensor,
                           decimation: int = 8, stuck=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance the per-cell registers and emit per-node uniforms.

    state: public int32[..., n_cells]; gather_perm: int64[n_nodes] from
    `node_gather_perm`; ``stuck`` (see `force_stuck_bits`) is forced after
    the decimated clock, before the read.  Returns (new_state int32,
    u float32[..., n_nodes]).
    """
    st = force_stuck_bits(lfsr_step_n(to_u64(state), decimation), stuck)
    u = flat_cell_uniforms(st).index_select(-1, gather_perm)
    return from_u64(st), u


# ---------------------------------------------------------------------------
# Counter-based (stateless) RNG
# ---------------------------------------------------------------------------
def mix32(x: torch.Tensor) -> torch.Tensor:
    """Avalanche finalizer (lowbias32 constants) on int64 in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def counter_bits(seed, ctr, row: torch.Tensor, col: torch.Tensor
                 ) -> torch.Tensor:
    """Stateless hash of (seed, step counter, chain row, node col).

    seed/ctr: Python ints or integer tensors (any 32-bit pattern);
    row/col: integer tensors.  Returns int64 in [0, 2**32) — the same
    value the reference's uint32 expression gives, bit for bit.
    """
    seed = to_u64(torch.as_tensor(seed, device=row.device))
    ctr = to_u64(torch.as_tensor(ctr, device=row.device))
    x = mix32(seed ^ _mul32(ctr, 0x9E3779B9))
    return mix32(x
                 ^ _mul32(to_u64(row), 0x85EBCA77)
                 ^ _mul32(to_u64(col), 0xC2B2AE3D))


def counter_uniform(seed, ctr, row: torch.Tensor, col: torch.Tensor
                    ) -> torch.Tensor:
    """Counter-mode uniform in (-1, 1), quantized like the 8-bit RNG DAC."""
    return byte_to_uniform(counter_bits(seed, ctr, row, col) & 0xFF)
