"""Dense chromatic-Gibbs half-sweep: CUDA kernel + plain version.

`pbit_half_sweep` computes one half-sweep of eqns 1 + 2 on the dense
(N, N) couplings: ``I = Σ_j W[i, j] m[:, j] + h`` for every node of the
update mask, tanh with a per-chain beta, ``+ rand_gain·u + comp_off``,
sign, masked write.  ``u`` is an input (the host step function draws it),
so the kernel runs with any noise kind.

It replaces the TPU kernel ``repro.kernels.pbit_update.pbit_half_sweep_pallas``;
the CUDA source is ``csrc/pbit_update.cu``.  The product is the sequential
ascending-j float32 row reduction (see `kernels/ref.py`), so kernel and
plain version agree bit for bit.  On an H100 one launch is microseconds of
work and the caller launches once per half-sweep from a Python loop: at the
chip's size launch latency bounds it, not bytes or operations.

`pbit_half_sweep_ref` (kernels/ref.py) is the plain PyTorch version.  The
wrapper uses it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import pbit_half_sweep_ref
from repro_torch.kernels.sweep_fused import _want, card_limits

__all__ = ["pbit_half_sweep", "pbit_half_sweep_ref"]

_VP, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH_ARGTYPES = (
    [_VP, _VP, _I, _I]      # m, out, B, N
    + [_VP] * 6             # W, h, gain, off, rg, co
    + [_VP, _VP, _VP, _VP]  # mask, beta, u, stream
)


def _library() -> ctypes.CDLL:
    lib = build.load("pbit_update")
    if lib.pbit_half_sweep_launch.argtypes is None:
        lib.pbit_half_sweep_launch.argtypes = _LAUNCH_ARGTYPES
        lib.pbit_half_sweep_launch.restype = _I
        lib.pbit_half_sweep_smem_bytes.argtypes = [_I]
        lib.pbit_half_sweep_smem_bytes.restype = _I
        lib.pbit_half_sweep_error_string.argtypes = [_I]
        lib.pbit_half_sweep_error_string.restype = ctypes.c_char_p
    return lib


def beta_column(beta, B: int, device) -> torch.Tensor:
    """A scalar or (B,) beta as the kernel's (B,) per-chain column (a scalar
    is broadcast here, on the host side of the launch)."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
    return beta.reshape(-1).expand(B).contiguous()


def pbit_half_sweep(m, W, h, gain, off, rand_gain, comp_off, update_mask,
                    beta, u):
    """One dense half-sweep; shapes and semantics of `pbit_half_sweep_ref`.

    m: (B, N) float32 ±1;  W: (N, N) float32;  h/gain/off/rand_gain/
    comp_off: (N,) float32;  update_mask: (N,) bool;  beta: scalar or (B,);
    u: (B, N) float32.  Returns the new (B, N) spins.  CPU tensors go to
    `pbit_half_sweep_ref`; a CUDA tensor launches the kernel or raises, and
    ``pbit_half_sweep.launches`` counts the launches.
    """
    if not m.is_cuda:
        return pbit_half_sweep_ref(m, W, h, gain, off, rand_gain, comp_off,
                                   update_mask, beta, u)
    B, N = m.shape
    f32 = torch.float32
    _want("m", m, f32, (B, N))
    _want("W", W, f32, (N, N))
    rows = [_want(n, t, f32, (N,)) for n, t in (
        ("h", h), ("gain", gain), ("off", off), ("rand_gain", rand_gain),
        ("comp_off", comp_off))]
    mask = update_mask.view(torch.uint8) if update_mask.dtype == torch.bool \
        else update_mask        # the same bytes: no conversion launch
    _want("update_mask", mask, torch.uint8, (N,))
    beta = beta_column(beta, B, m.device)
    _want("u", u, f32, (B, N))

    lib = _library()
    limit = card_limits(m.device).smem_per_block
    if lib.pbit_half_sweep_smem_bytes(N) > limit - 16 * 1024:
        raise ValueError(f"the update list of N={N} nodes does not fit the "
                         f"shared memory of one block on this card")
    out = torch.empty_like(m)
    with torch.cuda.device(m.device):
        rc = lib.pbit_half_sweep_launch(
            m.data_ptr(), out.data_ptr(), B, N, W.data_ptr(),
            *(r.data_ptr() for r in rows), mask.data_ptr(), beta.data_ptr(),
            u.data_ptr(), torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        msg = lib.pbit_half_sweep_error_string(rc).decode()
        raise RuntimeError(f"pbit_half_sweep launch: CUDA error {rc} ({msg})")
    pbit_half_sweep.launches += 1
    return out


pbit_half_sweep.launches = 0
