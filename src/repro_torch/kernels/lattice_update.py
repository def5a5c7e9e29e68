"""Chain-batched Chimera-lattice vertical half-step (SoA): CUDA kernel +
plain version.

`lattice_vertical_update` updates the vertical nodes of the cells of one
parity colour on structure-of-arrays ``(B, R, C, k)`` float32 planes: the
in-cell K_{k,k} couplings to the cell's horizontal spins, the vertical
inter-cell couplers to the cells above and below (their spins given as
planes), the bias, a tanh neuron with the gain (beta folded in by the
caller) and the comparator against the given uniform noise ``u``.

It replaces the TPU kernel
``repro.kernels.lattice_update.lattice_vertical_update_pallas``; the CUDA
source is ``csrc/lattice_update.cu``.  It is bound by device memory (six
planes streamed once; about 101 MB, 30 µs, per call at B=256, R=C=64,
k=4).  The reference has no caller of its kernel either: the function is
its own entry point.

`lattice_vertical_update_ref` (kernels/ref.py) is the plain PyTorch
version.  The wrapper uses it only for tensors that lie on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lattice_vertical_update_ref
from repro_torch.kernels.sweep_fused import _want

__all__ = ["lattice_vertical_update", "lattice_vertical_update_ref"]

_VP, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH_ARGTYPES = (
    [_VP] * 12                  # m_v, m_h, up, dn, W_vh, wv_up, wv_dnin,
                                # h, gain, u, parity, out
    + [_I] * 5                  # B, R, C, k, color
    + [_VP]                     # stream
)


def _library() -> ctypes.CDLL:
    lib = build.load("lattice_update")
    if lib.lattice_vertical_update_launch.argtypes is None:
        lib.lattice_vertical_update_launch.argtypes = _LAUNCH_ARGTYPES
        lib.lattice_vertical_update_launch.restype = _I
        lib.lattice_update_error_string.argtypes = [_I]
        lib.lattice_update_error_string.restype = ctypes.c_char_p
    return lib


def lattice_vertical_update(m_v, m_h, m_v_up, m_v_dn, W_vh, wv_up, wv_dnin,
                            h, gain, u, parity, color: int):
    """One vertical-node half-step; shapes and semantics of
    `lattice_vertical_update_ref`.

    m_v/m_h/m_v_up/m_v_dn/u: (B, R, C, k) float32;  W_vh: (R, C, k, k);
    wv_up/wv_dnin/h/gain: (R, C, k) float32;  parity: (R, C) int32;
    color: 0 or 1.  Returns the new (B, R, C, k) vertical spins (a new
    tensor).  CPU tensors go to `lattice_vertical_update_ref`; a CUDA
    tensor launches the kernel or raises, and
    ``lattice_vertical_update.launches`` counts the launches.
    """
    if not m_v.is_cuda:
        return lattice_vertical_update_ref(m_v, m_h, m_v_up, m_v_dn, W_vh,
                                           wv_up, wv_dnin, h, gain, u,
                                           parity, color)
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color!r}")
    if m_v.ndim != 4 or m_v.numel() == 0:
        raise ValueError(f"m_v must be a non-empty (B, R, C, k) plane, got "
                         f"shape {tuple(m_v.shape)}")
    B, R, C, k = m_v.shape
    f32 = torch.float32
    planes = [_want(n, t, f32, (B, R, C, k)) for n, t in (
        ("m_v", m_v), ("m_h", m_h), ("m_v_up", m_v_up), ("m_v_dn", m_v_dn))]
    _want("W_vh", W_vh, f32, (R, C, k, k))
    rows = [_want(n, t, f32, (R, C, k)) for n, t in (
        ("wv_up", wv_up), ("wv_dnin", wv_dnin), ("h", h), ("gain", gain))]
    _want("u", u, f32, (B, R, C, k))
    _want("parity", parity, torch.int32, (R, C))
    lib = _library()
    out = torch.empty_like(m_v)
    with torch.cuda.device(m_v.device):
        rc = lib.lattice_vertical_update_launch(
            *(t.data_ptr() for t in planes), W_vh.data_ptr(),
            *(t.data_ptr() for t in rows), u.data_ptr(), parity.data_ptr(),
            out.data_ptr(), B, R, C, k, int(color),
            torch.cuda.current_stream(m_v.device).cuda_stream)
    if rc != 0:
        msg = lib.lattice_update_error_string(rc).decode()
        raise RuntimeError(
            f"lattice_vertical_update launch: CUDA error {rc} ({msg})")
    lattice_vertical_update.launches += 1
    return out


lattice_vertical_update.launches = 0
