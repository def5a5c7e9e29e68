"""Public wrappers around the kernels, in the chip + graph-colour view.

`make_kernel_half_sweep` adapts the dense half-sweep kernel (K2,
`kernels/pbit_update.py`) to the sampler's ``half_sweep(m, chip,
update_mask, beta, u)`` signature (the "pallas" backend); `ref_half_sweep`
and `sparse_half_sweep` adapt the plain dense and slot-layout half-sweeps
(the "ref" and "sparse" scan backends).  `fused_sweeps` /
`fused_visible_hist` adapt the sweep-resident engines
(`kernels/sweep_fused.py`) — dense (K3) or slot layout (K1) — to the chip +
colour view `core/pbit.py` works with, and `stream_sweeps` the slot-layout
engine with the double-buffered program stream (K4).  Counterpart of
``repro.kernels.ops``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hardware import EffectiveChip
from repro_torch.kernels.pbit_update import PreparedHalfSweep, pbit_half_sweep
from repro_torch.kernels.ref import (
    pbit_half_sweep_ref,
    pbit_sparse_half_sweep_ref,
)
from repro_torch.kernels.sweep_fused import (
    sweep_fused,
    sweep_sparse,
    sweep_sparse_stream,
)


def make_kernel_half_sweep():
    """The dense half-sweep kernel in the sampler's signature.

    A sweep function calls it with the same two colour masks and chip on
    every sweep, so each (mask, chip, chain count) is prepared once — its
    compacted update list, launch plan and checked operands
    (`PreparedHalfSweep`, one host sync) — and every later half-sweep only
    launches.  ``half_sweep.prepared`` maps each to its preparation."""
    prepared = {}

    def half_sweep(m, chip: EffectiveChip, update_mask, beta, u):
        _require_dense(chip)
        key = (id(update_mask), id(chip), m.shape[0])
        entry = prepared.get(key)
        if entry is None:
            # the entry holds the mask and the chip, so their ids stay theirs
            entry = prepared[key] = (PreparedHalfSweep(
                chip.W, chip.h, chip.tanh_gain, chip.tanh_offset,
                chip.rand_gain, chip.comp_offset, update_mask, m.shape[0]),
                update_mask, chip)
        return pbit_half_sweep(
            m, chip.W, chip.h, chip.tanh_gain, chip.tanh_offset,
            chip.rand_gain, chip.comp_offset, update_mask, beta, u,
            prepared=entry[0])

    half_sweep.prepared = prepared
    return half_sweep


def ref_half_sweep(m, chip: EffectiveChip, update_mask, beta, u):
    """Plain dense half-sweep."""
    _require_dense(chip)
    return pbit_half_sweep_ref(
        m, chip.W, chip.h, chip.tanh_gain, chip.tanh_offset,
        chip.rand_gain, chip.comp_offset, update_mask, beta, u)


def _require_dense(chip: EffectiveChip) -> None:
    if chip.W is None:
        raise ValueError(
            "this chip carries only the sparse slot layout (W=None); use a "
            "sparse backend ('sparse' or 'fused_sparse')")


def _require_sparse(chip: EffectiveChip) -> None:
    if chip.nbr_w is None or chip.nbr_idx is None:
        raise ValueError(
            "sparse backend needs a chip carrying the neighbor-table "
            "layout; program with neighbors=graph.neighbor_table()[0], use "
            "hardware.attach_sparse, or hardware.program_weights_sparse")


def sparse_half_sweep(m, chip: EffectiveChip, update_mask, beta, u):
    """Plain half-sweep on the fixed-degree slot layout (no dense W)."""
    _require_sparse(chip)
    return pbit_sparse_half_sweep_ref(
        m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
        chip.tanh_offset, chip.rand_gain, chip.comp_offset,
        update_mask, beta, u)


def _fused_common(chip, color, betas, B, noise_spec, clamp_mask, sparse):
    if noise_spec is None or noise_spec.kind not in ("counter", "lfsr"):
        kind = None if noise_spec is None else noise_spec.kind
        raise ValueError(
            f"fused backend needs in-kernel noise ('counter' or 'lfsr'), "
            f"got {kind!r}; build the noise fn with make_counter_noise or "
            f"make_lfsr_noise")
    if sparse:
        _require_sparse(chip)
    elif chip.W is None:
        raise ValueError(
            "dense fused backend needs a chip with a dense W; this chip is "
            "sparse-native (W=None) — use backend='fused_sparse' or "
            "'sparse'")
    betas = torch.as_tensor(betas, dtype=torch.float32, device=chip.h.device)
    if betas.ndim == 1:
        betas = betas[:, None].expand(betas.shape[0], B)
    # colour classes minus clamped nodes: on a 2-coloured graph each is an
    # independent set, which lets the slot-layout kernel update in place
    # (the dense kernel is synchronous and needs no such property)
    mask0 = (color == 0)
    mask1 = (color == 1)
    if clamp_mask is not None:
        mask0 = mask0 & ~clamp_mask
        mask1 = mask1 & ~clamp_mask
    return betas.contiguous(), mask0, mask1


def fused_sweeps(
    m: torch.Tensor,
    chip: EffectiveChip,
    color: torch.Tensor,
    betas: torch.Tensor,               # (S,) or (S, B)
    noise_state: torch.Tensor,
    noise_spec,                        # core/pbit.py NoiseSpec
    clamp_mask: torch.Tensor | None = None,
    clamp_values: torch.Tensor | None = None,
    measured: torch.Tensor | None = None,
    *,
    sparse: bool = False,
):
    """Run S resident sweeps through the fused engine.

    Returns (m', noise_state') or, when ``measured`` is given,
    (m', noise_state', s_sum[N], c_sum) — raw sums over (chains x measured
    sweeps); divide by B * sum(measured).  c_sum is the (N, N) Gram matrix
    on the dense path and the (D, N) per-slot edge correlations on the
    sparse path (read edge (i, j) at ``c_sum[slot_of(i→j), i]``, see
    `ChimeraGraph.edge_slots`).
    """
    betas, mask0, mask1 = _fused_common(
        chip, color, betas, m.shape[0], noise_spec, clamp_mask, sparse)
    kw = dict(clamp_mask=clamp_mask, clamp_values=clamp_values,
              measured=measured, noise_mode=noise_spec.kind,
              decimation=noise_spec.decimation,
              gather_perm=noise_spec.gather_perm,
              accumulate=measured is not None)
    if sparse:
        return sweep_sparse(
            m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
            chip.tanh_offset, chip.rand_gain, chip.comp_offset,
            mask0, mask1, betas, noise_state, **kw)
    return sweep_fused(
        m, chip.W, chip.h, chip.tanh_gain, chip.tanh_offset,
        chip.rand_gain, chip.comp_offset, mask0, mask1, betas, noise_state,
        **kw)


def fused_visible_hist(
    m: torch.Tensor,
    chip: EffectiveChip,
    color: torch.Tensor,
    betas: torch.Tensor,
    noise_state: torch.Tensor,
    noise_spec,
    visible_idx,
    measured: torch.Tensor,            # (S,) histogram weights (burn-in mask)
    clamp_mask: torch.Tensor | None = None,
    *,
    sparse: bool = False,
):
    """S resident sweeps + in-kernel visible-pattern histogram.

    Returns (m', noise_state', hist[2^nv]) — hist counts each measured
    sweep's visible bit pattern per chain; the (S, B, N) trajectory never
    exists anywhere.  ``clamp_mask`` (N,) freezes its nodes at their value
    in ``m`` (they leave both colour masks).
    """
    betas, mask0, mask1 = _fused_common(
        chip, color, betas, m.shape[0], noise_spec, clamp_mask, sparse)
    kw = dict(measured=measured, visible_idx=visible_idx,
              noise_mode=noise_spec.kind, decimation=noise_spec.decimation,
              gather_perm=noise_spec.gather_perm, collect_hist=True,
              n_visible=int(len(visible_idx)))
    if sparse:
        return sweep_sparse(
            m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
            chip.tanh_offset, chip.rand_gain, chip.comp_offset,
            mask0, mask1, betas, noise_state, **kw)
    return sweep_fused(
        m, chip.W, chip.h, chip.tanh_gain, chip.tanh_offset,
        chip.rand_gain, chip.comp_offset, mask0, mask1, betas, noise_state,
        **kw)


def stream_sweeps(
    m: torch.Tensor,
    chip: EffectiveChip,
    color: torch.Tensor,
    betas: torch.Tensor,               # (S,) or (S, B)
    noise_state: torch.Tensor,         # (2,) counter state
    noise_spec,                        # core/pbit.py NoiseSpec (counter)
    next_nbr_w: torch.Tensor,          # (D, N) the next program's slots
    next_h: torch.Tensor,              # (N,) the next program's biases
    clamp_mask: torch.Tensor | None = None,
    clamp_values: torch.Tensor | None = None,
    *,
    staged=None,
):
    """S resident sweeps of ``chip`` (slot layout, counter noise) while the
    next program's ``(nbr_w, h)`` is staged: (m', noise_state', staged_w,
    staged_h).  A program chain feeds the staged pair back as the next
    launch's chip ``nbr_w`` / ``h`` (the chip's other fields belong to the
    chip instance and stay), with ``staged`` the free slot of a two-slot
    ring; each launch equals `fused_sweeps` on its own program bit for
    bit."""
    betas, mask0, mask1 = _fused_common(
        chip, color, betas, m.shape[0], noise_spec, clamp_mask, True)
    return sweep_sparse_stream(
        m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
        chip.tanh_offset, chip.rand_gain, chip.comp_offset, mask0, mask1,
        betas, noise_state, next_nbr_w, next_h, clamp_mask, clamp_values,
        noise_mode=noise_spec.kind, staged=staged)
