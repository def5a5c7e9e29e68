"""Public wrappers around the kernels, in the chip + graph-colour view.

`sparse_half_sweep` adapts the plain slot-layout half-sweep to the
sampler's ``half_sweep(m, chip, update_mask, beta, u)`` signature (the
"sparse" scan backend).  `fused_sweeps` / `fused_visible_hist` adapt the
sweep-resident engine (`kernels/sweep_fused.py`) to the chip + colour view
`core/pbit.py` works with.  Counterpart of ``repro.kernels.ops``, sparse
layout only.
"""
from __future__ import annotations

import torch

from repro_torch.core.hardware import EffectiveChip
from repro_torch.kernels.ref import pbit_sparse_half_sweep_ref
from repro_torch.kernels.sweep_fused import sweep_sparse

_DENSE_MSG = ("the dense sweep-resident engine (sparse=False) is not ported "
              "yet; it comes with the dense-backends slice — use the slot "
              "layout (sparse=True)")


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
    if not sparse:
        raise NotImplementedError(_DENSE_MSG)
    if noise_spec is None or noise_spec.kind not in ("counter", "lfsr"):
        kind = None if noise_spec is None else noise_spec.kind
        raise ValueError(
            f"fused backend needs in-kernel noise ('counter' or 'lfsr'), "
            f"got {kind!r}; build the noise fn with make_counter_noise or "
            f"make_lfsr_noise")
    _require_sparse(chip)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=chip.h.device)
    if betas.ndim == 1:
        betas = betas[:, None].expand(betas.shape[0], B)
    # colour classes of a 2-coloured graph, minus clamped nodes: each an
    # independent set, which is what lets the kernel update in place
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
    sparse: bool = True,
):
    """Run S resident sweeps through the fused engine.

    Returns (m', noise_state') or, when ``measured`` is given,
    (m', noise_state', s_sum[N], c_slots[D, N]) — raw sums over
    (chains x measured sweeps); divide by B * sum(measured).
    """
    betas, mask0, mask1 = _fused_common(
        chip, color, betas, m.shape[0], noise_spec, clamp_mask, sparse)
    return sweep_sparse(
        m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
        chip.tanh_offset, chip.rand_gain, chip.comp_offset,
        mask0, mask1, betas, noise_state,
        clamp_mask=clamp_mask, clamp_values=clamp_values, measured=measured,
        noise_mode=noise_spec.kind, decimation=noise_spec.decimation,
        gather_perm=noise_spec.gather_perm,
        accumulate=measured is not None)


def fused_visible_hist(
    m: torch.Tensor,
    chip: EffectiveChip,
    color: torch.Tensor,
    betas: torch.Tensor,
    noise_state: torch.Tensor,
    noise_spec,
    visible_idx,
    measured: torch.Tensor,            # (S,) histogram weights (burn-in mask)
    *,
    sparse: bool = True,
):
    """S resident sweeps + in-kernel visible-pattern histogram.

    Returns (m', noise_state', hist[2^nv]) — hist counts each measured
    sweep's visible bit pattern per chain; the (S, B, N) trajectory never
    exists anywhere.
    """
    betas, mask0, mask1 = _fused_common(
        chip, color, betas, m.shape[0], noise_spec, None, sparse)
    return sweep_sparse(
        m, chip.nbr_idx, chip.nbr_w, chip.h, chip.tanh_gain,
        chip.tanh_offset, chip.rand_gain, chip.comp_offset,
        mask0, mask1, betas, noise_state,
        measured=measured, visible_idx=visible_idx,
        noise_mode=noise_spec.kind, decimation=noise_spec.decimation,
        gather_perm=noise_spec.gather_perm,
        collect_hist=True, n_visible=int(len(visible_idx)))
