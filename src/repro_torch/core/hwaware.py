"""Generalized hardware-aware learning for arbitrary PyTorch models.

The paper's insight — put the hardware's quantization + analog mismatch
*in the training forward path* so learning absorbs it — generalizes beyond
Ising lattices.  This module provides a straight-through-estimator (STE)
transform that fake-quantizes selected weight matrices to signed 8-bit
"DAC codes" with per-output-channel gain mismatch (the same R-2R +
multiplier model as `core/hardware.py`, at tensor granularity).  The port
of `repro.core.hwaware`: the same leaves are quantized (by the same path
strings and skip rules), and with ``sigma_gain=0`` the result equals the
reference's bit for bit.

The channel gains of one chip instance come from a generator seeded with
the counter hash (`core.lfsr.counter_bits`) of the chip seed and the CRC-32
of the parameter's path, so every process draws the same chip; the
reference folds the per-process salted ``hash()`` of the path into its key
and draws another chip in each interpreter (ROADMAP Queue 3 item 18).
The gains are equal in distribution to the reference's.

On a rank mesh a parameter is a DTensor (`core.ranks`): its
quantizer's scale is the maximum over the whole tensor (the blocks'
maxima reduced across their ranks), and the gains are sliced to the
block's output channels.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Optional

import torch

from repro_torch.core import lfsr as lfsr_mod
from repro_torch.core import ranks


@dataclasses.dataclass(frozen=True)
class HwAwareConfig:
    bits: int = 8
    sigma_gain: float = 0.03      # per-output-channel analog gain mismatch
    sigma_bit: float = 0.0        # optional per-bit DNL (0 = plain quant)
    min_ndim: int = 2             # only quantize matrices/tensors, not norms
    min_size: int = 4096          # skip tiny params (biases, scales)

    @staticmethod
    def from_chip(hw, bits: int = 8) -> "HwAwareConfig":
        """Derive QAT sigmas from a chip `HardwareConfig` so the STE
        forward models the same silicon an `api.SamplerSpec` samples:
        the Gilbert-multiplier gain spread becomes the per-channel gain
        mismatch and the R-2R branch spread the per-bit DNL."""
        return HwAwareConfig(bits=bits, sigma_gain=hw.sigma_edge_gain,
                             sigma_bit=hw.sigma_dac_bit)


def _fake_quant(w: torch.Tensor, bits: int,
                peak: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric per-tensor fake quantization with STE (round half to
    even, as ``jnp.round``).  ``peak``: the tensor's largest magnitude
    where ``w`` is only a block of it (else ``w``'s own)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if peak is None:
        peak = w.abs().max()
    scale = torch.clamp(peak, min=1e-8) / qmax
    q = torch.round(w / scale) * scale
    return w + (q - w).detach()  # STE


def path_seed(path: str, chip_seed: int) -> int:
    """The 32-bit seed of one parameter's gains on chip ``chip_seed``: a
    stable digest of the path string, the same in every process."""
    zero = torch.zeros((), dtype=torch.int64)
    return int(lfsr_mod.counter_bits(int(chip_seed) & 0xFFFFFFFF,
                                     zlib.crc32(path.encode()), zero, zero))


def _channel_gain(path: str, shape: tuple[int, ...], sigma: float,
                  chip_seed: int, device) -> torch.Tensor:
    """Frozen per-channel gain for one chip instance (from seed + path)."""
    gen = torch.Generator(device=device).manual_seed(
        path_seed(path, chip_seed))
    return 1.0 + sigma * torch.randn((shape[-1],), generator=gen,
                                     dtype=torch.float32, device=device)


def _should_quantize(path: str, w: Any, cfg: HwAwareConfig) -> bool:
    if not isinstance(w, torch.Tensor):
        return False
    if w.ndim < cfg.min_ndim or w.numel() < cfg.min_size:
        return False
    if "embed" in path:  # embeddings stay high precision (chip analogy: SPI)
        return False
    return w.is_floating_point()


def _map_keyed(fn, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts / lists / tuples, the path
    in the reference's ``jax.tree_util.keystr`` form:
    ``['blocks']['layer_0']['attn']['wq']``, ``['prefix'][0]``."""
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_keyed(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def apply_hardware(params: Any, cfg: HwAwareConfig, chip_seed: int = 0
                   ) -> Any:
    """Map params -> "as seen by the hardware" params (differentiable, STE).

    ``chip_seed`` fixes the mismatch instance: the same seed across all
    training steps models one physical chip, exactly like the paper's
    in-situ setup.
    """
    def leaf(pstr, w):
        if not _should_quantize(pstr, w, cfg):
            return w
        if ranks.is_dtensor(w):
            return _hardware_block(pstr, w, cfg, chip_seed)
        wq = _fake_quant(w.float(), cfg.bits)
        gain = _channel_gain(pstr, tuple(w.shape), cfg.sigma_gain,
                             chip_seed, w.device)
        return (wq * gain).to(w.dtype)

    return _map_keyed(leaf, params)


def _hardware_block(path: str, w, cfg: HwAwareConfig, chip_seed: int):
    """`apply_hardware`'s leaf for a DTensor: the rank's block quantized
    with the whole tensor's scale, times its channels' gains; a DTensor
    with the weight's placements (differentiable, the quantizer straight
    through)."""
    from torch.distributed.tensor import DTensor

    comm = ranks.rank_comm_of(w)
    dims = ranks.dims_axes(w)
    t = w.to_local().float()
    peak = comm.all_reduce(t.detach().abs().max(),
                           tuple(a for ax in dims.values() for a in ax),
                           op="max")
    wq = _fake_quant(t, cfg.bits, peak)
    gain = _channel_gain(path, tuple(w.shape), cfg.sigma_gain, chip_seed,
                         t.device)
    gain = comm.block(gain, 0, dims.get(w.ndim - 1, ()))
    return DTensor.from_local((wq * gain).to(w.dtype), w.device_mesh,
                              w.placements, run_check=False, shape=w.shape,
                              stride=w.stride())
