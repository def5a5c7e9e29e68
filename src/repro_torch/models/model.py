"""Model facade: build_model(cfg) -> uniform init / loss / cache / decode.

The port of `repro.models.model` for all ten architectures: the
decoder-only families (`models.transformer`: dense, mixture-of-experts,
the Mamba hybrid, RWKV) and Whisper's encoder-decoder (`models.whisper`).
``input_specs`` and ``make_dummy_batch`` come with the dry run (item 12d).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.api.spec import require_device
from repro_torch.configs.base import ModelCfg
from repro_torch.core.hwaware import HwAwareConfig, apply_hardware
from repro_torch.models import transformer, whisper


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelCfg
    device: torch.device
    init: Callable[[int], Any]                 # seed -> params on device
    loss: Callable[[Any, dict], torch.Tensor]  # (params, batch) -> loss
    init_cache: Callable[[int, int], Any]      # (batch, max_seq) -> cache
    decode_step: Callable[[Any, torch.Tensor, int, Any], tuple]


def build_model(cfg: ModelCfg,
                hw_aware: Optional[HwAwareConfig] = None,
                chip_key: Optional[int] = None,
                device="cuda") -> Model:
    """hw_aware: the paper's generalized in-situ learning — the loss and
    decode see params through the 8-bit DAC + mismatch model
    (core/hwaware.py) of the chip seeded ``chip_key`` (default 0); the
    loss's gradient passes the quantizer straight through.  Parameters
    are drawn on ``device`` (the card unless the caller asks for the
    CPU)."""
    dev = require_device(device)

    def maybe_hw(params):
        if hw_aware is None:
            return params
        return apply_hardware(params, hw_aware,
                              0 if chip_key is None else chip_key)

    if cfg.enc_dec is not None:
        return Model(
            cfg=cfg,
            device=dev,
            init=lambda seed: whisper.init_encdec(
                torch.Generator(device=dev).manual_seed(seed), cfg),
            loss=lambda p, b: whisper.encdec_loss(maybe_hw(p), cfg, b),
            init_cache=lambda b, s: whisper.init_cache(cfg, b, s,
                                                       device=dev),
            decode_step=lambda p, t, pos, c: whisper.decode_step(
                maybe_hw(p), cfg, t, pos, c),
        )
    return Model(
        cfg=cfg,
        device=dev,
        init=lambda seed: transformer.init_lm(
            torch.Generator(device=dev).manual_seed(seed), cfg),
        loss=lambda p, b: transformer.lm_loss(maybe_hw(p), cfg, b),
        init_cache=lambda b, s: transformer.init_cache(cfg, b, s,
                                                       device=dev),
        decode_step=lambda p, t, pos, c: transformer.decode_step(
            maybe_hw(p), cfg, t, pos, c),
    )
