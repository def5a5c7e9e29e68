"""Model facade: build_model(cfg) -> uniform init / loss / cache / decode.

The port of `repro.models.model` for all ten architectures: the
decoder-only families (`models.transformer`: dense, mixture-of-experts,
the Mamba hybrid, RWKV) and Whisper's encoder-decoder (`models.whisper`).
`train_input_specs` / `decode_input_specs` give ``(shape, dtype)``
records of every model input of an (arch x shape) cell — the contract the
dry run (`launch.dryrun`) traces against, with no allocation — and
`make_dummy_batch` a concrete random batch of that form.  Modality stubs
live here: [audio] gets (B, enc_seq, D) frame embeddings, [vlm] gets
patch embeddings + 3D M-RoPE position ids.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.api.spec import require_device
from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.core.hwaware import HwAwareConfig, apply_hardware
from repro_torch.models import transformer, whisper
from repro_torch.models.layers import dtype_of
from repro_torch.optim.adamw import tree_map

VLM_PATCHES = 1024  # vision stub: patches occupying the first positions


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


# ---------------------------------------------------------------------------
# Input specs ((shape, dtype) stand-ins, no allocation)
# ---------------------------------------------------------------------------
class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype, without its data (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def train_input_specs(cfg: ModelCfg, shape: ShapeCfg) -> dict:
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": ShapeDtype((B, S), torch.int32),
        "labels": ShapeDtype((B, S), torch.int32),
    }
    if cfg.frontend == "vision_stub":
        specs["frontend_embeds"] = ShapeDtype(
            (B, min(VLM_PATCHES, S), cfg.d_model), dtype_of(cfg))
        specs["positions"] = ShapeDtype((3, B, S), torch.int32)
    elif cfg.frontend == "audio_stub":
        specs["frontend_embeds"] = ShapeDtype(
            (B, cfg.enc_dec.enc_seq, cfg.d_model), dtype_of(cfg))
    return specs


def decode_input_specs(cfg: ModelCfg, shape: ShapeCfg) -> dict:
    """serve_step inputs: one new token + a seq_len KV/state cache; the
    cache's shapes come from `init_cache` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, S = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        cache = build_model(cfg, device="cpu").init_cache(B, S)
    return {
        "tokens": ShapeDtype((B, 1), torch.int32),
        "pos": ShapeDtype((), torch.int32),
        "cache": tree_map(lambda x: ShapeDtype(tuple(x.shape), x.dtype),
                          cache),
    }


def make_dummy_batch(cfg: ModelCfg, shape: ShapeCfg,
                     gen: torch.Generator) -> dict:
    """Concrete random batch matching `train_input_specs`, drawn from
    ``gen`` on its device (equal to the reference's in shape, dtype and
    range only)."""
    specs = train_input_specs(cfg, shape)
    dev = gen.device
    batch = {
        k: torch.randint(0, cfg.vocab_size, specs[k].shape, generator=gen,
                         dtype=torch.int32, device=dev)
        for k in ("tokens", "labels")}
    if "frontend_embeds" in specs:
        fe = specs["frontend_embeds"]
        batch["frontend_embeds"] = (0.02 * torch.randn(
            fe.shape, generator=gen, dtype=torch.float32, device=dev)
        ).to(fe.dtype)
    if "positions" in specs:
        B, S = batch["tokens"].shape
        batch["positions"] = torch.arange(
            S, dtype=torch.int32, device=dev)[None, None].expand(
                3, B, S).contiguous()
    return batch
