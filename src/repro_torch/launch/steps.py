"""The language model's train step: fwd + bwd + AdamW.

The port of `repro.launch.steps.make_train_step` on one device: the
loss's gradients come from ``torch.autograd.grad`` with respect to
detached views of the parameter leaves, and `optim.adamw.apply` writes
the new parameters and moments into the caller's tensors in place (the
reference donates the state).  Its mesh, sharding specs and the serve /
prefill steps belong to the multi-card slice (ROADMAP item 12d).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.core.hwaware import HwAwareConfig
from repro_torch.models.model import Model, build_model
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainStep:
    fn: Callable[[Any, adamw.OptState, dict], tuple]
    model: Model            # its init draws the parameters ``fn`` takes


def _split(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches along the batch axis (axis 1 of a (3, B, S)
    positions leaf)."""
    out = [{} for _ in range(n)]
    for k, v in batch.items():
        axis = 1 if k == "positions" and v.ndim == 3 else 0
        for i, part in enumerate(v.chunk(n, dim=axis)):
            out[i][k] = part
    return out


def make_train_step(
    cfg: ModelCfg,
    shape: ShapeCfg,
    opt_cfg: Optional[adamw.AdamWConfig] = None,
    hw_aware: Optional[HwAwareConfig] = None,
    microbatches: int = 1,
    device="cuda",
) -> TrainStep:
    """``.fn(params, opt_state, batch) -> (params, opt_state, metrics)``,
    ``metrics = {"loss", "grad_norm", "lr"}`` as tensors; params and
    opt_state are updated in place and returned.  microbatches > 1:
    gradient accumulation in float32 over batch slices, divided by the
    count."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    model = build_model(cfg, hw_aware=hw_aware, device=device)
    if shape.global_batch % microbatches:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{microbatches} microbatches")

    def grads_of(params, batch):
        live = [p.detach().requires_grad_()
                for p in adamw.tree_leaves(params)]
        loss = model.loss(adamw.tree_unflatten(params, live), batch)
        return loss.detach(), torch.autograd.grad(loss, live)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = None
            for micro in _split(batch, microbatches):
                l, g = grads_of(params, micro)
                loss = loss + l.float()
                grads = ([x.float() for x in g] if grads is None else
                         [a + b.float() for a, b in zip(grads, g)])
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        grads = adamw.tree_unflatten(params, grads)
        params, opt_state, metrics = adamw.apply(opt_cfg, grads, opt_state,
                                                 params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return TrainStep(train_step, model)
