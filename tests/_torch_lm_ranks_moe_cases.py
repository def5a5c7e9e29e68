"""The mixture-of-experts and hybrid (Mamba) language models' steps on rank
meshes: the cases that `test_torch_lm_ranks_moe.py` runs in gloo ranks
and, with ``mesh=None``, in one process.  The train, gradient, generation
and checkpoint cases are `_torch_lm_ranks_cases`' (the same batch,
prompts and optimizer); this module adds the three reduced models, the
chunk sizes each runs at, the gradients of the train step's first step,
the aux loss and a Mamba block over sequence chunks.  The parameters are
the port's own draw from seed 0 (the same in every process).

No jax here: the ranks import this module.
"""
import contextlib

import numpy as np
import torch

import _torch_lm_ranks_cases as base
from repro_torch.configs.base import ShapeCfg, reduced
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.launch import steps
from repro_torch.models import mamba, moe, transformer
from repro_torch.models import sharding as shd
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

# granite-moe with an odd vocabulary like its 49155 (the model axis leaves
# it whole), jamba's one period, kimi-k2's dense prefix and one MoE layer
# with a shared expert
ARCHS = ("granite-moe-1b-a400m", "jamba-v0.1-52b", "kimi-k2-1t-a32b")
GRANITE_VOCAB = 511
# chunk sizes that split the train batch's 64 positions: two MoE token
# chunks (capacity per chunk, the statistics averaged over them), four
# Mamba scan chunks; the prefill's 16 positions take one shot
CHUNKS = {"moe.TOK_CHUNK": 32, "mamba.CHUNK": 16}


def cfg(arch):
    if arch == "granite-moe-1b-a400m":
        return reduced(get_config(arch), vocab_size=GRANITE_VOCAB)
    return get_reduced_config(arch)


@contextlib.contextmanager
def chunks():
    """`CHUNKS` in the port's modules, restored after."""
    mods = {"moe": moe, "mamba": mamba}
    saved = {k: getattr(mods[k.split(".")[0]], k.split(".")[1])
             for k in CHUNKS}
    for k, v in CHUNKS.items():
        setattr(mods[k.split(".")[0]], k.split(".")[1], v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mods[k.split(".")[0]], k.split(".")[1], v)


def params_of(c):
    """The port's parameters drawn from seed 0 on the CPU."""
    return build_model(c, device="cpu").init(0)


@contextlib.contextmanager
def first_grads(save, mesh, tag):
    """Save the gradients the train step hands `adamw.apply` on its first
    call (whole, gathered on a rank mesh) under ``<tag>/grads``: the
    step's own loss and gradients, with no second backward."""
    real, seen = adamw.apply, []

    def apply(cfg, grads, state, params):
        if not seen:
            seen.append(True)
            whole = shd.full_tree(grads) if shd.is_rank_mesh(mesh) else grads
            base._save_tree(save, f"{tag}/grads", whole)
        return real(cfg, grads, state, params)

    adamw.apply = apply
    try:
        yield
    finally:
        adamw.apply = real


def aux_loss(save, mesh, c, params, *, tag):
    """The aux term `transformer.forward_hidden` sums over the layers, on
    the train step's blocks of the parameters and the batch."""
    st = steps.make_train_step(c, ShapeCfg("t", base.S, base.B, "train"),
                               mesh, base.OPT, device="cpu")
    batch = base.batch_of(c)
    baxes = ()
    if shd.is_rank_mesh(mesh):
        params = shd.shard_tree(params, st.in_specs[0], mesh, "cpu")
        batch = shd.shard_tree(batch, st.in_specs[2], mesh, "cpu")
        baxes = steps._batch_axes(st.in_specs[2])
    with torch.no_grad(), shd.use_mesh(mesh, "cpu", baxes):
        b = shd.local_tree(batch)
        _, aux = transformer.forward_hidden(params, c, b["tokens"])
    save(f"{tag}/aux", aux)


def mamba_seq_chunks(save, mesh, *, tag):
    """One Mamba block of reduced jamba over two sequence chunks (the
    conv and SSM states carried, each chunk recomputed in backward): its
    output, and the gradients of the output's sum of squares with respect
    to the input and the block's parameters, whole.  On a rank mesh whose
    "data" axis is 1 (the batch whole on every rank)."""
    c = cfg("jamba-v0.1-52b")
    params = params_of(c)
    st = steps.make_train_step(c, ShapeCfg("t", base.S, base.B, "train"),
                               mesh, base.OPT, device="cpu")
    x = torch.randn((base.B, base.S, c.d_model),
                    generator=torch.Generator().manual_seed(7))
    if shd.is_rank_mesh(mesh):
        assert mesh.shape["data"] == 1, mesh.shape
        params = shd.shard_tree(params, st.in_specs[0], mesh, "cpu")
    p = transformer.group_slice(params["blocks"]["layer_0"], 0)["mamba"]
    live = {k: v.detach().requires_grad_() for k, v in p.items()}
    x = x.requires_grad_()
    saved = mamba.SEQ_CHUNK
    mamba.SEQ_CHUNK = base.S // 2
    try:
        with shd.use_mesh(mesh, "cpu"):
            y, _ = mamba.mamba_forward(live, c.hybrid, x)
            loss = (y * y).sum()
            grads = torch.autograd.grad(loss, [x] + list(live.values()))
            out = dict(zip(["x"] + list(live), grads))
            out["y"] = y
            if shd.is_rank_mesh(mesh):
                out = shd.full_tree(out)
    finally:
        mamba.SEQ_CHUNK = saved
    base._save_tree(save, tag, out)


def run(save, mesh, arch, name, *, aux=False, ckpt=None):
    """Every case of ``arch`` on ``mesh`` under `chunks`, tagged
    ``<arch>/<name>/...``; ``ckpt`` = (one-process checkpoint, where this
    mesh's goes) for `_torch_lm_ranks_cases.checkpoints`."""
    c = cfg(arch)
    tag = f"{arch}/{name}"
    with chunks():
        with first_grads(save, mesh, f"{tag}/train"):
            base.train(save, mesh, c, params_of(c), tag=f"{tag}/train")
        base.generate(save, mesh, c, params_of(c), tag=f"{tag}/gen")
        if aux:
            aux_loss(save, mesh, c, params_of(c), tag=tag)
        if ckpt is not None:
            base.checkpoints(save, mesh, c, params_of(c), *ckpt,
                             prefix=f"{arch}/")
