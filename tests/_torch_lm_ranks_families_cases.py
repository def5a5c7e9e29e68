"""The RWKV, Whisper and vision-language models' steps on rank meshes: the
cases that `test_torch_lm_ranks_families.py` runs in gloo ranks and, with
``mesh=None``, in one process.  The train and gradient cases are
`_torch_lm_ranks_cases`' (the same optimizer, the batch of `batch_of`);
this module adds the three reduced models, their batches (Whisper's
frames, qwen2-vl's patch prefix shorter than the sequence with three
distinct M-RoPE position rows), their generation (Whisper: the prompt
teacher-forced into the self cache after the cross cache is filled) and
the prefill caches.  The parameters are the port's own draw from seed 0
(the same in every process).

No jax here: the ranks import this module.
"""
import contextlib

import numpy as np
import torch

import _torch_lm_ranks_cases as base
from _torch_lm_ranks_moe_cases import params_of
from repro_torch.configs.base import ShapeCfg, reduced
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.launch import serve, steps
from repro_torch.models import rwkv, transformer
from repro_torch.models import sharding as shd
from repro_torch.models import whisper
from repro_torch.models.model import build_model, make_dummy_batch
from repro_torch.optim import adamw

RWKV, WHISPER, VLM = "rwkv6-3b", "whisper-tiny", "qwen2-vl-72b"
ARCHS = (RWKV, WHISPER, VLM)
# whisper-tiny's indivisibilities at the reduced width: an odd vocabulary
# (its 51,865; whole on every model axis) and 6 heads, which a 2-way
# model axis splits and a 4-way one leaves whole
WHISPER_VOCAB, WHISPER_HEADS = 511, 6
# qwen2-vl's patch prefix: shorter than the train batch's 64 positions
# (text positions follow it), a grid 6 patches wide; the prompts' prefix
VLM_PATCHES, VLM_GRID_W, VLM_PROMPT_PATCHES = 24, 6, 8
# the WKV's chunk: four chunks of the train batch's 64 positions (the
# state carried across them on each rank's heads), the prompts' 16 in one
WKV_CHUNK = 16


# Whisper with 4 query heads on 2 KV heads: on 1 x 4 its self- and
# cross-attention split the query heads and keep the KV heads whole (the
# encoder's K/V cached whole, a rank's query head attending KV head r // 2)
WHISPER_GQA = "whisper-tiny-gqa"


def cfg(arch):
    if arch == WHISPER_GQA:
        return reduced(get_config(WHISPER), vocab_size=WHISPER_VOCAB,
                       num_heads=4, num_kv_heads=2, head_dim=16)
    if arch == WHISPER:
        return reduced(get_config(arch), vocab_size=WHISPER_VOCAB,
                       num_heads=WHISPER_HEADS, num_kv_heads=WHISPER_HEADS,
                       head_dim=16)
    return get_reduced_config(arch)


def vlm_positions(B, S, S_f):
    """M-RoPE ids: the patches at (t, h, w) = (0, i // W, i % W), the text
    after them on all three rows from the grid's largest id + 1."""
    i = torch.arange(S_f)
    start = int(max((i // VLM_GRID_W).max(), (i % VLM_GRID_W).max())) + 1
    text = start + torch.arange(S - S_f)
    rows = [torch.cat([i * 0, text]), torch.cat([i // VLM_GRID_W, text]),
            torch.cat([i % VLM_GRID_W, text])]
    return torch.stack(rows)[:, None].expand(3, B, S).to(
        torch.int32).contiguous()


def batch_of(c):
    """`_torch_lm_ranks_cases.batch_of`'s batch; qwen2-vl's patch prefix
    cut to `VLM_PATCHES` rows with `vlm_positions`."""
    b = make_dummy_batch(c, ShapeCfg("t", base.S, base.B, "train"),
                         torch.Generator().manual_seed(1))
    if c.frontend == "vision_stub":
        b["frontend_embeds"] = b["frontend_embeds"][:, :VLM_PATCHES]
        b["positions"] = vlm_positions(base.B, base.S, VLM_PATCHES)
    return b


def frames_of(c):
    """The prompts' frontend: Whisper's frames, or qwen2-vl's patch
    prefix (None for RWKV)."""
    gen = torch.Generator().manual_seed(9)
    if c.enc_dec is not None:
        return 0.02 * torch.randn((base.B, c.enc_dec.enc_seq, c.d_model),
                                  generator=gen)
    if c.frontend == "vision_stub":
        return 0.02 * torch.randn((base.B, VLM_PROMPT_PATCHES, c.d_model),
                                  generator=gen)
    return None


@contextlib.contextmanager
def batches():
    """`batch_of` as the base cases' batch and `WKV_CHUNK` as the WKV's
    chunk, restored after."""
    saved = base.batch_of, rwkv.CHUNK
    base.batch_of, rwkv.CHUNK = batch_of, WKV_CHUNK
    try:
        yield
    finally:
        base.batch_of, rwkv.CHUNK = saved


@contextlib.contextmanager
def first_step(save, mesh, tag):
    """Save the gradients the train step hands `adamw.apply` on its first
    call and the parameters that call returns (whole, gathered on a rank
    mesh) under ``<tag>/grads`` and ``<tag>/params1``: the step's own
    gradients, and the parameters its second step starts from."""
    real, seen = adamw.apply, []

    def whole(tree):        # a copy: the next step writes in place
        if shd.is_rank_mesh(mesh):
            return shd.full_tree(tree)
        return shd.map_with_path(lambda _, x: x.detach().clone(), tree)

    def apply(cfg, grads, state, params):
        first = not seen
        seen.append(True)
        if first:
            base._save_tree(save, f"{tag}/grads", whole(grads))
        out = real(cfg, grads, state, params)
        if first:
            base._save_tree(save, f"{tag}/params1", whole(out[0]))
        return out

    adamw.apply = apply
    try:
        yield
    finally:
        adamw.apply = real


def loss_and_norm(c, params):
    """One process's loss and gradients' global norm on the train batch
    at ``params``, as the train step computes them (under `batches`)."""
    st = steps.make_train_step(c, ShapeCfg("t", base.S, base.B, "train"),
                               None, base.OPT, device="cpu")
    live = [p.detach().requires_grad_() for p in adamw.tree_leaves(params)]
    loss = st.model.loss(adamw.tree_unflatten(params, live), batch_of(c))
    grads = adamw.tree_unflatten(params,
                                 list(torch.autograd.grad(loss, live)))
    return loss.detach(), adamw.global_norm(grads)


def one_process_logits(c, params, prompts, frames):
    """`launch.serve.generate_ranked`'s steps in one process, every
    step's last logits kept, and the cache after the last step."""
    model = build_model(c, device="cpu")
    P = prompts.shape[1]
    with torch.no_grad():
        if c.enc_dec is not None:
            logits, _ = whisper.forward(params, c, prompts, frames)
            cache = whisper.fill_cross(params, c, frames,
                                       model.init_cache(base.B,
                                                        base.MAX_SEQ))
            for i in range(P):
                model.decode_step(params, prompts[:, i:i + 1], i, cache)
        else:
            logits, pcache = transformer.prefill(params, c, prompts,
                                                 frontend_embeds=frames)
            cache = serve.graft(model.init_cache(base.B, base.MAX_SEQ),
                                pcache)
        out = [logits[:, -1].float()]
        tok = out[-1].argmax(-1)[:, None]
        for i in range(base.GEN - 1):
            logits, cache = model.decode_step(params, tok, P + i, cache)
            out.append(logits[:, -1].float())
            tok = out[-1].argmax(-1)[:, None]
    return out, cache


def generate(save, mesh, c, params, *, tag):
    """Greedy prefill of the prompts (with the model's frontend) and
    ``GEN - 1`` decode steps: every step's logits and the decode cache
    after them, whole; on a rank mesh through the sharded steps, with
    the blocks' shapes."""
    prompts, frames = base.prompts_of(c), frames_of(c)
    if shd.is_rank_mesh(mesh):
        pspec = steps.make_prefill_step(
            c, ShapeCfg("p", base.PROMPT, base.B, "prefill"), mesh,
            device="cpu").in_specs[0]
        out = serve.generate_ranked(
            c, mesh, shd.shard_tree(params, pspec, mesh, "cpu"), prompts,
            base.GEN, base.MAX_SEQ, "cpu", temperature=0.0,
            frontend_embeds=frames)
        logits, cache = out["logits"], out["cache"]
        save(f"{tag}/comm", np.array(sum(out["decode_comm"]["calls"]
                                         .values())))
        base._save_shapes(save, f"{tag}/cache", cache)
        with shd.use_mesh(mesh, "cpu"):
            cache = shd.full_tree(cache)
    else:
        logits, cache = one_process_logits(c, params, prompts, frames)
    save(f"{tag}/tokens", torch.stack([x.argmax(-1) for x in logits], 1))
    for i, x in enumerate(logits):
        save(f"{tag}/logits/{i}", x)
    base._save_tree(save, f"{tag}/cache", cache)


def prefill_cache(save, mesh, c, params, *, tag):
    """`launch.steps.make_prefill_step`'s logits and cache (a decoder-only
    model's; Whisper's prefill is its last logits), whole; on a rank mesh
    with the blocks' shapes."""
    prompts, frames = base.prompts_of(c), frames_of(c)
    st = steps.make_prefill_step(c, ShapeCfg("p", base.PROMPT, base.B,
                                             "prefill"), mesh, device="cpu")
    batch = {"tokens": prompts}
    if frames is not None:
        batch["frontend_embeds"] = frames
    if shd.is_rank_mesh(mesh):
        out = st.fn(shd.shard_tree(params, st.in_specs[0], mesh, "cpu"),
                    shd.shard_tree(batch, st.in_specs[1], mesh, "cpu"))
        if c.enc_dec is None:
            base._save_shapes(save, f"{tag}/cache", out[1])
        with shd.use_mesh(mesh, "cpu"):
            out = shd.full_tree(out)
    else:
        out = st.fn(params, batch)
    logits, cache = (out, {}) if c.enc_dec is not None else out
    save(f"{tag}/logits", logits)
    base._save_tree(save, f"{tag}/cache", cache)


def run(save, mesh, arch, name):
    """Every case of ``arch`` on ``mesh``, tagged ``<arch>/<name>/...``."""
    c = cfg(arch)
    tag = f"{arch}/{name}"
    with batches():
        with first_step(save, mesh, f"{tag}/train"):
            base.train(save, mesh, c, params_of(c), tag=f"{tag}/train")
        generate(save, mesh, c, params_of(c), tag=f"{tag}/gen")
        prefill_cache(save, mesh, c, params_of(c), tag=f"{tag}/prefill")


def eight_bit(save, mesh, arch, name):
    """Two train steps with 8-bit moments (`_torch_lm_ranks_cases.
    eight_bit`: each apply's gradients and state, whole), tagged
    ``<arch>/<name>/q8``."""
    c = cfg(arch)
    with batches():
        base.eight_bit(save, mesh, c, params_of(c), tag=f"{arch}/{name}/q8")


# `constrain`'s move of the model axis between dims: a (B, P, H, hd)
# block held with "model" on the heads and asked for with it on the
# positions, as Whisper's cross K/V moves (ROADMAP Queue 3 item 31)
MOVE_SHAPE = (4, 8, 4, 3)
MOVE_HELD = ("batch", None, "heads", None)
MOVE_NAMES = ("batch", "kv_seq", None, None)


def constrain_move(save, mesh):
    """`models.sharding.constrain` of this rank's `MOVE_HELD` block of a
    whole tensor (the same on every rank, every entry distinct) to
    `MOVE_NAMES`, and the block of that whole the rules give for
    `MOVE_NAMES`: ``constrain/got`` and ``constrain/want``."""
    x = torch.arange(np.prod(MOVE_SHAPE), dtype=torch.float32).reshape(
        MOVE_SHAPE)

    def block(names):
        comm, t = shd.current_comm(), x
        for dim, part in enumerate(shd.spec(x.shape, names)):
            t = comm.block(t, dim, shd._spec_axes(part))
        return t.clone()

    with shd.use_mesh(mesh, "cpu"):
        got = shd.constrain(block(MOVE_HELD), MOVE_NAMES, held=MOVE_HELD)
        want = block(MOVE_NAMES)
    save("constrain/got", got)
    save("constrain/want", want)
    save("constrain/held", np.array(block(MOVE_HELD).shape))
