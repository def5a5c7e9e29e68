"""The dense language model's steps on rank meshes: the cases that
`test_torch_lm_ranks.py` runs in gloo ranks and, with ``mesh=None``, in
one process.  Every case builds its inputs from seeds or from the arrays
it is handed, so every process sees the same ones, and hands what it
computed to ``save(name, *tensors)``: whole values (`full_tree`) and this
rank's block shapes.

No jax here: the ranks import this module.
"""
import contextlib

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.hwaware import HwAwareConfig
from repro_torch.launch import serve, steps
from repro_torch.models import attention, flash
from repro_torch.models import sharding as shd
from repro_torch.models.model import build_model, make_dummy_batch
from repro_torch.models.sharding import leaves_with_path
from repro_torch.optim import adamw

ARCH = "gemma2-2b"
B, S = 4, 64               # the train batch
PROMPT, GEN, MAX_SEQ = 16, 5, 32
STEPS = 2
OPT = adamw.AdamWConfig(warmup_steps=1)


def cfg():
    return get_reduced_config(ARCH)


def params_of(inputs, c):
    """The reference's reduced parameters when handed (``p/<key>``), else
    the port's own draw from seed 0."""
    keys = [k for k in inputs if k.startswith("p/")]
    if not keys:
        return build_model(c, device="cpu").init(0)
    like = build_model(c, device="cpu").init(0)
    return shd.map_with_path(
        lambda key, _: torch.from_numpy(np.array(inputs["p/" + key])), like)


def batch_of(c):
    return make_dummy_batch(c, ShapeCfg("t", S, B, "train"),
                            torch.Generator().manual_seed(1))


def prompts_of(c):
    return torch.randint(0, c.vocab_size, (B, PROMPT),
                         generator=torch.Generator().manual_seed(3))


def _save_tree(save, name, tree):
    for key, leaf in leaves_with_path(tree):
        save(f"{name}{key}", leaf)


def _save_shapes(save, name, tree):
    for key, leaf in leaves_with_path(shd.local_tree(tree)):
        save(f"shape/{name}{key}", np.array(leaf.shape, dtype=np.int64))


# the hardware-aware cases: 8 bits, gain mismatch on, every matrix of 256
# entries or more (the reduced model's are small)
HW = HwAwareConfig(bits=8, sigma_gain=0.03, min_size=256)


def train(save, mesh, c, params, *, tag, steps_=STEPS, microbatches=1):
    """``steps_`` train steps on one batch: each step's loss and gradient
    norm, and the parameters and moments after them, whole; on a rank
    mesh also the blocks' shapes."""
    st = steps.make_train_step(c, ShapeCfg("t", S, B, "train"), mesh, OPT,
                               microbatches=microbatches, device="cpu")
    batch = batch_of(c)
    if shd.is_rank_mesh(mesh):
        params = shd.shard_tree(params, st.in_specs[0], mesh, "cpu")
        batch = shd.shard_tree(batch, st.in_specs[2], mesh, "cpu")
    else:       # the step writes the parameters in place
        params = shd.map_with_path(lambda _, x: x.clone(), params)
    opt = adamw.init(params)
    for i in range(steps_):
        params, opt, m = st.fn(params, opt, batch)
        save(f"{tag}/loss/{i}", m["loss"])
        save(f"{tag}/grad_norm/{i}", m["grad_norm"])
    if shd.is_rank_mesh(mesh):
        _save_shapes(save, f"{tag}/params", params)
        _save_shapes(save, f"{tag}/mu", opt.mu)
        _save_shapes(save, f"{tag}/nu", opt.nu)
        _save_shapes(save, f"{tag}/batch", batch)
        with shd.use_mesh(mesh, "cpu"):
            params, mu, nu = shd.full_tree((params, opt.mu, opt.nu))
    else:
        mu, nu = opt.mu, opt.nu
    _save_tree(save, f"{tag}/params", params)
    _save_tree(save, f"{tag}/mu", mu)
    _save_tree(save, f"{tag}/nu", nu)
    return params, opt


def loss_and_grads(save, mesh, c, params, *, tag, hw=None):
    """`Model.loss` and its gradients, as `launch.steps`' train step takes
    them (DTensor leaves on a rank mesh), whole; hardware-aware with
    ``hw``."""
    st = steps.make_train_step(c, ShapeCfg("t", S, B, "train"), mesh, OPT,
                               hw_aware=hw, device="cpu")
    batch = batch_of(c)
    baxes = ()
    if shd.is_rank_mesh(mesh):
        params = shd.shard_tree(params, st.in_specs[0], mesh, "cpu")
        batch = shd.shard_tree(batch, st.in_specs[2], mesh, "cpu")
        baxes = steps._batch_axes(st.in_specs[2])
    with shd.use_mesh(mesh, "cpu", baxes):
        live = [p.detach().requires_grad_()
                for p in adamw.tree_leaves(params)]
        loss = st.model.loss(adamw.tree_unflatten(params, live),
                             shd.local_tree(batch))
        grads = adamw.tree_unflatten(params,
                                     list(torch.autograd.grad(loss, live)))
        if shd.is_rank_mesh(mesh):
            grads = shd.full_tree(grads)
    save(f"{tag}/loss", loss)
    _save_tree(save, f"{tag}/grads", grads)


def generate(save, mesh, c, params, *, tag):
    """Greedy prefill of the prompts and ``GEN - 1`` decode steps: every
    step's logits, whole; on a rank mesh through the sharded steps."""
    prompts = prompts_of(c)
    if shd.is_rank_mesh(mesh):
        pspec = steps.make_prefill_step(
            c, ShapeCfg("p", PROMPT, B, "prefill"), mesh,
            device="cpu").in_specs[0]
        out = serve.generate_ranked(c, mesh, shd.shard_tree(
            params, pspec, mesh, "cpu"), prompts, GEN, MAX_SEQ, "cpu",
            temperature=0.0)
        logits = out["logits"]
        save(f"{tag}/comm", np.array(sum(out["decode_comm"]["calls"]
                                         .values())))
        _save_shapes(save, f"{tag}/cache", out["cache"])
    else:
        logits = _one_process_logits(c, params, prompts)
    save(f"{tag}/tokens", torch.stack([x.argmax(-1) for x in logits], 1))
    for i, x in enumerate(logits):
        save(f"{tag}/logits/{i}", x)


def _one_process_logits(c, params, prompts):
    """`serve.generate`'s steps with every step's last logits kept."""
    from repro_torch.models import transformer

    model = build_model(c, device="cpu")
    with torch.no_grad():
        logits, pcache = transformer.prefill(params, c, prompts)
        cache = serve.graft(model.init_cache(B, MAX_SEQ), pcache)
        out = [logits[:, -1].float()]
        tok = out[-1].argmax(-1)[:, None]
        for i in range(GEN - 1):
            logits, cache = model.decode_step(params, tok, PROMPT + i, cache)
            out.append(logits[:, -1].float())
            tok = out[-1].argmax(-1)[:, None]
    return out


@contextlib.contextmanager
def seq_shard_flash():
    """The flash path at the reduced sizes, with sequence-parallel
    attention on: the module constants patched, restored after."""
    saved = (attention.DIRECT_MAX_SEQ, attention.SEQ_SHARD_ATTN,
             flash.Q_CHUNK, flash.KV_CHUNK)
    attention.DIRECT_MAX_SEQ, attention.SEQ_SHARD_ATTN = 16, True
    flash.Q_CHUNK, flash.KV_CHUNK = 16, 16
    try:
        yield
    finally:
        (attention.DIRECT_MAX_SEQ, attention.SEQ_SHARD_ATTN,
         flash.Q_CHUNK, flash.KV_CHUNK) = saved


def seq_shard_cfg():
    """3 query heads on 1 KV head: a count the 2-way "model" axis does not
    divide, so the heads stay whole and the queries' sequence splits."""
    import dataclasses
    return dataclasses.replace(cfg(), num_heads=3, num_kv_heads=1)


def refusals(save, make_rank_mesh):
    """What a rank mesh refuses: a rank holding several positions, 8-bit
    moments (on the dense model's step and on Whisper's).  Saves each
    error's type name and message."""
    c = cfg()
    shape = ShapeCfg("t", S, B, "train")
    mesh = make_rank_mesh((1, 2), ("data", "model"))
    cases = {
        "several_positions": lambda: steps.make_train_step(
            c, shape, make_rank_mesh((2, 2), ("data", "model")),
            device="cpu"),
        "eight_bit_step": lambda: steps.make_train_step(
            c, shape, mesh, adamw.AdamWConfig(state_bits=8), device="cpu"),
        "eight_bit_whisper": lambda: steps.make_train_step(
            get_reduced_config("whisper-tiny"), shape, mesh,
            adamw.AdamWConfig(state_bits=8), device="cpu"),
        "eight_bit_init": lambda: adamw.init(shd.shard_tree(
            build_model(c, device="cpu").init(0),
            shd.param_specs(build_model(c, device="cpu").init(0), mesh),
            mesh, "cpu"), 8),
    }
    for name, fn in cases.items():
        try:
            fn()
            save(f"refused/{name}", np.array("none"))
        except Exception as e:       # the type and message are the result
            save(f"refused/{name}", np.array(f"{type(e).__name__}: {e}"))


def checkpoints(save, mesh, c, params, ckpt_in, ckpt_out, prefix=""):
    """Resume the one-process checkpoint in ``ckpt_in`` on this rank mesh
    (`ElasticState`), and write the state after one more step to
    ``ckpt_out`` (whole leaves, rank 0 writing); the results are saved
    under ``prefix + "ckpt/"``."""
    from repro_torch.runtime.fault_tolerance import ElasticState

    st = steps.make_train_step(c, ShapeCfg("t", S, B, "train"), mesh, OPT,
                               device="cpu")
    pspec, ospec, bspec = st.in_specs
    step, (params, opt) = ElasticState(ckpt_in).resume(
        mesh, lambda _: (pspec, ospec), st.abstract_args[:2], device="cpu")
    save(prefix + "ckpt/resumed_step", np.array(step))
    _save_shapes(save, prefix + "ckpt/params", params)
    with shd.use_mesh(mesh, "cpu"):
        _save_tree(save, prefix + "ckpt/resumed", shd.full_tree(params))
    batch = shd.shard_tree(batch_of(c), bspec, mesh, "cpu")
    params, opt, m = st.fn(params, opt, batch)
    save(prefix + "ckpt/loss", m["loss"])
    ckpt.save(ckpt_out, step + 1, (params, opt))


# dtypes of the gathers' bit check: (name, torch dtype, the integer dtype
# of its bits); 5 bool or int8 elements are not a multiple of 4 bytes
TRANSPORT_DTYPES = (("float32", torch.float32, torch.int32),
                    ("bfloat16", torch.bfloat16, torch.int16),
                    ("int8", torch.int8, torch.int8),
                    ("bool", torch.bool, torch.bool))


def transport_block(rank, dtype):
    """Rank ``rank``'s block for the gathers' bit check: a negative zero,
    a NaN with a payload and infinities among the floats."""
    if dtype == torch.bool:
        return torch.tensor([True, False, rank == 1, True, rank == 0])
    if dtype == torch.int8:
        return torch.tensor([-128, -1, 0, 127, rank], dtype=torch.int8)
    bits = torch.tensor([0x80000000, 0x7FC01234, 0x7F800000, 0xFF800000,
                         0x3FC00000 + rank], dtype=torch.int64)
    f = bits.to(torch.int32).view(torch.float32)
    if dtype == torch.float32:
        return f
    # bfloat16: the upper half of each float32's bits
    return (bits >> 16).to(torch.int16).view(torch.bfloat16)


def transport(save, mesh):
    """Every rank's `transport_block` gathered by the language model's
    `MeshComm.all_gather` over ``model`` and by the p-bit engine's
    `RankComm.all_gather` over the group: both stage and gather alike, a
    sum of integers with zeros, which must copy every bit."""
    import torch.distributed as dist

    from repro_torch.core import ranks

    rank, world = dist.get_rank(), dist.get_world_size()
    comm = ranks.rank_comm(mesh, "cpu")
    pbit = ranks.RankComm(None, [(r, r + 1, 0, 1) for r in range(world)],
                          "cpu")
    for name, dtype, bits in TRANSPORT_DTYPES:
        x = transport_block(rank, dtype)
        save(f"transport/{name}",
             comm.all_gather(x, 0, ("model",)).view(bits),
             pbit.all_gather(x).reshape(-1).view(bits))
