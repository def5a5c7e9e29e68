"""The dense language model's steps on rank meshes: the cases that
`test_torch_lm_ranks.py` runs in gloo ranks and, with ``mesh=None``, in
one process.  Every case builds its inputs from seeds or from the arrays
it is handed, so every process sees the same ones, and hands what it
computed to ``save(name, *tensors)``: whole values (`full_tree`) and this
rank's block shapes.

No jax here: the ranks import this module.
"""
import contextlib
import dataclasses

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
# 8-bit moments; reduced gemma2-2b's gradient norm is ~2.1, so the clip
# of 1.0 scales every step, and a clip of 1e3 never does
OPT8 = dataclasses.replace(OPT, state_bits=8)
OPT8_NOCLIP = dataclasses.replace(OPT8, grad_clip=1e3)


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


def train(save, mesh, c, params, *, tag, steps_=STEPS, microbatches=1,
          opt_cfg=OPT):
    """``steps_`` train steps on one batch: each step's loss and gradient
    norm, and the parameters and moments after them, whole; on a rank
    mesh also the blocks' shapes."""
    st = steps.make_train_step(c, ShapeCfg("t", S, B, "train"), mesh,
                               opt_cfg, microbatches=microbatches,
                               device="cpu")
    batch = batch_of(c)
    if shd.is_rank_mesh(mesh):
        params = shd.shard_tree(params, st.in_specs[0], mesh, "cpu")
        batch = shd.shard_tree(batch, st.in_specs[2], mesh, "cpu")
    else:       # the step writes the parameters in place
        params = shd.map_with_path(lambda _, x: x.clone(), params)
    opt = adamw.init(params, opt_cfg.state_bits)
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


def save_comm(save, tag, comm):
    """A `MeshComm`'s calls and contributed bytes by kind: what
    `launch.dryrun.rank_trace` must give for the same step."""
    rec = comm.record()
    for kind in comm.KINDS:
        save(f"{tag}/calls/{kind}", np.array(rec["calls"][kind]))
        save(f"{tag}/bytes/{kind}", np.array(rec["bytes"][kind]))


# the dry run's calibration cell: a train step at B = 32, S = 64
COMM_B = 32


def comm_step(save, mesh, c, *, tag, opt_cfg=OPT, batch=COMM_B):
    """One train step at B = ``batch``, S = `S` from seed 0's parameters
    on a rank mesh, with nothing of the test's own in it: this rank's
    `MeshComm` record of the step (`save_comm`)."""
    shape = ShapeCfg("t", S, batch, "train")
    st = steps.make_train_step(c, shape, mesh, opt_cfg, device="cpu")
    params = shd.shard_tree(build_model(c, device="cpu").init(0),
                            st.in_specs[0], mesh, "cpu")
    tokens = shd.shard_tree(
        make_dummy_batch(c, shape, torch.Generator().manual_seed(1)),
        st.in_specs[2], mesh, "cpu")
    opt = adamw.init(params, opt_cfg.state_bits)
    comm = shd.rank_comm(mesh, "cpu")
    comm.reset()
    st.fn(params, opt, tokens)
    save_comm(save, tag, comm)


@contextlib.contextmanager
def applies(save, mesh, tag, calls=2):
    """Record what the train step's first ``calls`` `adamw.apply` calls
    see: the gradients call n is handed (``<tag>/grads<n>``) and the
    state it returns (``<tag>/state<n>``, as (params, mu, nu)), whole."""
    real, seen = adamw.apply, []

    def whole(tree):        # a copy: the next step writes in place
        if shd.is_rank_mesh(mesh):
            return shd.full_tree(tree)
        return shd.map_with_path(lambda _, x: x.detach().clone(), tree)

    def apply(cfg, grads, state, params):
        seen.append(True)
        n = len(seen)
        if n <= calls:
            _save_tree(save, f"{tag}/grads{n}", whole(grads))
        out = real(cfg, grads, state, params)
        if n <= calls:
            _save_tree(save, f"{tag}/state{n}",
                       whole((out[0], out[1].mu, out[1].nu)))
        return out

    adamw.apply = apply
    try:
        yield
    finally:
        adamw.apply = real


def eight_bit(save, mesh, c, params, *, tag, opt=OPT8):
    """`train` with 8-bit moments (``opt``), and each apply's gradients
    and state (`applies`)."""
    with applies(save, mesh, tag):
        train(save, mesh, c, params, tag=tag, opt_cfg=opt)


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
    """What a rank mesh refuses: a rank holding several positions.  Saves
    each error's type name and message."""
    c = cfg()
    shape = ShapeCfg("t", S, B, "train")
    cases = {
        "several_positions": lambda: steps.make_train_step(
            c, shape, make_rank_mesh((2, 2), ("data", "model")),
            device="cpu"),
    }
    for name, fn in cases.items():
        try:
            fn()
            save(f"refused/{name}", np.array("none"))
        except Exception as e:       # the type and message are the result
            save(f"refused/{name}", np.array(f"{type(e).__name__}: {e}"))


def checkpoints(save, mesh, c, params, ckpt_in, ckpt_out, prefix="",
                opt_cfg=OPT, asynchronous=False):
    """Resume the checkpoint in ``ckpt_in`` (whole leaves, as one process
    writes them) on this rank mesh (`ElasticState`), and write the state
    after one more step to ``ckpt_out`` (whole leaves, rank 0 writing;
    through `checkpoint.AsyncCheckpointer` with ``asynchronous``); the
    results are saved under ``prefix + "ckpt/"``: the resumed parameters
    and, with 8-bit moments (``opt_cfg``), the resumed moments and the
    step's gradients and state (`applies`), whole."""
    from repro_torch.runtime.fault_tolerance import ElasticState

    st = steps.make_train_step(c, ShapeCfg("t", S, B, "train"), mesh,
                               opt_cfg, device="cpu")
    pspec, ospec, bspec = st.in_specs
    step, (params, opt) = ElasticState(ckpt_in).resume(
        mesh, lambda _: (pspec, ospec), st.abstract_args[:2], device="cpu")
    save(prefix + "ckpt/resumed_step", np.array(step))
    _save_shapes(save, prefix + "ckpt/params", params)
    quantized = opt_cfg.state_bits == 8
    with shd.use_mesh(mesh, "cpu"):
        _save_tree(save, prefix + "ckpt/resumed", shd.full_tree(
            (params, opt.mu, opt.nu) if quantized else params))
    batch = shd.shard_tree(batch_of(c), bspec, mesh, "cpu")
    with (applies(save, mesh, prefix + "ckpt", calls=1) if quantized
          else contextlib.nullcontext()):
        params, opt, m = st.fn(params, opt, batch)
    save(prefix + "ckpt/loss", m["loss"])
    if quantized:
        _save_shapes(save, prefix + "ckpt/mu", opt.mu)
    if asynchronous:
        writer = ckpt.AsyncCheckpointer(ckpt_out)
        writer.save(step + 1, (params, opt))
        writer.wait()
    else:
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


# ---------------------------------------------------------------------------
# 8-bit moments: the checks the test modules share (no rank runs them)
# ---------------------------------------------------------------------------
# the leaves of a `QTensor` as `leaves_with_path` keys them
Q, SCALE = "[<flat index 0>]", "[<flat index 1>]"
# the 8-bit contract (ROADMAP Queue 3 item 33): scales to 1e-6 relative
# for `adamw.apply` on the same state and gradients, where only the clip
# factor's rounding differs; 1e-5 where the gradients themselves differ
# in their last places (the ranks' first step; the reference's); the
# parameters to 1e-5 + lr/5 (item 28's rule)
SCALE_RTOL, GRAD_SCALE_RTOL = 1e-6, 1e-5
PARAM_ATOL = 1e-5 + 0.2 * OPT.lr


def sub(tree: dict, prefix: str) -> dict:
    """``{key: array}`` of the leaves saved under ``prefix`` (keys
    relative to it)."""
    return {k[len(prefix):]: v[0] for k, v in tree.items()
            if k.startswith(prefix + "[")}


def eight_bit_close(got: dict, want: dict, exact=False,
                    scale_rtol=SCALE_RTOL):
    """States ``(params, mu, nu)`` by the 8-bit contract (ROADMAP Queue 3
    item 33): bit for bit when ``exact``; else the parameters to 1e-5 +
    lr/5, the codes within one, the scales to ``scale_rtol``."""
    assert want and got.keys() == want.keys()
    assert any(k.endswith(Q) for k in want)
    for k, w in want.items():
        g = got[k]
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k.startswith("[0]"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=PARAM_ATOL,
                                       err_msg=k)
        elif k.endswith(Q):
            assert g.dtype == np.int8, k
            assert np.abs(g.astype(np.int32) - w).max() <= 1, k
        else:
            assert k.endswith(SCALE), k
            np.testing.assert_allclose(g, w, rtol=scale_rtol, atol=0,
                                       err_msg=k)


def replayed(rank: dict, tag: str, c, opt_cfg, state=None, step=1,
             call=2) -> dict:
    """One process's `adamw.apply` on the state a mesh's first step left
    (or a copy of ``state``, whole tensors, after ``step`` steps) and the
    gradients the mesh's apply call ``call`` was handed: ``(params, mu,
    nu)`` keyed as the ranks save them."""
    like = build_model(c, device="cpu").init(0)
    opt = adamw.init(like, 8)

    def load(prefix, tree):
        return shd.map_with_path(lambda key, _: torch.from_numpy(
            np.array(rank[prefix + key][0])), tree)

    if state is None:
        state = load(f"{tag}/state1", (like, opt.mu, opt.nu))
    p1, mu1, nu1 = shd.map_with_path(lambda _, x: x.clone(), state)
    grads = load(f"{tag}/grads{call}", like)
    step = torch.tensor(step, dtype=torch.int32)
    p2, o2, _ = adamw.apply(opt_cfg, grads, adamw.OptState(step, mu1, nu1),
                            p1)
    return {k: v.numpy() for k, v in
            shd.leaves_with_path((p2, o2.mu, o2.nu))}
