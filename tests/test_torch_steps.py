"""The step functions of `repro_torch.launch.steps` under a mesh, and the
``REPRO_REMAT=dots`` policy, on reduced configs on the CPU.

* `make_step` dispatches by the shape's kind, each step with the
  reference's argument and spec layout;
* a train step under a 2 x 4 logical mesh equals the one with
  ``mesh=None`` bit for bit (the port's meshes are logical devices of one
  device: a spec changes no value);
* `make_serve_step` and `make_prefill_step` equal the reference's on the
  same parameters (`convert.lm_tree_from_numpy`);
* `make_dummy_batch` draws the reference's shapes, dtypes and ranges;
* ``REPRO_REMAT=dots`` leaves the loss and the gradients bit-equal, and
  its backward recomputes fewer unbatched products (``aten.mm``) and the
  same batched ones (``aten.bmm``: attention's, recomputed as the
  reference's ``dots_with_no_batch_dims_saveable`` recomputes them).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import assert_lm_tree_close, lm_state
from repro.configs.base import ShapeCfg as RShape
from repro.launch import mesh as ref_mesh
from repro.launch import steps as RS
from repro.models.model import make_dummy_batch as ref_dummy
from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_reduced_config as ref_reduced
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_reduced_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as PS
from repro_torch.models import sharding as shd
from repro_torch.models.model import build_model, make_dummy_batch
from repro_torch.optim import adamw


def _batch(cfg, shape, seed=1):
    return make_dummy_batch(cfg, shape, torch.Generator().manual_seed(seed))


def test_make_step_dispatches_by_kind():
    cfg = get_reduced_config("gemma2-2b")
    mesh = mesh_mod.make_host_mesh(2, 4)
    train = PS.make_step(cfg, ShapeCfg("t", 16, 8, "train"), mesh,
                         opt_bits=8, device="cpu")
    assert len(train.abstract_args) == len(train.in_specs) == 3
    assert train.out_specs[2] is None
    assert any(leaf.dtype == torch.int8 for _, leaf in
               shd.leaves_with_path(train.abstract_args[1].mu))
    assert train.in_specs[2]["tokens"] == shd.P("data", None)
    prefill = PS.make_step(cfg, ShapeCfg("p", 16, 8, "prefill"), mesh,
                           device="cpu")
    assert len(prefill.abstract_args) == 2 and prefill.out_specs is None
    assert "labels" not in prefill.abstract_args[1]
    decode = PS.make_step(cfg, ShapeCfg("d", 16, 8, "decode"), mesh,
                          device="cpu")
    params_a, tokens, pos, cache = decode.abstract_args
    assert tokens.shape == (8, 1) and pos.shape == ()
    assert decode.in_specs[1] == shd.P("data", None)
    k = cache["blocks"]["layer_0"]["k"]
    assert decode.in_specs[3]["blocks"]["layer_0"]["k"] == shd.spec(
        k.shape, (None, "batch", "kv_seq", "kv_heads", None), mesh)


def _digest(tree):
    return {k: v.clone() for k, v in shd.leaves_with_path(tree)}


def test_train_step_under_a_mesh_equals_no_mesh():
    """Two steps of the same state and batches under a 2 x 4 logical mesh
    and with ``mesh=None``: every parameter, moment and metric equal bit
    for bit (microbatched, so the accumulation runs too)."""
    cfg = get_reduced_config("gemma2-2b")
    shape = ShapeCfg("t", 16, 4, "train")
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    outs = []
    for mesh in (mesh_mod.make_host_mesh(2, 4), None):
        step = PS.make_train_step(cfg, shape, mesh, ocfg, microbatches=2,
                                  device="cpu")
        params = step.model.init(0)
        opt = adamw.init(params)
        metrics = []
        for s in range(2):
            params, opt, m = step.fn(params, opt, _batch(cfg, shape, s))
            metrics.append({k: v.clone() for k, v in m.items()})
        outs.append((_digest((params, opt)), metrics))
    (pa, ma), (pb, mb) = outs
    assert set(pa) == set(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    for a, b in zip(ma, mb):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def gemma():
    return lm_state("gemma2-2b", batch=2, seq=16)


def test_serve_step_matches_reference(gemma):
    """One decode step after writing the prompt's first positions: the
    port's `make_serve_step` under a 2 x 4 logical mesh against the
    reference's on a one-device host mesh, logits and cache."""
    cfg, rcfg, rmodel, rparams, pparams, rbatch, pbatch = gemma
    B, S = 2, 16
    rstep = RS.make_serve_step(rcfg, RShape("d", S, B, "decode"),
                               ref_mesh.make_host_mesh(1, 1))
    pstep = PS.make_serve_step(cfg, ShapeCfg("d", S, B, "decode"),
                               mesh_mod.make_host_mesh(2, 4), device="cpu")
    rcache = rmodel.init_cache(B, S)
    pcache = pstep.model.init_cache(B, S)
    for pos in range(3):
        tok = np.asarray(rbatch["tokens"])[:, pos:pos + 1]
        rlog, rcache = rstep.fn(rparams, jax.numpy.asarray(tok),
                                jax.numpy.int32(pos), rcache)
        plog, pcache = pstep.fn(pparams, torch.as_tensor(tok.copy()), pos,
                                pcache)
        np.testing.assert_allclose(plog.numpy(), np.asarray(rlog),
                                   rtol=1e-5, atol=1e-5)
    assert_lm_tree_close(pcache, rcache)


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-tiny"])
def test_prefill_step_matches_reference(arch, gemma):
    """`make_prefill_step` under the production mesh: the decoder's last
    logits and filled cache, and the encoder-decoder's last-position
    logits, equal the reference's."""
    cfg, rcfg, _, rparams, pparams, rbatch, pbatch = (
        gemma if arch == "gemma2-2b" else lm_state(arch, batch=2, seq=16))
    shape = ShapeCfg("p", 16, 2, "prefill")
    rstep = RS.make_prefill_step(rcfg, RShape("p", 16, 2, "prefill"),
                                 ref_mesh.make_host_mesh(1, 1))
    pstep = PS.make_prefill_step(cfg, shape, mesh_mod.make_production_mesh(),
                                 device="cpu")
    rb = {k: v for k, v in rbatch.items() if k != "labels"}
    pb = {k: v for k, v in pbatch.items() if k != "labels"}
    want, got = rstep.fn(rparams, rb), pstep.fn(pparams, pb)
    if cfg.enc_dec is not None:
        assert tuple(got.shape) == want.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
        assert_lm_tree_close(got[1], want[1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dummy_batch_matches_reference_in_shape_dtype_and_range(arch):
    cfg, rcfg = get_reduced_config(arch), ref_reduced(arch)
    want = ref_dummy(rcfg, RShape("s", 32, 3, "train"),
                     jax.random.PRNGKey(0))
    got = _batch(cfg, ShapeCfg("s", 32, 3, "train"))
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for k in ("tokens", "labels"):
        assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg.vocab_size
    if "positions" in want:
        np.testing.assert_array_equal(got["positions"].numpy(),
                                      np.asarray(want["positions"]))
    if "frontend_embeds" in want:
        assert float(got["frontend_embeds"].float().abs().max()) < 0.2


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_saves_unbatched_products_only(monkeypatch):
    """Reduced gemma2-2b with remat: ``REPRO_REMAT=dots`` against the
    default policy — the loss and every gradient bit-equal; the backward
    recomputes 7 products a layer fewer (q, k, v, o, gate, up, down) and
    every batched product again."""
    cfg = dataclasses.replace(get_reduced_config("gemma2-2b"), remat=True)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = _batch(cfg, ShapeCfg("t", 64, 2, "train"))
    runs = {}
    for mode in ("default", "dots"):
        if mode == "dots":
            monkeypatch.setenv("REPRO_REMAT", "dots")
        else:
            monkeypatch.delenv("REPRO_REMAT", raising=False)
        live = [p.detach().requires_grad_()
                for p in adamw.tree_leaves(params)]
        loss = model.loss(adamw.tree_unflatten(params, live), batch)
        with _Count() as count:
            grads = torch.autograd.grad(loss, live)
        runs[mode] = (loss.detach(), grads, count.ops)
    (l0, g0, c0), (l1, g1, c1) = runs["default"], runs["dots"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert c0[mm] - c1[mm] == 7 * cfg.num_layers
    assert c0[bmm] == c1[bmm] > 0
