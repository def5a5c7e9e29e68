"""The language model's loss and gradients on the port (`Model.loss`,
`transformer.chunked_ce`, remat, `unbind_groups`) against the
reference's, reduced gemma2-2b and deepseek-67b (float32), the
reference's parameters carried across by `repro_torch.convert` and the
same batch.  The train step and the entry point are
`tests/test_torch_train_step.py`'s.

Tolerances: the loss to 1e-5 relative; every gradient leaf to 1e-4 of
that leaf's max |g| (measured <= 1.6e-6: summation order), plainly and
through the hardware-aware transform at sigma_gain 0 (ROADMAP Queue 3
item 18: at sigma > 0 the packages draw different chips).  Remat and
`unbind_groups` change what is kept, not what is computed: their losses
and gradients are bit-equal to the plain run's on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as ref_reduced
from repro.core.hwaware import HwAwareConfig as RHw
from repro.data.pipeline import DataConfig as RData
from repro.data.pipeline import SyntheticLM as RSynth
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build
from repro_torch import convert
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.hwaware import HwAwareConfig
from repro_torch.models import transformer as PT
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

ARCHS = ["gemma2-2b", "deepseek-67b"]
HW = dict(bits=8, sigma_gain=0.0, min_size=256)
B, S = 2, 64


@pytest.fixture(scope="module")
def lm():
    """Per arch, built once: the reference's params (numpy) and batch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = ref_reduced(arch)
            params = ref_build(rcfg).init(jax.random.PRNGKey(0))
            batch = RSynth(RData(seed=0, vocab_size=rcfg.vocab_size)).batch(
                0, B, S)
            cache[arch] = (jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, batch))
        return cache[arch]
    return get


def _port_batch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _port_grads(loss_fn, params, batch):
    live = [p.detach().requires_grad_() for p in adamw.tree_leaves(params)]
    loss = loss_fn(adamw.tree_unflatten(params, live), batch)
    return loss.detach(), torch.autograd.grad(loss, live)


def _assert_grads_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        gap = np.abs(g.numpy() - w).max()
        assert gap <= 1e-4 * np.abs(w).max(), gap


@pytest.mark.parametrize("hw", [False, True], ids=["plain", "hw_sigma0"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(lm, arch, hw):
    np_params, np_batch = lm(arch)
    rmodel = ref_build(ref_reduced(arch), hw_aware=RHw(**HW) if hw else None)
    want_loss, want_g = jax.value_and_grad(rmodel.loss)(
        jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, np_batch))
    model = build_model(get_reduced_config(arch),
                        hw_aware=HwAwareConfig(**HW) if hw else None,
                        device="cpu")
    loss, grads = _port_grads(model.loss,
                              convert.lm_tree_from_numpy(np_params, "cpu"),
                              _port_batch(np_batch))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    _assert_grads_close(grads, jax.tree.leaves(want_g))


@pytest.mark.parametrize("chunk", [16, 24], ids=["divides", "full_ce"])
def test_chunked_ce_matches_reference(lm, monkeypatch, chunk):
    """`chunked_ce` over 4 chunks of 16, and with a chunk of 24 that does
    not divide S = 64 (the full `cross_entropy`), against the reference's
    with the same `CE_CHUNK`: the loss and its gradients in x and in the
    tied embedding."""
    for mod in (RT, PT):
        monkeypatch.setattr(mod, "CE_CHUNK", chunk)
    np_params, np_batch = lm("gemma2-2b")
    x = np.random.default_rng(1).normal(size=(B, S, 128)).astype(np.float32)
    cfg, rcfg = get_reduced_config("gemma2-2b"), ref_reduced("gemma2-2b")
    table = np_params["tok_embed"]
    want, (wt, wx) = jax.value_and_grad(
        lambda t, x: RT.chunked_ce({"tok_embed": t}, rcfg, x,
                                   jnp.asarray(np_batch["labels"])),
        argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))
    t, xt = (torch.as_tensor(np.array(a)).requires_grad_()
              for a in (table, x))
    got = PT.chunked_ce({"tok_embed": t}, cfg, xt,
                        torch.as_tensor(np.array(np_batch["labels"])))
    gt, gx = torch.autograd.grad(got, (t, xt))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    _assert_grads_close([gt, gx], [wt, wx])


def test_remat_is_bit_equal_to_no_remat(lm):
    """Remat (each group under `torch.utils.checkpoint`) recomputes the
    same operations in backward: loss and every gradient bit-equal."""
    np_params, np_batch = lm("gemma2-2b")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_reduced_config("gemma2-2b"),
                                  remat=remat)
        out.append(_port_grads(build_model(cfg, device="cpu").loss,
                               convert.lm_tree_from_numpy(np_params, "cpu"),
                               _port_batch(np_batch)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_unbind_groups_gradients_equal_group_slice(lm, monkeypatch):
    """The training path's groups by one ``unbind(0)`` a leaf give the
    gradients that per-group indexing (`group_slice`) gives, bit for
    bit (deepseek reduced: 4 groups of one layer)."""
    np_params, np_batch = lm("deepseek-67b")
    model = build_model(get_reduced_config("deepseek-67b"), device="cpu")
    params = convert.lm_tree_from_numpy(np_params, "cpu")
    unbound = _port_grads(model.loss, params, _port_batch(np_batch))
    monkeypatch.setattr(PT, "unbind_groups", lambda tree, G: [
        PT.group_slice(tree, g) for g in range(G)])
    sliced = _port_grads(model.loss, params, _port_batch(np_batch))
    assert torch.equal(unbound[0], sliced[0])
    assert all(torch.equal(a, b) for a, b in zip(unbound[1], sliced[1]))
