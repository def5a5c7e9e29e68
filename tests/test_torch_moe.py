"""The port's mixture-of-experts layer (`repro_torch.models.moe`) against
the reference's (`repro.models.moe`): each of `tests/test_moe.py`'s five
tests on the port, each also held against the reference on the same
inputs (the reference's `init_moe` parameters carried across by
`repro_torch.convert`, inputs from a numpy seed); the routing, a token
dropped at rank == C, the layer at the reduced granite / kimi / jamba
geometries with its gradients and in bf16; and the whole reduced granite
and kimi models' losses and gradients, plainly and hardware-aware.

Tolerances, float32: outputs 1e-5 absolute (the reference's own test's),
gates and the auxiliary loss 1e-6 relative (measured: equal to ~1e-7),
gradients 1e-4 of the leaf's max |g| (as `test_torch_train.py`).  The
top-k selection is compared exactly: on these inputs no router's k-th
and (k+1)-th probabilities come within 1e-6 of each other (asserted), so
``torch.topk`` and ``lax.top_k`` cannot order a tie differently.  In
bf16 the layer is held to 0.1 of the output's RMS (as the bf16 models in
`test_torch_lm.py`: the reference's bf16 ``silu`` rounds each step, the
port's once)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RM
import repro_torch.models.moe as PM
from _torch_port import (assert_hw_transform_matches,
                         assert_loss_and_grads_match, lm_state)
from repro.configs.base import MoECfg as RMoECfg
from repro.configs.registry import get_reduced_config as ref_reduced
from repro_torch import convert
from repro_torch.configs.base import MoECfg
from repro_torch.optim import adamw

OUT = dict(rtol=0, atol=1e-5)


def _params(m: MoECfg, d: int, seed: int, dtype=jnp.float32):
    """The reference's `init_moe` draw: (reference params, port params)."""
    rp = RM.init_moe(jax.random.PRNGKey(seed), d,
                     RMoECfg(**dataclasses.asdict(m)), dtype)
    return rp, convert.lm_tree_from_numpy(jax.tree.map(np.asarray, rp),
                                          "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(m: MoECfg, rp, pp, x):
    """(port y, port aux, reference y, reference aux)."""
    want, want_aux = RM.moe_layer(rp, RMoECfg(**dataclasses.asdict(m)),
                                  jnp.asarray(x))
    got, aux = PM.moe_layer(pp, m, torch.as_tensor(x))
    return got, aux, np.asarray(want), float(want_aux)


def _dense(pp, m: MoECfg, x):
    """Every token through its top-k experts, weighted by the
    renormalised gates, one at a time (the reference test's oracle)."""
    x = torch.as_tensor(x)
    probs = torch.softmax(x @ pp["router"], -1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for b in range(x.shape[0]):
        for t in range(x.shape[1]):
            for j in range(m.top_k):
                e = int(idx[b, t, j])
                h = torch.nn.functional.silu(x[b, t] @ pp["we_gate"][e]) * \
                    (x[b, t] @ pp["we_up"][e])
                y[b, t] += gate[b, t, j] * (h @ pp["we_down"][e])
    return y


def test_moe_matches_dense_reference_when_capacity_ample():
    m = MoECfg(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0)
    rp, pp = _params(m, 16, 0)
    x = _x((2, 8, 16), 1)
    got, aux, want, want_aux = _both(m, rp, pp, x)
    np.testing.assert_allclose(got.numpy(), _dense(pp, m, x).numpy(), **OUT)
    np.testing.assert_allclose(got.numpy(), want, **OUT)
    assert float(aux) >= 0.99  # Switch aux loss lower bound is 1 (balanced)
    assert float(aux) == pytest.approx(want_aux, rel=1e-6)


def test_moe_capacity_drops_tokens_not_crashes():
    m = MoECfg(num_experts=4, top_k=2, d_ff_expert=16,
               capacity_factor=0.25)  # deliberately starved
    rp, pp = _params(m, 8, 0)
    x = _x((1, 32, 8), 1)
    got, _, want, _ = _both(m, rp, pp, x)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **OUT)
    # starved capacity must reduce total output mass vs ample capacity
    m2 = dataclasses.replace(m, capacity_factor=8.0)
    y2, _ = PM.moe_layer(pp, m2, torch.as_tensor(x))
    assert float(got.abs().sum()) < float(y2.abs().sum())


def test_moe_shared_expert_always_active():
    m = MoECfg(num_experts=4, top_k=1, d_ff_expert=16, num_shared=1,
               capacity_factor=4.0)
    rp, pp = _params(m, 8, 2)
    x = _x((1, 4, 8), 3)
    y_with, _, want, _ = _both(m, rp, pp, x)
    np.testing.assert_allclose(y_with.numpy(), want, **OUT)
    p2 = dict(pp)
    p2["shared"] = {k: torch.zeros_like(v) for k, v in pp["shared"].items()}
    y_without, _ = PM.moe_layer(p2, m, torch.as_tensor(x))
    assert float((y_with - y_without).abs().max()) > 1e-6


def test_moe_chunked_equals_single_shot(monkeypatch):
    """Chunks of 16 (4 a row) against one shot, on the port; and the
    chunked layer (its outputs and the aux averaged over chunks) against
    the reference's with the same `TOK_CHUNK`."""
    m = MoECfg(num_experts=4, top_k=2, d_ff_expert=16, capacity_factor=8.0)
    rp, pp = _params(m, 8, 0)
    x = _x((2, 64, 8), 1)
    for mod in (RM, PM):
        monkeypatch.setattr(mod, "TOK_CHUNK", 16)
    y1, aux1, want, want_aux = _both(m, rp, pp, x)
    np.testing.assert_allclose(y1.numpy(), want, **OUT)
    assert float(aux1) == pytest.approx(want_aux, rel=1e-6)
    monkeypatch.setattr(PM, "TOK_CHUNK", 4096)
    y2, _ = PM.moe_layer(pp, m, torch.as_tensor(x))
    # chunked capacity is per-chunk; with ample cf results are identical
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **OUT)


@pytest.mark.parametrize("chunk", [1, 9, 33, 64, 512, 1024])
def test_capacity_is_lane_aligned(chunk):
    """`_capacity` is a multiple of 8, at least 8 and the reference's,
    for kimi's 384 experts top-8 and the reduced and full granite and
    jamba routers."""
    for m in (MoECfg(num_experts=384, top_k=8, d_ff_expert=16),
              MoECfg(num_experts=32, top_k=8, d_ff_expert=16),
              MoECfg(num_experts=16, top_k=2, d_ff_expert=16),
              MoECfg(num_experts=4, top_k=2, d_ff_expert=16)):
        c = PM._capacity(chunk, m)
        assert c % 8 == 0 and c >= max(8, chunk * m.top_k * 1.25
                                       / m.num_experts)
        assert c == RM._capacity(chunk, RMoECfg(**dataclasses.asdict(m)))


def test_token_dropped_at_rank_equal_to_capacity():
    """Nine tokens all routed to expert 0 (top-1; capacity C = 8 at a
    9-token shot): ranks 0..7 are kept and the ninth token, at rank == C,
    drops — its output row is exactly zero, as the reference's all-zero
    one-hot row gives (``F.one_hot`` would raise there)."""
    m = MoECfg(num_experts=4, top_k=1, d_ff_expert=16)
    assert PM._capacity(9, m) == 8
    rp, pp = _params(m, 8, 5)
    router = np.zeros((8, 4), np.float32)
    router[0, 0] = 50.0
    rp = dict(rp, router=jnp.asarray(router))
    pp = dict(pp, router=torch.as_tensor(router))
    x = _x((1, 9, 8), 6)
    x[..., 0] = np.abs(x[..., 0]) + 1.0      # every token to expert 0
    got, _, want, _ = _both(m, rp, pp, x)
    assert bool((got[0, 8] == 0).all()) and bool((got[0, :8] != 0).any(-1)
                                                 .all())
    np.testing.assert_allclose(got.numpy(), want, **OUT)


def _layer_cfg(arch):
    cfg = ref_reduced(arch)
    return cfg.d_model, MoECfg(**dataclasses.asdict(cfg.moe))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b"])
def test_routing_matches_reference(arch):
    """The router's top-k experts equal the reference's and their gates
    agree to 1e-6 relative; no k-th / (k+1)-th probability pair is within
    1e-6 (no tie to break)."""
    d, m = _layer_cfg(arch)
    rp, pp = _params(m, d, 7)
    x = _x((2, 64, d), 8)
    probs = jax.nn.softmax(jnp.asarray(x) @ rp["router"], -1)
    rgate, ridx = jax.lax.top_k(probs, m.top_k + 1)
    rgate = np.asarray(rgate)
    assert (rgate[..., m.top_k - 1] - rgate[..., m.top_k]).min() > 1e-6
    pprobs = torch.softmax(torch.as_tensor(x) @ pp["router"], -1)
    gate, idx = torch.topk(pprobs, m.top_k, dim=-1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx)[..., :-1])
    np.testing.assert_allclose(gate.numpy(), rgate[..., :-1], rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b",
                                  "jamba-v0.1-52b"])
def test_layer_and_gradients_match_reference(arch, monkeypatch):
    """The layer at a reduced model's geometry over 64 tokens in chunks
    of 16 (the chunked path, capacity `_capacity(16)`): outputs, aux, and
    the gradients of sum(y · w) + aux in x and every parameter."""
    d, m = _layer_cfg(arch)
    rp, pp = _params(m, d, 9)
    x = _x((2, 64, d), 10)
    w = _x((2, 64, d), 11)
    for mod in (RM, PM):
        monkeypatch.setattr(mod, "TOK_CHUNK", 16)
    rm = RMoECfg(**dataclasses.asdict(m))

    def rloss(p, x):
        y, aux = RM.moe_layer(p, rm, x)
        return jnp.sum(y * w) + aux
    want, (rg, rgx) = jax.value_and_grad(rloss, argnums=(0, 1))(
        rp, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    live = [v.requires_grad_() for v in adamw.tree_leaves(pp)]
    y, aux = PM.moe_layer(pp, m, xt)
    got = torch.sum(y * torch.as_tensor(w)) + aux
    grads = torch.autograd.grad(got, [xt] + live)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for g, r in zip(grads, [rgx] + jax.tree.leaves(rg)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()


def test_bf16_layer_matches_reference():
    """The granite-reduced layer in bf16 (dispatch one-hot and combine
    weights in x's dtype): the dtypes, and the output within 0.1 of its
    RMS of the reference's."""
    d, m = _layer_cfg("granite-moe-1b-a400m")
    rp, pp = _params(m, d, 12, jnp.bfloat16)
    x = jnp.asarray(_x((2, 32, d), 13), jnp.bfloat16)
    want, _ = RM.moe_layer(rp, RMoECfg(**dataclasses.asdict(m)), x)
    xt = torch.as_tensor(np.asarray(x, np.float32)).bfloat16()
    got, aux = PM.moe_layer(pp, m, xt)
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    want = np.asarray(want, np.float32)
    rms = float(np.sqrt(np.mean(want ** 2)))
    assert float(np.abs(got.float().numpy() - want).max()) <= 0.1 * rms


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = lm_state(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("hw", [False, True], ids=["plain", "hw_sigma0"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_loss_and_gradients_match_reference(arch, hw, models):
    """Reduced granite (4 MoE layers) and kimi (the dense prefix, one MoE
    layer with a shared expert): `Model.loss` — cross-entropy plus 0.01 ·
    aux — and every gradient; the hardware-aware loss at sigma 0."""
    assert_loss_and_grads_match(models(arch), hw)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"])
def test_hw_transform_quantizes_the_reference_leaves(arch, models):
    """The hardware-aware transform quantizes the same leaves, the MoE
    router and the stacked experts among them, bit for bit."""
    chosen = assert_hw_transform_matches(models(arch))
    assert any(k.endswith("['moe']['router']") for k in chosen)
    assert any(k.endswith("['moe']['we_gate']") for k in chosen)
