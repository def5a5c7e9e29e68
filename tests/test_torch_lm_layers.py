"""The port's LM building blocks (`repro_torch.models.layers`) against the
reference's (`repro.models.layers`) on the same numpy inputs, float32:
norms, RoPE / M-RoPE, the gated MLP with either activation, the scaled
embedding (its scale rounded to the parameter dtype first) and the
softcapped unembedding agree to 1e-6 relative (last-ulp gaps of the
float32 ``pow`` / ``sin`` / ``tanh``, ROADMAP Queue 3 item 1).
`dense_init` is equal in distribution only and is held by its moments."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_reduced_config as ref_reduced
from repro.models import layers as R
from repro_torch import convert
from repro_torch.configs.registry import get_reduced_config
from repro_torch.models import layers as P

RTOL, ATOL = 1e-6, 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rms_norm_is_gemmas_form(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    _close(P.rms_norm(_t(x), _t(scale), 1e-6),
           R.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    # bf16 in, bf16 out, float32 inside
    xb = jnp.asarray(x, jnp.bfloat16)
    out = P.rms_norm(_t(np.asarray(xb, np.float32)).bfloat16(), _t(scale),
                     1e-6)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        out.float().numpy(),
        np.asarray(R.rms_norm(xb, jnp.asarray(scale), 1e-6), np.float32),
        rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_rotates_split_halves(rng, theta):
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    _close(P.rope_freqs(32, theta), R.rope_freqs(32, theta))
    _close(P.apply_rope(_t(x), _t(pos), theta),
           R.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           atol=1e-5, rtol=1e-5)


def test_apply_mrope_matches_reference(rng):
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos3 = rng.integers(0, 50, size=(3, 2, 7)).astype(np.int32)
    _close(P.apply_mrope(_t(x), _t(pos3), 10000.0, (4, 6, 6)),
           R.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 10000.0,
                         (4, 6, 6)), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        P.apply_mrope(_t(x), _t(pos3), 10000.0, (4, 6, 4))


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_activation(rng, act):
    """gemma's activation is ``jax.nn.gelu``, whose default is the tanh
    approximation: the port's `gelu_tanh`, not ``F.gelu``'s erf."""
    params = {k: rng.normal(size=s).astype(np.float32) / 8 for k, s in
              (("w_gate", (64, 96)), ("w_up", (64, 96)),
               ("w_down", (96, 64)))}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    ref_act, port_act = {"gelu": (jax.nn.gelu, P.gelu_tanh),
                         "silu": (jax.nn.silu, F.silu)}[act]
    want = R.mlp({k: jnp.asarray(v) for k, v in params.items()},
                 jnp.asarray(x), act=ref_act)
    got = P.mlp({k: _t(v) for k, v in params.items()}, _t(x), act=port_act)
    _close(got, want, rtol=1e-5, atol=1e-5)
    if act == "gelu":
        erf = P.mlp({k: _t(v) for k, v in params.items()}, _t(x), act=F.gelu)
        assert np.abs(erf.numpy() - np.asarray(want)).max() > 1e-4


@pytest.mark.parametrize("d_model,scale", [(2304, 48.0), (3584, 59.75)])
def test_embed_scale_rounds_to_bf16_first(rng, d_model, scale):
    """gemma2-2b's sqrt(2304) = 48 is exact in bf16; gemma2-9b's
    sqrt(3584) = 59.87 rounds to 59.75 before it multiplies."""
    cfg = dataclasses.replace(get_reduced_config("gemma2-9b"),
                              d_model=d_model, dtype="bfloat16")
    rcfg = dataclasses.replace(ref_reduced("gemma2-9b"), d_model=d_model,
                               dtype="bfloat16")
    table_np = rng.normal(size=(16, d_model))
    table_np[0, 0] = 1.0
    table = jnp.asarray(table_np, jnp.bfloat16)
    toks = np.array([[0, 3, 15], [7, 7, 1]], np.int32)
    want = R.embed_tokens(rcfg, table, jnp.asarray(toks))
    got = P.embed_tokens(cfg, convert.lm_tree_from_numpy(
        {"t": np.asarray(table)}, "cpu")["t"], _t(toks).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert got[0, 0, 0].item() == scale == float(
        jnp.asarray(np.sqrt(d_model), jnp.bfloat16))
    f32 = dataclasses.replace(cfg, dtype="float32")
    x = P.embed_tokens(f32, _t(np.asarray(table, np.float32)), _t(toks).long())
    np.testing.assert_allclose(
        x.numpy(), np.asarray(table, np.float32)[toks] * np.float32(
            math.sqrt(d_model)), rtol=1e-6)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-67b"])
def test_unembed_tied_and_softcapped(rng, arch):
    """gemma2: tied embeddings, final softcap 30; deepseek: an untied
    ``lm_head`` and no softcap."""
    cfg, rcfg = get_reduced_config(arch), ref_reduced(arch)
    params = {"tok_embed": rng.normal(size=(512, 128)).astype(np.float32),
              "lm_head": rng.normal(size=(128, 512)).astype(np.float32)}
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    want = R.unembed(rcfg, {k: jnp.asarray(v) for k, v in params.items()},
                     jnp.asarray(x))
    got = P.unembed(cfg, {k: _t(v) for k, v in params.items()}, _t(x))
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-5, atol=1e-5)
    if cfg.final_softcap is not None:
        assert got.abs().max() < cfg.final_softcap
        raw = _t(x) @ _t(params["tok_embed"]).T
        assert raw.abs().max() > cfg.final_softcap
    _close(P.softcap(_t(x), None), x, rtol=0, atol=0)


@pytest.mark.parametrize("shape,in_axis,lead", [
    ((256, 128), 0, ()), ((128, 4, 32), 0, (3,)), ((4, 32, 128), 1, (2,))])
def test_dense_init_moments(shape, in_axis, lead):
    """A truncated normal on [-2, 2] times 1/sqrt(fan_in), fan_in the
    product of the dims up to ``in_axis`` (``wo``: heads x head_dim): the
    reference's draw in distribution (its variance 0.7737 / fan_in)."""
    gen = torch.Generator().manual_seed(0)
    w = P.dense_init(gen, shape, in_axis, torch.float32, lead).numpy()
    ref = np.asarray(R.dense_init(jax.random.PRNGKey(0), shape, in_axis))
    assert w.shape == tuple(lead) + tuple(shape)
    fan_in = math.prod(shape[:in_axis + 1])
    bound = 2.0 / math.sqrt(fan_in)
    for a in (w, ref):
        assert np.abs(a).max() <= bound * (1 + 1e-6)
        assert abs(a.mean()) < 0.02 / math.sqrt(fan_in)
        np.testing.assert_allclose(a.std() * math.sqrt(fan_in),
                                   math.sqrt(0.77374), rtol=0.02)
    # independent draws per stacked group, different generators differ
    if lead:
        assert not np.array_equal(w[0], w[1])
    w2 = P.dense_init(torch.Generator().manual_seed(1), shape, in_axis)
    assert not np.array_equal(w2.numpy(), w.reshape(w2.shape) if not lead
                              else w[0])
    assert P.dense_init(gen, shape, in_axis, torch.bfloat16).dtype == \
        torch.bfloat16


def test_bf16_leaves_cross_through_float32_exactly(rng):
    a = jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)
    tree = jax.tree.map(np.asarray, {"a": a, "b": [jnp.arange(3)],
                                     "c": {"d": jnp.ones(2, jnp.float32)}})
    got = convert.lm_tree_from_numpy(tree, "cpu")
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"].float().numpy(),
                                  np.asarray(a, np.float32))
    assert got["b"][0].dtype == torch.int32
    assert got["c"]["d"].dtype == torch.float32
    cache = convert.lm_tree_from_numpy({"blocks": {"layer_0": {
        "k": np.asarray(a)[None], "v": np.asarray(a)[None]}}}, "cpu")
    assert cache["blocks"]["layer_0"]["k"].shape == (1, 3, 5)
