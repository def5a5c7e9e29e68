"""The port's Whisper encoder-decoder (`repro_torch.models.whisper`, the
cross path of `repro_torch.models.attention`) against the reference's,
at the reference's reduced whisper-tiny (d_model 128, 2 encoder and 4
decoder layers, enc_seq 16, vocab 512; float32), the reference's
parameters carried across by `repro_torch.convert`
(`tests/_torch_port.py::lm_state`), the same batch: `encode`, the
teacher-forced `forward`, `cross_kv`, the cross-attention paths, decode
against a cache whose cross entries `cross_kv` fills, `Model.loss` and
its gradients, the hardware-aware loss, the parameter tree.

Tolerances, float32: logits 1e-4 absolute and relative, encoder outputs
and K/V 1e-5 (as `test_torch_lm.py`; measured ~1e-6, summation order);
the loss 1e-5 relative, each gradient leaf 1e-4 of its max |g|.  Decode
continues the teacher-forced forward position by position to 3e-2, the
reference's rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import repro.models.whisper as RW
import repro_torch.models.attention as PA
import repro_torch.models.whisper as PW
from _torch_port import (assert_hw_transform_matches,
                         assert_lm_tree_close, assert_loss_and_grads_match,
                         flat_tree, lm_state, ref_flat_tree)
from repro_torch.configs.registry import get_reduced_config
from repro_torch.models.model import build_model

ARCH = "whisper-tiny"
LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def wh():
    return lm_state(ARCH)


def _fe(state):
    return state[5]["frontend_embeds"], state[6]["frontend_embeds"]


def test_encode_matches_reference(wh):
    """The bidirectional encoder over enc_seq frames with learned
    positions."""
    cfg, rcfg, _, rparams, pparams, _, _ = wh
    rfe, pfe = _fe(wh)
    want = RW.encode(rparams, rcfg, rfe)
    got = PW.encode(pparams, cfg, pfe)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHE)


def test_forward_matches_reference(wh):
    cfg, rcfg, _, rparams, pparams, batch, pbatch = wh
    want, _ = RW.forward(rparams, rcfg, batch["tokens"],
                         batch["frontend_embeds"])
    got, aux = PW.forward(pparams, cfg, pbatch["tokens"],
                          pbatch["frontend_embeds"])
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_decode_wraps_positions_past_the_table(wh):
    """Learned positions index ``pos % 4096``: a decode step at position
    4097 (a 4100-slot self cache, its cross entries `cross_kv`'s) reads
    position 1 of the table, as the reference's does."""
    cfg, rcfg, rmodel, rparams, pparams, batch, pbatch = wh
    model, rcache, pcache = _caches(wh, 4100)
    want, _ = rmodel.decode_step(rparams, batch["tokens"][:, :1],
                                 jnp.int32(4097), rcache)
    got, _ = model.decode_step(pparams, pbatch["tokens"][:, :1], 4097,
                               pcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


def test_cross_attention_matches_reference(wh):
    """`cross_kv` of the encoder output and `attention(kv=...)` (queries
    only, never causal) for decoder layer 0's cross-attention."""
    cfg, rcfg, _, rparams, pparams, _, _ = wh
    rfe, pfe = _fe(wh)
    renc, penc = RW.encode(rparams, rcfg, rfe), PW.encode(pparams, cfg, pfe)
    rp, pp = rparams["decoder"][0]["xattn"], pparams["decoder"][0]["xattn"]
    rk, rv = RA.cross_kv(rp, rcfg, renc)
    pk, pv = PA.cross_kv(pp, cfg, penc)
    np.testing.assert_allclose(pk.numpy(), np.asarray(rk), **CACHE)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), **CACHE)
    x = np.random.default_rng(1).normal(size=(2, 10, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    want, _ = RA.attention(rp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                           kv=(rk, rv))
    got, _ = PA.attention(pp, cfg, torch.as_tensor(x),
                          torch.as_tensor(pos.copy()), kv=(pk, pv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHE)
    # never causal: the first query sees every frame
    causal, _ = PA.attention(pp, cfg, torch.as_tensor(x),
                             torch.as_tensor(pos.copy()), causal=True,
                             kv=(pk, pv))
    assert torch.equal(causal, got)


def _caches(wh, max_seq):
    """The reference's and the port's decode caches with the cross entries
    filled by `cross_kv` of the encoder output."""
    cfg, rcfg, rmodel, rparams, pparams, _, _ = wh
    rfe, pfe = _fe(wh)
    renc, penc = RW.encode(rparams, rcfg, rfe), PW.encode(pparams, cfg, pfe)
    rcache = rmodel.init_cache(2, max_seq)
    rcache["cross"] = [dict(zip(("k", "v"), RA.cross_kv(p["xattn"], rcfg,
                                                          renc)))
                       for p in rparams["decoder"]]
    model = build_model(cfg, device="cpu")
    pcache = model.init_cache(2, max_seq)
    for p, cx in zip(pparams["decoder"], pcache["cross"]):
        k, v = PA.cross_kv(p["xattn"], cfg, penc)
        cx["k"].copy_(k)
        cx["v"].copy_(v)
    return model, rcache, pcache


def test_decode_matches_reference_and_continues_forward(wh):
    """Eight decode steps from position 0 against the cross cache: each
    step's logits and the whole cache (``self`` written in place,
    ``cross`` unchanged) equal the reference's, and each step continues
    the teacher-forced forward at its position."""
    cfg, rcfg, rmodel, rparams, pparams, batch, pbatch = wh
    model, rcache, pcache = _caches(wh, 16)
    cross_before = [v.clone() for cx in pcache["cross"] for v in cx.values()]
    fwd, _ = PW.forward(pparams, cfg, pbatch["tokens"][:, :8],
                        pbatch["frontend_embeds"])
    toks = batch["tokens"]
    for pos in range(8):
        want, rcache = rmodel.decode_step(rparams, toks[:, pos:pos + 1],
                                          jnp.int32(pos), rcache)
        got, out = model.decode_step(pparams, pbatch["tokens"][:, pos:pos + 1],
                                     pos, pcache)
        assert out is pcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
        np.testing.assert_allclose(got[:, 0].numpy(), fwd[:, pos].numpy(),
                                   rtol=3e-2, atol=3e-2)
    assert_lm_tree_close(pcache, rcache, **CACHE)
    after = [v for cx in pcache["cross"] for v in cx.values()]
    assert all(torch.equal(a, b) for a, b in zip(after, cross_before))


def test_cross_decode_attention_writes_nothing(wh):
    """`decode_attention(cross=True)`: the cache is read, not written, and
    every frame is attended (equal to the reference's)."""
    cfg, rcfg, _, rparams, pparams, _, _ = wh
    rng = np.random.default_rng(2)
    ck, cv = (rng.normal(size=(2, 16, cfg.num_kv_heads, cfg.hd())).astype(
        np.float32) for _ in range(2))
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    rp, pp = rparams["decoder"][1]["xattn"], pparams["decoder"][1]["xattn"]
    want, _, _ = RA.decode_attention(rp, rcfg, jnp.asarray(x),
                                     jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.int32(3), cross=True)
    pk, pv = torch.as_tensor(ck), torch.as_tensor(cv)
    got, k2, v2 = PA.decode_attention(pp, cfg, torch.as_tensor(x), pk, pv, 3,
                                      cross=True)
    assert torch.equal(k2, torch.as_tensor(ck))
    assert torch.equal(v2, torch.as_tensor(cv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CACHE)


def test_init_draws_the_reference_tree(wh):
    """`build_model(cfg).init(seed)`: the reference's tree — ``encoder``
    and ``decoder`` lists of per-layer dicts, not stacked — with its
    shapes and dtypes, zero norms."""
    rparams = wh[3]
    params = build_model(get_reduced_config(ARCH), device="cpu").init(0)
    got, want = flat_tree(params), ref_flat_tree(rparams)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    assert isinstance(params["encoder"], list) and \
        len(params["decoder"]) == get_reduced_config(ARCH).num_layers
    assert not any(v.any() for k, v in got.items() if "norm" in k)


def test_init_cache_shapes(wh):
    cfg, rcfg, rmodel = wh[0], wh[1], wh[2]
    rcache = rmodel.init_cache(3, 24)
    pcache = build_model(cfg, device="cpu").init_cache(3, 24)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in flat_tree(pcache).items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref_flat_tree(rcache).items()}


@pytest.mark.parametrize("hw", [False, True], ids=["plain", "hw_sigma0"])
def test_loss_and_gradients_match_reference(wh, hw):
    """`Model.loss` (the full cross-entropy of the teacher-forced logits)
    and every gradient; the hardware-aware loss at sigma 0."""
    assert_loss_and_grads_match(wh, hw)


def test_hw_transform_quantizes_the_reference_leaves(wh):
    """The same leaves, bit for bit; the three embedding tables
    (``tok_embed``, ``pos_embed``, ``enc_pos_embed``) stay."""
    chosen = assert_hw_transform_matches(wh)
    assert any(k.startswith("['encoder'][0]") for k in chosen)
    assert any(k.endswith("['xattn']['wq']") for k in chosen)
