"""The port's flash forward (`repro_torch.models.flash`) against the
reference's (`repro.models.flash.flash_attention`) and against a direct
softmax, float32, with small chunks in both modules (Q_CHUNK 32, KV_CHUNK
16, as `tests/test_flash.py` sets them) so that at S = 128 the triangular
schedule skips KV chunks and the windows' ranges are aligned to chunks.
Tolerance 1e-5 absolute (outputs are O(1))."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.flash as RF
from repro_torch.models import flash as PF

ATOL = 1e-5


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    for mod in (RF, PF):
        monkeypatch.setattr(mod, "Q_CHUNK", 32)
        monkeypatch.setattr(mod, "KV_CHUNK", 16)


def direct(q, k, v, KV, scale, softcap=None, causal=True, window=None):
    """Direct softmax attention in float64 (the oracle)."""
    B, Sq, H, hd = q.shape
    qg = q.reshape(B, Sq, KV, H // KV, hd).astype(np.float64)
    s = np.einsum("bqkgh,bskh->bkgqs", qg, k.astype(np.float64)) * scale
    if softcap:
        s = softcap * np.tanh(s / softcap)
    d = np.arange(Sq)[:, None] - np.arange(k.shape[1])[None, :]
    ok = np.ones(d.shape, bool)
    if causal:
        ok &= d >= 0
    if window:
        ok &= d < window
    s = np.where(ok, s, -2e38)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgqs,bskh->bqkgh", p, v).reshape(B, Sq, H, hd)


def _inputs(seed, B=2, S=128, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, n, hd)).astype(np.float32)
            for n in (H, KV, KV)]


CASES = [(cap, win, causal) for cap, win, causal in itertools.product(
    (None, 30.0, 50.0), (None, 32, 48), (True, False))]


@pytest.mark.parametrize("softcap,window,causal", CASES)
def test_flash_forward_matches_reference_and_direct(softcap, window,
                                                    causal):
    q, k, v = _inputs(0)
    kw = dict(num_kv_heads=2, scale=1 / np.sqrt(16), softcap=softcap,
              causal=causal, window=window)
    got = PF.flash_attention(*map(torch.as_tensor, (q, k, v)), **kw).numpy()
    want = np.asarray(RF.flash_attention(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, direct(q, k, v, 2, kw["scale"], softcap,
                                           causal, window),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("S,G,hd", [(32, 1, 8), (96, 2, 16), (160, 4, 8)])
def test_flash_shapes_and_gqa(S, G, hd):
    q, k, v = _inputs(S, B=1, S=S, H=2 * G, KV=2, hd=hd)
    kw = dict(num_kv_heads=2, scale=0.25, causal=True, window=40)
    got = PF.flash_attention(*map(torch.as_tensor, (q, k, v)), **kw).numpy()
    want = np.asarray(RF.flash_attention(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_pick_chunk_and_masked_blocks_stay_finite():
    """`_pick_chunk` is the largest divisor below the target; a window
    that masks a q-row's whole first KV chunk leaves no NaN (the finite
    NEG_INF's uniform row is cleared by the next chunk's correction)."""
    for size, target in ((1500, 512), (128, 16), (7, 16), (96, 32)):
        assert PF._pick_chunk(size, target) == RF._pick_chunk(size, target)
    q, k, v = _inputs(1)
    kw = dict(num_kv_heads=2, scale=0.25, causal=True, window=20)
    got = PF.flash_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), direct(q, k, v, 2, 0.25, None,
                                                   True, 20), atol=ATOL)


def test_bf16_inputs_accumulate_in_float32():
    """bf16 q/k/v: scores and the PV product accumulate in float32 (the
    reference's ``preferred_element_type``) and the output is bf16."""
    q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in _inputs(2))
    kw = dict(num_kv_heads=2, scale=0.25, softcap=50.0, causal=True,
              window=48)
    got = PF.flash_attention(*(torch.as_tensor(a).bfloat16()
                               for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    want = RF.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2 ** -7, rtol=2 ** -7)
