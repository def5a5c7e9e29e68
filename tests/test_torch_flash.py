"""The port's flash attention (`repro_torch.models.flash`) against the
reference's (`repro.models.flash.flash_attention`) and against a direct
softmax, float32, with small chunks in both modules (Q_CHUNK 32, KV_CHUNK
16, as `tests/test_flash.py` sets them) so that at S = 128 the triangular
schedule skips KV chunks and the windows' ranges are aligned to chunks.
Tolerance 1e-5 absolute on the forward (outputs are O(1)); the backward's
dq, dk, dv 2e-5 absolute against the reference's ``jax.grad`` and against
the port's direct attention under autograd (`tests/test_flash.py`'s rule).
bf16: at most 1 % of the gradients' entries differ from the reference's,
each by at most two bf16 ulps of the larger of the entry and the
gradient's RMS (2^-6 (|ref| + rms(ref))): the two packages add the
overlapping q-chunks' bf16 dk / dv contributions in their own order."""
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.flash as RF
from repro_torch.models import attention as PA
from repro_torch.models import flash as PF

ATOL = 1e-5
GRAD_ATOL = 2e-5


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


def _port_direct(q, k, v, KV, scale, softcap, window):
    """The port's direct attention (`attention._attend_direct`), causal."""
    cfg = types.SimpleNamespace(num_kv_heads=KV, attn_softcap=softcap)
    pos = torch.arange(q.shape[1])
    return PA._attend_direct(q, k, v, cfg, scale, pos, pos, True, window)


@pytest.mark.parametrize("softcap,window", [
    (None, None), (30.0, None), (None, 48), (50.0, 32),
    (None, 20)])   # window 20: whole KV chunks of a q-row masked
def test_flash_backward_matches_reference_and_direct(softcap, window):
    """`tests/test_flash.py::test_flash_fwd_bwd_vs_direct` on the port:
    the gradient of 0.01 * sum(out) through the custom backward."""
    q, k, v = _inputs(0)
    scale = 1 / np.sqrt(16)
    kw = dict(num_kv_heads=2, scale=scale, softcap=softcap, causal=True,
              window=window)
    f = lambda *a: RF.flash_attention(*a, **kw).sum() * 0.01  # noqa: E731
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(PF.flash_attention(*t, **kw).sum() * 0.01, t)
    direct_g = torch.autograd.grad(
        _port_direct(*t, 2, scale, softcap, window).sum() * 0.01, t)
    for name, a, w, d in zip("qkv", got, want, direct_g):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(a.numpy(), d.numpy(), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_fully_masked_kv_chunks_give_finite_gradients():
    """A causal window of 1 keeps only the diagonal: in every KV chunk a
    q-chunk visits but the diagonal one, every score is the finite
    `NEG_INF`.  The gradients are finite and equal the direct path's:
    each softmax row is one-hot, so dq and dk vanish (to rounding) and dv
    is the cotangent summed over the query group."""
    q, k, v = _inputs(4)
    kw = dict(num_kv_heads=2, scale=0.25, softcap=None, causal=True,
              window=1)
    t = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(PF.flash_attention(*t, **kw).sum(), t)
    direct_g = torch.autograd.grad(
        _port_direct(*t, 2, 0.25, None, 1).sum(), t)
    for name, a, d in zip("qkv", got, direct_g):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), d.numpy(), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)
    assert max(got[0].abs().max(), got[1].abs().max()) < GRAD_ATOL
    np.testing.assert_array_equal(got[2].numpy(), np.full(v.shape, 2.0))


def test_flash_backward_bf16():
    """bf16 q, k, v and cotangent: dq, dk, dv are bf16 and hold the
    module docstring's rule against the reference's VJP (measured: 0.06 %
    and 0.16 % of dq's and dk's entries one ulp apart, dv equal)."""
    rng = np.random.default_rng(3)
    q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in _inputs(3) + [rng.normal(size=(2, 128, 4, 16))])
    kw = dict(num_kv_heads=2, scale=0.25, softcap=50.0, causal=True,
              window=48)
    _, vjp = jax.vjp(lambda *a: RF.flash_attention(*a, **kw),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    t = [torch.as_tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(PF.flash_attention(*t, **kw), t,
                              torch.as_tensor(do).bfloat16())
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, name
        a, w = a.float().numpy(), np.asarray(w, np.float32)
        rms = np.sqrt(np.mean(w ** 2))
        gap = np.abs(a - w)
        assert (gap <= 2 ** -6 * (np.abs(w) + rms)).all(), name
        assert (gap > 0).mean() <= 0.01, name
