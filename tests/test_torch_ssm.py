"""The port's Mamba and RWKV-6 blocks (`repro_torch.models.mamba`,
`repro_torch.models.rwkv`) against the reference's: each of
`tests/test_ssm_blocks.py`'s five tests on the port (the selective
scan's custom backward, Mamba chunked == unchunked and decode == prefix,
WKV chunked vs stepwise, the channel-mix state), each also held against
the reference on the same inputs (the reference's parameters carried
across by `repro_torch.convert`, inputs from a numpy seed); the causal
conv in bf16; and the whole reduced jamba and rwkv6 models' losses and
gradients, plainly and hardware-aware.

Tolerances: the reference test's own on the port's invariants (1e-5 for
the scan, 1e-4 for Mamba, 2e-3 for the stepwise WKV, whose chunk-of-1
path clamps 1/W at e^30 differently); against the reference in float32,
outputs and states to 1e-5 of their max |x| (measured <= 2e-6: the
scan's association — the port's log-depth sweep pairs steps differently
from ``lax.associative_scan`` — and einsum summation order), gradients
to 1e-4 of the leaf's max |g| (as `test_torch_train.py`).  The
selective scan's backward against autograd through the scan: 1e-5 of
the max.  The causal conv in bf16 sums its taps from 0 in tap order, as
the reference does: equal bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as RMb
import repro.models.rwkv as RR
import repro_torch.models.mamba as M
import repro_torch.models.rwkv as R
from _torch_port import (assert_hw_transform_matches,
                         assert_loss_and_grads_match, lm_state)
from repro.configs.base import HybridCfg as RHybrid
from repro.configs.registry import get_reduced_config as ref_reduced
from repro_torch import convert
from repro_torch.configs.base import HybridCfg
from repro_torch.configs.registry import get_reduced_config

HC = HybridCfg(d_state=8, d_conv=4, expand=2)
RHC = RHybrid(d_state=8, d_conv=4, expand=2)


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


def _port(tree):
    return convert.lm_tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close_to_max(got, want, frac):
    want = np.asarray(want)
    gap = np.abs(np.asarray(got) - want).max()
    assert gap <= frac * max(np.abs(want).max(), 1e-30), gap


def _step_scan(a, bx, h0):
    """h_t = a_t h_{t-1} + bx_t one step at a time: the oracle."""
    h, out = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out.append(h)
    return torch.stack(out, 1), h


def test_selective_scan_custom_vjp():
    """The chunked scan (chunks of 4 here) equals the stepwise oracle and
    the reference's; its closed-form gradients equal autograd through the
    oracle and the reference's custom VJP."""
    rng = np.random.default_rng(0)
    B, S, D, N = 2, 16, 3, 4
    a = rng.uniform(0.3, 0.99, (B, S, D, N)).astype(np.float32)
    bx = rng.normal(size=(B, S, D, N)).astype(np.float32)
    h0 = rng.normal(size=(B, D, N)).astype(np.float32)
    w = rng.normal(size=(B, S, D, N)).astype(np.float32)
    ts = [torch.as_tensor(v).requires_grad_() for v in (a, bx, h0)]
    o1 = M._selective_scan(*ts)
    o2 = _step_scan(*ts)
    np.testing.assert_allclose(o1[0].detach().numpy(),
                               o2[0].detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(o1[1].detach().numpy(),
                               o2[1].detach().numpy(), atol=1e-5)
    g1 = torch.autograd.grad((o1[0] * torch.as_tensor(w)).sum(), ts)
    g2 = torch.autograd.grad((o2[0] * torch.as_tensor(w)).sum(), ts)
    for x, y in zip(g1, g2):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-4)
    want = RMb._selective_scan(*(jnp.asarray(v) for v in (a, bx, h0)))
    _close_to_max(o1[0].detach(), want[0], 1e-5)
    rg = jax.grad(lambda *z: (RMb._selective_scan(*z)[0] * w).sum(),
                  argnums=(0, 1, 2))(*(jnp.asarray(v) for v in (a, bx, h0)))
    for x, y in zip(g1, rg):
        _close_to_max(x, y, 1e-5)


def test_selective_scan_final_state_gradient(monkeypatch):
    """A loss on h_T alone and one on every h_t, over several scan chunks
    (`CHUNK` 4): the closed form equals autograd through the stepwise
    oracle."""
    monkeypatch.setattr(M, "CHUNK", 4)
    rng = np.random.default_rng(1)
    B, S, D, N = 1, 12, 2, 3
    a = rng.uniform(0.5, 1.0, (B, S, D, N)).astype(np.float32)
    bx = rng.normal(size=(B, S, D, N)).astype(np.float32)
    h0 = rng.normal(size=(B, D, N)).astype(np.float32)
    wf = torch.as_tensor(rng.normal(size=(B, D, N)).astype(np.float32))
    wa = torch.as_tensor(rng.normal(size=(B, S, D, N)).astype(np.float32))
    ts = [torch.as_tensor(v).requires_grad_() for v in (a, bx, h0)]

    def loss(out):
        return (out[1] * wf).sum() + (out[0] * wa).sum()
    g1 = torch.autograd.grad(loss(M._selective_scan(*ts)), ts)
    g2 = torch.autograd.grad(loss(_step_scan(*ts)), ts)
    for x, y in zip(g1, g2):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def mamba():
    """The reference's `init_mamba` at d_model 32: (ref, port) params."""
    rp = RMb.init_mamba(jax.random.PRNGKey(0), 32, RHC, jnp.float32)
    return rp, _port(rp)


def test_mamba_chunked_equals_unchunked(mamba, monkeypatch):
    rp, pp = mamba
    x = _np((2, 64, 32), 1)
    for mod in (RMb, M):
        monkeypatch.setattr(mod, "SEQ_CHUNK", 16)  # force chunked path
    y1, _ = M.mamba_forward(pp, HC, torch.as_tensor(x))
    want, _ = RMb.mamba_forward(rp, RHC, jnp.asarray(x))
    _close_to_max(y1, want, 1e-5)
    monkeypatch.setattr(M, "SEQ_CHUNK", 4096)  # single shot
    y2, _ = M.mamba_forward(pp, HC, torch.as_tensor(x))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-4)


def test_mamba_chunked_gradients_match_reference(mamba, monkeypatch):
    """Through the chunked path (4 sequence chunks, each recomputed in
    backward by `torch.utils.checkpoint`, and 2 scan chunks each): the
    gradients in x and every parameter against the reference's."""
    rp, pp = mamba
    x = _np((2, 64, 32), 2)
    w = _np((2, 64, 32), 3)
    for mod in (RMb, M):
        monkeypatch.setattr(mod, "SEQ_CHUNK", 16)
        monkeypatch.setattr(mod, "CHUNK", 8)
    rg = jax.grad(lambda p, x: (RMb.mamba_forward(p, RHC, x)[0] * w).sum(),
                  argnums=(0, 1))(rp, jnp.asarray(x))
    keys = sorted(pp)
    live = [pp[k].detach().requires_grad_() for k in keys]
    xt = torch.as_tensor(x).requires_grad_()
    y, _ = M.mamba_forward(dict(zip(keys, live)), HC, xt)
    grads = torch.autograd.grad((y * torch.as_tensor(w)).sum(), [xt] + live)
    for g, r in zip(grads, [rg[1]] + [rg[0][k] for k in keys]):
        _close_to_max(g, r, 1e-4)


def test_mamba_decode_matches_prefix(mamba):
    """Step-by-step decode with carried state == full-sequence forward,
    and the carried state == the reference's."""
    rp, pp = mamba
    x = _np((2, 12, 32), 1)
    y_full, _ = M.mamba_forward(pp, HC, torch.as_tensor(x))
    state = {"conv": torch.zeros((2, HC.d_conv - 1, 64)),
             "ssm": torch.zeros((2, 64, 8))}
    rstate = {"conv": jnp.zeros((2, HC.d_conv - 1, 64)),
              "ssm": jnp.zeros((2, 64, 8))}
    ys = []
    for t in range(12):
        y, state = M.mamba_forward(pp, HC, torch.as_tensor(x[:, t:t + 1]),
                                   state=state, return_state=True)
        _, rstate = RMb.mamba_forward(rp, RHC, jnp.asarray(x[:, t:t + 1]),
                                      state=rstate, return_state=True)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               atol=1e-4)
    for k in ("conv", "ssm"):
        _close_to_max(state[k], rstate[k], 1e-5)


def test_mamba_prefill_state_matches_reference(mamba):
    """A 24-token forward with ``return_state``: the output and the
    (conv, ssm) state against the reference's."""
    rp, pp = mamba
    x = _np((2, 24, 32), 4)
    y, st = M.mamba_forward(pp, HC, torch.as_tensor(x), return_state=True)
    want, rst = RMb.mamba_forward(rp, RHC, jnp.asarray(x), return_state=True)
    _close_to_max(y, want, 1e-5)
    assert st["conv"].dtype == st["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        _close_to_max(st[k], rst[k], 1e-5)


def test_causal_conv_bf16_matches_reference_bit_for_bit():
    """The depthwise conv's taps summed from 0 in tap order, then the
    bias: bf16 outputs equal the reference's bit for bit, with and
    without a carried state."""
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, 9, 16)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(16, 4)), jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(16,)), jnp.bfloat16)
    st = jnp.asarray(rng.normal(size=(2, 3, 16)), jnp.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    for state in (None, st):
        want, wst = RMb._causal_conv(x, w, b, state)
        got, gst = M._causal_conv(t(x), t(w), t(b),
                                  None if state is None else t(state))
        assert got.dtype == torch.bfloat16 and gst.dtype == torch.float32
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        np.testing.assert_array_equal(gst.numpy(), np.asarray(wst))


def test_scan_stays_finite_at_jamba_decay():
    """dt·A down to -1.6 a step (jamba's A <= 16, dt <= 0.1) over a
    128-step chunk: the log-depth sweep stays finite and equals the
    stepwise oracle (a closed form through exp(-cumsum(log a)) would
    overflow float32 here)."""
    rng = np.random.default_rng(6)
    a = np.exp(-rng.uniform(0.0, 1.6, (1, 256, 4, 16))).astype(np.float32)
    bx = rng.normal(size=(1, 256, 4, 16)).astype(np.float32)
    h0 = np.zeros((1, 4, 16), np.float32)
    got = M._selective_scan(*(torch.as_tensor(v) for v in (a, bx, h0)))
    want = _step_scan(*(torch.as_tensor(v) for v in (a, bx, h0)))
    assert bool(torch.isfinite(got[0]).all())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5)


def _rwkv_cfg():
    return ref_reduced("rwkv6-3b"), get_reduced_config("rwkv6-3b")


@pytest.fixture(scope="module")
def tmix():
    rcfg, _ = _rwkv_cfg()
    rp = RR.init_rwkv_tmix(jax.random.PRNGKey(0), rcfg, jnp.float32)
    return rp, _port(rp)


def test_wkv_chunked_vs_stepwise(tmix):
    """24 tokens in one call (chunks of 24) against 24 one-token calls
    carrying the state, on the port (the reference's rule), and the
    one-call output and state against the reference's."""
    rcfg, cfg = _rwkv_cfg()
    rp, pp = tmix
    x = _np((2, 24, cfg.d_model), 1, 0.5)
    y_full, st_full = R.rwkv_time_mix(pp, cfg, torch.as_tensor(x),
                                      return_state=True)
    state = {"shift": torch.zeros((2, cfg.d_model)),
             "wkv": torch.zeros((2, cfg.d_model // 64, 64, 64))}
    ys = []
    for t in range(24):
        y, state = R.rwkv_time_mix(pp, cfg, torch.as_tensor(x[:, t:t + 1]),
                                   state=state, return_state=True)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(state["wkv"].numpy(), st_full["wkv"].numpy(),
                               rtol=2e-3, atol=2e-3)
    want, rst = RR.rwkv_time_mix(rp, rcfg, jnp.asarray(x), return_state=True)
    _close_to_max(y_full, want, 1e-5)
    _close_to_max(st_full["wkv"], rst["wkv"], 1e-5)
    np.testing.assert_array_equal(st_full["shift"].numpy(),
                                  np.asarray(rst["shift"]))


@pytest.mark.parametrize("T", [1, 13, 64, 128, 96])
def test_wkv_chunk_lengths_match_reference(tmix, T):
    """Lengths whose chunk is 1 (decode; 13, prime), 64, two chunks of 64
    and three of 32 (96): output and state against the reference's,
    from a carried nonzero state."""
    rcfg, cfg = _rwkv_cfg()
    rp, pp = tmix
    H = cfg.d_model // 64
    x = _np((2, T, cfg.d_model), T, 0.5)
    st = {"shift": _np((2, cfg.d_model), 7), "wkv": _np((2, H, 64, 64), 8)}
    got, gst = R.rwkv_time_mix(
        pp, cfg, torch.as_tensor(x),
        state={k: torch.as_tensor(v) for k, v in st.items()},
        return_state=True)
    want, wst = RR.rwkv_time_mix(rp, rcfg, jnp.asarray(x),
                                 state={k: jnp.asarray(v)
                                        for k, v in st.items()},
                                 return_state=True)
    _close_to_max(got, want, 1e-5)
    _close_to_max(gst["wkv"], wst["wkv"], 1e-5)


def test_time_mix_gradients_match_reference(tmix):
    """Gradients of sum(y · w) through two WKV chunks (T = 128) in x and
    every time-mix parameter, against the reference's."""
    rcfg, cfg = _rwkv_cfg()
    rp, pp = tmix
    x = _np((1, 128, cfg.d_model), 9, 0.5)
    w = _np((1, 128, cfg.d_model), 10)
    rg = jax.grad(lambda p, x: (RR.rwkv_time_mix(p, rcfg, x)[0] * w).sum(),
                  argnums=(0, 1))(rp, jnp.asarray(x))
    keys = sorted(pp)
    live = [pp[k].detach().requires_grad_() for k in keys]
    xt = torch.as_tensor(x).requires_grad_()
    y, _ = R.rwkv_time_mix(dict(zip(keys, live)), cfg, xt)
    grads = torch.autograd.grad((y * torch.as_tensor(w)).sum(), [xt] + live)
    for g, r in zip(grads, [rg[1]] + [rg[0][k] for k in keys]):
        _close_to_max(g, r, 1e-4)


def test_group_norm_is_the_population_variance(tmix):
    """The per-head group norm divides by hd (``jnp.var``), not hd - 1:
    over one head's 64 channels the normalised output has variance 1
    under ``correction=0``."""
    _, cfg = _rwkv_cfg()
    y = torch.as_tensor(_np((1, 3, 2, 64), 11))
    var = y.var(-1, keepdim=True, correction=0)
    norm = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(var + 1e-5)
    assert float(norm.var(-1, correction=0).mean()) == pytest.approx(
        1.0, abs=1e-4)
    assert float(y.var(-1).mean()) > float(var.mean())


def test_channel_mix_state():
    rcfg, cfg = _rwkv_cfg()
    rp = RR.init_rwkv_cmix(jax.random.PRNGKey(0), rcfg, jnp.float32)
    pp = _port(rp)
    x = _np((2, 8, cfg.d_model), 1)
    y_full, last = R.rwkv_channel_mix(pp, cfg, torch.as_tensor(x),
                                      return_state=True)
    np.testing.assert_allclose(last.numpy(), x[:, -1], atol=1e-6)
    want, wlast = RR.rwkv_channel_mix(rp, rcfg, jnp.asarray(x),
                                      return_state=True)
    _close_to_max(y_full, want, 1e-5)
    np.testing.assert_array_equal(last.numpy(), np.asarray(wlast))
    # decode: the carried last input stands in for the shift
    y1, _ = R.rwkv_channel_mix(pp, cfg, torch.as_tensor(x[:, 5:6]),
                               state=torch.as_tensor(x[:, 4]))
    np.testing.assert_allclose(y1[:, 0].numpy(), y_full[:, 5].numpy(),
                               atol=1e-5)


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = lm_state(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("hw", [False, True], ids=["plain", "hw_sigma0"])
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_loss_and_gradients_match_reference(arch, hw, models):
    """Reduced jamba (7 Mamba layers through the custom backward, 1
    attention, 4 MoE) and rwkv6: `Model.loss` and every gradient; the
    hardware-aware loss at sigma 0."""
    assert_loss_and_grads_match(models(arch), hw)


@pytest.mark.parametrize("arch,leaves", [
    ("jamba-v0.1-52b", ("['mamba']['A_log']", "['moe']['router']")),
    ("rwkv6-3b", ("['tmix']['mu']", "['tmix']['decay_a']",
                  "['tmix']['decay_b']"))])
def test_hw_transform_quantizes_the_reference_leaves(arch, leaves, models):
    """The hardware-aware transform quantizes the same leaves, bit for
    bit: Mamba's float32 ``A_log``, RWKV's ``mu`` and decay matrices among
    them, and no embedding."""
    chosen = assert_hw_transform_matches(models(arch))
    for leaf in leaves:
        assert any(k.endswith(leaf) for k in chosen), leaf


def test_mamba_init_matches_the_reference_rules():
    """`init_mamba`'s deterministic leaves equal the reference's (A_log
    to an ulp of log, D_skip, conv_b) and ``dt_b`` lies in the
    reference's range log(expm1([1e-3, 1e-1]))."""
    rp = RMb.init_mamba(jax.random.PRNGKey(0), 32, RHC, jnp.float32)
    pp = M.init_mamba(torch.Generator().manual_seed(0), 32, HC,
                      torch.float32)
    assert set(pp) == set(rp)
    for k in rp:
        assert tuple(pp[k].shape) == rp[k].shape, k
    np.testing.assert_allclose(pp["A_log"].numpy(), np.asarray(rp["A_log"]),
                               rtol=1.2e-7, atol=0)
    for k in ("D_skip", "conv_b"):
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(rp[k]))
    lo, hi = np.log(np.expm1([1e-3, 1e-1]))
    dt_b = pp["dt_b"].numpy()
    assert lo - 1e-4 <= dt_b.min() and dt_b.max() <= hi + 1e-4
    assert dataclasses.asdict(HC) == dataclasses.asdict(RHC)
