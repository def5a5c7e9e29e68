"""The port's decoder-only LM (`repro_torch.models`, `launch.serve`)
against the reference's (`repro.models`, `repro.launch.serve`) for the five
dense architectures at reduced width (d_model 128, one period or 4
layers, vocab 512, window 64; float32), the reference's parameters
carried across by `repro_torch.convert`.

Tolerances, float32: logits 1e-4 absolute and relative (measured gaps
~4e-6: the two frameworks' matmul sums and ``tanh`` / ``rsqrt`` differ in
the last places), caches 1e-5; the reference's own invariants hold on the
port under the reference's rules (prefill == forward's last logits to
2e-3, decode continues prefill to 3e-2).

In bf16 (gemma2-2b reduced, the width the card runs in its dtype): each
attention path on the same inputs is held to two bf16 ulps (and one ulp
of the outputs' RMS, for outputs near 0), with at most
1 % of its outputs differing at all (measured: decode bit-equal, direct
0.1-0.3 % one ulp apart through the float32 softmax's last places).  The
whole model in bf16 is held to 0.1 of the logits' (or each cache leaf's)
RMS: the reference's bf16 ``jax.nn.gelu`` / ``silu`` round every step,
the port's ``F.gelu`` / ``F.silu`` once, so ~40 % of the activations
differ by an ulp and the gap compounds to ~0.05 of the RMS (measured).
A score product left unrounded, probabilities not cast to the value
dtype, a window or a decode position off by one, or a `build_model` that
drops ``hw_aware``, each fails these tests."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as RA
import repro.models.flash as RF
from repro.configs.base import ShapeCfg
from repro.configs.registry import get_reduced_config as ref_reduced
from repro.core import hwaware as RH
from repro.models import transformer as RT
from repro.models.model import build_model as ref_build
from repro.models.model import make_dummy_batch
from repro_torch import convert
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core import hwaware as PH
from repro_torch.launch import serve as lm_serve
from repro_torch.models import attention as PA
from repro_torch.models import flash as PF
from repro_torch.models import transformer as PT
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parent.parent
DENSE = ["gemma2-2b", "gemma2-9b", "deepseek-67b", "qwen1.5-110b",
         "qwen2-vl-72b"]
SHAPE = ShapeCfg("smoke", 64, 2, "train")
LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-5, atol=1e-5)
BF16_ATTN_RTOL = 2 ** -6      # two bf16 ulps, plus one at the RMS
BF16_ATTN_DIFFER = 0.01       # share of attention outputs that may differ
BF16_MODEL = 0.1              # max |port - ref| over the reference's RMS


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def lm_state():
    """Per arch, built once: (port cfg, ref cfg, ref model, ref params,
    port params, ref batch, port batch)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = ref_reduced(arch)
            rmodel = ref_build(rcfg)
            rparams = rmodel.init(jax.random.PRNGKey(0))
            batch = make_dummy_batch(rcfg, SHAPE, jax.random.PRNGKey(1))
            pparams = convert.lm_tree_from_numpy(
                jax.tree.map(np.asarray, rparams), "cpu")
            pbatch = {k: _t(v) for k, v in batch.items()}
            pbatch["tokens"] = pbatch["tokens"].long()
            cache[arch] = (get_reduced_config(arch), rcfg, rmodel, rparams,
                           pparams, batch, pbatch)
        return cache[arch]

    return get


def _inputs(batch):
    return batch["tokens"], batch.get("positions"), \
        batch.get("frontend_embeds")


def _ref_graft(dst, src):
    pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
    return jnp.pad(src.astype(dst.dtype), pad)


def _assert_tree_close(port: dict, ref: dict, **tol):
    assert set(port) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_tree_close(port[k], v, **tol)
        else:
            assert tuple(port[k].shape) == v.shape, k
            np.testing.assert_allclose(port[k].numpy(), np.asarray(v),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch, lm_state):
    cfg, rcfg, _, rparams, pparams, batch, pbatch = lm_state(arch)
    want, _ = RT.forward(rparams, rcfg, *_inputs(batch))
    got, aux = PT.forward(pparams, cfg, *_inputs(pbatch))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch, lm_state):
    """Last logits and the filled cache, (G, B, S, KV, hd) per slot."""
    cfg, rcfg, _, rparams, pparams, batch, pbatch = lm_state(arch)
    want, rcache = RT.prefill(rparams, rcfg, *_inputs(batch))
    got, pcache = PT.prefill(pparams, cfg, *_inputs(pbatch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    _assert_tree_close(pcache, rcache, **CACHE)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_after_graft_matches_reference(arch, lm_state):
    """Prefill, graft into a longer cache, two decode steps: logits and
    the whole cache equal the reference's."""
    cfg, rcfg, rmodel, rparams, pparams, batch, pbatch = lm_state(arch)
    toks = batch["tokens"]
    S = toks.shape[1]
    _, rpre = RT.prefill(rparams, rcfg, toks)
    rcache = jax.tree.map(_ref_graft, rmodel.init_cache(2, S + 8), rpre)
    model = build_model(cfg, device="cpu")
    _, ppre = PT.prefill(pparams, cfg, pbatch["tokens"])
    pcache = lm_serve.graft(model.init_cache(2, S + 8), ppre)
    _assert_tree_close(pcache, rcache, **CACHE)
    for step, tok in enumerate((toks[:, :1], toks[:, 5:6])):
        want, rcache = rmodel.decode_step(rparams, tok, jnp.int32(S + step),
                                          rcache)
        got, pcache = model.decode_step(pparams, _t(tok).long(), S + step,
                                        pcache)
        assert got.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    _assert_tree_close(pcache, rcache, **CACHE)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_equals_forward_last_logits(arch, lm_state):
    """The reference's invariant (`test_archs_smoke.py`), on the port."""
    cfg, _, _, _, pparams, _, pbatch = lm_state(arch)
    fwd, _ = PT.forward(pparams, cfg, *_inputs(pbatch))
    pre, _ = PT.prefill(pparams, cfg, *_inputs(pbatch))
    np.testing.assert_allclose(pre[:, 0].numpy(), fwd[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_continues_prefill(arch, lm_state):
    """Decode after prefill == teacher-forced forward at the next position
    (the reference's invariant and rule)."""
    cfg, _, _, _, pparams, _, pbatch = lm_state(arch)
    toks = pbatch["tokens"]
    S = toks.shape[1]
    fwd, _ = PT.forward(pparams, cfg, torch.cat([toks, toks[:, :1]], 1))
    model = build_model(cfg, device="cpu")
    _, pre = PT.prefill(pparams, cfg, toks)
    cache = lm_serve.graft(model.init_cache(2, S + 8), pre)
    dec, _ = model.decode_step(pparams, toks[:, :1], S, cache)
    np.testing.assert_allclose(dec[:, 0].numpy(), fwd[:, S].numpy(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-67b",
                                  "qwen2-vl-72b"])
def test_long_prefill_goes_through_flash(arch, lm_state, monkeypatch):
    """Above DIRECT_MAX_SEQ (64 here, in both packages) prefill takes the
    flash forward (chunks 32 / 16 in both): equal to the reference's, and
    to the port's own direct path.  gemma2's local layers (window 64)
    skip KV chunks on both sides of the window."""
    cfg, rcfg, _, rparams, pparams, _, _ = lm_state(arch)
    toks = np.random.default_rng(3).integers(0, 512, (1, 128), np.int32)
    direct, dcache = PT.prefill(pparams, cfg, _t(toks).long())
    for mod, name, val in ((RA, "DIRECT_MAX_SEQ", 64),
                           (PA, "DIRECT_MAX_SEQ", 64), (RF, "Q_CHUNK", 32),
                           (RF, "KV_CHUNK", 16), (PF, "Q_CHUNK", 32),
                           (PF, "KV_CHUNK", 16)):
        monkeypatch.setattr(mod, name, val)
    calls = []
    flash = PF.flash_attention
    monkeypatch.setattr(PF, "flash_attention",
                        lambda *a, **kw: calls.append(kw["window"])
                        or flash(*a, **kw))
    want, rcache = RT.prefill(rparams, rcfg, jnp.asarray(toks))
    got, pcache = PT.prefill(pparams, cfg, _t(toks).long())
    assert len(calls) == cfg.num_layers
    if cfg.attn_type == "local_global":
        assert calls[0] == cfg.window == 64 and calls[1] is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    _assert_tree_close(pcache, rcache, **CACHE)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **LOGITS)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen1.5-110b"])
def test_greedy_serve_matches_reference(arch, lm_state):
    """`launch.serve.generate` at temperature 0 against the reference's
    serve loop (prefill, graft, argmax decode): equal tokens up to the
    first step whose top-two logit margin is within 1e-4."""
    cfg, rcfg, rmodel, rparams, pparams, _, _ = lm_state(arch)
    B, P, n_gen, max_seq = 3, 16, 12, 40
    prompts = np.random.default_rng(4).integers(0, 512, (B, P), np.int32)
    logits, pcache = RT.prefill(rparams, rcfg, jnp.asarray(prompts))
    cache = jax.tree.map(_ref_graft, rmodel.init_cache(B, max_seq), pcache)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, margins = [tok], [logits[:, -1]]
    for i in range(n_gen - 1):
        logits, cache = rmodel.decode_step(rparams, tok, jnp.int32(P + i),
                                           cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
        margins.append(logits[:, -1])
    want = np.concatenate([np.asarray(t) for t in toks], axis=1)
    top2 = np.sort(np.stack([np.asarray(m) for m in margins], 1), -1)
    margin = top2[..., -1] - top2[..., -2]                  # (B, n_gen)

    model = build_model(cfg, device="cpu")
    out = lm_serve.generate(model, pparams, _t(prompts).long(), n_gen,
                            max_seq, temperature=0.0)
    got = out["tokens"].numpy()
    assert got.shape == (B, n_gen) and len(out["decode_step_s"]) == n_gen - 1
    compared = 0
    for b in range(B):
        ambiguous = np.flatnonzero(margin[b] <= 1e-4)
        upto = ambiguous[0] + 1 if ambiguous.size else n_gen
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])
        compared += upto
    assert compared >= B * n_gen // 2


def test_sampled_serve_is_seeded():
    """Temperature sampling draws from the generator: the same seed gives
    the same tokens, another seed other tokens, all in the vocabulary."""
    cfg = get_reduced_config("gemma2-2b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8),
                            generator=torch.Generator().manual_seed(1))

    def run(seed):
        return lm_serve.generate(
            model, params, prompts, 10, 24, temperature=1.0,
            generator=torch.Generator().manual_seed(seed))["tokens"]

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", DENSE)
def test_init_draws_the_reference_tree(arch, lm_state):
    """`build_model(cfg).init(seed)`: the reference's tree (paths, shapes,
    dtypes: norms float32, weights in the config's dtype), the parameter
    count `cfg.param_count()` plus the norms and QKV biases (which the
    count leaves out), zero norms and biases."""
    cfg, _, _, rparams, _, _, _ = lm_state(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    ref = {jax.tree_util.keystr(p): (leaf.shape, str(leaf.dtype))
           for p, leaf in jax.tree_util.tree_flatten_with_path(rparams)[0]}
    got = {}

    def walk(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}[{k!r}]")
            else:
                got[f"{path}[{k!r}]"] = (tuple(v.shape),
                                         str(v.dtype).split(".")[-1])
    walk(params)
    assert got == ref
    uncounted = [v for k, v in _leaves(params)
                 if "norm" in k or k in ("bq", "bk", "bv")]
    assert sum(v.numel() for _, v in _leaves(params)) == \
        cfg.param_count() + sum(v.numel() for v in uncounted)
    assert not any(v.any() for v in uncounted)
    bf16 = build_model(cfg.__class__(**{**cfg.__dict__,
                                        "dtype": "bfloat16"}),
                       device="cpu").init(1)
    assert bf16["tok_embed"].dtype == torch.bfloat16
    assert bf16["final_norm"].dtype == torch.float32


def _leaves(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


def test_serve_entry_point_runs_on_the_cpu():
    """``python -m repro_torch.launch.serve --reduced --device cpu``."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
         "6", "--max-seq", "16"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill 2x8")
    assert lines[1].startswith("decoded 5 steps x 2 seqs")
    assert len(eval(lines[2].split(":", 1)[1])) == 6


def test_build_model_hw_aware_decode_matches_reference(lm_state):
    """``build_model(cfg, hw_aware=, chip_key=)``: decode sees the params
    through `apply_hardware` (8-bit fake quantization, no gain mismatch),
    as the reference's does, and differs from the plain decode."""
    cfg, rcfg, rmodel, rparams, pparams, batch, pbatch = lm_state(
        "gemma2-2b")
    toks = batch["tokens"]
    S = toks.shape[1]
    rhw = ref_build(rcfg, hw_aware=RH.HwAwareConfig(sigma_gain=0.0),
                    chip_key=jax.random.PRNGKey(3))
    phw = build_model(cfg, hw_aware=PH.HwAwareConfig(sigma_gain=0.0),
                      chip_key=3, device="cpu")
    _, rpre = RT.prefill(rparams, rcfg, toks)
    rcache = jax.tree.map(_ref_graft, rmodel.init_cache(2, S + 4), rpre)
    want, _ = rhw.decode_step(rparams, toks[:, :1], jnp.int32(S), rcache)
    _, ppre = PT.prefill(pparams, cfg, pbatch["tokens"])
    pcache = lm_serve.graft(phw.init_cache(2, S + 4), ppre)
    got, _ = phw.decode_step(pparams, pbatch["tokens"][:, :1], S,
                             {"blocks": {n: {k: v.clone() for k, v in
                                             slot.items()} for n, slot in
                                         pcache["blocks"].items()}})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    plain, _ = build_model(cfg, device="cpu").decode_step(
        pparams, pbatch["tokens"][:, :1], S, pcache)
    assert (got - plain).abs().max().item() > 1e-3


@pytest.fixture(scope="module")
def bf16_state():
    """gemma2-2b reduced in bf16, built once: the reference's model and
    params, the port's params (converted), and 2 x 98 tokens (96 to
    prefill, past the window of 64, and two to decode)."""
    rcfg = dataclasses.replace(ref_reduced("gemma2-2b"), dtype="bfloat16")
    cfg = dataclasses.replace(get_reduced_config("gemma2-2b"),
                              dtype="bfloat16")
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    pparams = convert.lm_tree_from_numpy(jax.tree.map(np.asarray, rparams),
                                         "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 98),
                                             np.int32)
    return cfg, rcfg, rmodel, rparams, pparams, toks


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("path", ["direct", "decode"])
def test_bf16_attention_matches_reference(path, window, bf16_state):
    """Layer 0's attention in bf16 on the same inputs: the direct path
    (96 queries) and the decode path (one query at 96 against a 112-slot
    cache), each with and without the window."""
    cfg, rcfg, _, rparams, pparams, _ = bf16_state
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"]["layer_0"]["attn"])
    pp = PT.group_slice(pparams["blocks"]["layer_0"]["attn"], 0)
    rng = np.random.default_rng(2)
    B, S = 2, 96
    x = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)), jnp.bfloat16)
    xt = torch.as_tensor(_f32(x)).bfloat16()
    if path == "direct":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        want, _ = RA.attention(rp, rcfg, x, jnp.asarray(pos), causal=True,
                               window=window)
        got, _ = PA.attention(pp, cfg, xt, torch.as_tensor(pos.copy()),
                              causal=True, window=window)
    else:
        ck, cv = (jnp.asarray(rng.normal(size=(B, 112, cfg.num_kv_heads,
                                               cfg.hd())), jnp.bfloat16)
                  for _ in range(2))
        want, rk, _ = RA.decode_attention(rp, rcfg, x[:, :1], ck, cv,
                                          jnp.int32(S), window=window)
        pk = torch.as_tensor(_f32(ck)).bfloat16()
        got, pk, _ = PA.decode_attention(
            pp, cfg, xt[:, :1], pk, torch.as_tensor(_f32(cv)).bfloat16(), S,
            window=window)
        np.testing.assert_array_equal(_f32(pk), _f32(rk))
    assert got.dtype == torch.bfloat16
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=BF16_ATTN_RTOL,
                               atol=2 ** -8 * np.sqrt(np.mean(want ** 2)))
    assert (got != want).mean() <= BF16_ATTN_DIFFER


def _assert_rms_close(got, want, name):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    rms = float(np.sqrt(np.mean(want ** 2)))
    err = float(np.abs(got - want).max())
    assert err <= BF16_MODEL * rms, (name, err, rms)


@pytest.mark.parametrize("stage", ["forward", "prefill", "decode"])
def test_bf16_model_matches_reference(stage, bf16_state):
    """gemma2-2b reduced in bf16 against the reference: forward logits
    over 96 tokens, prefill's last logits and its cache, and two decode
    steps at positions 96 and 97 after the graft (logits and cache)."""
    cfg, rcfg, rmodel, rparams, pparams, toks = bf16_state
    S = 96
    ptoks = torch.as_tensor(toks).long()
    if stage == "forward":
        want, _ = RT.forward(rparams, rcfg, jnp.asarray(toks[:, :S]))
        got, _ = PT.forward(pparams, cfg, ptoks[:, :S])
        _assert_rms_close(got, want, "logits")
        return
    want, rcache = RT.prefill(rparams, rcfg, jnp.asarray(toks[:, :S]))
    got, pcache = PT.prefill(pparams, cfg, ptoks[:, :S])
    if stage == "decode":
        rcache = jax.tree.map(_ref_graft, rmodel.init_cache(2, 112), rcache)
        model = build_model(cfg, device="cpu")
        pcache = lm_serve.graft(model.init_cache(2, 112), pcache)
        for pos in (S, S + 1):
            want, rcache = rmodel.decode_step(
                rparams, jnp.asarray(toks[:, pos:pos + 1]), jnp.int32(pos),
                rcache)
            got, pcache = model.decode_step(pparams, ptoks[:, pos:pos + 1],
                                            pos, pcache)
            _assert_rms_close(got, want, f"logits at {pos}")
    else:
        _assert_rms_close(got, want, "logits")
    for name, slot in rcache["blocks"].items():
        for kv, leaf in slot.items():
            assert pcache["blocks"][name][kv].dtype == torch.bfloat16
            _assert_rms_close(pcache["blocks"][name][kv], leaf,
                              f"{name}/{kv}")
