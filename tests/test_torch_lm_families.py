"""The port's other language-model families (`repro_torch.models`:
mixture-of-experts, the Mamba hybrid, RWKV-6) against the reference's,
whole-model: granite-moe-1b-a400m, kimi-k2 (its dense prefix layer and
one MoE layer with a shared expert), jamba-v0.1-52b (one period: 7 Mamba
layers, 1 attention, 4 MoE) and rwkv6-3b at the reference's
`get_reduced_config` sizes (d_model 128, vocab 512; float32), the
reference's parameters carried across by `repro_torch.convert`
(`tests/_torch_port.py::lm_state`), the same inputs.  Losses and
gradients are in `test_torch_moe.py` and `test_torch_ssm.py`, Whisper in
`test_torch_whisper.py`.

Tolerances, float32: logits 1e-4 absolute and relative (as
`test_torch_lm.py`; measured ~4e-6), caches and state leaves 1e-5
(`assert_lm_tree_close`), absolute in units of the leaf's max |x| where
that exceeds 1: RWKV's wkv state reaches ~12, and its entries differ by
up to 4.6e-5 (3.8e-6 of the max: summation order in the chunk einsums).
The reference's own invariants hold on the port under its rules
(prefill == forward's last logits to 2e-3, decode continues prefill to
3e-2).  Also here: the two repairs of this slice (`launch.serve.graft`
fills the ``prefix`` cache; the MoE auxiliary loss reaches `Model.loss`),
every architecture through `build_model`, and ``python -m
repro_torch.launch.serve`` for a MoE, an RWKV and a hybrid
architecture."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_lm_tree_close, flat_tree, lm_state,
                         ref_flat_tree)
from repro.models import transformer as RT
from repro_torch.configs.registry import ARCH_IDS, get_reduced_config
from repro_torch.launch import serve as lm_serve
from repro_torch.models import transformer as PT
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parent.parent
DECODERS = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
            "rwkv6-3b"]
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def fam():
    """Per arch, built once: `lm_state(arch)`."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = lm_state(arch)
        return cache[arch]

    return get


def _ref_graft(dst, src):
    pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
    return jnp.pad(src.astype(dst.dtype), pad)


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_matches_reference(arch, fam):
    cfg, rcfg, _, rparams, pparams, batch, pbatch = fam(arch)
    want, want_aux = RT.forward(rparams, rcfg, batch["tokens"])
    got, aux = PT.forward(pparams, cfg, pbatch["tokens"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5, abs=1e-6)
    if cfg.moe is not None:
        assert float(aux) > 0.5      # the Switch term, ~1 when balanced


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_matches_reference(arch, fam):
    """Last logits and the filled cache: stacked K/V and state leaves,
    and kimi's unstacked prefix."""
    cfg, rcfg, _, rparams, pparams, batch, pbatch = fam(arch)
    want, rcache = RT.prefill(rparams, rcfg, batch["tokens"])
    got, pcache = PT.prefill(pparams, cfg, pbatch["tokens"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert_lm_tree_close(pcache, rcache)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_after_graft_matches_reference(arch, fam):
    """Prefill, graft into a longer cache, two decode steps: logits and
    the whole cache (K/V, Mamba conv/ssm, RWKV shift/wkv, the prefix)
    equal the reference's."""
    cfg, rcfg, rmodel, rparams, pparams, batch, pbatch = fam(arch)
    toks = batch["tokens"]
    S = toks.shape[1]
    _, rpre = RT.prefill(rparams, rcfg, toks)
    rcache = jax.tree.map(_ref_graft, rmodel.init_cache(2, S + 8), rpre)
    model = build_model(cfg, device="cpu")
    _, ppre = PT.prefill(pparams, cfg, pbatch["tokens"])
    pcache = lm_serve.graft(model.init_cache(2, S + 8), ppre)
    assert_lm_tree_close(pcache, rcache)
    for step, tok in enumerate((toks[:, :1], toks[:, 5:6])):
        want, rcache = rmodel.decode_step(rparams, tok, jnp.int32(S + step),
                                          rcache)
        got, pcache = model.decode_step(pparams, _t(tok).long(), S + step,
                                        pcache)
        assert got.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    assert_lm_tree_close(pcache, rcache)


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_equals_forward_last_logits(arch, fam):
    """The reference's invariant (`test_archs_smoke.py`), on the port."""
    cfg, _, _, _, pparams, _, pbatch = fam(arch)
    fwd, _ = PT.forward(pparams, cfg, pbatch["tokens"])
    pre, _ = PT.prefill(pparams, cfg, pbatch["tokens"])
    np.testing.assert_allclose(pre[:, 0].numpy(), fwd[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_decode_continues_prefill(arch, fam):
    """Decode after prefill == teacher-forced forward at the next position
    (the reference's invariant, rule and arch list: capacity-limited MoE
    may drop a token under teacher forcing, never at one-token decode)."""
    cfg, _, _, _, pparams, _, pbatch = fam(arch)
    toks = pbatch["tokens"]
    S = toks.shape[1]
    fwd, _ = PT.forward(pparams, cfg, torch.cat([toks, toks[:, :1]], 1))
    model = build_model(cfg, device="cpu")
    _, pre = PT.prefill(pparams, cfg, toks)
    cache = lm_serve.graft(model.init_cache(2, S + 8), pre)
    dec, _ = model.decode_step(pparams, toks[:, :1], S, cache)
    np.testing.assert_allclose(dec[:, 0].numpy(), fwd[:, S].numpy(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch", DECODERS)
def test_init_draws_the_reference_tree(arch, fam):
    """`build_model(cfg).init(seed)`: the reference's tree (paths with
    kimi's ``prefix`` and whisper's ``encoder`` / ``decoder`` lists,
    shapes, dtypes); the deterministic leaves equal the reference's (norms
    0, ``mu`` 0.5, ``decay_bias`` -5, ``ln_x`` and ``D_skip`` 1,
    ``A_log`` = log 1..N, ``conv_b`` 0); Mamba's ``dt_b`` inside the
    reference's range."""
    _, _, _, rparams, _, _, _ = fam(arch)
    params = build_model(get_reduced_config(arch), device="cpu").init(0)
    got, want = flat_tree(params), ref_flat_tree(rparams)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    fixed = ("norm", "['mu']", "decay_bias", "ln_x", "D_skip", "A_log",
             "conv_b")
    for k, w in want.items():
        if any(f in k for f in fixed):
            # log 1..N: XLA's float32 log and torch's differ by an ulp
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                       rtol=1.2e-7, atol=0, err_msg=k)
        if k.endswith("['dt_b']"):
            lo, hi = np.log(np.expm1([1e-3, 1e-1]))
            v = got[k].numpy()
            assert lo - 1e-4 <= v.min() and v.max() <= hi + 1e-4
            assert v.std() > 0.3 * np.asarray(w).std()


def test_moe_aux_loss_reaches_the_loss(fam):
    """granite-reduced's `Model.loss` equals the reference's, which adds
    0.01 · aux (the Switch load-balance term, ~1) to the cross-entropy:
    a layer that dropped the auxiliary loss would miss it by ~0.01."""
    cfg, rcfg, rmodel, rparams, pparams, batch, pbatch = fam(
        "granite-moe-1b-a400m")
    want = float(rmodel.loss(rparams, batch))
    got = float(build_model(cfg, device="cpu").loss(pparams, pbatch))
    assert got == pytest.approx(want, rel=1e-5)
    x, aux = PT.forward_hidden(pparams, cfg, pbatch["tokens"])
    ce = float(PT.chunked_ce(pparams, cfg, x, pbatch["labels"]))
    assert float(aux) > 0.5 and got == pytest.approx(ce + 0.01 * float(aux),
                                                      rel=1e-6)


def test_graft_fills_the_prefix_cache_and_serve_matches_reference(fam):
    """kimi-reduced through `launch.serve.generate` at temperature 0
    against the reference's serve loop (prefill, the graft of every leaf,
    argmax decode): the grafted cache — the dense prefix layer's K/V
    included — equals the reference's, and so do the tokens up to the
    first step whose top-two logit margin is within 1e-4."""
    cfg, rcfg, rmodel, rparams, pparams, _, _ = fam("kimi-k2-1t-a32b")
    B, P, n_gen, max_seq = 3, 16, 10, 40
    prompts = np.random.default_rng(4).integers(0, 512, (B, P), np.int32)
    logits, pcache = RT.prefill(rparams, rcfg, jnp.asarray(prompts))
    cache = jax.tree.map(_ref_graft, rmodel.init_cache(B, max_seq), pcache)
    model = build_model(cfg, device="cpu")
    _, ppre = PT.prefill(pparams, cfg, _t(prompts).long())
    grafted = lm_serve.graft(model.init_cache(B, max_seq), ppre)
    assert grafted["prefix"][0]["k"][:, :P].abs().max() > 0
    assert_lm_tree_close(grafted, cache)

    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    toks, margins = [tok], [logits[:, -1]]
    decode = jax.jit(rmodel.decode_step)     # as the reference's serve loop
    for i in range(n_gen - 1):
        logits, cache = decode(rparams, tok, jnp.int32(P + i), cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(tok)
        margins.append(logits[:, -1])
    want = np.concatenate([np.asarray(t) for t in toks], axis=1)
    top2 = np.sort(np.stack([np.asarray(m) for m in margins], 1), -1)
    margin = top2[..., -1] - top2[..., -2]
    got = lm_serve.generate(model, pparams, _t(prompts).long(), n_gen,
                            max_seq, temperature=0.0)["tokens"].numpy()
    compared = 0
    for b in range(B):
        ambiguous = np.flatnonzero(margin[b] <= 1e-4)
        upto = ambiguous[0] + 1 if ambiguous.size else n_gen
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])
        compared += upto
    assert compared >= B * n_gen // 2


def test_rwkv_prime_length_prompt(fam):
    """A 13-token prompt (prime: WKV chunks of 1) and a 128-token one (two
    chunks of 64): prefill's logits and state equal the reference's."""
    cfg, rcfg, _, rparams, pparams, _, _ = fam("rwkv6-3b")
    for S in (13, 128):
        toks = np.random.default_rng(S).integers(0, 512, (2, S), np.int32)
        want, rcache = RT.prefill(rparams, rcfg, jnp.asarray(toks))
        got, pcache = PT.prefill(pparams, cfg, _t(toks).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
        assert_lm_tree_close(pcache, rcache)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_runs_every_architecture(arch):
    """`build_model(get_reduced_config(a), device="cpu")`: init, loss,
    init_cache and decode_step run for all ten architectures, with finite
    outputs of the expected shapes."""
    cfg = get_reduced_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    if cfg.enc_dec is not None:
        batch["frontend_embeds"] = 0.02 * torch.randn(
            (2, cfg.enc_dec.enc_seq, cfg.d_model), generator=gen)
    if cfg.rope_kind == "mrope":
        batch["positions"] = torch.arange(16)[None, None].expand(3, 2, 16)
    assert torch.isfinite(model.loss(params, batch))
    logits, _ = model.decode_step(params, toks[:, :1], 3,
                                  model.init_cache(2, 16))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-3b",
                                  "jamba-v0.1-52b"])
def test_serve_entry_point_runs_on_the_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <a> --reduced --device
    cpu`` for a MoE, an RWKV and a hybrid architecture."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "8", "--gen", "6", "--max-seq", "16"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill 2x8")
    assert lines[1].startswith("decoded 5 steps x 2 seqs")
    assert len(eval(lines[2].split(":", 1)[1])) == 6


def test_serve_entry_point_refuses_the_encoder_decoder():
    """The demo drives decoder-only archs: whisper is refused with an
    error, as the reference asserts."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "whisper-tiny", "--reduced", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 2 and "encoder-decoder" in proc.stderr
