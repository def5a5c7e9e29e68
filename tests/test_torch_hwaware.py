"""The port's hardware-aware STE transform (`repro_torch.core.hwaware`)
against the reference's (`repro.core.hwaware`): with ``sigma_gain=0`` the
transformed parameters equal the reference's leaf for leaf, bit for bit
(the same leaves quantized, the same fake quantization, the STE's
``w + (q - w)`` kept unsimplified); with ``sigma_gain > 0`` the channel
gains are equal in distribution; the port's gains are the same in every
process, where the reference's follow Python's salted ``hash()`` of the
path (ROADMAP Queue 3 item 18); the STE's gradient is the identity."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as ref_reduced
from repro.core import hwaware as RH
from repro.models.model import build_model as ref_build
from repro_torch import convert
from repro_torch.core import hwaware as PH

ROOT = Path(__file__).resolve().parent.parent


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{path}[{k!r}]"))
        else:
            out[f"{path}[{k!r}]"] = v
    return out


@pytest.mark.parametrize("arch,bits", [("gemma2-2b", 8), ("qwen1.5-110b", 8),
                                       ("deepseek-67b", 4)])
def test_zero_gain_mismatch_is_bit_equal(arch, bits):
    rparams = ref_build(ref_reduced(arch)).init(jax.random.PRNGKey(0))
    pparams = convert.lm_tree_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu")
    cfg_r = RH.HwAwareConfig(bits=bits, sigma_gain=0.0)
    cfg_p = PH.HwAwareConfig(bits=bits, sigma_gain=0.0)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(
                RH.apply_hardware(rparams, cfg_r, jax.random.PRNGKey(3)))[0]}
    got = _flat(PH.apply_hardware(pparams, cfg_p, 3))
    assert set(got) == set(want)
    orig = _flat(pparams)
    quantized = 0
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)
        changed = not torch.equal(got[path], orig[path])
        assert changed == PH._should_quantize(path, orig[path], cfg_p), path
        quantized += changed
    # every attention and MLP matrix and an untied lm_head, never the
    # embedding, the norms or the (small) QKV biases
    tied = arch == "gemma2-2b"
    assert quantized == 7 * (2 if tied else 1) + (0 if tied else 1)
    assert torch.equal(got["['tok_embed']"], orig["['tok_embed']"])


def test_gains_are_equal_in_distribution():
    """Over 20000 channels: mean 1 and spread sigma in both packages."""
    sigma = 0.03
    ref = np.asarray(RH._channel_gain(12345, (4, 20000), sigma,
                                      jax.random.PRNGKey(0)))
    port = PH._channel_gain("['blocks']['layer_0']['attn']['wq']",
                            (4, 20000), sigma, 0, "cpu").numpy()
    for g in (ref, port):
        assert g.shape == (20000,)
        assert abs(g.mean() - 1.0) < 4 * sigma / np.sqrt(20000)
        np.testing.assert_allclose(g.std(), sigma, rtol=0.03)
    # another path or another chip is another draw
    other = PH._channel_gain("['blocks']['layer_0']['attn']['wk']",
                             (4, 20000), sigma, 0, "cpu")
    chip1 = PH._channel_gain("['blocks']['layer_0']['attn']['wq']",
                             (4, 20000), sigma, 1, "cpu")
    assert not torch.equal(other, torch.as_tensor(port))
    assert not torch.equal(chip1, torch.as_tensor(port))


_PORT_GAINS = """
import sys, hashlib, torch
sys.path.insert(0, 'src')
from repro_torch.core import hwaware as H
w = torch.linspace(-1, 1, 64 * 96).reshape(64, 96)
out = H.apply_hardware({'blocks': {'layer_0': {'w': w}}},
                       H.HwAwareConfig(sigma_gain=0.05), 7)
print(hashlib.sha1(out['blocks']['layer_0']['w'].numpy().tobytes()).hexdigest())
"""

_REF_GAINS = """
import sys, hashlib, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, 'src')
from repro.core import hwaware as H
w = jnp.linspace(-1, 1, 64 * 96).reshape(64, 96)
out = H.apply_hardware({'blocks': {'layer_0': {'w': w}}},
                       H.HwAwareConfig(sigma_gain=0.05), jax.random.PRNGKey(7))
print(hashlib.sha1(np.asarray(out['blocks']['layer_0']['w']).tobytes()).hexdigest())
"""


def _digest(code, hash_seed):
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "PYTHONHASHSEED": str(hash_seed)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip()


def test_two_interpreters_draw_the_same_chip():
    """Two fresh interpreters (string hashes salted differently) give the
    port the same gains; the reference's ``hash(path)`` gives two chips."""
    assert _digest(_PORT_GAINS, 1) == _digest(_PORT_GAINS, 2)
    assert _digest(_REF_GAINS, 1) != _digest(_REF_GAINS, 2)


def test_ste_gradient_is_the_identity():
    w = torch.randn(64, 96, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    out = PH.apply_hardware({"w": w}, PH.HwAwareConfig(sigma_gain=0.0))["w"]
    assert not torch.equal(out, w)
    g = torch.randn(64, 96, generator=torch.Generator().manual_seed(1))
    (out * g).sum().backward()
    assert torch.equal(w.grad, g)


def test_skip_rules_and_from_chip():
    cfg = PH.HwAwareConfig()
    big = torch.ones(64, 96)
    assert PH._should_quantize("['blocks']['w']", big, cfg)
    assert not PH._should_quantize("['tok_embed']", big, cfg)
    assert not PH._should_quantize("['w']", torch.ones(8, 8), cfg)
    assert not PH._should_quantize("['w']", torch.ones(5000), cfg)
    assert not PH._should_quantize("['w']", torch.ones(64, 96,
                                                       dtype=torch.int32),
                                   cfg)

    class Hw:
        sigma_edge_gain, sigma_dac_bit = 0.04, 0.01

    assert PH.HwAwareConfig.from_chip(Hw(), bits=6) == PH.HwAwareConfig(
        bits=6, sigma_gain=0.04, sigma_bit=0.01)
    assert RH.HwAwareConfig.from_chip(Hw(), bits=6) == RH.HwAwareConfig(
        bits=6, sigma_gain=0.04, sigma_bit=0.01)
