"""The port's AdamW (`repro_torch.optim.adamw`) against the reference's
(`repro.optim.adamw`): the same parameters, gradients and optimizer state
carried across (`repro_torch.convert`), one `apply` in each package, for
float32 and 8-bit moments at steps 1, 2 and 50.

Tolerances: parameters, moments and 8-bit scales to 1e-6 of each leaf's
max |x| (the reference's compiled float32 may contract ``b * m + c * g``
into one FMA where the port rounds twice; measured <= 1.1e-7); the 8-bit
payload ``q`` bit-equal (it may differ only where a division rounds
across a half, which these inputs do not reach); lr and grad_norm to
1e-6 relative.  Plus the reference's own optimizer tests
(`tests/test_substrate.py`) on the port, and the in-place contract.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch import convert
from repro_torch.optim import adamw as PA

REL = 1e-6


def _params(rng):
    """A stacked layer slot (G=3), its (G, d) norm scale, an unstacked
    vector and a leaf of 700 entries (not a multiple of QBLOCK)."""
    return {"blocks": {"w": rng.normal(size=(3, 40, 50)),
                       "norm": rng.normal(size=(3, 40))},
            "final_norm": rng.normal(size=(40,)),
            "tok": rng.normal(size=(700,))}


def _grads(step):
    """Gradients of mixed scales, half of one leaf's entries near zero."""
    rng = np.random.default_rng(100 + step)
    g = _params(rng)
    g["blocks"]["w"] *= 1e-2
    g["blocks"]["norm"] *= 1e-3
    g["tok"] *= np.where(rng.random(700) < 0.5, 1e-7, 1.0)
    return jax.tree.map(lambda a: a.astype(np.float32), g)


def _cfgs(bits):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=100, state_bits=bits)
    return RA.AdamWConfig(**kw), PA.AdamWConfig(**kw)


@pytest.fixture(scope="module")
def ref_states():
    """The reference's (params, state) before steps 1, 2 and 50, per bits,
    as numpy trees."""
    out = {}
    for bits in (32, 8):
        rcfg, _ = _cfgs(bits)
        step = jax.jit(lambda g, s, p: RA.apply(rcfg, g, s, p))
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                         _params(np.random.default_rng(0)))
        s = RA.init(p, bits)
        for n in range(49):
            if n in (0, 1):
                out[bits, n + 1] = jax.tree.map(np.asarray, (p, s))
            p, s, _ = step(_grads(n), s, p)
        out[bits, 50] = jax.tree.map(np.asarray, (p, s))
    return out


def _moment_leaves(tree, bits):
    """Reference moments as numpy leaves in `jax.tree.leaves` order, or
    the port's as the same leaves (a QTensor gives q, then scale)."""
    if isinstance(tree, list):
        if bits == 8:
            return [np.asarray(x) for t in tree for x in (t.q, t.scale)]
        return [np.asarray(t) for t in tree]
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= REL * scale, what


@pytest.mark.parametrize("bits", [32, 8])
@pytest.mark.parametrize("step", [1, 2, 50])
def test_apply_matches_reference(ref_states, bits, step):
    rcfg, pcfg = _cfgs(bits)
    rp, rs = ref_states[bits, step]
    g = _grads(step - 1)
    want_p, want_s, want_m = RA.apply(
        rcfg, jax.tree.map(jnp.asarray, g),
        jax.tree.map(jnp.asarray, rs), jax.tree.map(jnp.asarray, rp))
    pp = convert.lm_tree_from_numpy(rp, "cpu")
    ps = convert.opt_state_from_numpy(rs, "cpu")
    got_p, got_s, got_m = PA.apply(pcfg, convert.lm_tree_from_numpy(g, "cpu"),
                                   ps, pp)
    assert int(got_s.step) == int(want_s.step) == step
    for k in ("lr", "grad_norm"):
        assert float(got_m[k]) == pytest.approx(float(want_m[k]), rel=REL)
    for w, a in zip(jax.tree.leaves(want_p), PA.tree_leaves(got_p)):
        _close(a.numpy(), np.asarray(w), "params")
    for name in ("mu", "nu"):
        want = _moment_leaves(getattr(want_s, name), bits)
        got = _moment_leaves(PA.tree_leaves(getattr(got_s, name)), bits)
        assert len(got) == len(want)
        for a, w in zip(got, want):
            if w.dtype == np.int8:
                np.testing.assert_array_equal(a, w, err_msg=name)
            else:
                _close(a, w, name)


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=15, total_steps=300, min_lr_frac=0.1)
    rcfg, pcfg = RA.AdamWConfig(**cfg), PA.AdamWConfig(**cfg)
    steps = [0, 1, 7, 15, 16, 100, 299, 300, 301, 5000]
    want = [float(RA.schedule(rcfg, jnp.int32(s))) for s in steps]
    got = [float(PA.schedule(pcfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def test_bias_corrections_equal_the_reference():
    """``1 - b ** step`` for b1 and b2 over the first 20,000 steps: the
    port takes the power in float64 and rounds once, XLA's float32 pow
    differs in the last place at a few hundred steps (and flushes b1's
    subnormal powers), and the corrections are bit-equal all the same
    (ROADMAP Queue 3 item 20)."""
    steps = np.arange(1, 20001, dtype=np.int32)
    for b in (0.9, 0.95):
        want = jax.jit(lambda s: 1.0 - b ** s.astype(jnp.float32))(
            jnp.asarray(steps))
        got = 1.0 - PA._pow32(b, torch.as_tensor(steps))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_matches_reference():
    """`_quantize` / `_dequantize` on the same float32 values: q and
    scale bit-equal, and the round trip equal."""
    x = (np.random.default_rng(7).normal(size=(3, 333)) *
         np.logspace(-6, 2, 333)).astype(np.float32)
    want = RA._quantize(jnp.asarray(x))
    got = PA._quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.shape == tuple(want.shape) == (3, 333)
    np.testing.assert_array_equal(PA._dequantize(got).numpy(),
                                  np.asarray(RA._dequantize(want)))


@pytest.mark.parametrize("bits", [32, 8])
def test_apply_updates_in_place(bits):
    """The donation contract: the returned parameters, state, step and
    moments are the caller's objects, updated."""
    params = {"w": torch.ones(4, 300), "b": torch.zeros(300)}
    leaves = PA.tree_leaves(params)
    state = PA.init(params, bits)
    moments = PA.tree_leaves(state.mu) + PA.tree_leaves(state.nu)
    before = [t.clone() for t in leaves]
    cfg = PA.AdamWConfig(lr=0.1, warmup_steps=0, state_bits=bits)
    grads = {"w": torch.full((4, 300), 0.5), "b": torch.full((300,), -1.0)}
    new_p, new_s, _ = PA.apply(cfg, grads, state, params)
    assert new_p is params and new_s is state
    assert all(a is b for a, b in zip(PA.tree_leaves(new_p), leaves))
    assert all(a is b for a, b in zip(
        PA.tree_leaves(new_s.mu) + PA.tree_leaves(new_s.nu), moments))
    assert int(state.step) == 1
    assert all(not torch.equal(a, b) for a, b in zip(leaves, before))


# ------------------------------------------ the reference's own tests
def test_adamw_optimizes_quadratic():
    cfg = PA.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                         total_steps=100)
    params = {"w": torch.ones(4) * 5.0}
    state = PA.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = PA.apply(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip_applies():
    cfg = PA.AdamWConfig(lr=1e-3, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = PA.init(params)
    _, _, m = PA.apply(cfg, {"w": torch.full((3,), 1e6)}, state, params)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_schedule_warmup_and_decay():
    cfg = PA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    lrs = [float(PA.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[1] == pytest.approx(0.5, abs=0.01)
    assert lrs[2] == pytest.approx(1.0, abs=0.05)
    assert lrs[-1] == pytest.approx(0.1, abs=0.02)
