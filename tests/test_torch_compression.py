"""`repro_torch.runtime.compression` against `repro.runtime.compression`:
int8 block compression with error feedback, bit-equal across the
packages (the same op order; ``torch.round`` and ``jnp.round`` both round
half to even), and the reference's own compression tests on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.runtime import compression as R
from repro_torch.optim import adamw
from repro_torch.runtime import compression as comp


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (257,), (1000,),
                                   (37, 41)])
def test_compress_is_bit_equal_to_reference(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.normal(size=shape) * 3.0).astype(np.float32)
    g.reshape(-1)[::7] = 0.0                 # all-zero-ish blocks too
    c, err = R.compress(jnp.asarray(g))
    pc, perr = comp.compress(torch.as_tensor(g))
    assert pc.shape == c.shape == shape
    assert pc.q.dtype == torch.int8 and pc.scale.dtype == torch.float32
    np.testing.assert_array_equal(pc.q.numpy(), np.asarray(c.q))
    np.testing.assert_array_equal(pc.scale.numpy(), np.asarray(c.scale))
    np.testing.assert_array_equal(perr.numpy(), np.asarray(err))
    np.testing.assert_array_equal(comp.decompress(pc).numpy(),
                                  np.asarray(R.decompress(c)))


def test_ef_compress_tree_is_bit_equal_to_reference():
    """Over a tree with a carried error, a bf16 leaf among float32 ones:
    payloads, scales and the new error equal the reference's."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(300,)).astype(np.float32),
            "b": [rng.normal(size=(4, 70)).astype(np.float32)]}
    err = {"a": (rng.normal(size=(300,)) * 1e-3).astype(np.float32),
           "b": [np.zeros((4, 70), np.float32)]}
    rc, rerr = R.ef_compress_tree(
        {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(tree["b"][0])]},
        {"a": jnp.asarray(err["a"]), "b": [jnp.asarray(err["b"][0])]})
    pc, perr = comp.ef_compress_tree(
        {"a": torch.as_tensor(tree["a"]), "b": [torch.as_tensor(
            tree["b"][0])]},
        {"a": torch.as_tensor(err["a"]), "b": [torch.as_tensor(
            err["b"][0])]})
    for got, want in ((pc["a"], rc["a"]), (pc["b"][0], rc["b"][0])):
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
    np.testing.assert_array_equal(perr["a"].numpy(), np.asarray(rerr["a"]))
    np.testing.assert_array_equal(perr["b"][0].numpy(),
                                  np.asarray(rerr["b"][0]))
    out = comp.decompress_tree(pc)
    np.testing.assert_array_equal(out["b"][0].numpy(),
                                  np.asarray(R.decompress_tree(rc)["b"][0]))
    zero = comp.init_error({"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert zero["w"].dtype == torch.float32 and zero["w"].shape == (3, 5)


def test_compress_error_feedback_identity():
    """decompress(q) + err == g exactly (EF invariant)."""
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(300,)) * 3.0, dtype=torch.float32)
    c, err = comp.compress(g)
    assert torch.equal(comp.decompress(c) + err, g)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 1000), scale=st.floats(1e-3, 1e3))
def test_compress_error_bounded(n, scale):
    rng = np.random.default_rng(n)
    g = torch.as_tensor(rng.normal(size=(n,)) * scale, dtype=torch.float32)
    c, err = comp.compress(g)
    pad = (-n) % comp.BLOCK
    blocks = np.pad(g.numpy(), (0, pad)).reshape(-1, comp.BLOCK)
    per_block_bound = np.abs(blocks).max(1) / 127.0 * 0.5 + 1e-6
    err_blocks = np.abs(np.pad(err.numpy(), (0, pad))).reshape(-1,
                                                               comp.BLOCK)
    assert (err_blocks.max(1) <= per_block_bound + 1e-5).all()


def test_ef_training_converges_like_uncompressed():
    """EF-compressed grads reach the same optimum on a quadratic."""
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0)
    target = torch.tensor([1.0, -2.0, 3.0, 0.5])

    def run(compressed):
        params = {"w": torch.zeros(4)}
        state = adamw.init(params)
        err = comp.init_error(params)
        for _ in range(200):
            grads = {"w": 2 * (params["w"] - target)}
            if compressed:
                cgrads, err = comp.ef_compress_tree(grads, err)
                grads = comp.decompress_tree(cgrads)
            params, state, _ = adamw.apply(cfg, grads, state, params)
        return params["w"]

    w_plain = run(False)
    w_comp = run(True)
    np.testing.assert_allclose(w_comp.numpy(), target.numpy(), atol=0.05)
    np.testing.assert_allclose(w_comp.numpy(), w_plain.numpy(), atol=0.05)
