"""Port vs reference: the SoA Chimera-lattice vertical half-step (K6).

`lattice_vertical_update` on CPU tensors runs its plain version
(`kernels/ref.py::lattice_vertical_update_ref`), held here against the
reference's Pallas kernel in interpret mode and against its own plain
oracle, on the shapes of ``tests/test_kernels.py::
test_lattice_kernel_matches_ref`` and both colours.  The port adds the
neuron input in the Pallas kernel's order (``h`` and the vertical couplers
first, then the in-cell terms in ascending j); the JAX oracle's einsum
adds in XLA's order, so the shared tests use dyadic couplings and biases
(multiples of 2^-8 over a small range): every partial sum is then exact in
float32 and every order gives the same input, bit for bit.  One test
holds the order itself against the Pallas kernel with couplings whose
partial sums round.  What is left
is ``tanh``'s last place in the two frameworks (ROADMAP Queue 3 item 3),
which flips a spin only where ``tanh(gain·I) + u`` lies within an ulp of
zero; no element of these seeds does, so spins are compared for equality.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lattice_update import lattice_vertical_update_pallas
from repro.kernels.ref import lattice_vertical_update_ref as jax_oracle
from repro_torch.kernels.lattice_update import (
    lattice_vertical_update,
    lattice_vertical_update_ref,
)

K = 4


def _dyadic(rng, shape, scale):
    return (rng.integers(-scale, scale + 1, size=shape) / 256.0).astype(
        np.float32)


def _problem(B, R, C, seed):
    """Spin planes, dyadic couplings and biases, gains, noise and the
    global cell parity, as numpy."""
    rng = np.random.default_rng(seed)
    sp = lambda *s: (rng.integers(0, 2, s) * 2 - 1).astype(  # noqa: E731
        np.float32)
    return dict(
        m_v=sp(B, R, C, K), m_h=sp(B, R, C, K), m_v_up=sp(B, R, C, K),
        m_v_dn=sp(B, R, C, K), W_vh=_dyadic(rng, (R, C, K, K), 128),
        wv_up=_dyadic(rng, (R, C, K), 256),
        wv_dnin=_dyadic(rng, (R, C, K), 256),
        h=_dyadic(rng, (R, C, K), 80),
        gain=(1 + 0.1 * rng.normal(size=(R, C, K))).astype(np.float32),
        u=rng.uniform(-1, 1, (B, R, C, K)).astype(np.float32),
        parity=(np.add.outer(np.arange(R), np.arange(C)) % 2).astype(
            np.int32))


def _port(p):
    return [torch.from_numpy(p[k]) for k in p]


def _jax(p):
    return [jnp.asarray(p[k]) for k in p]


@pytest.mark.parametrize("color", [0, 1])
@pytest.mark.parametrize("B,R,C,br", [(2, 8, 8, 4), (4, 16, 4, 8),
                                      (1, 8, 32, 8)])
def test_lattice_update_matches_reference_kernel(B, R, C, br, color):
    p = _problem(B, R, C, B * R + C)
    got = lattice_vertical_update(*_port(p), color)
    want = lattice_vertical_update_pallas(*_jax(p), color=color, block_r=br,
                                          interpret=True)
    oracle = jax_oracle(*_jax(p), color)
    assert got.dtype == torch.float32 and got.shape == (B, R, C, K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    # only the cells of the colour moved; the rest keep their spins
    keep = np.broadcast_to((p["parity"] != color)[None, :, :, None],
                           got.shape)
    np.testing.assert_array_equal(got.numpy()[keep], p["m_v"][keep])
    assert (got.numpy()[~keep] != p["m_v"][~keep]).any()


@pytest.mark.parametrize("B,R,C", [(3, 5, 3), (2, 13, 7)])
def test_lattice_update_ragged_rows_match_oracle(B, R, C):
    """R not a multiple of the reference's row tile (its kernel asserts
    R % block_r == 0; the port's has no such precondition): held against
    the reference's plain oracle, both colours."""
    p = _problem(B, R, C, 100 + R)
    for color in (0, 1):
        got = lattice_vertical_update(*_port(p), color)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_oracle(*_jax(p), color)))


def test_lattice_update_input_is_the_ascending_sum():
    """With couplings that are not dyadic the plain version's input is the
    Pallas kernel's float32 sum: ``h``, then the vertical terms, then the
    in-cell terms in ascending j; its decision equals a float32 loop in
    numpy that adds the terms in that order."""
    rng = np.random.default_rng(5)
    p = _problem(2, 4, 4, 6)
    p["W_vh"] = rng.normal(size=p["W_vh"].shape).astype(np.float32)
    p["h"] = rng.normal(size=p["h"].shape).astype(np.float32)
    I = (p["h"] + p["wv_dnin"] * p["m_v_up"]).astype(np.float32)
    I = (I + p["wv_up"] * p["m_v_dn"]).astype(np.float32)
    for j in range(K):
        I = (I + p["W_vh"][..., j] * p["m_h"][..., j:j + 1]).astype(
            np.float32)
    dec = np.tanh(p["gain"] * I).astype(np.float32) + p["u"]
    sure = np.abs(dec) > 1e-5          # numpy's tanh vs torch's last place
    want = np.where(dec >= 0, 1.0, -1.0).astype(np.float32)
    for color in (0, 1):
        got = lattice_vertical_update_ref(*_port(p), color).numpy()
        upd = np.broadcast_to((p["parity"] == color)[None, :, :, None],
                              got.shape)
        np.testing.assert_array_equal(got[upd & sure], want[upd & sure])
        np.testing.assert_array_equal(got[~upd], p["m_v"][~upd])


@pytest.mark.parametrize("color", [0, 1])
def test_lattice_update_adds_in_the_reference_kernels_order(color):
    """Couplings whose partial sums round: ``wv_dnin·m_v_up = 2^25``,
    ``wv_up·m_v_dn = -2^25``, ``h = 0`` and in-cell terms summing to 1.0.
    In the Pallas kernel's order (vertical terms first) I = 1; in the
    order that adds the in-cell terms first, 2^25 + 1 rounds to 2^25 and
    I = 0.  A gain of 100 saturates tanh to exactly 1.0 or leaves 0.0, and
    u = -0.5 turns that into +1 or -1: the port must give +1, as the
    kernel does, on every updated node."""
    B, R, C = 2, 8, 4
    p = _problem(B, R, C, 7)
    big = np.float32(2.0 ** 25)
    p["wv_dnin"] = (big * p["m_v_up"][0]).astype(np.float32)
    p["wv_up"] = (-big * p["m_v_dn"][0]).astype(np.float32)
    p["m_v_up"][:] = p["m_v_up"][:1]     # one plane for every chain
    p["m_v_dn"][:] = p["m_v_dn"][:1]
    p["h"] = np.zeros_like(p["h"])
    # each in-cell term is w_ij·m_j = +0.25: the four sum to 1.0
    p["W_vh"] = (0.25 * p["m_h"][0][..., None, :]
                 * np.ones((1, 1, K, 1))).astype(np.float32)
    p["m_h"][:] = p["m_h"][:1]
    p["gain"] = np.full_like(p["gain"], 100.0)
    p["u"] = np.full_like(p["u"], -0.5)
    want = np.asarray(lattice_vertical_update_pallas(
        *_jax(p), color=color, block_r=4, interpret=True))
    got = lattice_vertical_update(*_port(p), color).numpy()
    upd = np.broadcast_to((p["parity"] == color)[None, :, :, None],
                          got.shape)
    assert (want[upd] == 1.0).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[~upd], p["m_v"][~upd])


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """Dispatch on the tensor's device alone, no try/except around the
    launch, no library call standing in for the kernel."""
    src_path = (Path(__file__).resolve().parent.parent / "src" /
                "repro_torch" / "kernels" / "lattice_update.py")
    src = src_path.read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef)
              and n.name == "lattice_vertical_update")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "lattice_vertical_update_ref"]
    assert len(calls) == 1
    body = ast.get_source_segment(src, fn)
    assert "einsum" not in body and "torch.compile" not in body
    before = lattice_vertical_update.launches
    p = _problem(1, 2, 2, 0)
    lattice_vertical_update(*_port(p), 0)
    assert lattice_vertical_update.launches == before   # no kernel on CPU
