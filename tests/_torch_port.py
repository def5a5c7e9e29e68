"""Helpers for the port's parity tests: move reference state to the port.

State crosses as numpy only, through `repro_torch.convert` — the two
packages never see each other's objects.
"""
import jax
import numpy as np

from repro_torch import convert


def leaves(tree):
    """numpy leaves of a reference pytree (None fields dropped)."""
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def port_chip(ref_chip):
    return convert.chip_from_numpy(leaves(ref_chip), device="cpu")


def port_mismatch(ref_mismatch):
    return convert.mismatch_from_numpy(leaves(ref_mismatch), device="cpu")


def assert_chip_close(port, ref, rtol=1e-6):
    """Programmed chips agree to float32 rounding: 1e-6 relative (the
    8-term DAC sum may associate differently in the two frameworks)."""
    for name in ("W", "h", "tanh_gain", "tanh_offset", "rand_gain",
                 "comp_offset", "nbr_w"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.numpy().dtype == np.float32, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=1e-7, err_msg=name)
    assert (port.nbr_idx is None) == (ref.nbr_idx is None)
    if port.nbr_idx is not None:
        np.testing.assert_array_equal(port.nbr_idx.numpy(),
                                      np.asarray(ref.nbr_idx))
