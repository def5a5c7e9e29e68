"""Port vs reference: the analog hardware model on the reference's drawn
mismatch.  Codes and tables equal; programmed chips to 1e-6 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hardware as ref_hw
from repro.core.chimera import make_chimera
from repro_torch.core import hardware as port_hw
from repro_torch.kernels.ref import scatter_edge_slots

from _torch_port import assert_chip_close, leaves, port_chip, port_mismatch

GRAPHS = {"2x2": dict(rows=2, cols=2),
          "masked_3x3": dict(rows=3, cols=3, masked_cells=[(1, 1)])}


def _codes(g, seed):
    rng = np.random.default_rng(seed)
    n = g.n_nodes
    vals = rng.integers(-128, 128, size=g.n_edges)
    vals[:4] = (-128, 127, 0, 1)          # DAC end points and a disabled edge
    J = np.zeros((n, n), np.int32)
    J[g.edges[:, 0], g.edges[:, 1]] = vals
    J[g.edges[:, 1], g.edges[:, 0]] = vals
    h = rng.integers(-128, 128, size=n).astype(np.int32)
    return J, h, vals.astype(np.int32)


def test_hardware_config_matches():
    for f in dataclasses.fields(ref_hw.HardwareConfig):
        assert getattr(ref_hw.HardwareConfig(), f.name) == \
            getattr(port_hw.HardwareConfig(), f.name)
    assert port_hw.HardwareConfig.ideal().is_ideal()
    assert (port_hw.WMIN, port_hw.WMAX) == (ref_hw.WMIN, ref_hw.WMAX)


def test_quantize_codes_equal():
    rng = np.random.default_rng(0)
    w = np.concatenate([
        rng.normal(size=500) * 80.0,
        np.arange(-6, 7) + 0.5,                    # ties: round half to even
        [-1e4, 1e4, -128.5, 127.5, 126.5, -127.5]]).astype(np.float32)
    for lsb in (1.0, 0.5, 3.0):
        want = np.asarray(ref_hw.quantize_codes(jnp.asarray(w), lsb))
        got = port_hw.quantize_codes(torch.from_numpy(w), lsb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())


def test_dac_transfer_matches():
    rng = np.random.default_rng(1)
    code = np.arange(-128, 128, dtype=np.int32)
    err = (rng.normal(size=(256, 8)) * 0.04).astype(np.float32)
    want = np.asarray(ref_hw.dac_transfer(jnp.asarray(code),
                                          jnp.asarray(err)))
    got = port_hw.dac_transfer(torch.from_numpy(code), torch.from_numpy(err))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # an ideal DAC is the identity on codes, exactly
    ideal = port_hw.dac_transfer(torch.from_numpy(code), torch.zeros(256, 8))
    np.testing.assert_array_equal(ideal.numpy(), code.astype(np.float32))


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("compression", [3e-3, 0.0])
def test_program_weights_matches(name, compression):
    g = make_chimera(**GRAPHS[name])
    cfg_kw = dict(compression=compression)
    ref_cfg, port_cfg = (ref_hw.HardwareConfig(**cfg_kw),
                         port_hw.HardwareConfig(**cfg_kw))
    mism = ref_hw.sample_mismatch(jax.random.PRNGKey(3), g.n_nodes, ref_cfg)
    J, h, _ = _codes(g, 2)
    enable = np.abs(J) > 0
    nbr_idx, _ = g.neighbor_table()
    want = ref_hw.program_weights(
        jnp.asarray(J), jnp.asarray(h), jnp.asarray(enable), mism, ref_cfg,
        adjacency=jnp.asarray(g.adjacency()), neighbors=jnp.asarray(nbr_idx))
    pm = port_mismatch(mism)
    assert isinstance(pm, port_hw.Mismatch)
    got = port_hw.program_weights(
        torch.from_numpy(J), torch.from_numpy(h), torch.from_numpy(enable),
        pm, port_cfg, adjacency=torch.from_numpy(g.adjacency()),
        neighbors=torch.from_numpy(nbr_idx))
    assert_chip_close(got, want)
    # attach_sparse gathers W: bit-identical entries within the port
    again = port_hw.attach_sparse(dataclasses.replace(got, nbr_idx=None,
                                                      nbr_w=None), nbr_idx)
    assert torch.equal(again.nbr_w, got.nbr_w)
    rows = np.arange(g.n_nodes)[None, :]
    np.testing.assert_array_equal(got.nbr_w.numpy(),
                                  got.W.numpy()[rows, nbr_idx])


@pytest.mark.parametrize("name", list(GRAPHS))
def test_from_dense_and_sparse_programming_match(name):
    g = make_chimera(**GRAPHS[name])
    cfg = ref_hw.HardwareConfig()
    nbr_idx, nbr_mask = g.neighbor_table()
    slot_ij, slot_ji = g.edge_slots(nbr_idx)
    dense = ref_hw.sample_mismatch(jax.random.PRNGKey(5), g.n_nodes, cfg)
    ref_sparse = ref_hw.SparseMismatch.from_dense(dense,
                                                  jnp.asarray(nbr_idx))
    got_sparse = port_hw.SparseMismatch.from_dense(port_mismatch(dense),
                                                   nbr_idx)
    for a, b in zip(leaves(ref_sparse), dataclasses.astuple(got_sparse)):
        np.testing.assert_array_equal(a, b.numpy())   # a gather: exact
    assert isinstance(port_mismatch(ref_sparse), port_hw.SparseMismatch)

    J, h, edge_codes = _codes(g, 6)
    ref_slots = np.asarray(jnp.asarray(J)[np.arange(g.n_nodes)[None, :],
                                          nbr_idx])
    got_slots = scatter_edge_slots(
        torch.from_numpy(edge_codes), torch.from_numpy(g.edges).long(),
        torch.from_numpy(slot_ij).long(), torch.from_numpy(slot_ji).long(),
        nbr_idx.shape[0], g.n_nodes)
    np.testing.assert_array_equal(got_slots.numpy(), ref_slots * nbr_mask)

    want = ref_hw.program_weights_sparse(
        jnp.asarray(ref_slots), jnp.asarray(h),
        jnp.abs(jnp.asarray(ref_slots)) > 0, ref_sparse, cfg,
        jnp.asarray(nbr_idx), jnp.asarray(nbr_mask))
    got = port_hw.program_weights_sparse(
        got_slots, torch.from_numpy(h), torch.abs(got_slots) > 0,
        got_sparse, port_hw.HardwareConfig(), nbr_idx, nbr_mask)
    assert got.W is None and got.degree == nbr_idx.shape[0]
    assert_chip_close(got, want)


def test_ideal_chip_and_chip_round_trip():
    g = make_chimera(2, 2)
    J, h, _ = _codes(g, 7)
    nbr_idx, _ = g.neighbor_table()
    want = ref_hw.ideal_chip(jnp.asarray(J), jnp.asarray(h),
                             jnp.asarray(g.adjacency()),
                             neighbors=jnp.asarray(nbr_idx))
    got = port_hw.ideal_chip(J, h, g.adjacency(), neighbors=nbr_idx,
                             device="cpu")
    assert_chip_close(got, want, rtol=0)
    carried = port_chip(want)                 # 8 leaves, both layouts
    assert_chip_close(carried, want, rtol=0)
    assert carried.nbr_idx.dtype == torch.int32
    assert carried.to("cpu").n_nodes == g.n_nodes


def test_sample_mismatch_statistics():
    """Draws agree with the reference's in distribution only."""
    cfg = port_hw.HardwareConfig()
    gen = torch.Generator().manual_seed(0)
    m = port_hw.sample_mismatch(gen, 64, cfg, device="cpu")
    s = port_hw.sample_mismatch_sparse(gen, 512, 6, cfg, device="cpu")
    ref = ref_hw.sample_mismatch(jax.random.PRNGKey(0), 64,
                                 ref_hw.HardwareConfig())
    for name, sigma in (("dac_bit_j", cfg.sigma_dac_bit),
                        ("edge_gain", cfg.sigma_edge_gain),
                        ("tanh_offset", cfg.sigma_tanh_offset)):
        for draw in (m, s):
            x = getattr(draw, name)
            assert x.dtype == torch.float32
            assert abs(float(x.std()) / sigma - 1.0) < 0.15, name
        assert getattr(m, name).shape == np.asarray(getattr(ref, name)).shape
    assert s.dac_bit_j.shape == (6, 512, 8) and s.leak.shape == (6, 512)
    assert bool((m.leak >= 0).all()) and bool((s.leak >= 0).all())
    zero = port_hw.sample_mismatch(gen, 8, port_hw.HardwareConfig.ideal(),
                                   device="cpu")
    assert all(float(t.abs().sum()) == 0.0
               for t in dataclasses.astuple(zero))
