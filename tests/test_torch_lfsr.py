"""Port vs reference: the integer noise streams, bit for bit.

The reference computes in uint32; the port's plain functions compute in
int64 masked to 32 bits and carry public state as int32 bit patterns.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lfsr as ref_lfsr
from repro.core.chimera import make_chimera
from repro_torch import convert
from repro_torch.core import lfsr as port_lfsr

EDGE_WORDS = np.array(
    [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xDEADBEEF, 0xFFFFFFFE,
     0xFFFFFFFF, 0x0000FFFF, 0xFFFF0000, 0x80200003], np.uint32)


def _words(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    flat = w.reshape(-1)
    flat[:min(flat.size, EDGE_WORDS.size)] = EDGE_WORDS[:flat.size]
    return w


def _u64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _as_u32(t):
    return t.numpy().astype(np.uint32)


def test_mix32_bit_exact():
    w = _words(0, (4096,))
    np.testing.assert_array_equal(
        np.asarray(ref_lfsr.mix32(jnp.asarray(w))),
        _as_u32(port_lfsr.mix32(_u64(w))))


@pytest.mark.parametrize("seed,ctr", [
    (0, 0), (1, 1), (0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFE, 0xFFFFFFFD),
    (0x80000000, 0x7FFFFFFF), (123456789, 2 ** 32 - 2), (2 ** 32 - 5, 17)])
def test_counter_bits_bit_exact(seed, ctr):
    """Seeds and counters near 2^32: every multiply wraps in the
    reference and must wrap identically here."""
    rows = np.concatenate([np.arange(9), [2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]])
    cols = np.concatenate([np.arange(33), [2 ** 32 - 7, 2 ** 31 + 3]])
    want = np.asarray(ref_lfsr.counter_bits(
        jnp.uint32(seed), jnp.uint32(ctr),
        jnp.asarray(rows.astype(np.uint32))[:, None],
        jnp.asarray(cols.astype(np.uint32))[None, :]))
    got = port_lfsr.counter_bits(
        seed, ctr, torch.from_numpy(rows)[:, None],
        torch.from_numpy(cols)[None, :])
    np.testing.assert_array_equal(want, _as_u32(got))
    want_u = np.asarray(ref_lfsr.counter_uniform(
        jnp.uint32(seed), jnp.uint32(ctr),
        jnp.asarray(rows.astype(np.uint32))[:, None],
        jnp.asarray(cols.astype(np.uint32))[None, :]))
    got_u = port_lfsr.counter_uniform(
        seed, ctr, torch.from_numpy(rows)[:, None],
        torch.from_numpy(cols)[None, :])
    assert got_u.dtype == torch.float32
    np.testing.assert_array_equal(want_u, got_u.numpy())


def test_counter_bits_takes_public_state_tensors():
    """seed/ctr as int32 bit-pattern tensors (negative = high bit set)."""
    state = convert.noise_state_from_numpy(
        np.array([0xFFFFFFF0, 0xFFFFFFFF], np.uint32), device="cpu")
    assert state.dtype == torch.int32 and int(state[0]) < 0
    rows, cols = torch.arange(4)[:, None], torch.arange(16)[None, :]
    want = np.asarray(ref_lfsr.counter_bits(
        jnp.uint32(0xFFFFFFF0), jnp.uint32(0xFFFFFFFF),
        jnp.arange(4, dtype=jnp.uint32)[:, None],
        jnp.arange(16, dtype=jnp.uint32)[None, :]))
    np.testing.assert_array_equal(
        want, _as_u32(port_lfsr.counter_bits(state[0], state[1], rows, cols)))


@pytest.mark.parametrize("n", [1, 8, 37])
def test_lfsr_step_n_bit_exact(n):
    w = _words(n, (6, 50))
    np.testing.assert_array_equal(
        np.asarray(ref_lfsr.lfsr_step_n(jnp.asarray(w), n)),
        _as_u32(port_lfsr.lfsr_step_n(_u64(w), n)))


def test_byte_maps_bit_exact():
    b = np.arange(256, dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(ref_lfsr.reverse_byte_bits_swar(jnp.asarray(b))),
        _as_u32(port_lfsr.reverse_byte_bits_swar(_u64(b))))
    u = port_lfsr.byte_to_uniform(_u64(b))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        np.asarray(ref_lfsr.byte_to_uniform(jnp.asarray(b))), u.numpy())
    np.testing.assert_array_equal(
        u.numpy(), ((b.astype(np.float32) - np.float32(127.5))
                    / np.float32(128.0)))


def test_flat_cell_uniforms_bit_exact():
    w = _words(3, (5, 9))
    np.testing.assert_array_equal(
        np.asarray(ref_lfsr.flat_cell_uniforms(jnp.asarray(w))),
        port_lfsr.flat_cell_uniforms(_u64(w)).numpy())


def _scatter_tables(g):
    cells = sorted({(int(r), int(c)) for r, c in zip(g.node_r, g.node_c)})
    vert = np.stack([g.cell_nodes(r, c, side=0) for r, c in cells])
    horiz = np.stack([g.cell_nodes(r, c, side=1) for r, c in cells])
    return vert, horiz


@pytest.mark.parametrize("masked", [(), ((0, 1), (2, 2))])
def test_node_gather_perm_and_graph_uniforms(masked):
    g = make_chimera(3, 3, masked_cells=masked)
    vert, horiz = _scatter_tables(g)
    want_perm = ref_lfsr.node_gather_perm(vert, horiz, g.n_nodes)
    got_perm = port_lfsr.node_gather_perm(vert, horiz, g.n_nodes)
    assert want_perm.dtype == got_perm.dtype
    np.testing.assert_array_equal(want_perm, got_perm)

    state = _words(5, (4, vert.shape[0]))
    state[state == 0] = 1
    want_st, want_u = ref_lfsr.lfsr_uniform_for_graph(
        jnp.asarray(state), None, None, g.n_nodes, 8,
        gather_perm=jnp.asarray(want_perm))
    got_st, got_u = port_lfsr.lfsr_uniform_for_graph(
        convert.noise_state_from_numpy(state, device="cpu"),
        torch.from_numpy(got_perm.astype(np.int64)), 8)
    assert got_st.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want_st),
                                  convert.noise_state_to_numpy(got_st))
    np.testing.assert_array_equal(np.asarray(want_u), got_u.numpy())


def test_noise_state_round_trip_bit_for_bit():
    for shape in ((2,), (7, 13)):
        w = _words(9, shape)
        t = convert.noise_state_from_numpy(w, device="cpu")
        assert t.dtype == torch.int32 and tuple(t.shape) == shape
        back = convert.noise_state_to_numpy(t)
        assert back.dtype == np.uint32
        np.testing.assert_array_equal(back, w)
        np.testing.assert_array_equal(
            _as_u32(port_lfsr.to_u64(t)), w)
        assert torch.equal(port_lfsr.from_u64(port_lfsr.to_u64(t)), t)


def test_seed_states_nonzero_and_reproducible():
    a = port_lfsr.seed_states(torch.Generator().manual_seed(4), (64, 55))
    b = port_lfsr.seed_states(torch.Generator().manual_seed(4), (64, 55))
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert bool((a != 0).all())
    # like the reference's: (roughly) uniform over all 32 bits
    ref = np.asarray(ref_lfsr.seed_states(jax.random.PRNGKey(0), (64, 55)))
    hi_ref = (ref >> 31).mean()
    hi = (convert.noise_state_to_numpy(a) >> 31).mean()
    assert abs(hi - 0.5) < 0.05 and abs(hi_ref - 0.5) < 0.05


def test_entry_points_default_to_the_card_or_the_generator():
    """`seed_states` draws on its generator's device unless told otherwise;
    `state_from_numpy` defaults to the card, as `convert.noise_state_from_
    numpy` does (callers that want the CPU say so)."""
    import inspect

    st = port_lfsr.seed_states(torch.Generator().manual_seed(1), (3, 5))
    assert st.device.type == "cpu"
    default = inspect.signature(port_lfsr.state_from_numpy).parameters[
        "device"].default
    assert default == "cuda" == inspect.signature(
        convert.noise_state_from_numpy).parameters["device"].default
    w = _words(2, (4,))
    t = port_lfsr.state_from_numpy(w, device="cpu")
    np.testing.assert_array_equal(port_lfsr.state_to_numpy(t), w)


# -- the per-cell helpers, and twins of tests/test_lfsr.py on the port ------

def test_cell_bytes_and_byte_reversal_table_bit_exact():
    w = _words(12, (7, 11))
    np.testing.assert_array_equal(
        np.asarray(ref_lfsr.cell_bytes(jnp.asarray(w))),
        _as_u32(port_lfsr.cell_bytes(_u64(w))))
    b = np.arange(256, dtype=np.uint32)
    rev = port_lfsr.reverse_bytes_bits(_u64(b))
    assert rev.dtype == torch.int64
    np.testing.assert_array_equal(
        np.asarray(ref_lfsr.reverse_bytes_bits(jnp.asarray(b))),
        _as_u32(rev))
    # the table and the shift/mask form agree on every byte
    assert torch.equal(rev, port_lfsr.reverse_byte_bits_swar(_u64(b)))


@pytest.mark.parametrize("decimation", [1, 8, 13])
def test_cell_and_next_uniforms_bit_exact(decimation):
    w = _words(20 + decimation, (6, 9))
    w[w == 0] = 1
    rv, rh = ref_lfsr.cell_uniforms(jnp.asarray(w))
    pv, ph = port_lfsr.cell_uniforms(_u64(w))
    assert pv.dtype == ph.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(rv), pv.numpy())
    np.testing.assert_array_equal(np.asarray(rh), ph.numpy())
    r_st, r_v, r_h = ref_lfsr.next_uniforms(jnp.asarray(w), decimation)
    p_st, p_v, p_h = port_lfsr.next_uniforms(_u64(w), decimation)
    np.testing.assert_array_equal(np.asarray(r_st), _as_u32(p_st))
    np.testing.assert_array_equal(np.asarray(r_v), p_v.numpy())
    np.testing.assert_array_equal(np.asarray(r_h), p_h.numpy())
    # the default is the chip's decimation of 8
    d_st, _, _ = port_lfsr.next_uniforms(_u64(w))
    assert torch.equal(d_st, port_lfsr.lfsr_step_n(_u64(w), 8))


def test_byte_reversal_table():
    b = torch.arange(256, dtype=torch.int64)
    r = port_lfsr.reverse_bytes_bits(b)
    assert torch.equal(port_lfsr.reverse_bytes_bits(r), b)
    assert int(r[0b00000001]) == 0b10000000


def _seeded(seed, shape):
    return port_lfsr.to_u64(
        port_lfsr.seed_states(torch.Generator().manual_seed(seed), shape))


def test_uniformity_chi2():
    """Bytes from the decimated LFSR should be ~uniform (chip's RNG DAC)."""
    s = _seeded(1, (128,))
    counts = np.zeros(256)
    for _ in range(200):
        s, v, h = port_lfsr.next_uniforms(s, decimation=8)
        by = (v * 128.0 + 127.5).numpy().astype(np.int64).reshape(-1)
        np.add.at(counts, by, 1)
    expected = counts.sum() / 256
    chi2 = ((counts - expected) ** 2 / expected).sum()
    # dof=255; mean 255, sd ~22.6 — allow 6 sigma
    assert chi2 < 255 + 6 * 22.6, chi2


def test_reversed_sequence_correlation_benign():
    """Horizontal nodes reuse bit-reversed bytes: the two streams are only
    weakly correlated."""
    s = _seeded(2, (256,))
    vs, hs = [], []
    for _ in range(100):
        s, v, h = port_lfsr.next_uniforms(s)
        vs.append(v.numpy().reshape(-1))
        hs.append(h.numpy().reshape(-1))
    corr = np.corrcoef(np.concatenate(vs), np.concatenate(hs))[0, 1]
    assert abs(corr) < 0.05, corr
