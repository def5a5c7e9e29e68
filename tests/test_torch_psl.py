"""Port vs reference: the PSL compiler, `full_adder_inference`, the exports.

The same circuits, graphs and numpy states go through `repro.psl` and
`repro_torch.psl`:

* the exact layer (numpy in both): synthesized Hamiltonians, their
  ground sets, embeddings (chains, codes, scale, stats, errors), clamp
  arrays and decoded `Readout`s are equal, bit for bit;
* the default mismatch under the ideal hardware is all zeros in both;
* one compiled AND and one 2-bit adder, run forward on ``sparse`` and
  ``fused_sparse`` (the port's plain versions; the reference's Pallas
  kernel in interpret mode) from the same numpy spins and counter noise
  state with the reference's betas passed to both, give equal spins,
  noise states and readouts;
* the reference's statistical tests (`tests/test_psl.py`, the PSL
  inference of `tests/test_system.py`, `examples/factorize.py`'s quick
  mode) run on the port at ``device="cpu"``.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro import psl as ref_psl
from repro.core.chimera import make_chimera as ref_make_chimera
from repro.core.chimera import make_chip_graph as ref_make_chip_graph
from repro.core.hardware import HardwareConfig as RefHardwareConfig
from repro.psl import compile as ref_compile
import repro_torch.core as port_core
from repro_torch import api as port_api
from repro_torch import convert
from repro_torch import psl
from repro_torch.core import tasks
from repro_torch.core.chimera import make_chimera, make_chip_graph
from repro_torch.core.hardware import HardwareConfig
from repro_torch.psl import compile as port_compile

from _torch_port import assert_chip_close, leaves

BUILDERS = {
    "copy": lambda p: p.copy_circuit(),
    "not": lambda p: p.not_circuit(),
    "and": lambda p: p.and_circuit(),
    "or": lambda p: p.or_circuit(),
    "xor": lambda p: p.xor_circuit(),
    "full_adder": lambda p: p.full_adder_circuit(),
    "adder1": lambda p: p.ripple_adder_circuit(1),
    "adder2": lambda p: p.ripple_adder_circuit(2),
    "adder2_cin": lambda p: p.ripple_adder_circuit(2, with_cin=True),
    "mult2": lambda p: p.multiplier_circuit(2),
}


def _both(name):
    return (BUILDERS[name](ref_psl).synthesize(),
            BUILDERS[name](psl).synthesize())


def _ground_set(logical):
    """Exact enumeration: the min-energy ±1 states and the gap."""
    states = np.asarray(list(itertools.product((-1, 1),
                                               repeat=logical.n_spins)),
                        np.int8)
    Jd, h = logical.dense()
    s = states.astype(np.float64)
    e = -0.5 * np.einsum("si,ij,sj->s", s, Jd, s) - s @ h
    ground = states[np.isclose(e, e.min())]
    return {tuple(r) for r in ground}, float(
        e[~np.isclose(e, e.min())].min() - e.min())


# ---------------------------------------------------------------------------
# the exact layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(BUILDERS))
def test_synthesize_is_bit_equal(name):
    ref, port = _both(name)
    assert port.n_spins == ref.n_spins and port.names == ref.names
    for f in ("edges", "J", "h"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (port.inputs, port.outputs, port.ports) == (
        ref.inputs, ref.outputs, ref.ports)
    assert [(c.gate, c.spins, c.table) for c in port.clauses] == [
        (c.gate, c.spins, c.table) for c in ref.clauses]
    assert port.max_coupling == ref.max_coupling
    np.testing.assert_array_equal(port.degrees(), ref.degrees())


@pytest.mark.parametrize("name", list(BUILDERS))
def test_ground_set_equals_reference_and_truth_table(name):
    ref, port = _both(name)
    ground, gap = _ground_set(port)
    assert (ground, gap) == _ground_set(ref)
    assert gap > 0
    assert ground == {tuple(r) for r in port.valid_assignments()}
    np.testing.assert_array_equal(port.valid_assignments(),
                                  ref.valid_assignments())


def test_builder_rejects_bad_input_as_the_reference_does():
    c = psl.PCircuit()
    i = c.spin("x")
    with pytest.raises(ValueError, match="self-coupling"):
        c.add_coupling(i, i, 1.0)
    with pytest.raises(ValueError, match="out of range"):
        c.add_coupling(i, i + 1, 1.0)
    c.mark_input("p", i)
    with pytest.raises(ValueError, match="already declared"):
        c.mark_output("p", i)
    with pytest.raises(KeyError):
        c.synthesize().port("q")
    with pytest.raises(ValueError, match="2\\^N"):
        psl.multiplier_circuit(3).synthesize().valid_assignments()
    for n in (1, 3, 5):
        for v in range(1 << n):
            assert int(psl.bits_to_int(psl.int_to_spins(v, n))) == v
            np.testing.assert_array_equal(psl.int_to_spins(v, n),
                                          ref_psl.int_to_spins(v, n))
    with pytest.raises(ValueError):
        psl.int_to_spins(8, 3)


# (circuit, graph args, embed kwargs): masked, non-square, pinned, the chip
EMBED_CASES = {
    "and_1x1": ("and", (1, 1), {}, {}),
    "and_origin": ("and", (2, 2), {"masked_cells": [(0, 0)]},
                   {"origin": (1, 1)}),
    "and_chain3": ("and", (2, 2), {}, {"chain_scale": 3.0}),
    "full_adder_2x2": ("full_adder", (2, 2), {}, {}),
    "adder2_masked_3x4": ("adder2", (3, 4), {"masked_cells": [(0, 0)]}, {}),
    "adder2_masked_12": ("adder2", (3, 4), {"masked_cells": [(1, 2)]}, {}),
    "mult2_chip": ("mult2", "chip", {}, {}),
    "mult3_chip": ("mult3", "chip", {}, {}),
}


def _graphs(graph, gkw):
    if graph == "chip":
        return ref_make_chip_graph(), make_chip_graph()
    return ref_make_chimera(*graph, **gkw), make_chimera(*graph, **gkw)


def _logicals(name):
    if name == "mult3":
        return (ref_psl.multiplier_circuit(3).synthesize(),
                psl.multiplier_circuit(3).synthesize())
    return _both(name)


@pytest.mark.parametrize("case", list(EMBED_CASES))
def test_embedding_is_bit_exact(case):
    name, graph, gkw, ekw = EMBED_CASES[case]
    rg, pg = _graphs(graph, gkw)
    rl, pl = _logicals(name)
    ref = ref_psl.embed_circuit(rl, rg, **ekw)
    port = psl.embed_circuit(pl, pg, **ekw)
    assert port.window == ref.window and port.n_logical == ref.n_logical
    assert port.chain_nodes == ref.chain_nodes
    for f in ("chain_edge_idx", "coupler_edge_idx", "J_codes", "h_codes"):
        a, b = getattr(port, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert port.chain_strength == ref.chain_strength
    assert port.code_unit == ref.code_unit
    assert port.stats() == ref.stats()
    np.testing.assert_array_equal(port.node_to_logical(),
                                  ref.node_to_logical())
    np.testing.assert_array_equal(port.chain_index(), ref.chain_index())


@pytest.mark.parametrize("name,graph,gkw,origin", [
    ("and", (2, 2), {"masked_cells": [(0, 0)]}, (0, 0)),   # masked cell
    ("and", (2, 2), {"masked_cells": [(0, 0)]}, (2, 0)),   # off the grid
    ("mult2", (2, 2), {}, None),                           # too small
])
def test_embedding_errors_match_the_reference(name, graph, gkw, origin):
    rg, pg = _graphs(graph, gkw)
    rl, pl = _both(name)
    with pytest.raises(ValueError) as ref_err:
        ref_psl.embed_circuit(rl, rg, origin=origin)
    with pytest.raises(ValueError) as port_err:
        psl.embed_circuit(pl, pg, origin=origin)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("name,graph,assignments,chains", [
    ("and", (2, 2), {"a": 1, "b": 0}, 8),
    ("and", (1, 1), {"y": 1}, 3),
    ("adder2", (2, 2), {"a": 3, "b": 2}, 5),
    ("adder2", (2, 2), {"sum": 2, "cout": 0}, 4),
    ("mult2", (3, 3), {"prod": 6}, 2),
])
def test_clamp_arrays_are_equal(name, graph, assignments, chains):
    rg, pg = _graphs(graph, {})
    rl, pl = _both(name)
    ref = ref_psl.clamp_arrays(ref_psl.embed_circuit(rl, rg), rl,
                               assignments, chains)
    port = psl.clamp_arrays(psl.embed_circuit(pl, pg), pl, assignments,
                            chains)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _assert_readouts_equal(port, ref):
    np.testing.assert_array_equal(port.logical, ref.logical)
    np.testing.assert_array_equal(port.broken, ref.broken)
    np.testing.assert_array_equal(port.valid_mask(), ref.valid_mask())
    np.testing.assert_array_equal(port.broken_per_chain(),
                                  ref.broken_per_chain())
    assert port.broken_chain_fraction == ref.broken_chain_fraction
    assert port.summary() == ref.summary()
    names = [n for n, _ in ref.logical_model.ports]
    for n in names:
        assert port.port_counts(n) == ref.port_counts(n)
        assert port.port_mode(n) == ref.port_mode(n)
        assert port.infer(n) == ref.infer(n)
    assert port.joint_counts(names) == ref.joint_counts(names)


@pytest.mark.parametrize("name,graph", [("full_adder", (2, 2)),
                                        ("adder2", (3, 4)),
                                        ("mult2", (3, 3))])
def test_decode_result_is_equal(name, graph):
    """Random states (broken chains, 2-2 ties) and unanimous valid ones,
    with a leading batch shape, decode to the same `Readout`."""
    rg, pg = _graphs(graph, {})
    rl, pl = _both(name)
    remb, pemb = ref_psl.embed_circuit(rl, rg), psl.embed_circuit(pl, pg)
    rng = np.random.default_rng(7)
    noisy = rng.choice(np.array([-1, 1], np.int8), size=(3, 40, pg.n_nodes))
    valid = pl.valid_assignments()
    clean = noisy[:1].copy()
    for s, row in enumerate(valid[rng.integers(0, len(valid), 40)]):
        for spin, ch in zip(row, pemb.chain_nodes):
            clean[0, s, list(ch)] = spin
    states = np.concatenate([noisy, clean])
    _assert_readouts_equal(psl.decode_result(pl, pemb, states),
                           ref_psl.decode_result(rl, remb, states))
    lp, bp = psl.decode_states(pemb, states[0, 0])
    lr, br = ref_psl.decode_states(remb, states[0, 0])
    np.testing.assert_array_equal(lp, lr)
    np.testing.assert_array_equal(bp, br)


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_default_mismatch_under_ideal_hardware_is_exactly_equal(dense):
    rg, pg = ref_make_chip_graph(), make_chip_graph()
    ref = ref_compile._default_mismatch(rg, RefHardwareConfig.ideal(), dense,
                                        None)
    port = port_compile._default_mismatch(pg, HardwareConfig.ideal(), dense,
                                          None, "cpu")
    got = convert.mismatch_from_numpy(leaves(ref), device="cpu")
    assert type(port) is type(got)
    for f in ("dac_bit_j", "dac_bit_h", "edge_gain", "tanh_gain",
              "tanh_offset", "rand_gain", "comp_offset", "leak"):
        a, b = getattr(port, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
        assert not a.any(), f


def test_non_ideal_default_mismatch_is_equal_in_distribution():
    """Under a non-ideal `hw` the seed-0 draws differ (a torch.Generator
    against jax.random, ROADMAP Queue 3 item 15): each field's spread
    is the configured sigma in both, to 15 % (the smallest field has 440
    draws: a 3.4 % standard error)."""
    rg, pg = ref_make_chip_graph(), make_chip_graph()
    ref = ref_psl.compile_circuit(ref_psl.and_circuit(), rg,
                                  hw=RefHardwareConfig())
    port = psl.compile_circuit(psl.and_circuit(), pg, hw=HardwareConfig(),
                               device="cpu")
    r = convert.mismatch_from_numpy(leaves(ref.spec.mismatch), device="cpu")
    p, hw = port.spec.mismatch, HardwareConfig()
    sigma = {"dac_bit_j": hw.sigma_dac_bit, "dac_bit_h": hw.sigma_dac_bit,
             "edge_gain": hw.sigma_edge_gain, "tanh_gain": hw.sigma_tanh_gain,
             "tanh_offset": hw.sigma_tanh_offset,
             "rand_gain": hw.sigma_rand_gain,
             "comp_offset": hw.sigma_comp_offset}
    for f, want in sigma.items():
        a, b = getattr(p, f), getattr(r, f)
        assert a.shape == b.shape, f
        assert not torch.equal(a, b), f
        for got in (a.std().item(), b.std().item()):
            assert abs(got / want - 1.0) < 0.15, (f, got, want)
    assert bool((p.leak >= 0).all()) and bool((r.leak >= 0).all())


@pytest.mark.parametrize("backend", ["auto", "ref", "sparse"])
def test_compiled_spec_matches_the_reference(backend):
    circuit = "adder2"
    rg, pg = _graphs((3, 4), {"masked_cells": [(1, 2)]})
    noise = "philox" if backend == "ref" else "counter"
    ref = ref_psl.compile_circuit(BUILDERS[circuit](ref_psl), rg,
                                  backend=backend, noise=noise)
    port = psl.compile_circuit(BUILDERS[circuit](psl), pg, backend=backend,
                               noise=noise, device="cpu")
    for f in ("chains", "beta", "w_scale", "noise", "backend", "decimation"):
        assert getattr(port.spec, f) == getattr(ref.spec, f), f
    assert port.spec.hw == HardwareConfig.ideal()
    assert (port.spec.schedule.beta_start, port.spec.schedule.beta_end,
            port.spec.schedule.n_sweeps, port.spec.schedule.kind) == (
        ref.spec.schedule.beta_start, ref.spec.schedule.beta_end,
        ref.spec.schedule.n_sweeps, ref.spec.schedule.kind)
    assert type(port.spec.mismatch).__name__ == type(
        ref.spec.mismatch).__name__
    assert port.session().backend == ref.session().backend
    assert port.name == ref.name == "adder2"
    # the one-call path and the compiler's determinism
    again = psl.compile_circuit(BUILDERS[circuit](psl), pg, backend=backend,
                                noise=noise, device="cpu")
    assert again.embedding.chain_nodes == port.embedding.chain_nodes
    np.testing.assert_array_equal(again.embedding.J_codes,
                                  port.embedding.J_codes)
    spec = BUILDERS[circuit](psl).to_spec(pg, backend=backend, noise=noise,
                                          device="cpu")
    assert spec.w_scale == port.spec.w_scale == 1.0 / port.embedding.code_unit
    assert port.session() is port.session() and port.chip() is port.chip()
    assert_chip_close(port.chip(), ref.chip())


def test_compile_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        psl.compile_circuit(psl.and_circuit(), make_chimera(1, 1))
    with pytest.raises(RuntimeError, match="cuda"):
        tasks.full_adder_inference()


def test_run_checks_its_ports():
    cc = psl.compile_circuit(psl.and_circuit(), make_chimera(1, 1),
                             chains=4, n_sweeps=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match=r"forward run needs every input "
                       r"port; missing \['b'\]"):
        cc.run_forward(gen, {"a": 1})
    with pytest.raises(ValueError, match=r"inverse run needs every output "
                       r"port; missing \['y'\]"):
        cc.run_inverse(gen, {})
    r = cc.run(gen)           # nothing clamped: free-running chains
    assert r.n_samples == 4 and r.logical.shape == (4, 3)


def test_a_run_is_one_clamped_kernel_call(monkeypatch):
    """`auto` + counter noise resolves to the slot-layout kernel's engine:
    one `run` is one wrapper call with the clamped chains out of both
    colour masks."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.sweep_sparse

    def recorder(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "sweep_sparse", recorder)
    cc = psl.compile_circuit(psl.and_circuit(), make_chimera(1, 1),
                             chains=16, n_sweeps=20, device="cpu")
    assert cc.session().backend == "fused_sparse"
    cc.run_forward(torch.Generator().manual_seed(1), {"a": 1, "b": 0})
    assert len(calls) == 1
    args, kwargs = calls[0]
    assert args[10].shape == (20, 16)           # every sweep, every chain
    cm = cc.clamp({"a": 1, "b": 0})[0]
    np.testing.assert_array_equal(kwargs["clamp_mask"].numpy(), cm)
    for mask in args[8:10]:                     # both colour masks
        assert not mask[torch.as_tensor(cm)].any()


# ---------------------------------------------------------------------------
# trajectories across packages
# ---------------------------------------------------------------------------
RUN_CASES = [("and", (1, 1), {"a": 1, "b": 0}),
             ("adder2", (2, 2), {"a": 2, "b": 3})]


@pytest.mark.parametrize("backend", ["sparse", "fused_sparse"])
@pytest.mark.parametrize("name,graph,inputs", RUN_CASES,
                         ids=[c[0] for c in RUN_CASES])
def test_forward_run_equals_the_reference(name, graph, inputs, backend):
    """The same m0, counter noise state and the reference's geometric
    betas (passed to both: the port's own differ in the last place on a
    few entries, ROADMAP Queue 3 item 1) give equal spins."""
    chains, sweeps = 8, 30
    rg, pg = _graphs(graph, {})
    ref = ref_psl.compile_circuit(BUILDERS[name](ref_psl), rg,
                                  backend=backend, chains=chains,
                                  n_sweeps=sweeps)
    port = psl.compile_circuit(BUILDERS[name](psl), pg, backend=backend,
                               chains=chains, n_sweeps=sweeps, device="cpu")
    betas = np.asarray(ref.spec.schedule.betas(chains))
    rng = np.random.default_rng(11)
    m0 = rng.choice(np.array([-1.0, 1.0], np.float32), size=(chains,
                                                             pg.n_nodes))
    ns = rng.integers(0, 2 ** 32, size=(2,), dtype=np.uint64).astype(
        np.uint32)
    cm, cv = ref.clamp(inputs)
    r_m, r_ns, _ = ref.session().sample(
        ref.chip(), jnp.asarray(m0), jnp.asarray(ns), jnp.asarray(betas),
        clamp_mask=jnp.asarray(cm), clamp_values=jnp.asarray(cv))
    pcm, pcv = port.clamp(inputs)
    p_m, p_ns, _ = port.session().sample(
        port.chip(), convert.spins_from_numpy(m0, "cpu"),
        convert.noise_state_from_numpy(ns, "cpu"), betas,
        clamp_mask=torch.as_tensor(pcm), clamp_values=torch.as_tensor(pcv))
    assert port.session().backend == ref.session().backend == backend
    np.testing.assert_array_equal(p_m.numpy(), np.asarray(r_m))
    np.testing.assert_array_equal(convert.noise_state_to_numpy(p_ns),
                                  np.asarray(r_ns))
    _assert_readouts_equal(
        psl.decode_result(port.logical, port.embedding, p_m.numpy()),
        ref_psl.decode_result(ref.logical, ref.embedding, np.asarray(r_m)))


# ---------------------------------------------------------------------------
# the reference's statistical tests, on the port's plain versions
# ---------------------------------------------------------------------------
STAT_BACKENDS = [("ref", "philox"), ("sparse", "counter"),
                 ("fused_sparse", "counter")]


@pytest.mark.parametrize("backend,noise", STAT_BACKENDS,
                         ids=[b for b, _ in STAT_BACKENDS])
def test_and_gate_forward_and_inverse(backend, noise):
    cc = psl.compile_circuit(psl.and_circuit(), make_chimera(1, 1),
                             backend=backend, noise=noise, chains=32,
                             n_sweeps=200, device="cpu")
    assert cc.session().backend == backend
    gen = torch.Generator().manual_seed(0)
    for a in (0, 1):
        for b in (0, 1):
            r = cc.run_forward(gen, {"a": a, "b": b})
            assert r.infer("y") == (a & b), (a, b, r.port_counts("y"))
    r = cc.run_inverse(gen, {"y": 1})
    assert r.infer("a") == 1 and r.infer("b") == 1
    r = cc.run_inverse(gen, {"y": 0})
    valid = r.valid_mask()
    assert valid.any()
    a_v, b_v = r.port_values("a")[valid], r.port_values("b")[valid]
    assert np.all((a_v & b_v) == 0)


def test_xor_gate_forward_rows():
    cc = psl.compile_circuit(psl.xor_circuit(), make_chimera(1, 1),
                             chains=32, n_sweeps=200, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for a in (0, 1):
        for b in (0, 1):
            r = cc.run_forward(gen, {"a": a, "b": b})
            assert r.infer("y") == (a ^ b), (a, b, r.port_counts("y"))


def test_ripple_adder_end_to_end_on_masked_chimera():
    g = make_chimera(3, 4, masked_cells=[(0, 0)])
    circuit = psl.ripple_adder_circuit(2)
    spec = circuit.to_spec(g, device="cpu")
    session = port_api.Session(spec)
    cc = psl.compile_circuit(circuit, g, device="cpu")
    assert session.program_edges(cc.embedding.J_codes,
                                 cc.embedding.h_codes) is not None
    gen = torch.Generator().manual_seed(2)
    for a in range(4):
        for b in range(4):
            r = cc.run_forward(gen, {"a": a, "b": b})
            total = r.infer("sum") + (r.infer("cout") << 2)
            assert total == a + b, (a, b, total, r.summary())
    r = cc.run_inverse(gen, {"sum": 2, "cout": 0})
    valid = r.valid_mask()
    assert valid.any(), r.summary()
    pairs = {(int(x), int(y)) for x, y in zip(r.port_values("a")[valid],
                                              r.port_values("b")[valid])}
    assert pairs and pairs <= {(0, 2), (1, 1), (2, 0)}, pairs


def test_full_adder_psl_inference():
    out = tasks.full_adder_inference(
        make_chimera(2, 2), gen=torch.Generator().manual_seed(3),
        device="cpu")
    assert out["rows_correct"] >= 7, out["rows"]
    assert out["broken_chain_fraction"] < 0.2
    assert set(out["rows"]) == set(itertools.product((0, 1), repeat=3))
    # gen=None: a generator seeded 0 on the spec's device, drawn per row
    assert tasks.full_adder_inference(device="cpu", chains=8,
                                      n_sweeps=20) == \
        tasks.full_adder_inference(
            device="cpu", chains=8, n_sweeps=20,
            gen=torch.Generator().manual_seed(0))


def test_factorize_quick_mode():
    """`examples/factorize.py` with REPRO_EXAMPLE_QUICK: every clause-valid
    sample is a true factorization, and each product has one."""
    cc = psl.compile_circuit(psl.multiplier_circuit(2), make_chimera(3, 3),
                             chains=64, n_sweeps=400, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for product in (6, 9):
        r = cc.run_inverse(gen, {"prod": product})
        valid = r.valid_mask()
        pairs = set(zip(r.port_values("a")[valid].tolist(),
                        r.port_values("b")[valid].tolist()))
        assert pairs, product
        assert all(a * b == product for a, b in pairs), (product, pairs)


# ---------------------------------------------------------------------------
# the exports
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("port,ref", [(port_core, ref_core), (psl, ref_psl)],
                         ids=["core", "psl"])
def test_exports_equal_the_references(port, ref):
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert getattr(port, name).__name__ == getattr(ref, name).__name__
    assert set(port.__all__) <= set(dir(port))
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")
