"""`repro_torch.launch.dryrun`'s ``--pbit``: the paper's lattice anneal
traced as one rank of a rank mesh (`dryrun.pbit_trace`).

The reference's ``run_pbit`` compiles `make_lattice_anneal` on the
production mesh and reads the compiled module; here one interpreter with 4
forced host devices compiles it on an ``Auto`` 2 x 2 mesh (``row_axes``
``("data", "model")``, 20 sweeps, a record every 10) at
``LatticeSpec(8, 4, chains=1)``, ``LatticeSpec(16, 8, chains=4)`` and the
first in bfloat16, and saves ``argument_size_in_bytes``,
``output_size_in_bytes``, `collective_bytes_from_hlo` and
`dot_flops_from_hlo`.  The port's trace of ranks 0 and 1 of a 2 x 2 rank
mesh, on ``meta`` under a fake process group:

* its argument bytes (the whole lattice and the betas on every rank, and
  the 8 bytes of the reference's key for the port's generator) equal the
  reference's;
* rank 1, an interior band, sends exactly the reference's
  collective-permute bytes, and rank 0, the top band, half of them;
* its one-process FLOPs equal the reference's per-device ``dot_flops``
  (every device computes the whole energy there), and the rank's are a
  quarter: the energy's ``m @ h`` (``aten.mv``) is counted;
* it allocates nothing off ``meta`` and leaves no process group behind.

By design the port gathers each record's spins and partial energies (two
all-gathers a record) where the reference all-reduces the whole spins
(one all-reduce): the port's own figures are pinned here, the
reference's stand beside them in PERF.md.  That a traced rank's record
equals a real gloo rank's, call for call, is held where the ranks run
(`test_torch_ranks.py`).

Repairs on this path: `make_lattice_anneal` builds on ``meta`` (its
mismatch draw's generator is the CPU's there), and `sparse_energy` of a
bfloat16 lattice promotes ``h`` as the reference's ``m @ h`` does (it
raised before).
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import distributed as ref_dist
from repro_torch import convert
from repro_torch.core import distributed as port_dist
from repro_torch.core import ranks
from repro_torch.launch import dryrun

from _torch_port import finish_forced_reference, start_forced_reference

ROOT = Path(__file__).resolve().parent.parent
SWEEPS, EVERY = 20, 10
CASES = {"8x4": (8, 4, 1, "float32"), "16x8x4": (16, 8, 4, "float32"),
         "8x4_bf16": (8, 4, 1, "bfloat16")}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's anneal compiled on a 2 x 2 ``Auto`` mesh of forced
    host devices, each case's figures saved under its name."""
    started = start_forced_reference(f"""
        import jax.numpy as jnp
        sys.path.insert(0, {str(ROOT)!r})
        from benchmarks.roofline import (collective_bytes_from_hlo,
                                         dot_flops_from_hlo)
        from repro.core.distributed import (LatticeSpec, make_lattice_anneal,
                                            make_sk_lattice)
        mesh = auto_mesh((2, 2), ("data", "model"))
        for tag, (R, C, B, dt) in {CASES!r}.items():
            spec = LatticeSpec(R, C, chains=B)
            run = make_lattice_anneal(spec, mesh, row_axes=("data", "model"),
                                      n_sweeps={SWEEPS},
                                      record_every={EVERY})
            chip = jax.eval_shape(lambda k: make_sk_lattice(
                spec, k, dtype=jnp.dtype(dt)), jax.random.PRNGKey(0))
            with mesh:
                compiled = run.lower(
                    chip, jax.ShapeDtypeStruct((2,), jnp.uint32),
                    jax.ShapeDtypeStruct(({SWEEPS},), jnp.float32)).compile()
            ma = compiled.memory_analysis()
            hlo = compiled.as_text()
            save(tag + "/argument_bytes", ma.argument_size_in_bytes)
            save(tag + "/output_bytes", ma.output_size_in_bytes)
            save(tag + "/dot_flops", dot_flops_from_hlo(hlo))
            for op, b in collective_bytes_from_hlo(hlo)[
                    "per_op_bytes"].items():
                save(f"{{tag}}/collectives/{{op}}", b)
    """, 4, tmp_path_factory.mktemp("ref"))
    done = {}

    def result():
        if not done:
            done.update(finish_forced_reference(started, timeout=300))
        return done
    return result


def _want(reference, tag: str, key: str):
    return reference()[f"{tag}/{key}"][0].item()


@pytest.mark.parametrize("tag", list(CASES))
def test_traced_ranks_equal_the_compiled_reference(tag, reference):
    R, C, chains, dt = CASES[tag]
    spec = port_dist.LatticeSpec(R, C, chains=chains)
    got = [dryrun.pbit_trace(spec, {"data": 2, "model": 2},
                             ("data", "model"), rank, SWEEPS, EVERY,
                             getattr(torch, dt)) for rank in (0, 1)]
    assert not dist.is_initialized()
    assert not any(ranks.is_rank_mesh(m) for m in list(ranks._COMMS.keys()))
    permute = _want(reference, tag, "collectives/collective-permute")
    n_rec = SWEEPS // EVERY
    n_loc = spec.n_spins // 4
    for rank, one in enumerate(got):
        assert one["devices"] == ["meta"]
        assert one["argument_bytes"] == _want(reference, tag,
                                              "argument_bytes")
        # the final spins, whole on every rank, and the energies (the
        # reference's module adds its output tuple's table: PERF.md)
        assert one["output_bytes"] == 4 * chains * spec.n_spins + 4 * n_rec
        assert one["flops_global"] == _want(reference, tag, "dot_flops")
        assert one["flops"] == one["flops_global"] / 4
        assert one["temp_bytes"] > 0
        coll = one["collectives"]
        # the top band sends down only; an interior band both ways
        assert coll["bytes"]["exchange"] == permute * (rank + 1) / 2
        assert coll["calls"]["exchange"] == 2 * SWEEPS
        # the port's own: a record's spins and partial energies gathered
        # over the 4 ranks, where the reference all-reduces the spins
        assert coll["calls"] == {"all_reduce": 0, "all_gather": 2 * n_rec,
                                 "reduce_scatter": 0,
                                 "exchange": 2 * SWEEPS}
        assert coll["bytes"]["all_gather"] == n_rec * 4 * chains * (n_loc + 1)
        assert coll["reference"]["per_op_bytes"] == {
            "all-gather": 3.0 * coll["bytes"]["all_gather"],
            "collective-permute": float(coll["bytes"]["exchange"])}
    assert _want(reference, tag, "collectives/all-reduce") > 0


def test_make_lattice_anneal_builds_and_runs_on_meta():
    """On ``meta`` the mismatch draw's generator is the CPU's (torch has
    no meta generator); the anneal runs and allocates nothing."""
    spec = port_dist.LatticeSpec(4, 2, chains=2)
    run = port_dist.make_lattice_anneal(spec, None, n_sweeps=4,
                                        record_every=2, device="meta")
    lat = port_dist.make_sk_lattice(spec, torch.Generator(),
                                    device="meta")
    m, e = run(lat, torch.Generator(), torch.empty(4, device="meta"))
    assert m.device.type == "meta" and m.shape == (2, spec.n_spins)
    assert e.shape == (2,) and run.session._engine is None


def test_bfloat16_lattice_energy_matches_reference():
    """A bfloat16 lattice's energy: ``h`` promoted to the spins' float32,
    as the reference's ``m @ chip.h`` promotes; dyadic couplings, so every
    sum is exact and the two are equal bit for bit."""
    spec = ref_dist.LatticeSpec(4, 4, chains=4)
    lat = ref_dist.make_sk_lattice(spec, jax.random.PRNGKey(3),
                                   dtype=jax.numpy.bfloat16)
    arrays = {f.name: np.round(np.asarray(getattr(lat, f.name), np.float32)
                               * 16.0) / 16.0
              for f in dataclasses.fields(lat)}
    arrays["h_v"] = ((np.arange(arrays["h_v"].size) % 7 - 3) / 8).reshape(
        arrays["h_v"].shape).astype(np.float32)
    ref_lat = ref_dist.LatticeChip(**{
        k: jax.numpy.asarray(v, jax.numpy.bfloat16)
        for k, v in arrays.items()})
    ref_chip = ref_dist.lattice_to_chip(spec, ref_lat)
    port_lat = convert.lattice_from_numpy(arrays, "cpu")
    port_lat = port_dist.LatticeChip(**{
        f.name: getattr(port_lat, f.name).to(torch.bfloat16)
        for f in dataclasses.fields(port_lat)})
    chip = port_dist.lattice_to_chip(port_dist.LatticeSpec(4, 4, chains=4),
                                     port_lat)
    assert chip.nbr_w.dtype == torch.bfloat16
    m = np.where(np.random.default_rng(3).random((6, spec.n_spins)) < 0.5,
                 -1.0, 1.0).astype(np.float32)
    want = np.asarray(ref_dist.sparse_energy(ref_chip, jax.numpy.asarray(m)))
    got = port_dist.sparse_energy(chip, torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
