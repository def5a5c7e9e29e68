"""`repro_torch.launch.dryrun` and `benchmarks_torch/roofline.py`'s
reader.

A reduced cell (reduced gemma2-2b at a small train shape, the production
pod mesh, traced as its rank 0) and a ``--pbit pbit-chip-440`` plan,
``--force``, into a temp directory: ``status`` ``ok``; the argument bytes
a device equal the sum of the reference's ``NamedSharding.shard_shape``
bytes under the reference's specs; the rank's FLOPs, collectives and
temporaries are measured; ``long_500k`` on a full-attention arch is
``skip``; a cached cell is not rerun; `roofline_row` reads the record,
its collective term too.  Nothing here builds a full-width model: the
full-width cells are traced on the card's host by ``chip_smoke.py``."""
import importlib.util
import json
import math
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ShapeCfg as RShape
from repro.configs.registry import get_reduced_config as ref_reduced
from repro.launch import steps as RS
from repro.models import model as RM
from repro.models import sharding as RSH
from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"train_4k": ShapeCfg("train_4k", 64, 32, "train"),
         "long_500k": ShapeCfg("long_500k", 4096, 1, "decode")}


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline_torch", ROOT / "benchmarks_torch" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def reduced_cells(monkeypatch):
    """The dry run's cells on reduced configs and small shapes."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced_config)
    monkeypatch.setattr(dryrun, "LM_SHAPES", SMALL)


MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _ref_argument_bytes(shape: RShape, rcfg=None, multi_pod=False) -> int:
    """The reference's per-device argument bytes of a train step on a
    production mesh: every leaf's ``NamedSharding(AbstractMesh)
    .shard_shape`` under the reference's own specs (reduced gemma2-2b
    unless ``rcfg`` is given)."""
    amesh = AbstractMesh(*MESHES[multi_pod])

    class M:
        shape = dict(zip(MESHES[multi_pod][1], MESHES[multi_pod][0]))
    rcfg = rcfg or ref_reduced("gemma2-2b")
    params, opt = RS.abstract_train_state(rcfg)
    batch = RM.train_input_specs(rcfg, shape)
    trees = (params, opt.mu, opt.nu, batch)
    specs = (RSH.param_specs(params, M()), RS._opt_moment_specs(opt.mu, M()),
             RS._opt_moment_specs(opt.nu, M()), RS.batch_specs(batch, M()))
    total = 4                                    # the int32 step, replicated
    for tree, spec in zip(trees, specs):
        leaves = jax.tree.leaves(tree)
        sp = jax.tree.leaves(spec, is_leaf=lambda x: isinstance(x, JP))
        for leaf, s in zip(leaves, sp):
            total += math.prod(JNamedSharding(amesh, s).shard_shape(
                leaf.shape)) * leaf.dtype.itemsize
    return total


def test_reduced_cell_is_ok_with_exact_argument_bytes(tmp_path, reduced_cells):
    rec = dryrun.run_cell("gemma2-2b", "train_4k", False, tmp_path,
                          force=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec == json.loads(
        (tmp_path / "gemma2-2b__train_4k__pod.json").read_text())
    assert rec["n_devices"] == 256 and rec["kind"] == "train"
    assert rec["memory"]["argument_bytes"] == _ref_argument_bytes(
        RShape("train_4k", 64, 32, "train"))
    # a train step's outputs are its updated state and three scalars
    assert rec["memory"]["output_bytes"] == \
        rec["memory"]["argument_bytes"] - 2 * 32 * 64 * 4 // 16 + 3 * 4
    # rank 0's temporaries, collectives and FLOPs, traced: the reduced
    # model's 4 heads and d_ff of 256 on a 16-way model axis repeat work
    # on every rank, so rank 0 does more than a 256th of the whole
    assert rec["traced_rank"] == 0
    assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["temp_rule"]
    coll = rec["collectives"]
    assert coll["per_op_bytes"] and coll["total_bytes"] == sum(
        coll["per_op_bytes"].values())
    assert sum(coll["calls"].values()) > 0
    assert rec["flops_global"] > 0
    assert rec["dot_flops"] > rec["flops_global"] / 256
    assert rec["replication"] == rec["dot_flops"] * 256 / rec["flops_global"]
    assert rec["cost"]["flops"] == rec["dot_flops"]
    assert rec["params"] == get_reduced_config("gemma2-2b").param_count()

    row = _roofline().roofline_row(rec)
    assert row["t_collective_s"] == coll["total_bytes"] / mesh_mod.NVLINK_BW
    assert row["t_compute_s"] == rec["dot_flops"] / mesh_mod.PEAK_FLOPS_BF16
    assert row["step_time_lb_s"] == max(row["t_compute_s"],
                                        row["t_memory_s"],
                                        row["t_collective_s"])


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod", "multipod"])
def test_full_width_argument_bytes_are_exact(multi_pod):
    """gemma2-2b x train_4k at full width (the CLI's cell): the argument
    bytes a device that `run_cell` records, summed from the step's specs
    (no trace needed), equal the reference's."""
    from repro.configs.registry import get_config as ref_config
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import make_step

    mesh = make_mesh(*MESHES[multi_pod])
    step = make_step(get_config("gemma2-2b"), LM_SHAPES["train_4k"], mesh,
                     device="cpu")
    got = sum(dryrun.device_bytes(a, s, mesh)
              for a, s in zip(step.abstract_args, step.in_specs))
    assert got == _ref_argument_bytes(RShape("train_4k", 4096, 256, "train"),
                                      ref_config("gemma2-2b"), multi_pod)


def test_skip_and_cache(tmp_path, reduced_cells, monkeypatch, capsys):
    """long_500k on a full-attention arch is ``skip``; a cell with a
    record is read back, not rerun; a failure is recorded, and the CLI
    raises only at the end."""
    rec = dryrun.run_cell("gemma2-2b", "long_500k", False, tmp_path)
    assert rec["status"] == "skip" and "full-attention" in rec["reason"]
    first = dryrun.run_cell("gemma2-2b", "train_4k", True, tmp_path)
    assert first["status"] == "ok" and first["n_devices"] == 512

    def boom(*a, **k):
        raise RuntimeError("the cell was rerun")
    monkeypatch.setattr(dryrun, "make_step", boom)
    assert dryrun.run_cell("gemma2-2b", "train_4k", True, tmp_path) == first
    assert "[cached]" in capsys.readouterr().out
    failed = dryrun.run_cell("gemma2-2b", "train_4k", False, tmp_path)
    assert failed["status"] == "fail" and "rerun" in failed["error"]
    with pytest.raises(SystemExit, match="1 cells FAILED"):
        dryrun.main(["--arch", "gemma2-2b", "--shape", "train_4k",
                     "--mesh", "both", "--out", str(tmp_path)])
    # the cached multipod cell was not rerun; the pod one failed again
    assert json.loads((tmp_path / "gemma2-2b__train_4k__multipod.json")
                      .read_text()) == first


def test_pbit_plan(tmp_path, monkeypatch):
    """The 440-spin chip's 7 cell rows on a 1 x 7 mesh: the plan, the
    halo bytes, the routes and the napkin figure.  On the pod mesh its 7
    rows cannot make 256 bands, and the record says so."""
    rec = dryrun.run_pbit("pbit-chip-440", False, tmp_path, force=True)
    assert rec["status"] == "fail" and "256 bands" in rec["error"]
    monkeypatch.setattr(mesh_mod, "make_production_mesh",
                        lambda multi_pod=False: make_mesh(
                            (1, 7), ("data", "model")))
    dryrun.main(["--pbit", "pbit-chip-440", "--chains", "4", "--force",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "pbit-chip-440__anneal__pod.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["n_spins"] == 440 and rec["bands"] == 7
    assert rec["halo_bytes_per_sweep"] == 2 * rec["n_boundary"] * 4 * 4
    assert rec["routes"]["barrier"]["backend"] == "sparse"
    assert rec["routes"]["async"] == {"backend": "fused_sparse",
                                      "k5_body": "cluster"}
    assert rec["napkin"] == mesh_mod.halo_vs_hbm_seconds(
        rec["halo_bytes_per_sweep"] // 6, rec["band_bytes_per_sweep"],
        exchanges=2.0)
