"""`repro_torch.launch.dryrun` traced as one rank of a rank mesh.

The dry run runs a cell's step as rank 0 of the production rank mesh, on
meta tensors, under a process group that moves nothing
(`dryrun.rank_trace`).  Here, on reduced configs:

* Rank 0's FLOPs on a 2 x 2 mesh, and rank 3's, equal the reference's
  per-device ``dot_flops`` of the same cell (reduced gemma2-2b, a train
  step at B = 32, S = 64), read by
  ``benchmarks/roofline.py::dot_flops_from_hlo`` from the module the
  reference compiles on 4 forced host devices with ``Auto`` axes.
  Exactly: the partitioner and the port's FSDP x tensor parallelism
  split every product the same way at this cell.
* A reduced pod cell of each kind is ``ok`` with its collectives, its
  temporaries and its outputs measured, and `roofline_row` has a
  collective term.
* The fake group lives only inside the call: none is left initialized
  after `run_cell`, and `run_cell` refuses to run while a real group is
  initialized (it never takes one over).

That each rank's traced collectives equal the real gloo ranks' is held
where the ranks run: `test_torch_lm_ranks.py` and
`test_torch_lm_ranks_moe.py`.
"""
import importlib.util
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs.base import ShapeCfg
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core import ranks
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

from _torch_port import finish_forced_reference, start_forced_reference

ROOT = Path(__file__).resolve().parent.parent
B, S = 32, 64
CELL = ShapeCfg("train_4k", S, B, "train")
SMALL = {"train_4k": CELL,
         "prefill_32k": ShapeCfg("prefill_32k", S, 16, "prefill"),
         "decode_32k": ShapeCfg("decode_32k", S, 16, "decode")}


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline_torch", ROOT / "benchmarks_torch" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's compiled train step of reduced gemma2-2b at B x S
    on a 2 x 2 ``Auto`` mesh of forced host devices: its ``dot_flops``
    and collectives as its roofline reads them, started here and read by
    the first caller of ``result()``."""
    started = start_forced_reference(f"""
        sys.path.insert(0, {str(ROOT)!r})
        from benchmarks.roofline import (collective_bytes_from_hlo,
                                         dot_flops_from_hlo)
        from repro.configs.base import ShapeCfg
        from repro.configs.registry import get_reduced_config
        from repro.launch import steps
        mesh = auto_mesh((2, 2), ("data", "model"))
        st = steps.make_step(get_reduced_config("gemma2-2b"),
                             ShapeCfg("t", {S}, {B}, "train"), mesh)
        with mesh:
            hlo = st.fn.lower(*st.abstract_args).compile().as_text()
        save("dot_flops", dot_flops_from_hlo(hlo))
        for op, b in collective_bytes_from_hlo(hlo)["per_op_bytes"].items():
            save(f"collectives/{{op}}", b)
    """, 4, tmp_path_factory.mktemp("ref"))
    done = {}

    def result():
        if not done:
            done.update(finish_forced_reference(started, timeout=300))
        return done
    return result


@pytest.mark.parametrize("rank", [0, 3])
def test_rank_flops_equal_the_reference_per_device(rank, reference):
    got = dryrun.rank_trace(get_reduced_config("gemma2-2b"), CELL,
                            {"data": 2, "model": 2}, rank=rank)
    want = reference()
    assert got["flops"] == float(want["dot_flops"][0])
    # the partitioner chooses other collectives than FSDP x tensor
    # parallelism (ROADMAP Queue 3 item 25): recorded there, not held
    assert any(k.startswith("collectives/") for k in want)
    assert sum(got["collectives"]["calls"].values()) > 0


@pytest.fixture
def reduced_cells(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", get_reduced_config)
    monkeypatch.setattr(dryrun, "LM_SHAPES", SMALL)


@pytest.mark.parametrize("shape", list(SMALL))
def test_reduced_pod_cell_measures_its_rank(shape, tmp_path, reduced_cells):
    rec = dryrun.run_cell("gemma2-2b", shape, False, tmp_path, force=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["traced_rank"] == 0 and rec["n_devices"] == 256
    mem = rec["memory"]
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["generated_code_bytes"] is None and mem["why_null"]
    coll = rec["collectives"]
    assert coll["per_op_bytes"] and coll["total_bytes"] > 0
    assert coll["raw_result_bytes"] > 0
    assert set(coll["calls"]) == set(ranks.MeshComm.KINDS)
    assert rec["replication"] >= 1.0
    row = _roofline().roofline_row(rec)
    assert row["t_collective_s"] == coll["total_bytes"] / mesh_mod.NVLINK_BW
    assert row["bottleneck"] in ("compute", "memory", "collective")


def test_fake_group_lives_only_inside_the_call(tmp_path, reduced_cells):
    rec = dryrun.run_cell("gemma2-2b", "decode_32k", True, tmp_path,
                          force=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert not dist.is_initialized()
    assert not any(m.ranks is not None for m in list(ranks._COMMS.keys()))
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        rec = dryrun.run_cell("gemma2-2b", "decode_32k", True, tmp_path,
                              force=True)
        assert rec["status"] == "fail"
        assert "already initialized" in rec["error"]
        # the real group is left as it was
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.rank_trace(get_reduced_config("gemma2-2b"), CELL,
                              {"data": 1, "model": 1})
    finally:
        dist.destroy_process_group()
