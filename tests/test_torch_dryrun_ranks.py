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
  split every product the same way at this cell.  On a 1 x 4 mesh (the
  4 query heads split, the 2 KV heads whole: every model rank projects
  every KV head, as the partitioner does) rank 0's FLOPs are the
  reference's plus one cross-entropy logits product, which the
  reference's compiled module lacks where the batch is whole on every
  device (ROADMAP Queue 3 item 25); the port's loss on the reference's
  parameters and batch is the reference's meshed loss.
* A reduced pod cell of each kind is ``ok`` with its collectives, its
  temporaries and its outputs measured, and `roofline_row` has a
  collective term; so is each kind of a reduced granite-moe-1b-a400m
  with its own 16 query / 8 KV heads (the query heads split over the
  16-way model axis, the KV heads whole), which the dry run refused
  before grouped-query attention ran on such a mesh.
* The fake group lives only inside the call: none is left initialized
  after `run_cell`, and `run_cell` refuses to run while a real group is
  initialized (it never takes one over).

That each rank's traced collectives equal the real gloo ranks' is held
where the ranks run: `test_torch_lm_ranks.py` and
`test_torch_lm_ranks_moe.py`.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeCfg, reduced
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.core import ranks
from repro_torch.core.distributed import make_mesh
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import sharding as shd
from repro_torch.models.model import build_model

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
    on a 2 x 2 and a 1 x 4 ``Auto`` mesh of forced host devices: its
    ``dot_flops``, ``dot`` instructions and collectives as its roofline
    reads them; and on 1 x 4 its jitted loss with the specs' shardings on
    the parameters of ``PRNGKey(0)`` and `make_dummy_batch`'s batch of
    ``PRNGKey(1)``, which it saves by their ``keystr`` paths.  Started
    here and read by the first caller of ``result()``."""
    started = start_forced_reference(f"""
        import re
        sys.path.insert(0, {str(ROOT)!r})
        from jax.sharding import NamedSharding, PartitionSpec
        from benchmarks.roofline import (collective_bytes_from_hlo,
                                         dot_flops_from_hlo)
        from repro.configs.base import ShapeCfg
        from repro.configs.registry import get_reduced_config
        from repro.launch import steps
        from repro.models import sharding as shd
        from repro.models.model import build_model, make_dummy_batch
        cfg = get_reduced_config("gemma2-2b")
        shape = ShapeCfg("t", {S}, {B}, "train")
        for tag, dims in (("", (2, 2)), ("1x4/", (1, 4))):
            mesh = auto_mesh(dims, ("data", "model"))
            st = steps.make_step(cfg, shape, mesh)
            with mesh:
                hlo = st.fn.lower(*st.abstract_args).compile().as_text()
            save(tag + "dot_flops", dot_flops_from_hlo(hlo))
            save(tag + "dots", len(re.findall(r"= \\S+ dot\\(", hlo)))
            for op, b in collective_bytes_from_hlo(hlo)[
                    "per_op_bytes"].items():
                save(f"{{tag}}collectives/{{op}}", b)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        batch = make_dummy_batch(cfg, shape, jax.random.PRNGKey(1))
        ns = lambda specs: jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        with shd.use_mesh(mesh):
            loss = jax.jit(model.loss, in_shardings=(
                ns(shd.param_specs(params, mesh)),
                ns(steps.batch_specs(batch, mesh))))(params, batch)
        save("1x4/loss", loss)
        for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
            save("p" + jax.tree_util.keystr(path), x)
        for k, v in batch.items():
            save("batch/" + k, v)
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


def test_query_split_rank_flops_and_loss_equal_the_reference(reference):
    """Rank 0 of 1 x 4: each rank's query head attends KV head r // 2 of
    the whole K/V projection, which every rank computes, forward and
    backward, as the reference's partitioner does.  Its FLOPs are the
    reference's per-device ``dot_flops`` plus one cross-entropy logits
    product (2 B S D V / 4): the reference's module compiled on 1 x 4
    holds one ``dot`` fewer than on 2 x 2, the chunked cross-entropy's
    forward product, as its one-device module lacks the whole one
    (2^28 FLOPs; ROADMAP Queue 3 item 25).  The port's loss on the
    reference's parameters and batch, under a 1 x 4 mesh, is the
    reference's jitted loss under its 1 x 4 mesh to 1e-5."""
    c = get_reduced_config("gemma2-2b")
    got = dryrun.rank_trace(c, CELL, {"data": 1, "model": 4}, rank=0)
    want = reference()
    assert int(want["1x4/dots"][0]) == int(want["dots"][0]) - 1
    gap = 2 * B * S * c.d_model * c.vocab_size // 4
    assert got["flops"] == float(want["1x4/dot_flops"][0]) + gap
    assert got["collectives"]["calls"]["all_reduce"] > 0
    like = build_model(c, device="cpu").init(0)
    params = shd.map_with_path(lambda key, _: torch.from_numpy(
        np.array(want["p" + key][0])), like)
    batch = {k: torch.from_numpy(np.array(want["batch/" + k][0]))
             for k in ("tokens", "labels")}
    batch["tokens"] = batch["tokens"].long()
    with shd.use_mesh(make_mesh((1, 4), ("data", "model"))):
        loss = build_model(c, device="cpu").loss(params, batch)
    np.testing.assert_allclose(loss.item(), want["1x4/loss"][0], rtol=0,
                               atol=1e-5)


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


def _own_heads(arch):
    """``arch`` reduced, with its own query and KV head counts (8-wide
    heads)."""
    full = get_config(arch)
    return reduced(full, num_heads=full.num_heads,
                   num_kv_heads=full.num_kv_heads, head_dim=8)


@pytest.mark.parametrize("shape", list(SMALL))
def test_grouped_kv_heads_pod_cell_traces(shape, tmp_path, monkeypatch):
    """Reduced granite-moe-1b-a400m with its 16 query / 8 KV heads on the
    pod mesh: the 16-way model axis splits the query heads and leaves the
    KV heads whole, a layout the dry run refused before.  Each kind of
    cell is ``ok``: rank 0's step gathers nothing over the KV heads and
    sums the K/V weights' gradients over "model" (train), and repeats the
    K/V projection on every model rank (replication above 1)."""
    monkeypatch.setattr(dryrun, "get_config", _own_heads)
    monkeypatch.setattr(dryrun, "LM_SHAPES", SMALL)
    cfg = _own_heads("granite-moe-1b-a400m")
    mesh = mesh_mod.make_production_mesh(multi_pod=False)
    specs = dict(shd.leaves_with_path(shd.param_specs(
        steps.abstract_train_state(cfg)[0], mesh)))
    wq = next(v for k, v in specs.items() if k.endswith("['wq']"))
    wk = next(v for k, v in specs.items() if k.endswith("['wk']"))
    assert "model" in wq and "model" not in wk
    rec = dryrun.run_cell("granite-moe-1b-a400m", shape, False, tmp_path,
                          force=True)
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["replication"] > 1.0
    assert sum(rec["collectives"]["calls"].values()) > 0
