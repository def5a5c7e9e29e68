"""Multi-pod dry run: trace every (arch x shape x mesh) cell as one rank.

For each cell this answers, without a card and without allocating:
  * the sharding rules are coherent: every argument's spec holds on the
    mesh (`models.sharding.NamedSharding.shard_shape`),
  * whether it fits: per-device argument bytes, summed from the specs'
    shard shapes (exact), and the traced rank's temporaries, against one
    H100's HBM,
  * the roofline's terms: the traced rank's FLOPs and its collectives by
    kind, read by ``benchmarks_torch/roofline.py``.

The port of ``python -m repro.launch.dryrun``, with its CLI, cell file
names and ``status`` values (``ok``, ``skip``, ``fail``; a failure is
recorded, and raised only at the end).  The reference compiles the
partitioned module of every device and reads it; the port has no
compiler, so it runs the step itself as one rank of the production rank
mesh (`rank_trace`): ``make_production_mesh(ranks=True)`` under a process
group that moves nothing (the ``fake`` backend on ``cpu`` and ``meta``,
made inside the call and destroyed after it; a real group already
initialized is refused), every argument that rank's block of the step's
trees on the ``meta`` device (`models.sharding.shard_tree`), so nothing
is allocated and the card is never touched.  That rank's step is the one
the rank meshes run (`launch.steps`), with its collectives
(`core.ranks.MeshComm`).  From the trace:

  * ``dot_flops`` (and ``cost.flops``): ``FlopCounterMode`` over the
    rank's step; ``flops_global`` is the same counter over the unsharded
    step (the step on a logical mesh), and ``replication`` their ratio
    times the devices: above 1 where a mesh axis repeats work (gemma2-2b's
    8 heads whole on each rank of a 16-way model axis),
  * ``collectives``: the rank's `MeshComm` calls and contributed bytes by
    kind, and the bytes the reference's roofline would read for the same
    calls (``total_bytes``, ``raw_result_bytes``, ``per_op_bytes``;
    `core.ranks.ring_bytes`),
  * ``memory.temp_bytes``: `TEMP_RULE`; ``memory.output_bytes``: the
    rank's outputs' local bytes.

``generated_code_bytes`` stays null (`CODE_WHY`).

``--pbit`` traces nothing: it records the sharded lattice's plan — spins,
bands, the padded band width and halo, the halo bytes a sweep, per-band
bytes, and the backend and K5 body `auto` resolves to on that mesh —
with `launch.mesh.halo_vs_hbm_seconds`' napkin figure.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both        # the full sweep
  python -m repro_torch.launch.dryrun --pbit pbit-pod-2m       # paper's own arch
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import LM_SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, PBIT_CONFIGS, get_config
from repro_torch.core import ranks
from repro_torch.core.distributed import make_rank_mesh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import make_step
from repro_torch.models.model import ShapeDtype
from repro_torch.models.sharding import (NamedSharding, P, leaves_with_path,
                                         map_with_path, shard_tree)

# a process group that moves nothing, for collectives on CPU and meta
# tensors (a plain "fake" has no backend for meta tensors' point-to-point
# calls)
FAKE_BACKEND = "cpu:fake,meta:fake"
TEMP_RULE = ("the traced rank's peak of live tensor bytes on the meta device "
             "over the step (torch.distributed._tools.mem_tracker.MemTracker,"
             " the rank's arguments tracked from the start) less the rank's "
             "argument bytes; outputs alive at the peak count as temporaries")
CODE_WHY = "no compiler: the port runs eagerly and generates no code"


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` under ``specs`` (None: the
    whole tree on every device): each leaf's shard shape on ``mesh``."""
    by_key = dict(leaves_with_path(specs)) if specs is not None else {}
    total = 0
    for key, leaf in leaves_with_path(tree):
        shape = NamedSharding(mesh, by_key.get(key, P())).shard_shape(
            tuple(leaf.shape))
        total += _nbytes(shape, leaf.dtype)
    return total


def _materialize(args, seq_len: int):
    """The step's arguments on the ``meta`` device: shapes and dtypes, no
    data.  A fake tensor's meta twin traces the same ops as the fake
    tensor does, six times faster (gemma2-2b's 8192-token prefill: 10 s
    against 60 s on a CPU, the same FLOPs); a decode position becomes the
    last one."""
    def one(key, leaf):
        if isinstance(leaf, ShapeDtype) and leaf.shape == () \
                and leaf.dtype == torch.int32:
            return seq_len - 1
        return torch.empty(tuple(leaf.shape), dtype=leaf.dtype,
                           device="meta")
    return tuple(map_with_path(one, a) for a in args)


def trace_step(step, seq_len: int) -> tuple[object, float]:
    """(outputs, FLOPs of the whole step) of one call of ``step.fn`` on
    its abstract arguments, traced on the ``meta`` device."""
    with FlopCounterMode(display=False) as fc:
        out = step.fn(*_materialize(step.abstract_args, seq_len))
    return out, float(fc.get_total_flops())


def _local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` as this rank holds them (a
    DTensor's local block)."""
    return sum(t.numel() * t.element_size() for t in _locals(tree))


def _locals(tree) -> list:
    return [x.to_local() if ranks.is_dtensor(x) else x
            for _, x in leaves_with_path(tree)
            if isinstance(x, torch.Tensor)]


def rank_trace(cfg, shape, axes: dict, rank: int = 0, opt_bits: int = 32,
               microbatches: int = 1) -> dict:
    """One step of ``cfg`` at ``shape``, run as ``rank`` of a rank mesh of
    ``axes`` ({name: size}, in order) on ``meta`` tensors, under a
    process group of `FAKE_BACKEND` made for the call and destroyed
    after it (the mesh's `MeshComm` is dropped with it, so a trace of
    another rank starts clean).  Refuses while a process group is
    initialized.  Returns the rank's FLOPs, its `MeshComm` record, its
    argument bytes (checked against the specs' shard shapes), its peak
    of live bytes (`TEMP_RULE`), its outputs' bytes and the seconds the
    build and the trace took."""
    from torch.distributed._tools.mem_tracker import MemTracker

    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialized: the dry run traces "
            "under a process group of its own that moves nothing, and "
            "never takes over a real one; run it in a process with none")
    dist.init_process_group(FAKE_BACKEND, rank=rank,
                            world_size=math.prod(axes.values()),
                            store=FakeStore())
    mesh = None
    try:
        t0 = time.time()
        mesh = make_rank_mesh(tuple(axes.values()), tuple(axes))
        step = make_step(cfg, shape, mesh, opt_bits=opt_bits,
                         microbatches=microbatches, device="meta")
        spec_bytes = sum(device_bytes(a, s, mesh) for a, s in
                         zip(step.abstract_args, step.in_specs))
        # a decode position is a Python int, as the serving loop passes it
        args = tuple(a if isinstance(a, int) else
                     shard_tree(a, s, mesh, "meta") for a, s in
                     zip(_materialize(step.abstract_args, shape.seq_len),
                         step.in_specs))
        held = _local_bytes(args)
        as_ints = 4 * sum(isinstance(a, int) for a in args)
        if held + as_ints != spec_bytes:
            raise AssertionError(
                f"rank {rank} holds {held} argument bytes; its specs' "
                f"shard shapes give {spec_bytes - as_ints}")
        comm = ranks.rank_comm(mesh, "meta")
        comm.reset()
        tracker = MemTracker()
        tracker.track_external(*_locals(args))
        t_build = time.time() - t0
        with tracker, FlopCounterMode(display=False) as fc:
            out = step.fn(*args)
        peak = tracker.get_tracker_snapshot("peak")[torch.device("meta")]
        return {"flops": float(fc.get_total_flops()),
                "collectives": comm.record(),
                "argument_bytes": spec_bytes,
                "peak_bytes": peak["Total"],
                "temp_bytes": peak["Total"] - held,
                "output_bytes": _local_bytes(out),
                "build_s": t_build,
                "trace_s": time.time() - t0 - t_build}
    finally:
        if mesh is not None:
            ranks._COMMS.pop(mesh, None)
        dist.destroy_process_group()


def _collectives(record: dict) -> dict:
    """A `MeshComm` record under the reference's keys, with the calls and
    the bytes this rank contributed by kind beside them."""
    return {**record["reference"], "calls": record["calls"],
            "contributed_bytes": record["bytes"]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path, force: bool = False,
             opt_bits: int = 32, microbatches: int = 1) -> dict:
    mesh_tag = "multipod" if multi_pod else "pod"
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        if rec.get("status") in ("ok", "skip"):
            print(f"[cached] {arch} x {shape_name} x {mesh_tag}: "
                  f"{rec['status']}")
            return rec

    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=why)
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[skip]   {arch} x {shape_name}: {why}")
        return rec

    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh_mod.n_chips(mesh)
    t0 = time.time()
    try:
        # the unsharded step's model on the CPU: nothing is drawn, and the
        # card is never touched (its arguments are fake and meta tensors)
        step = make_step(cfg, shape, mesh, opt_bits=opt_bits,
                         microbatches=microbatches, device="cpu")
        t_build = time.time() - t0
        _, flops = trace_step(step, shape.seq_len)
        t_trace = time.time() - t0 - t_build
        arg_bytes = sum(device_bytes(a, s, mesh)
                        for a, s in zip(step.abstract_args, step.in_specs))
        # kept where the rank's trace fails
        rec.update(build_s=round(t_build, 2), trace_s=round(t_trace, 2),
                   n_devices=n_dev, flops_global=flops,
                   memory={"argument_bytes": arg_bytes})
        one = rank_trace(cfg, shape, dict(mesh.shape), 0, opt_bits,
                         microbatches)
        rec.update(
            status="ok",
            rank_build_s=round(one["build_s"], 2),
            rank_trace_s=round(one["trace_s"], 2),
            traced_rank=0,
            memory={"argument_bytes": arg_bytes,
                    "output_bytes": one["output_bytes"],
                    "temp_bytes": one["temp_bytes"],
                    "generated_code_bytes": None,
                    "temp_rule": TEMP_RULE,
                    "why_null": CODE_WHY},
            dot_flops=one["flops"],
            replication=one["flops"] * n_dev / flops,
            cost={"flops": one["flops"]},
            collectives=_collectives(one["collectives"]),
            fits_hbm=arg_bytes + one["temp_bytes"] <= mesh_mod.HBM_BYTES,
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            kind=shape.kind,
        )
        print(f"[ok]     {arch} x {shape_name} x {mesh_tag}: "
              f"trace={t_trace:.1f}s rank={one['trace_s']:.1f}s "
              f"args/dev={arg_bytes/2**30:.2f}GiB "
              f"temp/dev={one['temp_bytes']/2**30:.2f}GiB "
              f"coll={rec['collectives']['total_bytes']/2**30:.3f}GiB "
              f"flops/dev={one['flops']:.3e}", flush=True)
    except Exception as e:
        rec.update(status="fail", error=repr(e),
                   trace=traceback.format_exc()[-4000:])
        print(f"[FAIL]   {arch} x {shape_name} x {mesh_tag}: {e!r}",
              flush=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


# the sync policies of examples/pbit_lattice_pod.py, by name
def _policies():
    from repro_torch.api.spec import Sync
    return {"barrier": Sync(),
            "halo4": Sync(halo_every=4, sweeps_per_launch=4),
            "async": Sync(halo_every=math.inf, mode="async",
                          sweeps_per_launch=4)}


def _auto_route(graph, mesh, row_axes, chains: int, plan, sync) -> dict:
    """The backend `auto` resolves to for a counter-noise lattice on this
    mesh under ``sync``, and the K5 body `exchange_plan` picks for one
    launch of it on an H100 (None where K5 has no body)."""
    from repro_torch.api.spec import (Partition, SamplerSpec,
                                      resolve_backend)
    from repro_torch.core.hardware import HardwareConfig
    from repro_torch.kernels.sweep_fused import H100, exchange_plan

    spec = SamplerSpec(graph=graph, hw=HardwareConfig(), mismatch=None,
                       noise="counter", chains=chains, device="cpu",
                       mesh=mesh, partition=Partition(rows=row_axes),
                       sync=sync)
    try:
        body = exchange_plan(plan.n_shards, chains,
                             plan.n_loc + 2 * plan.halo, 6, False, H100,
                             halo=plan.halo).body
    except ValueError:
        body = None
    return {"backend": resolve_backend(spec), "k5_body": body}


def run_pbit(name: str, multi_pod: bool, out_dir: Path,
             force: bool = False, chains: int = 1,
             dtype: str = "float32") -> dict:
    """Dry-run the paper's own architecture: the plan of a distributed
    Chimera lattice."""
    from repro_torch.core.chimera import make_chimera
    from repro_torch.core.distributed import (halo_bytes_per_sweep,
                                              plan_row_partition)

    mesh_tag = "multipod" if multi_pod else "pod"
    out_path = out_dir / f"{name}__anneal__{mesh_tag}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        if rec.get("status") == "ok":
            print(f"[cached] {name} x {mesh_tag}: ok")
            return rec
    spec_d = PBIT_CONFIGS[name]
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    # the spatial cut is 1-D over cell rows: use every mesh axis so all
    # devices hold a row band (512 rows >= 512 devices)
    row_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    rec = {"arch": name, "shape": "anneal_1k_sweeps", "mesh": mesh_tag,
           "chains": chains, "dtype": dtype}
    t0 = time.time()
    try:
        graph = make_chimera(spec_d["cell_rows"], spec_d["cell_cols"],
                             masked_cells=tuple(spec_d["masked"]))
        n_bands = mesh_mod.n_chips(mesh)
        plan = plan_row_partition(graph, n_bands)
        itemsize = torch.empty((), dtype=getattr(torch, dtype)).itemsize
        halo = int(halo_bytes_per_sweep(plan, chains))
        # a band's sweep streams its slot weights and its spins once
        band_bytes = (6 * plan.n_loc * itemsize
                      + 2 * chains * plan.n_loc * itemsize)
        routes = {k: _auto_route(graph, mesh, row_axes, chains, plan, s)
                  for k, s in _policies().items()}
        sync = _policies()["barrier"]
        rec.update(
            status="ok",
            plan_s=round(time.time() - t0, 2),
            n_spins=graph.n_nodes,
            n_edges=graph.n_edges,
            n_devices=n_bands,
            bands=plan.n_shards,
            row_axes=list(row_axes),
            n_loc=plan.n_loc,
            halo=plan.halo,
            n_boundary=plan.n_boundary,
            halo_bytes_per_sweep=halo,
            band_bytes_per_sweep=band_bytes,
            routes=routes,
            napkin=mesh_mod.halo_vs_hbm_seconds(
                halo // max(n_bands - 1, 1), band_bytes,
                exchanges=sync.exchanges_per_sweep()),
        )
        print(f"[ok]     {name} ({graph.n_nodes/1e6:.1f}M spins) x "
              f"{mesh_tag}: {n_bands} bands of {plan.n_loc}, halo "
              f"{halo} B/sweep")
    except Exception as e:
        rec.update(status="fail", error=repr(e),
                   trace=traceback.format_exc()[-4000:])
        print(f"[FAIL]   {name} x {mesh_tag}: {e!r}")
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(LM_SHAPES))
    ap.add_argument("--pbit", choices=list(PBIT_CONFIGS))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--pbit-dtype", default="float32")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    if args.pbit:
        for mp in meshes:
            rec = run_pbit(args.pbit, mp, out_dir, args.force,
                           args.chains, args.pbit_dtype)
            n_fail += rec["status"] == "fail"
    elif args.all:
        for arch in ARCH_IDS:
            for shape_name in LM_SHAPES:
                for mp in meshes:
                    rec = run_cell(arch, shape_name, mp, out_dir,
                                   args.force, args.opt_bits,
                                   args.microbatches)
                    n_fail += rec["status"] == "fail"
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all or --pbit")
        for mp in meshes:
            rec = run_cell(args.arch, args.shape, mp, out_dir, args.force,
                           args.opt_bits, args.microbatches)
            n_fail += rec["status"] == "fail"
    if n_fail:
        raise SystemExit(f"{n_fail} cells FAILED")


if __name__ == "__main__":
    main()
