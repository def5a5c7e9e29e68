"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

For each cell this answers, without a card and without allocating:
  * the sharding rules are coherent: every argument's spec holds on the
    mesh (`models.sharding.NamedSharding.shard_shape`),
  * whether it fits: per-device argument and output bytes, summed from
    the specs' shard shapes (exact) against one H100's HBM,
  * the roofline's compute term: ``FlopCounterMode`` over one step traced
    on the step's abstract arguments (fake tensors from
    ``torch._subclasses.fake_tensor``, traced as their ``meta`` twins) —
    read by ``benchmarks_torch/roofline.py``.

The port of ``python -m repro.launch.dryrun``, with its CLI, cell file
names and ``status`` values (``ok``, ``skip``, ``fail``; a failure is
recorded, and raised only at the end).  Without XLA there is nothing to
lower or compile, so what the reference reads from the compiled module
is either reckoned or left ``null`` with the reason in the record:
``temp_bytes`` and ``generated_code_bytes`` (no compiler), and the
collectives (no partitioner: the port's meshes are logical devices of one
card, and collectives come with several cards).  ``dot_flops`` is
``flops_global / n_devices``: work a mesh axis replicates (gemma2-2b's 8
heads on a 16-way model axis) is under-counted per device.

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
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import LM_SHAPES, shape_applicable
from repro_torch.configs.registry import ARCH_IDS, PBIT_CONFIGS, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.steps import make_step
from repro_torch.models.model import ShapeDtype
from repro_torch.models.sharding import (NamedSharding, P, leaves_with_path,
                                         map_with_path)

TEMP_WHY = ("no compiler: the port runs eagerly, and its temporaries are "
            "measured on the card (torch.cuda.max_memory_allocated)")
COLLECTIVES_WHY = ("no partitioner: the mesh is logical devices of one "
                   "card; collectives come with several cards")
DOT_FLOPS_RULE = ("flops_global / n_devices, from FlopCounterMode over one "
                  "step on meta tensors; work replicated over a mesh axis "
                  "is under-counted per device")


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
        # the step's model on the CPU: nothing is drawn, and the card is
        # never touched (its arguments are fake and meta tensors)
        step = make_step(cfg, shape, mesh, opt_bits=opt_bits,
                         microbatches=microbatches, device="cpu")
        t_build = time.time() - t0
        out, flops = trace_step(step, shape.seq_len)
        t_trace = time.time() - t0 - t_build
        arg_bytes = sum(device_bytes(a, s, mesh)
                        for a, s in zip(step.abstract_args, step.in_specs))
        # the prefill step has no output specs: the reference leaves its
        # outputs' layout to the partitioner, and so their bytes unknown
        out_bytes = None if step.out_specs is None else sum(
            device_bytes(o, s, mesh) for o, s in zip(out, step.out_specs))
        rec.update(
            status="ok",
            build_s=round(t_build, 2),
            trace_s=round(t_trace, 2),
            n_devices=n_dev,
            memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                    "temp_bytes": None, "generated_code_bytes": None,
                    "why_null": TEMP_WHY,
                    "output_rule": "outputs under the step's out_specs "
                                   "(metrics whole on every device); null "
                                   "where the step has none (prefill)"},
            flops_global=flops,
            dot_flops=flops / n_dev,
            dot_flops_rule=DOT_FLOPS_RULE,
            cost={"flops": flops / n_dev},
            collectives=None,
            collectives_why=COLLECTIVES_WHY,
            fits_hbm=arg_bytes + (out_bytes or 0) <= mesh_mod.HBM_BYTES,
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            kind=shape.kind,
        )
        print(f"[ok]     {arch} x {shape_name} x {mesh_tag}: "
              f"trace={t_trace:.1f}s "
              f"args/dev={arg_bytes/2**30:.2f}GiB "
              f"flops={flops:.3e}")
    except Exception as e:
        rec.update(status="fail", error=repr(e),
                   trace=traceback.format_exc()[-4000:])
        print(f"[FAIL]   {arch} x {shape_name} x {mesh_tag}: {e!r}")
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
