"""The port stands alone: no module under ``src/repro_torch``, no script
under ``benchmarks_torch`` or ``examples_torch`` and not ``chip_smoke.py``
imports ``jax`` or the JAX package ``repro``; every
module imports without a GPU, ``nvcc`` or ``triton``; and the default
device without CUDA raises instead of carrying on on the CPU."""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py"))
           + sorted((ROOT / "benchmarks_torch").glob("*.py"))
           + sorted((ROOT / "examples_torch").glob("*.py"))
           + [ROOT / "chip_smoke.py"])
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax_and_no_reference(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_every_module_imports_here():
    """No GPU, nvcc or triton in this process: nothing may need them (or
    build a kernel) at import."""
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[:-len(".__init__")]
        importlib.import_module(name)


def test_port_imports_without_pulling_in_jax():
    """A fresh interpreter that imports the whole port (and the smoke
    script) has neither jax nor the reference package loaded."""
    code = (
        "import sys; sys.path.insert(0, 'src'); sys.path.insert(0, '.');"
        "import repro_torch.api, repro_torch.core.cd, repro_torch.convert,"
        " repro_torch.kernels.ops, repro_torch.kernels.pbit_update,"
        " repro_torch.core.tasks, repro_torch.core.annealing,"
        " repro_torch.core.tempering, repro_torch.core.maxcut,"
        " repro_torch.api.program, repro_torch.kernels.lattice_update,"
        " repro_torch.core.distributed, repro_torch.kernels.shard_sweep,"
        " repro_torch.psl, repro_torch.core, repro_torch.serve,"
        " repro_torch.serve.__main__, repro_torch.configs,"
        " repro_torch.models.model, repro_torch.launch.serve,"
        " repro_torch.core.hwaware, repro_torch.launch.train,"
        " repro_torch.launch.steps, repro_torch.optim.adamw,"
        " repro_torch.data.pipeline, repro_torch.models.moe,"
        " repro_torch.models.mamba, repro_torch.models.rwkv,"
        " repro_torch.models.whisper, chip_smoke;"
        "from repro_torch.core import *;"
        "bad = [m for m in ('jax', 'jaxlib', 'repro') if m in sys.modules];"
        "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("first", [
    "repro_torch.api", "repro_torch.core", "repro_torch.psl",
    "repro_torch.kernels.sweep_fused", "repro_torch.core.lfsr",
    "repro_torch.serve"])
def test_import_order_closes_no_cycle(first):
    """`core/__init__` exports `core.cd`'s names, `core.cd` imports `api`,
    whose spec imports the kernels, which import `core.lfsr`: whichever
    module a fresh interpreter imports first, the rest follow."""
    code = (
        "import sys; sys.path.insert(0, 'src');"
        f"import {first};"
        "import repro_torch.api, repro_torch.core, repro_torch.psl;"
        "from repro_torch.core import PBitMachine, parallel_tempering;"
        "from repro_torch.psl import compile_circuit;"
        "print(len(repro_torch.core.__all__), len(repro_torch.psl.__all__))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["23", "31"]


def test_kernel_sources_ship_with_the_package():
    cu = PORT / "kernels" / "csrc" / "sweep_sparse.cu"
    text = cu.read_text()
    assert 'extern "C"' in text and "sweep_sparse_launch" in text
    assert "use_fast_math" not in " ".join(
        importlib.import_module("repro_torch.kernels.build").NVCC_FLAGS)
    assert "csrc/*.cu" in (ROOT / "pyproject.toml").read_text()


@pytest.mark.parametrize("name", ["sweep_sparse", "pbit_update",
                                  "sweep_fused", "lattice_update",
                                  "sweep_exchange"])
def test_every_kernel_source_ships_and_keys_its_headers(name, tmp_path,
                                                        monkeypatch):
    """Each library has its .cu with a plain C interface; its build key
    covers every csrc header it includes, so an edited header rebuilds."""
    import shutil

    build = importlib.import_module("repro_torch.kernels.build")
    assert name in build.LIBRARIES
    text = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert 'extern "C"' in text and '#include "pbit_common.cuh"' in text
    assert [p.name for p in build.sources(name)] == [f"{name}.cu",
                                                     "pbit_common.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    before = build.library_path(name)
    header = csrc / "pbit_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_path(name) != before
    assert build.library_path(name).parent == tmp_path / "build"


@pytest.mark.parametrize("module,wrapper,plain", [
    ("sweep_fused", "sweep_fused", "sweep_fused_ref"),
    ("pbit_update", "pbit_half_sweep", "pbit_half_sweep_ref"),
    ("sweep_fused", "sweep_sparse_stream", "sweep_sparse_stream_ref"),
    ("lattice_update", "lattice_vertical_update",
     "lattice_vertical_update_ref"),
    ("sweep_fused", "sweep_sparse_exchange", "sweep_sparse_exchange_ref")])
def test_dense_wrappers_take_the_plain_version_only_for_cpu_tensors(
        module, wrapper, plain):
    """As for K1: dispatch on the tensor's device alone, no try/except
    around the launch, no library call standing in for the kernel."""
    src = (PORT / "kernels" / f"{module}.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == wrapper)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == plain]
    assert len(calls) == 1
    body = ast.get_source_segment(src, fn)
    assert "matmul" not in body and "torch.compile" not in body
    cu = {"pbit_update": "pbit_update.cu",
          "lattice_update": "lattice_update.cu"}.get(
        module, {"sweep_sparse_stream": "sweep_sparse.cu",
                 "sweep_sparse_exchange": "sweep_exchange.cu"}.get(
            wrapper, "sweep_fused.cu"))
    text = (PORT / "kernels" / "csrc" / cu).read_text()
    assert "cublas" not in text.lower() and f"{wrapper}_launch" in text


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    from repro_torch import api
    from repro_torch.core import hardware
    from repro_torch.core.cd import PBitMachine
    from repro_torch.core.chimera import make_chimera

    g = make_chimera(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        PBitMachine.create(g, 0)
    cpu = PBitMachine.create(g, 0, noise="counter", device="cpu")
    assert cpu.mismatch.tanh_gain.device.type == "cpu"
    spec = api.SamplerSpec(graph=g, hw=hardware.HardwareConfig(),
                           mismatch=cpu.mismatch, noise="counter")
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        api.Session(spec)
    with pytest.raises(RuntimeError, match="cuda"):
        api.spec.require_device("cuda:0")
    for backend in ("ref", "pallas", "fused"):
        with pytest.raises(RuntimeError, match="cuda"):
            PBitMachine.create(g, 0, noise="counter", backend=backend)


def test_lm_serve_default_device_without_cuda_raises():
    """``python -m repro_torch.launch.serve`` without ``--device`` wants
    the card, and raises here instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_reduced_config("gemma2-2b"))


def test_lm_train_default_device_without_cuda_raises():
    """``python -m repro_torch.launch.train`` without ``--device``, the
    train step and the data pipeline want the card, and raise here."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    from repro_torch.configs import ShapeCfg, get_reduced_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step

    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(get_reduced_config("gemma2-2b"),
                        ShapeCfg("t", 8, 2, "train"), None)
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticLM(DataConfig(vocab_size=50)).batch(0, 2, 8)


def test_smoke_script_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    """The wrapper's dispatch is on the tensor's device alone: the source
    has no try/except around the launch and no fallback branch."""
    src = (PORT / "kernels" / "sweep_fused.py").read_text()
    tree = ast.parse(src)
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "sweep_sparse")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "sweep_sparse_ref"]
    assert len(calls) == 1
    assert "torch.compile" not in src
    assert np.all([kw not in src for kw in ("index_add", "sparse_coo",
                                            "scaled_dot_product")])


def test_every_reference_module_has_its_counterpart():
    """A ``comm`` of the two packages' module lists leaves only the
    reference's ``kernels/util.py`` (``jnp.pad`` helpers of its Pallas
    kernels, which the port needs none of); the many-devices names of
    the reference have theirs (``shard_map``, ``_mesh``, ``_ns`` and the
    HLO parsers have none)."""
    ref = ROOT / "src" / "repro"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (PORT / p.relative_to(ref)).exists())
    assert missing == ["kernels/util.py"]
    names = {
        "launch.mesh": ["make_production_mesh", "make_host_mesh",
                        "make_line_mesh", "halo_vs_hbm_seconds", "n_chips",
                        "PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES"],
        "models.sharding": ["PARALLELISM", "LOGICAL_RULES", "_PARAM_RULES",
                            "use_mesh", "current_mesh", "_axes_for", "spec",
                            "constrain", "named_sharding", "_leaf_axes",
                            "param_specs", "param_shardings"],
        "launch.steps": ["batch_specs", "cache_specs", "LoweredStep",
                         "abstract_train_state", "_opt_moment_specs",
                         "make_train_step", "make_serve_step",
                         "make_prefill_step", "make_step"],
        "models.model": ["train_input_specs", "decode_input_specs",
                         "make_dummy_batch", "VLM_PATCHES"],
        "launch.dryrun": ["run_cell", "run_pbit", "main"],
        "runtime.compression": ["BLOCK", "Compressed", "compress",
                                "decompress", "ef_compress_tree",
                                "decompress_tree", "init_error"],
        "runtime.fault_tolerance": ["ElasticState"],
        "core.distributed": ["lattice_input_sharding"],
        "core.hardware": ["measure_node_transfer"],
    }
    for mod, attrs in names.items():
        m = importlib.import_module(f"repro_torch.{mod}")
        assert [a for a in attrs if not hasattr(m, a)] == [], mod
    for twin in ("serve_lm.py", "train_lm.py", "pbit_lattice_pod.py"):
        assert (ROOT / "examples_torch" / twin).exists(), twin


def test_dry_run_touches_no_card():
    """The dry run's modules import no CUDA state, and a full-width
    decode cell traces on fake and meta tensors only (a subprocess that
    hides every GPU)."""
    code = (
        "import sys, tempfile, torch\n"
        "from repro_torch.launch import dryrun\n"
        "from pathlib import Path\n"
        "rec = dryrun.run_cell('gemma2-2b', 'decode_32k', False,"
        " Path(tempfile.mkdtemp()), force=True)\n"
        "assert rec['status'] == 'ok', rec\n"
        "assert rec['memory']['argument_bytes'] > 0\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
