"""Build and load the package's CUDA kernels.

``csrc/*.cu`` files have a plain C interface.  `load("name")` compiles
``csrc/name.cu`` with ``nvcc`` for ``sm_90a`` into a shared library and
opens it with `ctypes` — at first use, never at import.  The library is
keyed on the source's hash, so an edited source rebuilds and an unchanged
one is reused.  Libraries go to ``$REPRO_TORCH_BUILD_DIR`` or, by default,
``build/`` at the root of the source checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # decisions must round like the eager PyTorch version: no FMA
    # contraction, and never --use_fast_math (tanhf stays libdevice's)
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are compiled at first use and "
            "need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/name.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: no process ever loads a half-written file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/name.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
