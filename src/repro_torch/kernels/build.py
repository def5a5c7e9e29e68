"""Build and load the package's CUDA kernels.

``csrc/*.cu`` files have a plain C interface.  `load("name")` compiles
``csrc/name.cu`` with ``nvcc`` for ``sm_90a`` into a shared library and
opens it with `ctypes` — at first use, never at import.  The library is
keyed on the hash of the source and of every ``csrc`` header it includes,
so an edited source or header rebuilds and an unchanged one is reused.
`build_all` compiles several libraries at once, one ``nvcc`` each.
Libraries go to ``$REPRO_TORCH_BUILD_DIR`` or, by default, ``build/`` at
the root of the source checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
LIBRARIES = ("sweep_sparse", "pbit_update", "sweep_fused", "lattice_update",
             "sweep_exchange")
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

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


def sources(name: str) -> list[Path]:
    """``csrc/name.cu`` and every ``csrc`` file it includes, transitively
    (``#include "..."``), in a fixed order."""
    seen: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(name):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _nvcc(name: str, out: Path) -> tuple[subprocess.Popen, Path]:
    """Start ``nvcc`` on ``csrc/name.cu``; its output goes to a log file
    beside the library (a pipe could fill and stall a polled process)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(tmp.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    proc.wait()
    log = tmp.with_suffix(".log")
    text = log.read_text()
    log.unlink()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{text}")
    os.replace(tmp, out)  # atomic: no process ever loads a half-written file


def build(name: str) -> Path:
    """Compile ``csrc/name.cu`` unless its library already exists."""
    out = library_path(name)
    if not out.exists():
        _finish(name, *_nvcc(name, out), out)
    return out


def build_all(names=LIBRARIES) -> dict[str, float]:
    """Compile the named libraries in parallel (one ``nvcc`` each, all
    started together); returns each library's seconds from the start to
    its own end (0.0 for one that was already built).  A failed build
    stops the others and raises."""
    t0 = time.perf_counter()
    seconds = {name: 0.0 for name in names}
    running = {}
    try:
        for name in names:
            out = library_path(name)
            if not out.exists():
                running[name] = (*_nvcc(name, out), out)
        while running:
            for name in [n for n, r in running.items()
                         if r[0].poll() is not None]:
                _finish(name, *running.pop(name))
                seconds[name] = time.perf_counter() - t0
            time.sleep(0.02)
    finally:
        for proc, tmp, _ in running.values():
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
            tmp.with_suffix(".log").unlink(missing_ok=True)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/name.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
