"""``--arch <id>`` registry for all assigned architectures (+ the paper's own
p-bit lattice configs)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import LM_SHAPES, ModelCfg, ShapeCfg, reduced

_ARCH_MODULES = {
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v0_1_52b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)

# The paper's own architecture: Chimera p-bit lattices (cells_rows x cells_cols)
PBIT_CONFIGS = {
    "pbit-chip-440": dict(cell_rows=7, cell_cols=8, masked=((6, 7),)),
    "pbit-pod-2m": dict(cell_rows=512, cell_cols=512, masked=()),
    "pbit-pod-33m": dict(cell_rows=2048, cell_cols=2048, masked=()),
}


def get_config(arch: str) -> ModelCfg:
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_reduced_config(arch: str) -> ModelCfg:
    return reduced(get_config(arch))


def get_shape(name: str) -> ShapeCfg:
    return LM_SHAPES[name]


def all_cells() -> list[tuple[str, str]]:
    """All 40 assigned (arch x shape) cells, including skipped ones."""
    return [(a, s) for a in ARCH_IDS for s in LM_SHAPES]
