"""Model architecture configs (`base`) and the ``--arch <id>`` registry."""
from repro_torch.configs.base import (LM_SHAPES, EncDecCfg, HybridCfg,
                                      ModelCfg, MoECfg, RWKVCfg, ShapeCfg,
                                      reduced, shape_applicable)
from repro_torch.configs.registry import (ARCH_IDS, PBIT_CONFIGS,
                                          all_cells, get_config,
                                          get_reduced_config, get_shape)

__all__ = ["LM_SHAPES", "EncDecCfg", "HybridCfg", "ModelCfg", "MoECfg",
           "RWKVCfg", "ShapeCfg", "reduced", "shape_applicable", "ARCH_IDS",
           "PBIT_CONFIGS", "all_cells", "get_config", "get_reduced_config",
           "get_shape"]
