"""The port's model configs and registry (`repro_torch.configs`) against
the reference's (`repro.configs`): every architecture id gives the same
config field for field, full and reduced, with the same derived counts and
shape rules."""
import dataclasses

import pytest

from repro.configs import base as ref_base
from repro.configs import registry as ref_registry
from repro_torch.configs import base, registry

ARCHS = ref_registry.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for get in ("get_config", "get_reduced_config"):
        port = getattr(registry, get)(arch)
        ref = getattr(ref_registry, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        assert port.hd() == ref.hd()
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.attn_free == ref.attn_free
        assert port.sub_quadratic() == ref.sub_quadratic()
        for name in ref_base.LM_SHAPES:
            assert base.shape_applicable(port, base.LM_SHAPES[name]) == \
                ref_base.shape_applicable(ref, ref_base.LM_SHAPES[name])


def test_shapes_pbit_configs_and_cells_match_reference():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert set(registry._ARCH_MODULES) == set(ref_registry._ARCH_MODULES)
    assert {k: dataclasses.asdict(v) for k, v in base.LM_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.LM_SHAPES.items()}
    assert registry.PBIT_CONFIGS == ref_registry.PBIT_CONFIGS
    assert registry.all_cells() == ref_registry.all_cells()
    assert len(registry.all_cells()) == 40
    for name in base.LM_SHAPES:
        assert dataclasses.asdict(registry.get_shape(name)) == \
            dataclasses.asdict(ref_registry.get_shape(name))


def test_reduced_overrides_and_unknown_arch():
    cfg = registry.get_config("gemma2-9b")
    port = base.reduced(cfg, dtype="bfloat16", d_model=3584)
    ref = ref_base.reduced(ref_registry.get_config("gemma2-9b"),
                           dtype="bfloat16", d_model=3584)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("gpt-5")
