"""Core p-bit probabilistic computing library (the paper's contribution).

Counterpart of ``repro.core``: the same exported names and `__all__`.
The names resolve on first use (PEP 562): the kernels import
`core.lfsr` and `core.hardware`, and `core.cd` imports `api`, whose spec
imports the kernels, so importing `core.cd` here would close that loop
for whichever module a caller happens to import first.
"""
import importlib

_EXPORTS = {
    "ChimeraGraph": "chimera", "make_chimera": "chimera",
    "make_chip_graph": "chimera",
    "EffectiveChip": "hardware", "HardwareConfig": "hardware",
    "Mismatch": "hardware", "SparseMismatch": "hardware",
    "attach_sparse": "hardware", "ideal_chip": "hardware",
    "program_weights": "hardware", "program_weights_sparse": "hardware",
    "sample_mismatch": "hardware", "sample_mismatch_sparse": "hardware",
    "CDConfig": "cd", "PBitMachine": "cd", "train_cd": "cd",
    "AnnealConfig": "annealing", "anneal": "annealing",
    "sk_instance": "annealing",
    "random_chimera_maxcut": "maxcut", "solve_maxcut": "maxcut",
    "PTConfig": "tempering", "parallel_tempering": "tempering",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
