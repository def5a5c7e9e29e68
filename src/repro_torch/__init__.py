"""PyTorch/CUDA port of the p-bit chip system (`repro` is the JAX reference).

Same sub-package layout as the reference (`core/`, `kernels/`, `api/`) so
a reader finds each counterpart; `convert` carries numpy state across.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
