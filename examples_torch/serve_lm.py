"""LANGUAGE-MODEL serving example: batched prefill + decode for a
decoder-only transformer (thin wrapper over the LM demo entry point,
`repro_torch.launch.serve`).  Twin of ``examples/serve_lm.py`` on the
PyTorch/CUDA port.

Not the p-bit sampling service — that is `python -m repro_torch.serve`
(and examples_torch/serve_pbit.py).

Run:  PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]
(on the GPU unless ``--device cpu``.)
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(["--arch", "gemma2-2b", "--reduced", "--batch", "4",
          "--prompt-len", "32", "--gen", "32", *sys.argv[1:]])
