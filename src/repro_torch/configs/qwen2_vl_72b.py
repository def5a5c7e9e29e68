"""Qwen2-VL 72B — M-RoPE, dynamic resolution; vision frontend is a STUB
(input_specs provides precomputed patch embeddings + 3D positions).
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    frontend="vision_stub",
)
