"""Jamba v0.1 52B — hybrid Mamba+attention 1:7, MoE 16e top-2 every 2 layers.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import HybridCfg, ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=14336, every=2),
    hybrid=HybridCfg(period=8, attn_index=4, d_state=16, d_conv=4, expand=2),
    rope_kind="none",  # Jamba uses no positional encoding (Mamba provides it)
)
