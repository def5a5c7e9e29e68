"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 + 1 shared expert,
first layer dense (paper-table). [arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,                # the single dense layer's FFN
    vocab_size=163840,
    moe=MoECfg(num_experts=384, top_k=8, d_ff_expert=2048,
               num_shared=1, first_dense=1),
)
