"""IBM Granite 3.0 1B-A400M — MoE 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ModelCfg, MoECfg

CONFIG = ModelCfg(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoECfg(num_experts=32, top_k=8, d_ff_expert=512),
    tie_embeddings=True,
)
