"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelCfg, RWKVCfg

CONFIG = ModelCfg(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,              # 2560 / 64 wkv heads
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rope_kind="none",
    rwkv=RWKVCfg(head_dim=64, decay_lora=64),
)
