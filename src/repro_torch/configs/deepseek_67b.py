"""DeepSeek 67B — dense llama-architecture, GQA kv=8. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
)
