"""Gemma 2 2B — local/global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelCfg

CONFIG = ModelCfg(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    attn_type="local_global",
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    scale_embed=True,
    post_norms=True,
)
