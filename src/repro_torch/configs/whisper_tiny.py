"""Whisper tiny — encoder-decoder audio transformer; conv frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import EncDecCfg, ModelCfg

CONFIG = ModelCfg(
    name="whisper-tiny",
    family="audio",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    rope_kind="none",          # whisper uses learned positions
    enc_dec=EncDecCfg(enc_layers=4, enc_seq=1500),
    frontend="audio_stub",
    tie_embeddings=True,
    dtype="float32",           # tiny model; fp32 is fine even on TPU
)
