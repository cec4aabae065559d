"""Qwen2-72B [arXiv:2407.10671]: GQA kv=8, QKV bias, SwiGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True, activation="silu", glu=True, rope_theta=1_000_000.0,
)
