"""Mixtral-8x7B [arXiv:2401.04088]: 8 experts top-2, GQA kv=8,
sliding-window attention (4096)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    n_experts=8, n_experts_per_tok=2, attn_window=4096,
    activation="silu", glu=True, rope_theta=1_000_000.0,
)
