"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts top-8, expert
d_ff=768, GQA kv=4, head_dim=128, qk-norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_30b_a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936,
    n_experts=128, n_experts_per_tok=8, qk_norm=True,
    activation="silu", glu=True, rope_theta=1_000_000.0,
)
