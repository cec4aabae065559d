"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, data-dependent
decay WKV, token-shift channel-mix FFN (relu^2)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1_6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/ssm_head_dim
    d_ff=7168, vocab_size=65536,
    block_type="rwkv6", ssm_head_dim=64, activation="relu2", glu=False,
)
