"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone (38 layers, state=64)
with ONE shared attention+MLP block applied every 6th layer (weight reuse)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_1_2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    block_type="mamba2", ssm_state=64, ssm_head_dim=64, conv_width=4,
    hybrid_shared_every=6, activation="gelu", glu=True,
)
