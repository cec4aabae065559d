"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B]: GQA kv=8, SwiGLU, tied
embeddings, rope theta 500k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_2_3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=128256,
    activation="silu", glu=True, rope_theta=500_000.0, tie_embeddings=True,
)
