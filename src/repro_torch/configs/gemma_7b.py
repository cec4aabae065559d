"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256, kv=16, embeddings
scaled by sqrt(d_model), tied unembedding."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma_7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    activation="gelu", glu=True, tie_embeddings=True, embed_scale=True,
)
