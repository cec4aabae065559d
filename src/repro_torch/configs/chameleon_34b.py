"""Chameleon-34B [arXiv:2405.09818]: early-fusion VLM backbone — VQ image
tokens share the 65536 vocab; qk-norm for stability.  Modality frontend is
a stub: train/prefill input_specs provide precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon_34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, activation="silu", glu=True, frontend="vision_stub",
)
