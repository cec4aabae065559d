"""MusicGen-large [arXiv:2306.05284]: decoder-only transformer over EnCodec
tokens (vocab 2048 per codebook).  Backbone only — the EnCodec frontend is a
stub: train/prefill input_specs provide precomputed frame embeddings.
MHA (kv=32), GELU non-GLU FFN (T5-style backbone)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    activation="gelu", glu=False, frontend="audio_stub",
)
