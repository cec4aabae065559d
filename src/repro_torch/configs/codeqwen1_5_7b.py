"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: Qwen1.5 arch — MHA (kv=32),
QKV bias, SwiGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1_5_7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    qkv_bias=True, activation="silu", glu=True, rope_theta=1_000_000.0,
)
