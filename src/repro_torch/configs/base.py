"""Model and shape configuration dataclasses of the LM stack (a copy of
``repro/configs/base.py``: the port imports nothing of the JAX package)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One LM-family architecture.  Field semantics follow the assignment
    table; every assigned arch maps onto this single config surface."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    block_type: str = "attn"           # 'attn' | 'rwkv6' | 'mamba2'
    activation: str = "silu"           # silu | gelu | relu | relu2
    glu: bool = True                   # gated MLP (SwiGLU / GeGLU)
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_window: Optional[int] = None  # sliding-window attention
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma: scale embeddings by sqrt(d)
    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024         # GShard dispatch group (tokens)
    moe_dispatch_dtype: str = "float32"  # bf16 quarters f32-MXU dispatch cost
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    conv_width: int = 4
    hybrid_shared_every: int = 0       # zamba2: shared attn block period
    # modality frontend: 'text' | 'vision_stub' | 'audio_stub'
    frontend: str = "text"
    # numerics / structure
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    # arch family tag for reporting
    family: str = "dense"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.block_type in ("rwkv6", "mamba2") and self.hybrid_shared_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (see DESIGN.md §5)."""
        return self.block_type in ("rwkv6", "mamba2") or self.attn_window is not None

    def n_params(self) -> int:
        """Analytical parameter count (embedding included once if tied)."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        per_layer = 0
        if self.block_type == "attn":
            per_layer += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            if self.qkv_bias:
                per_layer += (self.n_heads + 2 * self.n_kv_heads) * hd
        elif self.block_type == "rwkv6":
            per_layer += 4 * d * d + d * (d // 2)   # r,k,v,g,o-ish + decay lora
        elif self.block_type == "mamba2":
            d_in = 2 * d
            per_layer += d * (2 * d_in + 2 * self.ssm_state) + d_in * d \
                + d_in * self.conv_width
        if self.is_moe:
            per_layer += d * self.n_experts + self.n_experts * (
                (3 if self.glu else 2) * d * f)
        elif self.block_type != "mamba2":   # mamba2 blocks carry no FFN
            per_layer += (3 if self.glu else 2) * d * f
        per_layer += 2 * d  # norms
        total = self.n_layers * per_layer
        if self.hybrid_shared_every:
            # one shared attention+MLP block (weights reused)
            total += d * (self.n_heads * hd) * 2 + 2 * d * (self.n_kv_heads * hd) \
                + (3 if self.glu else 2) * d * self.d_ff
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_ffn = self.n_experts * ((3 if self.glu else 2) * d * f)
        active_ffn = self.n_experts_per_tok * ((3 if self.glu else 2) * d * f)
        return self.n_params() - self.n_layers * (dense_ffn - active_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (workload cell)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'
    num_microbatches: int = 1     # train-only: gradient accumulation

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape set for an arch, with the documented long_500k skip."""
    base = (TRAIN_4K, PREFILL_32K, DECODE_32K)
    if cfg.sub_quadratic:
        return base + (LONG_500K,)
    return base
