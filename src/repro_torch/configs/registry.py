"""Architecture registry: full assigned configs + reduced smoke variants
(a copy of ``repro/configs/registry.py``; the same reductions)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "codeqwen1_5_7b", "llama3_2_3b", "gemma_7b", "qwen2_72b", "chameleon_34b",
    "rwkv6_1_6b", "zamba2_1_2b", "mixtral_8x7b", "qwen3_moe_30b_a3b",
    "musicgen_large",
)

# CLI-friendly aliases (the assignment table's ids)
ALIASES = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "llama3.2-3b": "llama3_2_3b",
    "gemma-7b": "gemma_7b",
    "qwen2-72b": "qwen2_72b",
    "chameleon-34b": "chameleon_34b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-1.2b": "zamba2_1_2b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "musicgen-large": "musicgen_large",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; have {list(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    reductions: Dict[str, object] = dict(
        n_layers=2,
        d_model=64,
        d_ff=128 if not cfg.is_moe else 32,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads * 4 // cfg.n_heads, 4)),
        head_dim=16,
        moe_group_size=64,
        remat=False,
    )
    if cfg.is_moe:
        reductions["n_experts"] = min(cfg.n_experts, 8)
        reductions["n_experts_per_tok"] = min(cfg.n_experts_per_tok, 2)
    if cfg.block_type in ("rwkv6", "mamba2"):
        reductions["ssm_head_dim"] = 16
        if cfg.ssm_state:
            reductions["ssm_state"] = 16
    if cfg.hybrid_shared_every:
        reductions["hybrid_shared_every"] = 1
    if cfg.attn_window:
        reductions["attn_window"] = 32
    return dataclasses.replace(cfg, **reductions)  # type: ignore[arg-type]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
