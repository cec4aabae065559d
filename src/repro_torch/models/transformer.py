"""Transformer assembly for the attention family: init / forward / loss /
decode (port of ``repro/models/transformer.py``).

``Transformer`` is an ``nn.Module`` whose ``named_parameters()`` names are
the JAX pytree's leaf paths: with ``cfg.scan_layers`` the blocks' leaves
are stacked on a leading L axis (``blocks.attn.wq`` of shape (L, D, H*hd))
as the JAX model scans them; otherwise ``blocks`` is a list
(``blocks.0.attn.wq``).  The functions below take the module or a flat
dict of those names (a train state's parameters), so one parameter set
serves forward, autograd and the optimizer.  ``cfg.remat`` wraps each
block in ``torch.utils.checkpoint`` (recompute everything, as the JAX
``nothing_saveable`` policy).  Decode threads per-layer KV caches stacked
on L; MoE decode uses capacity factor ``n_experts``, so it never drops a
token.

The recurrent blocks (``rwkv6``, ``mamba2``, the zamba2 hybrid) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (MLP, Embed, Init, embed_apply,
                                       mlp_apply, nest, rms_norm,
                                       unembed_apply)
from repro_torch.tree import flatten_with_paths

ParamsLike = Union[nn.Module, Mapping[str, torch.Tensor]]

NOT_PORTED = ("block_type {!r} is not ported yet: the recurrent blocks "
              "(models/rwkv.py, models/ssm.py) are ROADMAP.md queue 1 item 7")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_block_type(cfg: ModelConfig) -> None:
    if cfg.block_type != "attn" or cfg.hybrid_shared_every:
        raise NotImplementedError(NOT_PORTED.format(cfg.block_type))


def _attn_dims(cfg: ModelConfig) -> attn_mod.AttnDims:
    return attn_mod.AttnDims(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm, window=cfg.attn_window, rope_theta=cfg.rope_theta)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One attention block's parameters; ``lead=(L,)`` stacks L of them."""

    def __init__(self, cfg: ModelConfig, init: Init, lead=()):
        super().__init__()
        _check_block_type(cfg)
        dt, d = _dtype(cfg), cfg.d_model
        self.norm1 = init.zeros((*lead, d), dt)
        self.attn = attn_mod.Attention(init, d, _attn_dims(cfg), dt, lead)
        self.norm2 = init.zeros((*lead, d), dt)
        if cfg.is_moe:
            self.moe = moe_mod.MoE(init, d, cfg.d_ff, cfg.n_experts, cfg.glu,
                                   dt, lead)
        else:
            self.ffn = MLP(init, d, cfg.d_ff, cfg.glu, dt, lead)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, init: Init):
        super().__init__()
        _check_block_type(cfg)
        self.cfg = cfg
        dt = _dtype(cfg)
        self.embed = Embed(init, cfg.vocab_size, cfg.d_model,
                           cfg.tie_embeddings, dt)
        self.final_norm = init.zeros((cfg.d_model,), dt)
        if cfg.scan_layers:
            self.blocks = Block(cfg, init, lead=(cfg.n_layers,))
        else:
            self.blocks = nn.ModuleList(Block(cfg, init)
                                        for _ in range(cfg.n_layers))

    def forward(self, tokens=None, **kw):
        return forward(self.cfg, self, tokens, **kw)


def init(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (the JAX init's distributions: truncated normals scaled by
    1/sqrt(fan-in), embeddings at scale 1, zero norms and biases)."""
    return Transformer(cfg, Init(seed, resolve_device(device)))


def _torch_leaf(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(cfg: ModelConfig, tree, device="cuda") -> Transformer:
    """The JAX pytree (numpy arrays; blocks stacked on L when
    ``scan_layers``, a list otherwise) as the port's modules, leaf for
    leaf, each leaf keeping its dtype."""
    dev = resolve_device(device)
    model = Transformer(cfg, Init(device="meta"))
    state = {path: _torch_leaf(leaf).to(dev)
             for path, leaf in flatten_with_paths(tree)}
    model.load_state_dict(state, strict=True, assign=True)
    return model


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _tree(params: ParamsLike) -> Dict:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return nest(params)


def _unstack(tree, n: int) -> List:
    """A stacked-on-L block tree as n per-layer trees (``unbind``: views,
    whose gradients stack back in one copy)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in subs.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _layers(cfg: ModelConfig, blocks) -> List:
    if cfg.scan_layers:
        return _unstack(blocks, cfg.n_layers)
    return [blocks[str(i)] for i in range(cfg.n_layers)]


def _moe_kw(cfg: ModelConfig) -> Dict[str, Any]:
    return dict(top_k=cfg.n_experts_per_tok, activation=cfg.activation,
                glu=cfg.glu, dispatch_dtype=getattr(torch, cfg.moe_dispatch_dtype))


def _block_apply(cfg: ModelConfig, bp, x: torch.Tensor,
                 return_state: bool = False):
    """(x, aux, state): an MoE layer's aux (``lb_loss``, ``z_loss``,
    ``dropped_frac``), else {}; the layer's k/v when asked."""
    aux, state = {}, {}
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    dims = _attn_dims(cfg)
    if return_state:
        y, kv = attn_mod.attn_apply_with_kv(bp["attn"], h, dims)
        state.update(kv)
    else:
        y = attn_mod.attn_apply(bp["attn"], h, dims)
    x = x + y

    h = rms_norm(x, bp["norm2"], cfg.norm_eps)
    if cfg.is_moe:
        y, moe_aux = moe_mod.moe_apply(
            bp["moe"], h, capacity_factor=cfg.capacity_factor,
            group_size=cfg.moe_group_size, **_moe_kw(cfg))
        aux = moe_aux
    else:
        y = mlp_apply(bp["ffn"], h, cfg.activation, cfg.glu)
    x = x + y
    return x, aux, state


def forward(cfg: ModelConfig, params: ParamsLike,
            tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None, last_only: bool = False,
            return_state: bool = False):
    """Full-sequence forward: (logits, aux), or (logits, aux, states) with
    ``return_state`` (per-layer k/v stacked on L, the decode cache's
    layout).  ``last_only`` computes the last position's logits only.
    ``aux`` sums ``lb_loss`` and ``z_loss`` over layers; for MoE it also
    holds ``dropped_frac``, the mean over layers (the port's addition)."""
    _check_block_type(cfg)
    p = _tree(params)
    if embeds is not None:
        x = embeds.to(_dtype(cfg))          # modality-stub path (vlm/audio)
    else:
        x = embed_apply(p["embed"], tokens, cfg.embed_scale)

    remat = cfg.remat and not return_state and torch.is_grad_enabled()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    dropped, states = [], []
    for bp in _layers(cfg, p["blocks"]):
        if remat:
            x, a, st = checkpoint(_block_apply, cfg, bp, x, False,
                                  use_reentrant=False)
        else:
            x, a, st = _block_apply(cfg, bp, x, return_state)
        if a:
            aux = {"lb_loss": aux["lb_loss"] + a["lb_loss"],
                   "z_loss": aux["z_loss"] + a["z_loss"]}
            dropped.append(a["dropped_frac"])
        states.append(st)
    if dropped:
        aux["dropped_frac"] = torch.stack(dropped).mean()

    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:, :]
    logits = unembed_apply(p["embed"], x)
    if return_state:
        stacked = {k: torch.stack([st[k] for st in states])
                   for k in ("k", "v")}
        return logits, aux, stacked
    return logits, aux


def loss_fn(cfg: ModelConfig, params: ParamsLike, batch: Mapping, *,
            lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Next-token cross-entropy (+ MoE aux).  batch: tokens/embeds + labels
    (+ an optional float mask)."""
    logits, aux = forward(cfg, params, batch.get("tokens"),
                          embeds=batch.get("embeds"))
    labels = batch["labels"].long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    ce = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    total = ce
    if cfg.is_moe:
        total = total + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
    metrics = {"ce": ce, "lb_loss": aux["lb_loss"], "z_loss": aux["z_loss"]}
    return total, metrics


# ---------------------------------------------------------------------------
# Decode (single-token, cached)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda") -> Dict[str, Any]:
    """Per-layer caches stacked on L; ``pos`` a 0-d int32 tensor."""
    _check_block_type(cfg)
    dev = resolve_device(device)
    one = attn_mod.init_kv_cache(batch, max_len, _attn_dims(cfg),
                                 _dtype(cfg), dev)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": {k: torch.zeros((cfg.n_layers,) + v.shape,
                                      dtype=v.dtype, device=dev)
                       for k, v in one.items()}}


def decode_step(cfg: ModelConfig, params: ParamsLike, state: Mapping,
                tokens: torch.Tensor, *, return_aux: bool = False):
    """tokens: (B, 1) -> (logits (B,1,V), new state); with ``return_aux``
    also {"dropped_frac"} for MoE (0 by construction).  The input state
    is left as it was."""
    _check_block_type(cfg)
    p = _tree(params)
    pos = state["pos"]
    dims = _attn_dims(cfg)
    x = embed_apply(p["embed"], tokens, cfg.embed_scale)
    new_k, new_v, dropped = [], [], []
    for i, bp in enumerate(_layers(cfg, p["blocks"])):
        cache = {k: v[i] for k, v in state["layers"].items()}
        h = rms_norm(x, bp["norm1"], cfg.norm_eps)
        y, cache = attn_mod.attn_decode(bp["attn"], h, cache, pos, dims)
        new_k.append(cache["k"])
        new_v.append(cache["v"])
        x = x + y
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        if cfg.is_moe:
            # capacity = top_k * batch (cf = E): never drops, the exact
            # top-k mixture (serving must not lose tokens)
            y, a = moe_mod.moe_apply(
                bp["moe"], h, capacity_factor=float(cfg.n_experts),
                group_size=min(cfg.moe_group_size, h.shape[0]),
                **_moe_kw(cfg))
            dropped.append(a["dropped_frac"])
        else:
            y = mlp_apply(bp["ffn"], h, cfg.activation, cfg.glu)
        x = x + y

    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = unembed_apply(p["embed"], x)
    new_state = {"pos": pos + 1,
                 "layers": {"k": torch.stack(new_k), "v": torch.stack(new_v)}}
    if return_aux:
        aux = {"dropped_frac": torch.stack(dropped).mean()} if dropped else {}
        return logits, new_state, aux
    return logits, new_state
