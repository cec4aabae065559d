"""GQA attention: full-causal, sliding-window, blockwise-flash and decode
paths (port of ``repro/models/attention.py``).

The JAX formulation, written in PyTorch: the masked-score path for short
sequences; above ``FLASH_THRESHOLD`` a blockwise online-softmax loop over
(``FLASH_BLOCK_Q`` x ``FLASH_BLOCK_KV``) tiles, so no S x S score matrix
is made; decode attends one query against a KV cache, a ring buffer for
sliding-window attention (``slot = pos % cache_len``, validity by age).
GQA maps query head ``h`` to kv head ``h // g`` by viewing q as
(B, S, KV, G, hd).  RoPE rotates split halves.  The thresholds are read
at call time, so tests may patch them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers import Init, Params, rms_norm

FLASH_THRESHOLD = 8192   # seq len beyond which the blockwise-flash path is used
FLASH_BLOCK_Q = 1024
FLASH_BLOCK_KV = 1024
MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None
    rope_theta: float = 10_000.0


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python base: no host-to-device copy, so no wait for the device
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]                        # (..., S, 1, hd/2)
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, init: Init, d_model: int, dims: AttnDims, dtype,
                 lead=()):
        super().__init__()
        h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
        self.wq = init.dense(d_model, (*lead, d_model, h * hd), dtype)
        self.wk = init.dense(d_model, (*lead, d_model, kv * hd), dtype)
        self.wv = init.dense(d_model, (*lead, d_model, kv * hd), dtype)
        self.wo = init.dense(h * hd, (*lead, h * hd, d_model), dtype)
        if dims.qkv_bias:
            self.bq = init.zeros((*lead, h * hd), dtype)
            self.bk = init.zeros((*lead, kv * hd), dtype)
            self.bv = init.zeros((*lead, kv * hd), dtype)
        if dims.qk_norm:
            self.q_norm = init.zeros((*lead, hd), dtype)
            self.k_norm = init.zeros((*lead, hd), dtype)


def _project_qkv(p: Params, x: torch.Tensor, dims: AttnDims,
                 positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if dims.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if dims.qk_norm:
        # the default eps, not cfg.norm_eps, as the JAX model does
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, dims.rope_theta)
    k = apply_rope(k, positions, dims.rope_theta)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,KV,G,hd), k: (B,Skv,KV,hd) -> (B,KV,G,Sq,Skv)."""
    return torch.einsum("bqkgh,bskh->bkgqs", q, k)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,KV,G,Sq,Skv), v: (B,Skv,KV,hd) -> (B,Sq,KV,G,hd)."""
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def _causal_mask(sq: int, skv: int, q_off: int, window: Optional[int],
                 device) -> torch.Tensor:
    qpos = q_off + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _plain_attention(q, k, v, dims: AttnDims) -> torch.Tensor:
    b, s, h, hd = q.shape
    kv = dims.n_kv_heads
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = _gqa_scores(qg, k).float() / (hd ** 0.5)
    mask = _causal_mask(s, s, 0, dims.window, q.device)
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = _gqa_out(probs, v)
    return out.reshape(b, s, h, hd)


def _flash_attention(q, k, v, dims: AttnDims) -> torch.Tensor:
    """Blockwise online-softmax attention (no S x S materialization)."""
    b, s, h, hd = q.shape
    kv = dims.n_kv_heads
    g = h // kv
    bq, bkv = FLASH_BLOCK_Q, FLASH_BLOCK_KV
    nq, nkv = s // bq, s // bkv
    if s % bq or s % bkv:
        raise ValueError(f"seq {s} not divisible by flash blocks")

    qg = q.reshape(b, nq, bq, kv, g, hd).permute(1, 0, 3, 4, 2, 5)  # (nq,b,kv,g,bq,hd)
    kb = k.reshape(b, nkv, bkv, kv, hd).permute(1, 0, 3, 2, 4)      # (nkv,b,kv,bkv,hd)
    vb = v.reshape(b, nkv, bkv, kv, hd).permute(1, 0, 3, 2, 4)
    scale = 1.0 / (hd ** 0.5)
    ar_q = torch.arange(bq, device=q.device)[:, None]
    ar_kv = torch.arange(bkv, device=q.device)[None, :]

    blocks = []
    for qi in range(nq):
        qblk = qg[qi]                                   # (b,kv,g,bq,hd)
        m = torch.full((b, kv, g, bq), MASK_VALUE, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, bq), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, kv, g, bq, hd), dtype=torch.float32,
                        device=q.device)
        for ki in range(nkv):
            s_blk = torch.einsum("bkgqh,bksh->bkgqs", qblk,
                                 kb[ki]).float() * scale
            qpos = qi * bq + ar_q
            kpos = ki * bkv + ar_kv
            mask = kpos <= qpos
            if dims.window is not None:
                mask &= kpos > qpos - dims.window
            s_blk = torch.where(mask, s_blk, MASK_VALUE)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            pr = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", pr.to(qblk.dtype), vb[ki]).float()
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        blocks.append(o.to(q.dtype))
    # (nq, b, kv, g, bq, hd) -> (b, s, h, hd)
    return torch.stack(blocks).permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, hd)


def _attend(q, k, v, dims: AttnDims) -> torch.Tensor:
    if q.shape[1] > FLASH_THRESHOLD:
        return _flash_attention(q, k, v, dims)
    return _plain_attention(q, k, v, dims)


def _positions(x: torch.Tensor, positions) -> torch.Tensor:
    if positions is None:
        return torch.arange(x.shape[1], device=x.device)[None, :]
    return positions


def attn_apply(p: Params, x: torch.Tensor, dims: AttnDims,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (train / prefill) attention."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, dims, _positions(x, positions))
    out = _attend(q, k, v, dims)
    return out.reshape(b, s, dims.n_heads * dims.head_dim) @ p["wo"]


def attn_apply_with_kv(p: Params, x: torch.Tensor, dims: AttnDims,
                       positions: Optional[torch.Tensor] = None):
    """Prefill: also return the rotated k/v.  For sliding-window attention
    only the last ``window`` positions are kept."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, dims, _positions(x, positions))
    out = _attend(q, k, v, dims)
    if dims.window is not None and s > dims.window:
        k, v = k[:, -dims.window:], v[:, -dims.window:]
    return (out.reshape(b, s, dims.n_heads * dims.head_dim) @ p["wo"],
            {"k": k, "v": v})


# ---------------------------------------------------------------------------
# Decode with KV cache (full or ring/SWA)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, dims: AttnDims, dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    cache_len = min(max_len, dims.window) if dims.window else max_len
    shape = (batch, cache_len, dims.n_kv_heads, dims.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: torch.Tensor,
                dims: AttnDims) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, D); pos: 0-d int32 tensor (the current
    index), kept on the device so a step never waits for the host."""
    b = x.shape[0]
    h, kv, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    positions = pos.expand(b, 1)
    q, k, v = _project_qkv(p, x, dims, positions)

    cache_len = cache["k"].shape[1]
    # a full cache clamps a write past its end, as dynamic_update_slice does
    slot = pos % cache_len if dims.window else torch.clamp(pos, max=cache_len - 1)
    slot1 = slot.reshape(1).long()
    k_cache = cache["k"].index_copy(1, slot1, k.to(cache["k"].dtype))
    v_cache = cache["v"].index_copy(1, slot1, v.to(cache["v"].dtype))

    g = h // kv
    qg = q.reshape(b, 1, kv, g, hd)
    scores = _gqa_scores(qg, k_cache).float() / (hd ** 0.5)  # (b,kv,g,1,C)

    idx = torch.arange(cache_len, device=x.device)
    if dims.window:
        # ring buffer: valid entries are the last min(pos+1, window) writes
        age = (slot - idx) % cache_len
        valid = age < torch.clamp(pos + 1, max=cache_len)
    else:
        valid = idx <= pos
    scores = torch.where(valid, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(probs, v_cache).reshape(b, 1, h * hd)
    return out @ p["wo"], {"k": k_cache, "v": v_cache}
