"""Shared neural building blocks (port of ``repro/models/layers.py``).

Each building block is an ``nn.Module`` that holds its parameters under
the JAX pytree's leaf names, and a function that applies a dict of those
parameters, as the JAX package does.  The conventions are the JAX ones:
``rms_norm`` scales by ``1 + scale`` in float32, gelu is the tanh
approximation, the embedding scale is ``sqrt(d)`` rounded to the state
dtype, and a tied unembedding is ``x @ embedding.T``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

Params = Mapping[str, torch.Tensor]


class Init:
    """Where and how parameters are made: one seeded generator drawn in
    order, on ``device``; on the ``"meta"`` device, shapes only."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.device = torch.device(device)
        self.generator = (None if self.device.type == "meta" else
                          torch.Generator(device=self.device).manual_seed(seed))

    def truncated_normal(self, shape, scale: float, dtype) -> nn.Parameter:
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        if self.generator is not None:
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                  generator=self.generator)
            t = t * scale
        return nn.Parameter(t.to(dtype))

    def dense(self, d_in: int, shape, dtype) -> nn.Parameter:
        return self.truncated_normal(shape, (1.0 / d_in) ** 0.5, dtype)

    def zeros(self, shape, dtype) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=dtype, device=self.device))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def activation_fn(name: str):
    return {
        "silu": torch.nn.functional.silu,
        "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
        "relu": torch.relu,
        "relu2": lambda x: torch.square(torch.relu(x)),
    }[name]


# ---------------------------------------------------------------------------
# MLP (optionally gated: SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, init: Init, d_model: int, d_ff: int, glu: bool,
                 dtype, lead=()):
        super().__init__()
        self.wi = init.dense(d_model, (*lead, d_model, d_ff), dtype)
        self.wo = init.dense(d_ff, (*lead, d_ff, d_model), dtype)
        if glu:
            self.wg = init.dense(d_model, (*lead, d_model, d_ff), dtype)


def mlp_apply(p: Params, x: torch.Tensor, activation: str,
              glu: bool) -> torch.Tensor:
    act = activation_fn(activation)
    h = x @ p["wi"]
    if glu:
        h = act(x @ p["wg"]) * h
    else:
        h = act(h)
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, init: Init, vocab: int, d_model: int, tie: bool,
                 dtype):
        super().__init__()
        self.embedding = init.truncated_normal((vocab, d_model), 1.0, dtype)
        if not tie:
            self.unembed = init.dense(d_model, (d_model, vocab), dtype)


def embed_apply(p: Params, tokens: torch.Tensor,
                scale: bool = False) -> torch.Tensor:
    x = torch.nn.functional.embedding(tokens.long(), p["embedding"])
    if scale:
        # sqrt(d) rounded to the state dtype, as a Python number (no
        # host-to-device copy); the product of two state-dtype values is
        # exact in float32, so the one rounding matches the JAX multiply
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype).item()
    return x


def unembed_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return x @ p["unembed"]
    return x @ p["embedding"].T.to(x.dtype)


def nest(flat: Mapping[str, torch.Tensor]) -> Dict:
    """``{"a.b.c": t}`` -> ``{"a": {"b": {"c": t}}}``: a module's
    ``named_parameters()`` as the JAX pytree's nesting."""
    out: Dict = {}
    for name, t in flat.items():
        *heads, leaf = name.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = t
    return out
