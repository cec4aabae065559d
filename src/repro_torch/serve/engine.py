"""Serving: prefill + batched decode over the transformer's cached decode
path (port of ``repro/serve/engine.py``).

As in the JAX engine, ``prefill`` takes its logits from ``forward`` and
fills the decode state by replaying the prompt token by token through
``decode_step`` (the reference formulation; a production prefill would
fill the cache inside ``forward``).  Everything runs without autograd.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, state, tokens (B,1)) -> (logits, state)."""

    @torch.no_grad()
    def serve_step(params, state, tokens):
        return tf.decode_step(cfg, params, state, tokens)

    return serve_step


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, Any]:
    """(last-token logits (B, V), decode state after the prompt)."""
    b, s = tokens.shape
    logits, _ = tf.forward(cfg, params, tokens)
    state = tf.init_decode_state(cfg, b, max_len, device=tokens.device)
    for t in range(s):
        _, state = tf.decode_step(cfg, params, state, tokens[:, t:t + 1])
    return logits[:, -1], state


@torch.no_grad()
def greedy_generate(cfg: ModelConfig, params, prompt: torch.Tensor,
                    n_new: int, max_len: int) -> torch.Tensor:
    """Greedy decoding; returns (B, n_new) token ids: the tokens decoded
    after the prefill's argmax, as the JAX engine returns them."""
    last_logits, state = prefill(cfg, params, prompt, max_len)
    tok = torch.argmax(last_logits, dim=-1)[:, None]
    out = []
    for _ in range(n_new):
        logits, state = tf.decode_step(cfg, params, state, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok[:, 0])
    if not out:
        return prompt.new_zeros((prompt.shape[0], 0))
    return torch.stack(out, dim=1)
