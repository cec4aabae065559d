"""Gradient compression with error feedback (port of
``repro/distributed/compression.py``).

int8 symmetric per-block quantization (blocks of 256 values, scale =
max|block| / 127) applied to gradients before the optimizer, with an error
feedback accumulator so the quantization error is re-injected next step.
``noise_fn(n)`` may supply n uniform [0, 1) values for stochastic rounding
(a chaotic stream's ``uniform`` among them); as in the JAX code it must
then cover a whole number of blocks.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
BLOCK = 256


def _quantize_leaf(g: torch.Tensor, noise: Optional[torch.Tensor] = None):
    """int8 symmetric per-block quantization.  Returns (q, scales)."""
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    scaled = blocks / scale
    if noise is not None:
        scaled = scaled + noise.reshape(scaled.shape) - 0.5   # stochastic
    q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                     dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:shape.numel()].reshape(shape).to(dtype)


def compress_grads(grads: Params, error_buf: Optional[Params] = None,
                   noise_fn: Optional[Callable[[int], object]] = None
                   ) -> Tuple[Params, Params]:
    """Quantize->dequantize each gradient with error feedback.  Returns
    (compensated grads, new error buffer), keyed as ``grads``."""
    if error_buf is None:
        error_buf = {k: torch.zeros_like(g, dtype=torch.float32)
                     for k, g in grads.items()}
    comp, errs = {}, {}
    for k, g in grads.items():
        g32 = g.float() + error_buf[k]
        noise = None
        if noise_fn is not None:
            noise = torch.as_tensor(noise_fn(g32.numel()),
                                    dtype=torch.float32, device=g.device)
        q, s = _quantize_leaf(g32, noise)
        deq = _dequantize_leaf(q, s, g.shape, torch.float32)
        errs[k] = g32 - deq
        comp[k] = deq.to(g.dtype)
    return comp, errs
