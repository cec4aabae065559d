"""Adam on dicts of tensors (port of ``repro/train/optimizer.py``'s Adam).

The JAX update formula, written on tensors: bias-corrected moments, ``eps``
outside the square root, optional global-norm clipping and decoupled
weight decay.  Functional like the JAX optimizer: ``update`` returns new
parameters and a new state and changes neither input.  Used by the
oscillator trainer (``core.ann.train``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam/AdamW with a constant learning rate; moments in float32."""

    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params: Params) -> AdamState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(step=0, mu={k: zeros(p) for k, p in params.items()},
                         nu={k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params):
        """Returns (new_params, new_state)."""
        step = state.step + 1
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (global_norm(grads) + 1e-12),
                                max=1.0)
            grads = {k: g * scale for k, g in grads.items()}
        b1, b2 = self.b1, self.b2
        mu = {k: b1 * m + (1 - b1) * grads[k].to(m.dtype)
              for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * torch.square(grads[k].to(v.dtype))
              for k, v in state.nu.items()}
        # 1 - b**step in float32, as the JAX optimizer computes it (float32
        # values, so a tensor op reads them exactly)
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
        lr = float(self.lr)
        new_params = {}
        for k, p in params.items():
            delta = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(delta.dtype)
            new_params[k] = (p.float() - lr * delta).to(p.dtype)
        return new_params, AdamState(step=step, mu=mu, nu=nu)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in float32."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves))
