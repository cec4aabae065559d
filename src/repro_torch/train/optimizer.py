"""Adam and the warmup-cosine schedule on dicts of tensors (port of
``repro/train/optimizer.py``).

The JAX update formula, written on tensors: bias-corrected moments, ``eps``
outside the square root, optional global-norm clipping and decoupled
weight decay.  Functional like the JAX optimizer: ``update`` returns new
parameters and a new state and changes neither input.  Parameters are flat
dicts (an LM's keyed by ``named_parameters()`` names).  Used by the
oscillator trainer (``core.ann.train``) and the LM train step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam/AdamW; moments in float32.  ``lr`` is a float or a schedule,
    a callable of the step (``state.step + 1``) that returns a float32
    value, as the JAX ``_lr_at`` reads it."""

    lr: Union[float, Callable[[int], float]] = 1e-4
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
        lr = float(np.float32(self.lr(step) if callable(self.lr) else self.lr))
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


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable[[int], np.float32]:
    """Linear warmup then cosine decay to ``final_frac * peak_lr``, in
    float32 in the JAX schedule's order of operations (its Python-float
    constants folded first, then rounded to float32 where they meet the
    step)."""
    f32 = np.float32
    warm_div = f32(max(warmup_steps, 1))
    decay_div = f32(max(total_steps - warmup_steps, 1))
    floor = f32(final_frac * peak_lr)
    amp = f32((1 - final_frac) * peak_lr * 0.5)

    def schedule(step) -> np.float32:
        s = f32(step)
        if s < f32(warmup_steps):
            return f32(f32(peak_lr) * s) / warm_div
        t = np.clip((s - f32(warmup_steps)) / decay_div, f32(0), f32(1))
        # cos of the float32 angle, rounded once (numpy's float32 cos is
        # off by an ulp where XLA's is not)
        cos = f32(np.cos(np.float64(f32(np.pi) * t)))
        return floor + amp * (f32(1) + cos)

    return schedule
