"""Plain PyTorch versions of the oscillator kernels.

Unlike ``repro/kernels/ref.py`` (an ``x @ w`` formulation), these scan the
*kernel's* step: the vpu order of ``repro/kernels/chaotic_ann.py``
(``_make_step``, the broadcast multiply-adds), with every multiply and add
a separate op in the state dtype.  So bf16 rounds after every op, as the
Pallas kernel does, and the CUDA kernels of ``chaotic_ann.cu`` can be held
to these versions bitwise.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.kernels import ops

ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid}


def make_step(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, *, dtype: torch.dtype,
              activation: str = "relu"
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """One oscillator step on (S, I) states, in the vpu order.

    ``h`` accumulates ``w1[i] * x[:, i]`` over ``i`` from zeros, then
    ``phi(h + b1)``; ``y`` accumulates ``w2[j] * h[:, j]`` over ``j`` from
    zeros, then ``+ b2``.  Weights are cast to ``dtype`` once, here.
    """
    phi = ACTIVATIONS[activation]
    w1, b1, w2, b2 = (t.to(dtype) for t in (w1, b1, w2, b2))
    i_dim, h_dim = w1.shape

    def step(x: torch.Tensor) -> torch.Tensor:
        h = torch.zeros((x.shape[0], h_dim), dtype=dtype, device=x.device)
        for i in range(i_dim):
            h = h + w1[i][None, :] * x[:, i:i + 1]
        h = phi(h + b1)
        y = torch.zeros_like(x)
        for j in range(h_dim):
            y = y + w2[j][None, :] * h[:, j:j + 1]
        return y + b2

    return step


def chaotic_ann_ref(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, x0: torch.Tensor, n_steps: int,
                    activation: str = "relu") -> torch.Tensor:
    """Plain K2: the (n_steps, S, I) trajectory after x0, in x0's dtype."""
    step = make_step(w1, b1, w2, b2, dtype=x0.dtype, activation=activation)
    traj = torch.empty((n_steps,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    x = x0
    for t in range(n_steps):
        x = step(x)
        traj[t] = x
    return traj


def chaotic_ann_bits_ref(w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         x0: torch.Tensor, n_steps: int, word_offset=0,
                         activation: str = "relu"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: the step scan, then ``ops.pack_words``.

    Returns (n_steps // 2, S) uint32 words and the (S, I) final state.
    """
    if n_steps < 2 or n_steps % 2:
        raise ValueError(f"n_steps must be even and >= 2, got {n_steps}")
    traj = chaotic_ann_ref(w1, b1, w2, b2, x0, n_steps, activation)
    return ops.pack_words(traj, word_offset), traj[-1].clone()
