"""Train-step builder: microbatched gradient accumulation, remat, optional
gradient compression (port of ``repro/train/train_step.py``).

``train_step(state, batch)`` is functional like the JAX one: it returns a
new ``TrainState`` and leaves the old one as it was.  Parameters are a
flat dict keyed by ``Transformer.named_parameters()`` names (the JAX
pytree's leaf paths).  Gradients accumulate in float32.  With n
microbatches, batch row ``i*n + j`` goes to microbatch j, as the JAX
split does, and the returned metrics are the last microbatch's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import compress_grads
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import Adam, AdamState, global_norm

Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    step: int
    params: Params
    opt: AdamState
    error_buf: Optional[Params] = None   # gradient-compression feedback


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    num_microbatches: int = 1
    compress_grads: bool = False
    lb_coef: float = 0.01
    z_coef: float = 1e-3


def state_from_params(params: Params, opt: Adam,
                      use_compression: bool = False) -> TrainState:
    """A step-0 train state over ``params`` (a flat dict of tensors)."""
    params = {k: p.detach() for k, p in params.items()}
    ebuf = None
    if use_compression:
        ebuf = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return TrainState(step=0, params=params, opt=opt.init(params),
                      error_buf=ebuf)


def init_train_state(cfg: ModelConfig, opt: Adam, seed: int = 0,
                     use_compression: bool = False,
                     device="cuda") -> TrainState:
    model = tf.init(cfg, seed, device)
    return state_from_params(dict(model.named_parameters()), opt,
                             use_compression)


def make_train_step(cfg: ModelConfig, opt: Adam,
                    ts_cfg: TrainStepConfig) -> Callable:
    """Build the train step.  Batch leaves have leading dim global_batch;
    microbatching splits dim 0."""

    def grad_fn(params: Params, mb):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            loss, metrics = tf.loss_fn(cfg, leaves, mb, lb_coef=ts_cfg.lb_coef,
                                       z_coef=ts_cfg.z_coef)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for (k, p), g in zip(leaves.items(), grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        n_mb = ts_cfg.num_microbatches
        if n_mb == 1:
            l, metrics, grads = grad_fn(state.params, batch)
            grads = {k: g.float() for k, g in grads.items()}
        else:
            l = 0.0
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in state.params.items()}
            for j in range(n_mb):
                mb = {k: v[j::n_mb] for k, v in batch.items()}
                lj, metrics, g = grad_fn(state.params, mb)
                for k, gk in g.items():
                    grads[k] += gk.float() / n_mb
                l = l + lj / n_mb

        error_buf = state.error_buf
        if ts_cfg.compress_grads and error_buf is not None:
            grads, error_buf = compress_grads(grads, error_buf)

        gnorm = global_norm(grads)
        params, opt_state = opt.update(grads, state.opt, state.params)
        metrics = dict(metrics, loss=l, grad_norm=gnorm)
        return TrainState(step=state.step + 1, params=params, opt=opt_state,
                          error_buf=error_buf), metrics

    return train_step

