"""Mixture-of-Experts layer: top-k router + GShard-style capacity dispatch
(port of ``repro/models/moe.py``).

Tokens are split into groups of ``group_size``; each group dispatches to a
per-group expert capacity C = int(top_k * group_size * capacity_factor / E)
(at least 1).  The router runs in float32 whatever the model dtype; the
top-k gates are renormalised; each (token, choice) is ranked in its
expert's queue choice-major (every first choice before any second) by a
cumulative sum; the dispatch and combine tensors are one-hot einsums in
``dispatch_dtype``.  Returns the load-balancing and z losses and the
fraction of choices dropped at capacity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.models.layers import Init, Params, activation_fn


class MoE(nn.Module):
    def __init__(self, init: Init, d_model: int, d_ff: int, n_experts: int,
                 glu: bool, dtype, lead=()):
        super().__init__()
        self.router = init.dense(d_model, (*lead, d_model, n_experts),
                                 torch.float32)
        self.wi = init.dense(d_model, (*lead, n_experts, d_model, d_ff), dtype)
        self.wo = init.dense(d_ff, (*lead, n_experts, d_ff, d_model), dtype)
        if glu:
            self.wg = init.dense(d_model, (*lead, n_experts, d_model, d_ff),
                                 dtype)


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, activation: str,
              glu: bool, capacity_factor: float = 1.25,
              group_size: int = 1024,
              dispatch_dtype=torch.float32
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D), aux metrics dict."""
    b, s, d = x.shape
    e = p["wi"].shape[0]
    n_tok = b * s
    g_sz = min(group_size, n_tok)
    if n_tok % g_sz:
        raise ValueError(f"{n_tok} tokens not divisible by group {g_sz}")
    n_grp = n_tok // g_sz
    cap = max(int(top_k * g_sz * capacity_factor / e), 1)

    xt = x.reshape(n_grp, g_sz, d)
    logits = xt.float() @ p["router"]                         # (G, t, E)
    probs = torch.softmax(logits, dim=-1)

    # --- top-k gating with renormalization (Mixtral-style) ---
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)   # (G, t, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # --- capacity assignment: position of each (token, choice) in its queue
    sel_onehot = nn.functional.one_hot(gate_idx, e).float()  # (G,t,k,E)
    # priority: iterate choices first (all 1st choices ranked before 2nd)
    sel_flat = sel_onehot.transpose(1, 2).reshape(n_grp, top_k * g_sz, e)
    pos_in_expert = torch.cumsum(sel_flat, dim=1) - sel_flat   # (G,k*t,E)
    pos_in_expert = pos_in_expert.reshape(n_grp, top_k, g_sz, e).transpose(1, 2)
    within_cap = pos_in_expert < cap                            # (G,t,k,E)
    kept = (sel_onehot * within_cap).sum(-1)                    # (G,t,k)

    # --- dispatch/combine tensors ---
    dd = dispatch_dtype
    cap_onehot = nn.functional.one_hot(
        torch.clamp(pos_in_expert, 0, cap - 1).long(), cap).to(dd)
    dispatch = torch.einsum("gtke,gtkec->gtec",
                            (sel_onehot * within_cap).to(dd), cap_onehot)
    combine = torch.einsum("gtk,gtke,gtkec->gtec",
                           (gate_vals * kept).to(dd), sel_onehot.to(dd),
                           cap_onehot)

    xe = torch.einsum("gtd,gtec->gecd", xt.to(dd), dispatch).to(x.dtype)

    # --- expert FFN: (G,E,C,D) x (E,D,F) ---
    act = activation_fn(activation)
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"])
    if glu:
        h = act(torch.einsum("gecd,edf->gecf", xe, p["wg"])) * h
    else:
        h = act(h)
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"])

    out = torch.einsum("gecd,gtec->gtd", ye.to(dd), combine)
    out = out.reshape(b, s, d).to(x.dtype)

    # --- aux losses ---
    me = probs.mean(dim=(0, 1))                  # mean router prob per expert
    ce = sel_onehot.sum(2).mean(dim=(0, 1))      # fraction routed per expert
    lb_loss = e * torch.sum(me * ce) / top_k
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - kept.mean()
    return out, {"lb_loss": lb_loss, "z_loss": z_loss, "dropped_frac": dropped}
