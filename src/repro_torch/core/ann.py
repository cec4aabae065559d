"""The HENNC I-H-I oscillator net as PyTorch tensors (port of the parts of
``repro/core/ann.py`` that serving needs; training is not ported).

Parameters cross between the two packages as numpy arrays: the JAX
package's bundles (``extract_parameters``, the registry npz files) are
dicts of float32 arrays ``w1 (I, H), b1 (H,), w2 (H, I), b2 (I,)``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ref

PARAM_KEYS = ("w1", "b1", "w2", "b2")


def params_from_numpy(bundle: Mapping[str, np.ndarray], *, device,
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters (numpy arrays) -> the port's tensors.

    Float arrays become ``dtype`` tensors on ``device``; other arrays (a
    lattice core's integer ``lattice_meta``) keep their type.  Tensors are
    taken as they are, moved and cast alike.  Keys that are not arrays (a
    registry stamp) are dropped.
    """
    out = {}
    for key, value in bundle.items():
        if isinstance(value, str):
            continue
        t = torch.as_tensor(value if isinstance(value, torch.Tensor)
                            else np.array(value), device=device)
        out[key] = t.to(dtype) if t.is_floating_point() else t
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """The port's tensors -> numpy arrays (float tensors as float32)."""
    return {k: (v.detach().to("cpu", torch.float32) if v.is_floating_point()
                else v.detach().cpu()).numpy()
            for k, v in params.items()}


class Oscillator(nn.Module):
    """The I-H-I oscillator: ``forward`` is one plain step in the input's
    dtype, in the kernels' (vpu) order."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 activation: str = "relu"):
        super().__init__()
        for key in PARAM_KEYS:
            self.register_buffer(key, torch.as_tensor(params[key]))
        self.activation = activation

    def params(self) -> Dict[str, torch.Tensor]:
        return {key: getattr(self, key) for key in PARAM_KEYS}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        step = ref.make_step(*self.params().values(), dtype=x.dtype,
                             activation=self.activation)
        return step(x)
