"""The HENNC I-H-I oscillator net as PyTorch tensors (port of the parts of
``repro/core/ann.py`` that serving needs; training is not ported).

Parameters cross between the two packages as numpy arrays: the JAX
package's bundles (``extract_parameters``, the registry npz files) are
dicts of float32 arrays ``w1 (I, H), b1 (H,), w2 (H, I), b2 (I,)``.  A
lattice core's bundle adds ``coupling`` (the dense (I, I) operator) and
``lattice_meta`` (``[n_nodes, base_dim, topology_code, strength]``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.chaotic import _TOPOLOGY_CODES, lattice_coupling_matrix
from repro_torch.kernels import ref

PARAM_KEYS = ("w1", "b1", "w2", "b2")


def expand_lattice_params(base_params: Mapping[str, np.ndarray], *,
                          n_nodes: int, coupling: float,
                          topology: str = "ring") -> Dict[str, np.ndarray]:
    """A block-coupled lattice core's parameters, derived from ONE base
    oscillator: block-diagonal ``w1``/``w2`` (node n's blocks at rows and
    columns ``n*d`` / ``n*h``), tiled biases, plus ``coupling`` and
    ``lattice_meta``.  Bitwise the arrays of the JAX function.

    ``n_nodes * d`` must be a multiple of 8 (the JAX kernels' sublanes;
    kept so both packages accept the same lattices).
    """
    w1 = np.asarray(base_params["w1"], np.float32)
    b1 = np.asarray(base_params["b1"], np.float32)
    w2 = np.asarray(base_params["w2"], np.float32)
    b2 = np.asarray(base_params["b2"], np.float32)
    d, h = w1.shape
    if n_nodes < 2:
        raise ValueError(f"a lattice needs n_nodes >= 2, got {n_nodes}")
    if (n_nodes * d) % 8 != 0:
        raise ValueError(
            f"lattice state dim {n_nodes}*{d}={n_nodes * d} must be a "
            f"multiple of 8 sublanes (d={d}: n_nodes in "
            f"{[n for n in range(2, 65) if n * d % 8 == 0][:4]}...)")
    big_i, big_h = n_nodes * d, n_nodes * h
    w1_l = np.zeros((big_i, big_h), np.float32)
    w2_l = np.zeros((big_h, big_i), np.float32)
    for n in range(n_nodes):
        w1_l[n * d:(n + 1) * d, n * h:(n + 1) * h] = w1
        w2_l[n * h:(n + 1) * h, n * d:(n + 1) * d] = w2
    return {
        "w1": w1_l, "b1": np.tile(b1, n_nodes),
        "w2": w2_l, "b2": np.tile(b2, n_nodes),
        "coupling": lattice_coupling_matrix(n_nodes, d, coupling, topology),
        "lattice_meta": np.asarray(
            [n_nodes, d, _TOPOLOGY_CODES[topology], coupling], np.float32),
    }


def lattice_meta_tuple(meta) -> Tuple[int, int, str, float]:
    """A ``lattice_meta`` array -> the static descriptor ``(n_nodes,
    base_dim, topology, strength)``; ``strength`` is the float32 value the
    array holds."""
    m = np.asarray(meta, np.float32).reshape(-1)
    if m.size != 4:
        raise ValueError(f"lattice_meta must be the 4-entry descriptor "
                         f"[n_nodes, base_dim, topology_code, strength], got "
                         f"{m.size} entries")
    names = {v: k for k, v in _TOPOLOGY_CODES.items()}
    return (int(m[0]), int(m[1]), names[int(m[2])], float(m[3]))


def check_block_diagonal(w1: torch.Tensor, w2: torch.Tensor,
                         n_nodes: int) -> None:
    """Raise unless ``w1`` (..., I, H) and ``w2`` (..., H, I) are zero off
    their ``n_nodes`` diagonal node blocks, the only entries the lattice
    kernels read.  A leading axis (a gang's stacked cores) is checked
    core by core in one pass."""
    i_dim, h_dim = w1.shape[-2:]
    d, h = i_dim // n_nodes, h_dim // n_nodes
    if (d * n_nodes, h * n_nodes) != (i_dim, h_dim):
        raise ValueError(f"lattice weights {tuple(w1.shape)} do not split "
                         f"into {n_nodes} node blocks")
    eye = torch.eye(n_nodes, dtype=torch.bool, device=w1.device)
    off = ~eye[:, None, :, None]
    if bool(((w1.reshape(-1, n_nodes, d, n_nodes, h) != 0) & off).any()
            or ((w2.reshape(-1, n_nodes, h, n_nodes, d) != 0) & off).any()):
        raise ValueError(
            "lattice weights must be block-diagonal (expand_lattice_params): "
            "the lattice kernels read only the diagonal node blocks")


def check_coupling_support(coupling: torch.Tensor, lattice) -> None:
    """Raise unless the dense (I, I) ``coupling`` is zero off the support
    of its lattice's operator (row ``n*d + k`` at columns ``m*d + k`` for
    ``m`` = n and n's ring or torus neighbours), the only entries the mxu
    lattice kernels read."""
    n_nodes, base_dim, topology, _ = lattice
    support = torch.as_tensor(
        lattice_coupling_matrix(n_nodes, base_dim, 1.0, topology) != 0,
        device=coupling.device)
    if tuple(coupling.shape) != tuple(support.shape):
        raise ValueError(f"coupling {tuple(coupling.shape)} does not fit "
                         f"the lattice's {tuple(support.shape)}")
    if bool(((coupling != 0) & ~support).any()):
        raise ValueError(
            "the coupling operand must be zero off its ring/torus support "
            "(lattice_coupling_matrix): the mxu lattice kernels read only "
            "that support")


def params_from_numpy(bundle: Mapping[str, np.ndarray], *, device,
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters (numpy arrays) -> the port's tensors.

    Float arrays (``coupling`` too) become ``dtype`` tensors on
    ``device``; other arrays keep their type.  Tensors are taken as they
    are, moved and cast alike.  A lattice core's ``lattice_meta`` stays a
    float32 numpy array, as in the JAX bundle (``lattice_meta_tuple``
    decodes it), its weights must be block-diagonal and its ``coupling``
    zero off the operator's support.  Keys that are not arrays (a registry
    stamp) are dropped.
    """
    out = {}
    for key, value in bundle.items():
        if key == "lattice_meta":
            out[key] = np.asarray(value, np.float32)
            continue
        if isinstance(value, str):
            continue
        t = torch.as_tensor(value if isinstance(value, torch.Tensor)
                            else np.array(value), device=device)
        out[key] = t.to(dtype) if t.is_floating_point() else t
    if "lattice_meta" in out:
        lattice = lattice_meta_tuple(out["lattice_meta"])
        check_block_diagonal(out["w1"], out["w2"], lattice[0])
        if "coupling" in out:
            check_coupling_support(out["coupling"], lattice)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """The port's tensors -> numpy arrays (float tensors as float32)."""
    return {k: (v.copy() if isinstance(v, np.ndarray) else
                (v.detach().to("cpu", torch.float32) if v.is_floating_point()
                 else v.detach().cpu()).numpy())
            for k, v in params.items()}


class Oscillator(nn.Module):
    """The I-H-I oscillator: ``forward`` is one plain step in the input's
    dtype, in the kernels' (vpu) order, with the lattice coupling when
    ``params`` carry ``lattice_meta``."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 activation: str = "relu"):
        super().__init__()
        for key in PARAM_KEYS:
            self.register_buffer(key, torch.as_tensor(params[key]))
        self.activation = activation
        meta = params.get("lattice_meta")
        self.lattice = None if meta is None else lattice_meta_tuple(meta)

    def params(self) -> Dict[str, torch.Tensor]:
        return {key: getattr(self, key) for key in PARAM_KEYS}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        step = ref.make_step(*self.params().values(), dtype=x.dtype,
                             activation=self.activation,
                             lattice=self.lattice)
        return step(x)
