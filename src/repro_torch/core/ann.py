"""The HENNC I-H-I oscillator net and its trainer (paper section III-A,
Table II), as PyTorch tensors: port of ``repro/core/ann.py``.

Parameters cross between the two packages as numpy arrays: the JAX
package's bundles (``extract_parameters``, the registry npz files) are
dicts of float32 arrays ``w1 (I, H), b1 (H,), w2 (H, I), b2 (I,)``.  A
lattice core's bundle adds ``coupling`` (the dense (I, I) operator) and
``lattice_meta`` (``[n_nodes, base_dim, topology_code, strength]``).

Training is the JAX recipe (MSE loss, ``train.optimizer.Adam``, batches of
the pre-shuffled dataset in order) on ``apply`` under autograd:
``torch.matmul`` and ``torch.tanh``/``torch.sigmoid``, which the JAX
package also leaves to its compiler outside any kernel.  So ``apply``
agrees with the JAX ``apply`` within float32 tolerance, and a net trained
here is a different net from the JAX package's, held to the same metrics.
The kernels (``kernels.ops``) run the JAX package's exact activation
formulas (``kernels.ref.ACTIVATIONS``) on the extracted parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.chaotic import (ChaoticDataset, _TOPOLOGY_CODES,
                                      denormalize, get_system,
                                      lattice_coupling_matrix, rk4_step)
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.train.optimizer import Adam

PARAM_KEYS = ("w1", "b1", "w2", "b2")
# The activations under autograd (training and ``apply``).
ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid}


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    """I-H-I oscillator net.  The paper sweeps H in {4, 8, 16} (Table III)."""

    dim: int = 3              # I: input == output neurons (system dimension)
    hidden: int = 8           # H: hidden neurons
    activation: str = "relu"  # Table II winner: ReLU
    dtype: torch.dtype = torch.float32

    @property
    def layer_sizes(self) -> Tuple[int, int, int]:
        return (self.dim, self.hidden, self.dim)


def init_params(cfg: AnnConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """He-normal weights from ``generator`` (a CPU generator: the same
    numbers on any device), zero biases, on ``device``: the JAX recipe,
    whose ``jax.random`` key gives other numbers."""
    device = resolve_device(device)
    s1 = float(np.sqrt(np.float32(2.0) / np.float32(cfg.dim)))
    s2 = float(np.sqrt(np.float32(2.0) / np.float32(cfg.hidden)))
    w1 = torch.randn((cfg.dim, cfg.hidden), generator=generator) * s1
    w2 = torch.randn((cfg.hidden, cfg.dim), generator=generator) * s2
    return {"w1": w1.to(device, cfg.dtype),
            "b1": torch.zeros((cfg.hidden,), dtype=cfg.dtype, device=device),
            "w2": w2.to(device, cfg.dtype),
            "b2": torch.zeros((cfg.dim,), dtype=cfg.dtype, device=device)}


def apply(cfg: AnnConfig, params: Mapping[str, torch.Tensor],
          x: torch.Tensor) -> torch.Tensor:
    """One oscillator step: y = W2·phi(W1·x + b1) + b2 (paper Eq. 6)."""
    phi = ACTIVATIONS[cfg.activation]
    h = phi(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def iterate(cfg: AnnConfig, params: Mapping[str, torch.Tensor],
            x0: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Autonomous oscillation: feed the output back as the next input
    (Fig. 1).  Returns the (n_steps, ...) trajectory, excluding x0."""
    out, x = [], x0
    for _ in range(n_steps):
        x = apply(cfg, params, x)
        out.append(x)
    return torch.stack(out)


def regression_metrics(pred, target) -> Dict[str, float]:
    """MSE, MAE, RMSE and R² (paper Table II) of (N, I) predictions."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=pred.device)
    err = pred - target
    mse = torch.mean(torch.square(err))
    mae = torch.mean(torch.abs(err))
    ss_res = torch.sum(torch.square(err))
    ss_tot = torch.sum(torch.square(
        target - torch.mean(target, dim=0, keepdim=True)))
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)
    return {"mse": float(mse), "mae": float(mae),
            "rmse": float(torch.sqrt(mse)), "r2": float(r2)}


def train_epoch(cfg: AnnConfig, opt: Adam, params: Mapping[str, torch.Tensor],
                opt_state, xb: torch.Tensor, yb: torch.Tensor):
    """One epoch over pre-batched pairs ``xb``/``yb`` (n_batches, B, dim):
    an MSE gradient and an Adam update a batch, in order.  Returns
    (params, opt_state, the epoch's mean loss as a 0-d tensor)."""
    losses = torch.zeros(len(xb), dtype=torch.float32, device=xb.device)
    for b in range(len(xb)):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = torch.mean(torch.square(apply(cfg, leaves, xb[b]) - yb[b]))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params, opt_state = opt.update(dict(zip(leaves, grads)), opt_state,
                                       params)
        losses[b] = loss.detach()
    return params, opt_state, losses.mean()


def train(cfg: AnnConfig, dataset: ChaoticDataset, *, epochs: int = 50,
          batch_size: int = 256, lr: float = 1e-4, seed: int = 0,
          target_mse: Optional[float] = None, verbose: bool = False,
          device="cuda"):
    """Train the oscillator net on ``device`` (the card unless the caller
    passes ``"cpu"``).  Returns (params, history).

    The paper's recipe: MSE loss, Adam; the pre-shuffled training pairs in
    ``len // batch_size`` batches, in order, every epoch; ``target_mse``
    stops once an epoch's mean loss reaches it.  ``history`` holds
    ``train_loss`` (one mean per epoch) and ``test_metrics``.
    """
    device = resolve_device(device)
    opt = Adam(lr=lr)
    params = init_params(cfg, torch.Generator().manual_seed(seed), device)
    opt_state = opt.init(params)

    x, y = dataset.x_train, dataset.y_train
    n_batches = len(x) // batch_size
    xb = torch.as_tensor(x[:n_batches * batch_size].reshape(
        n_batches, batch_size, -1), dtype=cfg.dtype, device=device)
    yb = torch.as_tensor(y[:n_batches * batch_size].reshape(
        n_batches, batch_size, -1), dtype=cfg.dtype, device=device)

    history = {"train_loss": []}
    for epoch in range(epochs):
        params, opt_state, loss = train_epoch(cfg, opt, params, opt_state,
                                              xb, yb)
        history["train_loss"].append(float(loss))
        if verbose and (epoch % 10 == 0 or epoch == epochs - 1):
            print(f"  epoch {epoch:4d}  train_mse "
                  f"{history['train_loss'][-1]:.6f}")
        if target_mse is not None and history["train_loss"][-1] <= target_mse:
            break

    with torch.no_grad():
        test_pred = apply(cfg, params, torch.as_tensor(
            dataset.x_test, dtype=cfg.dtype, device=device))
    history["test_metrics"] = regression_metrics(test_pred, dataset.y_test)
    return params, history


def extract_parameters(params: Mapping[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
    """Paper §III-A: 'the network parameters are extracted for the hardware
    phase'.  Plain float32 numpy, the hand-off format for DSE and codegen
    (and the JAX package's)."""
    return {k: (v.detach().to("cpu", torch.float32).numpy()
                if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
            for k, v in params.items()}


def one_step_reference(system_name: str, dataset: ChaoticDataset,
                       x_norm: torch.Tensor) -> torch.Tensor:
    """RK-4 oracle for the same one-step map in normalized space."""
    sys_ = get_system(system_name)
    x_norm = torch.as_tensor(x_norm)
    scale = torch.as_tensor(dataset.scale, device=x_norm.device)
    offset = torch.as_tensor(dataset.offset, device=x_norm.device)
    x = denormalize(x_norm, scale, offset)
    dt = torch.tensor(dataset.dt, dtype=x.dtype, device=x.device)
    return (rk4_step(sys_.f, x, dt) - offset) / scale


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
