"""Chaotic ODE systems, the RK-4 reference integrator, the training
dataset (paper Eqs. 1-5, section III-A), and block-coupled oscillator
lattices: names, topology and the coupling operator.  Port of
``repro/core/chaotic.py``.

The five systems are the JAX package's, each ``f`` written with the same
expressions on torch tensors.  ``integrate`` steps RK-4 in a Python loop
(the JAX package scans it under ``jit``) on x0's device; the dataset's
trajectory is integrated on the card unless the caller asks for the CPU,
and normalized on the host with numpy exactly as the JAX package does.  A long float32 trajectory of a chaotic system depends on
the last bit of every op, so the two packages' datasets agree in their
attractor box (``scale``/``offset``), not sample by sample.

A lattice couples ``n_nodes`` copies of a base oscillator diffusively on a
ring or a P x Q torus; it is addressed everywhere as
``<base>@<ring|grid><n>`` (e.g. ``chen@ring32``), and ``get_system`` of
such a name is ``lattice()`` of its base, so ``integrate``,
``make_dataset`` and ``rk4_op_counts`` take it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ChaoticSystem:
    """A system of N autonomous ODEs dX/dt = f(X) (paper Eq. 1).

    ``n_mul_dynamic`` / ``n_add_dynamic`` are the dynamic-term operation
    counts of ``f`` used by the paper's Eq. 4 RK-4 cost model.
    """

    name: str
    dim: int
    f: Callable[[torch.Tensor], torch.Tensor]
    n_mul_dynamic: int
    n_add_dynamic: int
    # A point near the attractor, used as the default trajectory seed.
    x0: Tuple[float, ...] = ()
    # Integration step that keeps RK-4 stable on the attractor.
    dt: float = 0.01

    def __post_init__(self):
        if not self.x0:
            object.__setattr__(self, "x0", tuple([0.1] * self.dim))


def _chen(a: float = 35.0, b: float = 3.0, c: float = 28.0) -> ChaoticSystem:
    """Chen system (paper Eq. 5): 6 muls, 5 adds in f (paper counts)."""

    def f(x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        d1 = a * (x2 - x1)
        d2 = (c - a) * x1 - x1 * x3 + c * x2
        d3 = x1 * x2 - b * x3
        return torch.stack([d1, d2, d3], dim=-1)

    return ChaoticSystem("chen", 3, f, n_mul_dynamic=6, n_add_dynamic=5,
                         x0=(-0.1, 0.5, -0.6), dt=0.002)


def _lorenz(sigma: float = 10.0, rho: float = 28.0,
            beta: float = 8.0 / 3.0) -> ChaoticSystem:
    def f(x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        d1 = sigma * (x2 - x1)
        d2 = x1 * (rho - x3) - x2
        d3 = x1 * x2 - beta * x3
        return torch.stack([d1, d2, d3], dim=-1)

    return ChaoticSystem("lorenz", 3, f, n_mul_dynamic=5, n_add_dynamic=5,
                         x0=(1.0, 1.0, 1.0), dt=0.005)


def _rossler(a: float = 0.2, b: float = 0.2, c: float = 5.7) -> ChaoticSystem:
    def f(x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        d1 = -x2 - x3
        d2 = x1 + a * x2
        d3 = b + x3 * (x1 - c)
        return torch.stack([d1, d2, d3], dim=-1)

    return ChaoticSystem("rossler", 3, f, n_mul_dynamic=2, n_add_dynamic=5,
                         x0=(0.0, 1.0, 0.0), dt=0.02)


def _chua(alpha: float = 15.6, beta: float = 28.0,
          m0: float = -1.143, m1: float = -0.714) -> ChaoticSystem:
    """Chua's circuit with the piecewise-linear diode."""

    def f(x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
        h = m1 * x1 + 0.5 * (m0 - m1) * (torch.abs(x1 + 1.0)
                                         - torch.abs(x1 - 1.0))
        d1 = alpha * (x2 - x1 - h)
        d2 = x1 - x2 + x3
        d3 = -beta * x2
        return torch.stack([d1, d2, d3], dim=-1)

    return ChaoticSystem("chua", 3, f, n_mul_dynamic=4, n_add_dynamic=7,
                         x0=(0.7, 0.0, 0.0), dt=0.01)


def _hyperlorenz(sigma: float = 10.0, rho: float = 28.0,
                 beta: float = 8.0 / 3.0, r: float = -1.0) -> ChaoticSystem:
    """4-D hyperchaotic Lorenz (Wang 2007): Lorenz plus a feedback state."""

    def f(x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3, x4 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        d1 = sigma * (x2 - x1) + x4
        d2 = x1 * (rho - x3) - x2
        d3 = x1 * x2 - beta * x3
        d4 = -x2 * x3 + r * x4
        return torch.stack([d1, d2, d3, d4], dim=-1)

    return ChaoticSystem("hyperlorenz", 4, f, n_mul_dynamic=6,
                         n_add_dynamic=6, x0=(1.0, 1.0, 1.0, 1.0), dt=0.005)


SYSTEMS = {s.name: s for s in (_chen(), _lorenz(), _rossler(), _chua(),
                               _hyperlorenz())}


def get_system(name: str) -> ChaoticSystem:
    """A registered system, or ``lattice()`` of its base for a lattice name
    ``<base>@<ring|grid><n>``."""
    if "@" in name:
        return _lattice_by_name(name)
    try:
        return SYSTEMS[name]
    except KeyError:
        raise KeyError(f"unknown chaotic system {name!r}; "
                       f"have {sorted(SYSTEMS)}") from None


# ---------------------------------------------------------------------------
# RK-4 (paper Eqs. 2-3)
# ---------------------------------------------------------------------------

def rk4_step(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             dt) -> torch.Tensor:
    """One classical RK-4 step.  Shapes broadcast; works batched.  ``dt``
    is a number or a 0-d tensor (``integrate`` passes it in x's dtype, as
    the JAX package's traced step is)."""
    k1 = f(x)
    k2 = f(x + (dt / 2) * k1)
    k3 = f(x + (dt / 2) * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)


def integrate(system_name: str, x0: torch.Tensor, n_steps: int,
              dt: float | None = None) -> torch.Tensor:
    """Integrate ``n_steps`` RK-4 steps.  Returns (n_steps+1, ...) trajectory.

    ``x0`` may be (dim,) or batched (B, dim); the trajectory keeps the batch
    and x0's dtype and device.
    """
    sys_ = get_system(system_name)
    dt = torch.tensor(sys_.dt if dt is None else dt, dtype=x0.dtype,
                      device=x0.device)
    traj = torch.empty((n_steps + 1,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    traj[0] = x = x0
    for t in range(n_steps):
        x = rk4_step(sys_.f, x, dt)
        traj[t + 1] = x
    return traj


# ---------------------------------------------------------------------------
# Op-count models (paper Eq. 4 and Eq. 7 / Table I)
# ---------------------------------------------------------------------------

def rk4_op_counts(system: ChaoticSystem) -> Tuple[int, int]:
    """Paper Eq. 4: static + dynamic multiplication/addition counts of RK-4."""
    n = system.dim
    n_mul = (3 * n * n + 3 * n) + 4 * system.n_mul_dynamic
    n_add = (3 * n * n + 4 * n) + 4 * system.n_add_dynamic
    return n_mul, n_add


def ann_op_counts(layer_sizes: Tuple[int, ...]) -> Tuple[int, int]:
    """Paper Eq. 7 for a feed-forward net given (n_1, ..., n_L) neuron counts.

    For 3-8-3: 48 muls, 59 adds (Table I).
    """
    n_mul = sum(layer_sizes[i] * layer_sizes[i - 1]
                for i in range(1, len(layer_sizes)))
    n_add = sum(layer_sizes[i] * (layer_sizes[i - 1] + 1)
                for i in range(1, len(layer_sizes)))
    return n_mul, n_add


# ---------------------------------------------------------------------------
# Dataset generation (paper section III-A)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChaoticDataset:
    """Labelled one-step pairs: model learns X_t -> X_{t+1} (paper §III-A).
    numpy float32 arrays, as in the JAX package."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    # Per-dimension affine normalizer mapping the attractor's range into
    # [-1, 1]; the generated core runs in normalized space.
    scale: np.ndarray
    offset: np.ndarray
    system: str
    dt: float


def normalize(x, scale, offset):
    return (x - offset) / scale


def denormalize(x, scale, offset):
    return x * scale + offset


def make_dataset(system_name: str, n_samples: int = 100_000,
                 train_frac: float = 0.8, burn_in: int = 2_000,
                 dt: float | None = None, seed: int = 0,
                 device="cuda") -> ChaoticDataset:
    """Generate the paper's dataset: sample a long RK-4 trajectory; each
    labelled point is (X_t, X_{t+1}) for consecutive time steps.  The
    trajectory is integrated in float32 on ``device`` (the card unless the
    caller passes ``"cpu"``); the pairs are numpy arrays on the host."""
    sys_ = get_system(system_name)
    dt = sys_.dt if dt is None else dt
    x0 = torch.tensor(sys_.x0, dtype=torch.float32,
                      device=resolve_device(device))
    # Burn in so samples lie on the attractor, then collect n_samples + 1.
    traj = integrate(system_name, x0, burn_in + n_samples, dt)
    traj = traj[burn_in:].cpu().numpy().astype(np.float32)  # (n_samples+1, dim)

    lo, hi = traj.min(axis=0), traj.max(axis=0)
    scale = ((hi - lo) / 2.0).astype(np.float32)
    scale = np.where(scale == 0, 1.0, scale)
    offset = ((hi + lo) / 2.0).astype(np.float32)
    norm = (traj - offset) / scale

    x_all, y_all = norm[:-1], norm[1:]
    # Shuffle pairs before splitting (trajectory order leaks time otherwise).
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x_all))
    x_all, y_all = x_all[perm], y_all[perm]
    n_train = int(train_frac * len(x_all))
    return ChaoticDataset(
        x_train=x_all[:n_train], y_train=y_all[:n_train],
        x_test=x_all[n_train:], y_test=y_all[n_train:],
        scale=scale, offset=offset, system=system_name, dt=dt,
    )


# ---------------------------------------------------------------------------
# Block-coupled oscillator lattices
# ---------------------------------------------------------------------------

# Diffusive coupling strength of name-addressed lattices ("chen@ring8"):
# weak against the base dynamics, so the lattice stays chaotic.
DEFAULT_LATTICE_COUPLING = 0.05

_TOPOLOGY_CODES = {"ring": 0, "grid": 1}


def _grid_shape(n_nodes: int) -> Tuple[int, int]:
    """Most-square P x Q factorization of ``n_nodes`` for grid topology."""
    p = max(1, int(np.sqrt(n_nodes)))
    while n_nodes % p:
        p -= 1
    return p, n_nodes // p


def lattice_coupling_matrix(n_nodes: int, base_dim: int, strength: float,
                            topology: str = "ring") -> np.ndarray:
    """The dense (I, I) form of the block-sparse diffusive coupling:
    ``strength * (A - deg*I) (x) I_d`` for the ring/torus adjacency ``A``,
    as float32.  The vpu kernels never build it; the mxu coupling dot
    takes it as an operand.
    """
    if topology not in _TOPOLOGY_CODES:
        raise ValueError(f"unknown lattice topology {topology!r}; "
                         f"have {sorted(_TOPOLOGY_CODES)}")
    if n_nodes < 2:
        raise ValueError(f"a lattice needs n_nodes >= 2, got {n_nodes}")
    adj = np.zeros((n_nodes, n_nodes), np.float64)
    if topology == "ring":
        for n in range(n_nodes):
            adj[n, (n - 1) % n_nodes] += 1.0
            adj[n, (n + 1) % n_nodes] += 1.0
    else:
        pp, qq = _grid_shape(n_nodes)
        for n in range(n_nodes):
            p_i, q_i = divmod(n, qq)
            adj[n, ((p_i - 1) % pp) * qq + q_i] += 1.0
            adj[n, ((p_i + 1) % pp) * qq + q_i] += 1.0
            adj[n, p_i * qq + (q_i - 1) % qq] += 1.0
            adj[n, p_i * qq + (q_i + 1) % qq] += 1.0
    deg = adj.sum(axis=1)
    lap = adj - np.diag(deg)
    cpl = float(strength) * np.kron(lap, np.eye(base_dim))
    return cpl.astype(np.float32)


def parse_lattice_name(name: str) -> Tuple[str, str, int]:
    """Split ``<base>@<ring|grid><n>`` into ``(base, topology, n_nodes)``."""
    base_name, spec = name.split("@", 1)
    topo = spec.rstrip("0123456789")
    tail = spec[len(topo):]
    if topo not in _TOPOLOGY_CODES or not tail:
        raise KeyError(
            f"bad lattice system {name!r}; want <base>@<ring|grid><n>, "
            f"e.g. 'chen@ring8'")
    return base_name, topo, int(tail)


def lattice(base_system: Union[str, ChaoticSystem], n_nodes: int,
            coupling: float = DEFAULT_LATTICE_COUPLING,
            topology: str = "ring") -> ChaoticSystem:
    """``n_nodes`` copies of a base system coupled into one chaotic system
    of dim ``n_nodes * base.dim``, nearest neighbours on a ring or torus:

        dX_n/dt = f_base(X_n) + coupling * sum_{m ~ n} (X_m - X_n)

    ``f`` adds ``x @ C^T`` for the dense coupling operator ``C``
    (``lattice_coupling_matrix``, cast to x's dtype and device).  Each
    node's seed is the base seed perturbed by its index (identical seeds
    would start the lattice synchronized); the Eq. 4 counts are the
    block-sparse ones: per-node dynamics plus one scale and ``deg``
    neighbour adds per component.
    """
    base = get_system(base_system) if isinstance(base_system, str) \
        else base_system
    cpl_t = torch.from_numpy(
        lattice_coupling_matrix(n_nodes, base.dim, coupling, topology).T
        .copy())
    dim = n_nodes * base.dim

    def f(x: torch.Tensor) -> torch.Tensor:
        nodes = x.reshape(x.shape[:-1] + (n_nodes, base.dim))
        dyn = base.f(nodes).reshape(x.shape)
        return dyn + x @ cpl_t.to(device=x.device, dtype=x.dtype)

    x0 = tuple(v * (1.0 + 0.03 * n) + 0.01 * n
               for n in range(n_nodes) for v in base.x0)
    deg = 2 if topology == "ring" else 4
    return ChaoticSystem(
        name=f"{base.name}@{topology}{n_nodes}", dim=dim, f=f,
        n_mul_dynamic=n_nodes * base.n_mul_dynamic + dim,
        n_add_dynamic=n_nodes * base.n_add_dynamic + dim * deg,
        x0=x0, dt=base.dt)


@functools.lru_cache(maxsize=None)
def _lattice_by_name(name: str) -> ChaoticSystem:
    base_name, topo, n_nodes = parse_lattice_name(name)
    return lattice(get_system(base_name), n_nodes, topology=topo)
