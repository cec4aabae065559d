"""Block-coupled oscillator lattices: names, topology and the coupling
operator (numpy copy of the lattice part of ``repro/core/chaotic.py``).

A lattice couples ``n_nodes`` copies of a base oscillator diffusively on a
ring or a P x Q torus; it is addressed everywhere as
``<base>@<ring|grid><n>`` (e.g. ``chen@ring32``).  The ODE systems, the
RK-4 integrator and ``lattice()`` as an ODE system are not ported
(ROADMAP.md queue 1, 'Paper flow').
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

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
