"""Core generation (paper section III-B.3): port of ``repro/core/codegen.py``.

The paper emits an HLS core and a co-simulation testbench per selected
solution.  ``generate_core`` emits, per solution, a Python package:

  <name>/__init__.py   the frozen core: the chosen ``Candidate``'s compute
                       unit, dtype and block shapes as constants, weights
                       from the bundled weights.npz; ``generate`` draws the
                       trajectory through ``kernels.ops.chaotic_trajectory``
                       (K2), ``generate_bits`` resumable words through
                       ``kernels.ops.chaotic_bits`` (K1), on the CUDA card
                       unless the caller passes ``device="cpu"``; imported
                       where a card is, it builds its kernels' shape
                       library first (``kernels.ops.prepare``)
  <name>/testbench.py  the JAX testbench's four checks: the kernel against
                       the plain version (bitwise here, where the JAX
                       testbench allows a tolerance), bounded trajectories
                       over 512 steps, chunked words equal to one long
                       draw, and the monobit balance of the words
  <name>/weights.npz   the extracted network parameters
  <name>/solution.json the selected ``candidate``, ``system`` and
                       ``activation``

``generate_farm`` emits one such core per registered system (the JAX
package's heterogeneous farm), the input of
``serve.farm.OscillatorFarm.from_generated``.

The JAX package's ``solution.json`` also carries ``estimated`` and
``measured_model``: the v5e cycle and VMEM model's numbers for the
solution.  They describe no property of this card, so the port leaves
them out.  A generated package imports only numpy, torch and
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Dict, Optional

import numpy as np

from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.chaotic import SYSTEMS
from repro_torch.core.dse import Candidate, CostModel, LatencyModel, select
from repro_torch.prng.stream import trained_oscillator

_CORE_TEMPLATE = '''"""Auto-generated by repro_torch.core.codegen: do not edit.

HENNC chaotic oscillator core: {system} {i_dim}-{h_dim}-{i_dim} ANN,
{activation}, solution P={p} ({compute_unit}, {dtype_name}),
s_block={s_block}, t_block={t_block}, unroll={unroll}.
"""
import functools
import pathlib

import numpy as np
import torch

from repro_torch.core.ann import params_from_numpy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_HERE = pathlib.Path(__file__).parent
_W = dict(np.load(_HERE / "weights.npz"))

SYSTEM = "{system}"
I_DIM, H_DIM = {i_dim}, {h_dim}
N_NODES = {n_nodes}
S_BLOCK, T_BLOCK, UNROLL = {s_block}, {t_block}, {unroll}
COMPUTE_UNIT, DTYPE = "{compute_unit}", torch.{dtype_name}
ACTIVATION = "{activation}"
SCALE = np.asarray({scale!r}, dtype=np.float32)
OFFSET = np.asarray({offset!r}, dtype=np.float32)

if torch.cuda.is_available():   # this core's kernels, built before a draw
    ops.prepare(ops.kernel_shapes(_W, COMPUTE_UNIT))


@functools.lru_cache(maxsize=None)
def _params(device):
    return params_from_numpy(_W, device=device)


def params(device="cuda"):
    """The float32 weights on ``device`` (the kernels cast to DTYPE)."""
    return _params(resolve_device(device))


def _state(x0, device):
    return torch.as_tensor(np.asarray(x0) if not isinstance(x0, torch.Tensor)
                           else x0).to(resolve_device(device), DTYPE)


def generate(x0, n_steps, *, backend="auto", device="cuda"):
    """Run the frozen oscillator core: the (n_steps, S, I) trajectory
    after x0, (S, I) normalized seeds, in DTYPE."""
    return ops.chaotic_trajectory(
        params(device), _state(x0, device), n_steps, activation=ACTIVATION,
        backend=backend, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        compute_unit=COMPUTE_UNIT)


def generate_bits(x0, n_steps, word_offset=0, *, backend="auto",
                  device="cuda"):
    """Fused, resumable PRNG draw: ((n_steps // 2, S) uint32 words, (S, I)
    final state).  ``word_offset`` and the returned state resume the exact
    word sequence of one long draw, chunk-size invariantly."""
    return ops.chaotic_bits(
        params(device), _state(x0, device), n_steps, word_offset,
        activation=ACTIVATION, backend=backend, s_block=S_BLOCK,
        t_block=T_BLOCK, unroll=UNROLL, compute_unit=COMPUTE_UNIT)
'''

_TESTBENCH_TEMPLATE = '''"""Auto-generated validation testbench (co-simulation analogue).

    python testbench.py [cuda|cpu]
"""
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
import {name} as core  # noqa: E402


def _same_bits(a, b):
    """Bit-identical tensors (as integer views: -0.0 is not 0.0)."""
    ints = {{torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.uint32: torch.int32}}
    return a.shape == b.shape and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


def run(verbose=True, device="cuda"):
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    p = core.params(dev)
    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(
        rng.uniform(0.0, 1.0, (core.S_BLOCK, core.I_DIM)).astype(np.float32)
        - np.float32(0.5)).to(dev, core.DTYPE)

    # 1) kernel vs the plain version: bit for bit, trajectory, words and
    # final state (the port's kernels repeat the plain ops in their order)
    T = 64
    got = core.generate(x0, T, device=dev)
    want = ops.chaotic_trajectory(p, x0, T, activation=core.ACTIVATION,
                                  backend="ref",
                                  compute_unit=core.COMPUTE_UNIT)
    assert _same_bits(got, want), "kernel trajectory != plain"
    got_w, got_x = core.generate_bits(x0, T, word_offset=5, device=dev)
    want_w, want_x = ops.chaotic_bits(p, x0, T, 5,
                                      activation=core.ACTIVATION,
                                      backend="ref",
                                      compute_unit=core.COMPUTE_UNIT)
    assert _same_bits(got_w, want_w) and _same_bits(got_x, want_x), \
        "kernel words or state != plain"

    # 2) bounded trajectories over a long horizon (oscillator is stable)
    long = core.generate(x0, 512, device=dev)
    assert bool(torch.isfinite(long).all()), "trajectory diverged"
    assert float(long.float().abs().max()) < 10.0, \\
        "trajectory left attractor box"

    # 3) fused PRNG words are resumable: two chunked draws (state +
    # word_offset threaded through) equal one long draw, bit for bit
    words, _ = core.generate_bits(x0, 2048, device=dev)
    w_a, mid = core.generate_bits(x0, 1024, device=dev)
    w_b, _ = core.generate_bits(mid, 1024, word_offset=512, device=dev)
    words = words.cpu().numpy()
    np.testing.assert_array_equal(
        np.concatenate([w_a.cpu().numpy(), w_b.cpu().numpy()], axis=0), words)

    # 4) monobit randomness of emitted words
    ones = int(np.unpackbits(words.view(np.uint8)).sum())
    frac = ones / (words.size * 32)
    assert abs(frac - 0.5) < 0.01, f"monobit bias {{frac}}"
    if verbose:
        print(f"TESTBENCH PASS: {{core.SYSTEM}} {{core.ACTIVATION}} "
              f"{{core.COMPUTE_UNIT}}/{{str(core.DTYPE).split('.')[-1]}} on "
              f"{{dev}}: bitwise vs plain (T={{T}}) monobit={{frac:.4f}} "
              f"resumable=yes")
    return True


if __name__ == "__main__":
    run(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
'''


def _atomic_write_text(path: pathlib.Path, text: str) -> None:
    """Write ``text`` to ``path`` through a temporary file and a rename, so
    a concurrent reader sees the old file or the new one, never half."""
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def generate_core(name: str, out_dir, *, params: Dict[str, np.ndarray],
                  candidate: Candidate, system: str = "chen",
                  activation: str = "relu", scale=None,
                  offset=None) -> pathlib.Path:
    """Emit the selected solution as an importable package; returns its
    path.  ``params`` are numpy arrays (``core.ann.extract_parameters``,
    or the JAX package's)."""
    out = pathlib.Path(out_dir) / name
    out.mkdir(parents=True, exist_ok=True)

    tmp = out / f".weights.tmp{os.getpid()}.npz"
    np.savez(tmp, **{k: np.asarray(v, np.float32) for k, v in params.items()})
    os.replace(tmp, out / "weights.npz")

    scale = ([1.0] * candidate.i_dim if scale is None
             else [float(v) for v in np.asarray(scale, np.float64)])
    offset = ([0.0] * candidate.i_dim if offset is None
              else [float(v) for v in np.asarray(offset, np.float64)])

    _atomic_write_text(out / "__init__.py", _CORE_TEMPLATE.format(
        system=system, i_dim=candidate.i_dim, h_dim=candidate.h_dim,
        p=candidate.p, compute_unit=candidate.compute_unit,
        dtype_name=candidate.dtype_name, s_block=candidate.s_block,
        t_block=candidate.t_block, unroll=candidate.unroll,
        n_nodes=candidate.n_nodes, activation=activation, scale=scale,
        offset=offset))
    _atomic_write_text(out / "testbench.py",
                       _TESTBENCH_TEMPLATE.format(name=name))
    _atomic_write_text(out / "solution.json", json.dumps({
        "candidate": dataclasses.asdict(candidate),
        "system": system,
        "activation": activation,
    }, indent=2))
    return out


def generate_farm(out_dir, systems=None, *, mode: str = "pareto",
                  p: Optional[int] = None,
                  overrides: Optional[Dict[str, Dict]] = None,
                  latency_model: Optional[LatencyModel] = None,
                  cost_model: Optional[CostModel] = None
                  ) -> Dict[str, pathlib.Path]:
    """Emit one relu core per chaotic system: the heterogeneous farm.

    For each system: the committed weights and normalizer
    (``prng.stream.trained_oscillator``), the solution ``select`` picks for
    the system's (I, H) (``n_nodes`` threaded through for a lattice), and
    ``generate_core`` under the system's name.  ``systems`` defaults to
    every registered system; a lattice spec (``"chen@ring8"``) is emitted
    as ``chen_ring8``, its weights carrying ``coupling`` and
    ``lattice_meta``.  ``mode``/``p`` are the ``select`` option for every
    system, ``overrides`` a per-system ``{"mode": ..., "p": ...}``.  The
    two models are fitted once and shared by every system's selection.
    Returns {system name: generated package path}.
    """
    systems = tuple(SYSTEMS) if systems is None else tuple(systems)
    lm = latency_model or LatencyModel.fit()
    cm = cost_model or CostModel.fit()
    cores: Dict[str, pathlib.Path] = {}
    for name in systems:
        bundle = trained_oscillator(name)
        params = {k: bundle[k] for k in ("w1", "b1", "w2", "b2", "coupling",
                                         "lattice_meta") if k in bundle}
        i_dim, h_dim = params["w1"].shape
        n_nodes = 1
        if "lattice_meta" in params:
            n_nodes = lattice_meta_tuple(params["lattice_meta"])[0]
        o = (overrides or {}).get(name, {})
        cand = select(i_dim, h_dim, o.get("mode", mode), p=o.get("p", p),
                      latency_model=lm, cost_model=cm, n_nodes=n_nodes)
        cores[name] = generate_core(
            name.replace("@", "_"), out_dir, params=params, candidate=cand,
            system=name, scale=bundle["scale"], offset=bundle["offset"])
    return cores
