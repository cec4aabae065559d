"""Public entry points of the kernels package, and the integer word stages.

Port of ``repro/kernels/ops.py``.  ``chaotic_trajectory`` and
``chaotic_bits`` keep that module's signatures.  The default backend
(``"auto"``) calls the kernel wrappers of ``chaotic_ann``: on a CUDA tensor
they launch the hand-written kernel, on a CPU tensor they take the plain
PyTorch version.  ``backend="ref"`` asks for the plain version explicitly,
on any device.  ``prepare`` builds the kernels of shapes outside the
default library ahead of their first launch (``kernel_shapes`` gives a
core's).

The integer stages (low-mantissa fold, pair packing, Weyl offsets, Murmur3
finalizer) are bitwise twins of the JAX ones.  They compute in int64 masked
to 32 bits, because PyTorch on the CPU has no uint32 shift, add or multiply,
and reach ``torch.uint32`` only at the edge, through a same-width view.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import chaotic_ann, ref

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9          # Weyl increment (2^32 / phi)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) without int64
    overflow: the high half of ``a`` only contributes its low 16 bits."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def to_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> ``torch.uint32`` (same-width view)."""
    signed = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return signed.to(torch.int32).view(torch.uint32)


def from_uint32(words: torch.Tensor) -> torch.Tensor:
    """``torch.uint32`` -> int64 values in [0, 2**32)."""
    return words.view(torch.int32).to(torch.int64) & _M32


def word_offsets(word_offset, shape, device) -> torch.Tensor:
    """A scalar or per-lane word-row offset -> an int64 tensor of
    ``shape`` (a lane count, or a tuple such as (C, S)) mod 2**32."""
    if isinstance(word_offset, torch.Tensor):
        off = (from_uint32(word_offset) if word_offset.dtype == torch.uint32
               else word_offset.to(torch.int64))
        off = off.to(device)
    else:
        off = torch.as_tensor(np.asarray(word_offset, np.int64), device=device)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.broadcast_to(off & _M32, shape)


def _fold_low16(traj: torch.Tensor) -> torch.Tensor:
    """(..., I) floats -> (...,) int64: low mantissa bits, I folded in.

    f32 keeps the low 16 bits of its bit pattern.  bf16 is viewed at its
    own width and masked to its 7 mantissa bits: upcasting it to f32 first
    would leave the low 16 bits all zero.
    """
    if traj.dtype == torch.bfloat16:
        lo = traj.view(torch.int16).to(torch.int64) & 0x7F
    else:
        lo = traj.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFF
    folded = lo[..., 0]
    for i in range(1, traj.shape[-1]):
        folded = folded ^ (lo[..., i] << (5 * i % 16))
    return folded


def _finalize_words(words: torch.Tensor) -> torch.Tensor:
    """Final avalanche (Murmur3 finalizer) on int64 words in [0, 2**32)."""
    words = words ^ (words >> 16)
    words = _mul32(words, 0x85EBCA6B)
    words = words ^ (words >> 13)
    words = _mul32(words, 0xC2B2AE35)
    return words ^ (words >> 16)


def _packed(traj: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Fold, pack pairs high|low, XOR the Weyl row index, finalize.
    ``offsets`` broadcasts against one packed row; returns int64."""
    folded = _fold_low16(traj)
    t = folded.shape[0] // 2
    words = ((folded[0:2 * t:2] << 16) & _M32) | folded[1:2 * t:2]
    rows = torch.arange(t, dtype=torch.int64, device=traj.device)
    idx = (rows.reshape((t,) + (1,) * (words.ndim - 1)) + offsets) & _M32
    return _finalize_words(words ^ _mul32(idx, _GOLDEN))


def bits_from_trajectory(traj: torch.Tensor) -> torch.Tensor:
    """(T, ..., I) floats -> (T // 2, ...) uint32 words, rows counted from 0."""
    zero = torch.zeros((), dtype=torch.int64, device=traj.device)
    return to_uint32(_packed(traj, zero))


def pack_words(traj: torch.Tensor, word_offset=0) -> torch.Tensor:
    """Offset-aware packing stage of the fused kernel.

    traj: (T, S, I) floats, T even.  word_offset: scalar or (S,), the
    absolute word-row index of the first packed row of each lane.
    Returns (T // 2, S) uint32.
    """
    off = word_offsets(word_offset, traj.shape[1], traj.device)
    return to_uint32(_packed(traj, off))


def uniform_from_trajectory(traj: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) f32 from the top 24 bits of each word (a full word
    over 2**32 would round up to 1.0 near 2**32)."""
    zero = torch.zeros((), dtype=torch.int64, device=traj.device)
    bits = _packed(traj, zero)
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def kernel_shapes(params, compute_unit: str = "vpu"):
    """The shape keys (``build.FAMILIES``) the kernels of one core take on
    ``compute_unit``, for ``prepare``: numpy or torch params, a lattice's
    by its ``lattice_meta``.  ``prepare`` checks them against what the
    card takes; the CPU takes any."""
    chaotic_ann._check_unit(compute_unit)
    i_dim, h_dim = (int(v) for v in params["w1"].shape[-2:])
    if "lattice_meta" in params:
        from repro_torch.core.ann import lattice_meta_tuple
        n_nodes, base_dim, topology, _ = lattice_meta_tuple(
            params["lattice_meta"])
        family = "mxu" if compute_unit == "mxu" else "lattice"
        return [(family, (base_dim, h_dim // n_nodes, n_nodes,
                          chaotic_ann._TOPOLOGY_CODES[topology]))]
    if compute_unit == "mxu":
        return [("mxu", (i_dim, h_dim, 1, 0))]
    return [("scalar", (i_dim, h_dim))]


def prepare(shapes, device=None):
    """Build, before any launch, the kernels of the shape keys ``shapes``
    that lie outside the default library (``chaotic_ann.prepare``; every
    build started at once).  Returns {key: build seconds}; raises
    ``ValueError`` for a shape the card does not take.  Does nothing
    where ``device`` (a ``torch.device`` or name, if given) is not a CUDA
    device: the CPU takes the plain versions, at any shape."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    return chaotic_ann.prepare(shapes)


def _lattice_args(params: Dict[str, torch.Tensor], compute_unit: str):
    """``(lattice, coupling)`` of a params dict, as JAX ``ops._lattice_args``
    returns them: the static descriptor of a lattice core (None for a
    scalar one), and its dense ``coupling`` operand on the mxu unit only
    (the vpu kernels rebuild the coupling from the descriptor)."""
    if "lattice_meta" not in params:
        return None, None
    from repro_torch.core.ann import lattice_meta_tuple
    lattice = lattice_meta_tuple(params["lattice_meta"])
    return lattice, params.get("coupling") if compute_unit == "mxu" else None


def _weights(params):
    return params["w1"], params["b1"], params["w2"], params["b2"]


def chaotic_trajectory(params: Dict[str, torch.Tensor], x0: torch.Tensor,
                       n_steps: int, *, activation: str = "relu",
                       backend: str = "auto", s_block: int = 256,
                       t_block: int = 128, unroll: int = 1,
                       compute_unit: str = "vpu",
                       config=None) -> torch.Tensor:
    """Generate (n_steps, S, I) oscillator trajectories.

    backend: 'auto' (the kernel wrapper) | 'ref' (the plain version).
    s_block/t_block/unroll shaped the TPU schedule and change no value;
    they are accepted for the JAX signature.  ``config`` (a
    ``core.dse.Candidate``) overrides ``compute_unit``.
    """
    if config is not None:
        compute_unit = config.compute_unit
    lattice, cpl = _lattice_args(params, compute_unit)
    if backend == "ref":
        return ref.chaotic_ann_ref(*_weights(params), x0, n_steps, activation,
                                   lattice, compute_unit, cpl)
    if backend != "auto":
        raise ValueError(f"backend must be 'auto' or 'ref', got {backend!r}")
    return chaotic_ann.chaotic_ann_traj(*_weights(params), x0,
                                        n_steps=n_steps, activation=activation,
                                        lattice=lattice,
                                        compute_unit=compute_unit,
                                        coupling=cpl)


def chaotic_bits(params: Dict[str, torch.Tensor], x0: torch.Tensor,
                 n_steps: int, word_offset=0, *, activation: str = "relu",
                 backend: str = "auto", s_block: int = 256,
                 t_block: int = 128, unroll: int = 1,
                 compute_unit: str = "vpu",
                 config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused PRNG draw: (n_steps // 2, S) uint32 words + (S, I) final state.

    Same backends and arguments as ``chaotic_trajectory``; ``word_offset``
    is a scalar or (S,) word-row counter.
    """
    if config is not None:
        compute_unit = config.compute_unit
    lattice, cpl = _lattice_args(params, compute_unit)
    if backend == "ref":
        return ref.chaotic_ann_bits_ref(*_weights(params), x0, n_steps,
                                        word_offset, activation, lattice,
                                        compute_unit, cpl)
    if backend != "auto":
        raise ValueError(f"backend must be 'auto' or 'ref', got {backend!r}")
    return chaotic_ann.chaotic_ann_bits(*_weights(params), x0, word_offset,
                                        n_steps=n_steps, activation=activation,
                                        lattice=lattice,
                                        compute_unit=compute_unit,
                                        coupling=cpl)


def _stacked_weights(params):
    """The stacked (leading core axis) weights of a gang's params."""
    w = _weights(params)
    if w[0].ndim != 3:
        raise ValueError(f"gang params need a leading core axis: w1 (C, I, "
                         f"H), got w1 of shape {tuple(w[0].shape)}")
    return w


def chaotic_bits_gang(params: Dict[str, torch.Tensor], x0: torch.Tensor,
                      n_steps: int, word_offset=0, *, core_map,
                      row_map=None, activation: str = "relu",
                      backend: str = "auto", s_block: int = 256,
                      t_block: int = 128, unroll: int = 1,
                      compute_unit: str = "vpu", mesh=None,
                      config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gang-scheduled fused PRNG draw: C stacked networks, ONE launch.

    ``params`` carries a leading core axis (w1 (C, I, H), b1 (C, H),
    w2 (C, H, I), b2 (C, I)); ``x0`` is the concatenated (S, I) stream
    pool with each ``s_block``-lane block homogeneous in core, and
    ``core_map[g]`` names the weight slab of block ``g``.  Per lane the
    result is bit-identical to a per-core ``chaotic_bits`` launch with
    that lane's network.

    ``row_map`` (optional, same shape as ``core_map``) makes the launch
    demand-shaped: block ``g`` computes only
    ``chaotic_ann.gang_effective_rows(row_map, n_steps, t_block,
    unroll)[g]`` word rows and its state advances by exactly that many;
    later word rows are garbage that callers slice away.  ``config`` (a
    ``core.dse.Candidate``) overrides s_block/t_block/unroll/compute_unit.
    A lattice group (``params`` with the un-stacked ``lattice_meta`` of
    its one descriptor) takes the lattice form of K3; an mxu group takes
    K3's mxu form, a lattice group there with the un-stacked ``coupling``
    every member shares.

    ``mesh`` (a ``distributed.sharding.DeviceMesh`` of more than one
    entry) shards the launch across the mesh's devices: the pool, offsets
    and both maps partition on the lane-block axis, the weights replicate
    (``chaotic_ann.chaotic_ann_gang_bits_sharded``).  The maps' block axis
    is padded with dead zero-row blocks until it divides the device count
    (``chaotic_ann.gang_partition_maps``), the pool to match, and the
    result is trimmed back.  A mesh of one takes the unsharded launch, and
    ``backend="ref"`` ignores the mesh: sharding never changes the words.
    """
    if config is not None:
        s_block, t_block = config.s_block, config.t_block
        unroll, compute_unit = config.unroll, config.compute_unit
    lattice, cpl = _lattice_args(params, compute_unit)
    w = _stacked_weights(params)
    if backend == "ref":
        rows = (chaotic_ann.gang_effective_rows(row_map, n_steps, t_block,
                                                unroll)
                if row_map is not None else None)
        return ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps,
                                             word_offset, rows, activation,
                                             lattice, compute_unit, cpl)
    if backend != "auto":
        raise ValueError(f"backend must be 'auto' or 'ref', got {backend!r}")
    if mesh is not None and len(mesh.devices) > 1:
        rmap = None if row_map is None else chaotic_ann._host_ints(row_map)
        cmap_p, rmap_p, pad = chaotic_ann.gang_partition_maps(
            chaotic_ann._host_ints(core_map), rmap, n_dev=len(mesh.devices),
            n_rows=n_steps // 2)
        s_total = x0.shape[0]
        xp, offp = x0, word_offsets(word_offset, s_total, x0.device)
        if pad:
            xp = torch.cat([x0, x0.new_zeros((pad * s_block, x0.shape[1]))])
            offp = torch.cat([offp, offp.new_zeros(pad * s_block)])
        words, state = chaotic_ann.chaotic_ann_gang_bits_sharded(
            *w, xp, cmap_p, offp, rmap_p, cpl, mesh=mesh, n_steps=n_steps,
            s_block=s_block, t_block=t_block, unroll=unroll,
            activation=activation, compute_unit=compute_unit,
            lattice=lattice)
        if pad:
            words, state = words[:, :s_total], state[:s_total]
        return words, state
    return chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, word_offset, row_map, n_steps=n_steps,
        s_block=s_block, t_block=t_block, unroll=unroll,
        activation=activation, compute_unit=compute_unit, lattice=lattice,
        coupling=cpl)


def chaotic_bits_gang_stacked(params: Dict[str, torch.Tensor],
                              x0: torch.Tensor, n_steps: int, word_offset=0,
                              *, row_map=None, activation: str = "relu",
                              backend: str = "auto", s_block: int = 256,
                              t_block: int = 128, unroll: int = 1,
                              compute_unit: str = "vpu", mesh=None,
                              config=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked gang draw for C EQUAL-size pools: ``x0`` (C, S, I), one pool
    per core, ``word_offset`` a scalar or (C, S).  vpu groups only, on
    every backend (the stacked step is the vpu order; an mxu group takes
    ``chaotic_bits_gang``, as in the JAX package); a lattice group takes
    the lattice form of K4.

    ``row_map`` (optional, (C,)) freezes core ``c``'s state after exactly
    ``row_map[c]`` word rows; its words past them are garbage.  Returns
    words (n_steps // 2, C, S) and final state (C, S, I).  s_block,
    t_block and unroll change nothing here; they are accepted for the JAX
    signature.

    ``mesh`` (more than one entry) shards the equal pools on the STREAM
    axis across the mesh's devices, every device running all C cores on
    1/n_dev of each pool's lanes
    (``chaotic_ann.chaotic_ann_gang_stacked_sharded``); the pool size must
    divide the device count (the farm's planner checks this before it
    picks the stacked layout on a mesh).  ``backend="ref"`` ignores the
    mesh.
    """
    if config is not None:
        compute_unit = config.compute_unit
    if compute_unit != "vpu":
        raise ValueError("stacked gang launches support compute_unit='vpu' "
                         "only; use chaotic_bits_gang for mxu")
    lattice, _ = _lattice_args(params, compute_unit)
    w = _stacked_weights(params)
    if backend == "ref":
        return ref.chaotic_ann_gang_stacked_ref(*w, x0, n_steps, word_offset,
                                                row_map, activation, lattice)
    if backend != "auto":
        raise ValueError(f"backend must be 'auto' or 'ref', got {backend!r}")
    if mesh is not None and len(mesh.devices) > 1:
        return chaotic_ann.chaotic_ann_gang_stacked_sharded(
            *w, x0, word_offset, row_map, mesh=mesh, n_steps=n_steps,
            activation=activation, compute_unit=compute_unit,
            lattice=lattice)
    return chaotic_ann.chaotic_ann_gang_stacked(
        *w, x0, word_offset, row_map, n_steps=n_steps, activation=activation,
        compute_unit=compute_unit, lattice=lattice)
