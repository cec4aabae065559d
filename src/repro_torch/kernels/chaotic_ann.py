"""Wrappers of the hand-written CUDA oscillator kernels (``csrc/chaotic_ann.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches on the current stream without
synchronising.  A tensor on the CPU takes the kernel's plain version in
``ref`` instead, and only because it lies on the CPU; a CUDA tensor
launches the kernel or raises.  ``<wrapper>.launches`` counts launches.
The lattice forms of K1 and K2 (``lattice=`` on ``chaotic_ann_bits`` /
``chaotic_ann_traj``) are kernels of their own, with their own wrappers
and counters (``chaotic_ann_lattice_bits`` / ``chaotic_ann_lattice_traj``),
and so is the mxu unit of K1 and K2, scalar and lattice cores alike
(``compute_unit="mxu"``: ``chaotic_ann_mxu_bits`` / ``chaotic_ann_mxu_traj``),
the lattice forms of the gang kernels K3 and K4 (``lattice=`` on
``chaotic_ann_gang_bits`` / ``chaotic_ann_gang_stacked``:
``chaotic_ann_lattice_gang_bits`` / ``chaotic_ann_lattice_gang_stacked``),
and K3 on the mxu unit (``compute_unit="mxu"`` on ``chaotic_ann_gang_bits``:
``chaotic_ann_mxu_gang_bits``; K4 has no mxu form).  Every form takes
relu, tanh and sigmoid: the vpu K1-K4, scalar and lattice, and the mxu
K1-K3, whose second dot reads phi's f32 result unrounded in bf16, as the
JAX kernel's dot does (``activation`` evaluates the kernels' tanh and
sigmoid alone, a check hook).

Shapes: every form takes what the reference's kernels take, any (I, H)
and any lattice whose state ``n_nodes * base_dim`` is a whole number of
8-row sublanes, with ``n_nodes`` at most 1,024 (a lane slot of
``slot_width`` threads: inside a warp up to 32 nodes, several warps of one
CTA past that).  A shape of ``build.DEFAULT_SHAPES`` launches from the
default library; any other launches the same hand-written kernel from a
shape library of its own, built from the repo's source the first time it
is asked for (``prepare``; a failed build raises).  A lattice the
reference refuses, or one of more than 1,024 nodes, raises ``ValueError``
on the card (``check_card_lattice``).

Across devices: ``chaotic_ann_gang_bits_sharded`` and
``chaotic_ann_gang_stacked_sharded`` split one gang launch over a
``distributed.sharding.DeviceMesh``, one K3 or K4 launch per mesh entry
(counted by K3's or K4's wrapper; ``mesh.shard_launches`` by entry).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.core.chaotic import _TOPOLOGY_CODES   # LATTICE_SHAPES' codes
from repro_torch.kernels import build, ops, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CTA_LANES = 128              # kThreads of chaotic_ann.cu: lanes per CTA
_c_ptr, _c_int, _c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# chaotic_ann.cu's activation codes (kRelu, kTanh, kSigmoid)
_ACTIVATION_CODES = {"relu": 0, "tanh": 1, "sigmoid": 2}


# Each family's C entries (build.FAMILIES) and their argument types.
_GANG = [_c_i64] * 3 + [_c_ptr]
_ENTRIES = {
    # (device, dtype, activation, i_dim, h_dim, ...)
    "scalar": (
        ("chaotic_ann_bits_launch",
         [_c_int] * 5 + [_c_ptr] * 8 + [_c_i64, _c_i64, _c_ptr]),
        ("chaotic_ann_traj_launch",
         [_c_int] * 5 + [_c_ptr] * 6 + [_c_i64, _c_i64, _c_ptr]),
        ("chaotic_ann_gang_bits_launch", [_c_int] * 5 + [_c_ptr] * 10 + _GANG),
        ("chaotic_ann_gang_stacked_launch",
         [_c_int] * 5 + [_c_ptr] * 9 + _GANG)),
    # (device, dtype, activation, base_i, base_h, n_nodes, topology, eps, ...)
    "lattice": (
        ("chaotic_ann_lattice_bits_launch",
         [_c_int] * 7 + [ctypes.c_float] + [_c_ptr] * 8
         + [_c_i64, _c_i64, _c_ptr]),
        ("chaotic_ann_lattice_traj_launch",
         [_c_int] * 7 + [ctypes.c_float] + [_c_ptr] * 6
         + [_c_i64, _c_i64, _c_ptr]),
        ("chaotic_ann_lattice_gang_bits_launch",
         [_c_int] * 7 + [ctypes.c_float] + [_c_ptr] * 10 + _GANG),
        ("chaotic_ann_lattice_gang_stacked_launch",
         [_c_int] * 7 + [ctypes.c_float] + [_c_ptr] * 9 + _GANG)),
    # (device, dtype, activation, node_i, node_h, n_nodes, topology, ...)
    "mxu": (
        ("chaotic_ann_mxu_bits_launch",
         [_c_int] * 7 + [_c_ptr] * 9 + [_c_i64, _c_i64, _c_ptr]),
        ("chaotic_ann_mxu_traj_launch",
         [_c_int] * 7 + [_c_ptr] * 7 + [_c_i64, _c_i64, _c_ptr]),
        ("chaotic_ann_mxu_gang_bits_launch",
         [_c_int] * 7 + [_c_ptr] * 11 + _GANG)),
}
# the check hooks, in the default library alone: the activation (device,
# dtype, activation, x, y, n, stream) and the bf16x2 checks (device,
# mismatches, n_examples, examples, stream), launched by chip_smoke.py
_HOOKS = (("chaotic_ann_activation_launch",
           [_c_int] * 3 + [_c_ptr] * 2 + [_c_i64, _c_ptr]),
          ("chaotic_ann_bf16x2_check_launch", [_c_int] + [_c_ptr] * 4))


def _declare(lib: ctypes.CDLL, families, hooks: bool) -> ctypes.CDLL:
    """``lib`` with the C functions of ``families`` (and the hooks) typed."""
    entries = [e for f in families for e in _ENTRIES[f]]
    for name, argtypes in entries + (list(_HOOKS) if hooks else []):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _c_int
    lib.chaotic_ann_error_string.argtypes = [_c_int]
    lib.chaotic_ann_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The default library (``build.DEFAULT_SHAPES``, the check hooks),
    every C function's types declared."""
    return _declare(build.load(), _ENTRIES, hooks=True)


# shape libraries loaded in this process, by key; prepare() fills it
_SHAPE_LIBS: Dict[build.Key, ctypes.CDLL] = {}
_PREPARE_LOCK = threading.Lock()


# the most nodes a lattice takes on the card: a lane slot is one CTA
MAX_CARD_NODES = 1_024


def slot_width(n_nodes: int) -> int:
    """Threads of a lattice lane slot in the kernels: the next power of
    two >= n_nodes (``chaotic_ann.cu``'s ``slot_width``); 1 for a scalar
    core.  Up to 32 a slot lies inside a warp; wider, it spans W / 32
    warps of one CTA."""
    return 1 << max(0, int(n_nodes) - 1).bit_length()


def gang_lane_granularity(n_nodes: int) -> int:
    """The lanes of a one-lane lattice or mxu K3 CTA, ``cta_slots`` in
    ``chaotic_ann.cu``: kThreads / slot_width(n_nodes), and 1 where a slot
    fills its CTA (W >= 128).  Their K3 takes an ``s_block`` that is a
    multiple of it (every served config's is: 128 * 2^p)."""
    return max(1, _CTA_LANES // slot_width(n_nodes))


def check_card_lattice(lattice, i_dim: int) -> None:
    """Raise ``ValueError`` for a lattice the card does not run: what the
    reference's Pallas kernels refuse (``n_nodes * base_dim`` not a whole
    number of 8-row sublanes: their wrapped-roll coupling cannot cross
    padding rows), and one of more than ``MAX_CARD_NODES`` nodes (a lane's
    nodes are one CTA's threads; more needs a slot across a thread-block
    cluster)."""
    ref.check_lattice(lattice, i_dim)
    n_nodes = lattice[0]
    if i_dim % 8:
        raise ValueError(f"lattice state dim {i_dim} must be a whole number "
                         f"of sublanes (got padding to {-(-i_dim // 8) * 8}); "
                         f"the wrapped-roll coupling cannot cross padding "
                         f"rows")
    if not 2 <= n_nodes <= MAX_CARD_NODES:
        raise ValueError(f"a lattice of {n_nodes} nodes: the CUDA kernels "
                         f"take 2 to {MAX_CARD_NODES:,} (a lane's nodes in "
                         f"one CTA)")


def shape_key(family: str, dims) -> build.Key:
    """A validated shape key: ints, the topology a code (0 ring, 1 grid)."""
    if family not in build.FAMILIES:
        raise ValueError(f"shape family must be one of "
                         f"{sorted(build.FAMILIES)}, got {family!r}")
    dims = tuple(_TOPOLOGY_CODES[d] if isinstance(d, str) else int(d)
                 for d in dims)
    if len(dims) != (2 if family == "scalar" else 4) or min(dims[:2]) < 1:
        raise ValueError(f"bad {family} shape {dims}")
    if family != "scalar":
        d, _, n_nodes, topology = dims
        if topology not in _TOPOLOGY_CODES.values():
            raise ValueError(f"unknown topology code {topology}")
        if n_nodes != 1 or family == "lattice":
            names = {v: k for k, v in _TOPOLOGY_CODES.items()}
            check_card_lattice((n_nodes, d, names[topology], 0.0),
                               n_nodes * d)
    return family, dims


def prepare(shapes: Iterable) -> Dict[build.Key, float]:
    """Build (or reuse) and load the library of every shape outside
    ``build.DEFAULT_SHAPES``: ``shapes`` are keys ``(family, dims)``
    (``ops.kernel_shapes``), the missing libraries built in parallel.  Returns
    {key: build seconds in this call (0.0 when built before)} for those
    keys; the default shapes need nothing.  A failed build raises with
    nvcc's log.  Services and farms call it when a core is added, so no
    flush waits on ``nvcc``."""
    keys = list(dict.fromkeys(shape_key(f, d) for f, d in shapes))
    keys = [k for k in keys if k[1] not in build.DEFAULT_SHAPES[k[0]]]
    with _PREPARE_LOCK:
        todo = [k for k in keys if k not in _SHAPE_LIBS]
        built = build.build_libraries(todo) if todo else {}
        for key in todo:
            _SHAPE_LIBS[key] = _load_shape_library(key)
    return {k: built[k][0] if k in built else 0.0 for k in keys}


def _load_shape_library(key: build.Key) -> ctypes.CDLL:
    """The built shape library of ``key``, its family's functions typed."""
    return _declare(build.load(key=key), (key[0],), hooks=False)


def _library(family: str, dims) -> ctypes.CDLL:
    """The library that holds ``family``'s kernels at ``dims`` (ints, the
    topology a code; the operands' helpers have validated them): the
    default library, or the shape library (built now if need be)."""
    key = (family, tuple(int(d) for d in dims))
    if key[1] in build.DEFAULT_SHAPES[family]:
        return _lib()
    lib = _SHAPE_LIBS.get(key)
    if lib is None:
        prepare([key])
        lib = _SHAPE_LIBS[key]
    return lib


def _check_activation(activation: str) -> int:
    """The activation's code in every kernel (``chaotic_ann.cu``'s ACT)."""
    if activation not in _ACTIVATION_CODES:
        raise ValueError(f"activation must be one of "
                         f"{sorted(_ACTIVATION_CODES)}, got {activation!r}")
    return _ACTIVATION_CODES[activation]


def _int32_on_card(a: np.ndarray, device) -> torch.Tensor:
    """A small host int array as int32 on the card, without blocking the
    host: staged in pinned memory and copied on the current stream (a
    copy from pageable memory would wait for the stream's queued work)."""
    host = torch.from_numpy(np.ascontiguousarray(a, np.int32)).pin_memory()
    return host.to(device, non_blocking=True)


def _offsets_i64(word_offset, shape, device) -> torch.Tensor:
    """The scalar K1/K3/K4's word-row offsets: a contiguous int64 tensor of
    ``shape`` on ``device``, whose low 32 bits the kernels read (the offset
    mod 2**32, as ``ops.word_offsets`` gives it).  An int64 tensor of that
    shape on the device, as the farm and the services pass, goes as it is,
    so that no device op runs before the kernel."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if (isinstance(word_offset, torch.Tensor)
            and word_offset.dtype == torch.int64
            and word_offset.device == device
            and tuple(word_offset.shape) == shape):
        return word_offset.contiguous()
    return ops.word_offsets(word_offset, shape, device).contiguous()


def _check_steps(n_steps: int) -> None:
    if n_steps < 2 or n_steps % 2:
        raise ValueError(f"n_steps must be even and >= 2, got {n_steps}")


def _operands(w1, b1, w2, b2, x0, lead: Tuple[int, ...] = (),
              x_dims: Tuple[str, ...] = ("S", "I")) -> Tuple[list, int]:
    """Validated kernel operands: weights cast to the state dtype.

    ``lead`` is the weights' leading shape: () for one net, (C,) for the
    C stacked nets of a gang launch.  ``x_dims`` names the state's dims:
    (S, I), or (C, S, I) for the stacked gang.
    """
    if x0.device.type != "cuda":
        raise ValueError(f"x0 must be a CUDA tensor, got {x0.device}")
    if x0.dtype not in _DTYPE_CODES:
        raise ValueError(f"state dtype must be float32 or bfloat16, "
                         f"got {x0.dtype}")
    if x0.ndim != len(x_dims) or not x0.is_contiguous():
        raise ValueError(f"x0 must be a contiguous ({', '.join(x_dims)}) "
                         f"tensor, got shape {tuple(x0.shape)} strides "
                         f"{x0.stride()}")
    i_dim, h_dim = w1.shape[-2:]
    shapes = {"w1": (w1, lead + (i_dim, h_dim)), "b1": (b1, lead + (h_dim,)),
              "w2": (w2, lead + (h_dim, i_dim)), "b2": (b2, lead + (i_dim,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want or t.device != x0.device:
            raise ValueError(f"{name} must be {want} on {x0.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if x0.shape[-1] != i_dim:
        raise ValueError(f"x0 has {x0.shape[-1]} features, w1 expects {i_dim}")
    weights = [t.to(x0.dtype).contiguous() for t in (w1, b1, w2, b2)]
    return weights, _DTYPE_CODES[x0.dtype]


def _raise_on(lib, code: int, kernel: str) -> None:
    if code:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.chaotic_ann_error_string(code).decode()}")


def _check_unit(compute_unit: str) -> None:
    if compute_unit not in ("vpu", "mxu"):
        raise ValueError(f"compute_unit must be 'vpu' or 'mxu', got "
                         f"{compute_unit!r}")


def chaotic_ann_bits(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, x0: torch.Tensor, word_offset=0, *,
                     n_steps: int, activation: str = "relu", lattice=None,
                     compute_unit: str = "vpu", coupling=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused oscillator + bit extraction: (n_steps // 2, S) uint32 words
    and the (S, I) final state.  ``lattice`` (the static descriptor
    ``(n_nodes, base_dim, topology, strength)``) takes the lattice form,
    ``chaotic_ann_lattice_bits``; ``compute_unit="mxu"`` the mxu unit,
    ``chaotic_ann_mxu_bits`` (a lattice with its dense ``coupling``).

    ``activation`` relu, tanh or sigmoid (the kernel's template
    parameter, the lattice and mxu forms' too).

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_bits_pallas`` (K1).
    Bound on the H100: operations.  Each word costs 2 steps of 4*I*H
    separate ops (each sum's products, its adds after the first term and
    its bias add), one instruction each, 192 for a 3-8-3 net with relu
    (tanh and sigmoid add their formulas' ops per hidden unit), against 4
    bytes written.  The design keeps the state and the hidden layer in
    registers for the whole launch, so the trajectory never reaches
    device memory and only the words, offsets and final state move.
    """
    _check_unit(compute_unit)
    if compute_unit == "mxu":
        return chaotic_ann_mxu_bits(w1, b1, w2, b2, x0, word_offset,
                                    n_steps=n_steps, lattice=lattice,
                                    coupling=coupling, activation=activation)
    if lattice is not None:
        return chaotic_ann_lattice_bits(w1, b1, w2, b2, x0, word_offset,
                                        n_steps=n_steps, lattice=lattice,
                                        activation=activation)
    act = _check_activation(activation)
    _check_steps(n_steps)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_bits_ref(w1, b1, w2, b2, x0, n_steps,
                                        word_offset, activation)
    weights, code = _operands(w1, b1, w2, b2, x0)
    n_lanes, n_rows = x0.shape[0], n_steps // 2
    offsets = _offsets_i64(word_offset, n_lanes, x0.device)
    words = torch.empty((n_rows, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0:
        return words, state
    lib = _library("scalar", w1.shape[-2:])
    rc = lib.chaotic_ann_bits_launch(
        x0.device.index, code, act, *w1.shape[-2:],
        *(t.data_ptr() for t in weights), x0.data_ptr(), offsets.data_ptr(),
        words.data_ptr(), state.data_ptr(), n_lanes, n_rows,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_bits")
    chaotic_ann_bits.launches += 1
    return words, state


chaotic_ann_bits.launches = 0


def chaotic_ann_traj(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, x0: torch.Tensor, *, n_steps: int,
                     activation: str = "relu", lattice=None,
                     compute_unit: str = "vpu", coupling=None
                     ) -> torch.Tensor:
    """The (n_steps, S, I) float trajectory after x0, in x0's dtype.
    ``lattice`` takes the lattice form, ``chaotic_ann_lattice_traj``;
    ``compute_unit="mxu"`` the mxu unit, ``chaotic_ann_mxu_traj``;
    ``activation`` as in ``chaotic_ann_bits``.

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_pallas`` (K2).
    Bound on the H100: bytes with relu.  A step costs 4*I*H ops per
    I*itemsize bytes written, 96 ops per 12 bytes for 3-8-3 in f32 (6 in
    bf16), below the card's 10 (f32) or 20 (bf16) ops per byte (33.5e12 or
    66.9e12 instructions a second over 3.35 TB/s); tanh and sigmoid add
    their formulas' f32 ops and make it operations.  f32 (``traj_kernel``):
    ``chaotic_ann_bits``'s design, each thread writing its I values per
    step, so a warp writes one contiguous run per step.  bf16
    (``bf16x2_traj_kernel``): the bf16 K1's two lanes a thread and packed
    bf16x2 step; each warp stages its lanes' values of a step in shared
    memory and writes them in 16-byte stores.
    """
    _check_unit(compute_unit)
    if compute_unit == "mxu":
        return chaotic_ann_mxu_traj(w1, b1, w2, b2, x0, n_steps=n_steps,
                                    lattice=lattice, coupling=coupling,
                                    activation=activation)
    if lattice is not None:
        return chaotic_ann_lattice_traj(w1, b1, w2, b2, x0, n_steps=n_steps,
                                        lattice=lattice,
                                        activation=activation)
    act = _check_activation(activation)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_ref(w1, b1, w2, b2, x0, n_steps, activation)
    weights, code = _operands(w1, b1, w2, b2, x0)
    n_lanes = x0.shape[0]
    traj = torch.empty((n_steps,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    if n_lanes == 0 or n_steps == 0:
        return traj
    lib = _library("scalar", w1.shape[-2:])
    rc = lib.chaotic_ann_traj_launch(
        x0.device.index, code, act, *w1.shape[-2:],
        *(t.data_ptr() for t in weights), x0.data_ptr(), traj.data_ptr(),
        n_lanes, n_steps, torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_traj")
    chaotic_ann_traj.launches += 1
    return traj


chaotic_ann_traj.launches = 0


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """The kernels' activation alone, elementwise: phi(x) in x's dtype, as
    the scalar vpu K1-K4 step applies it (``ref.ACTIVATIONS``, the JAX
    package's ``jnp.tanh`` / ``jax.nn.sigmoid`` formulas).  A check hook
    that holds the device formulas against the plain ones on many inputs;
    no path calls it.  A contiguous float32 or bfloat16 tensor.
    """
    act = _check_activation(name)
    if x.device.type == "cpu":
        return ref.ACTIVATIONS[name](x)
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be a float32 or bfloat16 CUDA tensor, got "
                         f"{x.dtype} on {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _lib()
    rc = lib.chaotic_ann_activation_launch(
        x.device.index, _DTYPE_CODES[x.dtype], act, x.data_ptr(),
        y.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"activation launch failed: "
                           f"{lib.chaotic_ann_error_string(rc).decode()}")
    activation.launches += 1
    return y


activation.launches = 0


# ---------------------------------------------------------------------------
# K5: the vpu lattice forms of K1 and K2.
# ---------------------------------------------------------------------------

def _lattice_operands(w1, b1, w2, b2, x0, lattice, lead=(),
                      x_dims=("S", "I")):
    """Validated operands of a lattice launch: the weights cast to the
    state dtype, the dtype code, the shape codes (base I, base H, n_nodes,
    topology) and the coupling strength as a value of the state dtype.
    ``lead`` and ``x_dims`` as in ``_operands``."""
    check_card_lattice(lattice, w1.shape[-2])
    weights, code = _operands(w1, b1, w2, b2, x0, lead, x_dims)
    n_nodes, base_dim, topology, strength = lattice
    if w1.shape[-1] % n_nodes:
        raise ValueError(f"H = {w1.shape[-1]} does not split into "
                         f"{n_nodes} node blocks")
    eps = torch.tensor(strength, dtype=torch.float32).to(x0.dtype).item()
    shape = (base_dim, w1.shape[-1] // n_nodes, n_nodes,
             _TOPOLOGY_CODES[topology])
    return weights, code, shape, eps


def chaotic_ann_lattice_bits(w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             x0: torch.Tensor, word_offset=0, *,
                             n_steps: int, lattice,
                             activation: str = "relu"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's lattice form: (n_steps // 2, S) uint32 words and the (S, I)
    final state of a block-coupled lattice core (lattice-expanded
    block-diagonal weights, ``lattice`` its static descriptor).  The
    kernel reads only the diagonal node blocks; ``params_from_numpy``
    checks that the rest is zero where lattice weights enter the port.

    Replaces the vpu lattice form of
    ``repro/kernels/chaotic_ann.py::chaotic_ann_bits_pallas`` (K1 with K5's
    ``_lattice_delta``), with relu, tanh or sigmoid (``activation``, the
    kernel's template parameter).  Bound on the H100: operations.  A word
    costs 2 steps of n_nodes x 4*D*HB block-sparse ops plus the
    coupling's 5 (ring) or 7 (torus) ops per component, plus with tanh or
    sigmoid the formula's 16 / 21 f32 ops on each of the n_nodes x HB
    hidden units (a step: 888 / 1,912 / 2,232 ops at chen@ring8 for relu
    / tanh / sigmoid, 3,552 / 7,648 / 8,928 at chen@ring32), against 4
    bytes written.  Design: one thread per (lane, node), the node's weight
    blocks and state in registers, phi on the node's own HB hidden units;
    neighbours' state comes by warp shuffles and the lane's fold by an XOR
    shuffle reduction, so nothing but words, offsets and the final state
    touches device memory.  Past 32 nodes a lane's slot spans warps: the
    neighbours come through shared memory (one barrier a step) and the
    fold is a warp reduction a warp combined there, in the same order.
    """
    act = _check_activation(activation)
    _check_steps(n_steps)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_bits_ref(w1, b1, w2, b2, x0, n_steps,
                                        word_offset, activation, lattice)
    weights, code, shape, eps = _lattice_operands(w1, b1, w2, b2, x0,
                                                  lattice)
    n_lanes, n_rows = x0.shape[0], n_steps // 2
    offsets = ops.to_uint32(ops.word_offsets(word_offset, n_lanes, x0.device))
    words = torch.empty((n_rows, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0:
        return words, state
    lib = _library("lattice", shape)
    rc = lib.chaotic_ann_lattice_bits_launch(
        x0.device.index, code, act, *shape, eps,
        *(t.data_ptr() for t in weights), x0.data_ptr(), offsets.data_ptr(),
        words.data_ptr(), state.data_ptr(), n_lanes, n_rows,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_lattice_bits")
    chaotic_ann_lattice_bits.launches += 1
    return words, state


chaotic_ann_lattice_bits.launches = 0


def chaotic_ann_lattice_traj(w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             x0: torch.Tensor, *, n_steps: int, lattice,
                             activation: str = "relu") -> torch.Tensor:
    """K2's lattice form: the (n_steps, S, I) trajectory of a lattice core,
    with ``activation`` as in ``chaotic_ann_lattice_bits``.

    Replaces the vpu lattice form of
    ``repro/kernels/chaotic_ann.py::chaotic_ann_pallas`` (K2 with K5).
    Bound on the H100 with relu: bytes.  A step at chen@ring32 is 3,552
    ops against 384 f32 or 192 bf16 bytes written, 9.25 or 18.5 ops per
    byte, below the card's 10 (f32) or 20 (bf16) ops per byte of
    bandwidth; with tanh or sigmoid operations (7,648 / 8,928 ops a step,
    the formulas' at the f32 rate).  f32 (``lattice_traj_kernel``): the
    design of ``chaotic_ann_lattice_bits``, one lane a node thread; the 32
    threads of a chen@ring32 lane write its 96 values of a step as one
    contiguous run.  bf16 (``bf16x2_lattice_traj_kernel``): the bf16x2
    lattice K1's step, two lanes a node thread packed in one register,
    every op one ``add/sub/mul.rn.bf16x2`` with no f32 round trip; a CTA's
    lanes are contiguous, so a step's values of a warp are two contiguous
    runs, staged in shared memory and written in 16-byte stores (a lane's
    values of a step are whole 16-byte chunks: ``n_nodes * base_dim`` is a
    multiple of 8).
    """
    act = _check_activation(activation)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_ref(w1, b1, w2, b2, x0, n_steps, activation,
                                   lattice)
    weights, code, shape, eps = _lattice_operands(w1, b1, w2, b2, x0,
                                                  lattice)
    n_lanes = x0.shape[0]
    traj = torch.empty((n_steps,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    if n_lanes == 0 or n_steps == 0:
        return traj
    lib = _library("lattice", shape)
    rc = lib.chaotic_ann_lattice_traj_launch(
        x0.device.index, code, act, *shape, eps,
        *(t.data_ptr() for t in weights), x0.data_ptr(), traj.data_ptr(),
        n_lanes, n_steps, torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_lattice_traj")
    chaotic_ann_lattice_traj.launches += 1
    return traj


chaotic_ann_lattice_traj.launches = 0


# ---------------------------------------------------------------------------
# The mxu unit of K1 and K2, with K5's mxu coupling for a lattice core.
# ---------------------------------------------------------------------------

def _mxu_operands(w1, b1, w2, b2, x0, lattice, coupling, lead=()):
    """Validated operands of an mxu launch: the weights cast to the state
    dtype, the coupling operand likewise (None for a scalar core), the
    dtype code and the shape codes (node I, node H, n_nodes, topology); a
    scalar core is one node.  ``lead`` as in ``_operands``: the coupling
    operand is one (I, I) array whatever the lead."""
    weights, code = _operands(w1, b1, w2, b2, x0, lead)
    i_dim, h_dim = w1.shape[-2:]
    if lattice is None:
        return weights, None, code, (i_dim, h_dim, 1, 0)
    check_card_lattice(lattice, i_dim)
    n_nodes, base_dim, topology, _ = lattice
    if h_dim % n_nodes:
        raise ValueError(f"H = {h_dim} does not split into {n_nodes} node "
                         f"blocks")
    if coupling is None or tuple(coupling.shape) != (i_dim, i_dim) \
            or coupling.device != x0.device:
        raise ValueError(f"an mxu lattice launch needs the dense ({i_dim}, "
                         f"{i_dim}) coupling operand on {x0.device}")
    return (weights, coupling.to(x0.dtype).contiguous(), code,
            (base_dim, h_dim // n_nodes, n_nodes, _TOPOLOGY_CODES[topology]))


def chaotic_ann_mxu_bits(w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         x0: torch.Tensor, word_offset=0, *, n_steps: int,
                         lattice=None, coupling=None,
                         activation: str = "relu"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the mxu unit: (n_steps // 2, S) uint32 words and the (S, I)
    final state of a scalar core, or of a lattice core (``lattice`` its
    descriptor, ``coupling`` its dense (I, I) operand; block-diagonal
    weights, a coupling zero off its ring or torus support, as
    ``params_from_numpy`` checks).

    Replaces the mxu form of
    ``repro/kernels/chaotic_ann.py::chaotic_ann_bits_pallas`` (K1, with
    K5's coupling dot for a lattice).  Each dot is a forward chain of f32
    FMAs, the order the JAX package's mxu stream has, so this is a word
    stream of its own, bitwise the JAX one.  ``activation`` relu, tanh or
    sigmoid: phi of the dtype-rounded ``dot + b1``, its f32 result read
    unrounded by the second dot (in bf16 the inner ops of sigmoid stay
    rounded), as the JAX kernel computes it.  Bound on the H100:
    operations, in both dtypes (the chains accumulate in f32): per word 2
    steps of n_nodes x (2*D*HB) FMAs of 2 flops and the coupling's 3
    (ring) or 5 (torus) FMAs per component at the f32 FMA rate (96 flops
    a step for 3-8-3, 3,648 at chen@ring32: the nonzero terms of the
    dense dots, which have 58,368 FMAs), plus the bias and coupling adds
    (11 / 448) at the state dtype's add rate (packed bf16x2 in bf16), and
    tanh's 16 or sigmoid's 21 f32 ops on each hidden unit (4,096 / 5,376
    a step at chen@ring32) at the f32 instruction rate, against 4 bytes
    written.
    Design (``mxu_x2_bits_kernel``, ``bf16x2_mxu_bits_kernel``): two
    lanes a thread, a CTA of 128 threads holding 128 / W lane slots of W =
    ``slot_width(n_nodes)`` threads, or one slot of W > 128 (a scalar core
    is one node; past n_nodes a slot's threads are idle, mirroring the
    last node), slot s lanes s and s + 128 / W of the CTA's range (past 32
    nodes the coupling's support nodes come through shared memory); the node's weight blocks in
    registers once for both lanes, the chains over the node's nonzero
    terms in the dense order; in bf16 both lanes packed in one register,
    each chain's f32 pair rounded by one ``cvt.rn.bf16x2.f32``, the bias
    and coupling adds ``add.rn.bf16x2``; both lanes' folds reduced
    together over the slot's nodes.
    """
    act = _check_activation(activation)
    _check_steps(n_steps)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_bits_ref(w1, b1, w2, b2, x0, n_steps,
                                        word_offset, activation, lattice,
                                        "mxu", coupling)
    weights, cpl, code, shape = _mxu_operands(w1, b1, w2, b2, x0, lattice,
                                              coupling)
    n_lanes, n_rows = x0.shape[0], n_steps // 2
    offsets = ops.to_uint32(ops.word_offsets(word_offset, n_lanes, x0.device))
    words = torch.empty((n_rows, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0:
        return words, state
    lib = _library("mxu", shape)
    rc = lib.chaotic_ann_mxu_bits_launch(
        x0.device.index, code, act, *shape,
        *(t.data_ptr() for t in weights),
        None if cpl is None else cpl.data_ptr(), x0.data_ptr(),
        offsets.data_ptr(), words.data_ptr(), state.data_ptr(), n_lanes,
        n_rows, torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_mxu_bits")
    chaotic_ann_mxu_bits.launches += 1
    return words, state


chaotic_ann_mxu_bits.launches = 0


def chaotic_ann_mxu_traj(w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         x0: torch.Tensor, *, n_steps: int, lattice=None,
                         coupling=None, activation: str = "relu"
                         ) -> torch.Tensor:
    """K2 on the mxu unit: the (n_steps, S, I) trajectory of a scalar or
    lattice core, with the operands of ``chaotic_ann_mxu_bits``.

    Replaces the mxu form of
    ``repro/kernels/chaotic_ann.py::chaotic_ann_pallas`` (K2, with K5's
    coupling dot), relu, tanh or sigmoid.  Bound on the H100: at
    chen@ring32 with relu bytes in f32 (3,648 FMA flops and 448 f32 ops a
    step, the time of 4,544 flops at the FMA rate, against 384 bytes
    written: 11.8 a byte, under the card's 20) and operations in bf16 (192
    bytes, 23.7); with tanh or sigmoid operations in both; operations for
    3-8-3 (96 FMA flops and 11, 139 / 179 with tanh / sigmoid, f32 ops a
    step against 12 or 6 bytes).  Same design as ``chaotic_ann_mxu_bits``
    (``mxu_x2_traj_kernel``, ``bf16x2_mxu_traj_kernel``: two lanes a
    thread); each warp stages its lanes' values of a step in shared memory
    and writes them in 16-byte stores.
    """
    act = _check_activation(activation)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_ref(w1, b1, w2, b2, x0, n_steps, activation,
                                   lattice, "mxu", coupling)
    weights, cpl, code, shape = _mxu_operands(w1, b1, w2, b2, x0, lattice,
                                              coupling)
    n_lanes = x0.shape[0]
    traj = torch.empty((n_steps,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    if n_lanes == 0 or n_steps == 0:
        return traj
    lib = _library("mxu", shape)
    rc = lib.chaotic_ann_mxu_traj_launch(
        x0.device.index, code, act, *shape,
        *(t.data_ptr() for t in weights),
        None if cpl is None else cpl.data_ptr(), x0.data_ptr(),
        traj.data_ptr(), n_lanes, n_steps,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_mxu_traj")
    chaotic_ann_mxu_traj.launches += 1
    return traj


chaotic_ann_mxu_traj.launches = 0


# ---------------------------------------------------------------------------
# The gang contract (pure integer code, copied from the JAX package): which
# rows a ragged lane-concat gang launch computes.  The farm advances each
# member by exactly these rows, so the CUDA kernel, which has no time grid,
# still computes them.
# ---------------------------------------------------------------------------

def _bits_blocks(n_steps: int, t_block: int, unroll: int):
    """Largest legal (t_block, unroll) not exceeding the requested ones.

    The fused kernel must run *exactly* n_steps (the final state is part of
    the contract), so t_block has to divide n_steps; it must also be even
    (2 samples -> 1 word) and unroll counts word rows, so it must divide
    t_block // 2.
    """
    t_block = max(2, t_block - (t_block % 2))
    tb = math.gcd(t_block, n_steps)
    un = max(1, math.gcd(unroll, tb // 2))
    return tb, un


def gang_row_granularity(n_steps: int, t_block: int, unroll: int) -> int:
    """Word-row granularity of ragged early-out in the lane-concat kernel:
    a block's computed rows are its ``row_map`` entry rounded up to the
    post-gcd unroll (the ``_bits_blocks`` collapse)."""
    _, un = _bits_blocks(n_steps, t_block, unroll)
    return un


def gang_effective_rows(row_map, n_steps: int, t_block: int,
                        unroll: int) -> np.ndarray:
    """Word rows each lane block of a ragged gang launch actually computes
    (and therefore the rows its member's state/counters advance by)."""
    un = gang_row_granularity(n_steps, t_block, unroll)
    r = np.asarray(row_map, np.int64)
    return np.minimum(-(-r // un) * un, n_steps // 2).astype(np.int32)


def _host_ints(a) -> np.ndarray:
    """A host int64 copy of a list, numpy array or tensor of integers."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.int64)


def _gang_maps(x0, core_map, row_map, n_cores: int, n_steps: int,
               s_block: int, t_block: int, unroll: int):
    """Validated host maps of a lane-concat launch: (core_map, rows), each
    (n_blocks,), ``rows`` the ``gang_effective_rows`` of ``row_map`` (all
    rows when None)."""
    _check_steps(n_steps)
    cmap = _host_ints(core_map)
    n_blocks, n_lanes = cmap.shape[0], x0.shape[0]
    if n_lanes != n_blocks * s_block:
        raise ValueError(
            f"pool of {n_lanes} lanes != {n_blocks} core-map blocks x "
            f"s_block {s_block}; pad each member pool to an s_block multiple")
    if row_map is not None and np.shape(row_map) != cmap.shape:
        raise ValueError(f"row_map shape {np.shape(row_map)} != core_map "
                         f"shape {cmap.shape}")
    if n_blocks and (cmap.min() < 0 or cmap.max() >= n_cores):
        raise ValueError(f"core_map values must lie in [0, {n_cores})")
    rows = (gang_effective_rows(row_map, n_steps, t_block, unroll)
            if row_map is not None
            else np.full(n_blocks, n_steps // 2, np.int32))
    return cmap, rows


def _stacked_rows(x0, row_map, n_cores: int, n_steps: int) -> np.ndarray:
    """Validated (C,) rows of a stacked launch: ``row_map`` clamped to
    n_steps // 2, or all rows."""
    _check_steps(n_steps)
    if x0.ndim != 3 or x0.shape[0] != n_cores:
        raise ValueError(f"x0 must be ({n_cores}, S, I), one pool per "
                         f"core, got {tuple(x0.shape)}")
    if row_map is not None and np.shape(row_map) != (n_cores,):
        raise ValueError(f"row_map must have shape ({n_cores},), got "
                         f"{np.shape(row_map)}")
    n_rows = n_steps // 2
    return (np.minimum(_host_ints(row_map), n_rows) if row_map is not None
            else np.full(n_cores, n_rows, np.int64))


def chaotic_ann_gang_bits(w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor,
                          x0: torch.Tensor, core_map, word_offset=0,
                          row_map=None, *, n_steps: int, s_block: int = 256,
                          t_block: int = 128, unroll: int = 1,
                          activation: str = "relu",
                          compute_unit: str = "vpu", lattice=None,
                          coupling=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-concat gang launch: C stacked nets (``w1`` (C, I, H), ``b1``
    (C, H), ``w2`` (C, H, I), ``b2`` (C, I)), one launch.  ``x0`` (S, I)
    is ``len(core_map)`` blocks of ``s_block`` lanes; block ``g`` runs net
    ``core_map[g]``.  ``row_map`` (n_blocks,) is each block's demand in
    word rows: block ``g`` computes ``gang_effective_rows(row_map, n_steps,
    t_block, unroll)[g]`` rows (its demand rounded up to the granularity
    the farm absorbs by) and its state advances by exactly that; later
    rows are unwritten.  None = every block computes every row.  Returns
    (n_steps // 2, S) uint32 words and the (S, I) state.  ``lattice`` (one
    descriptor for every core) takes the lattice form,
    ``chaotic_ann_lattice_gang_bits``; ``compute_unit="mxu"`` the mxu
    unit, ``chaotic_ann_mxu_gang_bits`` (a lattice group with its one
    shared dense ``coupling``).  ``activation`` relu, tanh or sigmoid on
    every form (the kernel's template parameter, as K1's).

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_gang_bits_pallas``
    (K3).  Bound on the H100: operations, as K1: 2 steps of 4*I*H
    separate ops per word, plus H times the activation's formula ops a
    step (tanh 16, sigmoid 21 per hidden unit: 224 / 264 ops a 3-8-3 step
    against relu's 96), summed over the rows each block really computes,
    against 4 bytes written per word; bf16 ops at the packed bf16x2 rate,
    twice f32's.  Design: a CTA lies inside one lane block, reads its
    block's core and rows, and stages that core's weights in shared
    memory; the TPU's scalar-prefetched maps become two small int32 arrays
    the CTA reads itself.  f32 (``f32_gang_bits_kernel``): the f32 K1's
    row loop (``f32_rows``), a thread a lane, CTAs of 128 lanes indexed by
    (block, CTA in the block), ``s_block`` a multiple of 128.  bf16
    (``bf16x2_gang_bits_kernel``): the bf16x2 K1's row loop, two lanes a
    thread packed in one register, every op one ``add/sub/mul.rn.bf16x2``
    with no f32 round trip, the weights held in registers; a CTA of 64
    threads holds 128 lanes of one block, CTAs indexed by (block, CTA in
    the block), so every CTA has both lane halves live (the served farms'
    ``s_block`` is 128, a client's lanes).  Both take the same ``s_block``
    values.
    """
    _check_unit(compute_unit)
    if compute_unit == "mxu":
        return chaotic_ann_mxu_gang_bits(
            w1, b1, w2, b2, x0, core_map, word_offset, row_map,
            n_steps=n_steps, lattice=lattice, coupling=coupling,
            s_block=s_block, t_block=t_block, unroll=unroll,
            activation=activation)
    if lattice is not None:
        return chaotic_ann_lattice_gang_bits(
            w1, b1, w2, b2, x0, core_map, word_offset, row_map,
            n_steps=n_steps, lattice=lattice, s_block=s_block,
            t_block=t_block, unroll=unroll, activation=activation)
    act = _check_activation(activation)
    n_cores = w1.shape[0]
    cmap, rows = _gang_maps(x0, core_map, row_map, n_cores, n_steps, s_block,
                            t_block, unroll)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_gang_bits_ref(w1, b1, w2, b2, x0, cmap,
                                             n_steps, word_offset, rows,
                                             activation)
    if s_block % _CTA_LANES:
        raise ValueError(f"s_block {s_block} must be a multiple of "
                         f"{_CTA_LANES}, the kernel's lanes per CTA")
    weights, code = _operands(w1, b1, w2, b2, x0, lead=(n_cores,))
    n_lanes, n_rows = x0.shape[0], n_steps // 2
    maps = _int32_on_card(np.stack([cmap, rows]), x0.device)
    offsets = _offsets_i64(word_offset, n_lanes, x0.device)
    words = torch.empty((n_rows, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0:
        return words, state
    lib = _library("scalar", w1.shape[-2:])
    rc = lib.chaotic_ann_gang_bits_launch(
        x0.device.index, code, act, *w1.shape[-2:],
        *(t.data_ptr() for t in weights), x0.data_ptr(), maps[0].data_ptr(),
        maps[1].data_ptr(), offsets.data_ptr(), words.data_ptr(),
        state.data_ptr(), n_lanes, s_block, n_rows,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_gang_bits")
    chaotic_ann_gang_bits.launches += 1
    return words, state


chaotic_ann_gang_bits.launches = 0


def chaotic_ann_gang_stacked(w1: torch.Tensor, b1: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             x0: torch.Tensor, word_offset=0, row_map=None,
                             *, n_steps: int, activation: str = "relu",
                             compute_unit: str = "vpu", lattice=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked gang launch for C equal pools: stacked nets as in
    ``chaotic_ann_gang_bits``, ``x0`` (C, S, I), ``word_offset`` a scalar
    or (C, S).  ``row_map`` (C,) freezes core ``c`` after exactly
    ``min(row_map[c], n_steps // 2)`` rows, with no rounding; later rows
    are unwritten.  Returns (n_steps // 2, C, S) uint32 words and the
    (C, S, I) state.  ``lattice`` takes the lattice form,
    ``chaotic_ann_lattice_gang_stacked``; ``activation`` as in
    ``chaotic_ann_gang_bits``.

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_gang_stacked_pallas``
    (K4).  Bound on the H100: operations, as K3 (the activation's formula
    ops included), summed over the rows each core really computes.
    Design: a 2-D grid, ``blockIdx.y`` the core, whose weights the CTA
    stages in shared memory; a thread's lanes are counted inside its core.
    f32 (``f32_gang_stacked_kernel``): ``f32_rows``, a thread a lane.  bf16
    (``bf16x2_gang_stacked_kernel``): the bf16x2 K1's row loop, two lanes
    a thread packed in one register, no f32 round trip, the weights held
    in registers; a ragged edge mirrors the core's own last lane.  The
    TPU's sublane stacking (one vreg sweep advancing all C cores) has no
    counterpart: C cores are C times the threads.  A frozen core's threads
    stop at its rows.
    """
    if compute_unit != "vpu":
        raise ValueError("stacked gang launches support compute_unit='vpu' "
                         "only (the stacked step is the vpu order)")
    if lattice is not None:
        return chaotic_ann_lattice_gang_stacked(
            w1, b1, w2, b2, x0, word_offset, row_map, n_steps=n_steps,
            lattice=lattice, activation=activation)
    act = _check_activation(activation)
    n_cores, n_rows = w1.shape[0], n_steps // 2
    rows = _stacked_rows(x0, row_map, n_cores, n_steps)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_gang_stacked_ref(w1, b1, w2, b2, x0, n_steps,
                                                word_offset, rows,
                                                activation)
    if n_cores > 65535:
        raise ValueError(f"{n_cores} cores exceed the grid's y extent")
    weights, code = _operands(w1, b1, w2, b2, x0, lead=(n_cores,),
                              x_dims=("C", "S", "I"))
    n_lanes = x0.shape[1]
    rows_d = _int32_on_card(rows, x0.device)
    offsets = _offsets_i64(word_offset, (n_cores, n_lanes), x0.device)
    words = torch.empty((n_rows, n_cores, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0 or n_cores == 0:
        return words, state
    lib = _library("scalar", w1.shape[-2:])
    rc = lib.chaotic_ann_gang_stacked_launch(
        x0.device.index, code, act, *w1.shape[-2:],
        *(t.data_ptr() for t in weights), x0.data_ptr(), rows_d.data_ptr(),
        offsets.data_ptr(), words.data_ptr(), state.data_ptr(), n_cores,
        n_lanes, n_rows, torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_gang_stacked")
    chaotic_ann_gang_stacked.launches += 1
    return words, state


chaotic_ann_gang_stacked.launches = 0


# ---------------------------------------------------------------------------
# K5 in K3 and K4: the vpu lattice forms of the gang kernels.
# ---------------------------------------------------------------------------

def chaotic_ann_lattice_gang_bits(w1: torch.Tensor, b1: torch.Tensor,
                                  w2: torch.Tensor, b2: torch.Tensor,
                                  x0: torch.Tensor, core_map, word_offset=0,
                                  row_map=None, *, n_steps: int, lattice,
                                  s_block: int = 256, t_block: int = 128,
                                  unroll: int = 1, activation: str = "relu"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's lattice form: the lane-concat gang of ``chaotic_ann_gang_bits``
    for C lattice cores of ONE descriptor ``lattice``, each with its own
    lattice-expanded block-diagonal weights in the stacked operands.
    Precondition, checked where stacked lattice weights enter (the farm's
    gang plan; ``params_from_numpy`` for each core): every core's weights
    are zero off their diagonal node blocks, the only entries read.

    Replaces the vpu lattice form of
    ``repro/kernels/chaotic_ann.py::chaotic_ann_gang_bits_pallas`` (K3 with
    K5's ``_lattice_delta``), with the group's one ``activation`` (relu,
    tanh or sigmoid).  Bound on the H100: operations, as
    ``chaotic_ann_lattice_bits`` (2 steps of 888 / 1,912 / 2,232 ops a word
    at chen@ring8 for relu / tanh / sigmoid), summed over the rows each
    block really computes, against 4 bytes a word; bf16 ops at the packed
    bf16x2 rate, twice f32's.  Design: the lattice K1's thread per (lane,
    node), weight blocks and state in registers, neighbours by warp
    shuffles (past 32 nodes through shared memory: a slot spans warps).
    A CTA lies inside one lane block and reads that block's
    core and rows.  f32 (``lattice_gang_bits_kernel``): a CTA holds
    ``gang_lane_granularity`` lanes (128 / W, W = ``slot_width(n_nodes)``,
    or one past 128 nodes) and ``s_block`` is a
    multiple of that (``gang_lane_granularity``).  bf16
    (``bf16x2_lattice_gang_bits_kernel``): the bf16x2 lattice K1's row
    loop, two lanes a node thread in one register, every op one packed
    ``add/sub/mul.rn.bf16x2`` with no f32 round trip; a CTA holds
    2 * 128 / W lanes of one block, CTAs indexed by (block, CTA in
    the block), and an ``s_block`` that is an odd multiple of 128 / W
    leaves the block's last CTA one lane half, which mirrors the block's
    last lane and writes nothing.  Both take the same ``s_block`` values.
    """
    act = _check_activation(activation)
    n_cores = w1.shape[0]
    cmap, rows = _gang_maps(x0, core_map, row_map, n_cores, n_steps, s_block,
                            t_block, unroll)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_gang_bits_ref(w1, b1, w2, b2, x0, cmap,
                                             n_steps, word_offset, rows,
                                             activation, lattice)
    weights, code, shape, eps = _lattice_operands(
        w1, b1, w2, b2, x0, lattice, lead=(n_cores,))
    cta_lanes = gang_lane_granularity(lattice[0])
    if s_block % cta_lanes:
        raise ValueError(f"s_block {s_block} must be a multiple of "
                         f"{cta_lanes}, the lattice kernel's lanes per CTA "
                         f"at {lattice[0]} nodes")
    n_lanes, n_rows = x0.shape[0], n_steps // 2
    maps = _int32_on_card(np.stack([cmap, rows]), x0.device)
    offsets = ops.to_uint32(ops.word_offsets(word_offset, n_lanes, x0.device))
    words = torch.empty((n_rows, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0:
        return words, state
    lib = _library("lattice", shape)
    rc = lib.chaotic_ann_lattice_gang_bits_launch(
        x0.device.index, code, act, *shape, eps,
        *(t.data_ptr() for t in weights), x0.data_ptr(), maps[0].data_ptr(),
        maps[1].data_ptr(), offsets.data_ptr(), words.data_ptr(),
        state.data_ptr(), n_lanes, s_block, n_rows,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_lattice_gang_bits")
    chaotic_ann_lattice_gang_bits.launches += 1
    return words, state


chaotic_ann_lattice_gang_bits.launches = 0


def chaotic_ann_lattice_gang_stacked(w1: torch.Tensor, b1: torch.Tensor,
                                     w2: torch.Tensor, b2: torch.Tensor,
                                     x0: torch.Tensor, word_offset=0,
                                     row_map=None, *, n_steps: int, lattice,
                                     activation: str = "relu"
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's lattice form: the stacked gang of ``chaotic_ann_gang_stacked``
    for C equal pools of lattice cores of ONE descriptor ``lattice``, with
    the precondition of ``chaotic_ann_lattice_gang_bits``.

    Replaces the vpu lattice form of
    ``repro/kernels/chaotic_ann.py::chaotic_ann_gang_stacked_pallas`` (K4
    with K5's ``_lattice_delta``), with the group's one ``activation``.
    Bound on the H100: operations, as ``chaotic_ann_lattice_bits`` (the
    activation's formula ops included), summed over the rows each core
    really computes; bf16 ops at the packed bf16x2 rate.  Design:
    ``blockIdx.y`` the core, the lattice K1's thread per (lane, node)
    within it; a thread's lanes are counted inside its core, so a ragged
    edge mirrors the core's own last lane.  f32:
    ``lattice_gang_stacked_kernel``, one lane a node thread.  bf16:
    ``bf16x2_lattice_gang_stacked_kernel``, the bf16x2 lattice K1's row
    loop, two lanes a node thread packed in one register, no f32 round
    trip.  The TPU's sublane stack of C lattice periods has no
    counterpart: each CTA holds one core's state in registers, so there is
    no VMEM cliff, and the only limit is the grid's y extent (65,535
    cores).
    """
    act = _check_activation(activation)
    n_cores, n_rows = w1.shape[0], n_steps // 2
    rows = _stacked_rows(x0, row_map, n_cores, n_steps)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_gang_stacked_ref(w1, b1, w2, b2, x0, n_steps,
                                                word_offset, rows,
                                                activation, lattice)
    if n_cores > 65535:
        raise ValueError(f"{n_cores} cores exceed the grid's y extent")
    weights, code, shape, eps = _lattice_operands(
        w1, b1, w2, b2, x0, lattice, lead=(n_cores,), x_dims=("C", "S", "I"))
    n_lanes = x0.shape[1]
    rows_d = _int32_on_card(rows, x0.device)
    offsets = ops.to_uint32(ops.word_offsets(
        word_offset, (n_cores, n_lanes), x0.device))
    words = torch.empty((n_rows, n_cores, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0 or n_cores == 0:
        return words, state
    lib = _library("lattice", shape)
    rc = lib.chaotic_ann_lattice_gang_stacked_launch(
        x0.device.index, code, act, *shape, eps,
        *(t.data_ptr() for t in weights), x0.data_ptr(), rows_d.data_ptr(),
        offsets.data_ptr(), words.data_ptr(), state.data_ptr(), n_cores,
        n_lanes, n_rows, torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_lattice_gang_stacked")
    chaotic_ann_lattice_gang_stacked.launches += 1
    return words, state


chaotic_ann_lattice_gang_stacked.launches = 0


# ---------------------------------------------------------------------------
# K3 on the mxu unit, scalar and lattice cores alike.
# ---------------------------------------------------------------------------

def chaotic_ann_mxu_gang_bits(w1: torch.Tensor, b1: torch.Tensor,
                              w2: torch.Tensor, b2: torch.Tensor,
                              x0: torch.Tensor, core_map, word_offset=0,
                              row_map=None, *, n_steps: int, lattice=None,
                              coupling=None, s_block: int = 256,
                              t_block: int = 128, unroll: int = 1,
                              activation: str = "relu"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the mxu unit: the lane-concat gang of ``chaotic_ann_gang_bits``
    for C scalar cores, or C lattice cores of ONE descriptor ``lattice``
    with ONE dense (I, I) ``coupling`` operand shared by every lane block
    (the farm's compat key pins the descriptor, and the coupling is a
    function of it).  Preconditions, as ``chaotic_ann_mxu_bits``: lattice
    weights block-diagonal and the coupling zero off its ring or torus
    support (checked where they enter: the farm's gang plan and
    ``params_from_numpy``).

    Replaces the mxu form of
    ``repro/kernels/chaotic_ann.py::chaotic_ann_gang_bits_pallas`` (K3 with
    the dot step, and K5's coupling dot for a lattice), relu, tanh or
    sigmoid as ``chaotic_ann_mxu_bits``.  Bound on the H100: operations in
    both dtypes, as ``chaotic_ann_mxu_bits`` (at chen@ring32 3,648 FMA
    flops a step and 448 f32 ops with relu, 4,544 / 5,824 with tanh /
    sigmoid; 96 and 11, 139, 179 for 3-8-3), summed over the rows each
    block really computes, against 4 bytes a word.  Design
    (``mxu_x2_gang_bits_kernel`` in f32, ``bf16x2_mxu_gang_bits_kernel``
    in bf16): the mxu K1's row loop, two lanes a thread, on the lane
    block's core, so a core's words are bitwise its mxu K1's.  A CTA of
    128 threads holds 128 / W lane slots of two lanes each (past 128
    nodes a CTA is one slot of W threads) and lies
    inside one lane block, reading that block's core and rows; CTAs are
    indexed by (block, CTA in the block), so ``s_block`` is any multiple
    of 128 / W, and where it is an odd one the block's last CTA
    holds one live lane half, the other mirroring the block's last lane
    and writing nothing (a scalar core at ``s_block`` 128: every CTA; in
    f32 such a thread runs its one lane alone).  K4
    has no mxu form (the stacked step is the vpu order), so every mxu gang
    is this launch.
    """
    act = _check_activation(activation)
    n_cores = w1.shape[0]
    cmap, rows = _gang_maps(x0, core_map, row_map, n_cores, n_steps, s_block,
                            t_block, unroll)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_gang_bits_ref(w1, b1, w2, b2, x0, cmap,
                                             n_steps, word_offset, rows,
                                             activation, lattice, "mxu",
                                             coupling)
    weights, cpl, code, shape = _mxu_operands(w1, b1, w2, b2, x0, lattice,
                                              coupling, lead=(n_cores,))
    cta_lanes = gang_lane_granularity(shape[2])
    if s_block % cta_lanes:
        raise ValueError(f"s_block {s_block} must be a multiple of "
                         f"{cta_lanes}, the mxu kernel's lane slots per CTA at "
                         f"{shape[2]} node(s)")
    n_lanes, n_rows = x0.shape[0], n_steps // 2
    maps = _int32_on_card(np.stack([cmap, rows]), x0.device)
    offsets = ops.to_uint32(ops.word_offsets(word_offset, n_lanes, x0.device))
    words = torch.empty((n_rows, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0:
        return words, state
    lib = _library("mxu", shape)
    rc = lib.chaotic_ann_mxu_gang_bits_launch(
        x0.device.index, code, act, *shape,
        *(t.data_ptr() for t in weights),
        None if cpl is None else cpl.data_ptr(), x0.data_ptr(),
        maps[0].data_ptr(), maps[1].data_ptr(), offsets.data_ptr(),
        words.data_ptr(), state.data_ptr(), n_lanes, s_block, n_rows,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_mxu_gang_bits")
    chaotic_ann_mxu_gang_bits.launches += 1
    return words, state


chaotic_ann_mxu_gang_bits.launches = 0


# ---------------------------------------------------------------------------
# Device-sharded gang launches: K3 and K4 with the pooled stream axis (and
# the per-block maps) partitioned across a mesh's devices, the weights
# replicated.  No kernel of their own: each shard launches K3 or K4.
# ---------------------------------------------------------------------------

def gang_partition_maps(core_map, row_map, *, n_dev: int, n_rows: int):
    """Partition the per-block gang maps across ``n_dev`` devices (copied
    from the JAX package).

    Pads the block axis with DEAD blocks (core 0, zero row demand) until it
    divides the device count, so every device owns the same number of
    ``s_block``-lane blocks and reads its own contiguous slice of the
    core-id and row maps.  Padding forces the launch ragged (dead blocks
    compute zero rows), and a ``row_map`` of ``n_rows`` per real block
    reproduces the padded group-max launch exactly.

    Returns ``(core_map, row_map, pad_blocks)`` as numpy arrays.  Device
    ``d`` takes ``core_map[d * B:(d + 1) * B]`` with ``B = len(core_map)
    // n_dev``.
    """
    cmap = np.asarray(core_map, np.int32)
    n_blocks = cmap.shape[0]
    pad = (-n_blocks) % n_dev
    rmap = None if row_map is None else np.asarray(row_map, np.int32)
    if pad == 0:
        return cmap, rmap, 0
    if rmap is None:
        rmap = np.full(n_blocks, n_rows, np.int32)
    return (np.concatenate([cmap, np.zeros(pad, np.int32)]),
            np.concatenate([rmap, np.zeros(pad, np.int32)]), pad)


def chaotic_ann_gang_bits_sharded(w1: torch.Tensor, b1: torch.Tensor,
                                  w2: torch.Tensor, b2: torch.Tensor,
                                  x0: torch.Tensor, core_map, word_offset=0,
                                  row_map=None, coupling=None, *, mesh,
                                  n_steps: int,
                                  s_block: int = 256, t_block: int = 128,
                                  unroll: int = 1, activation: str = "relu",
                                  compute_unit: str = "vpu", lattice=None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-concat gang launch (``chaotic_ann_gang_bits``, K3 in every
    form) partitioned across ``mesh`` (a ``distributed.sharding.DeviceMesh``)
    on its axis.

    Device ``d`` runs K3 on its own contiguous run of lane blocks with its
    own slice of the core-id and row maps and of the offsets; weights and
    ``coupling`` are replicated (``mesh.replicate``: copied to a device
    once, not on every flush).  Words and state gather on the lane axis
    on ``x0``'s device.  Lanes evolve independently and a word's whitening
    reads its lane's absolute row offset, so the result is bitwise the
    unsharded launch's (and the per-core launches') at any device count.
    The block count must divide the device count: pad the maps (and the
    pool) with ``gang_partition_maps`` dead blocks first.

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_gang_bits_sharded``
    (a ``shard_map`` of K3, no ``pallas_call`` of its own).
    """
    n_dev = len(mesh.devices)
    cmap = _host_ints(core_map)
    n_blocks = int(cmap.shape[0])
    if n_blocks % n_dev:
        raise ValueError(
            f"{n_blocks} lane blocks do not divide {n_dev} devices on mesh "
            f"axis {mesh.axis!r}; pad the maps with gang_partition_maps")
    has_cpl = lattice is not None and compute_unit == "mxu"
    if has_cpl and coupling is None:
        raise ValueError("mxu lattice launches need the dense coupling operand")
    rmap = None if row_map is None else _host_ints(row_map)
    s_total = x0.shape[0]
    off = ops.word_offsets(word_offset, s_total, x0.device)
    per = n_blocks // n_dev
    lanes = per * s_block
    words, state = [], []
    for d, dev in enumerate(mesh.devices):
        blk = slice(d * per, (d + 1) * per)
        ln = slice(d * lanes, (d + 1) * lanes)
        w, s = chaotic_ann_gang_bits(
            *(mesh.replicate(t, dev) for t in (w1, b1, w2, b2)),
            mesh.to(x0[ln], dev), cmap[blk],
            mesh.to(off[ln].contiguous(), dev),
            None if rmap is None else rmap[blk], n_steps=n_steps,
            s_block=s_block, t_block=t_block, unroll=unroll,
            activation=activation, compute_unit=compute_unit,
            lattice=lattice,
            coupling=mesh.replicate(coupling, dev) if has_cpl else None)
        mesh.shard_launches[d] += 1
        words.append(mesh.to(w, x0.device))
        state.append(mesh.to(s, x0.device))
    return torch.cat(words, dim=1), torch.cat(state, dim=0)


def chaotic_ann_gang_stacked_sharded(w1: torch.Tensor, b1: torch.Tensor,
                                     w2: torch.Tensor, b2: torch.Tensor,
                                     x0: torch.Tensor, word_offset=0,
                                     row_map=None, *, mesh, n_steps: int,
                                     activation: str = "relu",
                                     compute_unit: str = "vpu", lattice=None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked gang launch (``chaotic_ann_gang_stacked``, K4 in every form)
    partitioned across ``mesh`` on its axis.

    The group's equal pools shard on the STREAM axis: every device runs
    K4 on all C cores with 1/n_dev of each pool's lanes; the (C,) row map
    is replicated, since a core's freeze row is lane-independent, and so
    are the weights (``mesh.replicate``).  Words gather on the lane axis,
    states on the stream axis, on ``x0``'s device; bitwise the unsharded
    launch.  The pool size must divide the device count; ragged pool
    sizes take the lane-concat sharded path instead.

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_gang_stacked_sharded``
    (a ``shard_map`` of K4, no ``pallas_call`` of its own).
    """
    n_dev = len(mesh.devices)
    n_cores, s_total = x0.shape[0], x0.shape[1]
    if s_total % n_dev:
        raise ValueError(
            f"stacked pool of {s_total} lanes does not divide {n_dev} "
            f"devices on mesh axis {mesh.axis!r}")
    off = ops.word_offsets(word_offset, (n_cores, s_total), x0.device)
    per = s_total // n_dev
    words, state = [], []
    for d, dev in enumerate(mesh.devices):
        ln = slice(d * per, (d + 1) * per)
        w, s = chaotic_ann_gang_stacked(
            *(mesh.replicate(t, dev) for t in (w1, b1, w2, b2)),
            mesh.to(x0[:, ln].contiguous(), dev),
            mesh.to(off[:, ln].contiguous(), dev), row_map, n_steps=n_steps,
            activation=activation, compute_unit=compute_unit,
            lattice=lattice)
        mesh.shard_launches[d] += 1
        words.append(mesh.to(w, x0.device))
        state.append(mesh.to(s, x0.device))
    return torch.cat(words, dim=2), torch.cat(state, dim=1)
