"""Wrappers of the hand-written CUDA oscillator kernels (``csrc/chaotic_ann.cu``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches on the current stream without
synchronising.  A tensor on the CPU takes the kernel's plain version in
``ref`` instead, and only because it lies on the CPU; a CUDA tensor
launches the kernel or raises.  ``<wrapper>.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, ops, ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_c_ptr, _c_int, _c_i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The ROADMAP.md item that ports what these kernels refuse.
TODO_UNPORTED = ("queue 2, 'K1/K2: mxu unit, non-relu activations, "
                 "lattice forms'")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library, with every C function's types declared."""
    lib = build.load()
    lib.chaotic_ann_bits_launch.argtypes = (
        [_c_int] * 4 + [_c_ptr] * 8 + [_c_i64, _c_i64, _c_ptr])
    lib.chaotic_ann_bits_launch.restype = _c_int
    lib.chaotic_ann_traj_launch.argtypes = (
        [_c_int] * 4 + [_c_ptr] * 6 + [_c_i64, _c_i64, _c_ptr])
    lib.chaotic_ann_traj_launch.restype = _c_int
    lib.chaotic_ann_error_string.argtypes = [_c_int]
    lib.chaotic_ann_error_string.restype = ctypes.c_char_p
    return lib


def _check_activation(activation: str) -> None:
    if activation != "relu":
        raise NotImplementedError(
            f"activation {activation!r}: the kernels are relu only; see "
            f"ROADMAP.md {TODO_UNPORTED} (backend='ref' runs any activation)")


def _operands(w1, b1, w2, b2, x0) -> Tuple[list, int]:
    """Validated kernel operands: weights cast to the state dtype."""
    if x0.device.type != "cuda":
        raise ValueError(f"x0 must be a CUDA tensor, got {x0.device}")
    if x0.dtype not in _DTYPE_CODES:
        raise ValueError(f"state dtype must be float32 or bfloat16, "
                         f"got {x0.dtype}")
    if x0.ndim != 2 or not x0.is_contiguous():
        raise ValueError(f"x0 must be a contiguous (S, I) tensor, got shape "
                         f"{tuple(x0.shape)} strides {x0.stride()}")
    i_dim, h_dim = w1.shape
    shapes = {"w1": (w1, (i_dim, h_dim)), "b1": (b1, (h_dim,)),
              "w2": (w2, (h_dim, i_dim)), "b2": (b2, (i_dim,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want or t.device != x0.device:
            raise ValueError(f"{name} must be {want} on {x0.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if x0.shape[1] != i_dim:
        raise ValueError(f"x0 has {x0.shape[1]} features, w1 expects {i_dim}")
    weights = [t.to(x0.dtype).contiguous() for t in (w1, b1, w2, b2)]
    return weights, _DTYPE_CODES[x0.dtype]


def _raise_on(lib, code: int, kernel: str, w1) -> None:
    if code == -1:
        raise ValueError(f"{kernel}: (I, H) = {tuple(w1.shape)} is not "
                         f"compiled into {build.SOURCE} (CHAOTIC_ANN_SHAPES)")
    if code:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.chaotic_ann_error_string(code).decode()}")


def chaotic_ann_bits(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, x0: torch.Tensor, word_offset=0, *,
                     n_steps: int, activation: str = "relu"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused oscillator + bit extraction: (n_steps // 2, S) uint32 words
    and the (S, I) final state.

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_bits_pallas`` (K1).
    Bound on the H100: operations.  Each word costs 2 steps of
    (4*I*H + H + I) separate f32 ops, 214 for a 3-8-3 net, against 4
    bytes written.  The design keeps the state and the hidden layer in
    registers for the whole launch, so the trajectory never reaches
    device memory and only the words, offsets and final state move.
    """
    _check_activation(activation)
    if n_steps < 2 or n_steps % 2:
        raise ValueError(f"n_steps must be even and >= 2, got {n_steps}")
    if x0.device.type == "cpu":
        return ref.chaotic_ann_bits_ref(w1, b1, w2, b2, x0, n_steps,
                                        word_offset, activation)
    weights, code = _operands(w1, b1, w2, b2, x0)
    n_lanes, n_rows = x0.shape[0], n_steps // 2
    offsets = ops.to_uint32(ops.word_offsets(word_offset, n_lanes, x0.device))
    words = torch.empty((n_rows, n_lanes), dtype=torch.uint32,
                        device=x0.device)
    state = torch.empty_like(x0)
    if n_lanes == 0:
        return words, state
    lib = _lib()
    rc = lib.chaotic_ann_bits_launch(
        x0.device.index, code, *w1.shape,
        *(t.data_ptr() for t in weights), x0.data_ptr(), offsets.data_ptr(),
        words.data_ptr(), state.data_ptr(), n_lanes, n_rows,
        torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_bits", w1)
    chaotic_ann_bits.launches += 1
    return words, state


chaotic_ann_bits.launches = 0


def chaotic_ann_traj(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, x0: torch.Tensor, *, n_steps: int,
                     activation: str = "relu") -> torch.Tensor:
    """The (n_steps, S, I) float trajectory after x0, in x0's dtype.

    Replaces ``repro/kernels/chaotic_ann.py::chaotic_ann_pallas`` (K2).
    Bound on the H100: bytes.  A step costs (4*I*H + H + I) ops per
    I*itemsize bytes written, 107 ops per 12 bytes for 3-8-3 in f32,
    below the card's 20 ops per byte (67 TFLOP/s over 3.35 TB/s).  Same
    design as ``chaotic_ann_bits``; each thread writes its I values per
    step, so a warp writes one contiguous run per step.
    """
    _check_activation(activation)
    if x0.device.type == "cpu":
        return ref.chaotic_ann_ref(w1, b1, w2, b2, x0, n_steps, activation)
    weights, code = _operands(w1, b1, w2, b2, x0)
    n_lanes = x0.shape[0]
    traj = torch.empty((n_steps,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    if n_lanes == 0 or n_steps == 0:
        return traj
    lib = _lib()
    rc = lib.chaotic_ann_traj_launch(
        x0.device.index, code, *w1.shape,
        *(t.data_ptr() for t in weights), x0.data_ptr(), traj.data_ptr(),
        n_lanes, n_steps, torch.cuda.current_stream(x0.device).cuda_stream)
    _raise_on(lib, rc, "chaotic_ann_traj", w1)
    chaotic_ann_traj.launches += 1
    return traj


chaotic_ann_traj.launches = 0
