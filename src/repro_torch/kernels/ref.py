"""Plain PyTorch versions of the oscillator kernels.

Unlike ``repro/kernels/ref.py`` (an ``x @ w`` formulation), these scan the
*kernel's* step of ``repro/kernels/chaotic_ann.py::_make_step``, for each
compute unit:

* vpu: the broadcast multiply-adds, every multiply and add a separate op
  in the state dtype, so bf16 rounds after every op, as the Pallas kernel
  does;
* mxu: each ``jnp.dot(..., preferred_element_type=f32)`` is a forward
  chain of f32 fused multiply-adds from +0 (``fma_f32``), rounded to the
  state dtype once, then the bias and coupling adds in the state dtype.

So the CUDA kernels of ``chaotic_ann.cu`` can be held to these versions
bitwise.

The activations are the formulas the JAX package's ``jnp.tanh`` and
``jax.nn.sigmoid`` compute (XLA's CPU code), written in basic ops, so the
CUDA kernels can repeat them op for op.  ``torch.tanh``/``torch.sigmoid``
are neither: ``torch.tanh`` differs from ``jnp.tanh`` on about half of the
f32 inputs.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from repro_torch.core.chaotic import _TOPOLOGY_CODES, _grid_shape
from repro_torch.kernels import ops


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a correctly rounded fused
    multiply-add of float32 values), elementwise with broadcasting.

    The product of two float32 values is exact in float64, but the f64 sum
    rounds, and rounding that again to float32 is wrong when the f64 sum
    lands on a float32 midpoint (a false tie).  So the sum is rounded to
    odd: an inexact f64 sum ``s`` (TwoSum error ``e != 0``) whose last bit
    is even moves to its odd neighbour on ``e``'s side.  With 53 >= 24 + 2
    bits, rounding that to float32 gives the float32 rounding of the exact
    value.  Inputs may be float32 or already float64 copies of float32
    values.
    """
    a, b, c = a.double(), b.double(), c.double()
    p = a * b                                   # exact
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)               # s + e == p + c exactly
    keep = (e == 0) | ((s.view(torch.int64) & 1) == 1) | torch.isinf(s)
    s = torch.where(keep, s, torch.nextafter(s, e * math.inf))
    return s.float()


# f32 ``jnp.tanh``: Eigen's rational approximation, x * P(x^2) / Q(x^2) on
# x clamped to +-TANH_CLAMP, both polynomials by Horner's rule with fused
# multiply-adds from the highest coefficient; x itself where |x| < 0.0004.
TANH_CLAMP = 7.99881172180175781
TANH_TINY = 0.0004
TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
          5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
          4.89352455891786e-03)
TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
          4.89352518554385e-03)
# f32 ``exp`` inside ``jax.nn.sigmoid`` = 1 / (1 + exp(-x)): the Cephes
# polynomial, x = fx * ln 2 + r with fx = floor(x * log2(e) + 1/2), ln 2 in
# two parts, Horner in r with fused multiply-adds, y * 2^fx exactly.
EXP_CLAMP = 88.3762626647949
EXP_LOG2E = 1.44269504088896341
EXP_LN2_HI, EXP_LN2_LO = -0.693359375, 2.12194440e-4
EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
         1.6666665459e-1, 5.0000001201e-1)
F32_MIN = 1.1754943508222875e-38          # FLT_MIN: results below flush to 0


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """Flush results below FLT_MIN in magnitude to +0, as XLA's CPU code
    does (its tanh never gets there)."""
    return torch.where(v.abs() < F32_MIN, torch.zeros_like(v), v)


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``jnp.tanh`` of f32 ``x``, bitwise."""
    xc = x.clamp(-TANH_CLAMP, TANH_CLAMP)
    x2 = xc * xc
    p = _f32(TANH_P[0], x)
    for k in TANH_P[1:]:
        p = fma_f32(x2, p, _f32(k, x))
    q = _f32(TANH_Q[0], x)
    for k in TANH_Q[1:]:
        q = fma_f32(x2, q, _f32(k, x))
    return torch.where(x.abs() < _f32(TANH_TINY, x), x, (xc * p) / q)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 exp of f32 ``x`` as XLA's CPU code computes it, bitwise.  The
    scaling by 2^fx is exact: a product in f64 with 2^fx built from its
    exponent bits, then flushed below FLT_MIN and rounded to f32 (exact
    for the normal results that remain)."""
    x = x.clamp(-EXP_CLAMP, EXP_CLAMP)
    fx = torch.floor(fma_f32(x, _f32(EXP_LOG2E, x), _f32(0.5, x)))
    r = fma_f32(fx, _f32(EXP_LN2_HI, x), x)
    r = fma_f32(fx, _f32(EXP_LN2_LO, x), r)
    y = _f32(EXP_P[0], x)
    for k in EXP_P[1:]:
        y = fma_f32(y, r, _f32(k, x))
    y = fma_f32(y, r * r, r) + 1
    two_fx = ((fx.to(torch.int64) + 1023) << 52).view(torch.float64)
    return _flush(y.double() * two_fx).float()


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """An f32 value rounded to bf16 and back (round to nearest even)."""
    return v.to(torch.bfloat16).float()


def tanh(x: torch.Tensor, f32_result: bool = False) -> torch.Tensor:
    """``jnp.tanh`` in x's dtype, bitwise: bf16 is the f32 tanh of the
    upcast value, rounded once.  ``f32_result`` returns a bf16 input's f32
    result unrounded (what the mxu step's second dot reads)."""
    if x.dtype == torch.bfloat16:
        y = tanh_f32(x.float())
        return y if f32_result else y.to(torch.bfloat16)
    return tanh_f32(x)


def sigmoid(x: torch.Tensor, f32_result: bool = False) -> torch.Tensor:
    """``jax.nn.sigmoid`` = 1 / (1 + exp(-x)) in x's dtype, bitwise, the
    quotient flushed below FLT_MIN.  bf16 rounds after every op:
    ``bf16(1 / bf16(1 + bf16(exp(-x))))``; ``f32_result`` leaves the last
    rounding out."""
    if x.dtype == torch.bfloat16:
        y = _flush(1 / _bf16(1 + _bf16(exp_f32(-x.float()))))
        return y if f32_result else y.to(torch.bfloat16)
    return _flush(1 / (1 + exp_f32(-x)))


def relu(x: torch.Tensor, f32_result: bool = False) -> torch.Tensor:
    """``jax.nn.relu``; exact in either dtype, so ``f32_result`` changes
    nothing."""
    return torch.relu(x)


ACTIVATIONS = {"relu": relu, "tanh": tanh, "sigmoid": sigmoid}


def check_lattice(lattice, i_dim: int) -> None:
    """The static descriptor ``(n_nodes, base_dim, topology, strength)``
    against the state dim."""
    n_nodes, base_dim, topology, _ = lattice
    if n_nodes * base_dim != i_dim:
        raise ValueError(f"lattice {n_nodes}x{base_dim} != i_dim {i_dim}")
    if topology not in _TOPOLOGY_CODES:
        raise ValueError(f"unknown lattice topology {topology!r}")


def lattice_delta(x: torch.Tensor, lattice) -> torch.Tensor:
    """Plain ``_lattice_delta``: the diffusive coupling increment
    ``(sum_neighbours x - deg * x) * strength`` of (S, I) states, node n
    holding components ``n*base_dim ... (n+1)*base_dim - 1``.

    The JAX expression tree, op for op in the state dtype: a ring adds
    ``prev + nxt``; a P x Q torus adds ``(prev_row + nxt_row) + (prev_col
    + nxt_col)``; then ``(acc - deg * x) * eps`` with ``eps`` the strength
    in the state dtype.  A ring of 2 adds its one neighbour twice, a ring
    of 1 adds x itself twice, as the wrapped rolls do.
    """
    n_nodes, base_dim, topology, strength = lattice
    s_lanes = x.shape[0]
    if topology == "ring":
        nodes = x.reshape(s_lanes, n_nodes, base_dim)
        acc = torch.roll(nodes, 1, dims=1) + torch.roll(nodes, -1, dims=1)
        deg = 2
    else:
        pp, qq = _grid_shape(n_nodes)
        nodes = x.reshape(s_lanes, pp, qq, base_dim)
        acc = ((torch.roll(nodes, 1, dims=1) + torch.roll(nodes, -1, dims=1))
               + (torch.roll(nodes, 1, dims=2)
                  + torch.roll(nodes, -1, dims=2)))
        deg = 4
    eps = torch.tensor(strength, dtype=torch.float32,
                       device=x.device).to(x.dtype)
    return (acc.reshape(x.shape) - deg * x) * eps


def mxu_dot(x: torch.Tensor, w: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``jnp.dot`` with f32 accumulation as the mxu unit computes it: for
    (S, K) ``x`` and (K, N) ``w``, each output is the forward chain
    ``acc = fma(x[k], w[k, n], acc)`` over k = 0 .. K-1 from +0 in f32,
    rounded to ``dtype`` at the end.  A product of two bf16 values is
    exact in f32, so there a separate multiply and add is that fused op;
    an f32 ``x`` (a bf16 step's activation, read unrounded) takes the
    fused chain.  Dense over K: zero weights are terms of the chain like
    any other.
    """
    acc = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    if torch.float32 in (x.dtype, w.dtype):
        xd, wd = x.double(), w.double()
        for k in range(w.shape[-2]):
            acc = fma_f32(xd[:, k:k + 1], wd[k], acc)
    else:
        xf, wf = x.float(), w.float()
        for k in range(w.shape[-2]):
            acc = acc + xf[:, k:k + 1] * wf[k]
    return acc.to(dtype)


def make_step(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, *, dtype: torch.dtype,
              activation: str = "relu", lattice=None,
              compute_unit: str = "vpu", coupling=None
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """One oscillator step on (S, I) states.

    vpu: ``h`` accumulates ``w1[i] * x[:, i]`` over ``i`` from zeros, then
    ``phi(h + b1)``; ``y`` accumulates ``w2[j] * h[:, j]`` over ``j`` from
    zeros, then ``+ b2``.  Weights are cast to ``dtype`` once, here.  They
    are one net's (``w1`` (I, H)) or one net per lane (``w1`` (S, I, H),
    ``b1`` (S, H), ...): every lane then runs exactly the ops it would run
    alone.  ``lattice`` (the static descriptor) adds the coupling of the
    step's input, ``y + lattice_delta(x)``, after ``+ b2``; the loops stay
    dense over the lattice-expanded weights.

    mxu (one net's weights): ``h = phi(dot(x, w1) + b1)``, ``y = dot(h,
    w2) + b2``, and for a lattice ``y + dot(x, coupling^T)`` with the dense
    (I, I) ``coupling`` operand cast to ``dtype``; each ``dot`` is
    ``mxu_dot``, each add one op in ``dtype``.
    """
    phi = ACTIVATIONS[activation]
    w1, b1, w2, b2 = (t.to(dtype) for t in (w1, b1, w2, b2))
    i_dim, h_dim = w1.shape[-2:]
    if lattice is not None:
        check_lattice(lattice, i_dim)
    if compute_unit == "mxu":
        cpl_t = None
        if lattice is not None:
            if coupling is None:
                raise ValueError("mxu lattice steps need the dense coupling "
                                 "operand")
            if tuple(coupling.shape) != (i_dim, i_dim):
                raise ValueError(f"coupling shape {tuple(coupling.shape)} "
                                 f"!= ({i_dim}, {i_dim})")
            cpl_t = coupling.to(dtype).t()

        def mxu_step(x: torch.Tensor) -> torch.Tensor:
            h = phi(mxu_dot(x, w1, dtype) + b1, f32_result=True)
            y = mxu_dot(h, w2, dtype) + b2
            if cpl_t is not None:
                y = y + mxu_dot(x, cpl_t, dtype)
            return y

        return mxu_step
    if compute_unit != "vpu":
        raise ValueError(f"compute_unit must be 'vpu' or 'mxu', got "
                         f"{compute_unit!r}")

    def step(x: torch.Tensor) -> torch.Tensor:
        h = torch.zeros((x.shape[0], h_dim), dtype=dtype, device=x.device)
        for i in range(i_dim):
            h = h + w1[..., i, :] * x[:, i:i + 1]
        h = phi(h + b1)
        y = torch.zeros_like(x)
        for j in range(h_dim):
            y = y + w2[..., j, :] * h[:, j:j + 1]
        y = y + b2
        if lattice is not None:
            y = y + lattice_delta(x, lattice)
        return y

    return step


def chaotic_ann_ref(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, x0: torch.Tensor, n_steps: int,
                    activation: str = "relu", lattice=None,
                    compute_unit: str = "vpu", coupling=None
                    ) -> torch.Tensor:
    """Plain K2: the (n_steps, S, I) trajectory after x0, in x0's dtype
    (with ``lattice``: the lattice form of K2; ``compute_unit="mxu"``
    the mxu unit's, with the ``coupling`` operand for a lattice)."""
    step = make_step(w1, b1, w2, b2, dtype=x0.dtype, activation=activation,
                     lattice=lattice, compute_unit=compute_unit,
                     coupling=coupling)
    traj = torch.empty((n_steps,) + tuple(x0.shape), dtype=x0.dtype,
                       device=x0.device)
    x = x0
    for t in range(n_steps):
        x = step(x)
        traj[t] = x
    return traj


def chaotic_ann_bits_ref(w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         x0: torch.Tensor, n_steps: int, word_offset=0,
                         activation: str = "relu", lattice=None,
                         compute_unit: str = "vpu", coupling=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: the step scan, then ``ops.pack_words``.

    Returns (n_steps // 2, S) uint32 words and the (S, I) final state.
    """
    if n_steps < 2 or n_steps % 2:
        raise ValueError(f"n_steps must be even and >= 2, got {n_steps}")
    traj = chaotic_ann_ref(w1, b1, w2, b2, x0, n_steps, activation, lattice,
                           compute_unit, coupling)
    return ops.pack_words(traj, word_offset), traj[-1].clone()


def _gang_scan(w1, b1, w2, b2, x0: torch.Tensor, lane_core: torch.Tensor,
               lane_rows: torch.Tensor, n_steps: int, offsets: torch.Tensor,
               activation: str, lattice=None, compute_unit: str = "vpu",
               coupling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain gang scan over (N, I) lanes: lane ``l`` runs net
    ``lane_core[l]`` of the stacked weights for ``lane_rows[l]`` word rows
    and then holds its state (``torch.where``).  ``lattice`` (the static
    descriptor shared by every core) adds each core's coupling of its own
    lanes; on the mxu unit through the one (I, I) ``coupling`` operand
    every core shares.  ``offsets`` are (N,) int64.

    It loops over the cores present and steps each core's lanes with that
    core's ``make_step``, never a net gathered per lane: at chen@ring32 a
    gathered ``w1`` is a (96, 256) matrix for every lane, 6.4 GB at 65,536
    lanes.  Every lane still runs exactly the ops it would run alone, so
    the result is bitwise that of one launch per core.

    Returns (n_steps // 2, N) uint32 words, zero past each lane's rows,
    and the (N, I) state after each lane's own rows.
    """
    if n_steps < 2 or n_steps % 2:
        raise ValueError(f"n_steps must be even and >= 2, got {n_steps}")
    n_rows = n_steps // 2
    words = torch.zeros((n_rows, x0.shape[0]), dtype=torch.int64,
                        device=x0.device)
    state = x0.clone()
    for c in torch.unique(lane_core).tolist():
        idx = torch.nonzero(lane_core == c).squeeze(1)
        rows = lane_rows[idx]
        r_max = int(rows.max())
        if r_max == 0:
            continue
        step = make_step(w1[c], b1[c], w2[c], b2[c], dtype=x0.dtype,
                         activation=activation, lattice=lattice,
                         compute_unit=compute_unit, coupling=coupling)
        ragged = bool((rows < r_max).any())
        x = x0[idx]
        traj = torch.empty((2 * r_max,) + tuple(x.shape), dtype=x0.dtype,
                           device=x0.device)
        for r in range(r_max):
            x1 = step(x)
            x2 = step(x1)
            traj[2 * r], traj[2 * r + 1] = x1, x2
            x = torch.where((r < rows)[:, None], x2, x) if ragged else x2
        w = ops._packed(traj, offsets[idx])
        if ragged:
            live = torch.arange(r_max, device=x0.device)[:, None] < rows
            w = torch.where(live, w, 0)
        words[:r_max, idx] = w
        state[idx] = x
    return ops.to_uint32(words), state


def _rows(row_map, n: int, n_steps: int, device) -> torch.Tensor:
    """(n,) int64 rows: ``row_map`` clamped to n_steps // 2, or all rows."""
    full = torch.full((n,), n_steps // 2, dtype=torch.int64, device=device)
    if row_map is None:
        return full
    return torch.minimum(
        torch.as_tensor(row_map, dtype=torch.int64, device=device), full)


def chaotic_ann_gang_bits_ref(w1: torch.Tensor, b1: torch.Tensor,
                              w2: torch.Tensor, b2: torch.Tensor,
                              x0: torch.Tensor, core_map, n_steps: int,
                              word_offset=0, row_map=None,
                              activation: str = "relu", lattice=None,
                              compute_unit: str = "vpu", coupling=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3, the lane-concat gang: stacked weights ``w1`` (C, I, H),
    ``b1`` (C, H), ``w2`` (C, H, I), ``b2`` (C, I); ``x0`` (S, I) split
    into ``len(core_map)`` equal lane blocks, block ``g`` running net
    ``core_map[g]``.  ``lattice`` (one descriptor for every core) takes
    K3's lattice form: each core's lanes coupled among their own nodes.
    ``compute_unit="mxu"`` takes K3's mxu form, each core's step that of
    the mxu K1 (``make_step``), a lattice group with its one dense
    ``coupling`` operand, un-stacked.

    ``row_map`` (n_blocks,) is the word rows each block computes,
    *exactly* (values past ``n_steps // 2`` are clamped): the kernel's
    contract.  The public wrapper ``chaotic_ann.chaotic_ann_gang_bits``
    turns demands into these rows first (``gang_effective_rows``).
    None = every block computes every row.  Returns (n_steps // 2, S)
    uint32 words, zero past a block's rows, and the (S, I) state.
    """
    n_blocks, n_lanes = len(core_map), x0.shape[0]
    if n_blocks == 0 or n_lanes % n_blocks:
        raise ValueError(f"{n_lanes} lanes do not split into "
                         f"{n_blocks} equal lane blocks")
    s_block = n_lanes // n_blocks
    dev = x0.device
    cmap = torch.as_tensor(core_map, dtype=torch.int64, device=dev)
    rows = _rows(row_map, n_blocks, n_steps, dev)
    return _gang_scan(w1, b1, w2, b2, x0, cmap.repeat_interleave(s_block),
                      rows.repeat_interleave(s_block), n_steps,
                      ops.word_offsets(word_offset, n_lanes, dev),
                      activation, lattice, compute_unit, coupling)


def chaotic_ann_gang_stacked_ref(w1: torch.Tensor, b1: torch.Tensor,
                                 w2: torch.Tensor, b2: torch.Tensor,
                                 x0: torch.Tensor, n_steps: int,
                                 word_offset=0, row_map=None,
                                 activation: str = "relu", lattice=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4, C equal pools: stacked weights as in K3, ``x0`` (C, S, I),
    ``word_offset`` a scalar or (C, S).  ``row_map`` (C,) freezes core
    ``c`` after exactly ``min(row_map[c], n_steps // 2)`` rows;
    ``lattice`` as in K3.  Returns (n_steps // 2, C, S) uint32 words, zero
    past a core's rows, and the (C, S, I) state.
    """
    n_cores, n_lanes, i_dim = x0.shape
    dev = x0.device
    rows = _rows(row_map, n_cores, n_steps, dev)
    cores = torch.arange(n_cores, device=dev)
    off = ops.word_offsets(word_offset, (n_cores, n_lanes), dev)
    words, state = _gang_scan(
        w1, b1, w2, b2, x0.reshape(n_cores * n_lanes, i_dim),
        cores.repeat_interleave(n_lanes), rows.repeat_interleave(n_lanes),
        n_steps, off.reshape(-1), activation, lattice)
    return (words.reshape(n_steps // 2, n_cores, n_lanes),
            state.reshape(n_cores, n_lanes, i_dim))
