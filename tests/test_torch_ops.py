"""The port's integer word stages against the JAX package's, bitwise.

Both sides pack the *same* trajectory (made by numpy from a seed, or by
the JAX kernel), so any difference is in the integer pipeline: the
low-mantissa fold, pair packing, Weyl offsets and Murmur3 finalizer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.prng.stream import default_params

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def same_trajectory(seed, shape, jdtype):
    """One trajectory on both sides: JAX rounds it to the dtype, torch
    takes the exact values (f32 holds every bf16 value)."""
    rng = np.random.default_rng(seed)
    traj = (rng.standard_normal(shape) * 3).astype(np.float32)
    j = jnp.asarray(traj).astype(jdtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("offset", ["zero", "scalar", "scalar_wrap",
                                    "per_lane"])
def test_pack_words_bitwise(dtype, jdtype, offset):
    j, t = same_trajectory(1, (24, 33, 3), jdtype)
    rng = np.random.default_rng(2)
    off = {"zero": 0, "scalar": 12345, "scalar_wrap": 0xFFFFFFFA,
           "per_lane": rng.integers(0, 1 << 32, 33, dtype=np.uint64)
           .astype(np.uint32)}[offset]
    if offset == "per_lane":
        off[:3] = [0xFFFFFFFF, 0xFFFFFFF5, 0]
    want = np.asarray(jops.pack_words(j, jnp.asarray(off, jnp.uint32)))
    got = ops.pack_words(t, torch.from_numpy(np.asarray(off, np.uint32))
                         if offset == "per_lane" else off)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_bits_and_uniform_from_trajectory_bitwise(dtype, jdtype):
    j, t = same_trajectory(3, (20, 7, 4), jdtype)
    np.testing.assert_array_equal(ops.bits_from_trajectory(t).numpy(),
                                  np.asarray(jops.bits_from_trajectory(j)))
    u = ops.uniform_from_trajectory(t).numpy()
    np.testing.assert_array_equal(
        u, np.asarray(jops.uniform_from_trajectory(j)))
    assert u.min() >= 0.0 and u.max() < 1.0


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_fold_bitwise(dtype, jdtype):
    j, t = same_trajectory(4, (9, 5, 4), jdtype)
    np.testing.assert_array_equal(ops._fold_low16(t).numpy(),
                                  np.asarray(jops._fold_low16(j)))


def test_finalize_bitwise_over_full_range():
    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    got = ops._finalize_words(torch.from_numpy(w.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(jops._finalize_words(jnp.asarray(w))))


def test_uint32_edges_round_trip():
    vals = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    u = ops.to_uint32(vals)
    assert u.dtype == torch.uint32
    assert torch.equal(ops.from_uint32(u), vals)
    off = ops.word_offsets(torch.tensor([2 ** 32 + 3, -1]), 2, "cpu")
    assert off.tolist() == [3, 2 ** 32 - 1]
    assert ops.word_offsets(7, 3, "cpu").tolist() == [7, 7, 7]


def test_ops_route_and_refuse_unported_forms():
    p = {k: torch.from_numpy(v) for k, v in default_params().items()}
    x0 = torch.zeros(8, 3).uniform_(-0.9, 0.9, generator=torch.Generator().manual_seed(0))
    w_auto, s_auto = ops.chaotic_bits(p, x0, 8, 9)
    w_ref, s_ref = ops.chaotic_bits(p, x0, 8, 9, backend="ref")
    assert torch.equal(ops.from_uint32(w_auto), ops.from_uint32(w_ref))
    assert torch.equal(s_auto, s_ref)
    assert torch.equal(ops.chaotic_trajectory(p, x0, 5),
                       ops.chaotic_trajectory(p, x0, 5, backend="ref"))
    # the mxu unit is routed too (lattices: tests/test_torch_mxu.py), to a
    # stream of its own; an unknown unit is refused
    w_mxu, s_mxu = ops.chaotic_bits(p, x0, 8, 9, compute_unit="mxu")
    w_mref, s_mref = ops.chaotic_bits(p, x0, 8, 9, compute_unit="mxu",
                                      backend="ref")
    assert torch.equal(ops.from_uint32(w_mxu), ops.from_uint32(w_mref))
    assert torch.equal(s_mxu, s_mref)
    assert not torch.equal(s_mxu, s_auto)
    with pytest.raises(ValueError, match="compute_unit"):
        ops.chaotic_trajectory(p, x0, 4, compute_unit="tpu")
    with pytest.raises(ValueError):
        ops.chaotic_bits(p, x0, 8, backend="pallas")
    # any activation on the plain version and on every kernel form (here
    # the scalar vpu and the mxu unit)
    assert torch.equal(
        ops.chaotic_trajectory(p, x0, 2, activation="tanh"),
        ops.chaotic_trajectory(p, x0, 2, activation="tanh", backend="ref"))
    assert torch.equal(
        ops.chaotic_trajectory(p, x0, 2, activation="tanh",
                               compute_unit="mxu"),
        ops.chaotic_trajectory(p, x0, 2, activation="tanh", backend="ref",
                               compute_unit="mxu"))
