"""The kernels' f32 exp, as ``exp_f32`` in
``src/repro_torch/kernels/csrc/chaotic_ann.cu`` computes it, in a numpy
mirror: fx = floor(x * log2(e) + 1/2), and the scaling by 2^fx as an add
to y's bits in int32: fx + 1.5 * 2^23 holds fx in its low bits, and those
bits shifted left by 23 are fx on the exponent field, mod 2^32 (a sum
below 2^23 as a signed integer, a field <= 0, flushes to +0; a field of
255 overflows to +inf; a NaN y stays).  No f64 and no conversion.

The mirror is held bitwise to the plain version (``ref.exp_f32``, which
scales by an f64 product) on 2**22 seeded f32 bit patterns, a dense sweep
of [-89, 89], the clamp's edges, every f32 input whose result crosses
FLT_MIN, and +-0, +-inf, NaN and denormals; its sigmoid, 1 / (1 + exp(-x))
with an IEEE quotient flushed below FLT_MIN, to ``jax.nn.sigmoid`` in f32
on the CPU.  On the card ``chip_smoke.py`` holds the kernels' exp to the
f64 form on all 2**32 inputs; here the mirror shows why the design holds.
A NaN counts equal to any NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

F32 = np.float32
ROUND = F32(1.5 * 2 ** 23)          # fx + ROUND: fx in its low bits
CHUNK = 1 << 20


def fma32(a, b, c):
    """a * b + c rounded once to f32: the exact f64 product, its sum with
    c rounded to odd (TwoSum's error moves an inexact even sum to its odd
    neighbour), then to f32, which is the f32 rounding of the exact value
    (53 >= 24 + 2 bits)."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    with np.errstate(invalid="ignore", over="ignore"):
        s = p + c
        bb = s - p
        e = (p - (s - bb)) + (c - bb)
        keep = (e == 0) | ((s.view(np.int64) & 1) == 1) | np.isinf(s)
        s = np.where(keep, s, np.nextafter(s, np.copysign(np.inf, e)))
    return s.astype(F32)


def exp_bits(x):
    """f32 exp of f32 ``x`` as the kernels compute it, with the y and fx
    of each result (for the check of the exponent field)."""
    x = np.asarray(x, F32)
    lo, hi = F32(-ref.EXP_CLAMP), F32(ref.EXP_CLAMP)
    x = np.where(x < lo, lo, np.where(x > hi, hi, x))   # NaN kept
    with np.errstate(invalid="ignore", over="ignore"):
        fx = np.floor(fma32(x, F32(ref.EXP_LOG2E), F32(0.5)))
        k = (fx + ROUND).view(np.uint32).astype(np.int64)
        r = fma32(fx, F32(ref.EXP_LN2_HI), x)
        r = fma32(fx, F32(ref.EXP_LN2_LO), r)
        y = np.full_like(x, F32(ref.EXP_P[0]))
        for c in ref.EXP_P[1:]:
            y = fma32(y, r, F32(c))
        y = fma32(y, r * r, r) + F32(1)
    v = ((y.view(np.uint32).astype(np.int64) + (k << 23)) & 0xFFFFFFFF
         ).astype(np.uint32).view(np.int32)
    v = np.where(v < 0x00800000, 0, np.minimum(v, 0x7F800000))
    return np.where(np.isnan(y), y, v.astype(np.int32).view(F32)), y, fx


def sigmoid_bits(x):
    """1 / (1 + exp(-x)) in f32, the quotient IEEE and flushed below
    FLT_MIN, with the mirror's exp."""
    with np.errstate(over="ignore"):
        q = F32(1) / (F32(1) + exp_bits(-np.asarray(x, F32))[0])
    return np.where(np.abs(q) < F32(ref.F32_MIN), F32(0), q)


def assert_bitwise(got, want):
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bad = np.flatnonzero(got[~nan].view(np.int32) != want[~nan].view(np.int32))
    assert bad.size == 0, (
        f"{bad.size} of {want.size} differ, e.g. x index {bad[:4]}: "
        f"{got[~nan][bad[:4]]} vs {want[~nan][bad[:4]]}")


def span(a, b):
    """Every f32 value from a to b (a <= b, same sign)."""
    ia, ib = sorted((int(F32(a).view(np.int32)), int(F32(b).view(np.int32))))
    return np.arange(ia, ib + 1, dtype=np.int32).view(F32)


def inputs(kind):
    """The exp's input sets."""
    if kind == "random_bits":
        rng = np.random.default_rng(28)
        return rng.integers(0, 1 << 32, 1 << 22, dtype=np.uint64).astype(
            np.uint32).view(F32)
    if kind == "sweep":
        return np.linspace(-89.0, 89.0, 1 << 20).astype(F32)
    if kind == "clamp_edges":
        c = F32(ref.EXP_CLAMP)
        return np.concatenate([span(F32(c) - F32(0.001), c + F32(0.001)),
                               -span(F32(c) - F32(0.001), c + F32(0.001))])
    if kind == "flush_boundary":
        # exp(x) = FLT_MIN at x = ln(FLT_MIN) = -87.3365: every f32 around
        return span(-87.35, -87.32)
    assert kind == "specials"
    tiny = np.array([1, 2, 0x3FF, 0x7FFFF, 0x7FFFFF], np.int32).view(F32)
    return np.concatenate([
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan], F32),
        np.array([0xFFC00000, 0x7F800001], np.uint32).view(F32),
        tiny, -tiny])


@pytest.mark.parametrize("kind", ["random_bits", "sweep", "clamp_edges",
                                  "flush_boundary", "specials"])
def test_exp_mirror_bitwise_vs_plain(kind):
    """The mirror's exp (the exponent add in int32) equals
    ``ref.exp_f32`` (the f64 scaling) bit for bit."""
    x = inputs(kind)
    for i in range(0, x.size, CHUNK):
        xc = x[i:i + CHUNK]
        want = ref.exp_f32(torch.from_numpy(xc.copy())).numpy()
        assert_bitwise(exp_bits(xc)[0], want)


def test_exp_mirror_scales_y_in_half_to_two():
    """The design's premise: on every finite input y lies in [0.5, 2),
    its biased exponent 126 or 127, so adding fx to the field is the
    exact product wherever the field stays in 1..254; no input reaches a
    field of 255 (the +inf branch is kept for safety only); the flush
    boundary's inputs reach a field <= 0 and give +0."""
    x = np.concatenate([inputs("sweep"), inputs("random_bits")[:CHUNK],
                        inputs("clamp_edges")])
    x = x[np.isfinite(x)]
    _, y, fx = exp_bits(x)
    field = y.view(np.int32) >> 23 & 0xFF
    assert set(np.unique(field)) <= {126, 127}
    assert (field + fx).max() <= 254
    out, _, _ = exp_bits(inputs("flush_boundary"))
    assert (out == 0).any() and (out >= F32(ref.F32_MIN)).any()
    assert not ((out > 0) & (out < F32(ref.F32_MIN))).any()


def test_sigmoid_mirror_bitwise_vs_jax():
    """1 / (1 + exp(-x)) with the mirror's exp and an IEEE quotient,
    flushed, equals ``jax.nn.sigmoid`` in f32 on the CPU on 2**20 inputs:
    half a sweep of [-89, 89], half seeded bit patterns, and the edges."""
    n = 1 << 19
    x = np.concatenate([inputs("sweep")[::2], inputs("random_bits")[:n],
                        inputs("clamp_edges"), inputs("flush_boundary"),
                        inputs("specials")])
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    assert want.dtype == np.float32
    assert_bitwise(sigmoid_bits(x), want)
