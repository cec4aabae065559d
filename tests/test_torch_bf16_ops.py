"""The arithmetic the bf16 vpu K1 (``bf16x2_bits_kernel``,
``bf16x2_lattice_bits_kernel`` in ``csrc/chaotic_ann.cu``) rests on, on
the CPU.

The reference rounds each bf16 op as an f32 op on two bf16 values, rounded
once to bf16 (``ref.py``: PyTorch's eager bf16 ops; the JAX package the
same through XLA).  The kernels instead issue a correctly rounded bf16 add,
subtract or multiply.  The two agree when rounding twice, through f32's 24
bits to bf16's 8, is innocuous, which holds for +, - and x (24 >= 2*8 + 2):

* every bf16 pattern as the first operand, against structured second
  operands (zeros, subnormal ends, FLT_MIN, max, infinities, NaNs, values
  one ulp around ties) and a seeded sample: torch's bf16 result of the f32
  op, torch's own bf16 op and XLA's bf16 op each equal one correct rounding
  of the exact result (a product is exact in f64; a sum is rounded once in
  f64, which is innocuous too, 53 >= 2*8 + 2);
* ties to even and overflow to +-inf, built on purpose;
* relu on bf16 keeps -0 and NaN.

The card holds the native ops to the f32 round trip on all 2^32 operand
pairs (``chip_smoke.py``).  Two exact rewrites of the kernels' step are
checked here on a plain mirror of it: sums that start from their first term
with -0 biases taken as +0, and relu fused into the bias add; and the
packed fold that carries two lanes' words in three registers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

ALL = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
OPS = {"add": np.add, "sub": np.subtract, "mul": np.multiply}
TORCH_OPS = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
# structured second operands (bf16 bit patterns)
SPECIALS = [0x0000, 0x8000,                   # +-0
            0x0001, 0x007F, 0x8001, 0x807F,   # the subnormals' ends
            0x0080, 0x8080,                   # +-FLT_MIN
            0x7F7F, 0xFF7F,                   # +-max
            0x7F80, 0xFF80,                   # +-inf
            0x7FC0, 0xFFC0, 0x7F81]           # NaNs
# one ulp around values whose sums and products with other operands tie:
# 2^-8 (half an ulp of 1), 1, 1.5, 3 and their neighbours
ULPS = [v + d for v in (0x3B80, 0x3F80, 0x3FC0, 0x4040, 0x0040, 0x8040)
        for d in (-1, 0, 1)]


def _bf16_bits_to_f64(bits: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        return (bits.astype(np.uint32) << 16).view(np.float32).astype(
            np.float64)


def _exact(op, a_bits, b_bits) -> np.ndarray:
    """The op in f64 on two bf16 values (inf - inf and the like: NaN)."""
    with np.errstate(invalid="ignore"):
        return OPS[op](_bf16_bits_to_f64(a_bits), _bf16_bits_to_f64(b_bits))


def _round_to_bf16(v: np.ndarray) -> np.ndarray:
    """One correct rounding (to nearest, ties to even) of f64 values to
    bf16, subnormals and overflow included; NaN stays NaN.  Returns bit
    patterns."""
    with np.errstate(invalid="ignore", over="ignore"):
        a = np.abs(v)
        _, ex = np.frexp(a)                      # a = m * 2^ex, m in [.5, 1)
        # the quantum: 2^-7 of the leading bit, never below 2^-133
        q = np.ldexp(1.0, np.maximum(ex - 1, -126) - 7)
        r = np.rint(a / q) * q                   # exact; rint ties to even
        r = np.where(np.isfinite(a) & (r >= 2.0 ** 128), np.inf, r)
        r = np.where(np.isinf(a), np.inf, r)
        r = np.copysign(r, v)
        bits = (r.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    return np.where(np.isnan(v), np.uint16(0x7FC0), bits)


def _same(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Bitwise equal, any NaN equal to any NaN."""
    nan_g = (got & 0x7FFF) > 0x7F80
    nan_w = (want & 0x7FFF) > 0x7F80
    return np.where(nan_g | nan_w, nan_g & nan_w, got == want)


def _pairs(second):
    a = np.repeat(ALL, len(second))
    b = np.tile(np.asarray(second, np.uint32).astype(np.uint16), ALL.size)
    return a, b


def _torch_f32_op(op, a_bits, b_bits):
    """The reference's op: the f32 op on two bf16 values, rounded to bf16."""
    ta = torch.from_numpy(a_bits.view(np.int16)).view(torch.bfloat16)
    tb = torch.from_numpy(b_bits.view(np.int16)).view(torch.bfloat16)
    out = TORCH_OPS[op](ta.float(), tb.float()).to(torch.bfloat16)
    native = TORCH_OPS[op](ta, tb)
    return (out.view(torch.int16).numpy().view(np.uint16),
            native.view(torch.int16).numpy().view(np.uint16))


def _second_operands(group):
    if group == "specials":
        return SPECIALS
    if group == "ulps":
        return ULPS
    rng = np.random.default_rng(20)
    return rng.integers(0, 1 << 16, 48).tolist()


@pytest.mark.parametrize("group", ["specials", "ulps", "sample"])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_f32_op_rounded_to_bf16_is_one_correct_rounding(op, group):
    a, b = _pairs(_second_operands(group))
    want = _round_to_bf16(_exact(op, a, b))
    via_f32, native = _torch_f32_op(op, a, b)
    assert _same(via_f32, want).all(), op
    assert _same(native, want).all(), op


def _subnormal(bits: np.ndarray) -> np.ndarray:
    return ((bits & 0x7F80) == 0) & ((bits & 0x7F) != 0)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_xla_bf16_op_is_one_correct_rounding(op):
    """The JAX package's bf16 op on the CPU, wherever no operand is
    subnormal and the exact result is not below FLT_MIN (XLA's CPU code
    flushes those to zero; the port and the card keep them)."""
    a, b = _pairs(SPECIALS + ULPS)
    exact = _exact(op, a, b)
    want = _round_to_bf16(exact)
    ja = jnp.asarray(a.view(jnp.bfloat16))
    jb = jnp.asarray(b.view(jnp.bfloat16))
    got = np.asarray({"add": jnp.add, "sub": jnp.subtract,
                      "mul": jnp.multiply}[op](ja, jb)).view(np.uint16)
    with np.errstate(invalid="ignore"):
        tiny = (exact != 0) & (np.abs(exact) < 2.0 ** -126)
    normal = ~(_subnormal(a) | _subnormal(b) | tiny)
    assert normal.sum() > a.size // 2
    assert _same(got[normal], want[normal]).all(), op


def _ties(op):
    """Operand pairs whose exact result lies halfway between two bf16
    values: every a against values one ulp around the tie makers."""
    a, b = _pairs(ULPS + [0x3F81, 0x3F83, 0x4041, 0x3B81, 0x3B00, 0x3C00])
    exact = _exact(op, a, b)
    mag = np.abs(exact)
    _, ex = np.frexp(mag)
    q = np.ldexp(1.0, np.maximum(ex - 1, -126) - 7)
    with np.errstate(invalid="ignore"):
        tie = np.isfinite(mag) & (np.mod(mag / q, 1.0) == 0.5)
    return a[tie], b[tie]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_ties_round_to_even(op):
    a, b = _ties(op)
    assert a.size > 1000, f"too few {op} ties built: {a.size}"
    via_f32, native = _torch_f32_op(op, a, b)
    want = _round_to_bf16(_exact(op, a, b))
    assert (via_f32 == want).all() and (native == want).all()
    finite = (want & 0x7FFF) < 0x7F80
    assert (want[finite] & 1 == 0).all()         # the even neighbour


@pytest.mark.parametrize("op,a,b,want", [
    ("add", 0x7F7F, 0x7F7F, 0x7F80),     # max + max = +inf
    ("sub", 0xFF7F, 0x7F7F, 0xFF80),     # -max - max = -inf
    ("mul", 0x7F7F, 0x4000, 0x7F80),     # max * 2 = +inf
    ("mul", 0xFF7F, 0x4000, 0xFF80),     # -max * 2 = -inf
    ("add", 0x7F7F, 0x7B00, 0x7F80),     # max + half an ulp: tie to even, inf
    ("add", 0x7F7F, 0x7AFF, 0x7F7F),     # just under the tie: max
    ("mul", 0x0001, 0x3F00, 0x0000),     # min subnormal / 2: tie to even, +0
    ("mul", 0x8001, 0x3F00, 0x8000),     # -min subnormal / 2: -0
    ("sub", 0x3F80, 0x3F80, 0x0000),     # x - x = +0
    ("add", 0x8000, 0x8000, 0x8000),     # -0 + -0 = -0
])
def test_overflow_underflow_and_signed_zeros(op, a, b, want):
    a_bits = np.array([a], np.uint16)
    b_bits = np.array([b], np.uint16)
    exact = _exact(op, a_bits, b_bits)
    assert _round_to_bf16(exact)[0] == want
    via_f32, native = _torch_f32_op(op, a_bits, b_bits)
    assert via_f32[0] == want and native[0] == want


def test_relu_keeps_negative_zero_and_nan_on_bf16():
    x = torch.tensor([-0.0, float("nan"), -1.0, 1.0, 0.0, -1e-40],
                     dtype=torch.bfloat16)
    for y in (torch.relu(x), ref.relu(x)):
        bits = y.view(torch.int16).numpy().view(np.uint16)
        assert bits[0] == 0x8000                     # -0 stays -0
        assert (bits[1] & 0x7FFF) > 0x7F80           # NaN stays NaN
        assert list(bits[2:]) == [0x0000, 0x3F80, 0x0000, 0x0000]


def _mirror_step(x, w1, b1, w2, b2, activation, bias_fix=True):
    """The kernels' bf16x2 step (``step2``) in plain bf16 ops: each sum
    starts from its first term, -0 biases are +0 (``bias_fix=False``
    leaves them, which is not exact), and relu is fused into the bias add
    with a zero sum as +0 (``fma.rn.relu.bf16x2``)."""
    def pos_zero(b):
        if not bias_fix:
            return b
        return torch.where(b.view(torch.int16) == -32768,
                           torch.zeros_like(b), b)

    i_dim, h_dim = w1.shape
    h = w1[0] * x[:, 0:1]
    for i in range(1, i_dim):
        h = h + w1[i] * x[:, i:i + 1]
    v = h + pos_zero(b1)
    if activation == "relu":
        h = torch.where(v <= 0, torch.zeros_like(v), v)
    else:
        h = ref.ACTIVATIONS[activation](v)
    y = w2[0] * h[:, 0:1]
    for j in range(1, h_dim):
        y = y + w2[j] * h[:, j:j + 1]
    return y + pos_zero(b2)


def _adversarial(rng, shape, zero_share=0.4):
    """bf16 values, a share of them +0 or -0, some subnormal."""
    v = rng.normal(0, 1, shape).astype(np.float32)
    pick = rng.random(shape)
    v[pick < zero_share / 2] = 0.0
    v[(pick >= zero_share / 2) & (pick < zero_share)] = -0.0
    v[(pick >= zero_share) & (pick < zero_share + 0.05)] *= 1e-39
    return torch.from_numpy(v).to(torch.bfloat16)


@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", [(3, 8), (4, 16)])
def test_step_rewrite_is_the_reference_step_bitwise(activation, shape):
    """Zero weights, zero biases and zero states of both signs, with a
    hidden unit and a state component whose weights and bias are all -0 on
    half the lanes' nonnegative states, so that whole sums of -0 terms meet
    -0 biases: the mirror step equals ``ref.make_step`` bit for bit, sign
    of zero included, over 8 steps."""
    i_dim, h_dim = shape
    rng = np.random.default_rng([len(activation), i_dim, h_dim])
    for trial in range(4):
        w1 = _adversarial(rng, (i_dim, h_dim), 0.6)
        w2 = _adversarial(rng, (h_dim, i_dim), 0.6)
        b1 = _adversarial(rng, (h_dim,), 0.7)
        b2 = _adversarial(rng, (i_dim,), 0.7)
        x = _adversarial(rng, (2048, i_dim), 0.5)
        w1[:, 0], b1[0], w2[:, 0], b2[0] = -0.0, -0.0, -0.0, -0.0
        x[:1024] = x[:1024].abs()
        step = ref.make_step(w1, b1, w2, b2, dtype=torch.bfloat16,
                             activation=activation)
        for _ in range(8):
            want = step(x)
            got = _mirror_step(x, w1, b1, w2, b2, activation)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
            x = want


@pytest.mark.parametrize("n_terms", [1, 2, 3, 8])
def test_sum_from_first_term_with_positive_zero_bias(n_terms):
    """The lemma under ``step2``: ((+0 + t0) + t1 ...) + b is bitwise
    (t0 + t1 ...) + b', with b' = b except +0 for a -0 b, for terms and
    biases of every kind (both zeros, subnormals, normals, infinities,
    NaN); the sum with b itself differs where every term and b are -0."""
    rng = np.random.default_rng(n_terms)
    kinds = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x3F80, 0xBF80, 0x7F80,
                      0xFF80, 0x7FC0, 0x4123, 0xC123], np.uint16)
    rows = 20_000
    t = kinds[rng.integers(0, kinds.size, (rows, n_terms))]
    t[: rows // 4] = 0x8000                        # sums of -0 terms only
    b = kinds[rng.integers(0, kinds.size, rows)]
    t = torch.from_numpy(t.view(np.int16)).view(torch.bfloat16)
    b = torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
    ref_sum = torch.zeros(rows, dtype=torch.bfloat16)
    for k in range(n_terms):
        ref_sum = ref_sum + t[:, k]
    want = (ref_sum + b).view(torch.int16).numpy().view(np.uint16)
    s = t[:, 0]
    for k in range(1, n_terms):
        s = s + t[:, k]
    b_fixed = torch.where(b.view(torch.int16) == -32768, torch.zeros_like(b),
                          b)
    got = (s + b_fixed).view(torch.int16).numpy().view(np.uint16)
    naive = (s + b).view(torch.int16).numpy().view(np.uint16)
    assert _same(got, want).all()
    assert not _same(naive, want).all()


def _fold_parts(x, shift):
    """FoldShift of the kernels: a packed pair's term split into bits
    0-15 (lane a low, lane b high) and bits 16-21 (lane a in 0-5, lane b
    in 16-21)."""
    keep = 0x7F >> max(shift - 9, 0)
    keep2 = keep | keep << 16
    over_keep = 0x007F007F & ~keep2
    low = ((x & keep2) << shift) & 0xFFFFFFFF
    over = (x & over_keep) >> (16 - shift)
    return low, over


@pytest.mark.parametrize("i_dim", [3, 4, 24, 96])
def test_packed_fold_gives_each_lanes_word(i_dim):
    """Two lanes' folds carried in three registers (hi from the first
    step, lo and over from the second), then ``word_a``/``word_b``: the
    words of ``ops`` for each lane, for every shift 5*i % 16."""
    rng = np.random.default_rng(i_dim)
    n = 4096
    traj = torch.from_numpy(rng.integers(0, 1 << 16, (2, 2 * n, i_dim))
                            .astype(np.uint16).view(np.int16)).view(
                                torch.bfloat16)
    folded = ops._fold_low16(traj)
    want = ((folded[0] << 16) & 0xFFFFFFFF) | folded[1]
    bits = traj.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    pair = bits[:, :n] | bits[:, n:] << 16           # lane a low, b high
    hi = lo = over = np.zeros(n, np.int64)
    for i in range(i_dim):
        h_low, _ = _fold_parts(pair[0, :, i], 5 * i % 16)
        l_low, l_over = _fold_parts(pair[1, :, i], 5 * i % 16)
        hi, lo, over = hi ^ h_low, lo ^ l_low, over ^ l_over
    word_a = ((hi << 16) & 0xFFFFFFFF) | (lo & 0xFFFF) | ((over & 0x3F) << 16)
    word_b = (hi & 0xFFFF0000) | (lo >> 16) | (over & 0x3F0000)
    assert np.array_equal(word_a, want[:n].numpy())
    assert np.array_equal(word_b, want[n:].numpy())
