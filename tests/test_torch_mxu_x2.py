"""The two-lane mxu K1 (``mxu_x2_bits_kernel``, ``bf16x2_mxu_bits_kernel``
in ``csrc/chaotic_ann.cu``) mirrored on the CPU.

The kernels run two lanes a thread: a CTA of 128 threads holds 128 / N
lane slots of N node threads, slot s lanes s and s + 128 / N of the CTA's
range, a half whose lane does not exist mirroring a live lane.  In bf16 a
component is one register holding both lanes, each chain's f32 pair is
rounded by one ``cvt.rn.bf16x2.f32``, the bias and coupling adds are
``add.rn.bf16x2`` with relu fused into the hidden one, and both lanes'
folds travel in three registers reduced over the slot's nodes.  Here:

* ``pack_bf2``, the round to nearest even that ``cvt.rn.bf16x2.f32``
  performs, on bit patterns, against torch's f32 -> bf16;
* the launcher's lane-pair map: every lane computed and written by exactly
  one live half, every shuffle inside its slot;
* a plain mirror of the kernels' step and row loop, in their op order,
  bitwise ``ref``'s plain mxu step and K1 at every ``MXU_SHAPES`` entry,
  relu / tanh / sigmoid, f32 and bf16, and bitwise the JAX mxu K1 in
  interpret mode at 3-8 and chen@ring8.

The card holds the native ops themselves to the f32 round trip on all
their inputs, and the kernels to the plain version (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chaotic_ann import chaotic_ann_bits_pallas
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.chaotic import _grid_shape
from repro_torch.kernels import ops, ref
from repro_torch.prng.stream import default_params

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
M32 = 0xFFFFFFFF
ONE2 = 0x3F803F80                         # (1.0, 1.0) in bf16
# MXU_SHAPES of chaotic_ann.cu, as the registry systems that have them
SHAPES = {"3-8": "chen", "4-16": "hyperlorenz", "ring8": "chen@ring8",
          "grid8": "chen@grid8", "ring32": "chen@ring32",
          "grid32": "chen@grid32"}
# odd lane counts that leave a CTA partly live, and K1 steps (the plain
# f32 chains of a lattice are hundreds of small ops a step)
LANES = {1: 261, 8: 37, 32: 13}
STEPS = {1: 8, 8: 4, 32: 2}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the f32 FMA chains are many small tensor ops,
    which more threads only slow down when test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The bit-level primitives
# ---------------------------------------------------------------------------

def f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & M32


def bits_f32(u: torch.Tensor) -> torch.Tensor:
    u = u & M32
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(
        torch.float32)


def rne_bf16(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rn`` of f32 values to bf16 bit patterns: add 0x7FFF plus the
    kept part's last bit and cut the low 16 bits (ties to even, overflow
    to inf, subnormals alike); a NaN gives the canonical 0x7FFF."""
    u = f32_bits(x)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF
    return torch.where(torch.isnan(x), torch.full_like(u, 0x7FFF), r)


def pack_bf2(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``cvt.rn.bf16x2.f32``: both values rounded, lo in the low half."""
    return rne_bf16(lo) | rne_bf16(hi) << 16


def lo_f32(v: torch.Tensor) -> torch.Tensor:
    return bits_f32(v << 16)


def hi_f32(v: torch.Tensor) -> torch.Tensor:
    return bits_f32(v & 0xFFFF0000)


def pair16(v: torch.Tensor) -> torch.Tensor:
    return v | v << 16


def bf2_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``add.rn.bf16x2``: each half's sum rounded once to bf16 (the f32
    sum of two bf16 values rounded again: innocuous, held on the card)."""
    return pack_bf2(lo_f32(a) + lo_f32(b), hi_f32(a) + hi_f32(b))


def bf2_add_relu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fma.rn.relu.bf16x2(a, 1, b)``: the rounded sum, +0 where it is
    <= 0 (either zero), NaN kept."""
    def relu_half(h):
        nan = (h & 0x7FFF) > 0x7F80
        neg_or_zero = ((h & 0x8000) != 0) | (h == 0)
        return torch.where(nan | ~neg_or_zero, h, torch.zeros_like(h))
    s = bf2_add(a, b)
    return relu_half(s & 0xFFFF) | relu_half(s >> 16) << 16


def relu_mxu(v: torch.Tensor) -> torch.Tensor:
    """``max.NaN.f32(v, +0)``: +0 for either zero, NaN kept."""
    return torch.where(torch.isnan(v) | (v > 0), v, torch.zeros_like(v))


# ---------------------------------------------------------------------------
# cvt.rn.bf16x2.f32 on bit patterns against torch
# ---------------------------------------------------------------------------

def _specials() -> np.ndarray:
    ties = [(hi << 16) | 0x8000 for hi in (0x3F80, 0x3F81, 0x0000, 0x0001,
                                           0x7F7E, 0x8001, 0xBF81)]
    near = [t + d for t in ties for d in (-1, 1)]
    return np.array(ties + near + [
        0x00000000, 0x80000000,                   # +-0
        0x00000001, 0x007FFFFF, 0x80000001, 0x807FFFFF,   # subnormal ends
        0x00008000, 0x0000FFFF, 0x007F8000,       # subnormals that round
        0x00800000, 0x80800000,                   # +-FLT_MIN
        0x7F7FFFFF, 0xFF7FFFFF,                   # +-FLT_MAX: round to inf
        0x7F7F7FFF, 0x7F7F8000, 0x7F7E8000,       # below / at the overflow tie
        0x7F800000, 0xFF800000,                   # +-inf
        0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF],  # NaNs
        dtype=np.int64)


def test_cvt_rn_mirror_equals_torch_rounding():
    """The mirror of ``cvt.rn.bf16x2.f32`` (``pack_bf2``) against torch's
    f32 -> bf16 on ties (to even), +-0, subnormals, FLT_MAX's overflow
    edge, +-inf, NaN (any NaN equal) and a seeded 2^20 sample, both
    halves."""
    rng = np.random.default_rng(23)
    u = np.concatenate([_specials(),
                        rng.integers(0, 1 << 32, 1 << 20, dtype=np.int64)])
    x = bits_f32(torch.from_numpy(u))
    want = x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    x_hi = x.flip(0)
    want_hi = want.flip(0)
    got = pack_bf2(x, x_hi)
    for half, w in ((got & 0xFFFF, want), (got >> 16, want_hi)):
        nan_g, nan_w = (half & 0x7FFF) > 0x7F80, (w & 0x7FFF) > 0x7F80
        assert torch.equal(nan_g, nan_w)
        assert torch.equal(half[~nan_g], w[~nan_w])
    # the edges behave as named: a tie to even, FLT_MAX to inf
    assert int(rne_bf16(bits_f32(torch.tensor([0x3F808000])))) == 0x3F80
    assert int(rne_bf16(bits_f32(torch.tensor([0x3F818000])))) == 0x3F82
    assert int(rne_bf16(bits_f32(torch.tensor([0x7F7FFFFF])))) == 0x7F80


def test_relu_zero_sign_does_not_reach_the_second_chain():
    """The kernels' relu gives +0 where ``torch.relu`` keeps -0.  The
    hidden value feeds only the second chain, an f32 FMA chain from +0:
    a +-0 term leaves any accumulator but -0 as it is, and from +0 a
    chain's accumulator is -0 only after a product underflows to -0."""
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(np.concatenate([
        rng.normal(0, 3, 4096), [0.0, 1e-45, -1e-45, 3.4e38, -3.4e38]])
        .astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, acc.shape).astype(np.float32))
    w[:16] = torch.tensor([0.0, -0.0] * 8)
    plus = ref.fma_f32(torch.zeros_like(acc), w, acc)
    minus = ref.fma_f32(torch.full_like(acc, -0.0), w, acc)
    assert torch.equal(f32_bits(plus), f32_bits(minus))
    assert torch.equal(f32_bits(plus), f32_bits(acc))
    # and the relu itself: -0 in, +0 out; NaN kept
    v = torch.tensor([-0.0, 0.0, -1.0, 2.0, float("nan")])
    assert f32_bits(relu_mxu(v)).tolist()[:4] == [0, 0, 0, 0x40000000]
    assert torch.isnan(relu_mxu(v)[4])
    assert int(f32_bits(torch.relu(v))[0]) == 0x80000000


# ---------------------------------------------------------------------------
# The launcher's lane-pair map (launch_mxu_bits, LanePair)
# ---------------------------------------------------------------------------

def lane_pairs(n_lanes: int, n_nodes: int) -> dict:
    """Every thread of the launch: its CTA, thread index, node and lane
    pair, as ``launch_mxu_bits``'s grid and ``LanePair`` compute them."""
    slots = CTA // n_nodes
    cta_lanes = 2 * slots
    grid = (n_lanes + cta_lanes - 1) // cta_lanes
    t = np.arange(grid * CTA)
    cta, tid = t // CTA, t % CTA
    lane_a = cta * cta_lanes + tid // n_nodes
    lane_b = lane_a + slots
    live_a, live_b = lane_a < n_lanes, lane_b < n_lanes
    lane_a = np.where(live_a, lane_a, n_lanes - 1)
    lane_b = np.where(live_b, lane_b, lane_a)
    return dict(cta=cta, tid=tid, node=tid % n_nodes, lane_a=lane_a,
                lane_b=lane_b, live_a=live_a, live_b=live_b,
                slot=cta * slots + tid // n_nodes)


@pytest.mark.parametrize("n_nodes", [1, 8, 32])
@pytest.mark.parametrize("n_lanes", [1, 2, 3, 5, 129, 257, 8229])
def test_lane_pair_map_covers_every_lane_once(n_lanes, n_nodes):
    m = lane_pairs(n_lanes, n_nodes)
    node, slot = m["node"], m["slot"]
    # computed: each lane is the live half of exactly one slot
    computed = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                               m["lane_b"][m["live_b"] & (node == 0)]])
    assert np.array_equal(np.sort(computed), np.arange(n_lanes))
    # written: node 0 writes lane a's words, node 1 lane b's (node 0
    # both at one node); the state by every node of a live half
    writer_b = 1 if n_nodes > 1 else 0
    written = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                              m["lane_b"][m["live_b"] & (node == writer_b)]])
    assert np.array_equal(np.sort(written), np.arange(n_lanes))
    comps = np.concatenate([m[f"lane_{h}"][m[f"live_{h}"]] * n_nodes
                            + node[m[f"live_{h}"]] for h in ("a", "b")])
    assert np.array_equal(np.sort(comps), np.arange(n_lanes * n_nodes))
    # shuffles: a slot is n_nodes consecutive threads of one warp, the
    # width-n_nodes shuffle of thread t reads (t & ~(N-1)) + src, which is
    # a thread of t's slot; all of a slot's threads hold the same lanes
    tid = m["tid"]
    for src in range(n_nodes):
        source = (tid & ~(n_nodes - 1)) + src
        assert np.array_equal(source // n_nodes, tid // n_nodes)
        assert np.array_equal(source // 32, tid // 32)
    for key in ("lane_a", "lane_b", "live_a", "live_b"):
        per_slot = m[key].reshape(-1, n_nodes)
        assert (per_slot == per_slot[:, :1]).all(), key
    assert np.array_equal(slot.reshape(-1, n_nodes),
                          np.repeat(slot[::n_nodes, None], n_nodes, 1))
    # every launched thread runs (full masks): whole CTAs
    assert tid.size % CTA == 0


# ---------------------------------------------------------------------------
# The mirror of the kernels' step and row loop
# ---------------------------------------------------------------------------

def support(node: int, n_nodes: int, topology: str):
    """``MxuCoupling``'s support nodes of ``node``, ascending, and which of
    them repeat (a ring of 2 or a torus side of 2: zero coefficient)."""
    if topology == "ring":
        src = [(node - 1) % n_nodes, node, (node + 1) % n_nodes]
    else:
        pp, qq = _grid_shape(n_nodes)
        p, q = divmod(node, qq)
        src = [((p - 1) % pp) * qq + q, p * qq + (q - 1) % qq, node,
               p * qq + (q + 1) % qq, ((p + 1) % pp) * qq + q]
    src = sorted(src)
    return src, [j > 0 and src[j] == src[j - 1] for j in range(len(src))]


class Net:
    """One thread's view of a net, per node: weight blocks as f32 values
    of the state dtype, biases also as bf16 pairs, the coupling's support
    and coefficients."""

    def __init__(self, p: dict, dtype: torch.dtype, lattice):
        w1, b1, w2, b2 = (torch.from_numpy(p[k]).to(dtype) for k in KEYS)
        i_dim, h_dim = w1.shape
        n = lattice[0] if lattice else 1
        d, hb = i_dim // n, h_dim // n
        self.n, self.d, self.hb, self.dtype = n, d, hb, dtype
        nodes = range(n)
        self.w1 = torch.stack([w1[m * d:(m + 1) * d, m * hb:(m + 1) * hb]
                               for m in nodes]).float()          # (N, D, HB)
        self.w2 = torch.stack([w2[m * hb:(m + 1) * hb, m * d:(m + 1) * d]
                               for m in nodes]).float()          # (N, HB, D)
        self.b1 = b1.reshape(n, hb).float()
        self.b2 = b2.reshape(n, d).float()
        if dtype == torch.bfloat16:
            self.b1p = pair16(f32_bits(self.b1) >> 16)
            self.b2p = pair16(f32_bits(self.b2) >> 16)
        self.src = self.coef = None
        if lattice:
            cpl = torch.from_numpy(p["coupling"]).to(dtype).float()
            src, coef = [], []
            for m in nodes:
                s, rep = support(m, n, lattice[2])
                src.append(s)
                coef.append([[0.0 if rep[j] else float(cpl[m * d + k,
                                                          s[j] * d + k])
                              for k in range(d)] for j in range(len(s))])
            self.src = torch.tensor(src)                        # (N, T)
            self.coef = torch.tensor(coef, dtype=torch.float32)  # (N, T, D)


def chain(terms, acc=None):
    """A forward chain of f32 FMAs from +0 over (x, w) pairs."""
    for x, w in terms:
        acc = ref.fma_f32(x, w, torch.zeros_like(x) if acc is None else acc)
    return acc


def coupling_chains(net: Net, lanes):
    """Each lane's coupling chain: its nodes' shuffled components (by the
    support node within the slot) in ascending node order."""
    out = []
    for x in lanes:                                   # (P, N, D) f32
        out.append(torch.stack([
            chain((x[:, net.src[:, j], k], net.coef[:, j, k])
                  for j in range(net.src.shape[1]))
            for k in range(net.d)], -1))
    return out


def step_f32(net: Net, xa, xb, act: str):
    """``mxu_step_x2`` of lanes a and b, (P, N, D) f32 states."""
    cpl = coupling_chains(net, (xa, xb)) if net.src is not None else None
    out = []
    for lane, x in enumerate((xa, xb)):
        acc = chain((x[..., k:k + 1], net.w1[:, k]) for k in range(net.d))
        v = acc + net.b1
        h = relu_mxu(v) if act == "relu" else ref.ACTIVATIONS[act](v)
        acc = chain((h[..., j:j + 1], net.w2[:, j]) for j in range(net.hb))
        y = acc + net.b2
        out.append(y if cpl is None else y + cpl[lane])
    return out


def act_pair_f32(v2, act: str):
    """``activate_pair_f32``: tanh / sigmoid of both halves, f32 results,
    sigmoid's bf16(1 + bf16(e)) one pack and one bf16x2 add."""
    if act == "tanh":
        return ref.tanh_f32(lo_f32(v2)), ref.tanh_f32(hi_f32(v2))
    e2 = pack_bf2(ref.exp_f32(-lo_f32(v2)), ref.exp_f32(-hi_f32(v2)))
    d2 = bf2_add(torch.full_like(v2, ONE2), e2)
    return (ref._flush(1 / lo_f32(d2)), ref._flush(1 / hi_f32(d2)))


def step_bf16x2(net: Net, x2, act: str):
    """``mxu_step_bf16x2`` of packed (P, N, D) states, op for op: the
    coupling chains on shuffled packed components, unpacked; each chain's
    pair rounded by one pack; packed bias and coupling adds, relu fused."""
    cpl2 = None
    if net.src is not None:
        ca, cb = coupling_chains(net, (lo_f32(x2), hi_f32(x2)))
        cpl2 = pack_bf2(ca, cb)
    xa, xb = lo_f32(x2), hi_f32(x2)
    acc_a = chain((xa[..., k:k + 1], net.w1[:, k]) for k in range(net.d))
    acc_b = chain((xb[..., k:k + 1], net.w1[:, k]) for k in range(net.d))
    s2 = pack_bf2(acc_a, acc_b)
    if act == "relu":
        h2 = bf2_add_relu(s2, net.b1p)
        ha, hb = lo_f32(h2), hi_f32(h2)
    else:
        ha, hb = act_pair_f32(bf2_add(s2, net.b1p), act)
    acc_a = chain((ha[..., j:j + 1], net.w2[:, j]) for j in range(net.hb))
    acc_b = chain((hb[..., j:j + 1], net.w2[:, j]) for j in range(net.hb))
    y2 = bf2_add(pack_bf2(acc_a, acc_b), net.b2p)
    return y2 if cpl2 is None else bf2_add(y2, cpl2)


def shifts(net: Net) -> torch.Tensor:
    """Each (node, component)'s fold shift 5*i % 16, i = node*D + k."""
    return (5 * torch.arange(net.n * net.d) % 16).reshape(net.n, net.d)


def fold_f32(net: Net, xa, xb):
    """Both lanes' _fold16 (bits 0-30 in f32), packed: bits 0-15 of each
    into `low`, bits 16 up into `over`, lane a in the low halves."""
    s = shifts(net)
    fa = xor_all((f32_bits(xa) & 0xFFFF) << s, -1)
    fb = xor_all((f32_bits(xb) & 0xFFFF) << s, -1)
    return (fa & 0xFFFF) | (fb & 0xFFFF) << 16, (fa >> 16) | (fb & 0xFFFF0000)


def fold_bf16x2(net: Net, x2):
    """``FoldShift`` on packed components: bits 0-15 of each lane's term
    (`low`), bits 16-21 (`over`), XORed over the components."""
    s = shifts(net)
    seven = torch.full_like(s, 0x7F)
    keep = pair16(seven >> torch.clamp(s - 9, min=0))
    over_keep = pair16(seven) & ~keep
    low = ((x2 & keep) << s) & M32
    over = (x2 & over_keep) >> (16 - s)
    return xor_all(low, -1), xor_all(over, -1)


def xor_all(v: torch.Tensor, dim: int) -> torch.Tensor:
    out = v.select(dim, 0)
    for i in range(1, v.shape[dim]):
        out = out ^ v.select(dim, i)
    return out


def mirror_k1(net: Net, x0: torch.Tensor, offsets: torch.Tensor,
              n_steps: int, act: str):
    """The two-lane kernels' launch: the lane-pair map, the row loop
    (step, fold, step, fold, the folds reduced over each slot's nodes,
    ``word_a`` / ``word_b``, counter and finalizer) and the live halves'
    writes.  Returns (n_steps // 2, S) int64 words and the (S, I) state."""
    n_lanes = x0.shape[0]
    m = lane_pairs(n_lanes, net.n)
    a = torch.from_numpy(m["lane_a"][::net.n])            # per slot
    b = torch.from_numpy(m["lane_b"][::net.n])
    live_a = torch.from_numpy(m["live_a"][::net.n])
    live_b = torch.from_numpy(m["live_b"][::net.n])
    xs = x0.reshape(n_lanes, net.n, net.d)
    bf16 = net.dtype == torch.bfloat16
    if bf16:
        bits = xs.view(torch.int16).to(torch.int64) & 0xFFFF
        x2 = bits[a] | bits[b] << 16
    else:
        xa, xb = xs[a].float(), xs[b].float()
    words = torch.zeros((n_steps // 2, n_lanes), dtype=torch.int64)
    for r in range(n_steps // 2):
        folds = []
        for _ in range(2):
            if bf16:
                x2 = step_bf16x2(net, x2, act)
                low, over = fold_bf16x2(net, x2)
            else:
                xa, xb = step_f32(net, xa, xb, act)
                low, over = fold_f32(net, xa, xb)
            folds.append((xor_all(low, 1), xor_all(over, 1)))  # xor_nodes
        hi, (lo, over) = folds[0][0], folds[1]
        word_a = ((hi << 16) | (lo & 0xFFFF) | (over << 16)) & M32
        word_b = (hi & 0xFFFF0000) | (lo >> 16) | (over & 0xFFFF0000)
        for word, lanes, live in ((word_a, a, live_a), (word_b, b, live_b)):
            ctr = (offsets[lanes[live]] + r) & M32
            words[r, lanes[live]] = ops._finalize_words(
                word[live] ^ ops._mul32(ctr, 0x9E3779B9))
    state = torch.empty_like(xs)
    if bf16:
        for half, lanes, live in ((x2 & 0xFFFF, a, live_a),
                                  (x2 >> 16, b, live_b)):
            v = torch.where(half >= 1 << 15, half - (1 << 16), half)
            state[lanes[live]] = v[live].to(torch.int16).view(torch.bfloat16)
    else:
        state[a[live_a]] = xa[live_a]
        state[b[live_b]] = xb[live_b]
    return words, state.reshape(n_lanes, -1)


def operands(shape: str, dtype: torch.dtype, seed: int):
    p = default_params(system=SHAPES[shape])
    lattice = (lattice_meta_tuple(p["lattice_meta"]) if "lattice_meta" in p
               else None)
    n = lattice[0] if lattice else 1
    rng = np.random.default_rng(seed)
    n_lanes = LANES[n]
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_lanes, p["w1"].shape[0]))
                          .astype(np.float32)).to(dtype)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off[:2] = [0xFFFFFFFF, 0xFFFFFFFE]           # the counter wraps mid-run
    return p, lattice, x0, torch.from_numpy(off)


def plain_kw(p: dict, lattice):
    return dict(lattice=lattice, compute_unit="mxu", coupling=(
        None if lattice is None else torch.from_numpy(p["coupling"])))


def state_bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().view(torch.int32)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mirror_is_the_plain_mxu_step_and_k1(shape, act, tag):
    """K1's words and final state over one row (the state two plain
    steps), then over a few rows, bitwise ``ref``'s plain mxu step and
    K1."""
    dtype = DTYPES[tag][0]
    p, lattice, x0, off = operands(shape, dtype, len(shape) + len(act))
    net = Net(p, dtype, lattice)
    kw = plain_kw(p, lattice)
    step = ref.make_step(*(torch.from_numpy(p[k]) for k in KEYS),
                         dtype=dtype, activation=act, **kw)
    words, state = mirror_k1(net, x0, off, 2, act)
    words_p, _ = ref.chaotic_ann_bits_ref(
        *(torch.from_numpy(p[k]) for k in KEYS), x0, 2, off, act, **kw)
    assert torch.equal(state_bits(state), state_bits(step(step(x0))))
    assert torch.equal(words, ops.from_uint32(words_p))
    n_steps = STEPS[net.n]
    words, state = mirror_k1(net, x0, off, n_steps, act)
    words_p, state_p = ref.chaotic_ann_bits_ref(
        *(torch.from_numpy(p[k]) for k in KEYS), x0, n_steps, off, act, **kw)
    assert torch.equal(words, ops.from_uint32(words_p))
    assert torch.equal(state_bits(state), state_bits(state_p))


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", ["3-8", "ring8"])
def test_mirror_k1_is_the_jax_mxu_k1(shape, act, tag):
    """The mirror's words and state, bitwise the JAX package's
    ``chaotic_ann_bits_pallas(compute_unit="mxu")`` in interpret mode."""
    dtype, jdt = DTYPES[tag]
    p, lattice, x0, off = operands(shape, dtype, 7)
    net = Net(p, dtype, lattice)
    words, state = mirror_k1(net, x0, off, 4, act)
    jcpl = None if lattice is None else jnp.asarray(p["coupling"])
    words_j, state_j = chaotic_ann_bits_pallas(
        *(jnp.asarray(p[k]) for k in KEYS),
        jnp.asarray(x0.float().numpy()).astype(jdt),
        jnp.asarray(off.numpy().astype(np.uint32)), jcpl, n_steps=4,
        s_block=128 if lattice is None else 256, t_block=4, unroll=1,
        activation=act, compute_unit="mxu", lattice=lattice, interpret=True)
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(words_j).astype(np.int64))
    np.testing.assert_array_equal(
        state_bits(state).numpy(),
        np.asarray(state_j.astype(jnp.float32)).view(np.int32))
