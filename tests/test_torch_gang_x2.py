"""The scalar bf16 gang kernels on the bf16x2 row loop
(``bf16x2_gang_bits_kernel``, K3, and ``bf16x2_gang_stacked_kernel``, K4,
in ``csrc/chaotic_ann.cu``) mirrored on the CPU.

Both run the scalar bf16 K1's row loop (``bf16x2_rows``): thread t of a
CTA of C threads runs lanes t and t + C of the CTA's 2C (``LanePair<1>``),
both lanes packed in one register a component, every add, subtract and
multiply one ``add/sub/mul.rn.bf16x2``, relu fused into the bias add, both
lanes' folds in three registers.  K3 indexes its CTAs of 64 threads, 128
lanes, by (lane block, CTA within the block) (``GangCta<1, 64>``), so a
CTA never straddles two blocks (two cores or two row counts), stages one
core's weights and, since ``s_block`` is a multiple of 128, has both lane
halves live; K4 by (CTA, core), 128 threads a CTA, its lanes counted
inside the core.  A thread
whose lane a lies past its block's or core's end returns once the weights
are staged (the loop has no shuffles); a lane b past it mirrors lane a and
writes nothing.  Here:

* the launchers' lane-pair maps: K3 at ``s_block`` 128, 256, 384 and 640
  (every CTA of a whole block with both halves live), K4 at 1, 2, 3, 37,
  129 and 257 lanes a core: every lane computed and written by exactly
  one live half of its own block or core, every CTA inside one block;
* a plain mirror of the two-lane gang row loop, in the kernels' op order,
  bitwise ``ref.chaotic_ann_gang_bits_ref`` and
  ``ref.chaotic_ann_gang_stacked_ref`` in bf16 for relu, tanh and sigmoid
  at 3-8 (the four committed farm nets) and 4-16 (hyperlorenz's farm and
  registry nets), with a row map of 0, partial and full blocks and a
  frozen K4 core, and bitwise the JAX package's
  ``chaotic_ann_gang_bits_pallas`` / ``chaotic_ann_gang_stacked_pallas``
  in interpret mode on a subset that takes each kernel, shape and
  activation at least once (the plain versions are held to the JAX
  kernels on every combination in ``tests/test_torch_gang.py`` and
  ``tests/test_torch_gang_activation.py``).

Every comparison is bitwise: the tolerance is 0.  The card holds the
packed ops to the f32 round trip on all their inputs, and the kernels to
the plain versions (``chip_smoke.py``).
"""
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params

from test_torch_lattice_gang_x2 import (bf16_bits_of, bf2_mul, bias_bits,
                                        jax_words, k4_lane_pairs,
                                        state_bits)
from test_torch_mxu_x2 import (M32, act_pair_f32, bf2_add, bf2_add_relu,
                               fold_bf16x2, pack_bf2, pair16)

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
K3_CTA = CTA // 2                         # kGangThreads: the K3's CTA
FARM = (pathlib.Path(__file__).resolve().parents[1] / "results"
        / "generated_cores" / "farm")
# the committed farm's gangs: its four 3-8-3 nets, and hyperlorenz's farm
# and registry nets as a 4-16-4 pair
GANGS = {"3-8": ("chen", "chua", "lorenz", "rossler"),
         "4-16": ("hyperlorenz", "registry:hyperlorenz")}
N_STEPS = 16                              # 8 word rows
CORE_MAP = np.array([2, 0, 3, 1, 1, 2])   # modulo the gang's cores
K3_ROWS = np.array([0, 3, 8, 1, 8, 5])    # 0, partial and full blocks
K4_ROWS = np.array([3, 0, 8, 5])          # the gang's first cores: a frozen
K4_LANES = 256 + 128 + 37                 # one; a CTA with lane b partly live


# ---------------------------------------------------------------------------
# The launchers' lane-pair maps (launch_gang_bits / _stacked)
# ---------------------------------------------------------------------------

def k3_lane_pairs(n_lanes: int, s_block: int) -> dict:
    """Every thread of a K3 launch, as ``launch_gang_bits``'s grid and
    ``GangCta<1, kGangThreads>`` compute them: its CTA, thread, lane block
    and lane pair (lanes counted from lane 0)."""
    cta_lanes = 2 * K3_CTA
    per_block = -(-s_block // cta_lanes)
    grid = -(-n_lanes // s_block) * per_block
    t = np.arange(grid * K3_CTA)
    cta, tid = t // K3_CTA, t % K3_CTA
    block = cta // per_block
    first = block * s_block
    end = np.minimum(s_block, n_lanes - first)
    a = (cta % per_block) * cta_lanes + tid
    b = a + K3_CTA
    live_a, live_b = a < end, b < end
    a = np.where(live_a, a, end - 1)
    b = np.where(live_b, b, a)
    return dict(cta=cta, tid=tid, block=block, lane_a=first + a,
                lane_b=first + b, live_a=live_a, live_b=live_b)


def check_lane_pairs(m: dict, n_lanes: int, lane_block, cta: int):
    """Each lane computed and written (words and state) by exactly one
    live half, of a thread of its own block or core (a mirror too: the
    same core and rows); one block a CTA of ``cta`` threads; whole
    CTAs."""
    live = np.concatenate([m["lane_a"][m["live_a"]],
                           m["lane_b"][m["live_b"]]])
    assert np.array_equal(np.sort(live), np.arange(n_lanes))
    for h in ("a", "b"):
        assert np.array_equal(lane_block(m[f"lane_{h}"]), m["block"])
    per_cta = m["block"].reshape(-1, cta)
    assert (per_cta == per_cta[:, :1]).all()
    # a dead lane b mirrors its thread's lane a; lane b is live only
    # beside a live lane a
    dead = ~m["live_b"]
    assert np.array_equal(m["lane_b"][dead], m["lane_a"][dead])
    assert (m["live_a"] | ~m["live_b"]).all()


@pytest.mark.parametrize("s_block", [128, 256, 384, 640])
@pytest.mark.parametrize("n_blocks,cut", [(1, 0), (5, 0), (3, 3)])
def test_k3_lane_pair_map(s_block, n_blocks, cut):
    """``GangCta<1, 64>``: a CTA of 128 lanes, so an s_block of 128 (the
    served farms'), 256 and odd multiples of 128 all fill whole CTAs, and
    a pool cut short of its last block's end (the kernel takes it; the
    wrapper pads pools to whole blocks) leaves the last CTA ragged.  A
    lane's writer runs its own block's core and rows, 0 rows included,
    since it lies in that block."""
    n_lanes = n_blocks * s_block - min(cut, s_block - 1)
    m = k3_lane_pairs(n_lanes, s_block)
    check_lane_pairs(m, n_lanes, lambda lane: lane // s_block, K3_CTA)
    # every thread of a whole block has both halves live
    whole = m["block"] < n_lanes // s_block
    assert (m["live_a"] & m["live_b"])[whole].all()
    assert m["cta"].max() + 1 == -(-n_lanes // s_block) * s_block // 128


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 37, 129, 257])
def test_k4_lane_pair_map(n_lanes):
    """``LanePair<1>`` per core (grid (ceil(n_lanes / 256), C)): a ragged
    edge mirrors the core's own last lane."""
    n_cores = 3
    m = k4_lane_pairs(n_cores, n_lanes, 1)
    check_lane_pairs(m, n_cores * n_lanes, lambda lane: lane // n_lanes,
                     CTA)
    assert m["cta"].max() + 1 == n_cores * -(-n_lanes // (2 * CTA))


# ---------------------------------------------------------------------------
# The mirror of the two-lane gang row loop
# ---------------------------------------------------------------------------

class ScalarGang:
    """The stacked nets of one gang as a CTA holds them: each core's
    weights as duplicated bf16 pairs, (C, I, H) and (C, H, I), biases with
    -0 as +0 (``load_pair_weights``).  ``take(cores)`` gives each thread
    its core's operands."""

    def __init__(self, w):
        w1, b1, w2, b2 = (torch.as_tensor(a) for a in w)
        self.i, self.h = w1.shape[1:]
        self.w1 = pair16(bf16_bits_of(w1))
        self.w2 = pair16(bf16_bits_of(w2))
        self.b1, self.b2 = bias_bits(b1), bias_bits(b2)

    def take(self, cores: torch.Tensor) -> "ScalarGang":
        out = types.SimpleNamespace(i=self.i, h=self.h)
        for k in KEYS:
            setattr(out, k, getattr(self, k)[cores])
        return out


def step2(net, x2: torch.Tensor, act: str) -> torch.Tensor:
    """``step2`` of packed (P, I) states with each thread's operands, op
    for op: each hidden sum from its first product, relu fused into the
    bias add (tanh / sigmoid through ``activate2``), each output sum from
    its first product, then its bias."""
    h = bf2_mul(net.w1[:, 0, :], x2[:, 0:1])                  # (P, H)
    for i in range(1, net.i):
        h = bf2_add(h, bf2_mul(net.w1[:, i, :], x2[:, i:i + 1]))
    if act == "relu":
        h = bf2_add_relu(h, net.b1)
    else:
        h = pack_bf2(*act_pair_f32(bf2_add(h, net.b1), act))
    y = bf2_mul(net.w2[:, 0, :], h[:, 0:1])                   # (P, I)
    for j in range(1, net.h):
        y = bf2_add(y, bf2_mul(net.w2[:, j, :], h[:, j:j + 1]))
    return bf2_add(y, net.b2)


def fold2(x2: torch.Tensor):
    """``FoldShift`` over a thread's packed components: (low, over)."""
    one_node = types.SimpleNamespace(n=1, d=x2.shape[1])
    low, over = fold_bf16x2(one_node, x2[:, None, :])
    return low[:, 0], over[:, 0]


def mirror_gang(gang: ScalarGang, m: dict, x0, offsets, block_core,
                block_rows, n_steps: int, act: str):
    """A gang launch of the two-lane kernels over the lane-pair map ``m``
    (``k3_lane_pairs``, or ``k4_lane_pairs`` at one node), ``bf16x2_rows``
    in every thread: block (K3) or core (K4) g's threads run core
    ``block_core[g]`` for ``block_rows[g]`` rows of (step, fold, step,
    fold), ``word_a`` / ``word_b``, counter and finalizer; the live halves
    write.  ``x0`` (S, I) bf16 and ``offsets`` (S,) pooled.  Returns
    (n_steps // 2, S) int64 words, zero past a lane's rows, and the (S, I)
    state."""
    n_lanes = x0.shape[0]
    xs = bf16_bits_of(x0)
    t = {k: torch.from_numpy(v) for k, v in m.items()}
    a, b, live_a, live_b = (t[k] for k in ("lane_a", "lane_b", "live_a",
                                           "live_b"))
    net = gang.take(torch.as_tensor(np.asarray(block_core))[t["block"]])
    rows = torch.as_tensor(np.asarray(block_rows))[t["block"]]
    x2 = xs[a] | xs[b] << 16
    words = torch.zeros((n_steps // 2, n_lanes), dtype=torch.int64)
    for r in range(n_steps // 2):
        nx = step2(net, x2, act)
        hi = fold2(nx)[0]
        nx = step2(net, nx, act)
        lo, over = fold2(nx)
        run = rows > r
        x2 = torch.where(run[:, None], nx, x2)
        word_a = ((hi << 16) | (lo & 0xFFFF) | (over << 16)) & M32
        word_b = (hi & 0xFFFF0000) | (lo >> 16) | (over & 0xFFFF0000)
        for word, lanes, live in ((word_a, a, live_a), (word_b, b, live_b)):
            ctr = (offsets[lanes] + r) & M32
            out = ops._finalize_words(word ^ ops._mul32(ctr, 0x9E3779B9))
            words[r, lanes[live & run]] = out[live & run]
    state = torch.zeros_like(xs)
    state[a[live_a]] = (x2 & 0xFFFF)[live_a]
    state[b[live_b]] = (x2 >> 16)[live_b]
    state = torch.where(state >= 1 << 15, state - (1 << 16), state)
    return words, state.to(torch.int16).view(torch.bfloat16)


def gang_weights(shape: str):
    """(stacked f32 numpy weights, ScalarGang) of one of GANGS."""
    per_core = []
    for name in GANGS[shape]:
        if name.startswith("registry:"):
            p = default_params(system=name.split(":")[1])
        else:
            with np.load(FARM / name / "weights.npz") as npz:
                p = dict(npz)
        per_core.append([np.asarray(p[k], np.float32) for k in KEYS])
    w = [np.stack(ws) for ws in zip(*per_core)]
    return w, ScalarGang(w)


def inputs(rng, shape):
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, shape).astype(np.float32)
                          ).to(torch.bfloat16)
    off = rng.integers(0, 1 << 32, shape[:-1], dtype=np.int64)
    off[..., :2] = [0xFFFFFFFF, 0xFFFFFFFE]       # the counter wraps mid-run
    return x0, torch.from_numpy(off)


def k3_case(shape: str, s_block: int, seed: int):
    w, gang = gang_weights(shape)
    core_map = CORE_MAP % len(GANGS[shape])
    x0, off = inputs(np.random.default_rng(seed),
                     (len(core_map) * s_block, w[0].shape[1]))
    return w, gang, core_map, x0, off


def k4_case(shape: str, seed: int):
    w, gang = gang_weights(shape)
    n_cores = len(GANGS[shape])
    x0, off = inputs(np.random.default_rng(seed),
                     (n_cores, K4_LANES, w[0].shape[1]))
    return w, gang, K4_ROWS[:n_cores], x0, off


def mirror_k3(gang, core_map, x0, off, s_block, act):
    m = k3_lane_pairs(x0.shape[0], s_block)
    return mirror_gang(gang, m, x0, off, core_map, K3_ROWS, N_STEPS, act)


def mirror_k4(gang, rows, x0, off, act):
    n_cores = x0.shape[0]
    m = k4_lane_pairs(n_cores, K4_LANES, 1)
    words, state = mirror_gang(gang, m, x0.reshape(n_cores * K4_LANES, -1),
                               off.reshape(-1), range(n_cores), rows,
                               N_STEPS, act)
    return words.reshape(-1, n_cores, K4_LANES), state.reshape(x0.shape)


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", ["3-8", "4-16"])
def test_mirror_k3_is_the_plain_k3(shape, act):
    """The mirror of K3 at s_block 128 (the served farms'), 256 and 384,
    bitwise
    ``ref.chaotic_ann_gang_bits_ref`` and the wrapper on the CPU (the
    plain version): every word (zero past a block's rows) and the final
    state."""
    for s_block in (128, 256, 384):
        w, gang, core_map, x0, off = k3_case(shape, s_block, s_block)
        words, state = mirror_k3(gang, core_map, x0, off, s_block, act)
        tw = [torch.from_numpy(a) for a in w]
        words_p, state_p = ref.chaotic_ann_gang_bits_ref(
            *tw, x0, core_map, N_STEPS, off, K3_ROWS, act)
        assert torch.equal(words, ops.from_uint32(words_p))
        np.testing.assert_array_equal(state_bits(state), state_bits(state_p))
        _, state_w = chaotic_ann.chaotic_ann_gang_bits(
            *tw, x0, core_map, off, K3_ROWS, n_steps=N_STEPS,
            s_block=s_block, t_block=4, unroll=1, activation=act)
        np.testing.assert_array_equal(state_bits(state), state_bits(state_w))
        # 0-row block 0 keeps x0; its words stay unwritten
        np.testing.assert_array_equal(state_bits(state[:s_block]),
                                      state_bits(x0[:s_block]))
        assert not words[:, :s_block].any()


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", ["3-8", "4-16"])
def test_mirror_k4_is_the_plain_k4(shape, act):
    """The mirror of K4 on the gang's cores of 421 lanes (a second CTA
    whose lane-b halves are partly live), a frozen core among them,
    bitwise ``ref.chaotic_ann_gang_stacked_ref``."""
    w, gang, rows, x0, off = k4_case(shape, 3)
    words, state = mirror_k4(gang, rows, x0, off, act)
    words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
        *(torch.from_numpy(a) for a in w), x0, N_STEPS, off, rows, act)
    assert torch.equal(words, ops.from_uint32(words_p))
    np.testing.assert_array_equal(state_bits(state), state_bits(state_p))
    frozen = int(np.flatnonzero(rows == 0)[0])
    np.testing.assert_array_equal(state_bits(state[frozen]),
                                  state_bits(x0[frozen]))


# each kernel, shape and activation at least once
@pytest.mark.parametrize("kernel,shape,act,s_block", [
    ("k3", "3-8", "tanh", 384), ("k3", "4-16", "relu", 128),
    ("k4", "4-16", "sigmoid", 128), ("k4", "3-8", "relu", 128)])
def test_mirror_is_the_jax_gang_kernel(kernel, shape, act, s_block):
    """The mirror's words (each block's or core's rows; JAX leaves later
    rows unwritten) and final state, bitwise the JAX package's K3 / K4 in
    interpret mode (t_block 4, unroll 1: rows exactly the map's)."""
    def jax_bf16(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    if kernel == "k3":
        w, gang, core_map, x0, off = k3_case(shape, s_block, 7)
        words, state = mirror_k3(gang, core_map, x0, off, s_block, act)
        words_j, state_j = jax_ann.chaotic_ann_gang_bits_pallas(
            *map(jnp.asarray, w), jax_bf16(x0), jnp.asarray(core_map),
            jnp.asarray(off.numpy().astype(np.uint32)), jnp.asarray(K3_ROWS),
            n_steps=N_STEPS, s_block=s_block, t_block=4, unroll=1,
            activation=act, interpret=True)
        lane_rows = np.repeat(K3_ROWS, s_block)
    else:
        w, gang, rows, x0, off = k4_case(shape, 8)
        words, state = mirror_k4(gang, rows, x0, off, act)
        words_j, state_j = jax_ann.chaotic_ann_gang_stacked_pallas(
            *map(jnp.asarray, w), jax_bf16(x0),
            jnp.asarray(off.numpy().astype(np.uint32)), jnp.asarray(rows),
            n_steps=N_STEPS, s_block=s_block, t_block=4, unroll=1,
            activation=act, interpret=True)
        lane_rows = rows[:, None]
    r = np.arange(N_STEPS // 2).reshape((-1,) + (1,) * (words.ndim - 1))
    asked = r < lane_rows
    np.testing.assert_array_equal(np.where(asked, words.numpy(), 0),
                                  np.where(asked, jax_words(words_j), 0))
    np.testing.assert_array_equal(
        state_bits(state), np.asarray(state_j).view(np.int16))
