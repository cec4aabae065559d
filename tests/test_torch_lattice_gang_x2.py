"""The bf16 lattice gang kernels on the bf16x2 row loop
(``bf16x2_lattice_gang_bits_kernel``, K3, and
``bf16x2_lattice_gang_stacked_kernel``, K4, in ``csrc/chaotic_ann.cu``)
mirrored on the CPU.

Both run the bf16x2 lattice K1's row loop (``bf16x2_lattice_rows``): a
CTA of 128 threads holds 128 / N lane slots of N node threads, each slot
two lanes packed in one register a component, every add, subtract and
multiply one ``add/sub/mul.rn.bf16x2``, relu fused into the bias add,
both lanes' folds in three registers reduced over the slot's nodes.  K3
indexes its CTAs by (lane block, CTA within the block), so a CTA never
straddles two blocks (two cores or two row counts); K4 by (CTA, core).
A half whose lane lies past its block's or core's end mirrors that
block's or core's last lane and writes nothing.  Here:

* the launchers' lane-pair maps: for ``s_block`` on and off the two-lane
  span 2 * 128 / N, ragged lane counts and 0-row blocks, every lane is
  computed and written by exactly one live half of its own block or
  core, every CTA lies inside one block, every shuffle inside its slot;
* a plain mirror of the two-lane gang row loop, in the kernels' op order,
  bitwise ``ref.chaotic_ann_gang_bits_ref`` and
  ``ref.chaotic_ann_gang_stacked_ref`` in bf16 for relu, tanh and sigmoid
  at chen@ring8 and chen@grid8, with a row map that has 0, partial and
  full blocks, and bitwise the JAX package's
  ``chaotic_ann_gang_bits_pallas`` / ``chaotic_ann_gang_stacked_pallas``
  in interpret mode on a subset that takes each activation, topology and
  kernel at least once (each interpret compile takes seconds; the plain
  versions are held to the JAX kernels on every combination in
  ``tests/test_torch_lattice_farm.py`` and
  ``tests/test_torch_lattice_activation.py``).

The card holds the packed ops to the f32 round trip on all their inputs,
and the kernels to the plain versions (``chip_smoke.py``).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.chaotic import _grid_shape
from repro_torch.kernels import ops, ref
from repro_torch.prng.stream import default_params

from test_torch_mxu_x2 import (M32, act_pair_f32, bf2_add, bf2_add_relu,
                               fold_bf16x2, hi_f32, lo_f32, pack_bf2, pair16,
                               xor_all)

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
BASES = ("chen", "chua", "lorenz", "rossler")     # the 3-8 registry systems
N_STEPS = 16                              # 8 word rows
CORE_MAP = np.array([2, 0, 3, 1, 1, 2])
K3_ROWS = np.array([0, 3, 8, 1, 8, 5])    # 0, partial and full blocks
K4_ROWS = np.array([8, 0, 3])             # full, 0 and partial cores
K4_LANES = 37                             # a core's lanes: a ragged CTA


# ---------------------------------------------------------------------------
# The launchers' lane-pair maps (launch_lattice_gang_bits / _stacked)
# ---------------------------------------------------------------------------

def k3_lane_pairs(n_lanes: int, s_block: int, n_nodes: int) -> dict:
    """Every thread of a K3 launch, as ``launch_lattice_gang_bits``'s grid
    and ``bf16x2_lattice_gang_bits_kernel`` compute them: its CTA, thread,
    node, lane block and lane pair (lanes counted from lane 0)."""
    slots = CTA // n_nodes
    cta_lanes = 2 * slots
    per_block = -(-s_block // cta_lanes)
    grid = -(-n_lanes // s_block) * per_block
    t = np.arange(grid * CTA)
    cta, tid = t // CTA, t % CTA
    block = cta // per_block
    first = block * s_block
    end = np.minimum(s_block, n_lanes - first)
    a = (cta % per_block) * cta_lanes + tid // n_nodes
    b = a + slots
    live_a, live_b = a < end, b < end
    a = np.where(live_a, a, end - 1)
    b = np.where(live_b, b, a)
    return dict(cta=cta, tid=tid, node=tid % n_nodes, block=block,
                lane_a=first + a, lane_b=first + b, live_a=live_a,
                live_b=live_b)


def k4_lane_pairs(n_cores: int, n_lanes: int, n_nodes: int) -> dict:
    """Every thread of a K4 launch (grid (ceil(n_lanes / (2 * 128 / N)),
    n_cores)): lanes counted inside the thread's core ``block``, as
    elements ``core * n_lanes + lane`` of the pooled operands."""
    slots = CTA // n_nodes
    cta_lanes = 2 * slots
    grid_x = -(-n_lanes // cta_lanes)
    t = np.arange(n_cores * grid_x * CTA)
    cta, tid = t // CTA, t % CTA
    core, cx = cta // grid_x, cta % grid_x
    a = cx * cta_lanes + tid // n_nodes
    b = a + slots
    live_a, live_b = a < n_lanes, b < n_lanes
    a = np.where(live_a, a, n_lanes - 1)
    b = np.where(live_b, b, a)
    base = core * n_lanes
    return dict(cta=cta, tid=tid, node=tid % n_nodes, block=core,
                lane_a=base + a, lane_b=base + b, live_a=live_a,
                live_b=live_b)


def check_lane_pairs(m: dict, n_lanes: int, n_nodes: int, lane_block):
    """Each lane computed by exactly one live half and written by one
    thread (node 0 lane a's words, node 1 lane b's), the state by every
    node of a live half; every half's lanes in its own block (a mirror
    too: the same core and rows); one block a CTA; shuffles in the slot."""
    node = m["node"]
    computed = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                               m["lane_b"][m["live_b"] & (node == 0)]])
    assert np.array_equal(np.sort(computed), np.arange(n_lanes))
    written = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                              m["lane_b"][m["live_b"] & (node == 1)]])
    assert np.array_equal(np.sort(written), np.arange(n_lanes))
    comps = np.concatenate([m[f"lane_{h}"][m[f"live_{h}"]] * n_nodes
                            + node[m[f"live_{h}"]] for h in ("a", "b")])
    assert np.array_equal(np.sort(comps), np.arange(n_lanes * n_nodes))
    for h in ("a", "b"):
        assert np.array_equal(lane_block(m[f"lane_{h}"]), m["block"])
    per_cta = m["block"].reshape(-1, CTA)
    assert (per_cta == per_cta[:, :1]).all()
    tid = m["tid"]
    for src in range(n_nodes):
        source = (tid & ~(n_nodes - 1)) + src
        assert np.array_equal(source // n_nodes, tid // n_nodes)
        assert np.array_equal(source // 32, tid // 32)
    for key in ("lane_a", "lane_b", "live_a", "live_b"):
        per_slot = m[key].reshape(-1, n_nodes)
        assert (per_slot == per_slot[:, :1]).all(), key


@pytest.mark.parametrize("n_nodes,s_block", [
    (8, 16), (8, 32), (8, 48), (8, 128), (32, 4), (32, 8), (32, 12),
    (32, 256)])
@pytest.mark.parametrize("n_blocks,cut", [(1, 0), (5, 0), (3, 3)])
def test_k3_lane_pair_map(n_nodes, s_block, n_blocks, cut):
    """s_block on the two-lane span (32 at 8 nodes, 8 at 32) and off it
    (an odd multiple of 128 / N: the block's last CTA holds one live
    half), and a pool cut short of its last block's end (the kernel takes
    it; the wrapper pads pools to whole blocks).  A lane's writer runs its
    own block's core and rows, 0 rows included, since it lies in that
    block."""
    n_lanes = n_blocks * s_block - min(cut, s_block - 1)
    m = k3_lane_pairs(n_lanes, s_block, n_nodes)
    check_lane_pairs(m, n_lanes, n_nodes, lambda lane: lane // s_block)
    # a whole block's last CTA: both halves live on the span, lane a's
    # alone off it
    cta_lanes = 2 * CTA // n_nodes
    per_block = -(-s_block // cta_lanes)
    last = (m["cta"] % per_block == per_block - 1) & (
        m["block"] < n_lanes // s_block)
    assert m["live_a"][last].all()
    assert (m["live_b"][last] == (s_block % cta_lanes == 0)).all()


@pytest.mark.parametrize("n_nodes", [8, 32])
@pytest.mark.parametrize("n_cores,n_lanes", [(1, 1), (3, 5), (3, 37),
                                             (2, 129)])
def test_k4_lane_pair_map(n_cores, n_lanes, n_nodes):
    """Per core, a ragged edge mirroring the core's own last lane."""
    m = k4_lane_pairs(n_cores, n_lanes, n_nodes)
    check_lane_pairs(m, n_cores * n_lanes, n_nodes,
                     lambda lane: lane // n_lanes)
    dead = ~m["live_b"]
    assert np.array_equal(m["lane_b"][dead], m["lane_a"][dead])


# ---------------------------------------------------------------------------
# The mirror of the two-lane gang row loop
# ---------------------------------------------------------------------------

def bf2_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sub.rn.bf16x2``: each half's difference rounded once."""
    return pack_bf2(lo_f32(a) - lo_f32(b), hi_f32(a) - hi_f32(b))


def bf2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mul.rn.bf16x2``: each half's product (exact in f32) rounded."""
    return pack_bf2(lo_f32(a) * lo_f32(b), hi_f32(a) * hi_f32(b))


def bf16_bits_of(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def bias_bits(b: torch.Tensor) -> torch.Tensor:
    """A bias as a pair, -0 as +0 (``bias_bits``)."""
    bits = bf16_bits_of(b)
    return pair16(torch.where(bits == 0x8000, torch.zeros_like(bits), bits))


class LatticeGang:
    """The cores of one descriptor as their node threads hold them: each
    core's diagonal weight blocks as duplicated bf16 pairs, (C, N, D, HB)
    and (C, N, HB, D), biases with -0 as +0, and the descriptor's
    neighbours, degree and coupling strength.  ``take(cores)`` gives each
    lane slot its core's operands."""

    def __init__(self, per_core, lattice):
        n, d, topology, strength = lattice
        hb = per_core[0]["w1"].shape[1] // n
        self.n, self.d, self.hb = n, d, hb

        def blocks(w, rows, cols):
            return torch.stack([bf16_bits_of(torch.from_numpy(
                w[m * rows:(m + 1) * rows, m * cols:(m + 1) * cols]))
                for m in range(n)])

        self.w1 = pair16(torch.stack([blocks(p["w1"], d, hb)
                                      for p in per_core]))
        self.w2 = pair16(torch.stack([blocks(p["w2"], hb, d)
                                      for p in per_core]))
        self.b1 = torch.stack([bias_bits(torch.from_numpy(p["b1"]))
                               .reshape(n, hb) for p in per_core])
        self.b2 = torch.stack([bias_bits(torch.from_numpy(p["b2"]))
                               .reshape(n, d) for p in per_core])
        self.eps = int(pair16(bf16_bits_of(torch.tensor(strength))))
        node = torch.arange(n)
        if topology == "ring":
            self.sums = [((node - 1) % n, (node + 1) % n)]
            self.deg = 0x40004000                      # (2.0, 2.0)
        else:
            pp, qq = _grid_shape(n)
            row, col = node // qq, node % qq
            self.sums = [(((row - 1) % pp) * qq + col,
                          ((row + 1) % pp) * qq + col),
                         (row * qq + (col - 1) % qq,
                          row * qq + (col + 1) % qq)]
            self.deg = 0x40804080                      # (4.0, 4.0)

    def take(self, cores: torch.Tensor) -> "LatticeGang":
        out = copy.copy(self)
        for k in KEYS:
            setattr(out, k, getattr(self, k)[cores])
        return out


def lattice_step2(net: LatticeGang, x2: torch.Tensor, act: str):
    """``lattice_step2`` of packed (P, N, D) states with each slot's
    operands (``LatticeGang.take``), op for op: the neighbours' sums
    (shuffles by node), the coupling increment, ``step2`` on the node's
    own blocks (each sum from its first term, relu fused into the bias
    add, tanh / sigmoid through ``activate2``), then the increment added."""
    pairs = [bf2_add(x2[:, s[0]], x2[:, s[1]]) for s in net.sums]
    acc = pairs[0] if len(pairs) == 1 else bf2_add(pairs[0], pairs[1])
    delta = bf2_mul(bf2_sub(acc, bf2_mul(torch.full_like(x2, net.deg), x2)),
                    torch.full_like(x2, net.eps))
    h = bf2_mul(net.w1[..., 0, :], x2[..., 0:1])             # (P, N, HB)
    for k in range(1, net.d):
        h = bf2_add(h, bf2_mul(net.w1[..., k, :], x2[..., k:k + 1]))
    if act == "relu":
        h = bf2_add_relu(h, net.b1)
    else:
        h = pack_bf2(*act_pair_f32(bf2_add(h, net.b1), act))
    y = bf2_mul(net.w2[..., 0, :], h[..., 0:1])              # (P, N, D)
    for j in range(1, net.hb):
        y = bf2_add(y, bf2_mul(net.w2[..., j, :], h[..., j:j + 1]))
    return bf2_add(bf2_add(y, net.b2), delta)


def mirror_gang(gang: LatticeGang, m: dict, x0, offsets, block_core,
                block_rows, n_steps: int, act: str):
    """A gang launch of the two-lane kernels over the lane-pair map ``m``
    (``k3_lane_pairs`` or ``k4_lane_pairs``), ``bf16x2_lattice_rows`` in
    every lane slot: block (K3) or core (K4) g's slots run core
    ``block_core[g]`` for ``block_rows[g]`` rows of (step, fold, step,
    fold), each fold reduced over the slot's nodes (``xor_nodes``),
    ``word_a`` / ``word_b``, counter and finalizer; the live halves write.
    ``x0`` (S, I) bf16 and ``offsets`` (S,) pooled.  Returns
    (n_steps // 2, S) int64 words, zero past a lane's rows, and the (S, I)
    state."""
    n_lanes, n = x0.shape[0], gang.n
    xs = bf16_bits_of(x0).reshape(n_lanes, n, gang.d)
    slot = {k: torch.from_numpy(v[::n]) for k, v in m.items()}
    a, b, live_a, live_b = (slot[k] for k in ("lane_a", "lane_b", "live_a",
                                              "live_b"))
    net = gang.take(torch.as_tensor(np.asarray(block_core))[slot["block"]])
    rows = torch.as_tensor(np.asarray(block_rows))[slot["block"]]
    x2 = xs[a] | xs[b] << 16
    words = torch.zeros((n_steps // 2, n_lanes), dtype=torch.int64)
    for r in range(n_steps // 2):
        nx = lattice_step2(net, x2, act)
        hi = xor_all(fold_bf16x2(net, nx)[0], 1)
        nx = lattice_step2(net, nx, act)
        lo, over = (xor_all(v, 1) for v in fold_bf16x2(net, nx))
        run = rows > r
        x2 = torch.where(run[:, None, None], nx, x2)
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
    return words, state.to(torch.int16).view(torch.bfloat16).reshape(
        n_lanes, -1)


def lattice_gang(topology: str):
    """(per-core numpy params, stacked torch weights, descriptor) of the
    four bases as 8-node lattices of one descriptor."""
    per_core = [default_params(system=f"{b}@{topology}8") for b in BASES]
    w = [torch.from_numpy(np.stack([p[k] for p in per_core])) for k in KEYS]
    return per_core, w, lattice_meta_tuple(per_core[0]["lattice_meta"])


def k3_case(topology: str, s_block: int, seed: int):
    per_core, w, lattice = lattice_gang(topology)
    gang = LatticeGang(per_core, lattice)
    rng = np.random.default_rng(seed)
    n_lanes = len(CORE_MAP) * s_block
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_lanes, 24))
                          .astype(np.float32)).to(torch.bfloat16)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off[:2] = [0xFFFFFFFF, 0xFFFFFFFE]           # the counter wraps mid-run
    return gang, w, lattice, x0, torch.from_numpy(off)


def k4_case(topology: str, seed: int):
    per_core, w, lattice = lattice_gang(topology)
    gang = LatticeGang(per_core[:3], lattice)
    w3 = [a[:3] for a in w]
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (3, K4_LANES, 24))
                          .astype(np.float32)).to(torch.bfloat16)
    off = rng.integers(0, 1 << 32, (3, K4_LANES), dtype=np.int64)
    off[:, :2] = [0xFFFFFFFF, 0xFFFFFFFE]
    return gang, w3, lattice, x0, torch.from_numpy(off)


def mirror_k3(gang, x0, off, s_block, act):
    m = k3_lane_pairs(x0.shape[0], s_block, gang.n)
    return mirror_gang(gang, m, x0, off, CORE_MAP, K3_ROWS, N_STEPS, act)


def mirror_k4(gang, x0, off, act):
    m = k4_lane_pairs(3, K4_LANES, gang.n)
    words, state = mirror_gang(gang, m, x0.reshape(3 * K4_LANES, -1),
                               off.reshape(-1), range(3), K4_ROWS, N_STEPS,
                               act)
    return words.reshape(-1, 3, K4_LANES), state.reshape(x0.shape)


def state_bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy()


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("topology", ["ring", "grid"])
def test_mirror_k3_is_the_plain_lattice_k3(topology, act):
    """The mirror of K3, with s_block off the two-lane span (16 at 8
    nodes: each CTA of 32 lanes would straddle two blocks) and on it
    (32), bitwise ``ref.chaotic_ann_gang_bits_ref``: every word (zero
    past a block's rows) and the final state."""
    for s_block in (16, 32):
        gang, w, lattice, x0, off = k3_case(topology, s_block, s_block)
        words, state = mirror_k3(gang, x0, off, s_block, act)
        words_p, state_p = ref.chaotic_ann_gang_bits_ref(
            *w, x0, CORE_MAP, N_STEPS, off, K3_ROWS, act, lattice)
        assert torch.equal(words, ops.from_uint32(words_p))
        np.testing.assert_array_equal(state_bits(state), state_bits(state_p))
        # 0-row block 0 keeps x0; its words stay unwritten
        np.testing.assert_array_equal(state_bits(state[:s_block]),
                                      state_bits(x0[:s_block]))
        assert not words[:, :s_block].any()


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("topology", ["ring", "grid"])
def test_mirror_k4_is_the_plain_lattice_k4(topology, act):
    """The mirror of K4 on three cores of 37 lanes (a ragged CTA in
    each), a full, a 0-row and a partial core, bitwise
    ``ref.chaotic_ann_gang_stacked_ref``."""
    gang, w3, lattice, x0, off = k4_case(topology, 3)
    words, state = mirror_k4(gang, x0, off, act)
    words_p, state_p = ref.chaotic_ann_gang_stacked_ref(
        *w3, x0, N_STEPS, off, K4_ROWS, act, lattice)
    assert torch.equal(words, ops.from_uint32(words_p))
    np.testing.assert_array_equal(state_bits(state), state_bits(state_p))


def jax_words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


# each activation, topology and kernel at least once; K3 off the span
@pytest.mark.parametrize("kernel,topology,act,s_block", [
    ("k3", "ring", "tanh", 16), ("k3", "grid", "relu", 48),
    ("k4", "ring", "sigmoid", 40)])
def test_mirror_is_the_jax_lattice_gang_kernel(kernel, topology, act,
                                               s_block):
    """The mirror's words (each block's or core's rows; JAX leaves later
    rows unwritten) and final state, bitwise the JAX package's lattice K3
    / K4 in interpret mode (t_block 4, unroll 1: rows exactly the map's)."""
    if kernel == "k3":
        gang, w, lattice, x0, off = k3_case(topology, s_block, 7)
        words, state = mirror_k3(gang, x0, off, s_block, act)
        words_j, state_j = jax_ann.chaotic_ann_gang_bits_pallas(
            *(jnp.asarray(a.numpy()) for a in w),
            jnp.asarray(x0.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(CORE_MAP), jnp.asarray(off.numpy().astype(np.uint32)),
            jnp.asarray(K3_ROWS), n_steps=N_STEPS, s_block=s_block,
            t_block=4, unroll=1, activation=act, lattice=lattice,
            interpret=True)
        lane_rows = np.repeat(K3_ROWS, s_block)
    else:
        gang, w, lattice, x0, off = k4_case(topology, 8)
        words, state = mirror_k4(gang, x0, off, act)
        words_j, state_j = jax_ann.chaotic_ann_gang_stacked_pallas(
            *(jnp.asarray(a.numpy()) for a in w),
            jnp.asarray(x0.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(off.numpy().astype(np.uint32)), jnp.asarray(K4_ROWS),
            n_steps=N_STEPS, s_block=s_block, t_block=4, unroll=1,
            activation=act, lattice=lattice, interpret=True)
        lane_rows = K4_ROWS[:, None]
    rows = np.arange(N_STEPS // 2).reshape((-1,) + (1,) * (words.ndim - 1))
    asked = rows < lane_rows
    np.testing.assert_array_equal(np.where(asked, words.numpy(), 0),
                                  np.where(asked, jax_words(words_j), 0))
    np.testing.assert_array_equal(
        state_bits(state), np.asarray(state_j).view(np.int16))
