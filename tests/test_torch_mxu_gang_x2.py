"""The mxu K3 on the two-lane row loop (``mxu_x2_gang_bits_kernel``,
``bf16x2_mxu_gang_bits_kernel`` in ``csrc/chaotic_ann.cu``) mirrored on
the CPU.

Each lane runs the two-lane mxu K1's row loop on its lane block's core: a
CTA of 128 threads holds 128 / N lane slots of N node threads, two lanes
a slot, and lies inside one lane block, reading its core and rows.  CTAs
are indexed by (block, CTA within the block), as the bf16x2 lattice K3's
(``GangCta``), so ``s_block`` is any multiple of 128 / N and a block's
last CTA may hold one live half, the other mirroring the block's last
lane.  Here:

* the gang lane-pair map at N = 1, 8 and 32, ``s_block`` on the two-lane
  span 2 * 128 / N and off it, one or several blocks: every lane computed
  and written once, by a thread of its own block; mirrored halves write
  nothing; at N = 1 and ``s_block`` 128 every CTA holds one live half;
* a plain mirror of the two-lane gang row loop (the mxu K1's step, fold
  and word order on each block's core, each slot stopping after its
  block's rows), bitwise ``ref.chaotic_ann_gang_bits_ref(compute_unit=
  "mxu")`` in f32 and bf16 with relu, tanh and sigmoid at 3-8, 4-16,
  chen@ring8 and chen@grid8, padded (every block every row) and ragged
  (0, partial and full blocks), and bitwise the JAX package's mxu K3
  (``chaotic_ann_gang_bits_pallas(compute_unit="mxu")``) in interpret
  mode in three cases.

Every comparison is bitwise: the tolerance is 0.  Torch runs on one
thread here (``test_torch_mxu_x2.one_thread``).  The card holds the
kernels to the plain version (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.kernels import ops, ref
from repro_torch.prng.stream import default_params

from test_torch_lattice_gang_x2 import k3_lane_pairs
from test_torch_mxu_x2 import (DTYPES, M32, Net, fold_bf16x2, fold_f32,
                               one_thread, step_bf16x2, step_f32, xor_all)

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
BASES = ("chen", "chua", "lorenz", "rossler")     # the 3-8 registry systems
CORE_MAP = np.array([2, 0, 3, 1, 1, 2])
ROWS = np.array([0, 3, 9, 1, 9, 2])       # clamped to the launch's rows
# (s_block off the two-lane span, steps) by n_nodes: 128 of a scalar
# core's 256 (one CTA, one live half), at 8 nodes 48 = 32 + 16 (a full CTA
# and a lone half; at 16 lanes XLA's CPU f32 dot, which the JAX kernel's
# interpret mode runs, leaves the forward chain order in its last bits)
S_BLOCK = {1: 128, 8: 48}
STEPS = {1: 8, 8: 4}

one_thread = one_thread                   # the autouse fixture, here too


# ---------------------------------------------------------------------------
# The gang lane-pair map (launch_mxu_gang_bits, GangCta)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_nodes,s_block", [
    (1, 128), (1, 256), (1, 384), (8, 16), (8, 32), (8, 48), (32, 4),
    (32, 8), (32, 12), (32, 128)])
@pytest.mark.parametrize("n_blocks", [1, 5])
def test_gang_lane_pair_map(n_nodes, s_block, n_blocks):
    """Every lane computed by exactly one live half of a slot of its own
    block and written by one thread (node 0 lane a's words, node 1 lane
    b's; at one node the one thread both); a CTA inside one block; a dead
    half mirrors its block's last lane (lane a) or lane a (lane b), so it
    runs its block's core and rows, and writes nothing.  The launcher
    takes whole blocks only (n_lanes a multiple of s_block)."""
    n_lanes = n_blocks * s_block
    m = k3_lane_pairs(n_lanes, s_block, n_nodes)
    node, block = m["node"], m["block"]
    computed = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                               m["lane_b"][m["live_b"] & (node == 0)]])
    assert np.array_equal(np.sort(computed), np.arange(n_lanes))
    writer_b = 1 if n_nodes > 1 else 0
    written = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                              m["lane_b"][m["live_b"] & (node == writer_b)]])
    assert np.array_equal(np.sort(written), np.arange(n_lanes))
    for h in ("a", "b"):
        assert np.array_equal(m[f"lane_{h}"] // s_block, block)
    assert (block.reshape(-1, CTA) == block.reshape(-1, CTA)[:, :1]).all()
    last = block * s_block + s_block - 1
    assert np.array_equal(m["lane_a"][~m["live_a"]], last[~m["live_a"]])
    dead_b = ~m["live_b"]
    assert np.array_equal(m["lane_b"][dead_b], m["lane_a"][dead_b])
    # the share of mirrored halves: every CTA's lane-b half when s_block
    # is an odd multiple of 128 / N and one CTA spans the block
    span = 2 * CTA // n_nodes
    per_block = -(-s_block // span)
    halves = np.concatenate([m["live_a"], m["live_b"]])[::n_nodes]
    assert (~halves).mean() == pytest.approx(1 - s_block / (per_block * span))
    if n_nodes == 1 and s_block == 128:
        assert not m["live_b"].any()


# ---------------------------------------------------------------------------
# The mirror of the two-lane gang row loop
# ---------------------------------------------------------------------------

def gang_nets(shape: str):
    """(per-core params, lattice descriptor or None) of a gang: the four
    3-8 registry nets, two 4-16 nets (hyperlorenz's and a seeded one), or
    the four bases as 8-node lattices sharing chen's coupling operand."""
    if shape == "3-8":
        return [default_params(system=b) for b in BASES], None
    if shape == "4-16":
        rng = np.random.default_rng(18)
        seeded = {k: rng.normal(0.0, sd, dims).astype(np.float32)
                  for k, sd, dims in (("w1", 0.5, (4, 16)), ("b1", 0.1, (16,)),
                                      ("w2", 0.5, (16, 4)), ("b2", 0.1, (4,)))}
        return [default_params(system="hyperlorenz"), seeded], None
    per_core = [dict(default_params(system=f"{b}@{shape}")) for b in BASES]
    for p in per_core[1:]:
        p["coupling"] = per_core[0]["coupling"]   # one shared operand
    return per_core, lattice_meta_tuple(per_core[0]["lattice_meta"])


def mirror_gang(nets, x0, offsets, core_map, rows, s_block, n_steps, act):
    """A K3 launch of the two-lane kernels: ``k3_lane_pairs``'s map, each
    slot running its block's core (``nets[core]``) for its block's rows of
    (step, fold, step, fold), the folds reduced over the slot's nodes,
    ``word_a`` / ``word_b``, counter and finalizer, the live halves
    writing; slots of one core are stepped together and a slot past its
    rows holds its state.  Returns (n_steps // 2, S) int64 words, zero
    past a block's rows, and the (S, I) state."""
    n_lanes, n = x0.shape[0], nets[0].n
    m = k3_lane_pairs(n_lanes, s_block, n)
    slot = {k: torch.from_numpy(v[::n]) for k, v in m.items()}
    core = torch.as_tensor(core_map)[slot["block"]]
    slot_rows = torch.as_tensor(rows)[slot["block"]]
    xs = x0.reshape(n_lanes, n, -1)
    bf16 = x0.dtype == torch.bfloat16
    words = torch.zeros((n_steps // 2, n_lanes), dtype=torch.int64)
    state = torch.empty_like(xs)
    for c in torch.unique(core).tolist():
        sel = core == c
        net = nets[c]
        a, b = slot["lane_a"][sel], slot["lane_b"][sel]
        live_a, live_b = slot["live_a"][sel], slot["live_b"][sel]
        my_rows = slot_rows[sel]
        if bf16:
            bits = xs.view(torch.int16).to(torch.int64) & 0xFFFF
            x2 = bits[a] | bits[b] << 16
        else:
            xa, xb = xs[a].float(), xs[b].float()
        for r in range(int(my_rows.max())):
            run = (my_rows > r)[:, None, None]
            if bf16:
                n1 = step_bf16x2(net, x2, act)
                hi = xor_all(fold_bf16x2(net, n1)[0], 1)
                n2 = step_bf16x2(net, n1, act)
                lo, over = (xor_all(v, 1) for v in fold_bf16x2(net, n2))
                x2 = torch.where(run, n2, x2)
            else:
                a1, b1 = step_f32(net, xa, xb, act)
                hi = xor_all(fold_f32(net, a1, b1)[0], 1)
                a2, b2 = step_f32(net, a1, b1, act)
                lo, over = (xor_all(v, 1) for v in fold_f32(net, a2, b2))
                xa, xb = torch.where(run, a2, xa), torch.where(run, b2, xb)
            word_a = ((hi << 16) | (lo & 0xFFFF) | (over << 16)) & M32
            word_b = (hi & 0xFFFF0000) | (lo >> 16) | (over & 0xFFFF0000)
            for word, lanes, live in ((word_a, a, live_a),
                                      (word_b, b, live_b)):
                w = live & run[:, 0, 0]
                ctr = (offsets[lanes[w]] + r) & M32
                words[r, lanes[w]] = ops._finalize_words(
                    word[w] ^ ops._mul32(ctr, 0x9E3779B9))
        if bf16:
            for half, lanes, live in ((x2 & 0xFFFF, a, live_a),
                                      (x2 >> 16, b, live_b)):
                v = torch.where(half >= 1 << 15, half - (1 << 16), half)
                state[lanes[live]] = v[live].to(torch.int16).view(
                    torch.bfloat16)
        else:
            state[a[live_a]] = xa[live_a]
            state[b[live_b]] = xb[live_b]
    return words, state.reshape(n_lanes, -1)


def gang_case(shape: str, tag: str, ragged: bool, seed: int):
    """Operands of one gang launch: nets, stacked weights, descriptor,
    coupling, x0 and offsets (wrapping mid-run), the core map and each
    block's rows (every row when padded)."""
    per_core, lattice = gang_nets(shape)
    n = lattice[0] if lattice else 1
    dtype = DTYPES[tag][0]
    nets = [Net(p, dtype, lattice) for p in per_core]
    w = [torch.from_numpy(np.stack([np.asarray(p[k], np.float32)
                                    for p in per_core])) for k in KEYS]
    cpl = None if lattice is None else torch.from_numpy(per_core[0]["coupling"])
    core_map = CORE_MAP % len(per_core)
    n_steps, s_block = STEPS[n], S_BLOCK[n]
    rows = (np.minimum(ROWS, n_steps // 2) if ragged
            else np.full(len(core_map), n_steps // 2))
    rng = np.random.default_rng(seed)
    n_lanes = len(core_map) * s_block
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_lanes, w[0].shape[1]))
                          .astype(np.float32)).to(dtype)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off[:2] = [0xFFFFFFFF, 0xFFFFFFFE]           # the counter wraps mid-run
    return (nets, w, lattice, cpl, x0, torch.from_numpy(off), core_map,
            rows, s_block, n_steps)


def state_bits(x: torch.Tensor) -> torch.Tensor:
    return x.float().view(torch.int32)


@pytest.mark.parametrize("layout", ["padded", "ragged"])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", ["3-8", "4-16", "ring8", "grid8"])
def test_mirror_is_the_plain_mxu_k3(shape, act, tag, layout):
    """The mirror's words (zero past a block's rows) and final state,
    bitwise ``ref.chaotic_ann_gang_bits_ref(compute_unit="mxu")``; a
    0-row block keeps x0 and writes no word."""
    (nets, w, lattice, cpl, x0, off, core_map, rows, s_block,
     n_steps) = gang_case(shape, tag, layout == "ragged",
                          len(shape) + len(act) + len(tag))
    words, state = mirror_gang(nets, x0, off, core_map, rows, s_block,
                               n_steps, act)
    words_p, state_p = ref.chaotic_ann_gang_bits_ref(
        *w, x0, core_map, n_steps, off, rows, act, lattice, "mxu", cpl)
    assert torch.equal(words, ops.from_uint32(words_p))
    assert torch.equal(state_bits(state), state_bits(state_p))
    if layout == "ragged":
        assert torch.equal(state_bits(state[:s_block]),
                           state_bits(x0[:s_block]))
        assert not words[:, :s_block].any()


@pytest.mark.parametrize("shape,act,tag,layout", [
    ("3-8", "tanh", "f32", "ragged"), ("ring8", "sigmoid", "bf16", "ragged"),
    ("grid8", "relu", "f32", "padded")])
def test_mirror_is_the_jax_mxu_k3(shape, act, tag, layout):
    """The mirror's words (each block's rows; JAX leaves later rows
    unwritten) and final state, bitwise the JAX package's mxu K3 in
    interpret mode (t_block = n_steps, unroll 1: rows exactly the map's),
    s_block off the two-lane span."""
    (nets, w, lattice, cpl, x0, off, core_map, rows, s_block,
     n_steps) = gang_case(shape, tag, layout == "ragged", 11)
    words, state = mirror_gang(nets, x0, off, core_map, rows, s_block,
                               n_steps, act)
    jdt = DTYPES[tag][1]
    words_j, state_j = jax_ann.chaotic_ann_gang_bits_pallas(
        *(jnp.asarray(a.numpy()) for a in w),
        jnp.asarray(x0.float().numpy()).astype(jdt), jnp.asarray(core_map),
        jnp.asarray(off.numpy().astype(np.uint32)),
        jnp.asarray(rows, jnp.int32),
        None if cpl is None else jnp.asarray(cpl.numpy()), n_steps=n_steps,
        s_block=s_block, t_block=n_steps, unroll=1, activation=act,
        compute_unit="mxu", lattice=lattice, interpret=True)
    asked = np.arange(n_steps // 2)[:, None] < np.repeat(rows, s_block)
    np.testing.assert_array_equal(
        np.where(asked, words.numpy(), 0),
        np.where(asked, np.asarray(words_j).astype(np.int64), 0))
    np.testing.assert_array_equal(
        state_bits(state).numpy(),
        np.asarray(state_j.astype(jnp.float32)).view(np.int32))
