"""The mxu K2 on two lanes a thread (``mxu_x2_traj_kernel``,
``bf16x2_mxu_traj_kernel`` in ``csrc/chaotic_ann.cu``) mirrored on the CPU.

The kernels run the two-lane mxu K1's lane pairs, prologue and step: a
CTA of 128 threads holds 128 / N lane slots of N node threads, slot s lanes
s and s + 128 / N of the CTA's range, a half whose lane does not exist
mirroring a live lane; each step one ``mxu_step_x2`` (f32) or
``mxu_step_bf16x2`` (bf16, both lanes packed).  Each warp puts its lanes'
values of a step in shared memory and copies them out in 16-byte chunks
(``TrajStore``, whose bf16 store map ``tests/test_torch_traj_x2.py``
holds); in f32 a warp's two runs are 2 x 24 chunks (2 x 25 at 3-8, where a
step may start mid-chunk; 2 x 32 at 4-16), so some threads copy two.
Here:

* the launcher's lane-pair map at 1-257 lanes, 1, 8 and 32 nodes: every
  (lane, component) put by exactly one live half;
* the f32 store map at the same lane counts, odd ones whose step stride is
  not 16-byte aligned and a ragged last CTA: every (step, lane,
  component) written exactly once, 16-byte stores aligned, nothing past
  n_lanes;
* a plain mirror of the kernels' loop in their op and store order,
  bitwise ``ref.chaotic_ann_ref(compute_unit="mxu")`` for relu, tanh and
  sigmoid, f32 and bf16, at 3-8, 4-16, chen@ring8, chen@grid8 and a few
  chen@ring32 steps, and bitwise the JAX package's mxu
  ``chaotic_ann_pallas`` in interpret mode in three cases (s_block 128:
  XLA's CPU f32 dot keeps the forward chain there).

Every comparison is bitwise: the tolerance is 0.  The card holds the
kernels to the plain version (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.kernels import chaotic_ann, ref

from test_torch_mxu_x2 import (DTYPES, Net, bits_f32, f32_bits, lane_pairs,
                               one_thread, operands, plain_kw, state_bits,
                               step_bf16x2, step_f32)
from test_torch_traj_x2 import (LANES, check_store_map, step_offsets,
                                store_step, thread_values, traj_store)

KEYS = ("w1", "b1", "w2", "b2")
# the mirror's shapes (MXU_SHAPES but grid32) and steps by n_nodes: the
# plain f32 chains of a lattice are hundreds of small ops a step
SHAPES = ("3-8", "4-16", "ring8", "grid8", "ring32")
STEPS = {1: 12, 8: 4, 32: 2}

one_thread = one_thread                   # the autouse fixture, here too


@pytest.mark.parametrize("n_nodes", [1, 8, 32])
@pytest.mark.parametrize("n_lanes", LANES)
def test_lane_pair_map_puts_every_value_once(n_lanes, n_nodes):
    """``LanePair(n_lanes)``: the live halves' threads put each (lane,
    component) of a step exactly once; a dead half mirrors a live lane,
    so it computes (and puts) a live lane's values at a dead lane's
    place, which no store copies."""
    m, va, vb = thread_values(n_lanes, n_nodes, 3)
    put = np.concatenate([va[m["live_a"]].ravel(), vb[m["live_b"]].ravel()])
    assert np.array_equal(np.sort(put), np.arange(n_lanes * n_nodes * 3))
    assert (m["lane_a"][~m["live_a"]] == n_lanes - 1).all()
    dead_b = ~m["live_b"]
    assert np.array_equal(m["lane_b"][dead_b], m["lane_a"][dead_b])


@pytest.mark.parametrize("n_nodes,d", [(1, 3), (1, 4), (8, 3), (32, 3)])
@pytest.mark.parametrize("n_lanes", LANES)
def test_store_map_f32(n_lanes, n_nodes, d):
    """The f32 mxu K2's stores at 3-8, 4-16 and 8 and 32 nodes: every
    value once, at its place; 16-byte stores aligned."""
    check_store_map(n_lanes, n_nodes, d, 4)


def test_store_map_f32_constants():
    """A warp's two f32 runs: 24 + 24 chunks at a 3-D lattice and 25 + 25
    at 3-8 (a lane's 12 bytes: a step may start mid-chunk), 32 + 32 at 4-16
    (16 bytes a lane, whole chunks): two chunks for some threads, or all.
    Narrow stores at 3-8 only where n_lanes % 4."""
    for n_nodes, d, chunks, shift in ((1, 3, 25, True), (1, 4, 32, False),
                                      (8, 3, 24, False), (32, 3, 24, False)):
        s = traj_store(1, n_nodes, d, 4)
        assert (s["k_chunks"], s["k_shift"], s["k_copies"]) == (chunks, shift,
                                                                 2)
    for d, n_lanes, narrow in ((3, 37, True), (3, 36, False), (4, 37, False)):
        assert (check_store_map(n_lanes, 1, d, 4)[2] > 0) == narrow


def mirror_traj(net: Net, x0: torch.Tensor, n_steps: int,
                act: str) -> torch.Tensor:
    """The kernels' launch: the lane pairs, the two-lane step of both lanes
    (``step_f32`` / ``step_bf16x2``, the K1's mirror), and each step's
    stores as ``TrajStore`` makes them.  Returns the (n_steps, S, I)
    trajectory in x0's dtype; a value no store wrote fails."""
    n_lanes = x0.shape[0]
    m = lane_pairs(n_lanes, net.n)
    a = torch.from_numpy(m["lane_a"][::net.n])            # per slot
    b = torch.from_numpy(m["lane_b"][::net.n])
    xs = x0.reshape(n_lanes, net.n, net.d)
    bf16 = net.dtype == torch.bfloat16
    s = traj_store(n_lanes, net.n, net.d, 2 if bf16 else 4)
    if bf16:
        bits = xs.view(torch.int16).to(torch.int64) & 0xFFFF
        x2 = bits[a] | bits[b] << 16
    else:
        xa, xb = xs[a].float(), xs[b].float()
    traj = np.full(n_steps * n_lanes * net.n * net.d, -1, np.int64)
    for t, (base, shift) in enumerate(step_offsets(s, n_steps)):
        if bf16:
            x2 = step_bf16x2(net, x2, act)
            va, vb = x2 & 0xFFFF, x2 >> 16
        else:
            xa, xb = step_f32(net, xa, xb, act)
            va, vb = f32_bits(xa), f32_bits(xb)
        dst, val, _ = store_step(s, va.reshape(-1, net.d).numpy(),
                                 vb.reshape(-1, net.d).numpy(), base, shift)
        traj[dst] = val
    assert (traj >= 0).all()
    shape = (n_steps, n_lanes, net.n * net.d)
    if bf16:
        traj = np.where(traj >= 1 << 15, traj - (1 << 16), traj)
        return torch.from_numpy(traj.astype(np.int16)).view(
            torch.bfloat16).reshape(shape)
    return bits_f32(torch.from_numpy(traj)).reshape(shape)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_is_the_plain_mxu_k2(shape, act, tag):
    """The mirror's trajectory, bitwise ``ref.chaotic_ann_ref`` on the mxu
    unit and the wrapper on the CPU (the plain version), at odd lane
    counts (261 lanes of a scalar core: steps that start mid-chunk in f32
    and bf16 at 3-8, in bf16 at 4-16; 37 at 8 nodes, 13 at 32: a ragged
    last CTA, lane-b halves partly live)."""
    dtype = DTYPES[tag][0]
    p, lattice, x0, _ = operands(shape, dtype, len(shape) + len(act))
    net = Net(p, dtype, lattice)
    n_steps = STEPS[net.n]
    got = mirror_traj(net, x0, n_steps, act)
    w = [torch.from_numpy(p[k]) for k in KEYS]
    kw = plain_kw(p, lattice)
    want = ref.chaotic_ann_ref(*w, x0, n_steps, act, **kw)
    assert torch.equal(state_bits(got), state_bits(want))
    plain = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=n_steps,
                                         activation=act, **kw)
    assert torch.equal(state_bits(got), state_bits(plain))


@pytest.mark.parametrize("shape,act,tag", [("3-8", "tanh", "f32"),
                                           ("ring8", "relu", "bf16"),
                                           ("grid8", "sigmoid", "f32")])
def test_mirror_is_the_jax_mxu_k2(shape, act, tag):
    """The mirror's trajectory bitwise the JAX package's mxu K2
    (``chaotic_ann_pallas(compute_unit="mxu")``) in interpret mode, 37
    lanes in one 128-lane block, 4 steps."""
    dtype, jdt = DTYPES[tag]
    p, lattice, x0, _ = operands(shape, dtype, 9)
    x0 = x0[:37].contiguous()
    got = mirror_traj(Net(p, dtype, lattice), x0, 4, act)
    jcpl = None if lattice is None else jnp.asarray(p["coupling"])
    want = jax_ann.chaotic_ann_pallas(
        *(jnp.asarray(p[k]) for k in KEYS),
        jnp.asarray(x0.float().numpy()).astype(jdt), jcpl, n_steps=4,
        s_block=128, t_block=4, unroll=1, activation=act, compute_unit="mxu",
        lattice=lattice, interpret=True)
    np.testing.assert_array_equal(
        state_bits(got).numpy(),
        np.asarray(want.astype(jnp.float32)).view(np.int32))
