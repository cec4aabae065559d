"""The scalar bf16 K2 on the bf16x2 step (``bf16x2_traj_kernel`` in
``csrc/chaotic_ann.cu``) and the staged stores every two-lane K2 shares
(``TrajStore``), mirrored on the CPU.

The kernel runs the scalar bf16 K1's lanes and step: a CTA of 128 threads
covers 256 lanes, thread t lanes t and t + 128 of them (``LanePair<1>``, a
lane past n_lanes mirrored), both lanes packed in one register a
component, each step one ``step2`` of packed bf16x2 ops.  A CTA's values of
a step are one contiguous run of the (n_steps, S, I) trajectory; each warp
puts its share, two runs of 32 * D values (its lane-a lanes', its lane-b
lanes'), in shared memory and copies them out in 16-byte chunks.  A scalar
lane's values, 6 or 8 bytes, make chunks straddle lanes, and a step's
values start on a chunk only where n_lanes * I * 2 is a multiple of 16:
the stage holds each run shifted by the step's offset into a chunk, whole
chunks of live values go out in one 16-byte store, a run's first and last
chunk value by value.  Here:

* the launcher's lane-pair map at 1-257 lanes;
* the store map of ``TrajStore`` in bf16 (the scalar K2 at 3-8 and 4-16,
  the lattice K2 at 8 and 32 nodes), at lane counts whose step stride is
  not 16-byte aligned and with a ragged last CTA: every (step, lane,
  component) written exactly once, from the stage place its thread put it
  at, every 16-byte store aligned and of live values only, nothing past
  n_lanes, value-by-value stores only where a step may start mid-chunk;
* a plain mirror of the kernel's loop in its op and store order, bitwise
  ``ref.chaotic_ann_ref`` in bf16 for relu, tanh and sigmoid at 3-8 and
  4-16, and bitwise the JAX package's ``chaotic_ann_pallas`` in interpret
  mode in three cases.

Every comparison is bitwise: the tolerance is 0.  The card holds the
kernel to the plain version (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.kernels import chaotic_ann, ref
from repro_torch.prng.stream import default_params

from test_torch_bf16_ops import _mirror_step
from test_torch_mxu_x2 import lane_pairs

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
SHAPES = {"3-8": "chen", "4-16": "hyperlorenz"}
# odd lane counts (a ragged last CTA; at 3-8 steps that start mid-chunk),
# a whole CTA and a step stride that is a multiple of 16 bytes
LANES = (1, 2, 3, 5, 13, 17, 37, 64, 65, 129, 255, 256, 257)


# ---------------------------------------------------------------------------
# TrajStore, the staged stores of every two-lane K2
# ---------------------------------------------------------------------------

def traj_store(n_lanes: int, n_nodes: int, d: int, itemsize: int) -> dict:
    """``TrajStore``'s constants and the copy slots of every thread of the
    launch, (threads, kCopies) arrays as its constructor computes them:
    each slot's chunk j of the warp's stage, its run's live values
    (``live``), the chunk's first value in its run (``first``) and its
    chunk of the trajectory at step 0 with no shift (``out``)."""
    kv = 16 // itemsize
    i_dim, k_run = n_nodes * d, 32 * d
    k_shift = i_dim * itemsize % 16 != 0
    k_chunks = k_run // kv + int(k_shift)
    k_copies = -(-2 * k_chunks // 32)
    slots = CTA // n_nodes
    grid = -(-n_lanes // (2 * slots))
    t = np.arange(grid * CTA)
    cta, tid = t // CTA, t % CTA
    warp, lane = tid // 32, tid % 32
    j = lane[:, None] + 32 * np.arange(k_copies)
    h, q = j // k_chunks, j % k_chunks
    run_lane = (cta[:, None] * 2 * slots + h * slots
                + warp[:, None] * (32 // n_nodes))
    left = n_lanes - run_lane
    live = np.where((j >= 2 * k_chunks) | (left <= 0), 0,
                    np.minimum(left, 32 // n_nodes) * i_dim)
    assert (run_lane * i_dim % kv == 0).all()
    return dict(kv=kv, i_dim=i_dim, d=d, k_shift=k_shift, k_chunks=k_chunks,
                k_copies=k_copies, n_lanes=n_lanes, n_threads=t.size,
                j=j, live=live, first=q * kv, out=run_lane * i_dim // kv + q)


def step_offsets(s: dict, n_steps: int):
    """(base, shift) of each step as ``copy`` advances them: base the
    chunks and shift the values past a chunk boundary of the step's first
    value, from n_lanes * I = step_q chunks + step_r values a step."""
    step_q, step_r = divmod(s["n_lanes"] * s["i_dim"], s["kv"])
    base, shift, out = 0, 0, []
    for _ in range(n_steps):
        out.append((base, shift))
        base += step_q
        if s["k_shift"]:
            shift += step_r
            if shift >= s["kv"]:
                shift -= s["kv"]
                base += 1
    return out


def store_step(s: dict, vals_a: np.ndarray, vals_b: np.ndarray, base: int,
               shift: int):
    """One step of ``TrajStore``: every thread puts its D values of lane a
    and of lane b (``vals_*``: (threads, D)) into its warp's stage at
    lane * D + shift + k of run 0 and run 1, then every copy slot writes
    its chunk: a chunk of live values alone as one 16-byte store, a
    partial chunk (only where a step may start mid-chunk) value by value,
    its live values only.  Returns the trajectory value indices written,
    the values, and the 16-byte stores' first value indices."""
    kv, d, k_chunks = s["kv"], s["d"], s["k_chunks"]
    n_threads = s["n_threads"]
    stage = np.full((n_threads // 32, 2 * k_chunks * kv), -1, np.int64)
    t = np.arange(n_threads)
    pos = (t % 32)[:, None] * d + shift + np.arange(d)
    stage[(t // 32)[:, None], pos] = vals_a
    stage[(t // 32)[:, None], k_chunks * kv + pos] = vals_b
    rel = s["first"] - shift
    live = s["live"]
    whole = (rel >= 0) & (rel + kv <= live)
    dst, val = [], []
    for i in range(kv):
        keep = whole | (s["k_shift"] & (rel + i >= 0) & (rel + i < live))
        thread, slot = np.nonzero(keep)
        chunk = s["out"][thread, slot] + base
        dst.append(chunk * kv + i)
        val.append(stage[thread // 32, s["j"][thread, slot] * kv + i])
    thread, slot = np.nonzero(whole)
    chunk_starts = (s["out"][thread, slot] + base) * kv
    return np.concatenate(dst), np.concatenate(val), chunk_starts


def thread_values(n_lanes: int, n_nodes: int, d: int):
    """Each thread's lane-a and lane-b components as the trajectory's
    value indices (lane * I + node * D + k, step 0): its live lanes' own,
    a mirror's its mirrored lane's."""
    m = lane_pairs(n_lanes, n_nodes)
    i_dim = n_nodes * d
    comp = m["node"][:, None] * d + np.arange(d)
    return m, m["lane_a"][:, None] * i_dim + comp, (m["lane_b"][:, None]
                                                   * i_dim + comp)


def check_store_map(n_lanes: int, n_nodes: int, d: int, itemsize: int,
                    n_steps: int = 9):
    """Puts each value's own trajectory index and copies n_steps steps
    (n_steps covers every offset into a chunk): every value of every step
    lands at its own index exactly once, nothing past the trajectory,
    every 16-byte store aligned (the base is), value-by-value stores only
    where a step may start mid-chunk."""
    s = traj_store(n_lanes, n_nodes, d, itemsize)
    _, va, vb = thread_values(n_lanes, n_nodes, d)
    step_vals = n_lanes * s["i_dim"]
    count = np.zeros(n_steps * step_vals, np.int64)
    n_whole = n_narrow = 0
    for t, (base, shift) in enumerate(step_offsets(s, n_steps)):
        assert base * s["kv"] + shift == t * step_vals
        dst, val, starts = store_step(s, va, vb, base, shift)
        assert ((dst >= t * step_vals) & (dst < (t + 1) * step_vals)).all()
        assert np.array_equal(val, dst - t * step_vals)
        np.add.at(count, dst, 1)
        assert (starts * itemsize % 16 == 0).all()
        n_whole += starts.size
        n_narrow += dst.size - starts.size * s["kv"]
    assert (count == 1).all()
    if not s["k_shift"]:
        assert n_narrow == 0
    return s, n_whole, n_narrow


@pytest.mark.parametrize("n_lanes", LANES)
def test_lane_pair_map(n_lanes):
    """``LanePair<1>``: each lane the live half of exactly one thread,
    thread t of CTA c lanes 256 c + t and 256 c + 128 + t; a dead half
    mirrors a live lane (lane a the last lane, lane b lane a)."""
    m = lane_pairs(n_lanes, 1)
    computed = np.concatenate([m["lane_a"][m["live_a"]],
                               m["lane_b"][m["live_b"]]])
    assert np.array_equal(np.sort(computed), np.arange(n_lanes))
    live = m["live_a"]
    assert np.array_equal(m["lane_a"][live], 256 * m["cta"][live]
                          + m["tid"][live])
    assert (m["lane_a"][~m["live_a"]] == n_lanes - 1).all()
    dead_b = ~m["live_b"]
    assert np.array_equal(m["lane_b"][dead_b], m["lane_a"][dead_b])
    assert np.array_equal(m["lane_b"][m["live_b"]],
                          m["lane_a"][m["live_b"]] + 128)


@pytest.mark.parametrize("n_nodes,d", [(1, 3), (1, 4), (8, 3), (32, 3)])
@pytest.mark.parametrize("n_lanes", LANES)
def test_store_map_bf16(n_lanes, n_nodes, d):
    """The bf16 K2s' stores (scalar 3-8, 4-16; lattice at 8 and 32 nodes):
    every value once, at its place; 16-byte stores aligned."""
    check_store_map(n_lanes, n_nodes, d, 2)


def test_store_map_constants_and_narrow_stores():
    """The stage sizes: a warp's two runs are 12 + 12 chunks at 3-8 and
    16 + 16 at 4-16, each with one more where a step may start mid-chunk
    (a lane's 6 or 8 bytes), one chunk a thread but at 4-16 (34: two for
    some); 12 + 12 at a lattice (48 or 192 bytes a lane), no shift.
    Narrow stores come only at lane counts whose step stride is not a
    multiple of 16 bytes: at 3-8 where n_lanes % 8, at 4-16 where it is
    odd; the main path's 65,536 lanes make none."""
    for n_nodes, d, chunks, shift, copies in ((1, 3, 12, True, 1),
                                              (1, 4, 16, True, 2),
                                              (8, 3, 12, False, 1),
                                              (32, 3, 12, False, 1)):
        s = traj_store(1, n_nodes, d, 2)
        assert (s["k_chunks"], s["k_shift"], s["k_copies"]) == (
            chunks + shift, shift, copies)
    for d, n_lanes, narrow in ((3, 37, True), (3, 64, False), (3, 68, True),
                               (4, 37, True), (4, 38, False)):
        assert (check_store_map(n_lanes, 1, d, 2)[2] > 0) == narrow
    s = traj_store(65_536, 1, 3, 2)
    assert step_offsets(s, 3) == [(0, 0), (24_576, 0), (49_152, 0)]


# ---------------------------------------------------------------------------
# The mirror of the kernel's loop
# ---------------------------------------------------------------------------

def bits16(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy().astype(np.int64) & 0xFFFF


def mirror_traj(w, x0: torch.Tensor, n_steps: int, act: str) -> torch.Tensor:
    """The kernel's launch: the lane pairs, ``step2`` on both lanes (in
    plain bf16 ops, the rewrites included: ``_mirror_step``), and each
    step's stores as ``TrajStore`` makes them.  Returns the (n_steps, S,
    I) bf16 trajectory; a value no store wrote fails."""
    n_lanes, i_dim = x0.shape
    m = lane_pairs(n_lanes, 1)
    s = traj_store(n_lanes, 1, i_dim, 2)
    xa = x0[torch.from_numpy(m["lane_a"])]
    xb = x0[torch.from_numpy(m["lane_b"])]
    traj = np.full(n_steps * n_lanes * i_dim, -1, np.int64)
    for t, (base, shift) in enumerate(step_offsets(s, n_steps)):
        xa = _mirror_step(xa, *w, act)
        xb = _mirror_step(xb, *w, act)
        dst, val, _ = store_step(s, bits16(xa), bits16(xb), base, shift)
        traj[dst] = val
    assert (traj >= 0).all()
    traj = np.where(traj >= 1 << 15, traj - (1 << 16), traj)
    return torch.from_numpy(traj.astype(np.int16)).view(
        torch.bfloat16).reshape(n_steps, n_lanes, i_dim)


def case(shape: str, n_lanes: int, seed: int):
    p = default_params(system=SHAPES[shape])
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_lanes, p["w1"].shape[0]))
                          .astype(np.float32)).to(torch.bfloat16)
    return p, [torch.from_numpy(p[k]).to(torch.bfloat16) for k in KEYS], x0


def state_bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy()


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape,n_lanes", [("3-8", 37), ("3-8", 261),
                                           ("4-16", 37), ("4-16", 261)])
def test_mirror_is_the_plain_k2(shape, n_lanes, act):
    """The mirror's trajectory, bitwise ``ref.chaotic_ann_ref`` in bf16 and
    the wrapper on the CPU (the plain version), 16 steps, at lane counts
    whose steps start mid-chunk (37: a lone ragged CTA; 261: a full CTA
    and five lanes)."""
    p, wb, x0 = case(shape, n_lanes, n_lanes + len(act))
    got = mirror_traj(wb, x0, 16, act)
    w = [torch.from_numpy(p[k]) for k in KEYS]
    want = ref.chaotic_ann_ref(*w, x0, 16, act)
    np.testing.assert_array_equal(state_bits(got), state_bits(want))
    plain = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=16, activation=act)
    np.testing.assert_array_equal(state_bits(got), state_bits(plain))


@pytest.mark.parametrize("shape,act", [("3-8", "relu"), ("4-16", "tanh"),
                                       ("3-8", "sigmoid")])
def test_mirror_is_the_jax_k2(shape, act):
    """The mirror's trajectory bitwise the JAX package's K2
    (``chaotic_ann_pallas``) in interpret mode, 37 lanes, 8 steps."""
    p, wb, x0 = case(shape, 37, 3)
    got = mirror_traj(wb, x0, 8, act)
    want = jax_ann.chaotic_ann_pallas(
        *(jnp.asarray(p[k]) for k in KEYS),
        jnp.asarray(x0.float().numpy()).astype(jnp.bfloat16), n_steps=8,
        s_block=128, t_block=8, unroll=1, activation=act, interpret=True)
    np.testing.assert_array_equal(state_bits(got),
                                  np.asarray(want).view(np.int16))
