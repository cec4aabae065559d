"""The bf16 lattice K2 on the bf16x2 step (``bf16x2_lattice_traj_kernel`` in
``csrc/chaotic_ann.cu``) mirrored on the CPU.

The kernel runs the bf16x2 lattice K1's lane pairs and step: a CTA of 128
threads holds 128 / N lane slots of N node threads, slot s lanes s and
s + 128 / N of the CTA's 2 * 128 / N lanes, both lanes packed in one
register a component, every add, subtract and multiply one
``add/sub/mul.rn.bf16x2``.  A CTA's values of a step are one contiguous
run of the (n_steps, S, I) trajectory; each warp stages its share, two
runs of 32 * D values (its lane-a lanes', its lane-b lanes'), in shared
memory and copies them out in 16-byte chunks, one a thread, a chunk whose
lane does not exist left unwritten.  Here:

* the launcher's lane-pair map at 1-257 lanes and 8 and 32 nodes: every
  lane computed by one live half, the mirrors' lanes live lanes;
* the store map, the ragged last CTA included: every (step, lane,
  component) written exactly once, by the chunk that holds the thread's
  staged value, each chunk 16-byte aligned, inside its CTA's run and
  inside one lane's values;
* a plain mirror of the two-lane trajectory loop in the kernel's op and
  store order, bitwise ``ref.chaotic_ann_ref`` in bf16 for relu, tanh and
  sigmoid at chen@ring8 and chen@grid8 (a ragged lane count) and for a few
  chen@ring32 steps, and bitwise the JAX package's ``chaotic_ann_pallas``
  (its vpu lattice form) in interpret mode in three cases.

Every comparison is bitwise: the tolerance is 0.  The card holds the
kernel to the plain version (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.kernels import chaotic_ann, ref
from repro_torch.prng.stream import default_params

from test_torch_lattice_gang_x2 import (LatticeGang, bf16_bits_of,
                                        lattice_step2, state_bits)
from test_torch_mxu_x2 import lane_pairs

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
D = 3                                     # the chen base's state dim


# ---------------------------------------------------------------------------
# The lane-pair map and the store map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_nodes", [8, 32])
@pytest.mark.parametrize("n_lanes", [1, 2, 3, 5, 13, 17, 33, 37, 129, 257])
def test_lane_pair_map(n_lanes, n_nodes):
    """The K1's map (``LanePair(n_lanes)``): each lane the live half of
    exactly one slot; a dead half mirrors a live lane (lane a the last
    lane, lane b lane a), so it computes a live lane's values."""
    m = lane_pairs(n_lanes, n_nodes)
    node = m["node"]
    computed = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                               m["lane_b"][m["live_b"] & (node == 0)]])
    assert np.array_equal(np.sort(computed), np.arange(n_lanes))
    assert (m["lane_a"][~m["live_a"]] == n_lanes - 1).all()
    dead_b = ~m["live_b"]
    assert np.array_equal(m["lane_b"][dead_b], m["lane_a"][dead_b])


def store_map(n_lanes: int, n_nodes: int) -> dict:
    """Every copying thread's chunk of a step, as the kernel computes it:
    its CTA, warp and thread lane, the run it copies (0: the warp's lane-a
    lanes, 1: lane-b), the chunk, the chunk's lane (``copies`` when that
    lane exists) and the chunk's first value in the step's (S * I) values;
    and, per staged value, the thread that staged it (its slot's lanes
    from ``lane_pairs``) and the chunk value it lands on."""
    slots, i_dim = CTA // n_nodes, n_nodes * D
    k_run, k_chunks = 32 * D, 32 * D // 8
    grid = -(-n_lanes // (2 * slots))
    t = np.arange(grid * CTA)
    cta, tid = t // CTA, t % CTA
    warp, lane = tid // 32, tid % 32
    half, chunk = lane // k_chunks, lane % k_chunks
    run_lane = cta * 2 * slots + half * slots + warp * (32 // n_nodes)
    chunk_lane = run_lane + chunk * 8 // i_dim
    copier = lane < 2 * k_chunks
    return dict(cta=cta, warp=warp, lane=lane, half=half, chunk=chunk,
                run_lane=run_lane, chunk_lane=chunk_lane,
                copies=copier & (chunk_lane < n_lanes), copier=copier,
                first=run_lane * i_dim + chunk * 8, k_run=k_run,
                k_chunks=k_chunks, slots=slots, i_dim=i_dim)


@pytest.mark.parametrize("n_nodes", [8, 32])
@pytest.mark.parametrize("n_lanes", [1, 3, 5, 13, 17, 37, 64, 65, 257])
def test_store_map_writes_every_value_once(n_lanes, n_nodes):
    """Each (lane, component) of a step lands in exactly one copied chunk,
    at the place the staging thread's own lane and component have in the
    trajectory; every chunk is 16-byte aligned (the trajectory's base is),
    inside its CTA's run of 2 * 128 / N lanes and inside one lane's
    values; a chunk whose lane does not exist (the ragged last CTA) is not
    copied, and no copied chunk holds a mirror's value."""
    s = store_map(n_lanes, n_nodes)
    i_dim, k_run, k_chunks = s["i_dim"], s["k_run"], s["k_chunks"]
    cp = s["copies"]
    first = s["first"][cp]
    # 16-byte chunks of bf16 values: aligned, inside one lane and the CTA
    assert (first * 2 % 16 == 0).all()
    assert np.array_equal(first // i_dim, s["chunk_lane"][cp])
    assert np.array_equal((first + 7) // i_dim, s["chunk_lane"][cp])
    cta_lanes = 2 * s["slots"]
    assert (first >= s["cta"][cp] * cta_lanes * i_dim).all()
    assert (first + 8 <= (s["cta"][cp] + 1) * cta_lanes * i_dim).all()
    # every value of the step written exactly once
    written = np.zeros(n_lanes * i_dim, np.int64)
    np.add.at(written, (first[:, None] + np.arange(8)).ravel(), 1)
    assert (written == 1).all()
    # staging: thread (lane l of its warp, node) puts component k of lane
    # a at run 0, position l * D + k, of lane b at run 1; that position's
    # chunk and offset land it at (lane, node * D + k) of the trajectory
    m = lane_pairs(n_lanes, n_nodes)
    l, warp, cta = m["tid"] % 32, m["tid"] // 32, m["cta"]
    copied = {}
    for c, w, h, ch, f in zip(s["cta"][cp], s["warp"][cp], s["half"][cp],
                              s["chunk"][cp], first):
        copied[(c, w, h, ch)] = f
    for h, lanes, live in ((0, m["lane_a"], m["live_a"]),
                           (1, m["lane_b"], m["live_b"])):
        for k in range(D):
            pos = l * D + k
            assert (pos < k_run).all()
            for i in np.nonzero(live)[0]:
                f = copied[(cta[i], warp[i], h, pos[i] // 8)]
                assert f + pos[i] % 8 == (lanes[i] * i_dim
                                          + m["node"][i] * D + k)
            for i in np.nonzero(~live)[0]:
                assert (cta[i], warp[i], h, pos[i] // 8) not in copied


def test_store_map_chunks_a_lane_exactly():
    """At the compiled shapes a lane's values of a step are whole 16-byte
    chunks (48 bytes at 8 nodes, 192 at 32), the kernel's static_assert;
    a warp's two runs are 12 chunks each, copied by 24 threads."""
    for n_nodes, bytes_ in ((8, 48), (32, 192)):
        s = store_map(1, n_nodes)
        assert s["i_dim"] * 2 == bytes_ and bytes_ % 16 == 0
        assert s["k_chunks"] == 12 and s["copier"].reshape(-1, 32).sum(1)[0] == 24


# ---------------------------------------------------------------------------
# The mirror of the two-lane trajectory loop
# ---------------------------------------------------------------------------

def mirror_traj(gang: LatticeGang, x0: torch.Tensor, n_steps: int,
                act: str) -> torch.Tensor:
    """The kernel's launch: the lane pairs, ``lattice_step2`` on both
    lanes packed, and each step's stores as the kernel makes them: every
    warp's staging buffer (its lane-a lanes' values, then its lane-b
    lanes', each thread's D components at l * D + k), then the 16-byte
    chunks of copying threads whose lane exists, each to its place.
    Returns the (n_steps, S, I) bf16 trajectory; a value no chunk wrote
    fails."""
    n_lanes, n = x0.shape[0], gang.n
    i_dim = n * gang.d
    m = lane_pairs(n_lanes, n)
    a = torch.from_numpy(m["lane_a"][::n])             # per slot
    b = torch.from_numpy(m["lane_b"][::n])
    xs = bf16_bits_of(x0).reshape(n_lanes, n, gang.d)
    x2 = xs[a] | xs[b] << 16                            # (P, N, D)
    net = gang.take(torch.zeros(x2.shape[0], dtype=torch.int64))
    s = store_map(n_lanes, n)
    n_warps = x2.shape[0] * n // 32
    src = torch.from_numpy(s["cta"] * (CTA // 32) + s["warp"])[s["copies"]]
    half = torch.from_numpy(s["half"][s["copies"]])
    chunk = torch.from_numpy(s["chunk"][s["copies"]])
    dst = torch.from_numpy(s["first"][s["copies"]])[:, None] + torch.arange(8)
    traj = torch.full((n_steps, n_lanes * i_dim), -1, dtype=torch.int64)
    for t in range(n_steps):
        x2 = lattice_step2(net, x2, act)
        runs = torch.stack([(x2 & 0xFFFF).reshape(n_warps, -1),
                            (x2 >> 16).reshape(n_warps, -1)], 1)
        chunks = runs.reshape(n_warps, 2, -1, 8)         # (warp, run, chunk)
        traj[t, dst.reshape(-1)] = chunks[src, half, chunk].reshape(-1)
    assert (traj >= 0).all()
    traj = torch.where(traj >= 1 << 15, traj - (1 << 16), traj)
    return traj.to(torch.int16).view(torch.bfloat16).reshape(
        n_steps, n_lanes, i_dim)


def case(system: str, n_lanes: int, seed: int):
    p = default_params(system=system)
    lattice = lattice_meta_tuple(p["lattice_meta"])
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_lanes, p["w1"].shape[0]))
                          .astype(np.float32)).to(torch.bfloat16)
    return p, lattice, LatticeGang([p], lattice), x0


@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("system,n_lanes,n_steps", [
    ("chen@ring8", 37, 8), ("chen@grid8", 37, 8), ("chen@ring32", 13, 3)])
def test_mirror_is_the_plain_lattice_k2(system, n_lanes, n_steps, act):
    """The mirror's trajectory, bitwise ``ref.chaotic_ann_ref`` in bf16 and
    the wrapper on the CPU (the plain version), at a lane count that
    leaves the last CTA ragged (37 at 8 nodes: one live lane in the
    second CTA's 32; 13 at 32 nodes: five of eight)."""
    p, lattice, gang, x0 = case(system, n_lanes, n_lanes + len(act))
    got = mirror_traj(gang, x0, n_steps, act)
    w = [torch.from_numpy(p[k]) for k in KEYS]
    want = ref.chaotic_ann_ref(*w, x0, n_steps, act, lattice)
    np.testing.assert_array_equal(state_bits(got), state_bits(want))
    plain = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=n_steps,
                                         activation=act, lattice=lattice)
    np.testing.assert_array_equal(state_bits(got), state_bits(plain))


@pytest.mark.parametrize("system,act", [
    ("chen@ring8", "relu"), ("chen@grid8", "tanh"), ("chen@ring8", "sigmoid")])
def test_mirror_is_the_jax_lattice_k2(system, act):
    """The mirror's trajectory bitwise the JAX package's vpu lattice K2
    (``chaotic_ann_pallas``) in interpret mode, 37 lanes, 4 steps."""
    p, lattice, gang, x0 = case(system, 37, 5)
    got = mirror_traj(gang, x0, 4, act)
    want = jax_ann.chaotic_ann_pallas(
        *(jnp.asarray(p[k]) for k in KEYS),
        jnp.asarray(x0.float().numpy()).astype(jnp.bfloat16), n_steps=4,
        s_block=128, t_block=4, unroll=1, activation=act, lattice=lattice,
        interpret=True)
    np.testing.assert_array_equal(state_bits(got),
                                  np.asarray(want).view(np.int16))
