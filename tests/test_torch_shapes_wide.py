"""Lattices of more than 32 nodes (CPU): a numpy mirror of the kernels'
wide lane slot, and the port's plain K1 at such lattices against the JAX
package's Pallas kernels in interpret mode.

On the card a lattice of 33 to 1,024 nodes runs a lane's nodes as a slot
of ``W = slot_width(N)`` threads spanning W / 32 warps of one CTA
(``cta_threads``: 128 threads, or W where W is wider); neighbours are
read from a shared-memory buffer that every thread writes its D pre-step
components to (``Exchange``), and the fold is one warp reduction a warp,
combined through shared memory (``SlotXor``).  The mirror here holds:

* Lane slots: thread -> (lane, node, idle) for N in {33, 34, 40, 64, 96,
  128, 1,024}: every lane computed once, every (lane, node) by one live
  thread, a slot inside one CTA, the word writers in its first warp.
* The exchange: one coupled step through the mirror's buffer indices
  (k-major, a thread's place its position in the slot, an idle thread's
  past N) bitwise ``ref.lattice_delta`` in f32 and bf16 at chen@ring40,
  chen@grid64, a 6 x 8 torus (grid48) and chen@ring1024.
* The fold: the warps' partial XORs, posted and XORed, equal to the
  lane's ``_fold16``.
* ``TrajStore``'s runs across warps: every value of the trajectory stored
  once, every 16-byte chunk aligned and inside one lane.
* ``gang_lane_granularity`` non-zero and dividing every served ``s_block``.

Against the Pallas kernels (t_block 4, unroll 1, 128 lanes, where XLA
keeps the mxu dot's forward FMA chain): the plain bf16 vpu K1 at
chen@ring40 (words and final state), and the mxu K1 in f32 and bf16 at
chen@ring40 and chen@grid64, bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.dse import enumerate_candidates
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params

from test_torch_shapes import check_bitwise_k1, inputs

CTA = 128                                  # kThreads of chaotic_ann.cu
WIDE = (33, 34, 40, 64, 96, 128, 1_024)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain f32 FMA chains are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cta_threads(n_nodes: int) -> int:
    """``cta_threads``: 128, or one slot of W threads where W is wider."""
    return max(CTA, chaotic_ann.slot_width(n_nodes))


def grid_p(n: int) -> int:
    """``grid_p`` of chaotic_ann.cu: the torus's rows."""
    p = 1
    while (p + 1) * (p + 1) <= n:
        p += 1
    while n % p:
        p -= 1
    return p


def slot_map(n_lanes: int, n_nodes: int) -> dict:
    """Every thread of a two-lane lattice launch as ``LanePair`` and the
    launchers compute them: CTAs of cta_threads(N), W-thread slots, node
    (an idle thread mirrors node N - 1), lane pair."""
    w, cta = chaotic_ann.slot_width(n_nodes), cta_threads(n_nodes)
    slots = cta // w
    grid = -(-n_lanes // (2 * slots))
    t = np.arange(grid * cta)
    block, tid = t // cta, t % cta
    pos = tid % w
    a = block * 2 * slots + tid // w
    b = a + slots
    live_a, live_b = a < n_lanes, b < n_lanes
    a = np.where(live_a, a, n_lanes - 1)
    b = np.where(live_b, b, a)
    return dict(block=block, tid=tid, pos=pos, w=w, cta=cta,
                node=np.minimum(pos, n_nodes - 1), idle=pos >= n_nodes,
                lane_a=a, lane_b=b, live_a=live_a, live_b=live_b)


@pytest.mark.parametrize("n_nodes", WIDE)
@pytest.mark.parametrize("n_lanes", [1, 3, 37, 129])
def test_wide_lane_slot_map(n_lanes, n_nodes):
    """Each lane computed by one slot, its words written by one thread
    (node 0 lane a's, node 1 lane b's, both in the slot's first warp,
    never an idle thread), every (lane, node) state component by one live
    thread; a slot is whole warps of one CTA, so every node a thread reads
    lies in its own CTA's shared memory, and a CTA has at most 1,024
    threads."""
    m = slot_map(n_lanes, n_nodes)
    node, idle, w, tid = m["node"], m["idle"], m["w"], m["tid"]
    live = ~idle
    assert w % 32 == 0 and m["cta"] % w == 0 and m["cta"] <= 1_024
    assert m["cta"] == (CTA if w <= CTA else w)
    for h, writer in (("a", 0), ("b", 1)):
        keep = m[f"live_{h}"] & live & (node == writer)
        assert np.array_equal(np.sort(m[f"lane_{h}"][keep]),
                              np.sort(m[f"lane_{h}"][m[f"live_{h}"]
                                                     & (node == 0)]))
        assert (m["pos"][keep] < 32).all()        # the slot's first warp
    computed = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                               m["lane_b"][m["live_b"] & (node == 0)]])
    assert np.array_equal(np.sort(computed), np.arange(n_lanes))
    comps = np.concatenate([m[f"lane_{h}"][m[f"live_{h}"] & live] * n_nodes
                            + node[m[f"live_{h}"] & live]
                            for h in ("a", "b")])
    assert np.array_equal(np.sort(comps), np.arange(n_lanes * n_nodes))
    assert (node[idle] == n_nodes - 1).all()
    assert idle.sum() == (w - n_nodes) * (tid.size // w)
    slot_base = tid - m["pos"]
    for src in (0, n_nodes - 1):
        assert (slot_base + src < m["cta"]).all()
    for key in ("lane_a", "lane_b", "live_a", "live_b", "block"):
        per_slot = m[key].reshape(-1, w)
        assert (per_slot == per_slot[:, :1]).all(), key


def exchange_delta(x: torch.Tensor, lattice) -> torch.Tensor:
    """One coupled step's increment through the mirror of ``Exchange``:
    each lane slot's buffer (D, W) holds at [k, pos] what the thread at
    slot place ``pos`` put (node min(pos, N - 1)'s component k), and each
    live node thread reads its neighbours' places and sums them in
    ``lattice_step``'s order; then ``(acc - deg * x) * eps`` in the state
    dtype.  Returns the (S, N * D) increment."""
    n, d, topology, strength = lattice
    w = chaotic_ann.slot_width(n)
    s_lanes = x.shape[0]
    pos = np.arange(w)
    put_node = np.minimum(pos, n - 1)              # an idle thread: N - 1
    nodes = x.reshape(s_lanes, n, d)
    buf = nodes[:, put_node, :].transpose(1, 2)    # (S, D, W): [k, pos]
    own = np.arange(n)                             # the live node threads
    if topology == "ring":
        src = ((own + n - 1) % n, (own + 1) % n)
        acc = buf[:, :, src[0]] + buf[:, :, src[1]]
        deg = 2
    else:
        pp = grid_p(n)
        qq = n // pp
        p, q = own // qq, own % qq
        src = (((p + pp - 1) % pp) * qq + q, ((p + 1) % pp) * qq + q,
               p * qq + (q + qq - 1) % qq, p * qq + (q + 1) % qq)
        acc = ((buf[:, :, src[0]] + buf[:, :, src[1]])
               + (buf[:, :, src[2]] + buf[:, :, src[3]]))
        deg = 4
    assert all((s < n).all() for s in src)         # never an idle place
    eps = torch.tensor(strength, dtype=torch.float32).to(x.dtype)
    delta = (acc - deg * buf[:, :, own]) * eps
    return delta.transpose(1, 2).reshape(s_lanes, n * d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lattice", [
    (40, 3, "ring", 0.05), (64, 3, "grid", 0.05), (48, 3, "grid", 0.05),
    (1_024, 3, "ring", 0.05)], ids=["ring40", "grid64", "grid48", "ring1024"])
def test_exchange_step_is_the_plain_coupling(lattice, dtype):
    """The coupling read through the wide slot's buffer indices is
    ``ref.lattice_delta`` bitwise; grid64's row neighbours lie 8 places
    (a warp's quarter) off, grid48 is a 6 x 8 torus, its slot 64 threads
    with 16 idle."""
    n, d = lattice[:2]
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(-3, 3, (37, n * d)).astype(
        np.float32)).to(dtype)
    got, want = exchange_delta(x, lattice), ref.lattice_delta(x, lattice)
    assert got.dtype == want.dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_nodes,d", [(33, 8), (40, 3), (64, 3),
                                       (34, 4), (1_024, 3)])
def test_warp_partials_fold_to_the_lane_word(n_nodes, d, dtype):
    """``SlotXor``: each thread's fold term (0 from an idle one), XORed
    over its warp (redux.sync), posted a word a warp, and the slot's posts
    XORed (lane w reads warp w's) give ``_fold16`` of the lane's whole
    state, as the plain version folds it."""
    rng = np.random.default_rng(n_nodes * d)
    x = torch.from_numpy(rng.uniform(-3, 3, (5, n_nodes * d)).astype(
        np.float32)).to(dtype)
    if dtype == torch.bfloat16:
        low = x.view(torch.int16).numpy().astype(np.int64) & 0x7F
    else:
        low = x.view(torch.int32).numpy().astype(np.int64) & 0xFFFF
    w = chaotic_ann.slot_width(n_nodes)
    pos = np.arange(w)
    node = np.minimum(pos, n_nodes - 1)
    terms = np.zeros((x.shape[0], w), np.int64)
    for k in range(d):
        i = node * d + k
        terms ^= low[:, i] << (5 * i % 16)
    terms[:, pos >= n_nodes] = 0
    posts = np.bitwise_xor.reduce(terms.reshape(x.shape[0], w // 32, 32),
                                  axis=2)
    lanes = np.zeros((x.shape[0], 32), np.int64)
    lanes[:, :w // 32] = posts                     # lane w reads warp w's
    got = np.bitwise_xor.reduce(lanes, axis=1)
    np.testing.assert_array_equal(got, ops._fold_low16(x).numpy())


def wide_traj_stores(n_lanes: int, n_nodes: int, d: int, itemsize: int):
    """A numpy mirror of ``TrajStore`` in a wide slot: warp g of a slot
    stages its 32 nodes' D values of lane a and of lane b (every thread at
    its own place, lane * D), and copy slot j stores chunk q of run h
    where the run's lane exists and the chunk holds live nodes.  Returns
    the count of every value of one step's (S, I) values and the 16-byte
    stores' first values."""
    w, cta = chaotic_ann.slot_width(n_nodes), cta_threads(n_nodes)
    slots, warps = cta // w, w // 32
    kv, i_dim = 16 // itemsize, n_nodes * d
    assert i_dim * itemsize % 16 == 0
    k_chunks = 32 * d // kv
    k_copies = -(-2 * k_chunks // 32)
    grid = -(-n_lanes // (2 * slots))
    count = np.zeros(n_lanes * i_dim, np.int64)
    starts = []
    for block in range(grid):
        for warp in range(cta // 32):
            slot, node0 = warp // warps, warp % warps * 32
            # the stage: [half][place], (lane, node, k) of what was put
            lane = np.arange(32)
            node = np.minimum(node0 + lane, n_nodes - 1)
            for c in range(k_copies):
                j = lane + 32 * c
                h, q = j // k_chunks, j % k_chunks
                run_lane = block * 2 * slots + h * slots + slot
                nodes = min(n_nodes - node0, 32)
                live = np.where((j >= 2 * k_chunks) | (run_lane >= n_lanes)
                                | (nodes <= 0), 0, nodes * d)
                out = (run_lane * i_dim + node0 * d) // kv + q
                assert ((run_lane * i_dim + node0 * d) % kv == 0).all()
                for t in np.nonzero((q * kv >= 0) & (q * kv + kv <= live))[0]:
                    r = q[t] * kv + np.arange(kv)      # places in the run
                    src_lane, k = r // d, r % d
                    assert (node0 + src_lane < n_nodes).all()
                    assert (node[src_lane] == node0 + src_lane).all()
                    dst = out[t] * kv + np.arange(kv)
                    assert np.array_equal(
                        dst, run_lane[t] * i_dim + (node0 + src_lane) * d
                        + k)
                    assert (dst // i_dim == run_lane[t]).all()
                    np.add.at(count, dst, 1)
                    starts.append(out[t] * kv)
    return count, np.array(starts)


@pytest.mark.parametrize("n_nodes,d", [(34, 4), (40, 3), (64, 3), (96, 3),
                                       (128, 3), (33, 8), (1_024, 3)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n_lanes", [1, 5, 130])
def test_wide_traj_store_map(n_lanes, n_nodes, d, itemsize):
    """The K2s' staged stores in a wide slot: every value of a step once,
    each 16-byte store aligned and inside one lane; a warp past N (at
    1,024 nodes of a 1,024-thread slot none; at 40 nodes of 64, the second
    warp's last 24 places) stores nothing of its idle places."""
    count, starts = wide_traj_stores(n_lanes, n_nodes, d, itemsize)
    assert (count == 1).all()
    assert (starts * itemsize % 16 == 0).all()


def test_gang_granularity_divides_every_served_s_block():
    """A one-lane CTA's lanes at every N up to 1,024: 128 / W, and 1 where
    a slot fills its CTA; every s_block the DSE plans (128 * 2^p) is a
    multiple of it."""
    s_blocks = {c.s_block for c in enumerate_candidates(120, 320,
                                                        n_nodes=40)}
    assert s_blocks
    for n in range(2, 1_025):
        g = chaotic_ann.gang_lane_granularity(n)
        w = chaotic_ann.slot_width(n)
        assert g >= 1 and g == max(1, CTA // w)
        assert g * w == cta_threads(n)
        assert all(s % g == 0 for s in s_blocks)
    assert [chaotic_ann.slot_width(n) for n in WIDE] == [64, 64, 64, 64,
                                                         128, 128, 1_024]


@pytest.mark.parametrize("n_nodes", [33, 40, 64, 128, 512, 1_024])
def test_card_takes_up_to_1024_nodes(n_nodes):
    """``check_card_lattice`` and the shape keys take every node count
    from 33 to 1,024 whose state is whole sublanes."""
    d = 8 if n_nodes % 8 else 3
    chaotic_ann.check_card_lattice((n_nodes, d, "ring", 0.05), n_nodes * d)
    assert chaotic_ann.shape_key("lattice", (d, 8, n_nodes, "grid")) == (
        "lattice", (d, 8, n_nodes, 1))


# ---------------------------------------------------------------------------
# The plain K1 at wide lattices against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def lattice_of(system):
    p = default_params(system=system)
    return p, lattice_meta_tuple(p["lattice_meta"])


def test_plain_ring40_bf16_vpu_bitwise_vs_pallas():
    """The bf16 vpu K1 at chen@ring40: words and final state."""
    p, lattice = lattice_of("chen@ring40")
    x0, off = inputs(p["w1"].shape[0], seed=41)
    check_bitwise_k1(p, x0, off, torch.bfloat16, jnp.bfloat16, act="relu",
                     lattice=lattice, n_steps=8)


@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("system", ["chen@ring40", "chen@grid64"])
def test_plain_wide_mxu_bitwise_vs_pallas(system, dtypes):
    """The mxu K1 with the dense coupling operand: words and final
    state."""
    p, lattice = lattice_of(system)
    x0, off = inputs(p["w1"].shape[0], seed=42)
    check_bitwise_k1(p, x0, off, *dtypes, act="relu", unit="mxu",
                     lattice=lattice, cpl=p["coupling"], n_steps=8)
