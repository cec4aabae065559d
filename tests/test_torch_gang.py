"""The port's gang kernels (K3 ``chaotic_ann_gang_bits``, K4
``chaotic_ann_gang_stacked``) and their contract, on the CPU, against the
JAX package: its gang-row arithmetic, its Pallas gang kernels in interpret
mode, and per-core launches of the port's own plain K1.

Weights are the committed farm cores (``results/generated_cores/farm``):
the four 3-8-3 cores as a gang of C=4, and hyperlorenz's farm and registry
weights as a 4-16-4 gang of C=2.  Tolerance tiers as in
``tests/test_torch_kernels.py``: bf16 bitwise against Pallas; f32 states
within ``F32_FREE_RUN`` (XLA's CPU code and PyTorch's eager ops differ in
the low bits, so f32 words differ and are not compared across the two);
inside the port, bitwise in both dtypes.  The CUDA kernels are held to
the plain versions on the card in ``tests/test_torch_gpu.py``.
"""
import dataclasses
import itertools
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dse import Candidate as JaxCandidate
from repro.core.dse import GangCostModel as JaxGangCostModel
from repro.kernels import chaotic_ann as jax_ann
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.dse import Candidate, GangCostModel
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params

from test_torch_kernels import F32_FREE_RUN, bf16_bits, jax_bf16_bits

FARM = pathlib.Path(__file__).resolve().parents[1] / "results" / "generated_cores" / "farm"
KEYS = ("w1", "b1", "w2", "b2")
GANGS = {"3-8": ("chen", "chua", "lorenz", "rossler"),
         "4-16": ("hyperlorenz", "registry:hyperlorenz")}
S_BLOCK, T_BLOCK, UNROLL = 128, 256, 2


def _core_weights(name):
    if name.startswith("registry:"):
        p = default_params(system=name.split(":")[1])
    else:
        with np.load(FARM / name / "weights.npz") as npz:
            p = dict(npz)
    return [np.asarray(p[k], np.float32) for k in KEYS]


@pytest.fixture(scope="module", params=sorted(GANGS))
def gang(request):
    """(name, stacked numpy weights (C, ...)) of one gang."""
    per_core = [_core_weights(n) for n in GANGS[request.param]]
    return request.param, [np.stack(ws) for ws in zip(*per_core)]


def _t(ws):
    return [torch.from_numpy(w) for w in ws]


def _j(ws):
    return [jnp.asarray(w) for w in ws]


def _x0(rng, shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def _offsets(rng, shape):
    off = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    off.reshape(-1)[:3] = [0xFFFFFFFF, 0xFFFFFFF0, 0]   # wrap mid-run
    return off


def _words(t):
    return ops.from_uint32(t).numpy()


# ---------------------------------------------------------------------------
# The gang contract: pure integer code, equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_steps", [2, 8, 24, 64, 130, 512, 1024])
def test_gang_row_contract_equals_jax(n_steps):
    row_maps = [[0], [1, 3, 7, 9], [0, 5, 13, 64, 600], [n_steps, n_steps + 5]]
    for t_block, unroll in itertools.product([1, 2, 32, 128, 256, 255],
                                             [1, 2, 4, 8, 16]):
        assert (chaotic_ann._bits_blocks(n_steps, t_block, unroll)
                == jax_ann._bits_blocks(n_steps, t_block, unroll))
        assert (chaotic_ann.gang_row_granularity(n_steps, t_block, unroll)
                == jax_ann.gang_row_granularity(n_steps, t_block, unroll))
        for rm in row_maps:
            got = chaotic_ann.gang_effective_rows(rm, n_steps, t_block, unroll)
            want = jax_ann.gang_effective_rows(rm, n_steps, t_block, unroll)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_candidate_derived_fields_equal_jax():
    for p, i_dim, h_dim, nb in itertools.product([0, 1, 3], [3, 4, 9],
                                                 [8, 16, 17], [2, 4]):
        kw = dict(i_dim=i_dim, h_dim=h_dim, p=p, dtype_bytes=nb)
        mine, theirs = Candidate(**kw), JaxCandidate(**kw)
        assert (mine.s_block, mine.i_pad, mine.h_pad, mine.dtype_name) == (
            theirs.s_block, theirs.i_pad, theirs.h_pad, theirs.dtype_name)


# ---------------------------------------------------------------------------
# Plain K3 / K4 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# row maps of 8 lane blocks (K3) and of C cores (K4): demands of 0, not a
# multiple of the granularity, and above the launch's rows
K3_ROW_MAPS = {"padded": None, "ragged": np.array([0, 3, 32, 17, 9, 40, 1, 8])}
K4_ROW_MAPS = {"padded": None, "ragged": np.array([0, 17, 40, 9])}


@pytest.mark.parametrize("shape", sorted(K3_ROW_MAPS))
def test_gang_bits_bf16_bitwise_vs_pallas(gang, shape):
    """Plain K3 == Pallas K3: the words each block asked for and the final
    states, bitwise; the ragged map's rows are rounded as the kernel's."""
    _, ws = gang
    n_cores, i_dim = ws[0].shape[0], ws[0].shape[1]
    rng = np.random.default_rng(31)
    core_map = rng.integers(0, n_cores, 8).astype(np.int32)
    row_map, n_steps = K3_ROW_MAPS[shape], 64
    s_total = len(core_map) * S_BLOCK
    x0, off = _x0(rng, (s_total, i_dim)), _offsets(rng, s_total)
    jw, js = jax_ann.chaotic_ann_gang_bits_pallas(
        *_j(ws), jnp.asarray(x0).astype(jnp.bfloat16), jnp.asarray(core_map),
        jnp.asarray(off), None if row_map is None else jnp.asarray(row_map),
        n_steps=n_steps, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        interpret=True)
    tw, ts = chaotic_ann.chaotic_ann_gang_bits(
        *_t(ws), torch.from_numpy(x0).to(torch.bfloat16), core_map,
        torch.from_numpy(off), row_map, n_steps=n_steps, s_block=S_BLOCK,
        t_block=T_BLOCK, unroll=UNROLL)
    rows = (np.full(8, n_steps // 2) if row_map is None else
            jax_ann.gang_effective_rows(row_map, n_steps, T_BLOCK, UNROLL))
    if row_map is not None:
        np.testing.assert_array_equal(rows, [0, 4, 32, 18, 10, 32, 2, 8])
    jw, tw = np.asarray(jw), _words(tw)
    for g, r in enumerate(rows):
        lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
        np.testing.assert_array_equal(tw[:r, lanes], jw[:r, lanes])
    np.testing.assert_array_equal(bf16_bits(ts), jax_bf16_bits(js))


@pytest.mark.parametrize("shape", sorted(K4_ROW_MAPS))
def test_gang_stacked_bf16_bitwise_vs_pallas(gang, shape):
    """Plain K4 == Pallas K4: words each core asked for, final states."""
    _, ws = gang
    n_cores, i_dim = ws[0].shape[0], ws[0].shape[1]
    rng = np.random.default_rng(32)
    row_map = K4_ROW_MAPS[shape]
    row_map = None if row_map is None else row_map[:n_cores]
    n_steps, n_lanes = 64, S_BLOCK + 37
    x0 = _x0(rng, (n_cores, n_lanes, i_dim))
    off = _offsets(rng, (n_cores, n_lanes))
    jw, js = jax_ann.chaotic_ann_gang_stacked_pallas(
        *_j(ws), jnp.asarray(x0).astype(jnp.bfloat16), jnp.asarray(off),
        None if row_map is None else jnp.asarray(row_map), n_steps=n_steps,
        s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL, interpret=True)
    tw, ts = chaotic_ann.chaotic_ann_gang_stacked(
        *_t(ws), torch.from_numpy(x0).to(torch.bfloat16),
        torch.from_numpy(off), row_map, n_steps=n_steps)
    rows = (np.full(n_cores, n_steps // 2) if row_map is None
            else np.minimum(row_map, n_steps // 2))
    jw, tw = np.asarray(jw), _words(tw)
    for c, r in enumerate(rows):
        np.testing.assert_array_equal(tw[:r, c], jw[:r, c])
    np.testing.assert_array_equal(bf16_bits(ts), jax_bf16_bits(js))


def test_gang_f32_states_within_stated_tolerance_of_pallas(gang):
    """f32, 16 steps, ragged: states within the free-run tolerance (the
    words differ in the low bits across frameworks, as K1's do)."""
    _, ws = gang
    n_cores, i_dim = ws[0].shape[0], ws[0].shape[1]
    rng = np.random.default_rng(33)
    core_map = np.arange(4, dtype=np.int32) % n_cores
    row_map = np.array([8, 0, 3, 5])
    x0 = _x0(rng, (4 * S_BLOCK, i_dim))
    _, js = jax_ann.chaotic_ann_gang_bits_pallas(
        *_j(ws), jnp.asarray(x0), jnp.asarray(core_map), 0,
        jnp.asarray(row_map), n_steps=16, s_block=S_BLOCK, t_block=T_BLOCK,
        unroll=UNROLL, interpret=True)
    _, ts = chaotic_ann.chaotic_ann_gang_bits(
        *_t(ws), torch.from_numpy(x0), core_map, 0, row_map, n_steps=16,
        s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL)
    js = np.asarray(js)
    gap = np.abs(ts.numpy() - js).max()
    assert gap <= F32_FREE_RUN(np.abs(js).max()), gap
    x0s = x0[:2 * S_BLOCK].reshape(2, S_BLOCK, i_dim)
    sw = [w[[0, 1 % n_cores]] for w in ws]
    _, js = jax_ann.chaotic_ann_gang_stacked_pallas(
        *_j(sw), jnp.asarray(x0s), 0, jnp.asarray([8, 3]), n_steps=16,
        s_block=S_BLOCK, interpret=True)
    _, ts = chaotic_ann.chaotic_ann_gang_stacked(
        *_t(sw), torch.from_numpy(x0s), 0, [8, 3], n_steps=16)
    js = np.asarray(js)
    gap = np.abs(ts.numpy() - js).max()
    assert gap <= F32_FREE_RUN(np.abs(js).max()), gap


# ---------------------------------------------------------------------------
# Inside the port: plain K3 / K4 == per-core plain K1, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gang_plain_versions_equal_per_core_k1(gang, dtype):
    _, ws = gang
    n_cores, i_dim = ws[0].shape[0], ws[0].shape[1]
    w = _t(ws)
    rng = np.random.default_rng(34)
    n_steps, s_block = 40, 96
    core_map = np.array([1, 0, n_cores - 1, 1]) % n_cores
    rows = np.array([20, 0, 7, 13])
    x0 = torch.from_numpy(_x0(rng, (4 * s_block, i_dim))).to(dtype)
    off = torch.from_numpy(_offsets(rng, 4 * s_block))
    gw, gs = ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps, off,
                                           rows)
    for g, (c, r) in enumerate(zip(core_map, rows)):
        lanes = slice(g * s_block, (g + 1) * s_block)
        if r == 0:
            assert torch.equal(gs[lanes], x0[lanes])
            continue
        kw, ks = ref.chaotic_ann_bits_ref(*[t[c] for t in w], x0[lanes],
                                          2 * r, off[lanes])
        np.testing.assert_array_equal(_words(gw)[:r, lanes], _words(kw))
        assert not _words(gw)[r:, lanes].any()     # zero past the rows
        assert torch.equal(gs[lanes], ks)
    x0s = torch.from_numpy(_x0(rng, (n_cores, 77, i_dim))).to(dtype)
    offs = torch.from_numpy(_offsets(rng, (n_cores, 77)))
    srows = [0, 11][:n_cores] + [20] * (n_cores - 2)
    sw, ss = ref.chaotic_ann_gang_stacked_ref(*w, x0s, n_steps, offs, srows)
    assert tuple(sw.shape) == (20, n_cores, 77)
    for c, r in enumerate(srows):
        if r == 0:
            assert torch.equal(ss[c], x0s[c])
            continue
        kw, ks = ref.chaotic_ann_bits_ref(*[t[c] for t in w], x0s[c], 2 * r,
                                          offs[c])
        np.testing.assert_array_equal(_words(sw)[:r, c], _words(kw))
        assert torch.equal(ss[c], ks)


def test_ops_gang_backends_agree_on_cpu(gang):
    """'ref' and 'auto' (the wrapper, taking the plain version on a CPU
    tensor) give the same words and states, with ``config`` driving
    s_block and the row rounding."""
    _, ws = gang
    n_cores, i_dim = ws[0].shape[0], ws[0].shape[1]
    params = dict(zip(KEYS, _t(ws)))
    cfg = Candidate(i_dim=i_dim, h_dim=ws[0].shape[2], p=0, unroll=4,
                    t_block=16, dtype_bytes=2)
    rng = np.random.default_rng(35)
    x0 = torch.from_numpy(_x0(rng, (3 * 128, i_dim))).to(torch.bfloat16)
    cmap, rmap = np.array([0, n_cores - 1, 0]), np.array([1, 9, 4])
    outs = [ops.chaotic_bits_gang(params, x0, 24, 7, core_map=cmap,
                                  row_map=rmap, backend=b, config=cfg)
            for b in ("ref", "auto")]
    assert torch.equal(ops.from_uint32(outs[0][0]), ops.from_uint32(outs[1][0]))
    assert torch.equal(outs[0][1], outs[1][1])
    # rows 1 and 9 round up to the granularity 4: 4 and 12
    np.testing.assert_array_equal((_words(outs[0][0]) != 0).sum(0)[::128],
                                  [4, 12, 4])
    xs = x0[:2 * 128].reshape(2, 128, i_dim)
    sp = {k: v[:2] for k, v in params.items()}
    outs = [ops.chaotic_bits_gang_stacked(sp, xs, 24, 5, row_map=[3, 12],
                                          backend=b, config=cfg)
            for b in ("ref", "auto")]
    assert torch.equal(ops.from_uint32(outs[0][0]), ops.from_uint32(outs[1][0]))
    assert torch.equal(outs[0][1], outs[1][1])


def test_gang_wrappers_on_cpu_take_plain_version_without_counting(gang):
    _, ws = gang
    i_dim = ws[0].shape[1]
    w = _t(ws)
    x0 = torch.from_numpy(_x0(np.random.default_rng(0), (256, i_dim)))
    before = (chaotic_ann.chaotic_ann_gang_bits.launches,
              chaotic_ann.chaotic_ann_gang_stacked.launches)
    words, state = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, [0, 1], 3, n_steps=4, s_block=128)
    rw, rs = ref.chaotic_ann_gang_bits_ref(*w, x0, [0, 1], 4, 3)
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(rw))
    assert torch.equal(state, rs)
    chaotic_ann.chaotic_ann_gang_stacked(*[t[:2] for t in w],
                                         x0.reshape(2, 128, i_dim), n_steps=4)
    assert (chaotic_ann.chaotic_ann_gang_bits.launches,
            chaotic_ann.chaotic_ann_gang_stacked.launches) == before


def test_gang_wrappers_reject_what_the_kernels_do_not_take():
    w = _t([np.stack(ws) for ws in zip(*[_core_weights(n) for n in
                                         ("chen", "lorenz")])])
    x0 = torch.zeros(256, 3)
    with pytest.raises(ValueError, match="s_block multiple"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0[:200], [0, 1], n_steps=4,
                                          s_block=128)
    with pytest.raises(ValueError, match="row_map shape"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0, [0, 1], 0, [4], n_steps=4,
                                          s_block=128)
    with pytest.raises(ValueError, match="core_map values"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0, [0, 2], n_steps=4,
                                          s_block=128)
    with pytest.raises(ValueError, match="compute_unit"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0, [0, 1], n_steps=4,
                                          s_block=128, compute_unit="tpu")
    xm = torch.from_numpy(_x0(np.random.default_rng(5), (32, 3)))
    before = chaotic_ann.chaotic_ann_mxu_gang_bits.launches
    mxu_w, mxu_s = chaotic_ann.chaotic_ann_gang_bits(
        *w, xm, [0, 1], n_steps=4, s_block=16, compute_unit="mxu")
    assert chaotic_ann.chaotic_ann_mxu_gang_bits.launches == before  # CPU
    for c in range(2):
        want_w, want_s = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], xm[16 * c:16 * (c + 1)], n_steps=4,
            compute_unit="mxu")
        assert torch.equal(ops.from_uint32(mxu_w[:, 16 * c:16 * (c + 1)]),
                           ops.from_uint32(want_w))
        assert torch.equal(mxu_s[16 * c:16 * (c + 1)], want_s)
    # every gang form, scalar and lattice, vpu and mxu, takes tanh and
    # sigmoid: each block's words and state are solo K1's with that
    # activation
    tanh_w, tanh_s = chaotic_ann.chaotic_ann_gang_bits(
        *w, xm, [0, 1], n_steps=4, s_block=16, activation="tanh")
    for c in range(2):
        want_w, want_s = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], xm[16 * c:16 * (c + 1)], n_steps=4,
            activation="tanh")
        assert torch.equal(ops.from_uint32(tanh_w[:, 16 * c:16 * (c + 1)]),
                           ops.from_uint32(want_w))
        assert torch.equal(tanh_s[16 * c:16 * (c + 1)], want_s)
    mxu_tanh_w, mxu_tanh_s = chaotic_ann.chaotic_ann_gang_bits(
        *w, xm, [0, 1], n_steps=4, s_block=16, activation="tanh",
        compute_unit="mxu")
    for c in range(2):
        want_w, want_s = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], xm[16 * c:16 * (c + 1)], n_steps=4,
            activation="tanh", compute_unit="mxu")
        assert torch.equal(
            ops.from_uint32(mxu_tanh_w[:, 16 * c:16 * (c + 1)]),
            ops.from_uint32(want_w))
        assert torch.equal(mxu_tanh_s[16 * c:16 * (c + 1)], want_s)
    assert not torch.equal(ops.from_uint32(mxu_tanh_w),
                           ops.from_uint32(mxu_w))
    ring = default_params(system="chen@ring8")
    lw = [torch.from_numpy(np.stack([ring[k]] * 2)) for k in KEYS]
    lattice = lattice_meta_tuple(ring["lattice_meta"])
    lx = torch.from_numpy(_x0(np.random.default_rng(6), (2 * 16, 24)))
    sig_w, sig_s = chaotic_ann.chaotic_ann_gang_bits(
        *lw, lx, [0, 1], n_steps=4, s_block=16, lattice=lattice,
        activation="sigmoid")
    tanh_w, tanh_s = chaotic_ann.chaotic_ann_gang_stacked(
        *lw, lx.reshape(2, 16, 24), n_steps=4, lattice=lattice,
        activation="tanh")
    relu_w, _ = chaotic_ann.chaotic_ann_gang_stacked(
        *lw, lx.reshape(2, 16, 24), n_steps=4, lattice=lattice)
    assert not torch.equal(ops.from_uint32(tanh_w), ops.from_uint32(relu_w))
    for c in range(2):
        lanes = slice(16 * c, 16 * (c + 1))
        for act, words, state in (("sigmoid", sig_w[:, lanes], sig_s[lanes]),
                                  ("tanh", tanh_w[:, c], tanh_s[c])):
            want_w, want_s = chaotic_ann.chaotic_ann_bits(
                *[t[c] for t in lw], lx[lanes], n_steps=4, lattice=lattice,
                activation=act)
            assert torch.equal(ops.from_uint32(words),
                               ops.from_uint32(want_w))
            assert torch.equal(state, want_s)
    xs = x0.reshape(2, 128, 3)
    with pytest.raises(ValueError, match="vpu"):
        chaotic_ann.chaotic_ann_gang_stacked(*w, xs, n_steps=4,
                                             compute_unit="mxu")
    with pytest.raises(ValueError, match=r"row_map must have shape \(2,\)"):
        chaotic_ann.chaotic_ann_gang_stacked(*w, xs, 0, [1, 2, 3], n_steps=4)
    with pytest.raises(ValueError, match="one pool per core"):
        chaotic_ann.chaotic_ann_gang_stacked(*w, x0, n_steps=4)
    with pytest.raises(ValueError, match="even"):
        chaotic_ann.chaotic_ann_gang_stacked(*w, xs, n_steps=3)
    with pytest.raises(ValueError, match="CUDA"):      # no silent fallback
        chaotic_ann.chaotic_ann_gang_bits(*w, x0.to("meta"), [0, 1],
                                          n_steps=4, s_block=128)
    params = dict(zip(KEYS, w))
    with pytest.raises(ValueError, match="compute_unit='vpu' only"):
        ops.chaotic_bits_gang_stacked(params, xs, 4, compute_unit="mxu")
    words, state = ops.chaotic_bits_gang(params, xm, 4, core_map=[0, 1],
                                         s_block=16, compute_unit="mxu")
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(mxu_w))
    assert torch.equal(state, mxu_s)
    with pytest.raises(ValueError, match="4-entry descriptor"):
        ops.chaotic_bits_gang_stacked(
            dict(params, lattice_meta=torch.tensor([2, 3, 0])), xs, 4)
    with pytest.raises(ValueError, match="leading core axis"):
        ops.chaotic_bits_gang_stacked({k: v[0] for k, v in params.items()},
                                      xs, 4)


# ---------------------------------------------------------------------------
# The gang cost model: JAX launch arithmetic, Hopper step input
# ---------------------------------------------------------------------------

def test_gang_cost_multiblock_overdraw():
    """As tests/test_planner.py: the ragged concat cost credits each member
    its OWN effective rows, and padded overdraw counts (dmax - d) words
    per lane."""
    cand = Candidate(i_dim=3, h_dim=8, p=0, dtype_bytes=4, unroll=2,
                     t_block=32)
    model = GangCostModel(launch_overhead_cycles=0.0)
    demands, blocks, lanes = [16, 4], [2, 2], [512, 512]
    ragged = model.gang_cost(cand, demands, blocks, lanes, layout="concat",
                             rows_by_block=[16, 16, 4, 4])
    padded = model.gang_cost(cand, demands, blocks, lanes, layout="concat")
    step = model.step_cycles(cand)
    expected = 2 * 24 * step + model.buffer_cycles((16 - 4) * 512)
    assert padded - ragged == pytest.approx(expected, rel=1e-9)
    assert (model.gang_cost(cand, demands, blocks, lanes, layout="concat",
                            rows_by_block=[16, 16, 4, 4])
            < model.gang_cost(cand, demands, blocks, lanes, layout="concat",
                              rows_by_block=[16, 16, 8, 8]))


def test_gang_cost_hopper_step_and_jax_arithmetic():
    """One step of one block is step_ops x s_block flops at the dtype's
    rate; a stack of C costs C times that; the launch arithmetic is the
    JAX model's once both take the same per-step input."""
    cand = Candidate(i_dim=3, h_dim=8, p=1, dtype_bytes=2, unroll=8,
                     t_block=256)
    model = GangCostModel()
    flops = (4 * 3 * 8 + 8 + 3) * 256
    assert model.step_cycles(cand) == pytest.approx(
        flops / 133.8e12 * 1.98e9, rel=1e-12)
    assert model.step_cycles(cand, stack=4) == pytest.approx(
        4 * model.step_cycles(cand), rel=1e-12)
    assert model.seconds(model.launch_cycles(cand, [0])) == pytest.approx(
        20e-6, rel=1e-12)
    jax_model = JaxGangCostModel(launch_overhead_cycles=123.0,
                                 freeze_row_cycles=0.0)
    jc = JaxCandidate(**dataclasses.asdict(cand))
    jax_model.step_cycles = lambda c, stack=1: model.step_cycles(cand, stack)
    mine = GangCostModel(launch_overhead_cycles=123.0)
    mine.buffer_cycles = jax_model.buffer_cycles
    for layout, rbb in (("stacked", None), ("stacked", [9, 2, 2]),
                        ("concat", None), ("concat", [16] * 4 + [8] * 6)):
        args = ([9, 2, 2], [4, 3, 3], [512, 384, 384])
        if layout == "stacked":
            args = ([9, 2, 2], [4, 4, 4], [512, 512, 512])
        assert mine.gang_cost(cand, *args, layout=layout,
                              rows_by_block=rbb) == pytest.approx(
            jax_model.gang_cost(jc, *args, layout=layout, rows_by_block=rbb),
            rel=1e-12)
    assert mine.solo_cost(cand, 7, 3) == pytest.approx(
        jax_model.solo_cost(jc, 7, 3), rel=1e-12)
