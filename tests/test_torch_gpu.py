"""The port's CUDA kernels against their plain versions, bitwise, on the
card.  Every test here is ``gpu``-marked and skips without a CUDA card
and ``nvcc``.  The file imports no JAX, so it runs where JAX is not
installed; there, skip ``tests/conftest.py`` (it imports JAX):

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.ann import params_from_numpy
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params

pytestmark = pytest.mark.gpu

FARM = (pathlib.Path(__file__).resolve().parents[1] / "results"
        / "generated_cores" / "farm")
# the committed farm's gangs: the four 3-8-3 cores, and hyperlorenz's farm
# and registry weights as a 4-16-4 pair
GANGS = {"3-8": ("chen", "chua", "lorenz", "rossler"),
         "4-16": ("hyperlorenz", "registry:hyperlorenz")}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))


def _inputs(system, n_lanes, dtype, seed):
    rng = np.random.default_rng(seed)
    p = params_from_numpy(default_params(system=system), device="cuda")
    i_dim = p["w1"].shape[0]
    x0 = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off[:4] = [0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0]
    return ([p[k] for k in ("w1", "b1", "w2", "b2")],
            torch.from_numpy(x0).to("cuda", dtype),
            torch.from_numpy(off).to("cuda"))


@pytest.mark.parametrize("system", ["chen", "hyperlorenz"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bitwise_vs_plain_on_card(system, dtype):
    _need_card()
    w, x0, off = _inputs(system, 1000 + 37, dtype, seed=21)
    n0 = chaotic_ann.chaotic_ann_bits.launches
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=64)
    assert chaotic_ann.chaotic_ann_bits.launches == n0 + 1
    rw, rs = ref.chaotic_ann_bits_ref(*w, x0, 64, off)
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(rw))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(state.view(bits), rs.view(bits))
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=64)
    assert torch.equal(traj.view(bits),
                       ref.chaotic_ann_ref(*w, x0, 64).view(bits))


def test_ops_on_card_never_reach_the_plain_version(monkeypatch):
    _need_card()
    p = params_from_numpy(default_params(), device="cuda")
    _, x0, _ = _inputs("chen", 256, torch.float32, seed=2)
    want_w, want_s = ops.chaotic_bits(p, x0, 8, 3, backend="ref")

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(ref, "chaotic_ann_bits_ref", forbidden)
    monkeypatch.setattr(ref, "chaotic_ann_ref", forbidden)
    words, state = ops.chaotic_bits(p, x0, 8, 3)
    ops.chaotic_trajectory(p, x0, 4)
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(want_w))
    assert torch.equal(state, want_s)


def _seeded_net(i_dim, h_dim, seed):
    """Seeded (I, H) weights on the card, gain near 1."""
    rng = np.random.default_rng(seed)
    shapes = ((i_dim, h_dim), (h_dim,), (h_dim, i_dim), (i_dim,))
    scales = (1.2 / np.sqrt(i_dim), 0.2, 1.2 / np.sqrt(h_dim), 0.1)
    return [torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).cuda()
            for shape, s in zip(shapes, scales)]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Contiguity and dtype are refused; a 3-5 net, outside the default
    library, runs from its shape library bitwise its plain version."""
    _need_card()
    w, x0, off = _inputs("chen", 64, torch.float32, seed=3)
    with pytest.raises(ValueError, match="contiguous"):
        chaotic_ann.chaotic_ann_bits(*w, x0.t().contiguous().t(), off,
                                     n_steps=4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        chaotic_ann.chaotic_ann_traj(*w, x0.half(), n_steps=4)
    w35 = _seeded_net(3, 5, seed=4)
    for dtype in (torch.float32, torch.bfloat16):
        xd = x0.to(dtype)
        _assert_bitwise(chaotic_ann.chaotic_ann_traj(*w35, xd, n_steps=4),
                        ref.chaotic_ann_ref(*w35, xd, 4))
        words, state = chaotic_ann.chaotic_ann_bits(*w35, xd, off, n_steps=4)
        want_w, want_s = ref.chaotic_ann_bits_ref(*w35, xd, 4, off)
        _assert_bitwise(words, want_w)
        _assert_bitwise(state, want_s)


def _gang_weights(gang):
    per_core = []
    for name in GANGS[gang]:
        if name.startswith("registry:"):
            p = default_params(system=name.split(":")[1])
        else:
            with np.load(FARM / name / "weights.npz") as npz:
                p = dict(npz)
        per_core.append([np.asarray(p[k], np.float32)
                         for k in ("w1", "b1", "w2", "b2")])
    return [torch.from_numpy(np.stack(ws)).cuda() for ws in zip(*per_core)]


def _assert_bitwise(a, b):
    if a.dtype == torch.uint32:
        assert torch.equal(ops.from_uint32(a), ops.from_uint32(b))
    else:
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("ragged", [False, True], ids=["padded", "ragged"])
@pytest.mark.parametrize("gang", sorted(GANGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gang_kernels_bitwise_vs_plain_on_card(gang, dtype, ragged):
    """K3 and K4 against their plain versions: the words each block or
    core asked for, and the final states."""
    _need_card()
    w = _gang_weights(gang)
    n_cores, i_dim = w[0].shape[0], w[0].shape[1]
    rng = np.random.default_rng(22)
    n_steps, s_block, n_blocks = 64, 256, 6
    # K3: demands of 0, not a multiple of the granularity (unroll 8), and
    # above the launch's 32 rows
    core_map = np.arange(n_blocks) % n_cores
    row_map = np.array([0, 3, 32, 17, 40, 9]) if ragged else None
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_blocks * s_block, i_dim))
                          .astype(np.float32)).to("cuda", dtype)
    off = torch.from_numpy(rng.integers(0, 1 << 32, n_blocks * s_block))
    off[:4] = torch.tensor([0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0])
    off = off.cuda()
    n0 = chaotic_ann.chaotic_ann_gang_bits.launches
    words, state = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, off, row_map, n_steps=n_steps, s_block=s_block,
        t_block=256, unroll=8)
    assert chaotic_ann.chaotic_ann_gang_bits.launches == n0 + 1
    rows = (chaotic_ann.gang_effective_rows(row_map, n_steps, 256, 8)
            if ragged else np.full(n_blocks, n_steps // 2))
    rw, rs = ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps, off,
                                           rows)
    torch.cuda.synchronize()
    for g, r in enumerate(rows):
        lanes = slice(g * s_block, (g + 1) * s_block)
        _assert_bitwise(words[:r, lanes], rw[:r, lanes])
    _assert_bitwise(state, rs)
    # K4: a ragged lane count per core, and a zero demand
    n_lanes = 300 + 37
    xs = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_cores, n_lanes, i_dim))
                          .astype(np.float32)).to("cuda", dtype)
    offs = torch.from_numpy(rng.integers(0, 1 << 32, (n_cores, n_lanes)))
    offs = offs.cuda()
    srows = ([0, 13, 40, 32][:n_cores] if ragged else None)
    n0 = chaotic_ann.chaotic_ann_gang_stacked.launches
    words, state = chaotic_ann.chaotic_ann_gang_stacked(
        *w, xs, offs, srows, n_steps=n_steps)
    assert chaotic_ann.chaotic_ann_gang_stacked.launches == n0 + 1
    rw, rs = ref.chaotic_ann_gang_stacked_ref(*w, xs, n_steps, offs, srows)
    torch.cuda.synchronize()
    for c in range(n_cores):
        r = n_steps // 2 if srows is None else min(srows[c], n_steps // 2)
        _assert_bitwise(words[:r, c], rw[:r, c])
    _assert_bitwise(state, rs)


def test_gang_ops_on_card_never_reach_the_plain_version(monkeypatch):
    _need_card()
    w = _gang_weights("3-8")
    params = dict(zip(("w1", "b1", "w2", "b2"), w))
    x0 = torch.rand(4 * 128, 3, device="cuda") - 0.5
    kw = dict(core_map=[0, 3, 1, 2], row_map=[1, 9, 0, 4], s_block=128,
              t_block=16, unroll=4)
    want = ops.chaotic_bits_gang(params, x0, 24, 7, backend="ref", **kw)
    xs = x0.reshape(4, 128, 3)
    want_s = ops.chaotic_bits_gang_stacked(params, xs, 24, 5,
                                           row_map=[3, 12, 0, 5],
                                           backend="ref")

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(ref, "chaotic_ann_gang_bits_ref", forbidden)
    monkeypatch.setattr(ref, "chaotic_ann_gang_stacked_ref", forbidden)
    got = ops.chaotic_bits_gang(params, x0, 24, 7, **kw)
    got_s = ops.chaotic_bits_gang_stacked(params, xs, 24, 5,
                                          row_map=[3, 12, 0, 5])
    torch.cuda.synchronize()
    rows = chaotic_ann.gang_effective_rows(kw["row_map"], 24, 16, 4)
    for g, r in enumerate(rows):
        lanes = slice(g * 128, (g + 1) * 128)
        _assert_bitwise(got[0][:r, lanes], want[0][:r, lanes])
    _assert_bitwise(got[1], want[1])
    for c, r in enumerate([3, 12, 0, 5]):
        _assert_bitwise(got_s[0][:r, c], want_s[0][:r, c])
    _assert_bitwise(got_s[1], want_s[1])


def test_gang_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    w = _gang_weights("3-8")
    x0 = torch.zeros(256, 3, device="cuda")
    with pytest.raises(ValueError, match="multiple of 128"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0, [0, 1, 2, 3], n_steps=4,
                                          s_block=64)
    with pytest.raises(ValueError, match="contiguous"):
        chaotic_ann.chaotic_ann_gang_stacked(
            *w, torch.zeros(4, 3, 64, device="cuda").transpose(1, 2),
            n_steps=4)
    with pytest.raises(ValueError, match=r"b1 must be \(4, 8\)"):
        chaotic_ann.chaotic_ann_gang_bits(w[0], w[1][:, :5], *w[2:], x0,
                                          [0, 1], n_steps=4, s_block=128)


# the default library's lattices, and two shape libraries' whose lane slot
# spans two warps (40 nodes in 64 threads; an 8 x 8 torus)
LATTICES = ("chen@ring8", "chen@grid8", "chen@ring32", "chen@grid32",
            "chen@ring40", "chen@grid64")


def _lattice_inputs(system, n_lanes, dtype, seed):
    from repro_torch.core.ann import lattice_meta_tuple
    rng = np.random.default_rng(seed)
    p = default_params(system=system)
    lattice = lattice_meta_tuple(p["lattice_meta"])
    w = [torch.from_numpy(p[k]).cuda() for k in ("w1", "b1", "w2", "b2")]
    x0 = rng.uniform(-0.9, 0.9, (n_lanes, p["w1"].shape[0])).astype(np.float32)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off[:4] = [0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0]
    return (w, lattice, torch.from_numpy(x0).to("cuda", dtype),
            torch.from_numpy(off).to("cuda"))


@pytest.mark.parametrize("system", LATTICES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lattice_kernels_bitwise_vs_plain_on_card(system, dtype):
    """Lattice K1 and K2 against the plain dense versions: words, final
    state and trajectory, at a ragged lane count (not a whole CTA)."""
    _need_card()
    w, lattice, x0, off = _lattice_inputs(system, 100 + 3, dtype, seed=23)
    n0 = (chaotic_ann.chaotic_ann_lattice_bits.launches,
          chaotic_ann.chaotic_ann_lattice_traj.launches)
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=32,
                                                lattice=lattice)
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=32, lattice=lattice)
    assert (chaotic_ann.chaotic_ann_lattice_bits.launches,
            chaotic_ann.chaotic_ann_lattice_traj.launches) == (n0[0] + 1,
                                                               n0[1] + 1)
    rw, rs = ref.chaotic_ann_bits_ref(*w, x0, 32, off, lattice=lattice)
    torch.cuda.synchronize()
    _assert_bitwise(words, rw)
    _assert_bitwise(state, rs)
    _assert_bitwise(traj, ref.chaotic_ann_ref(*w, x0, 32, lattice=lattice))


def test_lattice_ops_on_card_never_reach_the_plain_version(monkeypatch):
    _need_card()
    p = params_from_numpy(default_params(system="chen@ring8"), device="cuda")
    x0 = torch.rand(2 * 128, 24, device="cuda") - 0.5
    want_w, want_s = ops.chaotic_bits(p, x0, 8, 3, backend="ref")
    want_t = ops.chaotic_trajectory(p, x0, 4, backend="ref")

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(ref, "chaotic_ann_bits_ref", forbidden)
    monkeypatch.setattr(ref, "chaotic_ann_ref", forbidden)
    words, state = ops.chaotic_bits(p, x0, 8, 3)
    traj = ops.chaotic_trajectory(p, x0, 4)
    torch.cuda.synchronize()
    _assert_bitwise(words, want_w)
    _assert_bitwise(state, want_s)
    _assert_bitwise(traj, want_t)


def test_lattice_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    w, lattice, x0, off = _lattice_inputs("chen@ring8", 64, torch.float32, 4)
    bad = dict(default_params(system="chen@ring8"))
    bad["w1"] = bad["w1"].copy()
    bad["w1"][0, -1] = 0.5               # an off-block weight
    with pytest.raises(ValueError, match="block-diagonal"):
        params_from_numpy(bad, device="cuda")
    # chen@ring8's weights read as a ring of 4 nodes of a 6-16 base (its
    # 3-8 blocks lie inside the 6-16 ones): a shape library's kernels,
    # bitwise the plain version
    four = (4, 6, "ring", 0.05)
    _assert_bitwise(chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=4,
                                                 lattice=four),
                    ref.chaotic_ann_ref(*w, x0, 4, lattice=four))
    with pytest.raises(ValueError, match="i_dim"):
        chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=4,
                                     lattice=(4, 3, "ring", 0.05))
    # 40 nodes (a slot of two warps) launch; more than 1,024 nodes (as a
    # descriptor and a shape key: no expansion built) and a state that is
    # no whole number of sublanes do not
    w40, ring40, x40, off40 = _lattice_inputs("chen@ring40", 8,
                                              torch.float32, 4)
    n0 = chaotic_ann.chaotic_ann_lattice_bits.launches
    got = chaotic_ann.chaotic_ann_bits(*w40, x40, off40, n_steps=4,
                                       lattice=ring40)
    assert chaotic_ann.chaotic_ann_lattice_bits.launches == n0 + 1
    for g, e in zip(got, ref.chaotic_ann_bits_ref(*w40, x40, 4, off40,
                                                  lattice=ring40)):
        _assert_bitwise(g, e)
    with pytest.raises(ValueError, match="1,024"):
        chaotic_ann.check_card_lattice((1_032, 3, "ring", 0.05), 3_096)
    with pytest.raises(ValueError, match="1,024"):
        ops.prepare([("lattice", (3, 8, 1_032, 0))])
    with pytest.raises(ValueError, match="sublanes"):
        chaotic_ann.chaotic_ann_traj(
            w[0][:12, :32], w[1][:32], w[2][:32, :12], w[3][:12],
            x0[:, :12].contiguous(), n_steps=4, lattice=(4, 3, "ring", 0.05))


MXU_SYSTEMS = ("chen", "hyperlorenz") + LATTICES


@pytest.mark.parametrize("system", MXU_SYSTEMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_kernels_bitwise_vs_plain_on_card(system, dtype):
    """mxu K1 and K2 (scalar cores, and lattices with the coupling dot)
    against the plain dense FMA chains: words, final state and trajectory,
    at a ragged lane count and with offsets that wrap past 2**32."""
    _need_card()
    rng = np.random.default_rng(31)
    p = params_from_numpy(default_params(system=system), device="cuda")
    w = [p[k] for k in ("w1", "b1", "w2", "b2")]
    kw = dict(lattice=None, coupling=None)
    if "lattice_meta" in p:
        from repro_torch.core.ann import lattice_meta_tuple
        kw = dict(lattice=lattice_meta_tuple(p["lattice_meta"]),
                  coupling=p["coupling"])
    n_lanes = 100 + 3 if kw["lattice"] else 1000 + 37
    x0 = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_lanes, w[0].shape[0]))
                          .astype(np.float32)).to("cuda", dtype)
    off_np = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off_np[:4] = [0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0]
    off = torch.from_numpy(off_np).to("cuda")
    n0 = (chaotic_ann.chaotic_ann_mxu_bits.launches,
          chaotic_ann.chaotic_ann_mxu_traj.launches)
    words, state = chaotic_ann.chaotic_ann_bits(
        *w, x0, off, n_steps=32, compute_unit="mxu", **kw)
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=32,
                                        compute_unit="mxu", **kw)
    assert (chaotic_ann.chaotic_ann_mxu_bits.launches,
            chaotic_ann.chaotic_ann_mxu_traj.launches) == (n0[0] + 1,
                                                           n0[1] + 1)
    rw, rs = ref.chaotic_ann_bits_ref(*w, x0, 32, off, compute_unit="mxu",
                                      **kw)
    torch.cuda.synchronize()
    _assert_bitwise(words, rw)
    _assert_bitwise(state, rs)
    _assert_bitwise(traj, ref.chaotic_ann_ref(*w, x0, 32, compute_unit="mxu",
                                              **kw))


def test_mxu_service_on_card_never_reaches_the_plain_version(monkeypatch):
    """The no-config chen@ring32 service picks the mxu unit and serves
    through mxu K1 alone; its words equal the plain version's."""
    _need_card()
    from repro_torch.serve.prng_service import PRNGService
    p = default_params(system="chen@ring32")
    want = PRNGService(p, lanes_per_client=32, burn_in=4, device="cpu")
    want.register("a", seed=5)
    want_words = want.draw("a", 256)

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(ref, "chaotic_ann_bits_ref", forbidden)
    monkeypatch.setattr(ref, "chaotic_ann_ref", forbidden)
    n0 = {name: getattr(chaotic_ann, name).launches
          for name in ("chaotic_ann_mxu_bits", "chaotic_ann_bits",
                       "chaotic_ann_lattice_bits")}
    svc = PRNGService(p, lanes_per_client=32, burn_in=4, device="cuda")
    assert svc.config.compute_unit == "mxu"
    svc.register("a", seed=5)
    np.testing.assert_array_equal(svc.draw("a", 256), want_words)
    assert {name: getattr(chaotic_ann, name).launches - n
            for name, n in n0.items()} == {"chaotic_ann_mxu_bits": 2,
                                           "chaotic_ann_bits": 0,
                                           "chaotic_ann_lattice_bits": 0}


def test_mxu_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    w, lattice, x0, off = _lattice_inputs("chen@ring8", 64, torch.float32, 4)
    with pytest.raises(ValueError, match="coupling"):
        chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=4, lattice=lattice,
                                     compute_unit="mxu")
    # the lattice's weights as one dense 24-64 net on the mxu unit: a
    # shape library's kernel, bitwise the plain dense FMA chains
    _assert_bitwise(
        chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=4, compute_unit="mxu"),
        ref.chaotic_ann_ref(*w, x0, 4, compute_unit="mxu"))
    # 40 nodes launch, bitwise the plain chains; past 1,024 nodes (a shape
    # key: no expansion built) the card refuses
    w40, ring40, x40, off40 = _lattice_inputs("chen@ring40", 8,
                                              torch.float32, 4)
    cpl40 = torch.from_numpy(
        default_params(system="chen@ring40")["coupling"]).cuda()
    got = chaotic_ann.chaotic_ann_bits(*w40, x40, off40, n_steps=4,
                                       lattice=ring40, compute_unit="mxu",
                                       coupling=cpl40)
    for g, e in zip(got, ref.chaotic_ann_bits_ref(
            *w40, x40, 4, off40, lattice=ring40, compute_unit="mxu",
            coupling=cpl40)):
        _assert_bitwise(g, e)
    with pytest.raises(ValueError, match="1,024"):
        ops.prepare([("mxu", (3, 8, 1_032, 0))])
    bad = dict(default_params(system="chen@ring8"))
    bad["coupling"] = bad["coupling"].copy()
    bad["coupling"][0, 12] = 0.05        # node 0 <- node 4: not a neighbour
    with pytest.raises(ValueError, match="support"):
        params_from_numpy(bad, device="cuda")


LATTICE_GANGS = ("ring8", "grid8", "ring32", "ring40", "grid64")


def _lattice_gang(topology):
    """The stacked (C=4, ...) weights, on the card, of chen, chua, lorenz
    and rossler as lattices of one descriptor, and that descriptor."""
    from repro_torch.core.ann import lattice_meta_tuple
    per_core = [default_params(system=f"{b}@{topology}")
                for b in ("chen", "chua", "lorenz", "rossler")]
    w = [torch.from_numpy(np.stack([p[k] for p in per_core])).cuda()
         for k in ("w1", "b1", "w2", "b2")]
    return w, lattice_meta_tuple(per_core[0]["lattice_meta"])


def _masked_rows(words, rows):
    """The uint32 words as int64, zero past each lane's (or core's)
    rows; ``rows`` broadcasts against one word row."""
    r = torch.arange(words.shape[0], device=words.device)
    r = r.reshape((-1,) + (1,) * (words.ndim - 1))
    return torch.where(r < rows, ops.from_uint32(words), 0)


def _x0_np(rng, shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def _off_np(rng, shape):
    off = rng.integers(0, 1 << 32, shape, dtype=np.int64)
    off.reshape(-1)[:4] = [0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0]
    return off


@pytest.mark.parametrize("topology", LATTICE_GANGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lattice_gang_kernels_bitwise_vs_plain_on_card(topology, dtype):
    """Lattice K3 (s_block 48: three CTAs of 16 ring8 lanes, twelve of 4
    ring32 lanes; ragged rows, offsets that wrap) and lattice K4 (137 lanes
    a core: a ragged CTA edge in every core; one core frozen early, one at
    0 rows) against their plain versions: the words each block or core
    asked for, and the final states, bitwise."""
    _need_card()
    w, lattice = _lattice_gang(topology)
    i_dim = w[0].shape[1]
    rng = np.random.default_rng(37)
    n_steps, s_block = 32, 48
    core_map = np.array([2, 0, 3, 1, 1, 0])
    row_map = np.array([16, 3, 0, 9, 40, 1])
    x0 = torch.from_numpy(_x0_np(rng, (6 * s_block, i_dim))).to("cuda", dtype)
    off = torch.from_numpy(_off_np(rng, 6 * s_block)).to("cuda")
    n0 = (chaotic_ann.chaotic_ann_lattice_gang_bits.launches,
          chaotic_ann.chaotic_ann_lattice_gang_stacked.launches)
    words, state = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, off, row_map, n_steps=n_steps, s_block=s_block,
        t_block=8, unroll=2, lattice=lattice)
    rows = chaotic_ann.gang_effective_rows(row_map, n_steps, 8, 2)
    rw, rs = ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps, off,
                                           rows, lattice=lattice)
    lane_rows = torch.from_numpy(np.repeat(rows, s_block)).cuda()
    xs = torch.from_numpy(_x0_np(rng, (4, 137, i_dim))).to("cuda", dtype)
    offs = torch.from_numpy(_off_np(rng, (4, 137))).to("cuda")
    srows = [16, 5, 0, 16]
    sw, ss = chaotic_ann.chaotic_ann_gang_stacked(
        *w, xs, offs, srows, n_steps=n_steps, lattice=lattice)
    rsw, rss = ref.chaotic_ann_gang_stacked_ref(*w, xs, n_steps, offs, srows,
                                                lattice=lattice)
    torch.cuda.synchronize()
    assert (chaotic_ann.chaotic_ann_lattice_gang_bits.launches,
            chaotic_ann.chaotic_ann_lattice_gang_stacked.launches) == (
                n0[0] + 1, n0[1] + 1)
    assert torch.equal(_masked_rows(words, lane_rows),
                       _masked_rows(rw, lane_rows))
    _assert_bitwise(state, rs)
    core_rows = torch.tensor(srows, device="cuda")[:, None]
    assert torch.equal(_masked_rows(sw, core_rows),
                       _masked_rows(rsw, core_rows))
    _assert_bitwise(ss, rss)


def test_lattice_farm_on_card_never_reaches_the_plain_version(monkeypatch):
    """Two chen@ring8-shaped lattice cores beside the scalar chen: one
    stacked lattice launch, then lane-concat, each equal to the CPU farm's
    words (the plain versions), and no scalar gang kernel launched."""
    _need_card()
    from repro_torch.core.dse import Candidate
    from repro_torch.serve.farm import OscillatorFarm
    lat = Candidate(i_dim=24, h_dim=64, p=0, compute_unit="vpu",
                    dtype_bytes=2, t_block=8, unroll=2, n_nodes=8)
    scal = Candidate(i_dim=3, h_dim=8, p=0, compute_unit="vpu",
                     dtype_bytes=2, t_block=32, unroll=2)

    def farm_on(device):
        farm = OscillatorFarm(device=device)
        for name, system in (("a", "chen@ring8"), ("b", "lorenz@ring8")):
            farm.add_core(name, default_params(system=system), config=lat,
                          dtype=torch.bfloat16, lanes_per_client=32)
        farm.add_core("chen", default_params(), config=scal,
                      dtype=torch.bfloat16, lanes_per_client=32)
        for i, core in enumerate(farm.cores):
            farm.register(core, "t", seed=i)
        return farm

    def serve(farm):
        """A uniform flush (stacked), then one more client on b (concat)."""
        for core in farm.cores:
            farm.request(core, "t", 512)
        out = [farm.flush()]
        farm.register("b", "u", seed=9)
        for core in farm.cores:
            for client in farm.services[core].clients:
                farm.request(core, client, 256)
        return out + [farm.flush()]

    want = serve(farm_on("cpu"))

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    farm = farm_on("cuda")
    for name in ("chaotic_ann_gang_bits_ref", "chaotic_ann_gang_stacked_ref",
                 "chaotic_ann_bits_ref"):
        monkeypatch.setattr(ref, name, forbidden)
    names = ("chaotic_ann_lattice_gang_bits",
             "chaotic_ann_lattice_gang_stacked", "chaotic_ann_gang_bits",
             "chaotic_ann_gang_stacked")
    n0 = {n: getattr(chaotic_ann, n).launches for n in names}
    for g, e in zip(serve(farm), want):
        assert set(g) == set(e)
        for core in e:
            for client in e[core]:
                np.testing.assert_array_equal(g[core][client],
                                              e[core][client])
    assert {n: getattr(chaotic_ann, n).launches - n0[n] for n in names} == {
        "chaotic_ann_lattice_gang_bits": 1,
        "chaotic_ann_lattice_gang_stacked": 1, "chaotic_ann_gang_bits": 0,
        "chaotic_ann_gang_stacked": 0}


def test_lattice_gang_wrappers_reject_what_the_kernels_do_not_take():
    _need_card()
    w, lattice = _lattice_gang("ring8")
    x0 = torch.zeros(4 * 32, 24, device="cuda")
    # the four ring8 cores read as rings of 4 nodes of a 6-16 base: the
    # shape library's K3 (s_block a multiple of 128 / 4) and K4, bitwise
    # their plain versions
    four = (4, 6, "ring", 0.05)
    xs = torch.from_numpy(_x0_np(np.random.default_rng(5), (4 * 32, 24)))
    xs = xs.cuda()
    got = chaotic_ann.chaotic_ann_gang_bits(*w, xs, [0, 1, 2, 3], n_steps=4,
                                            s_block=32, lattice=four)
    want = ref.chaotic_ann_gang_bits_ref(*w, xs, np.array([0, 1, 2, 3]), 4,
                                         lattice=four)
    for g, e in zip(got, want):
        _assert_bitwise(g, e)
    got = chaotic_ann.chaotic_ann_gang_stacked(*w, xs.reshape(4, 32, 24),
                                               n_steps=4, lattice=four)
    want = ref.chaotic_ann_gang_stacked_ref(*w, xs.reshape(4, 32, 24), 4,
                                            lattice=four)
    for g, e in zip(got, want):
        _assert_bitwise(g, e)
    # 40 nodes: K3 at s_block 4 (a multiple of the CTA's two lanes) and
    # K4, bitwise; past 1,024 nodes the card refuses (a shape key)
    w40, ring40, _, _ = _lattice_inputs("chen@ring40", 8, torch.float32, 4)
    w40 = [torch.stack([t, t * 0.9375]) for t in w40]
    x40 = torch.from_numpy(_x0_np(np.random.default_rng(6), (2 * 4, 120)))
    x40 = x40.cuda()
    got = chaotic_ann.chaotic_ann_gang_bits(*w40, x40, [0, 1], n_steps=4,
                                            s_block=4, lattice=ring40)
    want = ref.chaotic_ann_gang_bits_ref(*w40, x40, np.array([0, 1]), 4,
                                         lattice=ring40)
    for g, e in zip(got, want):
        _assert_bitwise(g, e)
    got = chaotic_ann.chaotic_ann_gang_stacked(*w40, x40.reshape(2, 4, 120),
                                               n_steps=4, lattice=ring40)
    want = ref.chaotic_ann_gang_stacked_ref(*w40, x40.reshape(2, 4, 120), 4,
                                            lattice=ring40)
    for g, e in zip(got, want):
        _assert_bitwise(g, e)
    with pytest.raises(ValueError, match="1,024"):
        ops.prepare([("lattice", (4, 16, 1_026, 0))])
    with pytest.raises(ValueError, match="multiple of 16"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0[:4 * 8], [0, 1, 2, 3],
                                          n_steps=4, s_block=8,
                                          lattice=lattice)


# K3's mxu form at every MXU_SHAPES entry: the scalar gangs (3-8, 4-16) and
# the four 3-8 bases as lattices of each compiled descriptor
MXU_GANGS = ("3-8", "4-16", "ring8", "grid8", "ring32", "grid32", "ring40",
             "grid64")


def _mxu_gang(gang):
    """Stacked weights on the card, the lattice descriptor and the one
    shared coupling operand (None, None for a scalar gang)."""
    if gang in GANGS:
        return _gang_weights(gang), None, None
    w, lattice = _lattice_gang(gang)
    cpl = default_params(system=f"chen@{gang}")["coupling"]
    return w, lattice, torch.from_numpy(cpl).cuda()


@pytest.mark.parametrize("ragged", [False, True], ids=["padded", "ragged"])
@pytest.mark.parametrize("gang", MXU_GANGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_gang_kernel_bitwise_vs_plain_on_card(gang, dtype, ragged):
    """mxu K3 (six blocks of 128 lanes, a CTA's worth for a scalar core;
    demands of 0, odd and above the launch's rows; offsets that wrap)
    against its plain version: the words each block asked for, and the
    final states, bitwise; one launch of the mxu K3 and no other gang
    kernel."""
    _need_card()
    w, lattice, cpl = _mxu_gang(gang)
    n_cores, i_dim = w[0].shape[0], w[0].shape[1]
    rng = np.random.default_rng(38)
    n_steps, s_block, n_blocks = 32, 128, 6
    core_map = np.arange(n_blocks) % n_cores
    row_map = np.array([0, 3, 16, 9, 40, 1]) if ragged else None
    x0 = torch.from_numpy(_x0_np(rng, (n_blocks * s_block, i_dim))).to(
        "cuda", dtype)
    off = torch.from_numpy(_off_np(rng, n_blocks * s_block)).to("cuda")
    names = ("chaotic_ann_mxu_gang_bits", "chaotic_ann_gang_bits",
             "chaotic_ann_lattice_gang_bits", "chaotic_ann_mxu_bits")
    n0 = {n: getattr(chaotic_ann, n).launches for n in names}
    words, state = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, off, row_map, n_steps=n_steps, s_block=s_block,
        t_block=8, unroll=2, compute_unit="mxu", lattice=lattice,
        coupling=cpl)
    assert {n: getattr(chaotic_ann, n).launches - n0[n] for n in names} == {
        "chaotic_ann_mxu_gang_bits": 1, "chaotic_ann_gang_bits": 0,
        "chaotic_ann_lattice_gang_bits": 0, "chaotic_ann_mxu_bits": 0}
    rows = (chaotic_ann.gang_effective_rows(row_map, n_steps, 8, 2)
            if ragged else np.full(n_blocks, n_steps // 2))
    rw, rs = ref.chaotic_ann_gang_bits_ref(
        *w, x0, core_map, n_steps, off, rows, lattice=lattice,
        compute_unit="mxu", coupling=cpl)
    torch.cuda.synchronize()
    lane_rows = torch.from_numpy(np.repeat(rows, s_block)).cuda()
    assert torch.equal(_masked_rows(words, lane_rows),
                       _masked_rows(rw, lane_rows))
    _assert_bitwise(state, rs)


def test_mxu_farm_on_card_never_reaches_the_plain_version(monkeypatch):
    """Two no-config chen@ring32-descriptor cores (the mxu unit) and two
    3-8-3 cores on an mxu config: each group one mxu K3 launch per flush,
    a uniform flush and one with unequal pools, each equal to the CPU
    farm's words (the plain versions); no other kernel launched but the
    new client's burn-in (one mxu K1)."""
    _need_card()
    from repro_torch.core.dse import select_config
    from repro_torch.serve.farm import OscillatorFarm
    scal = select_config(3, 8, s_total=128, dtype=torch.bfloat16, unit="mxu")

    def farm_on(device):
        farm = OscillatorFarm(device=device)
        for name in ("chen@ring32", "lorenz@ring32"):
            farm.add_core(name, default_params(system=name),
                          dtype=torch.bfloat16, burn_in=2)
        for name in ("chen", "rossler"):
            farm.add_core(name, default_params(system=name), config=scal,
                          dtype=torch.bfloat16, burn_in=2)
        for i, core in enumerate(farm.cores):
            farm.register(core, "t", seed=i)
        return farm

    def serve(farm):
        """A uniform flush, then one more client on lorenz@ring32."""
        for core in farm.cores:
            farm.request(core, "t", 512)
        out = [farm.flush()]
        farm.register("lorenz@ring32", "u", seed=9)
        for core in farm.cores:
            for client in farm.services[core].clients:
                farm.request(core, client, 512)
        return out + [farm.flush()]

    want = serve(farm_on("cpu"))

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    farm = farm_on("cuda")
    assert all(s.config.compute_unit == "mxu" for s in farm.services.values())
    for name in ("chaotic_ann_gang_bits_ref", "chaotic_ann_gang_stacked_ref",
                 "chaotic_ann_bits_ref", "chaotic_ann_ref"):
        monkeypatch.setattr(ref, name, forbidden)
    names = ("chaotic_ann_mxu_gang_bits", "chaotic_ann_mxu_bits",
             "chaotic_ann_gang_bits", "chaotic_ann_gang_stacked",
             "chaotic_ann_lattice_gang_bits",
             "chaotic_ann_lattice_gang_stacked")
    n0 = {n: getattr(chaotic_ann, n).launches for n in names}
    for g, e in zip(serve(farm), want):
        assert set(g) == set(e)
        for core in e:
            for client in e[core]:
                np.testing.assert_array_equal(g[core][client],
                                              e[core][client])
    got = {n: getattr(chaotic_ann, n).launches - n0[n] for n in names}
    assert got == dict.fromkeys(names, 0) | {"chaotic_ann_mxu_gang_bits": 4,
                                             "chaotic_ann_mxu_bits": 1}


def test_mxu_gang_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    w, lattice, cpl = _mxu_gang("ring32")
    x0 = torch.zeros(4 * 8, 96, device="cuda")
    kw = dict(n_steps=4, compute_unit="mxu", lattice=lattice)
    with pytest.raises(ValueError, match="multiple of 4"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0[:4 * 2], [0, 1, 2, 3],
                                          s_block=2, coupling=cpl, **kw)
    with pytest.raises(ValueError, match="coupling"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0, [0, 1, 2, 3], s_block=8,
                                          **kw)
    with pytest.raises(ValueError, match="coupling"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0, [0, 1, 2, 3], s_block=8,
                                          coupling=cpl[:48, :48], **kw)
    with pytest.raises(ValueError, match="coupling"):
        chaotic_ann.chaotic_ann_gang_bits(*w, x0, [0, 1, 2, 3], s_block=8,
                                          coupling=cpl.cpu(), **kw)
    with pytest.raises(ValueError, match=r"w1 must be"):
        chaotic_ann.chaotic_ann_gang_bits(w[0].cpu(), *w[1:], x0,
                                          [0, 1, 2, 3], s_block=8,
                                          coupling=cpl, **kw)
    with pytest.raises(ValueError, match="CUDA"):      # no silent fallback
        chaotic_ann.chaotic_ann_gang_bits(*w, x0.to("meta"), [0, 1, 2, 3],
                                          s_block=8, coupling=cpl, **kw)
    ws = _gang_weights("3-8")
    xs = torch.zeros(4 * 64, 3, device="cuda")
    with pytest.raises(ValueError, match="multiple of 128"):
        chaotic_ann.chaotic_ann_gang_bits(*ws, xs, [0, 1, 2, 3], n_steps=4,
                                          s_block=64, compute_unit="mxu")
    with pytest.raises(ValueError, match="vpu"):
        chaotic_ann.chaotic_ann_gang_stacked(*ws, xs.reshape(4, 64, 3),
                                             n_steps=4, compute_unit="mxu")


# ---------------------------------------------------------------------------
# tanh and sigmoid: the scalar vpu K1 and K2, and the paper flow
# ---------------------------------------------------------------------------

ACTIVATIONS = ("tanh", "sigmoid")


def _activation_edges():
    """The formulas' edges: the tanh clamp and small-x select, the exp
    clamp and the sigmoid's flush (results below FLT_MIN), +-0, denormal
    inputs, each with its float32 neighbours."""
    edges = np.array([0.0004, 7.99881172180175781, 88.7, 87.34, 87.5, 88.0,
                      88.5, 103.0, 1e-40, 1.4e-45, 1e-30, 0.0, 1.0],
                     np.float32)
    edges = np.concatenate([edges, -edges])
    return np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])


def _f32_inputs(seed, n):
    """``n`` seeded float32 inputs over the activations' whole range, and
    the edges."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0.0, 3.0, n // 2), rng.uniform(-110.0, 110.0, n // 4),
        rng.uniform(-1e-3, 1e-3, n - n // 2 - n // 4)]).astype(np.float32)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_device_activation_equals_plain_on_card(activation):
    """The kernels' tanh and sigmoid (the check hook) equal the plain
    formulas on every finite bf16 pattern and on 2**24 f32 inputs."""
    _need_card()
    pat = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    xb = pat.view(torch.bfloat16).cuda()
    xb = xb[torch.isfinite(xb.float())]
    got = chaotic_ann.activation(xb, activation)
    assert torch.equal(got.view(torch.int16),
                       ref.ACTIVATIONS[activation](xb).view(torch.int16))
    x = torch.from_numpy(np.concatenate(
        [_f32_inputs(7, 1 << 24), _activation_edges()])).cuda()
    n0 = chaotic_ann.activation.launches
    got = chaotic_ann.activation(x, activation)
    assert chaotic_ann.activation.launches == n0 + 1
    assert torch.equal(got.view(torch.int32),
                       ref.ACTIVATIONS[activation](x).view(torch.int32))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", ["chen", "hyperlorenz"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_kernels_bitwise_vs_plain_on_card(system, dtype,
                                                     activation):
    """tanh/sigmoid K1 and K2 (scalar vpu) equal their plain versions:
    words, final state and trajectory."""
    _need_card()
    w, x0, off = _inputs(system, 1000 + 37, dtype, seed=41)
    n0 = (chaotic_ann.chaotic_ann_bits.launches,
          chaotic_ann.chaotic_ann_traj.launches)
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=64,
                                                activation=activation)
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=64,
                                        activation=activation)
    assert (chaotic_ann.chaotic_ann_bits.launches,
            chaotic_ann.chaotic_ann_traj.launches) == (n0[0] + 1, n0[1] + 1)
    rt = ref.chaotic_ann_ref(*w, x0, 64, activation)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(traj.view(bits), rt.view(bits))
    assert torch.equal(ops.from_uint32(words),
                       ops.from_uint32(ops.pack_words(rt, off)))
    assert torch.equal(state.view(bits), rt[-1].view(bits))
    relu = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=64)
    assert not torch.equal(relu, traj)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("gang", sorted(GANGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_gang_kernels_bitwise_vs_plain_on_card(gang, dtype,
                                                          activation):
    """tanh/sigmoid K3 (ragged rows) and K4 (a frozen and a clamped core)
    equal their plain versions: the words each block or core asked for,
    and the final states; the words differ from relu's."""
    _need_card()
    w = _gang_weights(gang)
    n_cores, i_dim = w[0].shape[0], w[0].shape[1]
    rng = np.random.default_rng(45)
    n_steps, s_block, n_blocks = 64, 256, 6
    core_map = np.arange(n_blocks) % n_cores
    row_map = np.array([0, 3, 32, 17, 40, 9])
    x0 = torch.from_numpy(_x0_np(rng, (n_blocks * s_block, i_dim))).to(
        "cuda", dtype)
    off = torch.from_numpy(_off_np(rng, n_blocks * s_block)).cuda()
    kw = dict(n_steps=n_steps, s_block=s_block, t_block=256, unroll=8)
    n0 = chaotic_ann.chaotic_ann_gang_bits.launches
    words, state = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, off, row_map, activation=activation, **kw)
    relu, _ = chaotic_ann.chaotic_ann_gang_bits(*w, x0, core_map, off,
                                                row_map, **kw)
    assert chaotic_ann.chaotic_ann_gang_bits.launches == n0 + 2
    rows = chaotic_ann.gang_effective_rows(row_map, n_steps, 256, 8)
    rw, rs = ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps, off,
                                           rows, activation)
    torch.cuda.synchronize()
    for g, r in enumerate(rows):
        lanes = slice(g * s_block, (g + 1) * s_block)
        _assert_bitwise(words[:r, lanes], rw[:r, lanes])
        if r:
            assert not torch.equal(ops.from_uint32(words[:r, lanes]),
                                   ops.from_uint32(relu[:r, lanes]))
    _assert_bitwise(state, rs)
    n_lanes = 300 + 37
    xs = torch.from_numpy(_x0_np(rng, (n_cores, n_lanes, i_dim))).to(
        "cuda", dtype)
    offs = torch.from_numpy(_off_np(rng, (n_cores, n_lanes))).cuda()
    srows = [0, 40, 13, 32][:n_cores]
    n0 = chaotic_ann.chaotic_ann_gang_stacked.launches
    words, state = chaotic_ann.chaotic_ann_gang_stacked(
        *w, xs, offs, srows, n_steps=n_steps, activation=activation)
    assert chaotic_ann.chaotic_ann_gang_stacked.launches == n0 + 1
    rw, rs = ref.chaotic_ann_gang_stacked_ref(*w, xs, n_steps, offs, srows,
                                              activation)
    torch.cuda.synchronize()
    for c in range(n_cores):
        _assert_bitwise(words[:min(srows[c], n_steps // 2), c],
                        rw[:min(srows[c], n_steps // 2), c])
    _assert_bitwise(state, rs)


def test_paper_flow_on_card_never_reaches_the_plain_version(monkeypatch,
                                                            tmp_path):
    """A generated tanh core (the DSE's lowest-cost solution, vpu bf16)
    and a ``ChaoticStream.from_trained`` on the card launch the kernels
    only; the core's testbench passes on the card."""
    _need_card()
    import importlib
    import sys
    from repro_torch.core.codegen import generate_core
    from repro_torch.core.dse import select
    from repro_torch.prng.stream import ChaoticStream
    p = default_params()
    cand = select(3, 8, "lowest_cost")
    generate_core("gpu_tanh_core", tmp_path, params=p, candidate=cand,
                  activation="tanh")
    sys.path.insert(0, str(tmp_path))
    try:
        core = importlib.import_module("gpu_tanh_core")
        tb = importlib.import_module("gpu_tanh_core.testbench")
        assert tb.run(verbose=False, device="cuda")
        x0 = np.random.default_rng(5).uniform(
            -0.5, 0.5, (core.S_BLOCK, 3)).astype(np.float32)
        want_t = core.generate(x0, 16, backend="ref")
        want_w, want_s = core.generate_bits(x0, 16, 5, backend="ref")

        def forbidden(*a, **k):
            raise AssertionError("plain version reached on a CUDA tensor")

        monkeypatch.setattr(ref, "chaotic_ann_bits_ref", forbidden)
        monkeypatch.setattr(ref, "chaotic_ann_ref", forbidden)
        n0 = (chaotic_ann.chaotic_ann_bits.launches,
              chaotic_ann.chaotic_ann_traj.launches)
        assert torch.equal(core.generate(x0, 16).view(torch.int16),
                           want_t.view(torch.int16))
        words, state = core.generate_bits(x0, 16, 5)
        assert torch.equal(ops.from_uint32(words), ops.from_uint32(want_w))
        assert torch.equal(state.view(torch.int16), want_s.view(torch.int16))
        stream = ChaoticStream.from_trained(p, activation="sigmoid")
        assert stream.bits(1000).shape == (1000,)
        assert (chaotic_ann.chaotic_ann_bits.launches - n0[0],
                chaotic_ann.chaotic_ann_traj.launches - n0[1]) == (3, 1)
    finally:
        sys.path.remove(str(tmp_path))
        for name in ("gpu_tanh_core.testbench", "gpu_tanh_core"):
            sys.modules.pop(name, None)


def test_activation_wrappers_reject_what_the_kernels_do_not_take():
    """tanh/sigmoid run in every kernel form: the mxu K1, K3 and a
    lattice's mxu K2 launch on the card and equal their plain versions,
    with tanh words unlike relu's; an unknown activation is a
    ValueError."""
    _need_card()
    w, x0, off = _inputs("chen", 256, torch.float32, seed=5)
    n0 = (chaotic_ann.chaotic_ann_mxu_bits.launches,
          chaotic_ann.chaotic_ann_mxu_gang_bits.launches,
          chaotic_ann.chaotic_ann_mxu_traj.launches)
    words, state = chaotic_ann.chaotic_ann_bits(
        *w, x0, off, n_steps=4, activation="tanh", compute_unit="mxu")
    relu, _ = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=4,
                                           compute_unit="mxu")
    rw, rs = ref.chaotic_ann_bits_ref(*w, x0, 4, off, "tanh",
                                      compute_unit="mxu")
    gw, gs = chaotic_ann.chaotic_ann_gang_bits(
        *[t[None] for t in w], x0, [0], n_steps=4, s_block=256,
        activation="sigmoid", compute_unit="mxu")
    sw, ss = ref.chaotic_ann_bits_ref(*w, x0, 4, 0, "sigmoid",
                                      compute_unit="mxu")
    lw, lattice, lx, _ = _lattice_inputs("chen@ring8", 64, torch.float32, 4)
    cpl = torch.from_numpy(default_params(system="chen@ring8")["coupling"]
                           ).cuda()
    traj = chaotic_ann.chaotic_ann_traj(*lw, lx, n_steps=4, lattice=lattice,
                                        activation="tanh", compute_unit="mxu",
                                        coupling=cpl)
    rt = ref.chaotic_ann_ref(*lw, lx, 4, "tanh", lattice, "mxu", cpl)
    torch.cuda.synchronize()
    assert (chaotic_ann.chaotic_ann_mxu_bits.launches - n0[0],
            chaotic_ann.chaotic_ann_mxu_gang_bits.launches - n0[1],
            chaotic_ann.chaotic_ann_mxu_traj.launches - n0[2]) == (2, 1, 1)
    _assert_bitwise(words, rw)
    _assert_bitwise(state, rs)
    assert not torch.equal(ops.from_uint32(words), ops.from_uint32(relu))
    _assert_bitwise(gw, sw)
    _assert_bitwise(gs, ss)
    _assert_bitwise(traj, rt)
    with pytest.raises(ValueError, match="activation"):
        chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=4, activation="gelu")
    with pytest.raises(ValueError, match="activation"):
        chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=4, activation="gelu",
                                     compute_unit="mxu")
    with pytest.raises(ValueError, match="CUDA"):
        chaotic_ann.activation(x0.half(), "tanh")


# ---------------------------------------------------------------------------
# tanh and sigmoid: the vpu lattice K1-K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", ["chen@ring8", "chen@grid8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_lattice_kernels_bitwise_vs_plain_on_card(system, dtype,
                                                             activation):
    """tanh/sigmoid lattice K1 and K2 against the plain dense versions:
    words, final state and trajectory, at a ragged lane count; the words
    differ from relu's."""
    _need_card()
    w, lattice, x0, off = _lattice_inputs(system, 100 + 3, dtype, seed=46)
    n0 = (chaotic_ann.chaotic_ann_lattice_bits.launches,
          chaotic_ann.chaotic_ann_lattice_traj.launches)
    kw = dict(lattice=lattice, activation=activation)
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=32, **kw)
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=32, **kw)
    relu, _ = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=32,
                                           lattice=lattice)
    assert (chaotic_ann.chaotic_ann_lattice_bits.launches,
            chaotic_ann.chaotic_ann_lattice_traj.launches) == (n0[0] + 2,
                                                               n0[1] + 1)
    rt = ref.chaotic_ann_ref(*w, x0, 32, **kw)
    torch.cuda.synchronize()
    _assert_bitwise(words, ops.pack_words(rt, off))
    _assert_bitwise(state, rt[-1])
    _assert_bitwise(traj, rt)
    assert not torch.equal(ops.from_uint32(words), ops.from_uint32(relu))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("topology", ["ring8", "grid8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_lattice_gang_kernels_bitwise_vs_plain_on_card(
        topology, dtype, activation):
    """tanh/sigmoid lattice K3 (ragged rows, s_block 48) and K4 (137 lanes
    a core, one core frozen early, one at 0 rows) against their plain
    versions: the words each block or core asked for, and the final
    states; K3's words differ from relu's."""
    _need_card()
    w, lattice = _lattice_gang(topology)
    i_dim = w[0].shape[1]
    rng = np.random.default_rng(47)
    n_steps, s_block = 32, 48
    core_map = np.array([2, 0, 3, 1, 1, 0])
    row_map = np.array([16, 3, 0, 9, 40, 1])
    x0 = torch.from_numpy(_x0_np(rng, (6 * s_block, i_dim))).to("cuda", dtype)
    off = torch.from_numpy(_off_np(rng, 6 * s_block)).to("cuda")
    kw = dict(n_steps=n_steps, s_block=s_block, t_block=8, unroll=2,
              lattice=lattice)
    n0 = (chaotic_ann.chaotic_ann_lattice_gang_bits.launches,
          chaotic_ann.chaotic_ann_lattice_gang_stacked.launches)
    words, state = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, off, row_map, activation=activation, **kw)
    relu, _ = chaotic_ann.chaotic_ann_gang_bits(*w, x0, core_map, off,
                                                row_map, **kw)
    rows = chaotic_ann.gang_effective_rows(row_map, n_steps, 8, 2)
    rw, rs = ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps, off,
                                           rows, activation, lattice)
    lane_rows = torch.from_numpy(np.repeat(rows, s_block)).cuda()
    xs = torch.from_numpy(_x0_np(rng, (4, 137, i_dim))).to("cuda", dtype)
    offs = torch.from_numpy(_off_np(rng, (4, 137))).to("cuda")
    srows = [16, 5, 0, 16]
    sw, ss = chaotic_ann.chaotic_ann_gang_stacked(
        *w, xs, offs, srows, n_steps=n_steps, lattice=lattice,
        activation=activation)
    rsw, rss = ref.chaotic_ann_gang_stacked_ref(*w, xs, n_steps, offs, srows,
                                                activation, lattice)
    torch.cuda.synchronize()
    assert (chaotic_ann.chaotic_ann_lattice_gang_bits.launches,
            chaotic_ann.chaotic_ann_lattice_gang_stacked.launches) == (
                n0[0] + 2, n0[1] + 1)
    assert torch.equal(_masked_rows(words, lane_rows),
                       _masked_rows(rw, lane_rows))
    assert not torch.equal(_masked_rows(words, lane_rows),
                           _masked_rows(relu, lane_rows))
    _assert_bitwise(state, rs)
    core_rows = torch.tensor(srows, device="cuda")[:, None]
    assert torch.equal(_masked_rows(sw, core_rows),
                       _masked_rows(rsw, core_rows))
    _assert_bitwise(ss, rss)


# ---------------------------------------------------------------------------
# tanh and sigmoid: the mxu K1-K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", MXU_SYSTEMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_mxu_kernels_bitwise_vs_plain_on_card(system, dtype,
                                                         activation):
    """tanh/sigmoid mxu K1 and K2 at every MXU_SHAPES entry against the
    plain dense FMA chains (phi's f32 result read by the second dot):
    words, final state and trajectory, at a ragged lane count and with
    offsets that wrap past 2**32; the words differ from relu's."""
    _need_card()
    rng = np.random.default_rng(48)
    p = params_from_numpy(default_params(system=system), device="cuda")
    w = [p[k] for k in ("w1", "b1", "w2", "b2")]
    kw = dict(lattice=None, coupling=None, compute_unit="mxu")
    if "lattice_meta" in p:
        from repro_torch.core.ann import lattice_meta_tuple
        kw.update(lattice=lattice_meta_tuple(p["lattice_meta"]),
                  coupling=p["coupling"])
    n_lanes = 100 + 3 if kw["lattice"] else 1000 + 37
    x0 = torch.from_numpy(_x0_np(rng, (n_lanes, w[0].shape[0]))).to(
        "cuda", dtype)
    off = torch.from_numpy(_off_np(rng, n_lanes)).to("cuda")
    n0 = (chaotic_ann.chaotic_ann_mxu_bits.launches,
          chaotic_ann.chaotic_ann_mxu_traj.launches)
    words, state = chaotic_ann.chaotic_ann_bits(
        *w, x0, off, n_steps=16, activation=activation, **kw)
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=16,
                                        activation=activation, **kw)
    relu, _ = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=16, **kw)
    assert (chaotic_ann.chaotic_ann_mxu_bits.launches,
            chaotic_ann.chaotic_ann_mxu_traj.launches) == (n0[0] + 2,
                                                           n0[1] + 1)
    rt = ref.chaotic_ann_ref(*w, x0, 16, activation, **kw)
    torch.cuda.synchronize()
    _assert_bitwise(words, ops.pack_words(rt, off))
    _assert_bitwise(state, rt[-1])
    _assert_bitwise(traj, rt)
    assert not torch.equal(ops.from_uint32(words), ops.from_uint32(relu))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("gang", MXU_GANGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_activation_mxu_gang_kernel_bitwise_vs_plain_on_card(gang, dtype,
                                                             activation):
    """tanh/sigmoid mxu K3 at every MXU_SHAPES entry (six blocks of 128
    lanes, ragged rows) against its plain version: the words each block
    asked for, and the final states; one launch each; the words differ
    from relu's."""
    _need_card()
    w, lattice, cpl = _mxu_gang(gang)
    n_cores, i_dim = w[0].shape[0], w[0].shape[1]
    rng = np.random.default_rng(49)
    n_steps, s_block, n_blocks = 16, 128, 6
    core_map = np.arange(n_blocks) % n_cores
    row_map = np.array([0, 3, 8, 5, 40, 1])
    x0 = torch.from_numpy(_x0_np(rng, (n_blocks * s_block, i_dim))).to(
        "cuda", dtype)
    off = torch.from_numpy(_off_np(rng, n_blocks * s_block)).to("cuda")
    kw = dict(n_steps=n_steps, s_block=s_block, t_block=8, unroll=2,
              compute_unit="mxu", lattice=lattice, coupling=cpl)
    n0 = chaotic_ann.chaotic_ann_mxu_gang_bits.launches
    words, state = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, off, row_map, activation=activation, **kw)
    relu, _ = chaotic_ann.chaotic_ann_gang_bits(*w, x0, core_map, off,
                                                row_map, **kw)
    assert chaotic_ann.chaotic_ann_mxu_gang_bits.launches == n0 + 2
    rows = chaotic_ann.gang_effective_rows(row_map, n_steps, 8, 2)
    rw, rs = ref.chaotic_ann_gang_bits_ref(
        *w, x0, core_map, n_steps, off, rows, activation, lattice, "mxu",
        cpl)
    torch.cuda.synchronize()
    lane_rows = torch.from_numpy(np.repeat(rows, s_block)).cuda()
    assert torch.equal(_masked_rows(words, lane_rows),
                       _masked_rows(rw, lane_rows))
    assert not torch.equal(_masked_rows(words, lane_rows),
                           _masked_rows(relu, lane_rows))
    _assert_bitwise(state, rs)


# the two-lane K2s at odd lane counts: a lone lane-a half, lane-b halves
# partly live, a ragged last CTA and, for a scalar core, steps whose values
# start mid-chunk (n_lanes * I * itemsize not a multiple of 16)
TRAJ_X2_LANES = {1: (1, 3, 37, 255, 1000 + 37), 8: (1, 3, 17, 37),
                 32: (1, 3, 5, 13), 40: (1, 3, 5, 13), 64: (1, 3, 5, 13)}


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", ["chen", "hyperlorenz"])
def test_bf16x2_traj_kernel_bitwise_vs_plain_on_card(system, activation):
    """The scalar bf16 K2 on the bf16x2 step with staged 16-byte stores
    (``bf16x2_traj_kernel``): every lane count's trajectory bitwise the
    plain version's first lanes, one launch a call."""
    _need_card()
    w, x0, _ = _inputs(system, max(TRAJ_X2_LANES[1]), torch.bfloat16, 61)
    want = ref.chaotic_ann_ref(*w, x0, 24, activation)
    for n in TRAJ_X2_LANES[1]:
        n0 = chaotic_ann.chaotic_ann_traj.launches
        traj = chaotic_ann.chaotic_ann_traj(*w, x0[:n].contiguous(),
                                            n_steps=24, activation=activation)
        assert chaotic_ann.chaotic_ann_traj.launches == n0 + 1
        torch.cuda.synchronize()
        _assert_bitwise(traj, want[:, :n])


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", MXU_SYSTEMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_traj_x2_kernels_bitwise_vs_plain_on_card(system, dtype,
                                                      activation):
    """The mxu K2 on two lanes a thread with staged 16-byte stores
    (``mxu_x2_traj_kernel``, ``bf16x2_mxu_traj_kernel``) at every
    MXU_SHAPES entry: every lane count's trajectory bitwise the plain
    version's first lanes, one launch a call."""
    _need_card()
    rng = np.random.default_rng(62)
    p = params_from_numpy(default_params(system=system), device="cuda")
    w = [p[k] for k in ("w1", "b1", "w2", "b2")]
    kw = dict(compute_unit="mxu", lattice=None, coupling=None)
    if "lattice_meta" in p:
        from repro_torch.core.ann import lattice_meta_tuple
        kw.update(lattice=lattice_meta_tuple(p["lattice_meta"]),
                  coupling=p["coupling"])
    counts = TRAJ_X2_LANES[kw["lattice"][0] if kw["lattice"] else 1]
    x0 = torch.from_numpy(_x0_np(rng, (max(counts), w[0].shape[0]))).to(
        "cuda", dtype)
    want = ref.chaotic_ann_ref(*w, x0, 8, activation, **kw)
    for n in counts:
        n0 = chaotic_ann.chaotic_ann_mxu_traj.launches
        traj = chaotic_ann.chaotic_ann_traj(*w, x0[:n].contiguous(),
                                            n_steps=8, activation=activation,
                                            **kw)
        assert chaotic_ann.chaotic_ann_mxu_traj.launches == n0 + 1
        torch.cuda.synchronize()
        _assert_bitwise(traj, want[:, :n])


GANG_X2_S_BLOCKS = (128, 256, 384)        # off, on and off the 256-lane span
GANG_X2_LANES = (1, 5, 37, 257)           # K4 lanes a core


@pytest.mark.parametrize("activation", ("relu",) + ACTIVATIONS)
@pytest.mark.parametrize("gang", sorted(GANGS))
def test_bf16x2_gang_kernels_bitwise_vs_plain_on_card(gang, activation):
    """The scalar bf16 K3 and K4 on the bf16x2 row loop
    (``bf16x2_gang_bits_kernel``, ``bf16x2_gang_stacked_kernel``): K3 in
    six blocks with 0, partial and full rows at each s_block (an odd
    multiple of 128 leaves a block's last CTA one live half), K4 with a
    0-row and a partial core at each lane count (a ragged CTA), each
    launch's words (the rows asked for) and state bitwise the plain
    version's, one launch a call."""
    _need_card()
    w = _gang_weights(gang)
    n_cores, i_dim = w[0].shape[:2]
    rng = np.random.default_rng(63)
    n_steps = 16
    core_map = np.array([2, 0, 3, 1, 1, 2]) % n_cores
    rows = np.array([0, 3, 8, 1, 8, 5])
    for s_block in GANG_X2_S_BLOCKS:
        n_lanes = len(core_map) * s_block
        x0 = torch.from_numpy(_x0_np(rng, (n_lanes, i_dim))).to(
            "cuda", torch.bfloat16)
        off = torch.from_numpy(_off_np(rng, n_lanes)).cuda()
        n0 = chaotic_ann.chaotic_ann_gang_bits.launches
        words, state = chaotic_ann.chaotic_ann_gang_bits(
            *w, x0, core_map, off, rows, n_steps=n_steps, s_block=s_block,
            t_block=n_steps, unroll=1, activation=activation)
        assert chaotic_ann.chaotic_ann_gang_bits.launches == n0 + 1
        rw, rs = ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps,
                                               off, rows, activation)
        torch.cuda.synchronize()
        for g, r in enumerate(rows):
            lanes = slice(g * s_block, (g + 1) * s_block)
            _assert_bitwise(words[:r, lanes], rw[:r, lanes])
        _assert_bitwise(state, rs)
    srows = [0, 5, 8, 3][:n_cores]
    xs = torch.from_numpy(_x0_np(rng, (n_cores, max(GANG_X2_LANES), i_dim))
                          ).to("cuda", torch.bfloat16)
    offs = torch.from_numpy(_off_np(rng, (n_cores, max(GANG_X2_LANES))))
    offs = offs.cuda()
    rw, rs = ref.chaotic_ann_gang_stacked_ref(*w, xs, n_steps, offs, srows,
                                              activation)
    for n in GANG_X2_LANES:
        n0 = chaotic_ann.chaotic_ann_gang_stacked.launches
        words, state = chaotic_ann.chaotic_ann_gang_stacked(
            *w, xs[:, :n].contiguous(), offs[:, :n].contiguous(), srows,
            n_steps=n_steps, activation=activation)
        assert chaotic_ann.chaotic_ann_gang_stacked.launches == n0 + 1
        torch.cuda.synchronize()
        for c, r in enumerate(srows):
            _assert_bitwise(words[:r, c], rw[:r, c, :n].contiguous())
        _assert_bitwise(state, rs[:, :n].contiguous())


# ---------------------------------------------------------------------------
# The f32 vpu K1's tanh and sigmoid: quotients by div_fast, exp's 2^fx in
# f32 bits
# ---------------------------------------------------------------------------

# the library's check hook: its op count, and the index of exp_f32 against
# exp_f32_f64 on all 2**32 f32 inputs (kCheckAll, kCheckCvt + 3 in the
# source)
CHECK_OPS, CHECK_EXP = 12, 11


def test_f32_exp_check_hook_reports_no_mismatch():
    """The check hook's exhaustive checks, the new one among them: the
    kernels' exp (2^fx added to the exponent field) against the f64
    scaling on every f32 bit pattern, 0 mismatches in every op."""
    _need_card()
    fn = chaotic_ann._lib().chaotic_ann_bf16x2_check_launch
    mismatches = torch.zeros(CHECK_OPS, dtype=torch.int64, device="cuda")
    n_examples = torch.zeros(CHECK_OPS, dtype=torch.int32, device="cuda")
    examples = torch.zeros((CHECK_OPS, 4, 4), dtype=torch.int32,
                           device="cuda")
    rc = fn(0, mismatches.data_ptr(), n_examples.data_ptr(),
            examples.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert mismatches[CHECK_EXP].item() == 0
    assert mismatches.tolist() == [0] * CHECK_OPS


F32_K1_LANES = {"chen": (1, 3, 37, 129, 255, 1000 + 37),
                "hyperlorenz": (1, 3, 37, 129, 255),
                "chen@ring8": (1, 3, 17, 37, 103),
                "chen@grid8": (1, 3, 17, 37)}


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", sorted(F32_K1_LANES))
def test_f32_k1_tanh_sigmoid_bitwise_vs_plain_at_odd_lane_counts(system,
                                                                 activation):
    """The f32 K1, scalar (``bits_kernel``) and lattice
    (``lattice_bits_kernel``), with tanh and sigmoid: each lane count's
    words and final state bitwise the plain version's first lanes, one
    launch a call."""
    _need_card()
    lanes = F32_K1_LANES[system]
    if "@" in system:
        w, lattice, x0, off = _lattice_inputs(system, max(lanes),
                                              torch.float32, seed=67)
        counter = chaotic_ann.chaotic_ann_lattice_bits
    else:
        (w, x0, off), lattice = _inputs(system, max(lanes), torch.float32,
                                        67), None
        counter = chaotic_ann.chaotic_ann_bits
    kw = dict(lattice=lattice, activation=activation)
    rw, rs = ref.chaotic_ann_bits_ref(*w, x0, 24, off, **kw)
    for n in lanes:
        n0 = counter.launches
        words, state = chaotic_ann.chaotic_ann_bits(
            *w, x0[:n].contiguous(), off[:n].contiguous(), n_steps=24, **kw)
        assert counter.launches == n0 + 1
        torch.cuda.synchronize()
        _assert_bitwise(words, rw[:, :n].contiguous())
        _assert_bitwise(state, rs[:n])


# ---------------------------------------------------------------------------
# The f32 scalar K3/K4 on the f32 K1's row loop (f32_rows)
# ---------------------------------------------------------------------------

F32_GANG_S_BLOCKS = (128, 256, 384)
F32_GANG_LANES = (1, 5, 37, 257)           # K4 lanes a core: ragged CTAs
F32_GANG_WIDE = 16_384 + 37                # K4 lanes a core: the farm's F1


@pytest.mark.parametrize("activation", ("relu",) + ACTIVATIONS)
@pytest.mark.parametrize("gang", sorted(GANGS))
def test_f32_gang_kernels_bitwise_vs_plain_on_card(gang, activation):
    """The f32 K3 and K4 (``f32_gang_bits_kernel``,
    ``f32_gang_stacked_kernel``): K3 in six blocks with 0, partial and full
    rows at each s_block, K4 on four cores with a frozen and a partial
    core at ragged lane counts and at the farm's F1 width, each launch's
    words (the rows asked for) and state bitwise the plain version's, one
    launch a call."""
    _need_card()
    w = _gang_weights(gang)
    n_cores, i_dim = w[0].shape[:2]
    rng = np.random.default_rng(29)
    n_steps = 16
    core_map = np.array([2, 0, 3, 1, 1, 2]) % n_cores
    rows = np.array([0, 3, 8, 1, 8, 5])
    k3, k4 = chaotic_ann.chaotic_ann_gang_bits, chaotic_ann.chaotic_ann_gang_stacked
    for s_block in F32_GANG_S_BLOCKS:
        n_lanes = len(core_map) * s_block
        x0 = torch.from_numpy(_x0_np(rng, (n_lanes, i_dim))).cuda()
        off = torch.from_numpy(_off_np(rng, n_lanes)).cuda()
        n0 = k3.launches
        words, state = k3(*w, x0, core_map, off, rows, n_steps=n_steps,
                          s_block=s_block, t_block=n_steps, unroll=1,
                          activation=activation)
        assert k3.launches == n0 + 1
        rw, rs = ref.chaotic_ann_gang_bits_ref(*w, x0, core_map, n_steps,
                                               off, rows, activation)
        torch.cuda.synchronize()
        for g, r in enumerate(rows):
            lanes = slice(g * s_block, (g + 1) * s_block)
            _assert_bitwise(words[:r, lanes], rw[:r, lanes])
        _assert_bitwise(state, rs)
    w4 = [a[torch.arange(4, device="cuda") % n_cores] for a in w]
    srows = [0, 5, 8, 3]
    for n in F32_GANG_LANES + (F32_GANG_WIDE,):
        xs = torch.from_numpy(_x0_np(rng, (4, n, i_dim))).cuda()
        offs = torch.from_numpy(_off_np(rng, (4, n))).cuda()
        n0 = k4.launches
        words, state = k4(*w4, xs, offs, srows, n_steps=n_steps,
                          activation=activation)
        assert k4.launches == n0 + 1
        rw, rs = ref.chaotic_ann_gang_stacked_ref(*w4, xs, n_steps, offs,
                                                  srows, activation)
        torch.cuda.synchronize()
        for c, r in enumerate(srows):
            _assert_bitwise(words[:r, c], rw[:r, c])
        _assert_bitwise(state, rs)


# ---------------------------------------------------------------------------
# The word-quality gate and the serving tier on the card
# ---------------------------------------------------------------------------

SWEEP_SYSTEMS = ("chen", "chua", "hyperlorenz", "lorenz", "rossler")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("system", SWEEP_SYSTEMS)
def test_gate_words_kernel_vs_plain_on_card(system, dtype):
    """The offline gate's recipe (``ChaoticPRNG``, 256 lanes, seed 0) on
    the card: the K1 kernel's words bitwise the plain version's
    (``backend="ref"``) on a cut of rows, and ``nist_gate`` there reaches
    the verdict of the same gate over the plain words."""
    _need_card()
    from repro_torch.prng import quality
    from repro_torch.prng.stream import ChaoticPRNG
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    engs = [ChaoticPRNG(default_params(system=system), n_streams=256,
                        dtype=tdt, backend=b) for b in ("auto", "ref")]
    n0 = chaotic_ann.chaotic_ann_bits.launches
    kw, rw = [e.next_words(e.init(seed=0), 256 * 64)[0] for e in engs]
    assert chaotic_ann.chaotic_ann_bits.launches > n0
    np.testing.assert_array_equal(kw, rw)
    got = quality.nist_gate(system, dtype, n_words=8_192)
    plain = quality.nist_gate(system, dtype, n_words=8_192, backend="ref")
    assert got == plain


def test_retried_flush_under_the_frontend_on_card():
    """One flush of the committed farm's 3-8-3 cores under the async
    front-end on the card, offloaded to its executor thread, fails once by
    plan and is retried: every tenant's words are bitwise those of a farm
    with no fault plan, and the gang kernel launched."""
    _need_card()
    import asyncio
    from repro_torch.serve.async_frontend import AsyncOscillatorFarm
    from repro_torch.serve.clock import FakeClock
    from repro_torch.serve.farm import OscillatorFarm
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.health import HealthMonitor
    cores = ["chen", "chua", "lorenz", "rossler"]

    async def serve(faults):
        fc = FakeClock()
        farm = OscillatorFarm.from_generated(FARM, cores=cores, clock=fc,
                                             faults=faults)
        health = HealthMonitor(window_words=1 << 20, backoff_base_ms=1.0)
        async with AsyncOscillatorFarm(farm, clock=fc,
                                       health=health) as af:
            for c in cores:
                af.register(c, "t", seed=5)
            futs = [af.submit(c, "t", 128 * 40) for c in cores]
            for _ in range(10_000):
                await asyncio.sleep(0.001)
                fc.advance(0.01)
                if all(f.done() for f in futs):
                    break
            words = [f.result() for f in futs]
        return words, health.stats, farm.gang_launches

    k3, k4 = (chaotic_ann.chaotic_ann_gang_bits,
              chaotic_ann.chaotic_ann_gang_stacked)
    n0 = k3.launches + k4.launches
    plan = FaultPlan(seed=0, transient_rate=1.0, max_transients=1)
    got, stats, gang = asyncio.run(serve(plan))
    assert plan.injected["transient"] == 1
    assert stats["retries"] == 1 and stats["launch_failures"] == 1
    assert gang >= 1 and k3.launches + k4.launches > n0
    want, _, _ = asyncio.run(serve(None))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Shape libraries, built at first use
# ---------------------------------------------------------------------------

_PREPARE_IN_A_PROCESS = """
import sys
from repro_torch.kernels import build, ops
key = ("scalar", (5, 7))
got = ops.prepare([key])
print(got[key], build.library_path(key=key).stat().st_mtime_ns)
"""


def test_shape_library_built_once_and_reused_by_another_process():
    """A shape no one asked for (5-7) builds in the first process that
    prepares it and is reused, unbuilt, by the next; launches from it run
    bitwise the plain version."""
    _need_card()
    import subprocess
    import sys
    from repro_torch.kernels import build
    key = ("scalar", (5, 7))
    build.library_path(key=key).unlink(missing_ok=True)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(__import__("os").environ, PYTHONPATH=src)
    runs = [subprocess.run([sys.executable, "-c", _PREPARE_IN_A_PROCESS],
                           capture_output=True, text=True, env=env,
                           check=True).stdout.split() for _ in range(2)]
    assert float(runs[0][0]) > 0 and float(runs[1][0]) == 0.0
    assert runs[0][1] == runs[1][1]          # the same file, not rebuilt
    w = _seeded_net(5, 7, seed=6)
    x0 = torch.from_numpy(_x0_np(np.random.default_rng(6), (300, 5))).cuda()
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, 3, n_steps=8)
    want_w, want_s = ref.chaotic_ann_bits_ref(*w, x0, 8, 3)
    _assert_bitwise(words, want_w)
    _assert_bitwise(state, want_s)


def test_broken_shape_build_raises_and_never_falls_back(tmp_path,
                                                        monkeypatch):
    """A source that does not compile: the first launch at a new shape
    raises nvcc's log, and the plain version is never reached."""
    _need_card()
    from repro_torch.kernels import build
    src = (build.CSRC / build.SOURCE).read_text()
    (tmp_path / build.SOURCE).write_text(src + "\n#error deliberately broken\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(chaotic_ann, "_SHAPE_LIBS", {})

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(ref, "chaotic_ann_bits_ref", forbidden)
    w = _seeded_net(3, 6, seed=7)
    x0 = torch.zeros(64, 3, device="cuda")
    with pytest.raises(RuntimeError, match="deliberately broken"):
        chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=4)
    assert not build.library_path(key=("scalar", (3, 6))).exists()


def test_lm_logits_on_card_match_the_cpu():
    """llama3_2_3b's full width at 2 layers, f32 with TF32 off: one
    parameter set on the CPU and on the card, the logits of the same
    tokens within 1e-4 of their largest magnitude (``chip_smoke.py``
    phase 16 (b))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_config("llama3_2_3b"), n_layers=2,
                              dtype="float32")
    model = tf.init(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(2))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want, _ = tf.forward(cfg, model, toks)
            got, _ = tf.forward(cfg, model.to("cuda"), toks.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got = got.cpu()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
