"""The lattice forms of the gang kernels (K3 and K4 with K5's vpu
coupling) and a farm of lattice cores, in the port, against the JAX
package on the same numpy-seeded inputs (CPU).

The cores are the registry's chen, chua, lorenz and rossler expanded to
8-node rings and tori (I = 24, H = 64, derived from the committed base
weights).  Tiers, as in ``tests/test_torch_lattice.py``:

* bf16: the plain lattice K3 and K4 equal the Pallas kernels (interpret
  mode) bitwise, words and final state, and the bf16 port farm delivers
  the JAX farm's words bitwise;
* f32: the final state within ``F32_FREE_RUN`` of the Pallas kernels over
  a 16-step free run, and the words bitwise against the port's own solo
  lattice K1 plain version (XLA's CPU code differs in the low bits).

Inside the port: 24 members stacked equal 24 solo lattice launches (as
``tests/test_lattice.py`` checks for the JAX package), gang farms equal
``gang=False`` farms, snapshot/restore continues bitwise, and the gang
rules (scalar and lattice cores never gang; two descriptors never gang;
an mxu lattice gang is refused at flush).  The CUDA kernels are held to
the plain versions on the card in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dse import Candidate as JaxCandidate
from repro.core.dse import VMEM_USABLE, stacked_gang_vmem_bytes
from repro.kernels import chaotic_ann as jax_ann
from repro.serve.farm import GangScheduler as JaxScheduler
from repro.serve.farm import OscillatorFarm as JaxFarm
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.dse import Candidate, default_config
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params
from repro_torch.serve.farm import GangScheduler, OscillatorFarm, _compat_key
from repro_torch.serve.prng_service import PRNGService

from test_torch_kernels import F32_FREE_RUN, bf16_bits, jax_bf16_bits

KEYS = ("w1", "b1", "w2", "b2")
BASES = ("chen", "chua", "lorenz", "rossler")     # the 3-8 registry systems
# the Pallas schedule of the comparisons: small blocks keep interpret mode
# cheap (its compile time grows with t_block and unroll), and change no
# value (the row rounding of larger unrolls is held to JAX's in
# tests/test_torch_gang.py)
S_BLOCK, T_BLOCK, UNROLL = 128, 4, 1
K3_ROW_MAP = np.array([0, 3, 16, 9])     # 0, odd, the launch's rows, ragged
K4_ROW_MAP = np.array([16, 7, 0, 16])    # core 1 frozen early, core 2 at 0


def lattice_gang(topology, dtype=np.float32):
    """(stacked numpy weights (4, ...), descriptor) of the four bases as
    8-node lattices of one descriptor."""
    per_core = [default_params(system=f"{b}@{topology}8") for b in BASES]
    ws = [np.stack([np.asarray(p[k], dtype) for p in per_core]) for k in KEYS]
    return ws, lattice_meta_tuple(per_core[0]["lattice_meta"])


def _x0(rng, shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def _offsets(rng, shape):
    off = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    off.reshape(-1)[:3] = [0xFFFFFFFF, 0xFFFFFFF0, 0]   # wrap mid-run
    return off


def _words(t):
    return ops.from_uint32(t).numpy()


def _jax_k3(ws, lattice, x0, core_map, off, row_map, n_steps, dtype):
    return jax_ann.chaotic_ann_gang_bits_pallas(
        *[jnp.asarray(w) for w in ws], jnp.asarray(x0).astype(dtype),
        jnp.asarray(core_map), jnp.asarray(off), jnp.asarray(row_map),
        n_steps=n_steps, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice, interpret=True)


def _jax_k4(ws, lattice, x0, off, row_map, n_steps, dtype):
    return jax_ann.chaotic_ann_gang_stacked_pallas(
        *[jnp.asarray(w) for w in ws], jnp.asarray(x0).astype(dtype),
        jnp.asarray(off), jnp.asarray(row_map), n_steps=n_steps,
        s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL, lattice=lattice,
        interpret=True)


# ---------------------------------------------------------------------------
# Plain lattice K3 / K4 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topology", ["ring", "grid"])
def test_lattice_gang_bits_bf16_bitwise_vs_pallas(topology):
    """Plain lattice K3 == Pallas lattice K3 in bf16: the words each block
    asked for (ragged rows, offsets that wrap) and the final states."""
    ws, lattice = lattice_gang(topology)
    rng = np.random.default_rng(41)
    core_map = np.array([2, 0, 3, 1], np.int32)
    n_steps, s_total = 32, 4 * S_BLOCK
    x0, off = _x0(rng, (s_total, 24)), _offsets(rng, s_total)
    jw, js = _jax_k3(ws, lattice, x0, core_map, off, K3_ROW_MAP, n_steps,
                     jnp.bfloat16)
    tw, ts = chaotic_ann.chaotic_ann_gang_bits(
        *[torch.from_numpy(w) for w in ws],
        torch.from_numpy(x0).to(torch.bfloat16), core_map,
        torch.from_numpy(off), K3_ROW_MAP, n_steps=n_steps, s_block=S_BLOCK,
        t_block=T_BLOCK, unroll=UNROLL, lattice=lattice)
    rows = jax_ann.gang_effective_rows(K3_ROW_MAP, n_steps, T_BLOCK,
                                       UNROLL)
    np.testing.assert_array_equal(rows, [0, 3, 16, 9])
    jw, tw = np.asarray(jw), _words(tw)
    for g, r in enumerate(rows):
        lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
        np.testing.assert_array_equal(tw[:r, lanes], jw[:r, lanes])
    np.testing.assert_array_equal(bf16_bits(ts), jax_bf16_bits(js))


@pytest.mark.parametrize("topology", ["ring", "grid"])
def test_lattice_gang_stacked_bf16_bitwise_vs_pallas(topology):
    """Plain lattice K4 == Pallas lattice K4 in bf16, one core frozen
    early and one at 0 rows, lanes not a multiple of the block."""
    ws, lattice = lattice_gang(topology)
    rng = np.random.default_rng(42)
    n_steps, n_lanes = 32, 100
    x0, off = _x0(rng, (4, n_lanes, 24)), _offsets(rng, (4, n_lanes))
    jw, js = _jax_k4(ws, lattice, x0, off, K4_ROW_MAP, n_steps, jnp.bfloat16)
    tw, ts = chaotic_ann.chaotic_ann_gang_stacked(
        *[torch.from_numpy(w) for w in ws],
        torch.from_numpy(x0).to(torch.bfloat16), torch.from_numpy(off),
        K4_ROW_MAP, n_steps=n_steps, lattice=lattice)
    jw, tw = np.asarray(jw), _words(tw)
    for c, r in enumerate(K4_ROW_MAP):
        np.testing.assert_array_equal(tw[:r, c], jw[:r, c])
    np.testing.assert_array_equal(bf16_bits(ts), jax_bf16_bits(js))


def test_lattice_gangs_f32_within_tolerance_and_bitwise_vs_solo_k1():
    """f32, 16 steps, ring8: states within the free-run tolerance of the
    Pallas kernels; words bitwise the port's solo plain lattice K1, per
    lane block (K3) and per core (K4)."""
    ws, lattice = lattice_gang("ring")
    w = [torch.from_numpy(a) for a in ws]
    rng = np.random.default_rng(43)
    n_steps, core_map = 16, np.array([1, 3, 0, 2], np.int32)
    row_map = np.array([8, 0, 3, 5])
    rows = chaotic_ann.gang_effective_rows(row_map, n_steps, T_BLOCK,
                                           UNROLL)
    x0, off = _x0(rng, (4 * S_BLOCK, 24)), _offsets(rng, 4 * S_BLOCK)
    _, js = _jax_k3(ws, lattice, x0, core_map, off, row_map, n_steps,
                    jnp.float32)
    tw, ts = chaotic_ann.chaotic_ann_gang_bits(
        *w, torch.from_numpy(x0), core_map, torch.from_numpy(off), row_map,
        n_steps=n_steps, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice)
    js = np.asarray(js)
    assert np.abs(ts.numpy() - js).max() <= F32_FREE_RUN(np.abs(js).max())
    for g, (c, r) in enumerate(zip(core_map, rows)):
        lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
        if r == 0:
            assert torch.equal(ts[lanes], torch.from_numpy(x0[lanes]))
            continue
        kw, ks = ref.chaotic_ann_bits_ref(
            *[t[c] for t in w], torch.from_numpy(x0[lanes]), 2 * r,
            torch.from_numpy(off[lanes]), lattice=lattice)
        np.testing.assert_array_equal(_words(tw)[:r, lanes], _words(kw))
        assert not _words(tw)[r:, lanes].any()     # zero past the rows
        assert torch.equal(ts[lanes], ks)
    xs, offs = _x0(rng, (4, 77, 24)), _offsets(rng, (4, 77))
    srows = [8, 3, 0, 8]
    _, js = _jax_k4(ws, lattice, xs, offs, np.asarray(srows), n_steps,
                    jnp.float32)
    tw, ts = chaotic_ann.chaotic_ann_gang_stacked(
        *w, torch.from_numpy(xs), torch.from_numpy(offs), srows,
        n_steps=n_steps, lattice=lattice)
    js = np.asarray(js)
    assert np.abs(ts.numpy() - js).max() <= F32_FREE_RUN(np.abs(js).max())
    for c, r in enumerate(srows):
        if r == 0:
            assert torch.equal(ts[c], torch.from_numpy(xs[c]))
            continue
        kw, ks = ref.chaotic_ann_bits_ref(
            *[t[c] for t in w], torch.from_numpy(xs[c]), 2 * r,
            torch.from_numpy(offs[c]), lattice=lattice)
        np.testing.assert_array_equal(_words(tw)[:r, c], _words(kw))
        assert torch.equal(ts[c], ks)


# ---------------------------------------------------------------------------
# Inside the port: 24 stacked members == 24 solo lattice launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lattice_stacked_gang_24_members_equal_solo(dtype):
    """One stacked launch of 24 distinct lattice cores (each base's weights
    with its own bias shift) == 24 solo lattice K1 launches, words and
    final states, with per-lane offsets and three cores frozen early; the
    same 24 cores as a lane-concat gang likewise."""
    ws, lattice = lattice_gang("ring")
    rng = np.random.default_rng(44)
    n_cores, n_lanes, n_steps = 24, 32, 16
    w = [torch.from_numpy(np.concatenate([a] * 6)) for a in ws]
    w[1] = w[1] + torch.from_numpy(
        rng.uniform(-0.05, 0.05, (n_cores, 1)).astype(np.float32))
    xs = torch.from_numpy(_x0(rng, (n_cores, n_lanes, 24))).to(dtype)
    offs = torch.from_numpy(_offsets(rng, (n_cores, n_lanes)))
    srows = np.full(n_cores, n_steps // 2)
    srows[[3, 10, 17]] = [0, 5, 2]
    gw, gs = chaotic_ann.chaotic_ann_gang_stacked(
        *w, xs, offs, srows, n_steps=n_steps, lattice=lattice)
    cw, cs = chaotic_ann.chaotic_ann_gang_bits(
        *w, xs.reshape(-1, 24), np.arange(n_cores), offs.reshape(-1),
        n_steps=n_steps, s_block=n_lanes, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice)
    cw = _words(cw).reshape(n_steps // 2, n_cores, n_lanes)
    cs = cs.reshape(n_cores, n_lanes, 24)
    for c in range(n_cores):
        kw, ks = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], xs[c], offs[c], n_steps=n_steps,
            lattice=lattice)
        np.testing.assert_array_equal(cw[:, c], _words(kw))
        assert torch.equal(cs[c], ks)
        r = int(srows[c])
        if r == 0:
            assert torch.equal(gs[c], xs[c])
            continue
        kw, ks = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], xs[c], offs[c], n_steps=2 * r,
            lattice=lattice)
        np.testing.assert_array_equal(_words(gw)[:r, c], _words(kw))
        assert torch.equal(gs[c], ks)


# ---------------------------------------------------------------------------
# The farm: lattice cores next to a scalar core
# ---------------------------------------------------------------------------

def lattice_config(topology, dtype_bytes, unit="vpu"):
    """An explicit config of an 8-node lattice, in each package's record."""
    kw = dict(i_dim=24, h_dim=64, p=0, compute_unit=unit,
              dtype_bytes=dtype_bytes, t_block=T_BLOCK, unroll=UNROLL,
              n_nodes=8)
    return JaxCandidate(**kw), Candidate(**kw)


def build_farm(farm_cls, gang, dtype, *, jax_side=False, cores=None,
               **farm_kw):
    """lat_a (chen@ring8) and lat_b (lorenz@ring8) beside the scalar chen,
    as ``tests/test_lattice.py`` sets a lattice farm up; ``cores`` maps
    more names to lattice systems."""
    nb = 2 if "bfloat16" in str(dtype) else 4
    pick = 0 if jax_side else 1
    kw = dict(backend="pallas_interpret") if jax_side else {}
    farm = farm_cls(gang=gang, **farm_kw)
    systems = cores or {"lat_a": "chen@ring8", "lat_b": "lorenz@ring8"}
    for name, system in systems.items():
        topo = system.split("@")[1][:4]
        farm.add_core(name, default_params(system=system),
                      config=lattice_config(topo, nb)[pick], dtype=dtype,
                      lanes_per_client=128, **kw)
    scal = (JaxCandidate if jax_side else Candidate)(
        i_dim=3, h_dim=8, p=0, compute_unit="vpu", dtype_bytes=nb,
        t_block=32, unroll=2)
    farm.add_core("chen", default_params(system="chen"), config=scal,
                  dtype=dtype, lanes_per_client=128, **kw)
    for i, core in enumerate(farm.cores):
        farm.register(core, "t", seed=5 + i)
        farm.register(core, "u", seed=50 + i)
    return farm


def _serve(farm, words):
    """Request ``words[client]`` from every client each core has."""
    for core in farm.cores:
        for client in farm.services[core].clients:
            farm.request(core, client, words[client])
    return farm.flush()


def _assert_same(a, b):
    assert set(a) == set(b)
    for core in a:
        assert set(a[core]) == set(b[core])
        for client in a[core]:
            np.testing.assert_array_equal(np.asarray(a[core][client]),
                                          np.asarray(b[core][client]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lattice_farm_gangs_by_descriptor_and_equals_solo_farm(dtype):
    """Equal-descriptor lattice cores share a key, the scalar core has
    another; uniform demand takes one stacked lattice launch, skewed
    demand a ragged or split plan; words bitwise a gang=False farm's, and a
    snapshot with pending requests restored onto a fresh farm continues
    bitwise."""
    ganged = build_farm(OscillatorFarm, True, dtype, device="cpu")
    solo = build_farm(OscillatorFarm, False, dtype, device="cpu")
    keys = {c: _compat_key(ganged.services[c]) for c in ganged.cores}
    assert keys["lat_a"] == keys["lat_b"] != keys["chen"]
    _assert_same(_serve(ganged, {"t": 1024, "u": 1024}),
                 _serve(solo, {"t": 1024, "u": 1024}))
    assert ganged.gang_launches == 1
    assert {p["mode"] for p in ganged._sched._plans.values()} == {"stacked"}
    plan = next(iter(ganged._sched._plans.values()))
    assert "lattice_meta" in plan["params"] and "coupling" in plan["params"]
    assert plan["params"]["coupling"].ndim == 2          # un-stacked
    for f in (ganged, solo):
        f.request("lat_a", "t", 4096)
        f.request("lat_b", "u", 256)
        f.request("chen", "t", 300)
    snap = ganged.snapshot()
    out = ganged.flush()
    _assert_same(out, solo.flush())
    assert ganged.plan_decisions["padded"] == 1     # the uniform flush
    assert ganged.plan_decisions["ragged"] + ganged.plan_decisions["split"] == 1
    fresh = build_farm(OscillatorFarm, True, dtype, device="cpu")
    fresh.restore(snap)
    _assert_same(fresh.flush(), out)


def test_bf16_lattice_farm_bitwise_vs_jax_farm():
    """A uniform flush (the stacked layout), then unequal pools (one more
    client on lat_b: the lane-concat layout): every delivered word equal
    to the JAX farm's, bit for bit."""
    jfarm = build_farm(JaxFarm, True, jnp.bfloat16, jax_side=True)
    tfarm = build_farm(OscillatorFarm, True, torch.bfloat16, device="cpu")
    _assert_same(_serve(tfarm, {"t": 512, "u": 512}),
                 _serve(jfarm, {"t": 512, "u": 512}))
    for f in (jfarm, tfarm):
        f.register("lat_b", "v", seed=99)
    _assert_same(_serve(tfarm, {"t": 256, "u": 256, "v": 256}),
                 _serve(jfarm, {"t": 256, "u": 256, "v": 256}))
    assert ({p["mode"] for p in tfarm._sched._plans.values()}
            == {"stacked", "concat"})
    assert tfarm.gang_launches == 2


def test_ring_and_grid_lattice_cores_never_gang():
    """A ring8 and a grid8 core (same shape, other descriptor) launch
    alone, and deliver a standalone service's words."""
    farm = build_farm(OscillatorFarm, True, torch.bfloat16, device="cpu",
                      cores={"ring": "chen@ring8", "grid": "chen@grid8"})
    assert _compat_key(farm.services["ring"]) != _compat_key(
        farm.services["grid"])
    out = _serve(farm, {"t": 512, "u": 512})
    assert farm.gang_launches == 0
    alone = PRNGService(default_params(system="chen@grid8"),
                        config=lattice_config("grid", 2)[1],
                        dtype=torch.bfloat16, device="cpu")
    alone.register("t", seed=5 + farm.cores.index("grid"))
    np.testing.assert_array_equal(out["grid"]["t"], alone.draw("t", 512))


def test_mxu_lattice_cores_alone_served_and_as_a_gang_refused():
    """On the mxu unit a lone lattice core is served by its own service's
    solo launch; two lattice cores of one key, once refused at flush, now
    gang through K3's mxu form (one lane-concat launch), each delivering
    the words of a standalone service."""
    mxu = lattice_config("ring", 2, "mxu")[1]

    def farm_of(names):
        farm = OscillatorFarm(device="cpu")
        for name in names:
            farm.add_core(name, default_params(system="chen@ring8"),
                          config=mxu, dtype=torch.bfloat16,
                          lanes_per_client=8, burn_in=2)
            farm.register(name, "t", seed=3)
        return farm

    one = farm_of(["a"])
    alone = PRNGService(default_params(system="chen@ring8"),
                        lanes_per_client=8, burn_in=2, config=mxu,
                        dtype=torch.bfloat16, device="cpu")
    alone.register("t", seed=3)
    want = alone.draw("t", 32)
    np.testing.assert_array_equal(one.draw("a", "t", 32), want)
    two = farm_of(["a", "b"])
    for core in two.cores:
        two.request(core, "t", 32)
    out = two.flush()
    assert two.gang_launches == 1
    assert {p["mode"] for p in two._sched._plans.values()} == {"concat"}
    for core in two.cores:
        np.testing.assert_array_equal(out[core]["t"], want)


def test_stacked_layout_has_no_vmem_cliff_unlike_the_jax_planner():
    """From 69 f32 chen@ring32 members the JAX planner leaves the stacked
    layout (its VMEM budget); the port's stays stacked (no such cliff on
    Hopper): plans differ, words cannot."""
    cfg = default_config(96, 256, torch.float32, n_nodes=32)
    jcfg = JaxCandidate(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg) if f.init})
    assert stacked_gang_vmem_bytes(jcfg, 68) <= VMEM_USABLE
    assert stacked_gang_vmem_bytes(jcfg, 69) > VMEM_USABLE

    class _Svc:
        mesh, mesh_axis = None, "data"

        def __init__(self, c):
            self.config = c
            self.pool_x = np.zeros((c.s_block, c.i_dim), np.float32)

    for n, jax_layout in ((68, "stacked"), (69, "concat")):
        for sched, c, want in ((JaxScheduler(), jcfg, jax_layout),
                               (GangScheduler(), cfg, "stacked")):
            members = [(f"c{i}", _Svc(c), 8, None) for i in range(n)]
            dec = sched._decide(("k",), members, demands=(16,) * n)
            assert dec["parts"][0]["layout"] == want
