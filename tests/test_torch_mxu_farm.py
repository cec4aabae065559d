"""K3's mxu form (the lane-concat gang on the dot step, with K5's coupling
dot for a lattice group) and a farm of mxu cores, in the port, against the
JAX package on the same numpy-seeded inputs (CPU).

The mxu dot is a forward chain of f32 fused multiply-adds on both sides
(``tests/test_torch_mxu.py``), so the tier is bitwise in f32 and bf16:

* the plain mxu K3 equals ``chaotic_ann_gang_bits_pallas(compute_unit=
  "mxu")`` in interpret mode, words each lane block asked for and final
  states, for chen@ring8 / chen@grid8 lattices of three distinct bases
  (one shared coupling operand) and a 3-8-3 scalar gang of four, padded
  and ragged, with offsets that wrap past 2^32;
* a farm of chen/chua/lorenz/rossler@ring32 added with no config (both
  packages resolve the mxu unit: the JAX farm's default lattice gang)
  delivers the JAX farm's words, with the same plan layouts and gang
  launch counts.

Inside the port: the plain mxu K3 equals solo plain mxu K1 per core, the
mxu farm equals a ``gang=False`` farm, snapshot/restore with requests
pending continues bitwise, and the stacked gang refuses the mxu unit as
the JAX package does.  The CUDA kernel is held to the plain version on the
card in ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro.serve.farm import OscillatorFarm as JaxFarm
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.dse import Candidate, select_config
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params
from repro_torch.serve.farm import OscillatorFarm, _compat_key

from test_torch_lattice_farm import _assert_same, _offsets, _words, _x0
from test_torch_mxu import state_bits

KEYS = ("w1", "b1", "w2", "b2")
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
# the Pallas schedule of the kernel comparisons: small blocks keep the
# interpret compile short and change no value
S_BLOCK, T_BLOCK, UNROLL = 128, 4, 1
N_STEPS = 32
ROW_MAP = np.array([0, 3, 16, 9])        # 0, odd, the launch's rows, ragged
LATTICE_BASES = ("chen", "lorenz", "rossler")
SCALAR_BASES = ("chen", "chua", "lorenz", "rossler")
RING32 = tuple(f"{b}@ring32" for b in SCALAR_BASES)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain f32 FMA chains are thousands of small
    tensor ops, which more threads only slow down when several test
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gang(systems):
    """Stacked numpy weights (C, ...) of ``systems``, their lattice
    descriptor (None for scalar cores) and the one coupling operand."""
    per_core = [default_params(system=s) for s in systems]
    ws = [np.stack([np.asarray(p[k], np.float32) for p in per_core])
          for k in KEYS]
    p0 = per_core[0]
    if "lattice_meta" not in p0:
        return ws, None, None
    return ws, lattice_meta_tuple(p0["lattice_meta"]), p0["coupling"]


@pytest.mark.parametrize("system,kind", [("chen@ring8", "lattice"),
                                         ("chen@grid8", "lattice"),
                                         ("chen", "scalar")],
                         ids=["ring8", "grid8", "scalar"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_plain_mxu_k3_bitwise_vs_pallas(system, kind, dtypes):
    """Plain mxu K3 == Pallas mxu K3 (interpret), bitwise: a ragged launch
    (the words each block asked for) and a padded one, final states too.
    Lattices: three distinct bases sharing ONE coupling operand; scalar:
    the four 3-8-3 registry nets."""
    tdt, jdt = dtypes
    if kind == "lattice":
        topo = system.split("@")[1]
        systems = tuple(f"{b}@{topo}" for b in LATTICE_BASES)
        core_map = np.array([2, 0, 1, 0], np.int32)
    else:
        systems = SCALAR_BASES
        core_map = np.array([3, 1, 0, 2], np.int32)
    ws, lattice, cpl = _gang(systems)
    i_dim = ws[0].shape[1]
    rng = np.random.default_rng(61)
    s_total = len(core_map) * S_BLOCK
    x0, off = _x0(rng, (s_total, i_dim)), _offsets(rng, s_total)
    tw = [torch.from_numpy(w) for w in ws]
    tcpl = None if cpl is None else torch.from_numpy(cpl)
    for row_map in (ROW_MAP, None):
        jw, js = jax_ann.chaotic_ann_gang_bits_pallas(
            *[jnp.asarray(w) for w in ws], jnp.asarray(x0).astype(jdt),
            jnp.asarray(core_map), jnp.asarray(off),
            None if row_map is None else jnp.asarray(row_map),
            None if cpl is None else jnp.asarray(cpl), n_steps=N_STEPS,
            s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
            compute_unit="mxu", lattice=lattice, interpret=True)
        got_w, got_s = chaotic_ann.chaotic_ann_gang_bits(
            *tw, torch.from_numpy(x0).to(tdt), core_map,
            torch.from_numpy(off), row_map, n_steps=N_STEPS, s_block=S_BLOCK,
            t_block=T_BLOCK, unroll=UNROLL, compute_unit="mxu",
            lattice=lattice, coupling=tcpl)
        rows = (jax_ann.gang_effective_rows(row_map, N_STEPS, T_BLOCK, UNROLL)
                if row_map is not None else [N_STEPS // 2] * len(core_map))
        jw, got_w = np.asarray(jw), _words(got_w)
        for g, r in enumerate(rows):
            lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
            np.testing.assert_array_equal(got_w[:r, lanes], jw[:r, lanes])
        np.testing.assert_array_equal(state_bits(got_s),
                                      state_bits(js.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_mxu_k3_equals_solo_mxu_k1(dtype):
    """Per lane block, the plain mxu K3 equals the solo plain mxu K1 of its
    core over its own rows (words and state), zero past them; a block at
    0 rows keeps its state.  A chen@ring8 lattice gang of three bases and
    the 3-8-3 gang of four."""
    rng = np.random.default_rng(62)
    s_block, n_steps = 16, 16
    row_map = np.array([8, 0, 3, 5, 8])
    for systems in (tuple(f"{b}@ring8" for b in LATTICE_BASES),
                    SCALAR_BASES):
        ws, lattice, cpl = _gang(systems)
        w = [torch.from_numpy(a) for a in ws]
        kw = dict(lattice=lattice, compute_unit="mxu",
                  coupling=None if cpl is None else torch.from_numpy(cpl))
        core_map = np.arange(len(row_map)) % len(systems)
        i_dim = ws[0].shape[1]
        x0 = torch.from_numpy(_x0(rng, (len(row_map) * s_block, i_dim)))
        x0 = x0.to(dtype)
        off = torch.from_numpy(_offsets(rng, len(row_map) * s_block))
        gw, gs = chaotic_ann.chaotic_ann_gang_bits(
            *w, x0, core_map, off, row_map, n_steps=n_steps, s_block=s_block,
            t_block=T_BLOCK, unroll=UNROLL, **kw)
        rows = chaotic_ann.gang_effective_rows(row_map, n_steps, T_BLOCK,
                                               UNROLL)
        gw = _words(gw)
        for g, (c, r) in enumerate(zip(core_map, rows)):
            lanes = slice(g * s_block, (g + 1) * s_block)
            if r == 0:
                assert torch.equal(gs[lanes], x0[lanes])
                continue
            kw_words, ks = ref.chaotic_ann_bits_ref(
                *[t[c] for t in w], x0[lanes], 2 * int(r), off[lanes], **kw)
            np.testing.assert_array_equal(gw[:r, lanes], _words(kw_words))
            assert not gw[r:, lanes].any()        # zero past the rows
            assert torch.equal(gs[lanes], ks)


def test_stacked_gang_refuses_the_mxu_unit_as_jax_does():
    """K4 has no mxu form: the stacked gang raises JAX's ValueError on
    every backend, and an mxu group takes the lane-concat gang."""
    ws, lattice, cpl = _gang(tuple(f"{b}@ring8" for b in LATTICE_BASES))
    params = {k: torch.from_numpy(w) for k, w in zip(KEYS, ws)}
    params["lattice_meta"] = torch.from_numpy(
        default_params(system="chen@ring8")["lattice_meta"])
    params["coupling"] = torch.from_numpy(cpl)
    xs = torch.zeros(3, 16, 24)
    with pytest.raises(ValueError, match="compute_unit='vpu' only") as err:
        jax_ann.chaotic_ann_gang_stacked_pallas(
            *[jnp.asarray(w) for w in ws], jnp.zeros((3, 16, 24)),
            n_steps=4, compute_unit="mxu", lattice=lattice, interpret=True)
    for backend in ("auto", "ref"):
        with pytest.raises(ValueError, match="compute_unit='vpu' only"):
            ops.chaotic_bits_gang_stacked(params, xs, 4, backend=backend,
                                          compute_unit="mxu")
    assert "mxu" in str(err.value)
    words, state = ops.chaotic_bits_gang(
        params, xs.reshape(48, 24), 4, core_map=[0, 1, 2], s_block=16,
        compute_unit="mxu")
    want_w, want_s = ops.chaotic_bits_gang(
        params, xs.reshape(48, 24), 4, core_map=[0, 1, 2], s_block=16,
        compute_unit="mxu", backend="ref")
    np.testing.assert_array_equal(_words(words), _words(want_w))
    assert torch.equal(state, want_s)


# ---------------------------------------------------------------------------
# The farm of no-config ring32 cores against the JAX farm
# ---------------------------------------------------------------------------

def _ring32_farm(farm_cls, dtype, *, jax_side=False, gang=True, **farm_kw):
    """chen/chua/lorenz/rossler@ring32 added with no config (32 lanes a
    client, burn-in 2), one client each."""
    kw = dict(backend="pallas_interpret") if jax_side else {}
    farm = farm_cls(gang=gang, **farm_kw)
    for system in RING32:
        farm.add_core(system, default_params(system=system), dtype=dtype,
                      burn_in=2, **kw)
    for i, core in enumerate(farm.cores):
        farm.register(core, "t", seed=70 + i)
    return farm


def _serve(farm, words):
    """Request ``words[core]`` from every client of every core."""
    for core in farm.cores:
        for client in farm.services[core].clients:
            farm.request(core, client, words[core])
    return farm.flush()


# small draws: 512 words a client are 4 word rows of 128 lanes
UNIFORM = {c: 512 for c in RING32}
SKEWED = {c: 1024 if c == "chen@ring32" else 512 for c in RING32}


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_no_config_ring32_farm_bitwise_vs_jax_farm(dtypes):
    """Both farms resolve the mxu unit for every core (s_block 128,
    t_block 256, unroll 8); a uniform flush, one with unequal pools (one
    more lorenz@ring32 client) and a skewed one deliver the JAX farm's
    words bit for bit, every plan lane-concat, and the same gang
    launches."""
    tdt, jdt = dtypes
    jfarm = _ring32_farm(JaxFarm, jdt, jax_side=True)
    tfarm = _ring32_farm(OscillatorFarm, tdt, device="cpu")
    for core in RING32:
        tc, jc = tfarm.services[core].config, jfarm.services[core].config
        assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
        assert (tc.compute_unit, tc.s_block, tc.t_block, tc.unroll) == (
            "mxu", 128, 256, 8)
    assert len({_compat_key(s) for s in tfarm.services.values()}) == 1
    _assert_same(_serve(tfarm, UNIFORM), _serve(jfarm, UNIFORM))
    for f in (tfarm, jfarm):
        f.register("lorenz@ring32", "u", seed=99)
    _assert_same(_serve(tfarm, UNIFORM), _serve(jfarm, UNIFORM))
    _assert_same(_serve(tfarm, SKEWED), _serve(jfarm, SKEWED))
    for f in (tfarm, jfarm):
        assert {p["mode"] for p in f._sched._plans.values()} == {"concat"}
    assert tfarm.gang_launches == jfarm.gang_launches >= 2
    np.testing.assert_array_equal(
        state_bits(tfarm.services["chen@ring32"].pool_x),
        state_bits(jfarm.services["chen@ring32"].pool_x.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Inside the port: the mxu farm against gang=False, snapshot/restore
# ---------------------------------------------------------------------------

def _mxu_farm(dtype, gang=True):
    """Two chen@ring8-descriptor lattice cores and two 3-8-3 cores, all on
    explicit mxu configs (32 lanes a client), two clients each."""
    nb = torch.finfo(dtype).bits // 8
    lat = Candidate(i_dim=24, h_dim=64, p=0, compute_unit="mxu",
                    dtype_bytes=nb, t_block=8, unroll=2, n_nodes=8)
    scal = dataclasses.replace(
        select_config(3, 8, s_total=128, dtype=dtype, unit="mxu"),
        t_block=8, unroll=2)
    farm = OscillatorFarm(gang=gang, device="cpu")
    for name, system, cfg in (("lat_a", "chen@ring8", lat),
                              ("lat_b", "rossler@ring8", lat),
                              ("sc_a", "chen", scal), ("sc_b", "lorenz", scal)):
        farm.add_core(name, default_params(system=system), config=cfg,
                      dtype=dtype, lanes_per_client=32, burn_in=2)
    for i, core in enumerate(farm.cores):
        farm.register(core, "t", seed=80 + i)
        farm.register(core, "u", seed=90 + i)
    return farm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_farm_equals_gang_false_farm_and_restores(dtype):
    """Lattice and 3-8-3 cores on the mxu unit: each key gangs (two keys,
    lane-concat only), uniform / unequal-pool / skewed flushes deliver a
    gang=False farm's words, and a snapshot with requests pending,
    restored onto a fresh farm, continues bitwise."""
    ganged, solo = _mxu_farm(dtype), _mxu_farm(dtype, gang=False)
    keys = {c: _compat_key(ganged.services[c]) for c in ganged.cores}
    assert keys["lat_a"] == keys["lat_b"] != keys["sc_a"] == keys["sc_b"]
    assert ganged.services["sc_a"].config.compute_unit == "mxu"
    uniform = {c: 256 for c in ganged.cores}
    _assert_same(_serve(ganged, uniform), _serve(solo, uniform))
    assert ganged.gang_launches == 2
    for f in (ganged, solo):
        f.register("lat_b", "v", seed=7)
    _assert_same(_serve(ganged, uniform), _serve(solo, uniform))
    skewed = {c: 1024 if c in ("lat_a", "sc_a") else 64 for c in ganged.cores}
    for f in (ganged, solo):
        for core in f.cores:
            for client in f.services[core].clients:
                f.request(core, client, skewed[core])
    snap = ganged.snapshot()
    out = ganged.flush()
    _assert_same(out, solo.flush())
    assert {p["mode"] for p in ganged._sched._plans.values()} == {"concat"}
    assert ganged.plan_decisions["ragged"] + ganged.plan_decisions[
        "split"] == 2
    fresh = _mxu_farm(dtype)
    fresh.register("lat_b", "v", seed=7)
    fresh.restore(snap)
    _assert_same(fresh.flush(), out)
