"""tanh and sigmoid in the port's vpu lattice kernels (K5's coupling inside
K1 ``chaotic_ann_lattice_bits``, K2 ``chaotic_ann_lattice_traj``, K3
``chaotic_ann_lattice_gang_bits`` and K4 ``chaotic_ann_lattice_gang_stacked``),
the streams and farms that run them, and ``lattice()`` as an ODE system,
on the CPU, against the JAX package on the same numpy-seeded inputs.

* The plain lattice K1-K4 with tanh and sigmoid against the Pallas kernels
  in interpret mode at chen@ring8 and chen@grid8 (the four 3-8 registry
  nets as lattices of one descriptor for K3/K4, padded and ragged): in
  bf16 bitwise, words and state; in f32 within ``F32_ONE_STEP`` after one
  step from the JAX state and within ``F32_FREE_RUN`` after 8 steps
  (``tests/test_torch_kernels.py``).
* The port's lattice K3/K4 wrappers (on the CPU, their plain versions)
  against solo lattice K1 per core, bitwise in both dtypes: the JAX
  lattice K3/K4 equal per-core lattice K1 bitwise for relu, tanh and
  sigmoid (ROADMAP.md queue 2 item 3), so the port's must too.
* A no-config f32 tanh ring8 ``ChaoticStream`` resolves the JAX
  ``select_config`` (vpu) and stays within the f32 tier of the JAX stream;
  a bf16 stream on an explicit vpu config is bitwise the JAX one.
* A farm of JAX-generated ring8 relu, tanh and sigmoid cores: the port's
  farm delivers the JAX farm's words bitwise in bf16, one gang group per
  activation.
* ``lattice()``, ``get_system`` of a lattice name, ``integrate`` and
  ``make_dataset`` against the JAX ones.

The CUDA kernels are held to these plain versions on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chaotic as jax_chaotic
from repro.core import codegen as jax_codegen
from repro.core import dse as jax_dse
from repro.kernels import chaotic_ann as jax_ann
from repro.prng.stream import ChaoticPRNG as JaxPRNG
from repro.prng.stream import ChaoticStream as JaxStream
from repro.serve.farm import OscillatorFarm as JaxFarm
from repro_torch.core import chaotic
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.dse import Candidate
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import ChaoticPRNG, ChaoticStream, default_params
from repro_torch.serve.farm import OscillatorFarm, _compat_key

from test_torch_kernels import (F32_FREE_RUN, F32_ONE_STEP, bf16_bits,
                                jax_bf16_bits)

KEYS = ("w1", "b1", "w2", "b2")
BASES = ("chen", "chua", "lorenz", "rossler")     # the 3-8 registry nets
ACTIVATIONS = ("tanh", "sigmoid")
SYSTEMS = ("chen@ring8", "chen@grid8")
# the Pallas schedule of the comparisons: small blocks keep the interpret
# compiles short (their time grows with t_block and unroll) and change no
# value
S_BLOCK, T_BLOCK, UNROLL, STEPS = 128, 4, 1, 16
# K3: four lane blocks, one per net; demands of 0, odd, the launch's rows.
# K4: a core frozen early and one at 0 rows.  Padded is every row: the
# port takes None, the JAX kernel the full row_map (one interpret compile
# serves both shapes)
K3_ROW_MAPS = {"padded": None, "ragged": np.array([0, 3, 8, 5])}
K4_ROW_MAPS = {"padded": None, "ragged": np.array([8, 3, 0, 8])}
# f32 free runs: the registry's relu-trained chen weights under tanh make
# a map that doubles a low-bit gap about every step at chen@ring8
# (3.6e-7 after one step, 5.8e-4 after 16 against the Pallas kernel), so
# the free-run tier is held over 8 steps
F32_STEPS = 8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain lattice loops and formulas are many
    small tensor ops, which more threads only slow down under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0(rng, shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def _offsets(rng, shape):
    off = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    off.reshape(-1)[:3] = [0xFFFFFFFF, 0xFFFFFFF0, 0]   # wrap mid-run
    return off


def _words(t):
    return ops.from_uint32(t).numpy()


def _lattice(system):
    p = default_params(system=system)
    return p, lattice_meta_tuple(p["lattice_meta"])


def _gang(topology):
    """(stacked numpy weights (4, ...), descriptor) of the four bases as
    8-node lattices of one descriptor."""
    per_core = [default_params(system=f"{b}@{topology}8") for b in BASES]
    ws = [np.stack([np.asarray(p[k], np.float32) for p in per_core])
          for k in KEYS]
    return ws, lattice_meta_tuple(per_core[0]["lattice_meta"])


# ---------------------------------------------------------------------------
# Plain lattice K1 / K2 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _pallas_traj(p, lattice, x0, dtype, act, n_steps=STEPS):
    return jax_ann.chaotic_ann_pallas(
        *[jnp.asarray(p[k]) for k in KEYS], jnp.asarray(x0).astype(dtype),
        n_steps=n_steps, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice, activation=act, interpret=True)


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_plain_lattice_k1_k2_bf16_bitwise_vs_pallas(system, activation):
    """bf16: trajectory, words (offsets that wrap past 2**32) and final
    state, bitwise; the words differ from relu's."""
    p, lattice = _lattice(system)
    rng = np.random.default_rng(61)
    x0, off = _x0(rng, (128, 24)), _offsets(rng, 128)
    xt = torch.from_numpy(x0).to(torch.bfloat16)
    w = [torch.from_numpy(np.asarray(p[k])) for k in KEYS]
    kw = dict(n_steps=STEPS, lattice=lattice, activation=activation)
    traj = chaotic_ann.chaotic_ann_traj(*w, xt, **kw)
    np.testing.assert_array_equal(
        bf16_bits(traj),
        jax_bf16_bits(_pallas_traj(p, lattice, x0, jnp.bfloat16, activation)))
    words, state = chaotic_ann.chaotic_ann_bits(*w, xt, torch.from_numpy(off),
                                                **kw)
    jw, js = jax_ann.chaotic_ann_bits_pallas(
        *[jnp.asarray(p[k]) for k in KEYS],
        jnp.asarray(x0).astype(jnp.bfloat16), jnp.asarray(off),
        n_steps=STEPS, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice, activation=activation, interpret=True)
    np.testing.assert_array_equal(_words(words), np.asarray(jw))
    np.testing.assert_array_equal(bf16_bits(state), jax_bf16_bits(js))
    relu, _ = chaotic_ann.chaotic_ann_bits(*w, xt, torch.from_numpy(off),
                                           n_steps=STEPS, lattice=lattice)
    assert not np.array_equal(_words(relu), _words(words))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_plain_lattice_k1_k2_f32_within_tolerance_of_pallas(system,
                                                            activation):
    """f32: a step from each JAX state within the one-step tier, an 8-step
    free run within the free-run tier; the port's words are its own plain
    scan packed (f32 words are not compared across the two)."""
    p, lattice = _lattice(system)
    x0 = _x0(np.random.default_rng(62), (128, 24))
    jt = np.asarray(_pallas_traj(p, lattice, x0, jnp.float32, activation))
    w = [torch.from_numpy(np.asarray(p[k])) for k in KEYS]
    step = ref.make_step(*w, dtype=torch.float32, activation=activation,
                         lattice=lattice)
    forced = step(torch.from_numpy(jt[:-1].reshape(-1, 24).copy()))
    gap = np.abs(forced.numpy().reshape(jt[1:].shape) - jt[1:]).max()
    assert gap <= F32_ONE_STEP(np.abs(jt).max()), gap
    xt = torch.from_numpy(x0)
    free = chaotic_ann.chaotic_ann_traj(*w, xt, n_steps=F32_STEPS,
                                        lattice=lattice, activation=activation)
    gap = np.abs(free.numpy() - jt[:F32_STEPS]).max()
    assert gap <= F32_FREE_RUN(np.abs(jt[:F32_STEPS]).max()), gap
    words, state = chaotic_ann.chaotic_ann_bits(
        *w, xt, 7, n_steps=F32_STEPS, lattice=lattice, activation=activation)
    np.testing.assert_array_equal(_words(words),
                                  _words(ops.pack_words(free, 7)))
    assert torch.equal(state, free[-1])


# ---------------------------------------------------------------------------
# Plain lattice K3 / K4 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# each kernel meets each activation and each topology; the farm test below
# runs ring8 K3 and K4 with both (one interpret compile is about 7 s)
@pytest.mark.parametrize("topology,activation", [("ring", "tanh"),
                                                 ("grid", "sigmoid")])
def test_plain_lattice_k3_bf16_bitwise_vs_pallas(topology, activation):
    """Plain lattice K3 == Pallas lattice K3 with tanh/sigmoid, padded and
    ragged: the words each block asked for and the final states."""
    ws, lattice = _gang(topology)
    rng = np.random.default_rng(63)
    core_map = np.array([2, 0, 3, 1], np.int32)
    x0, off = _x0(rng, (4 * S_BLOCK, 24)), _offsets(rng, 4 * S_BLOCK)
    xt = torch.from_numpy(x0).to(torch.bfloat16)
    kw = dict(n_steps=STEPS, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
              lattice=lattice, activation=activation)
    for shape, row_map in K3_ROW_MAPS.items():
        rows = (np.full(4, STEPS // 2) if row_map is None else
                jax_ann.gang_effective_rows(row_map, STEPS, T_BLOCK, UNROLL))
        jw, js = jax_ann.chaotic_ann_gang_bits_pallas(
            *map(jnp.asarray, ws), jnp.asarray(x0).astype(jnp.bfloat16),
            jnp.asarray(core_map), jnp.asarray(off),
            jnp.asarray(rows if row_map is None else row_map),
            interpret=True, **kw)
        tw, ts = chaotic_ann.chaotic_ann_gang_bits(
            *map(torch.from_numpy, ws), xt, core_map, torch.from_numpy(off),
            row_map, **kw)
        jw, tw = np.asarray(jw), _words(tw)
        for g, r in enumerate(rows):
            lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
            np.testing.assert_array_equal(tw[:r, lanes], jw[:r, lanes],
                                          err_msg=shape)
        np.testing.assert_array_equal(bf16_bits(ts), jax_bf16_bits(js),
                                      err_msg=shape)


@pytest.mark.parametrize("topology,activation", [("ring", "sigmoid"),
                                                 ("grid", "tanh")])
def test_plain_lattice_k4_bf16_bitwise_vs_pallas(topology, activation):
    """Plain lattice K4 == Pallas lattice K4 with tanh/sigmoid, padded and
    with one core frozen early and one at 0 rows, lanes not a multiple of
    the block: the words each core asked for and the final states."""
    ws, lattice = _gang(topology)
    rng = np.random.default_rng(64)
    n_lanes = 100
    x0, off = _x0(rng, (4, n_lanes, 24)), _offsets(rng, (4, n_lanes))
    xt = torch.from_numpy(x0).to(torch.bfloat16)
    for shape, row_map in K4_ROW_MAPS.items():
        rows = (np.full(4, STEPS // 2) if row_map is None
                else np.minimum(row_map, STEPS // 2))
        jw, js = jax_ann.chaotic_ann_gang_stacked_pallas(
            *map(jnp.asarray, ws), jnp.asarray(x0).astype(jnp.bfloat16),
            jnp.asarray(off), jnp.asarray(rows), n_steps=STEPS,
            s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL, lattice=lattice,
            activation=activation, interpret=True)
        tw, ts = chaotic_ann.chaotic_ann_gang_stacked(
            *map(torch.from_numpy, ws), xt, torch.from_numpy(off), row_map,
            n_steps=STEPS, lattice=lattice, activation=activation)
        jw, tw = np.asarray(jw), _words(tw)
        for c, r in enumerate(rows):
            np.testing.assert_array_equal(tw[:r, c], jw[:r, c],
                                          err_msg=shape)
        np.testing.assert_array_equal(bf16_bits(ts), jax_bf16_bits(js),
                                      err_msg=shape)


def test_plain_lattice_gangs_f32_within_tolerance_of_pallas():
    """f32, 8 steps with ragged rows: the lattice K3 (ring8, tanh) and K4
    (grid8, sigmoid) final states within the free-run tier of the Pallas
    kernels."""
    rng = np.random.default_rng(65)
    core_map = np.array([1, 3, 0, 2], np.int32)
    x0 = _x0(rng, (4 * S_BLOCK, 24))
    ws, lattice = _gang("ring")
    kw = dict(n_steps=F32_STEPS, s_block=S_BLOCK, t_block=T_BLOCK,
              unroll=UNROLL, lattice=lattice, activation="tanh")
    row_map = K3_ROW_MAPS["ragged"]
    _, js = jax_ann.chaotic_ann_gang_bits_pallas(
        *map(jnp.asarray, ws), jnp.asarray(x0), jnp.asarray(core_map), 0,
        jnp.asarray(row_map), interpret=True, **kw)
    _, ts = chaotic_ann.chaotic_ann_gang_bits(
        *map(torch.from_numpy, ws), torch.from_numpy(x0), core_map, 0,
        row_map, **kw)
    js = np.asarray(js)
    assert np.abs(ts.numpy() - js).max() <= F32_FREE_RUN(np.abs(js).max())
    ws, lattice = _gang("grid")
    xs = x0[:400].reshape(4, 100, 24)
    row_map = K4_ROW_MAPS["ragged"]
    _, js = jax_ann.chaotic_ann_gang_stacked_pallas(
        *map(jnp.asarray, ws), jnp.asarray(xs), 0, jnp.asarray(row_map),
        n_steps=F32_STEPS, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice, activation="sigmoid", interpret=True)
    _, ts = chaotic_ann.chaotic_ann_gang_stacked(
        *map(torch.from_numpy, ws), torch.from_numpy(xs), 0, row_map,
        n_steps=F32_STEPS, lattice=lattice, activation="sigmoid")
    js = np.asarray(js)
    assert np.abs(ts.numpy() - js).max() <= F32_FREE_RUN(np.abs(js).max())


# ---------------------------------------------------------------------------
# Inside the port: the lattice gang wrappers == solo lattice K1, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_lattice_gang_wrappers_equal_solo_k1(activation, dtype):
    """Lattice K3 (ragged, through ``gang_effective_rows``) and K4 (one core
    frozen at 0 rows, one clamped) give each lane exactly what solo lattice
    ``chaotic_ann_bits`` with that lane's core and activation gives it; the
    words differ from relu's."""
    ws, lattice = _gang("grid")
    w = list(map(torch.from_numpy, ws))
    rng = np.random.default_rng(66)
    s_block, steps = 32, 24
    core_map = np.array([0, 1, 2, 3, 1, 0], np.int32)
    row_map = np.array([0, 5, 12, 9, 40, 1])
    n_lanes = len(core_map) * s_block
    x0 = torch.from_numpy(_x0(rng, (n_lanes, 24))).to(dtype)
    off = torch.from_numpy(_offsets(rng, n_lanes).astype(np.int64))
    kw = dict(n_steps=steps, s_block=s_block, t_block=8, unroll=2,
              lattice=lattice)
    gw, gs = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, core_map, off, row_map, activation=activation, **kw)
    rw, _ = chaotic_ann.chaotic_ann_gang_bits(*w, x0, core_map, off, row_map,
                                              **kw)
    rows = chaotic_ann.gang_effective_rows(row_map, steps, 8, 2)
    gw, rw = ops.from_uint32(gw), ops.from_uint32(rw)
    for g, (c, r) in enumerate(zip(core_map, rows)):
        lanes = slice(g * s_block, (g + 1) * s_block)
        if r == 0:
            assert torch.equal(gs[lanes], x0[lanes])
            continue
        sw, ss = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], x0[lanes], off[lanes], n_steps=2 * r,
            lattice=lattice, activation=activation)
        assert torch.equal(gw[:r, lanes], ops.from_uint32(sw))
        assert torch.equal(gs[lanes], ss)
        assert not torch.equal(gw[:r, lanes], rw[:r, lanes])
    xs = x0[:4 * 37].reshape(4, 37, 24)
    offs = off[:4 * 37].reshape(4, 37)
    srows = [0, 7, 40, 12]
    sw, ss = chaotic_ann.chaotic_ann_gang_stacked(
        *w, xs, offs, srows, n_steps=steps, lattice=lattice,
        activation=activation)
    for c, r in enumerate(np.minimum(srows, steps // 2)):
        if r == 0:
            assert torch.equal(ss[c], xs[c])
            continue
        kw_, ks = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], xs[c], offs[c], n_steps=2 * r,
            lattice=lattice, activation=activation)
        assert torch.equal(ops.from_uint32(sw[:r, c]), ops.from_uint32(kw_))
        assert torch.equal(ss[c], ks)


# ---------------------------------------------------------------------------
# Lattice streams with tanh and sigmoid
# ---------------------------------------------------------------------------

def test_no_config_f32_tanh_lattice_stream_is_the_jax_default():
    """A no-config f32 tanh ``ChaoticStream`` of a chen@ring8 lattice
    resolves the JAX ``select_config`` (vpu, p 1, unroll 8, t_block 256)
    in both packages, so its draws run lattice K1; its burned-in state
    stays within the free-run tier of the JAX stream's (Pallas, interpret
    mode; a 2-step burn-in from the same seeds, which the JAX kernel runs
    at unroll 1: its 16-step burn-in at unroll 8 compiles for 30 s in
    interpret mode); its words are the port's lattice K1 with tanh from
    that state, and differ from relu's."""
    p = default_params(system="chen@ring8")
    want = jax_dse.select_config(24, 64, s_total=256, dtype="float32",
                                 n_nodes=8)
    assert (want.compute_unit, want.p, want.unroll, want.t_block) == (
        "vpu", 1, 8, 256)
    js = JaxStream.from_trained(p, activation="tanh", burn_in=2)
    ts = ChaoticStream.from_trained(p, activation="tanh", burn_in=2,
                                    device="cpu")
    assert dataclasses.asdict(ts._engine.config) == dataclasses.asdict(
        js._engine.config) == dataclasses.asdict(want)
    jx = np.asarray(js._state_box[0].x)
    tx = ts._state_box[0].x
    assert np.abs(tx.numpy() - jx).max() <= F32_FREE_RUN(np.abs(jx).max())
    n_launches = chaotic_ann.chaotic_ann_lattice_bits.launches
    words = ts.bits(256 * 4).numpy()
    assert chaotic_ann.chaotic_ann_lattice_bits.launches == n_launches  # CPU
    want_w, _ = chaotic_ann.chaotic_ann_lattice_bits(
        *[ts._engine.params[k] for k in KEYS], tx, n_steps=8,
        lattice=lattice_meta_tuple(p["lattice_meta"]), activation="tanh")
    np.testing.assert_array_equal(words, _words(want_w).reshape(-1))
    relu = ChaoticStream.from_trained(p, burn_in=2, device="cpu")
    assert not np.array_equal(words, relu.bits(256 * 4).numpy())


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_bf16_lattice_stream_on_a_vpu_config_bitwise_vs_jax(activation):
    """bf16 on an explicit vpu config (the JAX no-config bf16 choice at
    ring8 is the mxu unit): the burn-in and two draws of 8 word rows (one
    interpret compile), words and state bitwise."""
    p = default_params(system="chen@grid8")
    kw = dict(i_dim=24, h_dim=64, p=0, compute_unit="vpu", dtype_bytes=2,
              t_block=T_BLOCK, unroll=UNROLL, n_nodes=8)
    assert jax_dse.select_config(24, 64, s_total=256, dtype="bfloat16",
                                 n_nodes=8).compute_unit == "mxu"
    jeng = JaxPRNG(p, n_streams=128, activation=activation,
                   config=jax_dse.Candidate(**kw), dtype=jnp.bfloat16)
    teng = ChaoticPRNG(p, n_streams=128, activation=activation,
                       config=Candidate(**kw), dtype=torch.bfloat16,
                       device="cpu")
    jst, tst = jeng.init(seed=4), teng.init(seed=4)
    for n in (1000, 1048):
        jw, jst = jeng.next_words(jst, n)
        tw, tst = teng.next_words(tst, n)
        np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(bf16_bits(tst.x), jax_bf16_bits(jst.x))


# ---------------------------------------------------------------------------
# A farm of generated ring8 relu, tanh and sigmoid lattice cores
# ---------------------------------------------------------------------------

# (core name, registry lattice, activation): two cores per activation
MIXED = (("chen_ring8", "chen@ring8", "relu"),
         ("chua_ring8", "chua@ring8", "relu"),
         ("chen_ring8_tanh", "chen@ring8", "tanh"),
         ("lorenz_ring8_tanh", "lorenz@ring8", "tanh"),
         ("chua_ring8_sigmoid", "chua@ring8", "sigmoid"),
         ("rossler_ring8_sigmoid", "rossler@ring8", "sigmoid"))


def _serve(farm, round_):
    for core, reqs in round_.items():
        for client, n in reqs:
            farm.request(core, client, n)
    return farm.flush()


def _assert_same(a, b):
    assert set(a) == set(b)
    for core in a:
        assert set(a[core]) == set(b[core])
        for client in a[core]:
            np.testing.assert_array_equal(np.asarray(a[core][client]),
                                          np.asarray(b[core][client]))


def test_generated_lattice_farm_bitwise_vs_jax_farm(tmp_path):
    """JAX-generated ring8 lattice cores (registry weights expanded, the
    JAX DSE's lowest-cost solution: vpu bf16) served by the JAX farm
    (Pallas in interpret mode) and by the port's farm: uniform, skewed,
    then unequal pools (one more client on lorenz_ring8_tanh), every word
    equal; one gang group per activation, one launch each on the uniform
    flush."""
    cand = jax_dse.select(24, 64, "lowest_cost", n_nodes=8)
    assert (cand.compute_unit, cand.dtype_bytes, cand.n_nodes) == (
        "vpu", 2, 8)
    for name, system, act in MIXED:
        jax_codegen.generate_core(name, tmp_path,
                                  params=default_params(system=system),
                                  candidate=cand, system=system,
                                  activation=act)
    # no burn-in: its solo launches would add three interpret compiles
    jfarm = JaxFarm.from_generated(tmp_path, backend="pallas_interpret",
                                   burn_in=0)
    tfarm = OscillatorFarm.from_generated(tmp_path, burn_in=0, device="cpu")
    assert tfarm.cores == jfarm.cores == tuple(sorted(n for n, _, _ in MIXED))
    groups = {}
    for c in tfarm.cores:
        groups.setdefault(_compat_key(tfarm.services[c]), []).append(c)
    assert sorted(sorted(g) for g in groups.values()) == [
        ["chen_ring8", "chua_ring8"],
        ["chen_ring8_tanh", "lorenz_ring8_tanh"],
        ["chua_ring8_sigmoid", "rossler_ring8_sigmoid"]]
    for f in (jfarm, tfarm):
        for core in f.cores:
            f.register(core, "a", seed=1)
            f.register(core, "b", seed=2)
    cores = tfarm.cores
    uniform = {c: [("a", 1024), ("b", 1024)] for c in cores}
    # the relu and sigmoid groups repeat the uniform demand (their launches
    # reuse its interpret compiles); the tanh group is skewed, then unequal
    skewed = dict(uniform, chen_ring8_tanh=[("a", 32 * 128)],
                  lorenz_ring8_tanh=[("a", 256), ("b", 100)])
    unequal = dict(uniform, lorenz_ring8_tanh=[("a", 512), ("b", 512),
                                               ("c", 512)])
    for i, round_ in enumerate((uniform, skewed, unequal)):
        if i == 2:
            for f in (jfarm, tfarm):
                f.register("lorenz_ring8_tanh", "c", seed=3)
        n0, g0 = tfarm.launches, tfarm.gang_launches
        _assert_same(_serve(tfarm, round_), _serve(jfarm, round_))
        if i == 0:
            assert (tfarm.launches - n0, tfarm.gang_launches - g0) == (3, 3)


# ---------------------------------------------------------------------------
# lattice() as an ODE system
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chen@ring8", "chen@grid8", "lorenz@ring4",
                                  "lattice('chen', 4)"])
def test_lattice_system_matches_jax(name):
    """Name, dim, dt, per-node seeds and the Eq. 4 op counts equal; ``f``
    on seeded states within an f32 tolerance (XLA's matmul and PyTorch's
    sum the coupling term in other orders: a few ulps of the largest
    term)."""
    if name.startswith("lattice"):
        mine, theirs = chaotic.lattice("chen", 4), jax_chaotic.lattice("chen", 4)
    else:
        mine, theirs = chaotic.get_system(name), jax_chaotic.get_system(name)
        assert mine is chaotic.get_system(name)          # cached
    assert (mine.name, mine.dim, mine.dt, mine.n_mul_dynamic,
            mine.n_add_dynamic) == (theirs.name, theirs.dim, theirs.dt,
                                    theirs.n_mul_dynamic,
                                    theirs.n_add_dynamic)
    assert mine.x0 == theirs.x0
    assert chaotic.rk4_op_counts(mine) == jax_chaotic.rk4_op_counts(theirs)
    x = np.random.default_rng(67).normal(0.0, 5.0, (16, mine.dim)).astype(
        np.float32)
    got = mine.f(torch.from_numpy(x)).numpy()
    want = np.asarray(theirs.f(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 16 * np.finfo(np.float32).eps * \
        np.abs(want).max()


def test_lattice_integrate_and_dataset_within_tolerance_of_jax():
    """``integrate("chen@ring8")`` over 20 RK-4 steps from the per-node
    seeds, and a small ``make_dataset("chen@grid8")``'s attractor box,
    against the JAX functions (f32: the two sum in other orders, so 20
    steps agree to 1e-4 of the state's magnitude, and the box of a
    2,000-sample run, chaotic past its burn-in, to 10% of its width)."""
    sys_ = chaotic.get_system("chen@ring8")
    x0 = np.asarray(sys_.x0, np.float32)
    got = chaotic.integrate("chen@ring8", torch.from_numpy(x0), 20).numpy()
    want = np.asarray(jax_chaotic.integrate("chen@ring8", jnp.asarray(x0),
                                            20))
    assert got.shape == want.shape == (21, 24)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())
    mine = chaotic.make_dataset("chen@grid8", n_samples=2_000, burn_in=500,
                                device="cpu")
    theirs = jax_chaotic.make_dataset("chen@grid8", n_samples=2_000,
                                      burn_in=500)
    assert mine.x_train.shape == theirs.x_train.shape == (1_600, 24)
    assert mine.system == "chen@grid8" and mine.dt == theirs.dt
    assert np.all(np.isfinite(mine.x_train))
    np.testing.assert_allclose(mine.scale, theirs.scale, rtol=0.1)
    assert np.abs(mine.offset - theirs.offset).max() <= \
        0.1 * theirs.scale.min()


@pytest.mark.parametrize("name,error", [
    ("chen@torus8", KeyError), ("chen@ring", KeyError),
    ("nosuch@ring8", KeyError), ("chen@ring1", ValueError)])
def test_bad_lattice_names_raise_as_jax(name, error):
    with pytest.raises(error):
        jax_chaotic.get_system(name)
    with pytest.raises(error):
        chaotic.get_system(name)
