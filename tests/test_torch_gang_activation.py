"""tanh and sigmoid in the port's scalar vpu gang kernels (K3
``chaotic_ann_gang_bits``, K4 ``chaotic_ann_gang_stacked``) and a farm of
generated tanh and sigmoid cores, on the CPU, against the JAX package.

* The plain K3/K4 with tanh and sigmoid against the Pallas K3/K4 in
  interpret mode on the four 3-8-3 registry nets (chen, chua, lorenz,
  rossler), padded and ragged, one net's slab referenced by two lane
  blocks: bitwise in bf16 (words and state); in f32 within
  ``F32_ONE_STEP`` after one word row from the JAX state and within
  ``F32_FREE_RUN`` after 16 steps (``tests/test_torch_kernels.py``).
* The port's K3/K4 wrappers (on the CPU, their plain versions) against
  solo ``chaotic_ann_bits`` per core: bitwise in both dtypes.
* A farm of JAX-generated relu, tanh and sigmoid cores served by both
  frameworks: every delivered word equal in bf16, one gang launch per
  activation group.
* ``generate_farm`` against the JAX ``generate_farm``, and a directory of
  its relu cores beside generated tanh and sigmoid cores served by the
  port: one gang group per activation, words equal to ``gang=False``.

The CUDA kernels are held to these plain versions on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen as jax_codegen
from repro.core import dse as jax_dse
from repro.kernels import chaotic_ann as jax_ann
from repro.serve.farm import OscillatorFarm as JaxFarm
from repro_torch.core import codegen, dse
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params
from repro_torch.serve.farm import OscillatorFarm, _compat_key

from test_torch_kernels import F32_FREE_RUN, F32_ONE_STEP

KEYS = ("w1", "b1", "w2", "b2")
NETS = ("chen", "chua", "lorenz", "rossler")       # the 3-8-3 registry nets
ACTIVATIONS = ("tanh", "sigmoid")
S_BLOCK, T_BLOCK, UNROLL, STEPS = 128, 32, 2, 64
# eight lane blocks, each net's slab referenced by two of them; demands of
# 0, not a multiple of the granularity (unroll 2), and above the 32 rows
CORE_MAP = np.array([0, 1, 2, 3, 1, 0, 3, 2], np.int32)
K3_ROW_MAPS = {"padded": None, "ragged": np.array([0, 3, 32, 17, 9, 40, 1, 8])}
K4_ROW_MAPS = {"padded": None, "ragged": np.array([0, 17, 40, 9])}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain formulas are many small tensor ops,
    which more threads only slow down under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stacked():
    """The four registry nets' weights stacked on a leading core axis."""
    per_core = [[np.asarray(default_params(system=s)[k], np.float32)
                 for k in KEYS] for s in NETS]
    return [np.stack(ws) for ws in zip(*per_core)]


def _x0(rng, shape):
    return rng.uniform(-0.9, 0.9, shape).astype(np.float32)


def _offsets(rng, shape):
    off = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    off.reshape(-1)[:3] = [0xFFFFFFFF, 0xFFFFFFF0, 0]   # wrap mid-run
    return off


def _bits(a):
    """bf16 or f32 values (torch or JAX) as their int32 f32 patterns."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy().view(np.int32)
    return np.asarray(a.astype(jnp.float32)).view(np.int32)


# ---------------------------------------------------------------------------
# Plain K3 / K4 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(K3_ROW_MAPS))
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_k3_bf16_bitwise_vs_pallas(stacked, activation, shape):
    """Plain K3 == Pallas K3 with tanh/sigmoid: the words each block asked
    for (its demand rounded as the kernel rounds it) and the final states,
    bitwise."""
    rng = np.random.default_rng(41)
    row_map = K3_ROW_MAPS[shape]
    n_lanes = len(CORE_MAP) * S_BLOCK
    x0, off = _x0(rng, (n_lanes, 3)), _offsets(rng, n_lanes)
    kw = dict(n_steps=STEPS, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
              activation=activation)
    jw, js = jax_ann.chaotic_ann_gang_bits_pallas(
        *map(jnp.asarray, stacked), jnp.asarray(x0).astype(jnp.bfloat16),
        jnp.asarray(CORE_MAP), jnp.asarray(off),
        None if row_map is None else jnp.asarray(row_map), interpret=True,
        **kw)
    rows = (np.full(len(CORE_MAP), STEPS // 2) if row_map is None else
            jax_ann.gang_effective_rows(row_map, STEPS, T_BLOCK, UNROLL))
    tw, ts = ref.chaotic_ann_gang_bits_ref(
        *map(torch.from_numpy, stacked),
        torch.from_numpy(x0).to(torch.bfloat16), CORE_MAP, STEPS,
        torch.from_numpy(off.astype(np.int64)), rows, activation)
    jw, tw = np.asarray(jw), ops.from_uint32(tw).numpy()
    for g, r in enumerate(rows):
        lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
        np.testing.assert_array_equal(tw[:r, lanes], jw[:r, lanes])
    np.testing.assert_array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("shape", sorted(K4_ROW_MAPS))
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_k4_bf16_bitwise_vs_pallas(stacked, activation, shape):
    """Plain K4 == Pallas K4 with tanh/sigmoid: the words each core asked
    for and the final states (a frozen core's included), bitwise."""
    rng = np.random.default_rng(42)
    row_map = K4_ROW_MAPS[shape]
    n_lanes = S_BLOCK + 37
    x0, off = _x0(rng, (4, n_lanes, 3)), _offsets(rng, (4, n_lanes))
    jw, js = jax_ann.chaotic_ann_gang_stacked_pallas(
        *map(jnp.asarray, stacked), jnp.asarray(x0).astype(jnp.bfloat16),
        jnp.asarray(off), None if row_map is None else jnp.asarray(row_map),
        n_steps=STEPS, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        activation=activation, interpret=True)
    tw, ts = ref.chaotic_ann_gang_stacked_ref(
        *map(torch.from_numpy, stacked),
        torch.from_numpy(x0).to(torch.bfloat16), STEPS,
        torch.from_numpy(off.astype(np.int64)), row_map, activation)
    rows = (np.full(4, STEPS // 2) if row_map is None
            else np.minimum(row_map, STEPS // 2))
    jw, tw = np.asarray(jw), ops.from_uint32(tw).numpy()
    for c, r in enumerate(rows):
        np.testing.assert_array_equal(tw[:r, c], jw[:r, c])
    np.testing.assert_array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_gang_f32_within_stated_tolerance_of_pallas(stacked,
                                                          activation):
    """f32 (XLA's CPU code and PyTorch's eager ops differ in the low bits,
    so f32 words are not compared across the two): K3 one word row from
    the JAX state after one row, within the one-step tier; K3 and K4 over
    16 steps with ragged rows, within the free-run tier."""
    rng = np.random.default_rng(43)
    jwts = list(map(jnp.asarray, stacked))
    tws = list(map(torch.from_numpy, stacked))
    n_lanes = len(CORE_MAP) * S_BLOCK
    x0 = _x0(rng, (n_lanes, 3))
    kw = dict(s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
              activation=activation)
    _, j1 = jax_ann.chaotic_ann_gang_bits_pallas(
        *jwts, jnp.asarray(x0), jnp.asarray(CORE_MAP), n_steps=2,
        interpret=True, **kw)
    _, j2 = jax_ann.chaotic_ann_gang_bits_pallas(
        *jwts, j1, jnp.asarray(CORE_MAP), n_steps=2, interpret=True, **kw)
    _, t2 = chaotic_ann.chaotic_ann_gang_bits(
        *tws, torch.from_numpy(np.array(j1)), CORE_MAP, n_steps=2, **kw)
    j2 = np.asarray(j2)
    gap = np.abs(t2.numpy() - j2).max()
    assert gap <= F32_ONE_STEP(np.abs(j2).max()), gap
    row_map = np.array([8, 0, 3, 5, 8, 2, 1, 8])
    _, js = jax_ann.chaotic_ann_gang_bits_pallas(
        *jwts, jnp.asarray(x0), jnp.asarray(CORE_MAP), 0,
        jnp.asarray(row_map), n_steps=16, interpret=True, **kw)
    _, ts = chaotic_ann.chaotic_ann_gang_bits(
        *tws, torch.from_numpy(x0), CORE_MAP, 0, row_map, n_steps=16, **kw)
    js = np.asarray(js)
    gap = np.abs(ts.numpy() - js).max()
    assert gap <= F32_FREE_RUN(np.abs(js).max()), gap
    xs = x0[:4 * S_BLOCK].reshape(4, S_BLOCK, 3)
    _, js = jax_ann.chaotic_ann_gang_stacked_pallas(
        *jwts, jnp.asarray(xs), 0, jnp.asarray([8, 3, 0, 5]), n_steps=16,
        s_block=S_BLOCK, activation=activation, interpret=True)
    _, ts = chaotic_ann.chaotic_ann_gang_stacked(
        *tws, torch.from_numpy(xs), 0, [8, 3, 0, 5], n_steps=16,
        activation=activation)
    js = np.asarray(js)
    gap = np.abs(ts.numpy() - js).max()
    assert gap <= F32_FREE_RUN(np.abs(js).max()), gap


# ---------------------------------------------------------------------------
# Inside the port: the gang wrappers == solo K1, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_gang_wrappers_equal_solo_k1(stacked, activation, dtype):
    """K3 (ragged, through ``gang_effective_rows``) and K4 (one core frozen
    at 0 rows, one clamped) give each lane exactly what solo
    ``chaotic_ann_bits`` with that lane's net and activation gives it; the
    words differ from relu's."""
    w = list(map(torch.from_numpy, stacked))
    rng = np.random.default_rng(44)
    n_lanes = len(CORE_MAP) * S_BLOCK
    x0 = torch.from_numpy(_x0(rng, (n_lanes, 3))).to(dtype)
    off = torch.from_numpy(_offsets(rng, n_lanes).astype(np.int64))
    row_map = K3_ROW_MAPS["ragged"]
    kw = dict(n_steps=STEPS, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL)
    gw, gs = chaotic_ann.chaotic_ann_gang_bits(
        *w, x0, CORE_MAP, off, row_map, activation=activation, **kw)
    rw, _ = chaotic_ann.chaotic_ann_gang_bits(*w, x0, CORE_MAP, off, row_map,
                                              **kw)
    rows = chaotic_ann.gang_effective_rows(row_map, STEPS, T_BLOCK, UNROLL)
    gw, rw = ops.from_uint32(gw), ops.from_uint32(rw)
    for g, (c, r) in enumerate(zip(CORE_MAP, rows)):
        lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
        if r == 0:
            assert torch.equal(gs[lanes], x0[lanes])
            continue
        sw, ss = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], x0[lanes], off[lanes], n_steps=2 * r,
            activation=activation)
        assert torch.equal(gw[:r, lanes], ops.from_uint32(sw))
        assert torch.equal(gs[lanes], ss)
        assert not torch.equal(gw[:r, lanes], rw[:r, lanes])
    xs = x0[:4 * 77].reshape(4, 77, 3)
    offs = off[:4 * 77].reshape(4, 77)
    srows = [0, 11, 40, 32]
    sw, ss = chaotic_ann.chaotic_ann_gang_stacked(
        *w, xs, offs, srows, n_steps=STEPS, activation=activation)
    for c, r in enumerate(np.minimum(srows, STEPS // 2)):
        if r == 0:
            assert torch.equal(ss[c], xs[c])
            continue
        kw_, ks = chaotic_ann.chaotic_ann_bits(
            *[t[c] for t in w], xs[c], offs[c], n_steps=2 * r,
            activation=activation)
        assert torch.equal(ops.from_uint32(sw[:r, c]), ops.from_uint32(kw_))
        assert torch.equal(ss[c], ks)


# ---------------------------------------------------------------------------
# A farm of generated tanh and sigmoid cores
# ---------------------------------------------------------------------------

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


# (core name, registry net, activation): two cores per activation
MIXED = (("chen_relu", "chen", "relu"), ("chua_relu", "chua", "relu"),
         ("chen_tanh", "chen", "tanh"), ("lorenz_tanh", "lorenz", "tanh"),
         ("chua_sigmoid", "chua", "sigmoid"),
         ("rossler_sigmoid", "rossler", "sigmoid"))


def test_generated_tanh_sigmoid_farm_bitwise_vs_jax_farm(tmp_path):
    """JAX-generated relu, tanh and sigmoid cores (vpu bf16, the JAX DSE's
    lowest-cost solution) served by the JAX farm (Pallas in interpret
    mode) and by the port's farm: uniform, skewed, then unequal pools (one
    more client on lorenz_tanh), every word equal; the uniform flush is one
    gang launch per activation."""
    cand = jax_dse.select(3, 8, "lowest_cost")
    assert (cand.compute_unit, cand.dtype_bytes) == ("vpu", 2)
    for name, net, act in MIXED:
        jax_codegen.generate_core(name, tmp_path, params=default_params(
            system=net), candidate=cand, system=net, activation=act)
    jfarm = JaxFarm.from_generated(tmp_path, backend="pallas_interpret")
    tfarm = OscillatorFarm.from_generated(tmp_path, device="cpu")
    assert tfarm.cores == jfarm.cores == tuple(sorted(n for n, _, _ in MIXED))
    keys = {c: _compat_key(tfarm.services[c]) for c in tfarm.cores}
    assert len(set(keys.values())) == 3
    assert all(keys[f"{a}_{b}"] == keys[f"{c}_{b}"] for a, c, b in (
        ("chen", "chua", "relu"), ("chen", "lorenz", "tanh"),
        ("chua", "rossler", "sigmoid")))
    for f in (jfarm, tfarm):
        for core in f.cores:
            f.register(core, "a", seed=1)
            f.register(core, "b", seed=2)
    cores = tfarm.cores
    uniform = {c: [("a", 1024), ("b", 1024)] for c in cores}
    skewed = {c: [("a", 256), ("b", 100)] for c in cores}
    skewed["chen_tanh"] = [("a", 64 * 128)]
    unequal = {c: [("a", 512)] for c in cores}
    unequal["lorenz_tanh"] = [("a", 512), ("c", 512)]
    for i, round_ in enumerate((uniform, skewed, unequal)):
        if i == 2:
            for f in (jfarm, tfarm):
                f.register("lorenz_tanh", "c", seed=3)
        n0, g0 = tfarm.launches, tfarm.gang_launches
        _assert_same(_serve(tfarm, round_), _serve(jfarm, round_))
        if i == 0:
            assert (tfarm.launches - n0, tfarm.gang_launches - g0) == (3, 3)


def test_generate_farm_equals_jax_generate_farm(tmp_path):
    """The port's ``generate_farm`` emits the JAX ``generate_farm``'s
    candidate, system, activation and weights for chen, lorenz and
    chen@ring8; the port's farm serves the directory (chen and lorenz in
    one gang, the lattice alone), words equal to ``gang=False``."""
    systems = ("chen", "lorenz", "chen@ring8")
    mine = codegen.generate_farm(tmp_path / "torch", systems)
    theirs = jax_codegen.generate_farm(tmp_path / "jax", systems)
    assert set(mine) == set(theirs) == set(systems)
    for name in systems:
        assert mine[name].name == theirs[name].name == name.replace("@", "_")
        a = json.loads((mine[name] / "solution.json").read_text())
        b = json.loads((theirs[name] / "solution.json").read_text())
        assert {k: a[k] for k in ("candidate", "system", "activation")} == \
            {k: b[k] for k in ("candidate", "system", "activation")}
        assert a["activation"] == "relu"
        with np.load(mine[name] / "weights.npz") as x, \
                np.load(theirs[name] / "weights.npz") as y:
            assert set(x.files) == set(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k])
    farms = [OscillatorFarm.from_generated(tmp_path / "torch", gang=g,
                                           device="cpu") for g in (True, False)]
    for f in farms:
        for core in f.cores:
            f.register(core, "a", seed=5)
    round_ = {c: [("a", 512)] for c in farms[0].cores}
    n0 = farms[0].gang_launches
    _assert_same(*(_serve(f, round_) for f in farms))
    assert (farms[0].launches, farms[0].gang_launches - n0) == (2, 1)


def test_mixed_directory_one_gang_group_per_activation(tmp_path):
    """``generate_farm``'s relu cores beside ``generate_core``'s tanh and
    sigmoid cores on ``select(3, 8, "pareto")``: every 3-8-3 core resolves
    to one config, so only the activation splits the groups (hyperlorenz,
    4-16, alone); a uniform flush is one gang launch per activation and a
    solo launch, words equal to ``gang=False``."""
    codegen.generate_farm(tmp_path, ("chen", "lorenz", "hyperlorenz"))
    cand = dse.select(3, 8, "pareto")
    assert dataclasses.asdict(cand) == dataclasses.asdict(
        jax_dse.select(3, 8, "pareto"))
    for net in ("chen", "chua"):
        for act in ACTIVATIONS:
            codegen.generate_core(f"{net}_{act}", tmp_path,
                                  params=default_params(system=net),
                                  candidate=cand, system=net, activation=act)
    farms = [OscillatorFarm.from_generated(tmp_path, gang=g, device="cpu")
             for g in (True, False)]
    svcs = farms[0].services
    groups = {}
    for c in farms[0].cores:
        groups.setdefault(_compat_key(svcs[c]), []).append(c)
    assert sorted(sorted(g) for g in groups.values()) == [
        ["chen", "lorenz"], ["chen_sigmoid", "chua_sigmoid"],
        ["chen_tanh", "chua_tanh"], ["hyperlorenz"]]
    assert len({svcs[c].config for c in farms[0].cores
                if c != "hyperlorenz"}) == 1
    for f in farms:
        for core in f.cores:
            f.register(core, "a", seed=8)
            f.register(core, "b", seed=9)
    round_ = {c: [("a", 384), ("b", 384)] for c in farms[0].cores}
    _assert_same(*(_serve(f, round_) for f in farms))
    assert (farms[0].launches, farms[0].gang_launches) == (4, 3)
    assert farms[1].launches == 7
