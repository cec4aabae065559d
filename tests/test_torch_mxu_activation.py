"""tanh and sigmoid in the port's mxu kernels (the dot form of K1
``chaotic_ann_mxu_bits``, K2 ``chaotic_ann_mxu_traj`` and K3
``chaotic_ann_mxu_gang_bits``, with K5's coupling dot for a lattice), and
the streams, generated cores and farms that run them, on the CPU, against
the JAX package on the same numpy-seeded inputs.

The mxu dot is a forward chain of f32 fused multiply-adds on both sides
(``tests/test_torch_mxu.py``), and the second dot reads phi's f32 result
unrounded (``ref.tanh``/``ref.sigmoid(..., f32_result=True)``), so the
tier is bitwise in f32 and bf16, as for relu:

* the plain mxu K1/K2 equal the Pallas kernels in interpret mode at
  chen@ring8, chen@grid8 (registry weights and a net trained here with
  tanh), hyperlorenz's 4-16 scalar net, and in a few steps at chen@ring32;
* the plain mxu K3 equals the Pallas mxu K3, padded and ragged, for a
  ring8 lattice gang of three bases and the 3-8-3 scalar gang of four,
  and equals solo plain mxu K1 per core;
* the no-config bf16 chen@ring8 ``ChaoticPRNG`` resolves the JAX mxu
  choice and equals the JAX engine; ``select(24, 64, "min_latency",
  n_nodes=8)`` is the JAX ``Candidate``, and a core generated on it
  equals the JAX-generated core;
* a farm of no-config ring8 relu, tanh and sigmoid cores (bf16: the mxu
  unit) delivers the JAX farm's words, one mxu gang group an activation.

Inside the port: the node's block-sparse chain equals the dense chain
bitwise when tanh puts -0 into it.  The CUDA kernels are held to these
plain versions on the card in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import dataclasses
import importlib
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen as jax_codegen
from repro.core import dse as jax_dse
from repro.kernels import chaotic_ann as jax_ann
from repro.prng.stream import ChaoticPRNG as JaxPRNG
from repro.serve.farm import OscillatorFarm as JaxFarm
from repro_torch.core import codegen, dse
from repro_torch.core.ann import (AnnConfig, expand_lattice_params,
                                  extract_parameters, lattice_meta_tuple,
                                  train)
from repro_torch.core.chaotic import DEFAULT_LATTICE_COUPLING, make_dataset
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import ChaoticPRNG, default_params
from repro_torch.serve.farm import OscillatorFarm, _compat_key

KEYS = ("w1", "b1", "w2", "b2")
ACTIVATIONS = ("tanh", "sigmoid")
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
# the Pallas schedule of the comparisons: small blocks keep the interpret
# compiles short and change no value
S_BLOCK, T_BLOCK, UNROLL, STEPS = 128, 4, 1, 16
LATTICE_BASES = ("chen", "lorenz", "rossler")
SCALAR_BASES = ("chen", "chua", "lorenz", "rossler")
ROW_MAP = np.array([0, 3, 8, 5])          # 0, odd, the launch's rows, ragged


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain f32 FMA chains are thousands of small
    tensor ops, which more threads only slow down under xdist."""
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


def state_bits(a):
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def tanh_net():
    """A chen 3-8-3 net trained here with tanh (a short run: the check is
    the kernels' arithmetic on weights other than the registry's)."""
    ds = make_dataset("chen", n_samples=4_000, seed=1, device="cpu")
    params, hist = train(AnnConfig(activation="tanh"), ds, epochs=100,
                         lr=3e-3, seed=1, device="cpu")
    assert hist["test_metrics"]["r2"] > 0.99, hist["test_metrics"]
    return extract_parameters(params)


def _net(name, tanh_net):
    """(numpy params, lattice descriptor or None, coupling or None)."""
    if name == "tanh-trained@ring8":
        p = expand_lattice_params(tanh_net, n_nodes=8,
                                  coupling=DEFAULT_LATTICE_COUPLING)
    else:
        p = default_params(system=name)
    if "lattice_meta" not in p:
        return p, None, None
    return p, lattice_meta_tuple(p["lattice_meta"]), p["coupling"]


# ---------------------------------------------------------------------------
# Plain mxu K1 / K2 against the Pallas kernels (interpret mode), bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("net", ["chen@ring8", "chen@grid8",
                                 "tanh-trained@ring8", "hyperlorenz"])
def test_plain_mxu_k1_k2_bitwise_vs_pallas(tanh_net, net, activation,
                                           dtypes):
    """Plain mxu K2 (the trajectory) and K1 (words, final state) ==
    Pallas mxu K2/K1 in interpret mode, bitwise, with offsets that wrap
    past 2^32; the wrappers on the CPU return the same."""
    tdt, jdt = dtypes
    p, lattice, cpl = _net(net, tanh_net)
    i_dim = p["w1"].shape[0]
    rng = np.random.default_rng(71)
    x0, off = _x0(rng, (S_BLOCK, i_dim)), _offsets(rng, S_BLOCK)
    jw = [jnp.asarray(p[k]) for k in KEYS]
    jx0 = jnp.asarray(x0).astype(jdt)
    jcpl = None if cpl is None else jnp.asarray(cpl)
    kw = dict(n_steps=STEPS, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
              compute_unit="mxu", lattice=lattice, activation=activation,
              interpret=True)
    traj_j = jax_ann.chaotic_ann_pallas(*jw, jx0, jcpl, **kw)
    words_j, state_j = jax_ann.chaotic_ann_bits_pallas(
        *jw, jx0, jnp.asarray(off), jcpl, **kw)
    w = [torch.from_numpy(np.asarray(p[k], np.float32)) for k in KEYS]
    x = torch.from_numpy(x0).to(tdt)
    tkw = dict(lattice=lattice, compute_unit="mxu",
               coupling=None if cpl is None else torch.from_numpy(cpl))
    traj = ref.chaotic_ann_ref(*w, x, STEPS, activation, **tkw)
    words, state = ref.chaotic_ann_bits_ref(
        *w, x, STEPS, torch.from_numpy(off.astype(np.int64)), activation,
        **tkw)
    np.testing.assert_array_equal(state_bits(traj),
                                  state_bits(traj_j.astype(jnp.float32)))
    np.testing.assert_array_equal(_words(words), np.asarray(words_j))
    np.testing.assert_array_equal(state_bits(state),
                                  state_bits(state_j.astype(jnp.float32)))
    assert torch.equal(chaotic_ann.chaotic_ann_traj(
        *w, x, n_steps=STEPS, activation=activation, **tkw), traj)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_mxu_ring32_bitwise_vs_pallas(activation):
    """chen@ring32, the shape the no-config stream and the mxu farm run: a
    few steps of plain mxu K1 == Pallas mxu K1 (interpret), words and
    state, in both dtypes."""
    p, lattice, cpl = _net("chen@ring32", None)
    rng = np.random.default_rng(72)
    x0, off = _x0(rng, (S_BLOCK, 96)), _offsets(rng, S_BLOCK)
    w = [torch.from_numpy(p[k]) for k in KEYS]
    for tdt, jdt in DTYPES:
        words_j, state_j = jax_ann.chaotic_ann_bits_pallas(
            *[jnp.asarray(p[k]) for k in KEYS], jnp.asarray(x0).astype(jdt),
            jnp.asarray(off), jnp.asarray(cpl), n_steps=4, s_block=S_BLOCK,
            t_block=4, unroll=1, compute_unit="mxu", lattice=lattice,
            activation=activation, interpret=True)
        words, state = ref.chaotic_ann_bits_ref(
            *w, torch.from_numpy(x0).to(tdt), 4,
            torch.from_numpy(off.astype(np.int64)), activation, lattice,
            "mxu", torch.from_numpy(cpl))
        np.testing.assert_array_equal(_words(words), np.asarray(words_j))
        np.testing.assert_array_equal(state_bits(state),
                                      state_bits(state_j.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Plain mxu K3 against the Pallas kernel and against solo mxu K1
# ---------------------------------------------------------------------------

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


GANGS = {"ring8": (tuple(f"{b}@ring8" for b in LATTICE_BASES),
                   np.array([2, 0, 1, 0], np.int32)),
         "scalar": (SCALAR_BASES, np.array([3, 1, 0, 2], np.int32))}


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("gang", sorted(GANGS))
def test_plain_mxu_k3_bitwise_vs_pallas(gang, activation, dtypes):
    """Plain mxu K3 == Pallas mxu K3 (interpret), bitwise: a ragged launch
    (the words each block asked for) and a padded one (the full row_map:
    one interpret compile serves both), final states too."""
    tdt, jdt = dtypes
    systems, core_map = GANGS[gang]
    ws, lattice, cpl = _gang(systems)
    i_dim = ws[0].shape[1]
    rng = np.random.default_rng(73)
    s_total = len(core_map) * S_BLOCK
    x0, off = _x0(rng, (s_total, i_dim)), _offsets(rng, s_total)
    tw = [torch.from_numpy(w) for w in ws]
    tcpl = None if cpl is None else torch.from_numpy(cpl)
    for row_map in (ROW_MAP, None):
        jw, js = jax_ann.chaotic_ann_gang_bits_pallas(
            *[jnp.asarray(w) for w in ws], jnp.asarray(x0).astype(jdt),
            jnp.asarray(core_map), jnp.asarray(off),
            jnp.asarray(np.full(len(core_map), STEPS // 2)
                        if row_map is None else row_map, jnp.int32),
            None if cpl is None else jnp.asarray(cpl), n_steps=STEPS,
            s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
            compute_unit="mxu", lattice=lattice, activation=activation,
            interpret=True)
        got_w, got_s = chaotic_ann.chaotic_ann_gang_bits(
            *tw, torch.from_numpy(x0).to(tdt), core_map,
            torch.from_numpy(off), row_map, n_steps=STEPS, s_block=S_BLOCK,
            t_block=T_BLOCK, unroll=UNROLL, compute_unit="mxu",
            lattice=lattice, coupling=tcpl, activation=activation)
        rows = (jax_ann.gang_effective_rows(row_map, STEPS, T_BLOCK, UNROLL)
                if row_map is not None else [STEPS // 2] * len(core_map))
        jw, got_w = np.asarray(jw), _words(got_w)
        for g, r in enumerate(rows):
            lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
            np.testing.assert_array_equal(got_w[:r, lanes], jw[:r, lanes])
        np.testing.assert_array_equal(state_bits(got_s),
                                      state_bits(js.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_mxu_k3_equals_solo_mxu_k1(activation, dtype):
    """Per lane block, the plain mxu K3 with tanh/sigmoid equals the solo
    plain mxu K1 of its core over its own rows (words and state), zero
    past them; a block at 0 rows keeps its state; the words differ from
    relu's.  A ring8 lattice gang of three bases and the 3-8-3 gang of
    four."""
    rng = np.random.default_rng(74)
    s_block, n_steps = 16, 16
    row_map = np.array([8, 0, 3, 5, 8])
    for gang in sorted(GANGS):
        ws, lattice, cpl = _gang(GANGS[gang][0])
        w = [torch.from_numpy(a) for a in ws]
        kw = dict(lattice=lattice, compute_unit="mxu",
                  coupling=None if cpl is None else torch.from_numpy(cpl))
        core_map = np.arange(len(row_map)) % len(ws[0])
        x0 = torch.from_numpy(_x0(rng, (len(row_map) * s_block,
                                        ws[0].shape[1]))).to(dtype)
        off = torch.from_numpy(_offsets(rng, len(row_map) * s_block)
                               .astype(np.int64))
        gkw = dict(n_steps=n_steps, s_block=s_block, t_block=T_BLOCK,
                   unroll=UNROLL, **kw)
        gw, gs = chaotic_ann.chaotic_ann_gang_bits(
            *w, x0, core_map, off, row_map, activation=activation, **gkw)
        relu_w, _ = chaotic_ann.chaotic_ann_gang_bits(
            *w, x0, core_map, off, row_map, **gkw)
        rows = chaotic_ann.gang_effective_rows(row_map, n_steps, T_BLOCK,
                                               UNROLL)
        gw = _words(gw)
        assert not np.array_equal(gw, _words(relu_w))
        for g, (c, r) in enumerate(zip(core_map, rows)):
            lanes = slice(g * s_block, (g + 1) * s_block)
            if r == 0:
                assert torch.equal(gs[lanes], x0[lanes])
                continue
            want_w, want_s = ref.chaotic_ann_bits_ref(
                *[t[c] for t in w], x0[lanes], 2 * int(r), off[lanes],
                activation, **kw)
            np.testing.assert_array_equal(gw[:r, lanes], _words(want_w))
            assert not gw[r:, lanes].any()        # zero past the rows
            assert torch.equal(gs[lanes], want_s)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_mxu_wrappers_on_cpu_take_the_plain_version(activation):
    """On CPU tensors the three mxu wrappers take tanh and sigmoid, return
    their plain versions' results and count no launch."""
    p, lattice, cpl = _net("chen@grid8", None)
    w = [torch.from_numpy(p[k]) for k in KEYS]
    x0 = torch.from_numpy(_x0(np.random.default_rng(75), (32, 24)))
    kw = dict(lattice=lattice, coupling=torch.from_numpy(cpl),
              activation=activation)
    names = ("chaotic_ann_mxu_bits", "chaotic_ann_mxu_traj",
             "chaotic_ann_mxu_gang_bits")
    before = [getattr(chaotic_ann, n).launches for n in names]
    words, state = chaotic_ann.chaotic_ann_mxu_bits(*w, x0, 5, n_steps=4,
                                                    **kw)
    traj = chaotic_ann.chaotic_ann_mxu_traj(*w, x0, n_steps=4, **kw)
    gw, gs = chaotic_ann.chaotic_ann_mxu_gang_bits(
        *[t[None] for t in w], x0, [0, 0], 5, n_steps=4, s_block=16, **kw)
    want = ref.chaotic_ann_ref(*w, x0, 4, activation, lattice, "mxu",
                               torch.from_numpy(cpl))
    assert torch.equal(traj, want)
    assert torch.equal(state, want[-1]) and torch.equal(gs, want[-1])
    np.testing.assert_array_equal(_words(words),
                                  _words(ops.pack_words(want, 5)))
    np.testing.assert_array_equal(_words(gw), _words(words))
    assert [getattr(chaotic_ann, n).launches for n in names] == before


# ---------------------------------------------------------------------------
# The block-sparse node chain against the dense chain, with -0 terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_node_chain_equals_dense_chain_with_negative_zero_terms(dtype):
    """The CUDA mxu kernels run each node's chain over its own block only
    (chaotic_ann.cu, the mxu section).  Under tanh the dense chain's
    off-block products are -0 wherever h < 0 (and in-block where a hidden
    pre-activation is exactly -0: tanh(-0) = -0); an accumulator from +0
    never becomes -0 and no +-0 term moves it, so the node chain equals
    the dense plain chain (``ref.mxu_dot``) bitwise.  Seeded hidden
    pre-activations at chen@ring8, a quarter of them exactly -0."""
    p, lattice, _ = _net("chen@ring8", None)
    n_nodes, d = lattice[0], lattice[1]
    hb = p["w1"].shape[1] // n_nodes
    rng = np.random.default_rng(76)
    v = rng.uniform(-2, 2, (64, n_nodes * hb)).astype(np.float32)
    v[rng.random(v.shape) < 0.25] = -0.0
    v = torch.from_numpy(v).to(dtype)
    h = ref.tanh(v, f32_result=True) if dtype == torch.bfloat16 \
        else ref.tanh(v)
    assert h.dtype == torch.float32
    assert bool((torch.signbit(h) & (h == 0)).any())     # -0 in the chain
    w2 = torch.from_numpy(p["w2"]).to(dtype)
    dense = ref.mxu_dot(h, w2, dtype)
    node = torch.empty_like(dense)
    for n in range(n_nodes):
        cols = slice(n * d, (n + 1) * d)
        acc = torch.zeros(h.shape[0], d)
        for j in range(n * hb, (n + 1) * hb):
            acc = ref.fma_f32(h[:, j:j + 1], w2[j, cols].float(), acc)
        node[:, cols] = acc.to(dtype)
    products = h[:, :, None] * w2.float()[None]
    assert bool(((products == 0) & torch.signbit(products)).any())
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(node.view(bits), dense.view(bits))
    assert not bool((torch.signbit(dense) & (dense == 0)).any())


# ---------------------------------------------------------------------------
# The no-config stream, the DSE's min-latency lattice core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_nodes,i_dim,h_dim", [(8, 24, 64), (32, 96, 256)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_resolve_config_is_the_jax_select_config(n_nodes, i_dim, h_dim,
                                                 dtypes):
    """A tanh engine's config is the JAX ``select_config`` at the
    lattice's shape: mxu at chen@ring32 in both dtypes and at bf16
    chen@ring8, vpu at f32 chen@ring8."""
    tdt, jdt = dtypes
    want = jax_dse.select_config(i_dim, h_dim, s_total=256,
                                 dtype=jnp.dtype(jdt).name, n_nodes=n_nodes)
    eng = ChaoticPRNG(default_params(system=f"chen@ring{n_nodes}"),
                      activation="tanh", dtype=tdt, device="cpu")
    assert dataclasses.asdict(eng.config) == dataclasses.asdict(want)
    assert eng.config.compute_unit == (
        "vpu" if (n_nodes, tdt) == (8, torch.float32) else "mxu")


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_no_config_bf16_ring8_engine_bitwise_vs_jax(activation):
    """The no-config bf16 chen@ring8 ``ChaoticPRNG`` with tanh/sigmoid (the
    mxu unit in both packages): burn-in, two draws and the state,
    bitwise; its words differ from relu's."""
    p = default_params(system="chen@ring8")
    jeng = JaxPRNG(p, n_streams=128, activation=activation,
                   dtype=jnp.bfloat16)
    teng = ChaoticPRNG(p, n_streams=128, activation=activation,
                       dtype=torch.bfloat16, device="cpu")
    assert teng.config.compute_unit == "mxu"
    assert dataclasses.asdict(teng.config) == dataclasses.asdict(jeng.config)
    jst, tst = jeng.init(seed=4), teng.init(seed=4)
    np.testing.assert_array_equal(state_bits(tst.x),
                                  state_bits(jst.x.astype(jnp.float32)))
    for n in (1000, 1048):
        jw, jst = jeng.next_words(jst, n)
        tw, tst = teng.next_words(tst, n)
        np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(state_bits(tst.x),
                                  state_bits(jst.x.astype(jnp.float32)))
    relu = ChaoticPRNG(p, n_streams=128, dtype=torch.bfloat16, device="cpu")
    relu_w, _ = relu.next_words(relu.init(seed=4), 1000)
    assert not np.array_equal(relu_w, tw[:1000])


@pytest.fixture()
def on_path(tmp_path):
    sys.path.insert(0, str(tmp_path))
    yield tmp_path
    sys.path.remove(str(tmp_path))
    # forget only the generated packages: a prefix match on "ml_" also
    # evicted ml_dtypes, whose re-import registers a second bfloat16 that
    # JAX rejects in every later test of the process
    for name in [m for m, mod in sys.modules.items()
                 if str(getattr(mod, "__file__", None) or "").startswith(
                     str(tmp_path))]:
        del sys.modules[name]


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_min_latency_lattice_core_against_jax_core(on_path, tanh_net,
                                                   activation):
    """``select(24, 64, "min_latency", n_nodes=8)`` is the JAX
    ``Candidate`` (mxu, bf16, p 5), and ``select(96, 256, ...,
    n_nodes=32)`` likewise; a chen_ring8 core of the trained net
    generated on it by each package: the same solution, and the port
    core's trajectory and words (plain mxu on the CPU) equal the JAX
    core's (Pallas in interpret mode), bitwise."""
    cand = dse.select(24, 64, "min_latency", n_nodes=8)
    jcand = jax_dse.select(24, 64, "min_latency", n_nodes=8)
    assert dataclasses.asdict(cand) == dataclasses.asdict(jcand)
    assert (cand.compute_unit, cand.dtype_bytes, cand.p) == ("mxu", 2, 5)
    assert dataclasses.asdict(dse.select(96, 256, "min_latency",
                                         n_nodes=32)) == \
        dataclasses.asdict(jax_dse.select(96, 256, "min_latency",
                                          n_nodes=32))
    params = expand_lattice_params(tanh_net, n_nodes=8,
                                   coupling=DEFAULT_LATTICE_COUPLING)
    name = f"ml_{activation}"
    jax_codegen.generate_core(f"{name}_jax", on_path, params=params,
                              candidate=jcand, system="chen@ring8",
                              activation=activation)
    pkg = codegen.generate_core(name, on_path, params=params, candidate=cand,
                                system="chen@ring8", activation=activation)
    sol = json.loads((pkg / "solution.json").read_text())
    assert sol == {"candidate": dataclasses.asdict(cand),
                   "system": "chen@ring8", "activation": activation}
    jcore = importlib.import_module(f"{name}_jax")
    tcore = importlib.import_module(name)
    assert (tcore.COMPUTE_UNIT, tcore.DTYPE, tcore.S_BLOCK) == (
        "mxu", torch.bfloat16, jcore.S_BLOCK)
    # the core's own lane block is 4,096 lanes; a 128-lane slice of it
    # changes no value (lanes are independent) and keeps the plain chains
    # short
    x0 = np.random.default_rng(77).uniform(
        -0.5, 0.5, (S_BLOCK, 24)).astype(np.float32)
    jt = np.asarray(jcore.generate(x0, 8).astype(jnp.float32))
    jw, js = jcore.generate_bits(x0, 16, 7)
    tt = tcore.generate(x0, 8, device="cpu")
    tw, ts = tcore.generate_bits(x0, 16, 7, device="cpu")
    np.testing.assert_array_equal(state_bits(tt), state_bits(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(state_bits(ts),
                                  state_bits(js.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# A farm of no-config ring8 relu, tanh and sigmoid cores against the JAX farm
# ---------------------------------------------------------------------------

# (core, registry lattice, activation): two cores an activation
FARM_CORES = (("chen_relu", "chen@ring8", "relu"),
              ("lorenz_relu", "lorenz@ring8", "relu"),
              ("chen_tanh", "chen@ring8", "tanh"),
              ("rossler_tanh", "rossler@ring8", "tanh"),
              ("chua_sigmoid", "chua@ring8", "sigmoid"),
              ("lorenz_sigmoid", "lorenz@ring8", "sigmoid"))


def _farm(farm_cls, dtype, jax_side=False, **farm_kw):
    kw = dict(backend="pallas_interpret") if jax_side else {}
    farm = farm_cls(**farm_kw)
    for name, system, act in FARM_CORES:
        farm.add_core(name, default_params(system=system), dtype=dtype,
                      activation=act, lanes_per_client=32, burn_in=2, **kw)
        farm.register(name, "a", seed=1)
        farm.register(name, "b", seed=2)
    return farm


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


def test_no_config_ring8_farm_bitwise_vs_jax_farm():
    """bf16 ring8 lattice cores of relu, tanh and sigmoid nets added with
    no config: both farms resolve the mxu unit, one gang group an
    activation; uniform, skewed and unequal-pool flushes deliver the JAX
    farm's words bit for bit, with the same gang launches."""
    jfarm = _farm(JaxFarm, jnp.bfloat16, jax_side=True)
    tfarm = _farm(OscillatorFarm, torch.bfloat16, device="cpu")
    for core in tfarm.cores:
        tc, jc = tfarm.services[core].config, jfarm.services[core].config
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.compute_unit == "mxu"
    groups = {}
    for c in tfarm.cores:
        groups.setdefault(_compat_key(tfarm.services[c]), []).append(c)
    assert sorted(sorted(g) for g in groups.values()) == [
        ["chen_relu", "lorenz_relu"], ["chen_tanh", "rossler_tanh"],
        ["chua_sigmoid", "lorenz_sigmoid"]]
    uniform = {c: [("a", 512), ("b", 512)] for c, _, _ in FARM_CORES}
    skewed = dict(uniform, chen_tanh=[("a", 2048)],
                  rossler_tanh=[("a", 64), ("b", 100)])
    unequal = dict(uniform, chua_sigmoid=[("a", 512), ("b", 512),
                                          ("c", 512)])
    for i, round_ in enumerate((uniform, skewed, unequal)):
        if i == 2:
            for f in (jfarm, tfarm):
                f.register("chua_sigmoid", "c", seed=3)
        g0 = tfarm.gang_launches
        _assert_same(_serve(tfarm, round_), _serve(jfarm, round_))
        if i == 0:
            assert tfarm.gang_launches - g0 == 3
    assert tfarm.gang_launches == jfarm.gang_launches
    for f in (tfarm, jfarm):
        assert {p["mode"] for p in f._sched._plans.values()} == {"concat"}
