"""The port's mxu unit (K1 and K2 in the dot form, with K5's coupling dot
for a lattice) and the copied ``select_config`` against the JAX package,
on the same numpy-seeded inputs (CPU).

The mxu dot of ``repro/kernels/chaotic_ann.py::_make_step`` is, on this
jax, a forward chain of f32 fused multiply-adds.  The port's plain version
(``ref.mxu_dot`` over ``ref.fma_f32``) computes that chain, so the plain
mxu K1/K2 equal the Pallas kernels in interpret mode *bitwise* in f32 and
bf16 (a stronger tier than the vpu unit's f32 tolerance).  The JAX
package's default stream of a lattice core is the mxu unit at
chen@ring32, so a ``PRNGService`` given no config serves the JAX
service's words bitwise.  Inside the port: chunk invariance,
snapshot/restore, and vpu and mxu streams that differ.
"""
import dataclasses
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dse as jax_dse
from repro.core.dse import Candidate as JaxCandidate
from repro.kernels.chaotic_ann import chaotic_ann_bits_pallas, chaotic_ann_pallas
from repro.serve.prng_service import PRNGService as JaxService
from repro_torch.core import dse
from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
from repro_torch.core.dse import Candidate
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import ChaoticPRNG, default_params
from repro_torch.serve.prng_service import PRNGService

KEYS = ("w1", "b1", "w2", "b2")
STEPS = 32
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain f32 FMA chains are thousands of small
    tensor ops, which more threads only slow down when several test
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def state_bits(a):
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return f32_bits(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# fma_f32: one rounding, checked against exact rational arithmetic
# ---------------------------------------------------------------------------

def round_f32(exact: Fraction) -> np.float32:
    """The float32 nearest ``exact``, ties to even (exact, not via f64)."""
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]

    def key(c):
        return (abs(Fraction(float(c)) - exact),
                int(np.asarray(c, np.float32).view(np.int32)) & 1)

    return min(cands, key=key)


def fma_exact(a, b, c) -> np.float32:
    return round_f32(Fraction(float(a)) * Fraction(float(b))
                     + Fraction(float(c)))


def test_fma_f32_rounds_a_false_tie_correctly():
    """acc = x = 1 + 2^-23, w = 2^-24 (1 - 2^-23): the exact sum lies just
    below the float32 midpoint 1 + 2^-23 + 2^-24, which is where its f64
    rounding lands; rounding that again would give 1 + 2^-22."""
    x = np.float32(1 + 2.0 ** -23)
    w = np.float32(2.0 ** -24 * (1 - 2.0 ** -23))
    got = ref.fma_f32(torch.tensor([x]), torch.tensor([w]),
                      torch.tensor([x]))
    assert got.item() == float(x) == float(fma_exact(x, w, x))
    twice = (torch.tensor([x]).double() * float(w) + float(x)).float()
    assert twice.item() == 1 + 2.0 ** -22           # the double rounding


def test_fma_f32_matches_exact_arithmetic():
    """Random triples over many scales, and a family built on float32
    midpoints (both sides, both signs), against ``Fraction``."""
    rng = np.random.default_rng(0)
    n = 3000
    scale = np.float32(2.0) ** rng.integers(-30, 30, (3, n)).astype(np.float32)
    a, b, c = (rng.uniform(-1, 1, (3, n)).astype(np.float32) * scale)
    base = (1 + rng.integers(0, 1 << 23, 1000) * 2.0 ** -23).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], 1000).astype(np.float32)
    tiny = (2.0 ** -24 * (1 + rng.choice([-1.0, 1.0], 1000) * 2.0 ** -23)
            ).astype(np.float32)
    expo = np.float32(2.0) ** rng.integers(-20, 20, 1000).astype(np.float32)
    a = np.concatenate([a, base * sign * expo])
    b = np.concatenate([b, tiny])
    c = np.concatenate([c, base * sign * expo])
    got = ref.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([fma_exact(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(f32_bits(got), f32_bits(want))


# ---------------------------------------------------------------------------
# Plain mxu K1/K2 against the Pallas kernels (interpret mode), bitwise
# ---------------------------------------------------------------------------

def _operands(system):
    p = default_params(system=system)
    lattice = (lattice_meta_tuple(p["lattice_meta"]) if "lattice_meta" in p
               else None)
    return p, lattice, p.get("coupling")


@pytest.mark.parametrize("system", ["chen", "hyperlorenz", "chen@ring8",
                                    "chen@grid8", "chen@ring32"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_plain_mxu_bitwise_vs_pallas(system, dtypes):
    """K2 (trajectory) and K1 (words, final state) at 256 lanes x 32
    steps, with offsets that wrap past 2^32; K1 on two Pallas stream
    blocks (the blocks change no word)."""
    tdt, jdt = dtypes
    p, lattice, cpl = _operands(system)
    rng = np.random.default_rng(40)
    n_lanes, i_dim = 256, p["w1"].shape[0]
    x0 = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off[:4] = [0xFFFFFFFF, 0xFFFFFFF8, 0xFFFFFFF0, 0]
    jw = [jnp.asarray(p[k]) for k in KEYS]
    jx0 = jnp.asarray(x0).astype(jdt)
    jcpl = None if cpl is None else jnp.asarray(cpl)
    traj_j = chaotic_ann_pallas(*jw, jx0, jcpl, n_steps=STEPS, s_block=256,
                                t_block=8, unroll=2, compute_unit="mxu",
                                lattice=lattice, interpret=True)
    traj = ref.chaotic_ann_ref(
        *[torch.from_numpy(p[k]) for k in KEYS],
        torch.from_numpy(x0).to(tdt), STEPS, lattice=lattice,
        compute_unit="mxu",
        coupling=None if cpl is None else torch.from_numpy(cpl))
    np.testing.assert_array_equal(state_bits(traj),
                                  state_bits(traj_j.astype(jnp.float32)))
    words = ops.from_uint32(ops.pack_words(traj, torch.from_numpy(off)))
    for s_block in (128, 256):
        words_j, state_j = chaotic_ann_bits_pallas(
            *jw, jx0, jnp.asarray(off.astype(np.uint32)), jcpl,
            n_steps=STEPS, s_block=s_block, t_block=8, unroll=2,
            compute_unit="mxu", lattice=lattice, interpret=True)
        np.testing.assert_array_equal(words.numpy(),
                                      np.asarray(words_j).astype(np.int64))
        np.testing.assert_array_equal(state_bits(traj[-1]),
                                      state_bits(state_j.astype(jnp.float32)))


def test_mxu_and_vpu_are_different_streams():
    """The units' expression trees differ, so their words do (the port
    keys streams on ``compute_unit`` as the JAX package does)."""
    p, lattice, cpl = _operands("chen@ring8")
    w = [torch.from_numpy(p[k]) for k in KEYS]
    x0 = torch.from_numpy(np.random.default_rng(41).uniform(
        -0.9, 0.9, (64, 24)).astype(np.float32))
    vpu, _ = ref.chaotic_ann_bits_ref(*w, x0, 16, lattice=lattice)
    mxu, _ = ref.chaotic_ann_bits_ref(*w, x0, 16, lattice=lattice,
                                      compute_unit="mxu",
                                      coupling=torch.from_numpy(cpl))
    assert np.mean(ops.from_uint32(vpu).numpy()
                   == ops.from_uint32(mxu).numpy()) < 0.01


def test_mxu_wrappers_on_cpu_take_the_plain_version_without_counting():
    p, lattice, cpl = _operands("chen@grid8")
    w = [torch.from_numpy(p[k]) for k in KEYS]
    x0 = torch.from_numpy(np.random.default_rng(42).uniform(
        -0.9, 0.9, (8, 24)).astype(np.float32))
    kw = dict(lattice=lattice, compute_unit="mxu",
              coupling=torch.from_numpy(cpl))
    before = (chaotic_ann.chaotic_ann_mxu_bits.launches,
              chaotic_ann.chaotic_ann_mxu_traj.launches)
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, 7, n_steps=4, **kw)
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=4, **kw)
    assert torch.equal(ops.from_uint32(words),
                       ops.from_uint32(ops.pack_words(traj, 7)))
    assert torch.equal(state, traj[-1])
    assert torch.equal(traj, ref.chaotic_ann_ref(*w, x0, 4, **kw))
    assert (chaotic_ann.chaotic_ann_mxu_bits.launches,
            chaotic_ann.chaotic_ann_mxu_traj.launches) == before
    with pytest.raises(ValueError, match="coupling"):
        chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=4, lattice=lattice,
                                     compute_unit="mxu")
    tanh = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=4,
                                        activation="tanh", **kw)
    assert torch.equal(tanh, ref.chaotic_ann_ref(*w, x0, 4, "tanh", **kw))
    assert not torch.equal(tanh, traj)
    assert (chaotic_ann.chaotic_ann_mxu_bits.launches,
            chaotic_ann.chaotic_ann_mxu_traj.launches) == before
    with pytest.raises(ValueError, match="compute_unit"):
        chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=4, compute_unit="tpu")


def test_coupling_support_check_refuses_other_operands():
    """The mxu lattice kernels read the coupling at its ring/torus support
    only, so an operand nonzero elsewhere is refused where it enters."""
    p, _, _ = _operands("chen@grid8")
    params_from_numpy(p, device="cpu")
    bad = dict(p, coupling=p["coupling"].copy())
    bad["coupling"][0, 1] = 0.05         # component 0 <- component 1
    with pytest.raises(ValueError, match="support"):
        params_from_numpy(bad, device="cpu")
    bad = dict(p, coupling=p["coupling"].copy())
    bad["coupling"][3, 9] = 0.05         # node 1 <- node 3: not a neighbour
    with pytest.raises(ValueError, match="support"):
        PRNGService(bad, device="cpu")


# ---------------------------------------------------------------------------
# select_config: the JAX package's choice, copied
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(3, 8, 1), (4, 16, 1), (24, 64, 8),
                                  (96, 256, 32), (6, 16, 2)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_select_config_equals_jax(dims, dtypes):
    i_dim, h_dim, n_nodes = dims
    tdt, jdt = dtypes
    for s_total in (None, 128, 65_536):
        want = jax_dse.select_config(i_dim, h_dim, s_total=s_total,
                                     dtype=jdt, n_nodes=n_nodes)
        got = dse.select_config(i_dim, h_dim, s_total=s_total, dtype=tdt,
                                n_nodes=n_nodes)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert (dse.select_config(96, 256, s_total=65_536, dtype=torch.float32,
                              n_nodes=32).compute_unit == "mxu")


def test_resolve_config_passes_each_callers_streams():
    """The engine searches at its ``n_streams``, the service at its
    ``lanes_per_client``, as the JAX callers do."""
    p = default_params(system="chen@ring32")
    eng = ChaoticPRNG(p, n_streams=65_536, device="cpu")
    svc = PRNGService(p, lanes_per_client=128, device="cpu")
    assert (eng.config.compute_unit, eng.config.p, eng.config.t_block) == (
        "mxu", 4, 32)
    assert (svc.config.compute_unit, svc.config.p, svc.config.t_block) == (
        "mxu", 0, 256)
    chen = PRNGService(default_params(), device="cpu").config
    assert dataclasses.astuple(chen) == dataclasses.astuple(
        dse.default_config(3, 8, torch.float32))
    assert (chen.compute_unit, chen.p, chen.unroll, chen.t_block) == (
        "vpu", 0, 8, 256)


# ---------------------------------------------------------------------------
# The served stream: JAX's default lattice stream, and mxu in the port
# ---------------------------------------------------------------------------

def _serve_twice(svc, demands):
    out = []
    for name, seed in (("a", 11), ("b", 12)):
        svc.register(name, seed=seed)
    for flush in demands:
        for name, n in flush.items():
            svc.request(name, n)
        out.append(svc.flush())
    return out


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_no_config_lattice_service_bitwise_vs_jax(dtypes):
    """chen@ring32 with no config: both packages pick mxu (p=0, t_block
    256 at 128 lanes) and serve the same words, two clients, two flushes,
    and the same pool."""
    tdt, jdt = dtypes
    p = default_params(system="chen@ring32")
    jsvc = JaxService(p, backend="pallas_interpret", dtype=jdt, burn_in=4)
    tsvc = PRNGService(p, dtype=tdt, device="cpu", burn_in=4)
    assert dataclasses.astuple(tsvc.config) == dataclasses.astuple(
        jsvc.config)
    assert tsvc.config.compute_unit == "mxu"
    demands = ({"a": 256, "b": 200}, {"a": 300, "b": 520})
    for jout, tout in zip(_serve_twice(jsvc, demands),
                          _serve_twice(tsvc, demands)):
        for name in ("a", "b"):
            np.testing.assert_array_equal(tout[name], np.asarray(jout[name]))
    np.testing.assert_array_equal(state_bits(tsvc.pool_x),
                                  state_bits(jsvc.pool_x.astype(jnp.float32)))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_explicit_mxu_config_scalar_service_bitwise_vs_jax(dtypes):
    tdt, jdt = dtypes
    kw = dict(i_dim=3, h_dim=8, p=0, compute_unit="mxu",
              dtype_bytes=tdt.itemsize, unroll=8, t_block=256)
    p = default_params()
    jsvc = JaxService(p, backend="pallas_interpret", dtype=jdt,
                      config=JaxCandidate(**kw))
    tsvc = PRNGService(p, dtype=tdt, device="cpu", config=Candidate(**kw))
    demands = ({"a": 4096, "b": 300}, {"a": 10, "b": 5000})
    for jout, tout in zip(_serve_twice(jsvc, demands),
                          _serve_twice(tsvc, demands)):
        for name in ("a", "b"):
            np.testing.assert_array_equal(tout[name], np.asarray(jout[name]))


def _mxu_config(dtype):
    return Candidate(i_dim=24, h_dim=64, p=0, compute_unit="mxu",
                     dtype_bytes=dtype.itemsize, unroll=2, t_block=8,
                     n_nodes=8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_stream_chunk_invariant(dtype):
    eng = ChaoticPRNG(default_params(system="chen@ring8"), n_streams=32,
                      burn_in=4, dtype=dtype, device="cpu",
                      config=_mxu_config(dtype))
    whole, _ = eng.next_words(eng.init(seed=3), 640)
    state, parts = eng.init(seed=3), []
    for n in (1, 63, 200, 376):
        w, state = eng.next_words(state, n)
        parts.append(w)
    np.testing.assert_array_equal(np.concatenate(parts), whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mxu_snapshot_restore_continues(dtype):
    p = default_params(system="chen@ring8")

    def service():
        return PRNGService(p, lanes_per_client=32, burn_in=4, dtype=dtype,
                           config=_mxu_config(dtype), device="cpu")

    svc = service()
    for i in range(3):
        svc.register(f"c{i}", seed=60 + i)
        svc.request(f"c{i}", 100 + 7 * i)
    svc.flush()
    snap = svc.snapshot()
    for i in range(3):
        svc.request(f"c{i}", 300)
    want = svc.flush()
    again = service()
    again.restore(snap)
    for i in range(3):
        again.request(f"c{i}", 300)
    got = again.flush()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_vpu_and_mxu_services_serve_different_streams():
    p = default_params(system="chen@ring8")
    out = {}
    for unit in ("vpu", "mxu"):
        cfg = dataclasses.replace(_mxu_config(torch.float32),
                                  compute_unit=unit)
        svc = PRNGService(p, lanes_per_client=32, burn_in=4, config=cfg,
                          device="cpu")
        svc.register("a", seed=1)
        out[unit] = svc.draw("a", 512)
    assert len(out["vpu"]) == len(out["mxu"]) == 512
    assert np.mean(out["vpu"] == out["mxu"]) < 0.01
