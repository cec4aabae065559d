"""The port's lattice streams (K5's vpu form inside K1 and K2) against the
JAX package, on the same numpy-seeded inputs (CPU).

Held to what the Pallas kernels emit in interpret mode, never to the JAX
``ref`` backend (its claim of f32 equality with the kernel fails on this
jax, ROADMAP.md queue 3).  Tiers:

* bf16: every op rounds to bf16 on both sides in the same order, so the
  plain lattice K1/K2 and the whole bf16 ``PRNGService`` match *bitwise*;
* f32: XLA's CPU code differs from PyTorch's eager ops in the low bits, so
  a 64-step free run is held to ``1e-4 * max(1, max|x|)``.

The registry arrays (block-diagonal weights, coupling, meta) are bitwise.
Inside the port: chunk invariance, snapshot/restore and fork non-overlap at
lattice width, as ``tests/test_lattice.py`` has them for the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ann as jax_ann
from repro.core import chaotic as jax_chaotic
from repro.core.dse import Candidate as JaxCandidate
from repro.kernels.chaotic_ann import (_lattice_delta, chaotic_ann_bits_pallas,
                                       chaotic_ann_pallas)
from repro.prng.stream import trained_oscillator as jax_trained_oscillator
from repro.serve.prng_service import PRNGService as JaxService
from repro_torch.core import chaotic
from repro_torch.core.ann import (Oscillator, check_block_diagonal,
                                  expand_lattice_params, lattice_meta_tuple,
                                  params_from_numpy, params_to_numpy)
from repro_torch.core.dse import Candidate, default_config
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import (ChaoticPRNG, default_params,
                                     trained_oscillator)
from repro_torch.serve.prng_service import PRNGService

KEYS = ("w1", "b1", "w2", "b2")
# the Pallas schedule of the comparisons: small blocks keep interpret mode
# cheap, and change no value
T_BLOCK, UNROLL, STEPS = 8, 2, 64


def f32_free_run(max_abs):
    """64 free-running f32 steps: the per-step low-bit gaps between XLA
    and PyTorch grow with the map's expansion, bounded over this run."""
    return 1e-4 * max(1.0, max_abs)


def seeds(rng, n_lanes, i_dim):
    return rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)


def bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def lattice_of(system):
    p = default_params(system=system)
    return p, lattice_meta_tuple(p["lattice_meta"])


def config(system, dtype_bytes):
    """An explicit vpu config of the lattice, in each package's record."""
    _, topo, n = chaotic.parse_lattice_name(system)
    kw = dict(i_dim=3 * n, h_dim=8 * n, p=0, compute_unit="vpu",
              dtype_bytes=dtype_bytes, t_block=T_BLOCK, unroll=UNROLL,
              n_nodes=n)
    return JaxCandidate(**kw), Candidate(**kw)


# ---------------------------------------------------------------------------
# numpy level: names, coupling, expansion, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["chen@ring8", "chen@grid9", "lorenz@ring32",
                                  "hyperlorenz@grid4"])
def test_parse_lattice_name_matches_jax(name):
    assert chaotic.parse_lattice_name(name) == jax_chaotic.parse_lattice_name(name)


@pytest.mark.parametrize("name", ["chen@torus8", "chen@ring", "chen@8"])
def test_parse_lattice_name_refuses_what_jax_refuses(name):
    with pytest.raises(KeyError):
        jax_chaotic.parse_lattice_name(name)
    with pytest.raises(KeyError, match="ring\\|grid"):
        chaotic.parse_lattice_name(name)


@pytest.mark.parametrize("n_nodes,base_dim,strength,topology", [
    (8, 3, 0.05, "ring"), (8, 3, 0.05, "grid"), (32, 3, 0.05, "grid"),
    (6, 4, 0.07, "grid"), (2, 3, 0.3, "ring"), (7, 2, 0.01, "grid")])
def test_coupling_matrix_bitwise(n_nodes, base_dim, strength, topology):
    got = chaotic.lattice_coupling_matrix(n_nodes, base_dim, strength,
                                          topology)
    want = jax_chaotic.lattice_coupling_matrix(n_nodes, base_dim, strength,
                                               topology)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert chaotic._grid_shape(n_nodes) == jax_chaotic._grid_shape(n_nodes)


@pytest.mark.parametrize("n_nodes,topology", [(8, "ring"), (8, "grid"),
                                              (16, "grid"), (32, "ring")])
def test_expand_lattice_params_bitwise(n_nodes, topology):
    rng = np.random.default_rng(n_nodes)
    base = {"w1": rng.normal(size=(3, 8)), "b1": rng.normal(size=8),
            "w2": rng.normal(size=(8, 3)), "b2": rng.normal(size=3)}
    base = {k: v.astype(np.float32) for k, v in base.items()}
    got = expand_lattice_params(base, n_nodes=n_nodes, coupling=0.05,
                                topology=topology)
    want = jax_ann.expand_lattice_params(base, n_nodes=n_nodes,
                                         coupling=0.05, topology=topology)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert (lattice_meta_tuple(got["lattice_meta"])
            == jax_ann.lattice_meta_tuple(want["lattice_meta"]))


def test_expand_lattice_params_refuses_what_jax_refuses():
    base = {k: np.zeros(s, np.float32) for k, s in
            (("w1", (3, 8)), ("b1", (8,)), ("w2", (8, 3)), ("b2", (3,)))}
    for n in (1, 5):
        with pytest.raises(ValueError):
            jax_ann.expand_lattice_params(base, n_nodes=n, coupling=0.05)
        with pytest.raises(ValueError):
            expand_lattice_params(base, n_nodes=n, coupling=0.05)


@pytest.mark.parametrize("system", ["chen@ring8", "chen@grid8", "chen@ring32"])
def test_registry_bundle_bitwise_vs_jax(system):
    """The derived bundle: block-diagonal weights, coupling, meta and the
    tiled normalizer, bitwise; ``default_params`` carries the lattice."""
    got, want = trained_oscillator(system), jax_trained_oscillator(system)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert set(default_params(system=system)) == set(KEYS) | {
        "coupling", "lattice_meta"}


def test_params_round_trip_keeps_the_descriptor():
    p = default_params(system="chen@grid8")
    t = params_from_numpy(p, device="cpu", dtype=torch.bfloat16)
    assert t["lattice_meta"].dtype == np.float32
    assert (lattice_meta_tuple(t["lattice_meta"])
            == (8, 3, "grid", float(np.float32(0.05))))
    assert t["coupling"].dtype == torch.bfloat16
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["lattice_meta"], p["lattice_meta"])
    np.testing.assert_array_equal(
        params_from_numpy(t, device="cpu")["lattice_meta"], p["lattice_meta"])


# ---------------------------------------------------------------------------
# The coupling term alone: plain lattice_delta == JAX _lattice_delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lattice", [
    (8, 3, "ring", 0.05), (8, 3, "grid", 0.05), (32, 3, "grid", 0.05),
    (2, 3, "ring", 0.3), (6, 4, "grid", 0.07), (7, 2, "grid", 0.01)],
    ids=lambda l: f"{l[2]}{l[0]}x{l[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lattice_delta_bitwise_vs_jax(lattice, dtype):
    """Every topology, including a ring of 2 (one neighbour added twice)
    and a 1 x 7 torus (a ring of 1 adds x itself twice), op for op."""
    n_nodes, base_dim = lattice[:2]
    x = seeds(np.random.default_rng(5), 40, n_nodes * base_dim) * 3
    got = ref.lattice_delta(torch.from_numpy(x).to(getattr(torch, dtype)),
                            lattice)
    want = _lattice_delta(jnp.asarray(x.T).astype(getattr(jnp, dtype)),
                          lattice).T
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Plain lattice K1/K2 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _pallas_traj(p, lattice, x0, dtype, n_steps=STEPS):
    return chaotic_ann_pallas(
        *[jnp.asarray(p[k]) for k in KEYS], jnp.asarray(x0).astype(dtype),
        n_steps=n_steps, s_block=128, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice, interpret=True)


def _pallas_bits(p, lattice, x0, off, dtype):
    return chaotic_ann_bits_pallas(
        *[jnp.asarray(p[k]) for k in KEYS], jnp.asarray(x0).astype(dtype),
        jnp.asarray(off), n_steps=STEPS, s_block=128, t_block=T_BLOCK,
        unroll=UNROLL, lattice=lattice, interpret=True)


def _torch_w(p):
    return [torch.from_numpy(np.array(p[k])) for k in KEYS]


@pytest.mark.parametrize("system", ["chen@ring8", "chen@grid8"])
def test_plain_lattice_bf16_bitwise_vs_pallas(system):
    """bf16: trajectory, words and final state, bitwise, 64 steps, with
    per-lane word offsets that wrap past 2**32."""
    p, lattice = lattice_of(system)
    rng = np.random.default_rng(31)
    x0 = seeds(rng, 130, p["w1"].shape[0])
    off = rng.integers(0, 1 << 32, 130, dtype=np.uint64).astype(np.uint32)
    off[:3] = [0xFFFFFFFF, 0xFFFFFFF0, 0]
    xt = torch.from_numpy(x0).to(torch.bfloat16)
    traj = chaotic_ann.chaotic_ann_traj(*_torch_w(p), xt, n_steps=STEPS,
                                        lattice=lattice)
    np.testing.assert_array_equal(bf16_bits(traj),
                                  bf16_bits(_pallas_traj(p, lattice, x0,
                                                         jnp.bfloat16)))
    words, state = chaotic_ann.chaotic_ann_bits(
        *_torch_w(p), xt, torch.from_numpy(off), n_steps=STEPS,
        lattice=lattice)
    jw, js = _pallas_bits(p, lattice, x0, off, jnp.bfloat16)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(bf16_bits(state), bf16_bits(js))


@pytest.mark.parametrize("system", ["chen@ring8", "chen@grid8"])
def test_plain_lattice_f32_within_tolerance_of_pallas(system):
    p, lattice = lattice_of(system)
    x0 = seeds(np.random.default_rng(32), 128, p["w1"].shape[0])
    want = np.asarray(_pallas_traj(p, lattice, x0, jnp.float32))
    got = chaotic_ann.chaotic_ann_traj(*_torch_w(p), torch.from_numpy(x0),
                                       n_steps=STEPS, lattice=lattice).numpy()
    max_abs = float(np.abs(want).max())
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= f32_free_run(max_abs)
    # the first step from the same input agrees more tightly
    assert np.abs(got[0] - want[0]).max() <= 8 * np.finfo(np.float32).eps * max(
        1.0, float(np.abs(want[0]).max()))


def test_plain_ring32_bf16_bitwise_vs_pallas():
    """chen@ring32 (I=96, H=256), bf16 trajectory, 16 steps."""
    p, lattice = lattice_of("chen@ring32")
    x0 = seeds(np.random.default_rng(33), 128, 96)
    traj = chaotic_ann.chaotic_ann_traj(
        *_torch_w(p), torch.from_numpy(x0).to(torch.bfloat16), n_steps=16,
        lattice=lattice)
    want = _pallas_traj(p, lattice, x0, jnp.bfloat16, n_steps=16)
    np.testing.assert_array_equal(bf16_bits(traj), bf16_bits(want))


def test_coupling_is_applied_and_topology_matters():
    """The lattice step is not the uncoupled block-diagonal step, and a
    ring and a torus of the same nodes emit different words."""
    ring, lat_r = lattice_of("chen@ring8")
    _, lat_g = lattice_of("chen@grid8")
    w, x0 = _torch_w(ring), torch.from_numpy(seeds(np.random.default_rng(34),
                                                   16, 24))
    coupled = chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=16,
                                           lattice=lat_r)[0]
    grid = chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=16, lattice=lat_g)[0]
    bare = chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=16)[0]
    assert not torch.equal(ops.from_uint32(coupled), ops.from_uint32(bare))
    assert not torch.equal(ops.from_uint32(coupled), ops.from_uint32(grid))


def test_ops_and_module_route_lattices():
    p = params_from_numpy(default_params(system="chen@grid8"), device="cpu")
    x0 = torch.from_numpy(seeds(np.random.default_rng(35), 12, 24))
    words, state = ops.chaotic_bits(p, x0, 8, 5)
    want_w, want_s = ref.chaotic_ann_bits_ref(
        *[p[k] for k in KEYS], x0, 8, 5,
        lattice=lattice_meta_tuple(p["lattice_meta"]))
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(want_w))
    assert torch.equal(state, want_s)
    traj = ops.chaotic_trajectory(p, x0, 8, backend="ref")
    assert torch.equal(traj[-1], state)
    assert torch.equal(Oscillator(p)(x0), traj[0])


def test_unported_lattice_forms_raise():
    """A vpu lattice gang with tanh equals per-core lattice K1 with tanh,
    and an mxu lattice with tanh names its ROADMAP.md item; an mxu lattice
    is routed with its coupling operand and refused without
    it, in a lattice gang too (K3's mxu form, its shared operand taken from
    the params), and the stacked gang refuses the mxu unit as JAX does; the
    plain dense loop refuses a descriptor that does not fit."""
    p = params_from_numpy(default_params(system="chen@ring8"), device="cpu")
    x0 = torch.from_numpy(seeds(np.random.default_rng(36), 8, 24))
    words, state = ops.chaotic_bits(p, x0, 4, compute_unit="mxu")
    want_w, want_s = ref.chaotic_ann_bits_ref(
        *[p[k] for k in KEYS], x0, 4, lattice=lattice_meta_tuple(
            p["lattice_meta"]), compute_unit="mxu", coupling=p["coupling"])
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(want_w))
    assert torch.equal(state, want_s)
    assert torch.equal(ops.chaotic_trajectory(p, x0, 4, config=Candidate(
        i_dim=24, h_dim=64, compute_unit="mxu", n_nodes=8))[-1], state)
    with pytest.raises(ValueError, match="coupling"):
        ops.chaotic_bits({k: v for k, v in p.items() if k != "coupling"},
                         x0, 4, compute_unit="mxu")
    x0 = torch.zeros(256, 24)
    gang = {k: p[k][None] for k in KEYS}
    gang["lattice_meta"] = p["lattice_meta"]
    with pytest.raises(ValueError, match="coupling"):
        ops.chaotic_bits_gang(gang, x0[:8], 4, core_map=[0], s_block=8,
                              compute_unit="mxu")
    gang["coupling"] = p["coupling"]
    g_words, g_state = ops.chaotic_bits_gang(gang, x0[:8], 4, core_map=[0],
                                             s_block=8, compute_unit="mxu")
    want_w, want_s = ops.chaotic_bits(p, x0[:8], 4, compute_unit="mxu")
    assert torch.equal(ops.from_uint32(g_words), ops.from_uint32(want_w))
    assert torch.equal(g_state, want_s)
    with pytest.raises(ValueError, match="compute_unit='vpu' only"):
        ops.chaotic_bits_gang_stacked(gang, x0[None], 4, compute_unit="mxu")
    # a vpu lattice gang takes tanh: each core's words and state are its
    # own lattice K1's with tanh (seeded states, so they differ from relu's)
    xs = torch.from_numpy(seeds(np.random.default_rng(37), 256, 24))
    want_w, want_s = ops.chaotic_bits(p, xs, 4, activation="tanh")
    relu_w, _ = ops.chaotic_bits(p, xs, 4)
    assert not torch.equal(ops.from_uint32(want_w), ops.from_uint32(relu_w))
    g_words, g_state = ops.chaotic_bits_gang(gang, xs, 4, core_map=[0],
                                             s_block=256, activation="tanh")
    assert torch.equal(ops.from_uint32(g_words), ops.from_uint32(want_w))
    assert torch.equal(g_state, want_s)
    g_words, g_state = ops.chaotic_bits_gang_stacked(gang, xs[None], 4,
                                                     activation="tanh")
    assert torch.equal(ops.from_uint32(g_words[:, 0]),
                       ops.from_uint32(want_w))
    assert torch.equal(g_state[0], want_s)
    # the mxu lattice form takes tanh too: the plain version's words and
    # state (the wrapper's own plain branch on the CPU), unlike relu's
    mxu_w, mxu_s = ops.chaotic_bits(p, xs, 4, activation="tanh",
                                    compute_unit="mxu")
    want_w, want_s = ops.chaotic_bits(p, xs, 4, activation="tanh",
                                      compute_unit="mxu", backend="ref")
    assert torch.equal(ops.from_uint32(mxu_w), ops.from_uint32(want_w))
    assert torch.equal(mxu_s, want_s)
    relu_w, _ = ops.chaotic_bits(p, xs, 4, compute_unit="mxu")
    assert not torch.equal(ops.from_uint32(mxu_w), ops.from_uint32(relu_w))
    with pytest.raises(ValueError, match="i_dim"):
        ref.chaotic_ann_ref(*[p[k] for k in KEYS], x0, 2,
                            lattice=(4, 3, "ring", 0.05))


def test_block_diagonal_check_refuses_off_block_weights():
    """The lattice kernels read only the diagonal node blocks, so lattice
    weights that are not block-diagonal are refused where they enter the
    port."""
    p, _ = lattice_of("chen@grid8")
    params_from_numpy(p, device="cpu")
    bad = dict(p, w2=p["w2"].copy())
    bad["w2"][8, 0] = 0.25           # node 1's hidden unit -> node 0's y
    with pytest.raises(ValueError, match="block-diagonal"):
        params_from_numpy(bad, device="cpu")
    bad = dict(p, w1=p["w1"].copy())
    bad["w1"][0, 8] = -1.0           # node 0's x -> node 1's hidden unit
    with pytest.raises(ValueError, match="block-diagonal"):
        PRNGService(bad, config=config("chen@grid8", 4)[1], device="cpu")
    with pytest.raises(ValueError, match="node blocks"):
        check_block_diagonal(torch.zeros(24, 64), torch.zeros(64, 24), 5)


# ---------------------------------------------------------------------------
# Streams and the service at lattice width
# ---------------------------------------------------------------------------

def test_bf16_lattice_service_bitwise_vs_jax():
    """The whole bf16 ``PRNGService`` on chen@ring8, 2 clients x 128
    lanes: register (burn-in), one flush, words and pool bitwise."""
    p = default_params(system="chen@ring8")
    jcfg, tcfg = config("chen@ring8", 2)
    jsvc = JaxService(p, lanes_per_client=128, backend="pallas_interpret",
                      dtype=jnp.bfloat16, config=jcfg)
    tsvc = PRNGService(p, lanes_per_client=128, dtype=torch.bfloat16,
                       config=tcfg, device="cpu")
    assert tsvc.dim == 24
    for svc in (jsvc, tsvc):
        svc.register("a", seed=1)
        svc.register("b", seed=2)
        svc.request("a", 1024)
        svc.request("b", 1000)
    jout, tout = jsvc.flush(), tsvc.flush()
    for name in ("a", "b"):
        np.testing.assert_array_equal(tout[name], np.asarray(jout[name]))
    np.testing.assert_array_equal(bf16_bits(tsvc.pool_x),
                                  bf16_bits(jsvc.pool_x))


def test_lattice_service_needs_an_explicit_config():
    """The vpu lattice stream needs an explicit config: given none, the
    port picks what the JAX package's ``select_config`` picks, and at
    chen@ring32 that is the mxu unit (tests/test_torch_mxu.py serves it)."""
    p = default_params(system="chen@ring32")
    for make in (PRNGService, ChaoticPRNG):
        cfg = make(p, device="cpu").config
        assert (cfg.compute_unit, cfg.n_nodes) == ("mxu", 32)
    svc = PRNGService(p, device="cpu", config=default_config(
        96, 256, torch.float32, n_nodes=32))
    assert (svc.dim, svc.config.compute_unit, svc.config.n_nodes,
            svc.config.i_dim, svc.config.h_dim) == (96, "vpu", 32, 96, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lattice_stream_chunk_invariant(dtype):
    eng = ChaoticPRNG(default_params(system="chen@grid8"), n_streams=32,
                      burn_in=4, dtype=dtype, device="cpu",
                      config=config("chen@grid8", dtype.itemsize)[1])
    whole, _ = eng.next_words(eng.init(seed=3), 640)
    state, parts = eng.init(seed=3), []
    for n in (1, 63, 200, 376):
        w, state = eng.next_words(state, n)
        parts.append(w)
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_lattice_fork_children_non_overlapping():
    """Mirrors tests/test_lattice.py: forked children differ from each
    other position by position, and forking consumes nothing."""
    eng = ChaoticPRNG(default_params(system="chen@ring8"), n_streams=128,
                      burn_in=16, device="cpu",
                      config=config("chen@ring8", 4)[1])
    root = eng.init(seed=1)
    words = [eng.next_words(k, 2048)[0] for k in eng.fork(root, 3)]
    for a in range(3):
        for b in range(a + 1, 3):
            assert np.mean(words[a] == words[b]) < 0.01
    np.testing.assert_array_equal(eng.next_words(root, 256)[0],
                                  eng.next_words(eng.init(seed=1), 256)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lattice_snapshot_restore_continues(dtype):
    p = default_params(system="chen@ring8")
    _, tcfg = config("chen@ring8", dtype.itemsize)

    def service():
        return PRNGService(p, lanes_per_client=32, burn_in=4, dtype=dtype,
                           config=tcfg, device="cpu")

    svc = service()
    for i in range(3):
        svc.register(f"c{i}", seed=50 + i)
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
    assert again.pool_x.shape == (3 * 32, 24)
