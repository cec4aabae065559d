"""Every shape the reference's kernels take (CPU): the shape libraries'
logic without ``nvcc``, the kernels' lane-slot layout at any node count up
to 32, and the port's plain scalar K1/K2 at the paper's other widths
against the JAX package's Pallas kernels in interpret mode.

* Shape libraries: distinct shapes get distinct library names and the
  default shapes the default library; ``prepare`` builds each missing
  library once, all in one parallel build; the CUDA source holds no shape
  list of its own.
* Lane slots: ``W = slot_width(N)`` threads a lattice lane, the CTA's
  lanes and every served ``s_block``; a numpy mirror of ``LanePair`` and
  ``TrajStore`` at N = 3-24 (idle threads past N): every lane computed
  once, every value stored once, 16-byte stores aligned.
* Refusals: a lattice of more than 1,024 nodes and one the reference
  refuses (``n_nodes * base_dim`` not a multiple of 8) raise
  ``ValueError`` on the card, the latter as the reference's kernels do;
  chen@ring40 reaches the build; on the CPU a service, a stream engine
  and a farm over chen@ring40 are built and serve.  (Lattices of more
  than 32 nodes: ``tests/test_torch_shapes_wide.py``.)
* Scalar parity at 3-4, 3-16 and 4-8 (seeded nets), relu and tanh: bf16
  vpu K1 words and final state and K2 trajectory bitwise; mxu K1 bitwise
  in f32 and bf16 (128 lanes, where XLA keeps the forward FMA chain); f32
  vpu K2 within ``8 * eps_f32 * max|x|`` for a step and
  ``1e-4 * max(1, max|x|)`` over 16 steps.
* The whole slice: a bf16 ``chen@grid24`` ``PRNGService`` with no config
  (the mxu unit, as ``select_config`` picks) against the JAX service.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chaotic_ann import chaotic_ann_bits_pallas, chaotic_ann_pallas
from repro.prng.stream import trained_oscillator as jax_trained_oscillator
from repro.serve.prng_service import PRNGService as JaxService
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.dse import LANES, default_config, enumerate_candidates
from repro_torch.kernels import build, chaotic_ann, ops, ref
from repro_torch.prng.stream import ChaoticPRNG, default_params
from repro_torch.serve.farm import OscillatorFarm
from repro_torch.serve.prng_service import PRNGService

KEYS = ("w1", "b1", "w2", "b2")
CTA = 128                                 # kThreads of chaotic_ann.cu
SCALAR = ((3, 4), (3, 16), (4, 8))        # the paper's sweep, a 4-D base
STEPS = 16
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain f32 FMA chains are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Shape libraries (no nvcc)
# ---------------------------------------------------------------------------

SHAPE_KEYS = [("scalar", (3, 4)), ("scalar", (3, 16)), ("scalar", (4, 8)),
              ("mxu", (3, 4, 1, 0)), ("mxu", (3, 8, 24, 1)),
              ("lattice", (3, 8, 24, 1)), ("lattice", (3, 8, 16, 0)),
              ("lattice", (4, 16, 4, 1)), ("lattice", (4, 16, 6, 0))]


def test_shape_libraries_are_named_by_their_shapes(tmp_path, monkeypatch):
    """One name per (family, shape), none the default library's, each
    carrying its shape; a changed source renames every library."""
    paths = [build.library_path(key=k) for k in SHAPE_KEYS]
    default = build.library_path()
    assert len(set(paths)) == len(paths) and default not in paths
    assert all(p.parent == build.BUILD_DIR for p in paths)
    assert paths[5].name.startswith("libchaotic_ann.lattice-3-8-24-1.")
    assert build.library_path(key=SHAPE_KEYS[0]) == paths[0]   # stable
    src = (build.CSRC / build.SOURCE).read_text()
    (tmp_path / build.SOURCE).write_text(src + "\n// changed\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path() != default
    assert build.library_path(key=SHAPE_KEYS[0]) != paths[0]


def test_the_python_table_is_the_only_shape_list():
    """The source defines no shape list; the default library's generated
    file defines DEFAULT_SHAPES and the hooks, a shape library's its one
    shape in its family's list, the other lists empty, no hooks, and it
    compiles only its family's entry groups."""
    src = (build.CSRC / build.SOURCE).read_text()
    for macro, _ in build.FAMILIES.values():
        assert f"#define {macro}" not in src
        assert f"{macro}(" in src
    shim = build._shim(build.SOURCE, None)
    assert "#define CHAOTIC_ANN_SHAPES(X) X(3, 8) X(4, 16)\n" in shim
    assert "X(3, 8, 32, 1)" in shim and "#define CHAOTIC_ANN_HOOKS 1" in shim
    shim = build._shim(build.SOURCE, ("lattice", (3, 8, 24, 1)))
    assert shim.splitlines()[1:] == [
        "#define CHAOTIC_ANN_SHAPES(X)",
        "#define LATTICE_SHAPES(X) X(3, 8, 24, 1)",
        "#define MXU_SHAPES(X)", "#define CHAOTIC_ANN_HOOKS 0",
        '#include "chaotic_ann.cu"']
    assert build._spec(("mxu", (3, 4, 1, 0)))[1] == (4, 5, 6)
    assert build._spec(None)[1] == tuple(range(build.PARTS))


def test_prepare_builds_each_missing_library_once(monkeypatch):
    """Default shapes need nothing; the others build in ONE call (their
    nvcc processes started together), each once per process; a launch's
    lookup takes the default library at a default shape and the shape
    library elsewhere, building it if nobody prepared it."""
    calls, loaded = [], []
    monkeypatch.setattr(build, "build_libraries",
                        lambda keys: calls.append(list(keys)) or {
                            k: (1.5, "") for k in keys})
    monkeypatch.setattr(chaotic_ann, "_load_shape_library",
                        lambda key: loaded.append(key) or ("lib", key))
    monkeypatch.setattr(chaotic_ann, "_SHAPE_LIBS", {})
    monkeypatch.setattr(chaotic_ann, "_lib", lambda: "default")
    got = ops.prepare([("scalar", (3, 8)), ("lattice", (3, 8, 24, "grid")),
                       ("scalar", (3, 4)), ("mxu", (3, 8, 8, 0))])
    assert got == {("lattice", (3, 8, 24, 1)): 1.5, ("scalar", (3, 4)): 1.5}
    assert calls == [[("lattice", (3, 8, 24, 1)), ("scalar", (3, 4))]]
    assert ops.prepare([("scalar", (3, 4))]) == {("scalar", (3, 4)): 0.0}
    assert len(calls) == 1
    assert chaotic_ann._library("scalar", (4, 16)) == "default"
    assert chaotic_ann._library("mxu", (3, 8, 32, 1)) == "default"
    assert chaotic_ann._library("scalar", (3, 4)) == ("lib", ("scalar", (3, 4)))
    assert chaotic_ann._library("mxu", (3, 16, 1, 0)) == (
        "lib", ("mxu", (3, 16, 1, 0)))
    assert calls[-1] == [("mxu", (3, 16, 1, 0))]
    assert ops.prepare([("scalar", (3, 5))], device="cpu") == {}
    assert len(loaded) == 3


def test_kernel_shapes_of_a_core():
    p = default_params(system="chen@grid24")
    assert ops.kernel_shapes(p) == [("lattice", (3, 8, 24, 1))]
    assert ops.kernel_shapes(p, "mxu") == [("mxu", (3, 8, 24, 1))]
    p = default_params(system="hyperlorenz@ring6")
    assert ops.kernel_shapes(p) == [("lattice", (4, 16, 6, 0))]
    w = {"w1": np.zeros((3, 16), np.float32)}
    assert ops.kernel_shapes(w) == [("scalar", (3, 16))]
    assert ops.kernel_shapes(w, "mxu") == [("mxu", (3, 16, 1, 0))]


# ---------------------------------------------------------------------------
# Lane slots of W = slot_width(N) threads
# ---------------------------------------------------------------------------

def test_slot_width_and_gang_granularity():
    """W is the next power of two >= N, so a slot lies in one warp; a CTA
    of 128 threads holds 128 / W lanes a thread-lane; every s_block a
    served config has (128 * 2^p) is a multiple of it at every N."""
    for n in range(1, 33):
        w = chaotic_ann.slot_width(n)
        assert w >= n and w & (w - 1) == 0 and (w == 1 or w // 2 < n)
        assert chaotic_ann.gang_lane_granularity(n) == CTA // w
    assert [chaotic_ann.slot_width(n) for n in (6, 16, 24, 32)] == [
        8, 16, 32, 32]
    s_blocks = {c.s_block for c in enumerate_candidates(72, 192, n_nodes=24)}
    assert s_blocks and all(s % LANES == 0 for s in s_blocks)
    for n in range(2, 33):
        assert all(s % chaotic_ann.gang_lane_granularity(n) == 0
                   for s in s_blocks)


def test_farm_plans_only_s_blocks_the_kernels_take():
    """A chen@grid24 lattice gang (two cores, a vpu config): the planner's
    one K4 launch and its K3 plan use the config's s_block, which the
    lattice K3 takes at N = 24 (a multiple of 128 / 32 lanes)."""
    p = default_params(system="chen@grid24")
    cfg = default_config(72, 192, torch.bfloat16, n_nodes=24)
    farm = OscillatorFarm(device="cpu")
    for core in ("a", "b"):
        farm.add_core(core, p, config=cfg, dtype=torch.bfloat16, burn_in=2)
    farm.register("a", "x")
    farm.register("b", "y")
    farm.request("a", "x", 128)
    farm.request("b", "y", 128)
    farm.flush()
    plans = list(farm._sched._plans.values())
    assert plans and all(
        plan["s_block"] % chaotic_ann.gang_lane_granularity(24) == 0
        for plan in plans)


def slot_lanes(n_lanes: int, n_nodes: int) -> dict:
    """Every thread of a two-lane lattice K1 launch, as ``LanePair<N>``
    and the launchers compute them: W-thread slots, node (an idle thread
    mirrors node N - 1), lane pair."""
    w = chaotic_ann.slot_width(n_nodes)
    slots = CTA // w
    grid = -(-n_lanes // (2 * slots))
    t = np.arange(grid * CTA)
    cta, tid = t // CTA, t % CTA
    pos = tid % w
    a = cta * 2 * slots + tid // w
    b = a + slots
    live_a, live_b = a < n_lanes, b < n_lanes
    a = np.where(live_a, a, n_lanes - 1)
    b = np.where(live_b, b, a)
    return dict(cta=cta, tid=tid, w=w, node=np.minimum(pos, n_nodes - 1),
                idle=pos >= n_nodes, lane_a=a, lane_b=b, live_a=live_a,
                live_b=live_b)


@pytest.mark.parametrize("n_nodes", [3, 6, 10, 16, 20, 24, 32])
@pytest.mark.parametrize("n_lanes", [1, 3, 37, 129])
def test_lane_slot_map(n_lanes, n_nodes):
    """Each lane computed by one slot, its words written by one thread
    (node 0 lane a's, node 1 lane b's, never an idle thread), every
    (lane, node) state component by one live thread; an idle thread runs
    node N - 1 of its own slot's lanes, and every shuffle source (a node
    < N) lies in the thread's slot and warp."""
    m = slot_lanes(n_lanes, n_nodes)
    node, idle, w = m["node"], m["idle"], m["w"]
    live = ~idle
    for h, writer in (("a", 0), ("b", 1)):
        keep = m[f"live_{h}"] & live & (node == writer)
        assert np.array_equal(np.sort(m[f"lane_{h}"][keep]),
                              np.sort(m[f"lane_{h}"][m[f"live_{h}"]
                                                     & (node == 0)]))
    computed = np.concatenate([m["lane_a"][m["live_a"] & (node == 0)],
                               m["lane_b"][m["live_b"] & (node == 0)]])
    assert np.array_equal(np.sort(computed), np.arange(n_lanes))
    comps = np.concatenate([m[f"lane_{h}"][m[f"live_{h}"] & live] * n_nodes
                            + node[m[f"live_{h}"] & live]
                            for h in ("a", "b")])
    assert np.array_equal(np.sort(comps), np.arange(n_lanes * n_nodes))
    assert (node[idle] == n_nodes - 1).all()
    assert (idle.sum() == 0) == (w == n_nodes)
    tid = m["tid"]
    for src in range(n_nodes):
        source = (tid & ~(w - 1)) + src
        assert np.array_equal(source // w, tid // w)
        assert np.array_equal(source // 32, tid // 32)
    for key in ("lane_a", "lane_b", "live_a", "live_b"):
        per_slot = m[key].reshape(-1, w)
        assert (per_slot == per_slot[:, :1]).all(), key


def traj_stores(n_lanes: int, n_nodes: int, d: int, itemsize: int,
                n_steps: int = 3):
    """A numpy mirror of ``TrajStore`` at a lattice of n_nodes (W-thread
    slots): each thread puts its node's D values of both lanes at ``at``
    in its warp's two runs (an idle thread node N - 1's, at that node's
    place), then each copy slot stores its chunk where its run's lanes
    are live.  Returns the value count of every trajectory index over
    n_steps steps, and the 16-byte stores' first values."""
    m = slot_lanes(n_lanes, n_nodes)
    w, kv, i_dim = m["w"], 16 // itemsize, n_nodes * d
    assert i_dim * itemsize % 16 == 0          # a lattice: no shift
    k_run = 32 // w * i_dim
    k_chunks = k_run // kv
    k_copies = -(-2 * k_chunks // 32)
    slots = CTA // w
    t = np.arange(m["tid"].size)
    cta, warp, lane = t // CTA, (t % CTA) // 32, t % 32
    at = (lane // w * n_nodes + m["node"]) * d
    j = lane[:, None] + 32 * np.arange(k_copies)
    h, q = j // k_chunks, j % k_chunks
    run_lane = cta[:, None] * 2 * slots + h * slots + warp[:, None] * (32 // w)
    left = n_lanes - run_lane
    live = np.where((j >= 2 * k_chunks) | (left <= 0), 0,
                    np.minimum(left, 32 // w) * i_dim)
    out = run_lane * i_dim // kv + q
    comp = m["node"][:, None] * d + np.arange(d)
    va = m["lane_a"][:, None] * i_dim + comp
    vb = m["lane_b"][:, None] * i_dim + comp
    count = np.zeros(n_steps * n_lanes * i_dim, np.int64)
    starts = []
    for step in range(n_steps):
        stage = np.full((t.size // 32, 2 * k_chunks * kv), -1, np.int64)
        g = (t // 32)[:, None]
        for k in range(d):
            # an idle thread writes node N - 1's value at its place: equal
            for src, off in ((va, 0), (vb, k_chunks * kv)):
                cur = stage[g[:, 0], off + at + k]
                assert ((cur == -1) | (cur == src[:, k])).all()
                stage[g[:, 0], off + at + k] = src[:, k]
        whole = (q * kv >= 0) & (q * kv + kv <= live)
        thread, slot = np.nonzero(whole)
        base = step * n_lanes * i_dim // kv
        for i in range(kv):
            dst = (out[thread, slot] + base) * kv + i
            val = stage[thread // 32, j[thread, slot] * kv + i]
            assert np.array_equal(val + step * n_lanes * i_dim, dst)
            np.add.at(count, dst, 1)
        starts.append((out[thread, slot] + base) * kv)
    return count, np.concatenate(starts)


@pytest.mark.parametrize("n_nodes,d", [(24, 3), (6, 4), (10, 4), (16, 3),
                                       (20, 4), (8, 3), (32, 3)])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n_lanes", [1, 5, 37, 130])
def test_traj_store_map_at_any_node_count(n_lanes, n_nodes, d, itemsize):
    """The two-lane K2s' staged stores: every value of every step once,
    at its place; 16-byte stores aligned; a dead lane's chunks unwritten."""
    count, starts = traj_stores(n_lanes, n_nodes, d, itemsize)
    assert (count == 1).all()
    assert (starts * itemsize % 16 == 0).all()


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_card_refuses_what_the_reference_refuses_and_past_32_nodes(
        monkeypatch):
    """Four chen nodes (12 rows, not a whole number of sublanes) are
    refused by the reference's kernels and on the card, both with
    ValueError; a lattice of more than 1,024 nodes (given as a descriptor
    and as shape keys, so no 100 MB expansion is built) the plain version
    takes and the card does not (a lane slot is one CTA).  Neither
    reaches nvcc.  chen@ring40 (120 rows) and the 4-16 base at 34 nodes
    now reach the build (recorded here, not built)."""
    built = []

    def record(keys, *args, **kwargs):
        built.extend(keys)
        return {}

    monkeypatch.setattr(build, "build_libraries", record)
    monkeypatch.setattr(chaotic_ann, "_SHAPE_LIBS", {})
    monkeypatch.setattr(chaotic_ann, "_load_shape_library", lambda key: None)
    # four chen nodes (the registry's expansion refuses to build them)
    ring4 = {"w1": np.zeros((12, 32), np.float32),
             "b1": np.zeros(32, np.float32),
             "w2": np.zeros((32, 12), np.float32),
             "b2": np.zeros(12, np.float32),
             "lattice_meta": np.array([4, 3, 0, 0.05], np.float32)}
    lat4 = lattice_meta_tuple(ring4["lattice_meta"])
    x0 = np.zeros((128, 12), np.float32)
    with pytest.raises(ValueError, match="sublanes"):
        chaotic_ann_bits_pallas(*[jnp.asarray(ring4[k]) for k in KEYS],
                                jnp.asarray(x0), n_steps=2, s_block=128,
                                t_block=2, lattice=lat4, interpret=True)
    with pytest.raises(ValueError, match="sublanes"):
        chaotic_ann.check_card_lattice(lat4, 12)
    for unit in ("vpu", "mxu"):
        with pytest.raises(ValueError, match="sublanes"):
            ops.prepare(ops.kernel_shapes(ring4, unit))
    lat1032 = (1_032, 3, "ring", 0.05)
    ref.check_lattice(lat1032, 3_096)            # the plain version's check
    with pytest.raises(ValueError, match="1,024"):
        chaotic_ann.check_card_lattice(lat1032, 3_096)
    for family in ("lattice", "mxu"):
        with pytest.raises(ValueError, match="1,024"):
            ops.prepare([(family, (3, 8, 1_032, 0))])
        with pytest.raises(ValueError, match="1,024"):
            ops.prepare([(family, (4, 16, 1_026, 1))])
    assert built == []
    ring40 = default_params(system="chen@ring40")
    lat40 = lattice_meta_tuple(ring40["lattice_meta"])
    chaotic_ann.check_card_lattice(lat40, 120)
    for unit in ("vpu", "mxu"):
        ops.prepare(ops.kernel_shapes(ring40, unit))
    ops.prepare([("lattice", (4, 16, 34, 0))])
    chaotic_ann.check_card_lattice((1_024, 3, "grid", 0.05), 3_072)
    assert built == [("lattice", (3, 8, 40, 0)), ("mxu", (3, 8, 40, 0)),
                     ("lattice", (4, 16, 34, 0))]
    # on the CPU the plain version takes both, as the JAX ref does
    w = [torch.from_numpy(ring40[k]) for k in KEYS]
    words, _ = chaotic_ann.chaotic_ann_bits(
        *w, torch.zeros(4, 120), n_steps=2, lattice=lat40)
    assert words.shape == (1, 4)


@pytest.mark.parametrize("unit", ["vpu", "mxu"])
def test_cpu_services_serve_lattices_past_32_nodes(unit, monkeypatch):
    """The card's shape libraries are built only for a card: on the CPU a
    ``PRNGService``, a ``ChaoticPRNG`` and a farm's core over chen@ring40
    are built and serve (the plain version), and nothing reaches nvcc."""
    monkeypatch.setattr(build, "build_libraries", pytest.fail)
    ring40 = default_params(system="chen@ring40")
    cfg = dataclasses.replace(
        default_config(120, 320, torch.float32, n_nodes=40),
        compute_unit=unit)
    kw = dict(config=cfg, burn_in=2, device="cpu")
    svc = PRNGService(ring40, lanes_per_client=2, **kw)
    svc.register("a", seed=1)
    svc.request("a", 4)
    assert svc.flush()["a"].shape == (4,)
    eng = ChaoticPRNG(ring40, n_streams=2, **kw)
    words, _ = eng.next_words(eng.init(3), 4)
    assert words.shape == (4,)
    farm = OscillatorFarm(device="cpu")
    farm.add_core("ring40", ring40, config=cfg, lanes_per_client=2,
                  burn_in=2)
    farm.register("ring40", "a", seed=1)
    farm.request("ring40", "a", 4)
    assert farm.flush()["ring40"]["a"].shape == (4,)


# ---------------------------------------------------------------------------
# Scalar plain K1/K2 against the Pallas kernels, the paper's other widths
# ---------------------------------------------------------------------------

def scalar_net(i_dim: int, h_dim: int, seed: int):
    """A seeded net of the shape, with a gain near 1 (bounded but not
    decaying within the comparisons' steps)."""
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(0, 1.2 / np.sqrt(i_dim), (i_dim, h_dim)),
            "b1": rng.normal(0, 0.2, h_dim),
            "w2": rng.normal(0, 1.2 / np.sqrt(h_dim), (h_dim, i_dim)),
            "b2": rng.normal(0, 0.1, i_dim)}


def inputs(i_dim: int, seed: int, n_lanes: int = 128):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.uint64).astype(np.uint32)
    off[:3] = [0xFFFFFFFF, 0xFFFFFFF0, 0]
    return x0, off


def jax_bits(p, x0, off, dtype, *, act, unit="vpu", lattice=None, cpl=None,
             n_steps=STEPS):
    return chaotic_ann_bits_pallas(
        *[jnp.asarray(np.float32(p[k])) for k in KEYS],
        jnp.asarray(x0).astype(dtype), jnp.asarray(off),
        None if cpl is None else jnp.asarray(cpl), n_steps=n_steps,
        s_block=128, t_block=4, unroll=1, activation=act, compute_unit=unit,
        lattice=lattice, interpret=True)


def jax_traj(p, x0, dtype, *, act, unit="vpu", lattice=None, cpl=None,
             n_steps=STEPS):
    return chaotic_ann_pallas(
        *[jnp.asarray(np.float32(p[k])) for k in KEYS],
        jnp.asarray(x0).astype(dtype),
        None if cpl is None else jnp.asarray(cpl), n_steps=n_steps,
        s_block=128, t_block=4, unroll=1, activation=act, compute_unit=unit,
        lattice=lattice, interpret=True)


def port_w(p):
    return [torch.from_numpy(np.asarray(p[k], np.float32)) for k in KEYS]


def bits_of(a) -> np.ndarray:
    """Bit patterns of a torch or JAX float array (bf16 as int16)."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a.view(torch.int32)).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def words_of(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return ops.from_uint32(a).numpy()
    return np.asarray(a).astype(np.int64)


def check_bitwise_k1(p, x0, off, tdt, jdt, *, act, unit="vpu",
                     lattice=None, cpl=None, n_steps=STEPS):
    """The port's plain K1 (wrapper on the CPU) against the Pallas K1:
    every word and the final state, bitwise."""
    words, state = chaotic_ann.chaotic_ann_bits(
        *port_w(p), torch.from_numpy(x0).to(tdt), torch.from_numpy(off),
        n_steps=n_steps, activation=act, lattice=lattice, compute_unit=unit,
        coupling=None if cpl is None else torch.from_numpy(cpl))
    jw, js = jax_bits(p, x0, off, jdt, act=act, unit=unit, lattice=lattice,
                      cpl=cpl, n_steps=n_steps)
    np.testing.assert_array_equal(words_of(words), words_of(jw))
    np.testing.assert_array_equal(bits_of(state), bits_of(js))


def check_f32_tiers(p, x0, *, act, lattice=None, n_steps=STEPS):
    """The f32 vpu K2 against the Pallas K2: the first step within
    8 * eps_f32 * max|x|, the run within 1e-4 * max(1, max|x|)."""
    got = chaotic_ann.chaotic_ann_traj(*port_w(p), torch.from_numpy(x0),
                                       n_steps=n_steps, activation=act,
                                       lattice=lattice).numpy()
    want = np.asarray(jax_traj(p, x0, jnp.float32, act=act, lattice=lattice,
                               n_steps=n_steps))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    step1 = 8 * F32_EPS * max(1.0, float(np.abs(want[0]).max()))
    assert np.abs(got[0] - want[0]).max() <= step1
    assert np.abs(got - want).max() <= 1e-4 * max(1.0,
                                                   float(np.abs(want).max()))


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("shape", SCALAR, ids=lambda s: f"{s[0]}-{s[1]}")
def test_scalar_plain_bf16_vpu_bitwise_vs_pallas(shape, act):
    """K1 words and final state, K2 trajectory: bitwise in bf16."""
    p = scalar_net(*shape, seed=shape[1])
    x0, off = inputs(shape[0], seed=7)
    check_bitwise_k1(p, x0, off, torch.bfloat16, jnp.bfloat16, act=act)
    traj = chaotic_ann.chaotic_ann_traj(
        *port_w(p), torch.from_numpy(x0).to(torch.bfloat16), n_steps=STEPS,
        activation=act)
    np.testing.assert_array_equal(
        bits_of(traj), bits_of(jax_traj(p, x0, jnp.bfloat16, act=act)))


@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("shape", SCALAR, ids=lambda s: f"{s[0]}-{s[1]}")
def test_scalar_plain_mxu_bitwise_vs_pallas(shape, act, dtypes):
    p = scalar_net(*shape, seed=shape[1] + 1)
    x0, off = inputs(shape[0], seed=8)
    check_bitwise_k1(p, x0, off, *dtypes, act=act, unit="mxu")


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("shape", SCALAR, ids=lambda s: f"{s[0]}-{s[1]}")
def test_scalar_plain_f32_vpu_within_tiers_of_pallas(shape, act):
    p = scalar_net(*shape, seed=shape[1] + 2)
    check_f32_tiers(p, inputs(shape[0], seed=9)[0], act=act)


# ---------------------------------------------------------------------------
# The whole slice: a chen@grid24 service against the JAX service
# ---------------------------------------------------------------------------

def test_grid24_bf16_service_bitwise_vs_jax():
    """bf16 chen@grid24 with no config: both packages pick the mxu unit and
    serve the same words to two clients over two flushes, and hold the
    same pool; the registry bundle is the JAX one's bitwise."""
    p = default_params(system="chen@grid24")
    want = jax_trained_oscillator("chen@grid24")
    for k in ("w1", "coupling", "lattice_meta"):
        np.testing.assert_array_equal(p[k], np.asarray(want[k]))
    kw = dict(lanes_per_client=16, burn_in=4)
    jsvc = JaxService(p, backend="pallas_interpret", dtype=jnp.bfloat16, **kw)
    tsvc = PRNGService(p, dtype=torch.bfloat16, device="cpu", **kw)
    assert dataclasses.astuple(tsvc.config) == dataclasses.astuple(
        jsvc.config)
    assert tsvc.config.compute_unit == "mxu"
    for svc in (jsvc, tsvc):
        svc.register("a", seed=1)
        svc.register("b", seed=2)
    for demand in ({"a": 40, "b": 16}, {"a": 8, "b": 72}):
        for svc in (jsvc, tsvc):
            for name, n in demand.items():
                svc.request(name, n)
        jout, tout = jsvc.flush(), tsvc.flush()
        for name in demand:
            np.testing.assert_array_equal(tout[name], np.asarray(jout[name]))
    np.testing.assert_array_equal(bits_of(tsvc.pool_x), bits_of(jsvc.pool_x))
