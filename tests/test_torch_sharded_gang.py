"""The port's multi-device path on the CPU (a mirror of
``tests/test_sharded_gang.py``).

Sharding a launch across a ``DeviceMesh`` changes nothing about the
words: per lane, the sharded K1 (``shard_stream_pool``), K3 (ragged and
padded) and K4 (with and without a row map) are bitwise the port's
unsharded launch at 2, 4 and 8 mesh entries, in f32 and bf16, on the
scalar and lattice vpu forms and the mxu unit (scalar and lattice, with
its one shared coupling).  Meshes list the CPU several times, the
counterpart of the JAX suite's forced host devices; the plain versions run
each shard, and on the card each shard is a launch of the CUDA kernel.

Against the JAX package: ``gang_partition_maps`` bitwise; every sharded
launch against the JAX unsharded launch (Pallas in interpret mode) at the
tiers of ``tests/test_torch_gang.py``: bitwise in bf16 and on the mxu
unit; vpu f32 states within ``F32_FREE_RUN`` (XLA's CPU code and
PyTorch's eager ops differ in the low bits of a vpu f32 step, so those
words are not compared across the two).  One case runs the JAX sharded
launch itself (``ops.chaotic_bits_gang(..., mesh=...)``) in a subprocess
with four forced host devices, bitwise against the port's 4-entry mesh.

Farm level: skewed and equal flushes on a meshed farm (one compat group)
are bitwise an unsharded gang farm's and a ``gang=False`` farm's;
snapshots round-trip across topologies only through
``on_topology_mismatch="replan"``; a mesh of one routes to the unsharded
kernels yet is a topology of its own.
"""
import functools
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro.kernels import ops as jax_ops
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.core.dse import Candidate
from repro_torch.distributed.sharding import DeviceMesh, shard_stream_pool
from repro_torch.kernels import chaotic_ann, ops
from repro_torch.prng.stream import default_params
from repro_torch.serve.farm import OscillatorFarm, _compat_key, _topology

from test_torch_kernels import F32_FREE_RUN

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("w1", "b1", "w2", "b2")
DEVICE_COUNTS = (2, 4, 8)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (systems, compute unit) of each form; three cores a gang
FORMS = {"scalar": (("chen", "chua", "lorenz"), "vpu"),
         "lattice": (("chen@ring8", "lorenz@ring8", "rossler@ring8"), "vpu"),
         "mxu": (("chen", "chua", "lorenz"), "mxu"),
         "mxu-lattice": (("chen@ring8", "lorenz@ring8", "rossler@ring8"),
                         "mxu")}
# a small Pallas schedule keeps interpret mode cheap and changes no value
S_BLOCK, T_BLOCK, UNROLL, N_STEPS = 128, 4, 1, 16
# 6 blocks: divides 2, not 4 or 8, so gang_partition_maps pads
CORE_MAP = np.array([0, 2, 1, 2, 0, 1], np.int32)
K3_ROW_MAP = np.array([8, 3, 0, 8, 5, 1], np.int32)
K4_LANES, K4_ROW_MAP = 256, np.array([8, 3, 0], np.int32)


@functools.lru_cache(maxsize=None)
def _gang(form):
    """(stacked numpy weights, lattice descriptor, coupling or None)."""
    systems, unit = FORMS[form]
    per_core = [default_params(system=s) for s in systems]
    ws = tuple(np.stack([np.asarray(p[k], np.float32) for p in per_core])
               for k in KEYS)
    if "lattice_meta" not in per_core[0]:
        return ws, None, None
    cpl = (np.asarray(per_core[0]["coupling"], np.float32)
           if unit == "mxu" else None)
    return ws, lattice_meta_tuple(per_core[0]["lattice_meta"]), cpl


def _params(form, dtype=torch.float32):
    ws, _, _ = _gang(form)
    p = {k: torch.from_numpy(w).to(dtype) for k, w in zip(KEYS, ws)}
    systems, _ = FORMS[form]
    meta = default_params(system=systems[0]).get("lattice_meta")
    if meta is not None:
        p["lattice_meta"] = np.asarray(meta, np.float32)
        p["coupling"] = torch.from_numpy(
            np.asarray(default_params(system=systems[0])["coupling"],
                       np.float32)).to(dtype)
    return p


def _inputs(form, shape, seed):
    rng = np.random.default_rng(seed)
    i_dim = _gang(form)[0][0].shape[1]
    x0 = rng.uniform(-0.9, 0.9, shape + (i_dim,)).astype(np.float32)
    off = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    off.reshape(-1)[:3] = [0xFFFFFFFF, 0xFFFFFFF0, 0]   # wrap mid-run
    return x0, off


def _mesh(n_dev):
    return DeviceMesh(["cpu"] * n_dev)


def _bits(a):
    """f32 bit patterns of a state (exact for bf16)."""
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return np.asarray(np.asarray(a, np.float32)).view(np.int32)


def _words(t):
    return ops.from_uint32(t).numpy()


def _kernel_kw(form):
    return dict(s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
                compute_unit=FORMS[form][1])


@functools.lru_cache(maxsize=None)
def _jax_k3(form, dt):
    ws, lattice, cpl = _gang(form)
    x0, off = _inputs(form, (len(CORE_MAP) * S_BLOCK,), 11)
    w, s = jax_ann.chaotic_ann_gang_bits_pallas(
        *map(jnp.asarray, ws), jnp.asarray(x0).astype(DTYPES[dt][1]),
        jnp.asarray(CORE_MAP), jnp.asarray(off), jnp.asarray(K3_ROW_MAP),
        None if cpl is None else jnp.asarray(cpl), n_steps=N_STEPS,
        lattice=lattice, interpret=True, **_kernel_kw(form))
    return np.asarray(w), np.asarray(s.astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_k4(form, dt):
    ws, lattice, _ = _gang(form)
    x0, off = _inputs(form, (3, K4_LANES), 12)
    w, s = jax_ann.chaotic_ann_gang_stacked_pallas(
        *map(jnp.asarray, ws), jnp.asarray(x0).astype(DTYPES[dt][1]),
        jnp.asarray(off), jnp.asarray(K4_ROW_MAP), n_steps=N_STEPS,
        s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL, lattice=lattice,
        interpret=True)
    return np.asarray(w), np.asarray(s.astype(jnp.float32))


def _hold_to_jax(form, dt, got_w, got_s, jax_w, jax_s, lanes_rows):
    """Bitwise in bf16 and on the mxu unit; vpu f32 states within the
    free-run tolerance (words differ across frameworks there)."""
    if dt == "bf16" or FORMS[form][1] == "mxu":
        for sel, r in lanes_rows:
            np.testing.assert_array_equal(got_w[(slice(0, r),) + sel],
                                          jax_w[(slice(0, r),) + sel])
        np.testing.assert_array_equal(_bits(got_s), _bits(jax_s))
    else:
        gap = np.abs(got_s.float().numpy() - jax_s).max()
        assert gap <= F32_FREE_RUN(np.abs(jax_s).max()), gap


# ---------------------------------------------------------------------------
# The partition maps: the JAX package's, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_blocks", [1, 2, 5, 6, 8, 13])
def test_gang_partition_maps_equal_jax(n_blocks, n_dev):
    rng = np.random.default_rng(n_blocks * 10 + n_dev)
    cmap = rng.integers(0, 4, n_blocks).astype(np.int32)
    for rmap in (None, rng.integers(0, 40, n_blocks).astype(np.int32)):
        got = chaotic_ann.gang_partition_maps(cmap, rmap, n_dev=n_dev,
                                              n_rows=32)
        want = jax_ann.gang_partition_maps(cmap, rmap, n_dev=n_dev,
                                           n_rows=32)
        assert got[2] == want[2] and len(got[0]) % n_dev == 0
        for g, w in zip(got[:2], want[:2]):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# Kernel level: every sharded launch == the unsharded one == JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_sharded_gang_bits_matches_unsharded_and_jax(form, dt):
    """K3 across 2, 4 and 8 entries (6 blocks: dead-block padding at 4
    and 8), ragged and padded: words each block asked for and states
    bitwise the unsharded launch, the ragged launch held to JAX's."""
    tdt = DTYPES[dt][0]
    params = _params(form, tdt)
    x0, off = _inputs(form, (len(CORE_MAP) * S_BLOCK,), 11)
    x = torch.from_numpy(x0).to(tdt)
    kw = dict(core_map=CORE_MAP, **_kernel_kw(form))
    for rmap in (K3_ROW_MAP, None):
        want_w, want_s = ops.chaotic_bits_gang(
            params, x, N_STEPS, torch.from_numpy(off), row_map=rmap, **kw)
        rows = (chaotic_ann.gang_effective_rows(rmap, N_STEPS, T_BLOCK,
                                                UNROLL)
                if rmap is not None else [N_STEPS // 2] * len(CORE_MAP))
        lanes_rows = [((slice(g * S_BLOCK, (g + 1) * S_BLOCK),), int(r))
                      for g, r in enumerate(rows)]
        for n_dev in DEVICE_COUNTS:
            mesh = _mesh(n_dev)
            got_w, got_s = ops.chaotic_bits_gang(
                params, x, N_STEPS, torch.from_numpy(off), row_map=rmap,
                mesh=mesh, **kw)
            assert sum(mesh.shard_launches) == n_dev
            gw, ww = _words(got_w), _words(want_w)
            for sel, r in lanes_rows:
                np.testing.assert_array_equal(gw[(slice(0, r),) + sel],
                                              ww[(slice(0, r),) + sel])
            np.testing.assert_array_equal(_bits(got_s), _bits(want_s))
        if rmap is not None:
            _hold_to_jax(form, dt, _words(want_w), want_s,
                         *_jax_k3(form, dt), lanes_rows)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("form", ["lattice", "scalar"])
def test_sharded_stacked_matches_unsharded_per_core_and_jax(form, dt):
    """K4 on the stream axis across 2, 4 and 8 entries, with a row map
    (one core frozen early, one at 0) and without: bitwise the unsharded
    launch and, on each core's demanded prefix, a solo K1; the frozen
    launch held to JAX's."""
    tdt = DTYPES[dt][0]
    params = _params(form, tdt)
    x0, off = _inputs(form, (3, K4_LANES), 12)
    x, o = torch.from_numpy(x0).to(tdt), torch.from_numpy(off)
    for rmap in (K4_ROW_MAP, None):
        want_w, want_s = ops.chaotic_bits_gang_stacked(
            params, x, N_STEPS, o, row_map=rmap)
        rows = [N_STEPS // 2] * 3 if rmap is None else list(rmap)
        for n_dev in DEVICE_COUNTS:
            got_w, got_s = ops.chaotic_bits_gang_stacked(
                params, x, N_STEPS, o, row_map=rmap, mesh=_mesh(n_dev))
            gw, ww = _words(got_w), _words(want_w)
            for c, r in enumerate(rows):
                np.testing.assert_array_equal(gw[:r, c], ww[:r, c])
            np.testing.assert_array_equal(_bits(got_s), _bits(want_s))
        if rmap is not None:
            for c, r in enumerate(rows):
                if r:
                    solo = {k: v[c] if isinstance(v, torch.Tensor)
                            and k in KEYS else v for k, v in params.items()}
                    w, _ = ops.chaotic_bits(solo, x[c], 2 * int(r), o[c])
                    np.testing.assert_array_equal(_words(want_w)[:r, c],
                                                  _words(w))
            _hold_to_jax(form, dt, _words(want_w), want_s,
                         *_jax_k4(form, dt),
                         [((c,), int(r)) for c, r in enumerate(rows)])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_shard_stream_pool_k1_matches_unsharded_and_jax(form, dt):
    """K1 through ``shard_stream_pool`` at 2, 4 and 8 entries: bitwise the
    unsharded launch, which is held to JAX's ``chaotic_bits``."""
    tdt = DTYPES[dt][0]
    params = {k: (v[0] if k in KEYS else v) for k, v in
              _params(form, tdt).items()}
    x0, off = _inputs(form, (8 * 64,), 13)
    x, o = torch.from_numpy(x0).to(tdt), torch.from_numpy(off).to(torch.int64)
    kw = _kernel_kw(form)

    def run(xs, offs):
        return ops.chaotic_bits(params, xs, N_STEPS, offs, **kw)

    want_w, want_s = run(x, o)
    for n_dev in DEVICE_COUNTS:
        mesh = _mesh(n_dev)
        got_w, got_s = shard_stream_pool(run, mesh)(x, o)
        assert mesh.shard_launches == [1] * n_dev
        np.testing.assert_array_equal(_words(got_w), _words(want_w))
        np.testing.assert_array_equal(_bits(got_s), _bits(want_s))
    with pytest.raises(ValueError, match="divide"):
        shard_stream_pool(run, _mesh(3))(x, o)
    jp = {k: jnp.asarray(v.float().numpy()) if isinstance(v, torch.Tensor)
          else v for k, v in params.items()}
    jw, js = jax_ops.chaotic_bits(jp, jnp.asarray(x0).astype(DTYPES[dt][1]),
                                  N_STEPS, jnp.asarray(off),
                                  backend="pallas_interpret", **kw)
    _hold_to_jax(form, dt, _words(want_w), want_s, np.asarray(jw),
                 np.asarray(js.astype(jnp.float32)),
                 [((slice(None),), N_STEPS // 2)])


def test_sharded_wrappers_refuse_what_jax_refuses():
    params = _params("scalar")
    w = [params[k] for k in KEYS]
    x = torch.zeros((6 * S_BLOCK, 3))
    with pytest.raises(ValueError, match="pad the maps"):
        chaotic_ann.chaotic_ann_gang_bits_sharded(
            *w, x, CORE_MAP, mesh=_mesh(4), n_steps=N_STEPS,
            s_block=S_BLOCK)
    lat = _params("mxu-lattice")
    with pytest.raises(ValueError, match="coupling"):
        chaotic_ann.chaotic_ann_gang_bits_sharded(
            *[lat[k] for k in KEYS], torch.zeros((6 * S_BLOCK, 24)),
            CORE_MAP, mesh=_mesh(2), n_steps=N_STEPS, s_block=S_BLOCK,
            compute_unit="mxu",
            lattice=lattice_meta_tuple(lat["lattice_meta"]))
    with pytest.raises(ValueError, match="does not divide"):
        chaotic_ann.chaotic_ann_gang_stacked_sharded(
            *w, torch.zeros((3, 100, 3)), mesh=_mesh(8), n_steps=N_STEPS)


def test_mesh_replicates_weights_once_and_counts_copies():
    mesh = DeviceMesh(["cpu", "cpu"], axis="model")
    assert mesh.shape == {"model": 2} and mesh.ids == (0, 0)
    t = torch.arange(6.0)
    assert mesh.replicate(t, torch.device("cpu")) is t
    assert mesh.copied_bytes == 0
    with pytest.raises(ValueError):
        DeviceMesh([])
    if not torch.cuda.is_available():       # an entry naming a missing card
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceMesh(["cpu", "cuda:0"])


# ---------------------------------------------------------------------------
# Against the JAX sharded kernel itself (4 forced host devices)
# ---------------------------------------------------------------------------

_JAX_SHARDED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.kernels import ops
    assert jax.device_count() == 4, jax.devices()
    z = np.load(sys.argv[1])
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    p = {k: jnp.asarray(z[k]) for k in ("w1", "b1", "w2", "b2")}
    kw = dict(backend="pallas_interpret", s_block=128, t_block=4, unroll=1)
    w, s = ops.chaotic_bits_gang(
        p, jnp.asarray(z["x"]).astype(jnp.bfloat16), 16,
        jnp.asarray(z["off"]), core_map=z["cmap"], row_map=z["rmap"],
        mesh=mesh, **kw)
    sw, ss = ops.chaotic_bits_gang_stacked(
        p, jnp.asarray(z["xs"]).astype(jnp.bfloat16), 16,
        jnp.asarray(z["offs"]), row_map=z["srmap"], mesh=mesh, **kw)
    np.savez(sys.argv[2], w=np.asarray(w), s=np.asarray(s.astype(jnp.float32)),
             sw=np.asarray(sw), ss=np.asarray(ss.astype(jnp.float32)))
""")


def test_jax_sharded_launch_on_four_host_devices_equals_port(tmp_path):
    """JAX ``chaotic_bits_gang`` / ``_stacked`` with ``mesh=`` over four
    forced host devices (a subprocess: a test process's JAX has one device)
    against the port's 4-entry mesh, bf16, bitwise."""
    ws, _, _ = _gang("scalar")
    x0, off = _inputs("scalar", (len(CORE_MAP) * S_BLOCK,), 11)
    xs, offs = _inputs("scalar", (3, K4_LANES), 12)
    np.savez(tmp_path / "in.npz", **dict(zip(KEYS, ws)), x=x0, off=off,
             cmap=CORE_MAP, rmap=K3_ROW_MAP, xs=xs, offs=offs,
             srmap=K4_ROW_MAP)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", _JAX_SHARDED,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    got = np.load(tmp_path / "out.npz")
    params = _params("scalar", torch.bfloat16)
    mesh = _mesh(4)
    tw, ts = ops.chaotic_bits_gang(
        params, torch.from_numpy(x0).to(torch.bfloat16), N_STEPS,
        torch.from_numpy(off), core_map=CORE_MAP, row_map=K3_ROW_MAP,
        mesh=mesh, **_kernel_kw("scalar"))
    rows = chaotic_ann.gang_effective_rows(K3_ROW_MAP, N_STEPS, T_BLOCK,
                                           UNROLL)
    for g, r in enumerate(rows):
        lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
        np.testing.assert_array_equal(_words(tw)[:r, lanes],
                                      got["w"][:r, lanes])
    np.testing.assert_array_equal(_bits(ts), _bits(got["s"]))
    sw, ss = ops.chaotic_bits_gang_stacked(
        params, torch.from_numpy(xs).to(torch.bfloat16), N_STEPS,
        torch.from_numpy(offs), row_map=K4_ROW_MAP, mesh=mesh)
    for c, r in enumerate(K4_ROW_MAP):
        np.testing.assert_array_equal(_words(sw)[:r, c], got["sw"][:r, c])
    np.testing.assert_array_equal(_bits(ss), _bits(got["ss"]))
    assert mesh.shard_launches == [2] * 4


# ---------------------------------------------------------------------------
# Farm level: sharded flushes == unsharded flushes == solo streams
# ---------------------------------------------------------------------------

CAND = Candidate(i_dim=3, h_dim=8, p=0, compute_unit="vpu", dtype_bytes=4,
                 unroll=2, t_block=32)


def _mk_farm(mesh, *, gang=True, dtype=None, form="scalar", seed_base=11):
    farm = OscillatorFarm(gang=gang, planner=gang, device="cpu")
    systems, unit = FORMS[form]
    for i, system in enumerate(systems):
        params = default_params(system=system)
        cand = CAND
        if form != "scalar":
            i_dim, h_dim = params["w1"].shape
            cand = Candidate(i_dim=i_dim, h_dim=h_dim, p=0, compute_unit=unit,
                             dtype_bytes=2 if dtype == torch.bfloat16 else 4,
                             unroll=1, t_block=4, n_nodes=8)
        farm.add_core(f"c{i}", params, config=cand, dtype=dtype,
                      lanes_per_client=128, mesh=mesh)
        farm.register(f"c{i}", "t", seed=seed_base + i)
    return farm


@pytest.mark.parametrize("n_dev", DEVICE_COUNTS)
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_farm_flush_bit_identical_across_topologies(n_dev, dtype):
    """Skewed demand (ragged / split) then equal demand (stacked): a
    meshed farm's words equal an unsharded gang farm's and a gang-less
    farm's, its cores form one compat group, and it ganged."""
    mesh = _mesh(n_dev)
    farms = [_mk_farm(None, gang=False, dtype=dtype),
             _mk_farm(None, dtype=dtype), _mk_farm(mesh, dtype=dtype)]
    meshed = farms[2]
    assert len({_compat_key(s) for s in meshed.services.values()}) == 1
    assert _topology(meshed.services["c0"]) == ("data", n_dev,
                                                (0,) * n_dev)
    for demand in ({"c0": 4096, "c1": 512, "c2": 512},
                   {"c0": 1024, "c1": 1024, "c2": 1024}):
        outs = []
        for f in farms:
            for core, n in demand.items():
                f.request(core, "t", n)
            outs.append(f.flush())
        for core in demand:
            np.testing.assert_array_equal(outs[2][core]["t"],
                                          outs[1][core]["t"])
            np.testing.assert_array_equal(outs[2][core]["t"],
                                          outs[0][core]["t"])
    assert meshed.gang_launches > 0          # no silent solo path
    assert sum(mesh.shard_launches) >= n_dev


@pytest.mark.parametrize("form", ["lattice", "mxu-lattice", "mxu"])
def test_lattice_and_mxu_farms_bit_identical_on_a_mesh(form):
    """A vpu lattice group (K3/K4's lattice forms), an mxu lattice group
    (one shared coupling) and an mxu scalar group on a 4-entry mesh
    serve the unsharded gang-less farm's words."""
    mesh = _mesh(4)
    flat = _mk_farm(None, gang=False, form=form, dtype=torch.bfloat16)
    meshed = _mk_farm(mesh, form=form, dtype=torch.bfloat16)
    for demand in ({"c0": 1024, "c1": 256, "c2": 128},
                   {"c0": 512, "c1": 512, "c2": 512}):
        outs = []
        for f in (flat, meshed):
            for core, n in demand.items():
                f.request(core, "t", n)
            outs.append(f.flush())
        for core in demand:
            np.testing.assert_array_equal(outs[0][core]["t"],
                                          outs[1][core]["t"])
    assert meshed.gang_launches > 0 and min(mesh.shard_launches) > 0


@pytest.mark.parametrize("n_dev", DEVICE_COUNTS)
def test_snapshot_round_trips_across_topologies(n_dev):
    """Snapshot sharded -> restore unsharded and back: refused by default,
    ``replan`` continues every stream bitwise."""
    mesh = _mesh(n_dev)
    sharded, flat = _mk_farm(mesh), _mk_farm(None)
    for f in (sharded, flat):
        f.request("c0", "t", 700)
        f.request("c1", "t", 300)
        f.flush()
    for snap_src, dst_mesh in ((sharded, None), (flat, mesh)):
        snap = snap_src.snapshot()
        dst = _mk_farm(dst_mesh)
        with pytest.raises(ValueError, match="topology"):
            dst.restore(snap)
        dst.restore(snap, on_topology_mismatch="replan")
        for f in (snap_src, dst):
            f.request("c0", "t", 777)
            f.request("c2", "t", 130)
        a, b = snap_src.flush(), dst.flush()
        np.testing.assert_array_equal(a["c0"]["t"], b["c0"]["t"])
        np.testing.assert_array_equal(a["c2"]["t"], b["c2"]["t"])


def test_mesh_of_one_routes_to_unsharded_kernels():
    """A 1-entry mesh is a topology of its own for the compat key, but
    launches the unsharded gang kernels: words equal ``mesh=None``."""
    mesh1 = _mesh(1)
    flat, meshed = _mk_farm(None), _mk_farm(mesh1)
    assert _topology(meshed.services["c0"]) == ("data", 1, (0,))
    assert _topology(flat.services["c0"]) is None
    for f in (flat, meshed):
        f.request("c0", "t", 500)
        f.request("c1", "t", 200)
    a, b = flat.flush(), meshed.flush()
    np.testing.assert_array_equal(a["c0"]["t"], b["c0"]["t"])
    np.testing.assert_array_equal(a["c1"]["t"], b["c1"]["t"])


def test_mesh_of_one_topology_mismatch_still_refused():
    mesh1 = _mesh(1)
    meshed, flat = _mk_farm(mesh1), _mk_farm(None)
    meshed.request("c0", "t", 300)
    meshed.flush()
    snap = meshed.snapshot()
    assert snap["topology"]["c0"] == ("data", 1, (0,))
    with pytest.raises(ValueError) as ei:
        flat.restore(snap)
    assert "topology" in str(ei.value) and "c0" in str(ei.value)
    flat.restore(snap, on_topology_mismatch="replan")
    for f in (meshed, flat):
        f.request("c0", "t", 256)
    np.testing.assert_array_equal(meshed.flush()["c0"]["t"],
                                  flat.flush()["c0"]["t"])
