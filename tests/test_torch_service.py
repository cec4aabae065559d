"""The port's PRNGService: against the JAX service (bf16 bitwise, f32 pool
state within tolerance), and the serving semantics of
``tests/test_prng_service.py`` inside the port, on the committed chen
weights and the plain versions (CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.prng_service import PRNGService as JaxService
from repro_torch.prng.stream import ChaoticPRNG, default_params
from repro_torch.serve.prng_service import PRNGService

from test_torch_kernels import F32_FREE_RUN


@pytest.fixture(scope="module")
def params():
    return default_params()


def _service(params, **kw):
    return PRNGService(params, lanes_per_client=128, device="cpu", **kw)


def test_bf16_service_bitwise_vs_jax(params):
    """2 clients x 1,024 words through each framework's whole service."""
    jsvc = JaxService(params, lanes_per_client=128,
                      backend="pallas_interpret", dtype=jnp.bfloat16)
    tsvc = _service(params, dtype=torch.bfloat16)
    for svc in (jsvc, tsvc):
        svc.register("a", seed=1)
        svc.register("b", seed=2)
        svc.request("a", 1024)
        svc.request("b", 1024)
    jout, tout = jsvc.flush(), tsvc.flush()
    for name in ("a", "b"):
        assert tout[name].size == 1024
        np.testing.assert_array_equal(tout[name], np.asarray(jout[name]))
    np.testing.assert_array_equal(
        tsvc.pool_x.view(torch.int16).numpy(),
        np.asarray(jsvc.pool_x).view(np.int16))


def test_f32_pool_after_burn_in_within_tolerance(params):
    """f32 is not bitwise across frameworks: the 16-step burn-in is a free
    run, held to the free-run tolerance of test_torch_kernels."""
    jsvc = JaxService(params, lanes_per_client=128,
                      backend="pallas_interpret")
    tsvc = _service(params)
    for svc in (jsvc, tsvc):
        svc.register("a", seed=3)
        svc.register("b", seed=4)
    want = np.asarray(jsvc.pool_x)
    gap = np.abs(tsvc.pool_x.numpy() - want).max()
    assert gap <= F32_FREE_RUN(np.abs(want).max()), gap


def test_eight_clients_one_launch(params):
    svc = _service(params)
    for i in range(8):
        svc.register(f"c{i}", seed=100 + i)
    for i in range(8):
        svc.request(f"c{i}", 400 + 31 * i)
    out = svc.flush()
    assert svc.launches == 1
    assert {k: v.size for k, v in out.items()} == {
        f"c{i}": 400 + 31 * i for i in range(8)}
    assert len({tuple(v[:16]) for v in out.values()}) == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_client_matches_standalone_stream(params, dtype):
    svc = _service(params, dtype=dtype)
    for i in range(4):
        svc.register(f"c{i}", seed=40 + i)
    for i in range(4):
        svc.request(f"c{i}", 700)
    out = svc.flush()
    eng = ChaoticPRNG(params, n_streams=128, config=svc.config, dtype=dtype,
                      device="cpu")
    np.testing.assert_array_equal(out["c3"],
                                  eng.next_words(eng.init(seed=43), 700)[0])


def test_stream_independent_of_cotenants_and_batching(params):
    svc_a = _service(params)
    svc_a.register("x", seed=7)
    for i in range(3):
        svc_a.register(f"noise{i}", seed=i)
    svc_a.request("x", 200)
    svc_a.request("noise2", 5000)          # forces a much larger launch
    first = svc_a.flush()["x"]
    rest = svc_a.draw("x", 800)
    svc_b = _service(params)
    svc_b.register("x", seed=7)
    np.testing.assert_array_equal(np.concatenate([first, rest]),
                                  svc_b.draw("x", 1000))


def test_snapshot_restore_resumes_bit_exactly(params):
    svc = _service(params, dtype=torch.bfloat16)
    for i in range(3):
        svc.register(f"c{i}", seed=i)
    svc.draw("c1", 333)
    snap = svc.snapshot()
    a = svc.draw("c1", 500)
    svc2 = _service(params, dtype=torch.bfloat16)
    svc2.restore(snap)
    assert svc2.pool_x.dtype == torch.bfloat16
    np.testing.assert_array_equal(a, svc2.draw("c1", 500))
    assert svc2.launches == svc.launches


def test_snapshot_between_request_and_flush_keeps_pending(params):
    svc = _service(params)
    svc.register("a", seed=1)
    svc.register("b", seed=2)
    svc.draw("a", 120)
    svc.request("a", 250)
    svc.request("b", 75)
    snap = svc.snapshot()
    out_a = svc.flush()
    svc2 = _service(params)
    svc2.restore(snap)
    assert svc2.clients["a"].pending == 250 and svc2.clients["b"].pending == 75
    out_b = svc2.flush()
    assert set(out_a) == set(out_b) == {"a", "b"}
    for name in out_a:
        np.testing.assert_array_equal(out_a[name], out_b[name])


def test_snapshot_restores_outbox_and_pending_roundtrip(params):
    svc = _service(params)
    svc.register("a", seed=1)
    svc.register("b", seed=2)
    svc.request("a", 300)
    svc.draw("b", 200)                     # a's words now parked in outbox
    assert svc.outbox_words("a") == 300
    snap = svc.snapshot()
    svc2 = _service(params)
    svc2.restore(snap)
    a1, a2 = svc.flush()["a"], svc2.flush()["a"]
    np.testing.assert_array_equal(a1, a2)
    solo = _service(params)
    solo.register("a", seed=1)
    np.testing.assert_array_equal(a1, solo.draw("a", 300))


def test_restore_refuses_other_burn_in(params):
    svc = _service(params)
    svc.register("a", seed=1)
    with pytest.raises(ValueError, match="burn_in"):
        _service(params, burn_in=8).restore(svc.snapshot())


def test_register_duplicate_raises_and_default_seeds_differ(params):
    svc = _service(params)
    svc.register("alice")
    svc.register("bob")
    with pytest.raises(ValueError):
        svc.register("alice", seed=1)
    svc.request("alice", 200)
    svc.request("bob", 200)
    out = svc.flush()
    assert not np.array_equal(out["alice"], out["bob"])


def test_idle_clients_frozen(params):
    svc = _service(params)
    svc.register("busy", seed=1)
    svc.register("idle", seed=2)
    for _ in range(3):
        svc.draw("busy", 3000)
    idle = svc.clients["idle"]
    assert len(idle.buf) == 0 and idle.row == 0
    solo = _service(params)
    solo.register("idle", seed=2)
    np.testing.assert_array_equal(svc.draw("idle", 500),
                                  solo.draw("idle", 500))


def test_draw_never_drops_cotenant_requests(params):
    svc = _service(params)
    svc.register("a", seed=1)
    svc.register("b", seed=2)
    svc.request("a", 300)
    assert svc.draw("b", 200).size == 200
    got_a = svc.flush()["a"]
    solo = _service(params)
    solo.register("a", seed=1)
    np.testing.assert_array_equal(got_a, solo.draw("a", 300))


def test_draw_after_own_request_returns_only_new_words(params):
    svc = _service(params)
    svc.register("a", seed=1)
    svc.request("a", 150)
    got = svc.draw("a", 100)
    solo = _service(params)
    solo.register("a", seed=1)
    whole = solo.draw("a", 250)
    np.testing.assert_array_equal(got, whole[150:])
    np.testing.assert_array_equal(svc.flush()["a"], whole[:150])


def test_small_draw_does_not_pay_full_time_block(params):
    svc = _service(params)
    svc.register("a", seed=1)
    got = svc.draw("a", 10)
    assert got.size == 10
    assert len(svc.clients["a"].buf) <= 4 * svc.lanes_per_client - 10
    solo = _service(params)
    solo.register("a", seed=1)
    np.testing.assert_array_equal(got, solo.draw("a", 2000)[:10])


def test_zero_and_negative_draws(params):
    svc = _service(params)
    svc.register("a", seed=0)
    z = svc.draw("a", 0)
    assert z.shape == (0,) and z.dtype == np.uint32
    assert svc.launches == 0
    with pytest.raises(ValueError):
        svc.draw("a", -1)
    with pytest.raises(KeyError):
        svc.draw("ghost", 0)


def test_replay_client_rebuilds_position_and_tail(params):
    """Replaying a fresh client to a recorded position reproduces its
    undelivered outbox and buffer words exactly."""
    svc = _service(params)
    svc.register("a", seed=5)
    svc.register("b", seed=6)
    svc.draw("a", 1000)
    svc.request("a", 100)
    svc.draw("b", 50)                      # parks a's 100 words
    c = svc.clients["a"]
    row, buf, outbox = c.row, c.buf.copy(), svc._outbox["a"].copy()
    fresh = _service(params)
    fresh.register("a", seed=5)
    fresh.register("b", seed=6)
    fresh.replay_client("a", row=row, buf_words=buf.size,
                        outbox_words=outbox.size, chunk_rows=16)
    np.testing.assert_array_equal(fresh.clients["a"].buf, buf)
    np.testing.assert_array_equal(fresh._outbox["a"], outbox)
    assert torch.equal(fresh.pool_x[:128], svc.pool_x[:128])
    np.testing.assert_array_equal(fresh.draw("a", 400), svc.draw("a", 400))
    with pytest.raises(ValueError, match="rewind"):
        fresh.replay_client("a", row=0)


def test_sharded_pool_matches_unsharded(params):
    """The stream axis sharded over a mesh of one entry, then of four
    (four clients: one a shard), then of three, which does not divide
    the pool and launches unsharded: every draw bitwise the unsharded
    service's, in f32 and bf16."""
    from repro_torch.distributed.sharding import DeviceMesh
    for dtype in (torch.float32, torch.bfloat16):
        for n_dev, sharded in ((1, True), (4, True), (3, False)):
            mesh = DeviceMesh(["cpu"] * n_dev)
            svc_m = PRNGService(params, lanes_per_client=128, dtype=dtype,
                                mesh=mesh)
            svc_u = _service(params, dtype=dtype)
            for svc in (svc_m, svc_u):
                for i in range(4):
                    svc.register(f"c{i}", seed=i)
            assert svc_m.device == torch.device("cpu")
            np.testing.assert_array_equal(svc_m.draw("c2", 600),
                                          svc_u.draw("c2", 600))
            svc_m.request("c0", 300)
            svc_u.request("c0", 300)
            out_m, out_u = svc_m.flush(), svc_u.flush()
            np.testing.assert_array_equal(out_m["c0"], out_u["c0"])
            # two launches, each a shard on every entry, or none
            assert mesh.shard_launches == [2 if sharded else 0] * n_dev


def test_meshed_service_refuses_a_device_off_the_mesh(params):
    from repro_torch.distributed.sharding import DeviceMesh
    mesh = DeviceMesh(["cpu", "cpu"], axis="data")
    svc = PRNGService(params, device="cpu", mesh=mesh)
    assert svc.device == mesh.devices[0]
    # a card off the mesh is refused; without a card, naming one raises
    err, match = ((ValueError, "first device") if torch.cuda.is_available()
                  else (RuntimeError, "CUDA"))
    with pytest.raises(err, match=match):
        PRNGService(params, device="cuda:0", mesh=mesh)
