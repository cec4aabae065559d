"""The paper's flow in the port (train -> DSE -> codegen -> testbench ->
words) against the JAX package, on the CPU at small sizes.

Tiers:

* RK-4 (``rk4_step``, ``integrate``): float32 on both sides, XLA fusing
  differently in the low bits: one step within ``4 * eps * max|x|``, 50
  steps within ``64 * eps * max|x|``.  A long trajectory is chaotic, so
  ``make_dataset`` is held by its attractor box: ``scale`` and ``offset``
  within 10% of the JAX ``scale``.
* ``apply`` and one Adam update: float32 tolerance (matmul order,
  ``torch.tanh`` against XLA's tanh).  Training is held to the JAX test's
  Table II ordering, not to the JAX weights.
* The copied DSE (``CostModel``, ``pareto_front``, ``select``): equal.
* A generated core: its testbench passes on the CPU (the plain path); given
  the JAX package's weights and ``Candidate``, its words and trajectory
  equal the JAX-generated core's bitwise in bf16 (vpu), within
  ``F32_FREE_RUN`` in f32.
"""
import dataclasses
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ann as jax_ann
from repro.core import chaotic as jax_chaotic
from repro.core import codegen as jax_codegen
from repro.core import dse as jax_dse
from repro.train.optimizer import Adam as JaxAdam
from repro_torch.core import ann, chaotic, codegen, dse
from repro_torch.prng.stream import ChaoticPRNG, ChaoticStream, default_params
from repro_torch.train.optimizer import Adam

EPS_F32 = float(np.finfo(np.float32).eps)
ACTIVATIONS = ("relu", "tanh", "sigmoid")


def F32_FREE_RUN(max_abs):
    """16 free-running steps (as in tests/test_torch_kernels.py)."""
    return 1e-4 * max(1.0, max_abs)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: small tensor ops, several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("system", sorted(chaotic.SYSTEMS))
def test_rk4_step_and_integrate_within_f32_tolerance_of_jax(system):
    s = jax_chaotic.get_system(system)
    xb = np.random.default_rng(3).normal(0, 5, (64, s.dim)).astype(np.float32)
    want = np.asarray(jax_chaotic.rk4_step(s.f, jnp.asarray(xb), s.dt))
    got = chaotic.rk4_step(chaotic.get_system(system).f, torch.from_numpy(xb),
                           torch.tensor(s.dt)).numpy()
    assert np.abs(got - want).max() <= 4 * EPS_F32 * np.abs(want).max()
    x0 = np.asarray(s.x0, np.float32)
    want = np.asarray(jax_chaotic.integrate(system, jnp.asarray(x0), 50))
    got = chaotic.integrate(system, torch.from_numpy(x0), 50)
    assert got.shape == (51, s.dim) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 64 * EPS_F32 * np.abs(want).max()
    assert chaotic.rk4_op_counts(chaotic.get_system(system)) == \
        jax_chaotic.rk4_op_counts(s)
    assert chaotic.ann_op_counts((3, 8, 3)) == (48, 59)


@pytest.fixture(scope="module")
def chen_ds():
    return chaotic.make_dataset("chen", n_samples=20_000, seed=0,
                                device="cpu")


def test_dataset_holds_the_jax_attractor_box(chen_ds):
    want = jax_chaotic.make_dataset("chen", n_samples=20_000, seed=0)
    assert chen_ds.x_train.shape == want.x_train.shape == (16_000, 3)
    assert chen_ds.x_test.shape == want.x_test.shape
    assert chen_ds.x_train.dtype == np.float32
    np.testing.assert_allclose(chen_ds.scale, want.scale, rtol=0.1)
    assert np.abs(chen_ds.offset - want.offset).max() <= 0.1 * want.scale.min()
    assert (chen_ds.system, chen_ds.dt) == ("chen", want.dt)
    # normalized into [-1, 1], consecutive pairs of one trajectory
    assert np.abs(chen_ds.x_train).max() <= 1.0 + 1e-6
    y = ann.one_step_reference("chen", chen_ds,
                               torch.from_numpy(chen_ds.x_test[:64]))
    np.testing.assert_allclose(y.numpy(), chen_ds.y_test[:64], atol=2e-5)
    if not torch.cuda.is_available():             # the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            chaotic.make_dataset("chen", n_samples=100)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_apply_within_f32_tolerance_of_jax(activation):
    rng = np.random.default_rng(4)
    p = {"w1": rng.normal(0, .8, (3, 8)), "b1": rng.normal(0, .2, 8),
         "w2": rng.normal(0, .5, (8, 3)), "b2": rng.normal(0, .1, 3)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    want = np.asarray(jax_ann.apply(jax_ann.AnnConfig(activation=activation),
                                    {k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x)))
    cfg = ann.AnnConfig(activation=activation)
    got = ann.apply(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 8 * EPS_F32 * max(1, np.abs(want).max())
    traj = ann.iterate(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x[:4]), 5)
    assert torch.equal(traj[1], ann.apply(
        cfg, {k: torch.from_numpy(v) for k, v in p.items()}, traj[0]))


@pytest.mark.parametrize("kw", [{}, {"clip_norm": 0.5},
                                {"weight_decay": 0.01, "lr": 3e-3}],
                         ids=["plain", "clip", "decay"])
def test_adam_update_within_f32_tolerance_of_jax(kw):
    """Three updates of identical params from identical grads."""
    rng = np.random.default_rng(5)
    p = {k: rng.normal(0, 1, s).astype(np.float32)
         for k, s in (("w1", (3, 8)), ("b1", (8,)))}
    grads = [{k: rng.normal(0, 2, v.shape).astype(np.float32)
              for k, v in p.items()} for _ in range(3)]
    jopt, topt = JaxAdam(**kw), Adam(**kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
    assert ts.step == int(js.step) == 3
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=4 * EPS_F32, atol=4 * EPS_F32)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   rtol=4 * EPS_F32)
    assert tp["w1"].dtype == torch.float32


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_train_epochs_within_f32_tolerance_of_jax(chen_ds, activation):
    """Two epochs of the port's training loop against the JAX epoch
    (``repro.core.ann._train_epoch``) from the same initial params and the
    same batches: params, Adam moments and each epoch's mean loss."""
    n_batches, batch = 40, 64
    xb = chen_ds.x_train[:n_batches * batch].reshape(n_batches, batch, 3)
    yb = chen_ds.y_train[:n_batches * batch].reshape(n_batches, batch, 3)
    jcfg = jax_ann.AnnConfig(activation=activation)
    p0 = ann.extract_parameters(jax_ann.init_params(
        jcfg, jax.random.PRNGKey(2)))
    jopt, topt = JaxAdam(lr=3e-3), Adam(lr=3e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    cfg = ann.AnnConfig(activation=activation)
    for _ in range(2):
        jp, js, jloss = jax_ann._train_epoch(jcfg, jopt, jp, js,
                                             jnp.asarray(xb), jnp.asarray(yb))
        tp, ts, tloss = ann.train_epoch(cfg, topt, tp, ts,
                                        torch.from_numpy(xb),
                                        torch.from_numpy(yb))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert ts.step == int(js.step) == 2 * n_batches
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   rtol=1e-4, atol=1e-7)
    assert not np.allclose(tp["w1"].numpy(), p0["w1"], atol=1e-2)  # trained


def test_training_reaches_the_jax_activation_ordering(chen_ds):
    """Paper Table II / the JAX test's recipe: 60 epochs, lr 3e-3; ReLU
    and tanh beat sigmoid in test MSE."""
    res = {}
    for act in ACTIVATIONS:
        params, hist = ann.train(ann.AnnConfig(activation=act), chen_ds,
                                 epochs=60, lr=3e-3, seed=0, device="cpu")
        res[act] = hist["test_metrics"]["mse"]
        assert len(hist["train_loss"]) == 60
        assert hist["test_metrics"]["r2"] > 0.99, (act, hist["test_metrics"])
    assert res["relu"] < res["sigmoid"], res
    assert res["tanh"] < res["sigmoid"], res
    params, hist = ann.train(ann.AnnConfig(hidden=16), chen_ds, epochs=500,
                             lr=3e-3, target_mse=1e-3, device="cpu")
    assert len(hist["train_loss"]) < 500          # stopped early
    if not torch.cuda.is_available():             # the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ann.train(ann.AnnConfig(), chen_ds, epochs=1)
    ex = ann.extract_parameters(params)
    assert set(ex) == {"w1", "b1", "w2", "b2"}
    assert all(v.dtype == np.float32 for v in ex.values())


def test_regression_metrics_definitions():
    pred = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    m = ann.regression_metrics(pred, pred.clone())
    assert m["mse"] == 0.0 and m["r2"] == 1.0
    m2 = ann.regression_metrics(pred + 1.0, pred)
    assert abs(m2["mse"] - 1.0) < 1e-6 and abs(m2["mae"] - 1.0) < 1e-6
    assert abs(m2["rmse"] - 1.0) < 1e-6


def test_dse_equals_jax_over_a_grid():
    jl, jc = jax_dse.LatencyModel.fit(), jax_dse.CostModel.fit()
    tl, tc = dse.LatencyModel.fit(), dse.CostModel.fit()
    assert jc.coeffs.keys() == tc.coeffs.keys()
    for key in jc.coeffs:
        np.testing.assert_array_equal(tc.coeffs[key], jc.coeffs[key])
    for i_dim, h_dim in ((3, 4), (3, 8), (4, 16), (6, 12)):
        jf = jax_dse.pareto_front(jax_dse.enumerate_candidates(i_dim, h_dim),
                                  jl, jc)
        tf = dse.pareto_front(dse.enumerate_candidates(i_dim, h_dim), tl, tc)
        assert [(dataclasses.asdict(c), cost, lat) for c, cost, lat in tf] \
            == [(dataclasses.asdict(c), cost, lat) for c, cost, lat in jf]
        for mode, p in (("min_latency", None), ("lowest_cost", None),
                        ("pareto", None), ("pareto", 0), ("pareto", 2),
                        ("pareto", 5)):
            want = jax_dse.select(i_dim, h_dim, mode, p=p, latency_model=jl,
                                  cost_model=jc)
            got = dse.select(i_dim, h_dim, mode, p=p, latency_model=tl,
                             cost_model=tc)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (i_dim, h_dim, mode, p)
    # the flow's two solutions for a 3-8-3 net: vpu bf16
    assert dse.select(3, 8, "min_latency") == dse.Candidate(
        3, 8, p=5, compute_unit="vpu", dtype_bytes=2, unroll=8, t_block=256)
    assert dse.select(3, 8, "lowest_cost") == dse.Candidate(
        3, 8, p=0, compute_unit="vpu", dtype_bytes=2, unroll=1, t_block=32)
    with pytest.raises(ValueError, match="mode"):
        dse.select(3, 8, "fastest")


@pytest.fixture()
def on_path(tmp_path):
    sys.path.insert(0, str(tmp_path))
    yield tmp_path
    sys.path.remove(str(tmp_path))
    for name in [m for m in sys.modules if m.startswith("pf_")]:
        del sys.modules[name]


def test_generated_core_testbench_passes_on_cpu(on_path):
    """The flow's lowest-cost solution (vpu bf16, 128 lanes) for a tanh
    net: the emitted package, its solution.json, and its testbench's four
    checks through the plain path."""
    cand = dse.select(3, 8, "lowest_cost")
    bundle = default_params(system="chen")
    pkg = codegen.generate_core("pf_tanh", on_path, params=bundle,
                                candidate=cand, activation="tanh",
                                scale=[2.0, 3.0, 4.0], offset=[0.0, 1.0, 2.0])
    assert {f.name for f in pkg.iterdir()} >= {
        "__init__.py", "testbench.py", "weights.npz", "solution.json"}
    sol = json.loads((pkg / "solution.json").read_text())
    assert sol == {"candidate": dataclasses.asdict(cand), "system": "chen",
                   "activation": "tanh"}
    core = importlib.import_module("pf_tanh")
    assert (core.ACTIVATION, core.COMPUTE_UNIT, core.DTYPE, core.S_BLOCK) == \
        ("tanh", "vpu", torch.bfloat16, 128)
    np.testing.assert_array_equal(core.OFFSET, [0.0, 1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.generate(np.zeros((4, 3), np.float32), 2)   # the card by default
    tb = importlib.import_module("pf_tanh.testbench")
    assert tb.run(verbose=False, device="cpu")


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("dtype_bytes", [2, 4], ids=["bf16", "f32"])
def test_port_core_against_jax_core(on_path, activation, dtype_bytes):
    """Given the same weights (chen's registry net) and Candidate, the
    port-generated core's trajectory and words against the JAX-generated
    core's (its Pallas kernels in interpret mode)."""
    cand = dse.Candidate(3, 8, p=0, compute_unit="vpu",
                         dtype_bytes=dtype_bytes, unroll=4, t_block=32)
    bundle = default_params(system="chen")
    name = f"pf_{activation}_{dtype_bytes}"
    jax_codegen.generate_core(f"{name}_jax", on_path, params=bundle,
                              candidate=jax_dse.Candidate(
                                  **dataclasses.asdict(cand)),
                              activation=activation)
    codegen.generate_core(name, on_path, params=bundle, candidate=cand,
                          activation=activation)
    jcore = importlib.import_module(f"{name}_jax")
    tcore = importlib.import_module(name)
    x0 = np.random.default_rng(9).uniform(
        -0.5, 0.5, (cand.s_block, 3)).astype(np.float32)
    jt = np.asarray(jcore.generate(x0, 16).astype(jnp.float32))
    jw, js = jcore.generate_bits(x0, 32, 7)
    tt = tcore.generate(x0, 16, device="cpu").float().numpy()
    tw, ts = tcore.generate_bits(x0, 32, 7, device="cpu")
    if dtype_bytes == 2:
        np.testing.assert_array_equal(tt.view(np.int32), jt.view(np.int32))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(
            ts.float().numpy().view(np.int32),
            np.asarray(js.astype(jnp.float32)).view(np.int32))
    else:
        assert np.abs(tt - jt).max() <= F32_FREE_RUN(np.abs(jt).max())
        assert tw.shape == tuple(jw.shape)


def test_stream_from_trained_is_the_engines_stream():
    """``ChaoticStream.from_trained`` over extracted (numpy) or tensor
    parameters draws the ``ChaoticPRNG`` words of its activation."""
    p = default_params(system="chen")
    s = ChaoticStream.from_trained(p, activation="sigmoid", n_streams=128,
                                   device="cpu")
    words = s.bits(1000).numpy()
    eng = ChaoticPRNG(p, n_streams=128, activation="sigmoid", device="cpu")
    want, _ = eng.next_words(eng.init(0), 1000)
    np.testing.assert_array_equal(words, want)
    t = ChaoticStream.from_trained({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   activation="sigmoid", n_streams=128,
                                   device="cpu")
    np.testing.assert_array_equal(t.bits(1000).numpy(), want)
    relu = ChaoticStream.from_trained(p, n_streams=128, device="cpu")
    assert not np.array_equal(relu.bits(1000).numpy(), want)
