"""The port's plain tanh and sigmoid (``kernels.ref.ACTIVATIONS``) against
the JAX package's ``jnp.tanh`` and ``jax.nn.sigmoid``, and the plain K1/K2
with those activations against the Pallas kernels in interpret mode (CPU).

``jnp.tanh`` and ``jax.nn.sigmoid`` are XLA formulas (a rational tanh, a
Cephes exp with an exact 2^fx scaling and a flush to zero below FLT_MIN),
not ``torch.tanh``/``torch.sigmoid``.  The port writes them in basic ops,
so they are held *bitwise*: on every finite bf16 value, on 2**20 + 2**19
seeded f32 values and on the formulas' edges.

The plain K1/K2 with tanh and sigmoid are then held to the Pallas kernels
at the tiers of ``tests/test_torch_kernels.py`` and
``tests/test_torch_mxu.py``: bitwise in vpu bf16, mxu f32 and mxu bf16
(words, final state and trajectory; the mxu bf16 step feeds phi's f32
result into the second dot, as the JAX kernel does), and within
``F32_ONE_STEP``/``F32_FREE_RUN`` in vpu f32, on chen's registry weights
and on a net trained here with tanh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chaotic_ann import chaotic_ann_bits_pallas, chaotic_ann_pallas
from repro_torch.core.ann import AnnConfig, extract_parameters, train
from repro_torch.core.chaotic import make_dataset
from repro_torch.kernels import chaotic_ann, ref
from repro_torch.prng.stream import default_params

KEYS = ("w1", "b1", "w2", "b2")
ACTIVATIONS = ("tanh", "sigmoid")
JAX_ACTIVATIONS = {"tanh": jnp.tanh, "sigmoid": jax.nn.sigmoid}
EPS_F32 = float(np.finfo(np.float32).eps)
STEPS = 32


def F32_ONE_STEP(max_abs):
    """Teacher-forced one step (as in tests/test_torch_kernels.py): 8
    ulps of the largest state."""
    return 8 * EPS_F32 * max_abs


def F32_FREE_RUN(max_abs):
    """16 free-running steps (as in tests/test_torch_kernels.py)."""
    return 1e-4 * max(1.0, max_abs)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain formulas and FMA chains are many
    small tensor ops, which more threads only slow down under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edges():
    """The formulas' edges: the tanh clamp (+-7.9988) and small-x select
    (+-0.0004), the exp clamp (+-88.7), inputs whose sigmoid is below
    FLT_MIN (x < -87.34), denormal inputs (tanh returns them), +-0, each
    with its float32 neighbours."""
    e = np.array([0.0004, 7.99881172180175781, 7.9988, 88.7, 88.3762626647949,
                  87.34, 87.5, 88.0, 88.5, 95.0, 103.0, 1e-40, 1.4e-45,
                  1e-30, 0.0, 1.0], np.float32)
    e = np.concatenate([e, -e])
    return np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                           np.nextafter(e, np.float32(-np.inf))])


def bits32(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_activation_bitwise_on_every_bf16_value(activation):
    pat = np.arange(1 << 16, dtype=np.uint16).view(np.int16)
    xb = torch.from_numpy(pat.copy()).view(torch.bfloat16)
    xb = xb[torch.isfinite(xb.float())]
    assert xb.numel() == 65_280
    want = JAX_ACTIVATIONS[activation](
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    got = ref.ACTIVATIONS[activation](xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_activation_bitwise_on_seeded_f32_and_edges(activation):
    rng = np.random.default_rng(18)
    x = np.concatenate([rng.normal(0.0, 3.0, 1 << 20),
                        rng.uniform(-110.0, 110.0, 1 << 19),
                        edges()]).astype(np.float32)
    want = np.asarray(JAX_ACTIVATIONS[activation](jnp.asarray(x)))
    got = ref.ACTIVATIONS[activation](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits32(got), bits32(want))
    if activation == "sigmoid":       # flushed below FLT_MIN, never denormal
        tiny = np.abs(got) < np.finfo(np.float32).tiny
        assert tiny.any() and (got[tiny] == 0).all()
    else:                             # tanh returns denormal inputs as they are
        den = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
        assert den.any() and (bits32(got[den]) == bits32(x[den])).all()


def test_mxu_bf16_second_dot_reads_phis_f32_result():
    """``f32_result`` leaves a bf16 activation's last rounding out (what
    the mxu step's second dot reads); relu is exact either way."""
    x = torch.linspace(-3, 3, 61).to(torch.bfloat16)
    for name, phi in ref.ACTIVATIONS.items():
        full, raw = phi(x), phi(x, f32_result=True)
        assert torch.equal(raw.to(torch.bfloat16).view(torch.int16),
                           full.view(torch.int16))
        assert (raw.dtype == torch.float32) == (name != "relu")
    assert not torch.equal(ref.tanh(x, f32_result=True),
                           ref.tanh(x).float())


@pytest.fixture(scope="module")
def nets():
    """chen's registry weights, and a 3-8-3 net trained here with tanh (a
    short run: the check is the kernels' arithmetic on other weights)."""
    ds = make_dataset("chen", n_samples=4_000, seed=1, device="cpu")
    params, hist = train(AnnConfig(activation="tanh"), ds, epochs=100,
                         lr=3e-3, seed=1, device="cpu")
    assert hist["test_metrics"]["r2"] > 0.99, hist["test_metrics"]
    return {"registry": default_params(system="chen"),
            "tanh-trained": extract_parameters(params)}


def _pallas(p, x0, off, dtype, activation, unit):
    w = [jnp.asarray(p[k]) for k in KEYS]
    xj = jnp.asarray(x0).astype(dtype)
    kw = dict(n_steps=STEPS, s_block=128, t_block=STEPS, unroll=4,
              interpret=True, activation=activation, compute_unit=unit)
    traj = chaotic_ann_pallas(*w, xj, **kw)
    words, state = chaotic_ann_bits_pallas(*w, xj, jnp.asarray(off), **kw)
    return (np.asarray(traj.astype(jnp.float32)), np.asarray(words),
            np.asarray(state.astype(jnp.float32)))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-0.9, 0.9, (200, 3)).astype(np.float32)
    off = rng.integers(0, 1 << 32, 200, dtype=np.uint64).astype(np.uint32)
    off[:4] = [0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0]
    return x0, off


@pytest.mark.parametrize("net", ["registry", "tanh-trained"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("unit,dtype", [("vpu", "bfloat16"),
                                        ("mxu", "float32"),
                                        ("mxu", "bfloat16")])
def test_plain_k1_k2_bitwise_vs_pallas(nets, net, activation, unit, dtype):
    """Plain K1/K2 == Pallas K1/K2 interpret: every step, the words and the
    final state, bitwise."""
    p = nets[net]
    x0, off = _inputs(31)
    tdt = getattr(torch, dtype)
    jt, jw, js = _pallas(p, x0, off, getattr(jnp, dtype), activation, unit)
    w = [torch.from_numpy(np.array(p[k])) for k in KEYS]
    x = torch.from_numpy(x0).to(tdt)
    tt = ref.chaotic_ann_ref(*w, x, STEPS, activation, compute_unit=unit)
    tw, ts = ref.chaotic_ann_bits_ref(
        *w, x, STEPS, torch.from_numpy(off.astype(np.int64)), activation,
        compute_unit=unit)
    np.testing.assert_array_equal(bits32(tt.float().numpy()), bits32(jt))
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(bits32(ts.float().numpy()), bits32(js))
    if unit == "vpu":       # the wrappers take the plain version on the CPU
        kw = dict(n_steps=STEPS, activation=activation)
        assert torch.equal(chaotic_ann.chaotic_ann_traj(*w, x, **kw), tt)
        assert torch.equal(chaotic_ann.chaotic_ann_bits(
            *w, x, torch.from_numpy(off.astype(np.int64)), **kw)[1], ts)


@pytest.mark.parametrize("net", ["registry", "tanh-trained"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_f32_within_stated_tolerance_of_pallas(nets, net, activation):
    """vpu f32: a teacher-forced step, and a 16-step free run."""
    p = nets[net]
    x0, off = _inputs(32)
    jt, _, _ = _pallas(p, x0, off, jnp.float32, activation, "vpu")
    w = [torch.from_numpy(np.array(p[k])) for k in KEYS]
    step = ref.make_step(*w, dtype=torch.float32, activation=activation)
    forced = step(torch.from_numpy(jt[:-1].reshape(-1, 3).copy()))
    gap = np.abs(forced.numpy().reshape(jt[1:].shape) - jt[1:]).max()
    assert gap <= F32_ONE_STEP(np.abs(jt).max()), gap
    free = chaotic_ann.chaotic_ann_traj(*w, torch.from_numpy(x0),
                                        n_steps=16, activation=activation)
    gap = np.abs(free.numpy() - jt[:16]).max()
    assert gap <= F32_FREE_RUN(np.abs(jt[:16]).max()), gap
