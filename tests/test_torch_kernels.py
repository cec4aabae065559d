"""The port's oscillator kernels (K1 ``chaotic_ann_bits``, K2
``chaotic_ann_traj``) against the JAX Pallas kernels in interpret mode,
on the committed chen (3-8-3) and hyperlorenz (4-16-4) weights.

Tiers, as the two frameworks allow:

* bf16 (vpu): every op rounds to bf16 on both sides in the same order,
  so the plain versions match the Pallas kernels *bitwise*.
* f32 (vpu): XLA's CPU code differs from PyTorch's eager ops in the low
  bits (and the JAX package's own ``x @ w`` oracle differs from its Pallas
  kernel from step 0), so floats are held to tolerances scaled by the
  trajectory's magnitude; see ``F32_ONE_STEP`` and ``F32_FREE_RUN``.

The CUDA kernels are held to the plain versions on the card in
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chaotic_ann import chaotic_ann_bits_pallas, chaotic_ann_pallas
from repro_torch.core.ann import Oscillator, params_from_numpy, params_to_numpy
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params

SYSTEMS = ("chen", "hyperlorenz")
KEYS = ("w1", "b1", "w2", "b2")
EPS_F32 = float(np.finfo(np.float32).eps)


def F32_ONE_STEP(max_abs):
    """Teacher-forced one step: both sides compute a step of at most 16
    terms per output in the same order, but XLA may contract or reorder
    in the low bits; 8 ulps of the largest state bounds that."""
    return 8 * EPS_F32 * max_abs


def F32_FREE_RUN(max_abs):
    """16 free-running steps: the one-step gaps grow with the map's
    expansion (chaotic, but over 16 steps only by a bounded factor)."""
    return 1e-4 * max(1.0, max_abs)


def seeds(rng, n_lanes, i_dim):
    """Initial states in the seeding box of ``_splitmix_seeds``."""
    return rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)


def offsets(rng, n_lanes):
    """Per-lane uint32 word offsets, some of them wrapping past 2**32."""
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.uint64).astype(np.uint32)
    off[:4] = [0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0]
    return off


def jax_weights(p):
    return [jnp.asarray(p[k]) for k in KEYS]


def torch_weights(p, device="cpu"):
    return [torch.from_numpy(np.array(p[k])).to(device) for k in KEYS]


def bf16_bits(t):
    """A bf16 tensor's bit patterns as numpy int16."""
    return t.view(torch.int16).numpy()


def jax_bf16_bits(a):
    return np.asarray(a).view(np.int16)


@pytest.fixture(scope="module", params=SYSTEMS)
def system(request):
    return request.param, default_params(system=request.param)


def test_bits_bf16_bitwise_vs_pallas(system):
    """K1 plain == Pallas K1 interpret: words and final state, bitwise."""
    name, p = system
    rng = np.random.default_rng(11)
    i_dim = p["w1"].shape[0]
    x0, off = seeds(rng, 200, i_dim), offsets(rng, 200)
    jw, js = chaotic_ann_bits_pallas(
        *jax_weights(p), jnp.asarray(x0).astype(jnp.bfloat16),
        jnp.asarray(off), n_steps=128, s_block=256, t_block=128, unroll=8,
        interpret=True)
    tw, ts = chaotic_ann.chaotic_ann_bits(
        *torch_weights(p), torch.from_numpy(x0).to(torch.bfloat16),
        torch.from_numpy(off), n_steps=128)
    assert tw.dtype == torch.uint32 and tuple(tw.shape) == (64, 200)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(bf16_bits(ts), jax_bf16_bits(js))


def test_traj_bf16_bitwise_vs_pallas(system):
    """K2 plain == Pallas K2 interpret, every step bitwise."""
    name, p = system
    rng = np.random.default_rng(12)
    x0 = seeds(rng, 130, p["w1"].shape[0])
    jt = chaotic_ann_pallas(*jax_weights(p),
                            jnp.asarray(x0).astype(jnp.bfloat16), n_steps=32,
                            s_block=256, t_block=32, unroll=8, interpret=True)
    tt = chaotic_ann.chaotic_ann_traj(
        *torch_weights(p), torch.from_numpy(x0).to(torch.bfloat16),
        n_steps=32)
    np.testing.assert_array_equal(bf16_bits(tt), jax_bf16_bits(jt))


def test_f32_within_stated_tolerance_of_pallas(system):
    """f32: a teacher-forced step, and a 16-step free run, against Pallas."""
    name, p = system
    rng = np.random.default_rng(13)
    i_dim = p["w1"].shape[0]
    x0 = seeds(rng, 128, i_dim)
    jt = np.asarray(chaotic_ann_pallas(
        *jax_weights(p), jnp.asarray(x0), n_steps=32, s_block=128,
        t_block=32, unroll=8, interpret=True))
    step = ref.make_step(*torch_weights(p), dtype=torch.float32)
    forced = step(torch.from_numpy(jt[:-1].reshape(-1, i_dim).copy()))
    gap = np.abs(forced.numpy().reshape(jt[1:].shape) - jt[1:]).max()
    assert gap <= F32_ONE_STEP(np.abs(jt).max()), gap
    free = chaotic_ann.chaotic_ann_traj(*torch_weights(p),
                                        torch.from_numpy(x0), n_steps=16)
    gap = np.abs(free.numpy() - jt[:16]).max()
    assert gap <= F32_FREE_RUN(np.abs(jt[:16]).max()), gap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bits_ref_is_trajectory_then_pack(system, dtype):
    """The plain K1 is the plain K2 scan followed by ``pack_words``, and its
    state is the trajectory's last row."""
    name, p = system
    rng = np.random.default_rng(14)
    i_dim = p["w1"].shape[0]
    x0 = torch.from_numpy(seeds(rng, 40, i_dim)).to(dtype)
    off = torch.from_numpy(offsets(rng, 40))
    w = torch_weights(p)
    words, state = ref.chaotic_ann_bits_ref(*w, x0, 12, off)
    traj = ref.chaotic_ann_ref(*w, x0, 12)
    assert torch.equal(ops.from_uint32(words),
                       ops.from_uint32(ops.pack_words(traj, off)))
    assert torch.equal(state, traj[-1])


def test_wrappers_on_cpu_take_plain_version_without_counting():
    p = default_params()
    w = torch_weights(p)
    x0 = torch.from_numpy(seeds(np.random.default_rng(0), 8, 3))
    before = (chaotic_ann.chaotic_ann_bits.launches,
              chaotic_ann.chaotic_ann_traj.launches)
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, 5, n_steps=4)
    rw, rs = ref.chaotic_ann_bits_ref(*w, x0, 4, 5)
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(rw))
    assert torch.equal(state, rs)
    assert torch.equal(chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=3),
                       ref.chaotic_ann_ref(*w, x0, 3))
    assert (chaotic_ann.chaotic_ann_bits.launches,
            chaotic_ann.chaotic_ann_traj.launches) == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    """tanh and sigmoid run on every unit (the plain version on the CPU,
    tests/test_torch_activation.py and tests/test_torch_mxu_activation.py):
    the mxu K1/K2 with them equal their plain versions, tanh's words
    unlike relu's; an unknown activation is refused."""
    w = torch_weights(default_params())
    x0 = torch.zeros(4, 3)
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=4,
                                                activation="tanh")
    assert torch.equal(state, ref.chaotic_ann_ref(*w, x0, 4, "tanh")[-1])
    xs = torch.from_numpy(seeds(np.random.default_rng(3), 16, 3))
    words, state = chaotic_ann.chaotic_ann_bits(
        *w, xs, 9, n_steps=4, activation="tanh", compute_unit="mxu")
    rw, rs = ref.chaotic_ann_bits_ref(*w, xs, 4, 9, "tanh",
                                      compute_unit="mxu")
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(rw))
    assert torch.equal(state, rs)
    relu, _ = chaotic_ann.chaotic_ann_bits(*w, xs, 9, n_steps=4,
                                           compute_unit="mxu")
    assert not torch.equal(ops.from_uint32(words), ops.from_uint32(relu))
    assert torch.equal(
        chaotic_ann.chaotic_ann_traj(*w, xs, n_steps=4, activation="sigmoid",
                                     compute_unit="mxu"),
        ref.chaotic_ann_ref(*w, xs, 4, "sigmoid", compute_unit="mxu"))
    with pytest.raises(ValueError, match="activation"):
        chaotic_ann.chaotic_ann_bits(*w, xs, n_steps=4, activation="gelu",
                                     compute_unit="mxu")
    with pytest.raises(ValueError, match="activation"):
        chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=4, activation="gelu")
    with pytest.raises(ValueError):
        chaotic_ann.chaotic_ann_bits(*w, x0, n_steps=3)
    with pytest.raises(ValueError, match="CUDA"):     # no silent fallback
        chaotic_ann.chaotic_ann_bits(*w, x0.to("meta"), n_steps=4)


def test_oscillator_module_is_one_plain_step():
    p = default_params()
    osc = Oscillator(params_from_numpy(p, device="cpu"))
    x = torch.from_numpy(seeds(np.random.default_rng(1), 16, 3))
    step = ref.make_step(*torch_weights(p), dtype=torch.float32)
    assert torch.equal(osc(x), step(x))
    assert torch.equal(osc(x.to(torch.bfloat16)),
                       ref.make_step(*torch_weights(p), dtype=torch.bfloat16)(
                           x.to(torch.bfloat16)))
    assert set(dict(osc.named_buffers())) == set(KEYS)


def test_params_numpy_round_trip():
    bundle = {k: np.asarray(v) for k, v in default_params(system="hyperlorenz").items()}
    # a non-float array keeps its type (a lattice's meta:
    # tests/test_torch_lattice.py)
    bundle["index"] = np.asarray([2, 3, 0], np.int32)
    t = params_from_numpy(bundle, device="cpu")
    assert t["w1"].dtype == torch.float32 and t["index"].dtype == torch.int32
    back = params_to_numpy(t)
    for k, v in bundle.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    half = params_from_numpy(bundle, device="cpu", dtype=torch.bfloat16)
    assert half["w1"].dtype == torch.bfloat16
