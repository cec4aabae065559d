"""The port's CUDA kernels against their plain versions, bitwise, on the
card.  Every test here is ``gpu``-marked and skips without a CUDA card
and ``nvcc``.  The file imports no JAX, so it runs where JAX is not
installed; there, skip ``tests/conftest.py`` (it imports JAX):

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ann import params_from_numpy
from repro_torch.kernels import chaotic_ann, ops, ref
from repro_torch.prng.stream import default_params

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import build
    try:
        build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(str(e))


def _inputs(system, n_lanes, dtype, seed):
    rng = np.random.default_rng(seed)
    p = params_from_numpy(default_params(system=system), device="cuda")
    i_dim = p["w1"].shape[0]
    x0 = rng.uniform(-0.9, 0.9, (n_lanes, i_dim)).astype(np.float32)
    off = rng.integers(0, 1 << 32, n_lanes, dtype=np.int64)
    off[:4] = [0xFFFFFFFF, 0xFFFFFFF0, 0xFFFFFFC0, 0]
    return ([p[k] for k in ("w1", "b1", "w2", "b2")],
            torch.from_numpy(x0).to("cuda", dtype),
            torch.from_numpy(off).to("cuda"))


@pytest.mark.parametrize("system", ["chen", "hyperlorenz"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_bitwise_vs_plain_on_card(system, dtype):
    _need_card()
    w, x0, off = _inputs(system, 1000 + 37, dtype, seed=21)
    n0 = chaotic_ann.chaotic_ann_bits.launches
    words, state = chaotic_ann.chaotic_ann_bits(*w, x0, off, n_steps=64)
    assert chaotic_ann.chaotic_ann_bits.launches == n0 + 1
    rw, rs = ref.chaotic_ann_bits_ref(*w, x0, 64, off)
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(rw))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(state.view(bits), rs.view(bits))
    traj = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=64)
    assert torch.equal(traj.view(bits),
                       ref.chaotic_ann_ref(*w, x0, 64).view(bits))


def test_ops_on_card_never_reach_the_plain_version(monkeypatch):
    _need_card()
    p = params_from_numpy(default_params(), device="cuda")
    _, x0, _ = _inputs("chen", 256, torch.float32, seed=2)
    want_w, want_s = ops.chaotic_bits(p, x0, 8, 3, backend="ref")

    def forbidden(*a, **k):
        raise AssertionError("plain version reached on a CUDA tensor")

    monkeypatch.setattr(ref, "chaotic_ann_bits_ref", forbidden)
    monkeypatch.setattr(ref, "chaotic_ann_ref", forbidden)
    words, state = ops.chaotic_bits(p, x0, 8, 3)
    ops.chaotic_trajectory(p, x0, 4)
    assert torch.equal(ops.from_uint32(words), ops.from_uint32(want_w))
    assert torch.equal(state, want_s)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    w, x0, off = _inputs("chen", 64, torch.float32, seed=3)
    with pytest.raises(ValueError, match="contiguous"):
        chaotic_ann.chaotic_ann_bits(*w, x0.t().contiguous().t(), off,
                                     n_steps=4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        chaotic_ann.chaotic_ann_traj(*w, x0.half(), n_steps=4)
    with pytest.raises(ValueError, match="CHAOTIC_ANN_SHAPES"):
        chaotic_ann.chaotic_ann_traj(
            torch.zeros(3, 5, device="cuda"), torch.zeros(5, device="cuda"),
            torch.zeros(5, 3, device="cuda"), torch.zeros(3, device="cuda"),
            x0, n_steps=4)
