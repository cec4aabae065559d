"""The port's plain lattice kernels at node counts and bases outside the
default library (CPU), against the JAX package's Pallas kernels in
interpret mode: ``chen@ring16`` (16 nodes), ``hyperlorenz@grid4`` and
``hyperlorenz@ring6`` (the 4-16 base; 6 nodes: a lane slot of 8 threads,
2 idle on the card).  ``tests/test_torch_shapes_grid24.py`` has
``chen@grid24``.

Per lattice, as ``tests/test_torch_shapes.py`` has them for scalar nets:
the bf16 vpu K1 (words and final state) and the mxu K1 in f32 and bf16,
bitwise; the f32 vpu K2 within ``8 * eps_f32 * max|x|`` for a step and
``1e-4 * max(1, max|x|)`` over 16 steps; tanh on the mxu unit at every
lattice and on the vpu at ``hyperlorenz@grid4``; one lattice K4 case there
(bf16, a frozen core), the words each core asked for and the final
states, bitwise.  The Pallas schedule is t_block 4, unroll 1 (their
interpret compiles grow with both; the values do not change) and 128
lanes, where XLA keeps the mxu dot's forward FMA chain.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import chaotic_ann as jax_ann
from repro_torch.core.ann import lattice_meta_tuple
from repro_torch.kernels import chaotic_ann
from repro_torch.prng.stream import default_params

from test_torch_shapes import (KEYS, bits_of, check_bitwise_k1,
                               check_f32_tiers, inputs, words_of)

LATTICES = ("chen@ring16", "hyperlorenz@grid4", "hyperlorenz@ring6")
S_BLOCK, T_BLOCK, UNROLL = 128, 4, 1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain f32 FMA chains are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lattice_of(system):
    p = default_params(system=system)
    return p, lattice_meta_tuple(p["lattice_meta"])


@pytest.mark.parametrize("system", LATTICES)
def test_plain_lattice_bf16_vpu_bitwise_vs_pallas(system):
    p, lattice = lattice_of(system)
    x0, off = inputs(p["w1"].shape[0], seed=11)
    check_bitwise_k1(p, x0, off, torch.bfloat16, jnp.bfloat16, act="relu",
                     lattice=lattice, n_steps=8)


@pytest.mark.parametrize("system", LATTICES)
def test_plain_lattice_f32_vpu_within_tiers_of_pallas(system):
    p, lattice = lattice_of(system)
    check_f32_tiers(p, inputs(p["w1"].shape[0], seed=12)[0], act="relu",
                    lattice=lattice)


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("system", LATTICES)
def test_plain_lattice_mxu_bitwise_vs_pallas(system, dtypes, act):
    """The dense coupling operand; relu in both dtypes, tanh too."""
    p, lattice = lattice_of(system)
    x0, off = inputs(p["w1"].shape[0], seed=13)
    check_bitwise_k1(p, x0, off, *dtypes, act=act, unit="mxu",
                     lattice=lattice, cpl=p["coupling"], n_steps=8)


def test_plain_lattice_tanh_vpu_vs_pallas():
    """tanh on the vpu at the 4-16 base on a 2 x 2 torus: bf16 K1 bitwise,
    f32 K2 within the tiers."""
    p, lattice = lattice_of("hyperlorenz@grid4")
    x0, off = inputs(16, seed=14)
    check_bitwise_k1(p, x0, off, torch.bfloat16, jnp.bfloat16, act="tanh",
                     lattice=lattice, n_steps=8)
    check_f32_tiers(p, x0, act="tanh", lattice=lattice)


def test_plain_grid4_gang_stacked_bf16_bitwise_vs_pallas():
    """K4 at hyperlorenz@grid4 (the 4-16 base on a 2 x 2 torus): its net
    and a scaled copy as two pools of 37 lanes, core 1 frozen early; the
    words each core asked for and the final states.  (The Pallas K4's
    interpret compile at chen@grid24 takes minutes: its stacked step
    unrolls every one of I + H terms; the card holds the CUDA K4 there.)"""
    p, lattice = lattice_of("hyperlorenz@grid4")
    ws = [np.stack([np.asarray(p[k], np.float32),
                    np.asarray(p[k], np.float32) * np.float32(0.9375)])
          for k in KEYS]
    n_steps, row_map = 16, np.array([8, 3])
    x0, off = inputs(16, seed=16, n_lanes=2 * 37)
    x0, off = x0.reshape(2, 37, 16), off.reshape(2, 37)
    jw, js = jax_ann.chaotic_ann_gang_stacked_pallas(
        *[jnp.asarray(w) for w in ws], jnp.asarray(x0).astype(jnp.bfloat16),
        jnp.asarray(off), jnp.asarray(row_map), n_steps=n_steps,
        s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL, lattice=lattice,
        interpret=True)
    tw, ts = chaotic_ann.chaotic_ann_gang_stacked(
        *[torch.from_numpy(w) for w in ws],
        torch.from_numpy(x0).to(torch.bfloat16), torch.from_numpy(off),
        row_map, n_steps=n_steps, lattice=lattice)
    jw, tw = words_of(jw), words_of(tw)
    for c, r in enumerate(row_map):
        np.testing.assert_array_equal(tw[:r, c], jw[:r, c])
    np.testing.assert_array_equal(bits_of(ts), bits_of(js))
