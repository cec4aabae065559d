"""The port's plain lattice kernels at ``chen@grid24`` (CPU): a 4 x 6
torus of 24 chen nodes, 72 rows, outside the default library (on the
card a lane slot of 32 threads, 8 of them idle), against the JAX
package's Pallas kernels in interpret mode, as
``tests/test_torch_shapes_lattice.py`` holds its lattices: the bf16 vpu
K1 and the mxu K1 (f32, bf16; relu, tanh) bitwise, the f32 vpu K2 within
the tiers, and one lattice K3 case (bf16, four cores of one descriptor,
ragged rows) bitwise.
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

SYSTEM = "chen@grid24"
BASES = ("chen", "chua", "lorenz", "rossler")
S_BLOCK, T_BLOCK, UNROLL = 128, 4, 1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain f32 FMA chains are many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid24():
    p = default_params(system=SYSTEM)
    return p, lattice_meta_tuple(p["lattice_meta"])


def test_plain_grid24_bf16_vpu_bitwise_vs_pallas():
    p, lattice = grid24()
    assert lattice[:3] == (24, 3, "grid")
    x0, off = inputs(72, seed=11)
    check_bitwise_k1(p, x0, off, torch.bfloat16, jnp.bfloat16, act="relu",
                     lattice=lattice, n_steps=8)


def test_plain_grid24_f32_vpu_within_tiers_of_pallas():
    p, lattice = grid24()
    check_f32_tiers(p, inputs(72, seed=12)[0], act="relu", lattice=lattice)


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("dtypes", [(torch.float32, jnp.float32),
                                    (torch.bfloat16, jnp.bfloat16)],
                         ids=["f32", "bf16"])
def test_plain_grid24_mxu_bitwise_vs_pallas(dtypes, act):
    p, lattice = grid24()
    x0, off = inputs(72, seed=13)
    check_bitwise_k1(p, x0, off, *dtypes, act=act, unit="mxu",
                     lattice=lattice, cpl=p["coupling"], n_steps=8)


def test_plain_grid24_gang_bits_bf16_bitwise_vs_pallas():
    """K3: four blocks of the four 3-8 bases as chen@grid24's lattice,
    rows 0, odd, all and ragged; the words each block asked for and the
    final states."""
    per_core = [default_params(system=f"{b}@grid24") for b in BASES]
    ws = [np.stack([np.asarray(p[k], np.float32) for p in per_core])
          for k in KEYS]
    lattice = lattice_meta_tuple(per_core[0]["lattice_meta"])
    n_steps, row_map = 16, np.array([0, 3, 8, 5])
    core_map = np.array([2, 0, 3, 1], np.int32)
    x0, off = inputs(72, seed=15, n_lanes=4 * S_BLOCK)
    jw, js = jax_ann.chaotic_ann_gang_bits_pallas(
        *[jnp.asarray(w) for w in ws], jnp.asarray(x0).astype(jnp.bfloat16),
        jnp.asarray(core_map), jnp.asarray(off), jnp.asarray(row_map),
        n_steps=n_steps, s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL,
        lattice=lattice, interpret=True)
    tw, ts = chaotic_ann.chaotic_ann_gang_bits(
        *[torch.from_numpy(w) for w in ws],
        torch.from_numpy(x0).to(torch.bfloat16), core_map,
        torch.from_numpy(off), row_map, n_steps=n_steps, s_block=S_BLOCK,
        t_block=T_BLOCK, unroll=UNROLL, lattice=lattice)
    rows = chaotic_ann.gang_effective_rows(row_map, n_steps, T_BLOCK, UNROLL)
    np.testing.assert_array_equal(rows, row_map)
    jw, tw = words_of(jw), words_of(tw)
    for g, r in enumerate(rows):
        lanes = slice(g * S_BLOCK, (g + 1) * S_BLOCK)
        np.testing.assert_array_equal(tw[:r, lanes], jw[:r, lanes])
    np.testing.assert_array_equal(bits_of(ts), bits_of(js))
