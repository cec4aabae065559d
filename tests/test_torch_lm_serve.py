"""The port's serving engine (``repro_torch.serve.engine``) and the
forward's prefill state against the JAX package on the CPU.

Smoke configs in float32, parameters carried from the JAX init by
``params_from_jax``.  Logits and caches are held to 1e-5 of their largest
magnitude; greedy tokens must be equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serve import engine as jengine
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serve import engine as tengine

TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The smoke models are thousands of small tensor ops, which more
    threads only slow down beside JAX's own pool and other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(arch, seed=0, **kw):
    jcfg = dataclasses.replace(jreg.get_smoke_config(arch), dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(treg.get_smoke_config(arch), dtype="float32",
                               **kw)
    params = jtf.init(jcfg, jax.random.PRNGKey(seed))
    model = ttf.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, model


def prompt(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


@pytest.mark.parametrize("arch,s,kw", [("llama3_2_3b", 12, {}),
                                       ("mixtral_8x7b", 20, {"attn_window": 8}),
                                       ("qwen3_moe_30b_a3b", 8, {})])
def test_prefill_matches_jax(arch, s, kw):
    """``prefill``'s last logits (from ``forward``) and the decode state
    its replay fills, against the JAX engine's; mixtral's 20-token prompt
    wraps an 8-slot SWA ring."""
    jcfg, tcfg, params, model = setup(arch, **kw)
    toks = prompt(jcfg, 2, s)
    max_len = s + 4
    jl, jst = jax.jit(functools.partial(jengine.prefill, jcfg),
                      static_argnums=2)(params, jnp.asarray(toks), max_len)
    tl, tst = tengine.prefill(tcfg, model, torch.from_numpy(toks), max_len)
    close(tl, jl, what="prefill logits")
    assert int(tst["pos"]) == int(jst["pos"]) == s
    for k in ("k", "v"):
        close(tst["layers"][k], jst["layers"][k], what=k)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "gemma_7b",
                                  "qwen3_moe_30b_a3b"])
def test_greedy_generate_matches_jax(arch):
    """f32 greedy tokens, equal to the JAX engine's."""
    jcfg, tcfg, params, model = setup(arch)
    toks = prompt(jcfg, 2, 8, seed=2)
    want = jax.jit(functools.partial(jengine.greedy_generate, jcfg),
                   static_argnums=(2, 3))(params, jnp.asarray(toks), 6, 16)
    got = tengine.greedy_generate(tcfg, model, torch.from_numpy(toks), 6, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(tengine.greedy_generate(
        tcfg, model, torch.from_numpy(toks), 0, 16).shape) == (2, 0)


@pytest.mark.parametrize("arch,s,kw", [("llama3_2_3b", 16, {}),
                                       ("mixtral_8x7b", 20, {"attn_window": 8})])
def test_forward_return_state_matches_jax(arch, s, kw):
    """``forward(return_state=True)``: logits, aux and the per-layer k/v
    stacked on L (for SWA only the last ``window`` positions) against the
    JAX forward's."""
    jcfg, tcfg, params, model = setup(arch, **kw)
    toks = prompt(jcfg, 2, s, seed=3)
    jl, jaux, jst = jtf.forward(jcfg, params, jnp.asarray(toks),
                                return_state=True)
    with torch.no_grad():
        tl, taux, tst = ttf.forward(tcfg, model, torch.from_numpy(toks),
                                    return_state=True)
    close(tl, jl, what="logits")
    for k in ("lb_loss", "z_loss"):
        close(taux[k], jaux[k], what=k)
    for k in ("k", "v"):
        close(tst[k], jst[k], what=k)
    if jcfg.attn_window:
        assert tst["k"].shape[2] == jcfg.attn_window < s


def test_serve_step_and_last_only():
    """``make_serve_step`` is ``decode_step``; ``forward(last_only=True)``
    is the full forward's last position; the replay's last decode logits
    agree with the forward's within 1e-5 (f32)."""
    _, tcfg, _, model = setup("codeqwen1_5_7b")
    toks = torch.from_numpy(prompt(tcfg, 3, 10, seed=4))
    serve = tengine.make_serve_step(tcfg)
    state = ttf.init_decode_state(tcfg, 3, 12, device="cpu")
    with torch.no_grad():
        full, _ = ttf.forward(tcfg, model, toks)
        last, _ = ttf.forward(tcfg, model, toks, last_only=True)
        for t in range(10):
            want, want_state = ttf.decode_step(tcfg, model, state,
                                               toks[:, t:t + 1])
            lg, state = serve(model, state, toks[:, t:t + 1])
            assert torch.equal(lg, want)
            assert all(torch.equal(state["layers"][k], want_state["layers"][k])
                       for k in ("k", "v"))
    assert last.shape == (3, 1, tcfg.vocab_size)
    close(last[:, 0], full[:, -1].numpy(), what="last_only")
    close(lg[:, 0], full[:, -1].numpy(), what="replay vs forward")
