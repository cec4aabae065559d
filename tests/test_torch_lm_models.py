"""The port's LM models (``repro_torch.configs``, ``models``) against the
JAX package on the CPU.

Every comparison starts from the JAX model's own parameters
(``repro.models.transformer.init``), carried into the port by
``params_from_jax``, and the same numpy inputs.  Smoke configs
(``get_smoke_config``) in float32 unless a case says bf16.  Tolerances
are stated beside each assertion: float32 forwards agree to about 1e-6
of the logits' largest magnitude, so 1e-5 of it is the bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.tree import flatten_with_paths

ATTN_ARCHS = ("llama3_2_3b", "codeqwen1_5_7b", "gemma_7b", "qwen2_72b",
              "chameleon_34b", "musicgen_large", "mixtral_8x7b",
              "qwen3_moe_30b_a3b")
F32_TOL = 1e-5          # of the largest magnitude, float32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The smoke models are thousands of small tensor ops, which more
    threads only slow down beside JAX's own pool and other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **kw):
    """The JAX and the port smoke config of ``arch``, both replaced by kw."""
    return (dataclasses.replace(jreg.get_smoke_config(arch), **kw),
            dataclasses.replace(treg.get_smoke_config(arch), **kw))


def carried(jcfg, tcfg, seed=0):
    """(JAX params, the port's model holding the same leaves)."""
    params = jtf.init(jcfg, jax.random.PRNGKey(seed))
    return params, ttf.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                       device="cpu")


def batch(cfg, b=2, s=64, seed=0):
    """numpy tokens or stub embeddings, labels and a 0/1 loss mask."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"labels": toks[:, 1:],
           "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if cfg.frontend != "text":
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = toks[:, :-1]
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def close(got, want, tol=F32_TOL, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_equal_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jreg, get)(arch), getattr(treg, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.n_params(), j.n_active_params(), j.resolved_head_dim,
                j.sub_quadratic, j.attention_free) == \
            (t.n_params(), t.n_active_params(), t.resolved_head_dim,
             t.sub_quadratic, t.attention_free)
    from repro.configs.base import shapes_for as jshapes
    from repro_torch.configs.base import shapes_for as tshapes
    assert ([dataclasses.asdict(s) for s in jshapes(jreg.get_config(arch))]
            == [dataclasses.asdict(s) for s in tshapes(treg.get_config(arch))])
    for alias, key in jreg.ALIASES.items():
        assert treg.get_config(alias).name == key


# ---------------------------------------------------------------------------
# Forward and loss: the eight attention-family archs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_and_loss_match_jax(arch):
    """Logits, aux and loss_fn (with a mask) of every attention arch:
    qkv bias (codeqwen, qwen2), qk-norm (chameleon, qwen3), SWA over a
    sequence past its window (mixtral, window 32, 64 tokens), MoE
    (mixtral, qwen3), embed scale + tied (gemma), tied (llama), the stub
    ``embeds`` path (chameleon, musicgen)."""
    jcfg, tcfg = configs(arch, dtype="float32")
    params, model = carried(jcfg, tcfg)
    b = batch(jcfg)
    jb, tb = to_jax(b), to_torch(b)
    jl, jaux = jtf.forward(jcfg, params, jb.get("tokens"),
                           embeds=jb.get("embeds"))
    with torch.no_grad():
        tl, taux = ttf.forward(tcfg, model, tb.get("tokens"),
                               embeds=tb.get("embeds"))
        tloss, tmet = ttf.loss_fn(tcfg, model, tb)
    jloss, jmet = jtf.loss_fn(jcfg, params, jb)
    close(tl, jl, what="logits")
    for k in ("lb_loss", "z_loss"):
        close(taux[k], jaux[k], tol=1e-5, what=k)
    close(tloss, jloss, tol=1e-5, what="loss")
    for k in jmet:
        close(tmet[k], jmet[k], tol=1e-5, what=k)
    assert ("dropped_frac" in taux) == tcfg.is_moe


@pytest.mark.parametrize("arch", ["llama3_2_3b", "gemma_7b"])
def test_forward_bf16_matches_jax(arch):
    """bf16 (the configs' own dtype; gemma's embedding scale rounded to
    it): every op rounds to bf16 on both sides, in orders that differ
    (XLA fuses), so the logits are held to 5% of their largest magnitude
    and the loss to 2%.  (A bf16 MoE is not held here: a gate that rounds
    the other way routes a token to another expert.)"""
    jcfg, tcfg = configs(arch)
    assert tcfg.dtype == "bfloat16"
    params, model = carried(jcfg, tcfg)
    assert model.embed.embedding.dtype == torch.bfloat16
    b = batch(jcfg)
    jl, _ = jtf.forward(jcfg, params, jnp.asarray(b["tokens"]))
    jloss, _ = jtf.loss_fn(jcfg, params, to_jax(b))
    with torch.no_grad():
        tl, _ = ttf.forward(tcfg, model, torch.from_numpy(b["tokens"]))
        tloss, _ = ttf.loss_fn(tcfg, model, to_torch(b))
    assert tl.dtype == torch.bfloat16
    close(tl, jl, tol=5e-2, what="bf16 logits")
    close(tloss, jloss, tol=2e-2, what="bf16 loss")


@pytest.mark.parametrize("arch", ["llama3_2_3b", "mixtral_8x7b"])
def test_grads_match_jax(arch):
    """torch autograd against ``jax.grad`` of ``loss_fn``, leaf for leaf,
    each within 1e-4 of its largest magnitude (float32; mixtral's MoE
    aux losses and SWA in the graph)."""
    jcfg, tcfg = configs(arch, dtype="float32")
    params, model = carried(jcfg, tcfg)
    b = batch(jcfg)
    jgrads = jax.jit(jax.grad(
        lambda p: jtf.loss_fn(jcfg, p, to_jax(b))[0]))(params)
    loss, _ = ttf.loss_fn(tcfg, model, to_torch(b))
    loss.backward()
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, jgrads)))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        close(g, want[k], tol=1e-4, what=k)


def test_remat_and_list_layout_change_nothing():
    """``remat`` (torch.utils.checkpoint around each block) and the list
    layout (``scan_layers=False``) give the scanned model's loss and
    gradients, bitwise."""
    jcfg, tcfg = configs("mixtral_8x7b", dtype="float32")
    params, model = carried(jcfg, tcfg)
    tb = to_torch(batch(jcfg))

    def loss_and_grads(cfg, m):
        loss, _ = ttf.loss_fn(cfg, m, tb)
        names = [k for k, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
        return loss, dict(zip(names, grads))

    base_loss, base = loss_and_grads(tcfg, model)
    rcfg = dataclasses.replace(tcfg, remat=True)
    r_loss, remat = loss_and_grads(rcfg, model)
    assert torch.equal(r_loss, base_loss)
    assert all(torch.equal(remat[k], g) for k, g in base.items())

    lcfg = dataclasses.replace(tcfg, scan_layers=False)
    lmodel = ttf.init(lcfg, device="cpu")
    # the stacked leaves, split into the list layout
    with torch.no_grad():
        for k, p in lmodel.named_parameters():
            if k.startswith("blocks."):
                _, i, rest = k.split(".", 2)
                p.copy_(dict(model.named_parameters())[f"blocks.{rest}"][int(i)])
            else:
                p.copy_(dict(model.named_parameters())[k])
    l_loss, listed = loss_and_grads(lcfg, lmodel)
    assert torch.equal(l_loss, base_loss)
    for k, g in listed.items():
        if k.startswith("blocks."):
            _, i, rest = k.split(".", 2)
            assert torch.equal(g, base[f"blocks.{rest}"][int(i)]), k
        else:
            assert torch.equal(g, base[k]), k


def test_list_layout_decodes_like_the_stacked():
    """``decode_step`` on the list layout gives the stacked model's logits
    and caches, bitwise.  (The JAX ``decode_step`` scans
    ``params["blocks"]`` and raises on the list layout; the port runs it.)"""
    _, tcfg = configs("qwen2_72b", dtype="float32")
    model = ttf.init(tcfg, seed=2, device="cpu")
    lcfg = dataclasses.replace(tcfg, scan_layers=False)
    stacked = dict(model.named_parameters())
    listed = {}
    for k, p in stacked.items():
        if k.startswith("blocks."):
            for i in range(tcfg.n_layers):
                listed[f"blocks.{i}.{k[len('blocks.'):]}"] = p[i]
        else:
            listed[k] = p
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 6)).astype(np.int32))
    a = ttf.init_decode_state(tcfg, 2, 6, device="cpu")
    b = ttf.init_decode_state(lcfg, 2, 6, device="cpu")
    with torch.no_grad():
        for i in range(6):
            la, a = ttf.decode_step(tcfg, model, a, toks[:, i:i + 1])
            lb, b = ttf.decode_step(lcfg, listed, b, toks[:, i:i + 1])
            assert torch.equal(la, lb)
    assert all(torch.equal(a["layers"][k], b["layers"][k]) for k in ("k", "v"))


# ---------------------------------------------------------------------------
# Parameters carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [True, False])
def test_params_from_jax_leaf_for_leaf(scan):
    """Every JAX leaf lands in the port's module under its checkpoint
    path, values, shape and dtype unchanged (bf16 included; the router in
    f32)."""
    jcfg, tcfg = configs("qwen3_moe_30b_a3b", scan_layers=scan)
    params, model = carried(jcfg, tcfg)
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, params)))
    got = dict(model.named_parameters())
    assert list(sorted(got)) == list(sorted(want))
    for k, p in got.items():
        w = want[k]
        assert str(p.dtype).split(".")[1] == w.dtype.name, k
        assert tuple(p.shape) == w.shape, k
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      w.astype(np.float32), err_msg=k)
    router = "blocks.moe.router" if scan else "blocks.0.moe.router"
    assert got[router].dtype == torch.float32


def test_port_init_draws_the_jax_distributions():
    """The port's own init (seeded ``torch.Generator``): the JAX leaf
    names, shapes and dtypes; zero norms and biases; truncated normals
    within 2 sigma of their 1/sqrt(fan-in) scale; the same seed, the same
    weights."""
    jcfg, tcfg = configs("codeqwen1_5_7b")
    params = jtf.init(jcfg, jax.random.PRNGKey(0))
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, params)))
    m1, m2 = ttf.init(tcfg, seed=3, device="cpu"), ttf.init(tcfg, seed=3,
                                                            device="cpu")
    got = dict(m1.named_parameters())
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        assert tuple(p.shape) == want[k].shape and \
            str(p.dtype).split(".")[1] == want[k].dtype.name, k
        assert torch.equal(p, dict(m2.named_parameters())[k]), k
        if "norm" in k or k.split(".")[-1] in ("bq", "bk", "bv"):
            assert not p.detach().float().any(), k
    wq = got["blocks.attn.wq"].detach().float()
    bound = 2.0 * (1.0 / tcfg.d_model) ** 0.5
    assert float(wq.abs().max()) <= bound * 1.01
    assert 0.5 * bound / 2 < float(wq.std()) < bound / 2


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "zamba2_1_2b"])
def test_recurrent_blocks_raise(arch):
    cfg = treg.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        ttf.init(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        ttf.init_decode_state(cfg, 1, 8, device="cpu")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq,kw", [
    ("llama3_2_3b", 12, {}), ("gemma_7b", 12, {}),
    ("qwen3_moe_30b_a3b", 12, {}), ("mixtral_8x7b", 20, {"attn_window": 8})])
def test_decode_matches_jax(arch, seq, kw):
    """``init_decode_state`` and ``decode_step`` token by token against
    the JAX decode: every step's logits and the final caches and position.
    mixtral's window is cut to 8, so its 20 steps wrap the SWA ring cache
    twice."""
    jcfg, tcfg = configs(arch, dtype="float32", **kw)
    params, model = carried(jcfg, tcfg)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, seq)).astype(np.int32)
    jstate = jtf.init_decode_state(jcfg, 2, seq)
    tstate = ttf.init_decode_state(tcfg, 2, seq, device="cpu")
    assert tstate["pos"].dtype == torch.int32 and int(tstate["pos"]) == 0
    for k in ("k", "v"):
        assert tuple(tstate["layers"][k].shape) == jstate["layers"][k].shape
        assert not tstate["layers"][k].any()
    if jcfg.attn_window:
        assert jstate["layers"]["k"].shape[2] == jcfg.attn_window < seq
    step = jax.jit(lambda st, t: jtf.decode_step(jcfg, params, st, t))
    with torch.no_grad():
        for i in range(seq):
            jl, jstate = step(jstate, jnp.asarray(toks[:, i:i + 1]))
            tl, tstate = ttf.decode_step(tcfg, model, tstate,
                                         torch.from_numpy(toks[:, i:i + 1]))
            close(tl, jl, what=f"step {i} logits")
    assert int(tstate["pos"]) == int(jstate["pos"]) == seq
    for k in ("k", "v"):
        close(tstate["layers"][k], jstate["layers"][k], what=f"cache {k}")


def test_moe_decode_drops_nothing():
    """Decode's MoE runs at capacity factor n_experts: dropped_frac 0 even
    where the train-path capacity drops."""
    _, tcfg = configs("qwen3_moe_30b_a3b", dtype="float32",
                      capacity_factor=0.25)
    model = ttf.init(tcfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (4, 16)).astype(np.int32))
    with torch.no_grad():
        _, aux = ttf.forward(tcfg, model, toks)
        assert float(aux["dropped_frac"]) > 0
        state = ttf.init_decode_state(tcfg, 4, 4, device="cpu")
        _, _, daux = ttf.decode_step(tcfg, model, state, toks[:, :1],
                                     return_aux=True)
    assert float(daux["dropped_frac"]) == 0.0


# ---------------------------------------------------------------------------
# Attention, MoE and layer conventions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,kv", [(None, 2), (24, 2), (None, 4)])
def test_flash_equals_plain(monkeypatch, window, kv):
    """The blockwise online-softmax path (threshold and blocks patched to
    16) against the JAX plain path and the port's own plain path, within
    2e-5 (the JAX flash test's bound) of the output's magnitude."""
    d, h, hd = 64, 4, 16
    jdims = jattn.AttnDims(n_heads=h, n_kv_heads=kv, head_dim=hd,
                           window=window)
    tdims = tattn.AttnDims(n_heads=h, n_kv_heads=kv, head_dim=hd,
                           window=window)
    p = jattn.attn_init(jax.random.PRNGKey(0), d, jdims, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal((2, 64, d)).astype(np.float32)
    want = jattn.attn_apply(p, jnp.asarray(x), jdims)
    plain = tattn.attn_apply(tp, torch.from_numpy(x), tdims)
    monkeypatch.setattr(tattn, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(tattn, "FLASH_BLOCK_Q", 16)
    monkeypatch.setattr(tattn, "FLASH_BLOCK_KV", 16)
    calls = []
    real = tattn._flash_attention
    monkeypatch.setattr(tattn, "_flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    flash = tattn.attn_apply(tp, torch.from_numpy(x), tdims)
    assert calls
    close(flash, want, tol=2e-5, what="flash vs JAX plain")
    close(flash, plain, tol=2e-5, what="flash vs port plain")
    # and the JAX flash itself, at the same blocks
    monkeypatch.setattr(jattn, "FLASH_THRESHOLD", 16)
    monkeypatch.setattr(jattn, "FLASH_BLOCK_Q", 16)
    monkeypatch.setattr(jattn, "FLASH_BLOCK_KV", 16)
    close(flash, jattn.attn_apply(p, jnp.asarray(x), jdims), tol=2e-5,
          what="flash vs JAX flash")


@pytest.mark.parametrize("capacity_factor,glu,act", [
    (0.25, False, "relu"), (1.25, True, "silu"), (8.0, True, "gelu")])
def test_moe_router_and_capacity_match_jax(capacity_factor, glu, act):
    """The router in f32, top-k with renormalisation, choice-major
    capacity ranking: the same ``dropped_frac`` (exactly), lb / z losses
    and output within 1e-5 of their magnitudes."""
    d, f, e, k = 32, 64, 8, 2
    p = jmoe.moe_init(jax.random.PRNGKey(0), d, f, e, glu, jnp.float32)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in p.items()}
    x = np.random.default_rng(2).standard_normal((2, 64, d)).astype(np.float32)
    kw = dict(top_k=k, activation=act, glu=glu, group_size=64,
              capacity_factor=capacity_factor)
    jout, jaux = jmoe.moe_apply(p, jnp.asarray(x), **kw)
    tout, taux = tmoe.moe_apply(tp, torch.from_numpy(x), **kw)
    close(tout, jout, what="moe out")
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    if capacity_factor < 1:
        assert float(taux["dropped_frac"]) > 0
    for n in ("lb_loss", "z_loss"):
        close(taux[n], jaux[n], what=n)


def test_moe_bf16_dispatch_parity():
    """bf16 dispatch against f32 dispatch in the port, under the JAX
    test's bound (2% of the output's magnitude + 1e-3), and against the
    JAX bf16 dispatch within 1% of it."""
    d, f, e, k = 32, 64, 8, 2
    p = jmoe.moe_init(jax.random.PRNGKey(0), d, f, e, True, jnp.float32)
    tp = {n: torch.from_numpy(np.array(v)) for n, v in p.items()}
    x = np.random.default_rng(1).standard_normal((2, 64, d)).astype(np.float32)
    kw = dict(top_k=k, activation="silu", glu=True, group_size=64,
              capacity_factor=8.0)
    out32, _ = tmoe.moe_apply(tp, torch.from_numpy(x),
                              dispatch_dtype=torch.float32, **kw)
    out16, _ = tmoe.moe_apply(tp, torch.from_numpy(x),
                              dispatch_dtype=torch.bfloat16, **kw)
    err = float((out32 - out16).abs().max())
    scale = float(out32.abs().max())
    assert err < 0.02 * scale + 1e-3, (err, scale)
    j16, _ = jmoe.moe_apply(p, jnp.asarray(x), dispatch_dtype=jnp.bfloat16,
                            **kw)
    close(out16, j16, tol=1e-2, what="bf16 dispatch vs JAX")


def test_layer_conventions_match_jax():
    """rms_norm (1 + scale, f32), the tanh gelu, RoPE on split halves,
    embedding scale sqrt(d) in the state dtype, tied unembedding: bitwise
    where both sides round once (bf16), else within 1e-6 relative."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jx = jnp.asarray(x).astype(dt)
        tx = torch.from_numpy(x).to(tdt)
        want = jlayers.rms_norm(jx, jnp.asarray(scale).astype(dt), 1e-6)
        got = tlayers.rms_norm(tx, torch.from_numpy(scale).to(tdt), 1e-6)
        close(got, want.astype(jnp.float32),
              tol=1e-6 if tdt == torch.float32 else 1e-2, what="rms_norm")
    pos = np.arange(8, dtype=np.int32)[None, :] + 1000
    close(tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5),
          jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5), tol=1e-6,
          what="rope")
    close(tlayers.activation_fn("gelu")(torch.from_numpy(x)),
          jlayers.activation_fn("gelu")(jnp.asarray(x)), tol=1e-6, what="gelu")
    emb = rng.standard_normal((50, 48)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5)).astype(np.int32)
    jemb = {"embedding": jnp.asarray(emb).astype(jnp.bfloat16)}
    temb = {"embedding": torch.from_numpy(emb).to(torch.bfloat16)}
    want = jlayers.embed_apply(jemb, jnp.asarray(toks), scale=True)
    got = tlayers.embed_apply(temb, torch.from_numpy(toks), scale=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    h = rng.standard_normal((2, 5, 48)).astype(np.float32)
    close(tlayers.unembed_apply({"embedding": torch.from_numpy(emb)},
                                torch.from_numpy(h)),
          jlayers.unembed_apply({"embedding": jnp.asarray(emb)},
                                jnp.asarray(h)), tol=1e-6, what="tied")
