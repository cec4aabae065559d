"""The port's LM training path against the JAX package on the CPU: the
train step, Adam with its schedule, gradient compression, the data
pipeline, checkpoints (either side restores the other's), the loop and
the launcher.

Smoke configs, parameters carried from the JAX init by
``params_from_jax``.  Tolerances are stated beside each assertion.
"""
import dataclasses
import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jpipe
from repro.distributed import compression as jcomp
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.clock import FakeClock
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import compression as tcomp
from repro_torch.models import transformer as ttf
from repro_torch.prng import default_stream
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.tree import flatten_with_paths

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The smoke models are thousands of small tensor ops, which more
    threads only slow down beside JAX's own pool and other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch, **kw):
    return (dataclasses.replace(jreg.get_smoke_config(arch), **kw),
            dataclasses.replace(treg.get_smoke_config(arch), **kw))


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def close(got, want, tol, what=""):
    got, want = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def lm_batch(cfg, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# Optimizer, schedule, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(3e-4, 5, 40), (1e-3, 10, 100, 0.2),
                                  (0.01, 0, 10)])
def test_warmup_cosine_matches_jax(args):
    """Every step of a short schedule (and 3 past its end) against the
    JAX schedule, eager and under jit: float32 in the same order of
    operations, within 5 ulps of the JAX value (XLA's cos, and its fused
    form under jit, round differently)."""
    want = jopt.warmup_cosine(*args)
    got = topt.warmup_cosine(*args)
    steps = np.arange(args[2] + 3)
    vals = np.array([got(int(s)) for s in steps])
    assert vals.dtype == np.float32
    eager = np.array([np.float32(want(jnp.asarray(int(s)))) for s in steps])
    jitted = np.asarray(jax.jit(jax.vmap(want))(jnp.asarray(steps)))
    for ref in (eager, jitted):
        assert (np.abs(vals - ref) <= 5 * np.spacing(ref)).all(), (vals, ref)
    assert vals[0] == 0.0 or args[1] == 0


def test_adam_with_schedule_matches_jax():
    """Three Adam updates (lr read at state.step + 1 from warmup_cosine,
    clipping, weight decay) against the JAX Adam: params and moments
    within 1e-6 of their magnitudes (float32)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": rng.standard_normal(16).astype(np.float32)}
    kw = dict(clip_norm=0.5, weight_decay=0.01)
    jo = jopt.Adam(lr=jopt.warmup_cosine(1e-2, 2, 6), **kw)
    to = topt.Adam(lr=topt.warmup_cosine(1e-2, 2, 6), **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        for k in params:
            close(tp[k], jp[k], 1e-6, f"param {k} step {i}")
            close(ts.mu[k], js.mu[k], 1e-6, f"mu {k}")
            close(ts.nu[k], js.nu[k], 1e-6, f"nu {k}")
    assert ts.step == int(js.step) == 3


def test_compress_grads_matches_jax_bitwise():
    """int8 block quantization with error feedback over three rounds,
    with a shared numpy ``noise_fn`` (leaves of whole 256-blocks, as the
    JAX code requires) and without one (a leaf with a padded last block):
    compensated grads and error buffers bitwise."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 64), "b": (512,), "c": (3, 256)}

    def noise_fn(seed):
        r = np.random.default_rng(seed)
        return lambda n: r.random(n, dtype=np.float32)

    for noisy in (True, False):
        if not noisy:
            shapes["d"] = (3, 50)
        jerr = terr = None
        for rnd in range(3):
            g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2))
                 .astype(np.float32) for k, s in sorted(shapes.items())}
            jg, jerr = jcomp.compress_grads(
                {k: jnp.asarray(v) for k, v in g.items()}, jerr,
                noise_fn=noise_fn(rnd) if noisy else None)
            tg, terr = tcomp.compress_grads(
                {k: torch.from_numpy(v) for k, v in g.items()}, terr,
                noise_fn=noise_fn(rnd) if noisy else None)
            for k in g:
                np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
                np.testing.assert_array_equal(terr[k].numpy(),
                                              np.asarray(jerr[k]))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_2_3b", "mixtral_8x7b"])
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step from the same parameters and batch:
    AdamW on warmup-cosine, clipping, weight decay, int8 compression with
    error feedback, 2 microbatches (row i*2 + j to microbatch j).  The
    metrics (the last microbatch's, with the mean loss and the grad norm)
    and the parameters within 1e-5 of their magnitudes.  The compressed
    gradients (read back from the first moment, mu = 0.1 g, and the
    second, nu = 0.001 g^2, g clipped) and the error buffers: float32
    gradients that
    differ in their last bits put a few values on the other side of a
    rounding step, so each may differ by one int8 step of its leaf's
    largest block (max |g| / 127), and at most 1% of them by more than
    1e-5 of the leaf's magnitude."""
    jcfg, tcfg = configs(arch, dtype="float32")
    kw = dict(clip_norm=1.0, weight_decay=0.01)
    jo = jopt.Adam(lr=jopt.warmup_cosine(3e-3, 1, 10), **kw)
    to = topt.Adam(lr=topt.warmup_cosine(3e-3, 1, 10), **kw)
    jstate = jts.init_train_state(jcfg, jo, jax.random.PRNGKey(0),
                                  use_compression=True)
    model = ttf.params_from_jax(tcfg, jax.tree.map(np.asarray, jstate.params),
                                device="cpu")
    tstate = tts.state_from_params(dict(model.named_parameters()), to,
                                   use_compression=True)
    b = lm_batch(jcfg, 4, 32)
    ts_kw = dict(num_microbatches=2, compress_grads=True)
    jstep = jax.jit(jts.make_train_step(jcfg, jo, jts.TrainStepConfig(**ts_kw)))
    tstep = tts.make_train_step(tcfg, to, tts.TrainStepConfig(**ts_kw))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    tnew, tm = tstep(tstate, {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in b.items()})
    assert set(tm) == set(jm)
    for k in jm:
        close(tm[k], jm[k], 1e-5, k)
    assert tnew.step == int(jnew.step) == 1 and tnew.opt.step == 1
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, jnew)))
    assert set(want) == {k for k, _ in flatten_with_paths(tnew)}
    for k, p in tnew.params.items():
        close(p, want[f"params.{k}"], 1e-5, k)
    # the moments see the clipped gradient, the error buffer the unclipped
    clip = min(1.0, 1.0 / (float(jm["grad_norm"]) + 1e-12))
    for k in tnew.params:
        g_want = want[f"opt.mu.{k}"].astype(np.float64) / 0.1 / clip
        step = np.abs(g_want).max() / 127 * 1.01
        for got, ref in ((tnew.opt.mu[k].numpy() / 0.1 / clip, g_want),
                         (np.sqrt(tnew.opt.nu[k].numpy() / 0.001) / clip,
                          np.sqrt(want[f"opt.nu.{k}"] / 0.001) / clip),
                         (tnew.error_buf[k].numpy(), want[f"error_buf.{k}"])):
            diff = np.abs(got.astype(np.float64) - ref)
            assert diff.max() <= step, (k, diff.max(), step)
            assert (diff > 1e-5 * np.abs(g_want).max()).mean() <= 0.01, k
    # functional: the old state is untouched
    for k, p in tstate.params.items():
        assert torch.equal(p, dict(model.named_parameters())[k].detach())


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def test_dataset_matches_jax_bitwise():
    """Unshuffled batches equal the JAX pipeline's bit for bit."""
    for kw in (dict(vocab_size=256, seq_len=32, global_batch=6, seed=3),
               dict(vocab_size=1000, seq_len=17, global_batch=3, seed=0)):
        j = jpipe.SyntheticLMDataset(**kw)
        t = tpipe.SyntheticLMDataset(**kw, device="cpu")
        np.testing.assert_array_equal(t.successors, j.successors)
        for step in (0, 1, 7):
            jb, tb = j.batch_at(step), t.batch_at(step)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
    jcfg, tcfg = jreg.get_smoke_config("llama3_2_3b"), treg.get_smoke_config(
        "llama3_2_3b")
    jd = jpipe.make_dataset(jcfg, JShape("s", 16, 4, "train"), seed=2)
    td = tpipe.make_dataset(tcfg, TShape("s", 16, 4, "train"), seed=2,
                            device="cpu")
    np.testing.assert_array_equal(td.batch_at(5)["tokens"],
                                  jd.batch_at(5)["tokens"])


def test_chaotic_shuffle_follows_the_ports_own_stream():
    """With the shuffle each batch is the unshuffled batch's rows permuted
    by the next ``default_stream(n_streams=256, seed)`` permutation, in
    call order (so, as in the reference, ``batch_at(step)`` depends on
    the calls before it); two datasets of one seed give the same batches.
    Not held to the JAX batches: the f32 chen stream agrees with JAX's to
    a tolerance, not bitwise, so its words and permutations differ."""
    kw = dict(vocab_size=256, seq_len=8, global_batch=16, seed=0)
    shuffled = tpipe.SyntheticLMDataset(**kw, use_chaotic_shuffle=True,
                                        device="cpu")
    again = tpipe.SyntheticLMDataset(**kw, use_chaotic_shuffle=True,
                                     device="cpu")
    plain = tpipe.SyntheticLMDataset(**kw, device="cpu")
    stream = default_stream(n_streams=256, seed=0, device="cpu")
    moved = 0
    for step in (0, 1, 1):
        got, base = shuffled.batch_at(step), plain.batch_at(step)
        perm = stream.permutation(16).numpy()
        assert sorted(perm) == list(range(16))
        moved += int((perm != np.arange(16)).any())
        twin = again.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], base[k][perm])
            np.testing.assert_array_equal(twin[k], got[k])
    assert moved == 3


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _states(use_compression=True):
    """A JAX and a port train state of the bf16 llama smoke model, with
    other values (the port's after one step)."""
    jcfg, tcfg = configs("llama3_2_3b")
    o = dict(clip_norm=1.0)
    jstate = jts.init_train_state(jcfg, jopt.Adam(**o), jax.random.PRNGKey(0),
                                  use_compression=use_compression)
    to = topt.Adam(**o)
    tstate = tts.init_train_state(tcfg, to, seed=1,
                                  use_compression=use_compression,
                                  device="cpu")
    step = tts.make_train_step(tcfg, to, tts.TrainStepConfig(
        compress_grads=use_compression))
    b = lm_batch(tcfg, 2, 16)
    tstate, _ = step(tstate, {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in b.items()})
    return jstate, tstate


def test_checkpoint_port_saved_jax_restores(tmp_path):
    """A port checkpoint (bf16 params as uint16 bits, f32 moments and
    error buffer, int32 steps) restored by ``repro.train.checkpoint``
    into a JAX train state: every leaf bitwise."""
    jstate, tstate = _states()
    tckpt.save(tmp_path, 1, tstate)
    restored = jckpt.restore(tmp_path, jstate)
    got = dict(flatten_with_paths(jax.tree.map(np.asarray, restored)))
    want = dict(flatten_with_paths(tstate))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, int):
            assert int(g) == w and g.dtype == np.int32, k
        else:
            assert g.dtype.name == str(w.dtype).split(".")[1], k
            np.testing.assert_array_equal(as_np(g), as_np(w), err_msg=k)


def test_checkpoint_jax_saved_port_restores(tmp_path):
    jstate, tstate = _states()
    jckpt.save(tmp_path, 3, jstate)
    restored = tckpt.restore(tmp_path, tstate)
    assert restored.step == 0 and restored.opt.step == 0
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, jstate)))
    for k, g in flatten_with_paths(restored):
        if isinstance(g, torch.Tensor):
            assert str(g.dtype).split(".")[1] == want[k].dtype.name, k
            np.testing.assert_array_equal(as_np(g), as_np(want[k]), err_msg=k)


def test_checkpoint_keep_atomic_and_shape_check(tmp_path):
    _, tstate = _states(use_compression=False)
    for s in (1, 2, 3, 4):
        tckpt.save(tmp_path, s, tstate, keep=2)
    assert tckpt.all_steps(tmp_path) == [3, 4]
    assert tckpt.latest_step(tmp_path) == 4
    assert not list(tmp_path.glob(".tmp_*"))
    bad = tstate._replace(params=dict(
        tstate.params, final_norm=torch.zeros(7, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(tmp_path, bad)
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", tstate)


# ---------------------------------------------------------------------------
# The loop and the launcher
# ---------------------------------------------------------------------------

def _tiny():
    cfg = dataclasses.replace(treg.get_smoke_config("llama3_2_3b"),
                              dtype="float32", n_layers=1)
    opt = topt.Adam(lr=topt.warmup_cosine(1e-3, 1, 4), clip_norm=1.0)
    ds = tpipe.SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, device="cpu")
    step = tts.make_train_step(cfg, opt, tts.TrainStepConfig(
        num_microbatches=2, compress_grads=True))

    def put(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()}

    return (tts.init_train_state(cfg, opt, use_compression=True,
                                 device="cpu"), step, ds.batch_at, put)


def test_loop_resume_exact(tmp_path):
    """Four steps straight against two, a restart, and two more from the
    checkpoint: the same parameters and moments, bitwise."""
    state, step, batch_at, put = _tiny()
    cfg = dict(ckpt_every=2, log_every=1)
    straight = tloop.run(state, step, batch_at, tloop.LoopConfig(
        total_steps=4, **cfg), put_batch=put, log_fn=lambda s: None)
    d = str(tmp_path)
    first = tloop.run(state, step, batch_at, tloop.LoopConfig(
        total_steps=2, ckpt_dir=d, **cfg), put_batch=put, log_fn=lambda s: None)
    assert first.final_state.step == 2 and tckpt.latest_step(d) == 2
    resumed = tloop.run(state, step, batch_at, tloop.LoopConfig(
        total_steps=4, ckpt_dir=d, **cfg), put_batch=put, log_fn=lambda s: None)
    assert resumed.resumed_from == 2 and resumed.final_state.step == 4
    assert [m["step"] for m in resumed.metrics_history] == [2, 3]
    for tree in ("params", "error_buf"):
        for k, v in getattr(straight.final_state, tree).items():
            assert torch.equal(getattr(resumed.final_state, tree)[k], v), k
    for k, v in straight.final_state.opt.mu.items():
        assert torch.equal(resumed.final_state.opt.mu[k], v), k


def test_loop_preemption_and_stragglers(tmp_path):
    """SIGTERM during step 1 saves an emergency checkpoint at step 2 and
    stops; on a FakeClock a step ten times the median is a straggler."""
    state, step, batch_at, put = _tiny()
    clock = FakeClock()
    durations = {0: 1.0, 1: 1.0, 2: 1.0, 3: 10.0, 4: 1.0}

    def timed_step(st, b):
        clock.advance(durations[st.step])
        return step(st, b)

    res = tloop.run(state, timed_step, batch_at, tloop.LoopConfig(
        total_steps=5), put_batch=put, log_fn=lambda s: None, clock=clock)
    assert res.straggler_steps == [3] and not res.preempted

    def preempting_step(st, b):
        if st.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(st, b)

    res = tloop.run(state, preempting_step, batch_at, tloop.LoopConfig(
        total_steps=5, ckpt_dir=str(tmp_path), ckpt_every=100), put_batch=put,
        log_fn=lambda s: None)
    assert res.preempted and res.final_state.step == 2
    assert tckpt.all_steps(tmp_path) == [2]
    assert signal.getsignal(signal.SIGTERM) is not None


def _launch(args, tmp_path):
    script = ("import sys; sys.modules['jax'] = None\n"
              "from repro_torch.launch.train import main\n"
              f"r = main({args!r})\n"
              "print('RESULT', r.final_state.step, r.resumed_from)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path), env=env)


def test_launcher_smoke_and_resume(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu`` (batch
    8 x 64, 2 microbatches, compression, the chaotic shuffle) in a process
    where ``import jax`` fails: 4 steps with checkpoints every 2, then a
    second run to 6 resumes from 4."""
    ck = str(tmp_path / "ck")
    base = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--compress-grads",
            "--chaotic-shuffle"]
    r = _launch(base + ["--steps", "4"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "RESULT 4 None" in r.stdout
    r = _launch(base + ["--steps", "6"], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "RESULT 6 4" in r.stdout


@pytest.mark.parametrize("flags", [["--mesh", "multi"], ["--mesh", "debug"],
                                   ["--sequence-parallel"]])
def test_launcher_refuses_what_needs_the_mesh_planner(flags):
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        main(["--smoke", "--device", "cpu", "--steps", "1"] + flags)


def test_launcher_microbatches_copy_the_reference():
    """Read from the source: importing ``repro.launch.dryrun`` would set
    ``XLA_FLAGS`` for the rest of the process."""
    import ast
    from repro_torch.launch.train import MICROBATCHES as got
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    want = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "MICROBATCHES")
    assert got == want
