"""The port's streams: seeding bitwise against JAX, the bf16 stream
bitwise against the JAX engine, and the stream semantics of
``tests/test_stream_api.py`` inside the port (chunk invariance,
state-as-value, counter-based fork), plus the read-only weight registry.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.prng import stream as jstream
from repro_torch.prng import stream
from repro_torch.prng.nist import cross_correlation
from repro_torch.prng.stream import (ChaoticPRNG, ChaoticStream,
                                     _lineage_counter, default_params)


@pytest.fixture(scope="module")
def params():
    return default_params()


def engine(params, **kw):
    return ChaoticPRNG(params, n_streams=128, device="cpu", **kw)


@pytest.mark.parametrize("counter", [0, 7, 123456789, 0xFFFFFFFF])
def test_splitmix_seeds_bitwise(counter):
    want = np.asarray(jstream._splitmix_seeds(
        jnp.asarray(counter, jnp.uint32), 50, 3))
    got = stream._splitmix_seeds(counter, 50, 3).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_lineage_round_rows_burn_in_match_jax():
    for seed in (0, 5, 2 ** 32 + 9):
        for path in ((), (0,), (3, 1), (7, 0, 2)):
            assert (stream._lineage_counter(seed, path)
                    == jstream._lineage_counter(seed, path))
    for n_rows in (1, 3, 4, 5, 63, 64, 127, 128, 129, 1000):
        for t_block in (2, 32, 256):
            assert (stream._round_rows(n_rows, t_block)
                    == jstream._round_rows(n_rows, t_block))
    for b in (0, 2, 16):
        assert stream.effective_burn_in(b) == jstream.effective_burn_in(b) == b
    with pytest.warns(UserWarning):
        assert stream.effective_burn_in(15) == 16
    with pytest.raises(ValueError):
        stream.effective_burn_in(-2)


def test_bf16_stream_bitwise_vs_jax_engine(params):
    """The JAX engine on its Pallas kernel (interpret) and the port's
    engine give the same bf16 words, across two chunked draws."""
    jeng = jstream.ChaoticPRNG(params, n_streams=128,
                               backend="pallas_interpret",
                               dtype=jnp.bfloat16)
    teng = engine(params, dtype=torch.bfloat16)
    js, ts = jeng.init(seed=4), teng.init(seed=4)
    for n in (300, 1000):
        jw, js = jeng.next_words(js, n)
        tw, ts = teng.next_words(ts, n)
        np.testing.assert_array_equal(tw, np.asarray(jw))


@pytest.mark.parametrize("chunks", [[2500], [100, 2400], [1, 1249, 1250],
                                    [337, 1000, 1163]])
def test_chunk_size_invariance(params, chunks):
    eng = engine(params)
    want, _ = eng.next_words(eng.init(seed=3), 2500)
    state = eng.init(seed=3)
    parts = []
    for n in chunks:
        w, state = eng.next_words(state, n)
        parts.append(w)
    np.testing.assert_array_equal(np.concatenate(parts), want)


def test_state_is_a_value_not_a_cursor(params):
    eng = engine(params, dtype=torch.bfloat16)
    _, s1 = eng.next_words(eng.init(seed=5), 777)
    a, _ = eng.next_words(s1, 500)
    b, _ = eng.next_words(s1, 500)
    np.testing.assert_array_equal(a, b)


def test_fork_is_counter_based(params):
    eng = engine(params)
    fresh = eng.init(seed=9)
    _, advanced = eng.next_words(fresh, 5000)
    for a, b in zip(eng.fork(fresh, 2), eng.fork(advanced, 2)):
        np.testing.assert_array_equal(eng.next_words(a, 600)[0],
                                      eng.next_words(b, 600)[0])
        assert a.path == b.path
    assert _lineage_counter(9, (0,)) != _lineage_counter(9, (1,))


def test_fork_streams_uncorrelated(params):
    """Forked streams pass the cross-correlation check (allow 1 failure
    in 6 pair tests, each with ~alpha false-positive rate)."""
    eng = engine(params)
    parent = eng.init(seed=0)
    streams = [eng.next_words(s, 4000)[0]
               for s in [parent] + eng.fork(parent, 3)]
    fails = sum(cross_correlation(streams[i], streams[j])["p_value"] < 0.01
                for i in range(4) for j in range(i + 1, 4))
    assert fails <= 1, fails


def test_chaotic_stream_wrapper(params):
    s = ChaoticStream(params=params, n_streams=64, device="cpu")
    u = s.uniform((500,))
    assert u.dtype == torch.float32 and 0.0 <= u.min() and u.max() < 1.0
    a, b = s.bits(100), s.bits(100)
    assert a.dtype == torch.uint32 and not torch.equal(a, b)
    assert s.permutation(50).sort().values.tolist() == list(range(50))
    assert s.bernoulli(0.5, (10,)).dtype == torch.bool
    kids = s.fork(2)
    assert not torch.equal(kids[0].bits(100), kids[1].bits(100))
    assert dataclasses.asdict(kids[0])["n_streams"] == 64


def test_registry_is_read_only_and_keeps_the_stamp(tmp_path, monkeypatch):
    bundle = stream.trained_oscillator("hyperlorenz")
    assert bundle["w1"].shape == (4, 16)
    with np.load(stream.weights_dir() / "hyperlorenz.npz") as npz:
        assert bundle["recipe_fingerprint"] == str(npz["recipe_fingerprint"])
    assert set(default_params(system="lorenz")) == {"w1", "b1", "w2", "b2"}
    monkeypatch.setenv("REPRO_WEIGHTS_DIR", str(tmp_path))
    assert stream.weights_dir() == tmp_path
    with pytest.raises(FileNotFoundError, match="does not train"):
        stream.trained_oscillator("chen")
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(ValueError):
        stream.trained_oscillator("chen", seed=1)
    # a lattice derives from its base system's file, never trains
    with pytest.raises(FileNotFoundError, match="does not train"):
        stream.trained_oscillator("chen@ring8")
    assert list(tmp_path.iterdir()) == []


def test_engine_defaults_to_the_card():
    """With no ``device`` the engine asks for CUDA and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChaoticPRNG(default_params())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        engine(default_params())              # device="cpu" is fine
