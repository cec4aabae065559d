"""The port's word-quality gates (``repro_torch.prng.quality``) and the rest
of ``repro_torch.prng`` on the CPU, held against the JAX package.

* ``online_gate``: the same verdict dict as the JAX gate on the same
  seeded windows (healthy, poisoned, biased, short), at two alphas, and
  on the windows of one client of the committed bf16 farm, whose lanes
  coalesce until both gates fail it.
* ``nist_gate`` words: in bf16 bitwise the JAX engine's (Pallas in
  interpret mode, t_block 4 / unroll 1) on a cut of rows; in f32 the
  burned-in state within the north star's 16-step free-run tier
  (``1e-4 * max(1, max|x|)``), since f32 words are not bitwise.
* Verdicts at the JAX test's 20,000 words (``tests/test_nist_sweep.py``,
  the JAX engine in interpret mode): every (system, dtype) pair's failed
  tests, hard failures and quarantine equal the JAX gate's, and in bf16
  the p-values too.  The reference quarantines bf16 rossler
  (``test_bf16_registry_stream_not_quarantined[rossler]`` fails on the JAX
  package); the port must return the same, not a clean pass.
* ``sweep_registry`` / ``quarantined_systems``: keys ``<system>/<dtype>``
  as JAX builds them, and the same quarantine map.
* ``draw_words`` (the legacy one-shot draw through K2 + the packing
  stage), ``default_stream`` and the package exports.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.chaotic import SYSTEMS
from repro_torch.prng import quality
from repro_torch.prng.quality import (ALPHA_HARD, nist_gate, online_gate,
                                      quarantined_systems, sweep_registry)
from repro_torch.prng.stream import ChaoticPRNG, default_params

SWEEP_WORDS = 20_000                  # tests/test_nist_sweep.py's GATE_KW
JAX_GATE_KW = dict(n_words=SWEEP_WORDS, backend="pallas_interpret")
DTYPES = ("float32", "bfloat16")
PAIRS = [(s, d) for s in sorted(SYSTEMS) for d in DTYPES]
VERDICT_KEYS = ("system", "dtype", "n_words", "failed_tests",
                "hard_failed_tests", "passed", "quarantined")

_SWEEPS = {}


def _pair(system, dtype):
    """(port gate, JAX gate) at the JAX test's recipe, computed once."""
    key = (system, dtype)
    if key not in _SWEEPS:
        from repro.prng.quality import nist_gate as jax_nist_gate
        _SWEEPS[key] = (nist_gate(system, dtype, n_words=SWEEP_WORDS,
                                  device="cpu"),
                        jax_nist_gate(system, dtype, **JAX_GATE_KW))
    return _SWEEPS[key]


def _windows():
    rng = np.random.default_rng(2024)
    good = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    biased = good.copy()
    biased[::5] |= np.uint32(0x00FF00FF)
    return {"healthy": good,
            "poisoned": good & np.uint32(0xFFFF0000),
            "biased": biased,
            "short": good[:256],
            "constant": np.zeros(512, np.uint32)}


# ---------------------------------------------------------------------------
# The online gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [quality.GATE_ALPHA, 0.2])
@pytest.mark.parametrize("name", list(_windows()))
def test_online_gate_equals_jax(name, alpha):
    from repro.prng.quality import online_gate as jax_online_gate
    words = _windows()[name]
    got = online_gate(words, alpha=alpha)
    assert got == jax_online_gate(words, alpha=alpha)
    if name in ("poisoned", "constant"):
        assert "monobit" in got["hard_failed_tests"]
    if name == "healthy" and alpha == quality.GATE_ALPHA:
        assert got["passed"]


def test_online_gate_refuses_an_empty_window():
    with pytest.raises(ValueError, match="non-empty"):
        online_gate(np.empty(0, np.uint32))


def test_constants_equal_jax():
    from repro.prng import quality as jq
    for name in ("GATE_WORDS", "GATE_ALPHA", "ONLINE_WINDOW_WORDS",
                 "ALPHA_HARD", "MAX_CHANCE_FAILS"):
        assert getattr(quality, name) == getattr(jq, name), name


@pytest.mark.parametrize("core,seed", [("chua", 8000), ("rossler", 11000)])
def test_committed_farm_windows_degrade_as_jax(core, seed):
    """One client of the committed bf16 farm drawing 1,024 words a flush,
    as a tenant of the serving tier does: its words bitwise the JAX
    farm's, and each 4,096-word window's online verdict equal to the JAX
    gate's.  The client's lanes coalesce within about 40,000 words, and
    both gates fail a late window: the reference's own verdict."""
    from pathlib import Path

    from repro.prng.quality import online_gate as jax_online_gate
    from repro.serve.farm import OscillatorFarm as JaxFarm
    from repro_torch.serve.farm import OscillatorFarm

    farm_dir = (Path(__file__).resolve().parents[1] / "results"
                / "generated_cores" / "farm")
    farms = (OscillatorFarm.from_generated(farm_dir, cores=(core,),
                                           device="cpu"),
             JaxFarm.from_generated(farm_dir, cores=(core,),
                                    backend="pallas_interpret"))
    words = ([], [])
    for f, out in zip(farms, words):
        f.register(core, "c", seed=seed)
        for _ in range(40):
            f.request(core, "c", 1024)
            out.append(np.asarray(f.flush()[core]["c"]))
    got, want = np.concatenate(words[0]), np.concatenate(words[1])
    assert np.array_equal(got, want)
    verdicts = []
    for i in range(0, got.size, 4096):
        verdict = online_gate(got[i:i + 4096])
        assert verdict == jax_online_gate(want[i:i + 4096])
        verdicts.append(verdict["passed"])
    assert verdicts[0] and not all(verdicts[-3:])
    # the mechanism: the last row's 128 lanes hold repeated words
    assert len(set(got[-128:].tolist())) < 100


# ---------------------------------------------------------------------------
# The offline gate's words against the JAX engine
# ---------------------------------------------------------------------------

CUT_WORDS = 256 * 6


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_gate_words_bf16_bitwise_vs_jax(system):
    """The gate's recipe (256 fresh lanes, seed 0) in bf16: the first six
    word rows bitwise the JAX engine's, Pallas in interpret mode."""
    import jax.numpy as jnp
    from repro.core.dse import Candidate
    from repro.prng.stream import ChaoticPRNG as JaxPRNG
    params = default_params(system=system)
    i_dim, h_dim = params["w1"].shape
    cfg = Candidate(i_dim=i_dim, h_dim=h_dim, p=1, compute_unit="vpu",
                    dtype_bytes=2, unroll=1, t_block=4)
    jeng = JaxPRNG(params, n_streams=256, backend="pallas_interpret",
                   dtype=jnp.bfloat16, config=cfg)
    jw, _ = jeng.next_words(jeng.init(seed=0), CUT_WORDS)
    teng = ChaoticPRNG(params, n_streams=256, dtype=torch.bfloat16,
                       device="cpu")
    tw, _ = teng.next_words(teng.init(seed=0), CUT_WORDS)
    np.testing.assert_array_equal(tw, np.asarray(jw))


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_gate_state_f32_within_tier_of_jax(system):
    """In f32 the words are not bitwise across frameworks; the gate's
    burned-in state (16 steps from the same seeds) stays within the
    north star's free-run tier of the JAX engine's."""
    from repro.prng.stream import ChaoticPRNG as JaxPRNG
    params = default_params(system=system)
    jx = np.asarray(JaxPRNG(params, n_streams=256,
                            backend="pallas_interpret").init(seed=0).x)
    tx = ChaoticPRNG(params, n_streams=256,
                     device="cpu").init(seed=0).x.numpy()
    tol = 1e-4 * max(1.0, float(np.abs(jx).max()))
    assert float(np.abs(tx - jx).max()) <= tol


# ---------------------------------------------------------------------------
# Verdicts at the JAX test's 20,000 words
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("system,dtype", PAIRS,
                         ids=[f"{s}-{d}" for s, d in PAIRS])
def test_gate_verdict_equals_jax(system, dtype):
    got, ref = _pair(system, dtype)
    assert {k: got[k] for k in VERDICT_KEYS} == \
        {k: ref[k] for k in VERDICT_KEYS}, (got, ref)
    assert set(got["p_values"]) == set(ref["p_values"])
    if dtype == "bfloat16":              # bitwise words: equal p-values
        assert got["p_values"] == ref["p_values"]
    if dtype == "float32":               # the paper's claim, both sides
        assert not got["quarantined"]
    if (system, dtype) == ("rossler", "bfloat16"):
        assert got["quarantined"]        # what the reference returns


def test_sweep_registry_keys_and_quarantine_map_equal_jax():
    """``sweep_registry`` over the five systems in both dtypes: keys
    ``<system>/<dtype>`` as the JAX sweep builds them, each entry the
    per-pair gate, and ``quarantined_systems`` of the two sweeps equal
    (bf16 rossler alone)."""
    from repro.prng.quality import quarantined_systems as jax_quarantined
    sweep = sweep_registry(n_words=SWEEP_WORDS, device="cpu")
    jax_sweep = {f"{s}/{d}": _pair(s, d)[1] for s, d in PAIRS}
    assert list(sweep) == list(jax_sweep)
    for key, res in sweep.items():
        assert res == _pair(res["system"], res["dtype"])[0], key
    assert quarantined_systems(sweep) == jax_quarantined(jax_sweep) == {
        "rossler": ["bfloat16"]}


def test_sweep_accepts_torch_dtypes_and_keeps_the_jax_spelling():
    sweep = sweep_registry(["chen"], (torch.float32, torch.bfloat16),
                           n_words=2_048, device="cpu")
    assert list(sweep) == ["chen/float32", "chen/bfloat16"]
    assert [r["dtype"] for r in sweep.values()] == ["float32", "bfloat16"]
    assert sweep["chen/bfloat16"] == nist_gate("chen", "bfloat16",
                                               n_words=2_048, device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        nist_gate("chen", torch.float16, n_words=64, device="cpu")


def test_quarantine_policy_mechanism():
    """``quarantined_systems`` collects exactly the quarantined pairs, and
    a constant stream hard-fails under the gate's scoring rule (as in
    ``tests/test_nist_sweep.py``)."""
    from repro_torch.prng.nist import run_nist_subset
    sweep = {
        "a/float32": {"system": "a", "dtype": "float32",
                      "quarantined": False},
        "a/bfloat16": {"system": "a", "dtype": "bfloat16",
                       "quarantined": True},
        "b/bfloat16": {"system": "b", "dtype": "bfloat16",
                       "quarantined": True},
    }
    assert quarantined_systems(sweep) == {"a": ["bfloat16"],
                                          "b": ["bfloat16"]}
    res = run_nist_subset(np.zeros(10_000, np.uint32))
    assert [k for k, v in res.items() if v["p_value"] < ALPHA_HARD]


def test_gate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nist_gate("chen", n_words=64)


# ---------------------------------------------------------------------------
# The rest of prng/: draw_words, default_stream, the exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_words,n_streams,burn_in",
                         [(1_000, 64, 16), (77, 128, 0), (4_096, 256, 8)])
def test_draw_words_packs_the_trajectory_as_jax_does(n_words, n_streams,
                                                     burn_in):
    """The legacy one-shot draw: its words are the JAX packing stage
    (``ops.bits_from_trajectory``, burn-in rows dropped, lanes
    interleaved, cut to ``n_words``) of the port's K2 trajectory, bit for
    bit, and that trajectory is within the f32 free-run tier of the JAX
    ``draw_words``' over the first 16 steps."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    from repro_torch.prng.stream import _splitmix_seeds, draw_words
    p = default_params(system="lorenz")
    words = draw_words(p["w1"], p["b1"], p["w2"], p["b2"], 0x1234_5678,
                       n_words, n_streams, burn_in, "relu", "auto",
                       device="cpu")
    assert words.dtype == torch.uint32 and words.shape == (n_words,)
    params = {k: torch.as_tensor(v) for k, v in p.items()}
    x0 = _splitmix_seeds(0x1234_5678, n_streams, 3)
    steps = max(2 * (-(-n_words // n_streams)) + 2 * burn_in, 4)
    traj = ops.chaotic_trajectory(params, x0, steps)
    ref = jops.bits_from_trajectory(jnp.asarray(traj.numpy())[2 * burn_in:])
    np.testing.assert_array_equal(
        words.view(torch.int32).numpy().view(np.uint32),
        np.asarray(ref).reshape(-1)[:n_words])
    free = min(16, steps)
    jtraj = np.asarray(jops.chaotic_trajectory(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x0.numpy()),
        free, backend="pallas_interpret"))
    tol = 1e-4 * max(1.0, float(np.abs(jtraj).max()))
    assert float(np.abs(traj[:free].numpy() - jtraj).max()) <= tol


def test_default_stream_is_the_registry_chen_stream():
    from repro_torch.prng import default_stream
    s = default_stream(n_streams=64, device="cpu")
    eng = ChaoticPRNG(default_params(), n_streams=64, device="cpu")
    want, _ = eng.next_words(eng.init(0), 500)
    np.testing.assert_array_equal(s.bits(500).numpy(), want)
    r = default_stream(n_streams=64, system="rossler", device="cpu")
    assert not np.array_equal(r.bits(500).numpy(), want)


def test_prng_exports_equal_jax_but_the_fingerprint():
    """``repro_torch.prng`` exports what ``repro.prng`` exports, except
    ``registry_fingerprint`` (a hash of the JAX training recipe and
    ``jax.__version__``; the port never trains)."""
    import repro.prng as jp
    import repro_torch.prng as tp
    assert set(tp.__all__) == set(jp.__all__) - {"registry_fingerprint"}
    for name in tp.__all__:
        assert callable(getattr(tp, name)), name
    assert not hasattr(tp, "registry_fingerprint")
