"""Registry-wide PRNG quality gate (port of ``repro/prng/quality.py``).

The paper (§II, citing Yu et al.) claims ANN-based chaotic PRNGs pass the
NIST SP 800-22 suite.  This module sweeps the gate across the weight
registry and both serving dtypes (f32 cores and half-width bf16 cores), so
the farm can *quarantine* a (system, dtype) whose bit quality regresses.

Two gates live here:

* :func:`nist_gate` / :func:`sweep_registry`: the OFFLINE sweep, the full
  7-test subset over ``GATE_WORDS`` freshly generated words per (system,
  dtype), drawn through the serving engine (``ChaoticPRNG``) on the card
  unless the caller passes ``device="cpu"``;
* :func:`online_gate`: the ONLINE monitor, a cheap 3-test subset
  (monobit, block frequency, runs) over a window of words a farm core
  actually *served*.  ``repro_torch.serve.health.HealthMonitor`` feeds it
  and turns verdicts into quarantine + core rotation.

Names, defaults, verdict dicts and sweep keys are the JAX module's: a
``dtype`` is ``"float32"`` / ``"bfloat16"`` or a ``torch.dtype``, and every
result carries the JAX spelling, so a port sweep and a JAX sweep compare
key by key.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.prng.nist import (_to_bits, block_frequency, monobit, runs,
                                   run_nist_subset)
from repro_torch.prng.stream import ChaoticPRNG, default_params

GATE_WORDS = 30_000          # ~0.96 Mbit per gated stream
GATE_ALPHA = 0.01

# Online monitoring: one rolling window of served words per core.  4096
# words = 128 Kbit, enough that a poisoned stream hard-fails monobit in
# ONE window while a healthy stream's per-window soft-failure odds stay
# at the single-test alpha.
ONLINE_WINDOW_WORDS = 4096

# A single NIST test at alpha=0.01 has a ~1% false-positive rate.  A
# (system, dtype) is quarantined only when MORE tests fail than chance
# plausibly explains: >= 2 failed tests out of the 7-test subset, or any
# single test failing catastrophically (p-value below ALPHA_HARD).
ALPHA_HARD = 1e-6
MAX_CHANCE_FAILS = 1

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _dtype_name(dtype) -> str:
    """The JAX spelling (``"float32"`` / ``"bfloat16"``) of a dtype given
    as that string or as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        name = _NAMES.get(dtype)
    else:
        name = str(dtype) if str(dtype) in _DTYPES else None
    if name is None:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    return name


def nist_gate(system: str, dtype="float32", *,
              n_words: int = GATE_WORDS, alpha: float = GATE_ALPHA,
              n_streams: int = 256, seed: int = 0,
              backend: str = "auto", device="cuda") -> Dict[str, object]:
    """Run the NIST subset on one registry (system, dtype) stream.

    Draws through the same fused path the serving stack uses
    (``ChaoticPRNG`` with the registry weights and the requested compute
    dtype), so the gate measures exactly what a farm core would emit.
    """
    name = _dtype_name(dtype)
    eng = ChaoticPRNG(default_params(system=system), n_streams=n_streams,
                      backend=backend, dtype=_DTYPES[name], device=device)
    words, _ = eng.next_words(eng.init(seed=seed), n_words)
    res = run_nist_subset(words, alpha=alpha)
    failed = sorted(k for k, v in res.items() if not v["passed"])
    hard_failed = sorted(k for k, v in res.items()
                         if v["p_value"] < ALPHA_HARD)
    quarantine = len(failed) > MAX_CHANCE_FAILS or bool(hard_failed)
    return {
        "system": system, "dtype": name,
        "n_words": int(n_words),
        "failed_tests": failed, "hard_failed_tests": hard_failed,
        "p_values": {k: v["p_value"] for k, v in res.items()},
        "passed": not failed,
        "quarantined": quarantine,
    }


def online_gate(words: np.ndarray, *,
                alpha: float = GATE_ALPHA) -> Dict[str, object]:
    """Gate ONE rolling window of served words (the online monitor).

    Runs monobit, block frequency and runs over exactly the words given
    (no generation; the caller sampled them off a live core).
    ``failed_tests`` are tests under ``alpha`` (chance-plausible for a
    single window: the caller should demand consecutive failing windows
    before acting), ``hard_failed_tests`` tests under ``ALPHA_HARD`` (act
    immediately).
    """
    words = np.asarray(words, np.uint32).reshape(-1)
    if words.size == 0:
        raise ValueError("online_gate needs a non-empty word window")
    bits = _to_bits(words)
    p_values = {"monobit": monobit(bits),
                "block_frequency": block_frequency(bits),
                "runs": runs(bits)}
    failed = sorted(k for k, v in p_values.items() if v < alpha)
    hard_failed = sorted(k for k, v in p_values.items()
                         if v < ALPHA_HARD)
    return {"n_words": int(words.size), "p_values": p_values,
            "failed_tests": failed, "hard_failed_tests": hard_failed,
            "passed": not failed}


def sweep_registry(systems: Optional[Iterable[str]] = None,
                   dtypes: Iterable = ("float32", "bfloat16"),
                   **gate_kw) -> Dict[str, Dict[str, object]]:
    """Gate every (system, dtype) pair; keys are '<system>/<dtype>'."""
    if systems is None:
        from repro_torch.core.chaotic import SYSTEMS
        systems = sorted(SYSTEMS)
    return {f"{s}/{_dtype_name(d)}": nist_gate(s, d, **gate_kw)
            for s in systems for d in dtypes}


def quarantined_systems(sweep: Dict[str, Dict[str, object]]) -> Dict[str, list]:
    """{system: [dtype, ...]} for every quarantined (system, dtype)."""
    out: Dict[str, list] = {}
    for res in sweep.values():
        if res["quarantined"]:
            out.setdefault(res["system"], []).append(res["dtype"])
    return out
