"""Chaotic-oscillator PRNG streams, the NIST test subset and the quality
gates (the exports of ``repro.prng``).

``registry_fingerprint`` is not exported: the JAX one hashes the training
recipe and ``jax.__version__``, and the port never trains, it reads the
committed registry and keeps each file's stamp as it is
(``trained_oscillator``).
"""
from repro_torch.prng.nist import cross_correlation, run_nist_subset
from repro_torch.prng.quality import (nist_gate, quarantined_systems,
                                      sweep_registry)
from repro_torch.prng.stream import (ChaoticPRNG, ChaoticStream, StreamState,
                                     default_params, default_stream,
                                     trained_oscillator)

__all__ = ["ChaoticPRNG", "ChaoticStream", "StreamState", "cross_correlation",
           "default_params", "default_stream", "nist_gate",
           "quarantined_systems", "run_nist_subset", "sweep_registry",
           "trained_oscillator"]
