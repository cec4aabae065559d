"""NIST SP 800-22 subset (paper §II cites Yu et al. passing this suite).

Seven tests implemented from the NIST specification (Rukhin et al., 2001):
monobit frequency, block frequency, runs, longest-run-of-ones, cumulative
sums, serial, and approximate entropy.  Each returns a p-value; a sequence
passes a test at significance alpha=0.01 when p >= alpha.

Pure numpy and scipy (these run on extracted bit streams on the host).
A copy of ``repro/prng/nist.py``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
from scipy import special as sc


def _to_bits(words: np.ndarray) -> np.ndarray:
    """uint32 words -> flat 0/1 bit array (big-endian within each word)."""
    return np.unpackbits(np.ascontiguousarray(words.astype(np.uint32)).view(np.uint8))


def monobit(bits: np.ndarray) -> float:
    n = bits.size
    s = np.abs(2.0 * bits.sum() - n) / math.sqrt(n)
    return float(math.erfc(s / math.sqrt(2.0)))


def block_frequency(bits: np.ndarray, m: int = 128) -> float:
    n = bits.size
    nblocks = n // m
    pi = bits[: nblocks * m].reshape(nblocks, m).mean(axis=1)
    chi2 = 4.0 * m * np.sum((pi - 0.5) ** 2)
    return float(sc.gammaincc(nblocks / 2.0, chi2 / 2.0))


def runs(bits: np.ndarray) -> float:
    n = bits.size
    pi = bits.mean()
    if abs(pi - 0.5) >= 2.0 / math.sqrt(n):
        return 0.0
    v = 1 + int(np.sum(bits[1:] != bits[:-1]))
    num = abs(v - 2.0 * n * pi * (1 - pi))
    den = 2.0 * math.sqrt(2.0 * n) * pi * (1 - pi)
    return float(math.erfc(num / den))


def longest_run(bits: np.ndarray) -> float:
    """Longest-run-of-ones in 128-bit blocks (NIST M=128 variant)."""
    m = 128
    n = bits.size
    nblocks = n // m
    if nblocks < 49:
        m, k_vals, pis = 8, [1, 2, 3, 4], [0.2148, 0.3672, 0.2305, 0.1875]
        nblocks = n // m
    else:
        k_vals = [4, 5, 6, 7, 8, 9]
        pis = [0.1174, 0.2430, 0.2493, 0.1752, 0.1027, 0.1124]
    blocks = bits[: nblocks * m].reshape(nblocks, m)
    longest = np.zeros(nblocks, dtype=np.int64)
    run = np.zeros(nblocks, dtype=np.int64)
    for j in range(m):
        run = (run + 1) * blocks[:, j]
        longest = np.maximum(longest, run)
    counts = np.zeros(len(k_vals), dtype=np.float64)
    for i, k in enumerate(k_vals):
        if i == 0:
            counts[i] = np.sum(longest <= k)
        elif i == len(k_vals) - 1:
            counts[i] = np.sum(longest >= k)
        else:
            counts[i] = np.sum(longest == k)
    exp = nblocks * np.asarray(pis)
    chi2 = np.sum((counts - exp) ** 2 / exp)
    return float(sc.gammaincc((len(k_vals) - 1) / 2.0, chi2 / 2.0))


def cusum(bits: np.ndarray) -> float:
    n = bits.size
    x = 2.0 * bits.astype(np.float64) - 1.0
    s = np.cumsum(x)
    z = np.max(np.abs(s))
    if z == 0:
        return 0.0
    total = 0.0
    for k in range(int((-n / z + 1) // 4), int((n / z - 1) // 4) + 1):
        total += (sc.ndtr((4 * k + 1) * z / math.sqrt(n)) -
                  sc.ndtr((4 * k - 1) * z / math.sqrt(n)))
    for k in range(int((-n / z - 3) // 4), int((n / z - 1) // 4) + 1):
        total -= (sc.ndtr((4 * k + 3) * z / math.sqrt(n)) -
                  sc.ndtr((4 * k + 1) * z / math.sqrt(n)))
    return float(1.0 - total)


def _psi2(bits: np.ndarray, m: int) -> float:
    if m <= 0:
        return 0.0
    n = bits.size
    ext = np.concatenate([bits, bits[: m - 1]]) if m > 1 else bits
    # m-bit pattern index per position
    idx = np.zeros(n, dtype=np.int64)
    for j in range(m):
        idx = (idx << 1) | ext[j: j + n]
    counts = np.bincount(idx, minlength=2 ** m).astype(np.float64)
    return float((2 ** m / n) * np.sum(counts ** 2) - n)


def serial(bits: np.ndarray, m: int = 5) -> float:
    d1 = _psi2(bits, m) - _psi2(bits, m - 1)
    return float(sc.gammaincc(2 ** (m - 2), d1 / 2.0))


def approximate_entropy(bits: np.ndarray, m: int = 4) -> float:
    n = bits.size

    def phi(mm: int) -> float:
        if mm == 0:
            return 0.0
        ext = np.concatenate([bits, bits[:mm - 1]]) if mm > 1 else bits
        idx = np.zeros(n, dtype=np.int64)
        for j in range(mm):
            idx = (idx << 1) | ext[j: j + n]
        counts = np.bincount(idx, minlength=2 ** mm).astype(np.float64)
        c = counts[counts > 0] / n
        return float(np.sum(c * np.log(c)))

    ap_en = phi(m) - phi(m + 1)
    chi2 = 2.0 * n * (math.log(2.0) - ap_en)
    return float(sc.gammaincc(2 ** (m - 1), chi2 / 2.0))


ALL_TESTS = {
    "monobit": monobit,
    "block_frequency": block_frequency,
    "runs": runs,
    "longest_run": longest_run,
    "cusum": cusum,
    "serial": serial,
    "approximate_entropy": approximate_entropy,
}


def cross_correlation(words_a: np.ndarray, words_b: np.ndarray,
                      max_lag: int = 8) -> Dict[str, float]:
    """Independence check between two bit streams (fork-quality gate).

    For each lag in [0, max_lag], correlates the ±1 bit sequences; under
    independence each normalized correlation is ~N(0, 1), so the min p-value
    over lags is Bonferroni-corrected.  Returns {max_abs_corr, p_value}.
    """
    a = 2.0 * _to_bits(np.asarray(words_a)).astype(np.float64) - 1.0
    b = 2.0 * _to_bits(np.asarray(words_b)).astype(np.float64) - 1.0
    n = min(a.size, b.size)
    a, b = a[:n], b[:n]
    worst_z, worst_corr = 0.0, 0.0
    for lag in range(max_lag + 1):
        m = n - lag
        corr = float(np.dot(a[:m], b[lag:lag + m])) / m
        z = abs(corr) * math.sqrt(m)
        if z > worst_z:
            worst_z, worst_corr = z, corr
    p = math.erfc(worst_z / math.sqrt(2.0))
    return {"max_abs_corr": abs(worst_corr),
            "p_value": min(1.0, p * (max_lag + 1))}


def run_nist_subset(words: np.ndarray, alpha: float = 0.01) -> Dict[str, Dict[str, float]]:
    """Run all tests on uint32 words. Returns {test: {p_value, passed}}."""
    bits = _to_bits(np.asarray(words))
    out = {}
    for name, fn in ALL_TESTS.items():
        p = fn(bits)
        out[name] = {"p_value": p, "passed": bool(p >= alpha)}
    return out
