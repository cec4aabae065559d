#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py`` (the LM stack) alone, on one CUDA card.

    python3 tools/lm_phase.py          # from the repo root, on a card

Builds the kernel library (the training run's chaotic shuffle launches
K1), then runs ``chip_smoke.phase_lm`` and prints its lines, each with the
card's name and power limit; exits 1 where a check of the phase fails.
"""
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_phase: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    try:
        n = chip_smoke.phase_lm(torch, torch.device("cuda", 0), card)
    except chip_smoke.SmokeFailure as e:
        print(f"lm_phase FAILED: {e}", file=sys.stderr)
        return 1
    print(f"K1 launches in the training run: {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
