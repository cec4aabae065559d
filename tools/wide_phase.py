#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (lattices of more than 32 nodes) alone,
on one CUDA card.

    python3 tools/wide_phase.py [ROWS.json]   # from the repo root, on a card

Builds the kernel library, starts the phase's shape libraries' parallel
build, then runs ``chip_smoke.phase_wide`` and prints its lines, each with
the card's name and power limit, and writes its ``kernels`` rows to
ROWS.json (default: ``build/wide_rows.json``); exits 1 where a check of
the phase fails.  Part (c)'s tanh and sigmoid chen nets
are seeded He-normal 3-8-3 nets (``core.ann.init_params``), not phase
10's trained ones: the kernels are held to their plain versions on
whatever weights they get.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def seeded_nets():
    """{activation: (numpy bundle, scale, offset)}: a chen 3-8-3 net a
    activation from a seeded generator, unit normalizer."""
    from repro_torch.core.ann import AnnConfig, extract_parameters, init_params
    nets = {}
    for seed, act in enumerate(chip_smoke.PAPER_ACTIVATIONS):
        params = init_params(AnnConfig(dim=3, hidden=8, activation=act),
                             torch.Generator().manual_seed(seed),
                             device="cpu")
        nets[act] = (extract_parameters(params), np.ones(3, np.float32),
                     np.zeros(3, np.float32))
    return nets


def main() -> int:
    if not torch.cuda.is_available():
        print("wide_phase: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build()
    print(f"build {time.perf_counter() - t0:.1f} s")
    wide_build = chip_smoke.WideBuild()
    try:
        rows = chip_smoke.phase_wide(torch, torch.device("cuda", 0), card,
                                     {}, seeded_nets(), wide_build)
    except chip_smoke.SmokeFailure as e:
        print(f"wide_phase FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        wide_build.thread.join()
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                       else ROOT / "build" / "wide_rows.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "kernels": rows}, indent=1))
    print(f"{len(rows)} rows written to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
