#!/usr/bin/env python3
"""Which training seeds keep the paper's sweep nets in the attractor box.
Needs a CUDA card.

    python3 tools/sweep_net_seeds.py [OUT_JSON]

Trains the chen 3-H-3 nets of ``chip_smoke.py``'s shapes phase (3-4-3 and
3-16-3 relu, 3-16-3 tanh) on the card with the port's ``train_epoch``, on
phase 10's dataset and recipe (``make_dataset("chen", 50_000)`` on the
card, Adam at lr 3e-3, batches of 256), from several init seeds.  At
every checkpoint epoch it prints the test R2 and the largest |x| of the
generated cores' testbench trajectory: 512 bf16 steps of the plain path
from 4,096 seeds ``uniform(0, 1) - 0.5`` of ``default_rng(0)`` (the
first S_BLOCK of them are each mode's testbench seeds, S_BLOCK <= 4,096).
The testbench passes where that is finite and under 10 (marked ``!``
where it is not).  The table goes to OUT_JSON (default
``chiprun_out/sweep_net_seeds.json``).
"""
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core.ann import (AnnConfig, apply, extract_parameters,  # noqa: E402
                                  init_params, params_from_numpy,
                                  regression_metrics, train_epoch)
from repro_torch.core.chaotic import make_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train.optimizer import Adam  # noqa: E402

# (H, activation, seeds, epochs)
NETS = ((4, "relu", 8, 60), (16, "relu", 6, 45), (16, "tanh", 3, 30))
CHECKPOINTS = (10, 15, 20, 25, 30, 35, 40, 45, 50, 60)
BATCH, LR, LANES, STEPS = 256, 3e-3, 4_096, 512


def main() -> int:
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                       else "chiprun_out/sweep_net_seeds.json")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ds = make_dataset("chen", n_samples=50_000, device=dev)
    print(f"dataset {time.perf_counter() - t0:.1f} s", flush=True)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        0.0, 1.0, (LANES, 3)).astype(np.float32) - np.float32(0.5)).to(
            dev, torch.bfloat16)
    x_test = torch.as_tensor(ds.x_test, device=dev)
    table = {}
    for h_dim, act, n_seeds, n_epochs in NETS:
        cfg = AnnConfig(dim=3, hidden=h_dim, activation=act)
        n_b = len(ds.x_train) // BATCH
        xb, yb = (torch.as_tensor(a[:n_b * BATCH].reshape(n_b, BATCH, -1),
                                  dtype=cfg.dtype, device=dev)
                  for a in (ds.x_train, ds.y_train))
        for seed in range(n_seeds):
            opt = Adam(lr=LR)
            params = init_params(cfg, torch.Generator().manual_seed(seed),
                                 dev)
            state = opt.init(params)
            row = []
            for epoch in range(1, n_epochs + 1):
                params, state, _ = train_epoch(cfg, opt, params, state, xb,
                                               yb)
                if epoch not in CHECKPOINTS:
                    continue
                p = params_from_numpy(extract_parameters(params), device=dev)
                traj = ops.chaotic_trajectory(p, x0, STEPS, activation=act,
                                              backend="ref")
                amax = (float(traj.float().abs().max())
                        if bool(torch.isfinite(traj).all()) else float("inf"))
                with torch.no_grad():
                    r2 = regression_metrics(apply(cfg, params, x_test),
                                            ds.y_test)["r2"]
                row.append((epoch, amax, r2))
            print(f"3-{h_dim}-3 {act} seed {seed}: " + " ".join(
                f"e{e}:{m:.4g}{'' if m < 10 else '!'}/{r:.5f}"
                for e, m, r in row), flush=True)
            table[f"3-{h_dim}-3 {act} seed {seed}"] = row
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(table))
    print(f"total {time.perf_counter() - t0:.1f} s; table in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
