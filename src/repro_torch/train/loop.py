"""Fault-tolerant training loop: checkpoint/restart, preemption handling,
straggler watchdog (port of ``repro/train/loop.py``).

  - resume-from-latest on start (crash/preemption restart is a no-op rerun);
  - SIGTERM/SIGINT triggers an emergency checkpoint at the next step
    boundary;
  - a step-time watchdog flags stragglers: steps slower than
    ``straggler_factor`` x the trailing median, on the injected ``Clock``;
  - each step ends by reading the loss to the host, which waits for the
    device (the JAX loop's ``block_until_ready``), so a step's time is
    its device time too.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.clock import Clock, SystemClock
from repro_torch.train import checkpoint as ckpt

PyTree = Any


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclasses.dataclass
class LoopResult:
    final_state: Any
    metrics_history: List[Dict[str, float]]
    resumed_from: Optional[int]
    straggler_steps: List[int]
    preempted: bool


def _value(v) -> float:
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)


def run(state: PyTree, train_step: Callable, batch_at: Callable[[int], Dict],
        loop_cfg: LoopConfig, put_batch: Optional[Callable] = None,
        log_fn: Callable[[str], None] = print,
        clock: Optional[Clock] = None) -> LoopResult:
    clock = clock or SystemClock()
    resumed_from = None
    if loop_cfg.ckpt_dir:
        latest = ckpt.latest_step(loop_cfg.ckpt_dir)
        if latest is not None:
            state = ckpt.restore(loop_cfg.ckpt_dir, state, step=latest)
            resumed_from = latest
            log_fn(f"[loop] resumed from checkpoint step {latest}")

    preempt = {"flag": False}

    def on_signal(signum, frame):
        preempt["flag"] = True
        log_fn(f"[loop] signal {signum}: emergency checkpoint at next step")

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:           # non-main thread (tests)
            pass

    history: List[Dict[str, float]] = []
    stragglers: List[int] = []
    step_times: List[float] = []
    start = int(state.step) if hasattr(state, "step") else 0

    try:
        for step in range(start, loop_cfg.total_steps):
            t0 = clock.now()
            batch = batch_at(step)
            if put_batch is not None:
                batch = put_batch(batch)
            state, metrics = train_step(state, batch)
            _value(metrics["loss"])          # waits for the device
            dt = clock.now() - t0

            if step_times:
                med = float(np.median(step_times[-20:]))
                if dt > loop_cfg.straggler_factor * med:
                    stragglers.append(step)
                    log_fn(f"[loop] straggler at step {step}: "
                           f"{dt:.3f}s vs median {med:.3f}s")
            step_times.append(dt)

            if step % loop_cfg.log_every == 0:
                m = {k: _value(v) for k, v in metrics.items()}
                m["step"] = step
                m["step_time_s"] = dt
                history.append(m)
                log_fn(f"[loop] step {step} loss {m.get('loss', float('nan')):.4f} "
                       f"({dt * 1e3:.0f} ms)")

            should_ckpt = loop_cfg.ckpt_dir and (
                (step + 1) % loop_cfg.ckpt_every == 0 or preempt["flag"]
                or step + 1 == loop_cfg.total_steps)
            if should_ckpt:
                ckpt.save(loop_cfg.ckpt_dir, step + 1, state, keep=loop_cfg.keep)
            if preempt["flag"]:
                log_fn(f"[loop] preempted at step {step + 1}; state saved")
                break
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    return LoopResult(final_state=state, metrics_history=history,
                      resumed_from=resumed_from, straggler_steps=stragglers,
                      preempted=preempt["flag"])
