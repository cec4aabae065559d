#!/usr/bin/env python3
"""Where the LM stack's time goes on one CUDA card.

    python3 tools/lm_trace.py          # from the repo root, on a card

Three measurements, each line with the card's name and power limit:

- decode: llama3_2_3b at full width and depth (28 layers, bf16, random
  weights from seed 0), 4 prompts of 64 tokens prefilled, then decode
  steps: the synchronised wall of a step, the device's busy time in it
  (``torch.profiler``, the sum of the step's kernel times), its kernel
  launches, and the host's hottest functions (``cProfile``);
- the first ``torch.utils.checkpoint`` call of the process alone, which
  imports ``torch._dynamo``;
- train: llama3_2_3b at full width on 4 layers (bf16, remat), batch 8 x
  512, 2 microbatches, warmup-cosine AdamW, int8 compression, the chaotic
  shuffle, as ``chip_smoke.py`` phase 16 trains it: the first step split
  into data, the train step's own parts (``cProfile``), and a steady
  step's device busy share and top kernels.
"""
from __future__ import annotations

import cProfile
import dataclasses
import io
import pathlib
import pstats
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.utils.checkpoint  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import card_line  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.train.optimizer import Adam, warmup_cosine  # noqa: E402
from repro_torch.train.train_step import (TrainStepConfig,  # noqa: E402
                                          init_train_state, make_train_step)


def device_us(prof) -> tuple:
    """(sum of kernel times in us, kernel launches) of a profile."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time for e in kernels), len(kernels)


def top_kernels(prof, n: int) -> str:
    rows = sorted((e for e in prof.key_averages()
                   if e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)[:n]
    return "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
                     f"x{e.count}" for e in rows)


def host_top(fn, n: int, key: str = "tottime") -> str:
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats(key).print_stats(n)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.strip() and ln.strip()[0].isdigit()]
    return "\n  ".join(lines[:n])


def trace_decode(card: str) -> None:
    cfg = get_config("llama3_2_3b")
    model = tf.init(cfg, seed=0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (4, 64),
                           generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        last, state = engine.prefill(cfg, model, prompt, 96)
        tok = torch.argmax(last, dim=-1)[:, None]

        def step():
            nonlocal state, tok
            logits, state = tf.decode_step(cfg, model, state, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(8):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 8
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                step()
            torch.cuda.synchronize()
        busy, n = device_us(prof)
        print(f"decode llama3_2_3b (28 layers, bf16, 4 sequences): "
              f"{wall * 1e3:.2f} ms a step (8 steps, synchronised); device "
              f"busy {busy / 4 / 1e3:.2f} ms a step ({busy / 4 / 1e3 / (wall * 1e3):.1%} "
              f"of the step), {n // 4} kernel launches a step; top kernels: "
              f"{top_kernels(prof, 6)}; card {card}")
        print(f"decode host, one step, by own time:\n  {host_top(step, 12)}")
    del model, state
    torch.cuda.empty_cache()


def trace_train(card: str) -> None:
    cfg = dataclasses.replace(get_config("llama3_2_3b"), n_layers=4,
                              remat=True)
    opt = Adam(lr=warmup_cosine(3e-4, 1, 4), clip_norm=1.0, weight_decay=0.01)
    step_fn = make_train_step(cfg, opt, TrainStepConfig(
        num_microbatches=2, compress_grads=True))
    state = init_train_state(cfg, opt, seed=0, use_compression=True,
                             device="cuda")
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=512,
                            global_batch=8, use_chaotic_shuffle=True,
                            device="cuda")

    def batch(i):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                for k, v in ds.batch_at(i).items()}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = batch(0)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    out = {}

    def first():
        out["state"], _ = step_fn(state, b)

    t0 = time.perf_counter()
    report = host_top(first, 14, key="cumtime")
    t_first = time.perf_counter() - t0
    print(f"train llama3_2_3b (4 layers, bf16, remat), first step: data "
          f"{t_data * 1e3:.1f} ms, step {t_first * 1e3:.1f} ms (under "
          f"cProfile); card {card}\n  {report}")
    state = out["state"]
    walls = []
    for i in (1, 2):
        b = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
    b = batch(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        float(m["loss"])
        wall = time.perf_counter() - t0
    busy, n = device_us(prof)
    print(f"train steady steps {', '.join(f'{w * 1e3:.1f}' for w in walls)} "
          f"ms; profiled step {wall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({busy / 1e3 / (wall * 1e3):.1%}), {n} kernel "
          f"launches; top kernels: {top_kernels(prof, 10)}; card {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_trace: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.build()                 # K1, which the shuffle launches
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}")
    # the first non-reentrant checkpoint call loads torch._dynamo: a cost
    # that lands in the first remat'd training step of a process
    t0 = time.perf_counter()
    torch.utils.checkpoint.checkpoint(
        torch.sin, torch.zeros(1, device="cuda", requires_grad=True),
        use_reentrant=False)
    print(f"first torch.utils.checkpoint call (imports torch._dynamo): "
          f"{time.perf_counter() - t0:.2f} s; card {card}")
    trace_decode(card)
    trace_train(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
