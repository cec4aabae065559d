"""Training launcher: wires configs, the data pipeline, the train step and
the fault-tolerant loop for an attention-family arch (port of
``repro/launch/train.py``).

On the card:
  python -m repro_torch.launch.train --arch llama3.2-3b --steps 1000 \\
      --ckpt-dir ckpts

On the CPU, ``--smoke --device cpu``: the reduced config at batch 8,
sequence 64, 2 microbatches, as the JAX launcher's smoke run.  One device
only: ``--mesh multi`` / ``debug`` and ``--sequence-parallel`` need the LM
mesh planner, which is not ported (ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import Adam, warmup_cosine
from repro_torch.train.train_step import (TrainStepConfig, init_train_state,
                                          make_train_step)

# desired gradient-accumulation microbatches per arch for train_4k (a copy
# of ``repro/launch/dryrun.py``'s MICROBATCHES)
MICROBATCHES = {
    "codeqwen1_5_7b": 4, "llama3_2_3b": 4, "gemma_7b": 4, "qwen2_72b": 16,
    "chameleon_34b": 8, "rwkv6_1_6b": 2, "zamba2_1_2b": 4, "mixtral_8x7b": 8,
    "qwen3_moe_30b_a3b": 8, "musicgen_large": 4,
}

NO_MESH = ("{} needs the LM mesh planner (distributed/sharding.py's MeshSpec "
           "and plan_params), not ported yet: ROADMAP.md queue 1 item 7")


def train(cfg, *, global_batch: int, seq_len: int, num_microbatches: int,
          steps: int, lr: float = 3e-4, compress_grads: bool = False,
          chaotic_shuffle: bool = False, ckpt_dir=None, ckpt_every: int = 50,
          log_every: int = 10, device="cuda", log_fn=print):
    """The launcher's run: AdamW (clip 1.0, weight decay 0.01) on a
    warmup-cosine schedule, params from seed 0, the synthetic stream from
    seed 0, through ``loop.run``.  Returns its ``LoopResult``."""
    dev = resolve_device(device)
    opt = Adam(lr=warmup_cosine(lr, min(100, steps // 10 + 1), steps),
               clip_norm=1.0, weight_decay=0.01)
    ts_cfg = TrainStepConfig(num_microbatches=num_microbatches,
                             compress_grads=compress_grads)
    step_fn = make_train_step(cfg, opt, ts_cfg)
    state = init_train_state(cfg, opt, seed=0,
                             use_compression=compress_grads, device=dev)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq_len,
                            global_batch=global_batch, seed=0,
                            use_chaotic_shuffle=chaotic_shuffle,
                            device=str(dev))

    def put_batch(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in b.items()}

    return run(state, step_fn, ds.batch_at,
               LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                          ckpt_every=ckpt_every, log_every=log_every),
               put_batch=put_batch, log_fn=log_fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=("single", "multi", "debug"), default="single")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch")
    ap.add_argument("--sequence-parallel", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--chaotic-shuffle", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "single":
        raise NotImplementedError(NO_MESH.format(f"--mesh {args.mesh}"))
    if args.sequence_parallel:
        raise NotImplementedError(NO_MESH.format("--sequence-parallel"))

    shape = SHAPES[args.shape]
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        global_batch, seq_len, n_mb = 8, 64, 2
    else:
        cfg = get_config(args.arch)
        global_batch, seq_len = shape.global_batch, shape.seq_len
        n_mb = min(MICROBATCHES.get(cfg.name, 1), max(global_batch, 1))

    res = train(cfg, global_batch=global_batch, seq_len=seq_len,
                num_microbatches=n_mb, steps=args.steps, lr=args.lr,
                compress_grads=args.compress_grads,
                chaotic_shuffle=args.chaotic_shuffle, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=args.device)
    print(f"[launch.train] finished at step {int(res.final_state.step)}; "
          f"preempted={res.preempted} stragglers={len(res.straggler_steps)}")
    return res


if __name__ == "__main__":
    main()
