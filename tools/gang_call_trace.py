#!/usr/bin/env python3
"""Every device operation of one scalar gang call, from a ``torch.profiler``
trace: what a K3/K4 call puts on the card beside its kernel.  Needs a CUDA
card and nvcc.

    python3 tools/gang_call_trace.py ROOT LABEL

ROOT is a checkout of the repo (its ``src/repro_torch`` is imported and its
kernels built there), LABEL names it in the output, so that a parent
commit unpacked into a git-ignored directory and the working tree can be
traced in turns in one call, each in its own process.  The calls, on the
four 3-8-3 registry nets at the farm's flush shapes (as
``tools/kernel_times.py``), relu, f32 and bf16, with int64 offsets on the
card as the farm passes them: K4 at F1 (4 x 16,384 lanes, 128 rows) and K3
at F3 (513 blocks of 128 lanes, 128 rows).  Each call is warmed up, then
traced three times queued behind a device spin (as ``chip_smoke.py``'s
``cuda_ms`` times it); the output lists each device operation of the
third call (kernels, copies, sets) with its time, the gaps between them,
and the call's span on the device, first start to last end.  The chrome
traces go to ``build/gang_call_trace/`` under the current directory
(git-ignored).
"""
import json
import pathlib
import subprocess
import sys

import numpy as np

KEYS = ("w1", "b1", "w2", "b2")
BASES = ("chen", "chua", "lorenz", "rossler")
POOL = 16_384
SPIN_CYCLES = 50_000_000      # about 25 ms at 1.98 GHz: the calls queue
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_ops(trace_path: pathlib.Path):
    """The trace's device operations, (start us, duration us, name), in
    order of start."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    ops = [(float(e["ts"]), float(e.get("dur", 0)), e["name"])
           for e in events if e.get("cat") in DEVICE_CATS]
    return sorted(ops)


def main() -> int:
    root, label = pathlib.Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, chaotic_ann
    from repro_torch.prng.stream import default_params

    dev = torch.device("cuda", 0)
    build.build()
    per = [default_params(system=s) for s in BASES]
    w = [torch.as_tensor(np.stack([p[k] for p in per]), device=dev)
         for k in KEYS]
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (4 * POOL + 128, 3)),
                        dtype=torch.float32, device=dev)
    off = torch.zeros(x.shape[0], dtype=torch.int64, device=dev)
    cm_f3 = np.repeat(np.arange(4), [128, 128, 129, 128])
    out_dir = pathlib.Path("build") / "gang_call_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{label}: card {card}")
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xx = x.to(dtype)
        calls = {
            "K4 F1": lambda: chaotic_ann.chaotic_ann_gang_stacked(
                *w, xx[:4 * POOL].reshape(4, POOL, 3),
                off[:4 * POOL].reshape(4, POOL), n_steps=256),
            "K3 F3": lambda: chaotic_ann.chaotic_ann_gang_bits(
                *w, xx, cm_f3, off, n_steps=256, s_block=128, t_block=256,
                unroll=8)}
        for name, fn in calls.items():
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(SPIN_CYCLES)
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            path = out_dir / (f"{label.replace('/', '_')}_{tag}_"
                              f"{name.replace(' ', '_')}.json")
            prof.export_chrome_trace(str(path))
            ops = [op for op in device_ops(path)
                   if "sleep" not in op[2].lower()]
            if not ops:
                print(f"  {tag} {name}: the trace holds no device operation")
                continue
            per_call = len(ops) // 3
            last = ops[-per_call:]
            print(f"  {tag} {name}: {len(ops)} device ops in 3 calls; the "
                  f"third call's span {last[-1][0] + last[-1][1] - last[0][0]:.2f} "
                  f"us, its ops {sum(d for _, d, _ in last):.2f} us:")
            prev_end = None
            for ts, dur, op in last:
                gap = "" if prev_end is None else f" (gap {ts - prev_end:.2f} us)"
                print(f"    {dur:8.2f} us{gap} {op[:110]}")
                prev_end = ts + dur
    return 0


if __name__ == "__main__":
    sys.exit(main())
