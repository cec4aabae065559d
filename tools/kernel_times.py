#!/usr/bin/env python3
"""Times a fixed set of the port's CUDA kernels from one checkout, so that two
commits can be compared on one card in one call.  Needs a CUDA card and nvcc.

    python3 tools/kernel_times.py ROOT LABEL

ROOT is a checkout of the repo (its ``src/repro_torch`` is imported and its
kernels built there); LABEL names it in the output.  To compare a parent
commit with the working tree, unpack the parent into a git-ignored
directory and run the two in turns, each in its own process:

    git archive <parent> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 tools/kernel_times.py $t $t; done

Each kernel at its path's shape (65,536 lanes; the lattice kernels x 256
steps, the mxu kernels x 64 steps, the 3-8-3 mxu K3 and the scalar
kernels x 256 and 1,024 steps), on the registry weights, by CUDA events
after a device spin (as ``chip_smoke.py``'s ``cuda_ms``): the lattice
K4 / K3 / K1 at chen@ring8 (the four bases as lattices of one descriptor)
in f32 and bf16 with relu, tanh and sigmoid, and at chen@ring32 in f32
and bf16 with relu; the f32 lattice K1 at chen@ring32 with each
activation; the bf16 lattice K2 at chen@ring32
(relu) and chen@ring8 (tanh, sigmoid), the f32 one at chen@ring8 (tanh,
sigmoid); the mxu
K3 at chen@ring32 (four cores, s_block 128) in f32 and bf16 with each
activation; the mxu K3 of the four 3-8-3 nets at s_block 128 (half its
two-lane kernel's lane slots without a lane b); the mxu K1 and K2 at
chen@ring32 in f32 and bf16 with each activation, the mxu K2 at
chen@ring8 in bf16 with tanh and sigmoid (the generated min-latency
cores' ``generate``); the scalar K1 and K2 at chen in f32 and bf16 with
each activation; the scalar K3 and K4 of the four 3-8-3 nets at the
farm's flush shapes (128 clients x 128 lanes a core, s_block 128, t_block
256, unroll 8) in f32 and bf16 with each activation: K4 at F1 (4 x 16,384
lanes, 128 rows each), K3 at F3 (one more lorenz client: 513 blocks, 128
rows) and at F2 (chen's blocks 512 rows, the others' 8).
"""
import pathlib
import subprocess
import sys
import time

import numpy as np

KEYS = ("w1", "b1", "w2", "b2")
BASES = ("chen", "chua", "lorenz", "rossler")
LANES = 65_536
SPIN_CYCLES = 50_000_000      # about 25 ms at 1.98 GHz: the calls queue


def cuda_ms(torch, fn, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    root, label = pathlib.Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
    from repro_torch.kernels import build, chaotic_ann
    from repro_torch.prng.stream import default_params

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.build()
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    bf16 = torch.bfloat16
    out = {}

    def stacked(systems):
        per = [default_params(system=s) for s in systems]
        return per, [torch.as_tensor(np.stack([p[k] for p in per]),
                                     device=dev) for k in KEYS]

    offs = torch.zeros((4, LANES // 4), dtype=torch.int64, device=dev)
    off = offs.reshape(-1)
    cmap = np.repeat(np.arange(4), LANES // 4 // 256)
    for topo, acts in (("ring8", ("relu", "tanh", "sigmoid")),
                       ("ring32", ("relu",))):
        per, w = stacked([f"{b}@{topo}" for b in BASES])
        lat = lattice_meta_tuple(per[0]["lattice_meta"])
        i_dim = per[0]["w1"].shape[0]
        xs_f = torch.as_tensor(rng.uniform(-0.9, 0.9,
                                           (4, LANES // 4, i_dim)),
                               dtype=torch.float32, device=dev)
        for tag, dtype in (("f32", torch.float32), ("bf16", bf16)):
            xs = xs_f.to(dtype)
            x = xs.reshape(-1, i_dim).contiguous()
            if (topo, tag) == ("ring8", "bf16"):
                x8 = x                      # the mxu K2 at ring8 below
            for act in acts:
                kw = dict(n_steps=256, lattice=lat, activation=act)
                out[f"{tag} lattice K4 chen@{topo} {act}, 4 x 16,384 "
                    f"lanes"] = cuda_ms(
                    torch, lambda: chaotic_ann.chaotic_ann_gang_stacked(
                        *w, xs, offs, **kw))
                out[f"{tag} lattice K3 chen@{topo} {act}, s_block 256"] = (
                    cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
                        *w, x, cmap, off, s_block=256, t_block=256, unroll=8,
                        **kw)))
                out[f"{tag} lattice K1 chen@{topo} {act} (chen)"] = cuda_ms(
                    torch, lambda: chaotic_ann.chaotic_ann_bits(
                        *[a[0] for a in w], x, off, **kw))
    p32 = params_from_numpy(default_params(system="chen@ring32"), device=dev)
    x32 = torch.as_tensor(rng.uniform(-0.9, 0.9, (LANES, 96)),
                          dtype=torch.float32, device=dev)
    for act in ("relu", "tanh", "sigmoid"):
        out[f"f32 lattice K1 chen@ring32 {act}"] = cuda_ms(
            torch, lambda: chaotic_ann.chaotic_ann_bits(
                *[p32[k] for k in KEYS], x32, off, n_steps=256,
                activation=act,
                lattice=lattice_meta_tuple(p32["lattice_meta"])))
    for tag, system, act in (("bf16", "chen@ring32", "relu"),
                             ("bf16", "chen@ring8", "tanh"),
                             ("bf16", "chen@ring8", "sigmoid"),
                             ("f32", "chen@ring8", "tanh"),
                             ("f32", "chen@ring8", "sigmoid")):
        p = params_from_numpy(default_params(system=system), device=dev)
        w1 = [p[k] for k in KEYS]
        x1 = torch.as_tensor(rng.uniform(-0.9, 0.9, (LANES, w1[0].shape[0])),
                             dtype=torch.float32, device=dev)
        x1 = x1.to(bf16) if tag == "bf16" else x1
        kw = dict(n_steps=256, activation=act,
                  lattice=lattice_meta_tuple(p["lattice_meta"]))
        out[f"{tag} lattice K2 {system} {act}"] = cuda_ms(
            torch, lambda: chaotic_ann.chaotic_ann_traj(*w1, x1, **kw),
            reps=3)
    per, wm = stacked([f"{b}@ring32" for b in BASES])
    mkw = dict(s_block=128, t_block=256, unroll=8, compute_unit="mxu",
               lattice=lattice_meta_tuple(per[0]["lattice_meta"]),
               coupling=torch.as_tensor(per[0]["coupling"], device=dev))
    cm = np.repeat(np.arange(4), LANES // 4 // 128)
    offm = torch.zeros(LANES, dtype=torch.int64, device=dev)
    xm = torch.as_tensor(rng.uniform(-0.9, 0.9, (LANES, 96)),
                         dtype=torch.float32, device=dev)
    for tag, dtype in (("f32", torch.float32), ("bf16", bf16)):
        xx = xm.to(dtype)
        for act in ("relu", "tanh", "sigmoid"):
            out[f"{tag} mxu K3 chen@ring32 {act}"] = cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
                    *wm, xx, cm, offm, n_steps=64, activation=act, **mkw))
    _, ws = stacked(BASES)
    x3 = torch.as_tensor(rng.uniform(-0.9, 0.9, (LANES, 3)),
                         dtype=torch.float32, device=dev)
    for tag, dtype in (("f32", torch.float32), ("bf16", bf16)):
        xx = x3.to(dtype)
        out[f"{tag} mxu K3 3-8-3 relu, s_block 128"] = cuda_ms(
            torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
                *ws, xx, cm, offm, n_steps=256, s_block=128, t_block=256,
                unroll=8, compute_unit="mxu"))
    pm = params_from_numpy(default_params(system="chen@ring32"), device=dev)
    wk = [pm[k] for k in KEYS]
    kw32 = dict(compute_unit="mxu", coupling=pm["coupling"],
                lattice=lattice_meta_tuple(pm["lattice_meta"]))
    for tag, dtype in (("f32", torch.float32), ("bf16", bf16)):
        xx = xm.to(dtype)
        for act in ("relu", "tanh", "sigmoid"):
            out[f"{tag} mxu K1 chen@ring32 {act}"] = cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_bits(
                    *wk, xx, offm, n_steps=64, activation=act, **kw32))
            out[f"{tag} mxu K2 chen@ring32 {act}"] = cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_traj(
                    *wk, xx, n_steps=64, activation=act, **kw32), reps=3)
    p8 = params_from_numpy(default_params(system="chen@ring8"), device=dev)
    for act in ("tanh", "sigmoid"):
        out[f"bf16 mxu K2 chen@ring8 {act}"] = cuda_ms(
            torch, lambda: chaotic_ann.chaotic_ann_traj(
                *[p8[k] for k in KEYS], x8, n_steps=64, activation=act,
                compute_unit="mxu", coupling=p8["coupling"],
                lattice=lattice_meta_tuple(p8["lattice_meta"])), reps=3)
    pc = params_from_numpy(default_params(system="chen"), device=dev)
    wc = [pc[k] for k in KEYS]
    for tag, dtype in (("f32", torch.float32), ("bf16", bf16)):
        xx = x3.to(dtype)
        for act in ("relu", "tanh", "sigmoid"):
            out[f"{tag} K1 chen {act}, 1,024 steps"] = cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_bits(
                    *wc, xx, offm, n_steps=1024, activation=act))
        for act in ("relu", "tanh", "sigmoid"):
            out[f"{tag} K2 chen {act}, 1,024 steps"] = cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_traj(
                    *wc, xx, n_steps=1024, activation=act), reps=3)
    # the scalar gang kernels at the farm's flush shapes
    pool = LANES // 4
    gkw = dict(s_block=128, t_block=256, unroll=8)
    blocks = np.array([pool // 128] * 4)
    blocks_f3 = blocks + np.array([0, 0, 1, 0])        # lorenz + 1 client
    cm_f3 = np.repeat(np.arange(4), blocks_f3)
    x_f3_f = torch.as_tensor(rng.uniform(-0.9, 0.9, (128 * cm_f3.size, 3)),
                             dtype=torch.float32, device=dev)
    off_f3 = torch.zeros(x_f3_f.shape[0], dtype=torch.int64, device=dev)
    cm_f2 = np.repeat(np.arange(4), blocks)
    rows_f2 = np.repeat([512, 8, 8, 8], blocks)         # chen hot
    for tag, dtype in (("f32", torch.float32), ("bf16", bf16)):
        xg, x_f3 = x3.to(dtype), x_f3_f.to(dtype)
        xs3 = xg.reshape(4, pool, 3)
        for act in ("relu", "tanh", "sigmoid"):
            out[f"{tag} K4 3-8-3 F1 {act}, 4 x 16,384 lanes, 128 rows"] = (
                cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_stacked(
                    *ws, xs3, offm.reshape(4, pool), n_steps=256,
                    activation=act)))
            out[f"{tag} K3 3-8-3 F3 {act}, 65,664 lanes, 128 rows"] = (
                cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
                    *ws, x_f3, cm_f3, off_f3, n_steps=256, activation=act,
                    **gkw)))
            out[f"{tag} K3 3-8-3 F2 {act}, chen 512 rows, others 8"] = (
                cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_gang_bits(
                    *ws, xg, cm_f2, offm, rows_f2, n_steps=1024,
                    activation=act, **gkw)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{label} (build {t_build:.1f} s; card {card})")
    for name, ms in out.items():
        print(f"  {name}: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
