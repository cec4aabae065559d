#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` into ``build/repro_torch_kernels``.
2. Hold each kernel against its plain PyTorch version on the card,
   bitwise (words, final state, trajectory), in f32 and bf16, on the
   committed chen (3-8-3) and hyperlorenz (4-16-4) weights, at a ragged
   lane count and with per-lane word offsets that wrap past 2**32.
3. The main path, per dtype: ``PRNGService`` on chen with 512 clients x
   128 lanes (register, then three flushes), each client drawing 65,536
   words per flush (33.5 M words a flush).  Then the unfused path
   (``ops.chaotic_trajectory`` + ``ops.pack_words``) on the same first
   flush.  Each path has the launch counters zeroed just before it and
   read just after; the served words are checked against a standalone
   ``ChaoticPRNG`` drawn in other chunks, a snapshot/restore
   continuation, and the unfused path.  Then the kernel times (CUDA
   events), the plain versions' times, and the bounds.
4. NIST monobit / runs / block frequency on 2**20 served words per dtype,
   under the JAX package's policy (``repro/prng/quality.py``): f32 words
   must pass outright; a bf16 core must not be quarantined by the offline
   gate recipe.  The 2**20 served bf16 words are tested and printed, not
   gated: the reference's bf16 lanes coalesce onto shared orbits, so
   served bf16 words repeat across lanes (ROADMAP.md queue 3).

Prints the ``kernels`` JSON line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA card is visible.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, Hopper whitepaper): each
# state dtype's rate outside the tensor cores, and HBM bandwidth.  Every
# op of a step rounds in the state dtype, which tensor cores (f32
# accumulators) do not do, so the scalar rates bound the work.
PEAK_FLOPS = {"f32": 67e12, "bf16": 133.8e12}
PEAK_HBM_BYTES = 3.35e12

SYSTEMS = ("chen", "hyperlorenz")
CHECK_LANES = 65_536 + 37      # ragged: not a multiple of the block size
CHECK_STEPS = 512
N_CLIENTS = 512
LANES_PER_CLIENT = 128
WORDS_PER_CLIENT = 65_536
NIST_WORDS = 1 << 20
# repro/prng/quality.py: alpha, hard alpha, chance failures a bf16 core
# may lose before quarantine, words and lanes of the offline gate recipe
NIST_ALPHA, NIST_ALPHA_HARD, NIST_MAX_CHANCE_FAILS = 0.01, 1e-6, 1
GATE_WORDS, GATE_STREAMS = 30_000, 256


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, n_bytes: float, tag: str):
    ops_ms = flops / PEAK_FLOPS[tag] * 1e3
    bytes_ms = n_bytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def step_flops(i_dim: int, h_dim: int) -> int:
    """Separate ops of one step, each in the state dtype: I*H mul+add,
    H bias, H*I mul+add, I bias."""
    return 4 * i_dim * h_dim + h_dim + i_dim


def max_abs_err(torch, a, b) -> float:
    """Bitwise agreement check; returns the largest absolute difference
    (0.0 when every element is bit-identical)."""
    if a.dtype == torch.uint32:
        ia = a.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        ib = b.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return float((ia - ib).abs().max().item())
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    if torch.equal(a.view(bits), b.view(bits)):
        return 0.0
    diff = (a.float() - b.float()).abs().nan_to_num(nan=float("inf"))
    return float(diff.max().item())


def phase_kernels(torch, device, errs) -> None:
    """Each kernel against its plain version on the card, bitwise."""
    from repro_torch.core.ann import params_from_numpy
    from repro_torch.kernels import chaotic_ann, ref
    from repro_torch.prng.stream import default_params

    rng = np.random.default_rng(0)
    for system in SYSTEMS:
        p = params_from_numpy(default_params(system=system), device=device)
        w = (p["w1"], p["b1"], p["w2"], p["b2"])
        i_dim = p["w1"].shape[0]
        x0_np = rng.uniform(-0.9, 0.9, (CHECK_LANES, i_dim)).astype(np.float32)
        off_np = rng.integers(0, 1 << 32, CHECK_LANES, dtype=np.int64)
        off_np[:64] = (1 << 32) - 1 - 3 * np.arange(64)    # wrap mid-run
        off = torch.as_tensor(off_np, device=device)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x0 = torch.as_tensor(x0_np, device=device).to(dtype)
            words_k, state_k = chaotic_ann.chaotic_ann_bits(
                *w, x0, off, n_steps=CHECK_STEPS)
            words_p, state_p = ref.chaotic_ann_bits_ref(
                *w, x0, CHECK_STEPS, off)
            traj_k = chaotic_ann.chaotic_ann_traj(*w, x0, n_steps=CHECK_STEPS)
            traj_p = ref.chaotic_ann_ref(*w, x0, CHECK_STEPS)
            torch.cuda.synchronize()
            e_bits = max(max_abs_err(torch, words_k, words_p),
                         max_abs_err(torch, state_k, state_p))
            e_traj = max_abs_err(torch, traj_k, traj_p)
            print(f"check {system} {tag} S={CHECK_LANES} steps={CHECK_STEPS}:"
                  f" chaotic_ann_bits max_abs_err={e_bits}"
                  f" chaotic_ann_traj max_abs_err={e_traj}"
                  f" max|x|={traj_p.float().abs().max().item():.6g}")
            check(e_bits == 0.0, f"chaotic_ann_bits != plain ({system}, {tag})")
            check(e_traj == 0.0, f"chaotic_ann_traj != plain ({system}, {tag})")
            for name, e in (("chaotic_ann_bits", e_bits),
                            ("chaotic_ann_traj", e_traj)):
                errs[(name, tag)] = max(errs.get((name, tag), 0.0), e)


def read_launches(chaotic_ann) -> dict:
    return {"chaotic_ann_bits": chaotic_ann.chaotic_ann_bits.launches,
            "chaotic_ann_traj": chaotic_ann.chaotic_ann_traj.launches}


def zero_launches(chaotic_ann) -> None:
    chaotic_ann.chaotic_ann_bits.launches = 0
    chaotic_ann.chaotic_ann_traj.launches = 0


def phase_main_path(torch, device, dtype, tag, card):
    """The served path at full width, then the unfused path; returns
    ({path: launch counts}, timings, served words for the NIST phase)."""
    from repro_torch.kernels import chaotic_ann, ops, ref
    from repro_torch.prng.stream import ChaoticPRNG, _round_rows, default_params
    from repro_torch.serve.prng_service import PRNGService

    params_np = default_params(system="chen")
    L, n_words = LANES_PER_CLIENT, WORDS_PER_CLIENT
    names = [f"client{i:03d}" for i in range(N_CLIENTS)]

    def make_service():
        return PRNGService(params_np, lanes_per_client=L, dtype=dtype,
                           device=device)

    zero_launches(chaotic_ann)
    t0 = time.perf_counter()
    svc = make_service()
    for i, name in enumerate(names):
        svc.register(name, seed=1000 + i)
    torch.cuda.synchronize()
    t_register = time.perf_counter() - t0

    x_before = svc.pool_x.clone()            # every client at word row 0
    for name in names:
        svc.request(name, n_words)
    t0 = time.perf_counter()
    out1 = svc.flush()
    torch.cuda.synchronize()
    t_flush1 = time.perf_counter() - t0
    check(svc.launches == 1, f"{tag}: one flush must be one launch")
    check(all(out1[n].size == n_words for n in names), f"{tag}: flush sizes")

    snap = svc.snapshot()
    for name in names:
        svc.request(name, n_words)
    t0 = time.perf_counter()
    out2 = svc.flush()
    torch.cuda.synchronize()
    t_flush2 = time.perf_counter() - t0

    # where a flush's wall time goes: plan, launch + copy to host, absorb
    for name in names:
        svc.request(name, n_words)
    t0 = time.perf_counter()
    n_need, offsets = svc.prepare_rows()
    n_rows = _round_rows(n_need, svc.config.t_block)
    t1 = time.perf_counter()
    words, new_x = svc._launch(n_rows, offsets)
    t2 = time.perf_counter()
    svc.absorb(words, new_x, n_rows)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {"served": read_launches(chaotic_ann)}
    check(launches["served"]["chaotic_ann_bits"] == N_CLIENTS + 3,
          f"{tag}: served path must launch once per burn-in and per flush, "
          f"got {launches['served']}")
    split = {"plan_ms": (t1 - t0) * 1e3, "launch_and_copy_ms": (t2 - t1) * 1e3,
             "absorb_ms": (t3 - t2) * 1e3}

    # snapshot/restore continues every stream bit-exactly
    svc2 = make_service()
    svc2.restore(snap)
    for name in names:
        svc2.request(name, n_words)
    out2r = svc2.flush()
    check(all(np.array_equal(out2[n], out2r[n]) for n in names),
          f"{tag}: snapshot/restore continuation differs")

    # a standalone engine, drawn in other chunks, gives the same words
    eng = ChaoticPRNG(params_np, n_streams=L, config=svc.config, dtype=dtype,
                      device=device)
    for i in (0, 1, N_CLIENTS - 1):
        state = eng.init(seed=1000 + i)
        parts = []
        first, second = n_words // 65, n_words // 2 + 7     # odd chunks
        for n in (first, second, 2 * n_words - first - second):
            w, state = eng.next_words(state, n)
            parts.append(w)
        check(np.array_equal(np.concatenate(parts),
                             np.concatenate([out1[names[i]], out2[names[i]]])),
              f"{tag}: chunked standalone stream differs for {names[i]}")

    # the unfused path (trajectory kernel + packing) gives the same words
    n_steps = 2 * (n_words // L)
    zero_launches(chaotic_ann)
    traj = ops.chaotic_trajectory(svc.params, x_before, n_steps,
                                  config=svc.config)
    slab = ops.pack_words(traj, 0).cpu().numpy()
    launches["unfused"] = read_launches(chaotic_ann)
    del traj
    check(all(np.array_equal(slab[:, i * L:(i + 1) * L].reshape(-1), out1[n])
              for i, n in enumerate(names)),
          f"{tag}: unfused pipeline differs from the fused service")
    # every lane shares the row counter here, so lanes whose oscillators
    # have merged emit equal words: distinct words per row count them
    distinct = [len(np.unique(slab[r])) for r in (0, len(slab) - 1)]
    print(f"main path {tag}: {N_CLIENTS} clients x {L} lanes, "
          f"{N_CLIENTS * n_words} words per flush; launches {launches}; "
          f"register {t_register:.3f} s; flush wall {t_flush1 * 1e3:.1f} ms "
          f"then {t_flush2 * 1e3:.1f} ms ({N_CLIENTS * n_words / t_flush2:.4g}"
          f" words/s); third flush split "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; distinct words of {x_before.shape[0]} lanes in row 0 "
          f"{distinct[0]}, in row {len(slab) - 1} {distinct[1]}; card {card}")

    # device times at the flush shape (not counted as main-path launches)
    w = [svc.params[k] for k in ("w1", "b1", "w2", "b2")]
    x, s_pool = x_before, x_before.shape[0]
    off = torch.zeros(s_pool, dtype=torch.int64, device=device)
    i_dim, h_dim = w[0].shape
    item = x.element_size()
    n_out = n_steps // 2 * s_pool
    t = {
        "bits_ms": cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_bits(
            *w, x, off, n_steps=n_steps), reps=10, warmup=2),
        "traj_ms": cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_traj(
            *w, x, n_steps=n_steps), reps=5, warmup=1),
        "unfused_ms": cuda_ms(torch, lambda: ops.pack_words(
            chaotic_ann.chaotic_ann_traj(*w, x, n_steps=n_steps), off),
            reps=3, warmup=1),
        "bits_plain_ms": cuda_ms(torch, lambda: ref.chaotic_ann_bits_ref(
            *w, x, n_steps, off), reps=1, warmup=1),
        "traj_plain_ms": cuda_ms(torch, lambda: ref.chaotic_ann_ref(
            *w, x, n_steps), reps=1, warmup=1),
    }
    weight_bytes = (2 * i_dim * h_dim + h_dim + i_dim) * item
    t["bits_bound"] = bound(
        n_out * 2 * step_flops(i_dim, h_dim),
        2 * s_pool * i_dim * item + s_pool * 4 + weight_bytes + n_out * 4, tag)
    t["traj_bound"] = bound(
        n_steps * s_pool * step_flops(i_dim, h_dim),
        s_pool * i_dim * item + weight_bytes + n_steps * s_pool * i_dim * item,
        tag)
    t["flush_s"] = t_flush2
    print(f"device times {tag} (S={s_pool}, n_steps={n_steps}): "
          f"chaotic_ann_bits {t['bits_ms']:.4f} ms "
          f"({n_out / t['bits_ms'] * 1e3:.4g} words/s, bound "
          f"{t['bits_bound'][0]:.4f} ms by {t['bits_bound'][1]}); "
          f"plain {t['bits_plain_ms']:.1f} ms; "
          f"unfused traj+pack {t['unfused_ms']:.3f} ms; "
          f"chaotic_ann_traj {t['traj_ms']:.4f} ms (bound "
          f"{t['traj_bound'][0]:.4f} ms by {t['traj_bound'][1]}); "
          f"plain {t['traj_plain_ms']:.1f} ms; card {card}")
    served = np.concatenate([out1[n] for n in names[:NIST_WORDS // n_words]])
    return launches, t, served


def nist3(words: np.ndarray):
    """p-values of the online-gate subset, and the tests under alpha."""
    from repro_torch.prng.nist import _to_bits, block_frequency, monobit, runs
    bits = _to_bits(words)
    p = {"monobit": monobit(bits), "runs": runs(bits),
         "block_frequency": block_frequency(bits)}
    return p, [k for k, v in p.items() if v < NIST_ALPHA]


def phase_nist(torch, device, served) -> None:
    from repro_torch.prng.nist import run_nist_subset
    from repro_torch.prng.stream import ChaoticPRNG, default_params

    for tag, words in served.items():
        p, failed = nist3(words)
        print(f"nist {tag} on {words.size} served words: "
              + ", ".join(f"{k} p={v:.4g}" for k, v in p.items())
              + ("" if tag == "f32" else
                 f"; failed {failed}, not gated (bf16 lanes coalesce)"))
        if tag == "f32":
            check(not failed, f"f32 served words fail NIST {failed}")
    # the offline gate recipe of repro/prng/quality.py::nist_gate, bf16
    eng = ChaoticPRNG(default_params(system="chen"), n_streams=GATE_STREAMS,
                      dtype=torch.bfloat16, device=device)
    res = run_nist_subset(eng.next_words(eng.init(seed=0), GATE_WORDS)[0],
                          alpha=NIST_ALPHA)
    failed = [k for k, v in res.items() if not v["passed"]]
    hard = [k for k, v in res.items() if v["p_value"] < NIST_ALPHA_HARD]
    print(f"nist gate bf16 chen ({GATE_WORDS} words, {GATE_STREAMS} lanes, "
          f"7 tests): " + ", ".join(f"{k} p={v['p_value']:.4g}"
                                    for k, v in res.items()))
    check(len(failed) <= NIST_MAX_CHANCE_FAILS and not hard,
          f"bf16 chen quarantined by the NIST gate: {failed} (hard {hard})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build    # fails outside the repo

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    log = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.SOURCE} {'compiled' if log else 'reused'})")
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  {line.strip()}")
    neg0 = torch.relu(torch.tensor([-0.0], device=device))
    print(f"torch.relu(-0.0) on the card: signbit={bool(neg0.signbit())}")

    errs = {}
    phase_kernels(torch, device, errs)
    rows, served = [], {}
    replaces = {"chaotic_ann_bits": "src/repro/kernels/chaotic_ann.py:441",
                "chaotic_ann_traj": "src/repro/kernels/chaotic_ann.py:254"}
    # the path that runs each kernel: the served path runs K1 only, the
    # unfused path K2 only
    paths = {"chaotic_ann_bits": "served", "chaotic_ann_traj": "unfused"}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        launches, t, served[tag] = phase_main_path(torch, device, dtype, tag,
                                                   card)
        for name, key in (("chaotic_ann_bits", "bits"),
                          ("chaotic_ann_traj", "traj")):
            path = paths[name]
            other = next(p for p in launches if p != path)
            check(launches[path][name] > 0,
                  f"{name} not launched on the {tag} {path} path")
            check(launches[other][name] == 0,
                  f"{name} launched on the {tag} {other} path")
            rows.append({
                "name": f"{name}/{tag}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/chaotic_ann.cu",
                "replaces": replaces[name], "path": path,
                "launches": launches[path][name],
                "max_abs_err": errs[(name, tag)],
                "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
                "bound_ms": t[f"{key}_bound"][0],
                "bound_by": t[f"{key}_bound"][1], "library_ms": None,
                "unfused_ms": t["unfused_ms"] if key == "bits" else None,
                "flush_wall_ms": t["flush_s"] * 1e3 if key == "bits" else None,
            })
    phase_nist(torch, device, served)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
