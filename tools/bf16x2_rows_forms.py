#!/usr/bin/env python3
"""Two choices in the scalar bf16 row loop (``bf16x2_rows`` in
``src/repro_torch/kernels/csrc/chaotic_ann.cu``), timed: the library as
built (a thread whose lane a does not exist returns after the weights are
staged, so lane a's stores need no predicate; each thread copies the
staged weights into registers) against two copies of the source: one
whose threads all run the loop, lane a's stores predicated on its being
live ("predicated"), and one whose loop reads the weights from shared
memory at every step ("shared").  Needs a CUDA card and nvcc.

    python3 tools/bf16x2_rows_forms.py

For each form: the registers and spill bytes of the scalar bf16 K1, K3 and
K4 (``-Xptxas -v``) and, where ``cuobjdump`` is found, their SASS
instructions in the row loop (LDS among them, as ``chip_smoke.py`` counts
them); then, on the registry weights, by CUDA events (``chip_smoke.py``'s
``cuda_ms``), in turns (built, predicated, shared, then back), relu, tanh
and sigmoid: the K1 at chen, 65,536 lanes x 1,024 steps; the K4 at the
farm's F1 (the four 3-8-3 bases, 4 x 16,384 lanes, 128 rows); the K3 at
the farm's F2 (s_block 128, chen's 128 blocks 512 rows, the others' 8).
Each form's words (the rows each lane computes) and states are held
bitwise to the built form's.  The copies are built under
``build/bf16x2_rows_variants/`` (git-ignored).
"""
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (text as built, text in the form) of each form's patches
RETURN = "  if (!p.live_a) return;\n"
FORMS = {
    "built": (),
    "predicated": (
        (RETURN, ""),
        ("    row[p.lane_a] = finalize(word_a(hi, lo, over) ^ (off_a + ctr)"
         " * kGolden);\n    if (p.live_b)",
         "    if (p.live_a) row[p.lane_a] = finalize(word_a(hi, lo, over) ^ "
         "(off_a + ctr) * kGolden);\n    if (p.live_b)"),
        ("    store_half(state, p.lane_a * I + i, x[i]);\n",
         "    if (p.live_a) store_half(state, p.lane_a * I + i, x[i]);\n")),
    "shared": ((RETURN + "  const PairWeights<I, H> w = ws;\n",
                RETURN + "  const PairWeights<I, H>& w = ws;\n"),),
}
KERNELS = ("bf16x2_bits_kernel", "bf16x2_gang_bits_kernel",
           "bf16x2_gang_stacked_kernel")
KEYS = ("w1", "b1", "w2", "b2")
BASES = ("chen", "chua", "lorenz", "rossler")
LANES = 65_536


def load_form(name: str, src: str):
    """The library of ``src`` built into a directory of its own (afresh,
    so that ptxas reports its registers), its ctypes handle, its
    registers and its SASS loop counts."""
    import chip_smoke as cs
    from repro_torch.kernels import build, chaotic_ann
    d = ROOT / "build" / "bf16x2_rows_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / build.SOURCE).write_text(src)
    build.CSRC = d
    build.library_path(build.SOURCE).unlink(missing_ok=True)
    log = build.build()
    regs = [cs.kernel_registers(log, k) for k in KERNELS]
    cs.SASS_KERNELS = tuple((k, (3, 8, a)) for k in KERNELS for a in range(3))
    dump = cs.sass_dump_start(build.library_path(build.SOURCE))
    try:
        report, _ = cs.sass_counts(dump)
    finally:
        cs.sass_dump_stop(dump)
    chaotic_ann._lib.cache_clear()
    return chaotic_ann._lib(), regs, report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, chaotic_ann
    from repro_torch.prng.stream import default_params

    device = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}")
    src = (build.CSRC / build.SOURCE).read_text()
    libs = {}
    for name, patches in FORMS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"bf16x2_rows changed: update the {name} "
                                 f"form's patch {old!r}")
            text = text.replace(old, new)
        libs[name], regs, report = load_form(name, text)
        print(f"{name}: " + "; ".join(regs))
        print(f"{name} sass: {report}")
    rng = np.random.default_rng(28)
    per = [default_params(system=s) for s in BASES]
    w = [torch.as_tensor(np.stack([p[k] for p in per]), device=device)
         for k in KEYS]
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (LANES, 3)),
                        dtype=torch.float32, device=device).to(torch.bfloat16)
    off = torch.zeros(LANES, dtype=torch.int64, device=device)
    pool = LANES // 4
    blocks = np.array([pool // 128] * 4)
    core_map = np.repeat(np.arange(4), blocks)
    rows_f2 = np.repeat([512, 8, 8, 8], blocks)       # chen hot
    gkw = dict(s_block=128, t_block=256, unroll=8)
    # the word rows each lane computes: K3's cold blocks leave the rest
    # unwritten
    every = torch.full((LANES,), 512, device=device)
    f2_rows = torch.as_tensor(np.repeat(rows_f2, 128), device=device)
    for act in ("relu", "tanh", "sigmoid"):
        cases = {
            "K1 chen, 1,024 steps": (
                every, lambda: chaotic_ann.chaotic_ann_bits(
                    *[a[0] for a in w], x, off, n_steps=1024,
                    activation=act)),
            "K4 F1, 4 x 16,384 lanes, 128 rows": (
                None, lambda: chaotic_ann.chaotic_ann_gang_stacked(
                    *w, x.reshape(4, pool, 3), off.reshape(4, pool),
                    n_steps=256, activation=act)),
            "K3 F2, chen 512 rows, others 8": (
                f2_rows, lambda: chaotic_ann.chaotic_ann_gang_bits(
                    *w, x, core_map, off, rows_f2, n_steps=1024,
                    activation=act, **gkw))}
        for label, (lane_rows, fn) in cases.items():
            times, outs = {}, {}
            order = list(FORMS) + list(FORMS)[::-1]
            for name in order:
                chaotic_ann._lib = lambda lib=libs[name]: lib
                outs.setdefault(name, fn())
                times.setdefault(name, []).append(cs.cuda_ms(
                    torch, fn, reps=10, warmup=2))
            wa, sa = outs["built"]
            same = all(
                cs.max_abs_err(torch, sa, sb) == 0.0
                and (cs.max_abs_err(torch, wa, wb) if lane_rows is None
                     else cs.masked_err(torch, wa, wb, lane_rows)) == 0.0
                for wb, sb in outs.values())
            print(f"bf16 {label} {act}: " + ", ".join(
                f"{name} " + " / ".join(f"{v:.4f}" for v in times[name])
                for name in FORMS)
                + f" ms; words and states bitwise equal: {same}")
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
