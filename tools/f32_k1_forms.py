#!/usr/bin/env python3
"""Four choices in the f32 vpu K1 (``bits_kernel`` and
``lattice_bits_kernel`` in ``src/repro_torch/kernels/csrc/chaotic_ann.cu``),
timed: the library as built (the f32 row loop, ``f32_rows``, copies the
weights from shared memory into registers first, as ``bf16x2_traj_kernel``
does; ``exp_f32`` floors with ``floorf``, SASS FRND; the formulas clamp
with ``clamp_nan``, max.NaN and min.NaN) against four copies of the
source: one whose row loop reads the weights from shared memory, from
where ptxas loads them before the loop ("shared"), one whose sums start
from +0 plus their first term, as the plain version's (``f32_step`` starts
from the first term: "plus0"), one whose ``exp_f32`` floors by adding and
subtracting 1.5 * 2^23, one less where that rounded up ("magic"), and one
whose ``clamp_nan`` is ``clampf``'s compares and selects ("ternary").
Needs a CUDA card and nvcc.

    python3 tools/f32_k1_forms.py

For each form: the registers and spill bytes of each f32 K1 instantiation
(``-Xptxas -v``) and, where ``cuobjdump`` is found, their SASS instructions
in the row loop (as ``chip_smoke.py`` counts them); then, on the registry
weights, by CUDA events (``chip_smoke.py``'s ``cuda_ms``), in turns (each
form, then back): the scalar K1 at chen (3-8) and hyperlorenz (4-16) with
relu, tanh and sigmoid, 65,536 lanes x 1,024 steps, and the lattice K1 at
chen@ring8 with tanh and sigmoid, 65,536 lanes x 256 steps.  Each form's
words and states are held bitwise to the built form's.  The copies are
built under ``build/f32_k1_variants/`` (git-ignored).
"""
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (text as built, text in the form) of each form's patches
FORMS = {
    "built": (),
    "shared": ((
        "  const Weights<I, H> w = ws;\n",
        "  const Weights<I, H>& w = ws;\n"),),
    "plus0": ((
        "h[k] = __fmul_rn(w.w1[k], x[0]);",
        "h[k] = __fadd_rn(0.0f, __fmul_rn(w.w1[k], x[0]));"), (
        "y[i] = __fmul_rn(w.w2[i], h[0]);",
        "y[i] = __fadd_rn(0.0f, __fmul_rn(w.w2[i], h[0]));")),
    "magic": ((
        "  const float fx = floorf(__fmaf_rn(x, 0x1.715476p+0f, 0.5f));\n"
        "  const uint32_t k = __float_as_uint(__fadd_rn(fx, kRound));\n",
        "  const float t = __fmaf_rn(x, 0x1.715476p+0f, 0.5f);\n"
        "  const float m = __fadd_rn(t, kRound);\n"
        "  const float n = __fsub_rn(m, kRound);\n"
        "  const bool up = n > t;\n"
        "  const float fx = up ? __fsub_rn(n, 1.0f) : n;\n"
        "  const uint32_t k = __float_as_uint(m) - (up ? 1u : 0u);\n"),),
    "ternary": ((
        "  float d;\n"
        "  asm(\"max.NaN.f32 %0, %1, %2;\" : \"=f\"(d) : \"f\"(x), \"f\"(lo));\n"
        "  asm(\"min.NaN.f32 %0, %1, %2;\" : \"=f\"(d) : \"f\"(d), \"f\"(hi));\n"
        "  return d;\n",
        "  return x < lo ? lo : (x > hi ? hi : x);\n"),),
}
# the instantiations reported: (kernel, template arguments)
KERNELS = tuple(("bits_kernel", ("f", i, h, a))
                for i, h in ((3, 8), (4, 16)) for a in range(3)) + tuple(
    ("lattice_bits_kernel", ("f", 3, 8, 8, 0, a)) for a in (1, 2))
KEYS = ("w1", "b1", "w2", "b2")
LANES = 65_536


def registers(log: str, name: str, args) -> str:
    """Registers and spill bytes of one instantiation in nvcc's log."""
    import chip_smoke as cs
    want = cs.mangled(name, args)
    for entry in log.split("Compiling entry function '")[1:]:
        if want in entry.split("'", 1)[0]:
            m = re.search(r"Used (\d+) registers", entry)
            spill = sorted({int(n) for n in re.findall(r"(\d+) bytes spill",
                                                       entry)})
            return (f"{name}<{', '.join(map(str, args))}> "
                    f"{m.group(1) if m else '?'} registers, spill {spill}")
    return f"{name}<{', '.join(map(str, args))}> not in the log"


def load_form(name: str, src: str):
    """The library of ``src`` built into a directory of its own (afresh,
    so that ptxas reports its registers), its ctypes handle, its
    registers and its SASS loop counts."""
    import chip_smoke as cs
    from repro_torch.kernels import build, chaotic_ann
    d = ROOT / "build" / "f32_k1_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / build.SOURCE).write_text(src)
    build.CSRC = d
    build.library_path(build.SOURCE).unlink(missing_ok=True)
    log = build.build()
    regs = [registers(log, k, a) for k, a in KERNELS]
    cs.SASS_KERNELS, cs.SASS_FREE = KERNELS, {}   # count, do not gate
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
    from repro_torch.core.ann import lattice_meta_tuple, params_from_numpy
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
                raise SystemExit(f"the f32 K1 changed: update the {name} "
                                 f"form's patch {old!r}")
            text = text.replace(old, new)
        libs[name], regs, report = load_form(name, text)
        print(f"{name}: " + "; ".join(regs))
        print(f"{name} sass: {report}")
    rng = np.random.default_rng(28)
    off = torch.zeros(LANES, dtype=torch.int64, device=device)
    cases = {}
    for system, n_steps in (("chen", 1024), ("hyperlorenz", 1024),
                            ("chen@ring8", 256)):
        p = params_from_numpy(default_params(system=system), device=device)
        w = [p[k] for k in KEYS]
        x = torch.as_tensor(rng.uniform(-0.9, 0.9, (LANES, w[0].shape[0])),
                            dtype=torch.float32, device=device)
        kw = dict(n_steps=n_steps)
        if "lattice_meta" in p:
            kw["lattice"] = lattice_meta_tuple(p["lattice_meta"])
        acts = ("tanh", "sigmoid") if "lattice" in kw else (
            "relu", "tanh", "sigmoid")
        for act in acts:
            cases[f"K1 {system} {act}, {LANES:,} lanes x {n_steps:,} "
                  f"steps"] = (lambda w=w, x=x, kw=kw, act=act:
                               chaotic_ann.chaotic_ann_bits(
                                   *w, x, off, activation=act, **kw))
    for label, fn in cases.items():
        times, outs = {}, {}
        for name in list(FORMS) + list(FORMS)[::-1]:
            chaotic_ann._lib = lambda lib=libs[name]: lib
            outs.setdefault(name, fn())
            times.setdefault(name, []).append(cs.cuda_ms(
                torch, fn, reps=10, warmup=2))
        wa, sa = outs["built"]
        same = all(cs.max_abs_err(torch, wa, wb) == 0.0
                   and cs.max_abs_err(torch, sa, sb) == 0.0
                   for wb, sb in outs.values())
        print(f"f32 {label}: " + ", ".join(
            f"{name} " + " / ".join(f"{v:.4f}" for v in times[name])
            for name in FORMS) + f" ms; words and states bitwise equal: {same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
