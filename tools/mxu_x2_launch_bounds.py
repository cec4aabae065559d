#!/usr/bin/env python3
"""The two-lane mxu K1's launch bounds, timed: the library as built from
``src/repro_torch/kernels/csrc/chaotic_ann.cu`` against copies of the source
whose ``mxu_x2_min_blocks`` asks ptxas for one CTA an SM everywhere, or four
at every lattice shape and activation.  Needs a CUDA card and nvcc.

    python3 tools/mxu_x2_launch_bounds.py

For each variant: the registers and spill bytes of every lattice
instantiation of ``mxu_x2_bits_kernel`` and ``bf16x2_mxu_bits_kernel``
(``-Xptxas -v``), then the mxu K1 at chen@ring32, 65,536 lanes x 64 steps,
relu / tanh / sigmoid in f32 and bf16, by CUDA events (``chip_smoke.py``'s
``cuda_ms``), each variant's words and state held bitwise to the first's.
The copies are built under ``build/mxu_x2_variants/`` (git-ignored).
"""
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

FUNCTION = "return n_nodes > 1 && act == kRelu ? 4 : 1;"
VARIANTS = {"as built": FUNCTION,
            "one CTA an SM": "return 1;",
            "four at every lattice": "return n_nodes > 1 ? 4 : 1;"}


def variant_dir(name: str, body: str, src: str) -> pathlib.Path:
    """A directory holding a copy of the kernel source ``src`` with
    ``mxu_x2_min_blocks``'s body replaced by ``body``."""
    from repro_torch.kernels import build
    if FUNCTION not in src:
        raise SystemExit("mxu_x2_min_blocks changed: update FUNCTION")
    d = ROOT / "build" / "mxu_x2_variants" / re.sub(r"\W+", "_", name)
    d.mkdir(parents=True, exist_ok=True)
    (d / build.SOURCE).write_text(src.replace(FUNCTION, body))
    return d


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
    p = params_from_numpy(default_params(system=cs.LATTICE), device=device)
    w = [p[k] for k in ("w1", "b1", "w2", "b2")]
    n, steps = cs.MXU_TIME_LANES, cs.MXU_TIME_STEPS
    rng = np.random.default_rng(23)
    off = torch.as_tensor(rng.integers(0, 1 << 32, n, dtype=np.int64),
                          device=device)
    x_np = rng.uniform(-0.9, 0.9, (n, w[0].shape[0])).astype(np.float32)
    kw = dict(n_steps=steps, coupling=p["coupling"],
              lattice=lattice_meta_tuple(p["lattice_meta"]))
    first = {}
    src = (build.CSRC / build.SOURCE).read_text()
    for name, body in VARIANTS.items():
        build.CSRC = variant_dir(name, body, src)
        chaotic_ann._lib.cache_clear()
        # built afresh, so that ptxas reports every variant's registers
        build.library_path(build.SOURCE).unlink(missing_ok=True)
        log = build.build()
        regs = []
        for entry in log.split("Compiling entry function '")[1:]:
            fn = entry.split("'", 1)[0]
            m = re.search(r"(mxu_x2|bf16x2_mxu)_bits_kernelILi3ELi8ELi(\d+)"
                          r"ELi(\d)ELi(\d)E", fn)
            if m:
                spill = max(map(int, re.findall(r"(\d+) bytes spill", entry)),
                            default=0)
                regs.append(f"{m.group(1)}<{m.group(2)},{m.group(3)},"
                            f"{m.group(4)}> "
                            + re.search(r"Used (\d+) registers",
                                        entry).group(1)
                            + (f" spill {spill}" if spill else ""))
        print(f"{name}: registers {'; '.join(regs)}")
        for act in ("relu", "tanh", "sigmoid"):
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16")):
                x = torch.as_tensor(x_np, device=device).to(dtype)
                out = chaotic_ann.chaotic_ann_mxu_bits(
                    *w, x, off, activation=act, **kw)
                ref = first.setdefault((act, tag), out)
                e = max(cs.max_abs_err(torch, a, b)
                        for a, b in zip(out, ref))
                ms = cs.cuda_ms(torch, lambda: chaotic_ann.chaotic_ann_mxu_bits(
                    *w, x, off, activation=act, **kw), reps=10, warmup=2)
                print(f"  {name} {act} {tag}: {ms:.4f} ms, max_abs_err vs "
                      f"the first variant {e}")
                if e:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
