#!/usr/bin/env python3
"""The bf16 lattice K2's stores, timed: the library as built from
``src/repro_torch/kernels/csrc/chaotic_ann.cu`` (``bf16x2_lattice_traj_kernel``
stages each step's values in shared memory and writes them in 16-byte
stores) against a copy of the source whose kernel writes each value where
it stands, two bytes a store (each node thread its D components of both
lanes).  Needs a CUDA card and nvcc.

    python3 tools/lattice_traj_stores.py

For each form: the registers and spill bytes of every instantiation of
``bf16x2_lattice_traj_kernel`` (``-Xptxas -v``), then the bf16 lattice K2
at 65,536 lanes x 256 steps (the lattice path's shape) by CUDA events
(``chip_smoke.py``'s ``cuda_ms``): relu at chen@ring32 and chen@ring8,
tanh and sigmoid at chen@ring8 and chen@ring32, on the registry weights.
The two forms run in turns (staged, direct, direct, staged), and the
direct form's trajectories are held bitwise to the staged form's.  The
copy is built under ``build/lattice_traj_variants/`` (git-ignored).
"""
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

STAGED = '''    lattice_step2<D, HB, N, TOPO, ACT>(th.x, th.w, p.node, th.eps2);
#pragma unroll
    for (int k = 0; k < D; ++k)
      st.put(k, static_cast<unsigned short>(th.x[k]),
             static_cast<unsigned short>(th.x[k] >> 16));
    st.copy();
'''
DIRECT = '''    lattice_step2<D, HB, N, TOPO, ACT>(th.x, th.w, p.node, th.eps2);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (p.live_a)
        store_half(traj, (t * n_lanes + p.lane_a) * (N * D) + p.node * D + k,
                   th.x[k]);
      if (p.live_b)
        store_half(traj, (t * n_lanes + p.lane_b) * (N * D) + p.node * D + k,
                   th.x[k] >> 16);
    }
'''
CASES = (("chen@ring32", "relu"), ("chen@ring8", "relu"),
         ("chen@ring8", "tanh"), ("chen@ring8", "sigmoid"),
         ("chen@ring32", "tanh"), ("chen@ring32", "sigmoid"))
LANES, STEPS = 65_536, 256


def load_form(name: str, src: str):
    """The library of ``src`` built into a directory of its own (afresh,
    so that ptxas reports its registers), its ctypes handle and the
    registers of its bf16x2_lattice_traj_kernel instantiations."""
    from repro_torch.kernels import build, chaotic_ann
    d = ROOT / "build" / "lattice_traj_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / build.SOURCE).write_text(src)
    build.CSRC = d
    build.library_path(build.SOURCE).unlink(missing_ok=True)
    log = build.build()
    regs = []
    for entry in log.split("Compiling entry function '")[1:]:
        fn = entry.split("'", 1)[0]
        m = re.search(r"26bf16x2_lattice_traj_kernelILi3ELi8ELi(\d+)ELi(\d)"
                      r"ELi(\d)E", fn)
        if m:
            used = re.search(r"Used (\d+) registers", entry)
            spill = max(map(int, re.findall(r"(\d+) bytes spill", entry)),
                        default=0)
            regs.append(f"{m.group(1)}/{m.group(2)}/{m.group(3)}: "
                        f"{used.group(1) if used else '?'} regs, "
                        f"{spill} B spill")
    chaotic_ann._lib.cache_clear()
    return chaotic_ann._lib(), regs


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
    if src.count(STAGED) != 1:
        raise SystemExit("bf16x2_lattice_traj_kernel's stores changed: "
                         "update STAGED")
    libs = {}
    for name, text in (("staged", src), ("direct", src.replace(STAGED,
                                                               DIRECT))):
        libs[name], regs = load_form(name, text)
        print(f"{name}: bf16x2_lattice_traj_kernel (N/topology/act) "
              + "; ".join(regs))
    rng = np.random.default_rng(27)
    for system, act in CASES:
        p = params_from_numpy(default_params(system=system), device=device)
        w = [p[k] for k in ("w1", "b1", "w2", "b2")]
        kw = dict(n_steps=STEPS, activation=act,
                  lattice=lattice_meta_tuple(p["lattice_meta"]))
        x = torch.as_tensor(rng.uniform(-0.9, 0.9, (LANES, w[0].shape[0])),
                            dtype=torch.float32, device=device).to(
                                torch.bfloat16)
        times, trajs = {}, {}
        for name in ("staged", "direct", "direct", "staged"):
            chaotic_ann._lib = lambda lib=libs[name]: lib
            trajs.setdefault(name, chaotic_ann.chaotic_ann_traj(*w, x, **kw))
            times.setdefault(name, []).append(cs.cuda_ms(
                torch, lambda: chaotic_ann.chaotic_ann_traj(*w, x, **kw),
                reps=5, warmup=1))
        same = torch.equal(trajs["staged"].view(torch.int16),
                           trajs["direct"].view(torch.int16))
        print(f"bf16 lattice K2 {system} {act} ({LANES} lanes x {STEPS} "
              f"steps): staged 16-byte stores "
              + " / ".join(f"{v:.4f}" for v in times["staged"])
              + " ms, direct two-byte stores "
              + " / ".join(f"{v:.4f}" for v in times["direct"])
              + f" ms; trajectories bitwise equal: {same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
