#!/usr/bin/env python3
"""The f32 scalar mxu K2's dead lane b, timed both ways: the library as built
from ``src/repro_torch/kernels/csrc/chaotic_ann.cu`` (``mxu_x2_traj_kernel``
mirrors lane a into a lane b that does not exist) against a copy of the
source whose scalar-core threads without a lane b run lane a alone on the
one-lane step (``mxu_step``), as the f32 mxu K1 and K3 do
(``mxu_x2_rows``).  Needs a CUDA card and nvcc.

    python3 tools/mxu_traj_lone_lane.py

The f32 mxu K2 of the 3-8-3 chen net with each activation, by CUDA events
(``chip_smoke.py``'s ``cuda_ms``), at 128 lanes (one CTA, every lane b
dead), 65,536 + 128 lanes (the last CTA's lanes b dead) and 65,536 lanes
(none dead), 1,024 steps, the two forms in turns (mirror, lone, lone,
mirror); the lone form's trajectories are held bitwise to the mirror's.
The copy is built under ``build/mxu_traj_variants/`` (git-ignored).
"""
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

MIRROR = '''  Store st(stage, traj, n_lanes);
#pragma unroll 1
  for (int64_t t = 0; t < n_steps; ++t) {
    mxu_step_x2<D, HB, N, TOPO, ACT>(th.xa, th.xb, th.w, th.cp);
'''
LONE = '''  Store st(stage, traj, n_lanes);
  if constexpr (N == 1) {
    if (!p.live_b) {
#pragma unroll 1
      for (int64_t t = 0; t < n_steps; ++t) {
        mxu_step<D, HB, N, TOPO, ACT>(th.xa, th.w, th.cp);
#pragma unroll
        for (int k = 0; k < D; ++k)
          st.put(k, __float_as_uint(th.xa[k]), __float_as_uint(th.xa[k]));
        st.copy();
      }
      return;
    }
  }
#pragma unroll 1
  for (int64_t t = 0; t < n_steps; ++t) {
    mxu_step_x2<D, HB, N, TOPO, ACT>(th.xa, th.xb, th.w, th.cp);
'''
LANES = (128, 65_536 + 128, 65_536)
STEPS = 1024


def load_form(name: str, src: str):
    """The library of ``src`` built into a directory of its own and its
    ctypes handle."""
    from repro_torch.kernels import build, chaotic_ann
    d = ROOT / "build" / "mxu_traj_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / build.SOURCE).write_text(src)
    build.CSRC = d
    build.build()
    chaotic_ann._lib.cache_clear()
    return chaotic_ann._lib()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core.ann import params_from_numpy
    from repro_torch.kernels import build, chaotic_ann
    from repro_torch.prng.stream import default_params

    device = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}")
    src = (build.CSRC / build.SOURCE).read_text()
    if src.count(MIRROR) != 1:
        raise SystemExit("mxu_x2_traj_kernel's loop changed: update MIRROR")
    libs = {name: load_form(name, text) for name, text in (
        ("mirror", src), ("lone", src.replace(MIRROR, LONE)))}
    p = params_from_numpy(default_params(system="chen"), device=device)
    w = [p[k] for k in ("w1", "b1", "w2", "b2")]
    rng = np.random.default_rng(28)
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (max(LANES), 3)),
                        dtype=torch.float32, device=device)
    for act in ("relu", "tanh", "sigmoid"):
        for n in LANES:
            kw = dict(n_steps=STEPS, activation=act, compute_unit="mxu")
            xn = x[:n].contiguous()
            times, trajs = {}, {}
            for name in ("mirror", "lone", "lone", "mirror"):
                chaotic_ann._lib = lambda lib=libs[name]: lib
                trajs.setdefault(name, chaotic_ann.chaotic_ann_traj(
                    *w, xn, **kw))
                times.setdefault(name, []).append(cs.cuda_ms(
                    torch, lambda: chaotic_ann.chaotic_ann_traj(*w, xn, **kw),
                    reps=5, warmup=1))
            same = torch.equal(trajs["mirror"].view(torch.int32),
                               trajs["lone"].view(torch.int32))
            print(f"f32 mxu K2 3-8-3 {act} ({n} lanes x {STEPS} steps): "
                  f"mirror " + " / ".join(f"{v:.4f}" for v in times["mirror"])
                  + " ms, lone lane a " + " / ".join(
                      f"{v:.4f}" for v in times["lone"])
                  + f" ms; trajectories bitwise equal: {same}")
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
