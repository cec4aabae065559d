#!/usr/bin/env python3
"""The f32 scalar K3 and K4 (``f32_gang_bits_kernel``,
``f32_gang_stacked_kernel`` in ``src/repro_torch/kernels/csrc/chaotic_ann.cu``)
in three forms, timed: a thread a lane (the library as built) against a
thread pair and a thread quad a lane.  The library builds one form; this
tool carries the others as a text patch (``SPLIT_CODE``, ``LAUNCH``) and
builds each from a copy of the source.  Needs a CUDA card and nvcc.

    python3 tools/f32_gang_forms.py

In the split forms kSplit consecutive threads of a warp share a lane:
thread part p computes hidden units p * H / kSplit .. (p + 1) * H /
kSplit - 1 (each sum over i in order, the bias add, phi_f32), gathers the
others' by __shfl_sync within its kSplit threads, and runs the I output
sums over all H units in j order, so every thread of the lane holds the
same new state; part 0 of a live lane writes.  Every shuffle needs its
whole warp, so a thread group whose lane does not exist mirrors its
block's or core's last lane and writes nothing.

Shapes: the four 3-8-3 registry nets at the farm's flushes (128
clients x 128 lanes a core, s_block 128, t_block 256, unroll 8): K4 at F1
(4 x 16,384 lanes, 128 rows), K3 at F3 (one more lorenz client: 513
blocks, 128 rows) and at F2 with 1, 2 and 4 cores hot (their blocks 512
rows, the others' 8: 16,384, 32,768 and 65,536 hot lanes), with relu,
tanh and sigmoid, by CUDA events (``chip_smoke.py``'s ``cuda_ms``), in
turns (one, pair, quad, quad, pair, one).  Every form's words and states
are held bitwise to the one-thread form's.  Prints the registers (``-Xptxas
-v``) and, where ``cuobjdump`` is found, the row loop's SASS of each
form's K3 and K4 at 3-8.  The copies are built under
``build/f32_gang_forms/`` (git-ignored).
"""
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# the split forms' row loop and kernels, put into the copy before ANCHOR
ANCHOR = "// The stores of the two-lane K2s"
SPLIT_CODE = r"""
template <int I, int H, int kSplit>
struct HiddenPart {   // part p's columns of w1 and b1
  static constexpr int kUnits = H / kSplit;
  float w1[I][kUnits];
  float b1[kUnits];

  __device__ __forceinline__ HiddenPart(const Weights<I, H>& w, int part) {
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
#pragma unroll
      for (int i = 0; i < I; ++i) w1[i][k] = w.w1[i * H + part * kUnits + k];
      b1[k] = w.b1[part * kUnits + k];
    }
  }
};

template <int I, int H, int ACT, int kSplit>
__device__ __forceinline__ void split_step(float (&x)[I],
                                           const Weights<I, H>& w,
                                           const HiddenPart<I, H, kSplit>& hp) {
  constexpr int kUnits = H / kSplit;
  float h[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) h[k] = __fmul_rn(hp.w1[0][k], x[0]);
#pragma unroll
  for (int i = 1; i < I; ++i) {
#pragma unroll
    for (int k = 0; k < kUnits; ++k)
      h[k] = __fadd_rn(h[k], __fmul_rn(hp.w1[i][k], x[i]));
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
    h[k] = phi_f32<ACT, false>(__fadd_rn(h[k], hp.b1[k]));
  float hj[H];
#pragma unroll
  for (int q = 0; q < kSplit; ++q) {
#pragma unroll
    for (int k = 0; k < kUnits; ++k)
      hj[q * kUnits + k] = __shfl_sync(0xFFFFFFFFu, h[k], q, kSplit);
  }
  float y[I];
#pragma unroll
  for (int i = 0; i < I; ++i) y[i] = __fmul_rn(w.w2[i], hj[0]);
#pragma unroll
  for (int j = 1; j < H; ++j) {
#pragma unroll
    for (int i = 0; i < I; ++i)
      y[i] = __fadd_rn(y[i], __fmul_rn(w.w2[j * I + i], hj[j]));
  }
#pragma unroll
  for (int i = 0; i < I; ++i) x[i] = __fadd_rn(y[i], w.b2[i]);
}

template <int I, int H, int ACT, int kSplit>
__device__ __forceinline__ void split_rows(
    int64_t lane, bool live, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ x0,
    const int64_t* __restrict__ offsets, uint32_t* __restrict__ words,
    float* __restrict__ state, int64_t word_stride, int64_t rows) {
  static_assert(H % kSplit == 0 && 32 % kSplit == 0, "kSplit splits H");
  __shared__ Weights<I, H> ws;
  load_weights<float, I, H>(ws, w1, b1, w2, b2);
  const Weights<I, H> w = ws;
  const HiddenPart<I, H, kSplit> hp(w, threadIdx.x % kSplit);
  const bool writer = live && threadIdx.x % kSplit == 0;
  float x[I];
  load_state<float, I>(x, x0, lane);
  const uint32_t off = static_cast<uint32_t>(offsets[lane]);
  uint32_t* out = words + lane;
  for (int64_t r = 0; r < rows; ++r) {
    split_step<I, H, ACT, kSplit>(x, w, hp);
    const uint32_t hi = fold<float, I>(x);
    split_step<I, H, ACT, kSplit>(x, w, hp);
    const uint32_t lo = fold<float, I>(x);
    uint32_t word = (hi << 16) | lo;
    word ^= (off + static_cast<uint32_t>(r)) * kGolden;
    if (writer) out[r * word_stride] = finalize(word);
  }
  if (writer) store_state<float, I>(state, lane, x);
}

template <int I, int H, int ACT, int kSplit>
__global__ void __launch_bounds__(kThreads)
split_gang_bits_kernel(const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ x0,
                       const int32_t* __restrict__ core_map,
                       const int32_t* __restrict__ rows,
                       const int64_t* __restrict__ offsets,
                       uint32_t* __restrict__ words, float* __restrict__ state,
                       int64_t n_lanes, int64_t s_block, int64_t n_rows) {
  const GangCta<kSplit, kThreads, 1> g(n_lanes, s_block);
  const int64_t core = core_map[g.block];
  const int64_t my_rows = rows[g.block] < n_rows ? rows[g.block] : n_rows;
  const int64_t slot =
      static_cast<int64_t>(g.cta) * g.kSpan + threadIdx.x / kSplit;
  const bool live = slot < g.end;
  split_rows<I, H, ACT, kSplit>(g.first + (live ? slot : g.end - 1), live,
                                w1 + core * I * H, b1 + core * H,
                                w2 + core * H * I, b2 + core * I, x0,
                                offsets, words, state, n_lanes, my_rows);
}

template <int I, int H, int ACT, int kSplit>
__global__ void __launch_bounds__(kThreads)
split_gang_stacked_kernel(const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          const float* __restrict__ x0,
                          const int32_t* __restrict__ rows,
                          const int64_t* __restrict__ offsets,
                          uint32_t* __restrict__ words,
                          float* __restrict__ state, int64_t n_cores,
                          int64_t n_lanes, int64_t n_rows) {
  const int64_t core = blockIdx.y;
  const int64_t base = core * n_lanes;
  const int64_t my_rows = rows[core] < n_rows ? rows[core] : n_rows;
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * (kThreads / kSplit)
                       + threadIdx.x / kSplit;
  const bool live = slot < n_lanes;
  split_rows<I, H, ACT, kSplit>(live ? slot : n_lanes - 1, live,
                                w1 + core * I * H, b1 + core * H,
                                w2 + core * H * I, b2 + core * I,
                                x0 + base * I, offsets + base, words + base,
                                state + base * I, n_cores * n_lanes, my_rows);
}

"""
# (text as built, text in a split form) of the f32 branches of
# launch_gang_bits and launch_gang_stacked; {s} is kSplit
LAUNCH = ((
    "      const int64_t grid = n_lane_blocks * (s_block / kThreads);\n"
    "      if (grid > 0x7FFFFFFF) return -2;\n"
    "      f32_gang_bits_kernel<I, H, decltype(a)::value>\n",
    "      const int64_t grid = n_lane_blocks * (s_block / (kThreads / {s}));\n"
    "      if (grid > 0x7FFFFFFF) return -2;\n"
    "      split_gang_bits_kernel<I, H, decltype(a)::value, {s}>\n"), (
    "      const dim3 grid(static_cast<unsigned>(n_blocks(n_lanes)),\n"
    "                      static_cast<unsigned>(n_cores));\n"
    "      f32_gang_stacked_kernel<I, H, decltype(a)::value>\n",
    "      const dim3 grid(static_cast<unsigned>(n_blocks(n_lanes * {s})),\n"
    "                      static_cast<unsigned>(n_cores));\n"
    "      split_gang_stacked_kernel<I, H, decltype(a)::value, {s}>\n"))
FORMS = {"one": 1, "pair": 2, "quad": 4}
KEYS = ("w1", "b1", "w2", "b2")
BASES = ("chen", "chua", "lorenz", "rossler")
POOL = 16_384                     # lanes a core: 128 clients x 128 lanes
S_BLOCK, T_BLOCK, UNROLL = 128, 256, 8


def kernels(split: int):
    """The K3 and K4 instantiations a form launches at 3-8."""
    if split == 1:
        return tuple(("f32_gang_bits_kernel", (3, 8, a)) for a in range(3)) \
            + (("f32_gang_stacked_kernel", (3, 8, 0)),)
    return tuple(("split_gang_bits_kernel", (3, 8, a, split))
                 for a in range(3)) + (
        ("split_gang_stacked_kernel", (3, 8, 0, split)),)


def split_source(src: str, split: int) -> str:
    """The library's source with its f32 K3 and K4 launched in kSplit
    threads a lane."""
    out = src.replace(ANCHOR, SPLIT_CODE + ANCHOR)
    for built, form in LAUNCH:
        out = out.replace(built, form.format(s=split))
    return out


def report(log: str, split: int) -> str:
    """Registers and spill bytes of the form's instantiations, and their
    row loops' SASS (``chip_smoke.sass_counts``)."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    regs = []
    for name, args in kernels(split):
        want = cs.mangled(name, args)
        for entry in log.split("Compiling entry function '")[1:]:
            if want in entry.split("'", 1)[0]:
                m = re.search(r"Used (\d+) registers", entry)
                spill = sorted({int(n) for n in
                                re.findall(r"(\d+) bytes spill", entry)})
                regs.append(f"{name}<{', '.join(map(str, args))}> "
                            f"{m.group(1) if m else '?'} registers, spill "
                            f"{spill}")
    cs.SASS_KERNELS, cs.SASS_FREE = kernels(split), {}   # count, do not gate
    dump = cs.sass_dump_start(build.library_path(build.SOURCE))
    try:
        sass, _ = cs.sass_counts(dump)
    finally:
        cs.sass_dump_stop(dump)
    return "; ".join(regs) + f"\n  sass: {sass}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, chaotic_ann
    from repro_torch.prng.stream import default_params

    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}; "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    src = (build.CSRC / build.SOURCE).read_text()
    if any(src.count(t) != 1 for t in (ANCHOR,) + tuple(b for b, _ in LAUNCH)):
        raise SystemExit("the f32 gang launchers changed: update LAUNCH")
    libs, csrc = {}, build.CSRC
    for name, split in FORMS.items():
        if split > 1:
            d = ROOT / "build" / "f32_gang_forms" / name
            d.mkdir(parents=True, exist_ok=True)
            (d / build.SOURCE).write_text(split_source(src, split))
            build.CSRC = d
            build.library_path(build.SOURCE).unlink(missing_ok=True)
        log = build.build()
        if log:
            print(f"{name}: {report(log, split)}")
        chaotic_ann._lib.cache_clear()
        libs[name] = chaotic_ann._lib()
        build.CSRC = csrc

    per = [default_params(system=s) for s in BASES]
    w = [torch.as_tensor(np.stack([p[k] for p in per]), device=dev)
         for k in KEYS]
    rng = np.random.default_rng(29)
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (4 * POOL + S_BLOCK, 3)),
                        dtype=torch.float32, device=dev)
    off = torch.as_tensor(rng.integers(0, 1 << 32, x.shape[0]),
                          dtype=torch.int64, device=dev)
    blocks = np.array([POOL // S_BLOCK] * 4)
    cm = np.repeat(np.arange(4), blocks)
    cm_f3 = np.repeat(np.arange(4), blocks + np.array([0, 0, 1, 0]))
    gkw = dict(s_block=S_BLOCK, t_block=T_BLOCK, unroll=UNROLL)
    x4, off4 = x[:4 * POOL], off[:4 * POOL]
    cases = {}      # label: (call, the rows each lane computes)
    every = torch.tensor(1 << 30, device=dev)
    for act in ("relu", "tanh", "sigmoid"):
        cases[f"K4 F1 {act}, 4 x 16,384 lanes, 128 rows"] = (
            lambda act=act: chaotic_ann.chaotic_ann_gang_stacked(
                *w, x4.reshape(4, POOL, 3), off4.reshape(4, POOL),
                n_steps=256, activation=act), every)
        cases[f"K3 F3 {act}, 65,664 lanes, 128 rows"] = (
            lambda act=act: chaotic_ann.chaotic_ann_gang_bits(
                *w, x, cm_f3, off, n_steps=256, activation=act, **gkw), every)
        for hot in (1, 2, 4):
            rows = np.repeat([512] * hot + [8] * (4 - hot), blocks)
            eff = chaotic_ann.gang_effective_rows(rows, 1024, T_BLOCK, UNROLL)
            cases[f"K3 F2 {act}, {hot * POOL:,} hot lanes x 512 rows"] = (
                lambda act=act, rows=rows: chaotic_ann.chaotic_ann_gang_bits(
                    *w, x4, cm, off4, rows, n_steps=1024, activation=act,
                    **gkw),
                torch.as_tensor(np.repeat(eff, S_BLOCK), device=dev))
    for label, (fn, lane_rows) in cases.items():
        times, outs = {}, {}
        for name in list(FORMS) + list(FORMS)[::-1]:
            chaotic_ann._lib = lambda lib=libs[name]: lib
            outs.setdefault(name, fn())
            times.setdefault(name, []).append(cs.cuda_ms(
                torch, fn, reps=10, warmup=2))
        wa, sa = outs["one"]
        same = all(cs.masked_err(torch, wa, wb, lane_rows) == 0.0
                   and cs.max_abs_err(torch, sa, sb) == 0.0
                   for wb, sb in outs.values())
        print(f"f32 {label}: " + ", ".join(
            f"{name} " + " / ".join(f"{v:.4f}" for v in times[name])
            for name in FORMS) + f" ms; words and states bitwise equal: "
            f"{same}")
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
