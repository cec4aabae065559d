// Issue rates of the bf16x2 ops that the bf16 vpu K1 (bf16x2_bits_kernel,
// bf16x2_lattice_bits_kernel) computes with, and of the conversions,
// shuffles and warp reductions that the mxu K1 forms issue
// (cvt.rn.bf16x2.f32, the round trip's cvt.rn.bf16.f32, __shfl_sync,
// __reduce_xor_sync), against f32 FADD's, on one sm_90a card.  A probe,
// not part of the library: it includes the kernel source for its
// primitives (bf2_add, bf2_mul, bf2_add_relu, pack_bf2) and instantiates
// none of its entry groups.
//
// Build and run from the repo root, on a machine with the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//     -o build/bf16x2_rates tools/bf16x2_rates.cu && build/bf16x2_rates
//
// Each thread runs kRateChains independent chains of kIters ops, so a
// launch is bound by the op's throughput, not its latency.  Printed per
// op: the time of one launch (best of kReps, CUDA events), warp
// instructions a clock per SM at the card's reported maximum clock, the
// same relative to FADD's full rate of 4 (the clock FADD's time implies),
// and results a clock per SM (two per lane for bf16x2 and the packing
// cvt).  The round trip's conversion is timed as the kernels ran it, a
// cvt.rn.bf16.f32 (F2F) and a shift back to f32, one conversion an
// iteration.
#define CHAOTIC_ANN_PART 99   // the primitives only, no entry group
#include "../src/repro_torch/kernels/csrc/chaotic_ann.cu"

#include <cstdio>

namespace {

constexpr int kRateChains = 8, kIters = 4096, kThreadsPerBlock = 256;
constexpr int kReps = 5;

constexpr int kOps = 8;

// The round trip's conversion: f32 -> bf16 (F2F.BF16.F32), back by a shift.
__device__ __forceinline__ uint32_t round_trip(uint32_t v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(__uint_as_float(v)));
  return static_cast<uint32_t>(h) << 16;
}

// OP 0 f32 add, 1 bf16x2 add, 2 bf16x2 mul, 3 bf16x2 add + relu,
// 4 cvt.rn.bf16x2.f32, 5 the round trip's cvt.rn.bf16.f32, 6 __shfl_sync
// from the next lane, 7 __reduce_xor_sync; out keeps the chains' XOR so
// that nothing is dead code.
template <int OP>
__global__ void __launch_bounds__(kThreadsPerBlock)
rate_kernel(uint32_t* __restrict__ out, int iters) {
  constexpr uint32_t kStep = 0x3F7F3F7Fu;   // (0.99609375, 0.99609375)
  const int next = (threadIdx.x + 1) % 32;
  uint32_t v[kRateChains];
#pragma unroll
  for (int c = 0; c < kRateChains; ++c) v[c] = threadIdx.x + c * 0x00010001u;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int c = 0; c < kRateChains; ++c) {
      if (OP == 0) v[c] = __float_as_uint(__fadd_rn(__uint_as_float(v[c]), 1.0f));
      if (OP == 1) v[c] = bf2_add(v[c], kStep);
      if (OP == 2) v[c] = bf2_mul(v[c], kStep);
      if (OP == 3) v[c] = bf2_add_relu(v[c], kStep);
      if (OP == 4)
        v[c] = pack_bf2(__uint_as_float(v[c]), __uint_as_float(v[c]));
      if (OP == 5) v[c] = round_trip(v[c]);
      if (OP == 6) v[c] = __shfl_sync(0xFFFFFFFFu, v[c], next);
      if (OP == 7) v[c] = __reduce_xor_sync(0xFFFFFFFFu, v[c]);
    }
  }
  uint32_t f = 0;
#pragma unroll
  for (int c = 0; c < kRateChains; ++c) f ^= v[c];
  out[static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x] = f;
}

void launch(int op, uint32_t* out, int blocks) {
  if (op == 0) rate_kernel<0><<<blocks, kThreadsPerBlock>>>(out, kIters);
  if (op == 1) rate_kernel<1><<<blocks, kThreadsPerBlock>>>(out, kIters);
  if (op == 2) rate_kernel<2><<<blocks, kThreadsPerBlock>>>(out, kIters);
  if (op == 3) rate_kernel<3><<<blocks, kThreadsPerBlock>>>(out, kIters);
  if (op == 4) rate_kernel<4><<<blocks, kThreadsPerBlock>>>(out, kIters);
  if (op == 5) rate_kernel<5><<<blocks, kThreadsPerBlock>>>(out, kIters);
  if (op == 6) rate_kernel<6><<<blocks, kThreadsPerBlock>>>(out, kIters);
  if (op == 7) rate_kernel<7><<<blocks, kThreadsPerBlock>>>(out, kIters);
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    std::fprintf(stderr, "no CUDA device\n");
    return 1;
  }
  int clock_khz = 0;
  cudaDeviceGetAttribute(&clock_khz, cudaDevAttrClockRate, 0);
  const int sms = prop.multiProcessorCount, blocks = sms * 32;
  uint32_t* out = nullptr;
  cudaMalloc(&out, sizeof(uint32_t) * blocks * kThreadsPerBlock);
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  const char* names[kOps] = {"f32 add", "bf16x2 add", "bf16x2 mul",
                             "bf16x2 add+relu", "cvt.rn.bf16x2.f32 (F2FP)",
                             "cvt.rn.bf16.f32 round trip (F2F + shift)",
                             "__shfl_sync", "__reduce_xor_sync (REDUX)"};
  // results a lane per instruction
  const int per_lane[kOps] = {1, 2, 2, 2, 2, 1, 1, 1};
  const double warp_instrs = static_cast<double>(blocks) * kThreadsPerBlock
                             / 32 * kRateChains * kIters;
  std::printf("%s, %d SMs, max clock %.3f GHz; %d blocks of %d threads, "
              "%d chains x %d ops a thread\n", prop.name, sms,
              clock_khz * 1e-6, blocks, kThreadsPerBlock, kRateChains,
              kIters);
  float best[kOps];
  for (int op = 0; op < kOps; ++op) {
    launch(op, out, blocks);   // warm-up
    best[op] = 1e30f;
    for (int r = 0; r < kReps; ++r) {
      cudaEventRecord(start);
      launch(op, out, blocks);
      cudaEventRecord(end);
      cudaEventSynchronize(end);
      float ms = 0.0f;
      cudaEventElapsedTime(&ms, start, end);
      if (ms < best[op]) best[op] = ms;
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::fprintf(stderr, "launch failed: %s\n", cudaGetErrorString(err));
    return 1;
  }
  for (int op = 0; op < kOps; ++op) {
    const double per_clock = warp_instrs / (best[op] * 1e-3)
                             / (clock_khz * 1e3) / sms;
    const double rel = 4.0 * best[0] / best[op];
    std::printf("%s: %.4f ms, %.2f warp instructions a clock per SM at the "
                "max clock, %.2f at FADD's full rate, %.0f results a clock "
                "per SM\n", names[op], best[op], per_clock, rel,
                rel * 32 * per_lane[op]);
  }
  cudaFree(out);
  return 0;
}
