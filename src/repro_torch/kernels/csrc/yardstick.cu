// A yardstick, not a port of a TPU kernel: the throughput of the
// resident-trace update's tensor-core product (bcpnn.cu::
// trace_update_kernel) without its memory traffic.  Each warp runs the
// update's per-step pattern on register operands: 2 x 4 fragments of A and
// B, 8 accumulators, the three 3xTF32 passes (lo*hi, hi*lo, hi*hi) of
// mma.sync m16n8k8, with the operands split by split_tf32 in every step as
// the kernel does after its shared loads (``split``), or split once
// (operands fixed).  One block of 16 warps per SM, as the update runs.
// chip_smoke.py times it; 2048 FLOP an mma.

#include "common.cuh"

namespace {

using namespace bcpnn;

constexpr int kRateThreads = 512;

template <bool SPLIT>
__global__ void __launch_bounds__(kRateThreads, 1) mma_tf32_rate_kernel(float* out, int iters) {
  float acc[2][4][4] = {};
  float av[2][4], bv[4][2];
  for (int m = 0; m < 2; ++m)
    for (int i = 0; i < 4; ++i) av[m][i] = 1.f + threadIdx.x * 1e-3f + i + m;
  for (int n = 0; n < 4; ++n)
    for (int i = 0; i < 2; ++i) bv[n][i] = 2.f + threadIdx.x * 1e-3f + i + n;
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
  for (int m = 0; m < 2; ++m)
    for (int i = 0; i < 4; ++i) split_tf32(av[m][i], ah[m][i], al[m][i]);
  for (int n = 0; n < 4; ++n)
    for (int i = 0; i < 2; ++i) split_tf32(bv[n][i], bh[n][i], bl[n][i]);
  for (int it = 0; it < iters; ++it) {
    if (SPLIT) {  // fresh operands every step, as from shared memory
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[m][i] + it, ah[m][i], al[m][i]);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) split_tf32(bv[n][i] + it, bh[n][i], bl[n][i]);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(acc[m][n], al[m], bh[n]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(acc[m][n], ah[m], bl[n]);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_tf32(acc[m][n], ah[m], bh[n]);
  }
  float s = 0.f;
  for (int m = 0; m < 2; ++m)
    for (int n = 0; n < 4; ++n)
      for (int q = 0; q < 4; ++q) s += acc[m][n][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}

}  // namespace

extern "C" {

// ``out``: blocks * 512 floats, blocks = the card's SM count (one block an
// SM).  Each block runs 16 warps * iters * 24 mma.sync.
int bcpnn_mma_tf32_rate(float* out, int blocks, int iters, int split, void* stream) {
  if (blocks <= 0 || iters <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (split) {
    mma_tf32_rate_kernel<true><<<blocks, kRateThreads, 0, st>>>(out, iters);
  } else {
    mma_tf32_rate_kernel<false><<<blocks, kRateThreads, 0, st>>>(out, iters);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
