// Helpers shared by the kernel sources in this directory (bcpnn.cu,
// quant.cu, yardstick.cu): warp reductions, the weight layouts and the
// table lookup of the patchy layouts, the TF32 split (the forwards and the
// resident-trace update) and the mma.sync product of the resident-trace
// update.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace bcpnn {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Barrier of the ``threads`` threads of group g only (named barriers 1..;
// 0 is __syncthreads), so a block's groups drift apart and one group's
// loads overlap another's arithmetic.
__device__ __forceinline__ void group_barrier(int g, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(threads) : "memory");
}

// Weight layouts of the forward and update bodies.
enum Layout : int { kDense = 0, kPatchy = 1, kCompact = 2 };

// Pre-synaptic unit (column of x, row of a dense-resident array) of
// contraction index k in post-HC h: k itself when dense, else the k-th
// live unit of the HC's ascending index table.
template <int L>
__device__ __forceinline__ int unit_of(const int* __restrict__ table, int h, int k, int Mi,
                                       int nact) {
  if constexpr (L == kDense) {
    return k;
  } else {
    const int q = k / Mi;
    return table[h * nact + q] * Mi + (k - q * Mi);
  }
}

// fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite value: half of the 13 dropped
// bits added to the magnitude, then cleared (ref.tf32_round).  Two
// full-rate integer operations in place of the cvt, which runs at a
// fraction of that rate (chip_smoke.py's mma.sync yardstick, operands
// split every step).  A NaN's carry may run into the sign bit or leave an
// infinity: split_tf32 carries the NaN in lo instead.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo, hi TF32 and lo = v - hi (exact in fp32).  lo goes to the
// tensor cores whole: they read a TF32 operand's top 19 bits, so it
// enters the product truncated to TF32 (ref.split_tf32_mm models both
// halves), and a rounding is saved.  A NaN v makes lo a NaN whatever hi
// came out as, so the NaN reaches the product.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c += a b on the tensor cores: one m16n8k8 TF32 product, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A weight or bias element as fp32: the forward reads fp32 or bf16 weights.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// In-place softmax of each of ``rows`` rows of a (rows, Mj) fp32 shared
// buffer, written to out[(row0 + r) * Nj + col0 + c]; rows at or past B are
// skipped.  One warp per row at a time.
__device__ __forceinline__ void softmax_rows_to(float* sup, int rows, int Mj, float* __restrict__ out,
                                                int row0, int B, int Nj, int col0) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int lr = warp; lr < rows; lr += blockDim.x / kWarp) {
    const int gr = row0 + lr;
    if (gr >= B) break;  // warp-uniform; rows only grow
    float* srow = sup + lr * Mj;
    float mx = -INFINITY;
    for (int c = lane; c < Mj; c += kWarp) mx = fmaxf(mx, srow[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < Mj; c += kWarp) {
      const float e = expf(srow[c] - mx);
      srow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float* orow = out + (size_t)gr * Nj + col0;
    for (int c = lane; c < Mj; c += kWarp) orow[c] = srow[c] / sum;
  }
}

}  // namespace bcpnn
