// Helpers shared by the kernel sources in this directory (bcpnn.cu,
// quant.cu, yardstick.cu): warp reductions, the weight layouts and the
// table lookup of the patchy layouts, the TF32 split (the forwards and the
// resident-trace update), the mma.sync product of the resident-trace
// update, cp.async copies, the wgmma descriptor and fences, mbarriers and
// TMA copies (the fp32 and int8 forwards), and the copy routes of a
// forward's slices (StageCopy).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace bcpnn {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may take

// How a forward's raw slices move: TMA tensor copies, or cp.async in 16-,
// 8- (x only, gathered) or 4-byte pieces, or plain loads (w only: rows
// too narrow or misaligned for 4-byte pieces).
enum StageCopy : int { kCopyTma = 0, kCopy16 = 1, kCopy4 = 2, kCopyElem = 3, kCopy8 = 4 };

// Sub-warp reductions over the L lanes (a power of two, at most 32) that
// share a segment (a whole warp: L = kWarp), in log2(L) xor shuffles.
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16, 8 or 4 bytes global -> shared, zero filled when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Orders this thread's earlier generic-proxy accesses of shared memory
// (loads, stores, cp.async) before the async proxy's later ones (bulk
// copies, wgmma operand reads): run before the barrier after which a region
// is refilled or read by the tensor cores.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The wgmma shared-memory descriptor of a K-major tile without swizzle:
// start address, leading byte offset 128 (k), stride byte offset 256 (rows).
// A core matrix is 8 rows x 16 bytes (4 tf32 or 16 int8 values of k), 128
// contiguous bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// mbarriers: init (``count`` arrivals a phase; one for those completed by
// bulk (TMA) copies), arrive, arrive expecting ``bytes``, wait for a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One 2-D TMA tensor copy of the box at (c0 inner, c1 outer), completing on bar.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// One 3-D TMA tensor copy of the box at (c0 inner, c1, c2 outer), completing on bar.
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// The CUDA driver's tensor-map encoder, found through the runtime (the
// library links only the runtime).
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

// A row-major tensor of 2 or 3 dimensions (dims and box innermost first)
// copied in boxes, zero filled outside.
inline bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int esize,
                       int rank, const long long* dims, const int* box) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t d[3], strides[2];
  cuuint32_t b[3];
  const cuuint32_t estrides[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    if (i > 0) strides[i - 1] = (i == 1 ? (cuuint64_t)esize : strides[i - 2]) * d[i - 1];
  }
  return encode(map, type, (cuuint32_t)rank, const_cast<void*>(base), d, strides, b, estrides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Named barriers (0 is __syncthreads): arrive without waiting (the other
// side syncs), or sync the ``threads`` threads of barrier id.
__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
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
    mx = group_max<kWarp>(mx);
    float sum = 0.f;
    for (int c = lane; c < Mj; c += kWarp) {
      const float e = expf(srow[c] - mx);
      srow[c] = e;
      sum += e;
    }
    sum = group_sum<kWarp>(sum);
    float* orow = out + (size_t)gr * Nj + col0;
    for (int c = lane; c < Mj; c += kWarp) orow[c] = srow[c] / sum;
  }
}

}  // namespace bcpnn
