// Hand-written Hopper (sm_90a) int8 forwards of the low-precision serving
// path, for the three Pallas TPU kernels of repro/kernels/quant.py:
//
//   bcpnn_quant_fwd, layout dense    <- quant.py::quant_fwd_pallas
//                                       (quant_fwd_tc_kernel: s8 tensor cores;
//                                       some shapes quant_fwd_kernel, below)
//   bcpnn_quant_fwd, layout compact  <- quant.py::quant_compact_forward
//   bcpnn_quant_fwd, layout patchy   <- quant.py::quant_patchy_forward
//                                       (both quant_fwd_kernel: __dp4a)
//
// rates[b, h*Mj + n] = softmax_n(gain * (acc[b, h*Mj + n] * su[h] + bias)),
//   acc = sum_k round(clip(x[b, unit(k)], 0, 1) * 127) * w_q[k, h*Mj + n],
//   su[h] = scale[h] * fp32(1/127).
//
// The TPU kernels take pre-quantized, pre-gathered (Hj, B, K) activation
// codes and emulate the int8 product on the float unit, exact only for
// blocks of at most 1040 terms.  Here a block quantizes x as it stages it
// (round half to even, as jnp.round), and accumulates exactly in int32 for
// any K the wrapper accepts.  The epilogue is fp32 with each operation
// rounded on its own (no contraction into an FMA), as the plain PyTorch
// version computes it, then the HC's softmax (IEEE expf, true division).
//
// Bound: bytes.  At Model 1 (B=128, Ni=1568, Nj=4096) the dense forward
// reads 6.4 MB of codes and 0.8 MB of fp32 x and writes 2.1 MB of rates,
// ~2.8 us at 3.35 TB/s; its 1.64 G int8 operations take ~0.8 us at the
// tensor cores' 1979 TOP/s.
//
// C interface as in bcpnn.cu: device pointers, sizes and the stream; the
// launch's cudaGetLastError() is returned.

#include <cooperative_groups.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace bcpnn;

// fp32(1/127): the Q0.7 activation step, as the reference's ``scale *
// ACT_SCALE`` rounds it.
constexpr float kActScale = 1.0f / 127.0f;

// ----------------------------------------- the dense tensor-core body --
//
// quant_fwd_tc_kernel<BN>: the dense layout on the s8 tensor cores, for HCs
// of Mj <= 128 columns that are whole 16-byte runs of codes (Mj % 16 == 0)
// of a 16-byte aligned w (the launcher sends other shapes to the __dp4a
// body below).  What bounds it and what the design does about it:
//
//  * Grid: one thread-block cluster per (batch tile of 128 rows, post-HC),
//    of KS blocks that split the contraction between them in 32-deep
//    slices (contiguous runs of slices a rank), so that 32 post-HCs fill
//    the card; KS (1..8) is the one with the fewest waves per share of
//    work, from cudaOccupancyMaxActiveClusters, as bcpnn_fwd_tc_kernel
//    picks it.  A cluster of one is launched without the attribute.  After
//    its slices a rank parks its int32 partial sums in shared memory and
//    pushes each other rank its KS-th of the tile's rows, one bulk copy
//    through distributed shared memory each; each rank then sums its rows
//    over the cluster's partials (integer adds, exact in any order, so the
//    rates do not depend on KS), adds the dequant, bias and gain and takes
//    the HC's softmax in registers, a warp a row.
//  * Products: wgmma m64nBNk32 s8 x s8 -> s32, both operands read by the
//    tensor cores from K-major code tiles in shared memory (8 rows x 16
//    bytes a core matrix, no swizzle), two warpgroups of 64 rows.  wgmma
//    and not mma.sync m16n8k32: the tensor cores read B once a warpgroup
//    from shared memory, where eight mma.sync warps would each load all of
//    it into registers; the product is a small part of a slice's time
//    either way.  8-bit wgmma operands must be K-major in shared memory;
//    the pack keeps the reference's row-major (Ni, Nj) codes, so w is
//    transposed at staging.
//  * Staging: raw slices (x [128][32] fp32, w [32][BN] codes) arrive by
//    TMA tensor copies (two a slice, zero filled past B, K and Nj) into a
//    ring of eight stages; a tensor-core thread refills a stage as soon as
//    its slice is laid out, so the copies run eight slices ahead (with four
//    or five, their latency set the pace).  Eight staging warps lay each
//    slice out in one of four code buffers: each x float4 becomes four Q0.7
//    codes (saturate, x127, and +1.5*2^23, which rounds to the nearest
//    integer, ties to even, as __float2int_rn, at a quarter of its cost);
//    each 4 x 4 block of w codes is transposed with __byte_perm.  mbarriers
//    pass the code buffers between the roles (full: an arrival a staging
//    warp; empty: one a tensor-core warp), so each staging warp runs at its
//    own pace.  With cp.async in place of TMA, issuing a slice's copies
//    took the staging warps as long as laying it out.
//  * Epilogue: the HC softmax, IEEE expf, and the quotient by the
//    reciprocal of the row's sum with one exact correction (quotient()):
//    the division's result down to 2^-118, without its slow path.
//  * The x traffic: every post-HC's cluster reads all of x in fp32 (32 x
//    0.8 MB through L2 at Model 1) and quantizes it again; the codes are
//    made once a tile, by the rank whose slice it is.

constexpr int kTqRows = 128;       // batch rows per block
constexpr int kTqK = 32;           // contraction slice: one wgmma k32 step
constexpr int kTqStages = 8;       // raw stages: the copies' latency over their pace
constexpr int kTqCodes = 4;        // code buffers between the two roles
constexpr int kTqMma = 256;        // two warpgroups of tensor-core warps (first), 64 rows each
constexpr int kTqStage = 256;      // eight staging warps
constexpr int kTqThreads = kTqMma + kTqStage;
constexpr int kTqMaxCluster = 8;

// One block's shared-memory map, in bytes: the raw ring, then the code
// buffers (x codes [128 rows], then w codes [BN columns], each as K-major
// core matrices); the int32 partial sums alias the ring after the slices.
template <int BN>
struct QTile {
  static constexpr int kRawX = kTqRows * kTqK * 4;  // raw x [128][32] fp32
  static constexpr int kStage = kRawX + kTqK * BN;   // then raw w [32][BN]
  static constexpr int kA = kTqRows * kTqK;
  static constexpr int kCode = kA + BN * kTqK;
  static constexpr int kRing = kTqStages * kStage;
  static constexpr int kPipe = kRing + kTqCodes * kCode;
  static constexpr int kLdP = BN + 8;  // partial rows: conflict-free int2 stores
  // after the slices: this rank's partials for all 128 rows, then those of
  // its rows received from the other ranks (at most 114 rows: 6 x 19 at a
  // cluster of 7)
  static constexpr int kPart = (kTqRows + 114) * kLdP * 4;
  // mbarriers: one a raw stage, the partials received from the ranks, and
  // each code buffer's full and empty
  static constexpr int kBars = (kPipe > kPart ? kPipe : kPart + 127) / 128 * 128;
  static constexpr int kRecvBar = kTqStages, kFullBar = kRecvBar + 1;
  static constexpr int kEmptyBar = kFullBar + kTqCodes;
  static constexpr int kSmem = kBars + 8 * (kEmptyBar + kTqCodes);
  static_assert(kStage % 128 == 0 && kCode % 128 == 0, "128-byte aligned regions");
};

// Byte offset of (row r, k) in a K-major k32 code tile.
__device__ __forceinline__ int kmajor8(int r, int k) {
  return (r >> 3) * 256 + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

// Q0.7 code of a rate in the low byte: round(clip(v, 0, 1) * 127), half to
// even.  The product lies in [0, 127]; adding 1.5 * 2^23 leaves an ulp of
// 1, so the sum is rounded to the nearest integer (ties to even), which
// sits in the low mantissa bits.  __saturatef maps a NaN to 0, as
// fminf(fmaxf(v, 0), 1) does.
__device__ __forceinline__ uint32_t code_bits(float v) {
  return __float_as_uint(__fadd_rn(__fmul_rn(__saturatef(v), 127.f), 12582912.f));
}

__device__ __forceinline__ uint32_t code4(float4 f) {
  const uint32_t lo = __byte_perm(code_bits(f.x), code_bits(f.y), 0x0040);
  const uint32_t hi = __byte_perm(code_bits(f.z), code_bits(f.w), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// d (64 x N, this thread's N/2 int32) += A (64 x 32) B (32 x N), both s8
// K-major in shared memory, issued by one warpgroup; scale_d = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// a / b rounded to nearest, given inv = 1/b rounded to nearest: the
// quotient through the reciprocal, then one correction by the residual
// a - q b, exact in an FMA (Markstein).  It equals the division wherever
// the quotient is at least 2^-118; below, where the residual underflows,
// it may differ by less than 1e-42.  The division operator checks for such
// operands and takes a slow path on them, which the many exp values that
// underflow in a sharp HC made most of the epilogue's time.
__device__ __forceinline__ float quotient(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  return __fmaf_rn(__fmaf_rn(-q, b, a), inv, q);
}

// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from this block's shared memory to the same-placed dst of cluster rank
// ``rank``, completing on that rank's mbarrier at bar's place.
__device__ __forceinline__ void push_rows(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, int rank) {
  uint32_t d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(d), "r"(smem_u32(src)), "r"(bytes), "r"(b)
      : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int BN>
__global__ void __launch_bounds__(kTqThreads, 1)
quant_fwd_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw, const float* __restrict__ bias,
                    const float* __restrict__ scale, float* __restrict__ out, int B, int K,
                    int Nj, int Mj, int ks, float gain) {
  using Q = QTile<BN>;
  constexpr int NA = BN / 2;  // accumulators a thread
  extern __shared__ __align__(1024) unsigned char qsm[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * kTqRows;
  const int h = blockIdx.z, col0 = h * Mj;
  // this rank's slices of the contraction
  const int total = (K + kTqK - 1) / kTqK;
  const int s0 = rank * total / ks, slices = (rank + 1) * total / ks - s0;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  auto raw_x = [&](int s) { return reinterpret_cast<float*>(qsm + (s % kTqStages) * Q::kStage); };
  auto raw_w = [&](int s) { return qsm + (s % kTqStages) * Q::kStage + Q::kRawX; };
  auto codes = [&](int s) { return qsm + Q::kRing + (s % kTqCodes) * Q::kCode; };

  const int st = tid - kTqMma;  // a staging thread's index
  uint64_t* bars = reinterpret_cast<uint64_t*>(qsm + Q::kBars);
  // The TMA copies of slice s into its raw stage, issued by the first
  // tensor-core thread.
  auto fetch = [&](int s) {
    if (s < slices) {
      const int k0 = (s0 + s) * kTqK;
      uint64_t* bar = bars + s % kTqStages;
      mbar_expect(bar, (uint32_t)Q::kStage);
      tma_2d(raw_x(s), &tmx, k0, row0, bar);
      tma_2d(raw_w(s), &tmw, col0, k0, bar);
    }
  };
  uint64_t* full = bars + Q::kFullBar;    // a code buffer is laid out: a staging warp's arrival
  uint64_t* empty = bars + Q::kEmptyBar;  // its products are done: a tensor-core warp's
  if (tid == 0) {
    for (int q = 0; q <= kTqStages; ++q) mbar_init(bars + q);
    for (int b = 0; b < kTqCodes; ++b) {
      mbar_init(full + b, kTqStage / kWarp);
      mbar_init(empty + b, kTqMma / kWarp);
    }
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tmx) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tmw) : "memory");
  }
  // the epilogue's operands, read while the slices stream
  const float su = __fmul_rn(scale[h], kActScale);
  const int c = 4 * lane;
  const bool lc = c < Mj;  // Mj % 16 == 0: a lane's four columns are all in or all out
  float b4[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) b4[e] = lc ? __ldg(bias + col0 + c + e) : 0.f;
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kTqStages; ++s) fetch(s);
  }

  // The staging warps lay slice s's raw stage out in its code buffer: all
  // of a thread's shared loads first, then the codes and their stores (the
  // compiler cannot move a load above a store that may alias it).
  auto lay_out = [&](int s) {
    constexpr int kX = kTqRows * kTqK / 4 / kTqStage;  // x float4s a thread
    constexpr int kCq = BN / 4;                          // w column quads
    static_assert(8 * kCq <= kTqStage, "one w block a thread at most");
    const float* rx = raw_x(s);
    const unsigned char* rw = raw_w(s);
    unsigned char* cb = codes(s);
    // x: a warp reads 4 rows, eight lanes a whole row
    float4 xr[kX];
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int p = st + i * kTqStage;
      xr[i] = *reinterpret_cast<const float4*>(rx + (p >> 3) * kTqK + 4 * (p & 7));
    }
    // w: 8 k-quads x BN/4 column quads, a 4 x 4 block of codes a thread, a
    // warp's lanes on 16 column quads of two k-quads.  The thread's columns
    // are rotated by rot (its words' bytes permuted before the transpose),
    // so that a store instruction covers 16 banks, as the loads do.
    const bool wt = st < 8 * kCq;
    const int wc = (st >> 1) % kCq, q = (((st >> 1) / kCq) << 1) | (st & 1);
    const int rot = (wc >> 1) & 3;
    uint32_t in[4];
    if (wt) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        in[m] = *reinterpret_cast<const uint32_t*>(rw + (4 * q + m) * BN + 4 * wc);
      }
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int p = st + i * kTqStage;
      *reinterpret_cast<uint32_t*>(cb + kmajor8(p >> 3, 4 * (p & 7))) = code4(xr[i]);
    }
    if (wt) {
      const uint32_t sel = (0x32103210u >> (4 * rot)) & 0xFFFFu;
#pragma unroll
      for (int m = 0; m < 4; ++m) in[m] = __byte_perm(in[m], 0, sel);
      const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);
      const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
      const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);
      const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
      const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * wc + ((j + rot) & 3);
        *reinterpret_cast<uint32_t*>(cb + Q::kA + kmajor8(n, 4 * q)) = o[j];
      }
    }
  };

  int acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0;
  const int wg = warp / 4;  // tensor-core warps: rows 64 wg .. 64 wg + 63
  if (warp < kTqMma / kWarp) {
    // ---- tensor-core warpgroups: wgmma on code buffer s % kTqCodes --------
#pragma unroll 1
    for (int s = 0; s < slices; ++s) {
      mbar_wait(full + s % kTqCodes, (s / kTqCodes) & 1);
      // slice s is laid out: its raw stage takes slice s + kTqStages
      if (tid == 0) fetch(s + kTqStages);
      const unsigned char* cb = codes(s);
      wgmma_fence();
      fence_acc<NA>(acc);
      wgmma_s8<BN>(acc, wgmma_desc(cb + wg * 64 * kTqK), wgmma_desc(cb + Q::kA), 1);
      wgmma_commit();
      fence_acc<NA>(acc);
      wgmma_wait<1>();  // slice s - 1's product is done: its buffer is free
      fence_acc<NA>(acc);
      if (s > 0 && lane == 0) mbar_arrive(empty + (s - 1) % kTqCodes);
    }
    wgmma_wait<0>();
    fence_acc<NA>(acc);
  } else {
    // ---- staging warps: quantize, transpose, lay out K-major ---------------
    // (each warp at its own pace: a slice's raw stage is refilled once the
    // tensor-core warps have seen it laid out by all of them)
#pragma unroll 1
    for (int s = 0; s < slices; ++s) {
      mbar_wait(bars + s % kTqStages, (s / kTqStages) & 1);
      // the products of slice s - kTqCodes, the buffer's last, are done
      if (s >= kTqCodes) mbar_wait(empty + s % kTqCodes, (s / kTqCodes - 1) & 1);
      lay_out(s);
      // the tensor cores read the codes, and TMA refills the raw stage
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full + s % kTqCodes);
    }
  }
  __syncthreads();  // the ring is free: it takes the partial sums

  // The rows [r0, r0 + nrows) of the tile are this rank's to finish.  Each
  // rank parks its partials for all rows (part), then pushes each other
  // rank's rows to it by one bulk copy through distributed shared memory
  // (slot of the sender in the receiver's recv), completing on the
  // receiver's mbarrier; reads of remote partials by the threads, a round
  // trip each, took most of the epilogue.
  const int r0 = rank * kTqRows / ks, nrows = (rank + 1) * kTqRows / ks - r0;
  const int maxrows = (kTqRows + ks - 1) / ks;
  int* part = reinterpret_cast<int*>(qsm);
  int* recv = part + kTqRows * Q::kLdP;
  uint64_t* recv_bar = bars + Q::kRecvBar;
  if (warp < kTqMma / kWarp) {
    // acc[4 n8 + 2 e + j] is row 16 (warp % 4) + g + 8 e, column 8 n8 + 2 t
    // + j of the warpgroup's 64 rows
    const int g = lane / 4, t = lane % 4;
    const int rb = wg * 64 + (warp % 4) * 16 + g;
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        *reinterpret_cast<int2*>(part + (rb + 8 * e) * Q::kLdP + n8 * 8 + 2 * t) =
            make_int2(acc[4 * n8 + 2 * e], acc[4 * n8 + 2 * e + 1]);
      }
    fence_proxy_async();  // the bulk copies read the partials
  }
  if (ks > 1) {
    if (tid == 0) mbar_expect(recv_bar, (uint32_t)((ks - 1) * nrows * Q::kLdP * 4));
    cluster.sync();  // every rank's partials are parked and its buffers dead
    if (tid < ks && tid != rank) {
      const int q0 = tid * kTqRows / ks, qn = (tid + 1) * kTqRows / ks - q0;
      push_rows(recv + (rank < tid ? rank : rank - 1) * maxrows * Q::kLdP,
                part + q0 * Q::kLdP, (uint32_t)(qn * Q::kLdP * 4), recv_bar, tid);
    }
    mbar_wait(recv_bar, 0);
    // this rank's copies in are done; it leaves only after every rank's
    // (the barrier orders no data)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  } else {
    __syncthreads();
  }

  // ---- the cluster's sum, dequant, bias, gain and the softmax, a warp a
  // row, four columns a lane, three rows a warp at a time (one round at a
  // cluster of 3).
  constexpr int kRowWarps = kTqThreads / kWarp, kRows = 3;
  const int rounds = (nrows + kRows * kRowWarps - 1) / (kRows * kRowWarps);
  for (int round = 0; round < rounds; ++round) {
    int lr[kRows];
    bool live[kRows];  // warp-uniform
    int a[kRows][4] = {};
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      lr[j] = r0 + (round * kRows + j) * kRowWarps + warp;
      live[j] = lr[j] < r0 + nrows && row0 + lr[j] < B;
#pragma unroll
      for (int q = 0; q < kTqMaxCluster; ++q) {
        if (q < ks && live[j] && lc) {
          const int4 p = *reinterpret_cast<const int4*>(
              q == 0 ? part + lr[j] * Q::kLdP + c
                     : recv + ((q - 1) * maxrows + lr[j] - r0) * Q::kLdP + c);
          a[j][0] += p.x; a[j][1] += p.y; a[j][2] += p.z; a[j][3] += p.w;
        }
      }
    }
    float v[kRows][4], mx[kRows], sum[kRows], inv[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      mx[j] = -INFINITY;
      if (live[j] && lc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(a[j][e]), su), b4[e]), gain);
          mx[j] = fmaxf(mx[j], v[j][e]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) mx[j] = group_max<kWarp>(mx[j]);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      sum[j] = 0.f;
      if (live[j] && lc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = expf(v[j][e] - mx[j]);
          sum[j] += v[j][e];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      sum[j] = group_sum<kWarp>(sum[j]);
      inv[j] = __frcp_rn(sum[j]);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (live[j] && lc) {
        *reinterpret_cast<float4*>(out + (size_t)(row0 + lr[j]) * Nj + col0 + c) =
            make_float4(quotient(v[j][0], sum[j], inv[j]), quotient(v[j][1], sum[j], inv[j]),
                        quotient(v[j][2], sum[j], inv[j]), quotient(v[j][3], sum[j], inv[j]));
      }
    }
  }
  if (ks > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The cluster size with the least time: a block's share of the work is
// 1/ks, and the clusters run in ceil(clusters / co-resident clusters)
// waves.  The co-resident counts are kept per (device, BN, cluster size),
// under a lock.  Also sets the kernel's shared-memory limit.
template <int BN>
cudaError_t quant_cluster_size(int B, int K, int Hj, int* ks_out) {
  const size_t smem = QTile<BN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(quant_fwd_tc_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int total = (K + kTqK - 1) / kTqK;
  const long long clusters = (long long)((B + kTqRows - 1) / kTqRows) * Hj;
  static std::mutex lock;
  static std::map<std::tuple<int, int, int>, int> seen;  // -> co-resident clusters
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kTqThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int ks = 1;
  double best = 0.0;
  for (int k = 1; k <= kTqMaxCluster && k <= total; ++k) {
    const auto key = std::make_tuple(device, BN, k);
    int n = 0;
    {
      const std::lock_guard<std::mutex> hold(lock);
      const auto it = seen.find(key);
      if (it != seen.end()) {
        n = it->second;
      } else {
        cfg.gridDim = dim3(k, 1, 1);
        attr[0].val.clusterDim.x = k;
        err = cudaOccupancyMaxActiveClusters(&n, (void*)quant_fwd_tc_kernel<BN>, &cfg);
        if (err != cudaSuccess) return err;
        seen[key] = n;
      }
    }
    if (n <= 0) continue;
    const double cost = (double)((clusters + n - 1) / n) / k;
    if (best == 0.0 || cost < best) {
      best = cost;
      ks = k;
    }
  }
  if (best == 0.0) return cudaErrorInvalidConfiguration;
  *ks_out = ks;
  return cudaSuccess;
}

template <int BN>
cudaError_t launch_quant_tc(const float* x, const int8_t* w, const float* bias,
                            const float* scale, float* out, int B, int Ni, int Hj, int Mj,
                            float gain, cudaStream_t stream) {
  int ks = 0;
  cudaError_t err = quant_cluster_size<BN>(B, Ni, Hj, &ks);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (B + kTqRows - 1) / kTqRows, Hj);
  cfg.blockDim = dim3(kTqThreads);
  cfg.dynamicSmemBytes = QTile<BN>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;  // a grid without clusters has clusters of one block
  CUtensorMap tmx = {}, tmw = {};
  const long long xdims[2] = {Ni, B}, wdims[2] = {(long long)Hj * Mj, Ni};
  const int xbox[2] = {kTqK, kTqRows}, wbox[2] = {BN, kTqK};
  if (!tensor_map(&tmx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, xdims, xbox) ||
      !tensor_map(&tmw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, wdims, wbox)) {
    return cudaErrorInvalidValue;
  }
  err = cudaLaunchKernelEx(&cfg, quant_fwd_tc_kernel<BN>, tmx, tmw, bias, scale, out, B, Ni,
                           Hj * Mj, Mj, ks, gain);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The routing rule of the dense layout: the tensor-core body takes HCs of
// at most 128 columns that are whole 16-byte runs of codes, with both
// operands' rows 16-byte aligned and sized (TMA copies them); every other
// shape (Mj % 16 != 0, Mj > 128, Ni % 4 != 0, x or the codes at an address
// that is not 16-byte aligned) takes the __dp4a body.  Decided from the
// shape and the pointers alone, never from a failed launch.
inline bool quant_tc_takes(const float* x, const int8_t* w, int Ni, int Mj) {
  return Mj % 16 == 0 && Mj <= 128 && Ni % 4 == 0 && aligned16(x) && aligned16(w);
}

// fn(tile) with the tensor-core body's column tile for the HC width.
template <class Fn>
cudaError_t with_quant_tile(int Mj, Fn&& fn) {
  if (Mj <= 16) return fn(std::integral_constant<int, 16>{});
  if (Mj <= 32) return fn(std::integral_constant<int, 32>{});
  if (Mj <= 64) return fn(std::integral_constant<int, 64>{});
  return fn(std::integral_constant<int, 128>{});
}

// ------------------------------------------------------- the __dp4a body --
//
// quant_fwd_kernel<TN, L>: the patchy and compact layouts, and the dense
// shapes the tensor-core body does not take.  The block quantizes x in its
// tile load and looks each row's unit up in the (Hj, nact) table there
// too; __dp4a: four int8 products an instruction on the CUDA cores.
//
// Grid: one block per (batch tile of kQRows rows, post-HC); the HC's Mj
// columns in chunks of TN.  Four K-groups of 256 threads take every fourth
// kQK-deep slice of K: each stages its slice's activation codes (row-major,
// four consecutive k per 32-bit word) and weight codes (transposed in
// registers with __byte_perm so a word holds four consecutive k of one
// column) in its own shared tiles behind its own barrier, and each thread
// accumulates RPT rows x 4 columns.  The groups' partial sums meet in a
// shared int32 tile (integer adds: exact in any order), the epilogue
// writes the scaled support, and warps normalise whole rows.

constexpr int kQRows = 32;             // batch rows per block
constexpr int kQK = 64;                // contraction slice (codes) per stage
constexpr int kQW = kQK / 4;           // 32-bit words of codes per row of a slice
constexpr int kQXS = kQW + 4;          // activation tile row stride in words
constexpr int kQGroups = 4;            // K-groups per block
constexpr int kQGroupThreads = 256;
constexpr int kQThreads = kQGroups * kQGroupThreads;

// 32-bit words of one K-group's stage: the activation tile, then the
// weight tile.
template <int TN>
__host__ __device__ constexpr int q_stage() { return kQRows * kQXS + kQW * TN; }

// Q0.7 code of a rate: round(clip(v, 0, 1) * 127), half to even.
__device__ __forceinline__ unsigned act_code(float v) {
  return (unsigned)__float2int_rn(fminf(fmaxf(v, 0.f), 1.f) * 127.f);
}

template <int TN, int L>
__global__ void __launch_bounds__(kQThreads)
quant_fwd_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ scale,
                 const int* __restrict__ table, float* __restrict__ out, int B, int Ni, int K,
                 int Nj, int Mj, int Mi, int nact, int vec, float gain) {
  constexpr int TC = TN / 4;                // threads across a chunk's columns
  constexpr int TR = kQGroupThreads / TC;   // threads across the rows
  constexpr int RPT = kQRows / TR;          // rows per thread
  constexpr int STAGE = q_stage<TN>();
  extern __shared__ __align__(16) int qsmem[];
  const int g = threadIdx.x / kQGroupThreads;
  const int gt = threadIdx.x % kQGroupThreads;
  const int tr = gt / TC;
  const int tc = gt % TC;
  int* xs = qsmem + g * STAGE;                  // [kQRows][kQXS] activation words
  int* ws = xs + kQRows * kQXS;                 // [kQW][TN] weight words
  int* red = qsmem + kQGroups * STAGE;          // [kQRows][TN] int32 sums
  float* sup = reinterpret_cast<float*>(red + kQRows * TN);  // [kQRows][Mj]
  const int row0 = blockIdx.x * kQRows;
  const int h = blockIdx.y;
  const int col0 = h * Mj;
  const int slices = (K + kQK - 1) / kQK;
  const float su = __fmul_rn(scale[h], kActScale);

  for (int c0 = 0; c0 < Mj; c0 += TN) {
    int acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int s0 = 0; s0 < slices; s0 += kQGroups) {
      const int k0 = (s0 + g) * kQK;  // past K: the group loads zeros
      // Activation codes: word (r, kw) holds k0 + 4kw .. + 3 of row r.
#pragma unroll
      for (int q = 0; q < kQRows * kQW / kQGroupThreads; ++q) {
        const int e = gt + q * kQGroupThreads;
        const int r = e / kQW, kw = e % kQW;
        const int gr = row0 + r;
        unsigned word = 0;
        if (gr < B) {
          const float* xrow = x + (size_t)gr * Ni;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int gk = k0 + 4 * kw + m;
            if (gk < K) word |= act_code(xrow[unit_of<L>(table, h, gk, Mi, nact)]) << (8 * m);
          }
        }
        xs[r * kQXS + kw] = (int)word;
      }
      // Weight codes: four k-rows of four columns each, loaded as 32-bit
      // words along the rows (or bytewise when Mj is not a multiple of 4)
      // and transposed so word (kw, c) holds k0 + 4kw .. + 3 of column c.
      for (int e = gt; e < kQW * TC; e += kQGroupThreads) {
        const int kw = e / TC, cq = e % TC;
        const int gc = c0 + 4 * cq;
        unsigned rows[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int gk = k0 + 4 * kw + m;
          rows[m] = 0;
          if (gk < K && gc < Mj) {
            const int8_t* wrow =
                L == kCompact ? w + ((size_t)h * K + gk) * Mj
                              : w + (size_t)unit_of<L>(table, h, gk, Mi, nact) * Nj + col0;
            if (vec) {
              rows[m] = *reinterpret_cast<const unsigned*>(wrow + gc);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (gc + i < Mj) rows[m] |= (unsigned)(uint8_t)wrow[gc + i] << (8 * i);
            }
          }
        }
        const unsigned t0 = __byte_perm(rows[0], rows[1], 0x5140);
        const unsigned t1 = __byte_perm(rows[2], rows[3], 0x5140);
        const unsigned t2 = __byte_perm(rows[0], rows[1], 0x7362);
        const unsigned t3 = __byte_perm(rows[2], rows[3], 0x7362);
        int4 o;
        o.x = (int)__byte_perm(t0, t1, 0x5410);
        o.y = (int)__byte_perm(t0, t1, 0x7632);
        o.z = (int)__byte_perm(t2, t3, 0x5410);
        o.w = (int)__byte_perm(t2, t3, 0x7632);
        *reinterpret_cast<int4*>(ws + kw * TN + 4 * cq) = o;
      }
      barrier_sync(g + 1, kQGroupThreads);  // the group's own barrier
#pragma unroll
      for (int kw4 = 0; kw4 < kQW; kw4 += 4) {
        int4 xa[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          xa[i] = *reinterpret_cast<const int4*>(xs + (tr * RPT + i) * kQXS + kw4);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int4 wb = *reinterpret_cast<const int4*>(ws + (kw4 + m) * TN + 4 * tc);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int a = m == 0 ? xa[i].x : m == 1 ? xa[i].y : m == 2 ? xa[i].z : xa[i].w;
            acc[i][0] = __dp4a(a, wb.x, acc[i][0]);
            acc[i][1] = __dp4a(a, wb.y, acc[i][1]);
            acc[i][2] = __dp4a(a, wb.z, acc[i][2]);
            acc[i][3] = __dp4a(a, wb.w, acc[i][3]);
          }
        }
      }
      barrier_sync(g + 1, kQGroupThreads);  // the group's own barrier
    }
    // The groups' sums meet in ``red``: group 0 stores, the others add.
    int* mine = red + (tr * RPT) * TN + 4 * tc;
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        *reinterpret_cast<int4*>(mine + i * TN) =
            make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    if (g > 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) atomicAdd(mine + i * TN + j, acc[i][j]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kQRows * TN; e += kQThreads) {
      const int r = e / TN, lc = c0 + e % TN;
      if (lc < Mj) {
        sup[r * Mj + lc] =
            __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(red[e]), su), bias[col0 + lc]), gain);
      }
    }
    __syncthreads();
  }

  softmax_rows_to(sup, kQRows, Mj, out, row0, B, Nj, col0);
}

template <int TN, int L>
cudaError_t launch_quant(const float* x, const int8_t* w, const float* bias, const float* scale,
                         const int* table, float* out, int B, int Ni, int K, int Hj, int Mj,
                         int Mi, int nact, int vec, float gain, cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * ((size_t)kQGroups * q_stage<TN>() + (size_t)kQRows * TN +
                     (size_t)kQRows * Mj);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_fwd_kernel<TN, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kQRows - 1) / kQRows, Hj);
  quant_fwd_kernel<TN, L><<<grid, kQThreads, smem, stream>>>(
      x, w, bias, scale, table, out, B, Ni, K, Hj * Mj, Mj, Mi, nact, vec, gain);
  return cudaGetLastError();
}

// Picks the column chunk (TN lanes) from the HC width.
template <int L>
cudaError_t launch_quant_any(const float* x, const int8_t* w, const float* bias,
                             const float* scale, const int* table, float* out, int B, int Ni,
                             int K, int Hj, int Mj, int Mi, int nact, float gain,
                             cudaStream_t st) {
  const int vec = Mj % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  if (Mj <= 32)
    return launch_quant<32, L>(x, w, bias, scale, table, out, B, Ni, K, Hj, Mj, Mi, nact, vec,
                               gain, st);
  if (Mj <= 64)
    return launch_quant<64, L>(x, w, bias, scale, table, out, B, Ni, K, Hj, Mj, Mi, nact, vec,
                               gain, st);
  return launch_quant<128, L>(x, w, bias, scale, table, out, B, Ni, K, Hj, Mj, Mi, nact, vec,
                              gain, st);
}

}  // namespace

extern "C" {

// x (B, Ni) fp32 rates; bias (Hj*Mj,) and scale (Hj,) fp32; out (B, Hj*Mj).
// layout 0 (dense): w (Ni, Hj*Mj) int8, table unused; the tensor-core body
// where quant_tc_takes says so, else __dp4a.  layout 1 (patchy):
// the same dense-resident codes, each post-HC reading the K = nact*Mi rows
// its (Hj, nact) int32 table names.  layout 2 (compact): w (Hj, K, Mj).
int bcpnn_quant_fwd(const float* x, const int8_t* w, const float* bias, const float* scale,
                    const int* table, float* out, int B, int Ni, int Hj, int Mj, int Mi,
                    int nact, int layout, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == kDense) {
    if (quant_tc_takes(x, w, Ni, Mj)) {
      return (int)with_quant_tile(Mj, [&](auto tile) {
        return launch_quant_tc<decltype(tile)::value>(x, w, bias, scale, out, B, Ni, Hj, Mj,
                                                      gain, st);
      });
    }
    return (int)launch_quant_any<kDense>(x, w, bias, scale, nullptr, out, B, Ni, Ni, Hj, Mj, 1,
                                         0, gain, st);
  }
  const int K = nact * Mi;
  if (layout == kPatchy)
    return (int)launch_quant_any<kPatchy>(x, w, bias, scale, table, out, B, Ni, K, Hj, Mj, Mi,
                                          nact, gain, st);
  return (int)launch_quant_any<kCompact>(x, w, bias, scale, table, out, B, Ni, K, Hj, Mj, Mi,
                                         nact, gain, st);
}

// How the dense layout takes these operands on the current device: plan =
// {1 tensor cores or 0 __dp4a, the cluster size of the tensor-core body (0
// for __dp4a)}.  Launches nothing (phase 1 of chip_smoke.py prints it).
int bcpnn_quant_fwd_plan(const float* x, const int8_t* w, int B, int Ni, int Hj, int Mj,
                         int* plan) {
  plan[0] = quant_tc_takes(x, w, Ni, Mj) ? 1 : 0;
  plan[1] = 0;
  if (!plan[0] || B <= 0 || Hj <= 0) return (int)cudaSuccess;
  return (int)with_quant_tile(Mj, [&](auto tile) {
    return quant_cluster_size<decltype(tile)::value>(B, Ni, Hj, plan + 1);
  });
}

}  // extern "C"
