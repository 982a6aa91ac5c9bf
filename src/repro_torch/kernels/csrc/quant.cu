// Hand-written Hopper (sm_90a) int8 forwards of the low-precision serving
// path: one body, quant_fwd_tc_kernel<BN, L, TM, kTma>, for the three
// Pallas TPU kernels of repro/kernels/quant.py:
//
//   bcpnn_quant_fwd, layout dense    <- quant.py::quant_fwd_pallas
//   bcpnn_quant_fwd, layout patchy   <- quant.py::quant_patchy_forward
//   bcpnn_quant_fwd, layout compact  <- quant.py::quant_compact_forward
//
// rates[b, h*Mj + n] = softmax_n(gain * (acc[b, h*Mj + n] * su[h] + bias)),
//   acc = sum_k round(clip(x[b, unit(k)], 0, 1) * 127) * w_q[k, h*Mj + n],
//   su[h] = scale[h] * fp32(1/127).
// Dense: unit(k) = k over K = Ni.  Gathered: unit(k) is the k-th live unit
// of post-HC h's row of the (Hj, nact) table, K = nact*Mi; patchy reads
// row unit(k) of the dense-resident (Ni, Hj*Mj) codes (silent synapses are
// code 0), compact row k of the HC's block of the (Hj, K, Mj) codes.
//
// The TPU kernels take pre-quantized, pre-gathered (Hj, B, K) activation
// codes and emulate the int8 product on the float unit, exact only for
// blocks of at most 1040 terms.  Here a block quantizes x as it stages it
// (round half to even, as jnp.round), and accumulates exactly in int32 for
// any K the wrapper accepts.  The epilogue is fp32 with each operation
// rounded on its own (no contraction into an FMA), as the plain PyTorch
// version computes it, then the HC's softmax (IEEE expf, and the division
// through quotient()).
//
// Bound: bytes.  At Model 1 (B=128, Ni=1568, Nj=4096) the dense forward
// reads 6.4 MB of codes and 0.8 MB of fp32 x and writes 2.1 MB of rates,
// ~2.8 us at 3.35 TB/s; its 1.64 G int8 operations take ~0.8 us at the
// tensor cores' 1979 TOP/s.  Gathered at Model 1-struct (nact 128, K = 256):
// 1.0 MB of live codes, x and the rates, ~1.2 us; the contraction is 8
// slices deep, so a launch's fixed costs (the first slice's copies, the
// exchange of partial sums, the epilogue) weigh as much as the slices.
//
// C interface as in bcpnn.cu: device pointers, sizes and the stream; the
// launch's cudaGetLastError() is returned.

#include <cooperative_groups.h>

#include <algorithm>
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

// quant_fwd_tc_kernel<BN, L, TM, kTma>: every layout and shape on the s8
// tensor cores.  What bounds it and what the design does about it:
//
//  * Grid: one thread-block cluster per (batch tile of TM rows, post-HC),
//    of KS blocks that split the contraction between them in 32-deep
//    slices (contiguous runs of slices a rank).  The plan (TM, KS) is the
//    cheapest by a cost model (quant_plans): waves of co-resident clusters
//    (cudaOccupancyMaxActiveClusters) times a rank's slices times a
//    slice's work.  A short contraction prefers short tiles to a wide
//    cluster: at Model 1-struct (8 slices, B = 128) tiles of 64 rows in
//    clusters of 2 fill the card with 4 slices a rank and exchange half a
//    tile, where tiles of 128 rows need a cluster of 3 and an exchange
//    that costs more than the slices it saves; at Model 1 (49 slices)
//    tiles of 128 rows in clusters of 3.  A cluster of one is launched
//    without the attribute.  After its slices a rank parks its int32
//    partial sums in shared memory and pushes each other rank its KS-th of
//    the tile's rows, one bulk copy through distributed shared memory
//    each; each rank then sums its rows over the cluster's partials
//    (integer adds, exact in any order, so the rates do not depend on the
//    plan), adds the dequant, bias and gain and takes the HC's softmax in
//    registers, a warp a row.
//  * Products: wgmma m64nNk32 s8 x s8 -> s32, both operands read by the
//    tensor cores from K-major code tiles in shared memory (8 rows x 16
//    bytes a core matrix, no swizzle), two warpgroups: each its 64 rows of
//    a 128-row tile, or its half of the columns of a 64-row one.  wgmma
//    and not mma.sync m16n8k32: the tensor cores read B once a warpgroup
//    from shared memory, where eight mma.sync warps would each load all of
//    it into registers; the product is a small part of a slice's time
//    either way.  8-bit wgmma operands must be K-major in shared memory;
//    the packs keep row-major codes, so w is transposed at staging.
//  * Copies: raw slices (x [TM][32] fp32, w [32][BN] codes) land in a
//    ring of eight stages, so the copies run eight slices ahead (with four
//    or five, their latency set the pace).  Dense x and w whose rows are
//    16-byte aligned and sized come by TMA tensor copies, one tensor-core
//    thread issuing two a slice (zero filled past B, K and Nj), and the
//    kernel is compiled for that case alone (kTma), so the other copy
//    paths cost its slices nothing; compact w
//    by one 3-D TMA box (BN x 32 x 1) a slice, zero filled past K.  TMA
//    cannot gather, so the other operands come by cp.async: x's gathered
//    columns (runs of Mi floats, one a live pre-HC) in pieces of 16, 8 or
//    4 bytes (Mi a multiple of 4, of 2 as at Model 1-struct, or odd),
//    patchy w's gathered rows in 16-byte pieces, and any operand whose rows
//    are not 16-byte aligned in 4-byte pieces or, for codes, plain loads.
//    Each staging warp copies exactly the bytes it lays out later,
//    kTqAhead slices ahead, and waits for its own copies alone (a cp.async
//    group a slice, then a __syncwarp),
//    so no barrier joins the staging warps: a barrier of theirs a slice
//    doubled a slice's time, and the same copies issued by the
//    tensor-core threads spilled their accumulators and set the pace.
//    The x pieces are the gathered layouts' price: at Model 1-struct a
//    64-row slice is 1024 scattered 8-byte pieces, each its own L1 request
//    (lanes on consecutive live units of a row, so that a request covers
//    neighbours where they share a line).
//    A block reads its table row once, at the start, into a shared vector
//    holding the unit of each of its contraction indices; the slice count
//    comes from K, not Ni.
//  * Staging: eight staging warps lay each slice out in one of four code
//    buffers: each x float4 becomes four Q0.7 codes (saturate, x127, and
//    +1.5*2^23, which rounds to the nearest integer, ties to even, as
//    __float2int_rn, at a quarter of its cost); each 4 x 4 block of w codes
//    is transposed with __byte_perm, columns past the HC (which a TMA box
//    reads from the next HC when Mj < BN) set to code 0.  mbarriers pass
//    the code buffers between the roles (full: an arrival a staging warp;
//    empty: one a tensor-core warp), so each staging warp runs at its own
//    pace.
//  * Wide HCs (Mj > 128): the slices run once a column chunk of 128, the
//    chunk's supports go to the rank's rows of ``out``, and the rank takes
//    their softmax once every chunk is in (a tile's supports of a 256-wide
//    HC, 128 KB, do not fit in shared memory beside the ring).
//  * Epilogue: the HC softmax, IEEE expf, and the quotient by the
//    reciprocal of the row's sum with one exact correction (quotient()):
//    the division's result down to 2^-118, without its slow path.  Columns
//    past the HC are masked one by one, with selects (they enter the max
//    as -inf and leave exp as 0), so any Mj works and the expf calls stay
//    one straight run (masks by branch broke it up and slowed the
//    epilogue).
//  * The x traffic: every post-HC's cluster reads all of its x columns in
//    fp32 (32 x 0.8 MB through L2 at Model 1) and quantizes them again;
//    the codes are made once a tile, by the rank whose slice it is.

constexpr int kTqK = 32;           // contraction slice: one wgmma k32 step
constexpr int kTqStages = 8;       // raw stages: the copies' latency over their pace
constexpr int kTqAhead = 3;        // slices a staging thread's own copies run ahead
constexpr int kTqCodes = 4;        // code buffers between the two roles
constexpr int kTqMma = 256;        // two warpgroups of tensor-core warps (first)
constexpr int kTqStage = 256;      // eight staging warps
constexpr int kTqThreads = kTqMma + kTqStage;
constexpr int kTqMaxCluster = 8;
constexpr int kTqMinSlices = 2;    // slices a rank at least (where the contraction allows)
// The plan's cost model, in rows of TMA-copied x a slice: a slice's fixed
// work (the w transpose, the barriers) counts kTqSliceRows rows, and a row
// of x in gathered pieces kTqPieceRow rows (fitted to the times of every
// plan at Model 1 and Model 1-struct, chip_smoke.py phase 1).
constexpr int kTqSliceRows = 128, kTqPieceRow = 2;

// Rows of the other ranks' partials a rank receives at most, over the
// cluster sizes, for a tile of tm rows: (ks - 1) * ceil(tm / ks).
constexpr int recv_rows(int tm) {
  int most = 0;
  for (int k = 2; k <= kTqMaxCluster; ++k) {
    const int r = (k - 1) * ((tm + k - 1) / k);
    most = r > most ? r : most;
  }
  return most;
}

// One block's tile, TM rows (64 or 128) by BN columns, and its
// shared-memory map in bytes: the raw ring, then the code buffers (x codes
// [TM rows], then w codes [BN columns], each as K-major core matrices); the
// int32 partial sums alias the ring after the slices; then the mbarriers,
// then (gathered) the units of the rank's contraction indices.  A
// warpgroup's wgmma takes 64 rows by WN columns: its own 64 rows of a
// 128-row tile, or its half of the columns of a 64-row one.
template <int BN, int TM>
struct QTile {
  static_assert(TM == 64 || TM == 128, "tiles of 64 or 128 rows");
  static constexpr int WN = TM == 128 ? BN : BN / 2;
  static constexpr int kRawX = TM * kTqK * 4;       // raw x [TM][32] fp32
  static constexpr int kStage = kRawX + kTqK * BN;  // then raw w [32][BN]
  static constexpr int kA = TM * kTqK;
  static constexpr int kCode = kA + BN * kTqK;
  static constexpr int kRing = kTqStages * kStage;
  static constexpr int kPipe = kRing + kTqCodes * kCode;
  static constexpr int kLdP = BN + 8;  // partial rows: conflict-free int2 stores
  // after the slices: this rank's partials for all TM rows, then those of
  // its rows received from the other ranks
  static constexpr int kPart = (TM + recv_rows(TM)) * kLdP * 4;
  // mbarriers: one a raw stage, the partials received from the ranks, and
  // each code buffer's full and empty
  static constexpr int kBars = (kPipe > kPart ? kPipe : kPart + 127) / 128 * 128;
  static constexpr int kRecvBar = kTqStages, kFullBar = kRecvBar + 1;
  static constexpr int kEmptyBar = kFullBar + kTqCodes;
  static constexpr int kKu = (kBars + 8 * (kEmptyBar + kTqCodes) + 15) / 16 * 16;
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
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
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

// kTma: every operand by TMA (dense, with 16-byte aligned rows and HC
// columns), known at compile time so that the copy paths of the other
// shapes cost its slices nothing.
template <int BN, int L, int TM, bool kTma>
__global__ void __launch_bounds__(kTqThreads, 1)
quant_fwd_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw, const float* __restrict__ x,
                    const int8_t* __restrict__ w, const float* __restrict__ bias,
                    const float* __restrict__ scale, const int* __restrict__ table,
                    float* __restrict__ out, int B, int Ni, int K, int Nj, int Mj, int Mi,
                    int nact, int ks, int xcopy, int wcopy, float gain) {
  using Q = QTile<BN, TM>;
  constexpr int WN = Q::WN, NA = WN / 2;  // a warpgroup's columns, a thread's accumulators
  extern __shared__ __align__(1024) unsigned char qsm[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * TM;
  const int h = blockIdx.z, col0 = h * Mj;
  // this rank's slices of the contraction
  const int total = (K + kTqK - 1) / kTqK;
  const int s0 = rank * total / ks, slices = (rank + 1) * total / ks - s0;
  const int kbeg = s0 * kTqK;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  auto raw_x = [&](int u) { return reinterpret_cast<float*>(qsm + (u % kTqStages) * Q::kStage); };
  auto raw_w = [&](int u) { return qsm + (u % kTqStages) * Q::kStage + Q::kRawX; };
  auto codes = [&](int u) { return qsm + Q::kRing + (u % kTqCodes) * Q::kCode; };
  int* ku = reinterpret_cast<int*>(qsm + Q::kKu);  // gathered: unit of index kbeg + i
  const bool one_chunk = Mj <= BN;

  uint64_t* bars = reinterpret_cast<uint64_t*>(qsm + Q::kBars);
  uint64_t* full = bars + Q::kFullBar;    // a code buffer is laid out: a staging warp's arrival
  uint64_t* empty = bars + Q::kEmptyBar;  // its products are done: a tensor-core warp's
  uint64_t* recv_bar = bars + Q::kRecvBar;
  // TMA copies complete on the raw stage's mbarrier; every other piece is
  // copied (cp.async, or plain loads of codes) by the staging thread that
  // lays it out, which waits for its own copies alone.
  if constexpr (kTma) xcopy = wcopy = kCopyTma;
  const uint32_t tma_bytes = (xcopy == kCopyTma ? Q::kRawX : 0) + (wcopy == kCopyTma ? kTqK * BN : 0);
  const bool pieces = !kTma && (xcopy != kCopyTma || wcopy != kCopyTma);
  if (tid == 0) {
    for (int q = 0; q <= kTqStages; ++q) mbar_init(bars + q);  // the stages', then recv_bar
    for (int b = 0; b < kTqCodes; ++b) {
      mbar_init(full + b, kTqStage / kWarp);
      mbar_init(empty + b, kTqMma / kWarp);
    }
    if (xcopy == kCopyTma) asm volatile("prefetch.tensormap [%0];" ::"l"(&tmx) : "memory");
    if (wcopy == kCopyTma) asm volatile("prefetch.tensormap [%0];" ::"l"(&tmw) : "memory");
  }
  if constexpr (L != kDense) {  // the table row, read once
    const int n = min(K, (s0 + slices) * kTqK) - kbeg;
    for (int i = tid; i < n; i += kTqThreads) ku[i] = unit_of<L>(table, h, kbeg + i, Mi, nact);
  }
  const float su = __fmul_rn(scale[h], kActScale);  // the epilogue's dequant
  __syncthreads();

  // The TMA copies of slice s of the chunk at c0 into raw stage u, issued
  // by the first tensor-core thread: dense x's (32 x 128) box, dense w's
  // (BN x 32) or compact w's (BN x 32 x 1).
  auto fetch = [&](int c0, int s, int u) {
    const int k0 = (s0 + s) * kTqK;
    uint64_t* bar = bars + u % kTqStages;
    mbar_expect(bar, tma_bytes);
    if (xcopy == kCopyTma) tma_2d(raw_x(u), &tmx, k0, row0, bar);
    if (wcopy == kCopyTma) {
      if constexpr (L == kCompact) {
        tma_3d(raw_w(u), &tmw, c0, k0, h, bar);
      } else {
        tma_2d(raw_w(u), &tmw, col0 + c0, k0, bar);
      }
    }
  };

  // A staging thread's share of a slice: x, rows (p >> 3) of the tile at
  // four columns 4 (p & 7).. for p = st + i * kTqStage (whole rows a warp);
  // w (the threads of the transpose), rows 4 q + m, columns 4 wc.. of the
  // chunk.
  const int st = tid - kTqMma;  // a staging thread's index
  constexpr int kX = TM * kTqK / 4 / kTqStage;  // x float4s a thread
  constexpr int kCq = BN / 4;                          // w column quads
  static_assert(8 * kCq <= kTqStage, "one w block a thread at most");
  const bool wt = st >= 0 && st < 8 * kCq;
  const int wc = (st >> 1) % kCq, q = (((st >> 1) / kCq) << 1) | (st & 1);
  // The copies of this warp's share of slice s of the chunk at c0 into raw
  // stage u that TMA does not make: x in pieces of 16, 8 or 4 bytes (a
  // piece lies in one pre-HC's run of Mi units, read at the unit of its
  // first k), w in 16-byte pieces or (each thread its own) 4-byte words
  // or, where rows are not 4-byte aligned and sized, code by code with
  // plain loads; zeros past B, K and the HC.
  auto issue = [&](int c0, int s, int u) {
    const int k0 = (s0 + s) * kTqK;
    auto unit = [&](int k) { return L == kDense ? k : ku[k - kbeg]; };
    if (xcopy != kCopyTma) {
      // the warp's rows, 4 sw + 32 i .. + 3 (its lay-out threads'), in
      // pieces of P floats: lanes on consecutive pieces of one or two rows,
      // so that a request covers the nearest live units
      auto pieces_of = [&](auto per) {
        constexpr int P = decltype(per)::value, kRow = kTqK / P;  // pieces a row
        const int sw = st / kWarp;
#pragma unroll
        for (int i = 0; i < kX; ++i) {
#pragma unroll
          for (int m = 0; m < 4 * kRow / kWarp; ++m) {
            const int e = lane + kWarp * m;
            const int r = 4 * sw + 32 * i + e / kRow, c = (e % kRow) * P, k = k0 + c;
            const bool v = row0 + r < B && k < K;
            const float* src = x;
            if (v) src = x + (size_t)(row0 + r) * Ni + unit(k);
            float* d = raw_x(u) + r * kTqK + c;
            if constexpr (P == 4) {
              cp_async16(d, src, v);
            } else if constexpr (P == 2) {
              cp_async8(d, src, v);
            } else {
              cp_async4(d, src, v);
            }
          }
        }
      };
      if (xcopy == kCopy16) {
        pieces_of(std::integral_constant<int, 4>{});
      } else if (xcopy == kCopy8) {
        pieces_of(std::integral_constant<int, 2>{});
      } else {
        pieces_of(std::integral_constant<int, 1>{});
      }
    }
    if (L == kPatchy && wcopy == kCopy16) {
      // gathered rows in 16-byte pieces, a lane each, of the rows and
      // columns its warp's transposers read: kRowsW rows of kColsW columns
      constexpr int kColsW = BN < 64 ? BN : 64, kRowsW = 512 / kColsW, kBands = BN / kColsW;
      const int sw = st / kWarp;
      if (sw < kTqK / kRowsW * kBands) {
        const int kk = kRowsW * (sw / kBands) + lane / (kColsW / 16), k = k0 + kk;
        const int col = kColsW * (sw % kBands) + 16 * (lane % (kColsW / 16));
        const bool v = k < K && c0 + col < Mj;
        const int8_t* src = v ? w + (size_t)ku[k - kbeg] * Nj + col0 + c0 + col : w;
        cp_async16(raw_w(u) + kk * BN + col, src, v);
      }
    } else if (wcopy != kCopyTma && wt) {
      unsigned char* rw = raw_w(u);
      const int col = c0 + 4 * wc;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = 4 * q + m, k = k0 + kk;
        const bool kv = k < K;
        const int8_t* row = w;
        if (kv) {
          if constexpr (L == kDense) {
            row = w + (size_t)k * Nj + col0;
          } else if constexpr (L == kPatchy) {
            row = w + (size_t)ku[k - kbeg] * Nj + col0;
          } else {
            row = w + ((size_t)h * K + k) * Mj;
          }
        }
        uint32_t* d = reinterpret_cast<uint32_t*>(rw + kk * BN + 4 * wc);
        if (wcopy == kCopy4) {
          const bool v = kv && col < Mj;
          cp_async4(d, v ? row + col : w, v);
        } else {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (kv && col + j < Mj) word |= (uint32_t)(uint8_t)__ldg(row + col + j) << (8 * j);
          }
          *d = word;
        }
      }
    }
  };

  // The staging warps lay slice u's raw stage out in its code buffer: all
  // of a thread's shared loads first, then the codes and their stores (the
  // compiler cannot move a load above a store that may alias it).
  auto lay_out = [&](int u, int c0) {
    const float* rx = raw_x(u);
    const unsigned char* rw = raw_w(u);
    unsigned char* cb = codes(u);
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
      // columns past the HC: code 0 (a TMA box reads the next HC's)
      const int left = Mj - c0 - 4 * wc;
      if (left < 4) {
        const uint32_t keep = left <= 0 ? 0u : 0xFFFFFFFFu >> (8 * (4 - left));
#pragma unroll
        for (int m = 0; m < 4; ++m) in[m] &= keep;
      }
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

  // The rows [r0, r0 + nrows) of the tile are this rank's to finish.
  const int r0 = rank * TM / ks, nrows = (rank + 1) * TM / ks - r0;
  const int maxrows = (TM + ks - 1) / ks;
  int* part = reinterpret_cast<int*>(qsm);
  int* recv = part + TM * Q::kLdP;
  // tensor-core warpgroup wg: rows 64 wg .. 64 wg + 63 of a 128-row tile, or
  // columns WN wg .. WN wg + WN - 1 of a 64-row one
  const int wg = warp / 4;
  const int c = 4 * lane;   // a lane's first column of the chunk in the epilogue

  int done = 0;  // slices staged before this chunk (ring stages, mbarrier phases)
  for (int c0 = 0, chunk = 0; c0 < Mj; c0 += BN, ++chunk, done += slices) {
    if (tid == 0 && tma_bytes > 0) {
      for (int s = 0; s < kTqStages && s < slices; ++s) fetch(c0, s, done + s);
    }
    // the epilogue's operands, read while the slices stream
    const int cols = min(BN, Mj - c0);
    bool lc[4];
    float b4[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lc[e] = c + e < cols;
      b4[e] = lc[e] ? __ldg(bias + col0 + c0 + c + e) : 0.f;
    }
    int acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0;
    if (warp < kTqMma / kWarp) {
      // ---- tensor-core warpgroups: wgmma on code buffer u % kTqCodes --------
#pragma unroll 1
      for (int s = 0; s < slices; ++s) {
        const int u = done + s;
        mbar_wait(full + u % kTqCodes, (u / kTqCodes) & 1);
        // slice s is laid out: its raw stage takes slice s + kTqStages
        if (tid == 0 && tma_bytes > 0 && s + kTqStages < slices) {
          fetch(c0, s + kTqStages, u + kTqStages);
        }
        const unsigned char* cb = codes(u);
        wgmma_fence();
        fence_acc<NA>(acc);
        wgmma_s8<WN>(acc, wgmma_desc(cb + (TM == 128 ? wg * 64 * kTqK : 0)),
                     wgmma_desc(cb + Q::kA + (TM == 128 ? 0 : wg * (WN / 8) * 256)), 1);
        wgmma_commit();
        fence_acc<NA>(acc);
        wgmma_wait<1>();  // slice s - 1's product is done: its buffer is free
        fence_acc<NA>(acc);
        if (s > 0 && lane == 0) mbar_arrive(empty + (u - 1) % kTqCodes);
      }
      wgmma_wait<0>();
      fence_acc<NA>(acc);
      if (slices > 0 && lane == 0) mbar_arrive(empty + (done + slices - 1) % kTqCodes);
    } else {
      // ---- staging warps: copy, quantize, transpose, lay out K-major -------
      // (each warp at its own pace: a slice's raw stage is refilled by TMA
      // once the tensor-core warps have seen it laid out by all of them, and
      // by a warp's own copies kTqAhead slices ahead, so that laying slice s
      // out overlaps the requests of the next: issued eight ahead, the
      // requests of a short contraction's every slice came before its first
      // was laid out).  One cp.async group a slice, committed empty past the
      // last.
      if (pieces) {
        for (int s = 0; s < kTqAhead; ++s) {
          if (s < slices) issue(c0, s, done + s);
          cp_async_commit();
        }
      }
#pragma unroll 1
      for (int s = 0; s < slices; ++s) {
        const int u = done + s;
        if (pieces) {
          cp_async_wait<kTqAhead - 1>();  // this thread's copies of slice s
          __syncwarp();                   // and its warp's
        }
        if (tma_bytes > 0) mbar_wait(bars + u % kTqStages, (u / kTqStages) & 1);
        // the products of slice u - kTqCodes, the buffer's last, are done
        if (u >= kTqCodes) mbar_wait(empty + u % kTqCodes, (u / kTqCodes - 1) & 1);
        lay_out(u, c0);
        if (pieces) {
          if (s + kTqAhead < slices) issue(c0, s + kTqAhead, u + kTqAhead);
          cp_async_commit();
        }
        // the tensor cores read the codes, and TMA refills the raw stage
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + u % kTqCodes);
      }
      if (pieces) cp_async_wait<0>();  // (groups past the last slice are empty)
    }
    __syncthreads();  // the ring is free: it takes the partial sums

    // Each rank parks its partials for all rows (part), then pushes each
    // other rank's rows to it by one bulk copy through distributed shared
    // memory (slot of the sender in the receiver's recv), completing on the
    // receiver's mbarrier; reads of remote partials by the threads, a round
    // trip each, took most of the epilogue.
    if (warp < kTqMma / kWarp) {
      // acc[4 n8 + 2 e + j] is row 16 (warp % 4) + g + 8 e, column 8 n8 + 2 t
      // + j of the warpgroup's 64 x WN product
      const int g = lane / 4, t = lane % 4;
      const int rb = (TM == 128 ? wg * 64 : 0) + (warp % 4) * 16 + g;
      const int cw = TM == 128 ? 0 : wg * WN;
#pragma unroll
      for (int n8 = 0; n8 < WN / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          *reinterpret_cast<int2*>(part + (rb + 8 * e) * Q::kLdP + cw + n8 * 8 + 2 * t) =
              make_int2(acc[4 * n8 + 2 * e], acc[4 * n8 + 2 * e + 1]);
        }
      fence_proxy_async();  // the bulk copies read the partials
    }
    if (ks > 1) {
      if (tid == 0) mbar_expect(recv_bar, (uint32_t)((ks - 1) * nrows * Q::kLdP * 4));
      cluster.sync();  // every rank's partials are parked and its buffers dead
      if (tid < ks && tid != rank) {
        const int q0 = tid * TM / ks, qn = (tid + 1) * TM / ks - q0;
        push_rows(recv + (rank < tid ? rank : rank - 1) * maxrows * Q::kLdP,
                  part + q0 * Q::kLdP, (uint32_t)(qn * Q::kLdP * 4), recv_bar, tid);
      }
      mbar_wait(recv_bar, chunk & 1);
      // this rank's copies in are done; it refills its ring or leaves only
      // after every rank's (the barrier orders no data)
      asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    } else {
      __syncthreads();
    }

    // ---- the cluster's sum, dequant, bias and gain, a warp a row, four
    // columns a lane, three rows a warp at a time (one round at a cluster of
    // 3); then, for an HC of one chunk, the softmax in registers, else the
    // supports to the rank's rows of out.
    constexpr int kRowWarps = kTqThreads / kWarp, kRows = 3;
    const bool vec = lc[3] && ((Nj | Mj) & 3) == 0;  // a float4 store of whole columns
    const int rounds = (nrows + kRows * kRowWarps - 1) / (kRows * kRowWarps);
    for (int round = 0; round < rounds; ++round) {
      int lr[kRows];
      bool live[kRows];  // warp-uniform
      int a[kRows][4] = {};
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        lr[j] = r0 + (round * kRows + j) * kRowWarps + warp;
        live[j] = lr[j] < r0 + nrows && row0 + lr[j] < B;
      }
      if (!live[0]) break;  // this warp's later rows are past the rank's or B
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!live[j] || !lc[0]) continue;
#pragma unroll
        for (int q = 0; q < kTqMaxCluster; ++q) {
          if (q >= ks) break;
          const int4 p = *reinterpret_cast<const int4*>(
              q == 0 ? part + lr[j] * Q::kLdP + c
                     : recv + ((q - 1) * maxrows + lr[j] - r0) * Q::kLdP + c);
          a[j][0] += p.x; a[j][1] += p.y; a[j][2] += p.z; a[j][3] += p.w;
        }
      }
      // (columns past the HC: -inf into the max, 0 out of exp, by selects)
      float v[kRows][4], mx[kRows], sum[kRows], inv[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        mx[j] = -INFINITY;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = __fmul_rn(__fadd_rn(__fmul_rn(__int2float_rn(a[j][e]), su), b4[e]), gain);
          mx[j] = fmaxf(mx[j], lc[e] ? v[j][e] : -INFINITY);
        }
      }
      if (one_chunk) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) mx[j] = group_max<kWarp>(mx[j]);
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          sum[j] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[j][e] = expf(lc[e] ? v[j][e] - mx[j] : -INFINITY);
            sum[j] += v[j][e];
          }
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          sum[j] = group_sum<kWarp>(sum[j]);
          inv[j] = __frcp_rn(sum[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[j][e] = quotient(v[j][e], sum[j], inv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (!live[j] || !lc[0]) continue;
        float* orow = out + (size_t)(row0 + lr[j]) * Nj + col0 + c0 + c;
        if (vec) {
          *reinterpret_cast<float4*>(orow) = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (lc[e]) orow[e] = v[j][e];
          }
        }
      }
    }
    if (!one_chunk) {
      // the ring takes the next chunk's copies (the async proxy) once every
      // thread's reads of the partials are done
      fence_proxy_async();
      __syncthreads();
    }
    if (ks > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
  if (one_chunk) return;

  // ---- several chunks: the softmax of the rank's rows, a warp a row, over
  // the supports the chunks left in out
  for (int lr = r0 + warp; lr < r0 + nrows; lr += kTqThreads / kWarp) {
    if (row0 + lr >= B) break;  // warp-uniform; rows only grow
    float* orow = out + (size_t)(row0 + lr) * Nj + col0;
    float mx = -INFINITY;
    for (int n = lane; n < Mj; n += kWarp) mx = fmaxf(mx, orow[n]);
    mx = group_max<kWarp>(mx);
    float sum = 0.f;
    for (int n = lane; n < Mj; n += kWarp) {
      const float e = expf(orow[n] - mx);
      orow[n] = e;
      sum += e;
    }
    sum = group_sum<kWarp>(sum);
    const float inv = __frcp_rn(sum);
    for (int n = lane; n < Mj; n += kWarp) orow[n] = quotient(orow[n], sum, inv);
  }
}

// The operands' geometry: x (B, Ni); w (Ni, Hj*Mj), or compact (Hj, K, Mj);
// table (Hj, nact) of the gathered layouts; K = Ni dense, nact*Mi gathered.
struct QShape {
  int B, Ni, K, Hj, Mj, Mi, nact;
};

// Shared bytes of a block at cluster size ks (the rank's units, gathered).
template <int BN, int L, int TM>
size_t quant_smem(int ks, int total) {
  const int ku = L == kDense ? 0 : (total + ks - 1) / ks * kTqK;
  return (size_t)QTile<BN, TM>::kKu + sizeof(int) * (size_t)ku;
}

// A launch's tile height (64 or 128 rows) and cluster size.
struct QPlan {
  int tm, ks;
};

// The plans the kernel of TM-row tiles (kTma: every copy by TMA) can take,
// into ``best``: ``forced`` where it is positive, else every cluster size
// that leaves each rank kTqMinSlices slices (or the smallest that fits, for
// a shorter contraction), each costed as its waves (ceil(clusters /
// co-resident clusters)) times a rank's slices, ceil(total / ks), times a
// slice's work, kTqSliceRows + TM rows of x (kTqPieceRow each when x comes
// in pieces).  The co-resident counts are kept per (device, cluster
// size, shared bytes), under a lock.  Also sets the kernel's shared-memory
// limit.
template <int BN, int L, int TM, bool kTma>
cudaError_t quant_plans(int B, int K, int Hj, int forced, bool xpieces, QPlan* best,
                        double* best_cost) {
  const int total = (K + kTqK - 1) / kTqK;
  int ks_min = 1;
  while (ks_min < kTqMaxCluster && quant_smem<BN, L, TM>(ks_min, total) > (size_t)kMaxSmem) {
    ++ks_min;
  }
  if (quant_smem<BN, L, TM>(ks_min, total) > (size_t)kMaxSmem) {
    // the rank's units do not fit beside this ring: no plan of TM rows
    return forced > 0 ? cudaErrorInvalidValue : cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(quant_fwd_tc_kernel<BN, L, TM, kTma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)quant_smem<BN, L, TM>(ks_min, total));
  if (err != cudaSuccess) return err;
  if (forced > 0 && (forced < ks_min || forced > kTqMaxCluster)) return cudaErrorInvalidValue;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int lo = forced > 0 ? forced : ks_min;
  const int hi = forced > 0 ? forced
                            : std::max(ks_min, std::min(kTqMaxCluster, total / kTqMinSlices));
  const long long clusters = (long long)((B + TM - 1) / TM) * Hj;
  static std::mutex lock;
  static std::map<std::tuple<int, int, size_t>, int> seen;  // -> co-resident clusters
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kTqThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int k = lo; k <= hi; ++k) {
    const auto key = std::make_tuple(device, k, quant_smem<BN, L, TM>(k, total));
    int n = 0;
    {
      const std::lock_guard<std::mutex> hold(lock);
      const auto it = seen.find(key);
      if (it != seen.end()) {
        n = it->second;
      } else {
        cfg.gridDim = dim3(k, 1, 1);
        cfg.dynamicSmemBytes = std::get<2>(key);
        attr[0].val.clusterDim.x = k;
        err = cudaOccupancyMaxActiveClusters(&n, (void*)quant_fwd_tc_kernel<BN, L, TM, kTma>, &cfg);
        if (err != cudaSuccess) return err;
        seen[key] = n;
      }
    }
    if (n <= 0) continue;
    const double slice = kTqSliceRows + (double)TM * (xpieces ? kTqPieceRow : 1);
    const double cost = (double)((clusters + n - 1) / n) * ((total + k - 1) / k) * slice;
    if (*best_cost < 0.0 || cost < *best_cost) {
      *best_cost = cost;
      *best = {TM, k};
    }
  }
  return cudaSuccess;
}

// The plan of a launch: ``rows`` (64 or 128) and ``cluster`` where they are
// positive, else the cheapest of quant_plans' over both tile heights (the
// taller on a tie).
template <int BN, int L, bool kTma>
cudaError_t quant_plan(int B, int K, int Hj, int rows, int cluster, bool xpieces, QPlan* plan) {
  if (rows != 0 && rows != 64 && rows != 128) return cudaErrorInvalidValue;
  double cost = -1.0;
  cudaError_t err = cudaSuccess;
  if (rows != 64) err = quant_plans<BN, L, 128, kTma>(B, K, Hj, cluster, xpieces, plan, &cost);
  if (err == cudaSuccess && rows != 128) {
    err = quant_plans<BN, L, 64, kTma>(B, K, Hj, cluster, xpieces, plan, &cost);
  }
  if (err != cudaSuccess) return err;
  return cost < 0.0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// How each operand's raw slices move (StageCopy), from the layout, the
// shape and the pointers alone.  x: dense, TMA where its rows are 16-byte
// aligned and sized, else 4-byte pieces; gathered, pieces of the widest of
// 16, 8 or 4 bytes that divides a pre-HC's run and the alignment allows.
// w: where the rows of codes and the HC's first column are 16-byte
// aligned, dense and compact by TMA and patchy (a gather) in 16-byte
// pieces; otherwise 4-byte words where the rows and the HC's columns are
// 4-byte aligned, else plain loads.
inline bool quant_copies(int L, const float* x, const int8_t* w, const QShape& sh, int* xcopy,
                         int* wcopy) {
  const uintptr_t xa = (uintptr_t)x, wa = (uintptr_t)w;
  if (L == kDense) {
    *xcopy = sh.Ni % 4 == 0 && xa % 16 == 0 ? kCopyTma : kCopy4;
  } else if (sh.Mi % 4 == 0 && xa % 16 == 0) {
    *xcopy = kCopy16;
  } else {
    *xcopy = sh.Mi % 2 == 0 && xa % 8 == 0 ? kCopy8 : kCopy4;
  }
  // bytes a row; a TMA box's first column (h * Mj dense) must sit on a
  // 16-byte boundary, or the copy faults
  const long long row = L == kCompact ? sh.Mj : (long long)sh.Hj * sh.Mj;
  if (row % 16 == 0 && sh.Mj % 16 == 0 && wa % 16 == 0) {
    *wcopy = L == kPatchy ? kCopy16 : kCopyTma;
  } else if (row % 4 == 0 && sh.Mj % 4 == 0 && wa % 4 == 0) {
    *wcopy = kCopy4;
  } else {
    *wcopy = kCopyElem;
  }
  return *xcopy == kCopyTma && *wcopy == kCopyTma;
}

template <int BN, int L, int TM, bool kTma>
cudaError_t launch_quant_tc(const float* x, const int8_t* w, const float* bias,
                            const float* scale, const int* table, float* out, const QShape& sh,
                            int xcopy, int wcopy, int ks, float gain, cudaStream_t stream) {
  const long long Nj = (long long)sh.Hj * sh.Mj;
  CUtensorMap tmx = {}, tmw = {};
  bool ok = true;
  if (xcopy == kCopyTma) {
    const long long dims[2] = {sh.Ni, sh.B};
    const int box[2] = {kTqK, TM};
    ok = tensor_map(&tmx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, dims, box);
  }
  if (ok && wcopy == kCopyTma) {
    if (L == kCompact) {
      const long long dims[3] = {sh.Mj, sh.K, sh.Hj};
      const int box[3] = {BN, kTqK, 1};
      ok = tensor_map(&tmw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 3, dims, box);
    } else {
      const long long dims[2] = {Nj, sh.Ni};
      const int box[2] = {BN, kTqK};
      ok = tensor_map(&tmw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, dims, box);
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (sh.B + TM - 1) / TM, sh.Hj);
  cfg.blockDim = dim3(kTqThreads);
  cfg.dynamicSmemBytes = quant_smem<BN, L, TM>(ks, (sh.K + kTqK - 1) / kTqK);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;  // a grid without clusters has clusters of one block
  cudaError_t err = cudaLaunchKernelEx(&cfg, quant_fwd_tc_kernel<BN, L, TM, kTma>, tmx, tmw, x, w, bias,
                                       scale, table, out, sh.B, sh.Ni, sh.K, (int)Nj, sh.Mj,
                                       sh.Mi, sh.nact, ks, xcopy, wcopy, gain);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// fn(tile, layout, all-TMA) with the column tile for the HC width (a chunk
// of 128 columns past 128), the layout and whether every copy is by TMA
// (dense only) as compile-time constants.
template <class Fn>
cudaError_t with_quant_kernel(int layout, int Mj, bool tma, Fn&& fn) {
  auto tiled = [&](auto l, auto t) {
    if (Mj <= 16) return fn(std::integral_constant<int, 16>{}, l, t);
    if (Mj <= 32) return fn(std::integral_constant<int, 32>{}, l, t);
    if (Mj <= 64) return fn(std::integral_constant<int, 64>{}, l, t);
    return fn(std::integral_constant<int, 128>{}, l, t);
  };
  const std::false_type pieces;
  if (layout == kPatchy) return tiled(std::integral_constant<int, kPatchy>{}, pieces);
  if (layout == kCompact) return tiled(std::integral_constant<int, kCompact>{}, pieces);
  if (tma) return tiled(std::integral_constant<int, kDense>{}, std::true_type{});
  return tiled(std::integral_constant<int, kDense>{}, pieces);
}

}  // namespace

extern "C" {

// x (B, Ni) fp32 rates; bias (Hj*Mj,) and scale (Hj,) fp32; out (B, Hj*Mj).
// layout 0 (dense): w (Ni, Hj*Mj) int8, table unused.  layout 1 (patchy):
// the same dense-resident codes, each post-HC reading the K = nact*Mi rows
// its (Hj, nact) int32 table names.  layout 2 (compact): w (Hj, K, Mj).
// rows: the tile height (64 or 128), cluster: the thread-block cluster
// size (1..8); 0 for either takes the launcher's plan
// (bcpnn_quant_fwd_plan).
int bcpnn_quant_fwd(const float* x, const int8_t* w, const float* bias, const float* scale,
                    const int* table, float* out, int B, int Ni, int Hj, int Mj, int Mi,
                    int nact, int layout, int rows, int cluster, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const QShape sh = {B, Ni, layout == kDense ? Ni : nact * Mi, Hj, Mj, Mi, nact};
  int xcopy = 0, wcopy = 0;
  const bool tma = quant_copies(layout, x, w, sh, &xcopy, &wcopy);
  return (int)with_quant_kernel(layout, Mj, tma, [&](auto tile, auto l, auto t) {
    constexpr int BN = decltype(tile)::value, L = decltype(l)::value;
    constexpr bool T = decltype(t)::value;
    QPlan plan = {0, 0};
    const cudaError_t err =
        quant_plan<BN, L, T>(sh.B, sh.K, sh.Hj, rows, cluster, xcopy != kCopyTma, &plan);
    if (err != cudaSuccess) return err;
    const cudaStream_t st = (cudaStream_t)stream;
    return plan.tm == 64 ? launch_quant_tc<BN, L, 64, T>(x, w, bias, scale, table, out, sh, xcopy,
                                                         wcopy, plan.ks, gain, st)
                         : launch_quant_tc<BN, L, 128, T>(x, w, bias, scale, table, out, sh,
                                                          xcopy, wcopy, plan.ks, gain, st);
  });
}

// The plan bcpnn_quant_fwd takes for these operands of ``layout`` on the
// current device: plan = {tile rows, cluster size}; K is the contraction's
// depth (Ni dense, nact*Mi gathered).  Launches nothing (phase 1 of
// chip_smoke.py prints it).
int bcpnn_quant_fwd_plan(const float* x, const int8_t* w, int B, int Ni, int K, int Hj, int Mj,
                         int Mi, int layout, int* plan) {
  plan[0] = plan[1] = 0;
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const QShape sh = {B, Ni, K, Hj, Mj, Mi, layout == kDense ? 0 : K / Mi};
  int xcopy = 0, wcopy = 0;
  const bool tma = quant_copies(layout, x, w, sh, &xcopy, &wcopy);
  return (int)with_quant_kernel(layout, Mj, tma, [&](auto tile, auto l, auto t) {
    QPlan p = {0, 0};
    const cudaError_t err =
        quant_plan<decltype(tile)::value, decltype(l)::value, decltype(t)::value>(
            B, K, Hj, 0, 0, xcopy != kCopyTma, &p);
    plan[0] = p.tm;
    plan[1] = p.ks;
    return err;
  });
}

}  // extern "C"
