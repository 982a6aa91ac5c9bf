// Hand-written Hopper (sm_90a) kernels for the BCPNN main path.
//
// Three kernel bodies for seven of the Pallas TPU kernels:
//
//   bcpnn_hc_softmax     <- repro/kernels/hc_softmax.py::hc_softmax_pallas
//                           (hc_softmax_kernel, sub-warp segments in
//                           registers; hc_softmax_long_kernel past 256)
//   bcpnn_fwd            <- repro/kernels/bcpnn_fwd.py::bcpnn_fwd_pallas
//                           (bcpnn_fwd_tc_kernel, dense layout)
//   bcpnn_patchy_fwd     <- repro/kernels/patchy.py::patchy_forward and
//                           ::compact_forward (bcpnn_fwd_tc_kernel, patchy
//                           and compact layouts)
//   bcpnn_update         <- repro/kernels/bcpnn_update.py::bcpnn_update_pallas
//                           (trace_update_kernel, dense layout)
//   bcpnn_patchy_update  <- repro/kernels/patchy.py::patchy_update and
//                           ::compact_update (trace_update_kernel, patchy
//                           and compact layouts)
//
// Weight layouts (Layout below): dense (Ni, Nj); patchy, the same
// dense-resident arrays restricted per post-HC to the K = nact*Mi live
// pre-units named by the (Hj, nact) index table; compact, the resident
// (Hj, K, Mj) arrays.  The forward body and the resident-trace update body
// each take all three layouts.  The patchy layouts gather their live rows
// inside the tile loads, so the (Hj, B, K) gathered activations of the TPU
// kernels never exist.
//
// All arithmetic keeps fp32 accuracy and no fast-math intrinsics are used,
// because trace increments are ~1e-5 and the log-weight fold must stay
// within 1e-4 of the fp32 reference.  The forwards and the resident-trace
// update run their products on the tensor cores in 3xTF32 (each operand
// split into two TF32 halves, three products summed in fp32), which keeps
// fp32 accuracy; a single TF32 pass (~1e-4 relative error) is never used.
// Each kernel computes its own offsets and masks ragged edges itself (no
// pad plan).  The forwards also take the bf16 weights and bias of a
// serving pack, widened to fp32 on the way in (the TPU kernels cast their
// operands to f32 in-kernel the same way).  The int8 forwards of a serving
// pack are in quant.cu.
//
// C interface: every entry point takes raw device pointers, sizes and the
// CUDA stream, launches on that stream without synchronising, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.  Built by repro_torch/kernels/_build.py, with
// quant.cu, into one library: each source compiled on its own with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// and the objects linked with the same flags and -shared.

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

// ------------------------------------------------------------ hc_softmax --
//
// out[r, h*M + m] = softmax_m(gain * s[r, h*M + m]) for every (row, HC)
// segment of a contiguous (B, H*M) array.
//
// Bound: bytes.  At Model 1 (B=128, H=32, M=128) it reads and writes 2 MiB
// each, ~1.3 us at 3.35 TB/s, below the cost of a launch; the readout call
// (B=128, H=1, M=10) is launch-bound, so there only the length of the
// dependent chain (load, reductions, exp, store) counts.
//
// A sub-warp of L lanes takes a segment, V consecutive values a lane per
// load: float4, float2 or a scalar, the widest that M and both pointers'
// alignment allow.  L is the next power of two of ceil(M / V), at most 32,
// so a warp holds 32 / L segments and reduces each in log2(L) shuffles: M =
// 128 is one 16-byte load a lane with no masked lane; M = 10 is five float2
// loads over 8 lanes, four segments a warp, three shuffle steps; M = 2 is a
// segment a lane.  Segments of up to kSoftmaxRegs values stay in registers
// (IT loads a lane, a power of two): one read, one write.  Longer ones take
// three passes over global memory (max, sum, write) with the same vector
// loads, a warp a segment.  Blocks of 128 threads, so few segments still
// spread over several SMs.
//
// IEEE expf and a true division, as the plain version (kernels/ref.py);
// only the order of the sums differs.  fmaxf passes over a NaN, but exp of
// it then makes the segment's sum and every value NaN, as in the plain
// version; so does a +inf (inf - inf) and an all -inf segment (-inf - -inf).
// NEG pad lanes (DESIGN.md §7) underflow to exactly 0.

constexpr int kSoftmaxThreads = 128;
constexpr int kSoftmaxWarps = kSoftmaxThreads / kWarp;
constexpr int kSoftmaxRegs = 256;  // the longest segment held in registers

// V consecutive floats from (or to) global memory aligned to 4V bytes.
template <int V>
__device__ __forceinline__ void ldg_vec(const float* p, float* d) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void stg_vec(float* p, const float* d) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
    p[0] = d[0];
  }
}

// Segments of at most kSoftmaxRegs values: L lanes a segment, IT loads of V
// values a lane (value (i L + lane) V + e at load i).
template <int V, int L, int IT>
__global__ void __launch_bounds__(kSoftmaxThreads)
hc_softmax_kernel(const float* __restrict__ s, float* __restrict__ out, long long segments,
                  int m, float gain) {
  constexpr int kSegs = kWarp / L;  // segments a warp
  const int lane = threadIdx.x % kWarp, sl = lane % L;
  const long long seg =
      ((long long)blockIdx.x * kSoftmaxWarps + threadIdx.x / kWarp) * kSegs + lane / L;
  const bool live = seg < segments;  // uniform over the segment's lanes
  const float* src = s + seg * m;
  float* dst = out + seg * m;
  float v[IT][V];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int c = (i * L + sl) * V;
    if (live && c < m) {
      ldg_vec<V>(src + c, v[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[i][e] *= gain;
        mx = fmaxf(mx, v[i][e]);
      }
    }
  }
  mx = group_max<L>(mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    if (live && (i * L + sl) * V < m) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[i][e] = expf(v[i][e] - mx);
        sum += v[i][e];
      }
    }
  }
  sum = group_sum<L>(sum);
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int c = (i * L + sl) * V;
    if (live && c < m) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = v[i][e] / sum;
      stg_vec<V>(dst + c, v[i]);
    }
  }
}

// Segments longer than kSoftmaxRegs: a warp a segment, three passes.
template <int V>
__global__ void __launch_bounds__(kSoftmaxThreads)
hc_softmax_long_kernel(const float* __restrict__ s, float* __restrict__ out, long long segments,
                       int m, float gain) {
  const long long seg = (long long)blockIdx.x * kSoftmaxWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (seg >= segments) return;  // warp-uniform
  const float* src = s + seg * m;
  float* dst = out + seg * m;
  float t[V];
  float mx = -INFINITY;
  for (int c = lane * V; c < m; c += kWarp * V) {
    ldg_vec<V>(src + c, t);
#pragma unroll
    for (int e = 0; e < V; ++e) mx = fmaxf(mx, t[e] * gain);
  }
  mx = group_max<kWarp>(mx);
  float sum = 0.f;
  for (int c = lane * V; c < m; c += kWarp * V) {
    ldg_vec<V>(src + c, t);
#pragma unroll
    for (int e = 0; e < V; ++e) sum += expf(t[e] * gain - mx);
  }
  sum = group_sum<kWarp>(sum);
  for (int c = lane * V; c < m; c += kWarp * V) {
    ldg_vec<V>(src + c, t);
#pragma unroll
    for (int e = 0; e < V; ++e) t[e] = expf(t[e] * gain - mx) / sum;
    stg_vec<V>(dst + c, t);
  }
}

// How a segment of m values is taken: V values a load, L lanes, IT loads a
// lane (0: the three-pass loop of hc_softmax_long_kernel).
struct SoftmaxPlan {
  int v, lanes, iters;
};

inline SoftmaxPlan softmax_plan(const float* s, const float* out, int m) {
  const uintptr_t a = (uintptr_t)s | (uintptr_t)out;
  const int v = m % 4 == 0 && (a & 15u) == 0 ? 4 : m % 2 == 0 && (a & 7u) == 0 ? 2 : 1;
  if (m > kSoftmaxRegs) return {v, kWarp, 0};
  const int loads = (m + v - 1) / v;
  int lanes = 1, iters = 1;
  while (lanes < loads && lanes < kWarp) lanes *= 2;
  while (lanes * iters < loads) iters *= 2;
  return {v, lanes, iters};
}

template <int V, int L, int IT>
cudaError_t launch_softmax(const float* s, float* out, long long segments, int m, float gain,
                           cudaStream_t st) {
  const long long per_block = (long long)kSoftmaxWarps * (kWarp / L);
  hc_softmax_kernel<V, L, IT><<<(unsigned)((segments + per_block - 1) / per_block),
                                kSoftmaxThreads, 0, st>>>(s, out, segments, m, gain);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_softmax_v(const SoftmaxPlan& p, const float* s, float* out,
                             long long segments, int m, float gain, cudaStream_t st) {
  if (p.iters == 0) {
    hc_softmax_long_kernel<V><<<(unsigned)((segments + kSoftmaxWarps - 1) / kSoftmaxWarps),
                                kSoftmaxThreads, 0, st>>>(s, out, segments, m, gain);
    return cudaGetLastError();
  }
  switch (p.lanes) {
    case 1: return launch_softmax<V, 1, 1>(s, out, segments, m, gain, st);
    case 2: return launch_softmax<V, 2, 1>(s, out, segments, m, gain, st);
    case 4: return launch_softmax<V, 4, 1>(s, out, segments, m, gain, st);
    case 8: return launch_softmax<V, 8, 1>(s, out, segments, m, gain, st);
    case 16: return launch_softmax<V, 16, 1>(s, out, segments, m, gain, st);
    default: break;
  }
  // 32 lanes: at most kSoftmaxRegs / (32 V) loads a lane
  if (p.iters == 1) return launch_softmax<V, kWarp, 1>(s, out, segments, m, gain, st);
  if (p.iters == 2) return launch_softmax<V, kWarp, 2>(s, out, segments, m, gain, st);
  if constexpr (V <= 2) {
    if (p.iters == 4) return launch_softmax<V, kWarp, 4>(s, out, segments, m, gain, st);
  }
  if constexpr (V == 1) {
    if (p.iters == 8) return launch_softmax<V, kWarp, 8>(s, out, segments, m, gain, st);
  }
  return cudaErrorInvalidValue;
}

// V consecutive floats from 8- or 16-byte-aligned shared memory (the
// resident-trace update's fragment and EMA loads).
template <int V>
__device__ __forceinline__ void lds(const float* p, float* d) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = p[0];
  }
}

// ------------------------------------------- resident-trace update (tc) --
//
//   co    = x^T y / n           (n = *count if given, else the B rows read)
//   pij'  = (1 - a) pij + a co
//   w     = (log clip(pij', eps^2, 1) - log_pi[i] - log_pj[j]) * m[i, j]
//
// One body for the three layouts of the resident trace.  It replaces three
// TPU kernels:
//   src/repro/kernels/bcpnn_update.py:63 bcpnn_update_pallas (dense: m is
//     the (Hi, Hj) hypercolumn mask, indexed at HC level, mask[i/Mi, j/Mj]);
//   src/repro/kernels/patchy.py:241 patchy_update (patchy-held: an element
//     is live when its pre-HC i/Mi is in post-HC j/Mj's row of the (Hj,
//     nact) table; a live element takes the EMA and the fold, a silent one
//     keeps pij' = pij bit for bit and w = 0);
//   src/repro/kernels/patchy.py:289 compact_update (compact: the resident
//     (Hj, K, Mj) trace, every element live, m = 1, log_pi taken at each
//     row's gathered unit).
// ``a`` and ``count`` are 0-d device tensors (no host sync); outputs are
// fresh arrays, every element written once, and the input trace is only
// read.
//
// Bound: bytes.  Each output element is read once as pij and written once
// as pij' and w: 77 MB at Model 1 (Ni=1568, Nj=4096) and at Model 1-struct
// (the same arrays), ~23 us at 3.35 TB/s, ~24 us with the inputs.  The
// product is 1.64 GFLOP at B=128; in 3xTF32 three times that, ~10 us at
// the tensor cores' 495 TFLOP/s, under the bytes.  This body does not
// reach the bound: mma.sync with the operands split in every step runs
// at well under half that rate on the card (chip_smoke.py's mma.sync
// yardstick, csrc/yardstick.cu), so its dense product at Model 1 lasts
// about as long as the bytes, and the two overlap only in part.  The
// compact layout at Model 1-struct (Hj = 32, K = 256, Mj = 128) moves
// 15.5 MB, ~4.6 us.  What each part of the design does about it:
//
//  * Tiles of 64 rows x 128 columns (64 x 32 when Nj <= 64: the readout),
//    and persistent blocks, one per SM, of two teams of 8 warps (each warp
//    a 32 x 32 block).  At Model 1: 25 x 32 = 800 tiles, ~6 per SM, the
//    half-height last row of tiles falling to the blocks with one more.
//  * The two teams take turns at the tensor cores (named barriers), so one
//    team's product runs while the other stores its last tile and loads
//    its next.  Each team owns two shared regions: tile k's pij lies in
//    region k % 2 and its batch-slice ring in the other, so tile k + 1's
//    pij is requested as soon as tile k's product ends and streams in under
//    tile k's epilogue and the other team's product.
//  * pij arrives by bulk async copies (TMA, cp.async.bulk), one per row,
//    completing on the region's mbarrier; rows whose length or address is
//    not 16-byte aligned (ragged shapes) fall back to 4-byte cp.async.
//  * The product runs on the tensor cores: mma.sync m16n8k8 TF32 with fp32
//    accumulators, in 3xTF32.  Each operand is split in the fragment load
//    (split_tf32) into hi, rounded as cvt.rna.tf32.f32 rounds but with two
//    integer operations (the cvt's lower rate bounded the split), and lo =
//    v - hi, which the tensor cores read truncated to TF32 (a NaN v makes
//    lo a NaN); the three products lo*hi, hi*lo, hi*hi are accumulated
//    (lo*lo, ~2^-22 relative, is dropped); ref.split_tf32_mm models it on
//    the CPU.  No single TF32 pass.  The contraction runs over the batch; x (B, Ni) and y (B, Nj)
//    arrive batch-major, so A = x^T is read column-wise from the staged x
//    slice.  Rows and columns of each warp's block are permuted inside the
//    fragments so that each operand comes in 8- or 16-byte shared loads,
//    and the slices' rows are padded to a stride of 8 (mod 32) words: the
//    fragment loads are free of bank conflicts.  (wgmma would need K-major
//    tf32 operands, a transpose in shared memory: a later redesign.)
//  * The batch slices of x and y (32 rows) are staged with cp.async
//    (16-byte, zero filled past the edges) in a ring of two stages, the
//    next slice in flight while the tensor cores work on the current one;
//    a tile's first slice is staged before its turn.
//  * Epilogue in two passes over the shared pij tile: the EMA in the
//    accumulators' layout, in place (16-byte shared accesses), then the
//    log fold and the mask in row-major order, reading log_pi, log_pj and
//    the HC indices from per-tile shared vectors (loaded by cp.async), with
//    pij' and w written as 16-byte coalesced stores.
//  * Patchy: the product runs only over live rows.  Gathered tiles (first
//    in the tile order) hold a post-HC's K = nact*Mi live rows, found
//    through its table row, with the EMA and the fold; copy tiles cover
//    the (Ni, Nj) grid and write its silent entries back as read with w =
//    0, skipping the live ones, with no product and no turn.  A copy tile
//    builds its live predicate, a bitmask over its pre-HCs for each
//    post-HC its columns cover, in shared memory from those post-HCs'
//    table rows (no extra launch, no (Hi, Hj) array).  Copy tiles read the
//    whole pij tile: the live rows, 16 % at Model 1-struct, are read twice.
//  * Compact: gathered tiles only, each a post-HC's live rows addressed in
//    the resident (Hj, K, Mj) arrays at ((h K + k) Mj + j), so a tile's rows
//    are one contiguous run; no copy tiles, no mask.  Gathered x moves in
//    8-byte pairs (a pre-HC's two units side by side) where Mi is even.
//    The tile was picked by timing variants of this body on the H100 at
//    Model 1-struct: 64 x 128 tiles, 128 of them, one per SM, with or
//    without the turns, were the fastest; 32 x 128 tiles (two per SM, one
//    a team), gathered x in 4-byte pieces, one team a block with 64-deep
//    batch slices, and the batch split between a block's two teams were
//    slower or no faster.  With one tile per SM every SM runs
//    the same phase at once (the pij read, the product, the 8.4 MB of
//    stores of the fold), so none hides another: ~3x the bytes bound.

constexpr int kTrStages = 2;
constexpr int kTrTeams = 2;          // ping-pong teams per block
constexpr int kTrTeamThreads = 256;  // 8 warps a team
constexpr int kTrThreads = kTrTeams * kTrTeamThreads;
constexpr int kTrPad = 8;            // row stride = 8 (mod 32) words

// Which operands may move in 16-byte pieces (length a multiple of 4
// floats and a 16-byte aligned base); kVecX2: gathered x in 8-byte pairs
// (a pre-HC's units 2m, 2m + 1 side by side: Mi and Ni even).
constexpr int kVecX = 1, kVecY = 2, kVecP = 4, kVecX2 = 8;

// What a tile computes.  kProduct: dense rows, the EMA and the masked
// fold.  kGathered: the patchy layout's live rows of one post-HC (table
// rows), the EMA and the fold.  kCopy: the patchy layout's silent entries
// of a dense tile, written back as read with w = 0 (no product).
enum TileKind : int { kProduct = 0, kGathered = 1, kCopy = 2 };

// One team's tile: BM rows x BN columns, BK batch rows a stage, WN warps
// along the columns; its warp layout and shared-memory map (offsets in
// 4-byte words).  The block holds kTrTeams of them.
template <int BM, int BN, int BK, int WN>
struct TraceTile {
  static constexpr int kBM = BM, kBN = BN, kBK = BK;
  static constexpr int kWarpsN = WN;
  static constexpr int kWarpsM = kTrTeamThreads / kWarp / WN;
  static constexpr int kMF = BM / kWarpsM / 16;  // m16 fragments a warp
  static constexpr int kNF = BN / WN / 8;        // n8 fragments a warp
  static constexpr int kLdX = BM + kTrPad;
  static constexpr int kLdY = BN + kTrPad;
  static constexpr int kLdP = BN + kTrPad;
  // Two regions, each holding a pij tile or a batch-slice ring, then two
  // sets of per-tile vectors, then one mbarrier per region.
  static constexpr int kX = 0;                              // ring: [stage][BK][kLdX]
  static constexpr int kY = kX + kTrStages * BK * kLdX;     // ring: [stage][BK][kLdY]
  static constexpr int kRing = kY + kTrStages * BK * kLdY;
  static constexpr int kRegion = BM * kLdP > kRing ? BM * kLdP : kRing;  // pij: [BM][kLdP]
  static constexpr int kLpi = 0;                            // [BM]
  static constexpr int kLpj = kLpi + BM;                    // [BN]
  static constexpr int kRowU = kLpj + BN;                   // [BM] int: row's unit
  static constexpr int kRowHc = kRowU + BM;                 // [BM] int
  static constexpr int kColHc = kRowHc + BM;                // [BN] int
  static constexpr int kLive = kColHc + BN;                 // [BN][4] bits
  static constexpr int kVec = kLive + BN * 4;
  static constexpr int kBars = 2 * kRegion + 2 * kVec;      // two mbarriers
  static constexpr int kWords = kBars + 4;                  // 16-byte multiple
  static_assert(kMF * kWarpsM * 16 == BM && (kMF == 1 || kMF == 2), "tile rows");
  static_assert(kNF * WN * 8 == BN && (kNF == 2 || kNF == 4 || kNF == 8), "tile columns");
  static constexpr int kNQ = kNF < 4 ? kNF : 4;  // n-fragments read in one load
  static_assert(BM <= 128 && BK % 8 == 0, "tile shape");
  static_assert(kRegion % 4 == 0 && kVec % 4 == 0 && kLpj % 4 == 0 && kColHc % 4 == 0,
                "alignment");
  static_assert(kLdX % 32 == kTrPad && kLdY % 32 == kTrPad, "bank-conflict-free stride");
};
// Wide traces (Model 1: (1568, 4096)): 64 x 128 tiles, each warp 32 x 32.
// Narrow ones (Nj <= 64, the readout): 64 x 32, each warp 16 x 16.
using WideTile = TraceTile<64, 128, 32, 4>;
using NarrowTile = TraceTile<64, 32, 16, 2>;

// One bulk (TMA) copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) completing on ``bar``.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// One team stages batch rows [b0, b0 + BK): the tile's x columns (the
// units in rowu, contiguous unless gathered, in pairs when x2) and its y
// columns.
template <class T>
__device__ __forceinline__ void load_batch_slice(float* xs, float* ys, const float* __restrict__ x,
                                                 const float* __restrict__ y, const int* rowu,
                                                 int tt, int b0, int B, int rows, int cols,
                                                 int Ni, int Nj, int j0, bool vx, bool x2,
                                                 bool vy) {
  constexpr int BM = T::kBM, BN = T::kBN, BK = T::kBK;
  if (vx) {  // contiguous rows rowu[0] .. rowu[0] + rows - 1
    const float* xb = x + rowu[0];
    for (int e = tt; e < BK * BM / 4; e += kTrTeamThreads) {
      const int bb = e / (BM / 4), u = (e % (BM / 4)) * 4;
      const bool v = b0 + bb < B && u < rows;
      cp_async16(xs + bb * T::kLdX + u, v ? xb + (size_t)(b0 + bb) * Ni + u : x, v);
    }
  } else if (x2) {  // rows 2m, 2m + 1 at units rowu[2m], rowu[2m] + 1
    for (int e = tt; e < BK * BM / 2; e += kTrTeamThreads) {
      const int bb = e / (BM / 2), u = (e % (BM / 2)) * 2;
      const bool v = b0 + bb < B && u < rows;
      cp_async8(xs + bb * T::kLdX + u, v ? x + (size_t)(b0 + bb) * Ni + rowu[u] : x, v);
    }
  } else {
    for (int e = tt; e < BK * BM; e += kTrTeamThreads) {
      const int bb = e / BM, u = e % BM;
      const bool v = b0 + bb < B && u < rows;
      cp_async4(xs + bb * T::kLdX + u, v ? x + (size_t)(b0 + bb) * Ni + rowu[u] : x, v);
    }
  }
  if (vy) {
    for (int e = tt; e < BK * BN / 4; e += kTrTeamThreads) {
      const int bb = e / (BN / 4), u = (e % (BN / 4)) * 4;
      const bool v = b0 + bb < B && u < cols;
      cp_async16(ys + bb * T::kLdY + u, v ? y + (size_t)(b0 + bb) * Nj + j0 + u : y, v);
    }
  } else {
    for (int e = tt; e < BK * BN; e += kTrTeamThreads) {
      const int bb = e / BN, u = e % BN;
      const bool v = b0 + bb < B && u < cols;
      cp_async4(ys + bb * T::kLdY + u, v ? y + (size_t)(b0 + bb) * Nj + j0 + u : y, v);
    }
  }
}

// Tiles of a launch: dense, the (Ni, Nj) grid of product tiles; patchy,
// Hj x ceil(K/BM) x ceil(Mj/BN) gathered tiles first, then the (Ni, Nj)
// grid of copy tiles; compact, the gathered tiles alone.
template <int L, class T>
__host__ __device__ __forceinline__ int trace_tiles(int Ni, int Nj, int Mi, int Mj, int Hj,
                                                   int nact) {
  const int dense = ((Ni + T::kBM - 1) / T::kBM) * ((Nj + T::kBN - 1) / T::kBN);
  const int gathered = Hj * ((nact * Mi + T::kBM - 1) / T::kBM) * ((Mj + T::kBN - 1) / T::kBN);
  if (L == kDense) return dense;
  return L == kCompact ? gathered : gathered + dense;
}

// Persistent: block b's team tau takes tiles b + (2k + tau) * gridDim.x,
// k = 0, 1, ...  The two teams take turns at the tensor cores (named
// barriers 3 and 4), so that one team's product runs while the other
// stores a tile and loads the next.  Each team keeps two regions: tile k's
// pij sits in region k % 2 and its batch-slice ring in the other, so tile
// k + 1's pij streams into the ring of tile k as soon as that product is
// done, under tile k's epilogue.
template <int L, class T>
__global__ void __launch_bounds__(kTrThreads, 1)
trace_update_kernel(const float* __restrict__ pij, const float* __restrict__ log_pi,
                    const float* __restrict__ log_pj, const float* __restrict__ x,
                    const float* __restrict__ y, const float* __restrict__ mask,
                    const int* __restrict__ table, const float* __restrict__ a_ptr,
                    const float* __restrict__ count_ptr, float* __restrict__ pij_out,
                    float* __restrict__ w_out, int B, int Ni, int Nj, int Mi, int Mj, int Hj,
                    int nact, int vec, float eps2) {
  constexpr int BM = T::kBM, BN = T::kBN, BK = T::kBK, MF = T::kMF, NF = T::kNF, NQ = T::kNQ;
  extern __shared__ __align__(16) float tsm[];
  const int team = threadIdx.x / kTrTeamThreads;
  const int tt = threadIdx.x % kTrTeamThreads;
  float* sm = tsm + team * T::kWords;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + T::kBars);
  const bool bulk = vec & kVecP;
  const int team_bar = 1 + team;  // this team's own barrier
  const int my_turn = 3 + team, their_turn = 4 - team;

  const int K = nact * Mi;  // live rows of a post-HC (patchy, compact)
  const int gm = (K + BM - 1) / BM, gn = (Mj + BN - 1) / BN;
  const int gathered = L == kDense ? 0 : Hj * gm * gn;
  const int dense_n = (Nj + BN - 1) / BN;
  const int tiles = trace_tiles<L, T>(Ni, Nj, Mi, Mj, Hj, nact);
  const int G = gridDim.x;
  // A team's tiles below ``below``: all of them, and its product tiles
  // (the first ones: gathered tiles come first), which take the turns.
  auto count_of = [&](int tau, int below) {
    const int first = blockIdx.x + tau * G;
    return first < below ? (below - 1 - first) / (2 * G) + 1 : 0;
  };
  const int products = L == kDense ? tiles : gathered;
  const int mine = count_of(team, tiles);
  const int my_products = count_of(team, products), their_products = count_of(1 - team, products);

  if (tt == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
  }
  __syncthreads();

  const float a = *a_ptr;
  const float one_minus_a = 1.f - a;
  const float a_n = a / (count_ptr != nullptr ? *count_ptr : (float)B);
  const int lane = tt % kWarp, warp = tt / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / T::kWarpsN) * (MF * 16);
  const int wn0 = (warp % T::kWarpsN) * (NF * 8);

  // Tile k: kind, first row r0 (a dense row, or a gathered index into
  // post-HC h's live rows), first column j0, extent.
  struct Job {
    int kind, r0, j0, rows, cols, h;
  };
  auto job_of = [&](int k) {
    const int tile = blockIdx.x + (2 * k + team) * G;
    Job j;
    j.h = 0;
    if (tile < gathered) {
      j.kind = kGathered;
      j.h = tile / (gm * gn);
      const int rem = tile % (gm * gn);
      j.r0 = (rem / gn) * BM;
      const int jl = (rem % gn) * BN;
      j.j0 = j.h * Mj + jl;
      j.rows = min(BM, K - j.r0);
      j.cols = min(BN, Mj - jl);
    } else {
      j.kind = L == kDense ? kProduct : kCopy;
      const int d = tile - gathered;
      j.r0 = (d / dense_n) * BM;
      j.j0 = (d % dense_n) * BN;
      j.rows = min(BM, Ni - j.r0);
      j.cols = min(BN, Nj - j.j0);
    }
    return j;
  };
  auto unit_at = [&](const Job& j, int r) {  // dense row or gathered unit of tile row r
    return j.kind == kGathered ? unit_of<kPatchy>(table, j.h, min(j.r0 + r, K - 1), Mi, nact)
                               : min(j.r0 + r, Ni - 1);
  };
  // Offset of tile row r's first column in pij, pij' and w: the (Ni, Nj)
  // arrays at the row's unit, or the compact (Hj, K, Mj) ones at
  // (h, r0 + r) (unit of the row: x's column and log_pi's index only).
  auto row_at = [&](const Job& j, int r) -> size_t {
    if (L == kCompact) return ((size_t)j.h * K + min(j.r0 + r, K - 1)) * Mj + (j.j0 - j.h * Mj);
    return (size_t)unit_at(j, r) * Nj + j.j0;
  };
  auto region = [&](int q) { return sm + (q & 1) * T::kRegion; };
  auto vecs = [&](int q) { return sm + 2 * T::kRegion + (q & 1) * T::kVec; };

  // Tile k's row and column vectors into its vector set, and its pij into
  // region k % 2 (the caller has freed both).  Each thread computes the
  // units of the rows it loads itself, so no barrier is needed first.
  auto prefetch = [&](int k) {
    const Job j = job_of(k);
    float* v = vecs(k);
    int* rowu = reinterpret_cast<int*>(v + T::kRowU);
    for (int r = tt; r < BM; r += kTrTeamThreads) {
      const int gi = unit_at(j, r);
      rowu[r] = gi;
      cp_async4(v + T::kLpi + r, log_pi + gi, true);
      reinterpret_cast<int*>(v + T::kRowHc)[r] = gi / Mi;
    }
    for (int c = tt; c < BN; c += kTrTeamThreads) {
      const int gj = min(j.j0 + c, Nj - 1);
      cp_async4(v + T::kLpj + c, log_pj + gj, true);
      reinterpret_cast<int*>(v + T::kColHc)[c] = gj / Mj;
    }
    float* ps = region(k);
    if (bulk) {
      uint64_t* bar = bars + (k & 1);
      if (tt == 0) mbar_expect(bar, (uint32_t)(j.rows * j.cols * 4));
      for (int r = tt; r < j.rows; r += kTrTeamThreads) {
        bulk_copy(ps + r * T::kLdP, pij + row_at(j, r), (uint32_t)(j.cols * 4), bar);
      }
    } else {
      for (int e = tt; e < BM * BN; e += kTrTeamThreads) {
        const int r = e / BN, c = e % BN;
        const bool ok = r < j.rows && c < j.cols;
        cp_async4(ps + r * T::kLdP + c, ok ? pij + row_at(j, r) + c : pij, ok);
      }
    }
    cp_async_commit();
  };
  // Batch slice sl of tile k into ring slot sl % kTrStages (region k + 1).
  auto stage = [&](int k, const Job& j, int sl) {
    const int slot = sl % kTrStages;
    float* ring = region(k + 1);
    const int* rowu = reinterpret_cast<const int*>(vecs(k) + T::kRowU);
    load_batch_slice<T>(ring + T::kX + slot * BK * T::kLdX, ring + T::kY + slot * BK * T::kLdY, x,
                        y, rowu, tt, sl * BK, B, j.rows, j.cols, Ni, Nj, j.j0,
                        (vec & kVecX) && j.kind != kGathered, vec & kVecX2, vec & kVecY);
    cp_async_commit();
  };

  if (mine > 0) {
    prefetch(0);
    barrier_sync(team_bar, kTrTeamThreads);  // tile 0's rows before its x slices
    const Job j0b = job_of(0);
    if (j0b.kind != kCopy) {
      for (int sl = 0; sl < (B + BK - 1) / BK && sl < kTrStages - 1; ++sl) stage(0, j0b, sl);
    }
  }
  for (int k = 0; k < mine; ++k) {
    const Job j = job_of(k);
    float* ps = region(k);
    float* ring = region(k + 1);
    float* v = vecs(k);
    const float* lpi_s = v + T::kLpi;
    const float* lpj_s = v + T::kLpj;
    const int* rowu = reinterpret_cast<const int*>(v + T::kRowU);
    const int* rowhc = reinterpret_cast<const int*>(v + T::kRowHc);
    const int* colhc = reinterpret_cast<const int*>(v + T::kColHc);
    uint32_t* live = reinterpret_cast<uint32_t*>(v + T::kLive);
    const int pre0 = j.r0 / Mi, post0 = j.j0 / Mj;

    // 1. x^T y in 3xTF32 on the tensor cores, in this team's turn.  The
    // fragments' rows and columns are permuted within the warp's block so
    // that each operand comes in 8- or 16-byte shared loads: fragment row
    // g (g + 8) of m-fragment mf is the block's row g*2*MF + 2*mf (+1),
    // fragment column g of n-fragment nf its column
    // (nf / NQ)*8*NQ + g*NQ + nf % NQ.
    const int slices = j.kind == kCopy ? 0 : (B + BK - 1) / BK;
    const bool turn = k < my_products;
    if (turn && (team == 1 || k > 0)) barrier_sync(my_turn, kTrThreads);
    float acc[MF][NF][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mf][nf][q] = 0.f;
    for (int s = 0; s < slices; ++s) {
      if (s + 1 < slices) {
        stage(k, j, s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      barrier_sync(team_bar, kTrTeamThreads);
      const float* xs = ring + T::kX + (s % kTrStages) * BK * T::kLdX + wm0 + g * 2 * MF;
      const float* ys = ring + T::kY + (s % kTrStages) * BK * T::kLdY + wn0 + g * NQ;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        float av[2][2 * MF], bv[2][NF];
#pragma unroll
        for (int hk = 0; hk < 2; ++hk) {  // k = kk + t, kk + t + 4
          lds<2 * MF>(xs + (kk + t + 4 * hk) * T::kLdX, av[hk]);
#pragma unroll
          for (int hq = 0; hq < NF / NQ; ++hq)
            lds<NQ>(ys + (kk + t + 4 * hk) * T::kLdY + hq * 8 * NQ, bv[hk] + hq * NQ);
        }
        uint32_t ah[MF][4], al[MF][4], bh[NF][2], bl[NF][2];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int q = 0; q < 4; ++q)  // a0..a3: (g, t), (g+8, t), (g, t+4), (g+8, t+4)
            split_tf32(av[q / 2][2 * mf + q % 2], ah[mf][q], al[mf][q]);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int q = 0; q < 2; ++q) split_tf32(bv[q][nf], bh[nf][q], bl[nf][q]);
        // pass by pass, so that MF*NF independent products lie between two
        // into one accumulator
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) mma_tf32(acc[mf][nf], al[mf], bh[nf]);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) mma_tf32(acc[mf][nf], ah[mf], bl[nf]);
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) mma_tf32(acc[mf][nf], ah[mf], bh[nf]);
      }
      if (s + 1 == slices) fence_proxy_async();  // the ring takes tile k + 1's pij
      barrier_sync(team_bar, kTrTeamThreads);  // (also: the ring is free)
    }
    // The other team's turn: after its own product k (team 0) or k + 1.
    if (turn && (team == 0 ? k < their_products : k + 1 < their_products)) {
      barrier_arrive(their_turn, kTrThreads);
    }

    // 2. Tile k + 1's vectors and pij, into the ring just freed (a copy
    // tile has no ring; region (k + 1) % 2 was freed by tile k - 1).
    if (k + 1 < mine) prefetch(k + 1);
    cp_async_wait<0>();  // tile k's vectors, a 4-byte pij path
    if (bulk) mbar_wait(bars + (k & 1), (k >> 1) & 1);

    // 3. The EMA, over the thread's 2*MF rows x 2*NQ contiguous columns
    // (NF / NQ runs) of the shared pij tile, in place.  acc[mf][nf][2h + e]
    // is row g*2*MF + 2*mf + h, column (nf / NQ)*8*NQ + (2t + e)*NQ +
    // nf % NQ of the warp's block.
    if (j.kind != kCopy) {
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
          for (int hq = 0; hq < NF / NQ; ++hq) {
            float* row = ps + (wm0 + g * 2 * MF + 2 * mf + hr) * T::kLdP + wn0 + hq * 8 * NQ +
                         2 * t * NQ;
#pragma unroll
            for (int v4 = 0; v4 < 2 * NQ; v4 += 4) {
              float p[4];
              lds<4>(row + v4, p);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int e = (v4 + q) / NQ, nf = hq * NQ + (v4 + q) % NQ;
                p[q] = one_minus_a * p[q] + a_n * acc[mf][nf][2 * hr + e];
              }
              *reinterpret_cast<float4*>(row + v4) = make_float4(p[0], p[1], p[2], p[3]);
            }
          }
        }
    } else {
      // the patchy live bits of a copy tile: for each post-HC its columns
      // cover, a mask over the tile's pre-HCs, from the table
      const int npost = (j.j0 + j.cols - 1) / Mj - post0 + 1;  // <= BN
      const int npre = (j.r0 + j.rows - 1) / Mi - pre0 + 1;    // <= BM
      for (int e = tt; e < npost * 4; e += kTrTeamThreads) live[e] = 0u;
      barrier_sync(team_bar, kTrTeamThreads);
      for (int e = tt; e < npost * nact; e += kTrTeamThreads) {
        const int hh = e / nact;
        const int p = table[(size_t)(post0 + hh) * nact + (e - hh * nact)] - pre0;
        if (p >= 0 && p < npre) atomicOr(&live[hh * 4 + (p >> 5)], 1u << (p & 31));
      }
    }
    barrier_sync(team_bar, kTrTeamThreads);

    // 4. The fold, row-major, with pij' and w as 16-byte stores.  A copy
    // tile's loop is compiled on its own (no log in it), the dense layout
    // has none.
    auto is_live = [&](int r, int c) -> bool {
      const int p = rowhc[r] - pre0;
      return (live[(colhc[c] - post0) * 4 + (p >> 5)] >> (p & 31)) & 1u;
    };
    auto fold = [&](auto copy_tile) {
      constexpr bool kCopyTile = decltype(copy_tile)::value;
#pragma unroll 2
      for (int e = tt; e < BM * BN / 4; e += kTrTeamThreads) {
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        if (r >= j.rows || c >= j.cols) continue;
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * T::kLdP + c);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        float wv[4];
        bool keep[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          keep[q] = c + q < j.cols;
          if constexpr (kCopyTile) {
            keep[q] = keep[q] && !is_live(r, c + q);  // live: the gathered tiles'
            wv[q] = 0.f;
          } else {
            // clip to [eps2, 1], a NaN kept (fmaxf would drop it), as the
            // plain version's clamp keeps it
            const float pc = pv[q] < eps2 ? eps2 : (pv[q] > 1.f ? 1.f : pv[q]);
            const float lw = logf(pc) - (lpi_s[r] + lpj_s[c + q]);
            wv[q] = L == kDense ? lw * mask[(size_t)rowhc[r] * Hj + colhc[c + q]] : lw;
          }
        }
        const size_t idx =
            (L == kCompact ? row_at(j, r) : (size_t)rowu[r] * Nj + j.j0) + c;
        // 16-byte stores: every chunk is whole and, in a copy tile, all
        // live or all silent (Mj a multiple of 4 on this path)
        if (bulk) {
          if (keep[0]) {
            *reinterpret_cast<float4*>(pij_out + idx) = p4;
            *reinterpret_cast<float4*>(w_out + idx) = make_float4(wv[0], wv[1], wv[2], wv[3]);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (keep[q]) {
              pij_out[idx + q] = pv[q];
              w_out[idx + q] = wv[q];
            }
          }
        }
      }
    };
    if (L == kPatchy && j.kind == kCopy) {
      fold(std::true_type{});
    } else {
      fold(std::false_type{});
    }

    // 5. Region k % 2 becomes tile k + 1's ring: its first slices load
    // while the other team multiplies.  (After a copy tile k + 1, it takes
    // tile k + 2's pij instead.)
    fence_proxy_async();
    barrier_sync(team_bar, kTrTeamThreads);
    if (k + 1 < mine) {
      const Job jn = job_of(k + 1);
      if (jn.kind != kCopy) {
        for (int sl = 0; sl < (B + BK - 1) / BK && sl < kTrStages - 1; ++sl) stage(k + 1, jn, sl);
      }
    }
  }
}

template <int L, class T>
cudaError_t launch_trace(const float* pij, const float* log_pi, const float* log_pj,
                         const float* x, const float* y, const float* mask, const int* table,
                         const float* a, const float* count, float* pij_out, float* w_out, int B,
                         int Ni, int Nj, int Mi, int Mj, int Hj, int nact, int vec, float eps2,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * kTrTeams * T::kWords;
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        trace_update_kernel<L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = trace_tiles<L, T>(Ni, Nj, Mi, Mj, Hj, nact);
  const int grid = sms < tiles ? sms : tiles;
  trace_update_kernel<L, T><<<grid, kTrThreads, smem, stream>>>(
      pij, log_pi, log_pj, x, y, mask, table, a, count, pij_out, w_out, B, Ni, Nj, Mi, Mj, Hj,
      nact, vec, eps2);
  return cudaGetLastError();
}

// Picks the tile from Nj and the 16-byte paths from the operands (the
// patchy layout's column blocks must also start on 16 bytes: Mj % 4 == 0).
template <int L>
cudaError_t launch_trace_any(const float* pij, const float* log_pi, const float* log_pj,
                             const float* x, const float* y, const float* mask,
                             const int* table, const float* a, const float* count,
                             float* pij_out, float* w_out, int B, int Ni, int Nj, int Mi, int Mj,
                             int Hj, int nact, float eps2, cudaStream_t st) {
  const bool cols4 = Nj % 4 == 0 && (L == kDense || Mj % 4 == 0);
  int vec = 0;
  if (Ni % 4 == 0 && aligned16(x)) vec |= kVecX;
  if (cols4 && aligned16(y)) vec |= kVecY;
  if (cols4 && aligned16(pij) && aligned16(pij_out) && aligned16(w_out)) vec |= kVecP;
  if (L == kCompact && Mi % 2 == 0 && Ni % 2 == 0 && ((uintptr_t)x & 7u) == 0) vec |= kVecX2;
  if (Nj <= 64) {
    return launch_trace<L, NarrowTile>(pij, log_pi, log_pj, x, y, mask, table, a, count, pij_out,
                                       w_out, B, Ni, Nj, Mi, Mj, Hj, nact, vec, eps2, st);
  }
  return launch_trace<L, WideTile>(pij, log_pi, log_pj, x, y, mask, table, a, count, pij_out,
                                   w_out, B, Ni, Nj, Mi, Mj, Hj, nact, vec, eps2, st);
}

// ------------------------------------------------------ the forwards --
//
// rates[b, h*Mj + n] = softmax_n(gain * (bias + xg @ wg)[b, h*Mj + n]), one
// body (bcpnn_fwd_tc_kernel<F>) for the three weight layouts:
//   dense    xg = x (B, Ni), wg = w (Ni, Hj*Mj).  Replaces
//            src/repro/kernels/bcpnn_fwd.py:56 bcpnn_fwd_pallas.
//   patchy   post-HC h contracts over its K = nact*Mi live pre-units, named
//            by row h of the (Hj, nact) index table: xg gathers those
//            columns of x, wg those rows of the dense-resident masked w
//            (Ni, Hj*Mj).  Replaces src/repro/kernels/patchy.py:121
//            patchy_forward.
//   compact  the same xg against the resident w_c (Hj, K, Mj).  Replaces
//            src/repro/kernels/patchy.py:154 compact_forward.
// x is fp32; w and bias fp32 or the bf16 of a serving pack.  The TPU
// kernels gather x into an (Hj, B, K) array first; here the gather happens
// in the tile loads, so that array never exists.
//
// Bound.  Dense, at Model 1 (B=128, Ni=1568, Nj=4096): operations, the
// 1.64 GFLOP product in 3xTF32 on the tensor cores three times over, ~10
// us at 495 TFLOP/s TF32 (two products for a bf16 weight, ~6.6 us); its
// 28.6 MB of traffic take ~8.5 us.  Gathered, at Model 1-struct (nact =
// 128, K = 256): bytes, ~7.1 MB (x, the live weights once, bias, rates),
// ~2.1 us at 3.35 TB/s, against ~1.6 us for the 3 x 268 MFLOP.  Its short
// contraction (16 slices) leaves each block five or six, so fixed costs
// weigh there: the first slice's gather, the slowest rank's extra slice,
// the exchange of partial supports.  The gathered slices themselves are
// held back by the load/store unit, which both the scattered x pieces
// (8 bytes each at Model 1-struct, 1024 a slice) and the split pass
// through.  What each part of the design does about it:
//
//  * Grid: one cluster per (batch tile of 128 rows, post-HC), of KS blocks
//    that split the contraction (Ni deep, or K gathered) between them in
//    16-deep slices, so each w element leaves L2 once per batch tile.
//    KS (1..8) is the
//    one with the fewest waves per share of work, from the count of
//    co-resident clusters (cudaOccupancyMaxActiveClusters): at Model 1
//    fewer clusters of 4 fit the card at once than its 32 post-HCs need,
//    so a smaller cluster that runs in one wave wins (3 at Model 1 and
//    Model 1-struct); the readout (one post-HC) takes 8.  A cluster of one
//    block is launched without the cluster attribute.
//    After its slices a block parks its partial support in shared
//    memory; each rank then sums a KS-th of the tile's rows over the
//    cluster's partials (distributed shared memory, in rank order): the
//    support never leaves the cluster.  An HC of one column chunk (Mj <=
//    128, every model here) keeps its rows in registers: G threads a row
//    read the partials in whole runs, add the bias (staged in shared
//    memory by the tensor-core warps while the first slice arrives),
//    apply the gain, take the softmax with shuffles and store; each thread
//    arrives at the cluster barrier as soon as its remote reads are done
//    and waits on it only before it exits.  Wider HCs keep the rows of
//    each column chunk in a shared support buffer and normalise them once
//    every chunk is in.
//  * The product runs on the tensor cores in 3xTF32: wgmma m64nCNk8
//    (lo*hi, hi*lo, hi*hi; lo*lo, ~2^-22 relative, dropped), both
//    operands read by the tensor cores from shared memory, so no fragment
//    passes through registers; ref.split_tf32_mm models it on the CPU.  No
//    single TF32 pass.  A bf16 weight is exact in TF32 (w_lo = 0): its
//    tiles hold w once and take two products.  Two warpgroups of
//    tensor-core warps each own 64 rows of the tile.
//  * The promotion.  The tensor cores' fp32 accumulator does not round to
//    nearest: each wgmma truncates at the magnitude of the running sum,
//    so a sum carried through a block's whole contraction drifts toward
//    zero in proportion to its size (a gain-like shrink of the supports,
//    which log-odds weights make thousands deep).  Each slice's products
//    therefore go to a fresh accumulator of CN = min(BN, 64) columns
//    (scale_d = 0 on the slice's first product), which the tensor-core
//    warps wait for and add into the block's partial support in fp32,
//    round to nearest; the split buffer is released after the add.  Its
//    cost (a wait a slice, two of them at 128 columns) and what it buys
//    against fp64 are measured in PERF.md (PR 23).
//  * Operands are split once, when a slice is staged, not in every
//    fragment load: two warpgroups of staging warps split each raw slice
//    (x: 128 x 16, w: 16 x BN) into hi and lo (split_tf32: hi rounded as
//    cvt.rna rounds, with two integer operations), and write them as the
//    K-major tiles wgmma reads (8 x 16-byte core matrices, no swizzle; w
//    transposed on the way) into one of two split buffers.  The staging
//    warps set the pace (the split is most of their work), hence two
//    warpgroups of them: wgmma keeps no fragments in registers, so 128
//    registers a thread suffice for 512 threads.
//  * The raw slices arrive by TMA tensor copies (two a slice, issued by
//    one staging thread, zero filled past the edges) into a ring of four
//    stages, three slices in flight; where a row is not 16-byte aligned or
//    sized (Ni or Nj not a multiple of 4, or 8 for bf16), by cp.async
//    (16-byte pieces where the rows allow, 4-byte ones otherwise, plain
//    loads for a bf16 weight with odd widths).  Named barriers pass the
//    split buffers between the roles.
//  * Gathered layouts: a block reads its table row once, at the start,
//    into a shared vector holding the unit of each of its contraction
//    indices; the slice count comes from K, not Ni.  TMA cannot gather
//    columns, so x's gathered columns (runs of Mi contiguous floats, one a
//    live pre-HC) come by cp.async in pieces of 16, 8 or 4 bytes (Mi a
//    multiple of 4, of 2 as at Model 1-struct, or odd).  Compact w comes
//    by TMA, one 3-D box (BN x 16 x 1) of the (Hj, K, Mj) array a slice,
//    zero filled past K.  Patchy w comes by cp.async, each gathered row
//    of the dense-resident array in 16-byte pieces, a row a warp
//    instruction: TMA boxes are issued one at a time, and 16 a slice (one
//    a gathered row) keep the issuing thread longer than those pieces
//    keep the staging warps.  Rows that are not 16-byte sized or aligned
//    take 4-byte pieces or plain loads, as in the dense layout.
//    Contraction indices past K are zeros in both operands (DESIGN.md
//    §7): x is zero filled, w masked when it is split.
//
// Variants of this body timed on the H100 at Model 1's hidden layer were
// slower: four staging warps in place of eight, cp.async in place of TMA
// for 16-byte-aligned rows, the split through cvt.rna.tf32.f32, and the
// promotion through 32-column accumulators (four waits a slice at 128).

constexpr int kTcRows = 128;      // batch rows per block (BM)
constexpr int kTcK = 16;          // contraction slice per stage
constexpr int kTcRaw = 4;         // raw stages: three slices in flight
constexpr int kTcMmaWarps = 8;    // two warpgroups of tensor-core warps (first)
constexpr int kTcStageWarps = 8;  // two warpgroups of staging warps
constexpr int kTcMma = kTcMmaWarps * kWarp;
constexpr int kTcStage = kTcStageWarps * kWarp;
constexpr int kTcThreads = kTcMma + kTcStage;
constexpr int kTcMaxCluster = 8;
// Named barriers (0 is __syncthreads): a split buffer is full (1, 2) or
// empty (3, 4); the staging warps' own (5).
constexpr int kBarFull = 1, kBarEmpty = 3, kBarStage = 5;

// One block's tile: 128 rows x BN columns, weight layout L; its
// shared-memory map in 4-byte words.  Core matrix (wgmma, K-major, no
// swizzle): 8 rows x 4 tf32 words, 128 contiguous bytes; the two core
// matrices of a row group along k8 are 128 bytes apart (leading byte
// offset), row groups 256.
template <int BN, typename T, int L>
struct FwdTile {
  using Elem = T;
  static constexpr int kBN = BN;
  static constexpr int kLayout = L;
  static constexpr bool kSplitW = std::is_same<T, float>::value;  // bf16: w_lo = 0
  static constexpr int kRawX = kTcRows * kTcK;                      // [128][16] fp32
  static constexpr int kRawW = kTcK * BN * (int)sizeof(T) / 4;      // [16][BN] T
  static constexpr int kRawStage = (kRawX + kRawW + 31) / 32 * 32;  // 128-byte aligned
  static constexpr int kA8 = kTcRows * 8;  // one k8 step of x, hi or lo
  static constexpr int kB8 = BN * 8;       // one k8 step of w, hi or lo
  // split buffer: x hi, x lo, w hi(, w lo), each [K/8][rows / 8][2][8][4]
  static constexpr int kSplit = (kTcK / 8) * (2 * kA8 + (kSplitW ? 2 : 1) * kB8);
  static constexpr int kLdP = BN + 8;  // partial support rows: conflict-free float2 stores
  static constexpr int kPipe = kTcRaw * kRawStage + 2 * kSplit;
  static constexpr int kWords =
      kPipe > kTcRows * kLdP ? kPipe : kTcRows * kLdP;  // then FwdSmem's regions
  static_assert(kRawStage % 32 == 0 && kSplit % 32 == 0, "128-byte aligned regions");
};

// Word offsets of the regions past the pipeline: the support rows a rank
// normalises (only when the HC takes more than one column chunk), the
// mbarriers, the units of the rank's contraction indices (gathered) and
// the HC's bias in fp32 (one column chunk).
struct FwdSmem {
  int sup, bars, ku, bias, words;
  template <class F>
  __host__ __device__ static FwdSmem of(int ks, int Mj, int total) {
    FwdSmem m;
    m.sup = F::kWords;
    const int sup_words = Mj > F::kBN ? (kTcRows + ks - 1) / ks * Mj : 0;
    m.bars = m.sup + ((sup_words + 1) & ~1);
    m.ku = m.bars + 2 * kTcRaw;
    m.bias = m.ku + (F::kLayout == kDense ? 0 : (total + ks - 1) / ks * kTcK);
    m.words = m.bias + F::kBN;
    return m;
  }
};

// d (64 x N, this thread's N/2 fp32) += A (64 x 8) B (8 x N), both tf32 in
// shared memory, issued by one warpgroup; scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// fn(e) for e = st, st + kTcStage, ... below N: the staging warps' share
// of N pieces, unrolled (compile-time trip count and divisors).
template <int N, class Fn>
__device__ __forceinline__ void staged_share(int st, Fn&& fn) {
#pragma unroll
  for (int i = 0; i < (N + kTcStage - 1) / kTcStage; ++i) {
    const int e = st + i * kTcStage;
    if (N % kTcStage == 0 || e < N) fn(e);
  }
}

__device__ __forceinline__ void split4(const float* v, uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(v[q], h[q], l[q]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// Word offset of (row r, k) of a K-major k8 tile.
__device__ __forceinline__ int kmajor(int r, int k) {
  return (r >> 3) * 64 + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
}

template <class F>
__global__ void __launch_bounds__(kTcThreads, 1)
bcpnn_fwd_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw, const float* __restrict__ x,
                    const typename F::Elem* __restrict__ w,
                    const typename F::Elem* __restrict__ bias, const int* __restrict__ table,
                    float* __restrict__ out, int B, int Ni, int Kc, int Nj, int Mj, int Mi,
                    int nact, int ks, int xcopy, int wcopy, float gain) {
  using T = typename F::Elem;
  constexpr int L = F::kLayout;
  constexpr int BM = kTcRows, BK = kTcK, BN = F::kBN, NA = BN / 2;
  constexpr bool kGather = L != kDense;
  extern __shared__ __align__(1024) float fsm[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * BM;
  const int hc = blockIdx.z;  // the post-HC
  const int col0 = hc * Mj;   // its first unit
  // rows [r0, r0 + nrows) of the tile: the ones this rank sums and normalises
  const int r0 = rank * BM / ks, nrows = (rank + 1) * BM / ks - r0;
  // this rank's slices of the Kc-deep contraction (Ni dense, K gathered)
  const int total = (Kc + BK - 1) / BK;
  const int s0 = rank * total / ks, slices = (rank + 1) * total / ks - s0;
  const int kbeg = s0 * BK, kend = min(Kc, (s0 + slices) * BK);
  const FwdSmem lay = FwdSmem::of<F>(ks, Mj, total);
  float* part = fsm;           // [BM][kLdP] partial support (after the slices)
  float* sup = fsm + lay.sup;  // [nrows][Mj] support rows (several column chunks)
  uint64_t* bars = reinterpret_cast<uint64_t*>(fsm + lay.bars);
  int* ku = reinterpret_cast<int*>(fsm + lay.ku);  // gathered: unit of index kbeg + i
  float* sbias = fsm + lay.bias;                   // one column chunk: the bias in fp32
  auto raw = [&](int u) { return fsm + (u % kTcRaw) * F::kRawStage; };
  auto split = [&](int b) { return fsm + kTcRaw * F::kRawStage + (b & 1) * F::kSplit; };
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const bool mma_warp = warp < kTcMmaWarps;
  const bool xtma = xcopy == kCopyTma, wtma = wcopy == kCopyTma;
  const bool copies = !(xtma && wtma);  // some operand goes by cp.async
  const bool one_chunk = Mj <= BN;
  // a cluster of one block needs only the block's own barrier
  auto cluster_sync = [&] {
    if (ks > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  if (threadIdx.x == kTcMma) {
    for (int q = 0; q < kTcRaw; ++q) mbar_init(bars + q);
    if (xtma) asm volatile("prefetch.tensormap [%0];" ::"l"(&tmx) : "memory");
    if (wtma) asm volatile("prefetch.tensormap [%0];" ::"l"(&tmw) : "memory");
  }
  if constexpr (kGather) {  // the table row, read once
    for (int i = threadIdx.x; i < kend - kbeg; i += kTcThreads) {
      ku[i] = unit_of<L>(table, hc, kbeg + i, Mi, nact);
    }
  }
  __syncthreads();

  int done = 0;  // slices staged before this column chunk (raw stages, mbarrier phases)
  // The TMA copies of slice s of the chunk at c0 into raw stage (done + s) %
  // kTcRaw, issued by the first staging thread: dense, x's (16 x 128) and
  // w's (BN x 16) boxes; compact, w's (BN x 16 x 1) box.
  auto fetch = [&](int c0, int s) {
    const int u = done + s;
    float* rx = raw(u);
    T* rw = reinterpret_cast<T*>(rx + F::kRawX);
    uint64_t* bar = bars + u % kTcRaw;
    const int k0 = (s0 + s) * BK;
    if constexpr (L == kDense) {
      mbar_expect(bar, (uint32_t)(4 * BM * BK + sizeof(T) * BK * BN));
      tma_2d(rx, &tmx, k0, row0, bar);
      tma_2d(rw, &tmw, col0 + c0, k0, bar);
    } else if constexpr (L == kCompact) {
      mbar_expect(bar, (uint32_t)(sizeof(T) * BK * BN));
      tma_3d(rw, &tmw, c0, k0, hc, bar);
    }
  };

  // A slice's products go to a fresh tensor-core accumulator of CN columns
  // (one or two a tile), which is then added into acc in fp32 (the
  // promotion, above).
  constexpr int CN = BN < 64 ? BN : 64, NAC = CN / 2;
  for (int c0 = 0; c0 < Mj; c0 += BN, done += slices) {
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    if (mma_warp) {
      // ---- tensor-core warpgroups: 3xTF32 wgmma on split buffer s % 2 ---
      const int wg = warp / 4;  // rows 64 wg .. 64 wg + 63
      if (c0 == 0 && one_chunk) {  // the bias, while the first slice arrives
        for (int c = threadIdx.x; c < Mj; c += kTcMma) sbias[c] = to_f32(bias[col0 + c]);
      }
      float sl[NAC];  // a slice's products on columns cn CN .. cn CN + CN - 1
#pragma unroll
      for (int i = 0; i < NAC; ++i) sl[i] = 0.f;
      for (int s = 0; s < slices; ++s) {
        barrier_sync(kBarFull + (s & 1), kTcThreads);
        const float* sx = split(s);
#pragma unroll
        for (int cn = 0; cn < BN / CN; ++cn) {
          wgmma_fence();
          fence_operands<NAC>(sl);
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            const float* xh = sx + kk * 2 * F::kA8 + wg * 64 * 8;
            // columns cn CN on: CN / 8 row groups of 64 words in
            const float* wh = sx + (BK / 8) * 2 * F::kA8 +
                              kk * (F::kSplitW ? 2 : 1) * F::kB8 + cn * CN * 8;
            const uint64_t dxh = wgmma_desc(xh), dxl = wgmma_desc(xh + F::kA8);
            const uint64_t dwh = wgmma_desc(wh);
            wgmma_tf32<CN>(sl, dxl, dwh, kk > 0);  // the slice's first product overwrites
            if constexpr (F::kSplitW) wgmma_tf32<CN>(sl, dxh, wgmma_desc(wh + F::kB8), 1);
            wgmma_tf32<CN>(sl, dxh, dwh, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands<NAC>(sl);
#pragma unroll
          for (int i = 0; i < NAC; ++i) acc[cn * NAC + i] += sl[i];
        }
        // slice s's products are done: its split buffer is free
        barrier_arrive(kBarEmpty + (s & 1), kTcThreads);
      }
    } else {
      // ---- staging warpgroups: copy, split, lay out K-major --------------
      const int st = threadIdx.x - kTcMma;
      // the staging warps' cp.async copies of slice s into raw stage
      // (done + s) % kTcRaw (the operands that do not come by TMA)
      auto stage = [&](int s) {
        float* rx = raw(done + s);
        T* rw = reinterpret_cast<T*>(rx + F::kRawX);
        const int k0 = (s0 + s) * BK;
        // x in pieces of P floats into [128][16]; gathered, a piece lies in
        // one pre-HC's run of Mi units (P divides Mi), read at the unit of
        // its first k
        auto stage_x = [&](auto per) {
          constexpr int P = decltype(per)::value;
          staged_share<BM * BK / P>(st, [&](int e) {
            const int r = e / (BK / P), c = (e % (BK / P)) * P;
            const bool v = row0 + r < B && k0 + c < kend;
            const float* src = x;
            if (v) src = x + (size_t)(row0 + r) * Ni + (kGather ? ku[s * BK + c] : k0 + c);
            if constexpr (P == 4) {
              cp_async16(rx + r * BK + c, src, v);
            } else if constexpr (P == 2) {
              cp_async8(rx + r * BK + c, src, v);
            } else {
              cp_async4(rx + r * BK + c, src, v);
            }
          });
        };
        if (xcopy == kCopy16) {
          stage_x(std::integral_constant<int, 4>{});
        } else if (kGather && xcopy == kCopy8) {
          stage_x(std::integral_constant<int, 2>{});
        } else if (xcopy == kCopy4) {
          stage_x(std::integral_constant<int, 1>{});
        }
        // row k of the slice's w, at column c0 of the post-HC
        auto wrow = [&](int k) -> const T* {
          if constexpr (L == kDense) return w + (size_t)k * Nj + col0 + c0;
          if constexpr (L == kPatchy) return w + (size_t)ku[k - kbeg] * Nj + col0 + c0;
          return w + ((size_t)hc * Kc + k) * Mj + c0;
        };
        // PER elements a piece: 16 or 4 bytes by cp.async, or one by a load
        auto stage_w = [&](auto mode) {
          constexpr int M = decltype(mode)::value;
          constexpr int PER = M == kCopy16 ? 16 / (int)sizeof(T) : M == kCopy4 ? 4 / (int)sizeof(T) : 1;
          staged_share<BK * BN / PER>(st, [&](int e) {
            const int kk = e / (BN / PER), c = (e % (BN / PER)) * PER;
            const bool v = k0 + kk < kend && c0 + c < Mj;
            if constexpr (M == kCopyElem) {
              rw[kk * BN + c] = v ? wrow(k0 + kk)[c] : T(0.f);
            } else if constexpr (M == kCopy16) {
              cp_async16(rw + kk * BN + c, v ? wrow(k0 + kk) + c : w, v);
            } else {
              cp_async4(rw + kk * BN + c, v ? wrow(k0 + kk) + c : w, v);
            }
          });
        };
        if (wcopy == kCopy16) {
          stage_w(std::integral_constant<int, kCopy16>{});
        } else if (wcopy == kCopy4) {
          stage_w(std::integral_constant<int, kCopy4>{});
        } else if (wcopy == kCopyElem) {
          stage_w(std::integral_constant<int, kCopyElem>{});
        }
        cp_async_commit();
      };
      const bool producer = st == 0 && (xtma || wtma);
      for (int q = 0; q < kTcRaw - 1 && q < slices; ++q) {
        if (producer) fetch(c0, q);
        if (copies) stage(q);
      }
      for (int s = 0; s < slices; ++s) {
        if (copies) {
          const int ahead = min(kTcRaw - 2, slices - 1 - s);  // later slices in flight
          if (ahead >= 2) {
            cp_async_wait<2>();
          } else if (ahead == 1) {
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
        }
        if (xtma || wtma) {
          const int u = done + s;
          mbar_wait(bars + u % kTcRaw, (u / kTcRaw) & 1);
        }
        // everyone's copies of slice s are in, and everyone is done
        // splitting s - 1: its stage takes slice s + kTcRaw - 1
        barrier_sync(kBarStage, kTcStage);
        if (s + kTcRaw - 1 < slices) {
          if (copies) stage(s + kTcRaw - 1);
          if (producer) fetch(c0, s + kTcRaw - 1);
        }
        if (s >= 2) barrier_sync(kBarEmpty + (s & 1), kTcThreads);
        const float* rx = raw(done + s);
        const T* rw = reinterpret_cast<const T*>(rx + F::kRawX);
        const int k0 = (s0 + s) * BK;
        float* sx = split(s);
        float* sw = sx + (BK / 8) * 2 * F::kA8;
        // x: four k values of a row a piece (one 16-byte read), eight rows
        // of a core matrix on eight neighbouring lanes (one 128-byte store)
        staged_share<BM * BK / 4>(st, [&](int e) {
          const int r = (e >> 5) * 8 + (e & 7), c4 = (e >> 3) & 3;
          const float4 v4 = *reinterpret_cast<const float4*>(rx + r * BK + c4 * 4);
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
          uint4 hi, lo;
          split4(v, hi, lo);
          float* d = sx + (c4 >> 1) * 2 * F::kA8 + kmajor(r, (c4 & 1) * 4);
          *reinterpret_cast<uint4*>(d) = hi;
          *reinterpret_cast<uint4*>(d + F::kA8) = lo;
        });
        // w transposed: four k values of a column a piece, neighbouring
        // lanes on neighbouring columns (gathered: zeros past kend, whatever
        // the raw stage holds there)
        staged_share<BK / 4 * BN>(st, [&](int e) {
          const int n = e % BN, c4 = e / BN;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            v[q] = to_f32(rw[(c4 * 4 + q) * BN + n]);
            if constexpr (kGather) {
              if (k0 + c4 * 4 + q >= kend) v[q] = 0.f;
            }
          }
          float* d = sw + (c4 >> 1) * (F::kSplitW ? 2 : 1) * F::kB8 + kmajor(n, (c4 & 1) * 4);
          if constexpr (F::kSplitW) {
            uint4 hi, lo;
            split4(v, hi, lo);
            *reinterpret_cast<uint4*>(d) = hi;
            *reinterpret_cast<uint4*>(d + F::kB8) = lo;
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
          }
        });
        // the split tiles are read by the tensor cores and the raw stage is
        // refilled by TMA (both the async proxy)
        fence_proxy_async();
        barrier_arrive(kBarFull + (s & 1), kTcThreads);
      }
      // the tensor-core warps' last releases of the split buffers
      for (int s = max(0, slices - 2); s < slices; ++s) {
        barrier_sync(kBarEmpty + (s & 1), kTcThreads);
      }
    }
    __syncthreads();  // every split buffer and raw stage is free
    if (mma_warp) {
      // the partial support: acc[4 n8 + 2h + e] is row 16 (warp % 4) + g + 8h,
      // column 8 n8 + 2t + e of the warpgroup's 64 rows
      const int rb = (warp / 4) * 64 + (warp % 4) * 16 + g;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(part + (rb + 8 * h) * F::kLdP + n8 * 8 + 2 * t) =
              make_float2(acc[4 * n8 + 2 * h], acc[4 * n8 + 2 * h + 1]);
        }
    }
    cluster_sync();  // every rank's partials are in
    if (one_chunk) break;  // the fused epilogue below
    // ---- several column chunks: the cluster's sum, bias and gain into this
    // rank's support rows, normalised once every chunk is in ---------------
    const int cols = min(BN, Mj - c0);
    for (int e = threadIdx.x; e < nrows * (BN / 4); e += kTcThreads) {
      const int lr = e / (BN / 4), c = (e % (BN / 4)) * 4;
      if (row0 + r0 + lr >= B || c >= cols) continue;
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < ks; ++q) {  // in rank order
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part + (r0 + lr) * F::kLdP + c, q));
        sum[0] += p.x; sum[1] += p.y; sum[2] += p.z; sum[3] += p.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c + i < cols) {
          sup[lr * Mj + c0 + c + i] = (sum[i] + to_f32(bias[col0 + c0 + c + i])) * gain;
        }
      }
    }
    fence_proxy_async();  // the partials' region takes TMA copies again
    cluster_sync();       // no rank overwrites or leaves its partials before this
  }
  if (!one_chunk) {
    softmax_rows_to(sup, nrows, Mj, out, row0 + r0, B, Nj, col0);
    return;
  }
  // ---- one column chunk: the cluster's sum, bias, gain and the softmax in
  // registers.  G threads a row, CPT columns each, interleaved (column
  // 4 (gi + G f) + e), so that the row's threads read and write whole runs
  // of 4G floats.  Every thread reads its partials from the ranks in
  // rank order, then arrives at the cluster barrier (its reads of the other
  // ranks are done) and waits on it only before it exits, so the softmax
  // and the stores run under the barrier.
  constexpr int G = BN / 4 < 8 ? BN / 4 : 8, CPT = BN / G, kRowsPer = kTcThreads / G;
  const int gi = threadIdx.x % G;
  const bool vec = Mj % 4 == 0;
  const int rounds = (nrows + kRowsPer - 1) / kRowsPer;
  for (int round = 0; round < rounds; ++round) {
    const int lr = round * kRowsPer + threadIdx.x / G;
    const bool live = lr < nrows && row0 + r0 + lr < B;
    float v[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) v[i] = 0.f;
    if (live) {
      for (int q = 0; q < ks; ++q) {  // in rank order
        const float* p = cluster.map_shared_rank(part + (r0 + lr) * F::kLdP + 4 * gi, q);
#pragma unroll
        for (int f = 0; f < CPT / 4; ++f) {
          const float4 p4 = *reinterpret_cast<const float4*>(p + 4 * G * f);
          v[4 * f] += p4.x; v[4 * f + 1] += p4.y; v[4 * f + 2] += p4.z; v[4 * f + 3] += p4.w;
        }
      }
    }
    if (ks > 1 && round + 1 == rounds) {
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    }
    // softmax over the row's Mj columns, across the G threads of the row
    // (fmaxf passes over a NaN; exp of it then makes the row NaN, as in the
    // plain version)
    float mx = -INFINITY;
    if (live) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int cc = 4 * (gi + G * (i / 4)) + i % 4;
        v[i] = (v[i] + sbias[cc < Mj ? cc : 0]) * gain;
        if (cc < Mj) mx = fmaxf(mx, v[i]);
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float sum = 0.f;
    if (live) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        v[i] = 4 * (gi + G * (i / 4)) + i % 4 < Mj ? expf(v[i] - mx) : 0.f;
        sum += v[i];
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    if (live) {
      const float inv = 1.f / sum;
      float* orow = out + (size_t)(row0 + r0 + lr) * Nj + col0;
#pragma unroll
      for (int f = 0; f < CPT / 4; ++f) {
        const int cf = 4 * (gi + G * f);
        if (vec && cf + 3 < Mj) {
          *reinterpret_cast<float4*>(orow + cf) = make_float4(
              v[4 * f] * inv, v[4 * f + 1] * inv, v[4 * f + 2] * inv, v[4 * f + 3] * inv);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (cf + e < Mj) orow[cf + e] = v[4 * f + e] * inv;
          }
        }
      }
    }
  }
  if (ks > 1) {
    if (rounds == 0) asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}

// Shared bytes of a block (FwdSmem).
template <class F>
size_t fwd_smem(int ks, int Mj, int total) {
  return sizeof(float) * (size_t)FwdSmem::of<F>(ks, Mj, total).words;
}

// The cluster sizes a forward of this shape may take, [*lo, *hi]: from the
// smallest whose shared memory fits up to kTcMaxCluster, and no more than
// the contraction's slices unless the smallest is.  Sets the kernel's
// shared-memory limit to the smallest's bytes, the most any of them takes.
// Kc: the contraction's depth (Ni dense, K = nact*Mi gathered).
template <class F>
cudaError_t fwd_clusters(int Kc, int Mj, int* lo, int* hi) {
  const int total = (Kc + kTcK - 1) / kTcK;
  int ks_min = 1;
  while (ks_min < kTcMaxCluster && fwd_smem<F>(ks_min, Mj, total) > (size_t)kMaxSmem) ++ks_min;
  if (fwd_smem<F>(ks_min, Mj, total) > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  *lo = ks_min;
  *hi = std::max(ks_min, std::min(kTcMaxCluster, total));
  return cudaFuncSetAttribute(bcpnn_fwd_tc_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)fwd_smem<F>(ks_min, Mj, total));
}

// The cluster size with the least time among fwd_clusters': a block's
// share of the work is 1/ks, and the clusters run in ceil(clusters /
// co-resident clusters) waves.  The co-resident counts are kept per
// (device, cluster size, shared bytes), under a lock.
template <class F>
cudaError_t fwd_cluster_size(int B, int Kc, int Hj, int Mj, cudaStream_t stream, int* ks_out) {
  const int total = (Kc + kTcK - 1) / kTcK;
  int lo = 0, hi = 0;
  cudaError_t err = fwd_clusters<F>(Kc, Mj, &lo, &hi);
  if (err != cudaSuccess) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const int tiles = (B + kTcRows - 1) / kTcRows;
  static std::mutex lock;
  static std::map<std::tuple<int, int, size_t>, int> seen;  // -> co-resident clusters
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kTcThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int ks = lo;
  double best = 0.0;
  for (int k = lo; k <= hi; ++k) {
    const auto key = std::make_tuple(device, k, fwd_smem<F>(k, Mj, total));
    int n = 0;
    {
      const std::lock_guard<std::mutex> hold(lock);
      const auto it = seen.find(key);
      if (it != seen.end()) {
        n = it->second;
      } else {
        cfg.gridDim = dim3(k, tiles, Hj);
        cfg.dynamicSmemBytes = std::get<2>(key);
        attr[0].val.clusterDim.x = k;
        err = cudaOccupancyMaxActiveClusters(&n, (void*)bcpnn_fwd_tc_kernel<F>, &cfg);
        if (err != cudaSuccess) return err;
        seen[key] = n;
      }
    }
    if (n <= 0) continue;
    const long long clusters = (long long)tiles * Hj;
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

// The operands' geometry: x (B, Ni); w (Ni, Hj*Mj), or compact (Hj, K, Mj);
// table (Hj, nact) of the gathered layouts; Kc = Ni dense, K = nact*Mi
// gathered.
struct FwdShape {
  int B, Ni, Kc, Hj, Mj, Mi, nact;
};

template <class F>
cudaError_t launch_fwd_tc(const float* x, const typename F::Elem* w,
                          const typename F::Elem* bias, const int* table, float* out,
                          const FwdShape& sh, int xcopy, int wcopy, int cluster, float gain,
                          cudaStream_t stream) {
  using T = typename F::Elem;
  constexpr int L = F::kLayout;
  const CUtensorMapDataType wtype =
      F::kSplitW ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long Nj = (long long)sh.Hj * sh.Mj;
  CUtensorMap tmx = {}, tmw = {};
  bool ok = true;
  if (xcopy == kCopyTma) {  // dense only
    const long long dims[2] = {sh.Ni, sh.B};
    const int box[2] = {kTcK, kTcRows};
    ok = tensor_map(&tmx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, dims, box);
  }
  if (ok && wcopy == kCopyTma) {
    if constexpr (L == kCompact) {
      const long long dims[3] = {sh.Mj, sh.Kc, sh.Hj};
      const int box[3] = {F::kBN, kTcK, 1};
      ok = tensor_map(&tmw, w, wtype, (int)sizeof(T), 3, dims, box);
    } else {
      const long long dims[2] = {Nj, sh.Ni};
      const int box[2] = {F::kBN, kTcK};
      ok = tensor_map(&tmw, w, wtype, (int)sizeof(T), 2, dims, box);
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  // cluster > 0: that size, if fwd_clusters allows it (never clamped);
  // 0: the search's.
  int ks = cluster;
  cudaError_t err = cudaSuccess;
  if (cluster == 0) {
    err = fwd_cluster_size<F>(sh.B, sh.Kc, sh.Hj, sh.Mj, stream, &ks);
  } else {
    int lo = 0, hi = 0;
    err = fwd_clusters<F>(sh.Kc, sh.Mj, &lo, &hi);
    if (err == cudaSuccess && (cluster < lo || cluster > hi)) err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks, (sh.B + kTcRows - 1) / kTcRows, sh.Hj);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = fwd_smem<F>(ks, sh.Mj, (sh.Kc + kTcK - 1) / kTcK);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ks > 1 ? 1 : 0;  // a grid without clusters has clusters of one block
  err = cudaLaunchKernelEx(&cfg, bcpnn_fwd_tc_kernel<F>, tmx, tmw, x, w, bias, table, out,
                           sh.B, sh.Ni, sh.Kc, (int)Nj, sh.Mj, sh.Mi, sh.nact, ks, xcopy, wcopy,
                           gain);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// fn(tile) with the tile for the HC width: 16, 32, 64 or 128 columns.
template <typename T, int L, class Fn>
cudaError_t with_fwd_tile(int Mj, Fn&& fn) {
  if (Mj <= 16) return fn(FwdTile<16, T, L>{});
  if (Mj <= 32) return fn(FwdTile<32, T, L>{});
  if (Mj <= 64) return fn(FwdTile<64, T, L>{});
  return fn(FwdTile<128, T, L>{});
}

// Picks the tile from the HC width and the copy paths from the operands.
// Dense: TMA for both where both operands' rows and the HC's first column
// are 16-byte aligned and sized (a TMA box that starts off a 16-byte
// boundary faults).  Gathered: x by cp.async in the widest piece that divides Mi and
// the alignment allows; compact w by TMA where its rows are 16-byte aligned
// and sized.  Elsewhere w by cp.async in 16- or 4-byte pieces, or plain
// loads (a bf16 weight of odd width).
template <typename T, int L>
cudaError_t launch_fwd_tc_any(const float* x, const T* w, const T* bias, const int* table,
                              float* out, const FwdShape& sh, int cluster, float gain,
                              cudaStream_t st) {
  const long long Nj = (long long)sh.Hj * sh.Mj;
  constexpr int kPer16 = 16 / (int)sizeof(T), kPer4 = 4 / (int)sizeof(T);
  const bool w16 = Nj % kPer16 == 0 && sh.Mj % kPer16 == 0 && aligned16(w);
  return with_fwd_tile<T, L>(sh.Mj, [&](auto tile) {
    using F = decltype(tile);
    int wcopy = kCopyElem, xcopy;
    if (w16) {
      wcopy = kCopy16;
    } else if (Nj % kPer4 == 0 && sh.Mj % kPer4 == 0 && ((uintptr_t)w & 3u) == 0) {
      wcopy = kCopy4;
    }
    if constexpr (L == kDense) {
      const bool x16 = sh.Ni % 4 == 0 && aligned16(x);
      if (x16 && w16) {  // (a box's first column, h * Mj, 16-byte aligned)
        xcopy = wcopy = kCopyTma;
      } else {
        xcopy = x16 ? kCopy16 : kCopy4;
      }
    } else {
      if (sh.Mi % 4 == 0 && aligned16(x)) {
        xcopy = kCopy16;
      } else {
        xcopy = sh.Mi % 2 == 0 && ((uintptr_t)x & 7u) == 0 ? kCopy8 : kCopy4;
      }
      if (L == kCompact && w16) wcopy = kCopyTma;
    }
    return launch_fwd_tc<F>(x, w, bias, table, out, sh, xcopy, wcopy, cluster, gain, st);
  });
}

// The weight element type: fp32, or the bf16 of a serving pack.
// ``cluster``: the cluster size to launch, 0 for the search's.
template <int L>
cudaError_t launch_fwd_typed(const float* x, const void* w, const void* bias, const int* table,
                             float* out, const FwdShape& sh, int bf16, int cluster, float gain,
                             cudaStream_t st) {
  if (bf16) {
    return launch_fwd_tc_any<__nv_bfloat16, L>(x, (const __nv_bfloat16*)w,
                                               (const __nv_bfloat16*)bias, table, out, sh,
                                               cluster, gain, st);
  }
  return launch_fwd_tc_any<float, L>(x, (const float*)w, (const float*)bias, table, out, sh,
                                     cluster, gain, st);
}

}  // namespace

extern "C" {

const char* bcpnn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int bcpnn_hc_softmax(const float* s, float* out, long long segments, int m, float gain,
                     void* stream) {
  if (segments <= 0 || m <= 0) return (int)cudaSuccess;
  const SoftmaxPlan p = softmax_plan(s, out, m);
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.v == 4) return (int)launch_softmax_v<4>(p, s, out, segments, m, gain, st);
  if (p.v == 2) return (int)launch_softmax_v<2>(p, s, out, segments, m, gain, st);
  return (int)launch_softmax_v<1>(p, s, out, segments, m, gain, st);
}

// How bcpnn_hc_softmax takes segments of m values between these pointers:
// plan = {values a load, lanes a segment, loads a lane (0: the three-pass
// loop)}.  Launches nothing (phase 1 of chip_smoke.py prints it).
int bcpnn_hc_softmax_plan(const float* s, const float* out, int m, int* plan) {
  const SoftmaxPlan p = softmax_plan(s, out, m);
  plan[0] = p.v;
  plan[1] = p.lanes;
  plan[2] = p.iters;
  return (int)cudaSuccess;
}

// ``bf16``: w and bias are __nv_bfloat16 (a bf16 serving pack), else float.
// The cluster sizes of the forward of ``layout`` (Layout: 0 dense, 1
// patchy, 2 compact) for this shape on the current device: ks = {the one
// the search takes (phase 1 of chip_smoke.py prints it), the least and the
// most a caller may name}; Kc is the contraction's depth (Ni dense, K =
// nact*Mi gathered).  Launches nothing.
int bcpnn_fwd_cluster(int B, int Kc, int Hj, int Mj, int layout, int bf16, int* ks) {
  auto pick = [&](auto tile) {
    const cudaError_t err = fwd_clusters<decltype(tile)>(Kc, Mj, ks + 1, ks + 2);
    if (err != cudaSuccess) return err;
    return fwd_cluster_size<decltype(tile)>(B, Kc, Hj, Mj, nullptr, ks);
  };
  auto typed = [&](auto layout_c) {
    constexpr int L = decltype(layout_c)::value;
    return bf16 ? with_fwd_tile<__nv_bfloat16, L>(Mj, pick) : with_fwd_tile<float, L>(Mj, pick);
  };
  if (layout == kPatchy) return (int)typed(std::integral_constant<int, kPatchy>{});
  if (layout == kCompact) return (int)typed(std::integral_constant<int, kCompact>{});
  return (int)typed(std::integral_constant<int, kDense>{});
}

// ``cluster``: the thread-block cluster size to launch, within
// bcpnn_fwd_cluster's least and most (else cudaErrorInvalidValue, never
// clamped); 0 for the search's.
int bcpnn_fwd(const float* x, const void* w, const void* bias, float* out, int B, int Ni,
              int Hj, int Mj, int bf16, int cluster, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const FwdShape sh = {B, Ni, Ni, Hj, Mj, 1, 0};
  return (int)launch_fwd_typed<kDense>(x, w, bias, nullptr, out, sh, bf16, cluster, gain,
                                       (cudaStream_t)stream);
}

// x (B, Ni); w (Ni, Hj*Mj) dense-resident, or (Hj, K, Mj) when ``compact``;
// table (Hj, nact) int32 with entries in [0, Ni/Mi); ``cluster`` as for
// bcpnn_fwd.
int bcpnn_patchy_fwd(const float* x, const void* w, const void* bias, const int* table,
                     float* out, int B, int Ni, int Hj, int Mj, int Mi, int nact, int compact,
                     int bf16, int cluster, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const FwdShape sh = {B, Ni, nact * Mi, Hj, Mj, Mi, nact};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(compact ? launch_fwd_typed<kCompact>(x, w, bias, table, out, sh, bf16, cluster,
                                                    gain, st)
                       : launch_fwd_typed<kPatchy>(x, w, bias, table, out, sh, bf16, cluster,
                                                   gain, st));
}

int bcpnn_update(const float* pij, const float* log_pi, const float* log_pj, const float* x,
                 const float* y, const float* mask, const float* a, const float* count,
                 float* pij_out, float* w_out, int B, int Ni, int Nj, int Hi, int Hj,
                 float eps2, void* stream) {
  if (Ni <= 0 || Nj <= 0 || B <= 0) return (int)cudaSuccess;
  return (int)launch_trace_any<kDense>(pij, log_pi, log_pj, x, y, mask, nullptr, a, count,
                                       pij_out, w_out, B, Ni, Nj, Ni / Hi, Nj / Hj, Hj, 0, eps2,
                                       (cudaStream_t)stream);
}

// Patchy: pij, pij_out, w_out (Ni, Hj*Mj), every entry written once (live
// ones updated, silent ones held with w 0).  Compact: (Hj, K, Mj).
int bcpnn_patchy_update(const float* pij, const float* log_pi, const float* log_pj,
                        const float* x, const float* y, const int* table, const float* a,
                        const float* count, float* pij_out, float* w_out, int B, int Ni, int Hj,
                        int Mj, int Mi, int nact, int compact, float eps2, void* stream) {
  const int K = nact * Mi;
  if (K <= 0 || Hj <= 0 || Mj <= 0 || B <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(compact ? launch_trace_any<kCompact>(pij, log_pi, log_pj, x, y, nullptr, table, a,
                                                    count, pij_out, w_out, B, Ni, Hj * Mj, Mi, Mj,
                                                    Hj, nact, eps2, st)
                       : launch_trace_any<kPatchy>(pij, log_pi, log_pj, x, y, nullptr, table, a,
                                                   count, pij_out, w_out, B, Ni, Hj * Mj, Mi, Mj,
                                                   Hj, nact, eps2, st));
}

}  // extern "C"
