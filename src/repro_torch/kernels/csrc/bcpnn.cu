// Hand-written Hopper (sm_90a) kernels for the BCPNN main path.
//
// Four kernel bodies for seven of the Pallas TPU kernels:
//
//   bcpnn_hc_softmax     <- repro/kernels/hc_softmax.py::hc_softmax_pallas
//   bcpnn_fwd            <- repro/kernels/bcpnn_fwd.py::bcpnn_fwd_pallas
//   bcpnn_patchy_fwd     <- repro/kernels/patchy.py::patchy_forward and
//                           ::compact_forward (the body of bcpnn_fwd)
//   bcpnn_update         <- repro/kernels/bcpnn_update.py::bcpnn_update_pallas
//                           (trace_update_kernel, dense layout)
//   bcpnn_patchy_update  <- repro/kernels/patchy.py::patchy_update
//                           (trace_update_kernel, patchy layout) and
//                           ::compact_update (compact_update_kernel)
//
// The forward body is templated on the weight layout (Layout below):
// dense (Ni, Nj); patchy, the same dense-resident arrays restricted per
// post-HC to the K = nact*Mi live pre-units named by the (Hj, nact) index
// table; compact, the resident (Hj, K, Mj) arrays.  The resident-trace
// update takes the dense and patchy layouts, compact_update_kernel the
// compact one.  The patchy layouts gather their live rows inside the tile
// loads, so the (Hj, B, K) gathered activations of the TPU kernels never
// exist.
//
// All arithmetic keeps fp32 accuracy and no fast-math intrinsics are used,
// because trace increments are ~1e-5 and the log-weight fold must stay
// within 1e-4 of the fp32 reference.  The forwards and the compact update
// run IEEE fp32 on the CUDA cores.  The resident-trace update runs its
// product on the tensor cores in 3xTF32 (each operand split into two TF32
// halves, three products summed in fp32), which keeps fp32 accuracy; a
// single TF32 pass (~1e-4 relative error) is never used.  Each kernel
// computes its own offsets and masks ragged edges itself (no pad plan).
// The forward body is also templated on its weight and bias element type:
// fp32, or the bf16 of a serving pack, widened to fp32 in the tile load
// (the TPU kernels cast their operands to f32 in-kernel the same way).
// The int8 forwards of a serving pack are in quant.cu.
//
// C interface: every entry point takes raw device pointers, sizes and the
// CUDA stream, launches on that stream without synchronising, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.  Built by repro_torch/kernels/_build.py, with
// quant.cu, into one library: each source compiled on its own with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// and the objects linked with the same flags and -shared.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace bcpnn;

// ------------------------------------------------------------ hc_softmax --
//
// out[r, h*M + m] = softmax_m(gain * s[r, h*M + m]) for every (row, HC)
// segment of a contiguous (B, H*M) array.  One warp per segment; segments
// of up to kSoftmaxVals*32 minicolumns stay in registers (one read, one
// write), longer ones take three passes over global memory.
//
// Bound: bytes.  At Model 1 (B=128, H=32, M=128) it reads and writes 2 MiB
// each, ~1.3 us at 3.35 TB/s, below the cost of a launch; the readout call
// (B=128, H=1, M=10) is launch-bound.

constexpr int kSoftmaxVals = 8;
constexpr int kSoftmaxWarps = 8;

__global__ void __launch_bounds__(kSoftmaxWarps * kWarp)
hc_softmax_kernel(const float* __restrict__ s, float* __restrict__ out,
                  long long segments, int m, float gain) {
  const long long seg = (long long)blockIdx.x * kSoftmaxWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (seg >= segments) return;  // warp-uniform
  const float* src = s + seg * m;
  float* dst = out + seg * m;
  if (m <= kSoftmaxVals * kWarp) {
    float v[kSoftmaxVals];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kSoftmaxVals; ++k) {
      const int c = lane + k * kWarp;
      v[k] = c < m ? src[c] * gain : -INFINITY;
      mx = fmaxf(mx, v[k]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kSoftmaxVals; ++k) {
      const int c = lane + k * kWarp;
      if (c < m) {
        v[k] = expf(v[k] - mx);
        sum += v[k];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int k = 0; k < kSoftmaxVals; ++k) {
      const int c = lane + k * kWarp;
      if (c < m) dst[c] = v[k] / sum;
    }
    return;
  }
  float mx = -INFINITY;
  for (int c = lane; c < m; c += kWarp) mx = fmaxf(mx, src[c] * gain);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < m; c += kWarp) sum += expf(src[c] * gain - mx);
  sum = warp_sum(sum);
  for (int c = lane; c < m; c += kWarp) dst[c] = expf(src[c] * gain - mx) / sum;
}

// ------------------------------------------------------------- bcpnn_fwd --
//
// rates[b, h*Mj + n] = softmax_n(gain * (bias + x @ w)[b, h*Mj + n]).
//
// Grid: one block per (batch tile of kFwdRows rows, post-HC), so the HC's
// softmax is block-local and the support never leaves the SM.  The
// contraction runs over K: all Ni pre-units when dense, the HC's K live
// ones (gathered row by row from x and from w in the tile loads) when
// patchy or compact.  The block
// walks the HC's Mj columns in chunks of 16*CPT.  For each chunk its
// kFwdGroups K-groups of 256 threads take every kFwdGroups-th kFwdK-deep
// slice of Ni, each staging its slice through its own shared-memory tiles
// (x transposed, w row-major) behind its own barrier and accumulating 2 rows x CPT columns per
// thread with fp32 FMA in registers; the tiles are read as float2/float4
// so one shared load feeds up to 8 FMAs.  Groups 1.. then park their
// partial sums in their w tiles, group 0 adds them in group order and
// writes (acc + bias) * gain into a (rows, Mj) shared buffer.  Once every
// chunk is in, each warp normalises whole rows with shuffles (max, exp,
// sum, divide) and writes them out coalesced.
//
// Bound: operations.  At Model 1 (B=128, Ni=1568, Nj=4096) the product is
// 1.64 GFLOP, ~24.5 us at 67 TFLOP/s fp32; its 28.6 MB of traffic take
// ~8.5 us.  Only 4 x 32 = 128 blocks exist at B=128, so the K-groups are
// what puts 32 warps on each SM.  Still simple: no wgmma (that would be
// TF32 or lower), no TMA, no pipelining across slices.  At Model 1-struct
// (nact = 128, K = 256) the patchy product is 268 MFLOP, ~4.0 us; its
// traffic is ~7.1 MB, ~2.1 us: operations again.

constexpr int kFwdRows = 32;           // batch rows per block
constexpr int kFwdK = 32;              // contraction slice per stage
constexpr int kFwdGroups = 4;          // K-groups per block
constexpr int kFwdGroupThreads = 256;  // 16 row pairs x 16 column groups
constexpr int kFwdThreads = kFwdGroups * kFwdGroupThreads;
constexpr int kFwdXS = kFwdRows + 2;   // x tile leading dim (even: float2 reads)

// Shared floats of one K-group's stage: the x tile, then the w tile.
template <int CPT>
__host__ __device__ constexpr int fwd_stage() { return kFwdK * kFwdXS + kFwdK * 16 * CPT; }

// V consecutive floats from 8- or 16-byte-aligned shared memory.
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

// Barrier of one K-group only (ids 1.. ; 0 is __syncthreads), so the
// groups drift apart and one group's loads overlap another's FMAs.
__device__ __forceinline__ void group_sync(int g) { group_barrier(g, kFwdGroupThreads); }

template <int CPT, int L, typename T>
__global__ void __launch_bounds__(kFwdThreads)
bcpnn_fwd_kernel(const float* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, const int* __restrict__ table,
                 float* __restrict__ out, int B, int Ni, int K, int Nj, int Mj, int Mi,
                 int nact, float gain) {
  constexpr int V = CPT < 4 ? CPT : 4;  // width of one w read
  constexpr int TN = 16 * CPT;          // columns per chunk
  constexpr int STAGE = fwd_stage<CPT>();
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / kFwdGroupThreads;
  const int gt = threadIdx.x % kFwdGroupThreads;
  const int tr = gt / 16;
  const int tc = gt % 16;
  float* xs = smem + g * STAGE;                 // [kFwdK][kFwdXS]
  float* ws = xs + kFwdK * kFwdXS;              // [kFwdK][TN]
  float* sup = smem + kFwdGroups * STAGE;       // [kFwdRows][Mj]
  const int row0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int col0 = h * Mj;  // first unit of this post-HC
  const int slices = (K + kFwdK - 1) / kFwdK;

  for (int c0 = 0; c0 < Mj; c0 += TN) {
    float acc[2][CPT];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

    for (int s0 = 0; s0 < slices; s0 += kFwdGroups) {
      const int k0 = (s0 + g) * kFwdK;  // past K: the group loads zeros
#pragma unroll
      for (int q = 0; q < kFwdRows * kFwdK / kFwdGroupThreads; ++q) {
        const int e = gt + q * kFwdGroupThreads;
        const int r = e / kFwdK, kk = e % kFwdK;
        const int gr = row0 + r, gk = k0 + kk;
        xs[kk * kFwdXS + r] =
            (gr < B && gk < K) ? x[(size_t)gr * Ni + unit_of<L>(table, h, gk, Mi, nact)] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kFwdK * TN / kFwdGroupThreads; ++q) {
        const int e = gt + q * kFwdGroupThreads;
        const int kk = e / TN, c = e % TN;
        const int gk = k0 + kk, gc = c0 + c;
        float v = 0.f;
        if (gk < K && gc < Mj) {
          v = to_f32(L == kCompact
                         ? w[((size_t)h * K + gk) * Mj + gc]
                         : w[(size_t)unit_of<L>(table, h, gk, Mi, nact) * Nj + col0 + gc]);
        }
        ws[kk * TN + c] = v;
      }
      group_sync(g);
#pragma unroll 8
      for (int kk = 0; kk < kFwdK; ++kk) {
        float a[2];
        float b[CPT];
        lds<2>(xs + kk * kFwdXS + tr * 2, a);
#pragma unroll
        for (int v = 0; v < CPT / V; ++v) lds<V>(ws + kk * TN + v * 16 * V + tc * V, b + v * V);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      group_sync(g);
    }
    // Groups 1.. park their partial sums in their own w tiles (2*CPT*256
    // floats, exactly a tile); group 0 adds them in group order.
    if (g > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) ws[(r * CPT + c) * kFwdGroupThreads + gt] = acc[r][c];
    }
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float s = acc[r][c];
          for (int o = 1; o < kFwdGroups; ++o)
            s += smem[o * STAGE + kFwdK * kFwdXS + (r * CPT + c) * kFwdGroupThreads + gt];
          const int lc = c0 + (c / V) * 16 * V + tc * V + (c % V);
          if (lc < Mj) sup[(tr * 2 + r) * Mj + lc] = (s + to_f32(bias[col0 + lc])) * gain;
        }
    }
    __syncthreads();
  }

  softmax_rows_to(sup, kFwdRows, Mj, out, row0, B, Nj, col0);
}

template <int CPT, int L, typename T>
cudaError_t launch_fwd(const float* x, const T* w, const T* bias, const int* table,
                       float* out, int B, int Ni, int K, int Hj, int Mj, int Mi, int nact,
                       float gain, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kFwdGroups * fwd_stage<CPT>() + (size_t)kFwdRows * Mj);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcpnn_fwd_kernel<CPT, L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kFwdRows - 1) / kFwdRows, Hj);
  bcpnn_fwd_kernel<CPT, L, T><<<grid, kFwdThreads, smem, stream>>>(
      x, w, bias, table, out, B, Ni, K, Hj * Mj, Mj, Mi, nact, gain);
  return cudaGetLastError();
}

// Picks the column chunk (16*CPT lanes) from the HC width.
template <int L, typename T>
cudaError_t launch_fwd_any(const float* x, const T* w, const T* bias, const int* table,
                           float* out, int B, int Ni, int K, int Hj, int Mj, int Mi, int nact,
                           float gain, cudaStream_t st) {
  if (Mj <= 16) return launch_fwd<1, L>(x, w, bias, table, out, B, Ni, K, Hj, Mj, Mi, nact, gain, st);
  if (Mj <= 32) return launch_fwd<2, L>(x, w, bias, table, out, B, Ni, K, Hj, Mj, Mi, nact, gain, st);
  if (Mj <= 64) return launch_fwd<4, L>(x, w, bias, table, out, B, Ni, K, Hj, Mj, Mi, nact, gain, st);
  return launch_fwd<8, L>(x, w, bias, table, out, B, Ni, K, Hj, Mj, Mi, nact, gain, st);
}

// The weight element type: fp32, or the bf16 of a serving pack.
template <int L>
cudaError_t launch_fwd_typed(const float* x, const void* w, const void* bias, const int* table,
                             float* out, int B, int Ni, int K, int Hj, int Mj, int Mi, int nact,
                             int bf16, float gain, cudaStream_t st) {
  if (bf16) {
    return launch_fwd_any<L>(x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias, table, out,
                             B, Ni, K, Hj, Mj, Mi, nact, gain, st);
  }
  return launch_fwd_any<L>(x, (const float*)w, (const float*)bias, table, out, B, Ni, K, Hj, Mj,
                           Mi, nact, gain, st);
}

// ------------------------------------------- resident-trace update (tc) --
//
//   co    = x^T y / n           (n = *count if given, else the B rows read)
//   pij'  = (1 - a) pij + a co
//   w     = (log clip(pij', eps^2, 1) - log_pi[i] - log_pj[j]) * m[i, j]
//
// One body for the two layouts whose trace lives in the device's (Ni, Nj)
// layout.  It replaces two TPU kernels:
//   src/repro/kernels/bcpnn_update.py:63 bcpnn_update_pallas (dense: m is
//     the (Hi, Hj) hypercolumn mask, indexed at HC level, mask[i/Mi, j/Mj]);
//   src/repro/kernels/patchy.py:241 patchy_update (patchy-held: an element
//     is live when its pre-HC i/Mi is in post-HC j/Mj's row of the (Hj,
//     nact) table; a live element takes the EMA and the fold, a silent one
//     keeps pij' = pij bit for bit and w = 0).
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
// at about a third of that rate on the card (chip_smoke.py's mma.sync
// yardstick, csrc/yardstick.cu), so its dense product at Model 1 lasts
// about as long as the bytes, and the two overlap only in part.  What each
// part of the design does about it:
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
//    with cvt.rna.tf32.f32 into hi and lo = tf32(v - hi), and the three
//    products lo*hi, hi*lo, hi*hi are accumulated (lo*lo, ~2^-22 relative,
//    is dropped); ref.split_tf32_co models it on the CPU.  No single TF32
//    pass.  The contraction runs over the batch; x (B, Ni) and y (B, Nj)
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

constexpr int kTrStages = 2;
constexpr int kTrTeams = 2;          // ping-pong teams per block
constexpr int kTrTeamThreads = 256;  // 8 warps a team
constexpr int kTrThreads = kTrTeams * kTrTeamThreads;
constexpr int kTrPad = 8;            // row stride = 8 (mod 32) words

// Which operands may move in 16-byte pieces (length a multiple of 4
// floats and a 16-byte aligned base).
constexpr int kVecX = 1, kVecY = 2, kVecP = 4;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 or 4 bytes global -> shared, zero filled when !valid (src unread).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
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

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
// One bulk (TMA) copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) completing on ``bar``.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
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
// Named barriers: arrive without waiting (the other side syncs), or sync.
__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// Orders this thread's earlier generic-proxy accesses of shared memory
// (loads, stores, cp.async) before the async proxy's later ones (the bulk
// copies): run before the barrier after which a region is refilled.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// One team stages batch rows [b0, b0 + BK): the tile's x columns (the
// units in rowu, contiguous unless gathered) and its y columns.
template <class T>
__device__ __forceinline__ void load_batch_slice(float* xs, float* ys, const float* __restrict__ x,
                                                 const float* __restrict__ y, const int* rowu,
                                                 int tt, int b0, int B, int rows, int cols,
                                                 int Ni, int Nj, int j0, bool vx, bool vy) {
  constexpr int BM = T::kBM, BN = T::kBN, BK = T::kBK;
  if (vx) {  // contiguous rows rowu[0] .. rowu[0] + rows - 1
    const float* xb = x + rowu[0];
    for (int e = tt; e < BK * BM / 4; e += kTrTeamThreads) {
      const int bb = e / (BM / 4), u = (e % (BM / 4)) * 4;
      const bool v = b0 + bb < B && u < rows;
      cp_async16(xs + bb * T::kLdX + u, v ? xb + (size_t)(b0 + bb) * Ni + u : x, v);
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
// grid of copy tiles.
template <int L, class T>
__host__ __device__ __forceinline__ int trace_tiles(int Ni, int Nj, int Mi, int Mj, int Hj,
                                                   int nact) {
  const int dense = ((Ni + T::kBM - 1) / T::kBM) * ((Nj + T::kBN - 1) / T::kBN);
  if (L == kDense) return dense;
  return Hj * ((nact * Mi + T::kBM - 1) / T::kBM) * ((Mj + T::kBN - 1) / T::kBN) + dense;
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

  const int K = nact * Mi;  // live rows of a post-HC (patchy)
  const int gm = (K + BM - 1) / BM, gn = (Mj + BN - 1) / BN;
  const int gathered = L == kPatchy ? Hj * gm * gn : 0;
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
        bulk_copy(ps + r * T::kLdP, pij + (size_t)unit_at(j, r) * Nj + j.j0,
                  (uint32_t)(j.cols * 4), bar);
      }
    } else {
      for (int e = tt; e < BM * BN; e += kTrTeamThreads) {
        const int r = e / BN, c = e % BN;
        const bool ok = r < j.rows && c < j.cols;
        cp_async4(ps + r * T::kLdP + c, ok ? pij + (size_t)unit_at(j, r) * Nj + j.j0 + c : pij,
                  ok);
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
                        (vec & kVecX) && j.kind != kGathered, vec & kVecY);
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
            const float lw = logf(fminf(fmaxf(pv[q], eps2), 1.f)) - (lpi_s[r] + lpj_s[c + q]);
            wv[q] = L == kDense ? lw * mask[(size_t)rowhc[r] * Hj + colhc[c + q]] : lw;
          }
        }
        const size_t idx = (size_t)rowu[r] * Nj + j.j0 + c;
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

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
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
  if (Nj <= 64) {
    return launch_trace<L, NarrowTile>(pij, log_pi, log_pj, x, y, mask, table, a, count, pij_out,
                                       w_out, B, Ni, Nj, Mi, Mj, Hj, nact, vec, eps2, st);
  }
  return launch_trace<L, WideTile>(pij, log_pi, log_pj, x, y, mask, table, a, count, pij_out,
                                   w_out, B, Ni, Nj, Mi, Mj, Hj, nact, vec, eps2, st);
}

// ------------------------------------------------------- compact_update --
//
//   the same EMA and fold over the resident (Hj, K, Mj) compact trace.
//
// Grid: (64-column, 64-row) tiles of each post-HC h's (K, Mj) block (the
// grid's z axis is h).  The tile rows are the HC's K live pre-units,
// gathered from x in the tile loads; every entry is live, so there is no
// mask.  Each block loops over the batch in kUpdK-row slices staged
// through shared memory and accumulates its x^T y tile in registers (4 x 4
// per thread, fp32 FMA), then runs the EMA and log fold as the epilogue
// and writes pij' and w once, reading and writing the resident arrays and
// touching nothing else.  ``a`` and ``count`` are read from device memory.
//
// Bound: bytes.  At Model 1-struct (K = 256) it moves 15.5 MB, ~4.6 us.

constexpr int kUpdTile = 64;
constexpr int kUpdK = 16;
constexpr int kUpdThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kUpdThreads)
compact_update_kernel(const float* __restrict__ pij, const float* __restrict__ log_pi,
                      const float* __restrict__ log_pj, const float* __restrict__ x,
                      const float* __restrict__ y, const int* __restrict__ table,
                      const float* __restrict__ a_ptr, const float* __restrict__ count_ptr,
                      float* __restrict__ pij_out, float* __restrict__ w_out, int B, int Ni,
                      int Nj, int K, int Mi, int Mj, int nact, float eps2) {
  __shared__ float xs[kUpdK][kUpdTile];
  __shared__ float ys[kUpdK][kUpdTile];
  const int tid = threadIdx.x;
  const int ti = tid / 16;
  const int tj = tid % 16;
  const int h = blockIdx.z;              // post-HC
  const int i0 = blockIdx.y * kUpdTile;  // contraction rows [0, K)
  const int j0 = blockIdx.x * kUpdTile;  // columns [0, Mj) of the HC
  const int colbase = h * Mj;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int b0 = 0; b0 < B; b0 += kUpdK) {
#pragma unroll
    for (int q = 0; q < kUpdK * kUpdTile / kUpdThreads; ++q) {
      const int e = tid + q * kUpdThreads;
      const int bb = e / kUpdTile, u = e % kUpdTile;
      const int gb = b0 + bb;
      xs[bb][u] = (gb < B && i0 + u < K)
                      ? x[(size_t)gb * Ni + unit_of<kCompact>(table, h, i0 + u, Mi, nact)]
                      : 0.f;
      ys[bb][u] = (gb < B && j0 + u < Mj) ? y[(size_t)gb * Nj + colbase + j0 + u] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int bb = 0; bb < kUpdK; ++bb) {
      float xv[4], yv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xs[bb][ti * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) yv[c] = ys[bb][tj + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xv[r], yv[c], acc[r][c]);
    }
    __syncthreads();
  }

  const float a = *a_ptr;
  const float one_minus_a = 1.f - a;
  const float count = count_ptr != nullptr ? *count_ptr : (float)B;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gk = i0 + ti * 4 + r;
    if (gk >= K) continue;
    const float lpi = log_pi[unit_of<kCompact>(table, h, gk, Mi, nact)];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jl = j0 + tj + 16 * c;
      if (jl >= Mj) continue;
      const size_t idx = ((size_t)h * K + gk) * Mj + jl;
      const float co = acc[r][c] / count;
      const float p = one_minus_a * pij[idx] + a * co;
      pij_out[idx] = p;
      w_out[idx] = logf(fminf(fmaxf(p, eps2), 1.f)) - (lpi + log_pj[colbase + jl]);
    }
  }
}

}  // namespace

extern "C" {

const char* bcpnn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int bcpnn_hc_softmax(const float* s, float* out, long long segments, int m, float gain,
                     void* stream) {
  if (segments <= 0 || m <= 0) return (int)cudaSuccess;
  const long long blocks = (segments + kSoftmaxWarps - 1) / kSoftmaxWarps;
  hc_softmax_kernel<<<(unsigned)blocks, kSoftmaxWarps * kWarp, 0, (cudaStream_t)stream>>>(
      s, out, segments, m, gain);
  return (int)cudaGetLastError();
}

// ``bf16``: w and bias are __nv_bfloat16 (a bf16 serving pack), else float.
int bcpnn_fwd(const float* x, const void* w, const void* bias, float* out, int B, int Ni,
              int Hj, int Mj, int bf16, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  return (int)launch_fwd_typed<kDense>(x, w, bias, nullptr, out, B, Ni, Ni, Hj, Mj, 1, 0, bf16,
                                       gain, (cudaStream_t)stream);
}

// x (B, Ni); w (Ni, Hj*Mj) dense-resident, or (Hj, K, Mj) when ``compact``;
// table (Hj, nact) int32 with entries in [0, Ni/Mi).
int bcpnn_patchy_fwd(const float* x, const void* w, const void* bias, const int* table,
                     float* out, int B, int Ni, int Hj, int Mj, int Mi, int nact, int compact,
                     int bf16, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const int K = nact * Mi;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(compact ? launch_fwd_typed<kCompact>(x, w, bias, table, out, B, Ni, K, Hj, Mj, Mi,
                                                    nact, bf16, gain, st)
                       : launch_fwd_typed<kPatchy>(x, w, bias, table, out, B, Ni, K, Hj, Mj, Mi,
                                                   nact, bf16, gain, st));
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
  if (!compact) {
    return (int)launch_trace_any<kPatchy>(pij, log_pi, log_pj, x, y, nullptr, table, a, count,
                                          pij_out, w_out, B, Ni, Hj * Mj, Mi, Mj, Hj, nact, eps2,
                                          st);
  }
  const dim3 grid((Mj + kUpdTile - 1) / kUpdTile, (K + kUpdTile - 1) / kUpdTile, Hj);
  compact_update_kernel<<<grid, kUpdThreads, 0, st>>>(pij, log_pi, log_pj, x, y, table, a,
                                                      count, pij_out, w_out, B, Ni, Hj * Mj, K,
                                                      Mi, Mj, nact, eps2);
  return (int)cudaGetLastError();
}

}  // extern "C"
