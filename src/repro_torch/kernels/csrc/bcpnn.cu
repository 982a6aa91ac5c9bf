// Hand-written Hopper (sm_90a) kernels for the BCPNN main path.
//
// Three kernel bodies for the seven Pallas TPU kernels ported so far:
//
//   bcpnn_hc_softmax     <- repro/kernels/hc_softmax.py::hc_softmax_pallas
//   bcpnn_fwd            <- repro/kernels/bcpnn_fwd.py::bcpnn_fwd_pallas
//   bcpnn_patchy_fwd     <- repro/kernels/patchy.py::patchy_forward and
//                           ::compact_forward (the body of bcpnn_fwd)
//   bcpnn_update         <- repro/kernels/bcpnn_update.py::bcpnn_update_pallas
//   bcpnn_patchy_update  <- repro/kernels/patchy.py::patchy_update and
//                           ::compact_update (the body of bcpnn_update)
//
// The forward and update bodies are templated on the weight layout
// (Layout below): dense (Ni, Nj); patchy, the same dense-resident arrays
// restricted per post-HC to the K = nact*Mi live pre-units named by the
// (Hj, nact) index table; compact, the resident (Hj, K, Mj) arrays.  The
// patchy layouts gather their live rows inside the tile loads, so the
// (Hj, B, K) gathered activations of the TPU kernels never exist.
//
// All arithmetic is IEEE fp32 on the CUDA cores: no TF32 tensor cores and
// no fast-math intrinsics, because trace increments are ~1e-5 and the
// log-weight fold must stay within 1e-4 of the fp32 reference.  Each kernel
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

// ---------------------------------------------------------- bcpnn_update --
//
//   co    = x^T y / n           (n = *count if given, else the B rows read)
//   pij'  = (1 - a) pij + a co
//   w     = (log clip(pij', eps^2, 1) - log_pi[i] - log_pj[j]) * mask[i/Mi, j/Mj]
//
// Grid over (64-column, 64-row) tiles of the (Ni, Nj) trace.  Each block
// loops over the batch in kUpdK-row slices staged through shared memory
// and accumulates its x^T y tile in registers (4 x 4 per thread), then
// runs the EMA and log fold as the epilogue and writes pij' and w once.
// ``a`` is read from device memory (a 0-d tensor: no host sync), and the
// structural mask is indexed at HC level from the (Hi, Hj) array instead
// of streaming an expanded (Ni, Nj) unit mask (25.7 MB a step at Model 1).
// A zero-padded tail batch passes ``count``, the number of genuine rows as
// a 0-d device tensor: its pad rows are zero and add nothing to x^T y, and
// the divisor is the real row count, again with no host sync.
//
// Bound: the larger of 77 MB of traffic (read pij, write pij' and w),
// ~23 us at 3.35 TB/s, and 1.64 GFLOP of fp32 FMA, ~24.5 us, at Model 1's
// hidden projection (B=128, Ni=1568, Nj=4096).
//
// Patchy and compact layouts: the grid's z axis is the post-HC h and the
// (K, Mj) tile rows are its live pre-units, gathered from x in the tile
// loads; every entry is live, so there is no mask.  Patchy writes pij' and
// w at the live rows of (Ni, Nj) outputs that the caller filled with the
// held pij and zero w; compact reads and writes the resident (Hj, K, Mj)
// arrays and touches nothing else.  At Model 1-struct (K = 256) compact
// moves 15.5 MB, ~4.6 us: bytes.

constexpr int kUpdTile = 64;
constexpr int kUpdK = 16;
constexpr int kUpdThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <int L>
__global__ void __launch_bounds__(kUpdThreads)
bcpnn_update_kernel(const float* __restrict__ pij, const float* __restrict__ log_pi,
                    const float* __restrict__ log_pj, const float* __restrict__ x,
                    const float* __restrict__ y, const float* __restrict__ mask,
                    const int* __restrict__ table, const float* __restrict__ a_ptr,
                    const float* __restrict__ count_ptr, float* __restrict__ pij_out,
                    float* __restrict__ w_out, int B, int Ni, int Nj, int K, int ncols,
                    int Mi, int Mj, int Hj, int nact, float eps2) {
  __shared__ float xs[kUpdK][kUpdTile];
  __shared__ float ys[kUpdK][kUpdTile];
  const int tid = threadIdx.x;
  const int ti = tid / 16;
  const int tj = tid % 16;
  const int h = blockIdx.z;  // post-HC (0 when dense)
  const int i0 = blockIdx.y * kUpdTile;  // contraction rows [0, K)
  const int j0 = blockIdx.x * kUpdTile;  // columns [0, ncols) of the HC
  const int colbase = L == kDense ? 0 : h * Mj;

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
                      ? x[(size_t)gb * Ni + unit_of<L>(table, h, i0 + u, Mi, nact)]
                      : 0.f;
      ys[bb][u] = (gb < B && j0 + u < ncols) ? y[(size_t)gb * Nj + colbase + j0 + u] : 0.f;
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
    const int gi = unit_of<L>(table, h, gk, Mi, nact);
    const float lpi = log_pi[gi];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jl = j0 + tj + 16 * c;
      if (jl >= ncols) continue;
      const int gj = colbase + jl;
      const size_t idx = L == kCompact ? ((size_t)h * K + gk) * Mj + jl : (size_t)gi * Nj + gj;
      const float co = acc[r][c] / count;
      const float p = one_minus_a * pij[idx] + a * co;
      pij_out[idx] = p;
      const float lw = logf(fminf(fmaxf(p, eps2), 1.f)) - (lpi + log_pj[gj]);
      w_out[idx] = L == kDense ? lw * mask[(size_t)(gi / Mi) * Hj + gj / Mj] : lw;
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
  if (Ni <= 0 || Nj <= 0) return (int)cudaSuccess;
  const dim3 grid((Nj + kUpdTile - 1) / kUpdTile, (Ni + kUpdTile - 1) / kUpdTile);
  bcpnn_update_kernel<kDense><<<grid, kUpdThreads, 0, (cudaStream_t)stream>>>(
      pij, log_pi, log_pj, x, y, mask, nullptr, a, count, pij_out, w_out, B, Ni, Nj, Ni, Nj,
      Ni / Hi, Nj / Hj, Hj, 0, eps2);
  return (int)cudaGetLastError();
}

// Patchy: pij, pij_out, w_out (Ni, Hj*Mj), only the table's live rows of
// each post-HC's columns are read and written.  Compact: (Hj, K, Mj).
int bcpnn_patchy_update(const float* pij, const float* log_pi, const float* log_pj,
                        const float* x, const float* y, const int* table, const float* a,
                        const float* count, float* pij_out, float* w_out, int B, int Ni, int Hj,
                        int Mj, int Mi, int nact, int compact, float eps2, void* stream) {
  const int K = nact * Mi;
  if (K <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const dim3 grid((Mj + kUpdTile - 1) / kUpdTile, (K + kUpdTile - 1) / kUpdTile, Hj);
  const cudaStream_t st = (cudaStream_t)stream;
  if (compact) {
    bcpnn_update_kernel<kCompact><<<grid, kUpdThreads, 0, st>>>(
        pij, log_pi, log_pj, x, y, nullptr, table, a, count, pij_out, w_out, B, Ni, Hj * Mj, K,
        Mj, Mi, Mj, Hj, nact, eps2);
  } else {
    bcpnn_update_kernel<kPatchy><<<grid, kUpdThreads, 0, st>>>(
        pij, log_pi, log_pj, x, y, nullptr, table, a, count, pij_out, w_out, B, Ni, Hj * Mj, K,
        Mj, Mi, Mj, Hj, nact, eps2);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
