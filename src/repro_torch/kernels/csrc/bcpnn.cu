// Hand-written Hopper (sm_90a) kernels for the BCPNN main path.
//
// Three kernels, one per Pallas TPU kernel of the JAX package:
//
//   bcpnn_hc_softmax  <- repro/kernels/hc_softmax.py::hc_softmax_pallas
//   bcpnn_fwd         <- repro/kernels/bcpnn_fwd.py::bcpnn_fwd_pallas
//   bcpnn_update      <- repro/kernels/bcpnn_update.py::bcpnn_update_pallas
//
// All arithmetic is IEEE fp32 on the CUDA cores: no TF32 tensor cores and
// no fast-math intrinsics, because trace increments are ~1e-5 and the
// log-weight fold must stay within 1e-4 of the fp32 reference.  Each kernel
// computes its own offsets and masks ragged edges itself (no pad plan).
//
// C interface: every entry point takes raw device pointers, sizes and the
// CUDA stream, launches on that stream without synchronising, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.  Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

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
// softmax is block-local and the support never leaves the SM.  The block
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
// TF32 or lower), no TMA, no pipelining across slices.

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
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kFwdGroupThreads) : "memory");
}

template <int CPT>
__global__ void __launch_bounds__(kFwdThreads)
bcpnn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int Ni, int Nj, int Mj, float gain) {
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
  const int col0 = blockIdx.y * Mj;  // first unit of this post-HC
  const int slices = (Ni + kFwdK - 1) / kFwdK;

  for (int c0 = 0; c0 < Mj; c0 += TN) {
    float acc[2][CPT];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

    for (int s0 = 0; s0 < slices; s0 += kFwdGroups) {
      const int k0 = (s0 + g) * kFwdK;  // past Ni: the group loads zeros
#pragma unroll
      for (int q = 0; q < kFwdRows * kFwdK / kFwdGroupThreads; ++q) {
        const int e = gt + q * kFwdGroupThreads;
        const int r = e / kFwdK, kk = e % kFwdK;
        const int gr = row0 + r, gk = k0 + kk;
        xs[kk * kFwdXS + r] = (gr < B && gk < Ni) ? x[(size_t)gr * Ni + gk] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kFwdK * TN / kFwdGroupThreads; ++q) {
        const int e = gt + q * kFwdGroupThreads;
        const int kk = e / TN, c = e % TN;
        const int gk = k0 + kk, gc = c0 + c;
        ws[kk * TN + c] = (gk < Ni && gc < Mj) ? w[(size_t)gk * Nj + col0 + gc] : 0.f;
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
          if (lc < Mj) sup[(tr * 2 + r) * Mj + lc] = (s + bias[col0 + lc]) * gain;
        }
    }
    __syncthreads();
  }

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int lr = warp; lr < kFwdRows; lr += kFwdThreads / kWarp) {
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

template <int CPT>
cudaError_t launch_fwd(const float* x, const float* w, const float* bias, float* out,
                       int B, int Ni, int Hj, int Mj, float gain, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kFwdGroups * fwd_stage<CPT>() + (size_t)kFwdRows * Mj);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcpnn_fwd_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + kFwdRows - 1) / kFwdRows, Hj);
  bcpnn_fwd_kernel<CPT><<<grid, kFwdThreads, smem, stream>>>(x, w, bias, out, B, Ni, Hj * Mj, Mj, gain);
  return cudaGetLastError();
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

constexpr int kUpdTile = 64;
constexpr int kUpdK = 16;
constexpr int kUpdThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kUpdThreads)
bcpnn_update_kernel(const float* __restrict__ pij, const float* __restrict__ log_pi,
                    const float* __restrict__ log_pj, const float* __restrict__ x,
                    const float* __restrict__ y, const float* __restrict__ mask,
                    const float* __restrict__ a_ptr, const float* __restrict__ count_ptr,
                    float* __restrict__ pij_out, float* __restrict__ w_out, int B, int Ni,
                    int Nj, int Mi, int Mj, int Hj, float eps2) {
  __shared__ float xs[kUpdK][kUpdTile];
  __shared__ float ys[kUpdK][kUpdTile];
  const int tid = threadIdx.x;
  const int ti = tid / 16;
  const int tj = tid % 16;
  const int i0 = blockIdx.y * kUpdTile;
  const int j0 = blockIdx.x * kUpdTile;

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
      xs[bb][u] = (gb < B && i0 + u < Ni) ? x[(size_t)gb * Ni + i0 + u] : 0.f;
      ys[bb][u] = (gb < B && j0 + u < Nj) ? y[(size_t)gb * Nj + j0 + u] : 0.f;
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
    const int gi = i0 + ti * 4 + r;
    if (gi >= Ni) continue;
    const float lpi = log_pi[gi];
    const float* mrow = mask + (size_t)(gi / Mi) * Hj;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tj + 16 * c;
      if (gj >= Nj) continue;
      const size_t idx = (size_t)gi * Nj + gj;
      const float co = acc[r][c] / count;
      const float p = one_minus_a * pij[idx] + a * co;
      pij_out[idx] = p;
      const float lw = logf(fminf(fmaxf(p, eps2), 1.f)) - (lpi + log_pj[gj]);
      w_out[idx] = lw * mrow[gj / Mj];
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

int bcpnn_fwd(const float* x, const float* w, const float* bias, float* out, int B, int Ni,
              int Hj, int Mj, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (Mj <= 16) err = launch_fwd<1>(x, w, bias, out, B, Ni, Hj, Mj, gain, st);
  else if (Mj <= 32) err = launch_fwd<2>(x, w, bias, out, B, Ni, Hj, Mj, gain, st);
  else if (Mj <= 64) err = launch_fwd<4>(x, w, bias, out, B, Ni, Hj, Mj, gain, st);
  else err = launch_fwd<8>(x, w, bias, out, B, Ni, Hj, Mj, gain, st);
  return (int)err;
}

int bcpnn_update(const float* pij, const float* log_pi, const float* log_pj, const float* x,
                 const float* y, const float* mask, const float* a, const float* count,
                 float* pij_out, float* w_out, int B, int Ni, int Nj, int Hi, int Hj,
                 float eps2, void* stream) {
  if (Ni <= 0 || Nj <= 0) return (int)cudaSuccess;
  const dim3 grid((Nj + kUpdTile - 1) / kUpdTile, (Ni + kUpdTile - 1) / kUpdTile);
  bcpnn_update_kernel<<<grid, kUpdThreads, 0, (cudaStream_t)stream>>>(
      pij, log_pi, log_pj, x, y, mask, a, count, pij_out, w_out, B, Ni, Nj, Ni / Hi, Nj / Hj,
      Hj, eps2);
  return (int)cudaGetLastError();
}

}  // extern "C"
