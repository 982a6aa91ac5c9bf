// Hand-written Hopper (sm_90a) int8 forwards of the low-precision serving
// path: one kernel body, templated on the weight layout, for the three
// Pallas TPU kernels of repro/kernels/quant.py:
//
//   bcpnn_quant_fwd, layout dense    <- quant.py::quant_fwd_pallas
//   bcpnn_quant_fwd, layout compact  <- quant.py::quant_compact_forward
//   bcpnn_quant_fwd, layout patchy   <- quant.py::quant_patchy_forward
//
// rates[b, h*Mj + n] = softmax_n(gain * (acc[b, h*Mj + n] * su[h] + bias)),
//   acc = sum_k round(clip(x[b, unit(k)], 0, 1) * 127) * w_q[k, h*Mj + n],
//   su[h] = scale[h] * fp32(1/127).
//
// The TPU kernels take pre-quantized, pre-gathered (Hj, B, K) activation
// codes and emulate the int8 product on the float unit, exact only for
// blocks of at most 1040 terms.  Here the block quantizes x in its tile
// load (round half to even, as jnp.round), looks each row's unit up in the
// (Hj, nact) table there too, and accumulates in int32 with __dp4a: four
// int8 products a instruction, exact for any K the wrapper accepts.  The
// epilogue is fp32 with each operation rounded on its own (no contraction
// into an FMA), as the plain PyTorch version computes it.
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
//
// Bound: bytes.  At Model 1 (B=128, Ni=1568, Nj=4096) the kernel reads
// 6.4 MB of codes and 0.8 MB of fp32 x and writes 2.1 MB of rates, ~2.8 us
// at 3.35 TB/s; its 1.64 G int8 operations take ~0.8 us at the tensor
// cores' 1979 TOP/s.  This first kernel runs on the CUDA cores' __dp4a
// (no mma.sync or wgmma, no TMA, no pipelining across slices).
//
// C interface as in bcpnn.cu: device pointers, sizes and the stream; the
// launch's cudaGetLastError() is returned.

#include <cstdint>

#include "common.cuh"

namespace {

using namespace bcpnn;

constexpr int kQRows = 32;             // batch rows per block
constexpr int kQK = 64;                // contraction slice (codes) per stage
constexpr int kQW = kQK / 4;           // 32-bit words of codes per row of a slice
constexpr int kQXS = kQW + 4;          // activation tile row stride in words
constexpr int kQGroups = 4;            // K-groups per block
constexpr int kQGroupThreads = 256;
constexpr int kQThreads = kQGroups * kQGroupThreads;
// fp32(1/127): the Q0.7 activation step, as the reference's ``scale *
// ACT_SCALE`` rounds it.
constexpr float kActScale = 1.0f / 127.0f;

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
      group_barrier(g, kQGroupThreads);
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
      group_barrier(g, kQGroupThreads);
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
// layout 0 (dense): w (Ni, Hj*Mj) int8, table unused.  layout 1 (patchy):
// the same dense-resident codes, each post-HC reading the K = nact*Mi rows
// its (Hj, nact) int32 table names.  layout 2 (compact): w (Hj, K, Mj).
int bcpnn_quant_fwd(const float* x, const int8_t* w, const float* bias, const float* scale,
                    const int* table, float* out, int B, int Ni, int Hj, int Mj, int Mi,
                    int nact, int layout, float gain, void* stream) {
  if (B <= 0 || Hj <= 0 || Mj <= 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (layout == kDense)
    return (int)launch_quant_any<kDense>(x, w, bias, scale, nullptr, out, B, Ni, Ni, Hj, Mj, 1,
                                         0, gain, st);
  const int K = nact * Mi;
  if (layout == kPatchy)
    return (int)launch_quant_any<kPatchy>(x, w, bias, scale, table, out, B, Ni, K, Hj, Mj, Mi,
                                          nact, gain, st);
  return (int)launch_quant_any<kCompact>(x, w, bias, scale, table, out, B, Ni, K, Hj, Mj, Mi,
                                         nact, gain, st);
}

}  // extern "C"
