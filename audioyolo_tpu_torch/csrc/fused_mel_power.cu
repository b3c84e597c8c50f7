// Kernel 1: phase-grouped DFT -> power -> mel in one pass, for Hopper (sm_90a).
//
// Replaces: audioyolo_tpu/ops/pallas_frontend.py::fused_mel_power (body
// _kernel). Per phase r and frame row: x (F) rounded to bf16, times C_r
// (F, 2F') in bf16 with fp32 accumulation gives the spectrum; spec*spec is
// rounded to bf16 and multiplied by [M; M] (2F', 32) with fp32
// accumulation. The spectrum never reaches device memory.
//
// What bounds it on the H100: the bf16 tensor-core work. At the serving
// batch (B=32, 8 phases, 120 groups, F=1782, 2F'=1002) that is ~112 GFLOP,
// ~0.113 ms at 989 TFLOP/s, against ~142 MB of traffic (~0.042 ms at
// 3.35 TB/s). The unfused form would add a (32, 8, 120, 1002) fp32
// spectrum written and read back (~123 MB each way).
//
// Design: all clips share C_r, so the GEMM M dimension is B*G rows per
// phase; grid (ceil(B*G/64), n_ph). A CTA owns 64 rows and walks every
// 64-column N tile of C_r inside the block: K steps of 64 through shared
// memory with bf16 WMMA (mma.sync) and fp32 accumulators; in each N tile's
// epilogue the 64x64 spectrum tile is squared, rounded to bf16 and
// multiplied by that tile's 64 rows of [M; M] into a 64x32 fp32 mel
// accumulator that stays in registers. No atomics, a fixed summation
// order. C and [M; M] arrive zero-padded to multiples of 64 (the padded
// columns square to 0). Frame rows (int16: 3564 bytes, not 16-byte
// aligned) are read with masked element loads and converted to bf16 on
// load, as x.astype(bf16) does. Simple and right first: no TMA, no wgmma,
// no multi-stage pipeline yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;       // frame rows per CTA
constexpr int BN = 64;       // spectrum columns per N tile
constexpr int BK = 64;       // frame samples per K step
constexpr int NMEL = 32;     // mel bins (output width)
constexpr int THREADS = 256; // 8 warps
constexpr int LDA = BK + 8;  // shared-memory row pitches (elements); the +8/+4
constexpr int LDB = BN + 8;  // keep WMMA's 32-byte alignment and spread banks
constexpr int LDM = NMEL + 8;
constexpr int LDC = BN + 4;
constexpr int LDO = NMEL + 4;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_mel_power_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ c,
                       const __nv_bfloat16* __restrict__ mel2, float* __restrict__ out,
                       int B, int R, int G, int F, int Fp, int Np) {
  __shared__ __align__(128) __nv_bfloat16 a_s[BM * LDA];  // frame tile, then bf16(spec^2)
  __shared__ __align__(128) __nv_bfloat16 b_s[BK * LDB];  // C_r tile
  __shared__ __align__(128) __nv_bfloat16 m_s[BN * LDM];  // [M; M] rows of this N tile
  __shared__ __align__(128) float acc_s[BM * LDC];        // spectrum tile, then mel tile

  const int r = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int M = B * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // this warp's 16-row slab
  const int wn = warp % 2;  // spectrum: 32 columns; mel: 16 columns

  // Row of the frame tile this thread loads, and its 16-sample segment.
  const int a_row = tid / 4;
  const int a_seg = (tid % 4) * 16;
  const int m = m0 + a_row;
  const bool row_ok = m < M;
  const T* xrow = x;
  if (row_ok) {
    const int b = m / G;
    const int g = m - b * G;
    xrow = x + ((size_t)(b * R + r) * G + g) * (size_t)F;
  }
  const __nv_bfloat16* cr = c + (size_t)r * Fp * Np;

  FragC mel_acc;
  wmma::fill_fragment(mel_acc, 0.0f);

  for (int n0 = 0; n0 < Np; n0 += BN) {
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int k0 = 0; k0 < Fp; k0 += BK) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + a_seg + e;
        const float v = (row_ok && k < F) ? static_cast<float>(xrow[k]) : 0.0f;
        a_s[a_row * LDA + a_seg + e] = __float2bfloat16_rn(v);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // 64 rows x 8 chunks of 16 bytes
        const int idx = tid + i * THREADS;
        const int row = idx / 8;
        const int ch = (idx % 8) * 8;
        *reinterpret_cast<uint4*>(&b_s[row * LDB + ch]) =
            *reinterpret_cast<const uint4*>(cr + (size_t)(k0 + row) * Np + n0 + ch);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, a_s + wm * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB fb;
          wmma::load_matrix_sync(fb, b_s + kk * LDB + wn * 32 + j * 16, LDB);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }

    // Epilogue of this N tile: square, round to bf16, times [M; M] rows.
    wmma::store_matrix_sync(acc_s + wm * 16 * LDC + wn * 32, acc[0], LDC, wmma::mem_row_major);
    wmma::store_matrix_sync(acc_s + wm * 16 * LDC + wn * 32 + 16, acc[1], LDC, wmma::mem_row_major);
    for (int i = tid; i < BN * NMEL / 8; i += THREADS) {
      const int row = i / (NMEL / 8);
      const int ch = (i % (NMEL / 8)) * 8;
      *reinterpret_cast<uint4*>(&m_s[row * LDM + ch]) =
          *reinterpret_cast<const uint4*>(mel2 + (size_t)(n0 + row) * NMEL + ch);
    }
    __syncthreads();
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int row = i / BN;
      const int col = i % BN;
      const float s = acc_s[row * LDC + col];
      a_s[row * LDA + col] = __float2bfloat16_rn(s * s);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      FragA fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a_s + wm * 16 * LDA + kk, LDA);
      wmma::load_matrix_sync(fb, m_s + kk * LDM + wn * 16, LDM);
      wmma::mma_sync(mel_acc, fa, fb, mel_acc);
    }
    __syncthreads();  // a_s, m_s and acc_s are rewritten by the next N tile
  }

  wmma::store_matrix_sync(acc_s + wm * 16 * LDO + wn * 16, mel_acc, LDO, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * NMEL; i += THREADS) {
    const int row = i / NMEL;
    const int col = i % NMEL;
    const int mm = m0 + row;
    if (mm < M) {
      const int b = mm / G;
      const int g = mm - b * G;
      out[((size_t)(b * R + r) * G + g) * NMEL + col] = acc_s[row * LDO + col];
    }
  }
}

}  // namespace

// x: (B, R, G, F) float32 or int16, contiguous. c: (R, Fp, Np) bf16, zero
// padded. mel2: (Np, 32) bf16, zero padded. out: (B, R, G, 32) float32.
extern "C" int ayt_fused_mel_power(const void* x, int x_is_int16, const void* c,
                                   const void* mel2, void* out, int B, int R, int G,
                                   int F, int Fp, int Np, void* stream) {
  if (B <= 0 || R <= 0 || G <= 0 || F <= 0 || F > Fp || Fp % BK != 0 || Np % BN != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((B * G + BM - 1) / BM), (unsigned)R);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(c);
  const __nv_bfloat16* mb = static_cast<const __nv_bfloat16*>(mel2);
  float* o = static_cast<float*>(out);
  if (x_is_int16) {
    fused_mel_power_kernel<int16_t><<<grid, THREADS, 0, s>>>(
        static_cast<const int16_t*>(x), cb, mb, o, B, R, G, F, Fp, Np);
  } else {
    fused_mel_power_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), cb, mb, o, B, R, G, F, Fp, Np);
  }
  return (int)cudaGetLastError();
}
