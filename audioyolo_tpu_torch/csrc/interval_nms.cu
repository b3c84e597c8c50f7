// Kernels 2 and 3: greedy 1-D interval NMS keep flags, for Hopper (sm_90a).
//
// Replaces: audioyolo_tpu/ops/pallas_nms.py::greedy_suppress_pallas_blocked
// (body _nms_blocked_kernel) as the BLOCK=16 instance, and
// greedy_suppress_pallas (body _nms_kernel) as the BLOCK=1 instance. Input:
// per clip, K score-sorted intervals [x1, x2]. Row i, if still alive when
// its turn comes, suppresses every later column j with IoU(i, j) > thr
// (strict), the semantics of audioyolo_tpu/ops/nms.py::_greedy_suppress_rows.
//
// What bounds it on the H100: not bytes (~0.2 MB at B=32, K=630) nor
// operations (~K^2/2 IoUs per clip, ~40 MFLOP in all, well under 1 us):
// the K-step serial dependency chain and the launch. The roofline ignores
// both.
//
// Design: one CTA per clip; x1, x2, widths, keep state and per-column mask
// words live in shared memory (K padded to a multiple of 16 with [0, 0]
// intervals, which have IoU 0 with everything). Per chunk of BLOCK rows:
// (1) each thread builds a BLOCK-bit word per column it owns, bit r set when
// IoU(row i0+r, column) > thr; (2) one thread resolves the BLOCK x BLOCK
// in-chunk part serially; (3) every thread clears its columns past the
// chunk that any kept chunk row masks. The chain is K/BLOCK barriers long
// instead of K.
//
// Bit identity with the plain version: the IoU is computed with the same
// operations in the same order, inter / max(wi + wj - inter, 1e-12), with
// IEEE-rounded add, subtract and divide (__fadd_rn, __fsub_rn, __fdiv_rn)
// and the library is built with -fmad=false. max and min pass a NaN on, as
// torch.maximum and torch.minimum do (fmaxf and fminf would drop it), so a
// non-finite bound gives the plain version's keep flags too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 16;

// a NaN in either operand is returned
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float interval_iou(float x1i, float x2i, float wi,
                                              float x1j, float x2j, float wj) {
  const float inter = max_nan(__fsub_rn(min_nan(x2i, x2j), max_nan(x1i, x1j)), 0.0f);
  const float uni = __fsub_rn(__fadd_rn(wi, wj), inter);
  return __fdiv_rn(inter, max_nan(uni, 1e-12f));
}

template <int BLOCK>
__global__ void __launch_bounds__(THREADS)
greedy_suppress_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                       uint8_t* __restrict__ keep, int K, int k_pad, float thr) {
  static_assert(BLOCK >= 1 && BLOCK <= 32, "mask words are 32 bits");
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sx2 = sx1 + k_pad;
  float* sw = sx2 + k_pad;
  unsigned* smask = reinterpret_cast<unsigned*>(sw + k_pad);
  int* salive = reinterpret_cast<int*>(smask + k_pad);
  __shared__ unsigned kept_s;

  const size_t base = (size_t)blockIdx.x * K;
  const int tid = threadIdx.x;
  for (int j = tid; j < k_pad; j += THREADS) {
    const float a = j < K ? x1[base + j] : 0.0f;
    const float b = j < K ? x2[base + j] : 0.0f;
    sx1[j] = a;
    sx2[j] = b;
    sw[j] = max_nan(__fsub_rn(b, a), 0.0f);
    salive[j] = 1;
  }
  __syncthreads();

  for (int i0 = 0; i0 < k_pad; i0 += BLOCK) {
    // (1) mask words for the columns not yet final
    for (int j = i0 + tid; j < k_pad; j += THREADS) {
      const float x1j = sx1[j], x2j = sx2[j], wj = sw[j];
      unsigned bits = 0u;
#pragma unroll
      for (int rr = 0; rr < BLOCK; ++rr) {
        const int i = i0 + rr;
        if (interval_iou(sx1[i], sx2[i], sw[i], x1j, x2j, wj) > thr) bits |= 1u << rr;
      }
      smask[j] = bits;
    }
    __syncthreads();
    // (2) serial resolve inside the chunk: row i0+rr survives iff it is still
    // alive and no kept earlier row of the chunk masks it
    if (tid == 0) {
      unsigned kept = 0u;
      for (int rr = 0; rr < BLOCK; ++rr) {
        const int i = i0 + rr;
        if (salive[i] && !(smask[i] & kept)) {
          kept |= 1u << rr;
        } else {
          salive[i] = 0;
        }
      }
      kept_s = kept;
    }
    __syncthreads();
    // (3) bulk suppression of the later columns by the chunk's kept rows
    const unsigned kept = kept_s;
    if (kept) {
      for (int j = i0 + BLOCK + tid; j < k_pad; j += THREADS) {
        if (smask[j] & kept) salive[j] = 0;
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < K; j += THREADS) keep[base + j] = (uint8_t)salive[j];
}

template <int BLOCK>
cudaError_t launch(const float* x1, const float* x2, uint8_t* keep, int B, int K,
                   float thr, cudaStream_t s) {
  const int k_pad = (K + PAD - 1) / PAD * PAD;
  const size_t smem = (size_t)k_pad * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_suppress_kernel<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  greedy_suppress_kernel<BLOCK><<<B, THREADS, smem, s>>>(x1, x2, keep, K, k_pad, thr);
  return cudaGetLastError();
}

}  // namespace

// x1, x2: (B, K) float32 score-sorted bounds, contiguous. keep: (B, K) bytes
// (0/1). block: 16 (kernel 2) or 1 (kernel 3).
extern "C" int ayt_greedy_suppress(const void* x1, const void* x2, void* keep, int B,
                                   int K, float thr, int block, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(x1);
  const float* b = static_cast<const float*>(x2);
  uint8_t* k = static_cast<uint8_t*>(keep);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (block == 16) return (int)launch<16>(a, b, k, B, K, thr, s);
  if (block == 1) return (int)launch<1>(a, b, k, B, K, thr, s);
  return (int)cudaErrorInvalidValue;
}
