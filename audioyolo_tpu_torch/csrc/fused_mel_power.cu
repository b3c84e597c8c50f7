// Kernel 1: phase-grouped DFT -> power -> mel, for Hopper (sm_90a).
//
// Replaces: audioyolo_tpu/ops/pallas_frontend.py::fused_mel_power (body
// _kernel, pallas_call at line 75). Per phase r and frame row: x (F) rounded
// to bf16, times C_r (F, 2F') in bf16 with fp32 sums gives the spectrum;
// spec*spec is rounded to bf16 and multiplied by [M; M] (2F', 32) with fp32
// sums. The spectrum never reaches device memory.
//
// What bounds it on the H100: the bf16 tensor-core work. At the serving
// batch (B=32, 8 phases, 120 groups, F=1782, 2F'=1002) that is ~112 GFLOP,
// ~0.113 ms at 989 TFLOP/s, against ~142 MB of traffic (~0.042 ms at
// 3.35 TB/s). Only wgmma reaches that rate; it reads its operands from
// shared memory in the layout TMA writes, and it needs loads kept in flight
// ahead of it and enough FLOP per byte brought in from L2. As built, the
// main pass is held by L2 -> shared memory traffic (each CTA streams its
// phase's whole C_r^T: ~1.3 GB per call at B=32; a variant without the
// products takes 93% of its time) and the staging pass by device memory.
//
// Design, two launches on the caller's stream:
// 1. stage_frames_kernel: (B, R, G, F) int16/float32 frames -> bf16 scratch
//    (R, B*G, Fp), phase-major, rounded as x.astype(bf16), zero-padded from
//    F to Fp. A frame row (3564 or 7128 bytes) is not a multiple of 16
//    bytes, so TMA cannot address the frames themselves, and wgmma takes no
//    int16. Each phase becomes one dense matrix for a 3-D TMA map, whose
//    out-of-bounds rows read as zeros instead of the next phase.
// 2. mel_power_kernel: one CTA per 128-row tile of one phase; phase is the
//    slow grid axis, so one phase's 3.67 MB C_r^T stays in L2. A producer
//    warpgroup issues TMA loads (128-byte swizzle) of an A box (128 x 64
//    of the scratch) and a B box (256 x 64 of C_r^T, K-major) into a
//    3-stage ring guarded by full/empty mbarriers. Two consumer
//    warpgroups, 64 rows each, share every B box: they walk N in chunks of
//    256 columns and K in steps of 64 with wgmma m64n256k16 (both operands
//    in shared memory) into a 64 x 256 fp32 accumulator. After each chunk
//    the accumulator is squared and rounded to bf16 in registers; its
//    fragment for columns [16s, 16s+16) is exactly the register A fragment
//    of wgmma m64n32k16, so 16 register-A products against [M; M]^T (held
//    in shared memory for the whole CTA) add the chunk into a 64 x 32 fp32
//    mel accumulator. Fixed summation order, no atomics, no split-K.
//    128 x 256 x 64 per stage is 87 FLOP per byte brought in from L2.
// 1'. stage_frames_kernel_resample, on the waveform path in place of 1:
//    (B, S) int16/float32 at the dataset rate -> the same bf16 scratch
//    (1, B*G, Fp) of non-overlapping frames at the model rate. Replaces no
//    TPU kernel: the JAX package resamples with two float32 GEMMs over the
//    dense polyphase bank (ops/resample.py), 96 % of whose entries are exact
//    zeros. Output n (phase j = n % P) is the float32 FFMA chain, in tap
//    order, of the bank's taps of phase j times x[(n / P) * Q + first[j] -
//    width + t] (zero outside the clip; int16 read as x / 32768, the 2^-15
//    in the bank). Bound by bytes: at B=32, 22,050 -> 16,000 Hz, it reads
//    84.7 MB of int16 and writes 62.9 MB of bf16 (0.044 ms at 3.35 TB/s)
//    for 1.0 GFLOP. The FMAs take their operands from shared memory, whose
//    reads and the instructions around the FMAs bind, so the design keeps
//    operands in registers: a run of 8 outputs has fixed phases and input
//    offsets (the window bank, ops/resample.py::window_bank, holds their
//    taps over one U-sample window, zeros elsewhere), and a thread computes
//    one run in 8 rows (L = lcm(P, 8) outputs apart), so each window sample
//    it loads serves 8 outputs and each tap 8. A persistent CTA copies the
//    window bank to shared memory once; per unit (a clip's run of rows) the
//    unit's input span arrives by 16-byte asynchronous copies, in the
//    input's type, while the threads compute the unit before; the runs leave
//    by 16-byte bf16 stores. The resampled float32 signal never reaches
//    device memory. As built it takes ~2.2x its byte bound: shared-memory
//    reads (the window bank's, and the input's 1.75-way bank conflicts)
//    and their latency bind, not device memory (PERF.md §6).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 128;      // frame rows per CTA, 64 per consumer warpgroup
constexpr int BN = 256;      // spectrum columns per N chunk
constexpr int BK = 64;       // frame samples per K step: one 128-byte swizzle row
constexpr int NMEL = 32;     // mel bins (output width)
constexpr int MAX_NP = 1024; // [M; M]^T is held whole in shared memory
constexpr int STAGES = 3;
constexpr int THREADS = 384; // producer warpgroup + two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;           // 16 KB
constexpr int B_BYTES = BN * BK * 2;           // 32 KB
constexpr int MEL_TILE_BYTES = NMEL * BK * 2;  // 4 KB: 32 mel rows x 64 spectrum columns
constexpr int MEL_BYTES = MAX_NP / BK * MEL_TILE_BYTES;  // 64 KB
constexpr int BAR_BYTES = 64;  // full[STAGES], empty[STAGES], mel: 8 bytes each
constexpr int SMEM_BYTES = STAGES * (A_BYTES + B_BYTES) + MEL_BYTES + BAR_BYTES + 1024;  // + alignment

// ---------------------------------------------------------------- staging

__device__ __forceinline__ void load2(const int16_t* p, float& a, float& b) {
  const short2 v = *reinterpret_cast<const short2*>(p);
  a = static_cast<float>(v.x);
  b = static_cast<float>(v.y);
}

__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

// One thread per 8 scratch elements (one 16-byte store). x (B, R, G, F)
// row (b, r, g) becomes scratch row r*M + b*G + g, M = B*G.
template <typename T>
__global__ void __launch_bounds__(256)
stage_frames_kernel(const T* __restrict__ x, __nv_bfloat16* __restrict__ xs, int M, int R, int G,
                    int F, int Fp) {
  const int per_row = Fp / 8;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * M * per_row) return;
  const int k0 = (int)(i % per_row) * 8;
  const long long q = i / per_row;
  const int m = (int)(q % M);
  const int r = (int)(q / M);
  const int b = m / G;
  const int g = m - b * G;
  const T* src = x + ((size_t)(b * R + r) * G + g) * (size_t)F;
  float v[8];
  if (k0 + 8 <= F && F % 2 == 0) {  // even F keeps pairs 4-byte (int16) or 8-byte (f32) aligned
#pragma unroll
    for (int e = 0; e < 8; e += 2) load2(src + k0 + e, v[e], v[e + 1]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = k0 + e < F ? static_cast<float>(src[k0 + e]) : 0.0f;
  }
  __align__(16) __nv_bfloat162 o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(xs + q * Fp + k0) = *reinterpret_cast<const uint4*>(o);
}

// ------------------------------------------------ staging with resampling

constexpr int RS_THREADS = 128;
constexpr int RS_ROWS = 8;         // rows of one run a thread computes: each tap it loads serves 8
constexpr int RS_STAGES = 2;       // input spans in shared memory: this unit's and the next
constexpr int RS_MAX_WINDOW = 64;  // U: 28 at 22,050 -> 16,000 Hz, 56 at 44,100, 60 at 48,000
constexpr int SMEM_LIMIT = 232448; // the most dynamic shared memory a block can use

struct ResampleGeometry {
  int B, S;          // clips, input samples a clip
  int Q, P, width;   // input stride and output phases of the rate pair, the filter's half width
  int L, R, U, LQ;   // outputs a row (lcm(P, 8)), runs of 8 a row, window, input samples a row
  int F, Fp, G, N;   // frame length, padded, frames a clip, outputs a clip (G * F)
  int rows, KR;      // rows a clip, rows a unit
  int units_per_clip, n_units;
  int span;          // elements of a unit's input span in shared memory
};

// int16 -> float32 exactly without a conversion instruction (16 a clock on
// an SM): the bits of 2^23 + 2^15 + v (an integer add), less 2^23 + 2^15.
__device__ __forceinline__ float to_float(int16_t v) {
  return __int_as_float(static_cast<int>(v) + 0x4B008000) - 8421376.0f;
}

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A unit is KR rows of one clip; its input span starts `shift` elements into
// its buffer, whose first element is flat input element `fa` (16-byte aligned).
struct UnitSpan {
  int b, k0, nk, shift, len;
  long long cs, fa;
};

template <typename T>
__device__ __forceinline__ UnitSpan unit_span(const ResampleGeometry& g, const int* ssm, int unit,
                                              int mis) {
  constexpr int VEC = 16 / sizeof(T);
  UnitSpan u;
  u.b = unit / g.units_per_clip;
  u.k0 = (unit - u.b * g.units_per_clip) * g.KR;
  u.nk = min(g.KR, g.rows - u.k0);
  u.cs = (long long)u.b * g.S;
  const long long lo = u.cs + (long long)u.k0 * g.LQ + ssm[0] - g.width;  // the span's first sample
  u.fa = ((lo + mis) & ~(long long)(VEC - 1)) - mis;
  u.shift = (int)(lo - u.fa);
  u.len = u.shift + (u.nk - 1) * g.LQ + ssm[g.R - 1] - ssm[0] + g.U;
  return u;
}

// Start the copies of a unit's span into `buf`: 16 bytes at a time inside
// the clip; zeros outside it, as the resampler's zero padding (the few
// vectors across a clip's edge element by element).
template <typename T>
__device__ __forceinline__ void fetch_span(const T* __restrict__ x, T* buf, const ResampleGeometry& g,
                                           const int* ssm, int unit, int mis) {
  constexpr int VEC = 16 / sizeof(T);
  const UnitSpan u = unit_span<T>(g, ssm, unit, mis);
  for (int v = threadIdx.x; v * VEC < u.len; v += RS_THREADS) {
    const long long f = u.fa + (long long)v * VEC;
    T* dst = buf + v * VEC;
    if (f >= u.cs && f + VEC <= u.cs + g.S) {
      cp_async16(dst, x + f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const long long s = f + e - u.cs;
        dst[e] = (s >= 0 && s < g.S) ? x[f + e] : T(0);
      }
    }
  }
}

// Shared memory: the window bank (R runs, each 8 x U taps padded by 4
// floats, so that neighbouring runs' 16-byte reads fall in other banks), the
// runs' input starts, and a ring of RS_STAGES input spans in the input's
// type: the copies of the next units' spans run while the threads compute
// this one's. int16
// samples enter as integers (the bank is scaled by 2^-15). Output n = k*L +
// 8*run + e of clip b goes to scratch row b*G + n / F, column n % F.
// `mis`: the input pointer's offset from 16 bytes, in elements.
template <typename T>
__global__ void __launch_bounds__(RS_THREADS)
stage_frames_kernel_resample(const T* __restrict__ x, const float* __restrict__ wbank,
                             const int* __restrict__ wstart, __nv_bfloat16* __restrict__ xs,
                             const ResampleGeometry g, int mis) {
  extern __shared__ __align__(16) float rs_smem[];
  const int ws = 8 * g.U + 4;
  float* wsm = rs_smem;
  int* ssm = reinterpret_cast<int*>(rs_smem + g.R * ws);
  T* spans = reinterpret_cast<T*>(rs_smem + g.R * ws + ((g.R + 3) & ~3));

  const int quads = 2 * g.U;  // float4s of a run's taps, copied with the first unit's span
  for (int i = threadIdx.x; i < g.R * quads; i += RS_THREADS) {
    const int r = i / quads;
    cp_async16(wsm + r * ws + 4 * (i - r * quads), wbank + 4 * i);
  }
  for (int i = threadIdx.x; i < g.R; i += RS_THREADS) ssm[i] = wstart[i];

  // the zero columns [F, Fp) of every frame row, 16 bytes at a time where
  // F is a multiple of 8
  const int vec = g.F % 8 == 0 ? 8 : 1;
  const int pad = (g.Fp - g.F) / vec;
  for (int i = blockIdx.x * RS_THREADS + threadIdx.x; i < g.B * g.G * pad;
       i += gridDim.x * RS_THREADS) {
    const int row = i / pad;
    __nv_bfloat16* o = xs + (long long)row * g.Fp + g.F + (i - row * pad) * vec;
    if (vec == 8) {
      *reinterpret_cast<uint4*>(o) = make_uint4(0, 0, 0, 0);
    } else {
      *o = __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();  // the runs' starts, which place the spans

  const int groups = g.KR / RS_ROWS;  // a run's rows r*groups + grp belong to task grp
  const int tasks = g.R * groups;
  // a task's rows are `step` outputs apart: step_f frames and step_c columns
  const int step = groups * g.L, step_f = step / g.F, step_c = step - step_f * g.F;
  for (int s = 0; s < RS_STAGES - 1; ++s) {
    const int unit = blockIdx.x + s * gridDim.x;
    if (unit < g.n_units) fetch_span(x, spans + s * g.span, g, ssm, unit, mis);
    cp_async_commit();
  }
  int i = 0;
  for (int unit = blockIdx.x; unit < g.n_units; unit += gridDim.x, ++i) {
    const T* span = spans + (i % RS_STAGES) * g.span;
    const int ahead = unit + (RS_STAGES - 1) * gridDim.x;
    if (ahead < g.n_units) {
      fetch_span(x, spans + ((i + RS_STAGES - 1) % RS_STAGES) * g.span, g, ssm, ahead, mis);
    }
    cp_async_commit();
    cp_async_wait<RS_STAGES - 1>();  // this unit's copies have landed
    __syncthreads();
    const UnitSpan u = unit_span<T>(g, ssm, unit, mis);

    for (int t = threadIdx.x; t < tasks; t += RS_THREADS) {
      const int run = t % g.R;  // neighbouring threads: neighbouring runs, windows ~8Q/P apart
      const int grp = t / g.R;
      const float* w = wsm + run * ws;
      const T* xr = span + u.shift + ssm[run] - ssm[0] + grp * g.LQ;
      const int row_step = groups * g.LQ;
      float acc[RS_ROWS][8];
#pragma unroll
      for (int r = 0; r < RS_ROWS; ++r) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
      }
      for (int u0 = 0; u0 < g.U; u0 += 4) {
        float xv[RS_ROWS][4];
#pragma unroll
        for (int r = 0; r < RS_ROWS; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[r][c] = to_float(xr[r * row_step + u0 + c]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float4 wv = *reinterpret_cast<const float4*>(w + e * g.U + u0);
#pragma unroll
          for (int r = 0; r < RS_ROWS; ++r) {
            acc[r][e] = __fmaf_rn(wv.x, xv[r][0], acc[r][e]);
            acc[r][e] = __fmaf_rn(wv.y, xv[r][1], acc[r][e]);
            acc[r][e] = __fmaf_rn(wv.z, xv[r][2], acc[r][e]);
            acc[r][e] = __fmaf_rn(wv.w, xv[r][3], acc[r][e]);
          }
        }
      }
      const long long clip_row = (long long)u.b * g.G;
      int n0 = (u.k0 + grp) * g.L + 8 * run;
      int fr = n0 / g.F, col = n0 - fr * g.F;
#pragma unroll
      for (int r = 0; r < RS_ROWS; ++r, n0 += step, fr += step_f, col += step_c) {
        if (col >= g.F) {
          col -= g.F;
          ++fr;
        }
        if (grp + r * groups >= u.nk || n0 >= g.N) continue;
        if (g.F % 8 == 0) {  // the run lies in one frame row, 16-byte aligned
          __align__(16) __nv_bfloat162 o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(acc[r][2 * e], acc[r][2 * e + 1]);
          *reinterpret_cast<uint4*>(xs + (clip_row + fr) * g.Fp + col) = *reinterpret_cast<const uint4*>(o);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int n = n0 + e;
            if (n < g.N) {
              const int fr = n / g.F;
              xs[(clip_row + fr) * g.Fp + (n - fr * g.F)] = __float2bfloat16_rn(acc[r][e]);
            }
          }
        }
      }
    }
    __syncthreads();  // the span is read before a later fetch overwrites it
  }
}

// A unit: `groups` tasks of RS_ROWS rows for each of the R runs, as many as
// the threads take and shared memory holds (the window bank, the runs'
// starts and RS_STAGES input spans of `elem`-byte samples). Sets g.KR and
// g.span from g.R, g.U and g.LQ; returns the shared memory bytes, 0 where
// not even one group fits.
size_t resample_unit(ResampleGeometry& g, int elem) {
  for (int groups = std::max(1, RS_THREADS / g.R); groups > 0; --groups) {
    g.KR = RS_ROWS * groups;
    g.span = (g.KR * g.LQ + g.U + 2 * (16 / elem) + 7) / 8 * 8;
    const size_t smem = ((size_t)g.R * (8 * g.U + 4) + ((g.R + 3) & ~3)) * sizeof(float) +
                        (size_t)RS_STAGES * g.span * elem;
    if (smem <= SMEM_LIMIT) return smem;
  }
  return 0;
}

template <typename T>
int launch_resample(const void* x, const void* wbank, const void* wstart, void* xs,
                    const ResampleGeometry& g, size_t smem, cudaStream_t stream) {
  const auto kernel = stage_frames_kernel_resample<T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, RS_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)std::min<long long>(g.n_units, (long long)sms * std::max(per_sm, 1));
  const int mis = (int)((reinterpret_cast<uintptr_t>(x) / sizeof(T)) % (16 / sizeof(T)));
  kernel<<<grid, RS_THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const float*>(wbank),
                                             static_cast<const int*>(wstart),
                                             static_cast<__nv_bfloat16*>(xs), g, mis);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- barriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand that TMA wrote with
// the 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart
// (stride byte offset), leading byte offset unused (1), layout 1 = SW128.
// The atom must be 1024-byte aligned; one k16 slice further is +32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
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

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait that retires it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 fp32, this warpgroup) += A (64 x 16, smem) * B (256 x 16, smem)^T
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 0;"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72), F8(80),
        F8(88), F8(96), F8(104), F8(112), F8(120)
      : "l"(da), "l"(db));
}

#undef F8

// d (64 x 32 fp32) += A (64 x 16, bf16 in registers) * B (32 x 16, smem)^T
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1, 0;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db));
}

// bf16(lo*lo) in the low half, bf16(hi*hi) in the high half.
__device__ __forceinline__ uint32_t square_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(lo, lo), __fmul_rn(hi, hi));
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ main kernel

// grid (ceil(M / 128), R); out (B, R, G, 32) fp32 with M = B*G.
__global__ void __launch_bounds__(THREADS, 1)
mel_power_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                 const __grid_constant__ CUtensorMap m_map, float* __restrict__ out, int M, int R,
                 int G, int k_steps, int n_chunks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~(uintptr_t)1023);
  const uint32_t a_s = smem_u32(smem);
  const uint32_t b_s = a_s + STAGES * A_BYTES;
  const uint32_t mel_s = b_s + STAGES * B_BYTES;
  const uint32_t full0 = mel_s + MEL_BYTES;
  const uint32_t empty0 = full0 + 8 * STAGES;
  const uint32_t mel_bar = empty0 + 8 * STAGES;
  const int r = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 8);  // lane 0 of each consumer warp
    }
    mbar_init(mel_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const int mel_tiles = n_chunks * (BN / BK);
      mbar_expect_tx(mel_bar, mel_tiles * MEL_TILE_BYTES);
      for (int t = 0; t < mel_tiles; ++t) {
        tma_load_2d(mel_s + t * MEL_TILE_BYTES, &m_map, mel_bar, t * BK, 0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0; n < n_chunks; ++n) {
        for (int k = 0; k < k_steps; ++k) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, A_BYTES + B_BYTES);
          tma_load_3d(a_s + stage * A_BYTES, &a_map, full, k * BK, m0, r);
          tma_load_3d(b_s + stage * B_BYTES, &b_map, full, k * BK, n * BN, r);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const uint32_t a_c = a_s + c * (A_BYTES / 2);
    float mel[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) mel[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;

    for (int n = 0; n < n_chunks; ++n) {
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.0f;
      int prev = 0;
      for (int k = 0; k < k_steps; ++k) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint64_t da = sw128_desc(a_c + stage * A_BYTES);
        const uint64_t db = sw128_desc(b_s + stage * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n256k16(d, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        if (k > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // bf16(spec^2) in the register A layout of m64n32k16, 16 k16 slices
      uint32_t p[64];
#pragma unroll
      for (int s = 0; s < 16; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) p[4 * s + q] = square_bf16x2(d[8 * s + 2 * q], d[8 * s + 2 * q + 1]);
      }
      if (n == 0) mbar_wait(mel_bar, 0);
      wgmma_fence();
      const uint32_t mel_n = mel_s + n * (BN / BK) * MEL_TILE_BYTES;
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const uint64_t dm = sw128_desc(mel_n + (s / 4) * MEL_TILE_BYTES + (s % 4) * 32);
        wgmma_m64n32k16_rs(mel, p[4 * s], p[4 * s + 1], p[4 * s + 2], p[4 * s + 3], dm);
      }
      wgmma_commit();
      wgmma_wait<0>();  // the squared fragments stay untouched until here
      fence_regs(p);
      fence_regs(mel);
    }

    // Epilogue: row m = b*G + g of phase r goes to out[(b*R + r)*G + g].
    const int row = m0 + c * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m < M) {
        const int b = m / G;
        const int g = m - b * G;
        float* o = out + ((size_t)(b * R + r) * G + g) * NMEL + (lane % 4) * 2;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          *reinterpret_cast<float2*>(o + q * 8) = make_float2(mel[4 * q + 2 * h], mel[4 * q + 2 * h + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(p)
                                                                   : nullptr;
  }();
  return fn;
}

// A bf16 map read in 128-byte-swizzled boxes; out-of-bounds elements read as zero.
bool encode_bf16(CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: (B, R, G, F) float32 or int16, contiguous. xs: (R, B*G, Fp) bf16.
extern "C" int ayt_stage_frames(const void* x, int x_is_int16, void* xs, int B, int R, int G, int F,
                                int Fp, void* stream) {
  if (B <= 0 || R <= 0 || G <= 0 || F <= 0 || F > Fp || Fp % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = B * G;
  const long long n = (long long)R * M * (Fp / 8);
  const dim3 grid((unsigned)((n + 255) / 256));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(xs);
  if (x_is_int16) {
    stage_frames_kernel<int16_t><<<grid, 256, 0, s>>>(static_cast<const int16_t*>(x), o, M, R, G, F, Fp);
  } else {
    stage_frames_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), o, M, R, G, F, Fp);
  }
  return (int)cudaGetLastError();
}

// x: (B, S) float32 or int16 at the input rate, contiguous. wbank: (R, 8,
// U) float32, wstart: (R,) int32 (ops/resample.py::window_bank for the rate
// pair Q:P, L = 8R a multiple of P; for int16 input the bank times 2^-15,
// the samples read as integers), 16-byte aligned. xs: (1, B*G, Fp) bf16,
// G = ceil(P*S/Q) / F frames of F samples at the output rate. Fp % 8 == 0.
extern "C" int ayt_stage_frames_resample(const void* x, int x_is_int16, const void* wbank,
                                         const void* wstart, void* xs, int B, int S, int Q, int P,
                                         int width, int R, int U, int F, int Fp, void* stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || P <= 0 || width < 0 || R <= 0 || (8 * R) % P != 0 || U <= 0 ||
      U % 4 != 0 || U > RS_MAX_WINDOW || F <= 0 || F > Fp || Fp % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  ResampleGeometry g;
  g.B = B;
  g.S = S;
  g.Q = Q;
  g.P = P;
  g.width = width;
  g.L = 8 * R;
  g.R = R;
  g.U = U;
  g.LQ = g.L / P * Q;
  g.F = F;
  g.Fp = Fp;
  const long long target = ((long long)P * S + Q - 1) / Q;
  if (target / F == 0 || (long long)g.L * ((target + g.L - 1) / g.L) > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  g.G = (int)(target / F);
  g.N = g.G * F;
  g.rows = (g.N + g.L - 1) / g.L;
  const size_t smem = resample_unit(g, x_is_int16 ? 2 : 4);
  if (smem == 0 || (long long)B * g.G * (Fp - F) > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  g.units_per_clip = (g.rows + g.KR - 1) / g.KR;
  g.n_units = B * g.units_per_clip;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_is_int16 ? launch_resample<int16_t>(x, wbank, wstart, xs, g, smem, s)
                    : launch_resample<float>(x, wbank, wstart, xs, g, smem, s);
}

// Whether ayt_stage_frames_resample takes the window bank of R runs of U
// samples for the rate pair Q:P, with float32 input (int16 needs less
// shared memory): 1 or 0. It asks nothing of the card.
extern "C" int ayt_stage_frames_resample_fits(int R, int U, int Q, int P) {
  if (R <= 0 || P <= 0 || Q <= 0 || (8 * R) % P != 0 || U <= 0 || U % 4 != 0 || U > RS_MAX_WINDOW) {
    return 0;
  }
  ResampleGeometry g;
  g.R = R;
  g.U = U;
  g.LQ = 8 * R / P * Q;
  return resample_unit(g, 4) != 0;
}

// xs: (R, B*G, Fp) bf16 from ayt_stage_frames. ct: (R, Np, Fp) bf16 = C_r^T,
// zero-padded. mel2t: (32, Np) bf16 = [M; M]^T, zero-padded. out: (B, R, G,
// 32) float32. Fp % 64 == 0, Np % 256 == 0, Np <= 1024; 16-byte aligned.
extern "C" int ayt_mel_power_staged(const void* xs, const void* ct, const void* mel2t, void* out,
                                    int B, int R, int G, int Fp, int Np, void* stream) {
  if (B <= 0 || R <= 0 || G <= 0 || Fp <= 0 || Fp % BK != 0 || Np <= 0 || Np % BN != 0 ||
      Np > MAX_NP) {
    return (int)cudaErrorInvalidValue;
  }
  const int M = B * G;
  const cuuint64_t a_dims[3] = {(cuuint64_t)Fp, (cuuint64_t)M, (cuuint64_t)R};
  const cuuint64_t a_strides[2] = {(cuuint64_t)Fp * 2, (cuuint64_t)M * Fp * 2};
  const cuuint32_t a_box[3] = {BK, BM, 1};
  const cuuint64_t b_dims[3] = {(cuuint64_t)Fp, (cuuint64_t)Np, (cuuint64_t)R};
  const cuuint64_t b_strides[2] = {(cuuint64_t)Fp * 2, (cuuint64_t)Np * Fp * 2};
  const cuuint32_t b_box[3] = {BK, BN, 1};
  const cuuint64_t m_dims[2] = {(cuuint64_t)Np, NMEL};
  const cuuint64_t m_strides[1] = {(cuuint64_t)Np * 2};
  const cuuint32_t m_box[2] = {BK, NMEL};
  CUtensorMap a_map, b_map, m_map;
  if (!encode_bf16(&a_map, xs, 3, a_dims, a_strides, a_box) ||
      !encode_bf16(&b_map, ct, 3, b_dims, b_strides, b_box) ||
      !encode_bf16(&m_map, mel2t, 2, m_dims, m_strides, m_box)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e =
      cudaFuncSetAttribute(mel_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)R);
  mel_power_kernel<<<grid, THREADS, SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, m_map, static_cast<float*>(out), M, R, G, Fp / BK, Np / BN);
  return (int)cudaGetLastError();
}
