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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
