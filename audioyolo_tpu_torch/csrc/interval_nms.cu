// Kernels 2 and 3: greedy 1-D interval NMS keep flags, for Hopper (sm_90a).
//
// Replaces: audioyolo_tpu/ops/pallas_nms.py::greedy_suppress_pallas_blocked
// (body _nms_blocked_kernel) as the chunked instance (chunks of 32 rows), and
// greedy_suppress_pallas (body _nms_kernel) as the row-by-row instance.
// Input: per clip, K score-sorted intervals [x1, x2]. Row i, if still alive
// when its turn comes, suppresses every later column j with IoU(i, j) > thr
// (strict), the semantics of audioyolo_tpu/ops/nms.py::_greedy_suppress_rows.
//
// What bounds it on the H100: neither bytes (~0.2 MB at B=32, K=630) nor
// operations in the roofline's sense, but latency: a parallel phase of
// K^2/2 IoUs per clip (198 k at K=630) on the few SMs of one clip, then a
// serial chain of greedy decisions in one warp, and the launch. A single
// CTA per clip with a barrier-separated chain as long as K took ~0.28 ms.
//
// Design. The IoU rows depend only on the bounds, never on which rows are
// alive, so the work splits in two:
// - Mask phase, parallel: one thread-block cluster of CLUSTER CTAs per clip.
//   Chunk c (rows 32c..32c+31) belongs to CTA rank c % CLUSTER. Each CTA
//   writes into its own shared memory W = ceil(K/32) suppression words per
//   owned row: bit t of word w of row i is set iff j = 32w+t satisfies
//   j > i, j < K and IoU(i, j) > thr. One thread builds one word; the 32
//   lanes of a warp take 32 rows of one word, so the column bounds they read
//   are broadcast. The comparison takes two FMAs and no divide (see below).
// - Resolve phase, serial but on bits only: after cluster.sync(), warp 0 of
//   rank 0 walks the chunks in order, reading only its own shared memory
//   while rank 0's other warps stage the next pass of the other ranks'
//   chunks through distributed shared memory. Lane w holds `removed` word w
//   (and w + 32 above K = 1024). The chunked instance loops over a chunk's
//   surviving candidates with __ffs, once per kept row, each kept row
//   clearing its in-chunk victims; the row-by-row instance steps through
//   every row. The kept rows' words are OR-ed into `removed`.
// - keep[i] = !(removed bit i), written by rank 0; a second cluster.sync()
//   keeps every CTA alive until rank 0 has read its words.
// K is limited to K_MAX = 2048 (two words per lane; the words of one clip
// spread over the cluster's shared memory). Pad columns (j >= K) are masked
// off, not left to the bounds of pad intervals.
//
// Bit identity with the plain version: the IoU's numerator and denominator
// are computed with the same operations in the same order, inter and
// max(wi + wj - inter, 1e-12), with IEEE-rounded add and subtract (__fadd_rn,
// __fsub_rn) and the library built with -fmad=false; max and min pass a NaN
// on, as torch.maximum and torch.minimum do. Whether the rounded quotient
// exceeds thr is settled exactly by the signs of two FMAs, and by the IEEE
// divide (__fdiv_rn) where they cannot settle it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// CTAs per cluster: 4 (measured against 8 with nms_kernel_ab.py, which
// builds both through -DAYT_NMS_CLUSTER)
#ifndef AYT_NMS_CLUSTER
#define AYT_NMS_CLUSTER 4
#endif

namespace {

constexpr int CLUSTER = AYT_NMS_CLUSTER;
static_assert(CLUSTER == 4 || CLUSTER == 8, "portable cluster sizes");
constexpr int THREADS = 256;
constexpr int K_MAX = 2048;
constexpr int STAGE_BATCH = 8;  // 16-byte remote loads a staging thread keeps in flight
constexpr unsigned FULL = 0xffffffffu;

// IEEE maximum and minimum that return a NaN if either operand is one, as
// torch.maximum and torch.minimum do (fmaxf and fminf would drop it). They
// may give +0 where a compare-and-select gives -0 (or the reverse); no sign
// of zero reaches a keep flag: the IoU's numerator is max(. - ., +0).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The IoU is inter / den; both parts are computed as the plain version does.
struct Overlap {
  float inter, den;
};

__device__ __forceinline__ Overlap overlap(float4 a, float4 b) {
  const float inter = max_nan(__fsub_rn(min_nan(a.y, b.y), max_nan(a.x, b.x)), 0.0f);
  return {inter, max_nan(__fsub_rn(__fadd_rn(a.z, b.z), inter), 1e-12f)};
}

// word `idx` (warp-uniform) of a lane's RW words, without indexing a
// register array at run time (that would put it in local memory)
template <int RW>
__device__ __forceinline__ unsigned pick(const unsigned (&v)[RW], int idx) {
  unsigned out = v[0];
#pragma unroll
  for (int s = 1; s < RW; ++s) out = idx == s ? v[s] : out;
  return out;
}

// Grid: CLUSTER * B CTAs, one cluster per clip. RW: removed words per lane
// (1 for K <= 1024, 2 up to K_MAX). CHUNKED: kernel 2, else kernel 3.
template <int RW, bool CHUNKED>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
greedy_suppress_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                       uint8_t* __restrict__ keep, int K, float thr) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int W = (K + 31) >> 5;  // words per row, and chunks of 32 rows
  const int WS = W | 1;         // row stride in words: odd, so lanes on rows hit distinct banks
  extern __shared__ float4 smem[];
  float4* scol = smem;  // 32W columns: x1, x2, width, 0
  unsigned* words = reinterpret_cast<unsigned*>(scol + 32 * W);
  __shared__ unsigned s_removed[K_MAX / 32];

  const size_t base = (size_t)(blockIdx.x / CLUSTER) * K;
  const int tid = threadIdx.x;
  for (int j = tid; j < 32 * W; j += THREADS) {
    const float a = j < K ? x1[base + j] : 0.0f;
    const float b = j < K ? x2[base + j] : 0.0f;
    scol[j] = make_float4(a, b, max_nan(__fsub_rn(b, a), 0.0f), 0.0f);
  }
  __syncthreads();

  // Mask phase: this CTA's chunks c = rank, rank + CLUSTER, ..., local index
  // lc. RN(inter / den) > thr is decided without dividing where the sign of
  // one fused multiply-add settles it: inter - thr * den < 0 gives a quotient
  // below thr, so its rounding is at most thr; inter - thr_up * den > 0
  // (thr_up, the next float above thr) gives a rounding at least thr_up. Each
  // FMA rounds once, which keeps the sign. What neither settles (a quotient
  // within one ulp above thr, a NaN, a zero difference) takes the IEEE divide.
  const float thr_up = nextafterf(thr, __int_as_float(0x7f800000));  // toward +inf
  const int n_own = rank < W ? (W - 1 - rank) / CLUSTER + 1 : 0;
  for (int t = tid; t < n_own * W * 32; t += THREADS) {
    const int r = t & 31;
    const int w = (t >> 5) % W;
    const int lc = (t >> 5) / W;
    const int c = rank + lc * CLUSTER;
    const int i = 32 * c + r;
    unsigned bits = 0u;
    if (w >= c && i < K) {  // words wholly at or below the diagonal stay 0
      const float4 ri = scol[i];
      const float4* cj = scol + 32 * w;
      unsigned unsure = 0u;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const Overlap o = overlap(ri, cj[u]);
        const float below = __fmaf_rn(-thr, o.den, o.inter);
        const float above = __fmaf_rn(-thr_up, o.den, o.inter);
        bits |= (unsigned)(above > 0.0f) << u;
        unsure |= (unsigned)(!(below < 0.0f) && !(above > 0.0f)) << u;
      }
      while (unsure) {
        const int u = __ffs(unsure) - 1;
        unsure &= unsure - 1u;
        const Overlap o = overlap(ri, cj[u]);
        if (__fdiv_rn(o.inter, o.den) > thr) bits |= 1u << u;
      }
      if (w == c) bits &= r == 31 ? 0u : FULL << (r + 1);  // j > i
      if (32 * w + 32 > K) bits &= FULL >> (32 * w + 32 - K);  // j < K
    }
    words[(lc * 32 + r) * WS + w] = bits;
  }
  // release this CTA's words to the cluster; every CTA has started
  cluster.sync();

  if (rank == 0) {
    // Resolve phase. Pass p is chunks p * CLUSTER + q, q < CLUSTER: chunk p
    // of each rank's own. Warps 1.. copy pass p + 1's chunks of the other
    // ranks into `stage` through distributed shared memory while warp 0
    // decides pass p (two buffers, one block barrier per pass), so warp 0
    // reads only its own shared memory.
    const int chunk_words = 32 * WS;
    const int n_passes = (W + CLUSTER - 1) / CLUSTER;
    unsigned* stage = words + n_passes * chunk_words;
    auto stage_pass = [&](int p, int first, int stride) {
      uint4* dst = reinterpret_cast<uint4*>(stage + (p & 1) * (CLUSTER - 1) * chunk_words);
      const int n = (CLUSTER - 1) * 8 * WS;  // 16-byte pieces: [rank - 1][8 * WS]
      for (int v0 = tid - first; v0 < n; v0 += STAGE_BATCH * stride) {
        uint4 piece[STAGE_BATCH];  // all loads of a batch in flight before its stores
#pragma unroll
        for (int k = 0; k < STAGE_BATCH; ++k) {
          const int v = v0 + k * stride;
          const int q = 1 + v / (8 * WS);
          if (v < n && p * CLUSTER + q < W)
            piece[k] = reinterpret_cast<const uint4*>(cluster.map_shared_rank(words, q) +
                                                      p * chunk_words)[v % (8 * WS)];
        }
#pragma unroll
        for (int k = 0; k < STAGE_BATCH; ++k) {
          const int v = v0 + k * stride;
          if (v < n && p * CLUSTER + 1 + v / (8 * WS) < W) dst[v] = piece[k];
        }
      }
    };
    stage_pass(0, 0, THREADS);
    __syncthreads();
    unsigned removed[RW];
#pragma unroll
    for (int s = 0; s < RW; ++s) removed[s] = 0u;
    for (int p = 0; p < n_passes; ++p) {
      if (tid < 32) {
        const int lane = tid;
        const unsigned* rows_of[CLUSTER];  // chunk p * CLUSTER + q's rows
        unsigned diag[CLUSTER];            // chunk row `lane`'s in-chunk word, per chunk
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) {
          const int c = min(p * CLUSTER + q, W - 1);
          rows_of[q] = q == 0 ? words + p * chunk_words
                              : stage + ((p & 1) * (CLUSTER - 1) + q - 1) * chunk_words;
          diag[q] = CHUNKED ? rows_of[q][lane * WS + c] : 0u;
        }
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) {
          const int c = p * CLUSTER + q;
          if (c >= W) break;
          const unsigned* rows = rows_of[q];
          const int nrows = min(32, K - 32 * c);
          if (CHUNKED) {
            // candidates: the chunk's rows < K not removed by earlier chunks
            unsigned cand = ~__shfl_sync(FULL, pick(removed, c >> 5), c & 31) &
                            (FULL >> (32 - nrows));
            unsigned kept = 0u;
            while (cand) {  // once per kept row, lowest row first
              const int r = __ffs(cand) - 1;
              kept |= 1u << r;
              cand &= ~(1u << r) & ~__shfl_sync(FULL, diag[q], r);
            }
            while (kept) {  // the kept rows' words join `removed`, two rows at a time
              const unsigned* a = rows + (__ffs(kept) - 1) * WS + lane;
              kept &= kept - 1u;
              const unsigned* b = kept ? rows + (__ffs(kept) - 1) * WS + lane : a;
              kept &= kept - 1u;
#pragma unroll
              for (int s = 0; s < RW; ++s)
                if (lane + 32 * s < W) removed[s] |= a[32 * s] | b[32 * s];
            }
          } else {
            unsigned buf[RW][32];   // word lane + 32s of chunk row r
            unsigned in_chunk[32];  // word c of chunk row r, in every lane
#pragma unroll
            for (int r = 0; r < 32; ++r) {
              in_chunk[r] = rows[r * WS + c];
#pragma unroll
              for (int s = 0; s < RW; ++s)
                buf[s][r] = lane + 32 * s < W ? rows[r * WS + lane + 32 * s] : 0u;
            }
            // one row per step; `cur`, the chunk's removed word, is shuffled
            // from its lane once and then kept up to date in every lane
            unsigned cur = __shfl_sync(FULL, pick(removed, c >> 5), c & 31);
#pragma unroll
            for (int r = 0; r < 32; ++r) {
              if (r >= nrows) break;
              const unsigned kept = ((cur >> r) & 1u) - 1u;  // all ones if row 32c + r is kept
              cur |= in_chunk[r] & kept;
#pragma unroll
              for (int s = 0; s < RW; ++s) removed[s] |= buf[s][r] & kept;
            }
          }
        }
      } else if (p + 1 < n_passes) {
        stage_pass(p + 1, 32, THREADS - 32);
      }
      __syncthreads();
    }
    if (tid < 32) {
#pragma unroll
      for (int s = 0; s < RW; ++s)
        if (tid + 32 * s < W) s_removed[tid + 32 * s] = removed[s];
    }
    __syncthreads();
  }
  // no CTA exits while rank 0 may still read its words
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < K; i += THREADS)
      keep[base + i] = (uint8_t)!((s_removed[i >> 5] >> (i & 31)) & 1u);
  }
}

template <int RW, bool CHUNKED>
cudaError_t launch(const float* x1, const float* x2, uint8_t* keep, int B, int K,
                   float thr, cudaStream_t s) {
  const int W = (K + 31) / 32;
  const int n_passes = (W + CLUSTER - 1) / CLUSTER;
  // the columns, rank 0's own chunks and two staged passes of the others'
  const size_t smem = (size_t)32 * W * sizeof(float4) +
                      (size_t)(n_passes + 2 * (CLUSTER - 1)) * 32 * (W | 1) * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(greedy_suppress_kernel<RW, CHUNKED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  greedy_suppress_kernel<RW, CHUNKED><<<CLUSTER * B, THREADS, smem, s>>>(x1, x2, keep, K, thr);
  return cudaGetLastError();
}

template <bool CHUNKED>
cudaError_t launch_rw(const float* x1, const float* x2, uint8_t* keep, int B, int K,
                      float thr, cudaStream_t s) {
  return K <= 1024 ? launch<1, CHUNKED>(x1, x2, keep, B, K, thr, s)
                   : launch<2, CHUNKED>(x1, x2, keep, B, K, thr, s);
}

__global__ void empty_kernel() {}

}  // namespace

// x1, x2: (B, K) float32 score-sorted bounds, contiguous. keep: (B, K) bytes
// (0/1). block: 32 (kernel 2, chunks of 32 rows) or 1 (kernel 3, row by
// row). 1 <= K <= 2048.
extern "C" int ayt_greedy_suppress(const void* x1, const void* x2, void* keep, int B,
                                   int K, float thr, int block, void* stream) {
  if (B <= 0 || K <= 0 || K > K_MAX || B > (1 << 30) / CLUSTER) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(x1);
  const float* b = static_cast<const float*>(x2);
  uint8_t* k = static_cast<uint8_t*>(keep);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (block == 32) return (int)launch_rw<true>(a, b, k, B, K, thr, s);
  if (block == 1) return (int)launch_rw<false>(a, b, k, B, K, thr, s);
  return (int)cudaErrorInvalidValue;
}

// An empty kernel on the given stream: the launch floor, timed through the
// same ctypes route as the kernels.
extern "C" int ayt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
