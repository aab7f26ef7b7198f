// Fused cosine scores for Hopper (sm_90a): (Q, D) x (N, D) -> (Q, N) float32.
//
// Replaces the Pallas TPU kernel _cosine_tile_kernel in
// nornicdb_tpu/ops/pallas_kernels.py (reached through fused_cosine_scores and
// fused_cosine_topk). What it computes:
//   out[q, n] = <queries[q], corpus[n]> * rsqrt(max(sum_d corpus[n, d]^2, 1e-24))
// in full float32: the queries come L2-normalized, each corpus row is
// normalized inside the kernel with the TPU kernel's clamp, so a zero row
// scores 0. The TPU kernel scales the row before the product; scaling the
// dot product after it moves a score by about one float32 ulp.
//
// Bound on an H100 at the serving shape (N = 1M, D = 1024): operations at
// Q = 1024 (2*Q*N*D over the 67 TFLOP/s float32 rate, 31 ms), the corpus
// read and the (Q, N) write at Q = 16 (1.24 ms). The product is float32 on
// the CUDA cores (FFMA), never TF32 (wgmma takes no float32 input): the
// callers hold the ids equal to an f32 scan, which TF32's three decimal
// digits would not keep.
//
// Design, a pipelined SIMT GEMM:
// - A CTA owns a (BM = 16 * TM queries x BN = 128 corpus rows) output tile
//   and walks D in stages of BK = 32. Each stage's query and corpus tiles
//   are 16-byte cp.async copies into a ring of STAGES = 4 slots in dynamic
//   shared memory: no staging through registers, one barrier a stage, and
//   the next three stages' copies in flight while one is multiplied. Edges
//   (rows past Q or N, dimensions past D) are zero-filled by the copy.
// - The tiles keep the layout they have in memory, rows with D contiguous,
//   padded by 16 bytes a row so that the float4 reads of 8 consecutive rows
//   hit 8 distinct bank groups. A thread owns TM query rows (ty + 16 i) and
//   8 corpus rows (tx + 16 j) and accumulates acc[i][j] += dot(q_i[k..k+3],
//   c_j[k..k+3]) from float4 fragments: 8 + TM shared loads for 32 * TM FMAs.
//   At TM <= 2 a warp spans 16 query rows and 2 corpus groups (else 2 query
//   rows and 16 corpus groups), so the 8 corpus loads of a step each read
//   2 distinct rows, not 16: the small tiles are bound by shared-memory
//   reads, the large ones by FMAs.
// - __launch_bounds__(256, 1): registers are not capped to fit two CTAs on
//   an SM. At TM = 8 a cap of 128 spilled in the inner loop, and one CTA
//   of 8 warps with 4 stages ran faster than two capped CTAs with 3.
// - The norm: each stage's corpus rows add their squares in a short pass
//   over the stage in shared memory (16 values a thread), so the corpus is
//   read from device memory once; the epilogue scales each column by its
//   inverse norm and streams the tile out.
// - bf16 / f16 corpora are copied raw and converted as the fragment is read.
// - The host picks TM in {1, 2, 4, 8} from Q, so a small batch computes no
//   padding rows; the q_tiles CTAs that share a corpus tile are consecutive
//   in the grid and read it while it is in L2.
// The 16-byte copies need 16-byte aligned rows: D * sizeof(T) and D * 4 a
// multiple of 16 and both base pointers aligned. The wrapper pads a copy of
// the operands with zero columns where they are not (ops/kernels.py
// _cosine_plan); zero columns change no dot product and no norm.
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;     // corpus rows per CTA
constexpr int BK = 32;      // dimensions per stage
constexpr int STAGES = 4;   // slots of the copy ring
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// one stage's tile of T: rows of BK values plus 16 bytes of padding
template <typename T>
struct Tile {
  static constexpr int LD = BK + 16 / static_cast<int>(sizeof(T));  // values a staged row
  static constexpr int ROW_BYTES = LD * static_cast<int>(sizeof(T));
  static constexpr int CHUNKS = BK * static_cast<int>(sizeof(T)) / 16;  // copies a row
  static constexpr int PER_CHUNK = 16 / static_cast<int>(sizeof(T));   // values a copy
};

template <int TM, typename T>
struct Layout {
  static constexpr int BM = 16 * TM;
  static constexpr int Q_BYTES = BM * Tile<float>::ROW_BYTES;
  static constexpr int STAGE_BYTES = Q_BYTES + BN * Tile<T>::ROW_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive staged values as float32
__device__ __forceinline__ float4 frag(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 frag(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 frag(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Start the copies of one stage (dimensions k0..k0+BK) into `stage`.
template <int TM, typename T>
__device__ __forceinline__ void load_stage(char* stage, const float* __restrict__ q,
                                           const T* __restrict__ c, int nq, int n, int d,
                                           int m0, long n0, int k0) {
  using L = Layout<TM, T>;
  using TQ = Tile<float>;
  using TC = Tile<T>;
  constexpr int QN = L::BM * TQ::CHUNKS, CN = BN * TC::CHUNKS;
  static_assert(CN % THREADS == 0, "whole corpus copies a thread");
#pragma unroll
  for (int it = 0; it < (QN + THREADS - 1) / THREADS; ++it) {
    const int id = threadIdx.x + it * THREADS;
    if (QN % THREADS != 0 && id >= QN) break;
    const int row = id / TQ::CHUNKS, kc = k0 + (id % TQ::CHUNKS) * TQ::PER_CHUNK;
    const bool in = m0 + row < nq && kc < d;
    copy16(stage + row * TQ::ROW_BYTES + (id % TQ::CHUNKS) * 16,
           in ? q + static_cast<long>(m0 + row) * d + kc : q, in);
  }
  char* cs = stage + L::Q_BYTES;
#pragma unroll
  for (int it = 0; it < CN / THREADS; ++it) {
    const int id = threadIdx.x + it * THREADS;
    const int row = id / TC::CHUNKS, kc = k0 + (id % TC::CHUNKS) * TC::PER_CHUNK;
    const bool in = n0 + row < n && kc < d;
    copy16(cs + row * TC::ROW_BYTES + (id % TC::CHUNKS) * 16,
           in ? c + (n0 + row) * d + kc : c, in);
  }
}

template <int TM, typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_cosine_kernel(const float* __restrict__ q, const T* __restrict__ c,
                    float* __restrict__ out, int nq, int n, int d, int q_tiles) {
  using L = Layout<TM, T>;
  using TQ = Tile<float>;
  using TC = Tile<T>;
  extern __shared__ __align__(16) char ring[];
  __shared__ float inv[BN];

  const int tid = threadIdx.x, lane = tid & 31, pair = (tid >> 5) * 2 + (lane >> 4);
  const int tx = TM <= 2 ? pair : lane & 15;  // corpus rows tx + 16 j
  const int ty = TM <= 2 ? lane & 15 : pair;  // query rows ty + 16 i
  const int m0 = (blockIdx.x % q_tiles) * L::BM;
  const long n0 = static_cast<long>(blockIdx.x / q_tiles) * BN;
  const int stages = (d + BK - 1) / BK;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ss = 0.f;  // sum of squares of corpus row tid / 2, half tid % 2 of each stage

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < stages) load_stage<TM, T>(ring + s * L::STAGE_BYTES, q, c, nq, n, d, m0, n0, s * BK);
    copy_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < stages; ++kt) {
    copy_wait<STAGES - 2>();  // this thread's copies of stage kt have landed
    __syncthreads();          // everyone's have, and stage kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < stages)
      load_stage<TM, T>(ring + (next % STAGES) * L::STAGE_BYTES, q, c, nq, n, d, m0, n0,
                        next * BK);
    copy_commit();
    const char* st = ring + (kt % STAGES) * L::STAGE_BYTES;
    const float* qs = reinterpret_cast<const float*>(st);
    const T* cs = reinterpret_cast<const T*>(st + L::Q_BYTES);

    const T* own = cs + (tid >> 1) * TC::LD + (tid & 1) * (BK / 2);
#pragma unroll
    for (int v = 0; v < BK / 2; v += 4) {
      const float4 x = frag(own + v);
      ss = fmaf(x.x, x.x, ss);
      ss = fmaf(x.y, x.y, ss);
      ss = fmaf(x.z, x.z, ss);
      ss = fmaf(x.w, x.w, ss);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = frag(cs + (tx + 16 * j) * TC::LD + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = frag(qs + (ty + 16 * i) * TQ::LD + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
  }

  ss += __shfl_xor_sync(FULL, ss, 1);
  if ((tid & 1) == 0) inv[tid >> 1] = rsqrtf(fmaxf(ss, 1e-24f));
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= nq) continue;
    float* o = out + static_cast<long>(m) * n + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (n0 + col < n) __stcs(o + col, acc[i][j] * inv[col]);
    }
  }
}

template <int TM, typename T>
int launch(const void* q, const void* c, void* out, int nq, int n, int d, cudaStream_t stream) {
  using L = Layout<TM, T>;
  const auto kernel = fused_cosine_kernel<TM, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (nq + L::BM - 1) / L::BM;
  const long ctas = static_cast<long>(q_tiles) * ((static_cast<long>(n) + BN - 1) / BN);
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(ctas), THREADS, L::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(c), static_cast<float*>(out), nq, n,
      d, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tm(int tm, const void* q, const void* c, void* out, int nq, int n, int d,
              cudaStream_t stream) {
  // the 16-byte copies: aligned bases, rows a multiple of 16 bytes
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c)) & 15) != 0 ||
      (d * sizeof(float)) % 16 != 0 || (d * sizeof(T)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tm) {
    case 1: return launch<1, T>(q, c, out, nq, n, d, stream);
    case 2: return launch<2, T>(q, c, out, nq, n, d, stream);
    case 4: return launch<4, T>(q, c, out, nq, n, d, stream);
    case 8: return launch<8, T>(q, c, out, nq, n, d, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// queries (nq, d) float32, corpus (n, d) of c_dtype (0 float32, 1 bfloat16,
// 2 float16), out (nq, n) float32, all contiguous; nq, n >= 1; both inputs
// 16-byte aligned with d * 4 and d * sizeof(corpus value) multiples of 16.
// tm in {1, 2, 4, 8} sets BM = 16 * tm query rows per CTA.
extern "C" int nornic_fused_cosine_scores(const void* q, const void* c, void* out, int nq, int n,
                                          int d, int c_dtype, int tm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c_dtype) {
    case 0: return launch_tm<float>(tm, q, c, out, nq, n, d, s);
    case 1: return launch_tm<__nv_bfloat16>(tm, q, c, out, nq, n, d, s);
    case 2: return launch_tm<__half>(tm, q, c, out, nq, n, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
