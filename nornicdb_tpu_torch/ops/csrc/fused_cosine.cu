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
// Design. The product is float32 on the CUDA cores (FFMA), never TF32: the
// reference multiplies in float32 and its callers hold the ids equal to an
// f32 scan, which three decimal digits would not keep. A CTA owns a
// (BM queries x 128 corpus rows) output tile and walks D in chunks of 32:
// each warp loads 16 corpus rows and BM / 8 query rows of the chunk, lane j
// taking dimension j (coalesced, any D, any alignment, ragged edges
// zero-filled), and stores them transposed into padded shared memory. The
// next chunk's loads are issued before the current chunk's products. Each
// thread keeps a TM x 8 block of outputs in registers (rows ty*TM.., columns
// 4*tx.. and 64 + 4*tx..), read from shared memory as float4s. The sum of
// squares of every corpus row is taken from the same staged values, so the
// corpus is read once: each lane sums its dimensions, a warp shuffle ends
// the row's sum, and the epilogue multiplies each column by its inverse norm.
// BM = 16 * TM; the host picks TM in {1, 2, 4, 8} from Q, so a small batch
// does not compute 128 query rows of padding.
//
// Bound on an H100 at the serving shape (N = 1M, D = 1024): operations at
// Q = 1024 (2*Q*N*D over the 67 TFLOP/s float32 rate, 31 ms), the corpus
// read and the (Q, N) write at Q = 16 (1.24 ms). This first version is
// simple: no TMA, no async copies, no persistent CTAs.
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int BN = 128;            // corpus rows per CTA
constexpr int BK = 32;             // dimensions per chunk (one per lane)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CROWS = BN / WARPS;  // corpus rows each warp stages per chunk
constexpr int LDC = BN + 4;        // shared row of the corpus tile (16-byte aligned)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// One chunk's values of this thread: dimension k0 + lane of corpus rows
// n0 + warp + WARPS * i and query rows m0 + warp + WARPS * i.
template <int QROWS, typename T>
__device__ __forceinline__ void load_chunk(float (&cr)[CROWS], float (&qr)[QROWS],
                                           const float* __restrict__ q, const T* __restrict__ c,
                                           int nq, int n, int d, long n0, int m0, int k0,
                                           int warp, int lane) {
  const int k = k0 + lane;
  const bool kin = k < d;
#pragma unroll
  for (int i = 0; i < CROWS; ++i) {
    const long row = n0 + warp + WARPS * i;
    cr[i] = (kin && row < n) ? to_f32(c[row * d + k]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < QROWS; ++i) {
    const int m = m0 + warp + WARPS * i;
    qr[i] = (kin && m < nq) ? __ldg(q + static_cast<long>(m) * d + k) : 0.f;
  }
}

template <int TM, typename T>
__global__ void __launch_bounds__(THREADS)
fused_cosine_kernel(const float* __restrict__ q, const T* __restrict__ c,
                    float* __restrict__ out, int nq, int n, int d, int q_tiles) {
  constexpr int BM = 16 * TM;
  constexpr int QROWS = BM / WARPS;
  constexpr int LDQ = BM + 4;
  __shared__ __align__(16) float qs[BK * LDQ];
  __shared__ __align__(16) float cs[BK * LDC];
  __shared__ float inv[BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = (blockIdx.x % q_tiles) * BM;
  const long n0 = static_cast<long>(blockIdx.x / q_tiles) * BN;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ss[CROWS];
#pragma unroll
  for (int i = 0; i < CROWS; ++i) ss[i] = 0.f;

  float cr[CROWS], qr[QROWS];
  load_chunk<QROWS>(cr, qr, q, c, nq, n, d, n0, m0, 0, warp, lane);
  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < CROWS; ++i) {
      cs[lane * LDC + warp + WARPS * i] = cr[i];
      ss[i] = fmaf(cr[i], cr[i], ss[i]);
    }
#pragma unroll
    for (int i = 0; i < QROWS; ++i) qs[lane * LDQ + warp + WARPS * i] = qr[i];
    __syncthreads();
    if (k0 + BK < d) load_chunk<QROWS>(cr, qr, q, c, nq, n, d, n0, m0, k0 + BK, warp, lane);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[8];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(qs + kk * LDQ + ty * TM + i);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = qs[kk * LDQ + ty * TM + i];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(cs + kk * LDC + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(cs + kk * LDC + 64 + 4 * tx);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // each row's sum of squares: the lanes hold one dimension in 32 each
#pragma unroll
  for (int i = 0; i < CROWS; ++i) {
    float s = ss[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) inv[warp + WARPS * i] = rsqrtf(fmaxf(s, 1e-24f));
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= nq) continue;
    float* o = out + static_cast<long>(m) * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? 0 : 64) + 4 * tx + (j & 3);
      const long gcol = n0 + col;
      if (gcol < n) o[gcol] = acc[i][j] * inv[col];
    }
  }
}

template <int TM, typename T>
int launch(const void* q, const void* c, void* out, int nq, int n, int d, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const int q_tiles = (nq + BM - 1) / BM;
  const long ctas = static_cast<long>(q_tiles) * ((static_cast<long>(n) + BN - 1) / BN);
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_cosine_kernel<TM, T><<<static_cast<unsigned>(ctas), THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(c), static_cast<float*>(out), nq, n,
      d, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tm(int tm, const void* q, const void* c, void* out, int nq, int n, int d,
              cudaStream_t stream) {
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
// 2 float16), out (nq, n) float32, all contiguous; nq, n >= 1. tm in
// {1, 2, 4, 8} sets BM = 16 * tm query rows per CTA.
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
