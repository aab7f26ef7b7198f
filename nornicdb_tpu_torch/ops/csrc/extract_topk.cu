// Exact top-k extraction over packed bins for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _extract_topk_kernel in
// nornicdb_tpu/ops/pallas_kernels.py (reached through _topk_bins with
// epilogue="pallas"). What it computes: for each query row of the (Q, B)
// int32 bin matrix, k rounds of (argmax -> record -> mask that bin), the
// argmax breaking ties by the lowest bin index, exactly as the TPU kernel's
// first-occurrence rule and lax.top_k do. Outputs are (Q, kpad) values and
// bin ids; columns k..kpad-1 hold INT_MIN / 0 as on the TPU.
//
// Design: one CTA per query row holds the row's B bins in shared memory
// (8 KB at B = 2048), so the k rounds never touch device memory. A round is
// a strided scan per thread, a warp shuffle reduction and one reduction
// across the warps. Bound: the (Q, B) read and the (Q, kpad) writes; the k
// rounds of B compares are far below the card's integer rate.
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;

// (v, i) beats (bv, bi): larger value, or equal value at a lower index
__device__ __forceinline__ bool better(int v, int i, int bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
extract_topk_kernel(const int* __restrict__ flat, int* __restrict__ out_v,
                    int* __restrict__ out_i, int B, int k, int kpad) {
  extern __shared__ int s[];
  __shared__ int red_v[THREADS / 32], red_i[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long row = blockIdx.x;
  const int* src = flat + row * B;
  for (int i = tid; i < B; i += THREADS) s[i] = src[i];
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    int bv = INT_MIN, bi = INT_MAX;
    for (int i = tid; i < B; i += THREADS) {
      const int v = s[i];
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < THREADS / 32; ++w)
        if (better(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
      out_v[row * kpad + j] = bv;
      out_i[row * kpad + j] = bi;
      s[bi] = INT_MIN;  // mask the first occurrence; ties stay for later rounds
    }
    __syncthreads();
  }
  for (int j = k + tid; j < kpad; j += THREADS) {
    out_v[row * kpad + j] = INT_MIN;
    out_i[row * kpad + j] = 0;
  }
}

}  // namespace

// The wrapper checks 1 <= k <= B, k <= kpad and B * 4 <= 227 KB of shared memory.
extern "C" int nornic_extract_topk(const void* flat, void* out_v, void* out_i, int Q, int B,
                                   int k, int kpad, void* stream) {
  const size_t smem = static_cast<size_t>(B) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        extract_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  extract_topk_kernel<<<Q, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flat), static_cast<int*>(out_v), static_cast<int*>(out_i), B, k,
      kpad);
  return static_cast<int>(cudaGetLastError());
}
