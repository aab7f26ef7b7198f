// Streaming packed-bin cosine top-k for Hopper (sm_90a), int8.
//
// Replaces the Pallas TPU kernel _streaming_topk_int8_kernel (s8 x s8 -> s32
// GEMM), launched by streaming_cosine_topk_int8 in
// nornicdb_tpu/ops/pallas_kernels.py. The bf16 kernel beside it is in
// streaming_topk_bf16.cu.
//
// What it computes (identical to the TPU kernel): corpus tile t, column j
// maps to bin (t % rows, q, j). Each score (the s32 product times the row's
// dequant multiplier) is biased (+3 valid / -3 masked), bitcast to int32,
// its low `tile_bits` bits replaced by the tile index t, and folded into the
// bin with an integer max. The (Q, N) score matrix never reaches device
// memory; the output is the (rows, Q, tile_n) int32 bin block.
//
// Design. On the TPU the grid walks the tiles in order into one VMEM bin
// block. Here a CTA owns a (bin row r, 128-query block, 128-column block)
// and loops over the logical tiles t = r, r + rows, ... that fold into its
// bins, keeping the running max in registers. The fold is an integer max,
// so it is order independent: to fill the card at small Q the tile loop of
// one bin row is split over gridDim.z CTAs, which merge their partial maxima
// with one int32 atomicMax per bin into a block pre-filled with INT_MIN.
// The result is deterministic whatever the split.
//
// The product runs on the tensor cores through mma.sync (m16n8k32 s8 with
// s32 accumulation). Operand tiles are staged through registers into padded
// shared memory (rows of 80 bytes, so the fragment reads are free of bank
// conflicts); the next K chunk's global loads start before the current
// chunk's MMAs. Any D works: where the width and the base pointers allow it,
// rows take 16-byte vector loads; otherwise the host launches the kernel's
// instance that loads value by value (a template flag, so the vector
// instance carries no per-load branch). The K chunk past D is zero-filled,
// which adds nothing to the product.
//
// Bound on an H100 at the serving shape (N = 1M, D = 1024): operations at
// large Q (2*Q*N*D over the int8 tensor-core peak), the int8 corpus read at
// small Q. Still the first version: mma.sync through registers, no TMA, no
// wgmma (its redesign is the next item of the queue; it can share the bf16
// kernel's pipeline).
//
// Plain C interface (loaded with ctypes). The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int BM = 128;       // queries per CTA
constexpr int BN = 128;       // tile columns per CTA
constexpr int THREADS = 256;  // 8 warps: 2 (queries) x 4 (columns), 64 x 32 each

// ---------------------------------------------------------------- int8 ---
constexpr int BK8 = 64;          // int8 values per K chunk
constexpr int LDS8 = BK8 + 16;   // bytes per shared row: 80

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K chunk of a 128 x 64 int8 operand: 512 groups of 16, 2 per thread.
// VEC: every row starts on a 16-byte boundary.
template <bool VEC>
__device__ __forceinline__ void load_i8_chunk(int4 (&r)[2], const int8_t* __restrict__ base,
                                              long row0, long row_limit, int D, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 2;
    const int k = k0 + (idx & 3) * 16;
    const long grow = row0 + row;
    if (grow >= row_limit || k >= D) {
      r[i] = make_int4(0, 0, 0, 0);
    } else if constexpr (VEC) {
      r[i] = __ldg(reinterpret_cast<const int4*>(base + grow * D + k));
    } else {  // little endian: the value at the lowest address is the low byte
      const uint8_t* p = reinterpret_cast<const uint8_t*>(base + grow * D + k);
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + j * 4 + b < D) w[j] |= uint32_t(p[j * 4 + b]) << (8 * b);
      }
      r[i] = make_int4(int(w[0]), int(w[1]), int(w[2]), int(w[3]));
    }
  }
}

__device__ __forceinline__ void store_i8_chunk(int8_t* s, const int4 (&r)[2], int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;
    *reinterpret_cast<int4*>(s + (idx >> 2) * LDS8 + (idx & 3) * 16) = r[i];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
streaming_topk_i8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ c,
                         const float* __restrict__ c_scale, const uint8_t* __restrict__ valid,
                         int* __restrict__ bins, int Q, int D, int tile_n, int n_tiles,
                         int rows, int tile_bits) {
  __shared__ __align__(16) int8_t As[BM * LDS8];
  __shared__ __align__(16) int8_t Bs[BN * LDS8];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int col_blocks = tile_n / BN;
  const int r = blockIdx.y / col_blocks;
  const int cb = blockIdx.y % col_blocks;
  const int keep = -(1 << tile_bits);

  int best[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) best[mi][ni][e] = INT_MIN;

  for (int t = r + blockIdx.z * rows; t < n_tiles; t += rows * gridDim.z) {
    const long col0 = (long)t * tile_n + cb * BN;
    int acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    int4 ra[2], rb[2];
    load_i8_chunk<VEC>(ra, q, q0, Q, D, 0, tid);
    load_i8_chunk<VEC>(rb, c, col0, col0 + BN, D, 0, tid);
    for (int k0 = 0; k0 < D; k0 += BK8) {
      __syncthreads();
      store_i8_chunk(As, ra, tid);
      store_i8_chunk(Bs, rb, tid);
      __syncthreads();
      if (k0 + BK8 < D) {
        load_i8_chunk<VEC>(ra, q, q0, Q, D, k0 + BK8, tid);
        load_i8_chunk<VEC>(rb, c, col0, col0 + BN, D, k0 + BK8, tid);
      }
#pragma unroll
      for (int ks = 0; ks < BK8; ks += 32) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int8_t* p = As + (wm * 64 + mi * 16 + g) * LDS8 + ks + t4 * 4;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS8);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS8 + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* p = Bs + (wn * 32 + ni * 8 + g) * LDS8 + ks + t4 * 4;
          bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
          bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
    }
    // epilogue: (acc * (1 / c_scale or 0)) + bias as two rounded operations
    // (never contracted into an FMA), so the bins are bit-identical to the
    // plain version's separate multiply and add
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long n = col0 + wn * 32 + ni * 8 + t4 * 2 + j;
        const bool ok = valid[n] != 0;
        const float scale = ok ? __fdiv_rn(1.f, c_scale[n]) : 0.f;
        const float bias = ok ? 3.f : -3.f;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = h * 2 + j;
            const float biased = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][e]), scale), bias);
            const int packed = (__float_as_int(biased) & keep) | t;
            best[mi][ni][e] = max(best[mi][ni][e], packed);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qrow = q0 + wm * 64 + mi * 16 + g + h * 8;
      if (qrow >= Q) continue;
      int* out = bins + ((long)r * Q + qrow) * tile_n + cb * BN;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          atomicMax(out + wn * 32 + ni * 8 + t4 * 2 + j, best[mi][ni][h * 2 + j]);
    }
  }
}

}  // namespace

namespace {
// Rows of a (rows, D) operand at `p` all start on a `bytes` boundary.
bool rows_aligned(const void* p, int D, int elem, int bytes) {
  return (static_cast<long>(D) * elem) % bytes == 0 && reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Shapes are checked by the Python wrapper: tile_n % 128 == 0, n_tiles *
// tile_n == N, bins pre-filled with INT_MIN, all pointers device pointers of
// contiguous tensors.
extern "C" int nornic_streaming_topk_i8(const void* q, const void* c, const void* c_scale,
                                        const void* valid, void* bins, int Q, int D, int tile_n,
                                        int n_tiles, int rows, int tile_bits, int splits,
                                        void* stream) {
  dim3 grid((Q + BM - 1) / BM, rows * (tile_n / BN), splits);
  const bool vec = rows_aligned(q, D, 1, 16) && rows_aligned(c, D, 1, 16);
  auto kernel = vec ? streaming_topk_i8_kernel<true> : streaming_topk_i8_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(c),
      static_cast<const float*>(c_scale), static_cast<const uint8_t*>(valid),
      static_cast<int*>(bins), Q, D, tile_n, n_tiles, rows, tile_bits);
  return static_cast<int>(cudaGetLastError());
}
