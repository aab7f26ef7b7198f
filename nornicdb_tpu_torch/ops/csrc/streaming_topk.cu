// Streaming packed-bin cosine top-k for Hopper (sm_90a), bf16 and int8.
//
// Replaces the Pallas TPU kernels in nornicdb_tpu/ops/pallas_kernels.py:
//   _streaming_topk_kernel       (bf16 GEMM, f32 accumulate)   -> streaming_topk_bf16_kernel
//   _streaming_topk_int8_kernel  (s8 x s8 -> s32 GEMM)         -> streaming_topk_i8_kernel
//
// What it computes (identical to the TPU kernels): corpus tile t, column j
// maps to bin (t % rows, q, j). Each score is biased (+3 valid / -3 masked),
// bitcast to int32, its low `tile_bits` bits replaced by the tile index t,
// and folded into the bin with an integer max. The (Q, N) score matrix never
// reaches device memory; the output is the (rows, Q, tile_n) int32 bin block.
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
// The product runs on the tensor cores through mma.sync (m16n8k16 bf16 with
// f32 accumulation; m16n8k32 s8 with s32 accumulation). Operand tiles are
// staged through registers into padded shared memory (rows of 80 bytes, so
// the fragment reads are free of bank conflicts); the next K chunk's global
// loads are issued before the current chunk's MMAs.
//
// Types and widths. The bf16 kernel reads a float32, bfloat16 or float16
// corpus (a template on the load type) and rounds each value to bf16 while
// staging it, as the TPU kernel casts its tile; the queries are float32.
// Any D works: where the width and the base pointers allow it, rows take
// 16-byte (int8, float32) or 8-byte (16-bit) vector loads; otherwise the
// host launches the kernel's instance that loads value by value (a template
// flag, so the vector instance carries no per-load branch). The K chunk past
// D is zero-filled, which adds nothing to the product.
//
// Bound on an H100 at the serving shape (N = 1M, D = 1024): operations at
// large Q (2*Q*N*D over the tensor-core peak), the corpus read (4 bytes a
// value for the f32-resident corpus, 1 for the int8 mirror) at small Q.
// This first version is simple: no TMA, no wgmma, no persistent CTAs.
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int BM = 128;       // queries per CTA
constexpr int BN = 128;       // tile columns per CTA
constexpr int THREADS = 256;  // 8 warps: 2 (queries) x 4 (columns), 64 x 32 each

// ---------------------------------------------------------------- bf16 ---
constexpr int BK = 32;          // f32 values per K chunk
constexpr int LDS = BK + 8;     // bf16 per shared row: 80 bytes

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// Four consecutive values from an address aligned to four of them.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));  // bf16 = high half of an f32
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One K chunk of a 128 x 32 operand as float: 1024 groups of 4, 4 per
// thread. VEC: every row starts on a four-value boundary (load4 applies).
template <bool VEC, typename T>
__device__ __forceinline__ void load_chunk(float4 (&r)[4], const T* __restrict__ base,
                                           long row0, long row_limit, int D, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 3;
    const int k = k0 + (idx & 7) * 4;
    const long grow = row0 + row;
    if (grow >= row_limit || k >= D) {
      r[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if constexpr (VEC) {
      r[i] = load4(base + grow * D + k);
    } else {
      const T* p = base + grow * D + k;
      r[i] = make_float4(to_f32(p[0]), k + 1 < D ? to_f32(p[1]) : 0.f,
                         k + 2 < D ? to_f32(p[2]) : 0.f, k + 3 < D ? to_f32(p[3]) : 0.f);
    }
  }
}

__device__ __forceinline__ void store_bf16_chunk(__nv_bfloat16* s, const float4 (&r)[4], int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx >> 3;
    const int c4 = idx & 7;
    uint2 v;
    v.x = pack_bf16x2(r[i].x, r[i].y);
    v.y = pack_bf16x2(r[i].z, r[i].w);
    *reinterpret_cast<uint2*>(s + row * LDS + c4 * 4) = v;
  }
}

template <typename C, bool VEC>
__global__ void __launch_bounds__(THREADS)
streaming_topk_bf16_kernel(const float* __restrict__ q, const C* __restrict__ c,
                           const uint8_t* __restrict__ valid, int* __restrict__ bins,
                           int Q, int D, int tile_n, int n_tiles, int rows, int tile_bits) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * LDS];

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
    const long col0 = (long)t * tile_n + cb * BN;  // corpus row of this CTA's column 0
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    float4 ra[4], rb[4];
    load_chunk<VEC>(ra, q, q0, Q, D, 0, tid);
    load_chunk<VEC>(rb, c, col0, col0 + BN, D, 0, tid);
    for (int k0 = 0; k0 < D; k0 += BK) {
      __syncthreads();  // the previous chunk's fragment reads are done
      store_bf16_chunk(As, ra, tid);
      store_bf16_chunk(Bs, rb, tid);
      __syncthreads();
      if (k0 + BK < D) {  // next chunk's loads in flight during the MMAs
        load_chunk<VEC>(ra, q, q0, Q, D, k0 + BK, tid);
        load_chunk<VEC>(rb, c, col0, col0 + BN, D, k0 + BK, tid);
      }
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const __nv_bfloat16* p = As + (wm * 64 + mi * 16 + g) * LDS + ks + t4 * 2;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* p = Bs + (wn * 32 + ni * 8 + g) * LDS + ks + t4 * 2;
          bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
          bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
      }
    }
    // epilogue: bias, bitcast, tile provenance, running max
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + ni * 8 + t4 * 2 + j;
        const float bias = valid[col0 + col] ? 3.f : -3.f;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = h * 2 + j;
            const int packed = (__float_as_int(__fadd_rn(acc[mi][ni][e], bias)) & keep) | t;
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

template <typename C>
int launch_bf16(const void* q, const void* c, const void* valid, void* bins, int Q, int D,
                int tile_n, int n_tiles, int rows, int tile_bits, int splits, cudaStream_t stream) {
  dim3 grid((Q + BM - 1) / BM, rows * (tile_n / BN), splits);
  const bool vec = rows_aligned(q, D, 4, 16) && rows_aligned(c, D, sizeof(C), 4 * sizeof(C));
  auto kernel = vec ? streaming_topk_bf16_kernel<C, true> : streaming_topk_bf16_kernel<C, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const C*>(c),
      static_cast<const uint8_t*>(valid), static_cast<int*>(bins), Q, D, tile_n, n_tiles, rows,
      tile_bits);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// Shapes are checked by the Python wrapper: tile_n % 128 == 0, n_tiles *
// tile_n == N, bins pre-filled with INT_MIN, all pointers device pointers of
// contiguous tensors. c_dtype names the bf16 kernel's corpus type: 0 float32,
// 1 bfloat16, 2 float16 (queries are float32).
extern "C" int nornic_streaming_topk_bf16(const void* q, const void* c, const void* valid,
                                          void* bins, int Q, int D, int tile_n, int n_tiles,
                                          int rows, int tile_bits, int splits, int c_dtype,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c_dtype) {
    case 0: return launch_bf16<float>(q, c, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, s);
    case 1: return launch_bf16<__nv_bfloat16>(q, c, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, s);
    case 2: return launch_bf16<__half>(q, c, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
