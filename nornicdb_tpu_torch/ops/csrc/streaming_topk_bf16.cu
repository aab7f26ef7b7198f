// Streaming packed-bin cosine top-k for Hopper (sm_90a), bf16 products.
//
// Replaces the Pallas TPU kernel _streaming_topk_kernel (bf16 GEMM, float32
// accumulation), launched by streaming_cosine_topk in
// nornicdb_tpu/ops/pallas_kernels.py. The int8 kernel beside it is in
// streaming_topk.cu.
//
// What it computes (identical to the TPU kernel): corpus tile t, column j
// maps to bin (t % rows, q, j). Each score is biased (+3 valid / -3 masked)
// with one float32 add, bitcast to int32, its low `tile_bits` bits replaced
// by the tile index t, and folded into the bin with an integer max. The
// (Q, N) score matrix never reaches device memory; the output is the
// (rows, Q, tile_n) int32 bin block.
//
// Bound on an H100 at the serving shape (N = 1,000,064, D = 1024, a float32
// corpus): operations at Q = 1024 (2*Q*N*D at the bf16 tensor-core rate,
// 2.1 ms), the corpus read at Q = 16 (4 bytes a value, 1.2 ms). What this
// design meets in practice at Q = 1024 is L2: the 8 query blocks of a tile
// read it from L2 four times, the queries are read again for every tile
// (see PERF.md).
//
// Design.
// - The queries are rounded to bf16 once a call by a small pass
//   (round_queries_kernel) into a buffer the wrapper allocates, already in
//   the layout the tensor cores read: one (NQ queries x 64 values) block for
//   each query block and 64-deep K chunk, cut into 8 x 8 "core matrices" of
//   16 bytes a row (wgmma's K-major layout without swizzle). Values past D
//   and queries past Q are zeros.
// - The corpus is the wgmma A operand, from registers. A CTA owns (bin row,
//   query block, 128 corpus rows of the tile) and loops over the tiles that
//   fold into its bins. Two consumer warpgroups take 64 corpus rows each;
//   the queries are the B operand, NQ wide (8, 16, 32, 64 or 128, sized to
//   Q), so a small batch multiplies only its own rows. The accumulator comes
//   out as (corpus rows x queries): the bias, the tile provenance and the
//   bin index apply to its transpose, and the running maxima stay in
//   registers for the whole tile loop.
// - A producer thread keeps a ring of 64-deep K chunks full with the TMA
//   engine: the chunk's 128 corpus rows as one or two boxes of the
//   corpus's tensor map (128 rows x 128 bytes each, in the corpus's own
//   type, 128-byte swizzled; a box past D is zero-filled), and the query
//   block's chunk as one bulk copy, signalled by an mbarrier; consumers free
//   a stage with a second one. The consumers round each float32 chunk to
//   bf16 on its way from shared memory into the A fragments (round to
//   nearest even, as the TPU kernel's astype(bf16)). Within each 16-deep
//   step the K order is permuted (physical_k) so that a thread reads its
//   four values with one vector load and the loads of a quarter warp
//   (float32) or half warp (16-bit) hit distinct banks of the swizzled
//   rows; the query buffer holds the same permutation, so every product
//   pairs the same k. One TMA request moves 16 KB: a first form of this
//   kernel that copied each corpus row with a bulk copy of its own (129
//   requests a chunk) ran at a fixed ~4 us a chunk whatever Q, 2x slower
//   than the first version (chip runs, PERF.md).
// - The corpus is read from device memory once a call: the CTAs of the
//   different query blocks of one tile are adjacent in the grid (blockIdx.x),
//   so they run together and the later ones find the tile in L2. Pairs of
//   them form a cluster that shares each chunk: each CTA copies half its
//   rows into both (TMA multicast), halving the corpus's reads from L2.
//   Clusters of 4 ran slower (a CTA fills an SM, and clusters of 4 leave
//   SMs of a GPC idle).
// - The fold is unchanged: CTAs of one bin row split its tile loop (gridDim.z)
//   and merge their maxima with one int32 atomicMax a bin into the
//   INT32_MIN-filled block. The result is deterministic whatever the split.
//
// The corpus is float32, bfloat16 or float16 (a template on its type); its
// rows start on 16-byte boundaries, as a tensor map needs (the wrapper
// copies a corpus whose width or base does not allow it, zero-padded, to
// the same kernel). Any D works.
//
// Plain C interface (loaded with ctypes). The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                   // corpus rows a CTA: two warpgroups of 64
constexpr int BK = 64;                    // values a K chunk
constexpr int CONSUMERS = 256;            // the two warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int MAX_STAGES = 8;
constexpr int BARRIER_BYTES = 2 * MAX_STAGES * 8;  // full[], then empty[]
constexpr int ALIGN = 1024;  // a 128-byte-swizzled TMA box starts on 1,024 bytes

// One K chunk of the 128 corpus rows in the ring: BK values a row in the
// corpus's type, as TMA boxes of 128-byte rows (32 float32 or 64 16-bit
// values), each box's 16-byte pieces swizzled by the row (piece c of row r
// at c ^ (r % 8)), so the fragment loads of 8 rows hit distinct banks.
template <typename C> __host__ __device__ constexpr int box_values() {
  return 128 / static_cast<int>(sizeof(C));
}
template <typename C> __host__ __device__ constexpr int cchunk_bytes() {
  return BM * BK * static_cast<int>(sizeof(C));
}
// one query block's K chunk, bf16
template <int NQ> __host__ __device__ constexpr int qchunk_bytes() { return NQ * BK * 2; }

// dynamic shared memory: alignment slack, the corpus ring, the query ring,
// the barriers
template <typename C, int NQ>
constexpr int smem_bytes(int stages) {
  return ALIGN + stages * (cchunk_bytes<C>() + qchunk_bytes<NQ>()) + BARRIER_BYTES;
}

// The physical value (0..63 of a K chunk) that thread t4's register a_i
// takes in 16-deep step ks: a0 = (logical 2*t4, 2*t4+1), a2 = (2*t4+8,
// 2*t4+9) of the step (i = 0, 1, 2, 3 in that order). float32: four values
// (16 bytes) of piece 2*t4 + ks % 2 of box ks / 2; 16-bit: four values
// (8 bytes) of half t4 % 2 of piece ks + 4 * (t4 / 2). Either way a
// quarter (float32) or half (16-bit) warp reads distinct banks.
__host__ __device__ __forceinline__ int physical_k(bool wide, int ks, int t4, int i) {
  return wide ? 32 * (ks >> 1) + 4 * (2 * t4 + (ks & 1)) + i
              : 8 * (ks + 4 * (t4 >> 1)) + 4 * (t4 & 1) + i;
}

// Keep the A fragments live and in place (hopper.cuh's hold for their type).
__device__ __forceinline__ void hold(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma's shared-memory matrix descriptor, K-major without swizzle: 8 x 16-byte
// core matrices; `lbo` bytes between core matrices along K, `sbo` bytes
// between groups of 8 rows along N
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half, round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one 16-deep step from two ring rows (g and g + 8 of the
// warp's 16), at the pieces physical_k names: a0, a1 hold logical k 2*t4,
// 2*t4 + 1 of rows g, g + 8; a2, a3 logical k 2*t4 + 8, 2*t4 + 9.
__device__ __forceinline__ uint32_t half2_to_bf16x2(uint32_t h) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
  return pack_bf16x2(f.x, f.y);
}
template <typename C>
__device__ __forceinline__ void load_frag(uint32_t (&a)[4], const unsigned char* p0,
                                          const unsigned char* p1) {
  if constexpr (sizeof(C) == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p0);
    const float4 y = *reinterpret_cast<const float4*>(p1);
    a[0] = pack_bf16x2(x.x, x.y);
    a[1] = pack_bf16x2(y.x, y.y);
    a[2] = pack_bf16x2(x.z, x.w);
    a[3] = pack_bf16x2(y.z, y.w);
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p0);
    const uint2 y = *reinterpret_cast<const uint2*>(p1);
    if constexpr (std::is_same_v<C, __half>) {
      a[0] = half2_to_bf16x2(x.x);
      a[1] = half2_to_bf16x2(y.x);
      a[2] = half2_to_bf16x2(x.y);
      a[3] = half2_to_bf16x2(y.y);
    } else {
      a[0] = x.x;
      a[1] = y.x;
      a[2] = x.y;
      a[3] = y.y;
    }
  }
}
// Byte offset of thread (g, t4)'s piece in step ks, from the start of its
// row in the stage (rows of box b lie at b * BM * 128 + row * 128).
template <typename C>
__device__ __forceinline__ int frag_offset(int ks, int g, int t4) {
  if constexpr (sizeof(C) == 4) {
    return (ks >> 1) * (BM * 128) + (((2 * t4 + (ks & 1)) ^ g) << 4);
  } else {
    return (((ks + 4 * (t4 >> 1)) ^ g) << 4) + ((t4 & 1) << 3);
  }
}

// wgmma m64nNk16, A (corpus, bf16) from registers, B (queries, bf16) from
// shared memory, float32 accumulators; scale_d == 0 starts a new sum.
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  __device__ __forceinline__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};
template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// Queries rounded to bf16 once a call, in the order the tensor cores read
// them: for each query block and K chunk, core matrices [k8][n8] of
// 8 queries x 8 values, the K order within each 16-deep step that of
// physical_k (wide: a float32 corpus). Zeros past Q and past D.
__global__ void round_queries_kernel(const float* __restrict__ q, __nv_bfloat16* __restrict__ out,
                                     int Q, int D, int kchunks, int nq, bool wide, long total) {
  const int groups = nq >> 3;
  const int chunk = nq * BK;
  for (long o = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; o < total;
       o += static_cast<long>(gridDim.x) * blockDim.x) {
    const long cidx = o / chunk;  // query block * kchunks + K chunk
    int w = static_cast<int>(o - cidx * chunk);
    const int e = w & 7;
    w >>= 3;
    const int nr = w & 7;
    w >>= 3;
    const int ng = w % groups, k8 = w / groups;
    const int n = static_cast<int>(cidx / kchunks) * nq + ng * 8 + nr;
    const int j = (k8 & 1) * 8 + e;  // logical k within the 16-deep step k8 / 2
    const int k = static_cast<int>(cidx % kchunks) * BK +
                  physical_k(wide, k8 >> 1, (j & 7) >> 1, 2 * (j >> 3) + (j & 1));
    out[o] = __float2bfloat16_rn(n < Q && k < D ? q[static_cast<long>(n) * D + k] : 0.f);
  }
}

// One K chunk of the consumer loop, A the fragment registers it fills, B the
// other set (read by the previous chunk's wgmmas until the wait below).
#define CONSUME_CHUNK(A, B)                                                              \
  {                                                                                      \
    const int s = it % stages;                                                           \
    const int kc = it % kchunks;                                                         \
    if (kc == 0) { /* this tile's index and its rows' biases, read early */              \
      t = first + (it / kchunks) * step;                                                 \
      const long col0 = static_cast<long>(t) * tile_n + cb * BM + row_a;                 \
      v0 = valid[col0];                                                                  \
      v1 = valid[col0 + 8];                                                              \
    }                                                                                    \
    mbar_wait(full_bar + 8 * s, (it / stages) & 1);                                      \
    __syncwarp(); /* converged for the .aligned wgmma instructions */                    \
    const unsigned char* r0 = ring_c + s * cchunk_bytes<C>() + row_a * 128;              \
    _Pragma("unroll") for (int ks = 0; ks < 4; ++ks)                                     \
        load_frag<C>(A[ks], r0 + frag_offset<C>(ks, g, t4),                              \
                     r0 + 8 * 128 + frag_offset<C>(ks, g, t4));                          \
    const uint32_t qaddr = q_ring + s * qchunk_bytes<NQ>();                              \
    wgmma_fence();                                                                       \
    hold(acc);                                                                           \
    _Pragma("unroll") for (int ks = 0; ks < 4; ++ks)                                     \
        Wgmma<NQ>::mma(acc, A[ks], kmajor_desc(qaddr + ks * 2 * (NQ / 8) * 128, (NQ / 8) * 128, 128), \
                       kc | ks);                                                         \
    wgmma_commit();                                                                      \
    hold(acc);                                                                           \
    if (kc == kchunks - 1) { /* the tile is summed: fold it */                          \
      wgmma_wait<0>();                                                                   \
      hold(acc);                                                                         \
      hold(A);                                                                           \
      hold(B);                                                                           \
      __syncwarp();                                                                      \
      if (lane < csize) { /* free in this CTA: one arrival at each producer */          \
        if (pending >= 0) mbar_arrive_cluster(empty_bar + 8 * pending, lane);            \
        mbar_arrive_cluster(empty_bar + 8 * s, lane);                                    \
      }                                                                                  \
      pending = -1;                                                                      \
      const float b0 = v0 ? 3.f : -3.f, b1 = v1 ? 3.f : -3.f;                            \
      _Pragma("unroll") for (int i = 0; i < NQ / 2; ++i) {                               \
        const int packed =                                                               \
            (__float_as_int(__fadd_rn(acc[i], (i >> 1) & 1 ? b1 : b0)) & keep) | t;      \
        best[i] = max(best[i], packed);                                                  \
      }                                                                                  \
    } else { /* the previous chunk's wgmmas are done: free its stage */                 \
      wgmma_wait<1>();                                                                   \
      hold(acc);                                                                         \
      hold(B);                                                                           \
      __syncwarp();                                                                      \
      if (lane < csize && pending >= 0) mbar_arrive_cluster(empty_bar + 8 * pending, lane); \
      pending = s;                                                                       \
    }                                                                                    \
  }

// grid (query blocks, rows * tile_n / BM, splits) in clusters of (CL, 1, 1)
// query blocks; THREADS threads; smem_bytes<C, NQ>(stages) of dynamic
// shared memory. `cmap` is the corpus's (N, D) tensor map: boxes of BM / CL
// rows x 128 bytes, swizzled. The CTAs of a cluster read the same corpus
// chunks: each copies its BM / CL rows of a chunk into all of them (TMA
// multicast), and a stage is refilled only once every CTA of the cluster
// has freed it.
template <typename C, int NQ>
__global__ void __launch_bounds__(THREADS, 1)
streaming_topk_bf16_kernel(const __grid_constant__ CUtensorMap cmap,
                           const __nv_bfloat16* __restrict__ qbuf,
                           const uint8_t* __restrict__ valid, int* __restrict__ bins, int Q, int D,
                           int tile_n, int n_tiles, int rows, int tile_bits, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring_c = smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* bars = ring_c + stages * (cchunk_bytes<C>() + qchunk_bytes<NQ>());
  const uint32_t q_ring = smem_addr(ring_c + stages * cchunk_bytes<C>());
  const uint32_t full_bar = smem_addr(bars), empty_bar = full_bar + 8 * MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int csize = static_cast<int>(cluster_size()), crank = static_cast<int>(cluster_rank());
  const int col_blocks = tile_n / BM;
  const int r = blockIdx.y / col_blocks, cb = blockIdx.y % col_blocks;
  const int kchunks = (D + BK - 1) / BK;
  // this CTA's tiles: first, first + step, ... (< n_tiles)
  const int first = r + blockIdx.z * rows, step = rows * gridDim.z;
  const int my_tiles = first < n_tiles ? (n_tiles - 1 - first) / step + 1 : 0;
  const int total = my_tiles * kchunks;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS / 32 * csize);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&cmap)) : "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before a copy or arrival reaches them

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread keeps the ring full, a few TMA copies a chunk
    if (lane == 0) {
      for (int it = 0; it < total; ++it) {
        const int s = it % stages;
        const int ti = it / kchunks, kc = it - ti * kchunks;
        const int slice = BM / csize;  // the rows this CTA copies for the whole cluster
        const int col0 = (first + ti * step) * tile_n + cb * BM + crank * slice;
        const uint32_t dst = smem_addr(ring_c + s * cchunk_bytes<C>()) + crank * slice * 128;
        mbar_wait(empty_bar + 8 * s, ((it / stages) & 1) ^ 1);
        // the whole chunk lands here, a slice from each CTA of the cluster; a
        // box past D is zero-filled by the TMA engine and counts in full
        mbar_expect_tx(full_bar + 8 * s, cchunk_bytes<C>() + qchunk_bytes<NQ>());
#pragma unroll
        for (int b = 0; b < BK / box_values<C>(); ++b)
          tma_load_2d_multicast(dst + b * (BM * 128), &cmap, kc * BK + b * box_values<C>(), col0,
                                full_bar + 8 * s, static_cast<uint16_t>((1u << csize) - 1));
        bulk_copy(q_ring + s * qchunk_bytes<NQ>(),
                  qbuf + (static_cast<long>(blockIdx.x) * kchunks + kc) * (NQ * BK),
                  qchunk_bytes<NQ>(), full_bar + 8 * s);
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes ring rows 64 * wg .. 64 * wg + 63
    const int g = lane >> 2, t4 = lane & 3;
    const int row_a = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // a0's row; a1's is row_a + 8
    const int keep = -(1 << tile_bits);
    float acc[NQ / 2];
    int best[NQ / 2];
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      acc[i] = 0.f;
      best[i] = INT_MIN;
    }
    uint32_t fa[4][4], fb[4][4];
    int pending = -1, t = first;
    uint8_t v0 = 0, v1 = 0;
    for (int it = 0; it < total; ++it) {
      CONSUME_CHUNK(fa, fb)
      if (++it >= total) break;
      CONSUME_CHUNK(fb, fa)
    }
    if (my_tiles > 0) {
#pragma unroll
      for (int i = 0; i < NQ / 2; ++i) {
        const int qrow = blockIdx.x * NQ + (i >> 2) * 8 + t4 * 2 + (i & 1);
        if (qrow < Q)
          atomicMax(bins + (static_cast<long>(r) * Q + qrow) * tile_n + cb * BM + row_a +
                        ((i >> 1) & 1) * 8,
                    best[i]);
      }
    }
  }
  // no CTA leaves while the others may still copy into or arrive on it
  __syncwarp();
  cluster_sync();
}
#undef CONSUME_CHUNK

template <typename C> CUtensorMapDataType tma_type();
template <> CUtensorMapDataType tma_type<float>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
template <> CUtensorMapDataType tma_type<__nv_bfloat16>() { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
template <> CUtensorMapDataType tma_type<__half>() { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

template <typename C, int NQ>
int launch(const float* q, const void* c, const void* valid, void* qbuf, void* bins, int Q,
           int Dq, int D, int tile_n, int n_tiles, int rows, int tile_bits, int splits, int stages,
           int cluster, cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap cmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(n_tiles) * tile_n};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * sizeof(C)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_values<C>()),
                             static_cast<cuuint32_t>(BM / cluster)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&cmap, tma_type<C>(), 2, const_cast<void*>(c), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int qblocks = (Q + NQ - 1) / NQ;
  const int kchunks = (D + BK - 1) / BK;
  const long total = static_cast<long>(qblocks) * kchunks * NQ * BK;
  const int rgrid = static_cast<int>(min((total + 255) / 256, 4096L));
  round_queries_kernel<<<rgrid, 256, 0, stream>>>(q, static_cast<__nv_bfloat16*>(qbuf), Q, Dq,
                                                  kchunks, NQ, sizeof(C) == 4, total);
  auto kernel = streaming_topk_bf16_kernel<C, NQ>;
  const int smem = smem_bytes<C, NQ>(stages);
  static int allowed = 48 * 1024;  // dynamic shared memory this instance may take
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(qblocks, rows * (tile_n / BM), splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, cmap, static_cast<const __nv_bfloat16*>(qbuf),
      static_cast<const uint8_t*>(valid), static_cast<int*>(bins), Q, D, tile_n, n_tiles, rows,
      tile_bits, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename C>
int launch_nq(int nq, const float* q, const void* c, const void* valid, void* qbuf, void* bins,
              int Q, int Dq, int D, int tile_n, int n_tiles, int rows, int tile_bits, int splits,
              int stages, int cluster, cudaStream_t s) {
  switch (nq) {
    case 8: return launch<C, 8>(q, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    case 16: return launch<C, 16>(q, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    case 32: return launch<C, 32>(q, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    case 64: return launch<C, 64>(q, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    case 128: return launch<C, 128>(q, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename C>
int smem_for(int nq, int stages) {
  switch (nq) {
    case 8: return smem_bytes<C, 8>(stages);
    case 16: return smem_bytes<C, 16>(stages);
    case 32: return smem_bytes<C, 32>(stages);
    case 64: return smem_bytes<C, 64>(stages);
    case 128: return smem_bytes<C, 128>(stages);
    default: return -1;
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA takes (the wrapper's plan must
// agree); -1 for a width the kernel has no instance of.
extern "C" int nornic_streaming_bf16_smem_bytes(int nq, int stages, int c_dtype) {
  switch (c_dtype) {
    case 0: return smem_for<float>(nq, stages);
    case 1: return smem_for<__nv_bfloat16>(nq, stages);
    case 2: return smem_for<__half>(nq, stages);
    default: return -1;
  }
}

// The wrapper's plan (kernels._streaming_plan) checks and sizes everything:
// tile_n % 128 == 0, n_tiles * tile_n == N, bins pre-filled with INT_MIN,
// q (Q, Dq) float32, c (N, D) with D >= Dq, rows on 16-byte boundaries,
// qbuf of ceil(Q / nq) * ceil(D / 64) * nq * 64 bf16 values, 2 <= stages <=
// 8 (a consumer holds two stages at once) within a CTA's shared memory, a
// cluster of 1 or 2 query blocks that divides their number. c_dtype: 0
// float32, 1 bfloat16, 2 float16.
extern "C" int nornic_streaming_topk_bf16(const void* q, const void* c, const void* valid,
                                          void* qbuf, void* bins, int Q, int Dq, int D,
                                          int tile_n, int n_tiles, int rows, int tile_bits,
                                          int splits, int nq, int stages, int cluster,
                                          int c_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  if (stages < 2 || stages > MAX_STAGES || (cluster != 1 && cluster != 2) ||
      (Q + nq - 1) / nq % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (c_dtype) {
    case 0: return launch_nq<float>(nq, qf, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    case 1: return launch_nq<__nv_bfloat16>(nq, qf, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    case 2: return launch_nq<__half>(nq, qf, c, valid, qbuf, bins, Q, Dq, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
