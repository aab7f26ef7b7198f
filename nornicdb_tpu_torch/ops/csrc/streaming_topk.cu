// Streaming packed-bin cosine top-k for Hopper (sm_90a), int8 products.
//
// Replaces the Pallas TPU kernel _streaming_topk_int8_kernel (s8 x s8 -> s32
// GEMM), launched by streaming_cosine_topk_int8 in
// nornicdb_tpu/ops/pallas_kernels.py. The bf16 kernel beside it is in
// streaming_topk_bf16.cu; the PTX helpers both use are in hopper.cuh.
//
// What it computes (identical to the TPU kernel): corpus tile t, column j
// maps to bin (t % rows, q, j). Each score, the exact s32 product converted
// to float32 (round to nearest) times the row's dequant multiplier
// (valid ? 1 / c_scale : 0, an IEEE division) and then biased (+3 valid /
// -3 masked) as two separately rounded operations, is bitcast to int32, its
// low `tile_bits` bits replaced by the tile index t, and folded into the bin
// with an integer max. The (Q, N) score matrix never reaches device memory;
// the output is the (rows, Q, tile_n) int32 bin block.
//
// Bound on an H100 at the serving shape (N = 1,000,064, D = 1024): the
// operations at Q = 1024 (2*Q*N*D at the int8 tensor-core rate, 1.06 ms),
// the int8 corpus read at Q = 16 (1 byte a value, 0.31 ms). The first
// version (register-staged mma.sync, two barriers a 64-deep chunk) ran at
// 0.15 / 0.23 of them: it read each query block again for every tile, each
// query block read the tile on its own, and at Q = 16 7/8 of every MMA was
// padding. This one reaches the corpus read at Q = 16; at Q = 1024 what it
// meets is the rate of wgmmas that read both operands from shared memory
// (each warpgroup reads the whole query block's chunk for its 64 rows),
// then the fold and the corpus's delivery into shared memory (see PERF.md).
//
// Design.
// - Both operands come from shared memory into wgmma
//   (m64nNk32.s32.s8.s8), K-major and 128-byte swizzled, through
//   descriptors: no register staging. A CTA owns (bin row, query block, 128
//   corpus rows of the tile) and loops over the tiles that fold into its
//   bins. Two consumer warpgroups take 64 corpus rows each (A); the queries
//   are B, NQ wide (8, 16, 32, 64 or 128, sized to Q), so a small batch
//   multiplies only its own rows. A 128-deep K chunk is four k32 steps: the
//   descriptors' start address moves 32 bytes a step inside the swizzle
//   atom (8 rows x 128 bytes, the stride between atoms 1,024 bytes). The
//   accumulator comes out as (corpus rows x queries), so the multiplier and
//   the bias are per accumulator row: two of each a thread a tile.
// - A producer thread keeps a ring of 128-deep corpus chunks full with the
//   TMA engine: one box of the corpus's tensor map a chunk (128 rows x 128
//   bytes, swizzled; a box past D is zero-filled, and zeros add nothing to
//   an s32 sum), signalled by an mbarrier. Each warpgroup frees a stage
//   with a second one as soon as its own wgmmas on it are done; the other
//   warpgroup's keep the tensor cores busy meanwhile. The rows' scales are
//   loaded as a tile starts and used only by its fold.
// - The query block (NQ x padded D bytes) is loaded once a CTA through a
//   second tensor map and kept in shared memory for the whole tile loop
//   where it fits beside a ring of at least 3 stages (D <= 1,408 at
//   NQ = 128). Above that, each stage carries the query block's chunk
//   beside the corpus chunk. One kernel serves both (`q_kept`, chosen by the
//   wrapper's plan; the only difference in the loop is which chunk the B
//   descriptor names).
// - The corpus is read from device memory once a call: the CTAs of the
//   different query blocks of one tile are adjacent in the grid
//   (blockIdx.x), so they run together and the later ones find the tile in
//   L2. Pairs of them form a cluster that shares each chunk: each CTA copies
//   half its rows into both (TMA multicast), halving the corpus's reads
//   from L2.
// - The fold is unchanged: the running maxima stay in registers, CTAs of
//   one bin row split its tile loop (gridDim.z) and merge their maxima with
//   one int32 atomicMax a bin into the INT32_MIN-filled block. The result is
//   deterministic whatever the split.
//
// Rows start on 16-byte boundaries, as a tensor map needs: the wrapper
// copies queries or a corpus whose width or base does not allow it,
// zero-padded, to the same kernel. Any D works.
//
// Plain C interface (loaded with ctypes). The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <limits.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                   // corpus rows a CTA: two warpgroups of 64
constexpr int BK = 128;                   // values (bytes) a K chunk: one swizzled box row
constexpr int CONSUMERS = 256;            // the two warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int MAX_STAGES = 8;
constexpr int BARRIER_BYTES = (2 * MAX_STAGES + 1) * 8;  // full[], empty[], the queries'
constexpr int ALIGN = 1024;  // a 128-byte-swizzled TMA box starts on 1,024 bytes
constexpr int CCHUNK = BM * BK;  // a corpus chunk in the ring: 16 KB

// dynamic shared memory: alignment slack, the corpus ring, the query area
// (the whole block of kchunks chunks when kept, else one chunk a stage), the
// barriers
__host__ __device__ constexpr int smem_bytes(int nq, int kchunks, int stages, bool q_kept) {
  return ALIGN + stages * CCHUNK + (q_kept ? kchunks : stages) * nq * BK + BARRIER_BYTES;
}

// wgmma's shared-memory matrix descriptor, K-major with the 128-byte swizzle
// the TMA boxes land in: rows of 128 bytes in atoms of 8 rows, 1,024 bytes
// from one atom to the next (SBO); the leading offset is unused (1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma m64nNk32, A (corpus) and B (queries) s8 from shared memory, s32
// accumulators; scale_d == 0 starts a new sum.
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  __device__ __forceinline__ static void mma(int (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<16> {
  __device__ __forceinline__ static void mma(int (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<32> {
  __device__ __forceinline__ static void mma(int (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  __device__ __forceinline__ static void mma(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<128> {
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// grid (query blocks, rows * tile_n / BM, splits) in clusters of (CL, 1, 1)
// query blocks; THREADS threads; smem_bytes(NQ, kchunks, stages, q_kept) of
// dynamic shared memory. `cmap` is the corpus's (N, D) tensor map (boxes of
// BM / CL rows x 128 bytes, swizzled), `qmap` the queries' (Q, D) one (boxes
// of NQ rows x 128 bytes; rows past Q are zero-filled). The CTAs of a
// cluster read the same corpus chunks: each copies its BM / CL rows of a
// chunk into all of them (TMA multicast), and a stage is refilled only once
// every CTA of the cluster has freed it.
template <int NQ>
__global__ void __launch_bounds__(THREADS, 1)
streaming_topk_i8_kernel(const __grid_constant__ CUtensorMap cmap,
                         const __grid_constant__ CUtensorMap qmap,
                         const float* __restrict__ c_scale, const uint8_t* __restrict__ valid,
                         int* __restrict__ bins, int Q, int D, int tile_n, int n_tiles, int rows,
                         int tile_bits, int stages, int q_kept) {
  constexpr int QCHUNK = NQ * BK;  // the query block's K chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t ring = base + ((ALIGN - (base & (ALIGN - 1))) & (ALIGN - 1));
  const int kchunks = (D + BK - 1) / BK;
  const uint32_t q_area = ring + stages * CCHUNK;
  const uint32_t full_bar = q_area + (q_kept ? kchunks : stages) * QCHUNK;
  const uint32_t empty_bar = full_bar + 8 * MAX_STAGES, q_bar = empty_bar + 8 * MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int csize = static_cast<int>(cluster_size()), crank = static_cast<int>(cluster_rank());
  const int col_blocks = tile_n / BM;
  const int r = blockIdx.y / col_blocks, cb = blockIdx.y % col_blocks;
  // this CTA's tiles: first, first + step, ... (< n_tiles)
  const int first = r + blockIdx.z * rows, step = rows * gridDim.z;
  const int my_tiles = first < n_tiles ? (n_tiles - 1 - first) / step + 1 : 0;
  const int total = my_tiles * kchunks;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS / 32 * csize);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&cmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers exist before a copy or arrival reaches them

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread keeps the ring full, one or two TMA copies a chunk
    if (lane == 0 && total > 0) {
      const int q0 = blockIdx.x * NQ;
      if (q_kept) {  // the whole query block, once
        mbar_expect_tx(q_bar, kchunks * QCHUNK);
        for (int kc = 0; kc < kchunks; ++kc)
          tma_load_2d(q_area + kc * QCHUNK, &qmap, kc * BK, q0, q_bar);
      }
      const int slice = BM / csize;  // the rows this CTA copies for the whole cluster
      for (int it = 0; it < total; ++it) {
        const int s = it % stages;
        const int ti = it / kchunks, kc = it - ti * kchunks;
        const int col0 = (first + ti * step) * tile_n + cb * BM + crank * slice;
        mbar_wait(empty_bar + 8 * s, ((it / stages) & 1) ^ 1);
        // the whole chunk lands here, a slice from each CTA of the cluster
        mbar_expect_tx(full_bar + 8 * s, CCHUNK + (q_kept ? 0 : QCHUNK));
        tma_load_2d_multicast(ring + s * CCHUNK + crank * slice * BK, &cmap, kc * BK, col0,
                              full_bar + 8 * s, static_cast<uint16_t>((1u << csize) - 1));
        if (!q_kept) tma_load_2d(q_area + s * QCHUNK, &qmap, kc * BK, q0, full_bar + 8 * s);
      }
    }
  } else {
    // ---- consumers: warpgroup wg takes ring rows 64 * wg .. 64 * wg + 63
    const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
    const int row_a = wg * 64 + (warp & 3) * 16 + g;  // accumulator rows row_a, row_a + 8
    const int keep = -(1 << tile_bits);
    int acc[NQ / 2];
    int best[NQ / 2];
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) {
      acc[i] = 0;
      best[i] = INT_MIN;
    }
    int t = first;
    float s0 = 1.f, s1 = 1.f;  // c_scale and valid of rows row_a, row_a + 8 of the tile
    uint8_t u0 = 0, u1 = 0;
    if (q_kept && total > 0) mbar_wait(q_bar, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % stages;
      const int kc = it % kchunks;
      // this tile's index and its rows' scales, loaded here and used only by
      // the fold: a multiplier computed here would hold the tile's first
      // wgmma back behind two dependent global loads and a division
      if (kc == 0) {
        t = first + (it / kchunks) * step;
        const long n0 = static_cast<long>(t) * tile_n + cb * BM + row_a;
        s0 = c_scale[n0];
        s1 = c_scale[n0 + 8];
        u0 = valid[n0];
        u1 = valid[n0 + 8];
      }
      mbar_wait(full_bar + 8 * s, (it / stages) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      const uint32_t a = ring + s * CCHUNK + wg * 64 * BK;
      const uint32_t b = q_area + (q_kept ? kc : s) * QCHUNK;
      wgmma_fence();
      hold(acc);
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        Wgmma<NQ>::mma(acc, sw128_desc(a + 32 * ks), sw128_desc(b + 32 * ks), kc | ks);
      wgmma_commit();
      // Free the stage as soon as its own wgmmas are done, before waiting for
      // the next chunk, so no stage is held while its successor is still in
      // flight; the other warpgroup keeps the tensor cores busy meanwhile.
      wgmma_wait<0>();
      hold(acc);
      __syncwarp();
      if (lane < csize) mbar_arrive_cluster(empty_bar + 8 * s, lane);  // one arrival at each producer
      if (kc == kchunks - 1) {  // the tile is summed: fold it
        // (acc * multiplier) + bias as two rounded operations (never
        // contracted into an FMA), as the plain version's multiply and add
        const float m0 = u0 ? __fdiv_rn(1.f, s0) : 0.f, m1 = u1 ? __fdiv_rn(1.f, s1) : 0.f;
        const float b0 = u0 ? 3.f : -3.f, b1 = u1 ? 3.f : -3.f;
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) {
          const bool hi = (i >> 1) & 1;
          const float biased =
              __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), hi ? m1 : m0), hi ? b1 : b0);
          best[i] = max(best[i], (__float_as_int(biased) & keep) | t);
        }
      }
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

// A 2-D tensor map over `rows` int8 rows of D values (D bytes apart), boxes
// of `box_rows` rows x 128 bytes, 128-byte swizzled; reads past D or past
// the last row fill zeros. The enum has no signed 8-bit type: the bytes are
// the same.
bool encode_i8(CUtensorMap* map, EncodeTiled encode, const void* p, int D, long rows,
               int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NQ>
int launch(const void* q, const void* c, const void* c_scale, const void* valid, void* bins,
           int Q, int D, int tile_n, int n_tiles, int rows, int tile_bits, int splits,
           int stages, int cluster, int q_kept, cudaStream_t stream) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap cmap, qmap;
  if (!encode_i8(&cmap, encode, c, D, static_cast<long>(n_tiles) * tile_n, BM / cluster) ||
      !encode_i8(&qmap, encode, q, D, Q, NQ))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = streaming_topk_i8_kernel<NQ>;
  const int smem = smem_bytes(NQ, (D + BK - 1) / BK, stages, q_kept != 0);
  static int allowed = 48 * 1024;  // dynamic shared memory this instance may take
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Q + NQ - 1) / NQ, rows * (tile_n / BM), splits);
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
      &cfg, kernel, cmap, qmap, static_cast<const float*>(c_scale),
      static_cast<const uint8_t*>(valid), static_cast<int*>(bins), Q, D, tile_n, n_tiles, rows,
      tile_bits, stages, q_kept);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one CTA takes at query block width nq,
// (padded) width d, `stages` ring stages, the queries kept or not (the
// wrapper's plan must agree); -1 for a width the kernel has no instance of.
extern "C" int nornic_streaming_i8_smem_bytes(int nq, int d, int stages, int q_kept) {
  if (nq != 8 && nq != 16 && nq != 32 && nq != 64 && nq != 128) return -1;
  return smem_bytes(nq, (d + BK - 1) / BK, stages, q_kept != 0);
}

// The wrapper's plan (kernels._int8_plan) checks and sizes everything:
// tile_n % 128 == 0, n_tiles * tile_n == N, bins pre-filled with INT_MIN,
// q (Q, D) and c (N, D) int8 with D % 16 == 0 and both on 16-byte
// boundaries, c_scale (N,) float32, valid (N,) bool, 2 <= stages <= 8 (3 at
// least with the queries kept) within a CTA's shared memory, a cluster of 1
// or 2 query blocks that divides their number.
extern "C" int nornic_streaming_topk_i8(const void* q, const void* c, const void* c_scale,
                                        const void* valid, void* bins, int Q, int D, int tile_n,
                                        int n_tiles, int rows, int tile_bits, int splits, int nq,
                                        int stages, int cluster, int q_kept, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 2 || stages > MAX_STAGES || (cluster != 1 && cluster != 2) || D % 16 != 0 ||
      (Q + nq - 1) / nq % cluster != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (nq) {
    case 8: return launch<8>(q, c, c_scale, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, q_kept, s);
    case 16: return launch<16>(q, c, c_scale, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, q_kept, s);
    case 32: return launch<32>(q, c, c_scale, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, q_kept, s);
    case 64: return launch<64>(q, c, c_scale, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, q_kept, s);
    case 128: return launch<128>(q, c, c_scale, valid, bins, Q, D, tile_n, n_tiles, rows, tile_bits, splits, stages, cluster, q_kept, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
