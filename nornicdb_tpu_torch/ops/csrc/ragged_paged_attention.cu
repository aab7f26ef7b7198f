// Ragged paged attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ragged_attn_kernel, launched by
// ragged_paged_attention in nornicdb_tpu/ops/pallas_kernels.py. What it
// computes: q (L, Tq, H, Dh) query rows, one layer's K and V pools
// (num_pages, ps, Hkv, Dh), per-lane page tables (L, P) and per-row cache
// positions (L, Tq), -1 marking a padding row. Each row of lane l attends
// over the lane's S = P * ps slots, slot s visible iff s <= its position;
// GQA with n_rep = H / Hkv (head h reads KV head h / n_rep). float32 scores
// scaled by Dh^-0.5 after the product, a float32 softmax (exp(x - max) /
// sum), the probabilities rounded to the value type, then P.V summed in
// float32 and rounded to the output type: the reference's rounding points.
//
// Bound on an H100: bytes. Each lane's K/V pages up to its largest position
// are read once, q read and the output written once: at the generation
// path's shapes (Qwen2.5-0.5B, 14/2 heads, Dh 64, bf16) a few hundred KB,
// a fraction of a microsecond at 3.35 TB/s. A call is bound in practice by
// latency: the launch, a chain of dependent reads (positions, the page
// table, the pages) and the steps of the softmax.
//
// Design. A thread-block cluster of C CTAs (C = min(8, ceil(S / 16)))
// serves one (lane, KV head, block of qb query rows), i.e. the qb * n_rep
// query vectors that share the KV head. The visible slots, up to the
// block's largest position, are split over the first
// min(C, ceil(slots / 16)) CTAs of the cluster: the split follows the
// lane's largest position, and the rest of the cluster idles. Each CTA
//  - reads its own table entries (the TPU's scalar prefetch) and copies its
//    K tiles, then its V tiles, 64 slots at a time into a two-buffer ring
//    with 16-byte cp.async, the next tile in flight while one is used (at
//    the serving shape its K and V tiles are both in flight at once);
//  - scores its slots (one thread a (query vector, slot) pair) and takes
//    each vector's local maximum;
//  - exchanges the maxima with the cluster through distributed shared
//    memory, then the sums of exp(s - max), so every probability is
//    round_T(exp(s - m) / sum) with the row's global m and sum;
//  - sums P.V over its slots (one thread an output value);
//  - and the cluster reduces the partial sums, in rank order, each CTA
//    writing a slice of the block's output.
// A slot beyond a row's position has weight exp(-1e30 - max) = 0.0 in
// float32 in the reference, so skipping it changes no sum. A padding row,
// or a block whose rows are all padding, writes zeros and never divides: a
// valid row always sees slot 0, which CTA 0 holds. No tensor cores: the
// products are scalar float32 FMAs (14 query vectors share a K/V tile at
// the chunk block, 7 at decode: too few rows to fill an MMA, and the split
// keeps a CTA's slots to 16-32 at the generation path's lengths).
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_SLOTS = 64;   // slots a K/V tile
constexpr int MIN_SLOTS = 16;    // slots a CTA takes at least before the split grows
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// 16 bytes of T, widened to float32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x; f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Start copying slots [t0, t0 + ns) of KV head kh of one lane into the tile
// (row stride `stride` elements), 16 bytes a copy. Page ids are clamped
// into the pool, as the reference's gather clamps them.
template <typename T>
__device__ __forceinline__ void load_tile(T* tile, int stride, const T* __restrict__ pool,
                                          const int* __restrict__ table, int t0, int ns, int ps,
                                          int hkv, int kh, int dh, int num_pages) {
  const int vecs = dh / Vec<T>::N;
  for (int i = threadIdx.x; i < ns * vecs; i += THREADS) {
    const int s = i / vecs, c = i - s * vecs;
    const int slot = t0 + s;
    const int page = min(max(__ldg(table + slot / ps), 0), num_pages - 1);
    const T* src = pool + ((static_cast<long>(page) * ps + slot % ps) * hkv + kh) * dh;
    cp_async16(tile + s * stride + c * Vec<T>::N, src + c * Vec<T>::N);
  }
}

// Copy number `seq` of a CTA's sequence (its K tiles 0..nt-1, then its V
// tiles 0..nt-1) into ring buffer seq % 2; always one commit, so that
// "all but the newest group done" means seq - 1 has landed.
template <typename T>
__device__ __forceinline__ void start_copy(int seq, int nt, int lo, int my, T* ring, int stride,
                                      const T* k_pages, const T* v_pages, const int* table,
                                      int ps, int hkv, int kh, int dh, int num_pages) {
  if (seq < 2 * nt) {
    const int ti = seq < nt ? seq : seq - nt;
    load_tile(ring + (seq & 1) * TILE_SLOTS * stride, stride, seq < nt ? k_pages : v_pages,
              table, lo + ti * TILE_SLOTS, min(TILE_SLOTS, my - ti * TILE_SLOTS), ps, hkv, kh, dh,
              num_pages);
  }
  cp_async_commit();
}

__host__ __device__ __forceinline__ int cluster_for(int s_len) {
  return min(MAX_CLUSTER, max(1, (s_len + MIN_SLOTS - 1) / MIN_SLOTS));
}
// a CTA's slots at most: MIN_SLOTS while the split is below the cluster,
// ceil(S / C) once the whole cluster takes part
__host__ __device__ __forceinline__ int span_max_for(int s_len, int cluster) {
  return max(MIN_SLOTS, (s_len + cluster - 1) / cluster);
}

// grid (L * C, Hkv, ceil(Tq / qb)) in clusters of (C, 1, 1); THREADS threads
template <typename T>
__global__ void __launch_bounds__(THREADS)
ragged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const int* __restrict__ tables,
                   const int* __restrict__ positions, T* __restrict__ out, int tq,
                   int h, int hkv, int dh, int num_pages, int ps, int p, int qb,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rep = h / hkv, s_len = p * ps, stride = dh + Vec<T>::N;
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int span_max = span_max_for(s_len, csize);
  const int lane = blockIdx.x / csize, kh = blockIdx.y, r0 = blockIdx.z * qb;
  const int nq = min(qb, tq - r0);
  const int rows = nq * n_rep;  // query vector r: row r / n_rep, head kh * n_rep + r % n_rep
  const int rmax = qb * n_rep;
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + sizeof(T) * 2 * TILE_SLOTS * stride);
  float* acc = qs + rmax * dh;     // this CTA's partial P.V
  float* sc = acc + rmax * dh;     // scores, then weights, of this CTA's slots
  float* mx = sc + static_cast<long>(rmax) * span_max;  // local maxima
  float* sm = mx + rmax;                                // local sums
  int* pos = reinterpret_cast<int*>(sm + rmax);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int* table = tables + static_cast<long>(lane) * p;
  const long row0 = static_cast<long>(lane) * tq + r0;

  if (threadIdx.x < nq) pos[threadIdx.x] = positions[row0 + threadIdx.x];
  // the query vectors, 16 bytes a load (one load a thread at these sizes)
  constexpr int VN = Vec<T>::N;
  for (int i = threadIdx.x; i < rows * dh / VN; i += THREADS) {
    const int r = i * VN / dh, d = i * VN - r * dh;
    float f[VN];
    Vec<T>::load(q + ((row0 + r / n_rep) * h + kh * n_rep + r % n_rep) * dh + d, f);
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(qs + r * dh + d + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
  for (int i = threadIdx.x; i < rows * dh / 4; i += THREADS)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    mx[r] = __int_as_float(0xff800000);  // -inf: no visible slot here
    sm[r] = 0.f;
  }
  __syncthreads();
  int maxpos = -1;
  for (int i = 0; i < nq; ++i) maxpos = max(maxpos, pos[i]);
  const int n_slots = min(maxpos + 1, s_len);  // 0: every row is padding
  // the split: CTAs 0 .. active - 1 take `span` slots each
  const int active = n_slots > 0 ? min(csize, (n_slots + MIN_SLOTS - 1) / MIN_SLOTS) : 0;
  const int span = active > 0 ? (n_slots + active - 1) / active : 0;
  const int lo = rank * span;
  const int my = rank < active ? max(0, min(span, n_slots - lo)) : 0;
  const int nt = (my + TILE_SLOTS - 1) / TILE_SLOTS;

  start_copy(0, nt, lo, my, ring, stride, k_pages, v_pages, table, ps, hkv, kh, dh, num_pages);
  start_copy(1, nt, lo, my, ring, stride, k_pages, v_pages, table, ps, hkv, kh, dh, num_pages);

  // pass 1: one thread a (query vector, slot) score; invisible slots -inf
  for (int i = 0; i < nt; ++i) {
    cp_async_wait1();
    __syncthreads();
    const T* tile = ring + (i & 1) * TILE_SLOTS * stride;
    const int t0 = i * TILE_SLOTS, ns = min(TILE_SLOTS, my - t0);
    for (int task = threadIdx.x; task < rows * ns; task += THREADS) {
      const int r = task / ns, s = task - r * ns;
      float v = __int_as_float(0xff800000);
      if (lo + t0 + s <= pos[r / n_rep]) {
        const float* qr = qs + r * dh;
        const T* kr = tile + s * stride;
        float dot = 0.f;
        for (int c = 0; c < dh; c += VN) {
          float kf[VN];
          Vec<T>::load(kr + c, kf);
#pragma unroll
          for (int e = 0; e < VN; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + c + e);
            dot += qv.x * kf[e];
            dot += qv.y * kf[e + 1];
            dot += qv.z * kf[e + 2];
            dot += qv.w * kf[e + 3];
          }
        }
        v = dot * scale;
      }
      sc[static_cast<long>(r) * span_max + t0 + s] = v;
    }
    __syncthreads();
    start_copy(i + 2, nt, lo, my, ring, stride, k_pages, v_pages, table, ps, hkv, kh, dh,
               num_pages);
  }
  for (int r = warp; r < rows; r += WARPS) {
    const float* row = sc + static_cast<long>(r) * span_max;
    float m = __int_as_float(0xff800000);
    for (int s = ln; s < my; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    if (ln == 0) mx[r] = m;
  }
  cluster.sync();  // (1) every CTA's local maxima

  // exp(s - m) against the row's global maximum, and the local sums
  for (int r = warp; r < rows; r += WARPS) {
    float m = ln < csize ? *cluster.map_shared_rank(mx + r, ln) : __int_as_float(0xff800000);
    m = warp_max(m);
    float* row = sc + static_cast<long>(r) * span_max;
    float sum = 0.f;
    if (m != __int_as_float(0xff800000)) {  // a padding row has no visible slot anywhere
      for (int s = ln; s < my; s += 32) {
        const float e = expf(row[s] - m);  // an invisible slot: exp(-inf) = 0
        row[s] = e;
        sum += e;
      }
    }
    sum = warp_sum(sum);
    if (ln == 0) sm[r] = sum;
  }
  cluster.sync();  // (2) every CTA's local sums

  // the probabilities, rounded to T as the reference casts them
  for (int r = warp; r < rows; r += WARPS) {
    const float total = warp_sum(ln < csize ? *cluster.map_shared_rank(sm + r, ln) : 0.f);
    float* row = sc + static_cast<long>(r) * span_max;
    for (int s = ln; s < my; s += 32) row[s] = total > 0.f ? to_f32(from_f32<T>(row[s] / total)) : 0.f;
  }

  // pass 2: P.V over this CTA's slots, one thread an output value
  for (int i = 0; i < nt; ++i) {
    cp_async_wait1();
    __syncthreads();
    const T* tile = ring + ((nt + i) & 1) * TILE_SLOTS * stride;
    const int t0 = i * TILE_SLOTS, ns = min(TILE_SLOTS, my - t0);
    for (int o = threadIdx.x; o < rows * dh; o += THREADS) {
      const int r = o / dh, d = o - r * dh;
      const int vis = min(ns, pos[r / n_rep] + 1 - lo - t0);
      const float* pr = sc + static_cast<long>(r) * span_max + t0;
      float a = acc[o];
#pragma unroll 4
      for (int s = 0; s < vis; ++s) a += pr[s] * to_f32(tile[s * stride + d]);
      acc[o] = a;
    }
    __syncthreads();
    start_copy(nt + i + 2, nt, lo, my, ring, stride, k_pages, v_pages, table, ps, hkv, kh, dh,
               num_pages);
  }
  cluster.sync();  // (3) every CTA's partial sums

  // reduce the partial sums in rank order; CTA `rank` writes its slice
  const int per = (rows * dh + csize - 1) / csize;
  const int o_end = min(rows * dh, (rank + 1) * per);
  for (int o = rank * per + threadIdx.x; o < o_end; o += THREADS) {
    const int r = o / dh, d = o - r * dh;
    float v = 0.f;
    if (pos[r / n_rep] >= 0)
      for (int k = 0; k < active; ++k) v += *cluster.map_shared_rank(acc + o, k);
    out[((row0 + r / n_rep) * h + kh * n_rep + r % n_rep) * dh + d] = from_f32<T>(v);
  }
  cluster.sync();  // (4) no CTA leaves while the others read its shared memory
}

// Dynamic shared memory of one CTA: the two-tile K/V ring with rows padded
// by 16 bytes; the CTA's query vectors and partial sums in float32; its
// scores over at most span_max slots; the local maxima and sums; the rows'
// positions. kernels._ragged_plan computes the same.
template <typename T>
size_t smem_bytes(int qb, int n_rep, int dh, int s_len) {
  const size_t rmax = static_cast<size_t>(qb) * n_rep;
  const size_t span = span_max_for(s_len, cluster_for(s_len));
  return sizeof(T) * 2 * TILE_SLOTS * (dh + Vec<T>::N) +
         sizeof(float) * (2 * rmax * dh + rmax * span + 2 * rmax) + sizeof(int) * qb;
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* tables,
           const void* positions, void* out, const int* prm, float scale, cudaStream_t stream) {
  const int L = prm[0], tq = prm[1], h = prm[2], hkv = prm[3], dh = prm[4], num_pages = prm[5],
            ps = prm[6], p = prm[7], qb = prm[8];
  const int cluster = cluster_for(p * ps);
  const int smem = static_cast<int>(smem_bytes<T>(qb, h / hkv, dh, p * ps));
  static int allowed = 48 * 1024;  // dynamic shared memory this instance may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L * cluster, hkv, (tq + qb - 1) / qb);
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
      &cfg, ragged_attn_kernel<T>, static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), tq, h, hkv, dh, num_pages, ps, p,
      qb, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one CTA takes, capped at INT_MAX (the
// wrapper's plan must agree; the span, and so the count, follows the
// cluster size).
extern "C" int nornic_ragged_attn_smem_bytes(int qb, int n_rep, int dh, int s_len, int dtype) {
  const size_t smem = dtype == 1 ? smem_bytes<__nv_bfloat16>(qb, n_rep, dh, s_len)
                                 : smem_bytes<float>(qb, n_rep, dh, s_len);
  return smem > static_cast<size_t>(INT_MAX) ? INT_MAX : static_cast<int>(smem);
}

// prm: L, Tq, H, Hkv, Dh, num_pages, ps, P, qb, dtype (0 = float32, 1 =
// bfloat16), a host array the wrapper's plan keeps. The wrapper checks
// shapes, types, contiguity, 16-byte alignment, Dh % 8 == 0, Dh <= 128,
// H % Hkv == 0, 1 <= qb <= 4 and the shared memory bound.
extern "C" int nornic_ragged_paged_attention(const void* q, const void* k_pages,
                                             const void* v_pages, const void* tables,
                                             const void* positions, void* out, const void* prm,
                                             float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(prm);
  if (p[9] == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, positions, out, p, scale, s);
  return launch<float>(q, k_pages, v_pages, tables, positions, out, p, scale, s);
}
