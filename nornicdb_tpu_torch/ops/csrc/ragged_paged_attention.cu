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
// Design (simple and exact first): one CTA per (lane, KV head, block of qb
// query rows) computes the qb * n_rep query vectors that share the KV head.
// The CTA reads its own table row (the TPU's scalar prefetch) and walks only
// the slots up to the block's largest position: a slot beyond a row's
// position has weight exp(-1e30 - max) = 0.0 in float32 in the reference, so
// skipping it changes no sum. K and then V are staged through shared memory
// 64 slots at a time with 16-byte loads (rows padded by 16 bytes, so the
// 16-byte reads of pass 1 are free of bank conflicts). The scores of a row
// (at most S floats) stay in shared memory for an exact two-pass softmax.
// A padding row, or a block whose rows are all padding, writes zeros and
// never divides: a valid row always sees slot 0.
//
// Bound: bytes. Each lane's K/V pages up to its largest position are read
// once per (KV head, row block), q read and the output written once; the
// 4 * Dh operations per (query vector, visible slot) are far below the
// card's rate at these sizes. No tensor cores, no TMA yet.
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_SLOTS = 64;

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

// Stage slots [t0, t0 + ns) of KV head kh of one lane into the tile (row
// stride `stride` elements), 16 bytes a load. Page ids are clamped into
// the pool, as the reference's gather clamps them.
template <typename T>
__device__ void load_tile(T* tile, int stride, const T* __restrict__ pool,
                          const int* __restrict__ table, int t0, int ns, int ps,
                          int hkv, int kh, int dh, int num_pages) {
  const int vecs = dh / Vec<T>::N;
  for (int i = threadIdx.x; i < ns * vecs; i += THREADS) {
    const int s = i / vecs, c = i - s * vecs;
    const int slot = t0 + s;
    const int page = min(max(table[slot / ps], 0), num_pages - 1);
    const T* src = pool + ((static_cast<long>(page) * ps + slot % ps) * hkv + kh) * dh;
    reinterpret_cast<uint4*>(tile + s * stride)[c] = reinterpret_cast<const uint4*>(src)[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ragged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages, const int* __restrict__ tables,
                   const int* __restrict__ positions, T* __restrict__ out, int tq,
                   int h, int hkv, int dh, int num_pages, int ps, int p, int qb,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_rep = h / hkv, s_len = p * ps, stride = dh + Vec<T>::N;
  const int lane = blockIdx.x, kh = blockIdx.y, r0 = blockIdx.z * qb;
  const int nq = min(qb, tq - r0);
  const int rows = nq * n_rep;  // query vector r: row r / n_rep, head kh * n_rep + r % n_rep
  const int rmax = qb * n_rep;
  T* tile = reinterpret_cast<T*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + sizeof(T) * TILE_SLOTS * stride);
  float* acc = qs + rmax * dh;
  float* sc = acc + rmax * dh;
  int* pos = reinterpret_cast<int*>(sc + static_cast<long>(rmax) * s_len);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int* table = tables + static_cast<long>(lane) * p;
  const long row0 = static_cast<long>(lane) * tq + r0;

  if (threadIdx.x < nq) pos[threadIdx.x] = positions[row0 + threadIdx.x];
  for (int i = threadIdx.x; i < rows * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    qs[i] = to_f32(q[((row0 + r / n_rep) * h + kh * n_rep + r % n_rep) * dh + d]);
    acc[i] = 0.f;
  }
  __syncthreads();
  int maxpos = -1;
  for (int i = 0; i < nq; ++i) maxpos = max(maxpos, pos[i]);
  const int n_slots = min(maxpos + 1, s_len);  // 0: every row is padding

  // pass 1: each lane of a warp scores one slot of one query vector
  for (int t0 = 0; t0 < n_slots; t0 += TILE_SLOTS) {
    const int ns = min(TILE_SLOTS, n_slots - t0);
    __syncthreads();
    load_tile(tile, stride, k_pages, table, t0, ns, ps, hkv, kh, dh, num_pages);
    __syncthreads();
    const int groups = (ns + 31) / 32;
    for (int task = warp; task < rows * groups; task += WARPS) {
      const int r = task / groups, s = (task - r * groups) * 32 + ln;
      if (s >= min(ns, pos[r / n_rep] + 1 - t0)) continue;
      const float* qr = qs + r * dh;
      const T* kr = tile + s * stride;
      float dot = 0.f;
      for (int c = 0; c < dh; c += Vec<T>::N) {
        float kf[Vec<T>::N];
        Vec<T>::load(kr + c, kf);
#pragma unroll
        for (int i = 0; i < Vec<T>::N; ++i) dot += qr[c + i] * kf[i];
      }
      sc[static_cast<long>(r) * s_len + t0 + s] = dot * scale;
    }
  }
  __syncthreads();

  // softmax of each valid query vector over its visible slots, one warp each;
  // the probabilities are rounded to T, as the reference casts them
  for (int r = warp; r < rows; r += WARPS) {
    const int vis = min(n_slots, pos[r / n_rep] + 1);
    if (vis <= 0) continue;
    float* row = sc + static_cast<long>(r) * s_len;
    float m = __int_as_float(0xff800000);  // -inf
    for (int s = ln; s < vis; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = ln; s < vis; s += 32) {
      const float e = expf(row[s] - m);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int s = ln; s < vis; s += 32) row[s] = to_f32(from_f32<T>(row[s] / sum));
  }

  // pass 2: P.V, each lane owning output dims d = ln, ln + 32, ...
  for (int t0 = 0; t0 < n_slots; t0 += TILE_SLOTS) {
    const int ns = min(TILE_SLOTS, n_slots - t0);
    __syncthreads();
    load_tile(tile, stride, v_pages, table, t0, ns, ps, hkv, kh, dh, num_pages);
    __syncthreads();
    for (int r = warp; r < rows; r += WARPS) {
      const int vis = min(ns, pos[r / n_rep] + 1 - t0);
      if (vis <= 0) continue;
      const float* pr = sc + static_cast<long>(r) * s_len + t0;
      for (int d = ln; d < dh; d += 32) {
        float a = acc[r * dh + d];
        for (int s = 0; s < vis; ++s) a += pr[s] * to_f32(tile[s * stride + d]);
        acc[r * dh + d] = a;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    const float v = pos[r / n_rep] >= 0 ? acc[i] : 0.f;
    out[((row0 + r / n_rep) * h + kh * n_rep + r % n_rep) * dh + d] = from_f32<T>(v);
  }
}

// Dynamic shared memory of one CTA: the K/V tile with rows padded by 16
// bytes, the CTA's query vectors and accumulators in float32, their scores
// over S slots, and the rows' positions. The wrapper asks for it through
// nornic_ragged_attn_smem_bytes to pick qb.
template <typename T>
size_t smem_bytes(int qb, int n_rep, int dh, int s_len) {
  const size_t rmax = static_cast<size_t>(qb) * n_rep;
  return sizeof(T) * TILE_SLOTS * (dh + Vec<T>::N) +
         sizeof(float) * (2 * rmax * dh + rmax * s_len) + sizeof(int) * qb;
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* tables,
           const void* positions, void* out, int L, int tq, int h, int hkv, int dh,
           int num_pages, int ps, int p, int qb, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(qb, h / hkv, dh, p * ps);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ragged_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(L, hkv, (tq + qb - 1) / qb);
  ragged_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(tables), static_cast<const int*>(positions), static_cast<T*>(out),
      tq, h, hkv, dh, num_pages, ps, p, qb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory one CTA takes, capped at INT_MAX.
extern "C" int nornic_ragged_attn_smem_bytes(int qb, int n_rep, int dh, int s_len, int dtype) {
  const size_t smem = dtype == 1 ? smem_bytes<__nv_bfloat16>(qb, n_rep, dh, s_len)
                                 : smem_bytes<float>(qb, n_rep, dh, s_len);
  return smem > static_cast<size_t>(INT_MAX) ? INT_MAX : static_cast<int>(smem);
}

// dtype: 0 = float32, 1 = bfloat16. The wrapper checks shapes, types,
// contiguity, 16-byte alignment, Dh % 8 == 0, Dh <= 128, H % Hkv == 0,
// 1 <= qb <= 8 and the shared memory bound.
extern "C" int nornic_ragged_paged_attention(const void* q, const void* k_pages,
                                             const void* v_pages, const void* tables,
                                             const void* positions, void* out, int L, int tq,
                                             int h, int hkv, int dh, int num_pages, int ps,
                                             int p, int qb, float scale, int dtype,
                                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, positions, out, L, tq, h, hkv, dh,
                                 num_pages, ps, p, qb, scale, s);
  return launch<float>(q, k_pages, v_pages, tables, positions, out, L, tq, h, hkv, dh,
                       num_pages, ps, p, qb, scale, s);
}
