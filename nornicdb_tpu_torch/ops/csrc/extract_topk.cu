// Exact top-k extraction over packed bins for Hopper (sm_90a): a radix select.
//
// Replaces the Pallas TPU kernel _extract_topk_kernel in
// nornicdb_tpu/ops/pallas_kernels.py (reached through _topk_bins with
// epilogue="pallas"). What it computes: for each query row of the (Q, B)
// int32 bin matrix, the k largest values in descending order, equal values
// ordered by the lowest bin index (the TPU kernel's first-occurrence rule,
// and lax.top_k's). Outputs are (Q, kpad) values and bin ids; columns
// k..kpad-1 hold INT_MIN / 0 as on the TPU.
//
// Bound: the (Q, B) read and the (Q, kpad) writes. The TPU kernel's k rounds
// of (argmax, mask) cost k * B compares and two barriers a round; here one
// CTA a row finds the answer in a fixed number of passes over the row held
// in shared memory:
//   1. each bin becomes an order-preserving unsigned key, u = v ^ 0x80000000
//      (masked bins and INT_MIN order below every valid bin);
//   2. four passes of 8-bit digits, high to low, find T, the k-th largest
//      key: each pass histograms the digit of the keys that match the digits
//      chosen so far, and one scan of the 256 counts picks the digit that
//      holds the k-th key and the count still to take below it. After the
//      last pass, k - need keys are > T and the first `need` keys == T (in
//      index order) complete the top k;
//   3. thread t owns the contiguous bins [t * per, (t + 1) * per), so thread
//      order is index order: one block scan of each thread's counts of keys
//      > T and == T tells every thread how many keys it may take and where
//      its picks go, and the picks land in index order;
//   4. each pick's output column is the number of picks that beat it (larger
//      key, or equal key earlier in index order), counted against the k
//      picks in shared memory. Where the picks do not fit beside the row
//      (B and k both large), each pick is counted against the whole row
//      instead: slower, the same result.
// The TPU kernel masks a chosen bin with INT_MIN, so a bin that holds
// INT_MIN is never removed: once the bins above INT_MIN run out, every
// further round finds the whole row at INT_MIN and returns bin 0. A pick of
// value INT_MIN therefore outputs bin id 0.
// The histograms are plain shared-memory atomics: aggregating the lanes of
// one digit first (__match_any_sync) cost more than the collisions it saved,
// even in the first pass, where the valid packed scores share their top byte.
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;  // 8-bit digits: one histogram bin a thread
// words of shared memory before the row: histogram, scan scratch, control
// (ops/kernels.py _EXTRACT_HEAD_WORDS)
constexpr int HEAD = 320;
constexpr unsigned SIGN = 0x80000000u;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == RADIX, "one histogram bin a thread");

// Exclusive scan of one value a thread over the block; `total` gets the sum.
// Every thread calls it; it ends on a barrier, so `wsum` may be reused.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* wsum, unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < WARPS ? wsum[lane] : 0u;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const unsigned y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += y;
    }
    if (lane < WARPS) wsum[lane] = w;
  }
  __syncthreads();
  total = wsum[WARPS - 1];
  const unsigned before = warp ? wsum[warp - 1] : 0u;
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(THREADS)
extract_topk_kernel(const int* __restrict__ flat, int* __restrict__ out_v,
                    int* __restrict__ out_i, int B, int k, int kpad, int with_picks) {
  extern __shared__ unsigned sm[];
  unsigned* hist = sm;
  unsigned* wsum = sm + RADIX;
  unsigned* ctl = sm + RADIX + 32;
  unsigned* row = sm + HEAD;
  unsigned* pick_key = row + B;  // with_picks only: k keys, then k bin ids
  unsigned* pick_idx = pick_key + k;
  const int tid = threadIdx.x;
  const long r = blockIdx.x;
  const int* src = flat + r * B;
  int* ov = out_v + r * kpad;
  int* oi = out_i + r * kpad;

  // the row, as keys, read once
#pragma unroll 4
  for (int i = tid; i < B; i += THREADS) row[i] = unsigned(__ldg(src + i)) ^ SIGN;

  // T, the k-th largest key, one 8-bit digit a pass
  unsigned prefix = 0, kk = static_cast<unsigned>(k);
#pragma unroll 1
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const unsigned high = pass == 0 ? 0u : FULL << (shift + 8);
    hist[tid] = 0;
    __syncthreads();
    for (int i = tid; i < B; i += THREADS) {
      const unsigned u = row[i];
      if ((u & high) == prefix) atomicAdd(hist + ((u >> shift) & (RADIX - 1)), 1u);
    }
    __syncthreads();
    const unsigned h = hist[tid];
    unsigned total;
    const unsigned above = h + block_scan(h, wsum, total);  // keys in digits < tid and tid
    const unsigned higher = total - above;                  // keys in digits > tid
    if (higher < kk && kk <= higher + h) {
      ctl[0] = prefix | (unsigned(tid) << shift);
      ctl[1] = kk - higher;
    }
    __syncthreads();
    prefix = ctl[0];
    kk = ctl[1];
  }
  const unsigned thr = prefix, need = kk;  // take every key > T, the first `need` == T

  // this thread's bins, and how many keys > T and == T lie before them
  const int per = (B + THREADS - 1) / THREADS;
  const int lo = min(tid * per, B), hi = min(lo + per, B);
  unsigned gt = 0, eq = 0;
  for (int i = lo; i < hi; ++i) {
    gt += row[i] > thr;
    eq += row[i] == thr;
  }
  unsigned total;
  const unsigned before = block_scan((gt << 16) | eq, wsum, total);  // B < 2**16
  unsigned eq_seen = before & 0xffffu;
  unsigned slot = (before >> 16) + min(eq_seen, need);
  for (int i = lo; i < hi; ++i) {
    const unsigned u = row[i];
    if (!(u > thr || (u == thr && eq_seen++ < need))) continue;
    if (with_picks) {
      pick_key[slot] = u;
      pick_idx[slot] = i;
      ++slot;
    } else {  // the pick's column: the keys of the row that beat it
      int rank = 0;
      for (int j = 0; j < i; ++j) rank += row[j] >= u;
      for (int j = i + 1; j < B; ++j) rank += row[j] > u;
      ov[rank] = int(u ^ SIGN);
      oi[rank] = u ? i : 0;
    }
  }
  if (with_picks) {
    __syncthreads();
    // the picks are in index order: earlier picks beat on ties
    for (int e = tid; e < k; e += THREADS) {
      const unsigned u = pick_key[e];
      int rank = 0;
      for (int c = 0; c < e; ++c) rank += pick_key[c] >= u;
      for (int c = e + 1; c < k; ++c) rank += pick_key[c] > u;
      ov[rank] = int(u ^ SIGN);
      oi[rank] = u ? int(pick_idx[e]) : 0;
    }
  }
  for (int j = k + tid; j < kpad; j += THREADS) {
    ov[j] = INT_MIN;
    oi[j] = 0;
  }
}

}  // namespace

// flat (Q, B) int32, out_v / out_i (Q, kpad) int32, all contiguous. The
// wrapper (ops/kernels.py _extract_plan) checks 1 <= k <= B, k <= kpad and
// B < 2**16, and picks with_picks and smem: 4 * (HEAD + B) bytes, plus 8 * k
// with the picks.
extern "C" int nornic_extract_topk(const void* flat, void* out_v, void* out_i, int Q, int B,
                                   int k, int kpad, int with_picks, int smem, void* stream) {
  const long need = 4L * (HEAD + B) + (with_picks ? 8L * k : 0L);
  if (k < 1 || k > B || k > kpad || B >= (1 << 16) || smem < need)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extract_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  extract_topk_kernel<<<Q, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flat), static_cast<int*>(out_v), static_cast<int*>(out_i), B, k,
      kpad, with_picks);
  return static_cast<int>(cudaGetLastError());
}
