// What the port's two top-K kernels share: the hashed priority and the tie
// rule, so each exists once.
//
// - The hash is ops/priority.py::hash_jitter (k8s1m_tpu/ops/priority.py:73),
//   uint32 with logical shifts: a murmur3 finalizer of the wave seed mixed
//   with the pod row and, separately, with the node column; `stratum_bits`
//   > 0 replaces the top bits of the 20-bit draw with a seed-independent
//   hash of the column.  prio = clip(score, 0, 2047) << 20 | jitter, -1
//   where infeasible.
// - The tie rule is k8s1m_tpu/ops/pallas_topk.py::_merge_running_topk
//   (:606): priority descending, then the earlier row.  Each thread keeps
//   its pod's list in registers (`insert`); a node range split across
//   blocks leaves [splits, B, K] partial lists that `merge_splits_kernel`
//   folds with the same insertion, which keeps earlier-split-wins.
//
// - The staged-word scan (`scan_words`).  Both kernels run in two phases per
//   tile of rows: first they stage one i32 word per (pod group or slot,
//   row) in shared memory — clip(score) << 20 | stratum | (column hash &
//   m) where feasible, else -1 — and then each thread scans its group's
//   words: prio = word ^ (row hash & m), one threshold compare, and a rare
//   insert.  The stratum bits lie above m, so the xor reproduces
//   hash_jitter exactly, and -1 stays negative under it.  Rows reach a
//   thread's scan in ascending order within a split, so an equal priority
//   never displaces an earlier row: `prio > tp[K-1]` alone decides, and
//   the insert compares priorities only.  The split merge keeps the full
//   (prio, row) rule across splits.  Tensor cores have no part in this:
//   there is no product, only integer compares.
// - Asynchronous staging (`async_span`): one 4-byte `cp.async` per word of
//   a column's span over a tile, aligned down to 4 bytes so i16/i8 columns
//   and windows that start at any row need no alignment of their own.  A
//   4-byte word that holds one byte of the span lies in the span's page,
//   so the extra bytes never fault; they are never read.
//
// Included by fused_topk.cuh (the filter+score+top-K kernel) and
// delta_topk.cu (the deltasched plane tail).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k8s {

constexpr int kJitterBits = 20;
constexpr int kMaxScore = 2047;
constexpr int kMaxK = 128;        // the Pallas running list is 128 wide

// Staged words per block: enough for 27 staged rows of 128-row tiles, 52
// of 64-row tiles, 99 of 32-row tiles or 128 of 16-row tiles, each row
// padded by 4 words so it starts 16-byte aligned (LDS.128) and groups fall
// on different banks.
constexpr int kStageWords = 3584;
constexpr int kStagePad = 4;

// The tile height a block with `groups` staged rows uses: the widest of
// 128, 64, 32 or 16 whose padded rows all fit in kStageWords.
__host__ __device__ __forceinline__ int tile_rows_for(int groups) {
  return groups * (128 + kStagePad) <= kStageWords ? 128
       : groups * (64 + kStagePad) <= kStageWords ? 64
       : groups * (32 + kStagePad) <= kStageWords ? 32 : 16;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// The pod-row and node-column halves of hash_jitter, and the stratum bits
// of a column already shifted above the `low` per-pod bits (0 if sb == 0).
__device__ __forceinline__ uint32_t hash_row(uint32_t seed, uint32_t row) {
  return mix32(seed ^ (row * 0x9E3779B9u));
}
__device__ __forceinline__ uint32_t hash_col(uint32_t seed, uint32_t col) {
  return mix32(seed ^ (col * 0x85EBCA6Bu));
}
__device__ __forceinline__ uint32_t hash_stratum(uint32_t col, int sb, int low) {
  return sb ? (mix32(col * 0xC2B2AE35u) >> (32 - sb)) << low : 0u;
}
// The 20 jitter bits: stratum on top, (row hash ^ column hash) below.
__device__ __forceinline__ uint32_t jitter_of(uint32_t stratum, uint32_t rh, uint32_t ch,
                                              uint32_t low_mask) {
  return stratum | ((rh ^ ch) & low_mask);
}

// (p, r) ranks before (q, s): higher priority, then the earlier row.
__device__ __forceinline__ bool beats(int p, int r, int q, int s) {
  return p > q || (p == q && r < s);
}

// Insert into a list sorted by `beats`; the last entry falls off.  Fully
// unrolled so the list stays in registers.
template <int KMAX>
__device__ __forceinline__ void insert(int (&tp)[KMAX], int (&ti)[KMAX], int p, int r) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (beats(p, r, tp[j], ti[j])) {
      const int tq = tp[j];
      const int tr = ti[j];
      tp[j] = p;
      ti[j] = r;
      p = tq;
      r = tr;
    }
  }
}

// Insert a priority known to beat tp[KMAX-1] and to come from a later row
// than every listed entry: it goes before the first strictly smaller one.
template <int KMAX>
__device__ __forceinline__ void insert_later(int (&tp)[KMAX], int (&ti)[KMAX], int p, int r) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (p > tp[j]) {
      const int tq = tp[j];
      const int tr = ti[j];
      tp[j] = p;
      ti[j] = r;
      p = tq;
      r = tr;
    }
  }
}

// Scan `count4` staged words (a multiple of 4, 16-byte aligned, padded
// with -1) for rows row0, row0 + 1, ...: four words per LDS.128, one test
// of their maximum against the K-th best, and the per-row inserts in row
// order only when it passes.
template <int KMAX>
__device__ __forceinline__ void scan_words(const int* words, int count4, int row0, int rhm,
                                           int (&tp)[KMAX], int (&ti)[KMAX]) {
  const int4* w4 = reinterpret_cast<const int4*>(words);
  for (int j = 0; j < count4; j += 4) {
    const int4 v = w4[j >> 2];
    const int p0 = v.x ^ rhm, p1 = v.y ^ rhm, p2 = v.z ^ rhm, p3 = v.w ^ rhm;
    if (max(max(p0, p1), max(p2, p3)) > tp[KMAX - 1]) {
      if (p0 > tp[KMAX - 1]) insert_later<KMAX>(tp, ti, p0, row0 + j);
      if (p1 > tp[KMAX - 1]) insert_later<KMAX>(tp, ti, p1, row0 + j + 1);
      if (p2 > tp[KMAX - 1]) insert_later<KMAX>(tp, ti, p2, row0 + j + 2);
      if (p3 > tp[KMAX - 1]) insert_later<KMAX>(tp, ti, p3, row0 + j + 3);
    }
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Words a span of `rows` elements of `bytes` each may cover once aligned
// down to 4 bytes.
__host__ __device__ constexpr int span_words(int rows, int bytes) {
  return (rows * bytes + 3) / 4 + 1;
}

// The byte offset of element `row` of a column of `bytes` per element
// within its span as async_span copies it.
__device__ __forceinline__ int span_off(const void* col, int bytes, long long row) {
  return (int)(((uintptr_t)col + (uintptr_t)(row * bytes)) & 3u);
}

// Start the copy of elements [row0, row0 + rows) of a column of `bytes`
// per element into `dst` (span_words(rows, bytes) words, aligned down to
// 4 bytes; element row0 sits span_off(col, bytes, row0) bytes in); threads
// tid, tid + nthreads, ... each copy one word.
__device__ __forceinline__ void async_span(int* dst, const void* col, int bytes, long long row0,
                                           int rows, int tid, int nthreads) {
  const int off = span_off(col, bytes, row0);
  const int* src = (const int*)((uintptr_t)col + (uintptr_t)(row0 * bytes) - off);
  const int words = (off + rows * bytes + 3) >> 2;
  for (int w = tid; w < words; w += nthreads) cp_async4(dst + w, src + w);
}

// Element r of a staged span (see async_span), widened to i32.
__device__ __forceinline__ int span_at(const int* span, int off, int bytes, int r) {
  const char* p = (const char*)span + off;
  return bytes == 1 ? (int)((const int8_t*)p)[r]
       : bytes == 2 ? (int)((const int16_t*)p)[r]
                    : ((const int*)p)[r];
}

// Exclusive prefix count of `flag` over the threads of an NT-thread block,
// in thread order (a warp ballot, then a sum over the warps); `total` gets
// the block's count.  s_warp holds NT / 32 ints.  Ends with a
// __syncthreads(), so s_warp may be reused at once.
template <int NT>
__device__ __forceinline__ int block_prefix(bool flag, int* s_warp, int& total) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned bal = __ballot_sync(0xFFFFFFFFu, flag);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + __popc(bal & ((1u << lane) - 1u));
}

// Groups of a block from a neighbour compare: threads [0, live) (a prefix)
// each say whether they start a new group (thread 0 always does);
// block_prefix numbers the groups in thread order.  Writes s_start[g] =
// the first thread of group g, and s_start[groups] = live; returns the
// thread's group (-1 beyond live).  Ends with a __syncthreads().
template <int NT>
__device__ __forceinline__ int block_groups(bool starts, int live, int* s_start, int* s_warp,
                                            int& groups) {
  const int t = threadIdx.x;
  starts = (starts || t == 0) && t < live;
  const int g = block_prefix<NT>(starts, s_warp, groups);
  if (starts) s_start[g] = t;
  if (t == 0) s_start[groups] = live;
  __syncthreads();
  // A thread that does not start a group belongs to the last group that
  // started before it: the count of starts before it, minus one.
  return t < live ? (starts ? g : g - 1) : -1;
}

// The register-list width a launch instantiates for k (k <= kMaxK).
inline int kmax_bucket(int k) {
  return k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : k <= 64 ? 64 : 128;
}

// Fold the [splits, B, K] partial lists (each sorted by `beats`, -1
// padded) into out[B, K], splits in order.
template <int KMAX>
__global__ void merge_splits_kernel(const int* part_idx, const int* part_prio, int b, int k,
                                    int splits, int* out_idx, int* out_prio) {
  const int pod = blockIdx.x * blockDim.x + threadIdx.x;
  if (pod >= b) return;
  int tp[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tp[j] = -1;
    ti[j] = -1;
  }
  for (int s = 0; s < splits; ++s) {
    const size_t at = ((size_t)s * b + pod) * k;
    for (int j = 0; j < k; ++j) {
      const int p = part_prio[at + j];
      if (p < 0) break;  // each split's list is sorted: the rest is empty
      const int r = part_idx[at + j];
      if (beats(p, r, tp[KMAX - 1], ti[KMAX - 1])) insert<KMAX>(tp, ti, p, r);
    }
  }
  for (int j = 0; j < k; ++j) {
    int p = -1, r = -1;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      if (q == j) {
        p = tp[q];
        r = ti[q];
      }
    }
    out_prio[(size_t)pod * k + j] = p;
    out_idx[(size_t)pod * k + j] = p >= 0 ? r : -1;
  }
}

template <int KMAX>
cudaError_t merge_splits(const int* part_idx, const int* part_prio, int b, int k, int splits,
                         int* out_idx, int* out_prio, cudaStream_t stream) {
  const int threads = 128;
  merge_splits_kernel<KMAX><<<(b + threads - 1) / threads, threads, 0, stream>>>(
      part_idx, part_prio, b, k, splits, out_idx, out_prio);
  return cudaGetLastError();
}

}  // namespace k8s
