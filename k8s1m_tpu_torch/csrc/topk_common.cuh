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
// Included by fused_topk.cuh (the filter+score+top-K kernel) and
// delta_topk.cu (the deltasched plane tail).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k8s {

constexpr int kJitterBits = 20;
constexpr int kMaxScore = 2047;
constexpr int kMaxK = 128;        // the Pallas running list is 128 wide

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
