// The deltasched plane tail: per-pod slot gather over the merged
// feasibility/score planes, hashed priority, running top-K.
//
// Replaces: k8s1m_tpu/ops/pallas_topk.py::_delta_kernel (:1041), launched by
// _delta_call (:1119) and wrapped by delta_plane_topk (:1165).  For each pod
// i (slot s_i = clip(slot[i], 0, S-1), like the Pallas kernel) and plane
// column c:
//   prio = clip(pscore[s_i, c], 0, 2047) << 20 | hash_jitter(seed,
//          i + row_base, c + col_base, stratum_bits)   where pmask[s_i, c],
//          -1 otherwise;
// and each pod keeps its top K by (prio descending, column ascending);
// slots without a feasible column come back as prio -1, idx -1.  Columns
// are plane-local; the caller adds its row offset.
//
// Bound on an H100: operations, not bytes.  A wave visits B x N pairs
// (4096 x 1,048,576 = 4.3e9 on the main path) while the unique plane bytes
// are 5 B per (slot, column): 5 MiB at S=1, 320 MiB at S=64 (<= 0.1 ms at
// 3.35 TB/s).  Per pair the function needs the feasibility test, the pod's
// half of the hash and the compare against the K-th best entry.
//
// Design, and what it does about that bound:
// - A block owns 128 pods (one per thread) x one contiguous split of the
//   columns; per-split partial lists are folded by topk_common.cuh's
//   merge_splits_kernel (earlier-split-wins).  The wrapper hands the pods
//   over sorted by slot (`order`), so a block's pods share few slots.
// - The slot gather is direct loads: the Pallas kernel's one-hot
//   [TB, S] x [S, 3C] MXU product over 16-bit score halves becomes
//   pmask[slot * N + c] read as uint8 straight from the torch bool plane
//   and pscore[slot * N + c] as i32 (exact over the whole i32 range).
// - The block's distinct slots come from a neighbour compare of the
//   sorted slots and a warp-ballot prefix sum (block_groups), not a serial
//   loop.
// - Per tile the block stages, for each distinct slot, one i32 per column
//   in shared memory: (clip(score) << 20 | stratum | (column hash &
//   low_mask)) where feasible, else -1.  Everything but the pod's row hash
//   is then done once per (slot, column), not per pair.  A block with up
//   to kAsyncSlots slots copies the next tile's plane rows (128 mask bytes
//   and 512 score bytes per slot) with cp.async while it stages and scans
//   the current one; a block with more slots loads them directly.
// - Per pair a thread runs topk_common.cuh's scan_words over its slot's
//   staged row: four words per LDS.128, one xor and one compare each, and
//   an insert only for a priority above its K-th best.  Tiles are 128
//   columns for up to 27 slots in a block, 64 for up to 52, 32 for up to
//   99, else 16, so the staged words fit kStageWords and eight blocks fit
//   an SM.
//
// The hash is uint32 with logical shifts (topk_common.cuh).

#include "topk_common.cuh"

namespace k8s {
namespace {

constexpr int kPods = 128;          // pods per block, one per thread
constexpr int kTile = 128;          // widest tile of columns; splits are multiples of it
constexpr int kAsyncSlots = 4;      // slots whose plane rows a block copies asynchronously
constexpr int kMaskWords = 36;      // span_words(kTile, 1), rounded up to 4
constexpr int kScoreWords = 132;    // span_words(kTile, 4), rounded up to 4
static_assert(span_words(kTile, 1) <= kMaskWords && span_words(kTile, 4) <= kScoreWords,
              "a staged plane span must fit");

struct DeltaArgs {
  const uint8_t* pmask;   // bool[S, N]
  const int* pscore;      // i32[S, N]
  const int* slot;        // i32[B]
  const int* order;       // i32[B]: pods sorted by clipped slot
  int s;
  int n;
  int b;
  int k;
  uint32_t seed;
  int row_base;
  int col_base;
  int stratum_bits;
  int rows_per_split;
  int* part_idx;          // i32[splits, B, K]
  int* part_prio;
};

template <int KMAX>
__global__ void __launch_bounds__(kPods) delta_topk_kernel(const DeltaArgs a) {
  __shared__ __align__(16) int s_val[kStageWords];   // [slots][tile + pad]
  __shared__ int s_mask[2][kAsyncSlots][kMaskWords];
  __shared__ int s_score[2][kAsyncSlots][kScoreWords];
  __shared__ int s_cl[kPods];                        // clipped slot per thread
  __shared__ int s_start[kPods + 1];
  __shared__ int s_warp[kPods / 32];

  const int t = threadIdx.x;
  const int q = blockIdx.x * kPods + t;
  const int live_n = min(kPods, a.b - blockIdx.x * kPods);
  const bool live = t < live_n;
  const int pod = live ? a.order[q] : 0;
  const int cl = live ? min(max(a.slot[pod], 0), a.s - 1) : -1;
  s_cl[t] = cl;
  __syncthreads();
  int ns;
  const int g = block_groups<kPods>(t > 0 && live && s_cl[t - 1] != cl, live_n, s_start, s_warp,
                                    ns);
  const int tile = tile_rows_for(ns);
  const int stride = tile + kStagePad;
  const bool async = ns <= kAsyncSlots;
  // The slot of staged row d: that of the group's first thread.
  auto slot_of = [&](int d) { return s_cl[s_start[d]]; };

  const int split = blockIdx.y;
  const int row0 = split * a.rows_per_split;
  const int row1 = min(row0 + a.rows_per_split, a.n);
  const int low = kJitterBits - a.stratum_bits;
  const uint32_t low_mask = (1u << low) - 1u;
  const uint32_t row_id = (uint32_t)pod + (uint32_t)a.row_base;
  const int rhm = live ? (int)(hash_row(a.seed, row_id) & low_mask) : 0;

  int tp[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tp[j] = -1;
    ti[j] = -1;
  }

  // Start the copies of tile [base, base + tile) of every slot into buffer buf.
  auto start_copies = [&](int base, int buf) {
    const int rows = min(tile, row1 - base);
    for (int d = 0; d < ns; ++d) {
      const size_t at = (size_t)slot_of(d) * a.n;
      async_span(s_mask[buf][d], a.pmask + at, 1, base, rows, t, kPods);
      async_span(s_score[buf][d], a.pscore + at, 4, base, rows, t, kPods);
    }
    cp_async_commit();
  };
  if (async && row0 < row1) start_copies(row0, 0);

  int buf = 0;
  for (int base = row0; base < row1; base += tile, buf ^= 1) {
    if (async) {
      if (base + tile < row1) {
        start_copies(base + tile, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();  // this tile's plane rows have landed; the last scan is done
    const int count = min(tile, row1 - base);
    const int count4 = (count + 3) & ~3;
    if (t < count4) {
      // Thread t stages column base + t of every slot of the block.
      const int col = base + t;
      const bool in = t < count;
      const uint32_t c = (uint32_t)col + (uint32_t)a.col_base;
      const uint32_t cs =  // stratum | (column hash & low_mask)
          in ? jitter_of(hash_stratum(c, a.stratum_bits, low), 0u, hash_col(a.seed, c),
                         low_mask)
             : 0u;
      for (int d = 0; d < ns; ++d) {
        int v = -1;
        if (in) {
          bool ok;
          int sc;
          if (async) {
            const size_t at = (size_t)slot_of(d) * a.n;
            ok = span_at(s_mask[buf][d], span_off(a.pmask + at, 1, base), 1, t) != 0;
            sc = span_at(s_score[buf][d], span_off(a.pscore + at, 4, base), 4, t);
          } else {
            const size_t at = (size_t)slot_of(d) * a.n + col;
            ok = a.pmask[at] != 0;
            sc = ok ? __ldg(a.pscore + at) : 0;
          }
          if (ok) v = (min(max(sc, 0), kMaxScore) << kJitterBits) | (int)cs;
        }
        s_val[d * stride + t] = v;
      }
    }
    __syncthreads();
    if (live) scan_words<KMAX>(s_val + g * stride, count4, base, rhm, tp, ti);
  }

  if (live) {
    const size_t out = ((size_t)split * a.b + pod) * a.k;
    for (int j = 0; j < a.k; ++j) {
      // Register arrays must be indexed statically: select slot j.
      int p = -1, r = -1;
#pragma unroll
      for (int x = 0; x < KMAX; ++x) {
        if (x == j) {
          p = tp[x];
          r = ti[x];
        }
      }
      a.part_prio[out + j] = p;
      a.part_idx[out + j] = p >= 0 ? r : -1;
    }
  }
}

template <int KMAX>
cudaError_t launch(const DeltaArgs& a, int splits, int* out_idx, int* out_prio,
                   cudaStream_t stream) {
  // Eight blocks of ~24 KB of shared memory need a large carveout.
  static const cudaError_t carve = cudaFuncSetAttribute(
      delta_topk_kernel<KMAX>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return carve;
  const dim3 grid((a.b + kPods - 1) / kPods, splits);
  delta_topk_kernel<KMAX><<<grid, kPods, 0, stream>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge_splits<KMAX>(a.part_idx, a.part_prio, a.b, a.k, splits, out_idx, out_prio,
                            stream);
}

// Pointer and integer arguments, in the order the wrapper
// (ops/delta_topk.py _PTRS / _INTS) passes them.
enum Ptr { P_PMASK, P_PSCORE, P_SLOT, P_ORDER, P_PART_IDX, P_PART_PRIO, P_OUT_IDX, P_OUT_PRIO,
           P_COUNT };
enum Int { I_S, I_N, I_B, I_K, I_SEED, I_ROW_BASE, I_COL_BASE, I_STRATUM_BITS, I_SPLITS,
           I_COUNT };

}  // namespace
}  // namespace k8s

// Plain C entry point, bound with ctypes.  `ptrs` holds P_COUNT device
// pointers, `ints` I_COUNT integers; the launches go to `stream` and nothing
// synchronises.  Returns cudaGetLastError() after the launches (0 = ok);
// the wrapper has validated shapes, dtypes and contiguity.
extern "C" int k8s_delta_topk(const long long* ptrs, int n_ptrs, const long long* ints,
                              int n_ints, void* stream) {
  using namespace k8s;
  if (n_ptrs != P_COUNT || n_ints != I_COUNT) return (int)cudaErrorInvalidValue;
  auto iv = [&](int i) { return (int)ints[i]; };
  const int s = iv(I_S), n = iv(I_N), b = iv(I_B), k = iv(I_K), splits = iv(I_SPLITS);
  const int sb = iv(I_STRATUM_BITS);
  if (s < 1 || n < 1 || b < 1 || k < 1 || k > kMaxK || splits < 1 || sb < 0 ||
      sb > kJitterBits) {
    return (int)cudaErrorInvalidValue;
  }
  DeltaArgs a{};
  a.pmask = (const uint8_t*)(uintptr_t)ptrs[P_PMASK];
  a.pscore = (const int*)(uintptr_t)ptrs[P_PSCORE];
  a.slot = (const int*)(uintptr_t)ptrs[P_SLOT];
  a.order = (const int*)(uintptr_t)ptrs[P_ORDER];
  a.s = s;
  a.n = n;
  a.b = b;
  a.k = k;
  a.seed = (uint32_t)ints[I_SEED];
  a.row_base = iv(I_ROW_BASE);
  a.col_base = iv(I_COL_BASE);
  a.stratum_bits = sb;
  // Whole tiles per split, so every block's loads start tile-aligned.
  const int per = (n + splits - 1) / splits;
  a.rows_per_split = (per + kTile - 1) / kTile * kTile;
  a.part_idx = (int*)(uintptr_t)ptrs[P_PART_IDX];
  a.part_prio = (int*)(uintptr_t)ptrs[P_PART_PRIO];
  int* oi = (int*)(uintptr_t)ptrs[P_OUT_IDX];
  int* op = (int*)(uintptr_t)ptrs[P_OUT_PRIO];
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (kmax_bucket(k)) {
    case 4: err = launch<4>(a, splits, oi, op, st); break;
    case 8: err = launch<8>(a, splits, oi, op, st); break;
    case 16: err = launch<16>(a, splits, oi, op, st); break;
    case 32: err = launch<32>(a, splits, oi, op, st); break;
    case 64: err = launch<64>(a, splits, oi, op, st); break;
    default: err = launch<128>(a, splits, oi, op, st); break;
  }
  return (int)err;
}

// Resident blocks per SM of the kernel instantiation a launch with this k
// would use (cudaOccupancyMaxActiveBlocksPerMultiprocessor); negative on
// error.
extern "C" int k8s_delta_blocks_per_sm(int k) {
  using namespace k8s;
  if (k < 1 || k > kMaxK) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err;
  switch (kmax_bucket(k)) {
    case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, delta_topk_kernel<4>, kPods, 0); break;
    case 8: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, delta_topk_kernel<8>, kPods, 0); break;
    case 16: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, delta_topk_kernel<16>, kPods, 0); break;
    case 32: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, delta_topk_kernel<32>, kPods, 0); break;
    case 64: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, delta_topk_kernel<64>, kPods, 0); break;
    default: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, delta_topk_kernel<128>, kPods, 0); break;
  }
  return err == cudaSuccess ? blocks : -(int)err;
}
