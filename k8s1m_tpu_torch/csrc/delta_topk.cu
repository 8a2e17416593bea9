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
// - At block start thread 0 lists the block's distinct slots (at most
//   min(S, 128)).  Per 128-column tile the block stages, for each of them,
//   one i32 per column in shared memory: (clip(score) << 20 | stratum |
//   (column hash & low_mask)) where feasible, else -1.  Everything but the
//   pod's row hash is then done once per (slot, column), not per pair.
// - Per pair a thread loads its slot's staged word, xors in its row hash's
//   low bits — stratum | ((rh ^ ch) & m) == (stratum | (ch & m)) ^ (rh & m),
//   since the stratum bits lie above m — skips it if negative, and
//   inserts by (prio, row) into its register list.  Rows are padded to 129
//   words so pods on different slots read different banks.
//
// The hash is uint32 with logical shifts (topk_common.cuh).

#include "topk_common.cuh"

namespace k8s {
namespace {

constexpr int kPods = 128;          // pods per block, one per thread
constexpr int kTile = 128;          // columns staged per shared-memory tile
constexpr int kStride = kTile + 1;  // staged row stride (bank spread)
constexpr int kMaxBlockSlots = kPods;

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
  extern __shared__ int s_val[];                 // [block slots][kStride]
  __shared__ int s_slot[kMaxBlockSlots];         // the block's distinct slots
  __shared__ int s_local[kPods];                 // per thread: index into s_slot
  __shared__ int s_nslots;

  const int t = threadIdx.x;
  const int q = blockIdx.x * kPods + t;
  const bool live = q < a.b;
  const int pod = live ? a.order[q] : 0;
  s_local[t] = live ? min(max(a.slot[pod], 0), a.s - 1) : -1;
  __syncthreads();
  if (t == 0) {
    int ns = 0;
    for (int i = 0; i < kPods; ++i) {
      const int sl = s_local[i];
      int at = -1;
      if (sl >= 0) {
        for (int j = 0; j < ns && at < 0; ++j) at = s_slot[j] == sl ? j : at;
        if (at < 0) {
          s_slot[ns] = sl;
          at = ns++;
        }
      }
      s_local[i] = at;
    }
    s_nslots = ns;
  }
  __syncthreads();
  const int ns = s_nslots;
  const int* vals = s_val + (live ? s_local[t] : 0) * kStride;

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

  for (int base = row0; base < row1; base += kTile) {
    __syncthreads();  // the previous tile is consumed
    // Thread t stages column base + t of every slot of the block.
    const int col = base + t;
    const bool in = col < row1;
    const uint32_t c = (uint32_t)col + (uint32_t)a.col_base;
    const uint32_t cs =  // stratum | (column hash & low_mask)
        in ? jitter_of(hash_stratum(c, a.stratum_bits, low), 0u, hash_col(a.seed, c), low_mask)
           : 0u;
    for (int d = 0; d < ns; ++d) {
      int v = -1;
      if (in) {
        const size_t at = (size_t)s_slot[d] * a.n + col;
        if (a.pmask[at]) {
          v = (min(max(__ldg(a.pscore + at), 0), kMaxScore) << kJitterBits) | (int)cs;
        }
      }
      s_val[d * kStride + t] = v;
    }
    __syncthreads();

    if (!live) continue;
    const int count = min(kTile, row1 - base);
    for (int j = 0; j < count; ++j) {
      const int prio = vals[j] ^ rhm;
      if (prio < 0) continue;  // infeasible: -1 stays negative under the xor
      const int row = base + j;
      if (beats(prio, row, tp[KMAX - 1], ti[KMAX - 1])) insert<KMAX>(tp, ti, prio, row);
    }
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
  const int block_slots = a.s < kMaxBlockSlots ? a.s : kMaxBlockSlots;
  const size_t smem = (size_t)block_slots * kStride * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        delta_topk_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.b + kPods - 1) / kPods, splits);
  delta_topk_kernel<KMAX><<<grid, kPods, smem, stream>>>(a);
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
