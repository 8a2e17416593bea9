// Fused filter + score + hashed priority + running top-K over the node table.
//
// Replaces: k8s1m_tpu/ops/pallas_topk.py::_kernel (:139), all three of its
// compile-time stages, for the plain and packed table layouts:
//   base      :139-281, :556-603 — row validity, NodeResourcesFit,
//             NodeName, TaintToleration, LeastAllocated/BalancedAllocation;
//   with_aff  :285-435 — NodeAffinity: nodeSelector, required terms (OR of
//             ANDed In/NotIn/Exists/DoesNotExist/Gt/Lt), preferred score;
//   with_cons :448-554 — PodTopologySpread skew filter and score,
//             InterPodAffinity required/anti/symmetry filters and
//             preferred score, from the count tables and prologue stats.
// Each is a template flag <PACKED, WITH_AFF, WITH_CONS, KMAX>, so one launch
// computes any combination, as the Pallas kernel does.  For each pod and
// node row of the window:
//   prio = clip(score, 0, 2047) << 20 | hash_jitter(seed, pod + row_base,
//          col + col_base, stratum_bits), -1 where infeasible;
// and each pod keeps its top K by (prio descending, row ascending); slots
// without a feasible node come back as prio -1, idx -1.  Rows are
// window-local; the caller adds its window offset.
//
// Bound on an H100: every stage is bound by operations, not bytes.  At the
// main-path shapes (B = 4096 pods x a 53,248-row window) a wave evaluates
// ~2.2e8 pod-node pairs over a few MB of node columns: tens of integer and
// f32 operations per pair against ~40-200 bytes per node shared by 4096
// pods.  The affinity stage adds, per pair, ~10 + V operations for each live
// selector expression (V = values per In/NotIn set) plus the resolve of the
// batch's query keys, amortised over a block's 128 pods; the constraint stage
// adds ~15 operations and 2-3 cached loads per live ref, and the f32
// divisions of the scores.
//
// Design, and what it does about that bound:
// - A block owns 128 pods (one per thread) x one contiguous split of the
//   node range; nothing carries between blocks.  Partial [splits, B, K]
//   lists are merged by a second small kernel with the same (prio, row)
//   insertion, which keeps earlier-split-wins.
// - Node rows are staged in 128-row shared-memory tiles with every quantity
//   that does not depend on the pod precomputed once per tile (free
//   capacity, f32 allocatable, the column half of the hash, decoded taint
//   slots, widened zone/region ids), read by all threads at once.
// - Affinity: per tile the block resolves the batch's Q query keys against
//   the tile's label slots into shared memory (found, value id, numeric;
//   last matching slot wins, as the Pallas loop does; the fused packed
//   word decodes as key = w & (2^kb - 1), val = w >> kb).  Each thread then
//   evaluates its pod's live selector expressions slot by slot over the
//   128 rows into bit masks held in registers (nodeSelector AND, required
//   terms OR-of-AND, one mask per preferred term), loading the pod's slot
//   data once per tile.  The rows are padded to 129 so pods reading
//   different keys hit different banks.  The Pallas one-hot matmuls over
//   16-bit halves become these direct integer loads: ids and numerics
//   compare exactly over the full i32 range.
// - Constraints: per pair and live ref, the node count is a load of
//   node_tab[slot * ld + row] through the window's column view (row stride
//   ld, no copy), zone/region counts are tab[slot * Z + zone] from the
//   small whole tables; per-pod ref records are [field][ref][B] so a
//   warp's loads coalesce.  Refs that cannot change the result (not live,
//   no required term, zero preferred sign) are skipped.
// - Filters run first and skip the scoring of infeasible pairs; each
//   thread keeps its pod's top K in registers, inserting by (prio, row).
//
// Exactness: build with IEEE division and --fmad=false (never fast math) so
// the f32 scores match the reference digit for digit before their floor;
// the f32 expressions follow the Pallas kernel's order (pallas_topk.py:
// 274-280, 435, 509-515, 534-554); ints convert to float round-to-nearest;
// i32 sums wrap as in the reference; the hash, the (prio, row) insertion
// and the split merge are topk_common.cuh's, shared with delta_topk.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "topk_common.cuh"

namespace k8s {

constexpr int kPods = 128;        // pods per block, one per thread
constexpr int kTile = kPods;      // nodes staged per shared-memory tile
constexpr int kMaxTaintSlots = 16;
constexpr int kTolWords = 4;      // tolerated bits per pod: max_taint_ids <= 128
constexpr uint16_t kHardBit = 0x8000;

constexpr int kMaxQueryKeys = 16;      // PodSpec.query_keys
constexpr int kMaxValues = 8;          // PodSpec.aff_values
constexpr int kMaxPrefTerms = 4;       // PodSpec.pref_terms
constexpr int kResolveStride = kTile + 1;
constexpr int kNoNumeric = (int)0x80000000;
constexpr int kOpIn = 0, kOpNotIn = 1, kOpExists = 2, kOpDoesNotExist = 3, kOpGt = 4, kOpLt = 5;
constexpr int kTopoHostname = 0, kTopoZone = 1;

// Per-pod constraint records, i32[fields][refs][B] (pod index fastest).
enum SpreadField { kSpCid, kSpTopo, kSpSkew, kSpHard, kSpLive, kSpSelf, kSpMin, kSpMax, kSpFields };
enum IpaField { kIaTid, kIaTopo, kIaReqAff, kIaReqAnti, kIaBoot, kIaPrefSign, kIaFields };
enum SymField { kIiTid, kIiTopo, kIiValid, kIiFields };
enum PodField { kCsBound, kCsHasPref, kCsNrefs, kCsFields };

struct Args {
  // ---- base stage
  const int* cpu_alloc;
  const int* mem_alloc;
  const void* pods_alloc;   // i32[N] plain, i16[N] packed
  const int* cpu_req;
  const int* mem_req;
  const int* pods_req;
  const int* name_id;
  const void* taint_id;     // i32[N, TS] plain, i16[N, TS] packed
  const int* taint_eff;     // i32[N, TS] plain only
  const int* meta;          // i32[N] packed only
  int n;
  int ts;
  const int* p_cpu;
  const int* p_mem;
  const uint8_t* p_valid;
  const int* p_nnid;
  const uint8_t* tolerated; // bool[B, M]
  int b;
  int m;
  uint32_t seed;
  int row_base;
  int col_base;
  int stratum_bits;
  int w_la;
  int w_ba;
  int w_tt;
  int k;
  int rows_per_split;
  int* part_idx;            // i32[splits, B, K]
  int* part_prio;
  // ---- affinity stage (pod arrays are the PodBatch's, row-major by pod)
  const int* label_key;     // i32[N, L]: keys, or fused val << key_bits | key
  const int* label_val;     // i32[N, L], unused when fused
  const int* label_num;     // i32[N, L]
  int l;
  int fused;
  int key_bits;
  const int* qkey;          // i32[Q]
  int q;
  const uint8_t* sel_valid; // [B, S]
  const int* sel_qidx;
  const int* sel_val;
  int s;
  const uint8_t* req_tv;    // [B, T]
  const uint8_t* req_ev;    // [B, T, E]
  const int* req_qidx;
  const int* req_op;
  const int* req_num;
  const int* req_vals;      // [B, T, E, V]
  int t;
  int e;
  int v;
  const uint8_t* pref_tv;   // [B, P]
  const int* pref_w;
  const uint8_t* pref_ev;   // [B, P, E]
  const int* pref_qidx;
  const int* pref_op;
  const int* pref_num;
  const int* pref_vals;     // [B, P, E, V]
  int p;
  int w_na;
  // ---- constraint stage
  const void* zone;         // [N] of zone_bytes each (i32 plain; i16 packed)
  const void* region;       // [N] of region_bytes each (i32 plain; i8 packed)
  int zone_bytes;
  int region_bytes;
  const int* spread_node;   // [SS, ld] window column views, row stride ld
  const int* tgt_node;      // [AS, ld]
  const int* own_node;      // [AS, ld]
  long long ld;
  int ss;
  int as;
  const int* spread_zone;   // [SS, Z]
  const int* spread_region; // [SS, R]
  const int* tgt_zone;      // [AS, Z]
  const int* tgt_region;
  const int* own_zone;
  const int* own_region;
  int zd;
  int rd;
  const int* sp;            // [kSpFields, SR, B]
  int sr;
  const int* ia;            // [kIaFields, AR, B]
  int ar;
  const int* ii;            // [kIiFields, AI, B]
  int ai;
  const int* cs;            // [kCsFields, B]
  int w_ts;
  int w_ipa;
};

// i32 arithmetic that wraps, as XLA's and PyTorch's does.
__device__ __forceinline__ int wadd(int x, int y) { return (int)((uint32_t)x + (uint32_t)y); }
__device__ __forceinline__ int wsub(int x, int y) { return (int)((uint32_t)x - (uint32_t)y); }
__device__ __forceinline__ int wmul(int x, int y) { return (int)((uint32_t)x * (uint32_t)y); }

// Register arrays must be indexed statically: select word w of four.
__device__ __forceinline__ uint32_t word_of(const uint32_t (&a)[kTile / 32], int w) {
  uint32_t x = a[0];
#pragma unroll
  for (int i = 1; i < kTile / 32; ++i) x = (w == i) ? a[i] : x;
  return x;
}

struct AffShared {
  int qkey[kMaxQueryKeys];
  // Row kMaxQueryKeys stays zero: a query index outside [0, Q) reads it,
  // i.e. resolves to not-found, as the Pallas one-hot selection does.
  int found[kMaxQueryKeys + 1][kResolveStride];
  int val[kMaxQueryKeys + 1][kResolveStride];
  int num[kMaxQueryKeys + 1][kResolveStride];
};
struct ConsShared {
  int zone[kTile];
  int region[kTile];
};
struct NoShared {};

// One selector expression over the 32 rows of word w: bit b is the result
// for row w * 32 + b (match_expressions semantics, ops/label_match.py).
__device__ __forceinline__ uint32_t expr_word(const AffShared& sa, int q, int op, int operand,
                                              const int (&vals)[kMaxValues], int nv, int w) {
  uint32_t bits = 0u;
  const int* f = sa.found[q] + w * 32;
  switch (op) {
    case kOpIn:
    case kOpNotIn: {
      const int* val = sa.val[q] + w * 32;
      for (int b = 0; b < 32; ++b) {
        const int x = val[b];
        bool in = false;
#pragma unroll
        for (int i = 0; i < kMaxValues; ++i) in |= (i < nv) & (x == vals[i]);
        const bool hit = (f[b] != 0) & in;
        bits |= (uint32_t)(op == kOpIn ? hit : !hit) << b;
      }
      break;
    }
    case kOpExists:
    case kOpDoesNotExist:
      for (int b = 0; b < 32; ++b) {
        bits |= (uint32_t)((f[b] != 0) == (op == kOpExists)) << b;
      }
      break;
    case kOpGt:
    case kOpLt: {
      if (operand == kNoNumeric) break;
      const int* num = sa.num[q] + w * 32;
      for (int b = 0; b < 32; ++b) {
        const int x = num[b];
        const bool ok = (f[b] != 0) & (x != kNoNumeric) & (op == kOpGt ? x > operand : x < operand);
        bits |= (uint32_t)ok << b;
      }
      break;
    }
    default:
      break;
  }
  return bits;
}

// AND of a term's live expressions over the tile -> tm; false if the term
// has no valid expression (then it matches nothing).  `at` indexes the
// term's first expression in the [B, terms, E] arrays.
__device__ __forceinline__ bool term_words(const AffShared& sa, int ne, int nq, int nv,
                                           const uint8_t* ev, const int* qidx, const int* op,
                                           const int* num, const int* vals, size_t at,
                                           uint32_t (&tm)[kTile / 32]) {
  bool he = false;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) tm[w] = ~0u;
  for (int x = 0; x < ne; ++x) {
    const size_t j = at + x;
    if (!ev[j]) continue;
    he = true;
    int q = qidx[j];
    q = (q >= 0 && q < nq) ? q : kMaxQueryKeys;
    int vs[kMaxValues];
#pragma unroll
    for (int i = 0; i < kMaxValues; ++i) vs[i] = i < nv ? vals[j * nv + i] : 0;
    const int o = op[j];
    const int operand = num[j];
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) tm[w] &= expr_word(sa, q, o, operand, vs, nv, w);
  }
  return he;
}

// Count and domain validity of one (slot, topo) ref at one node
// (plugins/topology.py _counts_for; out-of-range slot or domain counts 0).
__device__ __forceinline__ void count_of(const int* node_tab, const int* ztab, const int* rtab,
                                         int slots, int zd, int rd, long long ld, int slot,
                                         int topo, int row, int zone, int region, int& cnt,
                                         bool& dok) {
  const bool slot_ok = slot >= 0 && slot < slots;
  if (topo == kTopoHostname) {
    dok = true;
    cnt = slot_ok ? __ldg(node_tab + (long long)slot * ld + row) : 0;
  } else if (topo == kTopoZone) {
    dok = zone != 0;
    cnt = (slot_ok && zone >= 0 && zone < zd) ? __ldg(ztab + (size_t)slot * zd + zone) : 0;
  } else {
    dok = region != 0;
    cnt = (slot_ok && region >= 0 && region < rd) ? __ldg(rtab + (size_t)slot * rd + region) : 0;
  }
}

__device__ __forceinline__ int widen(const void* p, int bytes, int r) {
  return bytes == 1 ? (int)((const int8_t*)p)[r]
       : bytes == 2 ? (int)((const int16_t*)p)[r]
                    : ((const int*)p)[r];
}

template <bool PACKED, bool WITH_AFF, bool WITH_CONS, int KMAX>
__global__ void __launch_bounds__(kPods) fused_topk_kernel(const Args a) {
  __shared__ int s_free_cpu[kTile];
  __shared__ int s_free_mem[kTile];
  __shared__ int s_cpu_req[kTile];
  __shared__ int s_mem_req[kTile];
  __shared__ int s_name[kTile];
  __shared__ float s_alloc_cpu[kTile];
  __shared__ float s_alloc_mem[kTile];
  __shared__ uint32_t s_col_hash[kTile];
  __shared__ uint32_t s_stratum[kTile];
  __shared__ int s_flags[kTile];                 // bit 0 row usable, bits 8+ taint count
  __shared__ uint16_t s_taints[kTile][kMaxTaintSlots];  // tid | kHardBit
  __shared__ std::conditional_t<WITH_AFF, AffShared, NoShared> sa;
  __shared__ std::conditional_t<WITH_CONS, ConsShared, NoShared> sc;

  const int split = blockIdx.y;
  const int pod = blockIdx.x * kPods + threadIdx.x;
  const int row0 = split * a.rows_per_split;
  const int row1 = min(row0 + a.rows_per_split, a.n);
  const int low = kJitterBits - a.stratum_bits;
  const uint32_t low_mask = (1u << low) - 1u;

  bool live = false;
  int pcpu = 0, pmem = 0, pnn = 0;
  uint32_t tol[kTolWords];
#pragma unroll
  for (int w = 0; w < kTolWords; ++w) tol[w] = 0u;
  uint32_t row_hash = 0u;
  if (pod < a.b) {
    live = a.p_valid[pod] != 0;
    pcpu = a.p_cpu[pod];
    pmem = a.p_mem[pod];
    pnn = a.p_nnid[pod];
    const uint8_t* trow = a.tolerated + (size_t)pod * a.m;
#pragma unroll
    for (int w = 0; w < kTolWords; ++w) {
      uint32_t word = 0u;
      for (int bit = 0; bit < 32; ++bit) {
        const int t = w * 32 + bit;
        if (t < a.m && trow[t]) word |= 1u << bit;
      }
      tol[w] = word;
    }
    const uint32_t row_id = (uint32_t)pod + (uint32_t)a.row_base;
    row_hash = hash_row(a.seed, row_id);
  }

  // Per-pod constants of the affinity stage: required terms present, and
  // each preferred term's weight (live * weight as f32) and their total.
  bool has_terms = false;
  float pref_wt[kMaxPrefTerms];
  float wtot = 0.0f;
#pragma unroll
  for (int x = 0; x < kMaxPrefTerms; ++x) pref_wt[x] = 0.0f;
  if constexpr (WITH_AFF) {
    if (threadIdx.x < a.q) sa.qkey[threadIdx.x] = a.qkey[threadIdx.x];
    sa.found[kMaxQueryKeys][threadIdx.x] = 0;
    sa.val[kMaxQueryKeys][threadIdx.x] = 0;
    sa.num[kMaxQueryKeys][threadIdx.x] = 0;
    if (pod < a.b) {
      for (int x = 0; x < a.t; ++x) has_terms |= a.req_tv[(size_t)pod * a.t + x] != 0;
#pragma unroll
      for (int x = 0; x < kMaxPrefTerms; ++x) {
        if (x < a.p) {
          const size_t at = (size_t)pod * a.p + x;
          bool he = false;
          for (int y = 0; y < a.e; ++y) he |= a.pref_ev[at * a.e + y] != 0;
          const bool lv = a.pref_tv[at] != 0 && he;
          pref_wt[x] = (float)(lv ? a.pref_w[at] : 0);
          wtot = wtot + pref_wt[x];
        }
      }
    }
  }
  // Per-pod constants of the constraint stage.
  float nrefs_f = 1.0f, bound_f = 1.0f;
  bool has_pref = false;
  if constexpr (WITH_CONS) {
    if (pod < a.b) {
      bound_f = (float)a.cs[kCsBound * a.b + pod];
      has_pref = a.cs[kCsHasPref * a.b + pod] != 0;
      nrefs_f = (float)a.cs[kCsNrefs * a.b + pod];
    }
  }

  int tp[KMAX];
  int ti[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tp[j] = -1;
    ti[j] = -1;
  }

  for (int base = row0; base < row1; base += kTile) {
    __syncthreads();  // the previous tile is consumed
    const int r = base + threadIdx.x;
    if (r < row1) {
      const int pods_alloc = PACKED ? (int)((const int16_t*)a.pods_alloc)[r]
                                    : ((const int*)a.pods_alloc)[r];
      const int meta = PACKED ? a.meta[r] : 0;
      bool usable = pods_alloc - a.pods_req[r] >= 1;
      if (PACKED) usable = usable && (meta & 1);
      const int cpu_alloc = a.cpu_alloc[r];
      const int mem_alloc = a.mem_alloc[r];
      s_free_cpu[threadIdx.x] = cpu_alloc - a.cpu_req[r];
      s_free_mem[threadIdx.x] = mem_alloc - a.mem_req[r];
      s_cpu_req[threadIdx.x] = a.cpu_req[r];
      s_mem_req[threadIdx.x] = a.mem_req[r];
      s_name[threadIdx.x] = a.name_id[r];
      s_alloc_cpu[threadIdx.x] = __int2float_rn(max(cpu_alloc, 1));
      s_alloc_mem[threadIdx.x] = __int2float_rn(max(mem_alloc, 1));
      const uint32_t col = (uint32_t)r + (uint32_t)a.col_base;
      s_col_hash[threadIdx.x] = hash_col(a.seed, col);
      s_stratum[threadIdx.x] = hash_stratum(col, a.stratum_bits, low);
      int nt = 0;
      for (int t = 0; t < a.ts; ++t) {
        const size_t at = (size_t)r * a.ts + t;
        const int tid = PACKED ? (int)((const int16_t*)a.taint_id)[at]
                               : ((const int*)a.taint_id)[at];
        const int eff = PACKED ? (meta >> (1 + 2 * t)) & 3 : a.taint_eff[at];
        const bool hard = eff == 1 || eff == 3;   // NoSchedule, NoExecute
        const bool soft = eff == 2;               // PreferNoSchedule
        // Slot id 0 is "no taint"; ids outside [0, M) match no toleration
        // column, as the Pallas one-hot gather counts nothing for them.
        if (tid > 0 && tid < a.m && (hard || soft)) {
          s_taints[threadIdx.x][nt++] = (uint16_t)(tid | (hard ? kHardBit : 0));
        }
      }
      s_flags[threadIdx.x] = (usable ? 1 : 0) | (nt << 8);
    } else {
      s_flags[threadIdx.x] = 0;
    }
    if constexpr (WITH_AFF) {
      // Resolve the batch's query keys against this row's label slots.
      for (int x = 0; x < a.q; ++x) {
        sa.found[x][threadIdx.x] = 0;
        sa.val[x][threadIdx.x] = 0;
        sa.num[x][threadIdx.x] = 0;
      }
      if (r < row1) {
        const size_t lb = (size_t)r * a.l;
        for (int x = 0; x < a.l; ++x) {
          const int word = a.label_key[lb + x];
          const int lk = a.fused ? (word & ((1 << a.key_bits) - 1)) : word;
          if (lk == 0) continue;                  // NONE slots never match
          const int lv = a.fused ? (word >> a.key_bits) : a.label_val[lb + x];
          const int ln = a.label_num[lb + x];
          for (int y = 0; y < a.q; ++y) {
            if (sa.qkey[y] == lk) {               // last matching slot wins
              sa.found[y][threadIdx.x] = 1;
              sa.val[y][threadIdx.x] = lv;
              sa.num[y][threadIdx.x] = ln;
            }
          }
        }
      }
    }
    if constexpr (WITH_CONS) {
      sc.zone[threadIdx.x] = r < row1 ? widen(a.zone, a.zone_bytes, r) : 0;
      sc.region[threadIdx.x] = r < row1 ? widen(a.region, a.region_bytes, r) : 0;
    }
    __syncthreads();

    if (!live) continue;
    const int count = min(kTile, row1 - base);

    // Affinity masks of this pod over the tile: ok (nodeSelector AND the
    // required terms) and one mask per preferred term.
    uint32_t okw[kTile / 32];
    uint32_t prefw[kMaxPrefTerms][kTile / 32];
    if constexpr (WITH_AFF) {
#pragma unroll
      for (int w = 0; w < kTile / 32; ++w) okw[w] = ~0u;
      for (int x = 0; x < a.s; ++x) {
        const size_t at = (size_t)pod * a.s + x;
        if (!a.sel_valid[at]) continue;
        int q = a.sel_qidx[at];
        q = (q >= 0 && q < a.q) ? q : kMaxQueryKeys;
        int vs[kMaxValues];
#pragma unroll
        for (int i = 0; i < kMaxValues; ++i) vs[i] = 0;
        vs[0] = a.sel_val[at];
#pragma unroll
        for (int w = 0; w < kTile / 32; ++w) okw[w] &= expr_word(sa, q, kOpIn, 0, vs, 1, w);
      }
      if (has_terms) {
        uint32_t any[kTile / 32];
#pragma unroll
        for (int w = 0; w < kTile / 32; ++w) any[w] = 0u;
        for (int x = 0; x < a.t; ++x) {
          const size_t at = (size_t)pod * a.t + x;
          if (!a.req_tv[at]) continue;
          uint32_t tm[kTile / 32];
          if (term_words(sa, a.e, a.q, a.v, a.req_ev, a.req_qidx, a.req_op, a.req_num,
                         a.req_vals, at * a.e, tm)) {
#pragma unroll
            for (int w = 0; w < kTile / 32; ++w) any[w] |= tm[w];
          }
        }
#pragma unroll
        for (int w = 0; w < kTile / 32; ++w) okw[w] &= any[w];
      }
#pragma unroll
      for (int x = 0; x < kMaxPrefTerms; ++x) {
#pragma unroll
        for (int w = 0; w < kTile / 32; ++w) prefw[x][w] = 0u;
        // Dead terms (not set, or no valid expression) keep an empty mask.
        if (x < a.p && a.w_na) {
          const size_t at = (size_t)pod * a.p + x;
          if (a.pref_tv[at]) {
            uint32_t tm[kTile / 32];
            if (term_words(sa, a.e, a.q, a.v, a.pref_ev, a.pref_qidx, a.pref_op,
                           a.pref_num, a.pref_vals, at * a.e, tm)) {
#pragma unroll
              for (int w = 0; w < kTile / 32; ++w) prefw[x][w] = tm[w];
            }
          }
        }
      }
    }

    for (int j = 0; j < count; ++j) {
      if constexpr (WITH_AFF) {
        if (!((word_of(okw, j >> 5) >> (j & 31)) & 1u)) continue;
      }
      const int flags = s_flags[j];
      if (!(flags & 1)) continue;
      if (pcpu > s_free_cpu[j] || pmem > s_free_mem[j]) continue;
      if (pnn != 0 && pnn != s_name[j]) continue;
      const int nt = flags >> 8;
      int soft_cnt = 0;
      bool hard_hit = false;
      for (int t = 0; t < nt; ++t) {
        const int e = s_taints[j][t];
        const int tid = e & 0x7FFF;
        uint32_t word = 0u;
#pragma unroll
        for (int w = 0; w < kTolWords; ++w) word = (w == (tid >> 5)) ? tol[w] : word;
        if (!((word >> (tid & 31)) & 1u)) {
          if (e & kHardBit) hard_hit = true;
          else ++soft_cnt;
        }
      }
      if (hard_hit) continue;

      int score = 0;
      if constexpr (WITH_CONS) {
        // PodTopologySpread: skew filter, then the score of each live ref.
        const int row = base + j;
        const int zone = sc.zone[j];
        const int region = sc.region[j];
        bool ok = true;
        float sp_acc = 0.0f;
        const size_t sstride = (size_t)a.sr * a.b;
        for (int x = 0; x < a.sr && ok; ++x) {
          const int* rec = a.sp + (size_t)x * a.b + pod;
          const bool lv = __ldg(rec + kSpLive * sstride) != 0;
          const bool hard = __ldg(rec + kSpHard * sstride) != 0;
          if (!lv && !hard) continue;  // adds s_ref * 0 and filters nothing
          int cnt;
          bool dok;
          count_of(a.spread_node, a.spread_zone, a.spread_region, a.ss, a.zd, a.rd, a.ld,
                   __ldg(rec + kSpCid * sstride), __ldg(rec + kSpTopo * sstride), row, zone,
                   region, cnt, dok);
          const int minc = __ldg(rec + kSpMin * sstride);
          if (hard) {
            const int lhs = wsub(wadd(cnt, __ldg(rec + kSpSelf * sstride)), minc);
            ok = dok && lhs <= __ldg(rec + kSpSkew * sstride);
          }
          if (ok && a.w_ts) {
            const int maxc = __ldg(rec + kSpMax * sstride);
            const float denom = (float)max(wsub(maxc, minc), 1);
            float s_ref = (100.0f * (float)wsub(maxc, cnt)) / denom;
            s_ref = fminf(fmaxf(s_ref, 0.0f), 100.0f) * (dok ? 1.0f : 0.0f);
            sp_acc = sp_acc + s_ref * (lv ? 1.0f : 0.0f);
          }
        }
        if (!ok) continue;
        // InterPodAffinity: the pod's own terms (required filter,
        // preferred score) ...
        float raw = 0.0f;
        const size_t istride = (size_t)a.ar * a.b;
        for (int x = 0; x < a.ar && ok; ++x) {
          const int* rec = a.ia + (size_t)x * a.b + pod;
          const bool reqaff = __ldg(rec + kIaReqAff * istride) != 0;
          const bool reqanti = __ldg(rec + kIaReqAnti * istride) != 0;
          const int prefsign = __ldg(rec + kIaPrefSign * istride);
          if (!reqaff && !reqanti && prefsign == 0) continue;
          int cnt;
          bool dok;
          count_of(a.tgt_node, a.tgt_zone, a.tgt_region, a.as, a.zd, a.rd, a.ld,
                   __ldg(rec + kIaTid * istride), __ldg(rec + kIaTopo * istride), row, zone,
                   region, cnt, dok);
          if (reqaff) ok = dok && (cnt > 0 || __ldg(rec + kIaBoot * istride) != 0);
          if (reqanti) ok = ok && (!dok || cnt == 0);
          raw = raw + (float)wmul(cnt, dok ? 1 : 0) * (float)prefsign;
        }
        // ... and the symmetry rule from existing pods' anti terms.
        const size_t ostride = (size_t)a.ai * a.b;
        for (int x = 0; x < a.ai && ok; ++x) {
          const int* rec = a.ii + (size_t)x * a.b + pod;
          if (!__ldg(rec + kIiValid * ostride)) continue;
          int cnt;
          bool dok;
          count_of(a.own_node, a.own_zone, a.own_region, a.as, a.zd, a.rd, a.ld,
                   __ldg(rec + kIiTid * ostride), __ldg(rec + kIiTopo * ostride), row, zone,
                   region, cnt, dok);
          ok = !dok || cnt == 0;
        }
        if (!ok) continue;
        if (a.w_ts) score += (int)floorf(sp_acc / nrefs_f) * a.w_ts;
        if (a.w_ipa) {
          const float ipa =
              has_pref ? fminf(fmaxf(50.0f + (50.0f * raw) / bound_f, 0.0f), 100.0f) : 0.0f;
          score += (int)floorf(ipa) * a.w_ipa;
        }
      }

      if (a.w_la || a.w_ba) {
        const float alloc_cpu = s_alloc_cpu[j];
        const float alloc_mem = s_alloc_mem[j];
        const float cpu_after = __int2float_rn(s_cpu_req[j] + pcpu);
        const float mem_after = __int2float_rn(s_mem_req[j] + pmem);
        if (a.w_la) {
          const float la = 50.0f * (fmaxf((alloc_cpu - cpu_after) / alloc_cpu, 0.0f) +
                                    fmaxf((alloc_mem - mem_after) / alloc_mem, 0.0f));
          score += (int)floorf(la) * a.w_la;
        }
        if (a.w_ba) {
          const float f_cpu = fminf(fmaxf(cpu_after / alloc_cpu, 0.0f), 1.0f);
          const float f_mem = fminf(fmaxf(mem_after / alloc_mem, 0.0f), 1.0f);
          const float ba = 100.0f * (1.0f - fabsf(f_cpu - f_mem) / 2.0f);
          score += (int)floorf(ba) * a.w_ba;
        }
      }
      if (a.w_tt) {
        const float tt = 100.0f * (1.0f - __int2float_rn(soft_cnt) / __int2float_rn(a.ts));
        score += (int)floorf(tt) * a.w_tt;
      }
      if constexpr (WITH_AFF) {
        if (a.w_na) {
          float na_acc = 0.0f;
#pragma unroll
          for (int x = 0; x < kMaxPrefTerms; ++x) {
            if (x < a.p) {
              const float hit = (float)((word_of(prefw[x], j >> 5) >> (j & 31)) & 1u);
              na_acc = na_acc + hit * pref_wt[x];
            }
          }
          const float na = 100.0f * na_acc / fmaxf(wtot, 1.0f);
          score += (int)floorf(na) * a.w_na;
        }
      }
      score = min(max(score, 0), kMaxScore);
      const uint32_t jitter = jitter_of(s_stratum[j], row_hash, s_col_hash[j], low_mask);
      const int prio = (score << kJitterBits) | (int)jitter;
      const int row = base + j;
      if (beats(prio, row, tp[KMAX - 1], ti[KMAX - 1])) insert<KMAX>(tp, ti, prio, row);
    }
  }

  if (pod < a.b) {
    const size_t out = ((size_t)split * a.b + pod) * a.k;
    for (int j = 0; j < a.k; ++j) {
      // Register arrays must be indexed statically: select slot j.
      int p = -1, r = -1;
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (q == j) {
          p = tp[q];
          r = ti[q];
        }
      }
      a.part_prio[out + j] = p;
      a.part_idx[out + j] = p >= 0 ? r : -1;
    }
  }
}

template <bool WITH_AFF, bool WITH_CONS, int KMAX>
cudaError_t launch_kernel(const Args& a, bool packed, dim3 grid, cudaStream_t stream) {
  if (packed) {
    fused_topk_kernel<true, WITH_AFF, WITH_CONS, KMAX><<<grid, kPods, 0, stream>>>(a);
  } else {
    fused_topk_kernel<false, WITH_AFF, WITH_CONS, KMAX><<<grid, kPods, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// One stage configuration, every K bucket; each is instantiated in its own
// translation unit (fused_topk_<stage>.cu) so the builds run in parallel.
template <bool WITH_AFF, bool WITH_CONS>
cudaError_t launch_stage(const Args& a, bool packed, int splits, int kmax, cudaStream_t stream) {
  const dim3 grid((a.b + kPods - 1) / kPods, splits);
  switch (kmax) {
    case 4: return launch_kernel<WITH_AFF, WITH_CONS, 4>(a, packed, grid, stream);
    case 8: return launch_kernel<WITH_AFF, WITH_CONS, 8>(a, packed, grid, stream);
    case 16: return launch_kernel<WITH_AFF, WITH_CONS, 16>(a, packed, grid, stream);
    case 32: return launch_kernel<WITH_AFF, WITH_CONS, 32>(a, packed, grid, stream);
    case 64: return launch_kernel<WITH_AFF, WITH_CONS, 64>(a, packed, grid, stream);
    case 128: return launch_kernel<WITH_AFF, WITH_CONS, 128>(a, packed, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k8s
