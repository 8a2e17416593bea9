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
// main-path shapes (B = 4096 pods x a 53,248-row window) a wave covers
// ~2.2e8 pod-node pairs over a few MB of node columns.  The filters and
// scores depend on the pod only through its per-pod inputs, and the pods
// of a wave come from a few deployments, so the least work is the filter
// and score chain once per (distinct pod group, row) plus a scan of a few
// operations per pair for the pod's own hash bits and its top K.
//
// Design, and what it does about that bound:
// - A block owns 128 pods (one per thread) x one contiguous split of the
//   node range; nothing carries between blocks.  Partial [splits, B, K]
//   lists are merged by a second small kernel with the same (prio, row)
//   insertion, which keeps earlier-split-wins.
// - Pod groups, found on the device with no host sync.  The wrapper builds
//   one i32 key row per pod from exactly the per-pod inputs the launched
//   stages read (ops/fused_topk.py::group_key) and hands the pods over
//   sorted by a hash of it (`order`).  Each thread compares its pod's key
//   row word for word with its sorted predecessor's, and a warp-ballot
//   prefix sum (block_groups) numbers the block's groups.  A hash collision
//   only splits or interleaves groups: results never rest on the hash.
// - Staging per (group, row).  Per tile the member of rank p of a group of
//   m pods runs the filter and score chain for rows p, p + m, ... with its
//   own (equal) inputs in registers and writes one word per (group, row):
//   clip(score) << 20 | stratum | (column hash & m) where feasible, else
//   -1.  Then every thread scans its group's words (topk_common.cuh
//   scan_words: an xor of its row-hash bits, one compare, a rare insert).
//   A group of one pod does not stage: it scans each word as it computes
//   it, so a block of 128 distinct pods runs the chain per pair with
//   128-row tiles, as before the redesign.
// - The staged words take kStageWords (14 KB): tiles are 128 rows for up
//   to 27 staged groups in a block, 64 for up to 52, else 32 (at most 64
//   groups of two or more fit 128 pods), so the buffer always holds every
//   staged group and no thread waits for a pass.
// - The node columns of the next tile (the six i32 request/allocatable/
//   name columns, pods_alloc, meta, zone and region) are copied with
//   4-byte cp.async into a second shared buffer while the current tile is
//   staged and scanned; spans align down to 4 bytes, so windows that start
//   at any row and the i16/i8 packed columns need no alignment.  Label
//   slots and count-table columns are read from global memory (label slots
//   once per row, counts per (group, row), coalesced across a group's
//   members).
// - Per tile, thread t computes row t's column hash bits, decodes its
//   hard/soft taint slots into shared memory and, with
//   affinity, resolves the batch's first kResolveKeys query keys against
//   row t's label slots into shared memory (found bits, value id, numeric;
//   last matching slot wins, as the Pallas loop does; the fused packed word
//   decodes as key = w & (2^kb - 1), val = w >> kb).  A member then
//   evaluates its pod's live selector expressions at its own rows only,
//   loading each expression once per tile, into bit masks held in
//   registers.  The Pallas one-hot matmuls over 16-bit halves become these
//   direct integer loads: ids and numerics compare exactly over the full
//   i32 range.
// - Any shape the Pallas kernel takes (it loops over whatever Q, V, P, TS
//   and M it is given) runs here too, with the common shapes on the fast
//   paths above and the rest spilled to global memory, so shared memory
//   and registers do not grow with the shape:
//   * a query key at index >= kResolveKeys resolves per (expression, row)
//     by scanning the row's label slots from the last one back (__ldg);
//   * an In/NotIn set holds its first kMaxValues values in registers and
//     reads the rest with __ldg;
//   * the first kMaxPrefTerms preferred terms are register masks, later
//     ones are evaluated per (group, row) with the same expression code,
//     their weights re-read, so the f32 sum keeps the term order;
//   * a row with more than kStagedTaints counted taints (or a taint id
//     above 15 bits) is marked spilled and its slots are re-read from the
//     table per (group, row); the tolerated bits of ids below 32 *
//     kTolWords sit in registers, the rest are the pod's tolerated bytes
//     (__ldg).
// - Constraints: per (group, row) and live ref, the node count is a load
//   of node_tab[slot * ld + row] through the window's column view (row
//   stride ld, no copy), zone/region counts are tab[slot * Z + zone] from
//   the small whole tables; per-pod ref records are [field][ref][B].  Refs
//   that cannot change the result are skipped.
// - Tensor cores have no part: there is no product, only integer compares
//   and a few f32 divisions per (group, row).
//
// Exactness: build with IEEE division and --fmad=false (never fast math) so
// the f32 scores match the reference digit for digit before their floor;
// the f32 expressions follow the Pallas kernel's order (pallas_topk.py:
// 274-280, 435, 509-515, 534-554); ints convert to float round-to-nearest;
// i32 sums wrap as in the reference; the hash, the scan, the (prio, row)
// insertion and the split merge are topk_common.cuh's, shared with
// delta_topk.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "topk_common.cuh"

namespace k8s {

constexpr int kPods = 128;        // pods per block, one per thread
constexpr int kTile = kPods;      // widest tile of node rows
constexpr int kColWords = 132;    // span_words(kTile, 4), rounded up to 4
static_assert(span_words(kTile, 4) <= kColWords, "a staged column span must fit");
constexpr int kStagedTaints = 16;  // counted taints of a row staged in shared memory
constexpr uint8_t kTaintSpill = 0xFF;  // s_ntaints: re-read the row's slots from the table
constexpr int kTolWords = 4;      // tolerated bits of ids below 128 held in registers
constexpr uint16_t kHardBit = 0x8000;

constexpr int kResolveKeys = 16;       // query keys resolved per tile in shared memory
constexpr int kMaxValues = 8;          // In/NotIn values held in registers
constexpr int kMaxPrefTerms = 4;       // preferred terms held as register masks
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
  const void* taint_id;     // i32[N, TS] plain, i16 or i32[N, TS] packed
  const int* taint_eff;     // i32[N, TS] plain only
  const int* meta;          // i32[N] packed only
  int n;
  int ts;
  int taint_bytes;          // 2 or 4 (packed); 4 plain
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
  // ---- pod groups
  const int* gkey;          // i32[B, kw]: the per-pod inputs of the launched stages
  int kw;
  const int* order;         // i32[B]: pods sorted by a hash of their key row
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

// The node columns of one tile, copied asynchronously (see async_span).
struct BaseRaw {
  int cpu_alloc[kColWords];
  int mem_alloc[kColWords];
  int cpu_req[kColWords];
  int mem_req[kColWords];
  int pods_req[kColWords];
  int name_id[kColWords];
  int pods_alloc[kColWords];
  int meta[kColWords];
};
struct ConsRaw {
  int zone[kColWords];
  int region[kColWords];
};
struct ConsShared {             // the tile's zone and region ids, widened
  int zone[kTile];
  int region[kTile];
};
struct AffShared {
  int qkey[kResolveKeys];
  // Row kResolveKeys stays not-found: a query index outside [0, Q) reads
  // it, i.e. resolves to not-found, as the Pallas one-hot selection does.
  uint32_t found[kResolveKeys + 1][kTile / 32];   // bit j & 31 of word j >> 5: row j
  int val[kResolveKeys + 1][kResolveStride];
  int num[kResolveKeys + 1][kResolveStride];
};
struct NoShared {};

// Register arrays must be indexed statically: select word w of four.
__device__ __forceinline__ uint32_t word_of(const uint32_t (&x)[kTile / 32], int w) {
  uint32_t v = x[0];
#pragma unroll
  for (int i = 1; i < kTile / 32; ++i) v = (w == i) ? x[i] : v;
  return v;
}

// The slot of a query index: itself in [0, Q), else -1 (not found).
__device__ __forceinline__ int query_slot(int q, int nq) { return (q >= 0 && q < nq) ? q : -1; }

// Query slot qs at tile row j (table row `row`): found, value id and
// numeric of the row's last label slot whose key is the query key (none:
// not found, 0, 0).  Slots below kResolveKeys (and -1) read the tile's
// resolve in shared memory; the others scan the row's label slots from
// the last one back.  `key` is qkey[qs] for those (the caller loads it).
__device__ __forceinline__ void resolve_at(const AffShared& sa, const Args& a, int qs, int key,
                                           int j, int row, bool& f, int& x, int& num) {
  if (qs < kResolveKeys) {
    const int r = qs < 0 ? kResolveKeys : qs;
    f = (sa.found[r][j >> 5] >> (j & 31)) & 1u;
    x = sa.val[r][j];
    num = sa.num[r][j];
    return;
  }
  f = false;
  x = 0;
  num = 0;
  const size_t lb = (size_t)row * a.l;
  for (int s = a.l - 1; s >= 0; --s) {
    const int word = __ldg(a.label_key + lb + s);
    const int lk = a.fused ? (word & ((1 << a.key_bits) - 1)) : word;
    if (lk != 0 && lk == key) {               // NONE slots never match
      f = true;
      x = a.fused ? (word >> a.key_bits) : __ldg(a.label_val + lb + s);
      num = __ldg(a.label_num + lb + s);
      return;
    }
  }
}

__device__ __forceinline__ int key_of(const Args& a, int qs) {
  return qs >= kResolveKeys ? __ldg(a.qkey + qs) : 0;
}

// One expression's result from a resolved row (match_expressions
// semantics, ops/label_match.py); the In/NotIn set is read from `vp`.
__device__ __forceinline__ bool expr_value(int op, int operand, bool f, int x, int num,
                                           const int* vp, int nv) {
  switch (op) {
    case kOpIn:
    case kOpNotIn: {
      bool in = false;
      for (int i = 0; i < nv; ++i) in |= x == __ldg(vp + i);
      const bool hit = f & in;
      return op == kOpIn ? hit : !hit;
    }
    case kOpExists: return f;
    case kOpDoesNotExist: return !f;
    case kOpGt:
    case kOpLt:
      return operand != kNoNumeric && f && num != kNoNumeric &&
             (op == kOpGt ? num > operand : num < operand);
    default: return false;
  }
}

// The rows of a member: the k-th row of the member of rank p in a group of
// m pods is p + k * m.  One selector expression at the member's rows
// 32 w .. 32 w + 31 (those below nmine): bit b is its result for row
// p + (32 w + b) * m (match_expressions semantics, ops/label_match.py).
// The first kMaxValues values of an In/NotIn set are `vals`, the rest
// vp[kMaxValues, nv).
__device__ __forceinline__ uint32_t expr_bits(const AffShared& sa, const Args& a, int base,
                                              int qs, int op, int operand,
                                              const int (&vals)[kMaxValues], const int* vp,
                                              int nv, int p, int m, int nmine, int w) {
  uint32_t bits = 0u;
  const int nb = min(32, nmine - 32 * w);
  const int key = key_of(a, qs);
  bool f;
  int x, num;
  switch (op) {
    case kOpIn:
    case kOpNotIn:
      for (int b = 0; b < nb; ++b) {
        const int j = p + (32 * w + b) * m;
        resolve_at(sa, a, qs, key, j, base + j, f, x, num);
        bool in = false;
#pragma unroll
        for (int i = 0; i < kMaxValues; ++i) in |= (i < nv) & (x == vals[i]);
        for (int i = kMaxValues; i < nv && !in; ++i) in = x == __ldg(vp + i);
        const bool hit = f & in;
        bits |= (uint32_t)(op == kOpIn ? hit : !hit) << b;
      }
      break;
    case kOpExists:
    case kOpDoesNotExist:
      for (int b = 0; b < nb; ++b) {
        const int j = p + (32 * w + b) * m;
        resolve_at(sa, a, qs, key, j, base + j, f, x, num);
        bits |= (uint32_t)(f == (op == kOpExists)) << b;
      }
      break;
    case kOpGt:
    case kOpLt:
      if (operand == kNoNumeric) break;
      for (int b = 0; b < nb; ++b) {
        const int j = p + (32 * w + b) * m;
        resolve_at(sa, a, qs, key, j, base + j, f, x, num);
        const bool ok = f & (num != kNoNumeric) & (op == kOpGt ? num > operand : num < operand);
        bits |= (uint32_t)ok << b;
      }
      break;
    default:
      break;
  }
  return bits;
}

// AND of a term's live expressions over the member's rows -> tm; false if
// the term has no valid expression (then it matches nothing).  `at`
// indexes the term's first expression in the [B, terms, E] arrays; the
// expression's loads happen once per tile.
__device__ __forceinline__ bool term_bits(const AffShared& sa, const Args& a, int base, int ne,
                                          int nv, const uint8_t* ev, const int* qidx,
                                          const int* op, const int* num, const int* vals,
                                          size_t at, int p, int m, int nmine,
                                          uint32_t (&tm)[kTile / 32]) {
  bool he = false;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) tm[w] = ~0u;
  for (int x = 0; x < ne; ++x) {
    const size_t j = at + x;
    if (!ev[j]) continue;
    he = true;
    const int qs = query_slot(qidx[j], a.q);
    const int* vp = vals + j * nv;
    int vs[kMaxValues];
#pragma unroll
    for (int i = 0; i < kMaxValues; ++i) vs[i] = i < nv ? vp[i] : 0;
    const int o = op[j];
    const int operand = num[j];
#pragma unroll
    for (int w = 0; w < kTile / 32; ++w) {
      if (32 * w < nmine) tm[w] &= expr_bits(sa, a, base, qs, o, operand, vs, vp, nv, p, m, nmine, w);
    }
  }
  return he;
}

// Preferred term x of a pod at one row (tile row j, table row `row`):
// the AND of its live expressions, false if it has none — the per-row
// form of term_bits for the terms past kMaxPrefTerms.
__device__ __forceinline__ bool pref_term_at(const AffShared& sa, const Args& a, int pod, int x,
                                             int j, int row) {
  const size_t at = ((size_t)pod * a.p + x) * a.e;
  bool he = false;
  for (int y = 0; y < a.e; ++y) {
    const size_t i = at + y;
    if (!__ldg(a.pref_ev + i)) continue;
    he = true;
    const int qs = query_slot(__ldg(a.pref_qidx + i), a.q);
    bool f;
    int xv, num;
    resolve_at(sa, a, qs, key_of(a, qs), j, row, f, xv, num);
    if (!expr_value(__ldg(a.pref_op + i), __ldg(a.pref_num + i), f, xv, num,
                    a.pref_vals + i * a.v, a.v)) {
      return false;
    }
  }
  return he;
}

// Weight of a pod's preferred term x: live * weight as f32 (live = set
// and with a valid expression).
__device__ __forceinline__ float pref_weight(const Args& a, int pod, int x) {
  const size_t at = (size_t)pod * a.p + x;
  bool he = false;
  for (int y = 0; y < a.e; ++y) he |= __ldg(a.pref_ev + at * a.e + y) != 0;
  const bool lv = __ldg(a.pref_tv + at) != 0 && he;
  return (float)(lv ? __ldg(a.pref_w + at) : 0);
}

// Taint slot t of the table row whose slots start at `at`: id and effect.
template <bool PACKED>
__device__ __forceinline__ void taint_slot(const Args& a, size_t at, int t, int meta, int& id,
                                           int& eff) {
  if (PACKED) {
    id = a.taint_bytes == 2 ? (int)((const int16_t*)a.taint_id)[at + t]
                            : ((const int*)a.taint_id)[at + t];
    eff = (meta >> (1 + 2 * t)) & 3;
  } else {
    id = ((const int*)a.taint_id)[at + t];
    eff = a.taint_eff[at + t];
  }
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

template <bool PACKED, bool WITH_AFF, bool WITH_CONS, int KMAX>
__global__ void __launch_bounds__(kPods) fused_topk_kernel(const Args a) {
  __shared__ __align__(16) int s_words[kStageWords];   // [groups][tile + pad]
  __shared__ BaseRaw s_raw[2];
  __shared__ std::conditional_t<WITH_CONS, ConsRaw, NoShared> s_craw[2];
  __shared__ std::conditional_t<WITH_CONS, ConsShared, NoShared> sc;
  __shared__ uint32_t s_colword[kTile];                // stratum | (column hash & m)
  __shared__ uint16_t s_taints[kTile][kStagedTaints];   // taint id | kHardBit, per row
  __shared__ uint8_t s_ntaints[kTile];
  __shared__ int s_start[kPods + 1];
  __shared__ int s_warp[kPods / 32];
  __shared__ std::conditional_t<WITH_AFF, AffShared, NoShared> sa;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kPods;
  const int live_n = min(kPods, a.b - q0);
  const bool here = tid < live_n;
  const int pod = here ? a.order[q0 + tid] : 0;
  if constexpr (WITH_AFF) {
    if (tid < min(a.q, kResolveKeys)) sa.qkey[tid] = a.qkey[tid];
    if (tid < kTile / 32) sa.found[kResolveKeys][tid] = 0u;
    sa.val[kResolveKeys][tid] = 0;
    sa.num[kResolveKeys][tid] = 0;
  }

  // This pod's group: a new one unless its key row equals its sorted
  // predecessor's, word for word.
  bool starts = false;
  if (here && tid > 0) {
    const int* k0 = a.gkey + (size_t)pod * a.kw;
    const int* k1 = a.gkey + (size_t)a.order[q0 + tid - 1] * a.kw;
    int diff = 0;
#pragma unroll 8
    for (int w = 0; w < a.kw; ++w) diff |= __ldg(k0 + w) ^ __ldg(k1 + w);   // loads overlap
    starts = diff != 0;
  }
  int groups;
  const int g = block_groups<kPods>(starts, live_n, s_start, s_warp, groups);
  const int rank = here ? tid - s_start[g] : 0;
  const int gsize = here ? s_start[g + 1] - s_start[g] : 1;
  // Groups of two or more pods stage their words (s_start is reused for
  // their staged row); a group of one scans its words as it computes them.
  const bool leads = here && rank == 0 && gsize > 1;
  int staged;
  const int srow = block_prefix<kPods>(leads, s_warp, staged);
  if (leads) s_start[g] = srow;
  __syncthreads();
  const int slot = here && gsize > 1 ? s_start[g] : -1;
  const int tile = tile_rows_for(staged);
  int* const words = s_words + max(slot, 0) * (tile + kStagePad);

  const int split = blockIdx.y;
  const int row0 = split * a.rows_per_split;
  const int row1 = min(row0 + a.rows_per_split, a.n);
  const int low = kJitterBits - a.stratum_bits;
  const uint32_t low_mask = (1u << low) - 1u;

  bool live = false;
  int pcpu = 0, pmem = 0, pnn = 0;
  uint32_t tol[kTolWords];          // tolerated bits of taint ids below 32 * kTolWords
#pragma unroll
  for (int w = 0; w < kTolWords; ++w) tol[w] = 0u;
  const uint8_t* const trow = a.tolerated + (size_t)pod * a.m;   // the pod's tolerated row
  int rhm = 0;
  if (here) {
    live = a.p_valid[pod] != 0;
    pcpu = a.p_cpu[pod];
    pmem = a.p_mem[pod];
    pnn = a.p_nnid[pod];
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
    rhm = (int)(hash_row(a.seed, row_id) & low_mask);
  }

  // Per-pod constants of the affinity stage: required terms present, the
  // first kMaxPrefTerms preferred terms' weights (live * weight as f32)
  // and the total over all P, summed in term order.
  bool has_terms = false;
  float pref_wt[kMaxPrefTerms];
  float wtot = 0.0f;
#pragma unroll
  for (int x = 0; x < kMaxPrefTerms; ++x) pref_wt[x] = 0.0f;
  if constexpr (WITH_AFF) {
    if (here) {
      for (int x = 0; x < a.t; ++x) has_terms |= a.req_tv[(size_t)pod * a.t + x] != 0;
#pragma unroll
      for (int x = 0; x < kMaxPrefTerms; ++x) {
        if (x < a.p) {
          pref_wt[x] = pref_weight(a, pod, x);
          wtot = wtot + pref_wt[x];
        }
      }
      for (int x = kMaxPrefTerms; x < a.p; ++x) wtot = wtot + pref_weight(a, pod, x);
    }
  }
  // Per-pod constants of the constraint stage.
  float nrefs_f = 1.0f, bound_f = 1.0f;
  bool has_pref = false;
  if constexpr (WITH_CONS) {
    if (here) {
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

  constexpr int kPodsAllocBytes = PACKED ? 2 : 4;
  // Start the copies of rows [base, base + tile) into buffer buf.
  auto start_copies = [&](int base, int buf) {
    const int rows = min(tile, row1 - base);
    BaseRaw& r = s_raw[buf];
    async_span(r.cpu_alloc, a.cpu_alloc, 4, base, rows, tid, kPods);
    async_span(r.mem_alloc, a.mem_alloc, 4, base, rows, tid, kPods);
    async_span(r.cpu_req, a.cpu_req, 4, base, rows, tid, kPods);
    async_span(r.mem_req, a.mem_req, 4, base, rows, tid, kPods);
    async_span(r.pods_req, a.pods_req, 4, base, rows, tid, kPods);
    async_span(r.name_id, a.name_id, 4, base, rows, tid, kPods);
    async_span(r.pods_alloc, a.pods_alloc, kPodsAllocBytes, base, rows, tid, kPods);
    if (PACKED) async_span(r.meta, a.meta, 4, base, rows, tid, kPods);
    if constexpr (WITH_CONS) {
      async_span(s_craw[buf].zone, a.zone, a.zone_bytes, base, rows, tid, kPods);
      async_span(s_craw[buf].region, a.region, a.region_bytes, base, rows, tid, kPods);
    }
    cp_async_commit();
  };
  if (row0 < row1) start_copies(row0, 0);

  uint32_t okw[kTile / 32];                      // affinity masks of this member's rows
  uint32_t prefw[kMaxPrefTerms][kTile / 32];
  int buf = 0;
  for (int base = row0; base < row1; base += tile, buf ^= 1) {
    if (base + tile < row1) {
      start_copies(base + tile, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's columns have landed; the last scan is done
    const int count = min(tile, row1 - base);
    const int count4 = (count + 3) & ~3;

    // Per row: the column half of the hash and, with affinity, the resolve
    // of the batch's query keys against the row's label slots.
    if (tid < count) {
      const uint32_t col = (uint32_t)(base + tid) + (uint32_t)a.col_base;
      s_colword[tid] = jitter_of(hash_stratum(col, a.stratum_bits, low), 0u,
                                 hash_col(a.seed, col), low_mask);
      const int meta = PACKED ? s_raw[buf].meta[tid] : 0;
      const size_t at = (size_t)(base + tid) * a.ts;
      // The first kStagedTaints slots' loads first, so they overlap.
      int tids[kStagedTaints], effs[kStagedTaints];
#pragma unroll
      for (int t = 0; t < kStagedTaints; ++t) {
        tids[t] = 0;
        effs[t] = 0;
        if (t < a.ts) taint_slot<PACKED>(a, at, t, meta, tids[t], effs[t]);
      }
      int nt = 0;
      bool spill = false;
      // Slot id 0 is "no taint"; ids outside [0, M) match no toleration
      // column, as the Pallas one-hot gather counts nothing for them.  A
      // counted taint past the staged ones, or with an id above 15 bits,
      // spills the row: word_at re-reads its slots.
      auto stage = [&](int tid_t, int eff) {
        const bool hard = eff == 1 || eff == 3;   // NoSchedule, NoExecute
        const bool soft = eff == 2;               // PreferNoSchedule
        if (tid_t > 0 && tid_t < a.m && (hard || soft)) {
          if (nt < kStagedTaints && tid_t < kHardBit) {
            s_taints[tid][nt++] = (uint16_t)(tid_t | (hard ? kHardBit : 0));
          } else {
            spill = true;
          }
        }
      };
#pragma unroll
      for (int t = 0; t < kStagedTaints; ++t) stage(tids[t], effs[t]);
      for (int t = kStagedTaints; t < a.ts && !spill; ++t) {
        int tid_t, eff;
        taint_slot<PACKED>(a, at, t, meta, tid_t, eff);
        stage(tid_t, eff);
      }
      s_ntaints[tid] = spill ? kTaintSpill : (uint8_t)nt;
      if constexpr (WITH_CONS) {
        sc.zone[tid] = span_at(s_craw[buf].zone, span_off(a.zone, a.zone_bytes, base),
                               a.zone_bytes, tid);
        sc.region[tid] = span_at(s_craw[buf].region, span_off(a.region, a.region_bytes, base),
                                 a.region_bytes, tid);
      }
    }
    if constexpr (WITH_AFF) {
      uint32_t fbits = 0u;
      if (tid < count) {
        const int nq = min(a.q, kResolveKeys);
        for (int x = 0; x < nq; ++x) {
          sa.val[x][tid] = 0;
          sa.num[x][tid] = 0;
        }
        const size_t lb = (size_t)(base + tid) * a.l;
        for (int x = 0; x < a.l; ++x) {
          const int word = a.label_key[lb + x];
          const int lk = a.fused ? (word & ((1 << a.key_bits) - 1)) : word;
          if (lk == 0) continue;                  // NONE slots never match
          const int lv = a.fused ? (word >> a.key_bits) : a.label_val[lb + x];
          const int ln = a.label_num[lb + x];
          for (int y = 0; y < nq; ++y) {
            if (sa.qkey[y] == lk) {               // last matching slot wins
              fbits |= 1u << y;
              sa.val[y][tid] = lv;
              sa.num[y][tid] = ln;
            }
          }
        }
      }
#pragma unroll
      for (int y = 0; y < kResolveKeys; ++y) {
        const uint32_t bits = __ballot_sync(0xFFFFFFFFu, (fbits >> y) & 1u);
        if ((tid & 31) == 0) sa.found[y][tid >> 5] = bits;
      }
    }
    __syncthreads();

    // Filter and score of (this pod's group, row j) -> its staged word.
    const BaseRaw& R = s_raw[buf];
    auto tolerates = [&](int tid_t) -> bool {   // does this pod tolerate taint id tid_t?
      if (tid_t < 32 * kTolWords) {
        uint32_t word = 0u;
#pragma unroll
        for (int w = 0; w < kTolWords; ++w) word = (w == (tid_t >> 5)) ? tol[w] : word;
        return (word >> (tid_t & 31)) & 1u;
      }
      return __ldg(trow + tid_t) != 0;
    };
    auto word_at = [&](int j, int k) -> int {
      const int row = base + j;
      const int meta = PACKED ? R.meta[j] : 0;
      const int pods_alloc = span_at(R.pods_alloc, span_off(a.pods_alloc, kPodsAllocBytes, base),
                                     kPodsAllocBytes, j);
      bool usable = pods_alloc - R.pods_req[j] >= 1;
      if (PACKED) usable = usable && (meta & 1);
      if (!usable) return -1;
      const int cpu_alloc = R.cpu_alloc[j];
      const int mem_alloc = R.mem_alloc[j];
      const int cpu_req = R.cpu_req[j];
      const int mem_req = R.mem_req[j];
      if (pcpu > cpu_alloc - cpu_req || pmem > mem_alloc - mem_req) return -1;
      if (pnn != 0 && pnn != R.name_id[j]) return -1;
      int soft_cnt = 0;
      const int nt = s_ntaints[j];
      if (nt != kTaintSpill) {
        for (int t = 0; t < nt; ++t) {
          const int e = s_taints[j][t];
          if (!tolerates(e & 0x7FFF)) {
            if (e & kHardBit) return -1;
            ++soft_cnt;
          }
        }
      } else {
        const size_t at = (size_t)row * a.ts;
        for (int t = 0; t < a.ts; ++t) {
          int tid_t, eff;
          taint_slot<PACKED>(a, at, t, meta, tid_t, eff);
          const bool hard = eff == 1 || eff == 3;
          if (tid_t > 0 && tid_t < a.m && (hard || eff == 2) && !tolerates(tid_t)) {
            if (hard) return -1;
            ++soft_cnt;
          }
        }
      }
      if constexpr (WITH_AFF) {
        if (!((word_of(okw, k >> 5) >> (k & 31)) & 1u)) return -1;
      }

      int score = 0;
      if constexpr (WITH_CONS) {
        // PodTopologySpread: skew filter, then the score of each live ref.
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
        if (!ok) return -1;
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
        if (!ok) return -1;
        if (a.w_ts) score += (int)floorf(sp_acc / nrefs_f) * a.w_ts;
        if (a.w_ipa) {
          const float ipa =
              has_pref ? fminf(fmaxf(50.0f + (50.0f * raw) / bound_f, 0.0f), 100.0f) : 0.0f;
          score += (int)floorf(ipa) * a.w_ipa;
        }
      }

      if (a.w_la || a.w_ba) {
        const float alloc_cpu = __int2float_rn(max(cpu_alloc, 1));
        const float alloc_mem = __int2float_rn(max(mem_alloc, 1));
        const float cpu_after = __int2float_rn(cpu_req + pcpu);
        const float mem_after = __int2float_rn(mem_req + pmem);
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
              const float hit = (float)((word_of(prefw[x], k >> 5) >> (k & 31)) & 1u);
              na_acc = na_acc + hit * pref_wt[x];
            }
          }
          // Terms past the register masks, in order; a dead term adds 0.
          for (int x = kMaxPrefTerms; x < a.p; ++x) {
            const float wt = pref_weight(a, pod, x);
            if (wt != 0.0f && pref_term_at(sa, a, pod, x, j, row)) na_acc = na_acc + wt;
          }
          const float na = 100.0f * na_acc / fmaxf(wtot, 1.0f);
          score += (int)floorf(na) * a.w_na;
        }
      }
      score = min(max(score, 0), kMaxScore);
      return (score << kJitterBits) | (int)s_colword[j];
    };

    if (live) {
      // The member of rank p of a group of m takes rows p, p + m, ...
      const int nmine = rank < count ? (count - 1 - rank) / gsize + 1 : 0;
      if constexpr (WITH_AFF) {
        // This member's affinity masks: ok (nodeSelector AND the required
        // terms) and one per preferred term, bit k for its k-th row.
#pragma unroll
        for (int w = 0; w < kTile / 32; ++w) okw[w] = ~0u;
        for (int x = 0; x < a.s; ++x) {
          const size_t at = (size_t)pod * a.s + x;
          if (!a.sel_valid[at]) continue;
          const int qs = query_slot(a.sel_qidx[at], a.q);
          int vs[kMaxValues];
#pragma unroll
          for (int i = 0; i < kMaxValues; ++i) vs[i] = 0;
          vs[0] = a.sel_val[at];
#pragma unroll
          for (int w = 0; w < kTile / 32; ++w) {
            if (32 * w < nmine) {
              okw[w] &= expr_bits(sa, a, base, qs, kOpIn, 0, vs, a.sel_val + at, 1, rank, gsize,
                                  nmine, w);
            }
          }
        }
        if (has_terms) {
          uint32_t any[kTile / 32];
#pragma unroll
          for (int w = 0; w < kTile / 32; ++w) any[w] = 0u;
          for (int x = 0; x < a.t; ++x) {
            const size_t at = (size_t)pod * a.t + x;
            if (!a.req_tv[at]) continue;
            uint32_t tm[kTile / 32];
            if (term_bits(sa, a, base, a.e, a.v, a.req_ev, a.req_qidx, a.req_op, a.req_num,
                          a.req_vals, at * a.e, rank, gsize, nmine, tm)) {
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
              if (term_bits(sa, a, base, a.e, a.v, a.pref_ev, a.pref_qidx, a.pref_op,
                            a.pref_num, a.pref_vals, at * a.e, rank, gsize, nmine, tm)) {
#pragma unroll
                for (int w = 0; w < kTile / 32; ++w) prefw[x][w] = tm[w];
              }
            }
          }
        }
      }
      if (slot < 0) {
        // A group of one: scan each word as it is computed.
        for (int j = 0; j < count; ++j) {
          const int prio = word_at(j, j) ^ rhm;
          if (prio > tp[KMAX - 1]) insert_later<KMAX>(tp, ti, prio, base + j);
        }
      } else {
        for (int j = rank, k = 0; j < count4; j += gsize, ++k) {
          words[j] = j < count ? word_at(j, k) : -1;
        }
      }
    }
    __syncthreads();
    if (live && slot >= 0) scan_words<KMAX>(words, count4, base, rhm, tp, ti);
  }

  if (here) {
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

// Eight blocks of ~28 KB of shared memory need the largest carveout; set
// once per instantiation.
template <bool PACKED, bool WITH_AFF, bool WITH_CONS, int KMAX>
cudaError_t prepare_one() {
  static const cudaError_t carve = cudaFuncSetAttribute(
      fused_topk_kernel<PACKED, WITH_AFF, WITH_CONS, KMAX>,
      cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  return carve;
}

// Launch one instantiation, or (grid.x == 0) write its resident blocks
// per SM to *blocks instead.
template <bool PACKED, bool WITH_AFF, bool WITH_CONS, int KMAX>
cudaError_t launch_one(const Args& a, dim3 grid, cudaStream_t stream, int* blocks) {
  const cudaError_t carve = prepare_one<PACKED, WITH_AFF, WITH_CONS, KMAX>();
  if (carve != cudaSuccess) return carve;
  if (grid.x == 0) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_topk_kernel<PACKED, WITH_AFF, WITH_CONS, KMAX>, kPods, 0);
  }
  fused_topk_kernel<PACKED, WITH_AFF, WITH_CONS, KMAX><<<grid, kPods, 0, stream>>>(a);
  return cudaGetLastError();
}

// One stage configuration in one layout, every K bucket; each of the eight
// is instantiated in its own translation unit (fused_topk_<stage>_<layout>.cu)
// so the builds run in parallel.
template <bool PACKED, bool WITH_AFF, bool WITH_CONS>
cudaError_t launch_layout(const Args& a, dim3 grid, int kmax, cudaStream_t stream,
                          int* blocks) {
  switch (kmax) {
    case 4: return launch_one<PACKED, WITH_AFF, WITH_CONS, 4>(a, grid, stream, blocks);
    case 8: return launch_one<PACKED, WITH_AFF, WITH_CONS, 8>(a, grid, stream, blocks);
    case 16: return launch_one<PACKED, WITH_AFF, WITH_CONS, 16>(a, grid, stream, blocks);
    case 32: return launch_one<PACKED, WITH_AFF, WITH_CONS, 32>(a, grid, stream, blocks);
    case 64: return launch_one<PACKED, WITH_AFF, WITH_CONS, 64>(a, grid, stream, blocks);
    case 128: return launch_one<PACKED, WITH_AFF, WITH_CONS, 128>(a, grid, stream, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// One stage configuration, either layout.  With splits == 0 it launches
// nothing and writes the resident blocks per SM of the instantiation to
// *blocks.
template <bool WITH_AFF, bool WITH_CONS>
cudaError_t launch_stage(const Args& a, bool packed, int splits, int kmax, cudaStream_t stream,
                         int* blocks) {
  const dim3 grid(splits ? (a.b + kPods - 1) / kPods : 0, splits ? splits : 1);
  return packed ? launch_layout<true, WITH_AFF, WITH_CONS>(a, grid, kmax, stream, blocks)
                : launch_layout<false, WITH_AFF, WITH_CONS>(a, grid, kmax, stream, blocks);
}

}  // namespace k8s
