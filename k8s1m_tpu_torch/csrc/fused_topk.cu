// Entry point of the fused filter + score + top-K kernel (fused_topk.cuh),
// bound with ctypes; the per-split partial lists are folded by
// topk_common.cuh's merge_splits_kernel.
//
// The kernel itself, its design and what it replaces are described in
// fused_topk.cuh.  Each stage configuration and layout is instantiated in
// its own translation unit (fused_topk_<base|aff|cons|affcons>_<plain|packed>.cu),
// so nvcc builds the eight in parallel.

#include "fused_topk.cuh"

namespace k8s {

extern template cudaError_t launch_layout<false, false, false>(const Args&, dim3, int,
                                                            cudaStream_t, int*);
extern template cudaError_t launch_layout<false, true, false>(const Args&, dim3, int,
                                                            cudaStream_t, int*);
extern template cudaError_t launch_layout<false, false, true>(const Args&, dim3, int,
                                                            cudaStream_t, int*);
extern template cudaError_t launch_layout<false, true, true>(const Args&, dim3, int,
                                                            cudaStream_t, int*);
extern template cudaError_t launch_layout<true, false, false>(const Args&, dim3, int,
                                                            cudaStream_t, int*);
extern template cudaError_t launch_layout<true, true, false>(const Args&, dim3, int,
                                                            cudaStream_t, int*);
extern template cudaError_t launch_layout<true, false, true>(const Args&, dim3, int,
                                                            cudaStream_t, int*);
extern template cudaError_t launch_layout<true, true, true>(const Args&, dim3, int,
                                                            cudaStream_t, int*);

namespace {

// Pointer and integer arguments, in the order the wrapper
// (ops/fused_topk.py _PTRS / _INTS) passes them.
enum Ptr {
  P_CPU_ALLOC, P_MEM_ALLOC, P_PODS_ALLOC, P_CPU_REQ, P_MEM_REQ, P_PODS_REQ, P_NAME_ID,
  P_TAINT_ID, P_TAINT_EFF, P_META,
  P_P_CPU, P_P_MEM, P_P_VALID, P_P_NNID, P_TOLERATED,
  P_PART_IDX, P_PART_PRIO, P_OUT_IDX, P_OUT_PRIO,
  P_LABEL_KEY, P_LABEL_VAL, P_LABEL_NUM, P_QKEY,
  P_SEL_VALID, P_SEL_QIDX, P_SEL_VAL,
  P_REQ_TV, P_REQ_EV, P_REQ_QIDX, P_REQ_OP, P_REQ_NUM, P_REQ_VALS,
  P_PREF_TV, P_PREF_W, P_PREF_EV, P_PREF_QIDX, P_PREF_OP, P_PREF_NUM, P_PREF_VALS,
  P_ZONE, P_REGION, P_SPREAD_NODE, P_TGT_NODE, P_OWN_NODE,
  P_SPREAD_ZONE, P_SPREAD_REGION, P_TGT_ZONE, P_TGT_REGION, P_OWN_ZONE, P_OWN_REGION,
  P_SP, P_IA, P_II, P_CS,
  P_GKEY, P_ORDER,
  P_COUNT
};
enum Int {
  I_PACKED, I_N, I_TS, I_TAINT_BYTES, I_B, I_M, I_SEED, I_ROW_BASE, I_COL_BASE, I_STRATUM_BITS,
  I_W_LA, I_W_BA, I_W_TT, I_K, I_SPLITS,
  I_WITH_AFF, I_L, I_FUSED, I_KEY_BITS, I_Q, I_S, I_T, I_E, I_V, I_P, I_W_NA,
  I_WITH_CONS, I_ZONE_BYTES, I_REGION_BYTES, I_LD, I_SS, I_AS, I_ZD, I_RD, I_SR, I_AR, I_AI,
  I_W_TS, I_W_IPA,
  I_KW,
  I_COUNT
};

bool width_ok(long long w) { return w == 1 || w == 2 || w == 4; }

using StageFn = cudaError_t (*)(const Args&, bool, int, int, cudaStream_t, int*);
StageFn stage_fn(bool with_aff, bool with_cons) {
  return with_aff && with_cons ? launch_stage<true, true>
       : with_aff              ? launch_stage<true, false>
       : with_cons             ? launch_stage<false, true>
                               : launch_stage<false, false>;
}

}  // namespace
}  // namespace k8s

// Plain C entry point, bound with ctypes.  `ptrs` holds P_COUNT device
// pointers (0 for an argument the stage does not read), `ints` holds
// I_COUNT integers; the launches go to `stream` and nothing synchronises.
// Returns cudaGetLastError() after the launches (0 = ok); the wrapper has
// validated shapes, dtypes and strides.
extern "C" int k8s_fused_topk(const long long* ptrs, int n_ptrs, const long long* ints,
                              int n_ints, void* stream) {
  using namespace k8s;
  if (n_ptrs != P_COUNT || n_ints != I_COUNT) return (int)cudaErrorInvalidValue;
  auto ptr = [&](int i) { return (const void*)(uintptr_t)ptrs[i]; };
  auto iv = [&](int i) { return (int)ints[i]; };
  const int n = iv(I_N), ts = iv(I_TS), b = iv(I_B), m = iv(I_M), k = iv(I_K);
  const int splits = iv(I_SPLITS), sb = iv(I_STRATUM_BITS);
  const bool with_aff = iv(I_WITH_AFF) != 0, with_cons = iv(I_WITH_CONS) != 0;
  const bool packed = iv(I_PACKED) != 0;
  const int taint_bytes = iv(I_TAINT_BYTES);
  // Any taint slot count and id range: slots past the staged ones and ids
  // past the register bits are read from global memory (fused_topk.cuh).
  // The packed meta word holds two effect bits per slot after bit 0.
  if (ts < 1 || m < 1 || k < 1 || k > kMaxK || splits < 1 || b < 1 || n < 0 || sb < 0 ||
      sb > kJitterBits || iv(I_KW) < 1 || (packed && 1 + 2 * ts > 32) ||
      !(taint_bytes == 4 || (packed && taint_bytes == 2))) {
    return (int)cudaErrorInvalidValue;
  }
  // Any Q, V and P (no upper bound, as the Pallas kernel's loops).
  if (with_aff && (iv(I_Q) < 0 || iv(I_V) < 0 || iv(I_P) < 0 || iv(I_L) < 0 || iv(I_S) < 0 ||
                   iv(I_T) < 0 || iv(I_E) < 0 || iv(I_KEY_BITS) < 1 || iv(I_KEY_BITS) > 30)) {
    return (int)cudaErrorInvalidValue;
  }
  if (with_cons && (!width_ok(ints[I_ZONE_BYTES]) || !width_ok(ints[I_REGION_BYTES]) ||
                    ints[I_LD] < n || iv(I_SR) < 0 || iv(I_AR) < 0 || iv(I_AI) < 0)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.cpu_alloc = (const int*)ptr(P_CPU_ALLOC);
  a.mem_alloc = (const int*)ptr(P_MEM_ALLOC);
  a.pods_alloc = ptr(P_PODS_ALLOC);
  a.cpu_req = (const int*)ptr(P_CPU_REQ);
  a.mem_req = (const int*)ptr(P_MEM_REQ);
  a.pods_req = (const int*)ptr(P_PODS_REQ);
  a.name_id = (const int*)ptr(P_NAME_ID);
  a.taint_id = ptr(P_TAINT_ID);
  a.taint_eff = (const int*)ptr(P_TAINT_EFF);
  a.meta = (const int*)ptr(P_META);
  a.n = n;
  a.ts = ts;
  a.taint_bytes = taint_bytes;
  a.p_cpu = (const int*)ptr(P_P_CPU);
  a.p_mem = (const int*)ptr(P_P_MEM);
  a.p_valid = (const uint8_t*)ptr(P_P_VALID);
  a.p_nnid = (const int*)ptr(P_P_NNID);
  a.tolerated = (const uint8_t*)ptr(P_TOLERATED);
  a.b = b;
  a.m = m;
  a.seed = (uint32_t)ints[I_SEED];
  a.row_base = iv(I_ROW_BASE);
  a.col_base = iv(I_COL_BASE);
  a.stratum_bits = sb;
  a.w_la = iv(I_W_LA);
  a.w_ba = iv(I_W_BA);
  a.w_tt = iv(I_W_TT);
  a.k = k;
  a.rows_per_split = (n + splits - 1) / splits;
  a.part_idx = (int*)ptr(P_PART_IDX);
  a.part_prio = (int*)ptr(P_PART_PRIO);
  a.gkey = (const int*)ptr(P_GKEY);
  a.kw = iv(I_KW);
  a.order = (const int*)ptr(P_ORDER);

  a.label_key = (const int*)ptr(P_LABEL_KEY);
  a.label_val = (const int*)ptr(P_LABEL_VAL);
  a.label_num = (const int*)ptr(P_LABEL_NUM);
  a.l = iv(I_L);
  a.fused = iv(I_FUSED);
  a.key_bits = iv(I_KEY_BITS);
  a.qkey = (const int*)ptr(P_QKEY);
  a.q = iv(I_Q);
  a.sel_valid = (const uint8_t*)ptr(P_SEL_VALID);
  a.sel_qidx = (const int*)ptr(P_SEL_QIDX);
  a.sel_val = (const int*)ptr(P_SEL_VAL);
  a.s = iv(I_S);
  a.req_tv = (const uint8_t*)ptr(P_REQ_TV);
  a.req_ev = (const uint8_t*)ptr(P_REQ_EV);
  a.req_qidx = (const int*)ptr(P_REQ_QIDX);
  a.req_op = (const int*)ptr(P_REQ_OP);
  a.req_num = (const int*)ptr(P_REQ_NUM);
  a.req_vals = (const int*)ptr(P_REQ_VALS);
  a.t = iv(I_T);
  a.e = iv(I_E);
  a.v = iv(I_V);
  a.pref_tv = (const uint8_t*)ptr(P_PREF_TV);
  a.pref_w = (const int*)ptr(P_PREF_W);
  a.pref_ev = (const uint8_t*)ptr(P_PREF_EV);
  a.pref_qidx = (const int*)ptr(P_PREF_QIDX);
  a.pref_op = (const int*)ptr(P_PREF_OP);
  a.pref_num = (const int*)ptr(P_PREF_NUM);
  a.pref_vals = (const int*)ptr(P_PREF_VALS);
  a.p = iv(I_P);
  a.w_na = iv(I_W_NA);

  a.zone = ptr(P_ZONE);
  a.region = ptr(P_REGION);
  a.zone_bytes = iv(I_ZONE_BYTES);
  a.region_bytes = iv(I_REGION_BYTES);
  a.spread_node = (const int*)ptr(P_SPREAD_NODE);
  a.tgt_node = (const int*)ptr(P_TGT_NODE);
  a.own_node = (const int*)ptr(P_OWN_NODE);
  a.ld = ints[I_LD];
  a.ss = iv(I_SS);
  a.as = iv(I_AS);
  a.spread_zone = (const int*)ptr(P_SPREAD_ZONE);
  a.spread_region = (const int*)ptr(P_SPREAD_REGION);
  a.tgt_zone = (const int*)ptr(P_TGT_ZONE);
  a.tgt_region = (const int*)ptr(P_TGT_REGION);
  a.own_zone = (const int*)ptr(P_OWN_ZONE);
  a.own_region = (const int*)ptr(P_OWN_REGION);
  a.zd = iv(I_ZD);
  a.rd = iv(I_RD);
  a.sp = (const int*)ptr(P_SP);
  a.sr = iv(I_SR);
  a.ia = (const int*)ptr(P_IA);
  a.ar = iv(I_AR);
  a.ii = (const int*)ptr(P_II);
  a.ai = iv(I_AI);
  a.cs = (const int*)ptr(P_CS);
  a.w_ts = iv(I_W_TS);
  a.w_ipa = iv(I_W_IPA);

  const int kmax = kmax_bucket(k);
  cudaStream_t s = (cudaStream_t)stream;
  const StageFn stage = stage_fn(with_aff, with_cons);
  cudaError_t err = stage(a, packed, splits, kmax, s, nullptr);
  if (err != cudaSuccess) return (int)err;
  int* oi = (int*)(uintptr_t)ptrs[P_OUT_IDX];
  int* op = (int*)(uintptr_t)ptrs[P_OUT_PRIO];
  switch (kmax) {
    case 4: err = merge_splits<4>(a.part_idx, a.part_prio, b, k, splits, oi, op, s); break;
    case 8: err = merge_splits<8>(a.part_idx, a.part_prio, b, k, splits, oi, op, s); break;
    case 16: err = merge_splits<16>(a.part_idx, a.part_prio, b, k, splits, oi, op, s); break;
    case 32: err = merge_splits<32>(a.part_idx, a.part_prio, b, k, splits, oi, op, s); break;
    case 64: err = merge_splits<64>(a.part_idx, a.part_prio, b, k, splits, oi, op, s); break;
    default: err = merge_splits<128>(a.part_idx, a.part_prio, b, k, splits, oi, op, s); break;
  }
  return (int)err;
}

// Resident blocks per SM of the kernel instantiation a launch with these
// flags and k would use (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// negative on error.
extern "C" int k8s_fused_blocks_per_sm(int with_aff, int with_cons, int packed, int k) {
  using namespace k8s;
  if (k < 1 || k > kMaxK) return -(int)cudaErrorInvalidValue;
  Args a{};
  int blocks = 0;
  const cudaError_t err =
      stage_fn(with_aff != 0, with_cons != 0)(a, packed != 0, 0, kmax_bucket(k), nullptr, &blocks);
  return err == cudaSuccess ? blocks : -(int)err;
}
