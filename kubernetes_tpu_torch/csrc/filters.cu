// Filter kernel: the pods x nodes feasibility mask.
//
// Replaces kubernetes_tpu/ops/filters.py:combined_mask (over filter_masks):
// the AND of CheckNodeUnschedulable, PodFitsHost, PodFitsHostPorts,
// PodMatchNodeSelector (nodeSelector pairs + required node affinity),
// PodFitsResources and PodToleratesNodeTaints, each gated by a bit of
// `predicates`, masked by the spec row's validity and by node
// `valid & ~fallback`.
//
// Design: one thread per (spec row u, node n); blockIdx.y = u, so a block's
// threads share one pod row (read through L1) and walk adjacent nodes. Each
// predicate short-circuits to the next row on the first failure. The mask is
// written as one byte per pair (viewed as torch.bool). With `sel_out` set,
// the same launch also writes the RAW PodMatchNodeSelector predicate
// (ops/filters.py:pod_match_node_selector, unmasked by node or pod
// validity) for every pair: the topology spread score's candidate set.
//
// Bound: memory. It must write U*N bytes and read the node bank once per
// spec row; the per-pair work is a few hundred integer compares at most
// (ports and selector loops skip padding lanes).
#include "common.cuh"

#define PRED_UNSCHEDULABLE 1
#define PRED_HOST 2
#define PRED_PORTS 4
#define PRED_SELECTOR 8
#define PRED_RESOURCES 16
#define PRED_TAINTS 32

struct FilterArgs {
  // node bank [N, ...]
  const uint8_t* n_valid;
  const uint8_t* n_fallback;
  const int32_t* n_name_id;
  const int64_t* n_alloc;          // [N, R]
  const int64_t* n_requested;      // [N, R]
  const int32_t* n_allowed_pods;
  const int32_t* n_pod_count;
  const int32_t* n_label_vals;     // [N, K]
  const int64_t* n_label_num;      // [N, K]
  const uint8_t* n_label_num_ok;   // [N, K]
  const int32_t* n_taint_key;      // [N, T]
  const int32_t* n_taint_val;
  const int32_t* n_taint_effect;
  const uint8_t* n_unschedulable;
  const int32_t* n_port_proto;     // [N, P]
  const int32_t* n_port_ip;
  const int32_t* n_port_num;
  // pod batch [U, ...]
  const uint8_t* p_valid;
  const int64_t* p_req;            // [U, R]
  const uint8_t* p_req_any;
  const int32_t* p_node_name_id;
  const int32_t* p_tol_key;        // [U, TL]
  const int32_t* p_tol_op;
  const int32_t* p_tol_val;
  const int32_t* p_tol_effect;
  const uint8_t* p_tol_valid;
  const int32_t* p_sel_pair_slot;  // [U, NSP]
  const int32_t* p_sel_pair_val;
  const uint8_t* p_has_required;
  const uint8_t* p_term_valid;     // [U, TERMS]
  const int32_t* p_term_req_op;    // [U, TERMS, REQS]
  const int32_t* p_term_req_slot;
  const int32_t* p_term_req_vals;  // [U, TERMS, REQS, VALS]
  const int64_t* p_term_req_num;   // [U, TERMS, REQS]
  const int32_t* p_port_proto;     // [U, PP]
  const int32_t* p_port_ip;
  const int32_t* p_port_num;
  uint8_t* out;                    // [U, N]
  uint8_t* sel_out;                // [U, N] raw selector predicate, or null
  int32_t N, U, K, R, T, P, TL, NSP, TERMS, REQS, VALS, PP;
  int32_t wildcard_ip, unschedulable_key, empty_val;
  int32_t predicates;
};

// PodMatchNodeSelector: nodeSelector pairs AND required node-affinity terms
// (terms ORed, requirements ANDed).
__device__ bool selector_ok(const FilterArgs& a, int u, int n) {
  const int32_t* lv = a.n_label_vals + (int64_t)n * a.K;
  const int64_t* ln = a.n_label_num + (int64_t)n * a.K;
  const uint8_t* lok = a.n_label_num_ok + (int64_t)n * a.K;
  for (int j = 0; j < a.NSP; ++j) {
    const int32_t slot = a.p_sel_pair_slot[(int64_t)u * a.NSP + j];
    if (slot < 0) continue;
    const int sc = slot > a.K - 1 ? a.K - 1 : slot;
    if (lv[sc] != a.p_sel_pair_val[(int64_t)u * a.NSP + j]) return false;
  }
  if (a.p_has_required[u]) {
    bool any_term = false;
    for (int t = 0; t < a.TERMS && !any_term; ++t) {
      if (!a.p_term_valid[(int64_t)u * a.TERMS + t]) continue;
      bool all_req = true;
      const int64_t base = ((int64_t)u * a.TERMS + t) * a.REQS;
      for (int q = 0; q < a.REQS && all_req; ++q) {
        all_req = eval_requirement(
            a.p_term_req_op[base + q], a.p_term_req_slot[base + q],
            a.p_term_req_vals + (base + q) * a.VALS, a.VALS, a.p_term_req_num[base + q],
            lv, ln, lok, a.K, a.n_name_id[n]);
      }
      any_term = all_req;
    }
    if (!any_term) return false;
  }
  return true;
}

// The enabled predicates for one pair; `sel` is the selector predicate when
// the caller already computed it.
__device__ bool fits(const FilterArgs& a, int u, int n, const bool* sel) {
  const int pr = a.predicates;
  const int32_t* tk = a.p_tol_key + (int64_t)u * a.TL;
  const int32_t* to = a.p_tol_op + (int64_t)u * a.TL;
  const int32_t* tv = a.p_tol_val + (int64_t)u * a.TL;
  const int32_t* te = a.p_tol_effect + (int64_t)u * a.TL;
  const uint8_t* tvalid = a.p_tol_valid + (int64_t)u * a.TL;

  if (pr & PRED_UNSCHEDULABLE) {
    // node.spec.unschedulable is a synthetic NoSchedule taint
    if (a.n_unschedulable[n] &&
        !tolerated(tk, to, tv, te, tvalid, a.TL, a.unschedulable_key, a.empty_val,
                   EFFECT_NO_SCHEDULE)) {
      return false;
    }
  }
  if (pr & PRED_HOST) {
    const int32_t pinned = a.p_node_name_id[u];
    if (pinned != 0 && pinned != a.n_name_id[n]) return false;
  }
  if (pr & PRED_RESOURCES) {
    if (a.n_pod_count[n] + 1 > a.n_allowed_pods[n]) return false;
    if (a.p_req_any[u]) {
      const int64_t* req = a.p_req + (int64_t)u * a.R;
      const int64_t* alloc = a.n_alloc + (int64_t)n * a.R;
      const int64_t* used = a.n_requested + (int64_t)n * a.R;
      for (int r = 0; r < a.R; ++r) {
        // cpu/mem/ephemeral always; scalar slots only when requested
        if ((r < 3 || req[r] > 0) && req[r] > alloc[r] - used[r]) return false;
      }
    }
  }
  if (pr & PRED_TAINTS) {
    const int32_t* nk = a.n_taint_key + (int64_t)n * a.T;
    const int32_t* nvv = a.n_taint_val + (int64_t)n * a.T;
    const int32_t* ne = a.n_taint_effect + (int64_t)n * a.T;
    for (int t = 0; t < a.T; ++t) {
      const int32_t eff = ne[t];
      if ((eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE) &&
          !tolerated(tk, to, tv, te, tvalid, a.TL, nk[t], nvv[t], eff)) {
        return false;
      }
    }
  }
  if ((pr & PRED_SELECTOR) && !(sel != nullptr ? *sel : selector_ok(a, u, n))) return false;
  if (pr & PRED_PORTS) {
    const int32_t* pn = a.p_port_num + (int64_t)u * a.PP;
    const int32_t* pp = a.p_port_proto + (int64_t)u * a.PP;
    const int32_t* pi = a.p_port_ip + (int64_t)u * a.PP;
    const int32_t* nn = a.n_port_num + (int64_t)n * a.P;
    const int32_t* np = a.n_port_proto + (int64_t)n * a.P;
    const int32_t* ni = a.n_port_ip + (int64_t)n * a.P;
    for (int i = 0; i < a.PP; ++i) {
      if (pn[i] <= 0) continue;
      for (int j = 0; j < a.P; ++j) {
        // HostPortInfo.CheckConflict (filters.port_clash)
        if (nn[j] > 0 && nn[j] == pn[i] && np[j] == pp[i] &&
            (pi[i] == a.wildcard_ip || ni[j] == a.wildcard_ip || pi[i] == ni[j])) {
          return false;
        }
      }
    }
  }
  return true;
}

__global__ void filter_mask_kernel(const FilterArgs a) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int u = blockIdx.y;
  if (n >= a.N) return;
  bool sel = true;
  const bool with_sel = a.sel_out != nullptr;
  if (with_sel) {
    sel = selector_ok(a, u, n);
    a.sel_out[(int64_t)u * a.N + n] = sel ? 1 : 0;
  }
  bool ok = a.p_valid[u] && a.n_valid[n] && !a.n_fallback[n];
  if (ok) ok = fits(a, u, n, with_sel ? &sel : nullptr);
  a.out[(int64_t)u * a.N + n] = ok ? 1 : 0;
}

extern "C" int ktpu_filter_mask(const FilterArgs* args, cudaStream_t stream) {
  const int threads = 128;
  if (args->U > 0 && args->N > 0) {
    dim3 grid((args->N + threads - 1) / threads, args->U);
    filter_mask_kernel<<<grid, threads, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
