// Topology kernels: term matching, EvenPodsSpread (DoNotSchedule filter and
// ScheduleAnyway score) and SelectorSpread score.
//
// Replace, in kubernetes_tpu/ops/topology.py:
//   ktpu_match_terms            match_terms (:49)
//   ktpu_spread_filter          spread_filter (:182) with match_terms,
//                               _bucket_of, _seg_sum, _sig_cnt_node,
//                               _merge_same_key, _gather_rows and
//                               _scatter_and inside, and the metadata that
//                               kubernetes_tpu/commit/arbiter.py
//                               _spread_tables (:76) reads (cand and the
//                               merged tables, written by the same launch)
//   ktpu_spread_score           spread_score (:227) with the same helpers and
//                               _scatter_add
//   ktpu_selector_spread_score  selector_spread_score (:433)
//
// Existing pods are label SIGNATURES (state/tensors.SigBank): counts[N, S]
// int16 pods per (node, signature). A term matches a handful of signatures
// (config 3: one), so where the reference multiplies the dense [TT, S] match
// matrix with counts^T, these kernels first compact each term's (or spec
// row's) matched signatures into a list and sum only those columns per node:
// the same integer sums, without the S-wide dot products. Every sum is an
// integer sum, so the order of atomics does not change a result; the one
// float64 path (the SelectorSpread blend) is evaluated in the reference's
// operation order, and the library is built with -fmad=false.
//
// Bound: none of them has enough arithmetic to matter. match_terms is
// bound by its [TT, X] byte output and label reads; the spread programs read the
// counts columns of the matched signatures once per term or spec row, the
// node bank's dense label column once per term, and write [U, N] int64
// (the filter [U, N] bytes): bytes. Their real cost is launch count and the
// reads a node costs (one 32-byte sector for each 2-byte count or 4-byte
// label: the banks are node-major). The spread score is four launches of
// U or TT blocks; the spread filter is one launch of U clusters (below),
// whose floor is the cluster launch and those sectors.
#include <cooperative_groups.h>

#include "topology.cuh"

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// match_terms
// ---------------------------------------------------------------------------

struct MatchArgs {
  const uint8_t* valid;         // [TT]
  const uint8_t* has_selector;  // [TT]
  const int32_t* ml_slot;       // [TT, ML]
  const int32_t* ml_val;        // [TT, ML]
  const int32_t* ex_op;         // [TT, EX]
  const int32_t* ex_slot;       // [TT, EX]
  const int32_t* ex_vals;       // [TT, EX, VALS]
  const uint8_t* ns_any;        // [TT]
  const int32_t* ns_ids;        // [TT, NS]
  const int32_t* labels;        // [X, K]
  const int32_t* ns;            // [X], or null: no namespace test
  uint8_t* out;                 // [TT, X]
  int32_t TT, X, K, ML, EX, VALS, NS;
};

// metav1.LabelSelectorAsSelector over interned ids (topology.match_terms):
// matchLabels at clipped slots (a negative slot passes), expressions with
// present = value id != 0 at the clipped slot, unknown operators pass; a
// nil selector or an invalid row matches nothing. Term t's fields and
// subject x's labels (row width K) and namespace (ns null: no namespace
// test); every read is of an input no kernel writes while it runs.
__device__ __forceinline__ bool selector_matches(
    const uint8_t* valid, const uint8_t* has_selector, const int32_t* ml_slot, const int32_t* ml_val,
    const int32_t* ex_op, const int32_t* ex_slot, const int32_t* ex_vals, const uint8_t* ns_any,
    const int32_t* ns_ids, const int32_t* labels, const int32_t* ns, int K, int ML, int EX, int VALS, int NS,
    int t, int x) {
  if (!__ldg(valid + t) || !__ldg(has_selector + t)) return false;
  const int32_t* lab = labels + (int64_t)x * K;
  const int kmax = K - 1;
  for (int j = 0; j < ML; ++j) {
    const int32_t slot = __ldg(ml_slot + (int64_t)t * ML + j);
    if (slot < 0) continue;
    if (__ldg(lab + (slot > kmax ? kmax : slot)) != __ldg(ml_val + (int64_t)t * ML + j)) return false;
  }
  for (int j = 0; j < EX; ++j) {
    const int64_t e = (int64_t)t * EX + j;
    const int32_t op = __ldg(ex_op + e);
    if (op != OP_IN && op != OP_NOT_IN && op != OP_EXISTS && op != OP_DOES_NOT_EXIST) {
      if (op == OP_NEVER) return false;
      continue;  // unknown operators pass
    }
    const int32_t slot = __ldg(ex_slot + e);
    const int32_t v = __ldg(lab + (slot < 0 ? 0 : (slot > kmax ? kmax : slot)));
    const bool present = v != 0;
    bool ok;
    if (op == OP_IN || op == OP_NOT_IN) {
      bool in_set = false;
      const int32_t* vals = ex_vals + e * VALS;
      for (int k = 0; k < VALS; ++k) in_set |= (v == __ldg(vals + k));
      ok = op == OP_IN ? (present && in_set) : (!present || !in_set);
    } else {
      ok = op == OP_EXISTS ? present : !present;
    }
    if (!ok) return false;
  }
  if (ns != nullptr && !__ldg(ns_any + t)) {
    const int32_t nsx = __ldg(ns + x);
    bool in = false;
    for (int j = 0; j < NS; ++j) in |= (__ldg(ns_ids + (int64_t)t * NS + j) == nsx);
    if (!in) return false;
  }
  return true;
}

__device__ bool term_matches(const MatchArgs& a, int t, int x) {
  return selector_matches(a.valid, a.has_selector, a.ml_slot, a.ml_val, a.ex_op, a.ex_slot, a.ex_vals, a.ns_any,
                          a.ns_ids, a.labels, a.ns, a.K, a.ML, a.EX, a.VALS, a.NS, t, x);
}

__global__ void match_terms_kernel(const MatchArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (x >= a.X) return;
  a.out[(int64_t)t * a.X + x] = term_matches(a, t, x) ? 1 : 0;
}

extern "C" int ktpu_match_terms(const MatchArgs* args, cudaStream_t stream) {
  if (args->TT > 0 && args->X > 0) {
    dim3 grid((args->X + THREADS - 1) / THREADS, args->TT);
    match_terms_kernel<<<grid, THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// spread_score: four launches from one entry
//   1. member   [U, N]: valid node carrying every topology key of row u's
//               soft terms
//   2. pairs    per term: counts of matching pods on counting nodes (member
//               & raw node selector) and member presence, per topology value
//               bucket
//   3. merge    per term: sum the pair tables of the row's terms on the same
//               key
//   4. score    per spec row: gather back per node, sum over the row's
//               terms, total and min over member nodes, 10*(total-cnt)/diff
// ---------------------------------------------------------------------------

struct SpreadArgs {
  const uint8_t* t_valid;       // [TT]
  const int32_t* t_kind;        // [TT]
  const int32_t* t_owner;       // [TT]
  const int32_t* t_topo_slot;   // [TT]
  const uint8_t* m_sig;         // [TT, S] match_terms without namespaces
  const uint8_t* e_valid;       // [S]
  const int16_t* counts;        // [N, S]
  const uint8_t* n_valid;       // [N]
  const int32_t* label_dense;   // [N, K]
  const uint8_t* sel;           // [U, N] raw PodMatchNodeSelector
  uint8_t* member;              // [U, N] scratch
  int32_t* sig_list;            // [TT, S] scratch
  int32_t* pair_cnt;            // [TT, V] scratch
  int32_t* pair_present;        // [TT, V] scratch
  int32_t* merged_cnt;          // [TT, V] scratch
  uint8_t* merged_present;      // [TT, V] scratch
  int64_t* out;                 // [U, N] score
  int32_t TT, S, N, K, U, V, table_in_shared;
};

__device__ __forceinline__ bool is_soft(const SpreadArgs& a, int t) {
  return a.t_valid[t] && a.t_kind[t] == SPREAD_SOFT;
}

__global__ void spread_member_kernel(const SpreadArgs a) {
  extern __shared__ int32_t terms[];  // [TT]
  __shared__ int n_terms;
  const int u = blockIdx.x;
  const int nt = owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, SPREAD_SOFT, u, terms, &n_terms);
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    bool m = a.n_valid[n];
    for (int i = 0; i < nt && m; ++i) {
      int32_t b;
      m = dense_bucket(a.label_dense, a.K, n, a.t_topo_slot[terms[i]], &b);
    }
    a.member[(int64_t)u * a.N + n] = m ? 1 : 0;
  }
}

__global__ void spread_pairs_kernel(const SpreadArgs a) {
  extern __shared__ int32_t table[];  // [2V] when table_in_shared
  __shared__ int n_sigs;
  const int t = blockIdx.x;
  if (!is_soft(a, t)) return;
  const int u = a.t_owner[t];
  const int32_t slot = a.t_topo_slot[t];
  int32_t* sigs = a.sig_list + (int64_t)t * a.S;
  if (threadIdx.x == 0) n_sigs = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    if (a.m_sig[(int64_t)t * a.S + s] && a.e_valid[s]) sigs[atomicAdd(&n_sigs, 1)] = s;
  }
  int32_t* cnt = a.table_in_shared ? table : a.pair_cnt + (int64_t)t * a.V;
  int32_t* present = a.table_in_shared ? table + a.V : a.pair_present + (int64_t)t * a.V;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) {
    cnt[v] = 0;
    present[v] = 0;
  }
  __syncthreads();
  const int ns = n_sigs;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const int64_t un = (int64_t)u * a.N + n;
    const bool mem = a.member[un];
    int32_t b;
    const bool has = dense_bucket(a.label_dense, a.K, n, slot, &b);
    if (b >= a.V) continue;  // segment_sum drops out-of-range buckets
    if (mem && a.sel[un]) {
      const int16_t* row = a.counts + (int64_t)n * a.S;
      int32_t c = 0;
      for (int i = 0; i < ns; ++i) c += row[sigs[i]];
      if (c != 0) atomicAdd(&cnt[b], c);
    }
    if (mem && has) present[b] = 1;
  }
  __syncthreads();
  if (a.table_in_shared) {
    for (int v = threadIdx.x; v < a.V; v += blockDim.x) {
      a.pair_cnt[(int64_t)t * a.V + v] = cnt[v];
      a.pair_present[(int64_t)t * a.V + v] = present[v];
    }
  }
}

__global__ void spread_merge_kernel(const SpreadArgs a) {
  extern __shared__ int32_t group[];  // [TT]
  __shared__ int n_group;
  const int t = blockIdx.x;
  if (!is_soft(a, t)) return;
  if (threadIdx.x == 0) n_group = 0;
  __syncthreads();
  for (int q = threadIdx.x; q < a.TT; q += blockDim.x) {
    if (is_soft(a, q) && a.t_owner[q] == a.t_owner[t] && a.t_topo_slot[q] == a.t_topo_slot[t]) {
      group[atomicAdd(&n_group, 1)] = q;
    }
  }
  __syncthreads();
  const int ng = n_group;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) {
    int32_t c = 0, p = 0;
    for (int i = 0; i < ng; ++i) {
      c += a.pair_cnt[(int64_t)group[i] * a.V + v];
      p += a.pair_present[(int64_t)group[i] * a.V + v];
    }
    a.merged_cnt[(int64_t)t * a.V + v] = c;
    a.merged_present[(int64_t)t * a.V + v] = p > 0 ? 1 : 0;
  }
}

__global__ void spread_score_kernel(const SpreadArgs a) {
  extern __shared__ int32_t terms[];  // [TT]
  __shared__ int n_terms;
  __shared__ int64_t red[THREADS / 32];
  const int u = blockIdx.x;
  const int nt = owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, SPREAD_SOFT, u, terms, &n_terms);
  int64_t total = 0, mn = BIG_COUNT, any = 0;
  int64_t* out = a.out + (int64_t)u * a.N;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    uint32_t nc = 0;  // int32 with the reference's wrap-around
    for (int i = 0; i < nt; ++i) {
      const int t = terms[i];
      int32_t b;
      const bool has = dense_bucket(a.label_dense, a.K, n, a.t_topo_slot[t], &b);
      const int64_t tv = (int64_t)t * a.V + (b > a.V - 1 ? a.V - 1 : b);  // gathers clamp
      if (has && a.merged_present[tv]) nc += (uint32_t)a.merged_cnt[tv];
    }
    const int32_t c = (int32_t)nc;
    out[n] = c;
    if (a.member[(int64_t)u * a.N + n]) {
      total += c;
      mn = c < mn ? c : mn;
      any = 1;
    }
  }
  total = block_sum<int64_t>(total, red);
  mn = block_min<int64_t>(mn, red, BIG_COUNT);
  any = block_max<int64_t>(any, red, 0);
  const int64_t min_cnt = any ? mn : 0;
  const int64_t diff = total - min_cnt;
  const bool has_soft = nt > 0;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const int64_t c = out[n];
    const int64_t f = diff > 0 ? floordiv(MAX_NODE_SCORE * (total - c), diff) : MAX_NODE_SCORE;
    out[n] = (has_soft && a.member[(int64_t)u * a.N + n]) ? f : 0;
  }
}

extern "C" int ktpu_spread_score(const SpreadArgs* args, cudaStream_t stream) {
  const SpreadArgs& a = *args;
  if (a.U <= 0 || a.N <= 0 || a.TT <= 0) return (int)cudaGetLastError();
  const size_t term_bytes = (size_t)a.TT * sizeof(int32_t);
  const size_t table_bytes = a.table_in_shared ? (size_t)2 * a.V * sizeof(int32_t) : 0;
  int rc;
  if ((rc = set_smem((const void*)spread_member_kernel, term_bytes))) return rc;
  if ((rc = set_smem((const void*)spread_pairs_kernel, table_bytes))) return rc;
  if ((rc = set_smem((const void*)spread_merge_kernel, term_bytes))) return rc;
  if ((rc = set_smem((const void*)spread_score_kernel, term_bytes))) return rc;
  spread_member_kernel<<<a.U, THREADS, term_bytes, stream>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  spread_pairs_kernel<<<a.TT, THREADS, table_bytes, stream>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  spread_merge_kernel<<<a.TT, THREADS, term_bytes, stream>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  spread_score_kernel<<<a.U, THREADS, term_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// spread_filter: ONE launch, a grid of U thread-block clusters of C CTAs,
// one cluster a spec row u; CTA c of the cluster owns the node slice
// [c * slice, (c + 1) * slice) and the bucket slice [c * vslice, ...).
//
//   1. The row's DoNotSchedule terms, in ascending term order (so every
//      CTA of the cluster walks the same groups); its candidate nodes
//      (valid, the raw node selector, every hard key present) and a
//      per-node state word in shared memory (the skew tests passed so far,
//      the candidate bit, the bucket at the current group's key).
//   2. Per (row, topology key) group, in the order of its first term:
//      a. the node's bucket at the key into the state word;
//      b. the signatures any of the group's terms matches (term_matches
//         with namespaces, inside the launch), with their multiplicity,
//         in windows of SPREAD_LIST; per candidate node the matched
//         counts summed, into per-warp copies of a V-wide count and
//         presence table in shared memory (folded into copy 0) — or, past
//         shared memory, with global atomics straight into the group's
//         first term's rows of merged_cnt / merged_present;
//      c. a cluster barrier; CTA c sums its bucket slice over the C
//         partial tables through distributed shared memory, writes it to
//         every group term's rows, and takes the slice's minimum over
//         present values and whether any is present;
//      d. a cluster barrier; every CTA reads the C partial minima (and,
//         for a small V, copies the whole merged table locally); rank 0
//         writes min_t and any_pair_t of the group's terms;
//      e. each node's skew test for each group term, the table read at the
//         clamped bucket (locally, from the owning CTA's shared memory,
//         or from device memory), ANDed into the state word.
//   3. The mask (every test passed, or no value present for any of the
//      row's groups) and the default rows of the tables for terms no
//      spec row owns; the exit waits on a split cluster barrier so no CTA
//      leaves while another reads its shared memory.
//
// The tables (cand, merged_cnt, merged_present, min_t, any_pair_t) are the
// arbiter's, with spread_hard_tables_plain's contents: a term that is not a
// DoNotSchedule term of some spec row has zero rows, min_t = BIG_COUNT and
// no pair.
// ---------------------------------------------------------------------------

#define SPREAD_LIST 1024        // matched signatures a window
#define SPREAD_BATCH 4          // nodes a thread loads for at once
#define ST_OK 0x80000000u       // every skew test so far passed
#define ST_CAND 0x40000000u     // a candidate node
#define ST_BUCKET 0x3FFFFFFFu   // min(bucket, V), or ST_BUCKET: no key

struct SpreadFilterArgs {
  const uint8_t* t_valid;         // [TT]
  const int32_t* t_kind;          // [TT]
  const int32_t* t_owner;         // [TT]
  const int32_t* t_topo_slot;     // [TT]
  const uint8_t* t_self_match;    // [TT]
  const int32_t* t_weight;        // [TT] max_skew
  const uint8_t* t_has_selector;  // [TT]
  const int32_t* t_ml_slot;       // [TT, ML]
  const int32_t* t_ml_val;        // [TT, ML]
  const int32_t* t_ex_op;         // [TT, EX]
  const int32_t* t_ex_slot;       // [TT, EX]
  const int32_t* t_ex_vals;       // [TT, EX, VALS]
  const uint8_t* t_ns_any;        // [TT]
  const int32_t* t_ns_ids;        // [TT, NS]
  const int32_t* e_labels;        // [S, KE] signature labels
  const int32_t* e_ns;            // [S]
  const uint8_t* e_valid;         // [S]
  const int16_t* counts;          // [N, S]
  const uint8_t* n_valid;         // [N]
  const int32_t* label_dense;     // [N, K]
  const uint8_t* sel;             // [U, N] raw PodMatchNodeSelector
  uint8_t* cand;                  // [U, N]
  int32_t* merged_cnt;            // [TT, V]
  uint8_t* merged_present;        // [TT, V]
  int32_t* min_t;                 // [TT]
  uint8_t* any_pair_t;            // [TT]
  uint8_t* mask;                  // [U, N]
  int32_t TT, S, N, K, KE, ML, EX, VALS, NS, U, V;
  // the launch (ops/topology.spread_filter_layout): C CTAs a spec row, the
  // node and bucket slices of a CTA, the per-warp table copies (0: the
  // tables in device memory), a local copy of the merged table, and the
  // dynamic shared memory
  int32_t C, slice, vslice, copies, local_table, smem;
};

// the dynamic shared memory of a CTA, in this order: the row's terms [TT],
// a window's signatures and multiplicities [SPREAD_LIST] each, the node
// states [slice] (all int32); with copies > 0 the partial count tables
// [copies, V], the merged bucket slice's counts [vslice] and (local_table)
// the local merged counts [V], int32, then the same three as presence
// bytes. ops/topology.spread_filter_layout computes the same bytes.
__host__ __device__ __forceinline__ size_t spread_filter_smem_bytes(const SpreadFilterArgs& a) {
  size_t bytes = 4 * ((size_t)a.TT + 2 * SPREAD_LIST + (size_t)a.slice);
  if (a.copies > 0) {
    bytes += 5 * ((size_t)a.copies * a.V + a.vslice);
    if (a.local_table) bytes += 5 * (size_t)a.V;
  }
  return bytes;
}

// the dense label of node x at a term's slot (clipped; -1: absent)
__device__ __forceinline__ int32_t ldg_dense(const SpreadFilterArgs& a, int x, int32_t slot) {
  const int sc = slot < 0 ? 0 : (slot > a.K - 1 ? a.K - 1 : slot);
  return __ldg(a.label_dense + (int64_t)x * a.K + sc);
}

__device__ __forceinline__ bool is_hard_of(const SpreadFilterArgs& a, int t, int u) {
  return a.t_valid[t] && a.t_kind[t] == SPREAD_HARD && a.t_owner[t] == u;
}

// Append the DoNotSchedule terms of spec row u to `list` in ascending term
// order (a block-wide ordered compaction); returns their count.
__device__ int ordered_hard_terms(const SpreadFilterArgs& a, int u, int32_t* list, int32_t* warp_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < a.TT; base += THREADS) {
    const int t = base + threadIdx.x;
    const bool f = t < a.TT && is_hard_of(a, t, u);
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = total, sum = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      off += w < warp ? warp_cnt[w] : 0;
      sum += warp_cnt[w];
    }
    if (f) list[off + __popc(bal & ((1u << lane) - 1u))] = t;
    total += sum;
    __syncthreads();
  }
  return total;
}

// the skew test of a term (its self-match and max skew) at a node whose
// value's merged count is match_num (int32 arithmetic with the reference's
// wrap-around)
__device__ __forceinline__ bool skew_ok(bool self_match, int32_t max_skew, int32_t match_num, int32_t mn) {
  const uint32_t lhs = (uint32_t)match_num + (self_match ? 1u : 0u) - (uint32_t)mn;
  return (int32_t)lhs <= max_skew;
}

__global__ void __launch_bounds__(THREADS) spread_filter_cluster_kernel(const SpreadFilterArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int32_t warp_cnt[THREADS / 32];
  __shared__ int64_t red[THREADS / 32];
  __shared__ int n_sigs;
  __shared__ int32_t part_min, part_any;  // this CTA's bucket slice, read by the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int u = blockIdx.y, c = blockIdx.x, C = a.C, tid = threadIdx.x, V = a.V;
  const bool shared_tables = a.copies > 0;
  int32_t* terms = (int32_t*)dyn;
  int32_t* sig_s = terms + a.TT;
  int32_t* sig_m = sig_s + SPREAD_LIST;
  uint32_t* state = (uint32_t*)(sig_m + SPREAD_LIST);
  int32_t* pcnt = (int32_t*)(state + a.slice);                    // [copies, V]
  int32_t* mcnt = pcnt + (size_t)(shared_tables ? a.copies : 0) * V;  // [vslice]
  int32_t* lcnt = mcnt + (shared_tables ? a.vslice : 0);           // [V] (local_table)
  uint8_t* ppres = (uint8_t*)(lcnt + (a.local_table ? V : 0));
  uint8_t* mpres = ppres + (size_t)(shared_tables ? a.copies : 0) * V;
  uint8_t* lpres = mpres + (shared_tables ? a.vslice : 0);

  const int n0 = c * a.slice;
  const int n1 = min(a.N, n0 + a.slice);
  const int v0 = min(V, c * a.vslice);
  const int v1 = min(V, v0 + a.vslice);
  const int64_t row = (int64_t)u * a.N;

  // 1. the row's terms; candidates and node states
  // (the first group's buckets come with the candidates: its key is the
  // first term's)
  const int nt = ordered_hard_terms(a, u, terms, warp_cnt);
  const int32_t slot0 = nt > 0 ? a.t_topo_slot[terms[0]] : -1;
  for (int x0 = n0 + tid; x0 < n1; x0 += SPREAD_BATCH * THREADS) {
    int32_t d0[SPREAD_BATCH];
    bool vs[SPREAD_BATCH];
#pragma unroll
    for (int k = 0; k < SPREAD_BATCH; ++k) {  // the batch's loads first
      const int x = x0 + k * THREADS;
      vs[k] = x < n1 && __ldg(a.n_valid + x) && __ldg(a.sel + row + x);
      d0[k] = (x < n1 && nt > 0) ? ldg_dense(a, x, slot0) : -1;
    }
#pragma unroll
    for (int k = 0; k < SPREAD_BATCH; ++k) {
      const int x = x0 + k * THREADS;
      if (x >= n1) continue;
      const bool has0 = d0[k] >= 0 && slot0 >= 0;
      bool cand = vs[k] && (nt == 0 || has0);
      for (int i = 1; i < nt && cand; ++i) {
        const int32_t si = a.t_topo_slot[terms[i]];
        cand = ldg_dense(a, x, si) >= 0 && si >= 0;
      }
      a.cand[row + x] = cand ? 1 : 0;
      state[x - n0] = ST_OK | (cand ? ST_CAND : 0u) | (has0 ? (uint32_t)(d0[k] < V ? d0[k] : V) : ST_BUCKET);
    }
  }
  __syncthreads();

  // 2. the groups: one per distinct key, led by its first term
  bool any_row = false;
  for (int i = 0; i < nt; ++i) {
    const int32_t slot = a.t_topo_slot[terms[i]];
    bool lead = true;
    for (int j = 0; j < i && lead; ++j) lead = a.t_topo_slot[terms[j]] != slot;
    if (!lead) continue;
    const int64_t lead_row = (int64_t)terms[i] * V;

    // a. clear the tables; the node buckets at this key
    if (shared_tables) {
      for (int k = tid; k < a.copies * V; k += THREADS) {
        pcnt[k] = 0;
        ppres[k] = 0;
      }
    } else {
      for (int v = v0 + tid; v < v1; v += THREADS) {
        a.merged_cnt[lead_row + v] = 0;
        a.merged_present[lead_row + v] = 0;
      }
    }
    for (int x = n0 + tid; x < n1 && i > 0; x += THREADS) {
      const int32_t d = ldg_dense(a, x, slot);
      const uint32_t bb = (d >= 0 && slot >= 0) ? (uint32_t)(d < V ? d : V) : ST_BUCKET;
      state[x - n0] = (state[x - n0] & (ST_OK | ST_CAND)) | bb;
    }
    if (shared_tables) {
      __syncthreads();
    } else {
      __threadfence();
      cluster.sync();  // every CTA's slice of the rows is clear
    }

    // b. per window of signatures: the matched ones, then the counts
    const int copy = (tid >> 5) % (shared_tables ? a.copies : 1);
    int s0 = 0;
    do {
      if (tid == 0) n_sigs = 0;
      __syncthreads();
      const int s1 = min(a.S, s0 + SPREAD_LIST);
      for (int s = s0 + tid; s < s1; s += THREADS) {
        if (!a.e_valid[s]) continue;
        int mult = 0;
        for (int j = i; j < nt; ++j) {
          const int t = terms[j];
          if (a.t_topo_slot[t] == slot &&
              selector_matches(a.t_valid, a.t_has_selector, a.t_ml_slot, a.t_ml_val, a.t_ex_op, a.t_ex_slot,
                               a.t_ex_vals, a.t_ns_any, a.t_ns_ids, a.e_labels, a.e_ns, a.KE, a.ML, a.EX, a.VALS,
                               a.NS, t, s)) {
            ++mult;
          }
        }
        if (mult) {
          const int k = atomicAdd(&n_sigs, 1);
          sig_s[k] = s;
          sig_m[k] = mult;
        }
      }
      __syncthreads();
      const int ns = n_sigs;
      if (ns > 0 || s0 == 0) {
        for (int x0 = n0 + tid; x0 < n1; x0 += SPREAD_BATCH * THREADS) {
          uint32_t bk[SPREAD_BATCH];
          int32_t cn[SPREAD_BATCH];
#pragma unroll
          for (int k = 0; k < SPREAD_BATCH; ++k) {
            const int x = x0 + k * THREADS;
            const uint32_t st = x < n1 ? state[x - n0] : 0u;
            // candidates only; segment_sum drops buckets >= V
            bk[k] = (st & ST_CAND) && (st & ST_BUCKET) < (uint32_t)V ? (st & ST_BUCKET) : ST_BUCKET;
            cn[k] = 0;
          }
          for (int j = 0; j < ns; ++j) {  // a signature's counts for the batch's nodes at once
            const int32_t sj = sig_s[j], mj = sig_m[j];
#pragma unroll
            for (int k = 0; k < SPREAD_BATCH; ++k) {
              if (bk[k] != ST_BUCKET) cn[k] += mj * (int32_t)__ldg(a.counts + (int64_t)(x0 + k * THREADS) * a.S + sj);
            }
          }
#pragma unroll
          for (int k = 0; k < SPREAD_BATCH; ++k) {
            if (bk[k] == ST_BUCKET) continue;
            if (shared_tables) {
              if (cn[k] != 0) atomicAdd(&pcnt[copy * V + bk[k]], cn[k]);
              if (s0 == 0) ppres[copy * V + bk[k]] = 1;
            } else {
              if (cn[k] != 0) atomicAdd(&a.merged_cnt[lead_row + bk[k]], cn[k]);
              if (s0 == 0) a.merged_present[lead_row + bk[k]] = 1;
            }
          }
        }
      }
      __syncthreads();
      s0 += SPREAD_LIST;
    } while (s0 < a.S);
    if (shared_tables && a.copies > 1) {
      for (int v = tid; v < V; v += THREADS) {
        int32_t cn = pcnt[v];
        uint8_t pr = ppres[v];
        for (int p = 1; p < a.copies; ++p) {
          cn += pcnt[p * V + v];
          pr |= ppres[p * V + v];
        }
        pcnt[v] = cn;
        ppres[v] = pr;
      }
    }
    if (!shared_tables) __threadfence();
    cluster.sync();  // every CTA's partial table is complete

    // c. this CTA's bucket slice: summed, written, its minimum
    int64_t mn = BIG_COUNT, any = 0;
    for (int v = v0 + tid; v < v1; v += THREADS) {
      int32_t cn = 0;
      uint8_t pr = 0;
      if (shared_tables) {
        for (int r = 0; r < C; ++r) {
          cn += *cluster.map_shared_rank(&pcnt[v], r);
          pr |= *cluster.map_shared_rank(&ppres[v], r);
        }
        mcnt[v - v0] = cn;
        mpres[v - v0] = pr;
      } else {
        cn = __ldcg(&a.merged_cnt[lead_row + v]);
        pr = __ldcg(&a.merged_present[lead_row + v]);
      }
      for (int j = i; j < nt; ++j) {
        const int t = terms[j];
        if (a.t_topo_slot[t] != slot || (!shared_tables && j == i)) continue;
        a.merged_cnt[(int64_t)t * V + v] = cn;
        a.merged_present[(int64_t)t * V + v] = pr;
      }
      if (pr) {
        mn = cn < mn ? cn : mn;
        any = 1;
      }
    }
    mn = block_min<int64_t>(mn, red, BIG_COUNT);
    any = block_max<int64_t>(any, red, 0);
    if (tid == 0) {
      part_min = (int32_t)mn;
      part_any = (int32_t)any;
    }
    cluster.sync();  // every CTA's merged slice and minimum are in place

    // d. the group's minimum over present values; the merged table locally
    int32_t gmin = BIG_COUNT;
    bool gany = false;
    for (int r = 0; r < C; ++r) {
      const int32_t pm = *cluster.map_shared_rank(&part_min, r);
      gmin = pm < gmin ? pm : gmin;
      gany |= *cluster.map_shared_rank(&part_any, r) != 0;
    }
    any_row |= gany;
    if (c == 0 && tid == 0) {
      for (int j = i; j < nt; ++j) {
        const int t = terms[j];
        if (a.t_topo_slot[t] != slot) continue;
        a.min_t[t] = gmin;
        a.any_pair_t[t] = gany ? 1 : 0;
      }
    }
    if (a.local_table) {
      for (int v = tid; v < V; v += THREADS) {
        const int r = v / a.vslice;
        lcnt[v] = *cluster.map_shared_rank(&mcnt[v - r * a.vslice], r);
        lpres[v] = *cluster.map_shared_rank(&mpres[v - r * a.vslice], r);
      }
      __syncthreads();
    }

    // e. the skew tests of the group's terms, ANDed into the node states (a
    // group of one term keeps its self-match and max skew in registers)
    int g_n = 0, g_t = 0;
    for (int j = i; j < nt; ++j) {
      if (a.t_topo_slot[terms[j]] == slot && g_n++ == 0) g_t = terms[j];
    }
    const bool g_self = a.t_self_match[g_t];
    const int32_t g_w = a.t_weight[g_t];
    for (int x = n0 + tid; x < n1; x += THREADS) {
      const uint32_t st = state[x - n0];
      if (!(st & ST_OK)) continue;
      const uint32_t b = st & ST_BUCKET;
      bool ok = b != ST_BUCKET;
      if (ok) {
        const int bc = b > (uint32_t)(V - 1) ? V - 1 : (int)b;  // gathers clamp
        int32_t cn;
        uint8_t pr;
        if (a.local_table) {
          cn = lcnt[bc];
          pr = lpres[bc];
        } else if (shared_tables) {
          const int r = bc / a.vslice;
          cn = *cluster.map_shared_rank(&mcnt[bc - r * a.vslice], r);
          pr = *cluster.map_shared_rank(&mpres[bc - r * a.vslice], r);
        } else {
          cn = __ldcg(&a.merged_cnt[lead_row + bc]);
          pr = __ldcg(&a.merged_present[lead_row + bc]);
        }
        const int32_t match_num = pr ? cn : 0;
        if (g_n == 1) {
          ok = skew_ok(g_self, g_w, match_num, gmin);
        } else {
          for (int j = i; j < nt && ok; ++j) {
            const int t = terms[j];
            if (a.t_topo_slot[t] == slot) ok = skew_ok(a.t_self_match[t], a.t_weight[t], match_num, gmin);
          }
        }
      }
      if (!ok) state[x - n0] = st & ~ST_OK;
    }
    // the next group's tables are cleared only after its first cluster
    // barrier has seen every CTA past these reads
    __syncthreads();
  }
  cluster_arrive();  // this CTA's reads of the others' shared memory are done

  // 3. the mask; the default table rows of terms no spec row owns
  for (int x = n0 + tid; x < n1; x += THREADS) {
    a.mask[row + x] = ((state[x - n0] & ST_OK) || !any_row) ? 1 : 0;
  }
  for (int t = u; t < a.TT; t += a.U) {
    const int32_t o = a.t_owner[t];
    if (a.t_valid[t] && a.t_kind[t] == SPREAD_HARD && o >= 0 && o < a.U) continue;
    for (int v = v0 + tid; v < v1; v += THREADS) {
      a.merged_cnt[(int64_t)t * V + v] = 0;
      a.merged_present[(int64_t)t * V + v] = 0;
    }
    if (c == 0 && tid == 0) {
      a.min_t[t] = BIG_COUNT;
      a.any_pair_t[t] = 0;
    }
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

extern "C" int ktpu_spread_filter(const SpreadFilterArgs* args, cudaStream_t stream) {
  const SpreadFilterArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.C < 1 || a.C > MAX_CLUSTER || a.V < 1 || a.V >= (int)ST_BUCKET || (size_t)a.C * a.slice < (size_t)a.N ||
      (size_t)a.C * a.vslice < (size_t)a.V || a.copies < 0 || spread_filter_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster((const void*)spread_filter_cluster_kernel, a.C, THREADS, (size_t)a.smem, a, stream, a.U);
}

// ---------------------------------------------------------------------------
// selector_spread_score: one block per spec row u
//   the row's matched signatures = AND over its SEL_SPREAD terms' matches
//   (with namespaces), valid, not deleting, and at least one selector;
//   pass 1: per-node counts (0 on invalid nodes), their max, and per-zone
//   sums (over valid nodes with a zone) in a V-wide table; pass 2: the
//   float64 node/zone blend, truncated.
// ---------------------------------------------------------------------------

struct SelSpreadArgs {
  const uint8_t* t_valid;       // [TT]
  const int32_t* t_kind;        // [TT]
  const int32_t* t_owner;       // [TT]
  const uint8_t* m_sig;         // [TT, S] match_terms with namespaces
  const int32_t* n_sel_spread;  // [U]
  const uint8_t* e_valid;       // [S]
  const uint8_t* e_deleting;    // [S]
  const int16_t* counts;        // [N, S]
  const uint8_t* n_valid;       // [N]
  const int32_t* zone_dense;    // [N]
  int32_t* sig_list;            // [U, S] scratch
  int64_t* ztable;              // [U, V] scratch unless table_in_shared
  int64_t* out;                 // [U, N]
  int32_t TT, S, N, U, V, table_in_shared;
};

__device__ __forceinline__ double spread_fraction(int64_t mx, int64_t c) {
  // 10 * (max - c) as float64 / max(max, 1), or 10 when max == 0
  if (mx <= 0) return (double)MAX_NODE_SCORE;
  return ((double)MAX_NODE_SCORE * (double)(mx - c)) / (double)mx;
}

__global__ void selector_spread_kernel(const SelSpreadArgs a) {
  extern __shared__ int64_t smem64[];  // [V] zone table (when in shared), then [TT] terms
  __shared__ int n_terms, n_sigs;
  __shared__ int64_t red[THREADS / 32];
  const int u = blockIdx.x;
  int64_t* table = a.table_in_shared ? smem64 : a.ztable + (int64_t)u * a.V;
  int32_t* terms = (int32_t*)(a.table_in_shared ? smem64 + a.V : smem64);
  const int nt = owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, SEL_SPREAD, u, terms, &n_terms);
  int32_t* sigs = a.sig_list + (int64_t)u * a.S;
  if (threadIdx.x == 0) n_sigs = 0;
  __syncthreads();
  if (a.n_sel_spread[u] > 0) {
    for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
      bool ok = a.e_valid[s] && !a.e_deleting[s];
      for (int i = 0; i < nt && ok; ++i) ok = a.m_sig[(int64_t)terms[i] * a.S + s];
      if (ok) sigs[atomicAdd(&n_sigs, 1)] = s;
    }
  }
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) table[v] = 0;
  __syncthreads();
  const int ns = n_sigs;
  int64_t* out = a.out + (int64_t)u * a.N;
  int64_t mx = 0, have_zones = 0;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    int64_t c = 0;
    if (a.n_valid[n]) {
      const int16_t* row = a.counts + (int64_t)n * a.S;
      for (int i = 0; i < ns; ++i) c += row[sigs[i]];
    }
    out[n] = c;
    mx = c > mx ? c : mx;
    const int32_t z = a.zone_dense[n];
    if (z >= 0 && a.n_valid[n]) {
      have_zones = 1;
      if (z < a.V && c != 0) atomicAdd((unsigned long long*)&table[z], (unsigned long long)c);
    }
  }
  mx = block_max<int64_t>(mx, red, 0);
  have_zones = block_max<int64_t>(have_zones, red, 0);  // any(zone_ok) over all nodes
  int64_t mz = 0;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) mz = table[v] > mz ? table[v] : mz;
  mz = block_max<int64_t>(mz, red, 0);
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const int64_t c = out[n];
    const double fscore = spread_fraction(mx, c);
    const int32_t z = a.zone_dense[n];
    double blended = fscore;
    if (have_zones && z >= 0 && a.n_valid[n]) {
      // the zone score of the node's bucket (a V-wide gather: clamped)
      const double zscore = spread_fraction(mz, table[z > a.V - 1 ? a.V - 1 : z]);
      blended = fscore * (1.0 / 3.0) + (2.0 / 3.0) * zscore;
    }
    out[n] = (int64_t)blended;
  }
}

extern "C" int ktpu_selector_spread_score(const SelSpreadArgs* args, cudaStream_t stream) {
  const SelSpreadArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  const size_t bytes = (a.table_in_shared ? (size_t)a.V * sizeof(int64_t) : 0) +
                       (size_t)a.TT * sizeof(int32_t);
  int rc;
  if ((rc = set_smem((const void*)selector_spread_kernel, bytes))) return rc;
  selector_spread_kernel<<<a.U, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}
