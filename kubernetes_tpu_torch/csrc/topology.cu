// Topology kernels: term matching, EvenPodsSpread (DoNotSchedule filter and
// ScheduleAnyway score) and SelectorSpread score.
//
// Replace, in kubernetes_tpu/ops/topology.py:
//   ktpu_match_terms            match_terms (:49)
//   ktpu_spread_filter          spread_filter (:182) with _bucket_of, _seg_sum,
//                               _sig_cnt_node, _merge_same_key, _gather_rows
//                               and _scatter_and inside
//                               (its first three launches leave the metadata
//                               that kubernetes_tpu/commit/arbiter.py
//                               _spread_tables (:76) reads in the scratch)
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
// (the filter [U, N] bytes): bytes. Their real cost here is launch count and the serial loops over a
// few nodes per thread (U or TT blocks of 256 threads each walk N nodes).
#include "topology.cuh"

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
// nil selector or an invalid row matches nothing.
__device__ bool term_matches(const MatchArgs& a, int t, int x) {
  if (!a.valid[t] || !a.has_selector[t]) return false;
  const int32_t* lab = a.labels + (int64_t)x * a.K;
  const int kmax = a.K - 1;
  for (int j = 0; j < a.ML; ++j) {
    const int32_t slot = a.ml_slot[(int64_t)t * a.ML + j];
    if (slot < 0) continue;
    if (lab[slot > kmax ? kmax : slot] != a.ml_val[(int64_t)t * a.ML + j]) return false;
  }
  for (int j = 0; j < a.EX; ++j) {
    const int64_t e = (int64_t)t * a.EX + j;
    const int32_t op = a.ex_op[e];
    const int32_t slot = a.ex_slot[e];
    const int32_t v = lab[slot < 0 ? 0 : (slot > kmax ? kmax : slot)];
    const bool present = v != 0;
    bool ok = true;
    switch (op) {
      case OP_IN:
      case OP_NOT_IN: {
        bool in_set = false;
        const int32_t* vals = a.ex_vals + e * a.VALS;
        for (int k = 0; k < a.VALS; ++k) in_set |= (v == vals[k]);
        ok = op == OP_IN ? (present && in_set) : (!present || !in_set);
        break;
      }
      case OP_EXISTS: ok = present; break;
      case OP_DOES_NOT_EXIST: ok = !present; break;
      case OP_NEVER: ok = false; break;
      default: break;
    }
    if (!ok) return false;
  }
  if (a.ns != nullptr && !a.ns_any[t]) {
    const int32_t nsx = a.ns[x];
    bool in = false;
    for (int j = 0; j < a.NS; ++j) in |= (a.ns_ids[(int64_t)t * a.NS + j] == nsx);
    if (!in) return false;
  }
  return true;
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
// spread_score and spread_filter: four launches from one entry each, the
// first three shared (`kind` picks the soft or the hard terms)
//   1. member   [U, N]: valid node carrying every topology key of row u's
//               terms of the kind (hard: and passing the raw node selector —
//               the candidate nodes)
//   2. pairs    per term: counts of matching pods on counting nodes (member
//               & raw node selector) and member presence, per topology value
//               bucket
//   3. merge    per term: sum the pair tables of the row's terms on the same
//               key; hard: also the minimum count over present values and
//               whether any value is present
//   4. score    per spec row: gather back per node, sum over the row's
//               terms, total and min over member nodes, 10*(total-cnt)/diff
//      filter   per spec row: every hard term's key present and its value's
//               count + self-match - minimum <= max_skew, or no value present
//               for any of the row's hard terms
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
  int64_t* out;                 // [U, N] score (soft)
  const uint8_t* t_self_match;  // [TT] (hard)
  const int32_t* t_weight;      // [TT] max_skew (hard)
  int32_t* min_t;               // [TT] scratch (hard)
  uint8_t* any_pair_t;          // [TT] scratch (hard)
  uint8_t* mask;                // [U, N] filter (hard)
  int32_t TT, S, N, K, U, V, table_in_shared, kind;
};

__device__ __forceinline__ bool is_kind(const SpreadArgs& a, int t) {
  return a.t_valid[t] && a.t_kind[t] == a.kind;
}

// _bucket_of for one node: the dense value at the clipped slot, clipped to
// >= 0; returns has_key (a value is present and the slot is known).
__device__ __forceinline__ bool bucket_of(const SpreadArgs& a, int n, int32_t slot, int32_t* b) {
  const int sc = slot < 0 ? 0 : (slot > a.K - 1 ? a.K - 1 : slot);
  const int32_t d = a.label_dense[(int64_t)n * a.K + sc];
  *b = d < 0 ? 0 : d;
  return d >= 0 && slot >= 0;
}

__global__ void spread_member_kernel(const SpreadArgs a) {
  extern __shared__ int32_t terms[];  // [TT]
  __shared__ int n_terms;
  const int u = blockIdx.x;
  const int nt = owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, a.kind, u, terms, &n_terms);
  const bool hard = a.kind == SPREAD_HARD;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    bool m = a.n_valid[n] && (!hard || a.sel[(int64_t)u * a.N + n]);
    for (int i = 0; i < nt && m; ++i) {
      int32_t b;
      m = bucket_of(a, n, a.t_topo_slot[terms[i]], &b);
    }
    a.member[(int64_t)u * a.N + n] = m ? 1 : 0;
  }
}

__global__ void spread_pairs_kernel(const SpreadArgs a) {
  extern __shared__ int32_t table[];  // [2V] when table_in_shared
  __shared__ int n_sigs;
  const int t = blockIdx.x;
  if (!is_kind(a, t)) return;
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
    const bool has = bucket_of(a, n, slot, &b);
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
  __shared__ int64_t red[THREADS / 32];
  const int t = blockIdx.x;
  if (!is_kind(a, t)) return;
  if (threadIdx.x == 0) n_group = 0;
  __syncthreads();
  for (int q = threadIdx.x; q < a.TT; q += blockDim.x) {
    if (is_kind(a, q) && a.t_owner[q] == a.t_owner[t] && a.t_topo_slot[q] == a.t_topo_slot[t]) {
      group[atomicAdd(&n_group, 1)] = q;
    }
  }
  __syncthreads();
  const int ng = n_group;
  int64_t mn = BIG_COUNT, any = 0;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) {
    int32_t c = 0, p = 0;
    for (int i = 0; i < ng; ++i) {
      c += a.pair_cnt[(int64_t)group[i] * a.V + v];
      p += a.pair_present[(int64_t)group[i] * a.V + v];
    }
    a.merged_cnt[(int64_t)t * a.V + v] = c;
    a.merged_present[(int64_t)t * a.V + v] = p > 0 ? 1 : 0;
    if (p > 0) {
      mn = c < mn ? c : mn;
      any = 1;
    }
  }
  if (a.kind == SPREAD_HARD) {  // block-uniform
    mn = block_min<int64_t>(mn, red, BIG_COUNT);
    any = block_max<int64_t>(any, red, 0);
    if (threadIdx.x == 0) {
      a.min_t[t] = (int32_t)mn;
      a.any_pair_t[t] = any ? 1 : 0;
    }
  }
}

// the DoNotSchedule predicate of spec row u on every node
__global__ void spread_filter_kernel(const SpreadArgs a) {
  extern __shared__ int32_t terms[];  // [TT]
  __shared__ int n_terms;
  const int u = blockIdx.x;
  const int nt = owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, SPREAD_HARD, u, terms, &n_terms);
  bool any_pair = false;
  for (int i = 0; i < nt; ++i) any_pair |= a.any_pair_t[terms[i]] != 0;
  uint8_t* mask = a.mask + (int64_t)u * a.N;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    bool ok = true;
    for (int i = 0; i < nt && ok; ++i) {
      const int t = terms[i];
      int32_t b;
      const bool has = bucket_of(a, n, a.t_topo_slot[t], &b);
      const int64_t tv = (int64_t)t * a.V + (b > a.V - 1 ? a.V - 1 : b);  // gathers clamp
      const int32_t match_num = a.merged_present[tv] ? a.merged_cnt[tv] : 0;
      ok = has && match_num + (a.t_self_match[t] ? 1 : 0) - a.min_t[t] <= a.t_weight[t];
    }
    mask[n] = (ok || !any_pair) ? 1 : 0;
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
      const bool has = bucket_of(a, n, a.t_topo_slot[t], &b);
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

// launches 1-3: the member (candidate) rows and the merged tables
static int launch_spread_tables(const SpreadArgs& a, cudaStream_t stream) {
  const size_t term_bytes = (size_t)a.TT * sizeof(int32_t);
  const size_t table_bytes = a.table_in_shared ? (size_t)2 * a.V * sizeof(int32_t) : 0;
  int rc;
  if ((rc = set_smem((const void*)spread_member_kernel, term_bytes))) return rc;
  if ((rc = set_smem((const void*)spread_pairs_kernel, table_bytes))) return rc;
  if ((rc = set_smem((const void*)spread_merge_kernel, term_bytes))) return rc;
  spread_member_kernel<<<a.U, THREADS, term_bytes, stream>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  spread_pairs_kernel<<<a.TT, THREADS, table_bytes, stream>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  spread_merge_kernel<<<a.TT, THREADS, term_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_spread_score(const SpreadArgs* args, cudaStream_t stream) {
  const SpreadArgs& a = *args;
  if (a.U <= 0 || a.N <= 0 || a.TT <= 0) return (int)cudaGetLastError();
  const size_t term_bytes = (size_t)a.TT * sizeof(int32_t);
  int rc;
  if ((rc = launch_spread_tables(a, stream))) return rc;
  if ((rc = set_smem((const void*)spread_score_kernel, term_bytes))) return rc;
  spread_score_kernel<<<a.U, THREADS, term_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_spread_filter(const SpreadArgs* args, cudaStream_t stream) {
  const SpreadArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  int rc;
  if (a.TT <= 0) {  // no terms: every pair passes
    return (int)cudaMemsetAsync(a.mask, 1, (size_t)a.U * a.N, stream);
  }
  const size_t term_bytes = (size_t)a.TT * sizeof(int32_t);
  if ((rc = launch_spread_tables(a, stream))) return rc;
  if ((rc = set_smem((const void*)spread_filter_kernel, term_bytes))) return rc;
  spread_filter_kernel<<<a.U, THREADS, term_bytes, stream>>>(a);
  return (int)cudaGetLastError();
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
