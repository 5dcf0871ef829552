// Topology kernels: term matching, EvenPodsSpread (ScheduleAnyway) score and
// SelectorSpread score.
//
// Replace, in kubernetes_tpu/ops/topology.py:
//   ktpu_match_terms            match_terms (:49)
//   ktpu_spread_score           spread_score (:227) with _bucket_of, _seg_sum,
//                               _sig_cnt_node, _merge_same_key, _gather_rows,
//                               _scatter_and and _scatter_add inside
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
// Bound: none of the three has enough arithmetic to matter. match_terms is
// bound by its [TT, X] byte output and label reads; the two scores read the
// counts columns of the matched signatures once per term or spec row, the
// node bank's dense label column once per term, and write [U, N] int64:
// bytes. Their real cost here is launch count and the serial loops over a
// few nodes per thread (U or TT blocks of 256 threads each walk N nodes).
#include "common.cuh"

#define SPREAD_SOFT 6
#define SEL_SPREAD 7
#define THREADS 256
#define BIG_COUNT (1 << 30)

// ---------------------------------------------------------------------------
// block reductions
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? red[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const T out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ __forceinline__ T block_max(T v, T* red, T ident) {
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? red[lane] : ident;
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_down_sync(0xffffffffu, v, off);
      v = o > v ? o : v;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const T out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ __forceinline__ T block_min(T v, T* red, T ident) {
  return -block_max<T>(-v, red, -ident);
}

// Append the terms of `kind` owned by spec row u to `list` (shared memory);
// returns their count. The order is arbitrary: every use is an AND or an
// integer sum.
__device__ int owner_terms(const uint8_t* valid, const int32_t* kind, const int32_t* owner, int TT,
                           int32_t want_kind, int u, int32_t* list, int* n_list) {
  if (threadIdx.x == 0) *n_list = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < TT; t += blockDim.x) {
    if (valid[t] && kind[t] == want_kind && owner[t] == u) list[atomicAdd(n_list, 1)] = t;
  }
  __syncthreads();
  return *n_list;
}

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
// spread_score: four launches from one entry
//   1. member   [U, N]: valid node carrying every soft topology key of row u
//   2. pairs    per soft term: counts of matching pods on counting nodes
//               (member & raw node selector) and member presence, per
//               topology value bucket
//   3. merge    per soft term: sum the pair tables of the row's terms on the
//               same key
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
  int64_t* out;                 // [U, N]
  int32_t TT, S, N, K, U, V, table_in_shared;
};

__device__ __forceinline__ bool is_soft(const SpreadArgs& a, int t) {
  return a.t_valid[t] && a.t_kind[t] == SPREAD_SOFT;
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
  const int nt = owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, SPREAD_SOFT, u, terms, &n_terms);
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    bool m = a.n_valid[n];
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

static int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return 0;
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
