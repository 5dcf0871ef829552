// Inter-pod affinity kernels: InterPodAffinityMatches, the inter-pod
// affinity priority and the solver's pairwise host-port conflict table.
//
// Replace, in kubernetes_tpu/ops:
//   ktpu_interpod_filter        topology.py:281 interpod_filter, with _bucket_of,
//                               _seg_sum, _sig_cnt_node, _gather_rows, _scatter_and
//                               and _scatter_or (:164) inside
//   ktpu_interpod_score         topology.py:363 interpod_score
//   ktpu_inbatch_port_conflict  pipeline.py:178 _inbatch_tensors' [U, U] port_clash
//
// Existing pods enter twice: as label SIGNATURES (state/tensors.SigBank,
// counts[N, S] int16) matched by the batch's terms, and their own terms as
// PATTERNS (state/terms.PatternBank, counts[N, PT] int16) matched against
// the batch's spec rows. The term x signature and pattern x spec-row
// matches come from the match_terms kernel (topology.cu), launched by the
// wrappers before these.
//
// ktpu_interpod_filter: up to three launches, by the parts asked for
//   1. pattern tables   one block per ANTI_REQ pattern: its instance counts
//                       summed per topology bucket ("existing")
//   2. term tables      one block per AFF_REQ / ANTI_REQ term: the
//                       signatures it counts compacted into a list (for
//                       required affinity those matching EVERY AFF_REQ term
//                       of its owner), their per-node counts summed per
//                       bucket, and whether any bucket is non-empty
//   3. mask             one thread per (spec row, node): OR over the row's
//                       matching ANTI_REQ patterns, AND over its AFF_REQ
//                       terms (with the first-pod escape), OR over its
//                       ANTI_REQ terms, each a gather of its table at the
//                       node's bucket
// ktpu_interpod_score: pattern tables (AFF_REQ / AFF_PREF / ANTI_PREF),
//   term tables (AFF_PREF / ANTI_PREF), then one block per spec row: the
//   weighted per-node sums in int64, the row's min and max over valid
//   nodes with 0 clamped in, and 10 * (c - min) // (max - min).
//
// Every count is an integer sum (atomics on int32 tables): the reference's
// f32 products are exact only below 2^24, these everywhere, and the order
// of the atomics does not change a result. A bucket at or above V is
// dropped from a sum and clamped in a gather, as segment_sum and the JAX
// gather do.
//
// Bound: bytes. Each table block reads one dense label column and the
// counts columns its term or pattern names; the mask and score kernels
// read the small tables and write [U, N]. The arithmetic is a few integer
// adds per (term, node); the real cost at the config-4 shapes is the
// launches and the serial walks of N nodes by PT or TT blocks.
#include "topology.cuh"

#define PART_EXISTING 1   // interpod_filter "existing"
#define PART_AFF 2        // interpod_filter "aff"
#define PART_ANTI 4       // interpod_filter "anti"
#define PART_PREF 8       // interpod_score "pref"
#define PART_X_SCORE 16   // interpod_score "existing"

struct InterpodArgs {
  const uint8_t* n_valid;         // [N]
  const int32_t* label_dense;     // [N, K]
  const uint8_t* x_valid;         // [PT] patterns
  const int32_t* x_kind;          // [PT]
  const int32_t* x_topo_slot;     // [PT]
  const int32_t* x_weight;        // [PT]
  const int16_t* x_counts;        // [N, PT]
  const uint8_t* m_pt;            // [PT, U] pattern matches spec row (labels + namespace)
  const uint8_t* t_valid;         // [TT] batch terms
  const int32_t* t_kind;          // [TT]
  const int32_t* t_owner;         // [TT]
  const int32_t* t_topo_slot;     // [TT]
  const int32_t* t_weight;        // [TT]
  const uint8_t* m_sig;           // [TT, S] term matches signature (labels + namespace)
  const uint8_t* e_valid;         // [S]
  const int16_t* counts;          // [N, S]
  const uint8_t* p_valid;         // [U]
  const uint8_t* self_aff_match;  // [U]
  const uint8_t* has_aff;         // [U]
  int32_t* sig_list;              // [TT, S] scratch
  int32_t* x_table;               // [PT, V] scratch: per-bucket pattern instances
  int32_t* t_table;               // [TT, V] scratch: per-bucket term matches
  uint8_t* any_pair;              // [TT] scratch: the term's table is non-empty
  uint8_t* mask;                  // [U, N] filter output
  int64_t* score;                 // [U, N] score output
  int32_t N, K, PT, TT, S, U, V, parts, table_in_shared;
};

__device__ __forceinline__ bool kind_in(int32_t kind, int kind_mask) {
  return kind > 0 && kind < 31 && ((kind_mask >> kind) & 1);
}

__device__ __forceinline__ int clamp_bucket(int32_t b, int V) { return b > V - 1 ? V - 1 : b; }

// Per-bucket instance sums of one pattern of a wanted kind: the hosting
// node must carry the pattern's topology key.
__global__ void pattern_table_kernel(const InterpodArgs a, int kind_mask) {
  extern __shared__ int32_t table_s[];  // [V] when table_in_shared
  const int pt = blockIdx.x;
  if (!a.x_valid[pt] || !kind_in(a.x_kind[pt], kind_mask)) return;
  int32_t* table = a.table_in_shared ? table_s : a.x_table + (int64_t)pt * a.V;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) table[v] = 0;
  __syncthreads();
  const int32_t slot = a.x_topo_slot[pt];
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    int32_t b;
    if (!dense_bucket(a.label_dense, a.K, n, slot, &b) || b >= a.V) continue;
    const int32_t c = a.x_counts[(int64_t)n * a.PT + pt];
    if (c != 0) atomicAdd(&table[b], c);
  }
  if (a.table_in_shared) {
    __syncthreads();
    for (int v = threadIdx.x; v < a.V; v += blockDim.x) a.x_table[(int64_t)pt * a.V + v] = table_s[v];
  }
}

// Per-bucket match sums of one batch term of a wanted kind, and whether any
// bucket holds a match.
__global__ void term_table_kernel(const InterpodArgs a, int kind_mask) {
  extern __shared__ int32_t smem[];  // [V] table when in shared, then [TT] the owner's AFF_REQ terms
  __shared__ int n_sigs, n_aff;
  const int t = blockIdx.x;
  if (!a.t_valid[t] || !kind_in(a.t_kind[t], kind_mask)) return;
  int32_t* table = a.table_in_shared ? smem : a.t_table + (int64_t)t * a.V;
  int32_t* aff_terms = a.table_in_shared ? smem + a.V : smem;
  const bool all_of_owner = a.t_kind[t] == AFF_REQ;
  int na = 0;
  if (all_of_owner) {
    na = owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, AFF_REQ, a.t_owner[t], aff_terms, &n_aff);
  }
  int32_t* sigs = a.sig_list + (int64_t)t * a.S;
  if (threadIdx.x == 0) n_sigs = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    bool ok = a.e_valid[s];
    if (all_of_owner) {
      for (int i = 0; i < na && ok; ++i) ok = a.m_sig[(int64_t)aff_terms[i] * a.S + s];
    } else {
      ok = ok && a.m_sig[(int64_t)t * a.S + s];
    }
    if (ok) sigs[atomicAdd(&n_sigs, 1)] = s;
  }
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) table[v] = 0;
  __syncthreads();
  const int ns = n_sigs;
  const int32_t slot = a.t_topo_slot[t];
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    int32_t b;
    if (!dense_bucket(a.label_dense, a.K, n, slot, &b) || b >= a.V) continue;
    const int16_t* row = a.counts + (int64_t)n * a.S;
    int32_t c = 0;
    for (int i = 0; i < ns; ++i) c += row[sigs[i]];
    if (c != 0) atomicAdd(&table[b], c);
  }
  __syncthreads();
  int any = 0;
  for (int v = threadIdx.x; v < a.V; v += blockDim.x) {
    const int32_t c = table[v];
    if (a.table_in_shared) a.t_table[(int64_t)t * a.V + v] = c;
    any |= c > 0;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) a.any_pair[t] = any ? 1 : 0;
}

__global__ void interpod_mask_kernel(const InterpodArgs a) {
  extern __shared__ int32_t lists[];  // [PT] matching ANTI_REQ patterns, [TT] AFF_REQ, [TT] ANTI_REQ terms
  __shared__ int n_pats, n_aff, n_anti;
  const int u = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t* pats = lists;
  int32_t* aff = lists + a.PT;
  int32_t* anti = aff + a.TT;
  if (threadIdx.x == 0) n_pats = 0;
  __syncthreads();
  if (a.parts & PART_EXISTING) {
    for (int pt = threadIdx.x; pt < a.PT; pt += blockDim.x) {
      if (a.x_valid[pt] && a.x_kind[pt] == ANTI_REQ && a.m_pt[(int64_t)pt * a.U + u]) {
        pats[atomicAdd(&n_pats, 1)] = pt;
      }
    }
  }
  const int naff = (a.parts & PART_AFF) ? owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, AFF_REQ, u, aff, &n_aff) : 0;
  const int nanti = (a.parts & PART_ANTI) ? owner_terms(a.t_valid, a.t_kind, a.t_owner, a.TT, ANTI_REQ, u, anti, &n_anti) : 0;
  __syncthreads();
  const int np = n_pats;
  if (n >= a.N) return;
  bool ok = true;
  // existing pods' required anti-affinity: a matching pattern hosted in the
  // node's bucket blocks it
  for (int i = 0; i < np && ok; ++i) {
    const int pt = pats[i];
    int32_t b;
    if (dense_bucket(a.label_dense, a.K, n, a.x_topo_slot[pt], &b) &&
        a.x_table[(int64_t)pt * a.V + clamp_bucket(b, a.V)] > 0) {
      ok = false;
    }
  }
  // required affinity: every term's bucket holds a pod matching all of them,
  // unless no such pod exists anywhere and the pod matches its own terms
  if (ok && (a.parts & PART_AFF) && a.has_aff[u]) {
    bool aff_ok = true, any_pair = false;
    for (int i = 0; i < naff; ++i) {
      const int t = aff[i];
      int32_t b;
      const bool has = dense_bucket(a.label_dense, a.K, n, a.t_topo_slot[t], &b);
      aff_ok = aff_ok && has && a.t_table[(int64_t)t * a.V + clamp_bucket(b, a.V)] > 0;
      any_pair = any_pair || a.any_pair[t];
    }
    ok = aff_ok || (!any_pair && a.self_aff_match[u]);
  }
  // required anti-affinity: a matching pod in any term's bucket blocks
  for (int i = 0; i < nanti && ok; ++i) {
    const int t = anti[i];
    int32_t b;
    if (dense_bucket(a.label_dense, a.K, n, a.t_topo_slot[t], &b) &&
        a.t_table[(int64_t)t * a.V + clamp_bucket(b, a.V)] > 0) {
      ok = false;
    }
  }
  a.mask[(int64_t)u * a.N + n] = ok ? 1 : 0;
}

__global__ void interpod_score_kernel(const InterpodArgs a) {
  extern __shared__ int32_t lists[];  // [TT] the row's preferred terms, [PT] its matching score patterns
  __shared__ int n_pref, n_pats;
  __shared__ int64_t red[THREADS / 32];
  const int u = blockIdx.x;
  int32_t* pref = lists;
  int32_t* pats = lists + a.TT;
  if (threadIdx.x == 0) {
    n_pref = 0;
    n_pats = 0;
  }
  __syncthreads();
  if (a.parts & PART_PREF) {
    for (int t = threadIdx.x; t < a.TT; t += blockDim.x) {
      if (a.t_valid[t] && (a.t_kind[t] == AFF_PREF || a.t_kind[t] == ANTI_PREF) && a.t_owner[t] == u) {
        pref[atomicAdd(&n_pref, 1)] = t;
      }
    }
  }
  if (a.parts & PART_X_SCORE) {
    for (int pt = threadIdx.x; pt < a.PT; pt += blockDim.x) {
      const int32_t k = a.x_kind[pt];
      if (a.x_valid[pt] && (k == AFF_REQ || k == AFF_PREF || k == ANTI_PREF) && a.m_pt[(int64_t)pt * a.U + u]) {
        pats[atomicAdd(&n_pats, 1)] = pt;
      }
    }
  }
  __syncthreads();
  const int np = n_pref, nx = n_pats;
  const bool row_valid = a.p_valid[u];
  int64_t* out = a.score + (int64_t)u * a.N;
  int64_t mx = 0, mn = 0;  // the clamps max(., 0) and min(., 0)
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    int64_t c = 0;
    for (int i = 0; i < np; ++i) {
      const int t = pref[i];
      int32_t b;
      if (dense_bucket(a.label_dense, a.K, n, a.t_topo_slot[t], &b)) {
        const uint32_t cnt = (uint32_t)a.t_table[(int64_t)t * a.V + clamp_bucket(b, a.V)];
        c += (int64_t)(int32_t)(cnt * (uint32_t)a.t_weight[t]);  // the reference's int32 product
      }
    }
    for (int i = 0; i < nx; ++i) {
      const int pt = pats[i];
      int32_t b;
      if (dense_bucket(a.label_dense, a.K, n, a.x_topo_slot[pt], &b)) {
        c += (int64_t)a.x_weight[pt] * (int64_t)a.x_table[(int64_t)pt * a.V + clamp_bucket(b, a.V)];
      }
    }
    out[n] = c;
    if (row_valid && a.n_valid[n]) {
      mx = c > mx ? c : mx;
      mn = c < mn ? c : mn;
    }
  }
  mx = block_max<int64_t>(mx, red, 0);
  mn = block_min<int64_t>(mn, red, 0);
  const int64_t diff = mx - mn;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const int64_t c = out[n];
    out[n] = (row_valid && a.n_valid[n] && diff > 0) ? floordiv(MAX_NODE_SCORE * (c - mn), diff) : 0;
  }
}

static size_t table_bytes(const InterpodArgs& a) {
  return a.table_in_shared ? (size_t)a.V * sizeof(int32_t) : 0;
}

static int launch_pattern_tables(const InterpodArgs& a, int kind_mask, cudaStream_t stream) {
  if (a.PT <= 0) return 0;
  const size_t bytes = table_bytes(a);
  int rc;
  if ((rc = set_smem((const void*)pattern_table_kernel, bytes))) return rc;
  pattern_table_kernel<<<a.PT, THREADS, bytes, stream>>>(a, kind_mask);
  return (int)cudaGetLastError();
}

static int launch_term_tables(const InterpodArgs& a, int kind_mask, cudaStream_t stream) {
  if (a.TT <= 0) return 0;
  const size_t bytes = table_bytes(a) + (size_t)a.TT * sizeof(int32_t);
  int rc;
  if ((rc = set_smem((const void*)term_table_kernel, bytes))) return rc;
  term_table_kernel<<<a.TT, THREADS, bytes, stream>>>(a, kind_mask);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_interpod_filter(const InterpodArgs* args, cudaStream_t stream) {
  const InterpodArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  int rc;
  if ((a.parts & PART_EXISTING) && (rc = launch_pattern_tables(a, 1 << ANTI_REQ, stream))) return rc;
  const int term_kinds = ((a.parts & PART_AFF) ? 1 << AFF_REQ : 0) | ((a.parts & PART_ANTI) ? 1 << ANTI_REQ : 0);
  if (term_kinds && (rc = launch_term_tables(a, term_kinds, stream))) return rc;
  const size_t bytes = ((size_t)a.PT + 2 * (size_t)a.TT) * sizeof(int32_t);
  if ((rc = set_smem((const void*)interpod_mask_kernel, bytes))) return rc;
  dim3 grid((a.N + THREADS - 1) / THREADS, a.U);
  interpod_mask_kernel<<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_interpod_score(const InterpodArgs* args, cudaStream_t stream) {
  const InterpodArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  int rc;
  if ((a.parts & PART_X_SCORE) &&
      (rc = launch_pattern_tables(a, (1 << AFF_REQ) | (1 << AFF_PREF) | (1 << ANTI_PREF), stream))) {
    return rc;
  }
  if ((a.parts & PART_PREF) && (rc = launch_term_tables(a, (1 << AFF_PREF) | (1 << ANTI_PREF), stream))) {
    return rc;
  }
  const size_t bytes = ((size_t)a.TT + (size_t)a.PT) * sizeof(int32_t);
  if ((rc = set_smem((const void*)interpod_score_kernel, bytes))) return rc;
  interpod_score_kernel<<<a.U, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// inbatch_port_conflict: [U, U], one thread per spec pair
// ---------------------------------------------------------------------------

struct PortConflictArgs {
  const int32_t* port_num;    // [U, PP]
  const int32_t* port_proto;  // [U, PP]
  const int32_t* port_ip;     // [U, PP]
  uint8_t* out;               // [U, U]
  int32_t U, PP, wildcard_ip;
};

__global__ void inbatch_port_conflict_kernel(const PortConflictArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)a.U * a.U) return;
  const int64_t u = i / a.U, w = i % a.U;
  a.out[i] = ports_clash(a.port_num + u * a.PP, a.port_proto + u * a.PP, a.port_ip + u * a.PP, a.PP,
                         a.port_num + w * a.PP, a.port_proto + w * a.PP, a.port_ip + w * a.PP, a.PP,
                         a.wildcard_ip) ? 1 : 0;
}

extern "C" int ktpu_inbatch_port_conflict(const PortConflictArgs* args, cudaStream_t stream) {
  const int64_t pairs = (int64_t)args->U * args->U;
  if (pairs > 0) {
    inbatch_port_conflict_kernel<<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
