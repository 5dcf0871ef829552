// Commit arbiter: the sequential-equivalent verdict pass over a solved batch.
//
// Replaces kubernetes_tpu/commit/arbiter.py:arbitrate (:157) with its
// _spread_tables (:76). The reference scans the batch in pop order (a
// lax.scan of B steps); each step checks the pod's assigned node against the
// state every earlier V_PLACE commit of the batch left — capacity and pod
// count, required anti-affinity both ways (ca: commits each anti term
// matches, cb: commits owning it, per topology value), host ports (cs:
// commits per (spec, node)) and DoNotSchedule skew (the merged
// per-(term, value) counts plus md, this batch's commits into them) — gives
// it a verdict and folds a placed pod into that state.
//
// Design: two launches from one entry.
//   1. init      grid-wide: copy the residuals (free, count) the scan
//                mutates, zero the tables that live in device memory, and
//                compute gm [TT, U]: per hard term and spec row, the number
//                of hard terms of the term's (owner, key) group matching the
//                spec row (the reference's f32 product of two 0/1 matrices,
//                here an integer count)
//   2. scan      ONE warp walks the B steps. Per step each lane takes a
//                strided share of the resource slots, the terms and the
//                spec rows; the verdict is a warp vote (__all_sync /
//                __any_sync); the commit is written by the lanes that own
//                each table cell, and __syncwarp publishes it before the
//                next step. No block barrier exists in the loop.
// ca, cb and md ([TT, V] int32; the reference's ca/cb are f32 compared > 0)
// live in shared memory while they fit, cs [U, N] too; at the config-4
// shapes (TT = 32, V = 2,048) they do not, and stay in device memory.
// Reads of a [TT, V] table at a node's bucket clamp to V - 1 (the
// reference's gathers); writes at a bucket >= V are dropped (its
// mode="drop" scatters). The hard-spread metadata (candidate nodes, merged
// counts, presence, whether a term sees any value) comes from
// csrc/topology.cu's spread-tables entry, launched before this one.
//
// Bound: the scan is serial over B pods; per step it reads a few hundred
// bytes (the pod's request row, its terms' buckets and table cells, a cs
// column), far below what its latency chain allows: latency, not bytes or
// operations, sets its time.
#include "topology.cuh"

#define ARB_THREADS 32
#define FULL_MASK 0xffffffffu
#define V_PLACE 0
#define V_DEFER 1
#define V_NOFIT 2

struct ArbiterArgs {
  const int64_t* order;          // [B] pop order (batch positions)
  const int32_t* sig;            // [B] spec row
  const uint8_t* pod_valid;      // [B]
  const int32_t* assign;         // [B] the solve's node row (-1 = none)
  const int64_t* free0;          // [N, R] alloc - requested
  const int64_t* count0;         // [N]
  const int64_t* allowed;        // [N]
  const int64_t* req;            // [U, R]
  const uint8_t* req_any;        // [U]
  const uint8_t* t_valid;        // [TT]
  const int32_t* t_kind;         // [TT]
  const int32_t* t_owner;        // [TT]
  const int32_t* t_topo_slot;    // [TT]
  const uint8_t* t_self_match;   // [TT]
  const int32_t* t_weight;       // [TT] max_skew of a hard term
  const uint8_t* m_raw;          // [TT, U] term matches spec row (namespaces tested)
  const int32_t* label_dense;    // [N, K]
  const uint8_t* pconf;          // [U, U] spec-pair host-port clash
  const uint8_t* cand;           // [U, N] hard-spread candidate nodes
  const int32_t* merged_cnt0;    // [TT, V]
  const uint8_t* merged_present; // [TT, V]
  const uint8_t* any_pair_t;     // [TT]
  int64_t* free_;                // [N, R] scratch
  int64_t* count;                // [N] scratch
  int32_t* ca;                   // [TT, V] scratch unless tables_in_shared
  int32_t* cb;                   // [TT, V] scratch unless tables_in_shared
  int32_t* cs;                   // [U, N] scratch unless cs_in_shared
  int32_t* md;                   // [TT, V] scratch unless tables_in_shared
  int32_t* mh;                   // [TT] scratch
  int32_t* gm;                   // [TT, U] scratch
  int32_t* verdict;              // [B] out
  int32_t B, U, N, R, TT, K, V, have_spread, tables_in_shared, cs_in_shared;
};

__device__ __forceinline__ bool is_hard(const ArbiterArgs& a, int t) {
  return a.t_valid[t] && a.t_kind[t] == SPREAD_HARD;
}

__device__ __forceinline__ bool is_anti(const ArbiterArgs& a, int t) {
  return a.t_valid[t] && a.t_kind[t] == ANTI_REQ;
}

__global__ void arbiter_init_kernel(const ArbiterArgs a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = i0; i < (int64_t)a.N * a.R; i += stride) a.free_[i] = a.free0[i];
  for (int64_t i = i0; i < a.N; i += stride) a.count[i] = a.count0[i];
  for (int64_t i = i0; i < a.TT; i += stride) a.mh[i] = 0;
  if (!a.tables_in_shared) {
    for (int64_t i = i0; i < (int64_t)a.TT * a.V; i += stride) {
      a.ca[i] = 0;
      a.cb[i] = 0;
      a.md[i] = 0;
    }
  }
  if (!a.cs_in_shared) {
    for (int64_t i = i0; i < (int64_t)a.U * a.N; i += stride) a.cs[i] = 0;
  }
  if (a.have_spread) {
    for (int64_t i = i0; i < (int64_t)a.TT * a.U; i += stride) {
      const int t = (int)(i / a.U), u = (int)(i % a.U);
      int32_t g = 0;
      if (is_hard(a, t)) {
        for (int q = 0; q < a.TT; ++q) {
          g += (is_hard(a, q) && a.t_owner[q] == a.t_owner[t] && a.t_topo_slot[q] == a.t_topo_slot[t] &&
                a.m_raw[(int64_t)q * a.U + u]) ? 1 : 0;
        }
      }
      a.gm[i] = g;
    }
  }
}

__global__ void __launch_bounds__(ARB_THREADS) arbiter_scan_kernel(const ArbiterArgs a) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x;
  const int64_t tv = (int64_t)a.TT * a.V;
  int32_t* ca = a.tables_in_shared ? smem : a.ca;
  int32_t* cb = a.tables_in_shared ? smem + tv : a.cb;
  int32_t* md = a.tables_in_shared ? smem + 2 * tv : a.md;
  int32_t* cs = a.cs_in_shared ? smem + 3 * tv : a.cs;
  if (a.tables_in_shared) {
    for (int64_t i = lane; i < 3 * tv; i += ARB_THREADS) smem[i] = 0;
  }
  if (a.cs_in_shared) {
    for (int64_t i = lane; i < (int64_t)a.U * a.N; i += ARB_THREADS) cs[i] = 0;
  }
  __syncwarp();

  for (int rank = 0; rank < a.B; ++rank) {
    const int64_t p = a.order[rank];
    if (!a.pod_valid[p]) {  // V_NOFIT, commits nothing
      if (lane == 0) a.verdict[p] = V_NOFIT;
      continue;
    }
    const int u = a.sig[p];
    const int32_t n = a.assign[p];
    const bool is_m1 = n < 0;
    const int ncl = is_m1 ? 0 : n;

    // PodFitsResources and the pod count against the commits so far
    bool fits = true;
    if (a.req_any[u]) {
      for (int r = lane; r < a.R; r += ARB_THREADS) {
        fits &= a.req[(int64_t)u * a.R + r] <= a.free_[(int64_t)ncl * a.R + r];
      }
    }
    const bool cap_ok = __all_sync(FULL_MASK, fits) && a.count[ncl] + 1 <= a.allowed[ncl];

    bool blocked = false, sp_bad = false, any_pair = false, couldfit = false;
    for (int t = lane; t < a.TT; t += ARB_THREADS) {
      int32_t b;
      const bool hk = dense_bucket(a.label_dense, a.K, ncl, a.t_topo_slot[t], &b);
      const int64_t cell = (int64_t)t * a.V + (b > a.V - 1 ? a.V - 1 : b);  // gathers clamp
      const bool own = a.t_owner[t] == u;
      if (is_anti(a, t) && hk) {
        // my term vs matching commits; committed owners' terms vs me
        if (own && ca[cell] > 0) blocked = true;
        if (a.m_raw[(int64_t)t * a.U + u] && cb[cell] > 0) blocked = true;
      }
      if (a.have_spread && own && is_hard(a, t)) {
        any_pair |= a.any_pair_t[t] != 0;
        int32_t mn = BIG_COUNT;
        for (int v = 0; v < a.V; ++v) {
          const int64_t c = (int64_t)t * a.V + v;
          if (a.merged_present[c]) {
            const int32_t x = a.merged_cnt0[c] + md[c];
            mn = x < mn ? x : mn;
          }
        }
        const int32_t at_b = a.merged_present[cell] ? a.merged_cnt0[cell] + md[cell] : 0;
        if (!(hk && at_b + (a.t_self_match[t] ? 1 : 0) - mn <= a.t_weight[t])) sp_bad = true;
        if (a.mh[t] > 0) couldfit = true;
      }
    }
    for (int w = lane; w < a.U; w += ARB_THREADS) {
      if (a.pconf[(int64_t)u * a.U + w] && cs[(int64_t)w * a.N + ncl] > 0) blocked = true;
    }
    blocked = __any_sync(FULL_MASK, blocked);
    sp_bad = __any_sync(FULL_MASK, sp_bad);
    any_pair = __any_sync(FULL_MASK, any_pair);
    couldfit = __any_sync(FULL_MASK, couldfit);
    const bool ok = cap_ok && !blocked && (!sp_bad || !any_pair);
    if (lane == 0) a.verdict[p] = is_m1 ? (couldfit ? V_DEFER : V_NOFIT) : (ok ? V_PLACE : V_DEFER);
    if (!is_m1 && ok) {  // fold the commit in
      for (int r = lane; r < a.R; r += ARB_THREADS) {
        a.free_[(int64_t)ncl * a.R + r] -= a.req[(int64_t)u * a.R + r];
      }
      if (lane == 0) {
        a.count[ncl] += 1;
        cs[(int64_t)u * a.N + ncl] += 1;
      }
      for (int t = lane; t < a.TT; t += ARB_THREADS) {
        int32_t b;
        const bool hk = dense_bucket(a.label_dense, a.K, ncl, a.t_topo_slot[t], &b);
        const int64_t cell = (int64_t)t * a.V + b;
        if (is_anti(a, t) && hk && b < a.V) {
          if (a.m_raw[(int64_t)t * a.U + u]) ca[cell] += 1;
          if (a.t_owner[t] == u) cb[cell] += 1;
        }
        if (a.have_spread && is_hard(a, t)) {
          if (a.cand[(int64_t)a.t_owner[t] * a.N + ncl]) {
            const int32_t g = a.gm[(int64_t)t * a.U + u];
            if (g > 0 && b < a.V) md[cell] += g;
          }
          if (a.m_raw[(int64_t)t * a.U + u]) a.mh[t] += 1;
        }
      }
    }
    __syncwarp();  // publishes the commit before the next step
  }
}

extern "C" int ktpu_arbitrate(const ArbiterArgs* args, cudaStream_t stream) {
  const ArbiterArgs& a = *args;
  if (a.B <= 0) return (int)cudaGetLastError();
  int rc;
  arbiter_init_kernel<<<264, 256, 0, stream>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  size_t bytes = 0;
  if (a.tables_in_shared) bytes += (size_t)3 * a.TT * a.V * sizeof(int32_t);
  if (a.cs_in_shared) bytes += (size_t)a.U * a.N * sizeof(int32_t);
  if ((rc = set_smem((const void*)arbiter_scan_kernel, bytes))) return rc;
  arbiter_scan_kernel<<<1, ARB_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}
