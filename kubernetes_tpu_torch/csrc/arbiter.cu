// Commit arbiter: the sequential-equivalent verdict pass over a solved batch.
//
// Replaces kubernetes_tpu/commit/arbiter.py:arbitrate (:157) with its
// _spread_tables (:76), and the mesh's shard_map'd scan
// kubernetes_tpu/commit/arbiter.py:_arbiter_body_sharded (:323, run by
// make_sharded_arbiter :484). The reference scans the batch in pop order (a
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
//   2. scan      ONE thread-block cluster of S CTAs of one warp each: S = 1
//                on one device, one CTA a node shard on a mesh (the
//                wrappers refuse S > 16 and any S the card cannot
//                co-schedule). CTA s owns node rows [s * Nl, (s + 1) * Nl)
//                with their residuals and cs columns. Per step each lane
//                takes a strided share of the resource slots, the terms
//                and the spec rows; the verdict is a warp vote (__all_sync /
//                __any_sync). A step whose pod holds a node needs the
//                node's facts — capacity and pod count against the
//                residuals, the host-port test against cs, and per term
//                the bucket, has-key and DoNotSchedule candidate bits —
//                which only the owner CTA holds: it packs them into its
//                shared-memory slot (double buffered), and after one
//                cluster barrier every CTA reads the owner's slot (the
//                reference's one packed pmax a step; with S = 1 the warp
//                reads its own slot after __syncwarp). Each CTA then
//                decides the verdict against its own replica of ca / cb /
//                md / mh and folds a placed pod into it; the owner also
//                folds it into its residuals and cs, and __syncwarp
//                publishes the commit before the next step. Invalid and -1
//                pods need no facts and no barrier (their verdicts read
//                only the replicated mh).
// ca, cb and md ([TT, V] int32 a replica; the reference's ca/cb are f32
// compared > 0) live in shared memory while they fit, a CTA's cs columns
// [U, Nl] too; at the config-4 shapes (TT = 32, V = 2,048) they do not,
// and stay in device memory ([S, TT, V]).
// Reads of a [TT, V] table at a node's bucket clamp to V - 1 (the
// reference's gathers); writes at a bucket >= V are dropped (its
// mode="drop" scatters). The hard-spread metadata (candidate nodes, merged
// counts, presence, whether a term sees any value) comes from
// csrc/topology.cu's spread-tables entry, launched before this one.
//
// Bound: the scan is serial over B pods; per step it reads a few hundred
// bytes (the pod's request row, its terms' buckets and table cells, a cs
// column), far below what its latency chain allows: latency, not bytes or
// operations, sets its time. S > 1 adds a cluster barrier and a remote
// read a step.
#include <cooperative_groups.h>

#include "topology.cuh"

namespace cg = cooperative_groups;

#define ARB_LANES 32
#define LANES_MASK 0xffffffffu

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
  int32_t* ca;                   // [S, TT, V] scratch unless tables_in_shared
  int32_t* cb;                   // [S, TT, V] scratch unless tables_in_shared
  int32_t* cs;                   // [U, N] scratch unless cs_in_shared
  int32_t* md;                   // [S, TT, V] scratch unless tables_in_shared
  int32_t* mh;                   // [S, TT] scratch
  int32_t* gm;                   // [TT, U] scratch
  int32_t* verdict;              // [B] out
  int32_t B, U, N, R, TT, K, V, have_spread, tables_in_shared, cs_in_shared;
};

struct ClusterArbiterArgs {
  ArbiterArgs arb;  // full-width views; free_ / count scratch (each CTA its rows); ca / cb / md / mh a
                    // replica a CTA (ca / cb / md in shared memory when tables_in_shared); cs [U, N]
                    // (shard-local columns; [U, Nl] a CTA in shared memory when cs_in_shared)
  int32_t S, Nl;    // CTAs of the cluster; node rows a CTA, N = S * Nl
};

__device__ __forceinline__ bool is_hard(const ArbiterArgs& a, int t) {
  return a.t_valid[t] && a.t_kind[t] == SPREAD_HARD;
}

__device__ __forceinline__ bool is_anti(const ArbiterArgs& a, int t) {
  return a.t_valid[t] && a.t_kind[t] == ANTI_REQ;
}

// gm[t, u]: for a hard term t, the hard terms of t's (owner, key) group
// whose selector matches spec row u (the reference's f32 product of two
// 0/1 matrices, here an integer count); 0 for any other term
__device__ __forceinline__ int32_t group_match_count(const ArbiterArgs& a, int t, int u) {
  int32_t g = 0;
  if (is_hard(a, t)) {
    for (int q = 0; q < a.TT; ++q) {
      g += (is_hard(a, q) && a.t_owner[q] == a.t_owner[t] && a.t_topo_slot[q] == a.t_topo_slot[t] &&
            a.m_raw[(int64_t)q * a.U + u]) ? 1 : 0;
    }
  }
  return g;
}

__global__ void arbiter_init_kernel(const ClusterArbiterArgs g) {
  const ArbiterArgs& a = g.arb;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = i0; i < (int64_t)a.N * a.R; i += stride) a.free_[i] = a.free0[i];
  for (int64_t i = i0; i < a.N; i += stride) a.count[i] = a.count0[i];
  for (int64_t i = i0; i < (int64_t)g.S * a.TT; i += stride) a.mh[i] = 0;
  if (!a.tables_in_shared) {
    for (int64_t i = i0; i < (int64_t)g.S * a.TT * a.V; i += stride) {
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
      a.gm[i] = group_match_count(a, (int)(i / a.U), (int)(i % a.U));
    }
  }
}

__global__ void __launch_bounds__(ARB_LANES) arbiter_scan_kernel(const ClusterArbiterArgs g) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int32_t smem[];
  const ArbiterArgs& a = g.arb;
  const int shard = (int)cluster.block_rank();
  const int lane = threadIdx.x;
  const int Nl = g.Nl, lo = shard * Nl;
  const int TT = a.TT;
  const int facts = 2 + 3 * TT;  // cap_ok, block_p, hk[TT], bucket[TT], candidate[TT]
  const int64_t tv = (int64_t)TT * a.V;
  int32_t* slots = smem;  // [2][facts]
  int32_t* tables = smem + 2 * facts;
  int32_t* ca = a.tables_in_shared ? tables : a.ca + shard * tv;
  int32_t* cb = a.tables_in_shared ? tables + tv : a.cb + shard * tv;
  int32_t* md = a.tables_in_shared ? tables + 2 * tv : a.md + shard * tv;
  int32_t* mh = a.mh + (int64_t)shard * TT;
  int32_t* cs_local = (a.tables_in_shared ? tables + 3 * tv : tables);  // [U, Nl] when cs_in_shared
  // cs at (spec w, node n) for a node of this shard
  auto cs_at = [&](int w, int n) -> int32_t& {
    return a.cs_in_shared ? cs_local[(int64_t)w * Nl + (n - lo)] : a.cs[(int64_t)w * a.N + n];
  };
  if (a.tables_in_shared) {
    for (int64_t i = lane; i < 3 * tv; i += ARB_LANES) tables[i] = 0;
  }
  if (a.cs_in_shared) {
    for (int64_t i = lane; i < (int64_t)a.U * Nl; i += ARB_LANES) cs_local[i] = 0;
  }
  __syncwarp();
  int buf = 0;

  for (int rank = 0; rank < a.B; ++rank) {
    const int64_t p = a.order[rank];
    if (!a.pod_valid[p]) {  // V_NOFIT, commits nothing
      if (shard == 0 && lane == 0) a.verdict[p] = V_NOFIT;
      continue;
    }
    const int u = a.sig[p];
    const int32_t n = a.assign[p];
    if (n < 0) {  // -1: V_DEFER only when an earlier commit matched one of my hard terms
      bool couldfit = false;
      if (a.have_spread) {
        for (int t = lane; t < TT; t += ARB_LANES) {
          if (a.t_owner[t] == u && is_hard(a, t) && mh[t] > 0) couldfit = true;
        }
      }
      couldfit = __any_sync(LANES_MASK, couldfit);
      if (shard == 0 && lane == 0) a.verdict[p] = couldfit ? V_DEFER : V_NOFIT;
      continue;
    }
    const int owner = n / Nl;
    if (shard == owner) {  // the node's facts, packed into this CTA's slot
      int32_t* f = slots + buf * facts;
      bool fits = true;
      if (a.req_any[u]) {
        for (int r = lane; r < a.R; r += ARB_LANES) {
          fits &= a.req[(int64_t)u * a.R + r] <= a.free_[(int64_t)n * a.R + r];
        }
      }
      const bool cap_ok = __all_sync(LANES_MASK, fits) && a.count[n] + 1 <= a.allowed[n];
      bool clash = false;
      for (int w = lane; w < a.U; w += ARB_LANES) {
        if (a.pconf[(int64_t)u * a.U + w] && cs_at(w, n) > 0) clash = true;
      }
      clash = __any_sync(LANES_MASK, clash);
      for (int t = lane; t < TT; t += ARB_LANES) {
        int32_t b;
        f[2 + t] = dense_bucket(a.label_dense, a.K, n, a.t_topo_slot[t], &b) ? 1 : 0;
        f[2 + TT + t] = b;
        f[2 + 2 * TT + t] = (a.have_spread && a.cand[(int64_t)a.t_owner[t] * a.N + n]) ? 1 : 0;
      }
      if (lane == 0) {
        f[0] = cap_ok ? 1 : 0;
        f[1] = clash ? 1 : 0;
      }
    }
    // the owner's facts are published (one CTA alone needs only its warp)
    if (g.S > 1) {
      cluster.sync();
    } else {
      __syncwarp();
    }
    const int32_t* f = g.S > 1 ? cluster.map_shared_rank(slots + buf * facts, owner) : slots + buf * facts;
    const bool cap_ok = f[0] != 0;
    bool blocked = f[1] != 0, sp_bad = false, any_pair = false;
    for (int t = lane; t < TT; t += ARB_LANES) {
      const bool hk = f[2 + t] != 0;
      const int32_t b = f[2 + TT + t];
      const int64_t cell = (int64_t)t * a.V + (b > a.V - 1 ? a.V - 1 : b);  // gathers clamp
      const bool own = a.t_owner[t] == u;
      if (is_anti(a, t) && hk) {
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
      }
    }
    blocked = __any_sync(LANES_MASK, blocked);
    sp_bad = __any_sync(LANES_MASK, sp_bad);
    any_pair = __any_sync(LANES_MASK, any_pair);
    const bool ok = cap_ok && !blocked && (!sp_bad || !any_pair);
    if (shard == 0 && lane == 0) a.verdict[p] = ok ? V_PLACE : V_DEFER;
    if (ok) {  // fold the commit in: the owner's residuals and cs, every replica's tables
      if (shard == owner) {
        for (int r = lane; r < a.R; r += ARB_LANES) {
          a.free_[(int64_t)n * a.R + r] -= a.req[(int64_t)u * a.R + r];
        }
        if (lane == 0) {
          a.count[n] += 1;
          cs_at(u, n) += 1;
        }
      }
      for (int t = lane; t < TT; t += ARB_LANES) {
        const bool hk = f[2 + t] != 0;
        const int32_t b = f[2 + TT + t];
        const int64_t cell = (int64_t)t * a.V + b;
        if (is_anti(a, t) && hk && b < a.V) {
          if (a.m_raw[(int64_t)t * a.U + u]) ca[cell] += 1;
          if (a.t_owner[t] == u) cb[cell] += 1;
        }
        if (a.have_spread && is_hard(a, t)) {
          if (f[2 + 2 * TT + t]) {
            const int32_t gm = a.gm[(int64_t)t * a.U + u];
            if (gm > 0 && b < a.V) md[cell] += gm;
          }
          if (a.m_raw[(int64_t)t * a.U + u]) mh[t] += 1;
        }
      }
    }
    buf ^= 1;
    __syncwarp();  // publishes the commit before the next step
  }
  cluster.sync();  // no CTA leaves while another may read its slots
}

static size_t arbiter_smem(const ClusterArbiterArgs& g) {
  const ArbiterArgs& a = g.arb;
  size_t bytes = 2 * (2 + 3 * (size_t)a.TT) * sizeof(int32_t);
  if (a.tables_in_shared) bytes += (size_t)3 * a.TT * a.V * sizeof(int32_t);
  if (a.cs_in_shared) bytes += (size_t)a.U * g.Nl * sizeof(int32_t);
  return bytes;
}

static int arbiter_valid(const ClusterArbiterArgs& g) {
  return g.S >= 1 && g.S <= MAX_CLUSTER && g.Nl >= 1 && (int64_t)g.S * g.Nl == g.arb.N;
}

extern "C" int ktpu_arbitrate(const ClusterArbiterArgs* args, cudaStream_t stream) {
  const ClusterArbiterArgs& g = *args;
  if (!arbiter_valid(g)) return (int)cudaErrorInvalidValue;
  if (g.arb.B <= 0) return (int)cudaGetLastError();
  int rc;
  arbiter_init_kernel<<<264, 256, 0, stream>>>(g);
  if ((rc = (int)cudaGetLastError())) return rc;
  return launch_cluster((const void*)arbiter_scan_kernel, g.S, ARB_LANES, arbiter_smem(g), g, stream);
}

// the clusters of the scan's launch the card holds at once (0: none)
extern "C" int ktpu_arbitrate_clusters(const ClusterArbiterArgs* args, int* out) {
  if (!arbiter_valid(*args)) return (int)cudaErrorInvalidValue;
  return cluster_capacity((const void*)arbiter_scan_kernel, args->S, ARB_LANES, arbiter_smem(*args),
                          out);
}
