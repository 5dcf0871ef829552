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
// Design: everything no earlier commit can change is computed before the
// serial scan, across the whole card; the scan keeps only the chain of
// facts that do change.
//   1. init     grid-wide: copy the residuals (free, count) the scan
//               mutates, zero the tables that live in device memory, the
//               V_NOFIT verdicts of invalid pods; per (spec row u, term t)
//               the term's word for u — its row, whether t matches u
//               (m_raw), whether u owns it, anti / hard / self-match /
//               any-pair bits — and gm, the hard terms of t's (owner, key)
//               group matching u (the reference's f32 product of two 0/1
//               matrices, here an integer count), or "irrelevant" when the
//               term can neither block u nor take u's commit
//   2. lists    per spec row: its relevant terms and its port-clashing
//               spec rows, compacted (a warp ballot), and whether any spec
//               row clashes with it (else its cs row is never read and not
//               kept); one more block builds the step list, the valid pods
//               in pop order as (position, spec row, node)
//   3. facts    grid-wide: per placed pod and relevant term, the node's
//               bucket (clamped as the reference's gathers clamp), has-key
//               and DoNotSchedule-candidate bits, one packed word
//   4. scan     ONE thread-block cluster of S CTAs of one warp each: S = 1
//               on one device, one CTA a node shard on a mesh (the
//               wrappers refuse S > 16 and any S the card cannot
//               co-schedule). Per step the lanes read the pod's term words
//               and facts with coalesced loads, prefetched one step ahead
//               with its request row, node limit and clash list; the verdict
//               is a warp vote. The node's residual word (a lane a slot)
//               and pod count are prefetched too, as they stand before the
//               current step's commit, which fixes them up when it lands on
//               the same node; the commit writes them back without a
//               reload. What changes with the commits is the
//               capacity and pod count against the residuals and the
//               host-port clash against cs, which only the node's owner CTA
//               holds: with S = 1 the warp reads them itself (no slot, no
//               barrier); with S > 1 the owner writes the two bits into its
//               shared slot (double buffered) and every CTA reads them
//               after one cluster barrier. Each CTA decides the verdict
//               against its own replica of ca / cb / the merged counts /
//               mh and folds a placed pod into it; the owner also folds it
//               into its residuals and cs, and __syncwarp publishes the
//               commit before the next step. -1 pods need no node and no
//               barrier (their verdicts read only the replicated mh).
// The DoNotSchedule minimum over values is kept per term as it changes,
// not recomputed: the merged count of each value (merged_cnt0 + md, at the
// values present) with the minimum and how many values hold it. Counts only
// grow, so the minimum moves only when the last value holding it grows;
// then the warp recomputes it over V, each lane a strided share. It equals
// the reference's min exactly. md at a value that is not present is never
// read by the reference, so it is not kept.
// ca, cb and the merged counts ([TT, V] int32 a replica; the reference's
// ca/cb are f32 compared > 0) live in shared memory while they fit, a CTA's
// cs columns [U, Nl] too; at the config-4 shapes (TT = 32, V = 2,048) they
// do not, and stay in device memory ([S, TT, V]).
// Reads of a [TT, V] table at a node's bucket clamp to V - 1 (the
// reference's gathers); writes at a bucket >= V are dropped (its
// mode="drop" scatters). The hard-spread metadata (candidate nodes, merged
// counts, presence, whether a term sees any value) comes from
// csrc/topology.cu's spread-tables entry, launched before this one.
//
// Bound: the scan is serial over B pods; per step it reads a few hundred
// bytes (the pod's request row, its terms' words and facts, table cells, a
// cs column), far below what its latency chain allows: latency, not bytes
// or operations, sets its time. S > 1 adds a cluster barrier and a remote
// read a placed step.
#include <cooperative_groups.h>

#include "topology.cuh"

namespace cg = cooperative_groups;

#define ARB_LANES 32
#define LANES_MASK 0xffffffffu

#define V_PLACE 0
#define V_DEFER 1
#define V_NOFIT 2

// a term's word for a spec row (rel): bits 0-15 the term row, then flags
#define W_MATCH (1 << 16)
#define W_OWN (1 << 17)
#define W_ANTI (1 << 18)
#define W_HARD (1 << 19)
#define W_SELF (1 << 20)
#define W_ANYPAIR (1 << 21)
// a fact word: bits 0-28 the bucket (capped at V), then has-key and candidate
#define F_BUCKET 0x1fffffff
#define F_CAND (1 << 29)
#define F_HASKEY (1 << 30)

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
  int32_t* mc;                   // [S, TT, V] scratch unless tables_in_shared: the merged counts
  int32_t* rel;                  // [U, TT] scratch: each spec row's term words (dense, then compacted)
  int32_t* relg;                 // [U, TT] scratch: gm of those terms
  int32_t* rel_n;                // [U] scratch: relevant terms
  int32_t* conf;                 // [U, U] scratch: each spec row's port-clashing spec rows
  int32_t* conf_n;               // [U] scratch
  int32_t* cs_read;              // [U] scratch: some spec row clashes with this one (its cs row is read)
  int32_t* facts;                // [B, TT] scratch: per position, its relevant terms' fact words
  int4* steps;                   // [B] scratch: (position, spec row, node) of the valid pods in pop order
  int32_t* n_steps;              // [1] scratch
  int32_t* verdict;              // [B] out
  int32_t B, U, N, R, TT, K, V, have_spread, tables_in_shared, cs_in_shared;
};

struct ClusterArbiterArgs {
  ArbiterArgs arb;  // full-width views; free_ / count scratch (each CTA its rows); ca / cb / mc a replica
                    // a CTA (in shared memory when tables_in_shared); cs [U, N] (shard-local columns;
                    // [U, Nl] a CTA in shared memory when cs_in_shared)
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
  const int64_t tv = (int64_t)a.TT * a.V;
  for (int64_t i = i0; i < (int64_t)a.N * a.R; i += stride) a.free_[i] = a.free0[i];
  for (int64_t i = i0; i < a.N; i += stride) a.count[i] = a.count0[i];
  for (int64_t i = i0; i < a.B; i += stride) {
    if (!a.pod_valid[i]) a.verdict[i] = V_NOFIT;  // commits nothing
  }
  if (!a.tables_in_shared) {
    for (int64_t i = i0; i < (int64_t)g.S * tv; i += stride) {
      a.ca[i] = 0;
      a.cb[i] = 0;
      if (a.have_spread) a.mc[i] = a.merged_cnt0[i % tv];
    }
  }
  if (!a.cs_in_shared) {
    for (int64_t i = i0; i < (int64_t)a.U * a.N; i += stride) a.cs[i] = 0;
  }
  // the term words, spec row by spec row
  for (int64_t i = i0; i < (int64_t)a.U * a.TT; i += stride) {
    const int u = (int)(i / a.TT), t = (int)(i % a.TT);
    const bool m = a.m_raw[(int64_t)t * a.U + u] != 0;
    const bool own = a.t_owner[t] == u;
    const bool anti = is_anti(a, t);
    const bool hard = a.have_spread && is_hard(a, t);
    const int32_t gm = hard ? group_match_count(a, t, u) : 0;
    const bool relevant = (anti && (m || own)) || (hard && (m || own || gm > 0));
    a.rel[i] = relevant ? (t | (m ? W_MATCH : 0) | (own ? W_OWN : 0) | (anti ? W_ANTI : 0) |
                           (hard ? W_HARD : 0) | (a.t_self_match[t] ? W_SELF : 0) |
                           (hard && a.any_pair_t[t] ? W_ANYPAIR : 0))
                        : -1;
    a.relg[i] = gm;
  }
}

// Blocks [0, U): spec row u's relevant terms and clashing spec rows,
// compacted in place by warps 0 and 1. Block U: the step list.
__global__ void __launch_bounds__(256) arbiter_lists_kernel(const ClusterArbiterArgs g) {
  const ArbiterArgs& a = g.arb;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if ((int)blockIdx.x < a.U) {
    const int u = blockIdx.x;
    if (warp == 0) {  // ascending term rows; the compaction never overtakes its reads
      int32_t* row = a.rel + (int64_t)u * a.TT;
      int32_t* grow = a.relg + (int64_t)u * a.TT;
      int at = 0;
      for (int t0 = 0; t0 < a.TT; t0 += 32) {
        const int t = t0 + lane;
        const int32_t w = t < a.TT ? row[t] : -1;
        const int32_t gm = t < a.TT ? grow[t] : 0;
        const unsigned keep = __ballot_sync(LANES_MASK, w >= 0);
        __syncwarp();
        if (w >= 0) {
          const int k = at + __popc(keep & ((1u << lane) - 1u));
          row[k] = w;
          grow[k] = gm;
        }
        at += __popc(keep);
        __syncwarp();
      }
      if (lane == 0) a.rel_n[u] = at;
    } else if (warp == 1) {
      int32_t* out = a.conf + (int64_t)u * a.U;
      int at = 0;
      for (int w0 = 0; w0 < a.U; w0 += 32) {
        const int w = w0 + lane;
        const bool c = w < a.U && a.pconf[(int64_t)u * a.U + w];
        const unsigned keep = __ballot_sync(LANES_MASK, c);
        if (c) out[at + __popc(keep & ((1u << lane) - 1u))] = w;
        at += __popc(keep);
      }
      if (lane == 0) a.conf_n[u] = at;
    } else if (warp == 2) {
      bool read = false;
      for (int w = lane; w < a.U; w += 32) read |= a.pconf[(int64_t)w * a.U + u] != 0;
      read = __any_sync(LANES_MASK, read);
      if (lane == 0) a.cs_read[u] = read ? 1 : 0;
    }
    return;
  }
  // the step list: a block-wide scan over the pop order
  __shared__ int warp_sum[8];
  const int per = (a.B + 255) / 256;
  const int r0 = min(a.B, (int)threadIdx.x * per), r1 = min(a.B, r0 + per);
  int mine = 0;
  for (int r = r0; r < r1; ++r) mine += a.pod_valid[a.order[r]] ? 1 : 0;
  int x = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(LANES_MASK, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < 8; ++w) {
    before += w < warp ? warp_sum[w] : 0;
    total += warp_sum[w];
  }
  int at = before + x - mine;
  for (int r = r0; r < r1; ++r) {
    const int64_t p = a.order[r];
    if (a.pod_valid[p]) a.steps[at++] = make_int4((int)p, a.sig[p], a.assign[p], 0);
  }
  if (threadIdx.x == 0) *a.n_steps = total;
}

// per placed pod and relevant term: the node's bucket, has-key, candidate bit
__global__ void arbiter_facts_kernel(const ClusterArbiterArgs g) {
  const ArbiterArgs& a = g.arb;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (int64_t)a.B * a.TT; i += stride) {
    const int p = (int)(i / a.TT), k = (int)(i % a.TT);
    if (!a.pod_valid[p]) continue;
    const int n = a.assign[p], u = a.sig[p];
    if (n < 0 || k >= a.rel_n[u]) continue;
    const int t = a.rel[(int64_t)u * a.TT + k] & 0xffff;
    int32_t b;
    const bool hk = dense_bucket(a.label_dense, a.K, n, a.t_topo_slot[t], &b);
    const bool cand = a.have_spread && a.cand[(int64_t)a.t_owner[t] * a.N + n];
    a.facts[i] = (b < a.V ? b : a.V) | (cand ? F_CAND : 0) | (hk ? F_HASKEY : 0);
  }
}

// what the scan reads of a step before its turn: its pod, the first term
// word, gm and fact of each lane, and the first request word, clash row
// and the node's limit; and the node's residual word and pod count as they
// stand before the current step's commit (which fixes them up when it
// lands on the same node)
struct Prefetch {
  int4 st;
  int nrel, ncf;
  int32_t w, gm, f, cf;
  int64_t rq, alw, fr, cnt;
  uint8_t any;
};

__device__ __forceinline__ void prefetch(const ArbiterArgs& a, const int4 st, const int lane, Prefetch& q) {
  const int p = st.x, u = st.y, n = st.z;
  q.st = st;
  q.nrel = a.rel_n[u];
  q.ncf = a.conf_n[u];
  q.w = q.gm = q.f = q.cf = 0;
  q.rq = q.alw = q.fr = q.cnt = 0;
  if (lane < a.TT) {  // loads in flight until the step's turn
    q.w = a.rel[(int64_t)u * a.TT + lane];
    q.gm = a.relg[(int64_t)u * a.TT + lane];
    if (n >= 0) q.f = a.facts[(int64_t)p * a.TT + lane];
  }
  if (lane < a.U) q.cf = a.conf[(int64_t)u * a.U + lane];
  if (lane < a.R) q.rq = a.req[(int64_t)u * a.R + lane];
  if (n >= 0) {
    q.alw = a.allowed[n];
    q.cnt = a.count[n];
    if (lane < a.R) q.fr = a.free_[(int64_t)n * a.R + lane];
  }
  q.any = a.req_any[u];
}

// the warp's minimum of term t's merged counts over the present values, and
// how many values hold it (BIG_COUNT and 0 when none is present)
__device__ __forceinline__ void merged_min(const ArbiterArgs& a, const int32_t* mc, int t, int lane, int32_t* mn,
                                           int32_t* at_min) {
  int32_t m = BIG_COUNT;
  for (int v = lane; v < a.V; v += ARB_LANES) {
    const int64_t c = (int64_t)t * a.V + v;
    if (a.merged_present[c]) m = min(m, mc[c]);
  }
  for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(LANES_MASK, m, off));
  int cnt = 0;
  for (int v = lane; v < a.V; v += ARB_LANES) {
    const int64_t c = (int64_t)t * a.V + v;
    cnt += (a.merged_present[c] && mc[c] == m) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(LANES_MASK, cnt, off);
  *mn = m;
  *at_min = m == BIG_COUNT ? 0 : cnt;
}

__global__ void __launch_bounds__(ARB_LANES) arbiter_scan_kernel(const ClusterArbiterArgs g) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int32_t slot[2];  // S > 1: the owner's capacity and clash bits, double buffered
  const ArbiterArgs& a = g.arb;
  const int shard = (int)cluster.block_rank();
  const int lane = threadIdx.x;
  const int Nl = g.Nl, lo = shard * Nl;
  const int TT = a.TT, V = a.V;
  const int64_t tv = (int64_t)TT * V;
  // shared: the per-term minimum, the values at it, mh; then the tables, then cs
  int32_t* mn = smem;
  int32_t* at_min = mn + TT;
  int32_t* mh = at_min + TT;
  int32_t* tables = mh + TT;
  int32_t* ca = a.tables_in_shared ? tables : a.ca + shard * tv;
  int32_t* cb = a.tables_in_shared ? tables + tv : a.cb + shard * tv;
  int32_t* mc = a.tables_in_shared ? tables + 2 * tv : a.mc + shard * tv;
  int32_t* cs_local = tables + (a.tables_in_shared ? (a.have_spread ? 3 : 2) * tv : 0);  // [U, Nl]
  // cs at (spec w, node n) for a node of this shard
  auto cs_at = [&](int w, int n) -> int32_t& {
    return a.cs_in_shared ? cs_local[(int64_t)w * Nl + (n - lo)] : a.cs[(int64_t)w * a.N + n];
  };
  if (a.tables_in_shared) {
    for (int64_t i = lane; i < 2 * tv; i += ARB_LANES) tables[i] = 0;
    if (a.have_spread) {
      for (int64_t i = lane; i < tv; i += ARB_LANES) mc[i] = a.merged_cnt0[i];
    }
  }
  if (a.cs_in_shared) {
    for (int64_t i = lane; i < (int64_t)a.U * Nl; i += ARB_LANES) cs_local[i] = 0;
  }
  for (int t = lane; t < TT; t += ARB_LANES) mh[t] = 0;
  __syncwarp();
  if (a.have_spread) {
    for (int t = 0; t < TT; ++t) {
      if (!is_hard(a, t)) continue;
      int32_t m, c;
      merged_min(a, mc, t, lane, &m, &c);
      if (lane == 0) {
        mn[t] = m;
        at_min[t] = c;
      }
    }
  }
  __syncwarp();
  const int nsteps = *a.n_steps;
  Prefetch cur, nxt;
  if (nsteps > 0) prefetch(a, a.steps[0], lane, cur);
  int4 st2 = make_int4(0, 0, -1, 0);
  if (nsteps > 1) st2 = a.steps[1];
  int buf = 0;

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) prefetch(a, st2, lane, nxt);
    if (i + 2 < nsteps) st2 = a.steps[i + 2];
    const int p = cur.st.x, u = cur.st.y, n = cur.st.z;
    const int nrel = cur.nrel;
    if (n < 0) {  // -1: V_DEFER only when an earlier commit matched one of my hard terms
      bool couldfit = false;
      for (int k = lane; k < nrel; k += ARB_LANES) {
        const int32_t w = k == lane ? cur.w : a.rel[(int64_t)u * TT + k];
        if ((w & W_OWN) && (w & W_HARD) && mh[w & 0xffff] > 0) couldfit = true;
      }
      couldfit = __any_sync(LANES_MASK, couldfit);
      if (shard == 0 && lane == 0) a.verdict[p] = couldfit ? V_DEFER : V_NOFIT;
      cur = nxt;
      continue;
    }
    // what the commits change: capacity and pod count, the host-port clash
    const int owner = n / Nl;
    bool cap_ok = false, clash = false;
    if (shard == owner) {
      bool fits = true;
      if (cur.any) {
        for (int r = lane; r < a.R; r += ARB_LANES) {
          const int64_t q = r == lane ? cur.rq : a.req[(int64_t)u * a.R + r];
          fits &= q <= (r == lane ? cur.fr : a.free_[(int64_t)n * a.R + r]);
        }
      }
      cap_ok = __all_sync(LANES_MASK, fits) && cur.cnt + 1 <= cur.alw;
      for (int k = lane; k < cur.ncf; k += ARB_LANES) {
        const int w = k == lane ? cur.cf : a.conf[(int64_t)u * a.U + k];
        if (cs_at(w, n) > 0) clash = true;
      }
      clash = __any_sync(LANES_MASK, clash);
      if (g.S > 1 && lane == 0) slot[buf] = (cap_ok ? 1 : 0) | (clash ? 2 : 0);
    }
    if (g.S > 1) {  // the owner's bits are published
      cluster.sync();
      const int32_t bits = *cluster.map_shared_rank(&slot[buf], owner);
      cap_ok = (bits & 1) != 0;
      clash = (bits & 2) != 0;
    }
    bool blocked = clash, sp_bad = false, any_pair = false;
    for (int k = lane; k < nrel; k += ARB_LANES) {
      const int32_t w = k == lane ? cur.w : a.rel[(int64_t)u * TT + k];
      const int32_t f = k == lane ? cur.f : a.facts[(int64_t)p * TT + k];
      const int t = w & 0xffff;
      const bool hk = (f & F_HASKEY) != 0;
      const int32_t b = f & F_BUCKET;
      const int64_t cell = (int64_t)t * V + (b > V - 1 ? V - 1 : b);  // gathers clamp
      if ((w & W_ANTI) && hk) {
        if ((w & W_OWN) && ca[cell] > 0) blocked = true;
        if ((w & W_MATCH) && cb[cell] > 0) blocked = true;
      }
      if ((w & W_HARD) && (w & W_OWN)) {
        any_pair |= (w & W_ANYPAIR) != 0;
        const int32_t at_b = a.merged_present[cell] ? mc[cell] : 0;
        if (!(hk && at_b + ((w & W_SELF) ? 1 : 0) - mn[t] <= a.t_weight[t])) sp_bad = true;
      }
    }
    blocked = __any_sync(LANES_MASK, blocked);
    sp_bad = __any_sync(LANES_MASK, sp_bad);
    any_pair = __any_sync(LANES_MASK, any_pair);
    const bool ok = cap_ok && !blocked && (!sp_bad || !any_pair);
    if (shard == 0 && lane == 0) a.verdict[p] = ok ? V_PLACE : V_DEFER;
    if (ok) {  // fold the commit in: the owner's residuals and cs, every replica's tables
      if (shard == owner) {
        // the residual word and count as prefetched (and fixed up): no reload
        if (lane < a.R) a.free_[(int64_t)n * a.R + lane] = cur.fr - cur.rq;
        for (int r = lane + ARB_LANES; r < a.R; r += ARB_LANES) {
          a.free_[(int64_t)n * a.R + r] -= a.req[(int64_t)u * a.R + r];
        }
        if (lane == 0) {
          a.count[n] = cur.cnt + 1;
          if (a.cs_read[u]) cs_at(u, n) += 1;  // no spec row reads an unclashing row's cs
        }
        if (i + 1 < nsteps && nxt.st.z == n) {  // the next step's node: its prefetched state moved
          nxt.fr -= lane < a.R ? cur.rq : 0;
          nxt.cnt += 1;
        }
      }
      for (int k0 = 0; k0 < nrel; k0 += ARB_LANES) {  // 32 terms at a time: one term a lane
        const int k = k0 + lane;
        bool recompute = false;
        int t = 0;
        if (k < nrel) {
          const int32_t w = k == lane ? cur.w : a.rel[(int64_t)u * TT + k];
          const int32_t f = k == lane ? cur.f : a.facts[(int64_t)p * TT + k];
          const int32_t gm = k == lane ? cur.gm : a.relg[(int64_t)u * TT + k];
          t = w & 0xffff;
          const int32_t b = f & F_BUCKET;
          const int64_t cell = (int64_t)t * V + b;
          if ((w & W_ANTI) && (f & F_HASKEY) && b < V) {
            if (w & W_MATCH) ca[cell] += 1;
            if (w & W_OWN) cb[cell] += 1;
          }
          if (w & W_HARD) {
            if ((f & F_CAND) && gm > 0 && b < V && a.merged_present[cell]) {
              const int32_t old = mc[cell];
              mc[cell] = old + gm;
              // the last value at the minimum grew: the minimum moves
              recompute = old == mn[t] && --at_min[t] == 0;
            }
            if (w & W_MATCH) mh[t] += 1;
          }
        }
        unsigned todo = __ballot_sync(LANES_MASK, recompute);
        if (todo) {
          __syncwarp();  // the merged counts are in
          for (; todo; todo &= todo - 1) {
            const int tr = __shfl_sync(LANES_MASK, t, __ffs(todo) - 1);
            int32_t m, c;
            merged_min(a, mc, tr, lane, &m, &c);
            if (lane == 0) {
              mn[tr] = m;
              at_min[tr] = c;
            }
          }
        }
      }
    }
    buf ^= 1;
    cur = nxt;
    __syncwarp();  // publishes the commit before the next step
  }
  if (g.S > 1) cluster.sync();  // no CTA leaves while another may read its slots
}

static size_t arbiter_smem(const ClusterArbiterArgs& g) {
  const ArbiterArgs& a = g.arb;
  size_t bytes = 3 * (size_t)a.TT * sizeof(int32_t);
  if (a.tables_in_shared) bytes += (size_t)(a.have_spread ? 3 : 2) * a.TT * a.V * sizeof(int32_t);
  if (a.cs_in_shared) bytes += (size_t)a.U * g.Nl * sizeof(int32_t);
  return bytes;
}

static int arbiter_valid(const ClusterArbiterArgs& g) {
  return g.S >= 1 && g.S <= MAX_CLUSTER && g.Nl >= 1 && (int64_t)g.S * g.Nl == g.arb.N && g.arb.TT <= 0xffff;
}

extern "C" int ktpu_arbitrate(const ClusterArbiterArgs* args, cudaStream_t stream) {
  const ClusterArbiterArgs& g = *args;
  if (!arbiter_valid(g)) return (int)cudaErrorInvalidValue;
  if (g.arb.B <= 0) return (int)cudaGetLastError();
  int rc;
  arbiter_init_kernel<<<264, 256, 0, stream>>>(g);
  if ((rc = (int)cudaGetLastError())) return rc;
  arbiter_lists_kernel<<<g.arb.U + 1, 256, 0, stream>>>(g);
  if ((rc = (int)cudaGetLastError())) return rc;
  arbiter_facts_kernel<<<264, 256, 0, stream>>>(g);
  if ((rc = (int)cudaGetLastError())) return rc;
  return launch_cluster((const void*)arbiter_scan_kernel, g.S, ARB_LANES, arbiter_smem(g), g, stream);
}

// the clusters of the scan's launch the card holds at once (0: none)
extern "C" int ktpu_arbitrate_clusters(const ClusterArbiterArgs* args, int* out) {
  if (!arbiter_valid(*args)) return (int)cudaErrorInvalidValue;
  return cluster_capacity((const void*)arbiter_scan_kernel, args->S, ARB_LANES, arbiter_smem(*args),
                          out);
}
