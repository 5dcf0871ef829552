// Greedy batch solve: the sequential walk the reference's chunked solver
// is bit-identical to, on one device and over a node mesh's shards.
//
// Replaces kubernetes_tpu/ops/solver.py:solve_greedy (with its `inb`
// in-batch anti-affinity / host-port tracking, :175-336) and its
// tie_noise, solve_gang (:365), and the mesh's shard_map'd solve
// kubernetes_tpu/parallel/sharded.py:_solver_body (:51, run by
// make_sharded_pipeline's pipeline :415 and pipeline_gang :435). Pods are
// taken in pop order; each picks the max-(score, noise) feasible node
// against the residuals every earlier pod left, then commits into (free,
// count, nz). solve_greedy's docstring (solver.py:110-126, :144-149)
// proves its chunked prefix-acceptance scan, with or without the pairwise
// commit barrier of the tracking, equals exactly this walk; the sharded
// solve is bit-identical to it by construction.
//
// Design: ONE thread-block cluster of S CTAs (cudaLaunchKernelEx with a
// cluster dimension of S): S = 1 on one device (1024 threads), one CTA a
// node shard on a mesh (512 threads a CTA; S > 8 needs the non-portable
// cluster size, and the wrappers refuse S > 16 and any S the card cannot
// co-schedule). CTA s owns node rows [s * Nl, (s + 1) * Nl) and their
// residuals. Per pod, every thread tests its strided share of its CTA's
// nodes — mask[sig] & (!req_any | req <= free on every slot) & count + 1
// <= allowed — and keeps its best (score, noise, -node); a warp-shuffle +
// shared-memory reduction finds the CTA's best and publishes it in its
// shared memory. After cluster.sync() (a CTA barrier when S = 1: one CTA
// needs no cluster-scope release) warp 0 of every CTA reads the S
// candidates through distributed shared memory (cluster.map_shared_rank)
// and reduces them with the same total order, so every CTA elects the same
// node — the replication the reference's pmax / pmin give — and only the
// owner CTA commits the pod into its residuals. The candidate slots are
// double buffered by valid step, so one cluster barrier a pod suffices: a
// CTA rewrites a slot only after the next barrier, which every reader
// reaches after its reads. Ties go to the lowest node index, as
// jnp.argmax does. The tie-break noise is the reference's counter hash
// (murmur3 fmix32 over (pop rank, node, key)) on global node indices,
// computed inline, so no [B, N] noise tensor exists; its top 24 bits
// compare as integers exactly as the reference's float32 values do.
//
// Tracking (track != 0): per pod of spec s, thread-strided lists in shared
// memory of the anti terms s owns, the anti terms whose selector matches
// s, and the specs whose host ports clash with s's. A node is then also
// infeasible when (A) a term s owns has, in the node's bucket, a commit the
// term matches (ca), (B) a term matching s has, in the node's bucket, a
// commit owning it (cb), or (P) a clashing spec committed on the node
// (cs). Each CTA keeps its own replica of ca / cb ([S, TT, V] int32 in
// device memory, updated identically from the elected node; buckets >= V
// dropped, and a read there sees "not blocked", as the reference's do);
// cs [U, N]'s columns are shard-local and the owner counts the commit.
// The node's bucket is read from the node bank's dense labels at the
// term's key slot, which every CTA addresses on one card (the reference
// broadcasts the winner's from the owner shard with a pmax), so no
// [TT, N] bucket table exists.
//
// Gang mode (gang != 0, no tracking, as the reference's solve_gang has
// none): both passes in one launch — the walk with the first split key on
// a scratch carry (free1 / count1 / nz1, copies of the batch-start
// residuals) into `first`; the group-fail flags, fail[group[p]] = 1 for
// each grouped position pass 1 left at -1 (padding and invalid pods
// included, as the reference's first < 0 does; ungrouped pods never flag);
// alive[p] = pod_valid[p] && !dropped[p]; the walk with the second key on
// the returned carry with alive as pod_valid; then assign = dropped ? -1 :
// second and gang_ok = !dropped. Each CTA keeps its own replica of first,
// fail and alive ([S, B]).
//
// Bound: the walk is serial over B pods (one cluster barrier a step); the
// bytes it must move (mask and score once, the residuals) are far below
// what the CTAs move in that many steps, so latency sets its time.
// Splitting the nodes over S CTAs cuts each step's scan to Nl rows a CTA
// and adds the barrier and the S remote reads.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define SOLO_THREADS 1024  // S = 1: one CTA scans every node
#define SHARD_THREADS 512  // S > 1: a CTA a shard
#define LANES_MASK 0xffffffffu

struct SolveArgs {
  const uint8_t* mask;         // [U, N]
  const int64_t* score;        // [U, N]
  const int64_t* req;          // [U, R]
  const uint8_t* req_any;      // [U]
  const int64_t* scoring_req;  // [U, 2]
  const int64_t* allowed;      // [N]
  const int64_t* order;        // [B] pop order (batch positions)
  const int32_t* sig;          // [B] batch position -> spec row
  const uint8_t* pod_valid;    // [B]
  int64_t* free_;              // [N, R] in/out residuals
  int64_t* count;              // [N] in/out pod counts
  int64_t* nz;                 // [N, 2] in/out non-zero scoring accumulators
  int32_t* assign;             // [B] out: node row or -1
  // in-batch tracking (read only when track != 0)
  const uint8_t* t_anti;       // [TT] valid ANTI_REQ term rows
  const int32_t* t_owner;      // [TT] spec row owning the term
  const int32_t* t_topo_slot;  // [TT]
  const uint8_t* m_bb;         // [TT, U] term matches spec row
  const int32_t* label_dense;  // [N, K]
  const uint8_t* pconf;        // [U, U] spec-pair host-port clash
  int32_t* ca;                 // [S, TT, V] commits the term matches, per bucket (zeroed), a replica a CTA
  int32_t* cb;                 // [S, TT, V] commits owning the term, per bucket (zeroed), a replica a CTA
  int32_t* cs;                 // [U, N] commits per (spec, node) (zeroed)
  int32_t U, N, R, B;
  uint32_t seed;
  int32_t deterministic;
  int32_t track, TT, K, V;
};

struct ClusterSolveArgs {
  SolveArgs walk;         // full-width views (mask / score [U, N], residuals [N, R])
  int32_t S, Nl;          // CTAs of the cluster; node rows a CTA, N = S * Nl
  int32_t gang;           // 1: the two-pass all-or-nothing solve (no tracking)
  const int32_t* group;   // [B] group id in [-1, B)
  int32_t* first;         // [S, B] scratch: pass 1's choices, a replica a CTA
  int32_t* fail;          // [S, B] scratch: group-fail flags (zeroed here)
  uint8_t* alive;         // [S, B] scratch: pass 2's pod_valid
  uint8_t* gang_ok;       // [B] out
  int64_t* free1;         // [N, R] scratch carry of pass 1
  int64_t* count1;        // [N]
  int64_t* nz1;           // [N, 2]
  uint32_t seed1, seed2;  // tie-noise seeds of the two split keys
};

// the dense bucket of node n at a term's key slot (topology._bucket_of),
// or -1 when the node lacks the key or the bucket is at or above V
__device__ __forceinline__ int32_t track_bucket(const SolveArgs& a, int n, int t) {
  const int32_t slot = a.t_topo_slot[t];
  const int sc = slot < 0 ? 0 : (slot > a.K - 1 ? a.K - 1 : slot);
  const int32_t d = a.label_dense[(int64_t)n * a.K + sc];
  return (d >= 0 && slot >= 0 && d < a.V) ? d : -1;
}

// solver.py:tie_noise for (pod rank i, node j): the top 24 bits
__device__ __forceinline__ uint32_t noise24(uint32_t i, uint32_t j, uint32_t seed) {
  uint32_t x = i * 0x9E3779B1u + j * 0x85EBCA77u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >> 8;
}

// is candidate (s1, k1, n1) better than (s0, k0, n0)? n < 0 = none
__device__ __forceinline__ bool better(int64_t s1, uint32_t k1, int32_t n1,
                                       int64_t s0, uint32_t k0, int32_t n0) {
  if (n1 < 0) return false;
  if (n0 < 0) return true;
  if (s1 != s0) return s1 > s0;
  if (k1 != k0) return k1 > k0;
  return n1 < n0;
}

// the best of a warp's candidates, in lane 0
__device__ __forceinline__ void warp_best(int64_t& s, uint32_t& k, int32_t& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t os = __shfl_down_sync(LANES_MASK, s, off);
    const uint32_t ok = __shfl_down_sync(LANES_MASK, k, off);
    const int32_t on = __shfl_down_sync(LANES_MASK, n, off);
    if (better(os, ok, on, s, k, n)) {
      s = os;
      k = ok;
      n = on;
    }
  }
}

// The walk over the B pods in pop order on CTA `shard` of the cluster, run
// by THREADS threads. Rows [shard * Nl, (shard + 1) * Nl) are this CTA's;
// `out` receives each pod's node when `writer`; ca / cb are this CTA's
// replicas. Ends on a cluster barrier, so no CTA leaves while another reads
// its slots.
template <int THREADS>
__device__ __forceinline__ void greedy_walk(const SolveArgs& a, const int shard, const int Nl, int32_t* out,
                                            const bool writer, int32_t* ca, int32_t* cb) {
  constexpr int WARPS = THREADS / 32;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int64_t w_score[WARPS];
  __shared__ uint32_t w_key[WARPS];
  __shared__ int32_t w_node[WARPS];
  __shared__ int64_t e_score[2];  // this CTA's candidate of the step, double buffered
  __shared__ uint32_t e_key[2];
  __shared__ int32_t e_node[2];
  __shared__ int64_t s_req[32];
  __shared__ int n_own, n_match, n_conf;
  extern __shared__ int32_t lists[];  // tracking: [TT] own anti terms, [TT] matching anti terms, [U] clashing specs
  int32_t* own = lists;
  int32_t* match = lists + a.TT;
  int32_t* conf = lists + 2 * a.TT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = a.R;
  const int S = a.N / Nl;
  const int lo = shard * Nl, hi = lo + Nl;
  int buf = 0;
  if (tid == 0) {
    n_own = 0;
    n_match = 0;
    n_conf = 0;
  }
  __syncthreads();

  for (int rank = 0; rank < a.B; ++rank) {
    const int64_t p = a.order[rank];
    if (!a.pod_valid[p]) {  // padding / invalid pods decide -1; every CTA skips them: no barrier
      if (writer && tid == 0) out[p] = -1;
      continue;
    }
    const int s = a.sig[p];
    const bool any_req = a.req_any[s];
    if (tid < R) s_req[tid] = a.req[(int64_t)s * R + tid];
    if (a.track) {  // the counters were reset by thread 0 before the last step's barrier
      for (int t = tid; t < a.TT; t += THREADS) {
        if (!a.t_anti[t]) continue;
        if (a.t_owner[t] == s) own[atomicAdd(&n_own, 1)] = t;
        if (a.m_bb[(int64_t)t * a.U + s]) match[atomicAdd(&n_match, 1)] = t;
      }
      for (int w = tid; w < a.U; w += THREADS) {
        if (a.pconf[(int64_t)s * a.U + w]) conf[atomicAdd(&n_conf, 1)] = w;
      }
    }
    __syncthreads();
    const int no = n_own, nm = n_match, nc = n_conf;

    int64_t best_s = 0;
    uint32_t best_k = 0;
    int32_t best_n = -1;
    const uint8_t* mrow = a.mask + (int64_t)s * a.N;
    const int64_t* srow = a.score + (int64_t)s * a.N;
    for (int n = lo + tid; n < hi; n += THREADS) {
      if (!mrow[n]) continue;
      if (a.count[n] + 1 > a.allowed[n]) continue;
      if (any_req) {
        const int64_t* fr = a.free_ + (int64_t)n * R;
        bool fits = true;
        for (int r = 0; r < R; ++r) fits &= s_req[r] <= fr[r];
        if (!fits) continue;
      }
      if (a.track) {
        bool blocked = false;
        for (int i = 0; i < no && !blocked; ++i) {  // (A) my term vs committed matchers
          const int b = track_bucket(a, n, own[i]);
          blocked = b >= 0 && ca[(int64_t)own[i] * a.V + b] > 0;
        }
        for (int i = 0; i < nm && !blocked; ++i) {  // (B) committed owners vs my labels
          const int b = track_bucket(a, n, match[i]);
          blocked = b >= 0 && cb[(int64_t)match[i] * a.V + b] > 0;
        }
        for (int i = 0; i < nc && !blocked; ++i) {  // (P) a clashing host port on the node
          blocked = a.cs[(int64_t)conf[i] * a.N + n] > 0;
        }
        if (blocked) continue;
      }
      const int64_t sc = srow[n];
      const uint32_t k = a.deterministic ? 0u : noise24((uint32_t)rank, (uint32_t)n, a.seed);
      if (better(sc, k, n, best_s, best_k, best_n)) {
        best_s = sc;
        best_k = k;
        best_n = n;
      }
    }
    warp_best(best_s, best_k, best_n);
    if (lane == 0) {
      w_score[warp] = best_s;
      w_key[warp] = best_k;
      w_node[warp] = best_n;
    }
    __syncthreads();
    if (warp == 0) {
      best_s = lane < WARPS ? w_score[lane] : 0;
      best_k = lane < WARPS ? w_key[lane] : 0u;
      best_n = lane < WARPS ? w_node[lane] : -1;
      warp_best(best_s, best_k, best_n);
      if (lane == 0) {
        e_score[buf] = best_s;
        e_key[buf] = best_k;
        e_node[buf] = best_n;
      }
    }
    // every CTA's candidate is published (one CTA alone needs no
    // cluster-scope barrier, whose release would also wait out its global
    // writes)
    if (S > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    if (warp == 0) {
      // the election: lane r reads CTA r's candidate; the order is total
      // (ties go to the lower node, and each node lives on one CTA), so
      // every CTA elects the same node
      best_s = 0;
      best_k = 0;
      best_n = -1;
      if (lane < S) {
        best_s = S > 1 ? *cluster.map_shared_rank(&e_score[buf], lane) : e_score[buf];
        best_k = S > 1 ? *cluster.map_shared_rank(&e_key[buf], lane) : e_key[buf];
        best_n = S > 1 ? *cluster.map_shared_rank(&e_node[buf], lane) : e_node[buf];
      }
      warp_best(best_s, best_k, best_n);
      if (lane == 0) {
        if (writer) out[p] = best_n;
        if (best_n >= 0) {
          if (best_n >= lo && best_n < hi) {  // the owner commits into its residuals
            int64_t* fr = a.free_ + (int64_t)best_n * R;
            for (int r = 0; r < R; ++r) fr[r] -= s_req[r];
            a.count[best_n] += 1;
            a.nz[(int64_t)best_n * 2 + 0] += a.scoring_req[(int64_t)s * 2 + 0];
            a.nz[(int64_t)best_n * 2 + 1] += a.scoring_req[(int64_t)s * 2 + 1];
            if (a.track) a.cs[(int64_t)s * a.N + best_n] += 1;
          }
          if (a.track) {  // every CTA counts the commit into its replicas
            for (int i = 0; i < nm; ++i) {
              const int b = track_bucket(a, best_n, match[i]);
              if (b >= 0) ca[(int64_t)match[i] * a.V + b] += 1;
            }
            for (int i = 0; i < no; ++i) {
              const int b = track_bucket(a, best_n, own[i]);
              if (b >= 0) cb[(int64_t)own[i] * a.V + b] += 1;
            }
          }
        }
        // every thread is past its node scan: the lists are free for the next pod
        n_own = 0;
        n_match = 0;
        n_conf = 0;
      }
    }
    buf ^= 1;
    // publishes the commit (and frees s_req, the lists and the warp slots)
    __syncthreads();
  }
  cluster.sync();
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS) solve_kernel(const ClusterSolveArgs g) {
  cg::cluster_group cluster = cg::this_cluster();
  const int shard = (int)cluster.block_rank();
  const SolveArgs& a = g.walk;
  const int tid = threadIdx.x;
  const int B = a.B;
  if (!g.gang) {
    const int64_t tv = (int64_t)a.TT * a.V;
    greedy_walk<THREADS>(a, shard, g.Nl, a.assign, shard == 0, a.track ? a.ca + shard * tv : nullptr,
                         a.track ? a.cb + shard * tv : nullptr);
    return;
  }
  // the gang mode, each CTA with its own replica of the choices, flags and alive set
  int32_t* first = g.first + (int64_t)shard * B;
  int32_t* fail = g.fail + (int64_t)shard * B;
  uint8_t* alive = g.alive + (int64_t)shard * B;
  SolveArgs p1 = a;
  p1.free_ = g.free1;
  p1.count = g.count1;
  p1.nz = g.nz1;
  p1.seed = g.seed1;
  for (int p = tid; p < B; p += THREADS) fail[p] = 0;
  greedy_walk<THREADS>(p1, shard, g.Nl, first, true, nullptr, nullptr);
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) {
    const int32_t grp = g.group[p];
    if (grp >= 0 && first[p] < 0) fail[grp] = 1;  // every writer stores 1
  }
  __syncthreads();
  for (int p = tid; p < B; p += THREADS) {
    const int32_t grp = g.group[p];
    const bool dropped = grp >= 0 && fail[grp] != 0;
    alive[p] = (a.pod_valid[p] && !dropped) ? 1 : 0;
    if (shard == 0) g.gang_ok[p] = dropped ? 0 : 1;
  }
  __syncthreads();
  SolveArgs p2 = a;
  p2.pod_valid = alive;
  p2.seed = g.seed2;
  greedy_walk<THREADS>(p2, shard, g.Nl, a.assign, shard == 0, nullptr, nullptr);
  __syncthreads();
  if (shard == 0) {
    for (int p = tid; p < B; p += THREADS) {
      if (!g.gang_ok[p]) a.assign[p] = -1;
    }
  }
}

static int solve_threads(const ClusterSolveArgs& g) { return g.S == 1 ? SOLO_THREADS : SHARD_THREADS; }

static const void* solve_kernel_for(const ClusterSolveArgs& g) {
  return g.S == 1 ? (const void*)solve_kernel<SOLO_THREADS> : (const void*)solve_kernel<SHARD_THREADS>;
}

static size_t solve_smem(const ClusterSolveArgs& g) {
  return g.walk.track ? (2 * (size_t)g.walk.TT + (size_t)g.walk.U) * sizeof(int32_t) : 0;
}

static int solve_valid(const ClusterSolveArgs& g) {
  if (g.S < 1 || g.S > MAX_CLUSTER || g.Nl < 1 || (int64_t)g.S * g.Nl != g.walk.N) return 0;
  return !(g.gang && g.walk.track);  // the gang solve tracks nothing
}

extern "C" int ktpu_solve(const ClusterSolveArgs* args, cudaStream_t stream) {
  const ClusterSolveArgs& g = *args;
  if (!solve_valid(g)) return (int)cudaErrorInvalidValue;
  if (g.walk.B <= 0) return (int)cudaGetLastError();
  return launch_cluster(solve_kernel_for(g), g.S, solve_threads(g), solve_smem(g), g, stream);
}

// the clusters of the solve's launch the card holds at once (0: none)
extern "C" int ktpu_solve_clusters(const ClusterSolveArgs* args, int* out) {
  const ClusterSolveArgs& g = *args;
  if (!solve_valid(g)) return (int)cudaErrorInvalidValue;
  return cluster_capacity(solve_kernel_for(g), g.S, solve_threads(g), solve_smem(g), out);
}
