// Greedy batch solve: the sequential walk the reference's chunked solver
// is bit-identical to.
//
// Replaces kubernetes_tpu/ops/solver.py:solve_greedy (with its `inb`
// in-batch anti-affinity / host-port tracking, :175-336) and its
// tie_noise. Pods are taken in pop order; each picks the max-(score, noise)
// feasible node against the residuals every earlier pod left, then commits
// into (free, count, nz). solve_greedy's docstring (solver.py:110-126,
// :144-149) proves its chunked prefix-acceptance scan, with or without the
// pairwise commit barrier of the tracking, equals exactly this walk.
//
// Design: ONE persistent block of 1024 threads. Per pod, every thread
// tests its strided share of nodes — mask[sig] & (!req_any | req <= free
// on every slot) & count + 1 <= allowed — and keeps its best
// (score, noise, -node); a warp-shuffle + shared-memory reduction finds
// the block's best; thread 0 commits and a barrier publishes the updated
// residuals before the next pod. Ties go to the lowest node index, as
// jnp.argmax does. The tie-break noise is the reference's counter hash
// (murmur3 fmix32 over (pop rank, node, key)), computed inline, so no
// [B, N] noise tensor exists; its top 24 bits compare as integers exactly
// as the reference's float32 values do.
//
// Tracking (track != 0): per pod of spec s, thread-strided lists in shared
// memory of the anti terms s owns, the anti terms whose selector matches
// s, and the specs whose host ports clash with s's. A node is then also
// infeasible when (A) a term s owns has, in the node's bucket, a commit the
// term matches (ca), (B) a term matching s has, in the node's bucket, a
// commit owning it (cb), or (P) a clashing spec committed on the node
// (cs). Thread 0 counts the commit into ca / cb / cs (buckets >= V
// dropped; a read there sees "not blocked", as the reference's do) before
// the step's barrier. ca and cb are [TT, V] int32 in device memory, cs
// [U, N]; the node's bucket is read from the node bank's dense labels at
// the term's key slot, so no [TT, N] bucket table exists.
//
// The walk is a __device__ function: solve_gang_kernel (below) runs it twice.
//
// Bound: the walk is serial over B pods (one barrier-separated step each);
// the bytes it must move (mask and score once, the residuals) are far
// below what a 1024-thread block moves in that many steps.
#include "common.cuh"

#define SOLVE_THREADS 1024
#define NUM_WARPS (SOLVE_THREADS / 32)

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
  int32_t* ca;                 // [TT, V] commits the term matches, per bucket (zeroed)
  int32_t* cb;                 // [TT, V] commits owning the term, per bucket (zeroed)
  int32_t* cs;                 // [U, N] commits per (spec, node) (zeroed)
  int32_t U, N, R, B;
  uint32_t seed;
  int32_t deterministic;
  int32_t track, TT, K, V;
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

// The walk over the B pods in pop order, run by one block of SOLVE_THREADS
// threads. It reads and updates a.free_ / a.count / a.nz in place and
// writes a.assign; it ends with the threads possibly apart (a trailing
// invalid pod has no barrier), so a caller that reads its results syncs.
__device__ __forceinline__ void greedy_walk(const SolveArgs& a) {
  __shared__ int64_t w_score[NUM_WARPS];
  __shared__ uint32_t w_key[NUM_WARPS];
  __shared__ int32_t w_node[NUM_WARPS];
  __shared__ int64_t s_req[32];
  __shared__ int n_own, n_match, n_conf;
  extern __shared__ int32_t lists[];  // tracking: [TT] own anti terms, [TT] matching anti terms, [U] clashing specs
  int32_t* own = lists;
  int32_t* match = lists + a.TT;
  int32_t* conf = lists + 2 * a.TT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = a.R;
  if (tid == 0) {
    n_own = 0;
    n_match = 0;
    n_conf = 0;
  }
  __syncthreads();

  for (int rank = 0; rank < a.B; ++rank) {
    const int64_t p = a.order[rank];
    if (!a.pod_valid[p]) {  // padding / invalid pods decide -1
      if (tid == 0) a.assign[p] = -1;
      continue;
    }
    const int s = a.sig[p];
    const bool any_req = a.req_any[s];
    if (tid < R) s_req[tid] = a.req[(int64_t)s * R + tid];
    if (a.track) {  // the counters were reset by thread 0 before the last step's barrier
      for (int t = tid; t < a.TT; t += SOLVE_THREADS) {
        if (!a.t_anti[t]) continue;
        if (a.t_owner[t] == s) own[atomicAdd(&n_own, 1)] = t;
        if (a.m_bb[(int64_t)t * a.U + s]) match[atomicAdd(&n_match, 1)] = t;
      }
      for (int w = tid; w < a.U; w += SOLVE_THREADS) {
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
    for (int n = tid; n < a.N; n += SOLVE_THREADS) {
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
          blocked = b >= 0 && a.ca[(int64_t)own[i] * a.V + b] > 0;
        }
        for (int i = 0; i < nm && !blocked; ++i) {  // (B) committed owners vs my labels
          const int b = track_bucket(a, n, match[i]);
          blocked = b >= 0 && a.cb[(int64_t)match[i] * a.V + b] > 0;
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
    for (int off = 16; off > 0; off >>= 1) {
      const int64_t os = __shfl_down_sync(0xffffffffu, best_s, off);
      const uint32_t ok = __shfl_down_sync(0xffffffffu, best_k, off);
      const int32_t on = __shfl_down_sync(0xffffffffu, best_n, off);
      if (better(os, ok, on, best_s, best_k, best_n)) {
        best_s = os;
        best_k = ok;
        best_n = on;
      }
    }
    if (lane == 0) {
      w_score[warp] = best_s;
      w_key[warp] = best_k;
      w_node[warp] = best_n;
    }
    __syncthreads();
    if (warp == 0) {
      best_s = w_score[lane];
      best_k = w_key[lane];
      best_n = w_node[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const int64_t os = __shfl_down_sync(0xffffffffu, best_s, off);
        const uint32_t ok = __shfl_down_sync(0xffffffffu, best_k, off);
        const int32_t on = __shfl_down_sync(0xffffffffu, best_n, off);
        if (better(os, ok, on, best_s, best_k, best_n)) {
          best_s = os;
          best_k = ok;
          best_n = on;
        }
      }
      if (lane == 0) {
        a.assign[p] = best_n;
        if (best_n >= 0) {
          int64_t* fr = a.free_ + (int64_t)best_n * R;
          for (int r = 0; r < R; ++r) fr[r] -= s_req[r];
          a.count[best_n] += 1;
          a.nz[(int64_t)best_n * 2 + 0] += a.scoring_req[(int64_t)s * 2 + 0];
          a.nz[(int64_t)best_n * 2 + 1] += a.scoring_req[(int64_t)s * 2 + 1];
          if (a.track) {
            for (int i = 0; i < nm; ++i) {
              const int b = track_bucket(a, best_n, match[i]);
              if (b >= 0) a.ca[(int64_t)match[i] * a.V + b] += 1;
            }
            for (int i = 0; i < no; ++i) {
              const int b = track_bucket(a, best_n, own[i]);
              if (b >= 0) a.cb[(int64_t)own[i] * a.V + b] += 1;
            }
            a.cs[(int64_t)s * a.N + best_n] += 1;
          }
        }
        // every thread is past its node scan: the lists are free for the next pod
        n_own = 0;
        n_match = 0;
        n_conf = 0;
      }
    }
    // publishes the commit (and frees s_req / the warp slots) for the next pod
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SOLVE_THREADS) solve_greedy_kernel(const SolveArgs a) { greedy_walk(a); }

// All-or-nothing gang solve (kubernetes_tpu/ops/solver.py:solve_gang), both
// passes in one launch of one block: the walk with the first split key on
// a scratch carry (free1 / count1 / nz1, copies of the batch-start
// residuals) into `first`; the group-fail flags, fail[group[p]] = 1 for each
// grouped position pass 1 left at -1 (padding and invalid pods included, as
// the reference's first < 0 does; ungrouped pods never flag); alive[p] =
// pod_valid[p] && !dropped[p]; the walk with the second key on the returned
// carry (free / count / nz, also copies of the batch-start residuals) with
// alive as pod_valid; then assign = dropped ? -1 : second and gang_ok =
// !dropped. No in-batch tracking, as the reference's solve_gang has none.
//
// Bound: two serial walks (the solve's bound twice) plus O(B) for the
// flags; the flag passes are strided over the block's 1024 threads.
struct GangArgs {
  SolveArgs walk;        // pass 2's view: carry free_/count/nz, assign = the output
  const int32_t* group;  // [B] group id in [-1, B)
  int32_t* first;        // [B] scratch: pass 1's assignment
  int64_t* free1;        // [N, R] scratch carry of pass 1
  int64_t* count1;       // [N]
  int64_t* nz1;          // [N, 2]
  int32_t* fail;         // [B] scratch: group-fail flags (zeroed here)
  uint8_t* alive;        // [B] scratch: pass 2's pod_valid
  uint8_t* gang_ok;      // [B] out
  uint32_t seed1, seed2; // tie-noise seeds of the two split keys
};

__global__ void __launch_bounds__(SOLVE_THREADS) solve_gang_kernel(const GangArgs g) {
  const int tid = threadIdx.x;
  const int B = g.walk.B;
  SolveArgs p1 = g.walk;
  p1.free_ = g.free1;
  p1.count = g.count1;
  p1.nz = g.nz1;
  p1.assign = g.first;
  p1.seed = g.seed1;
  for (int p = tid; p < B; p += SOLVE_THREADS) g.fail[p] = 0;
  greedy_walk(p1);
  __syncthreads();
  for (int p = tid; p < B; p += SOLVE_THREADS) {
    const int32_t grp = g.group[p];
    if (grp >= 0 && g.first[p] < 0) g.fail[grp] = 1;  // every writer stores 1
  }
  __syncthreads();
  for (int p = tid; p < B; p += SOLVE_THREADS) {
    const int32_t grp = g.group[p];
    const bool dropped = grp >= 0 && g.fail[grp] != 0;
    g.alive[p] = (g.walk.pod_valid[p] && !dropped) ? 1 : 0;
    g.gang_ok[p] = dropped ? 0 : 1;
  }
  __syncthreads();
  SolveArgs p2 = g.walk;
  p2.pod_valid = g.alive;
  p2.seed = g.seed2;
  greedy_walk(p2);
  __syncthreads();
  for (int p = tid; p < B; p += SOLVE_THREADS) {
    if (!g.gang_ok[p]) g.walk.assign[p] = -1;
  }
}

extern "C" int ktpu_solve_greedy(const SolveArgs* args, cudaStream_t stream) {
  if (args->B > 0) {
    const size_t bytes = args->track ? (2 * (size_t)args->TT + (size_t)args->U) * sizeof(int32_t) : 0;
    if (bytes > 48 * 1024) {
      const int rc = (int)cudaFuncSetAttribute((const void*)solve_greedy_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (rc) return rc;
    }
    solve_greedy_kernel<<<1, SOLVE_THREADS, bytes, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int ktpu_solve_gang(const GangArgs* args, cudaStream_t stream) {
  if (args->walk.track) return (int)cudaErrorInvalidValue;  // the gang solve tracks nothing
  if (args->walk.B > 0) solve_gang_kernel<<<1, SOLVE_THREADS, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}
