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
// Design: ONE thread-block cluster of S CTAs of 512 threads
// (cudaLaunchKernelEx with a cluster dimension of S; S > 8 needs the
// non-portable cluster size, and the wrappers refuse S > 16 and any S the
// card cannot co-schedule). One device runs as a cluster too (the wrapper
// fixes its S); a mesh runs one CTA a node shard. CTA s owns node rows
// [s * Nl, (s + 1) * Nl), Nl = ceil(N / S): rows at or past N are padding
// that never passes the test. Within a CTA, thread t owns the rows
// t, t + 512, ...: it alone tests them and commits into their residuals,
// so a commit needs no barrier before the next pod's test.
//
//   * Resident state (`resident`): the CTA's residuals live in its shared
//     memory for the whole walk — free slot-major [R, Nl] (a warp's loads
//     are consecutive words), count and the nz accumulators, and per row the
//     pods it still takes (allowed - count, capped at 2^31 - 1: exact for
//     any batch) and a bit a slot whose residual is negative — loaded
//     once with coalesced copies and written back once at exit. The test
//     reads only the slots the pod asks for; a slot it does not ask for
//     fits unless its bit is set. Each
//     thread keeps its rows' mask and score entries of the current spec in
//     registers (at most 4 rows a thread); the NEXT valid pod's spec row
//     is loaded while the current pod is tested and elected (a run of pods
//     of one spec, a replica set, loads nothing), as are its request row
//     and scoring requests, into a triple-buffered shared slot. The test is
//     branch-free over registers and shared memory; the tie-break noise is
//     computed inline. The pods' choices collect in shared memory and are
//     written out at exit, so the walk writes no device memory at all.
//   * Device-memory state (a CTA whose residuals do not fit its shared
//     memory, or more than 4 rows a thread): the same walk with the
//     residuals updated in place in device memory and the rows read there
//     each pod; counted by the wrapper.
//
// The valid pods in pop order are compacted into a step list first (a
// block-wide scan over pod_valid), so invalid and padding pods cost no
// step. Per pod: each thread's best (score, noise, -node) over its rows,
// a warp reduction (four redux.sync: the score's two words, the noise, the
// node), ONE CTA barrier, then the election:
//   * S = 1: every warp reduces the warp candidates itself;
//   * S > 1: warp 0 reduces the CTA's candidate; its lane 0 arrives on
//     this CTA's mbarrier expecting S candidates' bytes, and lane d stores
//     the candidate into CTA d's slot with st.async, completing those bytes
//     on CTA d's mbarrier; each CTA waits on its own mbarrier's phase and
//     every warp reduces the S candidates from local shared memory. (This
//     election beat a remote-arrive mbarrier and a full cluster barrier on
//     the card; PERF.md records the measurement.)
// Every CTA reduces the same S candidates under one total order (ties go
// to the lowest node index, as jnp.argmax does), so every CTA elects the
// same node — the replication the reference's pmax / pmin give — and only
// the owner thread commits. The candidate slots and mbarriers are double
// buffered by step: a CTA pushes into another's slot of step i + 2 only
// after its own wait of step i + 1, which needs that CTA's push of step
// i + 1, which follows its reads of step i. The tie-break noise is the
// reference's counter hash (murmur3 fmix32 over (pop rank, node, key)) on
// global node indices, computed inline; its top 24 bits compare as
// integers exactly as the reference's float32 values do.
//
// Tracking (track != 0): per pod of spec s, thread-strided lists in shared
// memory of the anti terms s owns, the anti terms whose selector matches
// s, and the specs whose host ports clash with s's. A node is then also
// infeasible when (A) a term s owns has, in the node's bucket, a commit the
// term matches (ca), (B) a term matching s has, in the node's bucket, a
// commit owning it (cb), or (P) a clashing spec committed on the node
// (cs). Each CTA keeps its own replica of ca / cb ([TT, V] int32, in its
// shared memory where both fit, else [S, TT, V] in device memory), updated
// identically from the elected node; buckets >= V dropped, and a read
// there sees "not blocked", as the reference's do; cs [U, N]'s columns are
// touched only by their owner thread. The node's bucket is read from the
// node bank's dense labels at the term's key slot. The lists and the
// replicated tables cost two more CTA barriers a pod.
//
// Gang mode (gang != 0, no tracking, as the reference's solve_gang has
// none): both passes in one launch — the walk with the first split key
// from the batch-start residuals into `first` (resident: in shared memory,
// nothing written back; device memory: on the scratch carry free1 /
// count1 / nz1); the group-fail flags, fail[group[p]] = 1 for each grouped
// position pass 1 left at -1 (padding and invalid pods included, as the
// reference's first < 0 does; ungrouped pods never flag); alive[p] =
// pod_valid[p] && !dropped[p]; the walk with the second key from the same
// batch-start residuals with alive as pod_valid; assign = -1 where
// dropped and gang_ok = !dropped. Each CTA keeps its own replica of first,
// fail and alive ([S, B]).
//
// Bound: the walk is serial over B pods; the bytes it must move (mask and
// score once, the residuals) are far below what its per-pod chain of one
// CTA barrier, one election and one commit allows: latency, not bytes or
// operations, sets its time.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define SOLVE_THREADS 512
#define SOLVE_WARPS (SOLVE_THREADS / 32)
#define MAX_ROWS_PER_THREAD 4  // the resident walk's rows a thread (Nl <= 2,048)
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
  int32_t* ca;                 // [S, TT, V] commits the term matches, per bucket (zeroed) unless track_shared
  int32_t* cb;                 // [S, TT, V] commits owning the term, per bucket (zeroed) unless track_shared
  int32_t* cs;                 // [U, N] commits per (spec, node) (zeroed)
  int32_t U, N, R, B;
  uint32_t seed;
  int32_t deterministic;
  int32_t track, TT, K, V;
};

struct ClusterSolveArgs {
  SolveArgs walk;         // full-width views (mask / score [U, N], residuals [N, R])
  int32_t S, Nl;          // CTAs of the cluster; node rows a CTA, Nl = ceil(N / S)
  int32_t gang;           // 1: the two-pass all-or-nothing solve (no tracking)
  const int32_t* group;   // [B] group id in [-1, B)
  int32_t* first;         // [S, B] scratch: pass 1's choices, a replica a CTA
  int32_t* fail;          // [S, B] scratch: group-fail flags (zeroed here)
  uint8_t* alive;         // [S, B] scratch: pass 2's pod_valid
  uint8_t* gang_ok;       // [B] out
  int64_t* free1;         // [N, R] scratch carry of pass 1 (device-memory state only)
  int64_t* count1;        // [N]
  int64_t* nz1;           // [N, 2]
  uint32_t seed1, seed2;  // tie-noise seeds of the two split keys
  int32_t resident;       // 1: the residuals in shared memory (see solve_smem)
  int32_t track_shared;   // tracking: ca / cb replicas in shared memory
  int4* steps;            // [S, B] scratch: (rank, position, spec row) of the valid pods in pop order
  int32_t* sel;           // [S, B] scratch: the choices by step (device-memory state only)
};

struct __align__(16) Cand {
  int64_t s;   // score
  uint32_t k;  // tie-break noise (top 24 bits)
  int32_t n;   // node row, -1 = none
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

// the best of a warp's candidates, in every lane: the lexicographic
// maximum of (score, noise, -node), n < 0 = none, in four warp reductions
// (redux.sync): the score's high word (signed), its low word (unsigned)
// among the lanes at that high word, the noise among the lanes at the
// maximum score, then the lowest node among those at the maximum noise.
// A none lane counts as the lowest score with noise 0 and never wins the
// node stage, where a real node always bids a positive word.
__device__ __forceinline__ void warp_best(Cand& c) {
  const bool real = c.n >= 0;
  const int32_t hi = real ? (int32_t)(c.s >> 32) : INT32_MIN;
  const uint32_t lo = real ? (uint32_t)c.s : 0u;
  const uint32_t k = real ? c.k : 0u;
  const int32_t m_hi = __reduce_max_sync(LANES_MASK, hi);
  const uint32_t m_lo = __reduce_max_sync(LANES_MASK, hi == m_hi ? lo : 0u);
  const bool at_s = hi == m_hi && lo == m_lo;
  const uint32_t m_k = __reduce_max_sync(LANES_MASK, at_s ? k : 0u);
  const uint32_t bid = (real && at_s && k == m_k) ? 0xFFFFFFFFu - (uint32_t)c.n : 0u;
  const uint32_t m_bid = __reduce_max_sync(LANES_MASK, bid);
  c.s = (int64_t)(((uint64_t)(uint32_t)m_hi << 32) | m_lo);
  c.k = m_k;
  c.n = m_bid == 0u ? -1 : (int32_t)(0xFFFFFFFFu - m_bid);
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

// --- mbarriers across the cluster (PTX; sm_90) -------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// arrive on this CTA's `bar` expecting `bytes` of st.async data this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// store a candidate into CTA `rank`'s copy of `slot`, completing its bytes
// on that CTA's copy of `bar` (no release fence: the phase's completion
// makes the data visible)
__device__ __forceinline__ void cand_store_async(Cand* slot, const Cand& c, uint64_t* bar, uint32_t rank) {
  uint32_t rslot, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rslot) : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(rbar) : "r"(smem_u32(bar)), "r"(rank));
  const uint64_t s = (uint64_t)c.s;
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(rslot),
      "r"((uint32_t)s), "r"((uint32_t)(s >> 32)), "r"(c.k), "r"((uint32_t)c.n), "r"(rbar)
      : "memory");
}

// wait (acquire at cluster scope) until the phase of this parity completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- the walk ----------------------------------------------------------------

// What one CTA of the walk shares between its passes.
struct Walk {
  cg::cluster_group cluster;
  int shard, S, Nl, lo;     // this CTA, the cluster size, its rows [lo, lo + Nl)
  uint32_t step;            // election steps taken so far (the mbarrier phases)
  int64_t* free_s;          // resident: [R, Nl] slot-major
  int64_t* cnt_s;           // resident: [Nl] pod counts (written back)
  int32_t* slack_s;         // resident: [Nl] pods a row still takes, allowed - count (capped)
  int32_t* neg_s;           // resident: [Nl] bit r: free[r] < 0
  int64_t* nz_s;            // resident: [2, Nl]
  int32_t* sel;             // [B] the choices by step (shared when resident)
  int32_t* lists;           // tracking: [TT] own, [TT] matching, [U] clashing
  int32_t* ca;              // tracking: this CTA's replicas
  int32_t* cb;
  Cand* e;                  // [2][MAX_CLUSTER] election slots
  uint64_t* bars;           // [2] election mbarriers
};

// The valid pods of `valid` in pop order, as (rank, position, spec row),
// into `steps`; -1 into out[p] for every other position when `writer`.
// Returns their count (in every thread); ends on a CTA barrier.
__device__ int build_steps(const SolveArgs& a, const uint8_t* valid, int4* steps, int32_t* out, bool writer) {
  __shared__ int warp_sum[SOLVE_WARPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (a.B + SOLVE_THREADS - 1) / SOLVE_THREADS;
  const int r0 = min(a.B, tid * per), r1 = min(a.B, r0 + per);
  int mine = 0;
  for (int r = r0; r < r1; ++r) {
    const int64_t p = a.order[r];
    if (valid[p]) {
      ++mine;
    } else if (writer) {
      out[p] = -1;
    }
  }
  int x = mine;  // inclusive scan over the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(LANES_MASK, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < SOLVE_WARPS; ++w) {
    const int v = warp_sum[w];
    before += w < warp ? v : 0;
    total += v;
  }
  int at = before + x - mine;
  for (int r = r0; r < r1; ++r) {
    const int64_t p = a.order[r];
    if (valid[p]) steps[at++] = make_int4(r, (int)p, a.sig[p], 0);
  }
  __syncthreads();  // the list is complete, warp_sum free
  return total;
}

// Load (RESIDENT) the batch-start residuals of this CTA's rows from the
// carry into shared memory.
__device__ void load_state(const SolveArgs& a, const Walk& w) {
  const int R = a.R, Nl = w.Nl;
  for (int i = threadIdx.x; i < Nl * R; i += SOLVE_THREADS) {
    const int j = i / R, r = i % R;
    const int n = w.lo + j;
    w.free_s[(int64_t)r * Nl + j] = n < a.N ? a.free_[(int64_t)n * R + r] : 0;
  }
  for (int j = threadIdx.x; j < Nl; j += SOLVE_THREADS) {
    const int n = w.lo + j;
    const int64_t cnt = n < a.N ? a.count[n] : 0, alw = n < a.N ? a.allowed[n] : 0;
    w.cnt_s[j] = cnt;
    // count + 1 <= allowed  <=>  slack >= 1; capped at 2^31 - 1 it stays
    // exact for fewer than 2^31 - 2 commits a row (a batch has fewer pods)
    const uint64_t d = (uint64_t)alw - (uint64_t)cnt;  // exact when alw > cnt
    w.slack_s[j] = alw > cnt ? (int32_t)(d < 0x7fffffffull ? d : 0x7fffffffull) : 0;
    uint32_t neg = 0;
    for (int r = 0; r < R; ++r) neg |= (n < a.N && a.free_[(int64_t)n * R + r] < 0) ? 1u << r : 0u;
    w.neg_s[j] = (int32_t)neg;
    w.nz_s[j] = n < a.N ? a.nz[(int64_t)n * 2] : 0;
    w.nz_s[Nl + j] = n < a.N ? a.nz[(int64_t)n * 2 + 1] : 0;
  }
}

// Write (RESIDENT) this CTA's residuals back into the carry.
__device__ void store_state(const SolveArgs& a, const Walk& w) {
  const int R = a.R, Nl = w.Nl;
  for (int i = threadIdx.x; i < Nl * R; i += SOLVE_THREADS) {
    const int j = i / R, r = i % R;
    const int n = w.lo + j;
    if (n < a.N) a.free_[(int64_t)n * R + r] = w.free_s[(int64_t)r * Nl + j];
  }
  for (int j = threadIdx.x; j < Nl; j += SOLVE_THREADS) {
    const int n = w.lo + j;
    if (n < a.N) {
      a.count[n] = w.cnt_s[j];
      a.nz[(int64_t)n * 2] = w.nz_s[j];
      a.nz[(int64_t)n * 2 + 1] = w.nz_s[Nl + j];
    }
  }
}

// The walk over the `nsteps` valid pods of `steps` on this CTA. RESIDENT:
// the residuals in shared memory (w.free_s ...); else in place in a's
// device arrays. The choices go to w.sel by step; `nz_on` accumulates nz.
template <bool RESIDENT>
__device__ void greedy_walk(const SolveArgs& a, Walk& w, const int4* steps, const int nsteps, const bool nz_on) {
  __shared__ Cand wslot[2][SOLVE_WARPS];            // warp candidates, double buffered
  __shared__ int64_t s_req[3][32];                  // the request row of steps i, i + 1, i + 2
  __shared__ int64_t s_sreq[3][2];                  // scoring requests
  __shared__ uint8_t s_any[3];                      // req_any
  __shared__ uint32_t s_nzm[3];                     // the request row's nonzero slots
  __shared__ int n_own, n_match, n_conf;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int R = a.R, N = a.N, Nl = w.Nl, lo = w.lo;
  const int hi = min(lo + Nl, N);  // this CTA's real rows end here
  int32_t* own = w.lists;
  int32_t* match = w.lists + a.TT;
  int32_t* conf = w.lists + 2 * a.TT;
  if (nsteps <= 0) return;

  // the current step's spec row of this thread's rows (resident walk)
  uint32_t cm[MAX_ROWS_PER_THREAD];
  int64_t cs[MAX_ROWS_PER_THREAD];
  uint32_t nm[MAX_ROWS_PER_THREAD];
  int64_t ns[MAX_ROWS_PER_THREAD];
  int4 cur = steps[0];
  int4 nxt = nsteps > 1 ? steps[1] : make_int4(0, 0, -1, 0);
  if (RESIDENT) {
#pragma unroll
    for (int k = 0; k < MAX_ROWS_PER_THREAD; ++k) {
      const int n = lo + tid + k * SOLVE_THREADS;
      const bool in = n < hi;
      cm[k] = in ? a.mask[(int64_t)cur.z * N + n] : 0u;
      cs[k] = in ? a.score[(int64_t)cur.z * N + n] : 0;
      nm[k] = 0u;
      ns[k] = 0;
    }
  }
  if (tid < R) s_req[0][tid] = a.req[(int64_t)cur.z * R + tid];
  if (warp == 0) {
    const unsigned nzm = __ballot_sync(LANES_MASK, tid < R && a.req[(int64_t)cur.z * R + tid] != 0);
    if (lane == 0) s_nzm[0] = nzm;
  }
  if (tid == 32) s_any[0] = a.req_any[cur.z];
  if (tid == 33 || tid == 34) s_sreq[0][tid - 33] = a.scoring_req[(int64_t)cur.z * 2 + tid - 33];
  if (tid == 0) {
    n_own = 0;
    n_match = 0;
    n_conf = 0;
  }
  __syncthreads();

  int b3 = 0;  // the request slot of this step
  for (int i = 0; i < nsteps; ++i) {
    const int s = cur.z;
    const bool has_next = i + 1 < nsteps;
    int4 nxt2 = make_int4(0, 0, -1, 0);
    if (i + 2 < nsteps) nxt2 = steps[i + 2];
    // prefetch: the next step's spec row (a new spec only) and request row
    const bool new_row = has_next && nxt.z != s;
    if (RESIDENT && new_row) {
#pragma unroll
      for (int k = 0; k < MAX_ROWS_PER_THREAD; ++k) {
        const int n = lo + tid + k * SOLVE_THREADS;
        nm[k] = 0u;
        ns[k] = 0;
        if (n < hi) {  // loads in flight until the next step's test
          nm[k] = a.mask[(int64_t)nxt.z * N + n];
          ns[k] = a.score[(int64_t)nxt.z * N + n];
        }
      }
    }
    int64_t pre = 0;
    if (has_next) {
      if (tid < R) pre = a.req[(int64_t)nxt.z * R + tid];
      if (tid == 32) pre = a.req_any[nxt.z];
      if (tid == 33 || tid == 34) pre = a.scoring_req[(int64_t)nxt.z * 2 + tid - 33];
    }
    int no = 0, nmt = 0, nc = 0;
    if (a.track) {  // the pod's term and clash lists
      for (int t = tid; t < a.TT; t += SOLVE_THREADS) {
        if (!a.t_anti[t]) continue;
        if (a.t_owner[t] == s) own[atomicAdd(&n_own, 1)] = t;
        if (a.m_bb[(int64_t)t * a.U + s]) match[atomicAdd(&n_match, 1)] = t;
      }
      for (int u = tid; u < a.U; u += SOLVE_THREADS) {
        if (a.pconf[(int64_t)s * a.U + u]) conf[atomicAdd(&n_conf, 1)] = u;
      }
      __syncthreads();
      no = n_own;
      nmt = n_match;
      nc = n_conf;
    }
    const int64_t* req = s_req[b3];
    const bool any_req = s_any[b3] != 0;
    // the slots the pod asks for (their residuals are read) and the others
    // (they fit unless their residual is negative: one bit each)
    const uint32_t nzm = s_nzm[b3];
    const uint32_t zm = (R == 32 ? 0xffffffffu : (1u << R) - 1u) & ~nzm;
    const uint32_t rank = (uint32_t)cur.x;

    // this thread's best row
    Cand best{0, 0u, -1};
    auto consider = [&](const int n, const int j, const bool m, const int64_t sc) {
      bool ok = m;
      if (RESIDENT) {
        ok &= w.slack_s[j] >= 1;
        if (any_req) {
          ok &= ((uint32_t)w.neg_s[j] & zm) == 0u;
          for (uint32_t m = nzm; m; m &= m - 1u) {
            const int r = __ffs(m) - 1;
            ok &= req[r] <= w.free_s[(int64_t)r * Nl + j];
          }
        }
      } else {
        ok = ok && a.count[n] + 1 <= a.allowed[n];
        if (ok && any_req) {
          const int64_t* fr = a.free_ + (int64_t)n * R;
          for (int r = 0; r < R; ++r) ok &= req[r] <= fr[r];
        }
      }
      if (ok && a.track) {
        bool blocked = false;
        for (int q = 0; q < no && !blocked; ++q) {  // (A) my term vs committed matchers
          const int b = track_bucket(a, n, own[q]);
          blocked = b >= 0 && w.ca[(int64_t)own[q] * a.V + b] > 0;
        }
        for (int q = 0; q < nmt && !blocked; ++q) {  // (B) committed owners vs my labels
          const int b = track_bucket(a, n, match[q]);
          blocked = b >= 0 && w.cb[(int64_t)match[q] * a.V + b] > 0;
        }
        for (int q = 0; q < nc && !blocked; ++q) {  // (P) a clashing host port on the node
          blocked = a.cs[(int64_t)conf[q] * N + n] > 0;
        }
        ok = !blocked;
      }
      if (ok) {
        const uint32_t k = a.deterministic ? 0u : noise24(rank, (uint32_t)n, a.seed);
        if (better(sc, k, n, best.s, best.k, best.n)) {
          best.s = sc;
          best.k = k;
          best.n = n;
        }
      }
    };
    if (RESIDENT) {
#pragma unroll
      for (int k = 0; k < MAX_ROWS_PER_THREAD; ++k) {
        const int j = tid + k * SOLVE_THREADS;
        if (lo + j < hi) consider(lo + j, j, cm[k] != 0, cs[k]);
      }
    } else {
      const uint8_t* mrow = a.mask + (int64_t)s * N;
      const int64_t* srow = a.score + (int64_t)s * N;
      for (int n = lo + tid; n < hi; n += SOLVE_THREADS) {
        if (mrow[n]) consider(n, n - lo, true, srow[n]);
      }
    }
    // the prefetched request row lands in the slot of step i + 1
    if (has_next) {
      const int nb = b3 == 2 ? 0 : b3 + 1;
      if (tid < R) s_req[nb][tid] = pre;
      if (warp == 0) {
        const unsigned nzm_next = __ballot_sync(LANES_MASK, tid < R && pre != 0);
        if (lane == 0) s_nzm[nb] = nzm_next;
      }
      if (tid == 32) s_any[nb] = (uint8_t)pre;
      if (tid == 33 || tid == 34) s_sreq[nb][tid - 33] = pre;
    }
    warp_best(best);
    const int wb = w.step & 1;
    if (lane == 0) wslot[wb][warp] = best;
    __syncthreads();  // every warp's candidate is in

    // the election
    Cand c{0, 0u, -1};
    if (w.S == 1) {
      if (lane < SOLVE_WARPS) c = wslot[wb][lane];
      warp_best(c);
    } else {
      if (warp == 0) {
        if (lane < SOLVE_WARPS) c = wslot[wb][lane];
        warp_best(c);  // this CTA's candidate, in every lane
        // this CTA's one arrival expects the S candidates' bytes; lane d
        // stores into CTA d's slot, completing them there
        if (lane == 0) mbar_arrive_expect_tx(&w.bars[wb], (uint32_t)(w.S * sizeof(Cand)));
        if (lane < w.S) cand_store_async(&w.e[wb * MAX_CLUSTER + w.shard], c, &w.bars[wb], (uint32_t)lane);
      }
      c = Cand{0, 0u, -1};
      mbar_wait(&w.bars[wb], (w.step >> 1) & 1u);
      if (lane < w.S) c = w.e[wb * MAX_CLUSTER + lane];
      warp_best(c);
    }
    const int32_t n = c.n;
    if (tid == 0) w.sel[i] = n;
    if (n >= lo && n < hi) {  // the owner thread commits into its row's residuals
      const int j = n - lo;
      if (j % SOLVE_THREADS == tid) {
        if (RESIDENT) {
          uint32_t neg = (uint32_t)w.neg_s[j];
          for (uint32_t m = nzm; m; m &= m - 1u) {  // the other slots do not move
            const int r = __ffs(m) - 1;
            const int64_t f = w.free_s[(int64_t)r * Nl + j] - req[r];
            w.free_s[(int64_t)r * Nl + j] = f;
            neg = f < 0 ? neg | (1u << r) : neg & ~(1u << r);
          }
          w.neg_s[j] = (int32_t)neg;
          w.cnt_s[j] += 1;
          w.slack_s[j] -= 1;
          if (nz_on) {
            w.nz_s[j] += s_sreq[b3][0];
            w.nz_s[Nl + j] += s_sreq[b3][1];
          }
        } else {
          int64_t* fr = a.free_ + (int64_t)n * R;
          for (int r = 0; r < R; ++r) fr[r] -= req[r];
          a.count[n] += 1;
          if (nz_on) {
            a.nz[(int64_t)n * 2 + 0] += s_sreq[b3][0];
            a.nz[(int64_t)n * 2 + 1] += s_sreq[b3][1];
          }
        }
        if (a.track) a.cs[(int64_t)s * N + n] += 1;
      }
    }
    if (a.track) {  // every CTA counts the commit into its replicas
      if (n >= 0 && warp == 0) {
        for (int q = lane; q < nmt; q += 32) {
          const int b = track_bucket(a, n, match[q]);
          if (b >= 0) w.ca[(int64_t)match[q] * a.V + b] += 1;
        }
        for (int q = lane; q < no; q += 32) {
          const int b = track_bucket(a, n, own[q]);
          if (b >= 0) w.cb[(int64_t)own[q] * a.V + b] += 1;
        }
      }
      if (tid == 0) {
        n_own = 0;
        n_match = 0;
        n_conf = 0;
      }
      __syncthreads();  // publishes the replicas; the lists are free
    }
    if (RESIDENT && new_row) {
#pragma unroll
      for (int k = 0; k < MAX_ROWS_PER_THREAD; ++k) {
        cm[k] = nm[k];
        cs[k] = ns[k];
      }
    }
    cur = nxt;
    nxt = nxt2;
    b3 = b3 == 2 ? 0 : b3 + 1;
    w.step += 1;
  }
  __syncthreads();  // w.sel complete
}

// out[position] of each step's choice (the writer CTA's copy)
__device__ void scatter_choices(const Walk& w, const int4* steps, int nsteps, int32_t* out) {
  for (int i = threadIdx.x; i < nsteps; i += SOLVE_THREADS) out[steps[i].y] = w.sel[i];
}

template <bool RESIDENT>
__device__ void solve_body(const ClusterSolveArgs& g, Walk& w) {
  const SolveArgs& a = g.walk;
  const int tid = threadIdx.x;
  const int B = a.B;
  int4* steps = g.steps + (int64_t)w.shard * B;
  if (!g.gang) {
    const int nsteps = build_steps(a, a.pod_valid, steps, a.assign, w.shard == 0);
    if (RESIDENT) load_state(a, w);
    __syncthreads();
    greedy_walk<RESIDENT>(a, w, steps, nsteps, true);
    if (RESIDENT) store_state(a, w);
    if (w.shard == 0) scatter_choices(w, steps, nsteps, a.assign);
    return;
  }
  // the gang mode, each CTA with its own replica of the choices, flags and alive set
  int32_t* first = g.first + (int64_t)w.shard * B;
  int32_t* fail = g.fail + (int64_t)w.shard * B;
  uint8_t* alive = g.alive + (int64_t)w.shard * B;
  for (int p = tid; p < B; p += SOLVE_THREADS) fail[p] = 0;
  SolveArgs p1 = a;
  p1.seed = g.seed1;
  if (!RESIDENT) {  // pass 1 walks a scratch copy of the carry
    p1.free_ = g.free1;
    p1.count = g.count1;
    p1.nz = g.nz1;
  }
  int nsteps = build_steps(p1, a.pod_valid, steps, first, true);
  if (RESIDENT) load_state(a, w);
  __syncthreads();
  greedy_walk<RESIDENT>(p1, w, steps, nsteps, false);
  scatter_choices(w, steps, nsteps, first);
  __syncthreads();
  for (int p = tid; p < B; p += SOLVE_THREADS) {
    const int32_t grp = g.group[p];
    if (grp >= 0 && first[p] < 0) fail[grp] = 1;  // every writer stores 1
  }
  __syncthreads();
  for (int p = tid; p < B; p += SOLVE_THREADS) {
    const int32_t grp = g.group[p];
    const bool dropped = grp >= 0 && fail[grp] != 0;
    alive[p] = (a.pod_valid[p] && !dropped) ? 1 : 0;
    if (w.shard == 0) g.gang_ok[p] = dropped ? 0 : 1;
  }
  __syncthreads();
  SolveArgs p2 = a;
  p2.seed = g.seed2;
  nsteps = build_steps(p2, alive, steps, a.assign, w.shard == 0);  // dropped pods decide -1
  if (RESIDENT) load_state(a, w);  // pass 2 starts again from the batch-start residuals
  __syncthreads();
  greedy_walk<RESIDENT>(p2, w, steps, nsteps, true);
  if (RESIDENT) store_state(a, w);
  if (w.shard == 0) scatter_choices(w, steps, nsteps, a.assign);
}

// dynamic shared memory of a CTA, in this order: (resident) free [R, Nl],
// count [Nl], nz [2, Nl] (int64), slack, negative slots [Nl] and the
// choices [B] (int32);
// (tracking) the lists [2 TT + U] and (track_shared) ca, cb [TT, V] (int32)
__host__ __device__ inline size_t solve_smem_bytes(const ClusterSolveArgs& g) {
  const SolveArgs& a = g.walk;
  size_t bytes = 0;
  if (g.resident) bytes += ((size_t)a.R + 4) * g.Nl * sizeof(int64_t) + (size_t)a.B * sizeof(int32_t);
  if (a.track) {
    bytes += (2 * (size_t)a.TT + a.U) * sizeof(int32_t);
    if (g.track_shared) bytes += 2 * (size_t)a.TT * a.V * sizeof(int32_t);
  }
  return bytes;
}

__global__ void __launch_bounds__(SOLVE_THREADS) solve_kernel(const ClusterSolveArgs g) {
  __shared__ Cand e[2 * MAX_CLUSTER];
  __shared__ __align__(8) uint64_t bars[2];
  extern __shared__ __align__(16) unsigned char dyn[];
  const SolveArgs& a = g.walk;
  Walk w{cg::this_cluster()};
  w.shard = (int)w.cluster.block_rank();
  w.S = g.S;
  w.Nl = g.Nl;
  w.lo = w.shard * g.Nl;
  w.step = 0;
  w.e = e;
  w.bars = bars;
  unsigned char* at = dyn;
  if (g.resident) {
    w.free_s = (int64_t*)at;
    w.cnt_s = w.free_s + (int64_t)a.R * g.Nl;
    w.nz_s = w.cnt_s + g.Nl;
    w.slack_s = (int32_t*)(w.nz_s + 2 * (int64_t)g.Nl);
    w.neg_s = w.slack_s + g.Nl;
    w.sel = w.neg_s + g.Nl;
    at = (unsigned char*)(w.sel + a.B);
  } else {
    w.sel = g.sel + (int64_t)w.shard * a.B;
  }
  if (a.track) {
    w.lists = (int32_t*)at;
    at = (unsigned char*)(w.lists + 2 * a.TT + a.U);
    const int64_t tv = (int64_t)a.TT * a.V;
    if (g.track_shared) {
      w.ca = (int32_t*)at;
      w.cb = w.ca + tv;
      for (int64_t i = threadIdx.x; i < 2 * tv; i += SOLVE_THREADS) w.ca[i] = 0;
    } else {
      w.ca = a.ca + w.shard * tv;
      w.cb = a.cb + w.shard * tv;
    }
  }
  if (g.S > 1) {
    if (threadIdx.x == 0) {
      mbar_init(&bars[0], 1u);  // this CTA's own arrival; the pushes complete bytes
      mbar_init(&bars[1], 1u);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    w.cluster.sync();  // every CTA's mbarriers are ready before the first push
  }
  __syncthreads();
  if (g.resident) {
    solve_body<true>(g, w);
  } else {
    solve_body<false>(g, w);
  }
  if (g.S > 1) w.cluster.sync();  // no CTA leaves while another may still read or push into its slots
}

static int solve_valid(const ClusterSolveArgs& g) {
  const SolveArgs& a = g.walk;
  if (g.S < 1 || g.S > MAX_CLUSTER || g.Nl < 1 || g.Nl != (a.N + g.S - 1) / g.S) return 0;
  if (a.R > 32) return 0;
  if (g.resident && g.Nl > MAX_ROWS_PER_THREAD * SOLVE_THREADS) return 0;
  if (g.track_shared && !a.track) return 0;
  return !(g.gang && a.track);  // the gang solve tracks nothing
}

extern "C" int ktpu_solve(const ClusterSolveArgs* args, cudaStream_t stream) {
  const ClusterSolveArgs& g = *args;
  if (!solve_valid(g)) return (int)cudaErrorInvalidValue;
  if (g.walk.B <= 0) return (int)cudaGetLastError();
  return launch_cluster((const void*)solve_kernel, g.S, SOLVE_THREADS, solve_smem_bytes(g), g, stream);
}

// the clusters of the solve's launch the card holds at once (0: none)
extern "C" int ktpu_solve_clusters(const ClusterSolveArgs* args, int* out) {
  const ClusterSolveArgs& g = *args;
  if (!solve_valid(g)) return (int)cudaErrorInvalidValue;
  return cluster_capacity((const void*)solve_kernel, g.S, SOLVE_THREADS, solve_smem_bytes(g), out);
}
