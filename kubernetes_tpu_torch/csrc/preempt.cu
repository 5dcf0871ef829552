// Vectorized victim search: the device formulation of preemption.
//
// Replaces kubernetes_tpu/ops/preempt.py:preempt_batch (:63). The reference
// is a scan over preemptors whose step runs selectVictimsOnNode on every
// node at once (an inner scan over the victim slots) and the six-key pick
// of pickOneNodeForPreemption; the carry is each node's free resources and
// pod slack (nominee-adjusted: free - nom_extra, count_free - nom_cnt, the
// only forms the step reads) and the victims still alive.
//
// Design: ONE thread block (at most 512 threads, 256 for R > 16: the
// registers of the request vectors) walks the P steps in order. Thread t
// owns nodes t, t + blockDim, ... and keeps their carry in global scratch
// that only it touches (nfree [N, R], ncount [N], alive / vmask / pdbmask
// [N] as 64-bit victim-slot masks, V <= 64). Per step each thread runs the victim search
// of its nodes: the lower-priority alive victims, the fit after removing
// them all, the greedy reprieve in slot order with the request vector in
// registers (R <= RCAP, the template width), and the pick keys. Then
//   any(fits_free)  one __syncthreads_or;
//   the pick        keep-min over (violations, max victim priority, int64
//                   priority sum, count, -max timestamp of the top-priority
//                   victims) and then the lowest row, which is the
//                   lexicographic minimum of the tuple (keys..., row): a
//                   warp-shuffle reduction, then one across the warps;
// and the chosen node's owner applies the carry update. The reference fills
// the max priority with INT32_MIN and the max timestamp with -2^62 before
// the max (so -max timestamp never exceeds the reference's 2^62 mask);
// both fills are kept.
//
// Bound: operations — a latency chain of P dependent steps, each one pass
// over N x V x R integers and two block barriers; the inputs (a few MB at
// P = 2048, N = 512, V = R = 8) are read once per step from L2.
#include "common.cuh"

#define PREEMPT_MAX_THREADS 512

struct PreemptArgs {
  const uint8_t* cand;        // [P, N]
  const int64_t* p_req;       // [P, R]
  const uint8_t* p_req_any;   // [P]
  const int32_t* p_prio;      // [P]
  const uint8_t* p_valid;     // [P]
  const int64_t* vict_req;    // [N, V, R]
  const int32_t* vict_prio;   // [N, V]
  const int64_t* vict_ts;     // [N, V]
  const uint8_t* vict_pdb;    // [N, V]
  const uint8_t* vict_valid;  // [N, V]
  const int64_t* free0;       // [N, R]
  const int32_t* count_free0; // [N]
  const uint8_t* node_valid;  // [N]
  const int64_t* nom_extra0;  // [N, R]
  const int32_t* nom_cnt0;    // [N]
  int32_t* nodes_out;         // [P]
  uint8_t* victims_out;       // [P, V]
  uint8_t* fits_free_out;     // [P]
  int64_t* nfree;             // [N, R] scratch: free - nom_extra
  int32_t* ncount;            // [N] scratch: count_free - nom_cnt
  uint64_t* alive;            // [N] scratch: alive victim slots
  uint64_t* vmask;            // [N] scratch: this step's victim slots
  uint64_t* pdbmask;          // [N] scratch: PDB-violating slots
  int32_t P, N, V, R;
};

// one node's pick key; an infeasible node carries row = INT32_MAX
struct PickKey {
  int64_t viol, maxprio, psum, cnt, negts;
  int32_t row;
};

__device__ __forceinline__ bool key_less(const PickKey& a, const PickKey& b) {
  if (a.viol != b.viol) return a.viol < b.viol;
  if (a.maxprio != b.maxprio) return a.maxprio < b.maxprio;
  if (a.psum != b.psum) return a.psum < b.psum;
  if (a.cnt != b.cnt) return a.cnt < b.cnt;
  if (a.negts != b.negts) return a.negts < b.negts;
  return a.row < b.row;
}

__device__ __forceinline__ PickKey shfl_key(const PickKey& k, int lane_mask) {
  PickKey o;
  o.viol = __shfl_xor_sync(0xffffffffu, k.viol, lane_mask);
  o.maxprio = __shfl_xor_sync(0xffffffffu, k.maxprio, lane_mask);
  o.psum = __shfl_xor_sync(0xffffffffu, k.psum, lane_mask);
  o.cnt = __shfl_xor_sync(0xffffffffu, k.cnt, lane_mask);
  o.negts = __shfl_xor_sync(0xffffffffu, k.negts, lane_mask);
  o.row = __shfl_xor_sync(0xffffffffu, k.row, lane_mask);
  return o;
}

__device__ __forceinline__ PickKey warp_min(PickKey k) {
  for (int m = 16; m > 0; m >>= 1) {
    const PickKey o = shfl_key(k, m);
    if (key_less(o, k)) k = o;
  }
  return k;
}

__device__ __forceinline__ PickKey no_key() {
  PickKey k;
  k.viol = k.maxprio = k.psum = k.cnt = k.negts = INT64_MAX;
  k.row = INT32_MAX;
  return k;
}

// MAXT: the block size the registers of one RCAP-wide thread allow
template <int RCAP, int MAXT>
__global__ void __launch_bounds__(MAXT) preempt_kernel(const PreemptArgs a) {
  __shared__ PickKey s_warp[PREEMPT_MAX_THREADS / 32];
  __shared__ int32_t s_chosen;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int N = a.N, V = a.V, R = a.R;
  const int64_t TS_MIN = -(INT64_C(1) << 62);

  // the carry's initial state and the constant slot masks
  for (int i = tid; i < N; i += nt) {
    for (int r = 0; r < R; ++r) {
      a.nfree[(int64_t)i * R + r] = a.free0[(int64_t)i * R + r] - a.nom_extra0[(int64_t)i * R + r];
    }
    a.ncount[i] = a.count_free0[i] - a.nom_cnt0[i];
    uint64_t valid = 0, pdb = 0;
    for (int v = 0; v < V; ++v) {
      if (a.vict_valid[(int64_t)i * V + v]) valid |= (1ull << v);
      if (a.vict_pdb[(int64_t)i * V + v]) pdb |= (1ull << v);
    }
    a.alive[i] = valid;  // alive & valid: the reference's alive starts all-true
    a.pdbmask[i] = pdb;
  }

  for (int k = 0; k < a.P; ++k) {
    int64_t req[RCAP];
    bool checked[RCAP];
    for (int r = 0; r < RCAP; ++r) {
      req[r] = r < R ? a.p_req[(int64_t)k * R + r] : 0;
      checked[r] = r < R && (r < 3 || req[r] > 0);
    }
    const bool any_req = a.p_req_any[k] != 0;
    const int32_t prio = a.p_prio[k];
    int ff_local = 0;
    PickKey best = no_key();
    for (int i = tid; i < N; i += nt) {
      const bool live = a.cand[(int64_t)k * N + i] && a.node_valid[i];
      const int64_t* nf = a.nfree + (int64_t)i * R;
      const int32_t nc = a.ncount[i];
      // fits_free: the pod fits as the node stands, nominees charged
      bool free_ok = true;
      if (any_req) {
        for (int r = 0; r < RCAP; ++r) {
          if (checked[r] && nf[r] - req[r] < 0) free_ok = false;
        }
      }
      if (live && free_ok && nc >= 1) ff_local = 1;
      // every alive, valid, lower-priority slot removed
      uint64_t lower = 0;
      const uint64_t alive = a.alive[i];
      for (int v = 0; v < V; ++v) {
        if (((alive >> v) & 1ull) && a.vict_prio[(int64_t)i * V + v] < prio) lower |= (1ull << v);
      }
      const int32_t nfreed = __popcll(lower);
      int64_t head[RCAP];
      for (int r = 0; r < RCAP; ++r) head[r] = r < R ? nf[r] - req[r] : 0;
      const int64_t* vr = a.vict_req + (int64_t)i * V * R;
      for (int v = 0; v < V; ++v) {
        if ((lower >> v) & 1ull) {
          for (int r = 0; r < RCAP; ++r) {
            if (r < R) head[r] += vr[(int64_t)v * R + r];
          }
        }
      }
      bool res_ok = true;
      if (any_req) {
        for (int r = 0; r < RCAP; ++r) {
          if (checked[r] && head[r] < 0) res_ok = false;
        }
      }
      int32_t cslack = nc + nfreed - 1;
      const bool fits = live && res_ok && cslack >= 0 && nfreed > 0;
      uint64_t victims = 0;
      if (fits) {
        // the greedy reprieve in slot order
        for (int v = 0; v < V; ++v) {
          if (!((lower >> v) & 1ull)) continue;
          bool keep = true;
          if (any_req) {
            for (int r = 0; r < RCAP; ++r) {
              if (checked[r] && head[r] - vr[(int64_t)v * R + r] < 0) keep = false;
            }
          }
          if (keep && cslack >= 1) {
            for (int r = 0; r < RCAP; ++r) {
              if (r < R) head[r] -= vr[(int64_t)v * R + r];
            }
            cslack -= 1;
          } else {
            victims |= (1ull << v);
          }
        }
      }
      a.vmask[i] = victims;
      if (victims != 0) {
        PickKey key;
        key.viol = __popcll(victims & a.pdbmask[i]);
        int32_t maxprio = INT32_MIN;
        int64_t psum = 0;
        for (int v = 0; v < V; ++v) {
          if ((victims >> v) & 1ull) {
            const int32_t pv = a.vict_prio[(int64_t)i * V + v];
            maxprio = pv > maxprio ? pv : maxprio;
            psum += (int64_t)pv;
          }
        }
        int64_t maxts = TS_MIN;
        for (int v = 0; v < V; ++v) {
          if (((victims >> v) & 1ull) && a.vict_prio[(int64_t)i * V + v] == maxprio) {
            const int64_t ts = a.vict_ts[(int64_t)i * V + v];
            maxts = ts > maxts ? ts : maxts;
          }
        }
        key.maxprio = maxprio;
        key.psum = psum;
        key.cnt = __popcll(victims);
        key.negts = (int64_t)(0ull - (uint64_t)maxts);
        key.row = i;
        if (key_less(key, best)) best = key;
      }
    }
    const int any_ff = __syncthreads_or(ff_local);
    best = warp_min(best);
    if ((tid & 31) == 0) s_warp[tid >> 5] = best;
    __syncthreads();
    if (tid < 32) {
      const int nw = (nt + 31) >> 5;
      PickKey w = tid < nw ? s_warp[tid] : no_key();
      w = warp_min(w);
      if (tid == 0) {
        const bool found = w.row != INT32_MAX && a.p_valid[k] && !any_ff;
        s_chosen = found ? w.row : -1;
        a.nodes_out[k] = found ? w.row : -1;
        a.fits_free_out[k] = any_ff ? 1 : 0;
      }
    }
    __syncthreads();
    const int32_t chosen = s_chosen;
    const uint64_t vm = chosen >= 0 ? a.vmask[chosen] : 0ull;
    for (int v = tid; v < V; v += nt) a.victims_out[(int64_t)k * V + v] = (vm >> v) & 1ull;
    if (chosen >= 0 && chosen % nt == tid) {
      // the carry update on the chosen row: its victims vanish, their
      // requests come back, the preemptor's request is charged
      const int64_t* vr = a.vict_req + (int64_t)chosen * V * R;
      int64_t* nf = a.nfree + (int64_t)chosen * R;
      for (int r = 0; r < R; ++r) {
        int64_t freed = 0;
        for (int v = 0; v < V; ++v) {
          if ((vm >> v) & 1ull) freed += vr[(int64_t)v * R + r];
        }
        nf[r] += freed - a.p_req[(int64_t)k * R + r];
      }
      a.ncount[chosen] += __popcll(vm) - 1;
      a.alive[chosen] &= ~vm;
    }
    // the next step's victim masks are written after this step's reads of
    // vmask[chosen]: keep them apart
    __syncthreads();
  }
}

extern "C" int ktpu_preempt_batch(const PreemptArgs* args, cudaStream_t stream) {
  const PreemptArgs& a = *args;
  if (a.P <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.V > 64 || a.R > 64) return (int)cudaErrorInvalidValue;
  int threads = ((a.N + 31) / 32) * 32;
  const int cap = a.R <= 16 ? PREEMPT_MAX_THREADS : PREEMPT_MAX_THREADS / 2;
  if (threads > cap) threads = cap;
  if (a.R <= 8) {
    preempt_kernel<8, PREEMPT_MAX_THREADS><<<1, threads, 0, stream>>>(a);
  } else if (a.R <= 16) {
    preempt_kernel<16, PREEMPT_MAX_THREADS><<<1, threads, 0, stream>>>(a);
  } else if (a.R <= 32) {
    preempt_kernel<32, PREEMPT_MAX_THREADS / 2><<<1, threads, 0, stream>>>(a);
  } else {
    preempt_kernel<64, PREEMPT_MAX_THREADS / 2><<<1, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
