// Vectorized victim search: the device formulation of preemption.
//
// Replaces kubernetes_tpu/ops/preempt.py:preempt_batch (:63). The reference
// is a scan over preemptors whose step runs selectVictimsOnNode on every
// node at once (an inner scan over the victim slots) and the six-key pick
// of pickOneNodeForPreemption; the carry is each node's free resources and
// pod slack (nominee-adjusted: free - nom_extra, count_free - nom_cnt, the
// only forms the step reads) and the victims still alive. Only the chosen
// node's carry changes in a step.
//
// Design: what no step changes is computed across the card first, then ONE
// block of 512 threads walks the P steps with the carry and a cache of
// every node's victim search in shared memory:
//   * prologues  preempt_steps_kernel (a block a step): the step's checked
//                resource mask, `same spec` (p_req, p_req_any and p_prio
//                equal step k-1's) and whether cand[k] holds every valid
//                node or none; preempt_nodes_kernel: each node's carry at
//                the start (free - nom_extra slot-major, count_free -
//                nom_cnt) and its valid (the alive victims at the start)
//                and PDB-violating victim-slot masks.
//   * the cache  per node the result of its victim search as if it were a
//                candidate: the fits-as-it-stands bit, the victim mask
//                and the pick key (PDB violations, max victim priority,
//                int64 priority sum, count, -max timestamp of the
//                top-priority victims, row) packed into three 64-bit
//                words whose unsigned order is the reference's
//                lexicographic order (no key: all ones). cand[k] and
//                node_valid only gate a cached result when the pick and
//                the fits-free test read it; they never dirty it.
//   * reuse      a step whose spec equals the step before re-evaluates only
//                the row the step before chose (the only carry that
//                changed); a step with a new spec re-evaluates every row.
//   * the pick   a tournament tree over the cached keys (valid nodes
//                only; an internal node holds the least key under it, and
//                a key names its row), and the count of valid nodes that
//                fit as they stand, both kept up to date as the cache
//                changes: a changed leaf rewrites its path in one pass (lane
//                l loads the sibling key at level l, a prefix minimum over
//                the lanes, lane l writes level l + 1). The least key
//                excluding the changed leaf is known before the leaf is
//                re-evaluated, so that row's state is fetched while it is.
//                A reuse step whose cand[k] holds every valid node (or
//                none) is walked by warp 0 alone: no block barrier at all.
//                Other steps take the block: the rows re-evaluated (a new
//                spec: every row), then a gated minimum over the cache and
//                a block OR of the fits-free bits; the tree is rebuilt (one
//                barrier a level) only before a reuse run.
//   * a row      is evaluated by a group of G lanes (G = 8 for R <= 8, else
//                32): lane g holds resource slots g, g + G (R <= 64) and
//                victim slots g, g + G, ...; the tests are group votes, the
//                greedy reprieve runs in slot order, the key's maxima and
//                sum are group reductions. The victims' first 8 request
//                rows stay in registers between the re-evaluation and the
//                carry update. A reuse step evaluates one row; all groups
//                of warp 0 evaluate it alike.
//   * the carry  nominee-adjusted free [R, N] int64, pod slack, alive /
//                PDB / victim masks, the keys, the tree and the bits live
//                in shared memory when they fit (`resident`; config 6: 118
//                B a node and 24 B a tree node), the victims' requests, priorities
//                and start times too when those also fit; otherwise the
//                same kernel keeps them in device memory (the wrapper
//                counts those launches).
// The reference fills the max priority with INT32_MIN and the max timestamp
// with -2^62 before the max (so -max timestamp never exceeds the
// reference's 2^62 mask); both fills are kept, and the priority sum is
// int64. `walk_stats` returns [rows evaluated, steps walked by warp 0
// alone, tree rebuilds].
//
// Bound: operations — a latency chain of P dependent steps; with reuse a
// step is one row's victim search, one tree path and one carry update.
#include "common.cuh"

#define PREEMPT_THREADS 512
#define PREEMPT_WARPS (PREEMPT_THREADS / 32)
#define VCHUNK 8  // victim slots whose requests a row keeps in registers

// step flags (preempt_steps_kernel)
#define STEP_SAME 1    // p_req, p_req_any and p_prio equal step k-1's
#define STEP_CFULL 2   // cand[k] holds every valid node
#define STEP_CEMPTY 4  // cand[k] holds no valid node
#define STEP_VALID 8   // p_valid[k]
#define STEP_ANY 16    // p_req_any[k]

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
  uint8_t* state;             // [state_bytes] the walk's carry in device memory (preempt_carry_bytes)
  int32_t* step_flags;        // [P] STEP_* bits
  uint64_t* step_checked;     // [P] bit r: resource slot r is checked
  int64_t* walk_stats;        // [3] rows evaluated, steps walked by warp 0 alone, tree rebuilds
  int64_t state_bytes;        // preempt_carry_bytes(N, NP, R)
  int64_t smem_bytes;         // dynamic shared memory (resident only)
  int32_t P, N, V, R;
  int32_t NP;                 // tree leaves: a power of two >= max(N, 2)
  int32_t resident;           // 1: the carry in shared memory
  int32_t victims_resident;   // 1: the victims' requests, priorities, start times in shared memory too
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// the carry's bytes: nfree [R, N] int64; alive, pdb, vm, key [3, N] uint64;
// the tree's keys [3, NP] uint64; ncount [N] int32; ff, valid [N] uint8
__host__ __device__ __forceinline__ size_t preempt_carry_bytes(int N, int NP, int R) {
  return align16((size_t)N * (8 * (size_t)R + 54) + 24 * (size_t)NP);
}

struct Layout {
  int64_t* nfree;     // [R, N]
  uint64_t* alive;    // [N] alive victim slots
  uint64_t* pdb;      // [N] PDB-violating slots
  uint64_t* vm;       // [N] cached victim mask
  uint64_t* key;      // [3, N] cached pick key words
  uint64_t* tree;     // [3, NP] the least key under internal node n (1 <= n < NP)
  int32_t* ncount;    // [N]
  uint8_t* ff;        // [N] cached fits-as-it-stands bit
  uint8_t* valid;     // [N]
  const int64_t* vr;  // [N, V, R]
  const int64_t* vt;  // [N, V]
  const int32_t* vp;  // [N, V]
};

__device__ __forceinline__ Layout carve(uint8_t* base, int N, int NP, int R) {
  Layout L;
  size_t off = 0;
  L.nfree = (int64_t*)(base + off); off += (size_t)8 * R * N;
  L.alive = (uint64_t*)(base + off); off += (size_t)8 * N;
  L.pdb = (uint64_t*)(base + off); off += (size_t)8 * N;
  L.vm = (uint64_t*)(base + off); off += (size_t)8 * N;
  L.key = (uint64_t*)(base + off); off += (size_t)24 * N;
  L.tree = (uint64_t*)(base + off); off += (size_t)24 * NP;
  L.ncount = (int32_t*)(base + off); off += (size_t)4 * N;
  L.ff = base + off; off += N;
  L.valid = base + off;
  return L;
}

// --- pick keys: (viol, maxprio, psum, cnt, -maxts, row) packed so that the
// unsigned order of (w0, w1, w2) is the lexicographic order of the tuple:
// viol 7 bits (<= 64), maxprio + 2^31 32 bits, psum + 2^37 38 bits (at most
// 64 int32 priorities), cnt 7 bits, -maxts with its sign bit flipped 64
// bits, row 32 bits. No key: all ones (above any key: viol <= 64).
struct Key {
  uint64_t w0, w1, w2;
};

#define KEY_NONE (~0ull)

__device__ __forceinline__ Key no_key() { return Key{KEY_NONE, KEY_NONE, KEY_NONE}; }

__device__ __forceinline__ bool key_lt(const Key& a, const Key& b) {
  if (a.w0 != b.w0) return a.w0 < b.w0;
  if (a.w1 != b.w1) return a.w1 < b.w1;
  return a.w2 < b.w2;
}

__device__ __forceinline__ bool key_none(const Key& k) { return k.w0 == KEY_NONE; }

__device__ __forceinline__ Key pack_key(int viol, int32_t maxprio, int64_t psum, int cnt, int64_t negts, int row) {
  const uint64_t mp = (uint64_t)((int64_t)maxprio + (INT64_C(1) << 31));
  const uint64_t ps = (uint64_t)(psum + (INT64_C(1) << 37));
  const uint64_t nt = (uint64_t)negts ^ (1ull << 63);
  Key k;
  k.w0 = ((uint64_t)viol << 57) | (mp << 25) | (ps >> 13);
  k.w1 = ((ps & 0x1FFFull) << 51) | ((uint64_t)cnt << 44) | (nt >> 20);
  k.w2 = ((nt & 0xFFFFFull) << 44) | ((uint64_t)(uint32_t)row << 12);
  return k;
}

__device__ __forceinline__ int key_row(const Key& k) { return (int)((k.w2 >> 12) & 0xFFFFFFFFull); }

__device__ __forceinline__ Key shfl_key(const Key& k, int src) {
  return Key{__shfl_sync(0xffffffffu, k.w0, src), __shfl_sync(0xffffffffu, k.w1, src),
             __shfl_sync(0xffffffffu, k.w2, src)};
}

__device__ __forceinline__ Key warp_min_key(Key k) {
  for (int m = 16; m > 0; m >>= 1) {
    const Key o{__shfl_xor_sync(0xffffffffu, k.w0, m), __shfl_xor_sync(0xffffffffu, k.w1, m),
                __shfl_xor_sync(0xffffffffu, k.w2, m)};
    if (key_lt(o, k)) k = o;
  }
  return k;
}

// node j's cached key as the pick reads it: an invalid or padding leaf has none
__device__ __forceinline__ Key key_at(const Layout& L, int N, int j) {
  if (j < 0 || j >= N || !L.valid[j]) return no_key();
  return Key{L.key[j], L.key[(size_t)N + j], L.key[2 * (size_t)N + j]};
}

// tree node n's key: a leaf's gated cache key, an internal node's least key
__device__ __forceinline__ Key tree_key(const Layout& L, int N, int NP, int n) {
  if (n >= NP) return key_at(L, N, n - NP);
  return Key{L.tree[n], L.tree[(size_t)NP + n], L.tree[2 * (size_t)NP + n]};
}

__device__ __forceinline__ void set_tree(const Layout& L, int NP, int n, const Key& k) {
  L.tree[n] = k.w0;
  L.tree[(size_t)NP + n] = k.w1;
  L.tree[2 * (size_t)NP + n] = k.w2;
}

__device__ __forceinline__ Key key_min(const Key& a, const Key& b) { return key_lt(b, a) ? b : a; }

// --- groups of G lanes evaluate one row ---------------------------------------
template <int G>
__device__ __forceinline__ unsigned group_bits(int lane) {
  return G == 32 ? 0xffffffffu : (((1u << G) - 1u) << (lane & ~(G - 1)));
}

// every lane of the group holds `p` (all lanes of the warp call it)
template <int G>
__device__ __forceinline__ bool group_all(bool p, int lane) {
  const unsigned gb = group_bits<G>(lane);
  return (__ballot_sync(0xffffffffu, p) & gb) == gb;
}

template <int G>
__device__ __forceinline__ int64_t group_sum64(int64_t x) {
  for (int m = G / 2; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

template <int G>
__device__ __forceinline__ int64_t group_max64(int64_t x) {
  for (int m = G / 2; m > 0; m >>= 1) {
    const int64_t o = __shfl_xor_sync(0xffffffffu, x, m);
    x = o > x ? o : x;
  }
  return x;
}

template <int G>
__device__ __forceinline__ int32_t group_max32(int32_t x) {
  for (int m = G / 2; m > 0; m >>= 1) {
    const int32_t o = __shfl_xor_sync(0xffffffffu, x, m);
    x = o > x ? o : x;
  }
  return x;
}

// one step's preemptor as a lane of a group holds it: resource slots
// g + G * j (RJ of them), the checked bits, p_req_any and the priority
template <int RJ>
struct Spec {
  int64_t req[RJ];
  bool chk[RJ];
  bool any;
  int32_t prio;
};

// one node's state as a lane of its group holds it: resource slots g + G * j,
// victim slots g + G * j (VJ of them), and the first VCHUNK victims' requests
template <int RJ, int VJ>
struct Row {
  int32_t i;  // the row (>= N: a group with nothing to evaluate)
  int32_t nc;
  bool ff, valid;  // the cached fits-free bit and node_valid
  int64_t nf[RJ];
  uint64_t alive, pdb, vm;
  int32_t vp[VJ];
  int64_t vt[VJ];
  int64_t x[RJ][VCHUNK];
};

template <int G, int RJ, int VJ>
__device__ __forceinline__ void load_row(const Layout& L, const PreemptArgs& a, int i, Row<RJ, VJ>& w, int g) {
  const int N = a.N, V = a.V, R = a.R;
  w.i = i;
  if (i >= N) {
    w.nc = 0;
    w.ff = w.valid = false;
    w.alive = w.pdb = w.vm = 0;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      w.nf[j] = 0;
#pragma unroll
      for (int c = 0; c < VCHUNK; ++c) w.x[j][c] = 0;
    }
#pragma unroll
    for (int j = 0; j < VJ; ++j) {
      w.vp[j] = 0;
      w.vt[j] = 0;
    }
    return;
  }
  w.nc = L.ncount[i];
  w.ff = L.ff[i] != 0;
  w.valid = L.valid[i] != 0;
  w.alive = L.alive[i];
  w.pdb = L.pdb[i];
  w.vm = L.vm[i];
  const int64_t* vr = L.vr + (size_t)i * V * R;
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int r = g + G * j;
    w.nf[j] = r < R ? L.nfree[(size_t)r * N + i] : 0;
#pragma unroll
    for (int c = 0; c < VCHUNK; ++c) w.x[j][c] = (r < R && c < V) ? vr[(size_t)c * R + r] : 0;
  }
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int v = g + G * j;
    w.vp[j] = v < V ? L.vp[(size_t)i * V + v] : 0;
    w.vt[j] = v < V ? L.vt[(size_t)i * V + v] : 0;
  }
}

// the request of victim slot v at this lane's resource slot j (v >= VCHUNK:
// read from memory)
template <int G, int RJ, int VJ>
__device__ __forceinline__ int64_t vreq(const Layout& L, const PreemptArgs& a, const Row<RJ, VJ>& w, int v, int j,
                                        int g) {
  const int r = g + G * j;
  return r < a.R ? L.vr[((size_t)w.i * a.V + v) * a.R + r] : 0;
}

// selectVictimsOnNode for row w as if it were a candidate: the fits-as-it-
// stands bit, the victim mask and the pick key (none when it cannot take the
// pod or needs no victim). Every lane of the warp calls it (group votes).
template <int G, int RJ, int VJ>
__device__ __forceinline__ void eval_row(const Layout& L, const PreemptArgs& a, const Row<RJ, VJ>& w,
                                         const Spec<RJ>& s, int lane, Key& key, bool& ff, uint64_t& vm) {
  const int g = lane & (G - 1);
  const int V = a.V;
  const int64_t TS_MIN = -(INT64_C(1) << 62);
  // fits_free: the pod fits as the node stands, nominees charged
  bool ok = true;
#pragma unroll
  for (int j = 0; j < RJ; ++j) ok = ok && (!s.chk[j] || w.nf[j] - s.req[j] >= 0);
  const bool free_ok = group_all<G>(ok, lane) || !s.any;
  ff = free_ok && w.nc >= 1;
  // every alive, lower-priority slot removed (alive holds only valid slots)
  uint64_t lower = 0;
  const int gbase = lane & ~(G - 1);
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int v = g + G * j;
    const bool b = v < V && ((w.alive >> v) & 1ull) && w.vp[j] < s.prio;
    const unsigned bal = (__ballot_sync(0xffffffffu, b) >> gbase) & gmask;
    lower |= (uint64_t)bal << (G * j);
  }
  const int nfreed = __popcll(lower);
  int64_t head[RJ];
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    head[j] = w.nf[j] - s.req[j];
#pragma unroll
    for (int c = 0; c < VCHUNK; ++c) head[j] += ((lower >> c) & 1ull) ? w.x[j][c] : 0;
  }
  for (int v = VCHUNK; v < V; ++v) {
    if ((lower >> v) & 1ull) {
#pragma unroll
      for (int j = 0; j < RJ; ++j) head[j] += vreq<G, RJ, VJ>(L, a, w, v, j, g);
    }
  }
  bool rok = true;
#pragma unroll
  for (int j = 0; j < RJ; ++j) rok = rok && (!s.chk[j] || head[j] >= 0);
  const bool res_ok = group_all<G>(rok, lane) || !s.any;
  int32_t cslack = w.nc + nfreed - 1;
  const bool fits = res_ok && cslack >= 0 && nfreed > 0;
  vm = 0;
  // the greedy reprieve in slot order; a group that does not fit keeps
  // voting (the warp's lanes vote together) and changes nothing
#pragma unroll
  for (int c = 0; c < VCHUNK; ++c) {
    const bool in = fits && ((lower >> c) & 1ull);
    bool kk = true;
#pragma unroll
    for (int j = 0; j < RJ; ++j) kk = kk && (!s.chk[j] || head[j] - w.x[j][c] >= 0);
    const bool keep = (group_all<G>(kk, lane) || !s.any) && cslack >= 1;
    if (in && keep) {
#pragma unroll
      for (int j = 0; j < RJ; ++j) head[j] -= w.x[j][c];
      cslack -= 1;
    } else if (in) {
      vm |= 1ull << c;
    }
  }
  for (int v = VCHUNK; v < V; ++v) {
    const bool in = fits && ((lower >> v) & 1ull);
    int64_t xv[RJ];
    bool kk = true;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      xv[j] = in ? vreq<G, RJ, VJ>(L, a, w, v, j, g) : 0;
      kk = kk && (!s.chk[j] || head[j] - xv[j] >= 0);
    }
    const bool keep = (group_all<G>(kk, lane) || !s.any) && cslack >= 1;
    if (in && keep) {
#pragma unroll
      for (int j = 0; j < RJ; ++j) head[j] -= xv[j];
      cslack -= 1;
    } else if (in) {
      vm |= 1ull << v;
    }
  }
  // the pick key over the victims
  int32_t mp = INT32_MIN;
  int64_t ps = 0;
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int v = g + G * j;
    if (v < V && ((vm >> v) & 1ull)) {
      mp = w.vp[j] > mp ? w.vp[j] : mp;
      ps += (int64_t)w.vp[j];
    }
  }
  mp = group_max32<G>(mp);
  ps = group_sum64<G>(ps);
  int64_t mt = TS_MIN;
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int v = g + G * j;
    if (v < V && ((vm >> v) & 1ull) && w.vp[j] == mp) mt = w.vt[j] > mt ? w.vt[j] : mt;
  }
  mt = group_max64<G>(mt);
  key = vm == 0 ? no_key()
                : pack_key(__popcll(vm & w.pdb), mp, ps, __popcll(vm), (int64_t)(0ull - (uint64_t)mt), w.i);
}

// the carry update on the chosen row: its victims vanish, their requests
// come back, the preemptor's request is charged (every resource slot);
// written through to the carry by the row's group
template <int G, int RJ, int VJ>
__device__ __forceinline__ void commit_row(const Layout& L, const PreemptArgs& a, Row<RJ, VJ>& w,
                                           const Spec<RJ>& s, uint64_t vm, int lane) {
  const int g = lane & (G - 1);
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    int64_t freed = 0;
#pragma unroll
    for (int c = 0; c < VCHUNK; ++c) freed += ((vm >> c) & 1ull) ? w.x[j][c] : 0;
    for (int v = VCHUNK; v < a.V; ++v) {
      if ((vm >> v) & 1ull) freed += vreq<G, RJ, VJ>(L, a, w, v, j, g);
    }
    w.nf[j] += freed - s.req[j];
    const int r = g + G * j;
    if (lane < G && r < a.R) L.nfree[(size_t)r * a.N + w.i] = w.nf[j];
  }
  w.nc += __popcll(vm) - 1;
  w.alive &= ~vm;
  if (lane == 0) {
    L.ncount[w.i] = w.nc;
    L.alive[w.i] = w.alive;
  }
}

template <int RJ>
__device__ __forceinline__ void load_spec(const PreemptArgs& a, int k, int fl, int g, int G, Spec<RJ>& s) {
  const uint64_t chk = a.step_checked[k];
  s.any = (fl & STEP_ANY) != 0;
  s.prio = a.p_prio[k];
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int r = g + G * j;
    s.req[j] = r < a.R ? a.p_req[(size_t)k * a.R + r] : 0;
    s.chk[j] = r < a.R && ((chk >> r) & 1ull);
  }
}

// --- prologues ------------------------------------------------------------------

// per step: the checked mask, same spec and the candidate classes
__global__ void __launch_bounds__(128) preempt_steps_kernel(const PreemptArgs a) {
  for (int k = blockIdx.x; k < a.P; k += gridDim.x) {
    int hole = 0, live = 0;
    for (int i = threadIdx.x; i < a.N; i += blockDim.x) {
      if (a.node_valid[i]) {
        if (a.cand[(size_t)k * a.N + i]) live = 1;
        else hole = 1;
      }
    }
    hole = __syncthreads_or(hole);
    live = __syncthreads_or(live);
    if (threadIdx.x == 0) {
      uint64_t chk = 0;
      bool same = k > 0 && a.p_req_any[k] == a.p_req_any[k - 1] && a.p_prio[k] == a.p_prio[k - 1];
      for (int r = 0; r < a.R; ++r) {
        const int64_t q = a.p_req[(size_t)k * a.R + r];
        if (r < 3 || q > 0) chk |= 1ull << r;
        if (k > 0 && q != a.p_req[(size_t)(k - 1) * a.R + r]) same = false;
      }
      a.step_flags[k] = (same ? STEP_SAME : 0) | (hole ? 0 : STEP_CFULL) | (live ? 0 : STEP_CEMPTY) |
                        (a.p_valid[k] ? STEP_VALID : 0) | (a.p_req_any[k] ? STEP_ANY : 0);
      a.step_checked[k] = chk;
    }
  }
}

// per node: the carry at the start and the constant slot masks
__global__ void __launch_bounds__(256) preempt_nodes_kernel(const PreemptArgs a) {
  const Layout L = carve(a.state, a.N, a.NP, a.R);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.N; i += gridDim.x * blockDim.x) {
    for (int r = 0; r < a.R; ++r) {
      L.nfree[(size_t)r * a.N + i] = a.free0[(size_t)i * a.R + r] - a.nom_extra0[(size_t)i * a.R + r];
    }
    L.ncount[i] = a.count_free0[i] - a.nom_cnt0[i];
    uint64_t valid = 0, pdb = 0;
    for (int v = 0; v < a.V; ++v) {
      if (a.vict_valid[(size_t)i * a.V + v]) valid |= 1ull << v;
      if (a.vict_pdb[(size_t)i * a.V + v]) pdb |= 1ull << v;
    }
    L.alive[i] = valid;  // alive & valid: the reference's alive starts all-true
    L.pdb[i] = pdb;
    L.valid[i] = a.node_valid[i] ? 1 : 0;
  }
}

// --- the walk -------------------------------------------------------------------

__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src, size_t bytes) {
  for (size_t o = (size_t)threadIdx.x * 16; o < bytes; o += (size_t)blockDim.x * 16) {
    *(uint4*)(dst + o) = *(const uint4*)(src + o);
  }
}

__device__ __forceinline__ void copy8(uint8_t* dst, const uint8_t* src, size_t bytes) {
  for (size_t o = (size_t)threadIdx.x * 8; o < bytes; o += (size_t)blockDim.x * 8) {
    *(uint64_t*)(dst + o) = *(const uint64_t*)(src + o);
  }
}

template <int G, int RJ, int VJ>
__global__ void __launch_bounds__(PREEMPT_THREADS, 1) preempt_walk_kernel(const PreemptArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Key s_red[PREEMPT_WARPS];
  __shared__ int32_t s_ffc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & (G - 1);
  const int N = a.N, NP = a.NP, P = a.P, V = a.V;
  const unsigned FULL = 0xffffffffu;
  int levels = 0;
  while ((1 << levels) < NP) ++levels;

  uint8_t* base = a.resident ? smem : a.state;
  const size_t carry = preempt_carry_bytes(N, NP, a.R);
  if (a.resident) copy16(smem, a.state, carry);
  Layout L = carve(base, N, NP, a.R);
  L.vr = a.vict_req;
  L.vt = a.vict_ts;
  L.vp = a.vict_prio;
  if (a.victims_resident) {
    uint8_t* vb = smem + carry;
    const size_t nvr = (size_t)N * V * a.R * 8, nvt = (size_t)N * V * 8, nvp = (size_t)N * V * 4;
    copy8(vb, (const uint8_t*)a.vict_req, nvr);
    copy8(vb + nvr, (const uint8_t*)a.vict_ts, nvt);
    for (size_t o = tid; o < (size_t)N * V; o += blockDim.x) ((int32_t*)(vb + nvr + nvt))[o] = a.vict_prio[o];
    L.vr = (const int64_t*)vb;
    L.vt = (const int64_t*)(vb + nvr);
    L.vp = (const int32_t*)(vb + nvr + nvt);
  }
  __syncthreads();

  Spec<RJ> s;
  Row<RJ, VJ> cur, nxt;  // warp 0: the row chosen last (its carry updated) and the prefetched runner-up
  bool have_dirty = false, tree_valid = false;
  int ffc = 0;  // warp 0: valid nodes that fit as they stand (while the tree is valid)
  int64_t n_eval = 0, n_solo = 0, n_rebuild = 0;
  int32_t win = 0;
  int wbase = -64;

  // warp 0: re-evaluate the row the last step chose and rewrite its tree
  // path and fits-free count; returns its key and the least key excluding
  // it, fetching that key's row into `nxt` when `prefetch`
  auto reeval_dirty = [&](bool prefetch, Key& kc, Key& ko) {
    const int c = cur.i;
    const int leaf = NP + c;
    // inclusive prefix minimum over the levels of the path's sibling keys:
    // lane l ends with the least key under the path's node at level l + 1
    // less the leaf
    Key pm = lane < levels ? tree_key(L, N, NP, (leaf >> lane) ^ 1) : no_key();
    for (int off = 1; off < levels; off <<= 1) {
      const Key o = Key{__shfl_up_sync(FULL, pm.w0, off), __shfl_up_sync(FULL, pm.w1, off),
                        __shfl_up_sync(FULL, pm.w2, off)};
      if (lane >= off && key_lt(o, pm)) pm = o;
    }
    ko = shfl_key(pm, levels - 1);
    if (prefetch && !key_none(ko)) load_row<G, RJ, VJ>(L, a, key_row(ko), nxt, g);
    bool nff;
    uint64_t nvm;
    eval_row<G, RJ, VJ>(L, a, cur, s, lane, kc, nff, nvm);
    if (lane == 0) {
      L.key[c] = kc.w0;
      L.key[(size_t)N + c] = kc.w1;
      L.key[2 * (size_t)N + c] = kc.w2;
      L.ff[c] = nff ? 1 : 0;
      L.vm[c] = nvm;
    }
    if (cur.valid) ffc += (nff ? 1 : 0) - (cur.ff ? 1 : 0);
    else kc = no_key();
    cur.vm = nvm;
    cur.ff = nff;
    if (lane < levels) set_tree(L, NP, leaf >> (lane + 1), key_min(kc, pm));
    __syncwarp();
    n_eval += 1;
  };

  // warp 0: the step's outputs and, when a node is chosen, its carry update
  auto finish = [&](int k, bool found, bool any_ff, uint64_t vm) {
    if (lane == 0) {
      a.nodes_out[k] = found ? cur.i : -1;
      a.fits_free_out[k] = any_ff ? 1 : 0;
    }
    const uint64_t out = found ? vm : 0ull;
    for (int v = lane; v < V; v += 32) a.victims_out[(size_t)k * V + v] = (out >> v) & 1ull;
    if (found) commit_row<G, RJ, VJ>(L, a, cur, s, vm, lane);
    have_dirty = found;
    __syncwarp();
  };

  for (int k = 0; k < P; ++k) {
    if (k - wbase >= 32) {
      wbase = k;
      win = k + lane < P ? a.step_flags[k + lane] : 0;
    }
    const int fl = __shfl_sync(FULL, win, k - wbase);
    const int nk = k + 1 - wbase;
    const int fl_next = k + 1 >= P ? 0 : (nk < 32 ? __shfl_sync(FULL, win, nk) : a.step_flags[k + 1]);
    const bool solo = k > 0 && (fl & STEP_SAME) && (fl & (STEP_CFULL | STEP_CEMPTY));
    const bool next_solo = k + 1 < P && (fl_next & STEP_SAME) && (fl_next & (STEP_CFULL | STEP_CEMPTY));
    if (!(fl & STEP_SAME)) load_spec<RJ>(a, k, fl, g, G, s);

    if (solo) {
      // warp 0 alone: the spec and the gate are those of the tree
      if (warp != 0) continue;
      const bool full = (fl & STEP_CFULL) != 0;
      bool picked = false;
      uint64_t vm = 0;
      if (have_dirty) {
        Key kc, ko;
        reeval_dirty(full, kc, ko);
        if (full && (!key_none(kc) || !key_none(ko))) {
          picked = true;
          if (key_lt(kc, ko)) {
            vm = cur.vm;
          } else {
            cur = nxt;
            vm = cur.vm;
          }
        }
      } else if (full) {
        const Key root = tree_key(L, N, NP, 1);
        if (!key_none(root)) {
          load_row<G, RJ, VJ>(L, a, key_row(root), cur, g);
          picked = true;
          vm = cur.vm;
        }
      }
      const bool any_ff = full && ffc > 0;
      finish(k, picked && (fl & STEP_VALID) && !any_ff, any_ff, vm);
      n_solo += 1;
      continue;
    }

    // a block step: the cache's rows that changed, then a gated minimum
    __syncthreads();  // warp 0's carry updates are visible
    if (tid == 0) s_ffc = 0;
    if (!(fl & STEP_SAME)) {
      // a new spec: every row, a group a row, the next row fetched while
      // this one is evaluated (no row is dirty after it: cur and nxt serve)
      const int per = PREEMPT_WARPS * (32 / G);
      int i = warp * (32 / G) + (lane / G);
      load_row<G, RJ, VJ>(L, a, i, cur, g);
      for (int b = warp * (32 / G); b < N; b += per, i += per) {
        if (b + per < N) load_row<G, RJ, VJ>(L, a, i + per, nxt, g);
        Key kk;
        bool nff;
        uint64_t nvm;
        eval_row<G, RJ, VJ>(L, a, cur, s, lane, kk, nff, nvm);
        if (g == 0 && i < N) {
          L.key[i] = kk.w0;
          L.key[(size_t)N + i] = kk.w1;
          L.key[2 * (size_t)N + i] = kk.w2;
          L.ff[i] = nff ? 1 : 0;
          L.vm[i] = nvm;
        }
        if (b + per < N) cur = nxt;
      }
      have_dirty = false;
      tree_valid = false;
      n_eval += N;
    } else if (warp == 0 && have_dirty) {
      Key kc, ko;
      reeval_dirty(false, kc, ko);
    }
    __syncthreads();  // the cache is complete
    Key best = no_key();
    int local_ff = 0;
    for (int i = tid; i < N; i += PREEMPT_THREADS) {
      if (a.cand[(size_t)k * N + i] && L.valid[i]) {
        local_ff |= L.ff[i];
        const Key kk = Key{L.key[i], L.key[(size_t)N + i], L.key[2 * (size_t)N + i]};
        if (key_lt(kk, best)) best = kk;
      }
    }
    best = warp_min_key(best);
    if (lane == 0) s_red[warp] = best;
    const int any_ff = __syncthreads_or(local_ff);
    if (warp == 0) {
      Key w = lane < PREEMPT_WARPS ? s_red[lane] : no_key();
      w = warp_min_key(w);
      const bool found = !key_none(w) && (fl & STEP_VALID) && !any_ff;
      uint64_t vm = 0;
      if (found) {
        load_row<G, RJ, VJ>(L, a, key_row(w), cur, g);
        vm = cur.vm;
      }
      finish(k, found, any_ff != 0, vm);
    }
    if (next_solo && !tree_valid) {
      // the tree and the fits-free count over the cache, before a reuse run
      int cnt = 0;
      for (int i = tid; i < N; i += PREEMPT_THREADS) cnt += (L.valid[i] && L.ff[i]) ? 1 : 0;
      if (cnt) atomicAdd(&s_ffc, cnt);
      for (int m = NP >> 1; m >= 1; m >>= 1) {
        for (int n = m + tid; n < 2 * m; n += PREEMPT_THREADS) {
          set_tree(L, NP, n, key_min(tree_key(L, N, NP, 2 * n), tree_key(L, N, NP, 2 * n + 1)));
        }
        __syncthreads();
      }
      ffc = s_ffc;
      tree_valid = true;
      n_rebuild += 1;
    }
  }
  if (tid == 0) {
    a.walk_stats[0] = n_eval;
    a.walk_stats[1] = n_solo;
    a.walk_stats[2] = n_rebuild;
  }
}

template <int G, int RJ, int VJ>
static int launch_walk(const PreemptArgs& a, cudaStream_t stream) {
  const void* kernel = (const void*)preempt_walk_kernel<G, RJ, VJ>;
  const size_t bytes = a.resident ? (size_t)a.smem_bytes : 0;
  int rc = set_smem(kernel, bytes);
  if (rc) return rc;
  preempt_walk_kernel<G, RJ, VJ><<<1, PREEMPT_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ktpu_preempt_batch(const PreemptArgs* args, cudaStream_t stream) {
  const PreemptArgs& a = *args;
  if (a.P <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.V < 0 || a.V > 64 || a.R < 1 || a.R > 64 || a.NP < 2 || a.NP < a.N || (a.NP & (a.NP - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  if ((size_t)a.state_bytes != preempt_carry_bytes(a.N, a.NP, a.R)) return (int)cudaErrorInvalidValue;
  preempt_steps_kernel<<<a.P < 4096 ? a.P : 4096, 128, 0, stream>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  preempt_nodes_kernel<<<(a.N + 255) / 256, 256, 0, stream>>>(a);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (a.R <= 8) {
    return a.V <= 8 ? launch_walk<8, 1, 1>(a, stream) : launch_walk<8, 1, 8>(a, stream);
  }
  return a.R <= 32 ? launch_walk<32, 1, 2>(a, stream) : launch_walk<32, 2, 2>(a, stream);
}
