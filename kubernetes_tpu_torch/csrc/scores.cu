// Score kernel: the pods x nodes weighted priority matrix (int64).
//
// Replaces kubernetes_tpu/ops/scores.py:score_matrix for the priorities
// LeastRequested, MostRequested, BalancedResourceAllocation, NodeAffinity,
// TaintToleration, NodePreferAvoidPods, ImageLocality, ResourceLimits and
// RequestedToCapacityRatio (the Policy's piecewise-linear shape,
// ops/scores.py:183 requested_to_capacity_ratio), weighted by an int64
// vector (Policy weights; 0 = off) plus a constant `bias` (the
// SelectorSpread term-absent constant of ops/pipeline.py). With
// `n_components` > 0 the same launch writes each default priority's
// unweighted [U, N] plane instead (kubernetes_tpu/ops/scores.py:288
// score_components): out is then [n_components, U, N].
//
// Design: a grid of thread-block clusters, one cluster of C CTAs a spec
// row (C <= 8, the portable size, enough CTAs to fill the card: 8 at U =
// 128), split along the node axis in tiles of 256 nodes, one a thread; CTA
// c of the row takes tiles c, c + C, ... (TPC of them) when the row needs
// more tiles than the cluster has CTAs. Each CTA first stages its row's
// preferred terms, tolerations and image columns in shared memory. Pass
// 1 computes each
// node's raw NodeAffinity weight sum and intolerable PreferNoSchedule taint
// count ONCE, keeps them (shared memory, or a device scratch past ~135,000
// nodes) for pass 2, and takes their maxima over valid nodes (the
// NormalizeReduce denominators) with a block reduction; the row's maxima
// are then one reduction over the cluster through distributed shared
// memory (one cluster barrier; the CTAs' exit waits on a second, split
// barrier so no CTA leaves while another reads its slot). Pass 2
// normalizes the kept raw values and writes the weighted sum (or the
// planes). Integer divisions are Python floor divisions (jnp `//`), but
// the RTCR shape's segment interpolation truncates toward zero like Go
// (`go_div`: they differ on a down-sloping segment). Divisions are cut
// without changing a result: a resource's LeastRequested and
// MostRequested come from one division (q = floor(10 req / cap), least =
// 10 - q - (remainder != 0)); a non-negative division whose operands are
// below 2^53 goes through float64 and one exact correction step, and the
// NormalizeReduce division by the row's maximum through its float64
// reciprocal and exact corrections. BalancedAllocation is float64,
// truncated like the reference, and the library is built with -fmad=false
// so no contraction changes a rounding. The RTCR shape (at most 101
// points) and its resources ride in the argument struct, so a Policy with
// RTCR still scores in one launch a batch.
//
// Bound: memory — it writes U*N int64 (C*U*N with planes) and reads the
// node bank once per spec row.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define W_LEAST 0
#define W_MOST 1
#define W_BALANCED 2
#define W_NODE_AFFINITY 3
#define W_TAINT 4
#define W_AVOID 5
#define W_IMAGE 6
#define W_LIMITS 7

#define N_WEIGHTS 8
#define RTCR_MAX_POINTS 101
#define RTCR_MAX_RESOURCES 8

#define IMAGE_MIN (23LL * 1024 * 1024)
#define IMAGE_MAX (1000LL * 1024 * 1024)

struct ScoreArgs {
  const uint8_t* n_valid;
  const int32_t* n_name_id;
  const int64_t* n_alloc;          // [N, R]
  const int64_t* n_nonzero_req;    // [N, 2]
  const int32_t* n_label_vals;     // [N, K]
  const int64_t* n_label_num;
  const uint8_t* n_label_num_ok;
  const int32_t* n_taint_key;      // [N, T]
  const int32_t* n_taint_val;
  const int32_t* n_taint_effect;
  const int32_t* n_avoid_kind;     // [N, AV]
  const int32_t* n_avoid_uid;
  const int64_t* n_image_scaled;   // [N, V_img] (null when the bank has none)
  const int64_t* p_scoring_req;    // [U, 2]
  const int64_t* p_limit_req;      // [U, 2]
  const uint8_t* p_pref_valid;     // [U, PT]
  const int32_t* p_pref_weight;
  const int32_t* p_pref_req_op;    // [U, PT, REQS]
  const int32_t* p_pref_req_slot;
  const int32_t* p_pref_req_vals;  // [U, PT, REQS, VALS]
  const int64_t* p_pref_req_num;
  const int32_t* p_tol_key;        // [U, TL]
  const int32_t* p_tol_op;
  const int32_t* p_tol_val;
  const int32_t* p_tol_effect;
  const uint8_t* p_tol_valid;
  const int32_t* p_ctrl_kind;      // [U]
  const int32_t* p_ctrl_uid;
  const int32_t* p_image_ids;      // [U, CI]
  int64_t* out;                    // [U, N]
  uint8_t* raw;                    // [U, C, 12 * TPC * SCORE_TILE] raw values when not in shared memory
  int64_t weights[N_WEIGHTS];
  int64_t bias;
  // RequestedToCapacityRatio: its weight (0 = off), the shape's points
  // (utilization, score) in increasing utilization, and the resources as
  // (node-bank column, weight) pairs
  int64_t w_rtcr;
  int64_t rtcr_res_w[RTCR_MAX_RESOURCES];
  int32_t rtcr_res_col[RTCR_MAX_RESOURCES];
  int32_t rtcr_u[RTCR_MAX_POINTS];
  int32_t rtcr_s[RTCR_MAX_POINTS];
  int32_t rtcr_points, rtcr_res;
  // 0: the weighted sum; > 0: that many unweighted component planes
  int32_t n_components;
  // the launch: C CTAs a spec row (one cluster), TPC node tiles a CTA, the
  // raw NodeAffinity / TaintToleration values in shared memory or not, and
  // the dynamic shared memory (ops/scores.score_layout)
  int32_t C, TPC, raw_shared, smem;
  int32_t N, U, R, K, T, TL, PT, REQS, VALS, AV, CI, V_img;
};

#define SCORE_TILE 256  // nodes a tile: one a thread

// the spec row's preferred terms and tolerations, staged in shared memory
struct Staged {
  const int64_t* num;    // [PT, REQS]
  const int32_t* op;     // [PT, REQS]
  const int32_t* slot;   // [PT, REQS]
  const int32_t* vals;   // [PT, REQS, VALS]
  const int32_t* w;      // [PT]
  const int32_t* tk;     // [TL]
  const int32_t* to;
  const int32_t* tv;
  const int32_t* te;
  const uint8_t* pv;     // [PT]
  const uint8_t* tvalid; // [TL]
};

// NodeAffinity map: summed weights of the preferred terms matching node n
__device__ int64_t affinity_raw(const ScoreArgs& a, const Staged& st, int n) {
  const int32_t* lv = a.n_label_vals + (int64_t)n * a.K;
  const int64_t* ln = a.n_label_num + (int64_t)n * a.K;
  const uint8_t* lok = a.n_label_num_ok + (int64_t)n * a.K;
  const int32_t name = a.n_name_id[n];
  int64_t sum = 0;
  for (int t = 0; t < a.PT; ++t) {
    if (!st.pv[t]) continue;
    const int base = t * a.REQS;
    bool all_req = true;
    for (int q = 0; q < a.REQS && all_req; ++q) {
      all_req = eval_requirement(st.op[base + q], st.slot[base + q], st.vals + (int64_t)(base + q) * a.VALS, a.VALS,
                                 st.num[base + q], lv, ln, lok, a.K, name);
    }
    if (all_req) sum += st.w[t];
  }
  return sum;
}

// TaintToleration map: PreferNoSchedule taints of node n that no eligible
// toleration (effect empty or PreferNoSchedule) tolerates
__device__ int32_t taint_raw(const ScoreArgs& a, const Staged& st, int n) {
  int32_t count = 0;
  for (int t0 = 0; t0 < a.T; t0 += 8) {
    // the effects of eight taints loaded together, then the few to test
    int32_t eff[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) eff[q] = t0 + q < a.T ? a.n_taint_effect[(int64_t)n * a.T + t0 + q] : 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int64_t i = (int64_t)n * a.T + t0 + q;
      if (eff[q] == EFFECT_PREFER_NO_SCHEDULE &&
          !tolerated(st.tk, st.to, st.tv, st.te, st.tvalid, a.TL, a.n_taint_key[i], a.n_taint_val[i],
                     EFFECT_PREFER_NO_SCHEDULE)) {
        ++count;
      }
    }
  }
  return count;
}

// floor(a / b) for 0 <= a and 1 <= b below 2^53: the float64 quotient is
// within one of the truth and one exact correction step fixes it
__device__ __forceinline__ int64_t div_small(int64_t a, int64_t b) {
  int64_t q = (int64_t)((double)a / (double)b);
  const int64_t r = a - q * b;
  if (r < 0) --q;
  else if (r >= b) ++q;
  return q;
}

// Python's floor division, through float64 where the operands allow it
__device__ __forceinline__ int64_t floordiv_fast(int64_t a, int64_t b) {
  if (a >= 0 && b >= 1 && ((a | b) >> 53) == 0) return div_small(a, b);
  return floordiv(a, b);
}

// LeastRequested and MostRequested of one resource from one division:
// q = floor(10 req / cap) and least = floor(10 (cap - req) / cap) =
// 10 - q - (10 req - q cap != 0), exact while 10 * cap cannot overflow
__device__ __forceinline__ void least_most(int64_t req, int64_t cap, int64_t& least, int64_t& most) {
  if (!(cap > 0 && req <= cap)) {
    least = most = 0;
    return;
  }
  if (req >= 0 && ((req | cap) >> 59) == 0) {
    const int64_t q = floordiv_fast(req * MAX_NODE_SCORE, cap);
    most = q;
    least = MAX_NODE_SCORE - q - (req * MAX_NODE_SCORE - q * cap != 0 ? 1 : 0);
    return;
  }
  least = floordiv((cap - req) * MAX_NODE_SCORE, cap);
  most = floordiv(req * MAX_NODE_SCORE, cap);
}

// Go integer division: truncates toward zero (floordiv floors); the two
// differ when exactly one operand is negative (a down-sloping segment)
__device__ __forceinline__ int64_t go_div(int64_t a, int64_t b) {
  const int64_t x = a < 0 ? -a : a, y = b < 0 ? -b : b;
  const int64_t q = (x >= 0 && y >= 1 && ((x | y) >> 53) == 0) ? div_small(x, y) : x / y;
  return ((a < 0) != (b < 0)) ? -q : q;
}

// buildBrokenLinearFunction: the first point with p <= u_i decides; between
// points, linear interpolation; past the last point, its score
__device__ __forceinline__ int64_t broken_linear(const ScoreArgs& a, int64_t p) {
  for (int i = 0; i < a.rtcr_points; ++i) {
    if (p <= a.rtcr_u[i]) {
      if (i == 0) return a.rtcr_s[0];
      const int64_t u0 = a.rtcr_u[i - 1], s0 = a.rtcr_s[i - 1];
      return s0 + go_div((a.rtcr_s[i] - s0) * (p - u0), a.rtcr_u[i] - u0);
    }
  }
  return a.rtcr_s[a.rtcr_points - 1];
}

// RequestedToCapacityRatio (requested_to_capacity_ratio.go:115-167): per
// resource the utilization% (100 when the capacity is 0 or exceeded)
// through the shape; resources scoring 0 leave both sums; the weighted
// mean rounds half away from zero
__device__ int64_t rtcr_score(const ScoreArgs& a, int u, int n) {
  int64_t node_score = 0, weight_sum = 0;
  for (int r = 0; r < a.rtcr_res; ++r) {
    const int col = a.rtcr_res_col[r];
    const int64_t cap = a.n_alloc[(int64_t)n * a.R + col];
    const int64_t req = a.n_nonzero_req[(int64_t)n * 2 + col] + a.p_scoring_req[(int64_t)u * 2 + col];
    const int64_t p =
        (cap == 0 || req > cap) ? 100 : 100 - floordiv_fast((cap - req) * 100, cap > 1 ? cap : 1);
    const int64_t s = broken_linear(a, p);
    if (s > 0) {
      node_score += s * a.rtcr_res_w[r];
      weight_sum += a.rtcr_res_w[r];
    }
  }
  return weight_sum > 0 ? floordiv_fast(2 * node_score + weight_sum, 2 * weight_sum) : 0;
}

// NormalizeReduce(10, reverse): scale by the row max over valid nodes;
// `rinv` is 1 / row_max in float64 (the quotient through it is within a
// few units of the truth, corrected exactly)
__device__ __forceinline__ int64_t normalize(int64_t s, int64_t row_max, double rinv, bool reverse) {
  int64_t scaled = 0;
  if (row_max > 0) {
    const int64_t x = MAX_NODE_SCORE * s;
    if (x >= 0 && ((x | row_max) >> 53) == 0) {
      int64_t q = (int64_t)((double)x * rinv);
      int64_t r = x - q * row_max;
      while (r < 0) {
        --q;
        r += row_max;
      }
      while (r >= row_max) {
        ++q;
        r -= row_max;
      }
      scaled = q;
    } else {
      scaled = floordiv(x, row_max);
    }
  }
  if (!reverse) return scaled;
  return row_max > 0 ? MAX_NODE_SCORE - scaled : MAX_NODE_SCORE;
}

__device__ __forceinline__ int64_t block_max(int64_t v, int64_t* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < SCORE_TILE / 32 ? red[lane] : INT64_MIN;
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return __shfl_sync(0xffffffffu, v, 0);
}

// the dynamic shared memory of a CTA, in this order: (raw_shared) the raw
// NodeAffinity sums [TPC * SCORE_TILE] int64; the staged requirement
// operands [PT, REQS] int64; (raw_shared) the raw taint counts [TPC *
// SCORE_TILE] int32; the staged operators, slots [PT, REQS], values [PT,
// REQS, VALS], weights [PT] and tolerations (key, op, value, effect [TL])
// int32; the image ids' table columns [CI] int32; the term and toleration
// valid bits. ops/scores.score_layout computes the same bytes.
__host__ __device__ __forceinline__ size_t score_smem_bytes(const ScoreArgs& a) {
  const size_t pr = (size_t)a.PT * a.REQS;
  size_t bytes = 8 * pr + 4 * (2 * pr + pr * a.VALS + a.PT + 4 * (size_t)a.TL + a.CI) + a.PT + a.TL;
  if (a.raw_shared) bytes += 12 * (size_t)a.TPC * SCORE_TILE;
  return bytes;
}

__global__ void __launch_bounds__(SCORE_TILE) score_matrix_kernel(const ScoreArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int64_t red[SCORE_TILE / 32];
  __shared__ int64_t part[2];  // this CTA's maxima, read by the row's cluster
  __shared__ int64_t rmax[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int u = blockIdx.y;
  const int c = blockIdx.x;  // the CTA's rank in its row's cluster
  const int C = a.C, tid = threadIdx.x;
  const bool comp = a.n_components > 0;
  // a component plane or a non-zero weight asks for a priority
  bool on[N_WEIGHTS];
#pragma unroll
  for (int k = 0; k < N_WEIGHTS; ++k) on[k] = comp ? k < a.n_components : a.weights[k] != 0;
  const bool need_aff = on[W_NODE_AFFINITY];
  const bool need_taint = on[W_TAINT];
  const bool need_raw = need_aff || need_taint;

  // stage the row's preferred terms and tolerations
  const size_t pr = (size_t)a.PT * a.REQS;
  const size_t tile_raw = (size_t)a.TPC * SCORE_TILE;
  uint8_t* at = dyn;
  int64_t* aff_raw = nullptr;
  int32_t* taint_raw_v = nullptr;
  if (a.raw_shared) {
    aff_raw = (int64_t*)at;
    at += 8 * tile_raw;
  } else if (need_raw) {
    uint8_t* mine = a.raw + ((size_t)u * C + c) * tile_raw * 12;
    aff_raw = (int64_t*)mine;
    taint_raw_v = (int32_t*)(mine + 8 * tile_raw);
  }
  int64_t* s_num = (int64_t*)at;
  at += 8 * pr;
  if (a.raw_shared) {
    taint_raw_v = (int32_t*)at;
    at += 4 * tile_raw;
  }
  int32_t* s_op = (int32_t*)at;
  int32_t* s_slot = s_op + pr;
  int32_t* s_vals = s_slot + pr;
  int32_t* s_w = s_vals + pr * a.VALS;
  int32_t* s_tk = s_w + a.PT;
  int32_t* s_to = s_tk + a.TL;
  int32_t* s_tv = s_to + a.TL;
  int32_t* s_te = s_tv + a.TL;
  int32_t* s_img = s_te + a.TL;
  uint8_t* s_pv = (uint8_t*)(s_img + a.CI);
  uint8_t* s_tvalid = s_pv + a.PT;
  for (size_t i = tid; i < pr; i += SCORE_TILE) {
    s_num[i] = a.p_pref_req_num[u * pr + i];
    s_op[i] = a.p_pref_req_op[u * pr + i];
    s_slot[i] = a.p_pref_req_slot[u * pr + i];
  }
  for (size_t i = tid; i < pr * a.VALS; i += SCORE_TILE) s_vals[i] = a.p_pref_req_vals[u * pr * a.VALS + i];
  for (int i = tid; i < a.PT; i += SCORE_TILE) {
    s_w[i] = a.p_pref_weight[(size_t)u * a.PT + i];
    s_pv[i] = a.p_pref_valid[(size_t)u * a.PT + i];
  }
  for (int i = tid; i < a.TL; i += SCORE_TILE) {
    const size_t j = (size_t)u * a.TL + i;
    s_tk[i] = a.p_tol_key[j];
    s_to[i] = a.p_tol_op[j];
    s_tv[i] = a.p_tol_val[j];
    s_te[i] = a.p_tol_effect[j];
    s_tvalid[i] = a.p_tol_valid[j];
  }
  for (int i = tid; i < a.CI; i += SCORE_TILE) {
    // ids beyond the table width are images no node has: column 0
    const int32_t id = a.p_image_ids[(size_t)u * a.CI + i];
    s_img[i] = (id > 0 && id < a.V_img) ? id : 0;
  }
  __syncthreads();
  const Staged st{s_num, s_op, s_slot, s_vals, s_w, s_tk, s_to, s_tv, s_te, s_pv, s_tvalid};

  // pass 1: each raw value once, kept for pass 2; the row's NormalizeReduce
  // denominators (max over valid nodes; an invalid node counts as 0, like
  // jnp.where(valid, score, 0)) over the cluster
  int64_t aff_max = 0, taint_max = 0;
  double aff_rinv = 0.0, taint_rinv = 0.0;
  if (need_raw) {
    int64_t am = INT64_MIN, tm = INT64_MIN;
    for (int t = 0; t < a.TPC; ++t) {
      const int n = (c + t * C) * SCORE_TILE + tid;
      if (n >= a.N) continue;
      const bool valid = a.n_valid[n];
      const int64_t ar = need_aff ? affinity_raw(a, st, n) : 0;
      const int32_t tr = need_taint ? taint_raw(a, st, n) : 0;
      aff_raw[t * SCORE_TILE + tid] = ar;
      taint_raw_v[t * SCORE_TILE + tid] = tr;
      const int64_t av = valid ? ar : 0, tv = valid ? (int64_t)tr : 0;
      am = av > am ? av : am;
      tm = tv > tm ? tv : tm;
    }
    am = block_max(am, red);
    __syncthreads();
    tm = block_max(tm, red);
    if (tid == 0) {
      part[0] = am;
      part[1] = tm;
    }
    if (C > 1) {
      cluster.sync();  // every CTA's maxima are in its slot
      if (tid < 2) {
        int64_t m = INT64_MIN;
        for (int r = 0; r < C; ++r) {
          const int64_t o = *cluster.map_shared_rank(&part[tid], r);
          m = o > m ? o : m;
        }
        rmax[tid] = m;
      }
      cluster_arrive();  // this CTA's reads are done (waited on at exit)
    } else if (tid < 2) {
      rmax[tid] = part[tid];
    }
    __syncthreads();
    aff_max = rmax[0];
    taint_max = rmax[1];
    aff_rinv = aff_max > 0 ? 1.0 / (double)aff_max : 0.0;
    taint_rinv = taint_max > 0 ? 1.0 / (double)taint_max : 0.0;
  }

  const int64_t s_cpu = a.p_scoring_req[(int64_t)u * 2 + 0];
  const int64_t s_mem = a.p_scoring_req[(int64_t)u * 2 + 1];
  const int64_t l_cpu = a.p_limit_req[(int64_t)u * 2 + 0];
  const int64_t l_mem = a.p_limit_req[(int64_t)u * 2 + 1];
  const int32_t kind = a.p_ctrl_kind[u];
  const int32_t uid = a.p_ctrl_uid[u];
  const int64_t plane = (int64_t)a.U * a.N;

  // pass 2: each asked-for priority, then the weighted sum or the planes
  for (int t = 0; t < a.TPC; ++t) {
    const int n = (c + t * C) * SCORE_TILE + tid;
    if (n >= a.N) continue;
    const int64_t ac = a.n_alloc[(int64_t)n * a.R + 0];
    const int64_t am = a.n_alloc[(int64_t)n * a.R + 1];
    const int64_t rc = a.n_nonzero_req[(int64_t)n * 2 + 0] + s_cpu;
    const int64_t rm = a.n_nonzero_req[(int64_t)n * 2 + 1] + s_mem;
    int64_t v[N_WEIGHTS] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (on[W_LEAST] || on[W_MOST]) {
      int64_t lc, mc, lm, mm;
      least_most(rc, ac, lc, mc);
      least_most(rm, am, lm, mm);
      v[W_LEAST] = on[W_LEAST] ? floordiv(lc + lm, 2) : 0;
      v[W_MOST] = on[W_MOST] ? floordiv(mc + mm, 2) : 0;
    }
    if (on[W_BALANCED]) {
      const double cpu_frac = ac > 0 ? (double)rc / (double)(ac > 1 ? ac : 1) : 1.0;
      const double mem_frac = am > 0 ? (double)rm / (double)(am > 1 ? am : 1) : 1.0;
      const double diff = fabs(cpu_frac - mem_frac);
      const int64_t score = (int64_t)((1.0 - diff) * (double)MAX_NODE_SCORE);
      v[W_BALANCED] = (cpu_frac >= 1.0 || mem_frac >= 1.0) ? 0 : score;
    }
    if (need_aff) v[W_NODE_AFFINITY] = normalize(aff_raw[t * SCORE_TILE + tid], aff_max, aff_rinv, false);
    if (need_taint) v[W_TAINT] = normalize(taint_raw_v[t * SCORE_TILE + tid], taint_max, taint_rinv, true);
    if (on[W_AVOID]) {
      bool hit = false;
      for (int e = 0; e < a.AV; ++e) {
        const int64_t i = (int64_t)n * a.AV + e;
        hit |= (a.n_avoid_kind[i] == kind) && (a.n_avoid_uid[i] == uid);
      }
      v[W_AVOID] = (kind > 0 && hit) ? 0 : MAX_NODE_SCORE;
    }
    if (on[W_IMAGE]) {
      int64_t sum = 0;
#pragma unroll 4
      for (int ci = 0; ci < a.CI; ++ci) sum += a.n_image_scaled[(int64_t)n * a.V_img + s_img[ci]];
      const int64_t clamped = sum < IMAGE_MIN ? IMAGE_MIN : (sum > IMAGE_MAX ? IMAGE_MAX : sum);
      v[W_IMAGE] = floordiv(MAX_NODE_SCORE * (clamped - IMAGE_MIN), IMAGE_MAX - IMAGE_MIN);
    }
    if (on[W_LIMITS]) {
      const bool cpu_ok = l_cpu != 0 && ac != 0 && l_cpu <= ac;
      const bool mem_ok = l_mem != 0 && am != 0 && l_mem <= am;
      v[W_LIMITS] = (cpu_ok || mem_ok) ? 1 : 0;
    }
    if (comp) {
#pragma unroll
      for (int k = 0; k < N_WEIGHTS; ++k) {
        if (k < a.n_components) a.out[k * plane + (int64_t)u * a.N + n] = v[k];
      }
      continue;
    }
    int64_t total = a.bias;
#pragma unroll
    for (int k = 0; k < N_WEIGHTS; ++k) total += a.weights[k] * v[k];
    if (a.w_rtcr) total += a.w_rtcr * rtcr_score(a, u, n);
    a.out[(int64_t)u * a.N + n] = total;
  }
  if (need_raw && C > 1) cluster_wait();  // no CTA leaves while another may read its maxima
}

extern "C" int ktpu_score_matrix(const ScoreArgs* args, cudaStream_t stream) {
  const ScoreArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  const int tiles = (a.N + SCORE_TILE - 1) / SCORE_TILE;
  if (a.C < 1 || a.C > PORTABLE_CLUSTER || (size_t)a.C * a.TPC < (size_t)tiles ||
      score_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster((const void*)score_matrix_kernel, a.C, SCORE_TILE, (size_t)a.smem, a, stream, a.U);
}
