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
// Design: one block per spec row u walks the node axis twice. Pass 1 sums
// the raw NodeAffinity weights and counts intolerable PreferNoSchedule
// taints per node and takes their maxima over valid nodes (the
// NormalizeReduce denominators) with a block reduction; pass 2 recomputes
// the raw values, normalizes them and writes the weighted sum (or the
// planes). Integer divisions are Python floor divisions (jnp `//`), but
// the RTCR shape's segment interpolation truncates toward zero like Go
// (`go_div`: they differ on a down-sloping segment); BalancedAllocation is
// float64, truncated like the reference, and the library is built with
// -fmad=false so no contraction changes a rounding. The RTCR shape (at
// most 101 points) and its resources ride in the argument struct, so a
// Policy with RTCR still scores in one launch a batch.
//
// Bound: memory — it writes U*N int64 (C*U*N with planes) and reads the
// node bank once per spec row; pass 1 re-reads only what
// NodeAffinity/TaintToleration need.
#include "common.cuh"

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
  int32_t N, U, R, K, T, TL, PT, REQS, VALS, AV, CI, V_img;
};

#define THREADS 256

// NodeAffinity map: summed weights of the preferred terms matching node n
__device__ int64_t affinity_raw(const ScoreArgs& a, int u, int n) {
  const int32_t* lv = a.n_label_vals + (int64_t)n * a.K;
  const int64_t* ln = a.n_label_num + (int64_t)n * a.K;
  const uint8_t* lok = a.n_label_num_ok + (int64_t)n * a.K;
  int64_t sum = 0;
  for (int t = 0; t < a.PT; ++t) {
    if (!a.p_pref_valid[(int64_t)u * a.PT + t]) continue;
    const int64_t base = ((int64_t)u * a.PT + t) * a.REQS;
    bool all_req = true;
    for (int q = 0; q < a.REQS && all_req; ++q) {
      all_req = eval_requirement(
          a.p_pref_req_op[base + q], a.p_pref_req_slot[base + q],
          a.p_pref_req_vals + (base + q) * a.VALS, a.VALS, a.p_pref_req_num[base + q],
          lv, ln, lok, a.K, a.n_name_id[n]);
    }
    if (all_req) sum += a.p_pref_weight[(int64_t)u * a.PT + t];
  }
  return sum;
}

// TaintToleration map: PreferNoSchedule taints of node n that no eligible
// toleration (effect empty or PreferNoSchedule) tolerates
__device__ int64_t taint_raw(const ScoreArgs& a, int u, int n) {
  const int32_t* tk = a.p_tol_key + (int64_t)u * a.TL;
  const int32_t* to = a.p_tol_op + (int64_t)u * a.TL;
  const int32_t* tv = a.p_tol_val + (int64_t)u * a.TL;
  const int32_t* te = a.p_tol_effect + (int64_t)u * a.TL;
  const uint8_t* tvalid = a.p_tol_valid + (int64_t)u * a.TL;
  int64_t count = 0;
  for (int t = 0; t < a.T; ++t) {
    const int64_t i = (int64_t)n * a.T + t;
    if (a.n_taint_effect[i] == EFFECT_PREFER_NO_SCHEDULE &&
        !tolerated(tk, to, tv, te, tvalid, a.TL, a.n_taint_key[i], a.n_taint_val[i],
                   EFFECT_PREFER_NO_SCHEDULE)) {
      ++count;
    }
  }
  return count;
}

__device__ __forceinline__ int64_t least_score(int64_t req, int64_t cap) {
  const bool ok = cap > 0 && req <= cap;
  return ok ? floordiv((cap - req) * MAX_NODE_SCORE, cap > 1 ? cap : 1) : 0;
}

__device__ __forceinline__ int64_t most_score(int64_t req, int64_t cap) {
  const bool ok = cap > 0 && req <= cap;
  return ok ? floordiv(req * MAX_NODE_SCORE, cap > 1 ? cap : 1) : 0;
}

// Go integer division: truncates toward zero (floordiv floors); the two
// differ when exactly one operand is negative (a down-sloping segment)
__device__ __forceinline__ int64_t go_div(int64_t a, int64_t b) {
  const int64_t q = (a < 0 ? -a : a) / (b < 0 ? -b : b);
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
    const int64_t p = (cap == 0 || req > cap) ? 100 : 100 - floordiv((cap - req) * 100, cap > 1 ? cap : 1);
    const int64_t s = broken_linear(a, p);
    if (s > 0) {
      node_score += s * a.rtcr_res_w[r];
      weight_sum += a.rtcr_res_w[r];
    }
  }
  return weight_sum > 0 ? floordiv(2 * node_score + weight_sum, 2 * weight_sum) : 0;
}

// NormalizeReduce(10, reverse): scale by the row max over valid nodes
__device__ __forceinline__ int64_t normalize(int64_t s, int64_t row_max, bool reverse) {
  const int64_t scaled = row_max > 0 ? floordiv(MAX_NODE_SCORE * s, row_max > 1 ? row_max : 1) : 0;
  if (!reverse) return scaled;
  return row_max > 0 ? MAX_NODE_SCORE - scaled : MAX_NODE_SCORE;
}

__device__ __forceinline__ int64_t block_max(int64_t v, int64_t* smem) {
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? smem[lane] : INT64_MIN;
    for (int off = 16; off > 0; off >>= 1) {
      const int64_t o = __shfl_down_sync(0xffffffffu, v, off);
      v = o > v ? o : v;
    }
    if (lane == 0) smem[0] = v;
  }
  __syncthreads();
  const int64_t out = smem[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(THREADS) score_matrix_kernel(const ScoreArgs a) {
  __shared__ int64_t smem[THREADS / 32];
  const int u = blockIdx.x;
  const bool comp = a.n_components > 0;
  // a component plane or a non-zero weight asks for a priority
  bool on[N_WEIGHTS];
#pragma unroll
  for (int k = 0; k < N_WEIGHTS; ++k) on[k] = comp ? k < a.n_components : a.weights[k] != 0;
  const bool need_aff = on[W_NODE_AFFINITY];
  const bool need_taint = on[W_TAINT];

  // pass 1: NormalizeReduce denominators (max over valid nodes; an invalid
  // node counts as 0, like jnp.where(valid, score, 0))
  int64_t aff_max = INT64_MIN, taint_max = INT64_MIN;
  if (need_aff || need_taint) {
    for (int n = threadIdx.x; n < a.N; n += THREADS) {
      const bool valid = a.n_valid[n];
      if (need_aff) {
        const int64_t s = valid ? affinity_raw(a, u, n) : 0;
        aff_max = s > aff_max ? s : aff_max;
      }
      if (need_taint) {
        const int64_t s = valid ? taint_raw(a, u, n) : 0;
        taint_max = s > taint_max ? s : taint_max;
      }
    }
    aff_max = block_max(aff_max, smem);
    taint_max = block_max(taint_max, smem);
  }

  const int64_t s_cpu = a.p_scoring_req[(int64_t)u * 2 + 0];
  const int64_t s_mem = a.p_scoring_req[(int64_t)u * 2 + 1];
  const int64_t l_cpu = a.p_limit_req[(int64_t)u * 2 + 0];
  const int64_t l_mem = a.p_limit_req[(int64_t)u * 2 + 1];
  const int32_t kind = a.p_ctrl_kind[u];
  const int32_t uid = a.p_ctrl_uid[u];
  const int64_t plane = (int64_t)a.U * a.N;

  // pass 2: each asked-for priority, then the weighted sum or the planes
  for (int n = threadIdx.x; n < a.N; n += THREADS) {
    const int64_t ac = a.n_alloc[(int64_t)n * a.R + 0];
    const int64_t am = a.n_alloc[(int64_t)n * a.R + 1];
    const int64_t rc = a.n_nonzero_req[(int64_t)n * 2 + 0] + s_cpu;
    const int64_t rm = a.n_nonzero_req[(int64_t)n * 2 + 1] + s_mem;
    int64_t v[N_WEIGHTS] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (on[W_LEAST]) v[W_LEAST] = floordiv(least_score(rc, ac) + least_score(rm, am), 2);
    if (on[W_MOST]) v[W_MOST] = floordiv(most_score(rc, ac) + most_score(rm, am), 2);
    if (on[W_BALANCED]) {
      const double cpu_frac = ac > 0 ? (double)rc / (double)(ac > 1 ? ac : 1) : 1.0;
      const double mem_frac = am > 0 ? (double)rm / (double)(am > 1 ? am : 1) : 1.0;
      const double diff = fabs(cpu_frac - mem_frac);
      const int64_t score = (int64_t)((1.0 - diff) * (double)MAX_NODE_SCORE);
      v[W_BALANCED] = (cpu_frac >= 1.0 || mem_frac >= 1.0) ? 0 : score;
    }
    if (need_aff) v[W_NODE_AFFINITY] = normalize(affinity_raw(a, u, n), aff_max, false);
    if (need_taint) v[W_TAINT] = normalize(taint_raw(a, u, n), taint_max, true);
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
      for (int c = 0; c < a.CI; ++c) {
        const int32_t id = a.p_image_ids[(int64_t)u * a.CI + c];
        // ids beyond the table width are images no node has: column 0
        const int32_t img = (id > 0 && id < a.V_img) ? id : 0;
        sum += a.n_image_scaled[(int64_t)n * a.V_img + img];
      }
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
      for (int c = 0; c < N_WEIGHTS; ++c) {
        if (c < a.n_components) a.out[c * plane + (int64_t)u * a.N + n] = v[c];
      }
      continue;
    }
    int64_t total = a.bias;
#pragma unroll
    for (int k = 0; k < N_WEIGHTS; ++k) total += a.weights[k] * v[k];
    if (a.w_rtcr) total += a.w_rtcr * rtcr_score(a, u, n);
    a.out[(int64_t)u * a.N + n] = total;
  }
}

extern "C" int ktpu_score_matrix(const ScoreArgs* args, cudaStream_t stream) {
  if (args->U > 0 && args->N > 0) {
    score_matrix_kernel<<<args->U, THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
