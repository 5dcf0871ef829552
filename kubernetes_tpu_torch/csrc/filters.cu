// Filter kernel: the pods x nodes feasibility mask.
//
// Replaces kubernetes_tpu/ops/filters.py:combined_mask (over filter_masks):
// the AND of CheckNodeUnschedulable, PodFitsHost, PodFitsHostPorts,
// PodMatchNodeSelector (nodeSelector pairs + required node affinity),
// PodFitsResources and PodToleratesNodeTaints, each gated by a bit of
// `predicates`, masked by the spec row's validity and by node
// `valid & ~fallback`. With `sel_out` set, the same launch also writes the
// RAW PodMatchNodeSelector predicate (ops/filters.py:pod_match_node_selector,
// unmasked by node or pod validity) for every pair: the topology spread
// programs' candidate set.
//
// Design: a CTA works a tile of UT spec rows x NT nodes, one node a thread
// (grid: node tiles along x, row tiles along y). Its warps first stage the
// tile's spec rows into shared memory with their live lanes compacted (the
// valid tolerations, the selector pairs with a slot, the requirements of
// valid required-affinity terms with an operator, each with its value
// lanes less repeated -1 padding, the compared resource slots, the ports >
// 0), and list the label slots those rows read. Each thread loads its
// node's fields once for the whole tile into registers — the validity,
// name, unschedulable flag and pod-count test, the cpu / memory /
// ephemeral free resources, the first blocking (NoSchedule / NoExecute)
// taints and the labels at the first listed slots — and then evaluates its
// node against every row of the tile in the reference's order of
// predicates; node ports (read only for a row with ports), scalar
// resources, further taints and labels come from device memory. Shared
// memory holds only the staged rows, so many CTAs stay resident: a row's
// test is a chain of dependent shared-memory reads, hidden by other warps. Stores stay coalesced: a row's NT mask bytes are
// adjacent. The pod count and allowed pods are read at the width the
// caller holds them (int32, or int64 in a carried batch state): no
// conversion launch. Where a row's compacted lanes and the node side
// exceed the shared-memory budget even at UT = 1 (widths the encoder can
// grow to), the same kernel evaluates every pair from device memory
// (`staged` = 0), counted by the wrapper.
//
// Bound: operations over live lanes (chip_smoke.py's filter_work); it
// writes U*N bytes and reads the node bank once a row tile.
#include "common.cuh"

#define PRED_UNSCHEDULABLE 1
#define PRED_HOST 2
#define PRED_PORTS 4
#define PRED_SELECTOR 8
#define PRED_RESOURCES 16
#define PRED_TAINTS 32

// FilterArgs.counts64 bits: the width of pod_count and allowed_pods
#define POD_COUNT_64 1
#define ALLOWED_PODS_64 2

struct FilterArgs {
  // node bank [N, ...]
  const uint8_t* n_valid;
  const uint8_t* n_fallback;
  const int32_t* n_name_id;
  const int64_t* n_alloc;          // [N, R]
  const int64_t* n_requested;      // [N, R]
  const void* n_allowed_pods;      // int32 or int64 (counts64)
  const void* n_pod_count;         // int32 or int64 (counts64)
  const int32_t* n_label_vals;     // [N, K]
  const int64_t* n_label_num;      // [N, K]
  const uint8_t* n_label_num_ok;   // [N, K]
  const int32_t* n_taint_key;      // [N, T]
  const int32_t* n_taint_val;
  const int32_t* n_taint_effect;
  const uint8_t* n_unschedulable;
  const int32_t* n_port_proto;     // [N, P]
  const int32_t* n_port_ip;
  const int32_t* n_port_num;
  // pod batch [U, ...]
  const uint8_t* p_valid;
  const int64_t* p_req;            // [U, R]
  const uint8_t* p_req_any;
  const int32_t* p_node_name_id;
  const int32_t* p_tol_key;        // [U, TL]
  const int32_t* p_tol_op;
  const int32_t* p_tol_val;
  const int32_t* p_tol_effect;
  const uint8_t* p_tol_valid;
  const int32_t* p_sel_pair_slot;  // [U, NSP]
  const int32_t* p_sel_pair_val;
  const uint8_t* p_has_required;
  const uint8_t* p_term_valid;     // [U, TERMS]
  const int32_t* p_term_req_op;    // [U, TERMS, REQS]
  const int32_t* p_term_req_slot;
  const int32_t* p_term_req_vals;  // [U, TERMS, REQS, VALS]
  const int64_t* p_term_req_num;   // [U, TERMS, REQS]
  const int32_t* p_port_proto;     // [U, PP]
  const int32_t* p_port_ip;
  const int32_t* p_port_num;
  uint8_t* out;                    // [U, N]
  uint8_t* sel_out;                // [U, N] raw selector predicate, or null
  int32_t N, U, K, R, T, P, TL, NSP, TERMS, REQS, VALS, PP;
  int32_t wildcard_ip, unschedulable_key, empty_val;
  int32_t predicates;
  int32_t counts64;
  // the tile (ops/filters.filter_layout): UT spec rows x NT nodes a CTA,
  // the staged bytes of a spec row, rows staged in shared memory or not,
  // and the dynamic shared memory
  int32_t UT, NT, row_bytes, staged, smem;
};

// ---------------------------------------------------------------------------
// a staged spec row: int64 lanes, then int32 lanes (offsets in elements)
// ---------------------------------------------------------------------------

#define H_VALID 0
#define H_PINNED 1
#define H_HAS_REQUIRED 3
#define H_N_TOL 4
#define H_N_PAIR 5
#define H_N_RES 6
#define H_N_PORT 7
#define H_N_TERMS 8
#define H_N_REQS 9
#define H_TERM_NREQ 10  // the first two terms' requirement counts (the header's last lanes)
#define HDR 12

// a thread keeps its node's fields for the whole tile in registers: the
// first FILTER_FREE free resources (cpu, memory, ephemeral storage: every
// requesting row compares them), its first FILTER_TAINTS blocking taints,
// and its labels at the first FILTER_SLOTS distinct slots the tile's
// pairs and set / presence requirements read; the rest is read from
// device memory
#define FILTER_FREE 3
#define FILTER_TAINTS 2
#define FILTER_SLOTS 4

struct RowLayout {
  int res_req, req_num, n64;                             // int64 (n64: even, so the int32 lanes are 16-byte aligned)
  int hdr, tol_key, tol_op, tol_val, tol_eff, pair_slot, pair_val, pair_li, res_idx, port_num, port_proto, port_ip,
      term_nreq, req_op, req_slot, req_li, req_nval, req_vals, n32;  // int32
};

__host__ __device__ __forceinline__ RowLayout row_layout(const FilterArgs& a) {
  const int tr = a.TERMS * a.REQS;
  RowLayout l;
  l.res_req = 0;
  l.req_num = a.R;
  l.n64 = (a.R + tr + 1) & ~1;
  l.hdr = 0;
  l.tol_key = HDR;
  l.tol_op = l.tol_key + a.TL;
  l.tol_val = l.tol_op + a.TL;
  l.tol_eff = l.tol_val + a.TL;
  l.pair_slot = l.tol_eff + a.TL;
  l.pair_val = l.pair_slot + a.NSP;
  l.pair_li = l.pair_val + a.NSP;
  l.res_idx = l.pair_li + a.NSP;
  l.port_num = l.res_idx + a.R;
  l.port_proto = l.port_num + a.PP;
  l.port_ip = l.port_proto + a.PP;
  l.term_nreq = l.port_ip + a.PP;
  l.req_op = l.term_nreq + a.TERMS;
  l.req_slot = l.req_op + tr;
  l.req_li = l.req_slot + tr;
  l.req_nval = l.req_li + tr;
  l.req_vals = l.req_nval + tr;
  l.n32 = l.req_vals + tr * a.VALS;
  return l;
}

// bytes of one staged row (a multiple of 16) and of a CTA's dynamic shared
// memory: UT rows, then the slot flags and map [K] x 2 int32.
// ops/filters.filter_layout computes the same bytes.
__host__ __device__ __forceinline__ size_t filter_row_bytes(const FilterArgs& a) {
  const RowLayout l = row_layout(a);
  const size_t bytes = 8 * (size_t)l.n64 + 4 * (size_t)l.n32;
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ size_t filter_smem_bytes(const FilterArgs& a) {
  if (!a.staged) return 0;
  return (size_t)a.UT * filter_row_bytes(a) + 8 * (size_t)a.K;
}

// lane-parallel compaction within a warp: the rank of this lane's kept
// lane among the chunk's, and the chunk's count
__device__ __forceinline__ int warp_rank(bool keep, int* count) {
  const unsigned bal = __ballot_sync(0xffffffffu, keep);
  *count = __popc(bal);
  return __popc(bal & ((1u << (threadIdx.x & 31)) - 1u));
}

// The value lanes of one requirement less repeated -1 padding (lane 0
// first: the name operators read it), eight loads at once; the first eight
// may come prefetched. Returns the lanes kept.
__device__ __forceinline__ int stage_values(const int32_t* vals, int VALS, const int32_t* first8, int32_t* out) {
  int nv = 0;
  bool pad = false;
  for (int v0 = 0; v0 < VALS; v0 += 8) {
    int32_t xs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[j] = v0 == 0 ? first8[j] : (v0 + j < VALS ? __ldg(vals + v0 + j) : -1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (v0 + j >= VALS) break;
      if (v0 + j == 0 || xs[j] != -1 || !pad) out[nv++] = xs[j];
      pad |= xs[j] == -1;
    }
  }
  return nv;
}

// Stage spec row u into `row` (one warp). Every lane first loads its lanes
// of every segment (the first 32 of each), so a row of the encoder's widths
// is one round of loads; the segments are then compacted by ballots.
__device__ void stage_row(const FilterArgs& a, int u, uint8_t* row) {
  const RowLayout l = row_layout(a);
  int64_t* r64 = (int64_t*)row;
  int32_t* r32 = (int32_t*)(r64 + l.n64);
  const int lane = threadIdx.x & 31;
  const int tr = a.TERMS * a.REQS;
  int cnt, n;

  // the loads: the row's scalars and term flags, then each segment's first
  // 32 lanes (a lane past a width loads nothing)
  const bool valid = __ldg(a.p_valid + u), req_any = __ldg(a.p_req_any + u);
  const bool has_required = __ldg(a.p_has_required + u);
  const int32_t pinned = __ldg(a.p_node_name_id + u);
  const bool term_lane = lane < a.TERMS && __ldg(a.p_term_valid + (int64_t)u * a.TERMS + (lane < a.TERMS ? lane : 0));
  const int64_t gt = (int64_t)u * a.TL + lane, gp = (int64_t)u * a.NSP + lane, gr = (int64_t)u * a.R + lane;
  const int64_t go = (int64_t)u * a.PP + lane, gq = (int64_t)u * tr + lane;
  const bool in_t = lane < a.TL, in_p = lane < a.NSP, in_r = lane < a.R, in_o = lane < a.PP, in_q = lane < tr;
  const bool tol_ok0 = in_t && __ldg(a.p_tol_valid + gt);
  const int32_t tk0 = in_t ? __ldg(a.p_tol_key + gt) : 0, to0 = in_t ? __ldg(a.p_tol_op + gt) : 0;
  const int32_t tv0 = in_t ? __ldg(a.p_tol_val + gt) : 0, te0 = in_t ? __ldg(a.p_tol_effect + gt) : 0;
  const int32_t ps0 = in_p ? __ldg(a.p_sel_pair_slot + gp) : -1, pv0 = in_p ? __ldg(a.p_sel_pair_val + gp) : 0;
  const int64_t rq0 = in_r ? __ldg(a.p_req + gr) : 0;
  const int32_t on0 = in_o ? __ldg(a.p_port_num + go) : 0, op0 = in_o ? __ldg(a.p_port_proto + go) : 0;
  const int32_t oi0 = in_o ? __ldg(a.p_port_ip + go) : 0;
  const int32_t qop0 = in_q ? __ldg(a.p_term_req_op + gq) : 0, qsl0 = in_q ? __ldg(a.p_term_req_slot + gq) : 0;
  const int64_t qnum0 = in_q ? __ldg(a.p_term_req_num + gq) : 0;
  int32_t qv0[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qv0[j] = (in_q && j < a.VALS) ? __ldg(a.p_term_req_vals + gq * a.VALS + j) : -1;

  // tolerations: the valid ones
  n = 0;
  for (int base = 0; base < a.TL; base += 32) {
    const int i = base + lane;
    const int64_t g = (int64_t)u * a.TL + i;
    const bool in = i < a.TL;
    const bool keep = base == 0 ? tol_ok0 : in && __ldg(a.p_tol_valid + g);
    const int32_t key = base == 0 ? tk0 : (in ? __ldg(a.p_tol_key + g) : 0);
    const int32_t op = base == 0 ? to0 : (in ? __ldg(a.p_tol_op + g) : 0);
    const int32_t val = base == 0 ? tv0 : (in ? __ldg(a.p_tol_val + g) : 0);
    const int32_t eff = base == 0 ? te0 : (in ? __ldg(a.p_tol_effect + g) : 0);
    const int k = n + warp_rank(keep, &cnt);
    if (keep) {
      r32[l.tol_key + k] = key;
      r32[l.tol_op + k] = op;
      r32[l.tol_val + k] = val;
      r32[l.tol_eff + k] = eff;
    }
    n += cnt;
  }
  if (lane == 0) r32[l.hdr + H_N_TOL] = n;

  // selector pairs with a slot (clipped to the label width)
  n = 0;
  for (int base = 0; base < a.NSP; base += 32) {
    const int i = base + lane;
    const int64_t g = (int64_t)u * a.NSP + i;
    const int32_t slot = base == 0 ? ps0 : (i < a.NSP ? __ldg(a.p_sel_pair_slot + g) : -1);
    const int32_t val = base == 0 ? pv0 : (i < a.NSP ? __ldg(a.p_sel_pair_val + g) : 0);
    const bool keep = slot >= 0;
    const int k = n + warp_rank(keep, &cnt);
    if (keep) {
      r32[l.pair_slot + k] = slot > a.K - 1 ? a.K - 1 : slot;
      r32[l.pair_val + k] = val;
    }
    n += cnt;
  }
  if (lane == 0) r32[l.hdr + H_N_PAIR] = n;

  // compared resource slots: cpu, memory and ephemeral storage always,
  // scalar slots when requested; none unless the pod requests anything
  n = 0;
  for (int base = 0; base < a.R; base += 32) {
    const int i = base + lane;
    const int64_t req = base == 0 ? rq0 : (i < a.R ? __ldg(a.p_req + (int64_t)u * a.R + i) : 0);
    const bool keep = req_any && i < a.R && (i < 3 || req > 0);
    const int k = n + warp_rank(keep, &cnt);
    if (keep) {
      r32[l.res_idx + k] = i;
      r64[l.res_req + k] = req;
    }
    n += cnt;
  }
  if (lane == 0) r32[l.hdr + H_N_RES] = n;

  // host ports > 0
  n = 0;
  for (int base = 0; base < a.PP; base += 32) {
    const int i = base + lane;
    const int64_t g = (int64_t)u * a.PP + i;
    const bool in = i < a.PP;
    const int32_t num = base == 0 ? on0 : (in ? __ldg(a.p_port_num + g) : 0);
    const int32_t proto = base == 0 ? op0 : (in ? __ldg(a.p_port_proto + g) : 0);
    const int32_t ip = base == 0 ? oi0 : (in ? __ldg(a.p_port_ip + g) : 0);
    const bool keep = num > 0;
    const int k = n + warp_rank(keep, &cnt);
    if (keep) {
      r32[l.port_num + k] = num;
      r32[l.port_proto + k] = proto;
      r32[l.port_ip + k] = ip;
    }
    n += cnt;
  }
  if (lane == 0) r32[l.hdr + H_N_PORT] = n;

  // required node affinity: the valid terms, each with its requirements
  // that have an operator (PAD and unknown codes evaluate true), each with
  // its value lanes less repeated -1 padding; the terms' requirements
  // follow one another
  int terms = 0, reqs = 0;
  if (tr <= 32) {  // one lane a (term, requirement), ranked by one ballot
    const int t = lane / (a.REQS > 0 ? a.REQS : 1);
    const bool tv = __shfl_sync(0xffffffffu, (int)term_lane, in_q ? t : 0) != 0;
    const bool keep = has_required && in_q && tv && qop0 >= OP_IN && qop0 <= OP_NEVER;
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int k = __popc(bal & ((1u << lane) - 1u));
      r32[l.req_op + k] = qop0;
      r32[l.req_slot + k] = qsl0;
      r64[l.req_num + k] = qnum0;
      r32[l.req_nval + k] = stage_values(a.p_term_req_vals + gq * a.VALS, a.VALS, qv0, r32 + l.req_vals + k * a.VALS);
    }
    // lane t: term t's count, at its rank among the valid terms
    const bool tvalid = has_required && term_lane;
    const unsigned tbal = __ballot_sync(0xffffffffu, tvalid);
    if (tvalid) {
      const unsigned span = a.REQS >= 32 ? 0xffffffffu : ((1u << a.REQS) - 1u);
      const int nq = __popc(bal & (span << (lane * a.REQS)));
      const int rank = __popc(tbal & ((1u << lane) - 1u));
      r32[l.term_nreq + rank] = nq;
      if (rank < 2) r32[l.hdr + H_TERM_NREQ + rank] = nq;
    }
    terms = __popc(tbal);
    reqs = __popc(bal);
  } else {
    for (int t = 0; t < a.TERMS && has_required; ++t) {
      const bool tv = t < 32 ? __shfl_sync(0xffffffffu, (int)term_lane, t) != 0
                             : __ldg(a.p_term_valid + (int64_t)u * a.TERMS + t) != 0;
      if (!tv) continue;
      const int64_t base_q = ((int64_t)u * a.TERMS + t) * a.REQS;
      int nq = 0;
      for (int base = 0; base < a.REQS; base += 32) {
        const int q = base + lane;
        const bool in = q < a.REQS;
        const int32_t op = in ? __ldg(a.p_term_req_op + base_q + q) : 0;
        const int32_t slot = in ? __ldg(a.p_term_req_slot + base_q + q) : 0;
        const int64_t num = in ? __ldg(a.p_term_req_num + base_q + q) : 0;
        int32_t first8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) first8[j] = (in && j < a.VALS) ? __ldg(a.p_term_req_vals + (base_q + q) * a.VALS + j) : -1;
        const bool keep = op >= OP_IN && op <= OP_NEVER;
        const int k = reqs + nq + warp_rank(keep, &cnt);
        if (keep) {
          r32[l.req_op + k] = op;
          r32[l.req_slot + k] = slot;
          r64[l.req_num + k] = num;
          r32[l.req_nval + k] = stage_values(a.p_term_req_vals + (base_q + q) * a.VALS, a.VALS, first8,
                                             r32 + l.req_vals + k * a.VALS);
        }
        nq += cnt;
      }
      if (lane == 0) {
        r32[l.term_nreq + terms] = nq;
        if (terms < 2) r32[l.hdr + H_TERM_NREQ + terms] = nq;
      }
      reqs += nq;
      ++terms;
    }
  }
  if (lane == 0) {
    r32[l.hdr + H_N_REQS] = reqs;
    r32[l.hdr + H_VALID] = valid;
    r32[l.hdr + H_PINNED] = pinned;
    r32[l.hdr + H_HAS_REQUIRED] = has_required;
    r32[l.hdr + H_N_TERMS] = terms;
  }
}

// Toleration.ToleratesTaint over a staged (all valid) toleration list
__device__ __forceinline__ bool tolerated_staged(const int32_t* r32, const RowLayout& l, int n, int32_t key,
                                                 int32_t val, int32_t effect) {
  for (int i = 0; i < n; ++i) {
    const int32_t te = r32[l.tol_eff + i], tk = r32[l.tol_key + i];
    if ((te == 0 || te == effect) && (tk == 0 || tk == key) &&
        (r32[l.tol_op + i] == TOL_EXISTS || r32[l.tol_val + i] == val)) {
      return true;
    }
  }
  return false;
}

// A node's fields as its thread keeps them for the tile: labels at the
// listed slots, the first free resources and blocking taints in registers,
// the rest in device memory.
struct NodeSide {
  const int32_t* lv;     // the node's rows in device memory
  const int64_t* ln;
  const uint8_t* lok;
  int32_t lab[FILTER_SLOTS];
  int64_t free[FILTER_FREE];
  int32_t tk[FILTER_TAINTS], tv[FILTER_TAINTS], te[FILTER_TAINTS];
  int n_taint;           // blocking taints; past FILTER_TAINTS all read from device memory
  // the label at clipped slot sc, whose listed index (or -1) is li
  __device__ __forceinline__ int32_t value(int li, int sc) const {
    int32_t v = 0;
#pragma unroll
    for (int k = 0; k < FILTER_SLOTS; ++k) v = li == k ? lab[k] : v;
    return li >= 0 ? v : __ldg(lv + sc);
  }
  __device__ __forceinline__ bool num_ok(int sc) const { return __ldg(lok + sc) != 0; }
  __device__ __forceinline__ int64_t number(int sc) const { return __ldg(ln + sc); }
};

// one compiled requirement (eval_requirement's semantics) over the staged
// labels
__device__ __forceinline__ bool requirement_staged(int32_t op, int32_t slot, int li, const int32_t* vals, int nval,
                                                   int64_t num, const NodeSide& nl, int K, int32_t name_id) {
  const int sc = slot < 0 ? 0 : (slot > K - 1 ? K - 1 : slot);
  const bool known = slot >= 0;
  switch (op) {
    case OP_IN:
    case OP_NOT_IN: {
      const int32_t nv = known ? nl.value(li, sc) : 0;
      bool in_set = false;
      for (int v = 0; v < nval; ++v) in_set |= (nv == vals[v]);
      const bool present = known && nv != 0;
      return op == OP_IN ? (present && in_set) : (!present || !in_set);
    }
    case OP_EXISTS: return known && nl.value(li, sc) != 0;
    case OP_DOES_NOT_EXIST: return !(known && nl.value(li, sc) != 0);
    case OP_GT: return known && nl.num_ok(sc) && nl.number(sc) > num;
    case OP_LT: return known && nl.num_ok(sc) && nl.number(sc) < num;
    case OP_NAME_IN: return name_id == vals[0];
    case OP_NAME_NOT_IN: return name_id != vals[0];
    case OP_NEVER: return false;
    default: return true;
  }
}

// PodMatchNodeSelector of a staged row on node n (its header in registers)
__device__ bool selector_staged(const FilterArgs& a, const int64_t* r64, const int32_t* r32, const RowLayout& l,
                                const int* hdr, const NodeSide& nl, int32_t name_id) {
  const int np = hdr[H_N_PAIR];
  for (int j = 0; j < np; ++j) {
    if (nl.value(r32[l.pair_li + j], r32[l.pair_slot + j]) != r32[l.pair_val + j]) return false;
  }
  if (!hdr[H_HAS_REQUIRED]) return true;
  const int terms = hdr[H_N_TERMS];
  int q = 0;
  for (int t = 0; t < terms; ++t) {
    const int nq = t < 2 ? hdr[H_TERM_NREQ + t] : r32[l.term_nreq + t];
    bool all_req = true;
    for (int i = 0; i < nq && all_req; ++i) {
      const int k = q + i;
      const int32_t op = r32[l.req_op + k], slot = r32[l.req_slot + k], li = r32[l.req_li + k];
      const int32_t nval = r32[l.req_nval + k];
      const int64_t num = r64[l.req_num + k];
      all_req = requirement_staged(op, slot, li, r32 + l.req_vals + k * a.VALS, nval, num, nl, a.K, name_id);
    }
    if (all_req) return true;
    q += nq;
  }
  return false;
}

// ---------------------------------------------------------------------------
// the device-memory evaluation (staged = 0): one pair from the pod batch's
// and the node bank's padded rows
// ---------------------------------------------------------------------------

// PodMatchNodeSelector: nodeSelector pairs AND required node-affinity terms
// (terms ORed, requirements ANDed).
__device__ bool selector_ok(const FilterArgs& a, int u, int n) {
  const int32_t* lv = a.n_label_vals + (int64_t)n * a.K;
  const int64_t* ln = a.n_label_num + (int64_t)n * a.K;
  const uint8_t* lok = a.n_label_num_ok + (int64_t)n * a.K;
  for (int j = 0; j < a.NSP; ++j) {
    const int32_t slot = a.p_sel_pair_slot[(int64_t)u * a.NSP + j];
    if (slot < 0) continue;
    const int sc = slot > a.K - 1 ? a.K - 1 : slot;
    if (lv[sc] != a.p_sel_pair_val[(int64_t)u * a.NSP + j]) return false;
  }
  if (a.p_has_required[u]) {
    bool any_term = false;
    for (int t = 0; t < a.TERMS && !any_term; ++t) {
      if (!a.p_term_valid[(int64_t)u * a.TERMS + t]) continue;
      bool all_req = true;
      const int64_t base = ((int64_t)u * a.TERMS + t) * a.REQS;
      for (int q = 0; q < a.REQS && all_req; ++q) {
        all_req = eval_requirement(
            a.p_term_req_op[base + q], a.p_term_req_slot[base + q],
            a.p_term_req_vals + (base + q) * a.VALS, a.VALS, a.p_term_req_num[base + q],
            lv, ln, lok, a.K, a.n_name_id[n]);
      }
      any_term = all_req;
    }
    if (!any_term) return false;
  }
  return true;
}

// The enabled predicates for one pair; `sel` is the selector predicate when
// the caller already computed it; `count_ok` the node's pod-count test.
__device__ bool fits(const FilterArgs& a, int u, int n, const bool* sel, bool count_ok) {
  const int pr = a.predicates;
  const int32_t* tk = a.p_tol_key + (int64_t)u * a.TL;
  const int32_t* to = a.p_tol_op + (int64_t)u * a.TL;
  const int32_t* tv = a.p_tol_val + (int64_t)u * a.TL;
  const int32_t* te = a.p_tol_effect + (int64_t)u * a.TL;
  const uint8_t* tvalid = a.p_tol_valid + (int64_t)u * a.TL;

  if (pr & PRED_UNSCHEDULABLE) {
    // node.spec.unschedulable is a synthetic NoSchedule taint
    if (a.n_unschedulable[n] &&
        !tolerated(tk, to, tv, te, tvalid, a.TL, a.unschedulable_key, a.empty_val,
                   EFFECT_NO_SCHEDULE)) {
      return false;
    }
  }
  if (pr & PRED_HOST) {
    const int32_t pinned = a.p_node_name_id[u];
    if (pinned != 0 && pinned != a.n_name_id[n]) return false;
  }
  if (pr & PRED_RESOURCES) {
    if (!count_ok) return false;
    if (a.p_req_any[u]) {
      const int64_t* req = a.p_req + (int64_t)u * a.R;
      const int64_t* alloc = a.n_alloc + (int64_t)n * a.R;
      const int64_t* used = a.n_requested + (int64_t)n * a.R;
      for (int r = 0; r < a.R; ++r) {
        // cpu/mem/ephemeral always; scalar slots only when requested
        if ((r < 3 || req[r] > 0) && req[r] > alloc[r] - used[r]) return false;
      }
    }
  }
  if (pr & PRED_TAINTS) {
    const int32_t* nk = a.n_taint_key + (int64_t)n * a.T;
    const int32_t* nvv = a.n_taint_val + (int64_t)n * a.T;
    const int32_t* ne = a.n_taint_effect + (int64_t)n * a.T;
    for (int t = 0; t < a.T; ++t) {
      const int32_t eff = ne[t];
      if ((eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE) &&
          !tolerated(tk, to, tv, te, tvalid, a.TL, nk[t], nvv[t], eff)) {
        return false;
      }
    }
  }
  if ((pr & PRED_SELECTOR) && !(sel != nullptr ? *sel : selector_ok(a, u, n))) return false;
  if (pr & PRED_PORTS) {
    const int32_t* pn = a.p_port_num + (int64_t)u * a.PP;
    const int32_t* pp = a.p_port_proto + (int64_t)u * a.PP;
    const int32_t* pi = a.p_port_ip + (int64_t)u * a.PP;
    const int32_t* nn = a.n_port_num + (int64_t)n * a.P;
    const int32_t* np = a.n_port_proto + (int64_t)n * a.P;
    const int32_t* ni = a.n_port_ip + (int64_t)n * a.P;
    if (ports_clash(pn, pp, pi, a.PP, nn, np, ni, a.P, a.wildcard_ip)) return false;
  }
  return true;
}

// PodFitsResources' pod-count test at the widths the caller holds (int32
// arithmetic wraps like the reference's)
__device__ __forceinline__ bool pod_count_ok(const FilterArgs& a, int n) {
  const int64_t c1 = (a.counts64 & POD_COUNT_64)
                         ? (int64_t)((uint64_t)__ldg((const int64_t*)a.n_pod_count + n) + 1u)
                         : (int64_t)(int32_t)((uint32_t)__ldg((const int32_t*)a.n_pod_count + n) + 1u);
  const int64_t al = (a.counts64 & ALLOWED_PODS_64) ? __ldg((const int64_t*)a.n_allowed_pods + n)
                                                    : (int64_t)__ldg((const int32_t*)a.n_allowed_pods + n);
  return c1 <= al;
}

__global__ void filter_tile_kernel(const FilterArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * a.NT + tid;
  const int u0 = blockIdx.y * a.UT;
  const int rows = min(a.UT, a.U - u0);
  const bool with_sel = a.sel_out != nullptr;
  const int pr = a.predicates;

  if (!a.staged) {  // the device-memory path
    if (n >= a.N) return;
    const bool alive = a.n_valid[n] && !a.n_fallback[n];
    const bool count_ok = pod_count_ok(a, n);
    for (int r = 0; r < rows; ++r) {
      const int u = u0 + r;
      bool sel = true;
      if (with_sel) {
        sel = selector_ok(a, u, n);
        a.sel_out[(int64_t)u * a.N + n] = sel ? 1 : 0;
      }
      bool ok = a.p_valid[u] && alive;
      if (ok) ok = fits(a, u, n, with_sel ? &sel : nullptr, count_ok);
      a.out[(int64_t)u * a.N + n] = ok ? 1 : 0;
    }
    return;
  }

  // stage the tile's spec rows, one warp a row
  const size_t row_bytes = filter_row_bytes(a);
  const RowLayout l = row_layout(a);
  for (int r = tid >> 5; r < rows; r += a.NT >> 5) stage_row(a, u0 + r, dyn + r * row_bytes);

  int32_t* s_flag = (int32_t*)(dyn + (size_t)a.UT * row_bytes);  // [K]
  int32_t* s_map_v = s_flag + a.K;                                // [K]
  __shared__ int32_t n_slots;
  __shared__ int32_t slots[FILTER_SLOTS];

  // the label slots the tile's rows read: flagged, then listed
  for (int k = tid; k < a.K; k += a.NT) s_flag[k] = 0;
  if (tid == 0) n_slots = 0;
  __syncthreads();
  const int refs = a.NSP + a.TERMS * a.REQS;
  for (int i = tid; i < rows * refs; i += a.NT) {
    const int32_t* r32 = (const int32_t*)(dyn + (i / refs) * row_bytes + 8 * (size_t)l.n64);
    const int j = i % refs;
    if (j < a.NSP) {
      if (j < r32[l.hdr + H_N_PAIR]) s_flag[r32[l.pair_slot + j]] = 1;
    } else if (j - a.NSP < r32[l.hdr + H_N_REQS]) {
      const int q = j - a.NSP;
      const int32_t op = r32[l.req_op + q], slot = r32[l.req_slot + q];
      if (slot >= 0 && op >= OP_IN && op <= OP_DOES_NOT_EXIST) s_flag[slot > a.K - 1 ? a.K - 1 : slot] = 1;
    }
  }
  __syncthreads();
  for (int k = tid; k < a.K; k += a.NT) {
    int mv = -1;
    if (s_flag[k]) {
      const int i = atomicAdd(&n_slots, 1);
      if (i < FILTER_SLOTS) slots[mv = i] = k;
    }
    s_map_v[k] = mv;
  }
  __syncthreads();
  for (int i = tid; i < rows * refs; i += a.NT) {  // each label read's listed index
    int32_t* r32 = (int32_t*)(dyn + (i / refs) * row_bytes + 8 * (size_t)l.n64);
    const int j = i % refs;
    if (j < a.NSP) {
      if (j < r32[l.hdr + H_N_PAIR]) r32[l.pair_li + j] = s_map_v[r32[l.pair_slot + j]];
    } else if (j - a.NSP < r32[l.hdr + H_N_REQS]) {
      const int q = j - a.NSP;
      const int32_t slot = r32[l.req_slot + q];
      r32[l.req_li + q] = s_map_v[slot < 0 ? 0 : (slot > a.K - 1 ? a.K - 1 : slot)];
    }
  }
  __syncthreads();
  if (n >= a.N) return;

  // the node's fields for the whole tile, every load issued before use
  NodeSide nd;
  nd.lv = a.n_label_vals + (int64_t)n * a.K;
  nd.ln = a.n_label_num + (int64_t)n * a.K;
  nd.lok = a.n_label_num_ok + (int64_t)n * a.K;
  const int nsl = min(n_slots, FILTER_SLOTS);
#pragma unroll
  for (int k = 0; k < FILTER_SLOTS; ++k) nd.lab[k] = k < nsl ? __ldg(nd.lv + slots[k]) : 0;
#pragma unroll
  for (int r = 0; r < FILTER_FREE; ++r) {
    const int64_t g = (int64_t)n * a.R + r;
    nd.free[r] = r < a.R ? __ldg(a.n_alloc + g) - __ldg(a.n_requested + g) : 0;
  }
  const bool alive = __ldg(a.n_valid + n) && !__ldg(a.n_fallback + n);
  const bool count_ok = pod_count_ok(a, n);
  const bool unsched = __ldg(a.n_unschedulable + n);
  const int32_t name_id = __ldg(a.n_name_id + n);
  nd.n_taint = 0;
#pragma unroll
  for (int k = 0; k < FILTER_TAINTS; ++k) nd.tk[k] = nd.tv[k] = nd.te[k] = 0;
  for (int t0 = 0; t0 < a.T; t0 += 8) {  // eight taint lanes' loads at once
    int32_t ee[8], ek[8], ev[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t g = (int64_t)n * a.T + t0 + j;
      const bool in = t0 + j < a.T;
      ee[j] = in ? __ldg(a.n_taint_effect + g) : 0;
      ek[j] = in ? __ldg(a.n_taint_key + g) : 0;
      ev[j] = in ? __ldg(a.n_taint_val + g) : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ee[j] != EFFECT_NO_SCHEDULE && ee[j] != EFFECT_NO_EXECUTE) continue;
#pragma unroll
      for (int k = 0; k < FILTER_TAINTS; ++k) {
        if (nd.n_taint == k) {
          nd.tk[k] = ek[j];
          nd.tv[k] = ev[j];
          nd.te[k] = ee[j];
        }
      }
      ++nd.n_taint;
    }
  }
  const int64_t* alloc = a.n_alloc + (int64_t)n * a.R;
  const int64_t* used = a.n_requested + (int64_t)n * a.R;

  for (int r = 0; r < rows; ++r) {
    const int u = u0 + r;
    const int64_t* r64 = (const int64_t*)(dyn + r * row_bytes);
    const int32_t* r32 = (const int32_t*)(r64 + l.n64);
    // the row's header in registers at once (three 16-byte reads)
    const int4 h0 = ((const int4*)r32)[0], h1 = ((const int4*)r32)[1], h2 = ((const int4*)r32)[2];
    const int hdr[HDR] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w, h2.x, h2.y, h2.z, h2.w};
    bool sel = true;
    if (with_sel) {
      sel = selector_staged(a, r64, r32, l, hdr, nd, name_id);
      a.sel_out[(int64_t)u * a.N + n] = sel ? 1 : 0;
    }
    bool ok = hdr[H_VALID] && alive;
    if (ok && (pr & PRED_UNSCHEDULABLE) && unsched &&
        !tolerated_staged(r32, l, hdr[H_N_TOL], a.unschedulable_key, a.empty_val, EFFECT_NO_SCHEDULE)) {
      ok = false;  // node.spec.unschedulable is a synthetic NoSchedule taint
    }
    if (ok && (pr & PRED_HOST)) {
      ok = hdr[H_PINNED] == 0 || hdr[H_PINNED] == name_id;
    }
    if (ok && (pr & PRED_RESOURCES)) {
      ok = count_ok;
      const int nr = hdr[H_N_RES];  // 0 unless the pod requests anything
      int i = 0;
      if (nr >= FILTER_FREE && ok) {  // the first compared slots are cpu, memory, ephemeral storage
        int64_t q[FILTER_FREE];
#pragma unroll
        for (int k = 0; k < FILTER_FREE; ++k) q[k] = r64[l.res_req + k];
#pragma unroll
        for (int k = 0; k < FILTER_FREE; ++k) ok &= q[k] <= nd.free[k];
        i = FILTER_FREE;
      }
      for (; i < nr && ok; ++i) {
        const int r = r32[l.res_idx + i];
        int64_t fr = 0;
#pragma unroll
        for (int k = 0; k < FILTER_FREE; ++k) fr = r == k ? nd.free[k] : fr;
        if (r >= FILTER_FREE) fr = __ldg(alloc + r) - __ldg(used + r);
        ok = r64[l.res_req + i] <= fr;
      }
    }
    if (ok && (pr & PRED_TAINTS) && nd.n_taint > 0) {
      if (nd.n_taint <= FILTER_TAINTS) {
#pragma unroll
        for (int k = 0; k < FILTER_TAINTS; ++k) {
          if (k < nd.n_taint && ok) ok = tolerated_staged(r32, l, hdr[H_N_TOL], nd.tk[k], nd.tv[k], nd.te[k]);
        }
      } else {
        for (int t = 0; t < a.T && ok; ++t) {
          const int64_t g = (int64_t)n * a.T + t;
          const int32_t eff = __ldg(a.n_taint_effect + g);
          if (eff == EFFECT_NO_SCHEDULE || eff == EFFECT_NO_EXECUTE) {
            ok = tolerated_staged(r32, l, hdr[H_N_TOL], __ldg(a.n_taint_key + g), __ldg(a.n_taint_val + g), eff);
          }
        }
      }
    }
    if (ok && (pr & PRED_SELECTOR)) ok = with_sel ? sel : selector_staged(a, r64, r32, l, hdr, nd, name_id);
    if (ok && (pr & PRED_PORTS) && hdr[H_N_PORT] > 0) {
      ok = !ports_clash(r32 + l.port_num, r32 + l.port_proto, r32 + l.port_ip, hdr[H_N_PORT],
                        a.n_port_num + (int64_t)n * a.P, a.n_port_proto + (int64_t)n * a.P,
                        a.n_port_ip + (int64_t)n * a.P, a.P, a.wildcard_ip);
    }
    a.out[(int64_t)u * a.N + n] = ok ? 1 : 0;
  }
}

extern "C" int ktpu_filter_mask(const FilterArgs* args, cudaStream_t stream) {
  const FilterArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.UT < 1 || a.NT < 32 || a.NT > 1024 || a.NT % 32 != 0 || (a.staged && filter_row_bytes(a) != (size_t)a.row_bytes) ||
      filter_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  int rc;
  if ((rc = set_smem((const void*)filter_tile_kernel, (size_t)a.smem))) return rc;
  dim3 grid((a.N + a.NT - 1) / a.NT, (a.U + a.UT - 1) / a.UT);
  filter_tile_kernel<<<grid, a.NT, (size_t)a.smem, stream>>>(a);
  return (int)cudaGetLastError();
}
