// Topology kernels: term matching, EvenPodsSpread (DoNotSchedule filter and
// ScheduleAnyway score) and SelectorSpread score.
//
// Replace, in kubernetes_tpu/ops/topology.py:
//   ktpu_match_terms            match_terms (:49), up to MATCH_PROBLEMS
//                               (terms, subjects) problems in one launch,
//                               and with them, or alone, pipeline.py:178
//                               _inbatch_tensors' [U, U] port_clash table
//   ktpu_spread_filter         spread_filter (:182) with match_terms,
//                               _bucket_of, _seg_sum, _sig_cnt_node,
//                               _merge_same_key, _gather_rows and
//                               _scatter_and inside, and the metadata that
//                               kubernetes_tpu/commit/arbiter.py
//                               _spread_tables (:76) reads (cand and the
//                               merged tables, written by the same launch)
//   ktpu_spread_score           spread_score (:227) with match_terms (no
//                               namespace test), the same helpers and
//                               _scatter_add inside
//   ktpu_selector_spread_score  selector_spread_score (:433)
//
// Existing pods are label SIGNATURES (state/tensors.SigBank): counts[N, S]
// int16 pods per (node, signature). A term matches a handful of signatures
// (config 3: one), so where the reference multiplies the dense [TT, S] match
// matrix with counts^T, these kernels first compact each term's (or spec
// row's) matched signatures into a list and sum only those columns per node:
// the same integer sums, without the S-wide dot products. Every sum is an
// integer sum, so the order of atomics does not change a result; the one
// float64 path (the SelectorSpread blend) is evaluated in the reference's
// operation order, and the library is built with -fmad=false.
//
// Bound: none of them has enough arithmetic to matter. match_terms is
// bound by its [TT, X] byte output and label reads; the spread programs read
// the counts columns of the matched signatures, the node bank's dense label
// column of each key and the selector rows, and write [U, N] int64 (the
// filter [U, N] bytes): bytes. Their real cost is launch count and the reads
// a node costs (one 32-byte sector for each 2-byte count or 4-byte label:
// the banks are node-major). The spread score, the spread filter and the
// selector spread are each one launch of clusters (below), the match one
// launch a batch.
#include <cooperative_groups.h>

#include "topology.cuh"

namespace cg = cooperative_groups;

#define LOAD_BATCH 16  // global loads a thread has in flight at once when staging

// ---------------------------------------------------------------------------
// A term's label selector compacted into shared memory (the match kernel's
// term tiles, the spread score's term chunks): only its live lanes, so a
// test against a subject reads shared memory and the subject's label slots.
//   word 0      TR_DEAD (an invalid row, a nil selector or a NEVER
//               expression: it matches nothing), TR_NS (the namespace test
//               applies), the test count (bits 0-9) and namespace lanes
//               (bits 10-19)
//   tests       two words each: (op << 24) | the clipped slot, then the
//               matchLabels value, or (pool word << 16) | value count for
//               In / NotIn, or 0
//   value pool  an In / NotIn expression's value lanes >= 0 and one -1 lane
//               where it had any (a padded lane equals only a -1 label)
//   namespaces  the term's namespace lanes, as they are
// metav1.LabelSelectorAsSelector over interned ids (topology.match_terms):
// matchLabels at clipped slots (a negative slot passes), expressions with
// present = value id != 0 at the clipped slot, unknown operators pass.
// ---------------------------------------------------------------------------

#define TR_DEAD 0x80000000u
#define TR_NS 0x40000000u
#define TR_EQ 15  // a matchLabels pair, beside the OP_* codes

__host__ __device__ __forceinline__ int term_row_ns(int ML, int EX, int VALS) { return 1 + 2 * (ML + EX) + EX * VALS; }

__host__ __device__ __forceinline__ int term_row_words(int ML, int EX, int VALS, int NS) {
  return term_row_ns(ML, EX, VALS) + NS;
}

struct TermSel {  // a term bank's selector fields (a device-side view)
  const uint8_t* valid;
  const uint8_t* has_selector;
  const int32_t* ml_slot;
  const int32_t* ml_val;
  const int32_t* ex_op;
  const int32_t* ex_slot;
  const int32_t* ex_vals;
  const uint8_t* ns_any;
  const int32_t* ns_ids;
  int ML, EX, VALS, NS;
};

// Compact term t's selector (subject label rows of width K; with_ns: the
// namespace test applies) into `row`.
__device__ void compact_term(const TermSel& f, int t, int K, bool with_ns, int32_t* row) {
  if (!f.valid[t] || !f.has_selector[t]) {
    row[0] = (int32_t)TR_DEAD;
    return;
  }
  const int kmax = K - 1;
  const int pool0 = 1 + 2 * (f.ML + f.EX);
  int32_t* tests = row + 1;
  int nt = 0, np = 0;
  for (int j = 0; j < f.ML; ++j) {
    const int32_t slot = f.ml_slot[(int64_t)t * f.ML + j];
    if (slot < 0) continue;
    tests[2 * nt] = (int32_t)(((uint32_t)TR_EQ << 24) | (uint32_t)(slot > kmax ? kmax : slot));
    tests[2 * nt + 1] = f.ml_val[(int64_t)t * f.ML + j];
    ++nt;
  }
  for (int j = 0; j < f.EX; ++j) {
    const int64_t e = (int64_t)t * f.EX + j;
    const int32_t op = f.ex_op[e];
    if (op == OP_NEVER) {
      row[0] = (int32_t)TR_DEAD;
      return;
    }
    if (op != OP_IN && op != OP_NOT_IN && op != OP_EXISTS && op != OP_DOES_NOT_EXIST) continue;
    const int32_t slot = f.ex_slot[e];
    int32_t arg = 0;
    if (op == OP_IN || op == OP_NOT_IN) {
      const int off = np;
      bool pad = false;
      for (int k = 0; k < f.VALS; ++k) {
        const int32_t v = f.ex_vals[e * f.VALS + k];
        if (v >= 0) {
          row[pool0 + np++] = v;
        } else {
          pad = true;
        }
      }
      if (pad) row[pool0 + np++] = -1;
      arg = ((pool0 + off) << 16) | (np - off);
    }
    tests[2 * nt] = (int32_t)(((uint32_t)op << 24) | (uint32_t)(slot < 0 ? 0 : (slot > kmax ? kmax : slot)));
    tests[2 * nt + 1] = arg;
    ++nt;
  }
  uint32_t head = (uint32_t)nt;
  if (with_ns && !f.ns_any[t]) {
    const int ns0 = term_row_ns(f.ML, f.EX, f.VALS);
    for (int j = 0; j < f.NS; ++j) row[ns0 + j] = f.ns_ids[(int64_t)t * f.NS + j];
    head |= TR_NS | ((uint32_t)f.NS << 10);
  }
  row[0] = (int32_t)head;
}

// Does the compacted `row` match a subject whose label at a clipped slot is
// lab(slot) and whose namespace is nsx?
template <typename Label>
__device__ __forceinline__ bool eval_term(const int32_t* row, int ns0, Label lab, int32_t nsx) {
  const uint32_t head = (uint32_t)row[0];
  if (head & TR_DEAD) return false;
  const int nt = head & 1023;
  for (int i = 0; i < nt; ++i) {
    const uint32_t w = (uint32_t)row[1 + 2 * i];
    const int32_t arg = row[2 + 2 * i];
    const int32_t op = (int32_t)(w >> 24);
    const int32_t v = lab((int)(w & 0xFFFFFFu));
    if (op == TR_EQ) {
      if (v != arg) return false;
      continue;
    }
    const bool present = v != 0;
    bool ok;
    if (op == OP_IN || op == OP_NOT_IN) {
      const int off = arg >> 16, cnt = arg & 0xFFFF;
      bool in_set = false;
      for (int k = 0; k < cnt; ++k) in_set |= v == row[off + k];
      ok = op == OP_IN ? (present && in_set) : (!present || !in_set);
    } else {
      ok = op == OP_EXISTS ? present : !present;
    }
    if (!ok) return false;
  }
  if (head & TR_NS) {
    const int nn = (head >> 10) & 1023;
    bool in = false;
    for (int j = 0; j < nn; ++j) in |= row[ns0 + j] == nsx;
    if (!in) return false;
  }
  return true;
}

// The same test read straight from the term bank (the spread filter's
// in-launch matching): term t against subject x's labels (row width K) and
// namespace (ns null: no namespace test).
__device__ __forceinline__ bool selector_matches(
    const uint8_t* valid, const uint8_t* has_selector, const int32_t* ml_slot, const int32_t* ml_val,
    const int32_t* ex_op, const int32_t* ex_slot, const int32_t* ex_vals, const uint8_t* ns_any,
    const int32_t* ns_ids, const int32_t* labels, const int32_t* ns, int K, int ML, int EX, int VALS, int NS,
    int t, int x) {
  if (!__ldg(valid + t) || !__ldg(has_selector + t)) return false;
  const int32_t* lab = labels + (int64_t)x * K;
  const int kmax = K - 1;
  for (int j = 0; j < ML; ++j) {
    const int32_t slot = __ldg(ml_slot + (int64_t)t * ML + j);
    if (slot < 0) continue;
    if (__ldg(lab + (slot > kmax ? kmax : slot)) != __ldg(ml_val + (int64_t)t * ML + j)) return false;
  }
  for (int j = 0; j < EX; ++j) {
    const int64_t e = (int64_t)t * EX + j;
    const int32_t op = __ldg(ex_op + e);
    if (op != OP_IN && op != OP_NOT_IN && op != OP_EXISTS && op != OP_DOES_NOT_EXIST) {
      if (op == OP_NEVER) return false;
      continue;  // unknown operators pass
    }
    const int32_t slot = __ldg(ex_slot + e);
    const int32_t v = __ldg(lab + (slot < 0 ? 0 : (slot > kmax ? kmax : slot)));
    const bool present = v != 0;
    bool ok;
    if (op == OP_IN || op == OP_NOT_IN) {
      bool in_set = false;
      const int32_t* vals = ex_vals + e * VALS;
      for (int k = 0; k < VALS; ++k) in_set |= (v == __ldg(vals + k));
      ok = op == OP_IN ? (present && in_set) : (!present || !in_set);
    } else {
      ok = op == OP_EXISTS ? present : !present;
    }
    if (!ok) return false;
  }
  if (ns != nullptr && !__ldg(ns_any + t)) {
    const int32_t nsx = __ldg(ns + x);
    bool in = false;
    for (int j = 0; j < NS; ++j) in |= (__ldg(ns_ids + (int64_t)t * NS + j) == nsx);
    if (!in) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// match_terms: one launch for up to MATCH_PROBLEMS (terms, subjects)
// problems, blockIdx.z the problem. A CTA takes MATCH_TERM_TILE terms x
// xtile subjects (xtile a power of two): the tile's term rows (each
// field's rows one contiguous run of the bank) copied into shared memory
// and compacted there once (a dead row matches nothing and names no
// slot); the subjects' labels staged at the slots the tile's tests name
// only, a column a slot (conflict-free along the subjects); then every pair
// tested from shared memory alone, written along the subjects.
//
// The launch may carry the batch's in-batch host-port table beside its term
// problems (or alone: a port-only launch, count 0): the slice blockIdx.z ==
// count, see port_table below. The solve's in-batch tracking and the
// arbiter read it with the batch's term x spec-row matches, so it rides in
// the launch that makes those.
// ---------------------------------------------------------------------------

#define MATCH_PROBLEMS 4
#define MATCH_TERM_TILE 8

struct MatchProblem {
  const uint8_t* valid;         // [TT]
  const uint8_t* has_selector;  // [TT]
  const int32_t* ml_slot;       // [TT, ML]
  const int32_t* ml_val;        // [TT, ML]
  const int32_t* ex_op;         // [TT, EX]
  const int32_t* ex_slot;       // [TT, EX]
  const int32_t* ex_vals;       // [TT, EX, VALS]
  const uint8_t* ns_any;        // [TT]
  const int32_t* ns_ids;        // [TT, NS]
  const int32_t* labels;        // [X, K]
  const int32_t* ns;            // [X], or null: no namespace test
  uint8_t* out;                 // [TT, X]
  int32_t TT, X, K, ML, EX, VALS, NS;
  int32_t xtile;                // subjects a CTA (ops/topology.match_layout)
};

struct PortProblem {
  const int32_t* num;    // [U, PP] (0: a padding lane)
  const int32_t* proto;  // [U, PP]
  const int32_t* ip;     // [U, PP]
  uint8_t* out;          // [U, U] bool, or null: no port table in the launch
  int32_t U, PP, wildcard_ip;
  int32_t rows, cols;    // a CTA's tile: spec rows x columns (ops/topology.port_layout)
};

struct MatchArgs {
  MatchProblem p[MATCH_PROBLEMS];
  PortProblem port;
  int32_t count;  // term problems in use
  int32_t smem;   // a CTA's dynamic shared memory: the largest problem's or the port slice's
};

// the int32 words of a tile's term rows as the bank holds them: the int32
// fields, then three bytes a row (valid, has-selector, any namespace)
__host__ __device__ __forceinline__ int match_raw_words(const MatchProblem& p) {
  return MATCH_TERM_TILE * (2 * p.ML + 2 * p.EX + p.EX * p.VALS + p.NS) + (3 * MATCH_TERM_TILE + 3) / 4;
}

// the label slots a tile's compacted tests can name
__host__ __device__ __forceinline__ int match_slot_cap(const MatchProblem& p) {
  const int tests = MATCH_TERM_TILE * (p.ML + p.EX);
  return tests < p.K ? tests : p.K;
}

// a problem's CTA: the tile's term rows as copied and as compacted, the slot
// map [K], the slots and their label columns [slot cap, xtile + 1] and the
// namespaces [xtile], int32 words (ops/topology.match_layout)
__host__ __device__ __forceinline__ size_t match_smem_bytes(const MatchProblem& p) {
  return 4 * ((size_t)match_raw_words(p) + (size_t)MATCH_TERM_TILE * term_row_words(p.ML, p.EX, p.VALS, p.NS) +
              p.K + (size_t)match_slot_cap(p) * (p.xtile + 1) + p.xtile);
}

// ---------------------------------------------------------------------------
// The port slice: [U, U] bool, out[u, w] = some host port of spec row u
// clashes with one of spec row w. Replaces kubernetes_tpu/ops/pipeline.py:178
// _inbatch_tensors' pairwise port_clash. CTA `tile` (blockIdx.y * gridDim.x
// + blockIdx.x) takes a tile of `rows` spec rows x `cols` columns (a
// multiple of 16; ops/topology.port_layout):
//   1. one thread a tile row or column makes ONE pass over that spec row's
//      PP lanes (their loads issued together) and keeps the live lanes
//      (num > 0) compacted at the row's first slots as (num, proto, ip, -)
//      words, beside its live count;
//   2. one thread a cell, 16 consecutive columns of one row a half-warp: a
//      pair whose row or column has no live lane is false without a test;
//      a live pair runs port_lists_clash (common.cuh, the pod-vs-node
//      filter's rule) over the compacted lanes; the warp's ballot gathers
//      the cells and one lane of each half-warp writes its 16 bytes in ONE
//      16-byte store (each thread its own byte where U is not a multiple
//      of 16).
// A cell a thread: a live pair's test is a chain of dependent shared-memory
// reads over both lists (~0.7 us on the card), so no thread takes more than
// a cell or two at the PORT_TILE tile, and at most four where the tile
// widens to fit the term problems' plane (ops/topology.PORT_CELLS).
// Bound: bytes (the [U, PP] lists read once, [U, U] written once); bench.py's
// batches hold no host port, so a CTA costs one round trip of loads and its
// stores.
// ---------------------------------------------------------------------------

#define PORT_LOAD 8  // a row's lanes loaded at once

// the slice's shared memory: the tile rows' and columns' lanes, then their
// live counts (ops/topology.port_layout)
__host__ __device__ __forceinline__ size_t port_smem_bytes(const PortProblem& q) {
  return ((size_t)16 * q.PP + 4) * ((size_t)q.rows + q.cols);
}

__host__ __device__ __forceinline__ int port_tiles(const PortProblem& q) {
  return ((q.U + q.rows - 1) / q.rows) * ((q.U + q.cols - 1) / q.cols);
}

// spec row `row`'s live lanes compacted into lanes[0 ...]; returns their count
__device__ __forceinline__ int stage_port_row(const PortProblem& q, int row, int4* lanes) {
  const int64_t base = (int64_t)row * q.PP;
  int c = 0;
  for (int k0 = 0; k0 < q.PP; k0 += PORT_LOAD) {
    int32_t num[PORT_LOAD], proto[PORT_LOAD], ip[PORT_LOAD];
#pragma unroll
    for (int k = 0; k < PORT_LOAD; ++k) {  // the loads first
      const bool in = k0 + k < q.PP;
      num[k] = in ? __ldg(q.num + base + k0 + k) : 0;
      proto[k] = in ? __ldg(q.proto + base + k0 + k) : 0;
      ip[k] = in ? __ldg(q.ip + base + k0 + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < PORT_LOAD; ++k) {
      if (num[k] > 0) lanes[c++] = make_int4(num[k], proto[k], ip[k], 0);
    }
  }
  return c;
}

__device__ __forceinline__ void port_table(const PortProblem& q, int tile, int32_t* smem) {
  const int col_tiles = (q.U + q.cols - 1) / q.cols;
  if (tile >= port_tiles(q)) return;
  const int r0 = (tile / col_tiles) * q.rows, c0 = (tile % col_tiles) * q.cols;
  const int nr = min(q.rows, q.U - r0), nc = min(q.cols, q.U - c0);
  int4* lanes = reinterpret_cast<int4*>(smem);                                     // [rows + cols, PP]
  int32_t* cnt = reinterpret_cast<int32_t*>(lanes + (size_t)(q.rows + q.cols) * q.PP);  // [rows + cols]
  // 1. the tile's rows, then its columns: one thread a spec row
  for (int t = threadIdx.x; t < nr + nc; t += THREADS) {
    const int slot = t < nr ? t : q.rows + (t - nr);
    cnt[slot] = stage_port_row(q, t < nr ? r0 + t : c0 + (t - nr), lanes + (size_t)slot * q.PP);
  }
  __syncthreads();
  // 2. a cell a thread, rows along the tile: 16 columns of a row a half-warp
  const bool vec = (q.U & 15) == 0 && (reinterpret_cast<uintptr_t>(q.out) & 15) == 0;
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < q.rows * q.cols; i0 += THREADS) {  // the same trip count for every thread
    const int i = i0 + threadIdx.x, r = i / q.cols, c = i - r * q.cols;
    const bool in = i < q.rows * q.cols && r < nr && c < nc;
    bool hit = false;
    if (in) {
      const int rc = cnt[r], cc = cnt[q.rows + c];
      hit = rc > 0 && cc > 0 &&
            port_lists_clash(PortLanes{lanes + (size_t)r * q.PP}, rc, PortLanes{lanes + (size_t)(q.rows + c) * q.PP},
                             cc, q.wildcard_ip);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    uint8_t* dst = q.out + (int64_t)(r0 + r) * q.U + c0 + c;
    if (vec) {  // a half-warp's 16 columns, one row, all in range: one store by its first lane
      if (in && (lane & 15) == 0) {
        const unsigned h = bits >> (lane & 16);
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = ((h >> (4 * k)) & 1u) | (((h >> (4 * k + 1)) & 1u) << 8) | (((h >> (4 * k + 2)) & 1u) << 16) |
                 (((h >> (4 * k + 3)) & 1u) << 24);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else if (in) {
      *dst = hit ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(THREADS) match_terms_kernel(const __grid_constant__ MatchArgs a) {
  extern __shared__ __align__(16) int32_t msm[];
  __shared__ int32_t warp_cnt[THREADS / 32];
  if ((int)blockIdx.z == a.count) {  // the port slice
    port_table(a.port, blockIdx.y * gridDim.x + blockIdx.x, msm);
    return;
  }
  const MatchProblem& p = a.p[blockIdx.z];  // read in place from the launch's parameters
  const int t0 = blockIdx.y * MATCH_TERM_TILE, x0 = blockIdx.x * p.xtile;
  if (t0 >= p.TT || x0 >= p.X) return;
  const int nt = min(MATCH_TERM_TILE, p.TT - t0), nx = min(p.xtile, p.X - x0);
  const int rw = term_row_words(p.ML, p.EX, p.VALS, p.NS), ns0 = term_row_ns(p.ML, p.EX, p.VALS);
  const bool with_ns = p.ns != nullptr;
  // the tile's term rows as the bank holds them (each field's rows are one
  // contiguous run), the compacted rows, the label slots they name (a map
  // slot -> column, the columns' slots), the subjects' labels at those
  // slots column by column, the subjects' namespaces
  const int s1 = nt * p.ML, s2 = 2 * s1, s3 = s2 + nt * p.EX, s4 = s3 + nt * p.EX, s5 = s4 + nt * p.EX * p.VALS;
  const int words = s5 + nt * p.NS, raw_n = words + 3 * nt;
  int32_t* raw = msm;
  uint8_t* rawb = (uint8_t*)(raw + words);
  int32_t* rows = raw + match_raw_words(p);
  int32_t* slot_of = rows + MATCH_TERM_TILE * rw;  // [K]
  int32_t* slots = slot_of + p.K;                  // [match_slot_cap]
  int32_t* lab = slots + match_slot_cap(p);        // [match_slot_cap, xtile]
  int32_t* nss = lab + match_slot_cap(p) * p.xtile;  // [xtile]
  auto load = [&](int e) -> int32_t {  // element e of the term rows' copy, from the bank
    if (e < s1) return __ldg(p.ml_slot + (int64_t)t0 * p.ML + e);
    if (e < s2) return __ldg(p.ml_val + (int64_t)t0 * p.ML + e - s1);
    if (e < s3) return __ldg(p.ex_op + (int64_t)t0 * p.EX + e - s2);
    if (e < s4) return __ldg(p.ex_slot + (int64_t)t0 * p.EX + e - s3);
    if (e < s5) return __ldg(p.ex_vals + (int64_t)t0 * p.EX * p.VALS + e - s4);
    if (e < words) return __ldg(p.ns_ids + (int64_t)t0 * p.NS + e - s5);
    if (e < words + nt) return __ldg(p.valid + t0 + e - words);
    if (e < words + 2 * nt) return __ldg(p.has_selector + t0 + e - words - nt);
    return __ldg(p.ns_any + t0 + e - words - 2 * nt);
  };
  auto store = [&](int e, int32_t v) {
    if (e < words) {
      raw[e] = v;
    } else {
      rawb[e - words] = (uint8_t)v;
    }
  };
  // 1. the term rows (a thread's first two elements in flight at once) and
  // the subjects' namespaces; the slot map cleared
  const int ea = threadIdx.x, eb = threadIdx.x + THREADS;
  const int32_t va = ea < raw_n ? load(ea) : 0, vb = eb < raw_n ? load(eb) : 0;
  const int32_t nsv = with_ns && (int)threadIdx.x < nx ? __ldg(p.ns + x0 + threadIdx.x) : 0;
  for (int k = threadIdx.x; k < p.K; k += THREADS) slot_of[k] = 0;
  if (ea < raw_n) store(ea, va);
  if (eb < raw_n) store(eb, vb);
  for (int e = threadIdx.x + 2 * THREADS; e < raw_n; e += THREADS) store(e, load(e));  // wide term rows
  for (int x = threadIdx.x; x < nx && with_ns; x += THREADS) nss[x] = x == (int)threadIdx.x ? nsv : __ldg(p.ns + x0 + x);
  __syncthreads();
  // 2. the rows compacted from the copy (a dead row has no test and reads
  // no label); the slots their tests name
  if ((int)threadIdx.x < nt) {
    const TermSel tile{rawb, rawb + nt, raw, raw + s1, raw + s2, raw + s3, raw + s4, rawb + 2 * nt, raw + s5,
                       p.ML, p.EX, p.VALS, p.NS};
    int32_t* row = rows + threadIdx.x * rw;
    compact_term(tile, threadIdx.x, p.K, with_ns, row);
    const uint32_t head = (uint32_t)row[0];
    for (int i = 0; i < (int)(head & 1023) && !(head & TR_DEAD); ++i) slot_of[(uint32_t)row[1 + 2 * i] & 0xFFFFFFu] = 1;
  }
  __syncthreads();
  const int nslots = ordered_compact(p.K, [&](int k) { return slot_of[k] != 0; }, slots, warp_cnt);
  for (int j = threadIdx.x; j < nslots; j += THREADS) slot_of[slots[j]] = j;
  // 3. the subjects' labels at those slots, a column a slot (loads in batches)
  int xshift = 0;
  while ((1 << xshift) < p.xtile) ++xshift;
  for (int k0 = threadIdx.x; k0 < (nslots << xshift); k0 += LOAD_BATCH * THREADS) {
    int32_t got[LOAD_BATCH];
#pragma unroll
    for (int q = 0; q < LOAD_BATCH; ++q) {  // the batch's loads first
      const int k = k0 + q * THREADS, xl = k & (p.xtile - 1);
      got[q] = (k < (nslots << xshift) && xl < nx) ? __ldg(p.labels + (int64_t)(x0 + xl) * p.K + slots[k >> xshift]) : 0;
    }
#pragma unroll
    for (int q = 0; q < LOAD_BATCH; ++q) {
      const int k = k0 + q * THREADS;
      if (k < (nslots << xshift)) lab[k] = got[q];
    }
  }
  __syncthreads();
  // 4. every pair from shared memory, written along the subjects
  for (int i = threadIdx.x; i < nt * nx; i += THREADS) {
    const int tl = i / nx, xl = i - tl * nx;
    const bool m = eval_term(rows + tl * rw, ns0, [&](int sc) { return lab[(slot_of[sc] << xshift) + xl]; },
                             with_ns ? nss[xl] : 0);
    p.out[(int64_t)(t0 + tl) * p.X + x0 + xl] = m ? 1 : 0;
  }
}

// The launch's grid (ops/topology.match_grid): x and y cover every term
// problem's tiles, z one slice a problem and the port slice last; the port
// slice's CTAs are the first `tiles` of its x-y plane. ops/topology.
// port_layout widens the slice's tiles until they fit the term problems'
// plane where a CTA can take them; x grows only where they still outnumber
// it (those extra CTAs of a term slice find no tile and return).
extern "C" int ktpu_match_terms(const MatchArgs* args, cudaStream_t stream) {
  const MatchArgs& a = *args;
  const bool port = a.port.out != nullptr;
  if (a.count < 0 || a.count > MATCH_PROBLEMS || a.count + (int)port < 1) return (int)cudaErrorInvalidValue;
  int gx = 1, gy = 1;
  for (int z = 0; z < a.count; ++z) {
    const MatchProblem& p = a.p[z];
    if (p.TT < 1 || p.X < 1 || p.K < 1 || p.xtile < 1 || match_smem_bytes(p) > (size_t)a.smem) {
      return (int)cudaErrorInvalidValue;
    }
    const int bx = (p.X + p.xtile - 1) / p.xtile, by = (p.TT + MATCH_TERM_TILE - 1) / MATCH_TERM_TILE;
    gx = bx > gx ? bx : gx;
    gy = by > gy ? by : gy;
  }
  if (port) {
    const PortProblem& q = a.port;
    if (q.U < 1 || q.PP < 1 || q.rows < 1 || q.cols < 16 || (q.cols & 15) || port_smem_bytes(q) > (size_t)a.smem) {
      return (int)cudaErrorInvalidValue;
    }
    const int tiles = port_tiles(q);
    if ((int64_t)gx * gy < tiles) gx = (tiles + gy - 1) / gy;
  }
  int rc;
  if ((rc = set_smem((const void*)match_terms_kernel, (size_t)a.smem))) return rc;
  match_terms_kernel<<<dim3(gx, gy, a.count + (int)port), THREADS, (size_t)a.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// spread_score: ONE launch, a grid of clusters of C CTAs along the node
// axis; cluster y takes the R spec rows [y * R, y * R + R), CTA c of it the
// node slice [c * slice, ...) and the bucket slice [c * vslice, ...).
//
//   1. The rows' ScheduleAnyway terms in ascending order; their
//      (owner, key) groups ordered by row (a row's groups are one range),
//      each with its size; the distinct keys; per row the mask of its keys.
//      Each slice node's dense label at the first dense_cap keys and its
//      mask of keys present (bit 31: a valid node) are staged once, so a
//      node's membership of a row (valid, every key of the row present) is
//      one test. A cluster whose rows hold no soft term writes zeros.
//   2. Presence: per key, each valid node carrying it marks its bucket and
//      counts itself in the key's member histogram (at its clamped bucket);
//      a row with one key takes its group's presence from its key's, a row
//      with several keys marks its member nodes' buckets itself.
//   3. Counts, per chunk of SCORE_TW terms (their rows compacted) and
//      window of SCORE_SWIN signatures: the matching (term, signature)
//      pairs (no namespace test: the reference counts over all
//      namespaces) as a list of (column, group); per node
//      tile the counts at the matched signatures in ascending order (a
//      warp's loads share the sectors of a node's row) and the rows'
//      selector bytes, staged once for every row of the cluster, loads in
//      batches; each pair's nonzero count at a member node passing the raw
//      node selector into its group's table at the node's bucket (buckets
//      >= V dropped), in per-warp copies.
//   4. The copies folded; a cluster barrier; each CTA sums its bucket slice
//      of the count, presence and key histogram tables over the cluster
//      through distributed shared memory (a thread per cell and CTA); a
//      cluster barrier; every CTA copies the merged tables back. Past
//      shared memory (copies == 0) the pairs and presence go by global
//      atomics straight into merged_cnt / merged_present at the group's
//      first term's row, and every row takes step 5's per-node path; so
//      does a cluster whose rows hold more groups than the shared tables
//      (gcap).
//   5. A node's count: over the row's groups, group size x the merged
//      count at the node's clamped bucket where it is present and the node
//      carries the key (uint32, the reference's int32 wrap). A one-key row
//      has its total, minimum and membership from its key's histogram (V
//      buckets, not N nodes); another row sums them over its slice nodes,
//      then over the cluster through distributed shared memory. The score
//      10 * (total - count) / (total - min) is written along the nodes (a
//      32-bit division where the operands fit; a one-key row's score is a
//      table by bucket, so a node costs two shared reads). Two CTAs fit an
//      SM, so one CTA's waits overlap the other's work. The exit waits on
//      a split cluster barrier so no CTA leaves while another reads its
//      shared memory.
// ---------------------------------------------------------------------------

#define SCORE_TW 16            // terms a chunk
#define SCORE_SWIN 256         // signatures a window
#define SCORE_TILE_WORDS 4096  // the counts tile: int16 pairs
#define SCORE_SEL_BYTES 8192   // the tile's selector bytes: R x tile nodes
#define SCORE_CHUNK 256        // nodes a warp walks for one row at once
#define KEY_BITS 31            // keys a node's key mask holds (bit 31: a valid node)
#define SCORE_FTAB_BYTES 16384  // one-key rows' scores by bucket, R x V int64, where they fit

// do the one-key rows' scores by bucket fit in shared memory?
__host__ __device__ __forceinline__ bool score_by_bucket(int R, int V) {
  return (size_t)R * V * 8 <= SCORE_FTAB_BYTES;
}

struct SpreadArgs {
  const uint8_t* t_valid;         // [TT]
  const int32_t* t_kind;          // [TT]
  const int32_t* t_owner;         // [TT]
  const int32_t* t_topo_slot;     // [TT]
  const uint8_t* t_has_selector;  // [TT]
  const int32_t* t_ml_slot;       // [TT, ML]
  const int32_t* t_ml_val;        // [TT, ML]
  const int32_t* t_ex_op;         // [TT, EX]
  const int32_t* t_ex_slot;       // [TT, EX]
  const int32_t* t_ex_vals;       // [TT, EX, VALS]
  const int32_t* e_labels;        // [S, KE] signature labels
  const uint8_t* e_valid;         // [S]
  const int16_t* counts;          // [N, S]
  const uint8_t* n_valid;         // [N]
  const int32_t* label_dense;     // [N, K]
  const uint8_t* sel;             // [U, N] raw PodMatchNodeSelector
  int32_t* merged_cnt;            // [TT, V] the device tables (copies == 0)
  uint8_t* merged_present;        // [TT, V]
  int64_t* out;                   // [U, N]
  int32_t TT, S, N, K, KE, ML, EX, VALS, U, V;
  // the launch (ops/topology.spread_score_layout): R spec rows a cluster of
  // C CTAs, the node and bucket slices of a CTA, the per-warp table copies
  // (0: the tables in device memory), the groups (and keys) the shared
  // tables hold (a cluster with more takes the device tables), the keys
  // staged for the slice, and the dynamic shared memory
  int32_t R, C, slice, vslice, copies, gcap, dense_cap, smem;
};

// the dynamic shared memory of a CTA, in this order: int32 words — the
// rows' int64 slice and cluster totals 4 R; where score_by_bucket, the
// one-key rows' scores by bucket R x V int64; the rows' int32 slice minimum
// and membership, cluster minimum and membership, key mask 5 R; the terms,
// their owners and keys, their groups, the groups' rows, keys, key
// indices, sizes and first terms, the keys, a scratch list 11 TT; the rows'
// group ranges R + 1; a chunk's compacted term rows; the pair
// list SCORE_TW x SCORE_SWIN; the column map and columns 2 SCORE_SWIN; the
// counts tile SCORE_TILE_WORDS; the staged keys dense_cap x slice; the
// nodes' key masks slice; with copies > 0 the count tables copies x gcap x
// V, the merged bucket slice gcap x vslice and the local merged table gcap
// x V, and the key histograms gcap x V, gcap x vslice, gcap x V. Then
// bytes: the tile's selector bytes SCORE_SEL_BYTES, with copies > 0 the
// presence tables gcap x V, gcap x vslice, gcap x V and the key presence
// gcap x V; rounded up to 16. ops/topology.spread_score_layout computes the
// same bytes.
__host__ __device__ __forceinline__ size_t spread_score_smem_bytes(const SpreadArgs& a) {
  size_t words = 9 * (size_t)a.R + (score_by_bucket(a.R, a.V) ? 2 * (size_t)a.R * a.V : 0) + 11 * (size_t)a.TT +
                 a.R + 1 +
                 SCORE_TW * (size_t)term_row_words(a.ML, a.EX, a.VALS, 0) + (size_t)SCORE_TW * SCORE_SWIN +
                 2 * SCORE_SWIN + SCORE_TILE_WORDS + ((size_t)a.dense_cap + 1) * a.slice;
  size_t bytes = SCORE_SEL_BYTES;
  if (a.copies > 0) {
    const size_t cells = (size_t)a.gcap * a.V, vs = (size_t)a.gcap * a.vslice;
    words += a.copies * cells + vs + cells + 2 * cells + vs;
    bytes += 3 * cells + vs;
  }
  return 4 * words + ((bytes + 15) & ~(size_t)15);
}

// node x's dense label at key `slot` (clipped), or -1 where it has none
__device__ __forceinline__ int32_t score_dense(const SpreadArgs& a, int x, int32_t slot) {
  const int sc = slot < 0 ? 0 : (slot > a.K - 1 ? a.K - 1 : slot);
  const int32_t d = __ldg(a.label_dense + (int64_t)x * a.K + sc);
  return (d >= 0 && slot >= 0) ? d : -1;
}

// MaxNodeScore * (total - count) floor-divided by diff (the reference's int64
// arithmetic), with a 32-bit division where the operands fit
__device__ __forceinline__ int64_t spread_node_score(int64_t total, int64_t cn, int64_t diff) {
  if (diff <= 0) return MAX_NODE_SCORE;
  const int64_t num = MAX_NODE_SCORE * (total - cn);
  if (num >= 0 && num <= 0xFFFFFFFFll && diff <= 0xFFFFFFFFll) return (int64_t)((uint32_t)num / (uint32_t)diff);
  return floordiv(num, diff);
}

__global__ void __launch_bounds__(THREADS) spread_score_cluster_kernel(const __grid_constant__ SpreadArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int32_t warp_cnt[THREADS / 32];
  __shared__ int n_groups, n_keys, n_pairs, n_generic;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.x, C = a.C, tid = threadIdx.x, V = a.V, R = a.R, TT = a.TT;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * R;
  const int nrows = min(R, a.U - r0);
  const size_t cells = a.copies > 0 ? (size_t)a.gcap * V : 0;
  const size_t vcells = a.copies > 0 ? (size_t)a.gcap * a.vslice : 0;
  const int rwords = term_row_words(a.ML, a.EX, a.VALS, 0);

  const bool by_bucket = score_by_bucket(R, V);
  int64_t* p_total = (int64_t*)dyn;  // [R] this slice's
  int64_t* q_total = p_total + R;    // [R] the cluster's
  int64_t* ftab = q_total + R;       // [R, V] a one-key row's score by clamped bucket
  int32_t* p_min = (int32_t*)(ftab + (by_bucket ? (size_t)R * V : 0));
  int32_t* p_any = p_min + R;
  int32_t* q_min = p_any + R;  // [R] the cluster's
  int32_t* q_any = q_min + R;
  uint32_t* rmask = (uint32_t*)(q_any + R);  // [R] bit 31 and the row's keys
  int32_t* terms = (int32_t*)(rmask + R);    // [TT] the rows' soft terms, ascending
  int32_t* t_own = terms + TT;   // [TT] their owners
  int32_t* t_key = t_own + TT;   // [TT] and keys
  int32_t* tgrp = t_key + TT;    // [TT] each listed term's group
  int32_t* g_row = tgrp + TT;    // per group: its row - r0
  int32_t* g_slot = g_row + TT;  //   its key
  int32_t* g_key = g_slot + TT;  //   its key's index
  int32_t* g_size = g_key + TT;  //   its terms
  int32_t* g_lead = g_size + TT;  //  its first term
  int32_t* keys = g_lead + TT;   // [TT] the distinct keys
  int32_t* scratch = keys + TT;  // [TT]
  int32_t* rg = scratch + TT;    // [R + 1] row r's groups: [rg[r], rg[r + 1])
  int32_t* crows = rg + R + 1;   // [SCORE_TW, rwords] a chunk's compacted term rows
  int32_t* pairs = crows + SCORE_TW * rwords;       // [SCORE_TW * SCORE_SWIN]
  int32_t* colmap = pairs + SCORE_TW * SCORE_SWIN;  // [SCORE_SWIN]
  int32_t* cols = colmap + SCORE_SWIN;              // [SCORE_SWIN]
  int16_t* ctile = (int16_t*)(cols + SCORE_SWIN);   // [tile nodes, stride]
  int32_t* dense = cols + SCORE_SWIN + SCORE_TILE_WORDS;      // [dense_cap, slice]
  uint32_t* kb = (uint32_t*)(dense + (size_t)a.dense_cap * a.slice);  // [slice]
  int32_t* pcnt = (int32_t*)(kb + a.slice);  // [copies, gcap, V]
  int32_t* mcnt = pcnt + a.copies * cells;   // [gcap, vslice]
  int32_t* lcnt = mcnt + vcells;             // [gcap, V]
  int32_t* kh = lcnt + cells;                // [gcap, V] members a key's bucket holds
  int32_t* mkh = kh + cells;                 // [gcap, vslice]
  int32_t* lkh = mkh + vcells;               // [gcap, V]
  uint8_t* stile = (uint8_t*)(lkh + cells);  // [R, tile nodes]
  uint8_t* ppres = stile + SCORE_SEL_BYTES;  // [gcap, V]
  uint8_t* mpres = ppres + cells;            // [gcap, vslice]
  uint8_t* lpres = mpres + vcells;           // [gcap, V]
  uint8_t* kpres = lpres + cells;            // [gcap, V]

  const int n0 = c * a.slice, n1 = min(a.N, n0 + a.slice), ns = max(n1 - n0, 0);
  const int v0 = min(V, c * a.vslice), v1 = min(V, v0 + a.vslice);

  // 1. the rows' soft terms, their groups (ordered by row) and keys
  if (tid == 0) n_groups = n_keys = n_generic = 0;
  for (int r = tid; r < R; r += THREADS) {
    p_total[r] = q_total[r] = 0;
    p_min[r] = q_min[r] = BIG_COUNT;
    p_any[r] = q_any[r] = 0;
  }
  const int nt = ordered_compact(
      TT,
      [&](int t) {
        const int32_t o = a.t_owner[t];
        return a.t_valid[t] && a.t_kind[t] == SPREAD_SOFT && o >= r0 && o < r0 + nrows;
      },
      terms, warp_cnt);
  for (int i = tid; i < nt; i += THREADS) {
    t_own[i] = a.t_owner[terms[i]];
    t_key[i] = a.t_topo_slot[terms[i]];
  }
  __syncthreads();
  for (int i = tid; i < nt; i += THREADS) {  // each term's group leader: the first term on its (owner, key)
    int lead = i;
    for (int j = 0; j < i; ++j) {
      if (t_own[j] == t_own[i] && t_key[j] == t_key[i]) {
        lead = j;
        break;
      }
    }
    scratch[i] = lead;
  }
  __syncthreads();
  for (int i = tid; i < nt; i += THREADS) {  // the leaders ranked by (row, position)
    if (scratch[i] != i) continue;
    const int32_t o = t_own[i];
    int rank = 0, size = 0;
    for (int j = 0; j < nt; ++j) {
      const int lj = scratch[j];
      size += lj == i;
      rank += lj == j && (t_own[j] < o || (t_own[j] == o && j < i));
    }
    g_row[rank] = o - r0;
    g_slot[rank] = t_key[i];
    g_size[rank] = size;
    g_lead[rank] = terms[i];
    tgrp[i] = rank;
    atomicAdd(&n_groups, 1);
  }
  __syncthreads();
  const int G = n_groups;
  for (int i = tid; i < nt; i += THREADS) {
    if (scratch[i] != i) tgrp[i] = tgrp[scratch[i]];
  }
  for (int r = tid; r <= R; r += THREADS) {
    int k = 0;
    for (int g = 0; g < G; ++g) k += g_row[g] < r;
    rg[r] = k;
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {  // each group's key leader
    int l = g;
    for (int h = 0; h < g; ++h) {
      if (g_slot[h] == g_slot[g]) {
        l = h;
        break;
      }
    }
    scratch[g] = l;
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    if (scratch[g] != g) continue;
    int k = 0;
    for (int h = 0; h < g; ++h) k += scratch[h] == h;
    keys[k] = g_slot[g];
    g_key[g] = k;
    atomicAdd(&n_keys, 1);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    if (scratch[g] != g) g_key[g] = g_key[scratch[g]];
  }
  if (G == 0) {  // no soft term in these rows: zeros, nothing read
    for (int r = 0; r < nrows; ++r) {
      int64_t* out = a.out + (int64_t)(r0 + r) * a.N;
      for (int x = n0 + tid; x < n1; x += THREADS) out[x] = 0;
    }
    return;
  }
  __syncthreads();
  const int D = n_keys;
  const bool masks = D <= KEY_BITS;  // else membership walks the row's groups
  // the tables in shared memory, unless the layout put them in device
  // memory or these rows hold more groups than the shared tables (uniform
  // over the cluster: every CTA takes the same rows)
  const bool shared_tables = a.copies > 0 && G <= a.gcap;
  for (int r = tid; r < nrows; r += THREADS) {
    uint32_t m = 1u << 31;
    for (int g = rg[r]; g < rg[r + 1] && masks; ++g) m |= 1u << g_key[g];
    rmask[r] = m;
    // a row takes the per-node path when it has several keys, or the tables live in device memory
    if (rg[r + 1] - rg[r] > 1 || !shared_tables) atomicAdd(&n_generic, 1);
  }

  // 2. the slice's labels at the staged keys and key masks; clear the
  // tables; presence and the key histograms
  const int dcap = min(D, a.dense_cap);
  for (int d = 0; d < dcap; ++d) {  // the slice's labels at the staged keys
    for (int xb = tid; xb < ns; xb += LOAD_BATCH * THREADS) {
      int32_t got[LOAD_BATCH];
#pragma unroll
      for (int q = 0; q < LOAD_BATCH; ++q) {  // the batch's loads first
        const int xl = xb + q * THREADS;
        got[q] = xl < ns ? score_dense(a, n0 + xl, keys[d]) : 0;
      }
#pragma unroll
      for (int q = 0; q < LOAD_BATCH; ++q) {
        const int xl = xb + q * THREADS;
        if (xl < ns) dense[d * a.slice + xl] = got[q];
      }
    }
  }
  __syncthreads();
  auto dense_at = [&](int d, int x) -> int32_t {
    return d < dcap ? dense[d * a.slice + (x - n0)] : score_dense(a, x, keys[d]);
  };
  for (int xl = tid; xl < ns; xl += THREADS) {
    uint32_t m = __ldg(a.n_valid + n0 + xl) ? 1u << 31 : 0u;
    for (int d = 0; d < D && masks; ++d) m |= dense_at(d, n0 + xl) >= 0 ? 1u << d : 0u;
    kb[xl] = m;
  }
  if (shared_tables) {
    for (int k = tid; k < a.copies * G * V; k += THREADS) {
      const int p = k / (G * V);
      pcnt[p * cells + (k - p * G * V)] = 0;
    }
    for (int k = tid; k < G * V; k += THREADS) ppres[k] = 0;
    for (int k = tid; k < D * V; k += THREADS) {
      kh[k] = 0;
      kpres[k] = 0;
    }
    for (int k = tid; k < G * a.vslice; k += THREADS) {
      mcnt[k] = 0;
      mpres[k] = 0;
    }
    for (int k = tid; k < D * a.vslice; k += THREADS) mkh[k] = 0;
    __syncthreads();
  } else {
    for (int g = 0; g < G; ++g) {
      for (int v = v0 + tid; v < v1; v += THREADS) {
        a.merged_cnt[(int64_t)g_lead[g] * V + v] = 0;
        a.merged_present[(int64_t)g_lead[g] * V + v] = 0;
      }
    }
    __threadfence();
    cluster.sync();  // every CTA's slice of the rows is clear
  }
  auto member_of = [&](int r, int x) -> bool {
    const uint32_t m = kb[x - n0];
    if (masks) return (m & rmask[r]) == rmask[r];
    if (!(m >> 31)) return false;
    for (int g = rg[r]; g < rg[r + 1]; ++g) {
      if (dense_at(g_key[g], x) < 0) return false;
    }
    return true;
  };
  if (shared_tables) {  // per key: presence and the member histogram
    for (int d = 0; d < D; ++d) {
      for (int x = n0 + tid; x < n1; x += THREADS) {
        if (!(kb[x - n0] >> 31)) continue;
        const int32_t b = dense_at(d, x);
        if (b < 0) continue;
        if (b < V) kpres[d * V + b] = 1;  // segment_sum drops out-of-range buckets
        atomicAdd(&kh[d * V + (b > V - 1 ? V - 1 : b)], 1);  // gathers clamp
      }
    }
    __syncthreads();
    for (int k = tid; k < G * V; k += THREADS) {  // a one-key row's presence is its key's
      const int g = k / V, r = g_row[g];
      if (rg[r + 1] - rg[r] == 1) ppres[k] = kpres[g_key[g] * V + (k - g * V)];
    }
  }
  if (n_generic) {  // a row with several keys (or device tables): its member nodes' buckets
    for (int r = 0; r < nrows; ++r) {
      if ((shared_tables && rg[r + 1] - rg[r] < 2) || rg[r] == rg[r + 1]) continue;
      for (int x = n0 + tid; x < n1; x += THREADS) {
        if (!member_of(r, x)) continue;
        for (int g = rg[r]; g < rg[r + 1]; ++g) {
          const int32_t b = dense_at(g_key[g], x);  // >= 0: a member carries every key
          if (b >= V) continue;
          if (shared_tables) {
            ppres[g * V + b] = 1;
          } else {
            a.merged_present[(int64_t)g_lead[g] * V + b] = 1;
          }
        }
      }
    }
  }

  // 3. the counts: per chunk of terms and window of signatures, the matched
  // pairs; per node tile the counts and selector bytes staged once for
  // every row
  const TermSel bank{a.t_valid, a.t_has_selector, a.t_ml_slot, a.t_ml_val, a.t_ex_op, a.t_ex_slot, a.t_ex_vals,
                     nullptr, nullptr, a.ML, a.EX, a.VALS, 0};
  int32_t* mine = pcnt + (shared_tables ? (size_t)(warp % a.copies) * cells : 0);
  for (int i0 = 0; i0 < nt; i0 += SCORE_TW) {
    const int tw = min(SCORE_TW, nt - i0);
    __syncthreads();  // the previous chunk's rows are no longer read
    if (tid < tw) compact_term(bank, terms[i0 + tid], a.KE, false, crows + tid * rwords);
    for (int s0 = 0; s0 < a.S; s0 += SCORE_SWIN) {
      const int sw = min(SCORE_SWIN, a.S - s0);
      __syncthreads();  // the previous window's list and columns are no longer read
      if (tid == 0) n_pairs = 0;
      for (int k = tid; k < SCORE_SWIN; k += THREADS) colmap[k] = 0;
      __syncthreads();
      for (int sl = tid; sl < sw; sl += THREADS) {  // a signature against the chunk's terms
        const int s = s0 + sl;
        if (!__ldg(a.e_valid + s)) continue;
        const int32_t* lab = a.e_labels + (int64_t)s * a.KE;
        for (int il = 0; il < tw; ++il) {
          if (eval_term(crows + il * rwords, 0, [&](int sc) { return __ldg(lab + sc); }, 0)) {
            pairs[atomicAdd(&n_pairs, 1)] = (sl << 16) | tgrp[i0 + il];
            colmap[sl] = 1;
          }
        }
      }
      __syncthreads();
      const int np = n_pairs;
      if (np == 0) continue;
      const int ncol = ordered_compact(sw, [&](int k) { return colmap[k] != 0; }, cols, warp_cnt);
      for (int j = tid; j < ncol; j += THREADS) {
        const int k = cols[j];
        colmap[k] = j;
        cols[j] = s0 + k;
      }
      __syncthreads();
      for (int k = tid; k < np; k += THREADS) {
        const int32_t e = pairs[k];
        pairs[k] = (colmap[e >> 16] << 16) | (e & 0xFFFF);
      }
      // as many nodes a tile as the matched columns and the rows' selector
      // bytes leave room for; the counts at an odd word stride (no bank
      // conflicts along the nodes)
      const int stride = ((ncol + 1) & ~3) + 2;
      const int tn_max = min(2 * SCORE_TILE_WORDS / stride, SCORE_SEL_BYTES / nrows);
      for (int x0 = n0; x0 < n1; x0 += tn_max) {
        const int tn = min(tn_max, n1 - x0);
        __syncthreads();  // the pairs are remapped; the previous tile is no longer read
        {  // the counts at the matched columns: 2^cshift lanes a node row, no division
          int cshift = 0;
          while ((1 << cshift) < ncol) ++cshift;
          const int per = THREADS >> cshift, j = tid & ((1 << cshift) - 1);
          const int col = j < ncol ? cols[j] : 0;
          for (int xb = tid >> cshift; xb < tn; xb += LOAD_BATCH * per) {
            int16_t got[LOAD_BATCH];
#pragma unroll
            for (int q = 0; q < LOAD_BATCH; ++q) {  // the batch's loads first
              const int xl = xb + q * per;
              got[q] = (j < ncol && xl < tn) ? __ldg(a.counts + (int64_t)(x0 + xl) * a.S + col) : 0;
            }
#pragma unroll
            for (int q = 0; q < LOAD_BATCH; ++q) {
              const int xl = xb + q * per;
              if (j < ncol && xl < tn) ctile[xl * stride + j] = got[q];
            }
          }
        }
        for (int xl = tid; xl < tn; xl += THREADS) {  // the rows' selector bytes: a thread a node
          for (int rb = 0; rb < nrows; rb += LOAD_BATCH) {
            uint8_t got[LOAD_BATCH];
#pragma unroll
            for (int q = 0; q < LOAD_BATCH; ++q) {
              const int r = rb + q;
              got[q] = r < nrows ? __ldg(a.sel + (int64_t)(r0 + r) * a.N + x0 + xl) : 0;
            }
#pragma unroll
            for (int q = 0; q < LOAD_BATCH; ++q) {
              if (rb + q < nrows) stile[(rb + q) * tn + xl] = got[q];
            }
          }
        }
        __syncthreads();
        const bool row_bits = masks && nrows <= 32;
        for (int xl = tid; xl < tn; xl += THREADS) {
          const int x = x0 + xl;
          // the node's counting rows (member, raw selector) and its bucket at
          // the first key, before the pairs: a pair's tail stays short
          uint32_t cb = 0;
          for (int r = 0; r < nrows && row_bits; ++r) {
            cb |= (stile[r * tn + xl] && (kb[x - n0] & rmask[r]) == rmask[r]) ? 1u << r : 0u;
          }
          const int32_t b0 = dense_at(0, x);
          for (int k = 0; k < np; ++k) {
            const int32_t e = pairs[k];
            const int32_t cn = ctile[xl * stride + (e >> 16)];
            if (cn == 0) continue;
            const int g = e & 0xFFFF, r = g_row[g], d = g_key[g];
            if (row_bits ? !((cb >> r) & 1u) : (!stile[r * tn + xl] || !member_of(r, x))) continue;
            const int32_t b = d == 0 ? b0 : dense_at(d, x);
            if (b >= V) continue;
            if (shared_tables) {
              atomicAdd(&mine[g * V + b], cn);
            } else {
              atomicAdd(&a.merged_cnt[(int64_t)g_lead[g] * V + b], cn);
            }
          }
        }
      }
    }
  }

  // 4. the tables over the copies and the cluster
  __syncthreads();
  if (shared_tables) {
    for (int k = tid; k < G * V && a.copies > 1; k += THREADS) {
      int32_t s = pcnt[k];
      for (int p = 1; p < a.copies; ++p) s += pcnt[p * cells + k];
      pcnt[k] = s;
    }
  } else {
    __threadfence();
  }
  cluster.sync();  // every CTA's partial tables are complete
  if (shared_tables) {  // this CTA's bucket slice summed over the cluster: a thread per (cell, CTA)
    const int vs = v1 - v0;
    for (int k = tid; k < (G + D) * vs * C; k += THREADS) {
      const int rk = k % C, gv = k / C, g = gv / vs, v = v0 + (gv - g * vs);
      if (g < G) {
        const int32_t cn = *cluster.map_shared_rank(&pcnt[g * V + v], rk);
        const uint8_t pr = *cluster.map_shared_rank(&ppres[g * V + v], rk);
        if (cn) atomicAdd(&mcnt[g * a.vslice + v - v0], cn);
        if (pr) mpres[g * a.vslice + v - v0] = 1;
      } else {
        const int32_t h = *cluster.map_shared_rank(&kh[(g - G) * V + v], rk);
        if (h) atomicAdd(&mkh[(g - G) * a.vslice + v - v0], h);
      }
    }
    cluster.sync();  // every CTA's merged bucket slice is in place
    for (int k = tid; k < (G + D) * V; k += THREADS) {
      const int g = k / V, v = k - g * V, rk = v / a.vslice, off = v - rk * a.vslice;
      if (g < G) {
        lcnt[k] = *cluster.map_shared_rank(&mcnt[g * a.vslice + off], rk);
        lpres[k] = *cluster.map_shared_rank(&mpres[g * a.vslice + off], rk);
      } else {
        lkh[k - G * V] = *cluster.map_shared_rank(&mkh[(g - G) * a.vslice + off], rk);
      }
    }
    __syncthreads();
  }

  // 5. per row: the node counts, the total, minimum and membership, the score
  auto bucket_count = [&](int g, int bc) -> uint32_t {  // group g's merged count at bucket bc, where present
    int32_t cn;
    uint8_t pr;
    if (shared_tables) {
      cn = lcnt[g * V + bc];
      pr = lpres[g * V + bc];
    } else {
      const int64_t i = (int64_t)g_lead[g] * V + bc;
      cn = __ldcg(a.merged_cnt + i);
      pr = __ldcg(a.merged_present + i);
    }
    return pr ? (uint32_t)g_size[g] * (uint32_t)cn : 0u;
  };
  auto node_count = [&](int r, int x) -> int32_t {
    uint32_t nc = 0;  // int32 with the reference's wrap-around
    for (int g = rg[r]; g < rg[r + 1]; ++g) {
      const int32_t d = dense_at(g_key[g], x);
      if (d >= 0) nc += bucket_count(g, d > V - 1 ? V - 1 : d);  // gathers clamp
    }
    return (int32_t)nc;
  };
  for (int r = warp; r < nrows && shared_tables; r += THREADS / 32) {  // a one-key row: from its key's histogram
    if (rg[r + 1] - rg[r] != 1) continue;
    const int g = rg[r];
    int64_t tot = 0;
    int32_t mn = BIG_COUNT;
    int any = 0;
    for (int bc = lane; bc < V; bc += 32) {
      const int32_t h = lkh[g_key[g] * V + bc];
      if (!h) continue;
      const int32_t cn = (int32_t)bucket_count(g, bc);
      tot += (int64_t)h * cn;
      mn = cn < mn ? cn : mn;
      any = 1;
    }
    for (int off = 16; off > 0; off >>= 1) {
      tot += __shfl_xor_sync(0xffffffffu, (long long)tot, off);
      const int32_t o = __shfl_xor_sync(0xffffffffu, mn, off);
      mn = o < mn ? o : mn;
      any |= __shfl_xor_sync(0xffffffffu, any, off);
    }
    if (lane == 0) {
      q_total[r] = tot;
      q_min[r] = mn;
      q_any[r] = any;
    }
  }
  const int chunks = (ns + SCORE_CHUNK - 1) / SCORE_CHUNK;
  if (n_generic) {  // another row: over its slice nodes, then over the cluster
    for (int it = warp; it < nrows * chunks; it += THREADS / 32) {
      const int r = it / chunks, xa = n0 + (it - r * chunks) * SCORE_CHUNK, xb = min(n1, xa + SCORE_CHUNK);
      if (rg[r] == rg[r + 1] || (shared_tables && rg[r + 1] - rg[r] == 1)) continue;
      int64_t tot = 0;
      int32_t mn = BIG_COUNT;
      int any = 0;
      for (int x = xa + lane; x < xb; x += 32) {
        if (!member_of(r, x)) continue;
        const int32_t cn = node_count(r, x);
        tot += cn;
        mn = cn < mn ? cn : mn;
        any = 1;
      }
      for (int off = 16; off > 0; off >>= 1) {
        tot += __shfl_xor_sync(0xffffffffu, (long long)tot, off);
        const int32_t o = __shfl_xor_sync(0xffffffffu, mn, off);
        mn = o < mn ? o : mn;
        any |= __shfl_xor_sync(0xffffffffu, any, off);
      }
      if (lane == 0 && any) {
        atomicAdd((unsigned long long*)&p_total[r], (unsigned long long)tot);
        atomicMin(&p_min[r], mn);
        atomicOr(&p_any[r], 1);
      }
    }
    cluster.sync();  // every CTA's row partials are complete
    for (int i = tid; i < nrows * C; i += THREADS) {  // a thread per (row, CTA)
      const int r = i / C, rk = i - r * C;
      if (rg[r] == rg[r + 1] || (shared_tables && rg[r + 1] - rg[r] == 1)) continue;
      if (!*cluster.map_shared_rank(&p_any[r], rk)) continue;
      atomicAdd((unsigned long long*)&q_total[r], (unsigned long long)*cluster.map_shared_rank(&p_total[r], rk));
      atomicMin(&q_min[r], *cluster.map_shared_rank(&p_min[r], rk));
      q_any[r] = 1;
    }
  }
  cluster_arrive();  // this CTA's reads of the others' shared memory are done
  __syncthreads();
  const bool fast = shared_tables && by_bucket && masks;  // one-key rows write from their score by bucket
  for (int i = tid; i < nrows * V && fast; i += THREADS) {
    const int r = i / V, bc = i - r * V;
    if (rg[r + 1] - rg[r] != 1) continue;
    const int64_t total = q_total[r], diff = total - (q_any[r] ? q_min[r] : 0);
    ftab[i] = spread_node_score(total, (int32_t)bucket_count(rg[r], bc), diff);
  }
  __syncthreads();
  for (int it = warp; it < nrows * chunks; it += THREADS / 32) {
    const int r = it / chunks, xa = n0 + (it - r * chunks) * SCORE_CHUNK, xb = min(n1, xa + SCORE_CHUNK);
    int64_t* out = a.out + (int64_t)(r0 + r) * a.N;
    if (rg[r] == rg[r + 1]) {  // no soft term: zeros, nothing read
      for (int x = xa + lane; x < xb; x += 32) out[x] = 0;
      continue;
    }
    if (fast && rg[r + 1] - rg[r] == 1) {
      const uint32_t m = rmask[r];
      const int d = g_key[rg[r]];
      const int64_t* f = ftab + (size_t)r * V;
      for (int x = xa + lane; x < xb; x += 32) {
        const int32_t b = dense_at(d, x);  // a member carries the key: b >= 0
        out[x] = (kb[x - n0] & m) == m ? f[b > V - 1 ? V - 1 : b] : 0;
      }
      continue;
    }
    const int64_t total = q_total[r], diff = total - (q_any[r] ? q_min[r] : 0);
    for (int x = xa + lane; x < xb; x += 32) {
      out[x] = member_of(r, x) ? spread_node_score(total, node_count(r, x), diff) : 0;
    }
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

extern "C" int ktpu_spread_score(const SpreadArgs* args, cudaStream_t stream) {
  const SpreadArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.R < 1 || a.C < 1 || a.C > MAX_CLUSTER || a.V < 1 || a.TT < 0 || a.TT > 0xFFFF || a.S < 0 || a.KE < 1 ||
      a.dense_cap < 0 || a.copies < 0 || a.gcap < 0 || (size_t)a.C * a.slice < (size_t)a.N ||
      (size_t)a.C * a.vslice < (size_t)a.V || spread_score_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster((const void*)spread_score_cluster_kernel, a.C, THREADS, (size_t)a.smem, a, stream,
                        (a.U + a.R - 1) / a.R);
}

// ---------------------------------------------------------------------------
// spread_filter: ONE launch, a grid of U thread-block clusters of C CTAs,
// one cluster a spec row u; CTA c of the cluster owns the node slice
// [c * slice, (c + 1) * slice) and the bucket slice [c * vslice, ...).
//
//   1. The row's DoNotSchedule terms, in ascending term order (so every
//      CTA of the cluster walks the same groups); its candidate nodes
//      (valid, the raw node selector, every hard key present) and a
//      per-node state word in shared memory (the skew tests passed so far,
//      the candidate bit, the bucket at the current group's key).
//   2. Per (row, topology key) group, in the order of its first term:
//      a. the node's bucket at the key into the state word;
//      b. the signatures any of the group's terms matches (term_matches
//         with namespaces, inside the launch), with their multiplicity,
//         in windows of SPREAD_LIST; per candidate node the matched
//         counts summed, into per-warp copies of a V-wide count and
//         presence table in shared memory (folded into copy 0) — or, past
//         shared memory, with global atomics straight into the group's
//         first term's rows of merged_cnt / merged_present;
//      c. a cluster barrier; CTA c sums its bucket slice over the C
//         partial tables through distributed shared memory, writes it to
//         every group term's rows, and takes the slice's minimum over
//         present values and whether any is present;
//      d. a cluster barrier; every CTA reads the C partial minima (and,
//         for a small V, copies the whole merged table locally); rank 0
//         writes min_t and any_pair_t of the group's terms;
//      e. each node's skew test for each group term, the table read at the
//         clamped bucket (locally, from the owning CTA's shared memory,
//         or from device memory), ANDed into the state word.
//   3. The mask (every test passed, or no value present for any of the
//      row's groups) and the default rows of the tables for terms no
//      spec row owns; the exit waits on a split cluster barrier so no CTA
//      leaves while another reads its shared memory.
//
// The tables (cand, merged_cnt, merged_present, min_t, any_pair_t) are the
// arbiter's, with spread_hard_tables_plain's contents: a term that is not a
// DoNotSchedule term of some spec row has zero rows, min_t = BIG_COUNT and
// no pair.
// ---------------------------------------------------------------------------

#define SPREAD_LIST 1024        // matched signatures a window
#define SPREAD_BATCH 4          // nodes a thread loads for at once
#define ST_OK 0x80000000u       // every skew test so far passed
#define ST_CAND 0x40000000u     // a candidate node
#define ST_BUCKET 0x3FFFFFFFu   // min(bucket, V), or ST_BUCKET: no key

struct SpreadFilterArgs {
  const uint8_t* t_valid;         // [TT]
  const int32_t* t_kind;          // [TT]
  const int32_t* t_owner;         // [TT]
  const int32_t* t_topo_slot;     // [TT]
  const uint8_t* t_self_match;    // [TT]
  const int32_t* t_weight;        // [TT] max_skew
  const uint8_t* t_has_selector;  // [TT]
  const int32_t* t_ml_slot;       // [TT, ML]
  const int32_t* t_ml_val;        // [TT, ML]
  const int32_t* t_ex_op;         // [TT, EX]
  const int32_t* t_ex_slot;       // [TT, EX]
  const int32_t* t_ex_vals;       // [TT, EX, VALS]
  const uint8_t* t_ns_any;        // [TT]
  const int32_t* t_ns_ids;        // [TT, NS]
  const int32_t* e_labels;        // [S, KE] signature labels
  const int32_t* e_ns;            // [S]
  const uint8_t* e_valid;         // [S]
  const int16_t* counts;          // [N, S]
  const uint8_t* n_valid;         // [N]
  const int32_t* label_dense;     // [N, K]
  const uint8_t* sel;             // [U, N] raw PodMatchNodeSelector
  uint8_t* cand;                  // [U, N]
  int32_t* merged_cnt;            // [TT, V]
  uint8_t* merged_present;        // [TT, V]
  int32_t* min_t;                 // [TT]
  uint8_t* any_pair_t;            // [TT]
  uint8_t* mask;                  // [U, N]
  int32_t TT, S, N, K, KE, ML, EX, VALS, NS, U, V;
  // the launch (ops/topology.spread_filter_layout): C CTAs a spec row, the
  // node and bucket slices of a CTA, the per-warp table copies (0: the
  // tables in device memory), a local copy of the merged table, and the
  // dynamic shared memory
  int32_t C, slice, vslice, copies, local_table, smem;
};

// the dynamic shared memory of a CTA, in this order: the row's terms [TT],
// a window's signatures and multiplicities [SPREAD_LIST] each, the node
// states [slice] (all int32); with copies > 0 the partial count tables
// [copies, V], the merged bucket slice's counts [vslice] and (local_table)
// the local merged counts [V], int32, then the same three as presence
// bytes. ops/topology.spread_filter_layout computes the same bytes.
__host__ __device__ __forceinline__ size_t spread_filter_smem_bytes(const SpreadFilterArgs& a) {
  size_t bytes = 4 * ((size_t)a.TT + 2 * SPREAD_LIST + (size_t)a.slice);
  if (a.copies > 0) {
    bytes += 5 * ((size_t)a.copies * a.V + a.vslice);
    if (a.local_table) bytes += 5 * (size_t)a.V;
  }
  return bytes;
}

// the dense label of node x at a term's slot (clipped; -1: absent)
__device__ __forceinline__ int32_t ldg_dense(const SpreadFilterArgs& a, int x, int32_t slot) {
  const int sc = slot < 0 ? 0 : (slot > a.K - 1 ? a.K - 1 : slot);
  return __ldg(a.label_dense + (int64_t)x * a.K + sc);
}

__device__ __forceinline__ bool is_hard_of(const SpreadFilterArgs& a, int t, int u) {
  return a.t_valid[t] && a.t_kind[t] == SPREAD_HARD && a.t_owner[t] == u;
}

// Append the DoNotSchedule terms of spec row u to `list` in ascending term
// order (a block-wide ordered compaction); returns their count.
__device__ int ordered_hard_terms(const SpreadFilterArgs& a, int u, int32_t* list, int32_t* warp_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < a.TT; base += THREADS) {
    const int t = base + threadIdx.x;
    const bool f = t < a.TT && is_hard_of(a, t, u);
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = total, sum = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      off += w < warp ? warp_cnt[w] : 0;
      sum += warp_cnt[w];
    }
    if (f) list[off + __popc(bal & ((1u << lane) - 1u))] = t;
    total += sum;
    __syncthreads();
  }
  return total;
}

// the skew test of a term (its self-match and max skew) at a node whose
// value's merged count is match_num (int32 arithmetic with the reference's
// wrap-around)
__device__ __forceinline__ bool skew_ok(bool self_match, int32_t max_skew, int32_t match_num, int32_t mn) {
  const uint32_t lhs = (uint32_t)match_num + (self_match ? 1u : 0u) - (uint32_t)mn;
  return (int32_t)lhs <= max_skew;
}

__global__ void __launch_bounds__(THREADS) spread_filter_cluster_kernel(const SpreadFilterArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int32_t warp_cnt[THREADS / 32];
  __shared__ int64_t red[THREADS / 32];
  __shared__ int n_sigs;
  __shared__ int32_t part_min, part_any;  // this CTA's bucket slice, read by the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int u = blockIdx.y, c = blockIdx.x, C = a.C, tid = threadIdx.x, V = a.V;
  const bool shared_tables = a.copies > 0;
  int32_t* terms = (int32_t*)dyn;
  int32_t* sig_s = terms + a.TT;
  int32_t* sig_m = sig_s + SPREAD_LIST;
  uint32_t* state = (uint32_t*)(sig_m + SPREAD_LIST);
  int32_t* pcnt = (int32_t*)(state + a.slice);                    // [copies, V]
  int32_t* mcnt = pcnt + (size_t)(shared_tables ? a.copies : 0) * V;  // [vslice]
  int32_t* lcnt = mcnt + (shared_tables ? a.vslice : 0);           // [V] (local_table)
  uint8_t* ppres = (uint8_t*)(lcnt + (a.local_table ? V : 0));
  uint8_t* mpres = ppres + (size_t)(shared_tables ? a.copies : 0) * V;
  uint8_t* lpres = mpres + (shared_tables ? a.vslice : 0);

  const int n0 = c * a.slice;
  const int n1 = min(a.N, n0 + a.slice);
  const int v0 = min(V, c * a.vslice);
  const int v1 = min(V, v0 + a.vslice);
  const int64_t row = (int64_t)u * a.N;

  // 1. the row's terms; candidates and node states
  // (the first group's buckets come with the candidates: its key is the
  // first term's)
  const int nt = ordered_hard_terms(a, u, terms, warp_cnt);
  const int32_t slot0 = nt > 0 ? a.t_topo_slot[terms[0]] : -1;
  for (int x0 = n0 + tid; x0 < n1; x0 += SPREAD_BATCH * THREADS) {
    int32_t d0[SPREAD_BATCH];
    bool vs[SPREAD_BATCH];
#pragma unroll
    for (int k = 0; k < SPREAD_BATCH; ++k) {  // the batch's loads first
      const int x = x0 + k * THREADS;
      vs[k] = x < n1 && __ldg(a.n_valid + x) && __ldg(a.sel + row + x);
      d0[k] = (x < n1 && nt > 0) ? ldg_dense(a, x, slot0) : -1;
    }
#pragma unroll
    for (int k = 0; k < SPREAD_BATCH; ++k) {
      const int x = x0 + k * THREADS;
      if (x >= n1) continue;
      const bool has0 = d0[k] >= 0 && slot0 >= 0;
      bool cand = vs[k] && (nt == 0 || has0);
      for (int i = 1; i < nt && cand; ++i) {
        const int32_t si = a.t_topo_slot[terms[i]];
        cand = ldg_dense(a, x, si) >= 0 && si >= 0;
      }
      a.cand[row + x] = cand ? 1 : 0;
      state[x - n0] = ST_OK | (cand ? ST_CAND : 0u) | (has0 ? (uint32_t)(d0[k] < V ? d0[k] : V) : ST_BUCKET);
    }
  }
  __syncthreads();

  // 2. the groups: one per distinct key, led by its first term
  bool any_row = false;
  for (int i = 0; i < nt; ++i) {
    const int32_t slot = a.t_topo_slot[terms[i]];
    bool lead = true;
    for (int j = 0; j < i && lead; ++j) lead = a.t_topo_slot[terms[j]] != slot;
    if (!lead) continue;
    const int64_t lead_row = (int64_t)terms[i] * V;

    // a. clear the tables; the node buckets at this key
    if (shared_tables) {
      for (int k = tid; k < a.copies * V; k += THREADS) {
        pcnt[k] = 0;
        ppres[k] = 0;
      }
    } else {
      for (int v = v0 + tid; v < v1; v += THREADS) {
        a.merged_cnt[lead_row + v] = 0;
        a.merged_present[lead_row + v] = 0;
      }
    }
    for (int x = n0 + tid; x < n1 && i > 0; x += THREADS) {
      const int32_t d = ldg_dense(a, x, slot);
      const uint32_t bb = (d >= 0 && slot >= 0) ? (uint32_t)(d < V ? d : V) : ST_BUCKET;
      state[x - n0] = (state[x - n0] & (ST_OK | ST_CAND)) | bb;
    }
    if (shared_tables) {
      __syncthreads();
    } else {
      __threadfence();
      cluster.sync();  // every CTA's slice of the rows is clear
    }

    // b. per window of signatures: the matched ones, then the counts
    const int copy = (tid >> 5) % (shared_tables ? a.copies : 1);
    int s0 = 0;
    do {
      if (tid == 0) n_sigs = 0;
      __syncthreads();
      const int s1 = min(a.S, s0 + SPREAD_LIST);
      for (int s = s0 + tid; s < s1; s += THREADS) {
        if (!a.e_valid[s]) continue;
        int mult = 0;
        for (int j = i; j < nt; ++j) {
          const int t = terms[j];
          if (a.t_topo_slot[t] == slot &&
              selector_matches(a.t_valid, a.t_has_selector, a.t_ml_slot, a.t_ml_val, a.t_ex_op, a.t_ex_slot,
                               a.t_ex_vals, a.t_ns_any, a.t_ns_ids, a.e_labels, a.e_ns, a.KE, a.ML, a.EX, a.VALS,
                               a.NS, t, s)) {
            ++mult;
          }
        }
        if (mult) {
          const int k = atomicAdd(&n_sigs, 1);
          sig_s[k] = s;
          sig_m[k] = mult;
        }
      }
      __syncthreads();
      const int ns = n_sigs;
      if (ns > 0 || s0 == 0) {
        for (int x0 = n0 + tid; x0 < n1; x0 += SPREAD_BATCH * THREADS) {
          uint32_t bk[SPREAD_BATCH];
          int32_t cn[SPREAD_BATCH];
#pragma unroll
          for (int k = 0; k < SPREAD_BATCH; ++k) {
            const int x = x0 + k * THREADS;
            const uint32_t st = x < n1 ? state[x - n0] : 0u;
            // candidates only; segment_sum drops buckets >= V
            bk[k] = (st & ST_CAND) && (st & ST_BUCKET) < (uint32_t)V ? (st & ST_BUCKET) : ST_BUCKET;
            cn[k] = 0;
          }
          for (int j = 0; j < ns; ++j) {  // a signature's counts for the batch's nodes at once
            const int32_t sj = sig_s[j], mj = sig_m[j];
#pragma unroll
            for (int k = 0; k < SPREAD_BATCH; ++k) {
              if (bk[k] != ST_BUCKET) cn[k] += mj * (int32_t)__ldg(a.counts + (int64_t)(x0 + k * THREADS) * a.S + sj);
            }
          }
#pragma unroll
          for (int k = 0; k < SPREAD_BATCH; ++k) {
            if (bk[k] == ST_BUCKET) continue;
            if (shared_tables) {
              if (cn[k] != 0) atomicAdd(&pcnt[copy * V + bk[k]], cn[k]);
              if (s0 == 0) ppres[copy * V + bk[k]] = 1;
            } else {
              if (cn[k] != 0) atomicAdd(&a.merged_cnt[lead_row + bk[k]], cn[k]);
              if (s0 == 0) a.merged_present[lead_row + bk[k]] = 1;
            }
          }
        }
      }
      __syncthreads();
      s0 += SPREAD_LIST;
    } while (s0 < a.S);
    if (shared_tables && a.copies > 1) {
      for (int v = tid; v < V; v += THREADS) {
        int32_t cn = pcnt[v];
        uint8_t pr = ppres[v];
        for (int p = 1; p < a.copies; ++p) {
          cn += pcnt[p * V + v];
          pr |= ppres[p * V + v];
        }
        pcnt[v] = cn;
        ppres[v] = pr;
      }
    }
    if (!shared_tables) __threadfence();
    cluster.sync();  // every CTA's partial table is complete

    // c. this CTA's bucket slice: summed, written, its minimum
    int64_t mn = BIG_COUNT, any = 0;
    for (int v = v0 + tid; v < v1; v += THREADS) {
      int32_t cn = 0;
      uint8_t pr = 0;
      if (shared_tables) {
        for (int r = 0; r < C; ++r) {
          cn += *cluster.map_shared_rank(&pcnt[v], r);
          pr |= *cluster.map_shared_rank(&ppres[v], r);
        }
        mcnt[v - v0] = cn;
        mpres[v - v0] = pr;
      } else {
        cn = __ldcg(&a.merged_cnt[lead_row + v]);
        pr = __ldcg(&a.merged_present[lead_row + v]);
      }
      for (int j = i; j < nt; ++j) {
        const int t = terms[j];
        if (a.t_topo_slot[t] != slot || (!shared_tables && j == i)) continue;
        a.merged_cnt[(int64_t)t * V + v] = cn;
        a.merged_present[(int64_t)t * V + v] = pr;
      }
      if (pr) {
        mn = cn < mn ? cn : mn;
        any = 1;
      }
    }
    mn = block_min<int64_t>(mn, red, BIG_COUNT);
    any = block_max<int64_t>(any, red, 0);
    if (tid == 0) {
      part_min = (int32_t)mn;
      part_any = (int32_t)any;
    }
    cluster.sync();  // every CTA's merged slice and minimum are in place

    // d. the group's minimum over present values; the merged table locally
    int32_t gmin = BIG_COUNT;
    bool gany = false;
    for (int r = 0; r < C; ++r) {
      const int32_t pm = *cluster.map_shared_rank(&part_min, r);
      gmin = pm < gmin ? pm : gmin;
      gany |= *cluster.map_shared_rank(&part_any, r) != 0;
    }
    any_row |= gany;
    if (c == 0 && tid == 0) {
      for (int j = i; j < nt; ++j) {
        const int t = terms[j];
        if (a.t_topo_slot[t] != slot) continue;
        a.min_t[t] = gmin;
        a.any_pair_t[t] = gany ? 1 : 0;
      }
    }
    if (a.local_table) {
      for (int v = tid; v < V; v += THREADS) {
        const int r = v / a.vslice;
        lcnt[v] = *cluster.map_shared_rank(&mcnt[v - r * a.vslice], r);
        lpres[v] = *cluster.map_shared_rank(&mpres[v - r * a.vslice], r);
      }
      __syncthreads();
    }

    // e. the skew tests of the group's terms, ANDed into the node states (a
    // group of one term keeps its self-match and max skew in registers)
    int g_n = 0, g_t = 0;
    for (int j = i; j < nt; ++j) {
      if (a.t_topo_slot[terms[j]] == slot && g_n++ == 0) g_t = terms[j];
    }
    const bool g_self = a.t_self_match[g_t];
    const int32_t g_w = a.t_weight[g_t];
    for (int x = n0 + tid; x < n1; x += THREADS) {
      const uint32_t st = state[x - n0];
      if (!(st & ST_OK)) continue;
      const uint32_t b = st & ST_BUCKET;
      bool ok = b != ST_BUCKET;
      if (ok) {
        const int bc = b > (uint32_t)(V - 1) ? V - 1 : (int)b;  // gathers clamp
        int32_t cn;
        uint8_t pr;
        if (a.local_table) {
          cn = lcnt[bc];
          pr = lpres[bc];
        } else if (shared_tables) {
          const int r = bc / a.vslice;
          cn = *cluster.map_shared_rank(&mcnt[bc - r * a.vslice], r);
          pr = *cluster.map_shared_rank(&mpres[bc - r * a.vslice], r);
        } else {
          cn = __ldcg(&a.merged_cnt[lead_row + bc]);
          pr = __ldcg(&a.merged_present[lead_row + bc]);
        }
        const int32_t match_num = pr ? cn : 0;
        if (g_n == 1) {
          ok = skew_ok(g_self, g_w, match_num, gmin);
        } else {
          for (int j = i; j < nt && ok; ++j) {
            const int t = terms[j];
            if (a.t_topo_slot[t] == slot) ok = skew_ok(a.t_self_match[t], a.t_weight[t], match_num, gmin);
          }
        }
      }
      if (!ok) state[x - n0] = st & ~ST_OK;
    }
    // the next group's tables are cleared only after its first cluster
    // barrier has seen every CTA past these reads
    __syncthreads();
  }
  cluster_arrive();  // this CTA's reads of the others' shared memory are done

  // 3. the mask; the default table rows of terms no spec row owns
  for (int x = n0 + tid; x < n1; x += THREADS) {
    a.mask[row + x] = ((state[x - n0] & ST_OK) || !any_row) ? 1 : 0;
  }
  for (int t = u; t < a.TT; t += a.U) {
    const int32_t o = a.t_owner[t];
    if (a.t_valid[t] && a.t_kind[t] == SPREAD_HARD && o >= 0 && o < a.U) continue;
    for (int v = v0 + tid; v < v1; v += THREADS) {
      a.merged_cnt[(int64_t)t * V + v] = 0;
      a.merged_present[(int64_t)t * V + v] = 0;
    }
    if (c == 0 && tid == 0) {
      a.min_t[t] = BIG_COUNT;
      a.any_pair_t[t] = 0;
    }
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

extern "C" int ktpu_spread_filter(const SpreadFilterArgs* args, cudaStream_t stream) {
  const SpreadFilterArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.C < 1 || a.C > MAX_CLUSTER || a.V < 1 || a.V >= (int)ST_BUCKET || (size_t)a.C * a.slice < (size_t)a.N ||
      (size_t)a.C * a.vslice < (size_t)a.V || a.copies < 0 || spread_filter_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster((const void*)spread_filter_cluster_kernel, a.C, THREADS, (size_t)a.smem, a, stream, a.U);
}

// ---------------------------------------------------------------------------
// selector_spread_score: ONE launch, a grid of U thread-block clusters of C
// CTAs, one cluster a spec row u; CTA c owns the node slice [c * slice,
// (c + 1) * slice) (an even count: a thread owns node pairs) and, where the
// zone table lives in slices, the bucket slice [c * vslice, ...).
//   1. The row's SEL_SPREAD terms in ascending order; then, in windows of
//      SPREAD_LIST, the signatures matching every one of them (valid, not
//      deleting; none where the row has no selector) compacted in shared
//      memory; each thread sums its nodes' counts at them in registers (0
//      on an invalid node), kept there for pass 2; each node's zone (-1
//      off a valid node) in shared memory.
//   2. The zone sums over valid nodes with a zone below V, by `mode`:
//      0 (V <= SEL_LOCAL_V): a V-wide partial table a CTA in shared memory;
//        after a cluster barrier every CTA sums the C partials through
//        distributed shared memory and keeps each bucket's zone score;
//      1: each node adds into the owning CTA's bucket slice (distributed
//        shared memory atomics), the slices cleared before a cluster
//        barrier;
//      2: the same slices in the row's device-memory table (counted).
//      The node maximum and have_zones (a valid node with a zone anywhere)
//      over the cluster from each CTA's partial; the zone maximum from the
//      merged table, or from the slices' maxima after one more barrier.
//   3. Pass 2: the float64 node/zone blend in the reference's operation
//      order, truncated; each output written once, a node pair a 16-byte
//      store where aligned. The exit waits on a split cluster barrier so no
//      CTA leaves while another reads its shared memory.
// A CTA is a chain of dependent round trips more than it is bytes: the
// predicates load their operands together, one barrier closes each
// reduction, and four CTAs fit an SM (64 registers a thread), so a launch
// of up to 528 CTAs runs in one wave.
// ---------------------------------------------------------------------------

#define SEL_PAIRS 8  // node pairs a thread keeps in registers: a slice <= 2 * SEL_PAIRS * THREADS

struct SelSpreadArgs {
  const uint8_t* t_valid;       // [TT]
  const int32_t* t_kind;        // [TT]
  const int32_t* t_owner;       // [TT]
  const uint8_t* m_sig;         // [TT, S] match_terms with namespaces
  const int32_t* n_sel_spread;  // [U]
  const uint8_t* e_valid;       // [S]
  const uint8_t* e_deleting;    // [S]
  const int16_t* counts;        // [N, S]
  const uint8_t* n_valid;       // [N]
  const int32_t* zone_dense;    // [N]
  int64_t* ztable;              // [U, V] the zone tables in device memory (mode 2)
  int64_t* out;                 // [U, N]
  int32_t TT, S, N, U, V;
  // the launch (ops/topology.selector_spread_layout): C CTAs a spec row,
  // the node and bucket slices of a CTA, where the zone tables live (0
  // local, 1 bucket slices, 2 device memory) and the dynamic shared memory
  int32_t C, slice, vslice, mode, smem;
};

// the dynamic shared memory of a CTA, in this order: the zone tables
// (mode 0: the partial [V] int64 and the zone scores [V] float64; mode 1:
// the bucket slice [vslice] int64), the row's terms [TT], a signature
// window [SPREAD_LIST] and the node zones [slice] (int32).
// ops/topology.selector_spread_layout computes the same bytes.
__host__ __device__ __forceinline__ size_t sel_spread_smem_bytes(const SelSpreadArgs& a) {
  const size_t cells = a.mode == 0 ? 2 * (size_t)a.V : (a.mode == 1 ? (size_t)a.vslice : 0);
  return 8 * cells + 4 * ((size_t)a.TT + SPREAD_LIST + a.slice);
}

__device__ __forceinline__ double spread_fraction(int64_t mx, int64_t c) {
  // 10 * (max - c) as float64 / max(max, 1), or 10 when max == 0
  if (mx <= 0) return (double)MAX_NODE_SCORE;
  return ((double)MAX_NODE_SCORE * (double)(mx - c)) / (double)mx;
}

__device__ __forceinline__ int64_t warp_max64(int64_t v) {
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS, 4) selector_spread_cluster_kernel(const SelSpreadArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int32_t warp_cnt[THREADS / 32];
  __shared__ int64_t red_max[THREADS / 32];
  __shared__ int32_t red_zones[THREADS / 32];
  __shared__ int64_t part_max, part_zmax;  // this CTA's partials, read by the cluster
  __shared__ int32_t part_zones;
  cg::cluster_group cluster = cg::this_cluster();
  const int u = blockIdx.y, c = blockIdx.x, tid = threadIdx.x, V = a.V, mode = a.mode;
  const int lane = tid & 31, warp = tid >> 5;
  int64_t* ztab = (int64_t*)dyn;  // mode 0: the partial [V]; mode 1: the bucket slice [vslice]
  double* zscore = (double*)(ztab + V);  // mode 0: each bucket's zone score [V]
  const size_t cells = mode == 0 ? 2 * (size_t)V : (mode == 1 ? (size_t)a.vslice : 0);
  int32_t* terms = (int32_t*)(ztab + cells);  // [TT]
  int32_t* sigs = terms + a.TT;               // [SPREAD_LIST]
  int32_t* zones = sigs + SPREAD_LIST;        // [slice]: the node's zone, -1 off a valid node
  int64_t* dtab = mode == 2 ? a.ztable + (int64_t)u * V : nullptr;
  const int n0 = c * a.slice, n1 = min(a.N, n0 + a.slice);
  const int v0 = min(V, c * a.vslice), v1 = min(V, v0 + a.vslice);
  const bool has_selectors = a.n_sel_spread[u] > 0;

  // the tables cleared (mode 0 its partial; else this CTA's bucket slice)
  if (mode == 0) {
    for (int v = tid; v < V; v += THREADS) ztab[v] = 0;
  } else {
    for (int v = v0 + tid; v < v1; v += THREADS) {
      if (mode == 1) {
        ztab[v - v0] = 0;
      } else {
        dtab[v] = 0;
      }
    }
  }
  // this thread's node pairs: x = n0 + 2 * (tid + k * THREADS) + h, lane q = 2 k + h
  int32_t cnt[2 * SEL_PAIRS];
  uint32_t valid = 0;
#pragma unroll
  for (int q = 0; q < 2 * SEL_PAIRS; ++q) {
    const int x = n0 + 2 * (tid + (q >> 1) * THREADS) + (q & 1);
    cnt[q] = 0;
    if (x < n1) {
      const bool v = __ldg(a.n_valid + x) != 0;
      const int32_t z = __ldg(a.zone_dense + x);
      valid |= (uint32_t)v << q;
      zones[x - n0] = (v && z >= 0) ? z : -1;
    }
  }

  // 1. the row's terms, the matched signatures window by window, the counts
  const int nt = ordered_compact(a.TT, [&](int t) -> bool {
    const bool v = a.t_valid[t] != 0;
    const int32_t k = a.t_kind[t], o = a.t_owner[t];
    return v & (k == SEL_SPREAD) & (o == u);
  }, terms, warp_cnt);
  if (has_selectors) {
    for (int s0 = 0; s0 < a.S; s0 += SPREAD_LIST) {
      const int ns = ordered_compact(min(a.S - s0, SPREAD_LIST), [&](int k) -> bool {
        const int s = s0 + k;
        bool ok = (a.e_valid[s] != 0) & (a.e_deleting[s] == 0);
        for (int i = 0; i < nt; ++i) ok &= a.m_sig[(int64_t)terms[i] * a.S + s] != 0;
        return ok;
      }, sigs, warp_cnt);
      for (int j = 0; j < ns; ++j) {
        const int16_t* col = a.counts + s0 + sigs[j];
#pragma unroll
        for (int q = 0; q < 2 * SEL_PAIRS; ++q) {  // a signature's counts for all of the thread's nodes at once
          if ((valid >> q) & 1) cnt[q] += __ldg(col + (int64_t)(n0 + 2 * (tid + (q >> 1) * THREADS) + (q & 1)) * a.S);
        }
      }
      __syncthreads();  // the window's list is read before the next one is built
    }
  }

  // 2. the zone sums; the node maximum and have_zones of this CTA
  if (mode == 0) {
    __syncthreads();  // the partial is clear; the zones are in place
  } else {
    if (mode == 2) __threadfence();
    cluster.sync();  // every bucket slice is clear before any CTA adds into it
  }
  int64_t mx = 0;
  int any_zone = 0;
#pragma unroll
  for (int q = 0; q < 2 * SEL_PAIRS; ++q) {
    const int x = n0 + 2 * (tid + (q >> 1) * THREADS) + (q & 1);
    if (!((valid >> q) & 1)) continue;
    mx = cnt[q] > mx ? cnt[q] : mx;
    const int32_t z = zones[x - n0];
    if (z < 0) continue;
    any_zone = 1;
    if (z >= V || cnt[q] == 0) continue;  // segment_sum drops a zone >= V
    int64_t* cellp;
    if (mode == 0) {
      cellp = ztab + z;
    } else if (mode == 1) {
      const int r = z / a.vslice;
      cellp = cluster.map_shared_rank(ztab + (z - r * a.vslice), r);
    } else {
      cellp = dtab + z;
    }
    atomicAdd((unsigned long long*)cellp, (unsigned long long)(int64_t)cnt[q]);
  }
  mx = warp_max64(mx);
  any_zone = __any_sync(0xffffffffu, any_zone);
  if (lane == 0) {
    red_max[warp] = mx;
    red_zones[warp] = any_zone;
  }
  __syncthreads();
  if (tid == 0) {
    int64_t m = 0;
    int32_t zs = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      m = red_max[w] > m ? red_max[w] : m;
      zs |= red_zones[w];
    }
    part_max = m;
    part_zones = zs;
  }
  if (mode == 2) __threadfence();
  cluster.sync();  // every CTA's partials are complete

  int64_t gmax = 0;
  bool have_zones = false;
  for (int r = 0; r < a.C; ++r) {
    const int64_t pm = *cluster.map_shared_rank(&part_max, r);
    gmax = pm > gmax ? pm : gmax;
    have_zones |= *cluster.map_shared_rank(&part_zones, r) != 0;
  }
  int64_t zmax = 0;
  if (mode == 0) {  // the merged table, locally
    for (int v = tid; v < V; v += THREADS) {
      int64_t zc = 0;
      for (int r = 0; r < a.C; ++r) zc += *cluster.map_shared_rank(ztab + v, r);
      zmax = zc > zmax ? zc : zmax;
      ((int64_t*)zscore)[v] = zc;  // the merged count for now; its score below
    }
  } else {  // this CTA's bucket slice
    for (int v = v0 + tid; v < v1; v += THREADS) {
      const int64_t zc = mode == 1 ? ztab[v - v0] : (int64_t)__ldcg((const long long*)dtab + v);
      zmax = zc > zmax ? zc : zmax;
    }
  }
  zmax = warp_max64(zmax);
  if (lane == 0) red_max[warp] = zmax;  // (free again: tid 0 read it before the cluster barrier)
  __syncthreads();
  zmax = 0;
  for (int w = 0; w < THREADS / 32; ++w) zmax = red_max[w] > zmax ? red_max[w] : zmax;
  if (mode == 0) {
    for (int v = tid; v < V; v += THREADS) zscore[v] = spread_fraction(zmax, ((int64_t*)zscore)[v]);
    __syncthreads();
  } else {  // the slices' maxima over the cluster
    if (tid == 0) part_zmax = zmax;
    cluster.sync();
    for (int r = 0; r < a.C; ++r) {
      const int64_t pz = *cluster.map_shared_rank(&part_zmax, r);
      zmax = pz > zmax ? pz : zmax;
    }
  }
  if (mode != 1) cluster_arrive();  // this CTA's reads of the others' shared memory are done

  // 3. the blend, each output written once
  const int64_t row = (int64_t)u * a.N;
  int64_t* out = a.out + row;
#pragma unroll
  for (int k = 0; k < SEL_PAIRS; ++k) {
    const int x = n0 + 2 * (tid + k * THREADS);
    if (x >= n1) break;
    int64_t o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * k + h;
      const double fscore = spread_fraction(gmax, cnt[q]);
      double blended = fscore;
      const int32_t z = x + h < n1 ? zones[x + h - n0] : -1;
      if (have_zones && z >= 0) {
        // the zone score of the node's bucket (a V-wide gather: clamped)
        const int b = z > V - 1 ? V - 1 : z;
        double zs;
        if (mode == 0) {
          zs = zscore[b];
        } else {
          int64_t zc;
          if (mode == 1) {
            const int r = b / a.vslice;
            zc = *cluster.map_shared_rank(ztab + (b - r * a.vslice), r);
          } else {
            zc = (int64_t)__ldcg((const long long*)dtab + b);
          }
          zs = spread_fraction(zmax, zc);
        }
        blended = fscore * (1.0 / 3.0) + (2.0 / 3.0) * zs;
      }
      o[h] = (int64_t)blended;
    }
    if (x + 1 < n1 && ((row + x) & 1) == 0) {
      *(longlong2*)(out + x) = make_longlong2(o[0], o[1]);
    } else {
      out[x] = o[0];
      if (x + 1 < n1) out[x + 1] = o[1];
    }
  }
  if (mode == 1) cluster_arrive();
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

extern "C" int ktpu_selector_spread_score(const SelSpreadArgs* args, cudaStream_t stream) {
  const SelSpreadArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.C < 1 || a.C > MAX_CLUSTER || a.V < 1 || a.slice < 2 || (a.slice & 1) ||
      a.slice > 2 * SEL_PAIRS * THREADS || (size_t)a.C * a.slice < (size_t)a.N || a.vslice < 1 ||
      (size_t)a.C * a.vslice < (size_t)a.V || a.mode < 0 || a.mode > 2 || (a.mode == 2 && a.ztable == nullptr) ||
      sel_spread_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster((const void*)selector_spread_cluster_kernel, a.C, THREADS, (size_t)a.smem, a, stream, a.U);
}
