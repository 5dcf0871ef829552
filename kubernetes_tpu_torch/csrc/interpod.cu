// Inter-pod affinity kernels: InterPodAffinityMatches and the inter-pod
// affinity priority. (The solver's pairwise host-port conflict table is the
// match launch's port slice, topology.cu.)
//
// Replace, in kubernetes_tpu/ops:
//   ktpu_interpod_filter        topology.py:281 interpod_filter, with _bucket_of,
//                               _seg_sum, _sig_cnt_node, _gather_rows, _scatter_and
//                               and _scatter_or (:164) inside
//   ktpu_interpod_score         topology.py:363 interpod_score
//
// Existing pods enter twice: as label SIGNATURES (state/tensors.SigBank,
// counts[N, S] int16) matched by the batch's terms, and their own terms as
// PATTERNS (state/terms.PatternBank, counts[N, PT] int16) matched against
// the batch's spec rows. The term x signature and pattern x spec-row
// matches come from the match_terms kernel (topology.cu): the batch's match
// plan, or one match launch by the wrappers.
//
// ktpu_interpod_filter: ONE launch, a grid of U thread-block clusters of C
//   CTAs, one cluster a spec row u; CTA c owns the node slice [c * slice,
//   (c + 1) * slice) and the bucket slice [c * vslice, ...) of every table.
//   1. The row's ITEMS, compacted once in shared memory in ascending order
//      (so every CTA walks the same chunks and the barriers match): its
//      matching ANTI_REQ patterns ("existing", code pt), its AFF_REQ terms
//      ("aff", where has_aff[u]) and its ANTI_REQ terms ("anti"; code
//      PT + t). A row without items (no matching pattern, no owned term)
//      writes its all-pass row and tabulates nothing.
//   2. The items in chunks of tcap per-bucket tables in shared memory (one
//      table at a time in device memory when tcap is 0):
//      a. each CTA clears its bucket slice of the chunk's tables; a cluster
//         barrier;
//      b. each CTA adds its nodes' counts into the OWNING CTA's bucket slice
//         through distributed shared memory (integer atomics; buckets >= V
//         dropped): a pattern's instances x_counts[n, pt], a term's matched
//         signatures' counts, the signatures compacted in windows of
//         SIG_WINDOW (an AFF_REQ term's: those matching EVERY AFF_REQ term
//         of the row; an ANTI_REQ term's: its own); a cluster barrier;
//      c. each node reads each table at its clamped bucket: a pattern or an
//         ANTI_REQ term holding a pod there blocks it, every AFF_REQ term
//         must hold one; each CTA notes whether its slice of an AFF_REQ
//         table holds a pod (the first-pod escape's any_pair).
//   3. any_pair over the cluster (one more barrier, for a row that can take
//      the escape), then the mask; the exit waits on a split cluster
//      barrier so no CTA leaves while another reads its shared memory.
// ktpu_interpod_score: ONE launch, a grid of U clusters of C CTAs, the
//   filter's layout: a row's items (matching AFF_REQ / AFF_PREF / ANTI_PREF
//   patterns, owned AFF_PREF / ANTI_PREF terms) compacted once, their
//   per-bucket tables in the owning CTAs' shared memory (device memory past
//   the budget), each node's weighted sum in registers across the items,
//   the row's min and max over valid nodes (0 clamped in) by one reduction
//   over the cluster, and 10 * (c - min) // (max - min) written once.
//
// Every count is an integer sum (atomics on int32 tables): the reference's
// f32 products are exact only below 2^24, these everywhere, and the order
// of the atomics does not change a result. A bucket at or above V is
// dropped from a sum and clamped in a gather, as segment_sum and the JAX
// gather do.
//
// Bound: bytes. Both kernels read, per item and node of the row, the dense
// label at the item's key and the counts columns it names, and write the
// [U, N] output (1 byte a cell for the filter, 8 for the score); the tables stay in the cluster's shared memory (in device
// memory only past its budget). The arithmetic is a few integer adds per
// (item, node). What costs is the reads a node takes (a 32-byte sector for
// each 2-byte count or 4-byte label: the banks are node-major), a CTA's
// chain of dependent round trips and cluster barriers and, for the score,
// the dependent label-then-table read of each (item, node).
#include <cooperative_groups.h>

#include "topology.cuh"

namespace cg = cooperative_groups;

#define PART_EXISTING 1   // interpod_filter "existing"
#define PART_AFF 2        // interpod_filter "aff"
#define PART_ANTI 4       // interpod_filter "anti"
#define PART_PREF 8       // interpod_score "pref"
#define PART_X_SCORE 16   // interpod_score "existing"

__device__ __forceinline__ int clamp_bucket(int32_t b, int V) { return b > V - 1 ? V - 1 : b; }

// the dense label of node x at a slot (clipped; -1: absent)
__device__ __forceinline__ int32_t dense_at(const int32_t* label_dense, int K, int x, int32_t slot) {
  const int sc = slot < 0 ? 0 : (slot > K - 1 ? K - 1 : slot);
  return __ldg(label_dense + (int64_t)x * K + sc);
}

// ---------------------------------------------------------------------------
// interpod_filter
// ---------------------------------------------------------------------------

#define IP_BATCH 4        // nodes a thread loads for at once
#define SIG_WINDOW 1024   // signatures a window of a term's compaction
#define IP_OK 1           // no pattern or ANTI_REQ term blocks the node
#define IP_AFF_OK 2       // every AFF_REQ term holds a pod in the node's bucket

struct InterpodFilterArgs {
  const int32_t* label_dense;     // [N, K]
  const uint8_t* x_valid;         // [PT] patterns
  const int32_t* x_kind;          // [PT]
  const int32_t* x_topo_slot;     // [PT]
  const int16_t* x_counts;        // [N, PT]
  const uint8_t* m_pt;            // [PT, U] pattern matches spec row (labels + namespace)
  const uint8_t* t_valid;         // [TT] batch terms
  const int32_t* t_kind;          // [TT]
  const int32_t* t_owner;         // [TT]
  const int32_t* t_topo_slot;     // [TT]
  const uint8_t* m_sig;           // [TT, S] term matches signature (labels + namespace)
  const uint8_t* e_valid;         // [S]
  const int16_t* counts;          // [N, S]
  const uint8_t* self_aff_match;  // [U]
  const uint8_t* has_aff;         // [U]
  int32_t* dtable;                // [U, V] the tables in device memory (tcap == 0)
  uint8_t* mask;                  // [U, N]
  int32_t N, K, PT, TT, S, U, V, parts;
  // the launch (ops/topology.interpod_filter_layout): C CTAs a spec row,
  // the node and bucket slices of a CTA, the item tables a chunk holds in
  // shared memory (0: one at a time in device memory) and the dynamic
  // shared memory
  int32_t C, slice, vslice, tcap, smem;
};

// the dynamic shared memory of a CTA, in this order: the chunk's bucket
// slices [tcap, vslice], the row's items [PT + TT] and a signature window
// [SIG_WINDOW] (int32), the node states [slice] (bytes).
// ops/topology.interpod_filter_layout computes the same bytes.
__host__ __device__ __forceinline__ size_t interpod_filter_smem_bytes(const InterpodFilterArgs& a) {
  return 4 * ((size_t)a.tcap * a.vslice + (size_t)a.PT + a.TT + SIG_WINDOW) + (size_t)a.slice;
}

// The cell of bucket b (< V) of the chunk's table j: in the owning CTA's
// shared memory, or in the row's device-memory table. (Args: the filter's
// or the score's struct; both carry the same layout fields.)
template <typename Args>
__device__ __forceinline__ int32_t* ip_cell(const Args& a, int32_t* tab, int32_t* dtab, int j, int b) {
  if (a.tcap == 0) return dtab + b;
  const int r = b / a.vslice;
  return cg::this_cluster().map_shared_rank(tab + (size_t)j * a.vslice + (b - r * a.vslice), r);
}

template <typename Args>
__device__ __forceinline__ int32_t ip_get(const Args& a, int32_t* tab, int32_t* dtab, int j, int b) {
  return a.tcap == 0 ? __ldcg(dtab + b) : *ip_cell(a, tab, dtab, j, b);
}

// Table j of the chunk += count(x) at the bucket of every node x of
// [n0, n1) with the key and a bucket below V (segment_sum drops the rest).
// Eager: each node's count is loaded beside its label (one round trip, a
// count read for a node without the key too); else only where the label
// has the key.
template <bool Eager = false, typename Args, typename Count>
__device__ __forceinline__ void ip_tabulate(const Args& a, int32_t* tab, int32_t* dtab, int j,
                                            int32_t slot, int n0, int n1, Count count) {
  for (int x0 = n0 + threadIdx.x; x0 < n1; x0 += IP_BATCH * THREADS) {
    int32_t d[IP_BATCH], cn[IP_BATCH];
#pragma unroll
    for (int k = 0; k < IP_BATCH; ++k) {  // the batch's label loads first
      const int x = x0 + k * THREADS;
      d[k] = (x < n1 && slot >= 0) ? dense_at(a.label_dense, a.K, x, slot) : -1;
      if (Eager) cn[k] = (x < n1 && slot >= 0) ? count(x) : 0;
    }
#pragma unroll
    for (int k = 0; k < IP_BATCH; ++k) {
      if (!Eager) cn[k] = (d[k] >= 0 && d[k] < a.V) ? count(x0 + k * THREADS) : 0;
      else if (d[k] < 0 || d[k] >= a.V) cn[k] = 0;
    }
#pragma unroll
    for (int k = 0; k < IP_BATCH; ++k) {
      if (cn[k] != 0) atomicAdd(ip_cell(a, tab, dtab, j, d[k]), cn[k]);
    }
  }
}

__global__ void __launch_bounds__(THREADS) interpod_filter_cluster_kernel(const InterpodFilterArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int32_t warp_cnt[THREADS / 32];
  __shared__ int32_t any_flag;  // this CTA's slices of the AFF_REQ tables hold a pod
  cg::cluster_group cluster = cg::this_cluster();
  const int u = blockIdx.y, c = blockIdx.x, tid = threadIdx.x, V = a.V;
  int32_t* tab = (int32_t*)dyn;                          // [tcap, vslice]
  int32_t* items = tab + (size_t)a.tcap * a.vslice;      // [PT + TT]
  int32_t* sigs = items + a.PT + a.TT;                   // [SIG_WINDOW]
  uint8_t* state = (uint8_t*)(sigs + SIG_WINDOW);        // [slice]
  int32_t* dtab = a.tcap == 0 ? a.dtable + (int64_t)u * V : nullptr;
  const int n0 = c * a.slice, n1 = min(a.N, n0 + a.slice);
  const int v0 = min(V, c * a.vslice), v1 = min(V, v0 + a.vslice);
  const int64_t row = (int64_t)u * a.N;
  const bool want_x = (a.parts & PART_EXISTING) != 0;
  const bool want_aff = (a.parts & PART_AFF) != 0 && a.has_aff[u];
  const bool want_anti = (a.parts & PART_ANTI) != 0;

  // 1. the row's items
  // (each predicate loads its operands together: one round trip, not a chain)
  const int ni = ordered_compact(a.PT + a.TT, [&](int i) -> bool {
    if (i < a.PT) {
      if (!want_x) return false;
      const bool v = a.x_valid[i] != 0, m = a.m_pt[(int64_t)i * a.U + u] != 0;
      return v & m & (a.x_kind[i] == ANTI_REQ);
    }
    const int t = i - a.PT;
    const bool v = a.t_valid[t] != 0;
    const int32_t o = a.t_owner[t], k = a.t_kind[t];
    return v & (o == u) & (((k == AFF_REQ) & want_aff) | ((k == ANTI_REQ) & want_anti));
  }, items, warp_cnt);
  if (ni == 0) {  // nothing to tabulate: the row passes everywhere (every CTA of the cluster returns here)
    for (int x = n0 + tid; x < n1; x += THREADS) a.mask[row + x] = 1;
    return;
  }
  int has_aff_item = 0;
  for (int i = tid; i < ni; i += THREADS) has_aff_item |= items[i] >= a.PT && a.t_kind[items[i] - a.PT] == AFF_REQ;
  // the row can take the first-pod escape
  const bool escape = __syncthreads_or(has_aff_item) && a.self_aff_match[u];
  for (int x = n0 + tid; x < n1; x += THREADS) state[x - n0] = IP_OK | IP_AFF_OK;
  int any_local = 0;

  // 2. the items, a chunk of tables at a time
  const int per = a.tcap > 0 ? a.tcap : 1;
  for (int i0 = 0; i0 < ni; i0 += per) {
    const int i1 = min(ni, i0 + per);
    // a. this CTA's bucket slices of the chunk's tables, cleared
    if (a.tcap > 0) {
      for (int k = tid; k < (i1 - i0) * a.vslice; k += THREADS) tab[k] = 0;
    } else {
      for (int v = v0 + tid; v < v1; v += THREADS) dtab[v] = 0;
      __threadfence();
    }
    cluster.sync();  // every slice is clear before any CTA adds into it

    // b. the node slice's counts into the owning CTAs' slices
    for (int i = i0; i < i1; ++i) {
      const int code = items[i];
      if (code < a.PT) {
        ip_tabulate(a, tab, dtab, i - i0, a.x_topo_slot[code], n0, n1,
                    [&](int x) { return (int32_t)__ldg(a.x_counts + (int64_t)x * a.PT + code); });
        continue;
      }
      const int t = code - a.PT;
      const bool aff = a.t_kind[t] == AFF_REQ;
      for (int s0 = 0; s0 < a.S; s0 += SIG_WINDOW) {
        const int ns = ordered_compact(min(a.S - s0, SIG_WINDOW), [&](int k) -> bool {
          const int s = s0 + k;
          bool ok = a.e_valid[s] != 0;
          if (!aff) return ok & (a.m_sig[(int64_t)t * a.S + s] != 0);
          for (int q = 0; q < ni; ++q) {  // every AFF_REQ term of the row matches it
            const int tq = items[q] - a.PT;
            if (tq >= 0 && a.t_kind[tq] == AFF_REQ) ok &= a.m_sig[(int64_t)tq * a.S + s] != 0;
          }
          return ok;
        }, sigs, warp_cnt);
        if (ns > 0) {
          const int16_t* cols = a.counts + s0;
          ip_tabulate(a, tab, dtab, i - i0, a.t_topo_slot[t], n0, n1, [&](int x) {
            const int16_t* rc = cols + (int64_t)x * a.S;
            int32_t cn = 0;
            for (int q = 0; q < ns; ++q) cn += __ldg(rc + sigs[q]);
            return cn;
          });
        }
        __syncthreads();  // the window's list is read before the next one is built
      }
    }
    if (a.tcap == 0) __threadfence();
    cluster.sync();  // the chunk's tables are complete

    // c. each node's tests at its clamped bucket
    for (int x0 = n0 + tid; x0 < n1; x0 += IP_BATCH * THREADS) {
      uint8_t st[IP_BATCH];
#pragma unroll
      for (int k = 0; k < IP_BATCH; ++k) st[k] = x0 + k * THREADS < n1 ? state[x0 + k * THREADS - n0] : 0;
      for (int i = i0; i < i1; ++i) {
        const int code = items[i];
        const bool pat = code < a.PT;
        const int32_t slot = pat ? a.x_topo_slot[code] : a.t_topo_slot[code - a.PT];
        const bool aff = !pat && a.t_kind[code - a.PT] == AFF_REQ;
        int32_t d[IP_BATCH];
#pragma unroll
        for (int k = 0; k < IP_BATCH; ++k) {
          const bool live = (st[k] & IP_OK) && (!aff || (st[k] & IP_AFF_OK));
          d[k] = (live && slot >= 0) ? dense_at(a.label_dense, a.K, x0 + k * THREADS, slot) : -1;
        }
#pragma unroll
        for (int k = 0; k < IP_BATCH; ++k) {
          if (!(st[k] & IP_OK)) continue;
          const bool present = d[k] >= 0 && ip_get(a, tab, dtab, i - i0, clamp_bucket(d[k], V)) > 0;
          if (aff) {
            if (!present) st[k] &= ~IP_AFF_OK;
          } else if (present) {
            st[k] &= ~IP_OK;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < IP_BATCH; ++k) {
        if (x0 + k * THREADS < n1) state[x0 + k * THREADS - n0] = st[k];
      }
    }
    // any_pair: this CTA's slices of the chunk's AFF_REQ tables
    for (int i = i0; i < i1 && escape; ++i) {
      const int code = items[i];
      if (code < a.PT || a.t_kind[code - a.PT] != AFF_REQ) continue;
      for (int v = v0 + tid; v < v1; v += THREADS) {
        any_local |= (a.tcap > 0 ? tab[(size_t)(i - i0) * a.vslice + (v - v0)] : __ldcg(dtab + v)) > 0;
      }
    }
    if (i1 < ni) cluster.sync();  // every CTA is past its reads before the next chunk clears its slices
  }

  // 3. any_pair over the cluster, then the mask
  bool any_pair = false;
  if (escape) {
    any_local = __syncthreads_or(any_local);
    if (tid == 0) any_flag = any_local;
    cluster.sync();
    for (int r = 0; r < a.C; ++r) any_pair |= *cluster.map_shared_rank(&any_flag, r) != 0;
  }
  cluster_arrive();  // this CTA's reads of the others' shared memory are done
  const bool pass_aff = escape && !any_pair;
  for (int x = n0 + tid; x < n1; x += THREADS) {
    const uint8_t st = state[x - n0];
    a.mask[row + x] = ((st & IP_OK) && ((st & IP_AFF_OK) || pass_aff)) ? 1 : 0;
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

extern "C" int ktpu_interpod_filter(const InterpodFilterArgs* args, cudaStream_t stream) {
  const InterpodFilterArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.C < 1 || a.C > MAX_CLUSTER || a.V < 1 || a.slice < 1 || a.vslice < 1 ||
      (size_t)a.C * a.slice < (size_t)a.N || (size_t)a.C * a.vslice < (size_t)a.V || a.tcap < 0 ||
      (a.tcap == 0 && a.dtable == nullptr) || interpod_filter_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster((const void*)interpod_filter_cluster_kernel, a.C, THREADS, (size_t)a.smem, a, stream, a.U);
}

// ---------------------------------------------------------------------------
// interpod_score: one launch, a cluster of C CTAs a spec row
// ---------------------------------------------------------------------------

#define IPS_NODES 16  // nodes a thread holds in registers (a CTA's slice <= IPS_NODES * THREADS)

struct InterpodArgs {
  const uint8_t* n_valid;         // [N]
  const int32_t* label_dense;     // [N, K]
  const uint8_t* x_valid;         // [PT] patterns
  const int32_t* x_kind;          // [PT]
  const int32_t* x_topo_slot;     // [PT]
  const int32_t* x_weight;        // [PT]
  const int16_t* x_counts;        // [N, PT]
  const uint8_t* m_pt;            // [PT, U] pattern matches spec row (labels + namespace)
  const uint8_t* t_valid;         // [TT] batch terms
  const int32_t* t_kind;          // [TT]
  const int32_t* t_owner;         // [TT]
  const int32_t* t_topo_slot;     // [TT]
  const int32_t* t_weight;        // [TT]
  const uint8_t* m_sig;           // [TT, S] term matches signature (labels + namespace)
  const uint8_t* e_valid;         // [S]
  const int16_t* counts;          // [N, S]
  const uint8_t* p_valid;         // [U]
  int32_t* dtable;                // [U, V] the tables in device memory (tcap == 0)
  int64_t* score;                 // [U, N] score output
  int32_t N, K, PT, TT, S, U, V, parts;
  // the launch (ops/topology.interpod_score_layout): C CTAs a spec row,
  // the node and bucket slices of a CTA, the item tables a chunk holds in
  // shared memory (0: one at a time in device memory) and the dynamic
  // shared memory
  int32_t C, slice, vslice, tcap, smem;
};

// the dynamic shared memory of a CTA, in this order: the chunk's bucket
// slices [tcap, vslice], the row's items [PT + TT] and a signature window
// [SIG_WINDOW] (int32; the int64 reduction cells are static).
// ops/topology.interpod_score_layout computes the same bytes.
__host__ __device__ __forceinline__ size_t interpod_score_smem_bytes(const InterpodArgs& a) {
  return 4 * ((size_t)a.tcap * a.vslice + (size_t)a.PT + a.TT + SIG_WINDOW);
}

// Spec row u = blockIdx.y, CTA c = blockIdx.x of its cluster, owning the
// node slice [c * slice, ...) and the bucket slice [c * vslice, ...) of each
// item table.
//   1. The row's ITEMS, compacted once in ascending order (every CTA walks
//      the same chunks, so the barriers match): the patterns of a score kind
//      (AFF_REQ, AFF_PREF, ANTI_PREF) that match the row ("existing", code
//      pt) and the row's own AFF_PREF / ANTI_PREF terms ("pref", code
//      PT + t). A row without items, or an invalid row, writes its zero row
//      and tabulates nothing (every CTA of the cluster returns here, before
//      any cluster barrier).
//   2. The items in chunks of tcap per-bucket tables in shared memory (one
//      at a time in device memory when tcap is 0), filled as the filter
//      fills them: clear a slice, a cluster barrier, each CTA adds its nodes'
//      counts into the owning CTA's slice by distributed shared memory
//      (a pattern's instances, a term's matched signatures' counts in
//      windows of SIG_WINDOW), a cluster barrier; then each node adds the
//      item's weighted count at its clamped bucket to its sum, which stays
//      in registers across the items: a term's count x weight wraps in
//      int32 (the reference's int32 product), a pattern's is an int64
//      product.
//   3. The row's max (0 clamped in) and min (0 clamped in) over the valid
//      nodes: a block reduction, then each CTA reads the cluster's partials
//      by distributed shared memory; each node's 10 * (c - min) // (max -
//      min) is written once.
__global__ void __launch_bounds__(THREADS) interpod_score_cluster_kernel(const InterpodArgs a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ int64_t red[2 * (THREADS / 32)];  // the warps' maxima, then their minima
  __shared__ int64_t ext[2];                   // this CTA's max and min, read by the cluster
  __shared__ int32_t warp_cnt[THREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int u = blockIdx.y, c = blockIdx.x, tid = threadIdx.x, V = a.V;
  int32_t* tab = (int32_t*)dyn;                          // [tcap, vslice]
  int32_t* items = tab + (size_t)a.tcap * a.vslice;      // [PT + TT]
  int32_t* sigs = items + a.PT + a.TT;                   // [SIG_WINDOW]
  int32_t* dtab = a.tcap == 0 ? a.dtable + (int64_t)u * V : nullptr;
  const int n0 = c * a.slice, n1 = min(a.N, n0 + a.slice);
  int64_t* out = a.score + (int64_t)u * a.N;
  const bool want_pref = (a.parts & PART_PREF) != 0, want_x = (a.parts & PART_X_SCORE) != 0;
  const bool row_valid = a.p_valid[u] != 0;

  // 1. the row's items
  const int ni = !row_valid ? 0 : ordered_compact(a.PT + a.TT, [&](int i) -> bool {
    if (i < a.PT) {
      if (!want_x) return false;
      const bool v = a.x_valid[i] != 0, m = a.m_pt[(int64_t)i * a.U + u] != 0;
      const int32_t k = a.x_kind[i];
      return v & m & ((k == AFF_REQ) | (k == AFF_PREF) | (k == ANTI_PREF));
    }
    if (!want_pref) return false;
    const int t = i - a.PT;
    const bool v = a.t_valid[t] != 0;
    const int32_t o = a.t_owner[t], k = a.t_kind[t];
    return v & (o == u) & ((k == AFF_PREF) | (k == ANTI_PREF));
  }, items, warp_cnt);
  if (ni == 0) {  // every count is 0: the zero row (every CTA of the cluster returns here)
    for (int x = n0 + tid; x < n1; x += THREADS) out[x] = 0;
    return;
  }
  int64_t sum[IPS_NODES];
  unsigned valid = 0;  // bit k: node n0 + tid + k * THREADS is a valid node (loaded now, read at the end)
#pragma unroll
  for (int k = 0; k < IPS_NODES; ++k) {
    const int x = n0 + tid + k * THREADS;
    sum[k] = 0;
    valid |= (x < n1 && a.n_valid[x]) ? 1u << k : 0u;
  }

  // 2. the items, a chunk of tables at a time
  const int per = a.tcap > 0 ? a.tcap : 1;
  const int v0 = min(V, c * a.vslice), v1 = min(V, v0 + a.vslice);
  for (int i0 = 0; i0 < ni; i0 += per) {
    const int i1 = min(ni, i0 + per);
    // a. this CTA's bucket slices of the chunk's tables, cleared
    if (a.tcap > 0) {
      for (int k = tid; k < (i1 - i0) * a.vslice; k += THREADS) tab[k] = 0;
    } else {
      for (int v = v0 + tid; v < v1; v += THREADS) dtab[v] = 0;
      __threadfence();
    }
    cluster.sync();  // every slice is clear before any CTA adds into it

    // b. the node slice's counts into the owning CTAs' slices
    for (int i = i0; i < i1; ++i) {
      const int code = items[i];
      if (code < a.PT) {
        ip_tabulate<true>(a, tab, dtab, i - i0, a.x_topo_slot[code], n0, n1,
                          [&](int x) { return (int32_t)__ldg(a.x_counts + (int64_t)x * a.PT + code); });
        continue;
      }
      const int t = code - a.PT;
      for (int s0 = 0; s0 < a.S; s0 += SIG_WINDOW) {
        const int ns = ordered_compact(min(a.S - s0, SIG_WINDOW), [&](int k) -> bool {
          const int s = s0 + k;
          return (a.e_valid[s] != 0) & (a.m_sig[(int64_t)t * a.S + s] != 0);
        }, sigs, warp_cnt);
        if (ns > 0) {
          const int16_t* cols = a.counts + s0;
          ip_tabulate<true>(a, tab, dtab, i - i0, a.t_topo_slot[t], n0, n1, [&](int x) {
            const int16_t* rc = cols + (int64_t)x * a.S;
            int32_t cn = 0;
            for (int q = 0; q < ns; ++q) cn += __ldg(rc + sigs[q]);
            return cn;
          });
        }
        __syncthreads();  // the window's list is read before the next one is built
      }
    }
    if (a.tcap == 0) __threadfence();
    cluster.sync();  // the chunk's tables are complete

    // c. each node's weighted count at its clamped bucket, into its sum
    for (int i = i0; i < i1; ++i) {
      const int code = items[i];
      const bool pat = code < a.PT;
      const int32_t slot = pat ? a.x_topo_slot[code] : a.t_topo_slot[code - a.PT];
      const int32_t w = pat ? a.x_weight[code] : a.t_weight[code - a.PT];
      int32_t d[IPS_NODES];
#pragma unroll
      for (int k = 0; k < IPS_NODES; ++k) {  // the label loads first
        const int x = n0 + tid + k * THREADS;
        d[k] = (x < n1 && slot >= 0) ? dense_at(a.label_dense, a.K, x, slot) : -1;
      }
#pragma unroll
      for (int k = 0; k < IPS_NODES; ++k) {
        if (d[k] < 0) continue;
        const int32_t cnt = ip_get(a, tab, dtab, i - i0, clamp_bucket(d[k], V));
        sum[k] += pat ? (int64_t)w * (int64_t)cnt : (int64_t)(int32_t)((uint32_t)cnt * (uint32_t)w);
      }
    }
    if (i1 < ni) cluster.sync();  // every CTA is past its reads before the next chunk clears its slices
  }

  // 3. the row's max and min over the valid nodes (0 clamped in), then the
  // scores: both over the warp by shuffles, over the block in one barrier,
  // over the cluster in one more
  int64_t mx = 0, mn = 0;
#pragma unroll
  for (int k = 0; k < IPS_NODES; ++k) {
    if ((valid >> k) & 1u) {
      mx = sum[k] > mx ? sum[k] : mx;
      mn = sum[k] < mn ? sum[k] : mn;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t hi = __shfl_down_sync(0xffffffffu, mx, off), lo = __shfl_down_sync(0xffffffffu, mn, off);
    mx = hi > mx ? hi : mx;
    mn = lo < mn ? lo : mn;
  }
  if ((tid & 31) == 0) {
    red[tid >> 5] = mx;
    red[THREADS / 32 + (tid >> 5)] = mn;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      mx = red[w] > mx ? red[w] : mx;
      mn = red[THREADS / 32 + w] < mn ? red[THREADS / 32 + w] : mn;
    }
    ext[0] = mx;
    ext[1] = mn;
  }
  cluster.sync();  // every CTA's partials are in place
  for (int r = 0; r < a.C; ++r) {
    const int64_t* o = cluster.map_shared_rank(ext, r);
    mx = o[0] > mx ? o[0] : mx;
    mn = o[1] < mn ? o[1] : mn;
  }
  cluster_arrive();  // this CTA's reads of the others' shared memory are done
  const int64_t diff = mx - mn;
#pragma unroll
  for (int k = 0; k < IPS_NODES; ++k) {
    const int x = n0 + tid + k * THREADS;
    if (x < n1) out[x] = (((valid >> k) & 1u) && diff > 0) ? floordiv(MAX_NODE_SCORE * (sum[k] - mn), diff) : 0;
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

extern "C" int ktpu_interpod_score(const InterpodArgs* args, cudaStream_t stream) {
  const InterpodArgs& a = *args;
  if (a.U <= 0 || a.N <= 0) return (int)cudaGetLastError();
  if (a.C < 1 || a.C > MAX_CLUSTER || a.V < 1 || a.slice < 1 || a.vslice < 1 || a.slice > IPS_NODES * THREADS ||
      (size_t)a.C * a.slice < (size_t)a.N || (size_t)a.C * a.vslice < (size_t)a.V || a.tcap < 0 ||
      (a.tcap == 0 && a.dtable == nullptr) || interpod_score_smem_bytes(a) != (size_t)a.smem) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cluster((const void*)interpod_score_cluster_kernel, a.C, THREADS, (size_t)a.smem, a, stream, a.U);
}
