// Slab row gather and row scatter for the ingest and term planes.
//
// ktpu_gather_batch replaces kubernetes_tpu/ingest/gather.py:gather_stage
// (:28) and kubernetes_tpu/terms_plane/gather.py:gather_terms (:28), both in
// ONE launch a batch: for every gather problem p (a slab dict, its padding
// row and a lane vector), every array k of its slab and every lane l,
//
//     out[p][k][l] = rows[p][l] >= 0 ? slab[p][k][rows[p][l]] : empty[p][k][0]
//
// where the wrapper folded keep into the index (rows = keep ? idx : -1). The
// override column (gather_stage's `fallback` as shipped, gather_terms's
// `owner` masked by keep) is host data: the wrapper writes its final bytes
// beside the lane vectors, and the one host->device copy of those lanes
// lands them in the column's output, so the kernel never touches it.
//
// Bound: bytes. Per batch the live lanes' rows of every array are read and
// every lane's row written: at config 3 (U = TT = 128, 100 live; 3,000 B a
// pod row, 196 B a term row) ~0.7 MB, ~0.21 us at 3.35 TB/s; so a launch is
// its latency, and the design is about CTAs and launches, not bandwidth:
//   * one launch for both slabs (the driver gathers the pod arrays and the
//     term table together);
//   * sized by bytes: the host cuts each (problem, array) output segment
//     into chunks of GATHER_CHUNK_BYTES (256 threads x 16 bytes) and passes
//     each segment's first CTA; a CTA finds its segment by a binary search
//     of that prefix in the __grid_constant__ block. Both slabs fill ~140
//     CTAs at config 3, one wave, with no CTA that exits idle;
//   * 16-byte words where a segment's row bytes and pointers allow it (else
//     8, 4, 2, 1); 32-bit index arithmetic, one division a thread (the
//     per-iteration step in rows and words comes from the host); a lane's
//     row index is one load a row per warp (a broadcast), keep folded in.
// The wrapper checked every index against the slab's rows on the host.
//
// ktpu_scatter_slab replaces kubernetes_tpu/ingest/bank.py:_scatter_fn (:54;
// terms_plane/bank.py:22 reuses it) and kubernetes_tpu/state/cache.py:
// _row_scatter_fn (:90): for every patch problem p (a resident slab dict,
// its dirty rows and the arrays to patch) and every array k of it,
//
//     slab[p][k][rows[p][r]] = staged[p][k][r]
//
// for the R_p rows staged since the last flush, in place. The mirror's sync
// passes its up to six patches (node rows, usage rows, and the signature
// and pattern banks' counts and metadata) as ONE launch; a plane's flush
// is a one-problem launch. The wrapper packed every problem's int32 row
// vector and staged rows into one pinned host buffer (each region 16-byte
// aligned), which lands on the card by ONE non-blocking copy into the
// staging buffer `base`; the scatter is stream-ordered behind it. The
// caller's duplicate rows inside a problem carry identical bytes, and the
// wrapper refused two problems writing one (array, row), so the order of
// the writes does not matter.
//
// Bound: bytes — each staged row read once and written once (config 5's
// restage flush: 64 rows of 3,000 bytes, 0.38 MB, ~0.11 us at 3.35 TB/s),
// so a launch is its latency, and the design is the batch gather's:
//   * sized by bytes: the host cuts each (problem, array) segment into
//     chunks of GATHER_CHUNK_BYTES of staged rows and passes each
//     segment's first CTA; a CTA finds its segment by a binary search of
//     that prefix in the __grid_constant__ block (SLAB_MAX_ARRAYS segments:
//     a mirror sync needs at most 46; a call needing more is split into the
//     fewest launches by the wrapper, counted);
//   * 16-byte words where a segment's row bytes and slab pointer allow it
//     (else 8, 4, 2, 1); 32-bit index arithmetic, one division a thread
//     with the host's (rows, words) increments after it; the staged reads
//     are contiguous and coalesced, the writes one row run at a time.
#include <cstdint>
#include <cuda_runtime.h>

#define SLAB_MAX_ARRAYS 64   // (problem, array) segments a scatter launch: a sync needs <= 46, both planes 49
#define SLAB_THREADS 256

// ---------------------------------------------------------------------------
// the batch gather
// ---------------------------------------------------------------------------

#define GATHER_MAX_SEGMENTS 64   // (problem, array) segments a launch: 34 pod + 13 term arrays today
#define GATHER_CHUNK_BYTES 4096  // output bytes a CTA (the scatter's too): SLAB_THREADS x 16-byte words

struct GatherSeg {
  const uint8_t* src;    // slab array [S, row_bytes]
  const uint8_t* empty;  // its padding row [row_bytes]
  int32_t dst;           // byte offset of the output [L, row_bytes] in the batch buffer
  int32_t rows;          // byte offset of the problem's lane rows [L] int32 (-1: padding) in the batch buffer
  int32_t log_word;      // word = 1 << log_word bytes (0..4), dividing row_bytes and every pointer
  int32_t row_words;     // words a row
  int32_t n_words;       // L x row_words
  int32_t step_rows;     // SLAB_THREADS / row_words: a thread's stride in rows ...
  int32_t step_words;    // ... and words (SLAB_THREADS % row_words)
  int32_t pad;
};

struct GatherBatchArgs {
  GatherSeg seg[GATHER_MAX_SEGMENTS];
  int32_t first_cta[GATHER_MAX_SEGMENTS];  // ascending: segment s owns CTAs [first_cta[s], first_cta[s + 1])
  uint8_t* base;        // the batch buffer: lane rows and columns first (copied from the host), then outputs
  int32_t n_segments;   // every segment has at least one CTA
  int32_t n_ctas;
};

template <typename W>
__device__ __forceinline__ void gather_chunk(const GatherSeg& s, uint8_t* base, int chunk) {
  constexpr int WORDS = GATHER_CHUNK_BYTES / (int)sizeof(W);
  const int end = min((chunk + 1) * WORDS, s.n_words);
  int w = chunk * WORDS + (int)threadIdx.x;
  if (w >= end) return;
  const W* src = (const W*)s.src;
  const W* empty = (const W*)s.empty;
  W* dst = (W*)(base + s.dst);
  const int32_t* rows = (const int32_t*)(base + s.rows);
  const int rw = s.row_words;
  int l = w / rw;
  int c = w - l * rw;
#pragma unroll 4
  for (; w < end; w += SLAB_THREADS) {
    const int32_t r = rows[l];
    dst[w] = r >= 0 ? src[(int64_t)r * rw + c] : empty[c];
    l += s.step_rows;
    c += s.step_words;
    if (c >= rw) {
      c -= rw;
      ++l;
    }
  }
}

// the CTA's segment: the last s with first_cta[s] <= b (first_cta ascending)
__device__ __forceinline__ int find_segment(const int32_t* first_cta, int n_segments, int b) {
  int lo = 0, hi = n_segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first_cta[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(SLAB_THREADS) gather_batch_kernel(const __grid_constant__ GatherBatchArgs a) {
  const int b = (int)blockIdx.x;
  const int lo = find_segment(a.first_cta, a.n_segments, b);
  const GatherSeg& s = a.seg[lo];
  const int chunk = b - a.first_cta[lo];
  switch (s.log_word) {
    case 4: gather_chunk<uint4>(s, a.base, chunk); break;
    case 3: gather_chunk<uint64_t>(s, a.base, chunk); break;
    case 2: gather_chunk<uint32_t>(s, a.base, chunk); break;
    case 1: gather_chunk<uint16_t>(s, a.base, chunk); break;
    default: gather_chunk<uint8_t>(s, a.base, chunk); break;
  }
}

extern "C" int ktpu_gather_batch(const GatherBatchArgs* args, cudaStream_t stream) {
  if (args->n_segments < 0 || args->n_segments > GATHER_MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  if (args->n_segments > 0 && args->n_ctas > 0) {
    gather_batch_kernel<<<(unsigned)args->n_ctas, SLAB_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the row scatter
// ---------------------------------------------------------------------------

struct ScatterSeg {
  uint8_t* dst;          // slab array [S, row_bytes]
  int32_t src;           // byte offset of the staged rows [R, row_bytes] in the staging buffer
  int32_t rows;          // byte offset of the problem's [R] int32 slab rows in the staging buffer
  int32_t log_word;      // word = 1 << log_word bytes (0..4), dividing row_bytes and the slab pointer
  int32_t row_words;     // words a row
  int32_t n_words;       // R x row_words
  int32_t step_rows;     // SLAB_THREADS / row_words: a thread's stride in rows ...
  int32_t step_words;    // ... and words (SLAB_THREADS % row_words)
  int32_t pad;
};

struct ScatterArgs {
  ScatterSeg seg[SLAB_MAX_ARRAYS];
  int32_t first_cta[SLAB_MAX_ARRAYS];  // ascending: segment s owns CTAs [first_cta[s], first_cta[s + 1])
  const uint8_t* base;  // the staging buffer: row vectors and staged rows, copied from pinned host memory
  int32_t n_segments;   // every segment has at least one CTA
  int32_t n_ctas;
};

template <typename W>
__device__ __forceinline__ void scatter_chunk(const ScatterSeg& s, const uint8_t* base, int chunk) {
  constexpr int WORDS = GATHER_CHUNK_BYTES / (int)sizeof(W);
  const int end = min((chunk + 1) * WORDS, s.n_words);
  int w = chunk * WORDS + (int)threadIdx.x;
  if (w >= end) return;
  const W* src = (const W*)(base + s.src);
  W* dst = (W*)s.dst;
  const int32_t* rows = (const int32_t*)(base + s.rows);
  const int rw = s.row_words;
  int l = w / rw;
  int c = w - l * rw;
#pragma unroll 4
  for (; w < end; w += SLAB_THREADS) {
    dst[(int64_t)rows[l] * rw + c] = src[w];
    l += s.step_rows;
    c += s.step_words;
    if (c >= rw) {
      c -= rw;
      ++l;
    }
  }
}

__global__ void __launch_bounds__(SLAB_THREADS) scatter_slab_kernel(const __grid_constant__ ScatterArgs a) {
  const int b = (int)blockIdx.x;
  const int lo = find_segment(a.first_cta, a.n_segments, b);
  const ScatterSeg& s = a.seg[lo];
  const int chunk = b - a.first_cta[lo];
  switch (s.log_word) {
    case 4: scatter_chunk<uint4>(s, a.base, chunk); break;
    case 3: scatter_chunk<uint64_t>(s, a.base, chunk); break;
    case 2: scatter_chunk<uint32_t>(s, a.base, chunk); break;
    case 1: scatter_chunk<uint16_t>(s, a.base, chunk); break;
    default: scatter_chunk<uint8_t>(s, a.base, chunk); break;
  }
}

extern "C" int ktpu_scatter_slab(const ScatterArgs* args, cudaStream_t stream) {
  if (args->n_segments < 0 || args->n_segments > SLAB_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  if (args->n_segments > 0 && args->n_ctas > 0) {
    scatter_slab_kernel<<<(unsigned)args->n_ctas, SLAB_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
