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
// terms_plane/bank.py:22 reuses it): slab[k][idx[r]] = rows[k][r] for the R
// dirty rows staged since the last flush. The caller's duplicate indices
// carry identical bytes, so the order of the writes does not matter. It is
// pure data movement over a descriptor table passed by value: one entry per
// array (staged rows, destination slab, bytes a row), so each call is ONE
// launch for the whole dict. Layout: one block row per array (blockIdx.y);
// blockIdx.x and the threads walk the array's rows x words with a grid
// stride, neighbouring threads on neighbouring words of a row so loads and
// stores coalesce. The word is 8 bytes where the row bytes and every pointer
// allow it, else 4, else 1. A scatter moves R dirty rows twice (read the
// staged copy, write the slab).
#include <cstdint>
#include <cuda_runtime.h>

#define SLAB_MAX_ARRAYS 48
#define SLAB_THREADS 256
#define SLAB_MAX_BLOCKS_X 128

// the scatter's descriptor table (its layout predates the batch gather,
// whose own table is GatherBatchArgs below; keep, col, col_array and
// col_masked are unused by the scatter)
struct SlabArray {
  const void* src;    // staged rows [R, row_bytes]
  const void* empty;  // unused
  void* dst;          // slab array [S, row_bytes]
  int64_t row_bytes;
};

struct SlabArgs {
  SlabArray a[SLAB_MAX_ARRAYS];
  const int32_t* idx;   // [R] slab rows
  const int32_t* keep;
  const int32_t* col;
  int32_t col_array;
  int32_t col_masked;
  int32_t n_arrays;
  int32_t L;            // dirty rows
};

__device__ __forceinline__ int word_bytes(const SlabArray& d) {
  const uint64_t bits = (uint64_t)d.row_bytes | (uint64_t)(uintptr_t)d.src |
                        (uint64_t)(uintptr_t)d.dst | (uint64_t)(uintptr_t)d.empty;
  if ((bits & 7) == 0) return 8;
  if ((bits & 3) == 0) return 4;
  return 1;
}

template <typename W>
__device__ void scatter_words(const SlabArray& d, const SlabArgs& a) {
  const W* src = (const W*)d.src;
  W* dst = (W*)d.dst;
  const int64_t row_words = d.row_bytes / (int64_t)sizeof(W);
  const int64_t total = (int64_t)a.L * row_words;
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; w < total;
       w += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = w / row_words;
    const int64_t c = w - r * row_words;
    dst[(int64_t)a.idx[r] * row_words + c] = src[w];
  }
}

__global__ void scatter_slab_kernel(const __grid_constant__ SlabArgs a) {
  const SlabArray& d = a.a[blockIdx.y];
  const int wb = word_bytes(d);
  if (wb == 8) scatter_words<uint64_t>(d, a);
  else if (wb == 4) scatter_words<uint32_t>(d, a);
  else scatter_words<uint8_t>(d, a);
}

static dim3 slab_grid(const SlabArgs* args) {
  int64_t most = 0;
  for (int k = 0; k < args->n_arrays; ++k) {
    const int64_t b = (int64_t)args->L * args->a[k].row_bytes;
    if (b > most) most = b;
  }
  // sized for 8-byte words; narrower words loop in the grid stride
  int64_t bx = (most / 8 + SLAB_THREADS - 1) / SLAB_THREADS;
  if (bx < 1) bx = 1;
  if (bx > SLAB_MAX_BLOCKS_X) bx = SLAB_MAX_BLOCKS_X;
  return dim3((unsigned)bx, (unsigned)args->n_arrays);
}

extern "C" int ktpu_scatter_slab(const SlabArgs* args, cudaStream_t stream) {
  if (args->n_arrays < 0 || args->n_arrays > SLAB_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  if (args->L > 0 && args->n_arrays > 0) {
    scatter_slab_kernel<<<slab_grid(args), SLAB_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the batch gather
// ---------------------------------------------------------------------------

#define GATHER_MAX_SEGMENTS 64   // (problem, array) segments a launch: 34 pod + 13 term arrays today
#define GATHER_CHUNK_BYTES 4096  // output bytes a CTA: SLAB_THREADS x 16-byte words

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

__global__ void __launch_bounds__(SLAB_THREADS) gather_batch_kernel(const __grid_constant__ GatherBatchArgs a) {
  // the CTA's segment: the last s with first_cta[s] <= blockIdx.x
  const int b = (int)blockIdx.x;
  int lo = 0, hi = a.n_segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.first_cta[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
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
