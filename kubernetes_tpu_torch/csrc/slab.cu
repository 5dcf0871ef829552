// Slab row gather and row scatter for the ingest and term planes.
//
// ktpu_gather_slab replaces kubernetes_tpu/ingest/gather.py:gather_stage
// (:28) and kubernetes_tpu/terms_plane/gather.py:gather_terms (:28): for
// every array k of a resident slab dict and every lane l of an index vector,
//
//     out[k][l] = keep[l] ? slab[k][idx[l]] : empty[k][0]
//
// and one optional int32 column overrides one array: gather_stage's
// `fallback` takes the shipped vector as it is (col_masked = 0),
// gather_terms's `owner` takes keep[l] ? col[l] : 0 (col_masked = 1).
//
// ktpu_scatter_slab replaces kubernetes_tpu/ingest/bank.py:_scatter_fn (:54;
// terms_plane/bank.py:22 reuses it): slab[k][idx[r]] = rows[k][r] for the R
// dirty rows staged since the last flush. The caller's duplicate indices
// carry identical bytes, so the order of the writes does not matter.
//
// Both are pure data movement over a descriptor table passed by value: one
// entry per array (source, padding row, destination, bytes a row), so each
// call is ONE launch for the whole dict. Layout: one block row per array
// (blockIdx.y); blockIdx.x and the threads walk the array's lanes x words
// with a grid stride, neighbouring threads on neighbouring words of a row
// so loads and stores coalesce. The word is 8 bytes where the row bytes and
// every pointer allow it, else 4, else 1 (bool rows are single bytes). The
// table is a __grid_constant__ parameter: a block reads its own entry in
// place, with no per-thread copy. The wrapper has checked every index
// against the slab's rows on the host.
//
// Bound: bytes. A gather reads L rows and writes L rows of every array
// (3,000 B a pod row at K = 64, R = 8; 196 B a term row): 768 KB at L = 128,
// ~0.23 us at 3.35 TB/s; a launch costs its latency. A scatter moves R dirty
// rows twice (read the staged copy, write the slab).
#include <cstdint>
#include <cuda_runtime.h>

#define SLAB_MAX_ARRAYS 48
#define SLAB_THREADS 256
#define SLAB_MAX_BLOCKS_X 128

struct SlabArray {
  const void* src;    // gather: slab array [S, row_bytes]; scatter: staged rows [R, row_bytes]
  const void* empty;  // gather: the padding row [row_bytes]; scatter: unused
  void* dst;          // gather: output [L, row_bytes]; scatter: slab array [S, row_bytes]
  int64_t row_bytes;
};

struct SlabArgs {
  SlabArray a[SLAB_MAX_ARRAYS];
  const int32_t* idx;   // [L] slab rows
  const int32_t* keep;  // [L] 1 = a gathered lane, 0 = padding (gather only)
  const int32_t* col;   // [L] the override column, or null
  int32_t col_array;    // the array the column writes (its rows 1 or 4 bytes), -1 for none
  int32_t col_masked;   // 1: keep ? col : 0; 0: col as given
  int32_t n_arrays;
  int32_t L;            // lanes (gather) or dirty rows (scatter)
};

__device__ __forceinline__ int word_bytes(const SlabArray& d) {
  const uint64_t bits = (uint64_t)d.row_bytes | (uint64_t)(uintptr_t)d.src |
                        (uint64_t)(uintptr_t)d.dst | (uint64_t)(uintptr_t)d.empty;
  if ((bits & 7) == 0) return 8;
  if ((bits & 3) == 0) return 4;
  return 1;
}

template <typename W>
__device__ void gather_words(const SlabArray& d, const SlabArgs& a) {
  const W* src = (const W*)d.src;
  const W* empty = (const W*)d.empty;
  W* dst = (W*)d.dst;
  const int64_t row_words = d.row_bytes / (int64_t)sizeof(W);
  const int64_t total = (int64_t)a.L * row_words;
  for (int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; w < total;
       w += (int64_t)gridDim.x * blockDim.x) {
    const int64_t l = w / row_words;
    const int64_t c = w - l * row_words;
    dst[w] = a.keep[l] ? src[(int64_t)a.idx[l] * row_words + c] : empty[c];
  }
}

template <typename T>
__device__ void write_column(const SlabArray& d, const SlabArgs& a) {
  T* dst = (T*)d.dst;
  for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < a.L; l += gridDim.x * blockDim.x) {
    const int32_t v = a.col_masked ? (a.keep[l] ? a.col[l] : 0) : a.col[l];
    dst[l] = sizeof(T) == 1 ? (T)(v != 0) : (T)v;
  }
}

__global__ void gather_slab_kernel(const __grid_constant__ SlabArgs a) {
  const int k = blockIdx.y;
  const SlabArray& d = a.a[k];
  if (k == a.col_array) {
    if (d.row_bytes == 1) write_column<uint8_t>(d, a);
    else write_column<int32_t>(d, a);
    return;
  }
  const int wb = word_bytes(d);
  if (wb == 8) gather_words<uint64_t>(d, a);
  else if (wb == 4) gather_words<uint32_t>(d, a);
  else gather_words<uint8_t>(d, a);
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

extern "C" int ktpu_gather_slab(const SlabArgs* args, cudaStream_t stream) {
  if (args->n_arrays < 0 || args->n_arrays > SLAB_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  if (args->L > 0 && args->n_arrays > 0) {
    gather_slab_kernel<<<slab_grid(args), SLAB_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int ktpu_scatter_slab(const SlabArgs* args, cudaStream_t stream) {
  if (args->n_arrays < 0 || args->n_arrays > SLAB_MAX_ARRAYS) return (int)cudaErrorInvalidValue;
  if (args->L > 0 && args->n_arrays > 0) {
    scatter_slab_kernel<<<slab_grid(args), SLAB_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
