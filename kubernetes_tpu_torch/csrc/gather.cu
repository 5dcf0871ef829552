// Score-row gather for the host oracle: out[k, :] = score[rows[k], :].
//
// Replaces kubernetes_tpu/ops/pipeline.py:gather_score_rows (:374), the
// device-side row gather that lets the driver's host oracle
// (scheduler/driver._oracle_place) rank its feasible nodes by the rows of
// the batch's [U, N] int64 score matrix without bringing the whole matrix
// to the host: only the K gathered rows cross.
//
// What the driver needs is "rows `rows` of the device score matrix, on the
// host", so the kernel is built for that:
//   * the row indices travel in the __grid_constant__ argument block (up to
//     SCORE_GATHER_MAX_INLINE of them): no device index tensor, no
//     host->device copy, and every CTA knows its source row at launch, with
//     no dependent load before its first read. Past the cap the wrapper
//     copies the rows from pinned memory without blocking and passes
//     `lanes`;
//   * CTAs sized by bytes: a CTA copies `words` x 512 int64 (4, 8 or 16
//     KB) of one row, each thread `words` independent 16-byte words loaded
//     before any is stored; the host takes the widest CTA that still gives
//     two CTAs an SM (SCORE_GATHER_MIN_CTAS), else 4 KB. At the
//     config-3-hard shapes (N = 10,240) that is 640 CTAs of 16 KB at
//     K = 128 (all resident at once) and 20 to 80 of 4 KB at the driver's
//     K of 1 to 4;
//   * 16-byte words where a row's source and destination share their
//     16-byte phase (always when N is even and both bases are 16-byte
//     aligned); then an odd first element is copied alone and an odd last
//     one is the scalar tail. Rows whose phases differ take 8-byte words;
//   * the destination may be pinned host memory mapped into the device's
//     address space (unified addressing): the wrapper points `out` at a
//     pinned buffer of the caching host allocator, so the rows cross the
//     bus once, from the kernel's own stores, with no device output and no
//     separate copy. The same kernel writes a device buffer when given one.
// The wrapper has checked every index against U on the host.
//
// Bound: bytes — K * N * 8 read and K * N * 8 written (21 MB at K = U =
// 128, N = 10,240: ~6 us at 3.35 TB/s; the score matrix of 10.5 MB usually
// sits in the 50 MB L2). At the driver's K of a few rows a launch costs its
// latency, and a host destination adds the bus.
#include <cstdint>
#include <cuda_runtime.h>

#define SCORE_GATHER_THREADS 256
#define SCORE_GATHER_MAX_WORDS 4      // 16-byte words a thread: a CTA copies 512 x words int64
#define SCORE_GATHER_MIN_CTAS 264     // the host narrows CTAs until a launch has two an SM (132 SMs)
#define SCORE_GATHER_MAX_INLINE 512   // row indices in the argument block (2 KB of a 4 KB block)

struct GatherArgs {
  const int64_t* score;   // [U, N]
  int64_t* out;           // [K, N]: device memory, or pinned host memory at its device address
  const int32_t* lanes;   // [K] rows in device memory when K > SCORE_GATHER_MAX_INLINE, else null
  int32_t U, N, K;
  int32_t chunks;         // CTAs a row: ceil(N / (512 x words))
  int32_t words;          // 16-byte words a thread: 1, 2 or 4
  int32_t rows[SCORE_GATHER_MAX_INLINE];  // the rows, when K <= SCORE_GATHER_MAX_INLINE
};

template <int WORDS>
__device__ __forceinline__ void gather_row_chunk(const GatherArgs& a, int k, int chunk) {
  constexpr int CHUNK = 2 * SCORE_GATHER_THREADS * WORDS;  // int64 elements a CTA
  const int r = a.lanes != nullptr ? a.lanes[k] : a.rows[k];
  const int64_t* __restrict__ src = a.score + (int64_t)r * a.N;
  int64_t* __restrict__ dst = a.out + (int64_t)k * a.N;
  const int phase = (int)(((uintptr_t)src >> 3) & 1);
  const bool wide = phase == (int)(((uintptr_t)dst >> 3) & 1);
  // a wide row's pairs start at element `head`, where both are 16-byte aligned
  const int head = wide ? phase : 0;
  if (head == 1 && chunk == 0 && threadIdx.x == 0) dst[0] = src[0];
  const int lo = head + chunk * CHUNK;
  const int hi = min(lo + CHUNK, a.N);
  if (lo >= hi) return;
  if (wide) {
    const int pairs = (hi - lo) >> 1;
    const longlong2* s2 = reinterpret_cast<const longlong2*>(src + lo);
    longlong2* d2 = reinterpret_cast<longlong2*>(dst + lo);
    longlong2 v[WORDS];
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      const int p = (int)threadIdx.x + i * SCORE_GATHER_THREADS;
      if (p < pairs) v[i] = s2[p];
    }
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      const int p = (int)threadIdx.x + i * SCORE_GATHER_THREADS;
      if (p < pairs) d2[p] = v[i];
    }
    // the scalar tail: only the row's last chunk can hold an odd count
    if (((hi - lo) & 1) && threadIdx.x == 0) dst[hi - 1] = src[hi - 1];
  } else {
    for (int e = lo + (int)threadIdx.x; e < hi; e += SCORE_GATHER_THREADS) dst[e] = src[e];
  }
}

__global__ void __launch_bounds__(SCORE_GATHER_THREADS) gather_rows_kernel(const __grid_constant__ GatherArgs a) {
  const int b = (int)blockIdx.x;
  const int k = b / a.chunks;
  const int chunk = b - k * a.chunks;
  switch (a.words) {
    case 4: gather_row_chunk<4>(a, k, chunk); break;
    case 2: gather_row_chunk<2>(a, k, chunk); break;
    default: gather_row_chunk<1>(a, k, chunk); break;
  }
}

extern "C" int ktpu_gather_score_rows(const GatherArgs* args, cudaStream_t stream) {
  if (args->K < 0 || (args->K > SCORE_GATHER_MAX_INLINE && args->lanes == nullptr) || args->chunks < 0 ||
      (args->words != 1 && args->words != 2 && args->words != SCORE_GATHER_MAX_WORDS) ||
      (args->K > 0 && args->N > 0 && (long long)args->chunks * 2 * SCORE_GATHER_THREADS * args->words < args->N)) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->K > 0 && args->N > 0) {
    const long long ctas = (long long)args->chunks * args->K;
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    gather_rows_kernel<<<(unsigned)ctas, SCORE_GATHER_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// *out = 1 when `p` is host memory the device reaches at the same address
// (pinned and mapped under unified addressing), else 0.
extern "C" int ktpu_host_pointer(const void* p, int* out) {
  cudaPointerAttributes at;
  const cudaError_t e = cudaPointerGetAttributes(&at, p);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  *out = (at.type == cudaMemoryTypeHost && at.devicePointer == p) ? 1 : 0;
  return 0;
}
