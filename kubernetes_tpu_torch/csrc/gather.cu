// Score-row gather for the host oracle: out[k, :] = score[idx[k], :].
//
// Replaces kubernetes_tpu/ops/pipeline.py:gather_score_rows (:374), the
// device-side row gather that lets the driver's host oracle
// (scheduler/driver._oracle_place) rank its feasible nodes by the rows of
// the batch's [U, N] int64 score matrix without bringing the whole matrix
// to the host: only the K gathered rows cross.
//
// One block row (blockIdx.y) per gathered row; blockIdx.x and the threads
// walk the row's N columns with a grid stride, neighbouring threads on
// neighbouring int64 words, so every load and store is coalesced. The
// block reads its source row index once. No shared memory: nothing is
// reused. The wrapper has checked every index against U on the host.
//
// Bound: bytes — K * N * 8 read and K * N * 8 written (21 MB at the
// config-3-hard shapes K = U = 128, N = 10,240: ~6 us at 3.35 TB/s); at the
// driver's K of a few rows a launch costs its latency.
#include <cstdint>
#include <cuda_runtime.h>

#define GATHER_THREADS 256
#define GATHER_MAX_BLOCKS_X 64

struct GatherArgs {
  const int64_t* score;  // [U, N]
  const int32_t* idx;    // [K] rows of score, each in [0, U)
  int64_t* out;          // [K, N]
  int32_t U, N, K;
};

__global__ void gather_rows_kernel(const GatherArgs a) {
  const int k = blockIdx.y;
  const int64_t src = (int64_t)a.idx[k] * a.N;
  const int64_t dst = (int64_t)k * a.N;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < a.N; c += gridDim.x * blockDim.x) {
    a.out[dst + c] = a.score[src + c];
  }
}

extern "C" int ktpu_gather_score_rows(const GatherArgs* args, cudaStream_t stream) {
  if (args->K > 0 && args->N > 0) {
    int bx = (args->N + GATHER_THREADS - 1) / GATHER_THREADS;
    if (bx > GATHER_MAX_BLOCKS_X) bx = GATHER_MAX_BLOCKS_X;
    gather_rows_kernel<<<dim3(bx, args->K), GATHER_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
