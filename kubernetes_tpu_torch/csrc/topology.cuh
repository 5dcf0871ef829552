// Shared pieces of the topology kernels (topology.cu, interpod.cu): the
// block size, block-wide reductions, per-row term lists in shared memory,
// the dense topology bucket of a node, and the dynamic shared-memory opt-in.
#pragma once

#include "common.cuh"

// term kinds (state/terms.py)
#define AFF_REQ 1
#define ANTI_REQ 2
#define AFF_PREF 3
#define ANTI_PREF 4
#define SPREAD_HARD 5
#define SPREAD_SOFT 6
#define SEL_SPREAD 7

#define THREADS 256
#define BIG_COUNT (1 << 30)

// ---------------------------------------------------------------------------
// block reductions
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? red[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const T out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ __forceinline__ T block_max(T v, T* red, T ident) {
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? red[lane] : ident;
    for (int off = 16; off > 0; off >>= 1) {
      const T o = __shfl_down_sync(0xffffffffu, v, off);
      v = o > v ? o : v;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const T out = red[0];
  __syncthreads();
  return out;
}

template <typename T>
__device__ __forceinline__ T block_min(T v, T* red, T ident) {
  return -block_max<T>(-v, red, -ident);
}

// Append the terms of `kind` owned by spec row u to `list` (shared memory);
// returns their count. The order is arbitrary: every use is an AND or an
// integer sum.
__device__ __forceinline__ int owner_terms(const uint8_t* valid, const int32_t* kind, const int32_t* owner, int TT,
                           int32_t want_kind, int u, int32_t* list, int* n_list) {
  if (threadIdx.x == 0) *n_list = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < TT; t += blockDim.x) {
    if (valid[t] && kind[t] == want_kind && owner[t] == u) list[atomicAdd(n_list, 1)] = t;
  }
  __syncthreads();
  return *n_list;
}

// _bucket_of for one node: the dense value at the clipped slot, clipped to
// >= 0 into *b; returns has_key (a value is present and the slot is known).
__device__ __forceinline__ bool dense_bucket(const int32_t* label_dense, int K, int n, int32_t slot,
                                             int32_t* b) {
  const int sc = slot < 0 ? 0 : (slot > K - 1 ? K - 1 : slot);
  const int32_t d = label_dense[(int64_t)n * K + sc];
  *b = d < 0 ? 0 : d;
  return d >= 0 && slot >= 0;
}
