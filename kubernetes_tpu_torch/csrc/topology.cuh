// Shared pieces of the topology kernels (topology.cu, interpod.cu): the
// block size, block-wide reductions, ordered compactions and per-row term
// lists in shared memory, and the dense topology bucket of a node.
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

// Append the indices i < n with pred(i) to `list` in ascending order (a
// block-wide ordered compaction); returns their count.
template <typename Pred>
__device__ int ordered_compact(int n, Pred pred, int32_t* list, int32_t* warp_cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + threadIdx.x;
    const bool f = i < n && pred(i);
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = total, sum = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      off += w < warp ? warp_cnt[w] : 0;
      sum += warp_cnt[w];
    }
    if (f) list[off + __popc(bal & ((1u << lane) - 1u))] = i;
    total += sum;
    __syncthreads();
  }
  return total;
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
