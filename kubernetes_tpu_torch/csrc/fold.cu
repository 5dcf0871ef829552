// Resident-state fold: a committed batch's deltas scattered into the device
// banks in place.
//
// Replaces kubernetes_tpu/ops/fold.py:fold_commit_banks (:44). One launch,
// ONE THREAD A BANK ELEMENT: the B commit lanes' (lane, column) elements —
// the R request columns and the two non-zero columns (int64), the pod count
// (int32) and the signature cell (int16) — then the T pattern triples
// (int16), laid out
//   [0, B*(R+2))            lane e / (R+2), column e % (R+2) of [req | nz]
//   [B*(R+2), B*(R+3))      lane's pod count
//   [B*(R+3), B*(R+4))      lane's (node, signature) cell
//   [B*(R+4), B*(R+4) + T)  triple's (node, pattern) cell
// so neighbouring threads read neighbouring control words (coalesced) and
// every thread issues its loads together: one round trip, then one add. A
// lane whose index is out of range (the padding sentinels N, S, PT) adds
// nothing, as the reference's mode="drop" scatters. The main path
// (ops/fold.fold_commit_packed) hands B and T as the LIVE counts of the
// batch's program, packed in one pinned upload, so the grid covers no
// padding; a caller passing padded tensors gets its sentinels dropped.
//
// Duplicates are the norm (many pods of one signature land on one node, one
// pod's pattern triples share words), so every add is an integer atomic,
// and none waits for its result where the result is unused: fire-and-forget
// reductions (`red.global.add`) on the int64 columns (two's-complement add
// on the unsigned view) and the int32 pod count. An int16 cell takes ONE
// 32-bit atomic add on its aligned word: the high half adds (v & 0xFFFF) <<
// 16, whose carry out of bit 31 is the int16 wrap; the low half adds
// v & 0xFFFF, and where the returned old value shows a carry out of the low
// half ((old & 0xFFFF) + (v & 0xFFFF) > 0xFFFF) one more reduction adds
// 0xFFFF0000, taking the carry back out of the high half. Each is an add
// mod 2^32 that leaves the other half's bits as they were, so the result is
// exact in any interleaving, as the reference's astype + add wraps.
//
// Bound: bytes. A live lane reads (R + 2) * 8 + 12 control bytes and a
// triple 10 and each touches a bank cell; a config-3 batch is ~200 KB, so a
// launch costs its latency (one wave, one round trip a thread) and not its
// bandwidth.
//
// fold_usage_kernel replaces kubernetes_tpu/ops/fold.py:fold_usage (:74),
// the preemption nominees' overlay on the usage columns: thread i adds
// entry i's request vector and pod count into its node row with 64- and
// 32-bit atomics (several nominees on one node are duplicate rows); the
// driver removes the overlay with negated vectors and counts, an exact
// integer inverse. Bound: bytes, a few KB a launch.
//
// The node-sharded folds (ops/fold.fold_commit_sharded, fold_usage_sharded_
// kernel) replace kubernetes_tpu/ops/fold.py:make_sharded_fold_fns (:96),
// its commit (:156) and usage (:164) folds under shard_map: the banks are
// split over S node shards of Nl rows, the control arrays are replicated,
// and each shard rebases the global rows onto its own and drops foreign
// lanes, so no collective is needed. On one card the shards are row
// ranges of one bank, so the sharded commit IS the single fold: an
// element's row in [0, N) lies in exactly one shard and adds at the same
// address, and any other row belongs to no shard and adds nothing, as the
// reference's _local_rows drops it. ops/fold.fold_commit_sharded checks
// N = S * Nl and launches fold_commit_kernel, each element read once. The
// sharded usage fold keeps a grid of S slices (blockIdx.y the shard), each
// lane read S times.
#include "common.cuh"

#define FOLD_THREADS 256

struct FoldArgs {
  int64_t* requested;    // [N, R]
  int64_t* nonzero_req;  // [N, 2]
  int32_t* pod_count;    // [N]
  int16_t* sig_counts;   // [N, S]
  int16_t* pat_counts;   // [N, PT]
  const int32_t* rows;   // [B] node row per commit (N = pad)
  const int64_t* req;    // [B, R]
  const int64_t* nz;     // [B, 2]
  const int32_t* cnt;    // [B]
  const int32_t* sig;    // [B] signature row (S = pad)
  const int32_t* pat_row;  // [T] node row (N = pad)
  const int32_t* pat_col;  // [T] pattern row (PT = pad)
  const int16_t* pat_cnt;  // [T]
  int32_t N, R, S, PT, B, T;
};

// fire-and-forget adds: the result is not returned, so no thread waits on it
__device__ __forceinline__ void red_add_u64(void* p, unsigned long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "l"(v) : "memory");
}

__device__ __forceinline__ void red_add_u32(void* p, unsigned int v) {
  asm volatile("red.global.add.u32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)), "r"(v) : "memory");
}

__device__ __forceinline__ void add_i64(int64_t* p, int64_t v) {
  if (v != 0) red_add_u64(p, (unsigned long long)v);
}

// *p += v on an int16 cell, wrapping: one 32-bit atomic add on the aligned
// word that holds it (the carry correction, where the low half carried, a
// second fire-and-forget add). Between a low half's carry and its correction
// the word's high half reads one too high: exact once the kernel ends, since
// the banks are read and written only on the fold's stream, and each int16
// bank either holds whole words or ends its own allocation, so the high half
// past an odd bank's last cell is allocator padding that no tensor holds
// (ops/fold._bank_args checks this).
__device__ __forceinline__ void add_i16(int16_t* p, int32_t v) {
  const unsigned int h = (unsigned int)v & 0xFFFFu;
  if (h == 0) return;
  const uintptr_t addr = (uintptr_t)p;
  unsigned int* word = (unsigned int*)(addr & ~(uintptr_t)3);
  if (addr & 2) {  // the high half: its carry leaves the word, the int16 wrap
    red_add_u32(word, h << 16);
    return;
  }
  const unsigned int old = atomicAdd(word, h);
  if ((old & 0xFFFFu) + h > 0xFFFFu) red_add_u32(word, 0xFFFF0000u);  // the carry out of the high half again
}

// Element e of one commit fold: a lane or triple whose row is not in
// [0, N) (a padding sentinel, a negative row) adds nothing.
__device__ __forceinline__ void commit_element(const FoldArgs& a, int64_t e) {
  const int W = a.R + 2;
  const int64_t wide = (int64_t)a.B * W;
  if (e < wide) {  // an int64 column of a lane: its row and its value in one round trip
    const int i = (int)(e / W), c = (int)(e - (int64_t)i * W);
    const int64_t v = c < a.R ? __ldg(a.req + (int64_t)i * a.R + c) : __ldg(a.nz + (int64_t)i * 2 + (c - a.R));
    const int32_t row = __ldg(a.rows + i);
    if (row < 0 || row >= a.N) return;
    add_i64(c < a.R ? a.requested + (int64_t)row * a.R + c : a.nonzero_req + (int64_t)row * 2 + (c - a.R), v);
    return;
  }
  e -= wide;
  if (e < 2 * (int64_t)a.B) {  // a lane's pod count, then its signature cell
    const int i = (int)(e < a.B ? e : e - a.B);
    const int32_t row = __ldg(a.rows + i), c = __ldg(a.cnt + i);
    if (e < a.B) {
      if (row >= 0 && row < a.N && c != 0) red_add_u32(a.pod_count + row, (unsigned int)c);
      return;
    }
    const int32_t s = __ldg(a.sig + i);
    if (row < 0 || row >= a.N || s < 0 || s >= a.S) return;
    add_i16(a.sig_counts + (int64_t)row * a.S + s, c);
    return;
  }
  e -= 2 * (int64_t)a.B;
  if (e < a.T) {  // a pattern triple
    const int j = (int)e;
    const int32_t row = __ldg(a.pat_row + j), col = __ldg(a.pat_col + j);
    const int32_t v = __ldg(a.pat_cnt + j);
    if (row < 0 || row >= a.N || col < 0 || col >= a.PT) return;
    add_i16(a.pat_counts + (int64_t)row * a.PT + col, v);
  }
}

// the launch's elements: B lanes of R + 4 and T triples
__host__ __device__ __forceinline__ int64_t fold_elements(const FoldArgs& a) {
  return (int64_t)a.B * (a.R + 4) + a.T;
}

__global__ void __launch_bounds__(FOLD_THREADS) fold_commit_kernel(const FoldArgs a) {
  commit_element(a, (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x);
}

struct FoldUsageArgs {
  int64_t* requested;   // [N, R]
  int32_t* pod_count;   // [N]
  const int32_t* rows;  // [B] node row per entry (N = pad)
  const int64_t* vecs;  // [B, R]
  const int32_t* cnt;   // [B]
  int32_t N, R, B;
};

__device__ __forceinline__ void usage_lane(const FoldUsageArgs& a, int i, int lo, int Nl) {
  if (i >= a.B) return;
  const int32_t row = a.rows[i] - lo;
  if (row < 0 || row >= Nl) return;
  int64_t* requested = a.requested + (int64_t)lo * a.R;
  for (int r = 0; r < a.R; ++r) add_i64(requested + (int64_t)row * a.R + r, a.vecs[(int64_t)i * a.R + r]);
  const int32_t c = a.cnt[i];
  if (c != 0) atomicAdd(a.pod_count + lo + row, c);
}

__global__ void fold_usage_kernel(const FoldUsageArgs a) {
  usage_lane(a, blockIdx.x * blockDim.x + threadIdx.x, 0, a.N);
}

struct ShardedFoldUsageArgs {
  FoldUsageArgs fold;
  int32_t S, Nl;
};

__global__ void fold_usage_sharded_kernel(const ShardedFoldUsageArgs g) {
  usage_lane(g.fold, blockIdx.x * blockDim.x + threadIdx.x, blockIdx.y * g.Nl, g.Nl);
}

extern "C" int ktpu_fold_usage(const FoldUsageArgs* args, cudaStream_t stream) {
  if (args->B > 0) {
    fold_usage_kernel<<<(args->B + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

static bool fold_shape_ok(const FoldArgs& a) { return a.B >= 0 && a.T >= 0 && a.R >= 0; }

static unsigned fold_blocks(const FoldArgs& a) {
  return (unsigned)((fold_elements(a) + FOLD_THREADS - 1) / FOLD_THREADS);
}

extern "C" int ktpu_fold_commit_banks(const FoldArgs* args, cudaStream_t stream) {
  if (!fold_shape_ok(*args)) return (int)cudaErrorInvalidValue;
  if (fold_elements(*args) > 0) fold_commit_kernel<<<fold_blocks(*args), FOLD_THREADS, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}

static bool sharded_shape_ok(int S, int Nl, int N) { return S >= 1 && Nl >= 1 && (int64_t)S * Nl == N; }

extern "C" int ktpu_fold_usage_sharded(const ShardedFoldUsageArgs* args, cudaStream_t stream) {
  if (!sharded_shape_ok(args->S, args->Nl, args->fold.N)) return (int)cudaErrorInvalidValue;
  if (args->fold.B > 0) {
    const dim3 grid((args->fold.B + FOLD_THREADS - 1) / FOLD_THREADS, args->S);
    fold_usage_sharded_kernel<<<grid, FOLD_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
