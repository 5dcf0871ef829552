// Resident-state fold: a committed batch's deltas scattered into the device
// banks in place.
//
// Replaces kubernetes_tpu/ops/fold.py:fold_commit_banks (:44). One launch
// covers the B commit lanes and the T pattern triples: thread i < B adds
// lane i's request vector, non-zero scoring request and pod count into its
// node row and one count into its (node, signature) cell; thread B + j adds
// triple j's count into its (node, pattern) cell. A lane whose index is out
// of range (the padding sentinels N, S, PT) adds nothing, as the
// reference's mode="drop" scatters.
//
// Duplicates are the norm (many pods of one signature land on one node), so
// every add is an integer atomic: 64-bit atomicAdd on the int64 columns
// (two's-complement add on the unsigned view), 32-bit atomicAdd on the pod
// count, and for the int16 count cells a 32-bit atomicCAS loop on the
// aligned word holding the half, which wraps the half as two's complement
// like the reference's astype + add. Integer adds commute, so the result is
// exact in any order.
//
// Bound: bytes. The lanes read their control rows once and touch
// R + 2 + 1 + 1 (or 1) bank cells each; a few thousand lanes are a few
// hundred KB, so a launch costs its latency, not its bandwidth.
//
// fold_usage_kernel replaces kubernetes_tpu/ops/fold.py:fold_usage (:74),
// the preemption nominees' overlay on the usage columns: thread i adds
// entry i's request vector and pod count into its node row with the same
// 64- and 32-bit atomics (several nominees on one node are duplicate rows);
// the driver removes the overlay with negated vectors and counts, an exact
// integer inverse. Bound: bytes, a few KB a launch.
//
// The node-sharded twins (fold_commit_sharded_kernel, fold_usage_sharded_
// kernel) replace kubernetes_tpu/ops/fold.py:make_sharded_fold_fns (:96),
// its commit (:156) and usage (:164) folds under shard_map: the banks are
// split over S node shards of Nl rows, the control arrays are replicated,
// and each shard rebases the global rows onto its own and drops foreign
// lanes, so no collective is needed. One launch covers every shard:
// blockIdx.y is the shard, and each lane adds only on the shard that owns
// its row, with the same integer atomics. Bound: bytes, as the fold's; the
// S-fold grid reads each lane's row S times (a few KB).
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

__device__ __forceinline__ void add_i64(int64_t* p, int64_t v) {
  if (v != 0) atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

// *p += v on an int16 cell: CAS on the aligned 32-bit word that holds it
__device__ __forceinline__ void add_i16(int16_t* p, int32_t v) {
  if ((v & 0xFFFF) == 0) return;
  const uintptr_t addr = (uintptr_t)p;
  unsigned int* word = (unsigned int*)(addr & ~(uintptr_t)3);
  const unsigned int shift = (addr & 2) ? 16u : 0u;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    const unsigned int half = (assumed >> shift) & 0xFFFFu;
    const unsigned int sum = (half + (unsigned int)v) & 0xFFFFu;
    const unsigned int next = (assumed & ~(0xFFFFu << shift)) | (sum << shift);
    old = atomicCAS(word, assumed, next);
  } while (old != assumed);
}

// Lane i of one commit fold, on the shard owning rows [lo, lo + Nl): a row
// outside them (another shard's, or a padding sentinel) adds nothing; the
// single-device fold is the one shard lo = 0, Nl = N.
__device__ __forceinline__ void commit_lane(const FoldArgs& a, int i, int lo, int Nl) {
  if (i < a.B) {
    const int32_t row = a.rows[i] - lo;  // rebased onto the shard's rows
    if (row < 0 || row >= Nl) return;
    int64_t* requested = a.requested + (int64_t)lo * a.R;
    int64_t* nonzero_req = a.nonzero_req + (int64_t)lo * 2;
    for (int r = 0; r < a.R; ++r) add_i64(requested + (int64_t)row * a.R + r, a.req[(int64_t)i * a.R + r]);
    add_i64(nonzero_req + (int64_t)row * 2 + 0, a.nz[(int64_t)i * 2 + 0]);
    add_i64(nonzero_req + (int64_t)row * 2 + 1, a.nz[(int64_t)i * 2 + 1]);
    const int32_t c = a.cnt[i];
    if (c != 0) atomicAdd(a.pod_count + lo + row, c);
    const int32_t s = a.sig[i];
    if (s >= 0 && s < a.S) add_i16(a.sig_counts + ((int64_t)lo + row) * a.S + s, c);
  } else if (i < a.B + a.T) {
    const int j = i - a.B;
    const int32_t row = a.pat_row[j] - lo;
    const int32_t col = a.pat_col[j];
    if (row < 0 || row >= Nl || col < 0 || col >= a.PT) return;
    add_i16(a.pat_counts + ((int64_t)lo + row) * a.PT + col, (int32_t)a.pat_cnt[j]);
  }
}

__global__ void fold_commit_kernel(const FoldArgs a) {
  commit_lane(a, blockIdx.x * blockDim.x + threadIdx.x, 0, a.N);
}

// the node-sharded fold: blockIdx.y is the shard
struct ShardedFoldArgs {
  FoldArgs fold;
  int32_t S, Nl;  // shards, rows a shard (N = S * Nl)
};

__global__ void fold_commit_sharded_kernel(const ShardedFoldArgs g) {
  commit_lane(g.fold, blockIdx.x * blockDim.x + threadIdx.x, blockIdx.y * g.Nl, g.Nl);
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

extern "C" int ktpu_fold_commit_banks(const FoldArgs* args, cudaStream_t stream) {
  const int lanes = args->B + args->T;
  if (lanes > 0) {
    fold_commit_kernel<<<(lanes + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

static bool sharded_shape_ok(int S, int Nl, int N) { return S >= 1 && Nl >= 1 && (int64_t)S * Nl == N; }

extern "C" int ktpu_fold_commit_sharded(const ShardedFoldArgs* args, cudaStream_t stream) {
  if (!sharded_shape_ok(args->S, args->Nl, args->fold.N)) return (int)cudaErrorInvalidValue;
  const int lanes = args->fold.B + args->fold.T;
  if (lanes > 0) {
    const dim3 grid((lanes + FOLD_THREADS - 1) / FOLD_THREADS, args->S);
    fold_commit_sharded_kernel<<<grid, FOLD_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int ktpu_fold_usage_sharded(const ShardedFoldUsageArgs* args, cudaStream_t stream) {
  if (!sharded_shape_ok(args->S, args->Nl, args->fold.N)) return (int)cudaErrorInvalidValue;
  if (args->fold.B > 0) {
    const dim3 grid((args->fold.B + FOLD_THREADS - 1) / FOLD_THREADS, args->S);
    fold_usage_sharded_kernel<<<grid, FOLD_THREADS, 0, stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
