// Shared device helpers of the port's kernels: the encoding codes of
// state/tensors.py and the two matching rules both the filter and the score
// kernel evaluate (compiled node-selector requirements and tolerations).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// operator codes for compiled node-selector requirements (state/tensors.py)
#define OP_PAD 0
#define OP_IN 1
#define OP_NOT_IN 2
#define OP_EXISTS 3
#define OP_DOES_NOT_EXIST 4
#define OP_GT 5
#define OP_LT 6
#define OP_NAME_IN 7
#define OP_NAME_NOT_IN 8
#define OP_NEVER 9

// taint effects and toleration operators
#define EFFECT_NO_SCHEDULE 1
#define EFFECT_PREFER_NO_SCHEDULE 2
#define EFFECT_NO_EXECUTE 3
#define TOL_EXISTS 1

#define MAX_NODE_SCORE 10

// One compiled requirement against one node (ops/filters._eval_requirements):
// the slot is clipped to [0, K) and only a known slot (>= 0) can be present;
// padded value lanes hold -1; the name operators compare vals[0] with the
// node's name id; PAD (and any unknown code) evaluates true.
__device__ __forceinline__ bool eval_requirement(
    int32_t op, int32_t slot, const int32_t* vals, int V, int64_t num,
    const int32_t* label_vals, const int64_t* label_num, const uint8_t* label_num_ok,
    int K, int32_t name_id) {
  const int sc = slot < 0 ? 0 : (slot > K - 1 ? K - 1 : slot);
  const bool known = slot >= 0;
  const int32_t nv = label_vals[sc];
  const bool present = known && nv != 0;
  switch (op) {
    case OP_IN:
    case OP_NOT_IN: {
      bool in_set = false;
      for (int v = 0; v < V; ++v) in_set |= (nv == vals[v]);
      return op == OP_IN ? (present && in_set) : (!present || !in_set);
    }
    case OP_EXISTS: return present;
    case OP_DOES_NOT_EXIST: return !present;
    case OP_GT: return known && label_num_ok[sc] && label_num[sc] > num;
    case OP_LT: return known && label_num_ok[sc] && label_num[sc] < num;
    case OP_NAME_IN: return name_id == vals[0];
    case OP_NAME_NOT_IN: return name_id != vals[0];
    case OP_NEVER: return false;
    default: return true;
  }
}

// Toleration.ToleratesTaint over a pod's toleration list (filters._tolerates):
// an empty key or effect matches everything; Exists ignores the value.
__device__ __forceinline__ bool tolerated(
    const int32_t* tol_key, const int32_t* tol_op, const int32_t* tol_val,
    const int32_t* tol_effect, const uint8_t* tol_valid, int TL,
    int32_t key, int32_t val, int32_t effect) {
  for (int l = 0; l < TL; ++l) {
    if (tol_valid[l] && (tol_effect[l] == 0 || tol_effect[l] == effect) &&
        (tol_key[l] == 0 || tol_key[l] == key) &&
        (tol_op[l] == TOL_EXISTS || tol_val[l] == val)) {
      return true;
    }
  }
  return false;
}

// A host-port list as three arrays (the pod-vs-node filter's lists) ...
struct PortArrays {
  const int32_t* n;
  const int32_t* p;
  const int32_t* i;
  __device__ __forceinline__ int32_t num(int k) const { return n[k]; }
  __device__ __forceinline__ int32_t proto(int k) const { return p[k]; }
  __device__ __forceinline__ int32_t ip(int k) const { return i[k]; }
};

// ... or as (num, proto, ip, -) words (the match launch's port slice keeps
// a spec row's live lanes so in shared memory)
struct PortLanes {
  const int4* l;
  __device__ __forceinline__ int32_t num(int k) const { return l[k].x; }
  __device__ __forceinline__ int32_t proto(int k) const { return l[k].y; }
  __device__ __forceinline__ int32_t ip(int k) const { return l[k].z; }
};

// HostPortInfo.CheckConflict (filters.port_clash) between two host-port
// lists: the same (protocol, port) conflicts when either IP is the wildcard
// or the two are equal; port 0 lanes are padding. The one definition the
// pod-vs-node filter and the pod-vs-pod in-batch conflict table (the match
// launch's port slice, topology.cu) share.
template <class A, class B>
__device__ __forceinline__ bool port_lists_clash(const A& a, int PA, const B& b, int PB, int32_t wildcard_ip) {
  for (int i = 0; i < PA; ++i) {
    const int32_t na = a.num(i);
    if (na <= 0) continue;
    for (int j = 0; j < PB; ++j) {
      const int32_t nb = b.num(j);
      if (nb > 0 && nb == na && b.proto(j) == a.proto(i) &&
          (a.ip(i) == wildcard_ip || b.ip(j) == wildcard_ip || a.ip(i) == b.ip(j))) {
        return true;
      }
    }
  }
  return false;
}

__device__ __forceinline__ bool ports_clash(
    const int32_t* num_a, const int32_t* proto_a, const int32_t* ip_a, int PA,
    const int32_t* num_b, const int32_t* proto_b, const int32_t* ip_b, int PB, int32_t wildcard_ip) {
  return port_lists_clash(PortArrays{num_a, proto_a, ip_a}, PA, PortArrays{num_b, proto_b, ip_b}, PB, wildcard_ip);
}

// Python's floor division (jnp `//`) on int64.
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
static inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  return 0;
}

// Thread-block clusters (the solve and the arbiter run one cluster of S
// CTAs, S = 1 on one device, one CTA a node shard on a mesh; the score
// matrix a cluster a spec row): 8 is the portable cluster size, 16 the
// largest Hopper allows (non-portable).
#define PORTABLE_CLUSTER 8
#define MAX_CLUSTER 16

// A grid of `rows` clusters of S CTAs each (gridDim = (S, rows), cluster
// dim S along x): the launch configuration, the non-portable size opt-in
// above 8 and the dynamic shared-memory opt-in.
static inline int cluster_config(const void* kernel, int S, int threads, size_t bytes, cudaStream_t stream,
                                 cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int rows = 1) {
  if (S < 1 || S > MAX_CLUSTER || rows < 1) return (int)cudaErrorInvalidValue;
  int rc;
  if (S > PORTABLE_CLUSTER &&
      (rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))) {
    return rc;
  }
  if ((rc = set_smem(kernel, bytes))) return rc;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(S, rows, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// The two halves of a split cluster barrier: a CTA arrives once its reads
// of the other CTAs' shared memory are done and waits before it exits, so
// no CTA leaves while another still reads its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Launch `kernel(*arg)` as `rows` clusters of S CTAs (one by default).
template <typename Args>
static inline int launch_cluster(const void* kernel, int S, int threads, size_t bytes, const Args& arg,
                                 cudaStream_t stream, int rows = 1) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int rc = cluster_config(kernel, S, threads, bytes, stream, &cfg, &attr, rows);
  if (rc) return rc;
  void* params[] = {(void*)&arg};
  if ((rc = (int)cudaLaunchKernelExC(&cfg, kernel, params))) return rc;
  return (int)cudaGetLastError();
}

// How many such clusters the card holds at once (0: it cannot launch one).
static inline int cluster_capacity(const void* kernel, int S, int threads, size_t bytes, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int rc = cluster_config(kernel, S, threads, bytes, 0, &cfg, &attr);
  if (rc) return rc;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}
