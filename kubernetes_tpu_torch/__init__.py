"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

A second package beside the JAX one, which stays the reference: the same
batch re-design of the v1.16 kube-scheduler (pods x nodes mask and score
matrices, one greedy batch solve, device-resident node and existing-pod
signature banks), with every
device program a kernel written by hand for NVIDIA Hopper (`csrc/`, built
by `kernels/build.py`) and plain PyTorch between them. It imports torch and
numpy, never jax and nothing of `kubernetes_tpu`.

Entry points run on the CUDA card unless the caller passes device="cpu",
which runs each kernel's plain PyTorch version instead.

Layout mirrors the reference package:
  api/        typed Pod/Node objects, resource.Quantity, label selectors,
              Service, the k8s JSON wire conversion
  oracle/     NodeInfo/Snapshot, the host oracle's predicate chain
              (predicates.go semantics), read by the driver's per-pod
              re-checks, the victim search and the term compiler, and the
              host priority set (the extender's /prioritize, Policy plugins)
  state/      interner, tensor encoding (node, signature, pod banks), term
              tables, queue, cache + device mirror, the zone-interleaved
              node order
  ops/        filters, scores, topology, solver, pipeline, fold, preempt
              (kernel wrappers + plain versions)
  commit/     the commit arbiter and the fold planner
  scheduler/  the batch driver and preemption
  framework/  the Scheduling Framework: plugins, CycleState, the registry
  extender/   the HTTP SchedulerExtender: server and client
  config/     feature gates (utils/), providers, Policy, ComponentConfig,
              the Configurator that builds a Scheduler from them
  kernels/    nvcc build + ctypes loading of csrc/*.cu
"""

__version__ = "0.1.0"
