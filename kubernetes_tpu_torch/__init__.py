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
  api/        typed Pod/Node objects, resource.Quantity, label selectors
  oracle/     NodeInfo/Snapshot, the request helpers the encoding reads and
              the term helpers the term compiler reads
  state/      interner, tensor encoding (node, signature, pod banks), term
              tables, queue, cache + device mirror
  ops/        filters, scores, topology, solver, pipeline (kernel wrappers
              + plain versions)
  scheduler/  the batch driver
  kernels/    nvcc build + ctypes loading of csrc/*.cu
"""

__version__ = "0.1.0"
