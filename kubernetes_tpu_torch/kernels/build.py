"""Build and load the port's hand-written CUDA kernels.

`library()` compiles every `kubernetes_tpu_torch/csrc/*.cu` with nvcc for
Hopper (`sm_90a`) into ONE shared library with a plain C interface, and
loads it with ctypes. Each source compiles to an object in its own nvcc
process, all started together; one more nvcc links them. The library lands
in `build/kernels_torch/<source hash>/` at the repository root, so a second
process (or a second call) with the same sources loads it without building.

The flags keep integer and float64 arithmetic exact against the plain
versions: no fused multiply-add contraction (`-fmad=false`) and never
`--use_fast_math`. `-Xptxas -v` reports each kernel's registers, shared
memory and spills; `build_report()` returns those lines.

A failed build raises; nothing falls back to the plain versions. Nothing is
compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels_torch")
LIB_NAME = "libktpu_kernels.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# entry points of the C interface: each takes (const <Args>*, cudaStream_t)
# and returns the cudaError_t of its launch
ENTRY_POINTS = (
    "ktpu_filter_mask", "ktpu_score_matrix", "ktpu_solve",
    "ktpu_match_terms", "ktpu_spread_score", "ktpu_selector_spread_score",
    "ktpu_interpod_filter", "ktpu_interpod_score", "ktpu_inbatch_port_conflict",
    "ktpu_spread_filter", "ktpu_arbitrate", "ktpu_fold_commit_banks",
    "ktpu_preempt_batch", "ktpu_fold_usage", "ktpu_gather_score_rows",
    "ktpu_gather_batch", "ktpu_scatter_slab", "ktpu_fold_commit_sharded", "ktpu_fold_usage_sharded",
    # cluster capacity queries of the cluster launches (ktpu_solve,
    # ktpu_arbitrate): (const <Args>*, int* out) -> cudaError_t
    "ktpu_solve_clusters", "ktpu_arbitrate_clusters",
    # (const void* p, int* out) -> cudaError_t: is p pinned host memory the
    # card reaches at the same address (the score-row gather's destination)
    "ktpu_host_pointer",
)

# CTAs of one thread-block cluster: 8 is the portable size, 16 the largest
# Hopper allows (non-portable); csrc/common.cuh's MAX_CLUSTER
MAX_CLUSTER = 16

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_report: Dict[str, object] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _compile(out_dir: str) -> Dict[str, object]:
    """Compile each .cu to an object in parallel, then link one .so into
    `out_dir`. Returns the build report."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    objs = []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = os.path.join(out_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs.append(obj)
    logs = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        text = out.decode(errors="replace")
        logs.append(f"== {os.path.basename(src)}\n{text}")
        if p.returncode != 0:
            failed.append(os.path.basename(src))
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    lib = os.path.join(out_dir, LIB_NAME)
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", *objs, "-o", lib],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    if link.returncode != 0:
        raise KernelBuildError("nvcc link failed:\n" + link.stdout.decode(errors="replace"))
    log = "\n".join(logs)
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write(log)
    return {
        "seconds": time.perf_counter() - t0,
        "ptxas": [ln.strip() for ln in log.splitlines() if "ptxas info" in ln],
    }


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Raises
    KernelBuildError when nvcc is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        final = os.path.join(BUILD_ROOT, source_hash())
        path = os.path.join(final, LIB_NAME)
        if os.path.exists(path):
            _report.update(seconds=0.0, cached=True, ptxas=_read_ptxas(final))
        else:
            os.makedirs(BUILD_ROOT, exist_ok=True)
            tmp = tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-")
            try:
                _report.update(_compile(tmp), cached=False)
                try:
                    os.rename(tmp, final)
                except OSError:
                    if not os.path.exists(path):  # not a lost race: a real failure
                        raise
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
        lib = ctypes.CDLL(path)
        for name in ENTRY_POINTS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _report["path"] = path
        _lib = lib
        return lib


def _read_ptxas(d: str) -> List[str]:
    try:
        with open(os.path.join(d, "ptxas.log")) as f:
            return [ln.strip() for ln in f if "ptxas info" in ln]
    except OSError:
        return []


def build_report() -> Dict[str, object]:
    """{"seconds", "cached", "ptxas", "path"} of the library load."""
    return dict(_report)


def launch(entry: str, args: ctypes.Structure, device: torch.device) -> None:
    """Call one C entry point on PyTorch's current stream of `device`;
    raise KernelLaunchError when the launch reports a CUDA error."""
    fn = getattr(library(), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(ctypes.addressof(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelLaunchError(f"{entry}: CUDA error {rc}")


def cluster_capacity(entry: str, args: ctypes.Structure) -> int:
    """How many thread-block clusters of the launch `args` describes the
    card holds at once (0: it cannot launch one), from the entry's
    `<entry>_clusters` query; raises KernelLaunchError on a CUDA error."""
    fn = getattr(library(), entry + "_clusters")
    out = ctypes.c_int(0)
    rc = fn(ctypes.addressof(args), ctypes.addressof(out))
    if rc != 0:
        raise KernelLaunchError(f"{entry}_clusters: CUDA error {rc}")
    return out.value


_CLUSTERS_OK: Dict[tuple, int] = {}


def check_clusters(entry: str, args: ctypes.Structure, key: tuple) -> None:
    """Refuse a cluster launch of `entry` the card cannot run: more than
    MAX_CLUSTER CTAs (`args.S`), or a cluster it cannot co-schedule
    (cluster_capacity is 0). `key` names what else sizes the launch; the
    query is cached per (entry, S, key)."""
    shards = args.S
    if not 1 <= shards <= MAX_CLUSTER:
        raise ValueError(f"{shards} node shards: the cluster kernels take 1 to {MAX_CLUSTER} (one CTA a shard)")
    full = (entry, shards) + tuple(key)
    got = _CLUSTERS_OK.get(full)
    if got is None:
        got = _CLUSTERS_OK[full] = cluster_capacity(entry, args)
    if got < 1:
        raise RuntimeError(f"{entry}: the card cannot co-schedule a cluster of {shards} CTAs for this launch "
                           f"({key})")


def ptr(t: torch.Tensor, dtype: torch.dtype, shape=None) -> int:
    """Device pointer of a contiguous CUDA tensor of the given dtype (and
    shape, when given). Raises on anything the kernels do not take."""
    if not t.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    return t.data_ptr()
