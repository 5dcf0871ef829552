"""Slab row gather and row scatter: the transport kernels of the ingest and
term planes (csrc/slab.cu).

`gather_slab` rebuilds a batch's array dict from a resident slab dict and
an index vector, in ONE launch for the whole dict (`ktpu_gather_slab`):

    out[k][l] = keep[l] ? slab[k][idx[l]] : empty[k][0]

with one optional int32 column written over one array (the term table's
`owner`, the pod arrays' `fallback`). `scatter_rows` patches a slab dict in
place from dirty host rows, again one launch (`ktpu_scatter_slab`), after
one host→device copy of the rows packed into a single buffer.

On CPU tensors both run their plain PyTorch versions (`index_select` +
`where` per array, `index_copy_` per array); on CUDA tensors they launch
the kernels or raise. Every index is checked against the slab's rows on the
host (the reference's jitted `v[idx]` would clamp one out of range; the
driver never builds one). The planes' wrappers (ingest/gather.gather_stage,
terms_plane/gather.gather_terms) count their launches; `scatter_rows`
counts its own.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..kernels import build
from ..state.convert import arrays_to_torch

GATHER_ENTRY = "ktpu_gather_slab"
SCATTER_ENTRY = "ktpu_scatter_slab"
MAX_ARRAYS = 48  # SLAB_MAX_ARRAYS in csrc/slab.cu
_ALIGN = 16  # byte alignment of each array's segment in the packed scatter buffer

Arrays = Dict[str, torch.Tensor]


class SlabArray(ctypes.Structure):
    """Mirror of `struct SlabArray` in csrc/slab.cu."""

    _fields_ = [("src", ctypes.c_void_p), ("empty", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row_bytes", ctypes.c_int64)]


class SlabArgs(ctypes.Structure):
    """Mirror of `struct SlabArgs` in csrc/slab.cu."""

    _fields_ = [("a", SlabArray * MAX_ARRAYS), ("idx", ctypes.c_void_p), ("keep", ctypes.c_void_p),
                ("col", ctypes.c_void_p), ("col_array", ctypes.c_int32), ("col_masked", ctypes.c_int32),
                ("n_arrays", ctypes.c_int32), ("L", ctypes.c_int32)]


def row_bytes(t: torch.Tensor) -> int:
    """Bytes of one row (the first axis) of a contiguous tensor."""
    return int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()


def _lane_vector(v, name: str, dtype) -> np.ndarray:
    a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).astype(dtype, copy=False)
    if a.ndim != 1:
        raise ValueError(f"expected a 1-D {name} vector, got shape {a.shape}")
    return a


def check_rows(idx: np.ndarray, s: int) -> None:
    """Every slab row index in [0, s), or IndexError."""
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= s):
        raise IndexError(f"slab row index out of range [0, {s}): min {int(idx.min())}, max {int(idx.max())}")


def gather_slab_plain(slab: Arrays, idx: torch.Tensor, keep: torch.Tensor, empty: Arrays) -> Arrays:
    """out[k] = where(keep, slab[k][idx], empty[k]) per array, on the slab's
    device (idx int32 or int64, keep bool, both [L] on that device)."""
    il = idx.long()
    out = {}
    for k, v in slab.items():
        g = v.index_select(0, il)
        cond = keep.reshape((-1,) + (1,) * (g.ndim - 1))
        out[k] = torch.where(cond, g, empty[k])
    return out


def gather_args(slab: Arrays, empty: Arrays, out: Arrays, lanes: torch.Tensor, col_key: Optional[str],
                col_masked: bool) -> SlabArgs:
    """The gather kernel's argument struct. `lanes` is the [3, L] int32 CUDA
    tensor of (idx, keep, column); `out` the [L, ...] outputs, one per slab
    array. Raises on a device, dtype, shape or layout the kernel does not
    take."""
    keys = list(slab)
    if len(keys) > MAX_ARRAYS:
        raise ValueError(f"{len(keys)} slab arrays, the kernel takes at most {MAX_ARRAYS}")
    n_lanes = lanes.shape[1]
    a = SlabArgs()
    for j, k in enumerate(keys):
        v, e, o = slab[k], empty[k], out[k]
        rb = row_bytes(v)
        a.a[j].src = build.ptr(v, v.dtype)
        a.a[j].empty = build.ptr(e, v.dtype, (1,) + tuple(v.shape[1:]))
        a.a[j].dst = build.ptr(o, v.dtype, (n_lanes,) + tuple(v.shape[1:]))
        a.a[j].row_bytes = rb
    build.ptr(lanes, torch.int32, (3, n_lanes))
    base = lanes.data_ptr()
    a.idx, a.keep = base, base + 4 * n_lanes
    a.col_array = -1
    a.col_masked = int(col_masked)
    if col_key is not None:
        j = keys.index(col_key)
        if row_bytes(slab[col_key]) not in (1, 4) or slab[col_key].ndim != 1:
            raise ValueError(f"override column {col_key!r} must be a 1-D array of 1- or 4-byte rows")
        a.col = base + 8 * n_lanes
        a.col_array = j
    a.n_arrays = len(keys)
    a.L = n_lanes
    return a


def gather_slab(slab: Arrays, idx, keep, empty: Arrays, col=None, col_key: Optional[str] = None,
                col_masked: bool = True):
    """(the gathered [L, ...] dict, whether a kernel was launched). `idx`,
    `keep` and `col` are host vectors ([L] int32 / bool / int32, numpy or
    CPU tensors). CPU slabs run `gather_slab_plain` and write the column
    with `where`; CUDA slabs launch csrc/slab.cu once."""
    idx_np = _lane_vector(idx, "index", np.int32)
    keep_np = _lane_vector(keep, "keep", bool)
    if keep_np.shape != idx_np.shape:
        raise ValueError(f"keep has shape {keep_np.shape}, the index {idx_np.shape}")
    col_np = None
    if col_key is not None:
        col_np = _lane_vector(col, "column", np.int32)
        if col_np.shape != idx_np.shape:
            raise ValueError(f"the column has shape {col_np.shape}, the index {idx_np.shape}")
    first = next(iter(slab.values()))
    check_rows(idx_np, first.shape[0])
    dev = first.device
    if dev.type == "cpu":
        out = gather_slab_plain(slab, torch.from_numpy(idx_np), torch.from_numpy(keep_np), empty)
        if col_key is not None:
            c = torch.from_numpy(col_np)
            v = torch.where(torch.from_numpy(keep_np), c, 0) if col_masked else c
            out[col_key] = v.to(slab[col_key].dtype)
        return out, False
    if dev.type != "cuda":
        raise ValueError(f"no slab gather kernel for device {dev}")
    n = idx_np.shape[0]
    out = {k: torch.empty((n,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev) for k, v in slab.items()}
    if n == 0:
        return out, False
    host = np.zeros((3, n), np.int32)
    host[0], host[1] = idx_np, keep_np
    if col_np is not None:
        host[2] = col_np
    lanes = torch.from_numpy(host).to(dev)
    build.launch(GATHER_ENTRY, gather_args(slab, empty, out, lanes, col_key, col_masked), dev)
    return out, True


def scatter_rows_plain(slab: Arrays, idx: torch.Tensor, updates: Arrays) -> None:
    """slab[k][idx] = updates[k] per array, in place (index_copy_)."""
    il = idx.long()
    for k, u in updates.items():
        slab[k].index_copy_(0, il, u)


def pack_rows(slab: Arrays, updates: Dict[str, np.ndarray]):
    """One host uint8 buffer holding every array's staged rows (each
    segment 16-byte aligned) and their byte offsets, in slab order."""
    offs, total = [], 0
    blobs = []
    for k in slab:
        b = np.ascontiguousarray(updates[k]).view(np.uint8).reshape(-1)
        offs.append(total)
        blobs.append(b)
        total += -(-b.size // _ALIGN) * _ALIGN
    buf = np.zeros(max(total, _ALIGN), np.uint8)
    for o, b in zip(offs, blobs):
        buf[o : o + b.size] = b
    return buf, offs


def scatter_args(slab: Arrays, packed: torch.Tensor, offs: Sequence[int], idx: torch.Tensor, n_rows: int) -> SlabArgs:
    """The scatter kernel's argument struct: `packed` the uint8 CUDA buffer
    of pack_rows, `idx` the [R] int32 CUDA row vector."""
    keys = list(slab)
    if len(keys) > MAX_ARRAYS:
        raise ValueError(f"{len(keys)} slab arrays, the kernel takes at most {MAX_ARRAYS}")
    a = SlabArgs()
    base = build.ptr(packed, torch.uint8)
    for j, k in enumerate(keys):
        v = slab[k]
        a.a[j].src = base + offs[j]
        a.a[j].dst = build.ptr(v, v.dtype)
        a.a[j].row_bytes = row_bytes(v)
    a.idx = build.ptr(idx, torch.int32, (n_rows,))
    a.col_array = -1
    a.n_arrays = len(keys)
    a.L = n_rows
    return a


def scatter_rows(slab: Arrays, rows, updates: Dict[str, np.ndarray]) -> None:
    """Write the host rows `updates[k]` ([R, ...] each, numpy) into rows
    `rows` of every array of the resident slab dict, in place. CPU slabs
    run `scatter_rows_plain`; CUDA slabs take one host→device copy of the
    packed rows and one launch of csrc/slab.cu (counted in
    `scatter_rows.launches`). No dirty row, no launch."""
    idx_np = _lane_vector(rows, "row", np.int32)
    if set(updates) != set(slab):
        raise ValueError(f"updates name {sorted(updates)}, the slab {sorted(slab)}")
    first = next(iter(slab.values()))
    check_rows(idx_np, first.shape[0])
    for k, u in updates.items():
        if np.dtype(u.dtype).itemsize != slab[k].element_size():
            raise TypeError(f"updates[{k!r}] is {u.dtype}, the slab array {slab[k].dtype}")
        if u.shape != (idx_np.shape[0],) + tuple(slab[k].shape[1:]):
            raise ValueError(f"updates[{k!r}] has shape {u.shape}, expected "
                             f"{(idx_np.shape[0],) + tuple(slab[k].shape[1:])}")
    if idx_np.size == 0:
        return
    dev = first.device
    if dev.type == "cpu":
        scatter_rows_plain(slab, torch.from_numpy(idx_np), arrays_to_torch(updates, "cpu"))
        return
    if dev.type != "cuda":
        raise ValueError(f"no slab scatter kernel for device {dev}")
    buf, offs = pack_rows(slab, updates)
    packed = torch.from_numpy(buf).to(dev)
    idx_d = torch.from_numpy(idx_np).to(dev)
    build.launch(SCATTER_ENTRY, scatter_args(slab, packed, offs, idx_d, idx_np.shape[0]), dev)
    scatter_rows.launches += 1


scatter_rows.launches = 0
