"""Slab row gather and row scatter: the transport kernels of the ingest and
term planes (csrc/slab.cu).

`gather_batch` rebuilds a batch's array dicts from resident slab dicts and
their lane vectors: every gather problem of the batch (the pod arrays, the
term table) in ONE launch (`ktpu_gather_batch`),

    out[p][k][l] = keep[l] ? slab[p][k][idx[l]] : empty[p][k][0]

with one optional column per problem written over one array (the term
table's `owner`, keep ? owner : 0; the pod arrays' `fallback`, as shipped).
`scatter_rows` patches a slab dict in place from dirty host rows, again one
launch (`ktpu_scatter_slab`), after one host→device copy of the rows packed
into a single buffer.

On CPU tensors both run their plain PyTorch versions (`index_select` +
`where` per array, `index_copy_` per array); on CUDA tensors they launch
the kernels or raise. Every index is checked against the slab's rows on the
host (the reference's jitted `v[idx]` would clamp one out of range; the
driver never builds one). `gather_batch.launches` counts the gather's
launches, `scatter_rows.launches` the scatter's; the planes' one-problem
wrappers (ingest/gather.gather_stage, terms_plane/gather.gather_terms)
count theirs too.

The gather's host side does no per-array work a call: its launch layout (a
`GatherPlan`: the segment table, the buffer layout, the argument block) is
built once per set of slab tensors and lane counts and cached while those
tensors live. A call writes the lanes into pinned host memory, allocates
ONE device buffer (lanes and columns first, then every output, each 16-byte
aligned), copies the lanes into its head with `non_blocking=True` (no
stream synchronisation: the caching host allocator keeps the pinned block
until the copy ran), launches, and returns typed views of the buffer.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build
from ..state.convert import arrays_to_torch

GATHER_ENTRY = "ktpu_gather_batch"
SCATTER_ENTRY = "ktpu_scatter_slab"
MAX_ARRAYS = 48  # SLAB_MAX_ARRAYS in csrc/slab.cu (the scatter's table)
MAX_SEGMENTS = 64  # GATHER_MAX_SEGMENTS: gathered (problem, array) segments a launch
THREADS = 256  # SLAB_THREADS
CHUNK_BYTES = 4096  # GATHER_CHUNK_BYTES: output bytes a CTA of the gather
_ALIGN = 16  # byte alignment of each segment in the packed scatter rows and the gather's buffer
_INT32_MAX = 2**31 - 1

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


class GatherSeg(ctypes.Structure):
    """Mirror of `struct GatherSeg` in csrc/slab.cu."""

    _fields_ = [("src", ctypes.c_void_p), ("empty", ctypes.c_void_p), ("dst", ctypes.c_int32),
                ("rows", ctypes.c_int32), ("log_word", ctypes.c_int32), ("row_words", ctypes.c_int32),
                ("n_words", ctypes.c_int32), ("step_rows", ctypes.c_int32), ("step_words", ctypes.c_int32),
                ("pad", ctypes.c_int32)]


class GatherBatchArgs(ctypes.Structure):
    """Mirror of `struct GatherBatchArgs` in csrc/slab.cu."""

    _fields_ = [("seg", GatherSeg * MAX_SEGMENTS), ("first_cta", ctypes.c_int32 * MAX_SEGMENTS),
                ("base", ctypes.c_void_p), ("n_segments", ctypes.c_int32), ("n_ctas", ctypes.c_int32)]


class GatherProblem(NamedTuple):
    """One slab gather of a batch. `slab` the resident [S, ...] dict, `empty`
    its one-row padding dict; `idx` ([L] int32 slab rows), `keep` ([L] bool)
    and `col` ([L] int32) host vectors (numpy or CPU tensors). The column,
    when `col_key` names a 1-D slab array, is written over that array:
    keep ? col : 0 (`col_masked`) or col as given."""

    slab: Arrays
    empty: Arrays
    idx: object
    keep: object
    col: object = None
    col_key: Optional[str] = None
    col_masked: bool = True


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


def host_lanes(p: GatherProblem) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(idx, keep, the column's final values or None) of one problem, checked:
    1-D vectors of one length, every index inside the slab."""
    idx = _lane_vector(p.idx, "index", np.int32)
    keep = _lane_vector(p.keep, "keep", bool)
    if keep.shape != idx.shape:
        raise ValueError(f"keep has shape {keep.shape}, the index {idx.shape}")
    col = None
    if p.col_key is not None:
        col = _lane_vector(p.col, "column", np.int32)
        if col.shape != idx.shape:
            raise ValueError(f"the column has shape {col.shape}, the index {idx.shape}")
        if p.col_masked:
            col = np.where(keep, col, 0).astype(np.int32)
    check_rows(idx, next(iter(p.slab.values())).shape[0])
    return idx, keep, col


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _log_word(bits: int) -> int:
    """log2 of the widest word (16, 8, 4, 2 or 1 bytes) dividing `bits`."""
    for lw in (4, 3, 2, 1):
        if bits % (1 << lw) == 0:
            return lw
    return 0


class GatherPlan:
    """The launch layout of one batch gather for fixed slab tensors and lane
    counts. The batch buffer holds, in order: each problem's lane rows ([L]
    int32, keep folded in: -1 for padding) and column bytes (the host
    region, copied from pinned memory), then every gathered output grouped
    by dtype, each segment 16-byte aligned. `segments` lists each gathered
    (problem, array) with bytes (problem, key, src, empty, dst, rows,
    log_word, row_words, n_words, first_cta, ctas); `n_ctas` sums their CTAs
    (CHUNK_BYTES of output each). Views are cut by `views_of` ((dtype,
    [(element offset, shape, strides)]) per dtype) and returned per problem
    in slab order (`order`)."""

    def __init__(self, problems: Sequence[GatherProblem], lens: Sequence[int]):
        for p in problems:
            _check_problem(p)
        off = 0
        rows_off = []
        for n in lens:
            rows_off.append(off)
            off = _align(off + 4 * n)
        # (rows offset, column offset or None, L, the column's numpy dtype)
        self.lanes: List[Tuple[int, Optional[int], int, Optional[np.dtype]]] = []
        views_of: Dict[torch.dtype, List[Tuple[int, tuple, tuple]]] = {}
        placed: Dict[Tuple[int, str], Tuple[torch.dtype, int]] = {}

        def place(j, k, v, n, at):
            """Output (j, k), [n, ...] of v's dtype, at byte `at`."""
            shape = (n,) + tuple(v.shape[1:])
            strides = tuple(int(np.prod(shape[i + 1:], dtype=np.int64)) for i in range(len(shape)))
            group = views_of.setdefault(v.dtype, [])
            placed[(j, k)] = (v.dtype, len(group))
            group.append((at // v.element_size(), shape, strides))

        for j, (p, n) in enumerate(zip(problems, lens)):
            if p.col_key is None:
                self.lanes.append((rows_off[j], None, n, None))
                continue
            v = p.slab[p.col_key]
            self.lanes.append((rows_off[j], off, n, torch.empty(0, dtype=v.dtype).numpy().dtype))
            place(j, p.col_key, v, n, off)
            off = _align(off + n * v.element_size())
        self.host_bytes = off
        by_dtype: Dict[torch.dtype, List[Tuple[int, str, int]]] = {}
        for j, (p, n) in enumerate(zip(problems, lens)):
            for k, v in p.slab.items():
                if k != p.col_key:
                    by_dtype.setdefault(v.dtype, []).append((j, k, n))
        self.segments: List[tuple] = []
        self.n_ctas = 0
        for entries in by_dtype.values():
            for j, k, n in entries:
                p = problems[j]
                v, e = p.slab[k], p.empty[k]
                rb = row_bytes(v)
                nbytes = n * rb
                if nbytes:
                    lw = _log_word(rb | v.data_ptr() | e.data_ptr() | off)
                    rw = rb >> lw
                    n_words = n * rw
                    chunk = CHUNK_BYTES >> lw
                    if n_words + chunk > _INT32_MAX:
                        raise ValueError(f"slab array {k!r}: {n} lanes of {rb} bytes exceed the gather's 32-bit index")
                    ctas = -(-n_words // chunk)
                    self.segments.append((j, k, v.data_ptr(), e.data_ptr(), off, rows_off[j], lw, rw, n_words,
                                          self.n_ctas, ctas))
                    self.n_ctas += ctas
                place(j, k, v, n, off)
                off += _align(nbytes)
        if off > _INT32_MAX:
            raise ValueError(f"a batch gather of {off} bytes exceeds the kernel's 32-bit offsets")
        if len(self.segments) > MAX_SEGMENTS:
            raise ValueError(f"{len(self.segments)} gathered arrays, the kernel takes at most {MAX_SEGMENTS}")
        self.nbytes = max(off, _ALIGN)
        self.views_of = list(views_of.items())
        # each problem's outputs in slab order: (key, dtype group, index in it)
        ranks = {dt: i for i, dt in enumerate(views_of)}
        self.order = [[(k, ranks[placed[(j, k)][0]], placed[(j, k)][1]) for k in p.slab]
                      for j, p in enumerate(problems)]
        # the kernel's argument block, `base` left 0 (set per call)
        self.args = GatherBatchArgs()
        for i, (_, _, src, empty, dst, rows, lw, rw, n_words, first, _) in enumerate(self.segments):
            s = self.args.seg[i]
            s.src, s.empty, s.dst, s.rows = src, empty, dst, rows
            s.log_word, s.row_words, s.n_words = lw, rw, n_words
            s.step_rows, s.step_words = divmod(THREADS, rw)
            self.args.first_cta[i] = first
        self.args.n_segments, self.args.n_ctas = len(self.segments), self.n_ctas
        self.refs: List[weakref.ref] = []  # set by gather_plan

    def fill(self, host: np.ndarray, lanes) -> None:
        """Write the host region (uint8, `host_bytes` long) from each
        problem's host_lanes: rows = keep ? idx : -1, the column's final
        values in its array's dtype."""
        for (idx, keep, col), (roff, coff, n, cdt) in zip(lanes, self.lanes):
            host[roff : roff + 4 * n].view(np.int32)[:] = np.where(keep, idx, -1)
            if coff is not None:
                host[coff : coff + n * cdt.itemsize].view(cdt)[:] = col.astype(cdt)

    def views(self, buf: torch.Tensor) -> List[Arrays]:
        """Each problem's output dict, contiguous typed views of the batch
        buffer (one strided view an array)."""
        groups = []
        for dtype, entries in self.views_of:
            typed = buf.view(dtype)
            groups.append([typed.as_strided(shape, strides, at) for at, shape, strides in entries])
        return [{k: groups[g][i] for k, g, i in order} for order in self.order]


_PLANS: Dict[tuple, GatherPlan] = {}
_MAX_PLANS = 32


def _check_problem(p: GatherProblem) -> None:
    """Raise on a slab dict the kernel does not take: every array and its
    padding row contiguous, of one dtype, on one device, with one row
    count; the column a 1-D slab array."""
    first = next(iter(p.slab.values()))
    for k, v in p.slab.items():
        e = p.empty.get(k)
        if e is None:
            raise ValueError(f"the padding dict has no array {k!r}")
        if v.device != first.device or e.device != first.device or v.shape[0] != first.shape[0]:
            raise ValueError(f"slab array {k!r}: {tuple(v.shape)} on {v.device}, the slab's first array "
                             f"{tuple(first.shape)} on {first.device}")
        if e.dtype != v.dtype or tuple(e.shape) != (1,) + tuple(v.shape[1:]):
            raise ValueError(f"padding row {k!r}: {e.dtype} {tuple(e.shape)} for a {v.dtype} {tuple(v.shape)} array")
        if not (v.is_contiguous() and e.is_contiguous()):
            raise ValueError(f"slab array {k!r} or its padding row is not contiguous")
    if p.col_key is not None and (p.col_key not in p.slab or p.slab[p.col_key].ndim != 1):
        raise ValueError(f"override column {p.col_key!r} must be a 1-D slab array")


def _plan_key(problems: Sequence[GatherProblem], lens: Sequence[int]) -> tuple:
    return tuple((tuple(p.slab), tuple(map(id, p.slab.values())), tuple(map(id, p.empty.values())), n, p.col_key)
                 for p, n in zip(problems, lens))


def gather_plan(problems: Sequence[GatherProblem], lens: Sequence[int]) -> GatherPlan:
    """The cached GatherPlan of `problems` at lane counts `lens`: keyed by
    the identity of every slab and padding tensor (the plan drops itself
    from the cache when any of them is freed, so an identity is never
    reused while cached), the lane counts and the column keys. The plan
    assumes a tensor's storage does not move (the twins never resize in
    place)."""
    key = _plan_key(problems, lens)
    plan = _PLANS.get(key)
    if plan is None:
        plan = GatherPlan(problems, lens)
        drop = lambda _ref, key=key, plans=_PLANS: plans.pop(key, None)  # noqa: E731
        plan.refs = [weakref.ref(t, drop) for p in problems for d in (p.slab, p.empty) for t in d.values()]
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = plan
    return plan


def gather_batch(problems: Sequence[GatherProblem]) -> List[Arrays]:
    """Each problem's gathered [L, ...] dict, on its slab's device. CPU
    slabs run `gather_slab_plain` and write the column with `where`; CUDA
    slabs (every problem on one card) launch csrc/slab.cu's batch gather
    ONCE for all of them (counted in `gather_batch.launches`; no launch
    when no output has a byte), after one non-blocking copy of the lanes."""
    lanes = [host_lanes(p) for p in problems]
    devs = {next(iter(p.slab.values())).device for p in problems}
    if devs <= {torch.device("cpu")}:
        out = []
        for p, (idx, keep, col) in zip(problems, lanes):
            o = gather_slab_plain(p.slab, torch.from_numpy(idx), torch.from_numpy(keep), p.empty)
            if col is not None:
                o[p.col_key] = torch.from_numpy(col).to(p.slab[p.col_key].dtype)
            out.append(o)
        return out
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"no slab gather kernel for devices {sorted(map(str, devs))}")
    dev = next(iter(devs))
    plan = gather_plan(problems, [idx.shape[0] for idx, _, _ in lanes])
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    if plan.host_bytes:
        pinned = torch.empty(plan.host_bytes, dtype=torch.uint8, pin_memory=True)
        plan.fill(pinned.numpy(), lanes)
        buf[: plan.host_bytes].copy_(pinned, non_blocking=True)
    if plan.n_ctas:
        args = GatherBatchArgs.from_buffer_copy(plan.args)
        args.base = buf.data_ptr()
        if args.base % _ALIGN:
            raise ValueError("the batch buffer is not 16-byte aligned")
        build.launch(GATHER_ENTRY, args, dev)
        gather_batch.launches += 1
    return plan.views(buf)


gather_batch.launches = 0


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
