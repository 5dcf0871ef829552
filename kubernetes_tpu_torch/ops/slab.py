"""Slab row gather and row scatter: the transport kernels of the ingest and
term planes and of the mirror's row patches (csrc/slab.cu).

`gather_batch` rebuilds a batch's array dicts from resident slab dicts and
their lane vectors: every gather problem of the batch (the pod arrays, the
term table) in ONE launch (`ktpu_gather_batch`),

    out[p][k][l] = keep[l] ? slab[p][k][idx[l]] : empty[p][k][0]

with one optional column per problem written over one array (the term
table's `owner`, keep ? owner : 0; the pod arrays' `fallback`, as shipped).
`scatter_batch` patches resident slab dicts in place from host rows: every
patch problem of a call (the mirror's six patches of a sync; a plane's
dirty rows) in ONE launch (`ktpu_scatter_slab`); `scatter_rows` is its
one-problem call.

On CPU tensors both run their plain PyTorch versions (`index_select` +
`where` per array, `index_copy_` per array); on CUDA tensors they launch
the kernels or raise. Every index is checked against the slab's rows on the
host (the reference's jitted `v[idx]` would clamp one out of range; the
driver never builds one). `gather_batch.launches` counts the gather's
launches, `scatter_batch.launches` the scatter's; the planes' one-problem
wrappers (ingest/gather.gather_stage, terms_plane/gather.gather_terms,
scatter_rows) count theirs too.

A gather's launch layout (a `GatherPlan`: the segment table, the buffer
layout, the argument block) is built once per set of slab tensors and lane
counts and cached while those tensors live; a scatter caches only what
does not depend on its rows (a `ScatterLayout`, per set of patched
tensors) and computes its offsets and argument blocks column-wise each
call (`ScatterPlan`). A gather writes the lanes into pinned host memory,
allocates ONE device buffer (lanes and columns first, then every output,
each 16-byte aligned), copies the lanes into its head with
`non_blocking=True`, launches, and returns typed views of the buffer. A
scatter takes the host rows straight into one pinned buffer (ndarray.take
into its views: row vectors first, then every (problem, array)'s rows,
each 16-byte aligned), copies it into one device staging buffer with
`non_blocking=True` and launches. Neither synchronises: the caching
host allocator keeps a pinned block until the copy that reads it ran.
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
MAX_ARRAYS = 64  # SLAB_MAX_ARRAYS in csrc/slab.cu: (problem, array) segments a scatter launch
MAX_SEGMENTS = 64  # GATHER_MAX_SEGMENTS: gathered (problem, array) segments a launch
THREADS = 256  # SLAB_THREADS
CHUNK_BYTES = 4096  # GATHER_CHUNK_BYTES: output (the scatter: staged) bytes a CTA
_ALIGN = 16  # byte alignment of each region of the scatter's staging buffer and the gather's buffer
_INT32_MAX = 2**31 - 1

Arrays = Dict[str, torch.Tensor]


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


class ScatterSeg(ctypes.Structure):
    """Mirror of `struct ScatterSeg` in csrc/slab.cu."""

    _fields_ = [("dst", ctypes.c_void_p), ("src", ctypes.c_int32), ("rows", ctypes.c_int32),
                ("log_word", ctypes.c_int32), ("row_words", ctypes.c_int32), ("n_words", ctypes.c_int32),
                ("step_rows", ctypes.c_int32), ("step_words", ctypes.c_int32), ("pad", ctypes.c_int32)]


class ScatterArgs(ctypes.Structure):
    """Mirror of `struct ScatterArgs` in csrc/slab.cu."""

    _fields_ = [("seg", ScatterSeg * MAX_ARRAYS), ("first_cta", ctypes.c_int32 * MAX_ARRAYS),
                ("base", ctypes.c_void_p), ("n_segments", ctypes.c_int32), ("n_ctas", ctypes.c_int32)]


# ScatterSeg as a numpy record: a call fills its argument blocks column-wise
_SEG_DTYPE = np.dtype([(name, np.uint64 if name == "dst" else np.int32) for name, _ in ScatterSeg._fields_])


class ScatterProblem(NamedTuple):
    """One patch of a scatter launch: rows `rows` ([R] slab rows: ints,
    numpy or a CPU tensor) of the arrays `keys` (None: every array of
    `slab`) of the resident dict `slab` take the same rows of the host
    arrays `host[k]` (host truth, [S', ...] as the mirror's and the planes'
    banks hold it)."""

    slab: Arrays
    rows: object
    host: Dict[str, np.ndarray]
    keys: Optional[Tuple[str, ...]] = None


def scatter_keys(p: ScatterProblem) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """(the [R] int32 slab rows, the patched keys) of one problem, the rows
    checked against the slab's row count; no per-array work."""
    idx = _lane_vector(p.rows, "row", np.int32)
    keys = tuple(p.slab) if p.keys is None else tuple(p.keys)
    if keys:
        check_rows(idx, p.slab[keys[0]].shape[0])
    return idx, keys


def check_slab(p: ScatterProblem, keys: Tuple[str, ...]) -> None:
    """Raise unless every patched slab array has the first's row count and
    device."""
    first = p.slab[keys[0]]
    for k in keys:
        v = p.slab[k]
        if v.shape[0] != first.shape[0] or v.device != first.device:
            raise ValueError(f"slab array {k!r}: {tuple(v.shape)} on {v.device}, {keys[0]!r} "
                             f"{tuple(first.shape)} on {first.device}")


def _check_host(k: str, h: Optional[np.ndarray], tail: tuple, itemsize: int, top: int) -> None:
    """Raise unless the host array `h` of slab array `k` exists with the
    slab array's row shape `tail` and element size, and a row past `top`."""
    if h is None:
        raise ValueError(f"no host rows for slab array {k!r}")
    if h.dtype.itemsize != itemsize:
        raise TypeError(f"host rows {k!r} are {h.dtype}, the slab array's elements {itemsize} bytes")
    if h.shape[1:] != tail:
        raise ValueError(f"host rows {k!r} have shape {h.shape}, expected [S', {', '.join(map(str, tail))}]")
    if top >= h.shape[0]:
        raise IndexError(f"host array {k!r} has {h.shape[0]} rows, row {top} asked")


def check_arrays(p: ScatterProblem, idx: np.ndarray, keys: Tuple[str, ...]) -> None:
    """check_slab, and every host array there with the slab array's row
    shape and element size and a row past every row asked."""
    check_slab(p, keys)
    top = int(idx.max()) if idx.size else -1
    for k in keys:
        v = p.slab[k]
        _check_host(k, p.host.get(k), tuple(v.shape[1:]), v.element_size(), top)


def scatter_lanes(p: ScatterProblem) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """scatter_keys with every array checked (check_arrays)."""
    idx, keys = scatter_keys(p)
    if keys:
        check_arrays(p, idx, keys)
    return idx, keys


def _sharing(problems: Sequence[ScatterProblem], keys) -> List[Tuple[int, ...]]:
    """Groups of two or more problems that patch one array (by storage
    address)."""
    owners: Dict[int, List[int]] = {}
    for j, (p, ks) in enumerate(zip(problems, keys)):
        for k in ks:
            if p.slab[k].numel():
                owners.setdefault(p.slab[k].data_ptr(), []).append(j)
    return sorted({tuple(js) for js in owners.values() if len(js) > 1})


def _check_disjoint(groups: Sequence[Tuple[int, ...]], lanes) -> None:
    for js in groups:
        seen: set = set()
        for j in js:
            rows = set(lanes[j][0].tolist())
            if seen & rows:
                raise ValueError(f"scatter problems {list(js)} write the same row of one slab array")
            seen |= rows


def check_disjoint(problems: Sequence[ScatterProblem], lanes) -> None:
    """Raise when two problems write the same row of one array: the
    launch writes in no order, so only disjoint patches are exact."""
    _check_disjoint(_sharing(problems, [keys for _, keys in lanes]), lanes)


class ScatterLayout:
    """What the scatter keeps of one set of patched slab tensors: per
    (problem, array) segment with row bytes, in order, its problem `prob`,
    key, destination `dst`, row bytes `rb`, word width `lw` (log2: the
    widest word dividing the row bytes and the pointer), words a row `rw`
    and the row shape `tail`; and `sharing`, the groups of problems that
    patch one array; `hosts`, every patched (problem, key) with its row
    shape and element size, for check_hosts. Nothing here depends on a
    call's rows or host arrays; the slab arrays are checked once, here."""

    def __init__(self, problems: Sequence[ScatterProblem], keys: Sequence[Tuple[str, ...]]):
        segs = []
        self.hosts: List[Tuple[int, str, tuple, int]] = []
        for j, (p, ks) in enumerate(zip(problems, keys)):
            if ks:
                check_slab(p, ks)
            for k in ks:
                v = p.slab[k]
                if not v.is_contiguous():
                    raise ValueError(f"slab array {k!r} is not contiguous")
                self.hosts.append((j, k, tuple(v.shape[1:]), v.element_size()))
                rb = row_bytes(v)
                if rb:
                    segs.append((j, k, v.data_ptr(), rb, _log_word(rb | v.data_ptr()), tuple(v.shape[1:])))
        self.keys = [(j, k) for j, k, _, _, _, _ in segs]
        self.tail = [t for _, _, _, _, _, t in segs]
        self.prob = np.array([s[0] for s in segs], np.int64)
        self.dst = np.array([s[2] for s in segs], np.uint64)
        self.rb = np.array([s[3] for s in segs], np.int64)
        self.lw = np.array([s[4] for s in segs], np.int64)
        self.rw = self.rb >> self.lw
        self.sharing = _sharing(problems, keys)
        self.refs: List[weakref.ref] = []  # set by scatter_layout

    def check_hosts(self, problems: Sequence[ScatterProblem], lanes) -> None:
        """check_arrays' host-side checks for a call of this layout."""
        tops = [int(idx.max()) if idx.size else -1 for idx, _ in lanes]
        for j, k, tail, itemsize in self.hosts:
            _check_host(k, problems[j].host.get(k), tail, itemsize, tops[j])


_ARGS_SIZE = ctypes.sizeof(ScatterArgs)
_FIRST_OFF = ScatterArgs.first_cta.offset
_COUNTS_OFF = ScatterArgs.n_segments.offset


def _aligned(n: np.ndarray) -> np.ndarray:
    return -(-n // _ALIGN) * _ALIGN


class ScatterPlan:
    """One scatter call's launch layout, from its ScatterLayout and row
    counts `lens`. The staging buffer holds each problem's [R] int32 row
    vector (at `rows_off`), then every live (problem, array)'s staged rows,
    each region 16-byte aligned; `live` picks the layout's segments with a
    row, `src`, `n_words` and `ctas` are theirs; `args` the argument
    blocks, the fewest launches of at most MAX_ARRAYS segments (`base`
    left 0). Everything is computed column-wise, once a call."""

    def __init__(self, problems: Sequence[ScatterProblem], lens: Sequence[int], keys: Sequence[Tuple[str, ...]],
                 layout: Optional[ScatterLayout] = None):
        lay = layout if layout is not None else ScatterLayout(problems, keys)
        self.layout = lay
        n_p = np.asarray(lens, np.int64).reshape(-1)
        vec = _aligned(4 * n_p)
        self.rows_off = np.cumsum(vec) - vec
        n = n_p[lay.prob]
        self.live = np.flatnonzero(n)
        n, rb, lw, rw = n[self.live], lay.rb[self.live], lay.lw[self.live], lay.rw[self.live]
        self.n = n
        size = _aligned(n * rb)
        self.src = int(vec.sum()) + np.cumsum(size) - size
        self.n_words = n * rw
        chunk_words = CHUNK_BYTES >> lw
        if self.n_words.size and int((self.n_words + chunk_words).max()) > _INT32_MAX:
            raise ValueError("a scatter segment's words exceed the kernel's 32-bit index")
        self.ctas = -(-self.n_words // chunk_words)
        nbytes = int(vec.sum() + size.sum())
        if nbytes > _INT32_MAX:
            raise ValueError(f"a scatter of {nbytes} staged bytes exceeds the kernel's 32-bit offsets")
        self.nbytes = max(nbytes, _ALIGN)
        self.args: List[ScatterArgs] = []
        for start in range(0, self.live.size, MAX_ARRAYS):
            part = slice(start, start + MAX_ARRAYS)
            m = self.n_words[part].size
            blk = np.zeros(_ARGS_SIZE, np.uint8)
            seg = blk[: MAX_ARRAYS * _SEG_DTYPE.itemsize].view(_SEG_DTYPE)[:m]
            seg["dst"] = lay.dst[self.live[part]]
            seg["src"], seg["rows"] = self.src[part], self.rows_off[lay.prob[self.live[part]]]
            seg["log_word"], seg["row_words"], seg["n_words"] = lw[part], rw[part], self.n_words[part]
            seg["step_rows"], seg["step_words"] = np.divmod(THREADS, rw[part])
            ctas = self.ctas[part]
            blk[_FIRST_OFF : _FIRST_OFF + 4 * m].view(np.int32)[:] = np.cumsum(ctas) - ctas
            blk[_COUNTS_OFF : _COUNTS_OFF + 8].view(np.int32)[:] = (m, ctas.sum())
            self.args.append(ScatterArgs.from_buffer(blk))

    @property
    def segments(self) -> List[tuple]:
        """Each live segment as (problem, key, dst, src, rows, log_word,
        row_words, n_words, ctas)."""
        lay = self.layout
        return [(*lay.keys[s], int(lay.dst[s]), int(self.src[i]), int(self.rows_off[lay.prob[s]]),
                 int(lay.lw[s]), int(lay.rw[s]), int(self.n_words[i]), int(self.ctas[i]))
                for i, s in enumerate(self.live)]

    def fill(self, host: np.ndarray, problems: Sequence[ScatterProblem], lanes) -> None:
        """Write the staging buffer (uint8, `nbytes` long): each problem's
        row vector, then its rows taken from host truth straight into the
        buffer (ndarray.take into a view; no intermediate array)."""
        for (idx, _), off in zip(lanes, self.rows_off.tolist()):
            host[off : off + 4 * idx.shape[0]].view(np.int32)[:] = idx
        lay = self.layout
        for s, off, n in zip(self.live.tolist(), self.src.tolist(), self.n.tolist()):
            j, k = lay.keys[s]
            h = problems[j].host[k]
            view = np.ndarray((n,) + lay.tail[s], h.dtype, host, off)
            h.take(lanes[j][0], 0, view, "clip")  # rows checked: no buffering


_SCATTER_LAYOUTS: Dict[tuple, ScatterLayout] = {}


def scatter_layout(problems: Sequence[ScatterProblem], keys: Sequence[Tuple[str, ...]]) -> ScatterLayout:
    """The cached ScatterLayout of `problems`' patched tensors: keyed by
    the keys and the identity of every patched slab tensor, whatever the
    rows (a mirror's or a bank's one key while its tensors live), dropped
    when any of those tensors is freed (as gather_plan). A miss is counted
    in `scatter_batch.layout_misses`, a hit in `scatter_batch.layout_hits`."""
    key = tuple((ks, tuple(id(p.slab[k]) for k in ks)) for p, ks in zip(problems, keys))
    lay = _SCATTER_LAYOUTS.get(key)
    if lay is not None:
        scatter_batch.layout_hits += 1
        return lay
    scatter_batch.layout_misses += 1
    lay = ScatterLayout(problems, keys)
    drop = lambda _ref, key=key, layouts=_SCATTER_LAYOUTS: layouts.pop(key, None)  # noqa: E731
    lay.refs = [weakref.ref(p.slab[k], drop) for p, ks in zip(problems, keys) for k in ks]
    if len(_SCATTER_LAYOUTS) >= _MAX_PLANS:
        _SCATTER_LAYOUTS.pop(next(iter(_SCATTER_LAYOUTS)))
    _SCATTER_LAYOUTS[key] = lay
    return lay


def scatter_batch(problems: Sequence[ScatterProblem]) -> None:
    """Patch every problem's rows into its resident slab arrays from host
    truth, in place. Refuses two problems writing one (array, row). CPU
    slabs run `scatter_rows_plain` per problem; CUDA slabs (every problem
    on one card) take the rows into one pinned buffer, one copy of it with
    `non_blocking=True` (no synchronisation: the caching host allocator
    keeps a pinned block until the copy that reads it ran) and ONE launch
    of csrc/slab.cu's scatter for all of them (counted in
    `scatter_batch.launches`; a call past MAX_ARRAYS segments takes the
    fewest launches, the ones beyond the first counted in
    `scatter_batch.split_launches`). No dirty row, no launch."""
    lanes = [scatter_keys(p) for p in problems]
    live = [j for j, (idx, keys) in enumerate(lanes) if idx.size and keys]
    devs = {problems[j].slab[lanes[j][1][0]].device for j in live}
    if devs <= {torch.device("cpu")}:
        for p, (idx, keys) in zip(problems, lanes):
            if keys:
                check_arrays(p, idx, keys)
        check_disjoint(problems, lanes)
        for j in live:
            (idx, keys), p = lanes[j], problems[j]
            rows = {k: np.take(p.host[k], idx, axis=0) for k in keys}
            scatter_rows_plain(p.slab, torch.from_numpy(idx), arrays_to_torch(rows, "cpu"))
        return
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"no slab scatter kernel for devices {sorted(map(str, devs))}")
    dev = next(iter(devs))
    layout = scatter_layout(problems, [keys for _, keys in lanes])
    layout.check_hosts(problems, lanes)
    _check_disjoint(layout.sharing, lanes)
    plan = ScatterPlan(problems, [idx.shape[0] for idx, _ in lanes], None, layout)
    if not plan.args:
        return
    pinned = torch.empty(plan.nbytes, dtype=torch.uint8, pin_memory=True)
    plan.fill(pinned.numpy(), problems, lanes)
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    if buf.data_ptr() % _ALIGN:
        raise ValueError("the staging buffer is not 16-byte aligned")
    buf.copy_(pinned, non_blocking=True)
    for i, args in enumerate(plan.args):
        args.base = buf.data_ptr()
        build.launch(SCATTER_ENTRY, args, dev)
        scatter_batch.launches += 1
        scatter_batch.split_launches += i > 0


scatter_batch.launches = 0
scatter_batch.split_launches = 0
scatter_batch.layout_hits = 0
scatter_batch.layout_misses = 0


def scatter_rows(slab: Arrays, rows, host: Dict[str, np.ndarray]) -> None:
    """One problem of `scatter_batch`: rows `rows` of every array of the
    resident slab dict take the same rows of the host arrays `host` (host
    truth). Its launches are counted in `scatter_rows.launches` too."""
    before = scatter_batch.launches
    scatter_batch([ScatterProblem(slab, rows, host)])
    scatter_rows.launches += scatter_batch.launches - before


scatter_rows.launches = 0
