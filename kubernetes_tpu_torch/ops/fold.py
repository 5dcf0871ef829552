"""Resident-state fold: a committed batch's deltas scattered into the
device banks in place.

Port of `kubernetes_tpu/ops/fold.py:44 fold_commit_banks`. The mirror's
patch path re-ships every dirty row from the host after a commit; but the
host applies those same deltas as integer adds (NodeBank
.apply_pod_deltas_bulk, SigBank.apply_adds_bulk, PatternBank.apply_delta),
a function of small control arrays the driver already has at commit time
(commit/fold.plan_fold). The fold runs that function on the device: per
commit lane its request vector, non-zero scoring request and pod count
into the node row, one count into its (node, signature) cell, and per
pattern triple one count into its (node, pattern) cell. Padding lanes carry
out-of-range sentinel indices (row N, signature S, pattern PT) and are
dropped, as the reference's mode="drop" scatters drop them.

There is no buffer donation in torch: both versions write into the bank
tensors they are given, so the mirror's resident storages are updated in
place. Integer adds commute, so the result is exact in any order; the
int16 counts wrap as two's complement, like the reference's `.astype` +
add.

On CUDA tensors `fold_commit_banks` launches `csrc/fold.cu` (counted in
`fold_commit_banks.launches`); on CPU tensors it runs the plain version.
Any other device raises. The kernel runs one thread a bank element (a
lane's column, pod count or signature cell, a pattern triple), int16 cells
by one 32-bit atomic add with a carry correction (csrc/fold.cu).

The main path (`TensorMirror.fold_commit`) does not upload the program
array by array: `fold_control` packs the program's LIVE lanes and triples
into one host buffer (pinned on the card's path) at 16-byte-aligned
offsets, and `fold_commit_packed` moves it with one non-blocking copy into
one device buffer and launches on its base pointer plus those offsets —
no blocking copy, no allocation per array, no padding over the bus or in
the grid. The pinned block outlives the copy: PyTorch's caching host
allocator keeps it until the copy that reads it has run.

`fold_usage` is the port of `kubernetes_tpu/ops/fold.py:74`: the usage
columns alone (`requested[rows] += vecs; pod_count[rows] += cnt`, mode
"drop"), which the driver uses to overlay the out-of-batch preemption
nominees onto the node bank at dispatch and to take the overlay off again
with negated vecs and counts (integer adds invert exactly). Several
nominees on one node give duplicate rows, so its kernel (`csrc/fold.cu`,
counted apart in `fold_usage.launches`) adds with integer atomics. The
same call on a clone of the columns is the reference's copy overlay
(`scheduler/driver.py:404 _nominee_fold_fn`).

`make_sharded_fold_fns(mesh)` is the port of `kubernetes_tpu/ops/fold.py:96`:
the (commit, usage) pair for banks split over the mesh's S node shards of
Nl rows each (rows [s * Nl, (s + 1) * Nl) of the one tensor). The control
arrays are replicated; each shard rebases the global rows onto its own and
drops foreign lanes, so no collective is needed. `fold_commit_sharded` and
`fold_usage_sharded` write that shard axis out (their plain versions loop
over the shards' row views); on CUDA tensors one launch covers every
shard (counted in their `.launches`). On one card the shards are row
ranges of one bank, so the sharded commit is the single fold's launch: a
row in [0, N) lies in exactly one shard and adds at the same address, and
any other row belongs to no shard and adds nothing.
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels import build
from ..parallel.mesh import node_shards, shard_rows

FOLD_ENTRY = "ktpu_fold_commit_banks"
FOLD_USAGE_ENTRY = "ktpu_fold_usage"
FOLD_USAGE_SHARDED_ENTRY = "ktpu_fold_usage_sharded"


def fold_commit_banks_plain(
    requested: torch.Tensor,    # [N, R] int64, updated in place
    nonzero_req: torch.Tensor,  # [N, 2] int64, updated in place
    pod_count: torch.Tensor,    # [N] int32, updated in place
    sig_counts: torch.Tensor,   # [N, S] int16, updated in place
    pat_counts: torch.Tensor,   # [N, PT] int16, updated in place
    rows: torch.Tensor,         # [B] int32 node row per commit (N = pad)
    req: torch.Tensor,          # [B, R] int64
    nz: torch.Tensor,           # [B, 2] int64
    cnt: torch.Tensor,          # [B] int32 (1 per commit, 0 pad)
    sig: torch.Tensor,          # [B] int32 signature row (S = pad)
    pat_row: torch.Tensor,      # [T] int32 node row per pattern instance (N = pad)
    pat_col: torch.Tensor,      # [T] int32 pattern row (PT = pad)
    pat_cnt: torch.Tensor,      # [T] int16
):
    """The reference's five scatter-adds with mode="drop": a lane whose
    index is out of range adds nothing. Returns the five banks (the same
    tensors, updated)."""
    n = requested.shape[0]
    s = sig_counts.shape[1]
    pt = pat_counts.shape[1]
    live = (rows >= 0) & (rows < n)
    r = rows[live].long()
    requested.index_put_((r,), req[live].to(requested.dtype), accumulate=True)
    nonzero_req.index_put_((r,), nz[live].to(nonzero_req.dtype), accumulate=True)
    pod_count.index_put_((r,), cnt[live].to(pod_count.dtype), accumulate=True)
    live_s = live & (sig >= 0) & (sig < s)
    _add_i16(sig_counts, rows[live_s].long(), sig[live_s].long(), cnt[live_s])
    live_p = (pat_row >= 0) & (pat_row < n) & (pat_col >= 0) & (pat_col < pt)
    _add_i16(pat_counts, pat_row[live_p].long(), pat_col[live_p].long(), pat_cnt[live_p])
    return requested, nonzero_req, pod_count, sig_counts, pat_counts


def _add_i16(table: torch.Tensor, i: torch.Tensor, j: torch.Tensor, v: torch.Tensor) -> None:
    """table[i, j] += v on an int16 table, wrapping as two's complement
    (summed in int32 per cell first: the wrap of a sum equals the sum of
    wraps)."""
    if i.numel() == 0:
        return
    flat = i * table.shape[1] + j
    acc = torch.zeros(table.numel(), dtype=torch.int32, device=table.device)
    acc.index_add_(0, flat, v.to(torch.int32))
    cells = torch.unique(flat)
    view = table.view(-1)
    view[cells] = (view[cells].to(torch.int32) + acc[cells]).to(torch.int16)


class FoldArgs(ctypes.Structure):
    """Mirror of `struct FoldArgs` in csrc/fold.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "requested", "nonzero_req", "pod_count", "sig_counts", "pat_counts",
            "rows", "req", "nz", "cnt", "sig", "pat_row", "pat_col", "pat_cnt")]
        + [(d, ctypes.c_int32) for d in ("N", "R", "S", "PT", "B", "T")]
    )


def _i16_bank_ptr(bank: torch.Tensor, n: int) -> int:
    """An int16 bank's pointer (validated). The kernel adds to a cell
    through the 32-bit word holding it, and a low half's carry touches the
    high half until its correction lands: the bank must hold whole words or
    end its storage, so that no other tensor's bytes share its last word."""
    p = build.ptr(bank, torch.int16, (n, bank.shape[1]))
    end = bank.storage_offset() + bank.numel()
    if end % 2 and end * 2 != bank.untyped_storage().nbytes():
        raise ValueError("an int16 bank of an odd number of cells must end its storage: its last word would reach "
                         "into the next tensor's bytes")
    return p


def _bank_args(requested, nonzero_req, pod_count, sig_counts, pat_counts) -> FoldArgs:
    """The fold struct's bank half for these CUDA tensors (validated)."""
    n, r = requested.shape
    a = FoldArgs()
    a.requested = build.ptr(requested, torch.int64, (n, r))
    a.nonzero_req = build.ptr(nonzero_req, torch.int64, (n, 2))
    a.pod_count = build.ptr(pod_count, torch.int32, (n,))
    a.sig_counts = _i16_bank_ptr(sig_counts, n)
    a.pat_counts = _i16_bank_ptr(pat_counts, n)
    a.N, a.R, a.S, a.PT = n, r, sig_counts.shape[1], pat_counts.shape[1]
    return a


def fold_args(requested, nonzero_req, pod_count, sig_counts, pat_counts,
              rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt) -> FoldArgs:
    """The fold kernel's argument struct for these CUDA tensors. Validates
    device, dtype, shape and contiguity (raises)."""
    a = _bank_args(requested, nonzero_req, pod_count, sig_counts, pat_counts)
    r = a.R
    b = rows.shape[0]
    t = pat_row.shape[0]
    a.rows = build.ptr(rows, torch.int32, (b,))
    a.req = build.ptr(req, torch.int64, (b, r))
    a.nz = build.ptr(nz, torch.int64, (b, 2))
    a.cnt = build.ptr(cnt, torch.int32, (b,))
    a.sig = build.ptr(sig, torch.int32, (b,))
    a.pat_row = build.ptr(pat_row, torch.int32, (t,))
    a.pat_col = build.ptr(pat_col, torch.int32, (t,))
    a.pat_cnt = build.ptr(pat_cnt, torch.int16, (t,))
    a.B, a.T = b, t
    return a


def fold_commit_banks(requested, nonzero_req, pod_count, sig_counts, pat_counts,
                      rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt):
    """Fold one committed batch into the five resident banks, in place.
    CPU tensors run the plain version; CUDA tensors launch csrc/fold.cu
    (counted in `fold_commit_banks.launches`). Returns the banks."""
    banks = (requested, nonzero_req, pod_count, sig_counts, pat_counts)
    dev = requested.device
    if dev.type == "cpu":
        return fold_commit_banks_plain(*banks, rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt)
    if dev.type == "cuda":
        args = fold_args(*banks, rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt)
        build.launch(FOLD_ENTRY, args, dev)
        fold_commit_banks.launches += 1
        return banks
    raise ValueError(f"no fold kernel for device {dev}")


fold_commit_banks.launches = 0


# --- the packed program: one buffer, one upload ------------------------------

# the control arrays in buffer order (int64 first), with their dtypes and
# whether they are per lane ("b") or per triple ("t")
CONTROL = (("req", np.int64, "b"), ("nz", np.int64, "b"), ("rows", np.int32, "b"), ("cnt", np.int32, "b"),
           ("sig", np.int32, "b"), ("pat_row", np.int32, "t"), ("pat_col", np.int32, "t"),
           ("pat_cnt", np.int16, "t"))
_ALIGN = 16


class FoldControl:
    """A fold program's live lanes and triples packed into ONE host buffer
    (`buf`, uint8; pinned for the card): each control array at its
    16-byte-aligned byte offset `offsets[name]`, B lanes of R request
    columns and T triples."""

    def __init__(self, buf: torch.Tensor, b: int, t: int, r: int, offsets: Dict[str, int]):
        self.buf, self.b, self.t, self.r, self.offsets = buf, b, t, r, offsets

    def arrays(self) -> Dict[str, torch.Tensor]:
        """The control arrays as views of the buffer (the buffer unpacked)."""
        host, out = self.buf.numpy(), {}
        for name, dt, axis in CONTROL:
            n = self.b if axis == "b" else self.t
            shape = (n, self.r) if name == "req" else (n, 2) if name == "nz" else (n,)
            off = self.offsets[name]
            out[name] = torch.from_numpy(host[off:off + int(np.prod(shape)) * np.dtype(dt).itemsize].view(dt)
                                         .reshape(shape))
        return out


def live_counts(rows: np.ndarray, pat_row: np.ndarray, pat_cnt: np.ndarray, n: int):
    """(B, T): the prefixes of a program's lanes and triples that can add
    anything to banks of n rows — through the last lane whose row is in
    range, the last triple whose row is in range and whose count is not 0.
    Lanes past them are padding (plan_fold pads the tails)."""
    lanes = np.flatnonzero((rows >= 0) & (rows < n))
    trips = np.flatnonzero((pat_row >= 0) & (pat_row < n) & (pat_cnt != 0))
    return (int(lanes[-1]) + 1 if lanes.size else 0), (int(trips[-1]) + 1 if trips.size else 0)


def fold_control(rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt, n: int, pin: bool = False) -> FoldControl:
    """Pack a fold program (numpy arrays, FoldProgram's fields) for banks of
    n node rows: its live lanes and triples (`live_counts`) into one host
    buffer, pinned when `pin` (the card's path needs a CUDA build)."""
    b, t = live_counts(rows, pat_row, pat_cnt, n)
    src = {"rows": rows, "req": req, "nz": nz, "cnt": cnt, "sig": sig, "pat_row": pat_row, "pat_col": pat_col,
           "pat_cnt": pat_cnt}
    parts = [(name, dt, np.asarray(src[name])[:b if axis == "b" else t]) for name, dt, axis in CONTROL]
    offsets, off = {}, 0
    for name, dt, a in parts:  # each array at a 16-byte-aligned offset
        offsets[name] = off
        off += -(-(a.size * np.dtype(dt).itemsize) // _ALIGN) * _ALIGN
    buf = torch.empty(max(off, _ALIGN), dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    for name, dt, a in parts:
        host[offsets[name]:offsets[name] + a.size * np.dtype(dt).itemsize].view(dt).reshape(a.shape)[...] = a
    return FoldControl(buf, b, t, int(req.shape[1]), offsets)


def packed_args(banks, ctl: FoldControl, base: int) -> FoldArgs:
    """The fold struct for the banks and a packed program whose buffer lies
    on the card at `base`: each control pointer is base + its offset, B and
    T the live counts."""
    a = _bank_args(*banks)
    if ctl.r != a.R:
        raise ValueError(f"the program has {ctl.r} request columns, the bank {a.R}")
    for name, _, _ in CONTROL:
        setattr(a, name, base + ctl.offsets[name])
    a.B, a.T = ctl.b, ctl.t
    return a


def fold_commit_packed(requested, nonzero_req, pod_count, sig_counts, pat_counts, ctl: FoldControl,
                       shards: Optional[int] = None):
    """Fold a packed program into the five resident banks, in place (over
    `shards` node shards where given). CPU banks run the plain version on
    the unpacked arrays; CUDA banks take the buffer in ONE non-blocking copy
    into one device buffer and ONE launch of csrc/fold.cu (counted in
    `fold_commit_banks.launches`, or `fold_commit_sharded.launches` on
    shards). Returns the banks."""
    banks = (requested, nonzero_req, pod_count, sig_counts, pat_counts)
    dev = requested.device
    if dev.type == "cpu":
        arrays = ctl.arrays()
        if shards is None:
            return fold_commit_banks_plain(*banks, **arrays)
        return fold_commit_sharded_plain(shards, *banks, **arrays)
    if dev.type != "cuda":
        raise ValueError(f"no fold kernel for device {dev}")
    buf = torch.empty(ctl.buf.shape[0], dtype=torch.uint8, device=dev)
    buf.copy_(ctl.buf, non_blocking=True)
    if shards is not None:
        shard_rows(requested.shape[0], shards)  # raises unless N = S * Nl
    build.launch(FOLD_ENTRY, packed_args(banks, ctl, buf.data_ptr()), dev)
    if shards is None:
        fold_commit_banks.launches += 1
    else:
        fold_commit_sharded.launches += 1
    return banks


def fold_usage_plain(
    requested: torch.Tensor,  # [N, R] int64, updated in place
    pod_count: torch.Tensor,  # [N] int32, updated in place
    rows: torch.Tensor,       # [B] int32 node row per entry (N = pad)
    vecs: torch.Tensor,       # [B, R] int64 request vector per entry
    cnt: torch.Tensor,        # [B] int32 pod-count delta per entry
):
    """The reference's two scatter-adds with mode="drop". Returns
    (requested, pod_count), the same tensors, updated."""
    n = requested.shape[0]
    live = (rows >= 0) & (rows < n)
    r = rows[live].long()
    requested.index_put_((r,), vecs[live].to(requested.dtype), accumulate=True)
    pod_count.index_put_((r,), cnt[live].to(pod_count.dtype), accumulate=True)
    return requested, pod_count


class FoldUsageArgs(ctypes.Structure):
    """Mirror of `struct FoldUsageArgs` in csrc/fold.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in ("requested", "pod_count", "rows", "vecs", "cnt")]
        + [(d, ctypes.c_int32) for d in ("N", "R", "B")]
    )


def fold_usage_args(requested, pod_count, rows, vecs, cnt) -> FoldUsageArgs:
    """The usage fold's argument struct for these CUDA tensors (raises on
    a device, dtype, shape or layout the kernel does not take)."""
    n, r = requested.shape
    b = rows.shape[0]
    a = FoldUsageArgs()
    a.requested = build.ptr(requested, torch.int64, (n, r))
    a.pod_count = build.ptr(pod_count, torch.int32, (n,))
    a.rows = build.ptr(rows, torch.int32, (b,))
    a.vecs = build.ptr(vecs, torch.int64, (b, r))
    a.cnt = build.ptr(cnt, torch.int32, (b,))
    a.N, a.R, a.B = n, r, b
    return a


def fold_usage(requested, pod_count, rows, vecs, cnt):
    """Add the entries' request vectors and pod counts into the usage
    columns, in place. CPU tensors run the plain version; CUDA tensors
    launch csrc/fold.cu (counted in `fold_usage.launches`). Returns
    (requested, pod_count)."""
    dev = requested.device
    if dev.type == "cpu":
        return fold_usage_plain(requested, pod_count, rows, vecs, cnt)
    if dev.type == "cuda":
        build.launch(FOLD_USAGE_ENTRY, fold_usage_args(requested, pod_count, rows, vecs, cnt), dev)
        fold_usage.launches += 1
        return requested, pod_count
    raise ValueError(f"no fold kernel for device {dev}")


fold_usage.launches = 0


# --- the node-sharded twins -------------------------------------------------

def _local_rows(rows: torch.Tensor, base: int, n_local: int) -> torch.Tensor:
    """Global row -> shard-local row; foreign and sentinel lanes -> n_local
    (out of range, dropped). Sentinel N is foreign to every shard: for the
    last shard N - base == n_local, already out of range."""
    mine = (rows >= base) & (rows < base + n_local)
    return torch.where(mine, rows - base, torch.full_like(rows, n_local))


def fold_commit_sharded_plain(shards: int, requested, nonzero_req, pod_count, sig_counts, pat_counts,
                              rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt):
    """The reference's shard_map'd commit fold with the shard axis written
    out: each shard's row views take the lanes rebased onto them."""
    nl = shard_rows(requested.shape[0], shards)
    for s in range(shards):
        lo, hi = s * nl, (s + 1) * nl
        fold_commit_banks_plain(
            requested[lo:hi], nonzero_req[lo:hi], pod_count[lo:hi], sig_counts[lo:hi], pat_counts[lo:hi],
            _local_rows(rows, lo, nl), req, nz, cnt, sig, _local_rows(pat_row, lo, nl), pat_col, pat_cnt,
        )
    return requested, nonzero_req, pod_count, sig_counts, pat_counts


def fold_commit_sharded(shards: int, requested, nonzero_req, pod_count, sig_counts, pat_counts,
                        rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt):
    """The commit fold over `shards` node shards, in place. CPU tensors run
    the plain version; CUDA tensors check N = S * Nl and launch the single
    fold's kernel, which on one card's row-range shards adds every element
    where the shard owning its row would (counted in
    `fold_commit_sharded.launches`). Returns the banks."""
    banks = (requested, nonzero_req, pod_count, sig_counts, pat_counts)
    dev = requested.device
    if dev.type == "cpu":
        return fold_commit_sharded_plain(shards, *banks, rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt)
    if dev.type == "cuda":
        shard_rows(requested.shape[0], shards)  # raises unless N = S * Nl
        build.launch(FOLD_ENTRY, fold_args(*banks, rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt), dev)
        fold_commit_sharded.launches += 1
        return banks
    raise ValueError(f"no fold kernel for device {dev}")


fold_commit_sharded.launches = 0


def fold_usage_sharded_plain(shards: int, requested, pod_count, rows, vecs, cnt):
    """The reference's shard_map'd usage fold with the shard axis written
    out."""
    nl = shard_rows(requested.shape[0], shards)
    for s in range(shards):
        lo, hi = s * nl, (s + 1) * nl
        fold_usage_plain(requested[lo:hi], pod_count[lo:hi], _local_rows(rows, lo, nl), vecs, cnt)
    return requested, pod_count


class ShardedFoldUsageArgs(ctypes.Structure):
    """Mirror of `struct ShardedFoldUsageArgs` in csrc/fold.cu."""

    _fields_ = [("fold", FoldUsageArgs), ("S", ctypes.c_int32), ("Nl", ctypes.c_int32)]


def fold_usage_sharded(shards: int, requested, pod_count, rows, vecs, cnt):
    """The usage fold over `shards` node shards, in place. CPU tensors run
    the plain version; CUDA tensors launch csrc/fold.cu's sharded kernel
    (counted in `fold_usage_sharded.launches`). Returns (requested,
    pod_count)."""
    dev = requested.device
    if dev.type == "cpu":
        return fold_usage_sharded_plain(shards, requested, pod_count, rows, vecs, cnt)
    if dev.type == "cuda":
        nl = shard_rows(requested.shape[0], shards)
        args = ShardedFoldUsageArgs(fold_usage_args(requested, pod_count, rows, vecs, cnt), shards, nl)
        build.launch(FOLD_USAGE_SHARDED_ENTRY, args, dev)
        fold_usage_sharded.launches += 1
        return requested, pod_count
    raise ValueError(f"no fold kernel for device {dev}")


fold_usage_sharded.launches = 0

_SHARDED_FOLD_CACHE: dict = {}


def make_sharded_fold_fns(mesh):
    """(commit, usage) fold functions bound to `mesh`'s node shards, with
    fold_commit_banks' and fold_usage's signatures. Memoized per mesh."""
    cached = _SHARDED_FOLD_CACHE.get(mesh)
    if cached is not None:
        return cached
    shards = node_shards(mesh)
    fns = (partial(fold_commit_sharded, shards), partial(fold_usage_sharded, shards))
    _SHARDED_FOLD_CACHE[mesh] = fns
    return fns
