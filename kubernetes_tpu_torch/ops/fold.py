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
Any other device raises.

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
over the shards' row views); on CUDA tensors one launch of
`csrc/fold.cu`'s sharded kernels covers every shard (counted in their
`.launches`).
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from ..kernels import build
from ..parallel.mesh import node_shards, shard_rows

FOLD_ENTRY = "ktpu_fold_commit_banks"
FOLD_USAGE_ENTRY = "ktpu_fold_usage"
FOLD_SHARDED_ENTRY = "ktpu_fold_commit_sharded"
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


def fold_args(requested, nonzero_req, pod_count, sig_counts, pat_counts,
              rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt) -> FoldArgs:
    """The fold kernel's argument struct for these CUDA tensors. Validates
    device, dtype, shape and contiguity (raises)."""
    n, r = requested.shape
    s = sig_counts.shape[1]
    pt = pat_counts.shape[1]
    b = rows.shape[0]
    t = pat_row.shape[0]
    a = FoldArgs()
    a.requested = build.ptr(requested, torch.int64, (n, r))
    a.nonzero_req = build.ptr(nonzero_req, torch.int64, (n, 2))
    a.pod_count = build.ptr(pod_count, torch.int32, (n,))
    a.sig_counts = build.ptr(sig_counts, torch.int16, (n, s))
    a.pat_counts = build.ptr(pat_counts, torch.int16, (n, pt))
    a.rows = build.ptr(rows, torch.int32, (b,))
    a.req = build.ptr(req, torch.int64, (b, r))
    a.nz = build.ptr(nz, torch.int64, (b, 2))
    a.cnt = build.ptr(cnt, torch.int32, (b,))
    a.sig = build.ptr(sig, torch.int32, (b,))
    a.pat_row = build.ptr(pat_row, torch.int32, (t,))
    a.pat_col = build.ptr(pat_col, torch.int32, (t,))
    a.pat_cnt = build.ptr(pat_cnt, torch.int16, (t,))
    a.N, a.R, a.S, a.PT, a.B, a.T = n, r, s, pt, b, t
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


class ShardedFoldArgs(ctypes.Structure):
    """Mirror of `struct ShardedFoldArgs` in csrc/fold.cu."""

    _fields_ = [("fold", FoldArgs), ("S", ctypes.c_int32), ("Nl", ctypes.c_int32)]


def fold_commit_sharded(shards: int, requested, nonzero_req, pod_count, sig_counts, pat_counts,
                        rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt):
    """The commit fold over `shards` node shards, in place. CPU tensors run
    the plain version; CUDA tensors launch csrc/fold.cu's sharded kernel,
    every shard in one launch (counted in `fold_commit_sharded.launches`).
    Returns the banks."""
    banks = (requested, nonzero_req, pod_count, sig_counts, pat_counts)
    dev = requested.device
    if dev.type == "cpu":
        return fold_commit_sharded_plain(shards, *banks, rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt)
    if dev.type == "cuda":
        nl = shard_rows(requested.shape[0], shards)
        args = ShardedFoldArgs(fold_args(*banks, rows, req, nz, cnt, sig, pat_row, pat_col, pat_cnt), shards, nl)
        build.launch(FOLD_SHARDED_ENTRY, args, dev)
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
