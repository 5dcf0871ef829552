"""Fold planner: a committed batch's state deltas as device control data.

Port of `kubernetes_tpu/commit/fold.py` (`FoldProgram` :34, `plan_fold`
:67) without the columnar-cache branch. Given the final placed set of a
batch — the (pod, node row) pairs the driver is about to assume — it
builds the padded control arrays ops/fold.fold_commit_banks scatters into
the resident banks: per pod its request vector, non-zero scoring request
and signature row, and per (anti-)affinity term instance a (node row,
pattern row) triple. Every value comes from the source the host delta path
reads (state/tensors._req_slot_pairs, oracle pod_non_zero_request, the
SigBank / PatternBank interning), so the fold equals the host scatter it
replaces.

Signatures and patterns are interned here first (SigBank.prepare_row,
PatternBank.prepare_pod_rows): the rows must exist before the fold, and a
new row's metadata ships as a dirty row while its counts arrive by the
fold. A bank overflow (signature, pattern or key slot) makes plan_fold
return None: the caller's assumes then ship as pending rows, and the
mirror's next sync rebuilds bigger, as the host path would have.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..oracle.nodeinfo import pod_non_zero_request
from ..state.tensors import KeySlotOverflow, _bucket, _req_slot_pairs


@dataclass
class FoldProgram:
    """Padded control arrays for one fold_commit_banks launch. Index
    sentinels (row N, signature S, pattern PT) mark padding; the fold
    drops out-of-range lanes."""

    rows: np.ndarray     # [B] int32 node row
    req: np.ndarray      # [B, R] int64
    nz: np.ndarray       # [B, 2] int64
    cnt: np.ndarray      # [B] int32
    sig: np.ndarray      # [B] int32
    pat_row: np.ndarray  # [T] int32
    pat_col: np.ndarray  # [T] int32
    pat_cnt: np.ndarray  # [T] int16
    pods: int            # real (unpadded) commit count

    @property
    def pat_bucket(self) -> int:
        return int(self.pat_row.shape[0])


def plan_fold(mirror, pairs: Sequence[Tuple[object, int]], row_bucket: int,
              pat_bucket: int) -> Optional[FoldProgram]:
    """A FoldProgram for `pairs` = [(pod, node row)] against `mirror`'s
    current bank shapes. `row_bucket` is the driver's monotone batch
    bucket (≥ len(pairs)); `pat_bucket` its pattern-triple bucket, grown
    here to the next power of two when the batch carries more pattern
    instances (the caller keeps the returned program's pat_bucket).
    Returns None on a bank overflow, or when there is nothing to fold."""
    n = len(pairs)
    if n == 0 or n > row_bucket:
        return None
    nodes = mirror.nodes
    n_cap = nodes.capacity
    width = nodes.requested.shape[1]
    s_cap = mirror.eps.capacity
    p_cap = mirror.pats.capacity
    rows = np.full(row_bucket, n_cap, np.int32)
    req = np.zeros((row_bucket, width), np.int64)
    nz = np.zeros((row_bucket, 2), np.int64)
    cnt = np.zeros(row_bucket, np.int32)
    sig = np.full(row_bucket, s_cap, np.int32)
    triples: List[Tuple[int, int]] = []
    vocab = mirror.vocab
    try:
        for i, (pod, row) in enumerate(pairs):
            rows[i] = row
            for s, v in _req_slot_pairs(vocab, pod):
                if s >= width:
                    raise KeySlotOverflow()
                req[i, s] = v
            c, m = pod_non_zero_request(pod)
            nz[i, 0] = c
            nz[i, 1] = m
            cnt[i] = 1
            sig[i] = mirror.eps.prepare_row(pod)
            for prow in mirror.pats.prepare_pod_rows(pod):
                triples.append((row, prow))
    except KeySlotOverflow:
        # SigOverflow and PatternOverflow included: the banks are full —
        # the host path raises the same way and rebuilds bigger
        return None
    t_bucket = max(pat_bucket, _bucket(max(len(triples), 1)))
    pat_row = np.full(t_bucket, n_cap, np.int32)
    pat_col = np.full(t_bucket, p_cap, np.int32)
    pat_cnt = np.zeros(t_bucket, np.int16)
    for j, (prow, pcol) in enumerate(triples):
        pat_row[j] = prow
        pat_col[j] = pcol
        pat_cnt[j] = 1
    return FoldProgram(rows=rows, req=req, nz=nz, cnt=cnt, sig=sig,
                       pat_row=pat_row, pat_col=pat_col, pat_cnt=pat_cnt, pods=n)
