"""Index-only term dispatch: a batch's term table rebuilt on the card.

The port of `kubernetes_tpu/terms_plane/gather.py`. One launch of
csrc/slab.cu's gather rebuilds the exact per-batch TermBank array dict the
solve and arbiter programs read, from the resident term slab and two int32
vectors — the slab row of each batch-term lane and the rep owning it.
Entries are concatenated in rep order, each entry's rows in the canonical
per-pod encode order, so lane i holds exactly what compile_batch_terms
would have written at row i. The slab stores each row's own index in
`owner`; the batch table owns rows by rep position, so `owner` is written
from the shipped vector (keep ? owner : 0, padding lanes keeping an
untouched row's 0). Padding lanes reproduce an untouched TermBank row bit
for bit.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.slab import GatherProblem, gather_batch, gather_slab_plain

Arrays = Dict[str, torch.Tensor]


def gather_terms_plain(bank: Arrays, idx: torch.Tensor, owner: torch.Tensor, keep: torch.Tensor,
                       empty: Arrays) -> Arrays:
    """The plain version: where(keep, bank[k][idx], empty[k]) per array,
    then owner = where(keep, owner, 0), every tensor on the bank's
    device."""
    out = gather_slab_plain(bank, idx, keep, empty)
    out["owner"] = torch.where(keep, owner, torch.zeros_like(owner)).to(torch.int32)
    return out


def term_problem(bank: Arrays, idx, owner, keep, empty: Arrays) -> GatherProblem:
    """The term table's gather problem: `owner` written as keep ? owner : 0."""
    return GatherProblem(bank, empty, idx, keep, owner, "owner", col_masked=True)


def gather_terms(bank: Arrays, idx, owner, keep, empty: Arrays) -> Arrays:
    """bank: the term slab dict ([S, ...] on the device); idx: [T] int32
    slab rows; owner: [T] int32 owning rep of each lane; keep: [T] bool
    (True for real term lanes); empty: the one-row padding dict. idx, owner
    and keep are host vectors. Returns the batch's term-table dict, [T,
    ...], on the bank's device: CUDA banks launch csrc/slab.cu's batch
    gather once for this one problem (counted in `gather_terms.launches`
    and `gather_batch.launches`), CPU banks run the plain version."""
    before = gather_batch.launches
    (out,) = gather_batch([term_problem(bank, idx, owner, keep, empty)])
    gather_terms.launches += gather_batch.launches - before
    return out


gather_terms.launches = 0
