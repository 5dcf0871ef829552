"""Index-only dispatch prologue: a batch's pod arrays rebuilt on the card.

The port of `kubernetes_tpu/ingest/gather.py`. csrc/slab.cu's batch gather
rebuilds the exact per-batch PodBatch array dict the solve, gang and
arbiter programs read, from the resident staged slab and an int32 index
vector — the only pod-side payload a covered dispatch ships. The driver
hands `stage_problem` to `ops/slab.gather_batch` beside the term table's
problem (one launch a batch); `gather_stage` is the one-problem call.
Padding lanes reproduce an untouched PodBatch row bit for bit (`empty` is
the slab's one-row zero state: -1 pads on the selector and term slots,
zeros elsewhere), so the programs downstream see exactly what the legacy
host-built upload would have given them.

`fallback` comes from the shipped vector, not the slab (ref :39): the
effective per-spec fallback is the staged row's overflow, patched on the
host with the batch term table's overflow, which exists only at dispatch.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.slab import GatherProblem, gather_batch, gather_slab_plain

Arrays = Dict[str, torch.Tensor]


def gather_stage_plain(bank: Arrays, idx: torch.Tensor, keep: torch.Tensor, empty: Arrays,
                       fallback: torch.Tensor) -> Arrays:
    """The plain version: where(keep, bank[k][idx], empty[k]) per array and
    `fallback` as given, every tensor on the bank's device."""
    out = gather_slab_plain(bank, idx, keep, empty)
    out["fallback"] = fallback
    return out


def stage_problem(bank: Arrays, idx, keep, empty: Arrays, fallback) -> GatherProblem:
    """The pod arrays' gather problem: `fallback` written as shipped."""
    return GatherProblem(bank, empty, idx, keep, fallback, "fallback", col_masked=False)


def gather_stage(bank: Arrays, idx, keep, empty: Arrays, fallback) -> Arrays:
    """bank: the staged slab dict ([S, ...] on the device); idx: [U] int32
    slab rows; keep: [U] bool (True for the batch's specs, False for
    padding); empty: the one-row padding dict; fallback: [U] bool (the
    host's effective fallback). idx, keep and fallback are host vectors.
    Returns the batch's pod-array dict, [U, ...], on the bank's device:
    CUDA banks launch csrc/slab.cu's batch gather once for this one problem
    (counted in `gather_stage.launches` and `gather_batch.launches`), CPU
    banks run the plain version."""
    before = gather_batch.launches
    (out,) = gather_batch([stage_problem(bank, idx, keep, empty, fallback)])
    gather_stage.launches += gather_batch.launches - before
    return out


gather_stage.launches = 0
