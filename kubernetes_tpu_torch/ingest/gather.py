"""Index-only dispatch prologue: a batch's pod arrays rebuilt on the card.

The port of `kubernetes_tpu/ingest/gather.py`. One launch of
csrc/slab.cu's gather rebuilds the exact per-batch PodBatch array dict the
solve, gang and arbiter programs read, from the resident staged slab and an
int32 index vector — the only pod-side payload a covered dispatch ships.
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

from ..ops.slab import gather_slab, gather_slab_plain

Arrays = Dict[str, torch.Tensor]


def gather_stage_plain(bank: Arrays, idx: torch.Tensor, keep: torch.Tensor, empty: Arrays,
                       fallback: torch.Tensor) -> Arrays:
    """The plain version: where(keep, bank[k][idx], empty[k]) per array and
    `fallback` as given, every tensor on the bank's device."""
    out = gather_slab_plain(bank, idx, keep, empty)
    out["fallback"] = fallback
    return out


def gather_stage(bank: Arrays, idx, keep, empty: Arrays, fallback) -> Arrays:
    """bank: the staged slab dict ([S, ...] on the device); idx: [U] int32
    slab rows; keep: [U] bool (True for the batch's specs, False for
    padding); empty: the one-row padding dict; fallback: [U] bool (the
    host's effective fallback). idx, keep and fallback are host vectors.
    Returns the batch's pod-array dict, [U, ...], on the bank's device:
    CUDA banks launch csrc/slab.cu once (counted in
    `gather_stage.launches`), CPU banks run the plain version."""
    out, launched = gather_slab(bank, idx, keep, empty, col=fallback, col_key="fallback", col_masked=False)
    if launched:
        gather_stage.launches += 1
    return out


gather_stage.launches = 0
