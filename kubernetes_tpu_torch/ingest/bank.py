"""Device-resident staged pod bank: the PodStage slab's twin on the card.

The port of `kubernetes_tpu/ingest/bank.py`, without its background
uploader, warm-up or compile plan: every flush here is the reference's
dispatch-time synchronous flush, counted in `stats["sync_rows"]`. The slab
uploads whole once (a plain host→device copy, as TensorMirror uploads its
banks) and again after a slab rebuild; after that only the rows admissions
staged since the last flush cross, through ONE launch of csrc/slab.cu's
row scatter (ops/slab.scatter_rows, a one-problem call of scatter_batch)
that ships exactly the dirty rows, taken from the host slab into pinned
memory and copied without blocking. The
reference pads a flush to its STAGE_RUNGS to bound the number of XLA
programs; the port compiles none.

The scatter writes the resident slab IN PLACE. The reference's scatter is
deliberately not donated, because its background uploader patches while an
earlier dispatch still holds the previous dict. Here the flush runs on the
driver thread, on the current stream, before the gather, and every gather
writes a fresh output tensor: an in-place patch is stream-ordered behind
the launches that read the slab before it, and exact. Double buffering
returns with the uploader (ROADMAP queue 1 item 6).

`StageBank` is slab-agnostic: any stage exposing `batch` (an encoder with
.arrays()), `empty_rows`, `_lock`, `dirty_rows`, `generation` and
`live_rows_locked` twins through it; the term plane's bank
(terms_plane/bank.TermBankDevice) does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.slab import scatter_rows
from ..state.convert import arrays_to_torch

Arrays = Dict[str, torch.Tensor]


class StageBank:
    """Keeps a device copy of a staging slab patched from its dirty rows.
    Shares the slab's RLock, so the driver's covered-dispatch window
    (validate rows, flush, capture the gather's inputs) is atomic against
    admissions and slab rebuilds."""

    #: the name of this twin's arrays in device_divergence()
    NAME = "stage"

    def __init__(self, stage, device):
        self.stage = stage
        self.device = torch.device(device)
        self._lock = stage._lock
        self._dev: Optional[Arrays] = None  # guarded by self._lock
        self._empty_dev: Optional[Arrays] = None  # guarded by self._lock
        self._dev_generation = -1  # guarded by self._lock
        # guarded by self._lock
        self.stats: Dict[str, int] = {
            "full_uploads": 0,
            "sync_rows": 0,  # dirty rows the driver flushed at dispatch
        }

    def _flush_locked(self) -> None:
        """Ship the slab's dirty rows into the device twin (slab lock
        held); a full upload on first use or after a slab rebuild."""
        stage = self.stage
        if self._dev is None or self._dev_generation != stage.generation:
            self._dev = arrays_to_torch(stage.batch.arrays(), self.device, copy=True)
            self._empty_dev = arrays_to_torch(stage.empty_rows, self.device, copy=True)
            self.stats["full_uploads"] += 1
            stage.dirty_rows.clear()
            self._dev_generation = stage.generation
            return
        if not stage.dirty_rows:
            return
        rows = sorted(stage.dirty_rows)
        stage.dirty_rows.clear()
        self.stats["sync_rows"] += len(rows)
        try:
            self._scatter_rows(rows)
        except BaseException:
            # the twin may hold part of the patch: the next flush re-uploads
            # it whole from host truth
            self._dev = None
            raise

    def _scatter_rows(self, rows: List[int]) -> None:
        """Write host truth of `rows` into the twin: one launch for every
        array of the slab (ref :215), the rows taken from the host slab
        straight into the launch's pinned buffer."""
        scatter_rows(self._dev, rows, self.stage.batch.arrays())

    def current_arrays(self) -> Tuple[Arrays, Arrays]:
        """(slab twin, padding row) with every dirty row flushed: the
        covered dispatch's gather inputs (ref :472)."""
        with self._lock:
            self._flush_locked()
            return self._dev, self._empty_dev

    def device_divergence(self) -> List[str]:
        """Names of twin arrays not bit-identical to the host slab on the
        live rows (ref :416), after flushing the dirty rows: an unflushed
        row is lag, not drift. Freed rows are not compared: release() frees
        host rows without dirtying them, and no live pair gathers one."""
        with self._lock:
            if self._dev is None:
                return []
            self._flush_locked()
            host = self.stage.batch.arrays()
            dev = dict(self._dev)
            live = np.asarray(self.stage.live_rows_locked(), np.int64)
        out: List[str] = []
        for k, h in host.items():
            d = dev.get(k)
            if d is None:
                out.append(f"{self.NAME}.{k}:missing")
                continue
            dn = d.cpu().numpy()
            if dn.shape != h.shape:
                out.append(f"{self.NAME}.{k}:shape")
            elif live.size and not np.array_equal(dn[live], h[live].astype(dn.dtype)):
                out.append(f"{self.NAME}.{k}")
        return out

    def close(self) -> None:
        """Flush the dirty backlog (ref :452), so the twin stays host-true
        to the last admission. Idempotent."""
        with self._lock:
            if self._dev is not None and self.stage.dirty_rows:
                self._flush_locked()
