"""Host-side pod staging slab: rows encoded once, at admission.

The port's copy of `kubernetes_tpu/ingest/stage.py`. A `PodStage` is a
`state/tensors.PodBatch` used as a SLAB with a row allocator: rows are
content-interned by `spec_key` (the replicas of one controller share one
row, as the dispatch-time dedup does) and refcounted by the queue entries
that hold them. `set_pod` runs once per distinct spec when the queue
admits the pod, so a dispatch only validates (row, generation) pairs and
ships an index vector.

Generation discipline: every allocation and free stamps the row with a
fresh value of one monotone counter, and a slab rebuild (vocab width
growth, capacity growth) restarts nothing, so ANY (row, gen) pair issued
before the event mismatches afterwards. A queue entry whose pair went stale
re-stages at dispatch (counted) or its batch takes the legacy in-batch
encode; correctness never depends on a row being live.

Thread safety: one RLock around all bookkeeping, shared with the device
twin (bank.StageBank). Lock order where both are held: the queue's lock,
then this one; the slab never calls into the queue.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..state.tensors import KeySlotOverflow, PodBatch, spec_key

#: slab capacity floor and ceiling (power-of-two rungs between). The slab
#: holds one row per DISTINCT pending spec, so the ceiling is a safety
#: valve, not a sizing concern.
MIN_CAPACITY = 256
MAX_CAPACITY = 16384


class PodStage:
    """Content-interned, refcounted slab of encoded pod rows."""

    def __init__(self, vocab, capacity: int = MIN_CAPACITY):
        self.vocab = vocab
        self._lock = threading.RLock()
        self._next_gen = 1  # guarded by self._lock
        # bumped on every rebuild; the device twin keys its full-upload
        # decision on it
        self.generation = 0  # guarded by self._lock
        # guarded by self._lock
        self.stats: Dict[str, int] = {
            "staged": 0,  # fresh rows encoded (once per distinct spec)
            "hits": 0,  # acquire served by an existing row
            "overflows": 0,  # slab-full growth events
            "rebuilds": 0,  # width-growth / capacity-growth rebuilds
        }
        self._build(max(capacity, MIN_CAPACITY))

    # -- slab lifecycle ------------------------------------------------------

    def _build(self, capacity: int) -> None:
        self.capacity = capacity
        self.batch = PodBatch(self.vocab, capacity)
        self.key_capacity = self.batch.key_capacity
        self.resource_capacity = self.batch.req.shape[1]
        self.row_of: Dict[tuple, int] = {}
        self._key_of_row: Dict[int, tuple] = {}
        self.refs = np.zeros(capacity, np.int64)
        self.row_gen = np.zeros(capacity, np.int64)  # 0 = never issued
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self.dirty_rows: set = set()
        self.generation += 1
        # an untouched PodBatch row, the gather's padding: -1 pads on the
        # selector and term slots, zeros elsewhere, bit for bit
        self.empty_rows = PodBatch(self.vocab, 1).arrays()

    def _rebuild(self, capacity: Optional[int] = None) -> None:
        self.stats["rebuilds"] += 1
        self._build(capacity or self.capacity)

    def current_for(self, vocab) -> bool:
        """Do the slab's widths still match the vocab's? A key-slot or
        resource-slot growth makes every staged row the wrong shape."""
        return (
            vocab is self.vocab
            and self.key_capacity == vocab.config.key_slots
            and self.resource_capacity == vocab.config.resource_slots
        )

    def ensure_current(self) -> bool:
        """Rebuild if the vocab widths grew; True when it rebuilt (every
        outstanding pair is then stale)."""
        with self._lock:
            if self.current_for(self.vocab):
                return False
            self._rebuild()
            return True

    # -- row acquisition -----------------------------------------------------

    def acquire(self, pod) -> Optional[Tuple[int, int]]:
        """Intern `pod`'s spec row (+1 reference). Returns (row, gen), or
        None when the pod cannot be staged now (an encode overflow while
        the vocab grows, or the slab at its ceiling): its batch takes the
        legacy encode. A full slab below the ceiling doubles; the rebuild
        makes the outstanding pairs stale (one legacy batch at worst)."""
        with self._lock:
            if not self.current_for(self.vocab):
                self._rebuild()
            key = spec_key(pod)
            row = self.row_of.get(key)
            if row is not None:
                self.refs[row] += 1
                self.stats["hits"] += 1
                return row, int(self.row_gen[row])
            if not self._free:
                self.stats["overflows"] += 1
                if self.capacity >= MAX_CAPACITY:
                    return None
                self._rebuild(self.capacity * 2)
            row = self._free.pop()
            try:
                self.batch.set_pod(row, pod)
            except KeySlotOverflow:
                # the widths changed under the encode: rebuild at the new
                # widths and let the next admission (or restage) encode
                self._free.append(row)
                self._rebuild()
                return None
            self.row_of[key] = row
            self._key_of_row[row] = key
            self.refs[row] = 1
            gen = self._next_gen
            self._next_gen += 1
            self.row_gen[row] = gen
            self.dirty_rows.add(row)
            self.stats["staged"] += 1
            return row, gen

    def ensure_row(self, pod) -> Optional[Tuple[int, int]]:
        """Intern `pod`'s spec row WITHOUT taking a reference: the
        dispatch-time restage. A fresh zero-reference row is never freed by
        release() (no holder can release it), so it stays valid through
        the dispatch and lingers until a rebuild reclaims it. Returns what
        acquire() returns."""
        with self._lock:
            pair = self.acquire(pod)
            if pair is None:
                return None
            row, _ = pair
            self.refs[row] = max(self.refs[row] - 1, 0)
            return pair

    def release(self, row: int, gen: int) -> None:
        """Drop one reference; at zero the row frees (generation bump). A
        stale pair is ignored."""
        with self._lock:
            if not (0 <= row < self.capacity) or self.row_gen[row] != gen:
                return
            self.refs[row] -= 1
            if self.refs[row] <= 0:
                self.refs[row] = 0
                key = self._key_of_row.pop(row, None)
                if key is not None:
                    self.row_of.pop(key, None)
                self.batch.valid[row] = False
                self.row_gen[row] = self._next_gen
                self._next_gen += 1
                self._free.append(row)
                # no live pair names a freed row, so the gather never reads
                # it: the device twin needs no update

    def live_rows_locked(self) -> List[int]:
        """Rows currently allocated: the only rows a gather can read, so
        the only rows the device-twin check compares (caller holds the
        lock)."""
        free = set(self._free)
        return [r for r in range(self.capacity) if r not in free]

    def valid_pair(self, row: int, gen: int) -> bool:
        with self._lock:
            return 0 <= row < self.capacity and self.row_gen[row] == gen
