"""Host-side term slab: a pod's topology terms compiled once, at admission.

The port of `kubernetes_tpu/terms_plane/stage.py`. A `TermStage` interns
each distinct pod spec's term set ONCE, as an ENTRY owning a short list of
rows in a `state/terms.TermBank` used as a slab, refcounted by the queue
entries that hold it. Replicas of one controller share one entry; a
dispatch ships int32 (row, owner) index vectors and gathers the batch's
term table on the device (terms_plane/gather.py).

Every row is encoded through `state/terms.encode_pod_terms`, the helper
`compile_batch_terms` writes from, in the same canonical per-pod order, so
concatenating entries in rep order reproduces the host-built table bit for
bit; `owner`, rewritten on the device from the shipped owner vector, is
the one per-batch field.

Generations (the PodStage contract): entry ids are monotone and never
reused; an update or delete between enqueue and pop frees the last
holder's entry (a popped copy sees the mismatch and re-stages at dispatch,
counted); a slab rebuild (row-capacity growth, key-width growth) drops
every entry. The spreading selectors (SelectorSpread's Service and
controller listers) are part of the intern key, so a Service change
between enqueue and dispatch is ordinary staleness, not a wrong answer.

Thread safety: one RLock around all bookkeeping, shared with the device
twin. Lock order where both are held: the queue's lock, then this one.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..state.tensors import KeySlotOverflow, _bucket, spec_key
from ..state.terms import TermBank, encode_pod_terms

#: slab row capacity floor and ceiling (power-of-two rungs between): one
#: entry per distinct pending (spec, selectors) pair, a few rows each
MIN_CAPACITY = 256
MAX_CAPACITY = 16384

_UNSET = object()


class TermEntry:
    """One interned term set: its slab rows (in canonical encode order) and
    what the dispatch needs host-side without reading the rows — the aux
    bits, the term kinds present, the topology slots, the overflow flag."""

    __slots__ = (
        "rows", "gen", "refs", "key", "self_aff_match", "has_aff",
        "has_anti", "n_sel_spread", "kinds", "topo_slots", "overflow",
    )

    def __init__(self, rows, gen, key, aux, kinds, topo_slots, overflow):
        self.rows: Tuple[int, ...] = rows
        self.gen = gen
        self.refs = 0
        self.key = key
        self.self_aff_match = aux["self_aff_match"]
        self.has_aff = aux["has_aff"]
        self.has_anti = aux["has_anti"]
        self.n_sel_spread = aux["n_sel_spread"]
        self.kinds: frozenset = kinds
        self.topo_slots: frozenset = topo_slots
        self.overflow = overflow


class TermStage:
    """Content-interned, refcounted slab of encoded term rows."""

    def __init__(self, vocab, capacity: int = MIN_CAPACITY):
        self.vocab = vocab
        self._lock = threading.RLock()
        self._next_gen = 1  # guarded by self._lock
        self._next_entry = 0  # guarded by self._lock
        # the SelectorSpread getSelectors hook (the driver installs the one
        # it uses at dispatch), consulted at acquire so an entry's key
        # equals the dispatch's dedup key
        self.selectors_fn: Optional[Callable] = None
        # bumped on every rebuild; the device twin keys its full-upload
        # decision on it
        self.generation = 0  # guarded by self._lock
        # guarded by self._lock
        self.stats: Dict[str, int] = {
            "staged": 0,  # entries encoded (once per distinct term set)
            "hits": 0,  # acquire served by an existing entry
            "overflows": 0,  # slab-full growth events
            "rebuilds": 0,  # capacity / width rebuilds
        }
        self._build(max(capacity, MIN_CAPACITY))

    # -- slab lifecycle ------------------------------------------------------

    def _build(self, capacity: int) -> None:
        self.capacity = capacity
        # the encode guard: after a key-slot growth fresh encodes may name
        # slots the node banks cannot index yet, so the slab rebuilds and
        # re-encodes at the new width (no term array is key-slot wide)
        self.key_capacity = self.vocab.config.key_slots
        # the row slab, named `batch` so the device twin reads it like the
        # pod slab's PodBatch
        self.batch = TermBank(self.vocab, capacity)
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._entry_of: Dict[tuple, int] = {}
        self._entries: Dict[int, TermEntry] = {}
        self.dirty_rows: set = set()
        self.generation += 1
        # an untouched TermBank row, the gather's padding
        self.empty_rows = TermBank(self.vocab, 1).arrays()

    def _rebuild(self, capacity: Optional[int] = None) -> None:
        self.stats["rebuilds"] += 1
        self._build(capacity or self.capacity)

    def current_for(self, vocab) -> bool:
        return vocab is self.vocab and self.key_capacity == vocab.config.key_slots

    def ensure_current(self) -> bool:
        """Rebuild if the vocab's key width grew; True when it rebuilt."""
        with self._lock:
            if self.current_for(self.vocab):
                return False
            self._rebuild()
            return True

    # -- entry acquisition ---------------------------------------------------

    def _encode_entry(self, pod, sels, key) -> Optional[TermEntry]:
        rows_args, aux = encode_pod_terms(pod, sels)
        need = len(rows_args)
        if need > len(self._free):
            self.stats["overflows"] += 1
            grown = max(self.capacity * 2, _bucket(need, MIN_CAPACITY))
            if grown > MAX_CAPACITY:
                return None  # the legacy path takes the batch
            self._rebuild(grown)  # every outstanding pair goes stale
        bank = self.batch
        rows: List[int] = []
        try:
            for kind, topo, sel, nss, ns_any, weight, sm in rows_args:
                row = self._free.pop()
                bank.clear_row(row)
                bank.overflow_owners.discard(row)
                bank.set_row(row, kind, row, topo, sel, namespaces=nss, ns_any=ns_any, weight=weight,
                             self_match=sm)
                rows.append(row)
        except KeySlotOverflow:
            # the key width grew under the encode: rebuild at the new width;
            # the next admission (or restage) encodes cleanly
            self._rebuild()
            return None
        # selector or namespace truncation: the row under- or over-matches
        # on the device, so its pod goes through the host oracle
        # (TermBank.overflow_owners, keyed here by row)
        overflow = any(r in bank.overflow_owners for r in rows)
        for r in rows:
            bank.overflow_owners.discard(r)
        kinds = frozenset(a[0] for a in rows_args)
        topo_slots = frozenset(int(bank.topo_slot[r]) for r in rows if bank.topo_slot[r] >= 0)
        gen = self._next_gen
        self._next_gen += 1
        entry = TermEntry(tuple(rows), gen, key, aux, kinds, topo_slots, overflow)
        eid = self._next_entry
        self._next_entry += 1
        self._entry_of[key] = eid
        self._entries[eid] = entry
        self.dirty_rows.update(rows)
        self.stats["staged"] += 1
        return entry

    def _acquire(self, pod, sels) -> Optional[Tuple[int, int]]:
        if not self.current_for(self.vocab):
            self._rebuild()
        key = spec_key(pod, sels)
        eid = self._entry_of.get(key)
        if eid is not None:
            e = self._entries[eid]
            e.refs += 1
            self.stats["hits"] += 1
            return eid, e.gen
        e = self._encode_entry(pod, sels, key)
        if e is None:
            return None
        e.refs = 1
        return self._entry_of[key], e.gen

    def acquire(self, pod) -> Optional[Tuple[int, int]]:
        """Intern `pod`'s term set (+1 reference). Returns (entry id, gen),
        or None when it cannot be staged now (an encode overflow while the
        vocab grows, the slab at its ceiling): its batch takes the legacy
        compile."""
        with self._lock:
            sels = self.selectors_fn(pod) if self.selectors_fn is not None else None
            return self._acquire(pod, sels)

    def ensure_entry(self, pod, selectors=_UNSET) -> Optional[Tuple[int, int]]:
        """Intern WITHOUT taking a reference: the dispatch-time restage (the
        PodStage.ensure_row contract). `selectors` overrides selectors_fn:
        the driver passes its dispatch-time getSelectors result so the
        entry's key equals the batch's dedup key."""
        with self._lock:
            if selectors is _UNSET:
                selectors = self.selectors_fn(pod) if self.selectors_fn is not None else None
            pair = self._acquire(pod, selectors)
            if pair is None:
                return None
            e = self._entries[pair[0]]
            e.refs = max(e.refs - 1, 0)
            return pair

    def release(self, eid: int, gen: int) -> None:
        """Drop one reference; at zero the entry's rows free. A stale pair
        is ignored."""
        with self._lock:
            e = self._entries.get(eid)
            if e is None or e.gen != gen:
                return
            e.refs -= 1
            if e.refs <= 0:
                self._entries.pop(eid, None)
                self._entry_of.pop(e.key, None)
                for r in e.rows:
                    self.batch.valid[r] = False
                    self._free.append(r)
                # no live pair names the freed rows: the twin keeps them as
                # they were; their content is cleared when reallocated

    def valid_pair(self, eid: int, gen: int) -> bool:
        with self._lock:
            e = self._entries.get(eid)
            return e is not None and e.gen == gen

    def live_rows_locked(self) -> List[int]:
        """Rows currently allocated: the only rows a gather can read
        (caller holds the lock)."""
        free = set(self._free)
        return [r for r in range(self.capacity) if r not in free]

    def entry_for(self, eid: int, gen: int, key) -> Optional[TermEntry]:
        """The dispatch-time check (caller holds the lock): the pair is live
        AND the entry's key equals the batch's dedup key for the rep — a
        spreading-selector change since admission is a key mismatch."""
        e = self._entries.get(eid)
        if e is None or e.gen != gen or e.key != key:
            return None
        return e
