"""Scheduling queue: the 3-queue design of the reference.

The port's own copy of `kubernetes_tpu.state.queue`, trimmed to what the
batch drain uses, with the same pop order. Reference:
pkg/scheduler/internal/queue/scheduling_queue.go PriorityQueue (:120-152):
  activeQ         — heap ordered by (priority desc, enqueue sequence asc)
  podBackoffQ     — heap ordered by backoff expiry; pods that failed and are
                    waiting out their backoff (flushed to activeQ, :389)
  unschedulableQ  — map of pods that found no node; moved back to activeQ on
                    cluster events (MoveAllToActiveQueue :569) or after the
                    unschedulable timeout (:423, 60s)
plus the move-request cycle counter that closes the race between "pod
determined unschedulable" and "cluster changed meanwhile" (:353-386), and
the nominated-node index of preemption's nominees (nominatedPodMap,
scheduling_queue.go:722): the driver folds the outstanding nominations
into the device bank at dispatch and counts them in the victim search.

Admission-time staging (the ingest and term planes, ref :134-216): with a
staging slab attached, `add` encodes the pod's row (ingest/stage.PodStage)
and interns its term set (terms_plane/stage.TermStage) once, outside the
queue lock, and the entry carries the ready (row, generation) pairs. An
entry's pairs are released only by delete, update or a re-add of its key
— never by pop or bind — and the re-add paths (requeue,
add_unschedulable, requeue_backoff) re-acquire a pair that went stale.
Lock order where both are held: queue lock, then the slab's lock.

Backoff: PodBackoffMap (pod_backoff.go): initial 1s, doubled per attempt,
capped at 10s.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api.types import Pod
from ..oracle.nodeinfo import accumulated_request, pod_non_zero_request
from .tensors import spec_key

INITIAL_BACKOFF = 1.0  # pod_backoff.go initialDuration
MAX_BACKOFF = 10.0  # pod_backoff.go maxDuration
UNSCHEDULABLE_TIMEOUT = 60.0  # scheduling_queue.go unschedulableQTimeInterval


@dataclass
class PodInfo:
    """framework.PodInfo: pod + queue timestamps."""

    pod: Pod
    timestamp: float = 0.0  # time added to the queue
    attempts: int = 0
    seq: int = 0  # monotonic enqueue sequence (tie-break within priority)
    pop_ts: float = 0.0  # time of the last pop
    # the ingest plane's ready staged row and its generation; (-1, -1) = not
    # staged. A generation that no longer matches at dispatch means the row
    # went stale (update or delete between enqueue and pop, a slab rebuild):
    # the pod re-stages or its batch takes the legacy encode, counted.
    staged_row: int = -1
    staged_gen: int = -1
    # the term plane's interned term set: an ENTRY id of the term slab (one
    # per distinct (spec, spreading selectors) pair) and its generation,
    # under the same staleness contract
    term_row: int = -1
    term_gen: int = -1


class _ActiveEntry:
    """activeQ heap node under a QueueSort plugin's comparator (ref :70).
    Default-ordered queues keep plain (neg_priority, seq, key) tuples,
    whose C-level comparison is the same (priority desc, seq asc) order."""

    __slots__ = ("neg_prio", "seq", "key", "info", "less")

    def __init__(self, info: PodInfo, less):
        self.neg_prio = -info.pod.get_priority()
        self.seq = info.seq
        self.key = info.pod.key()
        self.info = info
        self.less = less

    def __lt__(self, other: "_ActiveEntry") -> bool:
        if self.less is not None:
            return bool(self.less(self.info, other.info))
        return (self.neg_prio, self.seq) < (other.neg_prio, other.seq)


def _entry_key(e) -> str:
    """Pod key of a heap entry in either representation."""
    return e[2] if type(e) is tuple else e.key


class PriorityQueue:
    def __init__(self, now: Callable[[], float] = time.monotonic):
        # reentrant: update() of an unknown key adds it under the lock
        self._lock = threading.RLock()
        self._now = now
        self._seq = itertools.count()
        # activeQ entries are (neg_priority, seq, key) tuples: C-level tuple
        # comparison is the (priority desc, seq asc) comparator; under a
        # QueueSort plugin's comparator (`set_queue_sort`), _ActiveEntry nodes
        self._active: List = []  # guarded by self._lock
        self._less = None  # the QueueSort comparator (PodInfo, PodInfo) -> bool; guarded by self._lock
        self._backoff: List[Tuple[float, int, str]] = []  # guarded by self._lock
        self._unschedulable: Dict[str, PodInfo] = {}  # guarded by self._lock
        self._infos: Dict[str, PodInfo] = {}  # guarded by self._lock
        self._in_active: Set[str] = set()  # guarded by self._lock
        self._attempts: Dict[str, int] = {}  # guarded by self._lock
        self._last_failure: Dict[str, float] = {}  # guarded by self._lock
        self._last_move_request_cycle = -1  # guarded by self._lock
        self._scheduling_cycle = 0  # guarded by self._lock
        self.nominated: Dict[str, str] = {}  # guarded by self._lock
        self._nominated_by_node: Dict[str, Set[str]] = {}  # guarded by self._lock
        # bumped whenever a nomination is ADDED (never on clears): a solve
        # whose dispatch folded the nominations is current only while no
        # nomination appeared since (clears only make it conservative)
        self.nomination_adds = 0  # guarded by self._lock
        # the staging slabs (ingest/stage.PodStage, terms_plane/stage.
        # TermStage), attached once before traffic
        self._stage = None  # guarded by self._lock
        self._tstage = None  # guarded by self._lock

    # -- admission-time staging (ingest and term planes) ---------------------

    def attach_stage(self, stage) -> None:
        """Install the ingest plane's pod slab. Entries added before the
        attach re-stage at dispatch (counted)."""
        with self._lock:
            self._stage = stage

    def attach_term_stage(self, stage) -> None:
        """Install the term plane's slab, under attach_stage's contract."""
        with self._lock:
            self._tstage = stage

    def _planes_locked(self):
        """(slab, row attribute, generation attribute) of each attached
        plane: the one list every acquire/release/swap helper walks."""
        out = []
        if self._stage is not None:
            out.append((self._stage, "staged_row", "staged_gen"))
        if self._tstage is not None:
            out.append((self._tstage, "term_row", "term_gen"))
        return out

    @staticmethod
    def _plane_acquire(stage, info: PodInfo, row_attr: str, gen_attr: str) -> None:
        """Acquire one plane's pair for `info` and record it; (-1, -1) when
        the slab cannot stage the pod now."""
        pair = stage.acquire(info.pod)
        if pair is None:
            setattr(info, row_attr, -1)
            setattr(info, gen_attr, -1)
        else:
            setattr(info, row_attr, pair[0])
            setattr(info, gen_attr, pair[1])

    def _stage_acquire(self, info: PodInfo) -> None:
        for stage, row_attr, gen_attr in self._planes_locked():
            self._plane_acquire(stage, info, row_attr, gen_attr)

    def _stage_release(self, info: Optional[PodInfo]) -> None:
        if info is None:
            return
        for stage, row_attr, gen_attr in self._planes_locked():
            row = getattr(info, row_attr)
            if row < 0:
                continue
            stage.release(row, getattr(info, gen_attr))
            setattr(info, row_attr, -1)
            setattr(info, gen_attr, -1)

    def _stage_swap(self, info: PodInfo, new: Pod) -> None:
        """Point an entry at its updated pod and re-stage it, acquiring the
        new pairs before releasing the old: a content-identical update is
        an intern hit on the same row (no re-encode, no generation churn);
        a real spec change lands elsewhere and the old row frees."""
        old = [(stage, getattr(info, row_attr), getattr(info, gen_attr))
               for stage, row_attr, gen_attr in self._planes_locked()]
        info.pod = new
        self._stage_acquire(info)
        for stage, old_row, old_gen in old:
            if old_row >= 0:
                stage.release(old_row, old_gen)

    def _stage_acquire_if_stale(self, info: PodInfo) -> None:
        """On the re-add paths, re-acquire a pair that is missing or no
        longer valid (its row was freed or rebuilt while the entry was
        popped), so one staleness event re-stages once, not at every later
        dispatch."""
        for stage, row_attr, gen_attr in self._planes_locked():
            row = getattr(info, row_attr)
            if row >= 0 and stage.valid_pair(row, getattr(info, gen_attr)):
                continue
            self._plane_acquire(stage, info, row_attr, gen_attr)

    # -- internals -----------------------------------------------------------

    def set_queue_sort(self, less) -> None:
        """Install a QueueSort plugin comparator (ref :262); re-sorts the
        pending entries, switching the heap from the tuple to the
        _ActiveEntry representation when a comparator appears."""
        with self._lock:
            entries = [self._infos[_entry_key(e)] for e in self._active]
            self._less = less
            if less is None:
                self._active = [(-i.pod.get_priority(), i.seq, i.pod.key()) for i in entries]
            else:
                self._active = [_ActiveEntry(i, less) for i in entries]
            heapq.heapify(self._active)

    def _push_active(self, info: PodInfo) -> None:
        key = info.pod.key()
        self._infos[key] = info
        if key in self._in_active:
            return
        if self._less is None:
            heapq.heappush(self._active, (-info.pod.get_priority(), info.seq, key))
        else:
            heapq.heappush(self._active, _ActiveEntry(info, self._less))
        self._in_active.add(key)

    def _backoff_duration(self, key: str) -> float:
        attempts = self._attempts.get(key, 0)
        d = INITIAL_BACKOFF * (2 ** max(attempts - 1, 0))
        return min(d, MAX_BACKOFF)

    def _update_nominated(self, pod: Pod) -> None:
        key = pod.key()
        self._remove_nominated(key)
        node = pod.nominated_node_name
        if node:
            self.nominated[key] = node
            self._nominated_by_node.setdefault(node, set()).add(key)
            self.nomination_adds += 1

    def _remove_nominated(self, key: str) -> None:
        node = self.nominated.pop(key, None)
        if node:
            self._nominated_by_node.get(node, set()).discard(key)

    @staticmethod
    def _warm_memos(pod: Pod) -> None:
        """Warm the pod's request and spec-key memos at enqueue, off the
        batch's critical path; with_node clones carry them."""
        accumulated_request(pod)
        pod_non_zero_request(pod)
        pod.host_ports()
        spec_key(pod)

    def _flush_locked(self) -> None:
        """flushBackoffQCompleted (:389) + flushUnschedulableQLeftover
        (:423)."""
        now = self._now()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, key = heapq.heappop(self._backoff)
            info = self._infos.get(key)
            if info is not None:
                self._push_active(info)
        for key, info in list(self._unschedulable.items()):
            if now - info.timestamp > UNSCHEDULABLE_TIMEOUT:
                del self._unschedulable[key]
                self._push_active(info)

    # -- public API (scheduling_queue.go) -----------------------------------

    def add(self, pod: Pod) -> None:
        """Add: new pending pod → activeQ. With the planes attached the
        pod's row and term set are staged first, outside the queue lock
        (the encode is admission's heavy half; the acquired references keep
        the rows live until the pairs attach), then the previous entry of
        the key releases its pairs."""
        self._warm_memos(pod)
        stage, tstage = self._stage, self._tstage  # attached once, before traffic
        pair = stage.acquire(pod) if stage is not None else None
        tpair = tstage.acquire(pod) if tstage is not None else None
        with self._lock:
            info = PodInfo(pod=pod, timestamp=self._now(), seq=next(self._seq))
            if pair is not None:
                info.staged_row, info.staged_gen = pair
            if tpair is not None:
                info.term_row, info.term_gen = tpair
            # attach the new pairs, then release the old: an identical re-add
            # is an intern hit on the same rows
            self._stage_release(self._infos.get(pod.key()))
            self._unschedulable.pop(pod.key(), None)
            self._push_active(info)
            self._update_nominated(pod)

    def pop_batch(self, max_pods: int) -> List[PodInfo]:
        """Drain up to max_pods from activeQ without blocking — the batch
        entry point for the solver. Preserves pop order."""
        with self._lock:
            self._flush_locked()
            out = []
            now = self._now()
            while self._active and len(out) < max_pods:
                key = _entry_key(heapq.heappop(self._active))
                self._in_active.discard(key)
                info = self._infos[key]
                info.attempts += 1
                info.pop_ts = now
                out.append(info)
            if out:
                self._scheduling_cycle += 1
        return out

    def pop_all_in_groups(self, groups, group_fn: Callable[[Pod], str]) -> List[PodInfo]:
        """Take EVERY queued active pod whose group_fn(pod) is in `groups`,
        whatever the batch size, in pop order: a gang group is decided
        atomically, so a batch holding any member pulls in all the queued
        members (a group straddling the batch boundary would otherwise have
        its first slice bound before the rest was considered). Attempts and
        pop timestamps as pop_batch sets them; the scheduling cycle does
        not advance."""
        with self._lock:
            take = [e for e in self._active if group_fn(self._infos[_entry_key(e)].pod) in groups]
            if not take:
                return []
            taken = {_entry_key(e) for e in take}
            self._active = [e for e in self._active if _entry_key(e) not in taken]
            heapq.heapify(self._active)
            out = []
            now = self._now()
            for e in sorted(take):
                key = _entry_key(e)
                self._in_active.discard(key)
                info = self._infos[key]
                info.attempts += 1
                info.pop_ts = now
                out.append(info)
        return out

    def requeue(self, infos: List[PodInfo]) -> None:
        """Return popped-but-unsolved pods to activeQ with their enqueue
        sequence kept, so they pop again in the same order (no backoff)."""
        with self._lock:
            for info in infos:
                self._stage_acquire_if_stale(info)
                self._unschedulable.pop(info.pod.key(), None)
                self._push_active(info)

    def add_unschedulable(self, info: PodInfo, pod_scheduling_cycle: Optional[int] = None) -> None:
        """AddUnschedulableIfNotPresent (:353): if a move request arrived
        since this pod's cycle started, go to backoffQ (retry soon) instead
        of unschedulableQ (wait for an event)."""
        with self._lock:
            key = info.pod.key()
            self._stage_acquire_if_stale(info)
            self._attempts[key] = self._attempts.get(key, 0) + 1
            self._last_failure[key] = self._now()
            cycle = pod_scheduling_cycle if pod_scheduling_cycle is not None else self._scheduling_cycle
            self._infos[key] = info
            if self._last_move_request_cycle >= cycle:
                expiry = self._now() + self._backoff_duration(key)
                heapq.heappush(self._backoff, (expiry, info.seq, key))
            else:
                info.timestamp = self._now()
                self._unschedulable[key] = info
            self._update_nominated(info.pod)

    def requeue_backoff(self, info: PodInfo) -> None:
        """Bind-failure requeue: always the backoff tier with per-pod
        exponential backoff (1s → 10s), never unschedulableQ."""
        with self._lock:
            key = info.pod.key()
            self._stage_acquire_if_stale(info)
            self._attempts[key] = self._attempts.get(key, 0) + 1
            self._last_failure[key] = self._now()
            self._unschedulable.pop(key, None)
            self._infos[key] = info
            expiry = self._now() + self._backoff_duration(key)
            heapq.heappush(self._backoff, (expiry, info.seq, key))
            self._update_nominated(info.pod)

    def delete(self, pod: Pod) -> None:
        """Delete (ref :560): the entry leaves every sub-queue and releases
        its staged pairs; a popped copy still in flight then sees the
        generation mismatch at dispatch and re-stages (counted)."""
        with self._lock:
            key = pod.key()
            self._stage_release(self._infos.get(key))
            self._infos.pop(key, None)
            self._unschedulable.pop(key, None)
            self._in_active.discard(key)
            self._attempts.pop(key, None)
            self._last_failure.pop(key, None)
            self._remove_nominated(key)
            self._active = [e for e in self._active if _entry_key(e) != key]
            heapq.heapify(self._active)
            if any(k == key for _, _, k in self._backoff):
                self._backoff = [t for t in self._backoff if t[2] != key]
                heapq.heapify(self._backoff)

    def update(self, old: Pod, new: Pod) -> None:
        """Update (ref :582): an unschedulable entry moves back to activeQ,
        a queued one keeps its place; either re-stages (`_stage_swap`). An
        unknown key is added."""
        self._warm_memos(new)
        with self._lock:
            key = new.key()
            if key in self._unschedulable:
                info = self._unschedulable.pop(key)
                self._stage_swap(info, new)
                self._push_active(info)
            elif key in self._infos:
                self._stage_swap(self._infos[key], new)
            else:
                self.add(new)
            self._update_nominated(new)

    def scheduling_cycle(self) -> int:
        with self._lock:
            return self._scheduling_cycle

    def move_all_to_active(self) -> None:
        """MoveAllToActiveQueue (:569): a cluster event may have made
        unschedulable pods feasible."""
        with self._lock:
            now = self._now()
            for key, info in list(self._unschedulable.items()):
                expiry = self._last_failure.get(key, 0.0) + self._backoff_duration(key)
                if expiry <= now:
                    self._push_active(info)
                else:
                    heapq.heappush(self._backoff, (expiry, info.seq, key))
            self._unschedulable.clear()
            self._last_move_request_cycle = self._scheduling_cycle

    # -- nominated pods (preemption nominees) --------------------------------

    def clear_nomination(self, key: str) -> None:
        """Drop a pending pod's nomination (the preempt 'clear' list,
        generic_scheduler.go:346-360: lower-priority nominees of a node just
        claimed by a higher-priority preemptor)."""
        with self._lock:
            self._remove_nominated(key)
            info = self._infos.get(key)
            if info is not None:
                info.pod.nominated_node_name = ""

    def clear_nominations(self, keys) -> None:
        """clear_nomination for many keys under one lock (the bulk commit's
        DeleteNominatedPodIfExists at assume, scheduler.go:529)."""
        with self._lock:
            for key in keys:
                self._remove_nominated(key)
                info = self._infos.get(key)
                if info is not None:
                    info.pod.nominated_node_name = ""

    def nomination_extras(self, exclude_keys) -> List[Tuple[str, Pod]]:
        """Outstanding (node, pod) nominations except the given keys: the
        driver folds these into the device bank at dispatch (podFitsOnNode's
        pass-1 nominee accounting, generic_scheduler.go:620-630; a batch's
        own nominees are sequenced by the solve's carry, so only the others
        are listed)."""
        with self._lock:
            return [
                (node, self._infos[k].pod)
                for k, node in self.nominated.items()
                if k not in exclude_keys and k in self._infos
            ]

    def has_nominations(self) -> bool:
        """True if any pod nominates a node (empty sets left by clears do
        not count)."""
        with self._lock:
            return any(self._nominated_by_node.values())

    def nominated_pods_for_node(self, node: str) -> List[Pod]:
        with self._lock:
            return [
                self._infos[k].pod
                for k in self._nominated_by_node.get(node, set())
                if k in self._infos
            ]

    def counts(self) -> Tuple[int, int, int]:
        """(active, backoff, unschedulable) depths."""
        with self._lock:
            return len(self._active), len(self._backoff), len(self._unschedulable)
