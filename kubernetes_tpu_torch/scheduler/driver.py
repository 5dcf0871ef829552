"""Scheduler driver: the batch scheduling loop.

The port's lean copy of `kubernetes_tpu/scheduler/driver.py`, reproducing
the reference's plain path with every plane off (no commit/fold/ingest/term
plane, no speculation, no preemption). Per batch:

    pop_batch → TensorMirror.sync → spec dedup (with the pods' spreading
    selectors) → PodBatch encode + compile_batch_terms → device_arrays
    (node, signature and pattern banks) → one solve_pipeline (filter,
    score, topology and greedy-solve kernels, with the solver's in-batch
    anti-affinity / host-port tracking once a batch needs it) → commit in
    pop order: assume + async bind for a node, add_unschedulable for -1

The topology terms this port runs: ScheduleAnyway spread constraints,
SelectorSpread (`set_spread_selectors_fn`), required pod anti-affinity,
preferred pod (anti-)affinity, host ports, and existing pods carrying any
pod (anti-)affinity. None of them needs a host re-check here (see
`_commit`). Anything else raises NotImplementedError naming its ROADMAP.md
item instead of taking another route: pods the reference re-checks in
full (required pod affinity, DoNotSchedule spread), encoding-overflow pods
(term-table overflow included), existing pods whose terms overflow a
pattern row, -1 pods while some node rows fell back to the host oracle,
preemption nominees and gang groups. The batch is returned to the queue
first.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..api.types import DO_NOT_SCHEDULE, Pod
from ..device import resolve_device
from ..ops import filters as F
from ..ops.pipeline import SolveConfig, solve_pipeline
from ..ops.solver import prng_key_data
from ..state.cache import SchedulerCache, TensorMirror
from ..state.convert import arrays_to_torch
from ..state.queue import PodInfo, PriorityQueue
from ..state.terms import (
    AFF_PREF,
    AFF_REQ,
    ANTI_PREF,
    ANTI_REQ,
    SEL_SPREAD,
    SPREAD_HARD,
    SPREAD_SOFT,
    TermBank,
    compile_batch_terms,
    count_batch_terms,
)
from ..state.tensors import KeySlotOverflow, PodBatch, _bucket, dedup_specs

# the coscheduling PodGroup marker the reference's gang path reads
POD_GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io/name"

# bind pool threads; a batch's binds are split into this many chunks
BIND_WORKERS = 8


@dataclass
class ScheduleResult:
    scheduled: int = 0
    unschedulable: int = 0
    assignments: Dict[str, str] = field(default_factory=dict)


class Binder:
    """Default binder: callable hook (pod, node_name) -> None, raising on
    failure — the equivalent of POST pods/<p>/binding (factory.go:713)."""

    def __init__(self, bind_fn: Optional[Callable[[Pod, str], None]] = None):
        self._fn = bind_fn

    def bind(self, pod: Pod, node_name: str) -> None:
        if self._fn is not None:
            self._fn(pod, node_name)


RECHECK_NONE = 0
RECHECK_LIGHT = 1  # validate against THIS BATCH's commits only
RECHECK_FULL = 2  # full scalar oracle pass


def _recheck_level(pod: Pod) -> int:
    """How much validation the reference gives a pod's device placement
    against earlier commits of the same batch (its driver's
    `_recheck_level`). FULL: DoNotSchedule spread (commits shift domain
    counts) or required pod affinity (the anchor may be an in-batch
    commit). LIGHT: required anti-affinity or host ports — only the
    batch's commits can break them. ScheduleAnyway spread and preferred
    affinity shift only scores (batch-stale scores are the batching
    contract)."""
    a = pod.affinity
    if any(c.when_unsatisfiable == DO_NOT_SCHEDULE for c in pod.topology_spread_constraints):
        return RECHECK_FULL
    if a is not None and a.pod_affinity is not None and a.pod_affinity.required:
        return RECHECK_FULL
    if a is not None and a.pod_anti_affinity is not None and a.pod_anti_affinity.required:
        return RECHECK_LIGHT
    if pod.host_ports():
        return RECHECK_LIGHT
    return RECHECK_NONE


def _unported_reason(pod: Pod) -> Optional[str]:
    """Why this pod needs a program the port does not have yet, or None."""
    if _recheck_level(pod) == RECHECK_FULL:
        if any(c.when_unsatisfiable == DO_NOT_SCHEDULE for c in pod.topology_spread_constraints):
            return ("DoNotSchedule spread constraints need ops/topology spread_filter with the "
                    "commit arbiter (ROADMAP.md queue 1, arbiter slice)")
        return ("required pod affinity needs the host oracle's full re-check of in-batch anchors "
                "(ROADMAP.md queue 1, oracle fallback)")
    if POD_GROUP_LABEL in pod.labels or POD_GROUP_LABEL in pod.annotations:
        return "gang groups need solve_gang (ROADMAP.md queue 1, gang)"
    return None


def _term_kind_names(present, any_sel_spread: bool, etb) -> frozenset:
    """(batch term-kind ints, sel-spread flag, existing-pods PatternBank) →
    the kind names mask_and_score gates its topology programs on (the
    reference's `_term_kind_names`). Exact: a kind absent here means its
    program would compute its identity."""
    kinds = set()
    if SPREAD_HARD in present:
        kinds.add("spread_hard")
    if SPREAD_SOFT in present:
        kinds.add("spread_soft")
    if AFF_REQ in present:
        kinds.add("aff_req")
    if ANTI_REQ in present:
        kinds.add("anti_req")
    if AFF_PREF in present or ANTI_PREF in present:
        kinds.add("pref")
    if SEL_SPREAD in present or any_sel_spread:
        kinds.add("sel_spread")
    et_present = set(np.unique(etb.kind[etb.valid]).tolist())
    if ANTI_REQ in et_present:
        kinds.add("et_anti")
    if et_present & {AFF_REQ, AFF_PREF, ANTI_PREF}:
        kinds.add("et_score")
    return frozenset(kinds)


class Scheduler:
    """The batch driver on one device: the card unless `device="cpu"`."""

    def __init__(
        self,
        cache: Optional[SchedulerCache] = None,
        queue: Optional[PriorityQueue] = None,
        binder: Optional[Binder] = None,
        batch_size: int = 256,
        deterministic: bool = False,
        seed: int = 0,
        solve_config: Optional[SolveConfig] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cache = cache or SchedulerCache()
        self.queue = queue or PriorityQueue()
        self.binder = binder or Binder()
        self.batch_size = batch_size
        self.deterministic = deterministic
        self.solve_config = solve_config
        self.mirror = TensorMirror(self.cache, self.device)
        self._rng_seed = seed
        # one tie-break key per dispatch: the reference's
        # PRNGKey(seed + cycle), cycle advancing once per dispatch
        self._cycle = 0
        # monotone shape buckets, as the reference keeps them: pods, spec
        # rows, term rows and the topology segment axis
        self._b_bucket = 16
        self._u_bucket = 16
        self._t_bucket = 16
        self._v_bucket = 16
        # monotone union of the term kinds seen (a superset is exact: an
        # absent kind's program computes its identity)
        self._term_kinds: frozenset = frozenset()
        # monotone: once a batch carries required anti-affinity or host
        # ports, every later solve tracks in-batch conflicts (exact without
        # them too)
        self._track_inbatch = False
        self._spread_selectors_fn: Optional[Callable[[Pod], list]] = None
        self._ids: Optional[Dict[str, int]] = None
        self._bind_pool = ThreadPoolExecutor(max_workers=BIND_WORKERS, thread_name_prefix="bind")
        self._closed = False
        # per-stage wall-clock seconds (host clock; solve_s ends at the
        # assignment's device→host copy, so it includes the device work)
        self.stats: Dict[str, float] = {
            "sync_s": 0.0, "encode_s": 0.0, "solve_s": 0.0, "commit_s": 0.0, "batches": 0,
            "tracked_batches": 0,
        }

    def set_spread_selectors_fn(self, fn: Callable[[Pod], list]) -> None:
        """Install the getSelectors equivalent (the Service / RC / RS /
        StatefulSet selectors that select a pod, selector_spreading.go
        getSelectors) used for SelectorSpread scoring."""
        self._spread_selectors_fn = fn

    # -- one batch -----------------------------------------------------------

    def _refuse(self, infos: List[PodInfo], reason: str) -> None:
        self.queue.requeue(infos)
        raise NotImplementedError(reason)

    def _check_slice(self, infos: List[PodInfo]) -> None:
        if self.queue.has_nominations():
            self._refuse(infos, "preemption nominees need ops/preempt (ROADMAP.md queue 1, preemption)")
        for info in infos:
            reason = _unported_reason(info.pod)
            if reason is not None:
                self._refuse(infos, f"pod {info.pod.key()}: {reason}")

    def _encode(self, infos: List[PodInfo]) -> Tuple[PodBatch, List[Pod], np.ndarray, TermBank, Dict[str, np.ndarray]]:
        """Collapse the batch to unique pod specs (replicas share one
        mask/score row; pods behind different selectors never do), encode
        one PodBatch row per spec, and compile the specs' topology terms
        into a TermBank sized by the monotone term bucket."""
        pods = [info.pod for info in infos]
        selectors = None
        if self._spread_selectors_fn is not None:
            selectors = {id(p): self._spread_selectors_fn(p) for p in pods}
        reps, sig_list = dedup_specs(pods, selectors)
        self._u_bucket = max(self._u_bucket, _bucket(len(reps)))
        vocab = self.mirror.vocab
        while True:
            try:
                batch = PodBatch(vocab, self._u_bucket)
                for i, p in enumerate(reps):
                    batch.set_pod(i, p)
                # size the term bucket BEFORE compiling: one compile at the
                # final capacity
                self._t_bucket = max(self._t_bucket, _bucket(max(count_batch_terms(reps, selectors), 1)))
                tb, aux = compile_batch_terms(
                    vocab, reps, spread_selectors=selectors,
                    capacity=self._t_bucket, b_capacity=self._u_bucket,
                )
                self._t_bucket = max(self._t_bucket, tb.capacity)
                break
            except KeySlotOverflow:
                self.mirror._rebuild()
        if batch.fallback[: len(reps)].any():
            self._refuse(
                infos,
                "a pod's structures overflow the encoding: the host oracle path is "
                "not ported (ROADMAP.md queue 1, oracle fallback)",
            )
        if tb.overflow_owners:
            self._refuse(
                infos,
                "a pod's topology terms overflow the term table: the host oracle path is "
                "not ported (ROADMAP.md queue 1, oracle fallback)",
            )
        return batch, reps, np.asarray(sig_list, np.int32), tb, aux

    def _topology_shape(self, tb: TermBank, aux: Dict[str, np.ndarray], reps: List[Pod]) -> None:
        """Grow the monotone term-kind union, the segment-axis bucket and
        the in-batch tracking switch for this batch's terms. The axis
        covers the dense values of every slot a batch term or an existing
        pattern names plus the zones (the SelectorSpread blend); it is not
        clamped to the node count, since dense ids are grow-only and live
        ones can exceed it under node churn."""
        pats = self.mirror.pats
        present = set(np.unique(tb.kind[tb.valid]).tolist())
        self._term_kinds = self._term_kinds | _term_kind_names(
            present, bool(np.any(aux["n_sel_spread"] > 0)), pats
        )
        self._track_inbatch = self._track_inbatch or (
            "anti_req" in self._term_kinds or any(p.host_ports() for p in reps)
        )
        vocab = self.mirror.vocab
        slots = set(np.asarray(tb.topo_slot[tb.valid], np.int64).tolist())
        slots |= set(np.asarray(pats.bank.topo_slot[pats.valid], np.int64).tolist())
        needed = [vocab.dense_size(int(sl)) for sl in slots if sl >= 0]
        needed.append(vocab.zone_count())
        self._v_bucket = max(self._v_bucket, _bucket(max(needed + [1])))

    def schedule_batch(self, max_pods: Optional[int] = None) -> ScheduleResult:
        res = ScheduleResult()
        infos = self.queue.pop_batch(max_pods or self.batch_size)
        if not infos:
            return res
        self._check_slice(infos)
        cycle = self.queue.scheduling_cycle()
        self.stats["batches"] += 1
        pods = [pi.pod for pi in infos]

        t0 = time.perf_counter()
        self.mirror.sync()
        t1 = time.perf_counter()
        self.stats["sync_s"] += t1 - t0
        if self.mirror.pats.overflow_rows:
            self._refuse(
                infos,
                "an existing pod's affinity term overflows its pattern row: the host oracle "
                "re-check is not ported (ROADMAP.md queue 1, oracle fallback)",
            )

        self._b_bucket = max(self._b_bucket, _bucket(len(pods)))
        batch, reps, sig, tb, aux = self._encode(infos)
        self._topology_shape(tb, aux, reps)
        pb = {
            "sig": np.zeros(self._b_bucket, np.int32),
            "valid": np.zeros(self._b_bucket, bool),
            "priority": np.zeros(self._b_bucket, np.int32),
        }
        pb["sig"][: len(pods)] = sig
        pb["valid"][: len(pods)] = True
        pb["priority"][: len(pods)] = [p.get_priority() for p in pods]
        if self._ids is None:
            self._ids = F.make_ids(self.mirror.vocab)  # interned constants; stable
        pa = arrays_to_torch(batch.arrays(), self.device)
        pbt = arrays_to_torch(pb, self.device)
        ta = arrays_to_torch(tb.arrays(), self.device)
        au = arrays_to_torch(aux, self.device)
        t2 = time.perf_counter()
        self.stats["encode_s"] += t2 - t1

        self._cycle += 1
        key = prng_key_data(self._rng_seed + self._cycle)
        na, ea, xa = self.mirror.device_arrays()
        assign, _ = solve_pipeline(
            na, pa, self._ids, key, pb=pbt, deterministic=self.deterministic,
            config=self.solve_config, term_kinds=self._term_kinds,
            track_inbatch=self._track_inbatch,
            ea=ea, ta=ta, au=au, xa=xa, n_buckets=self._v_bucket,
        )
        if self._track_inbatch:
            self.stats["tracked_batches"] += 1
        assign_l = assign.cpu().numpy()[: len(pods)].tolist()
        t3 = time.perf_counter()
        self.stats["solve_s"] += t3 - t2

        if any(r < 0 for r in assign_l) and bool((self.mirror.nodes.fallback & self.mirror.nodes.valid).any()):
            self._refuse(
                infos,
                "unplaced pods while node rows fall back to the host oracle: the oracle "
                "path is not ported (ROADMAP.md queue 1, oracle fallback)",
            )
        self._commit(infos, assign_l, cycle, res)
        self.stats["commit_s"] += time.perf_counter() - t3
        return res

    def _commit(self, infos: List[PodInfo], assign_l: List[int], cycle: int, res: ScheduleResult) -> None:
        """The reference's bulk commit, in pop order: -1 pods go back as
        unschedulable, the rest are assumed in one cache call and bound on
        the bind pool in chunks.

        The reference gives pods with required anti-affinity or host ports
        (RECHECK_LIGHT) a re-check against the batch's earlier commits
        only while the solve did not track them, or after a commit left
        the device's pick (`tracked_ok`). Here every batch with such pods
        is solved with the in-batch tracking on, and no pod is ever
        re-placed (the pods that would need the oracle are refused before
        the solve), so that re-check is vacuous and the bulk commit
        places exactly what its per-pod loop would. For the same reason
        a -1 stands: feasibility only shrinks within the batch."""
        name_of = self.mirror.name_of_row
        assumed_meta: List[Tuple[PodInfo, Pod, str]] = []
        for info, row in zip(infos, assign_l):
            node_name = name_of[row] if row >= 0 else None
            if node_name is None:
                res.unschedulable += 1
                self._fail(info, cycle)
                continue
            assumed_meta.append((info, info.pod.with_node(node_name), node_name))
        rejected = set(self.cache.assume_pods([m[1] for m in assumed_meta]))
        jobs = []
        for j, (info, assumed, node_name) in enumerate(assumed_meta):
            if j in rejected:  # the key is already in the cache
                res.unschedulable += 1
                self._fail(info, cycle)
                continue
            jobs.append((info, assumed, node_name))
            res.assignments[info.pod.key()] = node_name
        res.scheduled += len(jobs)
        step = max(1, -(-len(jobs) // BIND_WORKERS))
        for i in range(0, len(jobs), step):
            self._bind_pool.submit(self._bind_chunk, jobs[i : i + step])

    def _fail(self, info: PodInfo, cycle: int) -> None:
        self.queue.add_unschedulable(info, cycle)

    def _bind_chunk(self, items: List[Tuple[PodInfo, Pod, str]]) -> None:
        """Bind a chunk; a failed bind forgets the assume and retries the
        pod through the backoff tier (MakeDefaultErrorFunc)."""
        finished: List[Pod] = []
        for info, assumed, node_name in items:
            try:
                self.binder.bind(info.pod, node_name)
            except Exception:  # the bind RPC failed: forget + requeue
                self.cache.forget_pod(assumed)
                self.queue.requeue_backoff(info)
                continue
            finished.append(assumed)
        self.cache.finish_bindings(finished)

    # -- loop and lifecycle --------------------------------------------------

    def run_until_empty(self, max_cycles: int = 1000) -> ScheduleResult:
        total = ScheduleResult()
        for _ in range(max_cycles):
            r = self.schedule_batch()
            total.scheduled += r.scheduled
            total.unschedulable += r.unschedulable
            total.assignments.update(r.assignments)
            if r.scheduled == 0 and r.unschedulable == 0:
                break
        return total

    def wait_for_binds(self) -> None:
        """Drain the bind pool (tests/benchmarks); no-op after close()."""
        if self._closed:
            return
        self._bind_pool.shutdown(wait=True)
        self._bind_pool = ThreadPoolExecutor(max_workers=BIND_WORKERS, thread_name_prefix="bind")

    def close(self) -> None:
        """Finish in-flight binds and retire the bind pool. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._bind_pool.shutdown(wait=True)
