"""Scheduler driver: the batch scheduling loop.

The port's lean copy of `kubernetes_tpu/scheduler/driver.py`, reproducing
the reference's default commit path — the commit and fold planes on and
preemption on, no ingest or term plane, no speculation. Per batch:

    pop_batch → TensorMirror.sync → spec dedup (with the pods' spreading
    selectors) → PodBatch encode + compile_batch_terms → device_arrays
    (node, signature and pattern banks) → the outstanding preemption
    nominees folded onto the node bank's usage columns → one
    solve_pipeline (filter, score, topology and greedy-solve kernels, with
    the solver's in-batch anti-affinity / host-port tracking once a batch
    needs it) → the commit arbiter when a pod needs a full re-check → the
    nominee overlay taken off → commit in pop order → one batched
    preemption round for the pods that fit nowhere

and the commit takes one of two routes, picked per batch from its pods:

* the bulk path (no DoNotSchedule pod): -1 pods go back as
  unschedulable, the rest are assumed in one cache call and bound on the
  bind pool in chunks. Required anti-affinity and host ports take it too:
  their batches are solved with the in-batch tracking, which leaves the
  arbiter nothing to defer (see `_commit_bulk`);
* the arbitrated path (a DoNotSchedule pod in the batch): the arbiter's
  verdicts (commit/arbiter.py) place, defer to the next batch (re-queued
  without backoff) or fail each pod; the placed ones are assumed and
  bound as on the bulk path.

On both, the fold plane scatters the placed pods' deltas into the
device-resident banks (ops/fold, commit/fold) and tags the assumes as
folded, so the mirror does not re-ship those rows. `commit_plane=False`
turns the arbiter and the fold off (the reference's per-pod commit
places the same pods: every batch then takes the bulk path, re-shipping
its rows).

Preemption (`enable_preemption`, on by default as in the reference): the
pods a batch could not place go through one device victim search
(scheduler/preemption.batch_preempt_device → ops/preempt.preempt_batch),
each plan is re-verified on the host against the live node, and the
victims are deleted and the pod nominated to the node; the next batches
see the outstanding nominations folded onto the node bank's usage columns
(ops/fold.fold_usage: in place with the commit plane on, on a copy with
it off), as podFitsOnNode's pass 1 counts them.

Anything else raises NotImplementedError naming its ROADMAP.md item
instead of taking another route: pods the reference re-checks with its
full host oracle (required pod affinity; DoNotSchedule spread with the
commit plane off; a pod the arbiter defers three times in a row),
encoding-overflow pods (term-table overflow included), existing pods
whose terms overflow a pattern row, -1 pods while some node rows fell back
to the host oracle, batches the reference re-checks per pod against the
outstanding nominations (a pod that is not resource-only while a
nomination is outstanding), preemption for a pod with (anti-)affinity or
spread terms when a candidate node holds a victim, and gang groups. The
batch is returned to the queue first.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..api.types import DO_NOT_SCHEDULE, Pod
from ..commit.arbiter import V_DEFER, V_PLACE, arbitrate, kinds_covered
from ..commit.fold import plan_fold
from ..device import resolve_device
from ..ops import filters as F
from ..ops.fold import fold_usage
from ..ops.pipeline import SolveConfig, solve_pipeline
from ..ops.solver import prng_key_data
from ..oracle.nodeinfo import accumulated_request
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
from ..state.tensors import KeySlotOverflow, PodBatch, _bucket, _req_slot_pairs, dedup_specs
from . import preemption as preemption_mod

_log = logging.getLogger(__name__)

# the coscheduling PodGroup marker the reference's gang path reads
POD_GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io/name"

# bind pool threads; a batch's binds are split into this many chunks
BIND_WORKERS = 8


@dataclass
class ScheduleResult:
    scheduled: int = 0
    unschedulable: int = 0
    preempted: int = 0  # failed pods whose preemption deleted victims and nominated a node
    deferred: int = 0  # arbiter V_DEFER: re-queued for the next batch
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


ORACLE_FALLBACK = "ROADMAP.md queue 1, oracle fallback"


def _unported_reason(pod: Pod, commit_plane: bool) -> Optional[str]:
    """Why this pod needs a program the port does not have yet, or None."""
    if _recheck_level(pod) == RECHECK_FULL:
        a = pod.affinity
        if a is not None and a.pod_affinity is not None and a.pod_affinity.required:
            return ("required pod affinity needs the host oracle's full re-check of in-batch anchors "
                    f"({ORACLE_FALLBACK})")
        if not commit_plane:
            return ("DoNotSchedule spread constraints with the commit plane off need the host oracle's "
                    f"full re-check ({ORACLE_FALLBACK})")
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
        commit_plane: bool = True,
        enable_preemption: bool = True,
        pdb_lister: Optional[Callable[[], list]] = None,
        delete_fn: Optional[Callable[[Pod], None]] = None,
        nominate_fn: Optional[Callable[[Pod, str], None]] = None,
    ):
        self.device = resolve_device(device)
        # the arbiter's verdicts for DoNotSchedule batches and the commits
        # folded into the device banks (the reference's commit and fold
        # planes, which it turns on together by default)
        self.commit_plane = commit_plane
        self.cache = cache or SchedulerCache()
        self.queue = queue or PriorityQueue()
        self.binder = binder or Binder()
        self.batch_size = batch_size
        self.deterministic = deterministic
        self.solve_config = solve_config
        # a Policy-restricted predicate set sends preemption to the
        # reference's full predicate chain (refused here)
        self._enabled_preds = solve_config.predicates if solve_config is not None else None
        self.enable_preemption = enable_preemption
        # PodDisruptionBudgets for the victim search; the victim delete (an
        # API delete whose informer echo removes the pod; without one the
        # cache removes it) and the nominatedNodeName status write
        self.pdb_lister = pdb_lister or (lambda: [])
        self.delete_fn = delete_fn
        self.nominate_fn = nominate_fn
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
        # monotone pattern-triple bucket of the commit fold's [T] axis
        self._fp_bucket = 16
        self._spread_selectors_fn: Optional[Callable[[Pod], list]] = None
        self._ids: Optional[Dict[str, int]] = None
        self._bind_pool = ThreadPoolExecutor(max_workers=BIND_WORKERS, thread_name_prefix="bind")
        # a pod deferred this many times in a row escalates to the host
        # oracle's re-placement in the reference (refused here)
        self._defer_counts: Dict[str, int] = {}
        self._defer_escalate = 3
        self._closed = False
        # per-stage wall-clock seconds (host clock; solve_s ends at the
        # device→host copy of the assignment and the verdicts, so it
        # includes the device work) and the planes' counters, under the
        # reference's names; fold_overflow_batches counts the folds a bank
        # overflow sent back to the host re-ship (plan_fold → None); apply_s
        # is the arbitrated batches' fold, assume and bind submission;
        # preempt_batches counts the batched preemption rounds, preempted
        # the pods whose preemption was applied, victims the pods deleted,
        # preempt_s the rounds' seconds, preempt_reverify_miss the device
        # plans the host re-verification rejected, nominee_folds the
        # dispatches that overlaid outstanding nominations
        self.stats: Dict[str, float] = {
            "sync_s": 0.0, "encode_s": 0.0, "solve_s": 0.0, "commit_s": 0.0, "batches": 0,
            "tracked_batches": 0, "fold_batches": 0, "fold_pods": 0, "fold_s": 0.0,
            "fold_overflow_batches": 0, "arbiter_batches": 0, "arbiter_place": 0, "arbiter_defer": 0,
            "arbiter_escalated": 0, "apply_s": 0.0, "preempt_batches": 0, "preempted": 0, "victims": 0,
            "preempt_s": 0.0, "preempt_reverify_miss": 0, "nominee_folds": 0,
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
        for info in infos:
            reason = _unported_reason(info.pod, self.commit_plane)
            if reason is not None:
                self._refuse(infos, f"pod {info.pod.key()}: {reason}")
        # with a nomination outstanding the reference commits a batch in
        # bulk only when every pod is resource-only; any other batch takes
        # its per-pod loop, which re-checks picks on nominated nodes with
        # the host oracle (fits_considering_nominated)
        if self.queue.has_nominations():
            for info in infos:
                if _recheck_level(info.pod) != RECHECK_NONE:
                    self._refuse(infos, f"pod {info.pod.key()} while a preemption nomination is outstanding needs "
                                        f"the host oracle's nominee re-check ({ORACLE_FALLBACK})")

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

    def _topology_shape(self, tb: TermBank, aux: Dict[str, np.ndarray], reps: List[Pod]) -> frozenset:
        """Grow the monotone term-kind union, the segment-axis bucket and
        the in-batch tracking switch for this batch's terms; returns the
        batch's own term kinds. The axis covers the dense values of every
        slot a batch term or an existing pattern names plus the zones (the
        SelectorSpread blend); it is not clamped to the node count, since
        dense ids are grow-only and live ones can exceed it under node
        churn."""
        pats = self.mirror.pats
        present = set(np.unique(tb.kind[tb.valid]).tolist())
        kinds = _term_kind_names(present, bool(np.any(aux["n_sel_spread"] > 0)), pats)
        self._term_kinds = self._term_kinds | kinds
        self._track_inbatch = self._track_inbatch or (
            "anti_req" in self._term_kinds or any(p.host_ports() for p in reps)
        )
        vocab = self.mirror.vocab
        slots = set(np.asarray(tb.topo_slot[tb.valid], np.int64).tolist())
        slots |= set(np.asarray(pats.bank.topo_slot[pats.valid], np.int64).tolist())
        needed = [vocab.dense_size(int(sl)) for sl in slots if sl >= 0]
        needed.append(vocab.zone_count())
        self._v_bucket = max(self._v_bucket, _bucket(max(needed + [1])))
        return kinds

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
                f"re-check is not ported ({ORACLE_FALLBACK})",
            )

        self._b_bucket = max(self._b_bucket, _bucket(len(pods)))
        batch, reps, sig, tb, aux = self._encode(infos)
        batch_kinds = self._topology_shape(tb, aux, reps)
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
        # outstanding nominations of pods outside the batch reserve their
        # nodes in this solve; nomination_adds tells the commit whether one
        # appeared since
        nom_adds = self.queue.nomination_adds
        if self.queue.has_nominations():
            na = self._nominee_overlay(na, pods)
        solved: Dict = {}
        assign, _ = solve_pipeline(
            na, pa, self._ids, key, pb=pbt, deterministic=self.deterministic,
            config=self.solve_config, term_kinds=self._term_kinds,
            track_inbatch=self._track_inbatch,
            ea=ea, ta=ta, au=au, xa=xa, n_buckets=self._v_bucket, arbiter_inputs=solved,
        )
        if self._track_inbatch:
            self.stats["tracked_batches"] += 1
        # the commit arbiter, chained on the assignment on the device, for
        # the batches it can change: those holding a RECHECK_FULL pod (the
        # others are the bulk path's), when it covers their term kinds
        full = any(_recheck_level(r) == RECHECK_FULL for r in reps)
        verdict = None
        if self.commit_plane and full and kinds_covered(batch_kinds):
            verdict = arbitrate(na, pa, ea, ta, self._ids, assign, pbt,
                                term_kinds=self._term_kinds, n_buckets=self._v_bucket, inputs=solved)
        assign_l = assign.cpu().numpy()[: len(pods)].tolist()
        verdicts = None if verdict is None else verdict.cpu().numpy()[: len(pods)].tolist()
        # the overlay's job ends with the solve: the resident banks mirror
        # the host again before any commit fold or row patch lands on them
        self.mirror.unfold_nominees()
        t3 = time.perf_counter()
        self.stats["solve_s"] += t3 - t2

        if any(r < 0 for r in assign_l) and bool((self.mirror.nodes.fallback & self.mirror.nodes.valid).any()):
            self._refuse(
                infos,
                "unplaced pods while node rows fall back to the host oracle: the oracle "
                f"path is not ported ({ORACLE_FALLBACK})",
            )
        # the reference's routes: the arbiter's verdicts where
        # `_arbiter_covers` holds — here that is "the arbiter ran": its
        # other conditions (encoding overflow, -1 pods beside fallback
        # rows, nominations) are refused above and speculation is absent —
        # else the bulk path, which a DoNotSchedule pod cannot take
        if verdicts is not None:
            self._commit_arbitrated(infos, assign_l, verdicts, cycle, res)
        elif full:
            self._refuse(infos, f"the batch's DoNotSchedule pods need the host oracle's re-check ({ORACLE_FALLBACK})")
        elif self.queue.has_nominations() and nom_adds != self.queue.nomination_adds:
            # a nomination appeared after the dispatch folded them: the
            # reference re-checks per pod (never without speculation)
            self._refuse(infos, f"a nomination appeared after the solve ({ORACLE_FALLBACK})")
        else:
            self._commit_bulk(infos, assign_l, cycle, res)
        self.stats["commit_s"] += time.perf_counter() - t3
        return res

    def _commit_bulk(self, infos: List[PodInfo], assign_l: List[int], cycle: int, res: ScheduleResult) -> None:
        """The reference's bulk commit, in pop order: -1 pods go back as
        unschedulable, the rest are applied (`_apply`).

        This path also takes batches with required anti-affinity or host
        ports (RECHECK_LIGHT), where the reference arbitrates (commit plane
        on) or re-checks each pod against the batch's earlier commits
        (off) while the solve did not track them, or after a commit left
        the device's pick (`tracked_ok`). Here every batch with such pods
        is solved with the in-batch tracking on, which serializes exactly
        the capacity, anti-affinity and host-port conflicts the arbiter
        checks, and no pod is ever re-placed (the pods that would need the
        oracle are refused before the solve): the arbiter would place every
        pod, the re-check is vacuous, and the bulk commit places exactly
        what those routes would. For the same reason a -1 stands:
        feasibility only shrinks within the batch."""
        name_of = self.mirror.name_of_row
        placed: List[Tuple[PodInfo, int, str]] = []
        preempt_fails: List[PodInfo] = []
        for info, row in zip(infos, assign_l):
            node_name = name_of[row] if row >= 0 else None
            if node_name is None:
                if row < 0 and self.enable_preemption:
                    # one batched preemption round after the commits
                    preempt_fails.append(info)
                    continue
                res.unschedulable += 1
                self._fail(info, cycle)
                continue
            placed.append((info, row, node_name))
        self._apply(placed, cycle, res)
        if preempt_fails:
            self._preempt_deferred(preempt_fails, cycle, res)

    def _apply(self, placed: List[Tuple[PodInfo, int, str]], cycle: int, res: ScheduleResult) -> None:
        """Commit (pod, node row, node name) triples in pop order: fold
        them into the device banks (the commit plane), assume them in one
        cache call and bind them on the bind pool in chunks. A key the
        cache already tracks is rejected by the assume: its pod fails and,
        when folded, its row goes back to a host-wins re-ship."""
        if not placed:
            return
        # folded BEFORE the assume, so a reject is corrected by a host-wins
        # re-ship of its row; and before the clones, which then carry the
        # request and signature memos the plan computed into the sync
        folded = self._dispatch_fold([(info.pod, row) for info, row, _ in placed])
        assumed_meta = [(info, info.pod.with_node(node_name), node_name) for info, _, node_name in placed]
        rejected = set(self.cache.assume_pods([m[1] for m in assumed_meta], folded=folded))
        if self.queue.has_nominations():
            # DeleteNominatedPodIfExists at assume (scheduler.go:529): a
            # committed pod stops reserving its nominated node
            self.queue.clear_nominations(
                [m[0].pod.key() for j, m in enumerate(assumed_meta) if j not in rejected])
        jobs = []
        for j, (info, assumed, node_name) in enumerate(assumed_meta):
            if j in rejected:  # the key is already in the cache
                if folded:
                    self.mirror.note_failed_fold(node_name)
                res.unschedulable += 1
                self._fail(info, cycle)
                continue
            jobs.append((info, assumed, node_name))
            res.assignments[info.pod.key()] = node_name
        res.scheduled += len(jobs)
        step = max(1, -(-len(jobs) // BIND_WORKERS))
        for i in range(0, len(jobs), step):
            self._bind_pool.submit(self._bind_chunk, jobs[i : i + step])

    def _dispatch_fold(self, pairs: List[Tuple[Pod, int]]) -> bool:
        """Fold a committed batch's deltas (`pairs` = the final placed set
        as (pod, node row)) into the resident device banks. True when the
        fold landed: the caller then tags the matching assumes folded. A
        bank overflow in the plan (plan_fold → None) is the reference's
        host route: the assumes ship as pending rows and the next sync
        rebuilds bigger; it is counted in `fold_overflow_batches`. A fold
        kernel that fails raises."""
        if not self.commit_plane or not self.mirror.can_fold():
            return False
        t0 = time.perf_counter()
        prog = plan_fold(self.mirror, pairs, self._b_bucket, self._fp_bucket)
        if prog is None:
            self.stats["fold_overflow_batches"] += 1
            return False
        self._fp_bucket = max(self._fp_bucket, prog.pat_bucket)
        if not self.mirror.fold_commit(prog):
            return False
        self.stats["fold_batches"] += 1
        self.stats["fold_pods"] += len(pairs)
        self.stats["fold_s"] += time.perf_counter() - t0
        return True

    def _commit_arbitrated(self, infos: List[PodInfo], assign_l: List[int], verdicts: List[int], cycle: int,
                           res: ScheduleResult) -> None:
        """Commit a batch from the arbiter's verdicts (the reference's
        `_commit_arbitrated` without speculation): V_PLACE pods are applied
        (`_apply`), V_DEFER pods go back to the queue with no backoff (they
        conflicted with their own batch; they are not unschedulable),
        V_NOFIT pods take the batched preemption round (or are
        unschedulable). A pod deferred `_defer_escalate` times in a row
        escalates to the reference's host oracle re-placement, which is
        not ported: the batch's placed pods are applied and its defers
        re-queued first, then the escalated pods and the batch's
        preemptors are re-queued and the batch raises."""
        name_of = self.mirror.name_of_row
        nodes = self.cache.snapshot.node_infos
        place: List[Tuple[PodInfo, int, str]] = []
        defers: List[PodInfo] = []
        preempt_fails: List[PodInfo] = []
        for info, row, v in zip(infos, assign_l, verdicts):
            if v == V_PLACE and row >= 0:
                node_name = name_of[row] if row < len(name_of) else None
                if node_name is None or node_name not in nodes:
                    defers.append(info)  # the node vanished under the solve
                    continue
                place.append((info, row, node_name))
            elif v == V_DEFER:
                defers.append(info)
            elif row < 0 and self.enable_preemption:
                preempt_fails.append(info)
            else:
                res.unschedulable += 1
                self._fail(info, cycle)
        kept_defers: List[PodInfo] = []
        escalate: List[PodInfo] = []
        for info in defers:
            k = info.pod.key()
            c = self._defer_counts.get(k, 0) + 1
            self._defer_counts[k] = c
            if c >= self._defer_escalate:
                self._defer_counts.pop(k, None)  # escalation consumes the budget
                escalate.append(info)
            else:
                kept_defers.append(info)
        if self._defer_counts and place:
            for info, _, _ in place:
                self._defer_counts.pop(info.pod.key(), None)
        # bounded: pods placed by other routes never clear their entry
        if len(self._defer_counts) > max(1024, 4 * self.batch_size):
            self._defer_counts.clear()
        # re-queued before the apply: the pods must be in the queue
        # whatever happens to this batch downstream
        if kept_defers:
            self.queue.requeue(kept_defers)
            res.deferred += len(kept_defers)
        t0 = time.perf_counter()
        placed_before = res.scheduled
        self._apply(place, cycle, res)
        self.stats["apply_s"] += time.perf_counter() - t0
        self.stats["arbiter_batches"] += 1
        self.stats["arbiter_place"] += res.scheduled - placed_before
        self.stats["arbiter_defer"] += len(defers)
        if escalate:
            self.stats["arbiter_escalated"] += len(escalate)
            self.queue.requeue(escalate + preempt_fails)
            raise NotImplementedError(
                f"{len(escalate)} pods deferred {self._defer_escalate} times in a row need the host "
                f"oracle's re-placement (_oracle_place) ({ORACLE_FALLBACK})"
            )
        if preempt_fails:
            self._preempt_deferred(preempt_fails, cycle, res)

    def _fail(self, info: PodInfo, cycle: int) -> None:
        self.queue.add_unschedulable(info, cycle)

    # -- preemption ------------------------------------------------------------

    def _nominee_overlay(self, na: Dict, pods: List[Pod]) -> Dict:
        """Fold the outstanding nominations of pods outside the batch onto
        the node bank's usage columns (podFitsOnNode's pass-1 nominee
        accounting, once per dispatch; the batch's own nominees are
        sequenced by the solve's carry). All nominees count, not only those
        of priority >= the incoming pod's: the reference's conservative
        overlay, since a per-pod filter would need a [B, N, R] one. With
        the commit plane on the overlay goes onto the resident tensors in
        place (`TensorMirror.fold_nominees`, taken off after the solve);
        off, onto clones of the two columns. Returns the node bank to
        solve on."""
        extras = self.queue.nomination_extras({p.key() for p in pods})
        width = int(na["requested"].shape[1])
        vocab = self.mirror.vocab
        rows: List[int] = []
        vecs: List[np.ndarray] = []
        for node, npod in extras:
            row = self.mirror.row_of.get(node)
            if row is None:
                continue
            vec = np.zeros(width, np.int64)
            pairs = _req_slot_pairs(vocab, npod)
            if any(s >= width for s, _ in pairs):
                continue  # an exotic resource slot beyond the bank: skipped, as the reference
            for s, v in pairs:
                vec[s] = v
            rows.append(row)
            vecs.append(vec)
        if not rows:
            return na
        self.stats["nominee_folds"] += 1
        rows_a = np.asarray(rows, np.int32)
        vecs_a = np.asarray(vecs, np.int64)
        cnt_a = np.ones(len(rows), np.int32)
        if self.commit_plane and self.mirror.can_fold():
            return self.mirror.fold_nominees(rows_a, vecs_a, cnt_a)
        ov = arrays_to_torch({"rows": rows_a, "vecs": vecs_a, "cnt": cnt_a}, self.device)
        na = dict(na)
        na["requested"] = na["requested"].clone()
        na["pod_count"] = na["pod_count"].clone()
        fold_usage(na["requested"], na["pod_count"], ov["rows"], ov["vecs"], ov["cnt"])
        return na

    def _can_disrupt(self, p: Pod) -> bool:
        # never a pod whose bind is in flight: removing it locally while the
        # bind completes would desync the cache from the node
        return not self.cache.is_assumed(p.key())

    def _try_preempt(self, info: PodInfo) -> bool:
        """scheduler.go:612 preempt on the host for one pod: nominate a
        node, delete the victims, clear obsolete lower-priority
        nominations. Runs before the pod is re-queued, so the queue's
        nominated index sees the nomination."""
        pod = info.pod
        node, victims, clear = preemption_mod.preempt(
            pod, self.cache.snapshot, pdbs=self.pdb_lister(),
            nominated_fn=self.queue.nominated_pods_for_node, can_disrupt=self._can_disrupt,
            enabled=self._enabled_preds,
        )
        if node is None:
            return False
        self._apply_preemption(pod, node, victims, clear)
        return True

    def _apply_preemption(self, pod: Pod, node: str, victims: List[Pod], clear) -> None:
        """The victim deletes and the nomination (the API-write tail of
        Preempt, scheduler.go:436-470)."""
        for v in victims:
            if self.delete_fn is not None:
                self.delete_fn(v)  # the informer's delete event removes it from the cache
            else:
                self.cache.remove_pod(v)
        for key in clear:
            self.queue.clear_nomination(key)
        pod.nominated_node_name = node
        if self.nominate_fn is not None:
            # a failed status write leaves the nomination local, as the
            # reference's SetNominatedNodeName error path does
            try:
                self.nominate_fn(pod, node)
            except Exception:
                _log.warning("nominatedNodeName write for %s failed; the nomination stays local", pod.key(),
                             exc_info=True)
        self.stats["victims"] += len(victims)

    def _preempt_deferred(self, fails: List[PodInfo], cycle: int, res: ScheduleResult) -> None:
        """One batched preemption round for a batch's unplaced pods, at the
        end-of-batch state (its commits assumed): one device victim search
        over every preemptor and node in pop order
        (preemption.batch_preempt_device), then each plan re-verified on
        the host against the live node (the exact victim list, or that pod
        goes to `_try_preempt`) and applied. Batches outside the kernel's
        domain (terms, ports, a restricted predicate set) take
        `_try_preempt` pod by pod. Every pod then fails into the queue with
        its nomination; after any preemption or a pod that fits as things
        stand, the unschedulable pods move back (MoveAllToActiveQueue)."""
        t0 = time.perf_counter()
        self.stats["preempt_batches"] += 1
        pdbs = self.pdb_lister()
        snapshot = self.cache.snapshot
        plans = None
        if self._enabled_preds is None:
            plans = preemption_mod.batch_preempt_device(
                [i.pod for i in fails], snapshot, pdbs=pdbs, can_disrupt=self._can_disrupt,
                nominated=self.queue.nomination_extras({i.pod.key() for i in fails}), device=self.device,
            )
        any_preempted = False
        any_fits_free = False
        for k, info in enumerate(fails):
            pod = info.pod
            try:
                if plans is None:
                    applied = self._try_preempt(info)
                else:
                    applied = False
                    node_name, victims, fits_free = plans[k]
                    any_fits_free |= fits_free
                    if node_name is not None:
                        if self._reverify(pod, node_name, victims, pdbs):
                            clear = [p.key() for p in self.queue.nominated_pods_for_node(node_name)
                                     if p.get_priority() < pod.get_priority()]
                            self._apply_preemption(pod, node_name, victims, clear)
                            applied = True
                        else:
                            self.stats["preempt_reverify_miss"] += 1
                            applied = self._try_preempt(info)
            except NotImplementedError:
                # the host path refused: the pods not yet handled go back
                self.queue.requeue(fails[k:])
                if any_preempted or any_fits_free:
                    self.queue.move_all_to_active()
                self.stats["preempt_s"] += time.perf_counter() - t0
                raise
            if applied:
                res.preempted += 1
                self.stats["preempted"] += 1
                any_preempted = True
            res.unschedulable += 1
            self._fail(info, cycle)
        if any_preempted or any_fits_free:
            # victim deletions are cluster events, and a pod that fits as
            # things stand must retry promptly (eventhandlers.go:127)
            self.queue.move_all_to_active()
        self.stats["preempt_s"] += time.perf_counter() - t0

    def _reverify(self, pod: Pod, node_name: str, victims: List[Pod], pdbs) -> bool:
        """The device plan against the live node: the host victim search
        (nominees on the node charged, the pod itself excepted) must name
        exactly the plan's victims, in order."""
        total: Dict[str, int] = {}
        noms = [p for p in self.queue.nominated_pods_for_node(node_name) if p.key() != pod.key()]
        for npod in noms:
            for rn, v in accumulated_request(npod).items():
                if rn != "pods":
                    total[rn] = total.get(rn, 0) + v
        live = preemption_mod._select_victims_fast(
            pod, self.cache.snapshot.get(node_name), pdbs, self._can_disrupt,
            nominee_charge=(total, len(noms)) if noms else None,
        )
        return live is not None and [p.key() for p in live.pods] == [p.key() for p in victims]

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
            total.preempted += r.preempted
            total.deferred += r.deferred
            total.assignments.update(r.assignments)
            if r.scheduled == 0 and r.unschedulable == 0 and r.deferred == 0:
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
