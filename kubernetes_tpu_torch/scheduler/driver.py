"""Scheduler driver: the batch scheduling loop.

The port's lean copy of `kubernetes_tpu/scheduler/driver.py`, reproducing
the reference's default path — the ingest, term, commit and fold planes on
and preemption on — and its host seams for Scheduling Framework plugins
and HTTP extenders; no speculation, warm-up or volumes. Per batch:

    pop_batch (+ every queued member of each gang group present) →
    TensorMirror.sync → spec dedup (with the pods' spreading
    selectors) → the batch's pod arrays and term table gathered on the
    device from the staged slabs (or, off the planes, PodBatch encode +
    compile_batch_terms and their upload) → device_arrays
    (node, signature and pattern banks) → the outstanding preemption
    nominees folded onto the node bank's usage columns → one
    solve_pipeline (filter, score, topology and greedy-solve kernels, with
    the solver's in-batch anti-affinity / host-port tracking once a batch
    needs it) → the commit arbiter when a pod needs a re-check → the
    nominee overlay taken off → commit in pop order

A batch holding a pod of a gang group (the PodGroup label or annotation)
solves through solve_pipeline_gang instead: the all-or-nothing two-pass
solve, without the in-batch tracking and without the arbiter. The commit
takes one of the reference's three routes, picked per batch
(`_schedule_batch`'s routing, ref :3578-:3760):

* the bulk path (`_commit_bulk`: every pod RECHECK_NONE, no encoding
  overflow, no nomination that appeared after the solve, no -1 beside
  node rows that fell back): -1 pods take one batched preemption round
  (or go back as unschedulable), the rest are assumed in one cache call
  and bound on the bind pool in chunks;
* the arbitrated path (`_commit_arbitrated`, where `_arbiter_covers`
  holds): the arbiter's verdicts (commit/arbiter.py) place, defer to the
  next batch (re-queued without backoff) or fail each pod; a pod deferred
  three times in a row escalates to the host oracle's re-placement
  (`_oracle_place`);
* the per-pod loop (`_commit_loop`, everything else: gang batches,
  required pod affinity, the commit plane off, encoding or pattern
  overflow, -1 pods beside fallback node rows, outstanding nominations):
  each pod's pick is
  re-checked in pop order against the batch's earlier commits — by the
  full host oracle chain (oracle/predicates.pod_fits_on_node with the
  two-pass nominee rule) for RECHECK_FULL, fallback and nominated picks, by
  the light batch-conflict index for RECHECK_LIGHT — and re-placed by
  `_oracle_place` when it fails; a pod placed nowhere preempts on the
  host (`_try_preempt`). A gang member is assumed as it is decided but
  bound only once the loop ends with its group complete; a member the
  solve dropped, one placed nowhere (no preemption for gang members) or a
  group short of its declared min-available rolls the whole group back
  (`GangRollbackRecord`: one bulk cache forget, the members failed).

The ingest and term planes (`ingest_plane`, `term_plane`, on by default as
in the reference): the queue stages each pod when it admits it — its
PodBatch row into ingest/stage.PodStage, its topology terms into
terms_plane/stage.TermStage, content-interned and refcounted — and the
entry carries the (row, generation) pairs. A dispatch validates the reps'
pairs (`_stage_prologue`, `_term_prologue`; a stale one re-stages,
counted), flushes the slabs' dirty rows into their device twins (one
launch of csrc/slab.cu's row scatter each) and gathers the batch's pod
arrays and term table on the device from int32 index vectors (ONE launch
of csrc/slab.cu's batch gather for both, in `_encode`); the term kinds,
topology slots, aux bits and overflow come from the interned entries. A batch the slabs cannot
cover (a stale rep that cannot re-stage: slab at its ceiling; a slab
rebuilt mid-resolve) takes the legacy host-built encode, counted in
`ingest_legacy_batches` / `term_legacy_batches`. Placements are
bit-identical either way. No warm-up and no uploader thread: every flush
is the dispatch-time one (`stage_sync_flushes`, `term_sync_flushes`).

`_oracle_place` walks the nodes in the zone-interleaved order of
state/node_tree.py and keeps the feasible node with the best device score,
first wins; the score rows it ranks by stay on the card until the batch's
commit ends, and only the gathered rows cross (`ScoreRows`,
ops/pipeline.gather_score_rows). On the bulk and arbitrated routes the
fold plane scatters the placed pods' deltas into the device-resident banks
(ops/fold, commit/fold) and tags the assumes as folded, so the mirror does
not re-ship those rows; the per-pod commits are re-shipped host-wins at
the next sync. `commit_plane=False` turns the arbiter and the fold off.

Preemption (`enable_preemption`, on by default as in the reference): the
pods the bulk and arbitrated routes could not place go through one device
victim search (scheduler/preemption.batch_preempt_device →
ops/preempt.preempt_batch), each plan is re-verified on the host against
the live node, and the victims are deleted and the pod nominated to the
node; batches outside the kernel's domain take the host search per pod.
The next batches see the outstanding nominations folded onto the node
bank's usage columns (ops/fold.fold_usage: in place with the commit plane
on, on a copy with it off), as podFitsOnNode's pass 1 counts them.

Framework plugins and extenders (the reference's host seams): a QueueSort
plugin's comparator orders the activeQ and, with the priority key zeroed,
the solve's in-batch order; any other plugin or any extender sends every
batch to the per-pod loop (`_commit_plane_statics_ok`: no arbiter dispatch,
no bulk path). There PreFilter can reject a pod, Filter joins the full
re-check, and Score / PostFilter plugins or an interested extender that
filters or prioritizes re-rank every placed pod through `_oracle_place`'s
full scan. Reserve / Unreserve wrap the assume; Permit (waiting pods),
PreBind, Bind and PostBind run in the bind pipeline, or an interested
extender with a bind verb binds. A non-ignorable extender failure is a
scheduling error (`ScheduleResult.errors`): the pod goes back to the queue
and never preempts. Extenders with a preemption verb trim or veto the host
victim search's plan and make the device victim search ineligible.

Nothing here turns an exception into another route — the reference's
fault breaker, which sends a failed prologue to the legacy path, has no
port: a kernel failure raises, after the batch's pods not yet handled, and
the staged members of any open gang group (their assumes forgotten), are
returned to the queue; a failure before the commit returns the whole
batch.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.selectors import match_label_selector
from ..api.types import DO_NOT_SCHEDULE, Pod
from ..commit.apply import GangRollbackRecord
from ..commit.arbiter import V_DEFER, V_PLACE, arbitrate, kinds_covered
from ..commit.fold import plan_fold
from ..device import resolve_device
from ..framework.interface import CycleState, Framework
from ..ingest import PodStage, StageBank, stage_problem
from ..ops import filters as F
from ..ops.fold import fold_usage
from ..ops.pipeline import SolveConfig, gather_score_rows, solve_pipeline, solve_pipeline_gang
from ..ops.slab import GatherProblem, gather_batch
from ..ops.solver import prng_key_data
from ..oracle.nodeinfo import accumulated_request
from ..parallel.mesh import indexed_device, node_shards
from ..parallel.sharded import make_sharded_pipeline
from ..oracle.predicates import (
    SnapshotAffinityIndex,
    compute_predicate_metadata,
    get_hard_spread_constraints,
    get_pod_affinity_terms,
    get_pod_anti_affinity_terms,
    pod_fits_on_node,
    pod_fits_resources,
    pod_match_node_selector,
    pod_matches_all_term_properties,
    pod_matches_term,
)
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
    compile_batch_terms,
    count_batch_terms,
)
from ..state.tensors import KeySlotOverflow, PodBatch, _bucket, _req_slot_pairs, dedup_specs_keyed, spec_key
from ..terms_plane import TermBankDevice, TermStage, term_problem
from . import preemption as preemption_mod
from .preemption import eligible_nominees, fits_considering_nominated, fits_with_nominees

_log = logging.getLogger(__name__)

# the coscheduling PodGroup marker and the group's declared size, read as
# the reference reads them (label preferred, annotation accepted)
POD_GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io/name"
POD_GROUP_MIN_AVAILABLE = "pod-group.scheduling.sigs.k8s.io/min-available"

# bind pool threads; a batch's binds are split into this many chunks
BIND_WORKERS = 8


def pod_group_name(pod: Pod) -> str:
    """The pod's gang group, "" for none; memoized on the pod (labels and
    annotations are spec-stable, and batch assembly, dispatch and the
    commit loop each read it)."""
    g = pod.__dict__.get("_grp_memo")
    if g is None:
        g = pod.labels.get(POD_GROUP_LABEL, "") or pod.annotations.get(POD_GROUP_LABEL, "")
        pod.__dict__["_grp_memo"] = g
    return g


def pod_group_min_available(pod: Pod) -> int:
    """The group's declared size (0 when unset or not an integer): a batch
    holding fewer members must not bind its slice."""
    raw = pod.labels.get(POD_GROUP_MIN_AVAILABLE, "") or pod.annotations.get(POD_GROUP_MIN_AVAILABLE, "")
    try:
        return int(raw)
    except ValueError:
        return 0


@dataclass
class ScheduleResult:
    scheduled: int = 0
    unschedulable: int = 0
    errors: int = 0  # scheduling errors (a non-ignorable extender failure): re-queued, never preempting
    preempted: int = 0  # failed pods whose preemption deleted victims and nominated a node
    deferred: int = 0  # arbiter V_DEFER: re-queued for the next batch
    assignments: Dict[str, str] = field(default_factory=dict)


class ExtenderError(Exception):
    """A non-ignorable extender wire failure (ref :171). Not a "no fit": the
    reference treats it as a scheduling error (core/generic_scheduler.go:
    531-557 returns an error, not a FitError), so it never preempts."""


# the extension points whose plugins force the per-pod loop (every one but
# QueueSort)
_HOST_POINTS = ("reserve", "filter", "pre_filter", "score", "post_filter", "permit", "pre_bind", "bind",
                "post_bind")
_VOLUME_SEAM = "volumes are not ported (ROADMAP.md queue 1 item 7, volumes)"
_COLUMNAR = "the columnar cache is not ported (ROADMAP.md queue 1 item 4, columnar cache)"
_SPECULATION = ("warm-up, speculation and the commit pipeline are not ported (ROADMAP.md queue 1 item 6, "
                "warm-up, speculation and the commit pipeline)")
_OBSERVABILITY = ("faults, events, tracing and health are not ported (ROADMAP.md queue 1 item 8, robustness "
                  "and observability)")


def _refuse_reference_options(kw: Dict[str, object], commit_plane: bool) -> None:
    """The reference Scheduler's keywords the port has no counterpart for:
    a value equal to the port's behaviour is accepted and does nothing;
    any other raises NotImplementedError naming its ROADMAP item."""
    accepted = {
        "speculate": ((False,), _SPECULATION), "spec_depth": ((2,), _SPECULATION),
        "compile_plan": ((None,), _SPECULATION), "columnar_cache": ((False,), _COLUMNAR),
        "error_fn": ((None,), _OBSERVABILITY), "event_fn": ((None,), _OBSERVABILITY),
        "trace": ((None, False), _OBSERVABILITY), "fault_plan": ((None,), _OBSERVABILITY),
        "bind_workers": ((BIND_WORKERS,), _OBSERVABILITY),
    }
    for name, (oks, item) in accepted.items():
        value = kw[name]
        # None and the booleans by identity; the counts as ints (True is no count)
        if not any(value is ok if ok is None or isinstance(ok, bool) else type(value) is int and value == ok
                   for ok in oks):
            raise NotImplementedError(f"Scheduler({name}={value!r}): {item}")
    fold_plane = kw["fold_plane"]
    if fold_plane is not None and bool(fold_plane) != bool(commit_plane):
        raise NotImplementedError(
            f"Scheduler(commit_plane={commit_plane!r}, fold_plane={fold_plane!r}): not ported; the port's "
            "commit_plane turns the commit arbiter and the commit fold on and off together")


class Binder:
    """Default binder: callable hook (pod, node_name) -> None, raising on
    failure — the equivalent of POST pods/<p>/binding (factory.go:713)."""

    def __init__(self, bind_fn: Optional[Callable[[Pod, str], None]] = None):
        self._fn = bind_fn

    def bind(self, pod: Pod, node_name: str) -> None:
        if self._fn is not None:
            self._fn(pod, node_name)


class ScoreRows:
    """Lazy per-row view of the batch's [U, N] device score matrix (ref
    driver.py:88-132): the host oracle ranks feasible nodes by a pod's row,
    and only the rows it asks for cross to the host, gathered on the card
    straight into pinned host memory (ops/pipeline.gather_score_rows).
    `sig` maps batch positions onto spec rows; replicas share one fetched
    row. Exactly the wanted rows are gathered (the reference pads the count
    to a power of two for its jit cache). The escalation loop and the
    host-ranked commit loop prefetch every row they will read in one
    gather."""

    def __init__(self, score: torch.Tensor, sig: Sequence[int]):
        self._dev = score
        self._sig = sig
        self._cache: Dict[int, np.ndarray] = {}

    def __getitem__(self, i: int) -> np.ndarray:
        u = int(self._sig[i])
        row = self._cache.get(u)
        if row is None:
            self.prefetch([i])
            row = self._cache[u]
        return row

    def prefetch(self, indices) -> None:
        """Fetch the rows of these batch positions in one gather."""
        want = sorted({int(self._sig[i]) for i in indices} - self._cache.keys())
        if not want:
            return
        rows = gather_score_rows(self._dev, want).numpy()
        for j, u in enumerate(want):
            self._cache[u] = rows[j]


@dataclass
class SolveOutput:
    """A solved batch as the commit routes read it, per batch position."""

    assign: List[int]  # node row or -1
    fallback: List[bool]  # encoding or term-table overflow: the host oracle re-checks
    score: ScoreRows
    has_anti: List[bool]  # the pod carries required anti-affinity
    levels: List[int]  # RECHECK_* per pod
    existing_overflow: bool  # an existing pod's terms overflow a pattern row: re-check all
    node_fallback_any: bool  # some node rows fell back out of the device path
    inbatch_tracked: bool  # the solve tracked anti-affinity and host ports in the batch
    nom_adds: int  # queue.nomination_adds when the nominees were folded for the solve
    verdicts: Optional[List[int]]  # the arbiter's, when it ran (every term kind of the batch covered)
    gang_ok: Optional[List[bool]] = None  # gang batches: False where the solve dropped the pod's group


class _BatchConflictIndex:
    """Commits of the current batch indexed by (topology key, value) for the
    LIGHT intra-batch anti-affinity re-check (ref driver.py:265-362). Two
    directions (predicates.go:1284 satisfiesExistingPodsAntiAffinity +
    satisfiesPodsAffinityAntiAffinity, anti half):

      * a committed pod's required anti term blocks later pods on nodes
        sharing the term's topology value with the commit node;
      * a later pod's own anti terms block it on nodes sharing a topology
        value with any commit whose pod the term selects.

    Buckets group their entries by spec (controller replicas share labels
    and terms), and selector matches are memoized per (direction, commit
    spec, term index, candidate spec): one match and a liveness peek per
    bucket. Rolled-back gang members are tombstoned (`remove`), not
    unindexed: a bucket blocks only while one of its commits is live."""

    def __init__(self):
        # (key, value of commit node) → {spec: {term index: [(committed pod, term)]}}
        self._anti_by_kv: Dict[Tuple[str, str], Dict] = {}
        # (key, value of commit node) → {spec: [committed pods]}
        self._commits_by_kv: Dict[Tuple[str, str], Dict] = {}
        self._rolled_back: set = set()  # id() of the rolled-back pods
        self._match_memo: Dict[Tuple, bool] = {}
        self.any_anti = False
        self.commits: List[Pod] = []  # flat, in commit order (rolled-back pods stay, as in the reference)

    def add_commit(self, pod: Pod, node) -> None:
        self.commits.append(pod)
        spec = spec_key(pod)
        for kv in node.labels.items():
            self._commits_by_kv.setdefault(kv, {}).setdefault(spec, []).append(pod)

    def add_anti(self, pod: Pod, node) -> None:
        self.any_anti = True
        spec = spec_key(pod)
        for t_i, term in enumerate(get_pod_anti_affinity_terms(pod.affinity)):
            k = term.topology_key
            v = node.labels.get(k) if k else None
            if v is not None:
                self._anti_by_kv.setdefault((k, v), {}).setdefault(spec, {}).setdefault(t_i, []).append((pod, term))

    def remove(self, pod: Pod) -> None:
        """Tombstone a rolled-back commit: it blocks no later pod."""
        self._rolled_back.add(id(pod))

    def _any_live(self, pods) -> bool:
        return any(id(p) not in self._rolled_back for p in pods)

    def anti_conflict(self, pod: Pod, node) -> bool:
        p_spec = spec_key(pod)
        memo = self._match_memo
        for kv in node.labels.items():
            for c_spec, by_term in self._anti_by_kv.get(kv, {}).items():
                # one representative match per (commit spec, term, pod spec)
                for t_i, entries in by_term.items():
                    c, term = entries[0]
                    mk = ("A", c_spec, t_i, p_spec)
                    hit = memo.get(mk)
                    if hit is None:
                        hit = memo[mk] = pod_matches_term(pod, c, term)
                    if hit and self._any_live(e[0] for e in entries):
                        return True
        a = pod.affinity
        if a is not None and a.pod_anti_affinity is not None:
            for t_i, term in enumerate(a.pod_anti_affinity.required):
                k = term.topology_key
                v = node.labels.get(k) if k else None
                if v is None:
                    continue
                for c_spec, pods in self._commits_by_kv.get((k, v), {}).items():
                    mk = ("B", p_spec, t_i, c_spec)
                    hit = memo.get(mk)
                    if hit is None:
                        hit = memo[mk] = pod_matches_term(pods[0], pod, term)
                    if hit and self._any_live(pods):
                        return True
        return False


def _no_nominations(node: str):
    """Batch-constant stand-in for queue.nominated_pods_for_node while the
    nominated index is empty."""
    return ()


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


def _minus_one_could_fit(pod: Pod, index: _BatchConflictIndex, preempted: bool, level: int) -> bool:
    """The device said no node fits (against the batch-start state). Within
    the batch feasibility only improves through the events checked here —
    anti-affinity, ports and resource use only shrink it — so otherwise the
    -1 stands without the O(nodes) oracle walk (ref driver.py:472-505):
      * a preemption freed capacity;
      * a commit matches the pod's required affinity terms (the in-batch
        anchor, predicates.go:1269);
      * a same-namespace commit matches a DoNotSchedule constraint's
        selector (it raises the domain minimum, loosening the skew bound)."""
    if level != RECHECK_FULL:
        return False
    if preempted:
        return True
    aff_terms = get_pod_affinity_terms(pod.affinity)
    hard = [c for c in pod.topology_spread_constraints if c.when_unsatisfiable == DO_NOT_SCHEDULE]
    for c in index.commits:
        if aff_terms and pod_matches_all_term_properties(c, pod, aff_terms):
            return True
        for con in hard:
            if c.namespace == pod.namespace and match_label_selector(con.label_selector, c.labels):
                return True
    return False


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
    """The batch driver on one device: the card unless `device="cpu"`, or
    the device of `mesh` (parallel.node_mesh: the node axis split over
    shards of that device)."""

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
        ingest_plane: bool = True,
        term_plane: bool = True,
        framework: Optional[Framework] = None,
        extenders: Optional[List] = None,
        volume_checker: Optional[Callable] = None,
        volume_binder=None,
        mesh=None,
        error_fn: Optional[Callable] = None,
        bind_workers: int = BIND_WORKERS,
        event_fn: Optional[Callable] = None,
        speculate: bool = False,
        spec_depth: int = 2,
        compile_plan=None,
        fold_plane: Optional[bool] = None,
        columnar_cache: bool = False,
        trace: Optional[bool] = None,
        fault_plan=None,
    ):
        # the reference's keywords: its defaults where they are the port's
        # behaviour (fold_plane follows commit_plane), refused otherwise
        _refuse_reference_options(dict(
            error_fn=error_fn, bind_workers=bind_workers, event_fn=event_fn, speculate=speculate,
            spec_depth=spec_depth, compile_plan=compile_plan, fold_plane=fold_plane,
            columnar_cache=columnar_cache, trace=trace, fault_plan=fault_plan), commit_plane)
        if volume_checker is not None or volume_binder is not None:
            raise NotImplementedError(f"Scheduler(volume_checker=..., volume_binder=...): {_VOLUME_SEAM}")
        self.device = resolve_device(device if device is not None or mesh is None else mesh.device)
        # the arbiter's verdicts for DoNotSchedule batches and the commits
        # folded into the device banks (the reference's commit and fold
        # planes, which it turns on together by default)
        self.commit_plane = commit_plane
        self.cache = cache or SchedulerCache()
        self.queue = queue or PriorityQueue()
        self.binder = binder or Binder()
        # Scheduling Framework plugins, consulted per pod on the host; a
        # QueueSort plugin's comparator orders the activeQ (ref :546-550)
        self.framework = framework or Framework()
        qs_less = self.framework.queue_sort_less()
        if qs_less is not None:
            self.queue.set_queue_sort(qs_less)
        # HTTP extenders (core/extender.go): consulted per pod on the host at
        # Filter / Prioritize time, and at Bind when one binds
        self.extenders: List = list(extenders or [])
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
        # a node mesh (parallel.node_mesh) routes every solve, gang solve
        # and arbiter scan through the sharded programs (node columns and
        # residuals shard-local), and the mirror folds through the sharded
        # folds (ref :552-565)
        self.mesh = mesh
        self._sharded = None
        self._mesh_shards = 0
        if mesh is not None:
            if indexed_device(mesh.device) != indexed_device(self.device):
                raise ValueError(f"the mesh lies on {mesh.device}, the scheduler on {self.device}")
            self._sharded = make_sharded_pipeline(mesh)
            self._mesh_shards = node_shards(mesh)
            self.mirror.set_mesh(mesh)
        # logged once on each change into the indivisible-capacity fallback
        self._sharded_fallback_logged = False
        # the ingest plane: pod rows staged at admission into a slab whose
        # twin lives on the device; covered dispatches gather the pod arrays
        # there from an index vector (ref :710-726)
        self.ingest_plane = ingest_plane
        self.stage: Optional[PodStage] = None
        self.stage_bank: Optional[StageBank] = None
        if ingest_plane:
            self.stage = PodStage(self.mirror.vocab)
            self.stage_bank = StageBank(self.stage, self.device)
            self.queue.attach_stage(self.stage)
        # the term plane: each pod's topology terms interned at admission;
        # covered dispatches gather the batch term table on the device from
        # index and owner vectors (ref :736-750)
        self.term_plane = term_plane
        self.tstage: Optional[TermStage] = None
        self.term_bank: Optional[TermBankDevice] = None
        if term_plane:
            self.tstage = TermStage(self.mirror.vocab)
            self.term_bank = TermBankDevice(self.tstage, self.device)
            self.queue.attach_term_stage(self.tstage)
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
        # oracle's re-placement
        self._defer_counts: Dict[str, int] = {}
        self._defer_escalate = 3
        # the host oracle's per-batch affinity index and the batch's commits
        # replayed on top of it (`_pod_meta`); None after anything the
        # commits list does not capture (a sync, victim deletes)
        self._aff_index: Optional[SnapshotAffinityIndex] = None
        self._aff_extra: List = []
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
        # dispatches that overlaid outstanding nominations; oracle_rechecks
        # counts the per-pod loop's full host re-checks of a pick,
        # light_rechecks its batch-conflict re-checks, oracle_places the
        # host oracle's re-placements the reference counts; gang_batches the
        # batches solved all-or-nothing, gang_rollbacks the groups whose
        # staged members the commit loop forgot. The planes, under the
        # reference's names: *_index_batches the batches gathered on the
        # device, *_legacy_batches those a plane could not cover,
        # *_stale_rows the reps whose staged pair was stale, *_restaged those
        # re-staged at dispatch, stage_sync_flushes / term_sync_flushes the
        # dispatches that flushed dirty rows, stage_s / term_gather_s the
        # prologues' seconds (resolve, flush; the batch's one gather launch
        # goes to stage_s when it gathers the pod arrays, else to
        # term_gather_s)
        self.stats: Dict[str, float] = {
            "sync_s": 0.0, "encode_s": 0.0, "solve_s": 0.0, "commit_s": 0.0, "batches": 0,
            "oracle_rechecks": 0, "light_rechecks": 0, "oracle_places": 0,
            "tracked_batches": 0, "fold_batches": 0, "fold_pods": 0, "fold_s": 0.0,
            "fold_overflow_batches": 0, "arbiter_batches": 0, "arbiter_place": 0, "arbiter_defer": 0,
            "arbiter_escalated": 0, "apply_s": 0.0, "preempt_batches": 0, "preempted": 0, "victims": 0,
            "preempt_s": 0.0, "preempt_reverify_miss": 0, "nominee_folds": 0,
            "gang_batches": 0, "gang_rollbacks": 0,
            "ingest_index_batches": 0, "ingest_legacy_batches": 0, "ingest_stale_rows": 0, "ingest_restaged": 0,
            "stage_sync_flushes": 0, "stage_s": 0.0,
            "term_index_batches": 0, "term_legacy_batches": 0, "term_stale_rows": 0, "term_restaged": 0,
            "term_sync_flushes": 0, "term_gather_s": 0.0, "sharded_fallbacks": 0,
        }

    def set_spread_selectors_fn(self, fn: Callable[[Pod], list]) -> None:
        """Install the getSelectors equivalent (the Service / RC / RS /
        StatefulSet selectors that select a pod, selector_spreading.go
        getSelectors) used for SelectorSpread scoring. The term slab
        interns (spec, selectors) pairs, so admission consults the same
        function as the dispatch's dedup (ref :839)."""
        self._spread_selectors_fn = fn
        if self.tstage is not None:
            self.tstage.selectors_fn = fn

    # -- one batch -----------------------------------------------------------

    def _encode(self, infos: List[PodInfo]) -> Tuple[Dict[str, torch.Tensor], List[Pod], np.ndarray,
                                                     Dict[str, torch.Tensor], Dict[str, np.ndarray], np.ndarray,
                                                     set, set]:
        """Collapse the batch to unique pod specs (replicas share one
        mask/score row; pods behind different selectors never do) and build
        the solve's pod arrays and term table on the device: gathered from
        the staged slabs where the planes cover the batch, else one
        PodBatch row per spec and the specs' topology terms compiled into a
        TermBank sized by the monotone term bucket, uploaded. Returns (pod
        arrays, reps, sig, term table, aux, fallback, term kinds present,
        topology slots named); `fallback` flags the spec rows whose
        structures or topology terms overflow the encoding: the host oracle
        re-checks those pods."""
        pods = [info.pod for info in infos]
        selectors = None
        if self._spread_selectors_fn is not None:
            selectors = {id(p): self._spread_selectors_fn(p) for p in pods}
        reps, sig_list, rep_keys = dedup_specs_keyed(pods, selectors)
        rep_infos: List[PodInfo] = []  # the first queue entry of each spec
        for info, u in zip(infos, sig_list):
            if u == len(rep_infos):
                rep_infos.append(info)
        self._u_bucket = max(self._u_bucket, _bucket(len(reps)))
        vocab = self.mirror.vocab
        st = self.stats
        while True:
            try:
                staged = self._stage_prologue(reps, rep_infos) if self.stage is not None else None
                if staged is not None:
                    fallback = staged.col[: len(reps)].copy()
                else:
                    batch = PodBatch(vocab, self._u_bucket)
                    for i, p in enumerate(reps):
                        batch.set_pod(i, p)
                    fallback = batch.fallback[: len(reps)].copy()
                tp = self._term_prologue(reps, rep_infos, rep_keys, selectors) if self.tstage is not None else None
                if tp is None:
                    # size the term bucket BEFORE compiling: one compile at
                    # the final capacity
                    self._t_bucket = max(self._t_bucket, _bucket(max(count_batch_terms(reps, selectors), 1)))
                    tb, aux = compile_batch_terms(
                        vocab, reps, spread_selectors=selectors,
                        capacity=self._t_bucket, b_capacity=self._u_bucket,
                    )
                    self._t_bucket = max(self._t_bucket, tb.capacity)
                break
            except KeySlotOverflow:
                self.mirror._rebuild()
        # one gather launch for both covered planes, after the retry loop (a
        # discarded attempt launches nothing)
        problems = ([staged] if staged is not None else []) + ([tp["problem"]] if tp is not None else [])
        if problems:
            t0 = time.perf_counter()
            gathered = gather_batch(problems)
            st["stage_s" if staged is not None else "term_gather_s"] += time.perf_counter() - t0
        if staged is None:
            pa = arrays_to_torch(batch.arrays(), self.device)
            if self.stage is not None:
                st["ingest_legacy_batches"] += 1
        else:
            pa = gathered[0]
            st["ingest_index_batches"] += 1
        if tp is None:
            ta = arrays_to_torch(tb.arrays(), self.device)
            overflow = tb.overflow_owners
            present = set(np.unique(tb.kind[tb.valid]).tolist())
            slots = set(np.asarray(tb.topo_slot[tb.valid], np.int64).tolist())
            if self.tstage is not None:
                st["term_legacy_batches"] += 1
        else:
            ta, aux, overflow, present, slots = gathered[-1], tp["aux"], tp["overflow"], tp["kinds"], tp["slots"]
            st["term_index_batches"] += 1
        for owner in overflow:
            if 0 <= owner < len(reps):
                fallback[owner] = True
        return pa, reps, np.asarray(sig_list, np.int32), ta, aux, fallback, present, slots

    def _stage_prologue(self, reps: List[Pod], rep_infos: List[PodInfo]) -> Optional[GatherProblem]:
        """Resolve each rep's staged row and capture the gather of the
        batch's pod arrays from the slab's device twin (ref :1254-1347).
        Returns the gather problem (its `col` the [U] host fallback vector),
        or None when the batch cannot be covered (a stale rep that cannot
        re-stage, the slab rebuilt mid-resolve): the caller encodes the
        legacy PodBatch, counted. Resolution, the dirty-row flush and the
        capture of the gather's inputs hold the slab lock; `_encode`
        launches the gather after both prologues. A failed flush raises."""
        stage, bank = self.stage, self.stage_bank
        st = self.stats
        t0 = time.perf_counter()
        with stage._lock:
            stage.ensure_current()
            # a rebuild DURING resolution (a restage growing a full slab)
            # makes the rows already collected garbage: detect it by
            # generation and take the legacy path ("one legacy batch at
            # worst")
            gen0 = stage.generation
            rows: List[int] = []
            stale = 0
            row_gen = stage.row_gen
            for pod, pi in zip(reps, rep_infos):
                if pi.pod is pod and 0 <= pi.staged_row < stage.capacity and row_gen[pi.staged_row] == pi.staged_gen:
                    rows.append(pi.staged_row)
                    continue
                # updated or deleted between enqueue and pop, slab rebuilt,
                # or admitted before the plane attached: re-stage the
                # captured pod object
                stale += 1
                pair = stage.ensure_row(pod)
                if pair is None:
                    st["ingest_stale_rows"] += stale
                    return None
                rows.append(pair[0])
                st["ingest_restaged"] += 1
            st["ingest_stale_rows"] += stale
            if stage.generation != gen0:
                return None
            u = self._u_bucket
            idx = np.zeros(u, np.int32)
            idx[: len(rows)] = rows
            keep = np.zeros(u, bool)
            keep[: len(rows)] = True
            fb = np.zeros(u, bool)
            fb[: len(rows)] = stage.batch.fallback[np.asarray(rows, np.int64)]
            was_sync = bank.stats["sync_rows"]
            bank_dev, empty_dev = bank.current_arrays()
            if bank.stats["sync_rows"] != was_sync:
                st["stage_sync_flushes"] += 1
        st["stage_s"] += time.perf_counter() - t0
        return stage_problem(bank_dev, idx, keep, empty_dev, fb)

    def _term_prologue(self, reps: List[Pod], rep_infos: List[PodInfo], rep_keys: List[tuple],
                       selectors: Optional[Dict[int, list]]) -> Optional[Dict]:
        """Resolve each rep's interned term entry and capture the gather of
        the batch's term table from the term slab's device twin (ref
        :1368-1491). Returns {"problem": the gather problem, "aux": the [U]
        aux bits from the entries, "kinds": the term kinds present,
        "slots": the topology slots named, "overflow": the reps whose terms
        overflow}, or None when the batch cannot be covered: the caller
        compiles the legacy TermBank, counted. The term bucket grows from
        the entries' row count. Locking as `_stage_prologue`."""
        ts, bank = self.tstage, self.term_bank
        st = self.stats
        t0 = time.perf_counter()
        u = self._u_bucket
        self_aff = np.zeros(u, bool)
        has_aff = np.zeros(u, bool)
        has_anti = np.zeros(u, bool)
        n_sel = np.zeros(u, np.int32)
        with ts._lock:
            ts.ensure_current()
            gen0 = ts.generation
            idx_rows: List[int] = []
            owners: List[int] = []
            kinds: set = set()
            slots: set = set()
            overflow: List[int] = []
            stale = 0
            for b, (pod, pi) in enumerate(zip(reps, rep_infos)):
                entry = (ts.entry_for(pi.term_row, pi.term_gen, rep_keys[b])
                         if pi.pod is pod and pi.term_row >= 0 else None)
                if entry is None:
                    # stale (updated or deleted since admission, slab
                    # rebuilt, selectors changed, or admitted before the
                    # plane attached): re-intern the captured pod with this
                    # dispatch's selectors
                    stale += 1
                    sels = selectors.get(id(pod)) if selectors else None
                    pair = ts.ensure_entry(pod, sels)
                    if pair is None:
                        st["term_stale_rows"] += stale
                        return None
                    entry = ts._entries[pair[0]]
                    st["term_restaged"] += 1
                idx_rows.extend(entry.rows)
                owners.extend([b] * len(entry.rows))
                kinds |= entry.kinds
                slots |= entry.topo_slots
                if entry.overflow:
                    overflow.append(b)
                self_aff[b] = entry.self_aff_match
                has_aff[b] = entry.has_aff
                has_anti[b] = entry.has_anti
                n_sel[b] = entry.n_sel_spread
            st["term_stale_rows"] += stale
            if ts.generation != gen0:
                return None
            self._t_bucket = max(self._t_bucket, _bucket(max(len(idx_rows), 1)))
            t = self._t_bucket
            idx = np.zeros(t, np.int32)
            idx[: len(idx_rows)] = idx_rows
            own = np.zeros(t, np.int32)
            own[: len(idx_rows)] = owners
            keep = np.zeros(t, bool)
            keep[: len(idx_rows)] = True
            was_sync = bank.stats["sync_rows"]
            bank_dev, empty_dev = bank.current_arrays()
            if bank.stats["sync_rows"] != was_sync:
                st["term_sync_flushes"] += 1
        st["term_gather_s"] += time.perf_counter() - t0
        aux = {"self_aff_match": self_aff, "has_aff": has_aff, "has_anti": has_anti, "n_sel_spread": n_sel}
        return dict(problem=term_problem(bank_dev, idx, own, keep, empty_dev), aux=aux, kinds=kinds, slots=slots,
                    overflow=overflow)

    def _topology_shape(self, present: set, slots: set, aux: Dict[str, np.ndarray], reps: List[Pod],
                        gang: bool) -> frozenset:
        """Grow the monotone term-kind union, the segment-axis bucket and
        (not on a gang batch, whose solve tracks nothing) the in-batch
        tracking switch for this batch's terms (`present`: the term kind
        ints; `slots`: the topology slots they name); returns the batch's
        own term kinds. The axis covers the dense values of every slot a
        batch term or an existing pattern names plus the zones (the
        SelectorSpread blend); it is not clamped to the node count, since
        dense ids are grow-only and live ones can exceed it under node
        churn."""
        pats = self.mirror.pats
        kinds = _term_kind_names(present, bool(np.any(aux["n_sel_spread"] > 0)), pats)
        self._term_kinds = self._term_kinds | kinds
        self._track_inbatch = self._track_inbatch or (not gang and (
            "anti_req" in self._term_kinds or any(p.host_ports() for p in reps)
        ))
        vocab = self.mirror.vocab
        slots = set(slots) | set(np.asarray(pats.bank.topo_slot[pats.valid], np.int64).tolist())
        needed = [vocab.dense_size(int(sl)) for sl in slots if sl >= 0]
        needed.append(vocab.zone_count())
        self._v_bucket = max(self._v_bucket, _bucket(max(needed + [1])))
        return kinds

    def schedule_batch(self, max_pods: Optional[int] = None) -> ScheduleResult:
        res = ScheduleResult()
        infos = self.queue.pop_batch(max_pods or self.batch_size)
        if not infos:
            return res
        # gang completeness: every queued member of a group present in the
        # batch joins it, so all-or-nothing is decided over the whole group
        groups = [pod_group_name(i.pod) for i in infos]
        present = {g for g in groups if g}
        if present:
            extra = self.queue.pop_all_in_groups(present, pod_group_name)
            infos.extend(extra)
            groups.extend(pod_group_name(i.pod) for i in extra)
        is_gang = bool(present)
        cycle = self.queue.scheduling_cycle()
        self.stats["batches"] += 1
        try:
            out = self._solve_batch(infos, groups, is_gang)
        except BaseException:
            # nothing of the batch was committed: it goes back to the queue
            # before the error surfaces
            self.queue.requeue(infos)
            raise
        t3 = time.perf_counter()
        assign_l, nom_adds = out.assign, out.nom_adds
        # the reference's routes: the bulk path when nothing can change or
        # veto a device pick, else the arbiter's verdicts where they cover
        # the batch, else the per-pod loop (every gang batch)
        nominated_fn = self.queue.nominated_pods_for_node if self.queue.has_nominations() else _no_nominations
        fast_bulk = (
            not is_gang
            and self._commit_plane_statics_ok()
            and all(lv == RECHECK_NONE for lv in out.levels)
            and (nominated_fn is _no_nominations or nom_adds == self.queue.nomination_adds)
            and not out.existing_overflow
            and not any(out.fallback)
            and not (out.node_fallback_any and any(r < 0 for r in assign_l))
        )
        if fast_bulk:
            self._commit_bulk(infos, assign_l, cycle, res)
        elif self._arbiter_covers(out):
            self._commit_arbitrated(infos, out, cycle, res)
        else:
            self._commit_loop(infos, out, cycle, res, nominated_fn, groups)
        self.stats["commit_s"] += time.perf_counter() - t3
        return res

    def _solve_batch(self, infos: List[PodInfo], groups: List[str], is_gang: bool) -> SolveOutput:
        """Sync the mirror, encode (or gather) the batch and solve it on
        the device: the dispatch half of a batch, up to the assignment and
        the arbiter's verdicts on the host."""
        pods = [pi.pod for pi in infos]

        t0 = time.perf_counter()
        self.mirror.sync()
        t1 = time.perf_counter()
        self.stats["sync_s"] += t1 - t0
        # the snapshot moved: the oracle's affinity index rebuilds lazily
        self._aff_index = None
        self._aff_extra = []

        self._b_bucket = max(self._b_bucket, _bucket(len(pods)))
        pa, reps, sig, ta, aux, fallback, present_kinds, slots = self._encode(infos)
        batch_kinds = self._topology_shape(present_kinds, slots, aux, reps, gang=is_gang)
        levels = [_recheck_level(r) for r in reps]
        pb = {
            "sig": np.zeros(self._b_bucket, np.int32),
            "valid": np.zeros(self._b_bucket, bool),
            "priority": np.zeros(self._b_bucket, np.int32),
        }
        pb["sig"][: len(pods)] = sig
        pb["valid"][: len(pods)] = True
        # under a QueueSort plugin the pop order is the in-batch order: a
        # zero priority key makes the solve's order the batch positions
        if self.queue._less is None:
            pb["priority"][: len(pods)] = [p.get_priority() for p in pods]
        if self._ids is None:
            self._ids = F.make_ids(self.mirror.vocab)  # interned constants; stable
        pbt = arrays_to_torch(pb, self.device)
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
        use_sharded = self._use_sharded()
        solved: Dict = {}
        gang_ok = None
        if is_gang:
            self.stats["gang_batches"] += 1
            # group ids in first-seen order over the batch positions
            gid: Dict[str, int] = {}
            garr = np.full(self._b_bucket, -1, np.int32)
            for i, g in enumerate(groups):
                if g:
                    garr[i] = gid.setdefault(g, len(gid))
            gang_fn = self._sharded.gang if use_sharded else solve_pipeline_gang
            assign, score, gang_ok = gang_fn(
                na, pa, self._ids, key, arrays_to_torch({"group": garr}, self.device)["group"], pb=pbt,
                deterministic=self.deterministic, config=self.solve_config, term_kinds=self._term_kinds,
                ea=ea, ta=ta, au=au, xa=xa, n_buckets=self._v_bucket,
            )
        else:
            solve_fn = self._sharded if use_sharded else solve_pipeline
            assign, score = solve_fn(
                na, pa, self._ids, key, pb=pbt, deterministic=self.deterministic,
                config=self.solve_config, term_kinds=self._term_kinds,
                track_inbatch=self._track_inbatch,
                ea=ea, ta=ta, au=au, xa=xa, n_buckets=self._v_bucket, arbiter_inputs=solved,
            )
            if self._track_inbatch:
                self.stats["tracked_batches"] += 1
        # the commit arbiter, chained on the assignment on the device, for
        # the batches whose verdicts the commit can use: no gang group, a
        # pod that needs a re-check, every present term kind covered
        verdict = None
        if (self.commit_plane and not is_gang and kinds_covered(batch_kinds) and self._commit_plane_statics_ok()
                and any(lv != RECHECK_NONE for lv in levels)):
            arb_fn = self._sharded.arbitrate if use_sharded else arbitrate
            verdict = arb_fn(na, pa, ea, ta, self._ids, assign, pbt,
                                term_kinds=self._term_kinds, n_buckets=self._v_bucket, inputs=solved)
        assign_l = assign.cpu().numpy()[: len(pods)].tolist()
        verdicts = None if verdict is None else verdict.cpu().numpy()[: len(pods)].tolist()
        gang_ok_l = None if gang_ok is None else gang_ok.cpu().numpy()[: len(pods)].tolist()
        # the overlay's job ends with the solve: the resident banks mirror
        # the host again before any commit fold or row patch lands on them
        self.mirror.unfold_nominees()
        t3 = time.perf_counter()
        self.stats["solve_s"] += t3 - t2

        has_anti = aux["has_anti"]
        out = SolveOutput(
            assign=assign_l,
            fallback=[bool(fallback[u]) for u in sig],
            score=ScoreRows(score, sig),
            has_anti=[bool(has_anti[u]) for u in sig],
            levels=[levels[u] for u in sig],
            existing_overflow=bool(self.mirror.pats.overflow_rows),
            node_fallback_any=bool((self.mirror.nodes.fallback & self.mirror.nodes.valid).any()),
            inbatch_tracked=self._track_inbatch and not is_gang,
            nom_adds=nom_adds,
            verdicts=verdicts,
            gang_ok=gang_ok_l,
        )
        return out

    def _shards_now(self) -> int:
        """The shard count the next dispatch partitions the nodes over: the
        mesh's when the node capacity divides into it, else 0 (the
        single-device fallback: a small cluster on a large mesh; ref
        :1046)."""
        if self._sharded is None or self.mirror.nodes.capacity % self._mesh_shards != 0:
            return 0
        return self._mesh_shards

    def _use_sharded(self) -> bool:
        """Route this dispatch: the sharded programs on a mesh, unless the
        capacity does not divide into its shards — the one legal way off
        them, counted in stats["sharded_fallbacks"] and warned about once
        per entry into it (ref :1817-1845)."""
        use = self._shards_now() > 0
        if self._sharded is not None and not use:
            self.stats["sharded_fallbacks"] += 1
            if not self._sharded_fallback_logged:
                self._sharded_fallback_logged = True
                _log.warning("sharded solve FALLBACK: node capacity %d not divisible by %d mesh shards; "
                             "dispatching the single-device pipeline until the bucket grows",
                             self.mirror.nodes.capacity, self._mesh_shards)
        elif use:
            self._sharded_fallback_logged = False
        return use

    def _commit_plane_statics_ok(self) -> bool:
        """The deployment-static precondition of the bulk path and the
        arbiter's verdicts (ref :2947-2967): any extender, or any plugin at
        an extension point other than QueueSort, sends every batch to the
        per-pod loop, so such a scheduler never dispatches the arbiter."""
        if self.extenders:
            return False
        return not any(self.framework.has_plugins(point) for point in _HOST_POINTS)

    def _lean_bind(self) -> bool:
        """No Permit / PreBind / Bind / PostBind plugin and no binding
        extender: the bind pipeline reduces to the binder and the cache's
        finish (ref :3545-3552)."""
        fw = self.framework
        return (not any(fw.has_plugins(p) for p in ("permit", "pre_bind", "bind", "post_bind"))
                and not any(e.supports_bind() for e in self.extenders))

    def _pod_extenders(self, pod: Pod) -> List:
        """The extenders interested in this pod (IsInterested,
        core/extender.go:450; ref :2351)."""
        return [e for e in self.extenders if e.is_interested(pod)]

    def _arbiter_covers(self, out: SolveOutput) -> bool:
        """Can this batch commit straight from the arbiter's verdicts (ref
        driver.py:2969-2997)? The arbiter ran only where it covers every
        term kind of the batch; not with encoding or pattern overflow,
        outstanding nominations (their two-pass host re-check covers more
        than the solve's usage fold) or -1 pods beside fallback node
        rows."""
        if out.verdicts is None or out.existing_overflow or any(out.fallback):
            return False
        if self.queue.has_nominations() or out.nom_adds != self.queue.nomination_adds:
            return False
        return not (out.node_fallback_any and any(r < 0 for r in out.assign))

    def _commit_bulk(self, infos: List[PodInfo], assign_l: List[int], cycle: int, res: ScheduleResult) -> None:
        """The reference's bulk commit, in pop order: -1 pods take one
        batched preemption round (or go back as unschedulable), the rest are
        applied (`_apply`). Every pod is RECHECK_NONE and resources are
        sequenced by the solve's carry, so no commit can invalidate a later
        one."""
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
            jobs.append((info, assumed, node_name, None))
            res.assignments[info.pod.key()] = node_name
        res.scheduled += len(jobs)
        # the bulk and arbitrated routes run only without host plugins and
        # extenders: the lean pipeline
        self._submit_binds(jobs, True)

    def _submit_binds(self, jobs: List[Tuple[PodInfo, Pod, str, Optional[CycleState]]], lean: bool) -> None:
        """Submit (info, assumed pod, node, CycleState) bind jobs in
        BIND_WORKERS chunks: the lean chunk without plugins or a binding
        extender, else the full pipeline, one job a task when a Permit
        plugin may park a pod on another's allow()."""
        if not jobs:
            return
        if not lean and self.framework.has_plugins("permit"):
            for job in jobs:
                self._bind_pool.submit(self._bind_pipeline, *job)
            return
        step = max(1, -(-len(jobs) // BIND_WORKERS))
        run = self._bind_chunk if lean else self._bind_pipeline_chunk
        for i in range(0, len(jobs), step):
            self._bind_pool.submit(run, jobs[i : i + step])

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

    def _commit_arbitrated(self, infos: List[PodInfo], out: SolveOutput, cycle: int, res: ScheduleResult) -> None:
        """Commit a batch from the arbiter's verdicts (the reference's
        `_commit_arbitrated` without speculation): V_PLACE pods are applied
        (`_apply`), V_DEFER pods go back to the queue with no backoff (they
        conflicted with their own batch; they are not unschedulable),
        V_NOFIT pods take the batched preemption round (or are
        unschedulable). A pod deferred `_defer_escalate` times in a row
        escalates to the host oracle's re-placement (`_oracle_place`) after
        the apply, and preempts on the host when it fits nowhere."""
        name_of = self.mirror.name_of_row
        nodes = self.cache.snapshot.node_infos
        place: List[Tuple[PodInfo, int, str]] = []
        defers: List[Tuple[int, PodInfo]] = []
        preempt_fails: List[PodInfo] = []
        for i, (info, row, v) in enumerate(zip(infos, out.assign, out.verdicts)):
            if v == V_PLACE and row >= 0:
                node_name = name_of[row] if row < len(name_of) else None
                if node_name is None or node_name not in nodes:
                    defers.append((i, info))  # the node vanished under the solve
                    continue
                place.append((info, row, node_name))
            elif v == V_DEFER:
                defers.append((i, info))
            elif row < 0 and self.enable_preemption:
                preempt_fails.append(info)
            else:
                res.unschedulable += 1
                self._fail(info, cycle)
        kept_defers: List[PodInfo] = []
        escalate: List[Tuple[int, PodInfo]] = []
        for i, info in defers:
            k = info.pod.key()
            c = self._defer_counts.get(k, 0) + 1
            self._defer_counts[k] = c
            if c >= self._defer_escalate:
                self._defer_counts.pop(k, None)  # escalation consumes the budget
                escalate.append((i, info))
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
        try:
            self._apply(place, cycle, res)
        except BaseException:
            self.queue.requeue([info for _, info in escalate] + preempt_fails)
            raise
        self.stats["apply_s"] += time.perf_counter() - t0
        self.stats["arbiter_batches"] += 1
        self.stats["arbiter_place"] += res.scheduled - placed_before
        self.stats["arbiter_defer"] += len(defers)
        metas: Dict = {}
        commits: List[Tuple[Pod, str]] = []
        if escalate:
            # every escalated pod reads its score row and the matrix does not
            # change within the batch: one gather for all of them
            try:
                out.score.prefetch([i for i, _ in escalate])
            except BaseException:
                self.queue.requeue([info for _, info in escalate] + preempt_fails)
                raise
        for n, (i, info) in enumerate(escalate):
            self.stats["arbiter_escalated"] += 1
            pod = info.pod
            try:
                self.stats["oracle_places"] += 1
                node_name = self._oracle_place(pod, out.score[i], self._escalation_meta(pod, metas, commits))
                if node_name is not None and self._commit(info, node_name, cycle):
                    res.scheduled += 1
                    res.assignments[pod.key()] = node_name
                    commits.append((pod, node_name))
                    continue
                if node_name is None:
                    if self.enable_preemption and self._try_preempt(info):
                        res.preempted += 1
                        self._aff_index = None
                        self.queue.move_all_to_active()
                    self._fail(info, cycle)
                res.unschedulable += 1
            except BaseException:
                # the pods not yet handled go back before the error surfaces
                self.queue.requeue([e for _, e in escalate[n:]] + preempt_fails)
                raise
        if preempt_fails:
            self._preempt_deferred(preempt_fails, cycle, res)

    def _commit_loop(self, infos: List[PodInfo], out: SolveOutput, cycle: int, res: ScheduleResult,
                     nominated_fn, groups: List[str]) -> None:
        """The reference's per-pod commit loop (driver.py:3758-4035 without
        plugins, extenders, volumes and speculation): in pop order, so every
        re-check sees the batch's earlier assumes. A pick is re-checked by
        the full host oracle when the pod is RECHECK_FULL, its encoding
        overflowed, an existing pod's terms overflowed or its node holds
        nominations; by the batch-conflict index when it is RECHECK_LIGHT
        (or follows a required anti-affinity commit) and the solve's
        in-batch tracking no longer vouches for it; by a resource check
        once an earlier pod left the device's pick. A failed re-check, and
        a -1 that the batch's events may have made feasible, re-place
        through `_oracle_place`; a pod placed nowhere preempts on the host.
        Nothing is folded: the next sync re-ships the rows host-wins.

        Gang members (`groups[i]` non-empty) are prepared (assumed) as they
        are decided and staged in their group's GangRollbackRecord; their
        binds are submitted once the loop ends, for each group that is
        complete and holds its declared min-available. A member the solve
        dropped ("gang does not fit"), a member placed nowhere ("gang
        member: no fit", no preemption) or a short group rolls the whole
        group back: one bulk cache forget, the members failed and
        tombstoned in the conflict index, the residuals diverged; later
        members of a failed group fail ("gang incomplete")."""
        snap = self.cache.snapshot
        fw = self.framework
        # host plugins: Filter joins the full re-check, PreFilter may reject
        # the pod, Score and PostFilter take part in the selection, so every
        # placed pod re-ranks on the host (its score rows fetched in one
        # gather)
        host_filter = fw.has_plugins("filter")
        host_pre_filter = fw.has_plugins("pre_filter")
        force_host_rank = fw.has_plugins("score") or fw.has_plugins("post_filter")
        if force_host_rank:
            out.score.prefetch(range(len(infos)))
        lean = self._lean_bind()
        conflict_index = _BatchConflictIndex()
        # a batch of RECHECK_NONE pods without gang groups, Filter plugins
        # or extenders never reads the index
        index_needed = (out.gang_ok is not None or host_filter or bool(self.extenders)
                        or any(lv != RECHECK_NONE for lv in out.levels))
        # once a pod commits elsewhere than the solve chose, the solve's
        # carried residuals are stale for the rest of the batch
        residuals_diverged = False
        name_of = self.mirror.name_of_row
        jobs: List[Tuple[PodInfo, Pod, str, CycleState]] = []
        staged: Dict[str, GangRollbackRecord] = {}
        failed_groups: set = set()

        def rollback_group(g: str) -> None:
            nonlocal residuals_diverged
            failed_groups.add(g)
            # the forgotten assumes leave the snapshot under the oracle's index
            self._aff_index = None
            rec = staged.pop(g, None)
            if rec is None or not len(rec):
                return
            self.stats["gang_rollbacks"] += 1
            res.unschedulable += rec.rollback(self.cache, fw, self._fail, cycle,
                                              on_member=lambda m: conflict_index.remove(m.pod))
            residuals_diverged = True  # the staged capacity is released

        def index_commit(i: int, pod: Pod, node_name: str, placed: Optional[Pod] = None) -> None:
            c_node = snap.get(node_name) if index_needed else None
            if c_node is not None:
                conflict_index.add_commit(pod, c_node.node)
                self._aff_extra.append((placed or pod.with_node(node_name), c_node.node.labels))
                if out.has_anti[i]:
                    conflict_index.add_anti(pod, c_node.node)

        i = 0
        disposed = False
        try:
            for i, info in enumerate(infos):
                disposed = False
                pod = info.pod
                state = CycleState()
                group = groups[i]
                if group and group in failed_groups:
                    res.unschedulable += 1
                    disposed = True
                    self._fail(info, cycle)  # gang incomplete
                    continue
                if group and out.gang_ok is not None and not out.gang_ok[i]:
                    # the solve dropped the whole group in pass 2
                    rollback_group(group)
                    res.unschedulable += 1
                    disposed = True
                    self._fail(info, cycle)  # gang does not fit
                    continue
                row = out.assign[i]
                node_name = name_of[row] if 0 <= row < len(name_of) else None
                device_choice = node_name
                if host_pre_filter:
                    st = fw.run_pre_filter(state, pod)
                    if not st.is_success():
                        res.unschedulable += 1
                        if device_choice is not None:
                            # the solve charged this pod to a node it never takes
                            residuals_diverged = True
                        disposed = True
                        self._fail(info, cycle)  # rejected by PreFilter
                        continue
                level = out.levels[i]
                needs_full = out.fallback[i] or out.existing_overflow or host_filter or level == RECHECK_FULL
                # the solve sequenced anti-affinity and ports within the
                # batch: LIGHT re-checks are redundant while commits follow
                # its picks
                tracked_ok = out.inbatch_tracked and not residuals_diverged
                needs_light = (level == RECHECK_LIGHT or conflict_index.any_anti) and not tracked_ok
                # Score / PostFilter plugins and interested extenders that
                # filter or prioritize take part in the selection
                pod_host_rank = force_host_rank or (bool(self.extenders) and any(
                    e.supports_filter() or e.supports_prioritize() for e in self._pod_extenders(pod)))
                placed_attempted = False
                try:
                    if node_name is not None and pod_host_rank:
                        # no validation of the device pick: the host ranks anew
                        self.stats["oracle_places"] += 1
                        node_name = self._oracle_place(pod, out.score[i], self._pod_meta(pod), state)
                        placed_attempted = True
                    elif node_name is not None and (needs_full or nominated_fn(node_name)):
                        self.stats["oracle_rechecks"] += 1
                        meta = self._pod_meta(pod)
                        ok = snap.get(node_name) is not None and fits_considering_nominated(
                            pod, node_name, snap, nominated_fn, meta=meta)
                        if ok and host_filter:
                            ok = fw.run_filter(state, pod, snap.get(node_name)).is_success()
                        if not ok:
                            # invalidated by an earlier commit of the batch: re-place
                            # against the live snapshot, ranked by the device score
                            node_name = self._oracle_place(pod, out.score[i], meta, state)
                            placed_attempted = True
                    elif node_name is not None and needs_light:
                        self.stats["light_rechecks"] += 1
                        ok = not self._intra_batch_conflict(pod, node_name, conflict_index)
                        if ok and residuals_diverged:
                            ni = snap.get(node_name)
                            ok = ni is not None and pod_fits_resources(pod, ni)
                        if not ok:
                            self.stats["oracle_places"] += 1
                            node_name = self._oracle_place(pod, out.score[i], self._pod_meta(pod), state)
                            placed_attempted = True
                    elif node_name is not None and residuals_diverged:
                        # an earlier re-placement moved capacity the solve did not
                        # account for: a resource check on the live node first
                        ni = snap.get(node_name)
                        if ni is None or not pod_fits_resources(pod, ni):
                            node_name = self._oracle_place(pod, out.score[i], self._pod_meta(pod), state)
                            placed_attempted = True
                    if node_name is None and not placed_attempted and (
                        out.fallback[i] or out.existing_overflow or out.node_fallback_any or residuals_diverged
                        or _minus_one_could_fit(pod, conflict_index, res.preempted > 0, level)
                    ):
                        # the device mask may be conservatively wrong (overflowed
                        # encodings, excluded node rows, capacity charged to a node
                        # an earlier pod left, a constraint an earlier commit
                        # satisfied): the host oracle before declaring a no-fit
                        self.stats["oracle_places"] += 1
                        node_name = self._oracle_place(pod, out.score[i], self._pod_meta(pod), state)
                except ExtenderError:
                    # a wire failure, not a no-fit: the error path, never
                    # preemption (MakeDefaultErrorFunc's re-queue, factory.go:646)
                    res.errors += 1
                    if device_choice is not None:
                        residuals_diverged = True
                    disposed = True
                    self._fail(info, cycle)
                    continue
                if node_name is None:
                    if device_choice is not None:
                        # the solve charged this pod to a node it never took
                        residuals_diverged = True
                    if group:
                        # one member without a home sinks its group; gang
                        # members never preempt
                        rollback_group(group)
                        res.unschedulable += 1
                        disposed = True
                        self._fail(info, cycle)  # gang member: no fit
                        continue
                    preempted_now = self.enable_preemption and self._try_preempt(info)
                    if preempted_now:
                        res.preempted += 1
                        # victim deletes moved the snapshot under the index
                        self._aff_index = None
                        nominated_fn = self.queue.nominated_pods_for_node
                    res.unschedulable += 1
                    disposed = True
                    self._fail(info, cycle)
                    if preempted_now:
                        # victim deletions are cluster events (eventhandlers.go:127)
                        self.queue.move_all_to_active()
                    continue
                if group:
                    assumed = self._prepare_commit(info, node_name, cycle, state)
                    if assumed is None:  # failed by the prepare
                        rollback_group(group)
                        res.unschedulable += 1
                        disposed = True
                        continue
                    # from here the pod's disposition belongs to its group
                    staged.setdefault(group, GangRollbackRecord(group)).stage(info, assumed, node_name, state)
                    disposed = True
                    index_commit(i, pod, node_name, assumed)
                    if node_name != device_choice:
                        residuals_diverged = True
                    continue
                disposed = True
                if self._commit(info, node_name, cycle, state, jobs):
                    res.scheduled += 1
                    res.assignments[pod.key()] = node_name
                    index_commit(i, pod, node_name)
                    if node_name != device_choice:
                        residuals_diverged = True
                else:
                    res.unschedulable += 1
                    if device_choice is not None:
                        residuals_diverged = True
            # complete groups bind, unless the declared min-available says
            # part of the group was not even queued yet
            for g, rec in list(staged.items()):
                need = max(pod_group_min_available(m[0].pod) for m in rec.members)
                if need and len(rec) < need:
                    rollback_group(g)
                    continue
                del staged[g]
                for s_info, s_assumed, s_node, s_state in rec.members:
                    self._finalize_commit(s_info, s_assumed, s_node, s_state, jobs)
                    res.scheduled += 1
                    res.assignments[s_info.pod.key()] = s_node
        except BaseException:
            # the staged members of open groups (their assumes forgotten) and
            # the pods not yet handled go back before the error surfaces
            back: List[PodInfo] = []
            for rec in staged.values():
                rec.rollback(self.cache, fw, lambda m, _cycle: back.append(m), cycle)
            staged.clear()
            self._aff_index = None
            self.queue.requeue(back + infos[i + 1 if disposed else i:])
            raise
        finally:
            self._submit_binds(jobs, lean)

    def _prepare_commit(self, info: PodInfo, node_name: str, cycle: int, state: CycleState) -> Optional[Pod]:
        """The per-pod commit's first half (the reference's
        `_prepare_commit`): Reserve plugins, then assume the pod in the
        cache (a key the cache already tracks unreserves), then clear its
        nomination (DeleteNominatedPodIfExists, scheduler.go:529). Returns
        the assumed pod, or None after failing the pod. A gang member stays
        prepared until its group binds or rolls back."""
        pod = info.pod
        if not self.framework.run_reserve(state, pod, node_name).is_success():
            self._fail(info, cycle)
            return None
        assumed = pod.with_node(node_name)
        try:
            self.cache.assume_pod(assumed)
        except ValueError:
            self.framework.run_unreserve(state, pod, node_name)
            self._fail(info, cycle)
            return None
        self.queue.clear_nomination(pod.key())
        return assumed

    def _finalize_commit(self, info: PodInfo, assumed: Pod, node_name: str, state: Optional[CycleState],
                         jobs: Optional[List[Tuple[PodInfo, Pod, str, Optional[CycleState]]]] = None) -> None:
        """The second half (the reference's `_finalize_commit`): the bind
        pipeline on the bind pool, appended to `jobs` for a chunked
        submission or submitted at once."""
        if jobs is None:
            self._submit_binds([(info, assumed, node_name, state)], self._lean_bind())
        else:
            jobs.append((info, assumed, node_name, state))

    def _commit(self, info: PodInfo, node_name: str, cycle: int, state: Optional[CycleState] = None,
                jobs: Optional[List[Tuple[PodInfo, Pod, str, Optional[CycleState]]]] = None) -> bool:
        """Prepare and finalize one pod; False when the prepare failed it.
        `state` is the pod's CycleState from PreFilter on."""
        state = state if state is not None else CycleState()
        assumed = self._prepare_commit(info, node_name, cycle, state)
        if assumed is None:
            return False
        self._finalize_commit(info, assumed, node_name, state, jobs)
        return True

    # -- the host oracle ---------------------------------------------------------

    def _pod_meta(self, pod: Pod):
        """Predicate metadata for the host oracle, backed by a per-batch
        SnapshotAffinityIndex (the pod-independent halves built once, not
        per pod) plus the batch's loop commits replayed exactly. The index
        is rebuilt after anything the commits list does not capture: a
        sync, victim deletes."""
        if self._aff_index is None:
            self._aff_index = SnapshotAffinityIndex(self.cache.snapshot)
            self._aff_extra = []
        return compute_predicate_metadata(
            pod, self.cache.snapshot, enabled=self._enabled_preds,
            affinity_index=self._aff_index, affinity_extra=self._aff_extra,
        )

    def _escalation_meta(self, pod: Pod, memo: Dict, commits: List[Tuple[Pod, str]]):
        """`_pod_meta` for the arbiter's escalated pods, memoized per spec
        through one batch's escalation loop. The loop does not replay its
        commits into the affinity index (nor does the reference's), so a
        spec's inter-pod half stands as computed while the index does;
        its DoNotSchedule counts advance by the loop's commits made since
        (`_advance_spread`). Any other change to the snapshot — victim
        deletes, a bind failure's forget, an informer event — moves the
        cache's mutation count past those commits, and the metadata is
        computed afresh."""
        key = spec_key(pod)
        hit = memo.get(key)
        count = self.cache.mutation_count
        if hit is not None:
            meta, index, at_count, at_commit = hit
            new = commits[at_commit:]
            if index is self._aff_index and count - at_count == len(new) and self._advance_spread(pod, meta, new):
                memo[key] = (meta, index, count, len(commits))
                return meta
        meta = self._pod_meta(pod)
        memo[key] = (meta, self._aff_index, count, len(commits))
        return meta

    def _advance_spread(self, pod: Pod, meta, commits: List[Tuple[Pod, str]]) -> bool:
        """Add commits to `pod`'s DoNotSchedule metadata as
        compute_even_pods_spread_metadata would count them: a committed pod
        on a candidate node (the pod's node selector, every constraint
        key) of the pod's namespace matching a constraint's selector adds
        one to its node's pair; then the per-key minima. False when a
        commit's node is gone (the caller recomputes)."""
        m = meta.even_pods_spread
        if m is None or not commits:
            return True
        snap = self.cache.snapshot
        constraints = get_hard_spread_constraints(pod)
        pair_num = m.tp_pair_to_match_num
        for p, node_name in commits:
            ni = snap.get(node_name)
            if ni is None:
                return False
            labels = ni.node.labels
            if p.namespace != pod.namespace or not all(c.topology_key in labels for c in constraints):
                continue
            if not pod_match_node_selector(pod, ni):
                continue
            for c in constraints:
                if match_label_selector(c.label_selector, p.labels):
                    pair = (c.topology_key, labels[c.topology_key])
                    pair_num[pair] = pair_num.get(pair, 0) + 1
        mins: Dict[str, int] = {}
        for (k, _), num in pair_num.items():
            if k not in mins or num < mins[k]:
                mins[k] = num
        m.tp_key_min_match = mins
        return True

    def _intra_batch_conflict(self, pod: Pod, node_name: str, index: _BatchConflictIndex) -> bool:
        """Can an earlier commit of this batch invalidate pod → node_name?
        The LIGHT re-check: the device mask validated everything against
        the batch-start state, so only the batch's commits can break a
        LIGHT pod — a host-port collision on the node (commits are assumed
        into the live NodeInfo) or required anti-affinity in either
        direction (predicates.go:1284)."""
        ni = self.cache.snapshot.get(node_name)
        if ni is None:
            return True
        if pod.host_ports() and ni.host_port_conflict(pod):
            return True
        return index.anti_conflict(pod, ni.node)

    def _oracle_place(self, pod: Pod, score_row: np.ndarray, meta,
                      state: Optional[CycleState] = None) -> Optional[str]:
        """The host oracle's re-placement (ref driver.py:2388-2466): of the
        nodes feasible for `pod` on the live snapshot (this batch's assumes
        included) by the full predicate chain — nodes holding nominations
        also by the with-nominees pass (generic_scheduler.go:612-697) — the
        one with the best device score, the first in the zone-interleaved
        node order among equals.

        The reference checks every node, then ranks the feasible ones; the
        checks have no side effects, so walking the nodes best score first
        (node order among equals) and stopping at the first feasible one
        returns the same node after checking only the nodes ranked above
        it. With Filter, PostFilter or Score plugins, or an interested
        extender that filters or prioritizes, the feasible set as a whole
        takes part: the reference's full scan (`_host_ranked_place`)."""
        if self._host_ranked(pod):
            return self._host_ranked_place(pod, score_row, meta, state if state is not None else CycleState())
        snap = self.cache.snapshot
        nominated = self.queue.nominated_pods_for_node if self.queue.has_nominations() else _no_nominations
        order = self.cache.node_order()
        row_of = self.mirror.row_of
        rows = np.fromiter((row_of.get(c, -1) for c in order), dtype=np.int64, count=len(order))
        has = (rows >= 0) & (rows < len(score_row))
        scores = np.where(has, score_row[np.where(has, rows, 0)], 0)
        # stable: equal scores keep the node order
        for k in np.argsort(-scores, kind="stable"):
            cand = order[k]
            ni = snap.get(cand)
            if ni is None or not pod_fits_on_node(pod, ni, meta=meta)[0]:
                continue
            nominees = eligible_nominees(pod, cand, nominated)
            if nominees and not fits_with_nominees(pod, cand, snap, nominees, enabled=self._enabled_preds):
                continue
            return cand
        return None

    def _host_ranked(self, pod: Pod) -> bool:
        """Does anything on the host see the feasible set as a whole: a
        Filter, PostFilter or Score plugin, or an interested extender that
        filters or prioritizes?"""
        fw = self.framework
        if fw.has_plugins("filter") or fw.has_plugins("post_filter") or fw.has_plugins("score"):
            return True
        return any(e.supports_filter() or e.supports_prioritize() for e in self._pod_extenders(pod))

    def _host_ranked_place(self, pod: Pod, score_row: np.ndarray, meta, state: CycleState) -> Optional[str]:
        """The reference's full scan (ref :2396-2466): every node in node
        order through the predicate chain, the Filter plugins and the
        with-nominees pass; PostFilter over the feasible set; each
        interested extender's filter narrows it (on the snapshot's nodes)
        and its prioritize adds its weighted scores (HTTPExtender.prioritize
        applies the extender's weight, so they add as they come); the Score
        plugins add their weighted sum; the first maximum of device score +
        plugin + extender scores in node order wins. An extender's wire
        failure skips it when it is ignorable, else raises ExtenderError."""
        fw = self.framework
        snap = self.cache.snapshot
        run_filter = fw.run_filter if fw.has_plugins("filter") else None
        nominated = self.queue.nominated_pods_for_node if self.queue.has_nominations() else _no_nominations
        feasible: List[str] = []
        for cand in self.cache.node_order():
            ni = snap.get(cand)
            if ni is None or not pod_fits_on_node(pod, ni, meta=meta)[0]:
                continue
            if run_filter is not None and not run_filter(state, pod, ni).is_success():
                continue
            nominees = eligible_nominees(pod, cand, nominated)
            if nominees and not fits_with_nominees(pod, cand, snap, nominees, enabled=self._enabled_preds):
                continue
            feasible.append(cand)
        if not feasible:
            return None
        if fw.has_plugins("post_filter") and not fw.run_post_filter(state, pod, feasible, {}).is_success():
            return None
        ext_scores: Dict[str, int] = {}
        for e in self._pod_extenders(pod):
            snap_nodes = [snap.node_infos[n].node for n in feasible]
            if e.supports_filter():
                try:
                    names, _failed = e.filter(pod, snap_nodes)
                except Exception as err:
                    if not e.is_ignorable():
                        raise ExtenderError(str(err)) from err
                    names = feasible
                keep = set(names)
                feasible = [n for n in feasible if n in keep]
                if not feasible:
                    return None
                snap_nodes = [snap.node_infos[n].node for n in feasible]
            if e.supports_prioritize():
                try:
                    for n, sc in e.prioritize(pod, snap_nodes).items():
                        ext_scores[n] = ext_scores.get(n, 0) + sc
                except Exception as err:
                    if not e.is_ignorable():
                        raise ExtenderError(str(err)) from err
        plugin_scores = fw.run_scores(state, pod, feasible) if fw.has_plugins("score") else {}
        row_of = self.mirror.row_of
        best, best_score = None, None
        for cand in feasible:
            row = row_of.get(cand)
            sc = int(score_row[row]) if row is not None and row < len(score_row) else 0
            sc += plugin_scores.get(cand, 0) + ext_scores.get(cand, 0)
            if best_score is None or sc > best_score:
                best, best_score = cand, sc
        return best

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
        # extenders with a preemption verb trim or veto the victims
        # (processPreemptionWithExtenders, core/generic_scheduler.go:323-345;
        # consulted on the chosen node, as the reference does)
        from ..extender.types import Victims  # the extender package imports this module

        for e in self.extenders:
            if not (e.supports_preemption() and e.is_interested(pod)):
                continue
            try:
                result = e.process_preemption(pod, {node: Victims(pods=list(victims))})
            except Exception:
                if e.is_ignorable():
                    continue
                return False
            kept = result.get(node)
            if kept is None:
                return False  # the extender vetoed the node
            keep = set(kept.pod_uids)
            victims = [v for v in victims if v.uid in keep]
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
        self.stats["preempted"] += 1
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
        stand, the unschedulable pods move back (MoveAllToActiveQueue). A
        failed victim search raises once the pods not yet handled are back
        in the queue."""
        t0 = time.perf_counter()
        self.stats["preempt_batches"] += 1
        pdbs = self.pdb_lister()
        any_preempted = False
        any_fits_free = False
        k = 0
        try:
            plans = None
            if self._enabled_preds is None and not any(e.supports_preemption() for e in self.extenders):
                plans = preemption_mod.batch_preempt_device(
                    [i.pod for i in fails], self.cache.snapshot, pdbs=pdbs, can_disrupt=self._can_disrupt,
                    nominated=self.queue.nomination_extras({i.pod.key() for i in fails}), device=self.device,
                )
            for k, info in enumerate(fails):
                pod = info.pod
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
                if applied:
                    res.preempted += 1
                    any_preempted = True
                    # victim deletes moved the snapshot under the oracle's index
                    self._aff_index = None
                res.unschedulable += 1
                self._fail(info, cycle)
        except BaseException:
            # the pods not yet handled go back before the error surfaces
            self.queue.requeue(fails[k:])
            raise
        finally:
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

    def _bind_chunk(self, items: List[Tuple[PodInfo, Pod, str, Optional[CycleState]]]) -> None:
        """Bind a chunk through the lean pipeline (binder, then the cache's
        finish); a failed bind unbinds the pod (`_unbind`)."""
        finished: List[Pod] = []
        for info, assumed, node_name, state in items:
            try:
                self.binder.bind(info.pod, node_name)
            except Exception:  # the bind RPC failed: forget + requeue
                self._unbind(info, assumed, node_name, state)
                continue
            finished.append(assumed)
        self.cache.finish_bindings(finished)

    def _bind_pipeline_chunk(self, items: List[Tuple[PodInfo, Pod, str, Optional[CycleState]]]) -> None:
        for job in items:
            self._bind_pipeline(*job)

    def _bind_pipeline(self, info: PodInfo, assumed: Pod, node_name: str, state: Optional[CycleState]) -> None:
        """The full bind pipeline (scheduler.go:631-743; ref :2540-2595):
        Permit (a WAIT parks the pod until allow, reject or timeout),
        PreBind, then the bind — by an interested extender with a bind verb
        (extendersBinding), else by a Bind plugin that does not skip, then
        the binder — and PostBind. Any failure unbinds the pod."""
        pod = info.pod
        state = state if state is not None else CycleState()
        fw = self.framework
        try:
            if not fw.run_permit(state, pod, node_name).is_success():
                self._unbind(info, assumed, node_name, state)
                return
            if not fw.run_pre_bind(state, pod, node_name).is_success():
                self._unbind(info, assumed, node_name, state)
                return
            ext = next((e for e in self.extenders if e.supports_bind() and e.is_interested(pod)), None)
            if ext is not None:
                ext.bind(pod, node_name)
            else:
                st = fw.run_bind(state, pod, node_name)
                if st.code not in (0, 4):  # neither SUCCESS nor SKIP
                    raise RuntimeError(st.message)
                self.binder.bind(pod, node_name)
        except Exception:  # the bind failed: forget + requeue
            self._unbind(info, assumed, node_name, state)
            return
        self.cache.finish_bindings([assumed])
        fw.run_post_bind(state, pod, node_name)

    def _unbind(self, info: PodInfo, assumed: Pod, node_name: str, state: Optional[CycleState]) -> None:
        """A bind pipeline failure (ref :2617): forget the assume, run the
        Unreserve plugins and retry the pod through the backoff tier
        (MakeDefaultErrorFunc)."""
        self.cache.forget_pod(assumed)
        self.framework.run_unreserve(state if state is not None else CycleState(), info.pod, node_name)
        self.queue.requeue_backoff(info)

    # -- loop and lifecycle --------------------------------------------------

    def run_until_empty(self, max_cycles: int = 1000) -> ScheduleResult:
        total = ScheduleResult()
        for _ in range(max_cycles):
            r = self.schedule_batch()
            total.scheduled += r.scheduled
            total.unschedulable += r.unschedulable
            total.errors += r.errors
            total.preempted += r.preempted
            total.deferred += r.deferred
            total.assignments.update(r.assignments)
            if r.scheduled == 0 and r.unschedulable == 0 and r.errors == 0 and r.deferred == 0:
                break
        return total

    def wait_for_binds(self) -> None:
        """Drain the bind pool (tests/benchmarks); no-op after close()."""
        if self._closed:
            return
        self._bind_pool.shutdown(wait=True)
        self._bind_pool = ThreadPoolExecutor(max_workers=BIND_WORKERS, thread_name_prefix="bind")

    # the reference's warm-up, speculation, tracing and fault-service
    # methods: refused, naming their ROADMAP items
    def warmup(self, max_pods: Optional[int] = None) -> int:
        raise NotImplementedError(f"Scheduler.warmup: {_SPECULATION}")

    @property
    def ready(self) -> bool:
        raise NotImplementedError(f"Scheduler.ready: {_SPECULATION}")

    def flush_speculative(self) -> int:
        raise NotImplementedError(f"Scheduler.flush_speculative: {_SPECULATION}")

    def abort(self) -> None:
        raise NotImplementedError(f"Scheduler.abort: {_OBSERVABILITY}")

    def dump_trace(self, path: str) -> str:
        raise NotImplementedError(f"Scheduler.dump_trace: {_OBSERVABILITY}")

    def enable_health_monitor(self, *args, **kwargs):
        raise NotImplementedError(f"Scheduler.enable_health_monitor: {_OBSERVABILITY}")

    def service_faults(self) -> None:
        raise NotImplementedError(f"Scheduler.service_faults: {_OBSERVABILITY}")

    def close(self) -> None:
        """Finish in-flight binds, retire the bind pool and flush both
        slabs' dirty rows into their twins (ref :4192). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._bind_pool.shutdown(wait=True)
        for bank in (self.stage_bank, self.term_bank):
            if bank is not None:
                bank.close()
