"""Preemption: victim selection when no node fits.

The port's copy of `kubernetes_tpu/scheduler/preemption.py`. Reference:
core/generic_scheduler.go Preempt (:313), selectNodesForPreemption
(:1007), selectVictimsOnNode (:1104), filterPodsWithPDBViolation (:1055),
pickOneNodeForPreemption (:878), nodesWherePreemptionMightHelp (:1218),
podFitsOnNode's nominated-pods two-pass rule (:612-697).

* `batch_preempt_device` — one device victim search for a whole batch of
  failed pods (ops/preempt.preempt_batch: the kernel on the card, its
  plain version on the CPU), sequentially consistent across preemptors;
  None for a batch outside the kernel's exact domain.
* `preempt` — the host answer for one pod: with no terms in play the
  affinity-free fast path (`_select_victims_fast`, exact arithmetic over
  the node's aggregates), else the slow path (`select_victims_on_node`:
  the full predicate chain on a copy-on-write shadow of the node), then
  the six-key pick.
* `fits_considering_nominated` / `fits_with_nominees` — the two-pass
  nominee re-check the driver's host oracle runs on nominated nodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.selectors import match_label_selector
from ..api.types import (
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Pod,
    PodDisruptionBudget,
)
from ..oracle.nodeinfo import DEFAULT_BIND_ALL_HOST_IP, NodeInfo, Snapshot, accumulated_request
from ..oracle.predicates import (
    check_node_unschedulable,
    compute_predicate_metadata,
    get_pod_affinity_terms,
    get_pod_anti_affinity_terms,
    pod_fits_host,
    pod_fits_on_node,
    pod_match_node_selector,
    pod_tolerates_node_taints,
)
from ..ops.preempt import preempt_batch
from ..state.convert import arrays_to_torch
from ..state.tensors import _bucket, _node_bucket, spec_key

NominatedFn = Callable[[str], List[Pod]]


@dataclass
class Victims:
    pods: List[Pod]
    num_pdb_violations: int = 0


def _shadow_one(snapshot: Snapshot, node_name: str) -> Snapshot:
    """Copy-on-write snapshot that clones only node_name's pod list (the one
    thing the victim search and the nominee simulation mutate); every other
    NodeInfo is shared with the source."""
    shadow = Snapshot()
    for n, info in snapshot.node_infos.items():
        if n == node_name:
            si = shadow.add_node(info.node)
            si.set_pods(info.pods)
        else:
            shadow.node_infos[n] = info
    return shadow


def eligible_nominees(pod: Pod, node_name: str, nominated_fn: Optional[NominatedFn]) -> List[Pod]:
    """Nominated pods the two-pass rule must count for `pod` on this node:
    someone else's nomination with equal-or-higher priority
    (generic_scheduler.go:620-630)."""
    if nominated_fn is None:
        return []
    prio = pod.get_priority()
    return [p for p in nominated_fn(node_name) if p.key() != pod.key() and p.get_priority() >= prio]


def fits_considering_nominated(
    pod: Pod,
    node_name: str,
    snapshot: Snapshot,
    nominated_fn: Optional[NominatedFn],
    meta=None,
) -> bool:
    """podFitsOnNode's two-pass rule (generic_scheduler.go:612-697): when
    the node has nominated pods of priority >= the incoming pod's, the
    predicates must pass both with those pods counted and without them
    (nominated pods may never arrive, and their absence can break the
    incoming pod's required pod affinity)."""
    ni = snapshot.get(node_name)
    if ni is None:
        return False
    nominees = eligible_nominees(pod, node_name, nominated_fn)
    if meta is None:
        meta = compute_predicate_metadata(pod, snapshot)
    if not pod_fits_on_node(pod, ni, meta=meta)[0]:
        return False
    if not nominees:
        return True
    return fits_with_nominees(pod, node_name, snapshot, nominees, enabled=meta.enabled)


def fits_with_nominees(
    pod: Pod,
    node_name: str,
    snapshot: Snapshot,
    nominees: Sequence[Pod],
    enabled: Optional[frozenset] = None,
) -> bool:
    """The with-nominated-pods pass alone (the caller has checked the plain
    pass)."""
    shadow = _shadow_one(snapshot, node_name)
    sni = shadow.get(node_name)
    for p in nominees:
        sni.add_pod(p.with_node(node_name))
    meta2 = compute_predicate_metadata(pod, shadow, enabled=enabled)
    return pod_fits_on_node(pod, sni, meta=meta2)[0]


def pod_eligible_to_preempt_others(pod: Pod, snapshot: Snapshot) -> bool:
    """podEligibleToPreemptOthers (:847): a pod that already nominated a node
    where a lower-priority pod is terminating must wait."""
    if pod.nominated_node_name:
        ni = snapshot.get(pod.nominated_node_name)
        if ni is not None:
            for p in ni.pods:
                if p.deletion_timestamp is not None and p.get_priority() < pod.get_priority():
                    return False
    return True


def nodes_where_preemption_might_help(pod: Pod, snapshot: Snapshot) -> List[str]:
    """:1218 — skip nodes whose failure cannot be resolved by removing pods
    (node selector, taints, unschedulable, name pinning are unresolvable)."""
    out = []
    for name, ni in snapshot.node_infos.items():
        if not check_node_unschedulable(pod, ni):
            continue
        if not pod_fits_host(pod, ni):
            continue
        if not pod_match_node_selector(pod, ni):
            continue
        if not pod_tolerates_node_taints(pod, ni):
            continue
        out.append(name)
    return out


def _pods_violating_pdbs(
    pods: Sequence[Pod], pdbs: Sequence[PodDisruptionBudget]
) -> Tuple[List[Pod], List[Pod]]:
    """filterPodsWithPDBViolation (:1055): a pod 'violates' when it matches a
    PDB (same namespace, selector) whose disruptionsAllowed is exhausted."""
    violating, non_violating = [], []
    for p in pods:
        hit = False
        for pdb in pdbs:
            if pdb.namespace != p.namespace or pdb.selector is None:
                continue
            # an EMPTY selector matches nothing here (the reference does
            # `if selector.Empty() || !selector.Matches(...) { continue }`,
            # generic_scheduler.go:1069) — the opposite of the usual
            # empty-selector-matches-all label semantics
            if not pdb.selector.match_labels and not pdb.selector.match_expressions:
                continue
            if match_label_selector(pdb.selector, p.labels):
                if pdb.disruptions_allowed <= 0:
                    hit = True
        (violating if hit else non_violating).append(p)
    return violating, non_violating


def _importance(p: Pod) -> Tuple[int, float]:
    """util.MoreImportantPod sort key: higher priority first, then earlier
    start (approximated by creation timestamp)."""
    return (-p.get_priority(), p.creation_timestamp)


def select_victims_on_node(
    pod: Pod,
    node_name: str,
    snapshot: Snapshot,
    pdbs: Sequence[PodDisruptionBudget] = (),
    can_disrupt: Optional[Callable[[Pod], bool]] = None,
    enabled: Optional[frozenset] = None,
    static_meta=None,
) -> Optional[Victims]:
    """selectVictimsOnNode (:1104): remove every lower-priority pod; if the
    pod then fits, reprieve them most-important-first — PDB-protected pods
    first; those that cannot be reprieved count as PDB violations for the
    pick. `can_disrupt` narrows the victims (the driver excludes pods whose
    bind is in flight). `static_meta`: predicate metadata that no victim
    removal can change, computed once by the caller."""
    ni = snapshot.get(node_name)
    if ni is None:
        return None
    prio = pod.get_priority()
    potential = [p for p in ni.pods if p.get_priority() < prio and (can_disrupt is None or can_disrupt(p))]
    if not potential:
        return None

    shadow = _shadow_one(snapshot, node_name)
    sni = shadow.get(node_name)
    victims_set = {id(p) for p in potential}
    sni.set_pods([p for p in sni.pods if id(p) not in victims_set])

    def fits() -> bool:
        meta = static_meta if static_meta is not None else compute_predicate_metadata(pod, shadow, enabled=enabled)
        return pod_fits_on_node(pod, sni, meta=meta)[0]

    if not fits():
        return None

    violating, non_violating = _pods_violating_pdbs(potential, pdbs)
    victims: List[Pod] = []
    num_violations = 0

    def reprieve(p: Pod) -> bool:
        sni.add_pod(p)
        if fits():
            return True
        sni.remove_pod(p)
        victims.append(p)
        return False

    for p in sorted(violating, key=_importance):
        if not reprieve(p):
            num_violations += 1
    for p in sorted(non_violating, key=_importance):
        reprieve(p)
    if not victims:
        return None
    return Victims(pods=victims, num_pdb_violations=num_violations)


def _select_victims_fast(
    pod: Pod,
    ni: Optional[NodeInfo],
    pdbs: Sequence[PodDisruptionBudget],
    can_disrupt: Optional[Callable[[Pod], bool]],
    nominee_charge: Optional[Tuple[Dict[str, int], int]] = None,
) -> Optional[Victims]:
    """selectVictimsOnNode for the static case (no (anti-)affinity or spread
    terms anywhere, the default predicate set): the only pod-dependent
    predicates are PodFitsResources and PodFitsHostPorts, the node-constant
    ones already held by nodes_where_preemption_might_help. So the victim
    search is arithmetic over the node's aggregates, with
    pod_fits_resources' compare rules (predicates.go:854, :886-895).

    `nominee_charge` = (summed requests, pod count) of the pods nominated
    to this node other than the preemptor: the victim search's fit check
    counts them (selectVictimsOnNode :1160 → podFitsOnNode pass 1). All
    nominees count regardless of priority (conservative against the
    reference's >= filter; the same aggregate as ops/preempt)."""
    if ni is None:
        return None
    prio = pod.get_priority()
    potential = [
        p
        for p in ni.pods
        if p.get_priority() < prio and (can_disrupt is None or can_disrupt(p))
    ]
    if not potential:
        return None

    req = pod.resource_request()
    check_res = not all(v == 0 for k, v in req.items() if k != "pods")
    alloc = ni.node.allocatable_int()
    allowed = ni.allowed_pod_number()
    used = dict(ni.requested())
    count = len(ni.pods)
    if nominee_charge is not None:
        nreq, ncnt = nominee_charge
        for rname, val in nreq.items():
            used[rname] = used.get(rname, 0) + val
        count += ncnt
    pod_ports = pod.host_ports()
    for v in potential:
        for rname, val in accumulated_request(v).items():
            used[rname] = used.get(rname, 0) - val
    count -= len(potential)
    port_counts: Optional[Dict[Tuple[str, str, int], int]] = None
    if pod_ports:
        port_counts = {}
        victim_ids = {id(p) for p in potential}
        for p in ni.pods:
            if id(p) not in victim_ids:
                for t in p.host_ports():
                    port_counts[t] = port_counts.get(t, 0) + 1

    def fits() -> bool:
        # PodFitsResources (predicates.go:854): count always; cpu/mem/
        # ephemeral unconditionally when anything is requested; scalars
        # only when requested non-zero
        if count + 1 > allowed:
            return False
        if check_res:
            for name in (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE):
                if alloc.get(name, 0) < req.get(name, 0) + used.get(name, 0):
                    return False
            for name, r in req.items():
                if name in (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE, "pods"):
                    continue
                if r != 0 and alloc.get(name, 0) < r + used.get(name, 0):
                    return False
        if port_counts is not None:
            # HostPortInfo.CheckConflict: 0.0.0.0 conflicts with every IP
            # for the same (protocol, port)
            live = [t for t, c in port_counts.items() if c > 0]
            for proto, ip, port in pod_ports:
                if port <= 0:
                    continue
                if ip == DEFAULT_BIND_ALL_HOST_IP:
                    if any(up == port and upr == proto for upr, _, up in live):
                        return False
                else:
                    for upr, uip, up in live:
                        if up == port and upr == proto and uip in (DEFAULT_BIND_ALL_HOST_IP, ip):
                            return False
        return True

    if not fits():
        return None

    violating, non_violating = _pods_violating_pdbs(potential, pdbs)
    victims: List[Pod] = []
    num_violations = 0

    def reprieve(p: Pod) -> bool:
        nonlocal count
        for rname, val in accumulated_request(p).items():
            used[rname] = used.get(rname, 0) + val
        count += 1
        if port_counts is not None:
            for t in p.host_ports():
                port_counts[t] = port_counts.get(t, 0) + 1
        if fits():
            return True
        for rname, val in accumulated_request(p).items():
            used[rname] = used.get(rname, 0) - val
        count -= 1
        if port_counts is not None:
            for t in p.host_ports():
                port_counts[t] -= 1
        victims.append(p)
        return False

    for p in sorted(violating, key=_importance):
        if not reprieve(p):
            num_violations += 1
    for p in sorted(non_violating, key=_importance):
        reprieve(p)
    if not victims:
        return None
    return Victims(pods=victims, num_pdb_violations=num_violations)


def pick_one_node_for_preemption(candidates: Dict[str, Victims]) -> Optional[str]:
    """pickOneNodeForPreemption (:878) tie-break chain:
    1. fewest PDB violations  2. lowest highest-victim-priority
    3. smallest priority sum  4. fewest victims
    5. latest start time of the highest-priority victim  6. first."""
    if not candidates:
        return None
    names = list(candidates)

    def keep_min(names: List[str], keyfn) -> List[str]:
        vals = {n: keyfn(candidates[n]) for n in names}
        m = min(vals.values())
        return [n for n in names if vals[n] == m]

    names = keep_min(names, lambda v: v.num_pdb_violations)
    if len(names) == 1:
        return names[0]
    names = keep_min(names, lambda v: max(p.get_priority() for p in v.pods))
    if len(names) == 1:
        return names[0]
    names = keep_min(names, lambda v: sum(p.get_priority() for p in v.pods))
    if len(names) == 1:
        return names[0]
    names = keep_min(names, lambda v: len(v.pods))
    if len(names) == 1:
        return names[0]
    # latest (max) start time among each node's highest-priority victim
    names = keep_min(
        names,
        lambda v: -max(
            p.creation_timestamp
            for p in v.pods
            if p.get_priority() == max(q.get_priority() for q in v.pods)
        ),
    )
    return names[0]


def _has_terms(pod: Pod) -> bool:
    return bool(
        get_pod_affinity_terms(pod.affinity)
        or get_pod_anti_affinity_terms(pod.affinity)
        or pod.topology_spread_constraints
    )


def _existing_anti_affinity(snapshot: Snapshot) -> bool:
    return any(
        get_pod_anti_affinity_terms(ep.affinity)
        for ni in snapshot.node_infos.values()
        for ep in ni.pods_with_affinity()
    )


def preempt_arrays(
    pods: Sequence[Pod],
    snapshot: Snapshot,
    pdbs: Sequence[PodDisruptionBudget] = (),
    can_disrupt: Optional[Callable[[Pod], bool]] = None,
    nominated: Sequence[Tuple[str, Pod]] = (),
    max_victim_slots: int = 64,
    max_bytes: int = 64 << 20,
):
    """The padded numpy inputs of ops/preempt.preempt_batch for these
    preemptors on this snapshot, as (arrays, node names by row, victim pods
    by row in slot order) — or None when the batch is outside the kernel's
    exact domain ((anti-)affinity or spread terms or host ports on a
    preemptor, required anti-affinity on an existing pod, a preemptor that
    must wait for its nominated node, more than `max_victim_slots` pods on
    a node, or padded victim tensors above `max_bytes`)."""
    if _existing_anti_affinity(snapshot):
        return None
    for p in pods:
        if _has_terms(p) or p.host_ports() or not pod_eligible_to_preempt_others(p, snapshot):
            return None

    names = list(snapshot.node_infos)
    n = len(names)
    if n == 0:
        return None
    # local resource-slot map (cpu/mem/ephemeral fixed in slots 0-2, the
    # scalars in order of appearance) — independent of the mirror's vocab
    slots: Dict[str, int] = {}

    def slot_of(rname: str) -> int:
        s = slots.get(rname)
        if s is None:
            s = len(slots)
            slots[rname] = s
        return s

    for rn in (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE):
        slot_of(rn)
    reqs = []
    for p in pods:
        reqs.append({k: v for k, v in p.resource_request().items() if k != RESOURCE_PODS})
        for rn in reqs[-1]:
            slot_of(rn)
    for _, npod in nominated:
        for rn in accumulated_request(npod):
            if rn != RESOURCE_PODS:
                slot_of(rn)
    victims_by_node: List[List[Pod]] = []
    vio_by_node: List[set] = []
    vict_reqs: List[List[Dict[str, int]]] = []
    v_max = 1
    for name in names:
        ni = snapshot.node_infos[name]
        pool = [p for p in ni.pods if can_disrupt is None or can_disrupt(p)]
        violating, non_violating = _pods_violating_pdbs(pool, pdbs)
        vio_by_node.append({id(p) for p in violating})
        ordered = sorted(violating, key=_importance) + sorted(non_violating, key=_importance)
        victims_by_node.append(ordered)
        rr = []
        for p in ordered:
            d = {k: v for k, v in accumulated_request(p).items() if k != RESOURCE_PODS}
            for rn in d:
                slot_of(rn)
            rr.append(d)
        vict_reqs.append(rr)
        v_max = max(v_max, len(ordered))
    if v_max > max_victim_slots:
        return None
    r_cap = _bucket(len(slots), 8)
    v_cap = _bucket(v_max, 8)
    n_pad = _node_bucket(n)
    # guard the padded allocation (the victim tensors are built at the
    # node-axis rung, up to ~2x the raw node count)
    if n_pad * v_cap * r_cap * 8 > max_bytes:
        return None

    b = len(pods)
    # the reference's padded axes (preemptors and slots to power-of-two
    # rungs, nodes to the node-axis rung). Padded rows are inert: p_valid
    # False kills their step's pick, node_valid / cand False keep phantom
    # nodes out of every fit check
    b_pad = _bucket(b, 8)
    p_req = np.zeros((b_pad, r_cap), np.int64)
    p_req_any = np.zeros(b_pad, bool)
    p_prio = np.zeros(b_pad, np.int32)
    p_valid = np.zeros(b_pad, bool)
    p_valid[:b] = True
    for k, d in enumerate(reqs):
        for rn, val in d.items():
            p_req[k, slots[rn]] = val
        p_req_any[k] = any(v != 0 for v in d.values())
        p_prio[k] = pods[k].get_priority()
    vict_req = np.zeros((n_pad, v_cap, r_cap), np.int64)
    vict_prio = np.zeros((n_pad, v_cap), np.int32)
    vict_ts = np.zeros((n_pad, v_cap), np.int64)
    vict_pdb = np.zeros((n_pad, v_cap), bool)
    vict_valid = np.zeros((n_pad, v_cap), bool)
    free0 = np.zeros((n_pad, r_cap), np.int64)
    count_free0 = np.zeros(n_pad, np.int32)
    node_valid = np.zeros(n_pad, bool)
    node_valid[:n] = True
    # out-of-batch nominee reservations (the queue's nominated index minus
    # this batch): charged into the fit checks, as podFitsOnNode's pass 1
    # counts nominated pods
    nom_extra0 = np.zeros((n_pad, r_cap), np.int64)
    nom_cnt0 = np.zeros(n_pad, np.int32)
    row_of_name = {name: i for i, name in enumerate(names)}
    for node, npod in nominated:
        row = row_of_name.get(node)
        if row is None:
            continue
        for rn, val in accumulated_request(npod).items():
            if rn != RESOURCE_PODS:
                nom_extra0[row, slots[rn]] += val
        nom_cnt0[row] += 1
    for i, name in enumerate(names):
        ni = snapshot.node_infos[name]
        alloc = ni.node.allocatable_int()
        used = ni.requested()
        for rn, s in slots.items():
            free0[i, s] = alloc.get(rn, 0) - used.get(rn, 0)
        count_free0[i] = ni.allowed_pod_number() - len(ni.pods)
        vio_set = vio_by_node[i]
        for j, p in enumerate(victims_by_node[i]):
            vict_valid[i, j] = True
            vict_prio[i, j] = p.get_priority()
            vict_ts[i, j] = int(p.creation_timestamp * 1e6)
            vict_pdb[i, j] = id(p) in vio_set
            for rn, val in vict_reqs[i][j].items():
                vict_req[i, j, slots[rn]] = val
    # candidate mask: the four unresolvable predicates, once per unique
    # spec (replicas share the row) — nodesWherePreemptionMightHelp :1218
    cand = np.zeros((b_pad, n_pad), bool)
    mask_of: Dict[object, np.ndarray] = {}
    for k, p in enumerate(pods):
        key = spec_key(p)
        m = mask_of.get(key)
        if m is None:
            m = np.array(
                [
                    check_node_unschedulable(p, snapshot.node_infos[nm])
                    and pod_fits_host(p, snapshot.node_infos[nm])
                    and pod_match_node_selector(p, snapshot.node_infos[nm])
                    and pod_tolerates_node_taints(p, snapshot.node_infos[nm])
                    for nm in names
                ],
                bool,
            )
            mask_of[key] = m
        cand[k, :n] = m

    arrays = {
        "cand": cand, "p_req": p_req, "p_req_any": p_req_any, "p_prio": p_prio, "p_valid": p_valid,
        "vict_req": vict_req, "vict_prio": vict_prio, "vict_ts": vict_ts, "vict_pdb": vict_pdb,
        "vict_valid": vict_valid, "free0": free0, "count_free0": count_free0, "node_valid": node_valid,
        "nom_extra0": nom_extra0, "nom_cnt0": nom_cnt0,
    }
    return arrays, names, victims_by_node


def batch_preempt_device(
    pods: Sequence[Pod],
    snapshot: Snapshot,
    pdbs: Sequence[PodDisruptionBudget] = (),
    can_disrupt: Optional[Callable[[Pod], bool]] = None,
    nominated: Sequence[Tuple[str, Pod]] = (),
    max_victim_slots: int = 64,
    max_bytes: int = 64 << 20,
    device="cpu",
):
    """One device victim search for a whole batch of failed pods
    (ops/preempt.preempt_batch on `device`): every preemptor against every
    candidate node, earlier preemptors' victims gone and their nominations
    charged for later ones.

    Returns a list aligned with `pods` of (node_name or None, [victim Pods
    in reprieve order], fits_free) — fits_free: the pod fits a candidate
    node without eviction at its step's state, so the caller retries it —
    or None when the batch is outside the kernel's exact domain
    (`preempt_arrays`): the caller then answers with `preempt`. The caller
    re-verifies each plan against the live snapshot before applying it."""
    built = preempt_arrays(pods, snapshot, pdbs, can_disrupt, nominated, max_victim_slots, max_bytes)
    if built is None:
        return None
    arrays, names, victims_by_node = built
    nodes_out, victims_out, fits_free_out = preempt_batch(**arrays_to_torch(arrays, torch.device(device)))
    nodes_out = nodes_out.cpu().numpy()
    victims_out = victims_out.cpu().numpy()
    fits_free_out = fits_free_out.cpu().numpy()
    plans = []
    for k in range(len(pods)):
        row = int(nodes_out[k])
        if row < 0:
            # fits_free: no eviction needed (a stale -1); plain None: no
            # eviction possible
            plans.append((None, [], bool(fits_free_out[k])))
            continue
        mask = victims_out[k]
        plans.append((names[row], [p for j, p in enumerate(victims_by_node[row]) if mask[j]], False))
    return plans


def preempt(
    pod: Pod,
    snapshot: Snapshot,
    pdbs: Sequence[PodDisruptionBudget] = (),
    nominated_fn: Optional[NominatedFn] = None,
    can_disrupt: Optional[Callable[[Pod], bool]] = None,
    enabled: Optional[frozenset] = None,
) -> Tuple[Optional[str], List[Pod], List[str]]:
    """Preempt (:313): (node, victims, nominated pod keys to clear). The
    third element lists the LOWER-priority pods nominated to the chosen
    node (the scheduling queue's nominated index, :346-360), whose
    nomination the caller clears: their node is about to be taken."""
    if not pod_eligible_to_preempt_others(pod, snapshot):
        return None, [], []
    potential = nodes_where_preemption_might_help(pod, snapshot)
    if not potential:
        return None, [], []
    # with no terms on the preemptor and no required anti-affinity on an
    # existing pod (the only existing-pod terms the metadata reads), the
    # predicate metadata is the same for every candidate shadow: computed
    # once; with the default predicate set too, the victim search is exact
    # arithmetic (_select_victims_fast)
    static_meta = None
    if not _has_terms(pod) and not _existing_anti_affinity(snapshot):
        static_meta = compute_predicate_metadata(pod, snapshot, enabled=enabled)
    fast = static_meta is not None and enabled is None
    candidates: Dict[str, Victims] = {}
    for name in potential:
        if fast:
            v = _select_victims_fast(pod, snapshot.get(name), pdbs, can_disrupt)
        else:
            v = select_victims_on_node(pod, name, snapshot, pdbs=pdbs, can_disrupt=can_disrupt, enabled=enabled,
                                       static_meta=static_meta)
        if v is not None:
            candidates[name] = v
    chosen = pick_one_node_for_preemption(candidates)
    if chosen is None:
        return None, [], []
    # lower-priority pending pods nominated to the chosen node lose their
    # nomination (getLowerPriorityNominatedPods :1240)
    clear: List[str] = []
    prio = pod.get_priority()
    if nominated_fn is not None:
        for p in nominated_fn(chosen):
            if p.get_priority() < prio:
                clear.append(p.key())
    return chosen, candidates[chosen].pods, clear
