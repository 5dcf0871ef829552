"""The host oracle's predicates: the port's own copy of
`kubernetes_tpu.oracle.predicates`.

The scalar feasibility semantics of
pkg/scheduler/algorithm/predicates/predicates.go over the typed API
objects, on the precomputed-metadata path that the default algorithm
provider installs (GetPredicateMetadata): the per-node predicates, the
DoNotSchedule spread metadata and predicate, the inter-pod affinity
metadata (with the per-snapshot `SnapshotAffinityIndex`) and predicate, and
the chain that runs them in predicates.Ordering() (`pod_fits_on_node`).
The driver's host oracle (scheduler/driver._oracle_place and the per-pod
re-checks), the slow-path victim search (scheduler/preemption) and the
arbiter's executable spec (commit/arbiter.host_arbitrate) read it; the
term compiler (state/terms.py) reads its term helpers.

The Policy config's custom-argument predicates (CheckNodeLabelPresence,
ServiceAffinity) sit at the end: the config factory registers them as
framework Filter plugins, so the chain itself never names them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..api.selectors import match_label_selector, node_matches_node_selector
from ..api.types import (
    DO_NOT_SCHEDULE,
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_NODE_UNSCHEDULABLE,
    Affinity,
    Pod,
    PodAffinityTerm,
    Taint,
    TopologySpreadConstraint,
    tolerations_tolerate_taint,
)
from .nodeinfo import NodeInfo, Snapshot

# Failure reason strings (mirror predicates.Err* for debuggability).
ERR_NODE_UNSCHEDULABLE = "NodeUnschedulable"
ERR_POD_NOT_FIT_HOST = "PodFitsHost"
ERR_POD_NOT_FIT_PORTS = "PodFitsHostPorts"
ERR_NODE_SELECTOR_NOT_MATCH = "MatchNodeSelector"
ERR_INSUFFICIENT = "Insufficient {}"
ERR_TAINTS = "PodToleratesNodeTaints"
ERR_TOPOLOGY_SPREAD = "EvenPodsSpreadNotMatch"
ERR_POD_AFFINITY = "MatchInterPodAffinity"


# ---------------------------------------------------------------------------
# Simple per-node predicates
# ---------------------------------------------------------------------------

def check_node_unschedulable(pod: Pod, node_info: NodeInfo) -> bool:
    """CheckNodeUnschedulablePredicate (predicates.go:1584): unschedulable
    nodes pass only if the pod tolerates the unschedulable taint."""
    if not node_info.node.unschedulable:
        return True
    return tolerations_tolerate_taint(
        pod.tolerations,
        Taint(key=TAINT_NODE_UNSCHEDULABLE, effect=TAINT_NO_SCHEDULE),
    )


def pod_fits_host(pod: Pod, node_info: NodeInfo) -> bool:
    """PodFitsHost (predicates.go:991): spec.nodeName pinning."""
    if not pod.node_name:
        return True
    return pod.node_name == node_info.node.name


def pod_fits_host_ports(pod: Pod, node_info: NodeInfo) -> bool:
    """PodFitsHostPorts (predicates.go:1161) via HostPortInfo conflicts."""
    if not pod.host_ports():
        return True
    return not node_info.host_port_conflict(pod)


def pod_match_node_selector(pod: Pod, node_info: NodeInfo) -> bool:
    """PodMatchNodeSelector (predicates.go:979) =
    PodMatchesNodeSelectorAndAffinityTerms: spec.nodeSelector (all labels
    must match) AND nodeAffinity.required terms (ORed)."""
    node = node_info.node
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    aff = pod.affinity
    if aff is not None and aff.node_affinity is not None and aff.node_affinity.required is not None:
        return node_matches_node_selector(aff.node_affinity.required, node.labels, node.name)
    return True


def pod_fits_resources(pod: Pod, node_info: NodeInfo) -> bool:
    """PodFitsResources (predicates.go:854): pod count always checked. When
    the pod requests anything at all, cpu/memory/ephemeral-storage are ALWAYS
    checked (so a zero-cpu pod still fails on a cpu-overcommitted node, per
    the reference's unconditional compares at predicates.go:886-895) while
    scalar resources are checked only when requested non-zero (explicit-zero
    scalar requests are treated as unset — indistinguishable in the tensor
    encoding; deviation only matters on overcommitted nodes)."""
    if len(node_info.pods) + 1 > node_info.allowed_pod_number():
        return False
    req = pod.resource_request()
    if all(v == 0 for k, v in req.items() if k != "pods"):
        return True
    alloc = node_info.node.allocatable_int()
    used = node_info.requested()
    for name in (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE):
        if alloc.get(name, 0) < req.get(name, 0) + used.get(name, 0):
            return False
    for name, r in req.items():
        if name in (RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE, "pods"):
            continue
        if r != 0 and alloc.get(name, 0) < r + used.get(name, 0):
            return False
    return True


def pod_tolerates_node_taints(pod: Pod, node_info: NodeInfo) -> bool:
    """PodToleratesNodeTaints (predicates.go:1604): only NoSchedule/NoExecute
    taints matter; every such taint must be tolerated."""
    for taint in node_info.node.taints:
        if taint.effect not in (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE):
            continue
        if not tolerations_tolerate_taint(pod.tolerations, taint):
            return False
    return True


# ---------------------------------------------------------------------------
# EvenPodsSpread (hard topology spread constraints)
# ---------------------------------------------------------------------------

def get_hard_spread_constraints(pod: Pod) -> List[TopologySpreadConstraint]:
    return [c for c in pod.topology_spread_constraints if c.when_unsatisfiable == DO_NOT_SCHEDULE]


def get_soft_spread_constraints(pod: Pod) -> List[TopologySpreadConstraint]:
    return [c for c in pod.topology_spread_constraints if c.when_unsatisfiable != DO_NOT_SCHEDULE]


def pod_matches_spread_constraint(pod_labels: Dict[str, str], c: TopologySpreadConstraint) -> bool:
    """PodMatchesSpreadConstraint (metadata.go:499): nil selector matches
    nothing (LabelSelectorAsSelector of nil -> Nothing)."""
    return match_label_selector(c.label_selector, pod_labels)


def node_labels_match_spread_constraints(
    node_labels: Dict[str, str], constraints: List[TopologySpreadConstraint]
) -> bool:
    """metadata.go:511: node must carry ALL topology keys."""
    return all(c.topology_key in node_labels for c in constraints)


@dataclass
class EvenPodsSpreadMetadata:
    """getEvenPodsSpreadMetadata (metadata.go:399): per-(key,value) counts of
    same-namespace pods matching each constraint's selector, over candidate
    nodes (nodes passing the incoming pod's node selector/affinity and
    carrying all topology keys), plus the per-key global minimum."""

    tp_pair_to_match_num: Dict[Tuple[str, str], int] = field(default_factory=dict)
    tp_key_min_match: Dict[str, int] = field(default_factory=dict)


def compute_even_pods_spread_metadata(pod: Pod, snapshot: Snapshot) -> Optional[EvenPodsSpreadMetadata]:
    """The reference's walk over every candidate node's pods, counting
    each (namespace, labels) group of a node with one selector match
    (NodeInfo.pod_signatures; a match memoized per constraint and label
    set): the same counts."""
    constraints = get_hard_spread_constraints(pod)
    if not constraints:
        return None
    m = EvenPodsSpreadMetadata()
    pair_num = m.tp_pair_to_match_num
    ns = pod.namespace
    aff = pod.affinity
    check_selector = bool(pod.node_selector) or (
        aff is not None and aff.node_affinity is not None and aff.node_affinity.required is not None)
    keys = [c.topology_key for c in constraints]
    memo: Dict[Tuple[int, frozenset], bool] = {}
    for ni in snapshot.node_infos.values():
        labels = ni.node.labels
        if check_selector and not pod_match_node_selector(pod, ni):
            continue
        if not all(k in labels for k in keys):
            continue
        sigs = ni.pod_signatures()
        for ci, c in enumerate(constraints):
            total = 0
            for (pns, lk), (cnt, plabels) in sigs.items():
                if pns != ns:
                    continue
                hit = memo.get((ci, lk))
                if hit is None:
                    hit = memo[(ci, lk)] = pod_matches_spread_constraint(plabels, c)
                if hit:
                    total += cnt
            pair = (c.topology_key, labels[c.topology_key])
            pair_num[pair] = pair_num.get(pair, 0) + total
    for (key, _), num in pair_num.items():
        cur = m.tp_key_min_match.get(key)
        if cur is None or num < cur:
            m.tp_key_min_match[key] = num
    return m


def even_pods_spread_predicate(
    pod: Pod, node_info: NodeInfo, meta: Optional[EvenPodsSpreadMetadata]
) -> bool:
    """EvenPodsSpreadPredicate (predicates.go:1778): per hard constraint,
    matchNum(node's pair) + selfMatch - minMatchNum(key) <= maxSkew; node must
    carry the topology key."""
    constraints = get_hard_spread_constraints(pod)
    if not constraints:
        return True
    if meta is None or not meta.tp_pair_to_match_num:
        return True
    node = node_info.node
    for c in constraints:
        tp_val = node.labels.get(c.topology_key)
        if tp_val is None:
            return False
        self_match = 1 if pod_matches_spread_constraint(pod.labels, c) else 0
        if c.topology_key not in meta.tp_key_min_match:
            continue  # "error which should not happen" branch: skip constraint
        min_match = meta.tp_key_min_match[c.topology_key]
        match_num = meta.tp_pair_to_match_num.get((c.topology_key, tp_val), 0)
        if match_num + self_match - min_match > c.max_skew:
            return False
    return True


# ---------------------------------------------------------------------------
# InterPodAffinity
# ---------------------------------------------------------------------------

def get_pod_affinity_terms(affinity: Optional[Affinity]) -> List[PodAffinityTerm]:
    """GetPodAffinityTerms: required terms only."""
    if affinity is None or affinity.pod_affinity is None:
        return []
    return list(affinity.pod_affinity.required)


def get_pod_anti_affinity_terms(affinity: Optional[Affinity]) -> List[PodAffinityTerm]:
    if affinity is None or affinity.pod_anti_affinity is None:
        return []
    return list(affinity.pod_anti_affinity.required)


def term_namespaces(owner: Pod, term: PodAffinityTerm) -> Set[str]:
    """priorityutil.GetNamespacesFromPodAffinityTerm: empty -> owner's ns."""
    return set(term.namespaces) if term.namespaces else {owner.namespace}


def pod_matches_term(target: Pod, owner: Pod, term: PodAffinityTerm) -> bool:
    """PodMatchesTermsNamespaceAndSelector for one term."""
    if target.namespace not in term_namespaces(owner, term):
        return False
    return match_label_selector(term.label_selector, target.labels)


def pod_matches_all_term_properties(target: Pod, owner: Pod, terms: List[PodAffinityTerm]) -> bool:
    """podMatchesAllAffinityTermProperties: target must match (ns, selector)
    of every term. Empty terms -> False (getAffinityTermProperties of [])."""
    if not terms:
        return False
    return all(pod_matches_term(target, owner, t) for t in terms)


@dataclass
class PodAffinityMetadata:
    """podAffinityMetadata (metadata.go:~360): three topology-pair sets."""

    # (key, value) pairs where scheduling the incoming pod violates an
    # EXISTING pod's required anti-affinity. Node fails if any of its own
    # labels is in this set.
    existing_anti_pairs: Set[Tuple[str, str]] = field(default_factory=set)
    # (key, value) pairs from existing pods matching ALL of the incoming
    # pod's required affinity terms' properties.
    incoming_affinity_pairs: Set[Tuple[str, str]] = field(default_factory=set)
    # (key, value) pairs from existing pods matching each of the incoming
    # pod's required anti-affinity terms.
    incoming_anti_pairs: Set[Tuple[str, str]] = field(default_factory=set)


class SnapshotAffinityIndex:
    """The pod-independent structure of the affinity metadata, built ONCE
    per snapshot epoch instead of re-walking the cluster for every pod:

    * existing pods' required anti-affinity terms grouped by CONTENT
      (namespace set, selector, topology key) with the set of topology
      values their hosting nodes carry — one selector match per distinct
      term content instead of one per (pod, term) instance;
    * existing pods grouped by (namespace, labels) signature with their
      hosting nodes' label dicts — the incoming pod's own terms match one
      group representative instead of every pod.

    Exactness: both halves of compute_pod_affinity_metadata depend on an
    existing pod only through its namespace + labels (and its node's
    labels), so grouping by those is a pure dedup. Callers that mutate the
    snapshot after building (the driver's in-batch commits) pass the new
    pods through `extra`, which replays the original per-pod logic."""

    def __init__(self, snapshot: Snapshot):
        self.anti_groups: Dict[tuple, dict] = {}
        self.pod_groups: Dict[tuple, dict] = {}
        for ni in snapshot.node_infos.values():
            labels = ni.node.labels
            for ep in ni.pods_with_affinity():
                for term in get_pod_anti_affinity_terms(ep.affinity):
                    v = labels.get(term.topology_key)
                    if v is None:
                        continue
                    nss = (
                        tuple(sorted(term.namespaces))
                        if term.namespaces
                        else ep.namespace
                    )
                    key = (nss, repr(term.label_selector), term.topology_key)
                    g = self.anti_groups.get(key)
                    if g is None:
                        self.anti_groups[key] = g = {
                            "term": term,
                            "ep": ep,
                            "values": set(),
                        }
                    g["values"].add(v)
            for ep in ni.pods:
                key = (ep.namespace, tuple(sorted(ep.labels.items())))
                g = self.pod_groups.get(key)
                if g is None:
                    self.pod_groups[key] = g = {"ep": ep, "nodes": []}
                g["nodes"].append(labels)


def _affinity_pairs_for_pod(
    m: PodAffinityMetadata,
    pod: Pod,
    ep: Pod,
    node_labels: Dict[str, str],
    affinity_terms,
    anti_terms,
) -> None:
    """The original per-(existing pod, node) metadata contribution — used
    for index `extra` entries (in-batch commits)."""
    for term in get_pod_anti_affinity_terms(ep.affinity):
        if pod_matches_term(pod, ep, term) and term.topology_key in node_labels:
            m.existing_anti_pairs.add((term.topology_key, node_labels[term.topology_key]))
    if affinity_terms and pod_matches_all_term_properties(ep, pod, affinity_terms):
        for term in affinity_terms:
            if term.topology_key in node_labels:
                m.incoming_affinity_pairs.add(
                    (term.topology_key, node_labels[term.topology_key])
                )
    for term in anti_terms:
        if pod_matches_term(ep, pod, term) and term.topology_key in node_labels:
            m.incoming_anti_pairs.add((term.topology_key, node_labels[term.topology_key]))


def compute_pod_affinity_metadata(
    pod: Pod,
    snapshot: Snapshot,
    index: Optional[SnapshotAffinityIndex] = None,
    extra=(),
) -> PodAffinityMetadata:
    m = PodAffinityMetadata()
    affinity_terms = get_pod_affinity_terms(pod.affinity)
    anti_terms = get_pod_anti_affinity_terms(pod.affinity)

    if index is not None:
        # grouped fast path: one match per distinct term content / pod
        # signature (see SnapshotAffinityIndex)
        for g in index.anti_groups.values():
            if pod_matches_term(pod, g["ep"], g["term"]):
                tk = g["term"].topology_key
                for v in g["values"]:
                    m.existing_anti_pairs.add((tk, v))
        if affinity_terms or anti_terms:
            for g in index.pod_groups.values():
                rep = g["ep"]
                if affinity_terms and pod_matches_all_term_properties(rep, pod, affinity_terms):
                    for term in affinity_terms:
                        for labels in g["nodes"]:
                            v = labels.get(term.topology_key)
                            if v is not None:
                                m.incoming_affinity_pairs.add((term.topology_key, v))
                for term in anti_terms:
                    if pod_matches_term(rep, pod, term):
                        for labels in g["nodes"]:
                            v = labels.get(term.topology_key)
                            if v is not None:
                                m.incoming_anti_pairs.add((term.topology_key, v))
        for ep, node_labels in extra:
            _affinity_pairs_for_pod(m, pod, ep, node_labels, affinity_terms, anti_terms)
        return m

    for ni in snapshot.node_infos.values():
        node = ni.node
        # Existing pods' required anti-affinity vs the incoming pod
        # (getTPMapMatchingExistingAntiAffinity).
        for ep in ni.pods_with_affinity():
            for term in get_pod_anti_affinity_terms(ep.affinity):
                if pod_matches_term(pod, ep, term):
                    if term.topology_key in node.labels:
                        m.existing_anti_pairs.add((term.topology_key, node.labels[term.topology_key]))
        # Incoming pod's terms vs existing pods
        # (getTPMapMatchingIncomingAffinityAntiAffinity).
        if affinity_terms or anti_terms:
            for ep in ni.pods:
                if affinity_terms and pod_matches_all_term_properties(ep, pod, affinity_terms):
                    for term in affinity_terms:
                        if term.topology_key in node.labels:
                            m.incoming_affinity_pairs.add(
                                (term.topology_key, node.labels[term.topology_key])
                            )
                for term in anti_terms:
                    if pod_matches_term(ep, pod, term):
                        if term.topology_key in node.labels:
                            m.incoming_anti_pairs.add(
                                (term.topology_key, node.labels[term.topology_key])
                            )
    return m


def inter_pod_affinity_matches(
    pod: Pod, node_info: NodeInfo, meta: PodAffinityMetadata
) -> bool:
    """InterPodAffinityMatches (predicates.go:1269), metadata path."""
    node = node_info.node
    # 1. satisfiesExistingPodsAntiAffinity: any of the node's own label pairs
    # present in the existing-anti set -> fail.
    for k, v in node.labels.items():
        if (k, v) in meta.existing_anti_pairs:
            return False

    affinity = pod.affinity
    if affinity is None or (affinity.pod_affinity is None and affinity.pod_anti_affinity is None):
        return True

    # 2. Pod's own required affinity: node must match topology of ALL terms.
    affinity_terms = get_pod_affinity_terms(affinity)
    if affinity_terms:
        match_exists = all(
            term.topology_key in node.labels
            and (term.topology_key, node.labels[term.topology_key]) in meta.incoming_affinity_pairs
            for term in affinity_terms
        )
        if not match_exists:
            # First-pod-in-series escape (generic_scheduler commentary at
            # satisfiesPodsAffinityAntiAffinity): allowed only when no pod in
            # the cluster matches and the pod matches its own terms.
            if not (
                not meta.incoming_affinity_pairs
                and pod_matches_all_term_properties(pod, pod, affinity_terms)
            ):
                return False

    # 3. Pod's own required anti-affinity: node matching ANY term -> fail.
    for term in get_pod_anti_affinity_terms(affinity):
        if (
            term.topology_key in node.labels
            and (term.topology_key, node.labels[term.topology_key]) in meta.incoming_anti_pairs
        ):
            return False
    return True


# ---------------------------------------------------------------------------
# Combined runner (findNodesThatFit semantics for one pod)
# ---------------------------------------------------------------------------

# Registration names (predicates.go:56-110) — what Policy files and the
# algorithm provider registry refer to.
CHECK_NODE_UNSCHEDULABLE_PRED = "CheckNodeUnschedulable"
GENERAL_PRED = "GeneralPredicates"
HOST_NAME_PRED = "HostName"
POD_FITS_HOST_PORTS_PRED = "PodFitsHostPorts"
MATCH_NODE_SELECTOR_PRED = "MatchNodeSelector"
POD_FITS_RESOURCES_PRED = "PodFitsResources"
POD_TOLERATES_NODE_TAINTS_PRED = "PodToleratesNodeTaints"
EVEN_PODS_SPREAD_PRED = "EvenPodsSpread"
MATCH_INTER_POD_AFFINITY_PRED = "MatchInterPodAffinity"

# GeneralPredicates expands to these (predicates.go:1204 noncriticalPredicates
# + EssentialPredicates). The one definition: the device mask
# (ops/filters.py) imports it.
GENERAL_PREDICATES_EXPANSION = frozenset(
    {HOST_NAME_PRED, POD_FITS_HOST_PORTS_PRED, MATCH_NODE_SELECTOR_PRED, POD_FITS_RESOURCES_PRED}
)

def predicate_enabled(name: str, enabled) -> bool:
    """Is `name` on, given an enabled-set from Policy/provider config?
    None = default provider (everything the oracle implements)."""
    if enabled is None:
        return True
    if name in enabled:
        return True
    return name in GENERAL_PREDICATES_EXPANSION and GENERAL_PRED in enabled


@dataclass
class PredicateMetadata:
    """GetPredicateMetadata (metadata.go:333) equivalent: the per-cycle
    precomputation for one incoming pod against a snapshot. Carries the
    config's enabled-predicate set so every consumer (driver, preemption,
    nominated-pods two-pass) applies the same policy."""

    even_pods_spread: Optional[EvenPodsSpreadMetadata]
    pod_affinity: Optional[PodAffinityMetadata]
    enabled: Optional[frozenset] = None


def compute_predicate_metadata(
    pod: Pod,
    snapshot: Snapshot,
    enabled: Optional[frozenset] = None,
    affinity_index: Optional["SnapshotAffinityIndex"] = None,
    affinity_extra=(),
) -> PredicateMetadata:
    return PredicateMetadata(
        even_pods_spread=(
            compute_even_pods_spread_metadata(pod, snapshot)
            if predicate_enabled(EVEN_PODS_SPREAD_PRED, enabled)
            else None
        ),
        pod_affinity=(
            compute_pod_affinity_metadata(
                pod, snapshot, index=affinity_index, extra=affinity_extra
            )
            if predicate_enabled(MATCH_INTER_POD_AFFINITY_PRED, enabled)
            else None
        ),
        enabled=enabled,
    )


def pod_fits_on_node(
    pod: Pod,
    node_info: NodeInfo,
    meta: Optional[PredicateMetadata] = None,
    snapshot: Optional[Snapshot] = None,
) -> Tuple[bool, List[str]]:
    """All default-provider predicates in predicates.Ordering()
    (predicates.go:147-153), short-circuiting like podFitsOnNode
    (core/generic_scheduler.go:612 with alwaysCheckAllPredicates=false),
    honoring meta.enabled (Policy/provider predicate selection). The
    volume predicates are not ported (ROADMAP.md queue 1 item 7, volumes)."""
    if meta is None:
        if snapshot is None:
            raise ValueError("pod_fits_on_node needs `meta` or a `snapshot` to compute it from")
        meta = compute_predicate_metadata(pod, snapshot)
    enabled = meta.enabled
    checks = [
        (
            CHECK_NODE_UNSCHEDULABLE_PRED,
            ERR_NODE_UNSCHEDULABLE,
            lambda: check_node_unschedulable(pod, node_info),
        ),
        (HOST_NAME_PRED, ERR_POD_NOT_FIT_HOST, lambda: pod_fits_host(pod, node_info)),
        (
            POD_FITS_HOST_PORTS_PRED,
            ERR_POD_NOT_FIT_PORTS,
            lambda: pod_fits_host_ports(pod, node_info),
        ),
        (
            MATCH_NODE_SELECTOR_PRED,
            ERR_NODE_SELECTOR_NOT_MATCH,
            lambda: pod_match_node_selector(pod, node_info),
        ),
        (
            POD_FITS_RESOURCES_PRED,
            ERR_INSUFFICIENT.format("resources"),
            lambda: pod_fits_resources(pod, node_info),
        ),
        (
            POD_TOLERATES_NODE_TAINTS_PRED,
            ERR_TAINTS,
            lambda: pod_tolerates_node_taints(pod, node_info),
        ),
        (
            EVEN_PODS_SPREAD_PRED,
            ERR_TOPOLOGY_SPREAD,
            lambda: even_pods_spread_predicate(pod, node_info, meta.even_pods_spread),
        ),
        (
            MATCH_INTER_POD_AFFINITY_PRED,
            ERR_POD_AFFINITY,
            lambda: inter_pod_affinity_matches(pod, node_info, meta.pod_affinity),
        ),
    ]
    for name, reason, fn in checks:
        if not predicate_enabled(name, enabled):
            continue
        if not fn():
            return False, [reason]
    return True, []


def find_nodes_that_fit(pod: Pod, snapshot: Snapshot) -> List[str]:
    """findNodesThatFit (core/generic_scheduler.go:457) without adaptive
    sampling: full feasibility set, deterministic node order."""
    meta = compute_predicate_metadata(pod, snapshot)
    return [
        name
        for name, ni in snapshot.node_infos.items()
        if pod_fits_on_node(pod, ni, meta=meta)[0]
    ]


# ---------------------------------------------------------------------------
# Policy custom-argument predicates (api/types.go:83-121): labelsPresence →
# CheckNodeLabelPresence (predicates.go:1033), serviceAffinity →
# checkServiceAffinity (predicates.go:1123). Registered as framework Filter
# plugins by the factory — they gate the host commit path, not the device
# mask (arbitrary user-named predicates have no device encoding).
# ---------------------------------------------------------------------------

def check_node_label_presence(pod, node_info, labels, presence: bool) -> bool:
    """CheckNodeLabelPresence (predicates.go:1033-1048): every listed label
    key must be present (presence=True) or absent (presence=False) on the
    node, values ignored."""
    node_labels = node_info.node.labels
    for label in labels:
        exists = label in node_labels
        if (exists and not presence) or (not exists and presence):
            return False
    return True


def get_pod_services(pod, services):
    """GetPodServices (client-go listers/core/v1/service_expansion.go):
    same-namespace services with a NON-EMPTY selector matching the pod's
    labels."""
    out = []
    for svc in services or []:
        if svc.namespace != pod.namespace or not svc.selector:
            continue
        if all(pod.labels.get(k) == v for k, v in svc.selector.items()):
            out.append(svc)
    return out


def service_affinity_precompute(pod, snapshot, labels, services):
    """The once-per-pod half of checkServiceAffinity
    (serviceAffinityMetadataProducer, predicates.go:1060-1082):
    (base_labels, anchor_candidates) where base_labels come from the pod's
    own nodeSelector and anchor_candidates is the ordered list of
    already-placed same-namespace pods with labels matching OURS —
    non-empty only when the pod belongs to some service. The per-node half
    (service_affinity_fits) applies the FilterOutPods exclusion against
    this list, so Filter stays O(1) amortized per node instead of
    O(cluster pods)."""
    base_labels = {k: pod.node_selector[k] for k in labels if k in pod.node_selector}
    candidates = []
    if len(labels) > len(base_labels) and get_pod_services(pod, services):
        for other in snapshot.all_pods():
            if other.namespace != pod.namespace or not other.node_name:
                continue
            if all(other.labels.get(k) == v for k, v in pod.labels.items()):
                candidates.append(other)
    return base_labels, candidates


def service_affinity_fits(pod, node_info, snapshot, labels, base_labels, candidates) -> bool:
    """Per-node half of checkServiceAffinity (predicates.go:1123-1160):
    backfill missing constraint keys from the FIRST anchor candidate not on
    the node under evaluation (FilterOutPods), then require the node to
    carry every constrained label with the constrained value."""
    affinity_labels = dict(base_labels)
    if len(labels) > len(affinity_labels):
        for other in candidates:
            if other.node_name == node_info.node.name:
                continue
            anchor_ni = snapshot.get(other.node_name)
            if anchor_ni is None:
                continue
            for k in labels:
                if k not in affinity_labels and k in anchor_ni.node.labels:
                    affinity_labels[k] = anchor_ni.node.labels[k]
            break
    node_labels = node_info.node.labels
    return all(node_labels.get(k) == v for k, v in affinity_labels.items())


def check_service_affinity(pod, node_info, snapshot, labels, services) -> bool:
    """checkServiceAffinity (predicates.go:1123-1160): force the listed
    node-label keys to stay homogeneous across a service's pods. One-shot
    convenience wrapper; the framework plugin path precomputes per pod."""
    base, cands = service_affinity_precompute(pod, snapshot, labels, services)
    return service_affinity_fits(pod, node_info, snapshot, labels, base, cands)
