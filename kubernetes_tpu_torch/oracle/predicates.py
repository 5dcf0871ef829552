"""Term helpers of the host predicates: the port's trimmed copy of
`kubernetes_tpu.oracle.predicates`.

What the term compiler (state/terms.py) reads: the split of a pod's
topology spread constraints into hard (DoNotSchedule) and soft ones, the
required pod (anti-)affinity terms, and the property match of a pod
against all of a term list (predicates.go podMatchesAllAffinityTermProperties).
And the four per-node predicates that evicting pods cannot resolve, which
preemption's candidate pruning reads (nodesWherePreemptionMightHelp,
generic_scheduler.go:1218). The rest of the host oracle chain is not
ported (ROADMAP.md queue 1, oracle fallback).
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..api.selectors import match_label_selector, node_matches_node_selector
from ..api.types import (
    DO_NOT_SCHEDULE,
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
from .nodeinfo import NodeInfo


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


def pod_tolerates_node_taints(pod: Pod, node_info: NodeInfo) -> bool:
    """PodToleratesNodeTaints (predicates.go:1604): only NoSchedule/NoExecute
    taints matter; every such taint must be tolerated."""
    for taint in node_info.node.taints:
        if taint.effect not in (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE):
            continue
        if not tolerations_tolerate_taint(pod.tolerations, taint):
            return False
    return True


def get_hard_spread_constraints(pod: Pod) -> List[TopologySpreadConstraint]:
    return [c for c in pod.topology_spread_constraints if c.when_unsatisfiable == DO_NOT_SCHEDULE]


def get_soft_spread_constraints(pod: Pod) -> List[TopologySpreadConstraint]:
    return [c for c in pod.topology_spread_constraints if c.when_unsatisfiable != DO_NOT_SCHEDULE]


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
