"""Term helpers of the host predicates: the port's trimmed copy of
`kubernetes_tpu.oracle.predicates`.

Only what the term compiler (state/terms.py) reads: the split of a pod's
topology spread constraints into hard (DoNotSchedule) and soft ones, the
required pod (anti-)affinity terms, and the property match of a pod
against all of a term list (predicates.go podMatchesAllAffinityTermProperties).
The host oracle predicates themselves are not ported (ROADMAP.md queue 1,
oracle fallback).
"""

from __future__ import annotations

from typing import List, Optional, Set

from ..api.selectors import match_label_selector
from ..api.types import (
    DO_NOT_SCHEDULE,
    Affinity,
    Pod,
    PodAffinityTerm,
    TopologySpreadConstraint,
)


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
