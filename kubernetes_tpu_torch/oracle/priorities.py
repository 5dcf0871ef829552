"""The host priority set: the port's own copy of
`kubernetes_tpu.oracle.priorities`.

pkg/scheduler/algorithm/priorities/ (map/reduce model, MaxNodeScore=10 in
this version — framework/v1alpha1/interface.go:77) as plain Python over the
typed API objects. The extender server's /prioritize, the Policy's
custom-argument Score plugins and the tensor encoding's request helpers
read it; ops/scores.py is its device counterpart.

The default provider registers (algorithmprovider/defaults/defaults.go:128):
SelectorSpreadPriority(1), InterPodAffinityPriority(1),
LeastRequestedPriority(1), BalancedResourceAllocation(1),
NodePreferAvoidPodsPriority(10000), NodeAffinityPriority(1),
TaintTolerationPriority(1), ImageLocalityPriority(1); EvenPodsSpreadPriority
(1, feature-gated).
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

from ..api.selectors import match_label_selector, match_node_selector_requirement
from ..api.types import (
    LabelSelector,
    Pod,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    TAINT_PREFER_NO_SCHEDULE,
)
from .nodeinfo import (
    NodeInfo,
    Snapshot,
    get_zone_key,
    normalized_image_name,
)
from .predicates import (
    get_soft_spread_constraints,
    node_labels_match_spread_constraints,
    pod_match_node_selector,
    pod_matches_spread_constraint,
    pod_matches_term,
)

MAX_NODE_SCORE = 10  # framework.MaxNodeScore in v1alpha1 (interface.go:77)

# image_locality.go:36-40
_MB = 1024 * 1024
IMAGE_MIN_THRESHOLD = 23 * _MB
IMAGE_MAX_THRESHOLD = 1000 * _MB

PREFER_AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"

# Scores is node name -> int64 score.
Scores = Dict[str, int]


def _score_list(snapshot: Snapshot, fn: Callable[[NodeInfo], int]) -> Scores:
    return {name: fn(ni) for name, ni in snapshot.node_infos.items()}


def normalize_reduce(scores: Scores, max_priority: int = MAX_NODE_SCORE, reverse: bool = False) -> Scores:
    """priorities/reduce.go NormalizeReduce: scale to [0, max], optionally
    invert; all-zero input stays zero (or all-max when reversed)."""
    max_count = max(scores.values(), default=0)
    if max_count == 0:
        if reverse:
            return {k: max_priority for k in scores}
        return dict(scores)
    out = {}
    for k, v in scores.items():
        s = max_priority * v // max_count
        if reverse:
            s = max_priority - s
        out[k] = s
    return out


# ---------------------------------------------------------------------------
# Resource-based priorities (resource_allocation.go)
# ---------------------------------------------------------------------------

def _pod_scoring_request(pod: Pod) -> Tuple[int, int]:
    """calculatePodResourceRequest (resource_allocation.go:138): per-container
    non-zero-defaulted requests; overhead added via Quantity.Value() — whole
    cores for CPU, a reference quirk preserved deliberately (the node-side
    accumulation in calculateResource uses MilliValue instead)."""
    cpu = 0
    mem = 0
    for c in pod.containers:
        q = c.requests.get(RESOURCE_CPU)
        cpu += q.milli_value() if q is not None else 100
        q = c.requests.get(RESOURCE_MEMORY)
        mem += q.value() if q is not None else 200 * 1024 * 1024
    q = pod.overhead.get(RESOURCE_CPU)
    if q is not None:
        cpu += q.value()
    q = pod.overhead.get(RESOURCE_MEMORY)
    if q is not None:
        mem += q.value()
    return cpu, mem


def _allocatable_and_requested(pod: Pod, ni: NodeInfo) -> Tuple[int, int, int, int]:
    """calculateResourceAllocatableRequest for cpu and memory: requested uses
    the node's accumulated NON-ZERO requests plus the incoming pod's
    defaulted (non-zero) scoring request."""
    alloc = ni.node.allocatable_int()
    node_cpu, node_mem = ni.non_zero_requested()
    pod_cpu, pod_mem = _pod_scoring_request(pod)
    return (
        alloc.get(RESOURCE_CPU, 0),
        node_cpu + pod_cpu,
        alloc.get(RESOURCE_MEMORY, 0),
        node_mem + pod_mem,
    )


def _least_requested_score(requested: int, capacity: int) -> int:
    if capacity == 0 or requested > capacity:
        return 0
    return (capacity - requested) * MAX_NODE_SCORE // capacity


def _most_requested_score(requested: int, capacity: int) -> int:
    if capacity == 0 or requested > capacity:
        return 0
    return requested * MAX_NODE_SCORE // capacity


def least_requested_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    """LeastRequestedPriority: mean of cpu/mem scores (weights 1,1)."""

    def fn(ni: NodeInfo) -> int:
        ac, rc, am, rm = _allocatable_and_requested(pod, ni)
        return (_least_requested_score(rc, ac) + _least_requested_score(rm, am)) // 2

    return _score_list(snapshot, fn)


def most_requested_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    def fn(ni: NodeInfo) -> int:
        ac, rc, am, rm = _allocatable_and_requested(pod, ni)
        return (_most_requested_score(rc, ac) + _most_requested_score(rm, am)) // 2

    return _score_list(snapshot, fn)


def balanced_resource_allocation(pod: Pod, snapshot: Snapshot) -> Scores:
    """BalancedResourceAllocation (balanced_resource_allocation.go): score =
    (1 - |cpuFraction - memFraction|) * 10; 0 if either fraction >= 1."""

    def fn(ni: NodeInfo) -> int:
        ac, rc, am, rm = _allocatable_and_requested(pod, ni)
        cpu_frac = rc / ac if ac else 1.0
        mem_frac = rm / am if am else 1.0
        if cpu_frac >= 1 or mem_frac >= 1:
            return 0
        return int((1 - abs(cpu_frac - mem_frac)) * MAX_NODE_SCORE)

    return _score_list(snapshot, fn)


# ---------------------------------------------------------------------------
# RequestedToCapacityRatio (requested_to_capacity_ratio.go) + ResourceLimits
# (resource_limits.go) — Policy-configurable / feature-gated resource scores
# ---------------------------------------------------------------------------

# default shape prefers least-utilized nodes: f(0%)=10, f(100%)=0
# (requested_to_capacity_ratio.go:40)
DEFAULT_RTCR_SHAPE: Tuple[Tuple[int, int], ...] = ((0, 10), (100, 0))
DEFAULT_RTCR_RESOURCES: Tuple[Tuple[str, int], ...] = ((RESOURCE_CPU, 1), (RESOURCE_MEMORY, 1))


def _go_div(a: int, b: int) -> int:
    """Go integer division truncates toward zero; Python // floors — the
    difference shows on down-sloping shape segments (negative numerators)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def validate_function_shape(shape) -> None:
    """NewFunctionShape preconditions (requested_to_capacity_ratio.go:53-86):
    nonempty, strictly increasing utilization in [0, 100], score in [0, 10]."""
    if not shape:
        raise ValueError("at least one point must be specified")
    for i, (u, s) in enumerate(shape):
        if i and shape[i - 1][0] >= u:
            raise ValueError("utilization values must be sorted")
        if not (0 <= u <= 100):
            raise ValueError("utilization values must be in [0, 100]")
        if not (0 <= s <= MAX_NODE_SCORE):
            raise ValueError("score values must be in [0, 10]")


def _broken_linear(shape: Tuple[Tuple[int, int], ...], p: int) -> int:
    """buildBrokenLinearFunction (requested_to_capacity_ratio.go:144-167):
    piecewise-linear through (utilization, score) points, integer math,
    constant extrapolation outside the shape's utilization range."""
    for i, (u, s) in enumerate(shape):
        if p <= u:
            if i == 0:
                return shape[0][1]
            u0, s0 = shape[i - 1]
            return s0 + _go_div((s - s0) * (p - u0), u - u0)
    return shape[-1][1]


def _rtcr_resource_values(pod: Pod, ni: NodeInfo, resource: str) -> Tuple[int, int]:
    """calculateResourceAllocatableRequest (resource_allocation.go:101-123):
    cpu/memory use the non-zero-defaulted accumulation + the incoming pod's
    scoring request; other resources use the plain requested accumulation.
    Unknown resources score (0, 0)."""
    if resource in (RESOURCE_CPU, RESOURCE_MEMORY):
        ac, rc, am, rm = _allocatable_and_requested(pod, ni)
        return (ac, rc) if resource == RESOURCE_CPU else (am, rm)
    a = ni.node.allocatable_int().get(resource)
    if a is None:
        return 0, 0
    node_req = ni.requested().get(resource, 0)
    pod_req = 0
    for c in pod.containers:
        q = c.requests.get(resource)
        if q is not None:
            pod_req += q.value()
    return a, node_req + pod_req


def requested_to_capacity_ratio_priority(
    pod: Pod,
    snapshot: Snapshot,
    shape: Tuple[Tuple[int, int], ...] = DEFAULT_RTCR_SHAPE,
    resources: Tuple[Tuple[str, int], ...] = DEFAULT_RTCR_RESOURCES,
) -> Scores:
    """RequestedToCapacityRatioResourceAllocationPriority
    (requested_to_capacity_ratio.go:115-142): per resource, utilization% is
    mapped through the broken-linear shape; full/overflowing nodes evaluate
    at 100% utilization. Resources scoring 0 are EXCLUDED from the weighted
    mean (both numerator and denominator — a reference quirk), and the mean
    is rounded half away from zero (math.Round)."""

    def fn(ni: NodeInfo) -> int:
        node_score = 0
        weight_sum = 0
        for resource, weight in resources:
            cap, req = _rtcr_resource_values(pod, ni, resource)
            if cap == 0 or req > cap:
                p = 100
            else:
                p = 100 - (cap - req) * 100 // cap
            s = _broken_linear(shape, p)
            if s > 0:
                node_score += s * weight
                weight_sum += weight
        if weight_sum == 0:
            return 0
        # math.Round for a non-negative ratio == floor(x + 1/2)
        return (2 * node_score + weight_sum) // (2 * weight_sum)

    return _score_list(snapshot, fn)


def _pod_resource_limits(pod: Pod) -> Tuple[int, int]:
    """getResourceLimits (resource_limits.go:92-107): sum of container
    limits, then elementwise max against each init container's limits.
    CPU in millicores, memory in bytes (Resource.Add semantics)."""
    cpu = 0
    mem = 0
    for c in pod.containers:
        q = c.limits.get(RESOURCE_CPU)
        if q is not None:
            cpu += q.milli_value()
        q = c.limits.get(RESOURCE_MEMORY)
        if q is not None:
            mem += q.value()
    for ic in pod.init_containers:
        q = ic.limits.get(RESOURCE_CPU)
        if q is not None:
            cpu = max(cpu, q.milli_value())
        q = ic.limits.get(RESOURCE_MEMORY)
        if q is not None:
            mem = max(mem, q.value())
    return cpu, mem


def resource_limits_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    """ResourceLimitsPriorityMap (resource_limits.go:36-80): score 1 when the
    node can satisfy the pod's cpu OR memory limit (both quantities nonzero),
    else 0 — a deliberate coarse tie-breaker, no normalization (Reduce nil)."""
    limit_cpu, limit_mem = _pod_resource_limits(pod)

    def fn(ni: NodeInfo) -> int:
        alloc = ni.node.allocatable_int()
        ac = alloc.get(RESOURCE_CPU, 0)
        am = alloc.get(RESOURCE_MEMORY, 0)
        cpu_ok = limit_cpu != 0 and ac != 0 and limit_cpu <= ac
        mem_ok = limit_mem != 0 and am != 0 and limit_mem <= am
        return 1 if (cpu_ok or mem_ok) else 0

    return _score_list(snapshot, fn)


# ---------------------------------------------------------------------------
# NodeAffinity / TaintToleration / NodePreferAvoidPods / ImageLocality
# ---------------------------------------------------------------------------

def node_affinity_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    """CalculateNodeAffinityPriorityMap + NormalizeReduce(10, false):
    sum of weights of matching preferred terms."""

    def fn(ni: NodeInfo) -> int:
        count = 0
        aff = pod.affinity
        if aff is not None and aff.node_affinity is not None:
            for pref in aff.node_affinity.preferred:
                if pref.weight == 0:
                    continue
                # Preference uses matchExpressions only, as a plain selector
                # (NodeSelectorRequirementsAsSelector) — an empty preference
                # (no expressions) matches everything, unlike required terms.
                if all(
                    match_node_selector_requirement(r, ni.node.labels)
                    for r in pref.preference.match_expressions
                ):
                    count += pref.weight
        return count

    return normalize_reduce(_score_list(snapshot, fn))


def taint_toleration_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    """ComputeTaintTolerationPriorityMap + NormalizeReduce(10, true): count
    intolerable PreferNoSchedule taints; fewer is better. Only tolerations
    with empty or PreferNoSchedule effect participate
    (getAllTolerationPreferNoSchedule)."""
    tols = [t for t in pod.tolerations if t.effect in ("", TAINT_PREFER_NO_SCHEDULE)]

    def fn(ni: NodeInfo) -> int:
        return sum(
            1
            for taint in ni.node.taints
            if taint.effect == TAINT_PREFER_NO_SCHEDULE
            and not any(t.tolerates(taint) for t in tols)
        )

    return normalize_reduce(_score_list(snapshot, fn), reverse=True)


def node_prefer_avoid_pods_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    """CalculateNodePreferAvoidPodsPriorityMap: 0 when the node's
    preferAvoidPods annotation lists the pod's RC/RS controller, else 10.
    Weight 10000 in the default registry makes this nearly a hard filter."""
    controller = None
    for ref in pod.owner_references:
        if ref.get("controller"):
            controller = ref
            break
    if controller is not None and controller.get("kind") not in ("ReplicationController", "ReplicaSet"):
        controller = None

    def fn(ni: NodeInfo) -> int:
        if controller is None:
            return MAX_NODE_SCORE
        ann = ni.node.annotations.get(PREFER_AVOID_PODS_ANNOTATION, "")
        if not ann:
            return MAX_NODE_SCORE
        try:
            avoids = json.loads(ann)
        except ValueError:
            return MAX_NODE_SCORE
        if not isinstance(avoids, dict):
            return MAX_NODE_SCORE
        entries = avoids.get("preferAvoidPods")
        if not isinstance(entries, list):
            return MAX_NODE_SCORE
        for avoid in entries:
            if not isinstance(avoid, dict):
                continue
            sig = avoid.get("podSignature")
            ref = (sig.get("podController") if isinstance(sig, dict) else None) or {}
            if ref.get("kind") == controller.get("kind") and ref.get("uid") == controller.get("uid"):
                return 0
        return MAX_NODE_SCORE

    return _score_list(snapshot, fn)


def image_locality_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    """ImageLocalityPriorityMap (image_locality.go): sum of image sizes
    already on the node, scaled by image spread (numNodes/totalNodes),
    clamped to [23MB, 1000MB] and mapped to [0, 10]."""
    total_nodes = len(snapshot.node_infos)
    image_node_counts = snapshot.total_image_nodes()

    def fn(ni: NodeInfo) -> int:
        sizes = ni.image_sizes()
        total = 0
        for c in pod.containers:
            name = normalized_image_name(c.image)
            if name in sizes:
                spread = image_node_counts.get(name, 0) / total_nodes if total_nodes else 0
                total += int(sizes[name] * spread)
        s = min(max(total, IMAGE_MIN_THRESHOLD), IMAGE_MAX_THRESHOLD)
        return MAX_NODE_SCORE * (s - IMAGE_MIN_THRESHOLD) // (IMAGE_MAX_THRESHOLD - IMAGE_MIN_THRESHOLD)

    return _score_list(snapshot, fn)


# ---------------------------------------------------------------------------
# SelectorSpread (selector_spreading.go)
# ---------------------------------------------------------------------------

ZONE_WEIGHTING = 2.0 / 3.0


def selector_spread_priority(
    pod: Pod, snapshot: Snapshot, selectors: Optional[List[LabelSelector]] = None
) -> Scores:
    """CalculateSpreadPriorityMap/Reduce: count same-namespace, non-deleting
    pods matching ALL controller selectors (services/RC/RS/SS of the pod);
    fewer is better, blended 1/3 node-level + 2/3 zone-level."""
    selectors = selectors or []
    counts: Scores = {}
    for name, ni in snapshot.node_infos.items():
        if not selectors:
            counts[name] = 0
            continue
        c = 0
        for ep in ni.pods:
            if ep.namespace != pod.namespace or ep.deletion_timestamp is not None:
                continue
            if all(match_label_selector(sel, ep.labels) for sel in selectors):
                c += 1
        counts[name] = c

    max_by_node = max(counts.values(), default=0)
    counts_by_zone: Dict[str, int] = {}
    for name, ni in snapshot.node_infos.items():
        zone = get_zone_key(ni.node)
        if zone:
            counts_by_zone[zone] = counts_by_zone.get(zone, 0) + counts[name]
    max_by_zone = max(counts_by_zone.values(), default=0)

    out: Scores = {}
    for name, ni in snapshot.node_infos.items():
        f = float(MAX_NODE_SCORE)
        if max_by_node > 0:
            f = MAX_NODE_SCORE * ((max_by_node - counts[name]) / max_by_node)
        if counts_by_zone:
            zone = get_zone_key(ni.node)
            if zone:
                zf = float(MAX_NODE_SCORE)
                if max_by_zone > 0:
                    zf = MAX_NODE_SCORE * ((max_by_zone - counts_by_zone[zone]) / max_by_zone)
                f = f * (1.0 - ZONE_WEIGHTING) + ZONE_WEIGHTING * zf
        out[name] = int(f)
    return out


# ---------------------------------------------------------------------------
# EvenPodsSpread soft constraints (even_pods_spread.go)
# ---------------------------------------------------------------------------

def even_pods_spread_priority(pod: Pod, snapshot: Snapshot) -> Scores:
    """CalculateEvenPodsSpreadPriority: total matching count minus the node's
    own count, normalized by (total - minCount) * 10. Candidate nodes are
    those passing the pod's node selector/affinity AND carrying all soft
    constraint topology keys; others score 0.

    NOTE (reference quirk, even_pods_spread.go:112): the per-node sum counts
    matching pods over ALL namespaces — unlike the hard-constraint predicate
    metadata which restricts to the incoming pod's namespace."""
    constraints = get_soft_spread_constraints(pod)
    result: Scores = {name: 0 for name in snapshot.node_infos}
    if not constraints:
        return result

    # initialize: candidate nodes must match spread constraints' keys
    candidate: Dict[str, bool] = {}
    pair_counts: Dict[Tuple[str, str], int] = {}
    for name, ni in snapshot.node_infos.items():
        if not node_labels_match_spread_constraints(ni.node.labels, constraints):
            continue
        candidate[name] = True
        for c in constraints:
            pair_counts.setdefault((c.topology_key, ni.node.labels[c.topology_key]), 0)

    # count matches per topology pair over nodes that ALSO pass the pod's
    # node selector/affinity
    for name, ni in snapshot.node_infos.items():
        if not pod_match_node_selector(pod, ni):
            continue
        if not node_labels_match_spread_constraints(ni.node.labels, constraints):
            continue
        for c in constraints:
            pair = (c.topology_key, ni.node.labels[c.topology_key])
            if pair not in pair_counts:
                continue
            pair_counts[pair] += sum(
                1 for ep in ni.pods if pod_matches_spread_constraint(ep.labels, c)
            )

    node_counts: Scores = {}
    total = 0
    min_count = None
    for name, ni in snapshot.node_infos.items():
        if name not in candidate:
            continue
        cnt = 0
        for c in constraints:
            tp_val = ni.node.labels.get(c.topology_key)
            if tp_val is not None:
                cnt += pair_counts.get((c.topology_key, tp_val), 0)
                total += pair_counts.get((c.topology_key, tp_val), 0)
        node_counts[name] = cnt
        if min_count is None or cnt < min_count:
            min_count = cnt

    if min_count is None:
        return result
    max_min_diff = total - min_count
    for name in snapshot.node_infos:
        if name not in node_counts:
            result[name] = 0
        elif max_min_diff == 0:
            result[name] = MAX_NODE_SCORE
        else:
            result[name] = int(MAX_NODE_SCORE * ((total - node_counts[name]) / max_min_diff))
    return result


# ---------------------------------------------------------------------------
# InterPodAffinity priority (interpod_affinity.go)
# ---------------------------------------------------------------------------

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1  # api/types.go DefaultHardPodAffinitySymmetricWeight


def inter_pod_affinity_priority(
    pod: Pod, snapshot: Snapshot, hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT
) -> Scores:
    """CalculateInterPodAffinityPriority: for every existing pod, accumulate
    term weights onto all nodes sharing the term's topology key with the
    existing pod's node; includes the symmetric contributions of existing
    pods' own (anti-)affinity toward the incoming pod. Final min-max
    normalization to [0, 10]."""
    aff = pod.affinity
    has_aff = aff is not None and aff.pod_affinity is not None
    has_anti = aff is not None and aff.pod_anti_affinity is not None

    node_list = list(snapshot.node_infos.values())
    counts = {ni.node.name: 0 for ni in node_list}

    def process_term(term, owner: Pod, to_check: Pod, fixed_node, weight: int) -> None:
        if weight == 0:
            return
        if not pod_matches_term(to_check, owner, term):
            return
        if not term.topology_key:
            return
        fixed_val = fixed_node.labels.get(term.topology_key)
        if fixed_val is None:
            return
        for ni in node_list:
            if ni.node.labels.get(term.topology_key) == fixed_val:
                counts[ni.node.name] += weight

    for ni in node_list:
        # When the incoming pod has constraints, iterate ALL existing pods on
        # the node; otherwise only pods that themselves have constraints.
        pods_iter = ni.pods if (has_aff or has_anti) else ni.pods_with_affinity()
        ep_node = ni.node
        for ep in pods_iter:
            ep_aff = ep.affinity
            if has_aff:
                for w in aff.pod_affinity.preferred:
                    process_term(w.pod_affinity_term, pod, ep, ep_node, w.weight)
            if has_anti:
                for w in aff.pod_anti_affinity.preferred:
                    process_term(w.pod_affinity_term, pod, ep, ep_node, -w.weight)
            if ep_aff is not None and ep_aff.pod_affinity is not None:
                if hard_pod_affinity_weight > 0:
                    for term in ep_aff.pod_affinity.required:
                        process_term(term, ep, pod, ep_node, hard_pod_affinity_weight)
                for w in ep_aff.pod_affinity.preferred:
                    process_term(w.pod_affinity_term, ep, pod, ep_node, w.weight)
            if ep_aff is not None and ep_aff.pod_anti_affinity is not None:
                for w in ep_aff.pod_anti_affinity.preferred:
                    process_term(w.pod_affinity_term, ep, pod, ep_node, -w.weight)

    max_count = max(counts.values(), default=0)
    min_count = min(counts.values(), default=0)
    max_count = max(max_count, 0)
    min_count = min(min_count, 0)
    diff = max_count - min_count
    out: Scores = {}
    for name, c in counts.items():
        out[name] = int(MAX_NODE_SCORE * ((c - min_count) / diff)) if diff > 0 else 0
    return out


# ---------------------------------------------------------------------------
# Default weighted sum (PrioritizeNodes, core/generic_scheduler.go:699)
# ---------------------------------------------------------------------------

DEFAULT_PRIORITY_WEIGHTS = {
    "SelectorSpreadPriority": 1,
    "InterPodAffinityPriority": 1,
    "LeastRequestedPriority": 1,
    "BalancedResourceAllocation": 1,
    "NodePreferAvoidPodsPriority": 10000,
    "NodeAffinityPriority": 1,
    "TaintTolerationPriority": 1,
    "ImageLocalityPriority": 1,
    "EvenPodsSpreadPriority": 1,
    # not in the default provider (ClusterAutoscalerProvider swaps it in for
    # LeastRequested); weight 0 unless a config raises it
    "MostRequestedPriority": 0,
    # Policy-argument custom priority (requested_to_capacity_ratio.go) and
    # the ResourceLimits feature-gated tie-breaker (resource_limits.go):
    # active only when a config names them
    "RequestedToCapacityRatioPriority": 0,
    "ResourceLimitsPriority": 0,
}


def prioritize_nodes(
    pod: Pod,
    snapshot: Snapshot,
    weights: Optional[Dict[str, int]] = None,
    spread_selectors: Optional[List[LabelSelector]] = None,
    enable_even_pods_spread: bool = True,
    rtcr: Optional[Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[str, int], ...]]] = None,
) -> Scores:
    w = dict(DEFAULT_PRIORITY_WEIGHTS)
    if weights:
        w.update(weights)
    rtcr_shape, rtcr_resources = rtcr if rtcr is not None else (
        DEFAULT_RTCR_SHAPE,
        DEFAULT_RTCR_RESOURCES,
    )
    # each map is O(nodes×pods): only compute the ones with weight > 0
    makers: Dict[str, Callable[[], Scores]] = {
        "SelectorSpreadPriority": lambda: selector_spread_priority(pod, snapshot, spread_selectors),
        "InterPodAffinityPriority": lambda: inter_pod_affinity_priority(pod, snapshot),
        "MostRequestedPriority": lambda: most_requested_priority(pod, snapshot),
        "LeastRequestedPriority": lambda: least_requested_priority(pod, snapshot),
        "BalancedResourceAllocation": lambda: balanced_resource_allocation(pod, snapshot),
        "NodePreferAvoidPodsPriority": lambda: node_prefer_avoid_pods_priority(pod, snapshot),
        "NodeAffinityPriority": lambda: node_affinity_priority(pod, snapshot),
        "TaintTolerationPriority": lambda: taint_toleration_priority(pod, snapshot),
        "ImageLocalityPriority": lambda: image_locality_priority(pod, snapshot),
        "RequestedToCapacityRatioPriority": lambda: requested_to_capacity_ratio_priority(
            pod, snapshot, rtcr_shape, rtcr_resources
        ),
        "ResourceLimitsPriority": lambda: resource_limits_priority(pod, snapshot),
    }
    if enable_even_pods_spread:
        makers["EvenPodsSpreadPriority"] = lambda: even_pods_spread_priority(pod, snapshot)
    total: Scores = {name: 0 for name in snapshot.node_infos}
    for pname, make in makers.items():
        weight = w.get(pname, 0)
        if not weight:
            continue
        for node_name, s in make().items():
            total[node_name] += weight * s
    return total


# ---------------------------------------------------------------------------
# Policy custom-argument priorities (api/types.go:94-137): labelPreference →
# NodeLabelPrioritizer (node_label.go:46), serviceAntiAffinity →
# ServiceAntiAffinity map/reduce (selector_spreading.go:211-277).
# Registered as framework Score plugins by the factory.
# ---------------------------------------------------------------------------

def node_label_priority(pod: Pod, snapshot: Snapshot, label: str, presence: bool) -> Scores:
    """CalculateNodeLabelPriorityMap: MaxNodeScore when the node's
    has-the-label state matches `presence`, else 0. No normalization."""

    def fn(ni: NodeInfo) -> int:
        exists = label in ni.node.labels
        return MAX_NODE_SCORE if exists == presence else 0

    return _score_list(snapshot, fn)


def service_anti_affinity_priority(
    pod: Pod, snapshot: Snapshot, label: str, services
) -> Scores:
    """ServiceAntiAffinity map+reduce (selector_spreading.go:211-277):
    map counts same-namespace pods matching the pod's FIRST service
    selector per node; reduce groups nodes by the configured label's value
    and scores maxScore * (total - group) / total — label-less nodes score
    0, zero service pods scores maxScore everywhere labeled."""
    from .predicates import get_pod_services

    matching = get_pod_services(pod, services)
    first_selector = dict(matching[0].selector) if matching else None

    def count_on(ni: NodeInfo) -> int:
        if first_selector is None:
            return 0
        c = 0
        for p in ni.pods:
            if p.namespace != pod.namespace:
                continue
            if all(p.labels.get(k) == v for k, v in first_selector.items()):
                c += 1
        return c

    raw = {name: count_on(ni) for name, ni in snapshot.node_infos.items()}
    num_service_pods = sum(raw.values())
    pod_counts: Dict[str, int] = {}
    label_of: Dict[str, str] = {}
    for name, ni in snapshot.node_infos.items():
        if label in ni.node.labels:
            val = ni.node.labels[label]
            label_of[name] = val
            pod_counts[val] = pod_counts.get(val, 0) + raw[name]
    out: Scores = {}
    for name in snapshot.node_infos:
        val = label_of.get(name)
        if val is None:
            out[name] = 0
            continue
        if num_service_pods > 0:
            out[name] = int(
                MAX_NODE_SCORE * (num_service_pods - pod_counts[val]) / num_service_pods
            )
        else:
            out[name] = MAX_NODE_SCORE
    return out
