"""Algorithm providers: named default predicate/priority sets
(pkg/scheduler/algorithmprovider/defaults/defaults.go); the port's own
copy of `kubernetes_tpu.config.provider`.

The 1.16 effective defaults: TaintNodesByCondition is GA, so the
node-condition predicates are already replaced by PodToleratesNodeTaints +
CheckNodeUnschedulable (ApplyFeatureGates, defaults.go:63-90); the
EvenPodsSpread gate adds its predicate + priority (defaults.go:94-103).

ClusterAutoscalerProvider = default with MostRequested replacing
LeastRequested (defaults.go:33-37).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..utils.featuregate import DEFAULT_FEATURE_GATE, FeatureGate

# volume predicate registration names: the reference's volume checker runs
# them; the port has no volume seam yet, so the chain passes over them
VOLUME_PREDICATES = frozenset(
    {
        "NoVolumeZoneConflict",
        "MaxEBSVolumeCount",
        "MaxGCEPDVolumeCount",
        "MaxAzureDiskVolumeCount",
        "MaxCSIVolumeCountPred",
        "NoDiskConflict",
        "CheckVolumeBinding",
    }
)

# device/oracle predicate names (predicates.go:56-110)
CORE_PREDICATES = frozenset(
    {
        "CheckNodeUnschedulable",
        "GeneralPredicates",
        "HostName",
        "PodFitsHostPorts",
        "MatchNodeSelector",
        "PodFitsResources",
        "PodToleratesNodeTaints",
        "MatchInterPodAffinity",
        "EvenPodsSpread",
    }
)

KNOWN_PREDICATES = CORE_PREDICATES | VOLUME_PREDICATES

KNOWN_PRIORITIES = frozenset(
    {
        "EqualPriority",
        "LeastRequestedPriority",
        "MostRequestedPriority",
        "BalancedResourceAllocation",
        "NodeAffinityPriority",
        "TaintTolerationPriority",
        "NodePreferAvoidPodsPriority",
        "ImageLocalityPriority",
        "SelectorSpreadPriority",
        "InterPodAffinityPriority",
        "EvenPodsSpreadPriority",
        # feature-gated (ResourceLimits, defaults.go:106-111)
        "ResourceLimitsPriority",
        # Policy-argument custom priority (plugins.go:389-393); the
        # registration name used when a Policy supplies
        # requestedToCapacityRatioArguments
        "RequestedToCapacityRatioPriority",
    }
)


def default_predicates(fg: Optional[FeatureGate] = None) -> frozenset:
    fg = fg or DEFAULT_FEATURE_GATE
    preds = {
        "NoVolumeZoneConflict",
        "MaxEBSVolumeCount",
        "MaxGCEPDVolumeCount",
        "MaxAzureDiskVolumeCount",
        "MaxCSIVolumeCountPred",
        "MatchInterPodAffinity",
        "NoDiskConflict",
        "GeneralPredicates",
        "PodToleratesNodeTaints",
        "CheckVolumeBinding",
        # TaintNodesByCondition GA replacement (defaults.go:63-90)
        "CheckNodeUnschedulable",
    }
    if fg.enabled("EvenPodsSpread"):
        preds.add("EvenPodsSpread")
    return frozenset(preds)


def default_priorities(fg: Optional[FeatureGate] = None) -> Tuple[Tuple[str, int], ...]:
    fg = fg or DEFAULT_FEATURE_GATE
    pairs = [
        ("SelectorSpreadPriority", 1),
        ("InterPodAffinityPriority", 1),
        ("LeastRequestedPriority", 1),
        ("BalancedResourceAllocation", 1),
        ("NodePreferAvoidPodsPriority", 10000),
        ("NodeAffinityPriority", 1),
        ("TaintTolerationPriority", 1),
        ("ImageLocalityPriority", 1),
    ]
    if fg.enabled("EvenPodsSpread"):
        pairs.append(("EvenPodsSpreadPriority", 1))
    if fg.enabled("ResourceLimits"):
        # ResourceLimitsPriorityFunction gate (defaults.go:106-111)
        pairs.append(("ResourceLimitsPriority", 1))
    return tuple(pairs)


def cluster_autoscaler_predicates(fg: Optional[FeatureGate] = None) -> frozenset:
    return default_predicates(fg)


def cluster_autoscaler_priorities(fg: Optional[FeatureGate] = None) -> Tuple[Tuple[str, int], ...]:
    return tuple(
        (("MostRequestedPriority", w) if n == "LeastRequestedPriority" else (n, w))
        for n, w in default_priorities(fg)
    )


PROVIDERS: Dict[str, Dict[str, object]] = {
    "DefaultProvider": {
        "predicates": default_predicates,
        "priorities": default_priorities,
    },
    "ClusterAutoscalerProvider": {
        "predicates": cluster_autoscaler_predicates,
        "priorities": cluster_autoscaler_priorities,
    },
}


def get_provider(name: str, fg: Optional[FeatureGate] = None):
    """→ (predicates frozenset, priorities tuple). KeyError on unknown."""
    p = PROVIDERS[name]
    return p["predicates"](fg), p["priorities"](fg)
