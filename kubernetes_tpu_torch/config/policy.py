"""The legacy Policy API (pkg/scheduler/api/types.go Policy, loadable from
a file or ConfigMap — scheduler.go:352-386 initPolicyFrom*); the port's own
copy of `kubernetes_tpu.config.policy`.

JSON shape:
    {"kind": "Policy", "apiVersion": "v1",
     "predicates": [{"name": "PodFitsResources"}, ...],
     "priorities": [{"name": "LeastRequestedPriority", "weight": 1}, ...],
     "extenders": [{"urlPrefix": ..., "filterVerb": ..., ...}],
     "hardPodAffinitySymmetricWeight": 1}

Empty predicate/priority lists mean "use the defaults" only when the key
is ABSENT; an explicitly empty list means none (factory.go:304-381
CreateFromConfig semantics).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..extender.client import ExtenderConfig
from .provider import KNOWN_PREDICATES, KNOWN_PRIORITIES, default_predicates, default_priorities

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 50  # api/types.go:29 (moot: full matrix)


class PolicyError(ValueError):
    pass


@dataclass
class Policy:
    predicates: Optional[frozenset] = None  # None = defaults
    priorities: Optional[Tuple[Tuple[str, int], ...]] = None
    extenders: List[ExtenderConfig] = field(default_factory=list)
    hard_pod_affinity_symmetric_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT
    # requestedToCapacityRatioArguments, when a priority entry supplies it
    # (api/types.go:139-152): (shape points (utilization, score), resource
    # weights (name, weight))
    rtcr: Optional[Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[str, int], ...]]] = None
    # Custom-argument predicates/priorities (api/types.go:83-137) — run as
    # framework Filter/Score plugins over the host commit path (the factory
    # builds them; RegisterCustomFitPredicate plugins.go:127 semantics):
    #   ("CheckNodeLabelPresence", name, labels, presence)
    #   ("ServiceAffinity",        name, labels)
    custom_predicates: Tuple[tuple, ...] = ()
    #   ("NodeLabel",           name, weight, label, presence)
    #   ("ServiceAntiAffinity", name, weight, label)
    custom_priorities: Tuple[tuple, ...] = ()


def _extender_from_json(d: dict) -> ExtenderConfig:
    return ExtenderConfig(
        url_prefix=d.get("urlPrefix", ""),
        filter_verb=d.get("filterVerb", ""),
        prioritize_verb=d.get("prioritizeVerb", ""),
        bind_verb=d.get("bindVerb", ""),
        preempt_verb=d.get("preemptVerb", ""),
        weight=int(d.get("weight", 1)),
        node_cache_capable=bool(d.get("nodeCacheCapable", False)),
        ignorable=bool(d.get("ignorable", False)),
        managed_resources=[
            r.get("name", "") for r in d.get("managedResources") or []
        ],
        timeout_s=float(d.get("httpTimeout", 5.0)),
    )


def _parse_rtcr_arguments(d: dict):
    """RequestedToCapacityRatioArguments (api/types.go:139-152 →
    buildScoringFunctionShapeFromRequestedToCapacityRatioArguments,
    plugins.go:416-438): shape points validated by NewFunctionShape; empty
    resources default to cpu/memory weight 1; zero weights become 1."""
    from ..oracle.priorities import validate_function_shape

    shape = tuple(
        (int(pt.get("utilization", 0)), int(pt.get("score", 0)))
        for pt in d.get("shape") or []
    )
    try:
        validate_function_shape(shape)
    except ValueError as e:
        raise PolicyError(f"invalid RequestedToCapacityRatio arguments: {e}")
    res = d.get("resources") or []
    if not res:
        resources = (("cpu", 1), ("memory", 1))
    else:
        for r in res:
            if int(r.get("weight", 0)) < 0:
                raise PolicyError(
                    f"RequestedToCapacityRatio resource {r.get('name')!r} "
                    "weight must not be negative"
                )
        # an omitted/zero weight becomes 1 (plugins.go:432-435)
        resources = tuple(
            (r.get("name", ""), int(r.get("weight", 0)) or 1) for r in res
        )
    for rname, _ in resources:
        if rname not in ("cpu", "memory"):
            raise PolicyError(
                f"RequestedToCapacityRatio resource {rname!r} not supported by "
                "the device score path (cpu/memory only)"
            )
    return shape, resources


def parse_policy(obj: dict) -> Policy:
    if obj.get("kind") not in (None, "Policy"):
        raise PolicyError(f"not a Policy: kind={obj.get('kind')!r}")
    policy = Policy()
    # Go json semantics: an ABSENT or NULL slice means "use defaults"; only
    # an explicitly-empty list means none (factory.go CreateFromConfig)
    if obj.get("predicates") is not None:
        names = set()
        custom_preds = []
        for p in obj["predicates"] or []:
            name = p.get("name", "")
            arg = p.get("argument") or {}
            lp = arg.get("labelsPresence")
            sa = arg.get("serviceAffinity")
            if lp is not None:
                # RegisterCustomFitPredicate (plugins.go:127): user-named
                # CheckNodeLabelPresence instance
                custom_preds.append((
                    "CheckNodeLabelPresence",
                    name,
                    tuple(lp.get("labels") or []),
                    bool(lp.get("presence", False)),
                ))
                continue
            if sa is not None:
                custom_preds.append((
                    "ServiceAffinity",
                    name,
                    tuple(sa.get("labels") or []),
                ))
                continue
            if name not in KNOWN_PREDICATES:
                raise PolicyError(f"unknown predicate {name!r}")
            names.add(name)
        policy.predicates = frozenset(names)
        policy.custom_predicates = tuple(custom_preds)
    else:
        policy.predicates = default_predicates()
    if obj.get("priorities") is not None:
        pairs = []
        custom_pris = []
        for p in obj["priorities"] or []:
            name = p.get("name", "")
            weight = int(p.get("weight", 1))
            if weight < 0:
                raise PolicyError(f"negative weight for {name}")
            arg = p.get("argument") or {}
            lpref = arg.get("labelPreference")
            saa = arg.get("serviceAntiAffinity")
            if lpref is not None:
                custom_pris.append((
                    "NodeLabel",
                    name,
                    weight,
                    lpref.get("label", ""),
                    bool(lpref.get("presence", False)),
                ))
                continue
            if saa is not None:
                custom_pris.append((
                    "ServiceAntiAffinity",
                    name,
                    weight,
                    saa.get("label", ""),
                ))
                continue
            rtcr_args = arg.get("requestedToCapacityRatioArguments")
            if rtcr_args is not None:
                # custom priority carrying its own name; register it under
                # the canonical kernel name (plugins.go:389-393 builds an
                # RTCR function for whatever name the Policy chose). Only ONE
                # such entry is representable — a second would silently
                # shadow the first's shape, so reject it.
                if policy.rtcr is not None:
                    raise PolicyError(
                        "multiple priorities with requestedToCapacityRatioArguments"
                    )
                policy.rtcr = _parse_rtcr_arguments(rtcr_args)
                pairs.append(("RequestedToCapacityRatioPriority", weight))
                continue
            if name not in KNOWN_PRIORITIES:
                raise PolicyError(f"unknown priority {name!r}")
            pairs.append((name, weight))
        policy.priorities = tuple(pairs)
        policy.custom_priorities = tuple(custom_pris)
    else:
        policy.priorities = default_priorities()
    policy.extenders = [_extender_from_json(e) for e in obj.get("extenders") or []]
    w = obj.get("hardPodAffinitySymmetricWeight")
    if w is not None:
        if not (0 <= int(w) <= 100):
            raise PolicyError("hardPodAffinitySymmetricWeight must be in [0, 100]")
        policy.hard_pod_affinity_symmetric_weight = int(w)
    return policy
