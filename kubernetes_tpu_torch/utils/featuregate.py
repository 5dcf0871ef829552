"""Feature gates (component-base/featuregate + pkg/features/kube_features.go):
the port's own copy of `kubernetes_tpu.utils.featuregate`.

The scheduler-relevant gates of the reference era with their 1.16 defaults:
EvenPodsSpread alpha/off (kube_features.go:480), ResourceLimits alpha/off,
TaintNodesByCondition GA/on (which is why the node-condition predicates are
NOT in the effective default provider — defaults.go:63-90 replaces them
with taint-based checks), VolumeScheduling GA/on.

Parses the kubelet-style --feature-gates=A=true,B=false syntax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    stage: str = ALPHA
    locked_to_default: bool = False  # GA features can't be turned off


# scheduler-relevant subset of kube_features.go (159 gates upstream; the
# rest gate components out of scope here)
KNOWN_FEATURES: Dict[str, FeatureSpec] = {
    "EvenPodsSpread": FeatureSpec(default=False, stage=ALPHA),
    "ResourceLimits": FeatureSpec(default=False, stage=ALPHA),
    "TaintNodesByCondition": FeatureSpec(default=True, stage=GA, locked_to_default=True),
    "VolumeScheduling": FeatureSpec(default=True, stage=GA, locked_to_default=True),
    "ScheduleDaemonSetPods": FeatureSpec(default=True, stage=BETA),
    "NonPreemptingPriority": FeatureSpec(default=False, stage=ALPHA),
}


class FeatureGate:
    def __init__(
        self,
        known: Optional[Mapping[str, FeatureSpec]] = None,
        overrides: Optional[Mapping[str, bool]] = None,
    ):
        self._known = dict(known if known is not None else KNOWN_FEATURES)
        self._enabled: Dict[str, bool] = {}
        if overrides:
            self.set_from_map(overrides)

    def add(self, name: str, spec: FeatureSpec) -> None:
        if name in self._known:
            raise ValueError(f"feature {name} already known")
        self._known[name] = spec

    def enabled(self, name: str) -> bool:
        if name in self._enabled:
            return self._enabled[name]
        spec = self._known.get(name)
        if spec is None:
            raise KeyError(f"unknown feature gate {name}")
        return spec.default

    def set_from_map(self, m: Mapping[str, bool]) -> None:
        for name, value in m.items():
            spec = self._known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name}")
            if spec.locked_to_default and value != spec.default:
                raise ValueError(f"cannot set {name}: locked to default since {spec.stage}")
            self._enabled[name] = bool(value)

    def parse(self, s: str) -> None:
        """--feature-gates=A=true,B=false"""
        if not s:
            return
        m: Dict[str, bool] = {}
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"invalid feature gate {part!r} (want name=bool)")
            name, _, val = part.partition("=")
            if val.lower() not in ("true", "false"):
                raise ValueError(f"invalid boolean {val!r} for feature {name}")
            m[name.strip()] = val.lower() == "true"
        self.set_from_map(m)

    def known(self) -> Dict[str, FeatureSpec]:
        return dict(self._known)


DEFAULT_FEATURE_GATE = FeatureGate()
