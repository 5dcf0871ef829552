"""KubeSchedulerConfiguration (pkg/scheduler/apis/config/types.go; staged
copy staging/src/k8s.io/kube-scheduler); the port's own copy of
`kubernetes_tpu.config.componentconfig`.

JSON shape (v1alpha1):
    {"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
     "kind": "KubeSchedulerConfiguration",
     "schedulerName": "default-scheduler",
     "algorithmSource": {"provider": "DefaultProvider"}
                        | {"policy": {"file": {"path": "..."}}},
     "percentageOfNodesToScore": 50,
     "bindTimeoutSeconds": 600,
     "leaderElection": {"leaderElect": true, "leaseDuration": "15s", ...},
     "metricsBindAddress": "127.0.0.1:10251",
     "featureGates": {"EvenPodsSpread": true}}
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional

from .policy import DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE


def _parse_duration(v, default_s: float) -> float:
    """Go duration → seconds: '15s', '2m', '1m30s', '1h2m3.5s', or a bare
    number."""
    if v is None:
        return default_s
    if isinstance(v, (int, float)):
        return float(v)
    import re

    s = str(v).strip()
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    parts = re.findall(r"([0-9]*\.?[0-9]+)(ms|s|m|h)", s)
    if parts and "".join(n + u for n, u in parts) == s:
        return sum(float(n) * units[u] for n, u in parts)
    return float(s)


@dataclass
class LeaderElectionConfig:
    leader_elect: bool = False
    lease_duration_s: float = 15.0
    renew_deadline_s: float = 10.0
    retry_period_s: float = 2.0
    resource_name: str = "kube-scheduler"
    resource_namespace: str = "kube-system"


@dataclass
class KubeSchedulerConfiguration:
    scheduler_name: str = "default-scheduler"
    algorithm_provider: Optional[str] = "DefaultProvider"
    policy_file: Optional[str] = None
    percentage_of_nodes_to_score: int = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE
    bind_timeout_seconds: float = 600.0
    metrics_bind_address: str = ""
    leader_election: LeaderElectionConfig = field(default_factory=LeaderElectionConfig)
    feature_gates: Dict[str, bool] = field(default_factory=dict)


def parse_component_config(obj: dict) -> KubeSchedulerConfiguration:
    cfg = KubeSchedulerConfiguration()
    cfg.scheduler_name = obj.get("schedulerName", cfg.scheduler_name)
    src = obj.get("algorithmSource") or {}
    if "policy" in src and src["policy"]:
        cfg.algorithm_provider = None
        f = (src["policy"].get("file") or {}).get("path")
        cfg.policy_file = f
    elif "provider" in src and src["provider"]:
        cfg.algorithm_provider = src["provider"]
    cfg.percentage_of_nodes_to_score = int(
        obj.get("percentageOfNodesToScore", cfg.percentage_of_nodes_to_score)
    )
    cfg.bind_timeout_seconds = float(obj.get("bindTimeoutSeconds", cfg.bind_timeout_seconds))
    cfg.metrics_bind_address = obj.get("metricsBindAddress", "")
    le = obj.get("leaderElection") or {}
    cfg.leader_election = LeaderElectionConfig(
        leader_elect=bool(le.get("leaderElect", False)),
        lease_duration_s=_parse_duration(le.get("leaseDuration"), 15.0),
        renew_deadline_s=_parse_duration(le.get("renewDeadline"), 10.0),
        retry_period_s=_parse_duration(le.get("retryPeriod"), 2.0),
        resource_name=le.get("resourceName", "kube-scheduler"),
        resource_namespace=le.get("resourceNamespace", "kube-system"),
    )
    cfg.feature_gates = dict(obj.get("featureGates") or {})
    return cfg


def load_component_config(path: str) -> KubeSchedulerConfiguration:
    with open(path) as f:
        return parse_component_config(json.load(f))
