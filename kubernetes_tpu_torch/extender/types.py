"""extender/v1 wire types: the port's own copy of
`kubernetes_tpu.extender.types`.

Faithful JSON shapes of pkg/scheduler/apis/extender/v1/types.go (mirrored
in staging/src/k8s.io/kube-scheduler/extender/v1): the Go structs carry no
json tags, so the wire keys are the exported field names verbatim ("Pod",
"NodeNames", "FailedNodes", ...). Pods/Nodes embed full v1 objects and are
converted through api.types.{pod,node}_{from,to}_k8s.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api.types import Node, Pod, node_from_k8s, node_to_k8s, pod_from_k8s, pod_to_k8s

MIN_EXTENDER_PRIORITY = 0
MAX_EXTENDER_PRIORITY = 10


@dataclass
class ExtenderArgs:
    pod: Optional[Pod] = None
    nodes: Optional[List[Node]] = None  # NodeCacheCapable == false
    node_names: Optional[List[str]] = None  # NodeCacheCapable == true

    @staticmethod
    def from_json(d: dict) -> "ExtenderArgs":
        nodes = None
        if d.get("Nodes") is not None:
            nodes = [node_from_k8s(o) for o in d["Nodes"].get("items") or []]
        return ExtenderArgs(
            pod=pod_from_k8s(d["Pod"]) if d.get("Pod") is not None else None,
            nodes=nodes,
            node_names=list(d["NodeNames"]) if d.get("NodeNames") is not None else None,
        )

    def to_json(self) -> dict:
        return {
            "Pod": pod_to_k8s(self.pod) if self.pod is not None else None,
            "Nodes": (
                {"items": [node_to_k8s(n) for n in self.nodes]} if self.nodes is not None else None
            ),
            "NodeNames": self.node_names,
        }


@dataclass
class ExtenderFilterResult:
    nodes: Optional[List[Node]] = None
    node_names: Optional[List[str]] = None
    failed_nodes: Dict[str, str] = field(default_factory=dict)
    error: str = ""

    @staticmethod
    def from_json(d: dict) -> "ExtenderFilterResult":
        nodes = None
        if d.get("Nodes") is not None:
            nodes = [node_from_k8s(o) for o in d["Nodes"].get("items") or []]
        return ExtenderFilterResult(
            nodes=nodes,
            node_names=list(d["NodeNames"]) if d.get("NodeNames") is not None else None,
            failed_nodes=dict(d.get("FailedNodes") or {}),
            error=d.get("Error", "") or "",
        )

    def to_json(self) -> dict:
        return {
            "Nodes": (
                {"items": [node_to_k8s(n) for n in self.nodes]} if self.nodes is not None else None
            ),
            "NodeNames": self.node_names,
            "FailedNodes": self.failed_nodes,
            "Error": self.error,
        }


@dataclass
class HostPriority:
    host: str = ""
    score: int = 0

    @staticmethod
    def from_json(d: dict) -> "HostPriority":
        return HostPriority(host=d.get("Host", ""), score=int(d.get("Score", 0)))

    def to_json(self) -> dict:
        return {"Host": self.host, "Score": self.score}


@dataclass
class ExtenderBindingArgs:
    pod_name: str = ""
    pod_namespace: str = ""
    pod_uid: str = ""
    node: str = ""

    @staticmethod
    def from_json(d: dict) -> "ExtenderBindingArgs":
        return ExtenderBindingArgs(
            pod_name=d.get("PodName", ""),
            pod_namespace=d.get("PodNamespace", ""),
            pod_uid=str(d.get("PodUID", "")),
            node=d.get("Node", ""),
        )

    def to_json(self) -> dict:
        return {
            "PodName": self.pod_name,
            "PodNamespace": self.pod_namespace,
            "PodUID": self.pod_uid,
            "Node": self.node,
        }


@dataclass
class ExtenderBindingResult:
    error: str = ""

    @staticmethod
    def from_json(d: dict) -> "ExtenderBindingResult":
        return ExtenderBindingResult(error=d.get("Error", "") or "")

    def to_json(self) -> dict:
        return {"Error": self.error}


@dataclass
class Victims:
    pods: List[Pod] = field(default_factory=list)
    num_pdb_violations: int = 0

    @staticmethod
    def from_json(d: dict) -> "Victims":
        return Victims(
            pods=[pod_from_k8s(p) for p in d.get("Pods") or []],
            num_pdb_violations=int(d.get("NumPDBViolations", 0)),
        )

    def to_json(self) -> dict:
        return {
            "Pods": [pod_to_k8s(p) for p in self.pods],
            "NumPDBViolations": self.num_pdb_violations,
        }


@dataclass
class MetaVictims:
    pod_uids: List[str] = field(default_factory=list)
    num_pdb_violations: int = 0

    @staticmethod
    def from_json(d: dict) -> "MetaVictims":
        return MetaVictims(
            pod_uids=[p.get("UID", "") for p in d.get("Pods") or []],
            num_pdb_violations=int(d.get("NumPDBViolations", 0)),
        )

    def to_json(self) -> dict:
        return {
            "Pods": [{"UID": u} for u in self.pod_uids],
            "NumPDBViolations": self.num_pdb_violations,
        }


@dataclass
class ExtenderPreemptionArgs:
    pod: Optional[Pod] = None
    node_name_to_victims: Dict[str, Victims] = field(default_factory=dict)
    node_name_to_meta_victims: Dict[str, MetaVictims] = field(default_factory=dict)

    @staticmethod
    def from_json(d: dict) -> "ExtenderPreemptionArgs":
        return ExtenderPreemptionArgs(
            pod=pod_from_k8s(d["Pod"]) if d.get("Pod") is not None else None,
            node_name_to_victims={
                k: Victims.from_json(v) for k, v in (d.get("NodeNameToVictims") or {}).items()
            },
            node_name_to_meta_victims={
                k: MetaVictims.from_json(v)
                for k, v in (d.get("NodeNameToMetaVictims") or {}).items()
            },
        )

    def to_json(self) -> dict:
        out: dict = {"Pod": pod_to_k8s(self.pod) if self.pod is not None else None}
        if self.node_name_to_victims:
            out["NodeNameToVictims"] = {
                k: v.to_json() for k, v in self.node_name_to_victims.items()
            }
        if self.node_name_to_meta_victims:
            out["NodeNameToMetaVictims"] = {
                k: v.to_json() for k, v in self.node_name_to_meta_victims.items()
            }
        return out


@dataclass
class ExtenderPreemptionResult:
    node_name_to_meta_victims: Dict[str, MetaVictims] = field(default_factory=dict)

    @staticmethod
    def from_json(d: dict) -> "ExtenderPreemptionResult":
        return ExtenderPreemptionResult(
            node_name_to_meta_victims={
                k: MetaVictims.from_json(v)
                for k, v in (d.get("NodeNameToMetaVictims") or {}).items()
            }
        )

    def to_json(self) -> dict:
        return {
            "NodeNameToMetaVictims": {
                k: v.to_json() for k, v in self.node_name_to_meta_victims.items()
            }
        }
