"""Scheduling-relevant API types: the port's own copy of the pod and node
model of `kubernetes_tpu.api.types` (the subset of `k8s.io/api/core/v1` the
scheduler reads), trimmed to the objects the batch solve encodes. The
constructors and fields are the reference's, so one cluster description
builds in either package."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .quantity import Quantity

# Resource names the scheduler treats as first-class
# (reference: predicates.go:854 PodFitsResources checks cpu/memory/ephemeral-storage
# plus arbitrary scalar resources).
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"

# Taint effects (k8s.io/api/core/v1/types.go).
TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

# Node taint applied for .spec.unschedulable (scheduler api TaintNodeUnschedulable).
TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"

# TopologySpreadConstraint.whenUnsatisfiable values.
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

# Default priority when pod.Spec.Priority is nil (podutil.GetPodPriority).
DEFAULT_POD_PRIORITY = 0

_uid_counter = itertools.count(1)


def _new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    image: str = ""
    ports: List[ContainerPort] = field(default_factory=list)
    requests: Dict[str, Quantity] = field(default_factory=dict)
    limits: Dict[str, Quantity] = field(default_factory=dict)


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_NO_SCHEDULE


@dataclass
class Toleration:
    key: str = ""  # empty key with Exists matches all taints
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    # NoExecute grace: how long the pod stays on a tainted node before
    # eviction (None = forever). Set to 300 by the DefaultTolerationSeconds
    # admission plugin; honored by the nodelifecycle controller.
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """v1helper.TolerationsTolerateTaint semantics
        (staging/src/k8s.io/api/core/v1/toleration.go ToleratesTaint)."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        if self.operator == "Exists":
            return True
        return False


def tolerations_tolerate_taint(tolerations: List[Toleration], taint: Taint) -> bool:
    return any(t.tolerates(taint) for t in tolerations)


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    match_fields: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelector:
    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    """metav1.LabelSelector. None (absence) matches nothing; an empty selector
    matches everything (metav1.LabelSelectorAsSelector semantics)."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = ""


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None


@dataclass
class Volume:
    """v1.Volume — the scheduling-visible sources (predicates.go volume
    predicates read exactly these): PVC references, the attachable in-tree
    disks (GCE PD / AWS EBS / Azure Disk), and the NoDiskConflict sources
    (GCE PD, AWS EBS, RBD, ISCSI). Everything else (emptyDir, configMap,
    ...) is scheduling-neutral and represented only by `name`."""

    name: str = ""
    pvc_claim_name: str = ""  # persistentVolumeClaim.claimName
    gce_pd_name: str = ""
    gce_pd_read_only: bool = False
    aws_volume_id: str = ""
    aws_read_only: bool = False
    azure_disk_name: str = ""
    rbd_pool: str = ""
    rbd_image: str = ""
    rbd_monitors: Tuple[str, ...] = ()
    rbd_read_only: bool = False
    iscsi_target_portal: str = ""
    iscsi_iqn: str = ""
    iscsi_lun: int = 0
    iscsi_read_only: bool = False


@dataclass
class Pod:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=_new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: str = ""
    creation_timestamp: float = field(default_factory=time.time)
    deletion_timestamp: Optional[float] = None
    owner_references: List[Dict[str, Any]] = field(default_factory=list)

    # spec
    node_name: str = ""
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Dict[str, Quantity] = field(default_factory=dict)
    priority: Optional[int] = None
    priority_class_name: str = ""
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    scheduler_name: str = "default-scheduler"
    host_network: bool = False
    volumes: List[Volume] = field(default_factory=list)

    # status
    phase: str = "Pending"
    nominated_node_name: str = ""
    conditions: List[Dict[str, Any]] = field(default_factory=list)

    def key(self) -> str:
        # memoized: called several times per pod per batch across the
        # state machine (assume/finish/forget), the queue, and the
        # oracle's remove-scan; with_node clones carry it. The memo is
        # VALIDATED against name/namespace identity — the controllers
        # clone a template and then rename it (new_child_pod,
        # StatefulSet._ordinal_pod), so a blind cache would pin every
        # child to the template's identity.
        m = self.__dict__.get("_key_memo")
        if m is not None and m[0] is self.namespace and m[1] is self.name:
            return m[2]
        k = f"{self.namespace}/{self.name}"
        self.__dict__["_key_memo"] = (self.namespace, self.name, k)
        return k

    def with_node(self, node_name: str) -> "Pod":
        """Shallow clone bound to a node — the assume-path equivalent of
        dataclasses.replace(pod, node_name=...), but ~20x cheaper (replace
        re-runs __init__ over every field; the commit loop pays it once
        per pod) and it carries the resource-request memo along."""
        clone = object.__new__(Pod)
        clone.__dict__.update(self.__dict__)
        clone.node_name = node_name
        return clone

    def get_priority(self) -> int:
        """podutil.GetPodPriority: nil priority -> 0."""
        return self.priority if self.priority is not None else DEFAULT_POD_PRIORITY

    def resource_request(self) -> Dict[str, int]:
        """predicates.GetResourceRequest semantics (predicates.go:~800-845):
        max(sum over containers, max over init containers) + overhead.
        cpu is millicores, memory/ephemeral-storage bytes, scalar resources
        in their own units (milli for hugepages-safety we use value()).

        Memoized after first call (the oracle evaluates it once per
        candidate NODE): callers must treat the returned dict as
        read-only, and the pod spec must not change after scheduling
        first sees it (updates arrive as new Pod objects)."""
        cached = getattr(self, "_req_cache", None)
        if cached is not None:
            return cached
        total: Dict[str, int] = {}
        for c in self.containers:
            for name, q in c.requests.items():
                total[name] = total.get(name, 0) + _request_value(name, q)
        for ic in self.init_containers:
            for name, q in ic.requests.items():
                v = _request_value(name, q)
                if v > total.get(name, 0):
                    total[name] = v
        for name, q in self.overhead.items():
            total[name] = total.get(name, 0) + _request_value(name, q)
        # idempotent memo on an effectively-immutable pod: concurrent
        # writers compute the identical dict (last write wins, benignly)
        self._req_cache = total
        return total

    def host_ports(self) -> List[Tuple[str, str, int]]:
        """(protocol, hostIP, hostPort) triples with hostPort != 0
        (nodeinfo usedPorts representation, node_info.go HostPortInfo).
        Memoized (read per commit-loop recheck decision); treat the
        returned list as read-only. with_node clones carry the memo."""
        memo = self.__dict__.get("_host_ports_memo")
        if memo is not None:
            return memo
        out = []
        for c in self.containers:
            for p in c.ports:
                if p.host_port:
                    out.append((p.protocol or "TCP", p.host_ip or "0.0.0.0", p.host_port))
        self.__dict__["_host_ports_memo"] = out
        return out


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class Node:
    name: str = ""
    uid: str = field(default_factory=_new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: str = ""

    # spec
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)

    # status
    capacity: Dict[str, Quantity] = field(default_factory=dict)
    allocatable: Dict[str, Quantity] = field(default_factory=dict)
    images: List[ContainerImage] = field(default_factory=list)
    conditions: List[Dict[str, Any]] = field(default_factory=list)

    def allocatable_int(self) -> Dict[str, int]:
        """Allocatable in scheduler units (cpu -> millicores, rest -> value).
        Memoized — the oracle reads it once per feasibility check and node
        allocatable is status the informer replaces wholesale (new Node
        object), never mutates. Treat the returned dict as read-only."""
        memo = self.__dict__.get("_alloc_int_memo")
        if memo is not None:
            return memo
        out = {}
        for name, q in self.allocatable.items():
            out[name] = _request_value(name, q)
        self.__dict__["_alloc_int_memo"] = out
        return out


def _request_value(resource_name: str, q: Quantity) -> int:
    if resource_name == RESOURCE_CPU:
        return q.milli_value()
    return q.value()


@dataclass
class PodDisruptionBudget:
    """policy/v1beta1 PodDisruptionBudget. Preemption's PDB filter
    (filterPodsWithPDBViolation, core/generic_scheduler.go:1055) reads its
    namespace, selector and status.disruptionsAllowed."""

    name: str = ""
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    resource_version: str = ""
    # spec — int, or a "N%" string resolved against the expected pod count
    min_available: Optional[Any] = None
    max_unavailable: Optional[Any] = None
    # status (disruption.go updatePdbStatus)
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class PriorityClass:
    """scheduling.k8s.io/v1 PriorityClass (pkg/apis/scheduling/types.go):
    name → integer priority, which the Priority admission plugin writes into
    pod.spec.priority at create time. Cluster-scoped."""

    name: str = ""
    value: int = 0
    global_default: bool = False
    description: str = ""
    resource_version: str = ""

    def key(self) -> str:
        return self.name
