"""Scheduling-relevant API types: the port's own copy of the pod and node
model of `kubernetes_tpu.api.types` (the subset of `k8s.io/api/core/v1` the
scheduler reads), trimmed to the objects the batch solve encodes. The
constructors and fields are the reference's, so one cluster description
builds in either package. `Service` and the extender's k8s JSON wire
conversion (`pod_from_k8s`, `node_from_k8s`, `pod_to_k8s`, `node_to_k8s`)
are copied from the reference too."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .quantity import Quantity, parse_quantity

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


@dataclass
class Service:
    """core/v1 Service — the scheduling-visible subset: the label selector
    that groups pods, consumed by the ServiceAffinity custom predicate
    (predicates.go:1051) and the ServiceAntiAffinity / SelectorSpread
    priorities (selector_spreading.go)."""

    name: str = ""
    namespace: str = "default"
    selector: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=_new_uid)
    resource_version: str = ""

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# ---------------------------------------------------------------------------
# k8s JSON wire conversion (the extender/v1 wire objects)
# ---------------------------------------------------------------------------

def _qmap(d: Optional[Dict[str, str]]) -> Dict[str, Quantity]:
    return {k: parse_quantity(v) for k, v in (d or {}).items()}


def _nsr_from(d: dict) -> NodeSelectorRequirement:
    return NodeSelectorRequirement(
        key=d.get("key", ""), operator=d.get("operator", ""), values=list(d.get("values") or [])
    )


def _term_from(d: dict) -> NodeSelectorTerm:
    return NodeSelectorTerm(
        match_expressions=[_nsr_from(e) for e in d.get("matchExpressions") or []],
        match_fields=[_nsr_from(e) for e in d.get("matchFields") or []],
    )


def _label_selector_from(d: Optional[dict]) -> Optional[LabelSelector]:
    if d is None:
        return None
    return LabelSelector(
        match_labels=dict(d.get("matchLabels") or {}),
        match_expressions=[
            LabelSelectorRequirement(
                key=e.get("key", ""), operator=e.get("operator", ""), values=list(e.get("values") or [])
            )
            for e in d.get("matchExpressions") or []
        ],
    )


def _pod_affinity_term_from(d: dict) -> PodAffinityTerm:
    return PodAffinityTerm(
        label_selector=_label_selector_from(d.get("labelSelector")),
        namespaces=list(d.get("namespaces") or []),
        topology_key=d.get("topologyKey", ""),
    )


def _affinity_from(d: Optional[dict]) -> Optional[Affinity]:
    if not d:
        return None
    aff = Affinity()
    na = d.get("nodeAffinity")
    if na:
        req = na.get("requiredDuringSchedulingIgnoredDuringExecution")
        aff.node_affinity = NodeAffinity(
            required=NodeSelector([_term_from(t) for t in req.get("nodeSelectorTerms") or []])
            if req is not None
            else None,
            preferred=[
                PreferredSchedulingTerm(weight=p.get("weight", 0), preference=_term_from(p.get("preference") or {}))
                for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []
            ],
        )
    for attr, key, cls in (
        ("pod_affinity", "podAffinity", PodAffinity),
        ("pod_anti_affinity", "podAntiAffinity", PodAntiAffinity),
    ):
        pa = d.get(key)
        if pa:
            setattr(
                aff,
                attr,
                cls(
                    required=[
                        _pod_affinity_term_from(t)
                        for t in pa.get("requiredDuringSchedulingIgnoredDuringExecution") or []
                    ],
                    preferred=[
                        WeightedPodAffinityTerm(
                            weight=w.get("weight", 0),
                            pod_affinity_term=_pod_affinity_term_from(w.get("podAffinityTerm") or {}),
                        )
                        for w in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []
                    ],
                ),
            )
    return aff


def _container_from(d: dict) -> Container:
    res = d.get("resources") or {}
    return Container(
        name=d.get("name", ""),
        image=d.get("image", ""),
        ports=[
            ContainerPort(
                host_port=p.get("hostPort", 0),
                container_port=p.get("containerPort", 0),
                protocol=p.get("protocol", "TCP"),
                host_ip=p.get("hostIP", ""),
            )
            for p in d.get("ports") or []
        ],
        requests=_qmap(res.get("requests")),
        limits=_qmap(res.get("limits")),
    )


def _parse_time(v) -> Optional[float]:
    """metav1.Time: RFC3339 string -> epoch seconds (also accepts numbers)."""
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return float(v)
    import datetime

    try:
        return datetime.datetime.fromisoformat(str(v).replace("Z", "+00:00")).timestamp()
    except ValueError:
        return None


def _format_time(t: float) -> str:
    import datetime

    return (
        datetime.datetime.fromtimestamp(t, tz=datetime.timezone.utc)
        .isoformat(timespec="seconds")
        .replace("+00:00", "Z")
    )


def _volume_from(d: dict) -> Volume:
    v = Volume(name=d.get("name", ""))
    pvc = d.get("persistentVolumeClaim")
    if pvc:
        v.pvc_claim_name = pvc.get("claimName", "")
    gce = d.get("gcePersistentDisk")
    if gce:
        v.gce_pd_name = gce.get("pdName", "")
        v.gce_pd_read_only = bool(gce.get("readOnly", False))
    aws = d.get("awsElasticBlockStore")
    if aws:
        v.aws_volume_id = aws.get("volumeID", "")
        v.aws_read_only = bool(aws.get("readOnly", False))
    az = d.get("azureDisk")
    if az:
        v.azure_disk_name = az.get("diskName", "")
    rbd = d.get("rbd")
    if rbd:
        v.rbd_pool = rbd.get("pool", "rbd")
        v.rbd_image = rbd.get("image", "")
        v.rbd_monitors = tuple(rbd.get("monitors") or [])
        v.rbd_read_only = bool(rbd.get("readOnly", False))
    iscsi = d.get("iscsi")
    if iscsi:
        v.iscsi_target_portal = iscsi.get("targetPortal", "")
        v.iscsi_iqn = iscsi.get("iqn", "")
        v.iscsi_lun = int(iscsi.get("lun", 0))
        v.iscsi_read_only = bool(iscsi.get("readOnly", False))
    return v


def _volume_to(v: Volume) -> dict:
    d: Dict[str, Any] = {"name": v.name}
    if v.pvc_claim_name:
        d["persistentVolumeClaim"] = {"claimName": v.pvc_claim_name}
    if v.gce_pd_name:
        d["gcePersistentDisk"] = {"pdName": v.gce_pd_name, "readOnly": v.gce_pd_read_only}
    if v.aws_volume_id:
        d["awsElasticBlockStore"] = {"volumeID": v.aws_volume_id, "readOnly": v.aws_read_only}
    if v.azure_disk_name:
        d["azureDisk"] = {"diskName": v.azure_disk_name}
    if v.rbd_image:
        d["rbd"] = {
            "pool": v.rbd_pool,
            "image": v.rbd_image,
            "monitors": list(v.rbd_monitors),
            "readOnly": v.rbd_read_only,
        }
    if v.iscsi_iqn:
        d["iscsi"] = {
            "targetPortal": v.iscsi_target_portal,
            "iqn": v.iscsi_iqn,
            "lun": v.iscsi_lun,
            "readOnly": v.iscsi_read_only,
        }
    return d


def pod_from_k8s(obj: dict) -> Pod:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    pod = Pod(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid") or _new_uid(),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        resource_version=str(meta.get("resourceVersion", "")),
        owner_references=list(meta.get("ownerReferences") or []),
        node_name=spec.get("nodeName", ""),
        **(
            {"creation_timestamp": _parse_time(meta.get("creationTimestamp"))}
            if _parse_time(meta.get("creationTimestamp")) is not None
            else {}  # unparseable -> default_factory now() (never None)
        ),
        node_selector=dict(spec.get("nodeSelector") or {}),
        affinity=_affinity_from(spec.get("affinity")),
        tolerations=[
            Toleration(
                key=t.get("key", ""),
                operator=t.get("operator", "Equal"),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
                toleration_seconds=t.get("tolerationSeconds"),
            )
            for t in spec.get("tolerations") or []
        ],
        containers=[_container_from(c) for c in spec.get("containers") or []],
        init_containers=[_container_from(c) for c in spec.get("initContainers") or []],
        overhead=_qmap(spec.get("overhead")),
        priority=spec.get("priority"),
        priority_class_name=spec.get("priorityClassName", ""),
        topology_spread_constraints=[
            TopologySpreadConstraint(
                max_skew=c.get("maxSkew", 1),
                topology_key=c.get("topologyKey", ""),
                when_unsatisfiable=c.get("whenUnsatisfiable", DO_NOT_SCHEDULE),
                label_selector=_label_selector_from(c.get("labelSelector")),
            )
            for c in spec.get("topologySpreadConstraints") or []
        ],
        scheduler_name=spec.get("schedulerName", "default-scheduler"),
        host_network=bool(spec.get("hostNetwork", False)),
        volumes=[_volume_from(v) for v in spec.get("volumes") or []],
        phase=status.get("phase", "Pending"),
        nominated_node_name=status.get("nominatedNodeName", ""),
        conditions=list(status.get("conditions") or []),
    )
    pod.deletion_timestamp = _parse_time(meta.get("deletionTimestamp"))
    return pod


def node_from_k8s(obj: dict) -> Node:
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    return Node(
        name=meta.get("name", ""),
        uid=meta.get("uid") or _new_uid(),
        labels=dict(meta.get("labels") or {}),
        annotations=dict(meta.get("annotations") or {}),
        resource_version=str(meta.get("resourceVersion", "")),
        unschedulable=bool(spec.get("unschedulable", False)),
        taints=[
            Taint(key=t.get("key", ""), value=t.get("value", ""), effect=t.get("effect", ""))
            for t in spec.get("taints") or []
        ],
        capacity=_qmap(status.get("capacity")),
        allocatable=_qmap(status.get("allocatable")),
        images=[
            ContainerImage(names=list(i.get("names") or []), size_bytes=i.get("sizeBytes", 0))
            for i in status.get("images") or []
        ],
        conditions=list(status.get("conditions") or []),
    )


def _quantity_str(name: str, v: Quantity) -> str:
    if name == RESOURCE_CPU:
        return f"{v.milli_value()}m"
    return str(v.value())


def pod_to_k8s(pod: Pod) -> dict:
    def container_to(c: Container) -> dict:
        d: Dict[str, Any] = {"name": c.name, "image": c.image}
        if c.ports:
            d["ports"] = [
                {
                    "hostPort": p.host_port,
                    "containerPort": p.container_port,
                    "protocol": p.protocol,
                    **({"hostIP": p.host_ip} if p.host_ip else {}),
                }
                for p in c.ports
            ]
        if c.requests:
            d.setdefault("resources", {})["requests"] = {
                k: _quantity_str(k, v) for k, v in c.requests.items()
            }
        if c.limits:
            d.setdefault("resources", {})["limits"] = {k: _quantity_str(k, v) for k, v in c.limits.items()}
        return d

    spec: Dict[str, Any] = {
        "containers": [container_to(c) for c in pod.containers],
        "schedulerName": pod.scheduler_name,
    }
    if pod.init_containers:
        spec["initContainers"] = [container_to(c) for c in pod.init_containers]
    if pod.node_name:
        spec["nodeName"] = pod.node_name
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if pod.priority is not None:
        spec["priority"] = pod.priority
    if pod.priority_class_name:
        spec["priorityClassName"] = pod.priority_class_name
    if pod.overhead:
        spec["overhead"] = {k: _quantity_str(k, v) for k, v in pod.overhead.items()}
    if pod.host_network:
        spec["hostNetwork"] = True
    if pod.tolerations:
        spec["tolerations"] = [
            {
                "key": t.key, "operator": t.operator, "value": t.value,
                "effect": t.effect,
                **(
                    {"tolerationSeconds": t.toleration_seconds}
                    if t.toleration_seconds is not None
                    else {}
                ),
            }
            for t in pod.tolerations
        ]
    if pod.topology_spread_constraints:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": c.max_skew,
                "topologyKey": c.topology_key,
                "whenUnsatisfiable": c.when_unsatisfiable,
                **(
                    {"labelSelector": _label_selector_to(c.label_selector)}
                    if c.label_selector is not None
                    else {}
                ),
            }
            for c in pod.topology_spread_constraints
        ]
    if pod.affinity is not None:
        spec["affinity"] = _affinity_to(pod.affinity)
    if pod.volumes:
        spec["volumes"] = [_volume_to(v) for v in pod.volumes]
    status: Dict[str, Any] = {"phase": pod.phase}
    if pod.nominated_node_name:
        status["nominatedNodeName"] = pod.nominated_node_name
    if pod.conditions:
        status["conditions"] = list(pod.conditions)
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.uid,
            "labels": dict(pod.labels),
            "annotations": dict(pod.annotations),
            "resourceVersion": pod.resource_version,
            "creationTimestamp": _format_time(pod.creation_timestamp),
            **(
                {"deletionTimestamp": _format_time(pod.deletion_timestamp)}
                if pod.deletion_timestamp is not None
                else {}
            ),
            **({"ownerReferences": pod.owner_references} if pod.owner_references else {}),
        },
        "spec": spec,
        "status": status,
    }


def _label_selector_to(s: LabelSelector) -> dict:
    d: Dict[str, Any] = {}
    if s.match_labels:
        d["matchLabels"] = dict(s.match_labels)
    if s.match_expressions:
        d["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, "values": list(e.values)} for e in s.match_expressions
        ]
    return d


def _term_to(t: NodeSelectorTerm) -> dict:
    return {
        "matchExpressions": [
            {"key": e.key, "operator": e.operator, "values": list(e.values)} for e in t.match_expressions
        ],
        **(
            {
                "matchFields": [
                    {"key": e.key, "operator": e.operator, "values": list(e.values)}
                    for e in t.match_fields
                ]
            }
            if t.match_fields
            else {}
        ),
    }


def _affinity_to(aff: Affinity) -> dict:
    d: Dict[str, Any] = {}
    if aff.node_affinity is not None:
        na: Dict[str, Any] = {}
        if aff.node_affinity.required is not None:
            na["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [_term_to(t) for t in aff.node_affinity.required.node_selector_terms]
            }
        if aff.node_affinity.preferred:
            na["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {"weight": p.weight, "preference": _term_to(p.preference)}
                for p in aff.node_affinity.preferred
            ]
        d["nodeAffinity"] = na
    for attr, key in (("pod_affinity", "podAffinity"), ("pod_anti_affinity", "podAntiAffinity")):
        pa = getattr(aff, attr)
        if pa is not None:
            e: Dict[str, Any] = {}
            if pa.required:
                e["requiredDuringSchedulingIgnoredDuringExecution"] = [
                    {
                        "labelSelector": _label_selector_to(t.label_selector)
                        if t.label_selector is not None
                        else None,
                        "namespaces": list(t.namespaces),
                        "topologyKey": t.topology_key,
                    }
                    for t in pa.required
                ]
            if pa.preferred:
                e["preferredDuringSchedulingIgnoredDuringExecution"] = [
                    {
                        "weight": w.weight,
                        "podAffinityTerm": {
                            "labelSelector": _label_selector_to(w.pod_affinity_term.label_selector)
                            if w.pod_affinity_term.label_selector is not None
                            else None,
                            "namespaces": list(w.pod_affinity_term.namespaces),
                            "topologyKey": w.pod_affinity_term.topology_key,
                        },
                    }
                    for w in pa.preferred
                ]
            d[key] = e
    return d


def node_to_k8s(node: Node) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": node.name,
            "uid": node.uid,
            "labels": dict(node.labels),
            "annotations": dict(node.annotations),
            "resourceVersion": node.resource_version,
        },
        "spec": {
            **({"unschedulable": True} if node.unschedulable else {}),
            **(
                {
                    "taints": [
                        {"key": t.key, "value": t.value, "effect": t.effect} for t in node.taints
                    ]
                }
                if node.taints
                else {}
            ),
        },
        "status": {
            "capacity": {k: _quantity_str(k, v) for k, v in node.capacity.items()},
            "allocatable": {k: _quantity_str(k, v) for k, v in node.allocatable.items()},
            "images": [{"names": list(i.names), "sizeBytes": i.size_bytes} for i in node.images],
            "conditions": list(node.conditions),
        },
    }
