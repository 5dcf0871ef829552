"""Host-side cluster snapshot views used by the host oracle and the
tensorization layer: the port's own copy of `kubernetes_tpu.oracle.nodeinfo`.

Mirrors the role of pkg/scheduler/nodeinfo/node_info.go: a per-node aggregate
of the scheduling-relevant state (requested resources, pod list, used host
ports, pods with affinity), plus a Snapshot keyed by node name like
nodeinfo.Snapshot (pkg/scheduler/nodeinfo/snapshot.go:22).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..api.types import Node, Pod, RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_PODS

DEFAULT_BIND_ALL_HOST_IP = "0.0.0.0"

# Kubernetes zone/region label keys (v1.LabelZoneFailureDomain / LabelZoneRegion).
LABEL_ZONE_FAILURE_DOMAIN = "failure-domain.beta.kubernetes.io/zone"
LABEL_ZONE_REGION = "failure-domain.beta.kubernetes.io/region"


def get_zone_key(node: Node) -> str:
    """utilnode.GetZoneKey (pkg/util/node/node.go): region + zone combined;
    empty string when neither label is present."""
    region = node.labels.get(LABEL_ZONE_REGION, "")
    zone = node.labels.get(LABEL_ZONE_FAILURE_DOMAIN, "")
    if not region and not zone:
        return ""
    return region + ":\x00:" + zone


def pod_has_affinity_constraints(pod: Pod) -> bool:
    """nodeinfo tracks podsWithAffinity = pods with affinity OR anti-affinity
    (node_info.go AddPod -> hasPodAffinityConstraints)."""
    a = pod.affinity
    return a is not None and (a.pod_affinity is not None or a.pod_anti_affinity is not None)


@dataclass
class NodeInfo:
    """Per-node scheduling aggregate (reference: nodeinfo/node_info.go:48).

    Resource/port aggregates are maintained INCREMENTALLY like the
    reference's calculateResource add/remove path — O(1) per pod change
    instead of O(pods-on-node) per query (the query sits on the mirror
    sync and oracle hot paths). Mutate `pods` ONLY through
    add_pod/remove_pod/remove_pod_key/set_pods; writing the list directly
    desyncs the running sums."""

    node: Node
    pods: List[Pod] = field(default_factory=list)

    def __post_init__(self):
        self._recount()

    # NodeInfo is an EXTERNALLY-synchronized value object: live instances
    # are mutated only under SchedulerCache._lock (the cache is the sole
    # mutator).
    def _recount(self) -> None:
        self._aff_pods: List[Pod] = []
        self._req: Dict[str, int] = {}
        self._nz_cpu = 0
        self._nz_mem = 0
        self._ports: Dict[Tuple[str, str, int], int] = {}
        self._sigs: Optional[Dict[Tuple[str, frozenset], List]] = None
        for p in self.pods:
            self._account(p, 1)

    def _account(self, pod: Pod, sign: int) -> None:
        self._sigs = None
        # podsWithAffinity, kept incrementally as node_info.go AddPod /
        # RemovePod keep it (every removal passes the stored object)
        if pod_has_affinity_constraints(pod):
            if sign > 0:
                self._aff_pods.append(pod)
            else:
                self._aff_pods.remove(pod)
        req = self._req
        for name, v in accumulated_request(pod).items():
            nv = req.get(name, 0) + sign * v
            if nv:
                req[name] = nv
            else:
                req.pop(name, None)
        c, m = pod_non_zero_request(pod)
        self._nz_cpu += sign * c
        self._nz_mem += sign * m
        ports = self._ports
        for t in pod.host_ports():
            nv = ports.get(t, 0) + sign
            if nv:
                ports[t] = nv
            else:
                ports.pop(t, None)

    # -- mutations (keep the running aggregates in sync) ---------------------

    def add_pod(self, pod: Pod) -> None:
        self.pods.append(pod)
        self._account(pod, 1)

    def remove_pod(self, pod: Pod) -> None:
        """Remove by object identity (the victim search's simulation)."""
        self.pods.remove(pod)
        self._account(pod, -1)

    def remove_pod_key(self, key: str) -> Optional[Pod]:
        for p in self.pods:
            if p.key() == key:
                self.pods.remove(p)
                self._account(p, -1)
                return p
        return None

    def set_pods(self, pods: List[Pod]) -> None:
        self.pods = list(pods)
        self._recount()

    # -- aggregates ----------------------------------------------------------

    def pods_with_affinity(self) -> List[Pod]:
        """The node's pods with pod (anti-)affinity, in insertion order —
        a READ-ONLY view of the incrementally kept list (the mirror's
        pattern encoding reads it)."""
        return self._aff_pods

    def pod_signatures(self) -> Dict[Tuple[str, frozenset], List]:
        """The node's pods grouped by (namespace, labels) as
        {(namespace, frozenset of label items): [count, labels]}, built on
        first use after a change. Everything a spread selector reads of a
        pod is its namespace and labels, so the DoNotSchedule metadata
        counts a group with one selector match (the frozenset keys keep
        their hash). A READ-ONLY view."""
        sigs = self._sigs
        if sigs is None:
            sigs = {}
            for p in self.pods:
                k = (p.namespace, frozenset(p.labels.items()))
                e = sigs.get(k)
                if e is None:
                    sigs[k] = [1, p.labels]
                else:
                    e[0] += 1
            self._sigs = sigs
        return sigs

    def requested(self) -> Dict[str, int]:
        """RequestedResource per calculateResource (node_info.go): sum of
        container requests + overhead — NOTE: unlike the incoming pod's
        GetResourceRequest, init-container maxima are NOT included."""
        return dict(self._req)

    def non_zero_requested(self) -> Tuple[int, int]:
        """nonzeroRequest (milliCPU, memoryBytes): per container,
        max(request, default 100m / 200Mi) — priorityutil.GetNonzeroRequests;
        plus overhead when present (calculateResource, node_info.go)."""
        return self._nz_cpu, self._nz_mem

    def allowed_pod_number(self) -> int:
        """allocatable.pods (the pod-count limit preemption checks)."""
        q = self.node.allocatable.get(RESOURCE_PODS)
        return q.value() if q is not None else 0

    def used_host_ports(self) -> Set[Tuple[str, str, int]]:
        """(protocol, hostIP, hostPort) triples across pods (HostPortInfo)."""
        return set(self._ports)

    def host_port_conflict(self, pod: Pod) -> bool:
        """HostPortInfo.CheckConflict semantics (nodeinfo/host_ports.go):
        0.0.0.0 conflicts with every IP for the same (protocol, port)."""
        used = self.used_host_ports()
        for proto, ip, port in pod.host_ports():
            if port <= 0:
                continue
            if ip == DEFAULT_BIND_ALL_HOST_IP:
                if any(u_port == port and u_proto == proto for u_proto, _, u_port in used):
                    return True
            else:
                for u_proto, u_ip, u_port in used:
                    if u_port == port and u_proto == proto and u_ip in (DEFAULT_BIND_ALL_HOST_IP, ip):
                        return True
        return False

    def image_sizes(self) -> Dict[str, int]:
        """image name -> size (nodeinfo imageStates, keyed by normalized name)."""
        out: Dict[str, int] = {}
        for img in self.node.images:
            for name in img.names:
                out[normalized_image_name(name)] = img.size_bytes
        return out


# Defaults for pods with no explicit cpu/memory request, used only for
# scoring (priorityutil non_zero.go:26-29).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


def accumulated_request(pod: Pod) -> Dict[str, int]:
    """calculateResource's `res` (node_info.go): container request sums +
    overhead; init containers excluded (unlike GetResourceRequest).

    Memoized on the pod object (computed once per pod; assume + forget +
    every oracle pass re-read it). `with_node` clones carry the memo.
    Callers must treat the returned dict as read-only."""
    memo = pod.__dict__.get("_acc_req_memo")
    if memo is not None:
        return memo
    total: Dict[str, int] = {}
    for c in pod.containers:
        for name, q in c.requests.items():
            v = q.milli_value() if name == RESOURCE_CPU else q.value()
            total[name] = total.get(name, 0) + v
    for name, q in pod.overhead.items():
        v = q.milli_value() if name == RESOURCE_CPU else q.value()
        total[name] = total.get(name, 0) + v
    pod.__dict__["_acc_req_memo"] = total
    return total


def pod_non_zero_request(pod: Pod) -> Tuple[int, int]:
    """(milliCPU, memBytes) with per-container defaulting of unset requests.
    Memoized like accumulated_request."""
    memo = pod.__dict__.get("_nz_req_memo")
    if memo is not None:
        return memo
    cpu = 0
    mem = 0
    for c in pod.containers:
        q = c.requests.get(RESOURCE_CPU)
        cpu += q.milli_value() if q is not None else DEFAULT_MILLI_CPU_REQUEST
        q = c.requests.get(RESOURCE_MEMORY)
        mem += q.value() if q is not None else DEFAULT_MEMORY_REQUEST
    q = pod.overhead.get(RESOURCE_CPU)
    if q is not None:
        cpu += q.milli_value()
    q = pod.overhead.get(RESOURCE_MEMORY)
    if q is not None:
        mem += q.value()
    pod.__dict__["_nz_req_memo"] = (cpu, mem)
    return cpu, mem


def normalized_image_name(name: str) -> str:
    """parsers.ParseImageName default-tag normalization: bare names get :latest
    (pkg/util/parsers; used by image_locality.go normalizedImageName)."""
    if ":" not in name.split("/")[-1] and "@" not in name:
        return name + ":latest"
    return name


class Snapshot:
    """Cluster snapshot: node name -> NodeInfo; the oracle's equivalent of
    nodeNameToInfo maps passed through the reference algorithm."""

    def __init__(self, nodes: Optional[List[Node]] = None, pods: Optional[List[Pod]] = None):
        # externally synchronized like NodeInfo: the live snapshot mutates
        # only under SchedulerCache._lock
        self.node_infos: Dict[str, NodeInfo] = {}
        for n in nodes or []:
            self.add_node(n)
        for p in pods or []:
            if p.node_name:
                self.assign(p)

    def add_node(self, node: Node) -> NodeInfo:
        ni = NodeInfo(node=node)
        self.node_infos[node.name] = ni
        return ni

    def assign(self, pod: Pod) -> None:
        ni = self.node_infos.get(pod.node_name)
        if ni is None:
            # pods on unknown nodes are tracked nowhere in the snapshot
            # (reference keeps a headless NodeInfo; scheduling never sees it)
            return
        ni.add_pod(pod)

    def get(self, name: str) -> Optional[NodeInfo]:
        return self.node_infos.get(name)

    def nodes(self) -> List[Node]:
        return [ni.node for ni in self.node_infos.values()]

    def all_pods(self) -> List[Pod]:
        out: List[Pod] = []
        for ni in self.node_infos.values():
            out.extend(ni.pods)
        return out

    def total_image_nodes(self) -> Dict[str, int]:
        """image name -> number of nodes that have it (ImageStateSummary.NumNodes)."""
        counts: Dict[str, int] = {}
        for ni in self.node_infos.values():
            for name in ni.image_sizes():
                counts[name] = counts.get(name, 0) + 1
        return counts
