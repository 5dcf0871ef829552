"""Tensorization layer: cluster state → fixed-capacity device tensors.

The port's own copy of `kubernetes_tpu.state.tensors` (node bank, pod batch,
image table and the encoding codes), kept key-for-key identical so the two
packages encode one cluster into equal arrays. The batch replacement for the
scheduler cache snapshot
(pkg/scheduler/internal/cache/cache.go UpdateNodeInfoSnapshot, nodeinfo/
snapshot.go): instead of a map of NodeInfo structs walked per pod, cluster
state is encoded once into padded, statically-shaped integer tensors that the
vectorized Filter/Score kernels (ops/) evaluate for a whole
pod batch at once.

Encoding scheme
---------------
* Every string (label key, label value, taint key/value, namespace, node
  name, image name, protocol, host IP) is interned to a dense int32 id
  (state/interner.py); id 0 = ABSENT/padding. Matching is exact integer
  equality — no hash collisions.
* Label KEYS additionally get a dense "key slot" in [0, K): node and pod
  labels become a K-wide value-id row (`label_vals[i, slot]`), so a selector
  requirement compiles to (slot, op, value-id-set) and evaluates as a
  vectorized compare against the whole node axis. Cluster-wide distinct
  label keys are few (zone/region/hostname/app/env/...), so K stays small;
  overflow grows K to the next bucket and re-encodes.
* Numeric label values are pre-parsed into a parallel int64 plane for the
  Gt/Lt node-affinity operators (labels.Requirement ParseInt64 semantics).
* Resources get dense slots: 0=cpu(milli) 1=memory(bytes) 2=ephemeral
  3..=extended/scalar resources as first seen.
* Variable-length structures (taints, tolerations, selector terms, ports)
  are padded to per-structure capacities with a validity mask. A pod or
  node whose structures exceed capacity sets `fallback` (the filter masks
  fallback nodes out; the port's driver refuses fallback pods until the
  host oracle path is ported).

All arrays are built host-side in numpy (cheap incremental row writes) and
shipped to device per scheduling cycle; dtype discipline: int32 ids/slots,
int64 resource quantities, bool masks.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..api.types import (
    Node,
    NodeSelectorRequirement,
    Pod,
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
)
from ..oracle.nodeinfo import (
    DEFAULT_BIND_ALL_HOST_IP,
    LABEL_ZONE_FAILURE_DOMAIN,
    LABEL_ZONE_REGION,
    NodeInfo,
    Snapshot,
    accumulated_request,
    normalized_image_name,
    pod_non_zero_request,
)
from ..oracle.priorities import (
    PREFER_AVOID_PODS_ANNOTATION,
    _pod_resource_limits,
    _pod_scoring_request,
)
from .interner import ABSENT, StringInterner

# --- operator codes for compiled node-selector requirements -----------------
OP_PAD = 0
OP_IN = 1
OP_NOT_IN = 2
OP_EXISTS = 3
OP_DOES_NOT_EXIST = 4
OP_GT = 5
OP_LT = 6
OP_NAME_IN = 7  # matchFields metadata.name In
OP_NAME_NOT_IN = 8  # matchFields metadata.name NotIn
OP_NEVER = 9  # compile-time-known unsatisfiable requirement

# --- taint effects ----------------------------------------------------------
EFFECT_PAD = 0
EFFECT_NO_SCHEDULE = 1
EFFECT_PREFER_NO_SCHEDULE = 2
EFFECT_NO_EXECUTE = 3
_EFFECT_CODE = {
    TAINT_NO_SCHEDULE: EFFECT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE: EFFECT_PREFER_NO_SCHEDULE,
    TAINT_NO_EXECUTE: EFFECT_NO_EXECUTE,
}

# toleration operators
TOL_EQUAL = 0
TOL_EXISTS = 1


@dataclass
class EncodingConfig:
    """Capacities for the padded encodings. Defaults sized for scheduler_perf
    style workloads; any overflow is handled (K grows; per-pod structures set
    the fallback flag)."""

    key_slots: int = 64  # K: distinct label keys cluster-wide
    resource_slots: int = 8  # R: cpu, mem, ephemeral + extended
    node_taints: int = 8  # T per node
    pod_tolerations: int = 8  # TL per pod
    nsel_terms: int = 4  # ORed required node-selector terms per pod
    nsel_reqs: int = 6  # ANDed requirements per term
    nsel_vals: int = 8  # value set size per requirement
    pref_terms: int = 4  # preferred node-affinity terms per pod
    node_ports: int = 32  # used host ports per node
    pod_ports: int = 8  # host ports per pod
    avoid_entries: int = 2  # preferAvoidPods signatures per node
    pod_images: int = 4  # containers (images) per pod

    # resource slot indices (fixed)
    CPU: int = 0
    MEM: int = 1
    EPHEMERAL: int = 2


class Vocab:
    """Interner + dense label-key-slot and resource-slot assignment shared by
    all encoders. Ids and slots are stable for the process lifetime so
    incrementally patched tensors never need re-encoding (interner.py)."""

    def __init__(self, config: Optional[EncodingConfig] = None):
        self.config = config or EncodingConfig()
        self.strings = StringInterner()
        self.key_slot: Dict[str, int] = {}  # guarded by self._slot_lock
        # guarded by self._slot_lock
        self.resource_slot: Dict[str, int] = {
            RESOURCE_CPU: self.config.CPU,
            RESOURCE_MEMORY: self.config.MEM,
            RESOURCE_EPHEMERAL_STORAGE: self.config.EPHEMERAL,
        }
        # interned constants used by kernels
        self.wildcard_ip = self.strings.intern(DEFAULT_BIND_ALL_HOST_IP)
        self.proto_tcp = self.strings.intern("TCP")
        self._dense: Dict[int, Dict[int, int]] = {}  # guarded by self._slot_lock
        self._zone_dense: Dict[int, int] = {}  # guarded by self._slot_lock
        # slot/dense assignment is a read-modify-write (len → insert): two
        # unlocked encoders could assign two new keys the SAME slot. The
        # string interner has its own lock already.
        self._slot_lock = threading.Lock()

    def zone_dense_of(self, zone_id: int) -> int:
        with self._slot_lock:
            idx = self._zone_dense.get(zone_id)
            if idx is None:
                idx = len(self._zone_dense)
                self._zone_dense[zone_id] = idx
            return idx

    # -- label keys → dense slots -------------------------------------------
    def slot_of_key(self, key: str) -> int:
        with self._slot_lock:
            s = self.key_slot.get(key)
            if s is None:
                s = len(self.key_slot)
                if s >= self.config.key_slots:
                    # grow bucket: next power of two; callers re-encode banks
                    self.config.key_slots *= 2
                self.key_slot[key] = s
            return s

    def slot_of_resource(self, name: str) -> int:
        with self._slot_lock:
            s = self.resource_slot.get(name)
            if s is None:
                s = len(self.resource_slot)
                if s >= self.config.resource_slots:
                    self.config.resource_slots *= 2
                self.resource_slot[name] = s
            return s

    def id(self, s: str) -> int:
        return self.strings.intern(s)

    # -- per-key-slot dense value indices (topology buckets) ----------------
    # For segment_sum/gather aggregation by topology value, each (key slot,
    # value id) pair gets a dense index in [0, N_values_of_slot). Stable and
    # grow-only like everything else.
    def dense_of(self, slot: int, val_id: int) -> int:
        with self._slot_lock:
            table = self._dense.setdefault(slot, {})
            idx = table.get(val_id)
            if idx is None:
                idx = len(table)
                table[val_id] = idx
            return idx

    def dense_size(self, slot: int) -> int:
        """Distinct dense values assigned for a key slot (upper bound on its
        dense indices). The topology kernels' segment axis only needs this
        many buckets FOR TERMS ON THIS SLOT — zone-keyed terms need ~#zones
        buckets, not one per node row (ops/pipeline n_buckets)."""
        with self._slot_lock:
            return len(self._dense.get(slot, ()))

    def zone_count(self) -> int:
        with self._slot_lock:
            return len(self._zone_dense)


def _parse_int_label(v: str) -> Tuple[int, bool]:
    """labels.Requirement Gt/Lt parse: base-10 int64 or no match."""
    try:
        return int(v, 10), True
    except ValueError:
        return 0, False


def spec_key(pod, selectors=None):
    """Canonical key of everything that shapes a pod's mask/score row and
    its compiled terms (every input PodBatch.set_pod and
    terms.compile_batch_terms read, the pod's spreading selectors
    included). Pods sharing a key — every replica of a controller — share
    ONE row of the [U, N] mask/score matrices; per-pod state (priority,
    queue order) stays on the batch axis. Containers enter only through
    their derived features (requests, scoring/limit requests, host ports,
    image names); without selectors the result is memoized on the pod
    (specs are immutable; updates arrive as new objects)."""
    if selectors is None:
        memo = pod.__dict__.get("_spec_key_memo")
        if memo is not None:
            return memo
    key = (
        pod.namespace,
        tuple(sorted(pod.labels.items())),
        pod.node_name,
        tuple(sorted(pod.resource_request().items())),
        _pod_scoring_request(pod),
        _pod_resource_limits(pod),
        tuple(pod.host_ports()),
        tuple(c.image for c in pod.containers),
        repr(pod.tolerations),
        tuple(sorted(pod.node_selector.items())),
        repr(pod.affinity),
        repr(pod.topology_spread_constraints),
        repr([r for r in pod.owner_references if r.get("controller")]),
        repr(selectors) if selectors is not None else None,
    )
    if selectors is None:
        pod.__dict__["_spec_key_memo"] = key
    return key


def dedup_specs(pods, selectors: Optional[Dict[int, list]] = None) -> Tuple[list, List[int]]:
    """Collapse pods to unique specs: (reps, sig), where reps[u] is the
    first pod of spec u (in order) and sig[i] is pod i's spec row.
    `selectors` maps id(pod) to its spreading selectors (the driver's
    set_spread_selectors_fn): pods whose selectors differ never share a
    row."""
    index: Dict[tuple, int] = {}
    reps: list = []
    sig: List[int] = []
    for p in pods:
        k = spec_key(p, selectors.get(id(p)) if selectors else None)
        u = index.get(k)
        if u is None:
            u = index[k] = len(reps)
            reps.append(p)
        sig.append(u)
    return reps, sig


def _req_slot_pairs(vocab: "Vocab", pod) -> Tuple[Tuple[int, int], ...]:
    """accumulated_request as ((resource slot, value), ...) pairs, memoized
    on the pod (resource slots are grow-only and process-stable per Vocab,
    so cached slots never go stale; the memo is tagged with its vocab for
    test isolation). with_node clones carry it."""
    memo = pod.__dict__.get("_req_slot_memo")
    if memo is not None and memo[0] is vocab:
        return memo[1]
    pairs = tuple(
        (vocab.slot_of_resource(name), v)
        for name, v in accumulated_request(pod).items()
        if name != RESOURCE_PODS
    )
    pod.__dict__["_req_slot_memo"] = (vocab, pairs)
    return pairs


# ---------------------------------------------------------------------------
# Node bank
# ---------------------------------------------------------------------------

@dataclass
class NodeBank:
    """Padded per-node tensors, capacity N (= _node_bucket ≥ cluster size:
    power of two up to 2048, multiple of 2048 above). The device-side
    mirror of the scheduler cache's NodeInfo list."""

    vocab: Vocab
    capacity: int

    valid: np.ndarray = None  # [N] bool
    fallback: np.ndarray = None  # [N] bool: structures truncated; device path
    # must treat the node conservatively (excluded from fast-path placement)
    name_id: np.ndarray = None  # [N] int32
    alloc: np.ndarray = None  # [N, R] int64 (slot 〈pods〉 kept separately)
    requested: np.ndarray = None  # [N, R] int64 accumulated (calculateResource)
    nonzero_req: np.ndarray = None  # [N, 2] int64 (cpu milli, mem bytes) for scoring
    allowed_pods: np.ndarray = None  # [N] int32
    pod_count: np.ndarray = None  # [N] int32
    label_vals: np.ndarray = None  # [N, K] int32 value id (ABSENT=0)
    label_num: np.ndarray = None  # [N, K] int64 parsed numeric value
    label_num_ok: np.ndarray = None  # [N, K] bool
    taint_key: np.ndarray = None  # [N, T] int32
    taint_val: np.ndarray = None  # [N, T] int32
    taint_effect: np.ndarray = None  # [N, T] int32 (EFFECT_*)
    unschedulable: np.ndarray = None  # [N] bool
    port_proto: np.ndarray = None  # [N, P] int32
    port_ip: np.ndarray = None  # [N, P] int32
    port_num: np.ndarray = None  # [N, P] int32 (0 = pad)
    label_dense: np.ndarray = None  # [N, K] int32 dense topo bucket (-1 absent)
    zone_id: np.ndarray = None  # [N] int32 (GetZoneKey interned, 0 = none)
    zone_dense: np.ndarray = None  # [N] int32 dense zone bucket (-1 none)
    avoid_kind: np.ndarray = None  # [N, AV] int32 (1=RC, 2=RS)
    avoid_uid: np.ndarray = None  # [N, AV] int32
    image_scaled: np.ndarray = None  # [N, V_img] int64, see ImageTable

    def __post_init__(self):
        c = self.vocab.config
        self.key_capacity = c.key_slots  # array width; vocab may grow later
        n = self.capacity
        self.valid = np.zeros(n, bool)
        self.fallback = np.zeros(n, bool)
        self.name_id = np.zeros(n, np.int32)
        self.alloc = np.zeros((n, c.resource_slots), np.int64)
        self.requested = np.zeros((n, c.resource_slots), np.int64)
        self.nonzero_req = np.zeros((n, 2), np.int64)
        self.allowed_pods = np.zeros(n, np.int32)
        self.pod_count = np.zeros(n, np.int32)
        self.label_vals = np.zeros((n, c.key_slots), np.int32)
        self.label_num = np.zeros((n, c.key_slots), np.int64)
        self.label_num_ok = np.zeros((n, c.key_slots), bool)
        self.taint_key = np.zeros((n, c.node_taints), np.int32)
        self.taint_val = np.zeros((n, c.node_taints), np.int32)
        self.taint_effect = np.zeros((n, c.node_taints), np.int32)
        self.unschedulable = np.zeros(n, bool)
        self.port_proto = np.zeros((n, c.node_ports), np.int32)
        self.port_ip = np.zeros((n, c.node_ports), np.int32)
        self.port_num = np.zeros((n, c.node_ports), np.int32)
        self.label_dense = np.full((n, c.key_slots), -1, np.int32)
        self.zone_id = np.zeros(n, np.int32)
        self.zone_dense = np.full(n, -1, np.int32)
        self.avoid_kind = np.zeros((n, c.avoid_entries), np.int32)
        self.avoid_uid = np.zeros((n, c.avoid_entries), np.int32)
        self.image_scaled = None  # set by ImageTable.apply

    def set_node(self, i: int, ni: NodeInfo) -> None:
        """Encode one NodeInfo into row i (the patch path: called per dirty
        node, mirroring UpdateNodeInfoSnapshot's generation walk)."""
        v = self.vocab
        c = v.config
        node = ni.node
        self.valid[i] = True
        overflow = False
        self.name_id[i] = v.id(node.name)
        # resources
        self.alloc[i] = 0
        for name, amount in node.allocatable_int().items():
            if name == RESOURCE_PODS:
                self.allowed_pods[i] = amount
            else:
                s = v.slot_of_resource(name)
                if s >= self.alloc.shape[1]:
                    raise KeySlotOverflow()
                self.alloc[i, s] = amount
        self.requested[i] = 0
        for name, amount in ni.requested().items():
            if name != RESOURCE_PODS:
                s = v.slot_of_resource(name)
                if s >= self.requested.shape[1]:
                    raise KeySlotOverflow()
                self.requested[i, s] = amount
        nz_cpu, nz_mem = ni.non_zero_requested()
        self.nonzero_req[i, 0] = nz_cpu
        self.nonzero_req[i, 1] = nz_mem
        self.pod_count[i] = len(ni.pods)
        # labels
        self.label_vals[i] = ABSENT
        self.label_num_ok[i] = False
        self.label_dense[i] = -1
        for k, val in node.labels.items():
            s = v.slot_of_key(k)
            if s >= self.key_capacity:
                raise KeySlotOverflow()
            vid = v.id(val)
            self.label_vals[i, s] = vid
            self.label_dense[i, s] = v.dense_of(s, vid)
            num, ok = _parse_int_label(val)
            self.label_num[i, s] = num
            self.label_num_ok[i, s] = ok
        # taints
        self.taint_key[i] = 0
        self.taint_val[i] = 0
        self.taint_effect[i] = EFFECT_PAD
        if len(node.taints) > c.node_taints:
            overflow = True
        for t_idx, taint in enumerate(node.taints[: c.node_taints]):
            self.taint_key[i, t_idx] = v.id(taint.key)
            self.taint_val[i, t_idx] = v.id(taint.value)
            self.taint_effect[i, t_idx] = _EFFECT_CODE.get(taint.effect, EFFECT_PAD)
        self.unschedulable[i] = node.unschedulable
        # used host ports
        self.port_proto[i] = 0
        self.port_ip[i] = 0
        self.port_num[i] = 0
        used_ports = sorted(ni.used_host_ports())
        if len(used_ports) > c.node_ports:
            overflow = True
        for p_idx, (proto, ip, port) in enumerate(used_ports[: c.node_ports]):
            self.port_proto[i, p_idx] = v.id(proto)
            self.port_ip[i, p_idx] = v.id(ip)
            self.port_num[i, p_idx] = port
        # zone
        zone_key = _zone_key(node.labels)
        self.zone_id[i] = v.id(zone_key) if zone_key else ABSENT
        self.zone_dense[i] = v.zone_dense_of(self.zone_id[i]) if zone_key else -1
        # preferAvoidPods
        self.avoid_kind[i] = 0
        self.avoid_uid[i] = 0
        sigs = _avoid_signatures(node)
        if len(sigs) > c.avoid_entries:
            overflow = True
        for a_idx, (kind, uid) in enumerate(sigs[: c.avoid_entries]):
            self.avoid_kind[i, a_idx] = kind
            self.avoid_uid[i, a_idx] = v.id(uid)
        self.fallback[i] = overflow

    def clear_node(self, i: int) -> None:
        self.valid[i] = False
        self.pod_count[i] = 0
        # un-latch the conservative flags: a stale True on an invalid row
        # would force the driver's O(nodes) oracle fallback forever
        self.fallback[i] = False

    def apply_pod_delta(self, i: int, pod, sign: int) -> None:
        """Increment the pod-driven usage columns by one pod's request
        vector (the mirror's delta path) — numerically identical to the
        snapshot refresh because NodeInfo's own accounting added the exact
        same memoized values. Ports are NOT handled here (list-shaped —
        the caller snapshot-refreshes ported nodes)."""
        for rname, v in accumulated_request(pod).items():
            if rname != RESOURCE_PODS:
                s = self.vocab.slot_of_resource(rname)
                if s >= self.requested.shape[1]:
                    raise KeySlotOverflow()
                self.requested[i, s] += sign * v
        c, m = pod_non_zero_request(pod)
        self.nonzero_req[i, 0] += sign * c
        self.nonzero_req[i, 1] += sign * m
        self.pod_count[i] += sign

    def apply_pod_deltas_bulk(self, rows: np.ndarray, pods: Sequence) -> None:
        """apply_pod_delta over a whole commit batch of ADDS as three
        np.add.at scatters (duplicate rows accumulate): the same memoized
        request values land in the same columns as the scalar path."""
        n = len(pods)
        width = self.requested.shape[1]
        mat = np.zeros((n, width), np.int64)
        nz = np.zeros((n, 2), np.int64)
        for i, pod in enumerate(pods):
            for s, v in _req_slot_pairs(self.vocab, pod):
                if s >= width:
                    raise KeySlotOverflow()
                mat[i, s] = v
            c, m = pod_non_zero_request(pod)
            nz[i, 0] = c
            nz[i, 1] = m
        np.add.at(self.requested, rows, mat)
        np.add.at(self.nonzero_req, rows, nz)
        np.add.at(self.pod_count, rows, 1)

    def update_usage(self, i: int, ni: NodeInfo) -> bool:
        """Refresh ONLY the pod-driven columns (requested/non-zero/pod
        count/used ports) — the single-pod delta path. Node identity
        (labels, taints, zone, avoid signatures) is untouched. Returns
        False when the caller must fall back to a full set_node (port
        table overflow changes the fallback flag)."""
        c = self.vocab.config
        used_ports = sorted(ni.used_host_ports())
        if len(used_ports) > c.node_ports or self.fallback[i]:
            return False
        self.requested[i] = 0
        for name, amount in ni.requested().items():
            if name != RESOURCE_PODS:
                s = self.vocab.slot_of_resource(name)
                if s >= self.requested.shape[1]:
                    raise KeySlotOverflow()
                self.requested[i, s] = amount
        nz_cpu, nz_mem = ni.non_zero_requested()
        self.nonzero_req[i, 0] = nz_cpu
        self.nonzero_req[i, 1] = nz_mem
        self.pod_count[i] = len(ni.pods)
        self.port_proto[i] = 0
        self.port_ip[i] = 0
        self.port_num[i] = 0
        for p_idx, (proto, ip, port) in enumerate(used_ports):
            self.port_proto[i, p_idx] = self.vocab.id(proto)
            self.port_ip[i, p_idx] = self.vocab.id(ip)
            self.port_num[i, p_idx] = port
        return True

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {
            "valid": self.valid,
            "fallback": self.fallback,
            "name_id": self.name_id,
            "alloc": self.alloc,
            "requested": self.requested,
            "nonzero_req": self.nonzero_req,
            "allowed_pods": self.allowed_pods,
            "pod_count": self.pod_count,
            "label_vals": self.label_vals,
            "label_num": self.label_num,
            "label_num_ok": self.label_num_ok,
            "taint_key": self.taint_key,
            "taint_val": self.taint_val,
            "taint_effect": self.taint_effect,
            "unschedulable": self.unschedulable,
            "port_proto": self.port_proto,
            "port_ip": self.port_ip,
            "port_num": self.port_num,
            "label_dense": self.label_dense,
            "zone_id": self.zone_id,
            "zone_dense": self.zone_dense,
            "avoid_kind": self.avoid_kind,
            "avoid_uid": self.avoid_uid,
        }
        if self.image_scaled is not None:
            out["image_scaled"] = self.image_scaled
        return out


class KeySlotOverflow(Exception):
    """Raised when a label key or resource name lands beyond the current
    bank's array width — the caller rebuilds banks at the grown capacity
    (Vocab already bumped config). Also used for resource-slot overflow."""


def _zone_key(labels: Dict[str, str]) -> str:
    region = labels.get(LABEL_ZONE_REGION, "")
    zone = labels.get(LABEL_ZONE_FAILURE_DOMAIN, "")
    if not region and not zone:
        return ""
    return region + ":\x00:" + zone


def _avoid_signatures(node: Node) -> List[Tuple[int, str]]:
    """Parse the preferAvoidPods annotation into (kind_code, uid) pairs;
    malformed JSON → empty (GetAvoidPodsFromNodeAnnotations error path)."""
    ann = node.annotations.get(PREFER_AVOID_PODS_ANNOTATION, "")
    if not ann:
        return []
    try:
        avoids = json.loads(ann)
    except ValueError:
        return []
    if not isinstance(avoids, dict):
        return []
    entries = avoids.get("preferAvoidPods")
    if not isinstance(entries, list):
        return []
    out = []
    for avoid in entries:
        if not isinstance(avoid, dict):
            continue
        sig = avoid.get("podSignature")
        ref = (sig.get("podController") if isinstance(sig, dict) else None) or {}
        kind = {"ReplicationController": 1, "ReplicaSet": 2}.get(ref.get("kind"), 0)
        if kind and ref.get("uid"):
            out.append((kind, str(ref.get("uid"))))
    return out


class ImageTable:
    """Dense image-id → spread-scaled size table (image_locality.go
    scaledImageScore): scaled = int(size * numNodesWithImage / totalNodes),
    precomputed host-side per image so the kernel is a pure gather."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def apply(
        self, bank: NodeBank, snapshot: Snapshot, row_of: Optional[Dict[str, int]] = None
    ) -> None:
        """row_of maps node name → bank row; defaults to snapshot enumeration
        order (the encode_snapshot layout)."""
        v = self.vocab
        if row_of is None:
            row_of = {ni.node.name: i for i, ni in enumerate(snapshot.node_infos.values())}
        node_counts = snapshot.total_image_nodes()
        total_nodes = len(snapshot.node_infos)
        # image vocabulary = every image name seen on any node
        max_id = 0
        for ni in snapshot.node_infos.values():
            for name in ni.image_sizes():
                max_id = max(max_id, v.id(name))
        # bucketed width → stable kernel shapes across snapshots
        table = np.zeros((bank.capacity, _bucket(max_id + 1, 64)), np.int64)
        for ni in snapshot.node_infos.values():
            idx = row_of.get(ni.node.name)
            if idx is None:
                continue
            for name, size in ni.image_sizes().items():
                spread = node_counts.get(name, 0) / total_nodes if total_nodes else 0.0
                table[idx, v.id(name)] = int(size * spread)
        bank.image_scaled = table


# ---------------------------------------------------------------------------
# Pod batch
# ---------------------------------------------------------------------------

@dataclass
class PodBatch:
    """Padded encoding of a batch of PENDING pods, capacity B."""

    vocab: Vocab
    capacity: int

    valid: np.ndarray = None  # [B]
    fallback: np.ndarray = None  # [B] structures overflowed; use oracle path
    label_vals: np.ndarray = None  # [B, K] int32 (pod labels, for symmetric matching)
    req: np.ndarray = None  # [B, R] int64 (GetResourceRequest: incl. init max)
    req_any: np.ndarray = None  # [B] bool: pod requests anything at all
    scoring_req: np.ndarray = None  # [B, 2] int64 (calculatePodResourceRequest)
    limit_req: np.ndarray = None  # [B, 2] int64 (getResourceLimits: cpu milli, mem bytes)
    priority: np.ndarray = None  # [B] int32
    node_name_id: np.ndarray = None  # [B] int32 spec.nodeName pin (0 = none)
    ns_id: np.ndarray = None  # [B] int32
    tol_key: np.ndarray = None  # [B, TL] int32 (0 = match-all-keys)
    tol_op: np.ndarray = None  # [B, TL] int32 TOL_*
    tol_val: np.ndarray = None  # [B, TL] int32
    tol_effect: np.ndarray = None  # [B, TL] int32 (0 = match-all-effects)
    tol_valid: np.ndarray = None  # [B, TL] bool
    nsel_key: np.ndarray = None  # [B, NS_pairs…] — nodeSelector map pairs
    # compiled required terms (nodeSelector map folded in as term-0 prefix is
    # NOT possible since map is ANDed with ORed terms; kept separate):
    sel_pair_slot: np.ndarray = None  # [B, NSP] int32 key slot (-1 pad)
    sel_pair_val: np.ndarray = None  # [B, NSP] int32
    has_required: np.ndarray = None  # [B] bool: affinity.required != nil
    term_valid: np.ndarray = None  # [B, TERMS] bool
    term_req_op: np.ndarray = None  # [B, TERMS, REQS] int32 OP_*
    term_req_slot: np.ndarray = None  # [B, TERMS, REQS] int32 (-1 = unknown key)
    term_req_vals: np.ndarray = None  # [B, TERMS, REQS, VALS] int32 (-1 pad)
    term_req_num: np.ndarray = None  # [B, TERMS, REQS] int64 Gt/Lt operand
    # preferred node-affinity terms for scoring
    pref_valid: np.ndarray = None  # [B, PT] bool
    pref_weight: np.ndarray = None  # [B, PT] int32
    pref_req_op: np.ndarray = None  # [B, PT, REQS] int32
    pref_req_slot: np.ndarray = None  # [B, PT, REQS] int32
    pref_req_vals: np.ndarray = None  # [B, PT, REQS, VALS] int32
    pref_req_num: np.ndarray = None  # [B, PT, REQS] int64
    # host ports
    port_proto: np.ndarray = None  # [B, PP] int32
    port_ip: np.ndarray = None  # [B, PP] int32
    port_num: np.ndarray = None  # [B, PP] int32 (0 pad)
    # tolerations restricted to PreferNoSchedule scoring set are derivable on
    # device (effect in {0, PREFER}) — no extra arrays needed.
    # images
    image_ids: np.ndarray = None  # [B, CI] int32 (0 pad)
    # preferAvoidPods controller signature
    ctrl_kind: np.ndarray = None  # [B] int32 (0 none, 1 RC, 2 RS)
    ctrl_uid: np.ndarray = None  # [B] int32

    def __post_init__(self):
        c = self.vocab.config
        self.key_capacity = c.key_slots
        b = self.capacity
        self.valid = np.zeros(b, bool)
        self.fallback = np.zeros(b, bool)
        self.label_vals = np.zeros((b, c.key_slots), np.int32)
        self.req = np.zeros((b, c.resource_slots), np.int64)
        self.req_any = np.zeros(b, bool)
        self.scoring_req = np.zeros((b, 2), np.int64)
        self.limit_req = np.zeros((b, 2), np.int64)  # getResourceLimits (cpu milli, mem bytes)
        self.priority = np.zeros(b, np.int32)
        self.node_name_id = np.zeros(b, np.int32)
        self.ns_id = np.zeros(b, np.int32)
        self.tol_key = np.zeros((b, c.pod_tolerations), np.int32)
        self.tol_op = np.zeros((b, c.pod_tolerations), np.int32)
        self.tol_val = np.zeros((b, c.pod_tolerations), np.int32)
        self.tol_effect = np.zeros((b, c.pod_tolerations), np.int32)
        self.tol_valid = np.zeros((b, c.pod_tolerations), bool)
        nsp = c.nsel_reqs  # nodeSelector map pair capacity
        self.sel_pair_slot = np.full((b, nsp), -1, np.int32)
        self.sel_pair_val = np.zeros((b, nsp), np.int32)
        self.has_required = np.zeros(b, bool)
        self.term_valid = np.zeros((b, c.nsel_terms), bool)
        self.term_req_op = np.zeros((b, c.nsel_terms, c.nsel_reqs), np.int32)
        self.term_req_slot = np.full((b, c.nsel_terms, c.nsel_reqs), -1, np.int32)
        self.term_req_vals = np.full((b, c.nsel_terms, c.nsel_reqs, c.nsel_vals), -1, np.int32)
        self.term_req_num = np.zeros((b, c.nsel_terms, c.nsel_reqs), np.int64)
        self.pref_valid = np.zeros((b, c.pref_terms), bool)
        self.pref_weight = np.zeros((b, c.pref_terms), np.int32)
        self.pref_req_op = np.zeros((b, c.pref_terms, c.nsel_reqs), np.int32)
        self.pref_req_slot = np.full((b, c.pref_terms, c.nsel_reqs), -1, np.int32)
        self.pref_req_vals = np.full((b, c.pref_terms, c.nsel_reqs, c.nsel_vals), -1, np.int32)
        self.pref_req_num = np.zeros((b, c.pref_terms, c.nsel_reqs), np.int64)
        self.port_proto = np.zeros((b, c.pod_ports), np.int32)
        self.port_ip = np.zeros((b, c.pod_ports), np.int32)
        self.port_num = np.zeros((b, c.pod_ports), np.int32)
        self.image_ids = np.zeros((b, c.pod_images), np.int32)
        self.ctrl_kind = np.zeros(b, np.int32)
        self.ctrl_uid = np.zeros(b, np.int32)

    # -- encoding ------------------------------------------------------------

    def _encode_requirement(self, req: NodeSelectorRequirement, is_field: bool):
        """Compile one requirement → (op, slot, vals, num) tuple."""
        v = self.vocab
        c = v.config
        op_map = {
            "In": OP_IN,
            "NotIn": OP_NOT_IN,
            "Exists": OP_EXISTS,
            "DoesNotExist": OP_DOES_NOT_EXIST,
            "Gt": OP_GT,
            "Lt": OP_LT,
        }
        vals = [-1] * c.nsel_vals
        num = 0
        if is_field:
            # only metadata.name In/NotIn with exactly 1 value is convertible
            # (NodeSelectorRequirementsAsFieldSelector); anything else makes
            # the term match nothing.
            if req.key != "metadata.name" or req.operator not in ("In", "NotIn") or len(req.values) != 1:
                return OP_NEVER, -1, vals, num, False
            op = OP_NAME_IN if req.operator == "In" else OP_NAME_NOT_IN
            vals[0] = v.id(req.values[0])
            return op, -1, vals, num, False
        op = op_map.get(req.operator)
        if op is None:
            return OP_NEVER, -1, vals, num, False
        slot = v.slot_of_key(req.key)
        overflow = False
        if op in (OP_IN, OP_NOT_IN):
            if len(req.values) > c.nsel_vals:
                overflow = True
            for j, s in enumerate(req.values[: c.nsel_vals]):
                vals[j] = v.id(s)
        elif op in (OP_GT, OP_LT):
            if len(req.values) != 1:
                return OP_NEVER, slot, vals, num, False
            n, ok = _parse_int_label(req.values[0])
            if not ok:
                return OP_NEVER, slot, vals, num, False
            num = n
        return op, slot, vals, num, overflow

    def set_pod(self, b: int, pod: Pod) -> None:
        v = self.vocab
        c = v.config
        overflow = False
        self.valid[b] = True
        self.label_vals[b] = ABSENT
        for k, val in pod.labels.items():
            s = v.slot_of_key(k)
            if s >= self.key_capacity:
                raise KeySlotOverflow()
            self.label_vals[b, s] = v.id(val)
        # resources
        self.req[b] = 0
        any_req = False
        for name, amount in pod.resource_request().items():
            if name == RESOURCE_PODS:
                continue
            if amount != 0:
                any_req = True
            s = v.slot_of_resource(name)
            if s >= self.req.shape[1]:
                raise KeySlotOverflow()
            self.req[b, s] = amount
        self.req_any[b] = any_req
        s_cpu, s_mem = _pod_scoring_request(pod)
        self.scoring_req[b, 0] = s_cpu
        self.scoring_req[b, 1] = s_mem
        l_cpu, l_mem = _pod_resource_limits(pod)
        self.limit_req[b, 0] = l_cpu
        self.limit_req[b, 1] = l_mem
        self.priority[b] = pod.get_priority()
        self.node_name_id[b] = v.id(pod.node_name) if pod.node_name else 0
        self.ns_id[b] = v.id(pod.namespace)
        # tolerations
        self.tol_valid[b] = False
        if len(pod.tolerations) > c.pod_tolerations:
            overflow = True
        for t_idx, tol in enumerate(pod.tolerations[: c.pod_tolerations]):
            self.tol_key[b, t_idx] = v.id(tol.key) if tol.key else 0
            self.tol_op[b, t_idx] = TOL_EXISTS if tol.operator == "Exists" else TOL_EQUAL
            self.tol_val[b, t_idx] = v.id(tol.value) if tol.value else v.id("")
            self.tol_effect[b, t_idx] = _EFFECT_CODE.get(tol.effect, 0) if tol.effect else 0
            self.tol_valid[b, t_idx] = True
        # nodeSelector map (ANDed pairs)
        self.sel_pair_slot[b] = -1
        pairs = list(pod.node_selector.items())
        if len(pairs) > self.sel_pair_slot.shape[1]:
            overflow = True
        for j, (k, val) in enumerate(pairs[: self.sel_pair_slot.shape[1]]):
            s = v.slot_of_key(k)
            if s >= self.key_capacity:
                raise KeySlotOverflow()
            self.sel_pair_slot[b, j] = s
            self.sel_pair_val[b, j] = v.id(val)
        # required node affinity
        self.has_required[b] = False
        self.term_valid[b] = False
        self.term_req_op[b] = OP_PAD
        aff = pod.affinity
        na = aff.node_affinity if aff is not None else None
        if na is not None and na.required is not None:
            self.has_required[b] = True
            terms = na.required.node_selector_terms
            if len(terms) > c.nsel_terms:
                overflow = True
            for t_idx, term in enumerate(terms[: c.nsel_terms]):
                reqs = [(r, False) for r in term.match_expressions] + [
                    (r, True) for r in term.match_fields
                ]
                if not reqs:
                    continue  # empty term matches nothing → leave invalid
                self.term_valid[b, t_idx] = True
                if len(reqs) > c.nsel_reqs:
                    overflow = True
                for r_idx, (r, is_field) in enumerate(reqs[: c.nsel_reqs]):
                    op, slot, vals, num, ovf = self._encode_requirement(r, is_field)
                    overflow = overflow or ovf
                    if slot >= self.key_capacity:
                        raise KeySlotOverflow()
                    self.term_req_op[b, t_idx, r_idx] = op
                    self.term_req_slot[b, t_idx, r_idx] = slot
                    self.term_req_vals[b, t_idx, r_idx] = vals
                    self.term_req_num[b, t_idx, r_idx] = num
        # preferred node affinity
        self.pref_valid[b] = False
        self.pref_req_op[b] = OP_PAD
        if na is not None and na.preferred:
            prefs = na.preferred
            if len(prefs) > c.pref_terms:
                overflow = True
            for t_idx, pref in enumerate(prefs[: c.pref_terms]):
                if pref.weight == 0:
                    continue
                self.pref_valid[b, t_idx] = True
                self.pref_weight[b, t_idx] = pref.weight
                reqs = pref.preference.match_expressions
                if len(reqs) > c.nsel_reqs:
                    overflow = True
                for r_idx, r in enumerate(reqs[: c.nsel_reqs]):
                    op, slot, vals, num, ovf = self._encode_requirement(r, False)
                    overflow = overflow or ovf
                    if slot >= self.key_capacity:
                        raise KeySlotOverflow()
                    self.pref_req_op[b, t_idx, r_idx] = op
                    self.pref_req_slot[b, t_idx, r_idx] = slot
                    self.pref_req_vals[b, t_idx, r_idx] = vals
                    self.pref_req_num[b, t_idx, r_idx] = num
        # host ports
        self.port_num[b] = 0
        ports = pod.host_ports()
        if len(ports) > c.pod_ports:
            overflow = True
        for p_idx, (proto, ip, port) in enumerate(ports[: c.pod_ports]):
            self.port_proto[b, p_idx] = v.id(proto)
            self.port_ip[b, p_idx] = v.id(ip)
            self.port_num[b, p_idx] = port
        # images
        self.image_ids[b] = 0
        if len(pod.containers) > c.pod_images:
            overflow = True
        for i_idx, cont in enumerate(pod.containers[: c.pod_images]):
            if cont.image:
                self.image_ids[b, i_idx] = v.strings.lookup(normalized_image_name(cont.image))
        # controller signature
        self.ctrl_kind[b] = 0
        self.ctrl_uid[b] = 0
        for ref in pod.owner_references:
            if ref.get("controller"):
                kind = {"ReplicationController": 1, "ReplicaSet": 2}.get(ref.get("kind"), 0)
                if kind:
                    self.ctrl_kind[b] = kind
                    self.ctrl_uid[b] = v.id(str(ref.get("uid", "")))
                break
        self.fallback[b] = overflow

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "valid": self.valid,
            "fallback": self.fallback,
            "label_vals": self.label_vals,
            "req": self.req,
            "req_any": self.req_any,
            "scoring_req": self.scoring_req,
            "limit_req": self.limit_req,
            "priority": self.priority,
            "node_name_id": self.node_name_id,
            "ns_id": self.ns_id,
            "tol_key": self.tol_key,
            "tol_op": self.tol_op,
            "tol_val": self.tol_val,
            "tol_effect": self.tol_effect,
            "tol_valid": self.tol_valid,
            "sel_pair_slot": self.sel_pair_slot,
            "sel_pair_val": self.sel_pair_val,
            "has_required": self.has_required,
            "term_valid": self.term_valid,
            "term_req_op": self.term_req_op,
            "term_req_slot": self.term_req_slot,
            "term_req_vals": self.term_req_vals,
            "term_req_num": self.term_req_num,
            "pref_valid": self.pref_valid,
            "pref_weight": self.pref_weight,
            "pref_req_op": self.pref_req_op,
            "pref_req_slot": self.pref_req_slot,
            "pref_req_vals": self.pref_req_vals,
            "pref_req_num": self.pref_req_num,
            "port_proto": self.port_proto,
            "port_ip": self.port_ip,
            "port_num": self.port_num,
            "image_ids": self.image_ids,
            "ctrl_kind": self.ctrl_kind,
            "ctrl_uid": self.ctrl_uid,
        }


def pow2_bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two capacity ≥ n (the reference's shape ladder,
    compile/ladder.py, so both packages pick the same padded shapes)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def node_axis_bucket(n: int, minimum: int = 16) -> int:
    """Node-axis capacity: power of two up to 2048, then the next multiple
    of 2048 (padding waste stays under 20% at large clusters)."""
    if n <= 2048:
        return pow2_bucket(n, minimum)
    return -(-n // 2048) * 2048


_bucket = pow2_bucket
_node_bucket = node_axis_bucket


class SigOverflow(KeySlotOverflow):
    """Signature bank out of slots — rebuild at the next bucket size."""


@dataclass
class SigBank:
    """Existing pods collapsed to LABEL SIGNATURES with per-node counts.

    Every device consumer of existing pods (the topology kernels) matches
    terms against a pod's (namespace, labels, deleting) and then counts
    matches per node — the pod's identity never matters. Distinct (ns,
    labels, deleting) combinations number in the hundreds even in
    100k-pod clusters, so matching runs against S signature rows instead
    of M pod rows, and the per-node counts become one [TT, S] x [S, N]
    product.

    Arrays:
      valid [S], ns_id [S], label_vals [S, K], deleting [S] — signature
      metadata, patched by dirty SIGNATURE rows;
      counts [N_cap, S] int16 — pods per (node, signature), node-major so
      the mirror patches it with dirty NODE rows.

    The slab bookkeeping is confined to the driver thread (the mirror's
    contract: sync and rebuild run there).
    """

    vocab: Vocab
    capacity: int  # S
    node_capacity: int  # N rows of the counts matrix

    valid: np.ndarray = None  # [S]
    ns_id: np.ndarray = None  # [S] int32
    label_vals: np.ndarray = None  # [S, K] int32
    deleting: np.ndarray = None  # [S] bool
    counts: np.ndarray = None  # [N, S] int16

    def __post_init__(self):
        c = self.vocab.config
        self.key_capacity = c.key_slots
        s = self.capacity
        self.valid = np.zeros(s, bool)
        self.ns_id = np.zeros(s, np.int32)
        self.label_vals = np.zeros((s, c.key_slots), np.int32)
        self.deleting = np.zeros(s, bool)
        self.counts = np.zeros((self.node_capacity, s), np.int16)
        self._sig_of: Dict[bytes, int] = {}
        self._key_of_row: Dict[int, bytes] = {}
        self._encode_cache: Dict[tuple, Tuple[bytes, np.ndarray, int, bool]] = {}
        self._refs = np.zeros(s, np.int64)
        self._free = list(range(s - 1, -1, -1))
        self.dirty_sig_rows: Set[int] = set()

    def _encode_key(self, pod) -> Tuple[bytes, np.ndarray, int, bool]:
        """(key bytes, label row, namespace id, deleting) of a pod. Memoized
        on the pod object (tagged by vocab and slot width, so a rebuild
        reuses it but a grown key space does not) and by label content:
        replicas share label sets, so a 4,096-pod batch needs ~#specs real
        encodes. Safe because Vocab ids and slots are grow-only."""
        obj_memo = pod.__dict__.get("_sig_enc_memo")
        if obj_memo is not None and obj_memo[0] is self.vocab and obj_memo[1] == self.key_capacity:
            return obj_memo[2]
        lk = (tuple(sorted(pod.labels.items())), pod.namespace, pod.deletion_timestamp is not None)
        hit = self._encode_cache.get(lk)
        if hit is not None:
            pod.__dict__["_sig_enc_memo"] = (self.vocab, self.key_capacity, hit)
            return hit
        v = self.vocab
        row = np.zeros(self.key_capacity, np.int32)
        row[:] = ABSENT
        for k, val in pod.labels.items():
            s = v.slot_of_key(k)
            if s >= self.key_capacity:
                raise KeySlotOverflow()
            row[s] = v.id(val)
        ns = v.id(pod.namespace)
        deleting = pod.deletion_timestamp is not None
        key = row.tobytes() + ns.to_bytes(4, "little") + bytes([deleting])
        if len(self._encode_cache) > 8192:
            self._encode_cache.clear()
        out = (key, row, ns, deleting)
        self._encode_cache[lk] = out
        pod.__dict__["_sig_enc_memo"] = (self.vocab, self.key_capacity, out)
        return out

    def _intern(self, pod) -> int:
        key, row, ns, deleting = self._encode_key(pod)
        sig = self._sig_of.get(key)
        if sig is None:
            if not self._free:
                raise SigOverflow()
            sig = self._free.pop()
            self._sig_of[key] = sig
            self.valid[sig] = True
            self.ns_id[sig] = ns
            self.label_vals[sig] = row
            self.deleting[sig] = deleting
            self._key_of_row[sig] = key
            self.dirty_sig_rows.add(sig)
        return sig

    def _unref(self, sig: int, n: int) -> None:
        self._refs[sig] -= n
        if self._refs[sig] <= 0:
            self._refs[sig] = 0
            self.valid[sig] = False
            key = self._key_of_row.pop(sig, None)
            if key is not None:
                self._sig_of.pop(key, None)
            self._free.append(sig)
            self.dirty_sig_rows.add(sig)

    def release_node(self, node_row: int, held: Dict[int, int]) -> None:
        """Undo a node's contribution: `held` is its {sig: count} map."""
        for sig, n in held.items():
            self.counts[node_row, sig] -= n
            self._unref(sig, n)

    def apply_delta(self, node_row: int, pod, sign: int, held: Dict[int, int]) -> None:
        """O(1) single-pod count change (the mirror's pod-delta path).
        `held` is the node's {sig: count} map. Raises KeySlotOverflow /
        SigOverflow like encode_node (the caller rebuilds); a remove of an
        unknown signature means the books are inconsistent — also a
        rebuild."""
        if sign > 0:
            sig = self._intern(pod)
            held[sig] = held.get(sig, 0) + 1
            self._refs[sig] += 1
            self.counts[node_row, sig] += 1
            return
        key, _, _, _ = self._encode_key(pod)
        sig = self._sig_of.get(key)
        if sig is None or held.get(sig, 0) <= 0:
            raise SigOverflow()  # inconsistent books: a full rebuild heals
        held[sig] -= 1
        if held[sig] == 0:
            del held[sig]
        self.counts[node_row, sig] -= 1
        self._unref(sig, 1)

    def apply_adds_bulk(self, rows: np.ndarray, pods: Sequence, held_maps: Sequence[Dict[int, int]]) -> None:
        """apply_delta(sign=+1) over a whole commit batch: interning stays
        per pod (memoized), the count and reference scatters are two
        np.add.at calls. A raise mid-loop leaves the books inconsistent;
        the caller rebuilds."""
        sigs = np.empty(len(pods), np.int64)
        for i, pod in enumerate(pods):
            sig = self._intern(pod)
            sigs[i] = sig
            h = held_maps[i]
            h[sig] = h.get(sig, 0) + 1
        np.add.at(self._refs, sigs, 1)
        np.add.at(self.counts, (rows, sigs), 1)

    def encode_node(self, node_row: int, pods) -> Dict[int, int]:
        """Count a node's pods into signatures → the {sig: count} map the
        caller keeps for the matching release_node. Raises KeySlotOverflow
        / SigOverflow for the mirror's rebuild-bigger loop (partial
        references are rolled back first)."""
        held: Dict[int, int] = {}
        try:
            for pod in pods:
                sig = self._intern(pod)
                held[sig] = held.get(sig, 0) + 1
                self._refs[sig] += 1
                self.counts[node_row, sig] += 1
        except KeySlotOverflow:
            self.release_node(node_row, held)
            raise
        return held

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "valid": self.valid,
            "ns_id": self.ns_id,
            "label_vals": self.label_vals,
            "deleting": self.deleting,
            "counts": self.counts,
        }


def encode_snapshot(
    snapshot: Snapshot, vocab: Optional[Vocab] = None, with_images: bool = True
) -> Tuple[NodeBank, SigBank, Dict[str, int]]:
    """Full (re-)encode of a Snapshot → (NodeBank, SigBank,
    node_row_index). The mirror's incremental path reuses the banks and
    calls set_node / encode_node for dirty rows only."""
    vocab = vocab or Vocab()
    min_sigs = 16
    while True:
        try:
            infos = list(snapshot.node_infos.values())
            bank = NodeBank(vocab, _node_bucket(len(infos)))
            row_of = {}
            for i, ni in enumerate(infos):
                bank.set_node(i, ni)
                row_of[ni.node.name] = i
            sigs = SigBank(vocab, _bucket(min_sigs), bank.capacity)
            for i, ni in enumerate(infos):
                sigs.encode_node(i, ni.pods)
            if with_images:
                ImageTable(vocab).apply(bank, snapshot)
            return bank, sigs, row_of
        except SigOverflow:
            min_sigs *= 2
        except KeySlotOverflow:
            continue  # vocab.config.key_slots already grown; rebuild
