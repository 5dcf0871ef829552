"""Seeded cluster builders shared by the tests and chip_smoke.py.

Every builder takes the API types module to build with — this package's
`api.types` by default — so one description builds the same cluster for
the port and for the reference package (whose types have the same
constructors), and the two can be held pod for pod against each other.

* `bench_config2` — the scheduler_perf-style config 2 of the repository's
  bench.py (5,000 nodes / 50,000 pods at scale 1): NodeResourcesFit +
  TaintToleration + NodeAffinity.
* `bench_config3` — bench.py config 3 (10,000 nodes in 8 zones / 100,000
  pods in 100 apps, one ScheduleAnyway zone spread constraint per pod),
  optionally with one Service per app (`services_selectors`, the
  SelectorSpread input).
* `random_cluster` — a seeded cluster meant to reach every branch of the
  filter and score programs: all node-selector operators, taints of every
  effect, unschedulable nodes, host pins, used host ports, images,
  preferAvoidPods, extended resources, limits, priorities and (optionally)
  encoding-overflow nodes, ported pending pods and, with `topology`, the
  branches of the topology programs (see `random_selectors` for the
  matching SelectorSpread input).
"""

from __future__ import annotations

import json
from types import ModuleType
from typing import List, Optional, Tuple

import numpy as np

from ..api import types as port_types

TAINT_KEYS = ("dedicated", "gpu", "spot")
EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
IMAGES = tuple(f"registry.local/app-{i}:v1" for i in range(6))
ZONES = ("zone-a", "zone-b", "zone-c")
GPU = "example.com/gpu"
ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"
BENCH_ZONES = tuple(f"zone-{i}" for i in range(8))  # bench.py ZONES


# --- bench.py config 2 ------------------------------------------------------

def _bench_node(t: ModuleType, i: int, taint: bool):
    labels = {"kubernetes.io/hostname": f"node-{i}", "instance-type": ["small", "large"][i % 2]}
    alloc = {
        t.RESOURCE_CPU: t.Quantity.parse("32"),
        t.RESOURCE_MEMORY: t.Quantity.parse("256Gi"),
        t.RESOURCE_PODS: t.Quantity.parse(110),
    }
    taints = [t.Taint(key="dedicated", value="batch", effect="NoSchedule")] if taint else []
    return t.Node(name=f"node-{i}", labels=labels, allocatable=alloc, capacity=dict(alloc), taints=taints)


def bench_config2(n_nodes: int, n_pods: int, t: ModuleType = port_types) -> Tuple[list, list]:
    """bench.py cfg2_taint_affinity: every 4th node tainted
    dedicated=batch:NoSchedule; pods of 100m/256Mi, every 2nd tolerating the
    taint, each with a required `instance-type In` affinity (small+large,
    or large only for every 3rd pod)."""
    nodes = [_bench_node(t, i, taint=(i % 4 == 0)) for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        p = t.Pod(
            name=f"pod-{i}",
            namespace="bench",
            labels={"app": f"svc-{i % 50}"},
            containers=[t.Container(name="c", requests={
                t.RESOURCE_CPU: t.Quantity.parse("100m"),
                t.RESOURCE_MEMORY: t.Quantity.parse("256Mi"),
            })],
        )
        if i % 2 == 0:
            p.tolerations = [t.Toleration(key="dedicated", operator="Equal", value="batch", effect="NoSchedule")]
        p.affinity = t.Affinity(node_affinity=t.NodeAffinity(required=t.NodeSelector(
            node_selector_terms=[t.NodeSelectorTerm(match_expressions=[
                t.NodeSelectorRequirement(key="instance-type", operator="In",
                                          values=["small", "large"] if i % 3 else ["large"]),
            ])])))
        pods.append(p)
    return nodes, pods


# --- bench.py config 3 ------------------------------------------------------

def services_selectors(pod, t: ModuleType = port_types) -> list:
    """getSelectors for a cluster with one Service per app: the Service
    selects `app=<the pod's app>` (selector_spreading.go)."""
    return [t.LabelSelector(match_labels={"app": pod.labels["app"]})]


def bench_config3(n_nodes: int, n_pods: int, t: ModuleType = port_types, services: bool = False):
    """bench.py cfg3_spread: nodes spread round-robin over 8 zones; pods of
    100m/256Mi in 100 apps, each with one ScheduleAnyway zone constraint
    (maxSkew 1) selecting its own app. Returns (nodes, pods, selectors_fn):
    with `services`, selectors_fn is services_selectors bound to `t` (pass
    it to Scheduler.set_spread_selectors_fn), else None."""
    nodes = []
    for i in range(n_nodes):
        node = _bench_node(t, i, taint=False)
        node.labels[ZONE_KEY] = BENCH_ZONES[i % len(BENCH_ZONES)]
        nodes.append(node)
    pods = []
    for i in range(n_pods):
        app = f"svc-{i % 100}"
        pods.append(t.Pod(
            name=f"pod-{i}",
            namespace="bench",
            labels={"app": app},
            containers=[t.Container(name="c", requests={
                t.RESOURCE_CPU: t.Quantity.parse("100m"),
                t.RESOURCE_MEMORY: t.Quantity.parse("256Mi"),
            })],
            topology_spread_constraints=[t.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE_KEY, when_unsatisfiable="ScheduleAnyway",
                label_selector=t.LabelSelector(match_labels={"app": app}),
            )],
        ))
    fn = (lambda p: services_selectors(p, t)) if services else None
    return nodes, pods, fn


# --- the all-branches random cluster ----------------------------------------

def _pick(rng, seq):
    return seq[int(rng.integers(len(seq)))]


def _requirement(t, rng, key_pool, node_names):
    op = _pick(rng, ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"))
    key = _pick(rng, key_pool)
    if op in ("In", "NotIn"):
        vals = [_pick(rng, ("a", "b", "c", "1", "2", "5")) for _ in range(int(rng.integers(1, 3)))]
    elif op in ("Gt", "Lt"):
        vals = [str(int(rng.integers(0, 8)))]
    else:
        vals = []
    return t.NodeSelectorRequirement(key=key, operator=op, values=vals)


def _node(t, rng, i, overflow: bool):
    labels = {
        "kubernetes.io/hostname": f"n{i}",
        "failure-domain.beta.kubernetes.io/zone": _pick(rng, ZONES),
    }
    for k in ("tier", "disk", "rank"):
        if rng.random() < 0.6:
            labels[k] = _pick(rng, ("a", "b", "c", "1", "2", "5", "x9"))
    n_taints = 10 if overflow else int(rng.integers(0, 3))
    taints = [
        t.Taint(key=_pick(rng, TAINT_KEYS), value=_pick(rng, ("", "v1", "v2")), effect=_pick(rng, EFFECTS))
        for _ in range(n_taints)
    ]
    alloc = {
        t.RESOURCE_CPU: t.Quantity.parse(f"{int(rng.integers(1, 9)) * 1000}m"),
        t.RESOURCE_MEMORY: t.Quantity.parse(f"{int(rng.integers(2, 17))}Gi"),
        t.RESOURCE_PODS: t.Quantity.parse(int(rng.integers(3, 12))),
    }
    if rng.random() < 0.3:
        alloc[GPU] = t.Quantity.parse(int(rng.integers(1, 4)))
    images = [
        t.ContainerImage(names=[img], size_bytes=int(rng.integers(10, 900)) * 1024 * 1024)
        for img in IMAGES if rng.random() < 0.4
    ]
    annotations = {}
    if rng.random() < 0.25:
        annotations["scheduler.alpha.kubernetes.io/preferAvoidPods"] = json.dumps({"preferAvoidPods": [
            {"podSignature": {"podController": {"kind": "ReplicaSet", "uid": f"rs-{int(rng.integers(3))}"}}}
        ]})
    return t.Node(
        name=f"n{i}", labels=labels, taints=taints, unschedulable=bool(rng.random() < 0.1),
        allocatable=alloc, capacity=dict(alloc), images=images, annotations=annotations,
    )


def _pod(t, rng, name, node_names, ports: bool, pin: bool):
    requests = {}
    if rng.random() < 0.9:
        requests[t.RESOURCE_CPU] = t.Quantity.parse(f"{int(rng.integers(1, 20)) * 100}m")
    if rng.random() < 0.8:
        requests[t.RESOURCE_MEMORY] = t.Quantity.parse(f"{int(rng.integers(1, 16)) * 256}Mi")
    if rng.random() < 0.15:
        requests[GPU] = t.Quantity.parse(1)
    limits = {}
    if rng.random() < 0.3:
        limits[t.RESOURCE_CPU] = t.Quantity.parse(f"{int(rng.integers(1, 12))}")
    if rng.random() < 0.3:
        limits[t.RESOURCE_MEMORY] = t.Quantity.parse(f"{int(rng.integers(1, 24))}Gi")
    cports = []
    if ports and rng.random() < 0.3:
        cports = [t.ContainerPort(
            host_port=int(_pick(rng, (80, 443, 8080))), container_port=80,
            protocol=_pick(rng, ("TCP", "UDP")), host_ip=_pick(rng, ("", "10.0.0.1", "10.0.0.2")),
        )]
    containers = [t.Container(
        name="c", image=_pick(rng, IMAGES + ("other/img",)) if rng.random() < 0.7 else "",
        requests=requests, limits=limits, ports=cports,
    )]
    tolerations = []
    for _ in range(int(rng.integers(0, 3))):
        op = _pick(rng, ("Equal", "Exists"))
        tolerations.append(t.Toleration(
            key=_pick(rng, TAINT_KEYS + ("",)) if op == "Exists" else _pick(rng, TAINT_KEYS),
            operator=op,
            value=_pick(rng, ("", "v1", "v2")) if op == "Equal" else "",
            effect=_pick(rng, EFFECTS + ("",)),
        ))
    if rng.random() < 0.1:
        tolerations.append(t.Toleration(key="node.kubernetes.io/unschedulable", operator="Exists",
                                        effect="NoSchedule"))
    node_selector = {}
    if rng.random() < 0.2:
        node_selector[_pick(rng, ("tier", "disk"))] = _pick(rng, ("a", "b", "1"))
    affinity = None
    if rng.random() < 0.6:
        keys = ("tier", "disk", "rank", "failure-domain.beta.kubernetes.io/zone", "absent-key")
        required = None
        if rng.random() < 0.6:
            terms = []
            for _ in range(int(rng.integers(1, 3))):
                exprs = [_requirement(t, rng, keys, node_names) for _ in range(int(rng.integers(0, 3)))]
                fields = []
                if rng.random() < 0.2:
                    fields = [t.NodeSelectorRequirement(
                        key="metadata.name", operator=_pick(rng, ("In", "NotIn")),
                        values=[_pick(rng, node_names)],
                    )]
                if rng.random() < 0.05:
                    exprs.append(t.NodeSelectorRequirement(key="rank", operator="Gt", values=["x"]))
                terms.append(t.NodeSelectorTerm(match_expressions=exprs, match_fields=fields))
            required = t.NodeSelector(node_selector_terms=terms)
        preferred = [
            t.PreferredSchedulingTerm(
                weight=int(rng.integers(1, 100)),
                preference=t.NodeSelectorTerm(match_expressions=[
                    _requirement(t, rng, keys, node_names) for _ in range(int(rng.integers(0, 3)))
                ]),
            )
            for _ in range(int(rng.integers(0, 3)))
        ]
        affinity = t.Affinity(node_affinity=t.NodeAffinity(required=required, preferred=preferred))
    owners = []
    if rng.random() < 0.4:
        owners = [{"kind": "ReplicaSet", "uid": f"rs-{int(rng.integers(3))}", "controller": True}]
    return t.Pod(
        name=name, namespace=_pick(rng, ("default", "team-a")),
        labels={"app": _pick(rng, ("web", "db", "cache"))},
        containers=containers, tolerations=tolerations, node_selector=node_selector,
        affinity=affinity, owner_references=owners,
        node_name=_pick(rng, node_names) if pin and rng.random() < 0.05 else "",
        priority=int(_pick(rng, (0, 0, 10, 100))),
    )


def _label_selector(t, rng, app: str):
    """A spread selector over the pods' labels: every branch of the
    compiled selector (nil, empty, matchLabels, each expression operator,
    an In without values)."""
    kind = int(rng.integers(8))
    if kind == 0:
        return None  # nil: matches nothing
    if kind == 1:
        return t.LabelSelector()  # empty: matches everything
    if kind in (2, 3):
        return t.LabelSelector(match_labels={"app": app})
    op = _pick(rng, ("In", "NotIn", "Exists", "DoesNotExist", "In"))
    key = _pick(rng, ("app", "tier", "absent-key"))
    vals = [] if op in ("Exists", "DoesNotExist") or rng.random() < 0.1 else \
        [_pick(rng, ("web", "db", "a", "b")) for _ in range(int(rng.integers(1, 3)))]
    ml = {"app": app} if rng.random() < 0.4 else {}
    return t.LabelSelector(match_labels=ml, match_expressions=[
        t.LabelSelectorRequirement(key=key, operator=op, values=vals)])


def _add_topology(t, rng, nodes, existing, pending, hard_spread: bool) -> None:
    """The topology branches: nodes without the zone key and with a `rack`
    key on some; existing pods with a second label, some deleting; pending
    pods with ScheduleAnyway constraints on the zone, hostname or rack key
    (sometimes two on one key) and, with `hard_spread`, DoNotSchedule
    ones."""
    for n in nodes:
        if rng.random() < 0.1:
            del n.labels[ZONE_KEY]
        if rng.random() < 0.7:
            n.labels["rack"] = f"r{int(rng.integers(4))}"
    for p in existing:
        if rng.random() < 0.5:
            p.labels["tier"] = _pick(rng, ("a", "b"))
        if rng.random() < 0.1:
            p.deletion_timestamp = 1.0
    for p in pending:
        if rng.random() < 0.5:
            p.labels["tier"] = _pick(rng, ("a", "b"))
        cons = []
        if rng.random() < 0.7:
            key = _pick(rng, (ZONE_KEY, HOST_KEY, "rack"))
            cons.append(t.TopologySpreadConstraint(
                max_skew=int(rng.integers(1, 3)), topology_key=key, when_unsatisfiable="ScheduleAnyway",
                label_selector=_label_selector(t, rng, p.labels["app"])))
            if rng.random() < 0.3:
                key2 = key if rng.random() < 0.6 else _pick(rng, (ZONE_KEY, HOST_KEY, "rack"))
                cons.append(t.TopologySpreadConstraint(
                    max_skew=1, topology_key=key2, when_unsatisfiable="ScheduleAnyway",
                    label_selector=_label_selector(t, rng, p.labels["app"])))
        if hard_spread and rng.random() < 0.3:
            cons.append(t.TopologySpreadConstraint(
                max_skew=1, topology_key=_pick(rng, (ZONE_KEY, HOST_KEY)),
                when_unsatisfiable="DoNotSchedule",
                label_selector=_label_selector(t, rng, p.labels["app"])))
        p.topology_spread_constraints = cons


def random_selectors(t: ModuleType = port_types):
    """A getSelectors for random_cluster pods: web pods sit behind one
    Service, db pods behind a Service and a ReplicaSet selector on the
    tier, cache pods behind none (0, 1 and 2 selectors per pod)."""
    def fn(pod):
        app = pod.labels.get("app")
        if app == "web":
            return [t.LabelSelector(match_labels={"app": "web"})]
        if app == "db":
            return [t.LabelSelector(match_labels={"app": "db"}),
                    t.LabelSelector(match_expressions=[
                        t.LabelSelectorRequirement(key="tier", operator="In", values=["a"])])]
        return []
    return fn


def random_cluster(
    seed: int,
    n_nodes: int,
    n_pending: int,
    n_existing: int = 0,
    t: ModuleType = port_types,
    overflow_nodes: int = 0,
    pending_ports: bool = False,
    pins: bool = True,
    topology: bool = False,
    hard_spread: bool = False,
) -> Tuple[list, list, list]:
    """(nodes, existing bound pods, pending pods). Existing pods may hold
    host ports (they fill the nodes' port tables); pending pods hold ports
    only with `pending_ports`, and `overflow_nodes` nodes carry more taints
    than the encoding holds (fallback rows). `topology` adds the spread
    branches (`_add_topology`, drawn after everything else so the default
    cluster is unchanged); `hard_spread` adds DoNotSchedule constraints."""
    rng = np.random.default_rng(seed)
    nodes = [_node(t, rng, i, overflow=i < overflow_nodes) for i in range(n_nodes)]
    names = [n.name for n in nodes]
    existing = []
    for i in range(n_existing):
        p = _pod(t, rng, f"e{i}", names, ports=True, pin=False)
        p.node_name = _pick(rng, names)
        existing.append(p)
    pending = [_pod(t, rng, f"p{i}", names, ports=pending_ports, pin=pins) for i in range(n_pending)]
    if topology:
        _add_topology(t, rng, nodes, existing, pending, hard_spread)
    return nodes, existing, pending


def fill_cache(cache, nodes: list, existing: Optional[List] = None) -> None:
    """Add nodes and bound pods to a SchedulerCache (either package's)."""
    for n in nodes:
        cache.add_node(n)
    for p in existing or []:
        cache.add_pod(p)
