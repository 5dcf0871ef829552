"""Seeded cluster builders shared by the tests and chip_smoke.py.

Every builder takes the API types module to build with — this package's
`api.types` by default — so one description builds the same cluster for
the port and for the reference package (whose types have the same
constructors), and the two can be held pod for pod against each other.

* `bench_config1` — bench.py config 1 (500 nodes / 5,000 pods at scale
  1): resources only.
* `bench_config2` — the scheduler_perf-style config 2 of the repository's
  bench.py (5,000 nodes / 50,000 pods at scale 1): NodeResourcesFit +
  TaintToleration + NodeAffinity.
* `bench_config3` — bench.py config 3 (10,000 nodes in 8 zones / 100,000
  pods in 100 apps, one ScheduleAnyway zone spread constraint per pod),
  optionally with one Service per app (`services_selectors`, the
  SelectorSpread input), or with DoNotSchedule constraints ("config
  3-hard": the commit arbiter's workload).
* `bench_config4` — bench.py config 4 (2,000 nodes in 8 zones / 20,000
  pods in 20 apps: every 10th pod with a required hostname anti-affinity
  against its own `exclusive` label, the rest with a preferred zone
  affinity to their own app).
* `bench_config5` — bench.py config 5 (2,000 nodes / 1,000 gang groups of
  64 pods at scale 1). `random_gang_cluster` is a tight seeded gang
  workload whose groups do not all fit: dropped groups, min-available,
  anti-affine members whose groups roll back on the host, ungrouped pods.
* `bench_config6` — bench.py config 6 (500 nodes of 32 cores, each
  holding 7 bound priority-0 pods of 4 cores; 2,000 pending priority-1000
  pods of 6 cores / 2Gi that land only by preemption).
* `random_preemption_cluster` — a seeded cluster meant to reach every
  branch of preemption: mixed priorities, PodDisruptionBudgets with and
  without disruptions left, an extended resource, taints, unschedulable
  and full nodes, pods that fit as things stand, pods that request
  nothing, and (optionally) host ports.
* `commit_plane_mix` — scripts/perf_smoke.py's tiny commit-plane
  workload: zoned nodes, 1/8 of the pods with a required hostname
  anti-affinity, 1/8 with a DoNotSchedule zone spread in their own label
  space, the rest plain.
* `make_node` / `make_pod` — one node or pod as the reference's
  models/generators builds them (its tests' scenarios, rebuilt here).
* `policy_cluster` — a config-1-sized cluster for the Policy's
  custom-argument predicates and priorities: region and zone labels, a
  `retiring` label on some nodes and `disktype=ssd` on others, apps with
  one Service each and one bound anchor pod per app.
* `random_cluster` — a seeded cluster meant to reach every branch of the
  filter and score programs: all node-selector operators, taints of every
  effect, unschedulable nodes, host pins, used host ports, images,
  preferAvoidPods, extended resources, limits, priorities and (optionally)
  encoding-overflow nodes, ported pending pods and, with `topology`, the
  branches of the topology programs (see `random_selectors` for the
  matching SelectorSpread input) and, with `interpod`, those of the
  inter-pod programs and the solver's in-batch tracking.
"""

from __future__ import annotations

import json
from types import ModuleType
from typing import List, Optional, Tuple

import numpy as np

from ..api import types as port_types
from ..scheduler.driver import POD_GROUP_LABEL, POD_GROUP_MIN_AVAILABLE

TAINT_KEYS = ("dedicated", "gpu", "spot")
EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
IMAGES = tuple(f"registry.local/app-{i}:v1" for i in range(6))
ZONES = ("zone-a", "zone-b", "zone-c")
GPU = "example.com/gpu"
ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"
BENCH_ZONES = tuple(f"zone-{i}" for i in range(8))  # bench.py ZONES


# --- single objects and the Policy cluster ---------------------------------

def make_node(name: str, cpu_milli: int = 4000, mem: int = 16 * 2**30, pods: int = 110,
              labels: Optional[dict] = None, taints: Optional[list] = None, unschedulable: bool = False,
              t: ModuleType = port_types):
    """A node as the reference's models/generators.make_node builds it."""
    alloc = {
        t.RESOURCE_CPU: t.Quantity.parse(f"{cpu_milli}m"),
        t.RESOURCE_MEMORY: t.Quantity.parse(mem),
        t.RESOURCE_PODS: t.Quantity.parse(pods),
    }
    return t.Node(name=name, labels=dict(labels or {}), taints=list(taints or []), unschedulable=unschedulable,
                  capacity=dict(alloc), allocatable=alloc)


def make_pod(name: str, namespace: str = "default", cpu_milli: int = 100, mem: int = 128 * 2**20,
             labels: Optional[dict] = None, node_name: str = "", t: ModuleType = port_types, **kwargs):
    """A pod as the reference's models/generators.make_pod builds it: one
    container requesting `cpu_milli` and `mem` (a zero leaves it out)."""
    requests = {}
    if cpu_milli:
        requests[t.RESOURCE_CPU] = t.Quantity.parse(f"{cpu_milli}m")
    if mem:
        requests[t.RESOURCE_MEMORY] = t.Quantity.parse(mem)
    return t.Pod(name=name, namespace=namespace, labels=dict(labels or {}), node_name=node_name,
                 containers=[t.Container(name="main", image=IMAGES[0], requests=requests)], **kwargs)


REGION_KEY = "failure-domain.beta.kubernetes.io/region"


def policy_cluster(n_nodes: int, n_pods: int, n_apps: int = 20, t: ModuleType = port_types):
    """Nodes as bench.py config 1's (32 cores / 256Gi / 110 pods) in 8
    zones over 2 regions (zone i in region i mod 2), every 7th node
    labelled `retiring`, every 3rd `disktype=ssd`; pods of config 1's
    sizes in `n_apps` apps with one Service each (selector app=<app>) and,
    per app, one bound anchor pod on node (3 app) mod n_nodes. Returns
    (nodes, anchors, pods, services)."""
    nodes = []
    for i in range(n_nodes):
        node = _bench_node(t, i, taint=False)
        node.labels[ZONE_KEY] = BENCH_ZONES[i % 8]
        node.labels[REGION_KEY] = f"region-{i % 2}"
        if i % 7 == 0:
            node.labels["retiring"] = "2026-01-01"
        if i % 3 == 0:
            node.labels["disktype"] = "ssd"
        nodes.append(node)
    app = lambda i: f"svc-{i % n_apps}"  # noqa: E731
    anchors = []
    for a in range(n_apps):
        p = _bench_pod(t, n_pods + a, labels={"app": app(a)})
        anchors.append(p.with_node(nodes[(3 * a) % n_nodes].name))
    pods = [_bench_pod(t, i, cpu=("100m", "250m", "500m")[i % 3], labels={"app": app(i)}) for i in range(n_pods)]
    services = [t.Service(name=app(a), namespace="bench", selector={"app": app(a)}) for a in range(n_apps)]
    return nodes, anchors, pods, services


# --- bench.py config 1 ------------------------------------------------------

def _bench_pod(t: ModuleType, i: int, cpu: str = "100m", labels: Optional[dict] = None):
    """bench.py mk_pod: pod-<i> in namespace bench, one container
    requesting `cpu` and 256Mi."""
    return t.Pod(
        name=f"pod-{i}",
        namespace="bench",
        labels=labels if labels is not None else {"app": f"svc-{i % 50}"},
        containers=[t.Container(name="c", requests={
            t.RESOURCE_CPU: t.Quantity.parse(cpu),
            t.RESOURCE_MEMORY: t.Quantity.parse("256Mi"),
        })],
    )


def bench_config1(n_nodes: int, n_pods: int, t: ModuleType = port_types) -> Tuple[list, list]:
    """bench.py cfg1_resources: untainted nodes of 32 cores / 256Gi / 110
    pods; pods of 100m, 250m or 500m (by index mod 3) and 256Mi in 50 apps.
    Resources only."""
    nodes = [_bench_node(t, i, taint=False) for i in range(n_nodes)]
    pods = [_bench_pod(t, i, cpu=("100m", "250m", "500m")[i % 3]) for i in range(n_pods)]
    return nodes, pods


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
        p = _bench_pod(t, i)
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


def bench_config3(n_nodes: int, n_pods: int, t: ModuleType = port_types, services: bool = False,
                  hard: bool = False):
    """bench.py cfg3_spread: nodes spread round-robin over 8 zones; pods of
    100m/256Mi in 100 apps, each with one ScheduleAnyway zone constraint
    (maxSkew 1) selecting its own app — DoNotSchedule with `hard`.
    Returns (nodes, pods, selectors_fn): with `services`, selectors_fn is
    services_selectors bound to `t` (pass it to
    Scheduler.set_spread_selectors_fn), else None."""
    nodes = []
    for i in range(n_nodes):
        node = _bench_node(t, i, taint=False)
        node.labels[ZONE_KEY] = BENCH_ZONES[i % len(BENCH_ZONES)]
        nodes.append(node)
    pods = []
    for i in range(n_pods):
        app = f"svc-{i % 100}"
        p = _bench_pod(t, i, labels={"app": app})
        p.topology_spread_constraints = [t.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE_KEY,
            when_unsatisfiable="DoNotSchedule" if hard else "ScheduleAnyway",
            label_selector=t.LabelSelector(match_labels={"app": app}),
        )]
        pods.append(p)
    fn = (lambda p: services_selectors(p, t)) if services else None
    return nodes, pods, fn


def commit_plane_mix(n_nodes: int = 8, n_pods: int = 96, t: ModuleType = port_types) -> Tuple[list, list]:
    """scripts/perf_smoke.py tiny_commit_plane_config: nodes over 4 of
    bench.py's zones; pods of 100m/64Mi: every 8th (i % 8 == 0) with
    `exclusive=x<i % 16>` and a required hostname anti-affinity against
    it, every 8th (i % 8 == 1) with `spread=grp<i % 2>` and a
    DoNotSchedule zone constraint (maxSkew 1) on its own label (so every
    pod its selector matches carries the constraint), the rest plain."""
    nodes = []
    for i in range(n_nodes):
        node = _bench_node(t, i, taint=False)
        node.labels[ZONE_KEY] = BENCH_ZONES[i % 4]
        nodes.append(node)
    pods = []
    for i in range(n_pods):
        labels = {"app": f"svc-{i % 50}"}
        if i % 8 == 0:
            labels = {"exclusive": f"x{i % 16}"}
        elif i % 8 == 1:
            labels = {"spread": f"grp{i % 2}"}
        p = t.Pod(
            name=f"pod-{i}",
            namespace="bench",
            labels=labels,
            containers=[t.Container(name="c", requests={
                t.RESOURCE_CPU: t.Quantity.parse("100m"),
                t.RESOURCE_MEMORY: t.Quantity.parse("64Mi"),
            })],
        )
        if i % 8 == 0:
            p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"exclusive": labels["exclusive"]}),
                topology_key=HOST_KEY)]))
        elif i % 8 == 1:
            p.topology_spread_constraints = [t.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE_KEY, when_unsatisfiable="DoNotSchedule",
                label_selector=t.LabelSelector(match_labels={"spread": labels["spread"]}))]
        pods.append(p)
    return nodes, pods


# --- bench.py config 4 ------------------------------------------------------

def bench_config4(n_nodes: int, n_pods: int, t: ModuleType = port_types) -> Tuple[list, list]:
    """bench.py cfg4_interpod: nodes spread round-robin over 8 zones; pods
    of 100m/256Mi in 20 apps. Every 10th pod (all of svc-0 and svc-10)
    carries `exclusive=<app>` and a REQUIRED anti-affinity on the hostname
    key against that label; every other pod a PREFERRED (weight 10) zone
    affinity to its own app."""
    nodes = []
    for i in range(n_nodes):
        node = _bench_node(t, i, taint=False)
        node.labels[ZONE_KEY] = BENCH_ZONES[i % len(BENCH_ZONES)]
        nodes.append(node)
    pods = []
    for i in range(n_pods):
        app = f"svc-{i % 20}"
        p = _bench_pod(t, i, labels={"app": app})
        if i % 10 == 0:
            p.labels["exclusive"] = app
            p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"exclusive": app}), topology_key=HOST_KEY)]))
        else:
            p.affinity = t.Affinity(pod_affinity=t.PodAffinity(preferred=[t.WeightedPodAffinityTerm(
                weight=10, pod_affinity_term=t.PodAffinityTerm(
                    label_selector=t.LabelSelector(match_labels={"app": app}), topology_key=ZONE_KEY))]))
        pods.append(p)
    return nodes, pods


# --- bench.py config 5 ------------------------------------------------------

def bench_config5(n_nodes: int, n_groups: int, t: ModuleType = port_types) -> Tuple[list, list]:
    """bench.py cfg5_gang: untainted nodes of 32 cores / 256Gi / 110 pods;
    `n_groups` gang groups of 64 pods of 100m / 256Mi, every pod of group g
    labelled app=gang-<g> and with the PodGroup label gang-<g>."""
    nodes = [_bench_node(t, i, taint=False) for i in range(n_nodes)]
    pods = []
    for g in range(n_groups):
        for m in range(64):
            pods.append(_bench_pod(t, g * 64 + m, labels={"app": f"gang-{g}", POD_GROUP_LABEL: f"gang-{g}"}))
    return nodes, pods


def random_gang_cluster(seed: int, n_nodes: int = 10, n_groups: int = 12, n_solo: int = 20,
                        t: ModuleType = port_types) -> Tuple[list, list]:
    """A tight seeded gang workload whose groups together ask for more than
    the cluster holds, so that some groups drop: nodes of 2-4 cores and
    6-10 pods over three zones; groups of 2-9 members of 250m-1000m (one
    request per group), some with priorities, some declaring a
    min-available above or equal to their size (by label or annotation),
    some whose members carry a required hostname anti-affinity against
    their own group (one member per node: larger groups fail on the host
    and roll back) and some whose members are selected by another group's
    anti term; and ungrouped pods between them. Returns (nodes, pods) in
    enqueue order."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        alloc = {
            t.RESOURCE_CPU: t.Quantity.parse(f"{int(rng.integers(2, 5)) * 1000}m"),
            t.RESOURCE_MEMORY: t.Quantity.parse("8Gi"),
            t.RESOURCE_PODS: t.Quantity.parse(int(rng.integers(6, 11))),
        }
        nodes.append(t.Node(name=f"n{i}", labels={HOST_KEY: f"n{i}", ZONE_KEY: ZONES[i % len(ZONES)]},
                            allocatable=alloc, capacity=dict(alloc)))
    members = []
    for g in range(n_groups):
        size = int(rng.integers(2, 10))
        cpu = int(_pick(rng, (250, 500, 750, 1000)))
        prio = int(_pick(rng, (0, 0, 10, 100)))
        anti = rng.random() < 0.3
        tag = f"t{int(rng.integers(0, 3))}"
        need = int(_pick(rng, (0, 0, 0, size, size + 2)))
        on_annotation = rng.random() < 0.5
        for m in range(size):
            labels = {"app": f"gang-{g}", "tier": tag}
            annotations = {}
            (annotations if on_annotation else labels)[POD_GROUP_LABEL] = f"gang-{g}"
            if need:
                (annotations if on_annotation else labels)[POD_GROUP_MIN_AVAILABLE] = str(need)
            p = t.Pod(name=f"g{g}-m{m}", namespace="default", labels=labels, annotations=annotations,
                      containers=[t.Container(name="c", requests={
                          t.RESOURCE_CPU: t.Quantity.parse(f"{cpu}m"),
                          t.RESOURCE_MEMORY: t.Quantity.parse("256Mi")})],
                      priority=prio)
            if anti:
                # one member per node, and none beside a pod of the same tier
                # from another anti-affine group
                p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                    label_selector=t.LabelSelector(match_labels={"tier": tag}), topology_key=HOST_KEY)]))
            members.append(p)
    solos = []
    for i in range(n_solo):
        solos.append(t.Pod(
            name=f"solo-{i}", namespace="default",
            labels={"app": f"solo-{i % 3}", "tier": f"t{int(rng.integers(0, 3))}"},
            containers=[t.Container(name="c", requests={
                t.RESOURCE_CPU: t.Quantity.parse(f"{int(_pick(rng, (100, 500, 1500)))}m"),
                t.RESOURCE_MEMORY: t.Quantity.parse("128Mi")})],
            priority=int(_pick(rng, (0, 10, 100))),
        ))
    # groups arrive member by member, the solos between them
    pods = members + solos
    order = rng.permutation(len(pods))
    return nodes, [pods[k] for k in order]


# --- bench.py config 6 ------------------------------------------------------

#: a fixed epoch for the seeded creation timestamps (seconds)
T0 = 1_700_000_000.0


def bench_config6(n_nodes: int, n_preemptors: int, t: ModuleType = port_types, seed: int = 0):
    """bench.py cfg6_preemption: `n_nodes` nodes of 32 cores / 256Gi /
    110 pods, each holding 7 bound priority-0 pods of 4000m / 1Gi (28 of
    its 32 cores), and `n_preemptors` pending pods of 6000m / 2Gi, priority
    class `bench-critical`, so that they land only by preemption. The
    pending pods carry priority 1000 directly (the value the reference's
    Priority admission plugin writes for that class) and every pod a
    seeded creation timestamp (the bound ones within the hour before the
    pending ones, which arrive 1 ms apart). Returns (nodes, existing,
    pending)."""
    rng = np.random.default_rng(seed)
    nodes = [_bench_node(t, i, taint=False) for i in range(n_nodes)]
    existing = []
    for i in range(n_nodes * 7):
        p = t.Pod(
            name=f"pod-{1_000_000 + i}",
            namespace="bench",
            labels={"app": f"lowprio-{i % 20}"},
            containers=[t.Container(name="c", requests={
                t.RESOURCE_CPU: t.Quantity.parse("4000m"),
                t.RESOURCE_MEMORY: t.Quantity.parse("1Gi"),
            })],
            priority=0,
            node_name=f"node-{i % n_nodes}",
            creation_timestamp=T0 + float(rng.uniform(0.0, 3600.0)),
        )
        existing.append(p)
    pending = []
    for i in range(n_preemptors):
        pending.append(t.Pod(
            name=f"pod-{i}",
            namespace="bench",
            labels={"app": f"hiprio-{i % 20}"},
            containers=[t.Container(name="c", requests={
                t.RESOURCE_CPU: t.Quantity.parse("6000m"),
                t.RESOURCE_MEMORY: t.Quantity.parse("2Gi"),
            })],
            priority=1000,
            priority_class_name="bench-critical",
            creation_timestamp=T0 + 3600.0 + i * 1e-3,
        ))
    return nodes, existing, pending


def random_preemption_cluster(seed: int, n_nodes: int = 24, n_pending: int = 40, t: ModuleType = port_types,
                              pdbs: bool = True, ports: bool = False):
    """(nodes, existing bound pods, pending pods, PodDisruptionBudgets).

    Nodes of 4-8 cores, 8-16Gi and 4-10 pods, some with an extended
    resource (`GPU`), a NoSchedule taint, a `tier` label or marked
    unschedulable, most of them filled close to their cpu or pod limit by
    bound pods of priority 0, 10, 50 or 100 in apps a0-a3 (some holding
    the extended resource); pending pods of priority 0, 50, 100 or 1000
    (a few requesting nothing, some the extended resource, some with a
    node selector or the taint's toleration). With `pdbs`, budgets on apps
    a0-a2 with 0 or 1 disruptions left (and one with an empty selector);
    with `ports`, host ports on some bound and pending pods."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        alloc = {
            t.RESOURCE_CPU: t.Quantity.parse(f"{int(rng.integers(4, 9)) * 1000}m"),
            t.RESOURCE_MEMORY: t.Quantity.parse(f"{int(rng.integers(8, 17))}Gi"),
            t.RESOURCE_PODS: t.Quantity.parse(int(rng.integers(4, 11))),
        }
        if rng.random() < 0.3:
            alloc[GPU] = t.Quantity.parse(int(rng.integers(1, 4)))
        labels = {HOST_KEY: f"n{i}"}
        if rng.random() < 0.5:
            labels["tier"] = _pick(rng, ("a", "b"))
        taints = [t.Taint(key="dedicated", value="x", effect="NoSchedule")] if rng.random() < 0.15 else []
        nodes.append(t.Node(name=f"n{i}", labels=labels, taints=taints, unschedulable=bool(rng.random() < 0.08),
                            allocatable=alloc, capacity=dict(alloc)))
    existing = []
    k = 0
    for node in nodes:
        cpu_cap = node.allocatable[t.RESOURCE_CPU].milli_value()
        pods_cap = node.allocatable[t.RESOURCE_PODS].value()
        used = 0
        for _ in range(pods_cap - int(rng.integers(0, 2))):
            cpu = int(_pick(rng, (500, 1000, 1500, 2000)))
            if used + cpu > cpu_cap - int(_pick(rng, (0, 0, 500, 1000))):
                break
            requests = {t.RESOURCE_CPU: t.Quantity.parse(f"{cpu}m"),
                        t.RESOURCE_MEMORY: t.Quantity.parse(f"{int(rng.integers(1, 5)) * 256}Mi")}
            if GPU in node.allocatable and rng.random() < 0.3:
                requests[GPU] = t.Quantity.parse(1)
            cports = []
            if ports and rng.random() < 0.2:
                cports = [t.ContainerPort(host_port=int(_pick(rng, (80, 8080))), container_port=80)]
            existing.append(t.Pod(
                name=f"e{k}", namespace=_pick(rng, ("default", "default", "team-a")),
                labels={"app": f"a{int(rng.integers(0, 4))}"},
                containers=[t.Container(name="c", requests=requests, ports=cports)],
                priority=int(_pick(rng, (0, 0, 10, 50, 100))), node_name=node.name,
                creation_timestamp=T0 + float(rng.uniform(0.0, 1000.0)),
            ))
            used += cpu
            k += 1
    pending = []
    for i in range(n_pending):
        requests = {}
        if rng.random() > 0.08:
            requests[t.RESOURCE_CPU] = t.Quantity.parse(f"{int(_pick(rng, (500, 1500, 2500, 4000)))}m")
            requests[t.RESOURCE_MEMORY] = t.Quantity.parse(f"{int(rng.integers(1, 9)) * 256}Mi")
            if rng.random() < 0.15:
                requests[GPU] = t.Quantity.parse(1)
        cports = []
        if ports and rng.random() < 0.2:
            cports = [t.ContainerPort(host_port=int(_pick(rng, (80, 8080))), container_port=80)]
        p = t.Pod(
            name=f"p{i}", namespace="default", labels={"app": f"a{int(rng.integers(0, 4))}"},
            containers=[t.Container(name="c", requests=requests, ports=cports)],
            priority=int(_pick(rng, (0, 50, 100, 1000, 1000))),
            creation_timestamp=T0 + 2000.0 + i,
        )
        if rng.random() < 0.15:
            p.node_selector = {"tier": _pick(rng, ("a", "b"))}
        if rng.random() < 0.3:
            p.tolerations = [t.Toleration(key="dedicated", operator="Exists", effect="NoSchedule")]
        pending.append(p)
    budgets = []
    if pdbs:
        for j in range(3):
            budgets.append(t.PodDisruptionBudget(
                name=f"pdb{j}", namespace="default",
                selector=t.LabelSelector(match_labels={"app": f"a{j}"}),
                disruptions_allowed=int(_pick(rng, (0, 0, 1))),
            ))
        budgets.append(t.PodDisruptionBudget(name="empty", namespace="default", selector=t.LabelSelector(),
                                             disruptions_allowed=0))
    return nodes, existing, pending, budgets


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


def _affinity_selector(t, rng):
    """A pod (anti-)affinity selector: nil, empty, matchLabels, each
    expression operator, an In without values."""
    kind = int(rng.integers(9))
    if kind == 0:
        return None  # nil: matches nothing
    if kind == 1:
        return t.LabelSelector()  # empty: matches everything
    if kind in (2, 3, 4):
        return t.LabelSelector(match_labels={"app": _pick(rng, ("web", "db", "cache"))})
    op = _pick(rng, ("In", "NotIn", "Exists", "DoesNotExist"))
    key = _pick(rng, ("app", "tier", "role", "absent-key"))
    vals = [] if op in ("Exists", "DoesNotExist") or rng.random() < 0.1 else \
        [_pick(rng, ("web", "db", "a", "lead")) for _ in range(int(rng.integers(1, 3)))]
    ml = {"app": _pick(rng, ("web", "db"))} if rng.random() < 0.3 else {}
    return t.LabelSelector(match_labels=ml, match_expressions=[
        t.LabelSelectorRequirement(key=key, operator=op, values=vals)])


def _affinity_term(t, rng, keys=(ZONE_KEY, HOST_KEY, "rack")):
    nss = _pick(rng, ([], [], ["default"], ["team-a", "default"], ["other"]))
    return t.PodAffinityTerm(label_selector=_affinity_selector(t, rng), namespaces=list(nss),
                             topology_key=_pick(rng, keys))


def _weighted(t, rng):
    return [t.WeightedPodAffinityTerm(weight=int(rng.integers(1, 101)), pod_affinity_term=_affinity_term(t, rng))
            for _ in range(int(rng.integers(1, 3)))]


def _add_interpod(t, rng, existing, pending, pending_affinity: bool) -> None:
    """The inter-pod branches: existing pods with required anti-affinity,
    required affinity and preferred (anti-)affinity terms (the PatternBank's
    ANTI_REQ, hard-weight AFF_REQ, AFF_PREF and negative ANTI_PREF rows);
    pending pods with 0-2 required anti terms (zone, hostname and rack
    keys), preferred affinity and anti-affinity, host ports (wildcard and
    specific IPs) and, with `pending_affinity`, required affinity terms —
    some matching only pods that exist nowhere yet (the first-pod escape
    when the pod matches itself). A `role` label on some pods gives the
    selectors something to find or miss."""
    for p in existing + pending:
        if rng.random() < 0.2:
            p.labels["role"] = _pick(rng, ("lead", "follow"))
    for p in existing:
        if rng.random() < 0.35:
            a = p.affinity or t.Affinity()
            r = rng.random()
            if r < 0.3:
                a.pod_anti_affinity = t.PodAntiAffinity(required=[_affinity_term(t, rng)])
            elif r < 0.5:
                a.pod_affinity = t.PodAffinity(required=[_affinity_term(t, rng)], preferred=_weighted(t, rng))
            elif r < 0.8:
                a.pod_affinity = t.PodAffinity(preferred=_weighted(t, rng))
            else:
                a.pod_anti_affinity = t.PodAntiAffinity(preferred=_weighted(t, rng))
            p.affinity = a
    for p in pending:
        a = p.affinity or t.Affinity()
        if rng.random() < 0.3:
            a.pod_anti_affinity = t.PodAntiAffinity(
                required=[_affinity_term(t, rng) for _ in range(int(rng.integers(1, 3)))])
        if rng.random() < 0.3:
            a.pod_affinity = t.PodAffinity(preferred=_weighted(t, rng))
        if rng.random() < 0.2:
            anti = a.pod_anti_affinity or t.PodAntiAffinity()
            anti.preferred = _weighted(t, rng)
            a.pod_anti_affinity = anti
        if pending_affinity and rng.random() < 0.25:
            if rng.random() < 0.3:
                # only pending pods carry tier=lead: no existing pod matches
                p.labels["tier"] = "lead"
                terms = [t.PodAffinityTerm(label_selector=t.LabelSelector(match_labels={"tier": "lead"}),
                                           topology_key=_pick(rng, (ZONE_KEY, HOST_KEY)))]
            else:
                terms = [_affinity_term(t, rng) for _ in range(int(rng.integers(1, 3)))]
            aff = a.pod_affinity or t.PodAffinity()
            aff.required = terms
            a.pod_affinity = aff
        if a.pod_affinity is not None or a.pod_anti_affinity is not None or a.node_affinity is not None:
            p.affinity = a
        if rng.random() < 0.15:
            p.containers[0].ports = [t.ContainerPort(
                host_port=int(_pick(rng, (80, 443))), container_port=80,
                protocol=_pick(rng, ("TCP", "UDP")), host_ip=_pick(rng, ("", "10.0.0.1", "0.0.0.0")),
            )]


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
    interpod: bool = False,
    pending_affinity: bool = True,
) -> Tuple[list, list, list]:
    """(nodes, existing bound pods, pending pods). Existing pods may hold
    host ports (they fill the nodes' port tables); pending pods hold ports
    only with `pending_ports`, and `overflow_nodes` nodes carry more taints
    than the encoding holds (fallback rows). `topology` adds the spread
    branches (`_add_topology`, drawn after everything else so the default
    cluster is unchanged); `hard_spread` adds DoNotSchedule constraints.
    `interpod` adds the inter-pod branches after those (`_add_interpod`;
    pending required affinity only with `pending_affinity`)."""
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
    if interpod:
        _add_interpod(t, rng, existing, pending, pending_affinity)
    return nodes, existing, pending


def fill_cache(cache, nodes: list, existing: Optional[List] = None) -> None:
    """Add nodes and bound pods to a SchedulerCache (either package's)."""
    for n in nodes:
        cache.add_node(n)
    for p in existing or []:
        cache.add_pod(p)


def random_preempt_arrays(seed: int, p: int = 48, n: int = 40, v: int = 8, r: int = 8, runs: bool = False) -> dict:
    """Seeded padded inputs of ops/preempt.preempt_batch (numpy, the
    driver's dtypes) meant to reach every branch of the scan: candidate
    masks with holes, preemptors that request nothing (p_req_any False) or
    an extended-resource slot (>= 3), nodes over- and under-committed and
    without pod slack, PDB-violating slots, negative and duplicate start
    times, outstanding nominee charges, the last 5 preemptor and 4 node
    rows padding. Two thirds of the nodes copy one of a few
    template nodes, changing at most one of start times, a victim's
    priority, a victim's request or a PDB flag, so the six-key pick is
    decided at every key, the row included.

    With `runs` the preemptors are instead runs of repeated specs (lengths
    1-12, at most a quarter of the rows) drawn from four templates, as a controller's replicas queue: one
    template requests nothing (its steps fit as things stand wherever a pod
    slot is free), one an extended-resource unit, two have every node as
    candidate and two have holes;
    the last 5 rows are zero padding with no candidate, and two rows inside
    the runs are invalid. The nodes are the default mode's."""
    rng = np.random.default_rng(seed)
    a = {}
    a["cand"] = rng.random((p, n)) < 0.85
    req = rng.integers(0, 4, (p, r)).astype(np.int64) * 1000
    req[:, 3:] = np.where(rng.random((p, r - 3)) < 0.15, rng.integers(1, 3, (p, r - 3)), 0)
    req[rng.random(p) < 0.08] = 0
    a["p_req"] = req
    a["p_req_any"] = req.any(axis=1)
    a["p_prio"] = rng.choice([0, 5, 10, 100], p).astype(np.int32)
    a["p_valid"] = np.arange(p) < p - 5
    n_tmpl = 4
    vreq = rng.integers(0, 3, (n, v, r)).astype(np.int64) * 1000
    vreq[:, :, 3:] = np.where(rng.random((n, v, r - 3)) < 0.1, 1, 0)
    vprio = rng.choice([-3, 0, 0, 5, 50], (n, v)).astype(np.int32)
    vts = rng.choice([-7_000_000, -3, 0, 4_000_000, 4_000_000, 9_000_000], (n, v)).astype(np.int64)
    vpdb = rng.random((n, v)) < 0.2
    vvalid = rng.random((n, v)) < 0.85
    free0 = rng.integers(-1, 3, (n, r)).astype(np.int64) * 1000
    free0[:, 3:] = rng.integers(0, 2, (n, r - 3))
    count_free0 = rng.integers(0, 4, n).astype(np.int32)
    for i in range(n // 3, n):
        j = int(rng.integers(0, n_tmpl))
        vreq[i], vprio[i], vts[i], vpdb[i], vvalid[i] = vreq[j], vprio[j], vts[j], vpdb[j], vvalid[j]
        free0[i], count_free0[i] = free0[j], count_free0[j]
        change = int(rng.integers(0, 5))
        slot = int(rng.integers(0, v))
        if change == 1:
            vts[i] = vts[i] + int(rng.integers(-2, 3)) * 1_000_000
        elif change == 2:
            vprio[i, slot] = int(rng.choice([-3, 0, 5]))
        elif change == 3:
            vreq[i, slot, 0] += 1000
        elif change == 4:
            vpdb[i, slot] = not vpdb[i, slot]
    a["vict_req"] = vreq
    a["vict_prio"] = vprio
    a["vict_ts"] = vts
    a["vict_pdb"] = vpdb
    a["vict_valid"] = vvalid
    a["free0"] = free0
    a["count_free0"] = count_free0
    a["node_valid"] = np.arange(n) < n - 4
    nom = rng.random(n) < 0.2
    a["nom_extra0"] = np.where(nom[:, None], rng.integers(0, 2, (n, r)) * 1000, 0).astype(np.int64)
    a["nom_cnt0"] = nom.astype(np.int32)
    if runs:
        _preemptor_runs(np.random.default_rng([seed, 7]), a, p, n, r)
    return a


def _preemptor_runs(rng, a: dict, p: int, n: int, r: int, n_tmpl: int = 4) -> None:
    """Overwrite the preemptor rows of `a` with runs of repeated template
    specs (see random_preempt_arrays)."""
    t_req = rng.integers(0, 4, (n_tmpl, r)).astype(np.int64) * 1000
    t_req[:, :2] = rng.integers(2, 4, (n_tmpl, 2)) * 1000  # cpu and memory: most steps need victims
    t_req[:, 3:] = 0
    t_req[n_tmpl - 1, 3] = 1  # the last template asks for one extended-resource unit
    t_req[0] = 0
    t_prio = rng.choice([5, 10, 100], n_tmpl).astype(np.int32)
    t_cand = rng.random((n_tmpl, n)) < 0.85
    t_cand[1:3] = True
    live = p - 5
    rows = []
    while len(rows) < live:
        rows += [int(rng.integers(0, n_tmpl))] * int(rng.integers(1, min(12, max(2, live // 4)) + 1))
    rows = np.asarray(rows[:live])
    a["p_req"] = np.zeros((p, r), np.int64)
    a["p_req"][:live] = t_req[rows]
    a["p_req_any"] = a["p_req"].any(axis=1)
    a["p_prio"] = np.zeros(p, np.int32)
    a["p_prio"][:live] = t_prio[rows]
    a["cand"] = np.zeros((p, n), bool)
    a["cand"][:live] = t_cand[rows]
    a["p_valid"] = np.arange(p) < live
    a["p_valid"][rng.choice(live, 2, replace=False)] = False
