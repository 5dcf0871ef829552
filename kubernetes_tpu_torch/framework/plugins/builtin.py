"""Built-in framework plugins: the port's own copy of
`kubernetes_tpu.framework.plugins.builtin`.

The reference migrated three plugins to the framework in this version —
NodeName, TaintToleration, VolumeBinding
(pkg/scheduler/framework/plugins/{nodename,tainttoleration,volumebinding},
default_registry.go) — plus `migration/` shims that wrap any legacy
predicate/priority as a plugin. Same set here. Note the DEFAULT config
does not register them as framework plugins (the legacy predicate set
covers the same checks — here, as the device kernels); they
exist for Policy/ComponentConfig configurations and as porting targets for
out-of-tree plugins.

Plugins that need cluster state beyond the NodeInfo handed to Filter take a
`handle` — the FrameworkHandle equivalent exposing a snapshot accessor
(framework/v1alpha1/interface.go FrameworkHandle).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ...api.types import Pod
from ...oracle import predicates as opred
from ...oracle import priorities as opri
from ..interface import CycleState, Plugin, Status


class Handle:
    """FrameworkHandle: what built-in plugins need from the scheduler."""

    def __init__(self, snapshot_fn: Callable[[], object]):
        self.snapshot_fn = snapshot_fn

    def snapshot(self):
        return self.snapshot_fn()


class PrioritySort(Plugin):
    """QueueSort: priority desc, then enqueue order — the default activeQ
    comparator (scheduling_queue.go activeQComp)."""

    name = "PrioritySort"

    def less(self, a, b) -> bool:
        pa, pb = a.pod.get_priority(), b.pod.get_priority()
        if pa != pb:
            return pa > pb
        return a.seq < b.seq


class NodeName(Plugin):
    """plugins/nodename: Filter = PodFitsHost (predicates.go:991)."""

    name = "NodeName"

    def filter(self, state: CycleState, pod: Pod, node_info) -> Status:
        if opred.pod_fits_host(pod, node_info):
            return Status.success()
        return Status.unschedulable("node didn't match the requested hostname")


class TaintToleration(Plugin):
    """plugins/tainttoleration: Filter = PodToleratesNodeTaints
    (predicates.go:1604); Score = preferred-taint count, normalized
    (taint_toleration.go:55)."""

    name = "TaintToleration"
    score_weight = 1

    def __init__(self, handle: Optional[Handle] = None):
        self.handle = handle

    def filter(self, state: CycleState, pod: Pod, node_info) -> Status:
        if opred.pod_tolerates_node_taints(pod, node_info):
            return Status.success()
        return Status.unschedulable("node has taints the pod doesn't tolerate")

    def score(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[int, Status]:
        snap = self.handle.snapshot() if self.handle else None
        if snap is None:
            return 0, Status.success()
        key = f"tt-scores/{pod.key()}"
        try:
            scores = state.read(key)
        except KeyError:
            scores = opri.taint_toleration_priority(pod, snap)
            state.write(key, scores)
        return scores.get(node_name, 0), Status.success()


class VolumeBinding(Plugin):
    """plugins/volumebinding: Filter = CheckVolumeBinding via the volume
    binder seam, which the port does not have yet: building one raises
    (ROADMAP.md queue 1 item 7, volumes)."""

    name = "VolumeBinding"

    def __init__(self, binder=None):
        raise NotImplementedError(
            "the VolumeBinding plugin needs the volume binder seam, which is not ported "
            "(ROADMAP.md queue 1 item 7, volumes)"
        )


def predicate_plugin(plugin_name: str, fn: Callable[[Pod, object], bool], msg: str = "") -> Plugin:
    """migration shim: legacy FitPredicate → Filter plugin
    (framework/plugins/migration/utils.go)."""

    class _Shim(Plugin):
        name = plugin_name

        def filter(self, state: CycleState, pod: Pod, node_info) -> Status:
            if fn(pod, node_info):
                return Status.success()
            return Status.unschedulable(msg or f"{plugin_name} failed")

    return _Shim()


def priority_plugin(
    plugin_name: str,
    fn: Callable[[Pod, object], Dict[str, int]],
    handle: Handle,
    weight: int = 1,
) -> Plugin:
    """migration shim: legacy PriorityFunction → Score plugin. `fn` maps
    (pod, snapshot) → {node: score}; cached in CycleState per cycle."""

    class _Shim(Plugin):
        name = plugin_name
        score_weight = weight

        def score(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[int, Status]:
            key = f"{plugin_name}/{pod.key()}"
            try:
                scores = state.read(key)
            except KeyError:
                scores = fn(pod, handle.snapshot())
                state.write(key, scores)
            return scores.get(node_name, 0), Status.success()

    return _Shim()


class ServiceAffinityPlugin(Plugin):
    """Policy serviceAffinity predicate as a plugin: PreFilter runs the
    once-per-pod anchor-candidate scan (serviceAffinityMetadataProducer,
    predicates.go:1060), Filter applies the per-node backfill + match
    (checkServiceAffinity, predicates.go:1123). State travels in
    CycleState so Filter never rescans the cluster."""

    def __init__(self, plugin_name: str, labels, snapshot_fn, services_fn):
        self.name = plugin_name
        self._labels = tuple(labels)
        self._snapshot_fn = snapshot_fn
        self._services_fn = services_fn

    def _key(self, pod: Pod) -> str:
        return f"{self.name}/meta/{pod.key()}"

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        from ...oracle.predicates import service_affinity_precompute

        state.write(
            self._key(pod),
            service_affinity_precompute(
                pod, self._snapshot_fn(), self._labels, self._services_fn()
            ),
        )
        return Status.success()

    def filter(self, state: CycleState, pod: Pod, node_info) -> Status:
        from ...oracle.predicates import (
            service_affinity_fits,
            service_affinity_precompute,
        )

        try:
            base, cands = state.read(self._key(pod))
        except KeyError:
            # resilient like the reference when metadata is missing
            base, cands = service_affinity_precompute(
                pod, self._snapshot_fn(), self._labels, self._services_fn()
            )
        if service_affinity_fits(
            pod, node_info, self._snapshot_fn(), self._labels, base, cands
        ):
            return Status.success()
        return Status.unschedulable("node(s) didn't match service affinity")
