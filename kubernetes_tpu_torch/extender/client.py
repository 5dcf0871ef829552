"""HTTPExtender client — calling OUT to external extenders; the port's own
copy of `kubernetes_tpu.extender.client`.

Re-creates core/extender.go:43 (HTTPExtender) and the
algorithm.SchedulerExtender interface (algorithm/scheduler_interface.go:
28-73): Filter/Prioritize/Bind/ProcessPreemption/IsInterested/IsIgnorable,
with the nodeCacheCapable wire modes (:180, :305-331). The Scheduler driver
invokes registered extenders per pod on the host commit path, exactly where
findNodesThatFit (:531-557) and PrioritizeNodes (:813) call them.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..api.types import Node, Pod
from .types import (
    ExtenderArgs,
    ExtenderBindingArgs,
    ExtenderBindingResult,
    ExtenderFilterResult,
    ExtenderPreemptionArgs,
    ExtenderPreemptionResult,
    HostPriority,
    MetaVictims,
    Victims,
)

DEFAULT_EXTENDER_TIMEOUT = 5.0  # core/extender.go DefaultExtenderTimeout


@dataclass
class ExtenderConfig:
    """schedulerapi.ExtenderConfig (pkg/scheduler/api/types.go Extender)."""

    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False  # IsIgnorable: failures skip, don't fail the pod
    managed_resources: List[str] = field(default_factory=list)
    timeout_s: float = DEFAULT_EXTENDER_TIMEOUT


class HTTPExtender:
    def __init__(self, config: ExtenderConfig):
        self.config = config

    # -- wire ---------------------------------------------------------------

    def _post(self, verb: str, payload: dict):
        url = self.config.url_prefix.rstrip("/") + "/" + verb
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.config.timeout_s) as resp:
            return json.loads(resp.read() or b"null")

    # -- SchedulerExtender --------------------------------------------------

    def is_ignorable(self) -> bool:
        return self.config.ignorable

    def is_interested(self, pod: Pod) -> bool:
        """IsInterested (core/extender.go:450): with no managed resources,
        every pod; otherwise pods requesting any managed resource."""
        if not self.config.managed_resources:
            return True
        managed = set(self.config.managed_resources)
        for c in pod.containers + pod.init_containers:
            for name in list(c.requests) + list(c.limits):
                if name in managed:
                    return True
        return False

    def supports_filter(self) -> bool:
        return bool(self.config.filter_verb)

    def supports_prioritize(self) -> bool:
        return bool(self.config.prioritize_verb)

    def supports_bind(self) -> bool:
        return bool(self.config.bind_verb)

    def supports_preemption(self) -> bool:
        return bool(self.config.preempt_verb)

    def filter(
        self, pod: Pod, nodes: List[Node]
    ) -> Tuple[List[str], Dict[str, str]]:
        """→ (feasible node names, failed{name: reason}). Raises on wire
        errors (caller honors is_ignorable)."""
        if self.config.node_cache_capable:
            args = ExtenderArgs(pod=pod, node_names=[n.name for n in nodes])
        else:
            args = ExtenderArgs(pod=pod, nodes=nodes)
        res = ExtenderFilterResult.from_json(self._post(self.config.filter_verb, args.to_json()))
        if res.error:
            raise RuntimeError(res.error)
        if res.node_names is not None:
            return list(res.node_names), res.failed_nodes
        return [n.name for n in (res.nodes or [])], res.failed_nodes

    def prioritize(self, pod: Pod, nodes: List[Node]) -> Dict[str, int]:
        """→ {node: score * weight} (PrioritizeNodes :813 applies weight)."""
        if self.config.node_cache_capable:
            args = ExtenderArgs(pod=pod, node_names=[n.name for n in nodes])
        else:
            args = ExtenderArgs(pod=pod, nodes=nodes)
        raw = self._post(self.config.prioritize_verb, args.to_json()) or []
        out: Dict[str, int] = {}
        for d in raw:
            hp = HostPriority.from_json(d)
            out[hp.host] = out.get(hp.host, 0) + hp.score * self.config.weight
        return out

    def bind(self, pod: Pod, node_name: str) -> None:
        args = ExtenderBindingArgs(
            pod_name=pod.name, pod_namespace=pod.namespace, pod_uid=pod.uid, node=node_name
        )
        res = ExtenderBindingResult.from_json(self._post(self.config.bind_verb, args.to_json()))
        if res.error:
            raise RuntimeError(res.error)

    def process_preemption(
        self, pod: Pod, node_to_victims: Dict[str, Victims]
    ) -> Dict[str, MetaVictims]:
        """ProcessPreemption (core/extender.go:119): send the victim map,
        receive the (possibly trimmed) map back."""
        if self.config.node_cache_capable:
            args = ExtenderPreemptionArgs(
                pod=pod,
                node_name_to_meta_victims={
                    n: MetaVictims(
                        pod_uids=[p.uid for p in v.pods],
                        num_pdb_violations=v.num_pdb_violations,
                    )
                    for n, v in node_to_victims.items()
                },
            )
        else:
            args = ExtenderPreemptionArgs(pod=pod, node_name_to_victims=node_to_victims)
        res = ExtenderPreemptionResult.from_json(
            self._post(self.config.preempt_verb, args.to_json())
        )
        return res.node_name_to_meta_victims
