"""Scheduling Framework: plugin extension points + CycleState; the port's
own copy of `kubernetes_tpu.framework.interface` (a plain RLock guards the
CycleState where the reference takes an audited one).

Re-creates the v1alpha1 framework API surface
(pkg/scheduler/framework/v1alpha1/interface.go:190-354): QueueSort,
PreFilter (with AddPod/RemovePod extensions), Filter, PostFilter, Score
(with NormalizeScore), Reserve, Permit, PreBind, Bind, PostBind, Unreserve.

Python adaptation: plugins are duck-typed objects registering for the
extension points they implement; statuses are (code, message) tuples via the
Status class. The batch driver invokes the same hook order as scheduleOne
(scheduler.go:579-743) around the batch solve — plugins see one pod at
a time, exactly like upstream, so out-of-tree plugin logic ports directly.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..api.types import Pod

MAX_NODE_SCORE = 10
MIN_NODE_SCORE = 0

# Status codes (interface.go:77-110)
SUCCESS = 0
ERROR = 1
UNSCHEDULABLE = 2
WAIT = 3
SKIP = 4


class Status:
    def __init__(self, code: int = SUCCESS, message: str = ""):
        self.code = code
        self.message = message

    def is_success(self) -> bool:
        return self.code == SUCCESS

    def is_unschedulable(self) -> bool:
        return self.code == UNSCHEDULABLE

    @staticmethod
    def success() -> "Status":
        return Status(SUCCESS)

    @staticmethod
    def unschedulable(msg: str = "") -> "Status":
        return Status(UNSCHEDULABLE, msg)

    @staticmethod
    def error(msg: str = "") -> "Status":
        return Status(ERROR, msg)

    def __repr__(self) -> str:
        return f"Status(code={self.code}, message={self.message!r})"


class CycleState:
    """framework.CycleState (cycle_state.go): per-scheduling-cycle KV store
    shared across a pod's plugin invocations."""

    def __init__(self):
        self._lock = threading.RLock()
        self._data: Dict[str, Any] = {}

    def read(self, key: str) -> Any:
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            return self._data[key]

    def write(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def clone(self) -> "CycleState":
        cs = CycleState()
        cs._data = dict(self._data)
        return cs


class Plugin:
    """Base plugin: subclasses implement any subset of the hook methods.
    Presence of the method (overridden from this base) registers the plugin
    at that extension point."""

    name = "unnamed"

    # QueueSort
    def less(self, pod_info_a, pod_info_b) -> bool:
        raise NotImplementedError

    # PreFilter + extensions
    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        raise NotImplementedError

    def add_pod(self, state: CycleState, pod: Pod, pod_to_add: Pod, node_info) -> Status:
        raise NotImplementedError

    def remove_pod(self, state: CycleState, pod: Pod, pod_to_remove: Pod, node_info) -> Status:
        raise NotImplementedError

    # Filter
    def filter(self, state: CycleState, pod: Pod, node_info) -> Status:
        raise NotImplementedError

    # PostFilter (after filtering, before scoring)
    def post_filter(self, state: CycleState, pod: Pod, nodes, filtered_nodes_statuses) -> Status:
        raise NotImplementedError

    # Score + normalize
    def score(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[int, Status]:
        raise NotImplementedError

    def normalize_score(self, state: CycleState, pod: Pod, scores: Dict[str, int]) -> Status:
        raise NotImplementedError

    score_weight = 1

    # Reserve / Unreserve
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        raise NotImplementedError

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        raise NotImplementedError

    # Permit
    def permit(self, state: CycleState, pod: Pod, node_name: str) -> Tuple[Status, float]:
        """Returns (status, timeout_seconds); WAIT status parks the pod."""
        raise NotImplementedError

    # PreBind / Bind / PostBind
    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        raise NotImplementedError

    def bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        raise NotImplementedError

    def post_bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        raise NotImplementedError


def _implements(plugin: Plugin, method: str) -> bool:
    return getattr(type(plugin), method, None) is not getattr(Plugin, method, None)


@dataclass
class WaitingPod:
    """waiting_pods_map.go: a pod parked by a Permit plugin."""

    pod: Pod
    deadline: float
    allowed: Optional[bool] = None  # None = still waiting
    event: threading.Event = field(default_factory=threading.Event)

    def allow(self) -> None:
        self.allowed = True
        self.event.set()

    def reject(self) -> None:
        self.allowed = False
        self.event.set()


class Framework:
    """framework.go: runs the registered plugins at each extension point."""

    def __init__(self, plugins: Optional[List[Plugin]] = None):
        self.plugins = list(plugins or [])
        self.waiting_pods: Dict[str, WaitingPod] = {}

    def _at(self, point: str) -> List[Plugin]:
        return [p for p in self.plugins if _implements(p, point)]

    def has_plugins(self, point: str) -> bool:
        """Any plugin registered at this extension point? The driver uses
        this to decide whether a pod can stay on the pure-device fast path
        (no host plugins) or must route through the host commit path where
        plugin hooks run (framework.go RunFilterPlugins/RunScorePlugins)."""
        return bool(self._at(point))

    def queue_sort_less(self):
        qs = self._at("less")
        return qs[0].less if qs else None

    def run_pre_filter(self, state: CycleState, pod: Pod) -> Status:
        for p in self._at("pre_filter"):
            s = p.pre_filter(state, pod)
            if not s.is_success():
                return s
        return Status.success()

    def run_filter(self, state: CycleState, pod: Pod, node_info) -> Status:
        for p in self._at("filter"):
            s = p.filter(state, pod, node_info)
            if not s.is_success():
                return s
        return Status.success()

    def run_post_filter(self, state: CycleState, pod: Pod, nodes, statuses) -> Status:
        for p in self._at("post_filter"):
            s = p.post_filter(state, pod, nodes, statuses)
            if not s.is_success():
                return s
        return Status.success()

    def run_scores(self, state: CycleState, pod: Pod, node_names: List[str]) -> Dict[str, int]:
        """RunScorePlugins: per-plugin map + normalize + weighted sum."""
        total = {n: 0 for n in node_names}
        for p in self._at("score"):
            scores = {}
            for n in node_names:
                sc, st = p.score(state, pod, n)
                if not st.is_success():
                    sc = 0
                scores[n] = sc
            if _implements(p, "normalize_score"):
                p.normalize_score(state, pod, scores)
            w = getattr(p, "score_weight", 1)
            for n in node_names:
                total[n] += w * scores[n]
        return total

    def run_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self._at("reserve"):
            s = p.reserve(state, pod, node_name)
            if not s.is_success():
                return s
        return Status.success()

    def run_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in self._at("unreserve"):
            p.unreserve(state, pod, node_name)

    def run_permit(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """RunPermitPlugins: WAIT parks the pod until allow/reject/timeout."""
        max_timeout = 0.0
        statuses = []
        for p in self._at("permit"):
            s, timeout = p.permit(state, pod, node_name)
            if s.code == ERROR:
                return s
            if s.is_unschedulable():
                return s
            if s.code == WAIT:
                max_timeout = max(max_timeout, timeout)
                statuses.append(s)
        if not statuses:
            return Status.success()
        wp = WaitingPod(pod=pod, deadline=time.monotonic() + max_timeout)
        self.waiting_pods[pod.key()] = wp
        try:
            wp.event.wait(max_timeout)
        finally:
            self.waiting_pods.pop(pod.key(), None)
        if wp.allowed:
            return Status.success()
        if wp.allowed is None:
            return Status.unschedulable("permit timeout")
        return Status.unschedulable("rejected by permit")

    def run_pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self._at("pre_bind"):
            s = p.pre_bind(state, pod, node_name)
            if not s.is_success():
                return s
        return Status.success()

    def run_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """First bind plugin that doesn't SKIP handles the bind."""
        for p in self._at("bind"):
            s = p.bind(state, pod, node_name)
            if s.code == SKIP:
                continue
            return s
        return Status(SKIP)

    def run_post_bind(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in self._at("post_bind"):
            p.post_bind(state, pod, node_name)

    def get_waiting_pod(self, key: str) -> Optional[WaitingPod]:
        return self.waiting_pods.get(key)


class Registry:
    """registry.go: plugin name → factory."""

    def __init__(self):
        self._factories: Dict[str, Callable[..., Plugin]] = {}

    def register(self, name: str, factory: Callable[..., Plugin]) -> None:
        if name in self._factories:
            raise ValueError(f"plugin {name} already registered")
        self._factories[name] = factory

    def unregister(self, name: str) -> None:
        self._factories.pop(name, None)

    def make(self, name: str, *args, **kwargs) -> Plugin:
        return self._factories[name](*args, **kwargs)

    def names(self) -> List[str]:
        return sorted(self._factories)
