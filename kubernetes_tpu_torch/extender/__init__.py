"""HTTP SchedulerExtender: server (front a real kube-scheduler with the
batch solver on the card) and client (call out-of-tree extenders from this
scheduler).

Wire format: extender/v1 (pkg/scheduler/apis/extender/v1/types.go)."""

from .client import DEFAULT_EXTENDER_TIMEOUT, ExtenderConfig, HTTPExtender
from .server import ExtenderServer
from .types import (
    MAX_EXTENDER_PRIORITY,
    MIN_EXTENDER_PRIORITY,
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

__all__ = [
    "DEFAULT_EXTENDER_TIMEOUT",
    "ExtenderConfig",
    "HTTPExtender",
    "ExtenderServer",
    "MAX_EXTENDER_PRIORITY",
    "MIN_EXTENDER_PRIORITY",
    "ExtenderArgs",
    "ExtenderBindingArgs",
    "ExtenderBindingResult",
    "ExtenderFilterResult",
    "ExtenderPreemptionArgs",
    "ExtenderPreemptionResult",
    "HostPriority",
    "MetaVictims",
    "Victims",
]
