"""Built-in framework plugins + default registry
(pkg/scheduler/framework/plugins/)."""

from .builtin import (
    Handle,
    NodeName,
    PrioritySort,
    TaintToleration,
    VolumeBinding,
    predicate_plugin,
    priority_plugin,
)
from .registry import new_default_registry

__all__ = [
    "Handle",
    "NodeName",
    "PrioritySort",
    "TaintToleration",
    "VolumeBinding",
    "predicate_plugin",
    "priority_plugin",
    "new_default_registry",
]
