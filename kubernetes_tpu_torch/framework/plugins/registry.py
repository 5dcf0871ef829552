"""Default plugin registry (framework/plugins/default_registry.go).

Maps the plugin names this version of the reference knows about to
factories. NewDefaultRegistry registers: prioritysort (queue),
nodename, tainttoleration, volumebinding (+ migration-shimmed legacy
predicates, which here run as device kernels and are exposed as shims
only for custom configs). VolumeBinding is registered, and its factory
raises like the port's other volume seams."""

from __future__ import annotations

from typing import Optional

from ..interface import Registry
from . import builtin


def new_default_registry(handle: Optional[builtin.Handle] = None, volume_binder=None) -> Registry:
    r = Registry()
    r.register("PrioritySort", lambda: builtin.PrioritySort())
    r.register("NodeName", lambda: builtin.NodeName())
    r.register("TaintToleration", lambda: builtin.TaintToleration(handle))
    r.register("VolumeBinding", lambda: builtin.VolumeBinding(volume_binder))
    return r
