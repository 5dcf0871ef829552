"""Scheduling Framework (v1alpha1 equivalent): plugin extension points,
CycleState, Registry, built-in plugins."""

from .interface import (
    ERROR,
    SKIP,
    SUCCESS,
    UNSCHEDULABLE,
    WAIT,
    CycleState,
    Framework,
    Plugin,
    Registry,
    Status,
    WaitingPod,
)

__all__ = [
    "ERROR",
    "SKIP",
    "SUCCESS",
    "UNSCHEDULABLE",
    "WAIT",
    "CycleState",
    "Framework",
    "Plugin",
    "Registry",
    "Status",
    "WaitingPod",
]
