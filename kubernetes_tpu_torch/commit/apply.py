"""The gang commit's rollback record (ref kubernetes_tpu/commit/apply.py:66).

The port's copy of `GangRollbackRecord`, with the framework's Unreserve
hook and without the reference's volume-binder one (the port has no volume
seam yet).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple


class GangRollbackRecord:
    """One record per gang group of a batch: the members staged so far
    (their cache assumes made, their binds held back) and the one call that
    unwinds them all."""

    __slots__ = ("group", "members")

    def __init__(self, group: str):
        self.group = group
        self.members: List[Tuple] = []  # (info, assumed pod, node name, CycleState)

    def stage(self, info, assumed, node_name: str, state) -> None:
        self.members.append((info, assumed, node_name, state))

    def __len__(self) -> int:
        return len(self.members)

    def rollback(self, cache, framework, fail: Callable, cycle: int, on_member: Optional[Callable] = None) -> int:
        """Unwind every staged member: one bulk cache forget, then per
        member the Unreserve plugins, `fail` and `on_member(info)` for the
        caller's bookkeeping (conflict-index tombstones). Returns the number
        of members."""
        members, self.members = self.members, []
        cache.forget_pods([m[1] for m in members])
        for info, _, node_name, state in members:
            framework.run_unreserve(state, info.pod, node_name)
            fail(info, cycle)
            if on_member is not None:
                on_member(info)
        return len(members)
