"""The gang commit's rollback record (ref kubernetes_tpu/commit/apply.py:66).

The port's copy of `GangRollbackRecord`, without the reference's framework
(unreserve) and volume-binder hooks, which the port has no seam for yet.
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
        self.members: List[Tuple] = []  # (info, assumed pod, node name)

    def stage(self, info, assumed, node_name: str) -> None:
        self.members.append((info, assumed, node_name))

    def __len__(self) -> int:
        return len(self.members)

    def rollback(self, cache, fail: Callable, cycle: int, on_member: Optional[Callable] = None) -> int:
        """Unwind every staged member: one bulk cache forget, then `fail`
        per member and `on_member(info)` for the caller's bookkeeping
        (conflict-index tombstones). Returns the number of members."""
        members, self.members = self.members, []
        cache.forget_pods([m[1] for m in members])
        for info, _, _ in members:
            fail(info, cycle)
            if on_member is not None:
                on_member(info)
        return len(members)
