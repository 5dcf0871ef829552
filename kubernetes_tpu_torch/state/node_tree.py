"""NodeTree: zone-interleaved round-robin node iteration
(pkg/scheduler/internal/cache/node_tree.go:31, Next() :162).

The port's own copy of `kubernetes_tpu/state/node_tree.py`. The batch solve
evaluates every node and breaks ties uniformly at random, but the host
oracle's re-placement (scheduler/driver._oracle_place) walks nodes in an
order and keeps the first of equal best scores; this is that order, zone by
zone round-robin as the reference iterates them, rotating its start point
on every call.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..api.types import Node
from ..oracle.nodeinfo import get_zone_key


class NodeTree:
    def __init__(self):
        self._lock = threading.Lock()
        self._tree: Dict[str, List[str]] = {}  # zone key -> node names, guarded by self._lock
        self._zones: List[str] = []  # insertion-ordered zone keys
        self._rotation = 0  # order() starting offset (rotating tie de-bias)
        self._flat: Optional[List[str]] = None  # the interleaved pass, until the tree changes
        self.num_nodes = 0

    def add_node(self, node: Node) -> None:
        with self._lock:
            zone = get_zone_key(node)
            arr = self._tree.get(zone)
            if arr is None:
                self._tree[zone] = [node.name]
                self._zones.append(zone)
            elif node.name not in arr:
                arr.append(node.name)
            else:
                return
            self.num_nodes += 1
            self._flat = None

    def remove_node(self, node: Node) -> None:
        with self._lock:
            zone = get_zone_key(node)
            arr = self._tree.get(zone)
            if arr is None or node.name not in arr:
                return
            arr.remove(node.name)
            self.num_nodes -= 1
            self._flat = None
            if not arr:
                del self._tree[zone]
                self._zones.remove(zone)

    def update_node(self, old: Optional[Node], new: Node) -> None:
        if old is not None and get_zone_key(old) != get_zone_key(new):
            self.remove_node(old)
        # always (re-)register: headless placeholders promoted to real nodes
        # were never added, and add_node dedups known names
        self.add_node(new)

    def order(self) -> List[str]:
        """One full zone-interleaved pass over every node. Successive calls
        rotate the starting point (the stateful-Next round-robin de-bias,
        node_tree.go:162), so first-max-wins tie-breaks do not land on the
        same node every time. The pass is kept until a node is added or
        removed."""
        with self._lock:
            if not self._zones:
                return []
            out = self._flat
            if out is None:
                out = []
                idx = 0
                remaining = True
                while remaining:
                    remaining = False
                    for zone in self._zones:
                        arr = self._tree[zone]
                        if idx < len(arr):
                            out.append(arr[idx])
                            if idx + 1 < len(arr):
                                remaining = True
                    idx += 1
                self._flat = out
            r = self._rotation % len(out)
            self._rotation = (self._rotation + 1) % len(out)
            return out[r:] + out[:r]
