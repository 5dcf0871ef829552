"""Scheduler cache and the device-resident node bank.

The port's own lean copies of `kubernetes_tpu.state.cache`:

* `SchedulerCache` — authoritative in-memory cluster state with the
  assumed-pod state machine (pkg/scheduler/internal/cache/cache.go,
  interface.go:33-47): Initial → Assume → [bind] → Added, or Assume →
  Forget (bind failed) → Initial. Every mutation records what changed
  (dirty nodes, single-pod deltas) for the mirror.
* `TensorMirror` — keeps the host `NodeBank` and the existing pods'
  `SigBank` in sync with the cache, patching only DIRTY rows per cycle the
  way UpdateNodeInfoSnapshot walks its generation-ordered dirty list
  (cache.go:206-242), and keeps device-resident torch copies of both. The
  copies are patched by dirty rows with one `index_copy_` per changed
  array — the counterpart of the reference's jitted `_row_scatter_fn`, a
  data move with no arithmetic — and uploaded in full only after a
  rebuild.

Both run on one driver thread at a time; the cache's lock covers the bind
workers' finish_binding / forget calls.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..api.types import Node, Pod
from ..oracle.nodeinfo import NodeInfo, Snapshot, pod_has_affinity_constraints
from .convert import arrays_to_torch
from .tensors import (
    ImageTable,
    KeySlotOverflow,
    NodeBank,
    SigBank,
    SigOverflow,
    Vocab,
    _bucket,
    _node_bucket,
)

# node-bank columns a pod commit changes: rows whose only change is a pod
# add/remove ship these three arrays instead of the whole row
USAGE_KEYS = ("requested", "nonzero_req", "pod_count")


@dataclass
class _PodState:
    pod: Pod
    assumed: bool = False
    binding_finished: bool = False


class SchedulerCache:
    """cache.go schedulerCache: node name → NodeInfo, pod key → state."""

    def __init__(self):
        self._lock = threading.RLock()
        self.snapshot = Snapshot()
        self._pod_states: Dict[str, _PodState] = {}  # guarded by self._lock
        self._assumed: Set[str] = set()  # guarded by self._lock
        self.dirty_nodes: Set[str] = set()
        self.removed_nodes: Set[str] = set()
        # (node, pod, ±1) single-pod changes (assume/confirm/remove) — the
        # common event; consumed by TensorMirror.sync
        self.pod_deltas: List[Tuple[str, Pod, int]] = []
        # keys of cached pods that carry pod (anti-)affinity: their terms
        # feed the inter-pod programs this port does not run yet
        self.affinity_pod_keys: Set[str] = set()

    # -- helpers -------------------------------------------------------------

    def _track_affinity(self, pod: Pod, sign: int) -> None:
        if pod_has_affinity_constraints(pod):
            if sign > 0:
                self.affinity_pod_keys.add(pod.key())
            else:
                self.affinity_pod_keys.discard(pod.key())

    def _collapse_deltas_locked(self) -> None:
        """Bound the delta log: past the bound it collapses into the
        node-count-bounded dirty set (a re-encoded row ships in full)."""
        if len(self.pod_deltas) >= max(1024, 4 * len(self.snapshot.node_infos)):
            for n, _, _ in self.pod_deltas:
                self.dirty_nodes.add(n)
            self.pod_deltas.clear()

    def _add_pod_to_node(self, pod: Pod) -> None:
        self._track_affinity(pod, 1)
        ni = self.snapshot.get(pod.node_name)
        if ni is None:
            # pod on an unknown node: track headlessly (the reference keeps
            # an imaginary NodeInfo; it becomes real when the node arrives)
            ni = self.snapshot.add_node(Node(name=pod.node_name))
            ni.add_pod(pod)
            self.dirty_nodes.add(pod.node_name)
            return
        ni.add_pod(pod)
        # single-pod change: a DELTA, not node dirt — the mirror patches the
        # node row's usage columns in O(1) instead of re-counting the node
        self.pod_deltas.append((pod.node_name, pod, 1))
        self._collapse_deltas_locked()

    def _remove_pod_from_node(self, pod: Pod) -> None:
        ni = self.snapshot.get(pod.node_name)
        if ni is None:
            return
        removed = ni.remove_pod_key(pod.key())
        if removed is not None:
            self._track_affinity(removed, -1)
            self.pod_deltas.append((pod.node_name, removed, -1))
            self._collapse_deltas_locked()

    # -- assumed pod state machine (cache.go:270-388) ------------------------

    def assume_pod(self, pod: Pod) -> None:
        """AssumePod: optimistically add to the target node before bind."""
        if self.assume_pods([pod]):
            raise ValueError(f"pod {pod.key()} already in cache")

    def assume_pods(self, pods: List[Pod]) -> List[int]:
        """Bulk AssumePod under ONE lock. Returns the indices of pods
        REJECTED because their key is already in the cache — the caller
        fails those individually."""
        rejected: List[int] = []
        with self._lock:
            for i, pod in enumerate(pods):
                key = pod.key()
                if key in self._pod_states:
                    rejected.append(i)
                    continue
                self._pod_states[key] = _PodState(pod=pod, assumed=True)
                self._assumed.add(key)
                self._add_pod_to_node(pod)
        return rejected

    def finish_bindings(self, pods: List[Pod]) -> None:
        """Bulk FinishBinding (cache.go:300). The assumed-pod TTL expiry
        that follows it in the reference is not ported yet (ROADMAP.md
        queue 1, robustness)."""
        with self._lock:
            for pod in pods:
                st = self._pod_states.get(pod.key())
                if st is not None and st.assumed:
                    st.binding_finished = True

    def forget_pod(self, pod: Pod) -> None:
        """ForgetPod: bind failed; undo the assume (cache.go:334)."""
        with self._lock:
            key = pod.key()
            st = self._pod_states.get(key)
            if st is None or not st.assumed:
                return
            self._remove_pod_from_node(st.pod)
            del self._pod_states[key]
            self._assumed.discard(key)

    # -- informer-confirmed pod events (cache.go:389-520) --------------------

    def add_pod(self, pod: Pod) -> None:
        """AddPod: the informer says the pod is bound. Confirms an assumed
        pod or adds a foreign one."""
        with self._lock:
            key = pod.key()
            st = self._pod_states.get(key)
            if st is not None and st.assumed:
                # confirmation: replace the assumed object with the real one
                # (the informer may report another node than we assumed)
                self._remove_pod_from_node(st.pod)
                self._add_pod_to_node(pod)
                self._pod_states[key] = _PodState(pod=pod)
                self._assumed.discard(key)
                return
            if st is not None:
                self.update_pod(st.pod, pod)
                return
            self._pod_states[key] = _PodState(pod=pod)
            self._add_pod_to_node(pod)

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._lock:
            self._remove_pod_from_node(old)
            self._add_pod_to_node(new)
            self._pod_states[new.key()] = _PodState(pod=new)

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            key = pod.key()
            st = self._pod_states.pop(key, None)
            self._assumed.discard(key)
            if st is not None:
                self._remove_pod_from_node(st.pod)

    def is_assumed(self, key: str) -> bool:
        with self._lock:
            return key in self._assumed

    # -- node events (cache.go:522-600) --------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            ni = self.snapshot.get(node.name)
            if ni is None:
                self.snapshot.add_node(node)
            else:
                ni.node = node  # was a headless placeholder, or an update
            self.dirty_nodes.add(node.name)
            self.removed_nodes.discard(node.name)

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        with self._lock:
            ni = self.snapshot.node_infos.pop(name, None)
            if ni is not None:
                for p in ni.pods:
                    self._pod_states.pop(p.key(), None)
                    self._assumed.discard(p.key())
                    self._track_affinity(p, -1)
            self.dirty_nodes.discard(name)
            self.removed_nodes.add(name)

    # -- counters ------------------------------------------------------------

    def pod_count(self) -> int:
        with self._lock:
            return len(self._pod_states)


class TensorMirror:
    """Keeps the `NodeBank` and the existing pods' `SigBank` patched from a
    SchedulerCache, plus their copies on `device`. Node rows come from a
    free list in snapshot order (the reference's allocation, so row
    indices — and with them every tie-break — match it); each node's pods
    are counted into label signatures, and `_node_sigs` holds each node's
    {signature: count} map so a re-encode or removal can release exactly
    what it added. Capacity overflow (more nodes than rows, more
    signatures than slots, label-key growth) rebuilds the banks at the
    next bucket size."""

    def __init__(self, cache: SchedulerCache, device: torch.device):
        self.cache = cache
        self.device = torch.device(device)
        self.vocab = Vocab()
        self.rebuild_count = -1  # the constructor's build doesn't count
        # distinct (ns, labels) signatures are workload-bounded (hundreds in
        # 100k-pod clusters): starting at 256 avoids a mid-drain rebuild
        self._min_sigs = 256
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dev_eps: Optional[Dict[str, torch.Tensor]] = None
        self._device_stale = True
        self._image_stale = False
        self._pending_node_rows: Set[int] = set()  # whole rows to ship
        self._pending_usage_rows: Set[int] = set()  # USAGE_KEYS + sig counts
        self.rows_shipped = 0  # node rows patched into the device copy
        self._rebuild()

    def _rebuild(self) -> None:
        self.rebuild_count += 1
        snap = self.cache.snapshot
        while True:
            try:
                self.nodes = NodeBank(self.vocab, _node_bucket(max(len(snap.node_infos), 1)))
                self.row_of: Dict[str, int] = {}
                self.name_of_row: List[Optional[str]] = [None] * self.nodes.capacity
                self._free_rows = list(range(self.nodes.capacity - 1, -1, -1))
                for ni in snap.node_infos.values():
                    row = self._free_rows.pop()
                    self.row_of[ni.node.name] = row
                    self.name_of_row[row] = ni.node.name
                    self.nodes.set_node(row, ni)
                self.eps = SigBank(self.vocab, _bucket(self._min_sigs), self.nodes.capacity)
                self._node_sigs: Dict[str, Dict[int, int]] = {}
                for name, ni in snap.node_infos.items():
                    self._encode_node_pods(name, ni)
                ImageTable(self.vocab).apply(self.nodes, snap, self.row_of)
                self._image_sig = {
                    name: self._image_signature(ni) for name, ni in snap.node_infos.items()
                }
                break
            except SigOverflow:
                # 4x per growth: buy headroom, not tight fits
                self._min_sigs *= 4
            except KeySlotOverflow:
                continue  # vocab.config.key_slots already grew
        self.cache.dirty_nodes.clear()
        self.cache.removed_nodes.clear()
        self.cache.pod_deltas.clear()  # the rebuild re-counted everything
        self._device_stale = True  # shapes may have changed: full re-upload
        self._pending_node_rows.clear()
        self._pending_usage_rows.clear()
        self.eps.dirty_sig_rows.clear()

    @staticmethod
    def _image_signature(ni: NodeInfo):
        return frozenset(ni.image_sizes().items())

    def _release_node_pods(self, name: str) -> None:
        """Subtract a node's held signature counts (zeroing its counts row)
        — before its row is freed or re-counted."""
        row = self.row_of.get(name)
        held = self._node_sigs.pop(name, None)
        if row is not None and held:
            self.eps.release_node(row, held)
            self._pending_node_rows.add(row)

    def _encode_node_pods(self, name: str, ni: NodeInfo) -> None:
        """Count one node's pods into label signatures. Raises SigOverflow /
        KeySlotOverflow when a bank is full (the caller rebuilds bigger)."""
        row = self.row_of[name]
        self._node_sigs[name] = self.eps.encode_node(row, ni.pods)
        self._pending_node_rows.add(row)

    def sync(self) -> bool:
        """Apply dirty nodes (re-counting only their pods) plus single-pod
        deltas (O(1) each). Returns True if a full rebuild happened (the
        arrays may change shape)."""
        cache = self.cache
        with cache._lock:
            dirty = set(cache.dirty_nodes)
            removed = set(cache.removed_nodes)
            deltas = list(cache.pod_deltas)
            cache.dirty_nodes.clear()
            cache.removed_nodes.clear()
            cache.pod_deltas.clear()
            has_new = any(n not in self.row_of for n in cache.snapshot.node_infos)
            if len(cache.snapshot.node_infos) > self.nodes.capacity:
                self._rebuild()
                return True
            if not (dirty or removed or has_new or deltas):
                return False
            try:
                for name in removed:
                    # release pods FIRST (zeroes the node's signature-count
                    # row) so a later node reusing this row starts clean
                    self._release_node_pods(name)
                    row = self.row_of.pop(name, None)
                    if row is not None:
                        self.nodes.clear_node(row)
                        self.name_of_row[row] = None
                        self._free_rows.append(row)
                        self._pending_node_rows.add(row)
                    self._image_sig.pop(name, None)
                new_nodes = [n for n in cache.snapshot.node_infos if n not in self.row_of]
                if len(new_nodes) > len(self._free_rows):
                    self._rebuild()
                    return True
                for name in new_nodes:
                    row = self._free_rows.pop()
                    self.row_of[name] = row
                    self.name_of_row[row] = name
                images_changed = bool(removed) or bool(new_nodes)
                for name in dirty | set(new_nodes):
                    ni = cache.snapshot.get(name)
                    if ni is None or name not in self.row_of:
                        continue
                    self.nodes.set_node(self.row_of[name], ni)
                    self._pending_node_rows.add(self.row_of[name])
                    self._release_node_pods(name)
                    self._encode_node_pods(name, ni)
                    sig = self._image_signature(ni)
                    if self._image_sig.get(name) != sig:
                        self._image_sig[name] = sig
                        images_changed = True
                # single-pod deltas last, skipping nodes re-encoded above
                # (their rows already include the deltas). Plain adds batch
                # into np.add.at scatters (usage columns and signature
                # counts); removes and ported pods take the scalar path,
                # flushing the batch first so per-node order is kept (a
                # remove must see the adds before it).
                reencoded = removed | dirty | set(new_nodes)
                ports_dirty: Set[str] = set()
                bulk_rows: List[int] = []
                bulk_pods: List[Pod] = []
                bulk_held: List[Dict[int, int]] = []

                def flush_bulk() -> None:
                    if bulk_pods:
                        rows_arr = np.asarray(bulk_rows, np.int64)
                        self.eps.apply_adds_bulk(rows_arr, bulk_pods, bulk_held)
                        self.nodes.apply_pod_deltas_bulk(rows_arr, bulk_pods)
                        self._pending_usage_rows.update(bulk_rows)
                        bulk_rows.clear()
                        bulk_pods.clear()
                        bulk_held.clear()

                for name, pod, sign in deltas:
                    if name in reencoded or name not in self.row_of:
                        continue
                    row = self.row_of[name]
                    held = self._node_sigs.setdefault(name, {})
                    if sign > 0 and not pod.host_ports():
                        bulk_rows.append(row)
                        bulk_pods.append(pod)
                        bulk_held.append(held)
                        continue
                    flush_bulk()
                    self.eps.apply_delta(row, pod, sign, held)
                    self.nodes.apply_pod_delta(row, pod, sign)
                    self._pending_usage_rows.add(row)
                    if pod.host_ports():
                        ports_dirty.add(name)
                flush_bulk()
                # the port table is a sorted list snapshot: refresh those
                # nodes' rows fully (rare)
                for name in ports_dirty:
                    ni = cache.snapshot.get(name)
                    if ni is None:
                        continue
                    row = self.row_of[name]
                    if not self.nodes.update_usage(row, ni):
                        self.nodes.set_node(row, ni)
                    self._pending_node_rows.add(row)
                if images_changed:
                    # spread scaling depends on cluster-wide image placement
                    # and node count → recompute the whole table (rare)
                    ImageTable(self.vocab).apply(self.nodes, cache.snapshot, self.row_of)
                    self._image_stale = True
            except KeySlotOverflow:  # SigOverflow included
                self._rebuild()
                return True
            return False

    def device_arrays(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(nodes, eps): the node bank and the signature bank as
        device-resident tensors, patched with only the rows sync() touched
        since the last call. The signature bank has two row spaces: its
        metadata (valid, ns_id, label_vals, deleting) is patched by dirty
        SIGNATURE rows, its node-major `counts` by dirty NODE rows (usage
        rows included: commits count pods into signatures). Full upload
        only after a rebuild (shape change)."""
        host = self.nodes.arrays()
        host_e = self.eps.arrays()
        if self._dev is None or self._device_stale:
            self._dev = arrays_to_torch(host, self.device, copy=True)
            self._dev_eps = arrays_to_torch(host_e, self.device, copy=True)
            self._device_stale = False
            self._image_stale = False
            self._pending_node_rows.clear()
            self._pending_usage_rows.clear()
            self.eps.dirty_sig_rows.clear()
            return self._dev, self._dev_eps
        if self._image_stale:
            # the table's width may have changed: ship it whole
            self._dev.update(arrays_to_torch({"image_scaled": host["image_scaled"]}, self.device, copy=True))
            self._image_stale = False
        node_rows = sorted(self._pending_node_rows)
        usage_rows = sorted(self._pending_usage_rows - self._pending_node_rows)
        count_rows = sorted(self._pending_usage_rows | self._pending_node_rows)
        self._patch_rows(self._dev, host, node_rows, tuple(k for k in host if k != "image_scaled"))
        self._patch_rows(self._dev, host, usage_rows, USAGE_KEYS)
        self._patch_rows(self._dev_eps, host_e, count_rows, ("counts",))
        self._patch_rows(self._dev_eps, host_e, sorted(self.eps.dirty_sig_rows),
                         tuple(k for k in host_e if k != "counts"))
        self.rows_shipped += len(node_rows) + len(usage_rows)
        self._pending_node_rows.clear()
        self._pending_usage_rows.clear()
        self.eps.dirty_sig_rows.clear()
        return self._dev, self._dev_eps

    def _patch_rows(self, dev: Dict[str, torch.Tensor], host: Dict[str, np.ndarray], rows: List[int], keys) -> None:
        """Overwrite `rows` of the device copy `dev` with host truth: one
        host→device slice and one index_copy_ per array (the counterpart
        of the reference's `_row_scatter_fn`)."""
        if not rows:
            return
        idx_np = np.asarray(rows, np.int64)
        idx = torch.from_numpy(idx_np).to(self.device)
        sliced = arrays_to_torch({k: host[k][idx_np] for k in keys}, self.device)
        for k, v in sliced.items():
            dev[k].index_copy_(0, idx, v)
