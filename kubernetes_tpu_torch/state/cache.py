"""Scheduler cache and the device-resident node bank.

The port's own lean copies of `kubernetes_tpu.state.cache`:

* `SchedulerCache` — authoritative in-memory cluster state with the
  assumed-pod state machine (pkg/scheduler/internal/cache/cache.go,
  interface.go:33-47): Initial → Assume → [bind] → Added, or Assume →
  Forget (bind failed) → Initial. Every mutation records what changed
  (dirty nodes, single-pod deltas) for the mirror.
* `TensorMirror` — keeps the host `NodeBank`, the existing pods'
  `SigBank` and their terms' `PatternBank` in sync with the cache,
  patching only DIRTY rows per cycle the way UpdateNodeInfoSnapshot walks
  its generation-ordered dirty list (cache.go:206-242), and keeps
  device-resident torch copies of all three. The copies are patched by
  dirty rows through the ingest plane's row scatter (ops/slab.scatter_batch:
  a sync's up to six patches — node rows, usage rows, and the signature
  and pattern banks' counts and metadata — packed straight from the host
  banks into pinned memory, one non-blocking copy and ONE launch of
  csrc/slab.cu) — the counterpart of the reference's jitted
  `_row_scatter_fn` — and uploaded in full only after a rebuild. With the fold plane a
  committed batch's deltas are scattered into the resident copies in place
  (`fold_commit`, ops/fold.fold_commit_banks), and sync does not make
  those rows pending, so they are not re-shipped. The preemption nominees'
  overlay is added onto the resident usage columns in place for one
  dispatch (`fold_nominees`, ops/fold.fold_usage) and taken off again by
  its exact integer inverse (`unfold_nominees`), which every other
  consumer of the resident banks calls first.

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
from ..ops.slab import ScatterProblem, scatter_batch
from .convert import arrays_to_torch
from .node_tree import NodeTree
from .terms import PatternBank, PatternOverflow
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

#: shipped-byte kinds whose payloads are predominantly node-major bank rows:
#: on a node mesh each shard holds 1/shards of them; everything else (fold
#: control arrays) is replicated to every shard in full (ref :69)
NODE_MAJOR_SHIP_KINDS = frozenset({"full", "rows", "usage", "warm"})


def per_shard_bytes(shipped: Dict[str, int], shards: int) -> Dict[str, int]:
    """The per-shard view of a {kind: bytes} shipping ledger (ref :75):
    node-major kinds split over the shards, the rest replicated. An
    approximation, as the reference's: the node-major kinds also carry
    small replicated metadata."""
    if not shards:
        return dict(shipped)
    return {k: (v // shards if k in NODE_MAJOR_SHIP_KINDS else v) for k, v in shipped.items()}


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
        # zone-interleaved iteration (internal/cache/node_tree.go) for the
        # host oracle's placement walk
        self.node_tree = NodeTree()
        self._pod_states: Dict[str, _PodState] = {}  # guarded by self._lock
        self._assumed: Set[str] = set()  # guarded by self._lock
        self.dirty_nodes: Set[str] = set()
        self.removed_nodes: Set[str] = set()
        # every change to the snapshot's nodes or their pods
        self.mutation_count = 0  # guarded by self._lock
        # (node, pod, ±1, folded) single-pod changes (assume/confirm/
        # remove) — the common event; consumed by TensorMirror.sync.
        # `folded` marks adds whose deltas a commit fold already applied
        # to the mirror's device banks: sync applies them to the host
        # banks the same way, but does not re-ship their rows
        self.pod_deltas: List[Tuple[str, Pod, int, bool]] = []

    # -- helpers -------------------------------------------------------------

    def _collapse_deltas_locked(self) -> None:
        """Bound the delta log: past the bound it collapses into the
        node-count-bounded dirty set (a re-encoded row ships in full)."""
        if len(self.pod_deltas) >= max(1024, 4 * len(self.snapshot.node_infos)):
            for n, _, _, _ in self.pod_deltas:
                self.dirty_nodes.add(n)
            self.pod_deltas.clear()

    def _add_pod_to_node(self, pod: Pod, folded: bool = False) -> None:
        self.mutation_count += 1
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
        self.pod_deltas.append((pod.node_name, pod, 1, folded))
        self._collapse_deltas_locked()

    def _remove_pod_from_node(self, pod: Pod) -> None:
        ni = self.snapshot.get(pod.node_name)
        if ni is None:
            return
        removed = ni.remove_pod_key(pod.key())
        if removed is not None:
            self.mutation_count += 1
            self.pod_deltas.append((pod.node_name, removed, -1, False))
            self._collapse_deltas_locked()

    # -- assumed pod state machine (cache.go:270-388) ------------------------

    def assume_pod(self, pod: Pod) -> None:
        """AssumePod: optimistically add to the target node before bind."""
        if self.assume_pods([pod]):
            raise ValueError(f"pod {pod.key()} already in cache")

    def assume_pods(self, pods: List[Pod], folded: bool = False) -> List[int]:
        """Bulk AssumePod under ONE lock. Returns the indices of pods
        REJECTED because their key is already in the cache — the caller
        fails those individually. `folded` tags the deltas as already
        applied to the device banks by a commit fold; the caller reports
        each rejected pod's node through TensorMirror.note_failed_fold
        (its fold lane landed with no host delta to match)."""
        rejected: List[int] = []
        with self._lock:
            for i, pod in enumerate(pods):
                key = pod.key()
                if key in self._pod_states:
                    rejected.append(i)
                    continue
                self._pod_states[key] = _PodState(pod=pod, assumed=True)
                self._assumed.add(key)
                self._add_pod_to_node(pod, folded)
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

    def forget_pods(self, pods: List[Pod]) -> None:
        """Bulk ForgetPod under one lock: the gang rollback's counterpart of
        assume_pods (commit/apply.GangRollbackRecord unwinds a whole group
        with one call). Pods not in the assumed state are skipped, exactly
        as forget_pod skips them."""
        with self._lock:
            for pod in pods:
                key = pod.key()
                st = self._pod_states.get(key)
                if st is None or not st.assumed:
                    continue
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
                self.node_tree.add_node(node)
            else:
                self.node_tree.update_node(ni.node, node)
                ni.node = node  # was a headless placeholder, or an update
            self.dirty_nodes.add(node.name)
            self.removed_nodes.discard(node.name)
            self.mutation_count += 1

    def update_node(self, node: Node) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        with self._lock:
            ni = self.snapshot.node_infos.pop(name, None)
            if ni is not None:
                self.node_tree.remove_node(ni.node)
                for p in ni.pods:
                    self._pod_states.pop(p.key(), None)
                    self._assumed.discard(p.key())
            self.dirty_nodes.discard(name)
            self.removed_nodes.add(name)
            self.mutation_count += 1

    def node_order(self) -> List[str]:
        """Zone-interleaved iteration order (NodeTree.order) for the host
        oracle's placement walk; nodes the tree does not know (headless
        placeholders) follow in insertion order."""
        with self._lock:
            order = [n for n in self.node_tree.order() if n in self.snapshot.node_infos]
            if len(order) != len(self.snapshot.node_infos):
                seen = set(order)
                order.extend(n for n in self.snapshot.node_infos if n not in seen)
            return order

    # -- counters ------------------------------------------------------------

    def pod_count(self) -> int:
        with self._lock:
            return len(self._pod_states)


class TensorMirror:
    """Keeps the `NodeBank`, the existing pods' `SigBank` and their terms'
    `PatternBank` patched from a SchedulerCache, plus their copies on
    `device`. Node rows come from a free list in snapshot order (the
    reference's allocation, so row indices — and with them every tie-break
    — match it); each node's pods are counted into label signatures and
    their (anti-)affinity terms into patterns, and `_node_sigs` /
    `_node_pats` hold each node's {row: count} maps so a re-encode or
    removal can release exactly what it added. Capacity overflow (more
    nodes than rows, more signatures or patterns than slots, label-key
    growth) rebuilds the banks at the next bucket size."""

    def __init__(self, cache: SchedulerCache, device: torch.device):
        self.cache = cache
        self.device = torch.device(device)
        self.vocab = Vocab()
        self.rebuild_count = -1  # the constructor's build doesn't count
        # distinct (ns, labels) signatures are workload-bounded (hundreds in
        # 100k-pod clusters): starting at 256 avoids a mid-drain rebuild
        self._min_sigs = 256
        # distinct term patterns are fewer still (one per controller spec
        # carrying affinity, not per replica)
        self._min_pats = 32
        self._dev: Optional[Dict[str, torch.Tensor]] = None
        self._dev_eps: Optional[Dict[str, torch.Tensor]] = None
        self._dev_pats: Optional[Dict[str, torch.Tensor]] = None
        self._device_stale = True
        self._image_stale = False
        self._pending_node_rows: Set[int] = set()  # whole rows to ship
        self._pending_usage_rows: Set[int] = set()  # USAGE_KEYS + sig counts
        # usage rows whose delta pod carried (anti-)affinity terms: only
        # those change the pattern counts
        self._pending_pat_rows: Set[int] = set()
        # the fold plane: nodes whose fold lane lost its assume (their rows
        # re-ship at the next sync). Rows a fold advanced are simply not
        # made pending.
        self._failed_fold_names: List[str] = []
        # (rows, vecs, cnt) tensors of the nominee overlay now added onto
        # the resident usage columns, or None
        self._nominee_overlay: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        # the node mesh the banks are split over (set_mesh) and its folds
        self._mesh = None
        self._sharded_folds = None
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
                self.pats = PatternBank(self.vocab, _bucket(self._min_pats), self.nodes.capacity)
                self._node_sigs: Dict[str, Dict[int, int]] = {}
                self._node_pats: Dict[str, Dict[int, int]] = {}
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
            except PatternOverflow:
                self._min_pats *= 4
            except KeySlotOverflow:
                continue  # vocab.config.key_slots already grew
        self.cache.dirty_nodes.clear()
        self.cache.removed_nodes.clear()
        self.cache.pod_deltas.clear()  # the rebuild re-counted everything
        self._device_stale = True  # shapes may have changed: full re-upload
        self._clear_pending()
        self._failed_fold_names.clear()

    def _clear_pending(self) -> None:
        """Forget the rows waiting to ship (after a full upload or a patch)."""
        self._pending_node_rows.clear()
        self._pending_usage_rows.clear()
        self._pending_pat_rows.clear()
        self.eps.dirty_sig_rows.clear()
        self.pats.dirty_pattern_rows.clear()

    @staticmethod
    def _image_signature(ni: NodeInfo):
        return frozenset(ni.image_sizes().items())

    def _release_node_pods(self, name: str) -> None:
        """Subtract a node's held signature and pattern counts (zeroing its
        counts rows) — before its row is freed or re-counted."""
        row = self.row_of.get(name)
        held = self._node_sigs.pop(name, None)
        held_p = self._node_pats.pop(name, None)
        if row is None:
            return
        if held:
            self.eps.release_node(row, held)
            self._pending_node_rows.add(row)
        if held_p:
            self.pats.release_node(row, held_p)
            self._pending_node_rows.add(row)

    def _encode_node_pods(self, name: str, ni: NodeInfo) -> None:
        """Count one node's pods into label signatures and their terms into
        patterns. Raises SigOverflow / PatternOverflow / KeySlotOverflow
        when a bank is full (the caller rebuilds bigger)."""
        row = self.row_of[name]
        self._node_sigs[name] = self.eps.encode_node(row, ni.pods)
        self._node_pats[name] = self.pats.encode_node(row, ni.pods_with_affinity())
        self._pending_node_rows.add(row)

    def sync(self) -> bool:
        """Apply dirty nodes (re-counting only their pods) plus single-pod
        deltas (O(1) each). Returns True if a full rebuild happened (the
        arrays may change shape)."""
        self.unfold_nominees()
        cache = self.cache
        with cache._lock:
            # fold lanes whose assume was rejected after the fold: their
            # device rows carry deltas the host never applied — host wins
            if self._failed_fold_names:
                names, self._failed_fold_names = self._failed_fold_names, []
                for nm in names:
                    row = self.row_of.get(nm)
                    if row is not None:
                        self._pending_usage_rows.add(row)
                        self._pending_pat_rows.add(row)
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
                # counts); removes, ported pods and pods with affinity take
                # the scalar path, flushing the batch first so per-node
                # order is kept (a remove must see the adds before it).
                # Folded adds update the host banks the same way, but do
                # not make their rows pending: the device already has them.
                reencoded = removed | dirty | set(new_nodes)
                ports_dirty: Set[str] = set()
                bulk_rows: List[int] = []
                bulk_pods: List[Pod] = []
                bulk_held: List[Dict[int, int]] = []
                bulk_folded: List[bool] = []

                def flush_bulk() -> None:
                    if bulk_pods:
                        rows_arr = np.asarray(bulk_rows, np.int64)
                        self.eps.apply_adds_bulk(rows_arr, bulk_pods, bulk_held)
                        self.nodes.apply_pod_deltas_bulk(rows_arr, bulk_pods)
                        self._pending_usage_rows.update(r for r, f in zip(bulk_rows, bulk_folded) if not f)
                        bulk_rows.clear()
                        bulk_pods.clear()
                        bulk_held.clear()
                        bulk_folded.clear()

                for name, pod, sign, folded in deltas:
                    if name in reencoded or name not in self.row_of:
                        continue
                    row = self.row_of[name]
                    held = self._node_sigs.setdefault(name, {})
                    if sign > 0 and not pod.host_ports() and not pod_has_affinity_constraints(pod):
                        bulk_rows.append(row)
                        bulk_pods.append(pod)
                        bulk_held.append(held)
                        bulk_folded.append(folded)
                        continue
                    flush_bulk()
                    self.eps.apply_delta(row, pod, sign, held)
                    # only adds fold (commits); any other delta ships
                    f = folded and sign > 0
                    if pod_has_affinity_constraints(pod):
                        self.pats.apply_delta(row, pod, sign, self._node_pats.setdefault(name, {}))
                        if not f:
                            self._pending_pat_rows.add(row)
                    self.nodes.apply_pod_delta(row, pod, sign)
                    if pod.host_ports():
                        # the port table changed too (list-shaped, not
                        # foldable): the full-row refresh below ships it
                        ports_dirty.add(name)
                        f = False
                    if not f:
                        self._pending_usage_rows.add(row)
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
            except KeySlotOverflow:  # SigOverflow and PatternOverflow included
                self._rebuild()
                return True
            return False

    def device_arrays(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(nodes, eps, pats): the node, signature and pattern banks as
        device-resident tensors, patched with only the rows sync() touched
        since the last call, minus the rows a commit fold already applied
        on the device. The signature and pattern banks have two row
        spaces each: their metadata is patched by dirty SIGNATURE /
        PATTERN rows, their node-major `counts` by dirty NODE rows (usage
        rows included for signatures: commits count pods into them; for
        patterns only the rows whose delta pods carried affinity). Full
        upload only after a rebuild (shape change)."""
        self.unfold_nominees()
        host = self.nodes.arrays()
        host_e = self.eps.arrays()
        host_p = self.pats.arrays()
        if self._dev is None or self._device_stale:
            self._dev = arrays_to_torch(host, self.device, copy=True)
            self._dev_eps = arrays_to_torch(host_e, self.device, copy=True)
            self._dev_pats = arrays_to_torch(host_p, self.device, copy=True)
            self._device_stale = False
            self._image_stale = False
            self._clear_pending()
            return self._dev, self._dev_eps, self._dev_pats
        if self._image_stale:
            # the table's width may have changed: ship it whole
            self._dev.update(arrays_to_torch({"image_scaled": host["image_scaled"]}, self.device, copy=True))
            self._image_stale = False
        node_rows = sorted(self._pending_node_rows)
        usage_rows = sorted(self._pending_usage_rows - self._pending_node_rows)
        count_rows = sorted(self._pending_usage_rows | self._pending_node_rows)
        # the sync's patches, disjoint by construction (usage rows exclude
        # node rows; counts and metadata are different arrays): ONE scatter
        patches = [ScatterProblem(self._dev, node_rows, host, tuple(k for k in host if k != "image_scaled")),
                   ScatterProblem(self._dev, usage_rows, host, USAGE_KEYS)]
        for dev, host_b, meta_rows, cnt_rows in (
            (self._dev_eps, host_e, self.eps.dirty_sig_rows, count_rows),
            (self._dev_pats, host_p, self.pats.dirty_pattern_rows,
             self._pending_pat_rows | self._pending_node_rows),
        ):
            patches.append(ScatterProblem(dev, sorted(cnt_rows), host_b, ("counts",)))
            patches.append(ScatterProblem(dev, sorted(meta_rows), host_b, tuple(k for k in host_b if k != "counts")))
        scatter_batch(patches)
        self.rows_shipped += len(node_rows) + len(usage_rows)
        self._clear_pending()
        return self._dev, self._dev_eps, self._dev_pats

    # -- the fold plane (ops/fold, commit/fold) ------------------------------

    def set_mesh(self, mesh) -> None:
        """Split the device banks over `mesh`'s node shards (ref :1239):
        shard s owns rows [s * Nl, (s + 1) * Nl) of each node-major tensor,
        which on one card stays one tensor. Commit folds and the nominee
        overlay then go through the sharded folds
        (ops/fold.make_sharded_fold_fns)."""
        self._mesh = mesh
        self._sharded_folds = None  # rebuilt for the new mesh on demand
        self.mark_device_stale()

    def can_fold(self) -> bool:
        """The device banks are resident and current-shaped: a commit fold
        may scatter into them. On a mesh, only while the node capacity
        divides into its shards, the sharded solve's own rule (ref :1578);
        otherwise the host patches the rows."""
        if self._dev is None or self._device_stale:
            return False
        if self._mesh is None:
            return True
        from ..parallel.mesh import node_shards

        shards = node_shards(self._mesh)
        return shards > 0 and self.nodes.capacity % shards == 0

    def _fold_fns(self):
        """(commit fold, usage fold) for the banks' layout: the
        single-device kernels, or the mesh's sharded twins (ref :1592)."""
        if self._mesh is None:
            from ..ops.fold import fold_commit_banks, fold_usage

            return fold_commit_banks, fold_usage
        if self._sharded_folds is None:
            from ..ops.fold import make_sharded_fold_fns

            self._sharded_folds = make_sharded_fold_fns(self._mesh)
        return self._sharded_folds

    def mark_device_stale(self) -> None:
        """Re-upload the full banks from host truth at the next
        device_arrays() (host wins); an overlay on the old copy goes with
        it."""
        self._device_stale = True
        self._nominee_overlay = None

    def fold_commit(self, prog) -> bool:
        """Apply a planned commit fold (commit/fold.FoldProgram) to the
        resident banks in place: fold_commit_banks writes into the same
        storages device_arrays() returns. Returns False when the banks are
        not resident (the caller's assumes then ship as pending rows). A
        kernel that fails to launch raises; the banks are then marked
        stale (a partial fold never survives an upload)."""
        if not self.can_fold():
            return False
        self.unfold_nominees()
        n, e, p = self._dev, self._dev_eps, self._dev_pats
        ctl = arrays_to_torch({
            "rows": prog.rows, "req": prog.req, "nz": prog.nz, "cnt": prog.cnt, "sig": prog.sig,
            "pat_row": prog.pat_row, "pat_col": prog.pat_col, "pat_cnt": prog.pat_cnt,
        }, self.device)
        fold_commit_banks, _ = self._fold_fns()
        try:
            fold_commit_banks(n["requested"], n["nonzero_req"], n["pod_count"], e["counts"], p["counts"], **ctl)
        except Exception:
            self.mark_device_stale()
            raise
        return True

    def note_failed_fold(self, node_name: str) -> None:
        """A fold lane's assume was rejected after the fold landed: queue
        the node's row for a host-wins re-ship at the next sync."""
        self._failed_fold_names.append(node_name)

    # -- the preemption nominees' overlay (ops/fold.fold_usage) ---------------

    def fold_nominees(self, rows: np.ndarray, vecs: np.ndarray, cnt: np.ndarray) -> Dict[str, torch.Tensor]:
        """Add the out-of-batch nominees' requests and pod counts onto the
        resident usage columns IN PLACE (podFitsOnNode's pass-1 nominee
        accounting for one dispatch) and record the overlay, which
        `unfold_nominees` takes off by the exact integer inverse. Rows out
        of range add nothing. Returns the node
        bank (the same tensors device_arrays() returned). A kernel that
        fails marks the banks stale (host wins) and raises."""
        _, fold_usage = self._fold_fns()
        self.unfold_nominees()
        n = self._dev
        ov = tuple(arrays_to_torch({"rows": rows, "vecs": vecs, "cnt": cnt}, self.device).values())
        try:
            fold_usage(n["requested"], n["pod_count"], *ov)
        except Exception:
            self.mark_device_stale()
            raise
        self._nominee_overlay = ov
        return n

    def unfold_nominees(self) -> None:
        """Take the nominee overlay, if any, off the resident usage columns
        (negated vectors and counts: integer adds invert exactly). Every
        other consumer of the resident banks calls this first (the
        reference's `_restore_nominees`)."""
        ov = self._nominee_overlay
        if ov is None:
            return
        self._nominee_overlay = None
        rows, vecs, cnt = ov
        n = self._dev
        _, fold_usage = self._fold_fns()
        try:
            fold_usage(n["requested"], n["pod_count"], rows, -vecs, -cnt)
        except Exception:
            self.mark_device_stale()
            raise
