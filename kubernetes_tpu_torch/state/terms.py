"""Flat term tables: the sparse encoding of topology spread constraints,
pod (anti-)affinity terms and spreading selectors — the port's copy of
`kubernetes_tpu.state.terms`, with the existing pods' PatternBank.

The reference precomputes per-pod topology-pair maps (predicates/metadata.go
topologyPairsMaps, evenPodsSpreadMetadata) with nested hash maps. Here every
term — an (owner, topology-key-slot, namespace-set, label-selector) tuple —
becomes one ROW of a padded table; matching a term against all existing-pod
signatures is then one broadcast integer compare (ops/topology.match_terms),
and per-topology-value aggregation is a segment sum keyed by the dense value
index (NodeBank.label_dense).

Term kinds of the incoming batch: AFF_REQ, ANTI_REQ (Filter), AFF_PREF,
ANTI_PREF (Score), SPREAD_HARD (Filter), SPREAD_SOFT (Score), SEL_SPREAD
(Score). The owner of a term is its pod's spec row. Existing pods' AFF_*/
ANTI_* terms are collapsed to distinct patterns with per-node instance
counts (PatternBank), the symmetric side matched against incoming pods.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api.selectors import match_label_selector
from ..api.types import LabelSelector, Pod, PodAffinityTerm
from ..oracle.predicates import (
    get_hard_spread_constraints,
    get_pod_affinity_terms,
    get_pod_anti_affinity_terms,
    get_soft_spread_constraints,
    pod_matches_all_term_properties,
)
from .tensors import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    OP_NEVER,
    OP_NOT_IN,
    KeySlotOverflow,
    Vocab,
    _bucket,
)

# term kinds
AFF_REQ = 1
ANTI_REQ = 2
AFF_PREF = 3
ANTI_PREF = 4
SPREAD_HARD = 5
SPREAD_SOFT = 6
SEL_SPREAD = 7


@dataclass
class TermBank:
    """Padded term rows + compiled label selectors."""

    vocab: Vocab
    capacity: int
    ns_cap: int = 4  # namespaces per term
    ml_cap: int = 4  # matchLabels pairs per selector
    ex_cap: int = 4  # matchExpressions per selector
    val_cap: int = 6  # values per expression

    def __post_init__(self):
        t = self.capacity
        self.key_capacity = self.vocab.config.key_slots
        self.valid = np.zeros(t, bool)
        self.kind = np.zeros(t, np.int32)
        self.owner = np.zeros(t, np.int32)
        self.weight = np.zeros(t, np.int32)  # pref weight / maxSkew
        self.topo_slot = np.full(t, -1, np.int32)
        self.self_match = np.zeros(t, bool)  # spread: selector matches owner pod
        self.ns_any = np.zeros(t, bool)
        self.ns_ids = np.zeros((t, self.ns_cap), np.int32)
        self.has_selector = np.zeros(t, bool)  # nil selector matches nothing
        self.ml_slot = np.full((t, self.ml_cap), -1, np.int32)
        self.ml_val = np.zeros((t, self.ml_cap), np.int32)
        self.ex_op = np.zeros((t, self.ex_cap), np.int32)
        self.ex_slot = np.full((t, self.ex_cap), -1, np.int32)
        self.ex_vals = np.full((t, self.ex_cap, self.val_cap), -1, np.int32)
        self.count = 0
        self.overflow_owners: set = set()

    def _compile_selector(self, row: int, sel: Optional[LabelSelector]) -> None:
        v = self.vocab
        if sel is None:
            self.has_selector[row] = False
            return
        self.has_selector[row] = True
        ml = list(sel.match_labels.items())
        if len(ml) > self.ml_cap:
            self.overflow_owners.add(int(self.owner[row]))
        for j, (k, val) in enumerate(ml[: self.ml_cap]):
            s = v.slot_of_key(k)
            if s >= self.key_capacity:
                raise KeySlotOverflow()
            self.ml_slot[row, j] = s
            self.ml_val[row, j] = v.id(val)
        exprs = sel.match_expressions
        if len(exprs) > self.ex_cap:
            self.overflow_owners.add(int(self.owner[row]))
        op_map = {"In": OP_IN, "NotIn": OP_NOT_IN, "Exists": OP_EXISTS, "DoesNotExist": OP_DOES_NOT_EXIST}
        for j, e in enumerate(exprs[: self.ex_cap]):
            op = op_map.get(e.operator, OP_NEVER)
            # In/NotIn with no values is invalid (selector parse error →
            # matches nothing, LabelSelectorAsSelector error path)
            if op in (OP_IN, OP_NOT_IN) and not e.values:
                op = OP_NEVER
            self.ex_op[row, j] = op
            s = v.slot_of_key(e.key)
            if s >= self.key_capacity:
                raise KeySlotOverflow()
            self.ex_slot[row, j] = s
            if len(e.values) > self.val_cap:
                self.overflow_owners.add(int(self.owner[row]))
            for k_idx, val in enumerate(e.values[: self.val_cap]):
                self.ex_vals[row, j, k_idx] = v.id(val)

    def add(
        self,
        kind: int,
        owner: int,
        topo_key: str,
        selector: Optional[LabelSelector],
        namespaces: Sequence[str] = (),
        ns_any: bool = False,
        weight: int = 0,
        self_match: bool = False,
    ) -> int:
        row = self.count
        if row >= self.capacity:
            self.overflow_owners.add(owner)
            return -1
        self.count += 1
        self.set_row(row, kind, owner, topo_key, selector, namespaces, ns_any, weight, self_match)
        return row

    def set_row(
        self,
        row: int,
        kind: int,
        owner: int,
        topo_key: str,
        selector: Optional[LabelSelector],
        namespaces: Sequence[str] = (),
        ns_any: bool = False,
        weight: int = 0,
        self_match: bool = False,
    ) -> None:
        """Encode one term at an explicit row."""
        v = self.vocab
        self.valid[row] = True
        self.kind[row] = kind
        self.owner[row] = owner
        self.weight[row] = weight
        self.self_match[row] = self_match
        if topo_key:
            s = v.slot_of_key(topo_key)
            if s >= self.key_capacity:
                raise KeySlotOverflow()
            self.topo_slot[row] = s
        self.ns_any[row] = ns_any
        if not ns_any:
            nss = list(namespaces)
            if len(nss) > self.ns_cap:
                self.overflow_owners.add(owner)
            for j, ns in enumerate(nss[: self.ns_cap]):
                self.ns_ids[row, j] = v.id(ns)
        self._compile_selector(row, selector)

    def clear_row(self, row: int) -> None:
        """Reset a row to padding (every kernel gates on `valid`; the other
        fields are reset so re-use starts from a clean slate)."""
        self.valid[row] = False
        self.kind[row] = 0
        self.owner[row] = 0
        self.weight[row] = 0
        self.self_match[row] = False
        self.topo_slot[row] = -1
        self.ns_any[row] = False
        self.ns_ids[row] = 0
        self.has_selector[row] = False
        self.ml_slot[row] = -1
        self.ml_val[row] = 0
        self.ex_op[row] = 0
        self.ex_slot[row] = -1
        self.ex_vals[row] = -1

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "valid": self.valid,
            "kind": self.kind,
            "owner": self.owner,
            "weight": self.weight,
            "topo_slot": self.topo_slot,
            "self_match": self.self_match,
            "ns_any": self.ns_any,
            "ns_ids": self.ns_ids,
            "has_selector": self.has_selector,
            "ml_slot": self.ml_slot,
            "ml_val": self.ml_val,
            "ex_op": self.ex_op,
            "ex_slot": self.ex_slot,
            "ex_vals": self.ex_vals,
        }


def _term_namespaces(owner_pod: Pod, term: PodAffinityTerm) -> List[str]:
    return list(term.namespaces) if term.namespaces else [owner_pod.namespace]


def encode_pod_terms(
    pod: Pod, selectors: Optional[List[LabelSelector]] = None
) -> Tuple[List[tuple], Dict[str, int]]:
    """ONE pod's topology-coupled structure as explicit term-row argument
    tuples plus its aux bits, in the reference's canonical row order.

    Returns (rows, aux): rows is a list of
    (kind, topo_key, selector, namespaces, ns_any, weight, self_match)
    tuples — TermBank.set_row's arguments minus the row/owner — in order:
    hard spread, soft spread, required affinity, required anti-affinity,
    preferred affinity, preferred anti-affinity, spreading selectors.
    aux holds the per-pod scalars of compile_batch_terms's aux arrays."""
    rows: List[tuple] = []
    aux = {
        "self_aff_match": False,
        "has_aff": False,
        "has_anti": False,
        "n_sel_spread": 0,
    }
    for c in get_hard_spread_constraints(pod):
        rows.append((
            SPREAD_HARD, c.topology_key, c.label_selector, (pod.namespace,),
            False, c.max_skew,
            match_label_selector(c.label_selector, pod.labels),
        ))
    for c in get_soft_spread_constraints(pod):
        # the soft-spread priority counts matching pods in ALL namespaces
        # (even_pods_spread.go quirk, see oracle.priorities)
        rows.append((
            SPREAD_SOFT, c.topology_key, c.label_selector, (),
            True, c.max_skew,
            match_label_selector(c.label_selector, pod.labels),
        ))
    aff_terms = get_pod_affinity_terms(pod.affinity)
    if aff_terms:
        aux["has_aff"] = True
        aux["self_aff_match"] = pod_matches_all_term_properties(pod, pod, aff_terms)
    for t in aff_terms:
        rows.append((
            AFF_REQ, t.topology_key, t.label_selector,
            tuple(_term_namespaces(pod, t)), False, 0, False,
        ))
    anti_terms = get_pod_anti_affinity_terms(pod.affinity)
    if anti_terms:
        aux["has_anti"] = True
    for t in anti_terms:
        rows.append((
            ANTI_REQ, t.topology_key, t.label_selector,
            tuple(_term_namespaces(pod, t)), False, 0, False,
        ))
    a = pod.affinity
    if a is not None and a.pod_affinity is not None:
        for w in a.pod_affinity.preferred:
            if w.weight and w.pod_affinity_term.topology_key:
                t = w.pod_affinity_term
                rows.append((
                    AFF_PREF, t.topology_key, t.label_selector,
                    tuple(_term_namespaces(pod, t)), False, w.weight, False,
                ))
    if a is not None and a.pod_anti_affinity is not None:
        for w in a.pod_anti_affinity.preferred:
            if w.weight and w.pod_affinity_term.topology_key:
                t = w.pod_affinity_term
                rows.append((
                    ANTI_PREF, t.topology_key, t.label_selector,
                    tuple(_term_namespaces(pod, t)), False, -w.weight, False,
                ))
    for sel in selectors or ():
        rows.append((SEL_SPREAD, "", sel, (pod.namespace,), False, 0, False))
        aux["n_sel_spread"] += 1
    return rows, aux


def count_pod_terms(pod: Pod, selectors: Optional[List[LabelSelector]] = None) -> int:
    """Exact row count encode_pod_terms would produce, without the
    selector-match work — the driver sizes its monotone term bucket from
    this BEFORE compiling."""
    n = len(get_hard_spread_constraints(pod)) + len(get_soft_spread_constraints(pod))
    n += len(get_pod_affinity_terms(pod.affinity))
    n += len(get_pod_anti_affinity_terms(pod.affinity))
    a = pod.affinity
    if a is not None and a.pod_affinity is not None:
        n += sum(
            1 for w in a.pod_affinity.preferred
            if w.weight and w.pod_affinity_term.topology_key
        )
    if a is not None and a.pod_anti_affinity is not None:
        n += sum(
            1 for w in a.pod_anti_affinity.preferred
            if w.weight and w.pod_affinity_term.topology_key
        )
    return n + len(selectors or ())


def count_batch_terms(
    pods: Sequence[Pod],
    spread_selectors: Optional[Dict[int, List[LabelSelector]]] = None,
) -> int:
    return sum(
        count_pod_terms(p, (spread_selectors or {}).get(id(p)) or None)
        for p in pods
    )


def compile_batch_terms(
    vocab: Vocab,
    pods: Sequence[Pod],
    spread_selectors: Optional[Dict[int, List[LabelSelector]]] = None,
    capacity: Optional[int] = None,
    b_capacity: Optional[int] = None,
) -> Tuple[TermBank, Dict[str, np.ndarray]]:
    """Compile all topology-coupled structure of a pending-pod batch into one
    TermBank + per-pod aux arrays:
      self_aff_match[b]: pod matches its own required affinity terms' props
                         (the first-pod-in-series escape hatch)
      has_aff[b] / has_anti[b]: pod has required (anti-)affinity terms
      n_sel_spread[b]: number of spreading selectors (0 → score 0 rule)
    """
    encoded = [
        encode_pod_terms(p, (spread_selectors or {}).get(id(p), []) or [])
        for p in pods
    ]
    n_terms = sum(len(rows) for rows, _ in encoded)
    # `capacity` is a floor, not a trust: clamping to the exact count keeps
    # a caller's count_pod_terms sizing honest (a short bank would push
    # the tail rows into overflow_owners)
    bank = TermBank(vocab, max(capacity or 0, _bucket(max(n_terms, 1))))
    b_count = b_capacity or _bucket(len(pods))
    self_aff_match = np.zeros(b_count, bool)
    has_aff = np.zeros(b_count, bool)
    has_anti = np.zeros(b_count, bool)
    n_sel_spread = np.zeros(b_count, np.int32)
    for b, (rows, a) in enumerate(encoded):
        for kind, topo, sel, nss, ns_any, weight, sm in rows:
            bank.add(
                kind, b, topo, sel, namespaces=nss, ns_any=ns_any,
                weight=weight, self_match=sm,
            )
        self_aff_match[b] = a["self_aff_match"]
        has_aff[b] = a["has_aff"]
        has_anti[b] = a["has_anti"]
        n_sel_spread[b] = a["n_sel_spread"]
    aux = {
        "self_aff_match": self_aff_match,
        "has_aff": has_aff,
        "has_anti": has_anti,
        "n_sel_spread": n_sel_spread,
    }
    return bank, aux


class PatternOverflow(KeySlotOverflow):
    """Pattern bank out of rows — rebuild at the next bucket size."""


@dataclass
class PatternBank:
    """Existing pods' (anti-)affinity terms collapsed to distinct PATTERNS
    with per-node instance counts — the term-side analogue of
    tensors.SigBank. The inter-pod programs need only whether a term
    matches the incoming pod and how many instances of it live in each
    topology bucket, both functions of the term's content, so rows are
    patterns interned by (kind, topology key, namespaces, weight, selector)
    and ownership is `counts[node, pattern]`, patched by dirty node rows
    like SigBank.counts. Free rows are taken from row 0 upward, as the
    reference takes them, so the bank's contents match it row for row.

    Wire format (`arrays()`): the TermBank fields (`owner` is the row's own
    index, unused by the kernels) + `counts` [N, PT] int16.
    """

    vocab: Vocab
    capacity: int  # PT
    node_capacity: int  # N rows of the counts matrix
    hard_pod_affinity_weight: int = 1  # interpod_affinity.go:131

    def __post_init__(self):
        self.bank = TermBank(self.vocab, self.capacity)
        self.counts = np.zeros((self.node_capacity, self.capacity), np.int16)
        self._row_of: Dict[tuple, int] = {}
        self._key_of_row: Dict[int, tuple] = {}
        self._refs = np.zeros(self.capacity, np.int64)
        self._free = list(range(self.capacity - 1, -1, -1))
        self.dirty_pattern_rows: set = set()
        self.overflow_rows: set = set()

    # numpy views used by the driver's term-kind gating
    @property
    def valid(self) -> np.ndarray:
        return self.bank.valid

    @property
    def kind(self) -> np.ndarray:
        return self.bank.kind

    def _pod_patterns(self, pod: Pod) -> List[tuple]:
        """One pod's term contents as intern keys' raw args: required anti
        terms, required affinity terms (at the hard weight), preferred
        affinity and preferred anti-affinity terms (negative weight)."""
        aff = pod.affinity
        if aff is None:
            return []
        out = []
        for t in get_pod_anti_affinity_terms(aff):
            out.append((ANTI_REQ, t.topology_key, t.label_selector, _term_namespaces(pod, t), 0))
        hw = self.hard_pod_affinity_weight
        for t in get_pod_affinity_terms(aff):
            if hw > 0 and t.topology_key:
                out.append((AFF_REQ, t.topology_key, t.label_selector, _term_namespaces(pod, t), hw))
        if aff.pod_affinity is not None:
            for w in aff.pod_affinity.preferred:
                if w.weight and w.pod_affinity_term.topology_key:
                    t = w.pod_affinity_term
                    out.append((AFF_PREF, t.topology_key, t.label_selector, _term_namespaces(pod, t), w.weight))
        if aff.pod_anti_affinity is not None:
            for w in aff.pod_anti_affinity.preferred:
                if w.weight and w.pod_affinity_term.topology_key:
                    t = w.pod_affinity_term
                    out.append((ANTI_PREF, t.topology_key, t.label_selector, _term_namespaces(pod, t), -w.weight))
        return out

    @staticmethod
    def _key(kind: int, topo_key: str, selector, namespaces, weight: int) -> tuple:
        return (kind, topo_key, tuple(sorted(namespaces)), weight, repr(selector))

    def _intern(self, kind: int, topo_key: str, selector, namespaces, weight: int) -> int:
        key = self._key(kind, topo_key, selector, namespaces, weight)
        row = self._row_of.get(key)
        if row is None:
            if not self._free:
                raise PatternOverflow()
            row = self._free.pop()
            self.bank.clear_row(row)
            self.bank.overflow_owners.discard(row)
            self.bank.set_row(row, kind, row, topo_key, selector, namespaces, weight=weight)
            if row in self.bank.overflow_owners:
                # a truncated selector under/over-matches on the device
                self.overflow_rows.add(row)
            self._row_of[key] = row
            self._key_of_row[row] = key
            self.dirty_pattern_rows.add(row)
        return row

    def prepare_pod_rows(self, pod: Pod) -> List[int]:
        """Intern one pod's term patterns WITHOUT taking references — the
        commit fold's counterpart of SigBank.prepare_row: the rows where
        the later apply_delta will count this pod. Raises PatternOverflow
        / KeySlotOverflow like _intern."""
        return [self._intern(kind, topo, sel, nss, w) for kind, topo, sel, nss, w in self._pod_patterns(pod)]

    def _unref(self, row: int, n: int) -> None:
        self._refs[row] -= n
        if self._refs[row] <= 0:
            self._refs[row] = 0
            self.bank.clear_row(row)
            self.bank.overflow_owners.discard(row)
            self.overflow_rows.discard(row)
            key = self._key_of_row.pop(row, None)
            if key is not None:
                self._row_of.pop(key, None)
            self._free.append(row)
            self.dirty_pattern_rows.add(row)

    def release_node(self, node_row: int, held: Dict[int, int]) -> None:
        """Undo a node's contribution: `held` is its {pattern: count} map."""
        for row, n in held.items():
            self.counts[node_row, row] -= n
            self._unref(row, n)

    def apply_delta(self, node_row: int, pod: Pod, sign: int, held: Dict[int, int]) -> None:
        """One pod's term instances added (sign > 0) or removed on a node
        (the mirror's single-pod delta path). Raises KeySlotOverflow /
        PatternOverflow like encode_node; a remove of an unknown pattern
        escalates to a rebuild."""
        for kind, topo, sel, nss, w in self._pod_patterns(pod):
            if sign > 0:
                row = self._intern(kind, topo, sel, nss, w)
                held[row] = held.get(row, 0) + 1
                self._refs[row] += 1
                self.counts[node_row, row] += 1
            else:
                row = self._row_of.get(self._key(kind, topo, sel, nss, w))
                if row is None or held.get(row, 0) <= 0:
                    raise PatternOverflow()  # inconsistent books: rebuild
                held[row] -= 1
                if held[row] == 0:
                    del held[row]
                self.counts[node_row, row] -= 1
                self._unref(row, 1)

    def encode_node(self, node_row: int, pods) -> Dict[int, int]:
        """Count a node's pods' term instances into patterns → the
        {pattern: count} map the caller keeps for release_node. Raises
        KeySlotOverflow / PatternOverflow for the mirror's rebuild-bigger
        loop (partial references rolled back first)."""
        held: Dict[int, int] = {}
        try:
            for pod in pods:
                for kind, topo, sel, nss, w in self._pod_patterns(pod):
                    row = self._intern(kind, topo, sel, nss, w)
                    held[row] = held.get(row, 0) + 1
                    self._refs[row] += 1
                    self.counts[node_row, row] += 1
        except KeySlotOverflow:
            self.release_node(node_row, held)
            raise
        return held

    def arrays(self) -> Dict[str, np.ndarray]:
        out = self.bank.arrays()
        out["counts"] = self.counts
        return out
