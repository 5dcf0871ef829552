"""Topology programs: EvenPodsSpread, InterPodAffinity and SelectorSpread.

Port of `kubernetes_tpu/ops/topology.py`:
`match_terms` (term x signature selector and namespace match),
`spread_filter` (EvenPodsSpreadPredicate, predicates.go:1778: the
DoNotSchedule constraints),
`spread_score` (CalculateEvenPodsSpreadPriority, even_pods_spread.go:85),
`interpod_filter` (InterPodAffinityMatches, predicates.go:1269),
`interpod_score` (CalculateInterPodAffinityPriority, interpod_affinity.go:99)
and `selector_spread_score` (CalculateSpreadPriorityMap/Reduce,
selector_spreading.go). Terms are the sparse rows of state/terms.TermBank;
existing pods are the label signatures of state/tensors.SigBank with
per-node counts, so matching runs against S signature rows and the
per-node counts are one [TT, S] x [S, N] product; existing pods' own terms
are the patterns of state/terms.PatternBank with per-node instance
counts. Aggregation per topology
value is a segment sum keyed by the dense value index
(NodeBank.label_dense) into `n_buckets` (V) buckets; an index at or above
V is dropped from a sum and clamped in a gather, as the reference's
segment_sum and gather do.

On CUDA tensors each public function launches its hand-written kernel in
`csrc/topology.cu` (counted in `<function>.launches`); on CPU tensors it
runs the plain PyTorch version below, a straight port of the JAX
arithmetic. Any other device raises. The plain versions compute the
signature products in float64 (exact below 2^53: CUDA has no integer
matmul), so the same code runs on the card as the kernels' yardstick.

The reference's f32 products are exact only while every partial sum stays
below 2^24; the plain versions and the kernels sum in integers (float64
below 2^53 in the plain products), which give the same numbers there.
spread_filter can also return its metadata (candidate nodes, merged
per-(term, topology value) counts; `spread_hard_tables_plain`): the commit
arbiter replays the skew predicate on it with the batch's commits added.

The match launch also carries the batch's in-batch host-port table
(`match_terms_multi(..., ports=(spec rows, ids))`, the [U, U] pairwise
port_clash of the reference's `_inbatch_tensors`, whose plain version is
`filters.inbatch_port_conflict_plain`): the solve's in-batch tracking and
the commit arbiter read it beside the term x spec-row matches, so it rides
in the launch that makes those (`filters.inbatch_port_conflict` is its
port-only call).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..kernels import build
from ..state.terms import AFF_PREF, AFF_REQ, ANTI_PREF, ANTI_REQ, SEL_SPREAD, SPREAD_HARD, SPREAD_SOFT
from ..state.tensors import OP_DOES_NOT_EXIST, OP_EXISTS, OP_IN, OP_NEVER, OP_NOT_IN
from .filters import inbatch_port_conflict_plain

Arrays = Dict[str, torch.Tensor]

MAX_NODE_SCORE = 10
_BIG = 2**30


# ---------------------------------------------------------------------------
# plain PyTorch versions (the JAX arithmetic, op for op)
# ---------------------------------------------------------------------------


def match_terms_plain(terms: Arrays, labels: torch.Tensor, ns: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[TT, X]: does term t's (namespace set, label selector) match subject
    x? labels: [X, K] value-id rows; ns: [X] namespace ids, or None to skip
    the namespace test. metav1.LabelSelectorAsSelector semantics: a nil
    selector matches nothing, an empty one everything."""
    k = labels.shape[1]
    lt = labels.T
    ml_slot = terms["ml_slot"].clamp(0, k - 1).long()  # [TT, ML]
    vals_at = lt[ml_slot]  # [TT, ML, X]
    ml_ok = (terms["ml_slot"][..., None] < 0) | (vals_at == terms["ml_val"][..., None])
    sel_ok = ml_ok.all(dim=1)  # [TT, X]
    ex_vals_at = lt[terms["ex_slot"].clamp(0, k - 1).long()]  # [TT, EX, X]
    present = ex_vals_at != 0
    in_set = (ex_vals_at[..., None, :] == terms["ex_vals"][..., :, None]).any(dim=-2)
    op = terms["ex_op"][..., None]
    ex_ok = torch.ones_like(present)
    ex_ok = torch.where(op == OP_IN, present & in_set, ex_ok)
    ex_ok = torch.where(op == OP_NOT_IN, ~present | ~in_set, ex_ok)
    ex_ok = torch.where(op == OP_EXISTS, present, ex_ok)
    ex_ok = torch.where(op == OP_DOES_NOT_EXIST, ~present, ex_ok)
    ex_ok = torch.where(op == OP_NEVER, torch.zeros_like(present), ex_ok)
    sel_ok = sel_ok & ex_ok.all(dim=1) & terms["has_selector"][:, None]
    if ns is not None:
        ns_in = (ns[None, None, :] == terms["ns_ids"][..., None]).any(dim=1)  # [TT, X]
        sel_ok = sel_ok & (terms["ns_any"][:, None] | ns_in)
    return sel_ok & terms["valid"][:, None]


def _bucket_of(nodes: Arrays, slot: torch.Tensor):
    """Dense topology bucket of every node at per-term key slots [TT] →
    (bucket [TT, N] clipped ≥ 0, has_key [TT, N])."""
    dense = nodes["label_dense"]  # [N, K]
    b = dense.T[slot.clamp(0, dense.shape[1] - 1).long()]  # [TT, N]
    has = (b >= 0) & (slot[:, None] >= 0)
    return b.clamp(min=0), has


def _seg_sum(values: torch.Tensor, buckets: torch.Tensor, num: int) -> torch.Tensor:
    """Row-wise segment sum [TT, X] → [TT, num]; buckets ≥ num are
    dropped (jax.ops.segment_sum / one_hot semantics). Bool values sum as
    int32."""
    if values.dtype == torch.bool:
        values = values.to(torch.int32)
    keep = buckets < num
    out = torch.zeros(values.shape[0], num, dtype=values.dtype, device=values.device)
    return out.scatter_add_(1, torch.where(keep, buckets, 0).long(), torch.where(keep, values, 0))


def _sig_cnt_node(m_sig: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[T, S] matches x [N, S] per-node signature counts → [T, N] int32, as
    one float64 product (exact: the sums stay far below 2^53)."""
    return (m_sig.to(torch.float64) @ counts.to(torch.float64).T).to(torch.int32)


def _gather_rows(table: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """table [TT, V]; buckets [TT, X] → [TT, X], indices clamped to V - 1
    (the JAX gather's out-of-bounds rule)."""
    return torch.gather(table, 1, buckets.clamp(max=table.shape[1] - 1).long())


def _merge_same_key(terms: Arrays, mask: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum rows of `table` over terms sharing (owner, topo_slot) — the
    reference's per-(key, value) pair maps shared by constraints on the
    same topology key (metadata.go tpPairToMatchNum)."""
    same = (
        mask[:, None]
        & mask[None, :]
        & (terms["owner"][:, None] == terms["owner"][None, :])
        & (terms["topo_slot"][:, None] == terms["topo_slot"][None, :])
    )
    return (same.to(torch.float64) @ table.to(torch.float64)).to(table.dtype)


def _owner_index(owner: torch.Tensor, mask_t: torch.Tensor, b: int) -> torch.Tensor:
    """Owner row of each term, or b (the dropped row) outside the mask."""
    return torch.where(mask_t, owner, b).long()


def _scatter_and(ok_t: torch.Tensor, owner: torch.Tensor, mask_t: torch.Tensor, b: int) -> torch.Tensor:
    """AND of ok_t rows per owner → [b, N] (terms outside the mask add 1)."""
    contrib = torch.where(mask_t[:, None], ok_t, True).to(torch.int32)
    out = torch.ones(b + 1, ok_t.shape[1], dtype=torch.int32, device=ok_t.device)
    idx = _owner_index(owner, mask_t, b)[:, None].expand_as(contrib)
    return out.scatter_reduce_(0, idx, contrib, reduce="amin")[:b].to(torch.bool)


def _scatter_or(bad_t: torch.Tensor, owner: torch.Tensor, mask_t: torch.Tensor, b: int) -> torch.Tensor:
    """OR of bad_t rows per owner → [b, N] (rows with no masked term: 0)."""
    contrib = torch.where(mask_t[:, None], bad_t, False).to(torch.int32)
    out = torch.zeros(b + 1, bad_t.shape[1], dtype=torch.int32, device=bad_t.device)
    idx = _owner_index(owner, mask_t, b)[:, None].expand_as(contrib)
    return out.scatter_reduce_(0, idx, contrib, reduce="amax")[:b].to(torch.bool)


def _matchall_rows(m_sig: torch.Tensor, owner: torch.Tensor, mask_t: torch.Tensor, b: int) -> torch.Tensor:
    """[b, S]: the signatures matching EVERY masked term of the row (rows
    without such a term: all ones)."""
    contrib = torch.where(mask_t[:, None], m_sig, True).to(torch.int32)
    out = torch.ones(b + 1, m_sig.shape[1], dtype=torch.int32, device=m_sig.device)
    idx = _owner_index(owner, mask_t, b)[:, None].expand_as(contrib)
    return out.scatter_reduce_(0, idx, contrib, reduce="amin")[:b].to(torch.bool)


def _scatter_add(val_t: torch.Tensor, owner: torch.Tensor, mask_t: torch.Tensor, b: int) -> torch.Tensor:
    contrib = torch.where(mask_t[:, None], val_t, 0)
    out = torch.zeros(b + 1, val_t.shape[1], dtype=val_t.dtype, device=val_t.device)
    return out.index_add_(0, _owner_index(owner, mask_t, b), contrib)[:b]


def _owner_any(flag_t: torch.Tensor, owner: torch.Tensor, mask_t: torch.Tensor, b: int) -> torch.Tensor:
    """[b] bool: any masked term of the row has flag_t set."""
    out = torch.zeros(b + 1, dtype=torch.int32, device=flag_t.device)
    out.index_add_(0, _owner_index(owner, mask_t, b), (flag_t & mask_t).to(torch.int32))
    return out[:b] > 0


def spread_hard_tables_plain(
    nodes: Arrays, eps: Arrays, terms: Arrays, selector_mask: torch.Tensor, n_buckets: Optional[int] = None,
) -> Arrays:
    """EvenPodsSpread metadata on the device (metadata.go:399
    getEvenPodsSpreadMetadata) for the DoNotSchedule terms: candidate
    nodes per spec row [U, N] (the raw node selector, every hard topology
    key of the row present, a valid node), and per hard term the
    same-namespace matching pods on candidate nodes per topology value,
    summed over the row's terms on the same key [TT, V] (int32), with the
    values some candidate node carries [TT, V] (bool), their minimum count
    [TT] and whether any exists [TT]."""
    b, n = selector_mask.shape
    v = n_buckets or n
    hard = terms["valid"] & (terms["kind"] == SPREAD_HARD)
    owner = terms["owner"]
    bucket_n, haskey_n = _bucket_of(nodes, terms["topo_slot"])
    cand = selector_mask & _scatter_and(haskey_n, owner, hard, b) & nodes["valid"][None, :]
    # namespaces were compiled to [pod namespace] for hard constraints
    m_sig = match_terms_plain(terms, eps["label_vals"], eps["ns_id"]) & eps["valid"][None, :] & hard[:, None]
    cnt_node = _sig_cnt_node(m_sig, eps["counts"])  # [TT, N]
    cand_t = cand[owner.long()]
    pair_cnt = _seg_sum(torch.where(cand_t, cnt_node, 0), bucket_n, v)
    pair_present = _seg_sum(cand_t & haskey_n, bucket_n, v) > 0
    merged_cnt = _merge_same_key(terms, hard, pair_cnt)
    merged_present = _merge_same_key(terms, hard, pair_present.to(torch.int32)) > 0
    return {
        "cand": cand, "merged_cnt": merged_cnt, "merged_present": merged_present,
        "min_t": torch.where(merged_present, merged_cnt, _BIG).amin(dim=1),
        "any_pair_t": merged_present.any(dim=1),
    }


def spread_filter_plain(
    nodes: Arrays, eps: Arrays, terms: Arrays, selector_mask: torch.Tensor, n_buckets: Optional[int] = None,
    with_tables: bool = False,
):
    """EvenPodsSpreadPredicate (predicates.go:1778), [U, N] bool: for each
    DoNotSchedule constraint of the pod, the node carries the key and its
    value's matching count + self-match - the minimum over values is at
    most max_skew (the term's weight); a pod whose constraints see no
    value at all passes (an empty pair map, predicates.go:1800).
    `selector_mask` is the RAW PodMatchNodeSelector matrix. With
    `with_tables`, the pair (mask, spread_hard_tables_plain's tables)."""
    b = selector_mask.shape[0]
    hard = terms["valid"] & (terms["kind"] == SPREAD_HARD)
    owner = terms["owner"]
    bucket_n, haskey_n = _bucket_of(nodes, terms["topo_slot"])
    tb = spread_hard_tables_plain(nodes, eps, terms, selector_mask, n_buckets)
    match_num = torch.where(_gather_rows(tb["merged_present"], bucket_n),
                            _gather_rows(tb["merged_cnt"], bucket_n), 0)  # [TT, N]
    self_m = terms["self_match"].to(torch.int32)[:, None]
    skew_ok = match_num + self_m - tb["min_t"][:, None] <= terms["weight"][:, None]
    ok = _scatter_and(haskey_n & skew_ok, owner, hard, b)
    any_pair = _owner_any(tb["any_pair_t"], owner, hard, b)
    mask = ok | ~any_pair[:, None]
    return (mask, tb) if with_tables else mask


def spread_score_plain(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, selector_mask: torch.Tensor,
    n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """CalculateEvenPodsSpreadPriority: member nodes carry all of the pod's
    soft topology keys; counts accumulate over member nodes that also pass
    the pod's node selector; score = 10*(total-count)/(total-min); counts
    span all namespaces (the reference's quirk). [U, N] int64."""
    b, n = selector_mask.shape
    v = n_buckets or n
    soft = terms["valid"] & (terms["kind"] == SPREAD_SOFT)
    owner = terms["owner"]
    has_soft = _owner_any(soft, owner, soft, b)

    bucket_n, haskey_n = _bucket_of(nodes, terms["topo_slot"])
    member = _scatter_and(haskey_n, owner, soft, b) & nodes["valid"][None, :]  # [U, N]
    counting = member & selector_mask

    m_sig = match_terms_plain(terms, eps["label_vals"], None) & eps["valid"][None, :] & soft[:, None]
    cnt_node = _sig_cnt_node(m_sig, eps["counts"])
    own = owner.long()
    counting_t = counting[own]
    member_t = member[own]
    pair_cnt = _seg_sum(torch.where(counting_t, cnt_node, 0), bucket_n, v)
    pair_present = _seg_sum(member_t & haskey_n, bucket_n, v) > 0

    merged_cnt = _merge_same_key(terms, soft, pair_cnt)
    merged_present = _merge_same_key(terms, soft, pair_present.to(torch.int32)) > 0

    node_cnt_t = torch.where(
        haskey_n & _gather_rows(merged_present, bucket_n), _gather_rows(merged_cnt, bucket_n), 0
    )
    node_cnt = _scatter_add(node_cnt_t, owner, soft, b)  # [U, N] int32

    # the reference's sum promotes int32 to int64 (jnp.sum under x64)
    total = torch.where(member, node_cnt, 0).sum(dim=1, dtype=torch.int64)
    min_cnt = torch.where(member, node_cnt, _BIG).amin(dim=1)
    min_cnt = torch.where(member.any(dim=1), min_cnt, 0)
    diff = total - min_cnt
    f = torch.where(
        diff[:, None] > 0,
        torch.div(MAX_NODE_SCORE * (total[:, None] - node_cnt), diff.clamp(min=1)[:, None],
                  rounding_mode="floor"),
        MAX_NODE_SCORE,
    )
    return torch.where(member & has_soft[:, None], f, 0)


def selector_spread_score_plain(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, n_buckets: Optional[int] = None,
    m_sig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CalculateSpreadPriorityMap/Reduce: count same-namespace,
    non-deleting pods matching ALL of the pod's controller selectors; blend
    1/3 node level + 2/3 zone level in float64, fewer is better; truncate.
    [U, N] int64. `m_sig`: the raw match_terms(terms, signature labels,
    signature namespaces), computed here when None."""
    b = aux["n_sel_spread"].shape[0]
    n = nodes["valid"].shape[0]
    v = n_buckets or n
    ss = terms["valid"] & (terms["kind"] == SEL_SPREAD)
    owner = terms["owner"]
    m_sig = _term_matches(terms, eps, m_sig)  # ns compiled = pod ns
    # AND across the pod's selectors, at the signature level
    matchall = _matchall_rows(m_sig, owner, ss, b)
    matchall = matchall & eps["valid"][None, :] & ~eps["deleting"][None, :]
    matchall = matchall & (aux["n_sel_spread"] > 0)[:, None]
    counts = _sig_cnt_node(matchall, eps["counts"]).to(torch.int64)  # [U, N]
    counts = torch.where(nodes["valid"][None, :], counts, 0)

    max_node = counts.amax(dim=1)
    zone_ok = (nodes["zone_dense"] >= 0) & nodes["valid"]
    zbucket = nodes["zone_dense"].clamp(min=0)
    zc_in = torch.where(zone_ok[None, :], counts, 0)
    zcounts = _seg_sum(zc_in, zbucket[None, :].expand_as(zc_in), v)  # [U, V]
    max_zone = zcounts.amax(dim=1)
    have_zones = zone_ok.any()

    ten = torch.tensor(float(MAX_NODE_SCORE), dtype=torch.float64, device=counts.device)
    fscore = torch.where(
        max_node[:, None] > 0,
        MAX_NODE_SCORE * (max_node[:, None] - counts).to(torch.float64)
        / max_node.clamp(min=1)[:, None].to(torch.float64),
        ten,
    )
    zscore = torch.where(
        max_zone[:, None] > 0,
        MAX_NODE_SCORE * (max_zone[:, None] - zcounts).to(torch.float64)
        / max_zone.clamp(min=1)[:, None].to(torch.float64),
        ten,
    )
    node_z = torch.gather(zscore, 1, zbucket.clamp(max=v - 1)[None, :].expand(b, n).long())
    blended = torch.where(
        have_zones & zone_ok[None, :],
        fscore * (1.0 / 3.0) + (2.0 / 3.0) * node_z,
        fscore,
    )
    return blended.to(torch.int64)


def _term_matches(terms: Arrays, eps: Arrays, m_sig: Optional[torch.Tensor]) -> torch.Tensor:
    """The raw batch terms x signatures match [TT, S] with the namespace
    test: `m_sig` where given (a batch's match plan), else computed."""
    return match_terms_plain(terms, eps["label_vals"], eps["ns_id"]) if m_sig is None else m_sig


def _pattern_matches(ex_terms: Arrays, pods: Arrays, m_pt: Optional[torch.Tensor]) -> torch.Tensor:
    """The raw patterns x spec rows match [PT, U] with the namespace test:
    `m_pt` where given, else computed."""
    return match_terms_plain(ex_terms, pods["label_vals"], pods["ns_id"]) if m_pt is None else m_pt


FILTER_PARTS = ("existing", "aff", "anti")
SCORE_PARTS = ("pref", "existing")


def interpod_filter_plain(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, ex_terms: Arrays, pods: Arrays,
    parts: tuple = FILTER_PARTS, n_buckets: Optional[int] = None,
    m_pt: Optional[torch.Tensor] = None, m_sig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """InterPodAffinityMatches (predicates.go:1269), metadata path, [U, N]:
      "existing"  existing pods' required anti-affinity (PatternBank)
                  blocks the same-topology nodes of the pods it matches;
      "aff"       the pod's required affinity: a node must share a
                  topology value with an existing pod matching ALL its
                  terms (first-pod-in-series escape when none exists);
      "anti"      the pod's required anti-affinity: a node sharing a
                  topology value with a matching existing pod fails.
    A part left out contributes its term-absent identity (pass). `m_pt` /
    `m_sig`: the raw matches (_pattern_matches, _term_matches)."""
    b = pods["valid"].shape[0]
    n = nodes["valid"].shape[0]
    v = n_buckets or n
    result = torch.ones(b, n, dtype=torch.bool, device=nodes["valid"].device)

    if "existing" in parts:
        ex_anti = ex_terms["valid"] & (ex_terms["kind"] == ANTI_REQ)
        m_pt = _pattern_matches(ex_terms, pods, m_pt) & ex_anti[:, None]  # [PT, U]
        bucket_n, haskey_n = _bucket_of(nodes, ex_terms["topo_slot"])  # [PT, N]
        hosted = torch.where(haskey_n, ex_terms["counts"].T.to(torch.int32), 0)
        present = _seg_sum(hosted, bucket_n, v) > 0  # [PT, V]
        block_t = haskey_n & _gather_rows(present, bucket_n)  # [PT, N]
        # boolean OR-product: some matching pattern blocks the node
        fail = (m_pt.T.to(torch.float64) @ block_t.to(torch.float64)) > 0.5
        result = result & ~fail

    if "aff" in parts or "anti" in parts:
        aff = terms["valid"] & (terms["kind"] == AFF_REQ)
        anti = terms["valid"] & (terms["kind"] == ANTI_REQ)
        owner = terms["owner"]
        m_sig = _term_matches(terms, eps, m_sig) & eps["valid"][None, :]  # [TT, S]
        bucket_n2, haskey_n2 = _bucket_of(nodes, terms["topo_slot"])  # [TT, N]

    if "aff" in parts:
        matchall = _matchall_rows(m_sig, owner, aff, b)  # [U, S]
        cnt_aff_node = _sig_cnt_node(matchall, eps["counts"])  # [U, N]
        contrib = torch.where(haskey_n2 & aff[:, None], cnt_aff_node[owner.long()], 0)  # [TT, N]
        agg_aff = _seg_sum(contrib, bucket_n2, v) > 0  # [TT, V]
        ok_aff_t = haskey_n2 & _gather_rows(agg_aff, bucket_n2)
        aff_ok = _scatter_and(ok_aff_t, owner, aff, b)
        any_pair = _owner_any(agg_aff.any(dim=1), owner, aff, b)
        escape = ~any_pair & aux["self_aff_match"]
        result = result & (aff_ok | escape[:, None] | ~aux["has_aff"][:, None])

    if "anti" in parts:
        cnt_anti_node = _sig_cnt_node(m_sig & anti[:, None], eps["counts"])  # [TT, N]
        agg_anti = _seg_sum(torch.where(haskey_n2, cnt_anti_node, 0), bucket_n2, v) > 0
        bad_anti_t = haskey_n2 & _gather_rows(agg_anti, bucket_n2)
        result = result & ~_scatter_or(bad_anti_t, owner, anti, b)

    return result


def interpod_score_plain(
    nodes: Arrays, eps: Arrays, terms: Arrays, ex_terms: Arrays, pods: Arrays,
    parts: tuple = SCORE_PARTS, n_buckets: Optional[int] = None,
    m_pt: Optional[torch.Tensor] = None, m_sig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CalculateInterPodAffinityPriority (interpod_affinity.go:99), [U, N]
    int64: weighted same-topology counts from "pref" (the pod's preferred
    terms against existing pods; ANTI_PREF weights are stored negative)
    and "existing" (existing pods' required-affinity (hard weight) and
    preferred terms against the pod), min-max normalized to [0, 10] over
    the valid nodes with 0 clamped in. `m_pt` / `m_sig`: the raw matches
    (_pattern_matches, _term_matches)."""
    b = pods["valid"].shape[0]
    n = nodes["valid"].shape[0]
    v = n_buckets or n
    counts = torch.zeros(b, n, dtype=torch.int64, device=nodes["valid"].device)

    if "pref" in parts:
        pref = terms["valid"] & ((terms["kind"] == AFF_PREF) | (terms["kind"] == ANTI_PREF))
        owner = terms["owner"]
        m_sig = _term_matches(terms, eps, m_sig) & eps["valid"][None, :] & pref[:, None]
        bucket_n, haskey_n = _bucket_of(nodes, terms["topo_slot"])
        cnt_node = _sig_cnt_node(m_sig, eps["counts"])  # [TT, N]
        cnt = _seg_sum(torch.where(haskey_n, cnt_node, 0), bucket_n, v)  # [TT, V]
        contrib_t = torch.where(haskey_n, _gather_rows(cnt, bucket_n), 0) * terms["weight"][:, None]
        counts = counts + _scatter_add(contrib_t.to(torch.int64), owner, pref, b)

    if "existing" in parts:
        kind = ex_terms["kind"]
        ex_score = ex_terms["valid"] & ((kind == AFF_REQ) | (kind == AFF_PREF) | (kind == ANTI_PREF))
        m_pt = _pattern_matches(ex_terms, pods, m_pt) & ex_score[:, None]  # [PT, U]
        bucket_ne, haskey_ne = _bucket_of(nodes, ex_terms["topo_slot"])  # [PT, N]
        hosted = torch.where(haskey_ne, ex_terms["counts"].T.to(torch.int32), 0)
        cnt_v = _seg_sum(hosted, bucket_ne, v)  # [PT, V]
        at_node = torch.where(haskey_ne, _gather_rows(cnt_v, bucket_ne), 0)  # [PT, N]
        weighted = m_pt.to(torch.float64) * ex_terms["weight"][:, None].to(torch.float64)  # [PT, U]
        counts = counts + (weighted.T @ at_node.to(torch.float64)).to(torch.int64)

    valid = nodes["valid"][None, :] & pods["valid"][:, None]
    masked = torch.where(valid, counts, 0)
    max_c = masked.amax(dim=1).clamp(min=0)
    min_c = masked.amin(dim=1).clamp(max=0)
    diff = max_c - min_c
    f = torch.where(
        diff[:, None] > 0,
        torch.div(MAX_NODE_SCORE * (counts - min_c[:, None]), diff.clamp(min=1)[:, None], rounding_mode="floor"),
        0,
    )
    return torch.where(valid, f, 0)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

MATCH_ENTRY = "ktpu_match_terms"
SPREAD_ENTRY = "ktpu_spread_score"
SPREAD_FILTER_ENTRY = "ktpu_spread_filter"
SEL_SPREAD_ENTRY = "ktpu_selector_spread_score"
INTERPOD_FILTER_ENTRY = "ktpu_interpod_filter"
INTERPOD_SCORE_ENTRY = "ktpu_interpod_score"

# a kernel block keeps its owner's term list in shared memory, and its
# V-wide bucket table there too while it fits (else in device memory)
MAX_TERMS = 16384

# csrc/interpod.cu's part bits
_PART_BITS = {("filter", "existing"): 1, ("filter", "aff"): 2, ("filter", "anti"): 4,
              ("score", "pref"): 8, ("score", "existing"): 16}


# csrc/topology.cu's match kernel: up to MATCH_PROBLEMS problems a launch,
# tiles of MATCH_TERM_TILE terms x MATCH_XTILE subjects (fewer subjects
# while their staged label rows would pass MATCH_LABEL_BYTES); its port
# slice tiles of PORT_TILE spec rows x columns, a cell a thread (timed at
# several tiles: PERF.md), widened beside term problems to at most
# PORT_CELLS cells (4 a thread), whose staged lanes stay within PORT_SMEM
# where fewer rows a tile can do it, else within PORT_SMEM_MAX (the card's
# 227 KB a block less the kernel's static slots, with room to spare)
MATCH_PROBLEMS = 4
MATCH_TERM_TILE = 8
MATCH_XTILE = 64
MATCH_LABEL_BYTES = 48 * 1024
PORT_TILE = (16, 16)
PORT_CELLS = 4 * 256
PORT_SMEM = 48 * 1024
PORT_SMEM_MAX = 220 * 1024


class MatchProblem(ctypes.Structure):
    """Mirror of `struct MatchProblem` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "valid", "has_selector", "ml_slot", "ml_val", "ex_op", "ex_slot", "ex_vals",
            "ns_any", "ns_ids", "labels", "ns", "out")]
        + [(d, ctypes.c_int32) for d in ("TT", "X", "K", "ML", "EX", "VALS", "NS", "xtile")]
    )


class PortProblem(ctypes.Structure):
    """Mirror of `struct PortProblem` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in ("num", "proto", "ip", "out")]
        + [(d, ctypes.c_int32) for d in ("U", "PP", "wildcard_ip", "rows", "cols")]
    )


class MatchArgs(ctypes.Structure):
    """Mirror of `struct MatchArgs` in csrc/topology.cu."""

    _fields_ = [("p", MatchProblem * MATCH_PROBLEMS), ("port", PortProblem), ("count", ctypes.c_int32),
                ("smem", ctypes.c_int32)]


class SpreadArgs(ctypes.Structure):
    """Mirror of `struct SpreadArgs` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "t_valid", "t_kind", "t_owner", "t_topo_slot", "t_has_selector", "t_ml_slot", "t_ml_val", "t_ex_op",
            "t_ex_slot", "t_ex_vals", "e_labels", "e_valid", "counts", "n_valid", "label_dense", "sel",
            "merged_cnt", "merged_present", "out")]
        + [(d, ctypes.c_int32) for d in ("TT", "S", "N", "K", "KE", "ML", "EX", "VALS", "U", "V",
                                         "R", "C", "slice", "vslice", "copies", "gcap", "dense_cap", "smem")]
    )


class SpreadFilterArgs(ctypes.Structure):
    """Mirror of `struct SpreadFilterArgs` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "t_valid", "t_kind", "t_owner", "t_topo_slot", "t_self_match", "t_weight", "t_has_selector",
            "t_ml_slot", "t_ml_val", "t_ex_op", "t_ex_slot", "t_ex_vals", "t_ns_any", "t_ns_ids",
            "e_labels", "e_ns", "e_valid", "counts", "n_valid", "label_dense", "sel",
            "cand", "merged_cnt", "merged_present", "min_t", "any_pair_t", "mask")]
        + [(d, ctypes.c_int32) for d in ("TT", "S", "N", "K", "KE", "ML", "EX", "VALS", "NS", "U", "V",
                                         "C", "slice", "vslice", "copies", "local_table", "smem")]
    )


class SelSpreadArgs(ctypes.Structure):
    """Mirror of `struct SelSpreadArgs` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "t_valid", "t_kind", "t_owner", "m_sig", "n_sel_spread", "e_valid", "e_deleting",
            "counts", "n_valid", "zone_dense", "ztable", "out")]
        + [(d, ctypes.c_int32) for d in ("TT", "S", "N", "U", "V", "C", "slice", "vslice", "mode", "smem")]
    )


def _check_terms(terms: Arrays) -> int:
    tt = terms["valid"].shape[0]
    if tt > MAX_TERMS:
        raise ValueError(f"{tt} term rows exceed the topology kernels' {MAX_TERMS}")
    return tt


def term_row_words(ml: int, ex: int, vals: int, ns: int) -> int:
    """The int32 words of one compacted term row in csrc/topology.cu: a
    header, two words a test, the value pool, the namespace lanes."""
    return 1 + 2 * (ml + ex) + ex * vals + ns


def match_layout(k: int, ml: int, ex: int, vals: int, ns: int) -> Dict[str, int]:
    """A match problem's CTA as csrc/topology.cu's `match_smem_bytes` counts
    it: `xtile` subjects (MATCH_XTILE, halved while the label columns of
    the slots a tile's tests can name [min(K, tile x (ML + EX)), xtile]
    pass MATCH_LABEL_BYTES) and `smem` bytes (the tile's term rows as copied
    and as compacted, the slot map [K], then the subjects). Raises on widths
    the compacted rows cannot encode."""
    if not 1 <= k < 1 << 24 or ml + ex > 1023 or ns > 1023 or term_row_words(ml, ex, vals, ns) >= 1 << 15:
        raise ValueError(f"term widths ML={ml} EX={ex} VALS={vals} NS={ns} K={k} exceed the match kernel's rows")
    cap = min(k, MATCH_TERM_TILE * (ml + ex))  # the label slots a tile's tests can name
    xt = MATCH_XTILE
    while xt > 1 and 4 * (cap + 1) * xt > MATCH_LABEL_BYTES:
        xt //= 2
    raw = MATCH_TERM_TILE * (2 * ml + 2 * ex + ex * vals + ns) + (3 * MATCH_TERM_TILE + 3) // 4
    return {"xtile": xt, "smem": 4 * (raw + MATCH_TERM_TILE * term_row_words(ml, ex, vals, ns) + k
                                      + cap * (xt + 1) + xt)}


def port_layout(u: int, pp: int, plane: Optional[int] = None,
                tile: Optional[Tuple[int, int]] = None) -> Dict[str, int]:
    """The match launch's port slice as csrc/topology.cu's `port_table`,
    `port_tiles` and `port_smem_bytes` lay it out, for U spec rows of PP
    port lanes: CTA tiles of `rows` spec rows x `cols` columns (rows at
    most U, cols a multiple of 16 at most U rounded up to 16), `tiles`
    CTAs, and `smem` bytes (16-byte (num, proto, ip, -) words for each lane
    of the tile's rows and columns, then their live counts).

    The tile is PORT_TILE, or `tile` (the CPU walk's). Long port lists
    halve its rows, down to one, while its lanes pass PORT_SMEM, and may
    then take up to PORT_SMEM_MAX. Beside term problems whose x-y plane
    holds `plane` CTAs, its columns, then its rows, double while the slice
    needs more CTAs than that plane holds and a CTA keeps within
    PORT_CELLS cells and PORT_SMEM (the launch grows its x only where the
    tiles still outnumber the plane). Raises where U or PP is 0 or one
    spec row's lanes beside 16 columns' pass PORT_SMEM_MAX."""
    rows, cols = tile or PORT_TILE
    if u < 1 or pp < 1 or rows < 1 or cols < 16 or cols % 16:
        raise ValueError(f"a port table needs spec rows, port lanes and a tile of whole 16-column groups, not U={u} "
                         f"PP={pp} tile={rows}x{cols}")
    width = -(-u // 16) * 16
    rows, cols = min(rows, u), min(cols, width)

    def smem(r, c):
        return (16 * pp + 4) * (r + c)

    def tiles(r, c):
        return -(-u // r) * -(-u // c)

    while rows > 1 and smem(rows, cols) > PORT_SMEM:
        rows //= 2
    if smem(rows, cols) > PORT_SMEM_MAX:
        raise ValueError(f"a {rows}x{cols} port tile of {pp} lanes needs {smem(rows, cols)} bytes of shared memory, "
                         f"past {PORT_SMEM_MAX}")
    while plane is not None and tile is None and tiles(rows, cols) > plane:
        wide, tall = min(2 * cols, width), min(2 * rows, u)
        if cols < width and rows * wide <= PORT_CELLS and smem(rows, wide) <= PORT_SMEM:
            cols = wide
        elif rows < u and tall * cols <= PORT_CELLS and smem(tall, cols) <= PORT_SMEM:
            rows = tall
        else:
            break
    return {"rows": rows, "cols": cols, "tiles": tiles(rows, cols), "smem": smem(rows, cols)}


def match_grid(terms: Sequence[Tuple[int, int, int]], port: Optional[Dict[str, int]] = None) -> Tuple[int, int, int]:
    """The match launch's grid as `ktpu_match_terms` sizes it, for term
    problems of (TT, X, xtile) and the port slice's layout (None: no port
    table): x and y cover every problem's tiles, z holds one slice a
    problem and the port slice last, whose CTAs are the first `tiles` of
    its x-y plane (x grows where the problems' plane is smaller)."""
    gx = max([1] + [-(-x // xt) for _, x, xt in terms])
    gy = max([1] + [-(-tt // MATCH_TERM_TILE) for tt, _, _ in terms])
    if port is not None and gx * gy < port["tiles"]:
        gx = -(-port["tiles"] // gy)
    return gx, gy, len(terms) + int(port is not None)


def match_args(problems: Sequence[Tuple[Arrays, torch.Tensor, Optional[torch.Tensor]]], ports=None):
    """The match kernel's argument struct for up to MATCH_PROBLEMS (terms,
    labels [X, K], namespaces [X] or None) problems on one CUDA device and,
    with `ports` = (spec-row arrays, ids), the batch's in-batch host-port
    table in the same launch; and the outputs: each problem's [TT, X] bool
    matrix (an empty one is not launched), then with `ports` the [U, U]
    bool port table. Validates device, dtype, shape and contiguity
    (raises)."""
    if len(problems) > MATCH_PROBLEMS or not (problems or ports is not None):
        raise ValueError(f"{len(problems)} match problems: one launch takes up to {MATCH_PROBLEMS}, and at least "
                         f"one or a port table")
    a = MatchArgs()
    outs, count, smem, plane = [], 0, 0, []
    for terms, labels, ns in problems:
        tt = terms["valid"].shape[0]
        x, k = labels.shape
        out = torch.empty((tt, x), dtype=torch.bool, device=labels.device)
        outs.append(out)
        if tt == 0 or x == 0:
            continue
        ml, ex, vals = terms["ml_slot"].shape[1], terms["ex_op"].shape[1], terms["ex_vals"].shape[2]
        nsc = terms["ns_ids"].shape[1]
        lay = match_layout(k, ml, ex, vals, nsc)
        p = a.p[count]
        for key, dt, shape in (("valid", torch.bool, (tt,)), ("has_selector", torch.bool, (tt,)),
                               ("ml_slot", torch.int32, (tt, ml)), ("ml_val", torch.int32, (tt, ml)),
                               ("ex_op", torch.int32, (tt, ex)), ("ex_slot", torch.int32, (tt, ex)),
                               ("ex_vals", torch.int32, (tt, ex, vals)), ("ns_any", torch.bool, (tt,)),
                               ("ns_ids", torch.int32, (tt, nsc))):
            setattr(p, key, build.ptr(terms[key], dt, shape))
        p.labels = build.ptr(labels, torch.int32)
        p.ns = None if ns is None else build.ptr(ns, torch.int32, (x,))
        p.out = build.ptr(out, torch.bool)
        p.TT, p.X, p.K, p.ML, p.EX, p.VALS, p.NS, p.xtile = tt, x, k, ml, ex, vals, nsc, lay["xtile"]
        smem = max(smem, lay["smem"])
        count += 1
        plane.append((tt, x, lay["xtile"]))
    if ports is not None:
        pods, ids = ports
        u, pp = pods["port_num"].shape
        table = torch.empty((u, u), dtype=torch.bool, device=pods["port_num"].device)
        outs.append(table)
        if u and pp:
            gx, gy, _ = match_grid(plane)
            lay = port_layout(u, pp, gx * gy if plane else None)
            q = a.port
            for key in ("num", "proto", "ip"):
                setattr(q, key, build.ptr(pods["port_" + key], torch.int32, (u, pp)))
            q.out = build.ptr(table, torch.bool, (u, u))
            q.U, q.PP, q.wildcard_ip, q.rows, q.cols = u, pp, int(ids["wildcard_ip"]), lay["rows"], lay["cols"]
            smem = max(smem, lay["smem"])
        else:
            table.zero_()
    a.count, a.smem = count, smem
    return a, outs


def launch_match(problems: Sequence[Tuple[Arrays, torch.Tensor, Optional[torch.Tensor]]], ports=None):
    """One launch of the match kernel on CUDA tensors (see match_args),
    counted by the caller; nothing is launched where every output is empty.
    Returns (the struct, the outputs)."""
    args, outs = match_args(problems, ports)
    if args.count or args.port.out:
        dev = outs[0].device
        build.launch(MATCH_ENTRY, args, dev)
    return args, outs


def match_terms_multi(problems: Sequence[Tuple[Arrays, torch.Tensor, Optional[torch.Tensor]]], ports=None):
    """match_terms for each (terms, labels, ns) problem, as a list of
    [TT, X] bool matrices, followed, with `ports` = (spec-row arrays,
    ids), by the batch's [U, U] in-batch host-port table
    (filters.inbatch_port_conflict_plain's). CPU tensors run the plain
    versions; CUDA tensors launch csrc/topology.cu's match kernel ONCE for
    up to MATCH_PROBLEMS problems and the port table (counted in
    `match_terms.launches`, the matrices in `match_terms.problems`, a
    launch of two or more matrices in `match_terms.multi_launches`, the
    port tables in `match_terms.port_tables`)."""
    dev = problems[0][1].device if problems else ports[0]["port_num"].device
    if dev.type == "cpu":
        outs = [match_terms_plain(*p) for p in problems]
        return outs + ([inbatch_port_conflict_plain(*ports)] if ports is not None else [])
    if dev.type == "cuda":
        args, outs = launch_match(problems, ports)
        if args.count or args.port.out:
            match_terms.launches += 1
            match_terms.problems += args.count
            match_terms.multi_launches += int(args.count > 1)
            match_terms.port_tables += int(bool(args.port.out))
        return outs
    raise ValueError(f"no topology kernel for device {dev}")


def match_terms(terms: Arrays, labels: torch.Tensor, ns: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[TT, X] term x subject match. CPU tensors run the plain version;
    CUDA tensors launch csrc/topology.cu's match kernel with this one
    problem (counted in `match_terms.launches` and `.problems`)."""
    return match_terms_multi([(terms, labels, ns)])[0]


match_terms.launches = 0
match_terms.problems = 0
match_terms.multi_launches = 0
match_terms.port_tables = 0


def _term_ptrs(a, terms: Arrays, tt: int, keys) -> None:
    dts = {"valid": torch.bool, "kind": torch.int32, "owner": torch.int32, "topo_slot": torch.int32}
    for k in keys:
        setattr(a, "t_" + k, build.ptr(terms[k], dts[k], (tt,)))


# csrc/topology.cu's spread score: SPREAD_SCORE_ROWS spec rows a cluster
# (timed at 1, 4, 8, 16 and all rows at the config-3 shapes: PERF.md), as
# many CTAs a cluster (up to 16) as keep the launch near SPREAD_SCORE_CTAS
# (two CTAs an SM, so one CTA's waits overlap the other's work); a
# chunk of SCORE_TW terms, a window of SCORE_SWIN signatures, a counts tile
# of SCORE_TILE_WORDS int32 words beside the rows' selector bytes
# (SCORE_SEL_BYTES); up to SCORE_DENSE_MAX keys of a node slice staged, in
# at most SCORE_DENSE_BYTES
SPREAD_SCORE_ROWS = 8
SPREAD_SCORE_CTAS = 256
SCORE_TW, SCORE_SWIN, SCORE_TILE_WORDS, SCORE_SEL_BYTES = 16, 256, 4096, 8192
SCORE_DENSE_MAX = 8
SCORE_DENSE_BYTES = 8 * 1024
SCORE_GROUPS_A_ROW = 4
SCORE_GROUPS_MIN = 32
SCORE_FTAB_BYTES = 16384  # one-key rows' scores by bucket, R x V int64, where they fit


def spread_score_layout(tt: int, n: int, v: int, u: int, ml: int, ex: int, vals: int,
                        rows: Optional[int] = None, cluster: Optional[int] = None,
                        gcap: Optional[int] = None) -> Dict[str, int]:
    """The spread score's launch for TT terms (selector widths ML, EX,
    VALS), N nodes, V buckets and U spec rows, as csrc/topology.cu's
    `spread_score_smem_bytes` counts it: `R` spec rows a cluster of `C`
    CTAs, each owning `slice` nodes and `vslice` buckets; `copies` per-warp
    copies of the [gcap, V] tables in shared memory (0: the tables live in
    device memory, the counted path), `gcap` the groups (one a spec row and
    topology key) they hold — SCORE_GROUPS_A_ROW a row, at least
    SCORE_GROUPS_MIN, at most TT; a cluster whose rows hold more takes the
    device tables —, `dense_cap` keys of the node slice staged, and `smem`
    bytes. `rows`, `cluster` and `gcap` override R, C and gcap (for
    measuring and testing)."""
    if not 1 <= v < 2**31 or tt > 0xFFFF:
        raise ValueError(f"V = {v}, TT = {tt}: the spread score takes 1 <= V < 2^31 and TT <= 65,535")
    r = max(1, min(int(rows or SPREAD_SCORE_ROWS), max(u, 1)))
    clusters = -(-max(u, 1) // r)
    if cluster is None:
        c = 1
        while 2 * c <= build.MAX_CLUSTER and clusters * 2 * c <= SPREAD_SCORE_CTAS:
            c *= 2
    else:
        c = int(cluster)
    if not 1 <= c <= build.MAX_CLUSTER:
        raise ValueError(f"{c} CTAs a cluster: the spread score takes 1 to {build.MAX_CLUSTER}")
    sl, vs = -(-n // c), -(-v // c)
    words0 = (9 * r + (2 * r * v if r * v * 8 <= SCORE_FTAB_BYTES else 0) + 11 * tt + r + 1
              + SCORE_TW * term_row_words(ml, ex, vals, 0) + SCORE_TW * SCORE_SWIN + 2 * SCORE_SWIN
              + SCORE_TILE_WORDS + sl)

    gcap = min(tt, max(SCORE_GROUPS_MIN, SCORE_GROUPS_A_ROW * r)) if gcap is None else int(gcap)

    def smem(copies: int, dcap: int) -> int:
        words, nbytes = words0 + dcap * sl, SCORE_SEL_BYTES
        if copies:
            cells = gcap * v
            words += copies * cells + gcap * vs + cells + 2 * cells + gcap * vs
            nbytes += 3 * cells + gcap * vs
        return 4 * words + ((nbytes + 15) & ~15)

    copies = 0
    for p in (_WARPS, 4, 2, 1):
        if (p == 1 or p * gcap * v <= SPREAD_COPY_CELLS) and smem(p, 0) <= SPREAD_SMEM:
            copies = p
            break
    if smem(copies, 0) > SPREAD_SMEM:
        raise ValueError(f"{tt} terms and {r} spec rows a cluster exceed the spread score's shared memory")
    dcap = min(SCORE_DENSE_MAX, SCORE_DENSE_BYTES // (4 * sl), (SPREAD_SMEM - smem(copies, 0)) // (4 * sl))
    return {"R": r, "C": c, "slice": sl, "vslice": vs, "copies": copies, "gcap": gcap, "dense_cap": dcap,
            "smem": smem(copies, dcap)}


def spread_args(nodes: Arrays, eps: Arrays, terms: Arrays, selector_mask: torch.Tensor,
                n_buckets: Optional[int] = None, rows: Optional[int] = None, cluster: Optional[int] = None,
                gcap: Optional[int] = None):
    """The spread score's argument struct for these CUDA tensors (with its
    device-memory tables) and the [U, N] int64 score its one launch
    writes. `rows`, `cluster` and `gcap` override the
    spec rows and CTAs a cluster and the groups its shared tables hold (for
    measuring and testing)."""
    tt = _check_terms(terms)
    u, n = selector_mask.shape
    s, ke = eps["label_vals"].shape
    k = nodes["label_dense"].shape[1]
    v = int(n_buckets or n)
    ml, ex, vals = terms["ml_slot"].shape[1], terms["ex_op"].shape[1], terms["ex_vals"].shape[2]
    lay = spread_score_layout(tt, n, v, u, ml, ex, vals, rows, cluster, gcap)
    dev = selector_mask.device
    # the device tables: the layout's, or a cluster's whose rows hold more
    # groups than its shared tables
    tables = {
        "merged_cnt": torch.empty((tt, v), dtype=torch.int32, device=dev),
        "merged_present": torch.empty((tt, v), dtype=torch.bool, device=dev),
    }
    out = torch.empty((u, n), dtype=torch.int64, device=dev)
    a = SpreadArgs()
    _term_ptrs(a, terms, tt, ("valid", "kind", "owner", "topo_slot"))
    for key, dt, shape in (("has_selector", torch.bool, (tt,)), ("ml_slot", torch.int32, (tt, ml)),
                           ("ml_val", torch.int32, (tt, ml)), ("ex_op", torch.int32, (tt, ex)),
                           ("ex_slot", torch.int32, (tt, ex)), ("ex_vals", torch.int32, (tt, ex, vals))):
        setattr(a, "t_" + key, build.ptr(terms[key], dt, shape))
    a.e_labels = build.ptr(eps["label_vals"], torch.int32, (s, ke))
    a.e_valid = build.ptr(eps["valid"], torch.bool, (s,))
    a.counts = build.ptr(eps["counts"], torch.int16, (n, s))
    a.n_valid = build.ptr(nodes["valid"], torch.bool, (n,))
    a.label_dense = build.ptr(nodes["label_dense"], torch.int32, (n, k))
    a.sel = build.ptr(selector_mask, torch.bool, (u, n))
    for name, t in tables.items():
        setattr(a, name, build.ptr(t, t.dtype))
    a.out = build.ptr(out, torch.int64)
    a.TT, a.S, a.N, a.K, a.KE, a.ML, a.EX, a.VALS, a.U, a.V = tt, s, n, k, ke, ml, ex, vals, u, v
    for key, val in lay.items():
        setattr(a, key, val)
    a.keepalive = tables
    return a, out


# csrc/topology.cu's spread filter: one cluster of SPREAD_FILTER_CLUSTER
# CTAs a spec row (timed at 4, 8 and 16 CTAs at the config-3-hard shapes:
# PERF.md), a window of SPREAD_LIST matched signatures, the per-warp copies
# of its bucket tables in shared memory up to SPREAD_COPY_CELLS cells, a
# local copy of the merged table up to SPREAD_LOCAL_V buckets, and a CTA's
# shared-memory budget
SPREAD_FILTER_CLUSTER = 4
SPREAD_LIST = 1024
SPREAD_COPY_CELLS = 4096
SPREAD_LOCAL_V = 1024
SPREAD_SMEM = 200 * 1024
_WARPS = 8  # 256 threads a CTA
_ST_BUCKET = 0x3FFFFFFF


def spread_filter_layout(tt: int, n: int, v: int, cluster: Optional[int] = None) -> Dict[str, int]:
    """The spread filter's launch for TT terms, N nodes and V buckets, as
    csrc/topology.cu's `spread_filter_smem_bytes` counts it: `C` CTAs a
    spec row (doubled up to 16 while a CTA's node states overflow the
    budget), each owning `slice` nodes and `vslice` buckets; `copies`
    per-warp copies of the V-wide bucket tables in shared memory (0: the
    tables live in device memory, the counted path), `local_table` (every
    CTA copies the merged table; else a lookup reads the owning CTA's
    slice) and `smem` bytes. Raises when even 16 CTAs cannot hold the node
    states."""
    if not 1 <= v < _ST_BUCKET:
        raise ValueError(f"{v} buckets: the spread filter takes 1 to {_ST_BUCKET - 1}")
    c = int(cluster or SPREAD_FILTER_CLUSTER)
    if not 1 <= c <= build.MAX_CLUSTER:
        raise ValueError(f"{c} CTAs a spec row: the spread filter takes 1 to {build.MAX_CLUSTER}")

    def base(c_):
        return 4 * (tt + 2 * SPREAD_LIST + -(-n // c_))

    while base(c) > SPREAD_SMEM and c < build.MAX_CLUSTER:
        c = min(2 * c, build.MAX_CLUSTER)
    if base(c) > SPREAD_SMEM:
        raise ValueError(f"{tt} terms and {n} nodes exceed the spread filter's shared memory")
    vs = -(-v // c)
    copies = 0
    for p in (_WARPS, 4, 2, 1):
        if (p == 1 or p * v <= SPREAD_COPY_CELLS) and base(c) + 5 * (p * v + vs) <= SPREAD_SMEM:
            copies = p
            break
    local = int(copies > 0 and v <= SPREAD_LOCAL_V and base(c) + 5 * (copies * v + vs + v) <= SPREAD_SMEM)
    smem = base(c) + (5 * (copies * v + vs) + 5 * v * local if copies else 0)
    return {"C": c, "slice": -(-n // c), "vslice": vs, "copies": copies, "local_table": local, "smem": smem}


def spread_filter_args(nodes: Arrays, eps: Arrays, terms: Arrays, selector_mask: torch.Tensor,
                       n_buckets: Optional[int] = None, cluster: Optional[int] = None):
    """The spread filter's argument struct for these CUDA tensors and the
    outputs its one launch writes: (args, mask [U, N] bool, tables: cand
    [U, N] bool, merged_cnt [TT, V] int32, merged_present [TT, V] bool,
    min_t [TT] int32, any_pair_t [TT] bool). `cluster` overrides the CTAs a
    spec row (for measuring)."""
    tt = _check_terms(terms)
    u, n = selector_mask.shape
    s, ke = eps["label_vals"].shape
    k = nodes["label_dense"].shape[1]
    v = int(n_buckets or n)
    lay = spread_filter_layout(tt, n, v, cluster)
    dev = selector_mask.device
    mask = torch.empty((u, n), dtype=torch.bool, device=dev)
    tables = {
        "cand": torch.empty((u, n), dtype=torch.bool, device=dev),
        "merged_cnt": torch.empty((tt, v), dtype=torch.int32, device=dev),
        "merged_present": torch.empty((tt, v), dtype=torch.bool, device=dev),
        "min_t": torch.empty((tt,), dtype=torch.int32, device=dev),
        "any_pair_t": torch.empty((tt,), dtype=torch.bool, device=dev),
    }
    ml, ex, vals = terms["ml_slot"].shape[1], terms["ex_op"].shape[1], terms["ex_vals"].shape[2]
    nsc = terms["ns_ids"].shape[1]
    a = SpreadFilterArgs()
    _term_ptrs(a, terms, tt, ("valid", "kind", "owner", "topo_slot"))
    for key, dt, shape in (("self_match", torch.bool, (tt,)), ("weight", torch.int32, (tt,)),
                           ("has_selector", torch.bool, (tt,)), ("ml_slot", torch.int32, (tt, ml)),
                           ("ml_val", torch.int32, (tt, ml)), ("ex_op", torch.int32, (tt, ex)),
                           ("ex_slot", torch.int32, (tt, ex)), ("ex_vals", torch.int32, (tt, ex, vals)),
                           ("ns_any", torch.bool, (tt,)), ("ns_ids", torch.int32, (tt, nsc))):
        setattr(a, "t_" + key, build.ptr(terms[key], dt, shape))
    a.e_labels = build.ptr(eps["label_vals"], torch.int32, (s, ke))
    a.e_ns = build.ptr(eps["ns_id"], torch.int32, (s,))
    a.e_valid = build.ptr(eps["valid"], torch.bool, (s,))
    a.counts = build.ptr(eps["counts"], torch.int16, (n, s))
    a.n_valid = build.ptr(nodes["valid"], torch.bool, (n,))
    a.label_dense = build.ptr(nodes["label_dense"], torch.int32, (n, k))
    a.sel = build.ptr(selector_mask, torch.bool, (u, n))
    for name, t in tables.items():
        setattr(a, name, build.ptr(t, t.dtype))
    a.mask = build.ptr(mask, torch.bool)
    a.TT, a.S, a.N, a.K, a.KE, a.ML, a.EX, a.VALS, a.NS, a.U, a.V = tt, s, n, k, ke, ml, ex, vals, nsc, u, v
    for key, val in lay.items():
        setattr(a, key, val)
    a.keepalive = tables
    return a, mask, tables


def spread_filter(
    nodes: Arrays, eps: Arrays, terms: Arrays, selector_mask: torch.Tensor, n_buckets: Optional[int] = None,
    with_tables: bool = False,
):
    """The [U, N] bool EvenPodsSpread (DoNotSchedule) predicate. CPU
    tensors run the plain version; CUDA tensors launch csrc/topology.cu's
    spread-filter entry once — the term matches against the signatures are
    computed inside it (counted in `spread_filter.launches`; a launch whose
    bucket tables live in device memory also in
    `spread_filter.device_table_launches`). `selector_mask` is the RAW
    PodMatchNodeSelector matrix. With `with_tables`, the pair (mask, the
    metadata of spread_hard_tables_plain, written by the same launch)."""
    dev = selector_mask.device
    if dev.type == "cpu":
        return spread_filter_plain(nodes, eps, terms, selector_mask, n_buckets, with_tables)
    if dev.type == "cuda":
        args, out, tables = spread_filter_args(nodes, eps, terms, selector_mask, n_buckets)
        build.launch(SPREAD_FILTER_ENTRY, args, dev)
        spread_filter.launches += 1
        spread_filter.device_table_launches += int(args.copies == 0)
        return (out, tables) if with_tables else out
    raise ValueError(f"no topology kernel for device {dev}")


spread_filter.launches = 0
spread_filter.device_table_launches = 0


def spread_score(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, selector_mask: torch.Tensor,
    n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """The [U, N] int64 EvenPodsSpread (ScheduleAnyway) score. CPU tensors
    run the plain version; CUDA tensors launch csrc/topology.cu's spread
    score once — the term matches against the signatures are computed
    inside it (counted in `spread_score.launches`; a launch whose bucket
    tables live in device memory also in
    `spread_score.device_table_launches`). `selector_mask` is the RAW
    PodMatchNodeSelector matrix (not masked by node or pod validity)."""
    dev = selector_mask.device
    if dev.type == "cpu":
        return spread_score_plain(nodes, eps, terms, aux, selector_mask, n_buckets)
    if dev.type == "cuda":
        args, out = spread_args(nodes, eps, terms, selector_mask, n_buckets)
        build.launch(SPREAD_ENTRY, args, dev)
        spread_score.launches += 1
        spread_score.device_table_launches += int(args.copies == 0)
        return out
    raise ValueError(f"no topology kernel for device {dev}")


spread_score.launches = 0
spread_score.device_table_launches = 0


# csrc/topology.cu's selector spread: one cluster of C CTAs a spec row, C
# doubled from the fewest that keep a CTA's node pairs in registers
# (SEL_PAIRS a thread: 4,096 nodes a CTA) while the launch stays within
# SEL_SPREAD_CTAS, four CTAs an SM in one wave (timed at 3, 4, 8 and 16
# CTAs at the config-3 shapes: PERF.md); the zone table a CTA's local
# partial up to SEL_LOCAL_V buckets, else bucket slices of up to
# SEL_SLICE_BYTES in shared memory, else device memory (the counted path)
SEL_SPREAD_CTAS = 512
SEL_PAIRS = 8
SEL_LOCAL_V = 1024
SEL_SLICE_BYTES = 64 * 1024


def selector_spread_layout(tt: int, n: int, v: int, u: int, cluster: Optional[int] = None,
                           mode: Optional[int] = None) -> Dict[str, int]:
    """The selector-spread launch for TT terms, N nodes, V buckets and U
    spec rows, as csrc/topology.cu's `sel_spread_smem_bytes` counts it: `C`
    CTAs a spec row, each owning `slice` nodes (even: a thread owns node
    pairs) and `vslice` buckets; `mode` where the zone tables live (0: a
    V-wide partial a CTA, merged locally; 1: bucket slices in shared
    memory; 2: device memory, the counted path) and `smem` bytes.
    `cluster` and `mode` override C and the mode (for measuring and
    testing). Raises past 16 CTAs' registers (65,536 nodes)."""
    if not 1 <= v < 2**31:
        raise ValueError(f"{v} buckets: the selector spread takes 1 <= V < 2^31")
    per_cta = 2 * SEL_PAIRS * 256
    c_min = max(1, -(-n // per_cta))
    if c_min > build.MAX_CLUSTER:
        raise ValueError(f"{n} nodes exceed the selector spread's {build.MAX_CLUSTER * per_cta} (16 CTAs' registers)")
    if cluster is None:
        c = c_min
        while 2 * c <= build.MAX_CLUSTER and max(u, 1) * 2 * c <= SEL_SPREAD_CTAS:
            c *= 2
    else:
        c = int(cluster)
    if not c_min <= c <= build.MAX_CLUSTER:
        raise ValueError(f"{c} CTAs a spec row: the selector spread takes {c_min} to {build.MAX_CLUSTER} for N = {n}")
    sl, vs = 2 * -(-n // (2 * c)), -(-v // c)
    if mode is None:
        mode = 0 if v <= SEL_LOCAL_V else (1 if 8 * vs <= SEL_SLICE_BYTES else 2)
    cells = (2 * v, vs, 0)[int(mode)]
    smem = 8 * cells + 4 * (tt + SPREAD_LIST + sl)
    if smem > SPREAD_SMEM:
        raise ValueError(f"{tt} terms and V = {v} in mode {mode} exceed the selector spread's shared memory")
    return {"C": c, "slice": sl, "vslice": vs, "mode": int(mode), "smem": smem}


def selector_spread_args(nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, m_sig: torch.Tensor,
                         n_buckets: Optional[int] = None, cluster: Optional[int] = None,
                         mode: Optional[int] = None):
    """The selector-spread kernel's argument struct (with its device-memory
    zone tables in mode 2) and the [U, N] int64 output its one launch
    writes. `m_sig` is match_terms's output with the namespace test;
    `cluster` and `mode` override the layout (for measuring and testing)."""
    tt = _check_terms(terms)
    u = aux["n_sel_spread"].shape[0]
    n = nodes["valid"].shape[0]
    s = eps["valid"].shape[0]
    v = int(n_buckets or n)
    lay = selector_spread_layout(tt, n, v, u, cluster, mode)
    dev = m_sig.device
    tables = {"ztable": torch.empty((u, v), dtype=torch.int64, device=dev)} if lay["mode"] == 2 else {}
    out = torch.empty((u, n), dtype=torch.int64, device=dev)
    a = SelSpreadArgs()
    _term_ptrs(a, terms, tt, ("valid", "kind", "owner"))
    a.m_sig = build.ptr(m_sig, torch.bool, (tt, s))
    a.n_sel_spread = build.ptr(aux["n_sel_spread"], torch.int32, (u,))
    a.e_valid = build.ptr(eps["valid"], torch.bool, (s,))
    a.e_deleting = build.ptr(eps["deleting"], torch.bool, (s,))
    a.counts = build.ptr(eps["counts"], torch.int16, (n, s))
    a.n_valid = build.ptr(nodes["valid"], torch.bool, (n,))
    a.zone_dense = build.ptr(nodes["zone_dense"], torch.int32, (n,))
    for name, t in tables.items():
        setattr(a, name, build.ptr(t, t.dtype))
    a.out = build.ptr(out, torch.int64)
    a.TT, a.S, a.N, a.U, a.V = tt, s, n, u, v
    for key, val in lay.items():
        setattr(a, key, val)
    a.keepalive = tables
    return a, out


def selector_spread_score(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, n_buckets: Optional[int] = None,
    m_sig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The [U, N] int64 SelectorSpread score. CPU tensors run the plain
    version; CUDA tensors launch the match kernel (with the namespace test)
    unless `m_sig` — that raw [TT, S] match, from the batch's match plan —
    is given, and then csrc/topology.cu's selector-spread kernel once, a
    cluster a spec row (counted in `selector_spread_score.launches`; a
    launch whose zone tables live in device memory also in
    `selector_spread_score.device_table_launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return selector_spread_score_plain(nodes, eps, terms, aux, n_buckets, m_sig)
    if dev.type == "cuda":
        if m_sig is None:
            m_sig = match_terms(terms, eps["label_vals"], eps["ns_id"])
        args, out = selector_spread_args(nodes, eps, terms, aux, m_sig, n_buckets)
        build.launch(SEL_SPREAD_ENTRY, args, dev)
        selector_spread_score.launches += 1
        selector_spread_score.device_table_launches += int(args.mode == 2)
        return out
    raise ValueError(f"no topology kernel for device {dev}")


selector_spread_score.launches = 0
selector_spread_score.device_table_launches = 0


class InterpodArgs(ctypes.Structure):
    """Mirror of `struct InterpodArgs` in csrc/interpod.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "n_valid", "label_dense", "x_valid", "x_kind", "x_topo_slot", "x_weight", "x_counts", "m_pt",
            "t_valid", "t_kind", "t_owner", "t_topo_slot", "t_weight", "m_sig", "e_valid", "counts",
            "p_valid", "dtable", "score")]
        + [(d, ctypes.c_int32) for d in ("N", "K", "PT", "TT", "S", "U", "V", "parts",
                                         "C", "slice", "vslice", "tcap", "smem")]
    )


class InterpodFilterArgs(ctypes.Structure):
    """Mirror of `struct InterpodFilterArgs` in csrc/interpod.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "label_dense", "x_valid", "x_kind", "x_topo_slot", "x_counts", "m_pt", "t_valid", "t_kind", "t_owner",
            "t_topo_slot", "m_sig", "e_valid", "counts", "self_aff_match", "has_aff", "dtable", "mask")]
        + [(d, ctypes.c_int32) for d in ("N", "K", "PT", "TT", "S", "U", "V", "parts",
                                         "C", "slice", "vslice", "tcap", "smem")]
    )


# csrc/interpod.cu's filter: one cluster of C CTAs a spec row, C doubled
# while the launch stays within INTERPOD_FILTER_CTAS (timed at 1 to 16 CTAs
# at the config-4 and the extender's /filter shapes: PERF.md); up to
# INTERPOD_TCAP item tables a chunk, their bucket slices within
# INTERPOD_TABLE_BYTES of a CTA's shared memory (none fits: device memory,
# the counted path); a window of INTERPOD_SIG_WINDOW signatures
INTERPOD_FILTER_CTAS = 256
INTERPOD_TCAP = 16
INTERPOD_TABLE_BYTES = 64 * 1024
INTERPOD_SIG_WINDOW = 1024


def interpod_filter_layout(pt: int, tt: int, n: int, v: int, u: int, cluster: Optional[int] = None,
                           tcap: Optional[int] = None) -> Dict[str, int]:
    """The inter-pod filter's launch for PT patterns, TT terms, N nodes, V
    buckets and U spec rows, as csrc/interpod.cu's
    `interpod_filter_smem_bytes` counts it: `C` CTAs a spec row (doubled up
    to 16 while a CTA's node states and lists overflow the budget), each
    owning `slice` nodes and `vslice` buckets; `tcap` item tables a chunk in
    shared memory (0: one table at a time in device memory, the counted
    path) and `smem` bytes. `cluster` and `tcap` override C and tcap (for
    measuring and testing)."""
    return _interpod_layout("filter", pt, tt, n, v, u, cluster, tcap, node_bytes=1, max_slice=n)


def _interpod_layout(what: str, pt: int, tt: int, n: int, v: int, u: int, cluster: Optional[int],
                     tcap: Optional[int], node_bytes: int, max_slice: int) -> Dict[str, int]:
    """The cluster layout both inter-pod kernels share: C doubled while the
    launch stays within INTERPOD_FILTER_CTAS, then up to 16 while a CTA's
    lists and `node_bytes` a node of shared memory overflow the budget or
    its slice exceeds `max_slice` nodes; the item tables a chunk."""
    if not 1 <= v < 2**31:
        raise ValueError(f"{v} buckets: the inter-pod {what} takes 1 <= V < 2^31")
    if cluster is None:
        c = 1
        while 2 * c <= build.MAX_CLUSTER and max(u, 1) * 2 * c <= INTERPOD_FILTER_CTAS:
            c *= 2
    else:
        c = int(cluster)
    if not 1 <= c <= build.MAX_CLUSTER:
        raise ValueError(f"{c} CTAs a spec row: the inter-pod {what} takes 1 to {build.MAX_CLUSTER}")

    def base(c_):
        return 4 * (pt + tt + INTERPOD_SIG_WINDOW) + node_bytes * -(-n // c_)

    def over(c_):
        return base(c_) > SPREAD_SMEM or -(-n // c_) > max_slice

    while over(c) and c < build.MAX_CLUSTER:
        c = min(2 * c, build.MAX_CLUSTER)
    if over(c):
        raise ValueError(f"{pt} patterns, {tt} terms and {n} nodes exceed the inter-pod {what}'s shared memory "
                         f"or registers")
    sl, vs = -(-n // c), -(-v // c)
    if tcap is None:
        tcap = min(INTERPOD_TCAP, INTERPOD_TABLE_BYTES // (4 * vs), (SPREAD_SMEM - base(c)) // (4 * vs))
    return {"C": c, "slice": sl, "vslice": vs, "tcap": int(tcap), "smem": base(c) + 4 * int(tcap) * vs}


# csrc/interpod.cu's score keeps each node's sum in registers, at most
# INTERPOD_SCORE_NODES a thread of 256
INTERPOD_SCORE_NODES = 16


def interpod_score_layout(pt: int, tt: int, n: int, v: int, u: int, cluster: Optional[int] = None,
                          tcap: Optional[int] = None) -> Dict[str, int]:
    """The inter-pod score's launch, as csrc/interpod.cu's
    `interpod_score_smem_bytes` counts it: the filter's layout
    (`interpod_filter_layout`) without the node states, a CTA's node slice
    at most INTERPOD_SCORE_NODES x 256 (its sums live in registers).
    `cluster` and `tcap` override C and tcap (for measuring and testing)."""
    return _interpod_layout("score", pt, tt, n, v, u, cluster, tcap, node_bytes=0,
                            max_slice=INTERPOD_SCORE_NODES * _WARPS * 32)


def interpod_filter_args(nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, ex_terms: Arrays, pods: Arrays,
                         m_pt: Optional[torch.Tensor], m_sig: Optional[torch.Tensor], parts: tuple = FILTER_PARTS,
                         n_buckets: Optional[int] = None, cluster: Optional[int] = None,
                         tcap: Optional[int] = None):
    """The inter-pod filter's argument struct for these CUDA tensors (with
    its device-memory tables where the layout takes them) and the [U, N]
    bool mask its one launch writes. `m_pt` is match_terms(ex_terms, pod
    labels, pod namespaces) [PT, U], read for "existing"; `m_sig`
    match_terms(terms, signature labels, signature namespaces) [TT, S], read
    for "aff" / "anti" (None where unread). `cluster` and `tcap` override
    the layout (for measuring and testing)."""
    tt = _check_terms(terms)
    u = pods["valid"].shape[0]
    n, k = nodes["label_dense"].shape
    s = eps["valid"].shape[0]
    pt = ex_terms["valid"].shape[0]
    v = int(n_buckets or n)
    lay = interpod_filter_layout(pt, tt, n, v, u, cluster, tcap)
    dev = nodes["valid"].device
    tables = {"dtable": torch.empty((u, v), dtype=torch.int32, device=dev)} if lay["tcap"] == 0 else {}
    out = torch.empty((u, n), dtype=torch.bool, device=dev)
    a = InterpodFilterArgs()
    a.label_dense = build.ptr(nodes["label_dense"], torch.int32, (n, k))
    for key, dt in (("valid", torch.bool), ("kind", torch.int32), ("topo_slot", torch.int32)):
        setattr(a, "x_" + key, build.ptr(ex_terms[key], dt, (pt,)))
    _term_ptrs(a, terms, tt, ("valid", "kind", "owner", "topo_slot"))
    a.x_counts = build.ptr(ex_terms["counts"], torch.int16, (n, pt))
    if "existing" in parts:
        a.m_pt = build.ptr(m_pt, torch.bool, (pt, u))
    if "aff" in parts or "anti" in parts:
        a.m_sig = build.ptr(m_sig, torch.bool, (tt, s))
    a.e_valid = build.ptr(eps["valid"], torch.bool, (s,))
    a.counts = build.ptr(eps["counts"], torch.int16, (n, s))
    a.self_aff_match = build.ptr(aux["self_aff_match"], torch.bool, (u,))
    a.has_aff = build.ptr(aux["has_aff"], torch.bool, (u,))
    for name, t in tables.items():
        setattr(a, name, build.ptr(t, t.dtype))
    a.mask = build.ptr(out, torch.bool)
    a.N, a.K, a.PT, a.TT, a.S, a.U, a.V = n, k, pt, tt, s, u, v
    a.parts = sum(_PART_BITS[("filter", p)] for p in set(parts))
    for key, val in lay.items():
        setattr(a, key, val)
    a.keepalive = tables
    return a, out


def interpod_score_args(nodes: Arrays, eps: Arrays, terms: Arrays, ex_terms: Arrays, pods: Arrays,
                        m_pt: Optional[torch.Tensor], m_sig: Optional[torch.Tensor], parts: tuple = SCORE_PARTS,
                        n_buckets: Optional[int] = None, cluster: Optional[int] = None,
                        tcap: Optional[int] = None):
    """The inter-pod score's argument struct for these CUDA tensors (with
    its device-memory tables where the layout takes them, no other
    scratch) and the [U, N] int64 score its one launch writes. `m_pt` is
    match_terms(ex_terms, pod labels, pod namespaces) [PT, U], read for
    "existing"; `m_sig` match_terms(terms, signature labels, signature
    namespaces) [TT, S], read for "pref" (None where unread). `cluster` and
    `tcap` override the layout (for measuring and testing)."""
    tt = _check_terms(terms)
    u = pods["valid"].shape[0]
    n, k = nodes["label_dense"].shape
    s = eps["valid"].shape[0]
    pt = ex_terms["valid"].shape[0]
    v = int(n_buckets or n)
    lay = interpod_score_layout(pt, tt, n, v, u, cluster, tcap)
    dev = nodes["valid"].device
    tables = {"dtable": torch.empty((u, v), dtype=torch.int32, device=dev)} if lay["tcap"] == 0 else {}
    out = torch.empty((u, n), dtype=torch.int64, device=dev)
    a = InterpodArgs()
    a.n_valid = build.ptr(nodes["valid"], torch.bool, (n,))
    a.label_dense = build.ptr(nodes["label_dense"], torch.int32, (n, k))
    for key, dt in (("valid", torch.bool), ("kind", torch.int32), ("topo_slot", torch.int32),
                    ("weight", torch.int32)):
        setattr(a, "x_" + key, build.ptr(ex_terms[key], dt, (pt,)))
        setattr(a, "t_" + key, build.ptr(terms[key], dt, (tt,)))
    a.t_owner = build.ptr(terms["owner"], torch.int32, (tt,))
    a.x_counts = build.ptr(ex_terms["counts"], torch.int16, (n, pt))
    if "existing" in parts:
        a.m_pt = build.ptr(m_pt, torch.bool, (pt, u))
    if "pref" in parts:
        a.m_sig = build.ptr(m_sig, torch.bool, (tt, s))
    a.e_valid = build.ptr(eps["valid"], torch.bool, (s,))
    a.counts = build.ptr(eps["counts"], torch.int16, (n, s))
    a.p_valid = build.ptr(pods["valid"], torch.bool, (u,))
    for name, t in tables.items():
        setattr(a, name, build.ptr(t, t.dtype))
    a.score = build.ptr(out, torch.int64)
    a.N, a.K, a.PT, a.TT, a.S, a.U, a.V = n, k, pt, tt, s, u, v
    a.parts = sum(_PART_BITS[("score", p)] for p in set(parts))
    for key, val in lay.items():
        setattr(a, key, val)
    a.keepalive = tables
    return a, out


def interpod_filter(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, ex_terms: Arrays, pods: Arrays,
    parts: tuple = FILTER_PARTS, n_buckets: Optional[int] = None,
    m_pt: Optional[torch.Tensor] = None, m_sig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The [U, N] bool InterPodAffinityMatches mask over `parts`. CPU
    tensors run the plain version; CUDA tensors launch the match kernel once
    for what the parts read and was not given (patterns x spec rows `m_pt`
    for "existing", terms x signatures `m_sig` for "aff" / "anti": the raw
    matrices of the batch's match plan) and then csrc/interpod.cu's filter
    once, a cluster a spec row (counted in `interpod_filter.launches`; a
    launch whose tables live in device memory also in
    `interpod_filter.device_table_launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return interpod_filter_plain(nodes, eps, terms, aux, ex_terms, pods, parts, n_buckets, m_pt, m_sig)
    if dev.type == "cuda":
        m_pt, m_sig = _interpod_matches(eps, terms, ex_terms, pods, "existing" in parts,
                                        "aff" in parts or "anti" in parts, m_pt, m_sig)
        args, out = interpod_filter_args(nodes, eps, terms, aux, ex_terms, pods, m_pt, m_sig, parts, n_buckets)
        build.launch(INTERPOD_FILTER_ENTRY, args, dev)
        interpod_filter.launches += 1
        interpod_filter.device_table_launches += int(args.tcap == 0)
        return out
    raise ValueError(f"no topology kernel for device {dev}")


interpod_filter.launches = 0
interpod_filter.device_table_launches = 0


def interpod_score(
    nodes: Arrays, eps: Arrays, terms: Arrays, ex_terms: Arrays, pods: Arrays,
    parts: tuple = SCORE_PARTS, n_buckets: Optional[int] = None,
    m_pt: Optional[torch.Tensor] = None, m_sig: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The [U, N] int64 inter-pod affinity priority over `parts`. CPU
    tensors run the plain version; CUDA tensors launch the match kernel once
    for what the parts read and was not given (terms x signatures `m_sig`
    for "pref", patterns x spec rows `m_pt` for "existing") and then
    csrc/interpod.cu's score once, a cluster a spec row (counted in
    `interpod_score.launches`; a launch whose tables live in device memory
    also in `interpod_score.device_table_launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return interpod_score_plain(nodes, eps, terms, ex_terms, pods, parts, n_buckets, m_pt, m_sig)
    if dev.type == "cuda":
        m_pt, m_sig = _interpod_matches(eps, terms, ex_terms, pods, "existing" in parts, "pref" in parts, m_pt, m_sig)
        args, out = interpod_score_args(nodes, eps, terms, ex_terms, pods, m_pt, m_sig, parts, n_buckets)
        build.launch(INTERPOD_SCORE_ENTRY, args, dev)
        interpod_score.launches += 1
        interpod_score.device_table_launches += int(args.tcap == 0)
        return out
    raise ValueError(f"no topology kernel for device {dev}")


interpod_score.launches = 0
interpod_score.device_table_launches = 0


def _interpod_matches(eps: Arrays, terms: Arrays, ex_terms: Arrays, pods: Arrays, patterns: bool,
                      batch_terms: bool, m_pt: Optional[torch.Tensor], m_sig: Optional[torch.Tensor]):
    """The matches the inter-pod kernels read: patterns x spec rows [PT, U]
    and batch terms x signatures [TT, S], both with the namespace test; the
    ones needed and not given come from one match launch, a side the parts
    do not read stays as given (None: the kernels read no pointer there)."""
    want = {}
    if patterns and m_pt is None:
        want["m_pt"] = (ex_terms, pods["label_vals"], pods["ns_id"])
    if batch_terms and m_sig is None:
        want["m_sig"] = (terms, eps["label_vals"], eps["ns_id"])
    got = dict(zip(want, match_terms_multi(list(want.values())))) if want else {}
    return got.get("m_pt", m_pt), got.get("m_sig", m_sig)
