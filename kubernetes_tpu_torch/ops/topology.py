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
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..kernels import build
from ..state.terms import AFF_PREF, AFF_REQ, ANTI_PREF, ANTI_REQ, SEL_SPREAD, SPREAD_HARD, SPREAD_SOFT
from ..state.tensors import OP_DOES_NOT_EXIST, OP_EXISTS, OP_IN, OP_NEVER, OP_NOT_IN

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
) -> torch.Tensor:
    """CalculateSpreadPriorityMap/Reduce: count same-namespace,
    non-deleting pods matching ALL of the pod's controller selectors; blend
    1/3 node level + 2/3 zone level in float64, fewer is better; truncate.
    [U, N] int64."""
    b = aux["n_sel_spread"].shape[0]
    n = nodes["valid"].shape[0]
    v = n_buckets or n
    ss = terms["valid"] & (terms["kind"] == SEL_SPREAD)
    owner = terms["owner"]
    m_sig = match_terms_plain(terms, eps["label_vals"], eps["ns_id"])  # ns compiled = pod ns
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


FILTER_PARTS = ("existing", "aff", "anti")
SCORE_PARTS = ("pref", "existing")


def interpod_filter_plain(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, ex_terms: Arrays, pods: Arrays,
    parts: tuple = FILTER_PARTS, n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """InterPodAffinityMatches (predicates.go:1269), metadata path, [U, N]:
      "existing"  existing pods' required anti-affinity (PatternBank)
                  blocks the same-topology nodes of the pods it matches;
      "aff"       the pod's required affinity: a node must share a
                  topology value with an existing pod matching ALL its
                  terms (first-pod-in-series escape when none exists);
      "anti"      the pod's required anti-affinity: a node sharing a
                  topology value with a matching existing pod fails.
    A part left out contributes its term-absent identity (pass)."""
    b = pods["valid"].shape[0]
    n = nodes["valid"].shape[0]
    v = n_buckets or n
    result = torch.ones(b, n, dtype=torch.bool, device=nodes["valid"].device)

    if "existing" in parts:
        ex_anti = ex_terms["valid"] & (ex_terms["kind"] == ANTI_REQ)
        m_pt = match_terms_plain(ex_terms, pods["label_vals"], pods["ns_id"]) & ex_anti[:, None]  # [PT, U]
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
        m_sig = match_terms_plain(terms, eps["label_vals"], eps["ns_id"]) & eps["valid"][None, :]  # [TT, S]
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
) -> torch.Tensor:
    """CalculateInterPodAffinityPriority (interpod_affinity.go:99), [U, N]
    int64: weighted same-topology counts from "pref" (the pod's preferred
    terms against existing pods; ANTI_PREF weights are stored negative)
    and "existing" (existing pods' required-affinity (hard weight) and
    preferred terms against the pod), min-max normalized to [0, 10] over
    the valid nodes with 0 clamped in."""
    b = pods["valid"].shape[0]
    n = nodes["valid"].shape[0]
    v = n_buckets or n
    counts = torch.zeros(b, n, dtype=torch.int64, device=nodes["valid"].device)

    if "pref" in parts:
        pref = terms["valid"] & ((terms["kind"] == AFF_PREF) | (terms["kind"] == ANTI_PREF))
        owner = terms["owner"]
        m_sig = match_terms_plain(terms, eps["label_vals"], eps["ns_id"]) & eps["valid"][None, :] & pref[:, None]
        bucket_n, haskey_n = _bucket_of(nodes, terms["topo_slot"])
        cnt_node = _sig_cnt_node(m_sig, eps["counts"])  # [TT, N]
        cnt = _seg_sum(torch.where(haskey_n, cnt_node, 0), bucket_n, v)  # [TT, V]
        contrib_t = torch.where(haskey_n, _gather_rows(cnt, bucket_n), 0) * terms["weight"][:, None]
        counts = counts + _scatter_add(contrib_t.to(torch.int64), owner, pref, b)

    if "existing" in parts:
        kind = ex_terms["kind"]
        ex_score = ex_terms["valid"] & ((kind == AFF_REQ) | (kind == AFF_PREF) | (kind == ANTI_PREF))
        m_pt = match_terms_plain(ex_terms, pods["label_vals"], pods["ns_id"]) & ex_score[:, None]  # [PT, U]
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
SHARED_TABLE_BYTES = 160 * 1024
# the inter-pod kernels stage a row's term and pattern lists in shared memory
MAX_LIST_BYTES = 200 * 1024

# csrc/interpod.cu's part bits
_PART_BITS = {("filter", "existing"): 1, ("filter", "aff"): 2, ("filter", "anti"): 4,
              ("score", "pref"): 8, ("score", "existing"): 16}


class MatchArgs(ctypes.Structure):
    """Mirror of `struct MatchArgs` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "valid", "has_selector", "ml_slot", "ml_val", "ex_op", "ex_slot", "ex_vals",
            "ns_any", "ns_ids", "labels", "ns", "out")]
        + [(d, ctypes.c_int32) for d in ("TT", "X", "K", "ML", "EX", "VALS", "NS")]
    )


class SpreadArgs(ctypes.Structure):
    """Mirror of `struct SpreadArgs` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "t_valid", "t_kind", "t_owner", "t_topo_slot", "m_sig", "e_valid", "counts",
            "n_valid", "label_dense", "sel", "member", "sig_list", "pair_cnt", "pair_present",
            "merged_cnt", "merged_present", "out", "t_self_match", "t_weight", "min_t", "any_pair_t",
            "mask")]
        + [(d, ctypes.c_int32) for d in ("TT", "S", "N", "K", "U", "V", "table_in_shared", "kind")]
    )


class SelSpreadArgs(ctypes.Structure):
    """Mirror of `struct SelSpreadArgs` in csrc/topology.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "t_valid", "t_kind", "t_owner", "m_sig", "n_sel_spread", "e_valid", "e_deleting",
            "counts", "n_valid", "zone_dense", "sig_list", "ztable", "out")]
        + [(d, ctypes.c_int32) for d in ("TT", "S", "N", "U", "V", "table_in_shared")]
    )


def _check_terms(terms: Arrays) -> int:
    tt = terms["valid"].shape[0]
    if tt > MAX_TERMS:
        raise ValueError(f"{tt} term rows exceed the topology kernels' {MAX_TERMS}")
    return tt


def match_args(terms: Arrays, labels: torch.Tensor, ns: Optional[torch.Tensor] = None):
    """The match kernel's argument struct for these CUDA tensors, and the
    [TT, X] bool output it writes. Validates device, dtype, shape and
    contiguity (raises)."""
    tt = terms["valid"].shape[0]
    x, k = labels.shape
    ml, ex, vals = terms["ml_slot"].shape[1], terms["ex_op"].shape[1], terms["ex_vals"].shape[2]
    nsc = terms["ns_ids"].shape[1]
    out = torch.empty((tt, x), dtype=torch.bool, device=labels.device)
    a = MatchArgs()
    a.valid = build.ptr(terms["valid"], torch.bool, (tt,))
    a.has_selector = build.ptr(terms["has_selector"], torch.bool, (tt,))
    a.ml_slot = build.ptr(terms["ml_slot"], torch.int32, (tt, ml))
    a.ml_val = build.ptr(terms["ml_val"], torch.int32, (tt, ml))
    a.ex_op = build.ptr(terms["ex_op"], torch.int32, (tt, ex))
    a.ex_slot = build.ptr(terms["ex_slot"], torch.int32, (tt, ex))
    a.ex_vals = build.ptr(terms["ex_vals"], torch.int32, (tt, ex, vals))
    a.ns_any = build.ptr(terms["ns_any"], torch.bool, (tt,))
    a.ns_ids = build.ptr(terms["ns_ids"], torch.int32, (tt, nsc))
    a.labels = build.ptr(labels, torch.int32)
    a.ns = None if ns is None else build.ptr(ns, torch.int32, (x,))
    a.out = build.ptr(out, torch.bool)
    a.TT, a.X, a.K, a.ML, a.EX, a.VALS, a.NS = tt, x, k, ml, ex, vals, nsc
    return a, out


def match_terms(terms: Arrays, labels: torch.Tensor, ns: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[TT, X] term x subject match. CPU tensors run the plain version;
    CUDA tensors launch csrc/topology.cu (counted in
    `match_terms.launches`)."""
    dev = labels.device
    if dev.type == "cpu":
        return match_terms_plain(terms, labels, ns)
    if dev.type == "cuda":
        args, out = match_args(terms, labels, ns)
        build.launch(MATCH_ENTRY, args, dev)
        match_terms.launches += 1
        return out
    raise ValueError(f"no topology kernel for device {dev}")


match_terms.launches = 0


def _term_ptrs(a, terms: Arrays, tt: int, keys) -> None:
    dts = {"valid": torch.bool, "kind": torch.int32, "owner": torch.int32, "topo_slot": torch.int32}
    for k in keys:
        setattr(a, "t_" + k, build.ptr(terms[k], dts[k], (tt,)))


def spread_args(nodes: Arrays, eps: Arrays, terms: Arrays, m_sig: torch.Tensor,
                selector_mask: torch.Tensor, n_buckets: Optional[int] = None, kind: int = SPREAD_SOFT):
    """The spread kernels' argument struct (with its scratch buffers) and
    the output they write: for SPREAD_SOFT the [U, N] int64 score
    (`m_sig` is match_terms's raw output without the namespace test), for
    SPREAD_HARD the [U, N] bool mask (`m_sig` with the namespace test);
    the hard tables are the scratch `member` (the candidate nodes),
    `merged_cnt`, `merged_present`, `min_t` and `any_pair_t`."""
    tt = _check_terms(terms)
    u, n = selector_mask.shape
    s = eps["valid"].shape[0]
    k = nodes["label_dense"].shape[1]
    v = int(n_buckets or n)
    dev = selector_mask.device
    in_shared = 2 * v * 4 <= SHARED_TABLE_BYTES
    scratch = dict(
        member=torch.empty((u, n), dtype=torch.bool, device=dev),
        sig_list=torch.empty((tt, s), dtype=torch.int32, device=dev),
        pair_cnt=torch.empty((tt, v), dtype=torch.int32, device=dev),
        pair_present=torch.empty((tt, v), dtype=torch.int32, device=dev),
        merged_cnt=torch.empty((tt, v), dtype=torch.int32, device=dev),
        merged_present=torch.empty((tt, v), dtype=torch.bool, device=dev),
    )
    hard = kind == SPREAD_HARD
    if hard:
        scratch.update(min_t=torch.empty((tt,), dtype=torch.int32, device=dev),
                       any_pair_t=torch.empty((tt,), dtype=torch.bool, device=dev))
    out = torch.empty((u, n), dtype=torch.bool if hard else torch.int64, device=dev)
    a = SpreadArgs()
    _term_ptrs(a, terms, tt, ("valid", "kind", "owner", "topo_slot"))
    if hard:
        a.t_self_match = build.ptr(terms["self_match"], torch.bool, (tt,))
        a.t_weight = build.ptr(terms["weight"], torch.int32, (tt,))
    a.m_sig = build.ptr(m_sig, torch.bool, (tt, s))
    a.e_valid = build.ptr(eps["valid"], torch.bool, (s,))
    a.counts = build.ptr(eps["counts"], torch.int16, (n, s))
    a.n_valid = build.ptr(nodes["valid"], torch.bool, (n,))
    a.label_dense = build.ptr(nodes["label_dense"], torch.int32, (n, k))
    a.sel = build.ptr(selector_mask, torch.bool, (u, n))
    for name, t in scratch.items():
        setattr(a, name, build.ptr(t, t.dtype))
    if hard:
        a.mask = build.ptr(out, torch.bool)
    else:
        a.out = build.ptr(out, torch.int64)
    a.TT, a.S, a.N, a.K, a.U, a.V = tt, s, n, k, u, v
    a.table_in_shared = int(in_shared)
    a.kind = kind
    a.keepalive = scratch
    return a, out


def spread_filter(
    nodes: Arrays, eps: Arrays, terms: Arrays, selector_mask: torch.Tensor, n_buckets: Optional[int] = None,
    with_tables: bool = False,
):
    """The [U, N] bool EvenPodsSpread (DoNotSchedule) predicate. CPU
    tensors run the plain version; CUDA tensors launch the match kernel
    (with the namespace test) and then csrc/topology.cu's spread-filter
    entry (counted in `spread_filter.launches`). `selector_mask` is the
    RAW PodMatchNodeSelector matrix. With `with_tables`, the pair (mask,
    the metadata of spread_hard_tables_plain: on the card the launch's own
    scratch)."""
    dev = selector_mask.device
    if dev.type == "cpu":
        return spread_filter_plain(nodes, eps, terms, selector_mask, n_buckets, with_tables)
    if dev.type == "cuda":
        m_sig = match_terms(terms, eps["label_vals"], eps["ns_id"])
        args, out = spread_args(nodes, eps, terms, m_sig, selector_mask, n_buckets, SPREAD_HARD)
        build.launch(SPREAD_FILTER_ENTRY, args, dev)
        spread_filter.launches += 1
        if not with_tables:
            return out
        sc = args.keepalive
        return out, {"cand": sc["member"], "merged_cnt": sc["merged_cnt"], "merged_present": sc["merged_present"],
                     "min_t": sc["min_t"], "any_pair_t": sc["any_pair_t"]}
    raise ValueError(f"no topology kernel for device {dev}")


spread_filter.launches = 0


def spread_score(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, selector_mask: torch.Tensor,
    n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """The [U, N] int64 EvenPodsSpread (ScheduleAnyway) score. CPU tensors
    run the plain version; CUDA tensors launch the match kernel and then
    csrc/topology.cu's spread kernel (counted in `spread_score.launches`).
    `selector_mask` is the RAW PodMatchNodeSelector matrix (not masked by
    node or pod validity)."""
    dev = selector_mask.device
    if dev.type == "cpu":
        return spread_score_plain(nodes, eps, terms, aux, selector_mask, n_buckets)
    if dev.type == "cuda":
        m_sig = match_terms(terms, eps["label_vals"], None)
        args, out = spread_args(nodes, eps, terms, m_sig, selector_mask, n_buckets)
        build.launch(SPREAD_ENTRY, args, dev)
        spread_score.launches += 1
        return out
    raise ValueError(f"no topology kernel for device {dev}")


spread_score.launches = 0


def selector_spread_args(nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, m_sig: torch.Tensor,
                         n_buckets: Optional[int] = None):
    """The selector-spread kernel's argument struct (with its scratch) and
    the [U, N] int64 output it writes. `m_sig` is match_terms's output
    with the namespace test."""
    tt = _check_terms(terms)
    u = aux["n_sel_spread"].shape[0]
    n = nodes["valid"].shape[0]
    s = eps["valid"].shape[0]
    v = int(n_buckets or n)
    dev = m_sig.device
    in_shared = v * 8 <= SHARED_TABLE_BYTES
    scratch = dict(
        sig_list=torch.empty((u, s), dtype=torch.int32, device=dev),
        ztable=torch.empty((u if not in_shared else 1, v), dtype=torch.int64, device=dev),
    )
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
    for name, t in scratch.items():
        setattr(a, name, build.ptr(t, t.dtype))
    a.out = build.ptr(out, torch.int64)
    a.TT, a.S, a.N, a.U, a.V = tt, s, n, u, v
    a.table_in_shared = int(in_shared)
    a.keepalive = scratch
    return a, out


def selector_spread_score(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """The [U, N] int64 SelectorSpread score. CPU tensors run the plain
    version; CUDA tensors launch the match kernel (with the namespace test)
    and then csrc/topology.cu's selector-spread kernel (counted in
    `selector_spread_score.launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return selector_spread_score_plain(nodes, eps, terms, aux, n_buckets)
    if dev.type == "cuda":
        m_sig = match_terms(terms, eps["label_vals"], eps["ns_id"])
        args, out = selector_spread_args(nodes, eps, terms, aux, m_sig, n_buckets)
        build.launch(SEL_SPREAD_ENTRY, args, dev)
        selector_spread_score.launches += 1
        return out
    raise ValueError(f"no topology kernel for device {dev}")


selector_spread_score.launches = 0


class InterpodArgs(ctypes.Structure):
    """Mirror of `struct InterpodArgs` in csrc/interpod.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "n_valid", "label_dense", "x_valid", "x_kind", "x_topo_slot", "x_weight", "x_counts", "m_pt",
            "t_valid", "t_kind", "t_owner", "t_topo_slot", "t_weight", "m_sig", "e_valid", "counts",
            "p_valid", "self_aff_match", "has_aff", "sig_list", "x_table", "t_table", "any_pair",
            "mask", "score")]
        + [(d, ctypes.c_int32) for d in ("N", "K", "PT", "TT", "S", "U", "V", "parts", "table_in_shared")]
    )


def interpod_args(which: str, nodes: Arrays, eps: Arrays, terms: Arrays, ex_terms: Arrays, pods: Arrays,
                  m_pt: torch.Tensor, m_sig: torch.Tensor, parts: tuple, aux: Optional[Arrays] = None,
                  n_buckets: Optional[int] = None):
    """The argument struct (with its scratch) of csrc/interpod.cu's
    `which` ("filter" or "score") entry for these CUDA tensors, and the
    [U, N] output it writes (bool mask or int64 score). `m_pt` is
    match_terms(ex_terms, pod labels, pod namespaces) [PT, U], `m_sig`
    match_terms(terms, signature labels, signature namespaces) [TT, S]."""
    tt = _check_terms(terms)
    u = pods["valid"].shape[0]
    n, k = nodes["label_dense"].shape
    s = eps["valid"].shape[0]
    pt = ex_terms["valid"].shape[0]
    v = int(n_buckets or n)
    dev = nodes["valid"].device
    in_shared = (v + tt) * 4 <= SHARED_TABLE_BYTES
    list_bytes = (pt + 2 * tt) * 4
    if list_bytes > MAX_LIST_BYTES:
        raise ValueError(f"{tt} term rows and {pt} patterns exceed the inter-pod kernels' shared lists")
    scratch = dict(
        sig_list=torch.empty((tt, s), dtype=torch.int32, device=dev),
        x_table=torch.empty((pt, v), dtype=torch.int32, device=dev),
        t_table=torch.empty((tt, v), dtype=torch.int32, device=dev),
        any_pair=torch.empty((tt,), dtype=torch.bool, device=dev),
    )
    out = torch.empty((u, n), dtype=torch.bool if which == "filter" else torch.int64, device=dev)
    a = InterpodArgs()
    a.n_valid = build.ptr(nodes["valid"], torch.bool, (n,))
    a.label_dense = build.ptr(nodes["label_dense"], torch.int32, (n, k))
    for key, dt in (("valid", torch.bool), ("kind", torch.int32), ("topo_slot", torch.int32),
                    ("weight", torch.int32)):
        setattr(a, "x_" + key, build.ptr(ex_terms[key], dt, (pt,)))
        setattr(a, "t_" + key, build.ptr(terms[key], dt, (tt,)))
    a.t_owner = build.ptr(terms["owner"], torch.int32, (tt,))
    a.x_counts = build.ptr(ex_terms["counts"], torch.int16, (n, pt))
    a.m_pt = build.ptr(m_pt, torch.bool, (pt, u))
    a.m_sig = build.ptr(m_sig, torch.bool, (tt, s))
    a.e_valid = build.ptr(eps["valid"], torch.bool, (s,))
    a.counts = build.ptr(eps["counts"], torch.int16, (n, s))
    a.p_valid = build.ptr(pods["valid"], torch.bool, (u,))
    if aux is not None:
        a.self_aff_match = build.ptr(aux["self_aff_match"], torch.bool, (u,))
        a.has_aff = build.ptr(aux["has_aff"], torch.bool, (u,))
    for name, t in scratch.items():
        setattr(a, name, build.ptr(t, t.dtype))
    if which == "filter":
        a.mask = build.ptr(out, torch.bool)
    else:
        a.score = build.ptr(out, torch.int64)
    a.N, a.K, a.PT, a.TT, a.S, a.U, a.V = n, k, pt, tt, s, u, v
    a.parts = sum(_PART_BITS[(which, p)] for p in set(parts))
    a.table_in_shared = int(in_shared)
    a.keepalive = scratch
    return a, out


def interpod_filter(
    nodes: Arrays, eps: Arrays, terms: Arrays, aux: Arrays, ex_terms: Arrays, pods: Arrays,
    parts: tuple = FILTER_PARTS, n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """The [U, N] bool InterPodAffinityMatches mask over `parts`. CPU
    tensors run the plain version; CUDA tensors launch the match kernel
    (patterns x spec rows for "existing", terms x signatures for "aff" /
    "anti") and then csrc/interpod.cu's filter entry (counted in
    `interpod_filter.launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return interpod_filter_plain(nodes, eps, terms, aux, ex_terms, pods, parts, n_buckets)
    if dev.type == "cuda":
        m_pt, m_sig = _interpod_matches(eps, terms, ex_terms, pods, "existing" in parts,
                                        "aff" in parts or "anti" in parts)
        args, out = interpod_args("filter", nodes, eps, terms, ex_terms, pods, m_pt, m_sig, parts, aux, n_buckets)
        build.launch(INTERPOD_FILTER_ENTRY, args, dev)
        interpod_filter.launches += 1
        return out
    raise ValueError(f"no topology kernel for device {dev}")


interpod_filter.launches = 0


def interpod_score(
    nodes: Arrays, eps: Arrays, terms: Arrays, ex_terms: Arrays, pods: Arrays,
    parts: tuple = SCORE_PARTS, n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """The [U, N] int64 inter-pod affinity priority over `parts`. CPU
    tensors run the plain version; CUDA tensors launch the match kernel
    (terms x signatures for "pref", patterns x spec rows for "existing")
    and then csrc/interpod.cu's score entry (counted in
    `interpod_score.launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return interpod_score_plain(nodes, eps, terms, ex_terms, pods, parts, n_buckets)
    if dev.type == "cuda":
        m_pt, m_sig = _interpod_matches(eps, terms, ex_terms, pods, "existing" in parts, "pref" in parts)
        args, out = interpod_args("score", nodes, eps, terms, ex_terms, pods, m_pt, m_sig, parts, None, n_buckets)
        build.launch(INTERPOD_SCORE_ENTRY, args, dev)
        interpod_score.launches += 1
        return out
    raise ValueError(f"no topology kernel for device {dev}")


interpod_score.launches = 0


def _interpod_matches(eps: Arrays, terms: Arrays, ex_terms: Arrays, pods: Arrays, patterns: bool,
                      batch_terms: bool):
    """The match_terms launches the inter-pod kernels read: patterns x spec
    rows [PT, U] and batch terms x signatures [TT, S], both with the
    namespace test; a side the parts do not read is an unread
    placeholder of its shape."""
    dev = pods["valid"].device
    pt, u = ex_terms["valid"].shape[0], pods["valid"].shape[0]
    tt, s = terms["valid"].shape[0], eps["valid"].shape[0]
    m_pt = match_terms(ex_terms, pods["label_vals"], pods["ns_id"]) if patterns else \
        torch.zeros((pt, u), dtype=torch.bool, device=dev)
    m_sig = match_terms(terms, eps["label_vals"], eps["ns_id"]) if batch_terms else \
        torch.zeros((tt, s), dtype=torch.bool, device=dev)
    return m_pt, m_sig
