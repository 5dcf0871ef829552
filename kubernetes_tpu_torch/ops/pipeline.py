"""The solve pipeline: mask → score → greedy batch solve.

Port of `kubernetes_tpu/ops/pipeline.py` for batches whose topology terms
are score-only — ScheduleAnyway spread ("spread_soft") and SelectorSpread
("sel_spread") — and without in-batch anti-affinity/port tracking: the
slices this port runs. The stages are the hand-written kernels of
filters.py, scores.py, topology.py and solver.py on CUDA tensors (their
plain versions on CPU tensors); the glue between them is plain PyTorch.
Any other term kind raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import filters as F
from . import scores as S
from . import topology as T
from .solver import pop_order, solve_greedy

Arrays = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class SolveConfig:
    """Device-solve policy: which predicates gate the mask and which
    (priority, weight) pairs sum into the score — the algorithm-provider /
    Policy selection (factory.go CreateFromKeys). None = the default
    provider."""

    predicates: Optional[frozenset] = None
    priorities: Optional[Tuple[Tuple[str, int], ...]] = None
    # RequestedToCapacityRatio Policy argument: (shape points, resource
    # weights) (api/types.go RequestedToCapacityRatioArguments)
    rtcr: Optional[Tuple[Tuple[Tuple[int, int], ...], Tuple[Tuple[str, int], ...]]] = None

    def priority_weight(self, name: str, default: int) -> int:
        if self.priorities is None:
            return default
        for n, w in self.priorities:
            if n == name:
                return w
        return 0


DEFAULT_SOLVE_CONFIG = SolveConfig()


# term kinds this port computes (score-only: no host re-check needed)
PORTED_TERM_KINDS = frozenset({"spread_soft", "sel_spread"})
_UNPORTED_KIND_ITEMS = {
    "spread_hard": "ops/topology spread_filter with the commit arbiter (ROADMAP.md queue 1, arbiter slice)",
    "aff_req": "ops/topology interpod_filter (ROADMAP.md queue 1, slice 3)",
    "anti_req": "ops/topology interpod_filter (ROADMAP.md queue 1, slice 3)",
    "pref": "ops/topology interpod_score (ROADMAP.md queue 1, slice 3)",
    "et_anti": "the PatternBank and interpod_filter (ROADMAP.md queue 1, slice 3)",
    "et_score": "the PatternBank and interpod_score (ROADMAP.md queue 1, slice 3)",
}


def _check_term_kinds(term_kinds) -> frozenset:
    """The term kinds of a batch, refused unless every one is ported. None
    (the reference's "assume everything") is refused too."""
    if term_kinds is None:
        raise NotImplementedError(
            "term_kinds=None assumes every topology kind; the inter-pod programs need "
            "ROADMAP.md queue 1, slice 3"
        )
    unported = sorted(set(term_kinds) - PORTED_TERM_KINDS)
    if unported:
        raise NotImplementedError(
            f"topology term kinds {unported} need "
            + "; ".join(_UNPORTED_KIND_ITEMS.get(k, "ROADMAP.md queue 1, slice 3") for k in unported)
        )
    return frozenset(term_kinds)


def mask_and_score(
    na: Arrays, pa: Arrays, ids, config: Optional[SolveConfig] = None,
    term_kinds: Optional[frozenset] = frozenset(), *,
    ea: Optional[Arrays] = None, ta: Optional[Arrays] = None, au: Optional[Arrays] = None,
    n_buckets: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Filter+Score stage. `ea` (SigBank tensors), `ta` (batch TermBank
    tensors), `au` (compile_batch_terms aux) and `n_buckets` (the segment
    axis bound, None = N) feed the topology scores of the kinds named in
    `term_kinds`, gated as the reference gates them. Without "sel_spread"
    the SelectorSpread priority still adds its term-absent constant: a pod
    with no controller selectors scores MaxNodeScore on every node
    (selector_spreading.go), so the score kernel carries `w * 10`."""
    kinds = _check_term_kinds(term_kinds)
    cfg = config or DEFAULT_SOLVE_CONFIG
    w_spread = cfg.priority_weight("EvenPodsSpreadPriority", 1)
    w_sel = cfg.priority_weight("SelectorSpreadPriority", 1)
    spread = bool(w_spread) and "spread_soft" in kinds
    sel_spread = bool(w_sel) and "sel_spread" in kinds
    # the spread score's candidate nodes pass the RAW node-selector
    # predicate (no node/pod validity mask): one filter launch gives both
    if spread:
        mask, sel = F.combined_mask(na, pa, ids, predicates=cfg.predicates, with_selector=True)
    else:
        mask = F.combined_mask(na, pa, ids, predicates=cfg.predicates)
    bias = 0 if sel_spread else w_sel * S.MAX_NODE_SCORE
    score = S.score_matrix(na, pa, priorities=cfg.priorities, rtcr=cfg.rtcr, bias=bias)
    if spread:
        score = score + w_spread * T.spread_score(na, ea, ta, au, sel, n_buckets=n_buckets)
    if sel_spread:
        score = score + w_sel * T.selector_spread_score(na, ea, ta, au, n_buckets=n_buckets)
    return mask, score


def apply_carry(na: Arrays, carry: Optional[Tuple]) -> Arrays:
    """Overlay a previous batch's residual carry onto the node bank's
    pod-driven columns (the speculative-pipelining contract)."""
    if carry is None:
        return na
    free_in, count_in, nz_in = carry
    return {
        **na,
        "requested": na["alloc"] - free_in,
        "pod_count": count_in,
        "nonzero_req": nz_in,
    }


def solve_pipeline(
    na: Arrays,  # NodeBank tensors
    pa: Arrays,  # PodBatch tensors (one row per unique pod spec)
    ids,  # interned constants (filters.make_ids)
    key: Sequence[int],  # two uint32 key words for selectHost tie-breaks
    pb: Optional[Arrays] = None,  # per-pod axis: sig/valid/priority [B]
    carry: Optional[Tuple] = None,  # (free, count, nz) of the previous batch
    deterministic: bool = False,
    config: Optional[SolveConfig] = None,
    term_kinds: Optional[frozenset] = frozenset(),
    return_carry: bool = False,
    track_inbatch: bool = False,
    *,
    ea: Optional[Arrays] = None,  # SigBank tensors
    ta: Optional[Arrays] = None,  # batch TermBank tensors
    au: Optional[Arrays] = None,  # compile_batch_terms aux
    n_buckets: Optional[int] = None,  # topology segment-axis bound
):
    """mask → score → greedy solve. Returns (assign [B], score [U, N]),
    plus the post-batch (free, count, nz) carry with return_carry."""
    _check_term_kinds(term_kinds)
    if track_inbatch:
        raise NotImplementedError(
            "in-batch anti-affinity/host-port tracking needs the solver's inb "
            "tables (ROADMAP.md queue 1, slice 3)"
        )
    na = apply_carry(na, carry)
    mask, score = mask_and_score(
        na, pa, ids, config, term_kinds, ea=ea, ta=ta, au=au, n_buckets=n_buckets
    )
    free0 = na["alloc"] - na["requested"]
    if pb is None:
        sig, pvalid, prio = None, pa["valid"], pa["priority"]
    else:
        sig, pvalid, prio = pb["sig"], pb["valid"], pb["priority"]
    b = pvalid.shape[0]
    order = pop_order(prio, torch.arange(b, dtype=torch.int32, device=pvalid.device), pvalid)
    result = solve_greedy(
        mask, score, pa["req"], free0,
        na["pod_count"].to(free0.dtype), na["allowed_pods"].to(free0.dtype),
        order, key, deterministic=deterministic, req_any=pa["req_any"],
        sig=sig, pod_valid=pvalid, return_carry=return_carry,
        nz0=na["nonzero_req"].to(free0.dtype) if return_carry else None,
        scoring_req=pa["scoring_req"] if return_carry else None,
    )
    if return_carry:
        assign, carry_out = result
        return assign, score, carry_out
    return result, score
