"""The solve pipeline: mask → score → greedy batch solve.

Port of `kubernetes_tpu/ops/pipeline.py` for batches whose topology terms
are DoNotSchedule spread ("spread_hard"), ScheduleAnyway spread
("spread_soft"), SelectorSpread ("sel_spread") and pod (anti-)affinity
("aff_req", "anti_req", "pref" and the existing pods' "et_anti" /
"et_score"), with or without the solver's in-batch anti-affinity /
host-port tracking. The stages are the hand-written kernels of
filters.py, scores.py, topology.py and solver.py on CUDA tensors (their
plain versions on CPU tensors); the glue between them is plain PyTorch.
A DoNotSchedule pod's placement is then re-checked against its batch's
earlier commits by the commit arbiter (commit/arbiter.py), which reads the
solve's intermediates (`arbiter_inputs`) instead of launching them again.
term_kinds=None is the reference's "assume every kind".

`filter_mask` (ref :131) is the mask half alone, for the extender's
/filter route: `mask_and_score` and it build the mask in one function.

`solve_pipeline_gang` (ref :285) is the same mask and score followed by the
all-or-nothing two-pass gang solve (ops/solver.solve_gang).

`gather_score_rows` (ref :374) brings the rows of the [U, N] score matrix
that the driver's host oracle ranks nodes by to the host, so that only
those rows cross: csrc/gather.cu on CUDA tensors, writing straight into
pinned host memory (counted in `gather_score_rows.launches`),
`index_select` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import filters as F
from . import scores as S
from . import topology as T
from ..kernels import build
from ..state.terms import ANTI_REQ
from .solver import pop_order, solve_gang, solve_greedy

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


# term kinds this port computes
PORTED_TERM_KINDS = frozenset({
    "spread_hard", "spread_soft", "sel_spread", "aff_req", "anti_req", "pref", "et_anti", "et_score",
})


def _check_term_kinds(term_kinds) -> frozenset:
    """The term kinds of a batch; None (the reference's "assume everything")
    is every kind. An unknown kind is an error."""
    if term_kinds is None:
        return PORTED_TERM_KINDS
    unknown = sorted(set(term_kinds) - PORTED_TERM_KINDS)
    if unknown:
        raise ValueError(f"unknown topology term kinds {unknown}")
    return frozenset(term_kinds)


def _filter_parts(cfg: SolveConfig, kinds: frozenset) -> tuple:
    """The inter-pod filter's parts a batch runs: under
    MatchInterPodAffinity, those whose term kinds it holds."""
    if not (cfg.predicates is None or "MatchInterPodAffinity" in cfg.predicates):
        return ()
    return tuple(p for p, k in (("existing", "et_anti"), ("aff", "aff_req"), ("anti", "anti_req")) if k in kinds)


def _score_parts(cfg: SolveConfig, kinds: frozenset) -> tuple:
    """The inter-pod score's parts a batch runs: under a non-zero
    InterPodAffinityPriority weight, those whose term kinds it holds."""
    if not cfg.priority_weight("InterPodAffinityPriority", 1):
        return ()
    return tuple(p for p, k in (("pref", "pref"), ("existing", "et_score")) if k in kinds)


def match_plan(
    pa: Arrays, cfg: SolveConfig, kinds: frozenset, *, ea: Optional[Arrays], ta: Optional[Arrays],
    xa: Optional[Arrays], score: bool = True, track_inbatch: bool = False,
) -> Dict[str, torch.Tensor]:
    """Every distinct raw term-match matrix a batch's consumers read, all
    from ONE match launch (`topology.match_terms_multi`; none where no
    consumer reads one):
      m_sig [TT, S]  batch terms x signatures, with namespaces: the inter-pod
                     filter's "aff" / "anti", the inter-pod score's "pref",
                     SelectorSpread (`score`)
      m_pt  [PT, U]  patterns x spec rows, with namespaces: the inter-pod
                     filter's and score's "existing"
      m_bb  [TT, U]  batch terms x spec rows, with namespaces: the solve's
                     in-batch tracking and the arbiter's `m_raw`
    The spread programs match inside their own launches. Each consumer
    applies its own validity and kind masks to the raw matrix (on CPU
    tensors the plain versions read the same matrices)."""
    fparts = set(_filter_parts(cfg, kinds))
    sparts = set(_score_parts(cfg, kinds)) if score else set()
    sel_spread = score and bool(cfg.priority_weight("SelectorSpreadPriority", 1)) and "sel_spread" in kinds
    want = {}
    if fparts & {"aff", "anti"} or "pref" in sparts or sel_spread:
        want["m_sig"] = (ta, ea["label_vals"], ea["ns_id"])
    if "existing" in fparts | sparts:
        want["m_pt"] = (xa, pa["label_vals"], pa["ns_id"])
    if track_inbatch:
        want["m_bb"] = (ta, pa["label_vals"], pa["ns_id"])
    if not want:
        return {}
    return dict(zip(want, T.match_terms_multi(list(want.values()))))


def _mask(
    na: Arrays, pa: Arrays, ids, cfg: SolveConfig, kinds: frozenset, with_selector: bool, *,
    ea: Optional[Arrays], ta: Optional[Arrays], au: Optional[Arrays], xa: Optional[Arrays],
    n_buckets: Optional[int], arbiter_inputs: Optional[Dict], matches: Dict[str, torch.Tensor],
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The Filter half that `mask_and_score` and `filter_mask` share, so the
    gating cannot diverge: the enabled non-topology predicates
    (`combined_mask`), the DoNotSchedule spread filter under the
    EvenPodsSpread predicate, the inter-pod filter's parts under
    MatchInterPodAffinity (reading the batch's `matches`, see match_plan).
    Returns (mask, the raw node-selector output when the spread filter ran
    or `with_selector` asks for it, else None). `plain` calls the kernels'
    plain versions whatever the device (`filter_mask_plain`)."""
    preds = cfg.predicates
    hard = (preds is None or "EvenPodsSpread" in preds) and "spread_hard" in kinds
    sel = None
    # the spread programs' candidate nodes pass the RAW node-selector
    # predicate (no node/pod validity mask): one filter launch gives both
    if plain:
        mask = F.combined_mask_plain(na, pa, ids, preds)
        if with_selector or hard:
            sel = F.pod_match_node_selector(na, pa)
    elif with_selector or hard:
        mask, sel = F.combined_mask(na, pa, ids, predicates=preds, with_selector=True)
    else:
        mask = F.combined_mask(na, pa, ids, predicates=preds)
    if hard:
        spread_filter = T.spread_filter_plain if plain else T.spread_filter
        ok, tables = spread_filter(na, ea, ta, sel, n_buckets=n_buckets, with_tables=True)
        mask = mask & ok
        if arbiter_inputs is not None:
            arbiter_inputs["spread_tables"] = tables
    parts = _filter_parts(cfg, kinds)
    if parts:
        interpod_filter = T.interpod_filter_plain if plain else T.interpod_filter
        mask = mask & interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=n_buckets,
                                      m_pt=matches.get("m_pt"), m_sig=matches.get("m_sig"))
    return mask, sel


def mask_and_score(
    na: Arrays, pa: Arrays, ids, config: Optional[SolveConfig] = None,
    term_kinds: Optional[frozenset] = frozenset(), *,
    ea: Optional[Arrays] = None, ta: Optional[Arrays] = None, au: Optional[Arrays] = None,
    xa: Optional[Arrays] = None, n_buckets: Optional[int] = None, arbiter_inputs: Optional[Dict] = None,
    matches: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Filter+Score stage. `ea` (SigBank tensors), `ta` (batch TermBank
    tensors), `au` (compile_batch_terms aux), `xa` (PatternBank tensors)
    and `n_buckets` (the segment axis bound, None = N) feed the topology
    programs of the kinds named in `term_kinds`, gated as the reference
    gates them: the mask as `_mask` builds it, the inter-pod score's parts
    under a non-zero InterPodAffinityPriority weight.
    Without "sel_spread" the SelectorSpread priority still adds its
    term-absent constant: a pod with no controller selectors scores
    MaxNodeScore on every node (selector_spreading.go), so the score kernel
    carries `w * 10`. The term matches the stage reads come from `matches`
    (the batch's match_plan; computed here, in one launch, when None). A
    dict passed as `arbiter_inputs` receives the raw selector ("sel") and
    the DoNotSchedule tables ("spread_tables") where this stage computed
    them."""
    kinds = _check_term_kinds(term_kinds)
    cfg = config or DEFAULT_SOLVE_CONFIG
    if matches is None:
        matches = match_plan(pa, cfg, kinds, ea=ea, ta=ta, xa=xa)
    w_spread = cfg.priority_weight("EvenPodsSpreadPriority", 1)
    w_sel = cfg.priority_weight("SelectorSpreadPriority", 1)
    spread = bool(w_spread) and "spread_soft" in kinds
    sel_spread = bool(w_sel) and "sel_spread" in kinds
    mask, sel = _mask(na, pa, ids, cfg, kinds, spread, ea=ea, ta=ta, au=au, xa=xa, n_buckets=n_buckets,
                      arbiter_inputs=arbiter_inputs, matches=matches)
    if sel is not None and arbiter_inputs is not None:
        arbiter_inputs["sel"] = sel
    bias = 0 if sel_spread else w_sel * S.MAX_NODE_SCORE
    score = S.score_matrix(na, pa, priorities=cfg.priorities, rtcr=cfg.rtcr, bias=bias)
    w_ipa = cfg.priority_weight("InterPodAffinityPriority", 1)
    parts = _score_parts(cfg, kinds)
    if parts:
        score = score + w_ipa * T.interpod_score(na, ea, ta, xa, pa, parts=parts, n_buckets=n_buckets,
                                                 m_pt=matches.get("m_pt"), m_sig=matches.get("m_sig"))
    if spread:
        score = score + w_spread * T.spread_score(na, ea, ta, au, sel, n_buckets=n_buckets)
    if sel_spread:
        score = score + w_sel * T.selector_spread_score(na, ea, ta, au, n_buckets=n_buckets,
                                                        m_sig=matches.get("m_sig"))
    return mask, score


def filter_mask(
    na: Arrays, pa: Arrays, ids, config: Optional[SolveConfig] = None,
    term_kinds: Optional[frozenset] = frozenset(), *,
    ea: Optional[Arrays] = None, ta: Optional[Arrays] = None, au: Optional[Arrays] = None,
    xa: Optional[Arrays] = None, n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """The Filter-only entry point (ref :131; the extender's /filter
    route): `mask_and_score`'s mask through the same `_mask`, launching no
    score, spread-score or inter-pod-score kernel (its term matches: one
    launch of the match plan, score=False). Its kernels are
    csrc/filters.cu, and csrc/topology.cu's spread filter and
    csrc/interpod.cu's filter where the term kinds ask for them (their
    plain versions on CPU tensors); calls are counted in
    `filter_mask.launches`."""
    kinds = _check_term_kinds(term_kinds)
    cfg = config or DEFAULT_SOLVE_CONFIG
    matches = match_plan(pa, cfg, kinds, ea=ea, ta=ta, xa=xa, score=False)
    mask, _ = _mask(na, pa, ids, cfg, kinds, False, ea=ea, ta=ta, au=au, xa=xa, n_buckets=n_buckets,
                    arbiter_inputs=None, matches=matches)
    if na["valid"].device.type == "cuda":
        filter_mask.launches += 1
    return mask


filter_mask.launches = 0


def filter_mask_plain(
    na: Arrays, pa: Arrays, ids, config: Optional[SolveConfig] = None,
    term_kinds: Optional[frozenset] = frozenset(), *,
    ea: Optional[Arrays] = None, ta: Optional[Arrays] = None, au: Optional[Arrays] = None,
    xa: Optional[Arrays] = None, n_buckets: Optional[int] = None,
) -> torch.Tensor:
    """`filter_mask` through the plain versions of its kernels, on any
    device (what the kernels are held against on the card)."""
    mask, _ = _mask(na, pa, ids, config or DEFAULT_SOLVE_CONFIG, _check_term_kinds(term_kinds), False, ea=ea,
                    ta=ta, au=au, xa=xa, n_buckets=n_buckets, arbiter_inputs=None, matches={}, plain=True)
    return mask


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


def _inbatch_tensors(na: Arrays, pa: Arrays, ta: Arrays, ids, n_buckets: Optional[int],
                     m_bb: Optional[torch.Tensor] = None) -> Dict:
    """solve_greedy's `inb` dict: what lets the solver serialize required
    anti-affinity and host-port conflicts WITHIN the batch. m_bb [TT, U]
    (each term against the spec rows' labels and namespaces) is the batch's
    match plan's, or comes from a match_terms launch when not given, and the
    pairwise port-conflict table [U, U] from the
    inbatch_port_conflict kernel; the solver reads each node's bucket at a
    term's key from the node bank's dense labels (`label_dense`,
    `topo_slot`), so no [TT, N] bucket table is built."""
    return {
        "anti": ta["valid"] & (ta["kind"] == ANTI_REQ),
        "owner": ta["owner"],
        "m_bb": T.match_terms(ta, pa["label_vals"], pa["ns_id"]) if m_bb is None else m_bb,
        "topo_slot": ta["topo_slot"],
        "label_dense": na["label_dense"],
        "port_conflict": F.inbatch_port_conflict(pa, ids),
        "n_buckets": int(n_buckets or na["valid"].shape[0]),
    }


def solve_inputs(
    na: Arrays, pa: Arrays, ids, pb: Optional[Arrays], carry: Optional[Tuple], config: Optional[SolveConfig],
    term_kinds: Optional[frozenset], return_carry: bool, track_inbatch: bool, *, ea: Optional[Arrays],
    ta: Optional[Arrays], au: Optional[Arrays], xa: Optional[Arrays], n_buckets: Optional[int],
    arbiter_inputs: Optional[Dict],
) -> Tuple[Dict, torch.Tensor, Optional[Dict]]:
    """What every solve pipeline (single-device, gang, node-sharded) hands
    its solve: the residual carry overlaid, the mask and score, the pop
    order and the per-pod axis. Returns (the solve's keyword arguments
    but key / deterministic / return_carry / inb, the [U, N] score, the
    in-batch tracking dict or None)."""
    kinds = _check_term_kinds(term_kinds)
    na = apply_carry(na, carry)
    # the batch's term matches: every consumer's raw matrix from one launch
    matches = match_plan(pa, config or DEFAULT_SOLVE_CONFIG, kinds, ea=ea, ta=ta, xa=xa,
                         track_inbatch=track_inbatch)
    mask, score = mask_and_score(
        na, pa, ids, config, term_kinds, ea=ea, ta=ta, au=au, xa=xa, n_buckets=n_buckets,
        arbiter_inputs=arbiter_inputs, matches=matches,
    )
    free0 = na["alloc"] - na["requested"]
    if pb is None:
        sig, pvalid, prio = None, pa["valid"], pa["priority"]
    else:
        sig, pvalid, prio = pb["sig"], pb["valid"], pb["priority"]
    b = pvalid.shape[0]
    order = pop_order(prio, torch.arange(b, dtype=torch.int32, device=pvalid.device), pvalid)
    inb = _inbatch_tensors(na, pa, ta, ids, n_buckets, matches.get("m_bb")) if track_inbatch else None
    if inb is not None and arbiter_inputs is not None:
        arbiter_inputs.update(m_raw=inb["m_bb"], pconf=inb["port_conflict"])
    kw = dict(
        mask=mask, score=score, req=pa["req"], free0=free0,
        count0=na["pod_count"].to(free0.dtype), allowed=na["allowed_pods"].to(free0.dtype),
        order=order, req_any=pa["req_any"], sig=sig, pod_valid=pvalid,
        nz0=na["nonzero_req"].to(free0.dtype) if return_carry else None,
        scoring_req=pa["scoring_req"] if return_carry else None,
    )
    return kw, score, inb


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
    xa: Optional[Arrays] = None,  # PatternBank tensors
    n_buckets: Optional[int] = None,  # topology segment-axis bound
    arbiter_inputs: Optional[Dict] = None,  # filled for commit/arbiter.arbitrate
):
    """mask → score → greedy solve. Returns (assign [B], score [U, N]),
    plus the post-batch (free, count, nz) carry with return_carry.
    `track_inbatch` turns on the solver's in-batch anti-affinity /
    host-port tracking (needs `ta`). A dict passed as `arbiter_inputs`
    receives what the arbiter would otherwise launch again: mask_and_score's
    entries and, with the tracking, the term matches against the spec rows
    ("m_raw") and the port-conflict table ("pconf")."""
    kw, score, inb = solve_inputs(na, pa, ids, pb, carry, config, term_kinds, return_carry, track_inbatch, ea=ea,
                                  ta=ta, au=au, xa=xa, n_buckets=n_buckets, arbiter_inputs=arbiter_inputs)
    result = solve_greedy(**kw, key=key, deterministic=deterministic, return_carry=return_carry, inb=inb)
    if return_carry:
        assign, carry_out = result
        return assign, score, carry_out
    return result, score


def solve_pipeline_gang(
    na: Arrays,  # NodeBank tensors
    pa: Arrays,  # PodBatch tensors (one row per unique pod spec)
    ids,  # interned constants (filters.make_ids)
    key: Sequence[int],  # two uint32 key words, split for the two passes
    group: torch.Tensor,  # [B] group id per batch position, -1 = ungrouped
    pb: Optional[Arrays] = None,  # per-pod axis: sig/valid/priority [B]
    carry: Optional[Tuple] = None,  # (free, count, nz) of the previous batch
    deterministic: bool = False,
    config: Optional[SolveConfig] = None,
    term_kinds: Optional[frozenset] = frozenset(),
    return_carry: bool = False,
    *,
    ea: Optional[Arrays] = None,  # SigBank tensors
    ta: Optional[Arrays] = None,  # batch TermBank tensors
    au: Optional[Arrays] = None,  # compile_batch_terms aux
    xa: Optional[Arrays] = None,  # PatternBank tensors
    n_buckets: Optional[int] = None,  # topology segment-axis bound
):
    """The gang variant (ref :285): the same mask → score, then the
    all-or-nothing two-pass solve (ops/solver.solve_gang). Returns (assign
    [B], score [U, N], gang_ok [B]), plus pass 2's (free, count, nz) carry
    with return_carry. Members of dropped groups come back -1 with gang_ok
    False, their capacity released to the other pods of pass 2. No in-batch
    tracking and no arbiter inputs, as in the reference."""
    kw, score, _ = solve_inputs(na, pa, ids, pb, carry, config, term_kinds, return_carry, False, ea=ea, ta=ta,
                                au=au, xa=xa, n_buckets=n_buckets, arbiter_inputs=None)
    result = solve_gang(**kw, group=group, key=key, deterministic=deterministic, return_carry=return_carry)
    if return_carry:
        assign, gang_ok, carry_out = result
        return assign, score, gang_ok, carry_out
    assign, gang_ok = result
    return assign, score, gang_ok


GATHER_ENTRY = "ktpu_gather_score_rows"
HOST_POINTER_ENTRY = "ktpu_host_pointer"
GATHER_THREADS = 256  # SCORE_GATHER_THREADS in csrc/gather.cu
GATHER_MAX_WORDS = 4  # SCORE_GATHER_MAX_WORDS: 16-byte words a thread (a CTA: 512 x words int64)
GATHER_MIN_CTAS = 264  # SCORE_GATHER_MIN_CTAS: two CTAs an SM before CTAs widen
GATHER_MAX_INLINE = 512  # SCORE_GATHER_MAX_INLINE: row indices in the argument block
_INT32_MAX = 2**31 - 1


def gather_score_rows_plain(score: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[k] = score[idx[k]] for an int32 index vector on score's device."""
    return score.index_select(0, idx.long())


class GatherArgs(ctypes.Structure):
    """Mirror of `struct GatherArgs` in csrc/gather.cu."""

    _fields_ = [("score", ctypes.c_void_p), ("out", ctypes.c_void_p), ("lanes", ctypes.c_void_p),
                ("U", ctypes.c_int32), ("N", ctypes.c_int32), ("K", ctypes.c_int32), ("chunks", ctypes.c_int32),
                ("words", ctypes.c_int32), ("rows", ctypes.c_int32 * GATHER_MAX_INLINE)]


def score_gather_words(k: int, n: int) -> int:
    """16-byte words a thread of the gather: the widest (4, 2) whose launch
    still has GATHER_MIN_CTAS CTAs, else 1."""
    for words in (GATHER_MAX_WORDS, 2):
        if k * -(-n // (2 * GATHER_THREADS * words)) >= GATHER_MIN_CTAS:
            return words
    return 1


def score_rows(rows, u: int) -> List[int]:
    """The row indices `rows` (a sequence of ints, or a 1-D numpy array or
    CPU tensor) as Python ints, each checked against U on the host (the
    reference's jitted gather would clamp one out of range; the driver
    never passes one)."""
    if isinstance(rows, (torch.Tensor, np.ndarray)):
        if rows.ndim != 1:
            raise ValueError(f"expected a 1-D index vector, got shape {tuple(rows.shape)}")
        out = [int(r) for r in rows.tolist()]
    else:
        out = []
        for r in rows:
            if not isinstance(r, (int, np.integer)):
                raise ValueError(f"expected a 1-D index vector of ints, got an entry {r!r}")
            out.append(int(r))
    if out and (min(out) < 0 or max(out) >= u):
        raise IndexError(f"score row index out of range [0, {u}): {out}")
    return out


def score_gather_block(score_ptr: int, out_ptr: int, lanes_ptr: Optional[int], u: int, n: int,
                       rows: Sequence[int]) -> GatherArgs:
    """The gather kernel's argument block for these addresses: the rows
    inline up to GATHER_MAX_INLINE, else `lanes_ptr` (the [K] int32 rows on
    the card); ceil(N / (512 x words)) CTAs a row (score_gather_words)."""
    k = len(rows)
    a = GatherArgs()
    a.score, a.out = score_ptr, out_ptr
    if k <= GATHER_MAX_INLINE:
        a.rows[:k] = rows
    elif lanes_ptr is None:
        raise ValueError(f"{k} rows exceed the argument block's {GATHER_MAX_INLINE}: pass them on the card")
    else:
        a.lanes = lanes_ptr
    a.U, a.N, a.K = u, n, k
    a.words = score_gather_words(k, n)
    a.chunks = -(-n // (2 * GATHER_THREADS * a.words))
    if a.chunks * k > _INT32_MAX:
        raise ValueError(f"a gather of {k} rows of {n} scores exceeds the kernel's 32-bit grid")
    return a


def host_destination_ok(t: torch.Tensor) -> None:
    """Raise unless the pinned CPU tensor `t` is host memory the card
    reaches at the same address (unified addressing: the caching host
    allocator's blocks are). Asked of the driver once a process
    (cudaPointerGetAttributes); every block comes from the same allocator."""
    if not t.is_pinned():
        raise ValueError("the gather's host destination must be pinned memory")
    if host_destination_ok.mapped is None:
        flag = ctypes.c_int(0)
        rc = getattr(build.library(), HOST_POINTER_ENTRY)(ctypes.c_void_p(t.data_ptr()), ctypes.addressof(flag))
        if rc != 0:
            raise build.KernelLaunchError(f"{HOST_POINTER_ENTRY}: CUDA error {rc}")
        host_destination_ok.mapped = bool(flag.value)
    if not host_destination_ok.mapped:
        raise RuntimeError("pinned host memory is not mapped into the card's address space at its host address: "
                           "the score-row gather cannot write the rows to the host")


host_destination_ok.mapped = None  # the card's answer for the caching host allocator's blocks


def gather_args(score: torch.Tensor, rows: Sequence[int], out: torch.Tensor,
                lanes: Optional[torch.Tensor] = None) -> GatherArgs:
    """The gather kernel's argument block: `score` the [U, N] int64 CUDA
    matrix, `rows` checked host ints, `out` the [K, N] int64 destination —
    a CUDA tensor or a pinned CPU tensor —, `lanes` the rows as a [K] int32
    CUDA tensor when K > GATHER_MAX_INLINE (raises on a device, dtype,
    shape or layout the kernel does not take)."""
    u, n = score.shape
    k = len(rows)
    sp = build.ptr(score, torch.int64, (u, n))
    if out.is_cuda:
        op = build.ptr(out, torch.int64, (k, n))
    else:
        if out.dtype != torch.int64 or tuple(out.shape) != (k, n) or not out.is_contiguous():
            raise ValueError(f"expected a contiguous int64 [{k}, {n}] destination, got {out.dtype} "
                             f"{tuple(out.shape)}")
        host_destination_ok(out)
        op = out.data_ptr()
    lp = build.ptr(lanes, torch.int32, (k,)) if lanes is not None else None
    return score_gather_block(sp, op, lp, u, n, rows)


def gather_score_rows(score: torch.Tensor, rows) -> torch.Tensor:
    """The rows `rows` (host indices: a sequence of ints, or a 1-D numpy
    array or CPU tensor) of the [U, N] score matrix, ON THE HOST as a
    [K, N] int64 CPU tensor. Every index is checked against U on the host.
    CPU tensors run the plain version; CUDA tensors launch csrc/gather.cu
    once (counted in `gather_score_rows.launches`) with the rows in its
    argument block (past GATHER_MAX_INLINE: copied from pinned memory
    without blocking) and a pinned host buffer as its destination, then
    wait on one CUDA event: no device output, no separate copy."""
    u, n = score.shape
    idx = score_rows(rows, u)
    dev = score.device
    if dev.type == "cpu":
        return gather_score_rows_plain(score, torch.tensor(idx, dtype=torch.int32))
    if dev.type != "cuda":
        raise ValueError(f"no gather kernel for device {dev}")
    out = torch.empty((len(idx), n), dtype=score.dtype, pin_memory=True)
    if not idx or not n:
        return out
    lanes = None
    if len(idx) > GATHER_MAX_INLINE:
        pinned = torch.tensor(idx, dtype=torch.int32).pin_memory()
        lanes = torch.empty(len(idx), dtype=torch.int32, device=dev)
        lanes.copy_(pinned, non_blocking=True)
    build.launch(GATHER_ENTRY, gather_args(score, idx, out, lanes), dev)
    gather_score_rows.launches += 1
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()
    return out


gather_score_rows.launches = 0
