"""Device commit arbiter: the sequential-equivalent verdict pass.

Port of `kubernetes_tpu/commit/arbiter.py` (`V_PLACE` / `V_DEFER` /
`V_NOFIT` :53-55, `ARBITER_COVERED_KINDS` and `kinds_covered` :65-73,
`_spread_tables` :76, `arbitrate` :157). The solve picks nodes against the
batch-start state; the arbiter replays the batch in pop order against the
commits made earlier in the same batch and gives each pod a verdict:

  V_PLACE  the pick survives every earlier commit of the batch: capacity,
           pod count, required anti-affinity (both directions), host ports
           and DoNotSchedule topology spread;
  V_DEFER  an earlier commit invalidated the pick, or a -1 may have become
           feasible because a commit raised a hard-spread domain minimum:
           the pod retries next batch, against a mask that sees the commit;
  V_NOFIT  the solve's -1 stands.

The state the walk carries is the solver's in-batch tracking (ca, cb, cs:
commits matched by / owning each anti term per topology value, commits per
(spec, node)) plus a hard-spread delta table (md, mh) replaying
spread_filter's merged per-(term, topology value) counts
(ops/topology.spread_hard_tables_plain).

The arbiter reads what the batch's solve already computed — the term
matches against the spec rows, the port-conflict table, spread_filter's
tables — from the dict the driver passed solve_pipeline as
`arbiter_inputs`; only what is missing there is computed here.

`arbitrate_plain` is the reference's scan as a Python loop of PyTorch ops;
the reference's float32 ca / cb / cs tables are only compared > 0, so they
are int32 here. On CUDA tensors `arbitrate` launches csrc/arbiter.cu: its
grid-wide launches hoist every fact no commit can change (each spec row's
relevant terms and clash list, each placed pod's buckets), then a
thread-block cluster of one CTA walks the same B steps (counted in
`arbitrate.launches`).
`host_arbitrate` (ref :583) is the arbiter's executable spec: the same
walk on the host by the full oracle predicate chain; only the tests call
it.

`arbitrate_sharded` (ref :323 `_arbiter_body_sharded`, :484
`make_sharded_arbiter`) is the same scan over a node mesh's shards: the
residuals and cs shard-local, the tables replicated, one packed
owner-shard broadcast a step. `arbitrate_sharded_plain` writes the shard
axis out; on CUDA tensors the same csrc/arbiter.cu scan runs it as a
cluster of one CTA a shard (`arbitrate_sharded.launches`).
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch

from ..api.selectors import match_label_selector
from ..kernels import build
from ..ops import filters as F
from ..ops import topology as T
from ..ops.pipeline import apply_carry, inbatch_matches
from ..ops.solver import pop_order
from ..oracle.nodeinfo import Snapshot
from ..oracle.predicates import compute_predicate_metadata, get_hard_spread_constraints, pod_fits_on_node
from ..parallel.mesh import node_shards, shard_rows
from ..state.terms import ANTI_REQ, SPREAD_HARD

Arrays = Dict[str, torch.Tensor]

V_PLACE = 0
V_DEFER = 1
V_NOFIT = 2

_BIG = 2**30

#: term kinds whose in-batch interactions the arbiter resolves exactly; a
#: batch presenting any other kind takes another commit route. Score-only
#: kinds shift scores, never validity; et_anti is static within a batch.
ARBITER_COVERED_KINDS = frozenset({
    "anti_req", "spread_hard", "spread_soft", "pref", "sel_spread", "et_anti", "et_score",
})

ARBITER_ENTRY = "ktpu_arbitrate"
# ca, cb and the merged counts live in shared memory while they fit, cs too
SHARED_TABLE_BYTES = 200 * 1024


def kinds_covered(present_kinds) -> bool:
    """True when every term kind present in a batch is arbiter-covered."""
    return frozenset(present_kinds) <= ARBITER_COVERED_KINDS


def _solve_inputs(na: Arrays, pa: Arrays, ea: Arrays, ta: Arrays, ids, inputs: Optional[Dict], have_spread: bool,
                  v: int, plain: bool) -> Dict:
    """The solve's intermediates the verdict scan reads — term matches
    against the spec rows (`m_raw`), the port-conflict table (`pconf`) and,
    with `have_spread`, spread_filter's tables — taken from `inputs` (the
    solve's `arbiter_inputs`) where present, else computed here: by the
    plain versions with `plain`, else by the same counted kernels the
    solve launches (`m_raw` and `pconf` from one match launch)."""
    got = dict(inputs or {})
    if plain:
        if "m_raw" not in got:
            got["m_raw"] = T.match_terms_plain(ta, pa["label_vals"], pa["ns_id"])
        if "pconf" not in got:
            got["pconf"] = F.inbatch_port_conflict_plain(pa, ids)
    else:
        got["m_raw"], got["pconf"] = inbatch_matches(pa, ta, ids, got.get("m_raw"), got.get("pconf"))
    if have_spread and "spread_tables" not in got:
        sel = got.get("sel")
        if plain:
            sel = F.pod_match_node_selector(na, pa) if sel is None else sel
            got["spread_tables"] = T.spread_hard_tables_plain(na, ea, ta, sel, v)
        else:
            if sel is None:
                _, sel = F.combined_mask(na, pa, ids, with_selector=True)
            _, got["spread_tables"] = T.spread_filter(na, ea, ta, sel, n_buckets=v, with_tables=True)
    return got


def _spread_tables(pa: Arrays, ta: Arrays, tb: Arrays, m_raw: torch.Tensor) -> Arrays:
    """The pre-batch DoNotSchedule metadata of the plain verdict scan: exactly
    spread_filter's merged per-(term, topology value) counts (`tb`, see
    spread_hard_tables_plain), the candidate node rows, per spec row whether
    any of its hard terms sees a value, the hard terms' matches against
    the batch's spec rows (`m_raw` is match_terms(ta, spec labels, spec
    namespaces)), and `gm`: per (term, spec row) the matches summed over
    the term's (owner, key) group — the reference's f32 product of two 0/1
    matrices, here an integer count."""
    u = pa["valid"].shape[0]
    hard = ta["valid"] & (ta["kind"] == SPREAD_HARD)
    owner = ta["owner"]
    m_batch_hard = m_raw & hard[:, None]
    same = (hard[:, None] & hard[None, :] & (owner[:, None] == owner[None, :])
            & (ta["topo_slot"][:, None] == ta["topo_slot"][None, :]))
    gm = (same.to(torch.float64) @ m_batch_hard.to(torch.float64)).to(torch.int32)  # [TT, U]
    return {
        "hard": hard, "owner": owner, "cand": tb["cand"],
        "merged_cnt0": tb["merged_cnt"].to(torch.int32), "merged_present": tb["merged_present"],
        "any_pair_t": tb["any_pair_t"], "any_pair_u": T._owner_any(tb["any_pair_t"], owner, hard, u),
        "m_batch_hard": m_batch_hard, "gm": gm,
        "self_m": ta["self_match"].to(torch.int32), "skew": ta["weight"].to(torch.int32),
    }


def arbitrate_plain(
    na: Arrays, pa: Arrays, ea: Arrays, ta: Arrays, ids, assign: torch.Tensor, pb: Arrays,
    carry: Optional[Tuple] = None, term_kinds: Optional[frozenset] = None, n_buckets: Optional[int] = None,
    inputs: Optional[Dict] = None,
) -> torch.Tensor:
    """Verdict [B] (V_PLACE / V_DEFER / V_NOFIT) per batch position: the
    reference's lax.scan over pop order, step for step. `inputs`: the
    solve's `arbiter_inputs` (see _solve_inputs)."""
    na = apply_carry(na, carry)
    dev = assign.device
    sig, pod_valid = pb["sig"], pb["valid"]
    b = sig.shape[0]
    u_cap = pa["valid"].shape[0]
    n = na["valid"].shape[0]
    v = n_buckets or n
    order = pop_order(pb["priority"], torch.arange(b, dtype=torch.int32, device=dev), pod_valid)

    free = na["alloc"] - na["requested"]
    count = na["pod_count"].to(free.dtype).clone()
    allowed = na["allowed_pods"].to(free.dtype)
    req, req_any = pa["req"], pa["req_any"]

    t_anti = ta["valid"] & (ta["kind"] == ANTI_REQ)
    t_owner = ta["owner"]
    have_spread = term_kinds is None or "spread_hard" in term_kinds
    got = _solve_inputs(na, pa, ea, ta, ids, inputs, have_spread, v, plain=True)
    m_raw = got["m_raw"]  # [TT, U]
    m_bb = m_raw & t_anti[:, None]
    bucket_n, haskey_n = T._bucket_of(na, ta["topo_slot"])
    bucket_n = bucket_n.long()
    pconf = got["pconf"]
    tt = t_anti.shape[0]
    t_rows = torch.arange(tt, device=dev)

    if have_spread:
        sp = _spread_tables(pa, ta, got["spread_tables"], m_raw)
        hard, owner = sp["hard"], sp["owner"]
        cand_t = sp["cand"][owner.long()]  # [TT, N]

    ca = torch.zeros((tt, v), dtype=torch.int32, device=dev)
    cb = torch.zeros((tt, v), dtype=torch.int32, device=dev)
    cs = torch.zeros((u_cap, n), dtype=torch.int32, device=dev)
    md = torch.zeros((tt, v), dtype=torch.int32, device=dev)
    mh = torch.zeros((tt,), dtype=torch.int32, device=dev)
    verdict = torch.full((b,), V_NOFIT, dtype=torch.int32, device=dev)
    sig_l, assign_l, pv_l = sig.tolist(), assign.tolist(), pod_valid.tolist()

    def scatter_add(table, mask, buck, val):
        # table[t, buck[t]] += val[t] where mask, buckets >= V dropped
        keep = mask & (buck < v)
        table.index_put_((t_rows[keep], buck[keep]), val[keep].to(table.dtype), accumulate=True)

    for p in order.tolist():
        if not pv_l[p]:
            continue  # V_NOFIT; commits nothing
        u, nrow = sig_l[p], assign_l[p]
        is_m1 = nrow < 0
        ncl = max(nrow, 0)
        r_q = req[u]
        cap_ok = (~req_any[u] | (r_q <= free[ncl]).all()) & (count[ncl] + 1 <= allowed[ncl])
        buck = bucket_n[:, ncl]
        bc = buck.clamp(max=v - 1)  # gathers clamp
        hk = haskey_n[:, ncl]
        own_u = (t_owner == u) & t_anti
        block_a = (own_u & hk & (ca[t_rows, bc] > 0)).any()
        block_b = (m_bb[:, u] & hk & (cb[t_rows, bc] > 0)).any()
        block_p = (pconf[u] & (cs[:, ncl] > 0)).any()
        if have_spread:
            own_h = hard & (owner == u)
            cnt = sp["merged_cnt0"] + md
            present = sp["merged_present"]
            min_t = torch.where(present, cnt, _BIG).amin(dim=1)
            at_b = torch.where(present[t_rows, bc], cnt[t_rows, bc], 0)
            skew_ok_t = hk & (at_b + sp["self_m"] - min_t <= sp["skew"])
            sp_ok = torch.where(own_h, skew_ok_t, True).all() | ~sp["any_pair_u"][u]
            couldfit = (own_h & (mh > 0)).any()
        else:
            sp_ok = torch.ones((), dtype=torch.bool, device=dev)
            couldfit = torch.zeros((), dtype=torch.bool, device=dev)
        ok = cap_ok & ~block_a & ~block_b & ~block_p & sp_ok
        if is_m1:
            verdict[p] = torch.where(couldfit, V_DEFER, V_NOFIT)
            continue
        verdict[p] = torch.where(ok, V_PLACE, V_DEFER)
        commit = ok
        free[ncl] -= r_q * commit
        count[ncl] += commit.to(count.dtype)
        hkc = hk & commit
        ones = torch.ones(tt, dtype=torch.int32, device=dev)
        scatter_add(ca, m_bb[:, u] & hkc, buck, ones)
        scatter_add(cb, own_u & hkc, buck, ones)
        cs[u, ncl] += commit.to(cs.dtype)
        if have_spread:
            contrib = torch.where(hard & commit & cand_t[:, ncl], sp["gm"][:, u], 0)
            scatter_add(md, contrib > 0, buck, contrib)
            mh += (sp["m_batch_hard"][:, u] & commit).to(mh.dtype)
    return verdict


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

class ArbiterArgs(ctypes.Structure):
    """Mirror of `struct ArbiterArgs` in csrc/arbiter.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "order", "sig", "pod_valid", "assign", "free0", "count0", "allowed", "req", "req_any",
            "t_valid", "t_kind", "t_owner", "t_topo_slot", "t_self_match", "t_weight", "m_raw",
            "label_dense", "pconf", "cand", "merged_cnt0", "merged_present", "any_pair_t",
            "free_", "count", "ca", "cb", "cs", "mc", "rel", "relg", "rel_n", "conf", "conf_n", "cs_read", "facts",
            "steps", "n_steps", "verdict")]
        + [(d, ctypes.c_int32) for d in (
            "B", "U", "N", "R", "TT", "K", "V", "have_spread", "tables_in_shared", "cs_in_shared")]
    )


class ClusterArbiterArgs(ctypes.Structure):
    """Mirror of `struct ClusterArbiterArgs` in csrc/arbiter.cu."""

    _fields_ = [("arb", ArbiterArgs), ("S", ctypes.c_int32), ("Nl", ctypes.c_int32)]


def arbiter_args(na: Arrays, pa: Arrays, ea: Arrays, ta: Arrays, ids, assign: torch.Tensor, pb: Arrays,
                 carry: Optional[Tuple] = None, term_kinds: Optional[frozenset] = None,
                 n_buckets: Optional[int] = None, inputs: Optional[Dict] = None, shards: int = 1):
    """The arbiter kernel's argument struct for a cluster of `shards` CTAs
    (1 on one device, one a node shard on a mesh), with its scratch, the
    pop order and the solve's intermediates (see _solve_inputs), and the
    [B] int32 verdict it writes. The scratch holds one replica of ca / cb /
    the merged counts a CTA where they do not fit shared memory, the
    hoisted per-spec term words, clash lists and per-pod facts, and the
    step list; a CTA's cs columns share the shared-memory budget."""
    na = apply_carry(na, carry)
    dev = assign.device
    sig, pod_valid = pb["sig"], pb["valid"]
    b = sig.shape[0]
    u = pa["valid"].shape[0]
    n, k = na["label_dense"].shape
    r = na["alloc"].shape[1]
    tt = ta["valid"].shape[0]
    v = int(n_buckets or n)
    order = pop_order(pb["priority"], torch.arange(b, dtype=torch.int32, device=dev), pod_valid)
    have_spread = term_kinds is None or "spread_hard" in term_kinds
    got = _solve_inputs(na, pa, ea, ta, ids, inputs, have_spread, v, plain=False)
    m_raw, pconf = got["m_raw"], got["pconf"]
    keep = {"order": order, "m_raw": m_raw, "pconf": pconf,
            "free0": (na["alloc"] - na["requested"]).contiguous(),
            "count0": na["pod_count"].to(torch.int64), "allowed": na["allowed_pods"].to(torch.int64)}
    if have_spread:
        keep.update(got["spread_tables"])
    reps = shards
    n_cols = shard_rows(n, shards)  # cs columns a CTA keeps
    # shared memory: the per-term minimum, values at it and mh [TT] int32;
    # ca, cb (and the merged counts with hard spread) [TT, V] int32; cs [U, Nl]
    n_tables = 3 if have_spread else 2
    table_bytes = 3 * tt * 4 + n_tables * tt * v * 4
    in_shared = table_bytes <= SHARED_TABLE_BYTES
    cs_shared = in_shared and table_bytes + u * n_cols * 4 <= SHARED_TABLE_BYTES
    in_dev = 0 if in_shared else reps * tt
    scratch = dict(
        free_=torch.empty((n, r), dtype=torch.int64, device=dev),
        count=torch.empty((n,), dtype=torch.int64, device=dev),
        ca=torch.empty((in_dev, v), dtype=torch.int32, device=dev),
        cb=torch.empty((in_dev, v), dtype=torch.int32, device=dev),
        mc=torch.empty((in_dev if have_spread else 0, v), dtype=torch.int32, device=dev),
        cs=torch.empty((0 if cs_shared else u, n), dtype=torch.int32, device=dev),
        rel=torch.empty((u, tt), dtype=torch.int32, device=dev),
        relg=torch.empty((u, tt), dtype=torch.int32, device=dev),
        rel_n=torch.empty((u,), dtype=torch.int32, device=dev),
        conf=torch.empty((u, u), dtype=torch.int32, device=dev),
        conf_n=torch.empty((u,), dtype=torch.int32, device=dev),
        cs_read=torch.empty((u,), dtype=torch.int32, device=dev),
        facts=torch.empty((b, tt), dtype=torch.int32, device=dev),
        steps=torch.empty((b, 4), dtype=torch.int32, device=dev),
        n_steps=torch.empty((1,), dtype=torch.int32, device=dev),
    )
    verdict = torch.empty((b,), dtype=torch.int32, device=dev)
    a = ArbiterArgs()
    a.order = build.ptr(order, torch.int64, (b,))
    a.sig = build.ptr(sig, torch.int32, (b,))
    a.pod_valid = build.ptr(pod_valid, torch.bool, (b,))
    a.assign = build.ptr(assign, torch.int32, (b,))
    a.free0 = build.ptr(keep["free0"], torch.int64, (n, r))
    a.count0 = build.ptr(keep["count0"], torch.int64, (n,))
    a.allowed = build.ptr(keep["allowed"], torch.int64, (n,))
    a.req = build.ptr(pa["req"], torch.int64, (u, r))
    a.req_any = build.ptr(pa["req_any"], torch.bool, (u,))
    for key, dt in (("valid", torch.bool), ("kind", torch.int32), ("owner", torch.int32),
                    ("topo_slot", torch.int32), ("self_match", torch.bool), ("weight", torch.int32)):
        setattr(a, "t_" + key, build.ptr(ta[key], dt, (tt,)))
    a.m_raw = build.ptr(m_raw, torch.bool, (tt, u))
    a.label_dense = build.ptr(na["label_dense"], torch.int32, (n, k))
    a.pconf = build.ptr(pconf, torch.bool, (u, u))
    if have_spread:
        a.cand = build.ptr(keep["cand"], torch.bool, (u, n))
        a.merged_cnt0 = build.ptr(keep["merged_cnt"], torch.int32, (tt, v))
        a.merged_present = build.ptr(keep["merged_present"], torch.bool, (tt, v))
        a.any_pair_t = build.ptr(keep["any_pair_t"], torch.bool, (tt,))
    for name, t in scratch.items():
        setattr(a, name, build.ptr(t, t.dtype))
    a.verdict = build.ptr(verdict, torch.int32)
    a.B, a.U, a.N, a.R, a.TT, a.K, a.V = b, u, n, r, tt, k, v
    a.have_spread = int(have_spread)
    a.tables_in_shared = int(in_shared)
    a.cs_in_shared = int(cs_shared)
    a.keepalive = (keep, scratch)
    args = ClusterArbiterArgs(arb=a, S=shards, Nl=n_cols)
    args.keepalive = a
    return args, verdict


def _launch_arbiter(args: ClusterArbiterArgs, dev) -> None:
    """Launch csrc/arbiter.cu's scan as one cluster of `args.S` CTAs; more
    than build.MAX_CLUSTER CTAs, or a cluster the card cannot co-schedule,
    raises."""
    a = args.arb
    build.check_clusters(ARBITER_ENTRY, args, (a.TT, a.V, a.U, a.tables_in_shared, a.cs_in_shared))
    build.launch(ARBITER_ENTRY, args, dev)


def arbitrate(
    na: Arrays, pa: Arrays, ea: Arrays, ta: Arrays, ids, assign: torch.Tensor, pb: Arrays,
    carry: Optional[Tuple] = None, term_kinds: Optional[frozenset] = None, n_buckets: Optional[int] = None,
    inputs: Optional[Dict] = None,
) -> torch.Tensor:
    """Verdict [B] per batch position. CPU tensors run the plain version;
    CUDA tensors launch csrc/arbiter.cu, its scan one CTA (counted in
    `arbitrate.launches`).
    `carry` is the residual carry the solve ran on; `inputs` is the dict
    the solve filled as `arbiter_inputs` (what is missing there is
    launched first, see _solve_inputs)."""
    dev = assign.device
    if dev.type == "cpu":
        return arbitrate_plain(na, pa, ea, ta, ids, assign, pb, carry, term_kinds, n_buckets, inputs)
    if dev.type == "cuda":
        args, verdict = arbiter_args(na, pa, ea, ta, ids, assign, pb, carry, term_kinds, n_buckets, inputs)
        _launch_arbiter(args, dev)
        arbitrate.launches += 1
        return verdict
    raise ValueError(f"no arbiter kernel for device {dev}")


arbitrate.launches = 0


# ---------------------------------------------------------------------------
# the verdict scan over node shards
# ---------------------------------------------------------------------------

def arbitrate_sharded_plain(
    shards: int, na: Arrays, pa: Arrays, ea: Arrays, ta: Arrays, ids, assign: torch.Tensor, pb: Arrays,
    carry: Optional[Tuple] = None, term_kinds: Optional[frozenset] = None, n_buckets: Optional[int] = None,
    inputs: Optional[Dict] = None,
) -> torch.Tensor:
    """The reference's shard_map'd verdict scan (arbiter.py:323
    _arbiter_body_sharded) with the shard axis written out: shard s owns
    node rows [s * Nl, (s + 1) * Nl) with their residuals, count and cs
    columns; each step the assigned node's owner packs its facts (capacity,
    host-port clash, per term has-key, bucket and DoNotSchedule candidate
    bit), every other shard the identity of max, and one max over shards
    broadcasts them; the ca / cb / md / mh tables are replicated and
    updated from the broadcast facts. The same verdicts as
    `arbitrate_plain`."""
    na = apply_carry(na, carry)
    dev = assign.device
    sig, pod_valid = pb["sig"], pb["valid"]
    b = sig.shape[0]
    u_cap = pa["valid"].shape[0]
    n = na["valid"].shape[0]
    nl = shard_rows(n, shards)
    v = n_buckets or n
    order = pop_order(pb["priority"], torch.arange(b, dtype=torch.int32, device=dev), pod_valid)
    r = na["alloc"].shape[1]
    free = (na["alloc"] - na["requested"]).view(shards, nl, r).clone()  # shard-local
    count = na["pod_count"].to(free.dtype).view(shards, nl).clone()
    allowed = na["allowed_pods"].to(free.dtype).view(shards, nl)
    req, req_any = pa["req"], pa["req_any"]
    t_anti = ta["valid"] & (ta["kind"] == ANTI_REQ)
    t_owner = ta["owner"]
    have_spread = term_kinds is None or "spread_hard" in term_kinds
    got = _solve_inputs(na, pa, ea, ta, ids, inputs, have_spread, v, plain=True)
    m_raw = got["m_raw"]
    m_bb = m_raw & t_anti[:, None]
    bucket_n, haskey_n = T._bucket_of(na, ta["topo_slot"])
    tt = t_anti.shape[0]
    bucket_s = bucket_n.long().view(tt, shards, nl).transpose(0, 1)  # [S, TT, Nl] shard-local columns
    haskey_s = haskey_n.view(tt, shards, nl).transpose(0, 1)
    pconf = got["pconf"]
    t_rows = torch.arange(tt, device=dev)
    if have_spread:
        sp = _spread_tables(pa, ta, got["spread_tables"], m_raw)
        hard, owner = sp["hard"], sp["owner"]
        cand_s = sp["cand"][owner.long()].view(tt, shards, nl).transpose(0, 1)  # [S, TT, Nl]
    # replicated state (identical on every shard by construction)
    ca = torch.zeros((tt, v), dtype=torch.int32, device=dev)
    cb = torch.zeros((tt, v), dtype=torch.int32, device=dev)
    md = torch.zeros((tt, v), dtype=torch.int32, device=dev)
    mh = torch.zeros((tt,), dtype=torch.int32, device=dev)
    cs = torch.zeros((shards, u_cap, nl), dtype=torch.int32, device=dev)  # shard-local columns
    verdict = torch.full((b,), V_NOFIT, dtype=torch.int32, device=dev)
    sig_l, assign_l, pv_l = sig.tolist(), assign.tolist(), pod_valid.tolist()
    ident = torch.cat([torch.zeros(2 + tt, dtype=torch.int64, device=dev),
                       torch.full((tt,), -1, dtype=torch.int64, device=dev),
                       torch.zeros(tt, dtype=torch.int64, device=dev)])

    def scatter_add(table, mask, buck, val):
        keep = mask & (buck < v)
        table.index_put_((t_rows[keep], buck[keep]), val[keep].to(table.dtype), accumulate=True)

    for p in order.tolist():
        if not pv_l[p]:
            continue  # V_NOFIT; commits nothing
        u, nrow = sig_l[p], assign_l[p]
        if nrow < 0:
            # -1: V_DEFER only when an earlier commit matched one of my hard terms
            couldfit = have_spread and bool((hard & (owner == u) & (mh > 0)).any())
            verdict[p] = V_DEFER if couldfit else V_NOFIT
            continue
        r_q = req[u]
        # each shard's packed facts: the identity of max on every shard but
        # the node's owner, whose facts are real
        own_sh, l = divmod(nrow, nl)
        cap_ok = (~req_any[u] | (r_q <= free[own_sh, l]).all()) & (count[own_sh, l] + 1 <= allowed[own_sh, l])
        block_p = (pconf[u] & (cs[own_sh, :, l] > 0)).any()
        cand_l = cand_s[own_sh, :, l] if have_spread else torch.zeros(tt, dtype=torch.bool, device=dev)
        rows = ident.expand(shards, -1).clone()
        rows[own_sh] = torch.cat([torch.stack([cap_ok, block_p]).long(), haskey_s[own_sh, :, l].long(),
                                  bucket_s[own_sh, :, l], cand_l.long()])
        packed = rows.amax(dim=0)  # the one pmax of the step
        cap_ok = packed[0] > 0
        block_p = packed[1] > 0
        hk = packed[2 : 2 + tt] > 0
        buck = packed[2 + tt : 2 + 2 * tt]
        cand_b = packed[2 + 2 * tt :] > 0
        bc = buck.clamp(min=0, max=v - 1)  # gathers clamp
        own_u = (t_owner == u) & t_anti
        block_a = (own_u & hk & (ca[t_rows, bc] > 0)).any()
        block_b = (m_bb[:, u] & hk & (cb[t_rows, bc] > 0)).any()
        if have_spread:
            own_h = hard & (owner == u)
            cnt = sp["merged_cnt0"] + md
            present = sp["merged_present"]
            min_t = torch.where(present, cnt, _BIG).amin(dim=1)
            at_b = torch.where(present[t_rows, bc], cnt[t_rows, bc], 0)
            skew_ok_t = hk & (at_b + sp["self_m"] - min_t <= sp["skew"])
            sp_ok = torch.where(own_h, skew_ok_t, True).all() | ~sp["any_pair_u"][u]
        else:
            sp_ok = torch.ones((), dtype=torch.bool, device=dev)
        ok = bool(cap_ok & ~block_a & ~block_b & ~block_p & sp_ok)
        verdict[p] = V_PLACE if ok else V_DEFER
        if not ok:
            continue
        free[own_sh, l] -= r_q  # the owner folds the commit into its residuals and cs
        count[own_sh, l] += 1
        cs[own_sh, u, l] += 1
        ones = torch.ones(tt, dtype=torch.int32, device=dev)  # every shard: the replicated tables
        scatter_add(ca, m_bb[:, u] & hk, buck, ones)
        scatter_add(cb, own_u & hk, buck, ones)
        if have_spread:
            contrib = torch.where(hard & cand_b, sp["gm"][:, u], 0)
            scatter_add(md, contrib > 0, buck, contrib)
            mh += sp["m_batch_hard"][:, u].to(mh.dtype)
    return verdict


def arbitrate_sharded(
    shards: int, na: Arrays, pa: Arrays, ea: Arrays, ta: Arrays, ids, assign: torch.Tensor, pb: Arrays,
    carry: Optional[Tuple] = None, term_kinds: Optional[frozenset] = None, n_buckets: Optional[int] = None,
    inputs: Optional[Dict] = None,
) -> torch.Tensor:
    """`arbitrate` over `shards` node shards: the same verdicts. CPU
    tensors run the plain version; CUDA tensors launch csrc/arbiter.cu's
    scan as one cluster of `shards` CTAs (counted in
    `arbitrate_sharded.launches`). A shard count the card cannot run as one
    cluster raises."""
    dev = assign.device
    if dev.type == "cpu":
        return arbitrate_sharded_plain(shards, na, pa, ea, ta, ids, assign, pb, carry, term_kinds, n_buckets, inputs)
    if dev.type == "cuda":
        args, verdict = arbiter_args(na, pa, ea, ta, ids, assign, pb, carry, term_kinds, n_buckets, inputs,
                                     shards=shards)
        _launch_arbiter(args, dev)
        arbitrate_sharded.launches += 1
        return verdict
    raise ValueError(f"no arbiter kernel for device {dev}")


arbitrate_sharded.launches = 0


def make_sharded_arbiter(mesh):
    """The verdict scan bound to `mesh`'s node shards, with `arbitrate`'s
    signature (ref :484)."""
    return partial(arbitrate_sharded, node_shards(mesh))


def host_arbitrate(pods, assign_rows, node_name_of_row, snapshot: Snapshot,
                   order: Optional[List[int]] = None) -> List[int]:
    """The sequential host walk `arbitrate` reproduces: pods in pop order
    (priority desc, batch position asc), each placed pick re-validated by
    the full oracle predicate chain against a scratch snapshot that assumes
    every earlier V_PLACE pod; a failure defers, and a -1 defers only when
    an earlier commit matched one of the pod's DoNotSchedule constraints
    (the could-fit rule). Returns the verdicts by batch position. The
    obviously-correct formulation: it re-derives the predicate metadata per
    pod against the scratch state."""
    if order is None:
        order = sorted(range(len(pods)), key=lambda i: (-pods[i].get_priority(), i))
    snap = Snapshot(
        [ni.node for ni in snapshot.node_infos.values()],
        [p for ni in snapshot.node_infos.values() for p in ni.pods],
    )
    verdicts = [V_NOFIT] * len(pods)
    commits: List = []
    for i in order:
        pod = pods[i]
        row = int(assign_rows[i])
        if row < 0:
            couldfit = any(
                c.namespace == pod.namespace and match_label_selector(con.label_selector, c.labels)
                for con in get_hard_spread_constraints(pod)
                for c in commits
            )
            verdicts[i] = V_DEFER if couldfit else V_NOFIT
            continue
        node_name = node_name_of_row(row)
        ni = snap.get(node_name) if node_name is not None else None
        if ni is None:
            verdicts[i] = V_DEFER
            continue
        meta = compute_predicate_metadata(pod, snap)
        if pod_fits_on_node(pod, ni, meta=meta)[0]:
            verdicts[i] = V_PLACE
            bound = pod.with_node(node_name)
            ni.add_pod(bound)
            commits.append(bound)
        else:
            verdicts[i] = V_DEFER
    return verdicts
