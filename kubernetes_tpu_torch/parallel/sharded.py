"""The solve over node shards: the scheduling cycle on a node mesh.

Port of `kubernetes_tpu/parallel/sharded.py`. The reference splits the
cycle in two:

1. **Mask/score.** The Filter/Score/topology programs are column-parallel
   over nodes; the reference pins their node axis to the mesh under
   `with_sharding_constraint` and lets XLA place the few collectives. On
   one card the [U, N] matrices are one tensor each, so there is nothing
   to place: the stage is the port's `mask_and_score` over the full node
   axis (`ops/pipeline.solve_inputs`), the same kernels as the
   single-device path.
2. **Greedy commit over shards.** The chunked prefix-acceptance solve
   (`ops/solver.solve_greedy`'s algorithm) keeps each shard's residuals
   local and elects every chunk pod's (shard, node) with a few [K]-wide
   max / min reductions across shards; acceptance prefix sums stay local,
   since a node lives on exactly one shard. It is bit-identical to the
   single-device solve, the selectHost tie-break included: the noise is the
   global-column `tie_noise` stream, sliced per shard.

`solve_sharded_plain` writes that shard axis out — pmax / pmin become
amax / amin over it — with the in-batch tracking (`inb`): the ca / cb
commit tables replicated, cs and the bucket / has-key columns shard-local,
each candidate's bucket broadcast from its owner shard. It keeps the port's
one deliberate difference with the reference (a bucket >= V reads as "no
earlier contributor", ops/solver._inb_block), so it equals the
single-device solve everywhere. On CUDA tensors `solve_sharded` launches
csrc/solver.cu — the single-device solve's kernel — as a thread-block
cluster of one CTA a shard (counted in `solve_sharded.launches`, tracked
ones also in `.tracked_launches`). `solve_gang_sharded` is the
reference's `pipeline_gang` solve: two passes around the group-fail drop,
one launch of the kernel's gang mode on the card
(`solve_gang_sharded.launches`).

`make_sharded_pipeline(mesh)` returns the pipeline bound to a mesh,
memoized per mesh: `pipeline(...)` with `ops/pipeline.solve_pipeline`'s
signature, `pipeline.gang` with `solve_pipeline_gang`'s, and
`pipeline.arbitrate` (commit/arbiter.make_sharded_arbiter). The "pods" axis
of a 2D mesh splits only the mask and score compute, which on one card is
the same compute: the result is the 1D mesh's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.pipeline import SolveConfig, solve_inputs
from ..ops.solver import (
    DEFAULT_CHUNK,
    _defaults,
    _gather_counts,
    _inb_block,
    _inb_record,
    _inb_state,
    check_group_ids,
    gang_dropped,
    launch_solve,
    prng_split,
    solve_args,
    tie_noise_bits,
)
from .mesh import AXIS_NODES, Mesh, shard_rows

Arrays = Dict[str, torch.Tensor]

_BIG = 2**30

def solve_sharded_plain(
    mask, score, req, free0, count0, allowed, order, key, shards: int, deterministic=False,
    req_any=None, sig=None, pod_valid=None, chunk: int = DEFAULT_CHUNK, return_carry=False,
    nz0=None, scoring_req=None, inb=None,
):
    """The reference's shard_map'd chunked solve (sharded.py:_solver_body)
    with the shard axis written out. Shard s owns node rows [s * Nl,
    (s + 1) * Nl). Returns the node row per batch position (-1 = no fit),
    plus the (free, count, nz) carry when asked."""
    U, N = mask.shape
    S = shards
    nl = shard_rows(N, S)
    dev = mask.device
    req_any, sig, pod_valid, nz0, scoring_req = _defaults(
        mask, req, order, req_any, sig, pod_valid, nz0, scoring_req, free0
    )
    R = req.shape[1]
    B = order.shape[0]
    K = min(chunk, B)
    if B % K:
        K = B
    neg = torch.iinfo(score.dtype).min
    jrange = torch.arange(K, device=dev)
    base = torch.arange(S, device=dev)[:, None] * nl  # [S, 1] first global row of each shard
    # shard-local views: [S, U, Nl] columns, [S, Nl, ...] residuals
    mask_s = mask.view(U, S, nl).transpose(0, 1)
    score_s = score.view(U, S, nl).transpose(0, 1)
    free = free0.clone().view(S, nl, R)
    count = count0.clone().view(S, nl)
    allowed_s = allowed.view(S, nl)
    nzacc = nz0.clone().view(S, nl, 2)
    # the global-column tie-break stream, each shard its own columns
    noise = None if deterministic else tie_noise_bits(key, B, N, dev).view(B, S, nl)
    st = _inb_state(inb, U, N, dev) if inb is not None else None
    if st is not None:
        tt = st["TT"]
        bucket_s = st["bucket_n"].view(tt, S, nl).transpose(0, 1)  # [S, TT, Nl] shard-local columns
        haskey_s = st["haskey_n"].view(tt, S, nl).transpose(0, 1)
        cs_s = torch.zeros((S, U, nl), dtype=torch.int32, device=dev)  # shard-local
    choices = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, B, K):
        idx = order[c0 : c0 + K].long()
        sg = sig[idx].long()
        pv = pod_valid[idx]
        m_r = mask_s[:, sg] & pv[None, :, None]  # [S, K, Nl]
        s_r = score_s[:, sg]
        r_q = req[sg]  # [K, R] replicated
        r_any = req_any[sg]
        s_q = scoring_req[sg]
        nz_rows = noise[c0 : c0 + K].transpose(0, 1) if noise is not None else None  # [S, K, Nl]
        if st is not None:
            own_t = (st["t_owner"][:, None] == sg[None, :]) & st["t_anti"][:, None]  # [TT, K]
            own_k = own_t.T.to(torch.float64)
            mbb_k = st["m_bb"][:, sg].T.to(torch.float64)
            pconf_k = st["pconf"][sg].to(torch.float64)  # [K, U]
        decided = ~pv
        choice = torch.full((K,), -1, dtype=torch.int32, device=dev)
        while not bool(decided.all()):
            res_ok = (~r_any[None, :, None]) | (r_q[None, :, None, :] <= free[:, None, :, :]).all(dim=-1)
            feas = m_r & res_ok & (count[:, None, :] + 1 <= allowed_s[:, None, :])  # [S, K, Nl]
            if st is not None:
                # the replicated tables read at each shard's own columns
                ca_pos = (_gather_counts(st["ca"], st["bucket_n"]) & st["haskey_n"]).view(tt, S, nl)
                cb_pos = (_gather_counts(st["cb"], st["bucket_n"]) & st["haskey_n"]).view(tt, S, nl)
                block_a = (own_k @ ca_pos.transpose(0, 1).to(torch.float64)) > 0.5
                block_b = (mbb_k @ cb_pos.transpose(0, 1).to(torch.float64)) > 0.5
                block_p = (pconf_k @ (cs_s > 0).to(torch.float64)) > 0.5
                feas = feas & ~(block_a | block_b | block_p)
            feas = feas & ~decided[None, :, None]
            anyf = feas.any(dim=2).amax(dim=0)  # pmax [K]
            masked = torch.where(feas, s_r, torch.full_like(s_r, neg))
            local_best = masked.amax(dim=2)  # [S, K]
            global_best = local_best.amax(dim=0)  # pmax
            if deterministic:
                # the first global max is the smallest global index among the shards' maxima
                gidx = torch.where(local_best == global_best[None], base + masked.argmax(dim=2), _BIG)
            else:
                # selectHost: uniform among the max-score nodes, the max noise wins
                ties = feas & (masked == global_best[None, :, None])
                nzm = torch.where(ties, nz_rows, torch.full_like(nz_rows, -1))
                local_nbest = nzm.amax(dim=2)
                global_nbest = local_nbest.amax(dim=0)  # pmax
                gidx = torch.where((local_nbest == global_nbest[None]) & ties.any(dim=2), base + nzm.argmax(dim=2),
                                   _BIG)
            cand = torch.where(anyf, gidx.amin(dim=0), -1).to(torch.int32)  # pmin [K] global rows
            newly_none = ~decided & ~anyf
            active = ~decided & (cand >= 0)
            local = active[None] & (cand[None] >= base) & (cand[None] < base + nl)  # [S, K]
            lidx = torch.where(local, cand[None] - base, 0).long()
            # per-node in-order prefix among the pods choosing each shard's nodes
            same = (local[:, :, None] & local[:, None, :] & (cand[:, None] == cand[None, :])[None]
                    & (jrange[None, :] < jrange[:, None])[None])  # [S, K, K]
            prefix_req = (same[..., None].long() * r_q[None, None, :, :]).sum(dim=2)  # [S, K, R]
            prefix_cnt = same.long().sum(dim=2)
            free_at = torch.gather(free, 1, lidx[..., None].expand(S, K, R))
            fits = (((~r_any)[None] | (r_q[None] <= free_at - prefix_req).all(dim=-1))
                    & (count.gather(1, lidx) + prefix_cnt + 1 <= allowed_s.gather(1, lidx)))
            rejected = local & ~fits
            first_rej = torch.where(rejected, jrange[None], K).amin()  # pmin of the shards' minima
            commit = active & (jrange < first_rej)
            if st is not None:
                # the pairwise commit barrier on each candidate's bucket and
                # has-key bit, broadcast from its node's owner shard
                mine_ok = local & commit[None]
                at = torch.where(mine_ok, lidx, 0)[:, None, :].expand(S, tt, K)
                bK = torch.where(mine_ok[:, None, :], bucket_s.gather(2, at), -1).amax(dim=0)  # [TT, K]
                hkK = (haskey_s.gather(2, at) & mine_ok[:, None, :]).any(dim=0)
                blocked = _inb_block(st, sg, own_t, commit, cand, jrange, K, bK, hkK)
                first_block = torch.where(blocked, jrange, K).min()
                commit = commit & (jrange < first_block)
            mine = commit[None] & local  # [S, K] each shard commits its own nodes
            for s in range(S):
                rows = lidx[s][mine[s]]
                free[s].index_add_(0, rows, -r_q[mine[s]])
                count[s].index_add_(0, rows, torch.ones_like(rows, dtype=count.dtype))
                nzacc[s].index_add_(0, rows, s_q[mine[s]])
            if st is not None:
                at = torch.where(mine, lidx, 0)[:, None, :].expand(S, tt, K)
                bc_g = torch.where(mine[:, None, :], bucket_s.gather(2, at), -1).amax(dim=0)  # owner's bucket
                hk_g = (haskey_s.gather(2, at) & mine[:, None, :]).any(dim=0)
                _inb_record(st, sg, own_t, commit, cand, bc_g, hk_g)
                for s in range(S):
                    cs_s[s].index_put_((sg[mine[s]], lidx[s][mine[s]]),
                                       torch.ones(int(mine[s].sum()), dtype=torch.int32, device=dev),
                                       accumulate=True)
            choice = torch.where(commit, cand, choice)
            decided = decided | commit | newly_none
        choices[c0 : c0 + K] = choice
    out = torch.full((B,), -1, dtype=torch.int32, device=dev)
    out[order.long()] = choices
    if return_carry:
        return out, (free.view(N, R), count.view(N), nzacc.view(N, 2))
    return out


def solve_sharded(
    mask: torch.Tensor,  # [U, N] feasibility (spec rows)
    score: torch.Tensor,  # [U, N] int64
    req: torch.Tensor,  # [U, R]
    free0: torch.Tensor,  # [N, R]
    count0: torch.Tensor,  # [N]
    allowed: torch.Tensor,  # [N]
    order: torch.Tensor,  # [B] scan order (pop_order)
    key: Sequence[int],  # two uint32 key words for tie-breaks
    shards: int,  # node shards S (N = S * Nl)
    deterministic: bool = False,
    req_any: Optional[torch.Tensor] = None,
    sig: Optional[torch.Tensor] = None,
    pod_valid: Optional[torch.Tensor] = None,
    return_carry: bool = False,
    nz0: Optional[torch.Tensor] = None,
    scoring_req: Optional[torch.Tensor] = None,
    inb: Optional[dict] = None,
):
    """`ops/solver.solve_greedy` over `shards` node shards: the same
    arguments and results (the same choices and residuals). CPU tensors
    run the plain version; CUDA tensors launch csrc/solver.cu as one
    cluster of `shards` CTAs (counted in `solve_sharded.launches`; with
    `inb` also in `.tracked_launches`). A shard count the card cannot run
    as one cluster raises."""
    dev = mask.device
    if dev.type == "cpu":
        return solve_sharded_plain(
            mask, score, req, free0, count0, allowed, order, key, shards, deterministic,
            req_any, sig, pod_valid, DEFAULT_CHUNK, return_carry, nz0, scoring_req, inb,
        )
    if dev.type == "cuda":
        shard_rows(mask.shape[1], shards)
        args, out, carry, _ = solve_args(mask, score, req, free0, count0, allowed, order, key, deterministic,
                                         req_any, sig, pod_valid, nz0, scoring_req, shards=shards, inb=inb)
        launch_solve(args, dev, solve_sharded)
        solve_sharded.launches += 1
        if inb is not None:
            solve_sharded.tracked_launches += 1
        return (out, carry) if return_carry else out
    raise ValueError(f"no solve kernel for device {dev}")


solve_sharded.launches = 0
solve_sharded.tracked_launches = 0
solve_sharded.global_state_launches = 0


def solve_gang_sharded_plain(
    mask, score, req, free0, count0, allowed, order, group, key, shards: int, deterministic=False,
    req_any=None, sig=None, pod_valid=None, return_carry=False, nz0=None, scoring_req=None,
):
    """The reference's pipeline_gang solve (sharded.py:435): the sharded
    solve with the first split key; groups with a member left unplaced are
    dropped; the sharded solve again from the same residuals with the
    second key over the rest. Returns (assign, gang_ok[, pass 2's carry])."""
    k1, k2 = prng_split(key)
    first = solve_sharded_plain(mask, score, req, free0, count0, allowed, order, k1, shards, deterministic,
                                req_any, sig, pod_valid)
    dropped = gang_dropped(group, first)
    alive = ~dropped if pod_valid is None else pod_valid & ~dropped
    result = solve_sharded_plain(mask, score, req, free0, count0, allowed, order, k2, shards, deterministic,
                                 req_any, sig, alive, DEFAULT_CHUNK, return_carry, nz0, scoring_req)
    second, carry = result if return_carry else (result, None)
    assign = torch.where(dropped, torch.full_like(second, -1), second)
    if return_carry:
        return assign, ~dropped, carry
    return assign, ~dropped


def solve_gang_sharded(
    mask, score, req, free0, count0, allowed, order, group, key, shards: int, deterministic=False,
    req_any=None, sig=None, pod_valid=None, return_carry=False, nz0=None, scoring_req=None,
):
    """`ops/solver.solve_gang` over `shards` node shards. CPU tensors run
    the plain version; CUDA tensors launch csrc/solver.cu's gang mode as
    one cluster of `shards` CTAs, both passes in one launch (counted in
    `solve_gang_sharded.launches`)."""
    check_group_ids(group, order.shape[0])
    dev = mask.device
    if dev.type == "cpu":
        return solve_gang_sharded_plain(
            mask, score, req, free0, count0, allowed, order, group, key, shards, deterministic,
            req_any, sig, pod_valid, return_carry, nz0, scoring_req,
        )
    if dev.type == "cuda":
        shard_rows(mask.shape[1], shards)
        args, out, carry, gang_ok = solve_args(mask, score, req, free0, count0, allowed, order, key, deterministic,
                                               req_any, sig, pod_valid, nz0, scoring_req, shards=shards, group=group)
        launch_solve(args, dev, solve_gang_sharded)
        solve_gang_sharded.launches += 1
        return (out, gang_ok, carry) if return_carry else (out, gang_ok)
    raise ValueError(f"no solve kernel for device {dev}")


solve_gang_sharded.launches = 0
solve_gang_sharded.global_state_launches = 0

_PIPELINE_CACHE: Dict[Mesh, object] = {}


def make_sharded_pipeline(mesh: Mesh):
    """The pipeline bound to `mesh`, memoized per mesh: `pipeline(...)`
    with ops/pipeline.solve_pipeline's signature and results,
    `pipeline.gang` with solve_pipeline_gang's, `pipeline.arbitrate` with
    commit/arbiter.arbitrate's. The carry's residuals stay node-sharded
    between batches: shard s's rows of the same [N, ...] tensors."""
    cached = _PIPELINE_CACHE.get(mesh)
    if cached is not None:
        return cached
    shards = mesh.shape[AXIS_NODES]

    def pipeline(
        na: Arrays, pa: Arrays, ids, key: Sequence[int], pb: Optional[Arrays] = None,
        carry: Optional[Tuple] = None, deterministic: bool = False, config: Optional[SolveConfig] = None,
        term_kinds: Optional[frozenset] = frozenset(), return_carry: bool = False, track_inbatch: bool = False,
        *, ea: Optional[Arrays] = None, ta: Optional[Arrays] = None, au: Optional[Arrays] = None,
        xa: Optional[Arrays] = None, n_buckets: Optional[int] = None, arbiter_inputs: Optional[Dict] = None,
    ):
        shard_rows(na["valid"].shape[0], shards)
        kw, score, inb = solve_inputs(na, pa, ids, pb, carry, config, term_kinds, return_carry, track_inbatch,
                                      ea=ea, ta=ta, au=au, xa=xa, n_buckets=n_buckets,
                                      arbiter_inputs=arbiter_inputs)
        result = solve_sharded(**kw, key=key, shards=shards, deterministic=deterministic,
                               return_carry=return_carry, inb=inb)
        if return_carry:
            assign, carry_out = result
            return assign, score, carry_out
        return result, score

    def pipeline_gang(
        na: Arrays, pa: Arrays, ids, key: Sequence[int], group: torch.Tensor, pb: Optional[Arrays] = None,
        carry: Optional[Tuple] = None, deterministic: bool = False, config: Optional[SolveConfig] = None,
        term_kinds: Optional[frozenset] = frozenset(), return_carry: bool = False,
        *, ea: Optional[Arrays] = None, ta: Optional[Arrays] = None, au: Optional[Arrays] = None,
        xa: Optional[Arrays] = None, n_buckets: Optional[int] = None,
    ):
        """All-or-nothing two-pass gang solve on the mesh (the reference's
        pipeline_gang): pass 1 places everything, groups with an unplaced
        member are dropped, pass 2 re-solves without them; the split keys
        come from ops/solver.prng_split."""
        shard_rows(na["valid"].shape[0], shards)
        kw, score, _ = solve_inputs(na, pa, ids, pb, carry, config, term_kinds, return_carry, False, ea=ea, ta=ta,
                                    au=au, xa=xa, n_buckets=n_buckets, arbiter_inputs=None)
        result = solve_gang_sharded(**kw, group=group, key=key, shards=shards, deterministic=deterministic,
                                    return_carry=return_carry)
        if return_carry:
            assign, gang_ok, carry_out = result
            return assign, score, gang_ok, carry_out
        assign, gang_ok = result
        return assign, score, gang_ok

    from ..commit.arbiter import make_sharded_arbiter

    pipeline.gang = pipeline_gang
    pipeline.arbitrate = make_sharded_arbiter(mesh)
    _PIPELINE_CACHE[mesh] = pipeline
    return pipeline
