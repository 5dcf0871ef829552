"""Batch assignment solver: greedy by queue priority, one batch at a time.

Port of `kubernetes_tpu/ops/solver.py`. A whole batch of pending pods is
assigned bit-identically to scheduling them one at a time in the order the
reference queue pops them (priority desc, then enqueue sequence asc): each
pod takes the max-(score, tie-noise) node that is feasible against the
residuals every earlier pod left — and, with `inb`, against the required
anti-affinity and host-port conflicts of the pods committed before it in
the same batch (predicates.go:1284 satisfiesExistingPodsAntiAffinity
applied within the batch).

* `solve_greedy_plain` is the reference's arithmetic as written: chunks of
  K pods choose nodes in one vectorized [K, N] pass, per-node in-order
  prefix sums accept every pod up to the first misfit, and the rest retry
  against the updated residuals; with `inb`, a pairwise commit barrier
  stops a round at the first pod whose anti/port mask an earlier
  candidate commit of the round could change.
* On CUDA tensors `solve_greedy` launches `csrc/solver.cu`, the sequential
  walk that the chunked scan provably equals (solver.py:110-126, :144-149),
  as a thread-block cluster of SOLO_SHARDS CTAs, each holding its node
  rows' residuals in shared memory (`solve_layout`; parallel/sharded.py
  launches the same kernel with one CTA a node shard).
* `solve_gang` is the reference's all-or-nothing gang solve: two greedy
  passes, with the two halves of `jax.random.split(key)` (`prng_split`),
  around a group-fail segment max; on CUDA tensors one launch of
  `csrc/solver.cu`'s gang mode walks both passes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..kernels import build
from .topology import _bucket_of

# chunk width of the prefix-acceptance loop (the reference's DEFAULT_CHUNK)
DEFAULT_CHUNK = 128

_MASK32 = 0xFFFFFFFF


def prng_key_data(seed: int) -> tuple:
    """The two uint32 key words of the reference's jax.random.PRNGKey(seed)
    (threefry: [seed >> 32, seed & 0xFFFFFFFF])."""
    seed = int(seed)
    return ((seed >> 32) & _MASK32, seed & _MASK32)


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple:
    """Threefry-2x32 with 20 rounds (Salmon et al., the block cipher of
    jax.random's default generator) on one counter pair."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & _MASK32, (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def prng_split(key: Sequence[int]) -> tuple:
    """The two key-word pairs of the reference's jax.random.split(key) under
    the partitionable threefry layout (jax_threefry_partitionable=True):
    key i is threefry2x32(key, (0, i)), the two words of one counter's
    output."""
    k0, k1 = int(key[0]) & _MASK32, int(key[-1]) & _MASK32
    return _threefry2x32(k0, k1, 0, 0), _threefry2x32(k0, k1, 0, 1)


def noise_seed(key: Sequence[int]) -> int:
    """Both key words enter before the avalanche (solver.tie_noise)."""
    return (_mul32(int(key[0]), 0x27220A95) ^ _mul32(int(key[-1]), 0x01000193)) & _MASK32


def _mul32(x, c: int):
    """x * c mod 2^32 for 0 <= x < 2^32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def tie_noise_bits(key: Sequence[int], b: int, n: int, device="cpu") -> torch.Tensor:
    """The top 24 bits of the reference's tie_noise hash for (pod rank
    [b], node [n]) as int64 — murmur3 fmix32 over (rank, node, key),
    computed in int64 with & 0xFFFFFFFF (CPU torch cannot shift uint32).
    They order exactly as the reference's float32 noise values."""
    seed = noise_seed(key)
    i = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    x = (_mul32(i, 0x9E3779B1) + _mul32(j, 0x85EBCA77) + seed) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >> 8


def tie_noise(key: Sequence[int], b: int, n: int, device="cpu") -> torch.Tensor:
    """selectHost tie-break noise [b, n] in [0, 1), float32, bit-identical
    to the reference's tie_noise for the same key words."""
    return tie_noise_bits(key, b, n, device).to(torch.float32) * (1.0 / (1 << 24))


def pop_order(priority: torch.Tensor, enqueue_seq: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Queue pop order: priority desc, then enqueue sequence asc; invalid
    rows last. A chain of stable sorts, least significant key first
    (torch has no lexsort). Returns the permutation [B] (int64)."""
    idx = torch.sort(enqueue_seq.long(), stable=True).indices
    idx = idx[torch.sort(-priority.long()[idx], stable=True).indices]
    idx = idx[torch.sort((~valid[idx]).to(torch.int8), stable=True).indices]
    return idx


def _defaults(mask, req, order, req_any, sig, pod_valid, nz0, scoring_req, free0):
    u, n = mask.shape
    b = order.shape[0]
    dev = mask.device
    if req_any is None:
        req_any = (req > 0).any(dim=-1)
    if sig is None:
        sig = torch.arange(b, dtype=torch.int32, device=dev)
    if pod_valid is None:
        pod_valid = torch.ones(b, dtype=torch.bool, device=dev)
    if nz0 is None:
        nz0 = torch.zeros((n, 2), dtype=free0.dtype, device=dev)
    if scoring_req is None:
        scoring_req = torch.zeros((u, 2), dtype=free0.dtype, device=dev)
    return req_any, sig, pod_valid, nz0, scoring_req


def _inb_state(inb, U: int, N: int, dev):
    """The plain version's view of an `inb` dict: the anti-term mask,
    owners, matches (masked to anti terms), per-node buckets / has-key,
    the port-conflict table and zeroed commit tables."""
    t_anti = inb["anti"]
    bucket_n, haskey_n = _bucket_of({"label_dense": inb["label_dense"]}, inb["topo_slot"])
    v = int(inb["n_buckets"])
    tt = t_anti.shape[0]
    return dict(
        t_anti=t_anti, t_owner=inb["owner"], m_bb=inb["m_bb"] & t_anti[:, None],
        bucket_n=bucket_n.long(), haskey_n=haskey_n, pconf=inb["port_conflict"], V=v, TT=tt, U=U, N=N,
        ca=torch.zeros((tt, v), dtype=torch.int32, device=dev),
        cb=torch.zeros((tt, v), dtype=torch.int32, device=dev),
        cs=torch.zeros((U, N), dtype=torch.int32, device=dev),
    )


def _gather_counts(table: torch.Tensor, bucket_n: torch.Tensor) -> torch.Tensor:
    """table [TT, V] read at bucket_n [TT, N]: > 0, a bucket >= V reading
    as empty (the reference's fill-mode take_along_axis)."""
    v = table.shape[1]
    got = torch.gather(table, 1, bucket_n.clamp(max=v - 1))
    return (got > 0) & (bucket_n < v)


def _scatter_min_rows(rows: int, width: int, idx: torch.Tensor, vals: torch.Tensor, fill: int) -> torch.Tensor:
    """[rows, width] table of the min of `vals` [rows, K] at column `idx`
    per row; a column >= width is dropped (mode="drop")."""
    out = torch.full((rows, width + 1), fill, dtype=torch.int64, device=vals.device)
    out.scatter_reduce_(1, idx.clamp(max=width), vals, reduce="amin")
    return out[:, :width]


def _inb_block(st, sg, own_t, cand_ok, cand, jrange, K, bK=None, hkK=None):
    """The reference's pairwise commit barrier: [K] bool, pod j must not
    commit this round because an earlier candidate commit i of the round
    contributes to a ca/cb row j reads at the same topology bucket, or
    port-conflicts j's spec on j's chosen node. A bucket >= V reads as no
    contributor (the reference's int32 fill value would block the round's
    first pod forever: the driver sizes V so that no bucket reaches it).
    `bK` / `hkK` [TT, K]: each candidate's bucket and has-key bit where the
    caller already has them (the sharded solve broadcasts them from the
    owner shard), else read here."""
    tt, v = st["TT"], st["V"]
    cidx3 = torch.where(cand_ok, cand, 0).long()
    if bK is None:
        bK = st["bucket_n"][:, cidx3]  # [TT, K] bucket of each choice
        hkK = st["haskey_n"][:, cidx3] & cand_ok[None, :]
    own_kt = own_t & hkK  # j reads ca[t, bK]
    contrib = st["m_bb"][:, sg] & hkK  # i bumps ca[t, bK]
    idxK = jrange[None, :].expand(tt, K)
    mi_contrib = _scatter_min_rows(tt, v, torch.where(contrib, bK, v), idxK, K)
    mi_own = _scatter_min_rows(tt, v, torch.where(own_kt, bK, v), idxK, K)
    at = torch.where(hkK, bK, 0)
    g_contrib = torch.where(at < v, torch.gather(mi_contrib, 1, at.clamp(max=v - 1)), K)
    g_own = torch.where(at < v, torch.gather(mi_own, 1, at.clamp(max=v - 1)), K)
    block_a = (own_kt & (g_contrib < jrange[None, :])).any(dim=0)
    block_b = (contrib & (g_own < jrange[None, :])).any(dim=0)
    # ports: the earliest candidate per (spec, node); j is blocked when a
    # port-conflicting spec has an earlier candidate on j's chosen node
    u, n = st["U"], st["N"]
    flat = torch.where(cand_ok, sg * n + cidx3, u * n)
    mi_sn = torch.full((u * n + 1,), K, dtype=torch.int64, device=sg.device)
    mi_sn.scatter_reduce_(0, flat, torch.where(cand_ok, jrange, K), reduce="amin")
    g_sn = mi_sn[: u * n].view(u, n)[:, cidx3]  # [U, K]
    block_p = (st["pconf"][sg].T & (g_sn < jrange[None, :])).any(dim=0)
    return cand_ok & (block_a | block_b | block_p)


def _inb_record(st, sg, own_t, commit, cand, bcand=None, hk=None):
    """Count this round's commits into the in-batch tables: ca per term a
    committed pod matches, cb per term it owns (per topology bucket of its
    node), cs per (spec, node); a bucket >= V is dropped. With `bcand` /
    `hk` [TT, K] (the commits' buckets and has-key bits, broadcast by the
    sharded solve) only ca and cb are counted: cs is shard-local there."""
    tt, v = st["TT"], st["V"]
    cidx2 = torch.where(commit, cand, 0).long()
    count_cs = bcand is None
    if count_cs:
        bcand = st["bucket_n"][:, cidx2]  # [TT, K]
        hk = st["haskey_n"][:, cidx2] & commit[None, :]
    hk = hk & (bcand < v)
    rows = torch.arange(tt, device=sg.device)[:, None] * (v + 1)
    for table, sel in ((st["ca"], st["m_bb"][:, sg] & hk), (st["cb"], own_t & hk)):
        flat = (rows + torch.where(sel, bcand, v)).flatten()
        acc = torch.zeros(tt * (v + 1), dtype=torch.int32, device=sg.device)
        acc.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        table += acc.view(tt, v + 1)[:, :v]
    if not count_cs:
        return
    u, n = st["cs"].shape
    flat = torch.where(commit, sg * n + cidx2, u * n)
    acc = torch.zeros(u * n + 1, dtype=torch.int32, device=sg.device)
    acc.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    st["cs"] += acc[: u * n].view(u, n)


def solve_greedy_plain(
    mask, score, req, free0, count0, allowed, order, key, deterministic=False,
    req_any=None, sig=None, pod_valid=None, chunk: int = DEFAULT_CHUNK,
    return_carry=False, nz0=None, scoring_req=None, inb=None,
):
    """The reference's chunked prefix-acceptance solve, in plain PyTorch
    (solver.py:solve_greedy). Returns the node row per batch position (-1 =
    no fit), plus the (free, count, nz) carry when asked. `inb` turns on the
    in-batch anti-affinity / host-port tracking (see `solve_greedy`)."""
    U, N = mask.shape
    dev = mask.device
    req_any, sig, pod_valid, nz0, scoring_req = _defaults(
        mask, req, order, req_any, sig, pod_valid, nz0, scoring_req, free0
    )
    B = order.shape[0]
    K = min(chunk, B)
    if B % K:
        K = B  # non-bucketed caller: one chunk covers everything
    noise = None if deterministic else tie_noise_bits(key, B, N, dev)
    neg = torch.iinfo(score.dtype).min
    jrange = torch.arange(K, device=dev)
    free, count, nzacc = free0.clone(), count0.clone(), nz0.clone()
    st = _inb_state(inb, U, N, dev) if inb is not None else None
    choices = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, B, K):
        idx = order[c0 : c0 + K].long()
        sg = sig[idx].long()
        pv = pod_valid[idx]
        m_r = mask[sg] & pv[:, None]
        s_r = score[sg]
        r_q = req[sg]
        r_any = req_any[sg]
        s_q = scoring_req[sg]
        nz_rows = noise[c0 : c0 + K] if noise is not None else None
        if st is not None:
            own_t = (st["t_owner"][:, None] == sg[None, :]) & st["t_anti"][:, None]  # [TT, K] terms each pod owns
            own_k = own_t.T.to(torch.float64)
            mbb_k = st["m_bb"][:, sg].T.to(torch.float64)  # [K, TT]
            pconf_k = st["pconf"][sg].to(torch.float64)  # [K, U]
        decided = ~pv
        choice = torch.full((K,), -1, dtype=torch.int32, device=dev)
        while not bool(decided.all()):
            res_ok = (~r_any[:, None]) | (r_q[:, None, :] <= free[None, :, :]).all(dim=-1)
            feas = m_r & res_ok & (count[None, :] + 1 <= allowed[None, :])
            if st is not None:
                # in-batch anti/port exclusion by the commits so far
                ca_pos = _gather_counts(st["ca"], st["bucket_n"]) & st["haskey_n"]
                cb_pos = _gather_counts(st["cb"], st["bucket_n"]) & st["haskey_n"]
                block_a = (own_k @ ca_pos.to(torch.float64)) > 0.5
                block_b = (mbb_k @ cb_pos.to(torch.float64)) > 0.5
                block_p = (pconf_k @ (st["cs"] > 0).to(torch.float64)) > 0.5
                feas = feas & ~(block_a | block_b | block_p)
            feas = feas & ~decided[:, None]
            anyf = feas.any(dim=1)
            masked = torch.where(feas, s_r, torch.full_like(s_r, neg))
            if deterministic:
                cand = masked.argmax(dim=1)
            else:
                # selectHost: uniform among max-score nodes — max noise wins
                best = masked.max(dim=1, keepdim=True).values
                ties = feas & (masked == best)
                cand = torch.where(ties, nz_rows, torch.full_like(nz_rows, -1)).argmax(dim=1)
            cand = torch.where(anyf, cand.to(torch.int32), torch.full_like(choice, -1))
            newly_none = ~decided & ~anyf
            active = ~decided & (cand >= 0)
            # what earlier active chunk pods consume on this pod's node
            same = (
                active[:, None] & active[None, :]
                & (cand[:, None] == cand[None, :])
                & (jrange[None, :] < jrange[:, None])
            )
            prefix_req = (same[:, :, None].long() * r_q[None, :, :]).sum(dim=1)
            prefix_cnt = same.long().sum(dim=1)
            cidx = torch.where(cand >= 0, cand, torch.zeros_like(cand)).long()
            fits = (
                (~r_any) | (r_q <= free[cidx] - prefix_req).all(dim=-1)
            ) & (count[cidx] + prefix_cnt + 1 <= allowed[cidx])
            rejected = active & ~fits
            first_rej = torch.where(rejected, jrange, torch.full_like(jrange, K)).min()
            commit = active & (jrange < first_rej)
            if st is not None:
                blocked = _inb_block(st, sg, own_t, commit, cand, jrange, K)
                first_block = torch.where(blocked, jrange, torch.full_like(jrange, K)).min()
                commit = commit & (jrange < first_block)
            rows = cidx[commit]
            free.index_add_(0, rows, -r_q[commit])
            count.index_add_(0, rows, torch.ones_like(rows, dtype=count.dtype))
            nzacc.index_add_(0, rows, s_q[commit])
            if st is not None:
                _inb_record(st, sg, own_t, commit, cand)
            choice = torch.where(commit, cand, choice)
            decided = decided | commit | newly_none
        choices[c0 : c0 + K] = choice
    out = torch.full((B,), -1, dtype=torch.int32, device=dev)
    out[order.long()] = choices
    if return_carry:
        return out, (free, count, nzacc)
    return out


class SolveArgs(ctypes.Structure):
    """Mirror of `struct SolveArgs` in csrc/solver.cu."""

    _fields_ = [
        ("mask", ctypes.c_void_p), ("score", ctypes.c_void_p), ("req", ctypes.c_void_p),
        ("req_any", ctypes.c_void_p), ("scoring_req", ctypes.c_void_p),
        ("allowed", ctypes.c_void_p), ("order", ctypes.c_void_p), ("sig", ctypes.c_void_p),
        ("pod_valid", ctypes.c_void_p), ("free", ctypes.c_void_p), ("count", ctypes.c_void_p),
        ("nz", ctypes.c_void_p), ("assign", ctypes.c_void_p),
        ("t_anti", ctypes.c_void_p), ("t_owner", ctypes.c_void_p), ("t_topo_slot", ctypes.c_void_p),
        ("m_bb", ctypes.c_void_p), ("label_dense", ctypes.c_void_p), ("pconf", ctypes.c_void_p),
        ("ca", ctypes.c_void_p), ("cb", ctypes.c_void_p), ("cs", ctypes.c_void_p),
        ("U", ctypes.c_int32), ("N", ctypes.c_int32), ("R", ctypes.c_int32), ("B", ctypes.c_int32),
        ("seed", ctypes.c_uint32), ("deterministic", ctypes.c_int32),
        ("track", ctypes.c_int32), ("TT", ctypes.c_int32), ("K", ctypes.c_int32), ("V", ctypes.c_int32),
    ]


MAX_KERNEL_RESOURCES = 32  # csrc/solver.cu stages one request row in shared memory
# with tracking, csrc/solver.cu stages each pod's anti-term and conflicting
# spec lists in shared memory: (2 * TT + U) int32
MAX_TRACK_LIST_BYTES = 200 * 1024


def _track_args(args: SolveArgs, inb, U: int, N: int, dev, replicas: int = 1) -> dict:
    """Point the solve struct at the in-batch tables; returns the tensors
    it must keep alive (the zeroed commit tables included). `replicas`:
    copies of ca / cb, one per shard of the sharded solve."""
    tt = inb["anti"].shape[0]
    n, k = inb["label_dense"].shape
    v = int(inb["n_buckets"])
    if (2 * tt + U) * 4 > MAX_TRACK_LIST_BYTES:
        raise ValueError(f"{tt} term rows and {U} spec rows exceed the solve kernel's shared lists")
    keep = dict(
        owner=inb["owner"].to(torch.int32).contiguous(),
        ca=torch.zeros((replicas * tt, v), dtype=torch.int32, device=dev),
        cb=torch.zeros((replicas * tt, v), dtype=torch.int32, device=dev),
        cs=torch.zeros((U, N), dtype=torch.int32, device=dev),
    )
    args.t_anti = build.ptr(inb["anti"], torch.bool, (tt,))
    args.t_owner = build.ptr(keep["owner"], torch.int32, (tt,))
    args.t_topo_slot = build.ptr(inb["topo_slot"], torch.int32, (tt,))
    args.m_bb = build.ptr(inb["m_bb"], torch.bool, (tt, U))
    args.label_dense = build.ptr(inb["label_dense"], torch.int32, (N, k))
    args.pconf = build.ptr(inb["port_conflict"], torch.bool, (U, U))
    args.ca = build.ptr(keep["ca"], torch.int32)
    args.cb = build.ptr(keep["cb"], torch.int32)
    args.cs = build.ptr(keep["cs"], torch.int32)
    args.track, args.TT, args.K, args.V = 1, tt, k, v
    return keep


def walk_args(mask, score, req, free0, count0, allowed, order, deterministic, req_any, sig, pod_valid, nz0,
              scoring_req) -> tuple:
    """The walk part of csrc/solver.cu's struct over these CUDA tensors:
    (SolveArgs, the [B] int32 assignment it writes, and the (free, count,
    nz) carry it updates in place: int64 copies of free0 / count0 / nz0).
    The struct holds what it points at in `.keepalive`."""
    U, N = mask.shape
    R = req.shape[1]
    if R > MAX_KERNEL_RESOURCES:
        raise ValueError(f"the solve kernel takes at most {MAX_KERNEL_RESOURCES} resource slots, got {R}")
    req_any, sig, pod_valid, nz0, scoring_req = _defaults(
        mask, req, order, req_any, sig, pod_valid, nz0, scoring_req, free0
    )
    B = order.shape[0]
    # the kernel updates the carry in place: it works on copies
    free = free0.to(torch.int64).contiguous().clone()
    count = count0.to(torch.int64).contiguous().clone()
    nz = nz0.to(torch.int64).contiguous().clone()
    allowed64 = allowed.to(torch.int64).contiguous()
    order64 = order.to(torch.int64).contiguous()
    sig32 = sig.to(torch.int32).contiguous()
    out = torch.empty((B,), dtype=torch.int32, device=mask.device)
    args = SolveArgs(
        mask=build.ptr(mask, torch.bool, (U, N)),
        score=build.ptr(score, torch.int64, (U, N)),
        req=build.ptr(req, torch.int64, (U, R)),
        req_any=build.ptr(req_any, torch.bool, (U,)),
        scoring_req=build.ptr(scoring_req, torch.int64, (U, 2)),
        allowed=build.ptr(allowed64, torch.int64, (N,)),
        order=build.ptr(order64, torch.int64, (B,)),
        sig=build.ptr(sig32, torch.int32, (B,)),
        pod_valid=build.ptr(pod_valid, torch.bool, (B,)),
        free=build.ptr(free, torch.int64, (N, R)),
        count=build.ptr(count, torch.int64, (N,)),
        nz=build.ptr(nz, torch.int64, (N, 2)),
        assign=build.ptr(out, torch.int32, (B,)),
        U=U, N=N, R=R, B=B,
        deterministic=1 if deterministic else 0,
    )
    args.keepalive = (allowed64, order64, sig32, req_any, pod_valid, scoring_req)
    return args, out, (free, count, nz)


SOLVE_ENTRY = "ktpu_solve"

# One device runs the solve as a thread-block cluster of this many CTAs
# (csrc/solver.cu: node rows split over the CTAs, each CTA's residuals in
# its shared memory); 16 beat 8 at the config-2 and config-3 shapes (PERF.md)
SOLO_SHARDS = 16
SOLVE_THREADS = 512  # csrc/solver.cu's CTA
MAX_ROWS_PER_THREAD = 4  # the resident walk's rows a thread (csrc/solver.cu)
# a CTA's dynamic shared memory for the resident residuals (the card's 227
# KB a block less the kernel's static slots, with room to spare)
SOLVE_SMEM_BUDGET = 220 * 1024


class ClusterSolveArgs(ctypes.Structure):
    """Mirror of `struct ClusterSolveArgs` in csrc/solver.cu."""

    _fields_ = [
        ("walk", SolveArgs), ("S", ctypes.c_int32), ("Nl", ctypes.c_int32), ("gang", ctypes.c_int32),
        ("group", ctypes.c_void_p), ("first", ctypes.c_void_p), ("fail", ctypes.c_void_p),
        ("alive", ctypes.c_void_p), ("gang_ok", ctypes.c_void_p), ("free1", ctypes.c_void_p),
        ("count1", ctypes.c_void_p), ("nz1", ctypes.c_void_p), ("seed1", ctypes.c_uint32),
        ("seed2", ctypes.c_uint32), ("resident", ctypes.c_int32), ("track_shared", ctypes.c_int32),
        ("steps", ctypes.c_void_p), ("sel", ctypes.c_void_p),
    ]


def solve_layout(n: int, r: int, b: int, shards: int, tt: int = 0, u: int = 0, v: int = 0,
                 track: bool = False) -> dict:
    """Where csrc/solver.cu keeps its state for this shape: `rows` (Nl =
    ceil(N / S) node rows a CTA), `resident` (the CTA's residuals — free
    [R, Nl], count, nz [2, Nl] int64, the pods each row still takes and
    its negative-slot bits [Nl] int32 — and the [B] int32 choices in its
    shared memory: when they fit SOLVE_SMEM_BUDGET with at most
    MAX_ROWS_PER_THREAD rows a thread), `track_shared` (the tracking's ca /
    cb replicas, [TT, V] int32 each, in shared memory too) and `smem`, the
    dynamic shared-memory bytes a CTA asks for."""
    rows = -(-n // shards)
    state = (r + 4) * rows * 8 + b * 4
    resident = rows <= MAX_ROWS_PER_THREAD * SOLVE_THREADS and state <= SOLVE_SMEM_BUDGET
    smem = state if resident else 0
    track_shared = False
    if track:
        smem += (2 * tt + u) * 4
        track_shared = smem + 2 * tt * v * 4 <= SOLVE_SMEM_BUDGET
        if track_shared:
            smem += 2 * tt * v * 4
    return {"rows": rows, "resident": resident, "track_shared": track_shared, "smem": smem}


def solve_args(mask, score, req, free0, count0, allowed, order, key, deterministic, req_any, sig, pod_valid, nz0,
               scoring_req, shards: Optional[int] = None, inb=None, group=None) -> tuple:
    """csrc/solver.cu's struct for these CUDA tensors, one cluster of
    `shards` CTAs (SOLO_SHARDS on one device, one a node shard on a mesh):
    (ClusterSolveArgs, the [B] int32 assignment, the (free, count, nz)
    carry it updates in place, gang_ok or None). With `group` the two-pass
    gang mode (no tracking): both passes from free0 / count0 / nz0.
    The struct holds what it points at in `.keepalive`."""
    walk, out, carry = walk_args(mask, score, req, free0, count0, allowed, order, deterministic, req_any, sig,
                                 pod_valid, nz0, scoring_req)
    U, N = mask.shape
    R = req.shape[1]
    B = order.shape[0]
    dev = mask.device
    shards = SOLO_SHARDS if shards is None else shards
    track = group is None and inb is not None
    tt = inb["anti"].shape[0] if track else 0
    v = int(inb["n_buckets"]) if track else 0
    lay = solve_layout(N, R, B, shards, tt, U, v, track)
    steps = torch.empty((shards * B * 4,), dtype=torch.int32, device=dev)
    sel = torch.empty((0 if lay["resident"] else shards * B,), dtype=torch.int32, device=dev)
    common = dict(S=shards, Nl=lay["rows"], resident=int(lay["resident"]),
                  track_shared=int(lay["track_shared"]),
                  steps=steps.data_ptr(), sel=sel.data_ptr())
    if group is None:
        walk.seed = noise_seed(key)
        if track:
            walk.tracked = _track_args(walk, inb, U, N, dev, replicas=0 if lay["track_shared"] else shards)
        args = ClusterSolveArgs(walk=walk, gang=0, **common)
        args.keepalive = (walk, steps, sel)
        args.smem = lay["smem"]
        return args, out, carry, None
    # pass 1's scratch carry: only the device-memory state walks in place
    scratch = tuple(c.clone() if not lay["resident"] else c for c in carry)
    free1, count1, nz1 = scratch
    group32 = group.to(torch.int32).contiguous()
    first = torch.empty((shards * B,), dtype=torch.int32, device=dev)  # a replica a CTA
    fail = torch.empty((shards * B,), dtype=torch.int32, device=dev)  # zeroed by the kernel
    alive = torch.empty((shards * B,), dtype=torch.bool, device=dev)
    gang_ok = torch.empty((B,), dtype=torch.bool, device=dev)
    k1, k2 = prng_split(key)
    args = ClusterSolveArgs(
        walk=walk, gang=1,
        group=build.ptr(group32, torch.int32, (B,)),
        first=build.ptr(first, torch.int32),
        fail=build.ptr(fail, torch.int32),
        alive=build.ptr(alive, torch.bool),
        gang_ok=build.ptr(gang_ok, torch.bool, (B,)),
        free1=build.ptr(free1, torch.int64, (N, R)),
        count1=build.ptr(count1, torch.int64, (N,)),
        nz1=build.ptr(nz1, torch.int64, (N, 2)),
        seed1=noise_seed(k1), seed2=noise_seed(k2), **common,
    )
    args.keepalive = (walk, group32, first, fail, alive, scratch, steps, sel)
    args.smem = lay["smem"]
    return args, out, carry, gang_ok


def launch_solve(args: ClusterSolveArgs, dev, counted=None) -> None:
    """Launch csrc/solver.cu as one cluster of `args.S` CTAs. More than
    build.MAX_CLUSTER CTAs, or a cluster the card cannot co-schedule,
    raises. A launch whose residuals stay in device memory counts in
    `counted.global_state_launches` (the wrapper's function)."""
    build.check_clusters(SOLVE_ENTRY, args, (args.smem, args.resident, args.track_shared))
    build.launch(SOLVE_ENTRY, args, dev)
    if counted is not None and not args.resident:
        counted.global_state_launches += 1


def _solve_greedy_cuda(
    mask, score, req, free0, count0, allowed, order, key, deterministic,
    req_any, sig, pod_valid, return_carry, nz0, scoring_req, inb=None,
):
    args, out, carry, _ = solve_args(mask, score, req, free0, count0, allowed, order, key, deterministic, req_any,
                                     sig, pod_valid, nz0, scoring_req, inb=inb)
    launch_solve(args, mask.device, solve_greedy)
    solve_greedy.launches += 1
    if inb is not None:
        solve_greedy.tracked_launches += 1
    if return_carry:
        return out, carry
    return out


def solve_greedy(
    mask: torch.Tensor,  # [U, N] feasibility (spec rows)
    score: torch.Tensor,  # [U, N] int64 weighted priority sums
    req: torch.Tensor,  # [U, R] pod requests
    free0: torch.Tensor,  # [N, R] alloc - requested at batch start
    count0: torch.Tensor,  # [N] pod counts at batch start
    allowed: torch.Tensor,  # [N] allowed pod numbers
    order: torch.Tensor,  # [B] scan order (pop_order)
    key: Sequence[int],  # two uint32 key words for tie-breaks
    deterministic: bool = False,
    req_any: Optional[torch.Tensor] = None,  # [U]
    sig: Optional[torch.Tensor] = None,  # [B] pod → spec row (None: identity)
    pod_valid: Optional[torch.Tensor] = None,  # [B] (None: all valid)
    return_carry: bool = False,
    nz0: Optional[torch.Tensor] = None,  # [N, 2]
    scoring_req: Optional[torch.Tensor] = None,  # [U, 2]
    inb: Optional[dict] = None,  # in-batch anti-affinity / host-port tracking
):
    """Greedy-by-priority batch assignment → node row per pod (-1 = no
    fit), plus the post-batch (free, count, nz) carry with return_carry.
    CPU tensors run the plain chunked version; CUDA tensors launch
    csrc/solver.cu, one cluster of SOLO_SHARDS CTAs (counted in
    `solve_greedy.launches`, those with tracking also in
    `solve_greedy.tracked_launches`, and those whose residuals are too
    large for shared memory in `solve_greedy.global_state_launches`).

    `inb` (ops/pipeline._inbatch_tensors) turns on the in-batch tracking:
    a pod may not take a node sharing a topology bucket with an earlier
    in-batch commit its own required anti-affinity term matches, nor one
    where an earlier commit's anti term matches it, nor a node an earlier
    commit with a clashing host port took. Keys: anti [TT] bool (valid
    ANTI_REQ rows), owner [TT] (spec row), m_bb [TT, U] bool (term matches
    spec labels and namespace), topo_slot [TT], label_dense [N, K] (the
    node bank's dense topology buckets), port_conflict [U, U] bool,
    n_buckets (V)."""
    dev = mask.device
    if dev.type == "cpu":
        return solve_greedy_plain(
            mask, score, req, free0, count0, allowed, order, key, deterministic,
            req_any, sig, pod_valid, DEFAULT_CHUNK, return_carry, nz0, scoring_req, inb,
        )
    if dev.type == "cuda":
        return _solve_greedy_cuda(
            mask, score, req, free0, count0, allowed, order, key, deterministic,
            req_any, sig, pod_valid, return_carry, nz0, scoring_req, inb,
        )
    raise ValueError(f"no solve kernel for device {dev}")


solve_greedy.launches = 0
solve_greedy.tracked_launches = 0
solve_greedy.global_state_launches = 0


# --- all-or-nothing gang solve ----------------------------------------------

def check_group_ids(group: torch.Tensor, b: int) -> None:
    """Every group id must lie in [-1, B): the segment max over group ids
    indexes a [B] table (the reference's jitted scatter would drop an id
    out of range and its gather clamp one; the driver never builds one)."""
    if group.shape != (b,):
        raise ValueError(f"expected group ids of shape ({b},), got {tuple(group.shape)}")
    if b and group.numel():
        lo, hi = (int(v) for v in torch.aminmax(group))
        if lo < -1 or hi >= b:
            raise IndexError(f"group ids must lie in [-1, {b}), got [{lo}, {hi}]")


def gang_dropped(group: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """[B] bool: the grouped positions whose group has a member that pass 1
    left unplaced (a segment max over group ids, which are < B)."""
    grouped = group >= 0
    failed = grouped & (first < 0)
    gidx = torch.where(grouped, group, torch.zeros_like(group)).long()
    fail_by_group = torch.zeros(group.shape[0], dtype=torch.int32, device=group.device)
    fail_by_group.scatter_reduce_(0, gidx, failed.to(torch.int32), reduce="amax")
    return grouped & (fail_by_group[gidx] > 0)


def solve_gang_plain(
    mask, score, req, free0, count0, allowed, order, group, key, deterministic=False,
    req_any=None, sig=None, pod_valid=None, return_carry=False, nz0=None, scoring_req=None,
    chunk: int = DEFAULT_CHUNK,
):
    """The reference's two-pass gang solve (solver.py:solve_gang) in plain
    PyTorch: pass 1 places every valid pod with the first half of the split
    key; groups with a member left unplaced are dropped; pass 2 re-solves
    the rest from the same starting residuals with the second half. Returns
    (assign, gang_ok[, pass 2's carry])."""
    k1, k2 = prng_split(key)
    first = solve_greedy_plain(mask, score, req, free0, count0, allowed, order, k1, deterministic,
                               req_any, sig, pod_valid, chunk)
    dropped = gang_dropped(group, first)
    alive = ~dropped if pod_valid is None else pod_valid & ~dropped
    result = solve_greedy_plain(mask, score, req, free0, count0, allowed, order, k2, deterministic,
                                req_any, sig, alive, chunk, return_carry, nz0, scoring_req)
    second, carry = result if return_carry else (result, None)
    assign = torch.where(dropped, torch.full_like(second, -1), second)
    if return_carry:
        return assign, ~dropped, carry
    return assign, ~dropped


def _solve_gang_cuda(
    mask, score, req, free0, count0, allowed, order, group, key, deterministic,
    req_any, sig, pod_valid, return_carry, nz0, scoring_req,
):
    args, out, carry, gang_ok = solve_args(mask, score, req, free0, count0, allowed, order, key, deterministic,
                                           req_any, sig, pod_valid, nz0, scoring_req, group=group)
    launch_solve(args, mask.device, solve_gang)
    solve_gang.launches += 1
    if return_carry:
        return out, gang_ok, carry
    return out, gang_ok


def solve_gang(
    mask: torch.Tensor,  # [U, N] feasibility (spec rows)
    score: torch.Tensor,  # [U, N] int64 weighted priority sums
    req: torch.Tensor,  # [U, R] pod requests
    free0: torch.Tensor,  # [N, R] alloc - requested at batch start
    count0: torch.Tensor,  # [N] pod counts at batch start
    allowed: torch.Tensor,  # [N] allowed pod numbers
    order: torch.Tensor,  # [B] scan order (pop_order)
    group: torch.Tensor,  # [B] group id per batch position, -1 = ungrouped
    key: Sequence[int],  # two uint32 key words, split for the two passes
    deterministic: bool = False,
    req_any: Optional[torch.Tensor] = None,  # [U]
    sig: Optional[torch.Tensor] = None,  # [B] pod → spec row (None: identity)
    pod_valid: Optional[torch.Tensor] = None,  # [B] (None: all valid)
    return_carry: bool = False,
    nz0: Optional[torch.Tensor] = None,  # [N, 2]
    scoring_req: Optional[torch.Tensor] = None,  # [U, 2]
):
    """All-or-nothing gang assignment (the reference's solve_gang): two
    greedy passes around a group-fail segment max. Members of a group with
    a member pass 1 could not place come back -1 with gang_ok False, and
    their capacity goes to the other pods in pass 2. Returns (assign [B],
    gang_ok [B] bool), plus pass 2's (free, count, nz) carry with
    return_carry. No in-batch tracking, as in the reference. Group ids are
    checked on the host first. CPU tensors run the plain version; CUDA
    tensors launch csrc/solver.cu's gang mode, one cluster of SOLO_SHARDS
    CTAs, both passes in one launch (counted in `solve_gang.launches`; a
    launch with its residuals in device memory also in
    `solve_gang.global_state_launches`)."""
    check_group_ids(group, order.shape[0])
    dev = mask.device
    if dev.type == "cpu":
        return solve_gang_plain(
            mask, score, req, free0, count0, allowed, order, group, key, deterministic,
            req_any, sig, pod_valid, return_carry, nz0, scoring_req,
        )
    if dev.type == "cuda":
        return _solve_gang_cuda(
            mask, score, req, free0, count0, allowed, order, group, key, deterministic,
            req_any, sig, pod_valid, return_carry, nz0, scoring_req,
        )
    raise ValueError(f"no solve kernel for device {dev}")


solve_gang.launches = 0
solve_gang.global_state_launches = 0
