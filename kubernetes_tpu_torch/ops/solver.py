"""Batch assignment solver: greedy by queue priority, one batch at a time.

Port of `kubernetes_tpu/ops/solver.py` without the in-batch
anti-affinity/port tracking (`inb`, ROADMAP slice 3). A whole batch of
pending pods is assigned bit-identically to scheduling them one at a time
in the order the reference queue pops them (priority desc, then enqueue
sequence asc): each pod takes the max-(score, tie-noise) node that is
feasible against the residuals every earlier pod left.

* `solve_greedy_plain` is the reference's arithmetic as written: chunks of
  K pods choose nodes in one vectorized [K, N] pass, per-node in-order
  prefix sums accept every pod up to the first misfit, and the rest retry
  against the updated residuals.
* On CUDA tensors `solve_greedy` launches `csrc/solver.cu`, the sequential
  walk that the chunked scan provably equals (solver.py:110-126).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..kernels import build

# chunk width of the prefix-acceptance loop (the reference's DEFAULT_CHUNK)
DEFAULT_CHUNK = 128

_MASK32 = 0xFFFFFFFF


def prng_key_data(seed: int) -> tuple:
    """The two uint32 key words of the reference's jax.random.PRNGKey(seed)
    (threefry: [seed >> 32, seed & 0xFFFFFFFF])."""
    seed = int(seed)
    return ((seed >> 32) & _MASK32, seed & _MASK32)


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


def solve_greedy_plain(
    mask, score, req, free0, count0, allowed, order, key, deterministic=False,
    req_any=None, sig=None, pod_valid=None, chunk: int = DEFAULT_CHUNK,
    return_carry=False, nz0=None, scoring_req=None,
):
    """The reference's chunked prefix-acceptance solve, in plain PyTorch
    (solver.py:solve_greedy without `inb`). Returns the node row per batch
    position (-1 = no fit), plus the (free, count, nz) carry when asked."""
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
        decided = ~pv
        choice = torch.full((K,), -1, dtype=torch.int32, device=dev)
        while not bool(decided.all()):
            res_ok = (~r_any[:, None]) | (r_q[:, None, :] <= free[None, :, :]).all(dim=-1)
            feas = m_r & res_ok & (count[None, :] + 1 <= allowed[None, :])
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
            rows = cidx[commit]
            free.index_add_(0, rows, -r_q[commit])
            count.index_add_(0, rows, torch.ones_like(rows, dtype=count.dtype))
            nzacc.index_add_(0, rows, s_q[commit])
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
        ("U", ctypes.c_int32), ("N", ctypes.c_int32), ("R", ctypes.c_int32), ("B", ctypes.c_int32),
        ("seed", ctypes.c_uint32), ("deterministic", ctypes.c_int32),
    ]


MAX_KERNEL_RESOURCES = 32  # csrc/solver.cu stages one request row in shared memory


def _solve_greedy_cuda(
    mask, score, req, free0, count0, allowed, order, key, deterministic,
    req_any, sig, pod_valid, return_carry, nz0, scoring_req,
):
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
        seed=noise_seed(key),
        deterministic=1 if deterministic else 0,
    )
    build.launch("ktpu_solve_greedy", args, mask.device)
    solve_greedy.launches += 1
    if return_carry:
        return out, (free, count, nz)
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
):
    """Greedy-by-priority batch assignment → node row per pod (-1 = no
    fit), plus the post-batch (free, count, nz) carry with return_carry.
    CPU tensors run the plain chunked version; CUDA tensors launch
    csrc/solver.cu (counted in `solve_greedy.launches`)."""
    dev = mask.device
    if dev.type == "cpu":
        return solve_greedy_plain(
            mask, score, req, free0, count0, allowed, order, key, deterministic,
            req_any, sig, pod_valid, DEFAULT_CHUNK, return_carry, nz0, scoring_req,
        )
    if dev.type == "cuda":
        return _solve_greedy_cuda(
            mask, score, req, free0, count0, allowed, order, key, deterministic,
            req_any, sig, pod_valid, return_carry, nz0, scoring_req,
        )
    raise ValueError(f"no solve kernel for device {dev}")


solve_greedy.launches = 0
