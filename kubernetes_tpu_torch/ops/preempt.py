"""Vectorized victim search: the device formulation of preemption.

Port of `kubernetes_tpu/ops/preempt.py:63 preempt_batch`. One step per
PREEMPTOR, in order (earlier victims vanish for later preemptors, and each
chosen preemptor's request becomes a nominee charge on its node), and in
each step the victim search of selectVictimsOnNode (generic_scheduler.go
:1104) on every node at once followed by pickOneNodeForPreemption's
six-key pick (:878):

  fits_free  the pod fits a candidate node as it is, nominees charged: no
             preemption (the caller retries the pod);
  victims    every alive, valid, lower-priority slot, then the greedy
             reprieve in slot order (the host pre-sorts each node's slots:
             PDB violators first, then by importance); cpu, memory and
             ephemeral storage (slots 0-2) are always checked, other slots
             only when requested, and a pod that requests nothing passes
             every resource test;
  pick       among feasible nodes (the pod fits after the removal and at
             least one victim is needed) keep-min on PDB violations, the
             highest victim priority, the int64 priority sum, the victim
             count and the negated latest start time of the top-priority
             victims, then the lowest row.

The carry is kept as the nominee-adjusted free vector `free - nom_extra`
and pod slack `count_free - nom_cnt`, the only forms the scan reads; the
chosen row's update (`+ freed - req`, `+ cnt - 1`) is the same integer
arithmetic.

`preempt_batch_plain` is the scan as a Python loop of PyTorch ops with the
reference's dtypes (int64 resources and timestamps, int32 priorities and
counts). On CUDA tensors `preempt_batch` launches csrc/preempt.cu (one
block walking the P steps; counted in `preempt_batch.launches`); on CPU
tensors it runs the plain version; any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..kernels import build

PREEMPT_ENTRY = "ktpu_preempt_batch"

_BIG = 2**62
_TS_MIN = -(2**62)
_I32_MIN = -(2**31)

#: the kernel keeps a node's victim set in one 64-bit mask and its request
#: vectors in registers of these widths
MAX_VICTIM_SLOTS = 64
MAX_RESOURCES = 64


def preempt_batch_plain(
    cand: torch.Tensor,         # [P, N] bool — candidate nodes (unresolvable predicates pass)
    p_req: torch.Tensor,        # [P, R] int64 — preemptor GetResourceRequest
    p_req_any: torch.Tensor,    # [P] bool — requests anything at all
    p_prio: torch.Tensor,       # [P] int32
    p_valid: torch.Tensor,      # [P] bool
    vict_req: torch.Tensor,     # [N, V, R] int64 — accumulated request per victim slot
    vict_prio: torch.Tensor,    # [N, V] int32
    vict_ts: torch.Tensor,      # [N, V] int64 — creation time (µs)
    vict_pdb: torch.Tensor,     # [N, V] bool — PDB-violating
    vict_valid: torch.Tensor,   # [N, V] bool — slot holds a disruptable pod
    free0: torch.Tensor,        # [N, R] int64 — allocatable - requested
    count_free0: torch.Tensor,  # [N] int32 — allowed pods - pod count
    node_valid: torch.Tensor,   # [N] bool
    nom_extra0: torch.Tensor,   # [N, R] int64 — out-of-batch nominee requests
    nom_cnt0: torch.Tensor,     # [N] int32 — out-of-batch nominee pod counts
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(chosen [P] int32 node row or -1, victims [P, V] bool of the chosen
    node, fits_free [P] bool)."""
    n, v_cap, r = vict_req.shape
    p = p_prio.shape[0]
    dev = vict_req.device
    always = (torch.arange(r, device=dev) < 3)[None, :]
    nfree = free0.to(torch.int64) - nom_extra0.to(torch.int64)
    ncount = count_free0.to(torch.int32) - nom_cnt0.to(torch.int32)
    alive = torch.ones((n, v_cap), dtype=torch.bool, device=dev)
    vict_prio = vict_prio.to(torch.int32)
    prio64 = vict_prio.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    nodes_out = torch.full((p,), -1, dtype=torch.int32, device=dev)
    victims_out = torch.zeros((p, v_cap), dtype=torch.bool, device=dev)
    fits_free_out = torch.zeros((p,), dtype=torch.bool, device=dev)
    for k in range(p):
        req = p_req[k].to(torch.int64)
        not_any = ~p_req_any[k]
        checked = always | (req[None, :] > 0)
        live = cand[k] & node_valid
        free_ok = ((nfree - req[None, :] >= 0) | ~checked).all(dim=1) | not_any
        fits_free = (live & free_ok & (ncount >= 1)).any()
        lower = alive & vict_valid & (vict_prio < p_prio[k].to(torch.int32))
        freed = torch.where(lower[..., None], vict_req, zero).sum(dim=1)
        nfreed = lower.sum(dim=1).to(torch.int32)
        head = nfree + freed - req[None, :]
        res_ok = ((head >= 0) | ~checked).all(dim=1) | not_any
        cslack = ncount + nfreed - 1
        fits = live & res_ok & (cslack >= 0) & (nfreed > 0)
        victims = torch.zeros((n, v_cap), dtype=torch.bool, device=dev)
        for vi in range(v_cap):
            is_l = lower[:, vi]
            r_v = vict_req[:, vi]
            keep_res = ((head - r_v >= 0) | ~checked).all(dim=1) | not_any
            can_keep = is_l & keep_res & (cslack >= 1)
            head = head - torch.where(can_keep[:, None], r_v, zero)
            cslack = cslack - can_keep.to(torch.int32)
            victims[:, vi] = is_l & ~can_keep
        cnt = victims.sum(dim=1).to(torch.int32)
        feasible = fits & (cnt > 0)
        viol = (victims & vict_pdb).sum(dim=1).to(torch.int64)
        maxprio = torch.where(victims, vict_prio, torch.full_like(vict_prio, _I32_MIN)).max(dim=1).values
        maxprio = maxprio.to(torch.int64)
        psum = torch.where(victims, prio64, zero).sum(dim=1)
        is_top = victims & (prio64 == maxprio[:, None])
        maxts = torch.where(is_top, vict_ts.to(torch.int64), torch.full_like(vict_ts, _TS_MIN,
                                                                              dtype=torch.int64)).max(dim=1).values
        sel = feasible
        for key in (viol, maxprio, psum, cnt.to(torch.int64), -maxts):
            masked = torch.where(sel, key, torch.full_like(key, _BIG))
            sel = sel & (masked == masked.min())
        found = bool(sel.any() & p_valid[k] & ~fits_free)
        fits_free_out[k] = fits_free
        if not found:
            continue
        chosen = int(sel.to(torch.int8).argmax())  # the lowest row among the survivors
        vrow = victims[chosen]
        freed_sel = torch.where(vrow[:, None], vict_req[chosen], zero).sum(dim=0)
        nfree[chosen] += freed_sel - req
        ncount[chosen] += cnt[chosen] - 1
        alive[chosen] &= ~vrow
        nodes_out[k] = chosen
        victims_out[k] = vrow
    return nodes_out, victims_out, fits_free_out


class PreemptArgs(ctypes.Structure):
    """Mirror of `struct PreemptArgs` in csrc/preempt.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "cand", "p_req", "p_req_any", "p_prio", "p_valid", "vict_req", "vict_prio", "vict_ts",
            "vict_pdb", "vict_valid", "free0", "count_free0", "node_valid", "nom_extra0", "nom_cnt0",
            "nodes_out", "victims_out", "fits_free_out",
            "nfree", "ncount", "alive", "vmask", "pdbmask")]
        + [(d, ctypes.c_int32) for d in ("P", "N", "V", "R")]
    )


def preempt_args(cand, p_req, p_req_any, p_prio, p_valid, vict_req, vict_prio, vict_ts, vict_pdb, vict_valid,
                 free0, count_free0, node_valid, nom_extra0, nom_cnt0):
    """(argument struct, (nodes_out, victims_out, fits_free_out)) for these
    CUDA tensors; the outputs and the kernel's scratch (the carry) are
    allocated here. Validates device, dtype, shape and contiguity, and the
    kernel's limits (V <= 64, R <= 64)."""
    n, v, r = vict_req.shape
    p = p_prio.shape[0]
    if v > MAX_VICTIM_SLOTS or r > MAX_RESOURCES:
        raise ValueError(f"preempt kernel takes V <= {MAX_VICTIM_SLOTS} and R <= {MAX_RESOURCES}, got V={v} R={r}")
    dev = vict_req.device
    nodes_out = torch.empty(p, dtype=torch.int32, device=dev)
    victims_out = torch.empty((p, v), dtype=torch.bool, device=dev)
    fits_free_out = torch.empty(p, dtype=torch.bool, device=dev)
    scratch = {
        "nfree": torch.empty((n, r), dtype=torch.int64, device=dev),
        "ncount": torch.empty(n, dtype=torch.int32, device=dev),
        "alive": torch.empty(n, dtype=torch.int64, device=dev),
        "vmask": torch.empty(n, dtype=torch.int64, device=dev),
        "pdbmask": torch.empty(n, dtype=torch.int64, device=dev),
    }
    a = PreemptArgs()
    a.cand = build.ptr(cand, torch.bool, (p, n))
    a.p_req = build.ptr(p_req, torch.int64, (p, r))
    a.p_req_any = build.ptr(p_req_any, torch.bool, (p,))
    a.p_prio = build.ptr(p_prio, torch.int32, (p,))
    a.p_valid = build.ptr(p_valid, torch.bool, (p,))
    a.vict_req = build.ptr(vict_req, torch.int64, (n, v, r))
    a.vict_prio = build.ptr(vict_prio, torch.int32, (n, v))
    a.vict_ts = build.ptr(vict_ts, torch.int64, (n, v))
    a.vict_pdb = build.ptr(vict_pdb, torch.bool, (n, v))
    a.vict_valid = build.ptr(vict_valid, torch.bool, (n, v))
    a.free0 = build.ptr(free0, torch.int64, (n, r))
    a.count_free0 = build.ptr(count_free0, torch.int32, (n,))
    a.node_valid = build.ptr(node_valid, torch.bool, (n,))
    a.nom_extra0 = build.ptr(nom_extra0, torch.int64, (n, r))
    a.nom_cnt0 = build.ptr(nom_cnt0, torch.int32, (n,))
    a.nodes_out = build.ptr(nodes_out, torch.int32)
    a.victims_out = build.ptr(victims_out, torch.bool)
    a.fits_free_out = build.ptr(fits_free_out, torch.bool)
    for k, t in scratch.items():
        setattr(a, k, t.data_ptr())
    a.P, a.N, a.V, a.R = p, n, v, r
    # the scratch must outlive the launch: the struct holds its pointers
    a._keep = scratch
    return a, (nodes_out, victims_out, fits_free_out)


def preempt_batch(cand, p_req, p_req_any, p_prio, p_valid, vict_req, vict_prio, vict_ts, vict_pdb, vict_valid,
                  free0, count_free0, node_valid, nom_extra0, nom_cnt0):
    """(chosen [P] int32 row or -1, victims [P, V] bool, fits_free [P]
    bool). CPU tensors run the plain version; CUDA tensors launch
    csrc/preempt.cu (counted in `preempt_batch.launches`)."""
    args = (cand, p_req, p_req_any, p_prio, p_valid, vict_req, vict_prio, vict_ts, vict_pdb, vict_valid,
            free0, count_free0, node_valid, nom_extra0, nom_cnt0)
    dev = vict_req.device
    if dev.type == "cpu":
        return preempt_batch_plain(*args)
    if dev.type == "cuda":
        st, out = preempt_args(*args)
        build.launch(PREEMPT_ENTRY, st, dev)
        preempt_batch.launches += 1
        return out
    raise ValueError(f"no preempt kernel for device {dev}")


preempt_batch.launches = 0
