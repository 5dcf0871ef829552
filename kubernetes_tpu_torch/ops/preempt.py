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
block walking the P steps with the carry and a cache of every node's victim
search in shared memory, re-evaluating only the rows whose inputs changed;
counted in `preempt_batch.launches`, and a walk whose state does not fit
shared memory in `preempt_batch.device_memory_launches`); on CPU tensors it
runs the plain version; any other device raises.
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
            "state", "step_flags", "step_checked", "walk_stats")]
        + [("state_bytes", ctypes.c_int64), ("smem_bytes", ctypes.c_int64)]
        + [(d, ctypes.c_int32) for d in ("P", "N", "V", "R", "NP", "resident", "victims_resident")]
    )


#: the walk's dynamic shared memory budget (the card's 227 KB a block, less
#: the kernel's static slots, with room to spare)
PREEMPT_SMEM_BUDGET = 220 * 1024


def _align16(x: int) -> int:
    return (x + 15) & ~15


def preempt_layout(n: int, v: int, r: int) -> dict:
    """Where csrc/preempt.cu keeps its walk's state for N nodes, V victim
    slots and R resource slots: `NP` (the tournament tree's leaves, a power
    of two >= max(N, 2)), `carry` (its bytes: nfree [R, N] int64; alive,
    PDB, victim masks and the three key words [N] uint64; the tree's three
    key words [NP] uint64; pod slack [N] int32; the fits-free and valid
    bits [N]; as `preempt_carry_bytes`), `resident` (the carry in shared memory: it fits
    PREEMPT_SMEM_BUDGET), `victims_resident` (the victims' requests,
    priorities and start times there too) and `smem`, the dynamic shared
    memory the walk asks for."""
    np_ = max(2, 1 << max(0, n - 1).bit_length())
    carry = _align16(n * (8 * r + 54) + 24 * np_)
    victims = n * v * (8 * r + 12)
    resident = carry <= PREEMPT_SMEM_BUDGET
    victims_resident = resident and carry + victims <= PREEMPT_SMEM_BUDGET
    smem = (carry + (victims if victims_resident else 0)) if resident else 0
    return {"NP": np_, "carry": carry, "resident": resident, "victims_resident": victims_resident, "smem": smem}


def preempt_args(cand, p_req, p_req_any, p_prio, p_valid, vict_req, vict_prio, vict_ts, vict_pdb, vict_valid,
                 free0, count_free0, node_valid, nom_extra0, nom_cnt0):
    """(argument struct, (nodes_out, victims_out, fits_free_out)) for these
    CUDA tensors; the outputs, the walk's state in device memory (its home
    when it does not fit shared memory), the hoisted step facts and the
    walk's counters (`.walk_stats`: [rows evaluated, steps walked by one
    warp, tree rebuilds], int64 on the card, as `.counts`) are allocated
    here. Validates
    device, dtype, shape and contiguity, and the kernel's limits (V <= 64,
    R <= 64)."""
    n, v, r = vict_req.shape
    p = p_prio.shape[0]
    if v > MAX_VICTIM_SLOTS or r > MAX_RESOURCES or r < 1:
        raise ValueError(f"preempt kernel takes V <= {MAX_VICTIM_SLOTS} and 1 <= R <= {MAX_RESOURCES}, "
                         f"got V={v} R={r}")
    dev = vict_req.device
    lay = preempt_layout(n, v, r)
    nodes_out = torch.empty(p, dtype=torch.int32, device=dev)
    victims_out = torch.empty((p, v), dtype=torch.bool, device=dev)
    fits_free_out = torch.empty(p, dtype=torch.bool, device=dev)
    scratch = {
        "state": torch.empty(lay["carry"], dtype=torch.uint8, device=dev),
        "step_flags": torch.empty(p, dtype=torch.int32, device=dev),
        "step_checked": torch.empty(p, dtype=torch.int64, device=dev),
        "walk_stats": torch.zeros(3, dtype=torch.int64, device=dev),
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
    a.state_bytes, a.smem_bytes = lay["carry"], lay["smem"]
    a.P, a.N, a.V, a.R = p, n, v, r
    a.NP, a.resident, a.victims_resident = lay["NP"], int(lay["resident"]), int(lay["victims_resident"])
    # the scratch must outlive the launch: the struct holds its pointers
    a._keep = scratch
    a.counts = scratch["walk_stats"]
    return a, (nodes_out, victims_out, fits_free_out)


def launch_preempt(args: PreemptArgs, dev) -> None:
    """Launch csrc/preempt.cu (its two prologues and the walk); a walk whose
    state stays in device memory counts in
    `preempt_batch.device_memory_launches`."""
    build.launch(PREEMPT_ENTRY, args, dev)
    if not args.resident:
        preempt_batch.device_memory_launches += 1


def preempt_batch(cand, p_req, p_req_any, p_prio, p_valid, vict_req, vict_prio, vict_ts, vict_pdb, vict_valid,
                  free0, count_free0, node_valid, nom_extra0, nom_cnt0):
    """(chosen [P] int32 row or -1, victims [P, V] bool, fits_free [P]
    bool). CPU tensors run the plain version; CUDA tensors launch
    csrc/preempt.cu (counted in `preempt_batch.launches`; a walk too large
    for shared memory also in `preempt_batch.device_memory_launches`)."""
    args = (cand, p_req, p_req_any, p_prio, p_valid, vict_req, vict_prio, vict_ts, vict_pdb, vict_valid,
            free0, count_free0, node_valid, nom_extra0, nom_cnt0)
    dev = vict_req.device
    if dev.type == "cpu":
        return preempt_batch_plain(*args)
    if dev.type == "cuda":
        st, out = preempt_args(*args)
        launch_preempt(st, dev)
        preempt_batch.launches += 1
        return out
    raise ValueError(f"no preempt kernel for device {dev}")


preempt_batch.launches = 0
preempt_batch.device_memory_launches = 0
