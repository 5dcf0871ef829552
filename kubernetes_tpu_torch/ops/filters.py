"""Filter: the pods x nodes feasibility mask.

Port of `kubernetes_tpu/ops/filters.py`. `combined_mask` is the AND of the
enabled non-topology predicates — CheckNodeUnschedulable, PodFitsHost,
PodFitsHostPorts, PodMatchNodeSelector (nodeSelector pairs + required node
affinity with In/NotIn/Exists/DoesNotExist/Gt/Lt/metadata.name), PodFits-
Resources and PodToleratesNodeTaints — masked by spec-row validity and by
node `valid & ~fallback`.

On CUDA tensors it launches the hand-written kernel `csrc/filters.cu`; on
CPU tensors it runs the plain PyTorch version below, a straight port of the
JAX arithmetic. Any other device raises. `inbatch_port_conflict` — the
spec-pair host-port table of the solver's in-batch tracking
(ops/pipeline._inbatch_tensors) — shares `port_clash` with the
PodFitsHostPorts mask; its kernel is in `csrc/interpod.cu`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..api.types import TAINT_NODE_UNSCHEDULABLE
from ..kernels import build
from ..oracle.predicates import GENERAL_PREDICATES_EXPANSION
from ..state.tensors import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NAME_IN,
    OP_NAME_NOT_IN,
    OP_NEVER,
    OP_NOT_IN,
    TOL_EXISTS,
)

Arrays = Dict[str, torch.Tensor]

# mask key → Policy/provider registration name (predicates.go:56-110), and
# the kernel's bit for it (csrc/filters.cu PRED_*)
MASK_PRED_NAMES = {
    "unschedulable": "CheckNodeUnschedulable",
    "host": "HostName",
    "ports": "PodFitsHostPorts",
    "selector": "MatchNodeSelector",
    "resources": "PodFitsResources",
    "taints": "PodToleratesNodeTaints",
}
PRED_BITS = {k: 1 << i for i, k in enumerate(MASK_PRED_NAMES)}


def make_ids(vocab) -> Dict[str, int]:
    """Interned constants the filter needs, as Python ints."""
    return {
        "wildcard_ip": int(vocab.wildcard_ip),
        "unschedulable_key": int(vocab.id(TAINT_NODE_UNSCHEDULABLE)),
        "empty_val": int(vocab.id("")),
    }


def enabled_masks(predicates=None) -> tuple:
    """Mask keys a Policy's predicate set turns on (None = all)."""
    if predicates is None:
        return tuple(MASK_PRED_NAMES)
    on = []
    for key, name in MASK_PRED_NAMES.items():
        if name in predicates or (
            name in GENERAL_PREDICATES_EXPANSION and "GeneralPredicates" in predicates
        ):
            on.append(key)
    return tuple(on)


# ---------------------------------------------------------------------------
# plain PyTorch version (filters.py arithmetic, one predicate at a time)
# ---------------------------------------------------------------------------


def _tolerates(pods: Arrays, taint_key, taint_val, taint_effect) -> torch.Tensor:
    """Toleration.ToleratesTaint broadcast over a taint tensor [B-or-1, T]
    → [B, T]: tolerated by ANY of the pod's tolerations."""
    tk = taint_key[..., :, None]
    tv = taint_val[..., :, None]
    te = taint_effect[..., :, None]
    pe = pods["tol_effect"][:, None, :]
    ok_effect = (pe == 0) | (pe == te)
    ok_key = (pods["tol_key"][:, None, :] == 0) | (pods["tol_key"][:, None, :] == tk)
    ok_value = (pods["tol_op"][:, None, :] == TOL_EXISTS) | (pods["tol_val"][:, None, :] == tv)
    match = pods["tol_valid"][:, None, :] & ok_effect & ok_key & ok_value
    return match.any(dim=-1)


def check_node_unschedulable(nodes: Arrays, pods: Arrays, ids) -> torch.Tensor:
    """CheckNodeUnschedulablePredicate (predicates.go:1584)."""
    b = pods["valid"].shape[0]
    dev = pods["valid"].device
    key = torch.full((b, 1), int(ids["unschedulable_key"]), dtype=torch.int32, device=dev)
    val = torch.full((b, 1), int(ids["empty_val"]), dtype=torch.int32, device=dev)
    eff = torch.full((b, 1), EFFECT_NO_SCHEDULE, dtype=torch.int32, device=dev)
    tol = _tolerates(pods, key, val, eff)[:, 0]
    return (~nodes["unschedulable"])[None, :] | tol[:, None]


def pod_fits_host(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """PodFitsHost (predicates.go:991)."""
    pinned = pods["node_name_id"][:, None]
    return (pinned == 0) | (pinned == nodes["name_id"][None, :])


def pod_fits_resources(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """PodFitsResources (predicates.go:854): pod count always; resource
    rows only when the pod requests anything; scalar slots only when
    requested."""
    count_ok = (nodes["pod_count"] + 1 <= nodes["allowed_pods"])[None, :]
    free = nodes["alloc"] - nodes["requested"]
    req = pods["req"][:, None, :]
    ok = req <= free[None, :, :]
    r = free.shape[-1]
    always = torch.arange(r, device=free.device) < 3
    checked = always[None, None, :] | (req > 0)
    fits = (ok | ~checked).all(dim=-1)
    return count_ok & (fits | ~pods["req_any"][:, None])


def port_clash(num_a, proto_a, ip_a, num_b, proto_b, ip_b, wild) -> torch.Tensor:
    """HostPortInfo.CheckConflict: the same (protocol, port) conflicts when
    either IP is the wildcard or they are equal."""
    ip_clash = (ip_a == wild) | (ip_b == wild) | (ip_a == ip_b)
    return (num_a > 0) & (num_b > 0) & (num_a == num_b) & (proto_a == proto_b) & ip_clash


def pod_fits_host_ports(nodes: Arrays, pods: Arrays, ids) -> torch.Tensor:
    """PodFitsHostPorts (predicates.go:1161)."""
    conflict = port_clash(
        pods["port_num"][:, None, :, None],
        pods["port_proto"][:, None, :, None],
        pods["port_ip"][:, None, :, None],
        nodes["port_num"][None, :, None, :],
        nodes["port_proto"][None, :, None, :],
        nodes["port_ip"][None, :, None, :],
        int(ids["wildcard_ip"]),
    )
    return ~conflict.any(dim=3).any(dim=2)


def eval_requirements(nodes: Arrays, op, slot, vals, num) -> torch.Tensor:
    """Compiled node-selector requirements against every node.
    op/slot/num: [B, T, R]; vals: [B, T, R, V] → [B, T, R, N] bool (PAD
    requirements evaluate True so they AND away)."""
    k = nodes["label_vals"].shape[1]
    slot_c = slot.clamp(0, k - 1).long()
    node_val = nodes["label_vals"].T[slot_c]  # [B, T, R, N]
    known = slot >= 0
    present = known[..., None] & (node_val != 0)
    node_num = nodes["label_num"].T[slot_c]
    node_num_ok = nodes["label_num_ok"].T[slot_c] & known[..., None]
    in_set = (node_val[..., None, :] == vals[..., :, None]).any(dim=-2)
    name_eq = nodes["name_id"][None, None, None, :] == vals[..., 0:1]

    res = torch.ones_like(present)
    opx = op[..., None]
    res = torch.where(opx == OP_IN, present & in_set, res)
    res = torch.where(opx == OP_NOT_IN, ~present | ~in_set, res)
    res = torch.where(opx == OP_EXISTS, present, res)
    res = torch.where(opx == OP_DOES_NOT_EXIST, ~present, res)
    res = torch.where(opx == OP_GT, node_num_ok & (node_num > num[..., None]), res)
    res = torch.where(opx == OP_LT, node_num_ok & (node_num < num[..., None]), res)
    res = torch.where(opx == OP_NAME_IN, name_eq, res)
    res = torch.where(opx == OP_NAME_NOT_IN, ~name_eq, res)
    res = torch.where(opx == OP_NEVER, torch.zeros_like(res), res)
    return res


def pod_match_node_selector(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """PodMatchNodeSelector (predicates.go:979): nodeSelector pairs ANDed
    with required node-affinity terms (terms ORed; requirements ANDed)."""
    k = nodes["label_vals"].shape[1]
    slot = pods["sel_pair_slot"]
    node_val = nodes["label_vals"].T[slot.clamp(0, k - 1).long()]  # [B, NSP, N]
    pair_ok = (slot[..., None] < 0) | (node_val == pods["sel_pair_val"][..., None])
    map_ok = pair_ok.all(dim=1)
    req_ok = eval_requirements(
        nodes, pods["term_req_op"], pods["term_req_slot"], pods["term_req_vals"], pods["term_req_num"]
    )
    term_ok = pods["term_valid"][..., None] & req_ok.all(dim=2)  # [B, TERMS, N]
    affinity_ok = term_ok.any(dim=1) | ~pods["has_required"][:, None]
    return map_ok & affinity_ok


def pod_tolerates_node_taints(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """PodToleratesNodeTaints (predicates.go:1604): every NoSchedule /
    NoExecute taint must be tolerated."""
    eff = nodes["taint_effect"]
    blocking = (eff == EFFECT_NO_SCHEDULE) | (eff == EFFECT_NO_EXECUTE)  # [N, T]
    n, t = nodes["taint_key"].shape
    tol = _tolerates(
        pods,
        nodes["taint_key"].reshape(1, -1),
        nodes["taint_val"].reshape(1, -1),
        eff.reshape(1, -1),
    ).reshape(-1, n, t)
    return (~blocking[None, :, :] | tol).all(dim=-1)


def filter_masks(nodes: Arrays, pods: Arrays, ids) -> Dict[str, torch.Tensor]:
    """Every non-topology predicate mask on its own (plain version)."""
    return {
        "unschedulable": check_node_unschedulable(nodes, pods, ids),
        "host": pod_fits_host(nodes, pods),
        "ports": pod_fits_host_ports(nodes, pods, ids),
        "selector": pod_match_node_selector(nodes, pods),
        "resources": pod_fits_resources(nodes, pods),
        "taints": pod_tolerates_node_taints(nodes, pods),
    }


def combined_mask_plain(nodes: Arrays, pods: Arrays, ids, predicates=None) -> torch.Tensor:
    """findNodesThatFit's feasibility matrix [B, N], plain PyTorch."""
    m = filter_masks(nodes, pods, ids)
    out = pods["valid"][:, None] & torch.ones_like(m["resources"])
    for key in enabled_masks(predicates):
        out = out & m[key]
    ok_nodes = nodes["valid"] & ~nodes["fallback"]
    return out & ok_nodes[None, :]


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_NODE_PTRS = (
    ("valid", torch.bool), ("fallback", torch.bool), ("name_id", torch.int32),
    ("alloc", torch.int64), ("requested", torch.int64), ("allowed_pods", torch.int32),
    ("pod_count", torch.int32), ("label_vals", torch.int32), ("label_num", torch.int64),
    ("label_num_ok", torch.bool), ("taint_key", torch.int32), ("taint_val", torch.int32),
    ("taint_effect", torch.int32), ("unschedulable", torch.bool), ("port_proto", torch.int32),
    ("port_ip", torch.int32), ("port_num", torch.int32),
)
_POD_PTRS = (
    ("valid", torch.bool), ("req", torch.int64), ("req_any", torch.bool),
    ("node_name_id", torch.int32), ("tol_key", torch.int32), ("tol_op", torch.int32),
    ("tol_val", torch.int32), ("tol_effect", torch.int32), ("tol_valid", torch.bool),
    ("sel_pair_slot", torch.int32), ("sel_pair_val", torch.int32), ("has_required", torch.bool),
    ("term_valid", torch.bool), ("term_req_op", torch.int32), ("term_req_slot", torch.int32),
    ("term_req_vals", torch.int32), ("term_req_num", torch.int64), ("port_proto", torch.int32),
    ("port_ip", torch.int32), ("port_num", torch.int32),
)
_DIMS = ("N", "U", "K", "R", "T", "P", "TL", "NSP", "TERMS", "REQS", "VALS", "PP")


FILTER_ENTRY = "ktpu_filter_mask"


class FilterArgs(ctypes.Structure):
    """Mirror of `struct FilterArgs` in csrc/filters.cu."""

    _fields_ = (
        [("n_" + k, ctypes.c_void_p) for k, _ in _NODE_PTRS]
        + [("p_" + k, ctypes.c_void_p) for k, _ in _POD_PTRS]
        + [("out", ctypes.c_void_p), ("sel_out", ctypes.c_void_p)]
        + [(d, ctypes.c_int32) for d in _DIMS]
        + [("wildcard_ip", ctypes.c_int32), ("unschedulable_key", ctypes.c_int32),
           ("empty_val", ctypes.c_int32), ("predicates", ctypes.c_int32)]
    )


def filter_args(nodes: Arrays, pods: Arrays, ids, predicates=None, with_selector: bool = False):
    """The kernel's argument struct for these CUDA tensors, the [U, N] mask
    it writes and, with `with_selector`, the [U, N] raw selector predicate
    it writes in the same launch (else None). Validates device, dtype and
    contiguity (raises)."""
    nodes = dict(nodes)
    # a carried batch state holds pod counts as int64 (ops/pipeline.apply_carry)
    nodes["pod_count"] = nodes["pod_count"].to(torch.int32)
    nodes["allowed_pods"] = nodes["allowed_pods"].to(torch.int32)
    n, r = nodes["alloc"].shape
    u = pods["valid"].shape[0]
    dims = dict(
        N=n, U=u, K=nodes["label_vals"].shape[1], R=r, T=nodes["taint_key"].shape[1],
        P=nodes["port_num"].shape[1], TL=pods["tol_key"].shape[1],
        NSP=pods["sel_pair_slot"].shape[1], TERMS=pods["term_valid"].shape[1],
        REQS=pods["term_req_op"].shape[2], VALS=pods["term_req_vals"].shape[3],
        PP=pods["port_num"].shape[1],
    )
    if pods["req"].shape[1] != r:
        raise ValueError("pod and node resource widths differ")
    out = torch.empty((u, n), dtype=torch.bool, device=nodes["valid"].device)
    sel = torch.empty_like(out) if with_selector else None
    args = FilterArgs()
    for k, dt in _NODE_PTRS:
        setattr(args, "n_" + k, build.ptr(nodes[k], dt))
    for k, dt in _POD_PTRS:
        setattr(args, "p_" + k, build.ptr(pods[k], dt))
    args.out = build.ptr(out, torch.bool, (u, n))
    args.sel_out = None if sel is None else build.ptr(sel, torch.bool, (u, n))
    for d, v in dims.items():
        setattr(args, d, int(v))
    args.wildcard_ip = int(ids["wildcard_ip"])
    args.unschedulable_key = int(ids["unschedulable_key"])
    args.empty_val = int(ids["empty_val"])
    args.predicates = sum(PRED_BITS[k] for k in enabled_masks(predicates))
    # the struct holds raw pointers: keep the converted tensors alive with it
    args.keepalive = (nodes["pod_count"], nodes["allowed_pods"])
    return args, out, sel


def combined_mask(
    nodes: Arrays, pods: Arrays, ids, predicates: Optional[frozenset] = None,
    with_selector: bool = False,
):
    """The [U, N] bool feasibility mask of the enabled predicates
    (None = all); with `with_selector`, the pair (mask, raw
    pod_match_node_selector [U, N]). CPU tensors run the plain versions;
    CUDA tensors launch csrc/filters.cu once for both (counted in
    `combined_mask.launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        mask = combined_mask_plain(nodes, pods, ids, predicates)
        return (mask, pod_match_node_selector(nodes, pods)) if with_selector else mask
    if dev.type == "cuda":
        args, out, sel = filter_args(nodes, pods, ids, predicates, with_selector)
        build.launch(FILTER_ENTRY, args, dev)
        combined_mask.launches += 1
        return (out, sel) if with_selector else out
    raise ValueError(f"no filter kernel for device {dev}")


combined_mask.launches = 0


def inbatch_port_conflict_plain(pods: Arrays, ids) -> torch.Tensor:
    """[U, U] bool: some host port of spec row u clashes with one of spec
    row w (the reference's pairwise port_clash, reduced over both lists)."""
    return port_clash(
        pods["port_num"][:, None, :, None],
        pods["port_proto"][:, None, :, None],
        pods["port_ip"][:, None, :, None],
        pods["port_num"][None, :, None, :],
        pods["port_proto"][None, :, None, :],
        pods["port_ip"][None, :, None, :],
        ids["wildcard_ip"],
    ).any(dim=3).any(dim=2)


PORT_CONFLICT_ENTRY = "ktpu_inbatch_port_conflict"


class PortConflictArgs(ctypes.Structure):
    """Mirror of `struct PortConflictArgs` in csrc/interpod.cu."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in ("port_num", "port_proto", "port_ip", "out")]
        + [(d, ctypes.c_int32) for d in ("U", "PP", "wildcard_ip")]
    )


def port_conflict_args(pods: Arrays, ids):
    """The port-conflict kernel's argument struct and the [U, U] output."""
    u, pp = pods["port_num"].shape
    out = torch.empty((u, u), dtype=torch.bool, device=pods["port_num"].device)
    a = PortConflictArgs()
    for k in ("port_num", "port_proto", "port_ip"):
        setattr(a, k, build.ptr(pods[k], torch.int32, (u, pp)))
    a.out = build.ptr(out, torch.bool)
    a.U, a.PP, a.wildcard_ip = u, pp, int(ids["wildcard_ip"])
    return a, out


def inbatch_port_conflict(pods: Arrays, ids) -> torch.Tensor:
    """The [U, U] spec-pair host-port conflict table. CPU tensors run the
    plain version; CUDA tensors launch csrc/interpod.cu (counted in
    `inbatch_port_conflict.launches`)."""
    dev = pods["port_num"].device
    if dev.type == "cpu":
        return inbatch_port_conflict_plain(pods, ids)
    if dev.type == "cuda":
        args, out = port_conflict_args(pods, ids)
        build.launch(PORT_CONFLICT_ENTRY, args, dev)
        inbatch_port_conflict.launches += 1
        return out
    raise ValueError(f"no filter kernel for device {dev}")


inbatch_port_conflict.launches = 0
