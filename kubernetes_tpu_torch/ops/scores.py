"""Score: the pods x nodes weighted priority matrix (int64).

Port of `kubernetes_tpu/ops/scores.py`. MaxNodeScore = 10. Integer
divisions are Python floor divisions like the reference's `//`;
BalancedResourceAllocation computes in float64 and truncates.

`score_matrix` launches the hand-written kernel `csrc/scores.cu` on CUDA
tensors and runs the plain PyTorch version below on CPU tensors; the
kernel covers every priority, RequestedToCapacityRatio's Policy shape
included. `score_components` (each default priority's plane on its own) is
the same kernel in its component mode.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..kernels import build
from ..state.tensors import EFFECT_PREFER_NO_SCHEDULE, TOL_EXISTS
from .filters import eval_requirements

Arrays = Dict[str, torch.Tensor]

MAX_NODE_SCORE = 10

# image_locality.go thresholds
_MB = 1024 * 1024
IMAGE_MIN = 23 * _MB
IMAGE_MAX = 1000 * _MB


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """Python floor division on integer tensors (the reference's `//`)."""
    return torch.div(a, b, rounding_mode="floor")


def normalize_reduce(scores: torch.Tensor, node_valid: torch.Tensor, reverse: bool) -> torch.Tensor:
    """NormalizeReduce (priorities/reduce.go): scale each row to [0, 10] by
    its max over valid nodes; all-zero rows stay 0 (or become 10 reversed)."""
    masked = torch.where(node_valid[None, :], scores, torch.zeros_like(scores))
    row_max = masked.max(dim=1, keepdim=True).values
    scaled = torch.where(
        row_max > 0, _div(MAX_NODE_SCORE * scores, row_max.clamp(min=1)), torch.zeros_like(scores)
    )
    if reverse:
        scaled = torch.where(row_max > 0, MAX_NODE_SCORE - scaled, torch.full_like(scaled, MAX_NODE_SCORE))
    return scaled


def _requested_both(nodes: Arrays, pods: Arrays):
    """allocatable and (non-zero accumulated + incoming scoring) requested
    for cpu/mem (calculateResourceAllocatableRequest)."""
    alloc_cpu = nodes["alloc"][:, 0][None, :]
    alloc_mem = nodes["alloc"][:, 1][None, :]
    req_cpu = nodes["nonzero_req"][:, 0][None, :] + pods["scoring_req"][:, 0][:, None]
    req_mem = nodes["nonzero_req"][:, 1][None, :] + pods["scoring_req"][:, 1][:, None]
    return alloc_cpu, req_cpu, alloc_mem, req_mem


def _least_score(req, cap):
    ok = (cap > 0) & (req <= cap)
    return torch.where(ok, _div((cap - req) * MAX_NODE_SCORE, cap.clamp(min=1)), torch.zeros_like(req))


def _most_score(req, cap):
    ok = (cap > 0) & (req <= cap)
    return torch.where(ok, _div(req * MAX_NODE_SCORE, cap.clamp(min=1)), torch.zeros_like(req))


def least_requested(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    ac, rc, am, rm = _requested_both(nodes, pods)
    return _div(_least_score(rc, ac) + _least_score(rm, am), 2)


def most_requested(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    ac, rc, am, rm = _requested_both(nodes, pods)
    return _div(_most_score(rc, ac) + _most_score(rm, am), 2)


def balanced_allocation(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """balanced_resource_allocation.go: (1 - |cpuFrac - memFrac|) * 10
    truncated; 0 when either fraction >= 1; missing capacity → fraction 1."""
    ac, rc, am, rm = _requested_both(nodes, pods)
    one = torch.ones((), dtype=torch.float64, device=rc.device)
    cpu_frac = torch.where(ac > 0, rc.double() / ac.clamp(min=1).double(), one)
    mem_frac = torch.where(am > 0, rm.double() / am.clamp(min=1).double(), one)
    diff = (cpu_frac - mem_frac).abs()
    score = ((1.0 - diff) * MAX_NODE_SCORE).long()
    return torch.where((cpu_frac >= 1) | (mem_frac >= 1), torch.zeros_like(score), score)


def node_affinity(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """CalculateNodeAffinityPriorityMap + NormalizeReduce(10, false): the
    weights of matching preferred terms; a term with no expressions
    matches everywhere."""
    req_ok = eval_requirements(
        nodes, pods["pref_req_op"], pods["pref_req_slot"], pods["pref_req_vals"], pods["pref_req_num"]
    )  # [B, PT, REQS, N]
    term_ok = req_ok.all(dim=2) & pods["pref_valid"][..., None]  # [B, PT, N]
    counts = (term_ok.long() * pods["pref_weight"][..., None].long()).sum(dim=1)
    return normalize_reduce(counts, nodes["valid"], reverse=False)


def taint_toleration(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """ComputeTaintTolerationPriorityMap + NormalizeReduce(10, true): the
    count of intolerable PreferNoSchedule taints, inverted. Only
    tolerations with an empty or PreferNoSchedule effect take part."""
    prefer = nodes["taint_effect"] == EFFECT_PREFER_NO_SCHEDULE  # [N, T]
    eligible = pods["tol_valid"] & (
        (pods["tol_effect"] == 0) | (pods["tol_effect"] == EFFECT_PREFER_NO_SCHEDULE)
    )  # [B, TL]
    tk = nodes["taint_key"][None, :, :, None]
    tv = nodes["taint_val"][None, :, :, None]
    te = nodes["taint_effect"][None, :, :, None]
    pk = pods["tol_key"][:, None, None, :]
    pv = pods["tol_val"][:, None, None, :]
    pe = pods["tol_effect"][:, None, None, :]
    po = pods["tol_op"][:, None, None, :]
    ok = (
        eligible[:, None, None, :]
        & ((pe == 0) | (pe == te))
        & ((pk == 0) | (pk == tk))
        & ((po == TOL_EXISTS) | (pv == tv))
    )
    tolerated = ok.any(dim=-1)  # [B, N, T]
    intolerable = (prefer[None, :, :] & ~tolerated).sum(dim=-1)
    return normalize_reduce(intolerable.long(), nodes["valid"], reverse=True)


def prefer_avoid_pods(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """CalculateNodePreferAvoidPodsPriorityMap: 0 when the node's
    preferAvoidPods signatures name the pod's RC/RS controller, else 10."""
    kind = pods["ctrl_kind"][:, None, None]
    uid = pods["ctrl_uid"][:, None, None]
    hit = (nodes["avoid_kind"][None, :, :] == kind) & (nodes["avoid_uid"][None, :, :] == uid)
    avoided = (kind[..., 0] > 0) & hit.any(dim=-1)
    return torch.where(avoided, 0, MAX_NODE_SCORE).long()


def image_locality(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """ImageLocalityPriorityMap: spread-scaled image sizes per (pod image,
    node), clamped to [23MB, 1000MB], mapped to [0, 10]. Ids beyond the
    table width are images no node has: they read column 0 (zeros)."""
    table = nodes["image_scaled"]  # [N, V_img]
    ids = pods["image_ids"]
    in_vocab = (ids > 0) & (ids < table.shape[1])
    img = torch.where(in_vocab, ids, torch.zeros_like(ids)).long()  # [B, CI]
    total = table[:, img].sum(dim=-1).T  # [B, N]
    clamped = total.clamp(IMAGE_MIN, IMAGE_MAX)
    return _div(MAX_NODE_SCORE * (clamped - IMAGE_MIN), IMAGE_MAX - IMAGE_MIN)


def resource_limits(nodes: Arrays, pods: Arrays) -> torch.Tensor:
    """ResourceLimitsPriorityMap (resource_limits.go:36-88): 1 when the node
    can hold the pod's cpu OR memory limit (both nonzero), else 0."""
    lc = pods["limit_req"][:, 0][:, None]
    lm = pods["limit_req"][:, 1][:, None]
    ac = nodes["alloc"][:, 0][None, :]
    am = nodes["alloc"][:, 1][None, :]
    cpu_ok = (lc != 0) & (ac != 0) & (lc <= ac)
    mem_ok = (lm != 0) & (am != 0) & (lm <= am)
    return (cpu_ok | mem_ok).long()


# default shape prefers least-utilized nodes (requested_to_capacity_ratio.go:40)
DEFAULT_RTCR_SHAPE = ((0, 10), (100, 0))
DEFAULT_RTCR_RESOURCES = (("cpu", 1), ("memory", 1))
_RTCR_COLUMNS = {"cpu": 0, "memory": 1}


def _go_div(a: torch.Tensor, b) -> torch.Tensor:
    """Go integer division truncates toward zero."""
    q = _div(a.abs(), abs(b))
    return torch.where((a < 0) != (b < 0), -q, q)


def requested_to_capacity_ratio(
    nodes: Arrays, pods: Arrays, shape=DEFAULT_RTCR_SHAPE, resources=DEFAULT_RTCR_RESOURCES
) -> torch.Tensor:
    """RequestedToCapacityRatio (requested_to_capacity_ratio.go:115-167):
    per resource, utilization% through the broken-linear shape; resources
    scoring 0 leave the weighted mean, which rounds half away from zero."""

    def raw(p: torch.Tensor) -> torch.Tensor:
        out = torch.full_like(p, shape[-1][1])
        for i in range(len(shape) - 1, -1, -1):
            u, s = shape[i]
            if i == 0:
                val = torch.full_like(p, s)
            else:
                u0, s0 = shape[i - 1]
                val = s0 + _go_div((s - s0) * (p - u0), u - u0)
            out = torch.where(p <= u, val, out)
        return out

    node_score = torch.zeros((), dtype=torch.int64, device=nodes["alloc"].device)
    weight_sum = torch.zeros((), dtype=torch.int64, device=nodes["alloc"].device)
    for rname, weight in resources:
        col = _RTCR_COLUMNS[rname]
        cap = nodes["alloc"][:, col][None, :]
        req = nodes["nonzero_req"][:, col][None, :] + pods["scoring_req"][:, col][:, None]
        full = (cap == 0) | (req > cap)
        p = torch.where(full, torch.full_like(req, 100), 100 - _div((cap - req) * 100, cap.clamp(min=1)))
        s = raw(p)
        pos = s > 0
        node_score = node_score + torch.where(pos, s * weight, torch.zeros_like(s))
        weight_sum = weight_sum + torch.where(pos, torch.full_like(s, weight), torch.zeros_like(s))
    return torch.where(
        weight_sum > 0,
        _div(2 * node_score + weight_sum, (2 * weight_sum).clamp(min=1)),
        torch.zeros_like(node_score),
    )


# Policy/provider registration name → (kernel weight slot, plain function);
# the slot order is csrc/scores.cu's W_* order
PRIORITIES = {
    "LeastRequestedPriority": (0, least_requested),
    "MostRequestedPriority": (1, most_requested),
    "BalancedResourceAllocation": (2, balanced_allocation),
    "NodeAffinityPriority": (3, node_affinity),
    "TaintTolerationPriority": (4, taint_toleration),
    "NodePreferAvoidPodsPriority": (5, prefer_avoid_pods),
    "ImageLocalityPriority": (6, image_locality),
    "ResourceLimitsPriority": (7, resource_limits),
}
RTCR_NAME = "RequestedToCapacityRatioPriority"

# the default provider's weighted sum in registration-name form
# (algorithmprovider/defaults/defaults.go:128)
DEFAULT_PRIORITY_TUPLE = (
    ("LeastRequestedPriority", 1),
    ("BalancedResourceAllocation", 1),
    ("NodeAffinityPriority", 1),
    ("TaintTolerationPriority", 1),
    ("NodePreferAvoidPodsPriority", 10000),
    ("ImageLocalityPriority", 1),
)


def score_matrix_plain(
    nodes: Arrays, pods: Arrays, priorities=None, rtcr=None, bias: int = 0
) -> torch.Tensor:
    """Weighted sum of the enabled non-topology priorities → [B, N] int64,
    plus the constant `bias`; plain PyTorch. Names without a kernel here
    (the topology priorities) contribute nothing, as in the reference."""
    pairs = priorities if priorities is not None else DEFAULT_PRIORITY_TUPLE
    b, n = pods["valid"].shape[0], nodes["valid"].shape[0]
    total = torch.full((b, n), int(bias), dtype=torch.int64, device=nodes["valid"].device)
    for name, weight in pairs:
        if name == RTCR_NAME:
            shape, res = rtcr if rtcr is not None else (DEFAULT_RTCR_SHAPE, DEFAULT_RTCR_RESOURCES)
            total = total + weight * requested_to_capacity_ratio(nodes, pods, shape, res)
            continue
        entry = PRIORITIES.get(name)
        if entry is None:
            continue
        if name == "ImageLocalityPriority" and "image_scaled" not in nodes:
            continue
        total = total + weight * entry[1](nodes, pods)
    return total


def kernel_weights(priorities, has_images: bool):
    """The kernel's int64 weight vector (csrc/scores.cu W_* order) for a
    (name, weight) tuple, and the RequestedToCapacityRatio weight."""
    pairs = priorities if priorities is not None else DEFAULT_PRIORITY_TUPLE
    w = [0] * 8
    w_rtcr = 0
    for name, weight in pairs:
        if name == RTCR_NAME:
            w_rtcr += int(weight)
            continue
        entry = PRIORITIES.get(name)
        if entry is None or (name == "ImageLocalityPriority" and not has_images):
            continue
        w[entry[0]] += int(weight)
    return w, w_rtcr


# the argument struct's fixed room for the RTCR shape: validate_function_shape
# allows at most 101 strictly increasing utilizations in [0, 100]
RTCR_MAX_POINTS = 101
RTCR_MAX_RESOURCES = 8

# score_components' planes in the reference's dict order; the first six are
# csrc/scores.cu's W_* slots 0-5, image_locality slot 6
COMPONENTS = (
    ("least_requested", least_requested),
    ("most_requested", most_requested),
    ("balanced_allocation", balanced_allocation),
    ("node_affinity", node_affinity),
    ("taint_toleration", taint_toleration),
    ("prefer_avoid_pods", prefer_avoid_pods),
    ("image_locality", image_locality),
)


def score_components_plain(nodes: Arrays, pods: Arrays) -> Dict[str, torch.Tensor]:
    """Each default priority's [U, N] int64 score on its own (image
    locality only when the bank has an image table); plain PyTorch."""
    return {name: fn(nodes, pods) for name, fn in COMPONENTS
            if name != "image_locality" or "image_scaled" in nodes}


_NODE_PTRS = (
    ("valid", torch.bool), ("name_id", torch.int32), ("alloc", torch.int64),
    ("nonzero_req", torch.int64), ("label_vals", torch.int32), ("label_num", torch.int64),
    ("label_num_ok", torch.bool), ("taint_key", torch.int32), ("taint_val", torch.int32),
    ("taint_effect", torch.int32), ("avoid_kind", torch.int32), ("avoid_uid", torch.int32),
    ("image_scaled", torch.int64),
)
_POD_PTRS = (
    ("scoring_req", torch.int64), ("limit_req", torch.int64), ("pref_valid", torch.bool),
    ("pref_weight", torch.int32), ("pref_req_op", torch.int32), ("pref_req_slot", torch.int32),
    ("pref_req_vals", torch.int32), ("pref_req_num", torch.int64), ("tol_key", torch.int32),
    ("tol_op", torch.int32), ("tol_val", torch.int32), ("tol_effect", torch.int32),
    ("tol_valid", torch.bool), ("ctrl_kind", torch.int32), ("ctrl_uid", torch.int32),
    ("image_ids", torch.int32),
)
_DIMS = ("N", "U", "R", "K", "T", "TL", "PT", "REQS", "VALS", "AV", "CI", "V_img")


SCORE_ENTRY = "ktpu_score_matrix"


class ScoreArgs(ctypes.Structure):
    """Mirror of `struct ScoreArgs` in csrc/scores.cu."""

    _fields_ = (
        [("n_" + k, ctypes.c_void_p) for k, _ in _NODE_PTRS]
        + [("p_" + k, ctypes.c_void_p) for k, _ in _POD_PTRS]
        + [("out", ctypes.c_void_p), ("weights", ctypes.c_int64 * 8), ("bias", ctypes.c_int64)]
        + [("w_rtcr", ctypes.c_int64), ("rtcr_res_w", ctypes.c_int64 * RTCR_MAX_RESOURCES),
           ("rtcr_res_col", ctypes.c_int32 * RTCR_MAX_RESOURCES),
           ("rtcr_u", ctypes.c_int32 * RTCR_MAX_POINTS), ("rtcr_s", ctypes.c_int32 * RTCR_MAX_POINTS),
           ("rtcr_points", ctypes.c_int32), ("rtcr_res", ctypes.c_int32), ("n_components", ctypes.c_int32)]
        + [(d, ctypes.c_int32) for d in _DIMS]
    )


def _set_rtcr(args: ScoreArgs, rtcr) -> None:
    """Write the RTCR shape and resources into the struct (None = the
    default shape over cpu and memory). Raises on what its fixed room or
    the node bank's two scoring columns cannot hold."""
    shape, res = rtcr if rtcr is not None else (DEFAULT_RTCR_SHAPE, DEFAULT_RTCR_RESOURCES)
    if not 1 <= len(shape) <= RTCR_MAX_POINTS:
        raise ValueError(f"an RTCR shape has 1 to {RTCR_MAX_POINTS} points, got {len(shape)}")
    if len(res) > RTCR_MAX_RESOURCES:
        raise ValueError(f"at most {RTCR_MAX_RESOURCES} RTCR resources, got {len(res)}")
    for i, (u, sc) in enumerate(shape):
        args.rtcr_u[i], args.rtcr_s[i] = int(u), int(sc)
    for i, (rname, weight) in enumerate(res):
        if rname not in _RTCR_COLUMNS:
            raise ValueError(f"RTCR resource {rname!r} has no device column (cpu and memory only)")
        args.rtcr_res_col[i], args.rtcr_res_w[i] = _RTCR_COLUMNS[rname], int(weight)
    args.rtcr_points, args.rtcr_res = len(shape), len(res)


def score_args(nodes: Arrays, pods: Arrays, priorities=None, bias: int = 0, rtcr=None, n_components: int = 0):
    """The kernel's argument struct for these CUDA tensors, and the output
    it writes: the [U, N] int64 weighted sum, or with `n_components` > 0
    the [n_components, U, N] int64 planes. Validates device, dtype and
    contiguity."""
    has_images = "image_scaled" in nodes
    weights, w_rtcr = kernel_weights(priorities, has_images)
    n, r = nodes["alloc"].shape
    u = pods["valid"].shape[0]
    dims = dict(
        N=n, U=u, R=r, K=nodes["label_vals"].shape[1], T=nodes["taint_key"].shape[1],
        TL=pods["tol_key"].shape[1], PT=pods["pref_valid"].shape[1],
        REQS=pods["pref_req_op"].shape[2], VALS=pods["pref_req_vals"].shape[3],
        AV=nodes["avoid_kind"].shape[1], CI=pods["image_ids"].shape[1],
        V_img=nodes["image_scaled"].shape[1] if has_images else 0,
    )
    shape = (n_components, u, n) if n_components else (u, n)
    out = torch.empty(shape, dtype=torch.int64, device=nodes["valid"].device)
    args = ScoreArgs()
    for k, dt in _NODE_PTRS:
        if k == "image_scaled" and not has_images:
            continue  # weight 0: the kernel never reads it
        setattr(args, "n_" + k, build.ptr(nodes[k], dt))
    for k, dt in _POD_PTRS:
        setattr(args, "p_" + k, build.ptr(pods[k], dt))
    args.out = build.ptr(out, torch.int64, shape)
    for i, w in enumerate(weights):
        args.weights[i] = w
    args.bias = int(bias)
    args.n_components = int(n_components)
    if w_rtcr and not n_components:
        args.w_rtcr = w_rtcr
        _set_rtcr(args, rtcr)
    for d, v in dims.items():
        setattr(args, d, int(v))
    return args, out


def score_matrix(
    nodes: Arrays, pods: Arrays, priorities=None, rtcr=None, bias: int = 0
) -> torch.Tensor:
    """Weighted priority sum [U, N] int64 (None = default provider
    weights) plus `bias`; `rtcr` is the RequestedToCapacityRatio Policy
    argument (shape points, resource weights), None = its default. CPU
    tensors run the plain version; CUDA tensors launch csrc/scores.cu
    (counted in `score_matrix.launches`, and those scoring RTCR also in
    `score_matrix.rtcr_launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return score_matrix_plain(nodes, pods, priorities, rtcr, bias)
    if dev.type == "cuda":
        args, out = score_args(nodes, pods, priorities, bias, rtcr)
        build.launch(SCORE_ENTRY, args, dev)
        score_matrix.launches += 1
        if args.w_rtcr:
            score_matrix.rtcr_launches += 1
        return out
    raise ValueError(f"no score kernel for device {dev}")


score_matrix.launches = 0
score_matrix.rtcr_launches = 0


def score_components(nodes: Arrays, pods: Arrays) -> Dict[str, torch.Tensor]:
    """Each default priority's [U, N] int64 score on its own, as the
    reference's dict (image_locality only when the bank has an image
    table). CPU tensors run the plain version; CUDA tensors launch
    csrc/scores.cu once in its component mode, every plane a view of one
    [C, U, N] buffer (counted in `score_components.launches`)."""
    dev = nodes["valid"].device
    if dev.type == "cpu":
        return score_components_plain(nodes, pods)
    if dev.type == "cuda":
        names = [name for name, _ in COMPONENTS if name != "image_locality" or "image_scaled" in nodes]
        args, out = score_args(nodes, pods, n_components=len(names))
        build.launch(SCORE_ENTRY, args, dev)
        score_components.launches += 1
        return {name: out[c] for c, name in enumerate(names)}
    raise ValueError(f"no score kernel for device {dev}")


score_components.launches = 0
