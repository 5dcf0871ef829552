#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels (kubernetes_tpu_torch/csrc/*.cu)
with nvcc for sm_90a, holds each kernel against its plain PyTorch version
on the card (exact equality: every value is an integer, and the two
float64 paths truncate identically), then drives the port's main paths —
the batch Scheduler on the bench.py config-2 workload (5,000 nodes, 50,000
pods, NoSchedule taints with tolerations, required node affinity) and on
the config-3 workload (10,000 nodes in 8 zones, 100,000 pods in 100 apps,
one ScheduleAnyway zone spread constraint each; then the same behind one
Service per app, the SelectorSpread input), batches of 4,096 — and checks
what they placed. Phases:

  1. device     card name, count, power limit
  2. build      nvcc seconds and the -Xptxas -v register/shared lines
  3. kernels    each kernel == its plain version: filter (and its raw
                node-selector output), score and solve on a seeded cluster
                reaching every predicate/priority branch and at the config-2
                shapes (U=128, N=6144, B=4096); match_terms, spread_score and
                selector_spread_score on a seeded cluster reaching every
                topology branch and at the config-3 shapes (U=128, N=10240,
                TT=128 or 256, S=256, V=16); CUDA-event times of kernel and
                plain version, and each kernel's bound
  4. parity     config 2 and config 3 at 1/10 scale through Scheduler on
                cuda and on cpu (config 3 without Services deterministic,
                with Services under tie-noise): identical placements
  5. drain      config 2 at full size; then config 3 at full size, without
                and with Services: every pod placed, no node over its
                allocatable or pod limit, config 2's placements pass the
                taint/affinity checks, config 3's device signature bank
                equals a fresh host encode of the final cache; pods/s,
                stages, peak memory, per-app zone skew
  6. kernels    one JSON line: per kernel its launches in the drains (the
                counts are set to 0 before each drain and read after it),
                error, times and bound
  7. result     the last line: {"ok": true, "device": {...}}

Any failed phase exits non-zero before the result line. Without a CUDA
card, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# CUDA-core int32 issue rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (Hopper architecture white paper); the filter/score/solve work is integer
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float64 outside the tensor cores: 132 SMs x 64 FP64 lanes x 2 (FMA) x
# 1.98 GHz (H100 SXM data sheet: 67 TFLOP/s FP64 tensor core, 34 without);
# the SelectorSpread blend is the only float64 work
FP64_OPS_PER_S = 132 * 64 * 2 * 1.98e9

CONFIG2_NODES = 5000
CONFIG2_PODS = 50000
CONFIG3_NODES = 10000
CONFIG3_PODS = 100000
BATCH = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*dicts) -> int:
    return sum(int(t.numel() * t.element_size()) for d in dicts for t in d.values())


# ---------------------------------------------------------------------------
# the work a kernel's function needs on these inputs, for its bound: only
# live lanes (valid spec rows, valid non-fallback nodes, requirement lanes
# with an operator, value lanes >= 0, taints with an effect, ports > 0) and
# only the arrays a live branch reads; each byte read once, each output
# byte written once
# ---------------------------------------------------------------------------

OP_IN, OP_NOT_IN, OP_GT, OP_LT, OP_NAME_IN, OP_NAME_NOT_IN = 1, 2, 5, 6, 7, 8


def live_row_bytes(arrays, keys, live) -> int:
    """Bytes of the rows of `live` (a bool vector over axis 0) in each array."""
    n = int(live.sum())
    return sum(n * int(arrays[k][0].numel() * arrays[k].element_size()) for k in keys)


def requirement_work(op, slot, vals):
    """Live compiled requirements (op != OP_PAD) of some selector terms:
    (requirements, compared value lanes, label slots read, numeric label
    slots read, whether a name operator reads the node's name)."""
    live = op != 0
    set_op = live & (op <= OP_NOT_IN)
    lanes = int(((vals >= 0) & set_op[..., None]).sum())
    labelled = live & (op <= OP_LT) & (slot >= 0)
    numeric = labelled & ((op == OP_GT) | (op == OP_LT))
    named = live & ((op == OP_NAME_IN) | (op == OP_NAME_NOT_IN))
    return (int(live.sum()), lanes, set(slot[labelled].tolist()), set(slot[numeric].tolist()),
            bool(named.any()))


def filter_work(na, pa):
    """(bytes, integer operations) of csrc/filters.cu's function on these
    inputs, all predicates on. Every pair costs its validity test and its
    output byte; a live pair (valid spec, valid non-fallback node) costs
    the unschedulable, host-pin and pod-count tests, 2 per taint with an
    effect, 4 per (valid toleration, blocking taint or unschedulable
    flag), 3 per compared resource slot, 2 per selector pair, 4 per live
    requirement plus 1 per compared value lane, and 6 per (pod port,
    node port) pair."""
    from kubernetes_tpu_torch.ops import filters as F

    live_u = pa["valid"]
    live_n = na["valid"] & ~na["fallback"]
    u, n = live_u.numel(), live_n.numel()
    nu, nn = int(live_u.sum()), int(live_n.sum())
    eff = na["taint_effect"][live_n]
    taints = int((eff != 0).sum())
    blocking = int(((eff == 1) | (eff == 3)).sum()) + int(na["unschedulable"][live_n].sum())
    tols = int(pa["tol_valid"][live_u].sum())
    req, req_any = pa["req"][live_u], pa["req_any"][live_u]
    scalar = (req[:, 3:] > 0) & req_any[:, None]
    res_slots = 3 * int(req_any.sum()) + int(scalar.sum())
    sel = pa["sel_pair_slot"][live_u]
    terms = pa["term_valid"] & (pa["has_required"] & live_u)[:, None]
    n_req, lanes, slots, numeric, named = requirement_work(
        pa["term_req_op"][terms], pa["term_req_slot"][terms], pa["term_req_vals"][terms])
    slots |= set(sel[sel >= 0].tolist())
    pinned = bool((pa["node_name_id"][live_u] != 0).any())
    pod_ports = int((pa["port_num"][live_u] > 0).sum())
    node_ports = int((na["port_num"][live_n] > 0).sum())
    ops = (
        2 * u * n
        + 5 * nu * nn
        + 2 * nu * taints
        + 4 * tols * blocking
        + 3 * res_slots * nn
        + 2 * int((sel >= 0).sum()) * nn
        + (4 * n_req + lanes) * nn
        + 6 * pod_ports * node_ports
    )
    scalar_cols = int(scalar.any(dim=0).sum())
    nbytes_ = (
        2 * n                                    # valid, fallback
        + nn * (4 + 4 + 1)                       # pod_count, allowed_pods, unschedulable
        + (nn * 4 if pinned or named else 0)     # name_id
        + (nn * 16 * (3 + scalar_cols) if int(req_any.sum()) else 0)  # alloc, requested
        + taints * 12                            # taint key/val/effect
        + nn * 4 * len(slots) + nn * 9 * len(numeric)  # label_vals; label_num(+ok)
        + (node_ports * 12 if pod_ports else 0)  # node port num/proto/ip
        + live_row_bytes(pa, [k for k, _ in F._POD_PTRS], live_u)
        + u * n                                  # the mask
    )
    return nbytes_, ops


def score_work(na, pa):
    """(bytes, integer operations) of csrc/scores.cu's function on these
    inputs under the default priority tuple. A pair of a valid spec and a
    valid node costs the arithmetic of each weighted priority (least
    requested 19, balanced allocation 14, the two normalizations 8 each,
    avoid 4 + 3 per avoid entry, image 8 + 3 per image, limits 10, bias
    and store 2), 4 per live preferred-term requirement plus 1 per
    compared value lane, 1 per taint with an effect and 4 per (eligible
    toleration, PreferNoSchedule taint)."""
    from kubernetes_tpu_torch.ops import scores as S

    has_images = "image_scaled" in na
    w = S.kernel_weights(None, has_images)
    live_u, live_n = pa["valid"], na["valid"]
    u, n = live_u.numel(), live_n.numel()
    nu, nn = int(live_u.sum()), int(live_n.sum())
    eff = na["taint_effect"][live_n]
    taints, prefer = int((eff != 0).sum()), int((eff == 2).sum())
    tol_eff = pa["tol_effect"][live_u]
    tols = int((pa["tol_valid"][live_u] & ((tol_eff == 0) | (tol_eff == 2))).sum())
    terms = pa["pref_valid"] & live_u[:, None]
    n_req, lanes, slots, numeric, named = requirement_work(
        pa["pref_req_op"][terms], pa["pref_req_slot"][terms], pa["pref_req_vals"][terms])
    avoid = int((na["avoid_kind"][live_n] != 0).sum())
    ids = pa["image_ids"][live_u]
    v_img = na["image_scaled"].shape[1] if has_images else 0
    images = ids[(ids > 0) & (ids < v_img)]
    per_pair = 2 + 19 * (w[0] != 0) + 19 * (w[1] != 0) + 14 * (w[2] != 0) + 8 * (w[3] != 0) \
        + 8 * (w[4] != 0) + 4 * (w[5] != 0) + 8 * (w[6] != 0) + 10 * (w[7] != 0)
    ops = (
        per_pair * nu * nn
        + ((4 * n_req + lanes) * nn if w[3] else 0)
        + (nu * taints + 4 * tols * prefer if w[4] else 0)
        + (3 * avoid * nu if w[5] else 0)
        + (3 * int(images.numel()) * nn if w[6] else 0)
    )
    nbytes_ = (
        n                                        # valid
        + nn * (16 + 16)                         # alloc cpu/mem, nonzero_req
        + (nn * 4 if named and w[3] else 0)      # name_id
        + ((nn * 4 * len(slots) + nn * 9 * len(numeric)) if w[3] else 0)
        + (taints * 4 + prefer * 8 if w[4] else 0)  # effect; key/val of PreferNoSchedule
        + (avoid * 8 if w[5] else 0)             # avoid kind/uid
        + (nn * 8 * len(set(images.tolist())) if w[6] else 0)  # image_scaled columns
        + live_row_bytes(pa, [k for k, _ in S._POD_PTRS], live_u)
        + u * n * 8                              # the score matrix
    )
    return nbytes_, ops


def solve_work(mask, sig, pod_valid, pa, free0, count0, allowed, nz0, order):
    """(bytes, integer operations) of csrc/solver.cu's function: per valid
    pod a mask test on every node, and for each node its spec's mask
    admits the pod-count and resource tests, the tie-break hash and the
    compare; the mask and score rows of the specs valid pods use, each
    read once, the carry read and written once."""
    n = mask.shape[1]
    r = pa["req"].shape[1]
    sigs = sig.long()[pod_valid]
    admitted = float(mask.sum(dim=1).double()[sigs].sum())
    ops = float(pod_valid.sum()) * n + admitted * (3 + r + 12)
    rows = int(torch.unique(sigs).numel())
    nbytes_ = (rows * n * (1 + 8)
               + nbytes({"a": pa["req"], "b": pa["req_any"], "c": pa["scoring_req"], "d": allowed,
                         "e": order, "f": sig, "g": pod_valid})
               + 2 * nbytes({"a": free0, "b": count0, "c": nz0}) + sig.numel() * 4)
    return nbytes_, ops


def topology_work(kernel, na, ea, ta, au, m_sig_soft=None, m_sig_ns=None):
    """(bytes, integer operations, float64 operations) of one topology
    kernel's function on these inputs, over live lanes: valid terms of the
    kernel's kinds, valid signatures, valid nodes, spec rows owning such
    terms, selector lanes in use.
      match_terms     per (live term, valid signature): 2 per matchLabels
                      pair with a slot, 3 + 1 per value lane per expression
                      with an operator, 1 per namespace lane when tested;
                      reads the live term rows, the label slots they name
                      of every valid signature (and its namespace), writes
                      the [TT, S] bytes
      spread_score    per soft term: per valid node 1 add per matched
                      signature and 6 for the bucket; per spec row with
                      soft terms, per valid node 6 per term (gather) and 8
                      (total, min, score); reads the matched signatures'
                      counts columns, the dense label column of each soft
                      slot, the owners' selector rows, writes [U, N] int64
      selector_spread per spec row with selectors, per valid node 1 add per
                      matched signature, 4 (max, zone) and 6 float64 (the
                      blend); reads the matched signatures' counts columns,
                      zone_dense, writes [U, N] int64"""
    from kubernetes_tpu_torch.state.terms import SEL_SPREAD, SPREAD_SOFT

    n = na["valid"].shape[0]
    nn = int(na["valid"].sum())
    s_live = ea["valid"]
    ns_live = int(s_live.sum())
    u = au["n_sel_spread"].shape[0]
    tv = ta["valid"]
    if kernel == "match_terms":
        live = tv
        tt = int(live.sum())
        ml = int((ta["ml_slot"][live] >= 0).sum())
        ex_live = ta["ex_op"][live] != 0
        ex = int(ex_live.sum())
        lanes = int(((ta["ex_vals"][live] >= 0) & ex_live[..., None]).sum())
        slots = set(ta["ml_slot"][live][ta["ml_slot"][live] >= 0].tolist()) | \
            set(ta["ex_slot"][live][ex_live].tolist())
        ops = ns_live * (2 * ml + 3 * ex + lanes + tt * (2 + ta["ns_ids"].shape[1]))
        row_bytes = sum(int(v[0].numel() * v.element_size()) for k, v in ta.items()
                        if k in ("valid", "has_selector", "ml_slot", "ml_val", "ex_op", "ex_slot",
                                 "ex_vals", "ns_any", "ns_ids"))
        nbytes_ = tt * row_bytes + ns_live * (4 * len(slots) + 4) + ta["valid"].shape[0] * s_live.shape[0]
        return nbytes_, ops, 0
    if kernel == "spread_score":
        soft = tv & (ta["kind"] == SPREAD_SOFT)
        m = m_sig_soft[soft] & s_live[None, :]
        matched = int(m.sum())
        sigs = int(m.any(dim=0).sum())
        slots = len(set(ta["topo_slot"][soft].tolist()))
        owners = set(ta["owner"][soft].tolist())
        n_soft = int(soft.sum())
        ops = nn * (matched + 6 * n_soft) + nn * (6 * n_soft + 8 * len(owners))
        nbytes_ = (nn * 2 * sigs + nn * 4 * slots + len(owners) * n + n
                   + n_soft * ea["valid"].shape[0] + u * n * 8)
        return nbytes_, ops, 0
    ss = tv & (ta["kind"] == SEL_SPREAD)
    rows = set(ta["owner"][ss].tolist())
    # the signatures each selector row matches (AND over its terms)
    matched, sigs = 0, set()
    for r in rows:
        mine = ss & (ta["owner"] == r)
        mr = m_sig_ns[mine].all(dim=0) & s_live & ~ea["deleting"]
        matched += int(mr.sum())
        sigs |= set(torch.nonzero(mr).flatten().tolist())
    ops = nn * (matched + 4 * len(rows))
    nbytes_ = nn * 2 * len(sigs) + n * 5 + int(ss.sum()) * ea["valid"].shape[0] + u * n * 8
    return nbytes_, ops, 6 * nn * len(rows)


def bound(work):
    nbytes_, ops = work[:2]
    f64 = work[2] if len(work) > 2 else 0
    t_bytes = nbytes_ / H100_BYTES_PER_S * 1e3
    t_ops = (ops / INT32_OPS_PER_S + f64 / FP64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ).stdout.strip()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from kubernetes_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    rep = build.build_report()
    log(f"[build] {time.perf_counter() - t0:.2f}s (nvcc {rep['seconds']:.2f}s, cached={rep['cached']})")
    for line in rep["ptxas"]:
        log(f"[build] {line}")


def compare_kernels(na, pa, ids, sig, label, time_it: bool):
    """Hold each kernel against its plain version on the same CUDA tensors.
    Returns {kernel: stats} (errors, and times when time_it)."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import scores as S
    from kubernetes_tpu_torch.ops import solver as SO

    out = {}
    # --- filter, under every predicate subset the Policy names can form
    subsets = [None, frozenset({"GeneralPredicates"}), frozenset({"PodToleratesNodeTaints", "CheckNodeUnschedulable"}),
               frozenset({"MatchNodeSelector"}), frozenset({"PodFitsHostPorts", "PodFitsResources"})]
    mismatched = 0
    for preds in subsets:
        k = F.combined_mask(na, pa, ids, preds)
        p = F.combined_mask_plain(na, pa, ids, preds)
        mismatched += int((k != p).sum())
    check(mismatched == 0, f"[{label}] filter kernel differs from its plain version in {mismatched} pairs")
    mask = F.combined_mask(na, pa, ids)
    # booleans: the largest |kernel - plain| is 1 if any pair differs
    out["filter_mask"] = {"max_abs_err": min(mismatched, 1), "feasible": int(mask.sum())}
    if time_it:
        # the kernel alone: relaunch one prebuilt argument struct, so the
        # wrapper's host-side struct building does not pace the device
        args, _, _ = F.filter_args(na, pa, ids)
        out["filter_mask"]["ms"] = cuda_ms(lambda: build.launch(F.FILTER_ENTRY, args, na["valid"].device), 200)
        out["filter_mask"]["wrapper_ms"] = cuda_ms(lambda: F.combined_mask(na, pa, ids), 200)
        out["filter_mask"]["plain_ms"] = cuda_ms(lambda: F.combined_mask_plain(na, pa, ids), 3)
        out["filter_mask"]["bound"] = bound(filter_work(na, pa))

    # --- score, under the default tuple and Policy weightings
    weightings = [
        None,
        (("MostRequestedPriority", 2), ("ResourceLimitsPriority", 3), ("NodeAffinityPriority", 5)),
        tuple((name, i + 1) for i, name in enumerate(S.PRIORITIES)),
    ]
    err = 0
    for pr in weightings:
        k = S.score_matrix(na, pa, pr, bias=10)
        p = S.score_matrix_plain(na, pa, pr, bias=10)
        err = max(err, int((k - p).abs().max()))
    check(err == 0, f"[{label}] score kernel differs from its plain version by {err}")
    score = S.score_matrix(na, pa, bias=10)
    out["score_matrix"] = {"max_abs_err": err}
    if time_it:
        args, _ = S.score_args(na, pa, bias=10)
        out["score_matrix"]["ms"] = cuda_ms(lambda: build.launch(S.SCORE_ENTRY, args, na["valid"].device), 200)
        out["score_matrix"]["wrapper_ms"] = cuda_ms(lambda: S.score_matrix(na, pa, bias=10), 200)
        out["score_matrix"]["plain_ms"] = cuda_ms(lambda: S.score_matrix_plain(na, pa, bias=10), 3)
        out["score_matrix"]["bound"] = bound(score_work(na, pa))

    # --- solve, deterministic and with tie-noise, on that mask and score
    b = sig.shape[0]
    pod_valid = torch.ones(b, dtype=torch.bool, device=sig.device)
    pod_valid[b - max(1, b // 16):] = False  # padded tail rows
    prio = (torch.arange(b, device=sig.device) % 3).to(torch.int32)
    order = SO.pop_order(prio, torch.arange(b, dtype=torch.int32, device=sig.device), pod_valid)
    free0 = na["alloc"] - na["requested"]
    count0 = na["pod_count"].long()
    allowed = na["allowed_pods"].long()
    nz0 = na["nonzero_req"]
    args = (mask, score, pa["req"], free0, count0, allowed, order)
    err = 0
    placed = 0
    for det in (True, False):
        key = SO.prng_key_data(7)
        kw = dict(deterministic=det, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid,
                  return_carry=True, nz0=nz0, scoring_req=pa["scoring_req"])
        ka, kc = SO.solve_greedy(*args, key, **kw)
        pa_, pc = SO.solve_greedy_plain(*args, key, **kw)
        err = max(err, int((ka - pa_).abs().max()), *(int((x - y).abs().max()) for x, y in zip(kc, pc)))
        placed = int((ka >= 0).sum())
    check(err == 0, f"[{label}] solve kernel differs from its plain version by {err}")
    out["solve_greedy"] = {"max_abs_err": err, "placed": placed}
    if time_it:
        kw = dict(deterministic=False, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid,
                  return_carry=True, nz0=nz0, scoring_req=pa["scoring_req"])
        key = SO.prng_key_data(7)
        # tens of ms per launch: the wrapper's host work is hidden behind it
        out["solve_greedy"]["ms"] = cuda_ms(lambda: SO.solve_greedy(*args, key, **kw), 5)
        out["solve_greedy"]["wrapper_ms"] = out["solve_greedy"]["ms"]
        out["solve_greedy"]["plain_ms"] = cuda_ms(lambda: SO.solve_greedy_plain(*args, key, **kw), 2)
        out["solve_greedy"]["bound"] = bound(
            solve_work(mask, sig, pod_valid, pa, free0, count0, allowed, nz0, order))
    log(f"[kernels] {label}: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} B={b}: "
        f"filter/score/solve exact ({out['filter_mask']['feasible']} feasible pairs, {placed} placed)")
    return out


def encode(nodes, existing, pods, device, selectors_fn=None):
    """Port encoding of (cluster, pending pods) as the driver builds a
    batch: node and signature banks, spec rows (deduped with the pods'
    selectors) and each pod's row (`sig`), the batch term bank and its
    aux, the interned constants and n_buckets (the dense sizes of the term
    slots and the zone count, bucketed)."""
    from kubernetes_tpu_torch.models.clusters import fill_cache
    from kubernetes_tpu_torch.ops.filters import make_ids
    from kubernetes_tpu_torch.state.cache import SchedulerCache, TensorMirror
    from kubernetes_tpu_torch.state.convert import arrays_to_torch
    from kubernetes_tpu_torch.state.tensors import PodBatch, dedup_specs, pow2_bucket
    from kubernetes_tpu_torch.state.terms import compile_batch_terms

    # the driver's banks (and so its shapes: S starts at 256 signatures)
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    mirror = TensorMirror(cache, device)
    vocab = mirror.vocab
    sel = {id(p): selectors_fn(p) for p in pods} if selectors_fn else None
    reps, sig = dedup_specs(pods, sel)
    u = pow2_bucket(len(reps))
    batch = PodBatch(vocab, u)
    for i, p in enumerate(reps):
        batch.set_pod(i, p)
    tb, aux = compile_batch_terms(vocab, reps, spread_selectors=sel, b_capacity=u)
    slots = set(tb.topo_slot[tb.valid].tolist())
    v = pow2_bucket(max([vocab.dense_size(int(x)) for x in slots if x >= 0] + [vocab.zone_count(), 1]))
    na, ea = mirror.device_arrays()
    t = lambda d: arrays_to_torch(d, device)  # noqa: E731
    return {"na": na, "ea": ea, "ta": t(tb.arrays()), "au": t(aux), "pa": t(batch.arrays()),
            "ids": make_ids(vocab), "v": v, "sig": torch.tensor(sig, dtype=torch.int32, device=device)}


def compare_topology(enc, label, time_it: bool):
    """Hold the filter's raw-selector output and the three topology kernels
    against their plain versions on the same CUDA tensors; with time_it,
    time each (kernel alone: one prebuilt struct relaunched) and bound it.
    Extra segment-axis widths reach the dropped-bucket and device-memory
    table branches."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import topology as TO

    na, ea, ta, au, pa, ids, v = (enc[k] for k in ("na", "ea", "ta", "au", "pa", "ids", "v"))
    dev = na["valid"].device
    mask, sel = F.combined_mask(na, pa, ids, with_selector=True)
    bad = int((mask != F.combined_mask_plain(na, pa, ids)).sum()) + \
        int((sel != F.pod_match_node_selector(na, pa)).sum())
    check(bad == 0, f"[{label}] filter kernel's raw selector output differs in {bad} pairs")
    out = {}
    mismatched = 0
    for ns in (None, ea["ns_id"]):
        mismatched += int((TO.match_terms(ta, ea["label_vals"], ns)
                           != TO.match_terms_plain(ta, ea["label_vals"], ns)).sum())
    check(mismatched == 0, f"[{label}] match_terms kernel differs from its plain version in {mismatched} pairs")
    out["match_terms"] = {"max_abs_err": min(mismatched, 1)}
    err_s = err_z = 0
    for nb in sorted({v, 16, 40000}):
        a = TO.spread_score(na, ea, ta, au, sel, n_buckets=nb)
        b = TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=nb)
        err_s = max(err_s, int((a - b).abs().max()))
        a = TO.selector_spread_score(na, ea, ta, au, n_buckets=nb)
        b = TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=nb)
        err_z = max(err_z, int((a - b).abs().max()))
    check(err_s == 0, f"[{label}] spread_score kernel differs from its plain version by {err_s}")
    check(err_z == 0, f"[{label}] selector_spread_score kernel differs from its plain version by {err_z}")
    out["spread_score"] = {"max_abs_err": err_s}
    out["selector_spread_score"] = {"max_abs_err": err_z}
    spread = TO.spread_score(na, ea, ta, au, sel, n_buckets=v)
    zsel = TO.selector_spread_score(na, ea, ta, au, n_buckets=v)
    log(f"[kernels] {label}: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} TT={ta['valid'].shape[0]} "
        f"S={ea['valid'].shape[0]} V={v}: raw selector, match_terms, spread_score, selector_spread_score "
        f"exact (spread sum {int(spread.sum())}, selector-spread sum {int(zsel.sum())})")
    if time_it:
        m_soft = TO.match_terms(ta, ea["label_vals"], None)
        m_ns = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
        margs, _ = TO.match_args(ta, ea["label_vals"], ea["ns_id"])
        out["match_terms"]["ms"] = cuda_ms(lambda: build.launch(TO.MATCH_ENTRY, margs, dev), 200)
        out["match_terms"]["plain_ms"] = cuda_ms(
            lambda: TO.match_terms_plain(ta, ea["label_vals"], ea["ns_id"]), 5)
        out["match_terms"]["bound"] = bound(topology_work("match_terms", na, ea, ta, au))
        sargs, _ = TO.spread_args(na, ea, ta, m_soft, sel, v)
        out["spread_score"]["ms"] = cuda_ms(lambda: build.launch(TO.SPREAD_ENTRY, sargs, dev), 200)
        out["spread_score"]["plain_ms"] = cuda_ms(
            lambda: TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=v), 5)
        out["spread_score"]["bound"] = bound(topology_work("spread_score", na, ea, ta, au, m_sig_soft=m_soft))
        zargs, _ = TO.selector_spread_args(na, ea, ta, au, m_ns, v)
        out["selector_spread_score"]["ms"] = cuda_ms(lambda: build.launch(TO.SEL_SPREAD_ENTRY, zargs, dev), 200)
        out["selector_spread_score"]["plain_ms"] = cuda_ms(
            lambda: TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=v), 5)
        out["selector_spread_score"]["bound"] = bound(
            topology_work("selector_spread_score", na, ea, ta, au, m_sig_ns=m_ns))
        for name in ("match_terms", "spread_score", "selector_spread_score"):
            st = out[name]
            log(f"[kernels] {label} {name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
                f"bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    return out


def config3_batch(services: bool, n_existing: int):
    """The config-3 shapes mid-drain: the full cluster holding `n_existing`
    bound pods (round-robin over the nodes) and the next 4,096-pod batch."""
    from kubernetes_tpu_torch.models.clusters import bench_config3

    nodes, pods, fn = bench_config3(CONFIG3_NODES, n_existing + BATCH, services=services)
    existing = [p.with_node(nodes[i % len(nodes)].name) for i, p in enumerate(pods[:n_existing])]
    return nodes, existing, pods[n_existing:], fn


def phase_kernels():
    from kubernetes_tpu_torch.models.clusters import bench_config2, random_cluster, random_selectors

    dev = torch.device("cuda")
    # the all-branches cluster: every operator, effect, pin, port, image,
    # preferAvoidPods, extended resource, and encoding-overflow nodes
    nodes, existing, pods = random_cluster(11, 900, 1000, 1500, overflow_nodes=12, pending_ports=True)
    e = encode(nodes, existing, pods, dev)
    compare_kernels(e["na"], e["pa"], e["ids"], e["sig"], "all-branches", time_it=False)
    # the all-branches topology cluster: zone / hostname (V > 64) / rack
    # keys, nodes without a key, fallback nodes, every selector kind, two
    # constraints on one key, namespaces, deleting pods, 0-2 selectors
    nodes, existing, pods = random_cluster(12, 700, 600, 2500, overflow_nodes=8, topology=True)
    compare_topology(encode(nodes, existing, pods, dev, random_selectors()), "topology all-branches",
                     time_it=False)
    # the config-2 shapes: the first batch of the full drain (its 100
    # distinct pod specs bucket to U=128 spec rows; 5,000 nodes to N=6144)
    nodes, pods = bench_config2(CONFIG2_NODES, BATCH)
    e = encode(nodes, [], pods, dev)
    stats = compare_kernels(e["na"], e["pa"], e["ids"], e["sig"], "config-2", time_it=True)
    for name, s in stats.items():
        log(f"[kernels] {name}: kernel {s['ms']:.4f} ms (through its wrapper {s['wrapper_ms']:.4f} ms), "
            f"plain {s['plain_ms']:.4f} ms, bound {s['bound'][0]:.4f} ms ({s['bound'][1]})")
    # the config-3 shapes mid-drain (50,000 pods bound), with and without
    # Services; the timed shapes are those with Services (every kernel runs)
    for services in (False, True):
        nodes, existing, pods, fn = config3_batch(services, CONFIG3_PODS // 2)
        enc = encode(nodes, existing, pods, dev, fn)
        label = "config-3" + (" + Services" if services else "")
        topo = compare_topology(enc, label, time_it=services)
    stats.update(topo)
    return stats


def kernel_fns():
    """Kernel name -> its wrapper (each counts its launches)."""
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import scores as S
    from kubernetes_tpu_torch.ops import solver as SO
    from kubernetes_tpu_torch.ops import topology as TO

    return {
        "filter_mask": F.combined_mask, "score_matrix": S.score_matrix, "solve_greedy": SO.solve_greedy,
        "match_terms": TO.match_terms, "spread_score": TO.spread_score,
        "selector_spread_score": TO.selector_spread_score,
    }


def drain(device, workload, n_nodes, n_pods, batch, deterministic, seed=0, services=False):
    from kubernetes_tpu_torch.models.clusters import bench_config2, bench_config3, fill_cache
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    fn = None
    if workload == "config2":
        nodes, pods = bench_config2(n_nodes, n_pods)
    else:
        nodes, pods, fn = bench_config3(n_nodes, n_pods, services=services)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes)
    for p in pods:
        queue.add(p)
    sched = Scheduler(cache, queue, batch_size=batch, deterministic=deterministic, seed=seed, device=device)
    if fn is not None:
        sched.set_spread_selectors_fn(fn)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.run_until_empty()
    sched.wait_for_binds()
    wall = time.perf_counter() - t0
    sched.close()
    return sched, nodes, pods, res, wall


def phase_parity():
    runs = [("config2", CONFIG2_NODES // 10, CONFIG2_PODS // 10, det, False) for det in (True, False)]
    # config 3: without Services deterministic, with Services under tie-noise
    runs += [("config3", CONFIG3_NODES // 10, CONFIG3_PODS // 10, True, False),
             ("config3", CONFIG3_NODES // 10, CONFIG3_PODS // 10, False, True)]
    batch = 1024
    for workload, n_nodes, n_pods, det, services in runs:
        _, _, _, gpu, tg = drain("cuda", workload, n_nodes, n_pods, batch, det, seed=3, services=services)
        _, _, _, cpu, tc = drain("cpu", workload, n_nodes, n_pods, batch, det, seed=3, services=services)
        check(gpu.scheduled == cpu.scheduled == n_pods, f"parity drain placed {gpu.scheduled}/{cpu.scheduled}")
        diff = sum(1 for k, v in cpu.assignments.items() if gpu.assignments.get(k) != v)
        check(diff == 0 and len(gpu.assignments) == len(cpu.assignments),
              f"parity drain ({workload}, deterministic={det}, services={services}): "
              f"{diff} pods placed differently on cuda and cpu")
        log(f"[parity] {workload} /10 ({n_nodes} nodes, {n_pods} pods, batch {batch}), deterministic={det}"
            f"{', Services' if services else ''}: identical placements ({gpu.scheduled} pods; "
            f"cuda {tg:.2f}s, cpu {tc:.2f}s)")


def verify_capacity(sched, pods, res):
    """Every pod placed, and no node over its allocatable or pod limit."""
    check(res.scheduled == len(pods) and len(res.assignments) == len(pods),
          f"drain placed {res.scheduled} of {len(pods)} pods")
    mirror = sched.mirror
    mirror.sync()
    bank = mirror.nodes
    valid = bank.valid
    check(bool((bank.requested[valid] <= bank.alloc[valid]).all()), "a node's requests exceed its allocatable")
    check(bool((bank.pod_count[valid] <= bank.allowed_pods[valid]).all()), "a node holds more pods than allowed")
    check(int(bank.pod_count[valid].sum()) == len(pods), "the node bank does not count every placed pod")


def verify_drain(sched, nodes, pods, res, device):
    """Capacity, pod count, taint and affinity of every placement."""
    from kubernetes_tpu_torch.api.selectors import node_matches_node_selector
    from kubernetes_tpu_torch.api.types import tolerations_tolerate_taint
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.state.convert import arrays_to_torch
    from kubernetes_tpu_torch.state.tensors import PodBatch, dedup_specs

    verify_capacity(sched, pods, res)
    mirror = sched.mirror
    bank = mirror.nodes
    # the plain filter's taint/affinity predicates, per spec row, on the final bank
    reps, sig = dedup_specs(pods)
    batch = PodBatch(mirror.vocab, 256)
    for i, p in enumerate(reps):
        batch.set_pod(i, p)
    na = arrays_to_torch(bank.arrays(), device)
    pa = arrays_to_torch(batch.arrays(), device)
    preds = frozenset({"CheckNodeUnschedulable", "HostName", "MatchNodeSelector", "PodToleratesNodeTaints"})
    mask = F.combined_mask_plain(na, pa, F.make_ids(mirror.vocab), preds).cpu().numpy()
    node_of = {n.name: n for n in nodes}
    bad = 0
    for p, s in zip(pods, sig):
        name = res.assignments[p.key()]
        node = node_of[name]
        ok = bool(mask[s, mirror.row_of[name]])
        ok &= all(tolerations_tolerate_taint(p.tolerations, t) for t in node.taints if t.effect == "NoSchedule")
        ok &= node_matches_node_selector(p.affinity.node_affinity.required, node.labels, node.name)
        bad += not ok
    check(bad == 0, f"{bad} placements violate a taint or the required node affinity")


def verify_sig_bank(sched):
    """The device signature bank, patched incrementally through the drain,
    equals a fresh host encode of the final cache: per signature content
    (label row, namespace, deleting) the same per-node counts, and no other
    valid signature."""
    from kubernetes_tpu_torch.state.tensors import encode_snapshot

    mirror = sched.mirror
    _, dev = mirror.device_arrays()
    dev = {k: v.cpu().numpy() for k, v in dev.items()}
    _, fresh, rows = encode_snapshot(sched.cache.snapshot, vocab=mirror.vocab)
    check(rows == mirror.row_of, "the fresh encode numbers the node rows differently")
    fresh = fresh.arrays()

    def by_content(e):
        out = {}
        for s in e["valid"].nonzero()[0]:
            key = (e["label_vals"][s].tobytes(), int(e["ns_id"][s]), bool(e["deleting"][s]))
            out[key] = e["counts"][:, s]
        return out

    got, want = by_content(dev), by_content(fresh)
    check(got.keys() == want.keys(), f"device signature bank holds {len(got)} signatures, a fresh encode {len(want)}")
    bad = sum(int((got[k] != want[k]).sum()) for k in want)
    check(bad == 0, f"device signature counts differ from a fresh encode in {bad} (node, signature) cells")
    return len(want)


def zone_skew(nodes, pods, res):
    """Max over apps of (most - fewest) pods per zone (information only:
    ScheduleAnyway spreads by score, it gates nothing)."""
    from collections import Counter

    from kubernetes_tpu_torch.models.clusters import ZONE_KEY

    zone_of = {n.name: n.labels[ZONE_KEY] for n in nodes}
    zones = sorted(set(zone_of.values()))
    per = Counter((p.labels["app"], zone_of[res.assignments[p.key()]]) for p in pods)
    apps = sorted({p.labels["app"] for p in pods})
    return max(max(per[(a, z)] for z in zones) - min(per[(a, z)] for z in zones) for a in apps)


def run_main_path(label, names, run):
    """Drive one main path with every kernel count set to 0 just before it;
    read the counts of `names` just after and require each > 0."""
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    out = run()
    launches = {name: fns[name].launches for name in fns}
    for name in names:
        check(launches[name] > 0, f"kernel {name} was not launched by the {label} drain")
    return out, launches


def log_drain(label, sched, res, wall, smi):
    st = sched.stats
    log(f"[drain] {label}: {res.scheduled} scheduled, 0 violations; {res.scheduled / wall:.1f} pods/s "
        f"({wall:.3f}s wall, {st['batches']} batches); sync {st['sync_s']:.3f}s encode {st['encode_s']:.3f}s "
        f"solve {st['solve_s']:.3f}s commit {st['commit_s']:.3f}s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; card {smi}")


def phase_drain(smi):
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    torch.cuda.reset_peak_memory_stats()
    (sched, nodes, pods, res, wall), launches = run_main_path(
        "config-2", ("filter_mask", "score_matrix", "solve_greedy"),
        lambda: drain("cuda", "config2", CONFIG2_NODES, CONFIG2_PODS, BATCH, deterministic=False))
    add(launches)
    verify_drain(sched, nodes, pods, res, "cuda")
    log_drain(f"config-2 full ({CONFIG2_NODES} nodes, {CONFIG2_PODS} pods, batch {BATCH})", sched, res, wall, smi)
    log(f"[drain] config-2 launches {launches}")
    for services in (False, True):
        label = "config-3" + (" + Services" if services else "")
        need = ["filter_mask", "score_matrix", "solve_greedy", "match_terms", "spread_score"]
        if services:
            need.append("selector_spread_score")
        torch.cuda.reset_peak_memory_stats()
        (sched, nodes, pods, res, wall), launches = run_main_path(label, need, lambda: drain(
            "cuda", "config3", CONFIG3_NODES, CONFIG3_PODS, BATCH, deterministic=False, services=services))
        add(launches)
        verify_capacity(sched, pods, res)
        n_sigs = verify_sig_bank(sched)
        log_drain(f"{label} full ({CONFIG3_NODES} nodes, {CONFIG3_PODS} pods, batch {BATCH})",
                  sched, res, wall, smi)
        log(f"[drain] {label}: device signature bank == fresh host encode ({n_sigs} signatures); "
            f"term kinds {sorted(sched._term_kinds)}, V={sched._v_bucket}, TT={sched._t_bucket}; "
            f"per-app max zone skew {zone_skew(nodes, pods, res)} (information only); launches {launches}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        import kubernetes_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name, count, smi = phase_device()
    phase_build()
    stats = phase_kernels()
    phase_parity()
    launches = phase_drain(smi)
    sources = {
        "filter_mask": ("kubernetes_tpu_torch/csrc/filters.cu", "kubernetes_tpu/ops/filters.py:216"),
        "score_matrix": ("kubernetes_tpu_torch/csrc/scores.cu", "kubernetes_tpu/ops/scores.py:262"),
        "solve_greedy": ("kubernetes_tpu_torch/csrc/solver.cu", "kubernetes_tpu/ops/solver.py:90"),
        "match_terms": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:49"),
        "spread_score": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:227"),
        "selector_spread_score": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:433"),
    }
    kernels = []
    for kname, (src, ref) in sources.items():
        s = stats[kname]
        check(launches[kname] > 0, f"kernel {kname} was not launched by the drains")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": ref,
            "launches": launches[kname], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound"][0], "bound_by": s["bound"][1], "library_ms": None,
        })
    log(f"[done] {time.perf_counter() - t0:.1f}s; card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
