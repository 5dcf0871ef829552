#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels (kubernetes_tpu_torch/csrc/*.cu)
with nvcc for sm_90a, holds each kernel against its plain PyTorch version
on the card (exact equality: every value is an integer, and the two
float64 paths truncate identically), then drives the port's main paths —
the batch Scheduler on the bench.py config-2 workload (5,000 nodes, 50,000
pods, NoSchedule taints with tolerations, required node affinity), on
the config-3 workload (10,000 nodes in 8 zones, 100,000 pods in 100 apps,
one ScheduleAnyway zone spread constraint each; then the same behind one
Service per app, the SelectorSpread input) and on the config-4 workload
(2,000 nodes in 8 zones, 20,000 pods in 20 apps: every 10th pod with a
required hostname anti-affinity, the rest with a preferred zone affinity),
batches of 4,096, and on the config-6 workload (500 nodes each holding 7
bound priority-0 pods of 4 cores, 2,000 pending priority-1000 pods of 6
cores that land only by preemption) and on config 3-hard (config 3 with
every constraint DoNotSchedule) on the full 10,000-node cluster, where
the commit arbiter's defers escalate to the host oracle, and on the
config-5 gang workload (2,000 nodes, 1,000 groups of 64 pods placed all
or nothing) — every one through the ingest and term planes (the pods
admitted to a running scheduler, staged as the queue adds them, each
batch's pod arrays and term table gathered on the card) — and checks what
they placed. Phases:

  1. device     card name, count, power limit
  2. build      nvcc seconds and the -Xptxas -v register/shared lines
  3. kernels    each kernel == its plain version: filter (and its raw
                node-selector output), score and solve on a seeded cluster
                reaching every predicate/priority branch and at the config-2
                shapes (U=128, N=6144, B=4096); match_terms (one problem
                with and without namespaces, three problems in one launch),
                spread_score (one launch, no match launch, at the driver's
                V, 16, 64 and 40,000: device-memory tables, counted) and
                selector_spread_score on a seeded cluster reaching every
                topology branch and at the config-3 shapes (U=128, N=10240,
                TT=128 or 256, S=256, V=16), the spread score timed at 1, 4,
                8, 16 and all spec rows a cluster in turns, alone, through its
                wrapper, with device-memory tables and by the profiler's
                device duration, the match kernel too; the selector spread
                (one cluster launch, no match launch given the plan) timed
                at 3, 4, 8 and 16 CTAs a spec row in turns, with its zone
                tables in bucket slices and in device memory, and by the
                profiler's device duration; interpod_filter (every subset
                of its parts; one cluster launch, no match launch given the
                plan, its device-memory tables counted; timed at 1 to 16
                CTAs a spec row in turns, through its wrapper, by the
                profiler's device duration), interpod_score (each part and both),
                inbatch_port_conflict and the tracked solve on a seeded
                cluster reaching every inter-pod branch and at the config-4
                shapes (U=32, N=2048, TT=32, S=256, PT=32, V=2048), with the
                batch's match plan (its three matrices in one launch, timed
                beside the same as three launches);
                CUDA-event times of kernel and plain version, and each
                kernel's bound; the filter also with int64 pod counts (read
                in place: no conversion), with spec rows past a CTA's
                shared memory (its counted device-memory path) and timed at
                five tile shapes in turns
                the commit plane's spread_filter (one launch, no
                match_terms launch, its mask and every table cell exact at
                the driver's V, 16, 64 and 40,000; the device-memory tables
                counted; timed at 4, 8 and 16 CTAs a spec row in turns),
                arbitrate and
                fold_commit_banks on a seeded cluster reaching every branch
                (DoNotSchedule spread, inter-pod terms, host ports) and at
                the config-3-hard shapes (config 3 with DoNotSchedule
                constraints: U=TT=128, N=10240, S=256, V=16, one 4,096-pod
                batch solved on the card), arbitrate also at the config-4
                shapes (U=32, N=2048, TT=32, V=2048, B=4096); the fold's
                library yardstick is one index_put_(accumulate=True) per bank;
                preempt_batch on seeded arrays reaching every branch (PDB
                violators, fits_free, preemptors requesting nothing,
                extended-resource slots, nominee charges, ties at each pick
                key, padded rows, V up to 64, R = 16, N above a block) and
                on a random preemption cluster's, then at the config-6
                shapes (P=2048, N=512, V=8, R=8); fold_usage with duplicate
                rows and sentinel pads, its inverse restoring the bank bit
                for bit, and timed at the config-6 nominee shapes (976
                nominees on 512 rows, B=976), with one
                index_put_(accumulate=True) per column as its library
                yardstick; the single-device solve as a cluster of 8 and
                of 16 CTAs at the config-2 and config-3 shapes, each equal
                to the plain version, timed in turns; gather_score_rows on its
                edges (K = 1, repeated rows, N * 8 not a multiple of 16, a
                host destination 8 bytes past 16, K past the argument
                block's cap, int64 extremes), through its wrapper and into
                device and pinned host buffers, and at the config-3-hard
                shapes (U = 128, N = 10,240, K = 128, and the driver's K of
                1, 2 and 4), one torch.index_select as its library
                yardstick, both relaunched and by device duration; solve_gang (both passes in one launch),
                deterministic and with tie-noise, on the pipeline's mask and
                score of the first config-5 batch (U=64, N=2048, B=4096, 64
                groups) and at a tight shape (one more pod a node: most
                groups drop), timed through its wrapper; the ingest and
                term planes' batch gather (csrc/slab.cu: the pod arrays
                and the term table in one launch) through its one-problem
                calls gather_stage and gather_terms on their edges, both
                problems on edges and at the config-3 shapes (U = TT = 128
                lanes, 100 live, slabs of 256) and the config-5 ones (U =
                64, slab 1,024; TT = 16, none live), each under the sync
                debug mode and timed relaunched, by device duration and
                through its wrapper, and scatter_rows on its edges
                (duplicates, an empty dirty set, one row), staged and taken
                from host truth, at config 5's restage flush (64 of 1,024
                rows, timed) and a mirror sync's six patches in one launch
                (config 3, and config 4 timed), the library yardstick one
                index_select + where, or one index_copy_, per array,
                summed; the score
                kernel's RequestedToCapacityRatio branch (the default
                shape, two-point bin-packing, a five-point shape with
                down-sloping segments over cpu 3 / memory 1, beside
                NodeAffinity and TaintToleration) and its component mode
                (score_components) at the config-2 shapes, timed; the
                extender's filter_mask (filter, spread-filter and
                inter-pod-filter kernels, no score kernel) at the config
                3-hard and config-4 batch shapes; the node mesh's cluster
                kernels at 2, 4 and 8 shards, each against its plain
                version and the single-device kernel on the same inputs:
                the sharded solve at the config-3 shapes, deterministic and
                with tie-noise, tracked at the config-4 shapes, its gang
                mode at the config-5 shapes, the sharded arbiter at the
                config-3-hard (timed) and config-4 shapes, the sharded
                commit fold on the config-3 batch's fold program and the
                sharded usage fold at the config-6 nominee shapes; timed at
                8 shards beside the single-device kernel
  4. parity     config 2, config 3 and config 4 at 1/10 scale through
                Scheduler with the commit plane on (the arbiter and the
                fold), on cuda and on cpu, with it off on cuda, and with the
                ingest and term planes off on cuda (config 3 without
                Services deterministic, with Services under tie-noise;
                config 4 both): identical placements, the plane counters
                equal on cuda and cpu; then config 3-hard at
                1/10 (1,000 nodes, 10,000 pods, batch 128, deterministic) on
                cuda (a main path: the arbiter's defers and spread_filter)
                and cpu: identical placements and defers, every batch
                arbitrated, no escalation, no zone skew above max_skew;
                then config 6 at 1/10 (50 nodes, 350 bound, 200
                preemptors, batch 64, one stepped clock) with the commit
                plane on on cuda (a main path: preempt_batch, fold_usage)
                and on cpu, and off on cuda (the copy overlay): the same
                placements, victims in order, nominations after every
                batch and preempted count; then the host oracle's drains
                on cuda and on cpu (preemption on, one stepped clock):
                config 3-hard at 1,000 nodes / 10,000 pods / batch 512
                (the reference's 667 escalations to _oracle_place; every
                pod placed, no zone skew above max_skew), the commit-plane
                mix (8 nodes, 96 pods, batch 16), a random preemption
                cluster with host ports (the per-pod nominee re-check), a
                random cluster mixing DoNotSchedule spread, required pod
                (anti-)affinity and host ports (the slow victim search),
                and config 3-hard at 100 / 1,000 / 128 with the commit
                plane off (the per-pod loop): identical placements,
                victims in order, nominations after every batch and the
                oracle and arbiter counters; then config 5 at 1/10 (200
                nodes, 100 groups of 64, batch 1,024, a main path: the gang
                solve), a tight random gang cluster (40 nodes, 60 groups, 80
                ungrouped pods, batch 64, three rounds on a stepped clock:
                dropped groups and host rollbacks; the same per-batch
                counts, queue and counters, every group all or nothing, no
                assume left beyond the placed pods; the groups never placed
                are printed) and config 1 at full size (500 nodes, 5,000
                pods): identical placements on cuda and cpu
  5. drain      (after every full drain: each slab's device twin equals its
                host slab, every batch gathered or legacy on each plane,
                at most one legacy batch per slab rebuild, one batch-gather
                launch a covered batch) config 2 at
                full size; then config 3 at full size, without
                and with Services; then config 4 at full size, all with the
                commit plane on (the default; one spread_score launch a
                batch, no match launch on config 3, one a batch with
                Services and at most one on config 4, logged a batch): every pod placed, no node
                over its allocatable or pod limit, config 2's placements
                pass the taint/affinity checks, config 4 puts no two pods
                of one `exclusive` value on a node, and after each drain the
                device node bank's usage columns, signature bank and
                pattern bank — produced by the folds — equal a fresh host
                encode of the final cache; every batch folded, none
                arbitrated on configs 2 and 3 (the bulk path), every one
                on config 4 (required anti-affinity), none deferred; pods/s,
                stages, fold and arbiter counters, peak memory, per-app
                zone skew or share; then config 6 at full size with the
                commit plane on, at bench.py's batch of 4,096 and at 1,024
                (where the second batch of the first round already
                dispatches beside the first one's nominations: the nominee
                overlay; at 4,096 it runs only where the backoff expiries
                split the second round into batches): every preemptor placed,
                every victim below its preemptor's priority and never an
                assumed pod, no node over its allocatable or pod limit, no
                plan rejected by the host re-verification, the device node
                bank equal to a fresh encode with no overlay left on it;
                wall time (it waits out the queue's 1 s backoff) and the
                summed schedule_batch seconds apart, preemption rounds and
                their seconds; then config 3-hard on the full cluster
                (10,000 nodes in 8 zones, HARD_FULL_PODS pods, batch
                4,096): every pod placed, no node over its limits, no zone
                skew above max_skew, the device node and signature banks
                equal to a fresh encode; the defers, escalations and
                oracle counters; then config 5 at full size (2,000 nodes,
                64,000 pods, batch 4,096): every pod placed, no node over
                its limits, every batch a gang batch and no rollback, the
                device node and signature banks equal to a fresh encode;
                stages, pods/s and the mirror's rebuild count; then the
                Policy seam: config 2 at full size built by
                config.Configurator from an RTCR bin-packing Policy
                (GeneralPredicates, PodToleratesNodeTaints,
                CheckNodeUnschedulable, MatchInterPodAffinity; RTCR 2,
                NodeAffinity 1, TaintToleration 1): every pod placed, no
                violation, one RTCR score launch a batch, pods/s beside the
                default provider's; at 1/10 cuda == cpu; a custom-argument
                Policy (labelsPresence, serviceAffinity, labelPreference,
                serviceAntiAffinity) on a config-1-sized cluster with
                region and zone labels and one Service per app, the pods
                cut to CUSTOM_PODS: cuda == cpu, every pod re-ranked on the
                host; then the extender seam: the port's ExtenderServer on
                cuda over config 3's full cluster (config 3-hard and
                config-4 pods bound), EXT_REQUESTS /filter requests in
                nodeCacheCapable mode with every node name, every one
                answered by the device path and equal to the oracle path's
                answers (a stride sample) and to a CPU server's; latency
                of both paths; filter_mask at a request's shapes, timed;
                /prioritize, /bind, /preemption, /healthz once; then a
                Scheduler consulting an in-script extender over HTTP (even
                nodes, index prioritize, weight 100; and a dead ignorable
                one): cuda == cpu, every pod on an even node; then the
                node mesh (`Scheduler(mesh=node_mesh(8))`: the sharded
                solve, gang solve, arbiter and folds): config 3 at full
                size, every pod placed as the single-device config-3 drain
                of this call placed it, no fallback off the mesh, the banks
                equal to a fresh encode, pods/s beside the single-device
                drain's; configs 4, 3-hard, 5 and 6 at 1/10, each equal to
                its single-device drain of phase 4 (placements, counters;
                config 6 also victims, nominations, preempted count)
  6. kernels    a {"redesign": ...} line (the serial walks at the main
                path's shapes: the solve plain, tracked, gang and on the
                mesh, the arbiter on one CTA and the mesh; ms, plain ms,
                bound ms and µs a pod, and the 8- and 16-CTA solve's ms;
                the victim search and the score matrix; the spread filter
                at the config-3-hard shapes and the feasibility mask at the
                config-2 shapes, alone and through their wrappers, beside
                their times before the redesign, their bounds, the chosen
                cluster size and tile, the alternatives timed, the
                device-memory paths and their main-path launches, and the
                extender's filter_mask through its wrapper; the spread score
                and the match kernel: relaunch mean and device duration
                beside the times before, the spec rows a cluster timed, the
                device-memory tables, and every full drain's match launches
                and matrices a batch; the inter-pod filter at the config-4
                shapes and at a config-4 pod's extender request, and the
                selector spread: relaunch mean, device duration, through
                the wrapper, the CTAs a spec row, beside the times before,
                and their main-path launches; the batch slab gather at the
                config-3 and config-5 shapes, relaunched, by device
                duration and through its wrapper, beside the two launches
                before, and its main-path launches; gather_score_rows at K
                = 128, 1, 2 and 4 into the card and into pinned host
                memory, relaunched and by device duration, through its
                wrapper and the driver's fetch,
                beside torch.index_select (with .cpu() too) and the times
                before; the row scatter at config 5's flush and a config-4
                mirror sync's six patches in one launch (the wrapper warm
                and with its layout rebuilt each call),
                and both kernels' main-path launches), a [launches] line (every
                counter summed over the main-path drains), then
                one JSON line: per kernel (the eighteen, the match plan's
                multi-problem launch, the tracked solve, the RTCR branch,
                score_components, the extender's
                filter_mask and the mesh's six: the sharded solve, tracked
                and gang, the sharded arbiter and the two sharded folds)
                its launches in the main-path
                drains (the counts are set to 0 before each drain and read
                after it: config 3-hard and config 6 at 1/10, the oracle
                drains, config 5 at 1/10, the tight gang drain and config 1
                on cuda, the nine full drains, the Policy drains, the
                /filter requests, the extender client's drain and the five
                mesh drains;
                score_components has no main-path caller and counts 0),
                error, times, bound and the library yardstick where one
                PyTorch call computes the function
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
from types import SimpleNamespace

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
CONFIG4_NODES = 2000
CONFIG4_PODS = 20000
BATCH = 4096
HARD_BATCH = 128  # config 3-hard at 1/10: the size that escalates no defer
# config 3-hard on the full 10,000-node cluster: the pods are cut from
# 100,000 to what the host oracle's escalations let the script finish in
# beside the mesh phases (the full drain: scripts/torch_drain_profile.py
# --config 3-hard)
HARD_FULL_PODS = 16384
CONFIG6_NODES = 500
CONFIG6_PREEMPTORS = 2000
# config 6 in batches of 1,024: the second batch of the first round
# dispatches while the first one's nominations are outstanding (the nominee
# overlay); at 1/10 the same in batches of 64
CONFIG6_BATCH = 1024
CONFIG6_SMALL_BATCH = 64
CONFIG1_NODES = 500
CONFIG1_PODS = 5000
CONFIG5_NODES = 2000
CONFIG5_GROUPS = 1000  # of 64 pods each
GANG_BATCH = 64  # the tight gang drain's batch: groups straddle it
MESH_SHARDS = 8  # the node mesh's shards: one thread-block cluster of 8 CTAs
# the single-device drains the mesh drains are held to, recorded by the
# phases that run them: config 3 full, and configs 4, 3-hard, 5 and 6 at 1/10
SINGLE = {}


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


def score_work(na, pa, priorities=None, rtcr=None, n_components=0):
    """(bytes, integer operations) of csrc/scores.cu's function on these
    inputs under a priority tuple (None = the default one) and RTCR
    argument, or in its component mode with `n_components` planes. A pair
    of a valid spec and a valid node costs the arithmetic of each weighted
    priority (least requested 19, balanced allocation 14, the two
    normalizations 8 each, avoid 4 + 3 per avoid entry, image 8 + 3 per
    image, limits 10, bias and store 2; RTCR per resource 14 for the
    utilization, the interpolation and the sums, 2 per shape point its
    scan visits on this pair's utilization, and 4 for the mean), 4 per
    live preferred-term requirement plus 1 per compared value lane, 1 per
    taint with an effect and 4 per (eligible toleration, PreferNoSchedule
    taint)."""
    from kubernetes_tpu_torch.ops import scores as S

    has_images = "image_scaled" in na
    if n_components:
        w, w_rtcr = [int(k < n_components) for k in range(8)], 0
    else:
        w, w_rtcr = S.kernel_weights(priorities, has_images)
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
    rtcr_ops = 0
    if w_rtcr:
        shape, res = rtcr if rtcr is not None else (S.DEFAULT_RTCR_SHAPE, S.DEFAULT_RTCR_RESOURCES)
        pts = torch.tensor([x for x, _ in shape], dtype=torch.int64, device=na["alloc"].device)
        for rname, _ in res:
            col = S._RTCR_COLUMNS[rname]
            cap = na["alloc"][live_n][:, col][None, :]
            req = na["nonzero_req"][live_n][:, col][None, :] + pa["scoring_req"][live_u][:, col][:, None]
            p = torch.where((cap == 0) | (req > cap), torch.full_like(req, 100),
                            100 - torch.div((cap - req) * 100, cap.clamp(min=1), rounding_mode="floor"))
            visited = ((p[..., None] > pts).sum(dim=-1) + 1).clamp(max=len(shape))
            rtcr_ops += 14 * nu * nn + 2 * int(visited.sum())
        rtcr_ops += 4 * nu * nn
    ops = (
        per_pair * nu * nn
        + rtcr_ops
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
        + max(n_components, 1) * u * n * 8       # the score matrix (or its planes)
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


def match_work(problems):
    """(bytes, integer operations) of one match launch over (terms, labels,
    namespaces or None, live subjects) problems, over live lanes: per (valid
    term, live subject) 2 per matchLabels pair with a slot, 3 + 1 per value
    lane per expression with an operator, 2 + 1 per namespace lane when
    tested; reads the live term rows, the label slots they name of every
    live subject (and its namespace), writes the [TT, X] bytes."""
    nbytes_ = ops = 0
    for terms, labels, ns, live_x in problems:
        live = terms["valid"]
        tt, nx = int(live.sum()), int(live_x.sum())
        ml = int((terms["ml_slot"][live] >= 0).sum())
        ex_live = terms["ex_op"][live] != 0
        lanes = int(((terms["ex_vals"][live] >= 0) & ex_live[..., None]).sum())
        slots = set(terms["ml_slot"][live][terms["ml_slot"][live] >= 0].tolist()) | \
            set(terms["ex_slot"][live][ex_live].tolist())
        ns_lanes = tt * (2 + terms["ns_ids"].shape[1]) if ns is not None else 0
        ops += nx * (2 * ml + 3 * int(ex_live.sum()) + lanes + ns_lanes)
        row_bytes = sum(int(v[0].numel() * v.element_size()) for k, v in terms.items()
                        if k in ("valid", "has_selector", "ml_slot", "ml_val", "ex_op", "ex_slot", "ex_vals",
                                 "ns_any", "ns_ids"))
        nbytes_ += tt * row_bytes + nx * (4 * len(slots) + (4 if ns is not None else 0)) + \
            terms["valid"].shape[0] * labels.shape[0]
    return nbytes_, ops


def topology_work(kernel, na, ea, ta, au, m_sig_soft=None, m_sig_ns=None):
    """(bytes, integer operations, float64 operations) of one topology
    kernel's function on these inputs, over live lanes: valid terms of the
    kernel's kinds, valid signatures, valid nodes, spec rows owning such
    terms, selector lanes in use.
      spread_score    the soft terms' matches against the valid signatures
                      (match_work, no namespace test: the launch computes
                      them); per soft term, per valid node 1 add per
                      matched signature and 6 for the bucket; per spec row
                      with soft terms, per valid node 6 per term (gather)
                      and 8 (total, min, score); reads the matched
                      signatures' counts columns, the dense label column of
                      each soft slot, the owners' selector rows, writes
                      [U, N] int64
      selector_spread per spec row with selectors, per valid node 1 add per
                      matched signature, 4 (max, zone) and 6 float64 (the
                      blend); reads the matched signatures' counts columns,
                      zone_dense, writes [U, N] int64"""
    from kubernetes_tpu_torch.state.terms import SEL_SPREAD, SPREAD_SOFT

    n = na["valid"].shape[0]
    nn = int(na["valid"].sum())
    s_live = ea["valid"]
    u = au["n_sel_spread"].shape[0]
    tv = ta["valid"]
    if kernel == "spread_score":
        soft = tv & (ta["kind"] == SPREAD_SOFT)
        m = m_sig_soft[soft] & s_live[None, :]
        matched = int(m.sum())
        sigs = int(m.any(dim=0).sum())
        slots = len(set(ta["topo_slot"][soft].tolist()))
        owners = set(ta["owner"][soft].tolist())
        n_soft = int(soft.sum())
        soft_terms = {k: x[soft] for k, x in ta.items() if x.shape[:1] == tv.shape}
        m_bytes, m_ops = match_work([(soft_terms, ea["label_vals"], None, s_live)])
        m_bytes -= n_soft * ea["label_vals"].shape[0]  # the matches are not written
        ops = m_ops + nn * (matched + 6 * n_soft) + nn * (6 * n_soft + 8 * len(owners))
        nbytes_ = m_bytes + nn * 2 * sigs + nn * 4 * slots + len(owners) * n + n + u * n * 8
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


def interpod_work(kernel, na, ea, xa, ta, au, pa, parts, m_pt=None, m_sig=None):
    """(bytes, integer operations) of one inter-pod kernel's function on
    these inputs, over live lanes: valid nodes, valid spec rows, valid
    terms and patterns of the kinds the parts read, valid signatures.
      interpod_filter  per live pattern ("existing") and per live term
                       ("aff", "anti"), per valid node: 2 (bucket, add) +
                       1 per signature the term counts; per (valid row,
                       valid node) 3 per matching pattern or owned term
                       (bucket, gather, test) + 1; reads the counts columns
                       and dense label columns those name and the live
                       table rows, writes [U, N] bytes
      interpod_score   the same tables for the score kinds; per (valid
                       row, valid node) 4 per preferred term or matching
                       pattern (bucket, gather, multiply, add) + 8 (min,
                       max, normalize); writes [U, N] int64
      inbatch_port_conflict  per (row, row) pair 1, and 6 per (live port,
                       live port) pair; reads the port lists, writes [U, U]
      solve_greedy_inb per valid pod: TT + U (its lists) and, per node its
                       spec's mask admits, 4 per own or matching anti term
                       and 1 per clashing spec (on top of solve_work's);
                       reads the term rows, m_bb, pconf and the anti
                       slots' dense label columns, writes the commit tables"""
    from kubernetes_tpu_torch.state.terms import AFF_PREF, AFF_REQ, ANTI_PREF, ANTI_REQ

    nv = na["valid"]
    n, nn = nv.shape[0], int(nv.sum())
    u_live = pa["valid"]
    u, nu = u_live.shape[0], int(u_live.sum())
    v = 0
    if kernel == "inbatch_port_conflict":
        live = (pa["port_num"] > 0).sum(dim=1)
        ops = u * u + 6 * int(live.sum()) ** 2
        return u * pa["port_num"].shape[1] * 12 + u * u, ops
    tk, tv, town = ta["kind"], ta["valid"], ta["owner"]
    xk, xv = xa["kind"], xa["valid"]
    if kernel == "interpod_filter":
        x_kinds = [ANTI_REQ] if "existing" in parts else []
        t_kinds = ([AFF_REQ] if "aff" in parts else []) + ([ANTI_REQ] if "anti" in parts else [])
        per_ref, per_pair, out_bytes = 3, 1, u * n
    else:
        x_kinds = [AFF_REQ, AFF_PREF, ANTI_PREF] if "existing" in parts else []
        t_kinds = [AFF_PREF, ANTI_PREF] if "pref" in parts else []
        per_ref, per_pair, out_bytes = 4, 8, u * n * 8
    xs = xv & torch.isin(xk, torch.tensor(x_kinds, dtype=xk.dtype, device=xk.device))
    ts = tv & torch.isin(tk, torch.tensor(t_kinds, dtype=tk.dtype, device=tk.device))
    sig_live = ea["valid"]
    sigs, matched = set(), 0
    for t in torch.nonzero(ts).flatten().tolist():
        if int(tk[t]) == AFF_REQ:
            group = tv & (tk == AFF_REQ) & (town == town[t])
            m = m_sig[group].all(dim=0) & sig_live
        else:
            m = m_sig[t] & sig_live
        matched += int(m.sum())
        sigs |= set(torch.nonzero(m).flatten().tolist())
    slots = set(xa["topo_slot"][xs].tolist()) | set(ta["topo_slot"][ts].tolist())
    # references per (row, node): matching patterns and owned terms of live rows
    refs = int((m_pt[xs][:, u_live]).sum()) if int(xs.sum()) else 0
    refs += sum(int(((town == r) & ts).sum()) for r in torch.nonzero(u_live).flatten().tolist())
    ops = nn * (2 * int(xs.sum()) + 2 * int(ts.sum()) + matched) + nn * (per_ref * refs + per_pair * nu)
    nbytes_ = (nn * 2 * (int(xs.sum()) + len(sigs)) + nn * 4 * len(slots)
               + (int(xs.sum()) + int(ts.sum())) * max(int(na["label_dense"].max()) + 1, 1) * 4
               + out_bytes)
    return nbytes_, ops


def tracked_solve_work(mask, sig, pod_valid, pa, free0, count0, allowed, nz0, order, inb):
    """solve_work plus the in-batch tracking (see interpod_work)."""
    nbytes_, ops = solve_work(mask, sig, pod_valid, pa, free0, count0, allowed, nz0, order)
    anti, owner, m_bb, pconf = inb["anti"], inb["owner"], inb["m_bb"], inb["port_conflict"]
    tt, u = anti.shape[0], pconf.shape[0]
    sigs = sig.long()[pod_valid]
    admitted = mask.sum(dim=1).double()
    per_spec = torch.zeros(u, dtype=torch.float64, device=mask.device)
    for s_ in range(u):
        own = int((anti & (owner == s_)).sum())
        match = int((anti & m_bb[:, s_]).sum())
        per_spec[s_] = 4 * (own + match) + int(pconf[s_].sum())
    ops += float(pod_valid.sum()) * (tt + u) + float((admitted * per_spec)[sigs].sum())
    n = mask.shape[1]
    slots = len(set(inb["topo_slot"][anti].tolist()))
    nbytes_ += tt * (1 + 4 + 4) + m_bb.numel() + pconf.numel() + n * 4 * slots
    return nbytes_, ops


def gang_work(mask, sig, pod_valid, alive, pa, free0, count0, allowed, nz0, order, group):
    """(bytes, integer operations) of csrc/solver.cu's gang kernel: the
    solve's work for pass 1 over the valid pods and for pass 2 over the
    pods left alive, plus the O(B) flag passes (the group ids read, gang_ok
    written; three operations a position)."""
    b1, o1 = solve_work(mask, sig, pod_valid, pa, free0, count0, allowed, nz0, order)
    b2, o2 = solve_work(mask, sig, alive, pa, free0, count0, allowed, nz0, order)
    b = group.numel()
    return b1 + b2 + b * (4 + 1), o1 + o2 + 3 * b


def spread_filter_work(na, ea, ta, m_sig_ns, u, v, tables=True):
    """(bytes, integer operations) of spread_filter on these inputs, over
    live lanes: the hard terms' matches against the valid signatures
    (match_terms' count, restricted to the hard terms: the launch computes
    them); per hard term, per valid node 1 add per matched signature and 6
    for the bucket (candidate counts, presence); per spec row with hard
    terms, per valid node 6 per term (bucket, gather, skew test); reads the
    hard term rows, the signatures' label slots they name, the matched
    signatures' counts columns, the dense label column of each hard slot,
    the owners' selector rows, writes the [U, N] mask and, with `tables`,
    the candidate bytes and the [TT, V] / [TT] tables."""
    from kubernetes_tpu_torch.state.terms import SPREAD_HARD

    n = na["valid"].shape[0]
    nn = int(na["valid"].sum())
    hard = ta["valid"] & (ta["kind"] == SPREAD_HARD)
    m = m_sig_ns[hard] & ea["valid"][None, :]
    matched, sigs = int(m.sum()), int(m.any(dim=0).sum())
    slots = len(set(ta["topo_slot"][hard].tolist()))
    owners = len(set(ta["owner"][hard].tolist()))
    n_hard = int(hard.sum())
    ns_live = int(ea["valid"].sum())
    ml = int((ta["ml_slot"][hard] >= 0).sum())
    ex_live = ta["ex_op"][hard] != 0
    lanes = int(((ta["ex_vals"][hard] >= 0) & ex_live[..., None]).sum())
    match_ops = ns_live * (2 * ml + 3 * int(ex_live.sum()) + lanes + n_hard * (2 + ta["ns_ids"].shape[1]))
    label_slots = set(ta["ml_slot"][hard][ta["ml_slot"][hard] >= 0].tolist()) | \
        set(ta["ex_slot"][hard][ex_live].tolist())
    row_bytes = sum(int(v[0].numel() * v.element_size()) for k, v in ta.items()
                    if k in ("valid", "kind", "owner", "topo_slot", "self_match", "weight", "has_selector", "ml_slot",
                             "ml_val", "ex_op", "ex_slot", "ex_vals", "ns_any", "ns_ids"))
    ops = match_ops + nn * (matched + 6 * n_hard) + nn * 6 * n_hard
    tt = ta["valid"].shape[0]
    nbytes_ = (n_hard * row_bytes + ns_live * (4 * len(label_slots) + 4) + nn * 2 * sigs + nn * 4 * slots
               + owners * n + u * n + (u * n + tt * (5 * v + 5) if tables else 0))
    return nbytes_, ops


def arbiter_work(na, pa, ta, pb, verdict, have_spread, v):
    """(bytes, integer operations) of arbitrate on these inputs: per valid
    pod, R resource compares, 8 per term (bucket, two table tests, the
    skew test) and 1 per spec row (the port-clash column), plus a V-wide
    minimum per own hard term; reads the per-pod arrays, the residual and
    limit rows, the spec rows' requests, the term x spec match and
    port-clash tables, the term slots' dense label columns and, with
    hard spread, the merged tables and candidate rows once; writes the
    [B] verdict."""
    from kubernetes_tpu_torch.state.terms import SPREAD_HARD

    b = pb["sig"].shape[0]
    n, r = na["alloc"].shape
    u = pa["valid"].shape[0]
    tt = ta["valid"].shape[0]
    pods = int(pb["valid"].sum())
    hard = ta["valid"] & (ta["kind"] == SPREAD_HARD)
    own_hard = 0
    if have_spread:
        per_spec = torch.zeros(u, dtype=torch.int64, device=hard.device)
        per_spec.index_add_(0, ta["owner"][hard].long(), torch.ones(int(hard.sum()), dtype=torch.int64,
                                                                    device=hard.device))
        own_hard = int(per_spec[pb["sig"][pb["valid"]].long()].sum())
    ops = pods * (r + 8 * tt + u) + own_hard * v
    slots = len(set(ta["topo_slot"][ta["valid"]].tolist()))
    nbytes_ = (b * (8 + 4 + 1 + 4 + 4) + n * (r * 8 + 16) + u * (r * 8 + 1) + tt * u + u * u
               + n * 4 * slots + (tt * v * 5 + u * n if have_spread else 0))
    return nbytes_, ops


def fold_work(prog, r):
    """(bytes, integer operations) of fold_commit_banks on this program:
    the live lanes' control rows read once, each bank cell they touch read
    and written once; one add per resource slot, non-zero request, pod
    count and count cell."""
    live = prog.pods
    plive = int((prog.pat_cnt > 0).sum())
    cells_n = len(set(prog.rows[:live].tolist()))
    cells_s = len(set(zip(prog.rows[:live].tolist(), prog.sig[:live].tolist())))
    cells_p = len(set(zip(prog.pat_row[:plive].tolist(), prog.pat_col[:plive].tolist())))
    nbytes_ = (live * (4 + r * 8 + 16 + 4 + 4) + plive * 10
               + 2 * (cells_n * (r * 8 + 16 + 4) + 2 * cells_s + 2 * cells_p))
    return nbytes_, live * (r + 4) + plive


def preempt_work(a):
    """(bytes, integer operations) of preempt_batch on these inputs: every
    input read once, the outputs written once; per valid preemptor and
    live candidate node the free check (2R), the victim scan (V) and, for
    each lower-priority valid victim alive at the start, its request added
    and its reprieve tested and applied (3R) — the scan removes at most
    one node's victims a step, so this counts what the run needs to within
    those few."""
    nbytes_ = sum(int(t.numel() * t.element_size()) for t in a.values())
    p, n = a["cand"].shape
    v, r = a["vict_req"].shape[1:]
    nbytes_ += p * (4 + v + 1)
    live = (a["cand"] & a["node_valid"][None, :] & a["p_valid"][:, None]).long()  # [P, N]
    lower = (a["vict_valid"][None] & (a["vict_prio"][None] < a["p_prio"][:, None, None])).sum(dim=2)  # [P, N]
    ops = int((live * (2 * r + v + 3 * r * lower)).sum())
    return nbytes_, ops


def fold_usage_work(rows, n, r):
    """(bytes, integer operations) of fold_usage: the live entries' row,
    vector and count read once, each touched bank row read and written
    once; R + 1 adds an entry."""
    live = rows[(rows >= 0) & (rows < n)]
    cells = int(torch.unique(live).numel())
    return int(live.numel()) * (4 + 8 * r + 4) + 2 * cells * (8 * r + 4), int(live.numel()) * (r + 1)


def gather_work(k, n):
    """(bytes, integer operations) of gather_score_rows: the K wanted rows
    of N int64 scores read once and written once, the K indices read."""
    return 2 * k * n * 8 + 4 * k, 0


def bound(work):
    nbytes_, ops = work[:2]
    f64 = work[2] if len(work) > 2 else 0
    t_bytes = nbytes_ / H100_BYTES_PER_S * 1e3
    t_ops = (ops / INT32_OPS_PER_S + f64 / FP64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, kernel, reps: int = 50, tries: int = 6) -> float:
    """The mean device duration (ms) of the kernel named `kernel` (None:
    every kernel) over runs of fn(), from torch.profiler (CUPTI) traces of
    `reps` runs each: the summed durations of its device events over their
    count (a relaunch mean by CUDA events also holds the gaps the host
    leaves between launches). A tuple of names, each launched once a run,
    sums their means: a run's device time. A trace may drop events (at its edges, or
    most of them in an occasional session), so the events of successive
    traces are pooled until they hold half of one trace's launches, up to
    `tries` traces. When even that falls short, the mean comes from CUDA
    events around `reps` runs queued behind a sleep kernel, so that the
    card runs them back to back with no host gap (every kernel of fn()
    and the gaps between them: an upper bound), and a line says so."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    if isinstance(kernel, tuple):
        return sum(device_ms(fn, k, reps, tries) for k in kernel)
    fn()
    torch.cuda.synchronize()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    durs = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        durs += [e["dur"] for e in events
                 if e.get("ph") == "X" and e.get("cat") == "kernel" and (kernel is None or kernel in e.get("name", ""))]
        if len(durs) >= reps // 2:
            return sum(durs) / len(durs) / 1e3
    ms = queued_ms(fn, reps)
    log(f"[device_ms] the profiler saw {len(durs)} launches of {kernel} in {tries} traces of {reps}: "
        f"{ms:.6f} ms a run from CUDA events behind a sleep kernel")
    return ms


def queued_ms(fn, reps: int = 50) -> float:
    """The mean milliseconds a run of fn() holds the card when `reps` runs
    are queued behind a sleep kernel long enough for the host to enqueue
    them all, timed by CUDA events on the current stream."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()  # a first launch may load its module
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock, far longer than the enqueueing
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    # ... with the pod counts at int32 and int64 (a carried state), read in
    # place (the struct holds the caller's tensors: no conversion), the raw
    # selector output beside, and the counted device-memory path (spec rows
    # padded past shared memory)
    widths = {"int32": na, "int64": {**na, "pod_count": na["pod_count"].long(),
                                     "allowed_pods": na["allowed_pods"].long()}}
    # 7,000 toleration lanes a spec row (those past the encoder's 8 invalid):
    # past a CTA's shared memory, on 4 rows (the plain version's broadcast)
    wide = {k: v[:4] for k, v in pa.items()}
    for k in ("tol_key", "tol_op", "tol_val", "tol_effect", "tol_valid"):
        wide[k] = torch.cat([wide[k], torch.zeros(4, 7000 - pa[k].shape[1], dtype=pa[k].dtype, device=pa[k].device)],
                            1)
    mismatched = 0
    dev_mem = F.combined_mask.device_memory_launches
    for preds in subsets:
        for nw in widths.values():
            k, sel = F.combined_mask(nw, pa, ids, preds, with_selector=True)
            p = F.combined_mask_plain(nw, pa, ids, preds)
            mismatched += int((k != p).sum()) + int((sel != F.pod_match_node_selector(nw, pa)).sum())
            a64, _, _ = F.filter_args(nw, pa, ids, preds)
            check(a64.n_pod_count == nw["pod_count"].data_ptr() and a64.n_allowed_pods == nw["allowed_pods"].data_ptr(),
                  f"[{label}] the filter wrapper converted the pod counts")
        mismatched += int((F.combined_mask(na, wide, ids, preds) != F.combined_mask_plain(na, wide, ids, preds)).sum())
    check(mismatched == 0, f"[{label}] filter kernel differs from its plain version in {mismatched} pairs")
    check(F.combined_mask.device_memory_launches == dev_mem + len(subsets),
          f"[{label}] the filter's device-memory path was not counted")
    mask = F.combined_mask(na, pa, ids)
    # booleans: the largest |kernel - plain| is 1 if any pair differs
    out["filter_mask"] = {"max_abs_err": min(mismatched, 1), "feasible": int(mask.sum())}
    if time_it:
        # the kernel alone: relaunch one prebuilt argument struct, so the
        # wrapper's host-side struct building does not pace the device
        fm = out["filter_mask"]
        args, _, _ = F.filter_args(na, pa, ids)
        fm["ms"] = cuda_ms(lambda: build.launch(F.FILTER_ENTRY, args, na["valid"].device), 200)
        fm["wrapper_ms"] = cuda_ms(lambda: F.combined_mask(na, pa, ids), 200)
        fm["layout"] = {k: getattr(args, k) for k in ("UT", "NT", "row_bytes", "staged", "smem")}
        # the tile shapes, each exact, in turns; int64 counts; device memory
        fm["tiles_ms"] = {}
        want = F.combined_mask_plain(na, pa, ids)
        tiles = ((16, 128), (32, 128), (8, 256), (8, 128), (4, 256))
        for tile in tiles + tiles[::-1]:
            targs, tout, _ = F.filter_args(na, pa, ids, tile=tile)
            build.launch(F.FILTER_ENTRY, targs, na["valid"].device)
            check(bool(torch.equal(tout, want)), f"[{label}] filter tile {tile} differs from its plain version")
            ms = cuda_ms(lambda: build.launch(F.FILTER_ENTRY, targs, na["valid"].device), 200)
            key = f"{tile[0]}x{tile[1]}"
            fm["tiles_ms"][key] = min(ms, fm["tiles_ms"].get(key, ms))
        a64, _, _ = F.filter_args(widths["int64"], pa, ids)
        fm["int64_ms"] = cuda_ms(lambda: build.launch(F.FILTER_ENTRY, a64, na["valid"].device), 200)
        dargs, _, _ = F.filter_args(na, wide, ids)
        fm["device_memory_ms"] = cuda_ms(lambda: build.launch(F.FILTER_ENTRY, dargs, na["valid"].device), 50)
        log(f"[kernels] {label} filter_mask: layout {fm['layout']}; tiles "
            + ", ".join(f"{k}: {t:.4f} ms" for k, t in fm["tiles_ms"].items())
            + f"; int64 counts {fm['int64_ms']:.4f} ms; device-memory path (4 spec rows of 7,000 toleration "
            f"lanes) {fm['device_memory_ms']:.4f} ms")
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
    out["solve_greedy"] = {"max_abs_err": err, "placed": placed, "pods": int(pod_valid.sum())}
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
    batch: node, signature and pattern banks, spec rows (deduped with the
    pods' selectors) and each pod's row (`sig`), the batch term bank and
    its aux, the interned constants and n_buckets (the dense sizes of the
    batch terms' and patterns' slots and the zone count, bucketed)."""
    from kubernetes_tpu_torch.models.clusters import fill_cache
    from kubernetes_tpu_torch.ops.filters import make_ids
    from kubernetes_tpu_torch.scheduler.driver import _term_kind_names
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
    slots = set(tb.topo_slot[tb.valid].tolist()) | set(mirror.pats.bank.topo_slot[mirror.pats.valid].tolist())
    v = pow2_bucket(max([vocab.dense_size(int(x)) for x in slots if x >= 0] + [vocab.zone_count(), 1]))
    na, ea, xa = mirror.device_arrays()
    t = lambda d: arrays_to_torch(d, device)  # noqa: E731
    kinds = _term_kind_names(set(tb.kind[tb.valid].tolist()), bool((aux["n_sel_spread"] > 0).any()), mirror.pats)
    return {"na": na, "ea": ea, "xa": xa, "ta": t(tb.arrays()), "au": t(aux), "pa": t(batch.arrays()),
            "ids": make_ids(vocab), "v": v, "sig": torch.tensor(sig, dtype=torch.int32, device=device),
            "mirror": mirror, "pods": pods, "kinds": kinds,
            "ports": any(p.host_ports() for p in reps)}


def compare_topology(enc, label, time_it: bool):
    """Hold the filter's raw-selector output, the match kernel (one problem
    with and without the namespace test, then three problems in one
    launch), the spread score (one launch, no match launch, at the
    driver's V, 16, 64 and 40,000: device-memory tables, counted) and the
    selector spread against their plain versions on the same CUDA tensors;
    with time_it, time each (kernel alone: one prebuilt struct relaunched,
    CUDA events; the match and the spread score also by the profiler's
    device duration, the spread score through its wrapper, at 1, 4, 8, 16
    and all spec rows a cluster in turns and with device-memory tables) and
    bound it."""
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
    problems = [(ta, ea["label_vals"], ea["ns_id"]), (ta, ea["label_vals"], None), (ta, pa["label_vals"], pa["ns_id"])]
    launches = TO.match_terms.launches
    multi = TO.match_terms_multi(problems)
    check(TO.match_terms.launches == launches + 1, f"[{label}] three match problems took more than one launch")
    mismatched += sum(int((m != TO.match_terms_plain(*p)).sum()) for m, p in zip(multi, problems))
    check(mismatched == 0, f"[{label}] match_terms kernel differs from its plain version in {mismatched} pairs")
    out["match_terms"] = {"max_abs_err": min(mismatched, 1)}
    err_s = err_z = 0
    dev_tables = TO.spread_score.device_table_launches
    widths = (ta["valid"].shape[0], na["valid"].shape[0])
    dims = (pa["valid"].shape[0], ta["ml_slot"].shape[1], ta["ex_op"].shape[1], ta["ex_vals"].shape[2])
    want_dev = sum(int(TO.spread_score_layout(*widths, nb, *dims)["copies"] == 0) for nb in sorted({v, 16, 64, 40000}))
    m_ns_plan = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])  # the plan's m_sig
    for nb in sorted({v, 16, 64, 40000}):
        calls, matches = TO.spread_score.launches, TO.match_terms.launches
        a = TO.spread_score(na, ea, ta, au, sel, n_buckets=nb)
        check(TO.spread_score.launches == calls + 1 and TO.match_terms.launches == matches,
              f"[{label}] spread_score is not one launch without match_terms")
        b = TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=nb)
        err_s = max(err_s, int((a - b).abs().max()))
        calls, matches, zdev = (TO.selector_spread_score.launches, TO.match_terms.launches,
                                TO.selector_spread_score.device_table_launches)
        a = TO.selector_spread_score(na, ea, ta, au, n_buckets=nb, m_sig=m_ns_plan)
        zlay = TO.selector_spread_layout(widths[0], widths[1], nb, au["n_sel_spread"].shape[0])
        check(TO.selector_spread_score.launches == calls + 1 and TO.match_terms.launches == matches
              and TO.selector_spread_score.device_table_launches == zdev + int(zlay["mode"] == 2),
              f"[{label}] selector_spread_score given the plan is not one launch without match_terms, its device "
              f"tables counted")
        check((zlay["mode"] == 2) == (nb == 40000), f"[{label}] selector_spread_score's zone tables at V = {nb}: "
              f"mode {zlay['mode']}")
        b = TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=nb)
        err_z = max(err_z, int((a - b).abs().max()))
    check(err_s == 0, f"[{label}] spread_score kernel differs from its plain version by {err_s}")
    check(err_z == 0, f"[{label}] selector_spread_score kernel differs from its plain version by {err_z}")
    got_dev = TO.spread_score.device_table_launches - dev_tables
    check(got_dev == want_dev >= 1, f"[{label}] spread_score's device-memory tables were counted {got_dev} times "
          f"for {want_dev} such launches (V = 40,000 one of them)")
    out["spread_score"] = {"max_abs_err": err_s}
    out["selector_spread_score"] = {"max_abs_err": err_z}
    spread = TO.spread_score(na, ea, ta, au, sel, n_buckets=v)
    zsel = TO.selector_spread_score(na, ea, ta, au, n_buckets=v)
    log(f"[kernels] {label}: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} TT={ta['valid'].shape[0]} "
        f"S={ea['valid'].shape[0]} V={v}: raw selector, match_terms (1 and 3 problems a launch), spread_score "
        f"(one launch, V = {sorted({v, 16, 64, 40000})}), selector_spread_score exact (spread sum "
        f"{int(spread.sum())}, selector-spread sum {int(zsel.sum())})")
    if time_it:
        m_soft = TO.match_terms_plain(ta, ea["label_vals"], None)
        m_ns = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
        margs, _ = TO.match_args([(ta, ea["label_vals"], ea["ns_id"])])
        mt = out["match_terms"]
        mt["ms"] = cuda_ms(lambda: build.launch(TO.MATCH_ENTRY, margs, dev), 200)
        mt["device_ms"] = device_ms(lambda: build.launch(TO.MATCH_ENTRY, margs, dev), "match_terms_kernel")
        mt["plain_ms"] = cuda_ms(lambda: TO.match_terms_plain(ta, ea["label_vals"], ea["ns_id"]), 5)
        mt["bound"] = bound(match_work([(ta, ea["label_vals"], ea["ns_id"], ea["valid"])]))
        ss = out["spread_score"]
        sargs, _ = TO.spread_args(na, ea, ta, sel, v)
        ss["ms"] = cuda_ms(lambda: build.launch(TO.SPREAD_ENTRY, sargs, dev), 200)
        ss["device_ms"] = device_ms(lambda: build.launch(TO.SPREAD_ENTRY, sargs, dev), "spread_score_cluster_kernel")
        ss["wrapper_ms"] = cuda_ms(lambda: TO.spread_score(na, ea, ta, au, sel, n_buckets=v), 200)
        ss["plain_ms"] = cuda_ms(lambda: TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=v), 5)
        ss["bound"] = bound(topology_work("spread_score", na, ea, ta, au, m_sig_soft=m_soft))
        ss["layout"] = {k: getattr(sargs, k) for k in ("R", "C", "slice", "vslice", "copies", "dense_cap", "smem")}
        # the spec rows a cluster: 1, 4, 8, 16 and all, each exact, in turns
        want = TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=v)
        u = pa["valid"].shape[0]
        ss["rows_ms"] = {}
        for rows in (1, 4, 8, 16, u, u, 16, 8, 4, 1):
            rargs, rout = TO.spread_args(na, ea, ta, sel, v, rows=rows)
            build.launch(TO.SPREAD_ENTRY, rargs, dev)
            check(torch.equal(rout, want), f"[{label}] spread_score at {rows} rows a cluster differs")
            ms = cuda_ms(lambda: build.launch(TO.SPREAD_ENTRY, rargs, dev), 200)
            key = "all" if rows == u else str(rows)
            ss["rows_ms"][key] = min(ms, ss["rows_ms"].get(key, ms))
        # the device-memory tables at V = 40,000, the kernel alone
        dargs, _ = TO.spread_args(na, ea, ta, sel, 40000)
        ss["device_tables_ms"] = cuda_ms(lambda: build.launch(TO.SPREAD_ENTRY, dargs, dev), 50)
        log(f"[kernels] {label} spread_score: layout {ss['layout']}; by rows a cluster "
            + ", ".join(f"{r}: {t:.4f} ms" for r, t in ss["rows_ms"].items())
            + f"; device tables (V = 40,000) {ss['device_tables_ms']:.4f} ms; through its wrapper "
            f"{ss['wrapper_ms']:.4f} ms; device duration {ss['device_ms']:.4f} ms")
        log(f"[kernels] {label} match_terms: device duration {mt['device_ms']:.4f} ms")
        zs = out["selector_spread_score"]
        zargs, _ = TO.selector_spread_args(na, ea, ta, au, m_ns, v)
        zs["ms"] = cuda_ms(lambda: build.launch(TO.SEL_SPREAD_ENTRY, zargs, dev), 200)
        zs["device_ms"] = device_ms(lambda: build.launch(TO.SEL_SPREAD_ENTRY, zargs, dev),
                                    "selector_spread_cluster_kernel")
        zs["wrapper_ms"] = cuda_ms(lambda: TO.selector_spread_score(na, ea, ta, au, n_buckets=v, m_sig=m_ns), 200)
        zs["plain_ms"] = cuda_ms(lambda: TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=v), 5)
        zs["bound"] = bound(topology_work("selector_spread_score", na, ea, ta, au, m_sig_ns=m_ns))
        zs["layout"] = {k: getattr(zargs, k) for k in ("C", "slice", "vslice", "mode", "smem")}
        # the CTAs a spec row: 3 (the fewest whose registers hold N), 4, 8
        # and 16, each exact, in turns
        want = TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=v)
        zs["ctas_ms"] = {}
        for c in (3, 4, 8, 16, 16, 8, 4, 3):
            cargs, cout = TO.selector_spread_args(na, ea, ta, au, m_ns, v, cluster=c)
            build.launch(TO.SEL_SPREAD_ENTRY, cargs, dev)
            check(torch.equal(cout, want), f"[{label}] selector_spread_score at {c} CTAs a spec row differs")
            ms = cuda_ms(lambda: build.launch(TO.SEL_SPREAD_ENTRY, cargs, dev), 200)
            zs["ctas_ms"][str(c)] = min(ms, zs["ctas_ms"].get(str(c), ms))
        # the zone tables in bucket slices (V = 16,384) and in device memory (40,000)
        for nb, key in ((16384, "slices_ms"), (40000, "device_tables_ms")):
            dargs, dout = TO.selector_spread_args(na, ea, ta, au, m_ns, nb)
            build.launch(TO.SEL_SPREAD_ENTRY, dargs, dev)
            check(torch.equal(dout, TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=nb)),
                  f"[{label}] selector_spread_score at V = {nb} differs")
            zs[key] = cuda_ms(lambda: build.launch(TO.SEL_SPREAD_ENTRY, dargs, dev), 50)
        log(f"[kernels] {label} selector_spread_score: layout {zs['layout']}; by CTAs a spec row "
            + ", ".join(f"{c}: {ms_:.4f} ms" for c, ms_ in zs["ctas_ms"].items())
            + f"; zone tables in slices (V = 16,384) {zs['slices_ms']:.4f} ms, in device memory (V = 40,000) "
            f"{zs['device_tables_ms']:.4f} ms; through its wrapper {zs['wrapper_ms']:.4f} ms; device duration "
            f"{zs['device_ms']:.4f} ms")
        for name in ("match_terms", "spread_score", "selector_spread_score"):
            st = out[name]
            log(f"[kernels] {label} {name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
                f"bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    return out


FILTER_SUBSETS = [("existing",), ("aff",), ("anti",), ("existing", "aff"), ("existing", "anti"),
                  ("aff", "anti"), ("existing", "aff", "anti")]
SCORE_PARTS = [("pref",), ("existing",), ("pref", "existing")]


def compare_interpod(enc, label, time_it: bool):
    """Hold interpod_filter (every non-empty subset of its parts),
    interpod_score (each part and both), inbatch_port_conflict and the
    tracked solve (deterministic and under tie-noise) against their plain
    versions on the same CUDA tensors, at the driver's V and at V = 16
    (dropped buckets) and 40,000 (device-memory tables); the filter given
    the plan's matrices is one launch and no match launch; with time_it,
    time each (kernel alone: one prebuilt struct relaunched; the filter
    also as time_interpod_filter says) and bound it. Returns {kernel:
    stats}."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import scores as S
    from kubernetes_tpu_torch.ops import solver as SO
    from kubernetes_tpu_torch.ops import topology as TO

    na, ea, xa, ta, au, pa, ids, v, sig = (enc[k] for k in ("na", "ea", "xa", "ta", "au", "pa", "ids", "v", "sig"))
    dev = na["valid"].device
    out = {}
    bad_f = bad_s = 0
    # the plan's matrices: given them, the filter is one launch and no match launch
    m_pt_plan = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
    m_sig_plan = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    dims = (xa["valid"].shape[0], ta["valid"].shape[0], na["valid"].shape[0])
    for nb in sorted({v, 16, 40000}):
        ilay = TO.interpod_filter_layout(*dims, nb, pa["valid"].shape[0])
        for parts in FILTER_SUBSETS:
            calls, matches, idev = (TO.interpod_filter.launches, TO.match_terms.launches,
                                    TO.interpod_filter.device_table_launches)
            k = TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=nb, m_pt=m_pt_plan, m_sig=m_sig_plan)
            check(TO.interpod_filter.launches == calls + 1 and TO.match_terms.launches == matches
                  and TO.interpod_filter.device_table_launches == idev + int(ilay["tcap"] == 0),
                  f"[{label}] interpod_filter given the plan is not one launch without match_terms, its device "
                  f"tables counted")
            p = TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, nb)
            bad_f += int((k != p).sum()) + int(k.dtype != p.dtype)
            k = TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=nb)
            bad_f += int((k != p).sum())
        for parts in SCORE_PARTS:
            k = TO.interpod_score(na, ea, ta, xa, pa, parts=parts, n_buckets=nb)
            p = TO.interpod_score_plain(na, ea, ta, xa, pa, parts, nb)
            bad_s = max(bad_s, int((k - p).abs().max()) + int(k.dtype != p.dtype))
    check(bad_f == 0, f"[{label}] interpod_filter kernel differs from its plain version in {bad_f} pairs")
    check(bad_s == 0, f"[{label}] interpod_score kernel differs from its plain version by {bad_s}")
    pconf = F.inbatch_port_conflict(pa, ids)
    bad_p = int((pconf != F.inbatch_port_conflict_plain(pa, ids)).sum())
    check(bad_p == 0, f"[{label}] inbatch_port_conflict kernel differs from its plain version in {bad_p} pairs")
    out["interpod_filter"] = {"max_abs_err": min(bad_f, 1)}
    out["interpod_score"] = {"max_abs_err": bad_s}
    out["inbatch_port_conflict"] = {"max_abs_err": min(bad_p, 1)}
    # the batch's match plan: its three matrices in one launch, each exact
    plan = [(ta, ea["label_vals"], ea["ns_id"]), (xa, pa["label_vals"], pa["ns_id"]),
            (ta, pa["label_vals"], pa["ns_id"])]
    launches = TO.match_terms.launches
    got = TO.match_terms_multi(plan)
    check(TO.match_terms.launches == launches + 1, f"[{label}] the match plan took more than one launch")
    bad_m = sum(int((g != TO.match_terms_plain(*p)).sum()) for g, p in zip(got, plan))
    check(bad_m == 0, f"[{label}] the multi-problem match differs from its plain version in {bad_m} pairs")
    out["match_terms[plan]"] = {"max_abs_err": min(bad_m, 1), "problems": len(plan)}

    # the tracked solve on the pipeline's own mask and score
    kinds = frozenset({"aff_req", "anti_req", "pref", "et_anti", "et_score"})
    mask, score = PP.mask_and_score(na, pa, ids, None, kinds, ea=ea, ta=ta, au=au, xa=xa, n_buckets=v)
    b = sig.shape[0]
    pod_valid = torch.ones(b, dtype=torch.bool, device=dev)
    order = SO.pop_order(torch.zeros(b, dtype=torch.int32, device=dev),
                         torch.arange(b, dtype=torch.int32, device=dev), pod_valid)
    free0 = na["alloc"] - na["requested"]
    args = (mask, score, pa["req"], free0, na["pod_count"].long(), na["allowed_pods"].long(), order)
    inb = PP._inbatch_tensors(na, pa, ta, ids, v)
    err = placed = 0
    for det in (True, False):
        kw = dict(deterministic=det, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid, return_carry=True,
                  nz0=na["nonzero_req"], scoring_req=pa["scoring_req"], inb=inb)
        ka, kc = SO.solve_greedy(*args, SO.prng_key_data(11), **kw)
        pa_, pc = SO.solve_greedy_plain(*args, SO.prng_key_data(11), **kw)
        err = max(err, int((ka - pa_).abs().max()), *(int((x - y).abs().max()) for x, y in zip(kc, pc)))
        placed = int((ka >= 0).sum())
    check(err == 0, f"[{label}] tracked solve kernel differs from its plain version by {err}")
    out["solve_greedy_inb"] = {"max_abs_err": err, "placed": placed, "pods": int(pod_valid.sum())}
    log(f"[kernels] {label}: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} TT={ta['valid'].shape[0]} "
        f"S={ea['valid'].shape[0]} PT={xa['valid'].shape[0]} V={v} B={b}: interpod_filter (7 part subsets), "
        f"interpod_score (3), inbatch_port_conflict, tracked solve exact ({int(mask.sum())} feasible pairs, "
        f"{int(pconf.sum())} clashing spec pairs, {placed} placed)")
    if time_it:
        parts_f, parts_s = FILTER_SUBSETS[-1], SCORE_PARTS[-1]
        m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
        m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
        out["interpod_filter"].update(time_interpod_filter(na, ea, ta, au, xa, pa, m_pt, m_sig, parts_f, v, label))
        sargs, _ = TO.interpod_score_args(na, ea, ta, xa, pa, m_pt, m_sig, parts_s, v)
        out["interpod_score"]["ms"] = cuda_ms(lambda: build.launch(TO.INTERPOD_SCORE_ENTRY, sargs, dev), 200)
        # its table kernels and its score kernel, each launched once a call
        out["interpod_score"]["device_ms"] = device_ms(lambda: build.launch(TO.INTERPOD_SCORE_ENTRY, sargs, dev),
                                                       ("pattern_table_kernel", "term_table_kernel",
                                                        "interpod_score_kernel"))
        out["interpod_score"]["plain_ms"] = cuda_ms(
            lambda: TO.interpod_score_plain(na, ea, ta, xa, pa, parts_s, v), 5)
        out["interpod_score"]["bound"] = bound(interpod_work("interpod_score", na, ea, xa, ta, au, pa, parts_s,
                                                             m_pt, m_sig))
        mp = out["match_terms[plan]"]
        margs, _ = TO.match_args(plan)
        mp["ms"] = cuda_ms(lambda: build.launch(TO.MATCH_ENTRY, margs, dev), 200)
        mp["device_ms"] = device_ms(lambda: build.launch(TO.MATCH_ENTRY, margs, dev), "match_terms_kernel")
        mp["plain_ms"] = cuda_ms(lambda: [TO.match_terms_plain(*p) for p in plan], 5)
        mp["bound"] = bound(match_work([(ta, ea["label_vals"], ea["ns_id"], ea["valid"]),
                                        (xa, pa["label_vals"], pa["ns_id"], pa["valid"]),
                                        (ta, pa["label_vals"], pa["ns_id"], pa["valid"])]))
        singles = [TO.match_args([p])[0] for p in plan]  # the same matrices as three launches
        mp["three_launches_ms"] = cuda_ms(lambda: [build.launch(TO.MATCH_ENTRY, a_, dev) for a_ in singles], 200)
        log(f"[kernels] {label} match plan (3 problems, one launch): {mp['ms']:.4f} ms (device duration "
            f"{mp['device_ms']:.4f}), as three launches {mp['three_launches_ms']:.4f} ms, bound "
            f"{mp['bound'][0]:.6f} ms ({mp['bound'][1]})")
        pargs, _ = F.port_conflict_args(pa, ids)
        out["inbatch_port_conflict"]["ms"] = cuda_ms(lambda: build.launch(F.PORT_CONFLICT_ENTRY, pargs, dev), 200)
        out["inbatch_port_conflict"]["device_ms"] = device_ms(lambda: build.launch(F.PORT_CONFLICT_ENTRY, pargs, dev),
                                                              "inbatch_port_conflict_kernel")
        out["inbatch_port_conflict"]["plain_ms"] = cuda_ms(lambda: F.inbatch_port_conflict_plain(pa, ids), 5)
        out["inbatch_port_conflict"]["bound"] = bound(interpod_work("inbatch_port_conflict", na, ea, xa, ta, au,
                                                                    pa, ()))
        kw = dict(deterministic=False, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid, return_carry=True,
                  nz0=na["nonzero_req"], scoring_req=pa["scoring_req"], inb=inb)
        key = SO.prng_key_data(11)
        out["solve_greedy_inb"]["ms"] = cuda_ms(lambda: SO.solve_greedy(*args, key, **kw), 5)
        out["solve_greedy_inb"]["plain_ms"] = cuda_ms(lambda: SO.solve_greedy_plain(*args, key, **kw), 1)
        out["solve_greedy_inb"]["bound"] = bound(tracked_solve_work(
            mask, sig, pod_valid, pa, free0, na["pod_count"].long(), na["allowed_pods"].long(),
            na["nonzero_req"], order, inb))
        for name in ("interpod_filter", "interpod_score", "inbatch_port_conflict", "solve_greedy_inb"):
            st = out[name]
            log(f"[kernels] {label} {name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
                f"bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    return out


def filter_rows_with_work(ta, au, xa, pa, m_pt, parts):
    """The spec rows the inter-pod filter tabulates: those owning an
    AFF_REQ term (under has_aff) or an ANTI_REQ term of the parts, or
    matched by an ANTI_REQ pattern ("existing")."""
    from kubernetes_tpu_torch.state.terms import AFF_REQ, ANTI_REQ

    tv, tk, town = ta["valid"], ta["kind"], ta["owner"].long()
    owns = torch.zeros_like(tv)
    if "aff" in parts:
        owns |= tv & (tk == AFF_REQ) & au["has_aff"][town.clamp(0, au["has_aff"].shape[0] - 1)]
    if "anti" in parts:
        owns |= tv & (tk == ANTI_REQ)
    rows = set(town[owns].tolist())
    if "existing" in parts:
        anti = xa["valid"] & (xa["kind"] == ANTI_REQ)
        rows |= set(torch.nonzero((m_pt & anti[:, None]).any(dim=0)).flatten().tolist())
    return len(rows)


def time_interpod_filter(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, v, label):
    """The inter-pod filter's one launch on these inputs: the kernel alone
    (relaunch mean by CUDA events, the profiler's device duration), through
    its wrapper given the plan, its plain version, the bound, the rows it
    tabulates, the CTAs a spec row 1 to 16 in turns (each exact) and the
    device-memory tables at V = 40,000. Returns its stats."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import topology as TO

    dev = na["valid"].device
    st = {}
    fargs, _ = TO.interpod_filter_args(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, v)
    st["ms"] = cuda_ms(lambda: build.launch(TO.INTERPOD_FILTER_ENTRY, fargs, dev), 200)
    st["device_ms"] = device_ms(lambda: build.launch(TO.INTERPOD_FILTER_ENTRY, fargs, dev),
                                "interpod_filter_cluster_kernel")
    st["wrapper_ms"] = cuda_ms(lambda: TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=v,
                                                          m_pt=m_pt, m_sig=m_sig), 200)
    st["plain_ms"] = cuda_ms(lambda: TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, v), 5)
    st["bound"] = bound(interpod_work("interpod_filter", na, ea, xa, ta, au, pa, parts, m_pt, m_sig))
    st["layout"] = {k: getattr(fargs, k) for k in ("C", "slice", "vslice", "tcap", "smem")}
    st["rows"] = [filter_rows_with_work(ta, au, xa, pa, m_pt, parts), pa["valid"].shape[0]]
    want = TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, v)
    st["ctas_ms"] = {}
    for c in (1, 2, 4, 8, 16, 16, 8, 4, 2, 1):
        cargs, cout = TO.interpod_filter_args(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, v, cluster=c)
        build.launch(TO.INTERPOD_FILTER_ENTRY, cargs, dev)
        check(torch.equal(cout, want), f"[{label}] interpod_filter at {c} CTAs a spec row differs")
        ms = cuda_ms(lambda: build.launch(TO.INTERPOD_FILTER_ENTRY, cargs, dev), 200)
        st["ctas_ms"][str(c)] = min(ms, st["ctas_ms"].get(str(c), ms))
    dargs, dout = TO.interpod_filter_args(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, 40000, cluster=1)
    check(dargs.tcap == 0, f"[{label}] interpod_filter at V = 40,000 on one CTA a row holds its tables in shared "
          f"memory")
    build.launch(TO.INTERPOD_FILTER_ENTRY, dargs, dev)
    check(torch.equal(dout, TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, 40000)),
          f"[{label}] interpod_filter's device-memory tables differ")
    st["device_tables_ms"] = cuda_ms(lambda: build.launch(TO.INTERPOD_FILTER_ENTRY, dargs, dev), 50)
    log(f"[kernels] {label} interpod_filter {'+'.join(parts)}: layout {st['layout']}, {st['rows'][0]} of "
        f"{st['rows'][1]} spec rows tabulate; relaunched {st['ms']:.4f} ms, device duration {st['device_ms']:.4f} "
        f"ms, through its wrapper {st['wrapper_ms']:.4f} ms; by CTAs a spec row "
        + ", ".join(f"{c}: {ms_:.4f} ms" for c, ms_ in st["ctas_ms"].items())
        + f"; device tables (V = 40,000, one CTA a row) {st['device_tables_ms']:.4f} ms")
    return st


def compare_commit(enc, label, time_it: bool, parts=("spread_filter", "arbitrate", "fold_commit_banks")):
    """Hold spread_filter (at the driver's V, at 16 and at 40,000), the
    commit arbiter (with and without the spread kinds) and the commit fold
    against their plain versions on the same CUDA tensors: the arbiter on
    the batch's own solve (one 4,096-pod batch of the encoded pods, the
    tracking on as the driver would have it), the fold with the arbiter's
    placed pods into copies of the device banks. With time_it, time each
    (the entry alone: one prebuilt struct relaunched), its plain version
    and, for the fold, the library's index_put_(accumulate=True) per bank,
    and bound it. Returns {kernel: stats}."""
    from kubernetes_tpu_torch.commit import arbiter as A
    from kubernetes_tpu_torch.commit.fold import plan_fold
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import fold as FO
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import solver as SO
    from kubernetes_tpu_torch.ops import topology as TO
    from kubernetes_tpu_torch.state.convert import arrays_to_torch
    from kubernetes_tpu_torch.state.tensors import pow2_bucket

    na, ea, xa, ta, au, pa, ids, v, sig = (enc[k] for k in ("na", "ea", "xa", "ta", "au", "pa", "ids", "v", "sig"))
    kinds = enc["kinds"]
    dev = na["valid"].device
    out = {}
    _, sel = F.combined_mask(na, pa, ids, with_selector=True)
    if "spread_filter" in parts:
        # one launch a call (the term matches inside it), its mask and every
        # table cell exact, at the driver's V, 16, 64 and 40,000 (device memory)
        bad = 0
        dev_tables = TO.spread_filter.device_table_launches
        for nb in sorted({v, 16, 64, 40000}):
            calls, matches = TO.spread_filter.launches, TO.match_terms.launches
            got, tb = TO.spread_filter(na, ea, ta, sel, n_buckets=nb, with_tables=True)
            check(TO.spread_filter.launches == calls + 1 and TO.match_terms.launches == matches,
                  f"[{label}] spread_filter is not one launch without match_terms")
            want, want_tb = TO.spread_filter_plain(na, ea, ta, sel, nb, with_tables=True)
            bad += int((got != want).sum()) + sum(int((tb[k] != want_tb[k]).sum()) for k in want_tb)
        check(bad == 0, f"[{label}] spread_filter kernel differs from its plain version in {bad} cells")
        check(TO.spread_filter.device_table_launches == dev_tables + 1,
              f"[{label}] spread_filter's device-memory tables were not counted once (V = 40,000)")
        out["spread_filter"] = {"max_abs_err": min(bad, 1)}
    b = sig.shape[0]
    pb = {"sig": sig, "valid": torch.ones(b, dtype=torch.bool, device=dev),
          "priority": torch.zeros(b, dtype=torch.int32, device=dev)}
    track = "anti_req" in kinds or enc["ports"]
    assign, _ = PP.solve_pipeline(na, pa, ids, SO.prng_key_data(5), pb=pb, term_kinds=kinds, track_inbatch=track,
                                  ea=ea, ta=ta, au=au, xa=xa, n_buckets=v)
    err = 0
    plain = {}
    for tk in (kinds, kinds - {"spread_hard"}):
        k = A.arbitrate(na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=v)
        plain[tk] = A.arbitrate_plain(na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=v)
        err += int((k != plain[tk]).sum())
    # as the driver runs it: on the intermediates its batch's solve left
    solved = {}
    PP.solve_pipeline(na, pa, ids, SO.prng_key_data(5), pb=pb, term_kinds=kinds, track_inbatch=track,
                      ea=ea, ta=ta, au=au, xa=xa, n_buckets=v, arbiter_inputs=solved)
    err += int((A.arbitrate(na, pa, ea, ta, ids, assign, pb, term_kinds=kinds, n_buckets=v, inputs=solved)
                != plain[kinds]).sum())
    check(err == 0, f"[{label}] arbitrate kernel differs from its plain version in {err} verdicts")
    verdict = A.arbitrate(na, pa, ea, ta, ids, assign, pb, term_kinds=kinds, n_buckets=v)
    counts = [int((verdict == x).sum()) for x in (A.V_PLACE, A.V_DEFER, A.V_NOFIT)]
    out["arbitrate"] = {"max_abs_err": min(err, 1), "pods": b}
    placed = torch.nonzero(verdict == A.V_PLACE).flatten().tolist()
    assign_l = assign.tolist()
    prog = plan_fold(enc["mirror"], [(enc["pods"][i], assign_l[i]) for i in placed], pow2_bucket(b), 16)
    check(prog is not None, f"[{label}] the fold plan overflowed a bank")
    banks = (na["requested"], na["nonzero_req"], na["pod_count"], ea["counts"], xa["counts"])
    ctl = arrays_to_torch({k: getattr(prog, k) for k in ("rows", "req", "nz", "cnt", "sig", "pat_row", "pat_col",
                                                         "pat_cnt")}, dev)
    kb = [x.clone() for x in banks]
    pbk = [x.clone() for x in banks]
    FO.fold_commit_banks(*kb, **ctl)
    FO.fold_commit_banks_plain(*pbk, **ctl)
    err_f = max(int((x.long() - y.long()).abs().max()) for x, y in zip(kb, pbk))
    check(err_f == 0, f"[{label}] fold_commit_banks kernel differs from its plain version by {err_f}")
    out["fold_commit_banks"] = {"max_abs_err": err_f}
    log(f"[kernels] {label}: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} TT={ta['valid'].shape[0]} "
        f"S={ea['valid'].shape[0]} PT={xa['valid'].shape[0]} V={v} B={b}, kinds {sorted(kinds)}: "
        f"{'spread_filter, ' if 'spread_filter' in parts else ''}arbitrate, fold_commit_banks exact "
        f"(verdicts place/defer/nofit {counts}; {prog.pods} pods and "
        f"{int((prog.pat_cnt > 0).sum())} pattern instances folded)")
    if time_it:
        if "spread_filter" in parts:
            m_ns = TO.match_terms_plain(ta, ea["label_vals"], ea["ns_id"])
            sf = out["spread_filter"]
            fargs, _, _ = TO.spread_filter_args(na, ea, ta, sel, v)
            sf["ms"] = cuda_ms(lambda: build.launch(TO.SPREAD_FILTER_ENTRY, fargs, dev), 200)
            sf["wrapper_ms"] = cuda_ms(lambda: TO.spread_filter(na, ea, ta, sel, n_buckets=v, with_tables=True), 200)
            sf["plain_ms"] = cuda_ms(lambda: TO.spread_filter_plain(na, ea, ta, sel, v), 5)
            sf["bound"] = bound(spread_filter_work(na, ea, ta, m_ns, pa["valid"].shape[0], v))
            sf["layout"] = {k: getattr(fargs, k) for k in ("C", "slice", "vslice", "copies", "local_table", "smem")}
            # the cluster size: 4, 8 and 16 CTAs a spec row, each exact, in turns
            want, want_tb = TO.spread_filter_plain(na, ea, ta, sel, v, with_tables=True)
            sf["ctas_ms"] = {}
            for ctas in (4, 8, 16, 16, 8, 4):
                cargs, cmask, ctb = TO.spread_filter_args(na, ea, ta, sel, v, cluster=ctas)
                build.launch(TO.SPREAD_FILTER_ENTRY, cargs, dev)
                bad_c = int((cmask != want).sum()) + sum(int((ctb[k] != want_tb[k]).sum()) for k in want_tb)
                check(bad_c == 0, f"[{label}] spread_filter at {ctas} CTAs a row differs in {bad_c} cells")
                ms = cuda_ms(lambda: build.launch(TO.SPREAD_FILTER_ENTRY, cargs, dev), 200)
                sf["ctas_ms"][ctas] = min(ms, sf["ctas_ms"].get(ctas, ms))
            # the device-memory tables at V = 40,000, the kernel alone
            dargs, _, _ = TO.spread_filter_args(na, ea, ta, sel, 40000)
            sf["device_tables_ms"] = cuda_ms(lambda: build.launch(TO.SPREAD_FILTER_ENTRY, dargs, dev), 50)
            log(f"[kernels] {label} spread_filter: layout {sf['layout']}; by CTAs a row "
                + ", ".join(f"{c}: {t:.4f} ms" for c, t in sorted(sf["ctas_ms"].items()))
                + f"; device-memory tables (V = 40,000) {sf['device_tables_ms']:.4f} ms; through its wrapper "
                f"{sf['wrapper_ms']:.4f} ms")
        if "arbitrate" in parts:
            aargs, _ = A.arbiter_args(na, pa, ea, ta, ids, assign, pb, term_kinds=kinds, n_buckets=v)
            out["arbitrate"]["ms"] = cuda_ms(lambda: build.launch(A.ARBITER_ENTRY, aargs, dev), 5)
            out["arbitrate"]["plain_ms"] = cuda_ms(
                lambda: A.arbitrate_plain(na, pa, ea, ta, ids, assign, pb, term_kinds=kinds, n_buckets=v), 1)
            out["arbitrate"]["bound"] = bound(arbiter_work(na, pa, ta, pb, verdict, "spread_hard" in kinds, v))
        if "fold_commit_banks" in parts:
            oargs = FO.fold_args(*kb, **ctl)
            out["fold_commit_banks"]["ms"] = cuda_ms(lambda: build.launch(FO.FOLD_ENTRY, oargs, dev), 200)
            out["fold_commit_banks"]["device_ms"] = device_ms(lambda: build.launch(FO.FOLD_ENTRY, oargs, dev),
                                                              "fold_commit_kernel")
            out["fold_commit_banks"]["plain_ms"] = cuda_ms(lambda: FO.fold_commit_banks_plain(*pbk, **ctl), 5)
            out["fold_commit_banks"]["bound"] = bound(fold_work(prog, na["requested"].shape[1]))
            out["fold_commit_banks"]["library_ms"] = library_fold_ms(kb, ctl, prog.pods)
        for name in parts:
            st = out[name]
            lib = st.get("library_ms")
            log(f"[kernels] {label} {name}: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, "
                f"bound {st['bound'][0]:.6f} ms ({st['bound'][1]})"
                + (f", library {lib:.4f} ms" if lib is not None else ""))
    return {k: out[k] for k in parts}


def library_fold_ms(banks, ctl, pods):
    """The fold's library yardstick: per bank one index_put_(accumulate=
    True) of the live lanes into a copy, timed apart; their sum."""
    requested, nonzero_req, pod_count, sig_counts, pat_counts = (x.clone() for x in banks)
    rows = ctl["rows"][:pods].long()
    plive = ctl["pat_cnt"] > 0
    pr, pc = ctl["pat_row"][plive].long(), ctl["pat_col"][plive].long()
    calls = (
        lambda: requested.index_put_((rows,), ctl["req"][:pods], accumulate=True),
        lambda: nonzero_req.index_put_((rows,), ctl["nz"][:pods], accumulate=True),
        lambda: pod_count.index_put_((rows,), ctl["cnt"][:pods], accumulate=True),
        lambda: sig_counts.index_put_((rows, ctl["sig"][:pods].long()), ctl["cnt"][:pods].to(torch.int16),
                                      accumulate=True),
        lambda: pat_counts.index_put_((pr, pc), ctl["pat_cnt"][plive], accumulate=True),
    )
    try:
        return sum(cuda_ms(c, 50) for c in calls)
    except RuntimeError as e:  # a dtype the library's scatter does not take
        log(f"[kernels] fold library yardstick not measured: {e}")
        return None


def compare_preempt(arrays, label, time_it: bool, plain_time: bool = True):
    """Hold preempt_batch against its plain version on the same CUDA
    tensors, and read the walk's reuse counts (rows evaluated beside P x N,
    steps walked by one warp, tree rebuilds) and where its state lived;
    with time_it, time the kernel (one prebuilt struct relaunched) and, with
    plain_time, the plain version, and bound it. Returns its stats."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import preempt as PR
    from kubernetes_tpu_torch.state.convert import arrays_to_torch

    a = arrays_to_torch(arrays, "cuda")
    before = PR.preempt_batch.device_memory_launches
    got = PR.preempt_batch(**a)
    device_memory = PR.preempt_batch.device_memory_launches - before
    want = PR.preempt_batch_plain(**a)
    bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    check(bad == 0, f"[{label}] preempt_batch kernel differs from its plain version in {bad} values")
    found = int((got[0] >= 0).sum())
    p, n = a["cand"].shape
    v, r = a["vict_req"].shape[1:]
    lay = PR.preempt_layout(n, v, r)
    pargs, again = PR.preempt_args(**a)
    PR.launch_preempt(pargs, a["cand"].device)
    bad = sum(int((g != w).sum()) for g, w in zip(again, want))
    check(bad == 0, f"[{label}] preempt_batch relaunched differs from its plain version in {bad} values")
    evaluated, solo, rebuilds = pargs.counts.tolist()
    st = {"max_abs_err": int(max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))),
          "steps": p, "evaluated": evaluated, "full_evaluations": p * n, "solo_steps": solo, "rebuilds": rebuilds,
          "resident": lay["resident"], "device_memory_launches": device_memory}
    log(f"[kernels] {label}: P={p} N={n} V={v} R={r}: preempt_batch exact ({found} preemptors placed, "
        f"{int(got[2][a['p_valid']].sum())} fit as things stand); reuse: {evaluated} rows evaluated of "
        f"P x N = {p * n}, {solo} steps walked by one warp, {rebuilds} tree rebuilds; state in "
        f"{'shared' if lay['resident'] else 'device'} memory")
    if time_it:
        st["ms"] = cuda_ms(lambda: build.launch(PR.PREEMPT_ENTRY, pargs, a["cand"].device), 5)
        if plain_time:
            st["plain_ms"] = cuda_ms(lambda: PR.preempt_batch_plain(**a), 1)
        st["bound"] = bound(preempt_work(a))
        log(f"[kernels] {label} preempt_batch: kernel {st['ms']:.4f} ms ({st['ms'] * 1000 / p:.3f} us a step), "
            f"plain {st.get('plain_ms', float('nan')):.4f} ms, bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    return st


def without_reuse(arrays):
    """The same preemption round with a new spec at every step: the valid
    preemptors' priorities alternate p, p + 1 (the victims below them do
    not change)."""
    import numpy as np

    out = dict(arrays)
    live = arrays["p_valid"]
    out["p_prio"] = arrays["p_prio"] + (live & (np.arange(live.shape[0]) % 2 == 1)).astype(np.int32)
    return out


def usage_case(n, r, nominees, b):
    """A seeded usage bank [n, r] and `nominees` overlay entries (about two
    a node: duplicate rows) padded by sentinel rows to `b`, on the card."""
    g = torch.Generator().manual_seed(6)
    requested = torch.randint(0, 10**12, (n, r), generator=g).cuda()
    pod_count = torch.randint(0, 110, (n,), generator=g).int().cuda()
    rows = torch.full((b,), n, dtype=torch.int32)
    rows[:nominees] = torch.randperm(nominees, generator=g).int() % max(n - 12, 1)
    vecs = torch.zeros((b, r), dtype=torch.int64)
    vecs[:nominees, 0] = 6000
    vecs[:nominees, 1] = 2 << 30
    cnt = (rows < n).int()
    return requested, pod_count, rows.cuda(), vecs.cuda(), cnt.cuda()


def compare_fold_usage(label, n, r, nominees, time_it: bool):
    """Hold fold_usage against its plain version with `nominees` entries
    (about two a node: duplicate rows) padded by sentinel rows to the next
    power of two, and its inverse against the bank it started from; with
    time_it, time the kernel, the plain version and the library's
    index_put_(accumulate=True) per column on the `nominees` entries alone
    (the driver's overlay has no padding), and bound it."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import fold as FO
    from kubernetes_tpu_torch.state.tensors import pow2_bucket

    b = pow2_bucket(nominees)
    requested, pod_count, rows, vecs, cnt = usage_case(n, r, nominees, b)
    kreq, kpc = requested.clone(), pod_count.clone()
    FO.fold_usage(kreq, kpc, rows, vecs, cnt)
    preq, ppc = FO.fold_usage_plain(requested.clone(), pod_count.clone(), rows, vecs, cnt)
    err = max(int((kreq - preq).abs().max()), int((kpc - ppc).abs().max()))
    check(err == 0, f"[{label}] fold_usage kernel differs from its plain version by {err}")
    FO.fold_usage(kreq, kpc, rows, -vecs, -cnt)
    check(torch.equal(kreq, requested) and torch.equal(kpc, pod_count),
          f"[{label}] fold_usage's inverse did not restore the bank")
    st = {"max_abs_err": err}
    log(f"[kernels] {label}: N={n} R={r} B={b} ({nominees} nominees): fold_usage exact, its inverse restores "
        f"the bank bit for bit")
    if time_it:
        rows, vecs, cnt = rows[:nominees].contiguous(), vecs[:nominees].contiguous(), cnt[:nominees].contiguous()
        uargs = FO.fold_usage_args(kreq, kpc, rows, vecs, cnt)
        st["ms"] = cuda_ms(lambda: build.launch(FO.FOLD_USAGE_ENTRY, uargs, kreq.device), 200)
        st["device_ms"] = device_ms(lambda: build.launch(FO.FOLD_USAGE_ENTRY, uargs, kreq.device), "fold_usage_kernel")
        st["plain_ms"] = cuda_ms(lambda: FO.fold_usage_plain(preq, ppc, rows, vecs, cnt), 20)
        st["bound"] = bound(fold_usage_work(rows, n, r))
        lr = rows.long()
        st["library_ms"] = (cuda_ms(lambda: kreq.index_put_((lr,), vecs, accumulate=True), 200)
                            + cuda_ms(lambda: kpc.index_put_((lr,), cnt, accumulate=True), 200))
        log(f"[kernels] {label} fold_usage: kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound "
            f"{st['bound'][0]:.6f} ms ({st['bound'][1]}), library {st['library_ms']:.4f} ms")
    return st


def compare_gather(label, u, n, rows, time_it: bool, seed=0, out_shift=0):
    """Hold gather_score_rows against its plain version, bit for bit, on a
    seeded [U, N] int64 score matrix holding both int64 extremes, for the
    row list `rows`: through its wrapper (the rows in pinned host memory),
    and its kernel into a device buffer and into a pinned host buffer
    `out_shift` elements past a 16-byte boundary (K past the argument
    block: the lanes on the card). With time_it, time the kernel into the
    device and into the host (one prebuilt argument block relaunched, and
    the device duration), the wrapper, the driver's fetch
    (ScoreRows.prefetch), the plain version and the library's
    torch.index_select on the card and with .cpu() after it, and bound it
    (the alternative design, a device destination and one non-blocking
    copy into pinned memory, is timed by scripts/topology_ab.py --mode
    gather)."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.scheduler.driver import ScoreRows

    g = torch.Generator().manual_seed(seed)
    score = torch.randint(-(2**62), 2**62, (u, n), generator=g, dtype=torch.int64)
    score[0, 0] = torch.iinfo(torch.int64).min
    score[-1, -1] = torch.iinfo(torch.int64).max
    score = score.cuda()
    dev = score.device
    k = len(rows)
    idx = torch.tensor(rows, dtype=torch.int32, device=dev)
    want = PP.gather_score_rows_plain(score, idx)
    want_h = want.cpu()
    got = PP.gather_score_rows(score, rows)
    check(got.is_pinned(), f"[{label}] gather_score_rows did not return pinned host rows")
    err = int((got != want_h).sum())
    lanes = idx if k > PP.GATHER_MAX_INLINE else None
    dev_out = torch.empty((k, n), dtype=torch.int64, device=dev)
    raw = torch.empty(k * n + 2, dtype=torch.int64).pin_memory()
    host_out = raw[out_shift : out_shift + k * n].view(k, n)
    dargs, hargs = PP.gather_args(score, rows, dev_out, lanes), PP.gather_args(score, rows, host_out, lanes)
    build.launch(PP.GATHER_ENTRY, dargs, dev)
    build.launch(PP.GATHER_ENTRY, hargs, dev)
    torch.cuda.synchronize()
    err += int((dev_out != want).sum()) + int((host_out != want_h).sum())
    check(err == 0, f"[{label}] gather_score_rows differs from its plain version in {err} cells")
    st = {"max_abs_err": err}
    log(f"[kernels] {label}: U={u} N={n} K={k}: gather_score_rows exact through its wrapper and into device and "
        f"pinned host memory{' (rows from the lanes)' if lanes is not None else ''}")
    if time_it:
        st["ms"] = cuda_ms(lambda: build.launch(PP.GATHER_ENTRY, dargs, dev), 200)
        st["device_ms"] = device_ms(lambda: build.launch(PP.GATHER_ENTRY, dargs, dev), "gather_rows_kernel")
        st["host_ms"] = cuda_ms(lambda: build.launch(PP.GATHER_ENTRY, hargs, dev), 200)
        st["host_device_ms"] = device_ms(lambda: build.launch(PP.GATHER_ENTRY, hargs, dev), "gather_rows_kernel")
        st["wrapper_ms"] = cuda_ms(lambda: PP.gather_score_rows(score, rows), 200)
        sig = list(rows)
        st["prefetch_ms"] = cuda_ms(lambda: ScoreRows(score, sig).prefetch(range(k)), 200)
        st["plain_ms"] = cuda_ms(lambda: PP.gather_score_rows_plain(score, idx), 200)
        st["library_ms"] = cuda_ms(lambda: torch.index_select(score, 0, idx), 200)
        # index_select launches one kernel a call: every kernel event counts
        st["library_device_ms"] = device_ms(lambda: torch.index_select(score, 0, idx), None)
        st["library_host_ms"] = cuda_ms(lambda: torch.index_select(score, 0, idx).cpu(), 200)
        st["bound"] = bound(gather_work(k, n))
        st["ctas"] = dargs.chunks * k
        log(f"[kernels] {label} gather_score_rows K={k}: kernel into the card {st['ms']:.4f} ms relaunched, "
            f"{st['device_ms']:.4f} ms device; into pinned host memory {st['host_ms']:.4f} / "
            f"{st['host_device_ms']:.4f} ms; wrapper (rows on the host) {st['wrapper_ms']:.4f} ms, ScoreRows.prefetch "
            f"{st['prefetch_ms']:.4f} ms; {st['ctas']} CTAs; plain {st['plain_ms']:.4f} ms, bound "
            f"{st['bound'][0]:.6f} ms ({st['bound'][1]}), index_select {st['library_ms']:.4f} ms relaunched, "
            f"{st['library_device_ms']:.4f} ms device, with .cpu() {st['library_host_ms']:.4f} ms")
    return st


def phase_gather_kernels():
    """gather_score_rows on its edges (K = 1, repeated rows, N * 8 not a
    multiple of 16, the host destination 8 bytes past 16, K past the
    argument block's cap) and at the config-3-hard shapes (U = 128,
    N = 10,240) with K = 128 and the driver's usual K of 1, 2 and 4, each
    beside torch.index_select in the same call."""
    compare_gather("gather edges", 1, 7, [0], time_it=False, seed=1)
    compare_gather("gather edges", 8, 1031, [5, 5, 0, 7, 5], time_it=False, seed=2)
    compare_gather("gather edges", 8, 1031, [5, 5, 0, 7, 6], time_it=False, seed=2, out_shift=1)
    compare_gather("gather edges", 40, 300, [39], time_it=False, seed=3)
    compare_gather("gather edges", 128, 2050, [i % 128 for i in range(513)], time_it=False, seed=3, out_shift=1)
    st = compare_gather("config-3-hard", 128, 10240, list(range(128))[::-1], time_it=True, seed=4)
    # the driver's usual K: one to four rows an escalated pod ranks by
    st["k_rows"] = {k: {f: v for f, v in compare_gather("config-3-hard", 128, 10240, [7, 91, 3, 120][:k],
                                                          time_it=True, seed=4 + k).items() if f != "bound"}
                    for k in (1, 2, 4)}
    return {"gather_score_rows": st}


def gang_case(enc, tight: bool):
    """The gang solve's positional arguments on the pipeline's own mask and
    score of one config-5 batch (every pod of group g on positions
    64 g .. 64 g + 63, pop order by position), and pod_valid; `tight` lets
    each node take one more pod only."""
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import solver as SO

    na, pa, sig = enc["na"], enc["pa"], enc["sig"]
    mask, score = PP.mask_and_score(na, pa, enc["ids"])
    b = sig.shape[0]
    dev = sig.device
    pod_valid = torch.ones(b, dtype=torch.bool, device=dev)
    order = SO.pop_order(torch.zeros(b, dtype=torch.int32, device=dev), torch.arange(b, dtype=torch.int32, device=dev),
                         pod_valid)
    group = (torch.arange(b, device=dev) // 64).to(torch.int32)
    count0 = na["pod_count"].long()
    allowed = count0 + 1 if tight else na["allowed_pods"].long()
    return (mask, score, pa["req"], na["alloc"] - na["requested"], count0, allowed, order, group), pod_valid


def compare_gang(enc, label, tight: bool):
    """Hold the gang kernel against its plain version, deterministic and
    with tie-noise, on the pipeline's own mask and score of one config-5
    batch (every pod of group g on positions 64 g .. 64 g + 63); `tight`
    lets each node take one more pod only, so pass 1 leaves most groups
    short and they drop. Times (through the wrapper: the kernel updates its
    carry in place, so each launch takes fresh copies), the plain
    version's time and the bound."""
    from kubernetes_tpu_torch.ops import solver as SO

    na, pa, sig = enc["na"], enc["pa"], enc["sig"]
    b = sig.shape[0]
    args, pod_valid = gang_case(enc, tight)
    mask, _, _, free0, count0, allowed, order, group = args
    nz0 = na["nonzero_req"]
    err = 0
    for det in (True, False):
        kw = dict(deterministic=det, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid, return_carry=True,
                  nz0=nz0, scoring_req=pa["scoring_req"])
        key = SO.prng_key_data(7 + 2**32)
        ka, kok, kc = SO.solve_gang(*args, key, **kw)
        pa_, pok, pc = SO.solve_gang_plain(*args, key, **kw)
        err = max(err, int((ka - pa_).abs().max()), int((kok != pok).sum()),
                  *(int((x - y).abs().max()) for x, y in zip(kc, pc)))
    check(err == 0, f"[{label}] gang kernel differs from its plain version by {err}")
    dropped = int((~kok).sum()) // 64
    check((dropped > 0) == tight, f"[{label}] {dropped} groups dropped")
    kw = dict(deterministic=False, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid, return_carry=True, nz0=nz0,
              scoring_req=pa["scoring_req"])
    st = {"max_abs_err": err, "dropped_groups": dropped, "placed": int((ka >= 0).sum()),
          "pods": int(pod_valid.sum())}
    st["ms"] = cuda_ms(lambda: SO.solve_gang(*args, key, **kw), 5)
    st["plain_ms"] = cuda_ms(lambda: SO.solve_gang_plain(*args, key, **kw), 2)
    st["bound"] = bound(gang_work(mask, sig, pod_valid, pod_valid & kok, pa, free0, count0, allowed, nz0, order,
                                  group))
    log(f"[kernels] {label}: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} B={b}: solve_gang exact "
        f"({st['placed']} placed, {dropped} of {b // 64} groups dropped); kernel {st['ms']:.4f} ms (through its "
        f"wrapper), plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    return st


def phase_gang_kernels():
    """solve_gang at the config-5 shapes (the first 4,096-pod batch of the
    full drain: 64 groups, U = 64 spec rows, N = 2,048) and at the tight
    shape with drops."""
    from kubernetes_tpu_torch.models.clusters import bench_config5

    nodes, pods = bench_config5(CONFIG5_NODES, BATCH // 64)
    enc = encode(nodes, [], pods, torch.device("cuda"))
    st = compare_gang(enc, "config-5", tight=False)
    st["tight"] = compare_gang(enc, "config-5 tight", tight=True)
    return {"solve_gang": st}, enc


def seeded_slab(template, s, seed):
    """A slab dict shaped like `template` at S rows from a numpy seed (bools,
    int32, int64 with both extremes) and a one-row padding dict, on the
    card."""
    import numpy as np

    from kubernetes_tpu_torch.state.convert import arrays_to_torch

    rng = np.random.default_rng(seed)
    slab, empty = {}, {}
    for k, v in template.items():
        shape = (s,) + v.shape[1:]
        if v.dtype == bool:
            slab[k] = rng.random(shape) < 0.5
        elif v.dtype == np.int64:
            slab[k] = rng.integers(-(2**62), 2**62, shape, dtype=np.int64)
            slab[k].flat[0], slab[k].flat[-1] = np.iinfo(np.int64).min, np.iinfo(np.int64).max
        else:
            slab[k] = rng.integers(-(2**31), 2**31 - 1, shape, dtype=v.dtype)
        empty[k] = np.asarray(v[:1]).copy()
    return slab, arrays_to_torch(slab, "cuda", copy=True), arrays_to_torch(empty, "cuda", copy=True)


def slab_template(plane):
    from kubernetes_tpu_torch.state.tensors import PodBatch, Vocab
    from kubernetes_tpu_torch.state.terms import TermBank

    return (PodBatch if plane == "stage" else TermBank)(Vocab(), 1).arrays()


def slab_gather_work(bank, lanes, live):
    """(bytes, integer operations) of a slab gather: each live lane's row of
    every array read once, the padding row read once, every output row
    written once, and the lane vectors (index, keep, column) read."""
    rb = sum(int(v[0].numel() * v.element_size()) for v in bank.values())
    return live * rb + rb + lanes * rb + 12 * lanes, 0


def slab_scatter_work(bank, n_rows):
    """(bytes, integer operations) of a row scatter: each dirty row of every
    array read once from the staged copy and written once, the indices
    read."""
    rb = sum(int(v[0].numel() * v.element_size()) for v in bank.values())
    return 2 * n_rows * rb + 4 * n_rows, 0


def slab_lanes(plane, s, lanes, live, seed):
    """A seeded slab of `plane` on the card at S rows and `lanes` lanes with
    `live` kept (repeated rows among them) and padding after: (bank, empty,
    idx, keep, col), the lanes numpy."""
    import numpy as np

    _, bank, emp = seeded_slab(slab_template(plane), s, seed)
    rng = np.random.default_rng(seed)
    idx = np.zeros(lanes, np.int32)
    idx[:live] = rng.integers(0, s, live)
    idx[: min(3, live)] = idx[0]
    keep = np.arange(lanes) < live
    col = rng.integers(0, 2 if plane == "stage" else 512, lanes).astype(np.int32)
    return bank, emp, idx, keep, col


def slab_problem(plane, case):
    """(the plane's gather problem, its plain version as a thunk)."""
    from kubernetes_tpu_torch.ingest import gather_stage_plain, stage_problem
    from kubernetes_tpu_torch.terms_plane import gather_terms_plain, term_problem

    bank, emp, idx, keep, col = case
    ti, tk, tc = (torch.from_numpy(a).cuda() for a in (idx, keep, col))
    if plane == "stage":
        return (stage_problem(bank, idx, keep, emp, col.astype(bool)),
                lambda: gather_stage_plain(bank, ti, tk, emp, tc.bool()))
    return term_problem(bank, idx, col, keep, emp), lambda: gather_terms_plain(bank, ti, tc, tk, emp)


def slab_diff(got, want) -> int:
    check(list(got) == list(want), f"the gathered keys {list(got)} are not the plain version's {list(want)}")
    return sum(int((got[k] != want[k]).sum()) + (got[k].dtype != want[k].dtype) for k in want)


def compare_slab_gather(label, plane, s, lanes, live, seed=0):
    """Hold gather_stage / gather_terms (the batch gather's one-problem
    calls, one launch each) against its plain version, bit for bit."""
    from kubernetes_tpu_torch.ingest import gather_stage
    from kubernetes_tpu_torch.terms_plane import gather_terms

    case = slab_lanes(plane, s, lanes, live, seed)
    bank, emp, idx, keep, col = case
    fn = gather_stage if plane == "stage" else gather_terms
    before = fn.launches
    got = (gather_stage(bank, idx, keep, emp, col.astype(bool)) if plane == "stage"
           else gather_terms(bank, idx, col, keep, emp))
    err = slab_diff(got, slab_problem(plane, case)[1]())
    check(err == 0 and fn.launches == before + 1, f"[{label}] {fn.__name__} differs from its plain version in {err} "
          f"cells ({fn.launches - before} launches)")
    log(f"[kernels] {label}: S={s} lanes={lanes} live={live}: {fn.__name__} exact, one launch")


def compare_slab_batch(label, shapes, time_it, seed=0):
    """Hold the batch gather (gather_batch: the pod arrays and the term
    table in ONE launch) against the plain versions, bit for bit; `shapes`
    maps each plane to (slab rows, lanes, live lanes). The wrapper also
    runs under torch.cuda.set_sync_debug_mode("error"). With time_it: the
    kernel alone (a prebuilt argument block and buffer relaunched), its
    device duration, the wrapper (lanes to pinned memory, one allocation,
    one non-blocking copy, the launch, the views), the pinned copy alone,
    the plain versions and the library yardstick (one index_select + where
    per array, summed), and the bound."""
    import numpy as np

    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import slab as SL

    cases = [(plane, slab_lanes(plane, *shape, seed + j)) for j, (plane, shape) in enumerate(shapes.items())]
    probs, plains = zip(*(slab_problem(plane, case) for plane, case in cases))
    before = SL.gather_batch.launches
    got = SL.gather_batch(list(probs))
    wants = [plain() for plain in plains]
    err = sum(slab_diff(g, w) for g, w in zip(got, wants))
    check(err == 0 and SL.gather_batch.launches == before + 1,
          f"[{label}] gather_batch differs from the plain versions in {err} cells "
          f"({SL.gather_batch.launches - before} launches)")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = SL.gather_batch(list(probs))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(sum(slab_diff(g, w) for g, w in zip(again, wants)) == 0, f"[{label}] gather_batch differs on a second call")
    st = {"max_abs_err": err, "shapes": {k: list(v) for k, v in shapes.items()}}
    log(f"[kernels] {label}: {shapes}: gather_batch exact in one launch, no synchronisation")
    if time_it:
        lanes = [SL.host_lanes(p) for p in probs]
        plan = SL.gather_plan(list(probs), [len(ln[0]) for ln in lanes])
        host = np.zeros(plan.host_bytes, np.uint8)
        plan.fill(host, lanes)
        buf = torch.empty(plan.nbytes, dtype=torch.uint8, device="cuda")
        buf[: plan.host_bytes].copy_(torch.from_numpy(host))
        args = SL.GatherBatchArgs.from_buffer_copy(plan.args)
        args.base = buf.data_ptr()
        dev = buf.device

        def launch():
            build.launch(SL.GATHER_ENTRY, args, dev)

        launch()
        check(sum(slab_diff(g, w) for g, w in zip(plan.views(buf), wants)) == 0,
              f"[{label}] the relaunched gather differs from the plain versions")
        pinned = torch.empty(plan.host_bytes, dtype=torch.uint8, pin_memory=True)
        st["ms"] = cuda_ms(launch, 200)
        st["device_ms"] = device_ms(launch, "gather_batch_kernel")
        st["wrapper_ms"] = cuda_ms(lambda: SL.gather_batch(list(probs)), 200)
        st["copy_ms"] = cuda_ms(lambda: buf[: plan.host_bytes].copy_(pinned, non_blocking=True), 200)
        st["plain_ms"] = cuda_ms(lambda: [plain() for plain in plains], 50)
        tensors = []
        for p, (idx, keep, _) in zip(probs, lanes):
            tensors.append((p, torch.from_numpy(idx).cuda().long(), torch.from_numpy(keep).cuda()))

        def library():
            for p, il, tk in tensors:
                for k, v in p.slab.items():
                    g = torch.index_select(v, 0, il)
                    torch.where(tk.reshape((-1,) + (1,) * (g.ndim - 1)), g, p.empty[k])

        st["library_ms"] = cuda_ms(library, 50)
        work = [slab_gather_work(p.slab, len(ln[0]), int(ln[1].sum())) for p, ln in zip(probs, lanes)]
        st["bound"] = bound((sum(w[0] for w in work), 0))
        st["ctas"] = plan.n_ctas
        st["segments"] = len(plan.segments)
        log(f"[kernels] {label} gather_batch: kernel {st['ms']:.4f} ms relaunched, {st['device_ms']:.4f} ms device "
            f"duration, {st['wrapper_ms']:.4f} ms through its wrapper (the pinned copy alone {st['copy_ms']:.4f} ms), "
            f"{plan.n_ctas} CTAs for {len(plan.segments)} segments; plain {st['plain_ms']:.4f} ms, bound "
            f"{st['bound'][0]:.6f} ms ({st['bound'][1]}), library index_select + where per array "
            f"{st['library_ms']:.4f} ms")
    return st


def compare_slab_scatter(label, plane, s, rows, time_it, seed=0):
    """Hold scatter_rows against its plain version (one index_copy_ per
    array) on a seeded slab: `rows` dirty rows taken from host truth (the
    planes' flush), duplicates carrying identical bytes; with time_it, time
    the kernel alone (the staging buffer already on the card), the plane's
    flush through its wrapper (packing into pinned memory and the one copy
    included), also with its layout rebuilt each call (cold), the plain
    version and its library yardstick, and bound it."""
    import numpy as np

    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.state.convert import arrays_to_torch

    template = slab_template(plane)
    host, dev, _ = seeded_slab(template, s, seed)
    upd_all, _, _ = seeded_slab(template, max(len(rows), 1), seed + 1)
    upd = {k: v[: len(rows)].copy() for k, v in upd_all.items()}
    for j in range(1, len(rows)):
        if rows[j] in rows[:j]:
            for v in upd.values():
                v[j] = v[rows.index(rows[j])]
    idx = np.asarray(rows, np.int64)
    truth = {k: v.copy() for k, v in host.items()}  # host truth holding the dirty rows
    for k, v in truth.items():
        v[idx] = upd[k]
    want = arrays_to_torch(host, "cuda", copy=True)
    ti = torch.from_numpy(idx).cuda()
    tu = arrays_to_torch(upd, "cuda", copy=True)
    SL.scatter_rows(dev, idx, truth)
    SL.scatter_rows_plain(want, ti, tu)
    err = sum(int((dev[k] != want[k]).sum()) for k in want)
    check(err == 0, f"[{label}] scatter_rows differs from its plain version in {err} cells")
    st = {"max_abs_err": err}
    log(f"[kernels] {label}: S={s} R={len(rows)}: scatter_rows exact, taken from host truth")
    if time_it:
        prob = SL.ScatterProblem(dev, idx, truth)
        lanes = [SL.scatter_lanes(prob)]
        plan = SL.ScatterPlan([prob], [len(rows)], [lanes[0][1]])
        staging = np.zeros(plan.nbytes, np.uint8)
        plan.fill(staging, [prob], lanes)
        buf = torch.from_numpy(staging).cuda()
        sargs = SL.ScatterArgs.from_buffer_copy(plan.args[0])
        sargs.base = buf.data_ptr()
        st["ms"] = cuda_ms(lambda: build.launch(SL.SCATTER_ENTRY, sargs, ti.device), 200)
        st["device_ms"] = device_ms(lambda: build.launch(SL.SCATTER_ENTRY, sargs, ti.device), "scatter_slab_kernel")
        st["wrapper_ms"] = cuda_ms(lambda: SL.scatter_rows(dev, idx, truth), 50)

        def cold():
            SL._SCATTER_LAYOUTS.clear()
            SL.scatter_rows(dev, idx, truth)

        st["cold_wrapper_ms"] = cuda_ms(cold, 50)
        st["plain_ms"] = cuda_ms(lambda: SL.scatter_rows_plain(want, ti, tu), 50)

        def library():
            for k, u in tu.items():
                want[k].index_copy_(0, ti, u)

        st["library_ms"] = cuda_ms(library, 50)
        st["bound"] = bound(slab_scatter_work(dev, len(rows)))
        st["ctas"] = plan.args[0].n_ctas
        log(f"[kernels] {label} scatter_rows: kernel {st['ms']:.4f} ms relaunched, {st['device_ms']:.4f} ms device, "
            f"{st['ctas']} CTAs; the plane's flush through its wrapper {st['wrapper_ms']:.4f} ms (its layout "
            f"rebuilt each call {st['cold_wrapper_ms']:.4f}), plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms "
            f"({st['bound'][1]}), library index_copy_ per array {st['library_ms']:.4f} ms")
    return st


def mirror_patches(mirror, n_node, n_usage, n_sig, n_pat, seed):
    """A mirror sync's six patch problems on clones of `mirror`'s resident
    banks, host truth its host banks with every row changed: node rows,
    usage rows (not node rows), the signature and pattern banks' counts
    (their node rows) and metadata (signature and pattern rows). Returns
    (problems, the clones)."""
    import numpy as np

    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.state.cache import USAGE_KEYS

    rng = np.random.default_rng(seed)
    dn, de, dp = ({k: v.clone() for k, v in d.items()} for d in mirror.device_arrays())
    hn, he, hp = ({k: np.roll(v, 1, axis=0) if k != "counts" else v + 1 for k, v in d.items()}
                  for d in (mirror.nodes.arrays(), mirror.eps.arrays(), mirror.pats.arrays()))
    n = next(iter(dn.values())).shape[0]
    rows = rng.permutation(n)
    # Python ints, as the mirror's sorted sets of dirty rows
    node_rows, usage_rows = sorted(rows[:n_node].tolist()), sorted(rows[n_node : n_node + n_usage].tolist())
    count_rows = sorted(rows[: n_node + n_usage].tolist())
    sig_rows = sorted(rng.choice(de["valid"].shape[0], n_sig, replace=False).tolist())
    pat_rows = sorted(rng.choice(dp["valid"].shape[0], n_pat, replace=False).tolist())
    problems = [SL.ScatterProblem(dn, node_rows, hn, tuple(k for k in hn if k != "image_scaled")),
                SL.ScatterProblem(dn, usage_rows, hn, USAGE_KEYS),
                SL.ScatterProblem(de, count_rows, he, ("counts",)),
                SL.ScatterProblem(de, sig_rows, he, tuple(k for k in he if k != "counts")),
                SL.ScatterProblem(dp, node_rows, hp, ("counts",)),
                SL.ScatterProblem(dp, pat_rows, hp, tuple(k for k in hp if k != "counts"))]
    return problems, (dn, de, dp)


def compare_mirror_scatter(label, mirror, time_it, seed=0):
    """A mirror sync's six patches (ops/slab.scatter_batch) in ONE launch
    against one index_copy_ per array per problem; with time_it, the kernel
    alone and the one call through its wrapper, also with its layout
    rebuilt each call (cold). The parent's six calls are timed beside it by
    scripts/topology_ab.py --mode scatter."""
    import numpy as np

    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import slab as SL

    sizes = (32, 128, 8, 4)  # node rows, usage rows, signature rows, pattern rows
    problems, banks = mirror_patches(mirror, *sizes, seed)
    want = [{k: v.clone() for k, v in d.items()} for d in banks]
    for p in problems:
        d = want[next(i for i, b in enumerate(banks) if b is p.slab)]
        ti = torch.tensor(np.asarray(p.rows, np.int64), device="cuda")
        for k in p.keys:
            d[k].index_copy_(0, ti, torch.from_numpy(np.take(p.host[k], np.asarray(p.rows), axis=0)).cuda())
    before = SL.scatter_batch.launches
    SL.scatter_batch(problems)
    launches = SL.scatter_batch.launches - before
    err = sum(int((b[k] != w[k]).sum()) for b, w in zip(banks, want) for k in w)
    check(err == 0 and launches == 1, f"[{label}] the mirror sync's scatter differs in {err} cells or took "
                                      f"{launches} launches")
    lanes = [SL.scatter_lanes(p) for p in problems]
    plan = SL.ScatterPlan(problems, [ln[0].shape[0] for ln in lanes], [ln[1] for ln in lanes])
    st = {"max_abs_err": err, "segments": len(plan.segments), "problems": len(problems),
          "rows": [len(p.rows) for p in problems]}
    log(f"[kernels] {label}: the mirror sync's six patches {st['rows']} in one scatter launch "
        f"({st['segments']} segments): exact")
    if time_it:
        staging = np.zeros(plan.nbytes, np.uint8)
        plan.fill(staging, problems, lanes)
        buf = torch.from_numpy(staging).cuda()
        sargs = SL.ScatterArgs.from_buffer_copy(plan.args[0])
        sargs.base = buf.data_ptr()
        st["ms"] = cuda_ms(lambda: build.launch(SL.SCATTER_ENTRY, sargs, buf.device), 200)
        st["device_ms"] = device_ms(lambda: build.launch(SL.SCATTER_ENTRY, sargs, buf.device), "scatter_slab_kernel")
        st["wrapper_ms"] = cuda_ms(lambda: SL.scatter_batch(problems), 50)

        def cold():
            SL._SCATTER_LAYOUTS.clear()
            SL.scatter_batch(problems)

        st["cold_wrapper_ms"] = cuda_ms(cold, 50)
        st["ctas"] = plan.args[0].n_ctas
        st["bound"] = bound((sum(2 * len(p.rows) * SL.row_bytes(p.slab[k]) + 4 * len(p.rows)
                                 for p in problems for k in p.keys), 0))
        log(f"[kernels] {label} mirror sync scatter: kernel {st['ms']:.4f} ms relaunched, {st['device_ms']:.4f} ms "
            f"device, {st['ctas']} CTAs; one call through its wrapper {st['wrapper_ms']:.4f} ms (its layout rebuilt "
            f"each call {st['cold_wrapper_ms']:.4f} ms); bound {st['bound'][0]:.6f} ms")
    return st


def phase_slab_kernels():
    """The ingest and term planes' kernels: the batch gather through its
    one-problem calls on their edges (S not a multiple of the block, one
    lane), both problems in one launch on edges (no live lane, one lane)
    and at the config-3 (U = TT = 128 lanes, 100 live, slabs of 256) and
    config-5 (U = 64 on a 1,024-row slab; TT = 16 lanes, none live: config
    5 has no terms) shapes; the scatter on its edges (duplicates, the last
    row, an empty dirty set) and at config 5's restage flush (64 dirty rows
    of a 1,024-row slab)."""
    for plane in ("stage", "terms"):
        compare_slab_gather("slab edges", plane, 37, 48, 5, seed=1)
        compare_slab_gather("slab edges", plane, 3, 1, 1, seed=2)
        compare_slab_scatter("slab edges", plane, 256, [3, 17, 17, 0, 255, 22], time_it=False, seed=3)
        compare_slab_scatter("slab edges", plane, 37, [], time_it=False, seed=4)
    compare_slab_batch("slab edges", {"stage": (37, 48, 0), "terms": (3, 1, 1)}, time_it=False, seed=10)
    compare_slab_batch("slab edges", {"stage": (1, 1, 1), "terms": (40, 1031, 700)}, time_it=False, seed=12)
    stats = {
        "gather_batch": compare_slab_batch("config-3", {"stage": (256, 128, 100), "terms": (256, 128, 100)},
                                           time_it=True, seed=5),
        "scatter_rows": compare_slab_scatter("config-5", "stage", 1024, list(range(0, 1024, 16)), time_it=True,
                                             seed=7),
    }
    compare_slab_scatter("slab edges", "stage", 5, [4], time_it=False, seed=9)
    info5 = compare_slab_batch("config-5", {"stage": (1024, 64, 64), "terms": (256, 16, 0)}, time_it=True, seed=8)
    stats["gather_batch"]["config-5"] = {k: info5[k] for k in ("ms", "device_ms", "wrapper_ms", "copy_ms", "ctas")}
    stats["gather_batch"]["config-5"]["bound_ms"] = info5["bound"][0]
    return stats


def phase_preempt_kernels():
    """preempt_batch on every branch and at the config-6 shapes; fold_usage
    likewise. Returns {kernel: stats}."""
    from kubernetes_tpu_torch.models.clusters import (
        bench_config6,
        random_preempt_arrays,
        random_preemption_cluster,
    )
    from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot
    from kubernetes_tpu_torch.scheduler.preemption import preempt_arrays

    for seed, (p, n, v, r) in enumerate([(48, 40, 8, 8), (24, 20, 64, 8), (20, 16, 8, 16), (40, 1100, 8, 8)]):
        compare_preempt(random_preempt_arrays(seed, p, n, v, r), f"preempt all-branches {seed}", time_it=False)
        runs = compare_preempt(random_preempt_arrays(seed, p, n, v, r, runs=True), f"preempt runs {seed}",
                               time_it=False)
        check(runs["solo_steps"] > 0 and runs["evaluated"] < p * n, f"preempt runs {seed}: no reuse ({runs})")
    # a carry too large for shared memory: the counted device-memory walk
    dm = compare_preempt(random_preempt_arrays(4, 64, 2100, 8, 8, runs=True), "preempt device memory",
                         time_it=True, plain_time=False)
    check(not dm["resident"] and dm["device_memory_launches"] == 1,
          f"preempt device memory: {dm['device_memory_launches']} counted device-memory launches")
    nodes, existing, pending, pdbs = random_preemption_cluster(3, n_nodes=60, n_pending=120)
    snap = Snapshot(nodes, existing)
    names = list(snap.node_infos)
    arrays, _, _ = preempt_arrays(pending[:-20], snap, pdbs=pdbs,
                                  nominated=[(names[i % len(names)], p) for i, p in enumerate(pending[-20:])])
    compare_preempt(arrays, "preempt random cluster", time_it=False)
    nodes, existing, pending = bench_config6(CONFIG6_NODES, CONFIG6_PREEMPTORS)
    arrays, _, _ = preempt_arrays(pending, Snapshot(nodes, existing))
    stats = {"preempt_batch": compare_preempt(arrays, "config-6", time_it=True)}
    p6, n6 = arrays["cand"].shape
    # the same round with a new spec at every step, and seeded runs of
    # repeated specs at the same shapes, each timed
    nr = compare_preempt(without_reuse(arrays), "config-6 no reuse", time_it=True, plain_time=False)
    # only the zero-spec padding rows after the first repeat a spec
    check(nr["solo_steps"] == p6 - CONFIG6_PREEMPTORS - 1 and nr["evaluated"] >= CONFIG6_PREEMPTORS * n6,
          f"config-6 no reuse: the walk reused rows ({nr})")
    rr = compare_preempt(random_preempt_arrays(6, p6, n6, 8, 8, runs=True), "config-6 shapes, runs", time_it=True,
                         plain_time=False)
    stats["_preempt"] = {"config-6": stats["preempt_batch"], "config-6 no reuse": nr, "config-6 shapes, runs": rr,
                         "device memory (N = 2,100)": dm}
    compare_fold_usage("fold_usage all-branches", 40, 16, 70, time_it=False)
    stats["fold_usage"] = compare_fold_usage("config-6", 512, 8, CONFIG6_PREEMPTORS - CONFIG6_BATCH, time_it=True)
    return stats


def config4_batch(n_existing: int):
    """The config-4 shapes mid-drain: the full cluster holding `n_existing`
    bound pods (pod i on node (7 i) mod N, so no node holds two pods of one
    `exclusive` value) and the next 4,096-pod batch."""
    from kubernetes_tpu_torch.models.clusters import bench_config4

    nodes, pods = bench_config4(CONFIG4_NODES, n_existing + BATCH)
    existing = [p.with_node(nodes[(7 * i) % len(nodes)].name) for i, p in enumerate(pods[:n_existing])]
    return nodes, existing, pods[n_existing:]


def config3_batch(services: bool, n_existing: int, hard: bool = False):
    """The config-3 shapes mid-drain: the full cluster holding `n_existing`
    bound pods (round-robin over the nodes) and the next 4,096-pod batch;
    with `hard`, config 3-hard (DoNotSchedule constraints)."""
    from kubernetes_tpu_torch.models.clusters import bench_config3

    nodes, pods, fn = bench_config3(CONFIG3_NODES, n_existing + BATCH, services=services, hard=hard)
    existing = [p.with_node(nodes[i % len(nodes)].name) for i, p in enumerate(pods[:n_existing])]
    return nodes, existing, pods[n_existing:], fn


# ---------------------------------------------------------------------------
# the node mesh's cluster kernels
# ---------------------------------------------------------------------------

MESH_KERNEL_SHARDS = (2, 4, 8)


def max_err(got, want) -> int:
    """The largest |a - b| over paired tensors (booleans as 0 / 1)."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in zip(got, want))


def mesh_solve_case(enc, track: bool):
    """The solve's inputs of one encoded batch as the pipeline builds them
    (solve_inputs: mask, score, residuals, pop order by three priorities),
    with the in-batch tracking when asked."""
    from kubernetes_tpu_torch.ops import pipeline as PP

    sig = enc["sig"]
    b = sig.shape[0]
    dev = sig.device
    pb = {"sig": sig, "valid": torch.ones(b, dtype=torch.bool, device=dev),
          "priority": (torch.arange(b, device=dev) % 3).to(torch.int32)}
    kw, _, inb = PP.solve_inputs(enc["na"], enc["pa"], enc["ids"], pb, None, None, enc["kinds"], True, track,
                                 ea=enc["ea"], ta=enc["ta"], au=enc["au"], xa=enc["xa"], n_buckets=enc["v"],
                                 arbiter_inputs=None)
    return kw, inb, pb


def compare_sharded_solve(enc, label, track: bool):
    """Hold the cluster solve against its plain version and the
    single-block kernel at 2, 4 and 8 shards, deterministic and with
    tie-noise (choices and the carry); time it at 8 shards with tie-noise
    (through its wrapper, which takes fresh copies of the carry), its plain
    version, and bound it (the single-device solve's work)."""
    from kubernetes_tpu_torch.ops import solver as SO
    from kubernetes_tpu_torch.parallel import sharded as PS

    kw, inb, _ = mesh_solve_case(enc, track)
    err = 0
    for det in (True, False):
        key = SO.prng_key_data(7)
        single = SO.solve_greedy(**kw, key=key, deterministic=det, return_carry=True, inb=inb)
        for shards in MESH_KERNEL_SHARDS:
            got = PS.solve_sharded(**kw, key=key, shards=shards, deterministic=det, return_carry=True, inb=inb)
            plain = PS.solve_sharded_plain(**kw, key=key, shards=shards, deterministic=det, return_carry=True,
                                           inb=inb)
            err = max(err, max_err((got[0],) + tuple(got[1]), (plain[0],) + tuple(plain[1])),
                      max_err((got[0],) + tuple(got[1]), (single[0],) + tuple(single[1])))
    name = "solve_sharded_inb" if track else "solve_sharded"
    check(err == 0, f"[{label}] {name} differs from its plain version or the single-block kernel by {err}")
    key = SO.prng_key_data(7)
    run = dict(**kw, key=key, shards=MESH_SHARDS, deterministic=False, return_carry=True, inb=inb)
    st = {"max_abs_err": err, "placed": int((got[0] >= 0).sum()), "pods": int(kw["pod_valid"].sum())}
    st["ms"] = cuda_ms(lambda: PS.solve_sharded(**run), 5)
    st["plain_ms"] = cuda_ms(lambda: PS.solve_sharded_plain(**run), 1)
    st["single_ms"] = cuda_ms(lambda: SO.solve_greedy(**kw, key=key, deterministic=False, return_carry=True,
                                                      inb=inb), 5)
    work = (kw["mask"], kw["sig"], kw["pod_valid"], enc["pa"], kw["free0"], kw["count0"], kw["allowed"], kw["nz0"],
            kw["order"])
    st["bound"] = bound(tracked_solve_work(*work, inb) if track else solve_work(*work))
    log(f"[kernels] {label} {name}: U={enc['pa']['valid'].shape[0]} N={kw['mask'].shape[1]} B={kw['order'].shape[0]},"
        f" shards {MESH_KERNEL_SHARDS}: exact against the plain version and the single-block kernel ({st['placed']} "
        f"placed); {MESH_SHARDS} shards {st['ms']:.4f} ms (through its wrapper), single block {st['single_ms']:.4f} "
        f"ms, plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    return st


# the single-device solve's cluster sizes held against each other
SOLO_LAYOUTS = (8, 16)


def compare_solve_layouts(enc, label):
    """The single-device solve at this batch's shapes (deterministic off)
    as a cluster of each of SOLO_LAYOUTS CTAs, each equal to the plain
    version (choices and carry), timed in turns (A B B A, one prebuilt
    struct a layout, fresh carries each launch through the wrapper's
    copies); returns {layout: ms} and logs ms and µs a pod beside the
    wrapper's default (ops/solver.SOLO_SHARDS)."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import solver as SO

    kw, _, _ = mesh_solve_case(enc, False)
    dev = kw["mask"].device
    key = SO.prng_key_data(7)
    want = SO.solve_greedy_plain(**kw, key=key, deterministic=False, return_carry=True)
    pods = int(kw["pod_valid"].sum())
    built = {}
    for shards in SOLO_LAYOUTS:
        pos = ("mask", "score", "req", "free0", "count0", "allowed", "order")
        rest = ("req_any", "sig", "pod_valid", "nz0", "scoring_req")
        args, out, carry, _ = SO.solve_args(*(kw[k] for k in pos), key, False, *(kw[k] for k in rest),
                                            shards=shards)
        SO.launch_solve(args, dev)
        torch.cuda.synchronize()
        err = max_err((out,) + tuple(carry), (want[0],) + tuple(want[1]))
        check(err == 0, f"[{label}] the solve at S={shards} differs from its plain version by {err}")
        built[shards] = args
    times = {k: [] for k in built}
    for k in list(built) + list(reversed(list(built))):
        times[k].append(cuda_ms(lambda: build.launch(SO.SOLVE_ENTRY, built[k], dev), 5))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"[kernels] {label} solve layouts (U={kw['mask'].shape[0]} N={kw['mask'].shape[1]} B={kw['order'].shape[0]},"
        f" {pods} pods; exact against the plain version): " + ", ".join(
            f"S={s_}{' (default)' if s_ == SO.SOLO_SHARDS else ''} {m:.4f} ms = {m * 1000 / pods:.3f} us a pod"
            for s_, m in ms.items()))
    return {f"S{s_}": m for s_, m in ms.items()}


def compare_sharded_arbiter(enc, label, time_it: bool):
    """Hold the cluster verdict scan against its plain version and the
    single-device kernel at 2, 4 and 8 shards, on the batch's own solve
    (tracking as the driver would have it); time it at 8 shards (one
    prebuilt struct relaunched) and its plain version, and bound it."""
    from kubernetes_tpu_torch.commit import arbiter as A
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import solver as SO

    na, ea, xa, ta, au, pa, ids, v, sig = (enc[k] for k in ("na", "ea", "xa", "ta", "au", "pa", "ids", "v", "sig"))
    kinds = enc["kinds"]
    b = sig.shape[0]
    dev = sig.device
    pb = {"sig": sig, "valid": torch.ones(b, dtype=torch.bool, device=dev),
          "priority": torch.zeros(b, dtype=torch.int32, device=dev)}
    track = "anti_req" in kinds or enc["ports"]
    assign, _ = PP.solve_pipeline(na, pa, ids, SO.prng_key_data(5), pb=pb, term_kinds=kinds, track_inbatch=track,
                                  ea=ea, ta=ta, au=au, xa=xa, n_buckets=v)
    args = (na, pa, ea, ta, ids, assign, pb)
    single = A.arbitrate(*args, term_kinds=kinds, n_buckets=v)
    err = 0
    for shards in MESH_KERNEL_SHARDS:
        got = A.arbitrate_sharded(shards, *args, term_kinds=kinds, n_buckets=v)
        plain = A.arbitrate_sharded_plain(shards, *args, term_kinds=kinds, n_buckets=v)
        err += int((got != plain).sum()) + int((got != single).sum())
    check(err == 0, f"[{label}] arbitrate_sharded differs from its plain version or the single-device kernel in "
          f"{err} verdicts")
    counts = [int((single == x).sum()) for x in (A.V_PLACE, A.V_DEFER, A.V_NOFIT)]
    st = {"max_abs_err": min(err, 1), "pods": b}
    msg = ""
    if time_it:
        sargs, _ = A.arbiter_args(*args, term_kinds=kinds, n_buckets=v, shards=MESH_SHARDS)
        st["ms"] = cuda_ms(lambda: build.launch(A.ARBITER_ENTRY, sargs, dev), 5)
        aargs, _ = A.arbiter_args(*args, term_kinds=kinds, n_buckets=v)
        st["single_ms"] = cuda_ms(lambda: build.launch(A.ARBITER_ENTRY, aargs, dev), 5)
        st["plain_ms"] = cuda_ms(lambda: A.arbitrate_sharded_plain(MESH_SHARDS, *args, term_kinds=kinds,
                                                                   n_buckets=v), 1)
        st["bound"] = bound(arbiter_work(na, pa, ta, pb, single, "spread_hard" in kinds, v))
        msg = (f"; {MESH_SHARDS} shards {st['ms']:.4f} ms, single-device kernel {st['single_ms']:.4f} ms, plain "
               f"{st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    log(f"[kernels] {label} arbitrate_sharded: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} "
        f"TT={ta['valid'].shape[0]} V={v} B={b}, shards {MESH_KERNEL_SHARDS}: exact against the plain version and "
        f"the single-device kernel (verdicts place/defer/nofit {counts}){msg}")
    return st


def compare_sharded_fold(enc, label):
    """Hold the sharded commit fold against its plain version and the
    single-device kernel at 2, 4 and 8 shards, on the fold program of the
    batch's placed pods; time it at 8 shards (one prebuilt struct
    relaunched), its plain version and the library's index_put_ per bank,
    and bound it."""
    from kubernetes_tpu_torch.commit.fold import plan_fold
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import fold as FO
    from kubernetes_tpu_torch.ops import solver as SO
    from kubernetes_tpu_torch.state.convert import arrays_to_torch
    from kubernetes_tpu_torch.state.tensors import pow2_bucket

    na, ea, xa = enc["na"], enc["ea"], enc["xa"]
    kw, inb, _ = mesh_solve_case(enc, False)
    assign = SO.solve_greedy(**kw, key=SO.prng_key_data(7), inb=inb).tolist()
    pods = enc["pods"]
    b = len(pods)
    prog = plan_fold(enc["mirror"], [(pods[i], assign[i]) for i in range(b) if assign[i] >= 0], pow2_bucket(b), 16)
    check(prog is not None, f"[{label}] the fold plan overflowed a bank")
    ctl = arrays_to_torch({k: getattr(prog, k) for k in ("rows", "req", "nz", "cnt", "sig", "pat_row", "pat_col",
                                                         "pat_cnt")}, na["valid"].device)
    banks = (na["requested"], na["nonzero_req"], na["pod_count"], ea["counts"], xa["counts"])
    single = [x.clone() for x in banks]
    FO.fold_commit_banks(*single, **ctl)
    err = 0
    for shards in MESH_KERNEL_SHARDS:
        got = [x.clone() for x in banks]
        plain = [x.clone() for x in banks]
        FO.fold_commit_sharded(shards, *got, **ctl)
        FO.fold_commit_sharded_plain(shards, *plain, **ctl)
        err = max(err, max_err(got, plain), max_err(got, single))
    check(err == 0, f"[{label}] fold_commit_sharded differs from its plain version or the single-device kernel by "
          f"{err}")
    oargs = FO.ShardedFoldArgs(FO.fold_args(*got, **ctl), MESH_SHARDS, na["valid"].shape[0] // MESH_SHARDS)
    st = {"max_abs_err": err}
    st["ms"] = cuda_ms(lambda: build.launch(FO.FOLD_SHARDED_ENTRY, oargs, na["valid"].device), 200)
    st["device_ms"] = device_ms(lambda: build.launch(FO.FOLD_SHARDED_ENTRY, oargs, na["valid"].device),
                                "fold_commit_sharded_kernel")
    st["plain_ms"] = cuda_ms(lambda: FO.fold_commit_sharded_plain(MESH_SHARDS, *plain, **ctl), 5)
    st["bound"] = bound(fold_work(prog, na["requested"].shape[1]))
    st["library_ms"] = library_fold_ms(got, ctl, prog.pods)
    lib = st["library_ms"]
    log(f"[kernels] {label} fold_commit_sharded: N={na['valid'].shape[0]} B={prog.rows.shape[0]} ({prog.pods} pods), "
        f"shards {MESH_KERNEL_SHARDS}: exact against the plain version and the single-device kernel; "
        f"{MESH_SHARDS} shards {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms "
        f"({st['bound'][1]})" + (f", library {lib:.4f} ms" if lib is not None else ""))
    return st


def compare_sharded_fold_usage(label, n, r, nominees):
    """fold_usage_sharded against its plain version and the single-device
    kernel at 2, 4 and 8 shards on compare_fold_usage's entries (duplicate
    rows, sentinel pads), its inverse restoring the bank; timed at 8
    shards on the unpadded entries, with the library's index_put_ per
    column, and bounded."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import fold as FO
    from kubernetes_tpu_torch.state.tensors import pow2_bucket

    b = pow2_bucket(nominees)
    requested, pod_count, rows, vecs, cnt = usage_case(n, r, nominees, b)
    sreq, spc = requested.clone(), pod_count.clone()
    FO.fold_usage(sreq, spc, rows, vecs, cnt)
    err = 0
    for shards in MESH_KERNEL_SHARDS:
        kreq, kpc = requested.clone(), pod_count.clone()
        FO.fold_usage_sharded(shards, kreq, kpc, rows, vecs, cnt)
        preq, ppc = FO.fold_usage_sharded_plain(shards, requested.clone(), pod_count.clone(), rows, vecs, cnt)
        err = max(err, max_err((kreq, kpc), (preq, ppc)), max_err((kreq, kpc), (sreq, spc)))
        FO.fold_usage_sharded(shards, kreq, kpc, rows, -vecs, -cnt)
        check(torch.equal(kreq, requested) and torch.equal(kpc, pod_count),
              f"[{label}] fold_usage_sharded's inverse did not restore the bank at {shards} shards")
    check(err == 0, f"[{label}] fold_usage_sharded differs from its plain version or the single-device kernel by {err}")
    rows, vecs, cnt = rows[:nominees].contiguous(), vecs[:nominees].contiguous(), cnt[:nominees].contiguous()
    uargs = FO.ShardedFoldUsageArgs(FO.fold_usage_args(kreq, kpc, rows, vecs, cnt), MESH_SHARDS, n // MESH_SHARDS)
    st = {"max_abs_err": err}
    st["ms"] = cuda_ms(lambda: build.launch(FO.FOLD_USAGE_SHARDED_ENTRY, uargs, kreq.device), 200)
    st["device_ms"] = device_ms(lambda: build.launch(FO.FOLD_USAGE_SHARDED_ENTRY, uargs, kreq.device),
                                "fold_usage_sharded_kernel")
    st["plain_ms"] = cuda_ms(lambda: FO.fold_usage_sharded_plain(MESH_SHARDS, preq, ppc, rows, vecs, cnt), 20)
    st["bound"] = bound(fold_usage_work(rows, n, r))
    lr = rows.long()
    st["library_ms"] = (cuda_ms(lambda: kreq.index_put_((lr,), vecs, accumulate=True), 200)
                        + cuda_ms(lambda: kpc.index_put_((lr,), cnt, accumulate=True), 200))
    log(f"[kernels] {label} fold_usage_sharded: N={n} R={r} B={b} ({nominees} nominees), shards {MESH_KERNEL_SHARDS}: "
        f"exact against the plain version and the single-device kernel, its inverse restores the bank; "
        f"{MESH_SHARDS} shards {st['ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms "
        f"({st['bound'][1]}), library {st['library_ms']:.4f} ms")
    return st


def compare_sharded_gang(enc, label):
    """The cluster solve's gang mode (both passes in one launch) against
    its plain version and the single-block gang kernel at 2, 4 and 8
    shards, deterministic and with tie-noise, on compare_gang's config-5
    batch; timed at 8 shards (through its wrapper), its plain version, and
    bounded (the gang solve's work)."""
    from kubernetes_tpu_torch.ops import solver as SO
    from kubernetes_tpu_torch.parallel import sharded as PS

    na, pa, sig = enc["na"], enc["pa"], enc["sig"]
    b = sig.shape[0]
    args, pod_valid = gang_case(enc, False)
    mask, _, _, free0, count0, allowed, order, group = args
    nz0 = na["nonzero_req"]
    key = SO.prng_key_data(7 + 2**32)
    err = 0
    for det in (True, False):
        kw = dict(deterministic=det, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid, return_carry=True,
                  nz0=nz0, scoring_req=pa["scoring_req"])
        single = SO.solve_gang(*args, key, **kw)
        for shards in MESH_KERNEL_SHARDS:
            got = PS.solve_gang_sharded(*args, key, shards, **kw)
            plain = PS.solve_gang_sharded_plain(*args, key, shards, **kw)
            flat = lambda o: (o[0], o[1]) + tuple(o[2])  # noqa: E731
            err = max(err, max_err(flat(got), flat(plain)), max_err(flat(got), flat(single)))
    check(err == 0, f"[{label}] solve_gang_sharded differs from its plain version or the single-block kernel by {err}")
    kw = dict(deterministic=False, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid, return_carry=True, nz0=nz0,
              scoring_req=pa["scoring_req"])
    st = {"max_abs_err": err, "pods": int(pod_valid.sum())}
    st["ms"] = cuda_ms(lambda: PS.solve_gang_sharded(*args, key, MESH_SHARDS, **kw), 5)
    st["plain_ms"] = cuda_ms(lambda: PS.solve_gang_sharded_plain(*args, key, MESH_SHARDS, **kw), 1)
    st["bound"] = bound(gang_work(mask, sig, pod_valid, pod_valid & got[1], pa, free0, count0, allowed, nz0, order,
                                  group))
    log(f"[kernels] {label} solve_gang_sharded: U={pa['valid'].shape[0]} N={na['valid'].shape[0]} B={b}, shards "
        f"{MESH_KERNEL_SHARDS}: exact against the plain version and the single-block kernel; {MESH_SHARDS} shards "
        f"{st['ms']:.4f} ms (through its wrapper), plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms "
        f"({st['bound'][1]})")
    return st


def phase_mesh_kernels(enc3, enc4, enc3h, enc5):
    """The node mesh's kernels at the main path's shapes: the solve at the
    config-3 shapes, tracked at the config-4 shapes, its gang mode at the
    config-5 shapes; the arbiter at the config-3-hard shapes (and, for
    information, config-4's); the commit fold at the config-3 shapes; the
    usage fold at the config-6 nominee shapes. Returns {kernel: stats}."""
    stats = {
        "solve_sharded": compare_sharded_solve(enc3, "config-3", track=False),
        "solve_sharded_inb": compare_sharded_solve(enc4, "config-4", track=True),
        "solve_gang_sharded": compare_sharded_gang(enc5, "config-5"),
        "arbitrate_sharded": compare_sharded_arbiter(enc3h, "config-3-hard", time_it=True),
        "fold_commit_sharded": compare_sharded_fold(enc3, "config-3"),
        "fold_usage_sharded": compare_sharded_fold_usage("config-6", 512, 8, CONFIG6_PREEMPTORS - CONFIG6_BATCH),
    }
    compare_sharded_arbiter(enc4, "config-4", time_it=False)
    return stats


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
    # the score kernel's RTCR branch and component mode at the same shapes
    stats.update(compare_policy_scores(e["na"], e["pa"], "config-2"))
    # the config-3 shapes mid-drain (50,000 pods bound), with and without
    # Services; the timed shapes are those with Services (every kernel runs)
    # (the kernels line keeps the timings with Services, the shapes of the
    # times before the redesign; the spread score is also timed at TT = 128)
    topo = {}
    for services in (False, True):
        nodes, existing, pods, fn = config3_batch(services, CONFIG3_PODS // 2)
        enc = encode(nodes, existing, pods, dev, fn)
        label = "config-3" + (" + Services" if services else "")
        topo[services] = compare_topology(enc, label, time_it=True)
    stats.update(topo[True])
    # the score kernel at the config-3 shapes (N = 10,240) in all three modes
    score3 = compare_score_shapes(enc["na"], enc["pa"], "config-3")
    # the all-branches inter-pod cluster: every term kind in the batch and
    # among the bound pods (negative weights), every selector kind,
    # namespaces, zone / hostname / rack keys, nodes without a key,
    # fallback nodes, the first-pod escape, host ports
    nodes, existing, pods = random_cluster(13, 700, 600, 2500, overflow_nodes=8, topology=True, interpod=True)
    compare_interpod(encode(nodes, existing, pods, dev), "inter-pod all-branches", time_it=False)
    # the config-4 shapes mid-drain (10,000 pods bound)
    nodes, existing, pods = config4_batch(CONFIG4_PODS // 2)
    enc4 = encode(nodes, existing, pods, dev)
    stats.update(compare_interpod(enc4, "config-4", time_it=True))
    # the same kernel at a config-4 pod's extender /filter request (U = 16, one live row)
    stats["_request4"] = extender_request_kernels()
    # the commit plane on the all-branches cluster: DoNotSchedule spread on
    # zone and hostname keys beside every inter-pod kind and host ports
    nodes, existing, pods = random_cluster(14, 500, 600, 1500, overflow_nodes=6, topology=True, hard_spread=True,
                                           interpod=True, pending_affinity=False, pending_ports=True)
    compare_commit(encode(nodes, existing, pods, dev), "commit all-branches", time_it=False)
    # the config-3-hard shapes mid-drain (50,000 pods bound); then the
    # arbiter at the config-4 shapes (the path where it runs every batch)
    nodes, existing, pods, _ = config3_batch(False, CONFIG3_PODS // 2, hard=True)
    enc3h = encode(nodes, existing, pods, dev)
    hard = compare_commit(enc3h, "config-3-hard", time_it=True)
    # the extender's filter_mask at the config-3-hard and config-4 batch shapes
    compare_filter_mask(enc_filter_inputs(enc3h), "config-3-hard filter_mask", time_it=False)
    compare_filter_mask(enc_filter_inputs(enc4), "config-4 filter_mask", time_it=False)
    log(f"[kernels] config-3-hard arbitrate (information): kernel {hard['arbitrate']['ms']:.4f} ms, "
        f"plain {hard['arbitrate']['plain_ms']:.4f} ms")
    stats.update(hard)
    stats.update(compare_commit(enc4, "config-4", time_it=True, parts=("arbitrate",)))
    stats.update(phase_preempt_kernels())
    stats.update(phase_gather_kernels())
    gang, enc5 = phase_gang_kernels()
    stats.update(gang)
    stats.update(phase_slab_kernels())
    compare_mirror_scatter("config-3", enc["mirror"], time_it=False, seed=1)
    stats["scatter_rows"]["mirror sync"] = compare_mirror_scatter("config-4", enc4["mirror"], time_it=True, seed=2)
    stats.update(phase_mesh_kernels(enc, enc4, enc3h, enc5))
    # the redesigned walk at 8 and 16 CTAs on one device, at the config-2
    # and config-3 shapes, and the walks' per-pod summary
    layouts = {"config-2": compare_solve_layouts(e, "config-2"), "config-3": compare_solve_layouts(enc, "config-3")}
    stats["_redesign"] = redesign_summary(stats, hard["arbitrate"], layouts)
    score2 = {k: stats[k] for k in ("score_matrix", "score_matrix[rtcr]", "score_components")}
    stats["_redesign"]["victim search and score matrix"] = victim_search_and_score_summary(stats.pop("_preempt"), score2, score3)
    stats["_redesign"]["spread filter and feasibility mask"] = spread_and_mask_summary(stats["filter_mask"],
                                                                                       hard["spread_filter"])
    stats["_redesign"]["spread score and term match"] = spread_and_match_summary(topo[False], topo[True],
                                                                                 stats["match_terms[plan]"])
    stats["_redesign"]["inter-pod filter and selector spread"] = interpod_and_selector_summary(
        stats["interpod_filter"], stats["selector_spread_score"])
    # the kernels at their launch latency: the relaunch mean beside the device duration
    latency = {k: [stats[k]["ms"], stats[k]["device_ms"]] for k in LATENCY_ROWS if "device_ms" in stats[k]}
    stats["_redesign"]["inter-pod filter and selector spread"]["launch-latency rows [relaunched, device] ms"] = latency
    log("[redesign] launch-latency rows, relaunch mean / device duration: "
        + ", ".join(f"{k} {ms:.4f} / {d:.4f} ms" for k, (ms, d) in latency.items()))
    stats["_redesign"]["batch slab gather"] = slab_gather_summary(stats["gather_batch"])
    stats["_redesign"]["score-row gather and row scatter"] = score_gather_and_scatter_summary(
        stats["gather_score_rows"], stats["scatter_rows"])
    # the table rows that carried only a relaunch mean
    gaps = {k: [stats[k]["ms"], stats[k]["device_ms"]] for k in ("interpod_score", "fold_commit_sharded",
                                                                  "fold_usage_sharded")}
    stats["_redesign"]["score-row gather and row scatter"]["table gaps [relaunched, device] ms"] = gaps
    log("[redesign] table gaps, relaunch mean / device duration: "
        + ", ".join(f"{k} {ms:.4f} / {d:.4f} ms" for k, (ms, d) in gaps.items()))
    return stats


# the two kernels' times before their redesign (PERF.md's device-program
# table: chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W, the kernel alone):
# the spread filter's four kernels and the match_terms launch its wrapper
# made first, at the config-3-hard shapes; the mask at the config-2 shapes;
# the extender's filter_mask through its wrapper
BEFORE_MS = {"spread_filter": 0.0928, "spread_filter_match_terms": 0.0138, "filter_mask": 0.0384,
             "pipeline.filter_mask": 0.3984,
             # the spread score's four kernels and its match launch, and the
             # match kernel, at the config-3 + Services shapes
             "spread_score": 0.1087, "spread_score_match_terms": 0.0127, "match_terms": 0.0127,
             # the inter-pod filter's three kernels at the config-4 shapes and
             # the selector spread's one block a row at the config-3 +
             # Services shapes, the kernel alone, relaunched
             "interpod_filter": 0.0197, "selector_spread_score": 0.0654}


# the kernels PERF.md lists at their launch latency
LATENCY_ROWS = ("gather_batch", "scatter_rows", "fold_commit_banks", "fold_usage",
                "inbatch_port_conflict")


# the slab gathers before the batch gather, PERF.md's device-program table
# (chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W): gather_stage and
# gather_terms at the config-3 shapes, two launches a batch
BEFORE_MS["slab_gathers"] = {"relaunched": [0.0155, 0.0103], "device": [0.0049, 0.0018]}


def slab_gather_summary(gb):
    """The batch gather at the config-3 and config-5 shapes (relaunched,
    device, through its wrapper, the pinned copy alone, CTAs, the bound)
    beside the two launches before."""
    keys = ("ms", "device_ms", "wrapper_ms", "copy_ms", "ctas")
    out = {"config-3": {**{k: gb[k] for k in keys}, "bound_ms": gb["bound"][0],
                        "before_ms": BEFORE_MS["slab_gathers"]},
           "config-5": gb["config-5"]}
    for k, v in out.items():
        log(f"[redesign] batch slab gather {k}: {v['ms']:.4f} ms relaunched, {v['device_ms']:.4f} ms device, "
            f"{v['wrapper_ms']:.4f} ms through its wrapper (pinned copy {v['copy_ms']:.4f} ms), {v['ctas']} CTAs, "
            f"bound {v['bound_ms']:.6f} ms")
    return out


# the score-row gather and the row scatter before their redesign (PERF.md's
# device-program table, chip_smoke.py on NVIDIA H100 80GB HBM3, 700.00 W):
# gather_score_rows at the config-3-hard shapes (K = 128; the driver's K of
# 1, 2, 4: device only), one block row a gathered row, into a device buffer;
# scatter_rows at config 5's restage flush, one block row an array
BEFORE_MS["gather_score_rows"] = {"K=128": {"ms": 0.0184, "device_ms": 0.0049},
                                  "K=1": {"device_ms": 0.0013}, "K=2": {"device_ms": 0.0013},
                                  "K=4": {"device_ms": 0.0014}}
BEFORE_MS["scatter_rows"] = {"ms": 0.0139, "device_ms": 0.0034, "wrapper_ms": 0.3778}


def score_gather_and_scatter_summary(gsr, sc):
    """gather_score_rows at K = 128 and the driver's K (into the card and
    into pinned host memory, relaunched and by device duration; the
    wrapper, the driver's fetch; index_select and index_select(...).cpu())
    and the row scatter at config 5's restage flush and a mirror sync's six
    patches (the wrapper warm and with its layout rebuilt each call), each
    beside its time before."""
    fields = ("ms", "device_ms", "host_ms", "host_device_ms", "wrapper_ms", "prefetch_ms",
              "library_ms", "library_device_ms", "library_host_ms", "ctas")
    rows = {128: gsr, **gsr["k_rows"]}
    out = {"gather_score_rows": {f"K={k}": {**{f: r[f] for f in fields},
                                            "before": BEFORE_MS["gather_score_rows"][f"K={k}"]}
                                 for k, r in rows.items()}}
    out["gather_score_rows"]["K=128"]["bound_ms"] = gsr["bound"][0]
    for k, r in out["gather_score_rows"].items():
        log(f"[redesign] gather_score_rows {k}: into the card {r['ms']:.4f} ms relaunched / {r['device_ms']:.4f} "
            f"device, into pinned host {r['host_ms']:.4f} / {r['host_device_ms']:.4f}; wrapper {r['wrapper_ms']:.4f}, "
            f"prefetch {r['prefetch_ms']:.4f}; index_select "
            f"{r['library_ms']:.4f} / {r['library_device_ms']:.4f}, with .cpu() {r['library_host_ms']:.4f}; before "
            f"{r['before']}")
    out["scatter_rows config-5 flush"] = {**{f: sc[f] for f in ("ms", "device_ms", "wrapper_ms", "cold_wrapper_ms",
                                                                 "library_ms", "ctas")},
                                          "bound_ms": sc["bound"][0], "before": BEFORE_MS["scatter_rows"]}
    mirror = sc["mirror sync"]
    out["scatter_rows mirror sync config-4"] = {**{f: mirror[f] for f in ("ms", "device_ms", "wrapper_ms",
                                                                           "cold_wrapper_ms", "ctas", "segments",
                                                                           "rows")},
                                                "bound_ms": mirror["bound"][0]}
    for k in ("scatter_rows config-5 flush", "scatter_rows mirror sync config-4"):
        v = out[k]
        log(f"[redesign] {k}: {v['ms']:.4f} ms relaunched, {v['device_ms']:.4f} ms device, {v['wrapper_ms']:.4f} ms "
            f"through its wrapper ({v['cold_wrapper_ms']:.4f} cold), {v['ctas']} CTAs, bound {v['bound_ms']:.6f} ms; {v.get('before', '')}")
    return out


def interpod_and_selector_summary(ip4, zs):
    """The redesigned inter-pod filter (config-4 shapes; the extender's
    request is added after phase 5) and selector spread (config-3 +
    Services shapes): relaunch mean, device duration, through the wrapper,
    the bound, the time before, the CTAs a spec row and the device tables."""
    keys = ("ms", "device_ms", "wrapper_ms", "ctas_ms", "layout", "device_tables_ms")
    out = {"interpod_filter config-4": {**{k: ip4[k] for k in keys}, "rows": ip4["rows"],
                                        "bound_ms": ip4["bound"][0], "before_ms": BEFORE_MS["interpod_filter"]},
           "selector_spread_score": {**{k: zs[k] for k in keys}, "slices_ms": zs["slices_ms"],
                                     "bound_ms": zs["bound"][0], "before_ms": BEFORE_MS["selector_spread_score"]}}
    for k, v in out.items():
        log(f"[redesign] {k}: {v['ms']:.4f} ms relaunched, {v['device_ms']:.4f} ms device duration, "
            f"{v['wrapper_ms']:.4f} ms through its wrapper, before {v['before_ms']:.4f} ms, bound "
            f"{v['bound_ms']:.6f} ms; CTAs a spec row {v['ctas_ms']}")
    return out


def spread_and_match_summary(s3, s3s, plan):
    """The redesigned spread score at the config-3 shapes (TT = 128, and
    TT = 256 with Services: the shapes of the time before) and match kernel
    (one problem at the config-3 + Services shapes; the config-4 plan's
    three problems in one launch, beside the same as three launches): the
    relaunch mean and the profiler's device duration, the times before,
    the bounds, the spec rows a cluster timed and the device-memory
    tables' time."""
    out = {}
    for key, st in (("spread_score config-3", s3["spread_score"]),
                    ("spread_score config-3 + Services", s3s["spread_score"])):
        out[key] = {"ms": st["ms"], "device_ms": st["device_ms"], "wrapper_ms": st["wrapper_ms"],
                    "plain_ms": st["plain_ms"], "bound_ms": st["bound"][0],
                    "before_ms": BEFORE_MS["spread_score"] + BEFORE_MS["spread_score_match_terms"],
                    "before_parts_ms": [BEFORE_MS["spread_score"], BEFORE_MS["spread_score_match_terms"]],
                    "layout": st["layout"], "rows_ms": st["rows_ms"], "device_tables_ms": st["device_tables_ms"]}
    mt = s3s["match_terms"]
    out["match_terms config-3 + Services"] = {"ms": mt["ms"], "device_ms": mt["device_ms"], "plain_ms": mt["plain_ms"],
                                              "bound_ms": mt["bound"][0], "before_ms": BEFORE_MS["match_terms"]}
    out["match_terms[plan] config-4"] = {"ms": plan["ms"], "device_ms": plan["device_ms"],
                                         "three_launches_ms": plan["three_launches_ms"], "plain_ms": plan["plain_ms"],
                                         "bound_ms": plan["bound"][0], "problems": plan["problems"]}
    for k, v in out.items():
        log(f"[redesign] {k}: {v['ms']:.4f} ms relaunched, {v['device_ms']:.4f} ms device duration, before "
            f"{v.get('before_ms', float('nan')):.4f}, bound {v['bound_ms']:.6f} ms, plain {v['plain_ms']:.4f} ms"
            + (f", by rows a cluster {v['rows_ms']}" if "rows_ms" in v else ""))
    return out


def spread_and_mask_summary(fm, sf):
    """The redesigned spread filter (config-3-hard shapes) and mask
    (config-2 shapes): each kernel alone and through its wrapper, the
    times before, the bounds, the chosen cluster size and tile, the
    alternatives timed, and the device-memory paths' times."""
    out = {
        "spread_filter config-3-hard": {
            "ms": sf["ms"], "wrapper_ms": sf["wrapper_ms"], "plain_ms": sf["plain_ms"], "bound_ms": sf["bound"][0],
            "before_ms": BEFORE_MS["spread_filter"] + BEFORE_MS["spread_filter_match_terms"],
            "before_parts_ms": [BEFORE_MS["spread_filter"], BEFORE_MS["spread_filter_match_terms"]],
            "C": sf["layout"]["C"], "layout": sf["layout"], "ctas_ms": sf["ctas_ms"],
            "device_tables_ms": sf["device_tables_ms"]},
        "filter_mask config-2": {
            "ms": fm["ms"], "wrapper_ms": fm["wrapper_ms"], "plain_ms": fm["plain_ms"], "bound_ms": fm["bound"][0],
            "before_ms": BEFORE_MS["filter_mask"], "tile": [fm["layout"]["UT"], fm["layout"]["NT"]],
            "layout": fm["layout"], "tiles_ms": fm["tiles_ms"], "int64_ms": fm["int64_ms"],
            "device_memory_ms": fm["device_memory_ms"]},
    }
    for k, v in out.items():
        log(f"[redesign] {k}: {v['ms']:.4f} ms alone, {v['wrapper_ms']:.4f} through its wrapper, before "
            f"{v['before_ms']:.4f}, bound {v['bound_ms']:.6f} ms, plain {v['plain_ms']:.4f} ms")
    return out


def victim_search_and_score_summary(preempt, score2, score3):
    """The victim search's and the score matrix's times at the main path's
    shapes, each from this run: ms, plain ms where timed, bound, and the
    walk's reuse counts."""
    out = {}
    for label, st in preempt.items():
        out[f"preempt {label}"] = {k: st.get(k) for k in ("ms", "plain_ms", "steps", "evaluated", "full_evaluations",
                                                         "solo_steps", "rebuilds", "resident")}
        out[f"preempt {label}"]["bound_ms"] = st["bound"][0]
        log(f"[redesign] preempt {label}: {st['ms']:.4f} ms, {st['ms'] * 1000 / st['steps']:.3f} us a step, "
            f"{st['evaluated']} of {st['full_evaluations']} rows evaluated, {st['solo_steps']} one-warp steps, "
            f"bound {st['bound'][0]:.6f} ms")
    for cfg, sc in (("config-2", score2), ("config-3", score3)):
        for name, st in sc.items():
            out[f"{name} {cfg}"] = {"ms": st["ms"], "wrapper_ms": st["wrapper_ms"], "plain_ms": st["plain_ms"],
                                    "bound_ms": st["bound"][0]}
            log(f"[redesign] {name} {cfg}: {st['ms']:.4f} ms (wrapper {st['wrapper_ms']:.4f}), "
                f"bound {st['bound'][0]:.6f} ms")
    return out


def redesign_summary(stats, arb3h, layouts):
    """The serial walks' times at the main path's shapes: ms, plain ms,
    bound and µs a pod (a step for the arbiter), each from this run."""
    from kubernetes_tpu_torch.ops import solver as SO

    def row(st, ms_key="ms"):
        ms = st[ms_key]
        return {"ms": ms, "plain_ms": st["plain_ms"], "bound_ms": st["bound"][0], "us_per_pod": ms * 1000 / st["pods"]}

    sh = stats["solve_sharded"]
    out = {
        f"solve config-2 (S={SO.SOLO_SHARDS})": row(stats["solve_greedy"]),
        # plain: the sharded plain version (the same function)
        f"solve config-3 (S={SO.SOLO_SHARDS})": row(sh, "single_ms"),
        "solve tracked config-4": row(stats["solve_greedy_inb"]),
        "solve gang config-5": row(stats["solve_gang"]),
        "solve sharded config-3 (8 CTAs)": row(sh),
        "solve sharded tracked config-4 (8 CTAs)": row(stats["solve_sharded_inb"]),
        "solve gang sharded config-5 (8 CTAs)": row(stats["solve_gang_sharded"]),
        "arbitrate config-3-hard": row(arb3h),
        "arbitrate config-4": row(stats["arbitrate"]),
        "arbitrate sharded config-3-hard (8 CTAs)": row(stats["arbitrate_sharded"]),
    }
    for k, v in out.items():
        log(f"[redesign] {k}: {v['ms']:.4f} ms, {v['us_per_pod']:.3f} us a pod, plain {v['plain_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.6f} ms")
    out["solve layouts"] = layouts
    return out


def kernel_counters():
    """Kernel name -> (its wrapper, the attribute counting its launches).
    The solve's launches with in-batch tracking are also counted apart."""
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import scores as S
    from kubernetes_tpu_torch.ops import solver as SO
    from kubernetes_tpu_torch.ops import topology as TO

    from kubernetes_tpu_torch.commit import arbiter as A
    from kubernetes_tpu_torch.ops import fold as FO
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import preempt as PR
    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.parallel import sharded as PS

    return {
        "filter_mask": (F.combined_mask, "launches"), "score_matrix": (S.score_matrix, "launches"),
        "solve_greedy": (SO.solve_greedy, "launches"), "match_terms": (TO.match_terms, "launches"),
        "spread_score": (TO.spread_score, "launches"),
        "selector_spread_score": (TO.selector_spread_score, "launches"),
        "interpod_filter": (TO.interpod_filter, "launches"), "interpod_score": (TO.interpod_score, "launches"),
        "inbatch_port_conflict": (F.inbatch_port_conflict, "launches"),
        "solve_greedy_inb": (SO.solve_greedy, "tracked_launches"),
        "spread_filter": (TO.spread_filter, "launches"), "arbitrate": (A.arbitrate, "launches"),
        "spread_filter[device tables]": (TO.spread_filter, "device_table_launches"),
        "spread_score[device tables]": (TO.spread_score, "device_table_launches"),
        "interpod_filter[device tables]": (TO.interpod_filter, "device_table_launches"),
        "selector_spread_score[device tables]": (TO.selector_spread_score, "device_table_launches"),
        "match_terms[problems]": (TO.match_terms, "problems"),
        "match_terms[plan]": (TO.match_terms, "multi_launches"),
        "filter_mask[device memory]": (F.combined_mask, "device_memory_launches"),
        "fold_commit_banks": (FO.fold_commit_banks, "launches"),
        "preempt_batch": (PR.preempt_batch, "launches"), "fold_usage": (FO.fold_usage, "launches"),
        "gather_score_rows": (PP.gather_score_rows, "launches"), "solve_gang": (SO.solve_gang, "launches"),
        "gather_batch": (SL.gather_batch, "launches"), "scatter_rows": (SL.scatter_batch, "launches"),
        "scatter_rows[split]": (SL.scatter_batch, "split_launches"),
        "scatter_rows[layout hits]": (SL.scatter_batch, "layout_hits"),
        "scatter_rows[layout misses]": (SL.scatter_batch, "layout_misses"),
        "score_matrix[rtcr]": (S.score_matrix, "rtcr_launches"), "score_components": (S.score_components, "launches"),
        "pipeline.filter_mask": (PP.filter_mask, "launches"),
        "solve_sharded": (PS.solve_sharded, "launches"), "solve_sharded_inb": (PS.solve_sharded, "tracked_launches"),
        "solve_gang_sharded": (PS.solve_gang_sharded, "launches"), "arbitrate_sharded": (A.arbitrate_sharded, "launches"),
        "fold_commit_sharded": (FO.fold_commit_sharded, "launches"),
        "fold_usage_sharded": (FO.fold_usage_sharded, "launches"),
    }


def drain(device, workload, n_nodes, n_pods, batch, deterministic, seed=0, services=False, planes=True,
          hard=False, stage_planes=True, mesh=0):
    from kubernetes_tpu_torch.models.clusters import (
        bench_config1,
        bench_config2,
        bench_config3,
        bench_config4,
        bench_config5,
        fill_cache,
    )
    from kubernetes_tpu_torch.parallel import node_mesh
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    fn = None
    if workload == "config1":
        nodes, pods = bench_config1(n_nodes, n_pods)
    elif workload == "config5":
        nodes, pods = bench_config5(n_nodes, n_pods // 64)
    elif workload == "config2":
        nodes, pods = bench_config2(n_nodes, n_pods)
    elif workload == "config4":
        nodes, pods = bench_config4(n_nodes, n_pods)
    else:
        nodes, pods, fn = bench_config3(n_nodes, n_pods, services=services, hard=hard)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes)
    # the pods are admitted to a running scheduler: the queue stages each
    # one into the ingest and term slabs as it adds it
    sched = Scheduler(cache, queue, batch_size=batch, deterministic=deterministic, seed=seed, device=device,
                      commit_plane=planes, ingest_plane=stage_planes, term_plane=stage_planes,
                      mesh=node_mesh(mesh, device=device) if mesh else None)
    if fn is not None:
        sched.set_spread_selectors_fn(fn)
    for p in pods:
        queue.add(p)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.run_until_empty(max_cycles=100000)
    sched.wait_for_binds()
    wall = time.perf_counter() - t0
    sched.close()
    return sched, nodes, pods, res, wall


# match launches and matrices a batch per full drain (phase 5), for the
# redesign line
MATCHES = {}


def record_matches(label, launches, batches):
    """Log and keep a drain's match launches and matrices a batch, and its
    spread_score launches a batch."""
    per = {"batches": batches, "match_launches_per_batch": launches["match_terms"] / batches,
           "match_problems_per_batch": launches["match_terms[problems]"] / batches,
           "spread_score_launches_per_batch": launches["spread_score"] / batches}
    MATCHES[label] = per
    log(f"[drain] {label}: {per['match_launches_per_batch']:.3f} match launches and "
        f"{per['match_problems_per_batch']:.3f} match matrices a batch, {per['spread_score_launches_per_batch']:.3f} "
        f"spread_score launches a batch ({batches} batches)")


class StepClock:
    """A queue clock that the drain loop steps: the backoff then waits on
    the loop, not on wall time, so two drains see the same queue."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def drain6(device, n_nodes, n_preemptors, batch, planes=True, stepped=False, mesh=0):
    """Drain config 6 to the end with preemption on. After every batch
    the binds are awaited; when a batch does nothing while pods wait out
    their backoff, the loop waits (a stepped clock steps 1 s; the real
    clock sleeps 50 ms) and moves the unschedulable pods back, as
    bench.py's drain does. Returns a dict of what it saw."""
    from kubernetes_tpu_torch.models.clusters import bench_config6, fill_cache
    from kubernetes_tpu_torch.parallel import node_mesh
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    nodes, existing, pending = bench_config6(n_nodes, n_preemptors)
    clock = StepClock() if stepped else time.monotonic
    cache, queue = SchedulerCache(), PriorityQueue(now=clock)
    fill_cache(cache, nodes, existing)
    victims, unnominated, bad_victims = [], [], []

    def delete(v):
        if cache.is_assumed(v.key()):
            bad_victims.append(f"{v.key()} was assumed")
        victims.append(v.key())
        unnominated.append(v)
        cache.remove_pod(v)

    def nominate(pod, node):
        for v in unnominated:
            if v.get_priority() >= pod.get_priority() or v.node_name != node:
                bad_victims.append(f"{v.key()} (priority {v.get_priority()} on {v.node_name}) for {pod.key()} on {node}")
        unnominated.clear()

    sched = Scheduler(cache, queue, batch_size=batch, deterministic=True, device=device, commit_plane=planes,
                      delete_fn=delete, nominate_fn=nominate, mesh=node_mesh(mesh, device=device) if mesh else None)
    for p in pending:
        queue.add(p)
    out = {"assignments": {}, "nominations": [], "preempted": 0, "batch_s": 0.0}
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    idle = 0
    for _ in range(10000):
        tb = time.perf_counter()
        r = sched.schedule_batch()
        sched.wait_for_binds()
        out["batch_s"] += time.perf_counter() - tb
        out["assignments"].update(r.assignments)
        out["preempted"] += r.preempted
        out["nominations"].append(dict(queue.nominated))
        if r.scheduled or r.unschedulable or r.deferred:
            idle = 0
            continue
        if sum(queue.counts()) == 0 or idle >= 400:
            break
        idle += 1
        if stepped:
            clock.t += 1.0
        else:
            time.sleep(0.05)
        queue.move_all_to_active()
    out["wall"] = time.perf_counter() - t0
    sched.close()
    check(not bad_victims, f"config-6 drain: bad victims {bad_victims[:5]}")
    out.update(sched=sched, nodes=nodes, existing=existing, pending=pending, victims=victims)
    return out


def gang_drain(device, batch, deterministic, seed=11):
    """Drain a tight random gang cluster (40 nodes, 60 groups, 80
    ungrouped pods) in three rounds on one stepped clock: batches until one
    does nothing, then the clock steps past the backoff and the
    unschedulable pods move back. Returns what it saw."""
    from kubernetes_tpu_torch.models.clusters import fill_cache, random_gang_cluster
    from kubernetes_tpu_torch.scheduler.driver import Scheduler, pod_group_name
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    nodes, pods = random_gang_cluster(seed, n_nodes=40, n_groups=60, n_solo=80)
    clock = StepClock()
    cache, queue = SchedulerCache(), PriorityQueue(now=clock)
    fill_cache(cache, nodes)
    sched = Scheduler(cache, queue, batch_size=batch, deterministic=deterministic, seed=seed, device=device)
    for p in pods:
        queue.add(p)
    out = {"assignments": {}, "batches": []}
    t0 = time.perf_counter()
    for _ in range(3):
        for _ in range(1000):
            r = sched.schedule_batch()
            sched.wait_for_binds()
            if not (r.scheduled or r.unschedulable or r.deferred):
                break
            out["batches"].append((r.scheduled, r.unschedulable, r.preempted))
            out["assignments"].update(r.assignments)
        clock.t += 30.0
        queue.move_all_to_active()
    out["wall"] = time.perf_counter() - t0
    sched.close()
    sizes, placed = {}, {}
    for p in pods:
        g = pod_group_name(p)
        if g:
            sizes[g] = sizes.get(g, 0) + 1
            placed[g] = placed.get(g, 0) + (p.key() in out["assignments"])
    partial = sorted(g for g in sizes if 0 < placed[g] < sizes[g])
    check(not partial, f"tight gang drain: groups placed in part {partial}")
    assumed = sorted(p.key() for p in pods if cache.is_assumed(p.key()))
    check(assumed == sorted(out["assignments"]), "tight gang drain: an assume is left beside the placed pods")
    out.update(sched=sched, queue=queue.counts(), dropped=sorted(g for g in sizes if not placed[g]),
               groups=len(sizes), counters={k: sched.stats[k] for k in ("gang_batches", "gang_rollbacks",
                                                                        "oracle_rechecks", "light_rechecks",
                                                                        "oracle_places")})
    return out


def phase_gang_parity():
    """Config 5 at 1/10 and the tight gang drain (main paths on cuda), and
    config 1 at full size, each on cuda and cpu: identical placements."""
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    n5, p5 = CONFIG5_NODES // 10, CONFIG5_GROUPS // 10 * 64
    (gsched, _, pods, gpu, tg), got = run_main_path("config-5 /10", ["filter_mask", "score_matrix", "solve_gang"],
                                                    lambda: drain("cuda", "config5", n5, p5, 1024, False, seed=3))
    add(got)
    _, _, _, cpu, tc = drain("cpu", "config5", n5, p5, 1024, False, seed=3)
    SINGLE["config5"] = (gsched, gpu)
    check(gpu.scheduled == cpu.scheduled == p5 and gpu.assignments == cpu.assignments,
          f"config-5 /10: {gpu.scheduled}/{cpu.scheduled} placed, or placed differently on cuda and cpu")
    log(f"[parity] config-5 /10 ({n5} nodes, {p5 // 64} groups of 64, batch 1024, tie-noise): identical "
        f"placements on cuda and cpu ({gpu.scheduled} pods, {gsched.stats['gang_batches']} gang batches; cuda "
        f"{tg:.2f}s, cpu {tc:.2f}s); launches {got}")
    gpu, got = run_main_path("tight gang", ["filter_mask", "score_matrix", "solve_gang"],
                             lambda: gang_drain("cuda", GANG_BATCH, False))
    add(got)
    cpu = gang_drain("cpu", GANG_BATCH, False)
    for key in ("assignments", "batches", "queue", "dropped", "counters"):
        check(gpu[key] == cpu[key], f"tight gang drain: {key} differ on cuda and cpu")
    check(gpu["dropped"] and gpu["counters"]["gang_rollbacks"] > 0,
          f"tight gang drain: dropped {gpu['dropped']}, counters {gpu['counters']}")
    log(f"[parity] tight gang (40 nodes, {gpu['groups']} groups, 80 ungrouped, batch {GANG_BATCH}, tie-noise, "
        f"stepped clock, three rounds): identical placements, per-batch counts, queue and counters on cuda and "
        f"cpu ({len(gpu['assignments'])} placed; {gpu['counters']}; queue {gpu['queue']}; cuda {gpu['wall']:.2f}s, "
        f"cpu {cpu['wall']:.2f}s); every group all or nothing; {len(gpu['dropped'])} groups never placed: "
        f"{gpu['dropped']}; launches {got}")
    need = ["filter_mask", "score_matrix", "solve_greedy", "fold_commit_banks"]
    (gsched, nodes, pods, gpu, tg), got = run_main_path("config-1", need, lambda: drain(
        "cuda", "config1", CONFIG1_NODES, CONFIG1_PODS, BATCH, False, seed=3))
    add(got)
    _, _, _, cpu, tc = drain("cpu", "config1", CONFIG1_NODES, CONFIG1_PODS, BATCH, False, seed=3)
    check(gpu.assignments == cpu.assignments, "config-1: placed differently on cuda and cpu")
    verify_capacity(gsched, pods, gpu)
    log(f"[parity] config-1 full ({CONFIG1_NODES} nodes, {CONFIG1_PODS} pods, batch {BATCH}, tie-noise): identical "
        f"placements on cuda and cpu, every pod placed, no node over its limits ({gsched.stats['batches']} batches; "
        f"cuda {tg:.2f}s, cpu {tc:.2f}s); launches {got}")
    return launches


ORACLE_COUNTERS = ("oracle_rechecks", "light_rechecks", "oracle_places", "arbiter_batches", "arbiter_defer",
                   "arbiter_escalated")


def oracle_workload(workload):
    """(nodes, bound pods, pending pods, PDBs) of phase 4's oracle drains."""
    from kubernetes_tpu_torch.models.clusters import (
        bench_config3,
        commit_plane_mix,
        random_cluster,
        random_preemption_cluster,
    )

    if workload == "config-3-hard 1,000/10,000":
        nodes, pods, _ = bench_config3(CONFIG3_NODES // 10, CONFIG3_PODS // 10, hard=True)
        return nodes, [], pods, []
    if workload == "config-3-hard 100/1,000":
        nodes, pods, _ = bench_config3(CONFIG3_NODES // 100, CONFIG3_PODS // 100, hard=True)
        return nodes, [], pods, []
    if workload == "commit-plane mix":
        nodes, pods = commit_plane_mix(8, 96)
        return nodes, [], pods, []
    if workload == "preemption + host ports":
        return random_preemption_cluster(20, ports=True)
    # DoNotSchedule spread, required pod (anti-)affinity, host ports
    nodes, existing, pods = random_cluster(24, 40, 100, 60, pins=False, topology=True, hard_spread=True,
                                           interpod=True, pending_ports=True, pending_affinity=True)
    return nodes, existing, pods, []


def oracle_drain(device, workload, batch, planes=True):
    """Drain an oracle workload to the end with preemption on, on one
    stepped clock (the drain6 loop). Returns the placements, the victims in
    delete order, the nominated index after every batch, the preempted
    count, the oracle and arbiter counters, the scheduler, the cluster and
    the wall seconds."""
    from kubernetes_tpu_torch.models.clusters import fill_cache
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    nodes, existing, pending, pdbs = oracle_workload(workload)
    clock = StepClock()
    cache, queue = SchedulerCache(), PriorityQueue(now=clock)
    fill_cache(cache, nodes, existing)
    victims = []

    def delete(v):
        victims.append(v.key())
        cache.remove_pod(v)

    sched = Scheduler(cache, queue, batch_size=batch, deterministic=True, device=device, commit_plane=planes,
                      pdb_lister=lambda: pdbs, delete_fn=delete)
    for p in pending:
        queue.add(p)
    out = {"assignments": {}, "victims": victims, "nominations": [], "preempted": 0}
    t0 = time.perf_counter()
    idle = stale = 0
    for _ in range(10000):
        r = sched.schedule_batch()
        sched.wait_for_binds()
        out["assignments"].update(r.assignments)
        out["preempted"] += r.preempted
        out["nominations"].append(dict(queue.nominated))
        # pods that fit nowhere retry after their backoff for ever: the
        # drain ends after 30 batches that place, defer and preempt nothing
        stale = 0 if (r.scheduled or r.deferred or r.preempted) else stale + 1
        if stale >= 30:
            break
        if r.scheduled or r.unschedulable or r.deferred:
            idle = 0
            continue
        if sum(queue.counts()) == 0 or idle >= 12:
            break
        idle += 1
        clock.t += 1.0
        queue.move_all_to_active()
    out["wall"] = time.perf_counter() - t0
    sched.close()
    out["counters"] = {k: sched.stats[k] for k in ORACLE_COUNTERS}
    out.update(sched=sched, nodes=nodes, pending=pending)
    return out


def phase_oracle_parity():
    """The host oracle's drains on cuda and on cpu: identical placements,
    victims in delete order, nominations after every batch, preempted
    count and oracle / arbiter counters. The cuda runs are main paths."""
    launches = {}
    runs = [
        # the reference's 667-escalation row: deferred pods escalate to _oracle_place
        ("config-3-hard 1,000/10,000", 512, True,
         ["filter_mask", "score_matrix", "solve_greedy", "spread_filter", "arbitrate", "fold_commit_banks",
          "gather_score_rows"]),
        ("commit-plane mix", 16, True, ["arbitrate", "fold_commit_banks", "gather_score_rows"]),
        ("preemption + host ports", 16, True, ["filter_mask", "score_matrix", "solve_greedy"]),
        ("random terms + preemption", 32, True, ["solve_greedy", "interpod_filter", "spread_filter"]),
        # DoNotSchedule spread with the commit plane off: the per-pod loop
        ("config-3-hard 100/1,000", 128, False, ["solve_greedy", "spread_filter"]),
    ]
    for workload, batch, planes, need in runs:
        gpu, got = run_main_path(f"oracle {workload}", need, lambda: oracle_drain("cuda", workload, batch, planes))
        cpu = oracle_drain("cpu", workload, batch, planes)
        for key in ("assignments", "victims", "nominations", "preempted", "counters"):
            check(gpu[key] == cpu[key], f"oracle drain {workload}: {key} differ on cuda and cpu")
        c = gpu["counters"]
        check(c["oracle_places"] + c["oracle_rechecks"] > 0, f"oracle drain {workload}: the host oracle never ran")
        if workload.startswith("config-3-hard"):
            check(len(gpu["assignments"]) == len(gpu["pending"]),
                  f"oracle drain {workload}: {len(gpu['assignments'])} of {len(gpu['pending'])} placed")
            skew = zone_skew(gpu["nodes"], gpu["pending"], SimpleNamespace(assignments=gpu["assignments"]))
            check(skew <= 1, f"oracle drain {workload}: an app's zone counts differ by {skew} > max_skew 1")
        if workload == "config-3-hard 1,000/10,000":
            check(c["arbiter_escalated"] > 0, f"oracle drain {workload}: no escalation")
        log(f"[parity] oracle {workload} (batch {batch}, commit plane {'on' if planes else 'off'}, stepped clock): "
            f"identical placements, victims, nominations and counters on cuda and cpu ({len(gpu['assignments'])} "
            f"placed, {len(gpu['victims'])} victims, {gpu['sched'].stats['batches']} batches; {c}; cuda "
            f"{gpu['wall']:.2f}s, cpu {cpu['wall']:.2f}s); launches {got}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def phase_parity():
    runs = [("config2", CONFIG2_NODES // 10, CONFIG2_PODS // 10, det, False) for det in (True, False)]
    # config 3: without Services deterministic, with Services under tie-noise
    runs += [("config3", CONFIG3_NODES // 10, CONFIG3_PODS // 10, True, False),
             ("config3", CONFIG3_NODES // 10, CONFIG3_PODS // 10, False, True)]
    runs += [("config4", CONFIG4_NODES // 10, CONFIG4_PODS // 10, det, False) for det in (True, False)]
    for workload, n_nodes, n_pods, det, services in runs:
        # config 4 at 1/10 in batches of 512, as at full size in 5 batches
        batch = 512 if workload == "config4" else 1024
        gsched, _, _, gpu, tg = drain("cuda", workload, n_nodes, n_pods, batch, det, seed=3, services=services)
        _, _, _, off, to = drain("cuda", workload, n_nodes, n_pods, batch, det, seed=3, services=services,
                                 planes=False)
        _, _, _, soff, ts = drain("cuda", workload, n_nodes, n_pods, batch, det, seed=3, services=services,
                                  stage_planes=False)
        csched, _, _, cpu, tc = drain("cpu", workload, n_nodes, n_pods, batch, det, seed=3, services=services)
        st = gsched.stats
        pc = plane_counters(gsched)
        check(pc == plane_counters(csched), f"parity drain ({workload}): plane counters {pc} on cuda, "
              f"{plane_counters(csched)} on cpu")
        verify_stage_planes(f"parity drain ({workload})", gsched)
        if workload == "config4":
            # later batches read the committed pods' terms from the PatternBank
            check({"et_anti", "et_score"} <= gsched._term_kinds and st["tracked_batches"] > 0,
                  f"config-4 parity drain ran without the existing-pod kinds or tracking: "
                  f"{sorted(gsched._term_kinds)}, {st['tracked_batches']} tracked batches")
        check(st["fold_batches"] == st["batches"] and st["fold_overflow_batches"] == 0,
              f"parity drain ({workload}) folded {st['fold_batches']} of {st['batches']} batches")
        check(gpu.scheduled == cpu.scheduled == off.scheduled == n_pods,
              f"parity drain placed {gpu.scheduled}/{off.scheduled}/{cpu.scheduled}")
        diff = sum(1 for k, v in cpu.assignments.items() if gpu.assignments.get(k) != v)
        diff_off = sum(1 for k, v in off.assignments.items() if gpu.assignments.get(k) != v)
        diff_soff = sum(1 for k, v in soff.assignments.items() if gpu.assignments.get(k) != v)
        check(diff == 0 and diff_off == 0 and diff_soff == 0 and len(gpu.assignments) == len(cpu.assignments)
              == len(soff.assignments),
              f"parity drain ({workload}, deterministic={det}, services={services}): {diff} pods placed "
              f"differently on cuda and cpu, {diff_off} with the commit plane on and off, {diff_soff} with the "
              f"ingest and term planes on and off")
        if workload == "config4" and det:
            SINGLE["config4"] = (gsched, gpu)
        log(f"[parity] {workload} /10 ({n_nodes} nodes, {n_pods} pods, batch {batch}), deterministic={det}"
            f"{', Services' if services else ''}: identical placements, planes on (cuda, cpu), commit plane off "
            f"(cuda) and ingest + term planes off (cuda) ({gpu.scheduled} pods; {st['arbiter_batches']} "
            f"arbitrated batches; plane counters {pc} on cuda and cpu; cuda {tg:.2f}s, commit plane off "
            f"{to:.2f}s, ingest + term off {ts:.2f}s, cpu {tc:.2f}s)")
    # config 3-hard at 1/10: a main path of its own (spread_filter and the
    # arbiter's defers run only on DoNotSchedule batches)
    n_nodes, n_pods = CONFIG3_NODES // 10, CONFIG3_PODS // 10
    need = ["filter_mask", "score_matrix", "solve_greedy", "match_terms", "spread_filter", "arbitrate",
            "fold_commit_banks"]
    (gsched, nodes, pods, gpu, tg), launches = run_main_path("config-3-hard /10", need, lambda: drain(
        "cuda", "config3", n_nodes, n_pods, HARD_BATCH, True, hard=True))
    csched, _, _, cpu, tc = drain("cpu", "config3", n_nodes, n_pods, HARD_BATCH, True, hard=True)
    g, c = gsched.stats, csched.stats
    check(gpu.scheduled == cpu.scheduled == n_pods, f"config-3-hard placed {gpu.scheduled}/{cpu.scheduled}")
    diff = sum(1 for k, v in cpu.assignments.items() if gpu.assignments.get(k) != v)
    check(diff == 0, f"config-3-hard: {diff} pods placed differently on cuda and cpu")
    check(g["arbiter_batches"] == g["batches"] == c["arbiter_batches"],
          f"config-3-hard arbitrated {g['arbiter_batches']} of {g['batches']} batches ({c['arbiter_batches']} on cpu)")
    check(g["arbiter_defer"] == c["arbiter_defer"] > 0 and g["arbiter_escalated"] == c["arbiter_escalated"] == 0,
          f"config-3-hard defers {g['arbiter_defer']}/{c['arbiter_defer']}, escalations "
          f"{g['arbiter_escalated']}/{c['arbiter_escalated']}")
    skew = zone_skew(nodes, pods, gpu)
    check(skew <= 1, f"config-3-hard: an app's zone counts differ by {skew} > max_skew 1")
    SINGLE["config3-hard"] = (gsched, gpu)
    log(f"[parity] config-3-hard /10 ({n_nodes} nodes, {n_pods} pods, batch {HARD_BATCH}), deterministic: "
        f"identical placements and defers on cuda and cpu ({gpu.scheduled} pods, {g['batches']} batches, "
        f"{g['arbiter_defer']} defers, 0 escalations; max per-app zone skew {skew}; cuda {tg:.2f}s, "
        f"cpu {tc:.2f}s); launches {launches}")
    # config 6 at 1/10: preemption, the nominee overlay and fold_usage
    n6, p6 = CONFIG6_NODES // 10, CONFIG6_PREEMPTORS // 10
    need = ["filter_mask", "score_matrix", "solve_greedy", "fold_commit_banks", "preempt_batch", "fold_usage"]
    gpu, launches6 = run_main_path("config-6 /10", need, lambda: drain6("cuda", n6, p6, CONFIG6_SMALL_BATCH,
                                                                        stepped=True))
    off = drain6("cuda", n6, p6, CONFIG6_SMALL_BATCH, planes=False, stepped=True)
    cpu = drain6("cpu", n6, p6, CONFIG6_SMALL_BATCH, stepped=True)
    for name, other in (("cpu", cpu), ("planes off", off)):
        for key in ("assignments", "victims", "nominations", "preempted"):
            check(gpu[key] == other[key], f"config-6 /10: {key} differ on cuda and {name}")
    g = gpu["sched"].stats
    SINGLE["config6"] = gpu
    check(len(gpu["assignments"]) == p6 and gpu["preempted"] == p6 and g["preempt_reverify_miss"] == 0,
          f"config-6 /10 placed {len(gpu['assignments'])}, preempted {gpu['preempted']} of {p6}, "
          f"{g['preempt_reverify_miss']} plans rejected by the host re-verification")
    check(off["sched"].stats["nominee_folds"] == g["nominee_folds"] > 0 and launches6["fold_usage"] > 0,
          f"config-6 /10: nominee folds {g['nominee_folds']} (planes off {off['sched'].stats['nominee_folds']})")
    log(f"[parity] config-6 /10 ({n6} nodes, {n6 * 7} bound, {p6} preemptors, batch {CONFIG6_SMALL_BATCH}, stepped "
        f"clock): identical placements, victims in order, nominations after every batch and preempted count on "
        f"cuda, cpu and planes-off cuda ({len(gpu['assignments'])} placed, {len(gpu['victims'])} victims, "
        f"{g['batches']} batches, {g['preempt_batches']} preemption rounds, {g['nominee_folds']} nominee folds; "
        f"cuda {gpu['wall']:.2f}s, planes off {off['wall']:.2f}s, cpu {cpu['wall']:.2f}s); launches {launches6}")
    for k, v in launches6.items():
        launches[k] = launches.get(k, 0) + v
    return launches


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


def verify_node_bank(sched):
    """The device node bank's usage columns (requested, nonzero_req,
    pod_count), advanced by the commit folds through the drain, equal a
    fresh host encode of the final cache; the other columns equal the
    host mirror."""
    from kubernetes_tpu_torch.state.tensors import encode_snapshot

    mirror = sched.mirror
    mirror.sync()
    dev, _, _ = mirror.device_arrays()
    fresh, _, rows = encode_snapshot(sched.cache.snapshot, vocab=mirror.vocab, with_images=False)
    check(rows == mirror.row_of, "the fresh encode numbers the node rows differently")
    fresh = fresh.arrays()
    for k in ("requested", "nonzero_req", "pod_count"):
        bad = int((dev[k].cpu() != torch.from_numpy(fresh[k])).sum())
        check(bad == 0, f"device node bank column {k} differs from a fresh encode in {bad} cells")
    host = mirror.nodes.arrays()
    bad = [k for k, h in host.items() if not torch.equal(dev[k].cpu(), torch.from_numpy(h))]
    check(not bad, f"device node bank columns {bad} differ from the host mirror")


def verify_sig_bank(sched):
    """The device signature bank, patched incrementally through the drain,
    equals a fresh host encode of the final cache: per signature content
    (label row, namespace, deleting) the same per-node counts, and no other
    valid signature."""
    from kubernetes_tpu_torch.state.tensors import encode_snapshot

    mirror = sched.mirror
    _, dev, _ = mirror.device_arrays()
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


def verify_pattern_bank(sched):
    """The device pattern bank, patched incrementally through the drain,
    equals a fresh host encode of the final cache's affinity pods: per
    pattern content (kind, key slot, weight, namespaces, compiled
    selector) the same per-node instance counts, and no other valid
    pattern."""
    from kubernetes_tpu_torch.state.terms import PatternBank

    mirror = sched.mirror
    _, _, dev = mirror.device_arrays()
    dev = {k: v.cpu().numpy() for k, v in dev.items()}
    fresh = PatternBank(mirror.vocab, mirror.pats.capacity, mirror.nodes.capacity)
    for name, ni in sched.cache.snapshot.node_infos.items():
        fresh.encode_node(mirror.row_of[name], ni.pods_with_affinity())
    fresh = fresh.arrays()
    meta = ("kind", "topo_slot", "weight", "ns_any", "ns_ids", "has_selector", "ml_slot", "ml_val",
            "ex_op", "ex_slot", "ex_vals")

    def by_content(x):
        return {b"".join(x[k][r].tobytes() for k in meta): x["counts"][:, r] for r in x["valid"].nonzero()[0]}

    got, want = by_content(dev), by_content(fresh)
    check(got.keys() == want.keys(), f"device pattern bank holds {len(got)} patterns, a fresh encode {len(want)}")
    bad = sum(int((got[k] != want[k]).sum()) for k in want)
    check(bad == 0, f"device pattern counts differ from a fresh encode in {bad} (node, pattern) cells")
    return len(want)


def verify_exclusive(pods, res):
    """No node hosts two pods of one `exclusive` value (config 4's required
    hostname anti-affinity)."""
    from collections import Counter

    per = Counter((p.labels["exclusive"], res.assignments[p.key()]) for p in pods if "exclusive" in p.labels)
    worst = max(per.values())
    check(worst == 1, f"a node hosts {worst} pods of one exclusive value")
    return sum(per.values())


def zone_share(nodes, pods, res):
    """The share of pods in their app's most common zone (information only:
    the preferred zone affinity gates nothing)."""
    from collections import Counter

    from kubernetes_tpu_torch.models.clusters import ZONE_KEY

    zone_of = {n.name: n.labels[ZONE_KEY] for n in nodes}
    per = Counter((p.labels["app"], zone_of[res.assignments[p.key()]]) for p in pods)
    top = Counter()
    for (app, _), c in per.items():
        top[app] = max(top[app], c)
    return sum(top.values()) / len(pods)


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


PLANE_COUNTERS = ("ingest_index_batches", "ingest_legacy_batches", "ingest_stale_rows", "ingest_restaged",
                  "stage_sync_flushes", "term_index_batches", "term_legacy_batches", "term_stale_rows",
                  "term_restaged", "term_sync_flushes")


def plane_counters(sched):
    return {k: sched.stats[k] for k in PLANE_COUNTERS}


def verify_stage_planes(label, sched, launches=None):
    """The ingest and term planes after a drain: each slab's device twin
    equals its host slab on the live rows, every batch went through a plane
    either gathered or legacy, and a plane took the legacy path at most
    once per slab rebuild. Given the drain's `launches`: one batch-gather
    launch a covered batch (a batch either plane gathered)."""
    st = sched.stats
    if launches is not None:
        got, idx_i, idx_t = launches["gather_batch"], st["ingest_index_batches"], st["term_index_batches"]
        if st["ingest_legacy_batches"] == 0 or st["term_legacy_batches"] == 0:
            lo = hi = max(idx_i, idx_t)  # every batch one plane did not gather, the other did
        else:
            lo, hi = max(idx_i, idx_t), min(st["batches"], idx_i + idx_t)
        check(lo <= got <= hi, f"{label}: {got} batch-gather launches for {st['batches']} batches ({idx_i} pod-array "
              f"and {idx_t} term-table gathers): one launch a covered batch expected")
    for plane, slab, bank in (("ingest", sched.stage, sched.stage_bank), ("term", sched.tstage, sched.term_bank)):
        div = bank.device_divergence()
        check(div == [], f"{label}: the {plane} slab's device twin differs from its host slab: {div}")
        idx, leg = st[f"{plane}_index_batches"], st[f"{plane}_legacy_batches"]
        check(idx + leg == st["batches"], f"{label}: {plane} plane {idx} gathered + {leg} legacy batches of "
              f"{st['batches']}")
        check(leg <= slab.stats["rebuilds"], f"{label}: {leg} {plane} legacy batches for {slab.stats['rebuilds']} "
              f"slab rebuilds")


def run_main_path(label, names, run, staged=True):
    """Drive one main path with every kernel count set to 0 just before it;
    read the counts of `names` just after and require each > 0. Every
    Scheduler main path runs the ingest and term planes: their gathers
    launch together, once a batch (`staged`; the extender's /filter path
    has no queue, so no plane)."""
    counters = kernel_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    out = run()
    launches = {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}
    for name in list(names) + (["gather_batch"] if staged else []):
        check(launches[name] > 0, f"kernel {name} was not launched by the {label} drain")
    return out, launches


def log_drain(label, sched, res, wall, smi):
    st = sched.stats
    log(f"[drain] {label}: {res.scheduled} scheduled, 0 violations; {res.scheduled / wall:.1f} pods/s "
        f"({wall:.3f}s wall, {st['batches']} batches); sync {st['sync_s']:.3f}s encode {st['encode_s']:.3f}s "
        f"solve {st['solve_s']:.3f}s commit {st['commit_s']:.3f}s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; card {smi}")
    log(f"[drain] {label} planes: fold_batches {st['fold_batches']} (fold_pods {st['fold_pods']}, fold_s "
        f"{st['fold_s']:.3f}, overflow {st['fold_overflow_batches']}), arbiter_batches {st['arbiter_batches']} "
        f"(place {st['arbiter_place']}, defer {st['arbiter_defer']}), apply_s {st['apply_s']:.3f}, "
        f"rows_shipped {sched.mirror.rows_shipped}")
    log(f"[drain] {label} ingest and term planes: stage_s {st['stage_s']:.3f}, term_gather_s "
        f"{st['term_gather_s']:.3f}; {plane_counters(sched)}; slab rebuilds {sched.stage.stats['rebuilds']} / "
        f"{sched.tstage.stats['rebuilds']}, capacity {sched.stage.capacity} / {sched.tstage.capacity}; twins: "
        f"{sched.stage_bank.stats} / {sched.term_bank.stats}")


def verify_planes(label, sched, arbitrated=False):
    """Every batch placed pods, so every batch folded (none overflowed).
    Configs 2 and 3 hold no pod that needs a re-check, so no batch was
    arbitrated (the bulk path); config 4's required anti-affinity is
    (`arbitrated`): every batch arbitrated, as the reference does, and
    nothing deferred (its tracked solve leaves the arbiter nothing to
    defer)."""
    st = sched.stats
    check(st["fold_batches"] == st["batches"] and st["fold_overflow_batches"] == 0,
          f"{label}: {st['fold_batches']} of {st['batches']} batches folded, {st['fold_overflow_batches']} overflowed")
    want = st["batches"] if arbitrated else 0
    check(st["arbiter_batches"] == want and st["arbiter_defer"] == 0,
          f"{label}: {st['arbiter_batches']} arbitrated batches (expected {want}), {st['arbiter_defer']} defers")


def phase_drain(smi, total):

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    torch.cuda.reset_peak_memory_stats()
    (sched, nodes, pods, res, wall), launches = run_main_path(
        "config-2", ("filter_mask", "score_matrix", "solve_greedy", "fold_commit_banks"),
        lambda: drain("cuda", "config2", CONFIG2_NODES, CONFIG2_PODS, BATCH, deterministic=False))
    add(launches)
    verify_drain(sched, nodes, pods, res, "cuda")
    verify_planes("config-2", sched)
    verify_stage_planes("config-2", sched, launches)
    verify_node_bank(sched)
    n_sigs = verify_sig_bank(sched)
    log_drain(f"config-2 full ({CONFIG2_NODES} nodes, {CONFIG2_PODS} pods, batch {BATCH})", sched, res, wall, smi)
    config2_pods_per_s = res.scheduled / wall
    log(f"[drain] config-2: device node bank usage columns and signature bank ({n_sigs} signatures) == fresh "
        f"host encode; launches {launches}")
    for services in (False, True):
        label = "config-3" + (" + Services" if services else "")
        # the spread score matches inside its launch: a config-3 batch
        # launches no match, one with Services one (SelectorSpread's m_sig)
        need = ["filter_mask", "score_matrix", "solve_greedy", "spread_score", "fold_commit_banks"]
        if services:
            need += ["match_terms", "selector_spread_score"]
        torch.cuda.reset_peak_memory_stats()
        (sched, nodes, pods, res, wall), launches = run_main_path(label, need, lambda: drain(
            "cuda", "config3", CONFIG3_NODES, CONFIG3_PODS, BATCH, deterministic=False, services=services))
        add(launches)
        verify_capacity(sched, pods, res)
        verify_planes(label, sched)
        verify_stage_planes(label, sched, launches)
        verify_node_bank(sched)
        n_sigs = verify_sig_bank(sched)
        log_drain(f"{label} full ({CONFIG3_NODES} nodes, {CONFIG3_PODS} pods, batch {BATCH})",
                  sched, res, wall, smi)
        batches = sched.stats["batches"]
        check(launches["spread_score"] == batches and launches["match_terms"] == (batches if services else 0),
              f"{label}: {launches['spread_score']} spread_score and {launches['match_terms']} match launches for "
              f"{batches} batches")
        record_matches(label, launches, batches)
        if not services:
            SINGLE["config3"] = (sched, res, wall)
        log(f"[drain] {label}: device node bank usage columns and signature bank == fresh host encode "
            f"({n_sigs} signatures); "
            f"term kinds {sorted(sched._term_kinds)}, V={sched._v_bucket}, TT={sched._t_bucket}; "
            f"per-app max zone skew {zone_skew(nodes, pods, res)} (information only); launches {launches}")
    torch.cuda.reset_peak_memory_stats()
    need = ["filter_mask", "score_matrix", "solve_greedy", "match_terms", "interpod_filter", "interpod_score",
            "inbatch_port_conflict", "solve_greedy_inb", "fold_commit_banks"]
    (sched, nodes, pods, res, wall), launches = run_main_path("config-4", need, lambda: drain(
        "cuda", "config4", CONFIG4_NODES, CONFIG4_PODS, BATCH, deterministic=False))
    add(launches)
    verify_capacity(sched, pods, res)
    verify_planes("config-4", sched, arbitrated=True)
    verify_stage_planes("config-4", sched, launches)
    verify_node_bank(sched)
    n_excl = verify_exclusive(pods, res)
    n_pats = verify_pattern_bank(sched)
    n_sigs = verify_sig_bank(sched)
    label = f"config-4 full ({CONFIG4_NODES} nodes, {CONFIG4_PODS} pods, batch {BATCH})"
    batches = sched.stats["batches"]
    check(launches["match_terms"] <= batches, f"config-4: {launches['match_terms']} match launches for {batches} "
          f"batches (the plan's matrices take one launch a batch)")
    record_matches("config-4", launches, batches)
    log_drain(label, sched, res, wall, smi)
    log(f"[drain] config-4: {n_excl} exclusive pods on distinct nodes per value; device pattern bank == fresh "
        f"host encode ({n_pats} patterns), signature bank and node bank usage columns too ({n_sigs} "
        f"signatures); "
        f"{sched.stats['tracked_batches']} of {sched.stats['batches']} batches tracked; term kinds "
        f"{sorted(sched._term_kinds)}, V={sched._v_bucket}, TT={sched._t_bucket}; share of pods in their "
        f"app's most common zone {zone_share(nodes, pods, res):.4f} (information only); launches {launches}")
    # config 3-hard on the full cluster: the arbiter's defers escalate to
    # the host oracle; the pod count is cut (HARD_FULL_PODS), never the nodes
    torch.cuda.reset_peak_memory_stats()
    need = ["filter_mask", "score_matrix", "solve_greedy", "match_terms", "spread_filter", "arbitrate",
            "fold_commit_banks", "gather_score_rows"]
    (sched, nodes, pods, res, wall), launches = run_main_path("config-3-hard full cluster", need, lambda: drain(
        "cuda", "config3", CONFIG3_NODES, HARD_FULL_PODS, BATCH, deterministic=False, hard=True))
    add(launches)
    verify_capacity(sched, pods, res)
    skew = zone_skew(nodes, pods, res)
    check(skew <= 1, f"config-3-hard full cluster: an app's zone counts differ by {skew} > max_skew 1")
    verify_stage_planes("config-3-hard full cluster", sched, launches)
    verify_node_bank(sched)
    n_sigs = verify_sig_bank(sched)
    st = sched.stats
    record_matches("config-3-hard", launches, st["batches"])
    check(st["arbiter_batches"] == st["batches"], f"config-3-hard full cluster: {st['arbiter_batches']} of "
          f"{st['batches']} batches arbitrated")
    log_drain(f"config-3-hard full cluster ({CONFIG3_NODES} nodes, {HARD_FULL_PODS} pods, batch {BATCH})",
              sched, res, wall, smi)
    log(f"[drain] config-3-hard full cluster: every pod placed, no node over its limits, max per-app zone skew "
        f"{skew} (max_skew 1), device node bank and signature bank ({n_sigs} signatures) == fresh host encode; "
        f"arbiter_defer {st['arbiter_defer']}, arbiter_escalated {st['arbiter_escalated']}, oracle_places "
        f"{st['oracle_places']}, oracle_rechecks {st['oracle_rechecks']}; launches {launches}")
    # config 5 at full size: every batch a gang batch, every pod through
    # the per-pod loop
    torch.cuda.reset_peak_memory_stats()
    n5 = CONFIG5_GROUPS * 64
    # its 1,000 distinct specs grow the pod slab 256 -> 1,024 during
    # admission: the pairs staged before the last growth re-stage at their
    # first dispatch, and those rows reach the twin through the scatter
    (sched, nodes, pods, res, wall), launches = run_main_path(
        "config-5", ["filter_mask", "score_matrix", "solve_gang", "scatter_rows"],
        lambda: drain("cuda", "config5", CONFIG5_NODES, n5, BATCH, deterministic=False))
    add(launches)
    verify_capacity(sched, pods, res)
    verify_stage_planes("config-5", sched, launches)
    verify_node_bank(sched)
    n_sigs = verify_sig_bank(sched)
    st = sched.stats
    check(st["gang_batches"] == st["batches"] == launches["solve_gang"] and st["gang_rollbacks"] == 0,
          f"config-5: {st['gang_batches']} gang batches of {st['batches']}, {launches['solve_gang']} gang solves, "
          f"{st['gang_rollbacks']} rollbacks")
    log_drain(f"config-5 full ({CONFIG5_NODES} nodes, {CONFIG5_GROUPS} groups of 64, batch {BATCH})", sched, res,
              wall, smi)
    log(f"[drain] config-5: every group placed whole, no node over its limits, device node bank and signature "
        f"bank ({n_sigs} signatures) == fresh host encode; {st['gang_batches']} gang batches, mirror rebuilds "
        f"{sched.mirror.rebuild_count}, oracle_rechecks {st['oracle_rechecks']}, light_rechecks "
        f"{st['light_rechecks']}, oracle_places {st['oracle_places']}; launches {launches}")
    for batch in (BATCH, CONFIG6_BATCH):
        need = ["filter_mask", "score_matrix", "solve_greedy", "fold_commit_banks", "preempt_batch"]
        if batch < CONFIG6_PREEMPTORS:
            need.append("fold_usage")
        torch.cuda.reset_peak_memory_stats()
        out, launches = run_main_path(f"config-6 batch {batch}", need, lambda: drain6(
            "cuda", CONFIG6_NODES, CONFIG6_PREEMPTORS, batch))
        add(launches)
        verify_config6(out, f"config-6 batch {batch}")
        sched = out["sched"]
        verify_stage_planes(f"config-6 batch {batch}", sched, launches)
        st = sched.stats
        log(f"[drain] config-6 full ({CONFIG6_NODES} nodes, {CONFIG6_NODES * 7} bound, {CONFIG6_PREEMPTORS} "
            f"preemptors, batch {batch}): {len(out['assignments'])} placed, {len(out['victims'])} victims, every "
            f"victim below its preemptor's priority and never assumed, no node over its limits, device node bank "
            f"== fresh host encode with no nominee overlay; wall {out['wall']:.3f}s (it waits out the queue's "
            f"backoff), schedule_batch {out['batch_s']:.3f}s summed ({st['batches']} batches: sync "
            f"{st['sync_s']:.3f}s encode {st['encode_s']:.3f}s solve {st['solve_s']:.3f}s commit "
            f"{st['commit_s']:.3f}s); {st['preempt_batches']} preemption rounds, preempt_s {st['preempt_s']:.3f}, "
            f"preempted {st['preempted']}, reverify misses {st['preempt_reverify_miss']}, nominee folds "
            f"{st['nominee_folds']}; max_memory_allocated {torch.cuda.max_memory_allocated()} B; card {smi}; "
            f"launches {launches}")
    return config2_pods_per_s


def phase_mesh(smi, total):
    """The node mesh's main paths on the card, each against the same
    call's single-device drain (SINGLE): config 3 at full size on an
    8-shard mesh, then configs 4, 3-hard, 5 and 6 at 1/10. Every mesh batch
    on the sharded programs (sharded_fallbacks 0); the same placements (and
    for config 6 victims, nominations and preempted counts) and counters;
    the folded banks equal a fresh encode."""

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def same_stats(label, mesh_sched, one_sched, keys):
        a = {k: mesh_sched.stats[k] for k in keys}
        b = {k: one_sched.stats[k] for k in keys}
        check(a == b, f"{label}: counters {a} on the mesh, {b} on one device")
        check(mesh_sched.stats["sharded_fallbacks"] == 0,
              f"{label}: {mesh_sched.stats['sharded_fallbacks']} batches fell back off the mesh")

    keys = ("batches", "fold_batches", "arbiter_batches", "arbiter_place", "arbiter_defer", "arbiter_escalated",
            "tracked_batches", "gang_batches", "oracle_places")
    # (b) config 3 at full size
    torch.cuda.reset_peak_memory_stats()
    need = ["filter_mask", "score_matrix", "solve_sharded", "spread_score", "fold_commit_sharded"]
    (sched, nodes, pods, res, wall), launches = run_main_path("config-3 mesh", need, lambda: drain(
        "cuda", "config3", CONFIG3_NODES, CONFIG3_PODS, BATCH, deterministic=False, mesh=MESH_SHARDS))
    add(launches)
    check(launches["spread_score"] == sched.stats["batches"] and launches["match_terms"] == 0,
          f"config-3 mesh: {launches['spread_score']} spread_score and {launches['match_terms']} match launches for "
          f"{sched.stats['batches']} batches")
    one_sched, one_res, one_wall = SINGLE["config3"]
    check(res.scheduled == CONFIG3_PODS and res.assignments == one_res.assignments,
          f"config-3 mesh: {res.scheduled} placed, {sum(1 for k, v in one_res.assignments.items() if res.assignments.get(k) != v)}"
          f" placed differently from the single-device drain")
    check(launches["solve_greedy"] == 0 and launches["solve_sharded"] == sched.stats["batches"],
          f"config-3 mesh: {launches['solve_greedy']} single-device and {launches['solve_sharded']} sharded solves "
          f"for {sched.stats['batches']} batches")
    same_stats("config-3 mesh", sched, one_sched, keys)
    verify_capacity(sched, pods, res)
    verify_planes("config-3 mesh", sched)
    verify_stage_planes("config-3 mesh", sched, launches)
    verify_node_bank(sched)
    n_sigs = verify_sig_bank(sched)
    log_drain(f"config-3 mesh full ({CONFIG3_NODES} nodes, {CONFIG3_PODS} pods, batch {BATCH}, {MESH_SHARDS} shards)",
              sched, res, wall, smi)
    log(f"[mesh] config-3 full on node_mesh({MESH_SHARDS}): every pod placed, placements == the single-device drain's, "
        f"0 fallbacks, device node bank and signature bank ({n_sigs} signatures) == fresh host encode; "
        f"{res.scheduled / wall:.1f} pods/s on the mesh beside {one_res.scheduled / one_wall:.1f} pods/s on one "
        f"device (one call, card {smi}); launches {launches}")
    # (c) at 1/10, each against its single-device drain of phase 4
    n4, p4 = CONFIG4_NODES // 10, CONFIG4_PODS // 10
    need = ["filter_mask", "score_matrix", "interpod_filter", "solve_sharded_inb", "arbitrate_sharded",
            "fold_commit_sharded"]
    (sched, _, pods, res, wall), launches = run_main_path("config-4 mesh /10", need, lambda: drain(
        "cuda", "config4", n4, p4, 512, True, seed=3, mesh=MESH_SHARDS))
    add(launches)
    one_sched, one_res = SINGLE["config4"]
    check(res.assignments == one_res.assignments and res.scheduled == p4,
          f"config-4 mesh /10: {res.scheduled} placed, or placed differently from the single-device drain")
    same_stats("config-4 mesh /10", sched, one_sched, keys)
    verify_node_bank(sched)
    log(f"[mesh] config-4 /10 ({n4} nodes, {p4} pods, batch 512) on node_mesh({MESH_SHARDS}): placements and counters "
        f"== the single-device drain's ({sched.stats['arbiter_batches']} arbitrated, {sched.stats['tracked_batches']} "
        f"tracked batches; {wall:.2f}s); launches {launches}")
    n3, p3 = CONFIG3_NODES // 10, CONFIG3_PODS // 10
    need = ["filter_mask", "score_matrix", "spread_filter", "solve_sharded", "arbitrate_sharded",
            "fold_commit_sharded"]
    (sched, nodes, pods, res, wall), launches = run_main_path("config-3-hard mesh /10", need, lambda: drain(
        "cuda", "config3", n3, p3, HARD_BATCH, True, hard=True, mesh=MESH_SHARDS))
    add(launches)
    one_sched, one_res = SINGLE["config3-hard"]
    check(res.assignments == one_res.assignments and res.scheduled == p3,
          f"config-3-hard mesh /10: {res.scheduled} placed, or placed differently from the single-device drain")
    same_stats("config-3-hard mesh /10", sched, one_sched, keys)
    check(sched.stats["arbiter_batches"] == sched.stats["batches"] and sched.stats["arbiter_defer"] > 0,
          f"config-3-hard mesh /10: {sched.stats['arbiter_batches']} of {sched.stats['batches']} batches arbitrated, "
          f"{sched.stats['arbiter_defer']} defers")
    verify_node_bank(sched)
    log(f"[mesh] config-3-hard /10 ({n3} nodes, {p3} pods, batch {HARD_BATCH}) on node_mesh({MESH_SHARDS}): "
        f"placements, defers and counters == the single-device drain's ({sched.stats['arbiter_defer']} defers; "
        f"{wall:.2f}s); launches {launches}")
    n5, p5 = CONFIG5_NODES // 10, CONFIG5_GROUPS // 10 * 64
    (sched, _, pods, res, wall), launches = run_main_path(
        "config-5 mesh /10", ["filter_mask", "score_matrix", "solve_gang_sharded"],
        lambda: drain("cuda", "config5", n5, p5, 1024, False, seed=3, mesh=MESH_SHARDS))
    add(launches)
    one_sched, one_res = SINGLE["config5"]
    check(res.assignments == one_res.assignments and res.scheduled == p5 and launches["solve_gang"] == 0,
          f"config-5 mesh /10: {res.scheduled} placed, or placed differently from the single-device drain")
    same_stats("config-5 mesh /10", sched, one_sched, keys)
    log(f"[mesh] config-5 /10 ({n5} nodes, {p5 // 64} groups of 64, batch 1024, tie-noise) on "
        f"node_mesh({MESH_SHARDS}): placements and counters == the single-device drain's "
        f"({sched.stats['gang_batches']} gang batches; {wall:.2f}s); launches {launches}")
    n6, p6 = CONFIG6_NODES // 10, CONFIG6_PREEMPTORS // 10
    need = ["filter_mask", "score_matrix", "solve_sharded", "fold_commit_sharded", "preempt_batch",
            "fold_usage_sharded"]
    out, launches = run_main_path("config-6 mesh /10", need, lambda: drain6(
        "cuda", n6, p6, CONFIG6_SMALL_BATCH, stepped=True, mesh=MESH_SHARDS))
    add(launches)
    one = SINGLE["config6"]
    for key in ("assignments", "victims", "nominations", "preempted"):
        check(out[key] == one[key], f"config-6 mesh /10: {key} differ from the single-device drain")
    same_stats("config-6 mesh /10", out["sched"], one["sched"], keys + ("nominee_folds", "preempt_batches"))
    check(launches["fold_usage"] == 0, f"config-6 mesh /10: {launches['fold_usage']} single-device usage folds")
    log(f"[mesh] config-6 /10 ({n6} nodes, {p6} preemptors, batch {CONFIG6_SMALL_BATCH}, stepped clock) on "
        f"node_mesh({MESH_SHARDS}): placements, victims in order, nominations after every batch and preempted "
        f"count == the single-device drain's ({out['sched'].stats['nominee_folds']} nominee folds; "
        f"{out['wall']:.2f}s); launches {launches}")


# ---------------------------------------------------------------------------
# the Policy config and the HTTP extender seams
# ---------------------------------------------------------------------------

# the RequestedToCapacityRatio shapes the score kernel is held to: the
# default (spread to the least used), two-point bin-packing, and five points
# with down-sloping segments (Go's truncating division) over cpu 3 / memory 1
RTCR_CASES = {
    "default": None,
    "binpack": (((0, 0), (100, 10)), (("cpu", 1), ("memory", 1))),
    "down": (((0, 2), (20, 9), (45, 1), (80, 6), (100, 0)), (("cpu", 3), ("memory", 1))),
}
# the chip-smoke RTCR Policy's priorities (RTCR at weight 2)
RTCR_PRIORITIES = (("RequestedToCapacityRatioPriority", 2), ("NodeAffinityPriority", 1),
                   ("TaintTolerationPriority", 1))
RTCR_POLICY = {
    "kind": "Policy",
    "predicates": [{"name": n} for n in ("GeneralPredicates", "PodToleratesNodeTaints", "CheckNodeUnschedulable",
                                         "MatchInterPodAffinity")],
    "priorities": [
        {"name": "BinPack", "weight": 2, "argument": {"requestedToCapacityRatioArguments": {
            "shape": [{"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}]}}},
        {"name": "NodeAffinityPriority", "weight": 1},
        {"name": "TaintTolerationPriority", "weight": 1},
    ],
}
ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"
REGION_KEY = "failure-domain.beta.kubernetes.io/region"
# the custom-argument Policy: its predicates and priorities run as framework
# plugins, so every pod re-ranks on the host over every node
CUSTOM_POLICY = {
    "kind": "Policy",
    "predicates": [
        {"name": "GeneralPredicates"}, {"name": "PodToleratesNodeTaints"},
        {"name": "NoRetiring", "argument": {"labelsPresence": {"labels": ["retiring"], "presence": False}}},
        {"name": "SvcRegion", "argument": {"serviceAffinity": {"labels": [REGION_KEY]}}},
    ],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "PreferSSD", "weight": 2, "argument": {"labelPreference": {"label": "disktype", "presence": True}}},
        {"name": "SvcSpread", "weight": 3, "argument": {"serviceAntiAffinity": {"label": ZONE_KEY}}},
    ],
}
# the custom-argument drain: config 1's 500 nodes; the pods are cut from
# 5,000 to what the host plugins' per-pod scans finish in about a minute
CUSTOM_NODES = 500
CUSTOM_PODS = 1000
# the extender phase: config 3's full cluster holding bound config 3-hard
# and config 4 pods; /filter requests for the next pods of both
EXT_BOUND3 = 20000
EXT_BOUND4 = 2000
EXT_REQUESTS = 256
EXT_ORACLE_STRIDE = 8  # the oracle path answers every 8th request (32)
# the Scheduler consulting an in-script extender: config 1's shapes
CLIENT_NODES = 500
CLIENT_PODS = 1000

def filter_mask_work(na, ea, xa, ta, au, pa, kinds, v):
    """(bytes, integer operations) of ops/pipeline.filter_mask with every
    predicate on: filter_work, plus spread_filter_work under DoNotSchedule
    spread and interpod_work's filter over the inter-pod parts present,
    less the intermediate masks the composition never needs to write."""
    from kubernetes_tpu_torch.ops import topology as TO

    works = [filter_work(na, pa)]
    u, n = pa["valid"].shape[0], na["valid"].shape[0]
    if "spread_hard" in kinds:
        works.append(spread_filter_work(na, ea, ta, TO.match_terms_plain(ta, ea["label_vals"], ea["ns_id"]), u, v,
                                        tables=False))
    parts = tuple(p for p, k in (("existing", "et_anti"), ("aff", "aff_req"), ("anti", "anti_req")) if k in kinds)
    if parts:
        m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
        m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
        works.append(interpod_work("interpod_filter", na, ea, xa, ta, au, pa, parts, m_pt, m_sig))
    return sum(w[0] for w in works) - (len(works) - 1) * u * n, sum(w[1] for w in works)


def compare_policy_scores(na, pa, label):
    """The score kernel's RTCR branch (three shapes, beside NodeAffinity and
    TaintToleration, with a bias) and its component mode against their
    plain versions on the same CUDA tensors; times (the entry alone: one
    prebuilt struct relaunched), plain times and bounds. Returns {kernel:
    stats}."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import scores as S

    dev = na["valid"].device
    err = 0
    for rtcr in RTCR_CASES.values():
        k = S.score_matrix(na, pa, RTCR_PRIORITIES, rtcr, bias=10)
        p = S.score_matrix_plain(na, pa, RTCR_PRIORITIES, rtcr, bias=10)
        err = max(err, int((k - p).abs().max()))
    check(err == 0, f"[{label}] the score kernel's RTCR branch differs from its plain version by {err}")
    rtcr = RTCR_CASES["binpack"]
    args, _ = S.score_args(na, pa, RTCR_PRIORITIES, bias=10, rtcr=rtcr)
    out = {"score_matrix[rtcr]": {
        "max_abs_err": err,
        "ms": cuda_ms(lambda: build.launch(S.SCORE_ENTRY, args, dev), 200),
        "wrapper_ms": cuda_ms(lambda: S.score_matrix(na, pa, RTCR_PRIORITIES, rtcr, bias=10), 200),
        "plain_ms": cuda_ms(lambda: S.score_matrix_plain(na, pa, RTCR_PRIORITIES, rtcr, bias=10), 3),
        "bound": bound(score_work(na, pa, RTCR_PRIORITIES, rtcr)),
    }}
    got, want = S.score_components(na, pa), S.score_components_plain(na, pa)
    check(list(got) == list(want), f"[{label}] score_components planes {list(got)} != {list(want)}")
    err_c = max(int((got[k] - want[k]).abs().max()) for k in want)
    check(err_c == 0, f"[{label}] the score kernel's component mode differs from its plain version by {err_c}")
    cargs, _ = S.score_args(na, pa, n_components=len(want))
    out["score_components"] = {
        "max_abs_err": err_c,
        "ms": cuda_ms(lambda: build.launch(S.SCORE_ENTRY, cargs, dev), 200),
        "wrapper_ms": cuda_ms(lambda: S.score_components(na, pa), 200),
        "plain_ms": cuda_ms(lambda: S.score_components_plain(na, pa), 3),
        "bound": bound(score_work(na, pa, n_components=len(want))),
    }
    log(f"[kernels] {label}: U={pa['valid'].shape[0]} N={na['valid'].shape[0]}: the RTCR branch exact on the "
        f"{', '.join(RTCR_CASES)} shapes; score_components exact ({len(want)} planes: {', '.join(want)})")
    for name, st in out.items():
        log(f"[kernels] {label} {name}: kernel {st['ms']:.4f} ms (through its wrapper {st['wrapper_ms']:.4f} ms), "
            f"plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms ({st['bound'][1]}); no single PyTorch "
            f"call computes it")
    return out


def compare_score_shapes(na, pa, label):
    """The score kernel at a main path's shapes in all three modes: the
    default tuple (and two Policy weightings) exact and timed, then the
    RTCR branch and the component mode (compare_policy_scores). Returns
    {kernel: stats}."""
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import scores as S

    err = 0
    for pr in (None, (("MostRequestedPriority", 2), ("ResourceLimitsPriority", 3), ("NodeAffinityPriority", 5)),
               tuple((name, i + 1) for i, name in enumerate(S.PRIORITIES))):
        err = max(err, int((S.score_matrix(na, pa, pr, bias=10) - S.score_matrix_plain(na, pa, pr, bias=10)).abs()
                           .max()))
    check(err == 0, f"[{label}] score kernel differs from its plain version by {err}")
    args, _ = S.score_args(na, pa, bias=10)
    out = {"score_matrix": {
        "max_abs_err": err, "ctas_a_row": args.C, "tiles_a_cta": args.TPC,
        "ms": cuda_ms(lambda: build.launch(S.SCORE_ENTRY, args, na["valid"].device), 200),
        "wrapper_ms": cuda_ms(lambda: S.score_matrix(na, pa, bias=10), 200),
        "plain_ms": cuda_ms(lambda: S.score_matrix_plain(na, pa, bias=10), 3),
        "bound": bound(score_work(na, pa)),
    }}
    st = out["score_matrix"]
    log(f"[kernels] {label} score_matrix (U={pa['valid'].shape[0]} N={na['valid'].shape[0]}, clusters of "
        f"{args.C} CTAs, {args.TPC} tiles a CTA): kernel {st['ms']:.4f} ms (through its wrapper "
        f"{st['wrapper_ms']:.4f} ms), plain {st['plain_ms']:.4f} ms, bound {st['bound'][0]:.6f} ms ({st['bound'][1]})")
    out.update(compare_policy_scores(na, pa, label))
    return out


def score_launch_counts():
    from kubernetes_tpu_torch.ops import scores as S
    from kubernetes_tpu_torch.ops import topology as TO

    return (S.score_matrix.launches, TO.spread_score.launches, TO.interpod_score.launches,
            TO.selector_spread_score.launches)


def compare_filter_mask(inputs, label, time_it: bool):
    """ops/pipeline.filter_mask (the extender's /filter program) against
    its plain composition on the same CUDA tensors, under every predicate
    and under the two topology gates alone; no score, spread-score or
    inter-pod-score kernel may launch. With time_it, the whole composition
    through its wrapper (its kernels run in sequence), the plain one and
    the bound. Returns its stats."""
    from kubernetes_tpu_torch.ops import pipeline as PP

    bad = 0
    for preds in (None, frozenset({"GeneralPredicates", "EvenPodsSpread"}),
                  frozenset({"GeneralPredicates", "MatchInterPodAffinity"})):
        kw = dict(inputs, config=PP.SolveConfig(predicates=preds) if preds is not None else inputs["config"])
        before = score_launch_counts()
        got = PP.filter_mask(**kw)
        torch.cuda.synchronize()
        check(score_launch_counts() == before, f"[{label}] filter_mask launched a score kernel")
        bad += int((got != PP.filter_mask_plain(**kw)).sum())
    check(bad == 0, f"[{label}] filter_mask differs from its plain version in {bad} pairs")
    mask = PP.filter_mask(**inputs)
    pa = inputs["pa"]
    out = {"max_abs_err": min(bad, 1), "feasible": int(mask[pa["valid"]].sum())}
    if time_it:
        out["ms"] = cuda_ms(lambda: PP.filter_mask(**inputs), 50)
        out["plain_ms"] = cuda_ms(lambda: PP.filter_mask_plain(**inputs), 3)
        out["bound"] = bound(filter_mask_work(inputs["na"], inputs["ea"], inputs["xa"], inputs["ta"], inputs["au"],
                                              pa, inputs["term_kinds"], inputs["n_buckets"]))
    log(f"[kernels] {label}: filter_mask exact under 3 predicate sets, no score kernel launched (U="
        f"{pa['valid'].shape[0]} N={inputs['na']['valid'].shape[0]} kinds {sorted(inputs['term_kinds'])}, "
        f"{out['feasible']} feasible pairs)"
        + (f"; through its wrapper {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound "
           f"{out['bound'][0]:.6f} ms ({out['bound'][1]})" if time_it else ""))
    return out


def extender_request_kernels():
    """A config-4 pod's /filter request (its required terms and the bound
    pods' patterns) on the extender's cluster, as the ExtenderServer builds
    it (phase 3: the server is never started): filter_mask through its
    wrapper and the inter-pod filter alone, each exact and timed."""
    from kubernetes_tpu_torch.extender import ExtenderServer
    from kubernetes_tpu_torch.models.clusters import fill_cache
    from kubernetes_tpu_torch.state.cache import SchedulerCache

    nodes, existing, pending = extender_cluster()
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    srv = ExtenderServer(cache=cache, device="cuda")
    try:
        req = srv.filter_inputs(pending[1])
        label = "extender /filter request (config-4 pod)"
        return {"filter_mask": compare_filter_mask(req, label, time_it=True),
                "interpod_filter": interpod_filter_request(req, label)}
    finally:
        srv.stop()


def interpod_filter_request(inputs, label):
    """The inter-pod filter at an extender request's shapes (U = 16 rows,
    one live): its parts and the match plan as filter_mask builds them;
    exact against its plain version, then timed (time_interpod_filter).
    Returns its stats."""
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import topology as TO

    cfg = inputs["config"] or PP.DEFAULT_SOLVE_CONFIG
    kinds = PP._check_term_kinds(inputs["term_kinds"])
    parts = PP._filter_parts(cfg, kinds)
    check(bool(parts), f"[{label}] the request runs no inter-pod filter part ({sorted(kinds)})")
    na, ea, ta, au, xa, pa, v = (inputs[k] for k in ("na", "ea", "ta", "au", "xa", "pa", "n_buckets"))
    plan = PP.match_plan(pa, cfg, kinds, ea=ea, ta=ta, xa=xa, score=False)
    m_pt = plan.get("m_pt", TO.match_terms(xa, pa["label_vals"], pa["ns_id"]))
    m_sig = plan.get("m_sig", TO.match_terms(ta, ea["label_vals"], ea["ns_id"]))
    got = TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=v, m_pt=m_pt, m_sig=m_sig)
    check(torch.equal(got, TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, v)),
          f"[{label}] interpod_filter differs from its plain version")
    st = time_interpod_filter(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, v, label)
    st["parts"] = list(parts)
    st["shape"] = {"U": pa["valid"].shape[0], "live": int(pa["valid"].sum()), "N": na["valid"].shape[0], "V": v,
                   "PT": xa["valid"].shape[0], "TT": ta["valid"].shape[0]}
    return st


def enc_filter_inputs(enc):
    """filter_mask's keyword arguments for an `encode`d batch."""
    return dict(na=enc["na"], pa=enc["pa"], ids=enc["ids"], config=None, term_kinds=enc["kinds"], ea=enc["ea"],
                ta=enc["ta"], au=enc["au"], xa=enc["xa"], n_buckets=enc["v"])


def policy_drain(device, n_nodes, n_pods, batch, policy=None):
    """bench.py config 2 through `Configurator(...).create_from_config`
    under the RTCR bin-packing Policy, the pods admitted to the running
    scheduler."""
    from kubernetes_tpu_torch.config import Configurator
    from kubernetes_tpu_torch.models.clusters import bench_config2, fill_cache
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    nodes, pods = bench_config2(n_nodes, n_pods)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes)
    sched = Configurator(device=device, cache=cache, queue=queue, batch_size=batch, seed=0).create_from_config(
        policy or RTCR_POLICY)
    for p in pods:
        queue.add(p)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sched.run_until_empty(max_cycles=100000)
    sched.wait_for_binds()
    wall = time.perf_counter() - t0
    sched.close()
    return sched, nodes, pods, res, wall


def custom_policy_drain(device):
    """The custom-argument Policy on `policy_cluster` (config 1's nodes in
    8 zones over 2 regions, one Service per app, one bound anchor a app)."""
    from kubernetes_tpu_torch.config import Configurator
    from kubernetes_tpu_torch.models.clusters import fill_cache, policy_cluster
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    nodes, anchors, pods, services = policy_cluster(CUSTOM_NODES, CUSTOM_PODS)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes, anchors)
    sched = Configurator(device=device, cache=cache, queue=queue, batch_size=256, seed=0,
                         service_lister=lambda: services).create_from_config(CUSTOM_POLICY)
    for p in pods:
        queue.add(p)
    t0 = time.perf_counter()
    res = sched.run_until_empty(max_cycles=1000)
    sched.wait_for_binds()
    wall = time.perf_counter() - t0
    sched.close()
    return sched, nodes, anchors, pods, res, wall


def verify_custom_policy(sched, nodes, anchors, pods, res, label):
    """Every pod placed, none on a retiring node, each app in its anchor's
    region (serviceAffinity), no node over its limits."""
    check(res.scheduled == len(pods), f"{label}: {res.scheduled} of {len(pods)} pods placed")
    node_of = {n.name: n for n in nodes}
    region_of_app = {a.labels["app"]: node_of[a.node_name].labels[REGION_KEY] for a in anchors}
    bad = sum(1 for p in pods if "retiring" in node_of[res.assignments[p.key()]].labels
              or node_of[res.assignments[p.key()]].labels[REGION_KEY] != region_of_app[p.labels["app"]])
    check(bad == 0, f"{label}: {bad} placements on a retiring node or outside their app's region")
    mirror = sched.mirror
    mirror.sync()
    bank = mirror.nodes
    valid = bank.valid
    check(bool((bank.requested[valid] <= bank.alloc[valid]).all()), f"{label}: a node's requests exceed its allocatable")
    check(bool((bank.pod_count[valid] <= bank.allowed_pods[valid]).all()), f"{label}: a node holds too many pods")
    check(sched.stats["oracle_places"] == len(pods), f"{label}: oracle_places {sched.stats['oracle_places']} != "
          f"{len(pods)} pods")


def phase_policy(smi, total, default_pods_per_s):
    """The RTCR Policy drains (config 2 full on cuda, its pods/s beside the
    default provider's drain of this call; at 1/10 cuda == cpu) and the
    custom-argument Policy drain (cuda == cpu)."""

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    torch.cuda.reset_peak_memory_stats()
    need = ["filter_mask", "score_matrix", "score_matrix[rtcr]", "solve_greedy", "fold_commit_banks"]
    (sched, nodes, pods, res, wall), launches = run_main_path(
        "config-2 RTCR Policy", need, lambda: policy_drain("cuda", CONFIG2_NODES, CONFIG2_PODS, BATCH))
    add(launches)
    verify_drain(sched, nodes, pods, res, "cuda")
    verify_stage_planes("config-2 RTCR Policy", sched, launches)
    verify_node_bank(sched)
    st = sched.stats
    check(launches["score_matrix[rtcr]"] == st["batches"],
          f"config-2 RTCR Policy: {launches['score_matrix[rtcr]']} RTCR score launches for {st['batches']} batches")
    used = int((sched.mirror.nodes.pod_count[sched.mirror.nodes.valid] > 0).sum())
    log_drain(f"config-2 RTCR Policy full ({CONFIG2_NODES} nodes, {CONFIG2_PODS} pods, batch {BATCH})", sched, res,
              wall, smi)
    log(f"[policy] config-2 RTCR bin-packing Policy: {res.scheduled / wall:.1f} pods/s against the default "
        f"provider's {default_pods_per_s:.1f} pods/s in this call; the pods packed "
        f"onto {used} of {CONFIG2_NODES} nodes; every batch one RTCR score launch; launches {launches}")
    # 1/10: cuda == cpu pod for pod
    small = {}
    for device in ("cuda", "cpu"):
        sched, nodes, pods, res, wall = policy_drain(device, CONFIG2_NODES // 10, CONFIG2_PODS // 10, BATCH // 8)
        small[device] = (res.assignments, res.scheduled)
        check(res.scheduled == len(pods), f"config-2 RTCR Policy at 1/10 on {device}: {res.scheduled} placed")
    check(small["cuda"] == small["cpu"], "config-2 RTCR Policy at 1/10: cuda and cpu placements differ")
    log(f"[policy] config-2 RTCR Policy at 1/10 ({CONFIG2_NODES // 10} nodes, {CONFIG2_PODS // 10} pods, batch "
        f"{BATCH // 8}): cuda == cpu pod for pod")
    # the custom-argument Policy: host plugins on every pod
    out = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            (sched, nodes, anchors, pods, res, wall), launches = run_main_path(
                "custom-argument Policy", ["filter_mask", "score_matrix", "solve_greedy", "gather_score_rows"],
                lambda: custom_policy_drain("cuda"))
            add(launches)
        else:
            sched, nodes, anchors, pods, res, wall = custom_policy_drain("cpu")
        verify_custom_policy(sched, nodes, anchors, pods, res, f"custom-argument Policy on {device}")
        out[device] = (res.assignments, sched.stats["oracle_places"])
        log(f"[policy] custom-argument Policy on {device} ({CUSTOM_NODES} nodes, {CUSTOM_PODS} pods, cut from "
            f"config 1's 5,000 to what the host plugins' per-pod scans finish in about a minute): every pod placed "
            f"outside the retiring nodes and inside its app's region, oracle_places {sched.stats['oracle_places']}, "
            f"{wall:.3f}s ({res.scheduled / wall:.1f} pods/s)")
    check(out["cuda"] == out["cpu"], "custom-argument Policy: cuda and cpu placements differ")


def extender_cluster():
    """Config 3's full 10,000-node cluster holding EXT_BOUND3 config 3-hard
    pods (round-robin) and EXT_BOUND4 config-4 pods (pod i on node 7 i mod
    N); the next EXT_REQUESTS pods of both, interleaved."""
    from kubernetes_tpu_torch.models.clusters import bench_config3, bench_config4

    nodes, pods3, _ = bench_config3(CONFIG3_NODES, EXT_BOUND3 + EXT_REQUESTS // 2, hard=True)
    _, pods4 = bench_config4(CONFIG4_NODES, EXT_BOUND4 + EXT_REQUESTS // 2)
    for p in pods4:
        p.name = "c4-" + p.name  # config 4's names would collide with config 3's
    existing = [p.with_node(nodes[i % len(nodes)].name) for i, p in enumerate(pods3[:EXT_BOUND3])]
    existing += [p.with_node(nodes[(7 * i) % len(nodes)].name) for i, p in enumerate(pods4[:EXT_BOUND4])]
    pending = [p for pair in zip(pods3[EXT_BOUND3:], pods4[EXT_BOUND4:]) for p in pair]
    return nodes, existing, pending


def http_post(url, obj, timeout=300):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def phase_extender(smi, total, stats):
    """The port's ExtenderServer over config 3's full cluster: /filter in
    nodeCacheCapable mode with every node name, on cuda (every request the
    device path's), against the same cache's oracle path (a stride sample)
    and a CPU server; filter_mask at the request's shapes against its
    plain version; the other routes once each; then a Scheduler consulting
    an in-script extender over HTTP, cuda == cpu."""
    from kubernetes_tpu_torch.api.types import pod_to_k8s
    from kubernetes_tpu_torch.extender import ExtenderServer
    from kubernetes_tpu_torch.models.clusters import fill_cache
    from kubernetes_tpu_torch.state.cache import SchedulerCache

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    nodes, existing, pending = extender_cluster()
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    names = [n.name for n in nodes]
    bound_to = []
    srv = ExtenderServer(cache=cache, device="cuda", bind_fn=bound_to.append).start()
    oracle = ExtenderServer(cache=cache, device="cuda", device_threshold=len(names) + 1).start()
    cpu = ExtenderServer(cache=cache, device="cpu").start()
    log(f"[extender] config 3's cluster ({len(nodes)} nodes, {len(existing)} bound pods) built in "
        f"{time.perf_counter() - t0:.3f}s; {len(pending)} /filter requests of {len(names)} names each")
    bodies = [{"Pod": pod_to_k8s(p), "NodeNames": names} for p in pending]
    try:
        http_post(srv.url + "/filter", bodies[0])  # the mirror's first build and upload
        srv.stats.update(filter_device=0, filter_oracle=0, filter_errors=0)
        lat = []

        def serve():
            answers = []
            for body in bodies:
                t1 = time.perf_counter()
                answers.append(http_post(srv.url + "/filter", body))
                lat.append(time.perf_counter() - t1)
            return answers

        answers, launches = run_main_path("extender /filter",
                                          ["filter_mask", "pipeline.filter_mask", "spread_filter", "interpod_filter"],
                                          serve, staged=False)
        add(launches)
        st = srv.stats
        check(st == {"filter_device": len(bodies), "filter_oracle": 0, "filter_errors": 0},
              f"extender: the device path did not answer every request: {st}")
        check(launches["pipeline.filter_mask"] == len(bodies) and launches["score_matrix"] == 0,
              f"extender: {launches['pipeline.filter_mask']} filter_mask calls, {launches['score_matrix']} score "
              f"launches for {len(bodies)} requests")
        lat_o = []
        for k in range(0, len(bodies), EXT_ORACLE_STRIDE):
            t1 = time.perf_counter()
            got = http_post(oracle.url + "/filter", bodies[k])
            lat_o.append(time.perf_counter() - t1)
            check(sorted(got["NodeNames"]) == sorted(answers[k]["NodeNames"])
                  and set(got["FailedNodes"]) == set(answers[k]["FailedNodes"]),
                  f"extender: request {k}'s device answer differs from the oracle path's")
        check(oracle.stats["filter_oracle"] == len(lat_o), f"extender: oracle server counters {oracle.stats}")
        t1 = time.perf_counter()
        for k, body in enumerate(bodies):
            check(http_post(cpu.url + "/filter", body) == answers[k],
                  f"extender: request {k}'s cuda answer differs from the cpu server's")
        cpu_s = time.perf_counter() - t1
        check(cpu.stats["filter_device"] == len(bodies) and cpu.stats["filter_errors"] == 0,
              f"extender: cpu server counters {cpu.stats}")
        feasible = [len(a["NodeNames"]) for a in answers]
        log(f"[extender] /filter on cuda: {len(bodies)} requests, every one by the device path ({st}); encode memo "
            f"{srv.filter_encode_cache}; feasible nodes per request min {min(feasible)} median "
            f"{percentile(feasible, 0.5)} max {max(feasible)}; latency median {percentile(lat, 0.5) * 1e3:.3f} ms "
            f"p99 {percentile(lat, 0.99) * 1e3:.3f} ms (host clock, HTTP included); card {smi}")
        log(f"[extender] /filter oracle path (device_threshold above N, every {EXT_ORACLE_STRIDE}th request: "
            f"{len(lat_o)}): the same answers; latency median {percentile(lat_o, 0.5) * 1e3:.3f} ms p99 "
            f"{percentile(lat_o, 0.99) * 1e3:.3f} ms; the cpu server's {len(bodies)} answers equal the cuda ones "
            f"({cpu_s:.3f}s); launches {launches}")
        # filter_mask at the request's shapes: held to its plain version, timed
        stats["pipeline.filter_mask"] = compare_filter_mask(srv.filter_inputs(pending[0]), "extender /filter request",
                                                            time_it=True)
        stats["pipeline.filter_mask"]["latency_ms"] = (percentile(lat, 0.5) * 1e3, percentile(lat_o, 0.5) * 1e3)
        # the other routes once each
        pr = http_post(srv.url + "/prioritize", {"Pod": pod_to_k8s(pending[1]), "NodeNames": names[:200]})
        check(len(pr) == 200 and all(0 <= d["Score"] <= 10 for d in pr), "extender: /prioritize answer out of range")
        br = http_post(srv.url + "/bind", {"PodName": pending[0].name, "PodNamespace": pending[0].namespace,
                                           "PodUID": pending[0].uid, "Node": names[0]})
        check(br["Error"] == "" and bound_to[0].node == names[0], f"extender: /bind answered {br}")
        victim = existing[0]
        mv = http_post(srv.url + "/preemption", {"Pod": pod_to_k8s(pending[0]), "NodeNameToMetaVictims": {
            victim.node_name: {"Pods": [{"UID": victim.uid}], "NumPDBViolations": 0},
            "ghost": {"Pods": [{"UID": victim.uid}], "NumPDBViolations": 0}}})
        check(list(mv["NodeNameToMetaVictims"]) == [victim.node_name], f"extender: /preemption answered {mv}")
        import urllib.request

        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            check(json.loads(r.read())["ok"] is True, "extender: /healthz")
        log("[extender] /prioritize, /bind, /preemption and /healthz answered")
    finally:
        for s in (srv, oracle, cpu):
            s.stop()
    phase_extender_client(total)


def extender_client_drain(device, url):
    """config 1's shapes (CLIENT_NODES nodes, CLIENT_PODS pods) through a
    Scheduler consulting the in-script extender (weight 100) and a dead,
    ignorable one."""
    from kubernetes_tpu_torch.extender import ExtenderConfig, HTTPExtender
    from kubernetes_tpu_torch.models.clusters import bench_config1, fill_cache
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    nodes, pods = bench_config1(CLIENT_NODES, CLIENT_PODS)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes)
    exts = [HTTPExtender(ExtenderConfig(url_prefix=url, filter_verb="filter", prioritize_verb="prioritize",
                                        weight=100, node_cache_capable=True)),
            HTTPExtender(ExtenderConfig(url_prefix="http://127.0.0.1:1", filter_verb="filter",
                                        node_cache_capable=True, ignorable=True, timeout_s=0.5))]
    sched = Scheduler(cache, queue, batch_size=256, seed=0, device=device, extenders=exts)
    for p in pods:
        queue.add(p)
    t0 = time.perf_counter()
    res = sched.run_until_empty(max_cycles=1000)
    sched.wait_for_binds()
    wall = time.perf_counter() - t0
    sched.close()
    return sched, pods, res, wall


def phase_extender_client(total):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading

    class EvenNodes(BaseHTTPRequestHandler):
        """Keeps the nodes with an even index; prioritizes by the index mod
        11 (an extender's 0-10 range)."""

        def log_message(self, fmt, *a):
            pass

        def do_POST(self):
            payload = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
            index = lambda name: int(name.rsplit("-", 1)[1])  # noqa: E731
            if self.path.endswith("/filter"):
                out = {"NodeNames": [x for x in payload["NodeNames"] if index(x) % 2 == 0], "FailedNodes": {},
                       "Error": ""}
            else:
                out = [{"Host": x, "Score": index(x) % 11} for x in payload["NodeNames"]]
            body = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), EvenNodes)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = {}
        for device in ("cuda", "cpu"):
            if device == "cuda":
                (sched, pods, res, wall), launches = run_main_path(
                    "extender client", ["filter_mask", "score_matrix", "solve_greedy", "gather_score_rows"],
                    lambda: extender_client_drain("cuda", url))
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            else:
                sched, pods, res, wall = extender_client_drain("cpu", url)
            check(res.scheduled == len(pods) and res.errors == 0, f"extender client on {device}: "
                  f"{res.scheduled} of {len(pods)} placed, {res.errors} errors")
            odd = [k for k, n in res.assignments.items() if int(n.rsplit("-", 1)[1]) % 2]
            check(not odd, f"extender client on {device}: {len(odd)} pods on odd nodes")
            out[device] = res.assignments
            log(f"[extender] a Scheduler consulting an in-script extender (even nodes, index prioritize, weight "
                f"100) and a dead ignorable one on {device}: {CLIENT_NODES} nodes, {CLIENT_PODS} pods, every pod on "
                f"an even node, oracle_places {sched.stats['oracle_places']}, {wall:.3f}s")
        check(out["cuda"] == out["cpu"], "extender client: cuda and cpu placements differ")
    finally:
        httpd.shutdown()
        httpd.server_close()


def verify_config6(out, label):
    """Every preemptor placed; no plan rejected by the host
    re-verification; no node over its allocatable or pod limit; the device
    node bank equal to a fresh host encode, with no nominee overlay on it
    (the victims' priorities and assumed state are checked as they go, in
    drain6's hooks)."""
    sched = out["sched"]
    n_pre = len(out["pending"])
    check(len(out["assignments"]) == n_pre, f"{label}: {len(out['assignments'])} of {n_pre} preemptors placed")
    check(sched.stats["preempt_reverify_miss"] == 0,
          f"{label}: {sched.stats['preempt_reverify_miss']} plans rejected by the host re-verification")
    check(sched.mirror._nominee_overlay is None and not sched.queue.has_nominations(),
          f"{label}: a nominee overlay or a nomination is left")
    mirror = sched.mirror
    mirror.sync()
    bank = mirror.nodes
    valid = bank.valid
    check(bool((bank.requested[valid] <= bank.alloc[valid]).all()), f"{label}: a node's requests exceed its allocatable")
    check(bool((bank.pod_count[valid] <= bank.allowed_pods[valid]).all()), f"{label}: a node holds too many pods")
    want = len(out["existing"]) - len(out["victims"]) + n_pre
    check(int(bank.pod_count[valid].sum()) == want, f"{label}: the node bank counts {int(bank.pod_count[valid].sum())} "
          f"pods, expected {want}")
    verify_node_bank(sched)


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
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"[time] {what} {now - clock[0]:.1f}s")
        clock[0] = now

    stats = phase_kernels()
    lap("phase 3 kernels")
    launches = dict(phase_parity())
    lap("phase 4 parity")
    for k, v in phase_oracle_parity().items():
        launches[k] = launches.get(k, 0) + v
    lap("phase 4 oracle parity")
    for k, v in phase_gang_parity().items():
        launches[k] = launches.get(k, 0) + v
    lap("phase 4 gang parity")
    config2_pods_per_s = phase_drain(smi, launches)
    lap("phase 5 drains")
    phase_mesh(smi, launches)
    lap("phase 5 mesh drains")
    phase_policy(smi, launches, config2_pods_per_s)
    lap("phase 5 Policy drains")
    phase_extender(smi, launches, stats)
    lap("phase 5 extender")
    sources = {
        "filter_mask": ("kubernetes_tpu_torch/csrc/filters.cu", "kubernetes_tpu/ops/filters.py:216"),
        "score_matrix": ("kubernetes_tpu_torch/csrc/scores.cu", "kubernetes_tpu/ops/scores.py:262"),
        "solve_greedy": ("kubernetes_tpu_torch/csrc/solver.cu", "kubernetes_tpu/ops/solver.py:90"),
        "match_terms": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:49"),
        "match_terms[plan]": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:49"),
        "spread_score": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:227"),
        "selector_spread_score": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:433"),
        "interpod_filter": ("kubernetes_tpu_torch/csrc/interpod.cu", "kubernetes_tpu/ops/topology.py:281"),
        "interpod_score": ("kubernetes_tpu_torch/csrc/interpod.cu", "kubernetes_tpu/ops/topology.py:363"),
        "inbatch_port_conflict": ("kubernetes_tpu_torch/csrc/interpod.cu", "kubernetes_tpu/ops/pipeline.py:178"),
        "solve_greedy_inb": ("kubernetes_tpu_torch/csrc/solver.cu", "kubernetes_tpu/ops/solver.py:175"),
        "spread_filter": ("kubernetes_tpu_torch/csrc/topology.cu", "kubernetes_tpu/ops/topology.py:182"),
        "arbitrate": ("kubernetes_tpu_torch/csrc/arbiter.cu", "kubernetes_tpu/commit/arbiter.py:157"),
        "fold_commit_banks": ("kubernetes_tpu_torch/csrc/fold.cu", "kubernetes_tpu/ops/fold.py:44"),
        "preempt_batch": ("kubernetes_tpu_torch/csrc/preempt.cu", "kubernetes_tpu/ops/preempt.py:63"),
        "fold_usage": ("kubernetes_tpu_torch/csrc/fold.cu", "kubernetes_tpu/ops/fold.py:74"),
        "gather_score_rows": ("kubernetes_tpu_torch/csrc/gather.cu", "kubernetes_tpu/ops/pipeline.py:374"),
        "solve_gang": ("kubernetes_tpu_torch/csrc/solver.cu", "kubernetes_tpu/ops/solver.py:366"),
        "gather_batch": ("kubernetes_tpu_torch/csrc/slab.cu",
                         "kubernetes_tpu/ingest/gather.py:28 and kubernetes_tpu/terms_plane/gather.py:28"),
        "scatter_rows": ("kubernetes_tpu_torch/csrc/slab.cu", "kubernetes_tpu/ingest/bank.py:54"),
        "score_matrix[rtcr]": ("kubernetes_tpu_torch/csrc/scores.cu", "kubernetes_tpu/ops/scores.py:183"),
        "score_components": ("kubernetes_tpu_torch/csrc/scores.cu", "kubernetes_tpu/ops/scores.py:288"),
        "pipeline.filter_mask": ("kubernetes_tpu_torch/csrc/filters.cu", "kubernetes_tpu/ops/pipeline.py:131"),
        "solve_sharded": ("kubernetes_tpu_torch/csrc/solver.cu", "kubernetes_tpu/parallel/sharded.py:51"),
        "solve_sharded_inb": ("kubernetes_tpu_torch/csrc/solver.cu", "kubernetes_tpu/parallel/sharded.py:89"),
        "solve_gang_sharded": ("kubernetes_tpu_torch/csrc/solver.cu", "kubernetes_tpu/parallel/sharded.py:435"),
        "arbitrate_sharded": ("kubernetes_tpu_torch/csrc/arbiter.cu", "kubernetes_tpu/commit/arbiter.py:323"),
        "fold_commit_sharded": ("kubernetes_tpu_torch/csrc/fold.cu", "kubernetes_tpu/ops/fold.py:156"),
        "fold_usage_sharded": ("kubernetes_tpu_torch/csrc/fold.cu", "kubernetes_tpu/ops/fold.py:164"),
    }
    kernels = []
    for kname, (src, ref) in sources.items():
        s = stats[kname]
        # score_components has no caller on a main path (the reference's only
        # caller is a test): its launches there are 0
        check(launches[kname] > 0 or kname == "score_components", f"kernel {kname} was not launched by the drains")
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": ref,
            "launches": launches[kname], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound"][0], "bound_by": s["bound"][1], "library_ms": s.get("library_ms"),
        })
    red = stats["_redesign"]["spread filter and feasibility mask"]
    ext = stats["pipeline.filter_mask"]
    red["extender filter_mask"] = {"wrapper_ms": ext["ms"], "before_wrapper_ms": BEFORE_MS["pipeline.filter_mask"],
                                   "bound_ms": ext["bound"][0]}
    red["main path device-memory launches"] = {k: launches.get(k, 0) for k in
                                               ("spread_filter[device tables]", "filter_mask[device memory]")}
    log(f"[redesign] extender filter_mask: {ext['ms']:.4f} ms through its wrapper (before "
        f"{BEFORE_MS['pipeline.filter_mask']:.4f}); main path device-memory launches "
        f"{red['main path device-memory launches']}")
    red = stats["_redesign"]["spread score and term match"]
    red["match launches a batch"] = MATCHES
    red["main path device-table launches"] = launches.get("spread_score[device tables]", 0)
    log(f"[redesign] match launches a batch {MATCHES}; spread_score device-table launches on the main path "
        f"{red['main path device-table launches']}")
    red = stats["_redesign"]["inter-pod filter and selector spread"]
    req = stats.pop("_request4")
    ipr = req["interpod_filter"]
    red["interpod_filter extender request"] = {
        **{k: ipr[k] for k in ("ms", "device_ms", "wrapper_ms", "ctas_ms", "layout", "rows", "parts", "shape",
                               "device_tables_ms")},
        "bound_ms": ipr["bound"][0], "filter_mask_wrapper_ms": req["filter_mask"]["ms"]}
    red["main path launches"] = {k: launches.get(k, 0) for k in (
        "interpod_filter", "interpod_filter[device tables]", "selector_spread_score",
        "selector_spread_score[device tables]")}
    check(red["main path launches"]["interpod_filter[device tables]"] == 0
          and red["main path launches"]["selector_spread_score[device tables]"] == 0,
          f"a main path took the inter-pod filter's or the selector spread's device tables: "
          f"{red['main path launches']}")
    log(f"[redesign] interpod_filter at a config-4 pod's /filter request {ipr['shape']} parts {ipr['parts']}: "
        f"{ipr['ms']:.4f} ms relaunched, {ipr['device_ms']:.4f} ms device duration, {ipr['wrapper_ms']:.4f} ms "
        f"through its wrapper, {ipr['rows'][0]} of {ipr['rows'][1]} rows tabulate, CTAs a spec row "
        f"{ipr['ctas_ms']}; filter_mask through its wrapper {req['filter_mask']['ms']:.4f} ms; main path "
        f"launches {red['main path launches']}")
    red = stats["_redesign"]["batch slab gather"]
    red["main path launches"] = {k: launches.get(k, 0) for k in ("gather_batch", "scatter_rows")}
    log(f"[redesign] batch slab gather: main-path launches {red['main path launches']}")
    red = stats["_redesign"]["score-row gather and row scatter"]
    red["main path launches"] = {k: launches.get(k, 0) for k in ("gather_score_rows", "scatter_rows",
                                                                 "scatter_rows[split]")}
    check(red["main path launches"]["scatter_rows[split]"] == 0,
          f"a main-path scatter call took more than one launch: {red['main path launches']}")
    # the scatter caches only its layout per set of patched tensors: how often the drains found it
    red["scatter layouts"] = {k: launches.get(f"scatter_rows[layout {k}]", 0) for k in ("hits", "misses")}
    log(f"[redesign] score-row gather and row scatter: main-path launches {red['main path launches']} "
        f"(before: gather_score_rows 2,211, scatter_rows 317); scatter layouts {red['scatter layouts']}")
    log(f"[launches] main-path launches summed over every drain: "
        + json.dumps({k: v for k, v in sorted(launches.items())}))
    log(f"[done] {time.perf_counter() - t0:.1f}s; card: {smi}")
    print(json.dumps({"redesign": stats["_redesign"]}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
