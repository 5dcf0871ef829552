#!/usr/bin/env python3
"""Topology, slab and score-row kernels of two checkouts of the port, on one card.

    python3 scripts/topology_ab.py --parent DIR
        [--mode spread|interpod|selector|slab|gather|scatter|fold|ipscore|ports] [--rounds 2]

DIR holds another checkout of the repository (for example the parent commit,
unpacked with `git archive`). Each round measures the parent, then this
checkout, then this checkout again, then the parent (one process each, each
building its own kernels). Modes:

  spread     (default) at the config-3 + Services batch shapes of
             chip_smoke.py (U = 128, N = 10,240, TT = 256, S = 256, V = 16):
             the ScheduleAnyway score as its wrapper launches it, every
             launch prebuilt (a checkout whose spread score reads a match
             matrix launches the match first), and match_terms alone (the
             batch terms against the signatures with the namespace test)
  interpod   the inter-pod filter entry (every part, the match plan's
             matrices given) at the config-4 batch shapes of chip_smoke.py,
             and at the extender's /filter request for a config-4 pod (config
             3's 10,000-node cluster holding bound config 3-hard and config-4
             pods: U = 16 rows, one live); there also filter_mask through
             its wrapper
  selector   the selector-spread entry (the plan's m_sig given) at the
             config-3 + Services batch shapes
  slab       a batch's slab gathers, the pod arrays and the term table, at
             the config-3 shapes (U = TT = 128 lanes, 100 live, slabs of
             256 rows) and the config-5 ones (U = 64 on a 1,024-row slab;
             TT = 16 lanes, none live): a checkout with ops/slab.gather_batch
             launches both in one launch, an older one launches
             gather_stage and gather_terms one after the other; through the
             wrappers too (gather_batch, or gather_stage + gather_terms)
  gather     the score-row gather at the config-3-hard shapes (U = 128,
             N = 10,240) for K = 128, 1, 2 and 4: the kernel into a device
             buffer, the rows on the host through the wrapper, the
             driver's ScoreRows.prefetch, and index_select on the card and
             with .cpu(); a checkout whose kernel takes the rows in its
             argument block also into pinned host memory and the
             alternative (a device buffer, then a non-blocking copy)
  scatter    the row scatter at config 5's restage flush (64 of 1,024 pod
             slab rows) and a mirror sync's six patches at the config-4
             shapes: a checkout with ops/slab.scatter_batch patches a sync
             in one launch, an older one in six scatter_rows calls
  fold       the commit fold at the config-3 and config-5 batches'
             programs (4,096 pods folded onto node rows of the mid-drain
             cluster): the kernel alone (a checkout with
             ops/fold.fold_control launches over its packed live lanes, an
             older one over the padded program) and TensorMirror.fold_commit
             through its wrapper (what a folded batch costs the driver);
             and the node-sharded commit fold on 8 shards, the kernel
             alone over the padded and the packed config-3 program
  ipscore    the inter-pod score entry (both parts, the match plan's
             matrices given) at the config-4 batch shapes, and through its
             wrapper
  ports      the in-batch port table at the config-4 batch shapes: the
             plan's match launch and the table (a checkout whose match
             launch carries the table: one launch; an older one: the plan,
             then the table's own kernel), relaunched and by device
             duration; a tracked batch's match plan and `_inbatch_tensors`
             through their wrappers; and the arbiter's `m_raw` and `pconf`
             (`commit/arbiter._solve_inputs`) at the config-3-hard batch
             shapes, an arbitrated batch the solve did not track

For each: the relaunch mean (CUDA events over 200 calls) and the device
duration from a torch.profiler (CUPTI) trace: the summed durations of the
kernels a call launches, over the calls seen. Prints one JSON line per
process and a summary line (the best of each checkout's runs); writes
chiprun_out/topology_ab[_<mode>].json. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {
    "spread": ("match_terms_kernel", "spread_member_kernel", "spread_pairs_kernel", "spread_merge_kernel",
               "spread_score_kernel", "spread_score_cluster_kernel"),
    # the parent's three launches and this checkout's one
    "interpod": ("pattern_table_kernel", "term_table_kernel", "interpod_mask_kernel",
                 "interpod_filter_cluster_kernel"),
    "selector": ("selector_spread_kernel", "selector_spread_cluster_kernel"),
    # the parent's gather a slab and this checkout's one for both
    "slab": ("gather_slab_kernel", "gather_batch_kernel"),
    "fold": ("fold_commit_kernel",),
    # the parent's sharded kernel, and this checkout's single fold, which
    # the sharded commit launches
    "fold_sharded": ("fold_commit_sharded_kernel", "fold_commit_kernel"),
    # the parent's match launch and port-table kernel, and this checkout's one
    "ports": ("match_terms_kernel", "inbatch_port_conflict_kernel"),
    # the parent's two table kernels and score kernel, and this checkout's one
    "ipscore": ("pattern_table_kernel", "term_table_kernel", "interpod_score_kernel",
                "interpod_score_cluster_kernel"),
}
KERNELS["match"] = ("match_terms_kernel",)


def device_ms(fn, kernels, reps: int = 50, tries: int = 6, per_call: int = 1) -> dict:
    """Per kernel name: the mean device milliseconds a call of fn() spends
    in it, from torch.profiler traces of `reps` calls each (a trace may
    drop events, so successive traces are pooled until they hold half of
    one trace's calls, up to `tries` traces);
    `per_call` is how many launches of its most launched kernel a call
    makes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                name = next((k for k in kernels if k in e.get("name", "")), None)
                if name:
                    n, t = out.get(name, (0, 0.0))
                    out[name] = (n + 1, t + e["dur"] / 1e3)
        if out and max(n for n, _ in out.values()) >= reps * per_call // 2:
            break
    else:
        raise SystemExit(f"the profiler saw too few launches of {kernels} in {tries} traces")
    # the mean over the calls seen
    calls = max(n for n, _ in out.values()) / per_call
    return {k: t / calls for k, (n, t) in out.items()}


def measure_spread(root: str) -> dict:
    """The spread score and the match kernel of the checkout at `root`."""
    import inspect

    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import topology as TO

    dev = torch.device("cuda")
    nodes, existing, pods, fn = CS.config3_batch(True, CS.CONFIG3_PODS // 2)
    enc = CS.encode(nodes, existing, pods, dev, fn)
    na, ea, ta, au, pa, ids, v = (enc[k] for k in ("na", "ea", "ta", "au", "pa", "ids", "v"))
    _, sel = F.combined_mask(na, pa, ids, with_selector=True)
    want = TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=v)
    multi = "problems" in inspect.signature(TO.match_args).parameters
    margs, _ = TO.match_args([(ta, ea["label_vals"], ea["ns_id"])]) if multi else \
        TO.match_args(ta, ea["label_vals"], ea["ns_id"])
    if "m_sig" in inspect.signature(TO.spread_args).parameters:  # the match, then the spread kernels
        soft_args, m_soft = TO.match_args(ta, ea["label_vals"], None)
        sargs, out = TO.spread_args(na, ea, ta, m_soft, sel, v)

        def spread():
            build.launch(TO.MATCH_ENTRY, soft_args, dev)
            build.launch(TO.SPREAD_ENTRY, sargs, dev)
    else:  # one launch, the matches inside it
        sargs, out = TO.spread_args(na, ea, ta, sel, v)

        def spread():
            build.launch(TO.SPREAD_ENTRY, sargs, dev)
    spread()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise SystemExit(f"{root}: the spread score differs from its plain version")

    def match():
        build.launch(TO.MATCH_ENTRY, margs, dev)

    dev_spread, dev_match = device_ms(spread, KERNELS["spread"]), device_ms(match, KERNELS["match"])
    return {
        "spread_ms": CS.cuda_ms(spread, 200), "spread_device_ms": sum(dev_spread.values()),
        "spread_kernels": dev_spread,
        "match_ms": CS.cuda_ms(match, 200), "match_device_ms": sum(dev_match.values()),
    }


def _filter_launch(TO, build, dev, na, ea, ta, au, xa, pa, m_pt, m_sig, parts, v):
    """(the filter entry's launch with a prebuilt struct, its output)."""
    if hasattr(TO, "interpod_filter_args"):  # one cluster launch
        args, out = TO.interpod_filter_args(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, v)
    else:  # the parent: three kernels behind one entry
        args, out = TO.interpod_args("filter", na, ea, ta, xa, pa, m_pt, m_sig, parts, au, v)
    return (lambda: build.launch(TO.INTERPOD_FILTER_ENTRY, args, dev)), out


def measure_interpod(root: str) -> dict:
    """The inter-pod filter of the checkout at `root` at the config-4 batch
    shapes and at a config-4 pod's extender request; filter_mask through
    its wrapper at that request."""
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.extender import ExtenderServer
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.models.clusters import fill_cache
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import topology as TO
    from kubernetes_tpu_torch.state.cache import SchedulerCache

    dev = torch.device("cuda")
    out = {}
    nodes, existing, pods = CS.config4_batch(CS.CONFIG4_PODS // 2)
    enc = CS.encode(nodes, existing, pods, dev)
    na, ea, xa, ta, au, pa, v = (enc[k] for k in ("na", "ea", "xa", "ta", "au", "pa", "v"))
    shapes = {"config4": (na, ea, ta, au, xa, pa, ("existing", "aff", "anti"), v)}
    nodes, existing, pending = CS.extender_cluster()
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    req = ExtenderServer(cache=cache, device="cuda").filter_inputs(pending[1])
    cfg = PP.DEFAULT_SOLVE_CONFIG
    parts = PP._filter_parts(cfg, PP._check_term_kinds(req["term_kinds"]))
    shapes["request"] = tuple(req[k] for k in ("na", "ea", "ta", "au", "xa", "pa")) + (parts, req["n_buckets"])
    for label, (na, ea, ta, au, xa, pa, parts, v) in shapes.items():
        m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
        m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
        fn, got = _filter_launch(TO, build, dev, na, ea, ta, au, xa, pa, m_pt, m_sig, parts, v)
        fn()
        torch.cuda.synchronize()
        if not torch.equal(got, TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, v)):
            raise SystemExit(f"{root}: the inter-pod filter differs from its plain version at {label}")
        kernels = device_ms(fn, KERNELS["interpod"])
        out[f"{label}_ms"] = CS.cuda_ms(fn, 200)
        out[f"{label}_device_ms"] = sum(kernels.values())
        out[f"{label}_kernels"] = kernels
        out[f"{label}_wrapper_ms"] = CS.cuda_ms(lambda: TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts,
                                                                           n_buckets=v, m_pt=m_pt, m_sig=m_sig), 200)
    out["request_parts"] = list(parts)
    out["filter_mask_ms"] = CS.cuda_ms(lambda: PP.filter_mask(**req), 200)
    return out


def measure_selector(root: str) -> dict:
    """The selector spread of the checkout at `root` at the config-3 +
    Services batch shapes."""
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import topology as TO

    dev = torch.device("cuda")
    nodes, existing, pods, fn = CS.config3_batch(True, CS.CONFIG3_PODS // 2)
    enc = CS.encode(nodes, existing, pods, dev, fn)
    na, ea, ta, au, v = (enc[k] for k in ("na", "ea", "ta", "au", "v"))
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    args, got = TO.selector_spread_args(na, ea, ta, au, m_sig, v)

    def sel():
        build.launch(TO.SEL_SPREAD_ENTRY, args, dev)

    sel()
    torch.cuda.synchronize()
    if not torch.equal(got, TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=v)):
        raise SystemExit(f"{root}: the selector spread differs from its plain version")
    kernels = device_ms(sel, KERNELS["selector"])
    return {"selector_ms": CS.cuda_ms(sel, 200), "selector_device_ms": sum(kernels.values()),
            "selector_kernels": kernels,
            "selector_wrapper_ms": CS.cuda_ms(lambda: TO.selector_spread_score(na, ea, ta, au, n_buckets=v,
                                                                               m_sig=m_sig), 200)}


def measure_slab(root: str) -> dict:
    """The slab gathers of the checkout at `root`: a batch's pod arrays and
    term table, relaunched from prebuilt arguments, by device duration and
    through the wrappers, each equal to the plain versions."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.ingest import gather_stage, gather_stage_plain
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.terms_plane import gather_terms, gather_terms_plain

    dev = torch.device("cuda")
    out = {}
    shapes = {"config3": ((256, 128, 100), (256, 128, 100)), "config5": ((1024, 64, 64), (256, 16, 0))}
    for label, sizes in shapes.items():
        planes = []
        for j, (plane, (s, n, live)) in enumerate(zip(("stage", "terms"), sizes)):
            _, bank, emp = CS.seeded_slab(CS.slab_template(plane), s, 5 + j)
            rng = np.random.default_rng(5 + j)
            idx = np.zeros(n, np.int32)
            idx[:live] = rng.integers(0, s, live)
            keep = np.arange(n) < live
            col = rng.integers(0, 2 if plane == "stage" else 512, n).astype(np.int32)
            ti, tk, tc = (torch.from_numpy(a).to(dev) for a in (idx, keep, col))
            want = (gather_stage_plain(bank, ti, tk, emp, tc.bool()) if plane == "stage"
                    else gather_terms_plain(bank, ti, tc, tk, emp))
            planes.append((plane, bank, emp, idx, keep, col, want))
        if hasattr(SL, "gather_batch"):  # one launch for both
            probs = [SL.GatherProblem(bank, emp, idx, keep, col.astype(bool) if plane == "stage" else col,
                                      "fallback" if plane == "stage" else "owner", plane != "stage")
                     for plane, bank, emp, idx, keep, col, _ in planes]
            lanes = [SL.host_lanes(p) for p in probs]
            plan = SL.gather_plan(probs, [len(ln[0]) for ln in lanes])
            host = np.zeros(plan.host_bytes, np.uint8)
            plan.fill(host, lanes)
            buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
            buf[: plan.host_bytes].copy_(torch.from_numpy(host))
            args = SL.GatherBatchArgs.from_buffer_copy(plan.args)
            args.base = buf.data_ptr()

            def launch():
                build.launch(SL.GATHER_ENTRY, args, dev)

            def wrapper():
                return SL.gather_batch(probs)

            def outputs():
                return plan.views(buf)
        else:  # the parent: one launch a slab
            launches, outs, held = [], [], []
            for plane, bank, emp, idx, keep, col, _ in planes:
                lanes_d = torch.from_numpy(np.stack([idx, keep.astype(np.int32), col])).to(dev)
                held.append(lanes_d)  # the argument struct points into it
                o = {k: torch.empty((len(idx),) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
                     for k, v in bank.items()}
                ck = "fallback" if plane == "stage" else "owner"
                launches.append(SL.gather_args(bank, emp, o, lanes_d, ck, plane != "stage"))
                outs.append(o)

            def launch():
                for a in launches:
                    build.launch(SL.GATHER_ENTRY, a, dev)

            def wrapper():
                (_, b1, e1, i1, k1, c1, _), (_, b2, e2, i2, k2, c2, _) = planes
                return [gather_stage(b1, i1, k1, e1, c1.astype(bool)), gather_terms(b2, i2, c2, k2, e2)]

            def outputs():
                return outs
        launch()
        torch.cuda.synchronize()
        for got_all in (outputs(), wrapper()):
            for got, (plane, *_r, want) in zip(got_all, planes):
                if any(not torch.equal(got[k], want[k]) for k in want):
                    raise SystemExit(f"{root}: the {plane} gather differs from its plain version at {label}")
        kernels = device_ms(launch, KERNELS["slab"], per_call=1 if hasattr(SL, "gather_batch") else 2)
        out[f"{label}_ms"] = CS.cuda_ms(launch, 200)
        out[f"{label}_device_ms"] = sum(kernels.values())
        out[f"{label}_kernels"] = kernels
        out[f"{label}_wrapper_ms"] = CS.cuda_ms(wrapper, 200)
    return out


def measure_gather(root: str) -> dict:
    """The score-row gather of the checkout at `root` at the config-3-hard
    shapes (U = 128, N = 10,240) for K = 128 and the driver's K of 1, 2 and
    4: the kernel into a device buffer (relaunched, device duration), the
    rows on the host through the wrapper, the driver's fetch
    (ScoreRows.prefetch), index_select on the card and with .cpu(); this
    checkout's kernel into pinned host memory and the alternative design
    (device buffer, non-blocking copy into pinned memory, event wait) too.
    Every result equal to index_select."""
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.scheduler.driver import ScoreRows

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    score = torch.randint(-(2**62), 2**62, (128, 10240), generator=g, dtype=torch.int64).to(dev)
    redesigned = hasattr(PP, "score_gather_block")
    out = {}
    for rows in (list(range(128))[::-1], [7], [7, 91], [7, 91, 3, 120]):
        k = len(rows)
        idx = torch.tensor(rows, dtype=torch.int32, device=dev)
        want = torch.index_select(score, 0, idx)
        dst = torch.empty((k, 10240), dtype=torch.int64, device=dev)
        args = PP.gather_args(score, rows, dst) if redesigned else PP.gather_args(score, idx, dst)

        def launch(a=args):
            build.launch(PP.GATHER_ENTRY, a, dev)

        def wrapper(rows=rows):
            got = PP.gather_score_rows(score, rows)
            return got if redesigned else got.cpu()

        launch()
        torch.cuda.synchronize()
        if not (torch.equal(dst, want) and torch.equal(wrapper(), want.cpu())):
            raise SystemExit(f"{root}: the score-row gather differs from index_select at K = {k}")
        label = f"K{k}"
        out[f"{label}_ms"] = CS.cuda_ms(launch, 200)
        out[f"{label}_device_ms"] = sum(device_ms(launch, ("gather_rows_kernel",)).values())
        out[f"{label}_wrapper_ms"] = CS.cuda_ms(wrapper, 200)
        out[f"{label}_prefetch_ms"] = CS.cuda_ms(lambda rows=rows: ScoreRows(score, rows).prefetch(range(len(rows))),
                                                 200)
        out[f"{label}_index_select_ms"] = CS.cuda_ms(lambda idx=idx: torch.index_select(score, 0, idx), 200)
        out[f"{label}_index_select_device_ms"] = sum(
            device_ms(lambda idx=idx: torch.index_select(score, 0, idx), ("index", "gather", "Index")).values())
        out[f"{label}_index_select_cpu_ms"] = CS.cuda_ms(lambda idx=idx: torch.index_select(score, 0, idx).cpu(), 200)
        if redesigned:
            host = torch.empty((k, 10240), dtype=torch.int64, pin_memory=True)
            hargs = PP.gather_args(score, rows, host)

            def alternative(rows=rows, k=k):
                o = torch.empty((k, 10240), dtype=torch.int64, device=dev)
                build.launch(PP.GATHER_ENTRY, PP.gather_args(score, rows, o), dev)
                pinned = torch.empty((k, 10240), dtype=torch.int64, pin_memory=True)
                pinned.copy_(o, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
                return pinned

            if not torch.equal(alternative(), want.cpu()):
                raise SystemExit(f"{root}: the alternative gather differs at K = {k}")
            out[f"{label}_host_ms"] = CS.cuda_ms(lambda a=hargs: build.launch(PP.GATHER_ENTRY, a, dev), 200)
            out[f"{label}_host_device_ms"] = sum(device_ms(lambda a=hargs: build.launch(PP.GATHER_ENTRY, a, dev),
                                                           ("gather_rows_kernel",)).values())
            out[f"{label}_alternative_ms"] = CS.cuda_ms(alternative, 200)
    return out


def _patches(mirror, seed=2):
    """A mirror sync's six patches, as (resident dict clone, rows, host
    truth, keys): node rows, usage rows, the signature and pattern banks'
    counts and metadata (chip_smoke.py's sizes: 32, 128, 8 and 4 rows)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dn, de, dp = ({k: v.clone() for k, v in d.items()} for d in mirror.device_arrays())
    hn, he, hp = ({k: np.roll(v, 1, axis=0) if k != "counts" else v + 1 for k, v in d.items()}
                  for d in (mirror.nodes.arrays(), mirror.eps.arrays(), mirror.pats.arrays()))
    n = next(iter(dn.values())).shape[0]
    perm = rng.permutation(n)
    # Python ints, as the mirror's sorted sets of dirty rows
    node_rows, usage_rows = sorted(perm[:32].tolist()), sorted(perm[32:160].tolist())
    count_rows = sorted(perm[:160].tolist())
    sig_rows = sorted(rng.choice(de["valid"].shape[0], 8, replace=False).tolist())
    pat_rows = sorted(rng.choice(dp["valid"].shape[0], 4, replace=False).tolist())
    return [(dn, node_rows, hn, tuple(k for k in hn if k != "image_scaled")),
            (dn, usage_rows, hn, ("requested", "nonzero_req", "pod_count")),
            (de, count_rows, he, ("counts",)), (de, sig_rows, he, tuple(k for k in he if k != "counts")),
            (dp, node_rows, hp, ("counts",)), (dp, pat_rows, hp, tuple(k for k in hp if k != "counts"))]


def measure_scatter(root: str) -> dict:
    """The row scatter of the checkout at `root`: config 5's restage flush
    (64 of 1,024 rows of the pod slab) relaunched from prebuilt arguments,
    by device duration and as the plane's flush calls it (the parent: the
    caller's staged copy, then scatter_rows; this checkout: scatter_rows
    taking host truth); and a mirror sync's six patches at the config-4
    shapes (the parent: six scatter_rows calls as its mirror made them;
    this checkout: one scatter_batch call, also with its layout rebuilt
    each call). Every result equal to index_copy_."""
    import numpy as np
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.state.convert import arrays_to_torch

    dev = torch.device("cuda")
    redesigned = hasattr(SL, "scatter_batch")
    out = {}
    host, bank, _ = CS.seeded_slab(CS.slab_template("stage"), 1024, 7)
    idx = np.arange(0, 1024, 16)
    truth = {k: np.roll(v, 5, axis=0) for k, v in host.items()}
    want = arrays_to_torch(host, dev, copy=True)
    ti = torch.from_numpy(idx).to(dev)
    for k, v in want.items():
        v.index_copy_(0, ti, torch.from_numpy(np.ascontiguousarray(truth[k][idx])).to(dev))
    if redesigned:
        prob = SL.ScatterProblem(bank, idx, truth)
        lanes = [SL.scatter_lanes(prob)]
        plan = SL.ScatterPlan([prob], [idx.size], [lanes[0][1]])
        staging = np.zeros(plan.nbytes, np.uint8)
        plan.fill(staging, [prob], lanes)
        buf = torch.from_numpy(staging).to(dev)
        args = SL.ScatterArgs.from_buffer_copy(plan.args[0])
        args.base = buf.data_ptr()

        def flush():
            SL.scatter_rows(bank, idx, truth)
    else:
        packed_np, offs = SL.pack_rows(bank, {k: np.ascontiguousarray(truth[k][idx]) for k in bank})
        packed = torch.from_numpy(packed_np).to(dev)
        i32 = ti.int()
        args = SL.scatter_args(bank, packed, offs, i32, idx.size)

        def flush():
            SL.scatter_rows(bank, idx, {k: np.ascontiguousarray(h[idx]) for k, h in truth.items()})

    def launch():
        build.launch(SL.SCATTER_ENTRY, args, dev)

    for fn in (launch, flush):
        fn()
        torch.cuda.synchronize()
        if any(not torch.equal(bank[k], want[k]) for k in want):
            raise SystemExit(f"{root}: the row scatter differs from index_copy_ at config 5's flush")
    out["flush_ms"] = CS.cuda_ms(launch, 200)
    out["flush_device_ms"] = sum(device_ms(launch, ("scatter_slab_kernel",)).values())
    out["flush_wrapper_ms"] = CS.cuda_ms(flush, 50)
    if redesigned:  # the layout rebuilt each call: what a flush costs when the cache misses
        out["flush_cold_wrapper_ms"] = CS.cuda_ms(lambda: (SL._SCATTER_LAYOUTS.clear(), flush()), 50)
    nodes, existing, pods = CS.config4_batch(CS.CONFIG4_PODS // 2)
    enc = CS.encode(nodes, existing, pods, dev)
    patches = _patches(enc["mirror"])
    wants = {}
    for d, rows, h, keys in patches:
        w = wants.setdefault(id(d), {k: v.clone() for k, v in d.items()})
        tr = torch.tensor(np.asarray(rows, np.int64), device=dev)
        for k in keys:
            w[k].index_copy_(0, tr, torch.from_numpy(np.ascontiguousarray(h[k][np.asarray(rows)])).to(dev))
    if redesigned:
        problems = [SL.ScatterProblem(d, rows, h, keys) for d, rows, h, keys in patches]

        def sync():
            SL.scatter_batch(problems)
    else:
        def sync():  # the parent mirror's _patch_rows, six times
            for d, rows, h, keys in patches:
                i = np.asarray(rows, np.int64)
                SL.scatter_rows({k: d[k] for k in keys}, i, {k: np.ascontiguousarray(h[k][i]) for k in keys})
    sync()
    torch.cuda.synchronize()
    for d, _, _, _ in patches:
        if any(not torch.equal(d[k], v) for k, v in wants[id(d)].items()):
            raise SystemExit(f"{root}: the mirror sync's scatter differs from index_copy_")
    out["mirror_sync_wrapper_ms"] = CS.cuda_ms(sync, 50)
    if redesigned:
        out["mirror_sync_cold_wrapper_ms"] = CS.cuda_ms(lambda: (SL._SCATTER_LAYOUTS.clear(), sync()), 50)
    out["mirror_sync_device_ms"] = sum(device_ms(sync, ("scatter_slab_kernel",),
                                                 per_call=1 if redesigned else 6).values())
    return out


def measure_fold(root: str) -> dict:
    """The commit fold of the checkout at `root` on two batch programs: the
    config-3 batch (4,096 pods of the mid-drain cluster, 10,000 nodes) and the config-5 one (4,096 gang pods on 2,000 nodes), each pod
    folded onto node row 7 * i mod the cluster's nodes. The kernel alone
    (relaunched and by device duration) and TensorMirror.fold_commit
    through its wrapper; every result equal to the plain version, the
    mirror's banks restored after the timing."""
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.commit.fold import plan_fold
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.models.clusters import bench_config5
    from kubernetes_tpu_torch.ops import fold as FO
    from kubernetes_tpu_torch.state.convert import arrays_to_torch

    dev = torch.device("cuda")
    packed_path = hasattr(FO, "fold_control")
    nodes, existing, pods, _ = CS.config3_batch(False, CS.CONFIG3_PODS // 2)
    c5_nodes, c5_pods = bench_config5(CS.CONFIG5_NODES, CS.BATCH // 64)
    out = {}
    for label, (ns, ex, ps) in (("config3", (nodes, existing, pods)), ("config5", (c5_nodes, [], c5_pods))):
        enc = CS.encode(ns, ex, ps, dev)
        mirror, na = enc["mirror"], enc["na"]
        rows = sorted(mirror.row_of.values())
        prog = plan_fold(mirror, [(p, rows[(7 * i) % len(rows)]) for i, p in enumerate(ps[:CS.BATCH])], CS.BATCH, 16)
        if prog is None:
            raise SystemExit(f"{root}: the {label} fold plan overflowed a bank")
        n, e, x = mirror.device_arrays()  # the plan's new rows shipped
        resident = [n["requested"], n["nonzero_req"], n["pod_count"], e["counts"], x["counts"]]
        ctl = arrays_to_torch({k: getattr(prog, k) for k in ("rows", "req", "nz", "cnt", "sig", "pat_row", "pat_col",
                                                             "pat_cnt")}, dev)
        kb = [t.clone() for t in resident]
        want = FO.fold_commit_banks_plain(*(t.clone() for t in resident), **ctl)
        if packed_path:
            packed = FO.fold_control(**{k: getattr(prog, k) for k in ctl}, n=na["valid"].shape[0], pin=True)
            dbuf = packed.buf.to(dev)
            args = FO.packed_args(kb, packed, dbuf.data_ptr())
        else:
            args = FO.fold_args(*kb, **ctl)

        def launch():
            build.launch(FO.FOLD_ENTRY, args, dev)

        launch()
        torch.cuda.synchronize()
        if any(not torch.equal(a, w) for a, w in zip(kb, want)):
            raise SystemExit(f"{root}: the fold kernel differs from its plain version at {label}")
        saved = [t.clone() for t in resident]
        if not mirror.fold_commit(prog):
            raise SystemExit(f"{root}: the mirror's banks are not resident at {label}")
        torch.cuda.synchronize()
        if any(not torch.equal(a, w) for a, w in zip(resident, want)):
            raise SystemExit(f"{root}: the mirror's fold differs from the plain version at {label}")
        out[f"{label}_ms"] = CS.cuda_ms(launch, 200)
        out[f"{label}_device_ms"] = sum(device_ms(launch, KERNELS["fold"]).values())
        out[f"{label}_mirror_ms"] = CS.cuda_ms(lambda: mirror.fold_commit(prog), 200)
        for t, v in zip(resident, saved):
            t.copy_(v)
        out[f"{label}_lanes"] = [prog.pods, int(prog.rows.shape[0]), int((prog.pat_cnt != 0).sum()), prog.pat_bucket]
        if label == "config3":
            out.update(_sharded_fold(root, resident, ctl, prog, na["valid"].shape[0], packed_path))
    return out


def _sharded_fold(root, resident, ctl, prog, n, packed_path, shards=8):
    """The node-sharded commit fold on `shards` shards, the kernel alone
    over the padded program and (a checkout with the packed path) its
    packed live lanes: relaunched and by device duration, each equal to
    the plain version."""
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import fold as FO

    dev = torch.device("cuda")
    want = FO.fold_commit_sharded_plain(shards, *(t.clone() for t in resident), **ctl)
    out = {}
    kinds = [("padded", None)]
    if packed_path:
        packed = FO.fold_control(**{k: getattr(prog, k) for k in ctl}, n=n, pin=True)
        kinds.append(("packed", packed))
    for kind, pk in kinds:
        kb = [t.clone() for t in resident]
        if pk is None:
            inner = FO.fold_args(*kb, **ctl)
        else:
            dbuf = pk.buf.to(dev)
            inner = FO.packed_args(kb, pk, dbuf.data_ptr())
        if hasattr(FO, "ShardedFoldArgs"):  # a checkout with a sharded commit kernel of its own
            entry, args = FO.FOLD_SHARDED_ENTRY, FO.ShardedFoldArgs(inner, shards, n // shards)
        else:
            entry, args = FO.FOLD_ENTRY, inner

        def launch():
            build.launch(entry, args, dev)

        launch()
        torch.cuda.synchronize()
        if any(not torch.equal(a, w) for a, w in zip(kb, want)):
            raise SystemExit(f"{root}: the sharded fold differs from its plain version ({kind})")
        out[f"sharded_{kind}_ms"] = CS.cuda_ms(launch, 200)
        out[f"sharded_{kind}_device_ms"] = sum(device_ms(launch, KERNELS["fold_sharded"]).values())
    return out


def measure_ipscore(root: str) -> dict:
    """The inter-pod score of the checkout at `root` at the config-4 batch
    shapes (both parts, the plan's m_pt / m_sig given): its entry relaunched
    from a prebuilt struct, by device duration (every kernel a call
    launches), and through its wrapper."""
    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import topology as TO

    dev = torch.device("cuda")
    nodes, existing, pods = CS.config4_batch(CS.CONFIG4_PODS // 2)
    enc = CS.encode(nodes, existing, pods, dev)
    na, ea, xa, ta, pa, v = (enc[k] for k in ("na", "ea", "xa", "ta", "pa", "v"))
    parts = ("pref", "existing")
    m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    args, got = TO.interpod_score_args(na, ea, ta, xa, pa, m_pt, m_sig, parts, v)

    def score():
        build.launch(TO.INTERPOD_SCORE_ENTRY, args, dev)

    score()
    torch.cuda.synchronize()
    if not torch.equal(got, TO.interpod_score_plain(na, ea, ta, xa, pa, parts, v)):
        raise SystemExit(f"{root}: the inter-pod score differs from its plain version")
    kernels = device_ms(score, KERNELS["ipscore"])
    return {"score_ms": CS.cuda_ms(score, 200), "score_device_ms": sum(kernels.values()), "score_kernels": kernels,
            "score_wrapper_ms": CS.cuda_ms(lambda: TO.interpod_score(na, ea, ta, xa, pa, parts=parts, n_buckets=v,
                                                                     m_pt=m_pt, m_sig=m_sig), 200)}


def measure_ports(root: str) -> dict:
    """The in-batch port table of the checkout at `root`: at the config-4
    batch shapes the plan's three matrices and the table (one launch where
    the match launch carries it, else the plan's launch and the table's
    own kernel), relaunched from prebuilt structs and by device duration;
    a tracked batch's match plan and `_inbatch_tensors` through their
    wrappers; at the config-3-hard batch shapes the arbiter's `m_raw` and
    `pconf` through `commit/arbiter._solve_inputs`. Every output equal to
    its plain version."""
    import inspect

    import torch

    import chip_smoke as CS
    from kubernetes_tpu_torch.commit import arbiter as A
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import pipeline as PP
    from kubernetes_tpu_torch.ops import topology as TO

    dev = torch.device("cuda")
    fused = "ports" in inspect.signature(TO.match_args).parameters
    nodes, existing, pods = CS.config4_batch(CS.CONFIG4_PODS // 2)
    enc = CS.encode(nodes, existing, pods, dev)
    na, ea, xa, ta, pa, ids, v = (enc[k] for k in ("na", "ea", "xa", "ta", "pa", "ids", "v"))
    plan = [(ta, ea["label_vals"], ea["ns_id"]), (xa, pa["label_vals"], pa["ns_id"]),
            (ta, pa["label_vals"], pa["ns_id"])]
    want = F.inbatch_port_conflict_plain(pa, ids)
    if fused:
        margs, outs = TO.match_args(plan, (pa, ids))
        launches = [margs]
        table = outs[-1]
    else:
        margs, outs = TO.match_args(plan)
        pargs, table = F.port_conflict_args(pa, ids)
        launches = [margs, pargs]
    entries = [TO.MATCH_ENTRY] + ([] if fused else [F.PORT_CONFLICT_ENTRY])

    def plan_and_table():
        for e, a in zip(entries, launches):
            build.launch(e, a, dev)

    plan_and_table()
    torch.cuda.synchronize()
    if not torch.equal(table, want) or any(not torch.equal(o, TO.match_terms_plain(*p)) for o, p in zip(outs, plan)):
        raise SystemExit(f"{root}: the plan or the port table differs from its plain version")
    kernels = device_ms(plan_and_table, KERNELS["ports"], per_call=1)
    kinds = frozenset({"anti_req", "pref", "et_anti", "et_score"})
    extra = {"ids": ids} if "ids" in inspect.signature(PP.match_plan).parameters else {}

    def tracked():
        got = PP.match_plan(pa, PP.DEFAULT_SOLVE_CONFIG, kinds, ea=ea, ta=ta, xa=xa, track_inbatch=True, **extra)
        return PP._inbatch_tensors(na, pa, ta, ids, v, got["m_bb"], *([got["port_conflict"]] if extra else []))

    if not torch.equal(tracked()["port_conflict"], want):
        raise SystemExit(f"{root}: the tracked batch's port table differs from its plain version")
    out = {"fused": fused, "plan_and_table_ms": CS.cuda_ms(plan_and_table, 200),
           "plan_and_table_device_ms": sum(kernels.values()), "plan_and_table_kernels": kernels,
           "tracked_wrapper_ms": CS.cuda_ms(tracked, 200)}
    nodes, existing, pods, _ = CS.config3_batch(False, CS.CONFIG3_PODS // 2, hard=True)
    h = CS.encode(nodes, existing, pods, dev)
    args = (h["na"], h["pa"], h["ea"], h["ta"], h["ids"], {}, False, h["v"])
    got = A._solve_inputs(*args, plain=False)
    if not (torch.equal(got["pconf"], F.inbatch_port_conflict_plain(h["pa"], h["ids"]))
            and torch.equal(got["m_raw"], TO.match_terms_plain(h["ta"], h["pa"]["label_vals"], h["pa"]["ns_id"]))):
        raise SystemExit(f"{root}: the arbiter's m_raw or pconf differs from its plain version")
    out["arbiter_inputs_ms"] = CS.cuda_ms(lambda: A._solve_inputs(*args, plain=False), 200)
    return out


MEASURES = {"spread": measure_spread, "interpod": measure_interpod, "selector": measure_selector,
            "slab": measure_slab, "gather": measure_gather, "scatter": measure_scatter, "fold": measure_fold,
            "ipscore": measure_ipscore, "ports": measure_ports}


def measure(root: str, mode: str) -> dict:
    """The measurements of the checkout at `root` (run in its own process)."""
    import torch

    sys.path.insert(0, root)
    from kubernetes_tpu_torch.kernels import build

    build.library()
    return {"root": root, "card": torch.cuda.get_device_name(0), **MEASURES[mode](root)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--mode", choices=sorted(MEASURES), default="spread")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.mode)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("topology_ab: no CUDA device", file=sys.stderr)
        return 1
    parent = os.path.abspath(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    runs = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for label, root in (("parent", parent), ("change", HERE), ("change", HERE), ("parent", parent)):
            got = subprocess.run([sys.executable, os.path.abspath(__file__), "--mode", args.mode, "--measure", root],
                                 cwd=root, stdout=subprocess.PIPE, text=True, check=True).stdout.strip().splitlines()[-1]
            print(f"[ab] {args.mode} {label}: {got}", flush=True)
            runs[label].append(json.loads(got))
    summary = {"card": smi, "mode": args.mode}
    for label, rs in runs.items():
        summary[label] = {k: min(r[k] for r in rs) for k, x in rs[0].items()
                          if k.endswith("_ms") and isinstance(x, float)}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    name = "topology_ab.json" if args.mode == "spread" else f"topology_ab_{args.mode}.json"
    with open(os.path.join(HERE, "chiprun_out", name), "w") as f:
        json.dump({"summary": summary, "runs": runs}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
