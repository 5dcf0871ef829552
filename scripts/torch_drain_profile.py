#!/usr/bin/env python3
"""Where the port's drain spends its time, on one NVIDIA card.

    python3 scripts/torch_drain_profile.py [--config 2|3|3-hard|4|5|6] [--services]
        [--policy default|rtcr] [--nodes N] [--pods P] [--batch 4096]
        [--runs plain,sampled,traced] [--out chiprun_out/drain_profile]
        [--ab PAIRS] [--ab-of commit|stage] [--mesh S]

Drives a drain of chip_smoke.py phase 5 (kubernetes_tpu_torch's Scheduler,
tie-noise on, every plane on — the pods admitted to the running scheduler,
so the queue stages them into the ingest and term slabs) on bench.py config 2 (default 5,000 nodes / 50,000 pods),
config 3 (default 10,000 nodes / 100,000 pods; with --services, one
Service per app feeds SelectorSpread), config 3-hard (config 3 with every
constraint DoNotSchedule: the commit arbiter's defers, and the host
oracle's re-placement of the pods deferred three times in a row; its
warm-up drain is 1/100 of the pods), config 4 (default 2,000 nodes /
20,000 pods: required hostname anti-affinity on every 10th pod, preferred
zone affinity on the rest), config 5 (default 2,000 nodes / 64,000 pods in
gang groups of 64: every batch solved all-or-nothing, every pod through
the per-pod commit loop) or config 6 (default 500 full nodes with 7
bound priority-0 pods each, --pods 2,000 pending priority-1000 pods that
land only by preemption, batch 1,024 by default so that batches
dispatch with another batch's nominations outstanding; the drain waits
out the queue's backoff in 50 ms sleeps, as bench.py's does, counted as
`wait_s`; pods/s counts the preemptors) after a 1/10-scale warm-up drain
that builds and loads the kernels, three times (or the runs named by
`--runs`):

  1. plain      wall time and the driver's per-stage seconds, the
                reference for the overheads of the two runs below;
  2. sampled    the host split: a thread samples the driver thread's stack
                about every millisecond and gives each sample the time
                since the one before (a thread holding the GIL delays the
                sampler, so unweighted samples would over-count waits
                outside the GIL); a stage's share is the share of that
                time with its function on the stack, and the leaf
                functions with the most time are listed (the bind pool's
                threads are not sampled). cProfile is not used: on Python
                3.12 it folds every thread's calls into one stack;
  3. traced     torch.profiler with CPU and CUDA activities: from its
                Chrome trace, the device's busy time inside the drain's
                window (the union of kernel, memcpy and memset intervals),
                the idle share, and the busy time and count per name.

With `--policy rtcr` (config 2 only) the Scheduler is built by
`config.Configurator(...).create_from_config` from chip_smoke.py's
RequestedToCapacityRatio bin-packing Policy (GeneralPredicates,
PodToleratesNodeTaints, CheckNodeUnschedulable, MatchInterPodAffinity;
RTCR at weight 2 with the shape (0, 0)-(100, 10), NodeAffinityPriority and
TaintTolerationPriority at 1) instead of the default provider.

With `--ab PAIRS` it runs, after the warm-up, PAIRS pairs of plain drains
with the commit plane (the arbiter and the fold) on and off (the
Scheduler's default and `commit_plane=False`; with `--ab-of stage`, the
ingest and term planes on and off instead), alternating which runs first,
and reports each run's pods/s and stages, the medians and each side's
lowest and highest pods/s, instead of the three runs above. Every run
prints the planes' counters (gathered and legacy batches, restages, dirty
flushes) beside the stage seconds.

With `--mesh S` every drain runs on a node mesh of S shards of the card
(`Scheduler(mesh=parallel.node_mesh(S))`: the solve and arbiter of
csrc/solver.cu and csrc/arbiter.cu as clusters of S CTAs, and the sharded
folds of csrc/fold.cu), and the traced run is made
twice, on one device and on the mesh, so the two device splits (idle
share, busy time per kernel) stand side by side.

Prints one JSON object as the last line of its output and writes the full
summary to --out/summary.json (--out/ab.json with --ab). Exits non-zero
when the trace holds no device event.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter, defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SAMPLER_SWITCH_INTERVAL_S = 2e-4
# the driver's stages and the functions under them, as (file suffix, name)
STAGES = (
    ("scheduler/driver.py", "schedule_batch"),
    ("state/queue.py", "pop_batch"),
    ("state/cache.py", "sync"),
    ("state/tensors.py", "apply_adds_bulk"),
    ("state/tensors.py", "apply_pod_deltas_bulk"),
    ("state/tensors.py", "apply_delta"),
    ("state/terms.py", "apply_delta"),
    ("scheduler/driver.py", "_encode"),
    ("scheduler/driver.py", "_stage_prologue"),
    ("scheduler/driver.py", "_term_prologue"),
    ("ingest/bank.py", "_flush_locked"),
    ("ops/slab.py", "scatter_batch"),
    ("ops/slab.py", "gather_batch"),
    ("state/tensors.py", "dedup_specs"),
    ("state/tensors.py", "set_pod"),
    ("state/terms.py", "compile_batch_terms"),
    ("state/convert.py", "arrays_to_torch"),
    ("state/cache.py", "device_arrays"),
    ("ops/pipeline.py", "solve_pipeline"),
    ("commit/arbiter.py", "arbitrate"),
    ("scheduler/driver.py", "_commit_bulk"),
    ("scheduler/driver.py", "_commit_arbitrated"),
    ("scheduler/driver.py", "_commit_loop"),
    ("state/queue.py", "pop_all_in_groups"),
    ("ops/pipeline.py", "solve_pipeline_gang"),
    ("scheduler/driver.py", "_prepare_commit"),
    ("scheduler/driver.py", "_oracle_place"),
    ("scheduler/driver.py", "_pod_meta"),
    ("oracle/predicates.py", "compute_even_pods_spread_metadata"),
    ("oracle/predicates.py", "pod_fits_on_node"),
    ("scheduler/preemption.py", "fits_considering_nominated"),
    ("ops/pipeline.py", "gather_score_rows"),
    ("scheduler/driver.py", "_apply"),
    ("scheduler/driver.py", "_dispatch_fold"),
    ("commit/fold.py", "plan_fold"),
    ("api/types.py", "with_node"),
    ("state/cache.py", "assume_pods"),
    ("state/queue.py", "add_unschedulable"),
    ("scheduler/driver.py", "wait_for_binds"),
    ("scheduler/driver.py", "_nominee_overlay"),
    ("scheduler/driver.py", "_preempt_deferred"),
    ("scheduler/preemption.py", "preempt_arrays"),
    ("ops/preempt.py", "preempt_batch"),
    ("scheduler/driver.py", "_reverify"),
    ("scheduler/driver.py", "_try_preempt"),
    ("scheduler/driver.py", "_apply_preemption"),
    ("state/queue.py", "move_all_to_active"),
    ("scripts/torch_drain_profile.py", "wait_backoff"),
)


def wait_backoff(queue) -> None:
    """The idle round of a preemption drain: sleep 50 ms, then move the
    unschedulable pods back (bench.py's drain loop)."""
    time.sleep(0.05)
    queue.move_all_to_active()


PLANE_COUNTERS = ("ingest_index_batches", "ingest_legacy_batches", "ingest_stale_rows", "ingest_restaged",
                  "stage_sync_flushes", "term_index_batches", "term_legacy_batches", "term_stale_rows",
                  "term_restaged", "term_sync_flushes")


def plane_line(label: str, r: dict) -> str:
    """The stage seconds with the ingest and term planes' counters."""
    stages = ", ".join(f"{k} {r[k]:.4f}" for k in ("sync_s", "encode_s", "stage_s", "term_gather_s", "solve_s",
                                                    "commit_s"))
    return f"[profile] {label} stages: {stages}; planes: " + ", ".join(f"{k} {r[k]}" for k in PLANE_COUNTERS)


# chip_smoke.py's RTCR bin-packing Policy (--policy rtcr)
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


def drain(config: str, services: bool, policy: str, n_nodes: int, n_pods: int, batch: int,
          around=contextlib.nullcontext, planes: bool = True, stage_planes: bool = True, mesh: int = 0):
    from kubernetes_tpu_torch.models.clusters import (
        bench_config2,
        bench_config3,
        bench_config4,
        bench_config5,
        bench_config6,
        fill_cache,
    )
    from kubernetes_tpu_torch.parallel import node_mesh
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    fn = None
    existing = []
    if config == "2":
        nodes, pods = bench_config2(n_nodes, n_pods)
    elif config == "4":
        nodes, pods = bench_config4(n_nodes, n_pods)
    elif config == "5":
        nodes, pods = bench_config5(n_nodes, n_pods // 64)
    elif config == "6":
        nodes, existing, pods = bench_config6(n_nodes, n_pods)
    else:
        nodes, pods, fn = bench_config3(n_nodes, n_pods, services=services, hard=config == "3-hard")
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes, existing)
    kw = dict(batch_size=batch, deterministic=False, seed=0, device="cuda", commit_plane=planes,
              ingest_plane=stage_planes, term_plane=stage_planes, mesh=node_mesh(mesh) if mesh else None)
    if policy == "rtcr":
        from kubernetes_tpu_torch.config import Configurator

        sched = Configurator(cache=cache, queue=queue, **kw).create_from_config(RTCR_POLICY)
    else:
        sched = Scheduler(cache, queue, **kw)
    if fn is not None:
        sched.set_spread_selectors_fn(fn)
    for p in pods:  # admitted to the running scheduler: staged as added, before the timed window
        queue.add(p)
    if config == "6":
        return drain_preemption(sched, queue, n_pods, around)
    torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        res = sched.run_until_empty(max_cycles=100000)
        sched.wait_for_binds()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.close()
    if res.scheduled != len(pods):
        raise SystemExit(f"drain placed {res.scheduled} of {len(pods)} pods")
    return {"wall_s": wall, "pods_per_s": len(pods) / wall, "mirror_rebuilds": sched.mirror.rebuild_count,
            **sched.stats}


def drain_preemption(sched, queue, n_pods: int, around):
    """Config 6's drain: batches until the queue is empty, waiting out the
    backoff between preemption rounds (`wait_backoff`)."""
    placed = 0
    wait_s = batch_s = 0.0
    torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        idle = 0
        while True:
            tb = time.perf_counter()
            r = sched.schedule_batch()
            sched.wait_for_binds()
            batch_s += time.perf_counter() - tb
            placed += r.scheduled
            if r.scheduled or r.unschedulable or r.deferred:
                idle = 0
                continue
            if sum(queue.counts()) == 0 or idle >= 400:
                break
            idle += 1
            tw = time.perf_counter()
            wait_backoff(queue)
            wait_s += time.perf_counter() - tw
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.close()
    if placed != n_pods:
        raise SystemExit(f"drain placed {placed} of {n_pods} pods")
    return {"wall_s": wall, "pods_per_s": n_pods / wall, "wait_s": wait_s, "batch_s": batch_s, **sched.stats}


class StackSampler:
    """Samples one thread's Python stack about every `period` seconds and
    weights each sample by the seconds since the previous one."""

    def __init__(self, thread_id: int, period: float = 1e-3):
        self.thread_id = thread_id
        self.period = period
        self.samples = 0
        self.seconds = 0.0
        self.stages: Counter = Counter()
        self.leaves: Counter = Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="stack-sampler", daemon=True)

    def _run(self) -> None:
        last = time.perf_counter()
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self.thread_id)
            now = time.perf_counter()
            weight, last = now - last, now
            if frame is None:
                continue
            self.samples += 1
            self.seconds += weight
            code = frame.f_code
            self.leaves[f"{code.co_filename.replace(REPO + os.sep, '')}:{code.co_name}"] += weight
            seen = set()
            while frame is not None:
                code = frame.f_code
                for suffix, name in STAGES:
                    if code.co_name == name and code.co_filename.endswith(suffix):
                        seen.add(f"{suffix}:{name}")
                frame = frame.f_back
            for k in seen:
                self.stages[k] += weight

    def __enter__(self):
        # a shorter GIL switch interval lets the sampler in sooner while
        # the sampled thread runs Python
        self._interval = sys.getswitchinterval()
        sys.setswitchinterval(SAMPLER_SWITCH_INTERVAL_S)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        sys.setswitchinterval(self._interval)

    def report(self, top: int = 20) -> dict:
        total = self.seconds or 1.0
        return {
            "samples": self.samples, "sampled_s": self.seconds,
            "stage_share": {k: v / total for k, v in self.stages.most_common()},
            "top_leaves": {k: v / total for k, v in self.leaves.most_common(top)},
        }


def device_split(trace_path: str, window: str = "drain") -> dict:
    """Device busy time inside the named CPU range of a Chrome trace: the
    union of device intervals, and per-name totals."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise SystemExit(f"no '{window}' range in the trace")
    w0 = spans[0]["ts"]
    w1 = w0 + spans[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    per = defaultdict(lambda: {"count": 0, "busy_ms": 0.0})
    for e in dev:
        per[e["name"]]["count"] += 1
        per[e["name"]]["busy_ms"] += e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e["ts"]):
        t = min(e["ts"] + e["dur"], w1)
        if t > end:
            busy += t - max(e["ts"], end)
            end = t
    window_ms = (w1 - w0) / 1e3
    return {
        "window_ms": window_ms, "busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / window_ms,
        "device_events": len(dev),
        "per_name": dict(sorted(per.items(), key=lambda kv: -kv[1]["busy_ms"])),
    }


def ab(work, args, smi) -> int:
    """PAIRS pairs of plain drains, planes on and off, alternating which
    runs first; each run's pods/s and stages, the medians and each side's
    pods/s range."""
    keys = ("pods_per_s", "wall_s", "sync_s", "encode_s", "stage_s", "term_gather_s", "solve_s", "commit_s",
            "apply_s", "fold_s")
    if args.config == "6":
        keys += ("wait_s", "batch_s", "preempt_s")
    runs = {"on": [], "off": []}
    for i in range(args.ab):
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            on = side == "on"
            r = drain(*work, args.nodes, args.pods, args.batch, planes=on or args.ab_of != "commit",
                      stage_planes=on or args.ab_of != "stage")
            runs[side].append({k: r[k] for k in keys})
            print(f"[ab] pair {i} {args.ab_of} planes {side}: " + ", ".join(f"{k} {r[k]:.4f}" for k in keys),
                  flush=True)
            print(plane_line(f"ab pair {i} {side}", r), flush=True)
    med = {side: {k: statistics.median(r[k] for r in rs) for k in keys} for side, rs in runs.items()}
    span = {side: [min(r["pods_per_s"] for r in rs), max(r["pods_per_s"] for r in rs)] for side, rs in runs.items()}
    for side in ("on", "off"):
        print(f"[ab] median planes {side}: " + ", ".join(f"{k} {v:.4f}" for k, v in med[side].items())
              + f"; pods_per_s range {span[side][0]:.4f}-{span[side][1]:.4f}", flush=True)
    with open(os.path.join(args.out, "ab.json"), "w") as f:
        json.dump({"card": smi, "config": args.config, "services": args.services, "ab_of": args.ab_of,
                   "runs": runs, "median": med,
                   "pods_per_s_range": span}, f, indent=1)
    print(json.dumps({"config": args.config, "services": args.services, "ab_of": args.ab_of,
                      "median_pods_per_s": {s_: med[s_]["pods_per_s"] for s_ in med},
                      "pods_per_s_range": span}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=("2", "3", "3-hard", "4", "5", "6"), default="2")
    ap.add_argument("--services", action="store_true", help="config 3: one Service per app")
    ap.add_argument("--policy", choices=("default", "rtcr"), default="default",
                    help="rtcr: config 2 under chip_smoke.py's RTCR bin-packing Policy")
    ap.add_argument("--nodes", type=int, default=None,
                    help="default 5,000 (config 2) / 10,000 (config 3) / 2,000 (configs 4, 5) / 500 (config 6)")
    ap.add_argument("--pods", type=int, default=None,
                    help="default 50,000 (config 2) / 100,000 (config 3) / 20,000 (config 4) / 64,000 in "
                         "groups of 64 (config 5) / 2,000 preemptors (config 6)")
    ap.add_argument("--runs", default="plain,sampled,traced", help="which of the three drains to run")
    ap.add_argument("--batch", type=int, default=None, help="default 4,096 (1,024 for config 6)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "drain_profile"))
    ap.add_argument("--ab", type=int, default=0, metavar="PAIRS",
                    help="run PAIRS alternating planes-on / planes-off drain pairs instead of the profile")
    ap.add_argument("--ab-of", choices=("commit", "stage"), default="commit",
                    help="which planes --ab turns off: the commit and fold planes, or the ingest and term planes")
    ap.add_argument("--mesh", type=int, default=0, metavar="S",
                    help="drain on a node mesh of S shards of the card; the traced run also on one device")
    args = ap.parse_args()
    cfg = args.config.split("-")[0]
    args.nodes = args.nodes or {"2": 5000, "3": 10000, "4": 2000, "5": 2000, "6": 500}[cfg]
    args.pods = args.pods or {"2": 50000, "3": 100000, "4": 20000, "5": 64000, "6": 2000}[cfg]
    args.batch = args.batch or (1024 if args.config == "6" else 4096)
    runs = set(args.runs.split(","))
    if not torch.cuda.is_available():
        print("torch_drain_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    print(f"[profile] card: {smi}; config {args.config}{' + Services' if args.services else ''}"
          f"{' under the RTCR Policy' if args.policy == 'rtcr' else ''}, "
          f"{args.nodes} nodes, {args.pods} pods, batch {args.batch}"
          f"{f', node mesh of {args.mesh} shards' if args.mesh else ''}", flush=True)

    if args.policy == "rtcr" and args.config != "2":
        ap.error("--policy rtcr drains config 2")
    if args.mesh and (args.ab or args.policy != "default"):
        ap.error("--mesh drains the default provider's profile runs")
    work = (args.config, args.services, args.policy)
    # builds + loads the kernels
    for mesh in sorted({0, args.mesh}):
        drain(*work, args.nodes // 10, args.pods // (100 if args.config == "3-hard" else 10), args.batch // 4,
              mesh=mesh)
    if args.ab:
        return ab(work, args, smi)
    summary = {"card": smi, "config": args.config, "services": args.services, "policy": args.policy,
               "nodes": args.nodes,
               "pods": args.pods, "batch": args.batch, "mesh": args.mesh}
    if "plain" in runs:
        summary["plain"] = drain(*work, args.nodes, args.pods, args.batch, mesh=args.mesh)
        print(f"[profile] plain: {json.dumps(summary['plain'])}", flush=True)
        print(plane_line("plain", summary["plain"]), flush=True)
    if "sampled" in runs:
        sampler = StackSampler(threading.get_ident())
        sampled = drain(*work, args.nodes, args.pods, args.batch, lambda: sampler, mesh=args.mesh)
        host = sampler.report()
        summary["sampled"] = {"run": sampled, **host}
        print(f"[profile] sampled: {json.dumps(sampled)}; {host['samples']} samples over "
              f"{host['sampled_s']:.3f}s", flush=True)
        print(plane_line("sampled", sampled), flush=True)
        for k, v in host["stage_share"].items():
            print(f"[profile]   stage {k}: {100 * v:.1f}% of the sampled time", flush=True)
        for k, v in host["top_leaves"].items():
            print(f"[profile]   leaf {k}: {100 * v:.1f}%", flush=True)
    last = {"config": args.config, "services": args.services, "policy": args.policy, "mesh": args.mesh}
    if "plain" in summary:
        last["plain_pods_per_s"] = summary["plain"]["pods_per_s"]
    if "traced" not in runs:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(last), flush=True)
        return 0

    from torch.profiler import ProfilerActivity, profile, record_function

    def trace_one(mesh: int):
        """One traced drain (on a mesh of `mesh` shards, or one device):
        its run and the device split of its trace."""
        tp = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        @contextlib.contextmanager
        def traced():
            with tp:
                with record_function("drain"):
                    yield

        run = drain(*work, args.nodes, args.pods, args.batch, traced, mesh=mesh)
        scratch = os.path.join(REPO, "build")
        os.makedirs(scratch, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            trace = os.path.join(d, "drain_trace.json")
            tp.export_chrome_trace(trace)
            device = device_split(trace)
        label = f"traced mesh {mesh}" if mesh else "traced"
        print(f"[profile] {label}: {json.dumps(run)}", flush=True)
        print(plane_line(label, run), flush=True)
        print(f"[profile]   {label}: device busy {device['busy_ms']:.3f} ms of a {device['window_ms']:.3f} ms "
              f"window, idle share {device['idle_share']:.4f}, {device['device_events']} device events", flush=True)
        for name, v in list(device["per_name"].items())[:12]:
            print(f"[profile]   {label}: {v['busy_ms']:.3f} ms in {v['count']} x {name[:90]}", flush=True)
        return {"run": run, "device": device}

    if args.mesh:  # the single-device trace beside the mesh's
        summary["traced_one_device"] = trace_one(0)
    summary["traced"] = trace_one(args.mesh)
    device = summary["traced"]["device"]
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if args.mesh:
        last["one_device_idle_share"] = summary["traced_one_device"]["device"]["idle_share"]
    print(json.dumps({**last, "idle_share": device["idle_share"], "busy_ms": device["busy_ms"],
                      "window_ms": device["window_ms"]}), flush=True)
    return 0 if device["device_events"] else 1


if __name__ == "__main__":
    sys.exit(main())
