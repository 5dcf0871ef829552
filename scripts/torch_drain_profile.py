#!/usr/bin/env python3
"""Where the port's drain spends its time, on one NVIDIA card.

    python3 scripts/torch_drain_profile.py [--config 2|3] [--services]
        [--nodes N] [--pods P] [--batch 4096] [--out chiprun_out/drain_profile]

Drives a drain of chip_smoke.py phase 5 (kubernetes_tpu_torch's Scheduler,
tie-noise on) on bench.py config 2 (default 5,000 nodes / 50,000 pods) or
config 3 (default 10,000 nodes / 100,000 pods; with --services, one
Service per app feeds SelectorSpread) after a 1/10-scale warm-up drain
that builds and loads the kernels, three times:

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

Prints one JSON object as the last line of its output and writes the full
summary to --out/summary.json. Exits non-zero when the trace holds no
device event.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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
    ("scheduler/driver.py", "_encode"),
    ("state/tensors.py", "dedup_specs"),
    ("state/tensors.py", "set_pod"),
    ("state/terms.py", "compile_batch_terms"),
    ("state/convert.py", "arrays_to_torch"),
    ("state/cache.py", "device_arrays"),
    ("state/cache.py", "_patch_rows"),
    ("ops/pipeline.py", "solve_pipeline"),
    ("scheduler/driver.py", "_commit"),
    ("api/types.py", "with_node"),
    ("state/cache.py", "assume_pods"),
    ("state/queue.py", "add_unschedulable"),
    ("scheduler/driver.py", "wait_for_binds"),
)


def drain(config: int, services: bool, n_nodes: int, n_pods: int, batch: int, around=contextlib.nullcontext):
    from kubernetes_tpu_torch.models.clusters import bench_config2, bench_config3, fill_cache
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.cache import SchedulerCache
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    fn = None
    if config == 2:
        nodes, pods = bench_config2(n_nodes, n_pods)
    else:
        nodes, pods, fn = bench_config3(n_nodes, n_pods, services=services)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes)
    for p in pods:
        queue.add(p)
    sched = Scheduler(cache, queue, batch_size=batch, deterministic=False, seed=0, device="cuda")
    if fn is not None:
        sched.set_spread_selectors_fn(fn)
    torch.cuda.synchronize()
    with around():
        t0 = time.perf_counter()
        res = sched.run_until_empty()
        sched.wait_for_binds()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched.close()
    if res.scheduled != n_pods:
        raise SystemExit(f"drain placed {res.scheduled} of {n_pods} pods")
    return {"wall_s": wall, "pods_per_s": n_pods / wall, **sched.stats}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, choices=(2, 3), default=2)
    ap.add_argument("--services", action="store_true", help="config 3: one Service per app")
    ap.add_argument("--nodes", type=int, default=None, help="default 5,000 (config 2) / 10,000 (config 3)")
    ap.add_argument("--pods", type=int, default=None, help="default 50,000 (config 2) / 100,000 (config 3)")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "drain_profile"))
    args = ap.parse_args()
    args.nodes = args.nodes or (5000 if args.config == 2 else 10000)
    args.pods = args.pods or (50000 if args.config == 2 else 100000)
    if not torch.cuda.is_available():
        print("torch_drain_profile: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True).stdout.strip()
    print(f"[profile] card: {smi}; config {args.config}{' + Services' if args.services else ''}, "
          f"{args.nodes} nodes, {args.pods} pods, batch {args.batch}", flush=True)

    work = (args.config, args.services)
    drain(*work, args.nodes // 10, args.pods // 10, args.batch // 4)  # builds + loads the kernels
    plain = drain(*work, args.nodes, args.pods, args.batch)
    print(f"[profile] plain: {json.dumps(plain)}", flush=True)

    sampler = StackSampler(threading.get_ident())
    sampled = drain(*work, args.nodes, args.pods, args.batch, lambda: sampler)
    host = sampler.report()
    print(f"[profile] sampled: {json.dumps(sampled)}; {host['samples']} samples over "
          f"{host['sampled_s']:.3f}s", flush=True)
    for k, v in host["stage_share"].items():
        print(f"[profile]   stage {k}: {100 * v:.1f}% of the sampled time", flush=True)
    for k, v in host["top_leaves"].items():
        print(f"[profile]   leaf {k}: {100 * v:.1f}%", flush=True)

    from torch.profiler import ProfilerActivity, profile, record_function

    tp = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    @contextlib.contextmanager
    def traced():
        with tp:
            with record_function("drain"):
                yield

    traced_run = drain(*work, args.nodes, args.pods, args.batch, traced)
    scratch = os.path.join(REPO, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        trace = os.path.join(d, "drain_trace.json")
        tp.export_chrome_trace(trace)
        device = device_split(trace)
    print(f"[profile] traced: {json.dumps(traced_run)}", flush=True)
    print(f"[profile]   device busy {device['busy_ms']:.3f} ms of a {device['window_ms']:.3f} ms window, "
          f"idle share {device['idle_share']:.4f}, {device['device_events']} device events", flush=True)
    for name, v in list(device["per_name"].items())[:12]:
        print(f"[profile]   {v['busy_ms']:.3f} ms in {v['count']} x {name[:90]}", flush=True)

    summary = {
        "card": smi, "config": args.config, "services": args.services,
        "nodes": args.nodes, "pods": args.pods, "batch": args.batch,
        "plain": plain, "sampled": {"run": sampled, **host},
        "traced": {"run": traced_run, "device": device},
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"config": args.config, "services": args.services,
                      "plain_pods_per_s": plain["pods_per_s"], "idle_share": device["idle_share"],
                      "busy_ms": device["busy_ms"], "window_ms": device["window_ms"]}), flush=True)
    return 0 if device["device_events"] else 1


if __name__ == "__main__":
    sys.exit(main())
