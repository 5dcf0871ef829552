#!/usr/bin/env python3
"""The spread score and the term match of two checkouts of the port, on one card.

    python3 scripts/topology_ab.py --parent DIR [--rounds 2]

DIR holds another checkout of the repository (for example the parent commit,
unpacked with `git archive`). Each round measures the parent, then this
checkout, then this checkout again, then the parent (one process each, each
building its own kernels), on the config-3 + Services batch shapes of
chip_smoke.py (U = 128, N = 10,240, TT = 256, S = 256, V = 16):

  spread     the ScheduleAnyway score as its wrapper launches it, every launch
             prebuilt: a checkout whose spread score reads a match matrix
             launches the match first
  match      match_terms alone: the batch terms against the signatures with
             the namespace test

For each: the relaunch mean (CUDA events over 200 calls) and the device
duration from a torch.profiler (CUPTI) trace: the summed durations of the
kernels a call launches, over the calls seen. Prints one JSON line per
process and a summary line; writes chiprun_out/topology_ab.json. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("match_terms_kernel", "spread_member_kernel", "spread_pairs_kernel", "spread_merge_kernel",
           "spread_score_kernel", "spread_score_cluster_kernel")


def device_ms(fn, reps: int = 50) -> dict:
    """Per kernel name: the mean device milliseconds a call of fn() spends
    in it, from a torch.profiler trace of `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = next((k for k in KERNELS if k in e.get("name", "")), None)
            if name:
                n, t = out.get(name, (0, 0.0))
                out[name] = (n + 1, t + e["dur"] / 1e3)
    # a trace may drop an event at its edges: the mean over the calls seen
    calls = max(n for n, _ in out.values())
    return {k: t / calls for k, (n, t) in out.items()}


def measure(root: str) -> dict:
    """The measurements of the checkout at `root` (run in its own process)."""
    import inspect

    import torch

    sys.path.insert(0, root)
    import chip_smoke as CS
    from kubernetes_tpu_torch.kernels import build
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import topology as TO

    build.library()
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

    dev_spread, dev_match = device_ms(spread), device_ms(match)
    return {
        "root": root, "card": torch.cuda.get_device_name(0),
        "spread_ms": CS.cuda_ms(spread, 200), "spread_device_ms": sum(dev_spread.values()),
        "spread_kernels": dev_spread,
        "match_ms": CS.cuda_ms(match, 200), "match_device_ms": sum(dev_match.values()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure)), flush=True)
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
            got = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root], cwd=root,
                                 stdout=subprocess.PIPE, text=True, check=True).stdout.strip().splitlines()[-1]
            print(f"[ab] {label}: {got}", flush=True)
            runs[label].append(json.loads(got))
    summary = {"card": smi}
    for label, rs in runs.items():
        summary[label] = {k: min(r[k] for r in rs) for k in ("spread_ms", "spread_device_ms", "match_ms",
                                                              "match_device_ms")}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "topology_ab.json"), "w") as f:
        json.dump({"summary": summary, "runs": runs}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
