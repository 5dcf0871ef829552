#!/usr/bin/env python3
"""Topology kernels of two checkouts of the port, on one card.

    python3 scripts/topology_ab.py --parent DIR [--mode spread|interpod|selector] [--rounds 2]

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
}
KERNELS["match"] = ("match_terms_kernel",)


def device_ms(fn, kernels, reps: int = 50, tries: int = 3) -> dict:
    """Per kernel name: the mean device milliseconds a call of fn() spends
    in it, from a torch.profiler trace of `reps` calls (a trace that saw
    fewer than half of them is taken again, up to `tries` traces)."""
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
        out = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                name = next((k for k in kernels if k in e.get("name", "")), None)
                if name:
                    n, t = out.get(name, (0, 0.0))
                    out[name] = (n + 1, t + e["dur"] / 1e3)
        if out and max(n for n, _ in out.values()) >= reps // 2:
            break
    else:
        raise SystemExit(f"the profiler saw too few launches of {kernels} in {tries} traces")
    # a trace may drop an event at its edges: the mean over the calls seen
    calls = max(n for n, _ in out.values())
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


MEASURES = {"spread": measure_spread, "interpod": measure_interpod, "selector": measure_selector}


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
