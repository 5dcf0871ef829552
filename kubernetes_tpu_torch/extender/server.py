"""HTTP SchedulerExtender server: the port's copy of
`kubernetes_tpu.extender.server`, whose /filter device path runs on the
card.

A real kube-scheduler configured with

    {"urlPrefix": "http://host:port", "filterVerb": "filter",
     "prioritizeVerb": "prioritize", "bindVerb": "bind",
     "preemptVerb": "preemption", "nodeCacheCapable": true, "weight": 1}

POSTs extender/v1 JSON here per scheduling cycle
(core/extender.go:43 HTTPExtender.send → :305-331 nodeCacheCapable wire
modes) and this server answers from the batch solver's state:

* /filter — feasibility for one pod over the candidate set. In
  nodeCacheCapable mode only node NAMES cross the wire and candidates
  resolve against this server's own cluster cache; otherwise full
  v1.Node objects arrive and are evaluated as a transient snapshot by the
  host oracle. A nodeCacheCapable request naming at least
  `device_threshold` nodes runs `ops/pipeline.filter_mask` over the
  cache's device mirror (the filter, spread-filter and inter-pod-filter
  kernels, one [U, N] mask of which row 0 is the pod); a smaller one uses
  the oracle. The device path gives way to the oracle only where the
  encoding cannot represent the request (a valid node row in encoding
  fallback, the pod's own fallback or term-table overflow, pattern-bank
  overflow rows); a build or launch failure propagates, and the HTTP
  handler's 500 reply is counted (`stats["filter_errors"]`).
* /prioritize — 0..10 host priorities (MaxExtenderPriority) from the
  default weighted score set.
* /bind — delegated binding (factory.go:713 equivalent) via bind_fn.
* /preemption — victim-map validation; answers in MetaVictims (UID-only)
  form when the args came nodeCacheCapable.

The mirror lives on the server's device: the card unless the caller
passes device="cpu", which runs the kernels' plain versions.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..api.types import Pod
from ..device import resolve_device
from ..ops import filters as F
from ..ops.pipeline import SolveConfig, filter_mask
from ..oracle.nodeinfo import Snapshot
from ..oracle.predicates import compute_predicate_metadata, pod_fits_on_node
from ..oracle.priorities import DEFAULT_PRIORITY_WEIGHTS, prioritize_nodes
from ..scheduler.driver import _term_kind_names
from ..state.cache import SchedulerCache, TensorMirror
from ..state.convert import arrays_to_torch
from ..state.tensors import KeySlotOverflow, PodBatch, _bucket, spec_key
from ..state.terms import compile_batch_terms
from .types import (
    MAX_EXTENDER_PRIORITY,
    ExtenderArgs,
    ExtenderBindingArgs,
    ExtenderBindingResult,
    ExtenderFilterResult,
    ExtenderPreemptionArgs,
    ExtenderPreemptionResult,
    HostPriority,
    MetaVictims,
)

# the per-spec encode memo's bound (oldest entry evicted first)
ENCODE_MEMO_SIZE = 1024


class ExtenderServer:
    """The solver-backed extender. Feed its cache from an informer; start()
    serves on a daemon thread."""

    def __init__(
        self,
        cache: Optional[SchedulerCache] = None,
        bind_fn: Optional[Callable[[ExtenderBindingArgs], None]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        device_threshold: int = 256,
        enabled_predicates: Optional[frozenset] = None,
        priority_weights=None,  # tuple of (registration name, weight)
        rtcr=None,  # RequestedToCapacityRatio (shape, resources) Policy args
        device=None,
    ):
        self.device = resolve_device(device)
        self.cache = cache or SchedulerCache()
        self.bind_fn = bind_fn
        self.device_threshold = device_threshold
        # Policy/provider selection (config.factory): gates the oracle
        # chain, the device mask, and the prioritize weights
        self.enabled_predicates = enabled_predicates
        self.priority_weights = tuple(priority_weights) if priority_weights else None
        self.rtcr = rtcr
        self._mirror: Optional[TensorMirror] = None
        self._mirror_lock = threading.Lock()
        # per-spec encode memo for /filter: same-spec pods (every replica of
        # a controller, the common extender traffic) reuse one PodBatch row
        # and compiled term table; keyed by spec_key, dropped wholesale when
        # the vocab's encoding widths grow (the arrays would be the wrong
        # shape). Guarded by _mirror_lock, as are the counters.
        self._enc_cache: Dict = {}
        self._enc_cache_widths = None
        self.filter_encode_cache = {"hits": 0, "misses": 0}
        # /filter requests answered by the device path, by the oracle, and
        # failed with a 500 reply
        self.stats = {"filter_device": 0, "filter_oracle": 0, "filter_errors": 0}
        self._stats_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        h, p = self.address
        return f"http://{h}:{p}"

    def start(self) -> "ExtenderServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving and close the socket (a server never started only
        closes it: shutdown() would wait for a loop that never ran)."""
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _count(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] += 1

    # -- core answers --------------------------------------------------------

    def _encode(self, mirror: TensorMirror, pod: Pod):
        """The pod's PodBatch row and term table as host arrays, memoized
        per spec: (pod arrays, pod fallback, term arrays, aux, term
        overflow, term kinds present, topology slots named)."""
        widths = (mirror.vocab.config.key_slots, mirror.vocab.config.resource_slots)
        if widths != self._enc_cache_widths:
            self._enc_cache.clear()
            self._enc_cache_widths = widths
        key = spec_key(pod)
        cached = self._enc_cache.get(key)
        if cached is not None:
            self.filter_encode_cache["hits"] += 1
            # LRU refresh: a hot spec is not evicted for being old
            self._enc_cache[key] = self._enc_cache.pop(key)
            return cached
        self.filter_encode_cache["misses"] += 1
        batch = PodBatch(mirror.vocab, _bucket(1))
        batch.set_pod(0, pod)
        tb, aux = compile_batch_terms(mirror.vocab, [pod], b_capacity=batch.capacity)
        cached = (
            batch.arrays(), bool(batch.fallback[0]), tb.arrays(), aux, bool(tb.overflow_owners),
            set(np.unique(tb.kind[tb.valid]).tolist()), set(np.asarray(tb.topo_slot[tb.valid], np.int64).tolist()),
        )
        if len(self._enc_cache) >= ENCODE_MEMO_SIZE:
            self._enc_cache.pop(next(iter(self._enc_cache)))
        self._enc_cache[key] = cached
        return cached

    def filter_inputs(self, pod: Pod) -> Optional[Dict]:
        """The keyword arguments of the `filter_mask` call that answers
        /filter for `pod` on the synced mirror (row 0 is the pod), or None
        where the encoding cannot represent the request."""
        with self._mirror_lock:
            return self._filter_inputs(pod)

    def _filter_inputs(self, pod: Pod) -> Optional[Dict]:
        if self._mirror is None:
            self._mirror = TensorMirror(self.cache, self.device)
        mirror = self._mirror
        mirror.sync()
        # a valid node row in encoding fallback: the device mask cannot
        # answer for the whole set
        if bool((mirror.nodes.fallback & mirror.nodes.valid).any()):
            return None
        while True:
            try:
                pa_host, pod_fallback, ta_host, aux, term_overflow, present, slots = self._encode(mirror, pod)
                break
            except KeySlotOverflow:
                mirror._rebuild()  # the vocab grew its key slots: encode again, as the driver does
        if pod_fallback or term_overflow or mirror.pats.overflow_rows:
            return None
        pats = mirror.pats
        vocab = mirror.vocab
        # the term kinds present (an absent kind's program computes its
        # identity) and the segment axis over every slot a term or pattern
        # names, as the driver sizes them
        kinds = _term_kind_names(present, bool(np.any(aux["n_sel_spread"] > 0)), pats)
        slots = set(slots) | set(np.asarray(pats.bank.topo_slot[pats.valid], np.int64).tolist())
        v = _bucket(max([vocab.dense_size(int(sl)) for sl in slots if sl >= 0] + [vocab.zone_count(), 1]))
        na, ea, xa = mirror.device_arrays()
        dev = self.device
        return dict(
            na=na, pa=arrays_to_torch(pa_host, dev), ids=F.make_ids(vocab),
            config=SolveConfig(predicates=self.enabled_predicates) if self.enabled_predicates is not None else None,
            term_kinds=kinds, ea=ea, ta=arrays_to_torch(ta_host, dev), au=arrays_to_torch(aux, dev), xa=xa,
            n_buckets=v,
        )

    def _device_filter(self, pod: Pod, names: List[str]) -> Optional[Dict[str, bool]]:
        """One filter_mask over the cache mirror: {name: feasible} for the
        names the mirror knows, or None where the encoding cannot represent
        the request (the caller asks the oracle). A kernel failure
        raises."""
        with self._mirror_lock:
            inputs = self._filter_inputs(pod)
            if inputs is None:
                return None
            row = filter_mask(**inputs)[0].cpu().numpy()
            row_of = self._mirror.row_of
            return {name: bool(row[row_of[name]]) for name in names if name in row_of}

    def _resolve(self, args: ExtenderArgs) -> Tuple[Snapshot, List[str], bool]:
        """(snapshot, candidate names, cache_capable_mode)."""
        if args.node_names is not None:
            return self.cache.snapshot, list(args.node_names), True
        nodes = args.nodes or []
        return Snapshot(nodes, []), [n.name for n in nodes], False

    def handle_filter(self, args: ExtenderArgs) -> ExtenderFilterResult:
        pod = args.pod
        if pod is None:
            return ExtenderFilterResult(error="no pod in args")
        snap, names, cache_mode = self._resolve(args)
        feasible: List[str] = []
        failed: Dict[str, str] = {}
        device = (
            self._device_filter(pod, names)
            if cache_mode and len(names) >= self.device_threshold
            else None
        )
        if device is not None:
            self._count("filter_device")
            for name in names:
                ok = device.get(name)
                if ok:
                    feasible.append(name)
                else:
                    failed[name] = "node unknown" if ok is None else "does not fit"
        else:
            self._count("filter_oracle")
            meta = compute_predicate_metadata(pod, snap, enabled=self.enabled_predicates)
            for name in names:
                ni = snap.get(name)
                if ni is None:
                    failed[name] = "node unknown"
                    continue
                ok, reasons = pod_fits_on_node(pod, ni, meta=meta)
                if ok:
                    feasible.append(name)
                else:
                    failed[name] = "; ".join(reasons) if reasons else "does not fit"
        if cache_mode:
            return ExtenderFilterResult(node_names=feasible, failed_nodes=failed)
        keep = set(feasible)
        return ExtenderFilterResult(
            nodes=[n for n in (args.nodes or []) if n.name in keep], failed_nodes=failed
        )

    def handle_prioritize(self, args: ExtenderArgs) -> List[HostPriority]:
        pod = args.pod
        if pod is None:
            return []
        snap, names, _ = self._resolve(args)
        weights = None
        if self.priority_weights is not None:
            weights = {name: 0 for name in DEFAULT_PRIORITY_WEIGHTS}
            weights.update(dict(self.priority_weights))
        scores = prioritize_nodes(pod, snap, weights=weights, rtcr=self.rtcr)
        # rescale the weighted sum into extender range [0, 10]
        relevant = {n: scores.get(n, 0) for n in names}
        hi = max(relevant.values(), default=0)
        out = []
        for n in names:
            s = relevant.get(n, 0)
            scaled = (s * MAX_EXTENDER_PRIORITY) // hi if hi > 0 else 0
            out.append(HostPriority(host=n, score=int(scaled)))
        return out

    def handle_bind(self, args: ExtenderBindingArgs) -> ExtenderBindingResult:
        if self.bind_fn is None:
            return ExtenderBindingResult(error="binding not supported")
        try:
            self.bind_fn(args)
        except Exception as e:
            return ExtenderBindingResult(error=str(e))
        return ExtenderBindingResult()

    def handle_preemption(self, args: ExtenderPreemptionArgs) -> ExtenderPreemptionResult:
        """Validate the scheduler's victim map against our cache: drop
        candidate nodes we don't know and victims that are already gone
        (core/extender.go ProcessPreemption → convertToMetaVictims)."""
        out: Dict[str, MetaVictims] = {}
        snap = self.cache.snapshot
        if args.node_name_to_meta_victims:
            for node, mv in args.node_name_to_meta_victims.items():
                ni = snap.get(node)
                if ni is None:
                    continue
                known = {p.uid for p in ni.pods}
                uids = [u for u in mv.pod_uids if u in known]
                if len(uids) == len(mv.pod_uids):
                    out[node] = MetaVictims(pod_uids=uids, num_pdb_violations=mv.num_pdb_violations)
        else:
            for node, v in args.node_name_to_victims.items():
                ni = snap.get(node)
                if ni is None:
                    continue
                # every named victim must still exist on the node (by UID,
                # or by namespace/name when the sender's UIDs differ)
                known_uids = {p.uid for p in ni.pods}
                known_keys = {p.key() for p in ni.pods}
                if all(p.uid in known_uids or p.key() in known_keys for p in v.pods):
                    out[node] = MetaVictims(
                        pod_uids=[p.uid for p in v.pods],
                        num_pdb_violations=v.num_pdb_violations,
                    )
        return ExtenderPreemptionResult(node_name_to_meta_victims=out)

    # -- http plumbing -------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):  # quiet
                pass

            def _reply(self, obj, code: int = 200) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._reply({"Error": "bad json"}, 400)
                    return
                path = self.path.rstrip("/")
                try:
                    if path.endswith("/filter"):
                        res = server.handle_filter(ExtenderArgs.from_json(payload))
                        self._reply(res.to_json())
                    elif path.endswith("/prioritize"):
                        hp = server.handle_prioritize(ExtenderArgs.from_json(payload))
                        self._reply([h.to_json() for h in hp])
                    elif path.endswith("/bind"):
                        res = server.handle_bind(ExtenderBindingArgs.from_json(payload))
                        self._reply(res.to_json())
                    elif path.endswith("/preemption"):
                        res = server.handle_preemption(ExtenderPreemptionArgs.from_json(payload))
                        self._reply(res.to_json())
                    else:
                        self._reply({"Error": f"unknown verb {path}"}, 404)
                except Exception as e:  # never crash the serving thread; counted on /filter
                    if path.endswith("/filter"):
                        server._count("filter_errors")
                    self._reply({"Error": str(e)}, 500)

            def do_GET(self) -> None:
                if self.path.rstrip("/").endswith("/healthz"):
                    self._reply({"ok": True})
                else:
                    self._reply({"Error": "POST only"}, 404)

        return Handler
