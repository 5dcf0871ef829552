"""The port's HTTP SchedulerExtender against the reference's, over real
HTTP with extender/v1 JSON.

Server direction: the port's ExtenderServer (device="cpu": the kernels'
plain versions) and the reference's, each over its own cache holding the
same cluster, answer the same JSON for /filter in both wire modes and on
the device path (device_threshold lowered: the port through
ops/pipeline.filter_mask, the reference through its JAX filter_mask), for
/prioritize, /bind and /preemption; the per-spec encode memo and the
filter counters. The device path answers every request it can represent
(no silent oracle detour) and a kernel failure is a counted 500.

Client direction: the tests/test_extender.py cases of the driver
consulting an out-of-tree extender (filter + prioritize with weight,
everything filtered out, a wire failure that is an error and never
preempts, an ignorable outage skipped), an extender's preemption veto and
extender-delegated binding — the same outcome as the reference's driver,
pod for pod. Exact equality throughout."""

import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import kubernetes_tpu.ops  # noqa: F401  (turns x64 on, as the reference runs)
from kubernetes_tpu.api import types as RT
from kubernetes_tpu.extender import ExtenderConfig as RConfig
from kubernetes_tpu.extender import ExtenderServer as RServer
from kubernetes_tpu.extender import HTTPExtender as RHTTPExtender
from kubernetes_tpu.scheduler import driver as RD
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.queue import PriorityQueue as RQueue

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.extender import ExtenderConfig, ExtenderServer, HTTPExtender
from kubernetes_tpu_torch.extender import server as server_mod
from kubernetes_tpu_torch.models.clusters import fill_cache, make_node, make_pod, random_cluster
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.scheduler import driver as PD
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.queue import PriorityQueue

PKGS = {
    "ref": dict(t=RT, Server=RServer, Cache=RCache, Queue=RQueue, D=RD, Config=RConfig, HTTP=RHTTPExtender,
                srv_kw={}, kw=dict(speculate=False, columnar_cache=False)),
    "port": dict(t=PT, Server=ExtenderServer, Cache=SchedulerCache, Queue=PriorityQueue, D=PD, Config=ExtenderConfig,
                 HTTP=HTTPExtender, srv_kw=dict(device="cpu"), kw=dict(device="cpu")),
}


def _post(url: str, obj, timeout: float = 120):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _servers(fill, **kw):
    """One started server per package over a cache that `fill(t, cache)`
    filled identically."""
    out = {}
    for pkg, m in PKGS.items():
        cache = m["Cache"]()
        fill(m["t"], cache)
        binds = []
        srv = m["Server"](cache=cache, bind_fn=lambda args, _b=binds: _b.append(args), **m["srv_kw"], **kw).start()
        srv.test_binds = binds
        out[pkg] = srv
    return out


def _stop(servers):
    for srv in servers.values():
        srv.stop()


def _six(t, cache):
    for i in range(6):
        cache.add_node(make_node(f"n{i}", cpu_milli=4000, mem=8 * 2**30, t=t))


def _both(servers, path, payload_fn):
    """POST each package's payload (built with its own types) to its own
    server; the answers must be equal."""
    got = {pkg: _post(srv.url + path, payload_fn(PKGS[pkg]["t"])) for pkg, srv in servers.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def test_filter_node_cache_capable():
    servers = _servers(_six)
    try:
        res = _both(servers, "/filter", lambda t: {
            "Pod": t.pod_to_k8s(make_pod("p0", cpu_milli=100, mem=0, t=t)), "NodeNames": ["n0", "n1", "ghost"]})
        assert sorted(res["NodeNames"]) == ["n0", "n1"] and res["FailedNodes"] == {"ghost": "node unknown"}
        assert servers["port"].stats == {"filter_device": 0, "filter_oracle": 1, "filter_errors": 0}
    finally:
        _stop(servers)


def test_filter_full_nodes_mode():
    """Full v1.Node objects on the wire; the answer echoes the feasible ones
    (each package draws its own node uids: the uids are set alike)."""

    def node(t, name, cpu):
        n = make_node(name, cpu_milli=cpu, mem=8 * 2**30, t=t)
        n.uid = f"uid-{name}"
        return t.node_to_k8s(n)

    servers = _servers(_six)
    try:
        res = _both(servers, "/filter", lambda t: {
            "Pod": t.pod_to_k8s(make_pod("p0", cpu_milli=3000, mem=0, t=t)),
            "Nodes": {"items": [node(t, "big", 4000), node(t, "small", 1000)]}})
        assert [n["metadata"]["name"] for n in res["Nodes"]["items"]] == ["big"] and "small" in res["FailedNodes"]
    finally:
        _stop(servers)


def _random_fill(seed, **kw):
    def fill(t, cache):
        nodes, existing, _ = random_cluster(seed, 40, 40, 60, t=t, **kw)
        fill_cache(cache, nodes, existing)
    return fill


def _random_pending(seed, **kw):
    return lambda t: random_cluster(seed, 40, 40, 60, t=t, **kw)[2]


CLUSTERS = {
    "plain": dict(pending_ports=True),
    "topology": dict(pending_ports=True, topology=True, hard_spread=True),
    "interpod": dict(pending_ports=True, topology=True, interpod=True, pending_affinity=True),
    "overflow": dict(overflow_nodes=3, pending_ports=True, topology=True, interpod=True),
}


@pytest.mark.parametrize("cluster", list(CLUSTERS))
@pytest.mark.parametrize("seed", [4, 9])
def test_filter_device_path_matches_reference(cluster, seed):
    """device_threshold lowered: every pending pod of a seeded random
    cluster (every predicate branch, DoNotSchedule spread, every inter-pod
    term kind, encoding-overflow nodes) POSTed with every node name and a
    ghost. The port's answers equal the reference's; a request the
    encoding can represent is answered by the device path; the device
    path's feasible sets equal the oracle path's."""
    kw = CLUSTERS[cluster]
    servers = _servers(_random_fill(seed, **kw), device_threshold=4)
    oracle = _servers(_random_fill(seed, **kw), device_threshold=10**6)
    # the reference's device-path answers that gave way to its oracle
    ref_none = []
    ref_device = servers["ref"]._device_filter
    servers["ref"]._device_filter = lambda pod, names: ref_none.append(1) if (
        r := ref_device(pod, names)) is None else r
    try:
        pend = {pkg: _random_pending(seed, **kw)(PKGS[pkg]["t"]) for pkg in PKGS}
        names = _names(servers["port"]) + ["ghost"]
        for k in range(len(pend["port"])):
            body = lambda t: {"Pod": t.pod_to_k8s(pend["ref" if t is RT else "port"][k]),  # noqa: E731
                              "NodeNames": names}
            dev = _both(servers, "/filter", body)
            orc = _both(oracle, "/filter", body)
            assert sorted(dev["NodeNames"]) == sorted(orc["NodeNames"])
            assert set(dev["FailedNodes"]) == set(orc["FailedNodes"])
        st = servers["port"].stats
        assert st["filter_errors"] == 0 and st["filter_device"] + st["filter_oracle"] == len(pend["port"])
        # the port gives way to its oracle exactly where the reference does
        assert st["filter_oracle"] == len(ref_none)
        if cluster == "overflow":
            assert st["filter_oracle"] == len(pend["port"])  # a valid node row falls back
        else:
            assert st["filter_device"] > 0
    finally:
        _stop(servers)
        _stop(oracle)


def _names(srv):
    return sorted(srv.cache.snapshot.node_infos)


def test_filter_device_path_launches_no_score_kernel(monkeypatch):
    """filter_mask runs the mask half only: no score, spread-score or
    inter-pod-score program is called, and it counts its calls."""
    called = []
    for name in ("score_matrix",):
        monkeypatch.setattr(PP.S, name, lambda *a, _n=name, **k: called.append(_n))
    for name in ("interpod_score", "spread_score", "selector_spread_score"):
        monkeypatch.setattr(PP.T, name, lambda *a, _n=name, **k: called.append(_n))
    servers = _servers(_random_fill(4, **CLUSTERS["interpod"]), device_threshold=4)
    try:
        pend = {pkg: _random_pending(4, **CLUSTERS["interpod"])(PKGS[pkg]["t"]) for pkg in PKGS}
        for k in range(10):
            _both(servers, "/filter", lambda t: {"Pod": t.pod_to_k8s(pend["ref" if t is RT else "port"][k]),
                                                 "NodeNames": _names(servers["port"])})
        assert called == [] and servers["port"].stats["filter_device"] > 0
    finally:
        _stop(servers)


def test_filter_kernel_failure_is_a_counted_500(monkeypatch):
    """A failing device path is not answered by the oracle: the handler's
    500 reply, counted in filter_errors."""

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(server_mod, "filter_mask", boom)
    cache = SchedulerCache()
    _six(PT, cache)
    srv = ExtenderServer(cache=cache, device_threshold=2, device="cpu").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.url + "/filter", {"Pod": PT.pod_to_k8s(make_pod("p0", t=PT)), "NodeNames": _names(srv)})
        assert err.value.code == 500
        assert srv.stats == {"filter_device": 0, "filter_oracle": 0, "filter_errors": 1}
    finally:
        srv.stop()


def test_filter_device_path_memoizes_same_spec_pods():
    def fill(t, cache):
        for i in range(8):
            cache.add_node(make_node(f"n{i}", cpu_milli=1000 if i % 2 else 4000, mem=8 * 2**30, t=t))

    servers = _servers(fill, device_threshold=4)
    try:
        names = [f"n{i}" for i in range(8)]
        for rep in range(3):
            res = _both(servers, "/filter", lambda t: {
                "Pod": t.pod_to_k8s(make_pod(f"web-{rep}", cpu_milli=2000, mem=0, labels={"app": "web"}, t=t)),
                "NodeNames": names})
            assert sorted(res["NodeNames"]) == ["n0", "n2", "n4", "n6"]
        _both(servers, "/filter", lambda t: {
            "Pod": t.pod_to_k8s(make_pod("db-0", cpu_milli=500, mem=0, labels={"app": "db"}, t=t)),
            "NodeNames": names})
        assert servers["port"].filter_encode_cache == servers["ref"].filter_encode_cache == {"hits": 2, "misses": 2}
        assert servers["port"].stats == {"filter_device": 4, "filter_oracle": 0, "filter_errors": 0}
    finally:
        _stop(servers)


@pytest.mark.parametrize("seed", [0, 6])
def test_prioritize_matches_reference(seed):
    kw = dict(topology=True, interpod=True)
    servers = _servers(_random_fill(seed, **kw))
    try:
        pend = {pkg: _random_pending(seed, **kw)(PKGS[pkg]["t"]) for pkg in PKGS}
        for k in range(0, len(pend["port"]), 4):
            res = _both(servers, "/prioritize", lambda t: {"Pod": t.pod_to_k8s(pend["ref" if t is RT else "port"][k]),
                                                            "NodeNames": _names(servers["port"])[:25]})
            assert all(0 <= d["Score"] <= 10 for d in res)
    finally:
        _stop(servers)


def test_prioritize_policy_weights_and_rtcr():
    def fill(t, cache):
        _six(t, cache)
        loaded = make_pod("existing", cpu_milli=3500, mem=2**30, node_name="n0", t=t)
        cache.add_pod(loaded)

    servers = _servers(fill, priority_weights=(("RequestedToCapacityRatioPriority", 2), ("NodeAffinityPriority", 1)),
                       rtcr=(((0, 0), (100, 10)), (("cpu", 1), ("memory", 1))))
    try:
        res = _both(servers, "/prioritize", lambda t: {"Pod": t.pod_to_k8s(make_pod("p0", cpu_milli=100, mem=0, t=t)),
                                                        "NodeNames": ["n0", "n1", "n2"]})
        scores = {d["Host"]: d["Score"] for d in res}
        assert scores["n0"] > scores["n1"]  # bin-packing prefers the loaded node
    finally:
        _stop(servers)


def test_bind_preemption_and_healthz():
    def fill(t, cache):
        _six(t, cache)
        victim = make_pod("victim", cpu_milli=100, mem=0, node_name="n1", t=t)
        victim.uid = "victim-uid"
        cache.add_pod(victim)

    servers = _servers(fill)
    try:
        res = _both(servers, "/bind", lambda t: {"PodName": "p0", "PodNamespace": "default", "PodUID": "u1",
                                                  "Node": "n3"})
        assert res["Error"] == ""
        assert [b.node for b in servers["port"].test_binds] == ["n3"]
        meta = _both(servers, "/preemption", lambda t: {
            "Pod": t.pod_to_k8s(make_pod("preemptor", t=t)),
            "NodeNameToMetaVictims": {
                "n1": {"Pods": [{"UID": "victim-uid"}], "NumPDBViolations": 0},
                "n2": {"Pods": [{"UID": "unknown-uid"}], "NumPDBViolations": 0},
                "ghost": {"Pods": [{"UID": "victim-uid"}], "NumPDBViolations": 0}}})
        assert list(meta["NodeNameToMetaVictims"]) == ["n1"]

        def full(t):
            v = make_pod("victim", cpu_milli=100, mem=0, node_name="n1", t=t)
            v.uid = "victim-uid"
            return {"Pod": t.pod_to_k8s(make_pod("preemptor", t=t)),
                    "NodeNameToVictims": {"n1": {"Pods": [t.pod_to_k8s(v)], "NumPDBViolations": 1},
                                          "n4": {"Pods": [t.pod_to_k8s(make_pod("gone", t=t))], "NumPDBViolations": 0}}}

        res = _both(servers, "/preemption", full)
        assert list(res["NodeNameToMetaVictims"]) == ["n1"]
        for srv in servers.values():
            with urllib.request.urlopen(srv.url + "/healthz", timeout=5) as r:
                assert json.loads(r.read())["ok"] is True
    finally:
        _stop(servers)


def test_wire_round_trip_matches_reference():
    """pod_to_k8s / node_to_k8s, and the same after a trip through
    pod_from_k8s / node_from_k8s, on a random cluster reaching every field
    the encoding reads (affinity of every kind, tolerations, spread
    constraints, ports, images): the port's JSON equals the reference's
    (uids and creation times aside, which each package draws itself)."""
    out = {}
    for pkg, m in PKGS.items():
        t = m["t"]
        nodes, existing, pending = random_cluster(3, 12, 20, 20, t=t, pending_ports=True, topology=True,
                                                  hard_spread=True, interpod=True)
        docs = []
        for p in existing + pending:
            for d in (t.pod_to_k8s(p), t.pod_to_k8s(t.pod_from_k8s(t.pod_to_k8s(p)))):
                for k in ("uid", "creationTimestamp"):
                    d["metadata"].pop(k, None)
                docs.append(d)
        for n in nodes:
            for d in (t.node_to_k8s(n), t.node_to_k8s(t.node_from_k8s(t.node_to_k8s(n)))):
                d["metadata"].pop("uid")
                docs.append(d)
        out[pkg] = docs
    assert out["port"] == out["ref"]


# --- client direction: the driver consults an out-of-tree extender ----------


class _FakeExtender(BaseHTTPRequestHandler):
    """extender_test.go's fakeExtender style: only nodes whose name ends in
    an even digit pass; prioritize scores the digit; bind records; its
    preemption verb vetoes every node (an empty map)."""

    binds = []

    def log_message(self, fmt, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        payload = json.loads(self.rfile.read(n))
        if self.path.endswith("/filter"):
            out = {"NodeNames": [x for x in payload["NodeNames"] if int(x[-1]) % 2 == 0], "FailedNodes": {},
                   "Error": ""}
        elif self.path.endswith("/prioritize"):
            out = [{"Host": x, "Score": int(x[-1])} for x in payload["NodeNames"]]
        elif self.path.endswith("/bind"):
            _FakeExtender.binds.append((payload["PodName"], payload["Node"]))
            out = {"Error": ""}
        elif self.path.endswith("/preemption"):
            out = {"NodeNameToMetaVictims": {}}
        else:
            out = {"Error": "unknown"}
        body = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def fake_extender():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _FakeExtender)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    _FakeExtender.binds = []
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _drive(nodes_fn, pods_fn, ext_fn, batches=1, pre=None, **kw):
    """The same scenario through each package's driver → (outcome, deleted
    victims, pending count)."""
    out = {}
    for pkg, m in PKGS.items():
        t = m["t"]
        cache = m["Cache"]()
        for n in nodes_fn(t):
            cache.add_node(n)
        if pre is not None:
            for p in pre(t):
                cache.add_pod(p)
        binds, deleted = [], []
        sched = m["D"].Scheduler(cache=cache, queue=m["Queue"](), extenders=ext_fn(m), deterministic=True,
                                 binder=m["D"].Binder(lambda p, n: binds.append((p.name, n))),
                                 delete_fn=lambda p: deleted.append(p.name), **m["kw"], **kw)
        for p in pods_fn(t):
            sched.queue.add(p)
        res = None
        for _ in range(batches):
            r = sched.schedule_batch()
            res = r if res is None else res
        sched.wait_for_binds()
        pending = sum(sched.queue.counts())
        out[pkg] = ((res.scheduled, res.unschedulable, res.errors, res.preempted, dict(res.assignments)),
                    sorted(binds), deleted, pending)
    assert out["port"] == out["ref"]
    return out["port"]


def _nodes(n):
    return lambda t: [make_node(f"n{i}", cpu_milli=4000, mem=8 * 2**30, t=t) for i in range(n)]


def test_driver_consults_extender(fake_extender):
    (s, _, _, _, assign), binds, _, _ = _drive(
        _nodes(6), lambda t: [make_pod(f"p{i}", cpu_milli=100, mem=0, t=t) for i in range(3)],
        lambda m: [m["HTTP"](m["Config"](url_prefix=fake_extender, filter_verb="filter", prioritize_verb="prioritize",
                                          weight=100, node_cache_capable=True))])
    # only even nodes pass; prioritize x100 dominates: n4 for every pod
    assert s == 3 and set(assign.values()) == {"n4"} and len(binds) == 3


def test_driver_extender_filters_all_nodes_out(fake_extender):
    (s, u, e, _, _), _, _, _ = _drive(
        lambda t: [make_node("n1", cpu_milli=4000, mem=8 * 2**30, t=t)],
        lambda t: [make_pod("p0", cpu_milli=100, mem=0, t=t)],
        lambda m: [m["HTTP"](m["Config"](url_prefix=fake_extender, filter_verb="filter", node_cache_capable=True))],
        enable_preemption=False)
    assert (s, u, e) == (0, 1, 0)


def test_driver_extender_wire_failure_is_error_not_fiterror():
    """A non-ignorable outage is a scheduling error: the pod goes back to
    the queue, and preemption does not run."""

    def pods(t):
        p = make_pod("p0", cpu_milli=100, mem=0, t=t)
        p.priority = 1000
        return [p]

    (s, u, e, pre, _), _, deleted, pending = _drive(
        _nodes(1), pods,
        lambda m: [m["HTTP"](m["Config"](url_prefix="http://127.0.0.1:1", filter_verb="filter", node_cache_capable=True,
                                          timeout_s=0.2))],
        pre=lambda t: [make_pod("running", cpu_milli=100, mem=0, node_name="n0", t=t)], enable_preemption=True)
    assert (s, u, e, pre) == (0, 0, 1, 0) and deleted == [] and pending == 1


def test_driver_ignorable_extender_outage_is_skipped():
    (s, _, e, _, _), _, _, _ = _drive(
        _nodes(1), lambda t: [make_pod("p0", cpu_milli=100, mem=0, t=t)],
        lambda m: [m["HTTP"](m["Config"](url_prefix="http://127.0.0.1:1", filter_verb="filter", node_cache_capable=True,
                                          ignorable=True, timeout_s=0.2))])
    assert (s, e) == (1, 0)


def test_driver_extender_binds_and_vetoes_preemption(fake_extender):
    """An extender with a bind verb binds every pod it is interested in
    (the binder is not called); its preemption verb vetoes the victim
    search's plan (no victim deleted) and makes the batched device search
    ineligible."""

    def pods(t):
        out = [make_pod(f"p{i}", cpu_milli=1500, mem=0, t=t) for i in range(3)]
        big = make_pod("big", cpu_milli=3900, mem=0, t=t)
        big.priority = 1000
        return out + [big]

    (s, u, e, pre, assign), binds, deleted, _ = _drive(
        _nodes(2), pods,
        lambda m: [m["HTTP"](m["Config"](url_prefix=fake_extender, bind_verb="bind", preempt_verb="preemption",
                                          node_cache_capable=True))],
        pre=lambda t: [make_pod("low", cpu_milli=2000, mem=0, node_name="n1", t=t)])
    assert binds == [] and deleted == [] and pre == 0
    # both drivers bound through the one fake extender
    assert sorted(_FakeExtender.binds) == sorted([(k.split("/")[1], n) for k, n in assign.items()] * 2)
    assert s == len(assign) > 0
