"""The port's Scheduling Framework seam against the reference's: the
scenarios of tests/test_framework.py (Filter, Score and PreFilter plugins
changing decisions, QueueSort in pop order and in in-batch contention, the
registry and built-in plugins, the migration shims), the bind pipeline's
extension points (Reserve / Unreserve / Permit / PreBind / Bind /
PostBind), and seeded random clusters drained under Filter + Score +
PostFilter plugins — the same assignments, counts and binds, pod for pod.
The reference runs on the CPU (tests/conftest.py) as
`Scheduler(speculate=False, columnar_cache=False)`; the port with
device="cpu" (the kernels' plain versions). Exact equality throughout."""

import threading

import pytest

import kubernetes_tpu.ops  # noqa: F401  (turns x64 on, as the reference runs)
from kubernetes_tpu.api import types as RT
from kubernetes_tpu.framework import interface as RF
from kubernetes_tpu.framework import plugins as RP
from kubernetes_tpu.oracle import predicates as RPred
from kubernetes_tpu.oracle import priorities as RPri
from kubernetes_tpu.scheduler import driver as RD
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.queue import PodInfo as RPodInfo
from kubernetes_tpu.state.queue import PriorityQueue as RQueue

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.framework import interface as PF
from kubernetes_tpu_torch.framework import plugins as PP
from kubernetes_tpu_torch.models.clusters import fill_cache, make_node, make_pod, random_cluster
from kubernetes_tpu_torch.oracle import predicates as PPred
from kubernetes_tpu_torch.oracle import priorities as PPri
from kubernetes_tpu_torch.scheduler import driver as PD
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.queue import PodInfo, PriorityQueue

PKGS = {
    "ref": dict(t=RT, F=RF, P=RP, D=RD, Cache=RCache, Queue=RQueue, PodInfo=RPodInfo, Pred=RPred, Pri=RPri,
                kw=dict(speculate=False, columnar_cache=False)),
    "port": dict(t=PT, F=PF, P=PP, D=PD, Cache=SchedulerCache, Queue=PriorityQueue, PodInfo=PodInfo,
                 Pred=PPred, Pri=PPri, kw=dict(device="cpu")),
}


def plugin_classes(F):
    """The test plugins, subclassing one package's Plugin base (its
    framework registers a plugin at the points it overrides)."""

    class OnlyNode(F.Plugin):
        name = "OnlyNode"

        def __init__(self, allowed):
            self.allowed = allowed

        def filter(self, state, pod, node_info):
            if node_info.node.name == self.allowed:
                return F.Status.success()
            return F.Status.unschedulable("not the chosen one")

    class PreferNode(F.Plugin):
        name = "PreferNode"
        score_weight = 1

        def __init__(self, preferred):
            self.preferred = preferred

        def score(self, state, pod, node_name):
            return (1000 if node_name == self.preferred else 0), F.Status.success()

    class RejectNamed(F.Plugin):
        name = "RejectNamed"

        def __init__(self, reject):
            self.reject = reject

        def pre_filter(self, state, pod):
            if pod.name == self.reject:
                return F.Status.unschedulable("rejected by prefilter")
            return F.Status.success()

    class ReversePriority(F.Plugin):
        name = "ReversePriority"

        def less(self, a, b):
            return a.pod.get_priority() < b.pod.get_priority()

    class HashFilter(F.Plugin):
        """Filter keeping a seeded, pod-dependent subset of the nodes."""

        name = "HashFilter"

        def filter(self, state, pod, node_info):
            h = sum(map(ord, pod.name + node_info.node.name))
            return F.Status.success() if h % 5 else F.Status.unschedulable("hash")

    class NameScore(F.Plugin):
        """Score by node name with a normalization and a weight, reading
        and writing the pod's CycleState."""

        name = "NameScore"
        score_weight = 3

        def score(self, state, pod, node_name):
            try:
                salt = state.read("salt")
            except KeyError:
                salt = len(pod.name)
                state.write("salt", salt)
            return (sum(map(ord, node_name)) * salt) % 17, F.Status.success()

        def normalize_score(self, state, pod, scores):
            hi = max(scores.values(), default=0)
            for n in scores:
                scores[n] = scores[n] * 10 // hi if hi else 0
            return F.Status.success()

    class KeepHalf(F.Plugin):
        """PostFilter rejecting pods whose feasible set is below two nodes."""

        name = "KeepHalf"

        def post_filter(self, state, pod, nodes, statuses):
            return F.Status.success() if len(nodes) >= 2 else F.Status.unschedulable("too few")

    class Recorder(F.Plugin):
        """Reserve / Unreserve / Permit / PreBind / Bind / PostBind, each
        logging its call; Reserve refuses `deny`, PreBind fails `broken`,
        Bind handles every pod (SUCCESS: no binder call)."""

        name = "Recorder"

        def __init__(self, deny="", broken=""):
            self.deny, self.broken = deny, broken
            self.log = []
            self.lock = threading.Lock()

        def _note(self, point, pod, node):
            with self.lock:
                self.log.append((point, pod.name, node))

        def reserve(self, state, pod, node_name):
            self._note("reserve", pod, node_name)
            return F.Status.unschedulable("denied") if pod.name == self.deny else F.Status.success()

        def unreserve(self, state, pod, node_name):
            self._note("unreserve", pod, node_name)

        def permit(self, state, pod, node_name):
            self._note("permit", pod, node_name)
            return F.Status.success(), 0.0

        def pre_bind(self, state, pod, node_name):
            self._note("pre_bind", pod, node_name)
            return F.Status.error("broken") if pod.name == self.broken else F.Status.success()

        def bind(self, state, pod, node_name):
            self._note("bind", pod, node_name)
            return F.Status.success()

        def post_bind(self, state, pod, node_name):
            self._note("post_bind", pod, node_name)

    class WaitPermit(F.Plugin):
        """Permit parking every pod until the test allows or rejects it
        through the framework's waiting pods."""

        name = "WaitPermit"

        def permit(self, state, pod, node_name):
            return F.Status(F.WAIT, "wait"), 5.0

    return {c.__name__: c for c in (OnlyNode, PreferNode, RejectNamed, ReversePriority, HashFilter, NameScore,
                                    KeepHalf, Recorder, WaitPermit)}


def _mk(pkg, nodes_fn, plugins_fn, **kw):
    m = PKGS[pkg]
    cache = m["Cache"]()
    for n in nodes_fn(m["t"]):
        cache.add_node(n)
    binds = []
    plugins = plugins_fn(plugin_classes(m["F"]))
    sched = m["D"].Scheduler(cache=cache, queue=m["Queue"](),
                             binder=m["D"].Binder(lambda pod, node: binds.append((pod.key(), node))),
                             framework=m["F"].Framework(plugins), deterministic=True, **m["kw"], **kw)
    return sched, binds, plugins


def _outcome(res, binds):
    return (res.scheduled, res.unschedulable, getattr(res, "errors", 0), dict(res.assignments), sorted(binds))


def _nodes4(t):
    return [make_node(f"n{i}", cpu_milli=4000, mem=8 * 2**30, t=t) for i in range(4)]


def _both(nodes_fn, plugins_fn, pods_fn, **kw):
    out = {}
    for pkg in PKGS:
        sched, binds, _ = _mk(pkg, nodes_fn, plugins_fn, **kw)
        for p in pods_fn(PKGS[pkg]["t"]):
            sched.queue.add(p)
        res = sched.schedule_batch()
        sched.wait_for_binds()
        out[pkg] = _outcome(res, binds)
    assert out["port"] == out["ref"]
    return out["port"]


def test_filter_plugin_changes_assignments():
    s, u, e, assign, _ = _both(_nodes4, lambda c: [c["OnlyNode"]("n2")],
                               lambda t: [make_pod(f"p{i}", cpu_milli=100, mem=0, t=t) for i in range(3)])
    assert s == 3 and set(assign.values()) == {"n2"}


def test_filter_plugin_unschedulable_when_no_node_passes():
    s, u, _, _, _ = _both(lambda t: _nodes4(t)[:2], lambda c: [c["OnlyNode"]("nope")],
                          lambda t: [make_pod("p0", cpu_milli=100, mem=0, t=t)], enable_preemption=False)
    assert (s, u) == (0, 1)


def test_score_plugin_changes_selection():
    s, _, _, assign, _ = _both(_nodes4, lambda c: [c["PreferNode"]("n3")],
                               lambda t: [make_pod(f"p{i}", cpu_milli=100, mem=0, t=t) for i in range(3)])
    assert s == 3 and set(assign.values()) == {"n3"}


def test_pre_filter_rejects_pod():
    s, u, _, assign, _ = _both(lambda t: _nodes4(t)[:1], lambda c: [c["RejectNamed"]("bad")],
                               lambda t: [make_pod("good", cpu_milli=100, mem=0, t=t),
                                          make_pod("bad", cpu_milli=100, mem=0, t=t)], enable_preemption=False)
    assert (s, u) == (1, 1) and "default/good" in assign


def test_queue_sort_plugin_overrides_pop_order():
    popped = {}
    for pkg, m in PKGS.items():
        q = m["Queue"]()
        cache = m["Cache"]()
        cache.add_node(make_node("n0", cpu_milli=1000, mem=2**30, t=m["t"]))
        m["D"].Scheduler(cache=cache, queue=q, framework=m["F"].Framework([plugin_classes(m["F"])["ReversePriority"]()]),
                         deterministic=True, **m["kw"])
        pods = []
        for i, prio in enumerate((100, 0, 50, 0, 100)):
            p = make_pod(f"p{i}", cpu_milli=100, mem=0, t=m["t"])
            p.priority = prio
            pods.append(p)
        for p in pods:
            q.add(p)
        popped[pkg] = [i.pod.name for i in q.pop_batch(5)]
    assert popped["port"] == popped["ref"]
    assert set(popped["port"][:2]) == {"p1", "p3"}  # the priority-0 pods first under the reversed comparator


def test_queue_sort_governs_in_batch_contention():
    """The comparator's order decides who wins scarce capacity within a
    batch (the solve's order and the commit's), not only the pop order."""

    def pods(t):
        lo, hi = make_pod("lo", cpu_milli=800, mem=0, t=t), make_pod("hi", cpu_milli=800, mem=0, t=t)
        lo.priority, hi.priority = 0, 100
        return [hi, lo]

    _, _, _, assign, _ = _both(lambda t: [make_node("n0", cpu_milli=1000, mem=2**30, t=t)],
                               lambda c: [c["ReversePriority"]()], pods, enable_preemption=False)
    assert assign.get("default/lo") == "n0" and "default/hi" not in assign


def test_queue_sort_with_gang_and_staging():
    """A QueueSort comparator with gang groups in the queue and the ingest
    and term planes staging at admission: pop_all_in_groups and the staged
    dispatch keep working, and the drain equals the reference's."""
    group_label = PD.POD_GROUP_LABEL

    def pods(t):
        out = []
        for i in range(12):
            p = make_pod(f"g{i}", cpu_milli=500, mem=0, labels={group_label: f"grp{i % 3}", "app": "gang"}, t=t)
            p.priority = i % 4
            out.append(p)
        for i in range(6):
            p = make_pod(f"s{i}", cpu_milli=300, mem=0, labels={"app": "solo"}, t=t)
            p.priority = 10 - i
            out.append(p)
        return out

    out = {}
    for pkg, m in PKGS.items():
        sched, binds, _ = _mk(pkg, lambda t: [make_node(f"n{i}", cpu_milli=2000, mem=2**32, t=t) for i in range(3)],
                              lambda c: [c["ReversePriority"]()], enable_preemption=False, batch_size=5)
        for p in pods(m["t"]):
            sched.queue.add(p)
        res = sched.run_until_empty(max_cycles=20)
        sched.wait_for_binds()
        out[pkg] = _outcome(res, binds)
    assert out["port"] == out["ref"]
    assert out["port"][0] > 0


def test_builtin_plugins_and_registry():
    got = {}
    for pkg, m in PKGS.items():
        t, P = m["t"], m["P"]
        reg = P.new_default_registry(P.Handle(lambda: None))
        names = reg.names()
        node = make_node("n0", cpu_milli=1000, mem=2**30, t=t)
        cache = m["Cache"]()
        cache.add_node(node)
        ni = cache.snapshot.get("n0")
        pinned = make_pod("p", cpu_milli=0, mem=0, t=t)
        other = make_pod("q", cpu_milli=0, mem=0, node_name="n1", t=t)
        nn = reg.make("NodeName")
        f = (nn.filter(m["F"].CycleState(), pinned, ni).code, nn.filter(m["F"].CycleState(), other, ni).code)
        ps = reg.make("PrioritySort")
        a = m["PodInfo"](pod=make_pod("a", cpu_milli=0, mem=0, t=t), seq=1)
        b = m["PodInfo"](pod=make_pod("b", cpu_milli=0, mem=0, t=t), seq=2)
        a.pod.priority, b.pod.priority = 5, 1
        tt = reg.make("TaintToleration")
        tainted = make_node("n2", taints=[t.Taint(key="k", value="v", effect="NoSchedule")], t=t)
        cache.add_node(tainted)
        got[pkg] = (names, f, ps.less(a, b), ps.less(b, a),
                    tt.filter(m["F"].CycleState(), pinned, cache.snapshot.get("n2")).code)
    assert got["port"] == got["ref"]
    assert set(got["port"][0]) == {"PrioritySort", "NodeName", "TaintToleration", "VolumeBinding"}
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        PP.new_default_registry().make("VolumeBinding")


def test_migration_shims():
    got = {}
    for pkg, m in PKGS.items():
        t = m["t"]
        cache = m["Cache"]()
        for i in range(3):
            cache.add_node(make_node(f"n{i}", cpu_milli=4000 - 1000 * i, mem=8 * 2**30, t=t))
        handle = m["P"].Handle(lambda: cache.snapshot)
        shim_f = m["P"].predicate_plugin("ShimFit", m["Pred"].pod_fits_resources)
        shim_s = m["P"].priority_plugin("ShimLeast", m["Pri"].least_requested_priority, handle, weight=2)
        pod = make_pod("p", cpu_milli=2500, mem=0, t=t)
        state = m["F"].CycleState()
        fits = [shim_f.filter(state, pod, cache.snapshot.get(f"n{i}")).code for i in range(3)]
        scores = [shim_s.score(state, pod, f"n{i}")[0] for i in range(3)]
        got[pkg] = (fits, scores, shim_s.score_weight)
    assert got["port"] == got["ref"]
    assert got["port"][0] == [0, 0, 2]


def test_bind_pipeline_extension_points():
    """Reserve refusing one pod, PreBind failing another (unreserve, back to
    the queue), a Bind plugin handling the rest: the same outcome, plugin
    calls and binder calls as the reference."""
    logs = {}
    out = {}
    for pkg, m in PKGS.items():
        sched, binds, plugins = _mk(pkg, _nodes4, lambda c: [c["Recorder"](deny="p1", broken="p2")],
                                    enable_preemption=False)
        for i in range(4):
            sched.queue.add(make_pod(f"p{i}", cpu_milli=100, mem=0, t=m["t"]))
        res = sched.schedule_batch()
        sched.wait_for_binds()
        out[pkg] = _outcome(res, binds) + (sorted(p.key() for p in sched.cache.snapshot.all_pods()),)
        logs[pkg] = sorted(plugins[0].log)
    assert out["port"] == out["ref"] and logs["port"] == logs["ref"]
    points = {x[0] for x in logs["port"]}
    assert {"reserve", "unreserve", "permit", "pre_bind", "bind", "post_bind"} <= points


def test_permit_waiting_pods():
    """A Permit plugin parks every pod; another thread allows p0 and rejects
    p1 through the framework's waiting pods: p0 binds, p1 is unbound."""
    out = {}
    for pkg, m in PKGS.items():
        sched, binds, _ = _mk(pkg, _nodes4, lambda c: [c["WaitPermit"]()], enable_preemption=False)
        fw = sched.framework
        for i in range(2):
            sched.queue.add(make_pod(f"p{i}", cpu_milli=100, mem=0, t=m["t"]))
        done = threading.Event()

        def release():
            while not done.is_set():
                for key, verdict in (("default/p0", True), ("default/p1", False)):
                    wp = fw.get_waiting_pod(key)
                    if wp is not None and wp.allowed is None:
                        wp.allow() if verdict else wp.reject()
                done.wait(0.01)

        th = threading.Thread(target=release, daemon=True)
        th.start()
        res = sched.schedule_batch()
        sched.wait_for_binds()
        done.set()
        th.join()
        out[pkg] = (sorted(binds), sorted(p.key() for p in sched.cache.snapshot.all_pods()), res.scheduled)
    assert out["port"] == out["ref"]
    assert [b[0] for b in out["port"][0]] == ["default/p0"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_cluster_drain_under_plugins(seed):
    """Seeded random clusters (every predicate and priority branch, host
    ports, topology and inter-pod terms) drained in batches of 16 under a
    Filter, a weighted normalizing Score and a PostFilter plugin: every
    placed pod re-ranks through `_oracle_place`'s full scan over the device
    score row; the same placements, counts and binds as the reference."""
    out = {}
    for pkg, m in PKGS.items():
        t = m["t"]
        nodes, existing, pending = random_cluster(seed, 40, 40, 48, t=t, pending_ports=True, topology=True,
                                                  interpod=True, pending_affinity=False)
        cache = m["Cache"]()
        fill_cache(cache, nodes, existing)
        binds = []
        c = plugin_classes(m["F"])
        sched = m["D"].Scheduler(cache=cache, queue=m["Queue"](), batch_size=16, deterministic=True,
                                 binder=m["D"].Binder(lambda pod, node: binds.append((pod.key(), node))),
                                 framework=m["F"].Framework([c["HashFilter"](), c["NameScore"](), c["KeepHalf"]()]),
                                 enable_preemption=False, **m["kw"])
        for p in pending:
            sched.queue.add(p)
        res = sched.run_until_empty(max_cycles=10)
        sched.wait_for_binds()
        out[pkg] = _outcome(res, binds) + (sched.stats["oracle_places"],)
    assert out["port"] == out["ref"]
    assert out["port"][0] > 0 and out["port"][5] > 0
