"""The slices end to end on the CPU: the port's solve_pipeline against the
reference's with no term kinds, with the score-only topology kinds
(ScheduleAnyway spread, SelectorSpread, both) and with the inter-pod kinds
under in-batch tracking, and the port's Scheduler(device="cpu") against the
reference Scheduler with every plane off, on seeded taint + node-affinity
+ resources drains, on config-3-shaped topology-spread drains with and
without spreading selectors, and on config-4-shaped and random inter-pod
drains (required anti-affinity, preferred (anti-)affinity, host ports,
existing pods with affinity) — pod-for-pod identical placements,
deterministic and with tie-noise. The port runs its default commit and
fold planes there; it is also held, with the planes on and off, to the
reference's planes-on Scheduler on configs 2, 3 and 4 and on config 3 with
DoNotSchedule constraints ("config 3-hard", whose defers go through the
commit arbiter). The host oracle's drains (defer escalations, required
pod affinity to in-batch anchors, encoding overflow, fallback node rows,
late and outstanding nominations, term-carrying preemptors) equal the
reference's default driver, its oracle and arbiter counters included.
Tolerance: exact equality. A batch holding a gang group's pod schedules as
the reference's (tests/test_torch_gang.py holds the gang path itself)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import filters as RF
from kubernetes_tpu.ops import pipeline as RP
from kubernetes_tpu.oracle.nodeinfo import Snapshot
from kubernetes_tpu.scheduler.driver import Scheduler as RScheduler
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.queue import PriorityQueue as RQueue

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu.state.tensors import PodBatch as RPodBatch
from kubernetes_tpu.state.tensors import encode_snapshot as r_encode
from kubernetes_tpu.state.terms import compile_batch_terms as r_compile

from kubernetes_tpu.state.cache import TensorMirror as RMirror
from kubernetes_tpu_torch.models.clusters import (
    HOST_KEY,
    ZONE_KEY,
    bench_config2,
    bench_config3,
    bench_config4,
    bench_config6,
    commit_plane_mix,
    fill_cache,
    random_cluster,
    random_preemption_cluster,
    random_selectors,
)
from kubernetes_tpu_torch.state.cache import TensorMirror as PMirror
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.ops.solver import prng_key_data
from kubernetes_tpu_torch.scheduler.driver import Binder, Scheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot as PSnapshot
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.state.queue import PriorityQueue
from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
from kubernetes_tpu_torch.state.tensors import encode_snapshot as p_encode
from kubernetes_tpu_torch.state.terms import compile_batch_terms as p_compile

CONFIGS = [
    (None, None),
    (frozenset({"GeneralPredicates", "PodToleratesNodeTaints"}),
     (("MostRequestedPriority", 2), ("NodeAffinityPriority", 3), ("SelectorSpreadPriority", 2))),
]


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("dedup", [False, True], ids=["rows", "sig"])
def test_solve_pipeline_matches_reference(cfg, det, dedup):
    nodes, existing, pending = random_cluster(21 + cfg, 48, 60, 40, t=RT)
    args = RP.encode_solve_args(Snapshot(nodes, existing), pending, key=jax.random.PRNGKey(5))
    na, pa = ({k: np.asarray(v) for k, v in d.items()} for d in args[:2])
    pb = None
    if dedup:  # 3 pods per spec row, some padding
        b = 3 * len(pending)
        pb = {"sig": np.arange(b, dtype=np.int32) % len(pending),
              "valid": np.arange(b) < b - 5,
              "priority": (np.arange(b) % 4).astype(np.int32)}
    preds, prios = CONFIGS[cfg]
    ref = RP.solve_pipeline(
        *args, pb=None if pb is None else {k: jnp.asarray(v) for k, v in pb.items()},
        deterministic=det, config=RP.SolveConfig(predicates=preds, priorities=prios),
        term_kinds=frozenset(), return_carry=True,
    )
    port = PP.solve_pipeline(
        arrays_to_torch(na, "cpu"), arrays_to_torch(pa, "cpu"),
        {k: int(v) for k, v in args[6].items()}, prng_key_data(5),
        pb=None if pb is None else arrays_to_torch(pb, "cpu"), deterministic=det,
        config=PP.SolveConfig(predicates=preds, priorities=prios), term_kinds=frozenset(),
        return_carry=True,
    )
    assert np.array_equal(np.asarray(ref[0]), port[0].numpy())  # assignment
    assert np.array_equal(np.asarray(ref[1]), port[1].numpy())  # score
    for a, b in zip(ref[2], port[2]):  # carry
        assert np.array_equal(np.asarray(a), b.numpy())
    assert (np.asarray(ref[0]) >= 0).sum() > 10


def test_solve_pipeline_refuses_terms_and_tracking():
    """term_kinds=None is the reference's "assume every kind": the same
    score and assignment as the reference's with None, on a cluster whose
    batch carries DoNotSchedule and ScheduleAnyway spread and every
    inter-pod kind (required pod affinity included, which the host oracle
    re-checks), and as the port's with every kind named. An unknown kind is
    an error."""
    out = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, existing, pending = random_cluster(43, 60, 40, 120, t=t, topology=True, hard_spread=True,
                                                  interpod=True)
        cache = (RCache if pkg == "ref" else SchedulerCache)()
        fill_cache(cache, nodes, existing)
        mirror = RMirror(cache) if pkg == "ref" else PMirror(cache, device="cpu")
        batch = (RPodBatch if pkg == "ref" else PPodBatch)(mirror.vocab, 64)
        for i, p in enumerate(pending):
            batch.set_pod(i, p)
        tb, aux = (r_compile if pkg == "ref" else p_compile)(mirror.vocab, pending, b_capacity=64)
        out[pkg] = [mirror.nodes.arrays(), mirror.eps.arrays(), mirror.pats.arrays(), tb.arrays(), aux,
                    batch.arrays(), (RF if pkg == "ref" else PF).make_ids(mirror.vocab)]
    na, ea, xa, ta, au, pa, ids = out["ref"]
    jx = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    ref = RP.solve_pipeline(jx(na), jx(pa), jx(ea), jx(ta), jx(xa), jx(au), ids, jax.random.PRNGKey(2),
                            deterministic=True, term_kinds=None, n_buckets=128)
    na, ea, xa, ta, au, pa, ids = out["port"]
    tc = lambda d: arrays_to_torch(d, "cpu")  # noqa: E731
    kw = dict(deterministic=True, ea=tc(ea), ta=tc(ta), au=tc(au), xa=tc(xa), n_buckets=128)
    port = PP.solve_pipeline(tc(na), tc(pa), ids, prng_key_data(2), term_kinds=None, **kw)
    named = PP.solve_pipeline(tc(na), tc(pa), ids, prng_key_data(2), term_kinds=PP.PORTED_TERM_KINDS, **kw)
    assert np.array_equal(np.asarray(ref[1]), port[1].numpy()) and torch.equal(port[1], named[1])  # score
    assert np.array_equal(np.asarray(ref[0]), port[0].numpy()) and torch.equal(port[0], named[0])  # assignment
    assert (np.asarray(ref[0]) >= 0).sum() > 10
    with pytest.raises(ValueError, match="unknown"):
        PP.mask_and_score({}, {}, {}, term_kinds=frozenset({"spread_soft", "gang"}))


TOPOLOGY_KINDS = {
    "spread": frozenset({"spread_soft"}),
    "selectors": frozenset({"sel_spread"}),
    "both": frozenset({"spread_soft", "sel_spread"}),
}


@pytest.mark.parametrize("kinds", list(TOPOLOGY_KINDS))
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_solve_pipeline_topology_kinds_match_reference(kinds, det):
    """The score-only topology kinds through the whole pipeline, on a
    cluster with spread constraints on zone, hostname (V > 64) and rack
    keys, nil/empty/expression selectors, deleting pods and 0/1/2 spreading
    selectors per pod, at the n_buckets the driver would pick."""
    n_buckets = 128
    out = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, existing, pending = random_cluster(31, 90, 48, 150, t=t, topology=True)
        fn = random_selectors(t)
        sel = {id(p): fn(p) for p in pending} if kinds != "spread" else None
        bank, sigs, _ = r_encode(Snapshot(nodes, existing)) if pkg == "ref" else \
            p_encode(PSnapshot(nodes, existing))
        batch = (RPodBatch if pkg == "ref" else PPodBatch)(bank.vocab, 64)
        for i, p in enumerate(pending):
            batch.set_pod(i, p)
        tb, aux = (r_compile if pkg == "ref" else p_compile)(
            bank.vocab, pending, spread_selectors=sel, b_capacity=64)
        out[pkg] = [bank.arrays(), sigs.arrays(), tb.arrays(), aux, batch.arrays(),
                    (RF if pkg == "ref" else PF).make_ids(bank.vocab)]
    na, ea, ta, au, pa, ids = out["ref"]
    jx = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    ref = RP.solve_pipeline(
        jx(na), jx(pa), jx(ea), jx(ta), {}, jx(au), ids, jax.random.PRNGKey(9),
        deterministic=det, term_kinds=TOPOLOGY_KINDS[kinds], n_buckets=n_buckets,
    )
    na, ea, ta, au, pa, ids = out["port"]
    tc = lambda d: arrays_to_torch(d, "cpu")  # noqa: E731
    port = PP.solve_pipeline(
        tc(na), tc(pa), ids, prng_key_data(9), deterministic=det,
        term_kinds=TOPOLOGY_KINDS[kinds], ea=tc(ea), ta=tc(ta), au=tc(au), n_buckets=n_buckets,
    )
    assert np.array_equal(np.asarray(ref[1]), port[1].numpy())  # score
    assert np.array_equal(np.asarray(ref[0]), port[0].numpy())  # assignment
    assert (np.asarray(ref[0]) >= 0).sum() > 10


INTERPOD_KINDS = frozenset({"aff_req", "anti_req", "pref", "et_anti", "et_score"})


@pytest.mark.parametrize("track", [True, False], ids=["tracked", "untracked"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_solve_pipeline_interpod_tracking_matches_reference(track, det):
    """Every inter-pod kind (batch and existing-pod terms) through the
    whole pipeline, with and without the solver's in-batch tracking, at the
    n_buckets the driver would pick, deduped spec rows (3 pods each)."""
    n_buckets = 128
    out = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, existing, pending = random_cluster(41, 90, 40, 200, t=t, topology=True, interpod=True)
        cache = (RCache if pkg == "ref" else SchedulerCache)()
        fill_cache(cache, nodes, existing)
        mirror = RMirror(cache) if pkg == "ref" else PMirror(cache, device="cpu")
        batch = (RPodBatch if pkg == "ref" else PPodBatch)(mirror.vocab, 64)
        for i, p in enumerate(pending):
            batch.set_pod(i, p)
        tb, aux = (r_compile if pkg == "ref" else p_compile)(mirror.vocab, pending, b_capacity=64)
        out[pkg] = [mirror.nodes.arrays(), mirror.eps.arrays(), mirror.pats.arrays(), tb.arrays(), aux,
                    batch.arrays(), (RF if pkg == "ref" else PF).make_ids(mirror.vocab)]
    b = 3 * 40
    pb = {"sig": np.arange(b, dtype=np.int32) % 40, "valid": np.arange(b) < b - 4,
          "priority": (np.arange(b) % 3).astype(np.int32)}
    kinds = INTERPOD_KINDS | {"spread_soft"}
    na, ea, xa, ta, au, pa, ids = out["ref"]
    jx = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    ref = RP.solve_pipeline(
        jx(na), jx(pa), jx(ea), jx(ta), jx(xa), jx(au), ids, jax.random.PRNGKey(4), pb=jx(pb),
        deterministic=det, term_kinds=kinds, n_buckets=n_buckets, track_inbatch=track,
    )
    na, ea, xa, ta, au, pa, ids = out["port"]
    tc = lambda d: arrays_to_torch(d, "cpu")  # noqa: E731
    port = PP.solve_pipeline(
        tc(na), tc(pa), ids, prng_key_data(4), pb=tc(pb), deterministic=det, term_kinds=kinds,
        track_inbatch=track, ea=tc(ea), ta=tc(ta), au=tc(au), xa=tc(xa), n_buckets=n_buckets,
    )
    assert np.array_equal(np.asarray(ref[1]), port[1].numpy())  # score
    assert np.array_equal(np.asarray(ref[0]), port[0].numpy())  # assignment
    assert (np.asarray(ref[0]) >= 0).sum() > 30


def _drain(pkg, workload, det, seed):
    t = RT if pkg == "ref" else PT
    if workload == "random":
        nodes, existing, pending = random_cluster(seed, 64, 600, 80, t=t, pins=True)
    else:
        (nodes, pending), existing = bench_config2(64, 700, t=t), []
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, nodes, existing)
    queue = (RQueue if pkg == "ref" else PriorityQueue)()
    for p in pending:
        queue.add(p)
    if pkg == "ref":
        sched = RScheduler(
            cache, queue, batch_size=128, deterministic=det, seed=seed, commit_plane=False,
            fold_plane=False, ingest_plane=False, term_plane=False, speculate=False,
            enable_preemption=False,
        )
    else:
        sched = Scheduler(cache, queue, batch_size=128, deterministic=det, seed=seed, device="cpu",
                          enable_preemption=False)
    res = sched.run_until_empty()
    sched.wait_for_binds()
    sched.close()
    return res


@pytest.mark.parametrize("workload", ["random", "config2"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_scheduler_drain_matches_reference_pod_for_pod(workload, det):
    ref = _drain("ref", workload, det, seed=3)
    port = _drain("port", workload, det, seed=3)
    assert port.scheduled == ref.scheduled and port.unschedulable == ref.unschedulable
    assert port.assignments == ref.assignments
    assert ref.scheduled > 150


def _topology_drain(pkg, workload, services, det, seed):
    t = RT if pkg == "ref" else PT
    fn = None
    if workload == "config3":
        # config 3's shape: 64 nodes in 8 zones, 100 apps, one ScheduleAnyway
        # zone constraint per pod
        nodes, pending, fn = bench_config3(64, 600, t=t, services=services)
        existing = []
    else:
        nodes, existing, pending = random_cluster(seed, 80, 500, 120, t=t, pins=True, topology=True)
        if services:
            fn = random_selectors(t)
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, nodes, existing)
    queue = (RQueue if pkg == "ref" else PriorityQueue)()
    for p in pending:
        queue.add(p)
    if pkg == "ref":
        sched = RScheduler(
            cache, queue, batch_size=128, deterministic=det, seed=seed, commit_plane=False,
            fold_plane=False, ingest_plane=False, term_plane=False, speculate=False,
            enable_preemption=False,
        )
    else:
        sched = Scheduler(cache, queue, batch_size=128, deterministic=det, seed=seed, device="cpu",
                          enable_preemption=False)
    if fn is not None:
        sched.set_spread_selectors_fn(fn)
    res = sched.run_until_empty()
    sched.wait_for_binds()
    sched.close()
    return res, sched


@pytest.mark.parametrize("workload", ["config3", "random"])
@pytest.mark.parametrize("services", [False, True], ids=["spread", "spread+selectors"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_topology_drain_matches_reference_pod_for_pod(workload, services, det):
    ref, _ = _topology_drain("ref", workload, services, det, seed=5)
    port, sched = _topology_drain("port", workload, services, det, seed=5)
    assert port.scheduled == ref.scheduled and port.unschedulable == ref.unschedulable
    assert port.assignments == ref.assignments
    assert ref.scheduled > (500 if workload == "config3" else 150)
    assert "spread_soft" in sched._term_kinds
    assert ("sel_spread" in sched._term_kinds) == services


def _cluster_with(pending_fn, existing_fn=None, t=PT, pkg="port", ref_planes=False, **port_kw):
    nodes, pending = bench_config2(8, 6, t=t)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"z{i % 2}"
    cache, queue = (SchedulerCache(), PriorityQueue()) if pkg == "port" else (RCache(), RQueue())
    fill_cache(cache, nodes, [existing_fn(nodes, t)] if existing_fn else [])
    pending_fn(pending, t)
    for p in pending:
        queue.add(p)
    if pkg == "port":
        return Scheduler(cache, queue, device="cpu", enable_preemption=False, **port_kw), queue
    return RScheduler(cache, queue, commit_plane=ref_planes, fold_plane=ref_planes, ingest_plane=False,
                      term_plane=False, speculate=False, columnar_cache=False, enable_preemption=False), queue


def _anti(p, t=PT, labels=None):
    sel = t.LabelSelector(match_labels=labels or {"app": "x"})
    p.affinity.pod_anti_affinity = t.PodAntiAffinity(
        required=[t.PodAffinityTerm(label_selector=sel, topology_key="kubernetes.io/hostname")])


def _edit_pending(case, pods, t):
    if case == "anti":
        # against its own app: the batch's other svc-2 pods (none here) and any later ones
        _anti(pods[2], t, {"app": pods[2].labels["app"]})
    elif case == "spread":
        pods[1].topology_spread_constraints = [t.TopologySpreadConstraint(
            max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule",
            label_selector=t.LabelSelector(match_labels={"app": pods[1].labels["app"]}))]
    elif case == "preferred-affinity":
        pods[4].affinity.pod_affinity = t.PodAffinity(preferred=[t.WeightedPodAffinityTerm(
            weight=5, pod_affinity_term=t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": "x"}), topology_key="zone"))])
    elif case == "term-overflow":
        # five matchLabels pairs: one more than a term row holds
        pods[5].topology_spread_constraints = [t.TopologySpreadConstraint(
            max_skew=1, topology_key="zone", when_unsatisfiable="ScheduleAnyway",
            label_selector=t.LabelSelector(match_labels={f"k{i}": "v" for i in range(5)}))]
    elif case == "ports":
        pods[0].containers[0].ports = [t.ContainerPort(host_port=80)]
        pods[3].containers[0].ports = [t.ContainerPort(host_port=80)]
    elif case == "overflow":
        pods[3].tolerations = [t.Toleration(key=f"k{i}", operator="Exists") for i in range(9)]
    elif case == "required-affinity":
        pods[2].affinity.pod_affinity = t.PodAffinity(required=[t.PodAffinityTerm(
            label_selector=t.LabelSelector(match_labels={"app": "svc-1"}), topology_key=HOST_KEY)])


def _existing_with(case):
    def existing_fn(nodes, t):
        p = t.Pod(name="bound", namespace="bench", node_name=nodes[0].name, labels={"app": "svc-0"},
                  affinity=t.Affinity())
        if case == "pattern-overflow":
            # five matchLabels pairs: the pattern row truncates the selector
            _anti(p, t, {f"k{i}": "v" for i in range(5)})
        else:
            _anti(p, t, {"app": "svc-1"})
        return p
    return existing_fn if case in ("existing-affinity", "pattern-overflow") else None


ORACLE_COUNTERS = ("oracle_rechecks", "light_rechecks", "oracle_places", "arbiter_batches", "arbiter_place",
                   "arbiter_defer", "arbiter_escalated")


def _counters(stats):
    return {k: stats.get(k, 0) for k in ORACLE_COUNTERS}


@pytest.mark.parametrize("case", ["spread", "overflow", "term-overflow", "required-affinity",
                                  "pattern-overflow"])
def test_unported_paths_raise_and_keep_the_batch(case):
    """The paths the port refused before it had the host oracle now drain
    pod for pod as the reference's planes-on driver (the planes-off one for
    DoNotSchedule spread with the commit plane off): a pod whose
    tolerations or spread selector overflow the encoding, required pod
    affinity to pods of the same batch, an existing pod whose anti-affinity
    selector overflows its pattern row. Their batches take the per-pod
    loop, whose full host re-check and re-placement the counters show."""
    planes = case != "spread"
    results = []
    for pkg, t in (("ref", RT), ("port", PT)):
        sched, queue = _cluster_with(lambda pods, t: _edit_pending(case, pods, t), _existing_with(case), t=t,
                                     pkg=pkg, ref_planes=planes, **({"commit_plane": planes} if pkg == "port" else {}))
        res = sched.run_until_empty()
        sched.wait_for_binds()
        sched.close()
        results.append((res, _counters(sched.stats)))
    (ref, rc), (port, pc) = results
    assert port.assignments == ref.assignments and port.scheduled == ref.scheduled == 6
    assert pc == rc and pc["oracle_rechecks"] + pc["oracle_places"] > 0
    if case == "required-affinity":  # its anchor commits earlier in the batch: the -1 is re-placed there
        assert pc["oracle_places"] > 0
        assert port.assignments["bench/pod-2"] == port.assignments["bench/pod-1"]


def test_gang_refuses_and_keeps_the_batch():
    """A pod of a PodGroup, once refused, now takes the gang solve and the
    per-pod loop: the batch schedules placement for placement as the
    reference's default commit path, and the queue ends empty on both."""
    def edit(pods, t):
        pods[2].labels["pod-group.scheduling.sigs.k8s.io/name"] = "g"

    results = []
    for pkg, t in (("ref", RT), ("port", PT)):
        sched, queue = _cluster_with(edit, t=t, pkg=pkg, ref_planes=True)
        res = sched.run_until_empty()
        sched.wait_for_binds()
        sched.close()
        results.append((res.scheduled, res.unschedulable, res.assignments, queue.counts(), sched.stats["batches"]))
    ref, port = results
    assert port == ref and port[0] == 6 and port[3] == (0, 0, 0)


@pytest.mark.parametrize("case", ["anti", "ports", "existing-affinity", "preferred-affinity", "spread"])
def test_formerly_unported_paths_schedule_like_the_reference(case):
    """The clusters the port refused before it ran inter-pod affinity and
    host ports now schedule, placement for placement as the reference."""
    results = []
    for pkg, t in (("ref", RT), ("port", PT)):
        sched, queue = _cluster_with(lambda pods, t: _edit_pending(case, pods, t), _existing_with(case),
                                     t=t, pkg=pkg)
        res = sched.run_until_empty()
        sched.wait_for_binds()
        sched.close()
        results.append(res)
    ref, port = results
    assert port.scheduled == ref.scheduled == 6 and port.assignments == ref.assignments
    if case == "existing-affinity":  # svc-1 pods stay off the bound pod's node
        assert all(port.assignments[f"bench/pod-{i}"] != "node-0" for i in (1,))
    if case == "ports":  # the two port-80 pods never share a node
        assert port.assignments["bench/pod-0"] != port.assignments["bench/pod-3"]


def test_failed_bind_forgets_and_backs_off():
    def bind(pod, node):
        if pod.name == "pod-1":
            raise RuntimeError("apiserver said no")

    nodes, pending = bench_config2(8, 6)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes)
    for p in pending:
        queue.add(p)
    sched = Scheduler(cache, queue, binder=Binder(bind), device="cpu")
    res = sched.schedule_batch()
    sched.wait_for_binds()
    assert res.scheduled == 6
    assert cache.pod_count() == 5 and not cache.is_assumed("bench/pod-1")
    assert queue.counts() == (0, 1, 0)
    sched.close()


def _interpod_drain(pkg, workload, det, seed):
    t = RT if pkg == "ref" else PT
    if workload == "config4":
        # config 4's shape: 64 nodes in 8 zones, 20 apps; every 10th pod with
        # a required hostname anti-affinity on its `exclusive` label, the
        # rest with a preferred zone affinity to their app
        (nodes, pending), existing = bench_config4(64, 640, t=t), []
    else:
        nodes, existing, pending = random_cluster(seed, 90, 400, 90, t=t, pins=True, topology=True,
                                                  interpod=True, pending_affinity=False)
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, nodes, existing)
    queue = (RQueue if pkg == "ref" else PriorityQueue)()
    for p in pending:
        queue.add(p)
    if pkg == "ref":
        sched = RScheduler(
            cache, queue, batch_size=128, deterministic=det, seed=seed, commit_plane=False,
            fold_plane=False, ingest_plane=False, term_plane=False, speculate=False,
            enable_preemption=False,
        )
    else:
        sched = Scheduler(cache, queue, batch_size=128, deterministic=det, seed=seed, device="cpu",
                          enable_preemption=False)
    res = sched.run_until_empty()
    sched.wait_for_binds()
    sched.close()
    return res, sched


@pytest.mark.parametrize("workload", ["config4", "random"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_interpod_drain_matches_reference_pod_for_pod(workload, det):
    ref, _ = _interpod_drain("ref", workload, det, seed=6)
    port, sched = _interpod_drain("port", workload, det, seed=6)
    assert port.scheduled == ref.scheduled and port.unschedulable == ref.unschedulable
    assert port.assignments == ref.assignments
    assert sched.stats["tracked_batches"] > 0
    if workload == "config4":
        assert sched.stats["tracked_batches"] == sched.stats["batches"]
        assert ref.scheduled == 640
        # later batches see the committed pods' terms through the PatternBank
        assert {"anti_req", "pref", "et_anti", "et_score"} <= sched._term_kinds
        exclusive = {}
        for key, node in port.assignments.items():
            i = int(key.split("-")[-1])
            if i % 10 == 0:
                exclusive.setdefault((f"svc-{i % 20}", node), []).append(key)
        assert all(len(v) == 1 for v in exclusive.values())
    else:
        assert ref.scheduled > 150 and ref.unschedulable > 0
        assert {"anti_req", "pref", "et_anti", "et_score"} <= sched._term_kinds


# --- the commit and fold planes against the reference's planes-on driver ---

PLANES_ON_WORKLOADS = {
    "config2": (64, 700, 128), "config3": (64, 600, 128), "config4": (64, 640, 128),
    "config3-hard": (100, 1000, 128),
}


def _planes_drain(pkg, workload, planes=True):
    t = RT if pkg == "ref" else PT
    n_nodes, n_pods, batch = PLANES_ON_WORKLOADS[workload]
    if workload == "config2":
        nodes, pending = bench_config2(n_nodes, n_pods, t=t)
    elif workload == "config4":
        nodes, pending = bench_config4(n_nodes, n_pods, t=t)
    else:
        nodes, pending, _ = bench_config3(n_nodes, n_pods, t=t, hard=workload == "config3-hard")
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, nodes)
    queue = (RQueue if pkg == "ref" else PriorityQueue)()
    for p in pending:
        queue.add(p)
    if pkg == "ref":
        sched = RScheduler(
            cache, queue, batch_size=batch, deterministic=True, commit_plane=True, fold_plane=True,
            ingest_plane=False, term_plane=False, columnar_cache=False, speculate=False, enable_preemption=False,
        )
    else:
        sched = Scheduler(cache, queue, batch_size=batch, deterministic=True, device="cpu", commit_plane=planes,
                          enable_preemption=False)
    res = sched.run_until_empty()
    sched.wait_for_binds()
    sched.close()
    return res, sched, nodes, pending


@pytest.mark.parametrize("workload", ["config2", "config3", "config4"])
def test_planes_on_drain_matches_planes_off_and_reference(workload):
    ref, rsched, _, _ = _planes_drain("ref", workload)
    on, sched, _, pending = _planes_drain("port", workload)
    off, osched, _, _ = _planes_drain("port", workload, planes=False)
    assert on.assignments == off.assignments == ref.assignments
    assert on.scheduled == off.scheduled == ref.scheduled == len(pending)
    st = sched.stats
    assert st["fold_batches"] == st["batches"] and st["fold_pods"] == len(pending)
    assert osched.stats["fold_batches"] == 0 and osched.stats["arbiter_batches"] == 0
    # configs 2 and 3 take the bulk path; config 4's batches carry required
    # anti-affinity, which the arbiter re-checks as the reference's does
    # (the tracked solve leaves it nothing to defer)
    assert _counters(st) == _counters(rsched.stats) and st["arbiter_defer"] == 0
    if workload == "config4":
        assert st["arbiter_batches"] == st["batches"] == st["tracked_batches"]
        assert st["arbiter_place"] == len(pending)
    else:
        assert st["arbiter_batches"] == 0
    assert sched.mirror.rows_shipped == 0


def test_config3_hard_drain_matches_reference():
    """Config 3 with every constraint DoNotSchedule at 100 nodes / 1,000
    pods / batch 128: the arbiter defers the pods an earlier commit of the
    batch pushed over max_skew; they retry next batch. Same placements and
    the same defers as the reference, no escalation, and no app's zone
    counts differ by more than max_skew."""
    ref, rsched, _, _ = _planes_drain("ref", "config3-hard")
    port, sched, nodes, pending = _planes_drain("port", "config3-hard")
    assert port.assignments == ref.assignments and port.scheduled == ref.scheduled == len(pending)
    st = sched.stats
    assert st["arbiter_defer"] == rsched.stats["arbiter_defer"] and st["arbiter_defer"] > 0
    assert st["arbiter_escalated"] == 0 and "arbiter_escalated" not in rsched.stats
    assert st["arbiter_batches"] == st["batches"] == rsched.stats["batches"]
    assert port.deferred == st["arbiter_defer"]
    zone_of = {n.name: n.labels[ZONE_KEY] for n in nodes}
    per = {}
    for p in pending:
        z = per.setdefault(p.labels["app"], {zone: 0 for zone in set(zone_of.values())})
        z[zone_of[port.assignments[p.key()]]] += 1
    assert max(max(z.values()) - min(z.values()) for z in per.values()) <= 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixed_hard_spread_drain_matches_reference(seed):
    """Random clusters whose batches mix DoNotSchedule spread, required
    anti-affinity, host ports, preferred affinity and plain pods, drained
    in batches of 32: every batch is arbitrated, and the placements and
    defers equal the reference's planes-on driver."""
    drained = {}
    for pkg in ("ref", "port"):
        t = RT if pkg == "ref" else PT
        nodes, existing, pending = random_cluster(seed, 40, 120, 60, t=t, pins=False, topology=True,
                                                  hard_spread=True, interpod=True, pending_affinity=False,
                                                  pending_ports=True)
        cache = (RCache if pkg == "ref" else SchedulerCache)()
        fill_cache(cache, nodes, existing)
        queue = (RQueue if pkg == "ref" else PriorityQueue)()
        for p in pending:
            queue.add(p)
        if pkg == "ref":
            sched = RScheduler(cache, queue, batch_size=32, deterministic=True, commit_plane=True, fold_plane=True,
                               ingest_plane=False, term_plane=False, columnar_cache=False, speculate=False,
                               enable_preemption=False)
        else:
            sched = Scheduler(cache, queue, batch_size=32, deterministic=True, device="cpu", enable_preemption=False)
        res = sched.run_until_empty()
        sched.wait_for_binds()
        sched.close()
        drained[pkg] = (res, sched.stats)
    (ref, rst), (port, st) = drained["ref"], drained["port"]
    assert port.assignments == ref.assignments and port.scheduled == ref.scheduled > 0
    assert st["arbiter_defer"] == rst["arbiter_defer"] > 0 and st["arbiter_escalated"] == 0
    assert st["arbiter_batches"] == st["batches"] == rst["arbiter_batches"]
    assert st["tracked_batches"] == st["batches"]


def test_defer_escalation_refuses_and_keeps_every_pod():
    """A pod the arbiter defers three batches in a row escalates to the host
    oracle's re-placement (`_oracle_place`): on the commit-plane mix at
    batch 16 (perf_smoke's tiny config) the drain equals the reference's
    planes-on, preemption-on driver — placements, nominations after every
    batch, the arbiter's and the oracle's counters — and every pod lands."""
    ra, rv, rn, rp, rst, _ = _preemption_drain("ref", "mix", batch=16)
    pa, pv, pn, pp, st, sched = _preemption_drain("port", "mix", batch=16)
    assert (pa, pv, pn, pp) == (ra, rv, rn, rp)
    assert _counters(st) == _counters(rst)
    assert st["arbiter_escalated"] > 0 and st["arbiter_defer"] > 0 and st["oracle_places"] == st["arbiter_escalated"]
    assert len(pa) == 96 and sched.cache.pod_count() == 96 and sum(sched.queue.counts()) == 0


# --- preemption against the reference's default (preemption-on) driver ---

class _Clock:
    """One stepped fake clock for a queue: the backoff then waits on the
    drain loop, not on wall time, so both packages see the same queue."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _preemption_workload(workload, t):
    """(nodes, bound pods, pending pods, PDBs) of a preemption-on drain:
    config 6 at 1/10; `random<seed>` / `ports<seed>` random preemption
    clusters without / with host ports; `terms<seed>` a random cluster
    mixing DoNotSchedule spread, required pod (anti-)affinity, preferred
    terms and host ports; `mix` / `perf-mix` the commit-plane mix (perf_smoke's
    tiny config, and 64 nodes / 800 pods)."""
    name = workload.rstrip("0123456789")
    seed = int(workload[len(name):] or 0)
    if workload == "config6":
        nodes, existing, pending = bench_config6(50, 200, t=t)
        return nodes, existing, pending, []
    if name in ("random", "ports"):
        return random_preemption_cluster(seed, t=t, ports=name == "ports")
    if name == "terms":
        nodes, existing, pending = random_cluster(seed, 40, 100, 60, t=t, pins=False, topology=True,
                                                  hard_spread=True, interpod=True, pending_ports=True)
        return nodes, existing, pending, []
    if name == "anchors":
        return _anchors_cluster(t)
    if name in ("overflow", "fallback"):
        # fallback: nodes whose taints overflow the encoding beside pods
        # pinned or selected onto no node (-1 pods while node rows fall
        # back); overflow: pods whose tolerations or spread selectors and an
        # existing pod whose anti-affinity selector overflow the encoding
        nodes, existing, pending = random_cluster(seed, 40, 90, 60, t=t, overflow_nodes=4 if name == "fallback" else 0,
                                                  pins=True, topology=name == "overflow")
        if name == "overflow":
            for i, p in enumerate(pending):
                if i % 7 == 0:
                    p.tolerations = [t.Toleration(key=f"k{j}", operator="Exists") for j in range(9)]
                elif i % 11 == 0:
                    p.topology_spread_constraints = [t.TopologySpreadConstraint(
                        max_skew=1, topology_key=ZONE_KEY, when_unsatisfiable="ScheduleAnyway",
                        label_selector=t.LabelSelector(match_labels={f"k{j}": "v" for j in range(5)}))]
            existing[0].affinity = t.Affinity()
            _anti(existing[0], t, {f"k{j}": "v" for j in range(5)})
        return nodes, existing, pending, []
    nodes, pending = commit_plane_mix(8, 96, t=t) if workload == "mix" else commit_plane_mix(64, 800, t=t)
    return nodes, [], pending, []


def _anchors_cluster(t):
    """Required pod affinity to anchors of the same batch: 8 nodes over 4
    zones; pod i % 4 == 0 is an anchor `app=db-<i % 3>`, the others
    `app=web-<i % 3>` requiring a `db-<i % 3>` pod in their zone. In the
    first batch the followers' masks see no anchor (a -1); an anchor
    committed earlier in the batch makes the host oracle re-place them."""
    nodes, _ = commit_plane_mix(8, 0, t=t)
    pods = []
    for i in range(64):
        app = f"db-{i % 3}" if i % 4 == 0 else f"web-{i % 3}"
        p = t.Pod(name=f"pod-{i}", namespace="bench", labels={"app": app},
                  containers=[t.Container(name="c", requests={t.RESOURCE_CPU: t.Quantity.parse("100m")})])
        if i % 4:
            p.affinity = t.Affinity(pod_affinity=t.PodAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": f"db-{i % 3}"}), topology_key=ZONE_KEY)]))
        pods.append(p)
    return nodes, [], pods, []


def _preemption_drain(pkg, workload, planes=True, batch=64):
    """Drain a preemption workload to the end: after every batch the binds
    are awaited (so both caches agree on which pods are assumed); when a
    batch does nothing while pods wait out their backoff, the clock steps
    1 s and the unschedulable pods move back, as bench.py's drain does.
    Returns (assignments, victim keys in delete order, the nominated index
    after each batch, preempted count, stats, scheduler)."""
    t = RT if pkg == "ref" else PT
    nodes, existing, pending, pdbs = _preemption_workload(workload, t)
    clock = _Clock()
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, nodes, existing)
    queue = (RQueue if pkg == "ref" else PriorityQueue)(now=clock)
    for p in pending:
        queue.add(p)
    deleted = []

    def delete(v):
        deleted.append(v.key())
        cache.remove_pod(v)

    kw = dict(batch_size=batch, deterministic=True, pdb_lister=lambda: pdbs, delete_fn=delete)
    if pkg == "ref":
        sched = RScheduler(cache, queue, enable_preemption=True, commit_plane=planes, fold_plane=planes,
                           speculate=False, ingest_plane=False, term_plane=False, columnar_cache=False, **kw)
    else:
        sched = Scheduler(cache, queue, device="cpu", commit_plane=planes, **kw)
    assignments, nominations = {}, []
    preempted = idle = 0
    for _ in range(120):
        r = sched.schedule_batch()
        sched.wait_for_binds()
        assignments.update(r.assignments)
        preempted += r.preempted
        nominations.append(dict(queue.nominated))
        if r.scheduled or r.unschedulable or r.deferred:
            idle = 0
            continue
        if sum(queue.counts()) == 0 or idle >= 12:
            break
        idle += 1
        clock.t += 1.0
        queue.move_all_to_active()
    sched.close()
    return assignments, deleted, nominations, preempted, sched.stats, sched


@pytest.mark.parametrize("planes", [True, False], ids=["planes-on", "planes-off"])
@pytest.mark.parametrize("workload", ["config6", "random0", "random1", "random2"])
def test_preemption_drain_matches_reference(workload, planes):
    """Config 6 at 1/10 (50 full nodes, 350 bound pods, 200 preemptors,
    batches of 64) and random preemption clusters (mixed priorities, PDBs,
    an extended resource; batches of 16), against the reference Scheduler
    with preemption on: the same placements, the same victims in the same
    order, the same nominations after every batch and the same preempted
    count, with the commit plane on and off. Every device plan passes the
    host re-verification; later batches fold the outstanding nominations
    onto the bank; the folded bank ends equal to a fresh encode with no
    overlay left on it."""
    batch = 64 if workload == "config6" else 16
    ra, rv, rn, rp, _, _ = _preemption_drain("ref", workload, planes, batch)
    pa, pv, pn, pp, st, sched = _preemption_drain("port", workload, planes, batch)
    assert pa == ra and pv == rv and pp == rp
    assert pn == rn
    assert st["preempt_reverify_miss"] == 0 and st["preempted"] == pp > 0
    assert st["victims"] == len(pv) and st["nominee_folds"] > 0
    if workload == "config6":
        assert len(pa) == 200 and pp == 200 and not sched.queue.has_nominations()
    m = sched.mirror
    assert m._nominee_overlay is None
    m.sync()
    dev, _, _ = m.device_arrays()
    fresh, _, rows = p_encode(sched.cache.snapshot, vocab=m.vocab, with_images=False)
    assert rows == m.row_of
    for k in ("requested", "nonzero_req", "pod_count"):
        assert np.array_equal(dev[k].numpy(), fresh.arrays()[k]), k


@pytest.mark.parametrize("case", ["victim-search", "nominee-recheck"])
def test_preemption_oracle_fallback_refuses_and_keeps_the_batch(case):
    """victim-search: a preemptor with a required anti-affinity term that
    fits nowhere, on nodes holding lower-priority pods, takes the slow
    victim search (the full predicate chain per candidate node).
    nominee-recheck: while a nomination is outstanding, a batch holding a
    pod that is not resource-only takes the per-pod loop, whose host
    oracle re-checks picks on nominated nodes. Both drain as the
    reference: the same placements, victims in order and nominations."""
    out = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, existing, pending = bench_config6(4, 6, t=t)
        cache, clock = (RCache() if pkg == "ref" else SchedulerCache()), _Clock()
        queue = (RQueue if pkg == "ref" else PriorityQueue)(now=clock)
        fill_cache(cache, nodes, existing)
        deleted = []

        def delete(v, cache=cache, deleted=deleted):
            deleted.append(v.key())
            cache.remove_pod(v)

        kw = dict(batch_size=8, deterministic=True, delete_fn=delete)
        if pkg == "ref":
            sched = RScheduler(cache, queue, enable_preemption=True, commit_plane=True, fold_plane=True,
                               speculate=False, ingest_plane=False, term_plane=False, columnar_cache=False, **kw)
        else:
            sched = Scheduler(cache, queue, device="cpu", **kw)
        pending[0].affinity = t.Affinity()
        _anti(pending[0], t, {"app": "zz"})
        if case == "nominee-recheck":
            pending[1].nominated_node_name = nodes[0].name
            queue.add(pending[1])
        queue.add(pending[0])
        assignments, nominations = {}, []
        for _ in range(6):
            r = sched.schedule_batch()
            sched.wait_for_binds()
            assignments.update(r.assignments)
            nominations.append(dict(queue.nominated))
            clock.t += 1.0
            queue.move_all_to_active()
        sched.close()
        out[pkg] = (assignments, deleted, nominations, _counters(sched.stats), sched.stats.get("victims"))
    assert out["port"][:4] == out["ref"][:4]
    assignments, deleted, _, counters, victims = out["port"]
    assert deleted and len(assignments) == (2 if case == "nominee-recheck" else 1)
    assert victims == len(deleted)
    if case == "nominee-recheck":
        assert counters["oracle_rechecks"] > 0


@pytest.mark.parametrize("workload,batch", [("mix", 32), ("perf-mix", 256), ("ports20", 16), ("ports21", 8),
                                            ("ports22", 32), ("terms24", 32), ("terms25", 16), ("anchors", 32),
                                            ("overflow26", 32), ("fallback27", 32)])
def test_oracle_drain_matches_reference(workload, batch):
    """The workloads the port refused before its host oracle, on seeds the
    other drains do not use, against the reference's default driver
    (commit and fold planes on, preemption on): the commit-plane mix at
    batch 32 and at 64 nodes / 800 pods (defers escalating to the host
    oracle), random preemption clusters with host ports (the nominee
    re-check), random clusters mixing DoNotSchedule spread, required pod
    (anti-)affinity and host ports (the slow victim search), required pod
    affinity to anchors of the same batch, pods and an existing pod whose
    structures overflow the encoding, and -1 pods beside node rows that fell
    back out of the device path (the per-pod loop's oracle). The same
    placements, victims in delete order, nominations after every batch,
    preempted count and oracle / arbiter counters; the folded banks end
    equal to a fresh encode."""
    ra, rv, rn, rp, rst, _ = _preemption_drain("ref", workload, batch=batch)
    pa, pv, pn, pp, st, sched = _preemption_drain("port", workload, batch=batch)
    assert (pa, pv, pn, pp) == (ra, rv, rn, rp)
    assert _counters(st) == _counters(rst)
    assert st["oracle_places"] + st["oracle_rechecks"] > 0 and len(pa) > 0
    if workload.startswith("ports") or workload.startswith("terms"):
        assert pp > 0 and pv
    if workload == "anchors":
        assert len(pa) == 64 and st["oracle_places"] > 0
    m = sched.mirror
    m.sync()
    dev, _, _ = m.device_arrays()
    fresh, _, rows = p_encode(sched.cache.snapshot, vocab=m.vocab, with_images=False)
    assert rows == m.row_of
    for k in ("requested", "nonzero_req", "pod_count"):
        assert np.array_equal(dev[k].numpy(), fresh.arrays()[k]), k


def test_late_nomination_takes_the_per_pod_loop_like_the_reference(monkeypatch):
    """A nomination that appears after a batch's solve (an informer event
    landing mid-batch) invalidates the solve's nominee fold: the batch takes
    the per-pod loop, whose host oracle re-checks every pick on the
    nominated node with the nominee counted and re-places the ones that no
    longer fit — pod for pod as the reference, with the same counters."""
    import kubernetes_tpu.ops.pipeline as RPipe
    from kubernetes_tpu_torch.scheduler import driver as D

    out = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, pending = bench_config2(8, 40, t=t)
        for p in pending:  # all on the untainted "large" nodes, big enough to crowd one
            p.tolerations = []
            p.containers[0].requests[t.RESOURCE_CPU] = t.Quantity.parse("3")
        nominee = t.Pod(name="nominee", namespace="bench", nominated_node_name="node-1", priority=10,
                        containers=[t.Container(name="c", requests={t.RESOURCE_CPU: t.Quantity.parse("30")})])
        cache = (RCache if pkg == "ref" else SchedulerCache)()
        queue = (RQueue if pkg == "ref" else PriorityQueue)()
        fill_cache(cache, nodes)
        for p in pending:
            queue.add(p)
        mod, real = (RPipe, RPipe.solve_pipeline) if pkg == "ref" else (D, D.solve_pipeline)

        def solve(*args, _real=real, _queue=queue, _nominee=nominee, **kw):
            result = _real(*args, **kw)
            if _nominee.key() not in _queue.nominated:
                _queue.add(_nominee)
            return result

        monkeypatch.setattr(mod, "solve_pipeline", solve)
        if pkg == "ref":
            sched = RScheduler(cache, queue, batch_size=40, deterministic=True, commit_plane=True, fold_plane=True,
                               speculate=False, ingest_plane=False, term_plane=False, columnar_cache=False)
        else:
            sched = Scheduler(cache, queue, batch_size=40, deterministic=True, device="cpu")
        first = sched.schedule_batch()
        sched.wait_for_binds()
        rest = sched.run_until_empty()
        sched.wait_for_binds()
        sched.close()
        out[pkg] = (first.assignments, rest.assignments, _counters(sched.stats))
    assert out["port"] == out["ref"]
    first, rest, counters = out["port"]
    assert counters["oracle_rechecks"] > 0 and counters["arbiter_batches"] == 0
    # the picks the solve made on node-1 were re-checked with the nominee
    # counted and re-placed: node-1 is left to the nominee
    assert "node-1" not in first.values() and rest.get("bench/nominee") == "node-1"
