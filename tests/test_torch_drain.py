"""The slices end to end on the CPU: the port's solve_pipeline against the
reference's with no term kinds and with the score-only topology kinds
(ScheduleAnyway spread, SelectorSpread, both), and the port's
Scheduler(device="cpu") against the reference Scheduler with every plane
off, on seeded taint + node-affinity + resources drains and on
config-3-shaped topology-spread drains with and without spreading
selectors — pod-for-pod identical placements, deterministic and with
tie-noise. Tolerance: exact equality. Also: what the slices do not cover
raises NotImplementedError and leaves the batch in the queue."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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

from kubernetes_tpu_torch.models.clusters import (
    bench_config2,
    bench_config3,
    fill_cache,
    random_cluster,
    random_selectors,
)
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
    with pytest.raises(NotImplementedError, match="slice 3"):
        PP.mask_and_score({}, {}, {}, term_kinds=frozenset({"anti_req"}))
    with pytest.raises(NotImplementedError, match="arbiter"):
        PP.mask_and_score({}, {}, {}, term_kinds=frozenset({"spread_soft", "spread_hard"}))
    with pytest.raises(NotImplementedError, match="slice 3"):
        PP.solve_pipeline({}, {}, {}, (0, 0), term_kinds=None)
    with pytest.raises(NotImplementedError, match="in-batch"):
        PP.solve_pipeline({}, {}, {}, (0, 0), track_inbatch=True)


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
        sched = Scheduler(cache, queue, batch_size=128, deterministic=det, seed=seed, device="cpu")
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
        sched = Scheduler(cache, queue, batch_size=128, deterministic=det, seed=seed, device="cpu")
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


def _cluster_with(pending_fn, existing_fn=None):
    nodes, pending = bench_config2(8, 6)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes, [existing_fn(nodes)] if existing_fn else [])
    pending_fn(pending)
    for p in pending:
        queue.add(p)
    return Scheduler(cache, queue, device="cpu"), queue


def _anti(p):
    sel = PT.LabelSelector(match_labels={"app": "x"})
    p.affinity.pod_anti_affinity = PT.PodAntiAffinity(
        required=[PT.PodAffinityTerm(label_selector=sel, topology_key="kubernetes.io/hostname")])


@pytest.mark.parametrize("case", ["anti", "spread", "ports", "existing-affinity", "overflow",
                                  "preferred-affinity", "term-overflow"])
def test_unported_paths_raise_and_keep_the_batch(case):
    def pending_fn(pods):
        if case == "anti":
            _anti(pods[2])
        elif case == "spread":
            pods[1].topology_spread_constraints = [PT.TopologySpreadConstraint(
                max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule")]
        elif case == "preferred-affinity":
            pods[4].affinity.pod_affinity = PT.PodAffinity(preferred=[PT.WeightedPodAffinityTerm(
                weight=5, pod_affinity_term=PT.PodAffinityTerm(
                    label_selector=PT.LabelSelector(match_labels={"app": "x"}), topology_key="zone"))])
        elif case == "term-overflow":
            # five matchLabels pairs: one more than a term row holds
            pods[5].topology_spread_constraints = [PT.TopologySpreadConstraint(
                max_skew=1, topology_key="zone", when_unsatisfiable="ScheduleAnyway",
                label_selector=PT.LabelSelector(match_labels={f"k{i}": "v" for i in range(5)}))]
        elif case == "ports":
            pods[0].containers[0].ports = [PT.ContainerPort(host_port=80)]
        elif case == "overflow":
            pods[3].tolerations = [PT.Toleration(key=f"k{i}", operator="Exists") for i in range(9)]

    def existing_fn(nodes):
        p = PT.Pod(name="bound", namespace="bench", node_name=nodes[0].name, affinity=PT.Affinity())
        _anti(p)
        return p

    sched, queue = _cluster_with(pending_fn, existing_fn if case == "existing-affinity" else None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sched.schedule_batch()
    assert queue.counts() == (6, 0, 0)
    sched.close()


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
