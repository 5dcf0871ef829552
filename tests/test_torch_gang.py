"""Gang (all-or-nothing) scheduling of the port against the reference, on
the CPU: `prng_split` against jax.random.split, the plain two-pass
`solve_gang` and `solve_pipeline_gang` against the reference's jitted
ones on seeded inputs where some groups drop and some do not,
`pop_all_in_groups` against the reference queue, the batch-conflict
index's rollback tombstones, and drains of the port's
Scheduler(device="cpu") against the reference's default commit path
(commit and fold planes on, preemption on; no speculation, ingest or term
plane, columnar cache): the scenarios of tests/test_gang.py except the
speculation one, random tight gang clusters (dropped groups,
min-available, anti-affine members rolled back on the host, ungrouped
pods) and bench.py config 5 at 1/20, deterministic and with tie-noise.
Tolerance: exact equality — the same assignments, unschedulable counts,
queue depths and oracle counters, and no assumed pod left in the cache
beyond the placed ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import pipeline as RP
from kubernetes_tpu.ops import solver as RS
from kubernetes_tpu.oracle.nodeinfo import Snapshot
from kubernetes_tpu.scheduler.driver import Scheduler as RScheduler
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.queue import PriorityQueue as RQueue

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import (
    HOST_KEY,
    bench_config5,
    fill_cache,
    random_cluster,
    random_gang_cluster,
)
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.ops import solver as PS
from kubernetes_tpu_torch.scheduler import driver as D
from kubernetes_tpu_torch.scheduler.driver import POD_GROUP_LABEL, POD_GROUP_MIN_AVAILABLE, Scheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.queue import PriorityQueue


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31, 2**32 + 5, 123456789012 + 4096])
def test_prng_split_matches_jax(seed):
    """Both halves of jax.random.split(PRNGKey(seed)) (x64 on, as the
    reference runs; the last seed stands for seed + cycle past 2^32)."""
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.PRNGKey(seed)))).tolist()
    assert [list(k) for k in PS.prng_split(PS.prng_key_data(seed))] == want


def _gang_inputs(seed, u=12, n=24, b=160, r=3):
    """Seeded solve_gang inputs: a random mask with some empty rows, score
    ties, tight capacity, padding at the tail, groups of 2-10 members on
    scattered positions and ungrouped pods between them."""
    rng = np.random.default_rng(seed)
    mask = rng.random((u, n)) < 0.85
    mask[0] = False  # a spec that fits nowhere: its groups drop in pass 1
    score = rng.integers(0, 4, (u, n)).astype(np.int64)
    req = rng.integers(0, 400, (u, r)).astype(np.int64)
    req[1] = 0  # requests nothing
    free0 = rng.integers(400, 3000, (n, r)).astype(np.int64)
    count0 = rng.integers(0, 3, n).astype(np.int64)
    allowed = rng.integers(4, 10, n).astype(np.int64)
    sig = rng.integers(0, u, b).astype(np.int32)
    valid = np.arange(b) < b - 11
    prio = rng.integers(0, 3, b).astype(np.int32)
    group = np.full(b, -1, np.int32)
    pos = rng.permutation(b - 11)
    g, k = 0, 0
    while k < len(pos) - 20:
        size = int(rng.integers(2, 7))
        group[pos[k:k + size]] = g
        g, k = g + 1, k + size
    group[b - 3] = g  # a padded position in a group of its own: it fails pass 1
    nz0 = rng.integers(0, 100, (n, 2)).astype(np.int64)
    scoring_req = rng.integers(0, 50, (u, 2)).astype(np.int64)
    return dict(mask=mask, score=score, req=req, free0=free0, count0=count0, allowed=allowed, sig=sig,
                valid=valid, prio=prio, group=group, nz0=nz0, scoring_req=scoring_req)


@pytest.mark.parametrize("carry", [False, True], ids=["assign", "carry"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_gang_plain_matches_reference(seed, det, carry):
    x = _gang_inputs(seed)
    b = x["sig"].shape[0]
    order = np.lexsort((np.arange(b), -x["prio"].astype(np.int64), ~x["valid"]))
    j = {k: jnp.asarray(v) for k, v in x.items()}
    ref = RS.solve_gang(
        j["mask"], j["score"], j["req"], j["free0"], j["count0"], j["allowed"], jnp.asarray(order), j["group"],
        jax.random.PRNGKey(seed + 40), deterministic=det, req_any=jnp.asarray((x["req"] > 0).any(-1)),
        sig=j["sig"], pod_valid=j["valid"], return_carry=carry, nz0=j["nz0"] if carry else None,
        scoring_req=j["scoring_req"] if carry else None,
    )
    t = arrays_to_torch(x, "cpu")
    port = PS.solve_gang(
        t["mask"], t["score"], t["req"], t["free0"], t["count0"], t["allowed"], torch.from_numpy(order), t["group"],
        PS.prng_key_data(seed + 40), deterministic=det, req_any=torch.from_numpy((x["req"] > 0).any(-1)),
        sig=t["sig"], pod_valid=t["valid"], return_carry=carry, nz0=t["nz0"] if carry else None,
        scoring_req=t["scoring_req"] if carry else None,
    )
    assert len(port) == len(ref) == (3 if carry else 2)
    assert np.array_equal(np.asarray(ref[0]), port[0].numpy())
    assert np.array_equal(np.asarray(ref[1]), port[1].numpy())
    if carry:
        for a, c in zip(ref[2], port[2]):
            assert np.array_equal(np.asarray(a), c.numpy())
    ok = port[1].numpy()
    grouped = x["group"] >= 0
    assert (~ok & grouped).any() and (ok & grouped & (port[0].numpy() >= 0)).any()  # some drop, some land
    assert ok[~grouped].all()


def test_solve_gang_checks_group_ids():
    x = arrays_to_torch(_gang_inputs(0), "cpu")
    b = x["sig"].shape[0]
    args = (x["mask"], x["score"], x["req"], x["free0"], x["count0"], x["allowed"], torch.arange(b))
    for bad in (b, -2):
        g = x["group"].clone()
        g[5] = bad
        with pytest.raises(IndexError, match="group ids"):
            PS.solve_gang(*args, g, (0, 1), sig=x["sig"], pod_valid=x["valid"])
    with pytest.raises(ValueError, match="shape"):
        PS.solve_gang(*args, x["group"][:-1], (0, 1), sig=x["sig"], pod_valid=x["valid"])


@pytest.mark.parametrize("carry", [False, True], ids=["assign", "carry"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_solve_pipeline_gang_matches_reference(det, carry):
    """Three pods per spec row with padding, pairs on consecutive positions
    and every third pod ungrouped, on a random cluster whose infeasible
    specs drop their groups."""
    nodes, existing, pending = random_cluster(31, 48, 60, 40, t=RT)
    args = RP.encode_solve_args(Snapshot(nodes, existing), pending, key=jax.random.PRNGKey(5))
    na, pa = ({k: np.asarray(v) for k, v in d.items()} for d in args[:2])
    b = 3 * len(pending)
    pb = {"sig": np.arange(b, dtype=np.int32) % len(pending), "valid": np.arange(b) < b - 5,
          "priority": (np.arange(b) % 4).astype(np.int32)}
    group = np.where(np.arange(b) % 3 == 2, -1, np.arange(b) // 3).astype(np.int32)
    group[b - 5:] = -1
    ref = RP.solve_pipeline_gang(*args, jnp.asarray(group), pb={k: jnp.asarray(v) for k, v in pb.items()},
                                 deterministic=det, term_kinds=frozenset(), return_carry=carry)
    port = PP.solve_pipeline_gang(
        arrays_to_torch(na, "cpu"), arrays_to_torch(pa, "cpu"), {k: int(v) for k, v in args[6].items()},
        PS.prng_key_data(5), torch.from_numpy(group), pb=arrays_to_torch(pb, "cpu"), deterministic=det,
        term_kinds=frozenset(), return_carry=carry,
    )
    assert len(port) == len(ref) == (4 if carry else 3)
    for a, c in zip(ref[:3], port[:3]):  # assign, score, gang_ok
        assert np.array_equal(np.asarray(a), c.numpy())
    if carry:
        for a, c in zip(ref[3], port[3]):
            assert np.array_equal(np.asarray(a), c.numpy())
    ok = port[2].numpy()
    assert (~ok).any() and (port[0].numpy()[group >= 0] >= 0).sum() > 10


def _queue_pods(t):
    pods = []
    for i in range(30):
        labels = {"app": f"a{i % 3}"}
        if i % 4:
            labels[POD_GROUP_LABEL] = f"g{i % 5}"
        pods.append(t.Pod(name=f"p{i}", namespace="default", labels=labels, priority=(i * 7) % 3))
    return pods


def test_pop_all_in_groups_matches_reference():
    """The members of the popped batch's groups, whatever the batch size, in
    pop order, with attempts and pop timestamps set; the rest stay queued
    in order."""
    grp = lambda p: p.labels.get(POD_GROUP_LABEL, "")  # noqa: E731
    out = {}
    for name, t, queue_cls in (("ref", RT, RQueue), ("port", PT, PriorityQueue)):
        clock = [5.0]
        q = queue_cls(now=lambda: clock[0])
        for p in _queue_pods(t):
            q.add(p)
        clock[0] = 9.0
        batch = q.pop_batch(4)
        groups = {grp(i.pod) for i in batch if grp(i.pod)}
        extra = q.pop_all_in_groups(groups, grp)
        none = q.pop_all_in_groups({"nope"}, grp)
        rest = q.pop_batch(100)
        out[name] = ([i.pod.key() for i in batch], [(i.pod.key(), i.attempts, i.pop_ts) for i in extra], none,
                     [i.pod.key() for i in rest], q.scheduling_cycle())
    assert out["port"] == out["ref"]
    assert len(out["port"][1]) > 5 and out["port"][2] == []


def test_conflict_index_tombstones():
    """A rolled-back commit blocks no later pod, while a live commit of the
    same spec still does — in both directions of the anti-affinity
    re-check."""
    node = PT.Node(name="n0", labels={HOST_KEY: "n0"})
    term = PT.PodAffinityTerm(label_selector=PT.LabelSelector(match_labels={"app": "x"}), topology_key=HOST_KEY)
    anti = lambda name: PT.Pod(name=name, namespace="d", labels={"app": "y"},  # noqa: E731
                               affinity=PT.Affinity(pod_anti_affinity=PT.PodAntiAffinity(required=[term])))
    plain = lambda name, app: PT.Pod(name=name, namespace="d", labels={"app": app})  # noqa: E731
    # direction A: committed replicas' anti term against a later pod
    ix = D._BatchConflictIndex()
    a1, a2 = anti("a1"), anti("a2")
    for p in (a1, a2):
        ix.add_commit(p, node)
        ix.add_anti(p, node)
    probe = plain("probe", "x")
    assert ix.anti_conflict(probe, node)
    ix.remove(a1)
    assert ix.anti_conflict(probe, node)  # a2 of the same spec is live
    ix.remove(a2)
    assert not ix.anti_conflict(probe, node)
    # direction B: a later pod's anti term against committed replicas
    ix = D._BatchConflictIndex()
    x1, x2 = plain("x1", "x"), plain("x2", "x")
    for p in (x1, x2):
        ix.add_commit(p, node)
    probe = anti("probe")
    assert ix.anti_conflict(probe, node)
    ix.remove(x2)
    assert ix.anti_conflict(probe, node)
    ix.remove(x1)
    assert not ix.anti_conflict(probe, node)
    assert not ix.anti_conflict(plain("other", "z"), node)


# --- drains -------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _node(t, name, cpu):
    alloc = {t.RESOURCE_CPU: t.Quantity.parse(f"{cpu}m"), t.RESOURCE_MEMORY: t.Quantity.parse("8Gi"),
             t.RESOURCE_PODS: t.Quantity.parse(110)}
    return t.Node(name=name, labels={HOST_KEY: name}, allocatable=alloc, capacity=dict(alloc))


def _pod(t, name, cpu, group=None, min_available=None):
    labels = {"app": name[0]}
    if group:
        labels[POD_GROUP_LABEL] = group
    if min_available:
        labels[POD_GROUP_MIN_AVAILABLE] = str(min_available)
    return t.Pod(name=name, namespace="default", labels=labels,
                 containers=[t.Container(name="c", requests={t.RESOURCE_CPU: t.Quantity.parse(f"{cpu}m")})])


def _scheduler(pkg, nodes, existing, pending, batch, det, clock, seed=0):
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, nodes, existing)
    queue = (RQueue if pkg == "ref" else PriorityQueue)(now=clock)
    for p in pending:
        queue.add(p)
    kw = dict(batch_size=batch, deterministic=det, seed=seed)
    if pkg == "ref":
        return RScheduler(cache, queue, commit_plane=True, fold_plane=True, speculate=False, ingest_plane=False,
                          term_plane=False, columnar_cache=False, **kw)
    return Scheduler(cache, queue, device="cpu", **kw)


def _drain(sched, pending, max_batches=200):
    """Batches until one does nothing; per batch (scheduled, unschedulable,
    preempted) after its binds."""
    per_batch, assignments = [], {}
    for _ in range(max_batches):
        r = sched.schedule_batch()
        sched.wait_for_binds()
        if not (r.scheduled or r.unschedulable or r.deferred):
            break
        per_batch.append((r.scheduled, r.unschedulable, r.preempted))
        assignments.update(r.assignments)
    return per_batch, assignments


def _outcome(sched, pending, per_batch, assignments):
    assumed = sorted(p.key() for p in pending if sched.cache.is_assumed(p.key()))
    assert assumed == sorted(assignments)  # only the placed pods hold an assume
    counters = {k: sched.stats.get(k, 0) for k in ("oracle_rechecks", "light_rechecks", "oracle_places")}
    return per_batch, assignments, sched.queue.counts(), counters


def _scenario(name, t):
    """(nodes, bound pods, pending pods, batch size) of tests/test_gang.py's
    scenarios."""
    if name == "fits":
        return [_node(t, f"n{i}", 2000) for i in range(4)], [], [_pod(t, f"g{i}", 500, "job-a") for i in range(8)], 256
    if name == "all-or-nothing":
        return ([_node(t, "n0", 2000)], [], [_pod(t, f"g{i}", 500, "job-b") for i in range(5)]
                + [_pod(t, "plain", 2000)], 5)
    if name == "released-capacity":
        return [_node(t, "n0", 2000)], [], [_pod(t, f"g{i}", 500, "job-c") for i in range(5)] + [
            _pod(t, "solo", 1500)], 256
    if name == "two-gangs":
        return ([_node(t, f"n{i}", 2000) for i in range(2)], [],
                [_pod(t, f"d{i}", 500, "job-d") for i in range(4)] + [_pod(t, f"e{i}", 500, "job-e") for i in range(9)],
                256)
    if name == "straddle":
        return [_node(t, f"n{i}", 2000) for i in range(8)], [], [_pod(t, f"g{i}", 500, "big-job") for i in range(12)], 4
    if name == "min-available":
        return ([_node(t, f"n{i}", 2000) for i in range(4)], [],
                [_pod(t, f"g{i}", 500, "job-partial", min_available=8) for i in range(3)], 256)
    raise KeyError(name)


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("name", ["fits", "all-or-nothing", "released-capacity", "two-gangs", "straddle",
                                  "min-available"])
def test_gang_scenarios_match_reference(name, det):
    got = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, existing, pending, batch = _scenario(name, t)
        sched = _scheduler(pkg, nodes, existing, pending, batch, det, _Clock())
        per_batch, assignments = _drain(sched, pending)
        got[pkg] = _outcome(sched, pending, per_batch, assignments)
        sched.close()
    assert got["port"] == got["ref"]
    per_batch, assignments, counts, _ = got["port"]
    expect = {"fits": 8, "all-or-nothing": 1, "released-capacity": 1, "two-gangs": 4, "straddle": 12,
              "min-available": 0}[name]
    assert len(assignments) == expect
    if name == "straddle":
        assert per_batch[0][0] == 12  # one batch decided the whole group
    if name == "released-capacity":
        assert assignments == {"default/solo": "n0"} and per_batch[0] == (1, 5, 0)


def test_gang_requeues_and_retries_after_capacity_frees():
    got = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        clock = _Clock()
        blocker = _pod(t, "blocker", 1500)
        blocker.node_name = "n0"
        pending = [_pod(t, f"g{i}", 500, "job-f") for i in range(3)]
        sched = _scheduler(pkg, [_node(t, "n0", 2000)], [blocker], pending, 256, True, clock)
        first, _ = _drain(sched, pending, max_batches=1)
        sched.cache.remove_pod(blocker)
        sched.queue.move_all_to_active()
        clock.t += 15.0
        per_batch, assignments = _drain(sched, pending)
        got[pkg] = (first, _outcome(sched, pending, per_batch, assignments))
        sched.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == [(0, 3, 0)] and len(got["port"][1][1]) == 3


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_random_gang_drain_matches_reference(seed, det):
    """Tight random gang clusters in batches of 16 (groups straddle the
    batch boundary), retried twice with the clock stepped past the backoff:
    dropped groups, min-available, members rolled back on the host,
    ungrouped pods placed beside them."""
    got = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, pending = random_gang_cluster(seed, t=t)
        clock = _Clock()
        sched = _scheduler(pkg, nodes, [], pending, 16, det, clock, seed=seed)
        per_batch, assignments = [], {}
        for _ in range(3):
            pb, a = _drain(sched, pending)
            per_batch.append(pb)
            assignments.update(a)
            clock.t += 30.0
            sched.queue.move_all_to_active()
        got[pkg] = _outcome(sched, pending, per_batch, assignments)
        sched.close()
    assert got["port"] == got["ref"]
    per_batch, assignments, _, _ = got["port"]
    unsched = sum(u for rnd in per_batch for _, u, _ in rnd)
    gangs = {p.split("/")[1].split("-")[0] for p in assignments if p.split("/")[1].startswith("g")}
    assert unsched > 0 and gangs and sched.stats["gang_rollbacks"] > 0


def test_config5_drain_matches_reference():
    """bench.py config 5 at 1/20 (100 nodes, 50 groups of 64) in batches of
    1,024: every group lands whole, on the same nodes as the reference."""
    got = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, pending = bench_config5(100, 50, t=t)
        sched = _scheduler(pkg, nodes, [], pending, 1024, False, _Clock(), seed=3)
        per_batch, assignments = _drain(sched, pending)
        got[pkg] = _outcome(sched, pending, per_batch, assignments)
        sched.close()
    assert got["port"] == got["ref"]
    assert len(got["port"][1]) == 3200 and [b[0] for b in got["port"][0]] == [1024, 1024, 1024, 128]


def test_exception_rolls_back_staged_members():
    """A failure in the middle of a group's commit: the group's staged
    members are forgotten and go back to the queue with the pods not yet
    handled, the error surfaces, and no assume is left; the retry then
    schedules as the reference does."""
    pending = [_pod(PT, f"g{i}", 500, "job-x") for i in range(6)] + [_pod(PT, "solo", 100)]
    sched = _scheduler("port", [_node(PT, f"n{i}", 2000) for i in range(2)], [], pending, 256, True, _Clock())
    real = sched.cache.assume_pod
    calls = []

    def flaky(pod):
        calls.append(pod.key())
        if len(calls) == 4:
            raise RuntimeError("injected")
        real(pod)

    sched.cache.assume_pod = flaky
    with pytest.raises(RuntimeError, match="injected"):
        sched.schedule_batch()
    assert not any(sched.cache.is_assumed(p.key()) for p in pending)
    assert sched.queue.counts() == (7, 0, 0)
    sched.cache.assume_pod = real
    port = _drain(sched, pending)
    sched.close()
    ref_pending = [_pod(RT, f"g{i}", 500, "job-x") for i in range(6)] + [_pod(RT, "solo", 100)]
    ref = _scheduler("ref", [_node(RT, f"n{i}", 2000) for i in range(2)], [], ref_pending, 256, True, _Clock())
    want = _drain(ref, ref_pending)
    ref.close()
    assert port[1] == want[1] and len(port[1]) == 7
