"""The port's Scheduler on a node mesh on the CPU, against the reference's
Scheduler on one device and on its 8-device mesh, and against the port's
single-device Scheduler: pod for pod, exact.

The reference runs `Scheduler(speculate=False, columnar_cache=False)` (the
port has neither speculation nor the columnar cache; both packages keep
their default ingest, term, commit and fold planes), alone and with
`mesh=kubernetes_tpu.parallel.node_mesh(8)` under the `ref_mesh` fixture
of tests/test_torch_parallel.py (its shard_map with `check_vma=False`,
fresh program memos). The port runs `Scheduler(device="cpu",
mesh=node_mesh(8, device="cpu"))`. Held: placements, victims, the
arbiter, fold and fallback counters, and the folded banks against a fresh
encode — on required anti-affinity with every batch arbitrated and folded,
DoNotSchedule spread, in-batch anti-affinity and host ports under
tie-noise, gang groups, preemption with the nominee overlay, a mixed
cluster with every covered kind on 1D and 2D meshes, and the counted
fallback for a node capacity the shards do not divide.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.scheduler.driver import Scheduler as RScheduler
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.queue import PriorityQueue as RQueue

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import (
    HOST_KEY,
    ZONE_KEY,
    bench_config3,
    bench_config6,
    fill_cache,
    make_node,
    make_pod,
    random_cluster,
    random_gang_cluster,
)
from kubernetes_tpu_torch.parallel import node_mesh
from kubernetes_tpu_torch.scheduler.driver import Scheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.queue import PriorityQueue
from kubernetes_tpu_torch.state.tensors import encode_snapshot as p_encode
from test_torch_parallel import pytestmark, ref_mesh  # noqa: F401  (the fixture)

# the counters both packages keep under one name
COUNTERS = ("batches", "arbiter_batches", "arbiter_place", "arbiter_defer", "fold_batches", "sharded_fallbacks")


class _Clock:
    """One stepped clock per queue: the backoff waits on the drain loop."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _workload(name, t):
    """(nodes, bound pods, pending pods) of one mesh drain."""
    if name == "mixed":
        return random_cluster(31, 16, 40, 48, t=t, pins=True, topology=True, interpod=True, pending_affinity=False)
    if name == "hard":
        nodes, pods, _ = bench_config3(32, 320, t=t, hard=True)
        return nodes, [], pods
    if name == "preempt":
        return bench_config6(16, 40, t=t)
    if name == "gang":
        nodes, pods = random_gang_cluster(3, 16, 12, 20, t=t)
        return nodes, [], pods
    if name == "anti":  # every 4th pod anti-affine to its app on the hostname
        nodes = [make_node(f"n{i}", cpu_milli=4000, labels={HOST_KEY: f"n{i}"}, t=t) for i in range(8)]
        pods = []
        for i in range(24):
            if i % 4 == 0:
                p = make_pod(f"a{i}", cpu_milli=100, labels={"app": f"g{i % 8}"}, t=t)
                p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                    label_selector=t.LabelSelector(match_labels={"app": f"g{i % 8}"}), topology_key=HOST_KEY)]))
            else:
                p = make_pod(f"p{i}", cpu_milli=100, t=t)
            pods.append(p)
        return nodes, [], pods
    # in-batch: 6 zone-anti pods over 4 zones, 10 ported pods over 8 hosts
    nodes = [make_node(f"n{i}", cpu_milli=8000, labels={HOST_KEY: f"n{i}", ZONE_KEY: f"z{i % 4}"}, t=t)
             for i in range(8)]
    pods = []
    for i in range(6):
        p = make_pod(f"anti{i}", cpu_milli=100, mem=2**20, labels={"grp": "a"}, t=t)
        p.priority = 20
        p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
            label_selector=t.LabelSelector(match_labels={"grp": "a"}), topology_key=ZONE_KEY)]))
        pods.append(p)
    for i in range(10):
        p = make_pod(f"port{i}", cpu_milli=100, mem=2**20, t=t)
        p.priority = 10
        p.containers[0].ports = [t.ContainerPort(host_port=9090, container_port=80)]
        pods.append(p)
    return nodes, [], pods


def _drain(pkg, workload, mesh, batch, det=True, seed=11, preemption=False, shards_hack=None):
    """Drain one workload to the end on a stepped clock (binds awaited after
    every batch; an idle batch steps the clock 1 s and moves the
    unschedulable pods back). Returns (assignments, victims in delete order,
    stats, scheduler)."""
    t = RT if pkg == "ref" else PT
    nodes, existing, pending = _workload(workload, t)
    clock = _Clock()
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, nodes, existing)
    queue = (RQueue if pkg == "ref" else PriorityQueue)(now=clock)
    deleted = []

    def delete(v):
        deleted.append(v.key())
        cache.remove_pod(v)

    kw = dict(batch_size=batch, deterministic=det, seed=seed, enable_preemption=preemption, delete_fn=delete,
              mesh=mesh)
    if pkg == "ref":
        sched = RScheduler(cache, queue, speculate=False, columnar_cache=False, **kw)
    else:
        sched = Scheduler(cache, queue, device="cpu", **kw)
    if shards_hack is not None:
        sched._mesh_shards = shards_hack
    for p in pending:
        queue.add(p)
    assignments = {}
    idle = 0
    for _ in range(200):
        r = sched.schedule_batch()
        sched.wait_for_binds()
        assignments.update(r.assignments)
        if r.scheduled or r.unschedulable or r.deferred:
            idle = 0
            continue
        if sum(queue.counts()) == 0 or idle >= 12:
            break
        idle += 1
        clock.t += 1.0
        queue.move_all_to_active()
    sched.close()
    stats = {k: sched.stats.get(k, 0) for k in COUNTERS}
    return assignments, deleted, stats, sched


def _port_stats(sched):
    return {k: v for k, v in sched.stats.items() if not k.endswith("_s") and k != "sharded_fallbacks"}


def _banks_fresh(sched):
    """The folded device node bank equals a fresh host encode of the cache."""
    m = sched.mirror
    m.sync()
    dev, _, _ = m.device_arrays()
    fresh, _, rows = p_encode(sched.cache.snapshot, vocab=m.vocab, with_images=False)
    assert rows == m.row_of
    for k in ("requested", "nonzero_req", "pod_count"):
        assert np.array_equal(dev[k].numpy(), fresh.arrays()[k]), k


CASES = [
    # (workload, batch, deterministic, preemption, also against the reference's mesh)
    ("anti", 8, True, False, False),
    ("hard", 64, True, False, True),
    ("inbatch", 32, False, False, False),
    ("gang", 16, True, False, True),
    ("preempt", 16, True, True, True),
]


@pytest.mark.parametrize("workload,batch,det,preemption,ref_on_mesh", CASES,
                         ids=[f"{c[0]}-{'det' if c[2] else 'noise'}" for c in CASES])
def test_driver_over_mesh_matches_reference(workload, batch, det, preemption, ref_on_mesh, ref_mesh):  # noqa: F811
    """The port on an 8-shard mesh == the reference's single-device drain
    and the port's single-device drain: placements, victims, the arbiter,
    fold and fallback counters (and every counter of the port's own
    drain); every mesh batch on the sharded programs (no fallback), and
    the sharded folds leave the banks equal to a fresh encode. The
    DoNotSchedule, gang and preemption drains are also held to the
    reference on its 8-device mesh."""
    pa, pv, ps, sched = _drain("port", workload, node_mesh(8, device="cpu"), batch, det, preemption=preemption)
    ra, rv, rs, _ = _drain("ref", workload, None, batch, det, preemption=preemption)
    assert pa == ra and pv == rv and ps == rs
    if ref_on_mesh:
        ma, mv, ms, _ = _drain("ref", workload, ref_mesh(8), batch, det, preemption=preemption)
        assert pa == ma and pv == mv and ps == ms
    oa, ov, _, one = _drain("port", workload, None, batch, det, preemption=preemption)
    assert pa == oa
    assert pv == ov
    assert _port_stats(sched) == _port_stats(one)  # every counter of the single-device drain
    assert ps["sharded_fallbacks"] == 0 and len(pa) > 10
    if workload in ("anti", "hard"):  # every batch arbitrated and folded
        assert ps["arbiter_batches"] == ps["fold_batches"] == ps["batches"] > 0
    if workload == "hard":
        assert ps["arbiter_place"] == len(pa) == 320
    if workload == "preempt":
        assert sched.stats["preempted"] > 0 and sched.stats["nominee_folds"] > 0 and len(pv) > 0
    if workload == "gang":
        assert sched.stats["gang_batches"] > 0
    _banks_fresh(sched)


@pytest.mark.parametrize("pods_parallel", [1, 2])
def test_driver_over_mesh_mixed_cluster(pods_parallel):
    """A random cluster with every covered term kind (spread, inter-pod,
    bound pods with affinity) under tie-noise, on a 1D and a 2D mesh: the
    reference's single-device drain pod for pod with the arbiter, fold and
    fallback counters, the port's single-device drain with every counter,
    no fallback."""
    pa, _, ps, sched = _drain("port", "mixed", node_mesh(8, pods_parallel=pods_parallel, device="cpu"), 16, det=False)
    ra, _, rs, _ = _drain("ref", "mixed", None, 16, det=False)
    assert pa == ra and ps == rs
    oa, _, os_, one = _drain("port", "mixed", None, 16, det=False)
    assert pa == oa and len(pa) > 10
    assert _port_stats(sched) == _port_stats(one)
    assert ps["sharded_fallbacks"] == 0 and ps["fold_batches"] == os_["fold_batches"] > 0
    _banks_fresh(sched)


def test_sharded_fallback_is_observable(ref_mesh, caplog):  # noqa: F811
    """A shard count that does not divide the node capacity (forced, as the
    reference's test forces it) falls back to the single-device programs,
    counted in stats["sharded_fallbacks"] and warned about once; the
    result is the reference's."""
    ra, _, rs, _ = _drain("ref", "anti", ref_mesh(8), 8, shards_hack=7)
    with caplog.at_level("WARNING"):
        pa, _, ps, _ = _drain("port", "anti", node_mesh(8, device="cpu"), 8, shards_hack=7)
    assert pa == ra and len(pa) == 24
    assert ps["sharded_fallbacks"] == rs["sharded_fallbacks"] == ps["batches"] > 0
    assert sum("sharded solve FALLBACK" in r.getMessage() for r in caplog.records
               if r.name.startswith("kubernetes_tpu_torch")) == 1


def test_scheduler_mesh_device_rules():
    """The scheduler runs on its mesh's device; a mesh on another device
    than the one asked for raises."""
    cache = SchedulerCache()
    sched = Scheduler(cache, PriorityQueue(), mesh=node_mesh(4, device="cpu"))
    assert sched.device == torch.device("cpu") and sched._mesh_shards == 4
    sched.close()
    mesh = node_mesh(4, device="cpu")
    mesh.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="the mesh lies on cuda:0, the scheduler on cpu"):
        Scheduler(SchedulerCache(), PriorityQueue(), device="cpu", mesh=mesh)
