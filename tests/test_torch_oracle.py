"""The host oracle on the CPU against `kubernetes_tpu`'s, on the same
seeded clusters built in each package:

* the predicate chain: `compute_predicate_metadata` (the DoNotSchedule
  spread counts and the inter-pod pair sets, on the full walk and through
  the per-snapshot `SnapshotAffinityIndex` with replayed commits),
  `pod_fits_on_node` (fit and reason) under the default provider and two
  Policy-restricted predicate sets, and `find_nodes_that_fit`, over
  `random_cluster` nodes x pods with topology spread, DoNotSchedule
  spread, inter-pod terms, host ports and fallback nodes;
* `NodeTree.order` and `SchedulerCache.node_order` through adds, zone
  moves, removals and a headless node;
* the slow preemption path: `fits_considering_nominated`,
  `select_victims_on_node` and `preempt` for preemptors with terms;
* `host_arbitrate` against the reference's and against the port's
  `arbitrate` on the batches the port's driver arbitrates;
* `gather_score_rows`' plain version against the JAX gather (K = 1,
  repeated rows, int64 extremes), and its host index check on the
  caller's ints; csrc/gather.cu's kernel walked in Python over its
  argument block (every output element once, 16-byte words by the rows'
  phases, the rows past the block's cap from the lanes);
* the escalation loop's one prefetch a batch for its escalated rows, in
  drains equal to the reference's.

Tolerance: exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.commit import arbiter as RA
from kubernetes_tpu.ops import pipeline as RPipe
from kubernetes_tpu.oracle import predicates as RPred
from kubernetes_tpu.oracle.nodeinfo import Snapshot as RSnapshot
from kubernetes_tpu.scheduler import preemption as RPre
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.node_tree import NodeTree as RNodeTree

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.commit import arbiter as PA
from kubernetes_tpu_torch.models.clusters import (
    HOST_KEY,
    bench_config3,
    commit_plane_mix,
    fill_cache,
    random_cluster,
    random_preemption_cluster,
)
from kubernetes_tpu_torch.ops import pipeline as PPipe
from kubernetes_tpu_torch.oracle import predicates as PPred
from kubernetes_tpu_torch.oracle.nodeinfo import LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot as PSnapshot
from kubernetes_tpu_torch.scheduler import driver as D
from kubernetes_tpu_torch.scheduler import preemption as PPre
from kubernetes_tpu_torch.scheduler.driver import Scheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.node_tree import NodeTree as PNodeTree
from kubernetes_tpu_torch.state.queue import PriorityQueue

PKGS = (("ref", RT, RPred, RSnapshot), ("port", PT, PPred, PSnapshot))

ENABLED = {
    "default": None,
    "general": frozenset({"GeneralPredicates", "PodToleratesNodeTaints"}),
    "terms": frozenset({"EvenPodsSpread", "MatchInterPodAffinity", "CheckNodeUnschedulable", "PodFitsResources"}),
}


def _cluster(seed, t):
    return random_cluster(seed, 30, 40, 90, t=t, overflow_nodes=2, pending_ports=True, topology=True,
                          hard_spread=True, interpod=True)


def _meta(m):
    """A predicate metadata as comparable plain data."""
    es = m.even_pods_spread
    pa = m.pod_affinity
    return (
        None if es is None else (es.tp_pair_to_match_num, es.tp_key_min_match),
        None if pa is None else (pa.existing_anti_pairs, pa.incoming_affinity_pairs, pa.incoming_anti_pairs),
        m.enabled,
    )


@pytest.mark.parametrize("enabled", list(ENABLED))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pod_fits_on_node_matches_reference(seed, enabled):
    out = {}
    for pkg, t, pred, snap_cls in PKGS:
        nodes, existing, pending = _cluster(seed, t)
        snap = snap_cls(nodes, existing)
        rows = []
        for pod in pending:
            meta = pred.compute_predicate_metadata(pod, snap, enabled=ENABLED[enabled])
            rows.append(_meta(meta))
            rows.append([pred.pod_fits_on_node(pod, ni, meta=meta) for ni in snap.node_infos.values()])
        out[pkg] = rows
    assert out["port"] == out["ref"]
    fits = [f for row in out["port"][1::2] for f, _ in row]
    reasons = {r[0] for row in out["port"][1::2] for f, r in row if not f}
    assert 0 < sum(fits) < len(fits)
    if enabled == "default":  # the chain's own verdicts decide some pods
        assert {"EvenPodsSpreadNotMatch", "MatchInterPodAffinity", "PodFitsHostPorts"} <= reasons


@pytest.mark.parametrize("seed", [3, 4])
def test_find_nodes_that_fit_matches_reference(seed):
    out = {}
    for pkg, t, pred, snap_cls in PKGS:
        nodes, existing, pending = _cluster(seed, t)
        snap = snap_cls(nodes, existing)
        out[pkg] = [pred.find_nodes_that_fit(pod, snap) for pod in pending]
    assert out["port"] == out["ref"]
    assert any(out["port"]) and not all(len(f) == 30 for f in out["port"])


@pytest.mark.parametrize("seed", [5, 6])
def test_affinity_index_with_replayed_commits_matches_reference_and_the_walk(seed):
    """The per-snapshot index plus commits replayed on top of it (the
    driver's `_pod_meta`) gives the reference's metadata, and the same
    metadata as the full walk over a snapshot holding those commits."""
    out = {}
    for pkg, t, pred, snap_cls in PKGS:
        nodes, existing, pending = _cluster(seed, t)
        snap = snap_cls(nodes, existing)
        index = pred.SnapshotAffinityIndex(snap)
        extra = []
        for j, pod in enumerate(pending[:12]):
            node = nodes[(7 * j) % len(nodes)]
            bound = pod.with_node(node.name)
            extra.append((bound, node.labels))
            snap.assign(bound)
        rows = []
        for pod in pending[12:]:
            got = _meta(pred.compute_predicate_metadata(pod, snap, affinity_index=index, affinity_extra=extra))
            walk = _meta(pred.compute_predicate_metadata(pod, snap))
            assert got == walk
            rows.append(got)
        out[pkg] = rows
    assert out["port"] == out["ref"]
    assert any(r[1][1] or r[1][2] for r in out["port"])  # the incoming pods' pair sets are exercised


def test_policy_predicates_are_refused():
    """No longer refused: an enabled set naming the Policy's
    custom-argument predicates (which run as framework Filter plugins) is
    taken as the reference takes it, the chain skipping those names: the
    same metadata and the same verdicts on every node."""
    enabled = frozenset({"CheckNodeLabelPresence", "ServiceAffinity", "GeneralPredicates",
                         "MatchInterPodAffinity"})
    out = {}
    for name, t, pred, snap_cls in PKGS:
        nodes, existing, pending = _cluster(0, t)
        snap = snap_cls(nodes, existing)
        rows = []
        for pod in pending[:20]:
            meta = pred.compute_predicate_metadata(pod, snap, enabled=enabled)
            rows.append((_meta(meta), [pred.pod_fits_on_node(pod, snap.get(n.name), meta=meta) for n in nodes]))
        out[name] = rows
    assert out["port"] == out["ref"]
    assert any(ok for _, verdicts in out["port"] for ok, _ in verdicts)


# --- NodeTree ----------------------------------------------------------------

def _zoned_nodes(t, n):
    rng = random.Random(n)
    out = []
    for i in range(n):
        labels = {HOST_KEY: f"n{i}"}
        k = rng.randrange(5)
        if k < 3:
            labels[LABEL_ZONE_FAILURE_DOMAIN] = f"z{k}"
        if k in (1, 3):
            labels[LABEL_ZONE_REGION] = f"r{k % 2}"
        out.append(t.Node(name=f"n{i}", labels=labels))
    return out


def test_node_tree_order_matches_reference():
    seqs = {}
    for pkg, t, tree_cls in (("ref", RT, RNodeTree), ("port", PT, PNodeTree)):
        tree = tree_cls()
        nodes = _zoned_nodes(t, 23)
        for n in nodes:
            tree.add_node(n)
        tree.add_node(nodes[3])  # a known name: no change
        seq = [tree.order() for _ in range(4)]
        moved = t.Node(name="n5", labels={LABEL_ZONE_FAILURE_DOMAIN: "z9"})
        tree.update_node(nodes[5], moved)
        for i in (0, 7, 8, 22):
            tree.remove_node(nodes[i])
        seq += [tree.order() for _ in range(3)]
        seqs[pkg] = (seq, tree.num_nodes)
    assert seqs["port"] == seqs["ref"]
    assert seqs["port"][0][0] != seqs["port"][0][1]  # the start rotates


def test_cache_node_order_matches_reference():
    out = {}
    for pkg, t, cache_cls in (("ref", RT, RCache), ("port", PT, SchedulerCache)):
        cache = cache_cls()
        nodes = _zoned_nodes(t, 17)
        headless = t.Pod(name="orphan", namespace="default", node_name="late")
        fill_cache(cache, nodes, [headless])  # "late" is a headless placeholder until its node arrives
        seq = [cache.node_order() for _ in range(2)]
        cache.add_node(t.Node(name="late", labels={LABEL_ZONE_FAILURE_DOMAIN: "z1"}))
        cache.remove_node("n4")
        seq += [cache.node_order() for _ in range(2)]
        out[pkg] = seq
    assert out["port"] == out["ref"]
    assert "late" in out["port"][0] and "n4" not in out["port"][-1]


# --- the slow preemption path ------------------------------------------------------

def _terms_cluster(seed, t):
    """random_preemption_cluster with terms added by index: every 3rd
    pending pod a required hostname anti-affinity to an app, every 3rd + 1
    a DoNotSchedule hostname spread on its own app, every 5th a required
    zone-free affinity to an app; every 4th bound pod a required
    anti-affinity to an app (the existing-pod half)."""
    nodes, existing, pending, pdbs = random_preemption_cluster(seed, t=t, ports=True)
    for i, p in enumerate(existing):
        if i % 4 == 0:
            p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": f"a{i % 3}"}), topology_key=HOST_KEY)]))
    for i, p in enumerate(pending):
        app = p.labels["app"]
        if i % 3 == 0:
            p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": f"a{(i + 1) % 4}"}), topology_key=HOST_KEY)]))
        elif i % 3 == 1:
            p.topology_spread_constraints = [t.TopologySpreadConstraint(
                max_skew=1, topology_key=HOST_KEY, when_unsatisfiable="DoNotSchedule",
                label_selector=t.LabelSelector(match_labels={"app": app}))]
        if i % 5 == 0:
            aff = p.affinity or t.Affinity()
            aff.pod_affinity = t.PodAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": f"a{i % 4}"}), topology_key="tier")])
            p.affinity = aff
    return nodes, existing, pending, pdbs


def _nominated(pending, nodes):
    """A fixed nominated index: pending pod j waits on node (3 j) % N."""
    by_node = {}
    for j, p in enumerate(pending[::3]):
        by_node.setdefault(nodes[(3 * j) % len(nodes)].name, []).append(p)
    return lambda name: list(by_node.get(name, ()))


@pytest.mark.parametrize("seed", [3, 4])
def test_fits_considering_nominated_matches_reference(seed):
    out = {}
    for pkg, t, mod, snap_cls in (("ref", RT, RPre, RSnapshot), ("port", PT, PPre, PSnapshot)):
        nodes, existing, pending, _ = _terms_cluster(seed, t)
        snap = snap_cls(nodes, existing)
        nominated = _nominated(pending, nodes)
        out[pkg] = [mod.fits_considering_nominated(pod, n.name, snap, nominated) for pod in pending
                    for n in nodes]
    assert out["port"] == out["ref"]
    assert 0 < sum(out["port"]) < len(out["port"])


@pytest.mark.parametrize("enabled", ["default", "general"])
@pytest.mark.parametrize("seed", [3, 5])
def test_select_victims_on_node_matches_reference(seed, enabled):
    """The full-chain victim search per (term-carrying preemptor, node):
    the same victims in reprieve order and the same PDB violation count."""
    out = {}
    for pkg, t, mod, snap_cls in (("ref", RT, RPre, RSnapshot), ("port", PT, PPre, PSnapshot)):
        nodes, existing, pending, pdbs = _terms_cluster(seed, t)
        snap = snap_cls(nodes, existing)
        rows = []
        for pod in pending:
            for n in nodes:
                v = mod.select_victims_on_node(pod, n.name, snap, pdbs=pdbs, enabled=ENABLED[enabled])
                rows.append(None if v is None else ([p.key() for p in v.pods], v.num_pdb_violations))
        out[pkg] = rows
    assert out["port"] == out["ref"]
    assert sum(r is not None for r in out["port"]) > 10


@pytest.mark.parametrize("enabled", ["default", "general"])
@pytest.mark.parametrize("seed", [3, 5, 6])
def test_slow_preempt_matches_reference(seed, enabled):
    """`preempt` for term-carrying preemptors (and every preemptor once an
    existing pod carries required anti-affinity): the slow path on every
    candidate node, then the six-key pick — the same node, victims and
    nominations to clear; the device search declines such batches in
    both packages."""
    out = {}
    for pkg, t, mod, snap_cls in (("ref", RT, RPre, RSnapshot), ("port", PT, PPre, PSnapshot)):
        nodes, existing, pending, pdbs = _terms_cluster(seed, t)
        snap = snap_cls(nodes, existing)
        nominated = _nominated(pending, nodes)
        rows = []
        for pod in pending:
            node, victims, clear = mod.preempt(pod, snap, pdbs=pdbs, nominated_fn=nominated,
                                               enabled=ENABLED[enabled])
            rows.append((node, [p.key() for p in victims], sorted(clear)))
        rows.append(mod.batch_preempt_device(pending, snap, pdbs=pdbs))
        out[pkg] = rows
    assert out["port"] == out["ref"]
    assert out["port"][-1] is None
    assert sum(r[0] is not None for r in out["port"][:-1]) >= 3


# --- host_arbitrate ---------------------------------------------------------------

def _arbitrated_batches(workload, seed, monkeypatch):
    """Drain `workload` with the port's driver (commit plane on) and record,
    for every batch it arbitrated: the pre-batch snapshot's nodes and pods,
    the batch's pods in pop order, the assignment and the verdicts."""
    if workload == "mix":
        nodes, pending = commit_plane_mix(8, 96)
        existing = []
    elif workload == "hard":
        nodes, pending, _ = bench_config3(24, 600, hard=True)
        existing = []
    else:
        nodes, existing, pending = random_cluster(seed, 40, 90, 60, pins=False, topology=True, hard_spread=True,
                                                  interpod=True, pending_affinity=False, pending_ports=True)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes, existing)
    for p in pending:
        queue.add(p)
    batch = {"mix": 16, "hard": 300}.get(workload, 32)
    sched = Scheduler(cache, queue, batch_size=batch, deterministic=True, device="cpu", enable_preemption=False)
    calls = []
    real_arbitrate, real_pop = D.arbitrate, queue.pop_batch
    state = {}

    def pop(n):
        infos = real_pop(n)
        state["pods"] = [i.pod for i in infos]
        state["bound"] = [p for ni in cache.snapshot.node_infos.values() for p in ni.pods]
        return infos

    def spy(*args, **kw):
        verdict = real_arbitrate(*args, **kw)
        k = len(state["pods"])
        calls.append((state["pods"], state["bound"], args[5].numpy()[:k].tolist(), verdict.numpy()[:k].tolist(),
                      list(sched.mirror.name_of_row)))
        return verdict

    monkeypatch.setattr(D, "arbitrate", spy)
    monkeypatch.setattr(queue, "pop_batch", pop)
    sched.run_until_empty()
    sched.close()
    return nodes, calls


def _to_ref(pods, ref_by_key):
    return [ref_by_key[p.key()] for p in pods]


@pytest.mark.parametrize("workload,seed", [("mix", 0), ("hard", 0), ("random", 7), ("random", 8)])
def test_host_arbitrate_matches_reference_and_arbitrate(workload, seed, monkeypatch):
    nodes, calls = _arbitrated_batches(workload, seed, monkeypatch)
    assert calls
    # the same cluster in the reference's types, looked up by pod key
    if workload == "mix":
        r_nodes, r_pods = commit_plane_mix(8, 96, t=RT)
        r_existing = []
    elif workload == "hard":
        r_nodes, r_pods, _ = bench_config3(24, 600, t=RT, hard=True)
        r_existing = []
    else:
        r_nodes, r_existing, r_pods = random_cluster(seed, 40, 90, 60, t=RT, pins=False, topology=True,
                                                     hard_spread=True, interpod=True, pending_affinity=False,
                                                     pending_ports=True)
    r_by_key = {p.key(): p for p in r_pods + r_existing}
    defers = 0
    for pods, bound, assign, verdicts, name_of in calls:
        name_of_row = lambda r: name_of[r] if 0 <= r < len(name_of) else None  # noqa: E731
        port = PA.host_arbitrate(pods, assign, name_of_row, PSnapshot(nodes, bound))
        r_bound = [r_by_key[p.key()].with_node(p.node_name) for p in bound]
        ref = RA.host_arbitrate(_to_ref(pods, r_by_key), assign, name_of_row, RSnapshot(r_nodes, r_bound))
        assert port == ref == verdicts
        defers += verdicts.count(PA.V_DEFER)
    if workload != "random":
        assert defers > 0


# --- gather_score_rows ----------------------------------------------------------------

def _score(seed, u, n):
    rng = np.random.default_rng(seed)
    s = rng.integers(-(2**40), 2**40, (u, n), dtype=np.int64)
    s[0, :3] = (np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0)
    return s


@pytest.mark.parametrize("u,n,idx", [
    (1, 7, [0]),
    (8, 33, [3]),
    (8, 33, [5, 5, 0, 7, 5]),
    (16, 300, list(range(16))[::-1]),
    (32, 257, [0, 31, 1, 30, 0]),
])
def test_gather_score_rows_matches_reference(u, n, idx):
    score = _score(u * n, u, n)
    want = np.asarray(RPipe.gather_score_rows(jnp.asarray(score), jnp.asarray(np.asarray(idx, np.int32))))
    got = PPipe.gather_score_rows(torch.from_numpy(score), idx)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(PPipe.gather_score_rows_plain(torch.from_numpy(score),
                                                        torch.tensor(idx, dtype=torch.int32)).numpy(), want)


@pytest.mark.parametrize("idx", [[8], [-1], [0, 3, 9]])
def test_gather_score_rows_checks_indices_on_the_host(idx):
    """The reference's jitted gather would clamp an index out of range; the
    port checks every index against U on the host and raises."""
    score = torch.from_numpy(_score(1, 8, 5))
    with pytest.raises(IndexError, match="out of range"):
        PPipe.gather_score_rows(score, idx)
    with pytest.raises(ValueError, match="1-D"):
        PPipe.gather_score_rows(score, [[0]])
    assert PPipe.gather_score_rows(score, []).shape == (0, 5)


def test_score_rows_fetch_each_spec_row_once():
    """The driver's lazy view: batch positions map onto spec rows; a
    prefetch gathers the missing rows once, in one call."""
    score = torch.from_numpy(_score(2, 6, 9))
    rows = D.ScoreRows(score, [2, 2, 0, 5, 0])
    before = PPipe.gather_score_rows.launches
    rows.prefetch([0, 1, 2])
    assert sorted(rows._cache) == [0, 2]
    assert np.array_equal(rows[4], score[0].numpy()) and np.array_equal(rows[3], score[5].numpy())
    assert sorted(rows._cache) == [0, 2, 5]
    assert PPipe.gather_score_rows.launches == before  # CPU tensors: the plain version, not counted


def test_escalation_meta_advances_like_a_fresh_computation():
    """The escalation loop's per-spec metadata, advanced by the loop's own
    commits, equals the metadata computed afresh on the live snapshot; a
    change the loop did not make (a pod removed behind its back) makes it
    compute afresh."""
    nodes, pods, _ = bench_config3(24, 1000, hard=True)
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes, [p.with_node(nodes[i % 24].name) for i, p in enumerate(pods[:200])])
    sched = Scheduler(cache, queue, device="cpu")
    sched.mirror.sync()
    memo, commits = {}, []
    probe = pods[205]  # app svc-5; its app's pods 305, 405, ... commit below
    fresh = lambda: _meta(PPred.compute_predicate_metadata(probe, cache.snapshot))  # noqa: E731
    assert _meta(sched._escalation_meta(probe, memo, commits)) == fresh()
    for j, p in enumerate(p for i, p in enumerate(pods) if i > 205 and (i % 100 == 5 or i % 13 == 0)):
        node = nodes[(5 * j) % 24].name
        assert sched._commit(D.PodInfo(pod=p), node, 0)
        commits.append((p, node))
        assert _meta(sched._escalation_meta(probe, memo, commits)) == fresh()
    assert sum(p.labels["app"] == "svc-5" for p, _ in commits) >= 5
    hit = memo[D.spec_key(probe)]
    cache.remove_pod(pods[5].with_node(nodes[5].name))  # svc-5, not one of the loop's commits
    assert _meta(sched._escalation_meta(probe, memo, commits)) == fresh()
    assert memo[D.spec_key(probe)][0] is not hit[0]  # computed afresh
    sched.wait_for_binds()
    sched.close()


# --- the score-row gather's kernel, walked on the host ------------------------------------

def walk_score_gather(score, rows, score_addr, out_addr):
    """csrc/gather.cu's kernel CTA by CTA over its argument block
    (score_gather_block: the rows inline up to GATHER_MAX_INLINE, past it
    read from the lanes the wrapper copies), at the given base addresses,
    whose 16-byte phases choose each row's words; each CTA's 16-byte words
    taken thread by thread (word p is thread p % THREADS's iteration
    p // THREADS). Returns (out, writes per out element, 16-byte words
    used)."""
    u, n = score.shape
    k = len(rows)
    a = PPipe.score_gather_block(score_addr, out_addr, 1 if k > PPipe.GATHER_MAX_INLINE else None, u, n, rows)
    out = np.zeros((k, n), np.int64)
    writes = np.zeros((k, n), np.int64)
    threads, words = PPipe.GATHER_THREADS, a.words
    chunk_n = 2 * threads * words
    wide_words = 0
    for b in range(a.chunks * a.K):
        kk = b // a.chunks
        chunk = b - kk * a.chunks
        r = rows[kk] if a.lanes else a.rows[kk]
        src_addr, dst_addr = a.score + r * n * 8, a.out + kk * n * 8
        phase = (src_addr >> 3) & 1
        wide = phase == (dst_addr >> 3) & 1
        head = phase if wide else 0
        idx = []
        if head == 1 and chunk == 0:
            idx.append(np.array([0]))  # thread 0
        lo = head + chunk * chunk_n
        hi = min(lo + chunk_n, n)
        if lo < hi:
            if wide:
                pairs = (hi - lo) >> 1
                p = np.arange(words * threads)
                p = p[p < pairs]
                first = lo + 2 * p
                assert not ((src_addr + 8 * first) % 16).any() and not ((dst_addr + 8 * first) % 16).any()
                idx += [first, first + 1]
                wide_words += p.size
                if (hi - lo) & 1:
                    idx.append(np.array([hi - 1]))  # the scalar tail, thread 0
            else:
                idx.append(np.arange(lo, hi))
        for e in idx:
            out[kk, e] = score[r, e]
            np.add.at(writes[kk], e, 1)
    return out, writes, wide_words


@pytest.mark.parametrize("u,n,rows,phases", [
    (3, 7, [0], (0, 0)),
    (8, 1031, [5, 5, 0, 7, 6], (0, 0)),  # odd N: each row's phase by its index
    (8, 1031, [5, 5, 0, 7, 6], (1, 0)),
    (4, 2048, [3, 1], (0, 0)),  # exactly one CTA a row
    (4, 2049, [0, 1, 2, 3], (1, 1)),  # a pair-aligned row past one CTA, the scalar head
    (128, 10240, [7, 91, 3, 120], (0, 0)),  # the config-3-hard rows at the driver's K
    (640, 3, list(range(640))[::-1], (0, 0)),  # K past the argument block: the lanes
    (600, 2050, [i % 600 for i in range(0, 513 * 7, 7)], (0, 1)),  # K = 513, repeated rows
])
def test_score_gather_walk_covers_every_output_element_once(u, n, rows, phases):
    """The score-row gather's kernel walked in Python: every output element
    written exactly once and equal to the plain gather (and the JAX
    gather), 16-byte words wherever a row's source and destination share a
    phase (an odd head alone, an odd tail as a scalar), 8-byte words where
    they do not, the rows past the argument block's cap from the lanes."""
    score = _score(u + n, u, n)
    out, writes, wide = walk_score_gather(score, rows, 0x10000 + 8 * phases[0], 0x90000 + 8 * phases[1])
    assert (writes == 1).all()
    want = np.asarray(RPipe.gather_score_rows(jnp.asarray(score), jnp.asarray(np.asarray(rows, np.int32))))
    assert np.array_equal(out, want)
    assert np.array_equal(PPipe.gather_score_rows(torch.from_numpy(score), rows).numpy(), want)
    if n % 2 == 0 and phases[0] == phases[1]:
        assert wide == len(rows) * (n // 2)  # every element in a 16-byte word
    if len(rows) > PPipe.GATHER_MAX_INLINE:
        with pytest.raises(ValueError, match="exceed"):
            PPipe.score_gather_block(1, 2, None, u, n, rows)
    # CTAs widen only while the launch keeps two an SM
    block = PPipe.score_gather_block(0, 0, 1, u, n, rows)
    ctas = block.chunks * len(rows)
    assert block.words in (1, 2, 4) and (block.words == 1 or ctas >= PPipe.GATHER_MIN_CTAS)
    assert block.words == 4 or len(rows) * -(-n // (2 * PPipe.GATHER_THREADS * 2 * block.words)) < \
        PPipe.GATHER_MIN_CTAS


def test_score_rows_are_checked_python_ints():
    """The wrapper's host check works on the caller's ints (a list, a numpy
    vector or a CPU tensor), with no tensor built for it."""
    assert PPipe.score_rows([3, np.int64(2)], 4) == [3, 2]
    assert PPipe.score_rows(np.array([1, 0], np.int32), 2) == [1, 0]
    assert PPipe.score_rows(torch.tensor([1]), 2) == [1]
    with pytest.raises(IndexError, match="out of range"):
        PPipe.score_rows([2], 2)
    with pytest.raises(ValueError, match="1-D"):
        PPipe.score_rows(np.zeros((1, 1), np.int64), 2)


@pytest.mark.parametrize("workload,batch", [("mix", 16), ("perf-mix", 256)])
def test_escalation_loop_prefetches_its_rows_once_a_batch(workload, batch, monkeypatch):
    """An arbitrated drain whose defers escalate to the host oracle: every
    batch that escalates makes exactly ONE prefetch of the score rows, for
    exactly its escalated pods (the loop then reads them from the cache),
    and the drain equals the reference's pod for pod and counter for
    counter."""
    from test_torch_drain import _counters, _preemption_drain

    ra, rv, rn, rp, rst, _ = _preemption_drain("ref", workload, batch=batch)
    batches, current = [], []
    real_arb, real_prefetch = D.Scheduler._commit_arbitrated, D.ScoreRows.prefetch

    def arbitrated(self, infos, out, *a, **k):
        current.append([])
        try:
            return real_arb(self, infos, out, *a, **k)
        finally:
            batches.append(current.pop())

    def prefetch(self, indices):
        indices = list(indices)
        if current:
            current[-1].append(indices)
        return real_prefetch(self, indices)

    monkeypatch.setattr(D.Scheduler, "_commit_arbitrated", arbitrated)
    monkeypatch.setattr(D.ScoreRows, "prefetch", prefetch)
    pa, pv, pn, pp, st, _ = _preemption_drain("port", workload, batch=batch)
    assert (pa, pv, pn, pp) == (ra, rv, rn, rp)
    assert _counters(st) == _counters(rst)
    escalating = [calls for calls in batches if calls]
    assert all(len(calls) == 1 for calls in escalating)
    assert sum(len(calls[0]) for calls in escalating) == st["arbiter_escalated"] > 0
    assert all(len(set(calls[0])) == len(calls[0]) for calls in escalating)
    if workload == "perf-mix":
        assert max(len(calls[0]) for calls in escalating) > 1  # pods of one batch share the gather
