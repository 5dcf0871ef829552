"""The pod-ingest plane of the port against the reference's, on the CPU:
the staged slab (PodStage) against the reference's on the same pods, the
plain slab gather (`gather_stage_plain`, and the `gather_stage` wrapper's
CPU path) against the reference's jitted `gather_stage` on seeded slabs
with padding lanes, repeated rows and every dtype, the gathered dict
against the legacy PodBatch of the same reps, a walk of csrc/slab.cu's
batch gather, a flush through the plain row scatter against the reference's
`_scatter_fn()` (host truth taken by the scatter, repeated rows, both
planes' slabs in one multi-problem call), the bank's flush as one
host-truth problem, and drains of the port's default Scheduler (both planes
on) against the reference's with the same planes on (speculation and the
columnar cache off, no warm-up, so every flush is the dispatch-time one):
the reference suite's mixed / anti / gang scenarios, its preemption and
node-churn drains — the same placements pod for pod and the same plane
counters — and the planes-off port drain equal to the planes-on one. Then
the staleness paths (update between enqueue and pop, delete between pop and
dispatch, slab growth, the slab ceiling taking the legacy path, a rebuild
mid-resolve, vocab width growth, refcounts) against the reference, and a
failing gather or flush: `schedule_batch` raises with the batch back in the
queue. Tolerance: exact equality."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops  # noqa: F401  (turns x64 on, as the reference runs)
from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ingest import stage as r_stage_mod
from kubernetes_tpu.ingest.bank import StageBank as RStageBank
from kubernetes_tpu.ingest.bank import _scatter_fn as r_scatter_fn
from kubernetes_tpu.ingest.gather import gather_stage as r_gather_stage
from kubernetes_tpu.scheduler.driver import Scheduler as RScheduler
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.queue import PriorityQueue as RQueue
from kubernetes_tpu.state.tensors import Vocab as RVocab

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.ingest import StageBank, gather_stage, gather_stage_plain
from kubernetes_tpu_torch.ingest import bank as bank_mod
from kubernetes_tpu_torch.ingest import stage as p_stage_mod
from kubernetes_tpu_torch.models.clusters import fill_cache, random_cluster
from kubernetes_tpu_torch.ops import slab as SL
from kubernetes_tpu_torch.scheduler import driver as D
from kubernetes_tpu_torch.scheduler.driver import POD_GROUP_LABEL, Scheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.queue import PriorityQueue
from kubernetes_tpu_torch.state.tensors import PodBatch, Vocab

HOST = "kubernetes.io/hostname"
ZONE = "zone"
PLANE_COUNTERS = (
    "ingest_index_batches", "ingest_legacy_batches", "ingest_stale_rows", "ingest_restaged", "stage_sync_flushes",
    "term_index_batches", "term_legacy_batches", "term_stale_rows", "term_restaged", "term_sync_flushes",
)


# ---------------------------------------------------------------------------
# clusters built identically for the reference (t=RT) and the port (t=PT)
# ---------------------------------------------------------------------------

def make_node(t, name, cpu=4000, labels=None):
    alloc = {t.RESOURCE_CPU: t.Quantity.parse(f"{cpu}m"), t.RESOURCE_MEMORY: t.Quantity.parse("16Gi"),
             t.RESOURCE_PODS: t.Quantity.parse(110)}
    return t.Node(name=name, labels=dict(labels or {}), allocatable=alloc, capacity=dict(alloc))


def make_pod(t, name, cpu=100, labels=None, node_name="", priority=None):
    p = t.Pod(name=name, namespace="default", labels=dict(labels or {}), node_name=node_name,
              containers=[t.Container(name="main", image="nginx:1.17",
                                      requests={t.RESOURCE_CPU: t.Quantity.parse(f"{cpu}m"),
                                                t.RESOURCE_MEMORY: t.Quantity.parse("128Mi")})])
    if priority is not None:
        p.priority = priority
    return p


def nodes(t, n, zones=0, cpu=4000):
    out = []
    for i in range(n):
        labels = {HOST: f"n{i}"}
        if zones:
            labels[ZONE] = f"z{i % zones}"
        out.append(make_node(t, f"n{i}", cpu, labels))
    return out


def anti_pod(t, name, app, cpu=100):
    p = make_pod(t, name, cpu, {"app": app})
    p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
        label_selector=t.LabelSelector(match_labels={"app": app}), topology_key=HOST)]))
    return p


def spread_pod(t, name, app, cpu=50):
    p = make_pod(t, name, cpu, {"app": app})
    p.topology_spread_constraints = [t.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=t.LabelSelector(match_labels={"app": app}))]
    return p


def pref_pod(t, name, app, cpu=50):
    p = make_pod(t, name, cpu, {"app": app})
    p.affinity = t.Affinity(pod_affinity=t.PodAffinity(preferred=[t.WeightedPodAffinityTerm(
        weight=3, pod_affinity_term=t.PodAffinityTerm(
            label_selector=t.LabelSelector(match_labels={"app": app}), topology_key=ZONE))]))
    return p


def scenario_pods(t, scenario):
    """The pending pods of the reference plane suites' drain scenarios
    (tests/test_ingest_plane.py, tests/test_terms_plane.py)."""
    out = []
    if scenario in ("ingest-mixed", "terms-mixed"):
        rng = random.Random(0)
        terms = scenario == "terms-mixed"
        for i in range(24):
            roll = rng.random()
            if roll < (0.2 if terms else 0.25):
                out.append(anti_pod(t, f"a{i}", f"g{rng.randrange(3)}"))
            elif roll < (0.4 if terms else 0.5):
                out.append(spread_pod(t, f"s{i}", f"sp{rng.randrange(2)}"))
            elif terms and roll < 0.55:
                out.append(pref_pod(t, f"w{i}", f"pp{rng.randrange(2)}"))
            else:
                out.append(make_pod(t, f"p{i}", 100 + 10 * (i % 3)))
    elif scenario == "anti":
        out = [anti_pod(t, f"a{i}", f"g{i % 4}") for i in range(12)]
    elif scenario == "spread":
        out = [spread_pod(t, f"s{i}", f"sp{i % 2}") for i in range(12)]
    elif scenario in ("ingest-gang", "terms-gang"):
        out = [make_pod(t, f"g{g}m{m}", 100, {POD_GROUP_LABEL: f"gang-{g}"}) for g in range(2) for m in range(6)]
        if scenario == "ingest-gang":
            out += [make_pod(t, f"p{i}", 100) for i in range(6)]
        else:
            out += [anti_pod(t, f"a{i}", f"g{i % 2}") for i in range(6)]
    else:
        raise AssertionError(scenario)
    return out


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def scheduler(pkg, node_list, existing=(), clock=None, **kw):
    """The port's Scheduler(device="cpu") or the reference's with
    speculation and the columnar cache off; both planes on unless `kw`
    says otherwise; both queues on one stepped clock."""
    cache = (RCache if pkg == "ref" else SchedulerCache)()
    fill_cache(cache, node_list, list(existing))
    queue = (RQueue if pkg == "ref" else PriorityQueue)(now=clock or Clock())
    kw.setdefault("deterministic", True)
    if pkg == "ref":
        return RScheduler(cache, queue, speculate=False, columnar_cache=False, **kw)
    return Scheduler(cache, queue, device="cpu", **kw)


def drain(sched, rounds=8):
    """Batches until one does nothing, then the clock steps past the
    backoff and the unschedulable pods move back; `rounds` times at most.
    Returns the assignments."""
    out = {}
    clock = sched.queue._now
    for _ in range(rounds):
        for _ in range(200):
            r = sched.schedule_batch()
            sched.wait_for_binds()
            out.update(r.assignments)
            if not (r.scheduled or r.unschedulable or r.deferred):
                break
        if not sum(sched.queue.counts()):
            break
        clock.t += 11.0
        sched.queue.move_all_to_active()
    return out


def counters(sched):
    return {k: sched.stats.get(k, 0) for k in PLANE_COUNTERS + ("batches",)}


def scenario_drain(pkg, scenario, **kw):
    t = RT if pkg == "ref" else PT
    if scenario == "preemption":
        node_list = nodes(t, 3, cpu=1000)
        existing = [make_pod(t, f"victim{i}", 900, node_name=nd.name, priority=0) for i, nd in enumerate(node_list)]
        make = anti_pod if kw.pop("terms", False) else (lambda t, name, app, cpu: make_pod(t, name, cpu))
        pending = [make(t, f"hi{i}", "hi", 800) for i in range(3)]
        for p in pending:
            p.priority = 1000
        sched = scheduler(pkg, node_list, existing, enable_preemption=True, batch_size=8, **kw)
        for p in pending:
            sched.queue.add(p)
        got = drain(sched)
    elif scenario == "churn":
        sched = scheduler(pkg, nodes(t, 4, zones=2), enable_preemption=False, batch_size=8, **kw)
        for i in range(8):
            sched.queue.add(spread_pod(t, f"s{i}", f"sp{i % 2}"))
        got = dict(sched.schedule_batch().assignments)
        sched.wait_for_binds()
        sched.cache.remove_node("n3")
        sched.cache.add_node(make_node(t, "n9", labels={HOST: "n9", ZONE: "z1"}))
        for i in range(8, 16):
            sched.queue.add(make_pod(t, f"p{i}", 100) if i % 2 else anti_pod(t, f"a{i}", f"g{i % 4}"))
        got.update(drain(sched))
    else:
        sched = scheduler(pkg, nodes(t, 6, zones=3), enable_preemption=False, batch_size=8, **kw)
        for p in scenario_pods(t, scenario):
            sched.queue.add(p)
        got = drain(sched)
    sched.close()
    return got, counters(sched), sched


# ---------------------------------------------------------------------------
# the slab, the gather and the scatter
# ---------------------------------------------------------------------------

def seeded_slab(template, s, seed):
    """A slab dict shaped like `template`'s arrays at S rows, filled from a
    numpy seed with every dtype's range (int64 extremes included), and a
    one-row padding dict of different values."""
    rng = np.random.default_rng(seed)
    slab, empty = {}, {}
    for k, v in template.items():
        shape = (s,) + v.shape[1:]
        if v.dtype == bool:
            slab[k] = rng.random(shape) < 0.5
        elif v.dtype == np.int64:
            slab[k] = rng.integers(-(2**62), 2**62, shape, dtype=np.int64)
            slab[k].flat[0] = np.iinfo(np.int64).min
            slab[k].flat[-1] = np.iinfo(np.int64).max
        else:
            slab[k] = rng.integers(-(2**31), 2**31 - 1, shape, dtype=v.dtype)
        empty[k] = np.asarray(v[:1]).copy()
    return slab, empty


def lanes(rng, s, u, n_live):
    idx = np.zeros(u, np.int32)
    idx[:n_live] = rng.integers(0, s, n_live)
    idx[: min(3, n_live)] = idx[0]  # repeated rows
    keep = np.zeros(u, bool)
    keep[:n_live] = True
    return idx, keep


def ref_dict(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def assert_same(ref, port):
    assert sorted(ref) == sorted(port)
    for k in ref:
        r = np.asarray(ref[k])
        p = port[k].numpy() if isinstance(port[k], torch.Tensor) else np.asarray(port[k])
        assert r.dtype == p.dtype and r.shape == p.shape, k
        assert np.array_equal(r, p), k


def walk_batch(problems):
    """csrc/slab.cu's batch gather, CTA by CTA and thread by thread, over
    the host's GatherPlan of `problems` (CPU tensors): the lane region as
    the wrapper writes it (GatherPlan.fill: rows = keep ? idx : -1, the
    columns' final bytes), each CTA's segment by the kernel's binary search
    of first_cta, each thread's words from one division and the segment's
    row and word steps, every field read from the argument block the
    launch passes (`plan.args`). Returns (each problem's output dict as numpy arrays, the number
    of kernel writes of every buffer byte)."""
    lens = [len(np.asarray(p.idx)) for p in problems]
    plan = SL.GatherPlan(problems, lens)
    buf = np.zeros(plan.nbytes, np.uint8)
    writes = np.zeros(plan.nbytes, np.int64)
    plan.fill(buf[: plan.host_bytes], [SL.host_lanes(p) for p in problems])
    a = plan.args  # the kernel's argument block, as the launch passes it
    for b in range(a.n_ctas):
        lo, hi = 0, a.n_segments - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if a.first_cta[mid] <= b else (lo, mid - 1)
        seg, j, k = a.seg[lo], plan.segments[lo][0], plan.segments[lo][1]
        wb, words, rw = 1 << seg.log_word, SL.CHUNK_BYTES >> seg.log_word, seg.row_words
        src = problems[j].slab[k].numpy().view(np.uint8).reshape(-1)
        pad = problems[j].empty[k].numpy().view(np.uint8).reshape(-1)
        assert (seg.src, seg.empty) == (problems[j].slab[k].data_ptr(), problems[j].empty[k].data_ptr())
        rows = buf[seg.rows :].view(np.int32)
        chunk = b - a.first_cta[lo]
        end = min((chunk + 1) * words, seg.n_words)
        for t in range(SL.THREADS):
            w = chunk * words + t
            if w >= end:
                continue
            ln = w // rw
            c = w - ln * rw
            while w < end:
                r = int(rows[ln])
                word = src[(r * rw + c) * wb : (r * rw + c + 1) * wb] if r >= 0 else pad[c * wb : (c + 1) * wb]
                buf[seg.dst + w * wb : seg.dst + (w + 1) * wb] = word
                writes[seg.dst + w * wb : seg.dst + (w + 1) * wb] += 1
                ln, c = ln + seg.step_rows, c + seg.step_words
                if c >= rw:
                    c, ln = c - rw, ln + 1
                w += SL.THREADS
    outs = plan.views(torch.from_numpy(buf))
    return [{k: v.numpy() for k, v in o.items()} for o in outs], writes


def walk_gather(slab, idx, keep, empty, col=None, col_key=None, masked=True):
    """csrc/slab.cu's batch gather walked in Python (walk_batch) for one
    problem: numpy arrays in, numpy arrays out."""
    prob = SL.GatherProblem(arrays_to_torch(slab, "cpu", copy=True), arrays_to_torch(empty, "cpu", copy=True), idx,
                            keep, col, col_key, masked)
    return walk_batch([prob])[0][0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_stage_plain_matches_reference(seed):
    rng = np.random.default_rng(seed)
    template = PodBatch(Vocab(), 1).arrays()
    s, u = (37, 64) if seed else (256, 128)
    slab, empty = seeded_slab(template, s, seed)
    idx, keep = lanes(rng, s, u, u - 9)
    fb = rng.random(u) < 0.3
    ref = r_gather_stage(ref_dict(slab), jnp.asarray(idx), jnp.asarray(keep), ref_dict(empty), jnp.asarray(fb))
    bank, emp = arrays_to_torch(slab, "cpu"), arrays_to_torch(empty, "cpu")
    plain = gather_stage_plain(bank, torch.from_numpy(idx), torch.from_numpy(keep), emp, torch.from_numpy(fb))
    assert_same(ref, plain)
    assert_same(ref, gather_stage(bank, idx, keep, emp, fb))  # the wrapper's CPU path
    assert gather_stage.launches == 0


def test_slab_kernel_walk_matches_plain_gather():
    """csrc/slab.cu's batch gather, walked in Python, equals the plain
    gather: every word width (int64 rows, int32 rows not a multiple of 8
    bytes, bool rows of odd length), padding lanes, repeated rows, the
    shipped override column."""
    rng = np.random.default_rng(5)
    template = PodBatch(Vocab(), 1).arrays()
    slab, empty = seeded_slab(template, 9, 5)
    idx, keep = lanes(rng, 9, 12, 8)
    col = rng.integers(0, 2, 12).astype(np.int32)
    bank, emp = arrays_to_torch(slab, "cpu"), arrays_to_torch(empty, "cpu")
    want = gather_stage_plain(bank, torch.from_numpy(idx), torch.from_numpy(keep), emp,
                              torch.from_numpy(col.astype(bool)))
    got = walk_gather(slab, idx, keep, empty, col, "fallback", masked=False)
    assert_same(got, want)
    widths = {v[0].nbytes % 8 == 0 for v in slab.values()} | {v[0].nbytes % 4 == 0 for v in slab.values()}
    assert widths == {True, False}


def test_gather_checks_indices_on_the_host():
    template = PodBatch(Vocab(), 1).arrays()
    slab, empty = seeded_slab(template, 8, 0)
    bank, emp = arrays_to_torch(slab, "cpu"), arrays_to_torch(empty, "cpu")
    with pytest.raises(IndexError, match="out of range"):
        gather_stage(bank, np.array([0, 8], np.int32), np.ones(2, bool), emp, np.zeros(2, bool))
    with pytest.raises(ValueError, match="1-D"):
        gather_stage(bank, np.zeros((2, 2), np.int32), np.ones(2, bool), emp, np.zeros(2, bool))
    with pytest.raises(IndexError, match="out of range"):
        SL.scatter_rows(bank, np.array([-1]), {k: v[:1] for k, v in slab.items()})


def _pods(t, seed):
    """A random cluster's pending pods, every third followed by a replica
    (same spec, another name)."""
    _, _, pending = random_cluster(seed, 20, 60, t=t, pins=True)
    out = []
    for i, p in enumerate(pending):
        out.append(p)
        if i % 3 == 0:
            out.append(dataclasses.replace(p, name=p.name + "-r", uid=p.uid + "-r"))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_pod_stage_matches_reference_and_gather_equals_legacy_batch(seed):
    """The port's PodStage and the reference's, fed the same pods, hold the
    same slab (interning replicas on one row); gathering the reps' rows
    (with repeats and padding) equals the legacy PodBatch of those reps,
    fallback included, and the reference's gather of its own slab."""
    pp, rp = _pods(PT, seed), _pods(RT, seed)
    ps, rs = p_stage_mod.PodStage(Vocab()), r_stage_mod.PodStage(RVocab())
    pairs = [ps.acquire(p) for p in pp]
    assert pairs == [rs.acquire(p) for p in rp]
    assert ps.stats == rs.stats and ps.stats["hits"] > 0
    assert_same(rs.batch.arrays(), arrays_to_torch(ps.batch.arrays(), "cpu"))
    assert_same(rs.empty_rows, arrays_to_torch(ps.empty_rows, "cpu"))
    reps, rows = [], []
    for p, (row, _) in zip(pp, pairs):
        if row not in rows:
            reps.append(p)
            rows.append(row)
    u = 64
    idx = np.zeros(u, np.int32)
    idx[: len(rows)] = rows
    keep = np.arange(u) < len(rows)
    fb = np.zeros(u, bool)
    fb[: len(rows)] = ps.batch.fallback[rows]
    bank, emp = arrays_to_torch(ps.batch.arrays(), "cpu", copy=True), arrays_to_torch(ps.empty_rows, "cpu")
    got = gather_stage(bank, idx, keep, emp, fb)
    legacy = PodBatch(ps.vocab, u)
    for i, p in enumerate(reps):
        legacy.set_pod(i, p)
    assert_same(legacy.arrays(), got)
    ref = r_gather_stage(ref_dict(rs.batch.arrays()), jnp.asarray(idx), jnp.asarray(keep), ref_dict(rs.empty_rows),
                         jnp.asarray(fb))
    assert_same(ref, got)


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicates"])
def test_scatter_plain_matches_reference(dup):
    """A flush of dirty rows through the plain scatter equals the
    reference's `_scatter_fn()` on the same rows (padded, as the reference
    pads a chunk, with repeats of its first row)."""
    rng = np.random.default_rng(7)
    template = PodBatch(Vocab(), 1).arrays()
    slab, _ = seeded_slab(template, 40, 7)
    upd, _ = seeded_slab(template, 6, 8)
    rows = np.array([3, 17, 17, 0, 39, 22] if dup else [3, 17, 8, 0, 39, 22], np.int64)
    if dup:
        for v in upd.values():
            v[2] = v[1]  # a duplicate index carries identical bytes
    padded = np.concatenate([rows, np.full(10, rows[0])])
    ref_upd = {k: np.concatenate([v, np.repeat(v[:1], 10, 0)]) for k, v in upd.items()}
    ref = r_scatter_fn()(ref_dict(slab), jnp.asarray(padded.astype(np.int32)), ref_dict(ref_upd))
    truth = {k: v.copy() for k, v in slab.items()}  # host truth holding the dirty rows
    for k, v in truth.items():
        v[rows] = upd[k]
    bank = arrays_to_torch(slab, "cpu", copy=True)
    SL.scatter_rows(bank, rows, truth)
    assert_same(ref, bank)
    SL.scatter_rows(bank, np.zeros(0, np.int64), truth)  # no dirty row
    assert_same(ref, bank)
    assert SL.scatter_rows.launches == 0
    del rng


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicates"])
def test_multi_problem_scatter_matches_reference_scatter_fn(dup):
    """One scatter_batch call patching a pod slab and a term slab (the two
    planes' flushes as one call), the rows taken from the host slabs,
    equals the reference's `_scatter_fn()` on each slab, with repeated rows
    too (they carry identical bytes); the one-problem scatter_rows equals
    it too."""
    from kubernetes_tpu_torch.state.terms import TermBank

    slab, _ = seeded_slab(PodBatch(Vocab(), 1).arrays(), 40, 11)
    term, _ = seeded_slab(TermBank(Vocab(), 1).arrays(), 24, 12)
    host_s, _ = seeded_slab(PodBatch(Vocab(), 1).arrays(), 40, 13)
    host_t, _ = seeded_slab(TermBank(Vocab(), 1).arrays(), 24, 14)
    rows_s, rows_t = (np.array([39, 0, 17, 0, 4]), np.array([5, 23, 5])) if dup else (np.array([39, 0, 17, 4]),
                                                                                       np.array([5, 23]))
    tw_s, tw_t = arrays_to_torch(slab, "cpu", copy=True), arrays_to_torch(term, "cpu", copy=True)
    SL.scatter_batch([SL.ScatterProblem(tw_s, rows_s, host_s), SL.ScatterProblem(tw_t, rows_t, host_t)])
    for got, base, host, rows in ((tw_s, slab, host_s, rows_s), (tw_t, term, host_t, rows_t)):
        ref = r_scatter_fn()(ref_dict(base), jnp.asarray(rows.astype(np.int32)),
                             {k: jnp.asarray(v[rows]) for k, v in host.items()})
        assert_same(ref, got)
        one = arrays_to_torch(base, "cpu", copy=True)
        SL.scatter_rows(one, rows, host)
        assert_same(ref, one)
    assert SL.scatter_batch.launches == SL.scatter_rows.launches == 0


def test_stage_bank_flush_takes_host_truth_in_one_problem(monkeypatch):
    """A plane's flush is one problem of the scatter, its rows taken from
    the host slab by the scatter itself (no staged copy built first): one
    call a flush, naming exactly the dirty rows."""
    calls = []
    real = bank_mod.scatter_rows

    def spy(slab, rows, host):
        calls.append((list(rows), host is ps.batch.arrays() or set(host) == set(slab)))
        return real(slab, rows, host)

    monkeypatch.setattr(bank_mod, "scatter_rows", spy)
    pp = _pods(PT, 6)
    ps = p_stage_mod.PodStage(Vocab())
    pb = StageBank(ps, "cpu")
    for p in pp[:10]:
        ps.acquire(p)
    pb.current_arrays()  # the full upload
    dirty = sorted({ps.acquire(p)[0] for p in pp[10:20]})
    pb.current_arrays()
    assert calls == [(dirty, True)]
    assert pb.device_divergence() == []


def test_stage_bank_flush_matches_reference_bank():
    """The device twin after a full upload, then dirty-row flushes, equals
    the reference bank's and the host slab (live rows)."""
    pp, rp = _pods(PT, 5), _pods(RT, 5)
    ps, rs = p_stage_mod.PodStage(Vocab()), r_stage_mod.PodStage(RVocab())
    pb, rb = StageBank(ps, "cpu"), RStageBank(rs)
    for part in (slice(0, 20), slice(20, 45), slice(45, 60)):
        for p, r in zip(pp[part], rp[part]):
            ps.acquire(p)
            rs.acquire(r)
        pdev, pemp = pb.current_arrays()
        rdev, remp = rb.current_arrays(sync=True)
        assert_same(rdev, pdev)
        assert_same(remp, pemp)
    assert pb.stats["full_uploads"] == rb.stats["full_uploads"] == 1
    assert pb.stats["sync_rows"] == rb.stats["sync_rows"] > 0
    assert pb.device_divergence() == [] == rb.device_divergence()


# ---------------------------------------------------------------------------
# drains: the port's default Scheduler against the reference's, planes on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["ingest-mixed", "anti", "ingest-gang", "preemption", "churn"])
def test_drain_matches_reference_with_planes_on(scenario):
    ref, ref_counts, _ = scenario_drain("ref", scenario)
    port, port_counts, sched = scenario_drain("port", scenario)
    assert port == ref and port_counts == ref_counts
    assert port_counts["ingest_index_batches"] > 0 and port_counts["term_index_batches"] > 0
    assert sched.stage_bank.device_divergence() == [] == sched.term_bank.device_divergence()
    off, off_counts, _ = scenario_drain("port", scenario, ingest_plane=False, term_plane=False)
    assert off == port and not any(off_counts[k] for k in PLANE_COUNTERS)
    if scenario == "preemption":
        assert len(port) == 3


# ---------------------------------------------------------------------------
# staleness, growth and no detour
# ---------------------------------------------------------------------------

def _update_case(pkg):
    t = RT if pkg == "ref" else PT
    sched = scheduler(pkg, nodes(t, 4), enable_preemption=False, batch_size=8)
    blocked = make_pod(t, "u0")
    blocked.node_selector = {"no-such-label": "x"}  # fits nowhere
    sched.queue.add(blocked)
    fixed = make_pod(t, "u0")  # same key, the selector gone
    sched.queue.update(blocked, fixed)
    got = drain(sched)
    sched.close()
    return got, counters(sched)


def test_update_between_enqueue_and_pop_uses_new_content():
    got, c = _update_case("port")
    assert got == {"default/u0": got.get("default/u0")} and got["default/u0"]
    assert (got, c) == _update_case("ref")


def _delete_case(pkg):
    t = RT if pkg == "ref" else PT
    sched = scheduler(pkg, nodes(t, 4), enable_preemption=False, batch_size=8)
    lone = make_pod(t, "lone", labels={"only": "holder"})
    sched.queue.add(lone)
    infos = sched.queue.pop_batch(8)
    assert len(infos) == 1 and infos[0].staged_row >= 0
    row, gen = infos[0].staged_row, infos[0].staged_gen
    sched.queue.delete(lone)  # the last holder: the row frees
    assert not sched.stage.valid_pair(row, gen)
    out = sched._device_solve(infos) if pkg == "ref" else sched._solve_batch(infos, [""], False)
    sched.close()
    return int(out.assign[0]), counters(sched)


def test_delete_between_pop_and_dispatch_restages():
    port = _delete_case("port")
    assert port[0] >= 0 and port[1]["ingest_stale_rows"] == port[1]["ingest_restaged"] == 1
    assert port[1]["ingest_index_batches"] == 1
    ref = _delete_case("ref")
    assert port[0] == ref[0] and port[1] == {**ref[1], "batches": 0}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_slab_overflow_grows_capacity_and_invalidates(pkg, monkeypatch):
    mod, t, vocab = (p_stage_mod, PT, Vocab) if pkg == "port" else (r_stage_mod, RT, RVocab)
    monkeypatch.setattr(mod, "MIN_CAPACITY", 4)
    st = mod.PodStage(vocab(), capacity=4)
    pairs = [st.acquire(make_pod(t, f"d{i}", 100 + i)) for i in range(4)]
    assert all(p is not None for p in pairs)
    p5 = st.acquire(make_pod(t, "d4", 999))
    assert p5 is not None and st.capacity == 8
    assert st.stats["overflows"] == 1 and st.stats["rebuilds"] == 1
    assert all(not st.valid_pair(r, g) for r, g in pairs)


def test_pod_refcount_lifecycle_matches_reference():
    out = {}
    for pkg, mod, t, vocab in (("port", p_stage_mod, PT, Vocab), ("ref", r_stage_mod, RT, RVocab)):
        st = mod.PodStage(vocab())
        a, b = make_pod(t, "r0"), make_pod(t, "r1")  # replicas: one row
        pa, pb = st.acquire(a), st.acquire(b)
        assert pa == pb and st.refs[pa[0]] == 2
        st.release(*pa)
        live = st.valid_pair(*pa)
        st.release(*pa)  # the last holder: the row frees
        st.release(*pa)  # a stale release is a no-op
        again = st.acquire(make_pod(t, "r2"))
        lingering = st.ensure_row(make_pod(t, "x", 300))
        out[pkg] = (pa, live, st.valid_pair(*pa), again, lingering, int(st.refs[lingering[0]]), dict(st.stats))
    assert out["port"] == out["ref"] and out["port"][1] and not out["port"][2]


def _ceiling_case(pkg, monkeypatch):
    t = RT if pkg == "ref" else PT
    sched = scheduler(pkg, nodes(t, 4), enable_preemption=False, batch_size=8)
    for i in range(6):
        sched.queue.add(make_pod(t, f"p{i}", 100 + i))
    # every pair stale and no restage possible: the batch takes the legacy path
    monkeypatch.setattr(sched.stage, "ensure_row", lambda pod: None)
    for info in list(sched.queue._infos.values()):  # every entry is pending here
        info.staged_row = -1
    got = drain(sched)
    sched.close()
    return got, counters(sched)


def test_slab_ceiling_takes_the_legacy_path(monkeypatch):
    port = _ceiling_case("port", monkeypatch)
    assert len(port[0]) == 6 and port[1]["ingest_legacy_batches"] >= 1 and port[1]["ingest_stale_rows"] >= 1
    assert port == _ceiling_case("ref", monkeypatch)


def test_prologue_bails_when_the_slab_rebuilds_mid_resolve(monkeypatch):
    sched = scheduler("port", nodes(PT, 4), enable_preemption=False, batch_size=8)
    for i in range(4):
        sched.queue.add(make_pod(PT, f"p{i}", 100 + i))
    infos = sched.queue.pop_batch(8)
    infos[-1].staged_row = -1  # one stale rep, resolved after the others
    real = sched.stage.ensure_row

    def growing(pod):
        sched.stage._rebuild(sched.stage.capacity * 2)
        return real(pod)

    monkeypatch.setattr(sched.stage, "ensure_row", growing)
    assert sched._stage_prologue([pi.pod for pi in infos], infos) is None
    monkeypatch.setattr(sched.stage, "ensure_row", real)
    out = sched._solve_batch(infos, [""] * 4, False)  # the next dispatch re-stages everything
    assert all(a >= 0 for a in out.assign)
    assert sched.stats["ingest_index_batches"] == 1 and sched.stats["ingest_restaged"] == 1 + 4
    sched.close()


def _width_case(pkg):
    t = RT if pkg == "ref" else PT
    sched = scheduler(pkg, nodes(t, 4), enable_preemption=False, batch_size=8)
    for i in range(4):
        sched.queue.add(make_pod(t, f"p{i}"))
    gen0 = sched.stage.generation
    n1 = drain(sched)
    # more distinct label keys than the vocab's K = 64: the widths grow
    sched.cache.add_node(make_node(t, "wide", labels={f"k{j}": "v" for j in range(70)}))
    for i in range(4, 8):
        sched.queue.add(make_pod(t, f"p{i}"))
    n2 = drain(sched)
    assert len(n1) + len(n2) == 8
    assert sched.stage.generation > gen0 and sched.stage.key_capacity == sched.mirror.vocab.config.key_slots
    assert sched.tstage.key_capacity == sched.mirror.vocab.config.key_slots
    sched.close()
    return {**n1, **n2}, counters(sched), sched.stage.generation - gen0


def test_vocab_width_growth_rebuilds_the_slabs_and_self_heals():
    port = _width_case("port")
    assert port[1]["ingest_index_batches"] >= 2
    assert port == _width_case("ref")


def test_queue_requeue_and_unschedulable_keep_one_reference():
    sched = scheduler("port", nodes(PT, 2), enable_preemption=False, batch_size=8)
    q, st = sched.queue, sched.stage
    q.add(make_pod(PT, "rq"))
    info = q.pop_batch(1)[0]
    row, gen = info.staged_row, info.staged_gen
    assert st.refs[row] == 1
    q.requeue([info])
    assert (info.staged_row, info.staged_gen) == (row, gen) and st.refs[row] == 1
    info = q.pop_batch(1)[0]
    q.add_unschedulable(info)
    assert (info.staged_row, info.staged_gen) == (row, gen) and st.refs[row] == 1
    q.delete(info.pod)
    assert not st.valid_pair(row, gen)
    sched.close()


@pytest.mark.parametrize("where", ["gather", "flush"])
def test_a_failing_gather_or_flush_raises_with_the_batch_requeued(where, monkeypatch):
    """No detour: a plane failure is not turned into the legacy path. The
    error surfaces from schedule_batch, the batch is back in the queue, and
    the next batch (the failure gone) places everything."""
    sched = scheduler("port", nodes(PT, 4), enable_preemption=False, batch_size=8)
    for i in range(6):
        sched.queue.add(make_pod(PT, f"p{i}", 100 + i))
    sched.schedule_batch() if where == "flush" else None  # the twin resident: later rows flush by scatter
    for i in range(6, 10):
        sched.queue.add(make_pod(PT, f"p{i}", 100 + i))
    pending = sum(sched.queue.counts())

    def boom(*a, **k):
        raise RuntimeError("injected")

    if where == "gather":
        monkeypatch.setattr(D, "gather_batch", boom)
    else:
        monkeypatch.setattr(bank_mod, "scatter_rows", boom)
    with pytest.raises(RuntimeError, match="injected"):
        sched.schedule_batch()
    assert sum(sched.queue.counts()) == pending
    assert sched.stats["ingest_legacy_batches"] == 0
    monkeypatch.undo()
    got = drain(sched)
    assert len(got) == pending
    sched.close()


def _growth_case(pkg):
    """600 distinct specs admitted to a running scheduler, each with a
    spread term of its own: both slabs grow during admission (256 -> 512),
    the pairs staged before the growth re-stage at their first dispatch,
    and a restage that fills the slab grows it mid-resolve (the one legacy
    batch), then the drain is covered again."""
    t = RT if pkg == "ref" else PT
    sched = scheduler(pkg, nodes(t, 40, zones=4, cpu=64000), enable_preemption=False, batch_size=128)
    for i in range(600):
        p = make_pod(t, f"u{i}", 10, {"uniq": f"u{i}"})
        p.topology_spread_constraints = [t.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE, when_unsatisfiable="ScheduleAnyway",
            label_selector=t.LabelSelector(match_labels={"uniq": f"u{i}"}))]
        sched.queue.add(p)
    got = drain(sched)
    sched.close()
    return got, counters(sched), dict(sched.stage.stats), dict(sched.tstage.stats), sched.stage.capacity


def test_slab_growth_drain_matches_reference():
    port = _growth_case("port")
    c = port[1]
    assert len(port[0]) == 600 and port[2]["rebuilds"] >= 2 and port[3]["rebuilds"] >= 2
    assert 1 <= c["ingest_legacy_batches"] <= port[2]["rebuilds"] and c["stage_sync_flushes"] > 0
    assert c["ingest_index_batches"] + c["ingest_legacy_batches"] == c["batches"]
    assert c["term_index_batches"] + c["term_legacy_batches"] == c["batches"]
    assert port == _growth_case("ref")
