"""The port's commit plane on the CPU against `kubernetes_tpu`'s:

* `arbitrate` (the plain version, and csrc/arbiter.cu's algorithm walked
  in Python) against the JAX `arbitrate` on the exact arrays the
  reference driver hands it, on the reference's verdict workloads
  (tests/test_commit_plane.py: anti-heavy seeds 0-2, DoNotSchedule spread,
  host ports, the -1 could-fit case) and a random cluster carrying every
  covered kind, with and without a residual carry;
* `spread_filter` against the JAX `spread_filter` on seeded clusters and
  on one built for its branches (max_skew 1 and 3, two constraints of one
  pod on one key, nodes missing the key, an empty pair map), at V = 16
  and V = N; and csrc/topology.cu's cluster kernel walked in Python (C =
  1, 3, 8, 16 CTAs a spec row, V = 16, 64, 40,000, signature windows)
  against the plain version's mask and tables and the JAX arbiter's;
* the driver's arbitrated route: the arbiter reads its batch's solve
  intermediates (equal to what it computes alone), and an already-assumed
  key fails its pod while the rest of the batch is applied.

Tolerance: exact equality; every value is an integer."""


import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.commit.arbiter as RA
from kubernetes_tpu.api import types as RT
from kubernetes_tpu.models.generators import make_node, make_pod
from kubernetes_tpu.ops import filters as RF
from kubernetes_tpu.ops import topology as RTopo
from kubernetes_tpu.oracle.nodeinfo import Snapshot
from kubernetes_tpu.scheduler.driver import Scheduler as RScheduler
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.queue import PriorityQueue as RQueue
from kubernetes_tpu.state.tensors import PodBatch as RPodBatch
from kubernetes_tpu.state.tensors import encode_snapshot as r_encode
from kubernetes_tpu.state.terms import compile_batch_terms as r_compile

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.commit import arbiter as PA
from kubernetes_tpu_torch.models.clusters import HOST_KEY, ZONE_KEY, fill_cache, random_cluster
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.ops import topology as PTopo
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.scheduler import driver as D
from kubernetes_tpu_torch.scheduler.driver import Scheduler
from kubernetes_tpu_torch.state.queue import PriorityQueue
from kubernetes_tpu_torch.state.terms import ANTI_REQ, SPREAD_HARD

ZONE = "zone"


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _tc(d):
    return arrays_to_torch(_np(d), "cpu")


# ---------------------------------------------------------------------------
# arbitrate: the reference's verdict workloads, through its own driver
# ---------------------------------------------------------------------------

def _nodes(n, zones=0, cpu=4000):
    out = []
    for i in range(n):
        labels = {HOST_KEY: f"n{i}"}
        if zones:
            labels[ZONE] = f"z{i % zones}"
        out.append(make_node(f"n{i}", cpu_milli=cpu, labels=labels))
    return out


def _anti_pod(name, app, cpu=100):
    p = make_pod(name, cpu_milli=cpu, labels={"app": app})
    p.affinity = RT.Affinity(pod_anti_affinity=RT.PodAntiAffinity(required=[RT.PodAffinityTerm(
        label_selector=RT.LabelSelector(match_labels={"app": app}), topology_key=HOST_KEY)]))
    return p


def _spread_pod(name, app, max_skew=1, cpu=50):
    p = make_pod(name, cpu_milli=cpu, labels={"app": app})
    p.topology_spread_constraints = [RT.TopologySpreadConstraint(
        max_skew=max_skew, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=RT.LabelSelector(match_labels={"app": app}))]
    return p


def _port_pod(name, port, cpu=50):
    p = make_pod(name, cpu_milli=cpu)
    p.containers[0].ports = [RT.ContainerPort(host_port=port)]
    p.__dict__.pop("_host_ports_memo", None)
    return p


def _workload(name):
    """(nodes, existing pods, pending pods) of one verdict workload."""
    if name.startswith("anti-heavy"):
        import random

        rng = random.Random(int(name[-1]))
        pods = [_anti_pod(f"a{i}", app=f"g{rng.randrange(2)}") if rng.random() < 0.6
                else make_pod(f"p{i}", cpu_milli=100) for i in range(12)]
        return _nodes(4), [], pods
    if name == "hard-spread":
        return _nodes(4, zones=2), [], [_spread_pod(f"s{i}", app="web") for i in range(6)]
    if name == "host-ports":
        pods = [_port_pod(f"hp{i}", port=8080) for i in range(4)]
        return _nodes(2), [], pods + [make_pod(f"f{i}", cpu_milli=50) for i in range(2)]
    if name == "could-fit":
        return _nodes(2, zones=2, cpu=300), [], [_spread_pod(f"s{i}", app="web", cpu=100) for i in range(8)]
    # every covered kind at once: required anti-affinity, host ports,
    # DoNotSchedule and ScheduleAnyway spread, preferred (anti-)affinity,
    # existing pods with affinity
    nodes, existing, pending = random_cluster(int(name[-1]), 40, 90, 60, t=RT, pins=False, topology=True,
                                              hard_spread=True, interpod=True, pending_affinity=False,
                                              pending_ports=True)
    return nodes, existing, pending


def _captured_arbitrate(workload, monkeypatch):
    """Run one batch of `workload` through the reference Scheduler with
    the commit plane on and capture the arguments and verdicts of its
    `arbitrate` call."""
    nodes, existing, pods = _workload(workload)
    cache = RCache()
    fill_cache(cache, nodes, existing)
    sched = RScheduler(cache, RQueue(), deterministic=True, commit_plane=True, fold_plane=True, speculate=False,
                       ingest_plane=False, term_plane=False, columnar_cache=False, enable_preemption=False,
                       batch_size=len(pods))
    calls = []
    real = RA.arbitrate
    driver = threading.get_ident()

    def spy(*args, **kw):
        out = real(*args, **kw)
        if threading.get_ident() != driver:
            # another thread's call (a reference warm-up service another
            # test left running in this process): not this batch's dispatch
            return out
        # copied now: the reference's fold donates the node bank's buffers
        host = [_np(a) if isinstance(a, dict) else np.asarray(a) for a in args]
        calls.append((host, {**kw, "pb": _np(kw["pb"])}, np.asarray(out)))
        return out

    monkeypatch.setattr(RA, "arbitrate", spy)
    for p in pods:
        sched.queue.add(p)
    sched.schedule_batch()
    sched.wait_for_binds()
    sched.close()
    assert len(calls) == 1, "the reference did not dispatch its arbiter"
    (na, pa, ea, ta, ids, assign), kw, out = calls[0]
    return dict(na=na, pa=pa, ea=ea, ta=ta, ids=ids, assign=assign, pb=kw["pb"],
                term_kinds=kw["term_kinds"], n_buckets=kw["n_buckets"], verdicts=out)


def _carry(c, seed):
    """A residual carry (free, count, nz) as a previous batch would leave
    it: some nodes' requests and pod counts raised."""
    rng = np.random.default_rng(seed)
    na = _np(c["na"])
    free = na["alloc"] - na["requested"]
    hit = rng.random(free.shape[0]) < 0.5
    free = free - np.where(hit[:, None], (free * rng.random(free.shape) * 0.9).astype(np.int64), 0)
    count = na["pod_count"] + hit.astype(na["pod_count"].dtype) * rng.integers(0, 3, free.shape[0]).astype(
        na["pod_count"].dtype)
    return free, count, na["nonzero_req"]


def _port_args(c):
    return (_tc(c["na"]), _tc(c["pa"]), _tc(c["ea"]), _tc(c["ta"]), {k: int(v) for k, v in c["ids"].items()},
            torch.from_numpy(np.array(c["assign"])), _tc(c["pb"]))


WORKLOADS = ["anti-heavy-0", "anti-heavy-1", "anti-heavy-2", "hard-spread", "host-ports", "could-fit",
             "random-7", "random-8"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_arbitrate_matches_reference(workload, monkeypatch):
    c = _captured_arbitrate(workload, monkeypatch)
    got = PA.arbitrate(*_port_args(c), term_kinds=c["term_kinds"], n_buckets=c["n_buckets"])
    assert np.array_equal(got.numpy(), c["verdicts"])
    n = int(np.asarray(c["pb"]["valid"]).sum())
    if workload == "hard-spread":  # the reference's own assertion: arbitration deferred
        assert PA.V_DEFER in got.numpy()[:n].tolist()
    if workload.startswith("random"):
        assert {"anti_req", "spread_hard"} <= set(c["term_kinds"])
        assert PA.V_PLACE in got.numpy()[:n].tolist()


@pytest.mark.parametrize("workload", ["anti-heavy-1", "hard-spread", "host-ports", "random-7"])
@pytest.mark.parametrize("spread", [True, False], ids=["spread-kinds", "no-spread-kinds"])
def test_arbitrate_with_carry_matches_reference(workload, spread, monkeypatch):
    """With a residual carry, and with the term kinds with / without
    spread_hard (the scan's spread part on or off)."""
    c = _captured_arbitrate(workload, monkeypatch)
    kinds = frozenset(c["term_kinds"]) | {"spread_hard"} if spread else frozenset(c["term_kinds"]) - {"spread_hard"}
    carry = _carry(c, 3)
    jx = lambda d: {k: jnp.asarray(x) for k, x in d.items()}  # noqa: E731
    want = RA.arbitrate(
        jx(c["na"]), jx(c["pa"]), jx(c["ea"]), jx(c["ta"]), jx(c["ids"]), jnp.asarray(c["assign"]),
        pb=jx(c["pb"]), carry=tuple(jnp.asarray(x) for x in carry), term_kinds=kinds, n_buckets=c["n_buckets"])
    got = PA.arbitrate(*_port_args(c), carry=tuple(torch.from_numpy(np.array(x)) for x in carry), term_kinds=kinds,
                       n_buckets=c["n_buckets"])
    assert np.array_equal(got.numpy(), np.asarray(want))


def arbiter_cu_walk(na, pa, ea, ta, ids, assign, pb, term_kinds, n_buckets):
    """csrc/arbiter.cu's algorithm in Python, on numpy arrays: the init
    launches (residual copies; per spec row its relevant terms — anti terms
    it owns or matches, hard terms it owns or matches or whose (owner, key)
    group matches it, gm the group's match count — and its port-clashing
    spec rows; per placed pod and relevant term the node's bucket capped
    at V, has-key and candidate bits), then the scan's steps exactly as its
    warp runs them: reads of a [TT, V] table at a node's bucket clamped to
    V - 1, writes at a bucket >= V dropped, the merged counts kept at the
    present values only, and each hard term's minimum over them kept with
    the number of values holding it, recomputed over V only when the last
    of them grows. The hard-spread metadata (candidate nodes, merged
    counts) is the scratch of topology.cu's spread-filter entry, taken
    here from its plain version."""
    t = {k: v.numpy() for k, v in ta.items()}
    n_ = {k: v.numpy() for k, v in na.items()}
    order = PA.pop_order(pb["priority"], torch.arange(pb["sig"].shape[0], dtype=torch.int32),
                         pb["valid"]).numpy()
    sig, pv, asg = pb["sig"].numpy(), pb["valid"].numpy(), assign.numpy()
    u_cap, (n, k) = pa["valid"].shape[0], n_["label_dense"].shape
    tt = t["valid"].shape[0]
    v = n_buckets or n
    big = 2**30
    m_raw = PTopo.match_terms_plain(ta, pa["label_vals"], pa["ns_id"]).numpy()
    pconf = PF.inbatch_port_conflict_plain(pa, ids).numpy()
    req, req_any = pa["req"].numpy(), pa["req_any"].numpy()
    free = (n_["alloc"] - n_["requested"]).astype(np.int64)
    count = n_["pod_count"].astype(np.int64).copy()
    allowed = n_["allowed_pods"].astype(np.int64)
    have_spread = term_kinds is None or "spread_hard" in term_kinds
    hard = t["valid"] & (t["kind"] == SPREAD_HARD) & have_spread
    anti = t["valid"] & (t["kind"] == ANTI_REQ)
    if have_spread:
        sel = PF.pod_match_node_selector(na, pa)
        sp = {key: x.numpy() for key, x in PTopo.spread_hard_tables_plain(na, ea, ta, sel, v).items()}
        present = sp["merged_present"][:, :v].astype(bool)
        mc = np.where(present, sp["merged_cnt"][:, :v].astype(np.int64), big)
    # the init launches: relevant terms and clash lists per spec row
    rel = [[] for _ in range(u_cap)]
    for u in range(u_cap):
        for ti in range(tt):
            m, own = bool(m_raw[ti, u]), t["owner"][ti] == u
            gm = 0
            if hard[ti]:
                gm = sum(int(m_raw[q, u]) for q in range(tt) if hard[q] and t["owner"][q] == t["owner"][ti]
                         and t["topo_slot"][q] == t["topo_slot"][ti])
            if (anti[ti] and (m or own)) or (hard[ti] and (m or own or gm > 0)):
                rel[u].append((ti, m, own, gm))
    conf = [np.flatnonzero(pconf[u]) for u in range(u_cap)]

    def fact(node, ti):
        slot = t["topo_slot"][ti]
        d = n_["label_dense"][node, min(max(slot, 0), k - 1)]
        cand = have_spread and bool(sp["cand"][t["owner"][ti], node])
        return min(max(d, 0), v), bool(d >= 0 and slot >= 0), cand

    def merged_min(ti):
        row = mc[ti][present[ti]]
        if not row.size:
            return big, 0
        return int(row.min()), int((row == row.min()).sum())

    mn, at_min = np.zeros(tt, np.int64), np.zeros(tt, np.int64)
    for ti in np.flatnonzero(hard):
        mn[ti], at_min[ti] = merged_min(ti)
    ca = np.zeros((tt, v), np.int64)
    cb = np.zeros((tt, v), np.int64)
    cs = np.zeros((u_cap, n), np.int64)
    mh = np.zeros(tt, np.int64)
    verdict = np.full(order.shape[0], PA.V_NOFIT, np.int32)
    for p in order:
        if not pv[p]:
            continue
        u, nrow = int(sig[p]), int(asg[p])
        if nrow < 0:
            couldfit = any(own and hard[ti] and mh[ti] > 0 for ti, _, own, _ in rel[u])
            verdict[p] = PA.V_DEFER if couldfit else PA.V_NOFIT
            continue
        facts = [fact(nrow, ti) for ti, _, _, _ in rel[u]]
        cap_ok = (not req_any[u] or bool((req[u] <= free[nrow]).all())) and count[nrow] + 1 <= allowed[nrow]
        blocked = bool((cs[conf[u], nrow] > 0).any())
        sp_bad = any_pair = False
        for (ti, m, own, _), (b, hk, _) in zip(rel[u], facts):
            bc = min(b, v - 1)
            if anti[ti] and hk:
                blocked |= bool(own and ca[ti, bc] > 0) or bool(m and cb[ti, bc] > 0)
            if hard[ti] and own:
                any_pair |= bool(sp["any_pair_t"][ti])
                at_b = mc[ti, bc] if present[ti, bc] else 0
                sp_bad |= not (hk and at_b + int(t["self_match"][ti]) - mn[ti] <= t["weight"][ti])
        ok = cap_ok and not blocked and (not sp_bad or not any_pair)
        verdict[p] = PA.V_PLACE if ok else PA.V_DEFER
        if not ok:
            continue
        free[nrow] -= req[u]
        count[nrow] += 1
        cs[u, nrow] += 1
        for (ti, m, own, gm), (b, hk, cand) in zip(rel[u], facts):
            if anti[ti] and hk and b < v:
                ca[ti, b] += int(m)
                cb[ti, b] += int(own)
            if hard[ti]:
                if cand and gm > 0 and b < v and present[ti, b]:
                    old = mc[ti, b]
                    mc[ti, b] = old + gm
                    if old == mn[ti]:
                        at_min[ti] -= 1
                        if at_min[ti] == 0:  # the last value at the minimum grew
                            mn[ti], at_min[ti] = merged_min(ti)
                mh[ti] += int(m)
    return verdict


@pytest.mark.parametrize("workload", ["anti-heavy-2", "hard-spread", "host-ports", "could-fit", "random-8"])
def test_arbiter_kernel_walk_matches_reference(workload, monkeypatch):
    c = _captured_arbitrate(workload, monkeypatch)
    got = arbiter_cu_walk(*_port_args(c), c["term_kinds"], c["n_buckets"])
    assert np.array_equal(got, c["verdicts"])


def test_kinds_covered_matches_reference():
    for kinds in ({"anti_req", "spread_hard"}, {"pref", "et_score"}, {"aff_req"}, {"anti_req", "aff_req"}, set()):
        assert PA.kinds_covered(kinds) == RA.kinds_covered(kinds)
    assert PA.ARBITER_COVERED_KINDS == RA.ARBITER_COVERED_KINDS
    assert (PA.V_PLACE, PA.V_DEFER, PA.V_NOFIT) == (RA.V_PLACE, RA.V_DEFER, RA.V_NOFIT)


# ---------------------------------------------------------------------------
# spread_filter
# ---------------------------------------------------------------------------

def _branches_cluster(t):
    """Zones z0-z2 on 11 of 12 nodes (node 11 has none), racks on half;
    existing pods of apps a / b (one in another namespace); pending pods:
    max_skew 1 and 3 on the zone, two constraints on the zone key (two
    selectors), one on the rack key (nodes missing it), one on a key no
    node has (an empty pair map), one with a node selector."""
    nodes = []
    for i in range(12):
        labels = {HOST_KEY: f"n{i}"}
        if i < 11:
            labels[ZONE_KEY] = f"z{i % 3}"
        if i % 2 == 0:
            labels["rack"] = f"r{i % 4}"
        alloc = {t.RESOURCE_CPU: t.Quantity.parse("8"), t.RESOURCE_MEMORY: t.Quantity.parse("32Gi"),
                 t.RESOURCE_PODS: t.Quantity.parse(110)}
        nodes.append(t.Node(name=f"n{i}", labels=labels, allocatable=alloc, capacity=dict(alloc)))
    existing = []
    for i in range(20):
        app = "a" if i % 3 else "b"
        existing.append(t.Pod(name=f"e{i}", namespace="other" if i == 7 else "bench",
                              labels={"app": app, "tier": "x" if i % 2 else "y"}, node_name=f"n{(i * 5) % 12}"))

    def con(key, skew, sel):
        return t.TopologySpreadConstraint(max_skew=skew, topology_key=key, when_unsatisfiable="DoNotSchedule",
                                          label_selector=t.LabelSelector(match_labels=sel))

    specs = [
        [con(ZONE_KEY, 1, {"app": "a"})],
        [con(ZONE_KEY, 3, {"app": "a"})],
        [con(ZONE_KEY, 1, {"app": "a"}), con(ZONE_KEY, 2, {"tier": "x"})],
        [con("rack", 1, {"app": "b"})],
        [con("no-such-key", 1, {"app": "a"})],
        [con(ZONE_KEY, 1, {"app": "b"}), con("rack", 1, {"app": "a"})],
        [],
    ]
    pending = []
    for i, cons in enumerate(specs):
        p = t.Pod(name=f"p{i}", namespace="bench", labels={"app": "a" if i % 2 else "b", "tier": "x"},
                  topology_spread_constraints=cons)
        if i == 5:
            p.node_selector = {"rack": "r0"}
        pending.append(p)
    return nodes, existing, pending


@pytest.mark.parametrize("cluster", ["branches", "random-3", "random-4"])
@pytest.mark.parametrize("v", [16, None], ids=["V16", "VN"])
def test_spread_filter_matches_reference(cluster, v):
    if cluster == "branches":
        nodes, existing, pending = _branches_cluster(RT)
    else:
        nodes, existing, pending = random_cluster(int(cluster[-1]), 60, 48, 200, t=RT, topology=True,
                                                  hard_spread=True)
    bank, sigs, _ = r_encode(Snapshot(nodes, existing))
    batch = RPodBatch(bank.vocab, 64)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, _ = r_compile(bank.vocab, pending, b_capacity=64)
    na, ea, ta, pa = bank.arrays(), sigs.arrays(), tb.arrays(), batch.arrays()
    assert (tb.kind[tb.valid] == SPREAD_HARD).any()
    nb = v or na["valid"].shape[0]
    jx = lambda d: {k: jnp.asarray(x) for k, x in d.items()}  # noqa: E731
    want = np.asarray(RTopo.spread_filter(jx(na), jx(ea), jx(ta), RF.pod_match_node_selector(jx(na), jx(pa)),
                                          n_buckets=nb))
    tna, tpa = _tc(na), _tc(pa)
    got = PTopo.spread_filter(tna, _tc(ea), _tc(ta), PF.pod_match_node_selector(tna, tpa), n_buckets=nb)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    # the filter passes and fails somewhere
    rows = len(pending)
    assert want[:rows].any() and not want[:rows].all()


# ---------------------------------------------------------------------------
# csrc/topology.cu's spread filter as its clusters walk it: one cluster of
# C CTAs a spec row, each CTA a node slice and a bucket slice; the row's
# groups (one per topology key) in order; matched signatures with their
# multiplicity in windows; per-CTA, per-warp partial tables summed over the
# cluster; lookups in the owning CTA's slice — held to the plain version
# and to the JAX package's tables
# ---------------------------------------------------------------------------

_NO_KEY = 0x3FFFFFFF


def _wrap32(x):
    return ((int(x) + 2**31) % 2**32) - 2**31


def spread_filter_walk(na, ea, ta, sel, v, cluster, list_cap=None):
    """(mask, tables, layout) of the cluster kernel's algorithm."""
    list_cap = list_cap or PTopo.SPREAD_LIST
    t = {k: x.numpy() for k, x in ta.items()}
    counts = ea["counts"].numpy().astype(np.int64)
    ev = ea["valid"].numpy()
    nv, ld, sel = na["valid"].numpy(), na["label_dense"].numpy(), sel.numpy()
    u_rows, n = sel.shape
    tt, s_n = len(t["valid"]), len(ev)
    lay = PTopo.spread_filter_layout(tt, n, v, cluster)
    c_n, sl, vs, copies = lay["C"], lay["slice"], lay["vslice"], lay["copies"]
    m = PTopo.match_terms_plain(ta, ea["label_vals"], ea["ns_id"]).numpy()  # term_matches in the launch
    hard = t["valid"] & (t["kind"] == SPREAD_HARD)
    slot = t["topo_slot"]
    mask = np.zeros((u_rows, n), bool)
    cand = np.zeros((u_rows, n), bool)
    mcnt = np.full((tt, v), -7, np.int64)  # sentinels: every cell must be written
    mpres = np.full((tt, v), 2, np.int64)
    min_t = np.full(tt, -7, np.int64)
    anyp = np.full(tt, 2, np.int64)
    for u in range(u_rows):
        terms = [q for q in range(tt) if hard[q] and t["owner"][q] == u]  # ascending
        cand[u] = nv & sel[u]
        for q in terms:
            cand[u] &= _bkt_col(ld, slot[q])[1]
        ok = np.ones(n, bool)
        any_row = False
        for i, lead in enumerate(terms):
            if any(slot[terms[j]] == slot[lead] for j in range(i)):
                continue
            group = [q for q in terms[i:] if slot[q] == slot[lead]]
            b, has = _bkt_col(ld, slot[lead])
            bkt = np.where(has, np.minimum(b, v), _NO_KEY)
            # per CTA, per warp copy (device memory: one table)
            pc = np.zeros((c_n, max(copies, 1), v), np.int64)
            pp = np.zeros((c_n, max(copies, 1), v), bool)
            s0 = 0
            while True:
                window = [(s, sum(int(m[q, s]) for q in group)) for s in range(s0, min(s_n, s0 + list_cap)) if ev[s]]
                window = [(s, k) for s, k in window if k]
                if window or s0 == 0:
                    for x in range(n):
                        if not cand[u, x] or bkt[x] >= v:
                            continue
                        c, off = divmod(x, sl)
                        copy = (off % 256 // 32) % max(copies, 1)
                        pc[c, copy, bkt[x]] += sum(k * counts[x, s] for s, k in window)
                        pp[c, copy, bkt[x]] |= s0 == 0
                s0 += list_cap
                if s0 >= s_n:
                    break
            # each CTA sums its bucket slice over the cluster
            slices_c, slices_p, mins, anys = [], [], [], []
            for c in range(c_n):
                lo, hi = min(v, c * vs), min(v, c * vs + vs)
                cs, ps = pc[:, :, lo:hi].sum((0, 1)), pp[:, :, lo:hi].any((0, 1))
                for q in group:
                    mcnt[q, lo:hi], mpres[q, lo:hi] = cs, ps
                slices_c.append(cs)
                slices_p.append(ps)
                mins.append(min([int(x) for x in cs[ps]] + [2**30]))
                anys.append(bool(ps.any()))
            gmin, gany = min(mins), any(anys)
            for q in group:
                min_t[q], anyp[q] = gmin, int(gany)
            any_row |= gany
            for x in range(n):
                if not ok[x]:
                    continue
                if bkt[x] == _NO_KEY:
                    ok[x] = False
                    continue
                bc = min(bkt[x], v - 1)
                r = bc // vs  # the owning CTA's slice
                cn, pr = slices_c[r][bc - r * vs], slices_p[r][bc - r * vs]
                match = int(cn) if pr else 0
                ok[x] = all(_wrap32(match + int(t["self_match"][q]) - gmin) <= t["weight"][q] for q in group)
        mask[u] = ok | (not any_row)
        for q in range(u, tt, u_rows):  # rows no spec row owns
            if not (hard[q] and 0 <= t["owner"][q] < u_rows):
                mcnt[q], mpres[q], min_t[q], anyp[q] = 0, 0, 2**30, 0
    tables = {"cand": cand, "merged_cnt": mcnt, "merged_present": mpres.astype(bool), "min_t": min_t,
              "any_pair_t": anyp.astype(bool)}
    assert (mpres != 2).all() and (anyp != 2).all()
    return mask, tables, lay


def _bkt_col(ld, sl):
    """Every node's (bucket clipped >= 0, has_key) at one term slot."""
    d = ld[:, 0 if sl < 0 else min(sl, ld.shape[1] - 1)].astype(np.int64)
    return np.maximum(d, 0), (d >= 0) & (sl >= 0)


@functools.lru_cache(maxsize=None)
def _spread_refs(cluster, v):
    """The JAX spread_filter's mask and arbiter tables of a case (computed
    once for every cluster size that walks it)."""
    na, ea, ta, pa = _spread_case(cluster)
    jx = lambda d: {k: jnp.asarray(x) for k, x in d.items()}  # noqa: E731
    mask = np.asarray(RTopo.spread_filter(jx(na), jx(ea), jx(ta), RF.pod_match_node_selector(jx(na), jx(pa)),
                                          n_buckets=v))
    bucket_n, haskey_n = RTopo._bucket_of(jx(na), jnp.asarray(ta["topo_slot"]))
    rtb = RA._spread_tables(jx(na), jx(pa), jx(ea), jx(ta), bucket_n, haskey_n, v)
    return mask, {k: np.asarray(rtb[k]) for k in ("merged_cnt0", "merged_present", "cand_t")}


@functools.lru_cache(maxsize=None)
def _spread_case(cluster):
    if cluster == "branches":
        nodes, existing, pending = _branches_cluster(RT)
    else:
        nodes, existing, pending = random_cluster(int(cluster[-1]), 60, 48, 200, t=RT, topology=True,
                                                  hard_spread=True)
    bank, sigs, _ = r_encode(Snapshot(nodes, existing))
    batch = RPodBatch(bank.vocab, 64)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, _ = r_compile(bank.vocab, pending, b_capacity=64)
    na, ea = bank.arrays(), sigs.arrays()
    # cut the node axis past the live nodes to a width no C divides
    n = len(nodes) + 1
    cut = {k: (x[:n] if x.ndim and x.shape[0] == na["valid"].shape[0] else x) for k, x in na.items()}
    return cut, {**ea, "counts": ea["counts"][:n]}, tb.arrays(), batch.arrays()


@pytest.mark.parametrize("v", [16, 64, 40000])
@pytest.mark.parametrize("cluster_ctas", [1, 3, 8, 16])
@pytest.mark.parametrize("cluster", ["branches", "random-3"])
def test_spread_filter_cluster_walk(cluster, cluster_ctas, v):
    """The cluster kernel's algorithm equals spread_filter_plain (mask and
    every table cell, non-hard rows included) and the JAX spread_filter and
    arbiter tables: C = 1, 3, 8 and 16 CTAs a row (N not a multiple of C),
    V = 16 (hostname buckets at or past V dropped and clamped), 64 and
    40,000 (the tables in device memory); rows owning 0, 1 and 2 hard
    terms, on one key and on two."""
    na, ea, ta, pa = _spread_case(cluster)
    tna, tea, tta, tpa = _tc(na), _tc(ea), _tc(ta), _tc(pa)
    sel = PF.pod_match_node_selector(tna, tpa)
    got, tables, lay = spread_filter_walk(tna, tea, tta, sel, v, cluster_ctas)
    want, want_tb = PTopo.spread_filter_plain(tna, tea, tta, sel, v, with_tables=True)
    assert np.array_equal(got, want.numpy())
    for k in ("cand", "merged_cnt", "merged_present", "min_t", "any_pair_t"):
        assert np.array_equal(tables[k], want_tb[k].numpy()), k
    ref, rtb = _spread_refs(cluster, v)
    assert np.array_equal(got, ref)
    hard = ta["valid"] & (ta["kind"] == SPREAD_HARD)
    assert np.array_equal(tables["merged_cnt"][hard], np.asarray(rtb["merged_cnt0"])[hard])
    assert np.array_equal(tables["merged_present"][hard], np.asarray(rtb["merged_present"])[hard])
    assert np.array_equal(tables["cand"][ta["owner"]][hard], np.asarray(rtb["cand_t"])[hard])
    # the walk's shapes: node slices that do not divide N, the device-memory
    # tables at V = 40,000, rows with 0, 1 and 2+ hard terms, one key and two
    n = na["valid"].shape[0]
    assert lay["C"] == cluster_ctas and (cluster_ctas == 1 or n % cluster_ctas != 0)
    assert (lay["copies"] == 0) == (v == 40000)
    per_row = [sorted(ta["topo_slot"][hard & (ta["owner"] == u)].tolist()) for u in range(pa["valid"].shape[0])]
    assert {0, 1} <= {len(r) for r in per_row}
    if cluster == "branches":
        assert any(len(r) >= 2 and len(set(r)) == 1 for r in per_row)
        assert any(len(set(r)) >= 2 for r in per_row)
    else:
        dense = na["label_dense"][:, sorted(set(ta["topo_slot"][hard].tolist()))]
        assert v != 16 or (dense >= v).any()  # buckets past V


@pytest.mark.parametrize("list_cap", [1, 3])
def test_spread_filter_walk_signature_windows(list_cap):
    """Windows of matched signatures (the kernel's SPREAD_LIST, cut to 1
    and 3 here so a row's signatures span several) sum to the same tables."""
    na, ea, ta, pa = _spread_case("random-4")
    tna, tea, tta, tpa = _tc(na), _tc(ea), _tc(ta), _tc(pa)
    sel = PF.pod_match_node_selector(tna, tpa)
    got, tables, _ = spread_filter_walk(tna, tea, tta, sel, 64, 8, list_cap=list_cap)
    want, want_tb = PTopo.spread_filter_plain(tna, tea, tta, sel, 64, with_tables=True)
    assert np.array_equal(got, want.numpy())
    for k in want_tb:
        assert np.array_equal(tables[k], want_tb[k].numpy()), k


def test_spread_filter_layout():
    """The launch's layout: V = 16 takes 8 per-warp table copies and a
    local merged table, the hostname V = 16,384 one copy and lookups in the
    owning CTA's slice, V = 40,000 device memory; a CTA's node states past
    the budget double the cluster; the bytes are the kernel's formula."""
    lay = PTopo.spread_filter_layout(128, 10240, 16)
    assert (lay["C"], lay["slice"], lay["vslice"], lay["copies"], lay["local_table"]) == (4, 2560, 4, 8, 1)
    assert lay["smem"] == 4 * (128 + 2 * PTopo.SPREAD_LIST + 2560) + 5 * (8 * 16 + 4) + 5 * 16
    lay = PTopo.spread_filter_layout(128, 10240, 16384)
    assert (lay["copies"], lay["local_table"]) == (1, 0)
    lay = PTopo.spread_filter_layout(128, 10240, 40000)
    assert (lay["copies"], lay["local_table"], lay["smem"]) == (0, 0, 4 * (128 + 2 * PTopo.SPREAD_LIST + 2560))
    assert PTopo.spread_filter_layout(128, 400000, 16)["C"] == 16
    with pytest.raises(ValueError):
        PTopo.spread_filter_layout(128, 2_000_000, 16)


# ---------------------------------------------------------------------------
# the driver's arbitrated route
# ---------------------------------------------------------------------------

def _port_scheduler(nodes, existing, pods, batch):
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes, existing)
    for p in pods:
        queue.add(p)
    # a pod the arbiter leaves unplaced stays unschedulable: the random
    # clusters' term-carrying preemptors would need the host oracle's
    # victim search
    return Scheduler(cache, queue, batch_size=batch, deterministic=True, device="cpu", enable_preemption=False)


@pytest.mark.parametrize("seed", [7, 8])
def test_arbitrate_reads_the_solves_inputs(seed, monkeypatch):
    """The driver hands arbitrate what its batch's solve computed — the
    term matches against the spec rows, the port-conflict table, the raw
    selector and spread_filter's tables — and they equal what arbitrate
    computes alone, as do the verdicts (a random cluster with every
    covered kind, one batch)."""
    nodes, existing, pods = random_cluster(seed, 40, 90, 60, pins=False, topology=True, hard_spread=True,
                                           interpod=True, pending_affinity=False, pending_ports=True)
    sched = _port_scheduler(nodes, existing, pods, len(pods))
    seen = []

    def spy(*args, inputs=None, **kw):
        na, pa, ea, ta, ids, assign, pb = args
        # compared now: the commit fold advances the banks in place
        assert {"m_raw", "pconf", "sel", "spread_tables"} <= set(inputs)
        alone = PA._solve_inputs(na, pa, ea, ta, ids, None, True, kw["n_buckets"], plain=True)
        assert torch.equal(inputs["m_raw"], alone["m_raw"]) and torch.equal(inputs["pconf"], alone["pconf"])
        for key, x in alone["spread_tables"].items():
            assert torch.equal(inputs["spread_tables"][key], x), key
        out = PA.arbitrate(*args, inputs=inputs, **kw)
        assert torch.equal(out, PA.arbitrate(*args, **kw))
        seen.append(out)
        return out

    monkeypatch.setattr(D, "arbitrate", spy)
    res = sched.schedule_batch()
    sched.wait_for_binds()
    sched.close()
    assert len(seen) == 1 and sched.stats["arbiter_batches"] == 1
    assert sched.stats["tracked_batches"] == 1 and res.scheduled > 0


def test_arbitrated_apply_fails_an_already_assumed_key():
    """A V_PLACE pod whose key the cache already holds is rejected by the
    arbitrated batch's one assume: it fails (unschedulable, not placed),
    the rest of the batch is applied, and its folded row goes back to a
    host-wins re-ship, so the device banks equal the host mirror after the
    next sync."""
    alloc = {PT.RESOURCE_CPU: PT.Quantity.parse("4"), PT.RESOURCE_MEMORY: PT.Quantity.parse("16Gi"),
             PT.RESOURCE_PODS: PT.Quantity.parse(110)}
    nodes = [PT.Node(name=f"n{i}", labels={HOST_KEY: f"n{i}", ZONE: f"z{i % 2}"}, allocatable=dict(alloc),
                     capacity=dict(alloc)) for i in range(4)]
    pods = []
    for i in range(6):
        p = PT.Pod(name=f"s{i}", namespace="bench", labels={"app": "web"}, containers=[PT.Container(
            name="c", requests={PT.RESOURCE_CPU: PT.Quantity.parse("50m")})])
        p.topology_spread_constraints = [PT.TopologySpreadConstraint(
            max_skew=3, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
            label_selector=PT.LabelSelector(match_labels={"app": "other"}))]
        pods.append(p)
    sched = _port_scheduler(nodes, [], pods, len(pods))
    sched.cache.assume_pod(pods[0].with_node("n3"))  # the key is already in the cache
    res = sched.schedule_batch()
    sched.wait_for_binds()
    st = sched.stats
    assert st["arbiter_batches"] == 1 and st["fold_batches"] == 1 and st["arbiter_defer"] == 0
    assert pods[0].key() not in res.assignments and res.unschedulable == 1
    assert res.scheduled == st["arbiter_place"] == 5 and sched.cache.pod_count() == 6
    m = sched.mirror
    m.sync()
    for dev, host in zip(m.device_arrays(), (m.nodes.arrays(), m.eps.arrays(), m.pats.arrays())):
        for key, h in host.items():
            assert np.array_equal(dev[key].numpy(), h), key
    sched.close()
