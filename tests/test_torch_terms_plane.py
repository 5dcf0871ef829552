"""The term-bank plane of the port against the reference's, on the CPU: the
term slab (TermStage) against the reference's on the same pods and
selectors, the plain term gather (`gather_terms_plain`, and the
`gather_terms` wrapper's CPU path) against the reference's jitted
`gather_terms` on seeded slabs with padding lanes, repeated rows and both
dtypes, the gathered table against `compile_batch_terms` of the same reps,
the term bank's flushes against the reference's, and drains of the port's
default Scheduler (both planes on) against the reference's with the same
planes on: the reference suite's mixed / anti / spread / gang scenarios,
its preemption and node-churn drains, and config 3 with Services (the
spreading selectors in the intern key) — the same placements pod for pod
and the same plane counters, and the planes-off port drain equal. Then the
staleness paths (update between enqueue and pop, delete between pop and
dispatch, slab growth, the ceiling, a rebuild mid-resolve, a label update),
the refcount lifecycle, the overflowing-terms pod reaching the host oracle
on both transports, and a failing term gather: `schedule_batch` raises
with the batch back in the queue. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ingest.bank import _scatter_fn as r_scatter_fn
from kubernetes_tpu.state.tensors import Vocab as RVocab
from kubernetes_tpu.terms_plane import stage as r_stage_mod
from kubernetes_tpu.terms_plane.bank import TermBankDevice as RTermBank
from kubernetes_tpu.terms_plane.gather import gather_terms as r_gather_terms

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import bench_config3, random_cluster, random_selectors
from kubernetes_tpu_torch.ops import slab as SL
from kubernetes_tpu_torch.scheduler import driver as D
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import Vocab
from kubernetes_tpu_torch.state.terms import TermBank, compile_batch_terms
from kubernetes_tpu_torch.terms_plane import TermBankDevice, gather_terms, gather_terms_plain
from kubernetes_tpu_torch.terms_plane import stage as p_stage_mod

from test_torch_ingest import (
    HOST,
    PLANE_COUNTERS,
    anti_pod,
    assert_same,
    counters,
    drain,
    lanes,
    make_pod,
    nodes,
    ref_dict,
    scenario_drain,
    scheduler,
    seeded_slab,
    spread_pod,
    walk_gather,
)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_terms_plain_matches_reference(seed):
    rng = np.random.default_rng(seed)
    template = TermBank(Vocab(), 1).arrays()
    s, t = (29, 48) if seed else (256, 128)
    slab, empty = seeded_slab(template, s, seed)
    idx, keep = lanes(rng, s, t, t - 11)
    owner = rng.integers(0, 64, t).astype(np.int32)
    ref = r_gather_terms(ref_dict(slab), jnp.asarray(idx), jnp.asarray(owner), jnp.asarray(keep), ref_dict(empty))
    bank, emp = arrays_to_torch(slab, "cpu"), arrays_to_torch(empty, "cpu")
    plain = gather_terms_plain(bank, torch.from_numpy(idx), torch.from_numpy(owner), torch.from_numpy(keep), emp)
    assert_same(ref, plain)
    assert_same(ref, gather_terms(bank, idx, owner, keep, emp))  # the wrapper's CPU path
    assert_same(ref, walk_gather(slab, idx, keep, empty, owner, "owner", masked=True))  # csrc/slab.cu's walk
    assert gather_terms.launches == 0


def _pods_and_selectors(t, seed):
    """A random cluster's pending pods with every term kind, every third
    followed by a replica, and the spreading-selector function."""
    _, _, pending = random_cluster(seed, 30, 50, 40, t=t, topology=True, hard_spread=True, interpod=True)
    out = []
    for i, p in enumerate(pending):
        out.append(p)
        if i % 3 == 0:
            r = type(p)(**{**p.__dict__, "name": p.name + "-r", "uid": p.uid + "-r"})
            r.__dict__.pop("_spec_key_memo", None)
            out.append(r)
    return out, random_selectors(t)


@pytest.mark.parametrize("seed", [6, 7])
def test_term_stage_matches_reference_and_gather_equals_compile(seed):
    """The port's TermStage and the reference's, fed the same pods and
    selectors, hold the same slab and entries; gathering the reps' entries
    in rep order (owners = rep positions, padding) equals compile_batch_terms
    of those reps, and the reference's gather of its own slab; the aux bits,
    kinds, slots and overflow the entries cache equal the compiled
    table's."""
    pp, pfn = _pods_and_selectors(PT, seed)
    rp, rfn = _pods_and_selectors(RT, seed)
    ps, rs = p_stage_mod.TermStage(Vocab()), r_stage_mod.TermStage(RVocab())
    ps.selectors_fn, rs.selectors_fn = pfn, rfn
    pairs = [ps.acquire(p) for p in pp]
    assert pairs == [rs.acquire(p) for p in rp]
    assert ps.stats == rs.stats and ps.stats["hits"] > 0
    assert_same(rs.batch.arrays(), arrays_to_torch(ps.batch.arrays(), "cpu"))
    reps, eids = [], []
    for p, (eid, _) in zip(pp, pairs):
        if eid not in eids:
            reps.append(p)
            eids.append(eid)
    rows, owners = [], []
    for b, eid in enumerate(eids):
        e = ps._entries[eid]
        re_ = rs._entries[eid]
        assert (e.rows, e.kinds, e.topo_slots, e.overflow, e.has_anti, e.n_sel_spread) == (
            re_.rows, re_.kinds, re_.topo_slots, re_.overflow, re_.has_anti, re_.n_sel_spread)
        rows += e.rows
        owners += [b] * len(e.rows)
    t = 1 << max(4, (len(rows) - 1).bit_length())
    idx = np.zeros(t, np.int32)
    idx[: len(rows)] = rows
    own = np.zeros(t, np.int32)
    own[: len(rows)] = owners
    keep = np.arange(t) < len(rows)
    bank, emp = arrays_to_torch(ps.batch.arrays(), "cpu", copy=True), arrays_to_torch(ps.empty_rows, "cpu")
    got = gather_terms(bank, idx, own, keep, emp)
    sels = {id(p): pfn(p) for p in reps}
    tb, aux = compile_batch_terms(ps.vocab, reps, spread_selectors=sels, capacity=t, b_capacity=64)
    assert tb.capacity == t
    assert_same(tb.arrays(), got)
    assert sorted(tb.overflow_owners) == [b for b, eid in enumerate(eids) if ps._entries[eid].overflow]
    assert [bool(ps._entries[eid].has_aff) for eid in eids] == aux["has_aff"][: len(eids)].tolist()
    assert [ps._entries[eid].n_sel_spread for eid in eids] == aux["n_sel_spread"][: len(eids)].tolist()
    ref = r_gather_terms(ref_dict(rs.batch.arrays()), jnp.asarray(idx), jnp.asarray(own), jnp.asarray(keep),
                         ref_dict(rs.empty_rows))
    assert_same(ref, got)


def test_term_scatter_and_bank_match_reference():
    """A term-row flush through the plain scatter equals the reference's
    `_scatter_fn()`; the term twin after a full upload and dirty flushes
    equals the reference's and the host slab."""
    template = TermBank(Vocab(), 1).arrays()
    slab, _ = seeded_slab(template, 30, 3)
    upd, _ = seeded_slab(template, 4, 4)
    rows = np.array([29, 0, 7, 12])
    ref = r_scatter_fn()(ref_dict(slab), jnp.asarray(np.r_[rows, [29] * 12].astype(np.int32)),
                         ref_dict({k: np.concatenate([v, np.repeat(v[:1], 12, 0)]) for k, v in upd.items()}))
    truth = {k: v.copy() for k, v in slab.items()}  # host truth holding the dirty rows
    for k, v in truth.items():
        v[rows] = upd[k]
    bank = arrays_to_torch(slab, "cpu", copy=True)
    SL.scatter_rows(bank, rows, truth)
    assert_same(ref, bank)
    pp, pfn = _pods_and_selectors(PT, 8)
    rp, rfn = _pods_and_selectors(RT, 8)
    ps, rs = p_stage_mod.TermStage(Vocab()), r_stage_mod.TermStage(RVocab())
    ps.selectors_fn, rs.selectors_fn = pfn, rfn
    pb, rb = TermBankDevice(ps, "cpu"), RTermBank(rs)
    for part in (slice(0, 15), slice(15, 40), slice(40, None)):
        for p, r in zip(pp[part], rp[part]):
            ps.acquire(p)
            rs.acquire(r)
        pdev, pemp = pb.current_arrays()
        rdev, remp = rb.current_arrays(sync=True)
        assert_same(rdev, pdev)
        assert_same(remp, pemp)
    assert pb.stats["sync_rows"] == rb.stats["sync_rows"] > 0
    assert pb.device_divergence() == [] == rb.device_divergence()


@pytest.mark.parametrize("scenario", ["terms-mixed", "spread", "terms-gang", "terms-preemption"])
def test_drain_matches_reference_with_planes_on(scenario):
    kw = {"terms": True} if scenario == "terms-preemption" else {}
    name = "preemption" if scenario == "terms-preemption" else scenario
    ref, ref_counts, _ = scenario_drain("ref", name, **kw)
    port, port_counts, sched = scenario_drain("port", name, **kw)
    assert port == ref and port_counts == ref_counts
    assert port_counts["term_index_batches"] > 0 and port_counts["term_legacy_batches"] == 0
    assert sched.term_bank.device_divergence() == []
    off, _, _ = scenario_drain("port", name, ingest_plane=False, term_plane=False, **kw)
    assert off == port
    # the term plane alone equals both on
    alone, alone_counts, _ = scenario_drain("port", name, ingest_plane=False, **kw)
    assert alone == port and alone_counts["ingest_index_batches"] == 0
    assert alone_counts["term_index_batches"] == port_counts["term_index_batches"]


def _services_drain(pkg, late_fn: bool):
    """Config 3 with Services at 1/100 scale: SelectorSpread's selectors are
    part of the term slab's intern key. With `late_fn` the selector
    function is installed after the pods were admitted, so every entry is
    stale by key at the first dispatch and re-interns."""
    t = RT if pkg == "ref" else PT
    node_list, pods, fn = bench_config3(40, 400, t=t, services=True)
    sched = scheduler(pkg, node_list, enable_preemption=False, batch_size=128)
    if not late_fn:
        sched.set_spread_selectors_fn(fn)
    for p in pods:
        sched.queue.add(p)
    if late_fn:
        sched.set_spread_selectors_fn(fn)
    got = drain(sched)
    sched.close()
    return got, counters(sched)


@pytest.mark.parametrize("late_fn", [False, True], ids=["admitted-with-selectors", "selectors-installed-late"])
def test_services_drain_matches_reference(late_fn):
    port = _services_drain("port", late_fn)
    c = port[1]
    assert len(port[0]) == 400 and c["term_index_batches"] + c["term_legacy_batches"] == c["batches"]
    # installed late, every admitted entry is stale by key: the first
    # dispatch re-interns them and the slab grows under it (one legacy batch)
    assert (c["term_restaged"] > 0) == late_fn and c["term_legacy_batches"] == int(late_fn)
    assert port == _services_drain("ref", late_fn)


def _term_case(pkg, case, monkeypatch=None):
    t = RT if pkg == "ref" else PT
    sched = scheduler(pkg, nodes(t, 4, zones=2), enable_preemption=False, batch_size=8)
    q = sched.queue
    if case == "update":
        blocked = make_pod(t, "u0", labels={"app": "u"})
        blocked.affinity = t.Affinity(pod_affinity=t.PodAffinity(required=[t.PodAffinityTerm(
            label_selector=t.LabelSelector(match_labels={"anchor": "nowhere"}), topology_key=HOST)]))
        q.add(blocked)
        q.update(blocked, make_pod(t, "u0", labels={"app": "u"}))  # the terms gone
        got = drain(sched)
    elif case == "delete":
        lone = anti_pod(t, "lone", "only")
        q.add(lone)
        infos = q.pop_batch(8)
        eid, gen = infos[0].term_row, infos[0].term_gen
        assert eid >= 0
        q.delete(lone)  # the last holder: the entry frees
        assert not sched.tstage.valid_pair(eid, gen)
        out = sched._device_solve(infos) if pkg == "ref" else sched._solve_batch(infos, [""], False)
        got = {"assign": int(out.assign[0])}
    elif case == "ceiling":
        for i in range(6):
            q.add(anti_pod(t, f"p{i}", f"g{i % 2}"))
        monkeypatch.setattr(sched.tstage, "ensure_entry", lambda pod, selectors=None: None)
        for info in list(q._infos.values()):  # every entry is pending here
            info.term_row = -1
        got = drain(sched)
    elif case == "label-update":
        old = spread_pod(t, "lu", "a")
        q.add(old)
        info = next(iter(q._infos.values()))
        eid, gen = info.term_row, info.term_gen
        q.update(old, spread_pod(t, "lu", "b"))  # selector and labels change
        assert (info.term_row, info.term_gen) != (eid, gen)
        assert not sched.tstage.valid_pair(eid, gen) and sched.tstage.valid_pair(info.term_row, info.term_gen)
        got = drain(sched)
    sched.close()
    return got, counters(sched)


@pytest.mark.parametrize("case", ["update", "delete", "ceiling", "label-update"])
def test_term_staleness_matches_reference(case, monkeypatch):
    port = _term_case("port", case, monkeypatch)
    if case == "update":
        assert list(port[0]) == ["default/u0"]
    if case == "delete":
        assert port[0]["assign"] >= 0 and port[1]["term_stale_rows"] == port[1]["term_restaged"] == 1
        assert port[1]["term_index_batches"] == 1
    if case == "ceiling":
        assert len(port[0]) == 6 and port[1]["term_legacy_batches"] >= 1 and port[1]["term_stale_rows"] >= 1
    assert port == _term_case("ref", case, monkeypatch)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_term_slab_overflow_grows_and_invalidates(pkg, monkeypatch):
    mod, t, vocab = (p_stage_mod, PT, Vocab) if pkg == "port" else (r_stage_mod, RT, RVocab)
    monkeypatch.setattr(mod, "MIN_CAPACITY", 4)
    st = mod.TermStage(vocab(), capacity=4)
    pairs = [st.acquire(anti_pod(t, f"o{i}", f"g{i}")) for i in range(4)]
    p5 = st.acquire(anti_pod(t, "o4", "g4"))
    assert p5 is not None and st.capacity == 8
    assert st.stats["overflows"] == 1 and st.stats["rebuilds"] == 1
    assert all(not st.valid_pair(e, g) for e, g in pairs) and st.valid_pair(*p5)


def test_term_refcount_lifecycle_matches_reference():
    out = {}
    for pkg, mod, t, vocab in (("port", p_stage_mod, PT, Vocab), ("ref", r_stage_mod, RT, RVocab)):
        st = mod.TermStage(vocab())
        pair = st.acquire(anti_pod(t, "r0", "x"))
        e = st._entries[pair[0]]
        seen = [(e.refs, len(e.rows), e.has_anti)]
        seen.append(st.acquire(anti_pod(t, "r1", "x")) == pair and e.refs)  # a replica: an intern hit
        free = len(st._free)
        st.release(*pair)
        seen.append((e.refs, st.valid_pair(*pair)))
        st.release(*pair)  # the last holder: the rows free, the entry goes
        seen.append((st.valid_pair(*pair), len(st._free) - free))
        st.release(*pair)  # stale: a no-op
        seen.append(st.acquire(anti_pod(t, "r2", "x")))  # a fresh entry, new id and generation
        out[pkg] = seen
    assert out["port"] == out["ref"]


def test_term_requeue_and_unschedulable_keep_one_reference():
    """add → pop → requeue / add_unschedulable round trips neither leak
    term-entry references nor drop the entry; delete frees it."""
    sched = scheduler("port", nodes(PT, 2), enable_preemption=False, batch_size=8)
    q = sched.queue
    q.add(anti_pod(PT, "rq", "rq"))
    info = q.pop_batch(1)[0]
    eid, gen = info.term_row, info.term_gen
    entry = sched.tstage._entries[eid]
    assert entry.refs == 1
    q.requeue([info])
    assert (info.term_row, info.term_gen) == (eid, gen) and entry.refs == 1
    info = q.pop_batch(1)[0]
    q.add_unschedulable(info)
    assert (info.term_row, info.term_gen) == (eid, gen) and entry.refs == 1
    q.delete(info.pod)
    assert not sched.tstage.valid_pair(eid, gen)
    sched.close()


def test_prologue_bails_when_the_term_slab_rebuilds_mid_resolve(monkeypatch):
    sched = scheduler("port", nodes(PT, 4), enable_preemption=False, batch_size=8)
    for i in range(4):
        sched.queue.add(anti_pod(PT, f"p{i}", f"g{i}"))
    infos = sched.queue.pop_batch(8)
    infos[-1].term_row = -1
    real = sched.tstage.ensure_entry

    def growing(pod, selectors=None):
        sched.tstage._rebuild(sched.tstage.capacity * 2)
        return real(pod, selectors)

    monkeypatch.setattr(sched.tstage, "ensure_entry", growing)
    keys = [pi.pod.__dict__.get("_spec_key_memo") for pi in infos]
    assert sched._term_prologue([pi.pod for pi in infos], infos, keys, None) is None
    monkeypatch.setattr(sched.tstage, "ensure_entry", real)
    out = sched._solve_batch(infos, [""] * 4, False)
    assert all(a >= 0 for a in out.assign)
    assert sched.stats["term_index_batches"] == 1
    sched.close()


def _overflowing_pod(t, name):
    """ml_cap (4) + 1 matchLabels pairs: the compiled selector truncates, so
    the device row under-matches and the pod must reach the host oracle."""
    p = make_pod(t, name, labels={f"k{j}": "v" for j in range(5)})
    p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
        label_selector=t.LabelSelector(match_labels={f"k{j}": "v" for j in range(5)}), topology_key=HOST)]))
    return p


def _overflow_case(pkg, term_plane):
    t = RT if pkg == "ref" else PT
    sched = scheduler(pkg, nodes(t, 4), enable_preemption=False, batch_size=8, term_plane=term_plane)
    sched.queue.add(_overflowing_pod(t, "ov0"))
    infos = sched.queue.pop_batch(8)
    out = sched._device_solve(infos) if pkg == "ref" else sched._solve_batch(infos, [""], False)
    fallback = bool(out.fallback[0])
    sched.queue.requeue(infos)
    got = drain(sched)
    sched.close()
    oracle = sched.stats.get("oracle_rechecks", 0) + sched.stats.get("oracle_places", 0)
    return fallback, got, counters(sched), oracle


@pytest.mark.parametrize("term_plane", [True, False], ids=["covered", "legacy"])
def test_overflowing_terms_pod_reaches_the_host_oracle(term_plane):
    port = _overflow_case("port", term_plane)
    assert port[0] and list(port[1]) == ["default/ov0"] and port[3] >= 1
    assert (port[2]["term_index_batches"] >= 1) == term_plane
    assert port == _overflow_case("ref", term_plane)


def test_a_failing_term_gather_raises_with_the_batch_requeued(monkeypatch):
    sched = scheduler("port", nodes(PT, 4), enable_preemption=False, batch_size=8)
    for i in range(5):
        sched.queue.add(anti_pod(PT, f"p{i}", f"g{i}"))

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(D, "gather_batch", boom)
    with pytest.raises(RuntimeError, match="injected"):
        sched.schedule_batch()
    assert sched.queue.counts() == (5, 0, 0) and sched.stats["term_legacy_batches"] == 0
    monkeypatch.undo()
    assert len(drain(sched)) == 5
    sched.close()


def test_plane_counters_are_the_references_names():
    sched = scheduler("port", nodes(PT, 2))
    assert set(PLANE_COUNTERS) | {"stage_s", "term_gather_s"} <= set(sched.stats)
    assert sched.stage is not None and sched.tstage is not None
    off = scheduler("port", nodes(PT, 2), ingest_plane=False, term_plane=False)
    assert off.stage is None and off.tstage is None and off.stage_bank is None and off.term_bank is None
    sched.close()
    off.close()
