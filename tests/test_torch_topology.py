"""The port's topology programs against `kubernetes_tpu.ops.topology` on the
same seeded encodings: `match_terms` (with and without the namespace
test), `spread_score` (zone key; hostname key with V > 64, which takes the
reference's segment_sum branch; two constraints on one key; a too-small
V that drops buckets; restrictive node selectors; nodes missing the key;
fallback nodes) and `selector_spread_score` (zones and no zones, deleting
signatures, rows with 0, 1 and 2 selectors, and the float64 blend that
truncates 6.999999999999999 to 6), and the kernels' algorithm written as
csrc/topology.cu walks it. Tolerance: exact equality, dtype
included. On the CPU the port runs its plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import filters as RF
from kubernetes_tpu.ops import topology as RTopo
from kubernetes_tpu.oracle.nodeinfo import Snapshot as RSnapshot
from kubernetes_tpu.state.tensors import PodBatch as RPodBatch
from kubernetes_tpu.state.tensors import encode_snapshot as r_encode
from kubernetes_tpu.state.terms import compile_batch_terms as r_compile

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import HOST_KEY, ZONE_KEY, random_cluster, random_selectors
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.ops import topology as PTopo
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot as PSnapshot
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
from kubernetes_tpu_torch.state.tensors import encode_snapshot as p_encode
from kubernetes_tpu_torch.state.terms import compile_batch_terms as p_compile


def _shape_constraints(t, pods, case):
    """Rewrite the pending pods' soft constraints for a case (the same
    rewrite for both packages' pods)."""
    for p in pods:
        cons = p.topology_spread_constraints
        if not cons:
            continue
        if case in ("zone", "hostname"):
            key = ZONE_KEY if case == "zone" else HOST_KEY
            p.topology_spread_constraints = [
                t.TopologySpreadConstraint(max_skew=c.max_skew, topology_key=key,
                                           when_unsatisfiable=c.when_unsatisfiable,
                                           label_selector=c.label_selector) for c in cons]
        elif case == "same-key":
            c = cons[0]
            p.topology_spread_constraints = [c, t.TopologySpreadConstraint(
                max_skew=1, topology_key=c.topology_key, when_unsatisfiable="ScheduleAnyway",
                label_selector=t.LabelSelector(match_labels={"app": p.labels["app"]}))]


def encoded(pkg, seed, case="mixed", selectors=False, no_zones=False, n_nodes=90, overflow_nodes=3):
    """(na, ea, ta, au, pa) numpy dicts of one seeded topology cluster."""
    t = RT if pkg == "ref" else PT
    nodes, existing, pending = random_cluster(seed, n_nodes, 40, 260, t=t, topology=True,
                                              overflow_nodes=overflow_nodes)
    _shape_constraints(t, pending, case)
    if no_zones:
        for n in nodes:
            n.labels.pop(ZONE_KEY, None)
    sel = None
    if selectors:
        fn = random_selectors(t)
        sel = {id(p): fn(p) for p in pending}
    snap = (RSnapshot if pkg == "ref" else PSnapshot)(nodes, existing)
    bank, sigs, _ = (r_encode if pkg == "ref" else p_encode)(snap)
    batch = (RPodBatch if pkg == "ref" else PPodBatch)(bank.vocab, 64)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, aux = (r_compile if pkg == "ref" else p_compile)(bank.vocab, pending, spread_selectors=sel,
                                                          b_capacity=64)
    return bank.arrays(), sigs.arrays(), tb.arrays(), aux, batch.arrays()


def both(**kw):
    ref = [{k: jnp.asarray(v) for k, v in d.items()} for d in encoded("ref", **kw)]
    port = [arrays_to_torch(d, "cpu") for d in encoded("port", **kw)]
    return ref, port


def same(ref, port):
    a, b = np.asarray(ref), port.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_ns", [False, True], ids=["all-namespaces", "namespaces"])
def test_match_terms_matches_reference(seed, with_ns):
    (rn, re, rt, ra, rp), (pn, pe, pt, pa_, pp) = both(seed=seed, selectors=True)
    r = RTopo.match_terms(rt, re["label_vals"], re["ns_id"] if with_ns else None)
    p = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"] if with_ns else None)
    same(r, p)
    assert 0 < int(p.sum()) < p.numel()
    # pods as subjects too (the [TT, B] direction of the inter-pod programs)
    same(RTopo.match_terms(rt, rp["label_vals"], rp["ns_id"]), PTopo.match_terms(pt, pp["label_vals"], pp["ns_id"]))


@pytest.mark.parametrize("case,n_buckets", [
    ("zone", 16), ("hostname", 128), ("same-key", 128), ("mixed", 128), ("mixed", 16), ("mixed", None),
])
@pytest.mark.parametrize("seed", [2, 3])
def test_spread_score_matches_reference(case, n_buckets, seed):
    """hostname with V = 128 takes the reference's segment_sum branch (V >
    64); ("mixed", 16) drops hostname and rack buckets above 15 in both."""
    (rn, re, rt, ra, rp), (pn, pe, pt, pa_, pp) = both(seed=seed, case=case)
    r_sel = RF.pod_match_node_selector(rn, rp)
    p_sel = PF.pod_match_node_selector(pn, pp)
    same(r_sel, p_sel)
    assert not bool(p_sel.all())  # some node selectors restrict
    assert bool((pn["fallback"] & pn["valid"]).any())
    r = RTopo.spread_score(rn, re, rt, ra, r_sel, n_buckets=n_buckets)
    p = PTopo.spread_score(pn, pe, pt, pa_, p_sel, n_buckets=n_buckets)
    same(r, p)
    assert int((p > 0).sum()) > 0 and int((p < 10).sum()) > 0


@pytest.mark.parametrize("no_zones", [False, True], ids=["zones", "no-zones"])
@pytest.mark.parametrize("n_buckets", [16, 128])
@pytest.mark.parametrize("seed", [4, 5])
def test_selector_spread_score_matches_reference(no_zones, n_buckets, seed):
    (rn, re, rt, ra, rp), (pn, pe, pt, pa_, pp) = both(seed=seed, selectors=True, no_zones=no_zones)
    assert bool(pe["deleting"].any())
    n_sel = pa_["n_sel_spread"][:40]
    assert {0, 1, 2} <= set(n_sel.tolist())
    r = RTopo.selector_spread_score(rn, re, rt, ra, n_buckets=n_buckets)
    p = PTopo.selector_spread_score(pn, pe, pt, pa_, n_buckets=n_buckets)
    same(r, p)
    assert len(np.unique(p.numpy())) >= 3


def _truncation_case(t, encode, snapshot_cls, batch_cls, compile_fn):
    """Two zones: node a holds 10 pods the selector matches, node b 3. For
    b, fscore = 10*(10-3)/10 = 7.0 and the zone score is 7.0 too, so the
    blend is 7.0*(1/3) + (2/3)*7.0 = 6.999999999999999 → 6."""
    alloc = {t.RESOURCE_PODS: t.Quantity.parse(110)}
    nodes = [t.Node(name=n, labels={HOST_KEY: n, ZONE_KEY: z}, allocatable=dict(alloc))
             for n, z in (("a", "z1"), ("b", "z2"))]
    existing = [t.Pod(name=f"e{i}", namespace="ns", labels={"app": "web"}, node_name="a" if i < 10 else "b")
                for i in range(13)]
    pod = t.Pod(name="p", namespace="ns", labels={"app": "web"})
    bank, sigs, _ = encode(snapshot_cls(nodes, existing))
    batch = batch_cls(bank.vocab, 16)
    batch.set_pod(0, pod)
    sel = {id(pod): [t.LabelSelector(match_labels={"app": "web"})]}
    tb, aux = compile_fn(bank.vocab, [pod], spread_selectors=sel, b_capacity=16)
    return bank.arrays(), sigs.arrays(), tb.arrays(), aux


def test_selector_spread_blend_truncates_like_the_reference():
    assert int(7.0 * (1.0 / 3.0) + (2.0 / 3.0) * 7.0) == 6
    rn, re, rt, ra = (
        {k: jnp.asarray(v) for k, v in d.items()}
        for d in _truncation_case(RT, r_encode, RSnapshot, RPodBatch, r_compile)
    )
    pn, pe, pt, pa_ = (
        arrays_to_torch(d, "cpu") for d in _truncation_case(PT, p_encode, PSnapshot, PPodBatch, p_compile)
    )
    r = RTopo.selector_spread_score(rn, re, rt, ra, n_buckets=16)
    p = PTopo.selector_spread_score(pn, pe, pt, pa_, n_buckets=16)
    same(r, p)
    assert p[0, :2].tolist() == [0, 6]


# ---------------------------------------------------------------------------
# csrc/topology.cu's algorithm, written as its blocks walk it (the matched
# signatures compacted per term or spec row, pair tables per soft term, a
# same-key merge, a per-row score; buckets >= V dropped from sums and
# clamped in gathers), held to the plain versions on the CPU — the card
# tests then hold the kernels themselves to the plain versions
# ---------------------------------------------------------------------------


def _bucket(ld, n, slot):
    k = ld.shape[1]
    d = ld[n, 0 if slot < 0 else min(slot, k - 1)]
    return max(d, 0), bool(d >= 0 and slot >= 0)


def spread_walk(na, ea, ta, m_sig, sel, v):
    valid, kind, owner, slot = (ta[k].numpy() for k in ("valid", "kind", "owner", "topo_slot"))
    counts, ev = ea["counts"].numpy().astype(np.int64), ea["valid"].numpy()
    nv, ld, sel = na["valid"].numpy(), na["label_dense"].numpy(), sel.numpy()
    u_rows, n = sel.shape
    soft = valid & (kind == 6)
    terms_of = [[t for t in range(len(valid)) if soft[t] and owner[t] == u] for u in range(u_rows)]
    member = np.array([[bool(nv[x]) and all(_bucket(ld, x, slot[t])[1] for t in terms_of[u])
                        for x in range(n)] for u in range(u_rows)])
    pair_cnt = np.zeros((len(valid), v), np.int64)
    pair_present = np.zeros((len(valid), v), bool)
    for t in np.flatnonzero(soft):
        u, sigs = owner[t], np.flatnonzero(m_sig[t].numpy() & ev)
        for x in range(n):
            b, has = _bucket(ld, x, slot[t])
            if b >= v:
                continue
            if member[u, x] and sel[u, x]:
                pair_cnt[t, b] += counts[x, sigs].sum()
            pair_present[t, b] |= member[u, x] and has
    out = np.zeros((u_rows, n), np.int64)
    for u in range(u_rows):
        cnt = np.zeros(n, np.int64)
        for t in terms_of[u]:
            group = [q for q in terms_of[u] if slot[q] == slot[t]]
            merged_cnt, merged_present = pair_cnt[group].sum(0), pair_present[group].any(0)
            for x in range(n):
                b, has = _bucket(ld, x, slot[t])
                if has and merged_present[min(b, v - 1)]:
                    cnt[x] += merged_cnt[min(b, v - 1)]
        mem = member[u]
        total = int(cnt[mem].sum())
        diff = total - (int(cnt[mem].min()) if mem.any() else 0)
        f = (10 * (total - cnt)) // diff if diff > 0 else np.full(n, 10)
        out[u] = np.where(mem & bool(terms_of[u]), f, 0)
    return out


def selector_spread_walk(na, ea, ta, au, m_sig, v):
    valid, kind, owner = (ta[k].numpy() for k in ("valid", "kind", "owner"))
    counts = ea["counts"].numpy().astype(np.int64)
    live = ea["valid"].numpy() & ~ea["deleting"].numpy()
    nv, zd, n_sel = na["valid"].numpy(), na["zone_dense"].numpy(), au["n_sel_spread"].numpy()
    zone_ok = (zd >= 0) & nv

    def frac(mx, c):
        return 10.0 if mx <= 0 else (10.0 * float(mx - c)) / float(mx)

    out = np.zeros((len(n_sel), len(nv)), np.int64)
    for u in range(len(n_sel)):
        ok = live & (n_sel[u] > 0)
        for t in np.flatnonzero(valid & (kind == 7) & (owner == u)):
            ok = ok & m_sig[t].numpy()
        c = np.where(nv, counts[:, np.flatnonzero(ok)].sum(1), 0)
        table = np.zeros(v, np.int64)
        for x in np.flatnonzero(zone_ok & (zd < v)):
            table[zd[x]] += c[x]
        for x in range(len(nv)):
            blend = frac(c.max(), c[x])
            if zone_ok.any() and zone_ok[x]:
                blend = blend * (1.0 / 3.0) + (2.0 / 3.0) * frac(table.max(), table[min(zd[x], v - 1)])
            out[u, x] = int(blend)
    return out


@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
def test_kernel_walk_equals_plain(n_buckets):
    """The topology kernels' algorithm (as csrc/topology.cu walks it)
    equals the plain versions: V = 16 drops hostname buckets, 64 holds
    them, 40,000 is the device-memory-table width."""
    pn, pe, pt, pa_, pp = (arrays_to_torch(d, "cpu")
                           for d in encoded("port", seed=7, selectors=True, n_nodes=40))
    sel = PF.pod_match_node_selector(pn, pp)
    m_soft = PTopo.match_terms(pt, pe["label_vals"], None)
    m_ns = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"])
    want = PTopo.spread_score_plain(pn, pe, pt, pa_, sel, n_buckets=n_buckets).numpy()
    assert ((want > 0) & (want < 10)).any()
    assert np.array_equal(spread_walk(pn, pe, pt, m_soft, sel, n_buckets), want)
    want = PTopo.selector_spread_score_plain(pn, pe, pt, pa_, n_buckets=n_buckets).numpy()
    assert ((want > 0) & (want < 10)).any()
    assert np.array_equal(selector_spread_walk(pn, pe, pt, pa_, m_ns, n_buckets), want)
