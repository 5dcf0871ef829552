"""The port's topology programs against `kubernetes_tpu.ops.topology` on the
same seeded encodings: `match_terms` (with and without the namespace
test), `spread_score` (zone key; hostname key with V > 64, which takes the
reference's segment_sum branch; two constraints on one key; a too-small
V that drops buckets; restrictive node selectors; nodes missing the key;
fallback nodes) and `selector_spread_score` (zones and no zones, deleting
signatures, rows with 0, 1 and 2 selectors, and the float64 blend that
truncates 6.999999999999999 to 6), and the kernels' algorithms written as
csrc/topology.cu walks them (the match kernel's compacted rows, the spread
score's clusters, the selector-spread blocks), and the launch layouts.
Tolerance: exact equality, dtype included. On the CPU the port runs its plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.ops import topology as PTopo
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot as PSnapshot
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
from kubernetes_tpu_torch.state.tensors import encode_snapshot as p_encode
from kubernetes_tpu_torch.state.tensors import OP_DOES_NOT_EXIST, OP_EXISTS, OP_IN, OP_NEVER, OP_NOT_IN
from kubernetes_tpu_torch.state.terms import SPREAD_SOFT
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


@pytest.mark.parametrize("seed", [4, 5])
def test_selector_spread_reads_the_plan_matrix_exactly(seed):
    """selector_spread_score given the match plan's raw m_sig returns
    exactly what it returns computing its own (Services: the plan's one
    matrix)."""
    pn, pe, pt, pa_, pp = (arrays_to_torch(d, "cpu") for d in encoded("port", seed=seed, selectors=True))
    plan = PP.match_plan(pp, PP.DEFAULT_SOLVE_CONFIG, frozenset({"spread_soft", "sel_spread"}), ea=pe, ta=pt,
                         xa=None)
    assert set(plan) == {"m_sig"}
    for v in (16, 128):
        assert torch.equal(PTopo.selector_spread_score(pn, pe, pt, pa_, n_buckets=v, m_sig=plan["m_sig"]),
                           PTopo.selector_spread_score(pn, pe, pt, pa_, n_buckets=v))


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
# csrc/topology.cu's algorithms, written as its CTAs walk them (the match
# kernel's compacted term rows; the spread score's clusters of R spec rows:
# groups per (row, key), staged counts at the matched signatures per node
# tile, per-CTA tables summed over the cluster by bucket slice, per-row
# partials; buckets >= V dropped from sums and clamped in gathers), held to
# the plain versions on the CPU — the card tests then hold the kernels
# themselves to the plain versions
# ---------------------------------------------------------------------------


def compact_row(terms, t, k, with_ns):
    """A term's compacted selector as csrc/topology.cu's compact_term builds
    it: (tests, namespace lanes or None), or None for a dead row."""
    g = {key: terms[key].numpy() for key in ("valid", "has_selector", "ml_slot", "ml_val", "ex_op", "ex_slot",
                                              "ex_vals", "ns_any", "ns_ids")}
    if not g["valid"][t] or not g["has_selector"][t]:
        return None
    tests = [("eq", min(int(s), k - 1), int(v)) for s, v in zip(g["ml_slot"][t], g["ml_val"][t]) if s >= 0]
    for op, slot, vals in zip(g["ex_op"][t], g["ex_slot"][t], g["ex_vals"][t]):
        if op == OP_NEVER:
            return None
        if op not in (OP_IN, OP_NOT_IN, OP_EXISTS, OP_DOES_NOT_EXIST):
            continue
        pool = [int(v) for v in vals if v >= 0] + ([-1] if (vals < 0).any() else [])
        tests.append((int(op), 0 if slot < 0 else min(int(slot), k - 1), pool))
    ns = [int(x) for x in g["ns_ids"][t]] if with_ns and not g["ns_any"][t] else None
    return tests, ns


def eval_row(row, lab, nsx):
    if row is None:
        return False
    tests, ns = row
    for op, sc, arg in tests:
        v = int(lab[sc])
        if op == "eq":
            if v != arg:
                return False
            continue
        present = v != 0
        if op in (OP_IN, OP_NOT_IN):
            in_set = v in arg
            ok = (present and in_set) if op == OP_IN else (not present or not in_set)
        else:
            ok = present if op == OP_EXISTS else not present
        if not ok:
            return False
    return ns is None or nsx in ns


def match_walk(terms, labels, ns):
    """[TT, X] from the compacted rows, as the match kernel's tiles test
    each (term, subject) pair."""
    lab = labels.numpy()
    nsv = None if ns is None else ns.numpy()
    rows = [compact_row(terms, t, lab.shape[1], ns is not None) for t in range(terms["valid"].shape[0])]
    return np.array([[eval_row(r, lab[x], None if nsv is None else int(nsv[x])) for x in range(lab.shape[0])]
                     for r in rows], bool).reshape(len(rows), lab.shape[0])


def spread_cluster_walk(na, ea, ta, sel, v, rows, ctas):
    """csrc/topology.cu's spread score at R = `rows` spec rows a cluster of
    C = `ctas` CTAs (spread_score_layout's slices), cluster by cluster."""
    valid, kind, owner, slot = (ta[k].numpy() for k in ("valid", "kind", "owner", "topo_slot"))
    tt = len(valid)
    counts, ev, elab = ea["counts"].numpy().astype(np.int64), ea["valid"].numpy(), ea["label_vals"].numpy()
    nv, ld, sel = na["valid"].numpy(), na["label_dense"].numpy(), sel.numpy()
    u_rows, n = sel.shape
    s_all, k = counts.shape[1], ld.shape[1]
    lay = PTopo.spread_score_layout(tt, n, v, u_rows, ta["ml_slot"].shape[1], ta["ex_op"].shape[1],
                                    ta["ex_vals"].shape[2], rows=rows, cluster=ctas)
    R, C, sl, vs = lay["R"], lay["C"], lay["slice"], lay["vslice"]
    crow = {t: compact_row(ta, t, elab.shape[1], False) for t in range(tt)}

    def dense(x, s):
        d = ld[x, 0 if s < 0 else min(s, k - 1)]
        return int(d) if d >= 0 and s >= 0 else -1

    out = np.zeros((u_rows, n), np.int64)
    for r0 in range(0, u_rows, R):
        nrows = min(R, u_rows - r0)
        terms = [t for t in range(tt) if valid[t] and kind[t] == SPREAD_SOFT and r0 <= owner[t] < r0 + nrows]
        leads = [i for i, t in enumerate(terms)
                 if not any(owner[terms[j]] == owner[t] and slot[terms[j]] == slot[t] for j in range(i))]
        leads.sort(key=lambda i: (owner[terms[i]], i))  # a row's groups are one range
        groups = [(int(owner[terms[i]]) - r0, int(slot[terms[i]])) for i in leads]
        size = [sum(1 for t in terms if (owner[t] - r0, slot[t]) == g) for g in groups]
        tgrp = [groups.index((int(owner[t]) - r0, int(slot[t]))) for t in terms]
        of_row = [[g for g, (r, _) in enumerate(groups) if r == r_] for r_ in range(nrows)]

        def member(r, x):
            return bool(nv[x]) and all(dense(x, groups[g][1]) >= 0 for g in of_row[r])

        part_cnt = np.zeros((C, len(groups), v), np.int64)
        part_pres = np.zeros((C, len(groups), v), bool)
        for c in range(C):
            nodes = range(c * sl, min(n, (c + 1) * sl))
            for r in range(nrows):
                for x in (x for x in nodes if of_row[r] and member(r, x)):
                    for g in of_row[r]:
                        if dense(x, groups[g][1]) < v:
                            part_pres[c, g, dense(x, groups[g][1])] = True
            for i0 in range(0, len(terms), PTopo.SCORE_TW):
                for s0 in range(0, s_all, PTopo.SCORE_SWIN):
                    pairs = [(s, tgrp[i]) for i in range(i0, min(len(terms), i0 + PTopo.SCORE_TW))
                             for s in range(s0, min(s_all, s0 + PTopo.SCORE_SWIN))
                             if ev[s] and eval_row(crow[terms[i]], elab[s], None)]
                    cols = sorted({s for s, _ in pairs})  # the tile's columns, ascending
                    stride = ((len(cols) + 1) & ~3) + 2
                    tn = min(2 * PTopo.SCORE_TILE_WORDS // stride, PTopo.SCORE_SEL_BYTES // nrows)
                    for x0 in range(nodes.start, nodes.stop, tn):
                        for x in range(x0, min(nodes.stop, x0 + tn)):
                            tile = {s: counts[x, s] for s in cols}
                            for s, g in pairs:
                                r, key = groups[g]
                                if tile[s] and member(r, x) and sel[r0 + r, x] and dense(x, key) < v:
                                    part_cnt[c, g, dense(x, key)] += tile[s]
        merged_cnt = np.zeros((len(groups), v), np.int64)
        merged_pres = np.zeros((len(groups), v), bool)
        for c in range(C):  # CTA c sums its bucket slice over the cluster
            b = slice(min(v, c * vs), min(v, c * vs + vs))
            merged_cnt[:, b] = part_cnt[:, :, b].sum(0)
            merged_pres[:, b] = part_pres[:, :, b].any(0)
        for r in range(nrows):
            if not of_row[r]:
                continue
            cnt, mem = np.zeros(n, np.int64), np.zeros(n, bool)
            for x in range(n):
                nc, m = 0, bool(nv[x])
                for g in of_row[r]:
                    d = dense(x, groups[g][1])
                    if d < 0:
                        m = False
                    elif merged_pres[g, min(d, v - 1)]:
                        nc += size[g] * int(merged_cnt[g, min(d, v - 1)])
                cnt[x], mem[x] = int(np.int64(nc).astype(np.int32)), m
            if lay["copies"] and len(groups) <= lay["gcap"] and len(of_row[r]) == 1:
                # a one-key row: its key's member histogram (at the clamped
                # bucket, summed over the cluster) against the count a bucket
                g = of_row[r][0]
                hist = np.zeros(v, np.int64)
                for x in range(n):
                    if nv[x] and dense(x, groups[g][1]) >= 0:
                        hist[min(dense(x, groups[g][1]), v - 1)] += 1
                at = np.array([int(np.int64(size[g] * int(merged_cnt[g, b]) if merged_pres[g, b] else 0)
                                   .astype(np.int32)) for b in range(v)], np.int64)
                total = int((hist * at).sum())
                low = int(at[hist > 0].min()) if (hist > 0).any() else 0
            else:  # over each CTA's slice nodes, then the cluster
                parts = [(cnt[c * sl:(c + 1) * sl][mem[c * sl:(c + 1) * sl]]) for c in range(C)]
                total = sum(int(p.sum()) for p in parts)
                low = min((int(p.min()) for p in parts if len(p)), default=0)
            diff = total - low
            f = (10 * (total - cnt)) // diff if diff > 0 else np.full(n, 10)
            out[r0 + r] = np.where(mem, f, 0)
    return out


def selector_spread_walk(na, ea, ta, au, m_sig, v, cluster=None, mode=None):
    """csrc/topology.cu's selector spread at C = `cluster` CTAs a spec row
    and the zone tables in `mode` (selector_spread_layout's), cluster by
    cluster: the row's matched signatures in windows of SPREAD_LIST, each
    CTA's node slice (its counts, maximum, have_zones and zone partial: a
    V-wide table of its own in mode 0, adds into the owning CTA's bucket
    slice in mode 1, into the row's device table in mode 2), the partials
    over the cluster, then the float64 blend."""
    valid, kind, owner = (ta[k].numpy() for k in ("valid", "kind", "owner"))
    counts = ea["counts"].numpy().astype(np.int64)
    ev, edel = ea["valid"].numpy(), ea["deleting"].numpy()
    nv, zd, n_sel = na["valid"].numpy(), na["zone_dense"].numpy(), au["n_sel_spread"].numpy()
    m_sig = m_sig.numpy()
    u_rows, n, s_all = len(n_sel), len(nv), len(ev)
    lay = PTopo.selector_spread_layout(len(valid), n, v, u_rows, cluster, mode)
    C, sl, vs, md = lay["C"], lay["slice"], lay["vslice"], lay["mode"]
    assert sl % 2 == 0 and C * sl >= n and sl <= 2 * PTopo.SEL_PAIRS * 256

    def frac(mx, c):
        return 10.0 if mx <= 0 else (10.0 * float(mx - c)) / float(mx)

    out = np.zeros((u_rows, n), np.int64)
    for u in range(u_rows):
        terms = [t for t in range(len(valid)) if valid[t] and kind[t] == 7 and owner[t] == u]
        cnt = np.zeros(n, np.int64)
        for s0 in range(0, s_all, PTopo.SPREAD_LIST) if n_sel[u] > 0 else ():
            ss = np.arange(s0, min(s_all, s0 + PTopo.SPREAD_LIST))
            ok = ev[ss] & ~edel[ss] & np.all(m_sig[np.ix_(terms, ss)], axis=0)
            cnt += counts[:, ss[ok]].sum(axis=1)
        cnt = np.where(nv, cnt.astype(np.int32), 0).astype(np.int64)  # registers: int32, 0 off valid nodes
        part_max, part_zones = np.zeros(C, np.int64), np.zeros(C, bool)
        partial = np.zeros((C, v), np.int64)  # mode 0: a CTA's own V-wide table
        owned = np.zeros((C, vs), np.int64)   # modes 1 and 2: CTA r's bucket slice (mode 2 in device memory)
        for c in range(C):
            xs = np.arange(c * sl, min(n, (c + 1) * sl))
            live = nv[xs]
            part_max[c] = max(int(cnt[xs][live].max(initial=0)), 0)
            zok = live & (zd[xs] >= 0)
            part_zones[c] = zok.any()
            add = zok & (zd[xs] < v) & (cnt[xs] != 0)
            z, val = zd[xs][add], cnt[xs][add]
            if md == 0:
                np.add.at(partial[c], z, val)
            else:
                np.add.at(owned, (z // vs, z % vs), val)
        gmax, have = int(part_max.max()), bool(part_zones.any())
        if md == 0:  # every CTA merges the C partials locally
            merged = partial.sum(axis=0)
            zmax = max(int(merged.max()), 0)
        else:  # each slice's maximum, then over the cluster
            merged = owned.reshape(-1)[:v]
            zmax = max(max(int(owned[r, :max(0, min(v, (r + 1) * vs) - r * vs)].max(initial=0)), 0) for r in range(C))
        for x in range(n):
            blend = frac(gmax, int(cnt[x]))
            if have and nv[x] and zd[x] >= 0:
                blend = blend * (1.0 / 3.0) + (2.0 / 3.0) * frac(zmax, int(merged[min(zd[x], v - 1)]))
            out[u, x] = int(blend)
    return out


@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
def test_kernel_walk_equals_plain(n_buckets):
    """The selector-spread kernel's algorithm (as csrc/topology.cu's
    clusters walk it, at the default layout) equals the plain version: V =
    16 drops buckets, 64 holds them, both in a CTA's local table; 40,000
    takes the bucket slices (8 CTAs a row here; the device tables: the
    cluster-size test below)."""
    pn, pe, pt, pa_, pp = (arrays_to_torch(d, "cpu")
                           for d in encoded("port", seed=7, selectors=True, n_nodes=40))
    m_ns = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"])
    want = PTopo.selector_spread_score_plain(pn, pe, pt, pa_, n_buckets=n_buckets).numpy()
    assert ((want > 0) & (want < 10)).any()
    assert PTopo.selector_spread_layout(pt["valid"].shape[0], 43, n_buckets, 64)["mode"] == (
        1 if n_buckets == 40000 else 0)
    assert np.array_equal(selector_spread_walk(pn, pe, pt, pa_, m_ns, n_buckets), want)


@pytest.mark.parametrize("cluster,mode", [(1, None), (3, None), (16, None), (4, 1), (2, 2), (5, 1)],
                         ids=["C1", "C3", "C16", "C4-slices", "C2-device", "C5-slices"])
@pytest.mark.parametrize("n_buckets", [16, "drain", 64, 40000])
def test_selector_spread_cluster_walk_equals_plain_and_reference(n_buckets, cluster, mode):
    """The selector spread's one-launch algorithm at 1, 2, 3, 4, 5 and 16
    CTAs a spec row on a node axis no C divides, with the zone tables local
    (V <= 1,024), in bucket slices of shared memory and in device memory,
    at V = 16, the segment axis the driver sizes for this cluster, 64 and
    40,000, equals the plain version and the JAX reference: rows with 0, 1
    and 2 selectors, deleting signatures, invalid padding rows, nodes
    without a zone, fallback nodes."""
    from kubernetes_tpu_torch.state.tensors import _bucket

    kw = dict(seed=7, selectors=True, n_nodes=40)
    (rn, re, rt, ra, rp), (pn, pe, pt, pa_, pp) = both(**kw)
    if n_buckets == "drain":  # the largest dense label count, bucketed
        n_buckets = _bucket(int(pn["label_dense"].max()) + 1)
    assert bool(pe["deleting"].any()) and not bool(pp["valid"].all())
    assert {0, 1, 2} <= set(pa_["n_sel_spread"].tolist())
    assert bool(((pn["zone_dense"] < 0) & pn["valid"]).any()) and bool((pn["fallback"] & pn["valid"]).any())
    m_ns = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"])
    got = selector_spread_walk(pn, pe, pt, pa_, m_ns, n_buckets, cluster, mode)
    want = PTopo.selector_spread_score_plain(pn, pe, pt, pa_, n_buckets=n_buckets)
    assert np.array_equal(got, want.numpy())
    same(RTopo.selector_spread_score(rn, re, rt, ra, n_buckets=n_buckets), torch.from_numpy(got))


def test_selector_spread_layouts():
    """The launches the selector-spread wrapper builds: at the config-3 +
    Services shapes (U = 128, N = 10,240, TT = 256) 3 CTAs a spec row (384
    CTAs, one wave; a CTA's 3,414 nodes in registers), the zone table local
    at V = 16, in bucket slices at 16,384 and in device memory at 40,000;
    the fewest CTAs that hold a slice's node pairs in registers, doubled
    while the launch stays within 512 CTAs."""
    lay = PTopo.selector_spread_layout(256, 10240, 16, 128)
    assert (lay["C"], lay["slice"], lay["mode"]) == (3, 3414, 0)
    assert PTopo.selector_spread_layout(256, 10240, 16384, 128)["mode"] == 1
    assert PTopo.selector_spread_layout(256, 10240, 40000, 128)["mode"] == 2
    assert PTopo.selector_spread_layout(256, 10240, 16, 8)["C"] == 12
    assert PTopo.selector_spread_layout(256, 2000, 16, 64)["C"] == 8
    assert PTopo.selector_spread_layout(256, 5000, 16, 1024)["C"] == 2
    with pytest.raises(ValueError):
        PTopo.selector_spread_layout(256, 10240, 16, 128, cluster=2)  # 5,120 nodes a CTA: past its registers
    with pytest.raises(ValueError):
        PTopo.selector_spread_layout(256, 70000, 16, 128)


@pytest.mark.parametrize("rows,ctas", [(1, 1), (3, 4), (64, 16)], ids=["1-row", "3-rows", "all-rows"])
@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
def test_spread_cluster_walk_equals_plain(n_buckets, rows, ctas):
    """The spread score's one-launch algorithm (as csrc/topology.cu's
    clusters walk it) equals the plain version at one, several and all
    spec rows a cluster, on node axes the CTAs do not divide: V = 16 drops
    hostname and rack buckets, 64 holds them, 40,000 is the device-memory
    table width. The rows own 0, 1 and 2 soft terms, two on one key."""
    pn, pe, pt, pa_, pp = (arrays_to_torch(d, "cpu")
                           for d in encoded("port", seed=7, case="same-key", selectors=True, n_nodes=40))
    soft = pt["valid"] & (pt["kind"] == SPREAD_SOFT)
    per_row = torch.bincount(pt["owner"][soft].long(), minlength=64)
    assert {0, 2} <= set(per_row.tolist())
    sel = PF.pod_match_node_selector(pn, pp)
    want = PTopo.spread_score_plain(pn, pe, pt, pa_, sel, n_buckets=n_buckets).numpy()
    assert ((want > 0) & (want < 10)).any()
    assert np.array_equal(spread_cluster_walk(pn, pe, pt, sel, n_buckets, rows, ctas), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_walk_and_multi_match_reference(seed):
    """The match kernel's compacted rows (dead rows, value pools keeping one
    -1 lane, clipped slots, namespace lanes) equal match_terms_plain and the
    JAX match_terms on each problem of one multi-problem call: terms x
    signatures with and without the namespace test, terms x spec rows."""
    (rn, re, rt, ra, rp), (pn, pe, pt, pa_, pp) = both(seed=seed, selectors=True)
    problems = [(pt, pe["label_vals"], pe["ns_id"]), (pt, pe["label_vals"], None), (pt, pp["label_vals"], pp["ns_id"])]
    ref = [RTopo.match_terms(rt, re["label_vals"], re["ns_id"]), RTopo.match_terms(rt, re["label_vals"], None),
           RTopo.match_terms(rt, rp["label_vals"], rp["ns_id"])]
    for (terms, labels, ns), got, r in zip(problems, PTopo.match_terms_multi(problems), ref):
        same(r, got)
        assert torch.equal(got, PTopo.match_terms_plain(terms, labels, ns))
        assert np.array_equal(match_walk(terms, labels, ns), got.numpy())
        assert 0 < int(got.sum()) < got.numel()


def test_match_and_spread_score_layouts():
    """The launches the wrappers build: a match CTA's subjects halve while
    the label columns of the slots its tile's tests can name pass 48 KB; the spread score's clusters fill about 256
    CTAs (two an SM), keep its tables in shared memory at V = 16 and 64 and
    move them to device memory at 40,000, and stay within the shared-memory
    budget (at 8 rows a cluster: two CTAs an SM)."""
    assert PTopo.match_layout(64, 4, 4, 6, 4)["xtile"] == 64
    assert PTopo.match_layout(1024, 4, 4, 6, 4)["xtile"] == 64  # wide rows: only the named slots staged
    assert PTopo.match_layout(1024, 64, 64, 6, 4)["xtile"] == 8  # wide selectors: 1,024 slots a tile
    with pytest.raises(ValueError):
        PTopo.match_layout(64, 1000, 100, 6, 4)
    for rows, c in ((1, 2), (4, 8), (8, 16), (16, 16), (128, 16)):
        lay = PTopo.spread_score_layout(128, 10240, 16, 128, 4, 4, 6, rows=rows)
        assert (lay["R"], lay["C"]) == (rows, c) and lay["C"] * lay["slice"] >= 10240
        assert lay["copies"] > 0 and lay["smem"] <= PTopo.SPREAD_SMEM
    assert PTopo.spread_score_layout(128, 10240, 64, 128, 4, 4, 6)["copies"] > 0
    dev = PTopo.spread_score_layout(128, 10240, 40000, 128, 4, 4, 6)
    assert dev["copies"] == 0 and dev["smem"] <= PTopo.SPREAD_SMEM
    assert 2 * PTopo.spread_score_layout(128, 10240, 16, 128, 4, 4, 6)["smem"] <= 227 * 1024
