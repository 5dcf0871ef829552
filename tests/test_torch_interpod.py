"""The port's inter-pod programs against `kubernetes_tpu.ops.topology` /
`kubernetes_tpu.ops.pipeline` on the same seeded encodings:
`interpod_filter` for every non-empty subset of its parts ("existing",
"aff", "anti"), `interpod_score` for each part and both, `_scatter_or`,
`_inbatch_tensors` and the batch's match plan (`match_plan`: the raw
matrices it names, and each consumer given them) — on the interpod random cluster (zone, hostname and
rack keys: V = 128 > 64 takes the reference's segment_sum branch, V = 16
drops buckets; nil / empty / every-operator selectors; namespaces; the
first-pod affinity escape; negative ANTI_PREF weights; host ports with
wildcard and specific IPs). Also the inter-pod kernels' algorithm written
as csrc/interpod.cu walks it, held to the plain versions. Tolerance:
exact equality, dtype included; every partial count stays below 2^24, the
bound under which the reference's f32 products are exact. On the CPU the
port runs its plain versions."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import filters as RF
from kubernetes_tpu.ops import pipeline as RP
from kubernetes_tpu.ops import topology as RTopo
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.cache import TensorMirror as RMirror
from kubernetes_tpu.state.tensors import PodBatch as RPodBatch
from kubernetes_tpu.state.terms import compile_batch_terms as r_compile

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import fill_cache, random_cluster
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.ops import topology as PTopo
from kubernetes_tpu_torch.state.cache import SchedulerCache as PCache
from kubernetes_tpu_torch.state.cache import TensorMirror as PMirror
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
from kubernetes_tpu_torch.state.terms import compile_batch_terms as p_compile

U = 64


@functools.lru_cache(maxsize=None)
def encoded(pkg, seed, n_nodes=90):
    """(na, ea, xa, ta, au, pa, ids) numpy dicts of one seeded inter-pod
    cluster, through each package's mirror (node, signature and pattern
    banks) and batch encoders."""
    t = RT if pkg == "ref" else PT
    nodes, existing, pending = random_cluster(seed, n_nodes, 48, 260, t=t, topology=True, interpod=True,
                                              overflow_nodes=3)
    cache = (RCache if pkg == "ref" else PCache)()
    fill_cache(cache, nodes, existing)
    mirror = RMirror(cache) if pkg == "ref" else PMirror(cache, device="cpu")
    batch = (RPodBatch if pkg == "ref" else PPodBatch)(mirror.vocab, U)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, aux = (r_compile if pkg == "ref" else p_compile)(mirror.vocab, pending, b_capacity=U)
    ids = (RF if pkg == "ref" else PF).make_ids(mirror.vocab)
    return (mirror.nodes.arrays(), mirror.eps.arrays(), mirror.pats.arrays(), tb.arrays(), aux,
            batch.arrays(), {k: int(v) for k, v in ids.items()})


def both(seed):
    ref = [{k: jnp.asarray(v) for k, v in d.items()} for d in encoded("ref", seed)[:6]]
    port = [arrays_to_torch(d, "cpu") for d in encoded("port", seed)[:6]]
    return ref, port


def same(ref, port):
    a, b = np.asarray(ref), port.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b)


def test_encodings_reach_every_branch():
    """The clusters the tests below run on: every term kind in the batch
    and in the pattern bank, negative weights in both, hostname buckets
    beyond 64, pods with host ports, and partial counts far below 2^24."""
    for seed in (0, 1):
        na, ea, xa, ta, au, pa, _ = encoded("port", seed)
        kinds = set(ta["kind"][ta["valid"]].tolist())
        assert {1, 2, 3, 4} <= kinds  # AFF_REQ, ANTI_REQ, AFF_PREF, ANTI_PREF
        assert {1, 2, 3, 4} <= set(xa["kind"][xa["valid"]].tolist())
        assert (ta["weight"][ta["valid"]] < 0).any() and (xa["weight"][xa["valid"]] < 0).any()
        assert (na["label_dense"].max(axis=0) > 64).any()
        assert (pa["port_num"] > 0).any()
        assert (au["has_aff"] & au["self_aff_match"]).any()
        # the largest partial sum of any product: every pod (or instance)
        # at its largest weight in one bucket
        bound = max(int(ea["counts"].sum()), int(xa["counts"].sum())) * max(
            int(np.abs(ta["weight"]).max()), int(np.abs(xa["weight"]).max()), 1) * xa["valid"].shape[0]
        assert bound < 2**24


FILTER_SUBSETS = [("existing",), ("aff",), ("anti",), ("existing", "aff"), ("existing", "anti"),
                  ("aff", "anti"), ("existing", "aff", "anti")]


@pytest.mark.parametrize("parts", FILTER_SUBSETS, ids=["+".join(p) for p in FILTER_SUBSETS])
@pytest.mark.parametrize("n_buckets", [128, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_interpod_filter_matches_reference(parts, n_buckets, seed):
    (rn, re, rx, rt, ra, rp), (pn, pe, px, pt, pa_, pp) = both(seed)
    r = RTopo.interpod_filter(rn, re, rt, ra, rx, rp, parts=parts, n_buckets=n_buckets)
    p = PTopo.interpod_filter(pn, pe, pt, pa_, px, pp, parts=parts, n_buckets=n_buckets)
    same(r, p)
    live = p[pp["valid"]]
    assert bool(live.any()) and not bool(live.all())


def test_affinity_escape_passes_rows_nothing_matches_yet():
    """Rows whose required affinity matches no existing pod but the pod
    itself pass everywhere; the others are confined to their anchors."""
    (_, _, _, _, _, _), (pn, pe, px, pt, pa_, pp) = both(0)
    got = PTopo.interpod_filter(pn, pe, pt, pa_, px, pp, parts=("aff",), n_buckets=128)
    escaped = pa_["has_aff"] & pa_["self_aff_match"] & got.all(dim=1)
    assert bool(escaped.any())
    assert bool((pa_["has_aff"] & ~got.all(dim=1)).any())


SCORE_PARTS = [("pref",), ("existing",), ("pref", "existing")]


@pytest.mark.parametrize("parts", SCORE_PARTS, ids=["+".join(p) for p in SCORE_PARTS])
@pytest.mark.parametrize("n_buckets", [128, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_interpod_score_matches_reference(parts, n_buckets, seed):
    (rn, re, rx, rt, ra, rp), (pn, pe, px, pt, pa_, pp) = both(seed)
    r = RTopo.interpod_score(rn, re, rt, rx, rp, parts=parts, n_buckets=n_buckets)
    p = PTopo.interpod_score(pn, pe, pt, px, pp, parts=parts, n_buckets=n_buckets)
    same(r, p)
    assert int((p > 0).sum()) > 0 and int(((p > 0) & (p < 10)).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_or_matches_reference(seed):
    rng = np.random.default_rng(seed)
    bad = rng.random((40, 30)) < 0.3
    owner = rng.integers(0, 12, 40).astype(np.int32)
    mask = rng.random(40) < 0.6
    r = RTopo._scatter_or(jnp.asarray(bad), jnp.asarray(owner), jnp.asarray(mask), 12)
    p = PTopo._scatter_or(torch.from_numpy(bad), torch.from_numpy(owner), torch.from_numpy(mask), 12)
    same(r, p)


@pytest.mark.parametrize("n_buckets", [128, 16])
@pytest.mark.parametrize("seed", [0, 1])
def test_inbatch_tensors_match_reference(seed, n_buckets):
    (rn, _, _, rt, _, rp), (pn, _, _, pt, _, pp) = both(seed)
    ids = encoded("port", seed)[6]
    r = RP._inbatch_tensors(rn, rp, rt, {k: jnp.asarray(v) for k, v in ids.items()}, n_buckets)
    p = PP._inbatch_tensors(pn, pp, pt, ids, n_buckets)
    for k in ("anti", "m_bb", "port_conflict"):
        same(r[k], p[k])
    same(r["owner"], p["owner"])
    assert bool(p["port_conflict"].any()) and not bool(p["port_conflict"].all())
    bucket, haskey = PTopo._bucket_of({"label_dense": p["label_dense"]}, p["topo_slot"])
    same(r["bucket_n"], bucket)
    same(r["haskey_n"], haskey)
    assert p["n_buckets"] == np.asarray(r["ca0"]).shape[1]


PLAN_CASES = [
    ("config-3", frozenset({"spread_soft"}), False, set()),
    ("config-3-services", frozenset({"spread_soft", "sel_spread"}), False, {"m_sig"}),
    ("config-3-hard", frozenset({"spread_hard"}), False, set()),
    ("existing-anti", frozenset({"et_anti"}), False, {"m_pt"}),
    ("config-4", frozenset({"anti_req", "pref", "et_anti", "et_score"}), True,
     {"m_sig", "m_pt", "m_bb", "port_conflict"}),
]


@pytest.mark.parametrize("kinds,track,want", [c[1:] for c in PLAN_CASES], ids=[c[0] for c in PLAN_CASES])
def test_match_plan_names_each_matrix_once(kinds, track, want):
    """ops/pipeline.match_plan computes exactly the distinct raw matrices a
    batch's consumers read (the spread programs match inside their own
    launches), each equal to the JAX match_terms on the same inputs, and
    with the in-batch tracking the port table of the same launch, equal to
    the JAX _inbatch_tensors' port_conflict."""
    (rn, re, rx, rt, _, rp), (pn, pe, px, pt, _, pp) = both(2)
    ids = encoded("port", 2)[6]
    plan = PP.match_plan(pp, PP.DEFAULT_SOLVE_CONFIG, kinds, ea=pe, ta=pt, xa=px, track_inbatch=track, ids=ids)
    assert set(plan) == want
    ref = {"m_sig": (rt, re), "m_pt": (rx, rp), "m_bb": (rt, rp)}
    for key, got in plan.items():
        if key == "port_conflict":
            rids = {k: jnp.asarray(v) for k, v in ids.items()}
            same(RP._inbatch_tensors(rn, rp, rt, rids, 16)["port_conflict"], got)
            continue
        terms, subj = ref[key]
        same(RTopo.match_terms(terms, subj["label_vals"], subj["ns_id"]), got)


@pytest.mark.parametrize("n_buckets", [128, 16])
@pytest.mark.parametrize("seed", [2, 3])
def test_consumers_read_the_plan_matrices_exactly(seed, n_buckets):
    """interpod_filter (every subset of its parts), interpod_score (each
    part and both) and _inbatch_tensors given the match plan's raw
    matrices return exactly what they return computing their own."""
    _, (pn, pe, px, pt, pa_, pp) = both(seed)
    ids = encoded("port", seed)[6]
    plan = PP.match_plan(pp, PP.DEFAULT_SOLVE_CONFIG, PP.PORTED_TERM_KINDS, ea=pe, ta=pt, xa=px, track_inbatch=True,
                         ids=ids)
    assert set(plan) == {"m_sig", "m_pt", "m_bb", "port_conflict"}
    for parts in FILTER_SUBSETS:
        assert torch.equal(PTopo.interpod_filter(pn, pe, pt, pa_, px, pp, parts, n_buckets, m_pt=plan["m_pt"],
                                                 m_sig=plan["m_sig"]),
                           PTopo.interpod_filter(pn, pe, pt, pa_, px, pp, parts, n_buckets)), parts
    for parts in SCORE_PARTS:
        assert torch.equal(PTopo.interpod_score(pn, pe, pt, px, pp, parts, n_buckets, m_pt=plan["m_pt"],
                                                m_sig=plan["m_sig"]),
                           PTopo.interpod_score(pn, pe, pt, px, pp, parts, n_buckets)), parts
    got = PP._inbatch_tensors(pn, pp, pt, ids, n_buckets, plan["m_bb"], plan["port_conflict"])
    alone = PP._inbatch_tensors(pn, pp, pt, ids, n_buckets)
    assert got.keys() == alone.keys()
    for k, v in got.items():
        assert torch.equal(v, alone[k]) if isinstance(v, torch.Tensor) else v == alone[k], k


# ---------------------------------------------------------------------------
# csrc/interpod.cu's algorithms, written as its CTAs walk them: the filter's
# clusters (a spec row's items compacted once, chunks of per-bucket tables
# whose bucket slices each CTA owns and every CTA's node slice adds into,
# the tests at each node's clamped bucket, any_pair from each CTA's slices;
# rows without items tabulate nothing) and the score's per-pattern and
# per-term tables, then a block per spec row — buckets >= V dropped from
# the tables and clamped in the gathers. The card tests hold the kernels
# themselves to the plain versions.
# ---------------------------------------------------------------------------


def _bucket(ld, n, slot):
    k = ld.shape[1]
    d = ld[n, 0 if slot < 0 else min(slot, k - 1)]
    return max(d, 0), bool(d >= 0 and slot >= 0)


def _tables(na, rows_valid, slots, per_node, v):
    """Per row: the [V] sums of per_node(row, n) over nodes with the key."""
    ld = na["label_dense"].numpy()
    out = {}
    for r in np.flatnonzero(rows_valid):
        tab = np.zeros(v, np.int64)
        for n in range(ld.shape[0]):
            b, has = _bucket(ld, n, slots[r])
            if has and b < v:
                tab[b] += per_node(r, n)
        out[r] = tab
    return out


def interpod_filter_walk(na, ea, ta, aux, xa, pa, m_pt, m_sig, parts, v, cluster=None, tcap=None):
    """csrc/interpod.cu's filter at C = `cluster` CTAs a spec row and `tcap`
    item tables a chunk (interpod_filter_layout's), cluster by cluster.
    Returns (the mask, the spec rows that tabulated anything)."""
    ld = na["label_dense"].numpy()
    n, k = ld.shape
    tv, tk, town, tslot = (ta[key].numpy() for key in ("valid", "kind", "owner", "topo_slot"))
    xv, xk, xslot = (xa[key].numpy() for key in ("valid", "kind", "topo_slot"))
    xc, ec, ev = xa["counts"].numpy().astype(np.int64), ea["counts"].numpy().astype(np.int64), ea["valid"].numpy()
    m_pt, m_sig = m_pt.numpy(), m_sig.numpy()
    npt, tt, s_all, u_rows = len(xv), len(tv), len(ev), pa["valid"].shape[0]
    lay = PTopo.interpod_filter_layout(npt, tt, n, v, u_rows, cluster, tcap)
    C, sl, vs, tc = lay["C"], lay["slice"], lay["vslice"], lay["tcap"]
    win = PTopo.INTERPOD_SIG_WINDOW

    def dense(slot):  # every node's dense label at the slot (-1: no key)
        d = ld[:, 0 if slot < 0 else min(slot, k - 1)].astype(np.int64)
        return np.where((d >= 0) & (slot >= 0), d, -1)

    out = np.ones((u_rows, n), bool)
    tabulated = []
    for u in range(u_rows):
        want_aff = "aff" in parts and bool(aux["has_aff"][u])
        items = [p for p in range(npt) if "existing" in parts and xv[p] and xk[p] == 2 and m_pt[p, u]]
        items += [npt + t for t in range(tt) if tv[t] and town[t] == u
                  and ((tk[t] == 1 and want_aff) or (tk[t] == 2 and "anti" in parts))]
        if not items:  # the all-pass row; nothing tabulated
            continue
        tabulated.append(u)
        aff_terms = [i - npt for i in items if i >= npt and tk[i - npt] == 1]
        escape = bool(aff_terms) and bool(aux["self_aff_match"][u])

        def node_counts(code):  # each node's count for the item, window by window (int32)
            if code < npt:
                return xc[:, code]
            t, cn = code - npt, np.zeros(n, np.int64)
            for s0 in range(0, s_all, win):
                ss = np.arange(s0, min(s_all, s0 + win))
                ok = ev[ss] & (np.all(m_sig[np.ix_(aff_terms, ss)], axis=0) if tk[t] == 1 else m_sig[t, ss])
                cn += ec[:, ss[ok]].sum(axis=1)
            return cn.astype(np.int32).astype(np.int64)

        ok_st, aff_st, any_cta = np.ones(n, bool), np.ones(n, bool), np.zeros(C, bool)
        per = tc if tc > 0 else 1
        for i0 in range(0, len(items), per):
            chunk = items[i0:i0 + per]
            # CTA r owns buckets [r * vs, (r + 1) * vs) of each table (tc == 0:
            # the same cells in the row's device table); every CTA's node
            # slice adds into the owners' cells
            owned = np.zeros((len(chunk), C, vs), np.int64)
            for j, code in enumerate(chunk):
                d = dense(xslot[code] if code < npt else tslot[code - npt])
                cn = node_counts(code)
                for c in range(C):
                    xs = np.arange(c * sl, min(n, (c + 1) * sl))
                    add = (d[xs] >= 0) & (d[xs] < v) & (cn[xs] != 0)
                    np.add.at(owned[j], (d[xs][add] // vs, d[xs][add] % vs), cn[xs][add])
            owned = owned.astype(np.int32)  # int32 cells
            for j, code in enumerate(chunk):  # the tests at each node's clamped bucket
                d = dense(xslot[code] if code < npt else tslot[code - npt])
                b = np.minimum(np.maximum(d, 0), v - 1)
                present = (d >= 0) & (owned[j][b // vs, b % vs] > 0)
                if code >= npt and tk[code - npt] == 1:
                    aff_st &= present | ~ok_st
                    for r in range(C):  # this CTA's slice of the table
                        any_cta[r] |= escape and bool((owned[j, r, :max(0, min(v, (r + 1) * vs) - r * vs)] > 0).any())
                else:
                    ok_st &= ~present
        any_pair = bool(any_cta.any())
        out[u] = ok_st & (aff_st | (escape and not any_pair))
    return out, tabulated


def interpod_score_walk(na, ea, ta, xa, pa, m_pt, m_sig, parts, v, cluster=None, tcap=None):
    """csrc/interpod.cu's score at C = `cluster` CTAs a spec row and `tcap`
    item tables a chunk (interpod_score_layout's), cluster by cluster: a
    row's items compacted, their tables filled slice by owning slice, each
    node's sum kept across the items, the row's max and min from the CTAs'
    partials. Returns (the score, the spec rows that tabulated anything)."""
    ld = na["label_dense"].numpy()
    n, k = ld.shape
    nv = na["valid"].numpy()
    tv, tk, town, tslot, tw = (ta[key].numpy() for key in ("valid", "kind", "owner", "topo_slot", "weight"))
    xv, xk, xslot, xw = (xa[key].numpy() for key in ("valid", "kind", "topo_slot", "weight"))
    xc, ec, ev = xa["counts"].numpy().astype(np.int64), ea["counts"].numpy().astype(np.int64), ea["valid"].numpy()
    m_pt, m_sig = m_pt.numpy(), m_sig.numpy()
    npt, tt, s_all, u_rows = len(xv), len(tv), len(ev), pa["valid"].shape[0]
    pv = pa["valid"].numpy()
    lay = PTopo.interpod_score_layout(npt, tt, n, v, u_rows, cluster, tcap)
    C, sl, vs, tc = lay["C"], lay["slice"], lay["vslice"], lay["tcap"]
    assert sl <= PTopo.INTERPOD_SCORE_NODES * 256  # each node's sum in one thread's registers
    win = PTopo.INTERPOD_SIG_WINDOW

    @functools.lru_cache(maxsize=None)
    def item(code):  # every node's dense label at the item's slot (-1: no key) and its count (int32, windowed)
        slot = xslot[code] if code < npt else tslot[code - npt]
        d = ld[:, 0 if slot < 0 else min(slot, k - 1)].astype(np.int64)
        d = np.where((d >= 0) & (slot >= 0), d, -1)
        if code < npt:
            return d, xc[:, code]
        t, cn = code - npt, np.zeros(n, np.int64)
        for s0 in range(0, s_all, win):
            ss = np.arange(s0, min(s_all, s0 + win))
            cn += ec[:, ss[ev[ss] & m_sig[t, ss]]].sum(axis=1)
        return d, cn.astype(np.int32).astype(np.int64)

    out = np.zeros((u_rows, n), np.int64)
    tabulated = []
    for u in range(u_rows):
        items = [p for p in range(npt) if "existing" in parts and xv[p] and xk[p] in (1, 3, 4) and m_pt[p, u]]
        items += [npt + t for t in range(tt) if "pref" in parts and tv[t] and town[t] == u and tk[t] in (3, 4)]
        if not pv[u] or not items:  # the zero row; nothing tabulated
            continue
        tabulated.append(u)
        sums = np.zeros(n, np.int64)
        per = tc if tc > 0 else 1
        for i0 in range(0, len(items), per):
            chunk = items[i0:i0 + per]
            # CTA r owns buckets [r * vs, (r + 1) * vs) of each table (tc == 0:
            # the same cells in the row's device table); the CTAs' node
            # slices partition the nodes, and each node adds into its
            # bucket's owner cell
            owned = np.zeros((len(chunk), C, vs), np.int64)
            for j, code in enumerate(chunk):
                d, cn = item(code)
                add = (d >= 0) & (d < v) & (cn != 0)
                np.add.at(owned[j], (d[add] // vs, d[add] % vs), cn[add])
            owned = owned.astype(np.int32)  # int32 cells
            for j, code in enumerate(chunk):  # each node's weighted count at its clamped bucket
                pat = code < npt
                d, _ = item(code)
                b = np.minimum(np.maximum(d, 0), v - 1)
                cnt = owned[j][b // vs, b % vs]
                w = xw[code] if pat else tw[code - npt]
                contrib = cnt.astype(np.int64) * np.int64(w) if pat else (cnt * np.int32(w)).astype(np.int64)
                sums += np.where(d >= 0, contrib, 0)
        # each CTA's max and min over its valid nodes (0 clamped in), then the cluster's
        mx = mn = 0
        for c in range(C):
            xs = np.arange(c * sl, min(n, (c + 1) * sl))
            live = sums[xs][nv[xs]]
            mx, mn = max(mx, int(live.max(initial=0))), min(mn, int(live.min(initial=0)))
        diff = mx - mn
        out[u] = np.where(nv & (diff > 0), (10 * (sums - mn)) // max(diff, 1), 0)
    return out, tabulated


def _walk_inputs(pkg="port"):
    d = encoded(pkg, 2, n_nodes=40)[:6]
    if pkg == "ref":
        return [{k: jnp.asarray(v) for k, v in x.items()} for x in d]
    return [arrays_to_torch(x, "cpu") for x in d]


@pytest.mark.parametrize("n_buckets", [16, 128])
def test_kernel_walk_equals_plain(n_buckets):
    """The inter-pod kernels' algorithms (as csrc/interpod.cu walks them,
    the filter at its default layout) equal the plain versions for every
    filter part and both score parts."""
    pn, pe, px, pt, pa_, pp = _walk_inputs()
    m_pt = PTopo.match_terms(px, pp["label_vals"], pp["ns_id"])
    m_sig = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"])
    aux = {k: v.numpy() for k, v in pa_.items()}
    for parts in FILTER_SUBSETS:
        want = PTopo.interpod_filter_plain(pn, pe, pt, pa_, px, pp, parts, n_buckets).numpy()
        got, _ = interpod_filter_walk(pn, pe, pt, aux, px, pp, m_pt, m_sig, parts, n_buckets)
        assert np.array_equal(got, want), parts
    for parts in SCORE_PARTS:
        want = PTopo.interpod_score_plain(pn, pe, pt, px, pp, parts, n_buckets).numpy()
        got, _ = interpod_score_walk(pn, pe, pt, px, pp, m_pt, m_sig, parts, n_buckets)
        assert np.array_equal(got, want), parts
        assert ((want > 0) & (want < 10)).any()


def _drain_v(na):
    """The segment axis the driver sizes for this cluster (the largest
    dense label count, bucketed)."""
    from kubernetes_tpu_torch.state.tensors import _bucket as bucket

    return bucket(int(na["label_dense"].max()) + 1)


@pytest.mark.parametrize("cluster,tcap", [(None, None), (1, None), (3, 1), (16, None), (2, 0)],
                         ids=["default", "C1", "C3-one-table-a-chunk", "C16", "C2-device"])
@pytest.mark.parametrize("n_buckets", [16, "drain", 64, 40000])
def test_filter_cluster_walk_equals_plain_and_reference(n_buckets, cluster, tcap):
    """The inter-pod filter's one-launch algorithm at 1, 2, 3, 4 and 16
    CTAs a spec row (node and bucket axes no C divides), with its tables in
    shared memory (several a chunk and one a chunk) and in device memory
    (V = 40,000 at one or two CTAs; tcap 0), equals the plain version and
    the JAX reference for every subset of the parts. The batch holds
    invalid padding rows (tabulated only where a pattern matches them: the
    plain version does not mask by validity), a pattern no row matches, and
    rows taking the first-pod escape; exactly the rows with a matching
    pattern or an owned term tabulate."""
    pn, pe, px, pt, pa_, pp = _walk_inputs()
    rn, re, rx, rt, ra, rp = _walk_inputs("ref")
    v = _drain_v(pn) if n_buckets == "drain" else n_buckets
    m_pt = PTopo.match_terms(px, pp["label_vals"], pp["ns_id"])
    m_sig = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"])
    aux = {k: x.numpy() for k, x in pa_.items()}
    anti_x = (px["valid"] & (px["kind"] == 2)).numpy()
    assert (anti_x & ~m_pt.numpy().any(axis=1)).any()  # a pattern no row matches
    assert not bool(pp["valid"].all())
    lay = PTopo.interpod_filter_layout(px["valid"].shape[0], pt["valid"].shape[0], pn["valid"].shape[0], v,
                                       pp["valid"].shape[0], cluster, tcap)
    assert (lay["tcap"] == 0) == (tcap == 0 or (v == 40000 and lay["C"] <= 2))
    escaped = 0
    for parts in FILTER_SUBSETS:
        got, rows = interpod_filter_walk(pn, pe, pt, aux, px, pp, m_pt, m_sig, parts, v, cluster, tcap)
        want = PTopo.interpod_filter_plain(pn, pe, pt, pa_, px, pp, parts, v)
        assert np.array_equal(got, want.numpy()), parts
        same(RTopo.interpod_filter(rn, re, rt, ra, rx, rp, parts=parts, n_buckets=v), torch.from_numpy(got))
        owns = (pt["valid"] & ((pt["kind"] == 1) & torch.tensor("aff" in parts) & pa_["has_aff"][pt["owner"].long()]
                               | (pt["kind"] == 2) & torch.tensor("anti" in parts)))
        work = set(pt["owner"][owns].tolist())
        if "existing" in parts:
            work |= set(np.flatnonzero((m_pt.numpy() & anti_x[:, None]).any(axis=0)).tolist())
        assert set(rows) == work, parts
        if "existing" not in parts:  # padding rows own no term (a pattern may match one: it is tabulated)
            assert not set(rows) & set(np.flatnonzero(~pp["valid"].numpy()).tolist()), parts
        if "aff" in parts:  # rows passing by the escape alone: no pod matches all their terms anywhere
            esc = PTopo.interpod_filter_plain(pn, pe, pt, pa_, px, pp, ("aff",), v)
            escaped += int((esc.all(dim=1) & pa_["has_aff"] & pa_["self_aff_match"] & pp["valid"]).sum())
    assert escaped > 0


@functools.lru_cache(maxsize=None)
def _reference_score(parts, v):
    rn, re, rx, rt, _, rp = _walk_inputs("ref")
    return np.asarray(RTopo.interpod_score(rn, re, rt, rx, rp, parts=parts, n_buckets=v))


SCORE_WALKS = [(16, 1, None), (16, None, None), ("drain", 2, 0), ("drain", 3, 1), (64, 16, None), (64, None, None),
               (40000, 1, None), (40000, 2, None), (40000, 16, None), (40000, None, None)]


@pytest.mark.parametrize("n_buckets,cluster,tcap", SCORE_WALKS,
                         ids=["V16-C1", "V16-default-C4", "drain-C2-device", "drain-C3-one-table-a-chunk", "V64-C16",
                              "V64-default-C4", "V40000-C1-device", "V40000-C2-device", "V40000-C16",
                              "V40000-default-C4"])
def test_score_cluster_walk_equals_plain_and_reference(n_buckets, cluster, tcap):
    """The inter-pod score's one-launch algorithm at 1, 2, 3, 4 and 16 CTAs
    a spec row (node and bucket axes no C > 2 divides) over V = 16, the
    drain's V, 64 and 40,000, with its tables in shared memory (several a
    chunk and one a chunk) and in device memory (V = 40,000 at one or two
    CTAs, and tcap 0), equals the plain version and the JAX reference for
    each part and both. Exactly the valid rows with a
    matching score pattern or an owned preferred term tabulate: padding
    rows and rows without items write zero rows untabulated."""
    pn, pe, px, pt, _, pp = _walk_inputs()
    v = _drain_v(pn) if n_buckets == "drain" else n_buckets
    m_pt = PTopo.match_terms(px, pp["label_vals"], pp["ns_id"])
    m_sig = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"])
    lay = PTopo.interpod_score_layout(px["valid"].shape[0], pt["valid"].shape[0], pn["valid"].shape[0], v,
                                      pp["valid"].shape[0], cluster, tcap)
    assert (lay["tcap"] == 0) == (tcap == 0 or (v == 40000 and lay["C"] <= 2))
    assert lay["C"] == (cluster or 4)  # 64 rows: the default doubles C to 4
    valid = pp["valid"].numpy()
    assert not valid.all()
    xk, tk = px["kind"].numpy(), pt["kind"].numpy()
    x_score = (px["valid"].numpy() & np.isin(xk, [1, 3, 4]))[:, None] & m_pt.numpy()
    owners = pt["owner"].numpy()[pt["valid"].numpy() & np.isin(tk, [3, 4])]
    for parts in SCORE_PARTS:
        got, rows = interpod_score_walk(pn, pe, pt, px, pp, m_pt, m_sig, parts, v, cluster, tcap)
        want = PTopo.interpod_score_plain(pn, pe, pt, px, pp, parts, v, m_pt=m_pt, m_sig=m_sig)
        assert np.array_equal(got, want.numpy()), parts
        assert np.array_equal(got, _reference_score(parts, v)), parts
        work = set(owners.tolist()) if "pref" in parts else set()
        if "existing" in parts:
            work |= set(np.flatnonzero(x_score.any(axis=0)).tolist())
        assert set(rows) == work & set(np.flatnonzero(valid).tolist()), parts
        assert set(rows) < set(range(pp["valid"].shape[0])), parts  # some rows tabulate nothing


def test_score_layout_raises_past_its_node_ceiling():
    """The score keeps each node's sum in registers: at most 4,096 nodes a
    CTA and 16 CTAs a spec row, so 65,536 node rows fit and one more
    raises."""
    lay = PTopo.interpod_score_layout(32, 32, 65536, 16, 32)
    assert lay["C"] == 16 and lay["slice"] == PTopo.INTERPOD_SCORE_NODES * 256 == 4096
    with pytest.raises(ValueError):
        PTopo.interpod_score_layout(32, 32, 65537, 16, 32)
