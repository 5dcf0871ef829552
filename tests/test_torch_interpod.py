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
    ("config-4", frozenset({"anti_req", "pref", "et_anti", "et_score"}), True, {"m_sig", "m_pt", "m_bb"}),
]


@pytest.mark.parametrize("kinds,track,want", [c[1:] for c in PLAN_CASES], ids=[c[0] for c in PLAN_CASES])
def test_match_plan_names_each_matrix_once(kinds, track, want):
    """ops/pipeline.match_plan computes exactly the distinct raw matrices a
    batch's consumers read (the spread programs match inside their own
    launches), each equal to the JAX match_terms on the same inputs."""
    (rn, re, rx, rt, _, rp), (pn, pe, px, pt, _, pp) = both(2)
    plan = PP.match_plan(pp, PP.DEFAULT_SOLVE_CONFIG, kinds, ea=pe, ta=pt, xa=px, track_inbatch=track)
    assert set(plan) == want
    ref = {"m_sig": (rt, re), "m_pt": (rx, rp), "m_bb": (rt, rp)}
    for key, got in plan.items():
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
    plan = PP.match_plan(pp, PP.DEFAULT_SOLVE_CONFIG, PP.PORTED_TERM_KINDS, ea=pe, ta=pt, xa=px, track_inbatch=True)
    assert set(plan) == {"m_sig", "m_pt", "m_bb"}
    for parts in FILTER_SUBSETS:
        assert torch.equal(PTopo.interpod_filter(pn, pe, pt, pa_, px, pp, parts, n_buckets, m_pt=plan["m_pt"],
                                                 m_sig=plan["m_sig"]),
                           PTopo.interpod_filter(pn, pe, pt, pa_, px, pp, parts, n_buckets)), parts
    for parts in SCORE_PARTS:
        assert torch.equal(PTopo.interpod_score(pn, pe, pt, px, pp, parts, n_buckets, m_pt=plan["m_pt"],
                                                m_sig=plan["m_sig"]),
                           PTopo.interpod_score(pn, pe, pt, px, pp, parts, n_buckets)), parts
    got, alone = PP._inbatch_tensors(pn, pp, pt, ids, n_buckets, plan["m_bb"]), PP._inbatch_tensors(pn, pp, pt, ids,
                                                                                                   n_buckets)
    assert got.keys() == alone.keys()
    for k, v in got.items():
        assert torch.equal(v, alone[k]) if isinstance(v, torch.Tensor) else v == alone[k], k


# ---------------------------------------------------------------------------
# csrc/interpod.cu's algorithm, written as its blocks walk it: per-bucket
# tables of the patterns and terms (for required affinity, of the
# signatures matching every AFF_REQ term of the owner), then per spec row
# the gathers at each node's bucket — buckets >= V dropped from the tables
# and clamped in the gathers. The card tests hold the kernels themselves
# to the plain versions.
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


def interpod_walk(na, ea, ta, aux, xa, pa, m_pt, m_sig, parts, v, which):
    ld = na["label_dense"].numpy()
    n_nodes = ld.shape[0]
    nv = na["valid"].numpy()
    tv, tk, town, tslot, tw = (ta[k].numpy() for k in ("valid", "kind", "owner", "topo_slot", "weight"))
    xv, xk, xslot, xw = (xa[k].numpy() for k in ("valid", "kind", "topo_slot", "weight"))
    xc, ec, ev = xa["counts"].numpy().astype(np.int64), ea["counts"].numpy().astype(np.int64), ea["valid"].numpy()
    m_pt, m_sig = m_pt.numpy(), m_sig.numpy()
    u_rows = pa["valid"].shape[0]
    pv = pa["valid"].numpy()

    def term_sigs(t):
        if tk[t] == 1:  # AFF_REQ: signatures matching every AFF_REQ term of the owner
            group = [q for q in range(len(tv)) if tv[q] and tk[q] == 1 and town[q] == town[t]]
            return np.flatnonzero(ev & np.all(m_sig[group], axis=0))
        return np.flatnonzero(ev & m_sig[t])

    def gather(tab, slot, n):
        b, has = _bucket(ld, n, slot)
        return has, tab[min(b, v - 1)]

    if which == "filter":
        x_kinds, t_kinds = ({2} if "existing" in parts else set()), \
            ({1} if "aff" in parts else set()) | ({2} if "anti" in parts else set())
    else:
        x_kinds, t_kinds = ({1, 3, 4} if "existing" in parts else set()), ({3, 4} if "pref" in parts else set())
    xt = _tables(na, xv & np.isin(xk, list(x_kinds)), xslot, lambda r, n: xc[n, r], v)
    sig_of = {t: term_sigs(t) for t in np.flatnonzero(tv & np.isin(tk, list(t_kinds)))}
    tt = _tables(na, tv & np.isin(tk, list(t_kinds)), tslot, lambda r, n: ec[n, sig_of[r]].sum(), v)
    if which == "filter":
        out = np.ones((u_rows, n_nodes), bool)
        for u in range(u_rows):
            pats = [p for p in xt if xk[p] == 2 and m_pt[p, u]]
            aff = [t for t in tt if tk[t] == 1 and town[t] == u]
            anti = [t for t in tt if tk[t] == 2 and town[t] == u]
            for n in range(n_nodes):
                ok = not any(h and c > 0 for h, c in (gather(xt[p], xslot[p], n) for p in pats))
                if ok and "aff" in parts and aux["has_aff"][u]:
                    aff_ok = all(h and c > 0 for h, c in (gather(tt[t], tslot[t], n) for t in aff))
                    any_pair = any((tt[t] > 0).any() for t in aff)
                    ok = aff_ok or (not any_pair and bool(aux["self_aff_match"][u]))
                if ok and any(h and c > 0 for h, c in (gather(tt[t], tslot[t], n) for t in anti)):
                    ok = False
                out[u, n] = ok
        return out
    out = np.zeros((u_rows, n_nodes), np.int64)
    for u in range(u_rows):
        pref = [t for t in tt if town[t] == u]
        pats = [p for p in xt if m_pt[p, u]]
        c = np.zeros(n_nodes, np.int64)
        for n in range(n_nodes):
            for t in pref:
                h, cnt = gather(tt[t], tslot[t], n)
                c[n] += int(np.int32(cnt) * np.int32(tw[t])) if h else 0
            for p in pats:
                h, cnt = gather(xt[p], xslot[p], n)
                c[n] += int(xw[p]) * int(cnt) if h else 0
        live = nv & pv[u]
        mx, mn = max(int(c[live].max(initial=0)), 0), min(int(c[live].min(initial=0)), 0)
        diff = mx - mn
        out[u] = np.where(live & (diff > 0), (10 * (c - mn)) // max(diff, 1), 0)
    return out


@pytest.mark.parametrize("n_buckets", [16, 128])
def test_kernel_walk_equals_plain(n_buckets):
    """The inter-pod kernels' algorithm (as csrc/interpod.cu walks it)
    equals the plain versions for every filter part and both score parts."""
    pn, pe, px, pt, pa_, pp = (arrays_to_torch(d, "cpu") for d in encoded("port", 2, n_nodes=40)[:6])
    m_pt = PTopo.match_terms(px, pp["label_vals"], pp["ns_id"])
    m_sig = PTopo.match_terms(pt, pe["label_vals"], pe["ns_id"])
    aux = {k: v.numpy() for k, v in pa_.items()}
    for parts in FILTER_SUBSETS:
        want = PTopo.interpod_filter_plain(pn, pe, pt, pa_, px, pp, parts, n_buckets).numpy()
        got = interpod_walk(pn, pe, pt, aux, px, pp, m_pt, m_sig, parts, n_buckets, "filter")
        assert np.array_equal(got, want), parts
    for parts in SCORE_PARTS:
        want = PTopo.interpod_score_plain(pn, pe, pt, px, pp, parts, n_buckets).numpy()
        got = interpod_walk(pn, pe, pt, aux, px, pp, m_pt, m_sig, parts, n_buckets, "score")
        assert np.array_equal(got, want), parts
        assert ((want > 0) & (want < 10)).any()
