"""The port's filter (plain version on CPU) against the reference's JAX
filter_masks / combined_mask on identical encoded inputs: every predicate
on its own and several Policy predicate subsets; and csrc/filters.cu's
tiles walked in Python (rows staged with live lanes compacted, node
fields once a tile, int32 / int64 pod counts, the device-memory path).
Tolerance: exact equality (boolean masks)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import filters as RF
from kubernetes_tpu.oracle.nodeinfo import Snapshot
from kubernetes_tpu.state.tensors import PodBatch, encode_snapshot

from kubernetes_tpu_torch.models.clusters import random_cluster
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.state.convert import arrays_to_torch


def encoded(seed, n_nodes=40, n_pending=48, n_existing=40, overflow_nodes=2):
    """The reference encoder's numpy arrays for a seeded all-branches
    cluster, as JAX inputs and as torch CPU inputs."""
    nodes, existing, pending = random_cluster(
        seed, n_nodes, n_pending, n_existing, t=RT, overflow_nodes=overflow_nodes, pending_ports=True
    )
    bank, _, _ = encode_snapshot(Snapshot(nodes, existing))
    batch = PodBatch(bank.vocab, 64)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    na, pa = bank.arrays(), batch.arrays()
    jids = RF.make_ids(bank.vocab)
    return (
        ({k: jnp.asarray(v) for k, v in na.items()}, {k: jnp.asarray(v) for k, v in pa.items()}, jids),
        (arrays_to_torch(na, "cpu"), arrays_to_torch(pa, "cpu"), {k: int(v) for k, v in jids.items()}),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_each_predicate_matches_reference(seed):
    (jn, jp, jids), (tn, tp, tids) = encoded(seed)
    ref = RF.filter_masks(jn, jp, jids)
    port = PF.filter_masks(tn, tp, tids)
    assert ref.keys() == port.keys()
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), port[k].numpy()), k
    # the cluster really exercises each predicate: each rejects some pair
    for k in ("unschedulable", "selector", "resources", "taints", "ports"):
        assert not bool(port[k].all()), k


SUBSETS = [
    None,
    frozenset({"GeneralPredicates"}),
    frozenset({"GeneralPredicates", "PodToleratesNodeTaints", "CheckNodeUnschedulable"}),
    frozenset({"PodToleratesNodeTaints"}),
    frozenset({"MatchNodeSelector", "HostName"}),
    frozenset({"PodFitsResources", "PodFitsHostPorts"}),
    frozenset(),
]


@pytest.mark.parametrize("preds", SUBSETS, ids=lambda s: "all" if s is None else "+".join(sorted(s)) or "none")
def test_combined_mask_subsets_match_reference(preds):
    (jn, jp, jids), (tn, tp, tids) = encoded(11)
    ref = np.asarray(RF.combined_mask(jn, jp, jids, predicates=preds))
    port = PF.combined_mask(tn, tp, tids, preds)
    assert port.dtype == torch.bool
    assert np.array_equal(ref, port.numpy())


def test_fallback_nodes_and_invalid_rows_are_masked():
    (jn, jp, jids), (tn, tp, tids) = encoded(7, overflow_nodes=5)
    port = PF.combined_mask(tn, tp, tids).numpy()
    fb = tn["fallback"].numpy()
    assert fb.sum() == 5 and not port[:, fb].any()
    assert not port[~tp["valid"].numpy()].any()  # padded spec rows
    assert np.array_equal(np.asarray(RF.combined_mask(jn, jp, jids)), port)


# --- csrc/filters.cu's tiles, walked as its CTAs walk them --------------------

_OPS = {1: "in", 2: "not_in", 3: "exists", 4: "dne", 5: "gt", 6: "lt", 7: "name_in", 8: "name_not_in", 9: "never"}


def _stage(pa, u, k, staged):
    """One spec row as the kernel's warp stages it (live lanes compacted),
    or its padded lanes (the device-memory path)."""
    g = {key: x[u] for key, x in pa.items()}
    req_any = bool(g["req_any"])
    row = {"valid": bool(g["valid"]), "pinned": int(g["node_name_id"]), "req_any": req_any,
           "has_required": bool(g["has_required"])}
    lanes = range(len(g["tol_key"]))
    row["tols"] = [(bool(g["tol_valid"][i]), g["tol_key"][i], g["tol_op"][i], g["tol_val"][i], g["tol_effect"][i])
                   for i in lanes if g["tol_valid"][i] or not staged]
    row["pairs"] = [(min(int(sl), k - 1) if staged else int(sl), g["sel_pair_val"][j])
                    for j, sl in enumerate(g["sel_pair_slot"]) if sl >= 0 or not staged]
    row["res"] = [(r, int(q)) for r, q in enumerate(g["req"]) if not staged or (req_any and (r < 3 or q > 0))]
    row["ports"] = [(g["port_num"][i], g["port_proto"][i], g["port_ip"][i])
                    for i in range(len(g["port_num"])) if g["port_num"][i] > 0 or not staged]
    row["terms"] = []
    for t in range(len(g["term_valid"])):
        if staged and not (row["has_required"] and g["term_valid"][t]):
            continue
        reqs = []
        for q in range(len(g["term_req_op"][t])):
            op = int(g["term_req_op"][t][q])
            if staged and op not in _OPS:
                continue
            vals = [int(x) for x in g["term_req_vals"][t][q]]
            if staged:  # lane 0 first, repeated -1 padding dropped
                kept, pad = [], False
                for i, x in enumerate(vals):
                    if i == 0 or x != -1 or not pad:
                        kept.append(x)
                    pad |= x == -1
                vals = kept
            reqs.append((op, int(g["term_req_slot"][t][q]), vals, int(g["term_req_num"][t][q])))
        row["terms"].append((bool(g["term_valid"][t]), reqs))
    return row


def _eval_req(op, slot, vals, num, na, n, k):
    sc = 0 if slot < 0 else min(slot, k - 1)
    known = slot >= 0
    nv = na["label_vals"][n, sc]
    present = known and nv != 0
    name = _OPS.get(op)
    if name in ("in", "not_in"):
        return (present and nv in vals) if name == "in" else (not present or nv not in vals)
    if name in ("exists", "dne"):
        return present if name == "exists" else not present
    if name in ("gt", "lt"):
        num_n = na["label_num"][n, sc]
        return known and bool(na["label_num_ok"][n, sc]) and (num_n > num if name == "gt" else num_n < num)
    if name in ("name_in", "name_not_in"):
        return (na["name_id"][n] == vals[0]) == (name == "name_in")
    return name != "never"


def _selector(row, na, n, k):
    for sl, val in row["pairs"]:
        if sl >= 0 and na["label_vals"][n, min(sl, k - 1)] != val:
            return False
    if not row["has_required"]:
        return True
    return any(ok_t and all(_eval_req(*q, na, n, k) for q in reqs) for ok_t, reqs in row["terms"])


def _tolerated(row, key, val, eff):
    return any(ok and (te == 0 or te == eff) and (tk == 0 or tk == key) and (to == 1 or tv == val)
               for ok, tk, to, tv, te in row["tols"])


def _count_ok(na, n):
    pc, al = na["pod_count"], na["allowed_pods"]
    c1 = int(pc[n]) + 1
    if pc.dtype == np.int32:
        c1 = ((c1 + 2**31) % 2**32) - 2**31
    return c1 <= int(al[n])


def tile_walk(na, pa, ids, predicates=None, tile=None):
    """(mask, raw selector, layout) of the tile kernel's algorithm."""
    dims = dict(N=na["valid"].shape[0], U=pa["valid"].shape[0], K=na["label_vals"].shape[1],
                R=na["alloc"].shape[1], T=na["taint_key"].shape[1], P=na["port_num"].shape[1],
                TL=pa["tol_key"].shape[1], NSP=pa["sel_pair_slot"].shape[1], TERMS=pa["term_valid"].shape[1],
                REQS=pa["term_req_op"].shape[2], VALS=pa["term_req_vals"].shape[3], PP=pa["port_num"].shape[1])
    lay = PF.filter_layout(dims, tile)
    na = {key: x.numpy() for key, x in na.items()}
    pa = {key: x.numpy() for key, x in pa.items()}
    n_all, u_all, k = dims["N"], dims["U"], dims["K"]
    on = set(PF.enabled_masks(predicates))
    staged = bool(lay["staged"])
    out = np.zeros((u_all, n_all), bool)
    sel_out = np.zeros((u_all, n_all), bool)
    for u0 in range(0, u_all, lay["UT"]):
        rows = [_stage(pa, u, k, staged) for u in range(u0, min(u_all, u0 + lay["UT"]))]
        for n0 in range(0, n_all, lay["NT"]):
            for n in range(n0, min(n_all, n0 + lay["NT"])):
                alive = bool(na["valid"][n]) and not na["fallback"][n]
                count_ok = _count_ok(na, n)
                free = na["alloc"][n] - na["requested"][n]
                taints = [(na["taint_key"][n, t], na["taint_val"][n, t], na["taint_effect"][n, t])
                          for t in range(dims["T"]) if na["taint_effect"][n, t] in (1, 3)]
                for i, row in enumerate(rows):
                    u = u0 + i
                    sel = _selector(row, na, n, k)
                    sel_out[u, n] = sel
                    ok = row["valid"] and alive
                    if ok and "unschedulable" in on and na["unschedulable"][n]:
                        ok = _tolerated(row, ids["unschedulable_key"], ids["empty_val"], 1)
                    if ok and "host" in on:
                        ok = row["pinned"] in (0, na["name_id"][n])
                    if ok and "resources" in on:
                        ok = count_ok and (not row["req_any"] or all(
                            q <= free[r] for r, q in row["res"] if r < 3 or q > 0))
                    if ok and "taints" in on:
                        ok = all(_tolerated(row, *tn) for tn in taints)
                    if ok and "selector" in on:
                        ok = sel
                    if ok and "ports" in on:
                        ok = not any(a > 0 and b > 0 and a == b and pa_ == pb and (
                            ia == ids["wildcard_ip"] or ib == ids["wildcard_ip"] or ia == ib)
                            for a, pa_, ia in row["ports"] for b, pb, ib in zip(
                                na["port_num"][n], na["port_proto"][n], na["port_ip"][n]))
                    out[u, n] = ok
    return out, sel_out, lay


_encoded_once = functools.lru_cache(maxsize=None)(encoded)  # the walks read these arrays, never write them


def _cut(tn, tp, n, u):
    """The arrays cut to n nodes and u spec rows (no tile divides them)."""
    return ({key: x[:n] for key, x in tn.items()}, {key: x[:u] for key, x in tp.items()})


@pytest.mark.parametrize("tile", [None, (32, 128), (16, 128), (16, 32), (3, 64)],
                         ids=["8x256", "32x128", "16x128", "16x32", "3x64"])
@pytest.mark.parametrize("preds", SUBSETS, ids=lambda s: "all" if s is None else "+".join(sorted(s)) or "none")
def test_filter_tile_walk_matches_reference(preds, tile):
    """The tile kernel's algorithm equals combined_mask_plain, its raw
    selector output pod_match_node_selector, and the JAX combined_mask,
    under every predicate subset and several tiles, with U and N not
    multiples of the tile, fallback nodes and invalid (padded) rows."""
    (jn, jp, jids), (tn, tp, tids) = _encoded_once(11, n_nodes=45, n_pending=50)
    tn, tp = _cut(tn, tp, 47, 53)  # two padded node rows, three padded spec rows
    jn, jp = _cut(jn, jp, 47, 53)
    got, sel, lay = tile_walk(tn, tp, tids, preds, tile)
    assert lay["staged"] == 1 and 53 % lay["UT"] and 47 % lay["NT"]
    assert np.array_equal(got, PF.combined_mask_plain(tn, tp, tids, preds).numpy())
    assert np.array_equal(got, np.asarray(RF.combined_mask(jn, jp, jids, predicates=preds)))
    assert np.array_equal(sel, PF.pod_match_node_selector(tn, tp).numpy())
    assert tn["fallback"].numpy().any() and not tp["valid"].numpy().all()
    assert got.any() and not got.all()


@pytest.mark.parametrize("case", ["int64", "pod-count-int64", "allowed-int64", "int32-wrap", "int64-wrap"])
def test_filter_tile_walk_pod_count_widths(case):
    """The pod count and allowed pods read at the width the caller holds
    them (the carried state's int64, either alone), int32 arithmetic wrapping
    like the reference's at 2^31 - 1: the walk equals the plain version on
    the same arrays and the JAX mask on the int32 values."""
    (jn, jp, jids), (tn, tp, tids) = _encoded_once(5)
    tn = dict(tn)
    if case in ("int64", "pod-count-int64", "int64-wrap"):
        tn["pod_count"] = tn["pod_count"].long()
    if case in ("int64", "allowed-int64", "int64-wrap"):
        tn["allowed_pods"] = tn["allowed_pods"].long()
    base = PF.combined_mask_plain(tn, tp, tids).numpy()
    cols = np.flatnonzero(base.any(0))[:3]  # nodes some row fits
    if case.endswith("wrap"):
        tn["pod_count"] = tn["pod_count"].clone()
        tn["pod_count"][cols] = 2**31 - 1
    got, sel, _ = tile_walk(tn, tp, tids)
    assert np.array_equal(got, PF.combined_mask_plain(tn, tp, tids).numpy())
    if not case.endswith("wrap"):
        assert np.array_equal(got, np.asarray(RF.combined_mask(jn, jp, jids)))
    elif case == "int32-wrap":  # the count + 1 wraps negative: still fits
        assert len(cols) == 3 and np.array_equal(got[:, cols], base[:, cols])
    else:  # int64 does not wrap: full
        assert len(cols) == 3 and not got[:, cols].any()


def test_filter_tile_walk_device_memory_path():
    """Widths past the shared-memory budget (7,000 toleration lanes a spec
    row, those past the encoder's 8 invalid) take the device-memory path:
    the same mask from the padded rows."""
    (_, _, _), (tn, tp, tids) = encoded(3, n_pending=12)
    tp = {k: v[:12] for k, v in tp.items()}
    for key in ("tol_key", "tol_op", "tol_val", "tol_effect", "tol_valid"):
        tp[key] = torch.cat([tp[key], torch.zeros(12, 7000 - tp[key].shape[1], dtype=tp[key].dtype)], 1)
    got, sel, lay = tile_walk(tn, tp, tids)
    assert lay["staged"] == 0 and lay["smem"] == 0
    assert np.array_equal(got, PF.combined_mask_plain(tn, tp, tids).numpy())
    assert np.array_equal(sel, PF.pod_match_node_selector(tn, tp).numpy())
    assert got.any() and not got.all()


def test_filter_layout():
    """The tile: 8 spec rows of the default widths and 256 nodes; wider
    rows halve the rows a CTA; the bytes are the kernel's formula."""
    dims = dict(N=6144, U=128, K=64, R=8, T=8, P=32, TL=8, NSP=8, TERMS=4, REQS=6, VALS=8, PP=8)
    lay = PF.filter_layout(dims)
    n32 = 12 + 4 * 8 + 3 * 8 + 8 + 3 * 8 + 4 + 4 * 24 + 24 * 8
    assert lay == {"UT": 8, "NT": 256, "row_bytes": 8 * (8 + 24) + 4 * n32, "staged": 1,
                   "smem": 8 * (8 * (8 + 24) + 4 * n32) + 8 * 64}
    # an odd count of int64 lanes (R + TERMS * REQS = 23) pads to 24: the
    # int32 lanes stay 16-byte aligned
    odd = PF.filter_layout({**dims, "TERMS": 3, "REQS": 5})
    assert odd["row_bytes"] == -(-(8 * 24 + 4 * (12 + 4 * 8 + 3 * 8 + 8 + 3 * 8 + 3 + 4 * 15 + 15 * 8)) // 16) * 16
    wide = PF.filter_layout({**dims, "VALS": 200})
    assert wide["staged"] == 1 and wide["UT"] < 8


# --- ops/pipeline.filter_mask: the extender /filter path ---------------------

def term_encoded(pkg, seed):
    """(na, ea, xa, ta, au, pa, ids, term kinds) of a seeded cluster with
    DoNotSchedule spread and every inter-pod term kind (in the batch and
    among the bound pods), through each package's mirror and encoders."""
    from kubernetes_tpu.ops import filters as rf
    from kubernetes_tpu.state.cache import SchedulerCache as RCache
    from kubernetes_tpu.state.cache import TensorMirror as RMirror
    from kubernetes_tpu.state.terms import compile_batch_terms as r_compile
    from kubernetes_tpu_torch.api import types as PT
    from kubernetes_tpu_torch.models.clusters import fill_cache
    from kubernetes_tpu_torch.scheduler.driver import _term_kind_names
    from kubernetes_tpu_torch.state.cache import SchedulerCache as PCache
    from kubernetes_tpu_torch.state.cache import TensorMirror as PMirror
    from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
    from kubernetes_tpu_torch.state.terms import compile_batch_terms as p_compile

    ref = pkg == "ref"
    nodes, existing, pending = random_cluster(seed, 70, 40, 200, t=RT if ref else PT, topology=True,
                                              hard_spread=True, interpod=True, pending_ports=True)
    cache = (RCache if ref else PCache)()
    fill_cache(cache, nodes, existing)
    mirror = RMirror(cache) if ref else PMirror(cache, device="cpu")
    batch = (PodBatch if ref else PPodBatch)(mirror.vocab, 64)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, aux = (r_compile if ref else p_compile)(mirror.vocab, pending, b_capacity=64)
    ids = (rf if ref else PF).make_ids(mirror.vocab)
    conv = (lambda d: {k: jnp.asarray(v) for k, v in d.items()}) if ref else (lambda d: arrays_to_torch(d, "cpu"))
    kinds = _term_kind_names(set(tb.kind[tb.valid].tolist()), bool((aux["n_sel_spread"] > 0).any()), mirror.pats)
    return ([conv(d) for d in (mirror.nodes.arrays(), mirror.eps.arrays(), mirror.pats.arrays(), tb.arrays(), aux,
                               batch.arrays())] + [{k: int(v) for k, v in ids.items()}, kinds])


GATES = {
    "all": None,
    "general": frozenset({"GeneralPredicates", "PodToleratesNodeTaints"}),
    "spread": frozenset({"GeneralPredicates", "EvenPodsSpread"}),
    "interpod": frozenset({"GeneralPredicates", "MatchInterPodAffinity"}),
    "both": frozenset({"GeneralPredicates", "EvenPodsSpread", "MatchInterPodAffinity", "CheckNodeUnschedulable"}),
}


@pytest.mark.parametrize("kinds_mode", ["present", "assume-all"])
@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_mask_matches_reference(seed, gate, kinds_mode):
    """filter_mask with every term kind present (DoNotSchedule spread,
    required affinity and anti-affinity in the batch, the bound pods'
    anti-affinity) under both predicate gates (EvenPodsSpread,
    MatchInterPodAffinity) and without them; term_kinds exact or None (the
    reference's "assume everything", as its extender passes it)."""
    from kubernetes_tpu.ops import pipeline as RP
    from kubernetes_tpu_torch.ops import pipeline as PP

    rn, re_, rx, rt, ra, rp, rids, kinds = term_encoded("ref", seed)
    pn, pe, px, pt, pa_, pp, pids, pkinds = term_encoded("port", seed)
    assert kinds == pkinds and {"spread_hard", "aff_req", "anti_req", "et_anti"} <= kinds
    preds = GATES[gate]
    tk = kinds if kinds_mode == "present" else None
    ref = np.asarray(RP.filter_mask(rn, rp, re_, rt, rx, ra, rids, config=RP.SolveConfig(predicates=preds),
                                    term_kinds=tk, n_buckets=256))
    port = PP.filter_mask(pn, pp, pids, PP.SolveConfig(predicates=preds), tk, ea=pe, ta=pt, au=pa_, xa=px,
                          n_buckets=256)
    assert port.dtype == torch.bool
    assert np.array_equal(ref, port.numpy())
    # the same gating as the solve's mask, and the plain composition
    mask, _ = PP.mask_and_score(pn, pp, pids, PP.SolveConfig(predicates=preds), tk, ea=pe, ta=pt, au=pa_, xa=px,
                                n_buckets=256)
    assert torch.equal(port, mask)
    assert torch.equal(port, PP.filter_mask_plain(pn, pp, pids, PP.SolveConfig(predicates=preds), tk, ea=pe,
                                                  ta=pt, au=pa_, xa=px, n_buckets=256))
    live = port[pp["valid"]]
    assert bool(live.any()) and not bool(live.all())
