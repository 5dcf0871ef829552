"""The port's filter (plain version on CPU) against the reference's JAX
filter_masks / combined_mask on identical encoded inputs: every predicate
on its own and several Policy predicate subsets. Tolerance: exact equality
(boolean masks)."""

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
