"""The port's term compiler against the reference's: for the same seeded
pods and selectors, `compile_batch_terms` gives equal TermBank arrays and
aux arrays key for key, dtype included, equal overflow owners, and
`count_batch_terms` the same count. Cases: soft and hard spread
constraints, nil / empty / matchLabels / every expression operator,
spreading selectors (0, 1, 2 per pod), namespaces, and term-table
overflow (too many pairs, expressions, values or namespaces, and a bank
smaller than the batch's terms). Tolerance: exact equality."""

import numpy as np
import pytest

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.state import terms as RTerms
from kubernetes_tpu.state.tensors import Vocab as RVocab

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import random_cluster, random_selectors
from kubernetes_tpu_torch.state import terms as PTerms
from kubernetes_tpu_torch.state.tensors import Vocab as PVocab


def assert_same_arrays(ref, port):
    assert ref.keys() == port.keys(), sorted(set(ref) ^ set(port))
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert np.array_equal(a, b), k


def _pods(t, seed, n=40):
    _, _, pending = random_cluster(seed, 10, n, 0, t=t, topology=True, hard_spread=True)
    return pending


def _overflow(t, pods):
    """Pods whose terms overflow a term row in every way the bank records."""
    sel = t.LabelSelector(match_labels={f"k{i}": "v" for i in range(5)})
    pods[0].topology_spread_constraints = [t.TopologySpreadConstraint(
        max_skew=1, topology_key="zone", when_unsatisfiable="ScheduleAnyway", label_selector=sel)]
    req = t.LabelSelectorRequirement(key="app", operator="In", values=[f"v{i}" for i in range(8)])
    pods[1].topology_spread_constraints = [t.TopologySpreadConstraint(
        max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule",
        label_selector=t.LabelSelector(match_expressions=[req] * 5))]
    pods[2].affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
        label_selector=t.LabelSelector(), namespaces=[f"ns{i}" for i in range(6)], topology_key="zone")]))
    pods[3].affinity = t.Affinity(pod_affinity=t.PodAffinity(
        required=[t.PodAffinityTerm(label_selector=t.LabelSelector(match_labels={"app": "web"}),
                                    topology_key="zone")],
        preferred=[t.WeightedPodAffinityTerm(weight=7, pod_affinity_term=t.PodAffinityTerm(
            label_selector=None, topology_key="rack"))]))
    return pods


def _compile(pkg, seed, selectors, overflow, capacity=None):
    t, terms, vocab = (RT, RTerms, RVocab()) if pkg == "ref" else (PT, PTerms, PVocab())
    pods = _pods(t, seed)
    if overflow:
        pods = _overflow(t, pods)
    sel = None
    if selectors:
        fn = random_selectors(t)
        sel = {id(p): fn(p) for p in pods}
    count = terms.count_batch_terms(pods, sel)
    tb, aux = terms.compile_batch_terms(vocab, pods, spread_selectors=sel, capacity=capacity, b_capacity=64)
    return count, tb, aux


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("selectors", [False, True], ids=["no-selectors", "selectors"])
@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
def test_compile_batch_terms_key_for_key(seed, selectors, overflow):
    r_count, rtb, raux = _compile("ref", seed, selectors, overflow)
    p_count, ptb, paux = _compile("port", seed, selectors, overflow)
    assert r_count == p_count == int(rtb.count)
    assert rtb.capacity == ptb.capacity and rtb.count == ptb.count
    assert_same_arrays(rtb.arrays(), ptb.arrays())
    assert_same_arrays(raux, paux)
    assert rtb.overflow_owners == ptb.overflow_owners
    assert bool(ptb.overflow_owners) == overflow
    kinds = set(np.unique(ptb.kind[ptb.valid]).tolist())
    assert {PTerms.SPREAD_SOFT, PTerms.SPREAD_HARD} <= kinds
    assert (PTerms.SEL_SPREAD in kinds) == selectors


def test_short_bank_capacity_is_a_floor():
    """A capacity below the batch's term count is clamped up to the exact
    count's bucket (no row lands in overflow_owners)."""
    r_count, rtb, raux = _compile("ref", 3, True, False, capacity=16)
    p_count, ptb, paux = _compile("port", 3, True, False, capacity=16)
    assert p_count > 16 and ptb.capacity >= p_count and not ptb.overflow_owners
    assert_same_arrays(rtb.arrays(), ptb.arrays())


@pytest.mark.parametrize("selectors", [False, True], ids=["no-selectors", "selectors"])
def test_count_pod_terms_matches_encode(selectors):
    """count_pod_terms counts the rows encode_pod_terms emits for every
    kind: spread (hard, soft), required and preferred pod (anti-)affinity,
    spreading selectors."""
    pods = _overflow(PT, _pods(PT, 4))
    fn = random_selectors(PT)
    for p in pods:
        sel = fn(p) if selectors else None
        rows, aux = PTerms.encode_pod_terms(p, sel)
        assert PTerms.count_pod_terms(p, sel) == len(rows)
        assert aux["n_sel_spread"] == len(sel or ())
