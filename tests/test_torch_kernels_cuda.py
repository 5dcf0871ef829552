"""Each hand-written CUDA kernel against its plain PyTorch version on the
card, on seeded all-branches clusters: filter (and its raw node-selector
output), score, solve, match_terms, spread_score and selector_spread_score.
Needs an NVIDIA card and nvcc:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips (decided in the fixture, so every worker
collects the same tests). Tolerance: exact equality — masks are boolean,
scores int64 (BalancedAllocation's and SelectorSpread's float64 truncate
identically; the library is built with -fmad=false), assignments and
carries integers."""

import pytest
import torch

from kubernetes_tpu_torch.models.clusters import random_cluster, random_selectors
from kubernetes_tpu_torch.ops import filters as F
from kubernetes_tpu_torch.ops import scores as S
from kubernetes_tpu_torch.ops import solver as SO
from kubernetes_tpu_torch.ops import topology as TO
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch, encode_snapshot
from kubernetes_tpu_torch.state.terms import compile_batch_terms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def cluster(seed, device):
    nodes, existing, pending = random_cluster(seed, 300, 200, 400, overflow_nodes=4, pending_ports=True)
    bank, _, _ = encode_snapshot(Snapshot(nodes, existing))
    batch = PodBatch(bank.vocab, 256)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    return (arrays_to_torch(bank.arrays(), device), arrays_to_torch(batch.arrays(), device),
            F.make_ids(bank.vocab))


@pytest.mark.parametrize("preds", [None, frozenset({"GeneralPredicates"}),
                                   frozenset({"PodToleratesNodeTaints", "CheckNodeUnschedulable"})])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_kernel_equals_plain(cuda, seed, preds):
    na, pa, ids = cluster(seed, cuda)
    before = F.combined_mask.launches
    got = F.combined_mask(na, pa, ids, preds)
    assert F.combined_mask.launches == before + 1
    assert torch.equal(got, F.combined_mask_plain(na, pa, ids, preds))


@pytest.mark.parametrize("prios", [None, (("MostRequestedPriority", 2), ("ResourceLimitsPriority", 1)),
                                   tuple((n, i + 1) for i, n in enumerate(S.PRIORITIES))])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_kernel_equals_plain(cuda, seed, prios):
    na, pa, _ = cluster(seed, cuda)
    before = S.score_matrix.launches
    got = S.score_matrix(na, pa, prios, bias=20)
    assert S.score_matrix.launches == before + 1
    assert torch.equal(got, S.score_matrix_plain(na, pa, prios, bias=20))


def test_score_kernel_refuses_rtcr(cuda):
    na, pa, _ = cluster(0, cuda)
    with pytest.raises(NotImplementedError, match="RequestedToCapacityRatio"):
        S.score_matrix(na, pa, (("RequestedToCapacityRatioPriority", 1),))


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_kernel_equals_plain(cuda, seed, det):
    na, pa, ids = cluster(seed, cuda)
    mask = F.combined_mask(na, pa, ids)
    score = S.score_matrix(na, pa)
    b = 640
    sig = (torch.arange(b, device=cuda) % 200).to(torch.int32)
    pod_valid = torch.arange(b, device=cuda) < b - 40
    order = SO.pop_order((torch.arange(b, device=cuda) % 3).to(torch.int32),
                         torch.arange(b, dtype=torch.int32, device=cuda), pod_valid)
    args = (mask, score, pa["req"], na["alloc"] - na["requested"], na["pod_count"].long(),
            na["allowed_pods"].long(), order, SO.prng_key_data(seed))
    kw = dict(deterministic=det, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid,
              return_carry=True, nz0=na["nonzero_req"], scoring_req=pa["scoring_req"])
    before = SO.solve_greedy.launches
    got, carry = SO.solve_greedy(*args, **kw)
    assert SO.solve_greedy.launches == before + 1
    want, want_carry = SO.solve_greedy_plain(*args, **kw)
    assert torch.equal(got, want)
    for a, c in zip(carry, want_carry):
        assert torch.equal(a, c)
    assert int((got >= 0).sum()) > 50


def topology_cluster(seed, device, n_nodes=200):
    """(na, ea, ta, au, pa) of a seeded cluster reaching every topology
    branch: zone / hostname / rack keys, nodes without a key, fallback
    nodes, every selector kind, deleting pods, 0-2 spreading selectors."""
    nodes, existing, pending = random_cluster(seed, n_nodes, 150, 600, overflow_nodes=3, topology=True)
    bank, sigs, _ = encode_snapshot(Snapshot(nodes, existing))
    batch = PodBatch(bank.vocab, 256)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    fn = random_selectors()
    tb, aux = compile_batch_terms(bank.vocab, pending, spread_selectors={id(p): fn(p) for p in pending},
                                  b_capacity=256)
    return [arrays_to_torch(d, device) for d in (bank.arrays(), sigs.arrays(), tb.arrays(), aux,
                                                 batch.arrays())] + [F.make_ids(bank.vocab)]


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_raw_selector_output_equals_plain(cuda, seed):
    na, _, _, _, pa, ids = topology_cluster(seed, cuda)
    mask, sel = F.combined_mask(na, pa, ids, with_selector=True)
    assert torch.equal(mask, F.combined_mask_plain(na, pa, ids))
    assert torch.equal(sel, F.pod_match_node_selector(na, pa))


@pytest.mark.parametrize("with_ns", [False, True], ids=["all-namespaces", "namespaces"])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_terms_kernel_equals_plain(cuda, seed, with_ns):
    _, ea, ta, _, _, _ = topology_cluster(seed, cuda)
    ns = ea["ns_id"] if with_ns else None
    before = TO.match_terms.launches
    got = TO.match_terms(ta, ea["label_vals"], ns)
    assert TO.match_terms.launches == before + 1
    assert torch.equal(got, TO.match_terms_plain(ta, ea["label_vals"], ns))


@pytest.mark.parametrize("n_buckets", [16, 256, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_spread_kernel_equals_plain(cuda, seed, n_buckets):
    """V = 16 drops the hostname buckets, 256 holds them in shared memory,
    40,000 takes the device-memory table."""
    na, ea, ta, au, pa, _ = topology_cluster(seed, cuda)
    sel = F.pod_match_node_selector(na, pa)
    before = TO.spread_score.launches
    got = TO.spread_score(na, ea, ta, au, sel, n_buckets=n_buckets)
    assert TO.spread_score.launches == before + 1
    assert torch.equal(got, TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=n_buckets))


@pytest.mark.parametrize("n_buckets", [16, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_selector_spread_kernel_equals_plain(cuda, seed, n_buckets):
    na, ea, ta, au, _, _ = topology_cluster(seed, cuda)
    before = TO.selector_spread_score.launches
    got = TO.selector_spread_score(na, ea, ta, au, n_buckets=n_buckets)
    assert TO.selector_spread_score.launches == before + 1
    assert torch.equal(got, TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=n_buckets))
