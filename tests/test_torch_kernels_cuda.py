"""Each hand-written CUDA kernel against its plain PyTorch version on the
card, on seeded all-branches clusters: filter (and its raw node-selector
output), score, solve (with and without in-batch tracking), match_terms
(and its multi-problem launch, 1-4 problems, narrow tiles for wide label
rows), spread_score (one launch, no match launch, at V = 16, 64, 256 and
40,000 and every rows-a-cluster choice; a small config-4 drain launches
one match a batch), selector_spread_score, interpod_filter (every subset of its
parts), interpod_score (each part and both; one kernel in the profiler, at
1-16 CTAs a spec row, device-memory tables at V = 40,000),
inbatch_port_conflict, spread_filter, the commit arbiter, the commit fold
(its tensor wrapper and the packed path, duplicates, int16 carries and
counts of both signs; TensorMirror.fold_commit one pinned copy and one
kernel in the profiler), the preemption victim
search, the nominee overlay's usage fold, the host oracle's score-row gather and
the two-pass gang solve, and the ingest and term planes' slab gather and row
scatter (the batch gather at row bytes 1 to 256, pointers only 4-byte
aligned, one and two problems, the config-3 and config-5 shapes, its
wrapper under the sync debug mode; a small drain through both planes, cuda
== cpu, one gather launch a batch); the score
kernel's RequestedToCapacityRatio branch (three shapes) and component
mode (score_components), and the extender's filter_mask composition; the
node mesh's cluster launches (csrc/solver.cu's solve, tracked solve and
gang mode, csrc/arbiter.cu's scan, csrc/fold.cu's sharded folds) at 1, 2, 4 and 8
shards against their plain versions and the single-device kernels, and a
16-CTA cluster run or refused; the single-device solve as a cluster of 1
to 16 CTAs with its residuals in shared memory (every mode, padded node
rows, all-tied scores, R = 32, runs of one spec and none, the three
election synchronisations) and its counted device-memory path, and the
arbiter's hoisted facts with its tables in shared and in device memory,
and at the config-3-hard and config-4 batch shapes (chip_smoke.py's); the
victim search on runs of repeated specs, on config 6's round with one
spec and with a new spec every step (its reuse counts) and past shared
memory (its counted device-memory path); the score kernel's clusters at
the node axis's edges and at the config-2 and config-3 shapes, in all
three modes; the spread filter as one launch (no match_terms launch) at
V = 16, 64, 256 and 40,000 (its device-memory tables counted), every
table cell, and at 1, 3, 4, 8 and 16 CTAs a spec row on node axes no C
divides with rows owning 0, 1 and 2 hard terms; the mask at every tile
shape, with int32 and int64 pod counts read in place, and past shared
memory (its counted device-memory path).
Needs an NVIDIA card and nvcc:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test skips (decided in the fixture, so every worker
collects the same tests). Tolerance: exact equality — masks are boolean,
scores int64 (BalancedAllocation's and SelectorSpread's float64 truncate
identically; the library is built with -fmad=false), assignments and
carries integers."""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.models.clusters import fill_cache, random_cluster, random_selectors
from kubernetes_tpu_torch.ops import filters as F
from kubernetes_tpu_torch.ops import scores as S
from kubernetes_tpu_torch.ops import solver as SO
from kubernetes_tpu_torch.ops import topology as TO
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot
from kubernetes_tpu_torch.state.cache import SchedulerCache, TensorMirror
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch, encode_snapshot
from kubernetes_tpu_torch.state.terms import SPREAD_HARD, compile_batch_terms

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


@pytest.mark.parametrize("widths", ["int32", "int64", "pod-count-int64", "allowed-int64"])
def test_filter_kernel_reads_counts_at_their_width(cuda, widths):
    """int64 pod counts and allowed pods (a carried state) are read in
    place: the struct holds the caller's tensors, no conversion launches."""
    na, pa, ids = cluster(0, cuda)
    na = dict(na)
    if widths in ("int64", "pod-count-int64"):
        na["pod_count"] = na["pod_count"].long()
    if widths in ("int64", "allowed-int64"):
        na["allowed_pods"] = na["allowed_pods"].long()
    args, out, _ = F.filter_args(na, pa, ids)
    assert args.n_pod_count == na["pod_count"].data_ptr() and args.n_allowed_pods == na["allowed_pods"].data_ptr()
    before = F.combined_mask.launches
    for preds in (None, frozenset({"PodFitsResources"})):
        got = F.combined_mask(na, pa, ids, preds)
        assert torch.equal(got, F.combined_mask_plain(na, pa, ids, preds))
    assert F.combined_mask.launches == before + 2


@pytest.mark.parametrize("tile", [(16, 128), (32, 128), (8, 256), (3, 64)])
def test_filter_kernel_tiles_equal_plain(cuda, tile):
    """Every tile shape, with U and N not multiples of it, mask and raw
    selector against the plain versions."""
    from kubernetes_tpu_torch.kernels import build

    na, pa, ids = cluster(1, cuda)
    na = {k: v[:299] for k, v in na.items()}
    pa = {k: v[:253] for k, v in pa.items()}
    for preds in (None, frozenset({"GeneralPredicates"}), frozenset({"MatchNodeSelector", "HostName"})):
        args, out, sel = F.filter_args(na, pa, ids, preds, with_selector=True, tile=tile)
        assert args.staged == 1 and (args.UT, args.NT) == tile
        build.launch(F.FILTER_ENTRY, args, cuda)
        assert torch.equal(out, F.combined_mask_plain(na, pa, ids, preds))
        assert torch.equal(sel, F.pod_match_node_selector(na, pa))


def test_filter_kernel_device_memory_path(cuda):
    """Widths past the shared-memory budget (7,000 toleration lanes a spec
    row, those past the encoder's 8 invalid) take the counted device-memory
    path, exact."""
    na, pa, ids = cluster(0, cuda)
    pa = {k: v[:12] for k, v in pa.items()}
    for k in ("tol_key", "tol_op", "tol_val", "tol_effect", "tol_valid"):
        pa[k] = torch.cat([pa[k], torch.zeros(12, 7000 - pa[k].shape[1], dtype=pa[k].dtype, device=cuda)], 1)
    before = F.combined_mask.device_memory_launches
    mask, sel = F.combined_mask(na, pa, ids, with_selector=True)
    assert F.combined_mask.device_memory_launches == before + 1
    assert torch.equal(mask, F.combined_mask_plain(na, pa, ids))
    assert torch.equal(sel, F.pod_match_node_selector(na, pa))


@pytest.mark.parametrize("prios", [None, (("MostRequestedPriority", 2), ("ResourceLimitsPriority", 1)),
                                   tuple((n, i + 1) for i, n in enumerate(S.PRIORITIES))])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_kernel_equals_plain(cuda, seed, prios):
    na, pa, _ = cluster(seed, cuda)
    before = S.score_matrix.launches
    got = S.score_matrix(na, pa, prios, bias=20)
    assert S.score_matrix.launches == before + 1
    assert torch.equal(got, S.score_matrix_plain(na, pa, prios, bias=20))


RTCR_CASES = {
    "default": ((("RequestedToCapacityRatioPriority", 2), ("NodeAffinityPriority", 1)), None),
    "binpack": ((("RequestedToCapacityRatioPriority", 2), ("TaintTolerationPriority", 1)),
                (((0, 0), (100, 10)), (("cpu", 1), ("memory", 1)))),
    "down": ((("RequestedToCapacityRatioPriority", 1), ("LeastRequestedPriority", 1)),
             (((0, 2), (20, 9), (45, 1), (80, 6), (100, 0)), (("cpu", 3), ("memory", 1)))),
}


@pytest.mark.parametrize("case", list(RTCR_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_score_kernel_rtcr_matches_plain(cuda, seed, case):
    """The RTCR branch: the default shape, a two-point bin-packing shape
    and a five-point shape with a down-sloping segment (Go's truncating
    division) over cpu 3 / memory 1, beside other priorities; one launch."""
    na, pa, _ = cluster(seed, cuda)
    prios, rtcr = RTCR_CASES[case]
    before, before_rtcr = S.score_matrix.launches, S.score_matrix.rtcr_launches
    got = S.score_matrix(na, pa, prios, rtcr, bias=10)
    assert S.score_matrix.launches == before + 1 and S.score_matrix.rtcr_launches == before_rtcr + 1
    assert torch.equal(got, S.score_matrix_plain(na, pa, prios, rtcr, bias=10))


@pytest.mark.parametrize("images", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_components_kernel_equals_plain(cuda, seed, images):
    na, pa, _ = cluster(seed, cuda)
    if not images:
        na = {k: v for k, v in na.items() if k != "image_scaled"}
    before = S.score_components.launches
    got = S.score_components(na, pa)
    assert S.score_components.launches == before + 1
    want = S.score_components_plain(na, pa)
    assert list(got) == list(want) and len(got) == (7 if images else 6)
    for name in want:
        assert torch.equal(got[name], want[name]), name


SCORE_MODES = {
    "default": None,
    "rtcr": ((("RequestedToCapacityRatioPriority", 2), ("NodeAffinityPriority", 1), ("TaintTolerationPriority", 1),
              ("LeastRequestedPriority", 1)),
             (((0, 2), (20, 9), (45, 1), (80, 6), (100, 0)), (("cpu", 3), ("memory", 1)))),
}


def score_mode_equal(na, pa, mode):
    """The kernel against its plain version in one mode: the default tuple,
    an RTCR Policy with a down-sloping segment beside NodeAffinity and
    TaintToleration, or the component planes."""
    if mode == "components":
        got, want = S.score_components(na, pa), S.score_components_plain(na, pa)
        assert list(got) == list(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
        return want
    prios, rtcr = SCORE_MODES[mode] or (None, None)
    got = S.score_matrix(na, pa, prios, rtcr, bias=10)
    assert torch.equal(got, S.score_matrix_plain(na, pa, prios, rtcr, bias=10))
    return None


def tiled_nodes(na, n):
    """The node bank's rows repeated to exactly n rows."""
    reps = -(-n // na["valid"].shape[0])
    return {k: torch.cat([v] * reps)[:n].contiguous() for k, v in na.items()}


SCORE_EDGES = {"below-a-tile": 100, "ragged": 1000, "ragged-multi-tile": 2600, "all-invalid": 700,
               "max-beyond-cta-0": 1500, "raws-in-device-memory": 140000}


@pytest.mark.parametrize("mode", ["default", "rtcr", "components"])
@pytest.mark.parametrize("edge", list(SCORE_EDGES))
def test_score_kernel_edge_shapes_equal_plain(cuda, edge, mode):
    """The score kernel's clusters at the node axis's edges: N below one
    tile (one CTA a row), N not a multiple of the tile (one and several
    tiles a CTA), no valid node (NodeAffinity 0, TaintToleration 10), and
    every valid node in CTA 1's tiles (the row maxima come from another
    CTA of the cluster), and 140,000 nodes over 4 spec rows (the raw values
    kept in device memory between the passes), exact in all three modes."""
    na, pa, _ = cluster(0, cuda)
    n = SCORE_EDGES[edge]
    na = tiled_nodes(na, n)
    if edge == "raws-in-device-memory":
        pa = {k: v[:4].contiguous() for k, v in pa.items()}
    u = pa["valid"].shape[0]
    lay = S.score_layout(n, u, True, pa["pref_valid"].shape[1], pa["pref_req_op"].shape[2],
                         pa["pref_req_vals"].shape[3], pa["tol_key"].shape[1], pa["image_ids"].shape[1])
    assert lay["C"] * lay["TPC"] * S.SCORE_TILE >= n
    assert lay["raw_shared"] == (edge != "raws-in-device-memory")
    if edge == "below-a-tile":
        assert lay["C"] == 1
    if edge == "ragged-multi-tile":
        assert lay["TPC"] > 1 and n % S.SCORE_TILE
    if edge == "all-invalid":
        na["valid"] = torch.zeros_like(na["valid"])
    cta1 = None
    if edge == "max-beyond-cta-0":
        assert lay["C"] > 1
        tile = torch.arange(n, device=cuda) // S.SCORE_TILE
        cta1 = (tile % lay["C"]) == 1
        na["valid"] = na["valid"] & cta1
    want = score_mode_equal(na, pa, mode)
    if want is not None and edge == "all-invalid":
        assert bool((want["taint_toleration"] == 10).all()) and bool((want["node_affinity"] == 0).all())
    if want is not None and cta1 is not None:
        assert bool((want["node_affinity"][:, cta1] == 10).any())


_MAIN_SHAPES = {}


def main_path_score_inputs(config):
    """The first batch's score inputs as the driver builds them, on the
    CPU: config 2 (5,000 nodes: N = 6,144) and config 3 (10,000 nodes: N =
    10,240), 4,096 pods deduplicated to their spec rows (U = 128)."""
    from kubernetes_tpu_torch.models.clusters import bench_config2, bench_config3
    from kubernetes_tpu_torch.state.tensors import dedup_specs, pow2_bucket

    if config not in _MAIN_SHAPES:
        if config == "config-2":
            nodes, pods = bench_config2(5000, 4096)
        else:
            nodes, pods, _ = bench_config3(10000, 4096)
        cache = SchedulerCache()
        fill_cache(cache, nodes, [])
        mirror = TensorMirror(cache, "cpu")
        reps, _ = dedup_specs(pods, None)
        batch = PodBatch(mirror.vocab, pow2_bucket(len(reps)))
        for i, p in enumerate(reps):
            batch.set_pod(i, p)
        _MAIN_SHAPES[config] = ({k: v.clone() for k, v in mirror.device_arrays()[0].items()}, batch.arrays())
    return _MAIN_SHAPES[config]


@pytest.mark.parametrize("mode", ["default", "rtcr", "components"])
@pytest.mark.parametrize("config", ["config-2", "config-3"])
def test_score_kernel_at_the_main_path_shapes_equals_plain(cuda, config, mode):
    nodes, pods = main_path_score_inputs(config)
    na, pa = {k: v.to(cuda) for k, v in nodes.items()}, arrays_to_torch(pods, cuda)
    assert na["valid"].shape[0] == (6144 if config == "config-2" else 10240) and pa["valid"].shape[0] == 128
    score_mode_equal(na, pa, mode)


@pytest.mark.parametrize("preds", [None, frozenset({"GeneralPredicates", "EvenPodsSpread"}),
                                   frozenset({"GeneralPredicates", "MatchInterPodAffinity"})])
@pytest.mark.parametrize("seed", [0, 1])
def test_filter_mask_equals_plain_and_launches_no_score_kernel(cuda, seed, preds):
    """ops/pipeline.filter_mask on a cluster with DoNotSchedule spread and
    every inter-pod term kind: equal to its plain composition, and no
    score, spread-score or inter-pod-score kernel launched."""
    nodes, existing, pending = random_cluster(seed, 200, 150, 600, overflow_nodes=0, topology=True, hard_spread=True,
                                              interpod=True, pending_ports=True)
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    mirror = TensorMirror(cache, cuda)
    batch = PodBatch(mirror.vocab, 256)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, aux = compile_batch_terms(mirror.vocab, pending, b_capacity=256)
    na, ea, xa = mirror.device_arrays()
    ta, au, pa = (arrays_to_torch(d, cuda) for d in (tb.arrays(), aux, batch.arrays()))
    ids = F.make_ids(mirror.vocab)
    cfg = PP.SolveConfig(predicates=preds)
    score_counts = lambda: (S.score_matrix.launches, TO.spread_score.launches, TO.interpod_score.launches,  # noqa: E731
                            TO.selector_spread_score.launches)
    before, calls = score_counts(), PP.filter_mask.launches
    got = PP.filter_mask(na, pa, ids, cfg, None, ea=ea, ta=ta, au=au, xa=xa, n_buckets=256)
    torch.cuda.synchronize()
    assert score_counts() == before and PP.filter_mask.launches == calls + 1
    assert torch.equal(got, PP.filter_mask_plain(na, pa, ids, cfg, None, ea=ea, ta=ta, au=au, xa=xa, n_buckets=256))
    assert bool(got[pa["valid"]].any()) and not bool(got[pa["valid"]].all())


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
    before, problems = TO.match_terms.launches, TO.match_terms.problems
    got = TO.match_terms(ta, ea["label_vals"], ns)
    assert TO.match_terms.launches == before + 1 and TO.match_terms.problems == problems + 1
    assert torch.equal(got, TO.match_terms_plain(ta, ea["label_vals"], ns))


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_multi_problem_match_equals_plain_per_problem(cuda, seed, count):
    """One launch for 1-4 problems of different shapes (terms x signatures
    with and without namespaces, patterns x spec rows, terms x spec rows),
    each equal to its plain version."""
    na, ea, xa, ta, au, pa, ids = interpod_cluster(seed, cuda)
    problems = [(ta, ea["label_vals"], ea["ns_id"]), (xa, pa["label_vals"], pa["ns_id"]),
                (ta, pa["label_vals"], pa["ns_id"]), (ta, ea["label_vals"], None)][:count]
    before, n_problems = TO.match_terms.launches, TO.match_terms.problems
    got = TO.match_terms_multi(problems)
    assert TO.match_terms.launches == before + 1 and TO.match_terms.problems == n_problems + count
    for (terms, labels, ns), g in zip(problems, got):
        assert torch.equal(g, TO.match_terms_plain(terms, labels, ns))


def test_match_kernel_stages_only_the_named_slots(cuda):
    """Label rows of 1,024 slots (only the slots a tile's tests name are
    staged) and selectors of 64 matchLabels and 64 expressions a term (1,024
    slots a tile: tiles of 8 subjects); the matches equal the plain
    version's."""
    _, ea, ta, _, _, _ = topology_cluster(0, cuda)
    wide = torch.zeros((ea["label_vals"].shape[0], 1024), dtype=torch.int32, device=cuda)
    wide[:, :ea["label_vals"].shape[1]] = ea["label_vals"]
    for ns in (None, ea["ns_id"]):
        assert torch.equal(TO.match_terms(ta, wide, ns), TO.match_terms_plain(ta, wide, ns))
    pad = {"ml_slot": -1, "ml_val": 0, "ex_op": 0, "ex_slot": -1, "ex_vals": -1}
    wide_terms = dict(ta)
    for key, fill in pad.items():
        t = ta[key]
        w = torch.full((t.shape[0], 64) + tuple(t.shape[2:]), fill, dtype=t.dtype, device=cuda)
        w[:, :t.shape[1]] = t
        wide_terms[key] = w.contiguous()
    assert TO.match_layout(1024, 64, 64, ta["ex_vals"].shape[2], ta["ns_ids"].shape[1])["xtile"] == 8
    for ns in (None, ea["ns_id"]):
        assert torch.equal(TO.match_terms(wide_terms, wide, ns), TO.match_terms_plain(wide_terms, wide, ns))


@pytest.mark.parametrize("n_buckets", [16, 64, 256, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_spread_kernel_equals_plain(cuda, seed, n_buckets):
    """One launch a call and no match launch (the matches inside it): V =
    16 drops the hostname buckets in shared-memory tables, 64 and 256 hold
    them (in shared or device memory as the layout says: the tables are
    [TT, V]), 40,000 takes the device-memory tables; a device-memory launch
    counted."""
    na, ea, ta, au, pa, _ = topology_cluster(seed, cuda)
    sel = F.pod_match_node_selector(na, pa)
    before, matches, dev_tables = TO.spread_score.launches, TO.match_terms.launches, \
        TO.spread_score.device_table_launches
    got = TO.spread_score(na, ea, ta, au, sel, n_buckets=n_buckets)
    assert TO.spread_score.launches == before + 1 and TO.match_terms.launches == matches
    lay = TO.spread_score_layout(ta["valid"].shape[0], na["valid"].shape[0], n_buckets, pa["valid"].shape[0],
                                 ta["ml_slot"].shape[1], ta["ex_op"].shape[1], ta["ex_vals"].shape[2])
    assert TO.spread_score.device_table_launches == dev_tables + int(lay["copies"] == 0)
    assert lay["copies"] > 0 if n_buckets == 16 else (lay["copies"] == 0 if n_buckets == 40000 else True)
    assert torch.equal(got, TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=n_buckets))


@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
@pytest.mark.parametrize("rows,ctas,gcap", [(1, None, None), (4, None, None), (16, None, None),
                                            (256, None, None), (3, 5, None), (16, 1, None), (7, 16, None),
                                            (16, None, 2), (4, 3, 1)])
def test_spread_kernel_rows_a_cluster_equal_plain(cuda, rows, ctas, gcap, n_buckets):
    """Every rows-a-cluster choice (1, 4, 16, all; and 3, 7 and 16 rows on
    5, 16 and 1 CTAs, node axes no C divides) writes exactly the plain
    score, with the tables in shared memory and (V = 40,000) in device
    memory, and where a cluster's rows hold more groups than its shared
    tables (gcap 1 and 2: those clusters take the device tables); rows
    owning 0, 1 and 2 soft terms."""
    na, ea, ta, au, pa, _ = topology_cluster(2, cuda, n_nodes=203)
    sel = F.pod_match_node_selector(na, pa)
    want = TO.spread_score_plain(na, ea, ta, au, sel, n_buckets=n_buckets)
    args, out = TO.spread_args(na, ea, ta, sel, n_buckets, rows=rows, cluster=ctas, gcap=gcap)
    build.launch(TO.SPREAD_ENTRY, args, cuda)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert bool((want > 0).any()) and bool(((want > 0) & (want < 10)).any())


@pytest.mark.parametrize("n_buckets", [16, 64, 256, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_selector_spread_kernel_equals_plain(cuda, seed, n_buckets):
    """One launch a call (none of match_terms when given the plan's m_sig),
    exact at V = 16, 64, 256 and 40,000; the device-memory zone tables (V =
    40,000) counted."""
    na, ea, ta, au, _, _ = topology_cluster(seed, cuda)
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    before, dev_tables, matches = (TO.selector_spread_score.launches, TO.selector_spread_score.device_table_launches,
                                   TO.match_terms.launches)
    got = TO.selector_spread_score(na, ea, ta, au, n_buckets=n_buckets, m_sig=m_sig)
    torch.cuda.synchronize()
    assert TO.selector_spread_score.launches == before + 1 and TO.match_terms.launches == matches
    lay = TO.selector_spread_layout(ta["valid"].shape[0], na["valid"].shape[0], n_buckets, au["n_sel_spread"].shape[0])
    assert TO.selector_spread_score.device_table_launches == dev_tables + int(lay["mode"] == 2)
    assert (lay["mode"] == 2) == (n_buckets == 40000)
    want = TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=n_buckets)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) >= 3


def tiled_topology(na, ea, n):
    """The node bank and the signature counts repeated to exactly n node
    rows (every row's counts beside its node's)."""
    reps = -(-n // na["valid"].shape[0])
    return tiled_nodes(na, n), {**ea, "counts": torch.cat([ea["counts"]] * reps)[:n].contiguous()}


@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
@pytest.mark.parametrize("mode", [None, 1, 2], ids=["default", "slices", "device"])
@pytest.mark.parametrize("ctas", [1, 3, 4, 16])
def test_selector_spread_cluster_sizes_and_modes_equal_plain(cuda, ctas, mode, n_buckets):
    """The cluster kernel at C = 1, 3, 4 and 16 CTAs a spec row on a node
    axis no C > 1 divides (203 rows, odd: the last node pair is ragged),
    its zone tables local, in bucket slices of shared memory and in device
    memory, against the plain version."""
    from kubernetes_tpu_torch.kernels import build

    na, ea, ta, au, _, _ = topology_cluster(3, cuda)
    na, ea = tiled_topology(na, ea, 203)
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    if (ctas, mode, n_buckets) == (1, 1, 40000):  # one CTA's slice of 40,000 int64 buckets: past shared memory
        with pytest.raises(ValueError):
            TO.selector_spread_args(na, ea, ta, au, m_sig, n_buckets, cluster=ctas, mode=mode)
        return
    args, out = TO.selector_spread_args(na, ea, ta, au, m_sig, n_buckets, cluster=ctas, mode=mode)
    default = 0 if n_buckets <= TO.SEL_LOCAL_V else (1 if 8 * -(-n_buckets // ctas) <= TO.SEL_SLICE_BYTES else 2)
    assert args.C == ctas and args.mode == (mode if mode is not None else default)
    build.launch(TO.SEL_SPREAD_ENTRY, args, cuda)
    torch.cuda.synchronize()
    assert torch.equal(out, TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=n_buckets))


@pytest.mark.parametrize("ctas", [None, 8, 16])
@pytest.mark.parametrize("n_buckets", [16, 16384])
def test_selector_spread_kernel_at_the_main_path_width(cuda, n_buckets, ctas):
    """At config 3's node axis (N = 10,240: a CTA's 1,280 to 2,560 nodes in
    registers, 3 to 5 node pairs a thread) the kernel writes exactly the
    plain score; V = 16,384 takes the bucket slices."""
    from kubernetes_tpu_torch.kernels import build

    na, ea, ta, au, _, _ = topology_cluster(0, cuda)
    na, ea = tiled_topology(na, ea, 10240)
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    args, out = TO.selector_spread_args(na, ea, ta, au, m_sig, n_buckets, cluster=ctas)
    assert args.mode == (0 if n_buckets == 16 else 1)
    build.launch(TO.SEL_SPREAD_ENTRY, args, cuda)
    torch.cuda.synchronize()
    assert torch.equal(out, TO.selector_spread_score_plain(na, ea, ta, au, n_buckets=n_buckets))


def interpod_cluster(seed, device, n_nodes=200):
    """(na, ea, xa, ta, au, pa, ids) of a seeded cluster reaching every
    inter-pod branch: zone / hostname / rack keys, every selector kind,
    namespaces, existing pods with every term kind (negative weights),
    pending pods with required (anti-)affinity, the first-pod escape,
    preferred terms and host ports."""
    nodes, existing, pending = random_cluster(seed, n_nodes, 150, 600, overflow_nodes=3, topology=True,
                                              interpod=True)
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    mirror = TensorMirror(cache, device)
    batch = PodBatch(mirror.vocab, 256)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, aux = compile_batch_terms(mirror.vocab, pending, b_capacity=256)
    na, ea, xa = mirror.device_arrays()
    return [na, ea, xa] + [arrays_to_torch(d, device) for d in (tb.arrays(), aux, batch.arrays())] + \
        [F.make_ids(mirror.vocab)]


FILTER_SUBSETS = [("existing",), ("aff",), ("anti",), ("existing", "aff"), ("existing", "anti"),
                  ("aff", "anti"), ("existing", "aff", "anti")]


@pytest.mark.parametrize("n_buckets", [16, 256, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_interpod_filter_kernel_equals_plain(cuda, seed, n_buckets):
    """Every subset of the parts: one launch a call, none of match_terms
    when given the plan's m_pt / m_sig; V = 16 drops the hostname buckets,
    256 holds the tables in shared memory, 40,000 takes the device-memory
    tables (U = 256: one CTA a spec row), counted."""
    na, ea, xa, ta, au, pa, _ = interpod_cluster(seed, cuda)
    m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    lay = TO.interpod_filter_layout(xa["valid"].shape[0], ta["valid"].shape[0], na["valid"].shape[0], n_buckets,
                                    pa["valid"].shape[0])
    assert (lay["tcap"] == 0) == (n_buckets == 40000)
    for parts in FILTER_SUBSETS:
        before, dev_tables, matches = (TO.interpod_filter.launches, TO.interpod_filter.device_table_launches,
                                       TO.match_terms.launches)
        got = TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=n_buckets, m_pt=m_pt, m_sig=m_sig)
        torch.cuda.synchronize()
        assert TO.interpod_filter.launches == before + 1 and TO.match_terms.launches == matches
        assert TO.interpod_filter.device_table_launches == dev_tables + int(lay["tcap"] == 0)
        assert torch.equal(got, TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, n_buckets)), parts
        # without the plan: one match launch for the matrices the parts read
        got = TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=n_buckets)
        assert TO.match_terms.launches == matches + 1
        assert torch.equal(got, TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, n_buckets)), parts


def cut_interpod(na, ea, xa, n):
    """The inter-pod filter's node-axis inputs cut or repeated to n rows."""
    reps = -(-n // na["valid"].shape[0])
    return (tiled_nodes(na, n), {**ea, "counts": torch.cat([ea["counts"]] * reps)[:n].contiguous()},
            {**xa, "counts": torch.cat([xa["counts"]] * reps)[:n].contiguous()})


@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
@pytest.mark.parametrize("tcap", [None, 1, 0], ids=["default", "one-table-a-chunk", "device"])
@pytest.mark.parametrize("ctas", [1, 3, 4, 16])
def test_interpod_filter_cluster_sizes_equal_plain(cuda, ctas, tcap, n_buckets):
    """The cluster kernel at C = 1, 3, 4 and 16 CTAs a spec row on a node
    axis no C > 1 divides (151 rows), with its tables in shared memory
    (several a chunk and one a chunk) and in device memory, against the
    plain version for every subset of the parts."""
    from kubernetes_tpu_torch.kernels import build

    na, ea, xa, ta, au, pa, _ = interpod_cluster(1, cuda)
    na, ea, xa = cut_interpod(na, ea, xa, 151)
    m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    for parts in FILTER_SUBSETS:
        args, out = TO.interpod_filter_args(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, n_buckets, cluster=ctas,
                                            tcap=tcap)
        assert args.C == ctas and (tcap is None or args.tcap == tcap)
        build.launch(TO.INTERPOD_FILTER_ENTRY, args, cuda)
        torch.cuda.synchronize()
        assert torch.equal(out, TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, n_buckets)), parts


def interpod_one_row(seed, device, n_nodes=200):
    """The extender's /filter shape on the inter-pod cluster: a 16-row batch
    holding one pending pod that owns a required (anti-)affinity term (row
    0; rows 1-15 padding), with the cluster's node, signature and pattern
    banks."""
    nodes, existing, pending = random_cluster(seed, n_nodes, 150, 600, overflow_nodes=3, topology=True,
                                              interpod=True)
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    mirror = TensorMirror(cache, device)
    for p in pending:
        tb, aux = compile_batch_terms(mirror.vocab, [p], b_capacity=16)
        kinds = set(tb.arrays()["kind"][tb.arrays()["valid"]].tolist())
        if kinds & {1, 2}:  # AFF_REQ or ANTI_REQ
            break
    batch = PodBatch(mirror.vocab, 16)
    batch.set_pod(0, p)
    na, ea, xa = mirror.device_arrays()
    return [na, ea, xa] + [arrays_to_torch(d, device) for d in (tb.arrays(), aux, batch.arrays())]


@pytest.mark.parametrize("n_buckets", [16, 16384, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_interpod_filter_one_live_row_equals_plain(cuda, seed, n_buckets):
    """The extender's /filter shape: U = 16 rows, one live (a pod owning a
    required term), N = 10,240 node rows: one launch of 16 clusters of 16
    CTAs, exact for every subset of the parts; the padding rows' rows too."""
    na, ea, xa, ta, au, pa = interpod_one_row(seed, cuda)
    na, ea, xa = cut_interpod(na, ea, xa, 10240)
    assert int(pa["valid"].sum()) == 1 and pa["valid"].shape[0] == 16
    m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    for parts in FILTER_SUBSETS:
        args, _ = TO.interpod_filter_args(na, ea, ta, au, xa, pa, m_pt, m_sig, parts, n_buckets)
        assert args.C == 16
        before = TO.interpod_filter.launches
        got = TO.interpod_filter(na, ea, ta, au, xa, pa, parts=parts, n_buckets=n_buckets, m_pt=m_pt, m_sig=m_sig)
        assert TO.interpod_filter.launches == before + 1
        assert torch.equal(got, TO.interpod_filter_plain(na, ea, ta, au, xa, pa, parts, n_buckets)), parts


TRACED_CALLS = 10


def device_events(fn, calls=TRACED_CALLS):
    """(kernel names, copy names) of the device events `calls` calls of
    fn() leave in a profiler trace. A trace may drop events at its edges,
    so a check reads "at most one a call" and "at least one"."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return ([e["name"] for e in events if e.get("cat") == "kernel"],
            [e["name"] for e in events if e.get("cat") == "gpu_memcpy"])


@pytest.mark.parametrize("n_buckets", [16, 256, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_interpod_score_kernel_equals_plain(cuda, seed, n_buckets):
    """Each part and both: one launch a call (one kernel in the profiler,
    none of match_terms when given the plan's m_pt / m_sig), exact at the
    layout's cluster width (U = 256: one CTA a row; V = 40,000 takes the
    device-memory tables, counted) and at 1, 2, 3, 4, 8 and 16 CTAs a spec
    row (device tables at 40,000 up to two CTAs)."""
    na, ea, xa, ta, _, pa, _ = interpod_cluster(seed, cuda)
    m_pt = TO.match_terms(xa, pa["label_vals"], pa["ns_id"])
    m_sig = TO.match_terms(ta, ea["label_vals"], ea["ns_id"])
    lay = TO.interpod_score_layout(xa["valid"].shape[0], ta["valid"].shape[0], na["valid"].shape[0], n_buckets,
                                   pa["valid"].shape[0])
    assert (lay["tcap"] == 0) == (n_buckets == 40000)
    for parts in (("pref",), ("existing",), ("pref", "existing")):
        before, dev_tables = TO.interpod_score.launches, TO.interpod_score.device_table_launches
        got = TO.interpod_score(na, ea, ta, xa, pa, parts=parts, n_buckets=n_buckets)
        assert TO.interpod_score.launches == before + 1
        assert TO.interpod_score.device_table_launches == dev_tables + int(lay["tcap"] == 0)
        want = TO.interpod_score_plain(na, ea, ta, xa, pa, parts, n_buckets)
        assert got.dtype == want.dtype == torch.int64
        assert torch.equal(got, want), parts
        names, _ = device_events(lambda: TO.interpod_score(na, ea, ta, xa, pa, parts=parts, n_buckets=n_buckets,
                                                           m_pt=m_pt, m_sig=m_sig))
        assert 1 <= len(names) <= TRACED_CALLS and all("interpod_score_cluster_kernel" in k for k in names), names
        for ctas in (1, 2, 3, 4, 8, 16):
            args, out = TO.interpod_score_args(na, ea, ta, xa, pa, m_pt, m_sig, parts, n_buckets, cluster=ctas)
            assert args.C == ctas and (args.tcap == 0) == (n_buckets == 40000 and ctas <= 2)
            build.launch(TO.INTERPOD_SCORE_ENTRY, args, cuda)
            torch.cuda.synchronize()
            assert torch.equal(out, want), (parts, ctas)


def port_rows(seed, u, pp=8, device="cuda"):
    """Spec-row port lists [U, PP] (tests/test_torch_port_table.py's
    shape): about a third of the rows hold one to three live ports at
    scattered lanes, from three numbers and two protocols, each IP the
    wildcard (7) or one of two addresses; padding lanes carry stray
    protocol and IP ids."""
    g = torch.Generator().manual_seed(seed)
    num = torch.zeros((u, pp), dtype=torch.int32)
    proto = torch.randint(0, 6, (u, pp), generator=g, dtype=torch.int32)
    ip = torch.randint(0, 14, (u, pp), generator=g, dtype=torch.int32)
    for r in range(u):
        if float(torch.rand(1, generator=g)) < 0.35:
            lanes = torch.randperm(pp, generator=g)[:int(torch.randint(1, 4, (1,), generator=g))]
            num[r, lanes] = torch.tensor([80, 443, 8080], dtype=torch.int32)[torch.randint(0, 3, (len(lanes),),
                                                                                          generator=g)]
            proto[r, lanes] = torch.randint(3, 5, (len(lanes),), generator=g, dtype=torch.int32)
            ip[r, lanes] = torch.tensor([7, 11, 12], dtype=torch.int32)[torch.randint(0, 3, (len(lanes),),
                                                                                     generator=g)]
    return {"port_num": num.to(device), "port_proto": proto.to(device), "port_ip": ip.to(device)}, {"wildcard_ip": 7}


PORT_US = [16, 32, 40, 128, 512]  # 40: byte stores


@pytest.mark.parametrize("count", [0, 1, 2, 3])
@pytest.mark.parametrize("u", PORT_US)
def test_port_table_in_match_launch_equals_plain(cuda, u, count):
    """The port table as a slice of a match launch holding 0 to 3 term
    problems: each matrix and the table equal their plain versions; one
    launch, counted as a match launch with a port table (count 0: a
    port-only launch), none as a standalone port launch."""
    na, ea, xa, ta, au, pa, ids = interpod_cluster(u % 3, cuda)
    problems = [(ta, ea["label_vals"], ea["ns_id"]), (xa, pa["label_vals"], pa["ns_id"]),
                (ta, pa["label_vals"], pa["ns_id"])][:count]
    pods, pids = port_rows(u + count, u)
    before = (TO.match_terms.launches, TO.match_terms.problems, TO.match_terms.port_tables,
              F.inbatch_port_conflict.launches)
    got = TO.match_terms_multi(problems, ports=(pods, pids))
    assert (TO.match_terms.launches, TO.match_terms.problems, TO.match_terms.port_tables,
            F.inbatch_port_conflict.launches) == (before[0] + 1, before[1] + count, before[2] + 1, before[3])
    assert len(got) == count + 1
    for g, pr in zip(got, problems):
        assert torch.equal(g, TO.match_terms_plain(*pr))
    want = F.inbatch_port_conflict_plain(pods, pids)
    assert got[-1].dtype == torch.bool and torch.equal(got[-1], want)
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("tile", [(1, 16), (8, 16), (16, 16), (16, 32), (16, 64), (32, 32), (128, 128)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("u", PORT_US)
def test_port_only_launch_equals_plain(cuda, u, tile):
    """F.inbatch_port_conflict is a port-only match launch (counted as a
    standalone port launch, not as a match launch); the slice at tiles of
    1 to 128 spec rows and 16 to 128 columns (those port_layout picks for
    long port lists and beside term problems among them) gives the same
    table."""
    pods, pids = port_rows(u, u)
    want = F.inbatch_port_conflict_plain(pods, pids)
    before = (F.inbatch_port_conflict.launches, TO.match_terms.launches, TO.match_terms.port_tables)
    got = F.inbatch_port_conflict(pods, pids)
    assert (F.inbatch_port_conflict.launches, TO.match_terms.launches, TO.match_terms.port_tables) == (
        before[0] + 1, before[1], before[2])
    assert torch.equal(got, want)
    args, (out,) = TO.match_args([], (pods, pids))
    lay = TO.port_layout(u, 8, tile=tile)
    args.port.rows, args.port.cols, args.smem = lay["rows"], lay["cols"], lay["smem"]
    assert args.count == 0 and args.port.rows == min(tile[0], u) and args.port.cols % 16 == 0
    out.fill_(True)
    build.launch(TO.MATCH_ENTRY, args, cuda)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("pp", [120, 400])
@pytest.mark.parametrize("u", [32, 128])
def test_port_table_with_long_port_lists_equals_plain(cuda, u, pp):
    """Long port lists: fewer spec rows a tile, and at PP = 400 more than
    48 KB of shared memory a CTA; the table alone and beside a term
    problem equals the plain version."""
    na, ea, xa, ta, au, pa, ids = interpod_cluster(1, cuda)
    pods, pids = port_rows(u + pp, u, pp)
    want = F.inbatch_port_conflict_plain(pods, pids)
    assert torch.equal(F.inbatch_port_conflict(pods, pids), want)
    got = TO.match_terms_multi([(ta, ea["label_vals"], ea["ns_id"])], ports=(pods, pids))
    assert torch.equal(got[0], TO.match_terms_plain(ta, ea["label_vals"], ea["ns_id"]))
    assert torch.equal(got[1], want) and bool(want.any())
    assert (TO.port_layout(u, pp)["smem"] > 48 * 1024) == (pp == 400)


def test_port_table_with_no_live_port_is_all_false(cuda):
    """bench.py's batches hold no host port: every pair false without a
    test, in one launch beside the plan's matrices."""
    na, ea, xa, ta, au, pa, ids = interpod_cluster(0, cuda)
    pods = {k: torch.zeros_like(pa[k]) for k in ("port_num", "port_proto", "port_ip")}
    *_, table = TO.match_terms_multi([(ta, pa["label_vals"], pa["ns_id"])], ports=(pods, ids))
    assert table.shape == (pa["valid"].shape[0],) * 2 and not bool(table.any())


@pytest.mark.parametrize("seed", [0, 1])
def test_encoded_port_table_equals_plain(cuda, seed):
    """On the inter-pod cluster's encoded spec rows (host ports from the
    generator) the port-only launch and the plan's slice equal the plain
    version."""
    na, ea, xa, ta, au, pa, ids = interpod_cluster(seed, cuda)
    want = F.inbatch_port_conflict_plain(pa, ids)
    assert torch.equal(F.inbatch_port_conflict(pa, ids), want) and bool(want.any())
    plan = PP.match_plan(pa, PP.DEFAULT_SOLVE_CONFIG, PP.PORTED_TERM_KINDS, ea=ea, ta=ta, xa=xa,
                         track_inbatch=True, ids=ids)
    assert torch.equal(plan["port_conflict"], want)
    assert torch.equal(plan["m_bb"], TO.match_terms_plain(ta, pa["label_vals"], pa["ns_id"]))


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tracked_solve_kernel_equals_plain(cuda, seed, det):
    """The solve with in-batch anti-affinity / host-port tracking: the
    sequential kernel against the chunked, barrier-serialized plain
    version on the inter-pod cluster's mask and score."""
    na, ea, xa, ta, au, pa, ids = interpod_cluster(seed, cuda)
    kinds = ("existing", "aff", "anti")
    mask = F.combined_mask(na, pa, ids) & TO.interpod_filter(na, ea, ta, au, xa, pa, kinds, n_buckets=256)
    score = S.score_matrix(na, pa) + TO.interpod_score(na, ea, ta, xa, pa, n_buckets=256)
    b = 640
    sig = (torch.arange(b, device=cuda) % 150).to(torch.int32)
    pod_valid = torch.arange(b, device=cuda) < b - 40
    order = SO.pop_order((torch.arange(b, device=cuda) % 3).to(torch.int32),
                         torch.arange(b, dtype=torch.int32, device=cuda), pod_valid)
    args = (mask, score, pa["req"], na["alloc"] - na["requested"], na["pod_count"].long(),
            na["allowed_pods"].long(), order, SO.prng_key_data(seed))
    inb = PP._inbatch_tensors(na, pa, ta, ids, 256)
    kw = dict(deterministic=det, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid,
              return_carry=True, nz0=na["nonzero_req"], scoring_req=pa["scoring_req"], inb=inb)
    before = SO.solve_greedy.tracked_launches
    got, carry = SO.solve_greedy(*args, **kw)
    assert SO.solve_greedy.tracked_launches == before + 1
    want, want_carry = SO.solve_greedy_plain(*args, **kw)
    assert torch.equal(got, want)
    for a, c in zip(carry, want_carry):
        assert torch.equal(a, c)
    assert int((got >= 0).sum()) > 50


def hard_spread_cluster(seed, device):
    """(na, ea, xa, ta, au, pa, ids, v) of a seeded cluster with
    DoNotSchedule constraints (zone / hostname keys, nodes without a key)
    beside every inter-pod kind and host ports."""
    nodes, existing, pending = random_cluster(seed, 150, 120, 300, overflow_nodes=2, topology=True,
                                              hard_spread=True, interpod=True, pending_affinity=False,
                                              pending_ports=True)
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    mirror = TensorMirror(cache, device)
    batch = PodBatch(mirror.vocab, 128)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, aux = compile_batch_terms(mirror.vocab, pending, b_capacity=128)
    na, ea, xa = mirror.device_arrays()
    return [na, ea, xa] + [arrays_to_torch(d, device) for d in (tb.arrays(), aux, batch.arrays())] + \
        [F.make_ids(mirror.vocab), 256]


@pytest.mark.parametrize("n_buckets", [16, 64, 256, 40000])
@pytest.mark.parametrize("seed", [0, 1])
def test_spread_filter_kernel_equals_plain(cuda, seed, n_buckets):
    """One launch a call (the term matches inside it: no match_terms
    launch); V = 40,000 keeps its tables in device memory, counted."""
    na, ea, _, ta, _, pa, ids, _ = hard_spread_cluster(seed, cuda)
    _, sel = F.combined_mask(na, pa, ids, with_selector=True)
    before, matches, dev_tables = TO.spread_filter.launches, TO.match_terms.launches, \
        TO.spread_filter.device_table_launches
    got = TO.spread_filter(na, ea, ta, sel, n_buckets=n_buckets)
    assert TO.spread_filter.launches == before + 1 and TO.match_terms.launches == matches
    assert TO.spread_filter.device_table_launches == dev_tables + (n_buckets == 40000)
    want = TO.spread_filter_plain(na, ea, ta, sel, n_buckets)
    assert torch.equal(got, want)
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("track", [True, False], ids=["tracked", "untracked"])
@pytest.mark.parametrize("seed", [0, 1])
def test_arbiter_kernel_equals_plain(cuda, seed, track):
    """The arbiter on a solved batch (3 pods per spec row, so in-batch
    conflicts defer), with and without the solve's tracking, with and
    without the spread kinds."""
    from kubernetes_tpu_torch.commit import arbiter as A

    na, ea, xa, ta, au, pa, ids, v = hard_spread_cluster(seed, cuda)
    b = 360
    pb = {"sig": (torch.arange(b, device=cuda) % 120).to(torch.int32),
          "valid": torch.arange(b, device=cuda) < b - 8,
          "priority": (torch.arange(b, device=cuda) % 3).to(torch.int32)}
    kinds = frozenset({"spread_hard", "spread_soft", "anti_req", "pref", "et_anti", "et_score"})
    assign, _ = PP.solve_pipeline(na, pa, ids, SO.prng_key_data(seed), pb=pb, term_kinds=kinds,
                                  track_inbatch=track, ea=ea, ta=ta, au=au, xa=xa, n_buckets=v)
    for tk in (kinds, kinds - {"spread_hard"}):
        before = A.arbitrate.launches
        got = A.arbitrate(na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=v)
        assert A.arbitrate.launches == before + 1
        want = A.arbitrate_plain(na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=v)
        assert torch.equal(got, want)
    assert bool((want == A.V_PLACE).any())
    if not track:  # the untracked solve leaves in-batch conflicts for the arbiter to defer
        assert bool((want == A.V_DEFER).any())


@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
def test_spread_filter_kernel_tables_equal_plain(cuda, n_buckets):
    """spread_filter's tables equal the plain metadata in every cell, from
    one counted launch: the candidate rows and the per-term tables (zero
    rows, min_t 2^30 and no pair on terms that are not DoNotSchedule)."""
    na, ea, _, ta, _, pa, ids, _ = hard_spread_cluster(0, cuda)
    _, sel = F.combined_mask(na, pa, ids, with_selector=True)
    before = TO.spread_filter.launches
    got, tables = TO.spread_filter(na, ea, ta, sel, n_buckets=n_buckets, with_tables=True)
    assert TO.spread_filter.launches == before + 1
    want, want_tables = TO.spread_filter_plain(na, ea, ta, sel, n_buckets, with_tables=True)
    assert torch.equal(got, want)
    assert tables.keys() == want_tables.keys()
    hard = ta["valid"] & (ta["kind"] == SPREAD_HARD)
    assert bool(hard.any()) and not bool(hard.all())
    for k in want_tables:
        assert tables[k].dtype == want_tables[k].dtype and torch.equal(tables[k], want_tables[k]), k


def branches_spread_cluster(device):
    """(na, ea, ta, sel) of a small cluster whose spec rows own 0, 1 and 2
    DoNotSchedule terms, two on one key and two on two keys (zone, rack,
    a key no node has), with nodes missing a key and a node selector."""
    from kubernetes_tpu_torch.api import types as t
    from kubernetes_tpu_torch.models.clusters import HOST_KEY, ZONE_KEY

    nodes = []
    for i in range(37):
        labels = {HOST_KEY: f"n{i}"}
        if i < 35:
            labels[ZONE_KEY] = f"z{i % 3}"
        if i % 2 == 0:
            labels["rack"] = f"r{i % 4}"
        alloc = {t.RESOURCE_CPU: t.Quantity.parse("8"), t.RESOURCE_MEMORY: t.Quantity.parse("32Gi"),
                 t.RESOURCE_PODS: t.Quantity.parse(110)}
        nodes.append(t.Node(name=f"n{i}", labels=labels, allocatable=alloc, capacity=dict(alloc)))
    existing = [t.Pod(name=f"e{i}", namespace="other" if i == 7 else "bench",
                      labels={"app": "a" if i % 3 else "b", "tier": "x" if i % 2 else "y"}, node_name=f"n{(i * 5) % 37}")
                for i in range(60)]

    def con(key, skew, sel):
        return t.TopologySpreadConstraint(max_skew=skew, topology_key=key, when_unsatisfiable="DoNotSchedule",
                                          label_selector=t.LabelSelector(match_labels=sel))

    specs = [[con(ZONE_KEY, 1, {"app": "a"})], [con(ZONE_KEY, 3, {"app": "a"})],
             [con(ZONE_KEY, 1, {"app": "a"}), con(ZONE_KEY, 2, {"tier": "x"})], [con("rack", 1, {"app": "b"})],
             [con("no-such-key", 1, {"app": "a"})], [con(ZONE_KEY, 1, {"app": "b"}), con("rack", 1, {"app": "a"})],
             [], [con(HOST_KEY, 1, {"app": "a"})]]
    pending = []
    for i, cons in enumerate(specs):
        p = t.Pod(name=f"p{i}", namespace="bench", labels={"app": "a" if i % 2 else "b", "tier": "x"},
                  topology_spread_constraints=cons)
        if i == 5:
            p.node_selector = {"rack": "r0"}
        pending.append(p)
    bank, sigs, _ = encode_snapshot(Snapshot(nodes, existing))
    batch = PodBatch(bank.vocab, 16)
    for i, p in enumerate(pending):
        batch.set_pod(i, p)
    tb, _ = compile_batch_terms(bank.vocab, pending, b_capacity=16)
    na, ea, ta, pa = (arrays_to_torch(d, device) for d in (bank.arrays(), sigs.arrays(), tb.arrays(), batch.arrays()))
    return na, ea, ta, F.pod_match_node_selector(na, pa)


def cut_nodes(na, ea, sel, n):
    """The spread filter's inputs cut to their first n node rows."""
    width = na["valid"].shape[0]
    return ({k: (v[:n] if v.dim() and v.shape[0] == width else v) for k, v in na.items()},
            {**ea, "counts": ea["counts"][:n]}, sel[:, :n].contiguous())


@pytest.mark.parametrize("n_buckets", [16, 64, 40000])
@pytest.mark.parametrize("ctas", [1, 3, 4, 8, 16])
def test_spread_filter_cluster_sizes_equal_plain(cuda, ctas, n_buckets):
    """The cluster kernel at C = 1, 3, 4, 8 and 16 CTAs a spec row, on node
    axes of 38 and 151 rows (no C > 1 divides them), its mask and every
    table cell against the plain version: rows with 0, 1 and 2 hard terms
    on one key and on two, buckets past V = 16 (the hostname key)."""
    from kubernetes_tpu_torch.kernels import build

    na, ea, ta, sel = branches_spread_cluster(cuda)
    rna, rea, _, rta, _, rpa, _, _ = hard_spread_cluster(1, cuda)
    cases = [(*cut_nodes(na, ea, sel, 38), ta),
             (*cut_nodes(rna, rea, F.pod_match_node_selector(rna, rpa), 151), rta)]
    for na, ea, sel, ta in cases:
        args, mask, tables = TO.spread_filter_args(na, ea, ta, sel, n_buckets, cluster=ctas)
        assert args.C == ctas and (args.copies == 0) == (n_buckets == 40000)
        build.launch(TO.SPREAD_FILTER_ENTRY, args, cuda)
        want, want_tables = TO.spread_filter_plain(na, ea, ta, sel, n_buckets, with_tables=True)
        assert torch.equal(mask, want)
        for k in want_tables:
            assert torch.equal(tables[k], want_tables[k]), k


@pytest.mark.parametrize("track", [True, False], ids=["tracked", "untracked"])
def test_arbiter_reads_solve_inputs_without_relaunching(cuda, track):
    """Given the dict its batch's solve filled, the arbiter launches only
    its own kernel where the solve computed the inputs (match_terms and
    the port table with the tracking; spread_filter's tables always), and
    its verdicts equal the plain version's. A tracked solve takes the port
    table from its one match launch: no standalone port launch."""
    from kubernetes_tpu_torch.commit import arbiter as A

    na, ea, xa, ta, au, pa, ids, v = hard_spread_cluster(1, cuda)
    b = 360
    pb = {"sig": (torch.arange(b, device=cuda) % 120).to(torch.int32),
          "valid": torch.arange(b, device=cuda) < b - 8,
          "priority": (torch.arange(b, device=cuda) % 3).to(torch.int32)}
    kinds = frozenset({"spread_hard", "spread_soft", "anti_req", "pref", "et_anti", "et_score"})
    solved = {}
    solve_before = (TO.match_terms.launches, TO.match_terms.port_tables, F.inbatch_port_conflict.launches)
    assign, _ = PP.solve_pipeline(na, pa, ids, SO.prng_key_data(1), pb=pb, term_kinds=kinds, track_inbatch=track,
                                  ea=ea, ta=ta, au=au, xa=xa, n_buckets=v, arbiter_inputs=solved)
    solve_added = [a - b_ for a, b_ in zip((TO.match_terms.launches, TO.match_terms.port_tables,
                                             F.inbatch_port_conflict.launches), solve_before)]
    assert solve_added == ([1, 1, 0] if track else [1, 0, 0])  # the plan's one launch
    counters = (TO.match_terms, F.inbatch_port_conflict, F.combined_mask, TO.spread_filter, A.arbitrate)
    before = [c.launches for c in counters] + [TO.match_terms.port_tables]
    got = A.arbitrate(na, pa, ea, ta, ids, assign, pb, term_kinds=kinds, n_buckets=v, inputs=solved)
    added = [c.launches - n for c, n in zip(counters, before)] + [TO.match_terms.port_tables - before[-1]]
    # untracked: m_raw and pconf from ONE match launch holding the port table
    assert added == ([0, 0, 0, 0, 1, 0] if track else [1, 0, 0, 0, 1, 1])
    want = A.arbitrate_plain(na, pa, ea, ta, ids, assign, pb, term_kinds=kinds, n_buckets=v)
    assert torch.equal(got, want)


def fold_case(case, g, n, r, s, pt, b, t):
    """Banks and a fold program (the control tensors in PROGRAM order) for
    the card's fold tests: "duplicates", every lane on one of a few rows
    and cells with counts of 1 and cells near the int16 edges; "carries",
    int16 cells over their whole range (low halves carry, high halves wrap)
    and counts of both signs; sentinel lanes in both."""
    lo16 = -32768
    banks = [torch.randint(0, 10**9, (n, r), generator=g), torch.randint(0, 10**9, (n, 2), generator=g),
             torch.randint(0, 100, (n,), generator=g).int(),
             torch.randint(lo16, 32768, (n, s), generator=g).to(torch.int16),
             torch.randint(lo16, 32768, (n, pt), generator=g).to(torch.int16)]
    if case == "duplicates":
        cnt, pat_cnt = torch.ones(b, dtype=torch.int32), torch.ones(t, dtype=torch.int16)
    else:
        cnt, pat_cnt = torch.randint(-3, 5, (b,), generator=g).int(), torch.randint(-3, 5, (t,), generator=g).to(
            torch.int16)
    ctl = [torch.randint(0, 5, (b,), generator=g).int(), torch.randint(-9000, 9000, (b, r), generator=g),
           torch.randint(-9000, 9000, (b, 2), generator=g), cnt,
           torch.randint(0, 3, (b,), generator=g).int(), torch.randint(0, 4, (t,), generator=g).int(),
           torch.randint(0, 3, (t,), generator=g).int(), pat_cnt]
    ctl[0][::7] = n  # sentinel lanes
    ctl[4][::5] = s
    ctl[6][::9] = pt
    return banks, ctl


FOLD_PROGRAM = ("rows", "req", "nz", "cnt", "sig", "pat_row", "pat_col", "pat_cnt")


@pytest.mark.parametrize("case", ["duplicates", "carries"])
def test_fold_kernel_equals_plain(cuda, case):
    """The fold through its tensor wrapper (padded lanes dropped in the
    kernel) and through the packed path (the live lanes in one pinned
    upload), one launch each, equal to the plain version."""
    from kubernetes_tpu_torch.ops.fold import (fold_commit_banks, fold_commit_banks_plain, fold_commit_packed,
                                               fold_control)

    g = torch.Generator().manual_seed(0)
    n, r, s, pt, b, t = 64, 6, 40, 12, 4096, 900
    banks, ctl = fold_case(case, g, n, r, s, pt, b, t)
    want = fold_commit_banks_plain(*(x.clone() for x in banks), *ctl)
    dev_banks = [x.to(cuda) for x in banks]
    before = fold_commit_banks.launches
    fold_commit_banks(*dev_banks, *(x.to(cuda) for x in ctl))
    assert fold_commit_banks.launches == before + 1
    for got, w in zip(dev_banks, want):
        assert torch.equal(got.cpu(), w)
    packed = fold_control(**{k: x.numpy() for k, x in zip(FOLD_PROGRAM, ctl)}, n=n, pin=True)
    assert packed.buf.is_pinned()
    dev_banks = [x.to(cuda) for x in banks]
    fold_commit_packed(*dev_banks, packed)
    assert fold_commit_banks.launches == before + 2
    for got, w in zip(dev_banks, want):
        assert torch.equal(got.cpu(), w)


def test_fold_refuses_an_int16_bank_sharing_its_last_word(cuda):
    """An int16 bank of an odd number of cells whose last 32-bit word
    reaches into more of its storage is refused (a low half's carry would
    touch the next bytes until its correction); the same bank ending its
    own storage folds."""
    from kubernetes_tpu_torch.ops.fold import fold_commit_banks, fold_commit_banks_plain

    g = torch.Generator().manual_seed(3)
    n, r, s, pt, b, t = 3, 6, 5, 3, 64, 16
    banks, ctl = fold_case("carries", g, n, r, s, pt, b, t)
    ctl[0] = torch.randint(0, n + 1, (b,), generator=g).int()
    ctl[5] = torch.randint(0, n + 1, (t,), generator=g).int()
    dev = [x.to(cuda) for x in banks]
    shared = torch.zeros(n * s + 1, dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        fold_commit_banks(dev[0], dev[1], dev[2], shared[:n * s].view(n, s), dev[4], *(x.to(cuda) for x in ctl))
    want = fold_commit_banks_plain(*(x.clone() for x in banks), *ctl)
    fold_commit_banks(*dev, *(x.to(cuda) for x in ctl))
    for got, w in zip(dev, want):
        assert torch.equal(got.cpu(), w)


def test_mirror_fold_is_one_pinned_copy_and_one_kernel(cuda):
    """TensorMirror.fold_commit on the card: the folded banks equal the CPU
    mirror's fold of the same program; in the profiler each fold is one
    host-to-device copy, from pinned memory, and one kernel (no per-array
    upload)."""
    from kubernetes_tpu_torch.commit.fold import plan_fold

    nodes, existing, pending = random_cluster(5, 30, 40, 60, topology=True, interpod=True, pending_affinity=True)
    mirrors = []
    for device in (cuda, "cpu"):
        cache = SchedulerCache()
        fill_cache(cache, nodes, existing)
        m = TensorMirror(cache, device)
        m.device_arrays()
        rows = sorted(m.row_of.values())
        prog = plan_fold(m, [(p, rows[(7 * i) % len(rows)]) for i, p in enumerate(pending)], 128, 16)
        assert prog is not None and int((prog.pat_cnt > 0).sum()) > 0
        m.device_arrays()  # ship the new rows' metadata before the fold
        assert m.fold_commit(prog)
        mirrors.append((m, prog))
    (gm, gprog), (cm, _) = mirrors
    for dg, dc in zip(gm.device_arrays(), cm.device_arrays()):
        for k in dc:
            assert torch.equal(dg[k].cpu(), dc[k]), k
    kernels, copies = device_events(lambda: gm.fold_commit(gprog))
    assert 1 <= len(kernels) <= TRACED_CALLS and all("fold_commit_kernel" in k for k in kernels), kernels
    assert 1 <= len(copies) <= TRACED_CALLS and all("HtoD" in c and "Pinned" in c for c in copies), copies


def preempt_counted(a):
    """preempt_batch's kernel on these CUDA arrays through one prebuilt
    struct: (outputs, [rows evaluated, steps walked by one warp, tree
    rebuilds], the layout)."""
    from kubernetes_tpu_torch.ops import preempt as PR

    st, out = PR.preempt_args(**a)
    PR.launch_preempt(st, a["cand"].device)
    n, v, r = a["vict_req"].shape
    return out, st.counts.tolist(), PR.preempt_layout(n, v, r)


@pytest.mark.parametrize("mode", ["iid", "runs"])
@pytest.mark.parametrize("shape", [(48, 40, 8, 8), (24, 20, 64, 8), (20, 16, 8, 16), (40, 1100, 8, 8)])
@pytest.mark.parametrize("seed", [0, 1])
def test_preempt_kernel_equals_plain(cuda, seed, shape, mode):
    """Random padded arrays reaching every branch (tests/test_torch_preempt.py
    checks the plain version against the JAX scan), at 64 victim slots, 16
    resource slots and more nodes than a block has threads; `runs`: the
    preemptors in runs of repeated specs (the reuse path, the one-warp
    steps, the tree), fits-free templates, invalid rows inside the runs."""
    from kubernetes_tpu_torch.models.clusters import random_preempt_arrays
    from kubernetes_tpu_torch.ops.preempt import preempt_batch, preempt_batch_plain

    p, n, v, r = shape
    a = arrays_to_torch(random_preempt_arrays(seed, p, n, v, r, runs=mode == "runs"), cuda)
    before = preempt_batch.launches
    got = preempt_batch(**a)
    assert preempt_batch.launches == before + 1
    want = preempt_batch_plain(**a)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] >= 0).sum()) >= 3
    again, counts, lay = preempt_counted(a)
    for g, w in zip(again, want):
        assert torch.equal(g, w)
    assert lay["resident"]
    if mode == "runs":
        assert counts[0] < p * n and counts[1] > 0 and counts[2] > 0, counts


def config6_arrays(cuda, reuse=True):
    """The first preemption round of bench.py config 6 at full size (500
    full nodes, 2,000 preemptors of one spec: P = 2,048, N = 512, V = 8,
    R = 8); without `reuse` the priorities alternate 1000 / 1001, so every
    step has a new spec."""
    from kubernetes_tpu_torch.models.clusters import bench_config6
    from kubernetes_tpu_torch.scheduler.preemption import preempt_arrays

    nodes, existing, pending = bench_config6(500, 2000)
    arrays, _, _ = preempt_arrays(pending, Snapshot(nodes, existing))
    if not reuse:
        live = arrays["p_valid"]
        arrays["p_prio"] = arrays["p_prio"] + (live & (np.arange(live.shape[0]) % 2 == 1)).astype(np.int32)
    a = arrays_to_torch(arrays, cuda)
    assert tuple(a["vict_req"].shape) == (512, 8, 8) and a["cand"].shape[0] == 2048
    return a


@pytest.mark.parametrize("reuse", [True, False], ids=["one-spec", "no-reuse"])
def test_preempt_kernel_equals_plain_at_config6(cuda, reuse):
    """Config 6's round: one spec (every step after the first re-evaluates
    only the row the step before chose, walked by one warp) and a new spec
    at every step (every row each step), both exact."""
    from kubernetes_tpu_torch.ops.preempt import preempt_batch, preempt_batch_plain

    a = config6_arrays(cuda, reuse)
    got = preempt_batch(**a)
    want = preempt_batch_plain(**a)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] >= 0).sum()) == 2000
    _, counts, lay = preempt_counted(a)
    assert lay["resident"] and not lay["victims_resident"]
    if reuse:
        assert counts[0] < 2 * 2048 + 512 and counts[1] >= 2000, counts
    else:
        # only the zero-spec padding rows after the first repeat a spec
        assert counts[0] >= 2000 * 512 and counts[1] == 2048 - 2000 - 1, counts


def test_preempt_too_large_for_shared_memory_takes_counted_device_path(cuda):
    """N = 2,100 at R = 8: the carry does not fit shared memory; the same
    walk keeps it in device memory, counted, and equals the plain version."""
    from kubernetes_tpu_torch.models.clusters import random_preempt_arrays
    from kubernetes_tpu_torch.ops.preempt import preempt_batch, preempt_batch_plain, preempt_layout

    assert not preempt_layout(2100, 8, 8)["resident"]
    for runs in (False, True):
        a = arrays_to_torch(random_preempt_arrays(4, 64, 2100, 8, 8, runs=runs), cuda)
        before = preempt_batch.device_memory_launches
        got = preempt_batch(**a)
        assert preempt_batch.device_memory_launches == before + 1
        want = preempt_batch_plain(**a)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int((got[0] >= 0).sum()) >= 3


def test_fold_usage_kernel_equals_plain_and_inverts(cuda):
    from kubernetes_tpu_torch.ops.fold import fold_usage, fold_usage_plain

    g = torch.Generator().manual_seed(3)
    n, r, b = 512, 8, 2048
    requested = torch.randint(0, 10**12, (n, r), generator=g)
    pod_count = torch.randint(0, 110, (n,), generator=g).int()
    rows = torch.randint(0, 6, (b,), generator=g).int()  # duplicate-heavy
    rows[::9] = n  # sentinel pads
    vecs = torch.randint(0, 10**9, (b, r), generator=g)
    cnt = (rows < n).int()
    dreq, dpc = requested.to(cuda), pod_count.to(cuda)
    before = fold_usage.launches
    fold_usage(dreq, dpc, rows.to(cuda), vecs.to(cuda), cnt.to(cuda))
    assert fold_usage.launches == before + 1
    want = fold_usage_plain(requested.clone(), pod_count.clone(), rows, vecs, cnt)
    assert torch.equal(dreq.cpu(), want[0]) and torch.equal(dpc.cpu(), want[1])
    fold_usage(dreq, dpc, rows.to(cuda), -vecs.to(cuda), -cnt.to(cuda))
    assert torch.equal(dreq.cpu(), requested) and torch.equal(dpc.cpu(), pod_count)


@pytest.mark.parametrize("u,n,rows", [
    (1, 7, [0]),
    (8, 1031, [5, 5, 0, 7, 5]),
    (128, 10240, list(range(128))[::-1]),
    (128, 10240, [3]),
    (128, 10240, [i % 128 for i in range(600)]),
])
def test_gather_score_rows_kernel_equals_plain(cuda, u, n, rows):
    """The wrapper: the rows on the host, in a pinned buffer the kernel
    wrote (one launch, none for no row), equal to index_select."""
    import numpy as np

    rng = np.random.default_rng(u + n)
    host = rng.integers(-(2**62), 2**62, (u, n), dtype=np.int64)
    host[0, :2] = (np.iinfo(np.int64).min, np.iinfo(np.int64).max)
    score = torch.from_numpy(host).to(cuda)
    before = PP.gather_score_rows.launches
    got = PP.gather_score_rows(score, rows)
    assert PP.gather_score_rows.launches == before + 1
    assert got.device.type == "cpu" and got.is_pinned()
    want = PP.gather_score_rows_plain(score, torch.tensor(rows, dtype=torch.int32, device=cuda))
    assert got.dtype == torch.int64 and torch.equal(got, want.cpu())
    assert PP.gather_score_rows(score, []).shape == (0, n)
    assert PP.gather_score_rows.launches == before + 1  # nothing to gather: no launch
    with pytest.raises(IndexError):
        PP.gather_score_rows(score, [u])


@pytest.mark.parametrize("dest", ["device", "pinned-host"])
@pytest.mark.parametrize("u,n,rows,out_shift", [
    (1, 7, [0], 0),  # K = 1, N * 8 not a multiple of 16
    (8, 1031, [5, 5, 0, 7, 6], 0),  # repeated rows, odd N: the head and tail by row phase
    (8, 1031, [5, 5, 0, 7, 6], 1),  # the destination one element past 16 bytes: phases differ
    (40, 4097, [39, 0, 1], 1),
    (128, 10240, [7, 91, 3, 120], 0),  # the driver's K at the config-3-hard shapes
    (128, 10240, list(range(128))[::-1], 0),
    (128, 2050, [i % 128 for i in range(513)], 0),  # K past the argument block: the lanes
    (700, 9, list(range(700))[::-1], 1),
])
def test_score_gather_destinations_equal_plain(cuda, u, n, rows, out_shift, dest):
    """The kernel into a device buffer and into pinned host memory, at
    16-byte and 8-byte destination phases, on int64 extremes: every
    element equal to index_select, none written outside the rows."""
    import numpy as np

    rng = np.random.default_rng(u * n)
    host = rng.integers(-(2**62), 2**62, (u, n), dtype=np.int64)
    host[0, 0], host[-1, -1] = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    score = torch.from_numpy(host).to(cuda)
    k = len(rows)
    raw = (torch.full((k * n + 2,), -1, dtype=torch.int64, device=cuda) if dest == "device"
           else torch.full((k * n + 2,), -1, dtype=torch.int64).pin_memory())
    out = raw[out_shift : out_shift + k * n].view(k, n)
    lanes = torch.tensor(rows, dtype=torch.int32, device=cuda) if k > PP.GATHER_MAX_INLINE else None
    args = PP.gather_args(score, rows, out, lanes)
    assert (args.lanes is not None) == (lanes is not None) and args.chunks == -(-n // (512 * args.words))
    build.launch(PP.GATHER_ENTRY, args, cuda)
    torch.cuda.synchronize()
    want = PP.gather_score_rows_plain(score, torch.tensor(rows, dtype=torch.int32, device=cuda))
    assert torch.equal(out.to(cuda), want)
    rest = torch.cat([raw[:out_shift], raw[out_shift + k * n:]])
    assert (rest == -1).all()


def test_score_rows_prefetch_on_the_card_equals_the_cpu(cuda):
    """The driver's lazy view on a device matrix: one gather for the rows a
    prefetch names, the cached rows host numpy arrays equal to the CPU's."""
    from kubernetes_tpu_torch.scheduler.driver import ScoreRows

    rng = np.random.default_rng(5)
    host = rng.integers(-(2**40), 2**40, (6, 300), dtype=np.int64)
    dev, cpu = ScoreRows(torch.from_numpy(host).to(cuda), [2, 2, 0, 5, 0]), ScoreRows(torch.from_numpy(host), [2, 2, 0, 5, 0])
    before = PP.gather_score_rows.launches
    dev.prefetch([0, 1, 2, 3, 4])
    assert PP.gather_score_rows.launches == before + 1
    for i in range(5):
        assert isinstance(dev[i], np.ndarray) and np.array_equal(dev[i], cpu[i])
    assert PP.gather_score_rows.launches == before + 1


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gang_kernel_equals_plain(cuda, seed, det):
    """Both passes in one launch: groups of 2-12 members on scattered
    positions (some with a spec that fits nowhere, so their groups drop),
    ungrouped pods, a grouped padded position; the same assignment, gang_ok
    and pass-2 carry as the plain version."""
    import numpy as np

    na, pa, ids = cluster(seed, cuda)
    mask = F.combined_mask(na, pa, ids)
    score = S.score_matrix(na, pa)
    b = 640
    rng = np.random.default_rng(seed)
    sig = (torch.arange(b, device=cuda) % 200).to(torch.int32)
    pod_valid = torch.arange(b, device=cuda) < b - 40
    group = np.full(b, -1, np.int32)
    pos, g, k = rng.permutation(b - 40), 0, 0
    while k < len(pos) - 60:
        size = int(rng.integers(2, 13))
        group[pos[k:k + size]] = g
        g, k = g + 1, k + size
    group[b - 2] = g
    group = torch.from_numpy(group).to(cuda)
    order = SO.pop_order((torch.arange(b, device=cuda) % 3).to(torch.int32),
                         torch.arange(b, dtype=torch.int32, device=cuda), pod_valid)
    args = (mask, score, pa["req"], na["alloc"] - na["requested"], na["pod_count"].long(),
            na["allowed_pods"].long(), order, group, SO.prng_key_data(seed + 2**32))
    kw = dict(deterministic=det, req_any=pa["req_any"], sig=sig, pod_valid=pod_valid,
              return_carry=True, nz0=na["nonzero_req"], scoring_req=pa["scoring_req"])
    before, greedy = SO.solve_gang.launches, SO.solve_greedy.launches
    got, ok, carry = SO.solve_gang(*args, **kw)
    assert SO.solve_gang.launches == before + 1 and SO.solve_greedy.launches == greedy
    want, want_ok, want_carry = SO.solve_gang_plain(*args, **kw)
    assert torch.equal(got, want) and torch.equal(ok, want_ok)
    for a, c in zip(carry, want_carry):
        assert torch.equal(a, c)
    assert int((~ok).sum()) > 0 and int((got >= 0).sum()) > 50


def seeded_slab(template, s, seed):
    """A slab dict shaped like `template` at S rows from a numpy seed (bools,
    int32 and int64 with both extremes) and a one-row padding dict."""
    import numpy as np

    rng = np.random.default_rng(seed)
    slab, empty = {}, {}
    for k, v in template.items():
        shape = (s,) + v.shape[1:]
        if v.dtype == bool:
            slab[k] = rng.random(shape) < 0.5
        elif v.dtype == np.int64:
            slab[k] = rng.integers(-(2**62), 2**62, shape, dtype=np.int64)
            slab[k].flat[0], slab[k].flat[-1] = np.iinfo(np.int64).min, np.iinfo(np.int64).max
        else:
            slab[k] = rng.integers(-(2**31), 2**31 - 1, shape, dtype=v.dtype)
        empty[k] = np.asarray(v[:1]).copy()
    return slab, empty


@pytest.mark.parametrize("plane", ["stage", "terms"])
@pytest.mark.parametrize("s,lanes,live", [(256, 128, 100), (1024, 64, 64), (37, 48, 5), (3, 1, 1)])
def test_slab_gather_kernel_equals_plain(cuda, plane, s, lanes, live):
    """The gather at the config-3 (U = 128, slab 256) and config-5 (U = 64,
    slab 1,024) shapes and small odd ones (S not a multiple of the block,
    one lane): padding lanes, repeated rows, int64 extremes, the override
    column (fallback as given, owner masked)."""
    import numpy as np

    from kubernetes_tpu_torch.ingest import gather_stage, gather_stage_plain
    from kubernetes_tpu_torch.state.tensors import Vocab
    from kubernetes_tpu_torch.state.terms import TermBank
    from kubernetes_tpu_torch.terms_plane import gather_terms, gather_terms_plain

    template = PodBatch(Vocab(), 1).arrays() if plane == "stage" else TermBank(Vocab(), 1).arrays()
    slab, empty = seeded_slab(template, s, s + lanes)
    rng = np.random.default_rng(s)
    idx = np.zeros(lanes, np.int32)
    idx[:live] = rng.integers(0, s, live)
    idx[: min(3, live)] = idx[0]
    keep = np.arange(lanes) < live
    col = rng.integers(0, 2 if plane == "stage" else 1000, lanes).astype(np.int32)
    bank, emp = arrays_to_torch(slab, cuda, copy=True), arrays_to_torch(empty, cuda, copy=True)
    ti, tk, tc = (torch.from_numpy(a).to(cuda) for a in (idx, keep, col))
    if plane == "stage":
        before = gather_stage.launches
        got = gather_stage(bank, idx, keep, emp, col.astype(bool))
        assert gather_stage.launches == before + 1
        want = gather_stage_plain(bank, ti, tk, emp, tc.bool())
    else:
        before = gather_terms.launches
        got = gather_terms(bank, idx, col, keep, emp)
        assert gather_terms.launches == before + 1
        want = gather_terms_plain(bank, ti, tc, tk, emp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    with pytest.raises(IndexError):
        (gather_stage if plane == "stage" else gather_terms)(
            *((bank, np.array([s], np.int32), np.ones(1, bool), emp, np.zeros(1, bool)) if plane == "stage"
              else (bank, np.array([s], np.int32), np.zeros(1, np.int32), np.ones(1, bool), emp)))


def synthetic_slab(cuda, s, widths, seed, shift=0):
    """A slab of one array a row width in `widths` (bytes: 1 bool, 4 int32,
    12 int32 x 3, 24 int64 x 3, 256 int32 x 64) and its padding row, from a
    numpy seed; with `shift`, the 256-byte array sits `shift` bytes past a
    16-byte boundary."""
    kinds = {1: (bool, ()), 4: (np.int32, ()), 12: (np.int32, (3,)), 24: (np.int64, (3,)), 256: (np.int32, (64,))}
    rng = np.random.default_rng(seed)
    slab, empty = {}, {}
    for w in widths:
        dt, tail = kinds[w]
        if dt is bool:
            a = rng.random((s,) + tail) < 0.5
        else:
            a = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, (s,) + tail, dtype=dt, endpoint=True)
        slab[f"w{w}"], empty[f"w{w}"] = a, np.full((1,) + tail, 7, dt) if dt is not bool else np.ones((1,), bool)
    bank, emp = arrays_to_torch(slab, cuda, copy=True), arrays_to_torch(empty, cuda, copy=True)
    if shift:
        v = bank["w256"]
        raw = torch.zeros(v.numel() * 4 + 32, dtype=torch.uint8, device=cuda)
        off = (-raw.data_ptr()) % 16 + shift
        moved = raw[off : off + v.numel() * 4].view(torch.int32).view(v.shape)
        moved.copy_(v)
        assert moved.data_ptr() % 16 == shift
        bank["w256"] = moved
    return bank, emp


def batch_lanes(s, n, live, seed):
    rng = np.random.default_rng(seed)
    idx = np.zeros(n, np.int32)
    idx[:live] = rng.integers(0, s, live)
    idx[: min(3, live)] = idx[0]
    return idx, np.arange(n) < live


def plain_problem(prob, cuda):
    """The plain gather of one GatherProblem on the card."""
    from kubernetes_tpu_torch.ops import slab as SL

    idx, keep, col = SL.host_lanes(prob)
    tk = torch.from_numpy(keep).to(cuda)
    out = SL.gather_slab_plain(prob.slab, torch.from_numpy(idx).to(cuda), tk, prob.empty)
    if prob.col_key is not None:
        out[prob.col_key] = torch.from_numpy(col).to(cuda).to(prob.slab[prob.col_key].dtype)
    return out


def assert_batch_equals_plain(probs, cuda):
    from kubernetes_tpu_torch.ops import slab as SL

    before = SL.gather_batch.launches
    got = SL.gather_batch(probs)
    assert SL.gather_batch.launches == before + 1
    for g, p in zip(got, probs):
        want = plain_problem(p, cuda)
        assert list(g) == list(want)
        for k in want:
            assert g[k].dtype == want[k].dtype and g[k].shape == want[k].shape and torch.equal(g[k], want[k]), k


@pytest.mark.parametrize("shift", [0, 4, 8], ids=["aligned", "4-byte-pointer", "8-byte-pointer"])
@pytest.mark.parametrize("n,live", [(1, 1), (1, 0), (100, 77), (1031, 600), (4096, 4000)])
@pytest.mark.parametrize("two", [False, True], ids=["one-problem", "two-problems"])
def test_batch_gather_row_widths_equal_plain(cuda, two, n, live, shift):
    """The batch gather bit for bit at row bytes 1, 4, 12, 24 and 256 (16-,
    8-, 4- and 1-byte words), a 256-byte array whose pointer is only 4- or
    8-byte aligned, one lane, lane counts that are not a multiple of a
    chunk, one and two problems in one launch."""
    from kubernetes_tpu_torch.ops import slab as SL

    bank, emp = synthetic_slab(cuda, 300, (1, 4, 12, 24, 256), seed=n, shift=shift)
    idx, keep = batch_lanes(300, n, live, seed=n + 1)
    probs = [SL.GatherProblem(bank, emp, idx, keep)]
    if two:
        bank2, emp2 = synthetic_slab(cuda, 17, (256, 24, 4, 1), seed=n + 2)
        idx2, keep2 = batch_lanes(17, max(n // 3, 1), max(live // 3, 0), seed=n + 3)
        col = np.arange(len(idx2), dtype=np.int32) * 3 - 5
        probs.append(SL.GatherProblem(bank2, emp2, idx2, keep2, col, "w4", True))
    assert_batch_equals_plain(probs, cuda)


@pytest.mark.parametrize("shape", ["config-3", "config-5"])
@pytest.mark.parametrize("which", ["both", "stage", "terms"])
def test_batch_gather_at_the_main_path_shapes_equals_plain(cuda, shape, which):
    """The pod arrays and the term table in one launch at the config-3
    (U = TT = 128, 100 live, slabs of 256) and config-5 (U = 64 on a
    1,024-row slab; TT = 16, none live) shapes, and each alone: padding
    lanes, repeated rows, int64 extremes, both override columns."""
    from kubernetes_tpu_torch.ingest import stage_problem
    from kubernetes_tpu_torch.state.tensors import Vocab
    from kubernetes_tpu_torch.state.terms import TermBank
    from kubernetes_tpu_torch.terms_plane import term_problem

    sizes = {"config-3": ((256, 128, 100), (256, 128, 100)), "config-5": ((1024, 64, 64), (256, 16, 0))}[shape]
    probs = []
    for plane, (s, n, live) in zip(("stage", "terms"), sizes):
        if which not in ("both", plane):
            continue
        template = PodBatch(Vocab(), 1).arrays() if plane == "stage" else TermBank(Vocab(), 1).arrays()
        slab, empty = seeded_slab(template, s, s + n)
        bank, emp = arrays_to_torch(slab, cuda, copy=True), arrays_to_torch(empty, cuda, copy=True)
        idx, keep = batch_lanes(s, n, live, seed=s)
        col = np.random.default_rng(n).integers(0, 2 if plane == "stage" else 1000, n).astype(np.int32)
        probs.append(stage_problem(bank, idx, keep, emp, col.astype(bool)) if plane == "stage"
                     else term_problem(bank, idx, col, keep, emp))
    assert_batch_equals_plain(probs, cuda)


def test_batch_gather_wrapper_never_synchronises(cuda):
    """gather_batch under torch.cuda.set_sync_debug_mode("error"): the
    lanes reach the card by a non-blocking copy from pinned memory, so
    nothing synchronises the stream (a pageable copy would raise)."""
    from kubernetes_tpu_torch.ops import slab as SL

    bank, emp = synthetic_slab(cuda, 64, (1, 4, 12, 24, 256), seed=5)
    bank2, emp2 = synthetic_slab(cuda, 32, (4, 256), seed=6)
    idx, keep = batch_lanes(64, 128, 100, seed=7)
    idx2, keep2 = batch_lanes(32, 16, 9, seed=8)
    probs = [SL.GatherProblem(bank, emp, idx, keep, keep.astype(np.int32), "w1", False),
             SL.GatherProblem(bank2, emp2, idx2, keep2, np.arange(16, dtype=np.int32), "w4", True)]
    SL.gather_batch(probs)  # the plan built and the pinned pool warmed outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [SL.gather_batch(probs) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for got in outs:
        for g, p in zip(got, probs):
            want = plain_problem(p, cuda)
            assert all(torch.equal(g[k], want[k]) for k in want)


@pytest.mark.parametrize("plane", ["stage", "terms"])
@pytest.mark.parametrize("s,rows", [(256, [3, 17, 17, 0, 255, 22]), (1024, list(range(0, 1024, 3))), (37, [36]),
                                    (37, [])])
def test_slab_scatter_kernel_equals_plain(cuda, plane, s, rows):
    """The row scatter: duplicate rows (identical bytes), the last row, a
    dirty set wider than a block, an empty dirty set (no launch)."""
    import numpy as np

    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.state.tensors import Vocab
    from kubernetes_tpu_torch.state.terms import TermBank

    template = PodBatch(Vocab(), 1).arrays() if plane == "stage" else TermBank(Vocab(), 1).arrays()
    slab, _ = seeded_slab(template, s, s)
    upd, _ = seeded_slab(template, max(len(rows), 1), s + 1)
    upd = {k: v[: len(rows)].copy() for k, v in upd.items()}
    idx = np.asarray(rows, np.int64)
    for j in range(1, len(rows)):
        if rows[j] in rows[:j]:
            for v in upd.values():
                v[j] = v[rows.index(rows[j])]  # a duplicate index carries identical bytes
    truth = {k: v.copy() for k, v in slab.items()}  # host truth holding the dirty rows
    for k, v in truth.items():
        v[idx] = upd[k]
    dev = arrays_to_torch(slab, cuda, copy=True)
    want = arrays_to_torch(slab, cuda, copy=True)
    before = SL.scatter_rows.launches
    SL.scatter_rows(dev, idx, truth)
    assert SL.scatter_rows.launches == before + (1 if rows else 0)
    SL.scatter_rows_plain(want, torch.from_numpy(idx).to(cuda), arrays_to_torch(upd, cuda))
    for k in want:
        assert torch.equal(dev[k], want[k]), k


@pytest.mark.parametrize("shift", [0, 4], ids=["aligned", "4-byte-aligned-pointer"])
@pytest.mark.parametrize("case", ["mirror-sync", "two-planes", "split", "one-row", "empty-and-zero-rows"])
def test_multi_problem_scatter_kernel_equals_plain(cuda, case, shift):
    """Several patch problems in one launch against one index_copy_ per
    array per problem: a mirror sync's six patches (two row sets of one
    dict, counts and metadata of two more), both planes' slabs, a call past
    SLAB_MAX_ARRAYS segments (the fewest launches, counted), one row, and
    problems with no row or no array (no launch); row widths of 1 to 256
    bytes, the 256-byte array 4 bytes past a 16-byte boundary with `shift`;
    overlapping problems refused."""
    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.state.tensors import Vocab
    from kubernetes_tpu_torch.state.terms import TermBank

    rng = np.random.default_rng(len(case) + shift)
    pod_h, _ = seeded_slab(PodBatch(Vocab(), 1).arrays(), 300, 1)
    term_h, _ = seeded_slab(TermBank(Vocab(), 1).arrays(), 64, 2)
    syn, _ = synthetic_slab(cuda, 40, (1, 4, 12, 24, 256), 3, shift=shift)
    syn_h = {k: v.cpu().numpy()[::-1].copy() for k, v in syn.items()}
    pod, term = arrays_to_torch(pod_h, cuda, copy=True), arrays_to_torch(term_h, cuda, copy=True)
    pod_new = {k: np.roll(v, 1, axis=0) for k, v in pod_h.items()}  # host truth differs from the twin
    term_new = {k: np.roll(v, 3, axis=0) for k, v in term_h.items()}
    keys = tuple(pod)
    if case == "mirror-sync":
        probs = [SL.ScatterProblem(pod, sorted(rng.choice(300, 40, replace=False)), pod_new, keys[3:]),
                 SL.ScatterProblem(pod, [0, 299], pod_new, keys[:3]),
                 SL.ScatterProblem(term, [1, 2, 3], term_new, ("kind",)),
                 SL.ScatterProblem(term, [60, 9], term_new, ("weight", "ns_ids", "ex_vals")),
                 SL.ScatterProblem(syn, [39, 0, 5], syn_h, ("w1", "w4")),
                 SL.ScatterProblem(syn, [7], syn_h, ("w12", "w24", "w256"))]
    elif case == "two-planes":
        probs = [SL.ScatterProblem(pod, list(range(0, 300, 16)), pod_new),
                 SL.ScatterProblem(term, [63, 0, 31], term_new)]
    elif case == "split":
        pod2 = arrays_to_torch(pod_h, cuda, copy=True)
        probs = [SL.ScatterProblem(pod, [5, 6, 250], pod_new), SL.ScatterProblem(pod2, [299], pod_new),
                 SL.ScatterProblem(syn, [1, 2], syn_h)]
    elif case == "one-row":
        probs = [SL.ScatterProblem(syn, [17], syn_h)]
    else:
        probs = [SL.ScatterProblem(pod, [], pod_new), SL.ScatterProblem(term, [4], term_new, ())]
    want = {}
    for p in probs:
        d = want.setdefault(id(p.slab), {k: v.clone() for k, v in p.slab.items()})
        idx = torch.tensor(np.asarray(p.rows, np.int64), device=cuda)
        for k in (p.keys if p.keys is not None else tuple(p.slab)):
            rows = np.take(p.host[k], np.asarray(p.rows, np.int64), axis=0)
            d[k].index_copy_(0, idx, torch.from_numpy(np.ascontiguousarray(rows)).to(cuda))
    before, split = SL.scatter_batch.launches, SL.scatter_batch.split_launches
    SL.scatter_batch(probs)
    torch.cuda.synchronize()
    launches = {"split": 2, "empty-and-zero-rows": 0}.get(case, 1)
    assert SL.scatter_batch.launches - before == launches
    assert SL.scatter_batch.split_launches - split == (1 if case == "split" else 0)
    for p in probs:
        for k, v in want[id(p.slab)].items():
            assert torch.equal(p.slab[k], v), (case, k)
    with pytest.raises(ValueError, match="same row"):
        SL.scatter_batch([SL.ScatterProblem(syn, [3], syn_h), SL.ScatterProblem(syn, [3, 4], syn_h, ("w4",))])


def test_scatter_never_synchronises_and_reuses_its_layout(cuda):
    """Twenty back-to-back scatters of changing host truth and changing
    row counts under the sync debug mode: no call synchronises, each
    call's rows land exact (a clone after each, stream-ordered, holds that
    call's truth), and every call after the first finds the bank's layout
    in the cache whatever its row count."""
    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.state.tensors import Vocab

    host, _ = seeded_slab(PodBatch(Vocab(), 1).arrays(), 512, 9)
    bank = arrays_to_torch(host, cuda, copy=True)
    rows = [list(range(3 + i, 512, 8 + i)) for i in range(21)]
    truths = [{k: np.roll(v, i + 1, axis=0) for k, v in host.items()} for i in range(21)]
    misses, hits = SL.scatter_batch.layout_misses, SL.scatter_batch.layout_hits
    SL.scatter_rows(bank, rows[0], truths[0])  # the layout
    clones = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r, t in zip(rows[1:], truths[1:]):
            SL.scatter_rows(bank, r, t)
            clones.append({k: v.clone() for k, v in bank.items()})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for r, t, got in zip(rows[1:], truths[1:], clones):
        idx = np.asarray(r)
        for k, v in got.items():
            assert np.array_equal(v.cpu().numpy()[idx], t[k][idx]), k
    assert (SL.scatter_batch.layout_misses - misses, SL.scatter_batch.layout_hits - hits) == (1, 20)


def test_planes_on_the_card_equal_the_cpu(cuda):
    """A small drain through both planes on the card: the same placements
    as on the CPU, every batch gathered on the card in ONE launch for its
    pod arrays and term table, and the device twins equal to their host
    slabs."""
    from kubernetes_tpu_torch.models.clusters import bench_config3
    from kubernetes_tpu_torch.ops import slab as SL
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    out = {}
    for dev in ("cuda", "cpu"):
        nodes, pods, fn = bench_config3(200, 2000, services=True)
        cache, queue = SchedulerCache(), PriorityQueue()
        fill_cache(cache, nodes)
        sched = Scheduler(cache, queue, batch_size=512, deterministic=True, device=dev)
        sched.set_spread_selectors_fn(fn)
        for i, p in enumerate(pods):
            if i % 100 < 50:
                queue.add(p)
        launches = (SL.gather_batch.launches, SL.scatter_rows.launches)
        res = sched.schedule_batch()
        for i, p in enumerate(pods):  # new apps, admitted after the twins are resident: flushed by the scatter
            if i % 100 >= 50:
                queue.add(p)
        total = sched.run_until_empty()
        sched.wait_for_binds()
        st = sched.stats
        assert st["ingest_index_batches"] == st["term_index_batches"] == st["batches"]
        gathers = SL.gather_batch.launches - launches[0]
        assert gathers == (st["batches"] if dev == "cuda" else 0), (gathers, st["batches"])
        assert st["stage_sync_flushes"] > 0 and st["term_sync_flushes"] > 0
        assert sched.stage_bank.device_divergence() == [] == sched.term_bank.device_divergence()
        sched.close()
        out[dev] = ({**res.assignments, **total.assignments},
                    [a - b for a, b in zip((SL.gather_batch.launches, SL.scatter_rows.launches), launches)])
    assert out["cuda"][0] == out["cpu"][0] and len(out["cuda"][0]) == 2000
    assert all(n > 0 for n in out["cuda"][1]) and out["cpu"][1] == [0, 0]


def test_config4_drain_launches_one_match_a_batch(cuda):
    """A small config-4 drain (required anti-affinity, preferred affinity,
    the existing pods' terms, in-batch tracking) launches one match a batch
    — its two or three matrices in one launch — and places as the CPU
    does."""
    from kubernetes_tpu_torch.models.clusters import bench_config4
    from kubernetes_tpu_torch.scheduler.driver import Scheduler
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    out = {}
    for dev in ("cuda", "cpu"):
        nodes, pods = bench_config4(200, 2000)
        cache, queue = SchedulerCache(), PriorityQueue()
        fill_cache(cache, nodes)
        sched = Scheduler(cache, queue, batch_size=512, deterministic=True, device=dev)
        for p in pods:
            queue.add(p)
        launches, problems = TO.match_terms.launches, TO.match_terms.problems
        tables, ports = TO.match_terms.port_tables, F.inbatch_port_conflict.launches
        res = sched.run_until_empty()
        sched.wait_for_binds()
        batches, tracked = sched.stats["batches"], sched.stats["tracked_batches"]
        sched.close()
        out[dev] = (res.assignments, TO.match_terms.launches - launches, TO.match_terms.problems - problems, batches,
                    TO.match_terms.port_tables - tables, F.inbatch_port_conflict.launches - ports, tracked)
    assignments, launches, problems, batches, tables, ports, tracked = out["cuda"]
    assert assignments == out["cpu"][0] and len(assignments) == 2000
    # the first batch finds no existing pod's terms: its plan holds two matrices
    assert launches == batches and 2 * batches <= problems <= 3 * batches
    # every tracked batch's port table rides in its plan's launch
    assert tracked > 0 and tables == tracked and ports == 0


# --- the node mesh's cluster kernels -------------------------------------------

SHARDS = [1, 2, 4, 8]


def _solve_case(cuda, seed, tracked):
    """(args, kwargs) of a solve on a seeded cluster's mask and score: 640
    pods over 150 or 200 spec rows, padding, three priorities; with
    `tracked`, the inter-pod cluster and its in-batch tracking."""
    if tracked:
        na, ea, xa, ta, au, pa, ids = interpod_cluster(seed, cuda)
        mask = F.combined_mask(na, pa, ids) & TO.interpod_filter(na, ea, ta, au, xa, pa, ("existing", "aff", "anti"),
                                                                 n_buckets=256)
        score = S.score_matrix(na, pa) + TO.interpod_score(na, ea, ta, xa, pa, n_buckets=256)
    else:
        na, pa, ids = cluster(seed, cuda)
        mask, score = F.combined_mask(na, pa, ids), S.score_matrix(na, pa)
    b = 640
    pod_valid = torch.arange(b, device=cuda) < b - 40
    order = SO.pop_order((torch.arange(b, device=cuda) % 3).to(torch.int32),
                         torch.arange(b, dtype=torch.int32, device=cuda), pod_valid)
    args = (mask, score, pa["req"], na["alloc"] - na["requested"], na["pod_count"].long(),
            na["allowed_pods"].long(), order)
    kw = dict(req_any=pa["req_any"], sig=(torch.arange(b, device=cuda) % (150 if tracked else 200)).to(torch.int32),
              pod_valid=pod_valid, return_carry=True, nz0=na["nonzero_req"], scoring_req=pa["scoring_req"])
    if tracked:
        kw["inb"] = PP._inbatch_tensors(na, pa, ta, ids, 256)
    return args, kw


@pytest.mark.parametrize("tracked", [False, True], ids=["untracked", "tracked"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_solve_kernel_equals_plain(cuda, shards, det, tracked):
    """One cluster of S CTAs: the same choices and residuals as the plain
    sharded solve and the single-block kernel."""
    from kubernetes_tpu_torch.parallel import sharded as PS

    args, kw = _solve_case(cuda, 0, tracked)
    key = SO.prng_key_data(3)
    before, tracked_before = PS.solve_sharded.launches, PS.solve_sharded.tracked_launches
    got, carry = PS.solve_sharded(*args, key, shards, det, **kw)
    assert PS.solve_sharded.launches == before + 1
    assert PS.solve_sharded.tracked_launches == tracked_before + int(tracked)
    want, want_carry = PS.solve_sharded_plain(*args, key, shards, det, **kw)
    single, single_carry = SO.solve_greedy(*args, key, det, **kw)
    assert torch.equal(got, want) and torch.equal(got, single)
    for a, c, d in zip(carry, want_carry, single_carry):
        assert torch.equal(a, c) and torch.equal(a, d)
    assert int((got >= 0).sum()) > 50


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_gang_kernel_equals_plain(cuda, shards, det):
    """The gang mode: both passes in one cluster launch, against the plain
    sharded gang solve and the single-block gang kernel."""
    import numpy as np

    from kubernetes_tpu_torch.parallel import sharded as PS

    args, kw = _solve_case(cuda, 1, False)
    b = args[-1].shape[0]
    rng = np.random.default_rng(5)
    group = torch.from_numpy(np.where(rng.random(b) < 0.7, rng.integers(0, 60, b), -1).astype(np.int32)).to(cuda)
    key = SO.prng_key_data(2**32 + 7)
    before = PS.solve_gang_sharded.launches
    got, ok, carry = PS.solve_gang_sharded(*args, group, key, shards, det, **kw)
    assert PS.solve_gang_sharded.launches == before + 1
    want, want_ok, want_carry = PS.solve_gang_sharded_plain(*args, group, key, shards, det, **kw)
    single, single_ok, _ = SO.solve_gang(*args, group, key, det, **kw)
    assert torch.equal(got, want) and torch.equal(ok, want_ok) and torch.equal(got, single) and torch.equal(ok, single_ok)
    for a, c in zip(carry, want_carry):
        assert torch.equal(a, c)


@pytest.mark.parametrize("track", [True, False], ids=["tracked", "untracked"])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_arbiter_kernel_equals_plain(cuda, shards, track):
    """The cluster scan on a solved DoNotSchedule / inter-pod / host-port
    batch, with and without the spread kinds: the plain sharded scan's,
    the single-device kernel's and the plain scan's verdicts."""
    from kubernetes_tpu_torch.commit import arbiter as A

    na, ea, xa, ta, au, pa, ids, v = hard_spread_cluster(0, cuda)
    b = 360
    pb = {"sig": (torch.arange(b, device=cuda) % 120).to(torch.int32),
          "valid": torch.arange(b, device=cuda) < b - 8,
          "priority": (torch.arange(b, device=cuda) % 3).to(torch.int32)}
    kinds = frozenset({"spread_hard", "spread_soft", "anti_req", "pref", "et_anti", "et_score"})
    assign, _ = PP.solve_pipeline(na, pa, ids, SO.prng_key_data(1), pb=pb, term_kinds=kinds,
                                  track_inbatch=track, ea=ea, ta=ta, au=au, xa=xa, n_buckets=v)
    for tk in (kinds, kinds - {"spread_hard"}):
        before = A.arbitrate_sharded.launches
        got = A.arbitrate_sharded(shards, na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=v)
        assert A.arbitrate_sharded.launches == before + 1
        want = A.arbitrate_sharded_plain(shards, na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=v)
        assert torch.equal(got, want)
        assert torch.equal(got, A.arbitrate(na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=v))
    assert bool((want == A.V_PLACE).any())
    if not track:
        assert bool((want == A.V_DEFER).any())


@pytest.mark.parametrize("case", ["duplicates", "carries"])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_fold_kernels_equal_plain(cuda, shards, case):
    """Both sharded folds (duplicate rows, sentinels, int16 wrap and, in
    the carries case, low-half carries and counts of both signs) against
    their plain versions and the single-device kernels; the commit fold
    through the tensor wrapper and the packed path."""
    from kubernetes_tpu_torch.ops import fold as FO

    g = torch.Generator().manual_seed(shards)
    n, r, s, pt, b, t = 64, 6, 40, 12, 4096, 900
    banks, ctl = fold_case(case, g, n, r, s, pt, b, t)
    ctl[0] = torch.randint(0, n + 1, (b,), generator=g).int()  # rows on every shard
    ctl[4] = torch.randint(0, s + 1, (b,), generator=g).int()  # every signature and pattern column
    ctl[5] = torch.randint(0, n + 1, (t,), generator=g).int()
    ctl[6] = torch.randint(0, pt + 1, (t,), generator=g).int()
    got = [x.to(cuda) for x in banks]
    single = [x.to(cuda) for x in banks]
    before = FO.fold_commit_sharded.launches
    FO.fold_commit_sharded(shards, *got, *(x.to(cuda) for x in ctl))
    assert FO.fold_commit_sharded.launches == before + 1
    FO.fold_commit_banks(*single, *(x.to(cuda) for x in ctl))
    want = FO.fold_commit_sharded_plain(shards, *(x.clone() for x in banks), *ctl)
    for a, w, o in zip(got, want, single):
        assert torch.equal(a.cpu(), w) and torch.equal(a, o)
    packed = FO.fold_control(**{k: x.numpy() for k, x in zip(FOLD_PROGRAM, ctl)}, n=n, pin=True)
    got = [x.to(cuda) for x in banks]
    FO.fold_commit_packed(*got, packed, shards=shards)
    assert FO.fold_commit_sharded.launches == before + 2
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)
    req, cnt = banks[0].to(cuda), banks[2].to(cuda)
    before = FO.fold_usage_sharded.launches
    FO.fold_usage_sharded(shards, req, cnt, ctl[0].to(cuda), ctl[1].to(cuda), ctl[3].to(cuda))
    assert FO.fold_usage_sharded.launches == before + 1
    w_req, w_cnt = FO.fold_usage_sharded_plain(shards, banks[0].clone(), banks[2].clone(), ctl[0], ctl[1], ctl[3])
    assert torch.equal(req.cpu(), w_req) and torch.equal(cnt.cpu(), w_cnt)
    FO.fold_usage_sharded(shards, req, cnt, ctl[0].to(cuda), -ctl[1].to(cuda), -ctl[3].to(cuda))
    assert torch.equal(req.cpu(), banks[0]) and torch.equal(cnt.cpu(), banks[2])


def _kernel_grids(fn, name):
    """The launch grids of kernel `name` in a profiler trace of fn()."""
    import json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED_CALLS):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [tuple(e["args"]["grid"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel" and name in e.get("name", "")]


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_commit_fold_is_one_element_grid(cuda, shards):
    """The sharded commit launches the single fold's kernel on its element
    grid, no y dimension (each element read once), and rows on either side
    of every shard boundary, the padding sentinel and negative rows fold as
    the plain version and the single-device fold them; a capacity that S
    does not divide is refused before any launch."""
    from kubernetes_tpu_torch.ops import fold as FO

    g = torch.Generator().manual_seed(10 + shards)
    n, r, s, pt, b, t = 64, 6, 40, 12, 2048, 600
    banks, ctl = fold_case("carries", g, n, r, s, pt, b, t)
    nl = n // shards
    edges = torch.tensor(sorted({x for lo in range(0, n, nl) for x in (lo - 1, lo, lo + nl - 1) if 0 <= x < n}
                                | {n, -1}), dtype=torch.int32)
    ctl[0] = edges[torch.randint(0, len(edges), (b,), generator=g)]
    ctl[5] = edges[torch.randint(0, len(edges), (t,), generator=g)]
    got = [x.to(cuda) for x in banks]
    single = [x.to(cuda) for x in banks]
    dctl = [x.to(cuda) for x in ctl]
    FO.fold_commit_sharded(shards, *got, *dctl)
    FO.fold_commit_banks(*single, *dctl)
    want = FO.fold_commit_sharded_plain(shards, *(x.clone() for x in banks), *ctl)
    for a, w, o in zip(got, want, single):
        assert torch.equal(a.cpu(), w) and torch.equal(a, o)
    blocks = -(-(b * (r + 4) + t) // 256)
    grids = _kernel_grids(lambda: FO.fold_commit_sharded(shards, *got, *dctl), "fold_commit_kernel")
    assert grids and all(gr == (blocks, 1, 1) for gr in grids), grids
    before = FO.fold_commit_sharded.launches
    with pytest.raises(ValueError, match="not divisible"):
        FO.fold_commit_sharded(3, *got, *dctl)
    assert FO.fold_commit_sharded.launches == before


def test_sharded_cluster_of_16_runs_or_is_refused(cuda):
    """16 shards need the non-portable cluster size: the kernel either runs
    one 16-CTA cluster, equal to the plain version, or is refused with the
    documented error (the card cannot co-schedule it); 32 shards are
    refused before any launch."""
    from kubernetes_tpu_torch.parallel import sharded as PS

    args, kw = _solve_case(cuda, 0, False)
    key = SO.prng_key_data(3)
    try:
        got, _ = PS.solve_sharded(*args, key, 16, False, **kw)
    except RuntimeError as e:
        assert "cannot co-schedule a cluster of 16 CTAs" in str(e)
    else:
        assert torch.equal(got, PS.solve_sharded_plain(*args, key, 16, False, **kw)[0])
    with pytest.raises(ValueError, match="1 to 16"):
        PS.solve_sharded(*args, key, 32, False, **kw)


# ---------------------------------------------------------------------------
# the solve walk as a cluster on one device: shared-memory residuals, spec
# rows prefetched, padded node rows, the counted device-memory path
# ---------------------------------------------------------------------------

def synthetic_solve(seed, device, u=24, n=517, b=700, r=8, ties=False, runs=True, fit_nowhere=True,
                    holes=True, tight=False):
    """(args, kwargs) of a solve on seeded random tensors: U spec rows of R
    resource slots over N nodes (any N, so the padding of the last CTA's
    rows shows), B pods in pop order over three priorities. `ties`: every
    score equal (the tie-break noise decides every pod); `runs`: pods of
    one spec in runs (the prefetch reuses the row), else consecutive pods
    never share a spec; `fit_nowhere`: one spec masked off everywhere and
    one asking more than any node has; `holes`: invalid pods scattered
    through the batch beside the padded tail; `tight`: one pod a node."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = rng.random((u, n)) < 0.6
    score = np.zeros((u, n), np.int64) if ties else rng.integers(0, 12, (u, n))
    req = rng.integers(0, 1000, (u, r))
    req[rng.random((u, r)) < 0.3] = 0
    req[0] = 0  # a spec asking nothing
    free0 = rng.integers(500, 6000, (n, r))
    count0 = rng.integers(0, 5, n)
    allowed = count0 + (1 if tight else rng.integers(1, 30, n))
    if fit_nowhere:
        mask[1] = False
        req[2] = 10**7
    if runs:
        sig = np.repeat(rng.integers(0, u, -(-b // 7)), 7)[:b]
    else:
        sig = (np.arange(b) * 5) % u
    pod_valid = np.arange(b) < b - 37
    if holes:
        pod_valid &= rng.random(b) > 0.1
    prio = rng.integers(0, 3, b)
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)  # noqa: E731
    order = SO.pop_order(t(prio, torch.int32), torch.arange(b, dtype=torch.int32, device=device),
                         t(pod_valid, torch.bool))
    args = (t(mask, torch.bool), t(score, torch.int64), t(req, torch.int64), t(free0, torch.int64),
            t(count0, torch.int64), t(allowed, torch.int64), order)
    kw = dict(req_any=t((req > 0).any(-1), torch.bool), sig=t(sig, torch.int32), pod_valid=t(pod_valid, torch.bool),
              return_carry=True, nz0=t(rng.integers(0, 100, (n, 2)), torch.int64),
              scoring_req=t(rng.integers(0, 50, (u, 2)), torch.int64))
    return args, kw


def _solo_or_refused(fn, shards):
    """fn()'s result, or None when the card cannot co-schedule `shards`
    CTAs as one cluster (the documented refusal, never a fallback)."""
    try:
        return fn()
    except RuntimeError as e:
        assert shards > 8 and f"cannot co-schedule a cluster of {shards} CTAs" in str(e)
        return None


SOLO = [1, 2, 4, 8, 16]
SOLVE_CASES = {
    "runs": {}, "no-runs": dict(runs=False), "ties": dict(ties=True), "r32": dict(r=32, u=12),
    "no-holes": dict(holes=False, fit_nowhere=False), "n-divisible": dict(n=512),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("shards", SOLO)
def test_solo_cluster_solve_equals_plain(cuda, monkeypatch, shards, det, case):
    """solve_greedy as one cluster of S CTAs on one device (N = 517: the
    last CTA's rows padded), the residuals in shared memory: the same
    choices and carry as the plain version, on runs of one spec and on
    consecutive distinct specs, all-tied scores, R = 32, pods that fit
    nowhere, invalid pods through the batch."""
    monkeypatch.setattr(SO, "SOLO_SHARDS", shards)
    args, kw = synthetic_solve(shards * 10 + det, cuda, **SOLVE_CASES[case])
    key = SO.prng_key_data(11)
    before, glob = SO.solve_greedy.launches, SO.solve_greedy.global_state_launches
    got = _solo_or_refused(lambda: SO.solve_greedy(*args, key, det, **kw), shards)
    if got is None:
        return
    assert SO.solve_greedy.launches == before + 1 and SO.solve_greedy.global_state_launches == glob
    want = SO.solve_greedy_plain(*args, key, det, **kw)
    assert torch.equal(got[0], want[0])
    for a, c in zip(got[1], want[1]):
        assert torch.equal(a, c)
    assert int((got[0] >= 0).sum()) > 100


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("shards", SOLO)
def test_solo_cluster_tracked_solve_equals_plain(cuda, monkeypatch, shards, det):
    """The tracked solve (in-batch anti-affinity, host ports) as one
    cluster of S CTAs on one device: the plain version's choices and carry."""
    monkeypatch.setattr(SO, "SOLO_SHARDS", shards)
    args, kw = _solve_case(cuda, 1, True)
    key = SO.prng_key_data(5)
    before = SO.solve_greedy.tracked_launches
    got = _solo_or_refused(lambda: SO.solve_greedy(*args, key, det, **kw), shards)
    if got is None:
        return
    assert SO.solve_greedy.tracked_launches == before + 1
    want = SO.solve_greedy_plain(*args, key, det, **kw)
    assert torch.equal(got[0], want[0])
    for a, c in zip(got[1], want[1]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("tight", [False, True], ids=["loose", "tight"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("shards", SOLO)
def test_solo_cluster_gang_solve_equals_plain(cuda, monkeypatch, shards, det, tight):
    """The gang mode as one cluster of S CTAs on one device, both passes in
    shared memory; `tight` (one pod a node) drops groups."""
    import numpy as np

    monkeypatch.setattr(SO, "SOLO_SHARDS", shards)
    args, kw = synthetic_solve(shards + 3, cuda, tight=tight, n=301 if tight else 517)
    b = args[-1].shape[0]
    rng = np.random.default_rng(shards)
    group = np.where(rng.random(b) < 0.7, rng.integers(0, 90, b), -1).astype(np.int32)
    group = torch.from_numpy(group).to(cuda)
    key = SO.prng_key_data(2**32 + 9)
    got = _solo_or_refused(lambda: SO.solve_gang(*args, group, key, det, **kw), shards)
    if got is None:
        return
    want = SO.solve_gang_plain(*args, group, key, det, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, c in zip(got[2], want[2]):
        assert torch.equal(a, c)
    if tight:
        assert int((~want[1]).sum()) > 0


@pytest.mark.parametrize("gang", [False, True], ids=["greedy", "gang"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_solve_too_large_for_shared_memory_takes_counted_device_path(cuda, det, gang):
    """A node count whose rows do not fit a CTA's shared memory (N =
    40,000 over the default cluster: more than 2,048 rows a CTA) takes the
    same kernel's device-memory path, counted, and equals the plain version."""
    import numpy as np

    args, kw = synthetic_solve(7, cuda, u=8, n=40000, b=512)
    lay = SO.solve_layout(40000, 8, 512, SO.SOLO_SHARDS)
    assert not lay["resident"]
    key = SO.prng_key_data(4)
    if gang:
        group = torch.from_numpy((np.arange(512) // 8).astype(np.int32)).to(cuda)
        before = SO.solve_gang.global_state_launches
        got = SO.solve_gang(*args, group, key, det, **kw)
        assert SO.solve_gang.global_state_launches == before + 1
        want = SO.solve_gang_plain(*args, group, key, det, **kw)
        assert torch.equal(got[1], want[1])
        got, want = (got[0], got[2]), (want[0], want[2])
    else:
        before = SO.solve_greedy.global_state_launches
        got = SO.solve_greedy(*args, key, det, **kw)
        assert SO.solve_greedy.global_state_launches == before + 1
        want = SO.solve_greedy_plain(*args, key, det, **kw)
    assert torch.equal(got[0], want[0])
    for a, c in zip(got[1], want[1]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("n_buckets", [16, 2048], ids=["tables-shared", "tables-device"])
@pytest.mark.parametrize("track", [True, False], ids=["tracked", "untracked"])
@pytest.mark.parametrize("shards", SHARDS)
def test_arbiter_hoisted_facts_equal_plain(cuda, shards, track, n_buckets):
    """The redesigned scan (facts hoisted into the grid-wide launches, the
    running DoNotSchedule minimum) with its tables in shared memory (V =
    16) and in device memory (V = 2,048), on a solved DoNotSchedule /
    inter-pod / host-port batch: the plain scan's verdicts, one CTA or S."""
    from kubernetes_tpu_torch.commit import arbiter as A

    na, ea, xa, ta, au, pa, ids, _ = hard_spread_cluster(1, cuda)
    b = 360
    pb = {"sig": (torch.arange(b, device=cuda) % 120).to(torch.int32),
          "valid": torch.arange(b, device=cuda) < b - 8,
          "priority": (torch.arange(b, device=cuda) % 3).to(torch.int32)}
    kinds = frozenset({"spread_hard", "spread_soft", "anti_req", "pref", "et_anti", "et_score"})
    assign, _ = PP.solve_pipeline(na, pa, ids, SO.prng_key_data(2), pb=pb, term_kinds=kinds,
                                  track_inbatch=track, ea=ea, ta=ta, au=au, xa=xa, n_buckets=n_buckets)
    for tk in (kinds, kinds - {"spread_hard"}):
        if shards == 1:
            got = A.arbitrate(na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=n_buckets)
        else:
            got = A.arbitrate_sharded(shards, na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=n_buckets)
        want = A.arbitrate_plain(na, pa, ea, ta, ids, assign, pb, term_kinds=tk, n_buckets=n_buckets)
        assert torch.equal(got, want)
    assert bool((want == A.V_PLACE).any())


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("config", ["config-3-hard", "config-4"])
def test_arbiter_at_the_main_path_shapes_equals_plain(cuda, config, shards):
    """The arbiter at the shapes its drains give it, one 4,096-pod batch
    solved on the card (chip_smoke.py's batches): config 3-hard (U = TT =
    128, N = 10,240, V = 16: tables in shared memory) and config 4 (U = TT
    = 32, N = 2,048, V = 2,048: tables in device memory), one CTA or S."""
    import os
    import sys

    from kubernetes_tpu_torch.commit import arbiter as A

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as C

    if config == "config-4":
        nodes, existing, pods = C.config4_batch(1000)
    else:
        nodes, existing, pods, _ = C.config3_batch(False, 5000, hard=True)
    enc = C.encode(nodes, existing, pods, cuda)
    na, ea, xa, ta, au, pa, ids, v, sig, kinds = (enc[k] for k in ("na", "ea", "xa", "ta", "au", "pa", "ids", "v",
                                                                   "sig", "kinds"))
    b = sig.shape[0]
    pb = {"sig": sig, "valid": torch.ones(b, dtype=torch.bool, device=cuda),
          "priority": torch.zeros(b, dtype=torch.int32, device=cuda)}
    track = "anti_req" in kinds or enc["ports"]
    assign, _ = PP.solve_pipeline(na, pa, ids, SO.prng_key_data(5), pb=pb, term_kinds=kinds, track_inbatch=track,
                                  ea=ea, ta=ta, au=au, xa=xa, n_buckets=v)
    args = (na, pa, ea, ta, ids, assign, pb)
    if shards == 1:
        got = A.arbitrate(*args, term_kinds=kinds, n_buckets=v)
    else:
        got = A.arbitrate_sharded(shards, *args, term_kinds=kinds, n_buckets=v)
    want = A.arbitrate_plain(*args, term_kinds=kinds, n_buckets=v)
    assert torch.equal(got, want)
    assert bool((want == A.V_PLACE).any())
