"""The port's score matrix (plain version on CPU) against the reference's
JAX score_matrix on identical encoded inputs: the default provider tuple,
MostRequested, ResourceLimits, RequestedToCapacityRatio (the default shape,
a bin-packing shape and a five-point shape with a down-sloping segment)
and every component alone; score_components against the reference's.
Tolerance: exact equality (int64; BalancedAllocation's float64 is
truncated identically)."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import scores as RS

from kubernetes_tpu_torch.ops import scores as PS
from test_torch_filters import encoded

CONFIGS = {
    "default": (None, None),
    "most": ((("MostRequestedPriority", 1),), None),
    "limits": ((("ResourceLimitsPriority", 3), ("LeastRequestedPriority", 1)), None),
    "rtcr-default": ((("RequestedToCapacityRatioPriority", 2),), None),
    "rtcr-shape": (
        (("RequestedToCapacityRatioPriority", 1), ("BalancedResourceAllocation", 2)),
        (((0, 0), (30, 7), (70, 3), (100, 10)), (("cpu", 3), ("memory", 1))),
    ),
    "rtcr-binpack": ((("RequestedToCapacityRatioPriority", 2), ("NodeAffinityPriority", 1)),
                     (((0, 0), (100, 10)), (("cpu", 1), ("memory", 1)))),
    "rtcr-down": ((("RequestedToCapacityRatioPriority", 1),),
                  (((0, 2), (20, 9), (45, 1), (80, 6), (100, 0)), (("cpu", 3), ("memory", 1)))),
    "all": (tuple((name, i + 1) for i, name in enumerate(PS.PRIORITIES)), None),
}


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 3])
def test_score_matrix_matches_reference(name, seed):
    priorities, rtcr = CONFIGS[name]
    (jn, jp, _), (tn, tp, _) = encoded(seed)
    ref = np.asarray(RS.score_matrix(jn, jp, priorities=priorities, rtcr=rtcr))
    port = PS.score_matrix(tn, tp, priorities, rtcr)
    assert port.dtype == torch.int64
    assert np.array_equal(ref, port.numpy())


@pytest.mark.parametrize("component", [
    "least_requested", "most_requested", "balanced_allocation", "node_affinity",
    "taint_toleration", "prefer_avoid_pods", "image_locality", "resource_limits",
])
def test_each_priority_matches_reference(component):
    (jn, jp, _), (tn, tp, _) = encoded(5)
    ref = np.asarray(getattr(RS, component)(jn, jp))
    port = getattr(PS, component)(tn, tp).numpy()
    assert np.array_equal(ref, port)
    assert len(np.unique(port)) > 1  # the cluster makes the component vary


def test_bias_and_kernel_weights():
    (_, _, _), (tn, tp, _) = encoded(2)
    base = PS.score_matrix(tn, tp)
    assert bool((PS.score_matrix(tn, tp, bias=10) == base + 10).all())
    w, w_rtcr = PS.kernel_weights((("NodeAffinityPriority", 2), ("NodeAffinityPriority", 3),
                                   ("SelectorSpreadPriority", 1)), has_images=True)
    assert w == [0, 0, 0, 5, 0, 0, 0, 0] and w_rtcr == 0
    assert PS.kernel_weights(None, has_images=False)[0][6] == 0
    # the RTCR branch is in the kernel now: its weight rides beside the vector
    w, w_rtcr = PS.kernel_weights((("RequestedToCapacityRatioPriority", 1), ("LeastRequestedPriority", 2),
                                   ("RequestedToCapacityRatioPriority", 3)), True)
    assert w == [2, 0, 0, 0, 0, 0, 0, 0] and w_rtcr == 4


@pytest.mark.parametrize("seed", [0, 5])
def test_score_components_matches_reference(seed):
    """The reference's score_components dict, plane for plane (its only
    reference caller is tests/test_score_parity.py)."""
    (jn, jp, _), (tn, tp, _) = encoded(seed)
    ref = RS.score_components(jn, jp)
    port = PS.score_components(tn, tp)
    assert sorted(port) == sorted(ref)  # a jitted dict comes back key-sorted
    for name in ref:
        assert port[name].dtype == torch.int64
        assert np.array_equal(np.asarray(ref[name]), port[name].numpy()), name
    # without an image table the reference drops the image plane, as does the port
    jn2 = {k: v for k, v in jn.items() if k != "image_scaled"}
    tn2 = {k: v for k, v in tn.items() if k != "image_scaled"}
    assert sorted(PS.score_components(tn2, tp)) == sorted(RS.score_components(jn2, jp))


def test_rtcr_struct_holds_the_shape():
    """The argument struct's RTCR room: the Policy's largest shape (101
    points) fits, a larger one and a resource without a device column are
    refused before any launch."""
    args = PS.ScoreArgs()
    shape = tuple((u, u // 10) for u in range(101))
    PS._set_rtcr(args, (shape, (("memory", 2), ("cpu", 1))))
    assert args.rtcr_points == 101 and args.rtcr_u[100] == 100 and args.rtcr_s[100] == 10
    assert (args.rtcr_res, args.rtcr_res_col[0], args.rtcr_res_w[0]) == (2, 1, 2)
    with pytest.raises(ValueError, match="1 to 101"):
        PS._set_rtcr(args, (shape + ((101, 0),), (("cpu", 1),)))
    with pytest.raises(ValueError, match="device column"):
        PS._set_rtcr(args, (((0, 0),), (("nvidia.com/gpu", 1),)))


def _c_div(a, b):
    """C's int64 `/` (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _walk_rtcr(nodes, pods, shape, resources):
    """csrc/scores.cu's rtcr_score as the kernel computes it: a forward
    scan to the first p <= u_i (the reference evaluates back to front),
    go_div written with C's truncating `/`, Python floor division where
    the kernel calls floordiv."""
    cols = {"cpu": 0, "memory": 1}
    alloc, nz, sreq = nodes["alloc"].tolist(), nodes["nonzero_req"].tolist(), pods["scoring_req"].tolist()
    out = []
    for u in range(len(sreq)):
        row = []
        for n in range(len(alloc)):
            ns = ws = 0
            for rname, w in resources:
                c = cols[rname]
                cap, req = alloc[n][c], nz[n][c] + sreq[u][c]
                p = 100 if (cap == 0 or req > cap) else 100 - ((cap - req) * 100) // max(cap, 1)
                s = shape[-1][1]
                for i, (ui, si) in enumerate(shape):
                    if p <= ui:
                        s = si if i == 0 else shape[i - 1][1] + _c_div((si - shape[i - 1][1]) * (p - shape[i - 1][0]),
                                                                       ui - shape[i - 1][0])
                        break
                if s > 0:
                    ns += s * w
                    ws += w
            row.append((2 * ns + ws) // (2 * ws) if ws > 0 else 0)
        out.append(row)
    return torch.tensor(out, dtype=torch.int64)


@pytest.mark.parametrize("name", ["rtcr-default", "rtcr-shape", "rtcr-binpack", "rtcr-down"])
def test_rtcr_kernel_algorithm_matches_plain(name):
    """The RTCR branch's algorithm as the kernel writes it (forward scan,
    C division) equals the plain version, which follows the reference."""
    _, rtcr = CONFIGS[name]
    shape, res = rtcr if rtcr is not None else (PS.DEFAULT_RTCR_SHAPE, PS.DEFAULT_RTCR_RESOURCES)
    (_, _, _), (tn, tp, _) = encoded(3)
    want = PS.requested_to_capacity_ratio(tn, tp, shape, res)
    assert torch.equal(_walk_rtcr(tn, tp, shape, res), want)
    assert len(torch.unique(want)) > 1
