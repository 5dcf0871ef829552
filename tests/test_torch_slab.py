"""The planes' batch slab gather (ops/slab.gather_batch, csrc/slab.cu's
ktpu_gather_batch) on the CPU: both problems of a batch (the pod arrays and
the term table) and each alone against the reference's jitted
`gather_stage` and `gather_terms`, bit for bit, on numpy-seeded slabs with
padding lanes, repeated rows, no live lane, int64 extremes and slabs of 1
to 16,384 rows; the kernel's algorithm walked in Python over the host's
segment table (every output byte written exactly once, every chunk on its
segment's word width and 16-byte aligned, the outputs equal to the plain
versions) with a slab array whose pointer is only 4-byte aligned; the
argument block against csrc/slab.cu's defines; the plan cache; the host
checks. Tolerance: exact equality."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops  # noqa: F401  (turns x64 on, as the reference runs)
from kubernetes_tpu.ingest.gather import gather_stage as r_gather_stage
from kubernetes_tpu.terms_plane.gather import gather_terms as r_gather_terms

from kubernetes_tpu_torch.ingest import gather_stage, gather_stage_plain, stage_problem
from kubernetes_tpu_torch.ops import slab as SL
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch, Vocab
from kubernetes_tpu_torch.state.terms import TermBank
from kubernetes_tpu_torch.terms_plane import gather_terms, gather_terms_plain, term_problem

from test_torch_ingest import assert_same, ref_dict, seeded_slab, walk_batch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kubernetes_tpu_torch", "csrc")


def template(plane):
    return (PodBatch if plane == "stage" else TermBank)(Vocab(), 1).arrays()


def case_lanes(rng, s, n, live):
    """[n] lanes, `live` kept (the first three on one row), padding after."""
    idx = np.zeros(n, np.int32)
    idx[:live] = rng.integers(0, s, live)
    idx[: min(3, live)] = idx[0]
    keep = np.arange(n) < live
    return idx, keep


def planes_case(s_stage, u, live_u, s_terms, t, live_t, seed):
    """Seeded slabs of both planes and their lanes: numpy slabs, torch CPU
    slabs, the lanes and the columns (fallback bools, owners past the
    lanes)."""
    rng = np.random.default_rng(seed)
    out = {}
    for plane, s, n, live in (("stage", s_stage, u, live_u), ("terms", s_terms, t, live_t)):
        slab, empty = seeded_slab(template(plane), s, seed + (plane == "terms"))
        idx, keep = case_lanes(rng, s, n, live)
        col = (rng.random(n) < 0.3) if plane == "stage" else rng.integers(0, 1000, n).astype(np.int32)
        out[plane] = (slab, empty, arrays_to_torch(slab, "cpu", copy=True), arrays_to_torch(empty, "cpu", copy=True),
                      idx, keep, col)
    return out


def problem(plane, case):
    _, _, bank, emp, idx, keep, col = case[plane]
    return (stage_problem(bank, idx, keep, emp, col) if plane == "stage"
            else term_problem(bank, idx, col, keep, emp))


def reference(plane, case):
    slab, empty, _, _, idx, keep, col = case[plane]
    if plane == "stage":
        return r_gather_stage(ref_dict(slab), jnp.asarray(idx), jnp.asarray(keep), ref_dict(empty), jnp.asarray(col))
    return r_gather_terms(ref_dict(slab), jnp.asarray(idx), jnp.asarray(col), jnp.asarray(keep), ref_dict(empty))


CASES = {
    # (stage slab rows, U, live; term slab rows, TT, live)
    "config-3": (256, 128, 100, 256, 128, 100),
    "no-live-lane": (37, 16, 0, 37, 16, 0),
    "one-row-slabs": (1, 4, 2, 1, 1, 1),
    "one-lane": (3, 1, 1, 3, 1, 0),
    "16384-row-slabs": (16384, 64, 64, 16384, 32, 20),
}


@pytest.mark.parametrize("which", ["both", "stage", "terms"])
@pytest.mark.parametrize("case", list(CASES))
def test_gather_batch_matches_reference(case, which):
    """gather_batch's CPU path equals the reference's jitted gathers, and a
    problem gathers the same alone or beside the other; no launch."""
    c = planes_case(*CASES[case], seed=len(case))
    planes = ["stage", "terms"] if which == "both" else [which]
    before = SL.gather_batch.launches
    got = SL.gather_batch([problem(p, c) for p in planes])
    assert SL.gather_batch.launches == before and len(got) == len(planes)
    for plane, out in zip(planes, got):
        assert_same(reference(plane, c), out)
        assert list(out) == list(c[plane][2])  # slab order


@pytest.mark.parametrize("case", ["config-3", "one-row-slabs", "16384-row-slabs"])
def test_plane_wrappers_are_one_problem_calls(case):
    """gather_stage / gather_terms equal their plain versions and the
    reference on the CPU, launching nothing."""
    c = planes_case(*CASES[case], seed=3)
    _, _, bank, emp, idx, keep, fb = c["stage"]
    want = gather_stage_plain(bank, torch.from_numpy(idx), torch.from_numpy(keep), emp, torch.from_numpy(fb))
    assert_same(reference("stage", c), gather_stage(bank, idx, keep, emp, fb))
    assert_same(reference("stage", c), want)
    _, _, bank, emp, idx, keep, own = c["terms"]
    want = gather_terms_plain(bank, torch.from_numpy(idx), torch.from_numpy(own), torch.from_numpy(keep), emp)
    assert_same(reference("terms", c), gather_terms(bank, idx, own, keep, emp))
    assert_same(reference("terms", c), want)
    assert gather_stage.launches == gather_terms.launches == 0


def unaligned(bank, key, offset_bytes=4):
    """`bank` with `key` moved into a buffer at `offset_bytes` past a
    16-byte boundary (same values, contiguous)."""
    v = bank[key]
    raw = torch.zeros(v.numel() * v.element_size() + 16, dtype=torch.uint8)
    shift = (-raw.data_ptr()) % 16 + offset_bytes
    moved = raw[shift : shift + v.numel() * v.element_size()].view(v.dtype).view(v.shape)
    moved.copy_(v)
    assert moved.data_ptr() % 16 == offset_bytes
    return {**bank, key: moved}


WALKS = {
    "config-3": (256, 128, 100, 256, 128, 100),
    "odd-lanes": (37, 48, 5, 37, 24, 7),
    "one-lane": (3, 1, 1, 3, 1, 0),
    "no-live-lane": (9, 8, 0, 9, 4, 0),
}


@pytest.mark.parametrize("shift", [False, True], ids=["aligned", "4-byte-aligned-pointer"])
@pytest.mark.parametrize("which", ["both", "stage", "terms"])
@pytest.mark.parametrize("case", list(WALKS))
def test_kernel_walk_covers_every_byte_once_and_equals_plain(case, which, shift):
    """csrc/slab.cu's batch gather walked over the host segment table:
    every gathered output byte written exactly once (the lane region and
    the alignment pads never), each CTA's chunk starting on its segment's
    word and on 16 bytes, the segments in CTA order; the outputs equal the
    plain gathers (and so the reference). With `shift`, the pod arrays'
    label_vals (256-byte rows) and the term table's ex_vals (24-byte rows)
    sit 4 bytes past a 16-byte boundary: 4-byte words."""
    c = planes_case(*WALKS[case], seed=11)
    if shift:
        for plane, key in (("stage", "label_vals"), ("terms", "ex_vals")):
            slab, empty, bank, emp, idx, keep, col = c[plane]
            c[plane] = (slab, empty, unaligned(bank, key), emp, idx, keep, col)
    planes = ["stage", "terms"] if which == "both" else [which]
    probs = [problem(p, c) for p in planes]
    outs, writes = walk_batch(probs)
    plan = SL.GatherPlan(probs, [len(c[p][4]) for p in planes])
    covered = np.zeros(plan.nbytes, np.int64)
    ctas = 0
    for j, k, src, _, dst, _, lw, rw, n_words, first, n_ctas in plan.segments:
        wb = 1 << lw
        assert first == ctas and n_ctas == -(-n_words * wb // SL.CHUNK_BYTES)
        assert dst % 16 == 0 and src % wb == 0 and SL.row_bytes(probs[j].slab[k]) == rw * wb
        for chunk in range(n_ctas):
            start = dst + chunk * SL.CHUNK_BYTES
            assert start % 16 == 0 and start % wb == 0
        covered[dst : dst + n_words * wb] += 1
        ctas += n_ctas
    assert ctas == plan.n_ctas and len(plan.segments) <= SL.MAX_SEGMENTS
    assert np.array_equal(writes, covered) and set(np.unique(writes)) <= {0, 1}
    assert not writes[: plan.host_bytes].any()
    if shift:
        lws = {seg[1]: seg[6] for seg in plan.segments}
        assert lws.get("label_vals", 2) == 2 and lws.get("ex_vals", 2) == 2
    for plane, got in zip(planes, outs):
        assert_same(reference(plane, c), {k: torch.from_numpy(v) for k, v in got.items()})


def test_argument_block_mirrors_the_kernel_source():
    """The ctypes mirror of GatherBatchArgs against csrc/slab.cu: the same
    limits, and a block below the 4 KB kernel-parameter limit every CUDA
    toolkit takes."""
    with open(os.path.join(CSRC, "slab.cu")) as f:
        src = f.read()
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert int(defines["GATHER_MAX_SEGMENTS"]) == SL.MAX_SEGMENTS
    assert int(defines["GATHER_CHUNK_BYTES"]) == SL.CHUNK_BYTES == SL.THREADS * 16
    assert int(defines["SLAB_THREADS"]) == SL.THREADS
    assert int(defines["SLAB_MAX_ARRAYS"]) == SL.MAX_ARRAYS
    import ctypes

    assert ctypes.sizeof(SL.GatherSeg) == 48 and ctypes.sizeof(SL.GatherBatchArgs) < 4096
    assert "ktpu_gather_batch" in src and "ktpu_gather_slab" not in src


def test_plan_is_cached_while_its_tensors_live():
    """One plan per (slab tensors, lane counts); it leaves the cache when a
    tensor it points into is freed."""
    c = planes_case(37, 16, 5, 37, 8, 3, seed=2)
    probs = [problem("stage", c), problem("terms", c)]
    plan = SL.gather_plan(probs, [16, 8])
    assert SL.gather_plan(probs, [16, 8]) is plan
    assert SL.gather_plan(probs, [16, 16]) is not plan
    key = SL._plan_key(probs, [16, 8])
    assert key in SL._PLANS
    del probs, c, plan
    import gc

    gc.collect()
    assert key not in SL._PLANS


def test_gather_batch_checks_on_the_host():
    c = planes_case(8, 4, 2, 8, 4, 2, seed=4)
    _, _, bank, emp, idx, keep, fb = c["stage"]
    with pytest.raises(IndexError, match="out of range"):
        SL.gather_batch([stage_problem(bank, np.array([0, 8], np.int32), np.ones(2, bool), emp, np.zeros(2, bool))])
    with pytest.raises(ValueError, match="1-D"):
        SL.gather_batch([stage_problem(bank, np.zeros((2, 2), np.int32), np.ones(2, bool), emp, np.zeros(2, bool))])
    with pytest.raises(ValueError, match="keep"):
        SL.gather_batch([stage_problem(bank, idx, keep[:2], emp, fb)])
    with pytest.raises(ValueError, match="1-D slab array"):
        SL.GatherPlan([SL.GatherProblem(bank, emp, idx, keep, fb, "label_vals", False)], [4])
    with pytest.raises(ValueError, match="padding row"):
        SL.GatherPlan([SL.GatherProblem(bank, {**emp, "req": emp["req"][:, :2]}, idx, keep)], [4])
    with pytest.raises(ValueError, match="at most"):
        SL.GatherPlan([problem("stage", c), problem("stage", c)], [4, 4])
