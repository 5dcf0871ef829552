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
checks. The row scatter (ops/slab.scatter_batch): several patch problems
in one call, its plain path against index assignment and the reference's
`_row_scatter_fn`, its kernel walked in Python over the host's plan
(every dirty byte written once, every staged byte read once, the fewest
launches past SLAB_MAX_ARRAYS segments), the refusal of overlapping
problems, its layout cache (the row counts computed a call); the mirror's
syncs making one scatter call each and ending equal to a fresh encode (the
walk patching the banks too).
Tolerance: exact equality."""

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


# ---------------------------------------------------------------------------
# the row scatter: several patch problems in one launch (ops/slab.scatter_batch)
# ---------------------------------------------------------------------------

def walk_scatter(problems):
    """csrc/slab.cu's row scatter, launch by launch, CTA by CTA and thread
    by thread, over the host's ScatterPlan of `problems` (CPU slabs,
    patched in place through their numpy views), built as the wrapper
    builds it (the layout of every problem, empty ones too, then the call's
    row counts): the staging buffer as the wrapper fills it
    (ScatterPlan.fill), each CTA's segment by the kernel's
    binary search of first_cta, each thread's words from one division and
    the segment's row and word steps, every field read from the argument
    blocks the launches pass. Returns (the plan, writes per byte of every
    patched array by data pointer, reads per staging-buffer byte)."""
    lanes = [SL.scatter_lanes(p) for p in problems]
    SL.check_disjoint(problems, lanes)
    layout = SL.ScatterLayout(problems, [keys for _, keys in lanes])
    plan = SL.ScatterPlan(problems, [idx.shape[0] for idx, _ in lanes], None, layout)
    buf = np.zeros(plan.nbytes, np.uint8)
    plan.fill(buf, problems, lanes)
    arrays = {p.slab[k].data_ptr(): p.slab[k] for p, (_, keys) in zip(problems, lanes) for k in keys}
    writes = {ptr: np.zeros(t.numel() * t.element_size(), np.int64) for ptr, t in arrays.items()}
    reads = np.zeros(plan.nbytes, np.int64)
    for a in plan.args:  # each launch's argument block
        assert a.n_segments <= SL.MAX_ARRAYS
        for b in range(a.n_ctas):
            lo, hi = 0, a.n_segments - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if a.first_cta[mid] <= b else (lo, mid - 1)
            seg = a.seg[lo]
            dst = arrays[seg.dst].numpy().view(np.uint8).reshape(-1)
            wb, words, rw = 1 << seg.log_word, SL.CHUNK_BYTES >> seg.log_word, seg.row_words
            rows = buf[seg.rows:].view(np.int32)
            chunk = b - a.first_cta[lo]
            end = min((chunk + 1) * words, seg.n_words)
            for t in range(SL.THREADS):
                w = chunk * words + t
                if w >= end:
                    continue
                ln = w // rw
                c = w - ln * rw
                while w < end:
                    at = (int(rows[ln]) * rw + c) * wb
                    dst[at : at + wb] = buf[seg.src + w * wb : seg.src + (w + 1) * wb]
                    writes[seg.dst][at : at + wb] += 1
                    reads[seg.src + w * wb : seg.src + (w + 1) * wb] += 1
                    ln, c = ln + seg.step_rows, c + seg.step_words
                    if c >= rw:
                        c, ln = c - rw, ln + 1
                    w += SL.THREADS
    return plan, writes, reads


def odd_slab(s, seed):
    """Arrays of 3-, 10- and 24-byte rows and one of 1 byte: 1-, 2- and
    8-byte words."""
    rng = np.random.default_rng(seed)
    return {"b3": rng.random((s, 3)) < 0.5, "i16": rng.integers(-(2**15), 2**15, (s, 5), dtype=np.int16),
            "i64": rng.integers(-(2**62), 2**62, (s, 3), dtype=np.int64), "flag": rng.random(s) < 0.5}


def scatter_case(case, seed=21):
    """(host slabs by name, problems over CPU twins, expected twins after
    the patch): each problem takes host truth of its rows."""
    rng = np.random.default_rng(seed)
    pod, _ = seeded_slab(template("stage"), 1024 if case == "config-5-flush" else 64, seed)
    term, _ = seeded_slab(template("terms"), 48, seed + 1)
    odd = odd_slab(40, seed + 2)
    host = {"pod": pod, "term": term, "odd": odd}
    twins = {name: arrays_to_torch({k: np.zeros_like(v) for k, v in h.items()}, "cpu", copy=True)
             for name, h in host.items()}
    pod_keys = tuple(pod)
    if case == "config-5-flush":
        probs = [SL.ScatterProblem(twins["pod"], list(range(0, 1024, 16)), pod)]
    elif case == "mirror-like":  # six patches: two row sets of one dict, counts and metadata of two more
        usage = pod_keys[:3]
        probs = [SL.ScatterProblem(twins["pod"], [1, 5, 9, 63], pod, tuple(k for k in pod_keys if k not in usage)),
                 SL.ScatterProblem(twins["pod"], [0, 2, 62], pod, usage),
                 SL.ScatterProblem(twins["term"], [3, 4, 40], term, ("kind",)),
                 SL.ScatterProblem(twins["term"], [7], term, ("weight", "topo_slot", "ns_ids", "ex_vals")),
                 SL.ScatterProblem(twins["odd"], [0, 39, 17], odd, ("b3", "i16")),
                 SL.ScatterProblem(twins["odd"], [], odd, ("i64", "flag"))]
    elif case == "odd-rows":
        for k, v in odd.items():
            v[[30, 2, 11]] = v[[5, 6, 7]]
        probs = [SL.ScatterProblem(twins["odd"], [30, 2, 11], odd)]
    elif case == "split":  # two pod dicts and a term dict: 35 + 35 + 14 segments, two launches
        twins["pod2"] = arrays_to_torch({k: np.zeros_like(v) for k, v in pod.items()}, "cpu", copy=True)
        host["pod2"] = pod
        probs = [SL.ScatterProblem(twins["pod"], rng.choice(64, 9, replace=False), pod),
                 SL.ScatterProblem(twins["pod2"], [63], pod),
                 SL.ScatterProblem(twins["term"], rng.choice(48, 5, replace=False), term)]
    else:  # "4-byte-aligned-pointer": label_vals (256-byte rows) 4 bytes past a 16-byte boundary
        twins["pod"] = unaligned(twins["pod"], "label_vals")
        probs = [SL.ScatterProblem(twins["pod"], [3, 4, 60], pod)]
    want = {}
    for p in probs:
        name = next(n for n, tw in twins.items() if tw is p.slab)
        keys = p.keys or tuple(p.slab)
        want.setdefault(name, {k: v.clone() for k, v in twins[name].items()})
        idx = np.asarray(p.rows, np.int64)
        for k in keys:
            rows = np.take(p.host[k], idx, axis=0)
            want[name][k][torch.from_numpy(idx)] = torch.from_numpy(np.ascontiguousarray(rows))
    return host, twins, probs, want


SCATTER_CASES = ["config-5-flush", "mirror-like", "odd-rows", "split", "4-byte-aligned-pointer"]


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_walk_covers_every_dirty_byte_once_and_equals_plain(case):
    """csrc/slab.cu's scatter walked in Python over the host's plan: every
    byte of every dirty (array, row) written exactly once and no other,
    every staged byte read exactly once, the row vectors and staged regions
    16-byte aligned, words of the widest width the row bytes and the slab
    pointer allow, the fewest launches of at most MAX_ARRAYS segments; the
    patched slabs equal the plain scatter's (and so index assignment)."""
    _, twins, probs, want = scatter_case(case)
    plan, writes, reads = walk_scatter(probs)
    expect = {}
    for p in probs:
        for k in p.keys or tuple(p.slab):
            v = p.slab[k]
            rb = SL.row_bytes(v)
            cover = expect.setdefault(v.data_ptr(), np.zeros(v.numel() * v.element_size(), np.int64))
            for r in np.asarray(p.rows, np.int64):
                cover[r * rb : (r + 1) * rb] += 1
    for ptr, cover in expect.items():
        assert np.array_equal(writes.get(ptr, np.zeros_like(cover)), cover)
    staged = np.zeros(plan.nbytes, np.int64)
    for _, _, dst, src, rows, lw, rw, n_words, _ in plan.segments:
        assert src % 16 == 0 and rows % 16 == 0 and dst % (1 << lw) == 0
        assert lw == SL._log_word(rw << lw | dst)
        staged[src : src + (n_words << lw)] += 1
    assert np.array_equal(reads, staged) and set(np.unique(reads)) <= {0, 1}
    assert len(plan.args) == -(-len(plan.segments) // SL.MAX_ARRAYS) == (2 if case == "split" else 1)
    if case == "4-byte-aligned-pointer":
        assert {seg[1]: seg[5] for seg in plan.segments}["label_vals"] == 2
    if case == "odd-rows":
        assert {seg[1]: seg[5] for seg in plan.segments} == {"b3": 0, "i16": 1, "i64": 3, "flag": 0}
    for name, w in want.items():
        for k in w:
            assert torch.equal(twins[name][k], w[k]), (name, k)


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_batch_plain_path_equals_index_assignment(case):
    """scatter_batch's CPU path (one index_copy_ per array per problem)
    patches exactly the dirty rows, every problem of the call, launching
    nothing."""
    _, twins, probs, want = scatter_case(case)
    before = SL.scatter_batch.launches
    SL.scatter_batch(probs)
    assert SL.scatter_batch.launches == before
    for name, w in want.items():
        for k in w:
            assert torch.equal(twins[name][k], w[k]), (name, k)


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicates"])
def test_multi_problem_scatter_matches_reference_row_scatter(dup):
    """The mirror's patches as one multi-problem call equal the reference's
    `_row_scatter_fn()` applied patch by patch on the same seeded banks:
    two row sets of one dict (disjoint rows, overlapping arrays), and a
    second dict's counts and metadata; with `dup`, a problem whose repeated
    row carries identical bytes (host truth of its own)."""
    from kubernetes_tpu.state.cache import _row_scatter_fn

    slab, _ = seeded_slab(template("stage"), 50, 31)
    term, _ = seeded_slab(template("terms"), 30, 32)
    host_a, _ = seeded_slab(template("stage"), 50, 33)
    host_b, _ = seeded_slab(template("terms"), 30, 34)
    keys_a = tuple(slab)
    patches = [(slab, host_a, [4, 9, 49], keys_a[:20]), (slab, host_a, [0, 8, 12], keys_a[10:]),
               (term, host_b, [3, 29], ("kind", "weight")), (term, host_b, [3, 5, 6], tuple(term)[5:])]
    twins = {"a": arrays_to_torch(slab, "cpu", copy=True), "b": arrays_to_torch(term, "cpu", copy=True)}
    probs = [SL.ScatterProblem(twins["a" if s is slab else "b"], rows, h, keys) for s, h, rows, keys in patches]
    staged = None
    if dup:
        rows = [20, 21, 20]
        staged = {k: np.take(host_a[k], [1, 2, 1], axis=0) for k in keys_a}
        host_c = {k: v.copy() for k, v in host_a.items()}
        for k, v in host_c.items():
            v[rows] = staged[k]
        probs.append(SL.ScatterProblem(twins["a"], rows, host_c))
    SL.scatter_batch(probs)
    ref = {"a": ref_dict(slab), "b": ref_dict(term)}
    for s, h, rows, keys in patches:
        name = "a" if s is slab else "b"
        upd = {k: jnp.asarray(np.take(h[k], rows, axis=0)) for k in keys}
        ref[name] = _row_scatter_fn()(ref[name], jnp.asarray(np.asarray(rows, np.int32)), upd)
    if dup:
        ref["a"] = _row_scatter_fn()(ref["a"], jnp.asarray(np.asarray([20, 21, 20], np.int32)), ref_dict(staged))
    assert_same(ref["a"], twins["a"])
    assert_same(ref["b"], twins["b"])


def test_scatter_refuses_overlapping_problems():
    """Two problems writing one (array, row) raise before anything is
    written: the launch writes in no order. Disjoint rows of one array, or
    one row of different arrays, pass."""
    host, _ = seeded_slab(template("stage"), 16, 41)
    twin = arrays_to_torch({k: np.zeros_like(v) for k, v in host.items()}, "cpu", copy=True)
    keys = tuple(host)
    with pytest.raises(ValueError, match="same row"):
        SL.scatter_batch([SL.ScatterProblem(twin, [1, 2], host, keys[:3]),
                          SL.ScatterProblem(twin, [2, 3], host, keys[2:5])])
    assert all(not v.any() for v in twin.values())  # refused before any write
    SL.scatter_batch([SL.ScatterProblem(twin, [1, 2], host, keys[:3]), SL.ScatterProblem(twin, [3], host, keys[:3]),
                      SL.ScatterProblem(twin, [1, 2], host, keys[3:])])
    for k, v in twin.items():
        assert np.array_equal(v.numpy()[[1, 2]], host[k][[1, 2]]), k
    with pytest.raises(ValueError, match="same row"):
        SL.scatter_batch([SL.ScatterProblem(twin, [4, 5], host), SL.ScatterProblem(twin, [5], host, ("valid",))])
    with pytest.raises(IndexError, match="out of range"):
        SL.scatter_batch([SL.ScatterProblem(twin, [16], host)])
    with pytest.raises(ValueError, match="no host rows"):
        SL.scatter_batch([SL.ScatterProblem(twin, [0], {}, ("valid",))])
    with pytest.raises(ValueError, match="expected"):
        SL.scatter_batch([SL.ScatterProblem(twin, [0, 1], {k: v[:, None] for k, v in host.items()})])


def test_scatter_layout_is_cached_while_its_tensors_live():
    """One scatter layout per set of patched tensors, whatever the row
    counts (a call computes its offsets and argument blocks from it); it
    leaves the cache when a tensor it writes is freed. Plans of different
    row counts from one layout equal plans built without the cache."""
    host, _ = seeded_slab(template("terms"), 16, 43)
    twin = arrays_to_torch(host, "cpu", copy=True)
    probs = [SL.ScatterProblem(twin, [1, 2], host)]
    keys = [SL.scatter_lanes(probs[0])[1]]
    misses, hits = SL.scatter_batch.layout_misses, SL.scatter_batch.layout_hits
    lay = SL.scatter_layout(probs, keys)
    assert SL.scatter_layout(probs, keys) is lay
    assert (SL.scatter_batch.layout_misses - misses, SL.scatter_batch.layout_hits - hits) == (1, 1)
    for n in (2, 3, 16):
        a, b = SL.ScatterPlan(probs, [n], None, lay), SL.ScatterPlan(probs, [n], keys)
        assert a.segments == b.segments and a.nbytes == b.nbytes
        assert [bytes(x) for x in a.args] == [bytes(x) for x in b.args]
    n = len(SL._SCATTER_LAYOUTS)
    del probs, twin, lay
    import gc

    gc.collect()
    assert len(SL._SCATTER_LAYOUTS) < n


@pytest.mark.parametrize("route", ["plain", "walk"])
def test_mirror_syncs_make_one_scatter_call_and_equal_a_fresh_encode(route, monkeypatch):
    """TensorMirror.device_arrays after random rounds of pod churn (adds
    with host ports and inter-pod terms, removals) and node label updates:
    each sync with dirty rows makes ONE scatter call holding all its
    patches (at most six problems, pairwise disjoint), and the resident
    banks equal the host banks array for array and a fresh encode of the
    cache. With `walk`, csrc/slab.cu's scatter walked in Python patches the
    banks instead of the plain version."""
    import dataclasses

    from kubernetes_tpu_torch.models.clusters import fill_cache, random_cluster
    from kubernetes_tpu_torch.state import cache as cache_mod
    from kubernetes_tpu_torch.state.cache import SchedulerCache, TensorMirror
    from kubernetes_tpu_torch.state.tensors import encode_snapshot

    calls = []
    real = cache_mod.scatter_batch

    def spy(problems):
        live = [p for p in problems if len(p.rows)]
        calls.append(len(live))
        if route == "walk":
            walk_scatter(problems)
        else:
            real(problems)

    monkeypatch.setattr(cache_mod, "scatter_batch", spy)
    nodes, existing, pending = random_cluster(17, 24, 90, 40, pending_ports=True, topology=True, interpod=True,
                                              pending_affinity=True)
    cache = SchedulerCache()
    fill_cache(cache, nodes, existing)
    m = TensorMirror(cache, device="cpu")
    m.sync()
    m.device_arrays()
    assert calls == []  # the first call uploads whole
    rng = np.random.default_rng(17)
    placed = []
    for rnd in range(6):
        for p in pending[rnd * 15 : (rnd + 1) * 15]:
            q = p.with_node(nodes[int(rng.integers(len(nodes)))].name)
            cache.add_pod(q)
            placed.append(q)
        for q in [placed.pop(int(rng.integers(len(placed)))) for _ in range(4)]:
            cache.remove_pod(q)
        if rnd % 2:
            n = nodes[int(rng.integers(len(nodes)))]
            nodes[nodes.index(n)] = n = dataclasses.replace(n, labels={**n.labels, "churn": f"r{rnd}"})
            cache.update_node(n)
        rebuilt = m.sync()
        dn, de, dp = ({k: v.numpy() for k, v in d.items()} for d in m.device_arrays())
        if not rebuilt:
            assert calls[-1] <= 6
        for dev, host in ((dn, m.nodes.arrays()), (de, m.eps.arrays()), (dp, m.pats.arrays())):
            for k, h in host.items():
                assert np.array_equal(dev[k], h), (rnd, k)
        fresh_n, _, rows = encode_snapshot(cache.snapshot, vocab=m.vocab)
        assert rows == m.row_of
        for k, h in fresh_n.arrays().items():
            if k != "image_scaled":
                assert np.array_equal(dn[k], h), (rnd, k)
    assert len(calls) >= 4 and max(calls) >= 3  # one call a sync, several patches in it


def test_scatter_and_score_gather_blocks_fit_the_parameter_limit():
    """The ctypes mirrors of the scatter's and the score-row gather's
    argument blocks against their sources' defines, each below the 4 KB
    kernel-parameter limit every CUDA toolkit takes (no larger limit, so no
    toolkit version is needed beyond the rest of the port's)."""
    import ctypes

    from kubernetes_tpu_torch.ops import pipeline as PP

    with open(os.path.join(CSRC, "slab.cu")) as f:
        slab_src = f.read()
    with open(os.path.join(CSRC, "gather.cu")) as f:
        gather_src = f.read()
    slab_defs = dict(re.findall(r"#define (\w+) (\d+)", slab_src))
    gather_defs = dict(re.findall(r"#define (\w+) (\d+)", gather_src))
    assert int(slab_defs["SLAB_MAX_ARRAYS"]) == SL.MAX_ARRAYS >= 46  # a mirror sync's six patches
    assert int(gather_defs["SCORE_GATHER_THREADS"]) == PP.GATHER_THREADS
    assert int(gather_defs["SCORE_GATHER_MAX_WORDS"]) == PP.GATHER_MAX_WORDS == 4
    assert int(gather_defs["SCORE_GATHER_MIN_CTAS"]) == PP.GATHER_MIN_CTAS
    assert int(gather_defs["SCORE_GATHER_MAX_INLINE"]) == PP.GATHER_MAX_INLINE
    assert ctypes.sizeof(SL.ScatterSeg) == 40 and ctypes.sizeof(SL.ScatterArgs) < 4096
    assert ctypes.sizeof(PP.GatherArgs) < 4096
    assert "struct SlabArgs" not in slab_src and "pack_rows" not in slab_src
