"""The port's resident-state fold on the CPU: `fold_commit_banks` against
`kubernetes_tpu.ops.fold.fold_commit_banks` on duplicate-heavy control
arrays (int16 counts wrapping included), `plan_fold` against
`kubernetes_tpu.commit.fold.plan_fold` for the same pods and mirror
(every array equal; None on a bank overflow), and seeded drains with the
fold plane on whose device banks equal both the host mirror and a fresh
encode of the final cache, with no usage row re-shipped for a folded
commit. Also the card kernel's algorithm (csrc/fold.cu) walked in numpy:
its element layout over the packed program (`fold_control`: the live
lanes in one buffer, equal to the program's arrays unpacked), and its
one-round-trip int16 add with the carry correction applied in seeded
random interleavings, against the plain version and the JAX reference.
Tolerance: exact equality; every value is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.commit.fold import plan_fold as r_plan_fold
from kubernetes_tpu.ops.fold import fold_commit_banks as r_fold
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.cache import TensorMirror as RMirror

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.commit.fold import plan_fold
from kubernetes_tpu_torch.models.clusters import bench_config3, bench_config4, fill_cache, random_cluster
from kubernetes_tpu_torch.ops.fold import (fold_commit_banks, fold_commit_banks_plain, fold_commit_packed,
                                           fold_commit_sharded_plain, fold_control)
from kubernetes_tpu_torch.scheduler.driver import Scheduler
from kubernetes_tpu_torch.state.cache import SchedulerCache, TensorMirror
from kubernetes_tpu_torch.state.queue import PriorityQueue
from kubernetes_tpu_torch.state.tensors import encode_snapshot
from kubernetes_tpu_torch.state.terms import PatternBank

BANKS = ("requested", "nonzero_req", "pod_count", "sig_counts", "pat_counts")
PROGRAM = ("rows", "req", "nz", "cnt", "sig", "pat_row", "pat_col", "pat_cnt")


def _fold_inputs(seed):
    """Banks near the int16 edges and control arrays where most lanes hit
    a few cells; sentinel lanes (row N, signature S, pattern PT) pad."""
    rng = np.random.default_rng(seed)
    n, r, s, pt, b, t = 12, 5, 9, 6, 96, 40
    banks = {
        "requested": rng.integers(0, 10**9, (n, r)).astype(np.int64),
        "nonzero_req": rng.integers(0, 10**9, (n, 2)).astype(np.int64),
        "pod_count": rng.integers(0, 100, n).astype(np.int32),
        "sig_counts": rng.choice(np.array([0, 3, 32760, -32765], np.int16), (n, s)),
        "pat_counts": rng.choice(np.array([0, 1, 32766], np.int16), (n, pt)),
    }
    live = rng.random(b) < 0.85
    ctl = {
        "rows": np.where(live, rng.integers(0, 3, b), n).astype(np.int32),
        "req": rng.integers(0, 5000, (b, r)).astype(np.int64),
        "nz": rng.integers(0, 5000, (b, 2)).astype(np.int64),
        "cnt": live.astype(np.int32),
        "sig": np.where(live & (rng.random(b) < 0.9), rng.integers(0, 2, b), s).astype(np.int32),
    }
    plive = rng.random(t) < 0.8
    ctl.update(
        pat_row=np.where(plive, rng.integers(0, 2, t), n).astype(np.int32),
        pat_col=np.where(plive & (rng.random(t) < 0.9), rng.integers(0, 3, t), pt).astype(np.int32),
        pat_cnt=plive.astype(np.int16),
    )
    return banks, ctl


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_commit_banks_matches_reference(seed):
    banks, ctl = _fold_inputs(seed)
    want = r_fold(*(jnp.asarray(banks[k]) for k in BANKS), *(jnp.asarray(ctl[k]) for k in PROGRAM))
    tb = {k: torch.from_numpy(v.copy()) for k, v in banks.items()}
    got = fold_commit_banks(*(tb[k] for k in BANKS), *(torch.from_numpy(ctl[k]) for k in PROGRAM))
    for k, w, g in zip(BANKS, want, got):
        assert g is tb[k]  # in place
        assert g.dtype == torch.from_numpy(np.array(w)).dtype and np.array_equal(g.numpy(), np.asarray(w)), k
    # duplicates really collided, and some int16 cell wrapped
    assert np.bincount(ctl["rows"]).max() > 20
    assert (np.asarray(want[3]) < banks["sig_counts"]).any()


def _mirrors(workload):
    """The same cluster in both packages' mirrors, and the pending pods
    with the node rows they are folded onto."""
    out = []
    for pkg, t in (("ref", RT), ("port", PT)):
        if workload == "config4":
            (nodes, pending), existing = bench_config4(24, 120, t=t), []
        elif workload == "many-sigs":  # more distinct signatures than the bank holds
            nodes, pending, _ = bench_config3(16, 300, t=t)
            for i, p in enumerate(pending):
                p.labels = {"uniq": f"u{i}"}
            existing = []
        else:
            nodes, existing, pending = random_cluster(5, 30, 40, 60, t=t, topology=True, interpod=True,
                                                      pending_affinity=True)
        cache = RCache() if pkg == "ref" else SchedulerCache()
        fill_cache(cache, nodes, existing)
        mirror = RMirror(cache) if pkg == "ref" else TensorMirror(cache, "cpu")
        rows = sorted(mirror.row_of.values())
        pairs = [(p, rows[(7 * i) % len(rows)]) for i, p in enumerate(pending)]
        out.append((mirror, pairs))
    return out


@pytest.mark.parametrize("workload", ["config4", "random", "many-sigs"])
def test_plan_fold_matches_reference(workload):
    (rm, rpairs), (pm, ppairs) = _mirrors(workload)
    bucket = 512
    want = r_plan_fold(rm, rpairs, bucket, 16)
    got = plan_fold(pm, ppairs, bucket, 16)
    if workload == "many-sigs":
        assert want is None and got is None
        return
    assert want is not None and got is not None
    for k in PROGRAM:
        assert np.array_equal(getattr(got, k), getattr(want, k)) and getattr(got, k).dtype == getattr(want, k).dtype, k
    assert got.pods == want.pods == len(ppairs) and got.pat_bucket == want.pat_bucket
    assert (got.pat_cnt > 0).sum() > 0  # affinity pods carried pattern triples
    # the same rows were pre-interned (their metadata ships as dirty rows)
    assert pm.eps.dirty_sig_rows == rm.eps.dirty_sig_rows
    assert pm.pats.dirty_pattern_rows == rm.pats.dirty_pattern_rows


def _drain(workload):
    if workload == "config4":
        (nodes, pending), existing, fn = bench_config4(40, 400), [], None
    elif workload == "config3":
        nodes, pending, fn = bench_config3(40, 400, services=True)
        existing = []
    else:
        nodes, existing, pending = random_cluster(9, 60, 300, 80, pins=False, topology=True, interpod=True,
                                                  pending_affinity=False)
        fn = None
    cache, queue = SchedulerCache(), PriorityQueue()
    fill_cache(cache, nodes, existing)
    for p in pending:
        queue.add(p)
    # pods that fit nowhere stay unschedulable: the random cluster's
    # term-carrying preemptors would need the host oracle's victim search
    sched = Scheduler(cache, queue, batch_size=96, deterministic=True, seed=1, device="cpu",
                      enable_preemption=False)
    if fn is not None:
        sched.set_spread_selectors_fn(fn)
    res = sched.run_until_empty()
    sched.wait_for_binds()
    sched.close()
    return sched, res


def _by_content(bank, meta):
    return {b"".join(bank[k][r].tobytes() for k in meta): bank["counts"][:, r] for r in bank["valid"].nonzero()[0]}


@pytest.mark.parametrize("workload", ["config4", "config3", "random"])
def test_folded_drain_banks_equal_fresh_encode(workload):
    sched, res = _drain(workload)
    m = sched.mirror
    assert res.scheduled > 100
    st = sched.stats
    if workload == "random":
        # its pending pods' terms outgrow the 32-row pattern bank: a batch's
        # plan overflows, its assumes ship from the host and the next sync
        # rebuilds the banks bigger (the reference's host route)
        assert st["fold_overflow_batches"] > 0 and m.rebuild_count > 0
    else:
        # every placed pod was folded, and no usage row was re-shipped
        assert st["fold_overflow_batches"] == 0 and st["fold_pods"] == res.scheduled
        assert st["fold_batches"] == st["batches"]
    m.sync()
    dn, de, dp = ({k: v.numpy() for k, v in d.items()} for d in m.device_arrays())
    if workload != "random":
        assert m.rows_shipped == 0
    # device == host mirror, array for array
    for dev, host in ((dn, m.nodes.arrays()), (de, m.eps.arrays()), (dp, m.pats.arrays())):
        for k, h in host.items():
            assert np.array_equal(dev[k], h), k
    # device == a fresh encode of the final cache
    fresh_n, fresh_e, rows = encode_snapshot(sched.cache.snapshot, vocab=m.vocab)
    assert rows == m.row_of
    for k in ("requested", "nonzero_req", "pod_count"):
        assert np.array_equal(dn[k], fresh_n.arrays()[k]), k
    sig_meta = ("label_vals", "ns_id", "deleting")
    assert _by_content(de, sig_meta).keys() == _by_content(fresh_e.arrays(), sig_meta).keys()
    want = _by_content(fresh_e.arrays(), sig_meta)
    assert all(np.array_equal(c, want[k]) for k, c in _by_content(de, sig_meta).items())
    fresh_p = PatternBank(m.vocab, m.pats.capacity, m.nodes.capacity)
    for name, ni in sched.cache.snapshot.node_infos.items():
        fresh_p.encode_node(m.row_of[name], ni.pods_with_affinity())
    pat_meta = ("kind", "topo_slot", "weight", "ns_any", "ns_ids", "has_selector", "ml_slot", "ml_val", "ex_op",
                "ex_slot", "ex_vals")
    want_p = _by_content(fresh_p.arrays(), pat_meta)
    got_p = _by_content(dp, pat_meta)
    assert got_p.keys() == want_p.keys()
    assert all(np.array_equal(c, want_p[k]) for k, c in got_p.items())
    if workload != "config3":
        assert len(want_p) > 0


# ---------------------------------------------------------------------------
# csrc/fold.cu's algorithm: one thread a bank element over the packed program
# ---------------------------------------------------------------------------


def _carry_inputs(seed):
    """_fold_inputs with the int16 cells spread over their whole range and
    counts of both signs (-3 to 4): cells carry out of the low half and wrap
    the high half, adds cancel, a lane adds 0."""
    banks, ctl = _fold_inputs(seed)
    rng = np.random.default_rng(100 + seed)
    for k in ("sig_counts", "pat_counts"):
        banks[k] = rng.integers(-32768, 32768, banks[k].shape).astype(np.int16)
    ctl["cnt"] = np.where(ctl["rows"] < banks["requested"].shape[0], rng.integers(-3, 5, ctl["cnt"].shape), 0)
    ctl["cnt"] = ctl["cnt"].astype(np.int32)
    ctl["pat_cnt"] = np.where(ctl["pat_row"] < banks["requested"].shape[0], rng.integers(-3, 5, ctl["pat_cnt"].shape),
                              0).astype(np.int16)
    return banks, ctl


def fold_walk(banks, ctl, rng=None):
    """csrc/fold.cu's commit fold (`fold_commit_kernel`, which the sharded
    commit launches too: on one card a row in [0, N) lies in exactly one
    shard and adds at the same address) over the packed program `ctl`:
    element by element as the kernel lays them out, reading only the buffer's arrays
    (the live lanes; no padding is in it), each element's add as the atomic
    the kernel issues. The atomics run in the kernel's order, or with `rng`
    in a random interleaving in which each low-half int16 add's carry
    correction is queued when its add returns and runs at a random later
    point. Returns (banks, the elements read, the carry corrections
    issued)."""
    a = {k: v.numpy() for k, v in ctl.arrays().items()}
    out = {k: v.copy() for k, v in banks.items()}
    n, r = out["requested"].shape
    s_, pt = out["sig_counts"].shape[1], out["pat_counts"].shape[1]
    words = {k: np.concatenate([out[k].reshape(-1), np.zeros(out[k].size % 2, np.int16)]).view(np.uint32)
             for k in ("sig_counts", "pat_counts")}
    flat64 = {k: out[k].reshape(-1).view(np.uint64) for k in ("requested", "nonzero_req")}
    ops, seen, carries = [], [], 0
    b, t, w = ctl.b, ctl.t, r + 2
    for e in range(b * (r + 4) + t):
        seen.append(e)
        if e < b * w:
            i, c = divmod(e, w)
            v = int(a["req"][i, c] if c < r else a["nz"][i, c - r])
            row = int(a["rows"][i])
            if 0 <= row < n and v != 0:
                ops.append(("i64", "requested", row * r + c, v) if c < r else
                           ("i64", "nonzero_req", row * 2 + c - r, v))
            continue
        e -= b * w
        if e < 2 * b:
            i = e if e < b else e - b
            row, c = int(a["rows"][i]), int(a["cnt"][i])
            if e < b:
                if 0 <= row < n and c != 0:
                    ops.append(("i32", "pod_count", row, c))
                continue
            sg = int(a["sig"][i])
            if 0 <= row < n and 0 <= sg < s_:
                ops.append(("i16", "sig_counts", row * s_ + sg, c))
            continue
        j = e - 2 * b
        row, col, c = int(a["pat_row"][j]), int(a["pat_col"][j]), int(a["pat_cnt"][j])
        if 0 <= row < n and 0 <= col < pt:
            ops.append(("i16", "pat_counts", row * pt + col, c))
    pending = list(ops)
    while pending:
        kind, name, cell, v = pending.pop(int(rng.integers(len(pending))) if rng is not None else 0)
        if kind == "i64":
            flat64[name][cell] = np.uint64((int(flat64[name][cell]) + v) % 2**64)
        elif kind == "i32":
            out[name][cell] = np.int32((int(out[name][cell]) + v + 2**31) % 2**32 - 2**31)
        elif kind == "u32":  # a fire-and-forget add on a word (high half, carry correction)
            words[name][cell] = np.uint32((int(words[name][cell]) + v) % 2**32)
        else:  # an int16 cell: one 32-bit atomic add on its aligned word
            h = v & 0xFFFF
            if h == 0:
                continue
            word, high = divmod(cell, 2)
            if high:
                pending.append(("u32", name, word, h << 16))
                continue
            old = int(words[name][word])
            words[name][word] = np.uint32((old + h) % 2**32)
            if (old & 0xFFFF) + h > 0xFFFF:  # the carry left the low half: take it back out of the high half
                carries += 1
                pending.insert(int(rng.integers(len(pending) + 1)) if rng is not None else 0,
                               ("u32", name, word, 0xFFFF0000))
    for k in ("sig_counts", "pat_counts"):
        out[k] = words[k].view(np.int16)[:out[k].size].reshape(out[k].shape)
    return out, seen, carries


def _reference(banks, ctl_arrays):
    return [np.asarray(x) for x in r_fold(*(jnp.asarray(banks[k]) for k in BANKS),
                                          *(jnp.asarray(ctl_arrays[k]) for k in PROGRAM))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_control_unpacks_to_the_program(seed):
    """fold_control packs a FoldProgram's live lanes and triples (the
    padding tails stay behind) at 16-byte-aligned offsets of one buffer,
    and the buffer unpacked on the CPU equals the program's arrays."""
    (rm, rpairs), (pm, ppairs) = _mirrors(["config4", "random", "config4"][seed])
    prog = plan_fold(pm, ppairs, 512, 16)
    arrays = {k: getattr(prog, k) for k in PROGRAM}
    ctl = fold_control(**arrays, n=pm.nodes.capacity)
    t_live = int((prog.pat_cnt != 0).sum())
    assert (ctl.b, ctl.t, ctl.r) == (prog.pods, t_live, prog.req.shape[1])
    assert ctl.b < prog.rows.shape[0] and ctl.t <= prog.pat_bucket
    assert all(off % 16 == 0 for off in ctl.offsets.values()) and ctl.buf.dtype == torch.uint8
    for k, got in ctl.arrays().items():
        want = arrays[k][:ctl.b if k in ("rows", "req", "nz", "cnt", "sig") else ctl.t]
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), k
    # what stays behind is padding: the sentinels and zero counts
    assert (prog.rows[ctl.b:] == pm.nodes.capacity).all() and (prog.cnt[ctl.b:] == 0).all()
    assert (prog.pat_cnt[ctl.t:] == 0).all()


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_element_walk_reads_each_element_once_and_equals_plain(seed, shards):
    """The kernel's element layout over the packed program: every (lane,
    column) element — R request columns, two non-zero columns, the pod
    count, the signature cell — and every pattern triple taken once (on S
    shards too: the sharded commit launches the same grid), nothing
    read past the live lanes (the buffer holds no padding), the result
    equal to the plain version on the padded program, the packed plain
    path and the JAX reference."""
    banks, ctl_np = _fold_inputs(seed)
    n = banks["requested"].shape[0]
    ctl = fold_control(**ctl_np, n=n)
    assert ctl.b < ctl_np["rows"].shape[0] or (ctl_np["rows"][-1] < n)
    got, seen, _ = fold_walk(banks, ctl)
    r = banks["requested"].shape[1]
    assert seen == list(range(ctl.b * (r + 4) + ctl.t))
    tb = {k: torch.from_numpy(v.copy()) for k, v in banks.items()}
    if shards == 1:
        want = fold_commit_banks_plain(*(tb[k] for k in BANKS), *(torch.from_numpy(ctl_np[k]) for k in PROGRAM))
    else:
        want = fold_commit_sharded_plain(shards, *(tb[k] for k in BANKS),
                                         *(torch.from_numpy(ctl_np[k]) for k in PROGRAM))
    packed = {k: torch.from_numpy(v.copy()) for k, v in banks.items()}
    fold_commit_packed(*(packed[k] for k in BANKS), ctl, shards=None if shards == 1 else shards)
    for k, w, ref in zip(BANKS, want, _reference(banks, ctl_np)):
        assert np.array_equal(got[k], w.numpy()) and np.array_equal(packed[k].numpy(), ref), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_round_trip_int16_add_is_exact_in_any_order(seed):
    """The int16 add (one 32-bit atomic add on the aligned word, a
    carry correction queued when the low half carried) in several seeded
    random interleavings, on cells across the whole int16 range taking
    counts of both signs, duplicates in both halves of a word: every order
    gives the plain version's banks and the JAX reference's."""
    banks, ctl_np = _carry_inputs(seed)
    n = banks["requested"].shape[0]
    ctl = fold_control(**ctl_np, n=n)
    tb = {k: torch.from_numpy(v.copy()) for k, v in banks.items()}
    want = [x.numpy() for x in fold_commit_banks_plain(*(tb[k] for k in BANKS),
                                                        *(torch.from_numpy(ctl_np[k]) for k in PROGRAM))]
    ref = _reference(banks, ctl_np)
    for w, rf in zip(want, ref):
        assert np.array_equal(w, rf)
    # the cases the scheme must get right happened: low halves carried, both
    # halves of a word were hit, negative counts
    live = ctl_np["rows"] < n
    flat = (ctl_np["rows"][live] * banks["sig_counts"].shape[1] + ctl_np["sig"][live])
    assert (np.bincount(flat % 2) > 0).all() and (ctl_np["cnt"][live] < 0).any()
    for order in range(4):
        got, _, carries = fold_walk(banks, ctl, rng=np.random.default_rng(1000 * seed + order))
        assert carries > 0  # some low half carried and took its correction
        for k, w in zip(BANKS, want):
            assert np.array_equal(got[k], w), (k, order)
