"""The port's resident-state fold on the CPU: `fold_commit_banks` against
`kubernetes_tpu.ops.fold.fold_commit_banks` on duplicate-heavy control
arrays (int16 counts wrapping included), `plan_fold` against
`kubernetes_tpu.commit.fold.plan_fold` for the same pods and mirror
(every array equal; None on a bank overflow), and seeded drains with the
fold plane on whose device banks equal both the host mirror and a fresh
encode of the final cache, with no usage row re-shipped for a folded
commit. Tolerance: exact equality; every value is an integer."""

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
from kubernetes_tpu_torch.ops.fold import fold_commit_banks
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
