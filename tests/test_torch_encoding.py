"""The port's encoder is the state carried across: for the same seeded
cluster, its NodeBank / SigBank / PodBatch arrays and interned constants
equal the reference's key for key, dtype included (exact equality), and
its mirror keeps the node, signature and pattern banks, and their device
copies, equal to the reference's through cache events: node adds and
removals, bulk pod adds, removes, a node update, a SigOverflow rebuild
and (on a cluster whose pods carry pod (anti-)affinity) a PatternOverflow
rebuild."""

import numpy as np
import pytest

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import filters as RF
from kubernetes_tpu.oracle.nodeinfo import Snapshot as RSnapshot
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.cache import TensorMirror as RMirror
from kubernetes_tpu.state.tensors import PodBatch as RPodBatch
from kubernetes_tpu.state.tensors import encode_snapshot as r_encode
from kubernetes_tpu.state.tensors import spec_key as r_spec_key

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import fill_cache, random_cluster, random_selectors
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot as PSnapshot
from kubernetes_tpu_torch.state.cache import SchedulerCache as PCache
from kubernetes_tpu_torch.state.cache import TensorMirror as PMirror
from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
from kubernetes_tpu_torch.state.tensors import dedup_specs
from kubernetes_tpu_torch.state.tensors import encode_snapshot as p_encode


def assert_same_arrays(ref, port):
    assert ref.keys() == port.keys(), sorted(set(ref) ^ set(port))
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshot_and_batch_encode_key_for_key(seed):
    kw = dict(n_nodes=24 + seed * 9, n_pending=40, n_existing=30, overflow_nodes=seed % 2,
              pending_ports=True)
    rn, re, rp = random_cluster(seed, t=RT, **kw)
    pn, pe, pp = random_cluster(seed, t=PT, **kw)
    rbank, rsigs, rrows = r_encode(RSnapshot(rn, re))
    pbank, psigs, prows = p_encode(PSnapshot(pn, pe))
    assert rrows == prows
    assert_same_arrays(rbank.arrays(), pbank.arrays())
    assert_same_arrays(rsigs.arrays(), psigs.arrays())
    rb, pb = RPodBatch(rbank.vocab, 64), PPodBatch(pbank.vocab, 64)
    for i, (a, b) in enumerate(zip(rp, pp)):
        rb.set_pod(i, a)
        pb.set_pod(i, b)
    assert_same_arrays(rb.arrays(), pb.arrays())
    assert {k: int(v) for k, v in RF.make_ids(rbank.vocab).items()} == PF.make_ids(pbank.vocab)


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("with_selectors", [False, True], ids=["plain", "selectors"])
def test_spec_dedup_groups_pods_like_the_reference_key(seed, with_selectors):
    """dedup_specs gives the spec rows the reference driver's spec_key
    dedup gives: first-seen order, one row per distinct key — with
    spreading selectors in the key, so replicas behind different selectors
    never share a row."""
    rn, re, rp = random_cluster(seed, 12, 10, 80, t=RT, topology=True)
    _, _, pp = random_cluster(seed, 12, 10, 80, t=PT, topology=True)
    pp = pp + pp[:20]  # replicas of earlier specs
    rp = rp + rp[:20]
    r_sel = p_sel = None
    if with_selectors:
        # the same spec behind different selectors: every 3rd pod's list
        # gains a selector
        rfn, pfn = random_selectors(RT), random_selectors(PT)
        r_sel = {id(p): rfn(p) + ([RT.LabelSelector()] if i % 3 == 0 else []) for i, p in enumerate(rp)}
        p_sel = {id(p): pfn(p) + ([PT.LabelSelector()] if i % 3 == 0 else []) for i, p in enumerate(pp)}
    index, r_sig = {}, []
    for p in rp:
        key = r_spec_key(p, r_sel[id(p)] if r_sel else None)
        r_sig.append(index.setdefault(key, len(index)))
    reps, sig = dedup_specs(pp, p_sel)
    assert sig == r_sig
    assert len(reps) == len(index) < len(pp)
    assert [p.name for p in reps] == [rp[r_sig.index(u)].name for u in range(len(reps))]


def test_key_slot_growth_reencodes_like_the_reference():
    """A 70th label key overflows K=64: both encoders grow and re-encode."""
    def build(t):
        nodes = [t.Node(name=f"n{i}", labels={f"k{j}": str(j) for j in range(i * 10, i * 10 + 10)},
                        allocatable={t.RESOURCE_PODS: t.Quantity.parse(5)}) for i in range(7)]
        return nodes
    rbank, _, _ = r_encode(RSnapshot(build(RT)))
    pbank, _, _ = p_encode(PSnapshot(build(PT)))
    assert pbank.key_capacity == rbank.key_capacity == 128
    assert_same_arrays(rbank.arrays(), pbank.arrays())


def _mirror_events(cache_cls, mirror_cls, t, seed, interpod=False, **mirror_kw):
    nodes, existing, pending = random_cluster(seed, 20, 40, 25, t=t, topology=True, interpod=interpod)
    cache = cache_cls()
    fill_cache(cache, nodes[:18], existing[:10])  # 18 nodes: a 32-row bank
    mirror = mirror_cls(cache, **mirror_kw)
    mirror._min_sigs = 16  # small signature bank: the adds below overflow it
    if interpod:
        mirror._min_pats = 4  # 16 pattern rows: the pending pods' terms overflow them
    mirror._rebuild()
    mirror.rebuild_count = 0
    yield mirror
    # node adds, pod assumes/forgets, a removal and a node update
    for n in nodes[18:]:
        cache.add_node(n)
    for p in pending[:12]:
        cache.assume_pod(p.with_node(nodes[int(p.name[1:]) % 20].name))
    cache.forget_pod(pending[3].with_node(nodes[3 % 20].name))
    cache.remove_pod(existing[2])
    cache.remove_node(nodes[4].name)
    changed = t.Node(name=nodes[7].name, labels={"tier": "z"}, allocatable=dict(nodes[7].allocatable))
    cache.update_node(changed)
    mirror.sync()
    yield mirror
    # bulk adds only (the common commit), then removes of some of them
    for p in pending[12:24]:
        cache.assume_pod(p.with_node(nodes[(int(p.name[1:]) * 7) % 20].name))
    mirror.sync()
    yield mirror
    for p in pending[12:16]:
        cache.forget_pod(p.with_node(nodes[(int(p.name[1:]) * 7) % 20].name))
    mirror.sync()
    yield mirror
    # more distinct signatures than the 16 slots hold: SigOverflow rebuild
    for i, p in enumerate(pending[24:40]):
        q = p.with_node(nodes[i % 20].name)
        q.labels = {**q.labels, "uniq": f"u{i}"}
        cache.assume_pod(q)
    mirror.sync()
    yield mirror


def _device_eps(mirror):
    """The port mirror's device copies of the node and signature banks as
    numpy dicts."""
    na, ea, _ = mirror.device_arrays()
    return {k: v.numpy() for k, v in na.items()}, {k: v.numpy() for k, v in ea.items()}


@pytest.mark.parametrize("seed", [5, 6])
def test_mirror_tracks_cache_events_like_the_reference(seed):
    ref = _mirror_events(RCache, RMirror, RT, seed)
    port = _mirror_events(PCache, PMirror, PT, seed, device="cpu")
    for rm, pm in zip(ref, port):
        assert rm.row_of == pm.row_of
        host = pm.nodes.arrays()
        assert_same_arrays(rm.nodes.arrays(), host)
        assert_same_arrays(rm.eps.arrays(), pm.eps.arrays())
        assert rm.rebuild_count == pm.rebuild_count
        # the resident copies, patched by dirty rows, equal host truth
        dev_n, dev_e = _device_eps(pm)
        assert_same_arrays(host, dev_n)
        assert_same_arrays(pm.eps.arrays(), dev_e)
    # the run patched rows into the resident copy; only the signature
    # overflow rebuilt the banks (at 4x the slots)
    assert pm.rows_shipped > 0 and pm.rebuild_count == 1
    assert pm.eps.capacity == 64


@pytest.mark.parametrize("seed", [5, 7])
def test_mirror_pattern_bank_tracks_cache_events_like_the_reference(seed):
    """The PatternBank row for row (free rows taken from 0 upward), through
    a fresh build, single-pod adds and removes of pods with affinity, bulk
    adds, a node removal and a PatternOverflow rebuild; its device copy
    (counts patched by node rows, metadata by pattern rows) equals host
    truth after each step."""
    ref = _mirror_events(RCache, RMirror, RT, seed, interpod=True)
    port = _mirror_events(PCache, PMirror, PT, seed, interpod=True, device="cpu")
    for rm, pm in zip(ref, port):
        assert rm.row_of == pm.row_of
        assert_same_arrays(rm.nodes.arrays(), pm.nodes.arrays())
        assert_same_arrays(rm.eps.arrays(), pm.eps.arrays())
        assert_same_arrays(rm.pats.arrays(), pm.pats.arrays())
        assert rm.pats.overflow_rows == pm.pats.overflow_rows
        assert rm.rebuild_count == pm.rebuild_count
        _, _, dev_x = pm.device_arrays()
        assert_same_arrays(pm.pats.arrays(), {k: v.numpy() for k, v in dev_x.items()})
    # the 16-row bank overflowed and was rebuilt bigger, as the reference's
    assert pm.pats.capacity == rm.pats.capacity > 16
    assert int(pm.pats.valid.sum()) > 16


def test_sig_bank_after_drain_equals_a_fresh_encode():
    """The incremental signature path (bulk adds through apply_adds_bulk)
    ends where a fresh encode of the final cache starts: the same counts,
    valid rows and label rows at each signature's row."""
    nodes, existing, pending = random_cluster(8, 16, 60, 20, t=PT, topology=True)
    cache = PCache()
    fill_cache(cache, nodes, existing)
    mirror = PMirror(cache, device="cpu")
    mirror.device_arrays()
    for i, p in enumerate(pending):
        cache.assume_pod(p.with_node(nodes[i % 16].name))
    mirror.sync()
    _, dev_e = _device_eps(mirror)
    _, fresh, rows = p_encode(cache.snapshot, vocab=mirror.vocab)
    assert rows == mirror.row_of
    # signature rows are allocated in another order: compare by content
    def by_key(e):
        out = {}
        for s in np.flatnonzero(e["valid"]):
            key = (e["label_vals"][s].tobytes(), int(e["ns_id"][s]), bool(e["deleting"][s]))
            out[key] = e["counts"][:, s].copy()
        return out
    got, want = by_key(dev_e), by_key(fresh.arrays())
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k])
