"""Preemption on the CPU: the port's `preempt_batch` (plain version)
against `kubernetes_tpu.ops.preempt.preempt_batch` on seeded padded arrays
that reach every branch of the scan (PDB violators, fits_free, preemptors
requesting nothing, extended-resource slots, nominee charges, ties decided
at each of the six pick keys, padded rows, 64 victim slots) and on runs of
repeated specs, and a Python walk of csrc/preempt.cu's algorithm (the
hoisted step facts, the nominee-adjusted carry, 64-bit victim masks, the
per-node cache re-evaluated only where the carry or the spec changed, the
packed keys and the tournament tree kept leaf by leaf) against the plain
version, with its reuse counts, and the walk's memory layout;
`fold_usage` against the JAX one (duplicate rows, sentinel pads) and its
exact inverse; the queue's nominated index, `batch_preempt_device`,
`_select_victims_fast`, `pick_one_node_for_preemption` and `preempt`
against the reference package on the same clusters; and a term-carrying
preemptor's slow victim search. Tolerance: exact equality; every value is
an integer."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops.fold import fold_usage as r_fold_usage
from kubernetes_tpu.ops.preempt import preempt_batch as r_preempt_batch
from kubernetes_tpu.oracle.nodeinfo import Snapshot as RSnapshot
from kubernetes_tpu.scheduler import preemption as RP
from kubernetes_tpu.state.queue import PriorityQueue as RQueue

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.models.clusters import random_preempt_arrays, random_preemption_cluster
from kubernetes_tpu_torch.ops.fold import fold_usage
from kubernetes_tpu_torch.ops.preempt import preempt_batch, preempt_batch_plain
from kubernetes_tpu_torch.oracle.nodeinfo import Snapshot as PSnapshot
from kubernetes_tpu_torch.scheduler import preemption as PP
from kubernetes_tpu_torch.state.queue import PriorityQueue

# (P, N, V, R): the default shape, 64 victim slots, 16 resource slots
SHAPES = {"base": (48, 40, 8, 8), "v64": (24, 20, 64, 8), "r16": (20, 16, 8, 16)}


def _arrays(seed, shape, mode="iid"):
    p, n, v, r = SHAPES[shape]
    return random_preempt_arrays(seed, p, n, v, r, runs=mode == "runs")


def _torch(a):
    return {k: torch.from_numpy(x.copy()) for k, x in a.items()}


@pytest.mark.parametrize("mode", ["iid", "runs"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_batch_matches_reference(seed, shape, mode):
    a = _arrays(seed, shape, mode)
    want = r_preempt_batch(**{k: jnp.asarray(x) for k, x in a.items()})
    got = preempt_batch(**_torch(a))  # CPU tensors: the plain version
    for w, g in zip(want, got):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype and np.array_equal(g.numpy(), w)
    chosen = got[0].numpy()
    assert (chosen >= 0).sum() >= 3  # preemptions happened
    assert chosen[-5:].max() == -1  # padded preemptors never pick
    assert (chosen < SHAPES[shape][1] - 4).all()  # nor do padded nodes get picked


_NONE = (2**64 - 1,) * 3


def _pack(viol, maxprio, psum, cnt, negts, row):
    """csrc/preempt.cu's pick key: three 64-bit words whose unsigned order is
    the order of the tuple (viol, maxprio, psum, cnt, negts, row)."""
    mp, ps, nt = maxprio + 2**31, psum + 2**37, (negts % 2**64) ^ (1 << 63)
    assert 0 <= viol <= 64 and 0 <= mp < 2**32 and 0 <= ps < 2**38 and 0 <= cnt <= 64 and 0 <= row < 2**32
    return ((viol << 57) | (mp << 25) | (ps >> 13),
            ((ps & 0x1FFF) << 51) | (cnt << 44) | (nt >> 20),
            ((nt & 0xFFFFF) << 44) | (row << 12))


def _kernel_walk(a):
    """csrc/preempt.cu's algorithm in Python. The prologue's step facts
    (checked mask, same spec, cand holding every valid node or none); per
    node the nominee-adjusted carry, 64-bit victim masks and a cache of its
    victim search as if it were a candidate (fits-free bit, victim mask,
    packed key); a step with a new spec re-evaluates every row, a step with
    the same spec only the row the step before chose; the pick is a
    tournament tree of least keys (a key names its row) kept up to date
    leaf by leaf (the path rewritten from the prefix minimum of its
    siblings' keys) with a count of
    valid nodes fitting as they stand, on the steps one warp walks (same
    spec, cand full or empty); other steps take a gated minimum over the
    cache, and the tree is rebuilt before a run of one-warp steps.
    Returns the three outputs, per found step the index of the first key
    (5 = the row) that separated the chosen node from the runner-up (-1:
    the only feasible node), and the walk's counts: rows evaluated, steps
    walked by one warp, tree rebuilds (the kernel's walk_stats)."""
    p, n = a["cand"].shape
    v, r = a["vict_req"].shape[1:]
    valid = [bool(x) for x in a["node_valid"]]
    # the prologues
    same = [k > 0 and np.array_equal(a["p_req"][k], a["p_req"][k - 1]) and a["p_req_any"][k] == a["p_req_any"][k - 1]
            and a["p_prio"][k] == a["p_prio"][k - 1] for k in range(p)]
    live_any = [bool((a["cand"][k] & a["node_valid"]).any()) for k in range(p)]
    cfull = [bool((a["cand"][k] | ~a["node_valid"]).all()) for k in range(p)]
    solo = [k > 0 and same[k] and (cfull[k] or not live_any[k]) for k in range(p)]
    nfree = (a["free0"] - a["nom_extra0"]).tolist()
    ncount = (a["count_free0"] - a["nom_cnt0"]).tolist()
    alive = [sum(1 << j for j in range(v) if a["vict_valid"][i, j]) for i in range(n)]
    pdbm = [sum(1 << j for j in range(v) if a["vict_pdb"][i, j]) for i in range(n)]
    vreq = a["vict_req"].tolist()
    vprio = a["vict_prio"].tolist()
    vts = a["vict_ts"].tolist()
    key, ff, vms = [_NONE] * n, [False] * n, [0] * n
    npow = max(2, 1 << max(0, n - 1).bit_length())
    levels = npow.bit_length() - 1
    tree = [_NONE] * npow
    counts = {"evaluated": 0, "solo": 0, "rebuilds": 0}

    def search(i, k):
        """selectVictimsOnNode for row i as if it were a candidate: (packed
        key or _NONE, fits-as-it-stands, victim mask); the plain tuple key
        beside the packed one."""
        counts["evaluated"] += 1
        req = a["p_req"][k].tolist()
        checked = [x < 3 or req[x] > 0 for x in range(r)]
        any_req = bool(a["p_req_any"][k])
        prio = int(a["p_prio"][k])
        free_ok = not any_req or all(not checked[x] or nfree[i][x] - req[x] >= 0 for x in range(r))
        fits_free = free_ok and ncount[i] >= 1
        lower = [j for j in range(v) if (alive[i] >> j) & 1 and vprio[i][j] < prio]
        head = [nfree[i][x] - req[x] + sum(vreq[i][j][x] for j in lower) for x in range(r)]
        res_ok = not any_req or all(not checked[x] or head[x] >= 0 for x in range(r))
        cslack = ncount[i] + len(lower) - 1
        vm = 0
        if res_ok and cslack >= 0 and lower:
            for j in lower:
                keep = not any_req or all(not checked[x] or head[x] - vreq[i][j][x] >= 0 for x in range(r))
                if keep and cslack >= 1:
                    head = [head[x] - vreq[i][j][x] for x in range(r)]
                    cslack -= 1
                else:
                    vm |= 1 << j
        if not vm:
            return _NONE, fits_free, 0
        vs = [j for j in range(v) if (vm >> j) & 1]
        maxprio = max([-(2**31)] + [vprio[i][j] for j in vs])
        maxts = max([-(2**62)] + [vts[i][j] for j in vs if vprio[i][j] == maxprio])
        plain = (bin(vm & pdbm[i]).count("1"), maxprio, sum(vprio[i][j] for j in vs), len(vs), -maxts, i)
        packed = _pack(*plain)
        assert (packed < _pack(*tuple(plain[:5]) + (i + 1,))) and packed < _NONE
        return packed, fits_free, vm

    def store(i, k):
        key[i], ff[i], vms[i] = search(i, k)

    def key_at(j):
        return key[j] if j < n and valid[j] else _NONE

    def tree_key(x):
        return key_at(x - npow) if x >= npow else tree[x]

    def row_of(key_):
        return (key_[2] >> 12) & 0xFFFFFFFF

    def rebuild():
        m = npow >> 1
        while m >= 1:
            for x in range(m, 2 * m):
                tree[x] = min(tree_key(2 * x), tree_key(2 * x + 1))
            m >>= 1
        counts["rebuilds"] += 1

    def reeval(c, k):
        """Re-evaluate row c; rewrite its tree path from the prefix minimum
        of its siblings' keys; return the fits-free delta and the least key
        excluding c."""
        leaf = npow + c
        pm, prefix = _NONE, []
        for lvl in range(levels):
            pm = min(pm, tree_key((leaf >> lvl) ^ 1))
            prefix.append(pm)
        old_ff = ff[c]
        store(c, k)
        kc = key_at(c)
        for lvl, pm_l in enumerate(prefix):
            tree[leaf >> (lvl + 1)] = min(kc, pm_l)
        return (int(ff[c]) - int(old_ff)) if valid[c] else 0, pm

    nodes_out, victims_out, ff_out, deciders = [], [], [], []
    dirty, tree_ok, ffc = -1, False, 0
    for k in range(p):
        chosen = -1
        if solo[k]:
            counts["solo"] += 1
            if dirty >= 0:
                d, ko = reeval(dirty, k)
                ffc += d
                if cfull[k]:
                    best = min(key_at(dirty), ko)
                    chosen = row_of(best) if best != _NONE else -1
            elif cfull[k] and tree_key(1) != _NONE:
                chosen = row_of(tree_key(1))
            any_ff = cfull[k] and ffc > 0
        else:
            if not same[k]:
                for i in range(n):
                    store(i, k)
                tree_ok = False
            elif dirty >= 0:
                ffc += reeval(dirty, k)[0]
            live = [i for i in range(n) if a["cand"][k, i] and valid[i]]
            any_ff = any(ff[i] for i in live)
            best = min([(key[i], i) for i in live], default=(_NONE, -1))
            chosen = best[1] if best[0] != _NONE else -1
        # the gated minimum the pick must equal, and which key decided it
        keys = sorted(key[i] for i in range(n) if a["cand"][k, i] and valid[i] and key[i] != _NONE)
        assert (chosen >= 0) == bool(keys) and (chosen < 0 or key[chosen] == keys[0])
        found = chosen >= 0 and bool(a["p_valid"][k]) and not any_ff
        ff_out.append(any_ff)
        if found:
            deciders.append(-1 if len(keys) == 1 else _decider(keys[0], keys[1]))
            vm = vms[chosen]
            req = a["p_req"][k].tolist()
            for x in range(r):
                nfree[chosen][x] += sum(vreq[chosen][j][x] for j in range(v) if (vm >> j) & 1) - req[x]
            ncount[chosen] += bin(vm).count("1") - 1
            alive[chosen] &= ~vm
            nodes_out.append(chosen)
            victims_out.append([bool((vm >> j) & 1) for j in range(v)])
            dirty = chosen
        else:
            nodes_out.append(-1)
            victims_out.append([False] * v)
            dirty = -1
        if not solo[k] and k + 1 < p and solo[k + 1] and not tree_ok:
            rebuild()
            ffc = sum(1 for i in range(n) if valid[i] and ff[i])
            tree_ok = True
    outputs = (np.asarray(nodes_out, np.int32), np.asarray(victims_out, bool), np.asarray(ff_out, bool))
    return outputs, deciders, counts


def _decider(best, runner):
    """The first of the six key fields (5 = the row) in which two packed
    keys differ."""
    def unpack(w):
        bits = (w[0] << 128) | (w[1] << 64) | w[2]
        widths = (7, 32, 38, 7, 64, 32)
        out, shift = [], 192
        for wd in widths:
            shift -= wd
            out.append((bits >> shift) & ((1 << wd) - 1))
        return out
    b, q = unpack(best), unpack(runner)
    return next(x for x in range(6) if b[x] != q[x])


@pytest.mark.parametrize("mode", ["iid", "runs"])
def test_kernel_walk_matches_plain_and_reaches_every_branch(mode):
    """The kernel's algorithm equals the plain scan, and over the seeds
    and shapes the arrays reach every branch: each of the six pick keys
    decides some step, some steps find their pod fitting as things stand,
    some preemptors request nothing and some request an extended slot,
    some picks evict a PDB-violating victim, some nodes carry nominees.
    With runs of repeated specs the reuse path carries the walk: far fewer
    rows evaluated than P x N, steps walked by one warp, the tree rebuilt
    before them."""
    deciders = set()
    fits_free = requests_nothing = scalar = pdb_victims = 0
    evaluated = full = solo = rebuilds = 0
    for shape in SHAPES:
        for seed in range(3):
            a = _arrays(seed, shape, mode)
            plain = preempt_batch_plain(**_torch(a))
            walked, dec, counts = _kernel_walk(a)
            for w, g in zip(walked, plain):
                assert np.array_equal(w, g.numpy())
            deciders |= set(dec)
            fits_free += int(walked[2][: -5].sum())
            requests_nothing += int((~a["p_req_any"] & a["p_valid"]).sum())
            scalar += int((a["p_req"][:, 3:] > 0).any(axis=1).sum())
            chosen = walked[0]
            pdb_victims += sum(int((walked[1][k] & a["vict_pdb"][chosen[k]]).any())
                               for k in range(len(chosen)) if chosen[k] >= 0)
            assert a["nom_cnt0"].sum() > 0
            evaluated += counts["evaluated"]
            full += a["cand"].size
            solo += counts["solo"]
            rebuilds += counts["rebuilds"]
    assert {0, 1, 2, 3, 4, 5} <= deciders, deciders
    assert fits_free > 0 and requests_nothing > 0 and scalar > 0 and pdb_victims > 0
    if mode == "runs":
        assert evaluated < full // 2 and solo > 0 and rebuilds > 0, (evaluated, full, solo, rebuilds)
    else:
        assert evaluated >= full - SHAPES["base"][0] * SHAPES["base"][1]


def test_preempt_layout_places_the_carry():
    """csrc/preempt.cu keeps the walk's carry in shared memory when it fits
    (config 6: N = 512, R = 8, the tree's 512 leaves), the victims there
    too when they also fit, and in device memory past the budget (a
    counted path)."""
    from kubernetes_tpu_torch.ops.preempt import PREEMPT_SMEM_BUDGET, preempt_layout

    six = preempt_layout(512, 8, 8)
    assert six == {"NP": 512, "carry": 512 * (8 * 8 + 54) + 24 * 512, "resident": True, "victims_resident": False,
                   "smem": 512 * (8 * 8 + 54) + 24 * 512}
    small = preempt_layout(40, 8, 8)
    assert small["NP"] == 64 and small["victims_resident"] and small["smem"] == small["carry"] + 40 * 8 * (8 * 8 + 12)
    assert preempt_layout(1, 8, 8)["NP"] == 2 and preempt_layout(1100, 8, 8)["resident"]
    big = preempt_layout(2100, 8, 8)
    assert not big["resident"] and big["smem"] == 0 and big["carry"] > PREEMPT_SMEM_BUDGET
    assert all(preempt_layout(n, 64, r)["carry"] % 16 == 0 for n in (1, 7, 40, 513) for r in (1, 8, 64))


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_usage_matches_reference_and_inverts(seed):
    """Duplicate rows (several nominees on a node) add up; sentinel rows
    (N) are dropped; the negated overlay restores the bank exactly."""
    rng = np.random.default_rng(seed)
    n, r, b = 10, 6, 64
    requested = rng.integers(0, 10**12, (n, r)).astype(np.int64)
    pod_count = rng.integers(0, 110, n).astype(np.int32)
    rows = np.where(rng.random(b) < 0.8, rng.integers(0, 3, b), n).astype(np.int32)
    vecs = rng.integers(0, 10**9, (b, r)).astype(np.int64)
    cnt = (rows < n).astype(np.int32)
    want = r_fold_usage(jnp.asarray(requested), jnp.asarray(pod_count), jnp.asarray(rows), jnp.asarray(vecs),
                        jnp.asarray(cnt))
    treq, tpc = torch.from_numpy(requested.copy()), torch.from_numpy(pod_count.copy())
    got = fold_usage(treq, tpc, torch.from_numpy(rows), torch.from_numpy(vecs), torch.from_numpy(cnt))
    assert got[0] is treq and got[1] is tpc  # in place
    for w, g in zip(want, got):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype and np.array_equal(g.numpy(), np.asarray(w))
    assert np.bincount(rows).max() > 10 and (rows == n).any()
    fold_usage(treq, tpc, torch.from_numpy(rows), -torch.from_numpy(vecs), -torch.from_numpy(cnt))
    assert np.array_equal(treq.numpy(), requested) and np.array_equal(tpc.numpy(), pod_count)


def test_nominated_index_matches_reference():
    """Nominations added, moved, cleared one by one and in bulk: the same
    extras, per-node lists, adds counter and has_nominations."""
    queues = {}
    for pkg, t, q in (("ref", RT, RQueue(now=lambda: 5.0)), ("port", PT, PriorityQueue(now=lambda: 5.0))):
        pods = [t.Pod(name=f"p{i}", namespace="bench", priority=i % 3,
                      nominated_node_name=f"n{i % 2}" if i % 3 else "") for i in range(8)]
        for p in pods:
            q.add(p)
        infos = q.pop_batch(8)
        infos[1].pod.nominated_node_name = "n5"
        q.add_unschedulable(infos[1], 0)
        q.clear_nomination(infos[2].pod.key())
        q.clear_nominations([infos[3].pod.key(), "bench/absent"])
        queues[pkg] = q
    r, p = queues["ref"], queues["port"]
    assert p.nomination_adds == r.nomination_adds > 0
    assert p.has_nominations() and r.has_nominations()
    for keys in (set(), {"bench/p1", "bench/p4"}):
        assert [(n, x.key()) for n, x in p.nomination_extras(keys)] == \
            [(n, x.key()) for n, x in r.nomination_extras(keys)]
    for node in ("n0", "n1", "n5", "n9"):
        assert sorted(x.key() for x in p.nominated_pods_for_node(node)) == \
            sorted(x.key() for x in r.nominated_pods_for_node(node))
    assert p.nominated == r.nominated


def _snapshots(seed, ports=False, **kw):
    out = {}
    for pkg, t, snap in (("ref", RT, RSnapshot), ("port", PT, PSnapshot)):
        nodes, existing, pending, pdbs = random_preemption_cluster(seed, t=t, ports=ports, **kw)
        out[pkg] = (snap(nodes, existing), pending, pdbs)
    return out


def _plans(plans):
    if plans is None:
        return None
    return [(n, [v.key() for v in vs], ff) for n, vs, ff in plans]


@pytest.mark.parametrize("case", ["pdbs", "no-pdbs", "nominated", "ports", "anti-affinity"])
@pytest.mark.parametrize("seed", [3, 4])
def test_batch_preempt_device_matches_reference(seed, case):
    """The same plans, or the same None, on random preemption clusters:
    with and without PDBs, with out-of-batch nominations charged, with a
    host-port preemptor and with a required anti-affinity term on a bound
    pod (both outside the kernel's domain)."""
    snaps = _snapshots(seed, ports=case == "ports", pdbs=case != "no-pdbs")
    got = {}
    for pkg, (snap, pending, pdbs) in snaps.items():
        t = RT if pkg == "ref" else PT
        if case == "anti-affinity":
            ep = next(iter(snap.node_infos.values())).pods[0]
            ep.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": "zz"}), topology_key="kubernetes.io/hostname")]))
            snap = (RSnapshot if pkg == "ref" else PSnapshot)(
                [ni.node for ni in snap.node_infos.values()], [p for ni in snap.node_infos.values() for p in ni.pods])
        nominated = []
        if case == "nominated":
            names = list(snap.node_infos)
            nominated = [(names[i % len(names)], pending[-1 - i]) for i in range(6)]
            pending = pending[:-6]
        fn = RP.batch_preempt_device if pkg == "ref" else PP.batch_preempt_device
        got[pkg] = _plans(fn(pending, snap, pdbs=pdbs, nominated=nominated, can_disrupt=lambda p: p.priority != 10))
    assert got["port"] == got["ref"]
    if case in ("ports", "anti-affinity"):
        assert got["port"] is None
    else:
        assert sum(1 for n, _, _ in got["port"] if n is not None) > 3
        assert any(ff for _, _, ff in got["port"])


def _fast_cluster(t, rng, n_nodes=12):
    """tests/test_preemption_fast.py's `_cluster`, built with `t`: 8-core
    16Gi nodes holding 0-5 pods of priority 0, 0, 10 or 50."""
    alloc = {t.RESOURCE_CPU: t.Quantity.parse("8000m"), t.RESOURCE_MEMORY: t.Quantity.parse(str(16 * 2**30)),
             t.RESOURCE_PODS: t.Quantity.parse(110)}
    nodes = [t.Node(name=f"n{i}", labels={"kubernetes.io/hostname": f"n{i}"}, allocatable=dict(alloc),
                    capacity=dict(alloc)) for i in range(n_nodes)]
    existing = []
    k = 0
    for i in range(n_nodes):
        for _ in range(rng.randint(0, 6)):
            p = _fast_pod(t, f"low-{k}", rng.choice([500, 1000, 2000, 3000]), rng.choice([2**28, 2**30]))
            p.labels = {"app": f"a{rng.randint(0, 3)}"}
            p.priority = rng.choice([0, 0, 10, 50])
            p.creation_timestamp = rng.random() * 1000
            p.node_name = f"n{i}"
            existing.append(p)
            k += 1
    return nodes, existing


def _fast_pod(t, name, cpu_milli, mem):
    return t.Pod(name=name, containers=[t.Container(name="c", requests={
        t.RESOURCE_CPU: t.Quantity.parse(f"{cpu_milli}m"), t.RESOURCE_MEMORY: t.Quantity.parse(str(mem))})])


def _fast_pdbs(t, rng):
    return [t.PodDisruptionBudget(name=f"pdb{i}", selector=t.LabelSelector(match_labels={"app": f"a{i}"}),
                                  disruptions_allowed=rng.choice([0, 1])) for i in range(rng.randint(0, 2))]


@pytest.mark.parametrize("seed", [7, 11])
def test_host_victim_search_matches_reference(seed):
    """On test_preemption_fast.py's clusters: `_select_victims_fast` per
    node (with and without a nominee charge), `pick_one_node_for_preemption`
    over the candidates, and `preempt` end to end (with a nominated-pods
    lookup) — the same victims, violation counts, picks and clear lists."""
    results = {}
    for pkg, t, mod, snap_cls in (("ref", RT, RP, RSnapshot), ("port", PT, PP, PSnapshot)):
        rng = random.Random(seed)
        out = []
        for trial in range(12):
            nodes, existing = _fast_cluster(t, rng)
            snap = snap_cls(nodes, existing)
            pdbs = _fast_pdbs(t, rng)
            pre = _fast_pod(t, "hi", rng.choice([4000, 6000, 7500]), 2 * 2**30)
            pre.priority = 1000
            charge = ({t.RESOURCE_CPU: 1000, t.RESOURCE_MEMORY: 2**28}, 1) if trial % 3 == 0 else None
            cands = {}
            for name in snap.node_infos:
                v = mod._select_victims_fast(pre, snap.get(name), pdbs, None, nominee_charge=charge)
                out.append(None if v is None else ([p.key() for p in v.pods], v.num_pdb_violations))
                if v is not None:
                    cands[name] = v
            out.append(mod.pick_one_node_for_preemption(cands))
            low = _fast_pod(t, "nominee", 100, 2**20)
            low.priority = 5
            node, victims, clear = mod.preempt(pre, snap, pdbs=pdbs, nominated_fn=lambda n: [low])
            out.append((node, [p.key() for p in victims], clear))
        results[pkg] = out
    assert results["port"] == results["ref"]
    assert sum(1 for x in results["port"] if isinstance(x, tuple) and x[0] is not None) > 5


def test_preempt_refuses_term_carrying_preemptor_with_a_victim():
    """A preemptor with (anti-)affinity terms takes the slow victim search
    (the full predicate chain on every candidate node that holds a
    victim): the same node, victims and clear list as the reference; with
    no lower-priority pod anywhere there is no candidate in either; the
    device search declines the batch in both."""
    got = {}
    for pkg, t, mod in (("ref", RT, RP), ("port", PT, PP)):
        snap, pending, pdbs = _snapshots(5)[pkg]
        rows = []
        for j, pod in enumerate(p for p in pending if p.priority == 1000):
            pod.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": f"a{j % 4}"}),
                topology_key="kubernetes.io/hostname")]))
            node, victims, clear = mod.preempt(pod, snap, pdbs=pdbs)
            rows.append((node, [v.key() for v in victims], clear))
            rows.append(mod.batch_preempt_device([pod], snap, pdbs=pdbs))
            pod.priority = -1
            rows.append(mod.preempt(pod, snap, pdbs=pdbs))
        got[pkg] = rows
    assert got["port"] == got["ref"]
    assert any(r[0] is not None for r in got["port"][::3])
    assert all(r is None for r in got["port"][1::3]) and all(r == (None, [], []) for r in got["port"][2::3])


def test_bench_config6_priority_matches_the_reference_admission():
    """bench_config6 sets priority 1000 on its pending pods directly; the
    reference's Priority admission plugin resolves their class,
    `bench-critical`, to the same value (bench.py cfg6_preemption's path);
    the bound pods keep priority 0, and every pod's creation time is the
    same in both packages."""
    from kubernetes_tpu.apiserver import FakeAPIServer, default_admission_chain, install_system_priority_classes

    from kubernetes_tpu_torch.models.clusters import bench_config6

    api = FakeAPIServer(admission=default_admission_chain())
    install_system_priority_classes(api)
    api.create("priorityclasses", RT.PriorityClass(name="bench-critical", value=1000))
    nodes, existing, pending = bench_config6(6, 12)
    _, r_existing, r_pending = bench_config6(6, 12, t=RT)
    for p, rp in zip(pending, r_pending):
        assert p.priority_class_name == rp.priority_class_name == "bench-critical"
        rp.priority = None
        admitted = api.create("pods", rp)
        assert admitted.priority == p.priority == 1000
        assert p.creation_timestamp == rp.creation_timestamp
    assert all(p.priority == 0 for p in existing) and len(existing) == 7 * len(nodes)
    assert [p.creation_timestamp for p in existing] == [p.creation_timestamp for p in r_existing]
