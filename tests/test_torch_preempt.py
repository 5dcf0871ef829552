"""Preemption on the CPU: the port's `preempt_batch` (plain version)
against `kubernetes_tpu.ops.preempt.preempt_batch` on seeded padded arrays
that reach every branch of the scan (PDB violators, fits_free, preemptors
requesting nothing, extended-resource slots, nominee charges, ties decided
at each of the six pick keys, padded rows, 64 victim slots), and a Python
walk of csrc/preempt.cu's algorithm (the nominee-adjusted carry, 64-bit
victim masks, the lexicographic block minimum) against the plain version;
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


def _arrays(seed, shape):
    p, n, v, r = SHAPES[shape]
    return random_preempt_arrays(seed, p, n, v, r)


def _torch(a):
    return {k: torch.from_numpy(x.copy()) for k, x in a.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_preempt_batch_matches_reference(seed, shape):
    a = _arrays(seed, shape)
    want = r_preempt_batch(**{k: jnp.asarray(x) for k, x in a.items()})
    got = preempt_batch(**_torch(a))  # CPU tensors: the plain version
    for w, g in zip(want, got):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype and np.array_equal(g.numpy(), w)
    chosen = got[0].numpy()
    assert (chosen >= 0).sum() >= 3  # preemptions happened
    assert chosen[-5:].max() == -1  # padded preemptors never pick
    assert (chosen < SHAPES[shape][1] - 4).all()  # nor do padded nodes get picked


def _kernel_walk(a):
    """csrc/preempt.cu's algorithm in Python: per node the nominee-adjusted
    carry and a victim-slot bitmask, the reprieve in slot order, and the
    pick as the lexicographic minimum of (keys..., row). Returns the three
    outputs and, per found step, the index of the first key (5 = the row)
    that separated the chosen node from the runner-up (-1: the only
    feasible node)."""
    p, n = a["cand"].shape
    v, r = a["vict_req"].shape[1:]
    nfree = (a["free0"] - a["nom_extra0"]).tolist()
    ncount = (a["count_free0"] - a["nom_cnt0"]).tolist()
    alive = [sum(1 << j for j in range(v) if a["vict_valid"][i, j]) for i in range(n)]
    pdbm = [sum(1 << j for j in range(v) if a["vict_pdb"][i, j]) for i in range(n)]
    vreq = a["vict_req"].tolist()
    vprio = a["vict_prio"].tolist()
    vts = a["vict_ts"].tolist()
    nodes_out, victims_out, ff_out, deciders = [], [], [], []
    for k in range(p):
        req = a["p_req"][k].tolist()
        checked = [x < 3 or req[x] > 0 for x in range(r)]
        any_req = bool(a["p_req_any"][k])
        prio = int(a["p_prio"][k])
        ff = False
        keys = []
        masks = {}
        for i in range(n):
            live = bool(a["cand"][k, i] and a["node_valid"][i])
            free_ok = not any_req or all(not checked[x] or nfree[i][x] - req[x] >= 0 for x in range(r))
            ff |= live and free_ok and ncount[i] >= 1
            lower = [j for j in range(v) if (alive[i] >> j) & 1 and vprio[i][j] < prio]
            head = [nfree[i][x] - req[x] + sum(vreq[i][j][x] for j in lower) for x in range(r)]
            res_ok = not any_req or all(not checked[x] or head[x] >= 0 for x in range(r))
            cslack = ncount[i] + len(lower) - 1
            if not (live and res_ok and cslack >= 0 and lower):
                continue
            vm = 0
            for j in lower:
                keep = not any_req or all(not checked[x] or head[x] - vreq[i][j][x] >= 0 for x in range(r))
                if keep and cslack >= 1:
                    head = [head[x] - vreq[i][j][x] for x in range(r)]
                    cslack -= 1
                else:
                    vm |= 1 << j
            if not vm:
                continue
            vs = [j for j in range(v) if (vm >> j) & 1]
            maxprio = max(vprio[i][j] for j in vs)
            maxts = max([-(2**62)] + [vts[i][j] for j in vs if vprio[i][j] == maxprio])
            keys.append((bin(vm & pdbm[i]).count("1"), maxprio, sum(vprio[i][j] for j in vs), len(vs), -maxts, i))
            masks[i] = vm
        ff_out.append(ff)
        keys.sort()
        found = bool(keys) and bool(a["p_valid"][k]) and not ff
        if not found:
            nodes_out.append(-1)
            victims_out.append([False] * v)
            continue
        best = keys[0]
        deciders.append(-1 if len(keys) == 1 else next(x for x in range(6) if keys[1][x] != best[x]))
        i = best[5]
        vm = masks[i]
        for x in range(r):
            nfree[i][x] += sum(vreq[i][j][x] for j in range(v) if (vm >> j) & 1) - req[x]
        ncount[i] += bin(vm).count("1") - 1
        alive[i] &= ~vm
        nodes_out.append(i)
        victims_out.append([bool((vm >> j) & 1) for j in range(v)])
    return (np.asarray(nodes_out, np.int32), np.asarray(victims_out, bool), np.asarray(ff_out, bool)), deciders


def test_kernel_walk_matches_plain_and_reaches_every_branch():
    """The kernel's algorithm equals the plain scan, and over the seeds
    and shapes the arrays reach every branch: each of the six pick keys
    decides some step, some steps find their pod fitting as things stand,
    some preemptors request nothing and some request an extended slot,
    some picks evict a PDB-violating victim, some nodes carry nominees."""
    deciders = set()
    fits_free = requests_nothing = scalar = pdb_victims = 0
    for shape in SHAPES:
        for seed in range(3):
            a = _arrays(seed, shape)
            plain = preempt_batch_plain(**_torch(a))
            walked, dec = _kernel_walk(a)
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
    assert {0, 1, 2, 3, 4, 5} <= deciders, deciders
    assert fits_free > 0 and requests_nothing > 0 and scalar > 0 and pdb_victims > 0


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
