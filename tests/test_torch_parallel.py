"""The node mesh on the CPU: the port's sharded programs against the
reference's, exact.

The reference's sharded programs (kubernetes_tpu/parallel/sharded.py,
commit/arbiter.make_sharded_arbiter, ops/fold.make_sharded_fold_fns) run on
the 8-virtual-device CPU mesh of tests/conftest.py. Under jax >= 0.5 the
top-level `jax.shard_map` checks varying manual axes, which the reference's
arbiter scan carry (`cs = jnp.zeros((U, n_local))`, arbiter.py:468-477) does
not declare; the `ref_mesh` fixture swaps in `partial(jax.shard_map,
check_vma=False)` for these tests alone (monkeypatch: no reference file
changes) and fresh program memos, so that no program built without it by
another test file in the same process is reused.

The port's mesh is S node shards of one device (`node_mesh(..., device=
"cpu")` here); its plain versions write the shard axis out. Held, with
exact equality: the sharded pipeline (seeds x tie-noise, 2D meshes, every
term kind with and without in-batch tracking, the residual carry) against
the reference's single-device and sharded pipelines; the chunked solve
across chunk boundaries against the reference's `_solver_body`; the gang
pipeline; the sharded arbiter against the reference's `arbitrate`, its
sharded twin and `host_arbitrate` on captured batches; the sharded folds
against `make_sharded_fold_fns`; the mesh's construction rules.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.commit.arbiter as RA
from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import fold as RFold
from kubernetes_tpu.ops import pipeline as RP
from kubernetes_tpu.ops import solver as RS
from kubernetes_tpu.oracle.nodeinfo import Snapshot
from kubernetes_tpu.parallel import mesh as RMesh
from kubernetes_tpu.parallel import sharded as RSharded
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.cache import TensorMirror as RMirror
from kubernetes_tpu.state.tensors import PodBatch as RPodBatch
from kubernetes_tpu.state.terms import compile_batch_terms as r_compile

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.commit import arbiter as PA
from kubernetes_tpu_torch.models.clusters import fill_cache, make_node, make_pod, random_cluster
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.ops import fold as PFold
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.ops.solver import prng_key_data, solve_gang_plain, solve_greedy_plain
from kubernetes_tpu_torch.parallel import AXIS_NODES, AXIS_PODS, make_sharded_pipeline, node_mesh, node_shards
from kubernetes_tpu_torch.parallel import sharded as PS
from kubernetes_tpu_torch.state.cache import SchedulerCache, TensorMirror, per_shard_bytes
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
from kubernetes_tpu_torch.state.terms import compile_batch_terms as p_compile
from test_torch_commit import _captured_arbitrate, _carry, _port_args

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="the reference's mesh needs 8 devices")


@pytest.fixture
def ref_mesh(monkeypatch):
    """The reference's node mesh with its shard_map runnable on this jax:
    `check_vma=False` (see the module docstring), and fresh memos."""
    shim = functools.partial(jax.shard_map, check_vma=False)
    monkeypatch.setattr(RMesh, "shard_map", shim)
    monkeypatch.setattr(RSharded, "shard_map", shim)
    monkeypatch.setattr(RSharded, "_PIPELINE_CACHE", {})
    monkeypatch.setattr(RFold, "_SHARDED_FOLD_CACHE", {})
    return RMesh.node_mesh


def _cpu_mesh(n=8, pods_parallel=1):
    return node_mesh(n, pods_parallel=pods_parallel, device="cpu")


def _jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _tc(d):
    return arrays_to_torch(d, "cpu")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_node_mesh_layout_and_errors():
    m = _cpu_mesh(8, pods_parallel=2)
    assert m.shape == {AXIS_PODS: 2, AXIS_NODES: 4} and node_shards(m) == 4
    assert m.axis_names == (AXIS_PODS, AXIS_NODES) and m.device == torch.device("cpu")
    assert m == _cpu_mesh(8, pods_parallel=2) and hash(m) == hash(_cpu_mesh(8, pods_parallel=2))
    assert m != _cpu_mesh(8) and node_shards(node_mesh(device="cpu")) == 8
    assert node_shards(node_mesh(devices=["cpu"] * 4)) == 4
    assert node_shards(node_mesh(2, devices=["cpu"] * 4)) == 2
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        node_mesh(8, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="does not divide"):
        node_mesh(6, pods_parallel=4, device="cpu")
    # a mesh spanning devices is the multi-card transport, not ported
    with pytest.raises(NotImplementedError, match="multi-card transport"):
        node_mesh(devices=["cpu", "cuda:1"])
    with pytest.raises(NotImplementedError, match="multi-card transport"):
        node_mesh(devices=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="multi-card transport"):
        node_mesh(devices=["cpu"], device="cuda:0")
    if not torch.cuda.is_available():  # the mesh is on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            node_mesh(8)


def test_per_shard_bytes_matches_reference():
    from kubernetes_tpu.state.cache import per_shard_bytes as ref_psb

    shipped = {"full": 8000, "rows": 801, "usage": 96, "warm": 17, "fold": 640}
    for shards in (0, 1, 2, 8):
        assert per_shard_bytes(shipped, shards) == ref_psb(shipped, shards)


# ---------------------------------------------------------------------------
# the sharded pipeline
# ---------------------------------------------------------------------------

def _encode(seed, n_nodes=24, n_existing=90, n_pending=14):
    """One cluster encoded by the reference (encode_solve_args) and handed
    to both packages: (reference args less the key, port args)."""
    nodes, existing, pending = random_cluster(seed, n_nodes, n_existing, n_pending, t=RT, pins=True)
    args = RP.encode_solve_args(Snapshot(nodes, existing), pending)[:-1]
    na, pa = ({k: np.asarray(v) for k, v in d.items()} for d in args[:2])
    return args, (_tc(na), _tc(pa), {k: int(v) for k, v in args[6].items()})


@pytest.mark.parametrize("seed", [40, 41, 42])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_sharded_pipeline_matches_reference(seed, det, ref_mesh):
    args, (na, pa, ids) = _encode(seed)
    key = jax.random.PRNGKey(seed)
    ref_assign, ref_score = RP.solve_pipeline(*args, key, deterministic=det, term_kinds=frozenset())
    if seed == 40:  # the reference's sharded pipeline too (a costly compile)
        ref_sh = RSharded.make_sharded_pipeline(ref_mesh(8))(*args, key, deterministic=det, term_kinds=frozenset())
        assert np.array_equal(np.asarray(ref_assign), np.asarray(ref_sh[0]))
    pipe = make_sharded_pipeline(_cpu_mesh(8))
    assert make_sharded_pipeline(_cpu_mesh(8)) is pipe  # memoized per mesh
    got_assign, got_score = pipe(na, pa, ids, prng_key_data(seed), deterministic=det)
    assert np.array_equal(np.asarray(ref_score), got_score.numpy())
    assert np.array_equal(np.asarray(ref_assign), got_assign.numpy())
    assert (got_assign >= 0).sum() > 5


@pytest.mark.parametrize("pods_parallel,det", [(2, False), (4, True)], ids=["pods2-noise", "pods4-deterministic"])
def test_sharded_pipeline_2d_mesh(pods_parallel, det):
    """A ("pods", "nodes") 2D mesh gives the 1D mesh's result, the
    reference's single-device one: the pods axis splits only the mask and
    score compute (the reference holds its own 2D mesh to the same in
    tests/test_parallel.py)."""
    args, (na, pa, ids) = _encode(43)
    ref_assign, ref_score = RP.solve_pipeline(*args, jax.random.PRNGKey(7), deterministic=det,
                                              term_kinds=frozenset())
    got = make_sharded_pipeline(_cpu_mesh(8, pods_parallel))(na, pa, ids, prng_key_data(7), deterministic=det)
    assert np.array_equal(np.asarray(ref_assign), got[0].numpy())
    assert np.array_equal(np.asarray(ref_score), got[1].numpy())


@pytest.mark.parametrize("seed,track,det", [(44, False, True), (45, True, False), (46, True, True)],
                         ids=["untracked-deterministic", "tracked-noise", "tracked-deterministic"])
def test_sharded_pipeline_terms_and_tracking(seed, track, det, ref_mesh):
    """Every term kind (term_kinds=None), with the in-batch anti-affinity /
    host-port tracking on and off, and a residual carry: the port's
    sharded pipeline at 2, 4 and 8 shards equals the reference's
    single-device pipeline (assignment, score, carry) and the port's
    single-device pipeline; the tracked tie-noise case also the
    reference's sharded pipeline (its compile is the costly part)."""
    from kubernetes_tpu.ops import filters as RF

    res = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes, existing, pending = random_cluster(seed, 60, 40, 120, t=t, topology=True, hard_spread=True,
                                                  interpod=True, pending_affinity=False, pending_ports=track)
        cache = (RCache if pkg == "ref" else SchedulerCache)()
        fill_cache(cache, nodes, existing)
        mirror = RMirror(cache) if pkg == "ref" else TensorMirror(cache, device="cpu")
        batch = (RPodBatch if pkg == "ref" else PPodBatch)(mirror.vocab, 128)
        for i, p in enumerate(pending):
            batch.set_pod(i, p)
        tb, aux = (r_compile if pkg == "ref" else p_compile)(mirror.vocab, pending, b_capacity=128)
        res[pkg] = [mirror.nodes.arrays(), mirror.eps.arrays(), mirror.pats.arrays(), tb.arrays(), aux,
                    batch.arrays(), (RF if pkg == "ref" else PF).make_ids(mirror.vocab)]
    na, ea, xa, ta, au, pa, ids = res["ref"]
    # a carry as a previous batch would leave it: some nodes fuller
    rng = np.random.default_rng(seed)
    free = na["alloc"] - na["requested"]
    hit = rng.random(free.shape[0]) < 0.3
    free = free - np.where(hit[:, None], (free * 0.5).astype(np.int64), 0)
    carry = (free, na["pod_count"] + hit.astype(na["pod_count"].dtype), na["nonzero_req"])
    kw = dict(deterministic=det, term_kinds=None, n_buckets=128, return_carry=True, track_inbatch=track)
    key = jax.random.PRNGKey(seed)
    rargs = (_jx(na), _jx(pa), _jx(ea), _jx(ta), _jx(xa), _jx(au), ids, key)
    want = RP.solve_pipeline(*rargs, carry=tuple(jnp.asarray(c) for c in carry), **kw)
    if track and not det:
        ref_sh = RSharded.make_sharded_pipeline(ref_mesh(8))(*rargs, carry=tuple(jnp.asarray(c) for c in carry),
                                                             **kw)
        assert np.array_equal(np.asarray(want[0]), np.asarray(ref_sh[0]))
    na, ea, xa, ta, au, pa, ids = res["port"]
    pkw = dict(deterministic=det, term_kinds=None, return_carry=True, track_inbatch=track, ea=_tc(ea), ta=_tc(ta),
               au=_tc(au), xa=_tc(xa), n_buckets=128, carry=tuple(torch.from_numpy(np.array(c)) for c in carry))
    single = PP.solve_pipeline(_tc(na), _tc(pa), ids, prng_key_data(seed), **pkw)
    for shards in (2, 4, 8):
        got = make_sharded_pipeline(_cpu_mesh(shards))(_tc(na), _tc(pa), ids, prng_key_data(seed), **pkw)
        assert np.array_equal(np.asarray(want[0]), got[0].numpy()), shards
        assert np.array_equal(np.asarray(want[1]), got[1].numpy()), shards
        for a, b in zip(want[2], got[2]):
            assert np.array_equal(np.asarray(a), b.numpy()), shards
        assert torch.equal(single[0], got[0])
    assert (got[0] >= 0).sum() > 10


def test_sharded_residuals_bind_within_batch():
    """Capacity one pod takes on one shard is seen by the next pods'
    commits on every shard: one big node the scorer prefers, fifteen small
    ones, twelve 1.5-core pods; the reference's single-device result."""
    want = {}
    for pkg, t in (("ref", RT), ("port", PT)):
        nodes = [make_node(f"n{i}", cpu_milli=8000 if i == 0 else 2000, labels={"kubernetes.io/hostname": f"n{i}"},
                           t=t) for i in range(16)]
        pods = [make_pod(f"p{i}", namespace="d", cpu_milli=1500, mem=0, t=t) for i in range(12)]
        want[pkg] = (nodes, pods)
    args = RP.encode_solve_args(Snapshot(*([want["ref"][0], []])), want["ref"][1])[:-1]
    ref_assign, _ = RP.solve_pipeline(*args, jax.random.PRNGKey(3), deterministic=True, term_kinds=frozenset())
    na, pa = ({k: np.asarray(v) for k, v in d.items()} for d in args[:2])
    got, _ = make_sharded_pipeline(_cpu_mesh(8))(_tc(na), _tc(pa), {k: int(v) for k, v in args[6].items()},
                                                 prng_key_data(3), deterministic=True)
    assert np.array_equal(np.asarray(ref_assign), got.numpy())
    placed = got.numpy()[:12]
    assert (placed >= 0).all()
    counts = np.bincount(placed, minlength=16)
    assert counts[0] <= 5 and (counts[1:16] <= 1).all()


def _contention(seed=5, B=256, N=8, R=2):
    rng = np.random.RandomState(seed)
    return dict(
        mask=rng.rand(B, N) < 0.9, score=rng.randint(0, 3, (B, N)).astype(np.int64),
        req=rng.randint(1, 4, (B, R)).astype(np.int64), free=rng.randint(10, 30, (N, R)).astype(np.int64),
        count=np.zeros(N, np.int64), allowed=np.full(N, 12, np.int64), order=np.arange(B, dtype=np.int32),
    )


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_sharded_chunked_contention_multi_chunk(det, ref_mesh):
    """B = 256 (two chunks of 128) fighting over 8 tight nodes: the
    cross-shard repair loop stays equal to the reference's single-device
    solve and its `_solver_body` on the 8-device mesh across chunk
    boundaries; the port at 1, 2, 4 and 8 shards equals both, residuals
    included."""
    from jax.sharding import PartitionSpec as P

    c = _contention()
    B, N = c["mask"].shape
    key = jax.random.PRNGKey(5)
    want = np.asarray(RS.solve_greedy(
        jnp.asarray(c["mask"]), jnp.asarray(c["score"]), jnp.asarray(c["req"]), jnp.asarray(c["free"]),
        jnp.asarray(c["count"]), jnp.asarray(c["allowed"]), jnp.asarray(c["order"]), key, deterministic=det,
        req_any=jnp.ones(B, bool)))
    noise = jnp.zeros((B, 8)) if det else RS.tie_noise(key, B, N)
    body = RMesh.shard_map(
        functools.partial(RSharded._solver_body, deterministic=det, n_local=1),
        mesh=ref_mesh(8),
        in_specs=(P(None, "nodes"), P(None, "nodes"), P(), P("nodes"), P("nodes"), P("nodes"), P(),
                  P(None, "nodes"), P(), P(), P(), P("nodes"), P()),
        out_specs=(P(), P("nodes"), P("nodes"), P("nodes")),
    )
    choices, *_ = body(jnp.asarray(c["mask"]), jnp.asarray(c["score"]), jnp.asarray(c["req"]),
                       jnp.asarray(c["free"]), jnp.asarray(c["count"]), jnp.asarray(c["allowed"]),
                       jnp.asarray(c["order"]), noise, jnp.ones(B, bool), jnp.arange(B, dtype=jnp.int32),
                       jnp.ones(B, bool), jnp.zeros((N, 2), jnp.int64), jnp.zeros((B, 2), jnp.int64))
    ref_sh = np.asarray(jnp.full((B,), -1, jnp.int32).at[jnp.asarray(c["order"])].set(choices))
    assert (ref_sh == want).all()
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    single, carry1 = solve_greedy_plain(t["mask"], t["score"], t["req"], t["free"], t["count"], t["allowed"],
                                        t["order"], prng_key_data(5), det, return_carry=True)
    for shards in (1, 2, 4, 8):
        got, carry = PS.solve_sharded(t["mask"], t["score"], t["req"], t["free"], t["count"], t["allowed"],
                                      t["order"], prng_key_data(5), shards, det, return_carry=True)
        assert np.array_equal(got.numpy(), want), shards
        assert all(torch.equal(a, b) for a, b in zip(carry, carry1))
    assert (want == -1).sum() > 0  # contention rejected pods
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        PS.solve_sharded(t["mask"], t["score"], t["req"], t["free"], t["count"], t["allowed"], t["order"],
                         prng_key_data(5), 3, det)


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_sharded_gang_pipeline_matches_reference(det, ref_mesh):
    """pipeline.gang against the reference's single-device and sharded gang
    pipelines: two groups over tight nodes, one of which cannot fit whole,
    ungrouped pods and padding; and the port's plain gang solve."""
    args, (na, pa, ids) = _encode(47, n_nodes=16, n_existing=60, n_pending=30)
    b = int(np.asarray(args[1]["valid"]).shape[0])
    group = np.full(b, -1, np.int32)
    group[:10] = 0
    group[10:24] = 1
    key = jax.random.PRNGKey(9)
    want = RP.solve_pipeline_gang(*args, key, jnp.asarray(group), deterministic=det, term_kinds=frozenset())
    refs = [want]
    if not det:  # the reference's sharded gang pipeline (its compile is the costly part)
        refs.append(RSharded.make_sharded_pipeline(ref_mesh(8)).gang(*args, key, jnp.asarray(group),
                                                                     deterministic=det, term_kinds=frozenset()))
    got = make_sharded_pipeline(_cpu_mesh(8)).gang(na, pa, ids, prng_key_data(9), torch.from_numpy(group),
                                                   deterministic=det)
    for w in refs:
        assert np.array_equal(np.asarray(w[0]), got[0].numpy())
        assert np.array_equal(np.asarray(w[2]), got[2].numpy())
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())
    c = _contention(seed=8, B=64, N=8)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    g = torch.from_numpy(np.random.RandomState(2).randint(-1, 12, 64).astype(np.int32))
    single = solve_gang_plain(t["mask"], t["score"], t["req"], t["free"], t["count"], t["allowed"], t["order"], g,
                              prng_key_data(4), det)
    sh = PS.solve_gang_sharded(t["mask"], t["score"], t["req"], t["free"], t["count"], t["allowed"], t["order"],
                               g, prng_key_data(4), 4, det)
    assert torch.equal(single[0], sh[0]) and torch.equal(single[1], sh[1]) and (~sh[1]).any()


# ---------------------------------------------------------------------------
# the sharded arbiter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["anti-heavy-1", "hard-spread", "could-fit", "random-7"])
def test_sharded_arbiter_matches_reference(workload, monkeypatch, ref_mesh):
    """On the arrays the reference Scheduler passed its arbiter (required
    anti-affinity; DoNotSchedule spread with defers; the could-fit -1
    defers; every covered kind with host ports): the port's sharded
    verdict scan at 1, 2, 4 and 8 shards equals the reference's
    `arbitrate` (on the spread batches also its shard_map'd twin on the
    8-device mesh); with a
    residual carry, the port's single-device scan (held to the
    reference's with a carry in tests/test_torch_commit.py)."""
    c = _captured_arbitrate(workload, monkeypatch)
    kw = dict(term_kinds=c["term_kinds"], n_buckets=c["n_buckets"])
    if workload in ("hard-spread", "random-7"):  # the reference's shard_map'd twin (a costly compile)
        ref_sh = RA.make_sharded_arbiter(ref_mesh(8))
        jargs = (_jx(c["na"]), _jx(c["pa"]), _jx(c["ea"]), _jx(c["ta"]), _jx(c["ids"]), jnp.asarray(c["assign"]))
        assert np.array_equal(np.asarray(ref_sh(*jargs, pb=_jx(c["pb"]), **kw)), c["verdicts"])
    pcarry = tuple(torch.from_numpy(np.array(x)) for x in _carry(c, 3))
    want_c = PA.arbitrate_plain(*_port_args(c), carry=pcarry, **kw)
    n = c["na"]["valid"].shape[0]
    for shards in (1, 2, 4, 8):
        if n % shards:
            continue
        assert np.array_equal(PA.arbitrate_sharded(shards, *_port_args(c), **kw).numpy(), c["verdicts"]), shards
        got_c = PA.arbitrate_sharded(shards, *_port_args(c), carry=pcarry, **kw)
        assert torch.equal(got_c, want_c), shards
    arb = make_sharded_pipeline(_cpu_mesh(8)).arbitrate
    assert np.array_equal(arb(*_port_args(c), **kw).numpy(), c["verdicts"])


def test_sharded_arbiter_verdicts_match_host_and_single_device(ref_mesh):
    """The reference's mixed anti / DoNotSchedule / host-port batch through
    each package's Scheduler on a mesh: the port's mesh verdicts equal its
    single-device verdicts, the reference's shimmed mesh verdicts and the
    host walk (`host_arbitrate`)."""
    from kubernetes_tpu.scheduler.driver import Scheduler as RScheduler
    from kubernetes_tpu.state.queue import PriorityQueue as RQueue
    from kubernetes_tpu_torch.scheduler.driver import Binder, Scheduler
    from kubernetes_tpu_torch.state.queue import PriorityQueue

    def batch(t):
        pods = []
        for i in range(6):
            p = make_pod(f"a{i}", cpu_milli=100, labels={"app": "g"}, t=t)
            p.affinity = t.Affinity(pod_anti_affinity=t.PodAntiAffinity(required=[t.PodAffinityTerm(
                label_selector=t.LabelSelector(match_labels={"app": "g"}), topology_key="kubernetes.io/hostname")]))
            pods.append(p)
        for i in range(6):
            p = make_pod(f"s{i}", cpu_milli=50, labels={"app": "web"}, t=t)
            p.topology_spread_constraints = [t.TopologySpreadConstraint(
                max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule",
                label_selector=t.LabelSelector(match_labels={"app": "web"}))]
            pods.append(p)
        for i in range(4):
            p = make_pod(f"hp{i}", cpu_milli=50, t=t)
            p.containers[0].ports = [t.ContainerPort(host_port=8080)]
            pods.append(p)
        return pods

    def nodes(t):
        return [make_node(f"n{i}", cpu_milli=4000, labels={"kubernetes.io/hostname": f"n{i}", "zone": f"z{i % 2}"},
                          t=t) for i in range(8)]

    def port(mesh):
        cache = SchedulerCache()
        fill_cache(cache, nodes(PT))
        sched = Scheduler(cache, PriorityQueue(), binder=Binder(), deterministic=True, enable_preemption=False,
                          device="cpu", mesh=mesh)
        for p in batch(PT):
            sched.queue.add(p)
        infos = sched.queue.pop_batch(16)
        out = sched._solve_batch(infos, [""] * len(infos), False)
        names = list(sched.mirror.name_of_row)
        host = PA.host_arbitrate([i.pod for i in infos], out.assign, lambda r: names[r] if 0 <= r < len(names) else None,
                                 sched.cache.snapshot)
        return list(out.assign), list(out.verdicts), host, sched

    def ref(mesh):
        cache = RCache()
        fill_cache(cache, nodes(RT))
        sched = RScheduler(cache=cache, queue=RQueue(), deterministic=True, enable_preemption=False, mesh=mesh,
                           speculate=False, columnar_cache=False)
        for p in batch(RT):
            sched.queue.add(p)
        infos = sched.queue.pop_batch(16)
        out = sched._finish_solve(sched._dispatch_solve(infos))
        sched.close()
        return list(out.assign), [int(v) for v in out.verdicts]

    a_mesh, v_mesh, host, sched = port(_cpu_mesh(8))
    a_one, v_one, _, _ = port(None)
    r_mesh = ref(ref_mesh(8))
    assert a_mesh == a_one == r_mesh[0]
    assert v_mesh == v_one == r_mesh[1] == host
    assert PA.V_DEFER in v_mesh and PA.V_PLACE in v_mesh
    sched.close()


# ---------------------------------------------------------------------------
# the sharded folds
# ---------------------------------------------------------------------------

def _fold_case(seed, n=64, r=4, s=12, pt=6, b=40, t=30):
    rng = np.random.default_rng(seed)
    banks = dict(
        requested=rng.integers(0, 1 << 40, (n, r)), nonzero_req=rng.integers(0, 1 << 30, (n, 2)),
        pod_count=rng.integers(0, 100, n).astype(np.int32),
        sig_counts=rng.integers(-32768, 32767, (n, s)).astype(np.int16),
        pat_counts=rng.integers(-32768, 32767, (n, pt)).astype(np.int16),
    )
    rows = rng.integers(0, n + 1, b).astype(np.int32)  # n: the padding sentinel
    ctl = dict(
        rows=rows, req=rng.integers(-1000, 1000, (b, r)), nz=rng.integers(0, 1000, (b, 2)),
        cnt=rng.integers(0, 2, b).astype(np.int32), sig=rng.integers(0, s + 1, b).astype(np.int32),
        pat_row=rng.integers(0, n + 1, t).astype(np.int32), pat_col=rng.integers(0, pt + 1, t).astype(np.int32),
        pat_cnt=rng.integers(-3, 4, t).astype(np.int16),
    )
    return banks, ctl


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_folds_match_reference(seed, ref_mesh):
    """The port's sharded commit and usage folds (duplicate rows, padding
    sentinels, int16 wrap) equal the reference's make_sharded_fold_fns on
    the 8-device mesh and the single-device folds."""
    banks, ctl = _fold_case(seed)
    names = ("requested", "nonzero_req", "pod_count", "sig_counts", "pat_counts")
    commit, usage = RFold.make_sharded_fold_fns(ref_mesh(8))
    want = commit(*(jnp.asarray(banks[k]) for k in names), *(jnp.asarray(v) for v in ctl.values()))
    pcommit, pusage = PFold.make_sharded_fold_fns(_cpu_mesh(8))
    assert PFold.make_sharded_fold_fns(_cpu_mesh(8))[0] is pcommit  # memoized per mesh
    single = [torch.from_numpy(banks[k].copy()) for k in names]
    PFold.fold_commit_banks_plain(*single, **_tc(ctl))
    for shards in (2, 4, 8):
        got = [torch.from_numpy(banks[k].copy()) for k in names]
        fn = pcommit if shards == 8 else PFold.make_sharded_fold_fns(_cpu_mesh(shards))[0]
        fn(*got, **_tc(ctl))
        for w, g, s1 in zip(want, got, single):
            assert np.array_equal(np.asarray(w), g.numpy()) and torch.equal(g, s1)
    vecs, cnt = ctl["req"], ctl["cnt"]
    want_u = usage(jnp.asarray(banks["requested"]), jnp.asarray(banks["pod_count"]), jnp.asarray(ctl["rows"]),
                   jnp.asarray(vecs), jnp.asarray(cnt))
    req_t, cnt_t = torch.from_numpy(banks["requested"].copy()), torch.from_numpy(banks["pod_count"].copy())
    pusage(req_t, cnt_t, *(torch.from_numpy(x) for x in (ctl["rows"], vecs, cnt)))
    assert np.array_equal(np.asarray(want_u[0]), req_t.numpy()) and np.array_equal(np.asarray(want_u[1]),
                                                                                   cnt_t.numpy())
    # its exact inverse restores the bank
    pusage(req_t, cnt_t, *(torch.from_numpy(x) for x in (ctl["rows"], -vecs, -cnt)))
    assert np.array_equal(req_t.numpy(), banks["requested"]) and np.array_equal(cnt_t.numpy(), banks["pod_count"])
    with pytest.raises(ValueError, match="not divisible"):
        PFold.fold_usage_sharded(3, req_t, cnt_t, *(torch.from_numpy(x) for x in (ctl["rows"], vecs, cnt)))
