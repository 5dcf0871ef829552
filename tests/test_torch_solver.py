"""The port's solver pieces against the reference's JAX ones on identical
numpy inputs: pop_order, tie_noise (bit-identical as uint32 float bits)
and solve_greedy (deterministic and tie-noise, spec dedup through `sig`,
padded pod_valid, contention, the (free, count, nz) carry). A scalar walk
written like csrc/solver.cu (one pod at a time, lexicographic (score,
noise, -node) pick) is held to the same reference, so the kernel's
algorithm is checked here even though the kernel itself runs only on the
card. Tolerance: exact equality (integers; noise compared bitwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import solver as RSO

from kubernetes_tpu_torch.ops import solver as PSO


def problem(seed, U=8, N=24, R=3, B=64, ties=True):
    rng = np.random.default_rng(seed)
    return dict(
        mask=rng.random((U, N)) < 0.7,
        score=rng.integers(0, 3 if ties else 10**6, (U, N)).astype(np.int64),
        req=rng.integers(0, 3, (U, R)).astype(np.int64),
        free0=rng.integers(-1, 12, (N, R)).astype(np.int64),  # some overcommitted slots
        count0=rng.integers(0, 3, N).astype(np.int64),
        allowed=rng.integers(1, 6, N).astype(np.int64),
        sig=rng.integers(0, U, B).astype(np.int32),
        pod_valid=rng.random(B) < 0.85,
        priority=rng.integers(0, 3, B).astype(np.int32),
        nz0=rng.integers(0, 5, (N, 2)).astype(np.int64),
        scoring_req=rng.integers(0, 5, (U, 2)).astype(np.int64),
    )


def ref_solve(p, det, seed, chunk=16):
    B = p["sig"].shape[0]
    order = RSO.pop_order(jnp.asarray(p["priority"]), jnp.arange(B, dtype=jnp.int32), jnp.asarray(p["pod_valid"]))
    out, carry = RSO.solve_greedy(
        jnp.asarray(p["mask"]), jnp.asarray(p["score"]), jnp.asarray(p["req"]), jnp.asarray(p["free0"]),
        jnp.asarray(p["count0"]), jnp.asarray(p["allowed"]), order, jax.random.PRNGKey(seed),
        deterministic=det, req_any=jnp.asarray((p["req"] > 0).any(-1)), sig=jnp.asarray(p["sig"]),
        pod_valid=jnp.asarray(p["pod_valid"]), chunk=chunk, return_carry=True,
        nz0=jnp.asarray(p["nz0"]), scoring_req=jnp.asarray(p["scoring_req"]),
    )
    return np.asarray(out), [np.asarray(c) for c in carry]


def port_args(p):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    B = p["sig"].shape[0]
    order = PSO.pop_order(t["priority"], torch.arange(B, dtype=torch.int32), t["pod_valid"])
    return t, order


def test_prng_key_words_match_jax():
    for seed in (0, 7, 12345, 2**32 + 5):
        assert PSO.prng_key_data(seed) == tuple(int(x) for x in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 11])
def test_tie_noise_bit_identical(seed):
    ref = np.asarray(RSO.tie_noise(jax.random.PRNGKey(seed), 33, 70))
    port = PSO.tie_noise(PSO.prng_key_data(seed), 33, 70).numpy()
    assert port.dtype == np.float32
    assert np.array_equal(ref.view(np.uint32), port.view(np.uint32))


def test_pop_order_matches_lexsort():
    rng = np.random.default_rng(1)
    for _ in range(5):
        b = 100
        prio = rng.integers(-2, 3, b).astype(np.int32)
        seq = rng.permutation(b).astype(np.int32)
        valid = rng.random(b) < 0.8
        ref = np.asarray(RSO.pop_order(jnp.asarray(prio), jnp.asarray(seq), jnp.asarray(valid)))
        port = PSO.pop_order(torch.from_numpy(prio), torch.from_numpy(seq), torch.from_numpy(valid))
        assert np.array_equal(ref, port.numpy())


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_solve_greedy_matches_reference(det, seed):
    p = problem(seed, ties=seed % 2 == 0)
    ref, ref_carry = ref_solve(p, det, seed + 7)
    t, order = port_args(p)
    out, carry = PSO.solve_greedy(
        t["mask"], t["score"], t["req"], t["free0"], t["count0"], t["allowed"], order,
        PSO.prng_key_data(seed + 7), deterministic=det, req_any=(t["req"] > 0).any(-1),
        sig=t["sig"], pod_valid=t["pod_valid"], return_carry=True, nz0=t["nz0"],
        scoring_req=t["scoring_req"],
    )
    assert np.array_equal(ref, out.numpy())
    for a, b in zip(ref_carry, carry):
        assert np.array_equal(a, b.numpy())
    assert (ref >= 0).sum() > 10 and (ref[p["pod_valid"]] < 0).any()  # placements and contention
    assert (ref[~p["pod_valid"]] == -1).all()


def test_solve_greedy_defaults_identity_sig():
    p = problem(9, U=16, B=16)
    p["sig"] = np.arange(16, dtype=np.int32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(RSO.solve_greedy(
        jnp.asarray(p["mask"]), jnp.asarray(p["score"]), jnp.asarray(p["req"]), jnp.asarray(p["free0"]),
        jnp.asarray(p["count0"]), jnp.asarray(p["allowed"]), jnp.arange(16, dtype=jnp.int32), key,
    ))
    t, _ = port_args(p)
    port = PSO.solve_greedy(t["mask"], t["score"], t["req"], t["free0"], t["count0"], t["allowed"],
                            torch.arange(16), PSO.prng_key_data(3))
    assert np.array_equal(ref, port.numpy())


def sequential_walk(p, order, det, key):
    """The kernel's algorithm (csrc/solver.cu), one pod at a time."""
    free, count, nz = p["free0"].copy(), p["count0"].copy(), p["nz0"].copy()
    req_any = (p["req"] > 0).any(-1)
    noise = PSO.tie_noise_bits(key, len(order), p["mask"].shape[1]).numpy()
    out = np.full(len(order), -1, np.int32)
    for rank, pos in enumerate(order):
        if not p["pod_valid"][pos]:
            continue
        s = p["sig"][pos]
        best = None
        for n in range(p["mask"].shape[1]):
            if not p["mask"][s, n] or count[n] + 1 > p["allowed"][n]:
                continue
            if req_any[s] and not (p["req"][s] <= free[n]).all():
                continue
            cand = (p["score"][s, n], 0 if det else noise[rank, n], -n)
            if best is None or cand > best:
                best = cand
        if best is not None:
            n = -best[2]
            out[pos] = n
            free[n] -= p["req"][s]
            count[n] += 1
            nz[n] += p["scoring_req"][s]
    return out, [free, count, nz]


@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [4, 5, 6])
def test_sequential_walk_equals_chunked_reference(det, seed):
    p = problem(seed, ties=True)
    ref, ref_carry = ref_solve(p, det, seed)
    _, order = port_args(p)
    walk, carry = sequential_walk(p, order.numpy(), det, PSO.prng_key_data(seed))
    assert np.array_equal(ref, walk)
    for a, b in zip(ref_carry, carry):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# in-batch anti-affinity / host-port tracking (`inb`)
# ---------------------------------------------------------------------------


def inb_problem(seed, case="random", U=8, N=24, TT=10, K=3, B=64):
    """A solve problem plus the raw in-batch inputs: required anti terms
    (owner, key slot, which spec rows each matches), the node bank's dense
    topology buckets, and the spec-pair port clashes. "all-anti": every
    spec owns a hostname-keyed anti term (one bucket per node) matching
    every spec, so a chunk's pods land in distinct buckets and the pairwise
    barrier must let them commit together; "ports": every spec clashes with
    every spec and nothing else constrains."""
    p = problem(seed, U=U, N=N, B=B, ties=True)
    p["free0"] = np.abs(p["free0"]) + 6  # room for many pods: the in-batch masks decide
    p["allowed"] = p["allowed"] + 4
    rng = np.random.default_rng(seed + 100)
    ld = rng.integers(-1, 4, (N, K)).astype(np.int32)
    ld[:, 0] = np.arange(N)  # slot 0: a hostname-like key, one bucket per node
    inb = dict(
        anti=rng.random(TT) < 0.7,
        owner=rng.integers(0, U, TT).astype(np.int32),
        m_bb=rng.random((TT, U)) < 0.3,
        topo_slot=rng.integers(-1, K, TT).astype(np.int32),
        label_dense=ld,
        port_conflict=rng.random((U, U)) < 0.15,
    )
    if case == "all-anti":
        inb["anti"] = np.ones(U, bool)
        inb["owner"] = np.arange(U, dtype=np.int32)
        inb["m_bb"] = np.ones((U, U), bool)
        inb["topo_slot"] = np.zeros(U, np.int32)
        inb["port_conflict"] = np.zeros((U, U), bool)
        p["mask"] = np.ones_like(p["mask"])
    elif case == "ports":
        inb["anti"] = np.zeros(TT, bool)
        inb["port_conflict"] = np.ones((U, U), bool)
    v = int(ld.max()) + 1
    return p, inb, max(v, 16)


def ref_inb(inb, v, N, U):
    import kubernetes_tpu.ops.topology as RTopo

    bucket, haskey = RTopo._bucket_of({"label_dense": jnp.asarray(inb["label_dense"])}, jnp.asarray(inb["topo_slot"]))
    tt = inb["anti"].shape[0]
    return dict(
        anti=jnp.asarray(inb["anti"]), owner=jnp.asarray(inb["owner"]), m_bb=jnp.asarray(inb["m_bb"]),
        bucket_n=bucket, haskey_n=haskey, port_conflict=jnp.asarray(inb["port_conflict"]),
        ca0=jnp.zeros((tt, v), jnp.float32), cb0=jnp.zeros((tt, v), jnp.float32),
        cs0=jnp.zeros((U, N), jnp.float32),
    )


def port_inb(inb, v):
    out = {k: torch.from_numpy(x) for k, x in inb.items()}
    out["n_buckets"] = v
    return out


@pytest.mark.parametrize("case", ["random", "all-anti", "ports"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
@pytest.mark.parametrize("seed", [0, 1])
def test_solve_greedy_inb_matches_reference(case, det, seed):
    p, inb, v = inb_problem(seed, case)
    U, N = p["mask"].shape
    B = p["sig"].shape[0]
    order = RSO.pop_order(jnp.asarray(p["priority"]), jnp.arange(B, dtype=jnp.int32), jnp.asarray(p["pod_valid"]))
    ref, ref_carry = RSO.solve_greedy(
        jnp.asarray(p["mask"]), jnp.asarray(p["score"]), jnp.asarray(p["req"]), jnp.asarray(p["free0"]),
        jnp.asarray(p["count0"]), jnp.asarray(p["allowed"]), order, jax.random.PRNGKey(seed),
        deterministic=det, req_any=jnp.asarray((p["req"] > 0).any(-1)), sig=jnp.asarray(p["sig"]),
        pod_valid=jnp.asarray(p["pod_valid"]), chunk=16, return_carry=True,
        nz0=jnp.asarray(p["nz0"]), scoring_req=jnp.asarray(p["scoring_req"]), inb=ref_inb(inb, v, N, U),
    )
    ref = np.asarray(ref)
    t, porder = port_args(p)
    out, carry = PSO.solve_greedy_plain(
        t["mask"], t["score"], t["req"], t["free0"], t["count0"], t["allowed"], porder,
        PSO.prng_key_data(seed), deterministic=det, req_any=(t["req"] > 0).any(-1), sig=t["sig"],
        pod_valid=t["pod_valid"], chunk=16, return_carry=True, nz0=t["nz0"],
        scoring_req=t["scoring_req"], inb=port_inb(inb, v),
    )
    assert np.array_equal(ref, out.numpy())
    for a, b in zip(ref_carry, carry):
        assert np.array_equal(np.asarray(a), b.numpy())
    # the tracking binds: without it some pods land elsewhere
    free = PSO.solve_greedy_plain(
        t["mask"], t["score"], t["req"], t["free0"], t["count0"], t["allowed"], porder,
        PSO.prng_key_data(seed), deterministic=det, req_any=(t["req"] > 0).any(-1), sig=t["sig"],
        pod_valid=t["pod_valid"], chunk=16,
    )
    assert not np.array_equal(free.numpy(), ref)
    assert (ref >= 0).sum() > 5
    if case == "all-anti":  # one pod per node at most: every spec's term matches every spec
        placed = ref[ref >= 0]
        assert len(placed) == len(set(placed.tolist())) == N


def sequential_walk_inb(p, order, det, key, inb, v):
    """The tracked kernel's algorithm (csrc/solver.cu), one pod at a time:
    (A) my anti term vs earlier commits it matches, (B) earlier commits'
    anti terms vs me, (P) a clashing host port on the node."""
    free, count, nz = p["free0"].copy(), p["count0"].copy(), p["nz0"].copy()
    req_any = (p["req"] > 0).any(-1)
    noise = PSO.tie_noise_bits(key, len(order), p["mask"].shape[1]).numpy()
    ld, slot = inb["label_dense"], inb["topo_slot"]
    tt = len(inb["anti"])
    ca, cb = np.zeros((tt, v), np.int64), np.zeros((tt, v), np.int64)
    cs = np.zeros(p["mask"].shape, np.int64)

    def bucket(n, t):
        d = ld[n, 0 if slot[t] < 0 else min(slot[t], ld.shape[1] - 1)]
        return d if (d >= 0 and slot[t] >= 0 and d < v) else -1

    out = np.full(len(order), -1, np.int32)
    for rank, pos in enumerate(order):
        if not p["pod_valid"][pos]:
            continue
        s = p["sig"][pos]
        own = [t for t in range(tt) if inb["anti"][t] and inb["owner"][t] == s]
        match = [t for t in range(tt) if inb["anti"][t] and inb["m_bb"][t, s]]
        conf = np.flatnonzero(inb["port_conflict"][s])
        best = None
        for n in range(p["mask"].shape[1]):
            if not p["mask"][s, n] or count[n] + 1 > p["allowed"][n]:
                continue
            if req_any[s] and not (p["req"][s] <= free[n]).all():
                continue
            if any(bucket(n, t) >= 0 and ca[t, bucket(n, t)] > 0 for t in own):
                continue
            if any(bucket(n, t) >= 0 and cb[t, bucket(n, t)] > 0 for t in match):
                continue
            if (cs[conf, n] > 0).any():
                continue
            cand = (p["score"][s, n], 0 if det else noise[rank, n], -n)
            if best is None or cand > best:
                best = cand
        if best is not None:
            n = -best[2]
            out[pos] = n
            free[n] -= p["req"][s]
            count[n] += 1
            nz[n] += p["scoring_req"][s]
            for t in match:
                if bucket(n, t) >= 0:
                    ca[t, bucket(n, t)] += 1
            for t in own:
                if bucket(n, t) >= 0:
                    cb[t, bucket(n, t)] += 1
            cs[s, n] += 1
    return out, [free, count, nz]


@pytest.mark.parametrize("case", ["random", "all-anti", "ports"])
@pytest.mark.parametrize("det", [True, False], ids=["deterministic", "noise"])
def test_sequential_walk_inb_equals_chunked_plain(case, det):
    """The tracked kernel's one-pod-at-a-time walk equals the chunked,
    barrier-serialized plain version (itself held to the reference above)."""
    p, inb, v = inb_problem(7, case)
    t, porder = port_args(p)
    want, want_carry = PSO.solve_greedy_plain(
        t["mask"], t["score"], t["req"], t["free0"], t["count0"], t["allowed"], porder,
        PSO.prng_key_data(7), deterministic=det, req_any=(t["req"] > 0).any(-1), sig=t["sig"],
        pod_valid=t["pod_valid"], chunk=16, return_carry=True, nz0=t["nz0"],
        scoring_req=t["scoring_req"], inb=port_inb(inb, v),
    )
    walk, carry = sequential_walk_inb(p, porder.numpy(), det, PSO.prng_key_data(7), inb, v)
    assert np.array_equal(want.numpy(), walk)
    for a, b in zip(want_carry, carry):
        assert np.array_equal(a.numpy(), b)


def test_solve_layout_keeps_the_main_path_shapes_resident():
    """Where csrc/solver.cu keeps its state: the config-2, config-3 and
    config-5 batches (B = 4,096) over the single-device cluster hold their
    CTA's residuals and the choices in shared memory; an N that is no
    multiple of S pads the last CTA's rows; more than 2,048 rows a CTA, or
    more bytes than a CTA's budget, take the device-memory path; the
    tracked solve's ca / cb replicas join them only where both fit."""
    s = PSO.SOLO_SHARDS
    for n in (6144, 10240, 2048):
        lay = PSO.solve_layout(n, 8, 4096, s)
        rows = -(-n // s)
        assert lay == {"rows": rows, "resident": True, "track_shared": False, "smem": 12 * rows * 8 + 4096 * 4}
        assert lay["smem"] <= PSO.SOLVE_SMEM_BUDGET
    assert PSO.solve_layout(517, 8, 700, 16)["rows"] == 33
    big = PSO.solve_layout(40000, 8, 512, 16)
    assert big["rows"] == 2500 and not big["resident"] and big["smem"] == 0
    assert not PSO.solve_layout(16 * 2000, 32, 65536, 16)["resident"]  # rows fit the threads, bytes do not
    tracked = PSO.solve_layout(2048, 8, 4096, s, tt=32, u=32, v=2048, track=True)
    assert tracked["resident"] and not tracked["track_shared"]
    assert tracked["smem"] == 12 * (2048 // s) * 8 + 4096 * 4 + (2 * 32 + 32) * 4
    small = PSO.solve_layout(300, 8, 640, s, tt=16, u=64, v=64, track=True)
    rows = -(-300 // s)
    assert small["track_shared"] and small["smem"] == 12 * rows * 8 + 640 * 4 + (2 * 16 + 64) * 4 + 2 * 16 * 64 * 4
