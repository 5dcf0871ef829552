"""The node-sharded commit fold on one element grid, on the CPU.

On one card the shards are row ranges of one bank, so the sharded commit
launches the single fold's element grid, each element read once: a row in
[0, N) lies in exactly one shard and adds at the same address, and any
other row belongs to no shard. `fold_walk` (tests/test_torch_fold.py)
walks that kernel in numpy over the packed program; here it runs at S = 1,
2, 4 and 8 on programs whose rows sit on
the shard boundaries, beside padding sentinels and negative rows, against
the port's `fold_commit_sharded_plain` (the shard axis written out), its
packed CPU path and the reference's `make_sharded_fold_fns` on the
8-virtual-device mesh (`ref_mesh`, tests/test_torch_parallel.py).
Tolerance: exact equality; every value is an integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import fold as RFold

from kubernetes_tpu_torch.ops.fold import fold_commit_packed, fold_commit_sharded_plain, fold_control
from test_torch_fold import BANKS, PROGRAM, fold_walk
from test_torch_parallel import pytestmark, ref_mesh  # noqa: F401  (the skip and the fixture)

N = 64


def _boundary_case(seed, shards, r=4, s=10, pt=6, b=96, t=48):
    """Banks near the int16 edges and a program whose lanes and triples
    sit on every shard's first and last rows and just past them, beside
    the padding sentinel N and negative rows (inside the live prefix, so
    the walk reads and drops them); the signature and pattern columns take
    their sentinels too."""
    rng = np.random.default_rng(seed)
    nl = N // shards
    edges = sorted({x for lo in range(0, N, nl) for x in (lo - 1, lo, lo + 1, lo + nl - 1) if 0 <= x < N})
    rows_pool = np.array(edges + [N, -1, -5], np.int32)
    banks = {
        "requested": rng.integers(0, 1 << 40, (N, r)).astype(np.int64),
        "nonzero_req": rng.integers(0, 1 << 30, (N, 2)).astype(np.int64),
        "pod_count": rng.integers(0, 100, N).astype(np.int32),
        "sig_counts": rng.integers(-32768, 32768, (N, s)).astype(np.int16),
        "pat_counts": rng.integers(-32768, 32768, (N, pt)).astype(np.int16),
    }
    rows = rng.choice(rows_pool, b).astype(np.int32)
    rows[-1] = edges[-1]  # the live prefix holds every lane
    pat_row = rng.choice(rows_pool, t).astype(np.int32)
    pat_row[-1] = edges[0]
    ctl = {
        "rows": rows, "req": rng.integers(-1000, 1000, (b, r)).astype(np.int64),
        "nz": rng.integers(0, 1000, (b, 2)).astype(np.int64),
        "cnt": rng.integers(-2, 3, b).astype(np.int32), "sig": rng.integers(0, s + 1, b).astype(np.int32),
        "pat_row": pat_row, "pat_col": rng.integers(0, pt + 1, t).astype(np.int32),
        "pat_cnt": rng.integers(-3, 4, t).astype(np.int16),
    }
    return banks, ctl


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_one_grid_shard_derivation_equals_plain_and_reference(shards, ref_mesh):
    """Each element read once whatever S; a row on either side of a shard
    boundary adds where its own shard would, a sentinel or negative row
    nowhere; the single fold's walk equals the plain sharded fold, the
    packed CPU path and the reference's shard_map'd commit fold."""
    banks, ctl = _boundary_case(shards, shards)
    nl = N // shards
    in_range = ctl["rows"][(ctl["rows"] >= 0) & (ctl["rows"] < N)]
    assert set(in_range // nl) == set(range(shards))  # lanes on every shard
    assert ((ctl["rows"] == N) | (ctl["rows"] < 0)).any()
    packed = fold_control(**ctl, n=N)
    assert packed.b == ctl["rows"].shape[0] and packed.t == ctl["pat_row"].shape[0]
    got, seen, _ = fold_walk(banks, packed)
    r = banks["requested"].shape[1]
    assert seen == list(range(packed.b * (r + 4) + packed.t))
    tb = {k: torch.from_numpy(v.copy()) for k, v in banks.items()}
    plain = fold_commit_sharded_plain(shards, *(tb[k] for k in BANKS), *(torch.from_numpy(ctl[k]) for k in PROGRAM))
    cpu = {k: torch.from_numpy(v.copy()) for k, v in banks.items()}
    fold_commit_packed(*(cpu[k] for k in BANKS), packed, shards=shards)
    commit, _ = RFold.make_sharded_fold_fns(ref_mesh(shards))
    ref = commit(*(jnp.asarray(banks[k]) for k in BANKS), *(jnp.asarray(ctl[k]) for k in PROGRAM))
    for k, p, rf in zip(BANKS, plain, ref):
        want = np.asarray(rf)
        assert np.array_equal(got[k], want) and np.array_equal(p.numpy(), want), k
        assert np.array_equal(cpu[k].numpy(), want), k
