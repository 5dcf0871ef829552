"""The in-batch host-port table as the match launch's port slice, on the
CPU.

csrc/topology.cu computes the [U, U] spec-pair port table of the solve's
in-batch tracking and the commit arbiter (the reference's
`_inbatch_tensors` port_conflict) as one slice of the batch's match
launch. `port_table_walk` walks that slice in numpy as `port_layout` and
`match_grid` lay it out: CTA tiles of spec rows x columns, each tile row's
and column's live lanes compacted in one pass with its live count, a cell
a thread, pairs without a live lane false without a test, one store of 16
bytes a half-warp's 16 columns where U is a multiple of 16 and byte
stores otherwise. Held, with exact
equality: the walk against `inbatch_port_conflict_plain` and the JAX
reference (its port_clash reduction on seeded port lists with wildcard and
equal IPs; its `_inbatch_tensors` on encoded clusters); the match plan and
`_inbatch_tensors` taking the table from the same launch; the arbiter's
`_solve_inputs` (`m_raw`, `pconf`) on a port-bearing preemption cluster
against the reference; and the launch's layout, grid and shared memory
with a port problem, the port-only launch included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as RT
from kubernetes_tpu.ops import filters as RF
from kubernetes_tpu.ops import pipeline as RP
from kubernetes_tpu.state.cache import SchedulerCache as RCache
from kubernetes_tpu.state.cache import TensorMirror as RMirror
from kubernetes_tpu.state.tensors import PodBatch as RPodBatch
from kubernetes_tpu.state.terms import compile_batch_terms as r_compile

from kubernetes_tpu_torch.api import types as PT
from kubernetes_tpu_torch.commit import arbiter as PA
from kubernetes_tpu_torch.models.clusters import fill_cache
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.ops import pipeline as PP
from kubernetes_tpu_torch.ops import topology as PTopo
from kubernetes_tpu_torch.state.cache import SchedulerCache as PCache
from kubernetes_tpu_torch.state.cache import TensorMirror as PMirror
from kubernetes_tpu_torch.state.convert import arrays_to_torch
from kubernetes_tpu_torch.state.tensors import PodBatch as PPodBatch
from kubernetes_tpu_torch.state.terms import compile_batch_terms as p_compile
from test_torch_interpod import both, encoded
from test_torch_oracle import _terms_cluster

WILD, IP_A, IP_B = 7, 11, 12


def port_rows(seed, u, pp=8):
    """Spec-row port lists [U, PP]: about a third of the rows hold one to
    three live ports at scattered lanes (so a row's compaction moves them),
    from three numbers and two protocols, each IP the wildcard or one of
    two addresses (equal IPs clash, different ones do not); padding lanes
    (port 0) carry stray protocol and IP ids, which no test may read."""
    rng = np.random.default_rng(seed)
    num = np.zeros((u, pp), np.int32)
    proto = rng.integers(0, 6, (u, pp)).astype(np.int32)
    ip = rng.integers(0, 14, (u, pp)).astype(np.int32)
    for r in range(u):
        if rng.random() < 0.35:
            lanes = rng.choice(pp, int(rng.integers(1, 4)), replace=False)
            num[r, lanes] = rng.choice([80, 443, 8080], len(lanes))
            proto[r, lanes] = rng.choice([3, 4], len(lanes))
            ip[r, lanes] = rng.choice([WILD, IP_A, IP_B], len(lanes))
    return {"port_num": torch.from_numpy(num), "port_proto": torch.from_numpy(proto),
            "port_ip": torch.from_numpy(ip)}


def reference_table(pods, wild):
    """The reference's reduction of its port_clash over both lists
    (kubernetes_tpu/ops/pipeline.py:_inbatch_tensors)."""
    p = {k: jnp.asarray(pods[k].numpy()) for k in ("port_num", "port_proto", "port_ip")}
    return np.asarray(jnp.any(RF.port_clash(
        p["port_num"][:, None, :, None], p["port_proto"][:, None, :, None], p["port_ip"][:, None, :, None],
        p["port_num"][None, :, None, :], p["port_proto"][None, :, None, :], p["port_ip"][None, :, None, :],
        wild), axis=(2, 3)))


def _lists_clash(a, b, wild):
    """common.cuh's port_lists_clash over two lists of (num, proto, ip)."""
    for na, pa, ia in a:
        if na <= 0:
            continue
        for nb, pb, ib in b:
            if nb > 0 and nb == na and pb == pa and (ia == wild or ib == wild or ia == ib):
                return True
    return False


def port_table_walk(pods, wild, tile=None, terms=()):
    """csrc/topology.cu's port slice, CTA by CTA of the launch's x-y plane
    (beside term problems of (TT, X, xtile), whose plane the layout fits
    its tiles to), each CTA's threads in the order the kernel gives them
    cells, a thread taking the next cell THREADS on. Returns
    (the [U, U] table, {"vector": 16-byte stores, "scalar": byte stores,
    "tests": live pairs tested, "skipped": pairs false without a test,
    "staged": spec rows staged}); checks that every cell is written once,
    that a half-warp's 16 cells are one row's 16 consecutive columns, and
    that every 16-byte store is 16-byte aligned (a torch allocation's base
    is)."""
    num, proto, ip = (pods[k].numpy() for k in ("port_num", "port_proto", "port_ip"))
    u, pp = num.shape
    plane = PTopo.match_grid(terms) if terms else None
    lay = PTopo.port_layout(u, pp, plane and plane[0] * plane[1], tile)
    nrows, ncols = lay["rows"], lay["cols"]
    assert ncols % 16 == 0 and lay["smem"] == (16 * pp + 4) * (nrows + ncols) <= PTopo.PORT_SMEM_MAX
    gx, gy, gz = PTopo.match_grid(terms, lay)
    assert gz == len(terms) + 1 and gx * gy >= lay["tiles"] == -(-u // nrows) * -(-u // ncols)
    col_tiles = -(-u // ncols)
    vec = u % 16 == 0
    out = np.zeros(u * u, np.uint8)
    writes = np.zeros(u * u, np.int64)
    stats = {"vector": 0, "scalar": 0, "tests": 0, "skipped": 0, "staged": 0}

    def stage(row):  # one pass over the row's lanes: the live ones compacted, and their count
        live = [(int(num[row, k]), int(proto[row, k]), int(ip[row, k])) for k in range(pp) if num[row, k] > 0]
        stats["staged"] += 1
        return live

    for tile_i in range(gx * gy):
        if tile_i >= lay["tiles"]:
            continue
        r0, c0 = (tile_i // col_tiles) * nrows, (tile_i % col_tiles) * ncols
        nr, nc = min(nrows, u - r0), min(ncols, u - c0)
        rows = [stage(r0 + t) for t in range(nr)]
        cols = [stage(c0 + t) for t in range(nc)]
        for i0 in range(0, nrows * ncols, 256):
            for half in range(0, 256, 16):  # the half-warps: 16 threads, 16 cells
                cells = []
                for t in range(half, half + 16):
                    i = i0 + t
                    r, c = divmod(i, ncols)
                    if i >= nrows * ncols or r >= nr or c >= nc:
                        cells.append(None)
                        continue
                    if not rows[r] or not cols[c]:
                        stats["skipped"] += 1
                        hit = False
                    else:
                        stats["tests"] += 1
                        hit = _lists_clash(rows[r], cols[c], wild)
                    cells.append((r, c, hit))
                live = [x for x in cells if x is not None]
                if not live:
                    continue
                if vec:
                    assert len(live) == 16 and len({r for r, _, _ in live}) == 1
                    r, c, _ = live[0]
                    assert [x[1] for x in live] == list(range(c, c + 16))
                    off = (r0 + r) * u + c0 + c
                    assert off % 16 == 0
                    stats["vector"] += 1
                    out[off:off + 16] = [x[2] for x in live]
                    writes[off:off + 16] += 1
                else:
                    for r, c, hit in live:
                        off = (r0 + r) * u + c0 + c
                        stats["scalar"] += 1
                        out[off] = hit
                        writes[off] += 1
    assert (writes == 1).all()
    return out.reshape(u, u).astype(bool), stats


TILES = [None, (8, 32), (32, 16), (128, 128)]


@pytest.mark.parametrize("tile", TILES, ids=["default", "8x32", "32x16", "128x128"])
@pytest.mark.parametrize("u", [16, 32, 40, 48, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_slice_walk_equals_plain_and_reference(seed, u, tile):
    """The slice's tiles, compaction, rows without lanes and stores (16
    bytes where U is a multiple of 16, a byte at a time at U = 40) give the
    plain version's and the reference's table; live pairs alone are
    tested; wildcard and equal IPs clash, different IPs do not."""
    pods = port_rows(seed, u)
    got, st = port_table_walk(pods, WILD, tile)
    want = PF.inbatch_port_conflict_plain(pods, {"wildcard_ip": WILD}).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, reference_table(pods, WILD))
    live = int((pods["port_num"] > 0).any(dim=1).sum())
    assert st["tests"] == live * live and st["skipped"] == u * u - live * live
    assert (st["vector"] == u * u // 16 and st["scalar"] == 0) if u % 16 == 0 else (st["vector"] == 0)
    lay = PTopo.port_layout(u, 8, tile=tile)
    assert st["staged"] == sum(min(lay["rows"], u - r0) + min(lay["cols"], u - c0)
                               for r0 in range(0, u, lay["rows"]) for c0 in range(0, u, lay["cols"]))
    assert want.any() and not want.all() and (want == want.T).all()
    num, ip = pods["port_num"].numpy(), pods["port_ip"].numpy()
    assert ((num > 0) & (ip == WILD)).any() and ((num > 0) & (ip == IP_A)).any()


# term problems of (TT, X, xtile) beside the table: config 3-hard's
# arbiter inputs (m_raw, U = TT = 128: a 2 x 16 plane) and a 1 x 4 plane
PLANES = {"m_raw": lambda u: [(u, u, 64)], "narrow": lambda u: [(32, 64, 64)]}


@pytest.mark.parametrize("plane", sorted(PLANES))
@pytest.mark.parametrize("u", [32, 48, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_port_slice_fitted_to_the_term_plane_walk_equals_plain(seed, u, plane):
    """Beside term problems the slice's tiles widen (columns, then rows,
    up to PORT_CELLS cells a CTA) until they fit the term problems' x-y
    plane, so the launch's grid is the term problems' own unless a CTA
    could take no wider tile (U = 128 on the 1 x 4 plane); the walk, a
    thread taking up to four cells, equals the plain version and the
    reference."""
    pods = port_rows(seed, u)
    terms = PLANES[plane](u)
    got, st = port_table_walk(pods, WILD, terms=terms)
    want = PF.inbatch_port_conflict_plain(pods, {"wildcard_ip": WILD}).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, reference_table(pods, WILD))
    gx, gy, _ = PTopo.match_grid(terms)
    lay = PTopo.port_layout(u, 8, gx * gy)
    assert lay["rows"] * lay["cols"] <= PTopo.PORT_CELLS
    fits = lay["tiles"] <= gx * gy
    assert fits or 2 * lay["rows"] * lay["cols"] > PTopo.PORT_CELLS  # x grows only past a CTA's cells
    assert fits == (u < 128 or plane == "m_raw")
    assert PTopo.match_grid(terms, lay) == (gx if fits else -(-lay["tiles"] // gy), gy, 2)


@pytest.mark.parametrize("pp", [120, 400])
@pytest.mark.parametrize("u", [16, 32])
def test_port_slice_walk_with_long_port_lists(u, pp):
    """Long port lists: the tile's rows halve (down to one) while its
    lanes pass PORT_SMEM, and at PP = 400 one row's lanes beside 16
    columns' take more than 48 KB (the launch raises its shared memory);
    the walk equals the plain version and the reference."""
    pods = port_rows(u + pp, u, pp)
    got, _ = port_table_walk(pods, WILD)
    want = PF.inbatch_port_conflict_plain(pods, {"wildcard_ip": WILD}).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, reference_table(pods, WILD))
    lay = PTopo.port_layout(u, pp)
    assert lay["rows"] < 16 and (lay["smem"] <= PTopo.PORT_SMEM or lay["rows"] == 1)
    assert (lay["smem"] > PTopo.PORT_SMEM) == (pp == 400)


@pytest.mark.parametrize("seed", [0, 1])
def test_port_slice_walk_on_encoded_clusters(seed):
    """On the inter-pod clusters' encoded spec rows (U = 64, the
    encoder's padding, host ports from the generator) the walk equals the
    reference's `_inbatch_tensors` port_conflict."""
    (rn, _, _, rt, _, rp), (_, _, _, _, _, pp) = both(seed)
    ids = encoded("port", seed)[6]
    want = np.asarray(RP._inbatch_tensors(rn, rp, rt, {k: jnp.asarray(v) for k, v in ids.items()}, 16)
                      ["port_conflict"])
    got, _ = port_table_walk(pp, ids["wildcard_ip"])
    assert np.array_equal(got, want) and want.any()


def test_port_layout_and_grid():
    """The slice's layout and the launch's grid and shared memory as
    ktpu_match_terms sizes them: the port slice last in z, its tiles in
    the first CTAs of the x-y plane (x grown where the term problems' plane
    is smaller), the smem the larger of the term problems' and the
    slice's; a port-only launch is one slice. Beside term problems the
    tiles widen to fit their plane; x grows only where a CTA could not
    take the wider tile."""
    assert PTopo.port_layout(32, 8) == {"rows": 16, "cols": 16, "tiles": 4, "smem": 132 * 32}
    assert PTopo.port_layout(128, 8)["tiles"] == 64
    assert PTopo.port_layout(128, 8, tile=(128, 128))["tiles"] == 1  # one CTA covers U = 128
    assert PTopo.port_layout(40, 8, tile=(64, 64)) == {"rows": 40, "cols": 48, "tiles": 1, "smem": 132 * 88}
    for bad in ((16, 8), (16, 24), (0, 16)):
        with pytest.raises(ValueError):
            PTopo.port_layout(64, 8, tile=bad)
    with pytest.raises(ValueError):
        PTopo.port_layout(0, 8)
    # long port lists: fewer rows a tile, then past PORT_SMEM, then refused
    assert PTopo.port_layout(64, 120)["rows"] == 8 and PTopo.port_layout(64, 400)["rows"] == 1
    assert PTopo.port_layout(1024, 8, tile=(256, 256))["rows"] == 64
    assert PTopo.port_layout(64, 827)["smem"] <= PTopo.PORT_SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        PTopo.port_layout(64, 828)
    # term problems of (TT, X, xtile): config 4's plan (m_sig, m_pt, m_bb)
    terms = [(32, 256, 64), (32, 32, 64), (32, 32, 64)]
    assert PTopo.match_grid(terms) == (4, 4, 3)
    lay = PTopo.port_layout(32, 8, 16)
    assert (lay["rows"], lay["cols"]) == (16, 16)  # 4 tiles: the plane has room, the tile stays
    assert PTopo.match_grid(terms, lay) == (4, 4, 4)
    # config 3-hard's arbiter inputs (m_raw, U = TT = 128): a 2 x 16 plane
    # takes 32 tiles of 16 x 32, not 64 of 16 x 16 on a grid grown to 4 x 16
    lay = PTopo.port_layout(128, 8, 32)
    assert (lay["rows"], lay["cols"], lay["tiles"]) == (16, 32, 32)
    assert PTopo.match_grid([(128, 128, 64)], lay) == (2, 16, 2)
    assert PTopo.match_grid([(128, 128, 64)], PTopo.port_layout(128, 8)) == (4, 16, 2)
    # U = 512 beside a plane of 32: 16 x 64 tiles (PORT_CELLS), 256 of them, x grown
    lay = PTopo.port_layout(512, 8, 32)
    assert (lay["rows"], lay["cols"], lay["tiles"]) == (16, 64, 256)
    assert PTopo.match_grid([(128, 128, 64)], lay) == (16, 16, 2)
    assert PTopo.match_grid([], PTopo.port_layout(128, 8)) == (64, 1, 1)  # port-only
    assert PTopo.match_grid([], PTopo.port_layout(16, 8)) == (1, 1, 1)


def _preemption_arrays(seed):
    """(na, ea, ta, pa, ids, v) of a port-bearing preemption cluster with
    terms (tests/test_torch_oracle._terms_cluster), through each package's
    mirror and batch encoders: numpy for the reference, torch for the
    port."""
    out = {}
    for pkg, t, cache_t, mirror_t, batch_t, compile_t in (
            ("ref", RT, RCache, RMirror, RPodBatch, r_compile),
            ("port", PT, PCache, PMirror, PPodBatch, p_compile)):
        nodes, existing, pending, _ = _terms_cluster(seed, t)
        cache = cache_t()
        fill_cache(cache, nodes, existing)
        mirror = mirror_t(cache) if pkg == "ref" else mirror_t(cache, device="cpu")
        batch = batch_t(mirror.vocab, 64)
        for i, p in enumerate(pending):
            batch.set_pod(i, p)
        tb, _ = compile_t(mirror.vocab, pending, b_capacity=64)
        ids = (RF if pkg == "ref" else PF).make_ids(mirror.vocab)
        out[pkg] = (mirror.nodes.arrays(), mirror.eps.arrays(), tb.arrays(), batch.arrays(),
                    {k: int(v) for k, v in ids.items()})
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_arbiter_solve_inputs_match_reference(seed):
    """The arbiter's `m_raw` and `pconf` (one match launch on the card;
    here the plain versions behind the same call), computed whole, from the
    plain path, or completing what the solve left, equal the reference's
    `_inbatch_tensors` m_bb and port_conflict on a port-bearing preemption
    cluster with terms."""
    enc = _preemption_arrays(seed)
    rn, _, rt, rp, rids = enc["ref"]
    want = RP._inbatch_tensors(*({k: jnp.asarray(x) for k, x in d.items()} for d in (rn, rp, rt)),
                               {k: jnp.asarray(x) for k, x in rids.items()}, 16)
    w_m, w_p = np.asarray(want["m_bb"]), np.asarray(want["port_conflict"])
    pn, pe, pt, pp, ids = enc["port"]
    na, ea, ta, pa = (arrays_to_torch(d, "cpu") for d in (pn, pe, pt, pp))
    assert w_p.any() and not w_p.all() and w_m.any()
    for plain in (False, True):
        for given in ({}, {"m_raw": torch.from_numpy(w_m.copy())}, {"pconf": torch.from_numpy(w_p.copy())}):
            got = PA._solve_inputs(na, pa, ea, ta, ids, given, False, 16, plain=plain)
            assert np.array_equal(got["m_raw"].numpy(), w_m) and np.array_equal(got["pconf"].numpy(), w_p)
    m_bb, pconf = PP.inbatch_matches(pa, ta, ids)
    assert np.array_equal(m_bb.numpy(), w_m) and np.array_equal(pconf.numpy(), w_p)
