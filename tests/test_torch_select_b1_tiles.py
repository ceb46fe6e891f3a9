"""Kernel 3 (``multi_area_select_from_tables``) as redesigned for the card:
kernel 13's tile body at one batch row, with the early-out of a row that
has no ok candidate.  A numpy model of the tiles at B = 1, held against
the port's plain version (``ops/route_select.py``
``multi_area_select_from_tables_plain``) and the JAX package's
``multi_area_select_from_tables`` (``openr_tpu/ops/route_select.py:267``).

* The mapping: a block takes a tile of ``fleet_select_tile_rows(1, P, A,
  sms, most=256)`` consecutive prefix rows (or a set tile); every row is
  computed once, the last tile shorter where the tile does not divide P.
* Phase 1, a thread per row: the row's cand_ok bytes first, then the
  chain over its ok candidates alone.  The model logs every cell a row
  reads: a row with no ok candidate (the candidate table's bucket
  padding) reads its cand_ok bytes and nothing else, and its outputs are
  the empty ones (use 0, shortest BIG, lanes 0, valid 0); a row with ok
  candidates reads no column of a slot that is not ok.  Then a thread per
  (row, area) pair: the min-cost winners and the shortest metric.
* Phase 2, the tile's lane span [rows, A, D], W bytes at a time (W the
  largest of 16, 8, 4 and 1 dividing D): the int32 sum over the pair's
  min-cost winners, then > 0.  Phase 3: valid and use.
* Inputs: seeded tables of 3 areas with a quarter of the rows padding, D
  of 1, 4, 6, 17 and 33 (most not a multiple of 4), C of 1, 4 and 64, both
  selection algorithms; and a 3-area world (a drained node, a soft-drained
  node, anycast across areas, a self-advertised prefix) through the
  port's candidate table, whose rows pad to the 64-row bucket.

The ``cuda`` cases run kernel 3 against its plain version on the same
inputs at the rule's tile and tiles of 7 and 16 rows, and on a lane table
that starts off a 16-byte boundary.  Tolerance: exact equality.  This
module imports no JAX at import time, so that its ``cuda`` cases run
where JAX is absent.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.backend import DEGREE_BUCKETS
from openr_tpu_torch.decision.cand_table import CandidateTable
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.emulation.topology import build_adj_dbs, grid_edges, random_connected_edges
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr
from openr_tpu_torch.ops import route_select as rs
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.types import PrefixEntry, PrefixMetrics

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
COLUMNS = ("area", "node", "ok", "drain", "ppref", "spref", "distance", "cnia")


def _bits(mask):
    c = 0
    while mask:
        if mask & 1:
            yield c
        mask >>= 1
        c += 1


class Row:
    """A prefix row's candidate columns, logging every (column, slot) read."""

    def __init__(self, cand, p):
        self.cand, self.p, self.reads = cand, p, set()

    def __call__(self, col, c, a=None):
        self.reads.add((col, c))
        x = self.cand[COLUMNS.index(col)][self.p, c]
        return x if a is None else x[a]


def row_use(row, C, dist, ovl, soft, per_area):
    """Phase 1, a thread per row: the ok bytes, then the chain over the ok
    candidates to the winner mask (0 where none is ok)."""
    ok = sum(1 << c for c in range(C) if row("ok", c))
    if not ok:
        return 0
    reach = nonhard = not_drained = 0
    for c in _bits(ok):
        a, n = int(row("area", c)), int(row("node", c))
        if dist[a, n] < BIG:
            reach |= 1 << c
            if not ovl[a, n]:
                nonhard |= 1 << c
        if not (row("drain", c) > 0 or soft[a, n] > 0):
            not_drained |= 1 << c
    use = nonhard or reach
    if use & not_drained:
        use &= not_drained
    for col in ("ppref", "spref"):
        best = max((int(row(col, c)) for c in _bits(use)), default=I32_MIN)
        use = sum(1 << c for c in _bits(use) if int(row(col, c)) == best)
    kept = 0
    for c in _bits(use):
        pool = [c2 for c2 in _bits(use) if not per_area or row("area", c2) == row("area", c)]
        if int(row("distance", c)) == min(int(row("distance", c2)) for c2 in pool):
            kept |= 1 << c
    return kept


def pair_winners(row, a, use, dist):
    """Phase 1, a thread per (row, area): (min-cost winners, shortest)."""
    shortest, reached = np.float32(BIG), 0
    if any(int(row("area", c)) == a for c in _bits(use)):
        for c in _bits(use):
            n = int(row("cnia", c, a))
            if n >= 0 and dist[a, n] < BIG:
                reached |= 1 << c
                shortest = min(shortest, dist[a, n])
    mc = sum(1 << c for c in _bits(reached) if dist[a, int(row("cnia", c, a))] == shortest)
    return mc, shortest


def tile_model(args, per_area, TP):
    """Kernel 3 tile by tile at B = 1: (use [P, C], shortest [P, A], lanes
    [P, A, D], valid [P, A]); checks every row once, and the early-out's
    reads and outputs."""
    dist, nh, ovl, soft, *cand = (np.asarray(x) for x in args)
    A, _V = dist.shape
    P, C = cand[0].shape
    D = nh.shape[-1]
    W = next(w for w in (16, 8, 4, 1) if D % w == 0)
    use_o = np.zeros((P, C), bool)
    short_o = np.zeros((P, A), np.float32)
    lanes_o = np.zeros((P, A, D), bool)
    valid_o = np.zeros((P, A), bool)
    seen = np.zeros(P, int)
    for p0 in range(0, P, TP):
        rows = range(p0, min(P, p0 + TP))
        log = {p: Row(cand, p) for p in rows}
        use_s = {p: row_use(log[p], C, dist, ovl, soft, per_area) for p in rows}
        mc_s, lit = {}, {}
        for p in rows:
            seen[p] += 1
            for a in range(A):
                mc_s[p, a], short_o[p, a] = pair_winners(log[p], a, use_s[p], dist)
                lit[p, a] = False
        span = lanes_o[p0:p0 + len(rows)].reshape(-1)
        for k in range(len(span) // W):
            pair, l0 = divmod(k * W, D)
            r, a = divmod(pair, A)
            p = p0 + r
            s = np.zeros(W, np.int32)
            for c in _bits(mc_s[p, a]):
                s += nh[a, int(log[p]("cnia", c, a)), l0:l0 + W].astype(np.int32)
            span[k * W:(k + 1) * W] = s > 0
            lit[p, a] |= bool((s > 0).any())
        for p in rows:
            valid_o[p] = [mc_s[p, a] != 0 and lit[p, a] for a in range(A)]
            use_o[p] = [(use_s[p] >> c) & 1 for c in range(C)]
            ok = cand[2][p]
            if not ok.any():  # the early-out: the ok bytes alone, the empty outputs
                assert log[p].reads == {("ok", c) for c in range(C)}
                assert not use_o[p].any() and not lanes_o[p].any() and not valid_o[p].any()
                assert (short_o[p] == np.float32(BIG)).all()
            else:
                assert all(ok[c] for col, c in log[p].reads if col != "ok")
    assert (seen == 1).all()
    return use_o, short_o, lanes_o, valid_o


# -- inputs ------------------------------------------------------------------------


def seeded(seed, A, V, D, P, C):
    """Seeded tables of A areas and candidates: hard-drained rows (0-7),
    soft-drained rows (8-15), a quarter of the rows padding as the
    candidate table pads them (not ok, area and node 0, cand_node_in_area
    -1), the other rows with empty slots; lane rows of the -128 fill."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 12, (A, V)).astype(np.float32)
    dist[rng.random((A, V)) < 0.2] = BIG
    nh = (rng.random((A, V, D)) < 0.4).astype(np.int8)
    nh[rng.random((A, V)) < 0.15] = -128
    ovl = rng.random((A, V)) < 0.2
    soft = np.where(rng.random((A, V)) < 0.2, 5, 0).astype(np.int32)
    area = rng.integers(0, A, (P, C)).astype(np.int32)
    node = rng.integers(0, V, (P, C)).astype(np.int32)
    ok = rng.random((P, C)) < 0.75
    ok[:, 0] = True
    ovl[area[:8], node[:8]] = True
    soft[area[8:16], node[8:16]] = 9
    drain = np.where(rng.random((P, C)) < 0.2, 1, 0).astype(np.int32)
    ppref = rng.choice([100, 200], (P, C)).astype(np.int32)
    spref = rng.choice([1, 2], (P, C)).astype(np.int32)
    dd = rng.choice([1, 2, 3], (P, C)).astype(np.int32)
    cnia = rng.integers(-1, V, (P, C, A)).astype(np.int32)
    cnia[np.arange(P)[:, None], np.arange(C)[None, :], area] = node
    pad = P - P // 4
    ok[pad:] = False
    area[pad:], node[pad:], cnia[pad:] = 0, 0, -1
    return [dist, nh, ovl, soft, area, node, ok, drain, ppref, spref, dd, cnia]


def three_area_world():
    """Three areas (a grid with a drained node, a ring with a soft-drained
    node, a random graph), 36 prefixes with anycast across areas,
    preferences, distances and a self-advertised prefix, through the
    port's candidate table (64 rows: 28 of bucket padding) and plain dense
    SPF tables."""
    me = "me"
    ring = [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
    area_edges = {
        "1": grid_edges(4, prefix="a") + [("a0", me, 1)],
        "2": ring + [("b0", me, 2), ("b3", me, 5)],
        "3": random_connected_edges(10, 6, seed=7, prefix="c") + [("c0", me, 1)],
    }
    drains = {"1": {"overloaded": ["a5"]}, "2": {"soft_drained": {"b2": 40}}, "3": {}}
    areas = {}
    for a, edges in area_edges.items():
        ls = LinkState(a, me)
        for db in build_adj_dbs(edges, area=a, **drains[a]).values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    ps = PrefixState()
    for i in range(16):
        ps.update_prefix(f"a{i}", "1", PrefixEntry(f"10.1.{i}.0/24"))
    for i in range(6):
        ps.update_prefix(f"b{i}", "2", PrefixEntry(f"10.2.{i}.0/24"))
    for i in range(10):
        ps.update_prefix(f"c{i}", "3", PrefixEntry(f"10.3.{i}.0/24"))
    for node, area, d in (("a15", "1", 3), ("b3", "2", 1), ("c9", "3", 2)):
        ps.update_prefix(node, area, PrefixEntry("10.9.0.0/16", metrics=PrefixMetrics(distance=d)))
    ps.update_prefix("a5", "1", PrefixEntry("10.8.0.0/16"))
    ps.update_prefix("b2", "2", PrefixEntry("10.8.0.0/16"))
    ps.update_prefix("c4", "3", PrefixEntry("10.7.0.0/16",
                                            metrics=PrefixMetrics(path_preference=900)))
    ps.update_prefix(me, "3", PrefixEntry("10.6.0.0/16"))
    enc = csr.encode_multi_area(areas, me)
    table = CandidateTable()
    table.full_sync(ps)
    cand = table.derived(enc).selection_inputs()
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    planes = tables_from_numpy(
        [getattr(enc, k) for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has",
                                   "overloaded", "roots")], "cpu")
    dist, nh = rs.multi_area_spf_tables_dense(*planes, max_degree=D)
    return [dist.numpy(), nh.numpy(), enc.overloaded, enc.soft, *cand]


#: (D, C, P): lane widths 1-33 (W = 1, 4 and 16; most not a multiple of 4),
#: 1, 4 and 64 candidates, P a multiple of no tile
CASES = [(1, 1, 60), (4, 4, 45), (6, 4, 50), (17, 64, 30), (33, 1, 61), (17, 4, 37)]


def _inputs(case):
    if case == "world":
        return three_area_world()
    D, C, P = case
    return seeded(D * 100 + C, 3, 24, D, P, C)


def _plain(args, per_area):
    return [t.numpy() for t in rs.multi_area_select_from_tables(
        *tables_from_numpy(args, "cpu"), per_area)]


def _jax(args, per_area):
    import jax.numpy as jnp
    from openr_tpu.ops.route_select import multi_area_select_from_tables as jax_select

    return [np.asarray(x) for x in jax_select(*(jnp.asarray(a) for a in args),
                                              per_area_distance=per_area)]


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


IDS = [f"D{d}-C{c}" for d, c, _p in CASES] + ["world"]


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("case", CASES + ["world"], ids=IDS)
def test_b1_tile_model_equals_plain_and_reference(case, per_area, tile):
    args = _inputs(case)
    P, C = args[4].shape
    A = args[0].shape[0]
    TP = rs.fleet_select_tile_rows(1, P, A, 132, most=256) if tile is None else tile
    got = tile_model(args, per_area, TP)
    want = _plain(args, per_area)
    _assert_same(got, want)
    _assert_same(got, _jax(args, per_area))
    ok = np.asarray(args[6])
    assert (~ok.any(axis=1)).any() and want[3].any()


def test_the_world_pads_to_its_row_bucket():
    """The world's 36 prefixes fill 36 of the table's 64 rows; the other 28
    have no ok candidate, and the world selects routes in every area."""
    args = three_area_world()
    ok = args[6]
    assert ok.shape[0] == 64 and int(ok.any(axis=1).sum()) == 36
    valid = _plain(args, False)[3]
    assert valid.any(axis=0).all()


def test_b1_tile_rule():
    """Kernel 3's rule keeps 256-row tiles where the rows give the card's
    SMs 4 blocks each (the grid's 1,048,576 rows: 4,096 blocks), and halves
    them to 16 below: a small table still spreads."""
    rows = lambda P, A: rs.fleet_select_tile_rows(1, P, A, 132, most=256)  # noqa: E731
    assert rows(1_048_576, 1) == 256
    assert rows(16_384, 1) == 16 and rows(64, 3) == 16 and rows(8, 1) == 8
    assert rs.fleet_select_tile_rows(1, 1_048_576, 1, 132) == 128  # kernel 13's cap


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _held(args, per_area):
    reset_launch_counts()
    got = rs.multi_area_select_from_tables(*args, per_area)
    torch.cuda.synchronize()
    assert LAUNCHES["multi_area_select_from_tables"] == 1
    want = rs.multi_area_select_from_tables_plain(*args, per_area)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[3].any())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, 7, 16])
@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("case", CASES + ["world"], ids=IDS)
def test_b1_select_tile_kernel_equals_plain(card, case, per_area, tile, monkeypatch):
    """Kernel 3 as kernel 13's tiles at one batch row, padding rows taking
    the early-out, against its plain version."""
    monkeypatch.setattr(rs, "SELECT_TILE_ROWS", tile)
    _held(tables_from_numpy(_inputs(case), card), per_area)


@pytest.mark.cuda
def test_b1_select_tile_kernel_on_unaligned_lanes_equals_plain(card):
    """Kernel 3 where the lane table starts 1 byte past a 16-byte boundary
    (D = 32: the kernel drops to a byte a thread)."""
    args = tables_from_numpy(seeded(9, 3, 24, 32, 300, 4), card)
    nh = args[1]
    flat = torch.empty(nh.numel() + 1, dtype=nh.dtype, device=card)
    shifted = flat[1:].view(nh.shape)
    shifted.copy_(nh)
    _held([args[0], shifted, *args[2:]], False)
