"""Kernel 13 (``fleet_select``) as redesigned for the card, on the CPU: a
model of its tile phases, held against the reference's
``multi_area_select_from_tables`` vmapped over batch rows (jitted on the
CPU) and against the fleet tables of ``openr_tpu/ops/fleet_tables.py``.

The model works as a block of the kernel does, one tile of TP consecutive
prefix rows of one batch row at a time (the last tile shorter where TP
does not divide P):

1. a thread per row: the chain to the winner mask, every candidate set a
   64-bit mask and the not-drained key a 0/1 mask; then a thread per
   (row, area) pair: its min-cost winners and shortest metric;
2. the tile's lane span [rows, A, D], W bytes at a time (W the largest of
   16, 8, 4 and 1 that divides D): each byte the int32 SUM over the
   pair's min-cost winners of their lane bytes, then > 0, so a winner
   holding the -128 fill cancels another's 1 exactly as the reference's
   einsum does; a pair with a set lane is lit;
3. valid (winners and lit) and use from the masks; with a previous
   generation, the row changed when any output differs.

Cases: D in {1, 4, 17, 32, 33}, C in {1, 4, 64}, A in {1, 3}, per-area
distance on and off, the rule's tile and tiles of 7 rows (a tail tile), a
row whose two min-cost winners hold lanes of 1 and the -128 fill, the diff
against a perturbed previous generation; and the fleet worlds of
``tests/test_torch_fleet_tables.py`` through the port's plain SPF tables.
The kernel itself is held against its plain version by the ``cuda`` tests
of ``tests/test_torch_kernels_cuda.py``.  Tolerance: exact equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.ops import fleet_tables as jft
from openr_tpu.ops.route_select import multi_area_select_from_tables as jax_select
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops import route_select as trs
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.consts import BIG
from tests.test_torch_fleet_tables import DENSE, WORLDS, Pair

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _bits(mask):
    c = 0
    while mask:
        if mask & 1:
            yield c
        mask >>= 1
        c += 1


def _keep_max(mask, key):
    best = max((int(key[c]) for c in _bits(mask)), default=I32_MIN)
    return sum(1 << c for c in _bits(mask) if int(key[c]) == best)


def row_use(p, dist, ovl, soft, cand, C, per_area):
    """Phase 1, a thread per row: the chain to the winner mask."""
    area, node, ok, drain, ppref, spref, dd, _cnia = cand
    reach = nonhard = not_drained = 0
    for c in range(C):
        a, n = int(area[p, c]), int(node[p, c])
        if ok[p, c] and dist[a, n] < BIG:
            reach |= 1 << c
            if not ovl[a, n]:
                nonhard |= 1 << c
        if not (drain[p, c] > 0 or soft[a, n] > 0):
            not_drained |= 1 << c
    use = nonhard or reach
    if use & not_drained:
        use &= not_drained
    use = _keep_max(use, ppref[p])
    use = _keep_max(use, spref[p])
    kept = 0
    for c in _bits(use):
        pool = [c2 for c2 in _bits(use) if not per_area or area[p, c2] == area[p, c]]
        if int(dd[p, c]) == min(int(dd[p, c2]) for c2 in pool):
            kept |= 1 << c
    return kept


def pair_winners(p, a, use, dist, cand, A):
    """Phase 1, a thread per (row, area): (min-cost winners, shortest)."""
    area, _node, _ok, _drain, _pp, _sp, _dd, cnia = cand
    shortest, reached = np.float32(BIG), 0
    if any(int(area[p, c]) == a for c in _bits(use)):
        for c in _bits(use):
            n = int(cnia[p, c, a])
            if n >= 0 and dist[a, n] < BIG:
                reached |= 1 << c
                shortest = min(shortest, dist[a, n])
    mc = sum(1 << c for c in _bits(reached) if dist[a, int(cnia[p, c, a])] == shortest)
    return mc, shortest


def lane_width(D):
    return next(w for w in (16, 8, 4, 1) if D % w == 0)


def tile_model(dist, nh, ovl, soft, cand, per_area, TP, prev=None):
    """Kernel 13 tile by tile: (use [B, P, C], shortest [B, P, A], lanes
    [B, P, A, D], valid [B, P, A]) and changed [B] with ``prev``."""
    dist, nh, ovl, soft = (np.asarray(x) for x in (dist, nh, ovl, soft))
    cand = tuple(np.asarray(x) for x in cand)
    B, A, _V = dist.shape
    P, C = cand[0].shape
    D = nh.shape[-1]
    W = lane_width(D)
    use_o = np.zeros((B, P, C), bool)
    short_o = np.zeros((B, P, A), np.float32)
    lanes_o = np.zeros((B, P, A, D), bool)
    valid_o = np.zeros((B, P, A), bool)
    for b in range(B):
        for p0 in range(0, P, TP):
            rows = range(p0, min(P, p0 + TP))
            use_s = {p: row_use(p, dist[b], ovl, soft, cand, C, per_area) for p in rows}
            mc_s, lit = {}, {}
            for p in rows:
                for a in range(A):
                    mc_s[p, a], short_o[b, p, a] = pair_winners(p, a, use_s[p], dist[b], cand, A)
                    lit[p, a] = False
            span = lanes_o[b, p0:p0 + len(rows)].reshape(-1)  # the tile's contiguous span
            for k in range(len(span) // W):
                pair, l0 = divmod(k * W, D)
                r, a = divmod(pair, A)
                p = p0 + r
                s = np.zeros(W, np.int32)
                for c in _bits(mc_s[p, a]):
                    s += nh[b, a, int(cand[7][p, c, a]), l0:l0 + W].astype(np.int32)
                span[k * W:(k + 1) * W] = s > 0
                lit[p, a] |= bool((s > 0).any())
            for p in rows:
                valid_o[b, p] = [mc_s[p, a] != 0 and lit[p, a] for a in range(A)]
                use_o[b, p] = [(use_s[p] >> c) & 1 for c in range(C)]
    outs = (use_o, short_o, lanes_o, valid_o)
    if prev is None:
        return outs
    changed = np.zeros(B, bool)
    for now, old in zip(outs, prev):
        changed |= (now != np.asarray(old)).reshape(B, -1).any(axis=1)
    return (*outs, changed)


@functools.lru_cache(maxsize=None)
def jax_fleet_select(per_area):
    """The reference's selection vmapped over batch rows (tables per row,
    candidates shared), as ``fleet_tables.py`` runs it."""
    def one(d, n, *rest):
        return jax_select(d, n, *rest, per_area_distance=per_area)

    return jax.jit(jax.vmap(one, in_axes=(0, 0) + (None,) * 10))


def inputs(seed, B, A, V, D, P, C):
    """Seeded tables per batch row and shared candidates; rows 0-7 all
    hard-drained, 8-15 soft-drained, the last 8 padded; with C >= 2, row
    20's two min-cost winners in area 0 hold lanes of 1 and the -128
    fill in batch row 0."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 12, (B, A, V)).astype(np.float32)
    dist[rng.random((B, A, V)) < 0.2] = BIG
    nh = (rng.random((B, A, V, D)) < 0.4).astype(np.int8)
    nh[rng.random((B, A, V)) < 0.15] = -128
    ovl = rng.random((A, V)) < 0.2
    soft = np.where(rng.random((A, V)) < 0.2, 5, 0).astype(np.int32)
    area = rng.integers(0, A, (P, C)).astype(np.int32)
    node = rng.integers(0, V, (P, C)).astype(np.int32)
    ok = rng.random((P, C)) < 0.85
    ovl[area[:8], node[:8]] = True
    soft[area[8:16], node[8:16]] = 9
    drain = np.where(rng.random((P, C)) < 0.2, 1, 0).astype(np.int32)
    ppref = rng.choice([100, 200], (P, C)).astype(np.int32)
    spref = rng.choice([1, 2], (P, C)).astype(np.int32)
    dd = rng.choice([1, 2, 3], (P, C)).astype(np.int32)
    ok[-8:] = False
    area[-8:] = 0
    node[-8:] = 0
    cnia = rng.integers(-1, V, (P, C, A)).astype(np.int32)
    cnia[np.arange(P)[:, None], np.arange(C)[None, :], area] = node
    cnia[-8:] = -1
    if C >= 2:
        p, (n1, n2) = 20, (V - 2, V - 1)
        area[p], node[p], ok[p] = 0, np.arange(C) % V, False
        area[p, :2], node[p, :2], ok[p, :2] = 0, (n1, n2), True
        cnia[p, :, 0] = node[p]
        drain[p], ppref[p], spref[p], dd[p] = 0, 100, 1, 1
        ovl[0, [n1, n2]], soft[0, [n1, n2]] = False, 0
        dist[0, 0, [n1, n2]] = 3.0
        nh[0, 0, n1], nh[0, 0, n2] = 1, -128
    return dist, nh, ovl, soft, (area, node, ok, drain, ppref, spref, dd, cnia)


def reference(dist, nh, ovl, soft, cand, per_area):
    outs = jax_fleet_select(per_area)(*(jnp.asarray(x) for x in (dist, nh, ovl, soft, *cand)))
    return tuple(np.asarray(x) for x in outs)


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


#: (D, C, A, P): every lane width the tiles take (vector widths 1, 4 and
#: 16, odd widths), 1, 4 and 64 candidates, 1 and 3 areas
CASES = [(1, 1, 1, 40), (4, 4, 3, 45), (17, 64, 1, 30), (32, 4, 3, 37), (33, 1, 1, 40),
         (32, 64, 1, 29), (4, 1, 3, 33), (17, 4, 3, 31)]


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[f"D{d}-C{c}-A{a}" for d, c, a, _p in CASES])
def test_tile_model_equals_jax_select(case, per_area, tile):
    D, C, A, P = case
    dist, nh, ovl, soft, cand = inputs(D * 100 + C, 3, A, 24, D, P, C)
    TP = trs.fleet_select_tile_rows(3, P, A, 132) if tile is None else tile
    got = tile_model(dist, nh, ovl, soft, cand, per_area, TP)
    want = reference(dist, nh, ovl, soft, cand, per_area)
    assert_same(got, want)
    assert want[3].any() and (P % TP != 0 or tile is None)
    if C >= 2:  # the -128 winner cancels the other winner's lanes
        assert not want[2][0, 20, 0].any() and not want[3][0, 20, 0]
        assert want[0][0, 20, :2].all()


@pytest.mark.parametrize("case", [(4, 4, 3, 45), (33, 64, 1, 30)])
def test_tile_model_diff_flags_the_perturbed_rows(case):
    """Against a previous generation with one lane, one shortest and one
    use flipped in rows 1, 2 and 4: exactly those rows changed, as the
    reference's per-row diff (``fleet_tables.py:205-210``) says."""
    D, C, A, P = case
    dist, nh, ovl, soft, cand = inputs(7, 5, A, 24, D, P, C)
    base = reference(dist, nh, ovl, soft, cand, False)
    prev = [x.copy() for x in base]
    prev[2][1, P - 1, A - 1, D - 1] ^= True
    prev[1][2, 3, 0] = -1.0
    prev[0][4, 0, C - 1] ^= True
    got = tile_model(dist, nh, ovl, soft, cand, False, 7, prev=prev)
    assert_same(got[:4], base)
    want = np.zeros(5, bool)
    for now, old in zip(base, prev):
        want |= (now != old).reshape(5, -1).any(axis=1)
    assert got[4].tolist() == want.tolist() == [False, True, True, False, True]


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_tile_model_equals_jax_fleet_tables(world, per_area):
    """The fleet tables of every vantage root: the model over the port's
    plain dense SPF tables against ``fleet_multi_area_tables_dense``."""
    pair = Pair(world)
    if not pair.ref.has_dense:
        pytest.skip("the world declines the dense planes")
    roots = torch.from_numpy(pair.roots)
    planes = pair.torch(pair.port, DENSE)
    dist, nh = tspf.fleet_spf_dense(*planes.values(), roots, pair.D)
    cand = tuple(t.numpy() for t in pair.port_cand().values())
    got = tile_model(dist, nh, pair.port.overloaded, pair.port.soft, cand, per_area, 3)
    want = jft.fleet_multi_area_tables_dense(
        **pair.jax(pair.ref, DENSE), soft=jnp.asarray(pair.ref.soft),
        roots=jnp.asarray(pair.roots), **pair.jax_cand(), max_degree=pair.D,
        per_area_distance=per_area,
    )
    assert_same(got, want)
    # and the port's selection entry point, on the CPU its plain version
    args = tables_from_numpy([dist.numpy(), nh.numpy(), pair.port.overloaded, pair.port.soft,
                              *cand])
    assert_same([t.numpy() for t in trs.fleet_select(*args, per_area)], want)


def test_tile_rule_bounds_the_block_state(monkeypatch):
    """The rule's tile: up to 128 rows, fewer where 63 areas' winner masks
    and lane flags would pass 24 KB, halved down to 16 rows while the
    blocks would leave the card's SMs short of 4 each, never more than P;
    a set tile wins."""
    assert trs.fleet_select_tile_rows(1024, 1024, 1, 132) == 128
    assert trs.fleet_select_tile_rows(1024, 50, 1, 132) == 50
    rows = trs.fleet_select_tile_rows(204, 4096, 63, 132)
    assert rows == 32 and rows * (8 + 12 * 63) <= 24576
    assert trs.fleet_select_tile_rows(2, 4096, 63, 132) == 16
    assert trs.fleet_select_tile_rows(2, 4096, 1, 132) == 16
    assert trs.fleet_select_tile_rows(33, 64, 3, 132) == 16
    monkeypatch.setattr(trs, "SELECT_TILE_ROWS", 7)
    assert trs.fleet_select_tile_rows(1024, 1024, 3, 132) == 7
