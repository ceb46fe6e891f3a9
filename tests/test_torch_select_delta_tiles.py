"""Kernel 7 (``multi_area_select_delta_from_tables``) as redesigned for the
card: kernel 3's tile body at one batch row (``kOkOnly``) with a flag a
prefix row.  A numpy model of the tiles and their per-row diff, held
against the port's plain version (``ops/route_select.py``
``multi_area_select_delta_from_tables_plain``) and the JAX package's
``multi_area_select_delta_from_tables`` (``openr_tpu/ops/route_select.py:368``).

* The mapping: kernel 3's (``tests/test_torch_select_b1_tiles.py``), a
  block a tile of ``fleet_select_tile_rows(1, P, A, sms, most=256)`` rows.
* The flag of row p, in the tile's order: phase 1 sets it from the row's
  touches (an ok slot whose own-area cell, or a cell it resolves to in
  any area, is in ``node_changed``; the ok slots are the ones the chain
  read); the (row, area) pairs from ``shortest``; phase 2 from each W-byte
  lane word against the same word of ``prev_lanes``; phase 3 from
  ``valid`` and ``use``.  The model logs which outputs each row compared:
  every row, one with no ok slot too, reads all of its ``prev_*`` cells.
* Inputs: the seeded tables of ``tests/test_torch_select_delta.py`` (the
  previous generation from perturbed tables, a few drain changes) and of
  ``tests/test_torch_select_b1_tiles.py`` at D 1-33 and C 1-64 with their
  bucket padding, both selection algorithms, tiles with a tail; an
  unchanged generation (no flag); withdrawn rows (empty rows whose
  previous rows were not); rows flagged only by an own-area touch or only
  by a cross-area touch.

The ``cuda`` cases run kernel 7 against its plain version on such inputs
at both ``per_area`` settings, A = 3, C 1, 8 and 64, D 1, 4, 33 and 2,048
(every lane word: 1, 4 and 16 bytes), P a multiple of no tile, at the
rule's tile and tiles of 7 and 16, and on lane tables that start off a
16-byte boundary.  Tolerance: exact equality.  This module imports no JAX
at import time, so that its ``cuda`` cases run where JAX is absent.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import route_select as rs
from test_torch_select_b1_tiles import Row, _bits, pair_winners, row_use, seeded, three_area_world


def touches(row, ok, node_changed):
    """Phase 1's touches of a row over its ok slots."""
    A = node_changed.shape[0]
    for c in _bits(ok):
        if node_changed[int(row("area", c)), int(row("node", c))]:
            return True
        for a in range(A):
            n = int(row("cnia", c, a))
            if n >= 0 and node_changed[a, n]:
                return True
    return False


def delta_tile_model(args, per_area, TP):
    """Kernel 7 tile by tile: (use, shortest, lanes, valid, changed [P]);
    checks that every row compares each of its outputs with the previous
    generation's, whatever its ok bytes."""
    args = [np.asarray(x) for x in args]
    dist, nh, ovl, soft, *rest = args
    cand, (prev_use, prev_short, prev_lanes, prev_valid, node_changed) = rest[:8], rest[8:]
    A, _V = dist.shape
    P, C = cand[0].shape
    D = nh.shape[-1]
    W = next(w for w in (16, 8, 4, 1) if D % w == 0)
    use_o = np.zeros((P, C), bool)
    short_o = np.zeros((P, A), np.float32)
    lanes_o = np.zeros((P, A, D), bool)
    valid_o = np.zeros((P, A), bool)
    changed = np.zeros(P, bool)
    for p0 in range(0, P, TP):
        rows = range(p0, min(P, p0 + TP))
        log = {p: Row(cand, p) for p in rows}
        compared = {p: set() for p in rows}
        flag = {}
        use_s = {}
        # 1. the chain and the touches, a thread per row
        for p in rows:
            ok = sum(1 << c for c in range(C) if log[p]("ok", c))
            use_s[p] = row_use(log[p], C, dist, ovl, soft, per_area)
            flag[p] = touches(log[p], ok, node_changed)
        # the pairs: shortest against the previous generation's
        mc_s, lit = {}, {}
        for p in rows:
            for a in range(A):
                mc_s[p, a], short_o[p, a] = pair_winners(log[p], a, use_s[p], dist)
                lit[p, a] = False
                compared[p].add(("shortest", a))
                flag[p] |= bool(short_o[p, a] != prev_short[p, a])
        # 2. the lane span, a W-byte word at a time against prev_lanes' word
        span = lanes_o[p0:p0 + len(rows)].reshape(-1)
        prev_span = prev_lanes[p0:p0 + len(rows)].reshape(-1)
        for k in range(len(span) // W):
            pair, l0 = divmod(k * W, D)
            r, a = divmod(pair, A)
            p = p0 + r
            s = np.zeros(W, np.int32)
            for c in _bits(mc_s[p, a]):
                s += nh[a, int(log[p]("cnia", c, a)), l0:l0 + W].astype(np.int32)
            word = s > 0
            span[k * W:(k + 1) * W] = word
            lit[p, a] |= bool(word.any())
            compared[p].update(("lanes", a, l0 + t) for t in range(W))
            flag[p] |= bool((word != prev_span[k * W:(k + 1) * W]).any())
        # 3. valid and use
        for p in rows:
            for a in range(A):
                valid_o[p, a] = mc_s[p, a] != 0 and lit[p, a]
                compared[p].add(("valid", a))
                flag[p] |= bool(valid_o[p, a] != prev_valid[p, a])
            for c in range(C):
                use_o[p, c] = (use_s[p] >> c) & 1
                compared[p].add(("use", c))
                flag[p] |= bool(use_o[p, c] != prev_use[p, c])
            changed[p] = flag[p]
            want = ({("shortest", a) for a in range(A)} | {("valid", a) for a in range(A)}
                    | {("use", c) for c in range(C)}
                    | {("lanes", a, l) for a in range(A) for l in range(D)})
            assert compared[p] == want
    return use_o, short_o, lanes_o, valid_o, changed


# -- inputs ------------------------------------------------------------------------


def _select_plain(args, per_area):
    return [t.numpy() for t in rs.multi_area_select_from_tables_plain(
        *tables_from_numpy(args, "cpu"), per_area)]


def with_prev(base, per_area, seed, kind):
    """The delta's arguments on ``base`` (the 12 selection inputs), its
    previous generation and ``node_changed`` by ``kind``:

    * ``perturbed``: the selection on tables with a tenth of the distances
      raised and a twentieth of the lane bytes flipped, 3 % of the cells
      changed;
    * ``unchanged``: the selection's own outputs, no cell changed;
    * ``withdrawn``: the own outputs, then a third of the rows with a valid
      route lose every ok slot (their rows empty, their previous rows not);
    * ``touch-own`` / ``touch-cross``: the own outputs and one changed cell
      that one row's ok slot names in its own area only (its own-area
      resolution cleared) or in another area only.

    Returns (args, rows that must flag, rows that must not)."""
    rng = np.random.default_rng(seed)
    args = [np.array(a) for a in base]
    dist, nh = args[0], args[1]
    A, V = dist.shape
    area, node, ok, cnia = args[4], args[5], args[6], args[11]
    must, must_not = set(), set()
    none = np.zeros((A, V), bool)
    if kind == "perturbed":
        pd = np.where(rng.random(dist.shape) < 0.1, dist + 1, dist).astype(np.float32)
        pn = np.where(rng.random(nh.shape) < 0.05, 1 - np.abs(nh), nh).astype(np.int8)
        prev = _select_plain([pd, pn, *args[2:]], per_area)
        return [*args, *prev, rng.random((A, V)) < 0.03], must, must_not
    prev = _select_plain(args, per_area)
    if kind == "unchanged":
        must_not = set(range(len(ok)))
        return [*args, *prev, none], must, must_not
    if kind == "withdrawn":
        live = np.nonzero(prev[3].any(axis=1))[0]
        gone = live[::3]
        ok[gone] = False
        must = set(gone.tolist())
        must_not = set(range(len(ok))) - must
        return [*args, *prev, none], must, must_not
    # one row's ok slot, its cell changed in one area alone
    changed = none.copy()
    for p in rng.permutation(len(ok)):
        oks = np.nonzero(ok[p])[0]
        if not len(oks):
            continue
        c = int(oks[0])
        a0, n0 = int(area[p, c]), int(node[p, c])
        if kind == "touch-own":
            if any(cnia[p, c2, a0] == n0 for c2 in oks if c2 != c):
                continue
            cnia[p, c, a0] = -1  # the cell is named by the own-area column alone
            changed[a0, n0] = True
        else:
            others = [a for a in range(A) if a != a0 and cnia[p, c, a] >= 0
                      and not any(area[p, c2] == a and node[p, c2] == cnia[p, c, a] for c2 in oks)]
            if not others:
                continue
            changed[others[0], cnia[p, c, others[0]]] = True
        prev = _select_plain(args, per_area)  # the own outputs of the edited columns
        must = {int(p)}
        return [*args, *prev, changed], must, must_not
    raise AssertionError(f"no row for {kind}")


#: (D, C, P): the b1 tiles' lane widths and candidate counts
CASES = [(1, 1, 60), (4, 4, 45), (6, 4, 50), (17, 64, 30), (33, 1, 61)]
KINDS = ["perturbed", "unchanged", "withdrawn", "touch-own", "touch-cross"]


def _base(case):
    if case == "world":
        return three_area_world()
    D, C, P = case
    return seeded(D * 100 + C, 3, 24, D, P, C)


def _plain(args, per_area):
    return [t.numpy() for t in rs.multi_area_select_delta_from_tables(
        *tables_from_numpy(args, "cpu"), per_area)]


def _jax(args, per_area):
    import jax.numpy as jnp
    from openr_tpu.ops.route_select import multi_area_select_delta_from_tables as jax_delta

    return [np.asarray(x) for x in jax_delta(*(jnp.asarray(a) for a in args),
                                             per_area_distance=per_area)]


def _assert_same(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def _check_rows(changed, must, must_not):
    assert all(changed[p] for p in must)
    assert not any(changed[p] for p in must_not)


IDS = [f"D{d}-C{c}" for d, c, _p in CASES] + ["world"]


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("case", CASES + ["world"], ids=IDS)
def test_delta_tile_model_equals_plain_and_reference(case, per_area, tile):
    """The perturbed previous generation: some rows flag, some do not."""
    args, _must, _not = with_prev(_base(case), per_area, 1, "perturbed")
    P, A = args[4].shape[0], args[0].shape[0]
    TP = rs.fleet_select_tile_rows(1, P, A, 132, most=256) if tile is None else tile
    got = delta_tile_model(args, per_area, TP)
    want = _plain(args, per_area)
    _assert_same(got, want)
    _assert_same(got, _jax(args, per_area))
    assert 0 < want[4].sum() < P


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("kind", KINDS[1:])
@pytest.mark.parametrize("case", [(4, 4, 45), (17, 64, 30), "world"], ids=["D4-C4", "D17-C64", "world"])
def test_delta_tile_model_flags_exactly_its_rows(case, kind, per_area):
    """An unchanged generation flags nothing (bucket padding included); a
    withdrawn row flags; a touch alone, own-area or cross-area, flags its
    row although no output of the row moved."""
    args, must, must_not = with_prev(_base(case), per_area, 2, kind)
    got = delta_tile_model(args, per_area, 7)
    want = _plain(args, per_area)
    _assert_same(got, want)
    _assert_same(got, _jax(args, per_area))
    _check_rows(got[4], must, must_not)
    if kind.startswith("touch"):
        (p,) = must
        for out, prev in zip(got[:4], args[12:16]):  # flagged by the touch alone
            assert np.array_equal(out[p], prev[p])


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_tile_model_on_the_delta_tests_inputs(seed, per_area):
    """The seeded inputs of ``tests/test_torch_select_delta.py``: the
    previous generation from the reference's selection on perturbed
    tables, drain state moved on a few cells."""
    import jax.numpy as jnp
    from openr_tpu.ops import route_select as jrs
    from test_torch_select_delta import _inputs

    tables, cand, (prev_dist, prev_nh), node_changed = _inputs(seed)
    prev = jrs.multi_area_select_from_tables(
        *(jnp.asarray(a) for a in (prev_dist, prev_nh, tables[2], tables[3], *cand)),
        per_area_distance=per_area,
    )
    args = [*tables, *cand, *(np.asarray(p) for p in prev), node_changed]
    got = delta_tile_model(args, per_area, 64)
    _assert_same(got, _jax(args, per_area))
    _assert_same(got, _plain(args, per_area))


def test_delta_tile_rule_and_shared_memory():
    """Kernel 7 takes kernel 3's tiles; a tile's winner masks, lane flags
    and row flags (8 + 12 A + 4 bytes a row) stay far below 48 KiB at
    every A the rule allows."""
    for P, A in ((1_048_576, 1), (64, 3), (409_600, 63), (5, 1)):
        TP = rs.fleet_select_tile_rows(1, P, A, 132, most=256)
        assert 1 <= TP <= min(P, 256) and TP * (8 + 12 * A + 4) <= 48 * 1024


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _held(args, per_area, must=(), must_not=()):
    reset_launch_counts()
    got = rs.multi_area_select_delta_from_tables(*args, per_area)
    torch.cuda.synchronize()
    assert LAUNCHES["multi_area_select_delta_from_tables"] == 1
    want = rs.multi_area_select_delta_from_tables_plain(*args, per_area)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    _check_rows(got[4].cpu().numpy(), must, must_not)
    return got


#: (D, C, P) on the card: D 1, 4, 33 and 2,048 (lane words of 1, 4, 1 and
#: 16 bytes), C 1, 8 and 64, P a multiple of no tile
CARD_CASES = [(1, 1, 301), (4, 8, 517), (33, 64, 130), (2048, 1, 70), (4, 1, 4099)]
CARD_IDS = [f"D{d}-C{c}-P{p}" for d, c, p in CARD_CASES] + ["world"]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, 7, 16])
@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("case", CARD_CASES + ["world"], ids=CARD_IDS)
def test_delta_tile_kernel_equals_plain(card, case, per_area, tile, monkeypatch):
    """Kernel 7 on a perturbed previous generation, against its plain
    version; some rows flag and some do not."""
    monkeypatch.setattr(rs, "SELECT_TILE_ROWS", tile)
    args, _must, _not = with_prev(_base(case), per_area, 3, "perturbed")
    got = _held(tables_from_numpy(args, card), per_area)
    assert 0 < int(got[4].sum()) < args[4].shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("kind", KINDS[1:])
@pytest.mark.parametrize("case", [(4, 8, 517), (33, 64, 130), (2048, 1, 70), "world"],
                         ids=["D4-C8", "D33-C64", "D2048-C1", "world"])
def test_delta_tile_kernel_flags_exactly_its_rows(card, case, kind, per_area):
    """An unchanged generation (bucket padding rows included) flags no row;
    withdrawn rows flag; a touch alone, own-area or cross-area, flags its
    row."""
    args, must, must_not = with_prev(_base(case), per_area, 4, kind)
    _held(tables_from_numpy(args, card), per_area, must, must_not)


@pytest.mark.cuda
@pytest.mark.parametrize("table", [1, 14], ids=["nh", "prev_lanes"])
def test_delta_tile_kernel_on_unaligned_lanes_equals_plain(card, table):
    """Kernel 7 where a lane table starts 1 byte past a 16-byte boundary
    (D = 32: the kernel drops to a byte a thread)."""
    args = list(tables_from_numpy(
        with_prev(seeded(9, 3, 24, 32, 300, 4), False, 5, "perturbed")[0], card))
    t = args[table]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    shifted = flat[1:].view(t.shape)
    shifted.copy_(t)
    args[table] = shifted
    _held(args, False)
