"""Kernel 17 (``batched_select_routes``) as redesigned for the card: a numpy
model of its tiles, held against the port's plain version
(``ops/route_select.py`` ``batched_select_routes_plain``) and the JAX
package's ``batched_select_routes`` (``openr_tpu/ops/route_select.py:112``).

* The mapping: a block takes a tile of TP consecutive prefixes of one row
  b (``batched_select_tile_rows``); every (row, prefix) is computed once,
  the last tile of a row shorter where TP does not divide P.
* The stage: a block's lane bytes [TP, D] and use bytes [TP, C] sit in
  shared memory at their output span's address mod 16, and the block
  stores each span as head bytes, 16-byte words and tail bytes, which
  cover every byte of the span once (D = 1, 4, 17, 32, 40 and 70, spans
  at every alignment).  The row tables it stages sit at their source's
  address mod 16, inside their regions of the stage.
* A thread per prefix runs the lean chain (a candidate that is not ok
  skipped past the first loop, the keep filters skipped where at most one
  candidate is left), which the model holds to the full chain: use,
  valid, metric, lanes and num.  It forms its lanes as words of four
  bytes, up to 16 at a time: the first winner's words as read (clamped at
  0 unless every candidate wins), each further winner's by the bytewise
  signed max, num their signed byte sum; a word is two aligned words of
  the table and a funnel shift (from L2 the second only where the row
  reaches into it), with equal results.  It ORs its lane words and its use
  bytes (four a word) into the zeroed stages, and no byte there is set by
  two prefixes.
* Worlds: a 64-node WAN of the headline class (a loopback a node and
  anycast /24s of 4 advertisers) with rows of their own failed link,
  hard and soft drains and roots, one root advertising an anycast prefix;
  the same at one candidate a prefix with a winner's lane row the -128
  fill (a lone winner that is every candidate); 64-wide candidates; and
  70 lanes (past the 16 words a thread holds at a time).

The ``cuda`` cases run kernel 17 against its plain version at D = 1, 4,
17, 32, 40 and 70, at the rule's tile and tiles that do not divide P; on
shapes whose row and lane tables are staged (V 40), whose lane table does
not fit (V 4,096, D 64: the row tables alone) and whose row tables do not
fit either (V 27,000: neither); at D 8,192, where the rule's tile falls
below 32 prefixes; at 1 and 64 candidates; and on tables that start off a
16-byte boundary.  Tolerance: exact equality.  This module imports no JAX
at import time, so that its ``cuda`` cases run where JAX is absent.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.emulation.topology import build_adj_dbs, random_connected_edges
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops import route_select as rs
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.types import PrefixEntry, PrefixMetrics

INT32_MIN = np.iinfo(np.int32).min
BIG32 = np.float32(BIG)


def _bits(mask):
    c = 0
    while mask:
        if mask & 1:
            yield c
        mask >>= 1
        c += 1


# -- worlds ------------------------------------------------------------------


def wan_world(B=12, seed=7, anycast=16):
    """The arguments of kernel 17 on a 64-node WAN of the headline class
    (``random_connected_edges(n, 2 n, seed=7)``): a loopback a node and
    ``anycast`` /24s of 4 advertisers with drain metrics, preferences,
    distances and min-nexthop gates; row b fails link 7 b + 3, rows past 1
    hard-drain node 13 b and soft-drain node 29 b, row b >= 4 roots at node
    b, and row 2 at an anycast advertiser."""
    edges = random_connected_edges(64, 128, seed=seed)
    ls = LinkState("0")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    topo = csr.encode_link_state(ls)
    rng = np.random.default_rng(seed)
    ps = PrefixState()
    names = topo.id_to_node
    for i, node in enumerate(names):
        ps.update_prefix(node, "0", PrefixEntry(f"10.1.{i}.1/32"))
    for k in range(anycast):
        for node in rng.choice(names, 4, replace=False):
            ps.update_prefix(str(node), "0", PrefixEntry(
                f"10.250.{k}.0/24", min_nexthop=2 if k % 8 == 0 else None,
                metrics=PrefixMetrics(drain_metric=int(rng.random() < 0.25),
                                      path_preference=int(rng.choice([100, 200])),
                                      source_preference=int(rng.choice([0, 50])),
                                      distance=int(rng.integers(0, 2)))))
    cands = csr.encode_prefix_candidates(ps, topo, "0", max_candidates=4)
    cand = [cands.cand_node, cands.cand_ok, cands.drain_metric, cands.path_pref,
            cands.source_pref, cands.distance, cands.min_nexthop]
    n, L = topo.num_nodes, len(topo.links)
    b = np.arange(B)
    failed = (7 * b + 3) % L
    ovl = np.tile(topo.overloaded, (B, 1))
    soft = np.tile(topo.soft, (B, 1))
    ovl[b[2:], (13 * b[2:]) % n] = True
    soft[b[2:], (29 * b[2:]) % n] += 60
    roots = np.where(b >= 4, b % n, topo.node_id("node0")).astype(np.int32)
    roots[2] = cands.cand_node[-1, 0]
    mask = csr.link_failure_batch(topo, [[int(f)] for f in failed])
    D = topo.max_out_degree()
    edges_t = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok, mask, ovl, roots],
                                "cpu")
    dist, nh = spf.batched_spf_plain(*edges_t, D)
    return [*cand, dist.numpy(), nh.numpy(), ovl, soft, roots]


def lone_fill_world():
    """The WAN at one candidate a prefix (each prefix's first advertiser):
    a loopback's lone winner is every candidate, and in row 0 the lane row
    of the node of prefix 5 (reached) holds the -128 fill."""
    args = wan_world()
    cand = [np.ascontiguousarray(c[:, :1]) for c in args[:7]]
    dist, nh = args[7], args[8].copy()
    node = int(cand[0][5, 0])
    assert cand[1][5, 0] and dist[0, node] < BIG
    nh[0, node] = -128
    return [*cand, dist, nh, *args[9:]]


def synthetic(B, V, P, C, D, seed):
    """Seeded tables and candidates at any width: distances with BIG holes,
    lanes of 0, 1 and -128 rows, drains, roots (row 0 at an advertiser),
    and candidate columns with empty slots, anycast, preferences and
    min-nexthop gates."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 9, (B, V)).astype(np.float32)
    dist[rng.random((B, V)) < 0.2] = BIG
    nh = (rng.random((B, V, D)) < 0.4).astype(np.int8)
    nh[rng.random((B, V)) < 0.1] = -128
    ovl = rng.random((B, V)) < 0.1
    soft = np.where(rng.random((B, V)) < 0.15, 60, 0).astype(np.int32)
    node = rng.integers(0, V, (P, C)).astype(np.int32)
    ok = rng.random((P, C)) < 0.6
    ok[:, 0] |= rng.random(P) < 0.8
    roots = rng.integers(0, V, B).astype(np.int32)
    roots[0] = node[1, 0]
    ok[1, 0] = True
    cand = [node, ok, (rng.random((P, C)) < 0.2).astype(np.int32),
            rng.choice([100, 200], (P, C)).astype(np.int32),
            rng.choice([0, 50], (P, C)).astype(np.int32),
            rng.integers(0, 2, (P, C)).astype(np.int32),
            np.where(rng.random((P, C)) < 0.1, 2, 0).astype(np.int32)]
    return [*cand, dist, nh, ovl, soft, roots]


WORLDS = {
    "wan": wan_world,
    "lone_fill": lone_fill_world,
    "wide": lambda: synthetic(6, 48, 45, 64, 17, 3),
    "d70": lambda: synthetic(4, 40, 30, 4, 70, 9),
}


# -- the chain, lean and full --------------------------------------------------


def chain(row, d, ovl, soft, root, lean):
    """(use, winners, best_igp, req, self_wins) of one prefix row: the
    kernel's lean chain, or the full one (every candidate through every
    filter)."""
    node, ok, drain, ppref, spref, dis, mnh = row
    C = len(node)
    reach = hard = 0
    last = -1
    for c in range(C):
        n = int(node[c])
        if lean and not ok[c]:
            continue
        last = c
        if ok[c] and d[n] < BIG32:
            reach |= 1 << c
        if ovl[n]:
            hard |= 1 << c
    if lean:
        C = last + 1
    nonhard = reach & ~hard
    use = nonhard or reach
    if not lean or use & (use - 1):
        keys = [(lambda c: 0 if drain[c] > 0 or soft[node[c]] > 0 else 1, max),
                (lambda c: int(ppref[c]), max), (lambda c: int(spref[c]), max),
                (lambda c: int(dis[c]), min)]
        for key, pick in keys:
            if use:
                best = pick(key(c) for c in _bits(use))
                use = sum(1 << c for c in _bits(use) if key(c) == best)
    best_igp, req, self_wins = BIG32, INT32_MIN, False
    for c in range(C):
        u = (use >> c) & 1
        if u and int(node[c]) == root:
            self_wins = True
        if u:
            best_igp = min(best_igp, d[int(node[c])])
        req = max(req, int(mnh[c]) if u else 0)
    winners = sum(1 << c for c in _bits(use) if d[int(node[c])] == best_igp)
    return use, winners, np.float32(best_igp), req, self_wins


def lanes_full(tab, node, winners, C, D):
    """The reference's int8 max over every candidate, a non-winner giving
    0, kept in int32 from INT32_MIN: (bytes [D], num)."""
    out = np.zeros(D, np.int8)
    num = 0
    for l in range(D):
        x = INT32_MIN
        for c in range(C):
            x = max(x, int(tab[int(node[c]), l]) if (winners >> c) & 1 else 0)
        out[l] = np.int8(x)
        num += x
    return out, num


def _as_word(b4):
    return int(np.asarray(b4, np.int8).view(np.uint32)[0])


def _as_bytes(w):
    return np.array([w], np.uint32).view(np.int8).astype(np.int32)


def clamp0(w):
    """The kernel's bytewise max with 0: the bytes with their sign bit set
    cleared."""
    return w & ~((((w & 0x80808080) >> 7) * 0xFF) & 0xFFFFFFFF)


def row_word(flat, at, k, left, staged):
    """Word k of the lane row starting at byte ``at`` of the table: the
    aligned word holding byte at + 4 k and the next one, funnel-shifted;
    from L2 the next only where the row's ``left`` bytes reach into it."""
    below = at % 4
    base = at - below + 4 * k
    lo = _as_word(flat[base:base + 4])
    need_hi = staged or (below and left > 4 - below)
    hi = _as_word(flat[base + 4:base + 8]) if need_hi else 0
    return ((hi << 32 | lo) >> (8 * below)) & 0xFFFFFFFF


def lanes_by_words(tab, node, winners, C, D, staged):
    """The kernel's lane words, up to 16 at a time in registers: the first
    winner's words as read (-128 bytes kept where every candidate wins,
    else clamped at 0), each further winner's by the bytewise signed max;
    the bytes past D masked, num the signed byte sum.  Returns (the words,
    num); the table is read as the kernel reads it (with 8 bytes of
    padding where staged)."""
    flat = np.concatenate([tab.reshape(-1), np.zeros(8, np.int8)])
    every = winners == (1 << C) - 1
    Dw = -(-D // 4)
    words, num = [], 0
    for k0 in range(0, Dw, 16):
        acc, first = [0] * 16, True
        for c in _bits(winners):
            at = int(node[c]) * D + 4 * k0
            for k in range(min(16, Dw - k0)):
                v = row_word(flat, at, k, D - 4 * (k0 + k), staged)
                if first:
                    acc[k] = v if every else clamp0(v)
                else:
                    acc[k] = _as_word(np.maximum(_as_bytes(acc[k]), _as_bytes(v)))
            first = False
        for k in range(min(16, Dw - k0)):
            x = 0 if first else acc[k]
            if k0 + k == Dw - 1 and D % 4:
                x &= (1 << (8 * (D % 4))) - 1
            num += int(_as_bytes(x).sum())
            words.append(x)
    return words, num


def word_bytes(words, D):
    return np.concatenate([_as_bytes(w) for w in words])[:D].astype(np.int8)


def or_word(stage, off, x, owner, who):
    """The kernel's shared-memory OR of word x at byte offset ``off`` (any
    alignment) into the zeroed stage (a bytearray); ``owner`` records which
    prefix set each nonzero byte: no byte may be set by two."""
    for t in range(4):
        byte = (x >> (8 * t)) & 0xFF
        if byte:
            assert owner[off + t] in (-1, who)
            owner[off + t] = who
            stage[off + t] |= byte


def select_full(args):
    """The full chain for every (row, prefix): (valid, metric, lanes, num,
    use) as the reference's dtypes."""
    return _select(args, lean=False)


def _select(args, lean, staged=True):
    node, ok, drain, ppref, spref, dis, mnh, dist, nh, ovl, soft, roots = args
    B, P, C, D = dist.shape[0], node.shape[0], node.shape[1], nh.shape[-1]
    valid = np.zeros((B, P), bool)
    metric = np.zeros((B, P), np.float32)
    lanes = np.zeros((B, P, D), np.int8)
    num = np.zeros((B, P), np.int32)
    use_o = np.zeros((B, P, C), bool)
    for b in range(B):
        for p in range(P):
            row = tuple(x[p] for x in (node, ok, drain, ppref, spref, dis, mnh))
            use, win, best, req, self_wins = chain(row, dist[b], ovl[b], soft[b], int(roots[b]),
                                                   lean)
            if lean:
                words, n = lanes_by_words(nh[b], node[p], win, C, D, staged)
                lanes[b, p] = word_bytes(words, D)
            else:
                lanes[b, p], n = lanes_full(nh[b], node[p], win, C, D)
            num[b, p] = n
            metric[b, p] = best
            valid[b, p] = bool(win) and not self_wins and best < BIG32 and n > 0 and n >= req
            use_o[b, p] = [(use >> c) & 1 for c in range(C)]
    return valid, metric, lanes, num, use_o


# -- the tiles and the stage ------------------------------------------------------


def region(n):
    """A stage region: 16 more bytes than its data, rounded to 16."""
    return (n + 16 + 15) & ~15


def layout(TP, V, C, D):
    """Byte offsets of kernel 17's stage (``batched_layout``): lanes, use,
    dist, soft, overloaded, the lane table (the row tables' end), and the
    whole stage."""
    lanes = 0
    use = lanes + region(TP * D)
    dist = use + region(TP * C)
    soft = dist + region(4 * V)
    ovl = soft + region(4 * V)
    nh = ovl + region(V)
    return dict(lanes=lanes, use=use, dist=dist, soft=soft, ovl=ovl, nh=nh,
                total=nh + region(V * D + 8))


def span_pieces(addr, n):
    """``store_span`` (and ``load_span``) of n bytes whose first byte sits at ``addr`` (mod 16):
    head bytes up to a 16-byte boundary, 16-byte words, tail bytes, as
    (start, length, kind) in span coordinates."""
    head = min(n, (16 - addr % 16) % 16)
    words = (n - head) // 16
    pieces = [(i, 1, "head") for i in range(head)]
    pieces += [(head + 16 * k, 16, "word") for k in range(words)]
    pieces += [(i, 1, "tail") for i in range(head + 16 * words, n)]
    return pieces


def tile_model(args, TP, base=0):
    """Kernel 17 block by block: each tile's prefixes through the lean
    chain and the word-wise lanes into the stage at the output spans'
    alignment (the lane output starting at byte ``base`` mod 16), then the
    spans' pieces to the outputs.  Returns the five outputs, and checks
    that every (row, prefix) is computed once and every output byte
    stored once."""
    node, ok, drain, ppref, spref, dis, mnh, dist, nh, ovl, soft, roots = args
    B, P, C, D = dist.shape[0], node.shape[0], node.shape[1], nh.shape[-1]
    V = dist.shape[1]
    L = layout(TP, V, C, D)
    valid = np.zeros((B, P), bool)
    metric = np.zeros((B, P), np.float32)
    num = np.zeros((B, P), np.int32)
    lanes = np.zeros(B * P * D, np.int8)
    use_o = np.zeros(B * P * C, np.uint8)
    seen = np.zeros((B, P), int)
    stored = {"lanes": np.zeros(B * P * D, int), "use": np.zeros(B * P * C, int)}
    for b in range(B):
        for p0 in range(0, P, TP):
            rows = min(TP, P - p0)
            out0 = b * P + p0
            stage = bytearray(L["dist"])  # the zeroed lane and use stages
            owner = np.full(L["dist"], -1)
            lane_at = L["lanes"] + (base + out0 * D) % 16
            use_at = L["use"] + (out0 * C) % 16
            assert lane_at + rows * D <= L["use"] and use_at + rows * C <= L["dist"]
            for r in range(rows):
                p = p0 + r
                seen[b, p] += 1
                row = tuple(x[p] for x in (node, ok, drain, ppref, spref, dis, mnh))
                use, win, best, req, self_wins = chain(row, dist[b], ovl[b], soft[b],
                                                       int(roots[b]), lean=True)
                for k in range(-(-C // 4)):  # 4 candidates' bits a word, a byte each
                    x = ((((use >> (4 * k)) & 0xF) * 0x00204081) & 0x01010101) & 0xFFFFFFFF
                    or_word(stage, use_at + r * C + 4 * k, x, owner, p)
                words, n = lanes_by_words(nh[b], node[p], win, C, D, staged=True)
                for k, x in enumerate(words):
                    or_word(stage, lane_at + r * D + 4 * k, x, owner, p)
                num[b, p] = n
                metric[b, p] = best
                valid[b, p] = bool(win) and not self_wins and best < BIG32 and n > 0 and n >= req
            for name, dst, at, width, addr in (("lanes", lanes, lane_at, D, base + out0 * D),
                                               ("use", use_o, use_at, C, out0 * C)):
                for start, length, kind in span_pieces(addr, rows * width):
                    if kind == "word":  # aligned in the output and in the stage
                        assert (addr + start) % 16 == 0 and (at + start) % 16 == 0
                    g = out0 * width + start
                    dst[g:g + length] = np.frombuffer(
                        bytes(stage[at + start:at + start + length]), np.int8).view(dst.dtype)
                    stored[name][g:g + length] += 1
    assert (seen == 1).all()
    assert (stored["lanes"] == 1).all() and (stored["use"] == 1).all()
    return (valid, metric, lanes.reshape(B, P, D), num, use_o.reshape(B, P, C).astype(bool))


def _jax_select(args):
    import jax.numpy as jnp
    from openr_tpu.ops.route_select import batched_select_routes as jax_batched_select

    return [np.asarray(x) for x in jax_batched_select(*(jnp.asarray(a) for a in args))]


def _plain(args):
    return [t.numpy() for t in rs.batched_select_routes(*tables_from_numpy(args, "cpu"))]


def _assert_same(got, want):
    assert len(got) == len(want) == 5
    for name, g, w in zip(("valid", "metric", "lanes", "num", "use"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), name


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_tile_model_equals_plain_and_reference(world, tile):
    args = WORLDS[world]()
    B, P, C, D = args[7].shape[0], args[0].shape[0], args[0].shape[1], args[8].shape[-1]
    TP = rs.batched_select_tile_rows(B, P, C, D, 132) if tile is None else tile
    got = tile_model(args, TP)
    want = _plain(args)
    _assert_same(got, want)
    _assert_same(got, _jax_select(args))
    valid = want[0]
    assert valid.any() and not valid.all()
    if world == "lone_fill":  # the -128 row survives its lone winner
        assert (want[2][0, 5] == -128).all() and not valid[0, 5] and want[3][0, 5] < 0
    if world == "wan":  # row 2's root advertises: where it is selected, no route
        own = want[4][2] & (args[0] == args[11][2])
        assert own.any() and not valid[2][own.any(axis=1)].any()


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_lean_chain_equals_full_chain(world):
    """Use, valid, metric, lanes and num of the lean chain with the
    word-wise lanes (read from the staged table or byte by byte) equal
    the full chain's with the reference's bytewise max."""
    args = WORLDS[world]()
    full = select_full(args)
    _assert_same(_select(args, lean=True), full)
    _assert_same(_select(args, lean=True, staged=False), full)


@pytest.mark.parametrize("D", [1, 4, 17, 32, 40, 70])
def test_span_pieces_cover_every_byte_once(D):
    """At every lane width, with P a multiple of no tile, every tile's lane
    and use spans (from every output alignment) are covered once by the
    head, word and tail pieces, and the words are 16-byte aligned; the
    stage regions hold their data wherever it lands mod 16."""
    P, C, V = 45, 4, 40
    for TP in (7, 16, 45):
        L = layout(TP, V, C, D)
        for base in range(16):
            covered = np.zeros(3 * P * D, int)
            for b in range(3):
                for p0 in range(0, P, TP):
                    rows = min(TP, P - p0)
                    addr = base + (b * P + p0) * D
                    for start, length, kind in span_pieces(addr, rows * D):
                        if kind == "word":
                            assert (addr + start) % 16 == 0 and length == 16
                        g = (b * P + p0) * D + start
                        covered[g:g + length] += 1
                    assert addr % 16 + rows * D <= L["use"] - L["lanes"]
            assert (covered == 1).all()
        for src in range(16):  # a staged table at its source's alignment
            assert L["dist"] + src % 16 + 4 * V <= L["soft"]
            assert L["ovl"] + src + V <= L["nh"]
            # a lane word of the last node, read as two aligned words
            last = L["nh"] + src + (V - 1) * D + ((D - 1) // 4) * 4
            assert (last & ~3) + 8 <= L["total"]


def test_tile_rule_takes_a_row_where_it_fits():
    """A whole row a block where its lane and use stage fits 48 KiB and the
    blocks give every SM four; halved otherwise, down to 32; below 32 only
    while the stage does not fit the block's shared memory."""
    assert rs.batched_select_tile_rows(4096, 1088, 4, 17, 132) == 1088
    assert rs.batched_select_tile_rows(4, 17, 4, 4, 132) == 17
    assert rs.batched_select_tile_rows(64, 1088, 4, 17, 132) == 68
    rows = rs.batched_select_tile_rows(4096, 100_000, 4, 17, 132)
    assert rows * 21 <= 49152 and rows >= 32
    for D, want in ((8192, 16), (7000, 32), (100_000, 2), (232_000, 1)):
        rows = rs.batched_select_tile_rows(1, 64, 4, D, 132)
        assert rows == want
        assert rs.batched_select_stage_bytes(rows, 4, D) <= rs.BATCHED_SELECT_SMEM
        assert layout(rows, 1, 4, D)["dist"] == rs.batched_select_stage_bytes(rows, 4, D)
    assert rs.batched_select_stage_bytes(1, 4, 233_000) > rs.BATCHED_SELECT_SMEM


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _on_card(args, card):
    return tables_from_numpy(args, card)


def _held(args):
    """Kernel 17 once, against its plain version on the same inputs."""
    reset_launch_counts()
    got = rs.batched_select_routes(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_select_routes"] == 1
    want = rs.batched_select_routes_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[0].any())


def _staged(args):
    """What the launcher stages for these arguments (``batched_layout``
    against the block's shared memory): "all", "rows" or "none"."""
    node, nh = args[0], args[8]
    B, V, D = nh.shape
    P, C = node.shape
    sms = torch.cuda.get_device_properties(nh.device).multi_processor_count
    L = layout(min(rs.batched_select_tile_rows(B, P, C, D, sms), P), V, C, D)
    smem = rs.BATCHED_SELECT_SMEM
    return "all" if L["total"] <= smem else "rows" if L["nh"] <= smem else "none"


#: (B, V, P, C, D, seed) of shapes whose row and lane tables the launcher
#: stages, whose lane table does not fit, and whose row tables do not fit
STAGE_SHAPES = {
    "all": (3, 40, 45, 4, 17, 5),
    "rows": (2, 4096, 45, 4, 64, 5),
    "none": (2, 27_000, 45, 4, 4, 5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [None, 7, 13])
@pytest.mark.parametrize("D", [1, 4, 17, 32, 40, 70])
def test_batched_select_tile_kernel_equals_plain(card, D, tile, monkeypatch):
    """Kernel 17 at every lane width and tile shape (a tail tile where TP
    does not divide P = 45)."""
    args = _on_card(synthetic(5, 40, 45, 4, D, D), card)
    if tile is not None:
        monkeypatch.setattr(rs, "batched_select_tile_rows", lambda *_shape: tile)
    _held(args)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", sorted(STAGE_SHAPES))
def test_batched_select_tile_kernel_stage_layouts_equal_plain(card, stage):
    """Kernel 17 with its row and lane tables staged, the row tables alone
    (the lane table does not fit) and neither (the row tables do not fit:
    read from L2)."""
    args = _on_card(synthetic(*STAGE_SHAPES[stage]), card)
    assert _staged(args) == stage
    _held(args)


@pytest.mark.cuda
def test_batched_select_tile_kernel_at_wide_lanes_equals_plain(card):
    """Kernel 17 at D 8,192 (a hub's lanes), where a tile of 32 prefixes'
    lane bytes would not fit the block's shared memory: the rule's tile
    of 18 (70 halved twice, rounded up), with a tail tile."""
    args = _on_card(synthetic(2, 64, 70, 4, 8192, 11), card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert rs.batched_select_tile_rows(2, 70, 4, 8192, sms) == 18
    _held(args)


@pytest.mark.cuda
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_batched_select_tile_kernel_on_the_worlds_equals_plain(card, world):
    """Kernel 17 on the model's worlds (anycast with drains and an
    advertising root, the lone -128 winner, 64 candidates, 70 lanes)."""
    _held(_on_card(WORLDS[world](), card))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["all", "none"])
def test_batched_select_tile_kernel_on_unaligned_tables_equals_plain(card, stage):
    """Kernel 17 where dist starts 4 bytes and the lane table 1 byte past a
    16-byte boundary (views into their storage), at D = 17, the tables
    staged or read from L2."""
    V = STAGE_SHAPES[stage][1]
    args = _on_card(synthetic(4, V, 45, 4, 17, 5), card)
    dist, nh = args[7], args[8]
    fd = torch.empty(dist.numel() + 1, dtype=dist.dtype, device=card)
    fn = torch.empty(nh.numel() + 1, dtype=nh.dtype, device=card)
    sd, sn = fd[1:].view(dist.shape), fn[1:].view(nh.shape)
    sd.copy_(dist)
    sn.copy_(nh)
    args = [*args[:7], sd, sn, *args[9:]]
    assert _staged(args) == stage
    _held(args)
