"""Kernel 10 (``select_chunk``) as redesigned for the card: a numpy model
of its tiles of snapshots x prefixes, held against the port's plain version
(``ops/sweep_select.py`` ``select_chunk_plain``) and the JAX package's
``_select_chunk`` (``openr_tpu/ops/sweep_select.py:155``).

* The mapping: a block takes one 32-snapshot word and a tile of prefixes.
  Where the chunk holds 32 snapshots or more, a warp takes one prefix and a
  warp lane one snapshot; below 32, the snapshots round up to a power of
  two bp and a warp takes 32 / bp prefixes of bp lanes (at b = 1: 32
  consecutive prefixes of the one snapshot, stored directly).  The tile is
  32 prefixes where bp >= 8, else 256 / bp, covered by 256 threads in
  passes.  The model walks every (block, pass, warp, lane) and checks that
  each (snapshot, prefix) is computed once, that a warp's stage stores hit
  32 banks, and that the transposed stores (a warp: 32 consecutive
  prefixes of one snapshot) cover every output once, the changed word
  being the ballot of the staged flags; prefixes past P and snapshots past
  b are masked.
* The chain itself is computed per lane from the lane's distance column
  (one coalesced line per candidate) and, for a winner, the broadcast words
  nh[node, d, sw], each lane taking its own bit; where a warp is one
  prefix, the kernel loads a winner's 32 lane words at once, a word a lane,
  and transposes the 32 x 32 bits across the warp, which a test holds to
  the broadcast words; where at most one candidate survives the reach and
  hard-drain filters, the kernel skips the keep-max and keep-min filters,
  which the model shows keep it as it is.
* Worlds: a grid, the first area of the 3-area world of
  ``tests/test_torch_warm.py`` (an overloaded node), an overloaded root, a
  drained node with soft drains, a WAN whose candidates are 64 wide
  (C = 64), a hub whose root has 40 lanes (D > 32), and D = 160 (lane
  words past the stage); chunks of b = 1, 3, 8, 20, 33 and 70 snapshots
  (b % 32 != 0 where b > 32), P not a multiple of 32.

The ``cuda`` cases run kernel 10 against its plain version at every
mapping (b = 1, 2, 4, 8, 16, 20, 32, 33, 70) over the same worlds, with
its lane words staged and (D = 160) stored by each lane.  Tolerance: exact
equality.  This module imports no JAX at import time, so that its ``cuda``
cases run where JAX is absent.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.emulation import topology as ttopo
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops import sweep_select as ss
from openr_tpu_torch.ops.bits import pack_bits_last
from openr_tpu_torch.ops.consts import BIG

INT32_MIN = np.iinfo(np.int32).min


def _hub(leaves):
    """me joined to every leaf, the leaves on a ring: 40 root lanes."""
    return [("me", f"h{i}", 1 + i % 3) for i in range(leaves)] + [
        (f"h{i}", f"h{(i + 1) % leaves}", 2) for i in range(leaves)
    ]


#: name -> (edges, drains, root, candidate width, soft-drained nodes, D)
WORLDS = {
    "grid": (ttopo.grid_edges(6, prefix="n") + [("n0", "me", 1), ("n5", "me", 1)], {}, "me", 4,
             (), None),
    "area1": (ttopo.random_connected_edges(12, 8, seed=5, prefix="a") + [("a0", "me", 1)],
              {"overloaded": ["a4"]}, "me", 3, (), None),
    "root_overloaded": (ttopo.grid_edges(5, prefix="n") + [("n0", "me", 1), ("n4", "me", 2)],
                        {"overloaded": ["me", "n12"]}, "me", 4, (), None),
    "drained": (ttopo.random_connected_edges(40, 60, seed=11, prefix="n") + [("n0", "me", 1)],
                {"overloaded": ["n3"]}, "me", 4, ("n7", "n9"), None),
    "wide": (ttopo.random_connected_edges(40, 60, seed=2, prefix="n")
             + [("n0", "me", 1), ("n17", "me", 3)], {}, "me", 64, (), None),
    "hub40": (_hub(40), {}, "me", 2, (), 40),
    "d160": (_hub(24), {}, "me", 2, (), 160),
}
SNAPSHOTS = (1, 3, 8, 20, 33, 70)


def _world(name):
    edges, drains, root, C, soft_nodes, D = WORLDS[name]
    ls = LinkState("0", root)
    for db in ttopo.build_adj_dbs(edges, **drains).values():
        ls.update_adjacency_database(db)
    topo = csr.encode_link_state(ls)
    soft = np.zeros(topo.padded_nodes, np.int32)
    for i, n in enumerate(soft_nodes):
        soft[topo.node_id(n)] = 3 + i
    D = D or csr.bucket_for(max(topo.max_out_degree(), 1), (4, 8, 16, 32))
    return topo, topo.node_id(root), C, soft, D


def candidates(V, P, C, seed):
    """[P, C] columns with anycast, drains, preferences, distances,
    min-nexthop gates, the root's own prefix and empty slots."""
    rng = np.random.default_rng(seed)
    node = rng.integers(0, V, size=(P, C)).astype(np.int32)
    node[: min(P, V), 0] = np.arange(min(P, V))
    ok = rng.random((P, C)) < 0.7
    ok[: min(P, V), 0] = True
    return (
        node, ok,
        (rng.random((P, C)) < 0.15).astype(np.int32) * 5,
        rng.choice([100, 200], size=(P, C)).astype(np.int32),
        rng.choice([100, 150], size=(P, C)).astype(np.int32),
        rng.integers(0, 3, size=(P, C)).astype(np.int32),
        (rng.random((P, C)) < 0.1).astype(np.int32) * 2,
    )


def chunk_inputs(name, b, seed=0):
    """The arguments of kernel 10 on world ``name`` at a chunk of ``b``
    snapshots: the cold sweep's tables (kernel 8's plain version) of b
    seeded failures, lanes packed over the snapshots; the base routes of
    the unperturbed solve as ``SweepRouteSelector.base_routes`` selects
    them (the plain version at b = 1, against an all-zero base)."""
    topo, root, C, soft, D = _world(name)
    V = topo.padded_nodes
    rng = np.random.default_rng(seed + b)
    fails = rng.integers(-1, len(topo.links), size=b).astype(np.int32)
    edges = [torch.from_numpy(np.ascontiguousarray(getattr(topo, f)))
             for f in ("src", "dst", "w", "edge_ok", "link_index")]
    ovl = torch.from_numpy(topo.overloaded)
    dist, nh, _rd, _rl = spf.sweep_spf_link_failures_plain(*edges, torch.from_numpy(fails), ovl,
                                                           root, D)
    words = pack_bits_last((nh > 0).permute(0, 2, 1), b)  # [V, D, Bw]
    P = 3 * topo.num_nodes + 5 if (3 * topo.num_nodes + 5) % 32 else 3 * topo.num_nodes + 6
    cands = [torch.from_numpy(c) for c in candidates(topo.num_nodes, P, C, seed)]
    soft_t = torch.from_numpy(soft)
    bd, bn, _r1, _r2 = spf.sweep_spf_link_failures_plain(
        *edges, torch.tensor([-1], dtype=torch.int32), ovl, root, D)
    Dw = -(-D // 32)
    zero = (torch.zeros(P, dtype=torch.bool), torch.zeros(P, dtype=torch.float32),
            torch.zeros((P, Dw), dtype=torch.int32))
    base_words = pack_bits_last((bn > 0).permute(0, 2, 1), 1)
    _c, bv, bm, bl = ss.select_chunk_plain(bd, base_words, ovl, soft_t, root, *cands, *zero, D)
    return (dist, words, ovl, soft_t, root, *cands, bv[0], bm[0], bl[0], D)


def tile_shape(b):
    """(bshift, lanes a prefix bp, prefixes a warp G, prefixes a tile TP,
    stage row stride) of kernel 10 at b snapshots."""
    bshift = 0
    while (1 << bshift) < b and bshift < 5:
        bshift += 1
    bp = 1 << bshift
    G = 32 >> bshift
    TP = 32 if bp >= 8 else 256 >> bshift
    return bshift, bp, G, TP, TP + G


def chain(args):
    """The selection chain of every lane, each read as the kernel reads
    it: the lane's own distance column (one line per candidate), the
    candidate row of its lane group, and for a winner the broadcast words
    nh[node, d, sw], of which the lane takes bit s % 32.  Returns (valid
    [b, P], metric [b, P] f32, lane words [b, P, Dw] uint32)."""
    dist, nh, ovl, soft, root, node, ok, drain, ppref, spref, dis, mnh = (
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args[:12])
    D = args[15]
    b = dist.shape[1]
    dc = dist[node].transpose(2, 0, 1)  # [b, P, C]
    reach = ok[None] & (dc < BIG)
    nonhard = reach & ~ovl[node][None]
    use = np.where(nonhard.any(-1, keepdims=True), nonhard, reach)
    before = use
    key = np.where((drain > 0) | (soft[node] > 0), 0, 1)
    for vals, pick in ((key, np.max), (ppref, np.max), (spref, np.max), (dis, np.min)):
        vals = np.broadcast_to(vals.astype(np.int64), use.shape)
        fill = np.iinfo(np.int64).min if pick is np.max else np.iinfo(np.int64).max
        best = pick(np.where(use, vals, fill), axis=-1, keepdims=True)
        use = use & (vals == best)
    # the kernel skips these filters where at most one candidate is left:
    # they keep it as it is
    one_left = before.sum(-1) <= 1
    assert (use == before)[one_left].all()
    self_wins = (use & (node == root)[None]).any(-1)
    best_igp = np.minimum(np.float32(BIG), np.where(use, dc, np.float32(BIG)).min(-1))
    req = np.where(use, mnh[None], 0).max(-1)
    winners = use & (dc == best_igp[..., None])
    s = np.arange(b)
    bits = (nh.view(np.uint32)[:, :, s // 32] >> (s % 32).astype(np.uint32)) & 1  # [V, D, b]
    bits = bits.transpose(2, 0, 1).astype(bool)  # [b, V, D]
    lanes = (bits[s[:, None, None], node[None]] & winners[..., None]).any(2)  # [b, P, D]
    Dw = -(-D // 32)
    pad = np.zeros(lanes.shape[:2] + (32 * Dw,), bool)
    pad[..., :D] = lanes
    words = (pad.reshape(*lanes.shape[:2], Dw, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    num = lanes.sum(-1)
    valid = winners.any(-1) & ~self_wins & (best_igp < BIG) & (num > 0) & (num >= req)
    return valid, best_igp.astype(np.float32), words


def tile_model(args):
    """Kernel 10, block by block, pass by pass, a warp's 32 lanes at a
    time, with its stage and its transposed stores: (changed [b, Pw],
    valid [b, P], metric [b, P], lanes [b, P, Dw]) as int32 / bool / f32 /
    int32."""
    dist = args[0]
    base_valid, base_metric, base_lanes, D = (
        args[12].numpy(), args[13].numpy(), args[14].numpy().view(np.uint32), args[15])
    cv, cm, cw = chain(args)
    b = dist.shape[1]
    P = args[5].shape[0]
    Pw, Dw = -(-P // 32), -(-D // 32)
    bshift, bp, G, TP, stride = tile_shape(b)
    direct = bp == 1
    changed = np.zeros((b, Pw), np.uint32)
    valid = np.zeros((b, P), bool)
    metric = np.zeros((b, P), np.float32)
    lanes = np.zeros((b, P, Dw), np.uint32)
    seen = np.zeros((b, P), int)
    lane = np.arange(32)
    sl, q = lane & (bp - 1), lane >> bshift
    passes = (TP << bshift) // 256
    assert passes >= 1
    for bx in range(-(-P // TP)):
        for sw in range(-(-b // 32)):
            s = sw * 32 + sl
            sc = np.minimum(s, b - 1)
            st_v = np.zeros(32 * 33, bool)
            st_m = np.zeros(32 * 33, np.float32)
            st_w = np.zeros((32 * 33, Dw), np.uint32)
            st_c = np.zeros(32 * 33, bool)
            taken = np.zeros(32 * 33, bool)
            for pas in range(passes):
                for warp in range(8):
                    pl = (pas * 8 + warp) * G + q
                    p = bx * TP + pl
                    live = (p < P) & (s < b)
                    pc = np.minimum(p, P - 1)
                    v, m, w = cv[sc, pc], cm[sc, pc], cw[sc, pc]
                    bv = base_valid[pc]
                    differ = (w != base_lanes[pc]).any(-1)
                    ch = live & ((v != bv) | (v & bv & ((m != base_metric[pc]) | differ)))
                    seen[s[live], p[live]] += 1
                    if direct:  # 32 consecutive prefixes of snapshot 0
                        valid[s[live], p[live]] = v[live]
                        metric[s[live], p[live]] = m[live]
                        lanes[s[live], p[live]] = w[live]
                        if p[0] < P:
                            changed[0, p[0] // 32] = int((ch.astype(np.uint64) << lane.astype(np.uint64)).sum())
                        continue
                    at = sl * stride + pl
                    assert len(np.unique(at % 32)) == 32  # 32 banks
                    assert not taken[at].any() and at.max() < 32 * 33
                    taken[at] = True
                    st_v[at], st_m[at], st_w[at], st_c[at] = v, m, w, ch
            if direct:
                continue
            segs = TP // 32
            for j in range(segs << bshift):
                s_loc, seg = divmod(j, segs)
                st = sw * 32 + s_loc
                if st >= b:
                    continue
                pl = seg * 32 + lane
                p = bx * TP + pl
                at = s_loc * stride + pl
                inn = p < P
                valid[st, p[inn]] = st_v[at][inn]
                metric[st, p[inn]] = st_m[at][inn]
                lanes[st, p[inn]] = st_w[at][inn]
                if inn[0]:
                    changed[st, p[0] // 32] = int(((inn & st_c[at]).astype(np.uint64) << lane.astype(np.uint64)).sum())
    assert (seen == 1).all()  # every (snapshot, prefix) computed once
    return (torch.from_numpy(changed.view(np.int32)), torch.from_numpy(valid),
            torch.from_numpy(metric), torch.from_numpy(lanes.view(np.int32)))


def _jax_select_chunk(args):
    import jax.numpy as jnp
    from openr_tpu.ops import sweep_select as jss

    dist, nh, ovl, soft, root, *cands, bv, bm, bl, D = args
    out = jss._select_chunk(
        jnp.asarray(dist.numpy()), jnp.asarray(nh.numpy().view(np.uint32)),
        jnp.asarray(ovl.numpy()), jnp.asarray(soft.numpy()), jnp.int32(root),
        *(jnp.asarray(c.numpy()) for c in cands), jnp.asarray(bv.numpy()),
        jnp.asarray(bm.numpy()), jnp.asarray(bl.numpy().view(np.uint32)), max_degree=D)
    return [np.asarray(o) for o in out]


def _assert_equal(got, want):
    for name, g, w in zip(("changed", "valid", "metric", "lanes"), got, want):
        w = np.asarray(w)
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("b", SNAPSHOTS)
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_tile_model_equals_plain_and_reference(world, b):
    args = chunk_inputs(world, b)
    got = tile_model(args)
    plain = ss.select_chunk_plain(*args)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    _assert_equal(got, _jax_select_chunk(args))
    if b > 1:
        assert bool(got[1].any())


def test_tile_shapes_cover_every_mapping():
    """bp is the snapshots rounded up to a power of two, 32 at most; a
    tile is 32 prefixes from bp = 8, 256 / bp below; the stage rows fit
    32 x 33 and a warp's stores hit 32 banks (stride = G mod 32)."""
    shapes = {b: tile_shape(b) for b in (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 1152)}
    assert [shapes[b][1] for b in (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 1152)] == [
        1, 2, 4, 4, 8, 8, 16, 16, 32, 32, 32, 32, 32]
    for b, (bshift, bp, G, TP, stride) in shapes.items():
        assert bp * G == 32 and TP % 32 == 0 and (TP * bp) % 256 == 0
        assert bp * stride <= 32 * 33 and stride % 32 == G % 32
        banks = {(s * stride + q) % 32 for s in range(bp) for q in range(G)}
        assert len(banks) == 32


def transpose_bits(rows):
    """The kernel's 32 x 32 bit transpose across a warp (5 butterfly
    exchanges): lane l holds row l; lane s ends with column s."""
    x = rows.astype(np.uint64)
    lane = np.arange(32)
    for j, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                 (1, 0x55555555)):
        nm = ~m & 0xFFFFFFFF
        y = x[lane ^ j]
        x = np.where(lane & j, (x & nm) | ((y & nm) >> j), (x & m) | ((y & m) << j)) & 0xFFFFFFFF
    return x.astype(np.uint32)


@pytest.mark.parametrize("world", ["grid", "hub40", "d160"])
def test_lane_words_by_bit_transpose(world):
    """Where a warp is one prefix (bp = 32), lane l loads the word of lane
    32 k + l of the winner (its bits the word's 32 snapshots) and the warp
    transposes: lane s then holds the bits the broadcast words give it."""
    args = chunk_inputs(world, 70)
    nh = args[1].numpy().view(np.uint32)  # [V, D, Bw]
    V, D, Bw = nh.shape
    for node in range(0, V, max(1, V // 7)):
        for sw in range(Bw):
            for k in range(-(-D // 32)):
                d = 32 * k + np.arange(32)
                rows = np.where(d < D, nh[node, np.minimum(d, D - 1), sw], 0).astype(np.uint32)
                got = transpose_bits(rows)
                for s in range(32):
                    want = sum(((int(nh[node, dd, sw]) >> s) & 1) << (dd - 32 * k)
                               for dd in range(32 * k, min(D, 32 * k + 32)))
                    assert int(got[s]) == want


def test_tail_prefixes_and_snapshots_are_masked():
    """P = 3 V + 5 leaves a partial changed word; b = 33 a partial
    snapshot word: the model's outputs there equal the plain version's
    and no bit past P is set."""
    args = chunk_inputs("grid", 33)
    got = tile_model(args)
    P = args[5].shape[0]
    assert P % 32 and args[0].shape[1] % 32
    tail = P % 32
    assert not bool((got[0][:, -1] >> tail).any())
    plain = ss.select_chunk_plain(*args)
    assert all(torch.equal(g, p) for g, p in zip(got, plain))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 20, 32, 33, 70])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_chunk_select_tile_kernel_equals_plain(card, world, b):
    """Kernel 10 at every lane mapping (bp = 1, 2, 4, 8, 16 and 32, words
    with a tail), lane words staged or (D = 160) stored by each lane,
    against its plain version."""
    args = [a.to(card) if isinstance(a, torch.Tensor) else a for a in chunk_inputs(world, b)]
    reset_launch_counts()
    got = ss.select_chunk(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["select_chunk"] == 1
    want = ss.select_chunk_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
