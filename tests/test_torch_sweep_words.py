"""Kernel 8 (``sweep_spf_link_failures``) as redesigned for the card: a
torch model of its layout and of its word-at-a-time solve, held against
the port's plain version and the JAX package's jitted
``openr_tpu.ops.spf.sweep_spf_link_failures``.

* The layout: each usable edge (edge_ok, and its source not overloaded or
  the root) becomes a record {src, w, link id, lane rank (-1 unless its
  source is the root)}, grouped by the vertex it enters (in any order
  within a vertex), the vertices ordered by (owner block, local index) for
  a cluster of C blocks (vertex v at block v % C, local v // C); the lanes
  a seed can reach are 1 + the highest usable rank below D.  The model
  checks it vertex by vertex against the edge list.
* The solve, one 32-snapshot word at a time (a lane past B mirrors the
  word's first snapshot): distance rounds over the records, the failed
  link dropped per snapshot by its link id; then each record's DAG
  membership word (bit b: the edge is on snapshot b's shortest-path DAG),
  and OR rounds over bit words, one uint32 per (vertex, lane), a root
  record ORing its membership word into the lane of its rank and any other
  record its source's word masked by its membership; the int8 [V, B, D]
  table written once, -128 where the vertex's run is empty.
* Cases: the worlds of ``tests/test_torch_spf_sweep.py`` (wan48, grid6,
  overloaded, line) and an overloaded root, a hub whose root has 40
  lanes (D > 32); the unperturbed snapshot, every link once (on and off
  the DAG), seeded random draws and -1 pads, B not a multiple of 32;
  clusters of 1, 2, 4 and 8.

The ``cuda`` cases run kernel 8 against its plain version over the same
worlds and failures at every cluster size the launcher can pick, with the
state in shared memory and (a budget of 0) in the global scratch.
Tolerance: exact equality (integral metrics keep every f32 sum exact; the
fixed points are unique).  This module imports no JAX at import time, so
that its ``cuda`` cases run where JAX is absent.
"""

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.emulation import topology as ttopo
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops.consts import BIG

WORD = 32
FIELDS = ("src", "dst", "w", "edge_ok", "link_index", "overloaded")


def _line(n):
    return [(f"node{i}", f"node{i + 1}", 1) for i in range(n - 1)]


def _hub(leaves):
    """node0 joined to every leaf (node1...), the leaves on a ring: 40
    root lanes."""
    return [("node0", f"node{i + 1}", 1 + i % 3) for i in range(leaves)] + [
        (f"node{i + 1}", f"node{(i + 1) % leaves + 1}", 2) for i in range(leaves)
    ]


WORLDS = {
    "wan48": (lambda: ttopo.random_connected_edges(48, 64, seed=11), {}),
    "grid6": (lambda: ttopo.grid_edges(6), {}),
    "overloaded": (lambda: ttopo.random_connected_edges(48, 64, seed=5),
                   {"overloaded": ["node7", "node9"]}),
    "line": (lambda: _line(8), {}),
    "root_overloaded": (lambda: ttopo.grid_edges(5), {"overloaded": ["node0", "node12"]}),
    "hub40": (lambda: _hub(40), {}),
}


def encode(world):
    edges, drains = WORLDS[world]
    ls = LinkState("0", "node0")
    for db in ttopo.build_adj_dbs(edges(), **drains).values():
        ls.update_adjacency_database(db)
    return csr.encode_link_state(ls)


def failures(topo, seed, extra=41):
    """The unperturbed snapshot, every link once, seeded draws with -1
    pads: 1 + L + 41 snapshots, not a multiple of 32 on these worlds."""
    L = len(topo.links)
    rng = np.random.default_rng(seed)
    return np.concatenate([[-1], np.arange(L), rng.integers(-1, L, size=extra)]).astype(np.int32)


def lanes_for(topo, world):
    return max(topo.max_out_degree(), 1) if world != "hub40" else 40


def layout_model(src, dst, w, edge_ok, link_index, overloaded, root, D, cluster):
    """Kernel 8's layout kernel: (records [n, 4] int64 {src, bits of w,
    link, rank}, the vertex of each record [n], rec_off [C S + 1] by key
    r S + j of vertex j C + r, lanes the seeds can reach)."""
    V, E = overloaded.shape[0], src.shape[0]
    s, t = src.long(), dst.long()
    usable = edge_ok & (~overloaded[s] | (s == root))
    pos = torch.zeros(E + 1, dtype=torch.int64)
    pos[1:] = torch.cumsum(usable.to(torch.int64), 0)
    seg_off = spf.segment_offsets(dst[None], V)[0].long()
    S = -(-V // cluster)
    keys = torch.arange(cluster * S)
    kv = (keys % S) * cluster + keys // S
    present = kv < V
    vk = kv.clamp(max=V - 1)
    count = torch.where(present, pos[seg_off[vk + 1]] - pos[seg_off[vk]], 0)
    rec_off = torch.zeros(cluster * S + 1, dtype=torch.int64)
    rec_off[1:] = torch.cumsum(count, 0)
    key_of = (t % cluster) * S + t // cluster
    at = rec_off[key_of] + pos[:E] - pos[seg_off[t]]
    rank = spf.root_lane_rank(src[None], torch.tensor([root], dtype=torch.int32))[0].long()
    rank = torch.where(s == root, rank, torch.full_like(rank, -1))
    n = int(usable.sum())
    recs = torch.zeros((n, 4), dtype=torch.int64)
    rec_v = torch.zeros(n, dtype=torch.int64)
    idx = at[usable]
    recs[idx] = torch.stack(
        [s, w.view(torch.int32).long(), link_index.long(), rank], 1)[usable]
    rec_v[idx] = t[usable]
    seeded = rank[usable & (rank >= 0) & (rank < D)]
    L = int(seeded.max()) + 1 if seeded.numel() else 0
    return recs, rec_v, rec_off, L


def pack32(bits):
    """[n, 32] bool -> [n] int64 word, bit b from column b."""
    return (bits.to(torch.int64) << torch.arange(WORD)).sum(-1)


def words_model(recs, rec_v, L, failed, dst, V, D, root):
    """Kernel 8's solve over the layout's records, word by word: (dist
    [V, B] f32, nh [V, B, D] int8)."""
    B = failed.shape[0]
    big = torch.tensor(BIG, dtype=torch.float32)
    rsrc, rw = recs[:, 0], recs[:, 1].to(torch.int32).view(torch.float32)
    rlink, rrank = recs[:, 2], recs[:, 3]
    is_root = rsrc == root
    empty = torch.bincount(dst.long(), minlength=V) == 0
    dist = torch.empty((V, B), dtype=torch.float32)
    nh = torch.empty((V, B, D), dtype=torch.int8)
    for word in range(-(-B // WORD)):
        cols = torch.arange(word * WORD, word * WORD + WORD)
        live = cols < B
        f = failed[torch.where(live, cols, word * WORD)].long()
        on_edge = rlink[:, None] != f[None, :]  # [n, 32]
        d = torch.full((V, WORD), BIG, dtype=torch.float32)
        d[root] = 0.0
        while True:
            cand = torch.where(on_edge, d[rsrc] + rw[:, None], big)
            nd = d.scatter_reduce(0, rec_v[:, None].expand(-1, WORD), cand, "amin")
            if torch.equal(nd, d):
                break
            d = nd
        dv = d[rec_v]
        member = pack32(on_edge & (dv < big) & (d[rsrc] + rw[:, None] == dv))  # [n]
        # bit words [V, L], bit b of (v, l): snapshot b
        bits = torch.zeros((V, max(L, 1), WORD), dtype=torch.bool)
        mbits = ((member[:, None] >> torch.arange(WORD)) & 1).bool()  # [n, 32]
        lanes = torch.arange(max(L, 1))
        seed = (is_root[:, None] & (rrank[:, None] == lanes))[:, :, None] & mbits[:, None, :]
        while True:
            contrib = seed | ((~is_root)[:, None, None] & bits[rsrc] & mbits[:, None, :])
            at = rec_v[:, None, None].expand_as(contrib)
            new = bits.to(torch.uint8).scatter_reduce(0, at, contrib.to(torch.uint8), "amax").bool()
            if torch.equal(new, bits):
                break
            bits = new
        dist[:, cols[live]] = d[:, live]
        out = torch.zeros((V, WORD, D), dtype=torch.int8)
        if L:
            out[:, :, :L] = bits[:, :L, :].permute(0, 2, 1).to(torch.int8)
        out[empty] = spf.INT8_MIN
        nh[:, cols[live]] = out[:, live]
    return dist, nh


def port_tensors(topo, fails):
    t = tables_from_numpy([getattr(topo, f) for f in FIELDS] + [fails])
    src, dst, w, ok, li, ovl, failed = t
    return src, dst, w, ok, li, failed, ovl


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_layout_lists_every_usable_edge_by_owner(world, cluster):
    topo = encode(world)
    src, dst, w, ok, li, _failed, ovl = port_tensors(topo, np.zeros(1, np.int32))
    D = lanes_for(topo, world)
    recs, rec_v, rec_off, L = layout_model(src, dst, w, ok, li, ovl, 0, D, cluster)
    V = ovl.shape[0]
    S = -(-V // cluster)
    usable = ok & (~ovl[src.long()] | (src == 0))
    assert recs.shape[0] == int(usable.sum()) == int(rec_off[-1])
    for v in range(V):
        k = (v % cluster) * S + v // cluster
        got = recs[rec_off[k]:rec_off[k + 1]]
        assert (rec_v[rec_off[k]:rec_off[k + 1]] == v).all()
        # the kernel places a vertex's records in any order (min and OR
        # take them so): compared as sets of (src, w, link)
        e = torch.nonzero(usable & (dst == v)).flatten()
        want = torch.stack([src[e].long(), w[e].view(torch.int32).long(), li[e].long()], 1)
        assert sorted(map(tuple, got[:, :3].tolist())) == sorted(map(tuple, want.tolist()))
    # every root out-edge is usable here, so the ranks run 0..out-1
    assert L == min(int((src[usable] == 0).sum()), D)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_word_model_equals_plain_and_reference(world):
    from openr_tpu.ops import spf as jspf  # the reference, on the CPU only
    import jax.numpy as jnp

    topo = encode(world)
    fails = failures(topo, seed=3)
    assert len(fails) % WORD
    D = lanes_for(topo, world)
    src, dst, w, ok, li, failed, ovl = port_tensors(topo, fails)
    V = ovl.shape[0]
    want_d, want_n, _, _ = spf.sweep_spf_link_failures_plain(src, dst, w, ok, li, failed, ovl, 0, D)
    for cluster in (1, 8):
        recs, rec_v, _off, L = layout_model(src, dst, w, ok, li, ovl, 0, D, cluster)
        dist, nh = words_model(recs, rec_v, L, failed, dst, V, D, 0)
        assert torch.equal(dist, want_d) and torch.equal(nh, want_n), cluster
    ref_d, ref_n = jspf.sweep_spf_link_failures(
        *(jnp.asarray(getattr(topo, f)) for f in ("src", "dst", "w", "edge_ok", "link_index")),
        jnp.asarray(fails), jnp.asarray(topo.overloaded), jnp.int32(0), max_degree=D)
    assert np.array_equal(dist.numpy(), np.asarray(ref_d))
    assert np.array_equal(nh.numpy(), np.asarray(ref_n))


def test_word_model_lanes_past_32_and_the_empty_run():
    """The hub's root has 40 lanes: lanes 32-39 live in the second half of
    the lane range; the padded vertices keep -128 in every snapshot."""
    topo = encode("hub40")
    fails = failures(topo, seed=5, extra=7)
    src, dst, w, ok, li, failed, ovl = port_tensors(topo, fails)
    V = ovl.shape[0]
    recs, rec_v, _off, L = layout_model(src, dst, w, ok, li, ovl, 0, 40, 4)
    assert L == 40
    dist, nh = words_model(recs, rec_v, L, failed, dst, V, 40, 0)
    want_d, want_n, _, _ = spf.sweep_spf_link_failures_plain(src, dst, w, ok, li, failed, ovl, 0, 40)
    assert torch.equal(dist, want_d) and torch.equal(nh, want_n)
    assert (nh[:, 0, 32:] == 1).any()
    absent = [v for v in range(V) if v not in set(dst.tolist())]
    assert absent and (nh[absent] == spf.INT8_MIN).all()


def test_cluster_rule_takes_8_blocks_where_there_are_8_vertices():
    assert [spf.sweep_cluster_size(V) for V in (1024, 64, 8, 5, 2, 1)] == [8, 8, 8, 4, 2, 1]


def test_word_model_root_overloaded_still_transits():
    """An overloaded root relaxes its out-edges (it is the SPF root); an
    overloaded transit node relaxes none of its own."""
    topo = encode("root_overloaded")
    fails = np.full(5, -1, np.int32)
    src, dst, w, ok, li, failed, ovl = port_tensors(topo, fails)
    assert bool(ovl[0])
    D = lanes_for(topo, "root_overloaded")
    recs, rec_v, _off, L = layout_model(src, dst, w, ok, li, ovl, 0, D, 2)
    dist, nh = words_model(recs, rec_v, L, failed, dst, ovl.shape[0], D, 0)
    n12 = topo.node_id("node12")
    assert not (recs[:, 0] == n12).any() and (recs[:, 0] == 0).any()
    reached = dist[: topo.num_nodes, 0] < BIG
    assert bool(reached.all())
    want_d, want_n, _, _ = spf.sweep_spf_link_failures_plain(src, dst, w, ok, li, failed, ovl, 0, D)
    assert torch.equal(dist, want_d) and torch.equal(nh, want_n)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _kernel_equals_plain(card, world, seed):
    topo = encode(world)
    fails = failures(topo, seed=seed)
    D = lanes_for(topo, world)
    src, dst, w, ok, li, failed, ovl = (t.to(card) for t in port_tensors(topo, fails))
    reset_launch_counts()
    got_d, got_n, rd, rl = spf.sweep_spf_link_failures(src, dst, w, ok, li, failed, ovl, 0, D)
    torch.cuda.synchronize()
    assert LAUNCHES["sweep_spf_link_failures"] == 1
    want_d, want_n, _, _ = spf.sweep_spf_link_failures_plain(src, dst, w, ok, li, failed, ovl, 0, D)
    assert torch.equal(got_d, want_d) and torch.equal(got_n, want_n)
    assert rd.shape == rl.shape == (-(-len(fails) // WORD),) and int(rd.min()) >= 1


def _state_ints(topo, D, cluster):
    """(head, a block's owned state, a copy of every vertex's state) of
    kernel 8 in int32 words, as ``spf.sweep_layout`` sizes them."""
    V = topo.padded_nodes
    S = -(-V // cluster)
    return ((2 * S + 1 + 3) // 4 * 4, (S * (32 + D) + 3) // 4 * 4, (V * (32 + D) + 3) // 4 * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["copies", "owned", "global"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sweep_word_kernel_equals_plain(card, world, cluster, state, monkeypatch):
    """Kernel 8 on clusters of 1-8 blocks a word, each block with a copy
    of every vertex's state (a cluster of 1: its own), or, shared memory
    cut below the copies, its owned vertices' state and records, or (a
    budget of 0) its state in the global scratch, against its plain
    version: every link once, random draws, -1 pads, B % 32 != 0."""
    topo = encode(world)
    E, D = len(topo.src), lanes_for(topo, world)
    head, owned, _every = _state_ints(topo, D, cluster)
    monkeypatch.setattr(spf, "SWEEP_CLUSTER", cluster)
    if state == "owned":
        monkeypatch.setattr(spf, "SWEEP_SHARED_BYTES", 4 * (head + owned + 4 * E))
    if state == "global":
        monkeypatch.setattr(spf, "SWEEP_SHARED_BYTES", 0)
    want = {"copies": 2 if cluster > 1 else 1, "owned": 1, "global": 0}[state]
    assert spf.sweep_layout(topo.padded_nodes, E, 32, D, cluster)[1] == want
    _kernel_equals_plain(card, world, cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["copies", "owned"])
@pytest.mark.parametrize("cluster", [2, 8])
@pytest.mark.parametrize("world", ["wan48", "hub40"])
def test_sweep_word_kernel_reading_its_records_in_place_equals_plain(card, world, cluster, state,
                                                                     monkeypatch):
    """Shared memory cut so that a block holds its state and at most a
    share E / cluster of records (copies) or none (owned): a block with
    more (the hub's root's block, all 40 of the root's in-edges its own)
    reads its records from the layout in place and recomputes their
    membership words every lane round."""
    topo = encode(world)
    V, E, D = topo.padded_nodes, len(topo.src), lanes_for(topo, world)
    head, owned, every = _state_ints(topo, D, cluster)
    held = every if state == "copies" else owned
    share = 4 * -(-E // cluster) if state == "copies" else 0
    monkeypatch.setattr(spf, "SWEEP_CLUSTER", cluster)
    monkeypatch.setattr(spf, "SWEEP_SHARED_BYTES", 4 * (head + held + share))
    _S, mode, cap_rec, _l, _s = spf.sweep_layout(V, E, 32, D, cluster)
    assert (mode, cap_rec) == (2 if state == "copies" else 1, share // 4)
    _kernel_equals_plain(card, world, cluster + 7)


@pytest.mark.cuda
def test_sweep_word_kernel_at_the_base_solve_shape_equals_plain(card):
    """One word of 32 unperturbed snapshots on the headline WAN, the
    engine's cold base solve, at the launcher's own rule."""
    from openr_tpu_torch.ops.whatif import root_lane_count

    ls = LinkState("0", "node0")
    for db in ttopo.build_adj_dbs(ttopo.random_connected_edges(1024, 2048, seed=7)).values():
        ls.update_adjacency_database(db)
    topo = csr.encode_link_state(ls)
    D = root_lane_count(topo, 0)
    src, dst, w, ok, li, failed, ovl = (
        t.to(card) for t in port_tensors(topo, np.full(WORD, -1, np.int32)))
    assert spf.sweep_cluster_size(ovl.shape[0]) == 8
    got_d, got_n, _, _ = spf.sweep_spf_link_failures(src, dst, w, ok, li, failed, ovl, 0, D)
    want_d, want_n, _, _ = spf.sweep_spf_link_failures_plain(src, dst, w, ok, li, failed, ovl, 0, D)
    assert torch.equal(got_d, want_d) and torch.equal(got_n, want_n)
