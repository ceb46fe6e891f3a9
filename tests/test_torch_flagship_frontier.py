"""Kernel 16 (``batched_spf``) as redesigned for the card, on the CPU: the
layout its launcher builds on the card and the frontier solve of each row,
as models held against the jitted JAX functions.

* A numpy model of the layout (``segment_layout_kernel`` in
  ``kernels/csrc/spf_warm.cu``, by the same steps as kernel 14's): per
  list (one shared list, or each row's own), a CSR by source of ALL the
  edges in edge order, an unusable edge a self-loop of +inf, each slot
  with its edge's position in the list (the row's mask bit).  A slot's
  place in its source's run is the lane ``root_lane_rank`` gives it, for
  every root.
* A torch model of each row's solve: the fill (dist BIG, lanes -128
  where the vertex's run in the padded edge list is empty, else 0), then
  frontier rounds from the row's root over the list, a slot kept where
  the row's bit of its edge is set, a vertex of the row's own hard-drain
  row relaxing nothing unless it is the root; the root's DAG out-slots
  seed their lanes by run place, every other DAG slot is a propagating
  source, and OR rounds run over the live lanes (bit words where they fit
  32, the int8 table past that).  It equals the jitted
  ``openr_tpu.ops.spf.batched_spf``, ``batched_spf_link_failures`` and
  ``batched_spf_distinct`` on the worlds of ``tests/test_torch_batched.py``
  (drained rows, ECMP ties, a root whose first out-edge is disabled) and
  on a fan of 40 equal-cost first hops (live lanes past one word).

The kernel itself is held against its plain version by the ``cuda`` tests
of ``tests/test_torch_kernels_cuda.py``.  Tolerance: exact equality
(integer metrics keep every f32 sum exact; the fixed points are unique).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.emulation.topology import random_connected_edges
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops.spf import batched_spf as jax_batched_spf
from openr_tpu.ops.spf import batched_spf_distinct as jax_distinct
from openr_tpu.ops.spf import batched_spf_link_failures as jax_link_failures
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.consts import BIG
from tests.test_torch_batched import WORLDS, edges_of, make_ls, max_degree, row_inputs, world
from tests.test_torch_lanes import segment_out_edge_csr

INT8_MIN = -128
FAN = "fan"


def fan_world():
    """node0 with 40 equal-cost first hops to two sinks and a tail beyond,
    and a drained hop (the root's lanes span two 32-bit words)."""
    edges = [("node0", f"m{i}", 1) for i in range(40)]
    edges += [(f"m{i}", sink, 1) for i in range(40) for sink in ("s0", "s1")]
    edges += [("s0", "t0", 2), ("s1", "t0", 2), ("t0", "t1", 1)]
    ls = make_ls(edges, ["m3"])
    return ls, jcsr.encode_link_state(ls)


def named_world(name):
    return fan_world() if name == FAN else world(name)


def batched_layout(src, dst, w, edge_ok, num_nodes: int):
    """Kernel 16's layout of one list ``[E]`` or of per-row lists
    ``[B, E]``: ``(off [A, V + 1], edge [A E, 2], rank [A E], edge_id
    [A E])``, as :func:`segment_out_edge_csr` with each slot's id its
    edge's position in its list."""
    arrays = [np.atleast_2d(np.asarray(a)) for a in (src, dst, w, edge_ok)]
    A, E = arrays[0].shape
    ids = np.tile(np.arange(E, dtype=np.int32), (A, 1))
    return segment_out_edge_csr(*arrays, num_nodes, ids)


def frontier_row(off, dst, w, keep, ovl, root, V):
    """One row's distances by frontier rounds (torch): each round relaxes
    the kept out-slots of the vertices lowered in the round before, an
    overloaded vertex other than the root relaxing nothing."""
    d = torch.full((V,), BIG, dtype=torch.float32)
    d[root] = 0.0
    frontier = torch.tensor([root])
    while len(frontier):
        frontier = frontier[~ovl[frontier] | (frontier == root)]
        counts = off[frontier + 1] - off[frontier]
        total = int(counts.sum())
        owner = torch.repeat_interleave(frontier, counts)
        at = torch.arange(total) - torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
        slots = torch.repeat_interleave(off[frontier], counts) + at
        kept = keep[slots]
        slots, owner = slots[kept], owner[kept]
        best = torch.full((V,), float("inf")).scatter_reduce(
            0, dst[slots].long(), d[owner] + w[slots], "amin")
        lowered = best < d
        d = torch.where(lowered, best, d)
        frontier = torch.nonzero(lowered).flatten()
    return d


def row_lanes(off, dst, w, keep, ovl, root, d, lanes, D):
    """One row's lanes in place on its filled table [V, D] (torch): the
    root's DAG out-slots set the lane of their run place, every other DAG
    slot is a propagating source of its dst, then OR rounds over the live
    lanes: as one bit word a vertex where they fit 32, else on the int8
    table.  Returns the live lane count."""
    V = d.shape[0]
    src = torch.repeat_interleave(torch.arange(V), off[1:] - off[:-1])
    slots = torch.arange(int(off[0]), int(off[V]))
    to = dst[slots].long()
    on = keep[slots] & (d[src] < BIG) & (d[src] + w[slots] == d[to])
    seeds = on & (src == root)
    rank = slots - off[root]
    used = int(rank[seeds].max()) + 1 if bool(seeds.any()) else 0
    hit = seeds & (rank < D)
    lanes[to[hit], rank[hit]] = 1
    prop = on & (src != root) & ~ovl[src]
    ps, pd = src[prop], to[prop]
    L = min(used, D)
    # OR is exact: a propagating source is reached, so its lanes are 0 / 1
    assert bool((lanes[ps, :L] >= 0).all())
    if 0 < L <= 32:
        bits = torch.arange(L, dtype=torch.int64)
        word = ((lanes[:, :L] == 1).to(torch.int64) << bits).sum(1).tolist()
        pairs = list(zip(ps.tolist(), pd.tolist()))
        changed = True
        while changed:
            changed = False
            for s, t in pairs:
                if word[t] | word[s] != word[t]:
                    word[t] |= word[s]
                    changed = True
        lanes[:, :L][((torch.tensor(word)[:, None] >> bits) & 1).bool()] = 1
    elif L > 32:
        while True:
            acc = lanes[:, :L].clone().scatter_reduce_(
                0, pd[:, None].expand(-1, L), lanes[ps, :L], "amax")
            if torch.equal(acc, lanes[:, :L]):
                break
            lanes[:, :L] = acc
    return L


def batched_model(src, dst, w, edge_ok, overloaded, roots, D, keep_rows=None):
    """Kernel 16's path, called as ``batched_spf`` (``keep_rows`` [B, E]:
    the rows' edge bits, None: every edge) or ``batched_spf_distinct``
    (the edge arrays [B, E]).  Returns (dist [B, V], nh [B, V, D], the
    live lane count of each row)."""
    B, V = overloaded.shape
    distinct = np.ndim(src) == 2
    off, edge, _rank, eid = batched_layout(src, dst, w, edge_ok, V)
    off = torch.from_numpy(off).long()
    to = torch.from_numpy(edge[:, 0])
    wf = torch.from_numpy(edge[:, 1].view(np.float32))
    seg = tspf.segment_offsets(torch.from_numpy(np.atleast_2d(dst)), V)
    has = seg[:, 1:] > seg[:, :-1]
    ovl = torch.from_numpy(overloaded)
    # the fill
    dist = torch.full((B, V), BIG, dtype=torch.float32)
    rows = torch.arange(B) % has.shape[0]
    nh = torch.where(has[rows][:, :, None], 0, INT8_MIN).to(torch.int8).expand(B, V, D).clone()
    live = []
    for b, root in enumerate(roots.tolist()):
        if not 0 <= root < V:
            live.append(0)
            continue
        a = b if distinct else 0
        keep = torch.ones(len(eid), dtype=torch.bool)
        if keep_rows is not None:
            keep = torch.from_numpy(keep_rows[b])[torch.from_numpy(eid).long()]
        d = frontier_row(off[a], to, wf, keep, ovl[b], root, V)
        reached = d < BIG
        dist[b, reached] = d[reached]
        live.append(row_lanes(off[a], to, wf, keep, ovl[b], root, d, nh[b], D))
    return dist, nh, live


def assert_same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


ALL = WORLDS + [FAN]


@pytest.mark.parametrize("name", ALL)
def test_layout_model_lists_every_edge_under_its_source_with_its_position(name):
    _ls, topo = named_world(name)
    V, E = topo.padded_nodes, topo.padded_edges
    off, edge, rank, eid = batched_layout(*edges_of(topo), V)
    assert off.shape == (1, V + 1) and len(edge) == len(eid) == E
    wf = edge[:, 1].view(np.float32)
    for u in range(V):
        sl = slice(off[0, u], off[0, u + 1])
        mine = np.nonzero(topo.src == u)[0]  # edge order
        want = mine[:off[0, u + 1] - off[0, u]]
        assert u == V - 1 or len(want) == len(mine)
        assert not topo.edge_ok[mine[len(want):]].any()
        # each slot's id is its edge's position: the row's mask bit
        assert np.array_equal(eid[sl], want)
        good = topo.edge_ok[want]
        assert np.array_equal(edge[sl, 0], np.where(good, topo.dst[want], u))
        assert np.array_equal(wf[sl][good], topo.w[want][good])
        assert np.isinf(wf[sl][~good]).all()
    # a slot's run place is the lane root_lane_rank gives it, every root
    src = torch.from_numpy(topo.src)[None]
    for root in range(topo.num_nodes):
        lanes = tspf.root_lane_rank(src, torch.tensor([root], dtype=torch.int32))[0].numpy()
        run = slice(off[0, root], off[0, root + 1])
        assert np.array_equal(rank[run], lanes[eid[run]])
        assert np.array_equal(eid[run], np.nonzero(lanes >= 0)[0][:len(eid[run])])


@pytest.mark.parametrize("name", ALL)
def test_frontier_model_equals_jax_batched_spf(name):
    """Per-row masks, hard drains and roots; row 0 roots at the busiest
    node with its first out-edge disabled (its lane stays numbered)."""
    _ls, topo = named_world(name)
    rng = np.random.default_rng(len(name))
    roots, ovl, enabled = row_inputs(topo, rng)
    if name == FAN:
        roots[0] = roots[1] = topo.node_id("node0")
    D = max_degree(topo)
    arrays = edges_of(topo) + [enabled, ovl, roots]
    want = jax_batched_spf(*(jnp.asarray(a) for a in arrays), D)
    dist, nh, live = batched_model(*edges_of(topo), ovl, roots, D, keep_rows=enabled)
    assert_same((dist, nh), want)
    assert tspf.batched_spf(*(torch.from_numpy(a) for a in arrays), D)[1].shape == nh.shape
    if name == FAN:
        assert max(live) == 40 > 32  # the lanes past one word take the table
    if name in ("ecmp_diamond", "grid", FAN):  # ECMP ties: vertices on two lanes or more
        assert int(((nh == 1).sum(-1) >= 2).sum()) > 0


@pytest.mark.parametrize("name", ALL)
def test_frontier_model_equals_jax_link_failures(name):
    """The set form: row b's bits clear its failed link's edges (-1: none)."""
    _ls, topo = named_world(name)
    rng = np.random.default_rng(7 + len(name))
    roots, ovl, _enabled = row_inputs(topo, rng)
    L = len(topo.links)
    failed = rng.integers(-1, L, len(roots)).astype(np.int32)
    failed[:2] = -1
    D = max_degree(topo)
    arrays = edges_of(topo) + [topo.link_index, failed, ovl, roots]
    want = jax_link_failures(*(jnp.asarray(a) for a in arrays), max_degree=D)
    keep = ~((failed[:, None] >= 0) & (topo.link_index[None] == failed[:, None]))
    dist, nh, _live = batched_model(*edges_of(topo), ovl, roots, D, keep_rows=keep)
    assert_same((dist, nh), want)


def test_frontier_model_equals_jax_distinct():
    """Each row over its own list (one layout per row), padded to a common
    node and edge bucket, with its own drains."""
    rng = np.random.default_rng(3)
    rows = []
    for b, n in enumerate((8, 24, 12, 16, 20, 5, 30)):
        edges = random_connected_edges(n, n + 3 * b, seed=20 + b)
        drained = [f"node{i}" for i in rng.choice(n, 2, replace=False)]
        rows.append(jcsr.encode_link_state(make_ls(edges, drained), node_bucket=32,
                                           edge_bucket=256))
    stack = [np.stack(a) for a in zip(*(edges_of(t) for t in rows))]
    ovl = np.stack([t.overloaded for t in rows])
    roots = np.array([rng.integers(0, t.num_nodes) for t in rows], np.int32)
    D = max(max_degree(t) for t in rows)
    want = jax_distinct(*(jnp.asarray(a) for a in stack + [ovl, roots]), max_degree=D)
    dist, nh, _live = batched_model(*stack, ovl, roots, D)
    assert_same((dist, nh), want)
    # the per-row layouts: row b's slots carry row b's own edges
    off, edge, _rank, eid = batched_layout(*stack, 32)
    E = stack[0].shape[1]
    for b in range(len(rows)):
        run = slice(off[b, 0], off[b, 32])
        assert ((off[b] >= b * E) & (off[b] <= (b + 1) * E)).all()
        good = stack[3][b][eid[run]]
        assert np.array_equal(edge[run, 0][good], stack[1][b][eid[run]][good])


def test_state_placement_at_the_flagship_shape():
    """At V = 1,024 and E = 8,192 a row's frontier state and edge bits sit
    in shared memory; its lane lists join them only where the SM still
    holds as many blocks as its threads allow (1,024 threads: two), else
    they go to the global scratch (256 and 512 threads: 8 and 4 blocks an
    SM); with no shared memory the whole state goes there."""
    V, E = 1024, 8192
    lists = (4 * (3 * V + 1 + E) + 15) // 16 * 16  # whole 16-byte words
    for T, want in ((256, 1), (512, 1), (1024, 0)):
        layout, cap, smem, slice_bytes = tspf.batched_spf_state(V, E, T)
        assert (layout, cap) == (want, V)
        assert slice_bytes == (lists if want else 0)
        blocks = tspf.SM_SHARED_BYTES // (smem + tspf.BLOCK_RESERVED_BYTES)
        assert blocks >= tspf.SM_THREADS // T
    saved = tspf.MAX_SHARED_BYTES
    try:
        tspf.MAX_SHARED_BYTES = 0
        assert tspf.batched_spf_state(V, E, 256)[:3] == (2, V, 0)
    finally:
        tspf.MAX_SHARED_BYTES = saved
