"""The layouts and algorithms of kernels 14 (``spf_segment_batch``) and 2
(``dense_spf_nexthop_lanes``) as redesigned for the card, on the CPU.

* A model of the out-edge CSR that kernel 14 builds on the card
  (``segment_layout_kernel`` in ``kernels/csrc/spf_warm.cu``, by the same
  steps) against the segment edge lists, edge by edge: every edge under
  its source in edge order (an unusable one as a self-loop of +inf), with
  its dst, weight, link id and lane rank (its rank among ALL of its
  source's edges in the area's dst-sorted edge order, the reference's
  numbering).
* A sequential model of kernel 14: the fill (dist BIG; lanes 0 on a -1
  root's pairs, else -128 where the vertex's run in the padded edge list
  is empty and 0 elsewhere), then per pair the frontier relaxation of
  ``kernels/csrc/frontier.cuh`` over the list with the row's failed set
  filtered per slot by link id, the root's DAG out-edges' seeds by rank,
  the packed propagating sources and OR rounds over the live lanes.  Its
  tables go through the port's selection and equal the jitted
  ``fleet_multi_area_tables`` / ``whatif_multi_area_tables`` on the worlds
  of ``tests/test_torch_fleet_tables.py`` and a hub of 300 leaves.
* A bit-word model of kernel 2: each in-slot classified once, seeds set
  as bits, the propagating sources packed, OR rounds over ceil(D / 32)
  uint32 words of the moving vertices, the int8 table written once (-128
  where ``in_has`` is false, else the bit).  It equals the jitted
  ``dense_spf_nexthop_lanes`` on the worlds of ``tests/test_torch_spf.py``
  and a fan of 40 equal-cost first hops, at D = 4, 33 and 64 (so that
  lanes span several words).  The model asserts what makes OR exact: a
  propagating source is present (``in_has``), so its lanes are 0 or 1.

The models are one order of the work the card runs in parallel; the
kernels themselves are held against their plain versions by the ``cuda``
tests of ``tests/test_torch_kernels_cuda.py``.  Tolerance: exact equality
(integer metrics keep every f32 sum exact).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.backend import DEGREE_BUCKETS
from openr_tpu.decision.cand_table import CandidateTable as RefTable
from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.prefix_state import PrefixState
from openr_tpu.emulation.topology import build_adj_dbs
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops import fleet_tables as jft
from openr_tpu.ops.spf import dense_spf_distances as jax_dense_distances
from openr_tpu.ops.spf import dense_spf_nexthop_lanes as jax_dense_lanes
from openr_tpu.types import PrefixEntry
from openr_tpu_torch.interop import lsdb_from_wire
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import fleet_tables as tft
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.consts import BIG
from tests.test_torch_fleet_tables import CAND, SEGMENT, WORLDS, Pair, _fail_sets, assert_same
from tests.test_torch_frontier import frontier_model
from tests.test_torch_spf import WORLDS as SPF_WORLDS
from tests.test_torch_spf import _link_states, lsdb_to_wire

INT8_MIN = -128


def hub_world(leaves=300):
    """A hub with ``leaves`` leaves, a prefix on every tenth."""
    ls = LinkState("0")
    for db in build_adj_dbs([("hub", f"leaf{i}", 1) for i in range(leaves)]).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for i in range(0, leaves, 10):
        ps.update_prefix(f"leaf{i}", "0", PrefixEntry(f"10.3.{i // 10}.0/24"))
    return {"0": ls}, ps, "hub"


WORLDS14 = {**WORLDS, "hub": hub_world}


@functools.lru_cache(maxsize=None)
def pair_of(world):
    """``Pair`` of ``tests/test_torch_fleet_tables.py`` for any world of
    WORLDS14; on the hub, three root rows (the hub and two leaves)."""
    if world in WORLDS:
        return Pair(world)
    areas, ps, me = WORLDS14[world]()
    pair = object.__new__(Pair)
    pair.me = me
    pair.ref = jcsr.encode_multi_area(areas, me)
    adj_wire, _ = lsdb_to_wire(areas, PrefixState())
    port_areas, _ = lsdb_from_wire(adj_wire, {}, my_node_name=me)
    pair.port = tcsr.encode_multi_area(port_areas, me)
    table = RefTable()
    table.full_sync(ps)
    pair.dv = table.derived(pair.ref)
    pair.D = jcsr.bucket_for(max(pair.ref.max_out_degree(), 1), DEGREE_BUCKETS)
    ids = pair.ref.topos[0].node_ids
    pair.roots = np.asarray([[ids["hub"]], [ids["leaf0"]], [ids["leaf7"]]], np.int32)
    return pair


def source_ranks(src, num_nodes: int) -> np.ndarray:
    """[A, E]: each edge's rank among the edges of its area with the same
    source, in edge order (padding and disabled edges included): its
    position in the area's edges stably sorted by source, less its
    source's first position there, as the kernel ranks a slot."""
    src = np.asarray(src)
    ranks = np.empty(src.shape, np.int64)
    for a in range(src.shape[0]):
        order = np.argsort(src[a], kind="stable")
        key = src[a][order]
        ranks[a, order] = np.arange(len(key)) - np.searchsorted(key, key, side="left")
    return ranks


def segment_out_edge_csr(src, dst, w, edge_ok, num_nodes: int, link_index=None):
    """Kernel 14's derived layout, by the kernel's steps: per area a, its
    edges stably sorted by source; slot a E + i holds sorted position i's
    (dst, bits of w) where the edge is usable, else a self-loop of +inf,
    and its link id; ``off[a, u]`` = a E + the first sorted position of
    source u, and ``off[a, V]`` the end of source V - 1's run less its
    trailing unusable edges.  A slot's lane rank is its place in its
    source's run.  Returns ``(off [A, V + 1], edge [A E, 2], rank [A E]
    (-1 outside every run), link [A E] or None)``."""
    src, dst, w, ok = (np.asarray(x) for x in (src, dst, w, edge_ok))
    A, E = src.shape
    V = num_nodes
    off = np.zeros((A, V + 1), np.int32)
    edge = np.zeros((A * E, 2), np.int32)
    rank = np.full(A * E, -1, np.int32)
    link = None if link_index is None else np.zeros(A * E, np.int32)
    ranks = source_ranks(src, V)
    for a in range(A):
        order = np.argsort(src[a], kind="stable")
        key = src[a][order]
        good = ok[a][order]
        at = a * E + np.arange(E)
        edge[at, 0] = np.where(good, dst[a][order], key)
        edge[at, 1] = np.where(good, w[a][order], np.float32(np.inf)).astype(np.float32).view(np.int32)
        if link is not None:
            link[at] = np.asarray(link_index)[a][order]
        starts = np.searchsorted(key, np.arange(V + 1), side="left")
        lo, hi = starts[V - 1], starts[V]
        kept = np.nonzero(good[lo:hi])[0]
        starts[V] = lo + (kept[-1] + 1 if len(kept) else 0)
        off[a] = a * E + starts
        in_run = (key >= 0) & (key < V)
        rank[at[in_run]] = ranks[a][order][in_run]
    return off, edge, rank, link


def segment_arrays(enc):
    return [torch.from_numpy(np.ascontiguousarray(getattr(enc, k))) for k in SEGMENT]


# -- the segment out-edge list ------------------------------------------------


@pytest.mark.parametrize("world", sorted(WORLDS14))
def test_segment_out_edge_csr_lists_every_usable_edge_once(world):
    enc = pair_of(world).port
    A, E = enc.src.shape
    V = enc.overloaded.shape[1]
    link_index = np.stack([t.link_index for t in enc.topos])
    src, dst, w, ok, _ovl = segment_arrays(enc)
    off, edge, rank, link = segment_out_edge_csr(src, dst, w, ok, V, link_index)
    assert off.shape == (A, V + 1) and len(edge) == len(rank) == len(link) == A * E
    wf = edge[:, 1].view(np.float32)
    for a in range(A):
        # area a owns the slots [a E, (a + 1) E); source u's run holds ALL
        # of u's edges in edge order (V - 1's less its trailing unusable
        # ones), an unusable one as a self-loop of +inf
        assert off[a, 0] == a * E
        s = enc.src[a]
        for u in range(V):
            sl = slice(off[a, u], off[a, u + 1])
            mine = np.nonzero(s == u)[0]  # edge order
            want = mine[:off[a, u + 1] - off[a, u]]
            assert u == V - 1 or len(want) == len(mine)
            assert not enc.edge_ok[a, mine[len(want):]].any()
            good = enc.edge_ok[a, want]
            assert np.array_equal(edge[sl, 0], np.where(good, enc.dst[a, want], u))
            assert np.array_equal(wf[sl][good], enc.w[a, want][good])
            assert np.isinf(wf[sl][~good]).all()
            assert np.array_equal(link[sl], link_index[a, want])
            # the rank among ALL of u's edges, disabled and padding ones too
            assert np.array_equal(rank[sl], np.cumsum(s == u)[want] - 1)
        # every usable edge once, each with a finite weight
        runs = slice(off[a, 0], off[a, V])
        assert int(np.isfinite(wf[runs]).sum()) == int(enc.edge_ok[a].sum())
    # without link ids the list carries none
    assert segment_out_edge_csr(src, dst, w, ok, V)[3] is None


@pytest.mark.parametrize("world", ["grid", "two_area_fleet", "hub"])
def test_source_ranks_are_each_roots_lane_numbering(world):
    """Ranked for every source at once, an edge's rank is its lane for
    every root: the port's ``root_lane_rank`` on the root's out-edges."""
    enc = pair_of(world).port
    V = enc.overloaded.shape[1]
    src = torch.from_numpy(enc.src)
    ranks = torch.from_numpy(source_ranks(src, V))
    for root in range(0, V, max(1, V // 40)):
        roots = torch.full((enc.src.shape[0],), root, dtype=torch.int32)
        want = tspf.root_lane_rank(src, roots)
        mine = src == root
        assert torch.equal(ranks[mine].int(), want[mine])


# -- kernel 14 ---------------------------------------------------------------


def segment_lanes_model(off, edge, rank, kept, lanes, ovl, root, d, D):
    """Kernel 14's lanes of one pair in place on its prefilled table: the
    root's DAG out-edges set their lanes, every other DAG edge is packed
    as a propagating source of its dst, OR rounds over the live lanes."""
    dst, w = edge[:, 0], edge[:, 1].view(np.float32)
    used = 0
    for slot in range(off[root], off[root + 1]):
        v = dst[slot]
        if kept(slot) and np.float32(d[root] + w[slot]) == d[v] and d[v] < BIG:
            if rank[slot] < D:
                lanes[v, rank[slot]] = 1
            used = max(used, rank[slot] + 1)
    sources = {}
    for u in range(len(ovl)):
        if u == root or d[u] >= BIG or ovl[u]:
            continue
        for slot in range(off[u], off[u + 1]):
            if np.float32(d[u] + w[slot]) == d[dst[slot]] and kept(slot):
                sources.setdefault(int(dst[slot]), []).append(u)
    L = min(used, D)
    for srcs in sources.values():
        assert (lanes[srcs, :L] >= 0).all()  # the fill left 0 there, not -128
    changed = True
    while changed:
        changed = False
        for v, srcs in sources.items():
            x = lanes[v, :L] | lanes[srcs, :L].max(axis=0)
            if not np.array_equal(x, lanes[v, :L]):
                lanes[v, :L] = x
                changed = True


def segment_batch_model(src, dst, w, edge_ok, overloaded, roots, max_degree,
                        link_index=None, fail_area=None, fail_link=None):
    """Kernel 14's new path in numpy, called as ``spf_segment_batch``."""
    B, A = roots.shape
    V = overloaded.shape[1]
    D = max_degree
    sets = fail_area is not None
    off, edge, rank, link = segment_out_edge_csr(src, dst, w, edge_ok, V, link_index if sets else None)
    seg_off = tspf.segment_offsets(dst, V).numpy()
    has = seg_off[:, 1:] > seg_off[:, :-1]
    r = roots.numpy()
    ovl = overloaded.numpy()
    # the fill
    dist = np.full((B, A, V), BIG, np.float32)
    nh = np.where(r[:, :, None, None] < 0, 0, np.where(has[None, :, :, None], 0, INT8_MIN))
    nh = np.ascontiguousarray(np.broadcast_to(nh, (B, A, V, D)).astype(np.int8))
    for b in range(B):
        for a in range(A):
            root = r[b, a]
            if root < 0:
                continue
            failed = set()
            if sets:
                failed = {int(fl) for fa, fl in zip(fail_area[b].tolist(), fail_link[b].tolist())
                          if fa == a and fl >= 0}
            kept = (lambda slot: int(link[slot]) not in failed) if failed else (lambda slot: True)
            d, _ = frontier_model(off[a], edge, ovl[a], root, kept, 5)
            reached = d < BIG
            dist[b, a, reached] = d[reached]
            segment_lanes_model(off[a], edge, rank, kept, nh[b, a], ovl[a], root, d, D)
    return torch.from_numpy(dist), torch.from_numpy(nh)


@pytest.mark.parametrize("world", sorted(WORLDS14))
def test_segment_batch_model_equals_jax_fleet_tables(world, monkeypatch):
    pair = pair_of(world)
    seg = dict(zip(SEGMENT, segment_arrays(pair.port)))
    roots = torch.from_numpy(pair.roots)
    model = segment_batch_model(*seg.values(), roots, pair.D)
    plain = tspf.spf_segment_batch_plain(*seg.values(), roots, pair.D)
    assert torch.equal(model[0], plain[0]) and torch.equal(model[1], plain[1])
    kw = dict(max_degree=pair.D, per_area_distance=False)
    want = jft.fleet_multi_area_tables(
        **pair.jax(pair.ref, SEGMENT), soft=jnp.asarray(pair.ref.soft),
        roots=jnp.asarray(pair.roots), **pair.jax_cand(), **kw,
    )
    monkeypatch.setattr(tft, "spf_segment_batch", segment_batch_model)
    got = tft.fleet_multi_area_tables(
        **seg, soft=torch.from_numpy(pair.port.soft), roots=roots, **pair.port_cand(), **kw
    )
    assert_same(got, want)
    if world == "hub":
        assert pair.D > 256 and int((model[1][0, 0] == 1).sum()) == 300  # every leaf its lane
    if world in ("two_area_fleet", "isolated"):
        assert bool((roots < 0).any()) and bool((model[1] == INT8_MIN).any())


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("world", ["whatif", "isolated", "grid"])
def test_segment_batch_model_equals_jax_whatif_tables(world, S, monkeypatch):
    pair = pair_of(world)
    fa, fl = _fail_sets(pair, S)
    link_index = np.stack([t.link_index for t in pair.ref.topos])
    kw = dict(max_degree=pair.D, per_area_distance=False)
    want = jft.whatif_multi_area_tables(
        **pair.jax(pair.ref, SEGMENT[:4]), link_index=jnp.asarray(link_index),
        overloaded=jnp.asarray(pair.ref.overloaded), soft=jnp.asarray(pair.ref.soft),
        roots=jnp.asarray(pair.ref.roots), fail_area=jnp.asarray(fa),
        fail_link=jnp.asarray(fl), **pair.jax_cand(), **kw,
    )
    seg = dict(zip(SEGMENT, segment_arrays(pair.port)))
    calls = []

    def model(*args, **kwargs):
        calls.append(args[5].shape[0])
        return segment_batch_model(*args, **kwargs)

    monkeypatch.setattr(tft, "spf_segment_batch", model)
    got = tft.whatif_multi_area_tables(
        *(seg[k] for k in SEGMENT[:4]), torch.from_numpy(link_index), seg["overloaded"],
        torch.from_numpy(pair.port.soft), torch.from_numpy(pair.port.roots),
        torch.from_numpy(fa), torch.from_numpy(fl),
        *(torch.from_numpy(getattr(pair.dv, k)) for k in CAND), **kw,
    )
    assert calls == [len(fa)]
    assert_same(got, want)


# -- kernel 2 ----------------------------------------------------------------


def dense_lane_words_model(in_src, in_w, in_ok, in_rank, in_has, overloaded, root, dist, D):
    """Kernel 2's lanes of one area: [V, D] int8."""
    V, K = in_src.shape
    W = (D + 31) // 32
    words = np.zeros((V, W), np.uint32)
    transit = ~overloaded
    transit[root] = True
    used = 0
    sources = {}
    for v in range(V):
        dv = dist[v]
        if dv >= BIG:
            continue
        for k in range(K):
            s = in_src[v, k]
            if not (in_ok[v, k] and transit[s] and np.float32(dist[s] + in_w[v, k]) == dv):
                continue
            if s != root:
                sources.setdefault(v, []).append(int(s))
                continue
            r = in_rank[v, k]
            if 0 <= r < D:
                words[v, r >> 5] |= np.uint32(1 << (r & 31))
                used = max(used, r + 1)
    # what makes OR exact: every propagating source is present
    assert all(in_has[s] for srcs in sources.values() for s in srcs)
    Wl = (min(used, D) + 31) // 32
    changed = True
    while changed:
        changed = False
        for v, srcs in sources.items():
            x = words[v, :Wl] | np.bitwise_or.reduce(words[srcs, :Wl], axis=0)
            if not np.array_equal(x, words[v, :Wl]):
                words[v, :Wl] = x
                changed = True
    bits = (words[:, np.arange(D) >> 5] >> (np.arange(D) & 31).astype(np.uint32)) & 1
    return np.where(in_has[:, None], bits, INT8_MIN).astype(np.int8), Wl


def fan_world():
    """me with 40 equal-cost first hops to two sinks and a tail beyond."""
    edges = [("me", f"m{i}", 1) for i in range(40)]
    edges += [(f"m{i}", sink, 1) for i in range(40) for sink in ("s0", "s1")]
    edges += [("s0", "t0", 2), ("s1", "t0", 2), ("t0", "t1", 1)]
    return {"0": list(build_adj_dbs(edges).values())}, "me"


LANE_WORLDS = {**SPF_WORLDS, "fan": fan_world}


@functools.lru_cache(maxsize=None)
def _dense_jits(D):
    lanes = jax.jit(jax_dense_lanes, static_argnames=("max_degree",))
    return jax.jit(jax_dense_distances), functools.partial(lanes, max_degree=D)


@pytest.mark.parametrize("D", [4, 33, 64])
@pytest.mark.parametrize("world", sorted(LANE_WORLDS))
def test_dense_lane_words_model_equals_jax(world, D):
    area_dbs, me = LANE_WORLDS[world]()
    ref = jcsr.encode_multi_area(_link_states(area_dbs), me)
    distances, lanes = _dense_jits(D)
    words_used = 0
    for a in range(ref.num_areas):
        planes = [getattr(ref, f)[a] for f in ("in_src", "in_w", "in_ok", "in_rank", "in_has",
                                               "overloaded")]
        root = int(ref.roots[a])
        dist = np.asarray(distances(*(jnp.asarray(p) for p in (*planes[:3], planes[5])),
                                    jnp.int32(root)))
        want = np.asarray(lanes(*(jnp.asarray(p) for p in planes), jnp.int32(root),
                                jnp.asarray(dist)))
        got, Wl = dense_lane_words_model(*planes, root, dist, D)
        assert np.array_equal(got, want), a
        words_used = max(words_used, Wl)
    if world == "fan":
        assert words_used == (D + 31) // 32  # lanes 32-39 in a second word
