"""The compact out-edge lists of kernels 12 and 15 (``ops/frontier.py``)
and the frontier relaxation they feed (``kernels/csrc/frontier.cuh``), on
the CPU.

* ``out_edge_csr`` against the dst-sorted edge list and
  ``dense_out_edge_csr`` against the dense in-edge planes, edge by edge:
  every usable edge appears exactly once under its source, with its dst,
  weight and edge id (or in_rank); no disabled or padding edge appears.
  Worlds: those of ``tests/test_torch_ksp2.py`` (kernel 15) and
  ``tests/test_torch_fleet_tables.py`` (kernel 12), and the fat-tree
  generator.
* A sequential model of the kernels' algorithm over those lists (the
  frontier listed a few vertices at a time, the transit rule per frontier
  vertex, the row mask per slot; then kernel 12's seeds, packed
  propagating sources and OR lane rounds) against the JAX package's
  ``batched_spf_distances_masked`` and ``multi_area_spf_tables_dense``.
  The model is one order of the relaxations the card runs in parallel;
  the kernels themselves are held against their plain versions by the
  ``cuda`` tests of ``tests/test_torch_kernels_cuda.py``.
* The ctypes argument lists of the two kernels' C entry points against
  their signatures in the sources, and of every kernel's C entry point
  (one case per symbol) against the constant its launcher binds.

Tolerance: exact equality (integer metrics keep every f32 sum exact).
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.backend import DEGREE_BUCKETS
from openr_tpu.decision.link_state import LinkState
from openr_tpu.emulation.topology import _build_fattree, build_adj_dbs
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops.route_select import multi_area_spf_tables_dense as jax_dense_tables
from openr_tpu.ops.spf import batched_spf_distances_masked as jax_masked
from openr_tpu_torch.ops import repair as trepair
from openr_tpu_torch.ops import route_select as trs
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops import sweep_select as tsweep
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.frontier import dense_out_edge_csr, live_nodes, out_edge_csr
from tests.test_torch_fleet_tables import WORLDS as FLEET_WORLDS
from tests.test_torch_ksp2 import masked_inputs, masked_world

CSRC = Path(tspf.__file__).resolve().parents[1] / "kernels" / "csrc"


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def fattree_dense():
    """The fattree_multipod class at scale 64 (80 nodes), vantage rsw0_0."""
    ls = LinkState("0", "rsw0_0")
    for db in build_adj_dbs(_build_fattree(64, 0)).values():
        ls.update_adjacency_database(db)
    return jcsr.encode_multi_area({"0": ls}, "rsw0_0")


def fleet_world(name):
    """(multi-area encoding, root rows [B, A] with -1 where absent)."""
    if name == "fattree":
        enc = fattree_dense()
    else:
        areas, _ps, me = FLEET_WORLDS[name]()
        enc = jcsr.encode_multi_area(areas, me)
    names = sorted(set().union(*[set(t.node_ids) for t in enc.topos]))
    roots = np.asarray([[t.node_ids.get(n, -1) for t in enc.topos] for n in names], np.int32)
    return enc, roots


def dense_planes(enc):
    return [enc.in_src, enc.in_w, enc.in_ok, enc.in_rank]


# -- the lists, edge by edge -------------------------------------------------


@pytest.mark.parametrize("world", ["random", "grid", "wan"])
def test_out_edge_csr_lists_every_usable_edge_once(world):
    topo, _drained = masked_world(world)
    V = topo.overloaded.shape[0]
    off, edge, eid = (x.numpy() for x in out_edge_csr(*_t(topo.src, topo.dst, topo.w, topo.edge_ok), V))
    assert off.dtype == edge.dtype == eid.dtype == np.int32 and edge.shape == (len(eid), 2)
    assert off[0] == 0 and off[-1] == len(eid) == int(topo.edge_ok.sum())
    assert (np.diff(off) >= 0).all()
    assert len(np.unique(eid)) == len(eid) and topo.edge_ok[eid].all()
    w = edge[:, 1].view(np.float32)
    for u in range(V):
        s = slice(off[u], off[u + 1])
        want = np.nonzero((topo.src == u) & topo.edge_ok)[0]
        assert np.array_equal(eid[s], want)  # edge order within a source
        assert np.array_equal(edge[s, 0], topo.dst[want])
        assert np.array_equal(w[s], topo.w[want])
    # the disabled real edges and the padding are all absent
    assert (~topo.edge_ok).any() and not np.isin(np.nonzero(~topo.edge_ok)[0], eid).any()


@pytest.mark.parametrize("world", sorted(FLEET_WORLDS) + ["fattree"])
def test_dense_out_edge_csr_lists_every_usable_slot_once(world):
    enc, _roots = fleet_world(world)
    A, V, K = enc.in_src.shape
    off, edge, rank = (x.numpy() for x in dense_out_edge_csr(*_t(*dense_planes(enc))))
    assert off.shape == (A, V + 1) and off[0, 0] == 0 and off[-1, -1] == len(rank)
    assert len(rank) == int(enc.in_ok.sum())
    w = edge[:, 1].view(np.float32)
    for a in range(A):
        assert a == 0 or off[a, 0] == off[a - 1, V]  # areas back to back
        for u in range(V):
            s = slice(off[a, u], off[a, u + 1])
            v, k = np.nonzero(enc.in_ok[a] & (enc.in_src[a] == u))  # slot order
            assert np.array_equal(edge[s, 0], v)
            assert np.array_equal(w[s], enc.in_w[a, v, k])
            assert np.array_equal(rank[s], enc.in_rank[a, v, k])
    # padding slots read in_src 0: none of them is listed under vertex 0
    assert np.isfinite(w).all() and (rank >= 0).all()


def test_live_nodes_end_at_the_last_endpoint_or_root():
    topo, _drained = masked_world("grid")
    V = topo.overloaded.shape[0]
    off, edge, _eid = out_edge_csr(*_t(topo.src, topo.dst, topo.w, topo.edge_ok), V)
    assert topo.num_nodes < V  # the node bucket's padding
    live = live_nodes(off, edge, torch.tensor([0], dtype=torch.int32))
    assert live == topo.num_nodes
    assert live_nodes(off, edge, torch.tensor([V - 1], dtype=torch.int32)) == V
    empty = out_edge_csr(*_t(topo.src, topo.dst, topo.w, np.zeros_like(topo.edge_ok)), V)
    assert live_nodes(empty[0], empty[1], torch.tensor([3, -1], dtype=torch.int32)) == 4
    assert live_nodes(empty[0], empty[1], torch.zeros(0, dtype=torch.int32)) == 0


def test_out_edge_lists_of_an_empty_edge_set():
    src = torch.zeros(8, dtype=torch.int32)
    off, edge, eid = out_edge_csr(src, src, torch.ones(8), torch.zeros(8, dtype=torch.bool), 4)
    assert off.tolist() == [0] * 5 and edge.shape == (0, 2) and eid.numel() == 0
    planes = torch.zeros((2, 4, 3), dtype=torch.int32)
    off, edge, rank = dense_out_edge_csr(planes, planes.float(), planes.bool(), planes)
    assert off.shape == (2, 5) and not off.any() and edge.shape == (0, 2)


# -- a sequential model of the kernels' algorithm ----------------------------


def frontier_model(off, edge, ovl, root, keep, cap):
    """Kernel 12's and 15's distances: rounds over the frontier (the
    vertices lowered in the round before, by rank), listed ``cap`` at a
    time; a vertex that may not transit relaxes nothing, a slot only where
    ``keep``.  Returns (dist, the widest frontier)."""
    V = len(ovl)
    dst, w = edge[:, 0], edge[:, 1].view(np.float32)
    d = np.full(V, BIG, np.float32)
    d[root] = 0
    marked, widest = {root}, 0
    while marked:
        frontier, marked = sorted(marked), set()
        widest = max(widest, len(frontier))
        for c0 in range(0, len(frontier), cap):
            for u in frontier[c0:c0 + cap]:
                if ovl[u] and u != root:
                    continue
                for slot in range(off[u], off[u + 1]):
                    if not keep(slot):
                        continue
                    nd = np.float32(d[u] + w[slot])
                    if nd < d[dst[slot]]:
                        d[dst[slot]] = nd
                        marked.add(int(dst[slot]))
    return d, widest


def fleet_lanes_model(off, edge, rank, has, ovl, root, d, D):
    """Kernel 12's lanes from the distances: the fill, the root's DAG
    out-edges' seeds, then OR rounds over the packed propagating sources
    and the lanes a seed can reach."""
    V = len(has)
    dst, w = edge[:, 0], edge[:, 1].view(np.float32)
    lanes = np.where(has[:, None], 0, -128).astype(np.int8).repeat(D, axis=1)
    used = 0
    for slot in range(off[root], off[root + 1]):
        v = dst[slot]
        if np.float32(d[root] + w[slot]) == d[v] and d[v] < BIG:
            if rank[slot] < D:
                lanes[v, rank[slot]] = 1
            used = max(used, rank[slot] + 1)
    sources = {}
    for u in range(V):
        if u == root or d[u] >= BIG or ovl[u]:
            continue
        for slot in range(off[u], off[u + 1]):
            if np.float32(d[u] + w[slot]) == d[dst[slot]]:
                sources.setdefault(int(dst[slot]), []).append(u)
    L = min(used, D)
    changed = True
    while changed:
        changed = False
        for v, srcs in sources.items():
            x = np.maximum(lanes[v, :L], lanes[srcs, :L].max(axis=0))
            if not np.array_equal(x, lanes[v, :L]):
                lanes[v, :L] = x
                changed = True
    return lanes


@pytest.mark.parametrize("cap", [3, 2048])
@pytest.mark.parametrize("world", ["random", "wan"])
def test_frontier_model_over_the_list_equals_jax_masked(world, cap):
    topo, drained = masked_world(world)
    assert topo.overloaded.any()
    roots, sets, mask = masked_inputs(topo, seed=len(world))
    want = np.asarray(jax_masked(
        *(jnp.asarray(a) for a in (topo.src, topo.dst, topo.w, topo.edge_ok)),
        jnp.asarray(mask), jnp.asarray(topo.overloaded), jnp.asarray(roots),
    ))
    V = topo.overloaded.shape[0]
    off, edge, eid = (x.numpy() for x in out_edge_csr(*_t(topo.src, topo.dst, topo.w, topo.edge_ok), V))
    widest = 0
    for b, root in enumerate(roots):
        got, w = frontier_model(off, edge, topo.overloaded, root,
                                lambda slot, b=b: mask[b, eid[slot]], cap)
        assert np.array_equal(got, want[b]), b
        widest = max(widest, w)
    assert (want[0] >= BIG).sum() == V - 1  # row 0: the root cut off
    assert widest > 3  # so cap 3 lists some frontier in chunks


@pytest.mark.parametrize("world", ["grid", "isolated", "two_area_fleet", "fattree"])
def test_fleet_model_over_the_lists_equals_jax_dense_tables(world):
    enc, roots = fleet_world(world)
    A, V, K = enc.in_src.shape
    D = jcsr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    off, edge, rank = (x.numpy() for x in dense_out_edge_csr(*_t(*dense_planes(enc))))
    planes = [jnp.asarray(a) for a in (*dense_planes(enc), enc.in_has, enc.overloaded)]
    picks = roots if len(roots) <= 24 else roots[np.random.default_rng(0).choice(len(roots), 24)]
    absent = 0
    for row in picks:
        dist, nh = (np.asarray(x) for x in jax_dense_tables(*planes, jnp.asarray(np.maximum(row, 0)),
                                                            max_degree=D))
        for a, root in enumerate(row):
            if root < 0:  # the reference masks an absent vantage's slice
                absent += 1
                continue
            ovl = enc.overloaded[a]
            d, _ = frontier_model(off[a], edge, ovl, root, lambda slot: True, 5)
            assert np.array_equal(d, dist[a])
            lanes = fleet_lanes_model(off[a], edge, rank, enc.in_has[a], ovl, root, d, D)
            assert np.array_equal(lanes, nh[a]), (root, a)
    assert absent or world in ("grid", "fattree")


# -- the ctypes argument lists -----------------------------------------------


def c_argtypes(source: str, symbol: str):
    """The ctypes types of the parameters of ``extern "C" int symbol(...)``
    in ``csrc/source``: pointers and the stream as c_void_p."""
    text = (CSRC / source).read_text()
    params = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*{{', text, re.S).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params.split(",")]


@pytest.mark.parametrize("source, symbol, argtypes", [
    ("spf_dense.cu", "openr_fleet_spf_dense", tspf.FLEET_SPF_DENSE_ARGTYPES),
    ("spf_warm.cu", "openr_spf_distances_masked", tspf.SPF_DISTANCES_MASKED_ARGTYPES),
])
def test_launcher_argtypes_match_the_c_entry_points(source, symbol, argtypes):
    assert c_argtypes(source, symbol) == argtypes


def _entry_points():
    """(source, symbol) of every ``extern "C"`` entry point in ``csrc``."""
    return sorted(
        (path.name, sym)
        for path in CSRC.glob("*.cu")
        for sym in re.findall(r'extern "C" int (\w+)\(', path.read_text())
    )


#: every kernel's C entry point and the module constant its launcher binds
ARGTYPES = {
    "openr_dense_spf_distances": tspf.DENSE_SPF_DISTANCES_ARGTYPES,
    "openr_dense_spf_nexthop_lanes": tspf.DENSE_SPF_NEXTHOP_LANES_ARGTYPES,
    "openr_multi_area_select": trs.MULTI_AREA_SELECT_ARGTYPES,
    "openr_warm_spf_distances": tspf.WARM_SPF_DISTANCES_ARGTYPES,
    "openr_spf_nexthop_lanes_reset": tspf.SPF_NEXTHOP_LANES_RESET_ARGTYPES,
    "openr_warm_subgraph_repair": tspf.WARM_SUBGRAPH_REPAIR_ARGTYPES,
    "openr_multi_area_select_delta": trs.MULTI_AREA_SELECT_DELTA_ARGTYPES,
    "openr_sweep_spf_link_failures": tspf.SWEEP_SPF_LINK_FAILURES_ARGTYPES,
    "openr_repair_sweep": trepair.REPAIR_SWEEP_ARGTYPES,
    "openr_select_chunk": tsweep.SELECT_CHUNK_ARGTYPES,
    "openr_compact_deltas": tsweep.COMPACT_DELTAS_ARGTYPES,
    "openr_fleet_spf_dense": tspf.FLEET_SPF_DENSE_ARGTYPES,
    "openr_fleet_select": trs.FLEET_SELECT_ARGTYPES,
    "openr_spf_segment_batch": tspf.SPF_SEGMENT_BATCH_ARGTYPES,
    "openr_spf_segment_batch_rounds": tspf.SPF_SEGMENT_BATCH_ROUNDS_ARGTYPES,
    "openr_spf_distances_masked": tspf.SPF_DISTANCES_MASKED_ARGTYPES,
    "openr_batched_spf": tspf.BATCHED_SPF_ARGTYPES,
    "openr_batched_select_routes": trs.BATCHED_SELECT_ROUTES_ARGTYPES,
    "openr_gather_selection_rows": trs.GATHER_SELECTION_ROWS_ARGTYPES,
}


def test_every_entry_point_has_its_argtypes():
    assert sorted(sym for _src, sym in _entry_points()) == sorted(ARGTYPES)


@pytest.mark.parametrize("source, symbol", _entry_points(), ids=[s for _f, s in _entry_points()])
def test_every_launcher_argtypes_match_its_c_entry_point(source, symbol):
    """The module constant each launcher binds (``function(lib, symbol,
    argtypes)``) against the parameters of its C entry point."""
    assert c_argtypes(source, symbol) == ARGTYPES[symbol]
