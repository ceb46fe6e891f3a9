"""The port's dense SPF tables against the JAX reference's, bit for bit.

The same LSDB goes through the reference (``openr_tpu``: encode +
``multi_area_spf_tables_dense`` on the CPU) and through the port
(``openr_tpu_torch``: carried across as wire dicts, encoded, plain
PyTorch SPF).  Tolerance: exact equality on every array — link metrics
are integers, so every f32 path sum is exact and both fixed points are
unique.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.backend import DEGREE_BUCKETS
from openr_tpu.decision.link_state import LinkState
from openr_tpu.emulation.topology import (
    build_adj_dbs,
    grid_edges,
    random_connected_edges,
    ring_edges,
)
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops.route_select import (
    multi_area_spf_tables_dense as jax_spf_tables,
)
from openr_tpu_torch.interop import lsdb_from_wire, tables_from_numpy
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.route_select import multi_area_spf_tables_dense


def lsdb_to_wire(area_link_states, prefix_state):
    """The reference's LinkState/PrefixState → the wire dicts
    ``interop.lsdb_from_wire`` takes: one adjacency database per (node,
    area) and one prefix database per advertising (node, area)."""
    adj_dbs = {
        f"adj:{node}:{area}": db.to_wire()
        for area, ls in area_link_states.items()
        for node, db in ls.get_adjacency_databases().items()
    }
    by_origin = {}
    for entries in prefix_state.prefixes().values():
        for (node, area), entry in entries.items():
            by_origin.setdefault((node, area), []).append(entry.to_wire())
    prefix_dbs = {
        f"prefix:{node}:{area}": {
            "this_node_name": node,
            "prefix_entries": wires,
            "perf_events": None,
            "delete_prefix": False,
            "area": area,
        }
        for (node, area), wires in by_origin.items()
    }
    return adj_dbs, prefix_dbs


def _link_states(area_dbs):
    """{area: [AdjacencyDatabase]} (reference types) → reference LinkStates."""
    out = {}
    for area, dbs in area_dbs.items():
        ls = LinkState(area)
        for db in dbs:
            ls.update_adjacency_database(db)
        out[area] = ls
    return out


def _multiarea_drains():
    """tests/test_stream_delta.py's world: ring(12) with random asymmetric
    metrics, a hard-drained and a soft-drained node; grid(5) beside it."""
    rng = np.random.default_rng(7)
    adj_a = build_adj_dbs(ring_edges(12), area="A")
    for db in adj_a.values():
        for a in db.adjacencies:
            a.metric = int(rng.integers(1, 9))
    adj_a["node3"].is_overloaded = True
    adj_a["node7"].node_metric_increment_val = 50
    adj_b = build_adj_dbs(grid_edges(5), area="B")
    return {"A": list(adj_a.values()), "B": list(adj_b.values())}, "node2"


def _grid_world():
    return {"0": list(build_adj_dbs(grid_edges(8)).values())}, "node0"


def _random_multiarea():
    e1 = random_connected_edges(12, 8, seed=11, prefix="a") + [("a0", "me", 1)]
    e2 = random_connected_edges(10, 6, seed=111, prefix="c") + [("c0", "me", 2)]
    return {
        "1": list(build_adj_dbs(e1, area="1", overloaded=["a4"]).values()),
        "2": list(build_adj_dbs(e2, area="2", soft_drained={"c3": 7}).values()),
    }, "me"


def _isolated_area():
    """me has no adjacencies in area 2: its root row there has no in-edges."""
    return {
        "1": list(build_adj_dbs(grid_edges(3), area="1").values()),
        "2": list(build_adj_dbs([("w0", "w1", 1)], area="2").values()),
    }, "node0"


WORLDS = {
    "multiarea_drains": _multiarea_drains,
    "grid8": _grid_world,
    "random_multiarea": _random_multiarea,
    "isolated_area": _isolated_area,
}

DENSE_FIELDS = ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "roots")


def _encodings(world):
    area_dbs, me = WORLDS[world]()
    ref_ls = _link_states(area_dbs)
    adj_wire, _ = lsdb_to_wire(ref_ls, _EmptyPrefixes())
    port_ls, _ = lsdb_from_wire(adj_wire, {})
    return jcsr.encode_multi_area(ref_ls, me), tcsr.encode_multi_area(port_ls, me)


class _EmptyPrefixes:
    def prefixes(self):
        return {}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_encode_matches_reference(world):
    ref, port = _encodings(world)
    assert ref.has_dense and port.has_dense
    assert port.areas == ref.areas
    for name in DENSE_FIELDS + ("soft",):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    for rt, pt in zip(ref.topos, port.topos):
        assert pt.id_to_node == rt.id_to_node
        assert pt.max_out_degree() == rt.max_out_degree()
        for name in ("src", "dst", "w", "edge_ok", "link_index"):
            assert np.array_equal(getattr(rt, name), getattr(pt, name)), name
        me = port.topos[0].id_to_node[port.roots[0]]
        assert [(l.key, n) for l, n in pt.root_out_edges(me)] == [
            (l.key, n) for l, n in rt.root_out_edges(me)
        ]


def _jax_tables(arrays, D):
    d, n = jax_spf_tables(*(jnp.asarray(a) for a in arrays), max_degree=D)
    return np.asarray(d), np.asarray(n)


def _port_tables(arrays, D):
    d, n = multi_area_spf_tables_dense(*tables_from_numpy(arrays), max_degree=D)
    assert d.dtype == torch.float32 and n.dtype == torch.int8
    return d.numpy(), n.numpy()


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spf_tables_match_reference(world):
    ref, port = _encodings(world)
    D = jcsr.bucket_for(max(ref.max_out_degree(), 1), DEGREE_BUCKETS)
    want = _jax_tables([getattr(ref, f) for f in DENSE_FIELDS], D)
    got = _port_tables([getattr(port, f) for f in DENSE_FIELDS], D)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if world == "isolated_area":
        # me's row in area 2 holds the int8-min fill
        assert (want[1] == -128).any()


def _random_planes(seed, A=2, V=16, real=11, E=40, K=8):
    """Seeded random dense planes with padded vertices (real..V-1) and, in
    every area, a root with no in-edges (its lane row is the -128 fill):
    dst-sorted random edges, padded with pad-node edges, through the
    reference's and the port's build_in_edge_matrix."""
    rng = np.random.default_rng(seed)
    planes = {f: [] for f in DENSE_FIELDS}
    for a in range(A):
        root = int(rng.integers(0, real))
        src = rng.integers(0, real, E).astype(np.int32)
        dst = rng.integers(0, real, E).astype(np.int32)
        keep = (src != dst) & (dst != root)
        src, dst = src[keep], dst[keep]
        n = len(src)
        w = rng.integers(1, 6, n).astype(np.float32)
        ok = rng.random(n) < 0.85
        w = np.where(ok, w, np.float32(np.inf)).astype(np.float32)
        pad = 48 - n
        src = np.concatenate([src, np.full(pad, V - 1, np.int32)])
        dst = np.concatenate([dst, np.full(pad, V - 1, np.int32)])
        w = np.concatenate([w, np.full(pad, np.inf, np.float32)])
        ok = np.concatenate([ok, np.zeros(pad, bool)])
        link = np.concatenate([np.arange(n, dtype=np.int32), np.full(pad, -1, np.int32)])
        order = np.argsort(dst, kind="stable")
        args = (src[order], dst[order], w[order], ok[order], link[order], V, K)
        ref = jcsr.build_in_edge_matrix(*args)
        got = tcsr.build_in_edge_matrix(*args)
        ref = ref[:4] + ref[5:]  # drop the reference's patch-path in_edge_pos
        for x, y in zip(ref, got):
            assert np.array_equal(x, y)
        for f, x in zip(DENSE_FIELDS[:5], got):
            planes[f].append(x)
        ovl = rng.random(V) < 0.15
        planes["overloaded"].append(ovl)
        planes["roots"].append(root)
    out = [np.stack(planes[f]) for f in DENSE_FIELDS[:6]]
    out.append(np.asarray(planes["roots"], np.int32))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spf_tables_random_padded_graph(seed):
    arrays = _random_planes(seed)
    in_has = arrays[4]
    assert not in_has[:, 11:-1].any()  # padded vertices are absent
    roots = arrays[6]
    assert not in_has[np.arange(len(roots)), roots].any()  # roots: no in-edges
    want = _jax_tables(arrays, 8)
    got = _port_tables(arrays, 8)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert (want[1] == -128).any()


def test_dispatch_on_cpu_runs_plain_and_not_the_kernel():
    from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts

    arrays = tables_from_numpy(_random_planes(5))
    reset_launch_counts()
    d1, n1 = tspf.dense_spf_one(*arrays, max_degree=8)
    d0 = tspf.dense_spf_distances_plain(*arrays[:3], arrays[5], arrays[6])
    n0 = tspf.dense_spf_nexthop_lanes_plain(*arrays, d0, max_degree=8)
    assert torch.equal(d1, d0) and torch.equal(n1, n0)
    assert all(v == 0 for v in LAUNCHES.values())
    with pytest.raises(ValueError):
        tspf.dense_spf_distances_cuda(*arrays[:3], arrays[5], arrays[6])
