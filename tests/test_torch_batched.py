"""The per-snapshot what-if batches on the port (on the CPU, through the
plain versions of kernels 16 and 17) against the JAX package's jitted
functions, on the same numpy inputs:

* ``batched_spf`` on the worlds of ``tests/test_ops_spf.py`` (line, ECMP
  diamond, grid, overloaded transit, asymmetric metrics, a partitioned
  graph, random WANs) with per-row masks, hard drains and roots, one row's
  root with its first out-edge disabled (lanes still number ALL the root's
  out-edges);
* ``batched_spf_link_failures`` with -1 rows; ``batched_spf_distinct`` on
  distinct WANs padded to a common edge bucket;
* ``batched_select_routes`` on precomputed SPF with per-row soft and hard
  drains, preferences, self-skip and ``min_nexthop``;
* ``spf_and_select`` on the graft entry's problem and on a 64-row WAN.

Tolerance: exact equality (integer metrics keep every f32 sum exact, and
the fixed points are unique).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as ref_entry
from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.prefix_state import PrefixState
from openr_tpu.emulation.topology import build_adj_dbs, grid_edges, random_connected_edges
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops.route_select import batched_select_routes as jax_select
from openr_tpu.ops.route_select import spf_and_select as jax_spf_and_select
from openr_tpu.ops.spf import batched_spf as jax_batched_spf
from openr_tpu.ops.spf import batched_spf_distinct as jax_distinct
from openr_tpu.ops.spf import batched_spf_link_failures as jax_link_failures
from openr_tpu.ops.spf import hop_count_weights as jax_hop_count_weights
from openr_tpu.types import PrefixEntry, PrefixMetrics
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops import route_select as trs
from openr_tpu_torch.ops import spf as tspf

SMALL = {
    "line": ([("a", "b", 1), ("b", "c", 2)], []),
    "ecmp_diamond": ([("a", "b", 1), ("a", "c", 1), ("b", "d", 1), ("c", "d", 1)], []),
    "grid": (grid_edges(4), []),
    "overloaded_transit": ([("a", "b", 1), ("b", "c", 1), ("a", "c", 10)], ["b"]),
    "asymmetric": ([("a", "b", 1), ("b", "a", 10), ("b", "c", 1), ("a", "c", 5)], []),
    "partitioned": ([("a", "b", 1), ("x", "y", 1)], []),
}
WORLDS = list(SMALL) + [f"wan{seed}" for seed in range(6)]


def make_ls(edges, overloaded=()):
    ls = LinkState("0")
    for db in build_adj_dbs(edges, overloaded=list(overloaded)).values():
        ls.update_adjacency_database(db)
    return ls


def world(name, **enc):
    """(reference LinkState, its encoding) of a named world."""
    if name in SMALL:
        edges, drained = SMALL[name]
    else:
        seed = int(name[3:])
        rng = np.random.default_rng(seed)
        edges = random_connected_edges(24, 30, seed=seed)
        drained = [f"node{i}" for i in rng.choice(24, 3, replace=False)]
    ls = make_ls(edges, drained)
    return ls, jcsr.encode_link_state(ls, **enc)


def max_degree(topo):
    return max(topo.max_out_degree(), 1)


def edges_of(topo):
    return [topo.src, topo.dst, topo.w, topo.edge_ok]


def row_inputs(topo, rng, B=12):
    """Per-row roots, hard-drain rows (the world's drains plus random
    ones) and enable masks; row 0 roots at the busiest node with its first
    out-edge disabled, row 1 solves the unperturbed world."""
    n, V, E = topo.num_nodes, topo.padded_nodes, topo.padded_edges
    out_deg = np.bincount(topo.src[topo.edge_ok], minlength=V)[:n]
    roots = rng.integers(0, n, B).astype(np.int32)
    roots[0] = int(out_deg.argmax())
    ovl = np.tile(topo.overloaded, (B, 1))
    ovl[:, :n] |= rng.random((B, n)) < 0.15
    ovl[1] = topo.overloaded
    enabled = rng.random((B, E)) > 0.2
    enabled[0] = True
    first_out = np.nonzero((topo.src == roots[0]) & topo.edge_ok)[0]
    if len(first_out) > 1:
        enabled[0, first_out[0]] = False
    enabled[1] = True
    return roots, ovl, enabled


def assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", WORLDS)
def test_batched_spf_equals_jax(name):
    _ls, topo = world(name)
    rng = np.random.default_rng(len(name))
    roots, ovl, enabled = row_inputs(topo, rng)
    D = max_degree(topo)
    arrays = edges_of(topo) + [enabled, ovl, roots]
    want = jax_batched_spf(*(jnp.asarray(a) for a in arrays), D)
    got = tspf.batched_spf(*tables_from_numpy(arrays, "cpu"), D)
    assert_equal(got, want)
    # the disabled first out-edge keeps its lane: no vertex reads lane 0
    first_out = np.nonzero((topo.src == roots[0]) & topo.edge_ok)[0]
    if len(first_out) > 1:
        assert not (got[1][0, :, 0] > 0).any()
        assert (got[1][0, :, 1] > 0).any()


@pytest.mark.parametrize("name", WORLDS)
def test_batched_spf_link_failures_equals_jax(name):
    _ls, topo = world(name)
    rng = np.random.default_rng(7 + len(name))
    roots, ovl, _enabled = row_inputs(topo, rng)
    L = len(topo.links)
    failed = rng.integers(-1, L, len(roots)).astype(np.int32)
    failed[:2] = -1
    D = max_degree(topo)
    arrays = edges_of(topo) + [topo.link_index, failed, ovl, roots]
    want = jax_link_failures(*(jnp.asarray(a) for a in arrays), max_degree=D)
    got = tspf.batched_spf_link_failures(*tables_from_numpy(arrays, "cpu"), D)
    assert_equal(got, want)


def test_batched_spf_distinct_equals_jax():
    """Distinct WANs, one per row, padded to a common node and edge bucket
    (each row has its own count of padding edges)."""
    rng = np.random.default_rng(3)
    rows = []
    for b, n in enumerate((8, 24, 12, 16, 20, 5)):
        edges = random_connected_edges(n, n + 3 * b, seed=10 + b)
        drained = [f"node{i}" for i in rng.choice(n, 2, replace=False)]
        ls = make_ls(edges, drained)
        rows.append(jcsr.encode_link_state(ls, node_bucket=32, edge_bucket=256))
    assert len({t.num_edges for t in rows}) == len(rows)
    stack = [np.stack(a) for a in zip(*(edges_of(t) for t in rows))]
    ovl = np.stack([t.overloaded for t in rows])
    roots = np.array([rng.integers(0, t.num_nodes) for t in rows], np.int32)
    D = max(max_degree(t) for t in rows)
    arrays = stack + [ovl, roots]
    want = jax_distinct(*(jnp.asarray(a) for a in arrays), max_degree=D)
    got = tspf.batched_spf_distinct(*tables_from_numpy(arrays, "cpu"), D)
    assert_equal(got, want)


def test_hop_count_weights_equals_jax():
    _ls, topo = world("grid")
    (w,) = tables_from_numpy([topo.w], "cpu")
    assert_equal([tspf.hop_count_weights(w)], [jax_hop_count_weights(jnp.asarray(topo.w))])


# -- selection ---------------------------------------------------------------


def prefix_mix(topo, rng, anycast=24):
    """A loopback per node (single advertiser) and ``anycast`` prefixes with
    2-4 advertisers each, mixed drain metric, preferences, distance and
    min-nexthop."""
    ps = PrefixState()
    names = topo.id_to_node
    for i, node in enumerate(names):
        ps.update_prefix(node, "0", PrefixEntry(f"10.1.{i}.1/32"))
    for k in range(anycast):
        for node in rng.choice(names, int(rng.integers(2, 5)), replace=False):
            metrics = PrefixMetrics(
                drain_metric=int(rng.random() < 0.3),
                path_preference=int(rng.choice([100, 200])),
                source_preference=int(rng.choice([0, 50])),
                distance=int(rng.integers(0, 3)),
            )
            mnh = int(rng.integers(1, 4)) if rng.random() < 0.3 else None
            ps.update_prefix(str(node), "0", PrefixEntry(f"10.2.{k}.0/24", metrics=metrics,
                                                         min_nexthop=mnh))
    return jcsr.encode_prefix_candidates(ps, topo, "0")


def cand_arrays(cands):
    return [cands.cand_node, cands.cand_ok, cands.drain_metric, cands.path_pref,
            cands.source_pref, cands.distance, cands.min_nexthop]


def drain_rows(topo, rng, B):
    n = topo.num_nodes
    ovl = np.tile(topo.overloaded, (B, 1))
    ovl[:, :n] |= rng.random((B, n)) < 0.1
    soft = np.tile(topo.soft, (B, 1))
    soft[:, :n] += np.where(rng.random((B, n)) < 0.15, 60, 0).astype(np.int32)
    return ovl, soft


@pytest.mark.parametrize("name", ["grid", "wan0", "wan3"])
def test_batched_select_routes_on_precomputed_spf_equals_jax(name):
    _ls, topo = world(name)
    rng = np.random.default_rng(11)
    cands = prefix_mix(topo, rng)
    B = 16
    roots, _o, enabled = row_inputs(topo, rng, B)
    # self-skip: row 2 roots at an anycast advertiser
    roots[2] = cands.cand_node[-1, 0]
    ovl, soft = drain_rows(topo, rng, B)
    D = max_degree(topo)
    dist, nh = jax_batched_spf(
        *(jnp.asarray(a) for a in edges_of(topo) + [enabled, ovl, roots]), D
    )
    arrays = cand_arrays(cands) + [np.array(dist), np.array(nh), ovl, soft, roots]
    want = jax_select(*(jnp.asarray(a) for a in arrays))
    got = trs.batched_select_routes(*tables_from_numpy(arrays, "cpu"))
    assert_equal(got, want)
    valid = np.asarray(want[0])
    assert valid.any() and not valid.all()


def test_spf_and_select_on_the_graft_problem_equals_jax():
    args, D, _ls, _topo, _cands = ref_entry._build_problem(batch=9, grid=4)
    arrays = [np.array(a) for a in args]
    want = jax_spf_and_select(*args, max_degree=D)
    got = trs.spf_and_select(*tables_from_numpy(arrays, "cpu"), max_degree=D)
    assert_equal(got, want)


def test_spf_and_select_on_a_64_row_wan_equals_jax():
    ls = make_ls(random_connected_edges(64, 96, seed=5), ["node9", "node33"])
    topo = jcsr.encode_link_state(ls)
    rng = np.random.default_rng(5)
    cands = prefix_mix(topo, rng, anycast=16)
    B = 64
    roots, _o, enabled = row_inputs(topo, rng, B)
    ovl, soft = drain_rows(topo, rng, B)
    D = max_degree(topo)
    arrays = edges_of(topo) + [enabled, ovl, soft, roots] + cand_arrays(cands)
    want = jax_spf_and_select(*(jnp.asarray(a) for a in arrays), max_degree=D)
    got = trs.spf_and_select(*tables_from_numpy(arrays, "cpu"), max_degree=D)
    assert_equal(got, want)
