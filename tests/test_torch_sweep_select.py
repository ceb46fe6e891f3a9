"""The port's sweep selection (``ops/route_select.py`` ``select_routes_one``;
``ops/sweep_select.py``: the plain versions of kernel 10, ``select_chunk``,
and kernel 11, ``compact_deltas``; ``SweepRouteSelector``) against the JAX
package, exactly.

Each kernel's plain version gets the same numpy inputs as its JAX
counterpart (``select_routes_one``, ``_select_chunk``, ``_compact_deltas``)
— the reference repair sweep's own chunk tables, a candidate table with
anycast, drains, preferences, distances, min-nexthop gates, the root's own
prefix and empty slots — and the pipeline is held to the reference's
``SweepRouteDeltas`` field by field: one chunk and many, padding, a
compaction buffer smaller than the change count (the exact re-run), the
overlapped ``start``/``finish`` and a base pinned across engine rebuilds.

Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.decision.link_state import LinkState
from openr_tpu.emulation import topology as jtopo
from openr_tpu.ops import route_select as jrs
from openr_tpu.ops import sweep_select as jss
from openr_tpu.ops.csr import encode_link_state
from openr_tpu.ops.whatif import LinkFailureSweep as RefSweep
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision.link_state import LinkState as PortLinkState
from openr_tpu_torch.interop import sweep_candidates_from_fields
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import route_select as trs
from openr_tpu_torch.ops import sweep_select as tss
from openr_tpu_torch.ops.whatif import LinkFailureSweep

CAND = tss.CAND_FIELDS
DELTA_FIELDS = (
    "snap_row", "base_valid", "base_metric", "base_lanes", "delta_row",
    "delta_prefix", "delta_valid", "delta_metric", "delta_lanes",
)


def t(a):
    a = np.array(a, copy=True)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def world(seed=3, n=48, links=64, **drains):
    ref, port = LinkState("0"), PortLinkState("0")
    for db in jtopo.build_adj_dbs(jtopo.random_connected_edges(n, links, seed=seed), **drains).values():
        ref.update_adjacency_database(db)
        port.update_adjacency_database(ttypes.AdjacencyDatabase.from_wire(db.to_wire()))
    return encode_link_state(ref), tcsr.encode_link_state(port)


def rich_candidates(V, seed, C=4):
    """Anycast rows with every tie-break in play."""
    rng = np.random.default_rng(seed)
    P = 3 * V
    node = rng.integers(0, V, size=(P, C)).astype(np.int32)
    node[:V, 0] = np.arange(V)  # every node's own loopback, the root's too
    ok = rng.random((P, C)) < 0.7
    ok[:V, 0] = True
    return jss.SweepCandidates(
        cand_node=node,
        cand_ok=ok,
        drain_metric=(rng.random((P, C)) < 0.15).astype(np.int32) * 5,
        path_pref=rng.choice([100, 200], size=(P, C)).astype(np.int32),
        source_pref=rng.choice([100, 150], size=(P, C)).astype(np.int32),
        distance=rng.integers(0, 3, size=(P, C)).astype(np.int32),
        min_nexthop=(rng.random((P, C)) < 0.1).astype(np.int32) * 2,
    )


def port_cands(c):
    return sweep_candidates_from_fields(vars(c))


def fails_for(topo, seed, size=96):
    L = len(topo.links)
    root_links = sorted({int(topo.link_index[e]) for e in np.nonzero(topo.src == 0)[0]})
    rng = np.random.default_rng(seed)
    return np.concatenate([root_links, rng.integers(-1, L, size=size)]).astype(np.int32)


def assert_deltas_equal(want, got):
    for f in DELTA_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.fetch_groups == want.fetch_groups
    assert (got.num_prefixes, got.max_degree) == (want.num_prefixes, want.max_degree)


def ref_chunk_inputs(seed=3, overloaded=("node7",)):
    rt, pt = world(seed=seed, overloaded=list(overloaded))
    eng = RefSweep(rt, "node0")
    fails = fails_for(rt, seed, size=51)
    rs = eng.repair_sweep()
    padded = np.full(64, -1, np.int32)
    padded[: len(fails)] = fails
    dist, nh, _, _ = rs.solve(padded)
    base_dist, base_nh = eng.base_solve()
    cands = rich_candidates(rt.num_nodes, seed)
    sel = jss.SweepRouteSelector(rt, "node0", cands, max_degree=eng.D)
    sel.base_routes(base_dist, base_nh)
    return rt, pt, eng, np.asarray(dist), np.asarray(nh), cands, sel


def test_select_routes_one_matches_reference():
    rt, pt = world(seed=5, overloaded=["node3"])
    eng = RefSweep(rt, "node0")
    dist, nh = eng.base_solve()
    cands = rich_candidates(rt.num_nodes, 5)
    soft = np.zeros(rt.padded_nodes, np.int32)
    soft[[4, 9]] = 3
    want = jrs.select_routes_one(
        *(jnp.asarray(getattr(cands, f)) for f in CAND), jnp.asarray(dist),
        jnp.asarray(nh), jnp.asarray(rt.overloaded), jnp.asarray(soft), jnp.int32(0),
    )
    got = trs.select_routes_one(
        *(t(getattr(cands, f)) for f in CAND), t(dist), t(nh), t(pt.overloaded), t(soft), 0,
    )
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert bool(got[0].any()) and not bool(got[0].all())


def test_select_chunk_matches_reference():
    rt, pt, eng, dist, nh, cands, sel = ref_chunk_inputs()
    bv, bm, bl = sel._base_dev
    want = jss._select_chunk(
        jnp.asarray(dist), jnp.asarray(nh), jnp.asarray(rt.overloaded),
        jnp.zeros(rt.padded_nodes, jnp.int32), jnp.int32(0),
        *(jnp.asarray(getattr(cands, f)) for f in CAND), bv, bm, bl,
        max_degree=eng.D,
    )
    got = tss.select_chunk(
        t(dist), t(nh), t(pt.overloaded), torch.zeros(pt.padded_nodes, dtype=torch.int32),
        0, *(t(getattr(cands, f)) for f in CAND), t(np.asarray(bv)), t(np.asarray(bm)),
        t(np.asarray(bl)), eng.D,
    )
    names = ("changed", "valid", "metric", "lanes")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g), name
    assert int(np.asarray(want[0]).any())


@pytest.mark.parametrize("cap", [4096, 37])
def test_compact_deltas_matches_reference(cap):
    """Three chunks (64, 32 and 64 snapshots, the last two padded), the
    global row offsets of a real sweep, and a cap above and below the
    change count."""
    rt, pt, eng, dist, nh, cands, sel = ref_chunk_inputs()
    bv, bm, bl = sel._base_dev

    def chunk(cols):
        return jss._select_chunk(
            jnp.asarray(dist[:, cols]), jnp.asarray(nh[:, :, cols[0] // 32 : cols[-1] // 32 + 1]),
            jnp.asarray(rt.overloaded), jnp.zeros(rt.padded_nodes, jnp.int32), jnp.int32(0),
            *(jnp.asarray(getattr(cands, f)) for f in CAND), bv, bm, bl, max_degree=eng.D,
        )

    chunks = (chunk(np.arange(64)), chunk(np.arange(32)), chunk(np.arange(64)))
    ns, goffs = (64, 20, 51), (0, 64, 84)
    want = jss._compact_deltas(
        chunks, tuple(jnp.int32(n) for n in ns), tuple(jnp.int32(g) for g in goffs), cap=cap
    )
    bufs = [np.concatenate([np.asarray(c[i]) for c in chunks]) for i in range(4)]
    row_id = np.concatenate(
        [np.where(np.arange(c[1].shape[0]) < n, g + np.arange(c[1].shape[0]), -1)
         for c, n, g in zip(chunks, ns, goffs)]
    ).astype(np.int32)
    got = tss.compact_deltas(*(t(b) for b in bufs), t(row_id), cap)
    assert int(got[0][0]) == int(want[0])
    assert (int(want[0]) > cap) == (cap == 37)
    for w, g in zip(want[1:], got[1:]):
        w = np.asarray(w)
        g = g.numpy().view(np.uint32) if w.dtype == np.uint32 else g.numpy()
        assert w.dtype == g.dtype and np.array_equal(w, g)


def pipelines(seed=11, max_chunk=4096, cands=None):
    rt, pt = world(seed=seed)
    ref = RefSweep(rt, "node0")
    port = LinkFailureSweep(pt, "node0", max_chunk=max_chunk, device="cpu")
    cands = cands if cands is not None else rich_candidates(rt.num_nodes, seed)
    rsel = jss.SweepRouteSelector(rt, "node0", cands, max_degree=ref.D)
    psel = tss.SweepRouteSelector(pt, "node0", port_cands(cands), max_degree=port.D, device="cpu")
    return rt, ref, port, rsel, psel


@pytest.mark.parametrize("max_chunk", [4096, 32])
def test_selector_run_matches_reference(max_chunk):
    rt, ref, port, rsel, psel = pipelines(max_chunk=max_chunk)
    fails = fails_for(rt, 5)
    want = rsel.run(ref.run(fails, fetch=False))
    sweep = port.run(fails, fetch=False)
    assert (len(sweep.chunks) > 1) == (max_chunk == 32)
    got = psel.run(sweep)
    assert_deltas_equal(want, got)
    assert got.fetch_groups == 1 and got.num_deltas > 0
    for s in (0, 3, 50):
        for a, b in zip(want.routes_of(s), got.routes_of(s)):
            assert np.array_equal(a, b)


def test_selector_overflow_reruns_exactly():
    rt, ref, port, rsel, psel = pipelines()
    rsel._cap = psel._cap = 256
    sets = [(int(a),) for a in range(len(rt.links))]
    want = rsel.run(ref.run_sets(sets, fetch=False))
    got = psel.run(port.run_sets(sets, fetch=False))
    assert want.num_deltas > 256 and got.fetch_groups == 2
    assert_deltas_equal(want, got)
    assert psel._cap == rsel._cap


def test_pipelined_start_finish_matches_run():
    rt, ref, port, rsel, psel = pipelines(max_chunk=32)
    rng = np.random.default_rng(5)
    sweeps = [rng.integers(0, len(rt.links), size=60).astype(np.int32) for _ in range(3)]
    expected = [rsel.run(ref.run(f, fetch=False)) for f in sweeps]
    pend = [psel.start(port.run(f, fetch=False)) for f in sweeps]
    assert all(p.is_ready() for p in pend)
    for e, p in zip(expected, pend):
        assert_deltas_equal(e, p.finish())


def test_pending_deltas_pin_their_base_across_engine_rebuilds():
    edges_a = jtopo.random_connected_edges(48, 96, seed=21)
    # generation B: every link of node0 but one made expensive
    edges_b = [
        (u, v, (w + 900 if i > 0 and "node0" in (u, v) else w))
        for i, (u, v, w) in enumerate(edges_a)
    ]

    def encode(edges):
        ls = PortLinkState("0")
        for db in jtopo.build_adj_dbs(edges).values():
            ls.update_adjacency_database(ttypes.AdjacencyDatabase.from_wire(db.to_wire()))
        return tcsr.encode_link_state(ls)

    topo_a, topo_b = encode(edges_a), encode(edges_b)
    eng_a = LinkFailureSweep(topo_a, "node0", device="cpu")
    eng_b = LinkFailureSweep(topo_b, "node0", device="cpu")
    cands = tss.SweepCandidates.single_advertiser(np.arange(topo_a.num_nodes))
    fails = np.random.default_rng(9).integers(0, len(topo_a.links), size=50).astype(np.int32)
    expected = tss.SweepRouteSelector(topo_a, "node0", cands, eng_a.D, device="cpu").run(
        eng_a.run(fails, fetch=False)
    )
    sel = tss.SweepRouteSelector(topo_a, "node0", cands, eng_a.D, device="cpu")
    pend = sel.start(eng_a.run(fails, fetch=False))
    sel.run(eng_b.run(fails, fetch=False))  # base B replaces sel._base
    assert not np.array_equal(eng_a.base_solve()[0], eng_b.base_solve()[0])
    got = pend.finish()
    assert_deltas_equal(expected, got)
    with pytest.raises(RuntimeError, match="twice"):
        pend.finish()


def test_base_routes_match_reference_and_pack():
    rt, ref, port, rsel, psel = pipelines(seed=13)
    want = rsel.base_routes(*ref.base_solve())
    got = psel.base_routes(*port.base_solve())
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # cached by the identity of the base arrays
    assert psel.base_routes(*port.base_solve()) is got
