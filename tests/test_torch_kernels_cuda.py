"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (the kernels have no CPU mode, so every test here skips without
one).  The plain versions are held against the JAX reference by the CPU
tests (``test_torch_spf.py``, ``test_torch_select.py``,
``test_torch_backend.py``); this file imports no JAX, so it runs on a
machine that has none:

    OPENR_TPU_TEST_PLATFORM=gpu python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerance: exact equality on every output.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openr_tpu_torch.decision.backend import DEGREE_BUCKETS, CudaBackend
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import route_db_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.emulation.topology import (
    build_adj_dbs,
    grid_edges,
    random_connected_edges,
)
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops import route_select as rs
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.types import PrefixEntry, RouteComputationRules

pytestmark = pytest.mark.cuda

FIELDS = ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "roots")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda", 0)


def _areas(world):
    me = "me"
    if world == "grid":
        # two root lanes: node0 carries column 0, node1 every other column
        edges = {"0": grid_edges(12) + [("node0", me, 1), ("node1", me, 1)]}
        drains = {"0": dict(overloaded=["node13"], soft_drained={"node40": 9})}
    else:  # multi-area with an area where me has no adjacencies
        edges = {
            "1": random_connected_edges(30, 20, seed=3, prefix="a") + [("a0", me, 2)],
            "2": random_connected_edges(20, 10, seed=4, prefix="b"),
        }
        drains = {"1": dict(overloaded=["a7"]), "2": {}}
    areas = {}
    for a, e in edges.items():
        ls = LinkState(a, me)
        for db in build_adj_dbs(e, area=a, **drains[a]).values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    return areas, me


@pytest.mark.parametrize("world", ["grid", "multiarea_isolated"])
def test_spf_kernels_equal_plain(card, world):
    areas, me = _areas(world)
    enc = csr.encode_multi_area(areas, me)
    planes = tables_from_numpy([getattr(enc, f) for f in FIELDS], card)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    reset_launch_counts()
    dist, nh = spf.dense_spf_one(*planes, max_degree=D)
    torch.cuda.synchronize()
    assert LAUNCHES["dense_spf_distances"] == 1
    assert LAUNCHES["dense_spf_nexthop_lanes"] == 1
    in_src, in_w, in_ok, in_rank, in_has, ovl, roots = planes
    want_d = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
    want_n = spf.dense_spf_nexthop_lanes_plain(*planes, want_d, D)
    assert torch.equal(dist, want_d)
    assert torch.equal(nh, want_n)
    if world == "multiarea_isolated":
        assert bool((nh == -128).any())


def _select_inputs(seed, A=3, V=64, D=4, P=4096, C=8):
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 40, (A, V)).astype(np.float32)
    dist[rng.random((A, V)) < 0.2] = BIG
    nh = (rng.random((A, V, D)) < 0.4).astype(np.int8)
    nh[rng.random((A, V)) < 0.1] = -128
    overloaded = rng.random((A, V)) < 0.2
    soft = np.where(rng.random((A, V)) < 0.2, 3, 0).astype(np.int32)
    cand_area = rng.integers(0, A, (P, C)).astype(np.int32)
    cand_node = rng.integers(0, V, (P, C)).astype(np.int32)
    cand_ok = rng.random((P, C)) < 0.8
    cand_ok[-64:] = False
    overloaded[cand_area[:64], cand_node[:64]] = True
    cnia = rng.integers(-1, V, (P, C, A)).astype(np.int32)
    cnia[np.arange(P)[:, None], np.arange(C)[None, :], cand_area] = cand_node
    ints = [rng.choice(vals, (P, C)).astype(np.int32)
            for vals in ([0, 0, 0, 1], [100, 200], [1, 2], [1, 2, 3])]
    return (dist, nh, overloaded, soft, cand_area, cand_node, cand_ok, *ints, cnia)


@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_select_kernel_equals_plain(card, seed, per_area):
    args = tables_from_numpy(_select_inputs(seed), card)
    reset_launch_counts()
    got = rs.multi_area_select_from_tables(*args, per_area)
    torch.cuda.synchronize()
    assert LAUNCHES["multi_area_select_from_tables"] == 1
    want = rs.multi_area_select_from_tables_plain(*args, per_area)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("algo", list(RouteComputationRules))
def test_backend_on_card_equals_scalar(card, algo):
    areas, me = _areas("multiarea_isolated")
    ps = PrefixState()
    for i in range(30):
        ps.update_prefix(f"a{i}", "1", PrefixEntry(f"10.1.{i}.0/24"))
    for i in range(20):
        ps.update_prefix(f"b{i}", "2", PrefixEntry(f"10.2.{i}.0/24"))
    ps.update_prefix(me, "2", PrefixEntry("10.1.3.0/24"))  # self in isolated area
    solver = SpfSolver(me, route_selection_algorithm=algo)
    backend = CudaBackend(SpfSolver(me, route_selection_algorithm=algo), device=card)
    got = backend.build_route_db(areas, ps)
    assert route_db_summary(got) == route_db_summary(solver.build_route_db(areas, ps))


# -- the steady-state kernels: warm SPF, bounded repair, select + delta ----


def _warm_world(world):
    """(adjacency dbs by area, LinkStates, me) for the 144-node grid or the
    2-area world with an isolated root."""
    me = "me"
    if world == "grid":
        # two root lanes: node0 carries column 0, node1 every other column
        edges = {"0": grid_edges(12) + [("node0", me, 1), ("node1", me, 1)]}
        drains = {"0": dict(overloaded=["node13"], soft_drained={"node40": 9})}
    else:
        edges = {
            "1": random_connected_edges(30, 20, seed=3, prefix="a") + [("a0", me, 2)],
            "2": random_connected_edges(20, 10, seed=4, prefix="b"),
        }
        drains = {"1": dict(overloaded=["a7"]), "2": {}}
    dbs = {a: build_adj_dbs(e, area=a, **drains[a]) for a, e in edges.items()}
    areas = {}
    for a, by_node in dbs.items():
        ls = LinkState(a, me)
        for db in by_node.values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    return dbs, areas, me


def _cold_tables(enc, card):
    planes = tables_from_numpy([getattr(enc, f) for f in FIELDS], card)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    return spf.dense_spf_one(*planes, max_degree=D), D


def _set_metric(dbs, areas, area, node, metric, neighbor=None):
    """Set the metric of ``node``'s adjacency to ``neighbor`` (its first
    adjacency when None)."""
    db = dbs[area][node]
    for adj in db.adjacencies:
        if neighbor is None or adj.other_node_name == neighbor:
            adj.metric = metric
            break
    areas[area].update_adjacency_database(db)


def _set_overload(dbs, areas, area, node, overloaded):
    db = dbs[area][node]
    db.is_overloaded = overloaded
    areas[area].update_adjacency_database(db)


def _set_link_metric(dbs, areas, a, b, metric):
    """Both directions of the grid link a-b; column 0 below node0 is
    reached through these links alone, so routes move with them."""
    _set_metric(dbs, areas, "0", a, metric, neighbor=b)
    _set_metric(dbs, areas, "0", b, metric, neighbor=a)


@pytest.mark.parametrize("world", ["grid", "multiarea_isolated"])
@pytest.mark.parametrize("delta", ["weaken", "improve"])
def test_warm_kernels_equal_plain_and_cold(card, world, delta):
    from openr_tpu_torch.ops.repair import plan_generation_delta

    dbs, areas, me = _warm_world(world)
    area = sorted(areas)[0]
    node = "node77" if world == "grid" else "a11"
    # the grid's improvement undrains node1: the root's second lane opens
    # and the lanes of every column but 0 move from their warm seed
    undrain = delta == "improve" and world == "grid"
    if undrain:
        _set_overload(dbs, areas, area, "node1", True)
    elif delta == "improve":
        _set_metric(dbs, areas, area, node, 6)
    old = csr.encode_multi_area(areas, me)
    (prev_dist, prev_nh), D = _cold_tables(old, card)
    if undrain:
        _set_overload(dbs, areas, area, "node1", False)
    else:
        _set_metric(dbs, areas, area, node, 6 if delta == "weaken" else 1)
    new, kind, _ = csr.patch_encoded_multi_area_slots(old, areas, me)
    assert kind == "patch"
    plans = [
        plan_generation_delta(ot, int(new.roots[i]), prev_dist[i].cpu().numpy(), nt)
        for i, (ot, nt) in enumerate(zip(old.topos, new.topos))
    ]
    (reset,) = tables_from_numpy([np.stack([p.reset for p in plans])], card)
    (want_d, want_n), _ = _cold_tables(new, card)
    reset_launch_counts()
    if delta == "weaken":
        assert all(not p.has_improvements and p.lanes_compatible for p in plans)
        assert int(reset.sum()) > 0
        sub = tables_from_numpy(CudaBackend._pack_sub_edges(None, new, plans), card)
        args = (*sub, prev_dist, prev_nh, reset, D)
        got = spf.warm_subgraph_repair(*args)
        torch.cuda.synchronize()
        assert LAUNCHES["warm_subgraph_repair"] == 1
        plain = spf.warm_subgraph_repair_plain(*args)
    else:
        assert any(p.has_improvements for p in plans)
        seg = tables_from_numpy(
            [getattr(new, f) for f in ("src", "dst", "w", "edge_ok", "overloaded", "roots")]
            + [np.asarray([p.lanes_compatible for p in plans], bool)],
            card,
        )
        args = (*seg[:6], prev_dist, prev_nh, reset, seg[6], D)
        got = spf.warm_spf_one(*args)
        torch.cuda.synchronize()
        assert LAUNCHES["warm_spf_distances"] == 1
        assert LAUNCHES["spf_nexthop_lanes_reset"] == 1
        d0, nh0 = spf.warm_seeds(prev_dist, prev_nh, reset, seg[6])
        plain_d, _ = spf.warm_spf_distances_plain(*seg[:6], d0)
        plain_n, _ = spf.spf_nexthop_lanes_reset_plain(*seg[:6], plain_d, nh0, D)
        plain = (plain_d, plain_n)
        if undrain:
            assert bool(seg[6].all())  # the lane seed is the previous lanes
            assert int((nh0 != want_n).sum()) > 100
        # reset semantics make any seed safe: from all zeros every lane
        # propagates down the whole DAG to the same tables
        zero = torch.zeros_like(nh0)
        got_z, _ = spf.spf_nexthop_lanes_reset(*seg[:6], got[0], zero, D)
        plain_z, _ = spf.spf_nexthop_lanes_reset_plain(*seg[:6], plain_d, zero, D)
        assert torch.equal(got_z, plain_z) and torch.equal(got_z, want_n)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert torch.equal(got[0], want_d) and torch.equal(got[1], want_n)
    if world == "multiarea_isolated":
        assert bool((got[1] == -128).any())


@pytest.mark.parametrize("per_area", [False, True])
def test_select_delta_kernel_equals_plain(card, per_area):
    inputs = _select_inputs(2)
    rng = np.random.default_rng(7)
    dist, nh = inputs[0], inputs[1]
    prev_dist = np.where(rng.random(dist.shape) < 0.1, dist + 1, dist).astype(np.float32)
    prev = rs.multi_area_select_from_tables_plain(
        *tables_from_numpy((prev_dist, *inputs[1:]), card), per_area
    )
    node_changed = rng.random(dist.shape) < 0.03
    args = (*tables_from_numpy(inputs, card), *prev,
            *tables_from_numpy([node_changed], card))
    reset_launch_counts()
    got = rs.multi_area_select_delta_from_tables(*args, per_area)
    torch.cuda.synchronize()
    assert LAUNCHES["multi_area_select_delta_from_tables"] == 1
    want = rs.multi_area_select_delta_from_tables_plain(*args, per_area)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert 0 < int(got[4].sum()) < got[4].numel()


def test_backend_steady_state_ticks_on_card(card):
    """Prefix churn, a weakening and a restoring warm tick (the lanes
    below the link move to node1's lane and back), a warm undrain, and
    two unhinted drain ticks, each on its kernels and equal to the
    oracle."""
    dbs, areas, me = _warm_world("grid")
    ps = PrefixState()
    for i in range(144):
        ps.update_prefix(f"node{i}", "0", PrefixEntry(f"10.0.{i}.0/24"))
    backend = CudaBackend(SpfSolver(me), device=card)
    backend.build_route_db(areas, ps)

    def drain(node):
        db = dbs["0"][node]
        db.is_overloaded = not db.is_overloaded
        areas["0"].update_adjacency_database(db)

    ticks = [
        ("churn", lambda: ps.update_prefix("node5", "0", PrefixEntry("10.9.0.0/24")),
         dict(changed_prefixes={"10.9.0.0/24"}), {"multi_area_select_from_tables"}),
        ("weaken", lambda: _set_link_metric(dbs, areas, "node60", "node72", 6),
         dict(changed_prefixes=set(), force_full=True, warm_delta=True),
         {"warm_subgraph_repair", "multi_area_select_from_tables"}),
        ("restore", lambda: _set_link_metric(dbs, areas, "node60", "node72", 1),
         dict(changed_prefixes=set(), force_full=True, warm_delta=True),
         {"warm_spf_distances", "spf_nexthop_lanes_reset", "multi_area_select_from_tables"}),
        ("undrain", lambda: drain("node13"),
         dict(changed_prefixes=set(), force_full=True, warm_delta=True),
         {"warm_spf_distances", "spf_nexthop_lanes_reset", "multi_area_select_from_tables"}),
        ("drain", lambda: drain("node30"), dict(changed_prefixes=set(), force_full=True),
         {"dense_spf_distances", "dense_spf_nexthop_lanes", "multi_area_select_from_tables"}),
        ("drain2", lambda: drain("node31"), dict(changed_prefixes=set(), force_full=True),
         {"dense_spf_distances", "dense_spf_nexthop_lanes",
          "multi_area_select_delta_from_tables", "gather_selection_rows"}),
    ]
    for name, change, hints, kernels in ticks:
        change()
        reset_launch_counts()
        got = backend.build_route_db(areas, ps, **hints)
        torch.cuda.synchronize()
        assert {k for k, v in LAUNCHES.items() if v} == kernels, name
        want = SpfSolver(me).build_route_db(areas, ps)
        assert route_db_summary(got) == route_db_summary(want), name


# -- the what-if path: kernels 8-11 ---------------------------------------


def _whatif_world(world):
    from openr_tpu_torch.decision.link_state import LinkState as _LS

    if world == "wan":
        edges = random_connected_edges(96, 160, seed=7)
    elif world == "grid":
        edges = grid_edges(10)
    else:  # a line: every link a bridge
        edges = [(f"node{i}", f"node{i + 1}", 1) for i in range(11)]
    drains = dict(overloaded=["node5"]) if world == "wan" else {}
    ls = _LS("0", "node0")
    for db in build_adj_dbs(edges, **drains).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for n in sorted(ls.get_adjacency_databases()):
        ps.update_prefix(n, "0", PrefixEntry(f"10.{int(n[4:]) // 256}.{int(n[4:]) % 256}.0/24"))
    return ls, ps


def _whatif_fails(topo, size=150, seed=1):
    L = len(topo.links)
    root_links = sorted({int(topo.link_index[e]) for e in np.nonzero(topo.src == 0)[0]})
    rng = np.random.default_rng(seed)
    return np.concatenate([root_links, np.arange(L), rng.integers(-1, L, size=size)]).astype(np.int32)


@pytest.mark.parametrize("world", ["wan", "grid", "line"])
def test_sweep_and_repair_kernels_equal_plain_and_each_other(card, world):
    from openr_tpu_torch.ops import repair as rp
    from openr_tpu_torch.ops.whatif import LinkFailureSweep

    ls, _ps = _whatif_world(world)
    topo = csr.encode_link_state(ls)
    eng = LinkFailureSweep(topo, "node0", device=card)
    fails = _whatif_fails(topo)
    fails = np.concatenate([fails, np.full(-len(fails) % 32, -1, np.int32)])
    edges = tables_from_numpy(
        [topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index], card
    )
    ovl = tables_from_numpy([topo.overloaded], card)[0]
    failed = tables_from_numpy([fails], card)[0]
    reset_launch_counts()
    cd, cn, _, _ = spf.sweep_spf_link_failures(*edges, failed, ovl, 0, eng.D)
    torch.cuda.synchronize()
    assert LAUNCHES["sweep_spf_link_failures"] == 1
    pd, pn, _, _ = spf.sweep_spf_link_failures_plain(*edges, failed, ovl, 0, eng.D)
    assert torch.equal(cd, pd) and torch.equal(cn, pn)

    rs = eng.repair_sweep()
    plain_args = None
    for k, batch in ((1, fails), (3, None)):
        if batch is None:  # sets of 1-3 links, some cutting the graph
            rng = np.random.default_rng(3)
            batch = np.full((64, 3), -1, np.int32)
            for i in range(64):
                m = int(rng.integers(1, 4))
                batch[i, :m] = rng.choice(len(topo.links), size=m, replace=False)
        reset_launch_counts()
        kd, kn, _, _ = rs.solve(batch)
        torch.cuda.synchronize()
        assert LAUNCHES["repair_sweep"] == 1
        src, dst, w, lid = rs._edges
        fails_t = tables_from_numpy([batch.reshape(len(batch), -1)], card)[0]
        plain_args = (src, dst, w, lid, rs._tsok, fails_t, *rs._plan_t)
        qd, qn, _, _ = rp.repair_sweep_plain(*plain_args, d_lanes=rs.plan.lanes, din=rs.plan.din)
        assert torch.equal(kd, qd) and torch.equal(kn, qn), k
    # the repair's single-link tables are the cold kernel's
    kd, kn, _, _ = rs.solve(fails)
    B = len(fails)
    bits = (kn[:, :, torch.arange(B, device=card) // 32] >> (torch.arange(B, device=card) % 32)) & 1
    assert torch.equal(kd, cd)
    assert torch.equal(bits.permute(0, 2, 1).to(torch.int8), (cn > 0).to(torch.int8))


@pytest.mark.parametrize("cap", [8192, 50])
def test_select_and_compact_kernels_equal_plain(card, cap):
    from openr_tpu_torch.ops import sweep_select as ss
    from openr_tpu_torch.ops.whatif import LinkFailureSweep

    ls, ps = _whatif_world("wan")
    topo = csr.encode_link_state(ls)
    cands = csr.encode_prefix_candidates(ps, topo, "0")
    eng = LinkFailureSweep(topo, "node0", max_chunk=64, device=card)
    sel = ss.SweepRouteSelector(topo, "node0", cands, eng.D, device=card)
    sweep = eng.run(_whatif_fails(topo), fetch=False)
    assert len(sweep.chunks) > 1
    sel.base_routes(*sweep.base)
    bufs = []
    for _off, _n, dist, nh in sweep.chunks:
        args = (dist, nh, sel._overloaded, sel._soft, sel.root_id, *sel._cand, *sel._base_dev, sel.D)
        reset_launch_counts()
        got = ss.select_chunk(*args)
        torch.cuda.synchronize()
        assert LAUNCHES["select_chunk"] == 1
        want = ss.select_chunk_plain(*args)
        for g, p in zip(got, want):
            assert torch.equal(g, p)
        bufs.append(got)
    cat = [torch.cat([b[i] for b in bufs]) for i in range(4)]
    row_id = torch.cat([
        torch.where(torch.arange(d.shape[1], device=card) < n,
                    off + torch.arange(d.shape[1], device=card), -1).to(torch.int32)
        for off, n, d, _nh in sweep.chunks
    ])
    reset_launch_counts()
    got = ss.compact_deltas(*cat, row_id, cap)
    torch.cuda.synchronize()
    assert LAUNCHES["compact_deltas"] == 1
    want = ss.compact_deltas_plain(*cat, row_id, cap)
    assert int(got[0][0]) == int(want[0]) > 50
    for g, p in zip(got[1:], want[1:]):
        assert torch.equal(g, p)


def test_whatif_engine_on_card_equals_plain_path_and_generic(card):
    from openr_tpu_torch.decision import whatif_api as wa

    ls, ps = _whatif_world("wan")
    areas = {"0": ls}
    topo = csr.encode_link_state(ls)
    pairs = [(l.n1, l.n2) for l in topo.links[:12]] + [("node0", "nope")]
    on_card = wa.WhatIfApiEngine(SpfSolver("node0"), device=card)
    plain = wa.WhatIfApiEngine(SpfSolver("node0"), device="cpu")
    reset_launch_counts()
    got = on_card.run(pairs, areas, ps, 1)
    torch.cuda.synchronize()
    launched = {n for n, c in LAUNCHES.items() if c}
    assert launched == {"sweep_spf_link_failures", "repair_sweep", "select_chunk", "compact_deltas"}
    assert got == plain.run(pairs, areas, ps, 1)
    generic = wa.GenericSolverWhatIfEngine(SpfSolver("node0")).run(pairs[:4], areas, ps, 1)

    def changes(resp):
        return [
            [dict(c, old_nexthops=sorted(c["old_nexthops"]), new_nexthops=sorted(c["new_nexthops"]))
             for c in f.get("changes", [])]
            for f in resp["failures"]
        ]

    assert changes(on_card.run(pairs[:4], areas, ps, 1)) == changes(generic)
    sim = pairs[:3]
    assert on_card.run(sim, areas, ps, 1, simultaneous=True) == plain.run(
        sim, areas, ps, 1, simultaneous=True
    )
    assert wa._whatif_engine_criticality(on_card, areas, ps, 1, max_pairs=300) == (
        wa._whatif_engine_criticality(plain, areas, ps, 1, max_pairs=300)
    )


# -- the fleet and multi-area what-if kernels: 12 (fleet_spf_dense), 13
# (fleet_select) and 14 (spf_segment_batch) ---------------------------------

SEGMENT = ("src", "dst", "w", "edge_ok", "overloaded")


def _fleet_roots(enc):
    names = sorted(set().union(*[set(t.node_ids) for t in enc.topos]))
    return np.asarray([[t.node_ids.get(n, -1) for t in enc.topos] for n in names], np.int32)


@pytest.mark.parametrize("world", ["grid", "multiarea_isolated"])
def test_fleet_spf_kernels_equal_plain_and_each_other(card, world):
    """Kernels 12 and 14 over every vantage root (-1 where absent) equal
    their plain versions and each other; kernel 14 at one row equals
    kernels 1 and 2 (the segment form is bit-equal to the dense one)."""
    areas, me = _areas(world)
    enc = csr.encode_multi_area(areas, me)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    (roots,) = tables_from_numpy((_fleet_roots(enc),), card)
    dense = tables_from_numpy([getattr(enc, f) for f in FIELDS[:-1]], card)
    seg = tables_from_numpy([getattr(enc, f) for f in SEGMENT], card)
    reset_launch_counts()
    got12 = spf.fleet_spf_dense(*dense, roots, D)
    got14 = spf.spf_segment_batch(*seg, roots, D)
    torch.cuda.synchronize()
    assert LAUNCHES["fleet_spf_dense"] == 1 and LAUNCHES["spf_segment_batch"] == 1
    want12 = spf.fleet_spf_dense_plain(*dense, roots, D)
    want14 = spf.spf_segment_batch_plain(*seg, roots, D)
    for got, want in ((got12, want12), (got14, want14), (got14, want12)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if world == "multiarea_isolated":
        assert bool((roots < 0).any()) and bool((got12[1] == -128).any())
    (me_roots,) = tables_from_numpy((enc.roots,), card)
    one = spf.spf_one(*seg, me_roots, D)
    cold = spf.dense_spf_one(*dense, me_roots, max_degree=D)
    assert torch.equal(one[0], cold[0]) and torch.equal(one[1], cold[1])


def _fattree_areas(scale=128):
    from openr_tpu_torch.emulation.topology import _build_fattree

    ls = LinkState("0", "rsw0_0")
    for db in build_adj_dbs(_build_fattree(scale, 0)).values():
        ls.update_adjacency_database(db)
    return {"0": ls}, "rsw0_0"


def _frontier_path(path, monkeypatch):
    """Force a path of the frontier kernels (12 and 15): the frontier state
    in shared memory listed whole, listed 4 vertices at a time, kernel 12's
    lane lists in the global scratch, or the whole state there."""
    if path == "chunked":
        monkeypatch.setattr(spf, "FRONTIER_CAP", 4)
    elif path == "lists":
        monkeypatch.setattr(spf, "FLEET_SHARED_ALL_BYTES", 0)
    elif path == "global":
        monkeypatch.setattr(spf, "MAX_SHARED_BYTES", 0)


@pytest.mark.parametrize("path", ["shared", "chunked", "lists", "global"])
@pytest.mark.parametrize("world", ["grid", "multiarea_isolated", "fattree"])
def test_fleet_frontier_kernel_on_every_path_equals_plain(card, world, path, monkeypatch):
    """Kernel 12 (frontier relaxation, then the packed OR lanes) against
    its plain version on every path of its frontier state: an overloaded
    non-root transit node and a soft drain (grid), A = 2 with roots of -1,
    vertices absent from an area and unreachable ones (multiarea_isolated),
    a 4-pod fat-tree whose roots have up to 28 out-edges."""
    areas, me = _fattree_areas() if world == "fattree" else _areas(world)
    enc = csr.encode_multi_area(areas, me)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    (roots,) = tables_from_numpy((_fleet_roots(enc),), card)
    dense = tables_from_numpy([getattr(enc, f) for f in FIELDS[:-1]], card)
    _frontier_path(path, monkeypatch)
    reset_launch_counts()
    got = spf.fleet_spf_dense(*dense, roots, D)
    torch.cuda.synchronize()
    assert LAUNCHES["fleet_spf_dense"] == 1
    want = spf.fleet_spf_dense_plain(*dense, roots, D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if world == "multiarea_isolated":
        assert enc.num_areas == 2 and bool((roots < 0).any())
        assert bool((got[1] == -128).any()) and bool((got[0] >= BIG).any())


@pytest.mark.parametrize("S", [1, 3])
def test_segment_batch_with_failed_sets_equals_plain(card, S):
    areas, me = _areas("multiarea_isolated")
    enc = csr.encode_multi_area(areas, me)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    rng = np.random.default_rng(S)
    B = 200
    fa = rng.integers(-1, enc.num_areas, (B, S)).astype(np.int32)
    fl = rng.integers(-1, max(len(t.links) for t in enc.topos), (B, S)).astype(np.int32)
    fa[-1], fl[-1] = -1, -1  # the base row
    link_index = np.stack([t.link_index for t in enc.topos])
    seg = tables_from_numpy([getattr(enc, f) for f in SEGMENT], card)
    li, fa_t, fl_t = tables_from_numpy((link_index, fa, fl), card)
    (roots,) = tables_from_numpy((np.repeat(enc.roots[None], B, axis=0),), card)
    got = spf.spf_segment_batch(*seg, roots, D, link_index=li, fail_area=fa_t, fail_link=fl_t)
    want = spf.spf_segment_batch_plain(*seg, roots, D, link_index=li, fail_area=fa_t,
                                       fail_link=fl_t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert any(not torch.equal(got[1][b], got[1][-1]) for b in range(B - 1))


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("per_area", [False, True])
def test_fleet_select_kernel_equals_plain(card, per_area, diff):
    B = 5
    rows = [_select_inputs(seed, P=1000) for seed in range(B)]
    dist = np.stack([r[0] for r in rows])
    nh = np.stack([r[1] for r in rows])
    args = tables_from_numpy((dist, nh, *rows[0][2:]), card)
    kw = {}
    if diff:
        base = rs.fleet_select_plain(*args, per_area)
        prev = [t.clone() for t in base]
        prev[0][1, 7, 0] = ~prev[0][1, 7, 0]
        prev[1][3, 999, 2] = -1.0
        kw = dict(zip(("prev_use", "prev_shortest", "prev_lanes", "prev_valid"), prev))
    reset_launch_counts()
    got = rs.fleet_select(*args, per_area, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fleet_select"] == 1
    want = rs.fleet_select_plain(*args, per_area, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if diff:
        assert got[4].tolist() == [False, True, False, True, False]


def test_fleet_and_multiarea_engines_on_card_equal_plain_path(card):
    from openr_tpu_torch.decision import whatif_api as wa
    from openr_tpu_torch.decision.fleet import FleetRibEngine

    areas, me = _areas("multiarea_isolated")
    ps = PrefixState()
    for i in range(30):
        ps.update_prefix(f"a{i}", "1", PrefixEntry(f"10.1.{i}.0/24"))
    for i in range(20):
        ps.update_prefix(f"b{i}", "2", PrefixEntry(f"10.2.{i}.0/24"))
    on_card = FleetRibEngine(SpfSolver(me), device=card)
    plain = FleetRibEngine(SpfSolver(me), device="cpu")
    reset_launch_counts()
    summary = on_card.fleet_summary(areas, ps, 1)
    torch.cuda.synchronize()
    assert {n for n, c in LAUNCHES.items() if c} == {"fleet_spf_dense", "fleet_select"}
    assert summary == plain.fleet_summary(areas, ps, 1)
    for node in ("a0", "b3", me):
        assert route_db_summary(on_card.compute_for_node(node, areas, ps, 1)) == (
            route_db_summary(SpfSolver(node).build_route_db(areas, ps)))
    # a second generation: the delta on the card
    db = areas["1"].get_adjacency_databases()["a5"]
    adjs = [dataclasses.replace(a, metric=9) for a in db.adjacencies]
    areas["1"].update_adjacency_database(dataclasses.replace(db, adjacencies=adjs))
    s2 = on_card.fleet_summary(areas, ps, 2)
    assert on_card.num_delta_solves == 1
    assert s2 == FleetRibEngine(SpfSolver(me), device="cpu").fleet_summary(areas, ps, 2)

    links = [(l.n1, l.n2) for t in csr.encode_multi_area(areas, me).topos for l in t.links][:40]
    eng = wa.MultiAreaWhatIfEngine(SpfSolver(me), device=card)
    reset_launch_counts()
    got = eng.run(links, areas, ps, 2)
    torch.cuda.synchronize()
    assert {n for n, c in LAUNCHES.items() if c} == {"spf_segment_batch", "fleet_select"}
    assert got == wa.MultiAreaWhatIfEngine(SpfSolver(me), device="cpu").run(links, areas, ps, 2)
    generic = wa.GenericSolverWhatIfEngine(SpfSolver(me)).run(links[:6], areas, ps, 2)

    def changes(resp):
        return [sorted((c["prefix"], c["old_metric"], tuple(sorted(c["old_nexthops"])),
                        c["new_metric"], tuple(sorted(c["new_nexthops"])))
                       for c in f.get("changes", [])) for f in resp["failures"]]

    assert changes(eng.run(links[:6], areas, ps, 2)) == changes(generic)


def test_backend_on_card_builds_a_segment_encoding(card):
    """The hub world declines the dense layout: kernel 14 at one row and
    the selection kernel build it, equal to the scalar solver."""
    edges = [("hub", f"leaf{i}", 1) for i in range(csr.IN_DEGREE_BUCKETS[-1] + 1)]
    ls = LinkState("0", "hub")
    for db in build_adj_dbs(edges).values():
        ls.update_adjacency_database(db)
    ps = PrefixState()
    for i in range(64):
        ps.update_prefix(f"leaf{i}", "0", PrefixEntry(f"10.3.{i}.0/24"))
    backend = CudaBackend(SpfSolver("hub"), device=card)
    reset_launch_counts()
    got = backend.build_route_db({"0": ls}, ps)
    torch.cuda.synchronize()
    assert {n for n, c in LAUNCHES.items() if c} == {"spf_segment_batch", "multi_area_select_from_tables"}
    assert route_db_summary(got) == route_db_summary(SpfSolver("hub").build_route_db({"0": ls}, ps))


# -- kernels 12 and 14 on both of their paths (shared and global state) and
# kernel 15 (spf_distances_masked) -------------------------------------------


@pytest.mark.parametrize("world", ["grid", "multiarea_isolated"])
def test_fleet_kernels_global_path_equals_shared_path_and_plain(card, world, monkeypatch):
    """At a shape both of kernel 14's paths take, its global-state path
    (forced by a shared-memory budget of 0) equals its shared path and the
    plain version, failed sets too; kernel 12 (always global-state) equals
    its plain version."""
    areas, me = _areas(world)
    enc = csr.encode_multi_area(areas, me)
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    (roots,) = tables_from_numpy((_fleet_roots(enc),), card)
    dense = tables_from_numpy([getattr(enc, f) for f in FIELDS[:-1]], card)
    seg = tables_from_numpy([getattr(enc, f) for f in SEGMENT], card)
    want12 = spf.fleet_spf_dense_plain(*dense, roots, D)
    want14 = spf.spf_segment_batch_plain(*seg, roots, D)
    launch, got12 = spf.fleet_spf_dense_launcher(*dense, roots, D)
    launch()
    torch.cuda.synchronize()
    assert torch.equal(got12[0], want12[0]) and torch.equal(got12[1], want12[1])
    for budget in (spf.MAX_SHARED_BYTES, 0):
        monkeypatch.setattr(spf, "MAX_SHARED_BYTES", budget)
        launch, got14 = spf.spf_segment_batch_launcher(*seg, roots, D)
        launch()
        torch.cuda.synchronize()
        assert torch.equal(got14[0], want14[0]) and torch.equal(got14[1], want14[1]), budget
    B, S = 64, 3
    rng = np.random.default_rng(1)
    fa = rng.integers(-1, enc.num_areas, (B, S)).astype(np.int32)
    fl = rng.integers(-1, max(len(t.links) for t in enc.topos), (B, S)).astype(np.int32)
    link_index = np.stack([t.link_index for t in enc.topos])
    li, fa_t, fl_t = tables_from_numpy((link_index, fa, fl), card)
    (rows,) = tables_from_numpy((np.repeat(enc.roots[None], B, axis=0),), card)
    sets = dict(link_index=li, fail_area=fa_t, fail_link=fl_t)
    want = spf.spf_segment_batch_plain(*seg, rows, D, **sets)
    launch, got = spf.spf_segment_batch_launcher(*seg, rows, D, **sets)
    launch()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _backbone(scale=8192):
    from openr_tpu_torch.emulation.topology import _build_wan

    ls = LinkState("0", "core0")
    for db in build_adj_dbs(_build_wan(scale, 7)).values():
        ls.update_adjacency_database(db)
    return ls


def test_fleet_kernels_at_the_16384_node_bucket_take_the_global_path(card):
    """The 8,192-node backbone (V = 16,384, E = 32,768, K = 32): both
    kernels' block state exceeds shared memory (kernel 14 keeps part of it
    in its global scratch), and the global path equals the plain versions
    (kernel 14 with 1-3-link failed sets)."""
    enc = csr.encode_multi_area({"0": _backbone()}, "core0")
    V, E = enc.overloaded.shape[1], enc.src.shape[1]
    K = enc.in_src.shape[2]
    assert (V, E) == (16384, 32768)
    assert spf.segment_batch_layout(8, V, E, 3, card)[1] != 0
    assert spf.fleet_dense_state_bytes(V, K) > spf.MAX_SHARED_BYTES
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    rng = np.random.default_rng(3)
    B, S = 8, 3
    picks = rng.choice(enc.topos[0].num_nodes, B, replace=False).astype(np.int32)
    (roots,) = tables_from_numpy((picks[:, None],), card)
    dense = tables_from_numpy([getattr(enc, f) for f in FIELDS[:-1]], card)
    seg = tables_from_numpy([getattr(enc, f) for f in SEGMENT], card)
    fl = np.full((B, S), -1, np.int32)
    for b in range(B):
        k = 1 + b % 3
        fl[b, :k] = rng.choice(len(enc.topos[0].links), k, replace=False)
    fa = np.where(fl >= 0, 0, -1).astype(np.int32)
    li, fa_t, fl_t = tables_from_numpy((enc.topos[0].link_index[None], fa, fl), card)
    sets = dict(link_index=li, fail_area=fa_t, fail_link=fl_t)
    reset_launch_counts()
    got12 = spf.fleet_spf_dense(*dense, roots, D)
    got14 = spf.spf_segment_batch(*seg, roots, D, **sets)
    torch.cuda.synchronize()
    assert LAUNCHES["fleet_spf_dense"] == 1 and LAUNCHES["spf_segment_batch"] == 1
    want12 = spf.fleet_spf_dense_plain(*dense, roots, D)
    want14 = spf.spf_segment_batch_plain(*seg, roots, D, **sets)
    for got, want in ((got12, want12), (got14, want14)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_segment_kernel_hub_row_on_the_global_path_equals_plain(card):
    """Kernel 14 at one row on a hub of 5,000 leaves (V = 16,384, the
    global path; the leaves hold their seed lanes without a round) equals
    its plain version."""
    ls = LinkState("0", "hub")
    for db in build_adj_dbs([("hub", f"leaf{i}", 1) for i in range(5000)]).values():
        ls.update_adjacency_database(db)
    enc = csr.encode_multi_area({"0": ls}, "hub")
    V, E = enc.overloaded.shape[1], enc.src.shape[1]
    assert V == 16384 and spf.segment_batch_layout(1, V, E, 0, card)[1] != 0
    D = csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    seg = tables_from_numpy([getattr(enc, f) for f in SEGMENT], card)
    (roots,) = tables_from_numpy((enc.roots[None],), card)
    reset_launch_counts()
    got = spf.spf_segment_batch(*seg, roots, D)
    torch.cuda.synchronize()
    assert LAUNCHES["spf_segment_batch"] == 1
    want = spf.spf_segment_batch_plain(*seg, roots, D)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _masked_rows(topo, B, rng, max_links=40):
    """Roots (the vantage first) and failed link sets of 0-max_links links."""
    L = len(topo.links)
    sets = [sorted(rng.choice(L, int(rng.integers(0, max_links + 1)), replace=False).tolist())
            for _ in range(B)]
    root = topo.node_id("core0") if "core0" in topo.node_ids else 0
    cut = np.unique(topo.link_index[(topo.src == root) & (topo.link_index >= 0)])
    sets[0] = cut.tolist()  # the root cut off
    return np.full(B, root, np.int32), sets


@pytest.mark.parametrize("scale", [64, 8192])
def test_masked_distance_kernel_equals_plain(card, scale):
    """Kernel 15, set form and mask form, against its plain version: on a
    tiny WAN and at the backbone's shape (8,191 rows over V = 16,384)."""
    topo = csr.encode_link_state(_backbone(scale))
    rng = np.random.default_rng(scale)
    B = 8191 if scale == 8192 else 37
    roots, sets = _masked_rows(topo, B, rng)
    src, dst, w, ok, li, ovl = tables_from_numpy(
        [topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index, topo.overloaded], card
    )
    r, f = tables_from_numpy((roots, csr.link_failure_sets(sets)), card)
    reset_launch_counts()
    got = spf.batched_spf_distances_masked_sets(src, dst, w, ok, li, f, ovl, r)
    torch.cuda.synchronize()
    assert LAUNCHES["spf_distances_masked"] == 1
    want = spf.batched_spf_distances_masked_sets_plain(src, dst, w, ok, li, f, ovl, r)
    assert torch.equal(got, want)
    assert bool((got[0] >= BIG).sum() == got.shape[1] - 1)  # only the root reached
    n = min(B, 64)
    (mask,) = tables_from_numpy((csr.link_failure_batch(topo, sets[:n]),), card)
    got_m = spf.batched_spf_distances_masked(src, dst, w, ok, mask, ovl, r[:n])
    assert torch.equal(got_m, want[:n])


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("path", ["shared", "chunked", "global"])
def test_masked_frontier_kernel_on_every_path_equals_plain(card, path, threads, monkeypatch):
    """Kernel 15 (frontier relaxation), set form and mask form, on every
    path of its frontier state and at each thread count tried: rows from
    random roots, an overloaded root (it may transit) beside overloaded
    transit nodes, a root with every out-edge masked, a root in a
    component the others cannot reach."""
    ls = LinkState("0")
    edges = random_connected_edges(40, 30, seed=1) + [("x0", "x1", 3), ("x1", "x2", 1)]
    for db in build_adj_dbs(edges, overloaded=["node3", "node17"]).values():
        ls.update_adjacency_database(db)
    topo = csr.encode_link_state(ls)
    rng = np.random.default_rng(threads)
    B = 48
    roots, sets = _masked_rows(topo, B, rng, max_links=6)
    roots = rng.integers(0, topo.num_nodes, B).astype(np.int32)
    roots[0] = 0  # _masked_rows cut node 0 off in row 0
    roots[1], roots[2] = topo.node_id("node3"), topo.node_id("x0")
    sets[2] = []
    monkeypatch.setattr(spf, "MASKED_THREADS", threads)
    _frontier_path(path, monkeypatch)
    src, dst, w, ok, li, ovl = tables_from_numpy(
        [topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index, topo.overloaded], card
    )
    r, f = tables_from_numpy((roots, csr.link_failure_sets(sets)), card)
    reset_launch_counts()
    got = spf.batched_spf_distances_masked_sets(src, dst, w, ok, li, f, ovl, r)
    (mask,) = tables_from_numpy((csr.link_failure_batch(topo, sets),), card)
    got_m = spf.batched_spf_distances_masked(src, dst, w, ok, mask, ovl, r)
    torch.cuda.synchronize()
    assert LAUNCHES["spf_distances_masked"] == 2
    want = spf.batched_spf_distances_masked_sets_plain(src, dst, w, ok, li, f, ovl, r)
    assert torch.equal(got, want) and torch.equal(got_m, want)
    assert bool((got[0] >= BIG).sum() == got.shape[1] - 1)  # only the root reached
    assert int((got[2] < BIG).sum()) == 3  # x0's component


def test_backend_ksp2_on_card_equals_plain_and_scalar(card):
    """A KSP2 fabric world through CudaBackend on the card: kernels 1-3
    and 15, equal to the CPU path and the scalar solver."""
    from openr_tpu_torch.emulation.topology import fabric_edges
    from openr_tpu_torch.types import PrefixForwardingAlgorithm, PrefixForwardingType

    edges = fabric_edges(num_pods=3, rsws_per_pod=4, fsws_per_pod=2, num_ssws=4)
    nodes = sorted({n for e in edges for n in e[:2]})
    labels = {n: 100 + i for i, n in enumerate(nodes)}

    def mk():
        ls = LinkState("0", "rsw0_0")
        for db in build_adj_dbs(edges, node_labels=labels).values():
            ls.update_adjacency_database(db)
        return {"0": ls}

    ps = PrefixState()
    for i, n in enumerate(nodes):
        ps.update_prefix(n, "0", PrefixEntry(
            f"10.{i}.0.1/32", forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP,
            forwarding_type=PrefixForwardingType.SR_MPLS if i % 2 else PrefixForwardingType.IP,
        ))
    reset_launch_counts()
    got = CudaBackend(SpfSolver("rsw0_0"), device=card).build_route_db(mk(), ps)
    torch.cuda.synchronize()
    assert {n for n, c in LAUNCHES.items() if c} == {
        "dense_spf_distances", "dense_spf_nexthop_lanes", "multi_area_select_from_tables",
        "spf_distances_masked",
    }
    want = route_db_summary(SpfSolver("rsw0_0").build_route_db(mk(), ps))
    assert route_db_summary(got) == want
    cpu = CudaBackend(SpfSolver("rsw0_0"), device="cpu").build_route_db(mk(), ps)
    assert route_db_summary(cpu) == want


# -- the flagship batches: kernels 16 and 17 ---------------------------------


def _batched_world(n=96, extra=160, seed=7, **enc):
    from openr_tpu_torch.decision.link_state import LinkState as _LS

    ls = _LS("0")
    for db in build_adj_dbs(random_connected_edges(n, extra, seed=seed), overloaded=["node5"]).values():
        ls.update_adjacency_database(db)
    return csr.encode_link_state(ls, **enc)


def _batched_rows(topo, B, rng):
    n = topo.num_nodes
    roots = rng.integers(0, n, B).astype(np.int32)
    ovl = np.tile(topo.overloaded, (B, 1))
    ovl[:, :n] |= rng.random((B, n)) < 0.1
    soft = np.tile(topo.soft, (B, 1))
    soft[:, :n] += np.where(rng.random((B, n)) < 0.1, 60, 0).astype(np.int32)
    return roots, ovl, soft, rng.random((B, topo.padded_edges)) > 0.1


@pytest.mark.parametrize("form", ["mask", "sets", "distinct", "global"])
def test_batched_spf_kernel_equals_plain(card, form, monkeypatch):
    """Kernel 16 in each form (mask, failed-link set, per-row edge lists,
    and the global-state path) against its plain version."""
    topo = _batched_world()
    rng = np.random.default_rng(16)
    B = 67
    roots, ovl, _soft, mask = _batched_rows(topo, B, rng)
    D = max(topo.max_out_degree(), 1)
    if form == "global":
        monkeypatch.setattr(spf, "MAX_SHARED_BYTES", 0)
    edges = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok], card)
    r, o = tables_from_numpy([roots, ovl], card)
    reset_launch_counts()
    if form == "sets":
        failed = rng.integers(-1, len(topo.links), B).astype(np.int32)
        li, f = tables_from_numpy([topo.link_index, failed], card)
        got = spf.batched_spf_link_failures(*edges, li, f, o, r, D)
        want = spf.batched_spf_link_failures_plain(*edges, li, f, o, r, D)
    elif form == "distinct":
        rows = [_batched_world(40 + b, 60 + b, seed=b, node_bucket=256, edge_bucket=2048)
                for b in range(B)]
        stack = [np.stack(a) for a in zip(*([t.src, t.dst, t.w, t.edge_ok] for t in rows))]
        ovl_d = np.stack([t.overloaded for t in rows])
        roots_d = np.array([b % t.num_nodes for b, t in enumerate(rows)], np.int32)
        D = max(t.max_out_degree() for t in rows)
        args = tables_from_numpy(stack + [ovl_d, roots_d], card)
        got = spf.batched_spf_distinct(*args, D)
        want = spf.batched_spf_distinct_plain(*args, D)
    else:
        (m,) = tables_from_numpy([mask], card)
        got = spf.batched_spf(*edges, m, o, r, D)
        want = spf.batched_spf_plain(*edges, m, o, r, D)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_spf"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _batched_cands(topo, rng):
    ps = PrefixState()
    names = topo.id_to_node
    for i, node in enumerate(names):
        ps.update_prefix(node, "0", PrefixEntry(f"10.1.{i}.1/32"))
    from openr_tpu_torch.types import PrefixMetrics

    for k in range(32):
        for node in rng.choice(names, 4, replace=False):
            ps.update_prefix(str(node), "0", PrefixEntry(
                f"10.2.{k}.0/24", min_nexthop=2 if k % 8 == 0 else None,
                metrics=PrefixMetrics(drain_metric=int(rng.random() < 0.3),
                                      path_preference=int(rng.choice([100, 200])),
                                      source_preference=int(rng.choice([0, 50])),
                                      distance=int(rng.integers(0, 3))),
            ))
    c = csr.encode_prefix_candidates(ps, topo, "0", max_candidates=4)
    return [c.cand_node, c.cand_ok, c.drain_metric, c.path_pref, c.source_pref,
            c.distance, c.min_nexthop]


def test_batched_select_and_spf_and_select_kernels_equal_plain(card):
    """Kernel 17 on kernel 16's tables, and spf_and_select (16 then 17, no
    sync between) against the plain path, with per-row drains and roots
    (row 0 roots at an anycast advertiser: self-skip)."""
    topo = _batched_world()
    rng = np.random.default_rng(17)
    B = 300
    roots, ovl, soft, mask = _batched_rows(topo, B, rng)
    cand = _batched_cands(topo, rng)
    roots[0] = cand[0][-1, 0]
    D = max(topo.max_out_degree(), 1)
    edges = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok], card)
    m, o, s, r = tables_from_numpy([mask, ovl, soft, roots], card)
    ct = tables_from_numpy(cand, card)
    dist, nh = spf.batched_spf_plain(*edges, m, o, r, D)
    reset_launch_counts()
    got = rs.batched_select_routes(*ct, dist, nh, o, s, r)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_select_routes"] == 1
    want = rs.batched_select_routes_plain(*ct, dist, nh, o, s, r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(want[0].any()) and not bool(want[0].all())
    reset_launch_counts()
    got = rs.spf_and_select(*edges, m, o, s, r, *ct, max_degree=D)
    torch.cuda.synchronize()
    assert {k for k, v in LAUNCHES.items() if v} == {"batched_spf", "batched_select_routes"}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="candidates"):
        wide = [torch.cat([t] * 17, dim=1) for t in ct]
        rs.batched_select_routes(*wide, dist, nh, o, s, r)


def test_graft_entry_on_card_equals_cpu(card):
    from openr_tpu_torch import graft_entry

    forward, args = graft_entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    reset_launch_counts()
    got = forward(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_spf"] == 1 and LAUNCHES["batched_select_routes"] == 1
    cpu_forward, cpu_args = graft_entry.entry(device="cpu")
    for g, w in zip(got, cpu_forward(*cpu_args)):
        assert torch.equal(g.cpu(), w)


# -- kernels 2 and 14 as redesigned: lane words in shared memory (2), the
# frontier solve with a fill over the card (14), on every layout ------------


def _fan_areas(width=40):
    """me with ``width`` equal-cost first hops to two sinks and a tail, and
    a second area where me is absent-adjacent (A = 2)."""
    me = "me"
    edges = [(me, f"m{i}", 1) for i in range(width)]
    edges += [(f"m{i}", sink, 1) for i in range(width) for sink in ("s0", "s1")]
    edges += [("s0", "t0", 2), ("s1", "t0", 2), ("t0", "t1", 1)]
    areas = {}
    for a, e in (("1", edges), ("2", [("w0", "w1", 2), ("w1", "w2", 1)])):
        ls = LinkState(a, me)
        for db in build_adj_dbs(e, area=a, overloaded=["m3"] if a == "1" else []).values():
            ls.update_adjacency_database(db)
        areas[a] = ls
    return areas, me


def _lane_world(world):
    if world == "fan":
        return _fan_areas()
    if world == "hub":
        ls = LinkState("0", "hub")
        for db in build_adj_dbs([("hub", f"leaf{i}", 1) for i in range(300)]).values():
            ls.update_adjacency_database(db)
        return {"0": ls}, "hub"
    return _areas(world)


def _dense_lanes_path(path, V, K, D, monkeypatch):
    """Force a layout of kernel 2: the lane lists beside the state in
    shared memory (default), in the global scratch (a budget that holds
    the state alone), or the whole state there (a budget of 0)."""
    if path == "lists":
        T = spf.DENSE_LANES_THREADS
        monkeypatch.setattr(spf, "MAX_SHARED_BYTES", spf.dense_lanes_state_bytes(V, D, T) + 15)
    elif path == "global":
        monkeypatch.setattr(spf, "MAX_SHARED_BYTES", 0)
    want = {"shared": 0, "lists": 1, "global": 2}[path]
    assert spf.dense_lanes_layout(V, K, D, spf.DENSE_LANES_THREADS)[0] == want


@pytest.mark.parametrize("D", [0, 6, 33, 64])
@pytest.mark.parametrize("path", ["shared", "lists", "global"])
@pytest.mark.parametrize("world", ["grid", "multiarea_isolated", "fan"])
def test_dense_lanes_word_kernel_equals_plain(card, world, path, D, monkeypatch):
    """Kernel 2 (lane words in shared memory or the global scratch) against
    its plain version: an overloaded transit node and a soft drain (grid),
    A = 2 with vertices absent from an area (multiarea_isolated), 40 equal-
    cost first hops (fan: lanes 32-39 in a second word); D the degree
    bucket (0) or 6 (bytes, not whole words), 33 and 64 (two words)."""
    areas, me = _lane_world(world)
    enc = csr.encode_multi_area(areas, me)
    D = D or csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    planes = tables_from_numpy([getattr(enc, f) for f in FIELDS], card)
    in_src, in_w, in_ok, in_rank, in_has, ovl, roots = planes
    dist = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
    _dense_lanes_path(path, *in_src.shape[1:], D, monkeypatch)
    reset_launch_counts()
    got = spf.dense_spf_nexthop_lanes(*planes, dist, D)
    torch.cuda.synchronize()
    assert LAUNCHES["dense_spf_nexthop_lanes"] == 1
    want = spf.dense_spf_nexthop_lanes_plain(*planes, dist, D)
    assert torch.equal(got, want)
    assert bool((want == -128).any())  # padding vertices at least
    if world == "fan" and D > 32:
        assert int((want[0, :, 32:] == 1).sum()) > 0


@pytest.mark.parametrize("D", [0, 6, 20, 48])
@pytest.mark.parametrize("path", ["shared", "chunked", "lists", "global", "rounds"])
@pytest.mark.parametrize("world", ["grid", "multiarea_isolated", "fan", "hub"])
def test_segment_frontier_kernel_equals_plain(card, world, path, D, monkeypatch):
    """Kernel 14's frontier form (fill over the card, frontier solve,
    packed OR lanes) on every layout, and its round form, against its
    plain version, every vantage root a row (-1 where absent: A = 2,
    vertices absent from an area) and 40 rows of 1-3 failed links with -1
    pads; D the degree bucket (0) or 6, 20 and 48 (fill stores of 1, 4
    and 16 lanes; 48 > 32); the hub of 300 leaves at its bucket seeds 300
    lanes of one row."""
    monkeypatch.setattr(spf, "SEGMENT_ROUNDS_MAX_NODES", 1 << 30 if path == "rounds" else 0)
    areas, me = _lane_world(world)
    enc = csr.encode_multi_area(areas, me)
    D = D or csr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    seg = tables_from_numpy([getattr(enc, f) for f in SEGMENT], card)
    roots = _fleet_roots(enc)
    rng = np.random.default_rng(D)
    B, S = 40, 3
    fa = rng.integers(-1, enc.num_areas, (B, S)).astype(np.int32)
    fl = rng.integers(-1, max(len(t.links) for t in enc.topos), (B, S)).astype(np.int32)
    fa[0], fl[0] = -1, -1  # only pads
    link_index = np.stack([t.link_index for t in enc.topos])
    li, fa_t, fl_t = tables_from_numpy((link_index, fa, fl), card)
    r_all, r_sets = tables_from_numpy((roots, np.repeat(enc.roots[None], B, axis=0)), card)
    sets = dict(link_index=li, fail_area=fa_t, fail_link=fl_t)
    _frontier_path(path, monkeypatch)
    reset_launch_counts()
    got = spf.spf_segment_batch(*seg, r_all, D)
    got_s = spf.spf_segment_batch(*seg, r_sets, D, **sets)
    torch.cuda.synchronize()
    assert LAUNCHES["spf_segment_batch"] == 2
    want = spf.spf_segment_batch_plain(*seg, r_all, D)
    want_s = spf.spf_segment_batch_plain(*seg, r_sets, D, **sets)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got_s[0], want_s[0]) and torch.equal(got_s[1], want_s[1])
    if world == "multiarea_isolated":
        assert bool((r_all < 0).any()) and bool((want[1] == -128).any())
    if world == "hub" and D >= 300:
        hub = int(np.nonzero(roots[:, 0] == enc.roots[0])[0][0])
        assert int((got[1][hub, 0] == 1).sum()) == 300


# -- kernels 16 and 9 as redesigned: kernel 16's frontier form over a layout
# built on the card, kernel 9's work lists on thread block clusters --------


def _flagship_world(world):
    """A 300-node WAN (V = 512 > 256) with a drained node; "fan" adds 40
    leaves at metric 1 from node0, each also linked onwards, so rows rooted
    at node0 seed 40+ lanes (past one word)."""
    from openr_tpu_torch.decision.link_state import LinkState as _LS

    edges = random_connected_edges(300, 500, seed=11)
    if world == "fan":
        edges += [("node0", f"x{i}", 1) for i in range(40)]
        edges += [(f"x{i}", f"node{1 + (i * 7) % 299}", 3) for i in range(40)]
    ls = _LS("0")
    for db in build_adj_dbs(edges, overloaded=["node5"]).values():
        ls.update_adjacency_database(db)
    return csr.encode_link_state(ls)


@pytest.mark.parametrize("threads", [256, 512, 1024])
@pytest.mark.parametrize("path", ["shared", "chunked", "lists", "global"])
@pytest.mark.parametrize("world", ["wan", "fan"])
def test_batched_frontier_kernel_on_every_path_equals_plain(card, world, path, threads, monkeypatch):
    """Kernel 16's frontier form on a world of more than 256 vertices, per-row
    masks, drains and roots (half the rows at node0), in its mask and set
    forms, on every state layout (the frontier listed 4 at a time, the lane
    lists or the whole state in the global scratch) and thread count; the
    fan's node0 rows use more than 32 lanes (the table's OR loop), the
    WAN's fewer (bit words)."""
    topo = _flagship_world(world)
    assert topo.padded_nodes > 256
    monkeypatch.setattr(spf, "ROW_THREADS", threads)
    _frontier_path(path, monkeypatch)
    rng = np.random.default_rng(threads)
    B = 70
    roots, ovl, _soft, mask = _batched_rows(topo, B, rng)
    roots[::2] = topo.node_id("node0")
    D = max(topo.max_out_degree(), 1)
    edges = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok], card)
    r, o, m = tables_from_numpy([roots, ovl, mask], card)
    failed = rng.integers(-1, len(topo.links), B).astype(np.int32)
    li, f = tables_from_numpy([topo.link_index, failed], card)
    reset_launch_counts()
    got = spf.batched_spf(*edges, m, o, r, D)
    got_s = spf.batched_spf_link_failures(*edges, li, f, o, r, D)
    torch.cuda.synchronize()
    assert LAUNCHES["batched_spf"] == 2
    want = spf.batched_spf_plain(*edges, m, o, r, D)
    want_s = spf.batched_spf_link_failures_plain(*edges, li, f, o, r, D)
    for g, w in zip(got + got_s, want + want_s):
        assert torch.equal(g, w)
    wide = int((want_s[1][::2, :, 32:] == 1).sum()) if D > 32 else 0
    assert (wide > 0) == (world == "fan")


def _repair_batch(topo, plan, rng):
    """[B, 3] failure sets, word by word: all -1 pads (an empty word); the
    32 links of largest affected sets (a large union); then sets of 1-3
    links with -1 pads."""
    L = len(topo.links)
    sizes = np.array([sum(bin(int(x)).count("1") for x in row) for row in plan.aff_link_words])
    batch = np.full((128, 3), -1, np.int32)
    batch[32:64, 0] = np.argsort(-sizes, kind="stable")[:32]
    for i in range(64, 128):
        m = int(rng.integers(1, 4))
        batch[i, :m] = rng.choice(L, size=m, replace=False)
    return batch


@pytest.mark.parametrize("budget", ["shared", "global"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("threads", [256, 1024])
@pytest.mark.parametrize("world", ["wan", "grid"])
def test_repair_worklist_kernel_equals_plain(card, world, threads, cluster, budget, monkeypatch):
    """Kernel 9 over each word's affected list, on clusters of 1-8 blocks,
    its state in shared memory or (a budget of 0) the global scratch: an
    empty word, a word of the largest unions, sets with -1 pads; and the
    list's cold singles equal kernel 8's tables."""
    from openr_tpu_torch.ops import repair as rp
    from openr_tpu_torch.ops.whatif import LinkFailureSweep

    monkeypatch.setattr(rp, "REPAIR_THREADS", threads)
    monkeypatch.setattr(rp, "REPAIR_CLUSTER", cluster)
    if budget == "global":
        monkeypatch.setattr(rp, "REPAIR_SHARED_BYTES", 0)
    ls, _ps = _whatif_world(world)
    topo = csr.encode_link_state(ls)
    eng = LinkFailureSweep(topo, "node0", device=card)
    rs = eng.repair_sweep()
    assert rs.exact_base
    batch = _repair_batch(topo, rs.plan, np.random.default_rng(cluster))
    reset_launch_counts()
    kd, kn, _, _ = rs.solve(batch)
    torch.cuda.synchronize()
    assert LAUNCHES["repair_sweep"] == 1
    src, dst, w, lid = rs._edges
    fails_t = tables_from_numpy([batch], card)[0]
    args = (src, dst, w, lid, rs._tsok, fails_t, *rs._plan_t)
    qd, qn, _, _ = rp.repair_sweep_plain(*args, d_lanes=rs.plan.lanes, din=rs.plan.din)
    assert torch.equal(kd, qd) and torch.equal(kn, qn)
    # singles against the cold kernel
    fails = np.concatenate([_whatif_fails(topo, size=26), np.full(32, -1, np.int32)])
    fails = np.concatenate([fails, np.full(-len(fails) % 32, -1, np.int32)])
    kd, kn, _, _ = rs.solve(fails)
    edges = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok, topo.link_index], card)
    ovl, f = tables_from_numpy([topo.overloaded, fails], card)
    cd, cn, _, _ = spf.sweep_spf_link_failures(*edges, f, ovl, 0, eng.D)
    B = len(fails)
    bits = (kn[:, :, torch.arange(B, device=card) // 32] >> (torch.arange(B, device=card) % 32)) & 1
    assert torch.equal(kd, cd)
    assert torch.equal(bits.permute(0, 2, 1).to(torch.int8), (cn > 0).to(torch.int8))


@pytest.mark.parametrize("cluster", [1, 4])
def test_repair_kernel_warm_base_mode_lists_every_vertex(card, cluster, monkeypatch):
    """The warm base solve of a second generation (a link added, one
    cheapened, one raised; lanes seeded from the old plan, then from zero)
    runs kernel 9 with every vertex listed: its table equals the plain
    version's and the cold base, where the union of the (empty) plan's
    affected sets would leave the over-estimate."""
    from openr_tpu_torch.decision.link_state import LinkState as _LS
    from openr_tpu_torch.ops import repair as rp
    from openr_tpu_torch.ops.whatif import LinkFailureSweep

    monkeypatch.setattr(rp, "REPAIR_CLUSTER", cluster)
    edges = random_connected_edges(96, 160, seed=7)
    gen2 = [(u, v, m + 7 if i == 3 else max(1, m - 2) if i == 20 else m)
            for i, (u, v, m) in enumerate(edges)] + [("node10", "node90", 1)]

    def encode(e):
        ls = _LS("0", "node0")
        for db in build_adj_dbs(e).values():
            ls.update_adjacency_database(db)
        return csr.encode_link_state(ls)

    old = LinkFailureSweep(encode(edges), "node0", device=card)
    old.plan()
    topo2 = encode(gen2)
    calls = []
    real = rp.repair_sweep

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(rp, "repair_sweep", record)
    eng = LinkFailureSweep(topo2, "node0", device=card)
    assert eng.seed_base_from(old)
    reset_launch_counts()
    base = eng.base_solve()
    torch.cuda.synchronize()
    assert eng.base_source == "warm" and LAUNCHES["repair_sweep"] == 1
    (args, kw), = calls
    assert kw["exact_base"] is False
    cold = LinkFailureSweep(topo2, "node0", device=card).base_solve()
    assert np.array_equal(base[0], cold[0]) and np.array_equal(base[1], cold[1])
    plain_kw = {k: v for k, v in kw.items() if k != "exact_base"}
    for seed in ("plan", "zero"):
        a = list(args)
        if seed == "zero":
            a[8] = torch.zeros_like(a[8])
        launch, (kd, kn, _, _) = rp.repair_sweep_launcher(*a, **kw)
        launch()
        qd, qn, _, _ = rp.repair_sweep_plain(*a, **plain_kw)
        assert torch.equal(kd, qd) and torch.equal(kn, qn)
        assert np.array_equal(kd[:, 0].cpu().numpy(), cold[0])
        # the union-only mode keeps the over-estimate: a wrong table here
        launch, (ud, _un, _, _) = rp.repair_sweep_launcher(*a, **dict(kw, exact_base=True))
        launch()
        assert not torch.equal(ud, qd)


def test_spf_and_select_enqueues_without_a_host_sync(card):
    """The flagship step binds and enqueues kernels 16 and 17 with no host
    synchronization (the mask form's launcher derives its layout on the
    card): under the sync debug mode any synchronizing call raises."""
    topo = _batched_world()
    rng = np.random.default_rng(18)
    B = 64
    roots, ovl, soft, mask = _batched_rows(topo, B, rng)
    cand = _batched_cands(topo, rng)
    D = max(topo.max_out_degree(), 1)
    edges = tables_from_numpy([topo.src, topo.dst, topo.w, topo.edge_ok], card)
    m, o, s, r = tables_from_numpy([mask, ovl, soft, roots], card)
    ct = tables_from_numpy(cand, card)
    want = rs.spf_and_select(*edges, m, o, s, r, *ct, max_degree=D)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rs.spf_and_select(*edges, m, o, s, r, *ct, max_degree=D)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k for k, v in LAUNCHES.items() if v} == {"batched_spf", "batched_select_routes"}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _dense_world(world):
    """(areas, me) of kernel 1's worlds: the grid and multi-area worlds of
    ``_areas``; a 600-node WAN with an overloaded transit node and a leaf
    whose only neighbour is overloaded (no usable in-slot but its own
    root's); and a grid whose root itself is overloaded (it still
    transits)."""
    if world in ("grid", "multiarea_isolated"):
        return _areas(world)
    me = "node0"
    if world == "wan":
        edges = random_connected_edges(600, 1200, seed=5) + [("node7", "leaf", 3)]
        drains = dict(overloaded=["node7", "node40"])
    else:  # overloaded_root
        edges = grid_edges(9)
        drains = dict(overloaded=["node0", "node10"])
    ls = LinkState("0", me)
    for db in build_adj_dbs(edges, **drains).values():
        ls.update_adjacency_database(db)
    return {"0": ls}, me


@pytest.mark.parametrize("records", ["shared", "global"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("world", ["grid", "multiarea_isolated", "wan", "overloaded_root"])
def test_dense_packed_kernel_on_every_path_equals_plain(card, world, cluster, records, monkeypatch):
    """Kernel 1 as redesigned, on clusters of 1, 2, 4 and 8 blocks an
    area, its packed records in shared memory or (a budget of 0) the global
    scratch, against its plain version."""
    areas, me = _dense_world(world)
    enc = csr.encode_multi_area(areas, me)
    in_src, in_w, in_ok, _rank, _has, ovl, roots = tables_from_numpy(
        [getattr(enc, f) for f in FIELDS], card)
    monkeypatch.setattr(spf, "DENSE_CLUSTER", cluster)
    if records == "global":
        monkeypatch.setattr(spf, "MAX_SHARED_BYTES", 0)
    A, V, K = in_src.shape
    _S, cap, scratch = spf.dense_distances_layout(A, V, K, cluster)
    assert (cap == 0 and scratch > 0) == (records == "global")
    reset_launch_counts()
    got = spf.dense_spf_distances(in_src, in_w, in_ok, ovl, roots)
    torch.cuda.synchronize()
    assert LAUNCHES["dense_spf_distances"] == 1
    want = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sweeps", [1, 3])
@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("world", ["grid", "wan"])
def test_dense_packed_kernel_with_rounds_between_votes_equals_plain(card, world, cluster, sweeps,
                                                                     monkeypatch):
    """Kernel 1 with 1 and 3 relaxation rounds between two votes (with 3,
    the threads of a block, and the blocks of a cluster, do not wait for
    each other between them) against its plain version."""
    areas, me = _dense_world(world)
    enc = csr.encode_multi_area(areas, me)
    in_src, in_w, in_ok, _rank, _has, ovl, roots = tables_from_numpy(
        [getattr(enc, f) for f in FIELDS], card)
    monkeypatch.setattr(spf, "DENSE_CLUSTER", cluster)
    monkeypatch.setattr(spf, "DENSE_SWEEPS", sweeps)
    got = spf.dense_spf_distances(in_src, in_w, in_ok, ovl, roots)
    want = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cluster", [None, 1, 2])
def test_dense_packed_kernel_at_the_backbone_shape_equals_plain(card, cluster, monkeypatch):
    """Kernel 1 at the KSP2 backbone's cold planes (V = 16,384, K = 32, 4 %
    of the slots usable): the rule's cluster of 8, whose blocks' records
    fit shared memory once packed, and clusters of 1 and 2 (records in
    the global scratch, or packed into shared memory), against its plain
    version."""
    enc = csr.encode_multi_area({"0": _backbone()}, "core0")
    in_src, in_w, in_ok, _rank, _has, ovl, roots = tables_from_numpy(
        [getattr(enc, f) for f in FIELDS], card)
    A, V, K = in_src.shape
    assert (V, K) == (16384, 32)
    if cluster is None:
        assert spf.dense_cluster_size(V, K) == 8
    monkeypatch.setattr(spf, "DENSE_CLUSTER", cluster)
    reset_launch_counts()
    got = spf.dense_spf_distances(in_src, in_w, in_ok, ovl, roots)
    torch.cuda.synchronize()
    assert LAUNCHES["dense_spf_distances"] == 1
    want = spf.dense_spf_distances_plain(in_src, in_w, in_ok, ovl, roots)
    assert torch.equal(got, want)


#: (D, C, A, P) of kernel 13's tile cases: lane widths 1-33 (vector widths
#: 1, 4 and 16, and a tail byte), 1-64 candidates, 1, 3 and 63 areas
TILE_CASES = [(1, 1, 1, 300), (4, 4, 3, 517), (17, 64, 1, 200), (32, 4, 1, 1000),
              (33, 4, 3, 301), (8, 4, 63, 90)]


@pytest.mark.parametrize("tile", [None, 7])
@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("per_area", [False, True])
@pytest.mark.parametrize("case", TILE_CASES, ids=[f"D{d}-C{c}-A{a}" for d, c, a, _p in TILE_CASES])
def test_fleet_select_tile_kernel_equals_plain(card, case, per_area, diff, tile, monkeypatch):
    """Kernel 13 as redesigned (a block per tile of prefix rows) against its
    plain version: lane widths 1-33, 1-64 candidates, 1-63 areas, the
    rule's tile and tiles of 7 rows (a tail tile), winner rows holding the
    -128 fill, the diff against a perturbed previous generation."""
    D, C, A, P = case
    B = 4
    rows = [_select_inputs(seed, A=A, V=40, D=D, P=P, C=C) for seed in range(B)]
    dist = np.stack([r[0] for r in rows])
    nh = np.stack([r[1] for r in rows])
    args = tables_from_numpy((dist, nh, *rows[0][2:]), card)
    monkeypatch.setattr(rs, "SELECT_TILE_ROWS", tile)
    kw = {}
    if diff:
        base = rs.fleet_select_plain(*args, per_area)
        prev = [t.clone() for t in base]
        prev[2][1, P - 1, A - 1, D - 1] = ~prev[2][1, P - 1, A - 1, D - 1]
        prev[3][3, 0, 0] = ~prev[3][3, 0, 0]
        kw = dict(zip(("prev_use", "prev_shortest", "prev_lanes", "prev_valid"), prev))
    reset_launch_counts()
    got = rs.fleet_select(*args, per_area, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["fleet_select"] == 1
    want = rs.fleet_select_plain(*args, per_area, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if diff:
        assert got[4].tolist() == [False, True, False, True]
    assert bool(want[3].any()) and bool((args[1] == -128).any())


def test_fleet_select_tile_kernel_on_unaligned_lanes_equals_plain(card):
    """Kernel 13 where the lane table starts off a 16-byte boundary (a view
    one byte into its storage): the kernel drops to a byte a thread."""
    rows = [_select_inputs(seed, A=1, V=40, D=32, P=400, C=4) for seed in range(3)]
    dist = np.stack([r[0] for r in rows])
    nh = np.stack([r[1] for r in rows])
    args = tables_from_numpy((dist, nh, *rows[0][2:]), card)
    flat = torch.empty(args[1].numel() + 1, dtype=torch.int8, device=card)
    shifted = flat[1:].view(args[1].shape)
    shifted.copy_(args[1])
    args = (args[0], shifted, *args[2:])
    got = rs.fleet_select(*args, False)
    want = rs.fleet_select_plain(*args, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _star_planes(V, dev):
    """Dense planes of one area: every node's one in-slot from node 0."""
    return (torch.zeros((1, V, 1), dtype=torch.int32, device=dev),
            torch.ones((1, V, 1), dtype=torch.float32, device=dev),
            torch.ones((1, V, 1), dtype=torch.bool, device=dev),
            torch.zeros((1, V), dtype=torch.bool, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))


def test_dense_packed_kernel_at_its_node_limit_and_past_it(card, monkeypatch):
    """Kernel 1 at ``DENSE_MAX_NODES`` (the rule's cluster of 8) equals its
    plain version; one node more is refused by the launcher, and a forced
    cluster whose blocks' fixed state passes shared memory by the C
    entry."""
    planes = _star_planes(spf.DENSE_MAX_NODES, card)
    got = spf.dense_spf_distances(*planes)
    assert torch.equal(got, spf.dense_spf_distances_plain(*planes))
    with pytest.raises(ValueError):
        spf.dense_spf_distances(*_star_planes(spf.DENSE_MAX_NODES + 1, card))
    monkeypatch.setattr(spf, "DENSE_CLUSTER", 1)
    with pytest.raises(RuntimeError):
        spf.dense_spf_distances(*_star_planes(30000, card))


def test_fleet_select_tile_kernel_refuses_a_tile_past_shared_memory(card, monkeypatch):
    """Kernel 13 over 63 areas: a tile of 256 rows (191 KB of winner masks
    and lane flags) equals its plain version; the C entry refuses one of
    512 (391 KB)."""
    rows = [_select_inputs(seed, A=63, V=40, D=8, P=600, C=4) for seed in range(2)]
    dist = np.stack([r[0] for r in rows])
    nh = np.stack([r[1] for r in rows])
    args = tables_from_numpy((dist, nh, *rows[0][2:]), card)
    monkeypatch.setattr(rs, "SELECT_TILE_ROWS", 256)
    got = rs.fleet_select(*args, False)
    want = rs.fleet_select_plain(*args, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    monkeypatch.setattr(rs, "SELECT_TILE_ROWS", 512)
    with pytest.raises(RuntimeError):
        rs.fleet_select(*args, False)


# -- the admission path on the card ---------------------------------------


def _admission_world():
    areas, me = _areas("multiarea_isolated")
    ps = PrefixState()
    for i in range(30):
        ps.update_prefix(f"a{i}", "1", PrefixEntry(f"10.1.{i}.0/24"))
    for i in range(20):
        ps.update_prefix(f"b{i}", "2", PrefixEntry(f"10.2.{i}.0/24"))
    return areas, ps, me


def _launched(build):
    reset_launch_counts()
    out = build()
    torch.cuda.synchronize()
    return out, {name for name, n in LAUNCHES.items() if n}


def test_admission_steps_on_card(card, monkeypatch):
    """Under a governor on a SimClock: (a) a cold build on kernels 1-3,
    shadow-verified clean; (b) injected corruption on the same kernels,
    found and quarantined, the scalar RouteDb served; (c) a quarantined
    build, no launch; (d) healed, past the hold, a probe on the cold
    kernels restores; (e) a ``KernelError`` from kernel 3's launcher, and
    the launcher's own ``TypeError`` refusing a tensor of the wrong dtype,
    each propagate with every counter and the breaker as they were, and
    the next build launches kernel 3 again.  Every RouteDb equals the
    scalar solver's."""
    from openr_tpu_torch.common.runtime import SimClock
    from openr_tpu_torch.config import ResilienceConfig
    from openr_tpu_torch.kernels.build import KernelError

    areas, ps, me = _admission_world()
    want = route_db_summary(SpfSolver(me).build_route_db(areas, ps))
    cold = {"dense_spf_distances", "dense_spf_nexthop_lanes", "multi_area_select_from_tables"}
    clock = SimClock()
    backend = CudaBackend(SpfSolver(me), device=card, clock=clock, resilience=ResilienceConfig(
        shadow_sample_every=8, failure_threshold=2, jitter_pct=0.0))
    gov = backend.governor
    db, launched = _launched(lambda: backend.build_route_db(areas, ps))  # (a)
    assert launched == cold and route_db_summary(db) == want
    assert gov.num_shadow_checks == 1 and gov.num_shadow_mismatches == 0
    backend.inject_silent_corruption(True)  # (b)
    db, launched = _launched(lambda: backend.build_route_db(areas, ps, force_full=True))
    assert launched == cold and route_db_summary(db) == want
    assert gov.num_shadow_mismatches == 1 and backend.device_failed
    db, launched = _launched(lambda: backend.build_route_db(areas, ps))  # (c)
    assert launched == set() and route_db_summary(db) == want
    assert backend.num_fallback_injected == 1 and backend.num_scalar_builds == 1
    backend.inject_silent_corruption(False)  # (d)
    clock._now += gov.breaker.current_hold_s() + 0.5
    db, launched = _launched(lambda: backend.build_route_db(areas, ps, force_full=True))
    assert launched == cold and route_db_summary(db) == want
    assert not backend.device_failed and gov.num_restores == 1

    real = rs.multi_area_select_from_tables_launcher

    def refuse(*args):  # (e)
        raise KernelError("multi_area_select_from_tables: injected launch failure")

    def wrong_dtype(*args):  # soft as int64: check_tensor refuses it
        return real(*args[:3], args[3].long(), *args[4:])

    for launcher, error in ((refuse, KernelError), (wrong_dtype, TypeError)):
        before = (backend.counter_snapshot(), gov.breaker.status())
        with monkeypatch.context() as m:
            m.setattr(rs, "multi_area_select_from_tables_launcher", launcher)
            with pytest.raises(error):
                backend.build_route_db(areas, ps, force_full=True)
        assert (backend.counter_snapshot(), gov.breaker.status()) == before
        assert not backend.device_failed
    db, launched = _launched(lambda: backend.build_route_db(areas, ps, force_full=True))
    assert launched == {"multi_area_select_from_tables"} and route_db_summary(db) == want
