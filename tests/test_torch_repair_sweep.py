"""The port's what-if repair (``ops/repair.py``: the planner, the plain
version of kernel 9 and ``RepairSweep``; ``ops/whatif.py``
``LinkFailureSweep``) against the JAX package, exactly.

* the planner field by field (``build_repair_plan``, the pull tables, the
  plan cache, ``warm_base_from_previous``, ``sort_by_depth``) from the
  same base solve;
* kernel 9's plain version driven by the REFERENCE planner's own plan
  (through ``interop.repair_plan_from_fields``) against the reference's
  ``RepairSweep.solve`` on the same failures: dist and every packed lane
  word — on 48-node WANs, a 6x6 grid over all links, overloaded nodes,
  disconnecting failures and sets of 2 and 3 links, where the lanes move
  from their warm seed (root-adjacent on-DAG links included);
* the repair's tables against the port's cold sweep of the same failures;
* ``LinkFailureSweep.run`` / ``run_sets`` and the warm base of a second
  generation against the reference engine.

Tolerance: exact equality (unique fixed points, integral metrics).
"""

import dataclasses

import numpy as np
import pytest
import torch

from openr_tpu.decision.link_state import LinkState
from openr_tpu.emulation import topology as jtopo
from openr_tpu.ops import repair as jrepair
from openr_tpu.ops.csr import encode_link_state
from openr_tpu.ops.whatif import LinkFailureSweep as RefSweep
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision.link_state import LinkState as PortLinkState
from openr_tpu_torch.interop import repair_plan_from_fields
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import repair as trepair
from openr_tpu_torch.ops import spf as tspf
from openr_tpu_torch.ops.whatif import LinkFailureSweep

EDGE_FIELDS = ("src", "dst", "w", "edge_ok", "link_index", "overloaded")


def encode_both(edges, **drains):
    ref, port = LinkState("0"), PortLinkState("0")
    for db in jtopo.build_adj_dbs(edges, **drains).values():
        ref.update_adjacency_database(db)
        port.update_adjacency_database(ttypes.AdjacencyDatabase.from_wire(db.to_wire()))
    rt, pt = encode_link_state(ref), tcsr.encode_link_state(port)
    for f in EDGE_FIELDS:
        assert np.array_equal(getattr(rt, f), getattr(pt, f)), f
    return rt, pt


WORLDS = {
    "wan11": lambda: encode_both(jtopo.random_connected_edges(48, 64, seed=11)),
    "wan12": lambda: encode_both(jtopo.random_connected_edges(48, 64, seed=12)),
    "wan13": lambda: encode_both(jtopo.random_connected_edges(48, 64, seed=13)),
    "grid6": lambda: encode_both(jtopo.grid_edges(6)),
    "overloaded": lambda: encode_both(
        jtopo.random_connected_edges(48, 64, seed=5), overloaded=["node7", "node9"]
    ),
    "line": lambda: encode_both(jtopo.line_edges(8)),
}


def assert_plans_equal(ref, port):
    for f in dataclasses.fields(trepair.RepairPlan):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def engines(world):
    rt, pt = WORLDS[world]()
    ref = RefSweep(rt, "node0")
    port = LinkFailureSweep(pt, "node0", device="cpu")
    return rt, pt, ref, port


def link_failures(topo, world):
    """Every link on the grid; elsewhere the root's links, then every link,
    then seeded random draws with -1 (unperturbed) entries."""
    L = len(topo.links)
    rng = np.random.default_rng(len(world))
    root_links = sorted({int(topo.link_index[e]) for e in np.nonzero(topo.src == 0)[0]})
    fails = np.concatenate([root_links, np.arange(L), rng.integers(-1, L, size=40)])
    B = ((len(fails) + 31) // 32) * 32
    out = np.full(B, -1, np.int32)
    out[: len(fails)] = fails
    return out


def failure_sets(topo, k, seed):
    L = len(topo.links)
    rng = np.random.default_rng(seed)
    sets = np.full((64, k), -1, np.int32)
    for i in range(64):
        m = int(rng.integers(1, k + 1))
        sets[i, :m] = rng.choice(L, size=m, replace=False)
    return sets


def port_plain(plan, topo, fails):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    words = lambda a: t(a.view(np.int32))  # noqa: E731
    if fails.ndim == 1:
        fails = fails[:, None]
    return trepair.repair_sweep_plain(
        t(topo.src), t(topo.dst), t(topo.w), t(topo.link_index),
        t(plan.transit_src_ok), t(fails), words(plan.aff_link_words),
        t(plan.base_dist), t(plan.base_nh), t(plan.nbr_flat), t(plan.pull_perm),
        t(plan.pull_valid), t(plan.nbr_is_root), t(plan.seed_v), t(plan.seed_r),
        t(plan.seed_slot), d_lanes=plan.lanes, din=plan.din,
    )


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_planner_matches_reference(world):
    rt, pt, ref, port = engines(world)
    rb, pb = ref.base_solve(), port.base_solve()
    assert np.array_equal(rb[0], pb[0]) and np.array_equal(rb[1], pb[1])
    assert port.base_source == "device"
    rplan = jrepair.build_repair_plan(rt, 0, *rb)
    pplan = trepair.build_repair_plan(pt, 0, *pb)
    assert_plans_equal(rplan, pplan)
    assert_plans_equal(rplan, port.plan())
    lanes, tables = trepair.build_pull_tables(pt, 0)
    rlanes, rtables = jrepair.build_pull_tables(rt, 0)
    assert lanes == rlanes
    for k in rtables:
        assert np.array_equal(np.asarray(rtables[k]), np.asarray(tables[k])), k
    assert trepair.topology_content_hash(pt, 0) == jrepair.topology_content_hash(rt, 0)
    fails = link_failures(rt, world)
    rs, order = jrepair.sort_by_depth(rplan, fails)
    ps, porder = trepair.sort_by_depth(pplan, fails)
    assert np.array_equal(rs, ps) and np.array_equal(order, porder)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_repair_plain_driven_by_reference_plan(world):
    rt, pt, ref, _ = engines(world)
    rplan = ref.plan()
    plan = repair_plan_from_fields(vars(rplan))
    assert_plans_equal(rplan, plan)
    fails = link_failures(rt, world)
    want_d, want_n, _, _ = jrepair.RepairSweep(rt, rplan).solve(fails)
    dist, nh, rounds_d, rounds_l = port_plain(plan, pt, fails)
    assert np.array_equal(dist.numpy(), np.asarray(want_d))
    assert np.array_equal(nh.numpy().view(np.uint32), np.asarray(want_n))
    assert rounds_d >= 1 and rounds_l >= 1
    # the lanes really moved from the warm seed: the affected vertices
    # start from nothing but the root's seeds
    aff, _d0, _en = trepair.repair_sweep_init(
        torch.from_numpy(pt.link_index), torch.from_numpy(fails[:, None]),
        torch.from_numpy(plan.aff_link_words.view(np.int32)),
        torch.from_numpy(plan.base_dist), pt.padded_nodes,
    )
    bits = ((nh[:, :, torch.arange(len(fails)) // 32] >> (torch.arange(len(fails)) % 32)) & 1)
    on_affected = int((bits.permute(0, 2, 1) & aff[:, :, None].to(torch.int32)).sum())
    if world == "line":  # every failure cuts the line: affected = cut off
        assert on_affected == 0 and bool((dist[aff] >= 3.0e38).all())
    else:
        assert on_affected > 0


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("world", ["wan11", "grid6", "line"])
def test_repair_plain_sets_driven_by_reference_plan(world, k):
    rt, pt, ref, _ = engines(world)
    rplan = ref.plan()
    sets = failure_sets(rt, k, seed=k)
    want_d, want_n, _, _ = jrepair.RepairSweep(rt, rplan).solve(sets)
    dist, nh, _, _ = port_plain(repair_plan_from_fields(vars(rplan)), pt, sets)
    assert np.array_equal(dist.numpy(), np.asarray(want_d))
    assert np.array_equal(nh.numpy().view(np.uint32), np.asarray(want_n))
    if world == "line":  # sets cut the line: vertices leave the graph
        assert (dist.numpy() >= 3.0e38).any()


@pytest.mark.parametrize("world", ["wan11", "grid6", "overloaded", "line"])
def test_repair_equals_cold_sweep(world):
    _, pt, _, port = engines(world)
    fails = link_failures(pt, world)
    dist, nh, _, _ = port.repair_sweep().solve(fails)
    t = [torch.from_numpy(np.ascontiguousarray(getattr(pt, f))) for f in EDGE_FIELDS]
    cd, cn, _, _ = tspf.sweep_spf_link_failures(
        *t[:5], torch.from_numpy(fails), t[5], 0, port.D
    )
    assert torch.equal(dist, cd)
    bits = (nh[:, :, torch.arange(len(fails)) // 32] >> (torch.arange(len(fails)) % 32)) & 1
    assert torch.equal(bits.permute(0, 2, 1).to(torch.int8), (cn > 0).to(torch.int8))


@pytest.mark.parametrize("world", ["wan12", "grid6", "line"])
def test_sweep_engine_matches_reference(world):
    rt, _, ref, port = engines(world)
    fails = link_failures(rt, world)[:-5]
    r, p = ref.run(fails), port.run(fails)
    assert np.array_equal(r.snap_row, p.snap_row)
    assert r.num_device_solves == p.num_device_solves
    assert np.array_equal(r.dist, p.dist) and np.array_equal(r.nh, p.nh)
    assert np.array_equal(ref.on_dag_links(), port.on_dag_links())
    sets = [tuple(s[s >= 0]) for s in failure_sets(rt, 3, seed=9)] + [(), (0, 0)]
    r, p = ref.run_sets(sets), port.run_sets(sets)
    assert np.array_equal(r.snap_row, p.snap_row)
    assert np.array_equal(r.dist, p.dist) and np.array_equal(r.nh, p.nh)


def test_multi_chunk_sweep_matches_one_chunk():
    rt, pt, ref, port = engines("wan11")
    small = LinkFailureSweep(pt, "node0", max_chunk=32, device="cpu")
    fails = link_failures(rt, "wan11")
    a, b = port.run(fails), small.run(fails)
    assert len(small._chunk_sizes(a.num_device_solves)) > 1
    assert np.array_equal(a.dist, b.dist) and np.array_equal(a.nh, b.nh)
    assert small._chunk_sizes(0) == [] and small._chunk_sizes(33) == [32, 32]
    assert port._chunk_sizes(4097) == [4096, 32]


def test_batch_must_be_multiple_of_32():
    _, _, _, port = engines("wan11")
    with pytest.raises(ValueError):
        port.repair_sweep().solve(np.zeros(33, np.int32))


def second_generation(edges):
    """The same LSDB with one on-tree link's metric raised (a removal the
    warm seed must reset below) and one lowered."""
    bumped = [(u, v, (m + 7 if i == 3 else max(1, m - 1) if i == 20 else m))
              for i, (u, v, m) in enumerate(edges)]
    return encode_both(bumped)


def test_warm_base_from_previous_matches_reference():
    edges = jtopo.random_connected_edges(48, 64, seed=21)
    rt, pt = encode_both(edges)
    rt2, pt2 = second_generation(edges)
    ref, port = RefSweep(rt, "node0"), LinkFailureSweep(pt, "node0", device="cpu")
    want = jrepair.warm_base_from_previous(rt2, 0, rt, ref.plan())
    got = trepair.warm_base_from_previous(pt2, 0, pt, port.plan())
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1]) and want[2] == got[2]
    assert (got[0] >= 3.0e38).any()  # the bump reset vertices

    ref2, port2 = RefSweep(rt2, "node0"), LinkFailureSweep(pt2, "node0", device="cpu")
    assert ref2.seed_base_from(ref) and port2.seed_base_from(port)
    rb, pb = ref2.base_solve(), port2.base_solve()
    assert port2.base_source == "warm" and ref2.base_source == "warm"
    assert np.array_equal(rb[0], pb[0]) and np.array_equal(rb[1], pb[1])
    cold = LinkFailureSweep(pt2, "node0", device="cpu").base_solve()
    assert np.array_equal(cold[0], pb[0]) and np.array_equal(cold[1], pb[1])
    fails = link_failures(rt2, "warm")
    r, p = ref2.run(fails), port2.run(fails)
    assert np.array_equal(r.dist, p.dist) and np.array_equal(r.nh, p.nh)


def test_plan_cache_hits_evicts_and_reports():
    cache = trepair.PlanCache()
    _, pt, _, port = engines("grid6")
    base = port.base_solve()
    a = cache.plan(pt, 0, *base)
    assert cache.plan(pt, 0, *base) is a
    assert (cache.hits, cache.misses) == (1, 1)
    assert cache.set_cap(1) == 1
    cache.plan(pt, 1, *base)
    g = cache.gauges()
    assert g["plan_cache.size"] == 1.0 and g["plan_cache.evictions"] == 1.0
    assert cache.set_cap(0) == trepair.PlanCache.DEFAULT_CAP
