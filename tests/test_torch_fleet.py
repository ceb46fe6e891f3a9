"""The port's ``FleetRibEngine`` (``decision/fleet.py``, on the CPU through
the plain kernel versions) against the JAX package's engine and the
scalar oracle.

The worlds are those of ``tests/test_fleet.py`` (the 4x4 grid with a soft
drain, an overloaded node and anycast; its two-area world where most
roots are absent from one area; the v4 gate; the min-nexthop gate over
the winners only; KSP2 ineligibility; cache invalidation) and of
``tests/test_stream_delta.py:429-470`` (the generation delta, and its
decline on a membership change; no device pool).  Each LSDB is held by
both packages: the port's copy is carried across as wire dicts and every
later change is applied to both.  Tolerance: ``route_db_summary``
equality of every RouteDb and exact equality of the summaries and path
counters.
"""

import dataclasses

import pytest

from openr_tpu.decision.fleet import FleetRibEngine as RefFleet
from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.prefix_state import PrefixState
from openr_tpu.decision.rib import route_db_summary as ref_summary
from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.emulation.topology import build_adj_dbs, grid_edges, ring_edges
from openr_tpu.types import (
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixMetrics,
    RouteComputationRules,
)
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision import fleet as tfleet
from openr_tpu_torch.decision.link_state import LinkState as PortLinkState
from openr_tpu_torch.decision.prefix_state import PrefixState as PortPrefixState
from openr_tpu_torch.decision.rib import route_db_summary as port_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from openr_tpu_torch.emulation import topology as ttopo


class Twin:
    """One multi-area LSDB and PrefixState held by both packages."""

    def __init__(self, area_edges, me="", adj_kw=None):
        self.me = me
        adj_kw = adj_kw or {}
        self.dbs = {a: build_adj_dbs(edges, area=a, **adj_kw.get(a, {}))
                    for a, edges in area_edges.items()}
        self.ref_ls = {a: LinkState(a, me) for a in area_edges}
        self.port_ls = {a: PortLinkState(a, me) for a in area_edges}
        for area, dbs in self.dbs.items():
            for db in dbs.values():
                self._apply(area, db)
        self.ref_ps, self.port_ps = PrefixState(), PortPrefixState()
        self.seq = 1

    def _apply(self, area, db):
        self.ref_ls[area].update_adjacency_database(db)
        self.port_ls[area].update_adjacency_database(
            ttypes.AdjacencyDatabase.from_wire(db.to_wire())
        )

    def advertise(self, node, area, entry):
        self.ref_ps.update_prefix(node, area, entry)
        self.port_ps.update_prefix(node, area, ttypes.PrefixEntry.from_wire(entry.to_wire()))
        self.seq += 1

    def set_node_metrics(self, area, node, metric):
        db = self.dbs[area][node]
        db = dataclasses.replace(
            db, adjacencies=[dataclasses.replace(a, metric=metric) for a in db.adjacencies]
        )
        self.dbs[area][node] = db
        self._apply(area, db)
        self.seq += 1

    def ref(self):
        return self.ref_ls, self.ref_ps, self.seq

    def port(self):
        return self.port_ls, self.port_ps, self.seq


def grid_twin(**kw):
    """tests/test_fleet.py:29 build_world."""
    t = Twin({"0": grid_edges(4)}, adj_kw={"0": kw})
    for i in range(16):
        t.advertise(f"node{i}", "0", PrefixEntry(f"10.{i}.0.0/24"))
    for node in ("node3", "node12"):
        t.advertise(node, "0", PrefixEntry(
            "10.100.0.0/24", metrics=PrefixMetrics(path_preference=1000)))
    t.advertise("node7", "0", PrefixEntry("2001:db8::/64"))
    return t


def two_area_twin():
    """tests/test_fleet.py:164: nine grid nodes, a six-ring, node0 in both."""
    t = Twin({
        "1": grid_edges(3),
        "2": ring_edges(6, prefix="b") + [("b0", "node0", 1)],
    })
    for node, area, p in (("node8", "1", "10.0.0.0/24"), ("b3", "2", "10.1.0.0/24"),
                          ("b4", "2", "10.2.0.0/24"), ("node2", "1", "10.77.0.0/24"),
                          ("b2", "2", "10.77.0.0/24")):
        t.advertise(node, area, PrefixEntry(p))
    return t


def delta_twin(side=6):
    """tests/test_stream_delta.py:22 make_world: a grid, a /24 per node."""
    t = Twin({"0": grid_edges(side)})
    for i in range(side * side):
        t.advertise(f"node{i}", "0", PrefixEntry(f"10.{(i >> 8) & 255}.{i & 255}.0/24"))
    return t


def engines(t, **solver_kw):
    port_kw = dict(solver_kw)
    if "route_selection_algorithm" in port_kw:
        port_kw["route_selection_algorithm"] = ttypes.RouteComputationRules(
            int(port_kw["route_selection_algorithm"])
        )
    return (RefFleet(SpfSolver("node0", **solver_kw)),
            tfleet.FleetRibEngine(PortSolver("node0", **port_kw), device="cpu"))


def assert_every_root(t, ref, port, oracle_kw=None):
    """Every vantage decodes to the reference engine's RouteDb and the
    scalar oracle's; the summaries are equal and match the RouteDbs."""
    summary = port.fleet_summary(*t.port())
    assert summary == ref.fleet_summary(*t.ref())
    for name in sorted(summary):
        got = port_summary(port.compute_for_node(name, *t.port()))
        assert got == ref_summary(ref.compute_for_node(name, *t.ref())), name
        oracle = SpfSolver(name, **(oracle_kw or {})).build_route_db(t.ref_ls, t.ref_ps)
        assert got == ref_summary(oracle), name
        assert summary[name]["num_routes"] == len(oracle.unicast_routes), name
    return summary


ALGOS = {
    "shortest": {},
    "per_area": {"route_selection_algorithm": RouteComputationRules.PER_AREA_SHORTEST_DISTANCE},
}


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_grid_every_root_matches_reference_and_scalar(algo):
    kw = ALGOS[algo]
    t = grid_twin(soft_drained={"node10": 60}, overloaded=["node5"])
    ref, port = engines(t, **kw)
    assert port.eligible(*t.port())
    assert len(assert_every_root(t, ref, port, kw)) == 16
    assert port.num_batched_solves == 1 and port.num_decodes == 16


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_two_area_every_vantage(algo):
    kw = ALGOS[algo]
    t = two_area_twin()
    ref, port = engines(t, **kw)
    assert len(assert_every_root(t, ref, port, kw)) == 15  # node0 in both areas
    assert port.num_batched_solves == 1


def test_cache_invalidation_on_change_seq():
    t = grid_twin()
    _ref, port = engines(t)
    port.compute_for_node("node1", *t.port())
    port.compute_for_node("node2", *t.port())
    assert port.num_batched_solves == 1  # cached
    t.advertise("node9", "0", PrefixEntry("10.200.0.0/24"))
    db = port.compute_for_node("node1", *t.port())
    assert port.num_batched_solves == 2
    assert "10.200.0.0/24" in db.unicast_routes
    oracle = SpfSolver("node1").build_route_db(t.ref_ls, t.ref_ps)
    assert port_summary(db) == ref_summary(oracle)
    assert port.compute_for_node("nobody", *t.port()) is None


def test_ineligible_on_ksp2():
    t = grid_twin()
    t.advertise("node2", "0", PrefixEntry(
        "10.250.0.0/24", forwarding_algorithm=PrefixForwardingAlgorithm.KSP2_ED_ECMP))
    ref, port = engines(t)
    assert not port.eligible(*t.port())
    assert not ref.eligible(*t.ref())


def test_summary_applies_v4_gate():
    t = grid_twin()
    ref = RefFleet(SpfSolver("node0", enable_v4=False, v4_over_v6_nexthop=False))
    port = tfleet.FleetRibEngine(
        PortSolver("node0", enable_v4=False, v4_over_v6_nexthop=False), device="cpu")
    summary = port.fleet_summary(*t.port())
    assert summary == ref.fleet_summary(*t.ref())
    db = port.compute_for_node("node0", *t.port())
    assert summary["node0"]["num_routes"] == len(db.unicast_routes) == 1


def test_summary_min_nexthop_gates_winners_only():
    t = Twin({"0": grid_edges(4)})
    t.advertise("node8", "0", PrefixEntry(
        "10.50.0.0/24", min_nexthop=4, metrics=PrefixMetrics(path_preference=100)))
    t.advertise("node3", "0", PrefixEntry(
        "10.50.0.0/24", metrics=PrefixMetrics(path_preference=200)))
    ref, port = engines(t)
    summary = assert_every_root(t, ref, port)
    assert summary["node0"]["num_routes"] == 1


def test_generation_delta_fetches_only_changed_roots():
    """tests/test_stream_delta.py:429 without a pool: a perturbed
    generation diffs on the card and fetches only the changed roots' rows;
    summaries and RouteDbs equal a fresh engine's, and the counters equal
    the reference engine's."""
    t = delta_twin()
    ref, port = engines(t)
    assert port.fleet_summary(*t.port()) == ref.fleet_summary(*t.ref())
    t.set_node_metrics("0", "node35", 7)
    s2 = port.fleet_summary(*t.port())
    assert s2 == ref.fleet_summary(*t.ref())
    assert port.num_delta_solves == ref.num_delta_solves == 1
    assert port.num_delta_roots_fetched == ref.num_delta_roots_fetched >= 1
    assert port.num_delta_roots_skipped == ref.num_delta_roots_skipped
    fresh = tfleet.FleetRibEngine(PortSolver("node0"), device="cpu")
    assert s2 == fresh.fleet_summary(*t.port())
    for node in ("node17", "node35", "node0"):
        assert port_summary(port.compute_for_node(node, *t.port())) == port_summary(
            fresh.compute_for_node(node, *t.port()))
    # a third generation restoring the metric: the delta again, equal to
    # the first generation's tables
    t.set_node_metrics("0", "node35", 1)
    s3 = port.fleet_summary(*t.port())
    assert port.num_delta_solves == 2
    assert s3 == tfleet.FleetRibEngine(PortSolver("node0"), device="cpu").fleet_summary(*t.port())


def test_generation_delta_declines_on_membership_change():
    t = delta_twin()
    ref, port = engines(t)
    port.fleet_summary(*t.port())
    ref.fleet_summary(*t.ref())
    t.advertise("node1", "0", PrefixEntry("10.123.0.0/24"))
    s = port.fleet_summary(*t.port())
    assert port.num_delta_solves == ref.num_delta_solves == 0
    assert s == ref.fleet_summary(*t.ref())
    assert s == tfleet.FleetRibEngine(PortSolver("node0"), device="cpu").fleet_summary(*t.port())


@pytest.mark.parametrize("make", [grid_twin, two_area_twin])
def test_segment_form_engine_every_root(make, monkeypatch):
    """With the dense layout declined (in-degree buckets cut to 2), the
    engine solves over the segment form, root for root equal to the
    reference engine (declined the same way) and the scalar oracle."""
    from openr_tpu.ops import csr as jcsr
    from openr_tpu_torch.ops import csr as tcsr

    monkeypatch.setattr(jcsr, "IN_DEGREE_BUCKETS", (2,))
    monkeypatch.setattr(tcsr, "IN_DEGREE_BUCKETS", (2,))
    t = make()
    ref, port = engines(t)
    assert_every_root(t, ref, port)
    assert port._prev_gen is None  # the delta needs the dense planes


def test_backend_builds_hub_world_over_segment_form():
    """tests/test_stream_delta.py:184's hub: more in-edges than the dense
    buckets hold.  CudaBackend builds it over the segment form, cold and on
    a warm tick, equal to TpuBackend (which answers it with the scalar
    solver: its lane buckets end below the hub's degree) and the oracle."""
    from openr_tpu.config import ParallelConfig, ResilienceConfig
    from openr_tpu.decision.backend import TpuBackend
    from openr_tpu_torch.decision.backend import CudaBackend
    from openr_tpu_torch.ops.csr import IN_DEGREE_BUCKETS

    t = Twin({"0": [("hub", f"leaf{i}", 1) for i in range(IN_DEGREE_BUCKETS[-1] + 1)]}, me="hub")
    for i in range(64):
        t.advertise(f"leaf{i}", "0", PrefixEntry(f"10.3.{i}.0/24"))
    tpu = TpuBackend(SpfSolver("hub"), min_device_prefixes=0,
                     resilience=ResilienceConfig(enabled=False),
                     parallel=ParallelConfig(max_devices=1))
    backend = CudaBackend(PortSolver("hub"), device="cpu")
    for tick in range(2):
        want = ref_summary(SpfSolver("hub").build_route_db(t.ref_ls, t.ref_ps))
        assert ref_summary(tpu.build_route_db(t.ref_ls, t.ref_ps, force_full=True)) == want
        hints = {} if tick == 0 else dict(changed_prefixes=set(), force_full=True, warm_delta=True)
        assert port_summary(backend.build_route_db(t.port_ls, t.port_ps, **hints)) == want
        t.set_node_metrics("0", "leaf3", 5)
    assert backend._last_enc is not None and not backend._last_enc.has_dense
    assert backend.num_warm_builds == 1


def test_wan_multi_area_copy_matches_reference():
    """The port's copy of the wan_multi_area class: the same per-area
    adjacency databases as the reference's for seed 7."""
    from openr_tpu.emulation import topology as rtopo

    for scale in (128, 1024):
        got = ttopo.wan_multi_area_dbs(scale, 7)
        want = rtopo.wan_multi_area_dbs(scale, 7)
        assert sorted(got) == sorted(want)
        for area in want:
            assert {n: db.to_wire() for n, db in got[area].items()} == {
                n: db.to_wire() for n, db in want[area].items()}
        assert ttopo._wan_params(scale) == rtopo._wan_params(scale)
    assert len(ttopo.wan_multi_area_dbs(1024, 7)) == 63


def test_default_device_refuses_to_run_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.FleetRibEngine(PortSolver("node0"))
