"""`CudaBackend` (on the CPU, through the plain kernel versions) against
the JAX package's `TpuBackend` and `ScalarBackend` on the same worlds.

Each world is built with the reference's types, carried across as wire
dicts (``lsdb_to_wire`` → ``interop.lsdb_from_wire``) and built
by all three backends.  Tolerance: ``route_db_summary`` equality — every
unicast and MPLS route with every field that affects forwarding.
"""

import pytest

from openr_tpu.decision.backend import ScalarBackend, TpuBackend
from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.prefix_state import PrefixState
from openr_tpu.decision.rib import route_db_summary as ref_summary
from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.emulation.topology import (
    build_adj_dbs,
    fabric_edges,
    grid_edges,
    line_edges,
    random_connected_edges,
    ring_edges,
)
from openr_tpu.types import (
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixMetrics,
    RouteComputationRules,
)
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.rib import route_db_summary as port_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from openr_tpu_torch.interop import lsdb_from_wire
from tests.test_torch_spf import lsdb_to_wire

PER_AREA = RouteComputationRules.PER_AREA_SHORTEST_DISTANCE


def make_ls(edges, area, me="", **kwargs):
    ls = LinkState(area, me)
    for db in build_adj_dbs(edges, area=area, **kwargs).values():
        ls.update_adjacency_database(db)
    return ls


def prefixes(*adverts):
    ps = PrefixState()
    for node, area, entry in adverts:
        ps.update_prefix(node, area, entry)
    return ps


def _port_kwargs(kw):
    out = dict(kw)
    if "route_selection_algorithm" in out:
        out["route_selection_algorithm"] = ttypes.RouteComputationRules(
            int(out["route_selection_algorithm"])
        )
    return out


def port_build(areas, ps, me, **kw):
    adj_wire, prefix_wire = lsdb_to_wire(areas, ps)
    als, pps = lsdb_from_wire(adj_wire, prefix_wire, my_node_name=me)
    backend = CudaBackend(PortSolver(me, **_port_kwargs(kw)), device="cpu")
    return backend, backend.build_route_db(als, pps)


def assert_three_way(mk_areas, ps, me, **kw):
    scalar = ScalarBackend(SpfSolver(me, **kw)).build_route_db(mk_areas(), ps)
    tpu = TpuBackend(SpfSolver(me, **kw)).build_route_db(mk_areas(), ps)
    backend, port = port_build(mk_areas(), ps, me, **kw)
    want = ref_summary(scalar)
    assert ref_summary(tpu) == want
    assert port_summary(port) == want
    assert backend.num_device_builds == (0 if port is None else 1)
    return port


# -- worlds --------------------------------------------------------------


def grid_drains():
    """tests/test_decision.py's TpuBackend-vs-ScalarBackend grid."""

    def mk():
        return {
            "0": make_ls(
                grid_edges(4), "0", me="node0", overloaded=["node5"],
                soft_drained={"node10": 60},
            )
        }

    ps = prefixes(
        ("node15", "0", PrefixEntry("10.0.0.0/24")),
        ("node12", "0", PrefixEntry("10.0.0.0/24")),
        ("node3", "0", PrefixEntry("2001:db8::/64")),
        ("node5", "0", PrefixEntry("10.7.0.0/24")),  # hard-drained
        ("node10", "0", PrefixEntry("10.8.0.0/24")),  # soft-drained
        ("node0", "0", PrefixEntry("10.9.0.0/24")),  # self
        ("node9", "0", PrefixEntry("10.3.0.0/24", min_nexthop=5)),  # gated
    )
    return mk, ps, "node0", {}


def grid_node_labels():
    """Node segment labels: the MPLS overlay the build keeps scalar."""
    labels = {f"node{i}": 101 + i for i in range(9)}

    def mk():
        return {"0": make_ls(grid_edges(3), "0", me="node0", node_labels=labels)}

    ps = prefixes(("node8", "0", PrefixEntry("10.0.0.0/24")))
    return mk, ps, "node0", {"enable_node_segment_label": True}


def two_area_factory(me="b0"):
    def mk():
        return {
            "1": make_ls([("a0", "a1", 1), ("a1", "b0", 1)], "1", me=me),
            "2": make_ls(ring_edges(4, prefix="b"), "2", me=me),
        }

    return mk


def two_areas_basic():
    ps = prefixes(
        ("a0", "1", PrefixEntry("10.0.0.0/24")),
        ("b2", "2", PrefixEntry("10.1.0.0/24")),
        ("b1", "2", PrefixEntry("2001:db8::/64")),
    )
    return two_area_factory(), ps, "b0", {}


def cross_area_merge():
    ps = prefixes(
        ("a1", "1", PrefixEntry("10.0.0.0/24")),
        ("b1", "2", PrefixEntry("10.0.0.0/24")),
    )
    return two_area_factory(), ps, "b0", {}


def cross_area_equal_metric_union():
    def mk():
        return {
            "1": make_ls([("me", "p", 1)], "1", me="me"),
            "2": make_ls([("me", "q", 1)], "2", me="me"),
        }

    ps = prefixes(
        ("p", "1", PrefixEntry("10.0.0.0/24")),
        ("q", "2", PrefixEntry("10.0.0.0/24")),
    )
    return mk, ps, "me", {}


def per_area_algorithm():
    ps = prefixes(
        ("a0", "1", PrefixEntry("10.0.0.0/24", metrics=PrefixMetrics(distance=5))),
        ("a1", "1", PrefixEntry("10.0.0.0/24", metrics=PrefixMetrics(distance=3))),
        ("b2", "2", PrefixEntry("10.0.0.0/24", metrics=PrefixMetrics(distance=9))),
    )
    return two_area_factory(), ps, "b0", {"route_selection_algorithm": PER_AREA}


def me_absent_from_one_area():
    def mk():
        return {
            "1": make_ls(line_edges(3), "1", me="node0"),
            "2": make_ls(ring_edges(3, prefix="z"), "2", me="node0"),
        }

    ps = prefixes(
        ("node2", "1", PrefixEntry("10.0.0.0/24")),
        ("z1", "2", PrefixEntry("10.1.0.0/24")),
    )
    return mk, ps, "node0", {}


def self_advert_isolated_area():
    def mk():
        return {
            "1": make_ls(line_edges(3), "1", me="node0"),
            "2": make_ls([("w0", "w1", 1)], "2", me="node0"),
        }

    ps = prefixes(
        ("node2", "1", PrefixEntry("10.0.0.0/24")),
        ("node0", "2", PrefixEntry("10.0.0.0/24")),  # self, area 2
    )
    return mk, ps, "node0", {}


def multiarea_drains():
    def mk():
        areas = {"1": make_ls(grid_edges(3), "1", me="node0", overloaded=["node4"])}
        areas["2"] = make_ls(
            ring_edges(4, prefix="b") + [("b0", "node0", 1)], "2", me="node0",
            soft_drained={"b2": 50},
        )
        return areas

    ps = prefixes(
        ("node4", "1", PrefixEntry("10.0.0.0/24")),  # hard-drained
        ("b2", "2", PrefixEntry("10.0.0.0/24")),  # soft-drained
        ("node8", "1", PrefixEntry("10.1.0.0/24")),
        ("b1", "2", PrefixEntry("10.1.0.0/24")),
    )
    return mk, ps, "node0", {}


def border_node():
    def mk():
        e1 = [("me", "a1", 1), ("a1", "a2", 1), ("a2", "a3", 1),
              ("a3", "a4", 1), ("a4", "X", 1)]
        e2 = [("me", "X", 1), ("X", "z1", 1)]
        return {"1": make_ls(e1, "1", me="me"), "2": make_ls(e2, "2", me="me")}

    return mk, prefixes(("X", "1", PrefixEntry("10.0.0.0/24"))), "me", {}


def three_areas():
    def mk():
        return {
            "1": make_ls([("me", "a1", 1), ("a1", "a2", 1)], "1", me="me"),
            "2": make_ls([("me", "b1", 2), ("b1", "b2", 1)], "2", me="me"),
            "3": make_ls([("me", "c1", 3)], "3", me="me"),
        }

    adverts = []
    for n, a in (("a2", "1"), ("b2", "2"), ("c1", "3")):
        adverts.append((n, a, PrefixEntry("10.0.0.0/24")))
        adverts.append((n, a, PrefixEntry(f"10.{a}.0.0/24")))
    return mk, prefixes(*adverts), "me", {}


def random_topology(seed):
    def world():
        def mk():
            e1 = random_connected_edges(12, 8, seed=seed, prefix="a")
            e2 = random_connected_edges(10, 6, seed=seed + 100, prefix="c")
            e1.append(("a0", "me", 1))
            e2.append(("c0", "me", 2))
            return {"1": make_ls(e1, "1", me="me"), "2": make_ls(e2, "2", me="me")}

        ps = prefixes(
            ("a5", "1", PrefixEntry("10.0.0.0/24")),
            ("c5", "2", PrefixEntry("10.0.0.0/24")),
            ("a7", "1", PrefixEntry("10.1.0.0/24")),
            ("c3", "2", PrefixEntry("10.2.0.0/24", min_nexthop=1)),
            ("a3", "1", PrefixEntry("10.3.0.0/24", metrics=PrefixMetrics(path_preference=900))),
            ("c7", "2", PrefixEntry("10.3.0.0/24", metrics=PrefixMetrics(path_preference=800))),
        )
        return mk, ps, "me", {}

    return world


def me_in_no_area():
    def mk():
        return {"1": make_ls(line_edges(3), "1", me="ghost")}

    return mk, prefixes(("node2", "1", PrefixEntry("10.0.0.0/24"))), "ghost", {}


WORLDS = {
    "grid_drains": grid_drains,
    "grid_node_labels": grid_node_labels,
    "two_areas_basic": two_areas_basic,
    "cross_area_merge": cross_area_merge,
    "cross_area_equal_metric_union": cross_area_equal_metric_union,
    "per_area_algorithm": per_area_algorithm,
    "me_absent_from_one_area": me_absent_from_one_area,
    "self_advert_isolated_area": self_advert_isolated_area,
    "multiarea_drains": multiarea_drains,
    "border_node": border_node,
    "three_areas": three_areas,
    "random_11": random_topology(11),
    "random_12": random_topology(12),
    "random_13": random_topology(13),
    "me_in_no_area": me_in_no_area,
}


@pytest.mark.parametrize("world", list(WORLDS))
def test_route_db_matches_tpu_and_scalar(world):
    mk, ps, me, kw = WORLDS[world]()
    port = assert_three_way(mk, ps, me, **kw)
    if world == "self_advert_isolated_area":
        assert "10.0.0.0/24" not in port.unicast_routes
    if world == "border_node":
        assert port.unicast_routes["10.0.0.0/24"].igp_cost == 5.0
    if world == "grid_node_labels":
        assert port.mpls_routes
    if world == "me_in_no_area":
        assert port is None


def test_route_db_per_area_algorithm_on_random_world():
    mk, ps, me, _kw = random_topology(12)()
    assert_three_way(mk, ps, me, route_selection_algorithm=PER_AREA)


def test_ksp2_world_raises_not_implemented():
    """The world this port once refused (a KSP2_ED_ECMP winner) now builds
    through the device KSP2 engine and matches the reference's backends."""
    ksp2 = PrefixForwardingAlgorithm.KSP2_ED_ECMP

    def mk():
        return {
            "1": make_ls(
                fabric_edges(num_pods=2, rsws_per_pod=2, fsws_per_pod=2), "1",
                me="rsw0_0",
            ),
        }

    ps = prefixes(("rsw1_1", "1", PrefixEntry("10.0.0.0/24", forwarding_algorithm=ksp2)))
    port = assert_three_way(mk, ps, "rsw0_0")
    assert len(port.unicast_routes["10.0.0.0/24"].nexthops) >= 1


def test_candidate_overflow_raises_not_implemented():
    """65 advertisers of one prefix: one more than the largest candidate
    bucket the selection kernel takes.  The port once refused this world;
    now, as the reference does, it counts a candidate overflow and answers
    through the scalar solver, with no device build."""

    def mk():
        return {"1": make_ls(line_edges(66), "1", me="node0")}

    ps = prefixes(*((f"node{i}", "1", PrefixEntry("10.0.0.0/24")) for i in range(1, 66)))
    scalar = ScalarBackend(SpfSolver("node0")).build_route_db(mk(), ps)
    tpu_be = TpuBackend(SpfSolver("node0"))
    tpu = tpu_be.build_route_db(mk(), ps)
    backend, port = port_build(mk(), ps, "node0")
    want = ref_summary(scalar)
    assert ref_summary(tpu) == want
    assert port_summary(port) == want
    assert "10.0.0.0/24" in port.unicast_routes
    for be in (tpu_be, backend):
        assert be.num_fallback_cand_overflow == 1
        assert be.num_scalar_builds == 1
        assert be.num_device_builds == 0


def test_hints_answer_with_the_cold_build():
    """Incremental/warm hints yield the same RouteDb as a cold build."""
    mk, ps, me, _kw = grid_drains()
    adj_wire, prefix_wire = lsdb_to_wire(mk(), ps)
    als, pps = lsdb_from_wire(adj_wire, prefix_wire, my_node_name=me)
    backend = CudaBackend(PortSolver(me), device="cpu")
    cold = port_summary(backend.build_route_db(als, pps))
    hinted = backend.build_route_db(
        als, pps, changed_prefixes={"10.0.0.0/24"}, warm_delta=True
    )
    assert port_summary(hinted) == cold
    assert backend.num_encode_hits == 1
    assert set(backend.last_phase_ms) == {"encode", "spf", "select", "decode", "total"}
