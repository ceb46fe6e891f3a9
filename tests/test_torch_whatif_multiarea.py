"""The port's ``MultiAreaWhatIfEngine`` (``decision/whatif_api.py``, on the
CPU through the plain kernel versions) against the JAX package's engine
and the scalar oracle.

The worlds are those of ``tests/test_whatif_multiarea.py:117-240``: the
two-area world with the border node b0 as vantage (every link failure,
the border failure that shifts the cross-area anycast, an unknown link,
bucketing independent of query size), plus a bundle of the same pair in
both areas and simultaneous sets.  Each LSDB is held by both packages.
Tolerance: exact equality of the returned dictionaries with the
reference's, and of every failure's changes with the scalar solver on the
LSDB with the links removed (``GenericSolverWhatIfEngine``, and the
reference test's own oracle diff).
"""

import pytest

from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.decision.whatif_api import MultiAreaWhatIfEngine as RefEngine
from openr_tpu.emulation.topology import ring_edges
from openr_tpu.types import PrefixEntry, PrefixMetrics
from openr_tpu_torch.decision import whatif_api as twa
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from tests.test_torch_fleet import Twin

AREA_EDGES = {
    "1": [("a0", "a1", 1), ("a1", "b0", 1), ("a0", "b0", 3)],
    "2": ring_edges(4, prefix="b"),
}


def world(area_edges=AREA_EDGES, me="b0"):
    """tests/test_whatif_multiarea.py:29-50."""
    t = Twin(area_edges, me=me)
    t.advertise("a0", "1", PrefixEntry("10.0.0.0/24"))
    t.advertise("b2", "2", PrefixEntry("10.1.0.0/24"))
    t.advertise("b1", "2", PrefixEntry("2001:db8::/64"))
    for node, area in (("a1", "1"), ("b3", "2")):
        t.advertise(node, area, PrefixEntry(
            "10.9.0.0/24", metrics=PrefixMetrics(path_preference=700)))
    return t


def bundle_world():
    """b0-b1 joined in both areas: failing the pair fails both links."""
    edges = dict(AREA_EDGES)
    edges["1"] = AREA_EDGES["1"] + [("b0", "b1", 2)]
    return world(edges)


def all_links(area_edges=AREA_EDGES):
    return [(n1, n2) for edges in area_edges.values() for (n1, n2, _w) in edges]


def engines(t):
    return RefEngine(SpfSolver(t.me)), twa.MultiAreaWhatIfEngine(PortSolver(t.me), device="cpu")


def oracle_changes(result):
    """prefix → ((old metric, old nexthops), (new metric, new nexthops))."""
    return [
        sorted(
            (c["prefix"], c["old_metric"], tuple(sorted(c["old_nexthops"])),
             c["new_metric"], tuple(sorted(c["new_nexthops"])))
            for c in f.get("changes", [])
        )
        for f in result["failures"]
    ]


QUERIES = {
    "every_link": (world, all_links(), False),
    "border": (world, [("a1", "b0")], False),
    "unknown": (world, [("nope", "b0"), ("a0", "a1")], False),
    "bundle": (bundle_world, [("b0", "b1"), ("b2", "b3")], False),
    "simultaneous": (world, [("a1", "b0"), ("b0", "b3")], True),
    "simultaneous_bundle": (bundle_world, [("b0", "b1"), ("a0", "b0")], True),
    "simultaneous_unknown": (world, [("a1", "b0"), ("nope", "b0")], True),
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_answers_match_reference_and_scalar(query):
    make, failures, simultaneous = QUERIES[query]
    t = make()
    ref, port = engines(t)
    got = port.run(failures, *t.port(), simultaneous=simultaneous)
    assert got == ref.run(failures, *t.ref(), simultaneous=simultaneous)
    generic = twa.GenericSolverWhatIfEngine(PortSolver(t.me)).run(
        failures, *t.port(), simultaneous=simultaneous)
    assert oracle_changes(got) == oracle_changes(generic)
    assert port.num_engine_builds == 1
    if query == "border":
        assert got["failures"][0]["routes_changed"] > 0
    if query == "bundle":
        assert got["failures"][0]["links_failed"] == 2
        assert got["failures"][0]["areas"] == ["1", "2"]
    if query == "unknown":
        assert got["failures"][0]["error"] == "unknown link"


def test_batch_size_independent_of_query_size():
    """tests/test_whatif_multiarea.py:191: the answer for a link does not
    depend on the other failures in the batch (the base row is the one pad
    row, after the last failure)."""
    t = world()
    _ref, port = engines(t)
    solo = port.run([("a1", "b0")], *t.port())
    many = port.run([("b0", "b1"), ("a1", "b0"), ("b2", "b3")], *t.port())
    assert solo["failures"][0] == many["failures"][1]
    assert port.num_engine_builds == 1 and port.num_sweeps == 2


def test_context_rebuilds_on_a_new_generation():
    t = world()
    ref, port = engines(t)
    port.run([("a1", "b0")], *t.port())
    t.set_node_metrics("1", "a0", 4)
    got = port.run(all_links(), *t.port())
    assert got == ref.run(all_links(), *t.ref())
    assert port.num_engine_builds == 2


@pytest.mark.parametrize("me", ["a0", "b2"])
def test_vantage_isolated_in_an_area(me):
    """A vantage with no adjacency in one area (its interned root there
    has no in-edges: the -128 lane row)."""
    t = world(me=me)
    ref, port = engines(t)
    got = port.run(all_links(), *t.port())
    assert got == ref.run(all_links(), *t.ref())


def test_default_device_refuses_to_run_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twa.MultiAreaWhatIfEngine(PortSolver("b0"))
