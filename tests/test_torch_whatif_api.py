"""The port's operator what-if (``decision/whatif_api.py``) against the JAX
package's ``WhatIfApiEngine``, criticality report and
``GenericSolverWhatIfEngine``, answer for answer.

The worlds are those of ``tests/test_whatif_api.py``: the 4x4 grid with a
prefix per node (single failures, an off-DAG heavy link, an unknown
link, a simultaneous set, the criticality report with its pair scan), the
parallel-bundle world and the primary+backup world.  Each LSDB is held
by both packages (the port's copy through the wire format); the port's
engine runs its plain path on the CPU.  Tolerance: exact equality of the
returned dictionaries.
"""

import dataclasses

import numpy as np
import pytest
import torch

from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.prefix_state import PrefixState
from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.decision.whatif_api import GenericSolverWhatIfEngine as RefGeneric
from openr_tpu.decision.whatif_api import WhatIfApiEngine as RefEngine
from openr_tpu.decision.whatif_api import _whatif_engine_criticality as ref_criticality
from openr_tpu.emulation.topology import build_adj_dbs, grid_edges
from openr_tpu.types import Adjacency, AdjacencyDatabase, PrefixEntry
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision import whatif_api as twa
from openr_tpu_torch.decision.link_state import LinkState as PortLinkState
from openr_tpu_torch.decision.prefix_state import PrefixState as PortPrefixState
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver


class World:
    """One single-area LSDB and PrefixState held by both packages."""

    def __init__(self, dbs, prefixes, me):
        self.me = me
        self.dbs = dict(dbs)
        self.ref_ls, self.port_ls = LinkState("0", me), PortLinkState("0", me)
        for db in self.dbs.values():
            self._apply(db)
        self.ref_ps, self.port_ps = PrefixState(), PortPrefixState()
        for node, entry in prefixes:
            self.ref_ps.update_prefix(node, "0", entry)
            self.port_ps.update_prefix(node, "0", ttypes.PrefixEntry.from_wire(entry.to_wire()))
        self.seq = 1

    def _apply(self, db):
        self.ref_ls.update_adjacency_database(db)
        self.port_ls.update_adjacency_database(ttypes.AdjacencyDatabase.from_wire(db.to_wire()))

    def set_metric(self, node, other, metric):
        db = self.dbs[node]
        adjs = [dataclasses.replace(a, metric=metric) if a.other_node_name == other else a
                for a in db.adjacencies]
        self.dbs[node] = dataclasses.replace(db, adjacencies=adjs)
        self._apply(self.dbs[node])
        self.seq += 1

    def ref(self):
        return {"0": self.ref_ls}, self.ref_ps, self.seq

    def port(self):
        return {"0": self.port_ls}, self.port_ps, self.seq


def grid_world(heavy=None):
    edges = [(a, b, 10 if heavy and {a, b} == heavy else m) for (a, b, m) in grid_edges(4)]
    prefixes = [(f"node{i}", PrefixEntry(f"10.{i}.0.0/24")) for i in range(16)]
    return World(build_adj_dbs(edges), prefixes, "node0")


def parallel_world():
    """a ==2 parallel links== b -- c; prefixes on b and c."""

    def db(me, adjs):
        return AdjacencyDatabase(
            this_node_name=me,
            adjacencies=[
                Adjacency(other_node_name=o, if_name=i, metric=m, other_if_name=ri)
                for (o, i, m, ri) in adjs
            ],
        )

    dbs = {
        "a": db("a", [("b", "if_ab1", 1, "if_ba1"), ("b", "if_ab2", 2, "if_ba2")]),
        "b": db("b", [("a", "if_ba1", 1, "if_ab1"), ("a", "if_ba2", 2, "if_ab2"),
                      ("c", "if_bc", 1, "if_cb")]),
        "c": db("c", [("b", "if_cb", 1, "if_bc")]),
    }
    prefixes = [("b", PrefixEntry("10.0.1.0/24")), ("c", PrefixEntry("10.0.2.0/24"))]
    return World(dbs, prefixes, "a")


def backup_world():
    edges = [("node0", "a", 1), ("a", "v", 1), ("node0", "b", 10), ("b", "v", 10)]
    prefixes = [(n, PrefixEntry(f"10.0.{ord(n[0])}.0/24")) for n in ("a", "b", "v")]
    return World(build_adj_dbs(edges), prefixes, "node0")


def engines(w):
    return RefEngine(SpfSolver(w.me)), twa.WhatIfApiEngine(PortSolver(w.me), device="cpu")


QUERIES = {
    "single": (grid_world, [("node0", "node1"), ("node1", "node2"), ("node14", "node15")], False),
    "off_dag": (lambda: grid_world(heavy={"node14", "node15"}), [("node14", "node15")], False),
    "unknown": (grid_world, [("node0", "node15"), ("node0", "node4")], False),
    "simultaneous": (
        grid_world, [("node0", "node1"), ("node5", "node6"), ("node10", "node14")], True
    ),
    "simultaneous_unknown": (grid_world, [("node0", "node1"), ("node0", "nope")], True),
    "parallel_bundle": (parallel_world, [("a", "b"), ("b", "c")], False),
    "parallel_bundle_simultaneous": (parallel_world, [("a", "b")], True),
}


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_whatif_matches_reference(query):
    make, failures, simultaneous = QUERIES[query]
    w = make()
    ref, port = engines(w)
    want = ref.run(failures, *w.ref(), simultaneous=simultaneous)
    got = port.run(failures, *w.port(), simultaneous=simultaneous)
    assert got == want
    if query == "off_dag":
        assert got["failures"][0]["on_shortest_path_dag"] is False
    if query == "parallel_bundle":
        assert got["failures"][0]["links_failed"] == 2


@pytest.mark.parametrize("query", ["single", "simultaneous", "parallel_bundle"])
def test_generic_solver_engine_matches_reference_and_device(query):
    make, failures, simultaneous = QUERIES[query]
    w = make()
    want = RefGeneric(SpfSolver(w.me)).run(failures, *w.ref(), simultaneous=simultaneous)
    got = twa.GenericSolverWhatIfEngine(PortSolver(w.me)).run(
        failures, *w.port(), simultaneous=simultaneous
    )
    assert got == want
    device = twa.WhatIfApiEngine(PortSolver(w.me), device="cpu").run(
        failures, *w.port(), simultaneous=simultaneous
    )

    def changes(resp):
        return [
            [dict(c, old_nexthops=sorted(c["old_nexthops"]), new_nexthops=sorted(c["new_nexthops"]))
             for c in f["changes"]]
            for f in resp["failures"]
        ]

    assert changes(device) == changes(got)


@pytest.mark.parametrize("make,max_pairs", [(grid_world, 10_000), (grid_world, 7), (backup_world, 100)])
def test_criticality_matches_reference(make, max_pairs):
    w = make()
    ref, port = engines(w)
    want = ref_criticality(ref, *w.ref(), max_pairs=max_pairs)
    got = twa._whatif_engine_criticality(port, *w.port(), max_pairs=max_pairs)
    assert got == want
    assert got["pairs"]["truncated"] == (max_pairs == 7)


def test_engine_cached_then_warm_seeded_next_generation():
    w = grid_world()
    ref, port = engines(w)
    failures = [("node0", "node1"), ("node5", "node9")]
    assert port.run(failures, *w.port()) == ref.run(failures, *w.ref())
    assert port.run(failures[:1], *w.port()) == ref.run(failures[:1], *w.ref())
    assert port.num_engine_builds == 1 and port.num_sweeps == 2
    w.set_metric("node1", "node2", 6)
    w.set_metric("node2", "node1", 6)
    assert port.run(failures, *w.port()) == ref.run(failures, *w.ref())
    assert port.num_engine_builds == 2
    assert port._sweep.base_source == "warm"
    cold = twa.WhatIfApiEngine(PortSolver(w.me), device="cpu")
    assert cold.run(failures, *w.port()) == port.run(failures, *w.port())


def test_default_device_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twa.WhatIfApiEngine(PortSolver("node0"))
    w = grid_world()
    from openr_tpu_torch.ops import csr as tcsr
    from openr_tpu_torch.ops.sweep_select import SweepCandidates, SweepRouteSelector
    from openr_tpu_torch.ops.whatif import LinkFailureSweep

    topo = tcsr.encode_link_state(w.port_ls)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LinkFailureSweep(topo, "node0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SweepRouteSelector(topo, "node0", SweepCandidates.single_advertiser(np.arange(16)), 2)
