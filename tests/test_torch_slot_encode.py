"""The port's slot-stable membership encode against the JAX package's.

* ``ops/csr.py`` ``patch_encoded_topology_slots`` /
  ``patch_encoded_multi_area_slots`` against the reference's
  (``openr_tpu/ops/csr.py:499``, ``:679``) on the same adjacency databases:
  a leave (tombstones), a rejoin (revived rows), a replacement (a new name
  on a freed slot, its links on the tombstoned rows), the two declines and
  the multi-area kinds, field by field (symbol tables, weight and validity
  planes, dense planes, tombstone sets, ``slot_changed``), with every layout
  array the previous encoding's own object.
* ``ops/repair.py`` ``plan_generation_delta`` with ``force_reset`` /
  ``trust_layout``: the reference's reset set, sub-edges and flags.
* ``CudaBackend(device="cpu")`` through seeded leave / rejoin /
  replacement / weight sweeps against ``TpuBackend(warm_rebuild=True)``, a
  cold port backend and the scalar ``SpfSolver``: the same RouteDb,
  changed set and path counters every generation; object identity of
  untouched routes on a structural tick; a purge after injected
  corruption; an unhinted replacement tick through the delta selection;
  an encoding without the dense layout (segment form) against the dense
  one; the gauges and the resilience status.
* On the card (``cuda``): the sweep with the hand kernels, against the
  port's scalar solver and a cold backend on the card.

Tolerance: exact equality throughout.  This module imports no JAX at
import time, so that its ``cuda`` case runs where JAX is absent.
"""

import types

import numpy as np
import pytest
import torch

from openr_tpu_torch import resilience as port_resilience
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.config import ResilienceConfig
from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import route_db_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.emulation.topology import (
    build_adj_dbs,
    grid_edges,
    make_adjacency,
    random_connected_edges,
)
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.kernels import LAUNCHES, reset_launch_counts
from openr_tpu_torch.ops import csr, spf
from openr_tpu_torch.ops.consts import BIG
from openr_tpu_torch.ops.repair import plan_generation_delta

NO_GOVERNOR = ResilienceConfig(enabled=False)

#: the path counters both backends keep
COUNTERS = (
    "num_incremental_builds",
    "num_warm_builds",
    "num_warm_selective_builds",
    "num_warm_subgraph_builds",
    "num_warm_cold_fallbacks",
    "num_delta_builds",
    "num_encode_patches",
    "num_encode_slot_patches",
    "num_device_builds",
    "warm_last_reset_nodes",
    "warm_last_est_depth",
)


def _ref():
    """The JAX package's modules, imported only by the CPU tests."""
    from openr_tpu import resilience
    from openr_tpu import types as rtypes
    from openr_tpu.common.runtime import SimClock
    from openr_tpu.config import ResilienceConfig as RefResilienceConfig
    from openr_tpu.decision.backend import TpuBackend
    from openr_tpu.decision.link_state import LinkState as RefLinkState
    from openr_tpu.decision.prefix_state import PrefixState as RefPrefixState
    from openr_tpu.decision.rib import route_db_summary as ref_summary
    from openr_tpu.decision.spf_solver import SpfSolver as RefSolver
    from openr_tpu.ops import csr as rcsr
    from openr_tpu.ops import repair as rrepair

    def backend(me, **kw):
        kw.setdefault("warm_rebuild", True)
        return TpuBackend(
            RefSolver(me), clock=SimClock(),
            resilience=RefResilienceConfig(enabled=False), **kw,
        )

    return types.SimpleNamespace(
        types=rtypes, LinkState=RefLinkState, PrefixState=RefPrefixState,
        SpfSolver=RefSolver, summary=ref_summary, csr=rcsr, repair=rrepair,
        backend=backend, resilience=resilience,
    )


class World:
    """One LSDB held by the port's LinkStates and, on the CPU, by the
    reference's too (through the wire format), mutated in lockstep.
    ``adj`` holds every node's current adjacency database, advertised or
    not."""

    def __init__(self, area_edges, me, ref=None):
        self.me = me
        self.ref_mod = ref
        self.adj = {}
        self.port = {}
        self.ref = {}
        for area, edges in area_edges.items():
            self.adj[area] = build_adj_dbs(edges, area=area)
            self.port[area] = LinkState(area, me)
            if ref is not None:
                self.ref[area] = ref.LinkState(area, me)
            for db in self.adj[area].values():
                self.apply(area, db)

    def apply(self, area, db):
        self.adj[area][db.this_node_name] = db
        self.port[area].update_adjacency_database(db)
        if self.ref_mod is not None:
            self.ref[area].update_adjacency_database(
                self.ref_mod.types.AdjacencyDatabase.from_wire(db.to_wire())
            )

    def leave(self, area, node):
        self.port[area].delete_adjacency_database(node)
        if self.ref_mod is not None:
            self.ref[area].delete_adjacency_database(node)

    def rejoin(self, area, node):
        self.apply(area, self.adj[area][node])

    def replace(self, area, old, new):
        """``new`` takes the place of ``old`` (which has left): the same
        neighbours and metrics under a new name; each neighbour still in
        the LSDB re-advertises, the others will when they rejoin."""
        dbs = self.adj[area]
        gone = dbs.pop(old)
        adjs = []
        for a in gone.adjacencies:
            nbr = a.other_node_name
            adjs.append(make_adjacency(new, nbr, a.metric))
            ndb = dbs[nbr]
            ndb.adjacencies = [
                x for x in ndb.adjacencies if x.other_node_name != old
            ] + [make_adjacency(nbr, new, a.metric)]
            if self.port[area].has_node(nbr):
                self.apply(area, ndb)
        self.apply(area, ttypes.AdjacencyDatabase(this_node_name=new, adjacencies=adjs, area=area))

    def set_metric(self, area, node, k, metric):
        db = self.adj[area][node]
        db.adjacencies[k].metric = metric
        self.apply(area, db)

    def add_link(self, area, a, b, metric=1):
        for x, y in ((a, b), (b, a)):
            db = self.adj[area][x]
            db.adjacencies = db.adjacencies + [make_adjacency(x, y, metric)]
            self.apply(area, db)


class Prefixes:
    """PrefixState held like World."""

    def __init__(self, ref=None):
        self.ref_mod = ref
        self.port = PrefixState()
        self.ref = ref.PrefixState() if ref is not None else None

    def add(self, node, area, prefix):
        self.port.update_prefix(node, area, ttypes.PrefixEntry(prefix))
        if self.ref is not None:
            self.ref.update_prefix(node, area, self.ref_mod.types.PrefixEntry(prefix))
        return {prefix}


def grid(ref=None, side=4):
    wd = World({"0": grid_edges(side)}, "node0", ref)
    ps = Prefixes(ref)
    for i in range(side * side):
        ps.add(f"node{i}", "0", f"10.8.{i}.0/24")
    ps.add("node12", "0", "10.8.15.0/24")  # anycast
    return wd, ps


def three_areas(ref=None):
    me = "me"
    ring = [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
    wd = World(
        {
            "1": grid_edges(4, prefix="a") + [("a0", me, 1)],
            "2": ring + [("b0", me, 2), ("b3", me, 5)],
            "3": random_connected_edges(10, 6, seed=7, prefix="c") + [("c0", me, 1)],
        },
        me,
        ref,
    )
    ps = Prefixes(ref)
    for area, pre, n in (("1", "a", 16), ("2", "b", 6), ("3", "c", 10)):
        for i in range(n):
            ps.add(f"{pre}{i}", area, f"10.{area}.{i}.0/24")
    ps.add("c9", "3", "10.1.3.0/24")  # anycast across areas
    return wd, ps


def port_backend(me, **kw):
    kw.setdefault("resilience", NO_GOVERNOR)
    return CudaBackend(SpfSolver(me), device=kw.pop("device", "cpu"), **kw)


# ---------------------------------------------------------------------------
# the slot patch, field by field against the reference
# ---------------------------------------------------------------------------

LAYOUT = ("src", "dst", "link_index", "link_edge_pos", "in_src", "in_rank", "in_edge_pos", "in_has")


def assert_topo_equal(r, p):
    """One area's encoding: the port's against the reference's."""
    assert p.node_ids == r.node_ids
    assert p.id_to_node == r.id_to_node
    for name in LAYOUT + ("w", "edge_ok", "overloaded", "soft", "in_w", "in_ok"):
        a, b = getattr(r, name), getattr(p, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert [lk._key for lk in p.links] == [lk._key for lk in r.links]
    assert p.tombstoned_nodes == r.tombstoned_nodes
    assert p.tombstoned_links == r.tombstoned_links
    if r.slot_changed is None:
        assert p.slot_changed is None
    else:
        assert np.array_equal(p.slot_changed, r.slot_changed)


def assert_layout_shared(new, old):
    for name in LAYOUT:
        assert getattr(new, name) is getattr(old, name), name


def slot_patch(wd, olds):
    """(reference, port) slot patches of area "0" against their previous
    encodings; the reasons must agree."""
    r_old, p_old = olds
    r, r_reason = wd.ref_mod.csr.patch_encoded_topology_slots(r_old, wd.ref["0"], wd.me)
    p, p_reason = csr.patch_encoded_topology_slots(p_old, wd.port["0"], wd.me)
    assert p_reason == r_reason
    assert (p is None) == (r is None)
    if p is not None:
        assert_topo_equal(r, p)
        assert_layout_shared(p, p_old)
    return (r, p), p_reason


def cold(wd):
    return (
        wd.ref_mod.csr.encode_link_state(wd.ref["0"]),
        csr.encode_link_state(wd.port["0"]),
    )


@pytest.mark.parametrize("node, links", [("node15", 2), ("node5", 4), ("node1", 3)])
def test_leave_tombstones_in_place_layout_shared(node, links):
    ref = _ref()
    wd, _ps = grid(ref)
    old = cold(wd)
    wd.leave("0", node)
    (r, p), reason = slot_patch(wd, old)
    assert reason is None
    assert p.node_ids is old[1].node_ids  # no rename: the symbols are shared
    assert p.tombstoned_nodes == frozenset({node})
    assert len(p.tombstoned_links) == links
    for li in p.tombstoned_links:
        for e in old[1].link_edge_pos[li]:
            assert not p.edge_ok[e] and p.w[e] == np.float32(np.inf)
    nid = old[1].node_id(node)
    assert p.slot_changed[nid]


def test_rejoin_revives_rows_and_matches_original():
    ref = _ref()
    wd, _ps = grid(ref)
    old = cold(wd)
    wd.leave("0", "node15")
    left, _ = slot_patch(wd, old)
    wd.rejoin("0", "node15")
    (r, back), reason = slot_patch(wd, left)
    assert reason is None
    assert back.tombstoned_nodes == frozenset() and back.tombstoned_links == frozenset()
    for name in ("w", "edge_ok", "in_w", "in_ok"):
        assert np.array_equal(getattr(back, name), getattr(old[1], name)), name
    assert_layout_shared(back, old[1])
    assert back.slot_changed[old[1].node_id("node15")]


@pytest.mark.parametrize("reason", ["slot_exhaustion", "new_link"])
def test_slot_exhaustion_and_new_link_decline(reason):
    ref = _ref()
    wd, _ps = grid(ref)
    old = cold(wd)
    if reason == "new_link":
        # a free slot admits the name, but its link joins a pair of slots
        # no tombstoned row serves
        wd.leave("0", "node15")
        old, _ = slot_patch(wd, old)
    wd.adj["0"]["nodeX"] = ttypes.AdjacencyDatabase(this_node_name="nodeX", area="0")
    wd.add_link("0", "nodeX", "node0")
    (_r, p), got = slot_patch(wd, old)
    assert p is None and got == reason


def test_new_link_between_live_nodes_declines():
    ref = _ref()
    wd, _ps = grid(ref)
    old = cold(wd)
    wd.add_link("0", "node5", "node10")  # a diagonal: no row exists
    (_r, p), reason = slot_patch(wd, old)
    assert p is None and reason == "new_link"


def test_replacement_node_reclaims_slot_and_rows():
    """node15 leaves for good and node99 joins with its neighbours: the
    new name takes node15's slot, its links the tombstoned rows."""
    ref = _ref()
    wd, _ps = grid(ref)
    old = cold(wd)
    slot15 = old[1].node_id("node15")
    wd.leave("0", "node15")
    left, _ = slot_patch(wd, old)
    wd.replace("0", "node15", "node99")
    (r, p), reason = slot_patch(wd, left)
    assert reason is None
    assert p.node_id("node99") == slot15 and "node15" not in p.node_ids
    assert p.tombstoned_nodes == frozenset() and p.tombstoned_links == frozenset()
    assert p.slot_changed[slot15]
    assert_layout_shared(p, old[1])
    # the reclaimed rows carry the replacement's links
    for li in left[1].tombstoned_links:
        assert "node99" in (p.links[li].n1, p.links[li].n2)
    # the tables over the slots equal a fresh encode's by name
    dist_p, _ = dense_tables(p)
    fresh = csr.encode_link_state(
        wd.port["0"], node_bucket=p.padded_nodes, edge_bucket=p.padded_edges,
        extra_nodes=("node0",),
    )
    dist_f, _ = dense_tables(fresh)
    for name in fresh.node_ids:
        assert dist_p[p.node_id(name)] == dist_f[fresh.node_id(name)], name


def dense_tables(topo, D=8, root="node0"):
    """Cold (dist, lanes) of one encoding by the port's plain dense SPF."""
    planes = [topo.in_src, topo.in_w, topo.in_ok, topo.in_rank, topo.in_has, topo.overloaded]
    args = tables_from_numpy(
        [p[None] for p in planes] + [np.asarray([topo.node_id(root)], np.int32)],
        torch.device("cpu"),
    )
    dist, nh = spf.dense_spf_one(*args, max_degree=D)
    return dist[0].numpy(), nh[0].numpy()


def test_tombstoned_rows_excluded_from_dense_reductions():
    """A tombstoned node's rows read in_ok=False / in_w=INF: the dense
    tables at every surviving slot equal a fresh encode's and the
    reference's, and the tombstone reads BIG."""
    import jax.numpy as jnp

    from openr_tpu.ops.spf import dense_spf_one as jax_dense_spf_one

    ref = _ref()
    wd, _ps = grid(ref)
    old = cold(wd)
    wd.leave("0", "node5")  # interior: four links
    (r, p), _ = slot_patch(wd, old)
    assert len(p.tombstoned_links) == 4
    dist_p, nh_p = dense_tables(p)
    rd, rn = jax_dense_spf_one(
        *(jnp.asarray(getattr(r, k)) for k in ("in_src", "in_w", "in_ok", "in_rank", "in_has",
                                                "overloaded")),
        jnp.int32(r.node_id("node0")), max_degree=8,
    )
    assert np.array_equal(dist_p, np.asarray(rd)) and np.array_equal(nh_p, np.asarray(rn))
    fresh = csr.encode_link_state(
        wd.port["0"], node_bucket=old[1].padded_nodes, edge_bucket=old[1].padded_edges,
        extra_nodes=("node0",),
    )
    dist_f, _ = dense_tables(fresh)
    for name in fresh.node_ids:
        assert dist_p[p.node_id(name)] == dist_f[fresh.node_id(name)], name
    assert dist_p[p.node_id("node5")] == np.float32(BIG)


def multi_slot_patch(wd, prevs):
    r_prev, p_prev = prevs
    r, rk, rr = wd.ref_mod.csr.patch_encoded_multi_area_slots(r_prev, wd.ref, wd.me)
    p, pk, pr = csr.patch_encoded_multi_area_slots(p_prev, wd.port, wd.me)
    assert (pk, pr) == (rk, rr)
    assert (p is None) == (r is None)
    if p is not None:
        assert p.areas == r.areas
        for rt, pt in zip(r.topos, p.topos):
            assert_topo_equal(rt, pt)
        for name in ("w", "edge_ok", "overloaded", "soft", "in_w", "in_ok", "roots"):
            assert np.array_equal(getattr(p, name), getattr(r, name)), name
        for name in ("src", "dst", "in_src", "in_rank", "in_has", "roots"):
            assert getattr(p, name) is getattr(p_prev, name), name
    return (r, p), pk, pr


def test_multi_area_slot_patch_kinds():
    ref = _ref()
    wd, _ps = grid(ref)
    prev = (ref.csr.encode_multi_area(wd.ref, wd.me), csr.encode_multi_area(wd.port, wd.me))
    wd.set_metric("0", "node3", 0, 5)  # weight churn: the perturbation patch
    enc, kind, reason = multi_slot_patch(wd, prev)
    assert kind == "patch" and reason is None
    wd.leave("0", "node15")  # membership churn: the slot patch
    enc2, kind2, reason2 = multi_slot_patch(wd, enc)
    assert kind2 == "slot" and reason2 is None
    wd.set_metric("0", "node3", 0, 1)  # tombstones present: the slot patch again
    _enc3, kind3, _ = multi_slot_patch(wd, enc2)
    assert kind3 == "slot"
    # a new area: a cold encode with the counted reason
    wd.port["b"] = LinkState("b", wd.me)
    wd.ref["b"] = ref.LinkState("b", wd.me)
    enc4, kind4, reason4 = multi_slot_patch(wd, enc2)
    assert enc4 == (None, None) and kind4 == "cold" and reason4 == "area_change"


def test_multi_area_leave_in_one_area():
    """One leave in one of three areas: the slot patch there, the
    perturbation patch in the others (no slot_changed), kind "slot"."""
    ref = _ref()
    wd, _ps = three_areas(ref)
    prev = (ref.csr.encode_multi_area(wd.ref, wd.me), csr.encode_multi_area(wd.port, wd.me))
    wd.leave("3", "c5")
    (_r, p), kind, reason = multi_slot_patch(wd, prev)
    assert kind == "slot" and reason is None
    by_area = dict(zip(p.areas, p.topos))
    assert by_area["3"].tombstoned_nodes == frozenset({"c5"})
    assert by_area["1"].slot_changed is None and by_area["2"].slot_changed is None


# ---------------------------------------------------------------------------
# the planner with force_reset / trust_layout
# ---------------------------------------------------------------------------


def _plan_ticks(wd, name):
    if name == "leave":
        wd.leave("0", "node10")
    elif name == "root_neighbour_leave":
        wd.leave("0", "node1")
    elif name in ("rejoin", "replacement", "replacement_weight"):
        wd.leave("0", "node10")
        yield
        if name == "rejoin":
            wd.rejoin("0", "node10")
        else:
            wd.replace("0", "node10", "node77")
            if name == "replacement_weight":
                wd.set_metric("0", "node77", 0, 3)
    yield


@pytest.mark.parametrize(
    "name", ["leave", "root_neighbour_leave", "rejoin", "replacement", "replacement_weight"]
)
def test_plan_generation_delta_trusted_matches_reference(name):
    ref = _ref()
    wd, _ps = grid(ref)
    encs = cold(wd)
    for _ in _plan_ticks(wd, name):
        # the previous generation's cold distances
        old_r, old_p = encs
        dist = dense_tables(old_p)[0]
        encs, reason = slot_patch(wd, encs)
        assert reason is None
        new_r, new_p = encs
        for trust in (True, False):
            force_r = new_r.slot_changed if trust else None
            force_p = new_p.slot_changed if trust else None
            root = old_p.node_id("node0")
            want = ref.repair.plan_generation_delta(
                old_r, root, dist, new_r, force_reset=force_r, trust_layout=trust
            )
            got = plan_generation_delta(
                old_p, root, dist, new_p, force_reset=force_p, trust_layout=trust
            )
            assert (got is None) == (want is None), trust
            if want is None:
                continue
            assert np.array_equal(got.reset, want.reset)
            assert np.array_equal(got.sub_edges, want.sub_edges)
            for f in ("lanes_compatible", "est_depth", "num_reset", "num_perturbed_edges",
                      "has_improvements"):
                assert getattr(got, f) == getattr(want, f), (trust, f)
            if trust:
                # the forced slots are in the reset set, the root never
                forced = np.nonzero(new_p.slot_changed)[0]
                assert got.reset[forced[forced != root]].all() and not got.reset[root]
    # a rename is a structural delta to the untrusting planner
    if name.startswith("replacement"):
        assert plan_generation_delta(old_p, root, dist, new_p) is None


def test_plan_defaults_keep_the_structural_decline():
    """Without trust a cold re-encode after a leave (other symbol tables)
    stays a structural delta for both packages."""
    ref = _ref()
    wd, _ps = grid(ref)
    old = cold(wd)
    dist = dense_tables(old[1])[0]
    wd.leave("0", "node10")
    new = cold(wd)
    root = old[1].node_id("node0")
    assert ref.repair.plan_generation_delta(old[0], root, dist, new[0]) is None
    assert plan_generation_delta(old[1], root, dist, new[1]) is None


# ---------------------------------------------------------------------------
# the backend: seeded membership churn against TpuBackend, cold and scalar
# ---------------------------------------------------------------------------


def counters_of(be, rounds=True):
    """The path counters, the warm plan's size and (``rounds``: the plain
    versions' and the reference's, not the hand kernels') the warm solve's
    rounds."""
    out = {name: getattr(be, name) for name in COUNTERS}
    if rounds:
        out["warm_last_rounds"] = be.warm_last_rounds
    out["warm_class_builds"] = dict(be._warm_class_builds)
    out["warm_class_fallbacks"] = dict(be._warm_class_fallbacks)
    out["slot_declines"] = dict(be._slot_decline_reasons)
    return out


def churn_sweep(ref, generations, seed, device="cpu"):
    """Seeded leaves, rejoins, replacements and weight changes on the 4x4
    grid, each tick with Decision's hints.  Every generation the port's
    warm backend must equal a cold port backend and the port's scalar
    solver, and on the CPU the reference's warm backend (RouteDb, changed
    set, path counters) and scalar solver.  Returns the warm backend."""
    wd, ps = grid(ref)
    me = wd.me
    warm = port_backend(me, device=device)
    cold_be = port_backend(me, device=device, warm_rebuild=False)
    tpu = ref.backend(me) if ref is not None else None
    warm.build_route_db(wd.port, ps.port, force_full=True)
    cold_be.build_route_db(wd.port, ps.port, force_full=True)
    if tpu is not None:
        tpu.build_route_db(wd.ref, ps.ref, force_full=True)
    rng = np.random.default_rng(seed)
    down = []
    for gen in range(generations):
        op = int(rng.integers(4))
        changed = set()
        structural = False
        alive = sorted(n for n in wd.adj["0"] if wd.port["0"].has_node(n))
        if op == 0 and len(down) < 3:
            victim = alive[1 + int(rng.integers(len(alive) - 1))]  # never node0
            wd.leave("0", victim)
            down.append(victim)
            structural = True
        elif op == 1 and down:
            wd.rejoin("0", down.pop(0))
            structural = True
        elif op == 2 and down:
            # the first node down leaves for good: a new name takes its slot
            new = f"new{gen}"
            wd.replace("0", down.pop(0), new)
            changed |= ps.add(new, "0", f"10.9.{gen}.0/24")
            structural = True
        else:
            victim = alive[int(rng.integers(len(alive)))]
            db = wd.adj["0"][victim]
            k = int(rng.integers(len(db.adjacencies)))
            wd.set_metric("0", victim, k, 1 + (db.adjacencies[k].metric % 3))
        hints = dict(changed_prefixes=changed, force_full=True,
                     warm_delta=not structural, structural_delta=structural)
        db_w = warm.build_route_db(wd.port, ps.port, **hints)
        want = route_db_summary(SpfSolver(me).build_route_db(wd.port, ps.port))
        assert route_db_summary(db_w) == want, gen
        assert route_db_summary(cold_be.build_route_db(wd.port, ps.port, **hints)) == want, gen
        got_changed = warm.take_last_changed_prefixes()
        if tpu is not None:
            db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
            want_ref = ref.summary(ref.SpfSolver(me).build_route_db(wd.ref, ps.ref))
            assert ref.summary(db_t) == want_ref and route_db_summary(db_w) == want_ref, gen
            assert got_changed == tpu.take_last_changed_prefixes(), gen
            assert counters_of(warm) == counters_of(tpu), gen
    return warm


@pytest.mark.parametrize("seed", [12, 5])
def test_seeded_membership_churn_warm_cold_scalar_parity(seed):
    warm = churn_sweep(_ref(), generations=16, seed=seed)
    # the warm path engaged: slot patches and structural warm builds, no
    # cold fallback
    assert warm._warm_class_builds["structural"] >= 4
    assert warm.num_encode_slot_patches >= 4
    assert warm.num_warm_cold_fallbacks == 0
    assert warm._warm_class_fallbacks["structural"] == 0


def test_multi_area_leave_rejoin_matches_reference():
    """The 3-area world: a leave in one area and its rejoin, structural
    hints, then a weight change: the port equals TpuBackend."""
    ref = _ref()
    wd, ps = three_areas(ref)
    port = port_backend(wd.me)
    tpu = ref.backend(wd.me)
    port.build_route_db(wd.port, ps.port, force_full=True)
    tpu.build_route_db(wd.ref, ps.ref, force_full=True)
    for tick in ("leave", "rejoin", "weight"):
        if tick == "leave":
            wd.leave("3", "c5")
        elif tick == "rejoin":
            wd.rejoin("3", "c5")
        else:
            wd.set_metric("1", "a5", 0, 4)
        hints = dict(changed_prefixes=set(), force_full=True,
                     structural_delta=tick != "weight", warm_delta=tick == "weight")
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        want = ref.summary(ref.SpfSolver(wd.me).build_route_db(wd.ref, ps.ref))
        assert ref.summary(db_t) == want and route_db_summary(db_p) == want, tick
        assert port.take_last_changed_prefixes() == tpu.take_last_changed_prefixes(), tick
        assert counters_of(port) == counters_of(tpu), tick
    # the rejoin left no tombstone, so the weight tick takes the perturbation patch
    assert port.num_encode_slot_patches == 2 and port.num_encode_patches == 1
    assert port._warm_class_builds["structural"] == 2


def test_structural_selective_patch_object_identity():
    """A far corner leaving: the warm-selective path re-selects only the
    affected rows, and every other route is the previous object."""
    ref = _ref()
    wd, ps = grid(ref)
    port = port_backend(wd.me)
    tpu = ref.backend(wd.me)
    db0 = port.build_route_db(wd.port, ps.port, force_full=True)
    tpu.build_route_db(wd.ref, ps.ref, force_full=True)
    wd.leave("0", "node15")
    hints = dict(changed_prefixes=set(), force_full=True, structural_delta=True)
    db1 = port.build_route_db(wd.port, ps.port, **hints)
    tpu.build_route_db(wd.ref, ps.ref, **hints)
    assert port._warm_class_builds["structural"] == 1 and port.num_warm_selective_builds == 1
    changed = port.take_last_changed_prefixes()
    assert changed == tpu.take_last_changed_prefixes()
    assert "10.8.1.0/24" not in changed
    for p, e in db1.unicast_routes.items():
        if p not in changed:
            assert db0.unicast_routes[p] is e, p
    assert "10.8.15.0/24" in db1.unicast_routes  # node12's anycast copy
    assert db1.unicast_routes["10.8.15.0/24"] is not db0.unicast_routes["10.8.15.0/24"]


def test_purge_on_suspicion_still_forces_cold_after_structural():
    """Injected corruption after a structural warm build purges the
    context; the next structural tick solves cold (counted no_context), and
    the one after it warms again."""
    ref = _ref()
    wd, ps = grid(ref)
    port = port_backend(wd.me)
    tpu = ref.backend(wd.me)
    hints = dict(changed_prefixes=set(), force_full=True, structural_delta=True)

    def tick():
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        want = ref.summary(ref.SpfSolver(wd.me).build_route_db(wd.ref, ps.ref))
        assert ref.summary(db_t) == want and route_db_summary(db_p) == want
        assert counters_of(port) == counters_of(tpu)

    port.build_route_db(wd.port, ps.port, force_full=True)
    tpu.build_route_db(wd.ref, ps.ref, force_full=True)
    wd.leave("0", "node15")
    tick()
    assert port._warm_class_builds["structural"] == 1
    for be in (port, tpu):
        be.inject_silent_corruption(True)
    assert port._warm_ctx is None
    for be in (port, tpu):
        be.inject_silent_corruption(False)
    wd.rejoin("0", "node15")
    tick()
    assert port._warm_class_fallbacks["structural"] == 1
    assert port._warm_class_fallback_reasons["structural"] == {"no_context": 1}
    wd.leave("0", "node12")
    tick()
    assert port._warm_class_builds["structural"] == 2


def test_unhinted_replacement_tick_re_decodes_renamed_slot():
    """Unhinted ticks (no delta class) take the delta selection: a leave,
    then a replacement on the freed slot.  The delta base shares the
    layout, so the renamed slot must reach the kernel's changed-node mask;
    the routes then name the replacement, as the reference's and the
    scalar solver's do."""
    ref = _ref()
    wd, ps = grid(ref)
    port = port_backend(wd.me)
    tpu = ref.backend(wd.me)
    seen = []
    select_delta = port._select_delta

    def spy(*args):
        seen.append(args[-2].numpy().copy())  # node_changed [A, V]
        return select_delta(*args)

    port._select_delta = spy
    port.build_route_db(wd.port, ps.port, force_full=True)
    tpu.build_route_db(wd.ref, ps.ref, force_full=True)
    slot1 = port._last_enc.topos[0].node_id("node1")
    unhinted = dict(changed_prefixes=set(), force_full=True)
    for tick in ("leave", "replace"):
        if tick == "leave":
            wd.leave("0", "node1")
            changed = set()
        else:
            wd.replace("0", "node1", "node70")
            changed = ps.add("node70", "0", "10.8.70.0/24")
        hints = dict(unhinted, changed_prefixes=changed)
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        want = ref.summary(ref.SpfSolver(wd.me).build_route_db(wd.ref, ps.ref))
        assert ref.summary(db_t) == want and route_db_summary(db_p) == want, tick
        assert port.take_last_changed_prefixes() == tpu.take_last_changed_prefixes(), tick
        assert counters_of(port) == counters_of(tpu), tick
        assert port.num_encode_slot_patches == (1 if tick == "leave" else 2)
        assert seen[-1][0, slot1], tick  # the slot is a changed node
    assert port.num_delta_builds == 2
    assert port._last_enc.topos[0].node_id("node70") == slot1
    via = {nh.neighbor_node_name for e in db_p.unicast_routes.values() for nh in e.nexthops}
    assert "node70" in via and "node1" not in via


@pytest.mark.parametrize("node", ["node15", "node1"])
def test_segment_form_encoding_bit_parity(node, monkeypatch):
    """The counterpart of the reference's kernel-preference test, chosen by
    the encoding and not by a setting: with the dense layout declined (the
    in-degree buckets cut to 2), the backend solves over the segment form
    (kernel 14's plain version at one row) and gives the dense backend's
    RouteDb, cold and across a structural warm tick on that encoding."""
    ref = _ref()
    wd, ps = grid(ref)
    dense_be = port_backend(wd.me)
    seg_be = port_backend(wd.me)
    calls = []
    segment_tables = seg_be._segment_tables
    seg_be._segment_tables = lambda *a: calls.append(1) or segment_tables(*a)
    want = ref.summary(ref.SpfSolver(wd.me).build_route_db(wd.ref, ps.ref))
    db_d = dense_be.build_route_db(wd.port, ps.port, force_full=True)
    with monkeypatch.context() as m:
        m.setattr(csr, "IN_DEGREE_BUCKETS", (2,))
        db_s = seg_be.build_route_db(wd.port, ps.port, force_full=True)
    assert dense_be._last_enc.has_dense and not seg_be._last_enc.has_dense
    assert route_db_summary(db_d) == route_db_summary(db_s) == want
    assert calls == [1]
    wd.leave("0", node)
    hints = dict(changed_prefixes=set(), force_full=True, structural_delta=True)
    db_d2 = dense_be.build_route_db(wd.port, ps.port, **hints)
    db_s2 = seg_be.build_route_db(wd.port, ps.port, **hints)
    want = ref.summary(ref.SpfSolver(wd.me).build_route_db(wd.ref, ps.ref))
    assert route_db_summary(db_d2) == route_db_summary(db_s2) == want
    assert not seg_be._last_enc.has_dense
    assert seg_be.num_encode_slot_patches == dense_be.num_encode_slot_patches == 1
    assert seg_be._warm_class_builds["structural"] == dense_be._warm_class_builds["structural"] == 1


def test_counter_snapshot_and_status_after_declines_match_reference():
    """Both declines counted (``slot_decline.*``), the slot-patch gauge, and
    ``node_resilience_status``'s warm section: the reference's keys and
    values."""
    ref = _ref()
    wd, ps = grid(ref)
    port = port_backend(wd.me)
    tpu = ref.backend(wd.me)
    hints = dict(changed_prefixes=set(), force_full=True, structural_delta=True)
    port.build_route_db(wd.port, ps.port, force_full=True)
    tpu.build_route_db(wd.ref, ps.ref, force_full=True)

    def same():
        got, want = port.counter_snapshot(), tpu.counter_snapshot()
        for k, v in want.items():
            if k.startswith(("decision.backend.warm_encode", "decision.backend.slot_decline")):
                assert got[k] == v, k
        assert {k for k in got if "slot" in k} == {k for k in want if "slot" in k}

    wd.leave("0", "node15")
    for step in ("leave", "exhaustion", "new_link"):
        if step == "exhaustion":
            # node15's slot is free, but two new names arrive
            for name in ("nodeX", "nodeY"):
                wd.adj["0"][name] = ttypes.AdjacencyDatabase(this_node_name=name, area="0")
                wd.add_link("0", name, "node14")
        elif step == "new_link":
            wd.add_link("0", "node5", "node10")
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        assert route_db_summary(db_p) == ref.summary(db_t), step
        same()
    assert port._slot_decline_reasons == {"slot_exhaustion": 1, "new_link": 1}
    snap = port.counter_snapshot()
    assert snap["decision.backend.warm_encode_slot_patches"] == 1.0
    assert snap["decision.backend.slot_decline.new_link"] == 1.0
    def node(be):
        return types.SimpleNamespace(
            name="node0", fib=types.SimpleNamespace(),
            decision=types.SimpleNamespace(backend=be),
        )

    got = port_resilience.node_resilience_status(node(port))
    want = ref.resilience.node_resilience_status(node(tpu))
    assert got["warm"] == want["warm"]
    assert got["warm"]["slot_declines"] == {"new_link": 1, "slot_exhaustion": 1}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_membership_churn_sweep_on_card():
    """The seeded sweep with the hand kernels: every generation equals the
    port's scalar solver and a cold backend on the card, the warm kernels
    launched, and the path counters equal the CPU sweep's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    reset_launch_counts()
    card = churn_sweep(None, generations=16, seed=12, device="cuda")
    host = churn_sweep(None, generations=16, seed=12, device="cpu")
    assert counters_of(card, rounds=False) == counters_of(host, rounds=False)
    assert card._warm_class_builds["structural"] >= 4 and card.num_warm_cold_fallbacks == 0
    assert LAUNCHES["warm_spf_distances"] or LAUNCHES["warm_subgraph_repair"]
    assert LAUNCHES["dense_spf_distances"] and LAUNCHES["multi_area_select_from_tables"]
