"""The port's warm topology tick against the JAX package, exactly.

* ``ops/csr.py`` ``patch_encoded_multi_area_slots`` on a perturbation:
  kind ``patch``, array for array against the reference's
  ``patch_encoded_multi_area``, layout arrays shared with the previous
  encoding; on membership churn and an area change, the reference's kinds.
* ``ops/repair.py`` ``plan_generation_delta``: the same reset set, lane
  compatibility, improvement flag and sub-edge list, and None where the
  reference declines.
* the plain ``warm_spf_one`` / ``warm_subgraph_repair`` against the JAX
  kernels ``warm_multi_area_spf_tables`` / ``warm_multi_area_subgraph_tables``,
  fed the same numpy inputs: the reference's cold tables as the previous
  generation and its planner's reset / lane_keep masks; both must also
  equal a cold solve of the new topology, and the reset-semantics lanes
  must reach it from any seed.
* ``CudaBackend`` (CPU) through a seeded churn sweep — metric
  perturbations and overload flips, prefix churn on the same tick,
  withdrawals, prefix-only ticks and unhinted ticks — against
  ``TpuBackend(warm_rebuild=True)``, ``ScalarBackend`` and a full scalar
  ``SpfSolver`` build: the same RouteDb, changed set and path counters
  every generation, and every route outside the changed set the previous
  RouteDb's object.

Tolerance: exact equality throughout (integral metrics keep every f32 sum
exact and the fixed points are unique).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openr_tpu.config import ResilienceConfig
from openr_tpu.decision.backend import DEGREE_BUCKETS, ScalarBackend, TpuBackend
from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.prefix_state import PrefixState
from openr_tpu.decision.rib import route_db_summary as ref_summary
from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.emulation.topology import (
    build_adj_dbs,
    grid_edges,
    random_connected_edges,
)
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops import repair as jrepair
from openr_tpu.ops import route_select as jrs
from openr_tpu.types import PrefixEntry
from openr_tpu_torch import types as ttypes
from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.link_state import LinkState as PortLinkState
from openr_tpu_torch.decision.prefix_state import PrefixState as PortPrefixState
from openr_tpu_torch.decision.rib import route_db_summary as port_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from openr_tpu_torch.interop import tables_from_numpy
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import repair as trepair
from openr_tpu_torch.ops import spf as tspf

PHASES = {"encode", "spf", "select", "decode", "total"}


class World:
    """One LSDB held twice, by the reference's and the port's LinkStates,
    mutated in lockstep (the port's copy through the wire format)."""

    def __init__(self, area_edges, me, drains=None):
        self.me = me
        self.adj = {}
        self.ref = {}
        self.port = {}
        for area, edges in area_edges.items():
            self.adj[area] = build_adj_dbs(edges, area=area, **(drains or {}).get(area, {}))
            self.ref[area] = LinkState(area, me)
            self.port[area] = PortLinkState(area, me)
            for db in self.adj[area].values():
                self._apply(area, db)

    def _apply(self, area, db):
        self.ref[area].update_adjacency_database(db)
        self.port[area].update_adjacency_database(
            ttypes.AdjacencyDatabase.from_wire(db.to_wire())
        )

    def set_metric(self, area, node, k, metric):
        db = self.adj[area][node]
        db.adjacencies[k].metric = metric
        self._apply(area, db)

    def flip_overload(self, area, node):
        db = self.adj[area][node]
        db.is_overloaded = not db.is_overloaded
        self._apply(area, db)

    def delete_node(self, area, node):
        self.ref[area].delete_adjacency_database(node)
        self.port[area].delete_adjacency_database(node)

    def perturb(self, rng, area="0"):
        nodes = sorted(self.adj[area])
        node = nodes[int(rng.integers(len(nodes)))]
        db = self.adj[area][node]
        k = int(rng.integers(len(db.adjacencies)))
        self.set_metric(area, node, k, 1 + (db.adjacencies[k].metric % 3))

    def encodings(self):
        return (
            jcsr.encode_multi_area(self.ref, self.me),
            tcsr.encode_multi_area(self.port, self.me),
        )


def grid_world(side=4):
    return World({"0": grid_edges(side)}, "node0")


def multiarea_world():
    """Three areas: a random graph with a drained node, a ring, and an
    area where me has no adjacencies (its root row has no in-edges)."""
    ring = [(f"b{i}", f"b{(i + 1) % 6}", 1) for i in range(6)]
    return World(
        {
            "1": random_connected_edges(12, 8, seed=5, prefix="a") + [("a0", "me", 1)],
            "2": ring + [("b0", "me", 2), ("b3", "me", 3)],
            "3": [("w0", "w1", 1), ("w1", "w2", 2)],
        },
        "me",
        drains={"1": {"overloaded": ["a4"]}, "2": {"soft_drained": {"b2": 5}}},
    )


def jax_cold(enc):
    D = jcsr.bucket_for(max(enc.max_out_degree(), 1), DEGREE_BUCKETS)
    d, n = jrs.multi_area_spf_tables_dense(
        *(
            jnp.asarray(getattr(enc, f))
            for f in ("in_src", "in_w", "in_ok", "in_rank", "in_has", "overloaded", "roots")
        ),
        max_degree=D,
    )
    return np.array(d), np.array(n), D


# -- the encode patch ----------------------------------------------------

TOPO_FIELDS = (
    "src", "dst", "w", "edge_ok", "overloaded", "soft", "link_index",
    "link_edge_pos", "in_src", "in_w", "in_ok", "in_rank", "in_edge_pos", "in_has",
)
STACKED_FIELDS = (
    "src", "dst", "w", "edge_ok", "overloaded", "soft", "roots",
    "in_src", "in_w", "in_ok", "in_rank", "in_has",
)


def assert_encodings_equal(ref, port):
    assert port.areas == ref.areas
    for name in STACKED_FIELDS:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for rt, pt in zip(ref.topos, port.topos):
        assert pt.id_to_node == rt.id_to_node
        assert pt.padded_edges == rt.padded_edges
        assert [l.key for l in pt.links] == [l.key for l in rt.links]
        for name in TOPO_FIELDS:
            a, b = getattr(rt, name), getattr(pt, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("world", ["grid", "multiarea"])
def test_patch_encoded_multi_area_matches_reference(world):
    wd = grid_world() if world == "grid" else multiarea_world()
    ref0, port0 = wd.encodings()
    assert_encodings_equal(ref0, port0)
    # metric churn on every adjacency of one node, and an overload flip
    area = sorted(wd.adj)[0]
    node = sorted(wd.adj[area])[5]
    for k in range(len(wd.adj[area][node].adjacencies)):
        wd.set_metric(area, node, k, 4)
    wd.flip_overload(area, sorted(wd.adj[area])[2])
    ref = jcsr.patch_encoded_multi_area(ref0, wd.ref, wd.me)
    port, kind, reason = tcsr.patch_encoded_multi_area_slots(port0, wd.port, wd.me)
    assert ref is not None and (kind, reason) == ("patch", None)
    assert_encodings_equal(ref, port)
    # the layout arrays are the previous encoding's own objects
    assert port.src is port0.src and port.in_src is port0.in_src
    assert port.topos[0].link_index is port0.topos[0].link_index
    # and the patch equals a cold encode of the new LSDB
    assert_encodings_equal(jcsr.encode_multi_area(wd.ref, wd.me), port)
    # membership churn declines the perturbation patch in both, and both
    # take the slot patch; an area change goes cold in both
    wd.delete_node(area, sorted(wd.adj[area])[-1])
    assert jcsr.patch_encoded_multi_area(ref, wd.ref, wd.me) is None
    want = jcsr.patch_encoded_multi_area_slots(ref, wd.ref, wd.me)
    got = tcsr.patch_encoded_multi_area_slots(port, wd.port, wd.me)
    assert want[1:] == got[1:] == ("slot", None)
    assert_encodings_equal(want[0], got[0])
    fewer = dict(list(wd.port.items())[1:])
    assert tcsr.patch_encoded_multi_area_slots(port, fewer, wd.me) == (None, "cold", "area_change")
    fewer_ref = dict(list(wd.ref.items())[1:])
    assert jcsr.patch_encoded_multi_area_slots(ref, fewer_ref, wd.me)[1:] == ("cold", "area_change")


# -- the generation-delta planner ----------------------------------------


def _weaken(wd):
    wd.set_metric("0", "node5", 0, 7)


def _improve(wd):
    wd.set_metric("0", "node5", 0, 7)
    return "reencode"  # improve from the weakened generation


def _overload(wd):
    wd.flip_overload("0", "node6")


def _mixed(wd):
    wd.set_metric("0", "node9", 1, 3)
    wd.flip_overload("0", "node2")
    wd.set_metric("0", "node0", 0, 2)


def _structural(wd):
    wd.delete_node("0", "node15")


DELTAS = {
    "weaken": _weaken,
    "improve": _improve,
    "overload": _overload,
    "mixed_root_lane": _mixed,
    "structural": _structural,
}


def _delta_pair(name, side=4):
    """(reference old enc, port old enc, reference new enc, port new enc)."""
    wd = grid_world(side)
    if DELTAS[name](wd) == "reencode":
        ref_old, port_old = wd.encodings()
        wd.set_metric("0", "node5", 0, 1)
    else:
        ref_old, port_old = grid_world(side).encodings()
    ref_new, port_new = wd.encodings()
    return ref_old, port_old, ref_new, port_new


@pytest.mark.parametrize("name", sorted(DELTAS))
def test_plan_generation_delta_matches_reference(name):
    ref_old, port_old, ref_new, port_new = _delta_pair(name)
    dist, _nh, _D = jax_cold(ref_old)
    root = int(ref_old.roots[0])
    want = jrepair.plan_generation_delta(ref_old.topos[0], root, dist[0], ref_new.topos[0])
    got = trepair.plan_generation_delta(port_old.topos[0], root, dist[0], port_new.topos[0])
    if name == "structural":
        assert want is None and got is None
        return
    assert want is not None and got is not None
    assert np.array_equal(got.reset, want.reset)
    assert got.lanes_compatible == want.lanes_compatible
    assert got.has_improvements == want.has_improvements
    assert np.array_equal(got.sub_edges, want.sub_edges)
    assert got.sub_edges.dtype == want.sub_edges.dtype
    assert (got.est_depth, got.num_reset, got.num_perturbed_edges) == (
        want.est_depth, want.num_reset, want.num_perturbed_edges,
    )
    if name == "weaken":
        assert got.num_reset > 0 and not got.has_improvements
    if name == "improve":
        assert got.has_improvements and got.num_reset == 0


def test_plan_generation_delta_matches_reference_on_random_8x8_churn():
    rng = np.random.default_rng(5)
    wd = grid_world(8)
    for _ in range(6):
        ref_old, port_old = wd.encodings()
        dist, _nh, _D = jax_cold(ref_old)
        wd.perturb(rng)
        if rng.random() < 0.5:
            wd.flip_overload("0", f"node{int(rng.integers(64))}")
        ref_new, port_new = wd.encodings()
        want = jrepair.plan_generation_delta(ref_old.topos[0], 0, dist[0], ref_new.topos[0])
        got = trepair.plan_generation_delta(port_old.topos[0], 0, dist[0], port_new.topos[0])
        assert np.array_equal(got.reset, want.reset)
        assert np.array_equal(got.sub_edges, want.sub_edges)
        assert (got.lanes_compatible, got.has_improvements) == (
            want.lanes_compatible, want.has_improvements,
        )


# -- the warm SPF tables -------------------------------------------------

SEG_FIELDS = ("src", "dst", "w", "edge_ok", "overloaded", "roots")


def _warm_inputs(ref_old, ref_new):
    """The previous generation's JAX cold tables and the reference
    planner's masks, for the JAX kernels and the port's plain versions
    alike."""
    prev_dist, prev_nh, D = jax_cold(ref_old)
    plans = [
        jrepair.plan_generation_delta(ot, int(ref_new.roots[ai]), prev_dist[ai], nt)
        for ai, (ot, nt) in enumerate(zip(ref_old.topos, ref_new.topos))
    ]
    reset = np.stack([p.reset for p in plans])
    lane_keep = np.asarray([p.lanes_compatible for p in plans], bool)
    return prev_dist, prev_nh, D, plans, reset, lane_keep


def _multiarea_pair(kind):
    old = multiarea_world()
    wd = multiarea_world()
    if kind == "weaken":
        wd.set_metric("1", "a3", 0, 9)
        wd.set_metric("2", "b1", 0, 4)
    else:
        wd.flip_overload("1", "a4")  # clears the drain: an improvement
        wd.set_metric("2", "b0", 0, 1)
    return old.encodings()[0], wd.encodings()[0]


WARM_PAIRS = [
    "grid4_improve", "grid4_mixed_root_lane", "grid4_overload", "grid4_weaken",
    "grid8_random", "multiarea_improve", "multiarea_weaken",
]


def _warm_pair(name):
    """(reference old encoding, reference new encoding) of one delta."""
    world, kind = name.split("_", 1)
    if world == "grid4":
        ref_old, _p, ref_new, _q = _delta_pair(kind)
        return ref_old, ref_new
    if world == "multiarea":
        return _multiarea_pair(kind)
    rng = np.random.default_rng(9)
    wd = grid_world(8)
    ref_old = wd.encodings()[0]
    for _ in range(3):
        wd.perturb(rng)
    return ref_old, wd.encodings()[0]


@pytest.mark.parametrize("pair", WARM_PAIRS)
def test_warm_tables_match_reference_and_cold(pair):
    ref_old, ref_new = _warm_pair(pair)
    prev_dist, prev_nh, D, _plans, reset, lane_keep = _warm_inputs(ref_old, ref_new)
    seg = [getattr(ref_new, f) for f in SEG_FIELDS]
    want = jrs.warm_multi_area_spf_tables(
        *(jnp.asarray(a) for a in seg),
        jnp.asarray(prev_dist), jnp.asarray(prev_nh), jnp.asarray(reset),
        jnp.asarray(lane_keep), max_degree=D,
    )
    got = tspf.warm_spf_one(
        *tables_from_numpy(seg + [prev_dist, prev_nh, reset, lane_keep]), D
    )
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int8
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    cold_d, cold_n, _ = jax_cold(ref_new)
    assert np.array_equal(got[0].numpy(), cold_d)
    assert np.array_equal(got[1].numpy(), cold_n)
    if pair.startswith("multiarea"):
        assert (cold_n == -128).any()  # the isolated area's root row


@pytest.mark.parametrize("seed", ["zero", "random"])
@pytest.mark.parametrize("pair", WARM_PAIRS)
def test_reset_lanes_reach_cold_from_any_seed(pair, seed):
    """Reset semantics replace every lane each round, so the fixed point
    does not depend on the seed: an all-zero seed and a random int8 seed
    (neither of them the answer) both end at the cold lanes."""
    ref_old, ref_new = _warm_pair(pair)
    cold_d, cold_n, D = jax_cold(ref_new)
    if seed == "zero":
        nh0 = np.zeros_like(cold_n)
    else:
        rng = np.random.default_rng(5)
        nh0 = rng.choice(np.array([-128, 0, 1], np.int8), size=cold_n.shape)
    assert not np.array_equal(nh0, cold_n)
    seg = tables_from_numpy([getattr(ref_new, f) for f in SEG_FIELDS])
    (dist,) = tables_from_numpy([cold_d])
    (nh0_t,) = tables_from_numpy([nh0])
    got, _rounds = tspf.spf_nexthop_lanes_reset(*seg, dist, nh0_t, D)
    assert np.array_equal(got.numpy(), cold_n)


@pytest.mark.parametrize("pair", [p for p in WARM_PAIRS if "weaken" in p])
def test_subgraph_repair_matches_reference_and_cold(pair):
    ref_old, ref_new = _warm_pair(pair)
    prev_dist, prev_nh, D, plans, reset, _lane_keep = _warm_inputs(ref_old, ref_new)
    assert all(not p.has_improvements and p.lanes_compatible for p in plans)
    sub = TpuBackend._pack_sub_edges(None, ref_new, plans)
    port_sub = CudaBackend._pack_sub_edges(None, ref_new, plans)
    # the reference pads to a bucket; the port packs the largest area's
    # count exactly, with the same pad rule for shorter areas
    es = max(len(p.sub_edges) for p in plans)
    assert es > 0
    for a, b in zip(sub, port_sub):
        assert a.dtype == b.dtype and b.shape == (len(plans), es)
        assert np.array_equal(a[:, :es], b)
    want = jrs.warm_multi_area_subgraph_tables(
        *(jnp.asarray(a) for a in sub),
        jnp.asarray(prev_dist), jnp.asarray(prev_nh), jnp.asarray(reset),
        max_degree=D,
    )
    got = tspf.warm_subgraph_repair(
        *tables_from_numpy(list(port_sub) + [prev_dist, prev_nh, reset]), D
    )
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    cold_d, cold_n, _ = jax_cold(ref_new)
    assert np.array_equal(got[0].numpy(), cold_d)
    assert np.array_equal(got[1].numpy(), cold_n)


def test_subgraph_repair_reset_vertex_without_sub_edges_holds_int8_min():
    """A reset vertex with no sub-edge ends at -128 lanes, as the
    reference's empty segment does; pads ride the last dst's segment."""
    V, D = 6, 4
    src = np.array([[0, 1, 0, 0]], np.int32)
    dst = np.array([[1, 2, 2, 2]], np.int32)  # two pads after the real edges
    w = np.array([[1, 1, np.inf, np.inf]], np.float32)
    ok = np.array([[True, True, False, False]])
    rank = np.array([[0, -1, -1, -1]], np.int32)
    prev_dist = np.array([[0, 1, 2, 9, 3e38, 3e38]], np.float32)
    prev_nh = np.zeros((1, V, D), np.int8)
    prev_nh[0, 1:4, 0] = 1
    reset = np.array([[False, True, True, True, False, False]])
    args = [src, dst, w, ok, rank, prev_dist, prev_nh, reset]
    want = jrs.warm_multi_area_subgraph_tables(*(jnp.asarray(a) for a in args), max_degree=D)
    got = tspf.warm_subgraph_repair(*tables_from_numpy(args), D)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy()[0, 3] == -128).all()


# -- the backend churn sweep ---------------------------------------------

COUNTERS = (
    "num_incremental_builds",
    "num_warm_builds",
    "num_warm_selective_builds",
    "num_warm_subgraph_builds",
    "num_warm_cold_fallbacks",
    "num_delta_builds",
    "num_encode_patches",
    "num_device_builds",
)


class Prefixes:
    """PrefixState held twice, like World."""

    def __init__(self):
        self.ref = PrefixState()
        self.port = PortPrefixState()

    def add(self, node, area, entry):
        self.ref.update_prefix(node, area, entry)
        self.port.update_prefix(node, area, ttypes.PrefixEntry.from_wire(entry.to_wire()))
        return {entry.prefix}

    def withdraw(self, node, area, prefix):
        self.ref.delete_prefix(node, area, prefix)
        self.port.delete_prefix(node, area, prefix)
        return {prefix}


def sweep(wd, ps, adverts, generations, seed, warm=True):
    """Drive both backends through the seeded tick mix; returns the port
    backend after checking every generation."""
    me = wd.me
    tpu = TpuBackend(
        SpfSolver(me), resilience=ResilienceConfig(enabled=False), warm_rebuild=warm
    )
    scalar = ScalarBackend(SpfSolver(me))
    port = CudaBackend(PortSolver(me), device="cpu", warm_rebuild=warm)
    area = sorted(wd.adj)[0]
    nodes = sorted(wd.adj[area])
    rng = np.random.default_rng(seed)
    hints = dict(force_full=True)
    prev_db = None
    drained = []
    for gen in range(generations):
        kind = gen % 6
        changed = set()
        if kind in (0, 3, 5):
            wd.perturb(rng, area)
        if kind == 1 and drained:  # an undrain: an improvement
            wd.flip_overload(area, drained.pop())
        elif kind in (1, 4):  # a drain of a node other than me
            free = [n for n in nodes if n != me and n not in drained]
            drained.append(free[int(rng.integers(len(free)))])
            wd.flip_overload(area, drained[-1])
        if kind in (0, 2):  # a new prefix, on the same tick as churn or alone
            node = nodes[int(rng.integers(len(nodes)))]
            p = f"10.99.{gen}.0/24"
            changed |= ps.add(node, area, PrefixEntry(p))
            adverts.append((node, p))
        if kind in (2, 4, 5):  # a withdrawal
            node, p = adverts.pop(int(rng.integers(len(adverts))))
            changed |= ps.withdraw(node, area, p)
        if gen > 0:
            hints = dict(
                changed_prefixes=changed,
                force_full=kind != 2,
                warm_delta=kind in (0, 1, 5),
            )
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        want = ref_summary(SpfSolver(me).build_route_db(wd.ref, ps.ref))
        assert ref_summary(scalar.build_route_db(wd.ref, ps.ref, **hints)) == want, gen
        assert ref_summary(db_t) == want, gen
        assert port_summary(db_p) == want, gen
        got_changed = port.take_last_changed_prefixes()
        assert got_changed == tpu.take_last_changed_prefixes(), gen
        for name in COUNTERS:
            assert getattr(port, name) == getattr(tpu, name), (gen, name)
        assert set(port.last_phase_ms) == PHASES
        if got_changed is not None and prev_db is not None:
            for p, e in db_p.unicast_routes.items():
                if p not in got_changed:
                    assert prev_db.unicast_routes[p] is e, (gen, p)
        prev_db = db_p
    return port


def grid_prefixes():
    ps = Prefixes()
    adverts = []
    for i in range(16):
        p = f"10.7.{i}.0/24"
        ps.add(f"node{i}", "0", PrefixEntry(p))
        adverts.append((f"node{i}", p))
    # anycast: two advertisers of one prefix
    ps.add("node12", "0", PrefixEntry("10.7.15.0/24"))
    return ps, adverts


def test_backend_churn_sweep_matches_tpu_backend_and_scalar():
    ps, adverts = grid_prefixes()
    port = sweep(grid_world(4), ps, adverts, generations=12, seed=11)
    # every steady-state path ran, the full-edge warm kernels included
    assert port.num_incremental_builds >= 2
    assert port.num_warm_selective_builds >= 2
    assert port.num_warm_subgraph_builds >= 1
    assert port.num_warm_builds > port.num_warm_subgraph_builds
    assert port.num_delta_builds >= 2
    assert port.num_encode_patches >= 8


def test_backend_churn_sweep_multiarea():
    wd = multiarea_world()
    ps = Prefixes()
    adverts = []
    for node in sorted(wd.adj["1"]):
        if node == "me":
            continue
        p = f"10.1.{node[1:]}.0/24"
        ps.add(node, "1", PrefixEntry(p))
        adverts.append((node, p))
    for area in ("2", "3"):
        for node in sorted(wd.adj[area]):
            if node != "me":
                ps.add(node, area, PrefixEntry(f"10.{area}.{node[1:]}.0/24"))
    ps.add("b1", "2", PrefixEntry("10.1.3.0/24"))  # anycast across areas
    port = sweep(wd, ps, adverts, generations=12, seed=4)
    assert port.num_delta_builds >= 1 and port.num_warm_selective_builds >= 1


def test_backend_churn_sweep_without_warm_rebuild():
    """warm_rebuild=False: no patch and no warm solve, so every topology
    tick re-encodes cold and the delta branch (which needs a layout-shared
    encoding chain) declines, as in the reference; the RouteDbs still
    match."""
    ps, adverts = grid_prefixes()
    port = sweep(grid_world(4), ps, adverts, generations=8, seed=11, warm=False)
    assert port.num_warm_builds == port.num_encode_patches == 0
    assert port.num_warm_cold_fallbacks == 0
    assert port.num_incremental_builds >= 1 and port.num_delta_builds == 0


@pytest.mark.parametrize("hint", ["structural_delta", "warm_delta"])
def test_membership_churn_solves_cold_with_the_same_route_db(hint):
    """A node leaving and rejoining: both packages slot-patch their encoding
    and warm-start from the surviving region (the test keeps its name from
    when the port re-encoded cold).  The RouteDbs, changed sets and path
    counters are the reference's."""
    wd = grid_world(4)
    ps, _adverts = grid_prefixes()
    me = wd.me
    tpu = TpuBackend(SpfSolver(me), resilience=ResilienceConfig(enabled=False))
    port = CudaBackend(PortSolver(me), device="cpu")
    for backend, ls, pstate in ((tpu, wd.ref, ps.ref), (port, wd.port, ps.port)):
        backend.build_route_db(ls, pstate, force_full=True)
    db15 = wd.adj["0"]["node15"]
    for tick in ("leave", "rejoin"):
        if tick == "leave":
            wd.delete_node("0", "node15")
        else:
            wd._apply("0", db15)
        hints = {"changed_prefixes": set(), "force_full": True, hint: True}
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        want = ref_summary(SpfSolver(me).build_route_db(wd.ref, ps.ref))
        assert ref_summary(db_t) == want and port_summary(db_p) == want, tick
        assert port.take_last_changed_prefixes() == tpu.take_last_changed_prefixes(), tick
        for name in COUNTERS + ("num_encode_slot_patches", "num_warm_cold_fallbacks"):
            assert getattr(port, name) == getattr(tpu, name), (tick, name)
    cls = "structural" if hint == "structural_delta" else "perturbation"
    assert port._warm_class_builds == tpu._warm_class_builds
    assert port._warm_class_builds[cls] == 2
    assert port.num_encode_slot_patches == 2 and port.num_encode_patches == 0
    assert port.num_warm_cold_fallbacks == 0
