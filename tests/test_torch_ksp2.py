"""KSP2_ED_ECMP on the port (on the CPU, through the plain kernel versions)
against the JAX package.

* ``batched_spf_distances_masked`` (kernel 15's plain version) and its set
  form against the reference's jitted function, on seeded worlds with
  random masks, a mask that cuts the root off, overloaded transit nodes
  and -1 pads; ``link_failure_batch`` against the reference's.
* ``Ksp2DeviceEngine``'s seeded k-th paths against the reference engine's
  and the scalar ``get_kth_paths``, in the same order, and its memo.
* ``CudaBackend(device="cpu")`` against ``TpuBackend`` and
  ``ScalarBackend`` on every world of ``tests/test_ksp2_device.py``, the
  multi-area KSP2 world of ``tests/test_multiarea_device.py`` and a
  256-node WAN with the chip run's prefix mix and ticks (path counters and
  changed sets too).
* ``DeviceBuildWhatIfEngine`` against the reference's and the port's
  ``GenericSolverWhatIfEngine``.

Tolerance: exact equality (integer metrics keep every f32 sum exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from openr_tpu.config import ResilienceConfig
from openr_tpu.decision.backend import TpuBackend
from openr_tpu.decision.ksp2 import Ksp2DeviceEngine as RefEngine
from openr_tpu.decision.link_state import LinkState
from openr_tpu.decision.rib import route_db_summary as ref_summary
from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.decision.whatif_api import DeviceBuildWhatIfEngine as RefDeviceBuild
from openr_tpu.emulation.topology import (
    _build_wan,
    build_adj_dbs,
    fabric_edges,
    grid_edges,
    random_connected_edges,
)
from openr_tpu.ops import csr as jcsr
from openr_tpu.ops.spf import batched_spf_distances_masked as jax_masked
from openr_tpu.types import (
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    PrefixMetrics,
)
from openr_tpu_torch.decision import whatif_api as twhatif
from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.ksp2 import Ksp2DeviceEngine
from openr_tpu_torch.decision.rib import route_db_summary as port_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from openr_tpu_torch.emulation import topology as ttopo
from openr_tpu_torch.interop import lsdb_from_wire, tables_from_numpy
from openr_tpu_torch.ops import csr as tcsr
from openr_tpu_torch.ops import spf as tspf
from tests.test_torch_backend import assert_three_way, make_ls, prefixes
from tests.test_torch_spf import lsdb_to_wire
from tests.test_torch_warm import COUNTERS, PHASES, Prefixes, World

KSP2 = PrefixForwardingAlgorithm.KSP2_ED_ECMP
SR_MPLS = PrefixForwardingType.SR_MPLS


def ksp2(prefix, **kw):
    return PrefixEntry(prefix, forwarding_algorithm=KSP2, **kw)


def port_lsdb(areas, ps, me):
    """The reference's LinkStates and PrefixState carried to the port."""
    return lsdb_from_wire(*lsdb_to_wire(areas, ps), my_node_name=me)


# -- kernel 15's plain version and its set form ------------------------------


def masked_world(name):
    """(reference encoding, overloaded transit nodes) of a seeded world."""
    if name == "random":
        edges, drained = random_connected_edges(40, 30, seed=1), ["node3", "node17"]
    elif name == "grid":
        edges, drained = grid_edges(6), ["node7", "node14", "node21"]
    else:
        edges, drained = _build_wan(256, 7), ["core3", "m1_4"]
    ls = LinkState("0")
    for db in build_adj_dbs(edges, overloaded=drained).values():
        ls.update_adjacency_database(db)
    return jcsr.encode_link_state(ls), drained


def masked_inputs(topo, seed, rows=12):
    """Per-row roots, failed link sets (row 0 cuts its root off) and the
    reference's mask of those sets."""
    rng = np.random.default_rng(seed)
    n = topo.num_nodes
    L = len(topo.links)
    roots = rng.integers(0, n, rows).astype(np.int32)
    sets = [sorted(rng.choice(L, int(rng.integers(0, 6)), replace=False).tolist())
            for _ in range(rows)]
    root_links = np.unique(topo.link_index[(topo.src == roots[0]) & (topo.link_index >= 0)])
    sets[0] = root_links.tolist()
    sets[1] = []  # no failure: the unmasked solve
    return roots, sets, jcsr.link_failure_batch(topo, sets)


def arrays(topo):
    return [topo.src, topo.dst, topo.w, topo.edge_ok]


@pytest.mark.parametrize("world", ["random", "grid", "wan"])
def test_masked_distances_plain_equal_jax(world):
    topo, drained = masked_world(world)
    assert all(topo.overloaded[topo.node_id(d)] for d in drained)
    roots, sets, mask = masked_inputs(topo, seed=len(world))
    # one more row of random per-edge masks, over the whole edge list
    rng = np.random.default_rng(5)
    dense_mask = np.concatenate([mask, rng.random((1, mask.shape[1])) > 0.2])
    dense_roots = np.concatenate([roots, roots[:1]])
    want = np.asarray(jax_masked(
        *(jnp.asarray(a) for a in arrays(topo)), jnp.asarray(dense_mask),
        jnp.asarray(topo.overloaded), jnp.asarray(dense_roots),
    ))
    src, dst, w, ok, ovl, li = tables_from_numpy(
        arrays(topo) + [topo.overloaded, topo.link_index], "cpu"
    )
    em, r = tables_from_numpy([dense_mask, dense_roots], "cpu")
    got = tspf.batched_spf_distances_masked(src, dst, w, ok, em, ovl, r)
    assert np.array_equal(got.numpy(), want)
    # the set form, with -1 pads, on the same rows
    failed = tcsr.link_failure_sets(sets)
    assert (failed == -1).any()
    f, r = tables_from_numpy([failed, roots], "cpu")
    got_sets = tspf.batched_spf_distances_masked_sets(src, dst, w, ok, li, f, ovl, r)
    assert np.array_equal(got_sets.numpy(), want[: len(roots)])
    # row 0 is cut off at its root: every other node unreachable
    row0 = got_sets.numpy()[0]
    assert row0[roots[0]] == 0 and (np.delete(row0[: topo.num_nodes], roots[0]) >= 3e38).all()


def test_failed_links_mask_and_link_failure_batch_equal_reference():
    topo, _ = masked_world("grid")
    port_topo = tcsr.encode_link_state(
        port_lsdb({"0": make_ls(grid_edges(6), "0", overloaded=["node7", "node14", "node21"])},
                  prefixes(), "")[0]["0"]
    )
    assert np.array_equal(port_topo.link_index, topo.link_index)
    _roots, sets, want = masked_inputs(topo, seed=9)
    sets.append([0, 0, 3])  # a repeated id
    want = np.concatenate([want, jcsr.link_failure_batch(topo, [[0, 0, 3]])])
    assert np.array_equal(tcsr.link_failure_batch(port_topo, sets), want)
    li, f = tables_from_numpy([topo.link_index, tcsr.link_failure_sets(sets)], "cpu")
    assert np.array_equal(tspf.failed_links_mask(li, f).numpy(), want)
    assert tcsr.link_failure_sets([[], []]).tolist() == [[-1], [-1]]


# -- the KSP2 engine ---------------------------------------------------------


def engine_world(name):
    if name == "fabric":
        return fabric_edges(num_pods=2, rsws_per_pod=3, fsws_per_pod=2, num_ssws=4), "rsw0_0"
    if name == "wan":
        return _build_wan(256, 7), "core0"
    return random_connected_edges(30, 25, seed=4), "node0"


def keys(paths):
    return [[link.key for link in path] for path in paths]


@pytest.mark.parametrize("world", ["fabric", "wan", "random"])
def test_engine_seeded_paths_equal_reference_engine_and_scalar(world):
    edges, root = engine_world(world)
    ls_ref, ls_scalar = make_ls(edges, "0"), make_ls(edges, "0")
    ls_port = port_lsdb({"0": make_ls(edges, "0")}, prefixes(), root)[0]["0"]
    dests = sorted(n for n in ls_scalar.get_adjacency_databases() if n != root)
    ref = RefEngine(ls_ref, jcsr.encode_link_state(ls_ref), root)
    ref.seed(dests)
    eng = Ksp2DeviceEngine(ls_port, tcsr.encode_link_state(ls_port), root, device="cpu")
    eng.seed(dests)
    assert eng.num_device_batches == 1 and eng.num_seeded == len(dests)
    second = 0
    for d in dests:
        want = keys(ls_scalar.get_kth_paths(root, d, 2))
        assert keys(ls_ref.get_kth_paths(root, d, 2)) == want, d
        assert keys(ls_port.get_kth_paths(root, d, 2)) == want, d
        assert keys(ls_port.get_kth_paths(root, d, 1)) == keys(ls_scalar.get_kth_paths(root, d, 1))
        second += bool(want)
    assert second > 0  # real second paths exist to trace
    assert ls_port.num_spf_runs == 1  # the base SPF only: no host re-solve


def test_engine_memo_holds_until_topology_changes():
    ls = port_lsdb({"0": make_ls(grid_edges(3), "0")}, prefixes(), "node0")[0]["0"]
    eng = Ksp2DeviceEngine(ls, tcsr.encode_link_state(ls), "node0", device="cpu")
    eng.seed(["node8", "node4"])
    assert eng.num_device_batches == 1
    eng.seed(["node8", "node4"])  # memo hit: no second batch
    assert eng.num_device_batches == 1
    eng.seed(["node8", "node4", "node7"])  # only the new destination solves
    assert eng.num_device_batches == 2 and eng.num_seeded == 3
    db = ls.get_adjacency_databases()["node1"]
    db.adjacencies[0].metric += 5
    ls.update_adjacency_database(db)  # a topology change clears the memo
    assert not ls.has_kth_paths("node0", "node8", 2)
    eng.seed(["node8"])
    assert eng.num_device_batches == 3


# -- CudaBackend on the KSP2 worlds of tests/test_ksp2_device.py -------------


def _fabric_world():
    edges = fabric_edges(num_pods=3, rsws_per_pod=4, fsws_per_pod=2, num_ssws=4)
    nodes = sorted({n for e in edges for n in e[:2]})
    rsws = [n for n in nodes if n.startswith("rsw")]
    ps = prefixes(*((n, "0", ksp2(f"10.{i}.0.0/24")) for i, n in enumerate(rsws)))
    return (lambda: {"0": make_ls(edges, "0", me="rsw0_0")}), ps, "rsw0_0"


def _sr_mpls_world():
    edges = fabric_edges(num_pods=2, rsws_per_pod=2, fsws_per_pod=2, num_ssws=2)
    nodes = sorted({n for e in edges for n in e[:2]})
    labels = {n: 100 + i for i, n in enumerate(nodes)}
    ps = prefixes(("rsw1_1", "0", ksp2("2001:db8::/64", forwarding_type=SR_MPLS)))
    return (lambda: {"0": make_ls(edges, "0", me="rsw0_0", node_labels=labels)}), ps, "rsw0_0"


def _anycast_min_nexthop_world():
    ps = prefixes(
        ("node15", "0", ksp2("10.0.0.0/24")),
        ("node12", "0", ksp2("10.0.0.0/24")),
        ("node9", "0", ksp2("10.1.0.0/24", min_nexthop=64)),
    )
    return (lambda: {"0": make_ls(grid_edges(4), "0", me="node0")}), ps, "node0"


def _mixed_world():
    ps = prefixes(
        ("node15", "0", ksp2("10.0.0.0/24")),
        ("node12", "0", PrefixEntry("10.1.0.0/24")),
        ("node3", "0", PrefixEntry("2001:db8::/64")),
    )
    return (lambda: {"0": make_ls(grid_edges(4), "0", me="node0")}), ps, "node0"


def _min_winner_world():
    ps = prefixes(
        ("node8", "0", PrefixEntry("10.0.0.0/24", metrics=PrefixMetrics(path_preference=1000))),
        ("node4", "0", ksp2("10.0.0.0/24", metrics=PrefixMetrics(path_preference=100))),
    )
    return (lambda: {"0": make_ls(grid_edges(3), "0", me="node0")}), ps, "node0"


def _random_world(seed):
    def world():
        edges = random_connected_edges(24, 30, seed=seed)
        ps = prefixes(*(
            (n, "0", ksp2(f"10.{i}.0.0/24"))
            for i, n in enumerate(["node5", "node11", "node17", "node23"])
        ))
        return (lambda: {"0": make_ls(edges, "0", me="node0")}), ps, "node0"

    return world


def _drains_world():
    ps = prefixes(*((n, "0", ksp2("10.0.0.0/24")) for n in ("node15", "node5", "node10")))
    kw = dict(overloaded=["node5"], soft_drained={"node10": 60})
    return (lambda: {"0": make_ls(grid_edges(4), "0", me="node0", **kw)}), ps, "node0"


def _multiarea_world():
    def mk():
        return {
            "1": make_ls(fabric_edges(num_pods=2, rsws_per_pod=2, fsws_per_pod=2), "1",
                         me="rsw0_0"),
            "2": make_ls(grid_edges(3, prefix="g") + [("g0", "rsw0_0", 1)], "2", me="rsw0_0"),
        }

    ps = prefixes(
        ("rsw1_1", "1", ksp2("10.0.0.0/24")),
        ("g8", "2", ksp2("10.0.0.0/24")),
        ("g4", "2", ksp2("10.1.0.0/24")),
    )
    return mk, ps, "rsw0_0"


KSP2_WORLDS = {
    "fabric": _fabric_world,
    "sr_mpls": _sr_mpls_world,
    "anycast_min_nexthop": _anycast_min_nexthop_world,
    "mixed": _mixed_world,
    "min_winner": _min_winner_world,
    "random0": _random_world(0),
    "random1": _random_world(1),
    "random2": _random_world(2),
    "drains": _drains_world,
    "multiarea": _multiarea_world,
}


@pytest.mark.parametrize("world", sorted(KSP2_WORLDS))
def test_backend_ksp2_worlds_equal_tpu_backend_and_scalar(world):
    mk, ps, me = KSP2_WORLDS[world]()
    port = assert_three_way(mk, ps, me)
    if world == "sr_mpls":
        stacks = [nh.mpls_action.push_labels
                  for nh in port.unicast_routes["2001:db8::/64"].nexthops
                  if nh.mpls_action is not None]
        assert stacks, "expected SR-MPLS push stacks on the second paths"
    if world == "min_winner":  # a losing KSP2 advertisement stays SP_ECMP
        assert len(port.unicast_routes["10.0.0.0/24"].nexthops) == 2


def test_backend_seeds_each_area_once_and_records_the_ksp2_phase():
    mk, ps, me = _multiarea_world()
    als, pps = port_lsdb(mk(), ps, me)
    backend = CudaBackend(PortSolver(me), device="cpu")
    backend.build_route_db(als, pps)
    engines = backend._ksp2_engines
    assert sorted(a for a, _seq in engines) == ["1", "2"]
    assert all(e.num_device_batches == 1 for e in engines.values())
    assert backend._ksp2_present
    assert set(backend.last_phase_ms) == PHASES | {"ksp2"}
    # a rebuild on the same LSDB: the memo holds, no batch runs
    backend.build_route_db(als, pps, force_full=True)
    assert all(e.num_device_batches == 1 for e in backend._ksp2_engines.values())


# -- the chip run's backbone world at a CPU size -----------------------------


def wan_world(scale):
    """The chip run's phase-(g) world: ``_build_wan(scale, 7)``, vantage
    core0, node labels as tests/test_ksp2_device.py sets them; every node
    but the last two (by name) advertises a KSP2 /32 loopback, every
    second one also SR-MPLS."""
    edges = _build_wan(scale, 7)
    nodes = sorted({n for e in edges for n in e[:2]})
    labels = {n: 100 + i for i, n in enumerate(nodes)}
    wd = World({"0": edges}, "core0", drains={"0": {"node_labels": labels}})
    ps = Prefixes()
    for i, n in enumerate(nodes[:-2]):
        ftype = SR_MPLS if i % 2 else PrefixForwardingType.IP
        ps.add(n, "0", ksp2(f"10.{i >> 8}.{i & 255}.1/32", forwarding_type=ftype))
    return wd, ps, nodes


def test_backend_wan_ticks_equal_tpu_backend_and_scalar():
    """Cold, prefix churn with two new KSP2 destinations, a warm_delta
    weakening of a backbone link (the memo clears, every destination solves
    again; the warm-selective branch declines) and a churn that names no
    new destination (no batch)."""
    wd, ps, nodes = wan_world(256)
    me = wd.me
    tpu = TpuBackend(SpfSolver(me), resilience=ResilienceConfig(enabled=False),
                     warm_rebuild=True)
    port = CudaBackend(PortSolver(me), device="cpu")
    core = wd.adj["0"]["core1"]
    k = next(i for i, a in enumerate(core.adjacencies) if a.other_node_name.startswith("core"))
    n = len(nodes)
    ticks = [
        ("cold", dict(force_full=True), n - 3),
        ("churn", None, 2),
        ("weaken", dict(changed_prefixes=set(), force_full=True, warm_delta=True), n - 2),
        ("churn-no-new-destination", None, 0),
    ]
    for label, hints, want_seeded in ticks:
        if label == "churn":
            changed = ps.add(nodes[-1], "0", ksp2("10.200.0.1/32"))
            changed |= ps.add(nodes[-2], "0", ksp2("10.200.0.2/32", forwarding_type=SR_MPLS))
            changed |= ps.withdraw(nodes[5], "0", "10.0.5.1/32")
            hints = dict(changed_prefixes=changed)
        elif label == "weaken":
            wd.set_metric("0", "core1", k, core.adjacencies[k].metric + 3)
        elif label == "churn-no-new-destination":
            hints = dict(changed_prefixes=ps.add(nodes[7], "0", ksp2("10.201.0.1/32")))
        before = {e: e.num_seeded for e in port._ksp2_engines.values()}
        db_t = tpu.build_route_db(wd.ref, ps.ref, **hints)
        db_p = port.build_route_db(wd.port, ps.port, **hints)
        got_seeded = sum(
            e.num_seeded - before.get(e, 0) for e in port._ksp2_engines.values()
        )
        assert got_seeded == want_seeded, label
        want = ref_summary(SpfSolver(me).build_route_db(wd.ref, ps.ref))
        assert ref_summary(db_t) == want, label
        assert port_summary(db_p) == want, label
        assert port.take_last_changed_prefixes() == tpu.take_last_changed_prefixes(), label
        for name in COUNTERS:
            assert getattr(port, name) == getattr(tpu, name), (label, name)
        assert port._ksp2_present
    # the weakening took the warm solve, then a full selection
    assert port.num_warm_builds == 1 and port.num_warm_selective_builds == 0
    assert port.num_encode_patches == 1
    assert port.num_incremental_builds == 2 and port.num_delta_builds == 0


# -- DeviceBuildWhatIfEngine ---------------------------------------------------


def test_device_build_whatif_equals_reference_and_generic():
    mk, ps, me = _fabric_world()
    ps.update_prefix("fsw1_0", "0", PrefixEntry("10.9.0.0/24"))  # one SP_ECMP prefix
    links = [("rsw0_0", "fsw0_0"), ("fsw1_1", "ssw1"), ("fsw0_1", "ssw3"), ("no", "such")]
    ref = RefDeviceBuild(SpfSolver(me)).run(links, mk(), ps, 1)
    als, pps = port_lsdb(mk(), ps, me)
    eng = twhatif.DeviceBuildWhatIfEngine(PortSolver(me), device="cpu")
    got = eng.run(links, als, pps, 1)
    generic = twhatif.GenericSolverWhatIfEngine(PortSolver(me)).run(links, als, pps, 1)
    assert got == ref
    assert got["engine"] == "device-build" and generic["engine"] == "generic-solver"
    assert got["failures"] == generic["failures"]
    assert any(f.get("routes_changed") for f in got["failures"])
    pair = links[:2]
    ref_set = RefDeviceBuild(SpfSolver(me)).run(pair, mk(), ps, 1, simultaneous=True)
    got_set = eng.run(pair, als, pps, 1, simultaneous=True)
    assert got_set == ref_set
    generic_set = twhatif.GenericSolverWhatIfEngine(PortSolver(me)).run(
        pair, als, pps, 1, simultaneous=True
    )
    assert got_set["failures"] == generic_set["failures"]
    assert eng.num_builds == 1 + 3 + 1  # base, three known links, the set


def test_port_fabric_and_fattree_generators_equal_reference():
    from openr_tpu.emulation import topology as rtopo

    assert ttopo.fabric_edges(3, 4, 2, 4) == fabric_edges(3, 4, 2, 4)
    assert ttopo._build_fattree(2048, 0) == rtopo._build_fattree(2048, 0)
    assert ttopo._fattree_params(2048) == rtopo._fattree_params(2048)
    assert ttopo._fattree_params(2048)["nodes"] == 2064
