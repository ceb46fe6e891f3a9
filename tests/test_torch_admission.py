"""The admission path of ``CudaBackend.build_route_db`` (on the CPU, through
the plain kernel versions) against the JAX package's ``TpuBackend`` and the
scalar ``SpfSolver``: the builds the device does not take are counted
scalar builds with the reference's counters, and the port's counter
snapshot has the reference's keys.

* disabled best-route selection, under both selection algorithms;
* an empty ``area_link_states``;
* a link of metric 0 (a ``CapacityError`` of the encode);
* ``min_device_prefixes`` N, on both sides of the world's prefix count;
* the auto cutover (``min_device_prefixes=None``) with
  ``measure_dispatch_rt_ms`` stubbed, in both packages, to a round trip
  above and below the crossover;
* ``counter_snapshot``'s keys against the reference backend's and
  governor's, less the reference's gauges of its device pool (and the
  pool's selection stream), of the per-chip governance, of the jit guard
  and of the slot-stable membership encode, none of which the port has.

Each world is built with the reference's types and carried across as wire
dicts.  Tolerance: ``route_db_summary`` equality and equal counters.
"""

import pytest
import torch

from openr_tpu.config import ParallelConfig
from openr_tpu.config import ResilienceConfig as RefResilienceConfig
from openr_tpu.decision import backend as ref_backend_mod
from openr_tpu.decision.backend import ScalarBackend, TpuBackend
from openr_tpu.decision.prefix_state import PrefixState as RefPrefixState
from openr_tpu.decision.rib import route_db_summary as ref_summary
from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.types import PrefixEntry, RouteComputationRules
from openr_tpu_torch.config import ResilienceConfig
from openr_tpu_torch.decision import backend as port_backend_mod
from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.prefix_state import PrefixState as PortPrefixState
from openr_tpu_torch.decision.rib import route_db_summary as port_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from openr_tpu_torch.interop import lsdb_from_wire
from tests.test_torch_backend import (
    _port_kwargs,
    make_ls,
    multiarea_drains,
    prefixes,
    three_areas,
)
from tests.test_torch_resilience import REF_ONLY_GOVERNOR
from tests.test_torch_spf import lsdb_to_wire

ALGORITHMS = (
    RouteComputationRules.SHORTEST_DISTANCE,
    RouteComputationRules.PER_AREA_SHORTEST_DISTANCE,
)
COUNTERS = (
    "num_device_builds",
    "num_scalar_builds",
    "num_small_scalar_builds",
    "num_fallback_cand_overflow",
    "num_fallback_injected",
    "num_dispatch_errors",
)


def no_device(backend):
    """Make any device SPF or selection of ``backend`` fail the test."""

    def refuse(*args):
        raise AssertionError("the device path ran")

    backend._spf_tables = backend._segment_tables = backend._select = refuse


class Pair:
    """A world's reference backend, port backend and scalar oracle."""

    def __init__(self, world, ref_kwargs=None, port_kwargs=None, **solver_kw):
        mk, ps, me, kw = world()
        kw = {**kw, **solver_kw}
        self.ref_als, self.ref_ps = mk(), ps
        adj_wire, prefix_wire = lsdb_to_wire(mk(), ps)
        self.port_als, self.port_ps = lsdb_from_wire(adj_wire, prefix_wire, my_node_name=me)
        self.oracle = ref_summary(
            ScalarBackend(SpfSolver(me, **kw)).build_route_db(mk(), ps)
        )
        self.ref = TpuBackend(SpfSolver(me, **kw), **(ref_kwargs or {}))
        self.port = CudaBackend(PortSolver(me, **_port_kwargs(kw)), device="cpu",
                                **(port_kwargs or {}))

    def build(self, **kw):
        ref = self.ref.build_route_db(self.ref_als, self.ref_ps, **kw)
        port = self.port.build_route_db(self.port_als, self.port_ps, **kw)
        assert ref_summary(ref) == self.oracle
        assert port_summary(port) == self.oracle
        for name in COUNTERS:
            assert getattr(self.port, name) == getattr(self.ref, name), name
        return port


@pytest.mark.parametrize("algo", ALGORITHMS, ids=lambda a: a.name)
def test_disabled_selection_is_a_counted_scalar_build(algo):
    pair = Pair(three_areas, enable_best_route_selection=False,
                route_selection_algorithm=algo)
    no_device(pair.port)
    for n in (1, 2):
        db = pair.build()
        assert db is not None and db.unicast_routes
        assert pair.port.num_scalar_builds == n
        assert pair.port.num_device_builds == 0
    # nothing reached the device, so nothing was verified
    assert pair.port.governor.num_shadow_checks == 0
    assert pair.port._last_db is None and not pair.port._table_synced


def test_empty_area_map_is_a_counted_scalar_build():
    pair = Pair(multiarea_drains)
    no_device(pair.port)
    ref = pair.ref.build_route_db({}, pair.ref_ps)
    port = pair.port.build_route_db({}, pair.port_ps)
    assert ref is None and port is None
    oracle = SpfSolver("node0").build_route_db({}, RefPrefixState())
    assert oracle is None
    for name in COUNTERS:
        assert getattr(pair.port, name) == getattr(pair.ref, name), name
    assert pair.port.num_scalar_builds == 1 and pair.port.num_device_builds == 0


@pytest.mark.parametrize("over", [1, 0], ids=["above_count", "at_count"])
def test_min_device_prefixes_cutover(over):
    mk, ps, _me, _kw = multiarea_drains()
    n = len(ps.prefixes()) + over
    pair = Pair(multiarea_drains, ref_kwargs=dict(min_device_prefixes=n),
                port_kwargs=dict(min_device_prefixes=n))
    if over:
        no_device(pair.port)
    pair.build()
    pair.build(force_full=True)
    assert pair.port.num_small_scalar_builds == (2 if over else 0)
    assert pair.port.num_device_builds == (0 if over else 2)
    assert pair.port.num_scalar_builds == 0


@pytest.mark.parametrize("rt_ms", [1000.0, 0.001], ids=["slow_dispatch", "fast_dispatch"])
def test_auto_cutover_follows_the_measured_round_trip(monkeypatch, rt_ms):
    calls = []

    def stub(*args):
        calls.append(args)
        return rt_ms

    monkeypatch.setattr(ref_backend_mod, "measure_dispatch_rt_ms", stub)
    monkeypatch.setattr(port_backend_mod, "measure_dispatch_rt_ms", stub)
    pair = Pair(multiarea_drains, ref_kwargs=dict(min_device_prefixes=None),
                port_kwargs=dict(min_device_prefixes=None))
    work = port_backend_mod.estimate_scalar_work_items(pair.port_als, pair.port_ps)
    assert work == ref_backend_mod.estimate_scalar_work_items(pair.ref_als, pair.ref_ps)
    scalar = work * CudaBackend.SCALAR_US_PER_ITEM < (
        CudaBackend.DEVICE_OVERHEAD_TRIPS * rt_ms * 1000.0
    )
    assert scalar == (rt_ms == 1000.0)
    if scalar:
        no_device(pair.port)
    pair.build()
    pair.build(force_full=True)
    # measured once per backend, on the port's own device
    assert calls == [(), (torch.device("cpu"),)]
    assert pair.port.auto_dispatch_rt_ms == pair.ref.auto_dispatch_rt_ms == rt_ms
    assert pair.port.num_small_scalar_builds == (2 if scalar else 0)
    assert pair.port.num_device_builds == (0 if scalar else 2)


def test_measured_round_trip_on_the_cpu():
    rt = port_backend_mod.measure_dispatch_rt_ms(torch.device("cpu"))
    assert 0.0 < rt < 1000.0


#: the reference backend's gauges with no counterpart in the port: the
#: device pool's selection stream
REF_ONLY_BACKEND = (
    "decision.backend.stream_builds",
    "decision.backend.stream_repacks",
)


def expected_keys(ref):
    """The reference backend's and governor's gauge keys, less its device
    pool's, its jit guard's, its per-chip governance's and
    ``REF_ONLY_BACKEND``."""
    keys = {
        k for k in ref.counter_snapshot()
        if not k.startswith("decision.backend.pool.") and "jit_guard" not in k
        and k not in REF_ONLY_BACKEND
    }
    keys |= {k for k in ref.governor.counter_snapshot() if not k.startswith(REF_ONLY_GOVERNOR)}
    return keys


def test_counter_snapshot_keys_equal_reference():
    pair = Pair(multiarea_drains, ref_kwargs=dict(parallel=ParallelConfig(enabled=False)))
    steps = [
        ("fresh", lambda be, als, ps: None),
        ("cold build", lambda be, als, ps: be.build_route_db(als, ps)),
        ("warm tick", lambda be, als, ps: be.build_route_db(als, ps, warm_delta=True)),
        ("corruption", lambda be, als, ps: be.inject_silent_corruption(True)),
        ("mismatch", lambda be, als, ps: be.build_route_db(als, ps, force_full=True)),
        ("quarantined", lambda be, als, ps: be.build_route_db(als, ps)),
    ]
    for label, step in steps:
        step(pair.ref, pair.ref_als, pair.ref_ps)
        step(pair.port, pair.port_als, pair.port_ps)
        got = set(pair.port.counter_snapshot())
        want = expected_keys(pair.ref)
        assert got == want, (label, sorted(got ^ want))
    assert pair.port.device_failed and pair.ref.device_failed
    assert "decision.backend.warm_purge.tpu_corrupt" in got


def test_disabled_governor_keeps_the_legacy_latch():
    pair = Pair(multiarea_drains,
                ref_kwargs=dict(resilience=RefResilienceConfig(enabled=False)),
                port_kwargs=dict(resilience=ResilienceConfig(enabled=False)))
    assert pair.port.governor is None and pair.ref.governor is None
    pair.build()
    for be in (pair.ref, pair.port):
        be.inject_device_failure(True)
    no_device(pair.port)
    pair.build()
    assert pair.port.num_fallback_injected == 1 and pair.port.num_scalar_builds == 1
    assert not any(k.startswith("resilience.") for k in pair.port.counter_snapshot())
    # without a governor a dispatch failure is not answered around: it raises
    for be in (pair.ref, pair.port):
        be.inject_device_failure(False)

    def explode(*args, **kwargs):
        raise RuntimeError("chip fell over")

    pair.port._build_device = explode
    with pytest.raises(RuntimeError, match="fell over"):
        pair.port.build_route_db(pair.port_als, PortPrefixState())
    assert pair.port.num_dispatch_errors == 0


def zero_metric_world():
    """A link of metric 0, which the device SPF does not take (its lane
    propagation needs metrics >= 1): the encode raises ``CapacityError``."""

    def mk():
        return {"0": make_ls([("me", "a", 1), ("a", "b", 0), ("b", "c", 2)], "0", me="me")}

    return mk, prefixes(("c", "0", PrefixEntry("10.0.0.0/24"))), "me", {}


def test_zero_metric_link_is_a_counted_scalar_build():
    pair = Pair(zero_metric_world)
    no_device(pair.port)
    db = pair.build()
    assert db.unicast_routes
    assert pair.port.num_scalar_builds == 1 and pair.port.num_device_builds == 0
    assert pair.port.num_fallback_cand_overflow == 0
    assert pair.port.governor.breaker.num_failures == 0
