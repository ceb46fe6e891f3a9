"""The port's recovery plane (``openr_tpu_torch.resilience``) side by side
with the JAX package's (``openr_tpu.resilience``).

* ``CircuitBreaker``: the six scenarios of ``tests/test_resilience.py``,
  run once on each package's breaker and clock; the state, hold, time to
  the probe, ``status()`` and ``counter_snapshot()`` after every step must
  be equal.
* ``BackendHealthGovernor`` over ``CudaBackend(device="cpu")`` (the plain
  kernel versions) and over ``TpuBackend`` (single device,
  ``ParallelConfig(enabled=False)``), in the nine governor scenarios of
  ``tests/test_resilience.py``, with the same ``ResilienceConfig`` and
  ``SimClock`` schedule.  After every step: ``route_db_summary`` of the
  returned RouteDb, the governor's gauges (the reference's less its
  per-chip and pool gauges), the breaker's status and the
  ``decision.backend.*`` gauges both backends report (less the
  process-wide plan cache's) must be equal.
* A kernel's own error — ``build.KernelError``, ``torch.AcceleratorError``,
  ``torch.OutOfMemoryError`` or a launcher's refusal (``ValueError``,
  ``TypeError``, ``ctypes.ArgumentError``) — raised inside a build
  propagates out of ``build_route_db`` with every counter, the breaker and
  ``device_failed`` as they were; a library without the C entry point a
  launcher binds raises ``build.KernelError``.

Tolerance: exact equality throughout.
"""

import asyncio
import ctypes
import dataclasses
import math
import types

import pytest
import torch

from openr_tpu import resilience as ref_resilience
from openr_tpu.common.runtime import SimClock as RefSimClock
from openr_tpu.config import ParallelConfig
from openr_tpu.config import ResilienceConfig as RefResilienceConfig
from openr_tpu.decision.backend import TpuBackend
from openr_tpu.decision.prefix_state import PrefixState as RefPrefixState
from openr_tpu.decision.rib import route_db_summary as ref_summary
from openr_tpu.decision.spf_solver import SpfSolver as RefSolver
from openr_tpu_torch import resilience as port_resilience
from openr_tpu_torch.common.runtime import SimClock as PortSimClock
from openr_tpu_torch.config import ResilienceConfig as PortResilienceConfig
from openr_tpu_torch.decision.backend import CudaBackend
from openr_tpu_torch.decision.prefix_state import PrefixState as PortPrefixState
from openr_tpu_torch.decision.rib import route_db_summary as port_summary
from openr_tpu_torch.decision.spf_solver import SpfSolver as PortSolver
from openr_tpu_torch.kernels import build
from openr_tpu_torch.kernels.build import KernelError
from openr_tpu_torch.interop import lsdb_from_wire
from tests.test_resilience import make_world
from tests.test_torch_spf import lsdb_to_wire


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# CircuitBreaker: the same scenario on both packages' breakers
# ---------------------------------------------------------------------------

BREAKER_KITS = {
    "reference": types.SimpleNamespace(clock=RefSimClock, mod=ref_resilience),
    "port": types.SimpleNamespace(clock=PortSimClock, mod=port_resilience),
}


def make_breaker(kit, clock, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("backoff_initial_s", 1.0)
    kw.setdefault("backoff_max_s", 8.0)
    kw.setdefault("jitter_pct", 0.0)
    return kit.mod.CircuitBreaker("test", clock, **kw)


def breaker_state(br):
    return (
        br.state,
        br.current_hold_s(),
        br.time_until_probe_s(),
        br.status(),
        br.counter_snapshot(),
    )


def scenario_closed_open_half_open_closed(kit, trace):
    m = kit.mod
    clock = kit.clock()
    br = make_breaker(kit, clock)
    assert br.state == m.STATE_CLOSED and br.allow_request()
    trace.append(breaker_state(br))
    br.record_failure()
    br.record_failure()
    assert br.state == m.STATE_CLOSED
    trace.append(breaker_state(br))
    br.record_failure()
    assert br.state == m.STATE_OPEN and br.num_opens == 1
    trace.append(breaker_state(br))
    assert not br.allow_request()
    assert br.num_short_circuits == 1
    trace.append(breaker_state(br))
    clock._now += 1.5
    assert br.allow_request()
    assert br.state == m.STATE_HALF_OPEN and br.num_probes == 1
    trace.append(breaker_state(br))
    br.record_success()
    assert br.state == m.STATE_CLOSED and br.num_closes == 1
    trace.append(breaker_state(br))
    for _ in range(3):
        br.record_failure()
        trace.append(breaker_state(br))
    assert br.state == m.STATE_OPEN and br.current_hold_s() == 1.0


def scenario_failed_probe_doubles_the_hold(kit, trace):
    m = kit.mod
    clock = kit.clock()
    br = make_breaker(kit, clock)
    for _ in range(3):
        br.record_failure()
    assert br.current_hold_s() == 1.0
    trace.append(breaker_state(br))
    clock._now += 2.0
    assert br.allow_request()
    br.record_failure()
    assert br.state == m.STATE_OPEN
    assert br.num_probe_failures == 1
    assert br.current_hold_s() == 2.0
    trace.append(breaker_state(br))
    clock._now += 3.0
    assert br.allow_request()
    br.record_failure()
    assert br.current_hold_s() == 4.0
    trace.append(breaker_state(br))
    for _ in range(4):
        clock._now += 100.0
        assert br.allow_request()
        br.record_failure()
        trace.append(breaker_state(br))
    assert br.current_hold_s() == 8.0


def scenario_concurrent_probe_exclusion(kit, trace):
    clock = kit.clock()
    br = make_breaker(kit, clock)
    for _ in range(3):
        br.record_failure()
    clock._now += 2.0
    assert br.allow_request()
    trace.append(breaker_state(br))
    assert not br.allow_request()
    assert not br.allow_request()
    trace.append(breaker_state(br))
    br.record_success()
    assert br.allow_request()
    trace.append(breaker_state(br))


def scenario_probe_exclusion_under_concurrent_callers(kit, trace):
    m = kit.mod

    async def main():
        clock = kit.clock()
        br = make_breaker(kit, clock)
        for _ in range(3):
            br.record_failure()
        assert br.state == m.STATE_OPEN
        trace.append(breaker_state(br))
        outcomes = {}

        async def caller(name):
            await clock.sleep(2.0)  # both due at the same virtual time
            outcomes[name] = br.allow_request()

        t1 = asyncio.ensure_future(caller("a"))
        t2 = asyncio.ensure_future(caller("b"))
        await clock.run_for(3.0)
        await asyncio.gather(t1, t2)
        assert sorted(outcomes.values()) == [False, True]
        assert br.state == m.STATE_HALF_OPEN
        assert br.num_probes == 1 and br.num_short_circuits == 1
        assert outcomes["a"] is True and outcomes["b"] is False
        trace.append((breaker_state(br), sorted(outcomes.items())))
        br.record_success()
        assert br.allow_request()
        trace.append(breaker_state(br))

    run(main())


def scenario_release_probe_is_unscored(kit, trace):
    m = kit.mod
    clock = kit.clock()
    br = make_breaker(kit, clock)
    br.force_open()
    trace.append(breaker_state(br))
    clock._now += 2.0
    assert br.allow_request()
    hold = br.current_hold_s()
    trace.append(breaker_state(br))
    br.release_probe()
    assert br.state == m.STATE_OPEN
    assert br.num_probe_failures == 0
    assert br.current_hold_s() == hold
    trace.append(breaker_state(br))
    assert br.allow_request()
    trace.append(breaker_state(br))


def scenario_jitter_bounds_and_determinism(kit, trace):
    def holds(seed):
        clock = kit.clock()
        br = make_breaker(kit, clock, jitter_pct=0.2, seed=seed)
        out = []
        for _ in range(6):
            br.force_open()
            out.append(br.current_hold_s())
            trace.append(breaker_state(br))
            br.force_close()
        return out

    a = holds(5)
    assert all(0.8 <= h <= 1.2 for h in a), a
    assert len(set(a)) > 1, "jitter must vary across draws"
    assert a == holds(5)
    assert a != holds(6)


@pytest.mark.parametrize(
    "scenario",
    [
        scenario_closed_open_half_open_closed,
        scenario_failed_probe_doubles_the_hold,
        scenario_concurrent_probe_exclusion,
        scenario_probe_exclusion_under_concurrent_callers,
        scenario_release_probe_is_unscored,
        scenario_jitter_bounds_and_determinism,
    ],
    ids=lambda f: f.__name__.removeprefix("scenario_"),
)
def test_breaker_trajectory_equals_reference(scenario):
    traces = {}
    for side, kit in BREAKER_KITS.items():
        traces[side] = []
        scenario(kit, traces[side])
    assert traces["port"] == traces["reference"]
    assert len(traces["port"]) >= 3


# ---------------------------------------------------------------------------
# BackendHealthGovernor over CudaBackend and TpuBackend
# ---------------------------------------------------------------------------

#: the reference's governor gauges with no counterpart here: per-chip
#: governance and the device pool
REF_ONLY_GOVERNOR = ("resilience.backend.chip_", "resilience.backend.pool_size",
                     "resilience.backend.healthy_devices", "resilience.backend.dev")


def ref_governor_gauges(gov):
    return {
        k: v for k, v in gov.counter_snapshot().items()
        if not k.startswith(REF_ONLY_GOVERNOR)
    }


def shared_backend_gauges(ref_be, port_be):
    """The ``decision.backend.*`` gauges both backends report, less the
    process-wide plan cache's (each package has its own)."""
    ref = ref_be.counter_snapshot()
    port = port_be.counter_snapshot()
    keys = {
        k for k in ref.keys() & port.keys()
        if k.startswith("decision.backend.") and ".plan_cache." not in k
    }
    return {k: ref[k] for k in keys}, {k: port[k] for k in keys}


class Sides:
    """One scenario's reference and port backends over the same world,
    clocks advanced together."""

    def __init__(self, n=6, **resilience_kw):
        resilience_kw.setdefault("shadow_sample_every", 1)
        resilience_kw.setdefault("failure_threshold", 2)
        resilience_kw.setdefault("probe_backoff_initial_s", 1.0)
        resilience_kw.setdefault("probe_backoff_max_s", 8.0)
        resilience_kw.setdefault("jitter_pct", 0.0)
        self.ref_als, self.ref_ps = make_world(n)
        adj_wire, prefix_wire = lsdb_to_wire(self.ref_als, self.ref_ps)
        self.port_als, self.port_ps = lsdb_from_wire(
            adj_wire, prefix_wire, my_node_name="node0"
        )
        self.ref_clock = RefSimClock()
        self.port_clock = PortSimClock()
        self.ref = TpuBackend(
            RefSolver("node0"),
            clock=self.ref_clock,
            resilience=RefResilienceConfig(**resilience_kw),
            parallel=ParallelConfig(enabled=False),
        )
        self.port = CudaBackend(
            PortSolver("node0"),
            device="cpu",
            clock=self.port_clock,
            resilience=PortResilienceConfig(**resilience_kw),
        )
        self.oracle = port_summary(PortSolver("node0").build_route_db(self.port_als, self.port_ps))
        assert ref_summary(RefSolver("node0").build_route_db(self.ref_als, self.ref_ps)) == self.oracle

    def advance(self, dt):
        self.ref_clock._now += dt
        self.port_clock._now += dt

    def both(self, ref_fn, port_fn):
        """Apply one step to both sides and hold their states equal."""
        ref_out = ref_fn(self.ref)
        port_out = port_fn(self.port)
        self.check()
        return ref_out, port_out

    def build(self, **kw):
        ref_db, port_db = self.both(
            lambda be: be.build_route_db(self.ref_als, self.ref_ps, **kw),
            lambda be: be.build_route_db(self.port_als, self.port_ps, **kw),
        )
        got = port_summary(port_db)
        assert got == ref_summary(ref_db)
        return got

    def check(self):
        ref_gov, port_gov = self.ref.governor, self.port.governor
        assert port_gov.counter_snapshot() == ref_governor_gauges(ref_gov)
        assert port_gov.breaker.status() == ref_gov.breaker.status()
        assert port_gov.injected == ref_gov.injected
        assert port_gov.quarantine_reason == ref_gov.quarantine_reason
        assert port_gov.last_probe == ref_gov.last_probe
        assert port_gov.last_mismatch == ref_gov.last_mismatch
        assert self.port.device_failed == self.ref.device_failed
        ref_g, port_g = shared_backend_gauges(self.ref, self.port)
        assert port_g == ref_g
        for name in ("num_device_builds", "num_scalar_builds", "num_fallback_injected",
                     "num_dispatch_errors"):
            assert getattr(self.port, name) == getattr(self.ref, name), name


def scenario_shadow_verification_passes_on_healthy_device(s):
    assert s.build() == s.oracle
    gov = s.port.governor
    assert gov.num_shadow_checks >= 1
    assert gov.num_shadow_mismatches == 0
    assert not s.port.device_failed


def scenario_sdc_detected_quarantined_and_served_from_scalar(s):
    s.build()
    s.both(lambda be: be.inject_silent_corruption(True),
           lambda be: be.inject_silent_corruption(True))
    assert s.build(force_full=True) == s.oracle
    gov = s.port.governor
    assert gov.num_shadow_mismatches == 1
    assert gov.num_quarantines == 1
    assert s.port.device_failed
    before = s.port.num_device_builds
    assert s.build() == s.oracle
    assert s.port.num_device_builds == before
    assert s.port.num_fallback_injected >= 1


def scenario_probed_recovery_after_corruption_heals(s):
    gov = s.port.governor
    s.build()
    s.both(lambda be: be.inject_silent_corruption(True),
           lambda be: be.inject_silent_corruption(True))
    s.build(force_full=True)
    assert s.port.device_failed
    s.both(lambda be: be.inject_silent_corruption(False),
           lambda be: be.inject_silent_corruption(False))
    s.build()
    assert s.port.device_failed
    s.advance(5.0)
    assert s.build(force_full=True) == s.oracle
    assert not s.port.device_failed
    assert gov.num_restores == 1
    assert gov.breaker.num_probes >= 1


def scenario_failed_probe_reopens_with_doubled_hold(s):
    gov = s.port.governor
    s.build()
    s.both(lambda be: be.inject_silent_corruption(True),
           lambda be: be.inject_silent_corruption(True))
    s.build(force_full=True)
    hold0 = gov.breaker.current_hold_s()
    s.advance(hold0 + 0.5)
    s.build(force_full=True)
    assert s.port.device_failed
    assert gov.breaker.num_probe_failures == 1
    assert gov.breaker.current_hold_s() == 2 * hold0


def scenario_dispatch_failures_trip_the_latch_after_threshold(s):
    gov = s.port.governor
    orig = {be: be._build_device for be in (s.ref, s.port)}

    def explode(*a, **k):
        raise RuntimeError("chip fell over")

    for be in orig:
        be._build_device = explode
    assert s.build() == s.oracle
    assert not s.port.device_failed and s.port.num_dispatch_errors == 1
    assert s.build() == s.oracle
    assert s.port.device_failed and gov.num_quarantines == 1
    touched = []
    for be in orig:
        be._build_device = lambda *a, **k: touched.append(1)
    s.build()
    assert not touched, "quarantined build must not touch the device"
    for be, fn in orig.items():
        be._build_device = fn
    s.advance(10.0)
    assert s.build(force_full=True) == s.oracle
    assert not s.port.device_failed


def scenario_non_finite_guard_trips_shadow_verification(s):
    outs = []
    for gov, solver, als, ps in (
        (s.ref.governor, RefSolver("node0"), s.ref_als, s.ref_ps),
        (s.port.governor, PortSolver("node0"), s.port_als, s.port_ps),
    ):
        db = solver.build_route_db(als, ps)
        prefix, entry = sorted(db.unicast_routes.items())[0]
        db.unicast_routes[prefix] = dataclasses.replace(entry, igp_cost=float("nan"))
        ok, scalar_db, reason = gov._shadow_verify(db, als, ps)
        assert not ok and reason.startswith("non_finite")
        assert all(math.isfinite(e.igp_cost) for e in scalar_db.unicast_routes.values())
        outs.append((ok, reason, gov._last_mismatch_prefixes))
    assert outs[0] == outs[1]
    assert port_summary(scalar_db) == s.oracle
    s.check()


def scenario_hard_quarantine_blocks_probes_until_requested(s):
    gov = s.port.governor
    s.build()
    s.both(lambda be: be.governor.force_quarantine(reason="chaos"),
           lambda be: be.governor.force_quarantine(reason="chaos"))
    assert s.port.device_failed and gov.injected
    s.advance(500.0)
    before = s.port.num_device_builds
    s.build()
    assert s.port.num_device_builds == before and s.port.device_failed
    s.both(lambda be: be.governor.request_probe(reason="chaos_heal"),
           lambda be: be.governor.request_probe(reason="chaos_heal"))
    assert s.port.device_failed
    assert s.build(force_full=True) == s.oracle
    assert not s.port.device_failed and gov.num_restores == 1


def scenario_forced_probe_mismatch_quarantines_even_from_closed(s):
    gov = s.port.governor
    s.build()
    assert gov.num_shadow_checks == 0
    s.both(lambda be: be.inject_silent_corruption(True),
           lambda be: be.inject_silent_corruption(True))
    s.build(force_full=True)
    assert not s.port.device_failed
    ref_out, out = s.both(
        lambda be: be.governor.probe_now(s.ref_als, s.ref_ps),
        lambda be: be.governor.probe_now(s.port_als, s.port_ps),
    )
    assert out == ref_out
    assert out["probed"] and out["passed"] is False
    assert s.port.device_failed and gov.num_quarantines == 1


def scenario_operator_probe_now_restores_a_quarantined_device(s):
    gov = s.port.governor
    s.build()
    s.both(lambda be: be.governor.force_quarantine(reason="operator"),
           lambda be: be.governor.force_quarantine(reason="operator"))
    ref_out, out = s.both(
        lambda be: be.governor.probe_now(s.ref_als, s.ref_ps),
        lambda be: be.governor.probe_now(s.port_als, s.port_ps),
    )
    assert out == ref_out
    assert out["probed"] and out["passed"] and out["restored"]
    assert not s.port.device_failed
    ref_out, out = s.both(
        lambda be: be.governor.probe_now({}, RefPrefixState()),
        lambda be: be.governor.probe_now({}, PortPrefixState()),
    )
    assert out == ref_out and out["probed"] is False


GOVERNOR_SCENARIOS = [
    (scenario_shadow_verification_passes_on_healthy_device, {}),
    (scenario_sdc_detected_quarantined_and_served_from_scalar, {}),
    (scenario_probed_recovery_after_corruption_heals, {}),
    (scenario_failed_probe_reopens_with_doubled_hold, {}),
    (scenario_dispatch_failures_trip_the_latch_after_threshold, {"failure_threshold": 2}),
    (scenario_non_finite_guard_trips_shadow_verification, {}),
    (scenario_hard_quarantine_blocks_probes_until_requested, {}),
    (scenario_forced_probe_mismatch_quarantines_even_from_closed, {"shadow_sample_every": 0}),
    (scenario_operator_probe_now_restores_a_quarantined_device, {}),
]


@pytest.mark.parametrize(
    "scenario, config",
    GOVERNOR_SCENARIOS,
    ids=[f.__name__.removeprefix("scenario_") for f, _ in GOVERNOR_SCENARIOS],
)
def test_governor_trajectory_equals_reference(scenario, config):
    s = Sides(**config)
    scenario(s)
    s.check()


# ---------------------------------------------------------------------------
# a kernel's own errors propagate, uncounted
# ---------------------------------------------------------------------------

KERNEL_ERRORS = {
    "kernel_error": lambda: KernelError("kernel spf_dense failed to launch"),
    "accelerator_error": lambda: torch.AcceleratorError("CUDA error: an illegal memory access"),
    "out_of_memory": lambda: torch.OutOfMemoryError("CUDA out of memory"),
    "launcher_value_error": lambda: ValueError("CUDA kernel called on cpu"),
    "type_error": lambda: TypeError("dist has dtype torch.int64, expected torch.int32"),
    "ctypes_argument_error": lambda: ctypes.ArgumentError("argument 3: wrong type"),
}


def _raising_spf_tables(backend, make_error):
    def raising(*args):
        raise make_error()

    backend._spf_tables = raising


def _state(backend):
    return (
        backend.counter_snapshot(),
        backend.governor.breaker.status(),
        backend.governor.status(),
        backend.device_failed,
    )


@pytest.mark.parametrize("error", sorted(KERNEL_ERRORS))
def test_kernel_errors_propagate_uncounted(error):
    s = Sides(shadow_sample_every=8)
    be = s.port
    before = _state(be)
    make_error = KERNEL_ERRORS[error]
    _raising_spf_tables(be, make_error)
    for _ in range(3):  # past the breaker's threshold, were it scored
        with pytest.raises(type(make_error())) as info:
            be.build_route_db(s.port_als, s.port_ps, force_full=True)
        assert type(info.value) is type(make_error())
        assert _state(be) == before
    assert be.num_dispatch_errors == 0 and be.num_scalar_builds == 0
    assert be.governor.breaker.num_failures == 0 and not be.device_failed
    # nothing of the failed build is a base: the next one is a full build
    assert be._last_db is None and not be._table_synced and be._prev_sel is None
    del be._spf_tables
    assert port_summary(be.build_route_db(s.port_als, s.port_ps)) == s.oracle
    assert be.num_device_builds == 1 and be.governor.num_shadow_checks == 1
    assert be.num_scalar_builds == 0 and be.num_dispatch_errors == 0


@pytest.mark.parametrize("error", sorted(KERNEL_ERRORS))
def test_kernel_error_during_probe_releases_it_unscored(error):
    s = Sides()
    be = s.port
    be.build_route_db(s.port_als, s.port_ps)
    be.governor.force_quarantine(reason="chaos")
    be.governor.request_probe(reason="heal")
    _raising_spf_tables(be, KERNEL_ERRORS[error])
    breaker = be.governor.breaker
    with pytest.raises(type(KERNEL_ERRORS[error]())):
        be.build_route_db(s.port_als, s.port_ps, force_full=True)
    # the probe slot is free again, unscored: the next build probes
    assert breaker.state == port_resilience.STATE_OPEN
    assert breaker.num_probe_failures == 0 and breaker.num_failures == 0
    assert be.num_dispatch_errors == 0 and be.device_failed
    del be._spf_tables
    db = be.build_route_db(s.port_als, s.port_ps, force_full=True)
    assert port_summary(db) == s.oracle
    assert not be.device_failed and be.governor.num_restores == 1


def test_missing_entry_point_is_a_kernel_error(monkeypatch):
    # any loaded library stands in for a kernel's: the C library lacks the symbol
    monkeypatch.setattr(build, "load", lambda name: ctypes.CDLL(None))
    with pytest.raises(KernelError, match="no entry point"):
        build.function("spf_dense", "no_such_entry_point", [ctypes.c_void_p])
    assert ("spf_dense", "no_such_entry_point") not in build._fns
