"""BackendHealthGovernor — owns the device backend's health latch (the
whole-backend part of ``openr_tpu/resilience/governor.py``).

A backend that trades the scalar Dijkstra for device kernels must survive
three failure modes without an operator:

1. **Hard outage** — the device build raises for a reason that is not a
   kernel's own refusal (those propagate; see ``decision/backend.py``).  A
   run of such failures opens the breaker instead of re-paying the failing
   device on every rebuild.
2. **Silent data corruption** — the device returns wrong but plausible
   tables (``CudaBackend.inject_silent_corruption`` models it).  Nothing
   raises, so only a comparison can notice.
3. **Recovery** — once the device heals, something has to re-trust it, and
   must not re-trust a device that still lies.

One mechanism covers all three: a :class:`CircuitBreaker` around the device
plus **shadow verification** — a sample of device builds (the first one,
then 1 in ``shadow_sample_every``, and every probe) is recomputed by the
scalar SPF oracle and RIB-diffed (nexthop sets, igp cost, do-not-install,
plus a non-finite guard on kernel-derived metrics).  A mismatch or a run of
dispatch failures opens the breaker: the backend is quarantined,
``device_failed`` goes up, and every build routes through the scalar
oracle, counted.  While open, half-open probe builds (which must pass
shadow verification) are the only device traffic; a passing probe restores
the device.

The per-device branches of the reference (a pool of cards, each with its
own breaker) need a device pool, which the port does not have yet; with no
pool the reference takes exactly the whole-backend paths kept here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from openr_tpu_torch.common.runtime import Clock, CounterMap, WallClock
from openr_tpu_torch.resilience.breaker import (
    STATE_CLOSED,
    CircuitBreaker,
)
from openr_tpu_torch.tracing import disabled_tracer

#: admit() verdicts
ADMIT_DEVICE = "device"
ADMIT_PROBE = "probe"
ADMIT_QUARANTINED = "quarantined"


class BackendHealthGovernor:
    """Health authority for one CudaBackend.

    The backend calls three hooks around every build:

    * :meth:`admit` — before touching the device.  ``"quarantined"``
      routes the build to the scalar oracle; ``"probe"`` marks this build
      as the half-open probe (it must shadow-verify to restore the
      device); ``"device"`` is the healthy fast path.
    * :meth:`record_dispatch_failure` — a device build raised a counted
      failure.  Consecutive failures past the breaker threshold quarantine.
    * :meth:`after_device_build` — the device produced a RouteDb.  Sampled
      builds (and every probe) are shadow-verified against the scalar
      oracle; on mismatch the device is quarantined and the scalar RouteDb
      replaces the device output, so a detected wrong answer never leaves
      the backend.
    """

    def __init__(
        self,
        backend,
        clock: Optional[Clock] = None,
        counters: Optional[CounterMap] = None,
        tracer=None,
        shadow_sample_every: int = 8,
        failure_threshold: int = 3,
        probe_backoff_initial_s: float = 1.0,
        probe_backoff_max_s: float = 30.0,
        jitter_pct: float = 0.1,
        seed: int = 0,
        per_device: bool = True,
    ) -> None:
        self.backend = backend
        self.clock = clock if clock is not None else WallClock()
        self.counters = counters if counters is not None else CounterMap()
        self.tracer = tracer if tracer is not None else disabled_tracer()
        self.shadow_sample_every = max(0, int(shadow_sample_every))
        self.breaker = CircuitBreaker(
            "backend",
            self.clock,
            failure_threshold=failure_threshold,
            backoff_initial_s=probe_backoff_initial_s,
            backoff_max_s=probe_backoff_max_s,
            jitter_pct=jitter_pct,
            seed=seed,
            counters=self.counters,
        )
        #: per-device governance applies only to a backend with a pool of
        #: more than one card; without one it does nothing
        self.per_device = per_device
        #: every mismatching prefix of the last failed shadow check
        self._last_mismatch_prefixes: List[str] = []
        #: hard latch: injected outage / operator force_quarantine.  While
        #: set, NO probes run (the fault owner declared the device dead);
        #: request_probe() clears it and makes the breaker probe-eligible
        self.injected = False
        self.quarantine_reason = ""
        #: device builds since the last shadow check; starts "due" so the
        #: FIRST device build is always verified
        self._builds_since_check = self.shadow_sample_every
        self._forced_probe = False
        self.num_shadow_checks = 0
        self.num_shadow_mismatches = 0
        self.num_quarantines = 0
        self.num_restores = 0
        self.num_dispatch_failures = 0
        self.last_probe: Dict[str, object] = {}
        self.last_mismatch: Dict[str, object] = {}
        #: quarantine observers, fired AFTER a quarantine transition
        #: settles with {"reason", "device": None}
        self._quarantine_listeners: List = []
        self._sync_latch()

    def add_quarantine_listener(self, fn) -> None:
        """Register ``fn(info: dict)`` fired on every quarantine transition.
        Listener exceptions are counted, never propagated — an observer must
        not break the health plane it observes."""
        self._quarantine_listeners.append(fn)

    def _notify_quarantine(self, info: Dict[str, object]) -> None:
        for fn in self._quarantine_listeners:
            try:
                fn(dict(info))
            except Exception:  # noqa: BLE001 - observer must not break us
                self.counters.bump("resilience.backend.listener_errors")

    # -- the latch (single writer) ------------------------------------------

    def _sync_latch(self) -> None:
        self.backend.device_failed = (
            self.injected or self.breaker.state != STATE_CLOSED
        )

    @property
    def quarantined(self) -> bool:
        return self.backend.device_failed

    # -- build hooks ---------------------------------------------------------

    def admit(self) -> str:
        """Gate one route build's device usage."""
        if self.injected:
            return ADMIT_QUARANTINED
        if self._forced_probe:
            # operator force_probe: run the device + full verification
            # regardless of breaker timing
            self._forced_probe = False
            return ADMIT_PROBE
        if self.breaker.state == STATE_CLOSED:
            return ADMIT_DEVICE
        if self.breaker.allow_request():
            return ADMIT_PROBE
        return ADMIT_QUARANTINED

    def abort_probe(self) -> None:
        """The admitted probe never reached a verdict (the build bailed to
        scalar for an eligibility reason, or a kernel error propagated):
        release the probe slot without scoring it."""
        self.breaker.release_probe()

    def request_shadow_check(self, reason: str = "") -> None:
        """Make the NEXT device build's shadow verification due regardless
        of where the sampling counter stands.  The warm-context purge calls
        this: after any event that makes device-resident state suspect
        (corruption injection, a quarantine, a full-replace swap), the
        first build off the purge is verified, not merely sampled."""
        self._builds_since_check = self.shadow_sample_every
        self.counters.bump("resilience.backend.shadow_check_requests")

    def record_dispatch_failure(self, exc: Optional[BaseException] = None) -> None:
        """A device build raised a counted failure.  Counts toward the
        breaker threshold; past it the device is quarantined instead of
        being re-tried on every rebuild."""
        self.num_dispatch_failures += 1
        self.counters.bump("resilience.backend.dispatch_failures")
        was_quarantined = self.quarantined
        self.breaker.record_failure()
        self._sync_latch()
        if self.quarantined and not was_quarantined:
            self._note_quarantine(
                f"dispatch:{type(exc).__name__}" if exc is not None else "dispatch"
            )

    def after_device_build(
        self, db, area_link_states, prefix_state, probe: bool = False
    ) -> Tuple[object, bool]:
        """Returns ``(route_db, from_device)``.  ``from_device`` is False
        exactly when shadow verification replaced a corrupt device result
        with the scalar oracle's — the caller must then drop its
        incremental bases."""
        self._builds_since_check += 1
        due = (
            self.shadow_sample_every > 0
            and self._builds_since_check >= self.shadow_sample_every
        )
        if not probe and not due:
            return db, True
        self._builds_since_check = 0
        span = self.tracer.start_span(
            "resilience.probe" if probe else "resilience.shadow_check",
            module="resilience",
            probe=probe,
            device=None,
        )
        ok, scalar_db, reason = self._shadow_verify(
            db, area_link_states, prefix_state
        )
        self.tracer.end_span(span, passed=ok, reason=reason)
        if probe:
            self.last_probe = {"passed": ok, "reason": reason}
        self.num_shadow_checks += 1
        self.counters.bump("resilience.backend.shadow_checks")
        if ok:
            was_quarantined = self.quarantined
            if probe or self.breaker.state != STATE_CLOSED:
                self.breaker.record_success()
                self.injected = False
            self._sync_latch()
            if was_quarantined and not self.quarantined:
                self.num_restores += 1
                self.counters.bump("resilience.backend.restores")
            return db, True
        # wrong-but-plausible device output: quarantine AND serve the
        # verified scalar answer for this build
        self.num_shadow_mismatches += 1
        self.counters.bump("resilience.backend.shadow_mismatches")
        self.last_mismatch = {"reason": reason}
        was_quarantined = self.quarantined
        if probe and self.breaker.state != STATE_CLOSED:
            self.breaker.record_failure()  # failed probe: backoff doubles
        else:
            # sampled mismatch, or a FORCED probe that failed while the
            # breaker was closed: proven corruption quarantines outright
            self.breaker.force_open()
        self._sync_latch()
        if not was_quarantined:
            self._note_quarantine(f"shadow:{reason}")
        return scalar_db, False

    def _note_quarantine(self, reason: str) -> None:
        self.quarantine_reason = reason
        self.num_quarantines += 1
        self.counters.bump("resilience.backend.quarantines")
        self._notify_quarantine({"reason": reason, "device": None})

    # -- shadow verification -------------------------------------------------

    def _shadow_verify(
        self, device_db, area_link_states, prefix_state
    ) -> Tuple[bool, object, str]:
        """Device RouteDb vs the scalar oracle: (ok, scalar_db, reason).

        Checks, cheapest first: a non-finite guard on kernel-derived
        metrics (a NaN/inf igp_cost is never legitimate on a reachable
        route), then the full RIB diff — same prefix set, and per prefix
        the same nexthop set (address/iface/metric/area), igp cost and
        do-not-install.  The scalar db is computed ONCE and returned so a
        mismatching build can be served from it without a second solve.
        Every mismatching prefix is collected; the reason string names the
        first."""
        self._last_mismatch_prefixes = []
        non_finite = [
            prefix
            for prefix, entry in device_db.unicast_routes.items()
            if not math.isfinite(entry.igp_cost)
        ]
        if non_finite:
            self._last_mismatch_prefixes = non_finite
            return False, self._scalar_db(area_link_states, prefix_state), (
                f"non_finite:{non_finite[0]}"
            )
        scalar_db = self._scalar_db(area_link_states, prefix_state)
        dev = device_db.unicast_routes
        ref = scalar_db.unicast_routes
        bad: List[str] = []
        reason = ""
        if set(dev) != set(ref):
            missing = sorted(set(ref) - set(dev))
            extra = sorted(set(dev) - set(ref))
            bad.extend(missing + extra)
            reason = f"prefix_set:missing={missing[:3]}:extra={extra[:3]}"
        for prefix, d in dev.items():
            r = ref.get(prefix)
            if r is None:
                continue  # already in `bad` via the prefix-set diff
            if set(d.nexthops) != set(r.nexthops):
                bad.append(prefix)
                reason = reason or f"nexthops:{prefix}"
            elif float(d.igp_cost) != float(r.igp_cost):
                bad.append(prefix)
                reason = reason or f"igp_cost:{prefix}"
            elif d.do_not_install != r.do_not_install:
                bad.append(prefix)
                reason = reason or f"do_not_install:{prefix}"
        if bad:
            self._last_mismatch_prefixes = bad
            return False, scalar_db, reason
        return True, scalar_db, ""

    def _scalar_db(self, area_link_states, prefix_state):
        return self.backend.solver.build_route_db(area_link_states, prefix_state)

    # -- operator / chaos controls -------------------------------------------

    def force_quarantine(self, reason: str = "operator") -> None:
        """Hard-quarantine the device (injected outage, operator drain).
        No probes run until request_probe/force_restore."""
        was = self.quarantined
        self.injected = True
        self.breaker.force_open()
        self._sync_latch()
        if not was:
            self._note_quarantine(reason)
        else:
            self.quarantine_reason = reason

    def request_probe(self, reason: str = "heal") -> None:
        """The fault owner healed the device: clear the hard latch and make
        the breaker probe-eligible NOW.  The device stays quarantined until
        a probe build passes shadow verification — heals are probed, never
        trusted blindly."""
        self.injected = False
        self.breaker.expire_hold()
        self.counters.bump("resilience.backend.probe_requests")
        self._sync_latch()

    def force_restore(self, reason: str = "operator") -> None:
        """Operator force-close: trust the device immediately (prefer
        request_probe for verified recovery)."""
        was = self.quarantined
        self.injected = False
        self.breaker.force_close()
        self._sync_latch()
        if was:
            self.num_restores += 1
            self.counters.bump("resilience.backend.restores")

    def probe_now(self, area_link_states, prefix_state) -> Dict[str, object]:
        """Synchronous operator probe: run one device build against the
        CURRENT LSDB through the full probe path (device solve + shadow
        verification) and report the outcome.  A pass restores the device,
        including from an injected quarantine — the operator explicitly
        demanded a re-check."""
        if not area_link_states or not any(
            ls.has_node(self.backend.solver.my_node_name)
            for ls in area_link_states.values()
        ):
            return {"probed": False, "reason": "no LSDB state to probe with"}
        self.injected = False  # the operator overrides the hard latch
        self._forced_probe = True
        self.last_probe = {}
        db = self.backend.build_route_db(
            area_link_states,
            prefix_state,
            force_full=True,
            cache_result=False,
        )
        out: Dict[str, object] = {
            "probed": bool(self.last_probe),
            "restored": not self.quarantined,
            "routes": len(db.unicast_routes) if db is not None else 0,
        }
        out.update(self.last_probe)
        if not self.last_probe:
            # the build never reached the device (algorithm/scale routes
            # every build scalar) — nothing was verified
            out["reason"] = "build took the scalar path; nothing to probe"
            self._forced_probe = False
        return out

    # -- observability -------------------------------------------------------

    def counter_snapshot(self) -> Dict[str, float]:
        """The governor's gauges: its breaker's and its own."""
        out = self.breaker.counter_snapshot("resilience.backend")
        out.update(
            {
                "resilience.backend.quarantined": 1.0 if self.quarantined else 0.0,
                "resilience.backend.injected": 1.0 if self.injected else 0.0,
                "resilience.backend.shadow_checks": float(self.num_shadow_checks),
                "resilience.backend.shadow_mismatches": float(
                    self.num_shadow_mismatches
                ),
                "resilience.backend.quarantines": float(self.num_quarantines),
                "resilience.backend.restores": float(self.num_restores),
                "resilience.backend.dispatch_failures": float(
                    self.num_dispatch_failures
                ),
            }
        )
        return out

    def status(self) -> Dict[str, object]:
        """The device-backend block of a resilience status report."""
        return {
            "present": True,
            "quarantined": self.quarantined,
            "injected": self.injected,
            "quarantine_reason": self.quarantine_reason,
            "shadow_sample_every": self.shadow_sample_every,
            "shadow_checks": self.num_shadow_checks,
            "shadow_mismatches": self.num_shadow_mismatches,
            "quarantines": self.num_quarantines,
            "restores": self.num_restores,
            "dispatch_failures": self.num_dispatch_failures,
            "last_probe": dict(self.last_probe),
            "last_mismatch": dict(self.last_mismatch),
            "breaker": self.breaker.status(),
            "per_device": self.per_device,
        }
