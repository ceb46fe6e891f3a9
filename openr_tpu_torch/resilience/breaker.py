"""CircuitBreaker — the state machine behind the backend's health governor
(a copy of ``openr_tpu/resilience/breaker.py``).

closed → open → half-open, a jittered exponential hold on the open state,
single-probe exclusion in half-open, and one gauge schema
(``resilience.<name>.*``).

* **Clock-injected** — all timing goes through the shared :class:`Clock`,
  so SimClock tests replay the full open→probe→close trajectory in virtual
  time, deterministically.
* **Deterministic jitter** — the jitter draw comes from a
  ``random.Random`` seeded from ``(seed, crc32(name))``, never from the
  process hash seed or wall entropy: two runs from one seed produce
  identical counter dumps.  Jitter exists so a fleet of breakers opened by
  one shared outage does not re-probe in lockstep.
* **Probe exclusion** — in half-open exactly ONE caller wins the probe
  slot (`allow_request` returns True once); everyone else keeps getting
  short-circuited until the probe resolves via `record_success` /
  `record_failure`.
"""

from __future__ import annotations

import random
import zlib
from typing import Dict, Optional

from openr_tpu_torch.common.runtime import Clock, CounterMap

#: state gauge encoding (resilience.<name>.state)
STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

_STATE_GAUGE = {STATE_CLOSED: 0.0, STATE_OPEN: 1.0, STATE_HALF_OPEN: 2.0}


class CircuitBreaker:
    """closed → open → half-open breaker with jittered exponential hold.

    * ``record_failure()`` — one observed failure of the protected
      dependency.  ``failure_threshold`` consecutive failures (or a
      failed half-open probe, or ``force_open``) open the breaker.
    * ``allow_request()`` — admission gate.  Closed: always True.
      Open: False until the jittered hold elapses, then the FIRST caller
      transitions to half-open and owns the probe (True); subsequent
      callers stay short-circuited.
    * ``record_success()`` — closes from any state and resets the
      backoff ladder.
    """

    def __init__(
        self,
        name: str,
        clock: Clock,
        failure_threshold: int = 3,
        backoff_initial_s: float = 1.0,
        backoff_max_s: float = 30.0,
        jitter_pct: float = 0.1,
        seed: int = 0,
        counters: Optional[CounterMap] = None,
    ) -> None:
        assert failure_threshold >= 1
        assert 0 < backoff_initial_s <= backoff_max_s
        assert 0.0 <= jitter_pct < 1.0
        self.name = name
        self.clock = clock
        self.failure_threshold = failure_threshold
        self.backoff_initial_s = backoff_initial_s
        self.backoff_max_s = backoff_max_s
        self.jitter_pct = jitter_pct
        #: name-salted so a fleet of same-seed breakers still de-syncs;
        #: crc32 (NOT hash()) keeps the draw independent of the process
        #: hash seed — reproducibility across interpreter invocations
        self._rng = random.Random((seed << 32) ^ zlib.crc32(name.encode()))
        self.counters = counters if counters is not None else CounterMap()
        self.state = STATE_CLOSED
        self._consecutive_failures = 0
        #: doublings applied so far on the open hold (resets on close)
        self._open_streak = 0
        #: jittered hold actually drawn for the current open period (s)
        self._hold_s = 0.0
        self._probe_due_at = 0.0
        self._probe_in_flight = False
        self.num_opens = 0
        self.num_closes = 0
        self.num_probes = 0
        self.num_probe_failures = 0
        self.num_failures = 0
        self.num_successes = 0
        self.num_short_circuits = 0

    # -- transitions --------------------------------------------------------

    def _draw_hold_s(self) -> float:
        base = min(
            self.backoff_initial_s * (2 ** self._open_streak),
            self.backoff_max_s,
        )
        if self.jitter_pct:
            base *= 1.0 + self.jitter_pct * self._rng.uniform(-1.0, 1.0)
        return base

    def _open(self) -> None:
        self.state = STATE_OPEN
        self._probe_in_flight = False
        self._hold_s = self._draw_hold_s()
        self._open_streak += 1
        self._probe_due_at = self.clock.now() + self._hold_s
        self.num_opens += 1
        self.counters.bump(f"resilience.{self.name}.opens")

    def _close(self) -> None:
        if self.state != STATE_CLOSED:
            self.num_closes += 1
            self.counters.bump(f"resilience.{self.name}.closes")
        self.state = STATE_CLOSED
        self._consecutive_failures = 0
        self._open_streak = 0
        self._hold_s = 0.0
        self._probe_in_flight = False

    def force_open(self) -> None:
        """Quarantine now, regardless of the failure count (operator
        drain, chaos injection, shadow-verification mismatch)."""
        self._consecutive_failures = max(
            self._consecutive_failures, self.failure_threshold
        )
        self._open()

    def force_close(self) -> None:
        """Operator force-restore: trust the dependency immediately."""
        self._close()

    def expire_hold(self) -> None:
        """Make the probe due NOW (the healed-fault fast path: a chaos
        heal or operator `force_probe` should not wait out the remaining
        jittered hold)."""
        if self.state == STATE_OPEN:
            self._probe_due_at = self.clock.now()

    def release_probe(self) -> None:
        """The half-open probe owner never exercised the dependency
        (its admitted work bailed for an unrelated reason): return to
        open with the probe slot immediately re-available, unscored."""
        if self.state == STATE_HALF_OPEN:
            self.state = STATE_OPEN
            self._probe_in_flight = False
            self._probe_due_at = self.clock.now()

    # -- admission ----------------------------------------------------------

    def allow_request(self) -> bool:
        """Gate one unit of work against the protected dependency.
        Returns False when the caller must short-circuit (breaker open,
        hold not elapsed, or another probe already in flight)."""
        if self.state == STATE_CLOSED:
            return True
        if self.state == STATE_OPEN and self.clock.now() >= self._probe_due_at:
            self.state = STATE_HALF_OPEN
            self._probe_in_flight = True
            self.num_probes += 1
            self.counters.bump(f"resilience.{self.name}.probes")
            return True  # this caller IS the probe
        self.num_short_circuits += 1
        self.counters.bump(f"resilience.{self.name}.short_circuits")
        return False

    # -- outcomes ------------------------------------------------------------

    def record_success(self) -> None:
        self.num_successes += 1
        self._close()

    def record_failure(self) -> None:
        self.num_failures += 1
        self.counters.bump(f"resilience.{self.name}.failures")
        if self.state == STATE_HALF_OPEN:
            # the probe failed: back off harder
            self.num_probe_failures += 1
            self.counters.bump(f"resilience.{self.name}.probe_failures")
            self._open()
            return
        if self.state == STATE_OPEN:
            return  # already quarantined; nothing to escalate
        self._consecutive_failures += 1
        if self._consecutive_failures >= self.failure_threshold:
            self._open()

    # -- introspection -------------------------------------------------------

    def current_hold_s(self) -> float:
        return self._hold_s

    def time_until_probe_s(self) -> float:
        if self.state != STATE_OPEN:
            return 0.0
        return max(0.0, self._probe_due_at - self.clock.now())

    def counter_snapshot(self, prefix: Optional[str] = None) -> Dict[str, float]:
        """Gauge surface for Monitor.add_counter_provider — the ONE
        schema every breaker-protected edge shares."""
        p = prefix if prefix is not None else f"resilience.{self.name}"
        return {
            f"{p}.state": _STATE_GAUGE[self.state],
            f"{p}.opens": float(self.num_opens),
            f"{p}.closes": float(self.num_closes),
            f"{p}.probes": float(self.num_probes),
            f"{p}.probe_failures": float(self.num_probe_failures),
            f"{p}.failures": float(self.num_failures),
            f"{p}.successes": float(self.num_successes),
            f"{p}.short_circuits": float(self.num_short_circuits),
            f"{p}.hold_ms": self._hold_s * 1000.0,
        }

    def status(self) -> Dict[str, object]:
        """The ctrl-API `get_resilience_status` wire form."""
        return {
            "state": self.state,
            "consecutive_failures": self._consecutive_failures,
            "hold_ms": round(self._hold_s * 1000.0, 3),
            "time_until_probe_ms": round(
                self.time_until_probe_s() * 1000.0, 3
            ),
            "opens": self.num_opens,
            "closes": self.num_closes,
            "probes": self.num_probes,
            "probe_failures": self.num_probe_failures,
            "failures": self.num_failures,
            "successes": self.num_successes,
            "short_circuits": self.num_short_circuits,
        }
