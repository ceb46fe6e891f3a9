"""Configuration of the port's modules: the fields of ``openr_tpu/config.py``
that the port reads, with the reference's defaults."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ResilienceConfig:
    """The backend health governor's shadow-verification sampling and its
    circuit breaker's parameters (``openr_tpu_torch.resilience``)."""

    enabled: bool = True
    #: shadow-verify 1 in N device builds against the scalar SPF oracle
    #: (the first device build is always verified; 0 disables sampling —
    #: probes still verify)
    shadow_sample_every: int = 8
    #: consecutive device dispatch failures that open the breaker
    failure_threshold: int = 3
    #: open-state hold before the first half-open probe (doubles per
    #: failed probe up to the max), jittered so a fleet quarantined by
    #: one shared outage does not re-probe in lockstep
    probe_backoff_initial_s: float = 1.0
    probe_backoff_max_s: float = 30.0
    #: +/- fraction of jitter applied to every hold draw (0 disables)
    jitter_pct: float = 0.1
    #: seeds the deterministic jitter RNG
    seed: int = 0
    #: govern health per device when the backend dispatches over more than
    #: one card; a single-device backend has no pool, so this does nothing
    #: there (the whole-backend latch governs)
    per_device: bool = True
