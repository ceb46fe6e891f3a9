"""The recovery plane of the port's device backend.

One :class:`CircuitBreaker` state machine (closed → open → half-open,
jittered exponential hold, single-probe exclusion) under
:class:`BackendHealthGovernor`, which adds shadow verification against the
scalar SPF oracle so silently-wrong kernel output is caught, not just
raised errors, under one gauge schema (``resilience.*``).  The per-device
governance of the reference (one breaker per card of a pool) comes with
multi-GPU dispatch.
"""

from __future__ import annotations

from typing import Dict

from openr_tpu_torch.resilience.breaker import (
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    CircuitBreaker,
)
from openr_tpu_torch.resilience.governor import BackendHealthGovernor


def node_resilience_status(node) -> Dict[str, object]:
    """The resilience status of one node: anything with ``name``,
    ``decision.backend`` and ``fib`` (and optionally ``kv_transport``)."""
    backend = getattr(node.decision, "backend", None)
    gov = getattr(backend, "governor", None)
    out: Dict[str, object] = {
        "node": node.name,
        "device_backend": (
            gov.status() if gov is not None else {"present": False}
        ),
        "fib_agent": (
            node.fib.breaker.status()
            if getattr(node.fib, "breaker", None) is not None
            else {}
        ),
    }
    kv = getattr(node, "kv_transport", None)
    if kv is not None and hasattr(kv, "breaker_status"):
        out["kv_transport"] = kv.breaker_status()
    if hasattr(backend, "_warm_class_builds"):
        # warm-rebuild health split by delta class: during a
        # rolling fleet upgrade the STRUCTURAL ratio is the first thing
        # an operator reads — a collapse there means publication→FIB
        # is back on the cold wall while the fleet churns
        builds = backend._warm_class_builds
        fallbacks = backend._warm_class_fallbacks
        out["warm"] = {
            "enabled": bool(backend._warm_enabled),
            "context_ready": backend._warm_ctx is not None,
            "by_class": {
                cls: {
                    "hits": builds[cls],
                    "fallbacks": fallbacks[cls],
                    "hit_ratio": round(
                        builds[cls]
                        / max(1, builds[cls] + fallbacks[cls]),
                        3,
                    ),
                    "fallback_reasons": dict(
                        sorted(
                            backend._warm_class_fallback_reasons[
                                cls
                            ].items()
                        )
                    ),
                }
                for cls in sorted(builds)
            },
            "encode_patches": backend.num_encode_patches,
            "encode_slot_patches": backend.num_encode_slot_patches,
            "slot_declines": dict(sorted(backend._slot_decline_reasons.items())),
            "purges": backend.num_warm_purges,
            "purge_reasons": dict(
                sorted(backend._warm_purge_reasons.items())
            ),
        }
    return out


__all__ = [
    "CircuitBreaker",
    "BackendHealthGovernor",
    "node_resilience_status",
    "STATE_CLOSED",
    "STATE_OPEN",
    "STATE_HALF_OPEN",
]
