"""Span tracing: for now only the always-off tracer, with the surface the
backend's health governor calls (``start_span`` / ``end_span``).  Any object
with that surface can be handed to the governor in its place."""

from __future__ import annotations

from typing import Any


class NoopTracer:
    """Records nothing; ``start_span`` returns a span ``end_span`` ignores."""

    def start_span(self, name: str, ctx: Any = None, **attrs: Any) -> None:
        return None

    def end_span(self, span: Any, **attrs: Any) -> None:
        return None


_DISABLED = NoopTracer()


def disabled_tracer() -> NoopTracer:
    """Shared always-off tracer: the default for modules constructed without
    one, so call sites never need a None check."""
    return _DISABLED
