"""Clocks and counters: the part of ``openr_tpu/common/runtime.py`` that the
backend's health governor and circuit breaker use.

Time is pluggable: `WallClock` for production, `SimClock` for
deterministic discrete-event tests, in which a test advances virtual time
(``run_for`` / ``run_until``, or ``_now`` directly) and every breaker hold
and probe deadline follows it.  `CounterMap` is the flat fb303-style
counter namespace the breaker and governor bump.  The reference's actor
runtime, its queues, its latency histograms and its SimClock's schedule
perturbation and observer ordering are not part of the port.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from typing import Dict, List


class Clock:
    """Time source. All protocol-plane sleeping/timing MUST go through this."""

    def now(self) -> float:
        raise NotImplementedError

    def now_ms(self) -> int:
        return int(self.now() * 1000)

    async def sleep(self, delay: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    async def sleep(self, delay: float) -> None:
        await asyncio.sleep(max(0.0, delay))


class SimClock(Clock):
    """Deterministic discrete-event virtual clock.

    Tasks `await clock.sleep(dt)`; a test calls `await run_for(dt)` /
    `await run_until(t)` which advances virtual time event by event, letting
    the loop quiesce between events.  Wakeups due at the same instant
    dispatch in the order they were registered.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._now = start
        self._heap: List = []
        self._seq = itertools.count()
        self.activity = 0  # bumped by sleepers waking; used for quiescing

    def now(self) -> float:
        return self._now

    async def sleep(self, delay: float) -> None:
        if delay <= 0:
            await asyncio.sleep(0)
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        heapq.heappush(self._heap, (self._now + delay, next(self._seq), fut))
        await fut

    async def _settle(self) -> None:
        # Let the asyncio ready-queue drain: plain yields until chained
        # callbacks stop producing new ones.
        for _ in range(3):
            before = self.activity
            for _ in range(10):
                await asyncio.sleep(0)
            if self.activity == before:
                return

    async def run_until(self, deadline: float) -> None:
        await self._settle()
        while self._heap and self._heap[0][0] <= deadline:
            t, _, fut = heapq.heappop(self._heap)
            self._now = max(self._now, t)
            if not fut.done():
                self.activity += 1
                fut.set_result(None)
            await self._settle()
        self._now = max(self._now, deadline)
        await self._settle()

    async def run_for(self, duration: float) -> None:
        await self.run_until(self._now + duration)


class CounterMap:
    """Flat counter namespace; `dump()` feeds the ctrl API `getCounters`."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}

    def bump(self, key: str, delta: float = 1) -> None:
        self._counters[key] = self._counters.get(key, 0) + delta

    def set(self, key: str, value: float) -> None:
        self._counters[key] = value

    def get(self, key: str) -> float:
        return self._counters.get(key, 0)

    def dump(self, prefix: str = "") -> Dict[str, float]:
        if not prefix:
            return dict(self._counters)
        return {k: v for k, v in self._counters.items() if k.startswith(prefix)}
