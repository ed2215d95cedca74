"""Copy of ``src/repro/resilience/breaker.py`` (device-free).

Per-statement circuit breakers for the degradation ladder.

A persistently-failing configuration (one statement whose fused or sharded
executable keeps dying) must stop burning a full retry ladder on every
wave.  Each ``(statement fingerprint, tier)`` pair gets a breaker:

* **closed** — requests flow; failures are counted in a sliding time
  window.  At ``failure_threshold`` failures within ``window_s`` the
  breaker **opens**.
* **open** — ``allow()`` is False, so the ladder routes the statement
  straight to the next tier down without attempting this one.  After
  ``cooldown_s`` the next ``allow()`` transitions to **half-open** and
  admits one probe.
* **half-open** — the probe's outcome decides: success restores
  **closed** (counters reset), failure re-opens with a fresh cooldown.

Clocks are injectable (the scheduler's deterministic test clock drives
breaker timing too), and every transition is counted so tests and serving
dashboards can watch ``opened / reopened / restored / probes`` per
breaker and per board.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    #: failures within ``window_s`` that trip a closed breaker open
    failure_threshold: int = 3
    #: sliding failure-count window (seconds)
    window_s: float = 30.0
    #: how long an open breaker rejects before admitting a half-open probe
    cooldown_s: float = 5.0


class CircuitBreaker:
    """One breaker; see module docstring for the state machine."""

    __slots__ = ("config", "clock", "state", "failures", "opened_at", "stats")

    def __init__(self, config: BreakerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or BreakerConfig()
        self.clock = clock
        self.state = CLOSED
        self.failures: deque[float] = deque()  # failure timestamps, windowed
        self.opened_at: float | None = None
        self.stats = {"opened": 0, "reopened": 0, "restored": 0, "probes": 0,
                      "rejected": 0}

    def _prune(self, now: float) -> None:
        w = self.config.window_s
        while self.failures and now - self.failures[0] > w:
            self.failures.popleft()

    def allow(self) -> bool:
        """May a request attempt this tier right now?  An open breaker
        past its cooldown admits exactly one half-open probe (drains are
        serialized, so the probe's outcome lands before the next ask)."""
        if self.state == CLOSED:
            return True
        now = self.clock()
        if self.state == OPEN:
            if now - self.opened_at >= self.config.cooldown_s:
                self.state = HALF_OPEN
                self.stats["probes"] += 1
                return True
            self.stats["rejected"] += 1
            return False
        # HALF_OPEN: a probe is already accounted; admit (the serialized
        # drain records its outcome before anyone else asks)
        return True

    def record_success(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self.failures.clear()
            self.opened_at = None
            self.stats["restored"] += 1
            return
        self._prune(now)

    def record_failure(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        if self.state == HALF_OPEN:
            self.state = OPEN
            self.opened_at = now
            self.stats["reopened"] += 1
            return
        if self.state == OPEN:
            return  # already open; nothing to count
        self.failures.append(now)
        self._prune(now)
        if len(self.failures) >= self.config.failure_threshold:
            self.state = OPEN
            self.opened_at = now
            self.failures.clear()
            self.stats["opened"] += 1


class BreakerBoard:
    """Lazy dict of breakers keyed by ``(statement fingerprint, tier)``.

    The board is what the ladder consults: ``allow(key)`` before an
    attempt, ``success(key)`` / ``failure(key)`` after.  ``snapshot()``
    is the introspection surface (state + counters per live breaker),
    mirroring ``Session.cache_stats``'s role for the cache tiers.
    """

    def __init__(self, config: BreakerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or BreakerConfig()
        self.clock = clock
        self.breakers: dict = {}

    def _get(self, key) -> CircuitBreaker:
        b = self.breakers.get(key)
        if b is None:
            b = self.breakers[key] = CircuitBreaker(self.config, self.clock)
        return b

    def allow(self, key) -> bool:
        b = self.breakers.get(key)
        return True if b is None else b.allow()

    def success(self, key) -> None:
        b = self.breakers.get(key)
        if b is not None:
            b.record_success()

    def failure(self, key) -> None:
        self._get(key).record_failure()

    def state(self, key) -> str:
        b = self.breakers.get(key)
        return CLOSED if b is None else b.state

    def snapshot(self) -> dict:
        """``{key: {"state": ..., **counters}}`` for every live breaker."""
        return {
            key: {"state": b.state, **b.stats}
            for key, b in self.breakers.items()
        }


__all__ = ["BreakerConfig", "CircuitBreaker", "BreakerBoard",
           "CLOSED", "OPEN", "HALF_OPEN"]
