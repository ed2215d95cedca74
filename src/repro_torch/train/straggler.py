"""Straggler detection/mitigation policy: a copy of
``src/repro/train/straggler.py`` (pure Python).

At pod scale the step time is the max over hosts; a single slow host
(thermal throttle, failing HBM, noisy neighbor) drags the fleet.  The
tracker keeps an EWMA of per-host step time; a host whose EWMA exceeds
``threshold`` × the fleet median for ``patience`` consecutive windows is
flagged for eviction — the launcher then triggers an elastic restart
without it (train/elastic.py).  Pure logic, unit-tested with synthetic
timings.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.2  # EWMA coefficient
    threshold: float = 1.5  # x median
    patience: int = 3  # consecutive slow windows before eviction


class StragglerTracker:
    def __init__(self, cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.ewma: dict[int, float] = {}
        self.slow_streak: dict[int, int] = defaultdict(int)
        self.evicted: set[int] = set()

    def record(self, host: int, step: int, seconds: float):
        a = self.cfg.alpha
        prev = self.ewma.get(host)
        self.ewma[host] = seconds if prev is None else (1 - a) * prev + a * seconds
        # evaluate only the reporting host: the slow-streak counts *its*
        # consecutive slow observations, not fleet-wide record events
        med = self._median()
        if med <= 0 or host in self.evicted:
            return
        if self.ewma[host] > self.cfg.threshold * med:
            self.slow_streak[host] += 1
            if self.slow_streak[host] >= self.cfg.patience:
                self.evicted.add(host)
        else:
            self.slow_streak[host] = 0

    def _median(self) -> float:
        vals = sorted(v for h, v in self.ewma.items() if h not in self.evicted)
        if not vals:
            return 0.0
        n = len(vals)
        return vals[n // 2] if n % 2 else 0.5 * (vals[n // 2 - 1] + vals[n // 2])

    def flagged(self) -> set[int]:
        """Hosts currently above threshold (pre-eviction warning)."""
        med = self._median()
        return {
            h
            for h, v in self.ewma.items()
            if h not in self.evicted and med > 0 and v > self.cfg.threshold * med
        }

    def should_evict(self) -> set[int]:
        return set(self.evicted)
