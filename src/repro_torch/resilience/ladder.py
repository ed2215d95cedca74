"""Copy of ``src/repro/resilience/ladder.py`` (device-free).

Graceful-degradation execution ladder for scheduler drains.

The engine stacks four execution alternatives for any drained wave, from
fastest/most-shared to slowest/most-isolated:

    fused wave  →  execute_many  →  serial execute  →  INTERPRETED per-row

(the paper's own fallback argument, PAPER.md §6: unsupported or failing
constructs revert to interpreted execution rather than failing the
query).  The ladder makes that contract hold for *any* failure at any
seam — trace, compile, dispatch, sync, or a genuine data error — by
retrying the failed work one tier down with bounded attempts and
narrowing granularity:

* a **fused wave** failure demotes every member group to its own
  ``execute_many`` (the per-statement isolation retry, tier 1 of 4);
* a **group** failure demotes each of its tickets to a serial compiled
  ``execute``;
* a **ticket** failure demotes that ticket to eager INTERPRETED
  execution — the mode oracle guarantees identical answers, so a
  demotion is invisible in results;
* only when the interpreter itself fails does the ticket surface an
  error (raw for genuine data errors, typed for injected/derived ones).

Per-statement **circuit breakers** (``breaker.py``) guard every tier: a
statement whose fused/batched configuration keeps failing routes straight
to the next tier down instead of burning the retry budget each wave, and
a half-open probe restores it once it heals.  **Deadlines** shed expired
tickets with a typed :class:`~repro_torch.resilience.faults.DeadlineExceeded`
*before* work starts at each tier (shed-before-drain), so a retry storm
cannot hold dead tickets through the whole ladder.

Every demotion, shed, breaker short-circuit and per-tier success is
counted in the ``counters`` dict the scheduler shares (see
``CoalescingScheduler.stats`` / ``resilience_stats``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

from repro_torch.core.policy import INTERPRETED
from repro_torch.resilience.breaker import BreakerBoard, BreakerConfig
from repro_torch.resilience.faults import (
    DeadlineExceeded,
    ResilienceError,
    WaveResultMismatch,
)

#: ladder tiers, top (most shared) to bottom (most isolated)
TIERS = ("fused", "many", "serial", "interp")

#: sentinel for "no result yet" (a legitimate result may be any object)
UNSET = object()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded in-tier retry: each tier gets at most ``max_attempts``
    tries, with ``backoff_s × backoff_mult**(attempt-1)`` between them
    (``sleep`` is injectable on the ladder, so tests stay instant)."""

    max_attempts: int = 1
    backoff_s: float = 0.0
    backoff_mult: float = 2.0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        return self.backoff_s * (self.backoff_mult ** (attempt - 1))


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    retry: RetryPolicy = RetryPolicy()
    breaker: BreakerConfig = BreakerConfig()
    #: allow the final INTERPRETED per-row tier (off = serial compiled
    #: execution is the floor and its error surfaces)
    interp_fallback: bool = True


class _NullLock:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclasses.dataclass
class WorkItem:
    """One ticket's work: parameters, optional absolute deadline, and the
    outcome the ladder fills (exactly one of result/error is set)."""

    params: dict
    deadline: float | None = None
    result: Any = UNSET
    error: BaseException | None = None
    #: the most recent tier failure (surfaced if every tier is exhausted)
    last_error: BaseException | None = None

    @property
    def resolved(self) -> bool:
        return self.result is not UNSET or self.error is not None


@dataclasses.dataclass
class WaveGroup:
    """One statement's batch within a drained wave."""

    stmt: Any  # PreparedStatement
    items: list  # [WorkItem]
    #: batches/drained counters bumped (first tier this group entered)
    counted: bool = False
    #: group was part of a fused wave that failed (legacy isolation stats)
    from_fused: bool = False
    #: group is running under a fault window (open breaker skipped its
    #: fused tier, or it was demoted): the cost router must not learn
    #: from its timings
    suppress_samples: bool = False

    def key(self):
        return self.stmt._query_fp

    def unresolved(self) -> list:
        return [it for it in self.items if not it.resolved]


class DegradationLadder:
    """Drains waves down the tier ladder; see module docstring.

    ``counters`` is any mutable mapping — the scheduler passes its own
    ``stats`` dict so ladder counters surface next to the drain counters
    clients already read.  ``clock``/``sleep`` are injectable for
    deterministic breaker-timing and backoff tests.
    """

    def __init__(self, config: ResilienceConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 counters: dict | None = None):
        self.config = config or ResilienceConfig()
        self.clock = clock
        self.sleep = sleep
        self.counters = counters if counters is not None else {}
        self.board = BreakerBoard(self.config.breaker, clock)

    # -- bookkeeping ---------------------------------------------------------
    def _bump(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    def snapshot(self) -> dict:
        """Introspection bundle (``Session.cache_stats`` style): ladder
        counters + per-breaker state/transition counts."""
        return {"counters": dict(self.counters),
                "breakers": self.board.snapshot()}

    def _count_group(self, g: WaveGroup) -> None:
        if not g.counted:
            g.counted = True
            self._bump("batches")
            self._bump("drained", len(g.items))

    def _shed_expired(self, items: list) -> list:
        """Shed-before-drain: expire overdue items with a typed error;
        return the still-live ones."""
        now = self.clock()
        live = []
        for it in items:
            if it.deadline is not None and now > it.deadline:
                it.error = DeadlineExceeded(it.deadline, now)
                self._bump("deadline_shed")
            else:
                live.append(it)
        return live

    def _sample_guard(self, session, suppress: bool = True):
        """Context excluding cost-router samples while held — retries,
        demoted tiers, and breaker-skip fallout run inside it so
        fault-window timings never train the cost model.  A no-op when
        the session has no router (or ``suppress`` is False)."""
        router = getattr(session, "cost_router", None)
        if router is None or not suppress:
            return contextlib.nullcontext()
        return router.suppress()

    def _backoff(self, attempt: int) -> None:
        d = self.config.retry.delay(attempt)
        if d > 0:
            self._bump("retry_backoffs")
            self.sleep(d)

    # -- public API ----------------------------------------------------------
    def drain(self, groups: list, *, fuse: bool = False,
              lock=None) -> None:
        """Resolve every item of every group: ladder tiers top-down,
        breaker-gated, deadline-shedding at each tier boundary.  ``lock``
        serializes session access (Session caches are not thread-safe)."""
        lock = lock if lock is not None else _NullLock()
        if fuse and len(groups) >= 2:
            self._tier_fused(groups, lock)
        for g in groups:
            self._run_group(g, lock)
            if g.from_fused and any(it.error is not None for it in g.items):
                self._bump("fused_isolated_errors")

    # -- tier: fused wave ----------------------------------------------------
    def _tier_fused(self, groups: list, lock) -> None:
        eligible = []
        for g in groups:
            if self.board.allow((g.key(), "fused")):
                eligible.append(g)
            else:
                self._bump("breaker_open_skips")
                # this group runs per-statement *because a breaker is
                # open* — a fault window, not a routing decision; its
                # timings must not train the cost model
                g.suppress_samples = True
        if len(eligible) < 2:
            return  # a lone group fuses with nobody; per-group path
        # wave-level accounting (legacy drain counters: one fused wave is
        # ONE batch however many member groups it carries)
        for g in eligible:
            if not g.counted:
                g.counted = True
                self._bump("drained", len(g.items))
        self._bump("batches")
        self._bump("fused_batches")
        self._bump("fused_statements", len(eligible))
        live_by_group = [self._shed_expired(g.items) for g in eligible]
        calls = [(g.stmt, it.params)
                 for g, live in zip(eligible, live_by_group) for it in live]
        if not calls:
            return
        session = eligible[0].stmt.session
        retry = self.config.retry
        for attempt in range(1, retry.max_attempts + 1):
            try:
                # retries are fault-window runs (something already failed
                # once); only the first attempt may train the cost model
                with lock, self._sample_guard(session, attempt > 1):
                    results = session.execute_fused(calls)
                if len(results) != len(calls):
                    raise WaveResultMismatch(len(calls), len(results),
                                             "execute_fused")
            except Exception as e:
                for g in eligible:
                    self.board.failure((g.key(), "fused"))
                if attempt < retry.max_attempts:
                    self._backoff(attempt)
                    continue
                # demote: every member group retries on its own
                # per-statement path (the isolation semantics)
                for g, live in zip(eligible, live_by_group):
                    g.from_fused = True
                    for it in live:
                        it.last_error = e
                    self._bump("fused_isolated_retries")
                    self._bump("demote_fused_to_many")
                return
            it = iter(results)
            for g, live in zip(eligible, live_by_group):
                for item in live:
                    item.result = next(it)
                self.board.success((g.key(), "fused"))
            self._bump("tier_fused_ok")
            return

    # -- tiers: per-group and per-item ---------------------------------------
    def _run_group(self, g: WaveGroup, lock) -> None:
        if not g.unresolved():
            return
        self._count_group(g)
        session = g.stmt.session
        # a group that reaches the many tier through demotion or an open
        # breaker is degradation work end-to-end; a group that starts here
        # (unfused wave) is the normal path and may train the cost model
        with self._sample_guard(session,
                                g.from_fused or g.suppress_samples):
            self._tier_many(g, lock)
        # serial/interp only ever see items a higher tier failed —
        # demotion-only tiers never train the cost model
        with self._sample_guard(session):
            self._tier_serial(g, lock)
            self._tier_interp(g, lock)
        # ladder exhausted (or fallback disabled): surface the last error
        for it in g.unresolved():
            it.error = it.last_error if it.last_error is not None else \
                ResilienceError("ladder exhausted with no recorded error")
            self._bump("ladder_exhausted")

    def _tier_many(self, g: WaveGroup, lock) -> None:
        key = (g.key(), "many")
        if not self.board.allow(key):
            self._bump("breaker_open_skips")
            self._bump("demote_many_to_serial")
            return
        live = self._shed_expired(g.unresolved())
        if not live:
            return
        retry = self.config.retry
        for attempt in range(1, retry.max_attempts + 1):
            try:
                with lock, self._sample_guard(g.stmt.session, attempt > 1):
                    results = g.stmt.execute_many([it.params for it in live])
                if len(results) != len(live):
                    raise WaveResultMismatch(len(live), len(results),
                                             "execute_many")
            except Exception as e:
                self.board.failure(key)
                if attempt < retry.max_attempts:
                    self._backoff(attempt)
                    continue
                for it in live:
                    it.last_error = e
                self._bump("demote_many_to_serial")
                return
            for it, r in zip(live, results):
                it.result = r
            self.board.success(key)
            self._bump("tier_many_ok")
            return

    def _per_item_tier(self, g: WaveGroup, lock, tier: str, run,
                       demote_key: str | None) -> None:
        """Shared per-item tier runner: breaker gate, shed, bounded
        retries of ``run(item)`` per item, demotion accounting."""
        pending = g.unresolved()
        if not pending:
            return
        key = (g.key(), tier)
        if not self.board.allow(key):
            self._bump("breaker_open_skips")
            if demote_key is not None:
                self._bump(demote_key)
            return
        retry = self.config.retry
        for it in self._shed_expired(pending):
            for attempt in range(1, retry.max_attempts + 1):
                try:
                    with lock:
                        it.result = run(it)
                except Exception as e:
                    self.board.failure(key)
                    if attempt < retry.max_attempts:
                        self._backoff(attempt)
                        continue
                    it.last_error = e
                    if demote_key is not None:
                        self._bump(demote_key)
                    break
                else:
                    self.board.success(key)
                    self._bump(f"tier_{tier}_ok")
                    break

    def _tier_serial(self, g: WaveGroup, lock) -> None:
        self._per_item_tier(
            g, lock, "serial",
            lambda it: g.stmt.execute(params=it.params),
            "demote_serial_to_interp",
        )

    def _tier_interp(self, g: WaveGroup, lock) -> None:
        if not self.config.interp_fallback:
            return
        session = g.stmt.session
        node = g.stmt.node
        self._per_item_tier(
            g, lock, "interp",
            lambda it: session.execute(node, INTERPRETED,
                                       params=it.params or None),
            None,
        )


__all__ = ["TIERS", "UNSET", "RetryPolicy", "ResilienceConfig",
           "WorkItem", "WaveGroup", "DegradationLadder"]
