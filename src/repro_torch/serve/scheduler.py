"""Copy of ``src/repro/serve/scheduler.py``.

Coalescing microbatch scheduler: per-request submits, set-oriented drains.

The serving path naturally produces one statement execution per request — a
serial loop of dispatch + sync, exactly the iterative shape the paper's
set-oriented argument is about.  This scheduler turns it back into batches:
concurrent ``submit`` calls for the same :class:`PreparedStatement`
accumulate in a pending microbatch, and the batch drains through
``execute_many`` (one vmapped device program) when any of

* the batch reaches ``max_batch`` (flush-on-full),
* the oldest entry has waited longer than ``window_s`` (flush-on-window;
  checked on each submit and by ``poll()``), or
* a caller forces it (``flush()``, or ``Ticket.result()`` on a pending
  ticket — a consumer that needs its answer never deadlocks waiting for
  traffic that might not arrive).

Drains run through the **degradation ladder**
(:class:`repro_torch.resilience.ladder.DegradationLadder`) by default: a failed
fused wave retries per-statement, a failed batch retries per ticket, a
failed compiled execute retries interpreted, so a ticket only surfaces an
error when the interpreter itself fails.  Per-``(statement, tier)``
circuit breakers stop persistently-failing configurations from burning
retries, and per-ticket **deadlines** (``submit(..., timeout_s=…)`` or the
scheduler-wide ``default_timeout_s``) shed expired tickets with a typed
:class:`~repro_torch.resilience.faults.DeadlineExceeded` before each tier
attempt.  ``resilience=False`` restores the bare single-tier drains.

The scheduler is synchronous and thread-safe: it never starts threads of
its own, so drains happen on the caller that trips a flush condition.
Drains are serialized on a dedicated lock (the underlying Session caches
are not thread-safe), while submits to other statements stay concurrent;
a Session driven through a scheduler must not also be driven concurrently
outside it.  ``clock`` is injectable for deterministic window tests (and
drives deadlines and breaker cooldowns too); ``sleep`` is injectable for
instant retry-backoff tests.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable

from repro_torch.core.session import PreparedStatement, QueryResult
from repro_torch.resilience.faults import WaveResultMismatch
from repro_torch.resilience.ladder import (
    UNSET as _UNSET,
    DegradationLadder,
    ResilienceConfig,
    WaveGroup,
    WorkItem,
)


class Ticket:
    """Handle for one submitted request; filled when its batch drains.
    ``_result`` uses a dedicated unset sentinel: a legitimate result may
    be any object, so ``None`` must not mean "pending"."""

    __slots__ = ("_sched", "_group", "_result", "_error", "_deadline",
                 "submitted_at", "latency_s")

    def __init__(self, sched: "CoalescingScheduler", group: "_Group",
                 deadline: float | None = None,
                 submitted_at: float | None = None):
        self._sched = sched
        self._group = group
        self._result: Any = _UNSET
        self._error: BaseException | None = None
        self._deadline = deadline
        #: scheduler-clock submit time / submit-to-fill seconds, stamped
        #: when the ticket's drain completes — the fleet bench's p50/p99
        #: source (deterministic under an injected clock)
        self.submitted_at = submitted_at
        self.latency_s: float | None = None

    def done(self) -> bool:
        return self._result is not _UNSET or self._error is not None

    def result(self) -> QueryResult:
        """The request's :class:`QueryResult`; forces a drain of the
        ticket's batch if it is still pending.  If another thread is
        mid-drain (the batch was popped but not yet filled), waits for
        that drain to finish instead of racing it.  Raises the ticket's
        error (a typed resilience error, or the raw failure once the
        ladder is exhausted) instead of returning wrong data."""
        if not self.done():
            self._sched._flush_group(self._group)
            self._group.done_evt.wait()
        if self._error is not None:
            raise self._error
        assert self._result is not _UNSET
        return self._result


class _Group:
    """Pending same-statement microbatch."""

    __slots__ = ("stmt", "params", "deadlines", "tickets", "opened_at",
                 "done_evt")

    def __init__(self, stmt: PreparedStatement, opened_at: float):
        self.stmt = stmt
        self.params: list[dict] = []
        self.deadlines: list[float | None] = []
        self.tickets: list[Ticket] = []
        self.opened_at = opened_at
        # set once every ticket is filled: drains happen outside the
        # scheduler lock, so a concurrent Ticket.result() waits on this
        # instead of racing the in-flight drain
        self.done_evt = threading.Event()


class CoalescingScheduler:
    """Accumulates concurrent same-statement requests into microbatches.

    ``max_batch`` / ``window_s`` default per statement from its policy's
    batch knobs (``ExecutionPolicy.max_batch`` / ``coalesce_window_s``), so
    presets tune coalescing without scheduler-side configuration.  For a
    mesh-sharded statement the flush-on-full threshold scales to the mesh:
    ``max_batch`` bounds the *per-device* batch, so a policy sharding over
    D devices coalesces up to ``max_batch × D`` requests before a full
    flush — online traffic fills every device instead of one.

    **Fusion drain mode** (``fuse=True``): when several *different*
    statements' batches drain together (a ``flush()``, an expired-window
    ``poll()``, or a submit that trips multiple groups), they go down as
    one mixed-statement wave through ``Session.execute_fused`` — one fused
    device program with shared scans — instead of one ``execute_many`` per
    statement.  Statements the fusability analysis rejects fall back to the
    per-statement path inside ``execute_fused``; a lone draining batch
    skips fusion entirely.

    **Adaptive coalescing** (``adaptive=True``): each statement's effective
    flush window tracks an EMA of *that statement's* inter-arrival gaps —
    ``min(window_s, adaptive_hold × ema_gap)``, i.e. hold a partial batch
    only about as long as the next few same-statement arrivals should
    take, clamped to ``[0, window_s]``.  Fast traffic drains almost
    immediately (latency tracks the arrival rate, not the worst-case
    window); sparse traffic degrades to the configured window.  The EMA is
    per statement, not global — round-robin traffic over many statements
    must not shrink every group's window below its own refill rate.  The
    injectable ``clock`` keeps the EMA deterministic in tests.

    **Resilience** (``resilience=True``, the default): drains run through
    the degradation ladder (fused → many → serial → interp) with circuit
    breakers and deadlines; pass a
    :class:`~repro_torch.resilience.ladder.ResilienceConfig` to tune retries /
    breaker thresholds, or ``False`` for the bare single-tier drains.
    ``default_timeout_s`` gives every ticket a deadline unless its
    ``submit`` overrides one.

    Stats (``self.stats``): submitted, batches, drained, flush reasons,
    fused_batches / fused_statements, plus — under resilience — the ladder
    counters (``demote_*``, ``tier_*_ok``, ``deadline_shed``,
    ``breaker_open_skips``, ``retry_backoffs``, ``ladder_exhausted``).
    ``resilience_stats`` bundles those with per-breaker state snapshots.
    """

    def __init__(self, max_batch: int | None = None,
                 window_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 fuse: bool = False,
                 adaptive: bool = False,
                 adaptive_alpha: float = 0.2,
                 adaptive_hold: float = 4.0,
                 resilience: "ResilienceConfig | bool" = True,
                 default_timeout_s: float | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_batch = max_batch
        self.window_s = window_s
        self.clock = clock
        self.fuse = fuse
        self.adaptive = adaptive
        self.adaptive_alpha = adaptive_alpha
        self.adaptive_hold = adaptive_hold
        self.default_timeout_s = default_timeout_s
        # id(stmt) -> (last arrival, EMA gap | None); bounded by the
        # statement population (sessions cap prepared handles)
        self._arrivals: dict[int, tuple[float, float | None]] = {}
        self._lock = threading.Lock()
        # serializes drains: execute_many mutates Session caches that have
        # no synchronization of their own
        self._drain_lock = threading.Lock()
        self._groups: dict[int, _Group] = {}  # id(stmt) -> pending batch
        self.stats = {
            "submitted": 0, "batches": 0, "drained": 0,
            "flush_full": 0, "flush_window": 0, "flush_forced": 0,
            "fused_batches": 0, "fused_statements": 0,
            "fused_isolated_retries": 0, "fused_isolated_errors": 0,
            # waves whose fuse-or-not choice came from the cost router
            # (mixed-statement waves of routed statements only)
            "routed_waves": 0,
        }
        self.ladder: DegradationLadder | None = None
        if resilience:
            cfg = resilience if isinstance(resilience, ResilienceConfig) \
                else None
            # ladder counters land in self.stats so demotions/sheds read
            # next to the drain counters clients already watch
            self.ladder = DegradationLadder(cfg, clock=clock, sleep=sleep,
                                            counters=self.stats)
            self.stats.update({
                "deadline_shed": 0, "breaker_open_skips": 0,
                "retry_backoffs": 0, "ladder_exhausted": 0,
                "demote_fused_to_many": 0, "demote_many_to_serial": 0,
                "demote_serial_to_interp": 0,
                "tier_fused_ok": 0, "tier_many_ok": 0,
                "tier_serial_ok": 0, "tier_interp_ok": 0,
            })

    # -- knob resolution ----------------------------------------------------
    def _max_batch(self, stmt: PreparedStatement) -> int:
        base = (self.max_batch if self.max_batch is not None
                else stmt.policy.max_batch)
        # mesh-sized buckets: per-device bound × data-parallel shard count
        return base * stmt.policy.shard_devices()

    def _window(self, stmt: PreparedStatement) -> float:
        return (self.window_s if self.window_s is not None
                else stmt.policy.coalesce_window_s)

    def ema_gap_s(self, stmt: PreparedStatement) -> float | None:
        """``stmt``'s inter-arrival EMA (None until two submits arrive)."""
        _, ema = self._arrivals.get(id(stmt), (None, None))
        return ema

    def effective_window(self, stmt: PreparedStatement) -> float:
        """The flush window actually in force for ``stmt``: the configured
        window, shrunk by ``stmt``'s own arrival-rate EMA under
        ``adaptive``."""
        base = self._window(stmt)
        ema = self.ema_gap_s(stmt)
        if not self.adaptive or ema is None:
            return base
        return min(base, max(0.0, ema * self.adaptive_hold))

    def _observe_arrival_locked(self, stmt: PreparedStatement,
                                now: float) -> None:
        if not self.adaptive:
            return
        last, ema = self._arrivals.get(id(stmt), (None, None))
        if last is not None:
            gap = now - last
            a = self.adaptive_alpha
            ema = gap if ema is None else a * gap + (1.0 - a) * ema
        self._arrivals[id(stmt)] = (now, ema)

    @property
    def resilience_stats(self) -> dict | None:
        """Ladder counters + per-``(statement, tier)`` breaker snapshot
        (state and opened/reopened/restored/probes/rejected counts); None
        when resilience is off."""
        return None if self.ladder is None else self.ladder.snapshot()

    # -- public API ----------------------------------------------------------
    def submit(self, stmt: PreparedStatement, params: dict | None = None,
               timeout_s: float | None = None) -> Ticket:
        """Queue one execution of ``stmt``; returns its :class:`Ticket`.
        May drain (this or another) batch if a flush condition trips.
        ``timeout_s`` (default: the scheduler's ``default_timeout_s``)
        gives the ticket an absolute deadline; a ticket still undrained
        when it expires is shed with
        :class:`~repro_torch.resilience.faults.DeadlineExceeded` instead of
        executed (shed-before-drain)."""
        to_drain: list[_Group] = []
        with self._lock:
            self.stats["submitted"] += 1
            now = self.clock()
            self._observe_arrival_locked(stmt, now)
            t_s = timeout_s if timeout_s is not None else self.default_timeout_s
            deadline = (now + t_s) if t_s is not None else None
            g = self._groups.get(id(stmt))
            if g is None:
                g = _Group(stmt, now)
                self._groups[id(stmt)] = g
            t = Ticket(self, g, deadline, submitted_at=now)
            g.params.append(dict(params) if params else {})
            g.deadlines.append(deadline)
            g.tickets.append(t)
            if len(g.params) >= self._max_batch(stmt):
                self.stats["flush_full"] += 1
                self._groups.pop(id(stmt), None)
                to_drain.append(g)
            to_drain.extend(self._take_expired_locked())
        self._drain_all(to_drain)
        return t

    def poll(self) -> int:
        """Drain every batch whose coalesce window has expired; returns the
        number of requests drained.  Serving loops call this once per tick."""
        with self._lock:
            expired = self._take_expired_locked()
        n = sum(len(g.params) for g in expired)
        self._drain_all(expired)
        return n

    def flush(self) -> int:
        """Drain all pending batches regardless of window; returns the
        number of requests drained.  Under fusion drain mode a
        mixed-statement flush goes down as one fused wave."""
        with self._lock:
            groups = list(self._groups.values())
            self._groups.clear()
            if groups:
                self.stats["flush_forced"] += len(groups)
        n = sum(len(g.params) for g in groups)
        self._drain_all(groups)
        return n

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(g.params) for g in self._groups.values())

    # -- internals -----------------------------------------------------------
    def _take_expired_locked(self) -> list[_Group]:
        now = self.clock()
        expired = [
            g for g in self._groups.values()
            if now - g.opened_at >= self.effective_window(g.stmt)
        ]
        for g in expired:
            self._groups.pop(id(g.stmt), None)
            self.stats["flush_window"] += 1
        return expired

    def _flush_group(self, group: _Group) -> None:
        """Forced drain of one batch (Ticket.result on a pending ticket)."""
        with self._lock:
            live = self._groups.get(id(group.stmt))
            if live is not group:
                return  # already drained by another path
            self._groups.pop(id(group.stmt), None)
            self.stats["flush_forced"] += 1
        self._drain_all([group])

    def _route_fuse(self, groups: list[_Group]) -> bool:
        """Wave-level fuse-or-not routing.  When fusion drain mode is on,
        the wave is mixed-statement, and every member statement is routed
        (``policy.route``) on one shared session, the session's cost
        router picks between the fused wave and per-statement drains from
        measured wave costs (each arm explored once, then the cheaper
        wins).  Any unrouted member — or a single-statement wave — keeps
        the scheduler's static ``fuse`` knob."""
        if not (self.fuse and len(groups) >= 2):
            return self.fuse
        stmts = [g.stmt for g in groups]
        if not all(s.policy.route for s in stmts):
            return self.fuse
        sess = stmts[0].session
        if any(s.session is not sess for s in stmts[1:]):
            return self.fuse
        router = sess._ensure_router()
        self.stats["routed_waves"] += 1
        return router.choose_fuse([(g.stmt, len(g.params)) for g in groups])

    def _drain_all(self, groups: list[_Group]) -> None:
        """Drain a set of batches that tripped together: through the
        degradation ladder under resilience (one fused wave when fusion
        drain mode is on and the wave is mixed-statement, demoting on
        failure), else the bare single-tier drains.  Routed waves may
        override the fuse choice per wave (``_route_fuse``)."""
        if not groups:
            return
        fuse = self._route_fuse(groups)
        if self.ladder is not None:
            self._drain_ladder(groups, fuse)
            return
        if fuse and len(groups) >= 2:
            self._drain_fused(groups)
            return
        for g in groups:
            self._drain(g)

    def _drain_ladder(self, groups: list[_Group],
                      fuse: bool | None = None) -> None:
        """Ladder-backed drain: hand the wave to the resilience layer,
        then map every WorkItem outcome onto its ticket.  The ladder
        resolves every item with a result or a typed/raw error; an
        interrupt (BaseException) mid-ladder parks a diagnostic on the
        still-unresolved tickets and re-raises."""
        wave = [
            WaveGroup(g.stmt, [WorkItem(p, deadline=d)
                               for p, d in zip(g.params, g.deadlines)])
            for g in groups
        ]
        try:
            self.ladder.drain(wave, fuse=self.fuse if fuse is None else fuse,
                              lock=self._drain_lock)
        except BaseException as e:
            for g, wg in zip(groups, wave):
                for t, it in zip(g.tickets, wg.items):
                    if it.error is not None:
                        t._error = it.error
                    elif it.result is not _UNSET:
                        t._result = it.result
                    else:
                        t._error = e
            raise
        else:
            for g, wg in zip(groups, wave):
                for t, it in zip(g.tickets, wg.items):
                    if it.error is not None:
                        t._error = it.error
                    else:
                        t._result = it.result
        finally:
            for g in groups:
                self._finish(g)

    # -- bare drains (resilience=False) --------------------------------------
    def _drain_fused(self, groups: list[_Group]) -> None:
        """Mixed-statement drain through ``Session.execute_fused``, with
        **per-group error isolation**: when the fused wave fails (one
        member referencing a dropped table must not poison every ticket of
        the wave), each statement's batch retries independently on its own
        per-statement path — only the genuinely failing group's tickets
        carry the error, and ``stats['fused_isolated_retries']`` /
        ``['fused_isolated_errors']`` record the fallout."""
        self.stats["batches"] += 1
        self.stats["drained"] += sum(len(g.params) for g in groups)
        self.stats["fused_batches"] += 1
        self.stats["fused_statements"] += len(groups)
        calls = [(g.stmt, p) for g in groups for p in g.params]
        try:
            with self._drain_lock:
                # execute_fused routes foreign-session / non-fusable
                # statements back to their own per-statement path
                results = groups[0].stmt.session.execute_fused(calls)
            if len(results) != len(calls):
                # a protocol violation must fail the wave with a typed
                # error, not leak StopIteration from the zip below
                raise WaveResultMismatch(len(calls), len(results),
                                         "execute_fused")
            it = iter(results)
            for g in groups:
                for t in g.tickets:
                    t._result = next(it)
        except Exception:
            # the wave failed as a unit; re-run each group alone so the
            # failure lands only on the tickets that earn it.  These are
            # fault-window runs: the cost router must not learn from them
            router = getattr(groups[0].stmt.session, "cost_router", None)
            suppress = (router.suppress if router is not None
                        else contextlib.nullcontext)
            try:
                for g in groups:
                    self.stats["fused_isolated_retries"] += 1
                    try:
                        with self._drain_lock, suppress():
                            rs = g.stmt.execute_many(g.params)
                        if len(rs) != len(g.tickets):
                            raise WaveResultMismatch(len(g.tickets), len(rs),
                                                     "execute_many")
                        for t, r in zip(g.tickets, rs):
                            t._result = r
                    except Exception as e:
                        self.stats["fused_isolated_errors"] += 1
                        for t in g.tickets:
                            t._error = e
            except BaseException as e:  # interrupt mid-retry: park a
                for g in groups:        # diagnostic on every unfilled
                    for t in g.tickets:  # ticket, let the interrupt rise
                        if t._result is _UNSET and t._error is None:
                            t._error = e
                raise
        except BaseException as e:  # KeyboardInterrupt/SystemExit: park a
            for g in groups:         # diagnostic on the tickets, but let
                for t in g.tickets:  # the interrupt reach the caller
                    t._error = e
            raise
        finally:
            for g in groups:
                self._finish(g)

    def _finish(self, group: _Group) -> None:
        """Stamp submit-to-fill latency on the group's tickets and release
        their waiters (every drain path funnels through here)."""
        now = self.clock()
        for t in group.tickets:
            if t.submitted_at is not None:
                t.latency_s = now - t.submitted_at
        group.done_evt.set()

    def _drain(self, group: _Group) -> None:
        self.stats["batches"] += 1
        self.stats["drained"] += len(group.params)
        try:
            with self._drain_lock:
                results = group.stmt.execute_many(group.params)
            if len(results) != len(group.tickets):
                raise WaveResultMismatch(len(group.tickets), len(results),
                                         "execute_many")
            for t, r in zip(group.tickets, results):
                t._result = r
        except Exception as e:  # fan the failure out to every waiter
            for t in group.tickets:
                t._error = e
        except BaseException as e:  # KeyboardInterrupt/SystemExit: park a
            for t in group.tickets:  # diagnostic on the tickets, but let
                t._error = e         # the interrupt reach the caller
            raise
        finally:
            self._finish(group)


__all__ = ["CoalescingScheduler", "Ticket"]
