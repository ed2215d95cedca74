"""Port of ``src/repro/serve/fleet.py`` over the port's ``Session`` and
``CoalescingScheduler``, with an explicit ``device`` (``None`` means the
card, and raises where CUDA is absent; every worker runs there).

Multi-worker serving fleet over a shared persistent plan tier.

One :class:`FleetEngine` owns N workers.  Each worker is an independent
(session, scheduler) pair — its own catalog, caches, and coalescing
microbatches — but every worker's :class:`~repro_torch.core.session.Session`
is attached to the *same* :class:`~repro_torch.persist.PlanStore`, so the
first worker to build an executable writes it and the rest warm-start
from disk (``persist_hits`` instead of re-planning), and a routed fleet's
measured costs (``save_costs``) warm-start a fresh fleet's routers.

Workers are built by a caller-supplied ``setup(session) -> {name: stmt}``
callback that registers the catalog/UDFs on the worker's fresh session
and returns its named :class:`PreparedStatement` handles — every worker
runs the same setup, so same-named statements are the same statement (the
fleet conformance oracle depends on this).

Intake is round-robin across workers by default (``submit(name, params)``);
``drain()`` flushes every worker's scheduler and returns results **in
arrival order** regardless of which worker served each request —
element-wise comparable against a single-worker serial drain of the same
queue (``conformance_util.check_fleet_oracle``'s logic).  ``parallel=True``
drains workers on threads (safe: workers share no mutable state — the
PlanStore is append-only files behind atomic renames, and the one kernel
on the path, relagg, fills its per-device state under a lock and holds its
stream's launch lock across a call's launches, whose global path shares a
kept accumulator between two kernels).
On the card every worker's work goes to the device's current stream.

DDL does not replicate automatically: ``broadcast(fn)`` applies a catalog
mutation to every worker's session, keeping the fleet's content-derived
persist keys in lockstep (a half-broadcast fleet still answers correctly
— stale workers just miss the persistent tier, they never load plans for
data they don't hold).
"""
from __future__ import annotations

import threading
from typing import Any, Callable

from repro_torch.core.session import Session
from repro_torch.serve.scheduler import CoalescingScheduler, Ticket
from repro_torch.tables.table import resolve_device


class FleetWorker:
    """One worker: a Session (shared store) + its coalescing scheduler."""

    __slots__ = ("wid", "session", "statements", "scheduler")

    def __init__(self, wid: int, session: Session,
                 statements: dict, scheduler: CoalescingScheduler):
        self.wid = wid
        self.session = session
        self.statements = statements
        self.scheduler = scheduler


class FleetEngine:
    """N (session, scheduler) workers sharing one persistent plan store.

    ``setup(session)`` must return the worker's statements as
    ``{name: PreparedStatement}``; ``store`` is a
    :class:`~repro_torch.persist.PlanStore` or a directory path (None = no
    persistence — workers still serve, each building for itself).  Every
    worker's session runs on ``device`` (the card unless ``"cpu"``).
    ``scheduler_factory`` builds each worker's scheduler (default: a plain
    :class:`CoalescingScheduler`); ``parallel`` drains workers on threads.
    """

    def __init__(self, setup: Callable[[Session], dict], *,
                 workers: int = 2, store=None, parallel: bool = False,
                 scheduler_factory: Callable[[], CoalescingScheduler]
                 | None = None, device=None):
        if workers < 1:
            raise ValueError(f"need at least one worker, got {workers}")
        self.device = resolve_device(device)
        if store is not None and not hasattr(store, "get"):
            from repro_torch.persist.store import PlanStore

            # one shared instance, not per worker
            store = PlanStore(store, device=self.device)
        self.store = store
        self.parallel = parallel
        self.workers: list[FleetWorker] = []
        for wid in range(workers):
            session = Session(device=self.device, store=store)
            stmts = setup(session)
            if not isinstance(stmts, dict) or not stmts:
                raise TypeError(
                    "setup(session) must return a non-empty "
                    f"{{name: PreparedStatement}} dict, got {stmts!r}")
            sched = (scheduler_factory() if scheduler_factory is not None
                     else CoalescingScheduler())
            self.workers.append(FleetWorker(wid, session, stmts, sched))
        self._rr = 0
        self._lock = threading.Lock()
        # arrival-order intake log: drained in submit order, not worker order
        self._inflight: list[Ticket] = []
        #: submit-to-fill seconds of every drained ticket (scheduler clock),
        #: appended at drain — the bench's p50/p99 source
        self.latencies_s: list[float] = []

    # -- intake ------------------------------------------------------------
    def submit(self, name: str, params: dict | None = None, *,
               worker: int | None = None,
               timeout_s: float | None = None) -> Ticket:
        """Queue one execution of statement ``name`` on the next worker
        (round-robin; ``worker`` pins one).  Returns the ticket — callers
        may wait on it directly, or let ``drain()`` collect it."""
        with self._lock:
            if worker is None:
                worker = self._rr % len(self.workers)
                self._rr += 1
            w = self.workers[worker]
            try:
                stmt = w.statements[name]
            except KeyError:
                raise KeyError(
                    f"unknown statement {name!r}; worker {w.wid} has "
                    f"{sorted(w.statements)}") from None
            t = w.scheduler.submit(stmt, params, timeout_s=timeout_s)
            self._inflight.append(t)
        return t

    # -- drain -------------------------------------------------------------
    def drain(self) -> list:
        """Flush every worker and return results **in arrival order**.
        A ticket that failed (resilience errors included) re-raises here —
        the fleet never papers over a wrong or missing answer."""
        with self._lock:
            tickets, self._inflight = self._inflight, []
        if self.parallel and len(self.workers) > 1:
            threads = [threading.Thread(target=w.scheduler.flush)
                       for w in self.workers]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        else:
            for w in self.workers:
                w.scheduler.flush()
        out = [t.result() for t in tickets]
        self.latencies_s.extend(
            t.latency_s for t in tickets if t.latency_s is not None)
        return out

    # -- fleet-wide control ------------------------------------------------
    def broadcast(self, fn: Callable[[Session], Any]) -> list:
        """Apply a catalog mutation (DDL, data reload, UDF swap) to every
        worker's session; returns the per-worker results in worker order."""
        return [fn(w.session) for w in self.workers]

    def save_costs(self) -> int:
        """Persist each worker's measured routing costs to the shared
        store; returns how many workers had a model worth saving."""
        return sum(1 for w in self.workers if w.session.save_costs())

    # -- observability -----------------------------------------------------
    @property
    def stats(self) -> dict:
        """Per-worker cache/persist/scheduler stats plus fleet aggregates
        (summed persist traffic, total drained, shared-store footprint)."""
        per_worker = [
            {
                "wid": w.wid,
                "cache": dict(w.session.cache_stats),
                "persist": w.session.persist_stats,
                "scheduler": dict(w.scheduler.stats),
            }
            for w in self.workers
        ]
        agg = {
            k: sum(pw["cache"].get(k, 0) for pw in per_worker)
            for k in ("persist_hits", "persist_misses", "persist_rejects")
        }
        agg["submitted"] = sum(pw["scheduler"]["submitted"]
                               for pw in per_worker)
        agg["drained"] = sum(pw["scheduler"]["drained"] for pw in per_worker)
        out = {"workers": per_worker, "fleet": agg}
        if self.store is not None:
            out["store"] = self.store.stats()
        return out


__all__ = ["FleetEngine", "FleetWorker"]
