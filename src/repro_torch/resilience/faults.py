"""Copy of ``src/repro/resilience/faults.py`` (device-free).

Typed resilience errors + the deterministic fault-injection harness.

Froid's production story (PAPER.md §6) hinges on safe fallback: an
unsupported construct reverts to interpreted execution instead of failing
the query.  Our engine has a four-deep stack of execution alternatives
(fused wave → batched ``execute_many`` → serial compiled ``execute`` →
per-row interpretation), and the degradation ladder (``ladder.py``) walks
it on failure.  This module supplies the two things the ladder's contract
needs to be *testable*:

* **Typed errors** — every error the resilience layer itself originates is
  a :class:`ResilienceError` subclass, so the chaos oracle can distinguish
  "the engine degraded explicitly" from "the engine corrupted or lost a
  ticket".
* **:class:`FaultInjector`** — a hook installed into the ``Session``
  executor seams (``session.fault_injector = fi`` /
  ``fi.install(session)``) that raises :class:`InjectedFault` at named
  sites (``compile`` / ``dispatch`` / ``sync`` / ``interp``), optionally
  scoped to one statement fingerprint, on an explicit occurrence schedule
  (:class:`FaultSpec`) or a seeded deterministic pseudo-random schedule
  (:meth:`FaultInjector.seeded`).  The injector never mutates engine
  state — it only raises — so any fault schedule is replayable and the
  fault-free run is byte-identical to an uninstrumented session.

Sites (each ``check`` carries the tuple of statement fingerprints the
operation serves, so specs can target one statement of a fused wave):

* ``compile``  — executable construction on a cache miss (trace + jit),
  for the unbatched, batched, sharded and fused tiers alike.
* ``dispatch`` — issuing the device call of a built executable.
* ``sync``     — blocking on a dispatched call's results.
* ``interp``   — eager per-row interpreted execution (the ladder's last
  tier; injecting here proves tickets surface *typed* errors when even
  the interpreter fails).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

#: the sites Session seams report, in pipeline order
SITES = ("compile", "dispatch", "sync", "interp")


class ResilienceError(RuntimeError):
    """Base of every error the resilience layer originates.  The chaos
    oracle's contract: under any injected fault schedule a ticket either
    carries the fault-free answer or raises one of these — never wrong
    data, never a hang."""


class InjectedFault(ResilienceError):
    """The fault-injection harness fired at a seam."""

    def __init__(self, site: str, statements: tuple, occurrence: int,
                 origin: str = "spec"):
        self.site = site
        self.statements = statements
        self.occurrence = occurrence
        self.origin = origin
        super().__init__(
            f"injected {site} fault (occurrence {occurrence}, {origin})"
        )


class DeadlineExceeded(ResilienceError):
    """A ticket's deadline passed before its work (or retry) started; it
    was shed instead of drained."""

    def __init__(self, deadline: float, now: float):
        self.deadline = deadline
        self.now = now
        super().__init__(
            f"ticket deadline exceeded ({now - deadline:.4f}s past deadline)"
        )


class WaveResultMismatch(ResilienceError):
    """A drain returned a different result count than the wave submitted —
    a protocol violation that fails the wave with a typed error (and lets
    the ladder retry a tier down) instead of leaking ``StopIteration`` or
    silently dropping results."""

    def __init__(self, expected: int, got: int, where: str):
        self.expected = expected
        self.got = got
        super().__init__(
            f"{where} returned {got} results for {expected} calls"
        )


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fail matching seam events.

    ``site``  — one of :data:`SITES` or ``"*"`` (any site).
    ``stmt``  — a statement fingerprint (``PreparedStatement._query_fp``);
    ``None`` matches any statement.  A fused-wave event matches when the
    fingerprint is *any* member of the wave.
    ``after`` — skip this many matching events before firing.
    ``times`` — fire on this many matching events, then go quiet
    (``None`` = fire forever: the persistent-failure shape circuit
    breakers exist for).
    """

    site: str = "*"
    stmt: Any = None
    after: int = 0
    times: int | None = 1
    # runtime counters (not part of the schedule identity)
    seen: int = dataclasses.field(default=0, compare=False)
    fired: int = dataclasses.field(default=0, compare=False)

    def matches(self, site: str, statements: tuple) -> bool:
        if self.site != "*" and self.site != site:
            return False
        if self.stmt is not None and self.stmt not in statements:
            return False
        return True

    def should_fire(self) -> bool:
        """Consume one matching event; True when this event faults."""
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


def _seeded_fraction(seed: int, site: str, index: int) -> float:
    """Deterministic uniform-ish fraction for event ``index`` at ``site``:
    same seed → same schedule, independent of wall clock or dict order."""
    h = hashlib.sha1(f"{seed}:{site}:{index}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultInjector:
    """Deterministic failure source for the Session executor seams.

    Explicit schedules::

        fi = FaultInjector([FaultSpec(site="dispatch", times=1)])
        fi.install(session)

    Seeded pseudo-random schedules (the chaos fuzzing surface)::

        fi = FaultInjector.seeded(seed=7, rate=0.3).install(session)

    ``events`` counts seam checks per site; ``injected`` logs every fired
    fault as ``(site, statements, occurrence)`` — the observability the
    chaos tests assert on.  ``check`` raises :class:`InjectedFault` and
    never mutates engine state, so schedules replay exactly.
    """

    def __init__(self, specs=()):
        self.specs: list[FaultSpec] = list(specs)
        self.events: dict[str, int] = {}
        self.injected: list[tuple] = []
        self._seed: int | None = None
        self._rate: float = 0.0
        self._seeded_sites: tuple = ()
        self._max_faults: int | None = None

    @classmethod
    def seeded(cls, seed: int, rate: float,
               sites: tuple = ("compile", "dispatch", "sync"),
               max_faults: int | None = None) -> "FaultInjector":
        """A deterministic pseudo-random schedule: each seam event at one
        of ``sites`` fails with probability ``rate``, decided by a hash of
        ``(seed, site, per-site event index)`` — no RNG state, so the
        schedule depends only on the event sequence.  ``max_faults``
        bounds total fired faults (so a high rate cannot starve every
        ladder tier forever)."""
        fi = cls()
        fi._seed = int(seed)
        fi._rate = float(rate)
        fi._seeded_sites = tuple(sites)
        fi._max_faults = max_faults
        return fi

    def install(self, session) -> "FaultInjector":
        session.fault_injector = self
        return self

    @property
    def fired(self) -> int:
        return len(self.injected)

    def check(self, site: str, statements: tuple = ()) -> None:
        """Seam hook: raise :class:`InjectedFault` when the schedule says
        this event fails; otherwise return (and count the event)."""
        n = self.events.get(site, 0)
        self.events[site] = n + 1
        for spec in self.specs:
            if spec.matches(site, statements) and spec.should_fire():
                self.injected.append((site, statements, n))
                raise InjectedFault(site, statements, n, origin="spec")
        if (self._seed is not None and site in self._seeded_sites
                and (self._max_faults is None
                     or self.fired < self._max_faults)
                and _seeded_fraction(self._seed, site, n) < self._rate):
            self.injected.append((site, statements, n))
            raise InjectedFault(site, statements, n, origin="seeded")


__all__ = [
    "SITES",
    "ResilienceError",
    "InjectedFault",
    "DeadlineExceeded",
    "WaveResultMismatch",
    "FaultSpec",
    "FaultInjector",
]
