"""Copy of ``src/repro/resilience/__init__.py`` (device-free).

Resilience layer: degradation ladder, circuit breakers, deadlines,
and the deterministic fault-injection harness.

Public surface re-exported here; see each module's docstring for the
design. ``ladder`` drains scheduler waves down the tier stack
(fused → many → serial → interp), ``breaker`` gates persistently
failing (statement, tier) pairs, ``faults`` supplies the typed error
taxonomy plus the :class:`FaultInjector` seam hook that chaos tests
install into a :class:`~repro_torch.core.session.Session`.
"""
from repro_torch.resilience.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerBoard,
    BreakerConfig,
    CircuitBreaker,
)
from repro_torch.resilience.faults import (
    SITES,
    DeadlineExceeded,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    ResilienceError,
    WaveResultMismatch,
)
from repro_torch.resilience.ladder import (
    TIERS,
    UNSET,
    DegradationLadder,
    ResilienceConfig,
    RetryPolicy,
    WaveGroup,
    WorkItem,
)

__all__ = [
    "SITES",
    "TIERS",
    "UNSET",
    "ResilienceError",
    "InjectedFault",
    "DeadlineExceeded",
    "WaveResultMismatch",
    "FaultSpec",
    "FaultInjector",
    "BreakerConfig",
    "CircuitBreaker",
    "BreakerBoard",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
    "RetryPolicy",
    "ResilienceConfig",
    "WorkItem",
    "WaveGroup",
    "DegradationLadder",
]
