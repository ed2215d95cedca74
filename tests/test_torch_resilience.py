"""The port's resilience layer (``repro_torch.resilience``: breaker, fault
injector, degradation ladder) and the scheduler's drains through it,
against the port's ``Session``, on the CPU.

Ports every case of ``tests/test_resilience.py`` that uses neither
``fuse=True`` nor ``check_chaos_oracle``: the breaker state machine and
the injector's schedules (``:72-180``), the ticket sentinel, the bare and
laddered ``execute_many`` result-count mismatch, demotion to serial and to
interp at each fault site, the typed interp error, in-tier retry backoff,
the breaker's open / half-open / reopen cycle on the ladder, deadlines
(shed before drain, none without a timeout, admission's timeout) and
``ServeEngine.drain`` shedding expired admission tickets; and the ladder's
fused tier with its breaker skipping wave membership.  The other fused
cases and the chaos oracle's FROID legs are in ``test_torch_fused.py``.

Beside each case's own assertions, the fault-site cases run the same
schedule through the reference's ``Session`` and scheduler and hold the
port to its counters: the scheduler's stats and the injector's events per
site, which fix where the port's seams sit.
"""
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as PC
from repro.resilience import FaultInjector as RefInjector
from repro.resilience import FaultSpec as RefSpec
from repro.serve.scheduler import CoalescingScheduler as RefScheduler
from repro_torch.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerConfig,
    CircuitBreaker,
    DeadlineExceeded,
    FaultInjector,
    FaultSpec,
    InjectedFault,
    ResilienceConfig,
    ResilienceError,
    RetryPolicy,
    WaveResultMismatch,
)
from repro_torch.serve.scheduler import CoalescingScheduler

from test_torch_correlated import no_vmap_fallback


class Clock:
    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def _mk(M=PC, n: int = 8):
    """Session + two distinct prepared statements over one small table."""
    s = M.Session(device="cpu") if M is PC else M.Session()
    s.create_table("T", x=np.arange(n, dtype=np.int32))
    q1 = M.scan("T").filter(M.col("x") < M.param("cutoff")).project("x")
    q2 = M.scan("T").compute(y=M.col("x") * M.param("m")).project("x", "y")
    return s, s.prepare(q1, M.FROID), s.prepare(q2, M.FROID)


def _sched(clock=None, cls=CoalescingScheduler, **kw):
    kw.setdefault("max_batch", 64)
    kw.setdefault("window_s", 1e9)
    kw.setdefault("sleep", lambda s: None)
    if clock is not None:
        kw["clock"] = clock
    return cls(**kw)


def _xs(result):
    return np.asarray(result.table.columns["x"].data).tolist()


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


# ---------------------------------------------------------------------------
# circuit breaker state machine
# ---------------------------------------------------------------------------


def test_breaker_opens_at_threshold_within_window():
    c = Clock()
    b = CircuitBreaker(BreakerConfig(failure_threshold=3, window_s=10.0,
                                     cooldown_s=5.0), clock=c)
    assert b.state == CLOSED and b.allow()
    b.record_failure(); b.record_failure()
    assert b.state == CLOSED
    b.record_failure()
    assert b.state == OPEN and b.stats["opened"] == 1
    assert not b.allow() and b.stats["rejected"] == 1


def test_breaker_window_prunes_old_failures():
    c = Clock()
    b = CircuitBreaker(BreakerConfig(failure_threshold=3, window_s=10.0), clock=c)
    b.record_failure()
    c.now = 11.0
    b.record_failure(); b.record_failure()
    assert b.state == CLOSED
    b.record_failure()
    assert b.state == OPEN


def test_breaker_half_open_probe_restores():
    c = Clock()
    b = CircuitBreaker(BreakerConfig(failure_threshold=1, cooldown_s=5.0), clock=c)
    b.record_failure()
    assert b.state == OPEN and not b.allow()
    c.now = 6.0
    assert b.allow() and b.state == HALF_OPEN and b.stats["probes"] == 1
    b.record_success()
    assert b.state == CLOSED and b.stats["restored"] == 1
    assert b.allow()


def test_breaker_half_open_probe_failure_reopens():
    c = Clock()
    b = CircuitBreaker(BreakerConfig(failure_threshold=1, cooldown_s=5.0), clock=c)
    b.record_failure()
    c.now = 6.0
    assert b.allow() and b.state == HALF_OPEN
    b.record_failure()
    assert b.state == OPEN and b.stats["reopened"] == 1
    assert not b.allow()
    c.now = 12.0
    assert b.allow() and b.state == HALF_OPEN


# ---------------------------------------------------------------------------
# fault injector schedule semantics
# ---------------------------------------------------------------------------


def test_fault_spec_site_stmt_after_times():
    fp = ("some", "fingerprint")
    fi = FaultInjector([FaultSpec(site="dispatch", stmt=fp, after=1, times=2)])
    fi.check("dispatch", ())
    fi.check("compile", (fp,))
    fi.check("dispatch", (fp,))
    with pytest.raises(InjectedFault):
        fi.check("dispatch", (fp,))
    with pytest.raises(InjectedFault):
        fi.check("dispatch", (fp, ("other",)))
    fi.check("dispatch", (fp,))
    assert fi.fired == 2
    assert fi.events == {"dispatch": 5, "compile": 1}


def test_fault_spec_times_none_fires_forever():
    fi = FaultInjector([FaultSpec(site="sync", times=None)])
    for _ in range(5):
        with pytest.raises(InjectedFault):
            fi.check("sync", ())
    assert fi.fired == 5


def _fire_pattern(fi, site: str, n: int, exc=InjectedFault) -> list:
    pat = []
    for _ in range(n):
        try:
            fi.check(site, ())
            pat.append(0)
        except exc:
            pat.append(1)
    return pat


def test_seeded_schedule_is_deterministic_and_seed_sensitive():
    a = _fire_pattern(FaultInjector.seeded(5, 0.5), "dispatch", 64)
    b = _fire_pattern(FaultInjector.seeded(5, 0.5), "dispatch", 64)
    other = _fire_pattern(FaultInjector.seeded(6, 0.5), "dispatch", 64)
    assert a == b
    assert a != other
    assert 0 < sum(a) < 64
    # the same schedule as the reference's injector draws from one seed
    from repro.resilience import InjectedFault as RefFault

    assert a == _fire_pattern(RefInjector.seeded(5, 0.5), "dispatch", 64, RefFault)


def test_seeded_schedule_max_faults_bounds_firing():
    fi = FaultInjector.seeded(5, 1.0, max_faults=3)
    pat = _fire_pattern(fi, "dispatch", 10)
    assert sum(pat) == 3 and fi.fired == 3
    assert pat[:3] == [1, 1, 1]


# ---------------------------------------------------------------------------
# Ticket sentinel and result-count guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resilience", [True, False])
def test_ticket_sentinel_distinguishes_none_result(monkeypatch, resilience):
    s, stmt, _ = _mk()
    sched = _sched(resilience=resilience)
    t = sched.submit(stmt, {"cutoff": 3})
    monkeypatch.setattr(stmt, "execute_many", lambda plist: [None] * len(plist))
    sched.flush()
    assert t.done()
    assert t.result() is None


def test_bare_many_drain_result_mismatch_is_typed(monkeypatch):
    s, stmt, _ = _mk()
    sched = _sched(resilience=False)
    real = stmt.execute_many
    monkeypatch.setattr(stmt, "execute_many", lambda plist: real(plist)[:-1])
    t = sched.submit(stmt, {"cutoff": 3})
    sched.flush()
    assert t.done()
    with pytest.raises(WaveResultMismatch):
        t.result()


def test_ladder_recovers_from_result_mismatch(monkeypatch):
    s, stmt, _ = _mk()
    sched = _sched()
    real = stmt.execute_many
    monkeypatch.setattr(stmt, "execute_many", lambda plist: real(plist)[:-1])
    t = sched.submit(stmt, {"cutoff": 4})
    sched.flush()
    assert _xs(t.result()) == [0, 1, 2, 3]
    assert sched.stats["demote_many_to_serial"] == 1
    assert sched.stats["tier_serial_ok"] == 1


# ---------------------------------------------------------------------------
# degradation ladder: demotions per site and tier, beside the reference
# ---------------------------------------------------------------------------


def _drain_under(M, Injector, Spec, Sched, specs, cutoffs=(4,), attempts=1):
    """One drain of ``cutoffs`` through a resilient scheduler (``attempts``
    tries a tier) with the fault ``specs`` installed, in either package:
    (xs per ticket or the error's type name, scheduler stats, injector
    events, faults fired)."""
    import repro.resilience as ref_resilience
    import repro_torch.resilience as port_resilience

    res = port_resilience if M is PC else ref_resilience
    s, stmt, _ = _mk(M)
    fi = Injector([Spec(**sp) for sp in specs]).install(s)
    cfg = res.ResilienceConfig(retry=res.RetryPolicy(max_attempts=attempts))
    sched = _sched(cls=Sched, resilience=cfg)
    ts = [sched.submit(stmt, {"cutoff": c}) for c in cutoffs]
    sched.flush()
    out = []
    for t in ts:
        try:
            out.append(_xs(t.result()))
        except Exception as e:  # noqa: BLE001 - compared by type name
            out.append(type(e).__name__)
    return out, dict(sched.stats), dict(fi.events), fi.fired


def _both(specs, **kw):
    port = _drain_under(PC, FaultInjector, FaultSpec, CoalescingScheduler, specs, **kw)
    ref = _drain_under(RC, RefInjector, RefSpec, RefScheduler, specs, **kw)
    assert port[0] == ref[0], "results"
    assert port[1] == ref[1], "scheduler stats"
    assert port[2] == ref[2], "injector events per site"
    assert port[3] == ref[3], "faults fired"
    return port


@pytest.mark.parametrize("site", ["compile", "dispatch", "sync"])
def test_single_statement_fault_demotes_to_serial(site):
    out, stats, _, _ = _both([dict(site=site, times=1)])
    assert out == [[0, 1, 2, 3]]
    assert stats["demote_many_to_serial"] == 1
    assert stats["tier_serial_ok"] == 1
    assert stats["ladder_exhausted"] == 0


def test_fault_chain_demotes_to_interp():
    out, stats, _, fired = _both([dict(site="dispatch", times=None)])
    assert out == [[0, 1, 2, 3]]
    assert stats["demote_many_to_serial"] == 1
    assert stats["demote_serial_to_interp"] == 1
    assert stats["tier_interp_ok"] == 1
    assert fired >= 2


def test_interp_fault_surfaces_typed_error():
    out, stats, _, _ = _both([dict(site="*", times=None)])
    assert out == ["InjectedFault"]
    assert stats["ladder_exhausted"] == 1
    assert stats["tier_interp_ok"] == 0
    s, stmt, _ = _mk()
    FaultInjector([FaultSpec(site="*", times=None)]).install(s)
    sched = _sched()
    t = sched.submit(stmt, {"cutoff": 4})
    sched.flush()
    with pytest.raises(InjectedFault):
        t.result()
    assert issubclass(InjectedFault, ResilienceError)


def test_faults_on_a_batch_of_tickets_match_the_reference():
    """A compile fault and a sync fault over a three-ticket batch, two
    tries a tier: the many tier fails twice and demotes, and each ticket
    answers on the serial tier."""
    out, stats, _, _ = _both([dict(site="compile", times=1), dict(site="sync", times=1)],
                             cutoffs=(2, 5, 8), attempts=2)
    assert out == [[0, 1], [0, 1, 2, 3, 4], list(range(8))]


def test_retry_backoff_within_tier():
    s, stmt, _ = _mk()
    FaultInjector([FaultSpec(site="dispatch", times=2)]).install(s)
    sleeps: list = []
    cfg = ResilienceConfig(retry=RetryPolicy(max_attempts=3, backoff_s=0.1, backoff_mult=2.0))
    sched = _sched(resilience=cfg, sleep=sleeps.append)
    t = sched.submit(stmt, {"cutoff": 4})
    sched.flush()
    assert _xs(t.result()) == [0, 1, 2, 3]
    assert sched.stats["tier_many_ok"] == 1
    assert sched.stats["demote_many_to_serial"] == 0
    assert sched.stats["retry_backoffs"] == 2
    np.testing.assert_allclose(sleeps, [0.1, 0.2])


# ---------------------------------------------------------------------------
# circuit breakers on the serving path
# ---------------------------------------------------------------------------


def _drain_one(sched, stmt, cutoff=4):
    t = sched.submit(stmt, {"cutoff": cutoff})
    sched.flush()
    return t


def test_breaker_opens_then_half_open_probe_restores():
    s, stmt, _ = _mk()
    fi = FaultInjector([FaultSpec(site="dispatch", times=None)]).install(s)
    c = Clock()
    cfg = ResilienceConfig(breaker=BreakerConfig(
        failure_threshold=2, window_s=100.0, cooldown_s=5.0))
    sched = _sched(clock=c, resilience=cfg)
    key_many = (stmt._query_fp, "many")
    board = sched.ladder.board
    for _ in range(2):
        assert _xs(_drain_one(sched, stmt).result()) == [0, 1, 2, 3]
    assert board.state(key_many) == OPEN
    assert board.state((stmt._query_fp, "serial")) == OPEN
    fired_before = fi.fired
    skips_before = sched.stats["breaker_open_skips"]
    t = _drain_one(sched, stmt)
    assert _xs(t.result()) == [0, 1, 2, 3]
    assert sched.stats["breaker_open_skips"] >= skips_before + 2
    assert fi.fired == fired_before
    fi.specs.clear()
    c.now += 10.0
    t = _drain_one(sched, stmt)
    assert _xs(t.result()) == [0, 1, 2, 3]
    assert board.state(key_many) == CLOSED
    snap = sched.resilience_stats["breakers"][key_many]
    assert snap["opened"] == 1 and snap["probes"] == 1
    assert snap["restored"] == 1
    assert sched.stats["tier_many_ok"] >= 1


def test_breaker_half_open_probe_failure_reopens_on_ladder():
    s, stmt, _ = _mk()
    FaultInjector([FaultSpec(site="dispatch", times=None)]).install(s)
    c = Clock()
    cfg = ResilienceConfig(breaker=BreakerConfig(
        failure_threshold=1, window_s=100.0, cooldown_s=5.0))
    sched = _sched(clock=c, resilience=cfg)
    key = (stmt._query_fp, "many")
    _drain_one(sched, stmt)
    assert sched.ladder.board.state(key) == OPEN
    c.now += 10.0
    t = _drain_one(sched, stmt)
    assert _xs(t.result()) == [0, 1, 2, 3]
    snap = sched.resilience_stats["breakers"][key]
    assert snap["reopened"] == 1
    assert sched.ladder.board.state(key) == OPEN


def test_ladder_refuses_a_fused_wave():
    """The fused tier refused waves until ``Session.execute_fused`` was
    ported (ROADMAP A7).  Now it drains them: a wave of two statements
    resolves in one fused tier run; and, beside the reference
    (``tests/test_resilience.py::test_fused_tier_breaker_skips_wave_membership``),
    an open fused-tier breaker drops its statement out of the next wave,
    which then drains per statement with no new fused wave."""
    from repro_torch.resilience import DegradationLadder, WaveGroup, WorkItem

    s, stmt1, stmt2 = _mk()
    wave = [WaveGroup(stmt1, [WorkItem({"cutoff": 3})]),
            WaveGroup(stmt2, [WorkItem({"m": 2})])]
    ladder = DegradationLadder()
    ladder.drain(wave, fuse=True)
    assert _xs(wave[0].items[0].result) == [0, 1, 2]
    assert len(_xs(wave[1].items[0].result)) == 8
    assert wave[0].items[0].result.stats["fused"]
    assert ladder.counters["tier_fused_ok"] == 1 and ladder.counters["fused_batches"] == 1

    def skips(M, Injector, Spec, Sched):
        import repro.resilience as ref_resilience
        import repro_torch.resilience as port_resilience

        res = port_resilience if M is PC else ref_resilience
        s, stmt1, stmt2 = _mk(M)
        fi = Injector([Spec(site="dispatch", times=None)]).install(s)
        cfg = res.ResilienceConfig(breaker=res.BreakerConfig(
            failure_threshold=1, window_s=100.0, cooldown_s=1e9))
        sched = _sched(cls=Sched, fuse=True, resilience=cfg)
        t1, t2 = sched.submit(stmt1, {"cutoff": 3}), sched.submit(stmt2, {"m": 2})
        sched.flush()  # the wave fails; both fused breakers open
        t1.result(), t2.result()
        fb = sched.stats["fused_batches"]
        fi.specs.clear()
        t1, t2 = sched.submit(stmt1, {"cutoff": 3}), sched.submit(stmt2, {"m": 2})
        sched.flush()
        return _xs(t1.result()), fb, dict(sched.stats)

    got = skips(PC, FaultInjector, FaultSpec, CoalescingScheduler)
    assert got == skips(RC, RefInjector, RefSpec, RefScheduler)
    xs, fb, stats = got
    assert xs == [0, 1, 2] and stats["fused_batches"] == fb
    assert stats["breaker_open_skips"] >= 2


# ---------------------------------------------------------------------------
# deadlines: shed-before-drain
# ---------------------------------------------------------------------------


def test_expired_ticket_sheds_with_typed_error():
    s, stmt, _ = _mk()
    c = Clock()
    sched = _sched(clock=c, default_timeout_s=5.0)
    t_live = sched.submit(stmt, {"cutoff": 3})
    t_dead = sched.submit(stmt, {"cutoff": 4}, timeout_s=1.0)
    c.now = 3.0
    sched.flush()
    assert _xs(t_live.result()) == [0, 1, 2]
    assert t_dead.done()
    with pytest.raises(DeadlineExceeded):
        t_dead.result()
    assert sched.stats["deadline_shed"] == 1


def test_deadline_shed_is_pre_drain_not_mid_ladder():
    s, stmt, _ = _mk()
    fi = FaultInjector([]).install(s)
    c = Clock()
    sched = _sched(clock=c, default_timeout_s=1.0)
    ts = [sched.submit(stmt, {"cutoff": k}) for k in (2, 3)]
    c.now = 10.0
    sched.flush()
    for t in ts:
        with pytest.raises(DeadlineExceeded):
            t.result()
    assert sched.stats["deadline_shed"] == 2
    assert fi.events == {}


def test_no_timeout_means_no_deadline():
    s, stmt, _ = _mk()
    c = Clock()
    sched = _sched(clock=c)
    t = sched.submit(stmt, {"cutoff": 3})
    c.now = 1e12
    sched.flush()
    assert _xs(t.result()) == [0, 1, 2]
    assert sched.stats["deadline_shed"] == 0


def test_admission_timeout_passthrough():
    from repro_torch.serve.admission import AdmissionPolicy

    c = Clock()
    sched = _sched(clock=c)
    ap = AdmissionPolicy(scheduler=sched, device="cpu")
    t = ap.submit(tier=1, prompt_len=100, max_new_tokens=50,
                  temperature=0.5, timeout_s=2.0)
    c.now = 5.0
    ap.scheduler.flush()
    with pytest.raises(DeadlineExceeded):
        t.result()
    assert sched.stats["deadline_shed"] == 1


# ---------------------------------------------------------------------------
# serving engine: shed completions instead of crashed drains
# ---------------------------------------------------------------------------


def test_serve_engine_drain_sheds_expired_admission():
    from repro_torch import configs as tconfigs
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    class Step:  # every clock() call advances 1s: tickets expire between
        def __init__(self):  # submit and drain
            self.now = 0.0

        def __call__(self):
            self.now += 1.0
            return self.now

    cfg = tconfigs.smoke_config_for("granite3_2b")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    sched = _sched(clock=Step(), default_timeout_s=0.5)
    eng = ServeEngine(model, slots=2, max_len=64, admission_scheduler=sched)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32),
            max_new_tokens=4))
    done = eng.drain()
    assert len(done) == 3
    assert all(c.reason == "shed" and c.tokens == [] for c in done)
    assert len(eng.shed) == 3
    assert sched.stats["deadline_shed"] == 3
