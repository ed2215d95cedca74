"""The port's multi-worker fleet (``repro_torch.serve.FleetEngine``) over the
shared persistent plan store, on the CPU.

Ports ``tests/test_fleet.py``: the fleet oracle across its axes (workers
1/2/3, no store, an empty table, warm start, sharing within a cold fleet,
DDL broadcast, parallel drains, a corrupt store, a stale stamp, injected
faults), the engine's intake, latencies, stats and cost persistence.  The
oracle is ``conformance_util.check_fleet_oracle``'s logic over the port's
``FleetEngine`` (:func:`check_fleet_oracle_port`), with the harness's
query functions rebound to the port's frontend (``test_torch_fused.PCU``), held
to the reference's serial FROID answers: masks, keys and counts exactly,
floats rtol 1e-4 (``assert_masked``).  The admission case
(``test_admission_store_warm_start``) is in ``tests/test_torch_serve.py``.

Then: ``FleetEngine()`` with no device raises without CUDA, and
``chip_smoke.py``'s fleet phase rehearsed on the CPU at 3,000 rows.
"""
from __future__ import annotations

import glob
import importlib.util
import os
import pathlib
import warnings

import pytest

import conformance_util as CU
import repro.core as RC
import repro_torch.core as PC
from repro_torch.persist import PlanCacheWarning, PlanStore, runtime_stamp
from repro_torch.resilience import FaultInjector, FaultSpec
from repro_torch.serve import FleetEngine
from repro_torch.serve.scheduler import CoalescingScheduler

from test_torch_correlated import assert_masked, no_vmap_fallback
from test_torch_fused import PCU
from test_torch_interpreter import PROGRAMS, _program_udf

N_ROWS = 23
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


def fleet_setup(seed: int, n_rows: int, policy):
    """``conformance_util.fleet_setup`` on the port: every worker loads the
    same tables and UDF and exposes the fusion oracle's statements as
    ``q0``/``q1``/``q2``."""

    def setup(session):
        PCU.populate_session(session, seed, n_rows)
        session.create_function(_program_udf(PC, PROGRAMS["uncorrelated_sum_case"](PC)))
        return {f"q{i}": session.prepare(q, policy) for i, q in enumerate(PCU.fusion_queries())}

    return setup


def _frozen_clock() -> float:
    return 0.0


def _fleet(seed, n_rows, policy, **kw):
    # each worker's scheduler on a clock that does not advance: on
    # time.monotonic a submit that lands after the coalesce window drains
    # the open batch early, so under host load a wave could run before a
    # broadcast that the test makes between its submits and its drain
    return FleetEngine(fleet_setup(seed, n_rows, policy), device="cpu",
                       scheduler_factory=lambda: CoalescingScheduler(clock=_frozen_clock),
                       **kw)


def check_fleet_oracle_port(seed: int, n_rows: int, *, workers: int = 2, store=None,
                            policy=None, calls_spec=None, ddl: bool = False,
                            fault_specs=(), waves: int = 1, parallel: bool = False) -> dict:
    """``conformance_util.check_fleet_oracle`` on the port: the fleet drain
    of the mixed queue == the reference's single-session serial FROID
    drain, element-wise, whatever the store served.  Returns the fleet's
    ``stats``."""
    policy = policy if policy is not None else PC.FROID
    spec = calls_spec if calls_spec is not None else CU.fusion_calls_spec()

    oracle = CU.make_session(seed, n_rows)
    oracle.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
    o_stmts = [oracle.prepare(q, RC.FROID) for q in CU.fusion_queries()]

    fleet = _fleet(seed, n_rows, policy, workers=workers, store=store, parallel=parallel)
    if fault_specs:
        for w in fleet.workers:
            FaultInjector(list(fault_specs)).install(w.session)

    for wave in range(waves):
        for i, p in spec:
            fleet.submit(f"q{i}", p)
        if ddl and wave == 0:
            data = CU.facts_data(seed + 1, max(n_rows, 1))
            fleet.broadcast(lambda s: s.create_table("facts", **data))
            oracle.create_table("facts", **data)
        got = fleet.drain()
        expected = [o_stmts[i].execute(params=p) for i, p in spec]
        assert len(got) == len(expected)
        for j, (e, g) in enumerate(zip(expected, got)):
            assert_masked(e.masked, g.masked, f"fleet[wave {wave}][{j}] vs reference serial")
    stats = fleet.stats
    assert stats["fleet"]["drained"] >= len(spec) * waves, stats["fleet"]
    return stats


# ---------------------------------------------------------------------------
# the fleet oracle across its axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_fleet_oracle_matrix(tmp_path, workers):
    check_fleet_oracle_port(3, N_ROWS, workers=workers, store=str(tmp_path), waves=2)


def test_fleet_oracle_no_store():
    stats = check_fleet_oracle_port(3, N_ROWS, workers=2, store=None)
    assert stats["fleet"]["persist_hits"] == 0
    assert "store" not in stats


def test_fleet_oracle_empty_table(tmp_path):
    check_fleet_oracle_port(4, 0, workers=2, store=str(tmp_path))


def test_fleet_warm_start_from_store(tmp_path):
    """A fresh fleet over a populated store answers its whole first drain
    from the store."""
    check_fleet_oracle_port(3, N_ROWS, workers=2, store=str(tmp_path))
    stats = check_fleet_oracle_port(3, N_ROWS, workers=2, store=str(tmp_path))
    assert stats["fleet"]["persist_hits"] >= 1
    assert stats["fleet"]["persist_misses"] == 0


def test_fleet_intra_cold_sharing(tmp_path):
    """Within one cold fleet, later workers warm-start from entries the
    first worker saved."""
    stats = check_fleet_oracle_port(5, N_ROWS, workers=2, store=str(tmp_path))
    per_worker = {pw["wid"]: pw["cache"] for pw in stats["workers"]}
    assert per_worker[0]["persist_misses"] >= 1
    assert per_worker[1]["persist_hits"] >= 1


def test_fleet_ddl_broadcast(tmp_path):
    check_fleet_oracle_port(3, N_ROWS, workers=2, store=str(tmp_path), ddl=True)


def test_fleet_parallel_drain(tmp_path):
    check_fleet_oracle_port(3, N_ROWS, workers=3, store=str(tmp_path), parallel=True,
                            waves=2)


def test_fleet_corrupt_store_silent_recompile(tmp_path):
    """Every entry cut short: the fleet rebuilds behind a typed warning and
    still equals the oracle."""
    check_fleet_oracle_port(6, N_ROWS, workers=2, store=str(tmp_path))
    for p in glob.glob(os.path.join(str(tmp_path), "*.plan")):
        with open(p, "r+b") as f:
            f.truncate(32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PlanCacheWarning)
        stats = check_fleet_oracle_port(6, N_ROWS, workers=2, store=str(tmp_path))
    assert stats["fleet"]["persist_rejects"] >= 1


def test_fleet_version_stamp_mismatch_silent_recompile(tmp_path):
    """Entries written under another torch (a stale stamp): silently
    rejected, rebuilt, oracle-equal."""
    check_fleet_oracle_port(6, N_ROWS, workers=2, store=str(tmp_path))
    stale = PlanStore(str(tmp_path), stamp={**runtime_stamp("cpu"), "torch": "0.0.0"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # version skew must NOT warn
        stats = check_fleet_oracle_port(6, N_ROWS, workers=2, store=stale)
    assert stats["fleet"]["persist_rejects"] >= 1
    first = min(stats["workers"], key=lambda pw: pw["wid"])["cache"]
    assert first["persist_hits"] == 0 and first["persist_rejects"] >= 1


def test_fleet_injected_faults(tmp_path):
    specs = [FaultSpec(site="dispatch", times=2), FaultSpec(site="compile", times=1)]
    check_fleet_oracle_port(7, N_ROWS, workers=2, store=str(tmp_path), fault_specs=specs,
                            waves=2)


# ---------------------------------------------------------------------------
# engine mechanics: intake, latency, stats, cost persistence
# ---------------------------------------------------------------------------


def test_fleet_round_robin_and_pinning(tmp_path):
    fleet = _fleet(3, N_ROWS, PC.FROID, workers=2, store=str(tmp_path))
    for _ in range(4):
        fleet.submit("q2")
    fleet.submit("q2", worker=1)
    fleet.drain()
    assert [w.scheduler.stats["submitted"] for w in fleet.workers] == [2, 3]


def test_fleet_rejects_bad_setup(tmp_path):
    with pytest.raises(TypeError):
        FleetEngine(lambda s: None, workers=1, store=str(tmp_path), device="cpu")
    with pytest.raises(ValueError):
        _fleet(3, N_ROWS, PC.FROID, workers=0)
    fleet = _fleet(3, N_ROWS, PC.FROID, workers=1, store=str(tmp_path))
    with pytest.raises(KeyError):
        fleet.submit("nope")


def test_ticket_latency_stamped():
    now = [0.0]
    sched = CoalescingScheduler(max_batch=256, window_s=10.0, clock=lambda: now[0])
    s = PC.Session(device="cpu")
    PCU.populate_session(s, 3, N_ROWS)
    s.create_function(_program_udf(PC, PROGRAMS["uncorrelated_sum_case"](PC)))
    stmt = s.prepare(PCU.param_query(), PC.FROID)
    t = sched.submit(stmt, {"cut": 5, "shift": 0.5})
    assert t.submitted_at == 0.0 and t.latency_s is None
    now[0] = 1.5
    sched.flush()
    t.result()
    assert t.latency_s == pytest.approx(1.5)


def test_fleet_latency_collection(tmp_path):
    fleet = _fleet(3, N_ROWS, PC.FROID, workers=2, store=str(tmp_path))
    spec = CU.fusion_calls_spec()
    for i, p in spec:
        fleet.submit(f"q{i}", p)
    fleet.drain()
    assert len(fleet.latencies_s) == len(spec)
    assert all(lat >= 0.0 for lat in fleet.latencies_s)


def test_fleet_stats_shape(tmp_path):
    fleet = _fleet(3, N_ROWS, PC.FROID, workers=2, store=str(tmp_path))
    fleet.submit("q2")
    fleet.drain()
    stats = fleet.stats
    assert len(stats["workers"]) == 2
    for pw in stats["workers"]:
        assert {"cache", "persist", "scheduler"} <= pw.keys()
        assert pw["persist"]["enabled"]
    assert stats["store"]["entries"] >= 1
    assert stats["fleet"]["drained"] == 1
    # one store instance, stamped for the fleet's device, shared by every worker
    assert all(w.session.store is fleet.store for w in fleet.workers)
    assert fleet.store.stats()["root"] == str(tmp_path)


def test_fleet_cost_persistence_warm_routing(tmp_path):
    """A routed fleet saves its measured costs; a fresh fleet's workers
    route warm from the shared store and still match the oracle."""
    fleet = _fleet(3, N_ROWS, PC.ROUTED, workers=2, store=str(tmp_path))
    for _ in range(3):
        for i, p in CU.fusion_calls_spec():
            fleet.submit(f"q{i}", p)
        fleet.drain()
    assert fleet.save_costs() >= 1

    check_fleet_oracle_port(3, N_ROWS, workers=2, store=str(tmp_path), policy=PC.ROUTED)
    fresh = _fleet(3, N_ROWS, PC.ROUTED, workers=2, store=str(tmp_path))
    fresh.broadcast(lambda s: s._ensure_router())
    assert all(w.session.persist_stats["costs_loaded"] > 0 for w in fresh.workers)


def test_fleet_broadcast_returns_worker_order(tmp_path):
    fleet = _fleet(3, N_ROWS, PC.FROID, workers=3, store=str(tmp_path))
    wids = fleet.broadcast(lambda s: s)
    assert [id(s) for s in wids] == [id(w.session) for w in fleet.workers]


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------


def test_fleet_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """``FleetEngine()`` with no device means the card: without CUDA it
    raises before any worker is made, as every entry point of the port
    does; ``device="cpu"`` runs every worker there."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    made = []

    def setup(session):
        made.append(session)
        return {"q": None}

    with pytest.raises(RuntimeError, match="CUDA"):
        FleetEngine(setup, workers=2, store=str(tmp_path))
    assert not made
    fleet = _fleet(3, N_ROWS, PC.FROID, workers=2, store=str(tmp_path))
    assert {str(w.session.device) for w in fleet.workers} == {"cpu"}
    assert fleet.store._stamp == runtime_stamp("cpu")


# ---------------------------------------------------------------------------
# chip_smoke.py's fleet phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_fleet", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fleet_population_is_the_benchmarks(smoke):
    """``chip_smoke.py``'s copy of ``benchmarks/bench_fleet.py``'s population
    and trace: the same statements (equal explain on the same ``T``) and
    the same trace."""
    import benchmarks.bench_fleet as bench

    assert smoke.FLEET_STATEMENTS == bench.N_STMTS and smoke.FLEET_TRACE_K == bench.TRACE_K
    assert smoke.fleet_trace(bench.TRACE_K) == bench._trace(bench.TRACE_K)
    ref = RC.Session()
    bench._populate(ref, 500)
    port = PC.Session(device="cpu")
    stmts = smoke.fleet_setup(500)(port)
    for i in range(bench.N_STMTS):
        assert stmts[f"s{i}"].explain() == ref.explain(bench._query(i)), i


def test_chip_smoke_fleet_phase_rehearsal(smoke):
    """(a)-(e) at SF 0.001 and 3,000 rows on the CPU: B's six first calls
    are store hits with A's rows bit for bit, the damaged entry warns and
    rebuilds, the population's warm first calls hit, every fleet drain ==
    the serial oracle, the warm-started routed fleet loads costs on both
    workers and explores nothing, admission hits the store (the phase
    checks each of these itself)."""
    out = smoke.fleet_run("cpu", 0.001, 3000, 96, 3000, 4, timed=False)
    t = out["tpch"]
    assert t["entries"] == len(smoke.QUERY_NAMES) and t["store_bytes"] > 0
    assert t["B_relagg_launches"] == {n: 0 for n in smoke.QUERY_NAMES}  # plain version here
    assert "damaged" in t["damaged"]["warning"]
    pop = out["population"]
    assert set(pop["arms"]) == {"single", "1w", "2w"}
    assert all(len(a["ms"]) == smoke.FLEET_TIMED_DRAINS for a in pop["arms"].values())
    r = out["routing"]
    assert all(n > 0 for n in r["costs_loaded"])
    assert len(r["fresh_fleet"]) == smoke.FLEET_ROUTED_SHOWN
    assert r["first_fleet"][0]["fuse"] == [["explore-fused"], ["explore-fused"]]
    assert all(w == ["measured"] for d in r["fresh_fleet"] for w in d["fuse"])
    assert out["admission"]["warm"]["persist_hits"] >= 1
