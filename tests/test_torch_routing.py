"""The port's cost router (``repro_torch.cost.router``, the ``ROUTED``
preset, ``Session.cost_stats``) against the reference's, on the CPU.

Ports every case of ``tests/test_cost_routing.py``: the
``ROUTED`` preset and ``routed()``, the lazy attach, the static estimates,
sample intake (EMAs, ``suppress``, fault-window exclusion end to end),
the three axes (policy, batch bucket, fuse-or-not), the routing oracle
(``conformance_util.check_routing_oracle``'s logic over the port's
``Session`` and scheduler, with ``conformance_util``'s builders rebound to
the port's frontend, ``test_torch_fused._cu``), the stats audit and the
printable snapshot.  Then:

* parity with the reference's router: the same scripted
  ``observe_many`` / ``observe_serial`` / ``observe_fused`` sequence and
  ``choose_*`` calls fed to a reference and a port router give the same
  choices, counters, decision logs and ``export_state`` rows.  The
  reference's cost model is pinned to the H100's peaks (``monkeypatch``;
  nothing in ``src/repro/`` changes) so that both estimates are equal;
* ``export_state`` → ``import_state`` on the port;
* a 15-example port of ``tests/test_property_froid.py::
  test_routing_oracle_random_queues``, sharded or not;
* the session side: a routed and an unrouted prepare do not alias, an
  unrouted session never makes a router, every surface (``execute``,
  ``execute_many``, ``execute_async``, scheduler drains fused and not)
  equals the reference's FROID serial answer.

The sharded cases (``test_routing_oracle_matrix``'s two ``sharded``
cases, ``test_routed_sharded_many_matches_serial`` and the ``shard=True``
legs of ``test_routing_oracle_random_queues``) run over four CPU mesh
positions (``make_small_mesh(data=4, devices=["cpu"] * 4)``); a sharded
configuration's router keys carry the policy's shard token in the
reference's position.  The stats audit reads the store counters
(``persist_*``) too.

Every port run is under ``no_vmap_fallback``.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import conformance_util as CU
import repro.core as RC
import repro_torch.core as PC
from repro.cost import model as ref_model
from repro.resilience import FaultInjector as RefFaultInjector
from repro.resilience import FaultSpec as RefFaultSpec
from repro.serve.scheduler import CoalescingScheduler as RefScheduler
from repro_torch.cost import (
    CostRouter,
    estimate_compile_s,
    estimate_plan,
    estimate_statement_s,
)
from repro_torch.cost import model as port_model
from repro_torch.cost.router import DECISION_LOG, _Ema
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.persist import PlanStore
from repro_torch.resilience import FaultInjector, FaultSpec
from repro_torch.serve.scheduler import CoalescingScheduler

from test_property_froid import ORACLE_SETTINGS, _overlap_specs, _ticket_values
from test_torch_correlated import no_vmap_fallback
from test_torch_fused import PCU, _udf_session


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


def _routed_session(seed: int = 3, n_rows: int = CU.N_ROWS):
    """``test_cost_routing._routed_session`` on the port."""
    return _udf_session(seed, n_rows, PCU)


def _ref_session(seed: int = 3, n_rows: int = CU.N_ROWS):
    db = CU.make_session(seed, n_rows)
    db.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
    return db


def _sched(fuse: bool, M=PC, **kw):
    cls = CoalescingScheduler if M is PC else RefScheduler
    return cls(max_batch=256, window_s=10.0, clock=lambda: 0.0, fuse=fuse, **kw)


# ---------------------------------------------------------------------------
# policy surface: the ROUTED preset and the routed() tuning knob
# ---------------------------------------------------------------------------


def test_routed_preset_and_helper():
    assert PC.ROUTED.route and PC.ROUTED.name == "routed"
    assert PC.ROUTED.fingerprint() == PC.FROID.fingerprint()
    assert PC.FROID.routed().route
    assert not PC.ROUTED.routed(False).route
    assert PC.ROUTED.routed() is PC.ROUTED
    assert PC.FROID.routed(False) is PC.FROID
    assert PC.ROUTED.fingerprint() == RC.ROUTED.fingerprint()


def test_router_attaches_lazily():
    db = PC.Session(device="cpu")
    db.create_table("t", x=np.arange(8))
    assert db.cost_stats == {"enabled": False}
    q = PC.scan("t").compute(y=PC.col("x") * 2.0).project("y")
    db.prepare(q, PC.FROID)
    assert db.cost_router is None
    db.prepare(q, PC.ROUTED)
    assert isinstance(db.cost_router, CostRouter)
    assert db.cost_stats["enabled"]


def test_unrouted_sessions_never_make_a_router():
    """FROID, HEKATON and INTERPRETED sessions, every surface run, pay for
    no router: ``cost_router`` stays None and ``cost_stats`` disabled."""
    db = _routed_session()
    for policy in (PC.FROID, PC.HEKATON, PC.INTERPRETED):
        stmt = db.prepare(PCU.param_query(), policy)
        p = {"cut": 5, "shift": 0.5}
        stmt.execute(params=p)
        stmt.execute_many([p, {"cut": 3, "shift": 1.0}])
        stmt.execute_async(params=p).result()
    sched = _sched(True)
    stmts = [db.prepare(q, PC.FROID) for q in PCU.fusion_queries()]
    for i, p in PCU.fusion_calls_spec():
        sched.submit(stmts[i], p)
    sched.flush()
    assert db.cost_router is None and db.cost_stats == {"enabled": False}
    assert sched.stats["routed_waves"] == 0


def test_routed_and_unrouted_prepares_do_not_alias():
    """``route`` is not part of the policy's identity, so the handle cache
    keys on it: a routed and an unrouted prepare of one query are two
    handles (sharing plans and executables), each keeping its own policy."""
    db = _routed_session()
    a = db.prepare(PCU.param_query(), PC.FROID)
    b = db.prepare(PCU.param_query(), PC.ROUTED)
    assert a is not b and not a.policy.route and b.policy.route
    assert db.prepare(PCU.param_query(), PC.ROUTED) is b
    assert db.prepare(PCU.param_query(), PC.FROID) is a
    assert db.cache_stats["plan_misses"] == 1


# ---------------------------------------------------------------------------
# static cost model sanity
# ---------------------------------------------------------------------------


def test_estimates_scale_with_work():
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.FROID)
    plan = stmt.plan
    prof = estimate_plan(plan, db.catalog)
    assert prof.rows > 0 and prof.flops > 0 and prof.nodes > 0
    assert prof.seconds() > 0
    e1 = estimate_statement_s(plan, db.catalog, bucket=1)
    e64 = estimate_statement_s(plan, db.catalog, bucket=64)
    assert e64 > e1
    assert estimate_statement_s(plan, db.catalog, bucket=64, devices=8) < e64
    small = db.prepare(PC.scan("keys").compute(z=PC.col("k") * 2.0), PC.FROID).plan
    assert estimate_compile_s(plan) > estimate_compile_s(small) > 0


# ---------------------------------------------------------------------------
# sample intake: EMA updates and fault-window exclusion
# ---------------------------------------------------------------------------


def test_observe_updates_ema_and_counters():
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    r = db.cost_router
    r.observe_serial(stmt._query_fp, stmt.policy, 1.0)
    r.observe_serial(stmt._query_fp, stmt.policy, 0.0)
    key = ("serial", stmt._query_fp, stmt.policy.fingerprint())
    ema = r.measured[key]
    assert ema.n == 2 and 0.0 < ema.wave_s < 1.0
    assert r.stats["samples"] == 2 and r.stats["samples_excluded"] == 0


def test_suppress_drops_samples_and_is_reentrant():
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    r = db.cost_router
    with r.suppress():
        with r.suppress():
            r.observe_serial(stmt._query_fp, stmt.policy, 9.9)
        assert r.suppressed
        r.observe_many(stmt._query_fp, stmt.policy, (), 4, 9.9, 4, shard=False)
    assert not r.suppressed
    assert r.stats["samples_excluded"] == 2 and r.stats["samples"] == 0
    assert not r.measured and not r.per_ticket


def _cpu_mesh():
    return make_small_mesh(data=4, devices=["cpu"] * 4)


def test_sharded_routing_raises_naming_a10():
    """Named for what it checked before the mesh was ported (a raise
    naming A10); now the ported behaviour: a sharded sample is keyed
    ``("many", query_fp, policy fp, sig, shard_token, bucket)``, the
    reference's key, apart from an unsharded one, and a bucket ride only
    rides a bucket measured under the same placement."""
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED.sharded(_cpu_mesh()))
    r = db.cost_router
    token = stmt.policy.shard_token()
    assert token and token[1] == (("cpu", None),) * 4
    r.observe_many(stmt._query_fp, stmt.policy, (), 8, 1e-9, 8, shard=True)
    r.observe_many(stmt._query_fp, stmt.policy, (), 16, 1e-9, 16, shard=False)
    keys = {k for k in r.measured if k[0] == "many"}
    pol_fp = stmt.policy.fingerprint()
    assert keys == {("many", stmt._query_fp, pol_fp, (), token, 8),
                    ("many", stmt._query_fp, pol_fp, (), (), 16)}
    assert r.stats["samples"] == 2
    # the measured sharded bucket 8 is ridable only under the placement
    assert r.choose_bucket(stmt, (), 3, 4, 256, shard=True) == 8
    assert r.choose_bucket(stmt, (), 3, 4, 256, shard=False) == 16
    assert any(d.startswith("many:") and d.endswith(":sharded")
               for d in db.cost_stats["measured"])


@pytest.mark.parametrize("site,times", [("dispatch", 3), ("sync", 2), ("compile", 1)])
def test_fault_window_samples_excluded_end_to_end(site, times):
    """Faults push the ladder into retries and demotions; the routed session
    drops those samples, as the reference's does: the same excluded and
    kept sample counts and the same decisions, and every ticket the
    reference's fault-free FROID serial answer."""
    out = []
    for M, db in ((RC, _ref_session()), (PC, _routed_session())):
        qs = CU.fusion_queries() if M is RC else PCU.fusion_queries()
        stmts = [db.prepare(q, M.ROUTED) for q in qs]
        fi, fs = (FaultInjector, FaultSpec) if M is PC else (RefFaultInjector, RefFaultSpec)
        fi([fs(site=site, times=times)]).install(db)
        sched = _sched(True, M, sleep=lambda s: None)
        tickets = [sched.submit(stmts[i], p) for i, p in CU.fusion_calls_spec()]
        sched.flush()
        out.append((db.cost_stats, [t.result() for t in tickets], sched.stats))
    (rcs, rres, rst), (pcs, pres, pst) = out
    assert pcs["samples_excluded"] >= 1, pcs
    for k in ("samples", "samples_excluded", "decisions", "waves_fused", "waves_unfused",
              "policy_reroutes", "bucket_rides"):
        assert pcs[k] == rcs[k], (k, pcs, rcs)
    assert ([(d["axis"], d["choice"], d["why"]) for d in pcs["decision_log"]]
            == [(d["axis"], d["choice"], d["why"]) for d in rcs["decision_log"]])
    assert pst == rst
    oracle = _ref_session()
    o_stmts = [oracle.prepare(q, RC.FROID) for q in CU.fusion_queries()]
    for (i, p), r in zip(CU.fusion_calls_spec(), pres):
        CU.assert_rows_equal(o_stmts[i].execute(params=p), r, "faulted routed ticket vs oracle")


# ---------------------------------------------------------------------------
# axis: FROID vs HEKATON policy
# ---------------------------------------------------------------------------


def test_choose_policy_prefers_measured_winner():
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    r = db.cost_router
    cands = r._policy_candidates(stmt)
    assert len(cands) >= 2
    alt = next(c for c, cfp in cands if cfp != stmt.policy.fingerprint())
    fp = stmt._query_fp
    r.per_ticket[("many", fp, stmt.policy.fingerprint())] = _Ema(1e-2)
    r.per_ticket[("many", fp, alt.fingerprint())] = _Ema(1e-3)
    chosen = r.choose_policy(stmt)
    assert chosen.fingerprint() == alt.fingerprint()
    assert r.stats["policy_reroutes"] == 1
    assert any(d["axis"] == "policy" and d["why"] == "measured" for d in r.decisions)
    r.per_ticket[("many", fp, alt.fingerprint())] = _Ema(1e-1)
    assert r.choose_policy(stmt).fingerprint() == stmt.policy.fingerprint()


def test_choose_policy_estimate_gated_exploration():
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    r = db.cost_router
    for c, cfp in r._policy_candidates(stmt):
        r.estimates[("policy", stmt._query_fp, cfp, db._catalog_token())] = 1.0
    assert r.choose_policy(stmt).fingerprint() == stmt.policy.fingerprint()
    assert r.stats["policy_reroutes"] == 0


def test_routed_execute_delegates_and_matches():
    """A policy reroute executes under the delegate (HEKATON here, on the
    session's device), and the answer is still the reference's FROID
    serial one."""
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    params = {"cut": 5, "shift": 0.5}
    expected = _ref_session().execute(CU.param_query(), RC.FROID, params=params)
    r = db.cost_router
    alt = next(c for c, cfp in r._policy_candidates(stmt)
               if cfp != stmt.policy.fingerprint())
    fp = stmt._query_fp
    r.per_ticket[("many", fp, stmt.policy.fingerprint())] = _Ema(1.0)
    r.per_ticket[("many", fp, alt.fingerprint())] = _Ema(1e-6)
    got = stmt.execute(params=params)
    CU.assert_rows_equal(expected, got, "rerouted execute vs oracle")
    assert got.policy.fingerprint() == alt.fingerprint() and not got.policy.route
    assert db.cost_stats["policy_reroutes"] >= 1
    batched = stmt.execute_many([params, {"cut": 3, "shift": 1.5}])
    CU.assert_rows_equal(expected, batched[0], "rerouted execute_many vs oracle")
    CU.assert_rows_equal(expected, stmt.execute_async(params=params).result(),
                         "rerouted execute_async vs oracle")


# ---------------------------------------------------------------------------
# axis: batch bucket (ride a warm larger bucket over a cold one)
# ---------------------------------------------------------------------------


def test_choose_bucket_rides_warm_bucket():
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    r = db.cost_router
    params8 = [{"cut": int(k % 6), "shift": 0.5} for k in range(8)]
    stmt.execute_many(params8)
    key8 = next(k for k in r.measured if k[0] == "many" and k[-1] == 8)
    sig = key8[3]
    assert key8[4] == ()  # the unsharded token, the reference's key shape
    r.measured[key8].wave_s = 1e-9
    assert r.choose_bucket(stmt, sig, 3, 4, 256, shard=False) == 8
    assert r.stats["bucket_rides"] == 1
    assert r.choose_bucket(stmt, sig, 7, 8, 256, shard=False) == 8
    r.measured[key8].wave_s = 1e9
    assert r.choose_bucket(stmt, sig, 3, 4, 256, shard=False) == 4


def test_bucket_ride_preserves_results_end_to_end():
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    stmt.execute_many([{"cut": int(k % 6), "shift": 0.5} for k in range(8)])
    r = db.cost_router
    for k in list(r.measured):
        if k[0] == "many":
            r.measured[k].wave_s = 1e-9
    small = [{"cut": 2, "shift": 0.5}, {"cut": 5, "shift": 0.5}, {"cut": 1, "shift": 0.5}]
    misses = db.cache_stats["batch_misses"]
    got = stmt.execute_many(small)
    o = _ref_session().prepare(CU.param_query(), RC.FROID)
    for i, (p, g) in enumerate(zip(small, got)):
        CU.assert_rows_equal(o.execute(params=p), g, f"bucket-ride[{i}]")
    assert db.cost_stats["bucket_rides"] >= 1
    # the ridden wave reports the bucket it ran in, and ran the warm
    # bucket's executable (no new one was built)
    assert got[0].stats["batch_bucket"] == 8 and got[0].stats["batch_size"] == 3
    assert db.cache_stats["batch_misses"] == misses


# ---------------------------------------------------------------------------
# the routing oracle on the port
# ---------------------------------------------------------------------------


def check_routing_oracle_port(seed: int, n_rows: int, *, fuse: bool = True,
                              shard: bool = False, waves: int = 3,
                              calls_spec=None, queries=None) -> dict:
    """``conformance_util.check_routing_oracle`` on the port: the reference's
    FROID serial answer to every call of the queue (``queries`` a
    (reference, port) pair of statement lists) against the port's routed
    session draining the queue ``waves`` times through a scheduler
    (``fuse`` drain mode; sharded over four CPU mesh positions per
    ``shard``), then a final serial ``execute`` pass."""
    rqs, pqs = queries if queries is not None else (CU.fusion_queries(), PCU.fusion_queries())
    spec = calls_spec if calls_spec is not None else CU.fusion_calls_spec()
    oracle = _ref_session(seed, n_rows)
    o_stmts = [oracle.prepare(q, RC.FROID) for q in rqs]
    expected = [o_stmts[i].execute(params=p) for i, p in spec]
    db = _routed_session(seed, n_rows)
    policy = PC.ROUTED.sharded(_cpu_mesh()) if shard else PC.ROUTED
    stmts = [db.prepare(q, policy) for q in pqs]
    sched = _sched(fuse)
    for w in range(waves):
        tickets = [sched.submit(stmts[i], p) for i, p in spec]
        sched.flush()
        for j, t in enumerate(tickets):
            CU.assert_rows_equal(expected[j], t.result(),
                                 f"routed[wave {w}][{j}] vs FROID serial oracle")
    for j, (i, p) in enumerate(spec):
        CU.assert_rows_equal(expected[j], stmts[i].execute(params=p),
                             f"routed serial[{j}] vs FROID serial oracle")
    cs = db.cost_stats
    assert cs.get("enabled"), f"router never attached: {cs}"
    assert cs["samples"] >= 1, f"router saw no samples: {cs}"
    return cs


def test_fuse_axis_explores_both_arms_then_measures():
    cs = check_routing_oracle_port(7, CU.N_ROWS, fuse=True, waves=3)
    assert cs["waves_fused"] >= 1 and cs["waves_unfused"] >= 1, cs
    fuse_whys = [d["why"] for d in cs["decision_log"] if d["axis"] == "fuse"]
    assert fuse_whys[0] == "explore-fused"
    assert "explore-unfused" in fuse_whys
    assert fuse_whys[-1] == "measured"


def test_route_fuse_requires_all_routed():
    db = _routed_session()
    qs = PCU.fusion_queries()
    stmts = [db.prepare(qs[0], PC.ROUTED), db.prepare(qs[1], PC.FROID)]
    sched = _sched(True)
    t1 = sched.submit(stmts[0], {"cut": 5, "shift": 0.5})
    t2 = sched.submit(stmts[1], {"minq": 4, "scale": 2.0})
    sched.flush()
    t1.result(), t2.result()
    assert sched.stats["routed_waves"] == 0
    assert sched.stats["fused_batches"] >= 1


@pytest.mark.parametrize("shard", [False, True], ids=["unsharded", "sharded"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_routing_oracle_matrix(fuse, shard):
    check_routing_oracle_port(11, CU.N_ROWS, fuse=fuse, shard=shard, waves=2)


def test_routed_sharded_many_matches_serial():
    """The routed ``execute_many`` path on a sharded mesh still equals the
    serial oracle (bucket riding and sharding compose), and its samples
    are keyed by the placement."""
    db = _routed_session()
    stmt = db.prepare(PCU.param_query(), PC.ROUTED.sharded(_cpu_mesh()))
    params = [{"cut": int(k % 6), "shift": 0.5} for k in range(8)]
    got = stmt.execute_many(params)
    oracle = _ref_session()
    o = oracle.prepare(CU.param_query(), RC.FROID)
    for i, (p, g) in enumerate(zip(params, got)):
        CU.assert_rows_equal(o.execute(params=p), g, f"routed sharded[{i}]")
        assert g.stats["sharded"] and g.stats["shard_devices"] == 4
    assert db.cost_stats["samples"] >= 1
    token = stmt.policy.shard_token()
    assert any(k[0] == "many" and k[4] == token for k in db.cost_router.measured)


def test_routing_oracle_empty_table():
    check_routing_oracle_port(12, 0, fuse=True, waves=2)


@settings(max_examples=15, **ORACLE_SETTINGS)
@given(specs=_overlap_specs, values=_ticket_values, seed=st.integers(0, 3),
       n_rows=st.sampled_from([0, CU.N_ROWS]), fuse=st.booleans(),
       shard=st.booleans(), waves=st.integers(1, 3))
def test_routing_oracle_random_queues(specs, values, seed, n_rows, fuse, shard, waves):
    """``test_property_froid.test_routing_oracle_random_queues`` on the
    port: any overlap queue, any wave count, fused or unfused drains,
    sharded or not — routing changes costs, never results."""
    rqs, calls = CU.overlap_queue(specs, values)
    pqs, pcalls = PCU.overlap_queue(specs, values)
    assert pcalls == calls
    with no_vmap_fallback():
        check_routing_oracle_port(seed, n_rows, fuse=fuse, shard=shard, waves=waves,
                                  calls_spec=calls, queries=(rqs, pqs))


# ---------------------------------------------------------------------------
# stats audit: monotone counters, wave normalization, snapshot shape
# ---------------------------------------------------------------------------


def test_stats_audit_monotone_and_consistent(tmp_path):
    db = _routed_session()
    db.store = PlanStore(str(tmp_path), device="cpu")  # the persist_* counters move
    stmts = [db.prepare(q, PC.ROUTED) for q in PCU.fusion_queries()]
    spec = PCU.fusion_calls_spec()
    sched = _sched(True)
    mono_keys = ("samples", "samples_excluded", "decisions", "policy_reroutes",
                 "bucket_rides", "waves_fused", "waves_unfused")
    cache_keys = ("fuse_hits", "fuse_misses", "cse_hits", "cse_shared_nodes",
                  "persist_hits", "persist_misses", "persist_rejects")
    prev_cost = {k: 0 for k in mono_keys}
    prev_cache = {k: 0 for k in cache_keys}
    prev_sched = {"demote_fused_to_many": 0, "demote_many_to_serial": 0,
                  "demote_serial_to_interp": 0, "deadline_shed": 0}
    for wave in range(3):
        tickets = [sched.submit(stmts[i], p) for i, p in spec]
        sched.flush()
        results = [t.result() for t in tickets]
        cs = db.cost_stats
        for k in mono_keys:
            assert cs[k] >= prev_cost[k], (wave, k, cs)
            prev_cost[k] = cs[k]
        for k in cache_keys:
            assert db.cache_stats[k] >= prev_cache[k], (wave, k)
            prev_cache[k] = db.cache_stats[k]
        for k in prev_sched:
            assert sched.stats[k] >= prev_sched[k], (wave, k)
            prev_sched[k] = sched.stats[k]
        for r in results:
            st_ = r.stats
            assert st_.get("dispatch_s", 0.0) >= 0.0
            assert st_.get("sync_s", 0.0) >= 0.0
            if st_.get("fused"):
                assert st_["wave_tickets"] == len(results)
                assert st_["cse_pool_slots"] >= st_["cse_bindings"] >= 0
            elif "wave_tickets" in st_:
                assert 1 <= st_["wave_tickets"] <= len(spec)
    n_emas = sum(e.n for e in db.cost_router.measured.values())
    assert n_emas == cs["samples"]
    assert db.cache_stats["persist_misses"] >= 1
    assert db.persist_stats["saves"] >= 1 and db.persist_stats["save_errors"] == 0


def test_cost_stats_snapshot_printable():
    cs = check_routing_oracle_port(13, CU.N_ROWS, fuse=True, waves=2)
    for label, rec in cs["measured"].items():
        assert isinstance(label, str) and ":" in label and ":sharded" not in label
        assert rec["n"] >= 1 and rec["wave_s"] >= 0.0
    for d in cs["decision_log"]:
        assert {"axis", "choice", "why"} <= d.keys()
    assert len(cs["decision_log"]) <= DECISION_LOG


# ---------------------------------------------------------------------------
# every surface under ROUTED == the reference's FROID serial answer
# ---------------------------------------------------------------------------


def test_routed_surfaces_match_the_reference():
    db = _routed_session()
    oracle = _ref_session()
    plist = [{"cut": 5, "shift": 0.5}, {"cut": 3, "shift": 1.5}, {"cut": 6, "shift": 2.0},
             {"cut": 1, "shift": 0.0}, {"cut": 4, "shift": 0.25}]
    want = [oracle.execute(CU.param_query(), RC.FROID, params=p) for p in plist]
    stmt = db.prepare(PCU.param_query(), PC.ROUTED)
    for label, got in (
            ("execute", [stmt.execute(params=p) for p in plist]),
            ("execute_many", stmt.execute_many(plist)),
            ("execute_many warm", stmt.execute_many(plist)),
            ("execute_async", [f.result() for f in [stmt.execute_async(params=p)
                                                    for p in plist]]),
            ("session execute", [db.execute(PCU.param_query(), PC.ROUTED, params=p)
                                 for p in plist])):
        for j, (w, g) in enumerate(zip(want, got)):
            CU.assert_rows_equal(w, g, f"ROUTED {label}[{j}]")
    cs = db.cost_stats
    assert cs["enabled"] and cs["samples"] >= 3
    assert any(k.startswith("serial:") for k in cs["measured"])
    assert any(k.startswith("many:") for k in cs["measured"])


# ---------------------------------------------------------------------------
# parity with the reference's router: scripted observations and choices
# ---------------------------------------------------------------------------


@pytest.fixture
def h100_reference_model(monkeypatch):
    """The reference's cost model at the port's (the H100's) peaks, so the
    two packages' estimates are the same numbers."""
    monkeypatch.setattr(ref_model, "PEAK_FLOPS", port_model.PEAK_FLOPS)
    monkeypatch.setattr(ref_model, "HBM_BW", port_model.HBM_BW)


P0 = {"cut": 5, "shift": 0.5}
P1 = {"minq": 4, "scale": 2.0}

#: one scripted life of a router over the fusion oracle's three statements
#: (0-2, ``ROUTED``) and ``param_query`` prepared under HEKATON.routed() (3):
#: every axis, both policy paths, rides and no rides, the fuse hysteresis,
#: a suppressed window
SCRIPT = [
    ("policy", 0), ("policy", 3),
    ("bucket", 0, P0, 3, 4, 256),
    ("many", 0, 0, P0, 8, 2e-3, 8),
    ("bucket", 0, P0, 3, 4, 256), ("bucket", 0, P0, 7, 8, 256), ("bucket", 0, P0, 3, 4, 4),
    ("many", 0, 0, P0, 8, 5e-3, 6), ("many", 0, 0, P0, 8, 1e9, 8),
    ("bucket", 0, P0, 3, 4, 256),
    ("serial", 1, 0, 1e-3),
    ("suppress", [("serial", 1, 0, 9.9), ("many", 1, 0, P1, 4, 9.9, 4),
                  ("fused", (0, 1, 2), 9.9, 7, None), ("suppress", [("serial", 2, 0, 9.9)])]),
    ("fuse", ((0, 3), (1, 2), (2, 2))),
    ("fused", (0, 1, 2), 4e-3, 7, {"cse_bindings": 2, "cse_pool_slots": 2,
                                   "cse_ticket_refs": 3}),
    ("fuse", ((0, 3), (1, 2), (2, 2))),
    ("serial", 2, 0, 1e-4), ("many", 1, 0, P1, 2, 1e-3, 2),
    ("fuse", ((0, 3), (1, 2), (2, 2))),
    ("fused", (0, 1, 2, 2), 1.0, 7, None),
    ("fuse", ((0, 3), (1, 2), (2, 2))),
    ("fused", (0, 1, 2), 1e-9, 7, None), ("fused", (0, 1, 2), 1e-9, 7, None),
    ("fuse", ((2, 1), (1, 5), (0, 1))),
    ("many", 0, 1, P0, 8, 1e-6, 8), ("policy", 0), ("policy", 0),
    ("many", 0, 1, P0, 8, 10.0, 8), ("many", 0, 1, P0, 8, 10.0, 8), ("policy", 0),
    ("serial", 3, 0, 0.5), ("serial", 3, 1, 0.25), ("policy", 3),
    ("bucket", 3, P0, 2, 2, 256),
]


def _play(M, db, stmts, script, out):
    r = db.cost_router
    sig = (lambda p: RC.param_signature(p)) if M is RC else PC.param_signature

    def cand(i, j):
        return r._policy_candidates(stmts[i])[j][0]

    for op in script:
        kind = op[0]
        if kind == "serial":
            _, i, j, s = op
            r.observe_serial(stmts[i]._query_fp, cand(i, j), s)
        elif kind == "many":
            _, i, j, p, bucket, s, n = op
            r.observe_many(stmts[i]._query_fp, cand(i, j), sig(p), bucket, s, n, shard=False)
        elif kind == "fused":
            _, idx, s, n, meta = op
            r.observe_fused([stmts[i]._query_fp for i in idx], s, n, meta=meta)
        elif kind == "suppress":
            with r.suppress():
                _play(M, db, stmts, op[1], out)
        elif kind == "policy":
            pol = r.choose_policy(stmts[op[1]])
            out.append(("policy", pol.name, repr(pol.fingerprint())))
        elif kind == "bucket":
            _, i, p, k, natural, cap = op
            out.append(("bucket", r.choose_bucket(stmts[i], sig(p), k, natural, cap,
                                                  shard=False)))
        elif kind == "fuse":
            out.append(("fuse", r.choose_fuse([(stmts[i], n) for i, n in op[1]])))
    return out


def _scripted(M, db, script):
    qs = CU.fusion_queries() if M is RC else PCU.fusion_queries()
    pq = CU.param_query() if M is RC else PCU.param_query()
    stmts = [db.prepare(q, M.ROUTED) for q in qs] + [db.prepare(pq, M.HEKATON.routed())]
    return _play(M, db, stmts, script, []), db.cost_router, stmts


@pytest.mark.parametrize("udf_row_flops", [None, 1e12], ids=["h100", "heavy-udf"])
def test_router_parity_with_the_reference(h100_reference_model, monkeypatch, udf_row_flops):
    """The same scripted observations and choices through a reference and a
    port router: the same choices, counters, decision log (every field,
    the estimates included), snapshot and ``export_state`` rows.  At the
    H100's peaks the interpreted UDF's per-row penalty is lost in the
    dispatch term, so the estimate-gated verdicts keep the incumbent;
    ``heavy-udf`` raises the penalty in both models alike so that the
    HEKATON-based statement is rerouted to FROID on its estimate."""
    if udf_row_flops is not None:
        monkeypatch.setattr(ref_model, "UDF_CALL_ROW_FLOPS", udf_row_flops)
        monkeypatch.setattr(port_model, "UDF_CALL_ROW_FLOPS", udf_row_flops)
    rout, rr, rstmts = _scripted(RC, _ref_session(), SCRIPT)
    pout, pr, pstmts = _scripted(PC, _routed_session(), SCRIPT)
    for rs, ps in zip(rstmts, pstmts):
        assert repr(ps._query_fp) == repr(rs._query_fp)
        for (rc, _), (pc, _) in zip(rr._policy_candidates(rs), pr._policy_candidates(ps)):
            assert pr.estimate_policy_s(ps, pc) == rr.estimate_policy_s(rs, rc)
    assert pout == rout
    assert pr.stats == rr.stats
    assert list(pr.decisions) == list(rr.decisions)
    assert pr.snapshot() == rr.snapshot()
    assert pr.export_state() == rr.export_state()
    whys = {(d["axis"], d["why"]) for d in pr.decisions}
    assert {("bucket", "ride-warm"), ("fuse", "explore-fused"), ("fuse", "explore-unfused"),
            ("fuse", "measured"), ("policy", "measured")} <= whys
    assert pr.stats["samples_excluded"] == 4
    assert (("policy", "estimate") in whys) == (udf_row_flops is not None)


def test_routed_drain_decisions_match_the_reference():
    """A routed fused drain of the fusion oracle's queue, twice, on both
    packages: the first two fuse decisions are explorations, timing-free,
    so they, the samples taken and the measured keys are the reference's."""
    logs, sts, keys = [], [], []
    for M, db in ((RC, _ref_session()), (PC, _routed_session())):
        qs = CU.fusion_queries() if M is RC else PCU.fusion_queries()
        stmts = [db.prepare(q, M.ROUTED) for q in qs]
        sched = _sched(True, M)
        for _ in range(2):
            for i, p in CU.fusion_calls_spec():
                sched.submit(stmts[i], p)
            sched.flush()
        cs = db.cost_stats
        logs.append([(d["axis"], d["choice"], d["why"], d.get("wave")) for d in cs["decision_log"]])
        sts.append({k: cs[k] for k in ("samples", "samples_excluded", "waves_fused",
                                       "waves_unfused", "decisions")})
        keys.append(sorted(cs["measured"]))
    assert logs[1] == logs[0] and sts[1] == sts[0] and keys[1] == keys[0]
    assert [w for _, _, w, _ in logs[0]] == ["explore-fused", "explore-unfused"]


# ---------------------------------------------------------------------------
# export_state -> import_state on the port
# ---------------------------------------------------------------------------


def test_export_import_round_trip():
    src = _routed_session()
    _scripted(PC, src, SCRIPT)
    state = src.cost_router.export_state()
    assert state["measured"] and state["per_ticket"]
    dst = _routed_session()
    stmts = [dst.prepare(q, PC.ROUTED) for q in PCU.fusion_queries()]
    r = dst.cost_router
    n = r.import_state(state)
    assert n == len(state["measured"]) + len(state["per_ticket"])
    assert r.export_state() == state
    # the warm-bucket index is rebuilt: the imported bucket 8 is a ride
    sig = PC.param_signature(P0)
    prefix = ("many", stmts[0]._query_fp, stmts[0].policy.fingerprint(), sig, ())
    assert set(r._warm_many[prefix]) == {8}
    # live evidence wins unless replace; malformed rows are skipped
    key = next(iter(r.measured))
    r.measured[key] = _Ema(123.0)
    assert r.import_state(state) == 0 and r.measured[key].wave_s == 123.0
    assert r.import_state(state, replace=True) == n and r.measured[key].wave_s != 123.0
    bad = {"measured": [["not a key(", 1.0, 1, 1.0, None], [repr(("x",)), "nan?", 1, 1.0],
                        [repr(("x", object.__name__)), 1.0]],
           "per_ticket": [[repr([1, 2]), 1.0, 1, 1.0, None]]}
    assert r.import_state(bad) == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's routed phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_routed", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_routing_queue_is_the_benchmark_queue(smoke):
    """``chip_smoke.py``'s ``routing_queries`` / ``routing_queue`` make
    ``benchmarks/bench_cost_routing.py``'s statements (the same FROID plans)
    and queue (the same parameters)."""
    import benchmarks.bench_cost_routing as bench
    from test_torch_fused import _norm, _populate

    ref, port = RC.Session(), PC.Session(device="cpu")
    _populate(RC, ref, n_detail=300, n_t=40)
    _populate(PC, port, n_detail=300, n_t=40)
    for rq, pq in zip(bench._queries(), smoke.routing_queries()):
        assert _norm(port.explain(pq)) == _norm(ref.explain(rq))
    rstmts = [ref.prepare(q, RC.FROID) for q in bench._queries()]
    pstmts = [port.prepare(q, PC.FROID) for q in smoke.routing_queries()]
    rq, pq = bench._queue(rstmts, 48), smoke.routing_queue(pstmts, 48)
    assert [(rstmts.index(s), p) for s, p in rq] == [(pstmts.index(s), p) for s, p in pq]
    assert (smoke.ROUTING_PER_STMT, smoke.ROUTING_MANY_K) == (bench.PER_STMT, bench.MANY_K)


def test_chip_smoke_routed_phase_rehearsal(smoke):
    """(a)-(d) at 3,000 ``detail`` rows on the CPU: both queues explore the
    fused arm, then the per-statement one, then follow the EMAs (the phase
    checks each ticket against the serial loop and float64, and each
    measured choice against the EMAs under ``FUSE_MARGIN``); the bucket
    axis runs N = 100 in the natural bucket or rides the warm 1,024, a
    ride logged with its warm wave under the cold estimate (which arm
    depends on this host's times); routing's overhead keeps the results."""
    out = smoke.routed_run("cpu", 3000, (4, 4), 3, timed=False)
    for q in ("routing", "overlap"):
        assert [w["why"] for w in out[q]["waves"]] == ["explore-fused", "explore-unfused",
                                                       "measured"]
    b = out["bucket"]
    assert b["bucket"] in (128, 1024) and b["rode"] == (b["bucket"] == 1024)
    assert (b["decision"] is not None) == b["rode"]
    assert b["plan_nodes"] * 3.0 == pytest.approx(b["estimate_compile_ms"])
    assert out["cost_stats"]["samples_excluded"] == 0 and out["cost_stats"]["samples"] > 0


def test_chip_smoke_routing_oracle_is_the_harness_oracle(smoke):
    """``chip_smoke.py``'s routing oracle over ``conformance_util``'s tables
    and queue: every routed wave (fused and not) == the port's FROID serial
    loop (checked inside) == the reference's."""
    ref = _ref_session(3, CU.N_ROWS)
    want = [ref.prepare(q, RC.FROID) for q in CU.fusion_queries()]
    for fuse in (True, False):
        got, serial, cs = smoke.routing_oracle_run(CU.N_ROWS, fuse, "cpu")
        for j, ((i, p), g) in enumerate(zip(CU.fusion_calls_spec(), got)):
            CU.assert_rows_equal(want[i].execute(params=p), g, f"fuse={fuse}[{j}]")
        assert cs["samples"] >= 1 and (cs["waves_fused"] >= 1) == fuse


def test_chip_smoke_policy_axis_rehearsal(smoke):
    """(e) at SF 0.001: Q6's and Q12's verdicts follow the estimates under
    ``EXPLORE_MARGIN`` (here both keep FROID: at this size the dispatch
    term dominates both candidates), and the routed rows == FROID."""
    from repro_torch.data.tpch import generate_tpch
    from repro_torch.data.tpch_udfs import register_udfs

    s = PC.Session(device="cpu")
    generate_tpch(s, sf=0.001)
    register_udfs(s)
    out = smoke.routed_policy_axis(s)
    for name in ("Q6", "Q12"):
        assert out[name]["verdict"] == "routed+relagg" and out[name]["ran"]
