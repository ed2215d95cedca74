"""The port's batched invocation engine (``execute_many``, ``execute_async``)
and the coalescing scheduler, against the reference and against the port's
own serial loop, on the CPU.

Ports every case of ``tests/test_execute_many.py`` that needs no mesh
or store (fusion has its own file, ``test_torch_fused.py``, routing
``test_torch_routing.py``; the scheduler's ``fuse=True`` drain and a
routed ``execute_many``, beside the reference's router, are checked here
once): element-wise identity with the serial loop and
input order, empty and parameter-free inputs, an eager policy run
serially, HEKATON (its scan-mode row loop under the parameter vmap),
bucket shape and reuse, mixed signatures, ``max_batch`` chunks, pipelining
bounded by ``max_inflight``, async == sync with its backpressure and slot
release, DDL / catalog / UDF changes between submit and drain, the
scheduler's window, full-batch and forced flushes on a fake clock, the
adaptive window, coalesced admission == the tick path and
``ServeEngine.submit``/``drain`` == ``run``.  Then the invocation oracle's
unsharded, sharded (four CPU mesh positions) and HEKATON legs
(``conformance_util.check_invocation_oracle``), and a ``pallas_agg``
plan whose parameter reaches relagg: one batched op a chunk, and a
GroupAgg the parameter does not reach runs once, unbatched.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``).  Masks, counts, keys and validity match exactly,
floats to rtol 1e-4 with an atol of 1e-4 (``test_torch_correlated``'s
``assert_masked``).  Every port run is under ``no_vmap_fallback``: a
functorch per-example fallback is an error.
"""
import numpy as np
import pytest
import torch

import repro.core as RC
import repro_torch.core as PC
from repro.serve.admission import AdmissionPolicy as RefAdmission
from repro_torch.kernels.relagg import ops as relagg_ops
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.serve.admission import AdmissionPolicy
from repro_torch.serve.scheduler import CoalescingScheduler

from conformance_util import FIXED_PROGRAMS
from test_torch_correlated import assert_masked, no_vmap_fallback
from test_torch_interpreter import PROGRAMS, _facts_tables, _keys_query, _program_udf


def _populate(M, db, n_detail=2000, n_t=200, seed=0):
    """``tests/test_execute_many.py::_populate`` with either package."""
    rng = np.random.default_rng(seed)
    db.create_table(
        "detail",
        d_key=rng.integers(0, 50, n_detail),
        d_val=rng.uniform(0, 100, n_detail).astype(np.float32),
    )
    db.create_table("T", a=rng.integers(0, 50, n_t))
    u = M.UdfBuilder("key_total", [("k", "int32")], "float32")
    u.declare("s", "float32")
    u.select({"s": M.sum_(M.col("d_val"))}, frm=M.scan("detail"),
             where=M.col("d_key") == M.param("k"))
    with u.if_(M.var("s").is_null()):
        u.return_(M.lit(0.0))
    u.return_(M.var("s"))
    db.create_function(u.build())


def _q(M=PC):
    return (
        M.scan("T")
        .filter(M.col("a") < M.param("cutoff"))
        .compute(v=M.udf("key_total", M.col("a")))
        .project("v")
    )


def _assert_same(serial, batched):
    """The reference test's check: masks exactly, ``v`` to rtol 1e-5."""
    assert len(serial) == len(batched)
    for s, b in zip(serial, batched):
        np.testing.assert_array_equal(np.asarray(s.masked.mask), np.asarray(b.masked.mask))
        np.testing.assert_allclose(
            np.asarray(s.masked.table.columns["v"].data),
            np.asarray(b.masked.table.columns["v"].data),
            rtol=1e-5,
        )


def _assert_ref(want, got, label):
    assert len(want) == len(got), label
    for i, (w, g) in enumerate(zip(want, got)):
        assert_masked(w.masked, g.masked, f"{label}[{i}]")


@pytest.fixture
def db():
    s = PC.Session(device="cpu")
    _populate(PC, s)
    return s


@pytest.fixture
def ref():
    s = RC.Session()
    _populate(RC, s)
    return s


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


# ---------------------------------------------------------------------------
# element-wise identity with the serial loop and the reference
# ---------------------------------------------------------------------------


def test_execute_many_matches_serial_loop(db, ref):
    stmt = db.prepare(_q(), PC.FROID)
    params_list = [{"cutoff": k} for k in (3, 17, 42, 50, 1, 29, 8)]
    serial = [stmt.execute(params=p) for p in params_list]
    batched = stmt.execute_many(params_list)
    _assert_same(serial, batched)
    _assert_ref(ref.prepare(_q(RC), RC.FROID).execute_many(params_list), batched,
                "reference execute_many vs port execute_many")
    st = batched[0].stats
    assert st["batched"] and st["batch_size"] == 7 and st["batch_bucket"] == 8
    assert "dispatch_s" in st and "sync_s" in st
    assert "udf_rows" not in st  # FROID inlined the UDF: no per-row hook ran


def test_execute_many_order_preserved(db, ref):
    stmt = db.prepare(_q(), PC.FROID)
    # mixed signatures interleaved: results must come back in input order
    params_list = [{"cutoff": 3}, {"cutoff": 10.5}, {"cutoff": 40},
                   {"cutoff": 0.5}, {"cutoff": 22}]
    batched = stmt.execute_many(params_list)
    serial = [stmt.execute(params=p) for p in params_list]
    _assert_same(serial, batched)
    rstmt = ref.prepare(_q(RC), RC.FROID)
    _assert_ref([rstmt.execute(params=p) for p in params_list], batched,
                "reference serial vs port execute_many")


def test_execute_many_empty_and_paramless(db):
    stmt = db.prepare(_q(), PC.FROID)
    assert stmt.execute_many([]) == []
    q = PC.scan("T").compute(v=PC.udf("key_total", PC.col("a")))
    s2 = db.prepare(q, PC.FROID)
    rs = s2.execute_many([None, {}, None])
    assert len(rs) == 3
    # one execution serves the group, but results are distinct shells
    assert len({id(r) for r in rs}) == 3
    assert len({id(r.stats) for r in rs}) == 3
    a = np.asarray(rs[0].masked.table.columns["v"].data)
    for r in rs[1:]:
        np.testing.assert_array_equal(a, np.asarray(r.masked.table.columns["v"].data))
    _assert_same([s2.execute()], rs[:1])


def test_execute_many_eager_policy_falls_back_serial(db, ref):
    stmt = db.prepare(_q(), PC.INTERPRETED)
    params_list = [{"cutoff": 5}, {"cutoff": 25}]
    rs = stmt.execute_many(params_list)
    serial = [stmt.execute(params=p) for p in params_list]
    _assert_same(serial, rs)
    assert "batched" not in rs[0].stats
    rstmt = ref.prepare(_q(RC), RC.INTERPRETED)
    _assert_ref([rstmt.execute(params=p) for p in params_list], rs,
                "reference INTERPRETED vs port")


def test_execute_many_hekaton(db, ref):
    stmt = db.prepare(_q(), PC.HEKATON)
    params_list = [{"cutoff": k} for k in (4, 31, 12)]
    serial = [stmt.execute(params=p) for p in params_list]
    batched = stmt.execute_many(params_list)
    _assert_same(serial, batched)
    _assert_ref(ref.prepare(_q(RC), RC.HEKATON).execute_many(params_list), batched,
                "reference HEKATON execute_many vs port")
    # the scan-mode row loop ran once for the whole batch: each result
    # reports the rows one invocation drives (every row of T), as serial
    assert batched[0].stats["udf_rows"] == serial[0].stats["udf_rows"] == 200


# ---------------------------------------------------------------------------
# bucketing + cache keying
# ---------------------------------------------------------------------------


def test_batch_bucket_shape():
    assert [PC.batch_bucket(n, 1024) for n in (1, 2, 3, 5, 8, 9, 1000)] == \
        [RC.batch_bucket(n, 1024) for n in (1, 2, 3, 5, 8, 9, 1000)] == \
        [1, 2, 4, 8, 8, 16, 1024]
    assert PC.batch_bucket(2000, 64) == 64  # capped at max_batch
    with pytest.raises(ValueError):
        PC.batch_bucket(0, 64)


def test_same_bucket_reuses_vmapped_executable(db):
    stmt = db.prepare(_q(), PC.FROID)
    stmt.execute_many([{"cutoff": k} for k in (1, 2, 3)])  # bucket 4
    misses = db.cache_stats["batch_misses"]
    r = stmt.execute_many([{"cutoff": k} for k in (9, 8, 7, 6)])  # bucket 4
    assert db.cache_stats["batch_misses"] == misses
    assert db.cache_stats["batch_hits"] >= 1
    assert r[0].cache_hit and r[0].stats["batch_bucket"] == 4
    # a different bucket is a new specialization
    stmt.execute_many([{"cutoff": k} for k in range(5)])  # bucket 8
    assert db.cache_stats["batch_misses"] == misses + 1


def test_mixed_signatures_split_into_buckets(db):
    stmt = db.prepare(_q(), PC.FROID)
    params_list = ([{"cutoff": k} for k in (1, 2, 3)]
                   + [{"cutoff": float(k)} for k in (4.0, 5.0)])
    before = db.cache_stats["batch_misses"]
    rs = stmt.execute_many(params_list)
    # two signatures -> two sub-batches -> two vmapped executables
    assert db.cache_stats["batch_misses"] == before + 2
    assert rs[0].stats["batch_size"] == 3 and rs[3].stats["batch_size"] == 2
    _assert_same([stmt.execute(params=p) for p in params_list], rs)


def test_max_batch_chunks(db, ref):
    stmt = db.prepare(_q(), PC.FROID.batched(max_batch=4))
    params_list = [{"cutoff": int(k)} for k in range(10)]
    rs = stmt.execute_many(params_list)
    sizes = [r.stats["batch_size"] for r in rs]
    assert sizes == [4, 4, 4, 4, 4, 4, 4, 4, 2, 2]
    assert all(r.stats["batch_bucket"] <= 4 for r in rs)
    _assert_same([stmt.execute(params=p) for p in params_list], rs)
    _assert_ref(ref.prepare(_q(RC), RC.FROID.batched(max_batch=4)).execute_many(params_list),
                rs, "reference chunks vs port chunks")


def test_batched_policy_knobs_are_not_identity():
    assert PC.FROID.batched(max_batch=8) == PC.FROID
    assert PC.FROID.batched(max_batch=8).fingerprint() == PC.FROID.fingerprint()
    assert PC.FROID.batched(max_batch=8).max_batch == 8
    assert not PC.INTERPRETED.allow_async


def test_prepare_distinct_batch_knobs_do_not_alias(db):
    s1 = db.prepare(_q(), PC.FROID)
    s2 = db.prepare(_q(), PC.FROID.batched(max_batch=2, allow_async=False))
    assert s1 is not s2
    assert s1.policy.max_batch == PC.FROID.max_batch
    assert s2.policy.max_batch == 2 and not s2.policy.allow_async
    rs = s2.execute_many([{"cutoff": k} for k in range(5)])
    assert all(r.stats["batch_bucket"] <= 2 for r in rs)
    assert s2.execute_async(params={"cutoff": 3}).done()  # degraded to sync
    s1.execute(params={"cutoff": 9})
    misses = db.cache_stats["exec_misses"]
    r = s2.execute(params={"cutoff": 9})
    assert db.cache_stats["exec_misses"] == misses and r.cache_hit


def test_padding_rows_are_computed_and_discarded(db):
    """N = 5 runs in bucket 8: the three padding rows repeat the last set,
    and no result is theirs."""
    stmt = db.prepare(_q(), PC.FROID)
    params_list = [{"cutoff": k} for k in (44, 2, 30, 11, 7)]
    rs = stmt.execute_many(params_list)
    assert [r.stats["batch_bucket"] for r in rs] == [8] * 5
    _assert_same([stmt.execute(params=p) for p in params_list], rs)


def test_raw_call_returns_device_outputs(db):
    stmt = db.prepare(_q(), PC.FROID)
    mask, cols = stmt(params={"cutoff": 20})
    r = stmt.execute(params={"cutoff": 20})
    assert torch.equal(mask, r.masked.mask)
    assert torch.equal(cols["v"][0], r.masked.table.columns["v"].data)
    assert torch.equal(db.prepare(_q(), PC.INTERPRETED)(params={"cutoff": 20}), mask)


# ---------------------------------------------------------------------------
# chunk pipelining
# ---------------------------------------------------------------------------


def test_chunked_dispatches_are_pipelined(db):
    stmt = db.prepare(_q(), PC.FROID.batched(max_batch=4))
    params_list = [{"cutoff": int(k)} for k in range(10)]
    rs = stmt.execute_many(params_list)
    assert all(r.stats["pipelined_chunks"] == 3 for r in rs)
    assert all(r.stats["wave_tickets"] == r.stats["batch_size"] for r in rs)
    _assert_same([stmt.execute(params=p) for p in params_list], rs)
    r1 = stmt.execute_many([{"cutoff": 5}])
    assert r1[0].stats["pipelined_chunks"] == 1


def test_pipelining_bounded_by_max_inflight(db):
    stmt = db.prepare(_q(), PC.FROID.batched(max_batch=2, max_inflight=1))
    params_list = [{"cutoff": int(k)} for k in range(7)]
    rs = stmt.execute_many(params_list)
    assert rs[0].stats["pipelined_chunks"] == 4
    _assert_same([stmt.execute(params=p) for p in params_list], rs)


# ---------------------------------------------------------------------------
# adaptive coalescing
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_adaptive_window_tracks_arrival_rate(db):
    clock = FakeClock()
    sched = CoalescingScheduler(max_batch=64, window_s=10.0, clock=clock,
                                adaptive=True, adaptive_alpha=0.5,
                                adaptive_hold=4.0)
    stmt = db.prepare(_q(), PC.FROID)
    ts = []
    for k in (1, 2, 3):
        ts.append(sched.submit(stmt, {"cutoff": k}))
        clock.advance(0.01)
    assert abs(sched.ema_gap_s(stmt) - 0.01) < 1e-12
    assert abs(sched.effective_window(stmt) - 0.04) < 1e-12
    assert sched.poll() == 0
    clock.advance(0.02)
    assert sched.poll() == 3
    _assert_same([stmt.execute(params={"cutoff": k}) for k in (1, 2, 3)],
                 [t.result() for t in ts])


def test_adaptive_window_clamped_to_configured_window(db):
    clock = FakeClock()
    sched = CoalescingScheduler(max_batch=64, window_s=0.05, clock=clock,
                                adaptive=True)
    stmt = db.prepare(_q(), PC.FROID)
    sched.submit(stmt, {"cutoff": 1})
    clock.advance(100.0)
    sched.poll()
    sched.submit(stmt, {"cutoff": 2})
    assert sched.ema_gap_s(stmt) == 100.0
    assert sched.effective_window(stmt) == 0.05
    plain = CoalescingScheduler(window_s=0.05, clock=clock)
    assert not plain.adaptive and plain.effective_window(stmt) == 0.05
    sched.flush()


def test_adaptive_window_is_per_statement(db):
    clock = FakeClock()
    sched = CoalescingScheduler(max_batch=64, window_s=10.0, clock=clock,
                                adaptive=True, adaptive_hold=4.0)
    stmts = [db.prepare(_q(), PC.FROID),
             db.prepare(PC.scan("T").filter(PC.col("a") < PC.param("cutoff")), PC.FROID),
             db.prepare(PC.scan("T").compute(b=PC.col("a") * 2), PC.FROID)]
    for wave in range(3):
        for s in stmts:
            sched.submit(s, {"cutoff": wave + 1} if s is not stmts[2] else {})
            clock.advance(0.01)
    for s in stmts:
        assert abs(sched.ema_gap_s(s) - 0.03) < 1e-12
        assert abs(sched.effective_window(s) - 0.12) < 1e-12
    assert sched.stats["batches"] == 0 and sched.pending == 9
    assert sched.flush() == 9
    assert sched.stats["batches"] == 3 and sched.stats["flush_window"] == 0


def test_scheduler_refuses_fused_drains(db, ref):
    """``fuse=True`` was refused until fusion was ported (ROADMAP A7); it
    now drains a mixed queue as one fused wave, equal to the serial loop
    and to the reference's fused drain."""
    from repro.serve.scheduler import CoalescingScheduler as RefScheduler

    arith = lambda M: M.scan("T").compute(b=M.col("a") * M.param("m")).project("b")  # noqa: E731
    out = {}
    for M, session, cls in ((PC, db, CoalescingScheduler), (RC, ref, RefScheduler)):
        s1, s2 = session.prepare(_q(M), M.FROID), session.prepare(arith(M), M.FROID)
        calls = [(s1, {"cutoff": 9}), (s2, {"m": 3}), (s1, {"cutoff": 40})]
        sched = cls(max_batch=64, window_s=10.0, clock=lambda: 0.0, fuse=True)
        tickets = [sched.submit(s, p) for s, p in calls]
        sched.flush()
        out[M] = ([t.result() for t in tickets], dict(sched.stats), calls)
    got, stats, calls = out[PC]
    assert stats == out[RC][1] and stats["fused_batches"] == 1 and stats["batches"] == 1
    assert all(r.stats["fused"] and r.stats["fused_statements"] == 2 for r in got)
    _assert_ref(out[RC][0], got, "reference fused drain vs port fused drain")
    _assert_ref([s.execute(params=p) for s, p in calls], got, "serial vs fused drain")


def test_routed_execute_many_beside_the_reference(db, ref):
    """A ``ROUTED`` statement's ``execute_many`` (chunks of ``max_batch``
    8, a bucket ridden or not as the router picks) equals the reference's
    FROID serial loop; both routers sample every chunk under the same keys,
    and a bucket ride, forced by a near-free warm bucket, runs the warm
    executable and still answers as the serial loop."""
    params = [{"cutoff": k} for k in (3, 17, 42, 50, 1, 29, 8, 11, 23, 5, 37)]
    want = [ref.prepare(_q(RC), RC.FROID).execute(params=p) for p in params]
    keys = {}
    for M, session in ((RC, ref), (PC, db)):
        stmt = session.prepare(_q(M), M.ROUTED.batched(max_batch=8))
        got = stmt.execute_many(params)
        if M is PC:
            _assert_ref(want, got, "ROUTED execute_many vs reference serial")
            _assert_ref(want, stmt.execute_many(params), "ROUTED execute_many, warm")
        else:
            stmt.execute_many(params)
        cs = session.cost_stats
        keys[M] = (cs["samples"], sorted(cs["measured"]), cs["bucket_rides"])
    assert keys[PC] == keys[RC] and keys[PC][0] == 4  # 2 calls x (8 + 3 in bucket 4)
    r = db.cost_router
    for k in r.measured:
        r.measured[k].wave_s = 1e-9
    misses = db.cache_stats["batch_misses"]
    stmt = db.prepare(_q(), PC.ROUTED.batched(max_batch=8))
    got = stmt.execute_many(params[:2])  # natural bucket 2, cold: rides 4 or 8
    _assert_ref(want[:2], got, "ridden bucket vs reference serial")
    assert got[0].stats["batch_bucket"] in (4, 8) and db.cache_stats["batch_misses"] == misses
    assert db.cost_stats["bucket_rides"] == 1


def test_routed_ladder_excludes_fault_window_samples(db, ref):
    """A routed statement drained through the resilience ladder while its
    dispatch fails twice: the retries' samples are excluded, the clean
    first attempts' kept, and the counts and the answers are the
    reference's."""
    from repro.resilience import FaultInjector as RefFI
    from repro.resilience import FaultSpec as RefFS
    from repro.serve.scheduler import CoalescingScheduler as RefScheduler
    from repro_torch.resilience import FaultInjector, FaultSpec

    params = [{"cutoff": k} for k in (3, 17, 42, 50)]
    out = {}
    for M, session, cls, fi, fs in ((RC, ref, RefScheduler, RefFI, RefFS),
                                    (PC, db, CoalescingScheduler, FaultInjector, FaultSpec)):
        stmt = session.prepare(_q(M), M.ROUTED)
        fi([fs(site="dispatch", times=2)]).install(session)
        sched = cls(max_batch=64, window_s=10.0, clock=lambda: 0.0, sleep=lambda s: None)
        tickets = [sched.submit(stmt, p) for p in params]
        sched.flush()
        cs = session.cost_stats
        out[M] = ([t.result() for t in tickets], dict(sched.stats),
                  {k: cs[k] for k in ("samples", "samples_excluded", "decisions")})
    assert out[PC][2] == out[RC][2] and out[PC][2]["samples_excluded"] >= 1
    assert out[PC][1] == out[RC][1]
    _assert_ref(out[RC][0], out[PC][0], "faulted routed drain vs reference")


# ---------------------------------------------------------------------------
# invalidation
# ---------------------------------------------------------------------------


def _detail(seed):
    rng = np.random.default_rng(seed)
    return dict(d_key=rng.integers(0, 50, 2000),
                d_val=rng.uniform(0, 100, 2000).astype(np.float32))


def test_catalog_mutation_invalidates_between_execute_many_calls(db):
    stmt = db.prepare(_q(), PC.FROID)
    params_list = [{"cutoff": k} for k in (10, 20, 30)]
    r1 = stmt.execute_many(params_list)
    assert stmt.execute_many(params_list)[0].cache_hit
    db.create_table("detail", **_detail(99))
    r2 = stmt.execute_many(params_list)
    assert not r2[0].cache_hit
    _assert_same([stmt.execute(params=p) for p in params_list], r2)
    a1 = np.asarray(r1[2].masked.table.columns["v"].data)
    a2 = np.asarray(r2[2].masked.table.columns["v"].data)
    assert not np.allclose(a1, a2)


def test_ddl_between_submit_and_drain_not_stale(db):
    sched = CoalescingScheduler(max_batch=64, window_s=10.0, clock=FakeClock())
    stmt = db.prepare(_q(), PC.FROID)
    params_list = [{"cutoff": k} for k in (10, 20, 49)]
    stmt.execute_many(params_list)
    tickets = [sched.submit(stmt, p) for p in params_list]
    db.create_table("detail", **_detail(17))
    assert sched.flush() == 3
    results = [t.result() for t in tickets]
    assert not results[0].cache_hit
    _assert_same([stmt.execute(params=p) for p in params_list], results)


def test_catalog_poke_between_submit_and_drain_not_stale(db):
    from repro_torch.tables.table import Table

    sched = CoalescingScheduler(max_batch=64, window_s=10.0, clock=FakeClock())
    stmt = db.prepare(_q(), PC.FROID)
    params = {"cutoff": 49}
    warm = stmt.execute(params=params)
    t = sched.submit(stmt, params)
    poked = Table.from_arrays("cpu", **_detail(23))
    poked.compute_stats()
    db.catalog["detail"] = poked
    sched.flush()
    r = t.result()
    _assert_same([stmt.execute(params=params)], [r])
    m = np.asarray(r.masked.mask)
    assert not np.allclose(np.asarray(warm.masked.table.columns["v"].data)[m],
                           np.asarray(r.masked.table.columns["v"].data)[m])


def test_udf_replacement_between_submit_and_drain_not_stale(db):
    sched = CoalescingScheduler(max_batch=64, window_s=10.0, clock=FakeClock())
    stmt = db.prepare(_q(), PC.FROID)
    t = sched.submit(stmt, {"cutoff": 49})
    u = PC.UdfBuilder("key_total", [("k", "int32")], "float32")
    u.return_(PC.lit(-1.0))
    db.create_function(u.build())
    sched.flush()
    r = t.result()
    m = np.asarray(r.masked.mask)
    np.testing.assert_allclose(np.asarray(r.masked.table.columns["v"].data)[m], -1.0)


# ---------------------------------------------------------------------------
# async futures
# ---------------------------------------------------------------------------


def test_execute_async_matches_sync(db, ref):
    stmt = db.prepare(_q(), PC.FROID)
    fut = stmt.execute_async(params={"cutoff": 33})
    assert isinstance(fut, PC.AsyncResult)
    assert fut._marker is None and fut.done()  # a CPU session has no event
    r = fut.result()
    s = stmt.execute(params={"cutoff": 33})
    _assert_same([s], [r])
    _assert_ref([ref.prepare(_q(RC), RC.FROID).execute_async(params={"cutoff": 33}).result()],
                [r], "reference execute_async vs port")
    assert r.stats.get("async") and "sync_s" in r.stats
    assert fut.result() is r  # idempotent


def test_execute_async_pipelined_dispatches(db):
    stmt = db.prepare(_q(), PC.FROID)
    params_list = [{"cutoff": k} for k in (2, 12, 22, 32)]
    futs = [stmt.execute_async(params=p) for p in params_list]
    rs = [f.result() for f in futs]
    _assert_same([stmt.execute(params=p) for p in params_list], rs)


def test_execute_async_disallowed_degrades_to_sync(db):
    stmt = db.prepare(_q(), PC.FROID.batched(allow_async=False))
    fut = stmt.execute_async(params={"cutoff": 11})
    assert fut.done()
    _assert_same([stmt.execute(params={"cutoff": 11})], [fut.result()])
    fut2 = db.prepare(_q(), PC.INTERPRETED).execute_async(params={"cutoff": 11})
    assert fut2.done()
    assert "async" not in fut2.result().stats


def test_async_backpressure_bounds_inflight(db):
    stmt = db.prepare(_q(), PC.FROID.batched(max_inflight=2))
    futs = []
    for k in range(8):
        futs.append(stmt.execute_async(params={"cutoff": int(k % 50)}))
        assert db.inflight <= 2
    assert db.async_stats["inflight_peak"] <= 2
    rs = [f.result() for f in futs]
    assert db.inflight == 0
    _assert_same([stmt.execute(params={"cutoff": int(k % 50)}) for k in range(8)], rs)


class _Event:
    """A marker that is never done until waited on (a CUDA event's
    ``query``/``synchronize``)."""

    def __init__(self):
        self.waited = False

    def query(self):
        return self.waited

    def synchronize(self):
        self.waited = True


def test_admit_async_blocks_at_bound():
    """With the queue full of never-done dispatches, admission waits on
    exactly the oldest one's event."""
    db = PC.Session(device="cpu")
    s1, s2 = (PC.AsyncResult(None, marker=_Event(), session=db) for _ in range(2))
    db._inflight.extend([s1, s2])
    db._admit_async(2)
    assert db.async_stats["inflight_waits"] == 1
    assert s1._released and s1._marker.waited and not s2._released
    assert not s2._marker.waited
    assert list(db._inflight) == [s2]
    db._admit_async(2)
    assert db.async_stats["inflight_waits"] == 1


def test_async_result_releases_slot(db):
    stmt = db.prepare(_q(), PC.FROID.batched(max_inflight=4))
    fut = stmt.execute_async(params={"cutoff": 13})
    assert db.inflight == 1
    fut.result()
    assert db.inflight == 0
    fut.result()
    assert db.inflight == 0


def test_async_degraded_results_hold_no_slot(db):
    stmt = db.prepare(_q(), PC.FROID.batched(allow_async=False, max_inflight=1))
    futs = [stmt.execute_async(params={"cutoff": 5}) for _ in range(3)]
    assert db.inflight == 0
    assert db.async_stats["inflight_waits"] == 0
    for f in futs:
        f.result()


def test_batched_max_inflight_knob_not_identity():
    assert PC.FROID.batched(max_inflight=2) == PC.FROID
    assert PC.FROID.batched(max_inflight=2).fingerprint() == PC.FROID.fingerprint()
    assert PC.FROID.batched(max_inflight=2).max_inflight == 2


# ---------------------------------------------------------------------------
# coalescing microbatch scheduler
# ---------------------------------------------------------------------------


def test_scheduler_coalesces_and_flushes_on_window(db, ref):
    clock = FakeClock()
    sched = CoalescingScheduler(max_batch=64, window_s=0.010, clock=clock)
    stmt = db.prepare(_q(), PC.FROID)
    t1 = sched.submit(stmt, {"cutoff": 5})
    t2 = sched.submit(stmt, {"cutoff": 25})
    assert sched.pending == 2 and not t1.done()
    assert sched.poll() == 0
    clock.advance(0.011)
    assert sched.poll() == 2
    assert t1.done() and t2.done()
    assert sched.stats["batches"] == 1 and sched.stats["flush_window"] == 1
    _assert_same([stmt.execute(params={"cutoff": 5}), stmt.execute(params={"cutoff": 25})],
                 [t1.result(), t2.result()])
    assert t1.result().stats["batch_size"] == 2
    rstmt = ref.prepare(_q(RC), RC.FROID)
    _assert_ref([rstmt.execute(params={"cutoff": c}) for c in (5, 25)],
                [t1.result(), t2.result()], "reference serial vs port scheduler")


def test_scheduler_flush_on_full_batch(db):
    sched = CoalescingScheduler(max_batch=3, window_s=10.0, clock=FakeClock())
    stmt = db.prepare(_q(), PC.FROID)
    ts = [sched.submit(stmt, {"cutoff": k}) for k in (1, 2)]
    assert sched.pending == 2
    ts.append(sched.submit(stmt, {"cutoff": 3}))
    assert sched.pending == 0 and all(t.done() for t in ts)
    assert sched.stats["flush_full"] == 1


def test_scheduler_result_forces_drain(db):
    sched = CoalescingScheduler(max_batch=64, window_s=10.0, clock=FakeClock())
    stmt = db.prepare(_q(), PC.FROID)
    t = sched.submit(stmt, {"cutoff": 7})
    assert not t.done()
    r = t.result()
    assert t.done() and sched.stats["flush_forced"] == 1
    _assert_same([stmt.execute(params={"cutoff": 7})], [r])


def test_scheduler_window_defaults_from_policy(db):
    clock = FakeClock()
    sched = CoalescingScheduler(clock=clock)
    stmt = db.prepare(_q(), PC.FROID.batched(max_batch=2, coalesce_window_s=5.0))
    sched.submit(stmt, {"cutoff": 1})
    clock.advance(1.0)
    assert sched.poll() == 0
    sched.submit(stmt, {"cutoff": 2})
    assert sched.pending == 0 and sched.stats["flush_full"] == 1


def test_scheduler_groups_per_statement(db):
    sched = CoalescingScheduler(max_batch=64, window_s=10.0, clock=FakeClock())
    s1 = db.prepare(_q(), PC.FROID)
    s2 = db.prepare(PC.scan("T").filter(PC.col("a") < PC.param("cutoff")), PC.FROID)
    t1 = sched.submit(s1, {"cutoff": 5})
    t2 = sched.submit(s2, {"cutoff": 5})
    assert sched.pending == 2
    assert sched.flush() == 2
    assert sched.stats["batches"] == 2
    assert t1.done() and t2.done()


# ---------------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------------

REQS = {
    "tier": np.array([0, 1, 2, 0, 2]),
    "prompt_len": np.array([100, 3000, 9000, 40000, 100]),
    "max_new_tokens": np.array([50, 2000, 8000, 10, 100]),
    "temperature": np.array([0.5, 1.5, -1.0, 0.7, 3.0], np.float32),
}


def _same_verdicts(want, got, label):
    np.testing.assert_array_equal(want["admit"], got["admit"], err_msg=label)
    np.testing.assert_array_equal(want["granted"], got["granted"], err_msg=label)
    np.testing.assert_allclose(want["temp"], got["temp"], rtol=1e-6, err_msg=label)


@pytest.mark.parametrize("policy", ["froid", "interpreted", "hekaton"])
def test_admission_coalesced_matches_tick_path(policy):
    ap = AdmissionPolicy(policy=policy, device="cpu")
    tick = ap.evaluate(REQS)
    co = ap.evaluate_coalesced(REQS)
    _same_verdicts(tick, co, f"{policy}: coalesced vs tick")
    _same_verdicts(RefAdmission(policy=policy).evaluate_coalesced(REQS), co,
                   f"{policy}: reference coalesced vs port")
    assert ap.scheduler.stats["batches"] >= 1
    assert ap.request_statement().policy.compile_plan
    before = ap._request_session.cache_stats["batch_misses"]
    ap.evaluate_coalesced(REQS)
    assert ap._request_session.cache_stats["batch_misses"] == before


def test_admission_coalesced_load_shedding_parity():
    n = 600
    rng = np.random.default_rng(3)
    reqs = {
        "tier": rng.integers(0, 3, n),
        "prompt_len": np.where(rng.random(n) < 0.5, 9000, 100),
        "max_new_tokens": np.full(n, 64),
        "temperature": np.full(n, 0.5, np.float32),
    }
    ap = AdmissionPolicy(device="cpu")
    tick = ap.evaluate(reqs)
    co = ap.evaluate_coalesced(reqs)
    np.testing.assert_array_equal(tick["admit"], co["admit"])
    assert not tick["admit"][reqs["prompt_len"] == 9000].any()
    assert tick["admit"][reqs["prompt_len"] == 100].all()


def test_serve_engine_submit_drain_matches_run():
    from repro_torch import configs as tconfigs
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = tconfigs.smoke_config_for("granite3_2b")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 5 + i).astype(np.int32),
                    max_new_tokens=3, tier=i % 3) for i in range(4)]
    reqs.append(Request(rid=4, prompt=np.zeros(40000, np.int32), max_new_tokens=3))
    want = ServeEngine(model, slots=2, max_len=64).run(reqs)
    eng = ServeEngine(model, slots=2, max_len=64)
    for r in reqs:
        eng.submit(r)
    got = eng.drain()
    assert [(c.rid, c.tokens, c.reason) for c in got] == \
        [(c.rid, c.tokens, c.reason) for c in want]
    assert got[0].reason == "rejected" and got[0].rid == 4
    assert eng.admission.scheduler.stats["batches"] == 1
    assert eng.drain() == []


# ---------------------------------------------------------------------------
# the invocation oracle (unsharded, sharded and HEKATON legs)
# ---------------------------------------------------------------------------

#: ``tests/test_conformance_oracle.py``'s mixed-signature list (int and
#: float shifts split sub-batches; repeats engage the padding)
PARAMS_MIXED = ([{"cut": c, "shift": 0.5} for c in (2, 7, 4, 0, 5)]
                + [{"cut": c, "shift": 1} for c in (3, 6, 1)])


@pytest.mark.parametrize("name", sorted(FIXED_PROGRAMS))
@pytest.mark.parametrize("n_rows", [0, 23], ids=["empty", "populated"])
def test_invocation_oracle_on_the_port(name, n_rows):
    """``check_invocation_oracle`` on the port: ``execute_many`` under
    FROID, FROID sharded over four CPU mesh positions, and HEKATON == the
    port's serial FROID loop == the reference's."""
    ref, port = RC.Session(), PC.Session(device="cpu")
    for tname, arrays in _facts_tables(n_rows, seed=2).items():
        ref.create_table(tname, **arrays)
        port.create_table(tname, **arrays)
    ref.create_function(_program_udf(RC, PROGRAMS[name](RC)))
    port.create_function(_program_udf(PC, PROGRAMS[name](PC)))
    rstmt = ref.prepare(_keys_query(RC, "f"), RC.FROID)
    serial = [port.prepare(_keys_query(PC, "f"), PC.FROID).execute(params=p)
              for p in PARAMS_MIXED]
    _assert_ref([rstmt.execute(params=p) for p in PARAMS_MIXED], serial,
                "reference serial vs port serial")
    mesh = make_small_mesh(data=4, devices=["cpu"] * 4)
    for policy, label in ((PC.FROID, "many"), (PC.FROID.sharded(mesh), "sharded"),
                          (PC.HEKATON, "hekaton")):
        batched = port.prepare(_keys_query(PC, "f"), policy).execute_many(PARAMS_MIXED)
        _assert_ref(serial, batched, f"execute_many[{label}] vs serial")
        # both signature groups (buckets 8 and 4) split over the 4 positions
        assert all(r.stats.get("sharded", False) == (label == "sharded")
                   for r in batched)


def test_invocation_oracle_empty_params_list():
    port = PC.Session(device="cpu")
    for tname, arrays in _facts_tables(23, seed=0).items():
        port.create_table(tname, **arrays)
    port.create_function(_program_udf(PC, PROGRAMS["correlated_min_null_guard"](PC)))
    for policy in (PC.FROID, PC.HEKATON):
        assert port.prepare(_keys_query(PC, "f"), policy).execute_many([]) == []


# ---------------------------------------------------------------------------
# relagg under execute_many
# ---------------------------------------------------------------------------


def _grouped(M):
    """A parameter in the filter over ``detail``, grouped by a dictionary
    key: with ``pallas_agg`` the GroupAgg takes relagg, batched over the
    parameter axis."""
    return (M.scan("detail").filter(M.col("d_val") <= M.param("v"))
            .group_by("cat", s=M.sum_(M.col("d_val")), c=M.count_()))


def _relagg_sessions(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    arrays = dict(d_key=rng.integers(0, 50, n),
                  d_val=rng.uniform(0, 100, n).astype(np.float32),
                  cat=np.array(["air", "rail", "ship", "truck"])[rng.integers(0, 4, n)])
    ref, port = RC.Session(), PC.Session(device="cpu")
    ref.create_table("detail", **arrays)
    port.create_table("detail", **arrays)
    return ref, port


def test_pallas_agg_plan_reaches_relagg_batched_once_per_chunk(monkeypatch):
    ref, port = _relagg_sessions()
    pol = PC.ExecutionPolicy(name="froid+relagg", pallas_agg=True).batched(max_batch=4)
    rpol = RC.ExecutionPolicy(name="froid+relagg", pallas_agg=True).batched(max_batch=4)
    calls = []
    batched = relagg_ops._batched

    def spy(gid, mask, vals, num_groups):
        calls.append((tuple(gid.shape), gid.stride(0)))
        return batched(gid, mask, vals, num_groups)

    monkeypatch.setattr(relagg_ops, "_batched", spy)
    params_list = [{"v": float(v)} for v in (5, 95, 40, 0.5, 60, 100, 70)]
    stmt = port.prepare(_grouped(PC), pol)
    serial = [stmt.execute(params=p) for p in params_list]
    assert calls == []  # the serial path takes the unbatched plain version
    rs = stmt.execute_many(params_list)
    # two chunks (4 + 3 in bucket 4): one batched op each, over the bucket,
    # with gid shared at stride 0
    assert calls == [((4, 3000), 0), ((4, 3000), 0)]
    _assert_ref(serial, rs, "execute_many vs serial")
    _assert_ref(ref.prepare(_grouped(RC), rpol).execute_many(params_list), rs,
                "reference execute_many vs port")


def test_parameter_free_groupagg_runs_once_unbatched(monkeypatch):
    """``key_total``'s decorrelated build does not depend on the parameter:
    under execute_many it runs once, through the unbatched op, not once a
    ticket and not batched."""
    ref, port = RC.Session(), PC.Session(device="cpu")
    rng = np.random.default_rng(0)
    cats = np.array(["a", "b", "c", "d", "e"])
    arrays = dict(d_key=rng.integers(0, 5, 2000), d_val=rng.uniform(0, 100, 2000).astype(np.float32))
    outer = dict(a=rng.integers(0, 5, 50), name=cats[rng.integers(0, 5, 50)])
    for s in (ref, port):
        s.create_table("detail", **arrays)
        s.create_table("T", **outer)
    counts = {"plain": 0, "batched": 0}
    plain, batched = relagg_ops.grouped_aggregate_ref, relagg_ops._batched
    monkeypatch.setattr(relagg_ops, "grouped_aggregate_ref",
                        lambda *a: counts.__setitem__("plain", counts["plain"] + 1) or plain(*a))
    monkeypatch.setattr(relagg_ops, "_batched",
                        lambda *a: counts.__setitem__("batched", counts["batched"] + 1) or batched(*a))

    def q(M):
        totals = M.scan("detail").group_by("d_key", t=M.sum_(M.col("d_val")))
        return (M.scan("T").filter(M.col("a") < M.param("cutoff"))
                .join(totals, on=[("a", "d_key")]).project("a", "t"))

    pol = PC.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    stmt = port.prepare(q(PC), pol)
    params_list = [{"cutoff": k} for k in (1, 3, 5, 2, 4)]
    rs = stmt.execute_many(params_list)
    assert counts == {"plain": 1, "batched": 0}
    rpol = RC.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    _assert_ref(ref.prepare(q(RC), rpol).execute_many(params_list), rs,
                "reference execute_many vs port")


# ---------------------------------------------------------------------------
# a WHILE on the scan-mode hook under execute_many
# ---------------------------------------------------------------------------


def _while_udf(M):
    """A plain WHILE (no cursor: FROID keeps the call on the scan-mode
    hook) with a BREAK and an early RETURN, whose trip count differs from
    row to row and from parameter set to parameter set."""
    u = M.UdfBuilder("w", [("x", "float32")], "float32")
    u.declare("i", "float32", M.lit(0.0))
    u.declare("t", "float32", M.lit(0.0))
    with u.while_(M.var("i") < M.param("x")):
        u.set("i", M.var("i") + 1.0)
        u.set("t", M.var("t") + M.var("i"))
        with u.if_(M.var("t") > M.lit(20.0)):
            u.break_()
        with u.if_(M.var("i") > M.lit(4.0)):
            u.return_(M.var("t") * -1.0)
    u.return_(M.var("t"))
    return u.build()


@pytest.mark.parametrize("policy", ["froid", "hekaton"])
def test_while_on_the_scan_hook_batches(policy):
    """The WHILE runs while any invocation's condition holds, each one's
    writes predicated on its own: execute_many == the serial loop == the
    reference's execute_many."""
    ref, port = RC.Session(), PC.Session(device="cpu")
    for s, M in ((ref, RC), (port, PC)):
        s.create_table("keys", k=np.arange(7))
        s.create_function(_while_udf(M))

    def q(M):
        return (M.scan("keys").filter(M.col("k") < M.param("cut"))
                .compute(out=M.udf("w", M.col("k") * 1.0 + M.param("shift")))
                .project("k", "out"))

    params_list = [{"cut": 7, "shift": s} for s in (0.5, 3.0, -1.0, 10.0, 1.5)]
    stmt = port.prepare(q(PC), PC.PRESETS[policy])
    serial = [stmt.execute(params=p) for p in params_list]
    batched = stmt.execute_many(params_list)
    _assert_ref(serial, batched, "execute_many vs serial")
    _assert_ref(ref.prepare(q(RC), RC.PRESETS[policy]).execute_many(params_list), batched,
                "reference execute_many vs port")
    assert len({float(r.masked.table.columns["out"].data[3]) for r in batched}) > 2


def _nested(M, S):
    """A correlated subquery (non-equi, so no rule decorrelates it) whose
    body groups with relagg, the parameter in its filter: under
    execute_many that is a vmap over the parameter sets of a vmap over the
    outer rows."""
    inner = (M.scan("facts").filter((M.col("fk") <= S.Outer("k"))
                                    & (M.col("qty") >= M.param("minq")))
             .group_by("cat", g=M.sum_(M.col("val"))).agg(s=M.max_(M.col("g"))))
    return M.scan("keys").compute(out=M.scalar_subquery(inner, "s")).project("k", "out")


def test_nested_vmap_folds_into_relaggs_batch_axis(monkeypatch):
    """relagg's nested rule folds the parameter level into the batch axis:
    one batched op a chunk over parameter sets x outer rows, equal to the
    serial loop and to the reference's execute_many."""
    from conformance_util import facts_data
    from repro.core import scalar as RS
    from repro_torch.core import scalar as PS

    rng = np.random.default_rng(4)
    facts = facts_data(4, 23)
    facts["cat"] = np.array(["red", "green", "blue"])[rng.integers(0, 3, 23)]
    ref, port = RC.Session(), PC.Session(device="cpu")
    for s in (ref, port):
        s.create_table("facts", **facts)
        s.create_table("keys", k=np.arange(7) - 1)
    calls = []
    batched = relagg_ops._batched

    def spy(gid, mask, vals, num_groups):
        calls.append(tuple(mask.shape))
        return batched(gid, mask, vals, num_groups)

    monkeypatch.setattr(relagg_ops, "_batched", spy)
    pol = PC.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    params_list = [{"minq": q} for q in (0, 4, 9)]
    stmt = port.prepare(_nested(PC, PS), pol)
    serial = [stmt.execute(params=p) for p in params_list]
    assert calls == [(7, 23)] * 3  # one batched op a call, over the outer rows
    calls.clear()
    rs = stmt.execute_many(params_list)
    assert calls == [(4 * 7, 23)]  # bucket 4 x 7 outer rows, one op
    _assert_ref(serial, rs, "execute_many vs serial")
    rpol = RC.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    _assert_ref(ref.prepare(_nested(RC, RS), rpol).execute_many(params_list), rs,
                "reference execute_many vs port")


# ---------------------------------------------------------------------------
# chip_smoke.py's invocation phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_smoke_key_total_meets_its_float64_answer(smoke, db):
    """(a)'s statement is the benchmark's (``_q`` here) and its checks
    pass on ``execute_many``, async and serial results, at 2,000 rows
    (relagg off: the plain relagg sums in float32 on the CPU)."""
    assert PC.plan_fingerprint(smoke.key_total_query().node) == PC.plan_fingerprint(_q().node)
    rng = np.random.default_rng(0)
    d_key, d_val = rng.integers(0, 50, 2000), rng.uniform(0, 100, 2000).astype(np.float32)
    a = rng.integers(0, 50, 200)
    sums = np.bincount(d_key, weights=d_val.astype(np.float64), minlength=50)
    tol = 1e-6 * np.bincount(d_key, weights=np.abs(d_val.astype(np.float64)), minlength=50) + 1e-3
    stmt = db.prepare(smoke.key_total_query(), PC.FROID)
    cutoffs = np.array([3, 17, 42, 50, 1])
    plist = [{"cutoff": int(c)} for c in cutoffs]
    serial = [stmt.execute(params=p) for p in plist]
    many = stmt.execute_many(plist)
    asyn = [stmt.execute_async(params=p).result() for p in plist]
    for rs in (serial, many, asyn):
        smoke.check_key_totals(rs, cutoffs, a, sums, tol, "rehearsal")
    assert smoke.same_tickets(serial, asyn, "v", "async", exact=True) == 0.0
    smoke.same_tickets(serial, many, "v", "execute_many", exact=False)
    with pytest.raises(RuntimeError, match="masks differ"):
        smoke.check_key_totals(many, cutoffs + 1, a, sums, tol, "a wrong cutoff")


def test_smoke_grouped_param_meets_its_float64_answer(smoke):
    """(b)'s statement and checks at SF 0.001 on the CPU (relagg off)."""
    from repro_torch.data.tpch import generate_tpch

    s = PC.Session(device="cpu")
    generate_tpch(s, sf=0.001)
    odate = s.catalog["orders"].columns["o_orderdate"].data.numpy()
    dates = np.sort(odate)[np.linspace(0, len(odate) - 1, 16).astype(int)]
    expected = smoke.grouped_param_expected(s, dates)
    price = PC.col("l_extendedprice") * (PC.lit(1.0) - PC.col("l_discount"))
    q = (PC.scan("lineitem").filter(PC.col("l_shipdate") <= PC.param("d"))
         .group_by("l_shipmode", g=PC.sum_(price)))
    stmt = s.prepare(q, PC.FROID)
    plist = [{"d": int(d)} for d in dates]
    many = stmt.execute_many(plist)
    smoke.check_grouped_param(many, expected, "rehearsal")
    smoke.check_grouped_param([stmt.execute(params=p) for p in plist], expected, "serial")
    assert not expected[0][1].all() and expected[-1][1].all()  # early dates miss modes
