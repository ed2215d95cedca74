"""The port's mesh-sharded ``execute_many`` (``policy.sharded(mesh)``), on
the CPU, against the serial loop and against the reference.

Ports every case of ``tests/test_sharded_many.py``: shard knobs are not
identity, the shard token, sharded and unsharded prepares do not alias,
sharded == serial (mixed signatures, an empty table, an empty aggregate
source), small buckets replicated, the shard cache tier, the replicated
fallback under ``max_batch``, mesh-capacity chunking, DDL invalidation,
the scheduler's mesh-sized flushes, DDL between submit and drain,
admission sharded == tick, and the engine's ``admission_mesh``.

The port's mesh is ``make_small_mesh(data=4, devices=["cpu"] * 4)``: four
mesh positions over one CPU, the port's counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, so the sharded
tier really runs here (one block a position).  Rows are held to the
port's serial loop and to the reference's ``execute_many`` rows.  The
reference's sharded *figures* (``shard_devices``, buckets and chunk sizes,
a fused wave's padded bucket, the shard cache counters) come from one
module-scoped subprocess that runs :func:`figures` on ``repro`` under four
forced host devices; the port's :func:`figures` must equal them scenario
by scenario.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import conformance_util as CU
import repro.core as RC
import repro_torch.core as PC
from repro_torch.dist.sharding import data_axis_size, pick_data_axes
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.serve.scheduler import CoalescingScheduler

from test_torch_correlated import assert_masked, no_vmap_fallback

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: mesh positions of the CPU mesh every sharded port test runs on
N_POS = 4


def cpu_mesh(n: int = N_POS):
    """An ``n``-position data mesh over the one CPU."""
    return make_small_mesh(data=n, devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


# ---------------------------------------------------------------------------
# helpers: either package
# ---------------------------------------------------------------------------


def _session(M):
    return M.Session(device="cpu") if M is PC else M.Session()


def _populate(M, db, n_detail=2000, n_t=200, seed=0):
    """``tests/test_sharded_many.py::_populate`` with either package."""
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


def _db(M):
    s = _session(M)
    _populate(M, s)
    return s


def _q(M=PC):
    return (
        M.scan("T")
        .filter(M.col("a") < M.param("cutoff"))
        .compute(v=M.udf("key_total", M.col("a")))
        .project("v")
    )


def _new_detail(db, seed):
    rng = np.random.default_rng(seed)
    db.create_table(
        "detail",
        d_key=rng.integers(0, 50, 2000),
        d_val=rng.uniform(0, 100, 2000).astype(np.float32),
    )


def _assert_same(serial, batched, label="sharded vs serial"):
    assert len(serial) == len(batched), label
    for i, (s, b) in enumerate(zip(serial, batched)):
        assert_masked(s.masked, b.masked, f"{label}[{i}]")


def _ref_rows(params_list, policy_of=lambda M: M.FROID, setup=None):
    """The reference's ``execute_many`` rows for the same statement."""
    ref = _db(RC)
    if setup is not None:
        setup(RC, ref)
    return ref.prepare(_q(RC), policy_of(RC)).execute_many(params_list)


def _fig(results) -> list:
    """The sharded figures of a result list, one row a result."""
    return [[r.stats.get("batch_size"), r.stats.get("batch_bucket"),
             bool(r.stats.get("sharded", False)), r.stats.get("shard_devices")]
            for r in results]


PARAMS8 = [{"cutoff": int(k)} for k in np.random.default_rng(1).integers(1, 50, 2 * N_POS)]
MIXED = ([{"cutoff": int(k)} for k in range(1, 1 + 2 * N_POS)]
         + [{"cutoff": float(k) + 0.5} for k in range(1, 1 + N_POS)])


# ---------------------------------------------------------------------------
# the scenarios whose figures the reference must share
# ---------------------------------------------------------------------------


def _sc_serial8(M, mesh_of):
    db = _db(M)
    rs = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS))).execute_many(PARAMS8)
    return [_fig(rs), db.cache_stats["shard_misses"]], rs


def _sc_mixed(M, mesh_of):
    rs = _db(M).prepare(_q(M), M.FROID.sharded(mesh_of(N_POS))).execute_many(MIXED)
    return _fig(rs), rs


def _sc_small(M, mesh_of):
    db = _db(M)
    rs = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS))).execute_many([{"cutoff": 7}])
    return [_fig(rs), db.cache_stats["shard_misses"]], rs


def _sc_cache(M, mesh_of):
    db = _db(M)
    stmt = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS)))
    params = [{"cutoff": int(k)} for k in range(N_POS)]
    r1 = stmt.execute_many(params)
    c1 = [r1[0].cache_hit, db.cache_stats["shard_hits"], db.cache_stats["shard_misses"]]
    r2 = stmt.execute_many([{"cutoff": int(k) + 9} for k in range(N_POS)])
    c2 = [r2[0].cache_hit, db.cache_stats["shard_hits"], db.cache_stats["shard_misses"]]
    db.prepare(_q(M), M.FROID).execute_many(params)
    return [_fig(r1), c1, _fig(r2), c2, db.cache_stats["batch_misses"]], r1 + r2


def _sc_fallback(M, mesh_of):
    """Three positions, ``max_batch=2``, four tickets: bucket 4 does not
    split over 3, so the call re-chunks to the per-device bound."""
    db = _db(M)
    stmt = db.prepare(_q(M), M.FROID.sharded(mesh_of(3)).batched(max_batch=2))
    rs = stmt.execute_many([{"cutoff": int(k)} for k in range(4)])
    return [_fig(rs), db.cache_stats["shard_misses"]], rs


def _sc_capacity(M, mesh_of):
    db = _db(M)
    stmt = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS)).batched(max_batch=2))
    rs = stmt.execute_many([{"cutoff": int(k % 50)} for k in range(2 * N_POS + 2)])
    return _fig(rs), rs


def _sc_ddl(M, mesh_of):
    db = _db(M)
    stmt = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS)))
    params = [{"cutoff": int(k)} for k in range(N_POS)]
    stmt.execute_many(params)
    warm = stmt.execute_many(params)[0].cache_hit
    _new_detail(db, 42)
    rs = stmt.execute_many(params)
    return [warm, rs[0].cache_hit, _fig(rs), db.cache_stats["shard_hits"],
            db.cache_stats["shard_misses"]], rs


def _scheduler(M, **kw):
    if M is PC:
        return CoalescingScheduler(**kw)
    from repro.serve.scheduler import CoalescingScheduler as RefScheduler

    return RefScheduler(**kw)


def _sc_scheduler(M, mesh_of):
    db = _db(M)
    sched = _scheduler(M, window_s=10.0, clock=lambda: 0.0)
    stmt = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS)).batched(max_batch=2))
    target = 2 * N_POS
    tickets = [sched.submit(stmt, {"cutoff": int(k % 50)}) for k in range(target - 1)]
    pending = sched.pending
    tickets.append(sched.submit(stmt, {"cutoff": 1}))
    rs = [t.result() for t in tickets]
    return [pending, sched.pending, sched.stats["flush_full"], _fig(rs)], rs


def _sc_ddl_sched(M, mesh_of):
    db = _db(M)
    sched = _scheduler(M, window_s=10.0, clock=lambda: 0.0)
    stmt = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS)))
    params = [{"cutoff": int(k)} for k in range(N_POS)]
    stmt.execute_many(params)
    tickets = [sched.submit(stmt, p) for p in params]
    _new_detail(db, 7)
    sched.flush()
    rs = [t.result() for t in tickets]
    return [rs[0].cache_hit, _fig(rs), db.cache_stats["shard_misses"]], rs


def _empty_t(M, db):
    db.create_table("T", a=np.array([], np.int64))


def _sc_empty(M, mesh_of):
    db = _db(M)
    _empty_t(M, db)
    rs = db.prepare(_q(M), M.FROID.sharded(mesh_of(N_POS))).execute_many(
        [{"cutoff": int(k)} for k in range(N_POS)])
    return [_fig(rs), [int(r.masked.num_rows) for r in rs]], rs


#: ``tests/test_fused.py``'s sharded specs (every member divisible; mixed
#: divisibility, 8 + 3 tickets and a parameter-free member), and 8 + 2
#: tickets, whose 2-ticket member pads its bucket up to the 4 positions
FUSED_SPECS = {
    "fused_divisible": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
                        + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(8)]
                        + [(2, None) for _ in range(8)]),
    "fused_mixed": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
                    + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(3)]
                    + [(2, None) for _ in range(2)]),
    "fused_padded": ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
                     + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(2)]
                     + [(2, None) for _ in range(2)]),
}


def _fused(M, mesh_of, name, seed):
    if M is PC:
        from test_torch_fused import check_fusion_oracle_port as check
    else:
        check = CU.check_fusion_oracle
    rs = check(seed, 23, M.FROID.sharded(mesh_of(N_POS)), FUSED_SPECS[name])
    return [_fig(rs), [bool(r.stats.get("fused")) for r in rs]], rs


def _sc_fused_divisible(M, mesh_of):
    return _fused(M, mesh_of, "fused_divisible", 16)


def _sc_fused_mixed(M, mesh_of):
    return _fused(M, mesh_of, "fused_mixed", 17)


def _sc_fused_padded(M, mesh_of):
    return _fused(M, mesh_of, "fused_padded", 18)


def _frozen_clock() -> float:
    return 0.0


def _sc_admission(M, mesh_of):
    # each package's scheduler as AdmissionPolicy builds it by default, on a
    # clock that does not advance during the scenario: on time.monotonic a
    # drain's submits may straddle the flush window under load and split the
    # batches otherwise
    if M is PC:
        from repro_torch.serve.admission import AdmissionPolicy
        from repro_torch.serve.scheduler import CoalescingScheduler

        sched = CoalescingScheduler(clock=_frozen_clock, fuse=False, adaptive=False,
                                    default_timeout_s=None)
        ap = AdmissionPolicy(device="cpu", froid=True, mesh=mesh_of(N_POS), scheduler=sched)
    else:
        from repro.serve.admission import AdmissionPolicy
        from repro.serve.scheduler import CoalescingScheduler

        sched = CoalescingScheduler(clock=_frozen_clock, fuse=False, adaptive=False,
                                    default_timeout_s=None)
        ap = AdmissionPolicy(froid=True, mesh=mesh_of(N_POS), scheduler=sched)
    reqs = _admission_requests()
    co = ap.evaluate_coalesced(reqs)
    stmt = ap.request_statement()
    return [stmt.policy.shard_devices(), ap.scheduler.stats["batches"],
            np.asarray(co["admit"]).astype(bool).tolist()], None


def _sc_routed(M, mesh_of):
    db = CU.make_session(3, CU.N_ROWS) if M is RC else _routed_port_session()
    if M is RC:
        db.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
    q = CU.param_query() if M is RC else _pcu().param_query()
    stmt = db.prepare(q, M.ROUTED.sharded(mesh_of(N_POS)))
    params = [{"cut": int(k % 6), "shift": 0.5} for k in range(8)]
    rs = stmt.execute_many(params)
    keys = [k for k in db.cost_router.measured if k[0] == "many"]
    return [_fig(rs), [len(k[4]) > 0 for k in keys], [k[5] for k in keys]], rs


SCENARIOS = {
    "serial8": _sc_serial8, "mixed": _sc_mixed, "small": _sc_small,
    "cache": _sc_cache, "fallback": _sc_fallback, "capacity": _sc_capacity,
    "ddl": _sc_ddl, "scheduler": _sc_scheduler, "ddl_sched": _sc_ddl_sched,
    "empty": _sc_empty, "fused_divisible": _sc_fused_divisible,
    "fused_mixed": _sc_fused_mixed, "fused_padded": _sc_fused_padded,
    "admission": _sc_admission,
    "routed": _sc_routed,
}


def _pcu():
    from test_torch_fused import PCU

    return PCU


def _routed_port_session():
    from test_torch_fused import _udf_session

    return _udf_session(3, CU.N_ROWS, _pcu())


def _admission_requests(seed=5):
    n = 4 * N_POS
    rng = np.random.default_rng(seed)
    return {
        "tier": rng.integers(0, 3, n),
        "prompt_len": rng.integers(10, 40000, n),
        "max_new_tokens": rng.integers(1, 9000, n),
        "temperature": rng.uniform(-1, 3, n).astype(np.float32),
    }


def figures(M, mesh_of) -> dict:
    """Every scenario's figures under package ``M`` (JSON-shaped)."""
    return {name: json.loads(json.dumps(fn(M, mesh_of)[0]))
            for name, fn in SCENARIOS.items()}


def reference_figures() -> dict:
    """:func:`figures` on ``repro``, meshes over the forced host devices."""
    import jax

    def mesh_of(n):
        return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))

    assert len(jax.devices()) == N_POS, jax.devices()
    return figures(RC, mesh_of)


@pytest.fixture(scope="module")
def ref_figures():
    code = ("import json, test_torch_sharded_many as T\n"
            "print('FIGURES ' + json.dumps(T.reference_figures()))\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={N_POS}",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("FIGURES "))
    return json.loads(line[len("FIGURES "):])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_figures_equal_the_reference(name, ref_figures):
    """The port on 4 CPU mesh positions and the reference on 4 forced host
    devices give the same sharded figures."""
    got = json.loads(json.dumps(SCENARIOS[name](PC, cpu_mesh)[0]))
    assert got == ref_figures[name]


def test_reference_figures_are_sharded(ref_figures):
    """The reference's run really sharded (4 devices, a sharded result)."""
    assert ref_figures["serial8"][0][0] == [2 * N_POS, 2 * N_POS, True, N_POS]
    assert ref_figures["admission"][0] == N_POS
    # the 2-ticket member's bucket padded from 2 up to the 4 positions
    assert ref_figures["fused_padded"][0][8] == [2, N_POS, True, N_POS]


# ---------------------------------------------------------------------------
# policy knobs
# ---------------------------------------------------------------------------


def test_shard_knobs_are_not_identity():
    mesh = cpu_mesh()
    pol = PC.FROID.sharded(mesh)
    assert pol == PC.FROID
    assert pol.fingerprint() == PC.FROID.fingerprint()
    assert pol.mesh is mesh and pol.shard_batches
    assert pol.shard_devices() == data_axis_size(mesh) == N_POS
    assert PC.FROID.shard_devices() == 1 and PC.FROID.shard_token() == ()
    # eager (no compiled plan) never shards, even with a mesh attached
    assert pol.eager().shard_devices() == 1


def test_shard_token_tracks_mesh_identity():
    pol = PC.FROID.sharded(cpu_mesh())
    axes, devices = pol.shard_token()
    assert axes == (("data", N_POS), ("model", 1))
    assert devices == (("cpu", None),) * N_POS
    # a rebuilt mesh over the same devices produces the same token
    assert PC.FROID.sharded(cpu_mesh()).shard_token() == pol.shard_token()
    # the same device named twice is another placement than four times
    assert PC.FROID.sharded(cpu_mesh(2)).shard_token() != pol.shard_token()
    # a 1-position mesh shards nothing
    assert PC.FROID.sharded(cpu_mesh(1)).shard_token() == ()


def test_prepare_sharded_and_unsharded_do_not_alias():
    db = _db(PC)
    s1 = db.prepare(_q(), PC.FROID)
    s2 = db.prepare(_q(), PC.FROID.sharded(cpu_mesh()))
    assert s1 is not s2
    assert s1.policy.mesh is None and s2.policy.mesh is not None
    assert db.prepare(_q(), PC.FROID.sharded(cpu_mesh())) is s2


# ---------------------------------------------------------------------------
# element-wise identity with the serial loop and the reference
# ---------------------------------------------------------------------------


def test_sharded_execute_many_matches_serial_loop():
    _, batched = _sc_serial8(PC, cpu_mesh)
    stmt = _db(PC).prepare(_q(), PC.FROID)
    _assert_same([stmt.execute(params=p) for p in PARAMS8], batched)
    _assert_same(_ref_rows(PARAMS8), batched, "sharded vs reference")
    st = batched[0].stats
    assert st["batched"] and st["batch_size"] == 2 * N_POS
    assert st["sharded"] and st["shard_devices"] == N_POS


def test_sharded_mixed_signatures_match_serial():
    _, batched = _sc_mixed(PC, cpu_mesh)
    stmt = _db(PC).prepare(_q(), PC.FROID.sharded(cpu_mesh()))
    _assert_same([stmt.execute(params=p) for p in MIXED], batched)
    _assert_same(_ref_rows(MIXED), batched, "sharded vs reference")


def test_sharded_empty_table_matches_serial():
    _, batched = _sc_empty(PC, cpu_mesh)
    params = [{"cutoff": int(k)} for k in range(N_POS)]
    db = _db(PC)
    _empty_t(PC, db)
    stmt = db.prepare(_q(), PC.FROID)
    _assert_same([stmt.execute(params=p) for p in params], batched)
    _assert_same(_ref_rows(params, setup=_empty_t), batched, "sharded vs reference")
    assert all(r.masked.num_rows == 0 for r in batched)
    assert batched[0].stats["sharded"]


def test_empty_aggregate_source_table_runs():
    """Aggregating over a zero-row table gives the UDF's NULL branch, on
    every shard."""
    db = PC.Session(device="cpu")
    db.create_table("detail", d_key=np.array([], np.int64),
                    d_val=np.array([], np.float32))
    db.create_table("T", a=np.arange(4))
    u = PC.UdfBuilder("key_total", [("k", "int32")], "float32")
    u.declare("s", "float32")
    u.select({"s": PC.sum_(PC.col("d_val"))}, frm=PC.scan("detail"),
             where=PC.col("d_key") == PC.param("k"))
    with u.if_(PC.var("s").is_null()):
        u.return_(PC.lit(0.0))
    u.return_(PC.var("s"))
    db.create_function(u.build())
    stmt = db.prepare(_q(), PC.FROID.sharded(cpu_mesh()))
    rs = stmt.execute_many([{"cutoff": 3}] * N_POS)
    assert rs[0].stats["sharded"]
    _assert_same([stmt.execute(params={"cutoff": 3})] * N_POS, rs)
    m = rs[0].masked.mask.numpy()
    np.testing.assert_array_equal(rs[0].masked.table.columns["v"].data.numpy()[m], 0.0)


# ---------------------------------------------------------------------------
# divisibility gating + cache tier
# ---------------------------------------------------------------------------


def test_small_bucket_runs_replicated():
    """A bucket the data axes don't divide (bucket 1 < positions) runs on
    the replicated single-device path, never padded to the mesh."""
    (figs, misses), rs = _sc_small(PC, cpu_mesh)
    assert "sharded" not in rs[0].stats
    assert misses == 0
    assert pick_data_axes(cpu_mesh(), 1) is None
    _assert_same(_ref_rows([{"cutoff": 7}]), rs, "replicated vs reference")


def test_shard_cache_tier_hits():
    (f1, c1, f2, c2, batch_misses), rs = _sc_cache(PC, cpu_mesh)
    assert f1[0][2] and c1 == [False, 0, 1]
    assert c2 == [True, 1, 1]
    # the sharded tier is separate from the single-device batch tier
    assert batch_misses >= 1
    params = [{"cutoff": int(k)} for k in range(N_POS)]
    params += [{"cutoff": int(k) + 9} for k in range(N_POS)]
    stmt = _db(PC).prepare(_q(), PC.FROID)
    _assert_same([stmt.execute(params=p) for p in params], rs)


def test_replicated_fallback_respects_max_batch():
    """``tests/test_sharded_many.py``'s case on 6 positions: bucket 8 does
    not split over 6, so the call falls back to the replicated path
    re-chunked at the per-device bound."""
    db = _db(PC)
    stmt = db.prepare(_q(), PC.FROID.sharded(cpu_mesh(6)).batched(max_batch=2))
    plist = [{"cutoff": int(k)} for k in range(5)]
    rs = stmt.execute_many(plist)
    assert all("sharded" not in r.stats for r in rs)
    assert all(r.stats["batch_bucket"] <= 2 for r in rs)
    assert [r.stats["batch_size"] for r in rs] == [2, 2, 2, 2, 1]
    _assert_same([stmt.execute(params=p) for p in plist], rs)
    _, rs3 = _sc_fallback(PC, cpu_mesh)
    _assert_same(_ref_rows([{"cutoff": int(k)} for k in range(4)]), rs3,
                 "fallback vs reference")


def test_mesh_capacity_chunking():
    """``max_batch`` bounds the per-device batch: a mesh of D positions
    takes max_batch × D parameter sets in one sharded dispatch."""
    _, rs = _sc_capacity(PC, cpu_mesh)
    sizes = [r.stats["batch_size"] for r in rs]
    assert sizes[: 2 * N_POS] == [2 * N_POS] * (2 * N_POS)
    assert sizes[2 * N_POS:] == [2, 2]
    assert rs[0].stats["sharded"]
    assert rs[-1].stats["batch_bucket"] == 2
    params = [{"cutoff": int(k % 50)} for k in range(2 * N_POS + 2)]
    stmt = _db(PC).prepare(_q(), PC.FROID)
    _assert_same([stmt.execute(params=p) for p in params], rs)


# ---------------------------------------------------------------------------
# invalidation
# ---------------------------------------------------------------------------


def test_ddl_invalidates_sharded_executables():
    db = _db(PC)
    stmt = db.prepare(_q(), PC.FROID.sharded(cpu_mesh()))
    params = [{"cutoff": int(k)} for k in range(N_POS)]
    r1 = stmt.execute_many(params)
    assert stmt.execute_many(params)[0].cache_hit
    _new_detail(db, 42)
    r2 = stmt.execute_many(params)
    assert not r2[0].cache_hit and r2[0].stats["sharded"]
    _assert_same([stmt.execute(params=p) for p in params], r2)
    # new data actually flowed through (same T, same mask; fresh detail)
    m = r2[-1].masked.mask.numpy()
    a1 = r1[-1].masked.table.columns["v"].data.numpy()[m]
    a2 = r2[-1].masked.table.columns["v"].data.numpy()[m]
    assert not np.allclose(a1, a2)


# ---------------------------------------------------------------------------
# scheduler + serving integration
# ---------------------------------------------------------------------------


def test_scheduler_flushes_mesh_sized_buckets():
    """Flush-on-full for a sharded statement waits for max_batch × devices
    requests."""
    (pending, after, full, figs), rs = _sc_scheduler(PC, cpu_mesh)
    assert pending == 2 * N_POS - 1
    assert after == 0 and full == 1
    assert rs[0].stats["sharded"]
    assert rs[0].stats["batch_size"] == 2 * N_POS
    params = [{"cutoff": int(k % 50)} for k in range(2 * N_POS - 1)] + [{"cutoff": 1}]
    stmt = _db(PC).prepare(_q(), PC.FROID)
    _assert_same([stmt.execute(params=p) for p in params], rs)


def test_ddl_between_submit_and_drain_not_stale_sharded():
    (hit, figs, misses), rs = _sc_ddl_sched(PC, cpu_mesh)
    assert not hit  # re-specialized, not stale
    db = _db(PC)
    _new_detail(db, 7)
    stmt = db.prepare(_q(), PC.FROID)
    _assert_same([stmt.execute(params={"cutoff": int(k)}) for k in range(N_POS)], rs)


def test_admission_sharded_matches_tick_path():
    from repro.serve.admission import AdmissionPolicy as RefAdmission
    from repro_torch.serve.admission import AdmissionPolicy

    reqs = _admission_requests()
    ap = AdmissionPolicy(device="cpu", froid=True, mesh=cpu_mesh())
    tick = ap.evaluate(reqs)
    co = ap.evaluate_coalesced(reqs)
    np.testing.assert_array_equal(tick["admit"], co["admit"])
    np.testing.assert_array_equal(tick["granted"], co["granted"])
    np.testing.assert_allclose(tick["temp"], co["temp"], rtol=1e-6)
    assert ap.request_statement().policy.shard_devices() == N_POS
    want = RefAdmission(froid=True).evaluate(reqs)
    np.testing.assert_array_equal(co["admit"], want["admit"])
    np.testing.assert_array_equal(co["granted"], want["granted"])
    np.testing.assert_allclose(co["temp"], want["temp"], rtol=1e-6)


def test_admission_sharded_tickets_ran_sharded():
    """The coalesced admission batch really split over the mesh."""
    from repro_torch.serve.admission import AdmissionPolicy

    ap = AdmissionPolicy(device="cpu", froid=True, mesh=cpu_mesh())
    tickets = [ap.submit(tier=1, prompt_len=100 + i, max_new_tokens=64,
                         temperature=0.5, depth=N_POS) for i in range(N_POS)]
    ap.scheduler.flush()
    st = tickets[0].result().stats
    assert st["sharded"] and st["shard_devices"] == N_POS


def test_serve_engine_accepts_admission_mesh():
    """ServeEngine wires admission_mesh through to the sharded per-request
    admission statement."""
    from repro_torch.serve.engine import ServeEngine

    class _NoModel:
        device = torch.device("cpu")

        def decode_step(self, cache, tok):  # pragma: no cover
            raise AssertionError("decode never reached in this test")

    eng = ServeEngine(_NoModel(), admission_mesh=cpu_mesh())
    assert eng.admission.mesh is not None
    assert eng.admission.request_statement().policy.shard_devices() == N_POS
