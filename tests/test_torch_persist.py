"""The port's persistent plan tier (``repro_torch.persist``,
``Session(store=...)``) on the CPU, against the reference's.

Ports every case of ``tests/test_persist.py`` to the port's store and
``Session(device="cpu")``: the entry format, atomic writes, typed
corruption and version errors, LRU eviction, key stability, the session's
hit/miss/reject ladder, the policy opt-out, fused template waves and
``execute_many`` from a fresh session, and the cost tables.  Then:

* the port's content env token, persist keys and entry file names equal
  the reference's for the same data, UDF and statements (the reference's
  values come from calling the reference);
* over the same scripts, the port's ``persist_*`` counters and
  ``persist_stats["saves"]`` equal the reference's;
* a directory written by either package is read by the other with
  rejects only, no warning, and rows equal to the writer's;
* ``codec.load_plan``: fresh ``node_id``s, no ``_session_stamp``, and an
  equal ``explain()`` for the six TPC-H UDF plans at SF 0.001; a fused
  wave over two sessions that loaded it in one process equals the serial
  loop;
* the compile fault seam on a store hit: it fires in the exec tier and not
  in the fused tier, with the reference's injector events.

Rows are held with ``conformance_util.assert_rows_equal`` (masks and
validity exactly, floats rtol 2e-3) and against the reference with
``assert_masked`` (floats rtol 1e-4).  Every port run is under
``no_vmap_fallback``.
"""
from __future__ import annotations

import glob
import json
import os
import re
import threading
import warnings

import numpy as np
import pytest

import conformance_util as CU
import repro.core as RC
import repro_torch.core as PC
from repro.persist import PlanStore as RefPlanStore
from repro.resilience import FaultInjector as RefFaultInjector
from repro.resilience import FaultSpec as RefFaultSpec
from repro_torch.core import optimizer as O
from repro_torch.core import relalg as PR
from repro_torch.core.fingerprint import plan_fingerprint
from repro_torch.core.session import param_signature
from repro_torch.data.tpch import generate_tpch
from repro_torch.data.tpch_udfs import QUERIES, register_udfs
from repro_torch.persist import (
    PERSIST_SCHEMA_VERSION,
    PlanCacheCorruptError,
    PlanCacheVersionError,
    PlanCacheWarning,
    PlanStore,
    assert_stable_key,
    codec,
    key_digest,
    parse_key,
    runtime_stamp,
)
from repro_torch.persist.costs import costs_key
from repro_torch.resilience import FaultInjector, FaultSpec
from repro_torch.serve.scheduler import CoalescingScheduler

from test_torch_correlated import assert_masked, no_vmap_fallback
from test_torch_fused import PCU
from test_torch_interpreter import PROGRAMS, _program_udf

PARAMS = {"cut": 5, "shift": 0.5}
CPU_STAMP = runtime_stamp("cpu")
TPCH_QUERIES = ("Q1", "Q3", "Q5", "Q6", "Q12", "Q14")


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


def _session(path, seed=7, n_rows=23, store=True):
    """``tests/test_persist.py::_session`` on the port."""
    s = PC.Session(device="cpu", store=str(path) if store else None)
    PCU.populate_session(s, seed, n_rows)
    s.create_function(_program_udf(PC, PROGRAMS["uncorrelated_sum_case"](PC)))
    return s


def _ref_session(path, seed=7, n_rows=23, store=True):
    s = RC.Session(store=str(path) if store else None)
    CU.populate_session(s, seed, n_rows)
    s.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
    return s


def _entries(path) -> list[str]:
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(str(path), "*.plan")))


# ---------------------------------------------------------------------------
# store unit tests: entry format, atomicity, typed degradation
# ---------------------------------------------------------------------------


def test_store_put_get_roundtrip(tmp_path):
    st = PlanStore(str(tmp_path), device="cpu")
    key = ("plan", "exec", ("fp",), (True, "python"), (), 0)
    st.put(key, {"kind": "exec"}, b"payload-bytes")
    got = st.get(key)
    assert got is not None
    meta, blob = got
    assert meta["kind"] == "exec" and blob == b"payload-bytes"
    assert st.get(("plan", "other")) is None  # clean miss
    assert st.stats()["entries"] == 1


def test_store_corrupt_entry_raises_typed(tmp_path):
    st = PlanStore(str(tmp_path), device="cpu")
    key = ("k", 1)
    st.put(key, {}, b"x" * 64)
    path = st.path_for(key)
    # truncation at several depths: magic, header length, header, blob
    for size in (3, 10, 12, 70):
        with open(path, "r+b") as f:
            f.truncate(size)
        with pytest.raises(PlanCacheCorruptError):
            st.get(key)
        st.put(key, {}, b"x" * 64)  # restore for next depth
    # flipped payload byte: digest mismatch
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:-1] + bytes([raw[-1] ^ 0xFF]))
    with pytest.raises(PlanCacheCorruptError):
        st.get(key)


def test_store_version_stamp_mismatch(tmp_path):
    st = PlanStore(str(tmp_path), device="cpu")
    st.put(("k",), {}, b"blob")
    stale = PlanStore(str(tmp_path), stamp={**CPU_STAMP, "torch": "0.0.0"})
    with pytest.raises(PlanCacheVersionError):
        stale.get(("k",))
    # same-stamp reader still loads
    assert PlanStore(str(tmp_path), device="cpu").get(("k",)) is not None


def test_store_concurrent_writers_atomic(tmp_path):
    """N threads racing puts on one key: readers always see a complete
    entry (one writer's whole blob, never a torn mix)."""
    st = PlanStore(str(tmp_path), device="cpu")
    key = ("contended",)
    payloads = [bytes([i]) * 4096 for i in range(8)]
    errs = []

    def write(i):
        try:
            for _ in range(20):
                st.put(key, {"w": i}, payloads[i])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for _ in range(50):
        got = st.get(key)
        if got is not None:
            meta, blob = got
            assert blob == payloads[meta["w"]]
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    meta, blob = st.get(key)
    assert blob == payloads[meta["w"]]
    # no leaked tempfiles
    assert not [p for p in os.listdir(tmp_path) if p.startswith("tmp")]


def test_store_rejects_unstable_keys(tmp_path):
    st = PlanStore(str(tmp_path), device="cpu")

    class Opaque:
        pass

    for bad in ((Opaque(),), (("x", [1, 2]),), ({"a": 1},)):
        with pytest.raises(TypeError):
            st.put(bad, {}, b"")


# ---------------------------------------------------------------------------
# eviction: byte budget, LRU-by-recency, degradation-to-miss only
# ---------------------------------------------------------------------------


def test_store_eviction_lru_by_mtime(tmp_path):
    st = PlanStore(str(tmp_path), device="cpu")  # unbudgeted writer: fill freely
    for i in range(10):
        p = st.put((f"k{i}",), {}, b"x" * 1024)
        os.utime(p, (1000 + i, 1000 + i))  # deterministic recency order
    full = st.nbytes()
    budgeted = PlanStore(str(tmp_path), max_bytes=full // 2, device="cpu")
    n = budgeted.sweep()
    assert n >= 1
    assert budgeted.nbytes() <= budgeted.max_bytes
    # oldest-recency entries went first; the newest survived
    assert budgeted.get(("k0",)) is None
    assert budgeted.get(("k9",)) is not None
    s = budgeted.stats()
    assert s["evictions"] == n and s["sweeps"] == 1
    assert s["evicted_bytes"] >= n * 1024
    assert s["max_bytes"] == full // 2


def test_store_get_refreshes_recency(tmp_path):
    """A read protects an entry: the LRU victim is the *unread* old entry,
    not the oldest-written one."""
    st = PlanStore(str(tmp_path), device="cpu")
    for i in range(4):
        p = st.put((f"k{i}",), {}, b"x" * 1024)
        os.utime(p, (1000 + i, 1000 + i))
    assert st.get(("k0",)) is not None  # touch: k0 becomes most recent
    budgeted = PlanStore(str(tmp_path), max_bytes=st.nbytes() - 1024, device="cpu")
    assert budgeted.sweep() == 1
    assert budgeted.get(("k0",)) is not None  # read-protected
    assert budgeted.get(("k1",)) is None  # the true LRU victim


def test_store_put_sweeps_back_under_budget(tmp_path):
    st = PlanStore(str(tmp_path), max_bytes=4096, device="cpu")
    for i in range(12):
        p = st.put((f"k{i}",), {}, b"y" * 1024)
        os.utime(p, (1000 + i, 1000 + i))
    assert st.nbytes() <= 4096
    assert st.get((f"k{11}",)) is not None  # a put never evicts itself
    assert st.eviction_stats["evictions"] >= 1


def test_session_budgeted_store_stays_correct(tmp_path):
    """A budget tight enough to churn on every save still answers every
    query identically to a store-less session — eviction degrades to a
    rebuild, never to a wrong result — and the directory stays bounded."""
    oracle = _session(tmp_path / "none", store=False)
    q = PCU.param_query()

    small = PlanStore(str(tmp_path / "s"), max_bytes=512, device="cpu")  # every entry over
    s = PC.Session(device="cpu", store=small)
    PCU.populate_session(s, 7, 23)
    s.create_function(_program_udf(PC, PROGRAMS["uncorrelated_sum_case"](PC)))
    # distinct parameter signatures (int vs float cut) force distinct
    # store entries, so each save churns the one before it out
    for cut in (3, 5.5, 5):
        params = {"cut": cut, "shift": 0.5}
        got = s.execute(q, PC.FROID, params=params)
        CU.assert_rows_equal(oracle.execute(q, PC.FROID, params=params), got,
                             f"budgeted-store vs oracle (cut={cut})")
    assert len(small.entries()) <= 1
    ps = s.persist_stats
    assert ps["store"]["evictions"] >= 1
    assert ps["store"]["max_bytes"] == 512


# ---------------------------------------------------------------------------
# key stability: repr round-trip, cross-process determinism
# ---------------------------------------------------------------------------


def test_stable_key_scalars_and_nesting():
    key = ("plan", 1, 2.5, True, None, b"b", ("nested", ("deeper", 0)))
    assert_stable_key(key)
    assert parse_key(repr(key)) == key


def test_stable_key_rejects_process_local():
    with pytest.raises(TypeError):
        assert_stable_key((object(),))
    with pytest.raises(TypeError):
        assert_stable_key(("ok", ["lists", "are", "mutable"]))
    with pytest.raises(TypeError):
        assert_stable_key(({"dicts": "too"},))


def test_stable_key_rejects_id_shaped_slot_names():
    from repro_torch.fuse.merge import slot_param

    with pytest.raises(TypeError):
        assert_stable_key("__cse_slot_140235678901234")
    with pytest.raises(TypeError):
        assert_stable_key(("fused", ("__cse_slot_7", "f32")))
    assert_stable_key(slot_param(0))  # canonical: ordinal-spelled
    assert_stable_key(("fused", (slot_param(3), "f32")))


def test_persist_keys_identical_across_sessions(tmp_path):
    """Two independently-built same-content sessions produce identical
    persist identity, and the second session's first execute hits the
    first's entry."""
    tokens = []
    for _ in range(2):
        s = _session(tmp_path, store=False)
        tok = s._content_env_token()
        assert_stable_key(tok)
        assert parse_key(repr(tok)) == tok
        tokens.append(tok)
    assert tokens[0] == tokens[1]
    a = _session(tmp_path)
    a.execute(PCU.param_query(), PC.FROID, params=PARAMS)
    b = _session(tmp_path)
    b.execute(PCU.param_query(), PC.FROID, params=PARAMS)
    assert b.cache_stats["persist_hits"] >= 1
    assert b.cache_stats["persist_misses"] == 0


def test_content_env_token_tracks_data(tmp_path):
    s = _session(tmp_path, store=False)
    t0 = s._content_env_token()
    assert s._content_env_token() == t0  # memoized + stable
    s.create_table("facts", fk=np.arange(4), val=np.ones(4, np.float32),
                   qty=np.arange(4))
    t1 = s._content_env_token()
    assert t1 != t0  # data changed -> token changed
    assert_stable_key(t1)


# ---------------------------------------------------------------------------
# session integration: hit/miss/invalidate, degradation parity
# ---------------------------------------------------------------------------


def test_session_cold_then_warm(tmp_path):
    cold = _session(tmp_path)
    q = PCU.param_query()
    expected = cold.execute(q, PC.FROID, params=PARAMS)
    assert cold.cache_stats["persist_misses"] >= 1
    assert cold.persist_stats["saves"] >= 1

    warm = _session(tmp_path)
    got = warm.execute(q, PC.FROID, params=PARAMS)
    CU.assert_rows_equal(expected, got, "warm vs cold")
    assert warm.cache_stats["persist_hits"] >= 1
    assert warm.cache_stats["persist_misses"] == 0


def test_session_invalidate_by_content(tmp_path):
    cold = _session(tmp_path, seed=7)
    cold.execute(PCU.param_query(), PC.FROID, params=PARAMS)

    other = _session(tmp_path, seed=8)  # different data, same store
    other.execute(PCU.param_query(), PC.FROID, params=PARAMS)
    assert other.cache_stats["persist_hits"] == 0
    assert other.cache_stats["persist_misses"] >= 1


def test_session_corrupt_entry_recompiles_with_warning(tmp_path):
    cold = _session(tmp_path)
    q = PCU.param_query()
    expected = cold.execute(q, PC.FROID, params=PARAMS)
    for p in glob.glob(os.path.join(str(tmp_path), "*.plan")):
        with open(p, "r+b") as f:
            f.truncate(16)
    warm = _session(tmp_path)
    with pytest.warns(PlanCacheWarning):
        got = warm.execute(q, PC.FROID, params=PARAMS)
    CU.assert_rows_equal(expected, got, "corrupt-store vs oracle")
    assert warm.cache_stats["persist_rejects"] >= 1
    assert warm.cache_stats["persist_hits"] == 0
    assert warm.persist_stats["saves"] >= 1  # evicted + re-saved behind
    # so a third session warm-starts from the repaired entry
    third = _session(tmp_path)
    third.execute(q, PC.FROID, params=PARAMS)
    assert third.cache_stats["persist_hits"] >= 1


def test_session_stale_stamp_recompiles_silently(tmp_path):
    cold = _session(tmp_path)
    q = PCU.param_query()
    expected = cold.execute(q, PC.FROID, params=PARAMS)
    stale = PC.Session(device="cpu", store=PlanStore(
        str(tmp_path), stamp={**CPU_STAMP, "schema": -1}))
    PCU.populate_session(stale, 7, 23)
    stale.create_function(_program_udf(PC, PROGRAMS["uncorrelated_sum_case"](PC)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # version skew must NOT warn
        got = stale.execute(q, PC.FROID, params=PARAMS)
    CU.assert_rows_equal(expected, got, "stale-stamp vs oracle")
    assert stale.cache_stats["persist_rejects"] >= 1


def test_policy_opt_out(tmp_path):
    s = _session(tmp_path)
    s.execute(PCU.param_query(), PC.FROID.persisted(False), params=PARAMS)
    assert s.cache_stats["persist_misses"] == 0
    assert s.persist_stats["saves"] == 0
    # identity unchanged: opted-out and opted-in policies share caches
    assert PC.FROID.persisted(False).fingerprint() == PC.FROID.fingerprint()


def _template_session(M, path):
    """``tests/test_persist.py::_template_session`` with either package."""
    s = M.Session(device="cpu", store=str(path)) if M is PC else M.Session(store=str(path))
    rng = np.random.default_rng(0)
    s.create_table("detail", d_key=rng.integers(0, 40, 200),
                   d_val=rng.uniform(0, 100, 200).astype(np.float32))
    s.create_table("T", a=rng.integers(0, 40, 30))
    return s


def _template_calls(M, s):
    """Two distinct statements riding one parameter-unified aggregate
    subquery, three distinct bindings."""

    def q(pname, out):
        agg = (M.scan("detail").filter(M.col("d_val") > M.param(pname))
               .agg(s=M.sum_(M.col("d_val"))))
        return (M.scan("T")
                .compute(**{out: M.scalar_subquery(agg.node, "s") + M.col("a") * 0.0})
                .project("a", out))

    s1 = s.prepare(q("x", "v1"), M.FROID)
    s2 = s.prepare(q("y", "v2"), M.FROID)
    return [(s1, {"x": 10.0}), (s2, {"y": 10.0}), (s1, {"x": 20.0}), (s2, {"y": 30.0})]


def test_fused_template_wave_roundtrips_fresh_session(tmp_path):
    """A fused wave carrying pooled templates persists, and a FRESH session
    serves the identical wave from the store, its stats as the cold
    wave's and nothing rebuilt."""
    cold = _template_session(PC, tmp_path)
    expected = cold.execute_fused(_template_calls(PC, cold))
    st = expected[0].stats
    assert st["fused"] and st["cse_template_groups"] >= 1
    assert st["cse_bindings"] == 3
    assert cold.persist_stats["saves"] >= 1

    warm = _template_session(PC, tmp_path)
    got = warm.execute_fused(_template_calls(PC, warm))
    gst = got[0].stats
    assert gst["fused"] and gst["cse_template_groups"] >= 1
    assert warm.cache_stats["persist_hits"] >= 1
    assert warm.persist_stats["saves"] == 0  # nothing rebuilt
    for i, (e, g) in enumerate(zip(expected, got)):
        CU.assert_rows_equal(e, g, f"fused template warm[{i}]")
        for k in ("cse_pool_evals", "cse_bindings", "shared_subtrees", "cse_templates"):
            assert g.stats.get(k) == e.stats.get(k), (i, k)


def test_execute_many_warm_start(tmp_path):
    cold = _session(tmp_path)
    stmt = cold.prepare(PCU.param_query(), PC.FROID)
    plist = [{"cut": c, "shift": 0.5} for c in (3, 5, 6)]
    expected = stmt.execute_many(plist)

    warm = _session(tmp_path)
    got = warm.prepare(PCU.param_query(), PC.FROID).execute_many(plist)
    for i, (e, g) in enumerate(zip(expected, got)):
        CU.assert_rows_equal(e, g, f"warm many[{i}]")
    assert warm.cache_stats["persist_hits"] >= 1


# ---------------------------------------------------------------------------
# cost-table persistence
# ---------------------------------------------------------------------------


def _route_waves(s, waves=2):
    stmts = [s.prepare(q, PC.ROUTED) for q in PCU.fusion_queries()]
    sched = CoalescingScheduler(max_batch=256, window_s=10.0, clock=lambda: 0.0, fuse=True)
    for _ in range(waves):
        ts = [sched.submit(stmts[i], p) for i, p in PCU.fusion_calls_spec()]
        sched.flush()
        [t.result() for t in ts]


def test_cost_tables_roundtrip(tmp_path):
    s1 = _session(tmp_path)
    _route_waves(s1)
    assert s1.cost_stats["samples"] >= 1
    assert s1.save_costs()
    assert s1.persist_stats["costs_saved"] == 1

    s2 = _session(tmp_path)
    s2._ensure_router()
    assert s2.persist_stats["costs_loaded"] >= 1
    # measured tables arrived without any execution on s2
    state = s2.cost_router.export_state()
    assert state["measured"]
    assert state == s1.cost_router.export_state()
    for key_repr, *_ in state["measured"]:
        assert parse_key(key_repr)  # strict round-trip on every row


def test_cost_tables_corrupt_degrades_to_empty(tmp_path):
    s1 = _session(tmp_path)
    _route_waves(s1)
    assert s1.save_costs()
    path = s1.store.path_for(costs_key(s1._content_env_token()))
    raw = open(path, "rb").read()
    with open(path, "wb") as f:  # valid envelope, garbage JSON payload
        f.write(raw[: len(raw) // 2])
    s2 = _session(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PlanCacheWarning)
        s2._ensure_router()
    assert s2.persist_stats["costs_loaded"] == 0
    assert s2.persist_stats["rejects"] >= 1
    # routing still works from scratch
    _route_waves(s2, waves=1)
    assert s2.cost_stats["samples"] >= 1


def test_persist_stats_shape(tmp_path):
    s = _session(tmp_path)
    ps = s.persist_stats
    assert ps["enabled"] and "store" in ps
    assert {"hits", "misses", "rejects", "saves"} <= ps.keys()
    assert PC.Session(device="cpu").persist_stats == {"enabled": False}


def test_schema_version_is_stamped(tmp_path):
    s = _session(tmp_path)
    s.execute(PCU.param_query(), PC.FROID, params=PARAMS)
    entry = glob.glob(os.path.join(str(tmp_path), "*.plan"))[0]
    raw = open(entry, "rb").read()
    hdr = json.loads(raw[12:12 + int.from_bytes(raw[8:12], "little")])
    assert hdr["stamp"]["schema"] == PERSIST_SCHEMA_VERSION
    assert hdr["stamp"] == CPU_STAMP
    assert set(hdr["stamp"]) == {"schema", "torch", "cuda", "platform", "devices"}
    assert hdr["stamp"]["platform"] == "cpu" and hdr["stamp"]["devices"] == 0


# ---------------------------------------------------------------------------
# the port against the reference: keys, counters, each other's directories
# ---------------------------------------------------------------------------


def test_runtime_stamp_is_stable_and_device_bound(monkeypatch):
    assert runtime_stamp("cpu") == runtime_stamp("cpu")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime_stamp()
    with pytest.raises(RuntimeError, match="CUDA"):
        PC.Session(store="plans")


def test_keys_equal_the_reference(tmp_path):
    """The content env token, each tier's persist key and its file name are
    the reference's for the same data, UDF and statement."""
    port, ref = _session(tmp_path, store=False), _ref_session(tmp_path, store=False)
    assert port._content_env_token() == ref._content_env_token()
    q, rq = PCU.param_query(), CU.param_query()
    fp = plan_fingerprint(q.node)
    from repro.core.fingerprint import plan_fingerprint as ref_fp
    from repro.core.session import param_signature as ref_sig
    from repro.persist import key_digest as ref_key_digest

    assert fp == ref_fp(rq.node)
    sig = param_signature(PARAMS)
    assert sig == ref_sig(PARAMS)
    for kind, kw in (("exec", {"sig": sig}), ("batch", {"sig": sig, "bucket": 8}),
                     ("fused", {"template": ((fp, sig, 3),)})):
        pk = port._persist_key(kind, fp, PC.FROID, **kw)
        rk = ref._persist_key(kind, fp, RC.FROID, **kw)
        assert pk == rk, kind
        assert key_digest(pk) == ref_key_digest(rk)
    assert costs_key(port._content_env_token()) == costs_key(ref._content_env_token())


def _script(M, s):
    """One script for either package's session: ``_template_session``'s
    tables, a serial execute twice, an ``execute_many`` over two
    signatures, and ``_template_calls``' fused wave."""
    cu = PCU if M is PC else CU
    rng = np.random.default_rng(0)
    s.create_table("detail", d_key=rng.integers(0, 40, 200),
                   d_val=rng.uniform(0, 100, 200).astype(np.float32))
    s.create_table("T", a=rng.integers(0, 40, 30))
    q = cu.param_query()
    out = [s.execute(q, M.FROID, params=PARAMS), s.execute(q, M.FROID, params=PARAMS)]
    out += s.prepare(q, M.FROID).execute_many(
        [{"cut": c, "shift": 0.5} for c in (3, 5, 6, 5.5)])
    out += s.execute_fused(_template_calls(M, s))
    return out


_COUNTERS = ("persist_hits", "persist_misses", "persist_rejects")


def _counts(s):
    return ({k: s.cache_stats[k] for k in _COUNTERS}, s.persist_stats["saves"],
            s.persist_stats["save_errors"])


def test_counters_and_entries_equal_the_reference(tmp_path):
    """The same script, cold then warm, in both packages: equal counters,
    saves and entry file names; rows equal the reference's."""
    pdir, rdir = tmp_path / "port", tmp_path / "ref"
    for phase in ("cold", "warm"):
        port, ref = _session(pdir), _ref_session(rdir)
        got, want = _script(PC, port), _script(RC, ref)
        assert _counts(port) == _counts(ref), phase
        assert _entries(pdir) == _entries(rdir), phase
        for i, (w, g) in enumerate(zip(want, got)):
            assert_masked(w.masked, g.masked, f"{phase}[{i}]")
    assert port.persist_stats["save_errors"] == 0
    assert port.cache_stats["persist_misses"] == 0 and port.persist_stats["saves"] == 0


def test_each_package_rejects_the_others_entries(tmp_path):
    """A directory written by the reference, read by the port: every lookup
    rejects (the stamp), nothing warns, rows are the reference's, and the
    port writes its own entries over them; then the reference reads the
    port's the same way."""
    ref = _ref_session(tmp_path)
    want = _script(RC, ref)
    written = _entries(tmp_path)
    port = _session(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _script(PC, port)
    assert port.cache_stats["persist_hits"] == 0
    assert port.cache_stats["persist_misses"] == 0
    assert port.cache_stats["persist_rejects"] == len(written)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_masked(w.masked, g.masked, f"port over the reference's[{i}]")
    assert _entries(tmp_path) == written  # same keys: rewritten in place
    ref2 = _ref_session(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = _script(RC, ref2)
    assert ref2.cache_stats["persist_hits"] == 0
    assert ref2.cache_stats["persist_rejects"] == len(written)
    for i, (w, g) in enumerate(zip(again, got)):
        assert_masked(w.masked, g.masked, f"reference over the port's[{i}]")
    # a reference store object refuses the port's stamp, and the reverse
    key = ("k",)
    PlanStore(str(tmp_path / "x"), device="cpu").put(key, {}, b"b")
    with pytest.raises(Exception, match="stamp"):
        RefPlanStore(str(tmp_path / "x")).get(key)


def test_fused_key_holds_no_session_stamp(tmp_path):
    """The fusion oracle's queue runs one statement under two signatures, so
    a whole member plan is a template occurrence and its fingerprint is
    part of the wave's key.  The session stamps that plan before the merge
    (``_merged_for``); the reference's fingerprint reads the stamp, so a
    fresh session misses its own fused entry.  The port's leaves the stamp
    out, as it leaves ``node_id`` out: a fresh session hits.  Rows are the
    reference's either way."""
    for M, mk, path in ((PC, _session, tmp_path / "port"), (RC, _ref_session, tmp_path / "ref")):
        cu = PCU if M is PC else CU
        for phase in ("cold", "warm"):
            s = mk(path)
            stmts = [s.prepare(q, M.FROID) for q in cu.fusion_queries()]
            rs = s.execute_fused([(stmts[i], p) for i, p in cu.fusion_calls_spec()])
            assert any(r.stats.get("fused") for r in rs)
        misses = s.cache_stats["persist_misses"]
        assert misses == (0 if M is PC else 1), (M.__name__, misses)


# ---------------------------------------------------------------------------
# codec: the loaded plan
# ---------------------------------------------------------------------------


def _tpch_session(path=None):
    s = PC.Session(device="cpu", store=str(path) if path is not None else None)
    generate_tpch(s, sf=0.001)
    register_udfs(s)
    return s


def _address_free(text: str) -> str:
    return re.sub(r" object at 0x[0-9a-f]+", "", text)


def test_load_plan_fresh_ids_no_stamps():
    """The six TPC-H UDF plans at SF 0.001: a pickle round trip (after the
    plan has been stamped, as a fused wave or an eager run stamps it) gives
    fresh node ids in the writer's order, no ``_session_stamp`` anywhere,
    and an equal ``explain()``."""
    from repro_torch.core.session import _stamp

    s = _tpch_session()
    for name in TPCH_QUERIES:
        plan = s.prepare(QUERIES[name][0](), PC.FROID).plan
        _stamp(plan)
        for u in s.registry.values():
            _stamp(u)
        before = list(PR.walk_plan_deep(plan))
        blob = codec.pack_plan(plan)
        assert 0 < len(blob) < 64_000, (name, len(blob))
        loaded = codec.load_plan(blob)
        after = list(PR.walk_plan_deep(loaded))
        assert len(after) == len(before)
        old = {n.node_id for n in before}
        new = [n.node_id for n in after]
        assert not old & set(new), name
        order = sorted(range(len(before)), key=lambda i: before[i].node_id)
        assert [new[i] for i in order] == sorted(new), name
        stamped = [o for o in codec._objects(loaded) if "_session_stamp" in vars(o)]
        assert not stamped, (name, stamped[:3])
        assert _address_free(O.explain(loaded)) == _address_free(O.explain(plan)), name


def test_tpch_store_hits_equal_cold_rows(tmp_path):
    """Session B over the same SF-0.001 data is served from A's entries:
    every first execute a hit, rows equal A's (relagg's plain version on in
    Q5 and Q12)."""
    a, b = _tpch_session(tmp_path), _tpch_session(tmp_path)
    pol = PC.ExecutionPolicy(name="froid+relagg", pallas_agg=True)
    for name in TPCH_QUERIES:
        q = QUERIES[name][0]()
        ra = a.execute(q, pol)
        hits = b.cache_stats["persist_hits"]
        rb = b.execute(q, pol)
        assert b.cache_stats["persist_hits"] == hits + 1, name
        CU.assert_rows_equal(ra, rb, name, rtol=0, atol=0)
        assert rb.explain == ra.explain
    assert a.persist_stats["saves"] == len(TPCH_QUERIES)
    assert b.persist_stats["saves"] == 0 and b.cache_stats["persist_misses"] == 0


def test_fused_wave_over_two_loaded_sessions(tmp_path, monkeypatch):
    """Two fresh sessions in one process both load the fusion oracle's
    fused wave from the store; each wave equals the serial loop, and the
    plans each loaded share no node id with the session's own plans or
    with the other session's."""
    loaded = []
    load_plan = codec.load_plan

    def recording(blob):
        out = load_plan(blob)
        loaded.append(out)
        return out

    monkeypatch.setattr(codec, "load_plan", recording)
    cold = _session(tmp_path)
    stmts = [cold.prepare(q, PC.FROID) for q in PCU.fusion_queries()]
    cold.execute_fused([(stmts[i], p) for i, p in PCU.fusion_calls_spec()])
    assert cold.persist_stats["saves"] >= 1 and not loaded
    ids = []
    for w in range(2):
        s = _session(tmp_path)
        stmts = [s.prepare(q, PC.FROID) for q in PCU.fusion_queries()]
        calls = [(stmts[i], p) for i, p in PCU.fusion_calls_spec()]
        n0 = len(loaded)
        fused = s.execute_fused(calls)
        assert s.cache_stats["persist_hits"] >= 1 and s.persist_stats["saves"] == 0, w
        assert any(r.stats.get("fused") for r in fused)
        for j, (r, (st_, p)) in enumerate(zip(fused, calls)):
            CU.assert_rows_equal(st_.execute(params=p), r, f"session {w} fused[{j}]")
        plans = [p for x in loaded[n0:] for p in (x if isinstance(x, tuple) else (x,))]
        got = {n.node_id for p in plans for n in PR.walk_plan_deep(p)}
        own = {n.node_id for st_ in stmts for n in PR.walk_plan_deep(st_.plan)}
        assert got and not got & own
        ids.append(got)
    assert not ids[0] & ids[1]


# ---------------------------------------------------------------------------
# the compile fault seam on a store hit
# ---------------------------------------------------------------------------


def _seam_run(M, path, fused: bool):
    s = _session(path) if M is PC else _ref_session(path)
    rng = np.random.default_rng(0)
    s.create_table("detail", d_key=rng.integers(0, 40, 200),
                   d_val=rng.uniform(0, 100, 200).astype(np.float32))
    s.create_table("T", a=rng.integers(0, 40, 30))
    fi = (FaultInjector if M is PC else RefFaultInjector)(
        [(FaultSpec if M is PC else RefFaultSpec)(site="compile", times=None)])
    fi.install(s)
    cu = PCU if M is PC else CU
    try:
        if fused:
            s.execute_fused(_template_calls(M, s))
        else:
            s.execute(cu.param_query(), M.FROID, params=PARAMS)
        err = None
    except Exception as e:
        err = type(e).__name__
    return err, dict(fi.events), s.cache_stats["persist_hits"]


@pytest.mark.parametrize("fused", [False, True], ids=["exec", "fused"])
def test_compile_seam_on_a_store_hit(tmp_path, fused):
    """With the store warm, a compile fault fires in the exec tier (the
    seam comes before the lookup) and not in the fused tier (it fires only
    on a store miss); the injector's events are the reference's."""
    pdir, rdir = tmp_path / "port", tmp_path / "ref"
    _script(PC, _session(pdir))
    _script(RC, _ref_session(rdir))
    port, ref = _seam_run(PC, pdir, fused), _seam_run(RC, rdir, fused)
    assert port == ref
    err, events, hits = port
    if fused:
        assert err is None and hits >= 1 and "compile" not in events
    else:
        assert err == "InjectedFault" and hits == 0 and events["compile"] >= 1
