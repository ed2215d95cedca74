"""The port's multi-statement fusion engine (``repro_torch.fuse``,
``Session.execute_fused``, the scheduler's fused drains and the ladder's
fused tier) against the reference and against the port's own serial loop,
on the CPU.

Ports the unsharded cases of ``tests/test_fused.py`` and
``tests/test_fuse_cse.py``: the merge pass (shared subtrees, templates,
lifted and correlated templates, nested sharing, its stats and
``explain()``), the fusability analysis and its overlap-aware split (under
the port's H100 cost model), ``execute_fused`` against the reference's and
the serial loop, the fused cache tier (arrival order, DDL, binding-count
buckets, ``CSE_EXACT_D``), pool evaluations counted exactly ``d``, the
scheduler's fused drains with per-group isolation, and the serving
pass-throughs.  Then ``conformance_util.check_fusion_oracle``'s logic on
the port's ``Session`` and scheduler, over ``fusion_queries`` and the
overlap queues built by ``conformance_util``'s own functions with the
port's frontend in place of the reference's (:func:`_cu`); the unsharded
FROID legs of ``check_chaos_oracle`` (``tests/test_resilience.py``'s
chaos cases) on the port; a GroupAgg shared across members with
``pallas_agg`` on, which reaches relagg's plain version once for the
shared pool and its batched one once for a member's parameterized
GroupAgg; and ``chip_smoke.py``'s copy of ``benchmarks/bench_fused.py``'s
queues held to the benchmark's; and routed fused drains (``ROUTED``:
the cost router picks the arm each wave) beside the reference's, under
faults too.  Decorrelated plans explain as the reference's byte for byte
(their column digests included).  The sharded cases
(``test_fused.py:412-457``) run on four CPU mesh positions
(``make_small_mesh(data=4, devices=["cpu"] * 4)``), beside the
reference's fused drain of the same queue.

The same numpy-seeded tables go through both packages (``device="cpu"``
for the port).  Masks, keys and validity match exactly and floats to rtol
1e-4 (``assert_masked``); every per-result ``fused_*`` / ``cse_*`` stat and
the session's fuse and CSE counters equal the reference's.  Every port run
is under ``no_vmap_fallback``: a functorch per-example fallback (the
template gather's batched slot index included) is an error.
"""
import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conformance_util as CU
import repro.core as RC
import repro_torch.core as PC
from repro.core import relalg as RR
from repro.core import scalar as RS
from repro.fuse import merge_plans as ref_merge_plans
from repro.fuse import partition_calls as ref_partition_calls
from repro.serve.scheduler import CoalescingScheduler as RefScheduler
from repro_torch.core import relalg as PR
from repro_torch.core import scalar as PS
from repro_torch.core import session as psession
from repro_torch.core.fingerprint import parametric_fingerprint, plan_fingerprint
from repro_torch.fuse import (
    CONST_BIND,
    is_fusable,
    merge_plans,
    partition_calls,
    plan_is_pure,
    rewrite_params,
    subtree_is_constant,
    subtree_shape,
)
from repro_torch.kernels.relagg import ops as relagg_ops
from repro_torch.resilience import (
    BreakerConfig,
    FaultInjector,
    FaultSpec,
    ResilienceConfig,
    ResilienceError,
)
from repro_torch.serve.scheduler import CoalescingScheduler

from test_torch_correlated import assert_masked, no_vmap_fallback
from test_torch_interpreter import PROGRAMS, _program_udf
from test_torch_session_tpch import _norm_explain

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_fallback():
    with no_vmap_fallback():
        yield


# ---------------------------------------------------------------------------
# helpers: both packages, the same tables
# ---------------------------------------------------------------------------


def _session(M):
    return M.Session(device="cpu") if M is PC else M.Session()


def _populate(M, db, n_detail=2000, n_t=200, seed=0):
    """``tests/test_fused.py::_populate`` with either package."""
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


def _populate_cse(M, db, n_detail=600, n_t=80, seed=0):
    """``tests/test_fuse_cse.py::_populate`` with either package."""
    rng = np.random.default_rng(seed)
    db.create_table(
        "detail",
        d_key=rng.integers(0, 40, n_detail),
        d_val=rng.uniform(0, 100, n_detail).astype(np.float32),
    )
    db.create_table("T", a=rng.integers(0, 40, n_t))


def _q_udf(M):
    return (M.scan("T").filter(M.col("a") < M.param("cutoff"))
            .compute(v=M.udf("key_total", M.col("a"))).project("v"))


def _q_arith(M):
    return (M.scan("T").filter(M.col("a") >= M.param("lo"))
            .compute(w=M.col("a") * M.param("scale")).project("a", "w"))


def _q_paramfree(M):
    return M.scan("T").compute(z=M.col("a") * 2).project("z")


def _agg_filtered(M, pname: str, out: str = "s"):
    return (M.scan("detail").filter(M.col("d_val") > M.param(pname))
            .agg(**{out: M.sum_(M.col("d_val"))}))


def _q_template(M, pname: str, out_col: str):
    return (M.scan("T")
            .compute(**{out_col: M.scalar_subquery(_agg_filtered(M, pname).node, "s")
                        + M.col("a") * 0.0})
            .project("a", out_col))


def _q_const_template(M, value, out_col: str):
    inner = (M.scan("detail").filter(M.col("d_val") > M.lit(value))
             .agg(s=M.sum_(M.col("d_val"))))
    return (M.scan("T")
            .compute(**{out_col: M.scalar_subquery(inner.node, "s") + M.col("a") * 0.0})
            .project("a", out_col))


def _corr_pair(M, S):
    """Two correlated subquery bodies differing in their outer binding."""
    body_a = (M.scan("detail").filter(M.col("d_key") <= S.Outer("a"))
              .agg(s=M.sum_(M.col("d_val"))))
    body_b = (M.scan("detail").filter(M.col("d_key") <= S.Outer("b"))
              .agg(s=M.sum_(M.col("d_val"))))
    qa = M.scan("T").compute(v=M.scalar_subquery(body_a.node, "s")).project("a", "v")
    qb = (M.scan("T").compute(b=M.col("a") * 1)
          .compute(w=M.scalar_subquery(body_b.node, "s")).project("b", "w"))
    return qa, qb


def _norm(text: str) -> str:
    """Explain text with object addresses named by class
    (``_norm_explain``); the decorrelated columns' content digests are
    compared as they are."""
    return _norm_explain(text)


#: per-result stats that must equal the reference's (timings and the
#: explain text compared apart)
FUSED_KEYS = (
    "fused", "fused_programs", "fused_statements", "fused_members",
    "batch_size", "batch_bucket", "wave_tickets", "compiled", "batched",
    "shared_subtrees", "shared_refs", "shared_maximal_subtrees",
    "cse_templates", "cse_template_refs", "cse_lifted_templates",
    "cse_corr_templates", "cse_corr_refs", "cse_shared_nodes",
    "total_scans", "shared_scan_nodes", "cse_pool_evals",
    "cse_template_groups", "cse_bindings", "cse_pool_slots",
    "cse_template_ticket_refs", "rows_scanned",
)
CACHE_KEYS = ("fuse_hits", "fuse_misses", "cse_hits", "cse_shared_nodes",
              "batch_hits", "batch_misses")


def _assert_same(serial, fused):
    """``tests/test_fused.py``'s check: masks exactly, every column to
    rtol 1e-5 on the selected rows."""
    assert len(serial) == len(fused)
    for s, f in zip(serial, fused):
        m = np.asarray(s.masked.mask)
        np.testing.assert_array_equal(m, np.asarray(f.masked.mask))
        for n, c in s.masked.table.columns.items():
            np.testing.assert_allclose(
                np.asarray(f.masked.table.columns[n].data)[m],
                np.asarray(c.data)[m], rtol=1e-5,
            )


def _assert_ref(want, got, label):
    """Reference results against the port's: rows (``assert_masked``) and
    every per-result fused stat, the explain text."""
    assert len(want) == len(got), label
    for i, (w, g) in enumerate(zip(want, got)):
        assert_masked(w.masked, g.masked, f"{label}[{i}]")
        ws, gs = w.stats, g.stats
        assert ("fused" in ws) == ("fused" in gs), f"{label}[{i}]: fused"
        for k in FUSED_KEYS:
            assert ws.get(k) == gs.get(k), f"{label}[{i}]: {k} {ws.get(k)} != {gs.get(k)}"
        if "fused_explain" in ws:
            assert _norm(gs["fused_explain"]) == _norm(ws["fused_explain"]), label


def _assert_cache(ref, port, label=""):
    for k in CACHE_KEYS:
        assert ref.cache_stats[k] == port.cache_stats[k], (
            f"{label} cache_stats[{k}]: {ref.cache_stats[k]} != {port.cache_stats[k]}")


class Pair:
    """A reference and a port session over the same tables; ``prep``
    prepares one statement in both (built by ``build(M)``), ``fused`` runs
    a call list (statement indices into the prepared list) through both
    ``execute_fused`` and holds the port to the reference."""

    def __init__(self, populate=_populate, **kw):
        self.ref, self.port = _session(RC), _session(PC)
        populate(RC, self.ref, **kw)
        populate(PC, self.port, **kw)
        self.r, self.p = [], []

    def prep(self, build, policy="FROID"):
        rpol = getattr(RC, policy) if isinstance(policy, str) else policy[0]
        ppol = getattr(PC, policy) if isinstance(policy, str) else policy[1]
        self.r.append(self.ref.prepare(build(RC), rpol))
        self.p.append(self.port.prepare(build(PC), ppol))
        return self.p[-1]

    def calls(self, spec, which):
        stmts = self.p if which == "port" else self.r
        return [(stmts[i], p) for i, p in spec]

    def fused(self, spec, label="execute_fused"):
        want = self.ref.execute_fused(self.calls(spec, "ref"))
        got = self.port.execute_fused(self.calls(spec, "port"))
        _assert_ref(want, got, label)
        _assert_same([s.execute(params=p) for s, p in self.calls(spec, "port")], got)
        _assert_cache(self.ref, self.port, label)
        return got


# ---------------------------------------------------------------------------
# plan-merge pass
# ---------------------------------------------------------------------------


def _merge_both(pair_plans):
    ref_m = ref_merge_plans(pair_plans[0])
    port_m = merge_plans(pair_plans[1])
    assert port_m.stats == ref_m.stats
    assert _norm(port_m.explain()) == _norm(ref_m.explain())
    return ref_m, port_m


def test_merge_dedups_shared_scans():
    pair = Pair()
    for b in (_q_udf, _q_arith, _q_paramfree):
        pair.prep(b)
    _, merged = _merge_both(([s.plan for s in pair.r], [s.plan for s in pair.p]))
    assert merged.stats["shared_subtrees"] >= 1
    assert merged.stats["shared_refs"] > merged.stats["shared_subtrees"]
    assert merged.stats["total_scans"] >= 3
    shared_fps = {fp for fp, _ in merged.shared}
    assert set(merged.shared_ids.values()) <= shared_fps


def _nested_plans(M, R):
    scan_t = R.Scan("T")
    f1 = R.Filter(scan_t, M.col("a") < M.lit(5))
    f2 = R.Filter(R.Scan("T"), M.col("a") < M.lit(5))
    return scan_t, f1, f2


def test_merge_shares_nested_subtrees():
    ref_nodes, (scan_t, f1, f2) = _nested_plans(RC, RR), _nested_plans(PC, PR)
    rs, rf1, rf2 = ref_nodes
    _, merged = _merge_both(([RR.Project(rf1, ["a"]), RR.Compute(rf2, {"b": RC.col("a")})],
                             [PR.Project(f1, ["a"]), PR.Compute(f2, {"b": PC.col("a")})]))
    assert len(dict(merged.shared)) == 2
    assert merged.shared_ids[f1.node_id] == merged.shared_ids[f2.node_id]
    assert scan_t.node_id in merged.shared_ids
    order = [fp for fp, _ in merged.shared]
    assert order.index(merged.shared_ids[scan_t.node_id]) \
        < order.index(merged.shared_ids[f1.node_id])
    assert merged.stats["shared_refs"] == 2
    assert merged.stats["cse_shared_nodes"] == 4
    _, whole = _merge_both(([RR.Project(rf1, ["a"]), RR.Project(rf2, ["a"])],
                            [PR.Project(f1, ["a"]), PR.Project(f2, ["a"])]))
    assert whole.stats["shared_refs"] == 2
    assert whole.stats["cse_shared_nodes"] == 6


def test_subtree_constness_and_shapes():
    assert subtree_is_constant(PR.Scan("T"))
    assert not subtree_is_constant(PR.Filter(PR.Scan("T"), PC.col("a") < PC.param("c")))
    assert plan_is_pure(PR.Project(PR.Scan("T"), ["a"]))
    assert subtree_shape(PR.Scan("T")) == "const"
    assert subtree_shape(PR.Filter(PR.Scan("T"), PC.col("a") < PC.param("c"))) == "param"
    assert subtree_shape(PR.Filter(PR.Scan("T"), PC.col("a") < PS.Outer("o"))) == "corr"
    assert subtree_shape(PR.Compute(PR.Scan("T"), {"r": PS.Func("rand", [])})) is None
    assert subtree_shape(PR.Filter(PR.Scan("T"), PC.col("a") < PS.Var("v"))) is None


def test_merge_blocks_nondeterministic_subtrees():
    def build(M, R, S):
        det = R.Filter(R.Scan("T"), M.col("a") < M.lit(5))
        rnd = R.Compute(R.Scan("T"), {"r": S.Func("rand", [])})
        return det, rnd

    _, rrnd = build(RC, RR, RS)
    det, rnd = build(PC, PR, PS)
    assert subtree_is_constant(det) and not subtree_is_constant(rnd)
    _, merged = _merge_both(([RR.Project(rrnd, ["r"]), RR.Compute(rrnd, {"b": RC.col("r")})],
                             [PR.Project(rnd, ["r"]), PR.Compute(rnd, {"b": PC.col("r")})]))
    assert rnd.node_id not in merged.shared_ids


def test_parametric_fingerprints():
    p1 = PR.Filter(PR.Scan("detail"), PC.col("d_val") > PC.param("x"))
    p2 = PR.Filter(PR.Scan("detail"), PC.col("d_val") > PC.param("y"))
    assert plan_fingerprint(p1) != plan_fingerprint(p2)
    (fp1, h1), (fp2, h2) = parametric_fingerprint(p1), parametric_fingerprint(p2)
    assert fp1 == fp2 and h1 == (("param", "x"),) and h2 == (("param", "y"),)
    twice = PR.Filter(PR.Scan("T"), PC.param("a") + PC.param("a") > PC.col("a"))
    mixed = PR.Filter(PR.Scan("T"), PC.param("x") + PC.param("y") > PC.col("a"))
    twice2 = PR.Filter(PR.Scan("T"), PC.param("b") + PC.param("b") > PC.col("a"))
    assert parametric_fingerprint(twice)[0] != parametric_fingerprint(mixed)[0]
    assert parametric_fingerprint(twice)[0] == parametric_fingerprint(twice2)[0]
    viap = PR.Filter(PR.Scan("detail"), PC.col("d_key") <= PC.param("k"))
    viao = PR.Filter(PR.Scan("detail"), PC.col("d_key") <= PS.Outer("k"))
    assert parametric_fingerprint(viap)[0] != parametric_fingerprint(viao)[0]
    free = PR.Filter(PR.Scan("detail"), PC.col("d_key") <= PC.lit(5))
    assert parametric_fingerprint(free)[0] == plan_fingerprint(free)
    c = PR.Filter(PR.Scan("detail"), PC.col("d_val") > PC.lit(5.0))
    fp_p, holes_p = parametric_fingerprint(p1, lift_consts=True)
    fp_c, holes_c = parametric_fingerprint(c, lift_consts=True)
    assert fp_p == fp_c and holes_c == (("const", ("float", 5.0)),)
    assert fp_p != parametric_fingerprint(p1)[0]
    m5 = PR.Filter(PR.Scan("T"), PC.lit(5) + PC.lit(5.0) > PC.col("a"))
    s5 = PR.Filter(PR.Scan("T"), PC.lit(5) + PC.lit(5) > PC.col("a"))
    assert parametric_fingerprint(m5, lift_consts=True)[1] == (
        ("const", ("int", 5)), ("const", ("float", 5.0)))
    assert (parametric_fingerprint(m5, lift_consts=True)[0]
            != parametric_fingerprint(s5, lift_consts=True)[0])


def test_cast_dtype_fingerprints_by_name():
    """A Cast's dtype tag (a numpy scalar class) fingerprints as the
    reference's tag for that dtype does (its ``repr``), never by the class
    object's address; another class fingerprints by its name."""
    for tag, ref_tag in ((np.int32, jnp.int32), (np.float32, jnp.float32),
                         (np.bool_, jnp.bool_)):
        fp = plan_fingerprint(PR.Compute(PR.Scan("T"), {"c": PS.Cast(PC.col("a"), tag)}))
        want = RC.plan_fingerprint(RR.Compute(RR.Scan("T"), {"c": RS.Cast(RC.col("a"), ref_tag)}))
        assert fp == want and repr(ref_tag) in repr(fp) and "object" not in repr(fp)
    fp = plan_fingerprint(PR.Compute(PR.Scan("T"), {"c": PS.Cast(PC.col("a"), np.int16)}))
    assert "('type', 'numpy', 'int16')" in repr(fp)


def test_decorrelated_cast_plan_is_the_reference_byte_for_byte():
    """``key_total``'s argument is cast by the binder (``Cast(Outer(a),
    int32)``), and decorrelation names its columns by a digest over that
    cast: the optimized plan explains as the reference's, byte for byte,
    and fingerprints to the same ``repr``."""
    ref, port = _session(RC), _session(PC)
    _populate(RC, ref)
    _populate(PC, port)
    rplan, pplan = ref.prepare(_q_udf(RC)).plan, port.prepare(_q_udf(PC)).plan
    fp = repr(plan_fingerprint(pplan))
    assert "'Cast'" in fp and "<class 'jax.numpy.int32'>" in fp
    text = port.explain(_q_udf(PC))
    assert "__dck" in text and "__dgk" in text and "__dc" in text
    assert text == ref.explain(_q_udf(RC))
    assert fp == repr(RC.plan_fingerprint(rplan))


def test_rewrite_params_descends_into_subquery_plans():
    inner = PR.Filter(PR.Scan("detail"), PC.col("d_val") > PC.param("x"))
    const_side = PR.Scan("T")
    plan = PR.Compute(const_side, {"v": PS.ScalarSubquery(inner, None)})
    out = rewrite_params(plan, {"x": "__cse_s0"})
    names = {s.name for n in PR.walk_plan_deep(out) for e in n.exprs()
             for s in PS.walk(e) if isinstance(s, PS.Param)}
    assert names == {"__cse_s0"}
    assert out.child is const_side


def test_merge_templates_lifting_and_correlated_identity():
    pair = Pair(_populate_cse)
    for b in (lambda M: _q_template(M, "x", "v1"), lambda M: _q_template(M, "y", "v2"),
              lambda M: _q_const_template(M, 30.0, "v3"),
              lambda M: _q_const_template(M, 30.0, "v4"),
              lambda M: _q_template(M, "p", "v5")):
        pair.prep(b)
    rp, pp = [s.plan for s in pair.r], [s.plan for s in pair.p]
    _, m1 = _merge_both((rp[:2], pp[:2]))
    assert m1.stats["cse_templates"] >= 1 and m1.stats["cse_template_refs"] >= 2
    assert m1.stats["cse_lifted_templates"] == 0
    assert {tuple(b.values()) for b in m1.template_binds.values()} >= {("x",), ("y",)}
    tnames = {s.name for t in m1.templates for n in PR.walk_plan_deep(t.node)
              for e in n.exprs() for s in PS.walk(e) if isinstance(s, PS.Param)}
    assert tnames and all(n.startswith("__cse_s") for n in tnames)
    _, m2 = _merge_both((rp[2:4], pp[2:4]))
    assert m2.stats["cse_lifted_templates"] == 0 and m2.stats["shared_subtrees"] >= 1
    _, m3 = _merge_both(([rp[4], rp[2]], [pp[4], pp[2]]))
    assert m3.stats["cse_lifted_templates"] >= 1
    assert any(v == (CONST_BIND, 30.0) for b in m3.template_binds.values() for v in b.values())
    assert "__const__" in m3.explain()
    qa, qb = _corr_pair(RC, RS)
    pa, pb = _corr_pair(PC, PS)
    _, m4 = _merge_both(([pair.ref.prepare(qa, RC.FROID).plan, pair.ref.prepare(qb, RC.FROID).plan],
                         [pair.port.prepare(pa, PC.FROID).plan, pair.port.prepare(pb, PC.FROID).plan]))
    assert m4.stats["cse_corr_templates"] >= 1 and m4.stats["cse_corr_refs"] >= 2
    assert "correlated templates" in m4.explain()


def test_merge_stats_monotonic_in_members():
    pair = Pair(_populate_cse)
    for b in (lambda M: _q_template(M, "x", "v1"), lambda M: _q_template(M, "y", "v2"),
              lambda M: M.scan("T").compute(z=M.col("a") * 2).project("z"),
              lambda M: _q_template(M, "z", "v3")):
        pair.prep(b)
    rp, pp = [s.plan for s in pair.r], [s.plan for s in pair.p]
    prev = 0
    for k in range(1, 5):
        _, m = _merge_both((rp[:k], pp[:k]))
        assert m.stats["cse_shared_nodes"] >= prev
        prev = m.stats["cse_shared_nodes"]
    assert prev > 0
    for perm in ([1, 0, 3, 2], [3, 2, 1, 0]):
        _, m = _merge_both(([rp[i] for i in perm], [pp[i] for i in perm]))
        assert m.stats["cse_shared_nodes"] == prev


# ---------------------------------------------------------------------------
# fusability analysis
# ---------------------------------------------------------------------------


def _partition_both(pair, spec):
    """Both packages' ``partition_calls`` on the same call list, as
    (groups as call-index lists, fallbacks as call-index lists)."""
    def shape(out):
        groups, fallbacks = out
        return ([[i for i, _, _ in g] for g in groups],
                [[i for i, _ in items] for _, items in fallbacks])

    want = shape(ref_partition_calls(pair.ref, pair.calls(spec, "ref")))
    got = shape(partition_calls(pair.port, pair.calls(spec, "port")))
    assert got == want
    return got


def test_fusability_gates():
    pair = Pair()
    s_froid = pair.prep(_q_udf)
    s_eager = pair.prep(_q_udf, "INTERPRETED")
    s_nofuse = pair.prep(_q_arith, (RC.FROID.fused(fuse=False), PC.FROID.fused(fuse=False)))
    other = _session(PC)
    _populate(PC, other)
    s_foreign = other.prepare(_q_arith(PC), PC.FROID)
    assert is_fusable(pair.port, s_froid)
    assert not is_fusable(pair.port, s_eager)
    assert not is_fusable(pair.port, s_nofuse)
    assert not is_fusable(pair.port, s_foreign)
    groups, fallbacks = _partition_both(
        pair, [(0, {"cutoff": 1}), (1, {"cutoff": 1}), (2, {"lo": 1, "scale": 1.0})])
    assert groups == [] and len(fallbacks) == 3
    groups, fallbacks = partition_calls(pair.port, [
        (s_froid, {"cutoff": 1}), (s_foreign, {"lo": 1, "scale": 1.0})])
    assert groups == [] and len(fallbacks) == 2


def test_max_fused_statements_splits():
    pair = Pair()
    pol = (RC.FROID.fused(max_fused_statements=2), PC.FROID.fused(max_fused_statements=2))
    for b in (_q_udf, _q_arith, _q_paramfree):
        pair.prep(b, pol)
    spec = [(0, {"cutoff": 5}), (1, {"lo": 1, "scale": 1.0}), (2, {})]
    groups, fallbacks = _partition_both(pair, spec)
    assert len(groups) == 1 and len(groups[0]) == 2 and len(fallbacks) == 1
    rs = pair.fused(spec)
    assert rs[0].stats["fused_statements"] == 2
    assert "fused" not in rs[2].stats


def test_fuse_policy_knobs_are_not_identity():
    assert PC.FROID.fused(fuse=False) == PC.FROID
    assert PC.FROID.fused(fuse=False).fingerprint() == PC.FROID.fingerprint()
    assert PC.FROID.fused(max_fused_statements=2).max_fused_statements == 2
    assert PC.FROID.fuse and PC.FROID.max_fused_statements == 8


def test_overlap_order_same_weights_same_order():
    """``_overlap_order`` given identical fingerprint sets and weights
    orders identically in both packages."""
    from repro.fuse.analysis import _overlap_order as ref_order
    from repro_torch.fuse.analysis import _overlap_order as port_order

    fp_sets = {"a": frozenset({1, 2}), "b": frozenset({3}), "c": frozenset({1}),
               "d": frozenset({3, 4}), "e": frozenset({2, 5})}
    weights = {1: 0.5, 2: 2.0, 3: 1.0, 4: 0.1, 5: 3.0}
    order = list("abcde")
    for cap in (2, 3):
        for w in (None, weights):
            assert port_order(order, fp_sets, cap, w) == ref_order(order, fp_sets, cap, w)


def test_partition_chunks_by_template_overlap():
    """The reference's overlap split, under the port's H100 cost model:
    the two overlap families land in the same programs."""
    pair = Pair(_populate_cse)
    pol = (RC.FROID.fused(max_fused_statements=2), PC.FROID.fused(max_fused_statements=2))
    pair.prep(lambda M: _q_template(M, "x", "v1"), pol)
    pair.prep(lambda M: M.scan("detail").filter(M.col("d_val") > M.lit(50.0))
              .group_by("d_key", s=M.sum_(M.col("d_val"))), pol)
    pair.prep(lambda M: _q_template(M, "y", "v2"), pol)
    pair.prep(lambda M: M.scan("detail").filter(M.col("d_val") > M.lit(50.0))
              .compute(w=M.col("d_val") * 2.0).project("d_key", "w"), pol)
    spec = [(0, {"x": 1.0}), (1, {}), (2, {"y": 2.0}), (3, {})]
    groups, fallbacks = _partition_both(pair, spec)
    assert sorted(map(sorted, groups)) == [[0, 2], [1, 3]] and not fallbacks
    pair.fused(spec)


# ---------------------------------------------------------------------------
# execute_fused: against the reference and the serial loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["FROID", "HEKATON"])
def test_execute_fused_matches_reference_and_serial(policy):
    pair = Pair()
    for b in (_q_udf, _q_arith, _q_paramfree):
        pair.prep(b, policy)
    spec = [(0, {"cutoff": 10}), (1, {"lo": 5, "scale": 2.0}), (2, None),
            (0, {"cutoff": 30}), (1, {"lo": 20, "scale": 0.5}),
            (0, {"cutoff": 7.5}), (2, {})]
    fused = pair.fused(spec)
    st = fused[0].stats
    assert st["fused"] and st["fused_programs"] == 1
    assert st["fused_programs"] < st["fused_statements"] == 3
    assert st["fused_members"] == 4
    assert st["shared_subtrees"] >= 1
    assert st["batch_size"] == 2 and st["batch_bucket"] == 2


def test_execute_fused_empty_and_single():
    pair = Pair()
    assert pair.port.execute_fused([]) == []
    pair.prep(_q_udf)
    rs = pair.fused([(0, {"cutoff": 5}), (0, {"cutoff": 9})])
    assert "fused" not in rs[0].stats


def test_fused_cache_tier():
    pair = Pair()
    pair.prep(_q_udf)
    pair.prep(_q_arith)
    r1 = pair.fused([(0, {"cutoff": 5}), (1, {"lo": 3, "scale": 1.0}), (0, {"cutoff": 8})])
    assert pair.port.cache_stats["fuse_misses"] == 1 and not r1[0].cache_hit
    r2 = pair.fused([(1, {"lo": 9, "scale": 4.0}), (0, {"cutoff": 40}), (0, {"cutoff": 2})])
    assert pair.port.cache_stats["fuse_hits"] == 1 and r2[0].cache_hit


def test_fused_cache_invalidates_on_ddl():
    pair = Pair()
    pair.prep(_q_udf)
    pair.prep(_q_arith)
    spec = [(0, {"cutoff": 49}), (1, {"lo": 0, "scale": 1.0})]
    r1 = pair.fused(spec)
    misses = pair.port.cache_stats["fuse_misses"]
    rng = np.random.default_rng(99)
    arrays = dict(d_key=rng.integers(0, 50, 2000),
                  d_val=rng.uniform(0, 100, 2000).astype(np.float32))
    pair.ref.create_table("detail", **arrays)
    pair.port.create_table("detail", **arrays)
    r2 = pair.fused(spec)
    assert pair.port.cache_stats["fuse_misses"] == misses + 1 and not r2[0].cache_hit
    m = np.asarray(r2[0].masked.mask)
    assert not np.allclose(np.asarray(r1[0].masked.table.columns["v"].data)[m],
                           np.asarray(r2[0].masked.table.columns["v"].data)[m])


def test_fused_group_honors_strictest_max_batch():
    pair = Pair()
    pair.prep(_q_udf)
    pair.prep(_q_arith, (RC.FROID.batched(max_batch=2), PC.FROID.batched(max_batch=2)))
    spec = ([(0, {"cutoff": int(k)}) for k in range(3)]
            + [(1, {"lo": int(k), "scale": 1.0}) for k in range(3)])
    rs = pair.fused(spec)
    fused_rs = [r for r in rs if "fused" in r.stats]
    assert fused_rs and all(r.stats["batch_bucket"] <= 2 for r in fused_rs)
    hits = pair.port.cache_stats["fuse_hits"]
    pair.fused(list(reversed(spec)))
    assert pair.port.cache_stats["fuse_hits"] > hits


def test_fused_overflow_spills_to_per_statement_path():
    pair = Pair()
    pol = (RC.FROID.batched(max_batch=4), PC.FROID.batched(max_batch=4))
    pair.prep(_q_udf, pol)
    pair.prep(_q_arith, pol)
    rs = pair.fused([(0, {"cutoff": int(k)}) for k in range(6)]
                    + [(1, {"lo": 5, "scale": 2.0})])
    assert rs[0].stats["fused"]
    assert rs[5].stats.get("batched") and "fused" not in rs[5].stats


def test_interpreted_and_fuse_off_fall_back():
    pair = Pair()
    for b in (_q_udf, _q_arith):
        pair.prep(b, "INTERPRETED")
    for b in (_q_udf, _q_arith):
        pair.prep(b, (RC.FROID.fused(fuse=False), PC.FROID.fused(fuse=False)))
    for spec in ([(0, {"cutoff": 9}), (1, {"lo": 5, "scale": 2.0})],
                 [(2, {"cutoff": 9}), (3, {"lo": 5, "scale": 2.0}), (2, {"cutoff": 3})]):
        rs = pair.fused(spec)
        assert all("fused" not in r.stats for r in rs)


# ---------------------------------------------------------------------------
# binding-pooled evaluation: exact counts, the template cache key
# ---------------------------------------------------------------------------


def _template_eval_counts(entry):
    return {k: v for k, v in entry.eval_counts.items()
            if isinstance(k, tuple) and k and isinstance(k[0], tuple)}


def _entries(pair):
    """The one fused executable of each package (a single-program test)."""
    (rentry,), (pentry,) = pair.ref._fuse_execs.values(), pair.port._fuse_execs.values()
    return rentry, pentry


def _counts_equal(pair):
    """Pool evaluations per kind equal the reference's (the keys hold
    package-specific fingerprints, so compare the multisets of counts)."""
    rentry, pentry = _entries(pair)
    rt, pt = _template_eval_counts(rentry), _template_eval_counts(pentry)
    assert sorted(pt.values()) == sorted(rt.values())
    assert (sorted(v for k, v in pentry.eval_counts.items() if k not in pt)
            == sorted(v for k, v in rentry.eval_counts.items() if k not in rt))
    return pentry, pt


def _cse_pair(*builds):
    pair = Pair(_populate_cse)
    for b in builds:
        pair.prep(b)
    return pair


T_X = (lambda M: _q_template(M, "x", "v1"), lambda M: _q_template(M, "y", "v2"))


def test_pool_evaluates_exactly_d_distinct_bindings():
    pair = _cse_pair(*T_X)
    values = [10.0, 30.0, 10.0, 55.0, 30.0, 10.0]
    spec = [((0, {"x": v}) if i % 2 == 0 else (1, {"y": v})) for i, v in enumerate(values)]
    fused = pair.fused(spec)
    st = fused[0].stats
    assert st["fused"] and st["cse_template_groups"] >= 1 and st["cse_bindings"] == 3
    entry, tcounts = _counts_equal(pair)
    assert tcounts and sum(tcounts.values()) == 3
    ccounts = {k: v for k, v in entry.eval_counts.items() if k not in tcounts}
    assert ccounts and all(v == 1 for v in ccounts.values())
    # a warm wave counts its own evaluations, not the first wave's too
    pair.fused(spec)
    _, tcounts = _counts_equal(pair)
    assert sum(tcounts.values()) == 3


def test_pool_count_insensitive_to_padding():
    pair = _cse_pair(*T_X)
    fused = pair.fused([(0, {"x": 10.0}), (0, {"x": 20.0}), (0, {"x": 10.0}),
                        (1, {"y": 20.0})])
    assert fused[0].stats["cse_bindings"] == 2


def test_nested_shared_subtree_dedups_between_roots():
    base = lambda M: M.scan("detail").filter(M.col("d_val") > M.lit(50.0))  # noqa: E731
    pair = _cse_pair(lambda M: base(M).group_by("d_key", s=M.sum_(M.col("d_val"))),
                     lambda M: base(M).compute(w=M.col("d_val") * 2.0).project("d_key", "w"))
    pair.fused([(0, None), (1, None), (0, {}), (1, {})])
    entry, _ = _counts_equal(pair)
    assert entry.eval_counts and all(v == 1 for v in entry.eval_counts.values())
    assert len(entry.eval_counts) >= 2


def test_correlated_bodies_share_interior_subtrees():
    pair = _cse_pair(lambda M: _corr_pair(M, RS if M is RC else PS)[0],
                     lambda M: _corr_pair(M, RS if M is RC else PS)[1])
    fused = pair.fused([(0, None), (1, None)])
    assert fused[0].stats["fused"] and fused[0].stats["cse_corr_templates"] >= 1


def test_lifted_pool_coinciding_binding_evaluates_once():
    pair = _cse_pair(lambda M: _q_template(M, "p", "v1"),
                     lambda M: _q_const_template(M, 30.0, "v2"))
    fused = pair.fused([(0, {"p": 30.0}), (1, None), (0, {"p": 30.0})])
    st = fused[0].stats
    assert st["fused"] and st["cse_lifted_templates"] >= 1 and st["cse_bindings"] == 1
    _, tcounts = _counts_equal(pair)
    assert tcounts and sum(tcounts.values()) == 1


def test_lifted_pool_distinct_bindings_evaluate_d_times():
    pair = _cse_pair(lambda M: _q_template(M, "p", "v1"),
                     lambda M: _q_const_template(M, 30.0, "v2"))
    fused = pair.fused([(0, {"p": 55.0}), (1, None), (0, {"p": 55.0}), (1, {})])
    assert fused[0].stats["cse_bindings"] == 2
    _, tcounts = _counts_equal(pair)
    assert tcounts and sum(tcounts.values()) == 2


def test_template_cache_key_arrival_order_independent():
    pair = _cse_pair(*T_X)
    r1 = pair.fused([(0, {"x": 10.0}), (1, {"y": 20.0}), (0, {"x": 20.0})])
    assert pair.port.cache_stats["fuse_misses"] == 1 and not r1[0].cache_hit
    r2 = pair.fused(list(reversed([(0, {"x": 70.0}), (1, {"y": 5.0}), (0, {"x": 5.0})])))
    assert pair.port.cache_stats["fuse_hits"] == 1 and r2[0].cache_hit


def test_template_cache_respecializes_on_binding_count():
    pair = _cse_pair(*T_X)
    pair.fused([(0, {"x": 10.0}), (1, {"y": 10.0})])
    misses = pair.port.cache_stats["fuse_misses"]
    rs = pair.fused([(0, {"x": 10.0}), (1, {"y": 99.0})])
    assert pair.port.cache_stats["fuse_misses"] == misses + 1
    assert rs[0].stats["cse_bindings"] == 2


def test_template_cache_d_bucketing_above_threshold():
    assert psession.CSE_EXACT_D == 8
    assert psession._pool_pad(9) == psession._pool_pad(10) == 16
    pair = _cse_pair(*T_X)
    r1 = pair.fused([(0, {"x": float(10 * i)}) for i in range(5)]
                    + [(1, {"y": float(10 * i + 5)}) for i in range(4)])
    misses = pair.port.cache_stats["fuse_misses"]
    assert r1[0].stats["cse_bindings"] == 9 and r1[0].stats["cse_pool_slots"] == 16
    r2 = pair.fused([(0, {"x": float(7 * i + 1)}) for i in range(6)]
                    + [(1, {"y": float(7 * i + 3)}) for i in range(4)])
    assert pair.port.cache_stats["fuse_misses"] == misses and r2[0].cache_hit
    assert r2[0].stats["cse_bindings"] == 10 and r2[0].stats["cse_pool_slots"] == 16


def test_template_cache_exact_d_below_threshold():
    assert psession._pool_pad(8) == 8 and psession._pool_pad(9) == 16
    pair = _cse_pair(*T_X)
    r8 = pair.fused([(0, {"x": float(10 * i)}) for i in range(5)]
                    + [(1, {"y": float(10 * i + 5)}) for i in range(3)])
    assert r8[0].stats["cse_bindings"] == 8 and r8[0].stats["cse_pool_slots"] == 8
    misses = pair.port.cache_stats["fuse_misses"]
    r9 = pair.fused([(0, {"x": float(10 * i)}) for i in range(5)]
                    + [(1, {"y": float(10 * i + 5)}) for i in range(4)])
    assert pair.port.cache_stats["fuse_misses"] == misses + 1
    assert r9[0].stats["cse_pool_slots"] == 16


def test_d_bucketing_threshold_is_tunable(monkeypatch):
    from repro.core import session as rsession

    monkeypatch.setattr(psession, "CSE_EXACT_D", 2)
    monkeypatch.setattr(rsession, "CSE_EXACT_D", 2)
    pair = _cse_pair(*T_X)
    r3 = pair.fused([(0, {"x": 10.0}), (0, {"x": 20.0}), (1, {"y": 30.0})])
    assert r3[0].stats["cse_bindings"] == 3 and r3[0].stats["cse_pool_slots"] == 4
    misses = pair.port.cache_stats["fuse_misses"]
    r4 = pair.fused([(0, {"x": 11.0}), (0, {"x": 21.0}), (1, {"y": 31.0})])
    assert pair.port.cache_stats["fuse_misses"] == misses and r4[0].cache_hit


def test_fused_explain_surfaces_templates():
    pair = _cse_pair(*T_X)
    rs = pair.fused([(0, {"x": 10.0}), (1, {"y": 10.0})])
    text = rs[0].stats["fused_explain"]
    assert "parameter-unified templates" in text
    assert "__cse_s0" in text and "'x'" in text and "'y'" in text
    assert "shared constant subtrees" in text
    assert pair.port.cache_stats["cse_shared_nodes"] > 0
    assert pair.port.cache_stats["cse_hits"] > 0


def test_value_binding_reads_the_host_once():
    """A ``Value`` binding's pool key is read to the host once and
    memoized on the instance; equal values dedup to one slot."""
    v = PS.Value(torch.tensor(10.0), torch.tensor(True))
    k = psession._binding_key(v)
    assert psession._binding_key(v) is k
    assert k == psession._binding_key(PS.Value(torch.tensor(10.0), torch.tensor(True)))
    assert k != psession._binding_key(PS.Value(torch.tensor(10.0), torch.tensor(False)))
    v20 = PS.Value(torch.tensor(20.0), torch.tensor(True))
    pair = _cse_pair(*T_X)
    rs = pair.port.execute_fused([(pair.p[0], {"x": v}), (pair.p[1], {"y": v}),
                                  (pair.p[0], {"x": v20})])
    assert rs[0].stats["cse_bindings"] == 2
    want = pair.ref.execute_fused([(pair.r[0], {"x": 10.0}), (pair.r[1], {"y": 10.0}),
                                   (pair.r[0], {"x": 20.0})])
    assert want[0].stats["cse_bindings"] == 2
    for i, (w, g) in enumerate(zip(want, rs)):
        assert_masked(w.masked, g.masked, f"Value bindings[{i}]")


# ---------------------------------------------------------------------------
# the scheduler's fused drains
# ---------------------------------------------------------------------------


def _drain(stmts, calls, cls=CoalescingScheduler, **kw):
    sched = cls(max_batch=64, window_s=10.0, clock=lambda: 0.0, **kw)
    tickets = [sched.submit(stmts[i], p) for i, p in calls]
    assert sched.flush() == len(calls)
    return sched, [t.result() for t in tickets]


def test_scheduler_fused_drain():
    pair = Pair()
    for b in (_q_udf, _q_arith, _q_paramfree):
        pair.prep(b)
    spec = [(0, {"cutoff": 10}), (1, {"lo": 5, "scale": 2.0}), (2, None),
            (0, {"cutoff": 30}), (1, {"lo": 20, "scale": 0.5}), (0, {"cutoff": 7.5}), (2, {})]
    rsched, want = _drain(pair.r, spec, RefScheduler, fuse=True)
    sched, got = _drain(pair.p, spec, fuse=True)
    _assert_ref(want, got, "scheduler fused drain")
    _assert_same([pair.p[i].execute(params=p) for i, p in spec], got)
    assert sched.stats == rsched.stats
    assert sched.stats["batches"] == 1 and sched.stats["fused_batches"] == 1
    assert sched.stats["fused_statements"] == 3 and got[0].stats["fused"]


def test_scheduler_fuse_off_and_single_group():
    pair = Pair()
    pair.prep(_q_udf)
    pair.prep(_q_arith)
    sched, rs = _drain(pair.p, [(0, {"cutoff": 5}), (1, {"lo": 1, "scale": 1.0})])
    assert sched.stats["batches"] == 2 and sched.stats["fused_batches"] == 0
    assert all("fused" not in r.stats for r in rs)
    sched, rs = _drain(pair.p, [(0, {"cutoff": 5}), (0, {"cutoff": 9})], fuse=True)
    assert sched.stats["fused_batches"] == 0 and "fused" not in rs[0].stats


@pytest.mark.parametrize("resilience", [True, False], ids=["ladder", "bare"])
def test_fused_drain_isolates_failing_member(resilience):
    """A member whose table is dropped between submit and drain fails
    only its own tickets, on the ladder and on the bare drain."""
    out = {}
    for M, cls in ((RC, RefScheduler), (PC, CoalescingScheduler)):
        db = _session(M)
        _populate_cse(M, db)
        db.create_table("doomed", x=np.arange(8))
        s_ok1 = db.prepare(_q_template(M, "x", "v1"), M.FROID)
        s_ok2 = db.prepare(M.scan("T").compute(z=M.col("a") * 2).project("z"), M.FROID)
        s_bad = db.prepare(M.scan("doomed").compute(y=M.col("x") + 1).project("y"), M.FROID)
        sched = cls(max_batch=64, window_s=10.0, clock=lambda: 0.0, fuse=True,
                    resilience=resilience, sleep=lambda s: None)
        t1 = sched.submit(s_ok1, {"x": 10.0})
        tb = sched.submit(s_bad, {})
        t2 = sched.submit(s_ok2, {})
        t3 = sched.submit(s_ok1, {"x": 30.0})
        del db.catalog["doomed"]
        sched.flush()
        with pytest.raises(KeyError) as err:
            tb.result()
        _assert_same([s_ok1.execute(params={"x": 10.0}), s_ok2.execute(),
                      s_ok1.execute(params={"x": 30.0})], [t1.result(), t2.result(), t3.result()])
        out[M] = (dict(sched.stats), err.type.__name__)
    assert out[PC] == out[RC]
    st = out[PC][0]
    assert st["fused_isolated_retries"] >= 2 and st["fused_isolated_errors"] == 1


# ---------------------------------------------------------------------------
# the ladder's fused tier, beside the reference
# ---------------------------------------------------------------------------


def _mk(M):
    """``tests/test_resilience.py::_mk``: two statements over one table."""
    s = _session(M)
    s.create_table("T", x=np.arange(8, dtype=np.int32))
    q1 = M.scan("T").filter(M.col("x") < M.param("cutoff")).project("x")
    q2 = M.scan("T").compute(y=M.col("x") * M.param("m")).project("x", "y")
    return s, s.prepare(q1, M.FROID), s.prepare(q2, M.FROID)


def _xs(result):
    return np.asarray(result.table.columns["x"].data).tolist()


def _ladder_run(M, body):
    import repro.resilience as ref_res
    import repro_torch.resilience as port_res

    res = port_res if M is PC else ref_res
    cls = CoalescingScheduler if M is PC else RefScheduler
    s, stmt1, stmt2 = _mk(M)
    return body(res, cls, s, stmt1, stmt2)


def test_fused_wave_fault_demotes_members_independently():
    def body(res, cls, s, stmt1, stmt2):
        fi = res.FaultInjector([res.FaultSpec(site="dispatch", stmt=stmt1._query_fp,
                                              times=None)]).install(s)
        sched = cls(max_batch=64, window_s=1e9, sleep=lambda x: None, fuse=True)
        t1 = sched.submit(stmt1, {"cutoff": 3})
        t2 = sched.submit(stmt2, {"m": 2})
        sched.flush()
        return _xs(t1.result()), len(_xs(t2.result())), dict(sched.stats), fi.fired

    want, got = _ladder_run(RC, body), _ladder_run(PC, body)
    assert got == want
    x1, n2, stats, fired = got
    assert x1 == [0, 1, 2] and n2 == 8
    assert stats["fused_batches"] == 1 and stats["demote_fused_to_many"] == 2
    assert stats["fused_isolated_retries"] == 2 and stats["fused_isolated_errors"] == 0
    assert stats["tier_many_ok"] == 1 and stats["tier_interp_ok"] == 1 and fired >= 3


def _routed_mk(M):
    s, _, _ = _mk(M)
    q1 = M.scan("T").filter(M.col("x") < M.param("cutoff")).project("x")
    q2 = M.scan("T").compute(y=M.col("x") * M.param("m")).project("x", "y")
    return s, s.prepare(q1, M.ROUTED), s.prepare(q2, M.ROUTED)


@pytest.mark.parametrize("fault", [None, "member", "wave"])
def test_routed_fused_drains_beside_the_reference(fault):
    """Routed statements drained through a fusion-mode scheduler, three
    waves: the router picks the arm each wave (explore fused, explore per
    statement, then the measured winner), every ticket equals the
    reference's, and the exploring waves' decisions and samples are the
    reference's.  Under a fault (one member's dispatch failing always, or
    the wave's first two dispatches), the ladder's demoted and retried runs
    are excluded from the samples on the port as on the reference."""
    import repro.resilience as ref_res
    import repro_torch.resilience as port_res

    out = {}
    for M, res, cls in ((RC, ref_res, RefScheduler), (PC, port_res, CoalescingScheduler)):
        s, stmt1, stmt2 = _routed_mk(M)
        if fault == "member":
            res.FaultInjector([res.FaultSpec(site="dispatch", stmt=stmt1._query_fp,
                                             times=None)]).install(s)
        elif fault == "wave":
            res.FaultInjector([res.FaultSpec(site="dispatch", times=2)]).install(s)
        sched = cls(max_batch=64, window_s=1e9, sleep=lambda x: None, fuse=True)
        waves = []
        for w in range(3):
            t1 = sched.submit(stmt1, {"cutoff": 3 + w})
            t2 = sched.submit(stmt2, {"m": 2})
            sched.flush()
            waves.append((_xs(t1.result()), _xs(t2.result()),
                          np.asarray(t2.result().table.columns["y"].data).tolist()))
        cs = s.cost_stats
        out[M] = (waves, cs, dict(sched.stats))
    (rw, rcs, rst), (pw, pcs, pst) = out[RC], out[PC]
    assert pw == rw
    assert pw[0][0] == [0, 1, 2] and pw[2][2] == [2 * x for x in range(8)]
    whys = lambda cs: [(d["axis"], d["choice"], d["why"]) for d in cs["decision_log"]]  # noqa: E731
    assert pst["routed_waves"] == rst["routed_waves"] == 3
    if fault is None:
        # explore fused, explore per statement, every sample kept; the
        # third wave's arm is the measured winner, which timing decides
        assert whys(pcs)[:2] == whys(rcs)[:2] == [("fuse", True, "explore-fused"),
                                                  ("fuse", False, "explore-unfused")]
        assert whys(pcs)[2][2] == whys(rcs)[2][2] == "measured"
        assert pcs["samples_excluded"] == rcs["samples_excluded"] == 0
    else:
        # a faulted fused wave is never measured, so the router explores
        # it again: the decisions stay timing-free and are the reference's
        assert whys(pcs) == whys(rcs) and whys(pcs)[0] == ("fuse", True, "explore-fused")
        assert pcs["samples_excluded"] == rcs["samples_excluded"] >= 1
        assert pcs["samples"] == rcs["samples"]
        assert pst == rst


def test_bare_fused_drain_result_mismatch_is_typed(monkeypatch):
    s, stmt1, stmt2 = _mk(PC)
    sched = CoalescingScheduler(max_batch=64, window_s=1e9, fuse=True, resilience=False)
    real = s.execute_fused
    monkeypatch.setattr(s, "execute_fused", lambda calls: real(calls)[:-1])
    t1 = sched.submit(stmt1, {"cutoff": 3})
    t2 = sched.submit(stmt2, {"m": 2})
    sched.flush()
    assert _xs(t1.result()) == [0, 1, 2] and len(_xs(t2.result())) == 8
    assert sched.stats["fused_isolated_retries"] == 2
    assert sched.stats["fused_isolated_errors"] == 0


# ---------------------------------------------------------------------------
# the fusion oracle on the port
# ---------------------------------------------------------------------------

_FRONTEND = ("scan", "col", "lit", "param", "udf", "sum_", "min_", "max_", "avg_",
             "count_", "case", "var", "exists", "not_exists", "scalar_subquery",
             "FROID", "HEKATON", "INTERPRETED", "UdfBuilder")
_CU_FUNCS = ("param_query", "fusion_queries", "fusion_calls_spec", "overlap_query",
             "overlap_param_names", "overlap_queue", "facts_data", "populate_session",
             "make_session")


def _cu():
    """``conformance_util``'s query, queue and session functions, rebound to
    the port's frontend: the same code, with ``repro_torch.core``'s
    constructors, scalar module and a CPU ``Session`` in its globals."""
    g = dict(vars(CU))
    g.update({name: getattr(PC, name) for name in _FRONTEND})
    g.update(S=PS, Session=lambda: PC.Session(device="cpu"))
    ns = types.SimpleNamespace()
    for name in _CU_FUNCS:
        f = getattr(CU, name)
        g[name] = types.FunctionType(f.__code__, g, name, f.__defaults__, f.__closure__)
        setattr(ns, name, g[name])
    return ns


PCU = _cu()


def _udf_session(seed, n_rows, cu):
    db = cu.make_session(seed, n_rows)
    M = PC if cu is PCU else RC
    db.create_function(_program_udf(M, PROGRAMS["uncorrelated_sum_case"](M)))
    return db


def test_rebound_functions_match_the_reference():
    """The rebound functions make the reference's statements: the same FROID
    plans, and the same queue."""
    ref, port = CU.make_session(3, 23), _udf_session(3, 23, PCU)
    ref.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
    for rq, pq in zip(CU.fusion_queries(), PCU.fusion_queries()):
        assert _norm(port.explain(pq)) == _norm(ref.explain(rq))
    assert PCU.fusion_calls_spec() == CU.fusion_calls_spec()
    specs = [("nested", "val_gt", "p"), ("agg", "lit", "q")]
    rqs, rcalls = CU.overlap_queue(specs, [1.5, 3.0, 8.0])
    pqs, pcalls = PCU.overlap_queue(specs, [1.5, 3.0, 8.0])
    assert pcalls == rcalls
    for rq, pq in zip(rqs, pqs):
        assert _norm(port.explain(pq)) == _norm(ref.explain(rq))


def check_fusion_oracle_port(seed, n_rows, policy, calls_spec=None, *, queries=None,
                             ddl=False, expect_fused=True, ref_policy=None):
    """``conformance_util.check_fusion_oracle`` on the port: the queue
    through a fusion-mode scheduler == the serial loop afterwards (under
    any DDL landed between submit and drain) and, with ``ref_policy``, ==
    the reference's fused drain of the same queue, stats included."""
    db = _udf_session(seed, n_rows, PCU)
    qs = queries[1] if queries is not None else PCU.fusion_queries()
    stmts = [db.prepare(q, policy) for q in qs]
    spec = calls_spec if calls_spec is not None else PCU.fusion_calls_spec()
    sched = CoalescingScheduler(max_batch=256, window_s=10.0, clock=lambda: 0.0, fuse=True)
    tickets = [sched.submit(stmts[i], p) for i, p in spec]
    if ddl:
        rng = np.random.default_rng(seed + 1)
        db.create_table(
            "facts", fk=rng.integers(0, CU.N_KEYS, max(n_rows, 1)),
            val=np.round(rng.uniform(-10, 10, max(n_rows, 1)), 2).astype(np.float32),
            qty=rng.integers(0, 9, max(n_rows, 1)))
    sched.flush()
    fused = [t.result() for t in tickets]
    serial = [stmts[i].execute(params=p) for i, p in spec]
    for j, (s, f) in enumerate(zip(serial, fused)):
        CU.assert_rows_equal(s, f, f"fused[{j}] vs serial")
    fusable = policy.compile_plan and policy.fuse
    if expect_fused == "auto":
        expect_fused = len({id(stmts[i]) for i, _ in spec}) >= 2
    if expect_fused and fusable:
        st = next(r.stats for r in fused if r.stats.get("fused"))
        assert st["fused_programs"] < st["fused_statements"], st
        assert st["shared_subtrees"] + st["cse_templates"] >= 1, st
        assert sched.stats["fused_batches"] >= 1
    elif not fusable:
        assert all("fused" not in r.stats for r in fused)
    if ref_policy is not None:
        ref = CU.make_session(seed, n_rows)
        ref.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
        rqs = queries[0] if queries is not None else CU.fusion_queries()
        rstmts = [ref.prepare(q, ref_policy) for q in rqs]
        rsched = RefScheduler(max_batch=256, window_s=10.0, clock=lambda: 0.0, fuse=True)
        rtickets = [rsched.submit(rstmts[i], p) for i, p in spec]
        rsched.flush()
        _assert_ref([t.result() for t in rtickets], fused, "reference fused drain")
        assert sched.stats == rsched.stats
    return fused


@pytest.mark.parametrize("policy", ["FROID", "HEKATON"])
def test_fusion_oracle_modes(policy):
    check_fusion_oracle_port(11, 23, getattr(PC, policy), ref_policy=getattr(RC, policy))


def test_fusion_oracle_interpreted_falls_back():
    check_fusion_oracle_port(12, 23, PC.INTERPRETED, expect_fused=False)


def test_fusion_oracle_fuse_knob_off_falls_back():
    fused = check_fusion_oracle_port(13, 23, PC.FROID.fused(fuse=False))
    assert all("fused" not in r.stats for r in fused)


def test_fusion_oracle_empty_table():
    check_fusion_oracle_port(14, 0, PC.FROID, ref_policy=RC.FROID)


def test_fusion_oracle_ddl_between_submit_and_drain():
    check_fusion_oracle_port(15, 23, PC.FROID, ddl=True)


def _cpu_mesh():
    from repro_torch.launch.mesh import make_small_mesh

    return make_small_mesh(data=4, devices=["cpu"] * 4)


def _assert_ref_rows(want, got):
    """Rows only: the reference's drain here runs on one device, so its
    buckets are the unsharded ones (``test_torch_sharded_many`` holds the
    sharded figures to the reference's under forced host devices)."""
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_masked(w.masked, g.masked, f"reference fused drain[{i}]")


def test_fusion_oracle_sharded():
    """``tests/test_fused.py::test_fusion_oracle_sharded`` on the port: 8
    tickets a statement make every member bucket divide the 4 positions;
    the wave runs sharded and equals serial and the reference's drain."""
    spec = ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
            + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(8)]
            + [(2, None) for _ in range(8)])
    fused = check_fusion_oracle_port(16, 23, PC.FROID.sharded(_cpu_mesh()), spec)
    _assert_ref_rows(CU.check_fusion_oracle(16, 23, RC.FROID, spec), fused)
    sts = [r.stats for r in fused if r.stats.get("fused")]
    assert len(sts) == len(spec)
    assert all(st.get("sharded") and st["shard_devices"] == 4 for st in sts)


@pytest.mark.parametrize("small", [3, 2], ids=["bucket4", "padded"])
def test_fusion_oracle_sharded_mixed_divisibility(small):
    """``tests/test_fused.py::test_fusion_oracle_sharded_mixed_divisibility``
    on the port: one member of 8 tickets, one of ``small`` and a
    parameter-free one.  The wave shards; a member whose bucket does not
    divide the 4 positions (2 tickets: bucket 2) pads up to 4, and every
    ticket equals serial and the reference's rows."""
    spec = ([(0, {"cut": int(k % 6), "shift": 0.5}) for k in range(8)]
            + [(1, {"minq": int(k % 4), "scale": 2.0}) for k in range(small)]
            + [(2, None) for _ in range(2)])
    fused = check_fusion_oracle_port(17, 23, PC.FROID.sharded(_cpu_mesh()), spec)
    _assert_ref_rows(CU.check_fusion_oracle(17, 23, RC.FROID, spec), fused)
    sts = [r.stats for r in fused if r.stats.get("fused")]
    assert len(sts) == len(spec)
    assert all(st.get("sharded") and st["shard_devices"] == 4 for st in sts), sts[0]
    member1 = fused[8].stats
    assert member1["batch_bucket"] == 4 and member1["batch_size"] == small
    assert fused[0].stats["batch_bucket"] == 8
    assert fused[-1].stats["batch_bucket"] == 1


#: ``tests/test_fuse_cse.py::FIXED_OVERLAP_QUEUES``
FIXED_OVERLAP_QUEUES = [
    ([("proj", "qty_ge", "p"), ("agg", "qty_ge", "q")], [2, 5, 2, 7, 5]),
    ([("nested", "none", "p"), ("nested", "val_gt", "q"), ("proj", "lit", "p")],
     [1.5, 3.0, 1.5, 8.0]),
    ([("agg", "lit", "p"), ("proj", "lit", "q"), ("proj", "none", "p")], [0, 0, 0]),
    ([("proj", "val_gt", "p"), ("proj", "val_gt", "p"), ("agg", "none", "q")],
     [4.0, 9.0, 4.0, 2.0]),
]


@pytest.mark.parametrize("policy", ["FROID", "HEKATON"])
@pytest.mark.parametrize("case_i", range(len(FIXED_OVERLAP_QUEUES)))
def test_fixed_overlap_queues(policy, case_i):
    specs, values = FIXED_OVERLAP_QUEUES[case_i]
    rqs, calls = CU.overlap_queue(specs, values)
    pqs, _ = PCU.overlap_queue(specs, values)
    check_fusion_oracle_port(20 + case_i, 23, getattr(PC, policy), calls, queries=(rqs, pqs),
                             expect_fused="auto", ref_policy=getattr(RC, policy))


def test_overlap_spec_space_is_covered():
    from test_fuse_cse import FIXED_OVERLAP_QUEUES as REF_QUEUES

    assert FIXED_OVERLAP_QUEUES == REF_QUEUES
    bodies = {b for specs, _ in FIXED_OVERLAP_QUEUES for b, _, _ in specs}
    filters = {f for specs, _ in FIXED_OVERLAP_QUEUES for _, f, _ in specs}
    assert bodies == set(CU.OVERLAP_BODIES) and filters == set(CU.OVERLAP_FILTERS)


# ---------------------------------------------------------------------------
# the chaos oracle's unsharded FROID legs on the port
# ---------------------------------------------------------------------------


class Clock:
    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now


def check_chaos_oracle_port(seed, n_rows, fault_specs=(), *, chaos_seed=None, rate=0.3,
                            sites=("compile", "dispatch", "sync"), max_faults=None,
                            timeout_s=None, clock=None, resilience=None):
    """``conformance_util.check_chaos_oracle`` on the port: a fault-free
    serial oracle session, and a chaos session with the injector installed
    draining the queue through a fusion-mode resilient scheduler; every
    ticket is done, and equals the oracle or raises a typed
    ``ResilienceError``."""
    oracle = _udf_session(seed, n_rows, PCU)
    qs, spec = PCU.fusion_queries(), PCU.fusion_calls_spec()
    o_stmts = [oracle.prepare(q, PC.FROID) for q in qs]
    expected = [o_stmts[i].execute(params=p) for i, p in spec]
    db = _udf_session(seed, n_rows, PCU)
    stmts = [db.prepare(q, PC.FROID) for q in PCU.fusion_queries()]
    if chaos_seed is not None:
        fi = FaultInjector.seeded(chaos_seed, rate, sites=sites, max_faults=max_faults)
        fi.specs = list(fault_specs)
    else:
        fi = FaultInjector(fault_specs)
    fi.install(db)
    kwargs = {} if resilience is None else {"resilience": resilience}
    if clock is not None:
        kwargs["clock"] = clock
    sched = CoalescingScheduler(max_batch=256, window_s=10.0, fuse=True,
                                default_timeout_s=timeout_s, sleep=lambda s: None, **kwargs)
    tickets = [sched.submit(stmts[i], p) for i, p in spec]
    sched.flush()
    outcomes = []
    interp_faultable = "interp" in sites or any(
        getattr(s, "site", None) in ("interp", "*") for s in fault_specs)
    for j, t in enumerate(tickets):
        assert t.done(), f"chaos: ticket[{j}] not done after flush"
        try:
            r = t.result()
        except ResilienceError as e:
            outcomes.append(("error", e))
            continue
        CU.assert_rows_equal(expected[j], r, f"chaos[{j}] vs fault-free oracle")
        outcomes.append(("ok", r))
    if not interp_faultable and timeout_s is None:
        assert all(kind == "ok" for kind, _ in outcomes), outcomes
    return {"outcomes": outcomes, "stats": dict(sched.stats),
            "resilience": sched.resilience_stats, "injector": fi}


@pytest.mark.parametrize("site", ["compile", "dispatch", "sync"])
@pytest.mark.parametrize("times", [1, 3, None])
def test_chaos_fixed_schedule_recovers(site, times):
    out = check_chaos_oracle_port(5, 23, [FaultSpec(site=site, times=times)])
    assert all(kind == "ok" for kind, _ in out["outcomes"])
    if times is None:
        assert out["stats"]["tier_interp_ok"] >= 1


def test_chaos_interp_floor_faults_are_typed():
    out = check_chaos_oracle_port(5, 23, [FaultSpec(site="*", times=None)],
                                  sites=("compile", "dispatch", "sync", "interp"))
    assert all(kind == "error" for kind, _ in out["outcomes"])
    assert out["stats"]["ladder_exhausted"] == len(out["outcomes"])


def test_chaos_targeted_statement_fault():
    fp = _udf_session(5, 23, PCU).prepare(PCU.fusion_queries()[1], PC.FROID)._query_fp
    out = check_chaos_oracle_port(5, 23, [FaultSpec(site="dispatch", stmt=fp, times=None)])
    assert all(kind == "ok" for kind, _ in out["outcomes"])
    assert out["stats"]["demote_fused_to_many"] >= 2
    assert all(site == "dispatch" for site, _, _ in out["injector"].injected)


def test_chaos_open_breaker_still_conformant():
    cfg = ResilienceConfig(breaker=BreakerConfig(failure_threshold=1, window_s=100.0,
                                                 cooldown_s=1e9))
    out = check_chaos_oracle_port(5, 23, [FaultSpec(site="dispatch", times=None)],
                                  resilience=cfg, clock=Clock())
    assert all(kind == "ok" for kind, _ in out["outcomes"])
    assert sum(b["opened"] for b in out["resilience"]["breakers"].values()) >= 1


def test_chaos_half_open_probe_still_conformant():
    cfg = ResilienceConfig(breaker=BreakerConfig(failure_threshold=1, window_s=100.0,
                                                 cooldown_s=0.0))
    out = check_chaos_oracle_port(5, 23, [FaultSpec(site="dispatch", times=1)],
                                  resilience=cfg, clock=Clock())
    assert all(kind == "ok" for kind, _ in out["outcomes"])


@pytest.mark.parametrize("chaos_seed", [0, 1, 2, 3, 4])
def test_chaos_seeded_sweep(chaos_seed):
    out = check_chaos_oracle_port(7, 23, chaos_seed=chaos_seed, rate=0.4)
    assert all(kind == "ok" for kind, _ in out["outcomes"])


def test_chaos_seeded_sweep_with_interp_faults():
    out = check_chaos_oracle_port(7, 23, chaos_seed=2, rate=0.5,
                                  sites=("compile", "dispatch", "sync", "interp"))
    for kind, v in out["outcomes"]:
        assert kind == "ok" or isinstance(v, ResilienceError)


def test_chaos_deadline_under_faults():
    class Step:
        def __init__(self):
            self.now = 0.0

        def __call__(self):
            self.now += 0.5
            return self.now

    out = check_chaos_oracle_port(5, 23, [FaultSpec(site="dispatch", times=2)], clock=Step(),
                                  timeout_s=4.0)
    for kind, v in out["outcomes"]:
        assert kind == "ok" or isinstance(v, ResilienceError)


# ---------------------------------------------------------------------------
# relagg: a GroupAgg shared across members, pallas_agg on
# ---------------------------------------------------------------------------


def _count_plain_calls(monkeypatch, calls):
    """Count relagg's plain versions, the unbatched and the batched, and
    add each call to ``ops.LAUNCHES`` (the batched to ``BATCHED_LAUNCHES``
    too) as a launch on the card adds: on the CPU the wrapper takes them
    without counting."""
    real, real_batched = relagg_ops.grouped_aggregate_ref, relagg_ops.grouped_aggregate_batched_ref

    def plain(*args, **kw):
        calls["plain"] += 1
        relagg_ops.LAUNCHES += 1
        return real(*args, **kw)

    def batched(*args, **kw):
        calls["batched"] += 1
        relagg_ops.LAUNCHES += 1
        relagg_ops.BATCHED_LAUNCHES += 1
        return real_batched(*args, **kw)

    monkeypatch.setattr(relagg_ops, "grouped_aggregate_ref", plain)
    monkeypatch.setattr(relagg_ops, "grouped_aggregate_batched_ref", batched)


def _grouped_detail(M, pname):
    return (M.scan("detail").filter(M.col("d_val") <= M.param(pname))
            .group_by("cat", s=M.sum_(M.col("d_val")), c=M.count_()))


def test_shared_group_agg_reaches_relagg_once(monkeypatch):
    """``pallas_agg`` on: the decorrelated GroupAgg over ``detail`` that two
    ``key_total`` members share runs once, in the constant pool, through
    relagg's plain version on the CPU; a member's parameterized GroupAgg
    runs batched, one batched call for the member (one
    ``BATCHED_LAUNCHES`` on the card).  Per statement, the build runs
    once a ``key_total`` statement."""
    rng = np.random.default_rng(5)
    cats = np.array(["air", "rail", "ship", "truck"])
    arrays = dict(d_key=rng.integers(0, 50, 3000),
                  d_val=rng.uniform(0, 100, 3000).astype(np.float32),
                  cat=cats[rng.integers(0, 4, 3000)])

    def populate(M, db):
        _populate(M, db)
        db.create_table("detail", **arrays)

    pair = Pair(populate)
    pol = (RC.ExecutionPolicy(name="froid+relagg", pallas_agg=True),
           PC.ExecutionPolicy(name="froid+relagg", pallas_agg=True))
    pair.prep(_q_udf, pol)
    pair.prep(lambda M: M.scan("T").compute(v=M.udf("key_total", M.col("a")) / M.param("div"))
              .project("v"), pol)
    pair.prep(lambda M: _grouped_detail(M, "v"), pol)
    calls = {"plain": 0, "batched": 0}
    _count_plain_calls(monkeypatch, calls)
    spec = ([(0, {"cutoff": c}) for c in (10, 30, 45)] + [(1, {"div": d}) for d in (2.0, 4.0)]
            + [(2, {"v": v}) for v in (20.0, 60.0, 90.0)])
    got = pair.port.execute_fused(pair.calls(spec, "port"))
    # the shared build once, unbatched; the grouped member once, batched
    assert calls == {"plain": 1, "batched": 1}, calls
    want = pair.ref.execute_fused(pair.calls(spec, "ref"))
    _assert_ref(want, got, "relagg fused")
    calls.update(plain=0, batched=0)
    per_stmt = [pair.p[i].execute_many([p for j, p in spec if j == i]) for i in range(3)]
    assert calls == {"plain": 2, "batched": 1}, calls
    _assert_same([r for rs in per_stmt for r in rs], got)


# ---------------------------------------------------------------------------
# serving pass-through
# ---------------------------------------------------------------------------


def test_admission_policy_fuse_adaptive_passthrough():
    from repro_torch.serve.admission import AdmissionPolicy

    ap = AdmissionPolicy(froid=True, fuse=True, adaptive=True, device="cpu")
    assert ap.scheduler.fuse and ap.scheduler.adaptive
    reqs = {"tier": np.array([0, 2]), "prompt_len": np.array([100, 9000]),
            "max_new_tokens": np.array([50, 800]),
            "temperature": np.array([0.5, 0.7], np.float32)}
    tick, co = ap.evaluate(reqs), ap.evaluate_coalesced(reqs)
    np.testing.assert_array_equal(tick["admit"], co["admit"])
    np.testing.assert_array_equal(tick["granted"], co["granted"])


def test_serve_engine_fuse_passthrough():
    from repro_torch.serve.engine import ServeEngine

    class _Model:
        device = torch.device("cpu")

    eng = ServeEngine(_Model(), admission_fuse=True, admission_adaptive=True)
    assert eng.admission.scheduler.fuse and eng.admission.scheduler.adaptive


# ---------------------------------------------------------------------------
# chip_smoke.py's copy of the fusion benchmark's queues
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_fused", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_queues_are_the_benchmark_queues(smoke):
    """``chip_smoke.py``'s ``fused_queries`` / ``overlap_queries`` /
    ``mixed_queue`` / ``overlap_queue`` make ``benchmarks/bench_fused.py``'s
    statements (the same FROID plans) and queues (the same parameters)."""
    import benchmarks.bench_fused as bench

    ref = _session(RC)
    port = _session(PC)
    _populate(RC, ref, n_detail=300, n_t=40)
    _populate(PC, port, n_detail=300, n_t=40)
    for rq, pq in zip(bench._queries() + bench._overlap_queries(),
                      smoke.fused_queries() + smoke.overlap_queries()):
        assert _norm(port.explain(pq)) == _norm(ref.explain(rq))
    rstmts = [ref.prepare(q, RC.FROID) for q in bench._queries()]
    pstmts = [port.prepare(q, PC.FROID) for q in smoke.fused_queries()]
    rq, pq = bench._mixed_queue(rstmts, 64), smoke.mixed_queue(pstmts, 64)
    assert [(rstmts.index(s), p) for s, p in rq] == [(pstmts.index(s), p) for s, p in pq]
    rstmts = [ref.prepare(q, RC.FROID) for q in bench._overlap_queries()]
    pstmts = [port.prepare(q, PC.FROID) for q in smoke.overlap_queries()]
    rq, pq = bench._overlap_queue(rstmts, 64), smoke.overlap_queue(pstmts, 64)
    assert [(rstmts.index(s), p) for s, p in rq] == [(pstmts.index(s), p) for s, p in pq]
    assert len({v for _, p in pq for v in p.values()}) <= 8


def test_chip_smoke_fused_phase_rehearsal(smoke, monkeypatch):
    """The fused phase's checks at a small size on the CPU: the mixed queue
    through both drains == the serial loop == float64, relagg's shared
    build launched once a fused wave and once a ``key_total`` statement
    per statement (its plain version counted as a launch here); the
    overlap queue's pool evaluations and distinct cutoffs at the
    figures the phase holds the card to."""
    _count_plain_calls(monkeypatch, {"plain": 0, "batched": 0})
    out = smoke.fused_mixed("cpu", 3000, smoke.FUSED_PER_STMT, rounds=1, timed=False)
    assert out["mixed"]["fused"]["relagg_launches"] == 1
    assert out["mixed"]["perstmt"]["relagg_launches"] == 3
    assert out["overlap"]["fused"]["cse_bindings"] <= 8


def test_chip_smoke_fusion_oracle_is_the_harness_oracle(smoke):
    """``chip_smoke.py``'s copy of the fusion oracle (tables, UDF,
    statements, queue) is ``conformance_util``'s: the same tables and FROID
    plans, the same queue, and its fused drain on the CPU equals the
    reference's fused drain and its own serial loop."""
    ref = CU.make_session(3, 23)
    ref.create_function(CU.build_udf(CU.FIXED_PROGRAMS["uncorrelated_sum_case"]).build())
    port = smoke.fusion_oracle_session(23, "cpu")
    tables = smoke.fusion_tables(23)
    for name, want in CU.facts_data(3, 23).items():
        np.testing.assert_array_equal(tables["facts"][name], want)
    np.testing.assert_array_equal(tables["keys"]["k"], np.arange(CU.N_KEYS))
    assert smoke.FUSION_CALLS == CU.fusion_calls_spec()
    for rq, pq in zip(CU.fusion_queries(), smoke.fusion_oracle_queries()):
        assert _norm(port.explain(pq)) == _norm(ref.explain(rq))
    for policy in ("FROID", "HEKATON"):
        fused, serial, st = smoke.fusion_oracle_run(23, policy, "cpu")
        for j, (s, f) in enumerate(zip(serial, fused)):
            smoke.same_masked(s, f, f"{policy}[{j}]")
        rstmts = [ref.prepare(q, getattr(RC, policy)) for q in CU.fusion_queries()]
        want = ref.execute_fused([(rstmts[i], p) for i, p in CU.fusion_calls_spec()])
        _assert_ref(want, fused, f"chip_smoke oracle {policy}")
        assert st["fused_programs"] < st["fused_statements"]
