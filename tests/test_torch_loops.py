"""The port's cursor-loop rewrite (``repro_torch.loops``, the algebrizer's
``emit_loop``), its ``LoopScan`` operator and the correlated scalar
subquery that binds a loop's outputs, against the reference's, on the CPU.

* Analysis: ``classify`` gives the reference's verdict (rewritable, kind,
  reason, written, locals) for every loop spec of
  ``conformance_util.build_loop_udf`` (each built with either package's
  builder), for the T-SQL texts of ``tests/test_loops.py`` and
  ``examples/cursor_loops.py``, and for each shape the rewrite refuses;
  the algebrizer raises the same ``AlgebrizeError`` for those.
* Plans: FROID's ``explain()`` equals the reference's; a loop the rewrite
  refuses keeps its ``UdfCall`` in both.
* Rows: the port's FROID (a ``LoopScan``) equals the reference's FROID and
  the port's INTERPRETED and HEKATON, which equal the reference's: counts,
  keys and validity exactly, floats to rtol 1e-4.  Fixed replays of
  ``tests/test_loops.py``, an empty cursor (``x < 0``) and an empty
  ``facts``.  The loop oracle's ``execute_many`` legs
  (``conformance_util.check_loop_oracle``): the port's ``execute_many``
  under FROID, unsharded and sharded over four CPU mesh positions, equals
  its serial loop and the reference's.
* The scan kind keeps each carry at its loop-entry dtype after every row,
  steps the rows in order and reads nothing back to the host.
* A correlated EXISTS, a correlated Apply over a general subplan and a
  GroupAgg inside a correlated scalar subquery (``pallas_agg`` on or off)
  run under the same vmap and equal the reference's; the relagg wrapper
  batches a vmapped input and never takes its unbatched plain version on
  it (``tests/test_torch_correlated.py`` holds the rest).
"""
import numpy as np
import pytest
import torch

import repro.core as RC
from repro.core import algebrizer as RA
from repro.core import ir as RIR
from repro.core import relalg as RR
from repro.core import scalar as RS
from repro.core.executor import Executor as RefExecutor
from repro.core.tsql import parse_udf as ref_parse
from repro.loops import classify as ref_classify
import repro_torch.core as PC
from repro_torch.core import algebrizer as PA
from repro_torch.core import ir as PIR
from repro_torch.core import relalg as PR
from repro_torch.core import scalar as PS
from repro_torch.core.tsql import parse_udf as port_parse
from repro_torch.kernels.relagg import ops as relagg_ops
from repro_torch.launch.mesh import make_small_mesh
from repro_torch.loops import LoopVerdict, classify as port_classify

from conformance_util import LOOP_BODIES, build_loop_udf, expected_loop_kind
from test_loops import CURSOR_GUARD_BREAK, CURSOR_SUM, PLAIN_WHILE
from test_torch_interpreter import (
    EXAMPLE,
    ITERATIVE,
    _facts_tables,
    _keys_query,
    _loop_udf,
    _oracle,
    _policy,
    assert_rows,
)
from test_torch_correlated import no_vmap_fallback
from test_torch_session_tpch import _norm_explain

#: every body of ``conformance_util.LOOP_BODIES`` with and without an
#: extra guard and a BREAK (a plain WHILE takes neither)
SPECS = [(b, g, k) for b in LOOP_BODIES if b != "plain_while"
         for g in (None, 40.0) for k in (None, 15.0)] + [("plain_while", None, None)]
SPEC_IDS = ["-".join(map(str, s)) for s in SPECS]

TEXTS = {"CURSOR_SUM": (CURSOR_SUM, "cursor_total"),
         "CURSOR_GUARD_BREAK": (CURSOR_GUARD_BREAK, "cursor_capped"),
         "PLAIN_WHILE": (PLAIN_WHILE, "wsum"),
         "CURSOR_TOTAL": (EXAMPLE["CURSOR_TOTAL"], "cursor_total"),
         "PLAIN": (EXAMPLE["PLAIN"], "countdown")}


def _loop_of(udf, IR):
    return next(s for s in udf.body if isinstance(s, (IR.While, IR.CursorLoop)))


def _same_verdict(ref, port, label):
    assert isinstance(port, LoopVerdict), label
    for field in ("rewritable", "kind", "reason", "written", "locals"):
        assert getattr(port, field) == getattr(ref, field), f"{label}: {field}"
    assert str(port) == str(ref), label


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_classify_loop_spec_matches_reference(spec):
    ref_udf, port_udf = _loop_udf(RC, *spec), _loop_udf(PC, *spec)
    # the twin builds what conformance_util builds
    assert repr(ref_udf) == repr(build_loop_udf(*spec).build())
    ref_v = ref_classify(_loop_of(ref_udf, RIR))
    port_v = port_classify(_loop_of(port_udf, PIR))
    _same_verdict(ref_v, port_v, str(spec))
    kind = expected_loop_kind(*spec)
    assert port_v.rewritable == (kind is not None)
    assert port_v.kind == (kind or "")


@pytest.mark.parametrize("name", list(TEXTS))
def test_classify_tsql_matches_reference(name):
    text, _ = TEXTS[name]
    ref_v = ref_classify(_loop_of(ref_parse(text), RIR))
    port_v = port_classify(_loop_of(port_parse(text), PIR))
    _same_verdict(ref_v, port_v, name)


def _refused(M, IR, shape):
    """A cursor loop of one shape the rewrite refuses, in either package."""
    inner = _loop_of(_loop_udf(M, "sum"), IR)
    facts = M.scan("facts").node
    body = {
        "nested": [inner],
        "return": [IR.Return(M.var("t"))],
        "fetch": [IR.Fetch("c", [("v", "val")])],
        "subquery": [IR.Assign("t", M.scalar_subquery(
            M.scan("facts").agg(s=M.sum_(M.col("val")))))],
        "udf_call": [IR.Assign("t", M.var("t") + M.udf("g", M.var("v")))],
        "nondeterministic": [IR.Assign("t", M.var("t") + M.func("rand"))],
    }.get(shape, [IR.Assign("t", M.var("t") + M.var("v"))])
    plan = (M.scan("facts").filter(M.udf("g", M.col("fk")) > 0.0).node
            if shape == "udf_in_query" else facts)
    return IR.CursorLoop("c2", plan, [("v", "val")], body, None)


REFUSED = ["nested", "return", "fetch", "subquery", "udf_call",
           "nondeterministic", "udf_in_query"]


@pytest.mark.parametrize("shape", REFUSED)
def test_refused_loop_same_verdict_and_algebrize_error(shape):
    loops = {}
    for M, IR, classify, A in ((RC, RIR, ref_classify, RA),
                               (PC, PIR, port_classify, PA)):
        loop = _refused(M, IR, shape)
        udf = IR.UdfDef("f", [("x", "float32")], "float32",
                        [IR.Declare("t", "float32", M.lit(0.0)),
                         IR.Declare("v", "float32", None), loop,
                         IR.Return(M.var("t"))])
        with pytest.raises(A.AlgebrizeError) as err:
            A.algebrize(udf)
        loops[M] = (classify(loop), str(err.value))
    (ref_v, ref_err), (port_v, port_err) = loops[RC], loops[PC]
    _same_verdict(ref_v, port_v, shape)
    assert not port_v.rewritable
    assert port_err == ref_err


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def _sessions(tables, build):
    ref, port = RC.Session(), PC.Session(device="cpu")
    for name, arrays in tables.items():
        ref.create_table(name, **arrays)
        port.create_table(name, **arrays)
    ref.create_function(build(RC))
    port.create_function(build(PC))
    return ref, port


def _has_call(plan, R, S):
    return any(isinstance(e, S.UdfCall) for n in R.walk_plan_deep(plan)
               for ex in n.exprs() for e in S.walk(ex))


def _loop_kinds(plan, R):
    return [n.kind for n in R.walk_plan_deep(plan) if isinstance(n, R.LoopScan)]


def _check_plan(ref, port, fname, kind):
    rstmt = ref.prepare(_keys_query(RC, fname), RC.FROID)
    pstmt = port.prepare(_keys_query(PC, fname), PC.FROID)
    assert _norm_explain(pstmt.explain()) == _norm_explain(rstmt.explain())
    if kind is None:
        assert _has_call(pstmt.plan, PR, PS) and not _loop_kinds(pstmt.plan, PR)
    else:
        assert _loop_kinds(pstmt.plan, PR) == [kind]
        assert not _has_call(pstmt.plan, PR, PS)
        assert f"LoopScan[{kind}]" in pstmt.explain()


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_froid_plan_of_loop_spec_matches_reference(spec):
    ref, port = _sessions(_facts_tables(), lambda M: _loop_udf(M, *spec))
    _check_plan(ref, port, "floop", expected_loop_kind(*spec))


TEXT_KINDS = {"CURSOR_SUM": "reduce", "CURSOR_GUARD_BREAK": "scan",
              "PLAIN_WHILE": None, "CURSOR_TOTAL": "scan", "PLAIN": None}


@pytest.mark.parametrize("name", list(TEXTS))
def test_froid_plan_of_tsql_matches_reference(name):
    text, fname = TEXTS[name]
    ref, port = _sessions(_facts_tables(), lambda M: (ref_parse if M is RC
                                                      else port_parse)(text))
    _check_plan(ref, port, fname, TEXT_KINDS[name])


# ---------------------------------------------------------------------------
# rows: port FROID (LoopScan) == reference FROID == INTERPRETED == HEKATON
# ---------------------------------------------------------------------------

#: ``loop_param_query``'s parameter sets, and one whose every cursor is
#: empty (``x = k + shift < 0`` for every key)
PARAMS = [{"cut": 5, "shift": 0.5}, {"cut": 7, "shift": -1.0},
          {"cut": 6, "shift": -20.0}]


def _many_leg(spec, seed, n_rows, params_list):
    """``check_loop_oracle``'s ``execute_many`` legs: the port's FROID
    batch, unsharded and sharded over four CPU mesh positions, == its
    serial loop == the reference's serial loop (the scan kind steps its
    rows once for the whole batch, once a shard)."""
    ref, port = _sessions(_facts_tables(n_rows, seed), lambda M: _loop_udf(M, *spec))
    q = lambda M: _keys_query(M, "floop")
    stmt = port.prepare(q(PC), PC.FROID)
    mesh = make_small_mesh(data=4, devices=["cpu"] * 4)
    with no_vmap_fallback():
        serial = [stmt.execute(params=p) for p in params_list]
        legs = {"many": stmt.execute_many(params_list),
                "sharded": port.prepare(q(PC), PC.FROID.sharded(mesh))
                .execute_many(params_list)}
    rstmt = ref.prepare(q(RC), RC.FROID)
    for label, batched in legs.items():
        for i, p in enumerate(params_list):
            assert batched[i].stats["batched"]
            # bucket 4 splits over the 4 positions; buckets 1 and 2 replicate
            assert batched[i].stats.get("sharded", False) == (
                label == "sharded" and len(params_list) > 2)
            assert_rows(serial[i], batched[i], f"{label}[{i}] vs serial")
            assert_rows(rstmt.execute(params=p), batched[i], f"reference[{i}] vs {label}")


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_loop_rows_match_reference_and_iterative(spec):
    _oracle(lambda M: _loop_udf(M, *spec), "floop", 2, 29, PARAMS)
    _many_leg(spec, 2, 29, PARAMS)


#: ``tests/test_loops.py::test_loop_oracle_fixed_replay``'s samples
REPLAYS = [(("sum_if", None, None), 0, 23, [{"cut": 5, "shift": 0.5}]),
           (("running", 10.0, 75.0), 1, 23, [{"cut": 6, "shift": -1.0},
                                              {"cut": 3, "shift": 2.0}])]


@pytest.mark.parametrize("replay", REPLAYS, ids=lambda r: "-".join(map(str, r[0])))
def test_loop_oracle_fixed_replay(replay):
    spec, seed, n_rows, params = replay
    _oracle(lambda M: _loop_udf(M, *spec), "floop", seed, n_rows, params)
    _many_leg(spec, seed, n_rows, params)


@pytest.mark.parametrize("body", ["sum", "running"])
def test_loop_rows_empty_facts(body):
    _oracle(lambda M: _loop_udf(M, body), "floop", 0, 0, PARAMS[:1])
    _many_leg((body, None, None), 0, 0, PARAMS)


@pytest.mark.parametrize("name", ["CURSOR_SUM", "CURSOR_GUARD_BREAK", "CURSOR_TOTAL"])
def test_tsql_loop_rows_match_reference(name):
    text, fname = TEXTS[name]
    ref, port = _sessions(_facts_tables(31, seed=3),
                          lambda M: (ref_parse if M is RC else port_parse)(text))
    q = lambda M: _keys_query(M, fname)
    for p in PARAMS:
        froid = port.execute(q(PC), PC.FROID, params=p)
        assert "udf_rows" not in froid.stats
        assert_rows(ref.execute(q(RC), RC.FROID, params=p), froid, f"{name} {p}")
        for policy in ITERATIVE:
            got = port.execute(q(PC), _policy(PC, policy), params=p)
            assert_rows(froid, got, f"{name} {policy} {p}", across_policies=True)


# ---------------------------------------------------------------------------
# the scan kind: carry dtypes, row order, no host reads
# ---------------------------------------------------------------------------


def _int_carry(M, kind):
    """An int32 accumulator plus a float32 term: the reduce kind widens the
    result to float32; the scan kind (forced by a guard) casts the carry
    back to int32 after every row, truncating as it goes."""
    u = M.UdfBuilder("icarry", [("x", "float32")], "float32")
    u.declare("t", "int32", M.lit(0))
    u.declare("v", "float32", None)
    guard = None if kind == "reduce" else M.var("t") < M.lit(1000)
    with u.cursor_loop({"v": "val"}, M.scan("facts"),
                       where=M.col("fk") <= M.param("x"), guard=guard):
        u.set("t", M.var("t") + M.var("v") * 0.75)
    u.return_(M.var("t"))
    return u.build()


@pytest.mark.parametrize("kind", ["reduce", "scan"])
def test_loop_carry_keeps_its_loop_entry_dtype(kind):
    tables = _facts_tables(17, seed=4)
    ref, port = _sessions(tables, lambda M: _int_carry(M, kind))
    q = lambda M: M.scan("keys").compute(out=M.udf("icarry", M.col("k") * 1.0))
    pstmt = port.prepare(q(PC), PC.FROID)
    assert _loop_kinds(pstmt.plan, PR) == [kind]
    got = pstmt.execute()
    assert_rows(ref.execute(q(RC), RC.FROID), got, kind)
    facts = tables["facts"]
    want = []
    for k in tables["keys"]["k"]:
        terms = facts["val"][facts["fk"] <= k].astype(np.float32) * np.float32(0.75)
        if kind == "reduce":
            want.append(np.float32(np.sum(terms, dtype=np.float64)))
        else:
            t = np.int32(0)
            for term in terms:  # int32 after every row, truncated toward 0
                t = np.int32(np.trunc(np.float32(t) + term))
            want.append(np.float32(t))
    np.testing.assert_allclose(got.table.columns["out"].data.numpy(), want,
                               rtol=1e-4, atol=1e-4)


def _froid_plan(text, fname, tables):
    port = PC.Session(device="cpu")
    for name, arrays in tables.items():
        port.create_table(name, **arrays)
    port.create_function(port_parse(text))
    q = PC.scan("keys").compute(out=PC.udf(fname, PC.col("k") * 1.0))
    return port, port.prepare(q, PC.FROID).plan


def test_scan_kind_steps_rows_in_order_without_host_reads(monkeypatch):
    """One step list a row, over the cursor's rows in table order, each
    row's values 0-d; the outer rows ride one vmap, and no tensor is read
    back to the host on the way (``item``, ``bool``, ``int``, ``float``
    and ``tolist`` raise while the plan runs)."""
    tables = _facts_tables(11, seed=5)
    port, plan = _froid_plan(EXAMPLE["CURSOR_TOTAL"], "cursor_total", tables)
    seen = []
    loopscan = PC.Executor._loopscan_scan

    def recording(self, node, child, init, ctx):
        seen.append(child.num_rows)
        return loopscan(self, node, child, init, ctx)

    monkeypatch.setattr(PC.Executor, "_loopscan_scan", recording)
    steps = []
    eval_scalar = PS.eval_scalar

    def counting(expr, env, ctx):
        if "val" in env and env["val"].data.dim() == 0:  # a step on one row
            steps.append(env["val"].data.numpy().item())
        return eval_scalar(expr, env, ctx)

    monkeypatch.setattr(PS, "eval_scalar", counting)

    def refuse(*args, **kwargs):
        raise AssertionError("host read inside the loop")

    with monkeypatch.context() as m:
        for attr in ("item", "__bool__", "__int__", "__float__", "tolist"):
            m.setattr(torch.Tensor, attr, refuse)
        res = PC.Executor(port.catalog, device="cpu").execute(plan)
    assert seen == [11]  # one scan of the 11 rows for all 7 keys
    n_steps = len(next(n for n in PR.walk_plan_deep(plan)
                       if isinstance(n, PR.LoopScan)).steps)
    vals = tables["facts"]["val"]
    assert steps == [float(v) for v in vals for _ in range(n_steps)]
    got = res.table.columns["out"].data.numpy()
    want = []
    for k in tables["keys"]["k"]:
        t = np.float32(0.0)
        for fk, v in zip(tables["facts"]["fk"], vals):
            if fk <= k:
                t = np.float32(t * np.float32(0.5) + v)
                if t > 75.0:
                    break
        want.append(t)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the correlated scalar subquery, EXISTS, Apply and GroupAgg under vmap
# ---------------------------------------------------------------------------


def _catalogs(seed=6, n_rows=19):
    ref, port = RC.Session(), PC.Session(device="cpu")
    for name, arrays in _facts_tables(n_rows, seed).items():
        ref.create_table(name, **arrays)
        port.create_table(name, **arrays)
    return ref.catalog, port.catalog


def _corr_sub(M, S, kind):
    """``keys`` with one correlated subquery column over ``facts``."""
    inner = M.scan("facts").filter(M.col("fk") <= S.Outer("k"))
    if kind == "first":
        sub = M.scalar_subquery(inner.compute(w=M.col("val") * 2.0).project("w"))
    elif kind == "groupagg":
        sub = M.scalar_subquery(
            inner.group_by("qty", capacity=9, s=M.sum_(M.col("val"))).project("s"))
    elif kind == "full_agg":
        sub = M.scalar_subquery(inner.agg(s=M.sum_(M.col("val"))))
    else:  # exists
        sub = M.exists(inner)
    return M.scan("keys").compute(out=sub).node


def test_correlated_scalar_subquery_matches_reference():
    rcat, pcat = _catalogs()
    plan_r, plan_p = _corr_sub(RC, RS, "first"), _corr_sub(PC, PS, "first")
    want = RefExecutor(rcat).execute(plan_r)
    got = PC.Executor(pcat, device="cpu").execute(plan_p)
    w, g = want.table.columns["out"], got.table.columns["out"]
    np.testing.assert_array_equal(g.validity().numpy(), np.asarray(w.validity()))
    ok = np.asarray(w.validity())
    np.testing.assert_allclose(g.data.numpy()[ok], np.asarray(w.data)[ok], rtol=1e-6)


def _same_out(want, got):
    w, g = want.table.columns["out"], got.table.columns["out"]
    np.testing.assert_array_equal(g.validity().numpy(), np.asarray(w.validity()))
    ok = np.asarray(w.validity())
    np.testing.assert_allclose(g.data.numpy()[ok], np.asarray(w.data)[ok], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("pallas_agg", [False, True])
@pytest.mark.parametrize("kind", ["groupagg", "full_agg", "exists"])
def test_correlated_shapes_match_reference_on_the_kernel_path(kind, pallas_agg, monkeypatch):
    """A GroupAgg, a full-table aggregate and an EXISTS inside a correlated
    subquery, under vmap: the reference's rows.  relagg's unbatched plain
    version is never called on the batched input; with ``pallas_agg`` on
    the grouped body takes relagg's batched plain version (the CPU's
    stand-in for the batched kernel) once."""
    rcat, pcat = _catalogs()
    plain, batched = [], []
    monkeypatch.setattr(relagg_ops, "grouped_aggregate_ref", lambda *a: plain.append(a))
    many = relagg_ops.grouped_aggregate_batched_ref
    monkeypatch.setattr(relagg_ops, "grouped_aggregate_batched_ref",
                        lambda *a: batched.append(a) or many(*a))
    want = RefExecutor(rcat, use_pallas_agg=pallas_agg).execute(_corr_sub(RC, RS, kind))
    got = PC.Executor(pcat, use_pallas_agg=pallas_agg, device="cpu").execute(
        _corr_sub(PC, PS, kind))
    _same_out(want, got)
    assert not plain
    assert len(batched) == (kind == "groupagg" and pallas_agg)


def test_correlated_apply_over_subplan_matches_reference():
    rcat, pcat = _catalogs()
    plans = {M: R.Apply(M.scan("keys").node,
                        M.scan("facts").filter(M.col("fk") == S.Outer("k")).node,
                        kind="cross")
             for M, R, S in ((RC, RR, RS), (PC, PR, PS))}
    want = RefExecutor(rcat).execute(plans[RC])
    got = PC.Executor(pcat, device="cpu").execute(plans[PC])
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    live = got.mask.numpy()
    for name, c in want.table.columns.items():
        g = got.table.columns[name]
        np.testing.assert_array_equal(g.validity().numpy()[live], np.asarray(c.validity())[live])
        np.testing.assert_allclose(g.data.numpy()[live], np.asarray(c.data)[live], rtol=1e-4)


def test_relagg_wrapper_batches_a_vmapped_input(monkeypatch):
    """Under vmap the wrapper takes the batched plain version on the CPU,
    never the unbatched one, and equals it item by item."""
    gid = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    vals = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    masks = torch.tensor([[1, 1, 0, 1], [0, 1, 1, 1]], dtype=torch.bool)
    one = relagg_ops.grouped_aggregate_ref
    plain = []
    monkeypatch.setattr(relagg_ops, "grouped_aggregate_ref",
                        lambda *a: plain.append(a) or one(*a))
    s, c = torch.func.vmap(lambda m: relagg_ops.grouped_aggregate(gid, m, vals, 3))(masks)
    assert not plain
    for b in range(2):
        s1, c1 = one(gid, masks[b], vals, 3)
        np.testing.assert_array_equal(s[b].numpy(), s1.numpy())
        np.testing.assert_array_equal(c[b].numpy(), c1.numpy())
    relagg_ops.grouped_aggregate(gid, torch.ones(4, dtype=torch.bool), vals, 3)
    assert len(plain) == 1  # an unbatched CPU tensor takes the plain version
