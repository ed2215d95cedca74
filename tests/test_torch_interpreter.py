"""The per-row UDF interpreter, the T-SQL parser and the ``Database`` shim
of the port (``repro_torch.core.interpreter``, ``tsql``, ``database``)
against the reference's, on the CPU.

* Parser: the same T-SQL text (``tests/test_tsql_parser.py``,
  ``tests/test_loops.py``, ``examples/cursor_loops.py``; the example's
  strings are read from its source, not run) parses to UDFs that print the
  same, and a text outside the subset raises with the same construct, line
  and column.
* Results: each UDF under INTERPRETED (``python`` mode) and HEKATON
  (``scan`` mode) in both packages — row masks, keys and validity exactly,
  floats to rtol 1e-4 — with the four interpreter counters of the
  reference (``invocations``, ``statements_executed``, ``bytes_scanned``,
  ``rows_scanned``) exactly, and equal to the port's FROID.
* TPC-H: the six UDF queries on a catalog whose ``lineitem`` is cut to 40
  rows (the reference compiles every statement it interprets): its first
  ten, and rows that Q3's, Q5's and Q12's predicates select, so that each
  query returns rows.
* Edge cases: a NULL IF predicate, the recursion limit, a WHILE past
  ``max_loop_iters`` (``python`` raises, ``scan`` stops), BREAK, an empty
  cursor table, rows masked out before the call, nested calls, one
  row-function call per row in order.

One reference defect is held apart: the reference caches a statement's
evaluator (and its ``scan``-mode row function) by the statement alone, so
a UDF called again with another string argument reuses the first call's
dictionary — TPC-H Q12's ``line_count(o_orderpriority, 'low')`` then
computes the ``'high'`` column.  The port keys its caches by those
dictionaries too and gives FROID's answer (``test_string_argument_*``).
"""
import ast
import dataclasses
import pathlib
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as RC
from repro.core import interpreter as RI
from repro.core import scalar as RS
from repro.core.tsql import parse_udf as ref_parse
from repro.data.tpch import generate_tpch as ref_generate
from repro.tables import table as RT
import repro_torch.core as PC
from repro_torch.core import interpreter as PI
from repro_torch.core import relalg as PR
from repro_torch.core import scalar as PS
from repro_torch.core.tsql import parse_udf as port_parse
from repro_torch.data.tpch_udfs import D
from repro_torch.data.tpch_udfs import QUERIES as PORT_QUERIES
from repro_torch.data.tpch_udfs import register_udfs as port_register

from conformance_util import facts_data
from test_loops import CURSOR_GUARD_BREAK, CURSOR_SUM, PLAIN_WHILE
from test_torch_session_tpch import NAMES, _norm_explain, export_catalog
from test_tsql_parser import BRACKET, GETVAL, TOTAL

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks.tpch_udfs import QUERIES as REF_QUERIES  # noqa: E402
from benchmarks.tpch_udfs import register_udfs as ref_register  # noqa: E402


def _example_strings() -> dict[str, str]:
    """The module-level string constants of ``examples/cursor_loops.py``,
    read without running the example."""
    tree = ast.parse((ROOT / "examples" / "cursor_loops.py").read_text())
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            out[node.targets[0].id] = node.value.value
    return out


EXAMPLE = _example_strings()
TEXTS = {"GETVAL": GETVAL, "TOTAL": TOTAL, "BRACKET": BRACKET,
         "CURSOR_SUM": CURSOR_SUM, "CURSOR_GUARD_BREAK": CURSOR_GUARD_BREAK,
         "PLAIN_WHILE": PLAIN_WHILE, "CURSOR_TOTAL": EXAMPLE["CURSOR_TOTAL"],
         "PLAIN": EXAMPLE["PLAIN"]}
ITERATIVE = ("interpreted", "hekaton")


def _policy(M, name):
    return M.PRESETS[name]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------


def _host(col):
    data = col.data
    valid = col.validity()
    if isinstance(data, torch.Tensor):
        return data.numpy(), valid.numpy()
    return np.asarray(data), np.asarray(valid)


def assert_rows(expected, got, label, across_policies=False, skip=()):
    """Compacted rows equal in order: validity and non-float values
    exactly, floats to rtol 1e-4.  Columns are matched by name (the
    reference's compiled path returns them in sorted order, through jit).
    ``across_policies``: an interpreted UDF's column is float32 whatever
    the UDF returns (the reference's rule), so values are held as
    float64."""
    e, g = expected.table, got.table
    assert sorted(e.names()) == sorted(g.names()), label
    assert e.num_rows == g.num_rows, label
    for name in e.names():
        if name in skip:
            continue
        ev, evalid = _host(e.columns[name])
        gv, gvalid = _host(g.columns[name])
        np.testing.assert_array_equal(evalid, gvalid, err_msg=f"{label}: valid({name})")
        if across_policies and ev.dtype != gv.dtype:
            ev, gv = ev.astype(np.float64), gv.astype(np.float64)
        assert str(ev.dtype) == str(gv.dtype), f"{label}: dtype({name})"
        if ev.dtype.kind == "f":
            np.testing.assert_allclose(gv[evalid], ev[evalid], rtol=1e-4,
                                       err_msg=f"{label}: {name}")
        else:
            np.testing.assert_array_equal(gv[evalid], ev[evalid],
                                          err_msg=f"{label}: {name}")


def assert_stats(ref_res, port_res, label, skip=()):
    """The reference's counters, exactly: the interpreter's four in the
    eager path (their delta also stands for the executor's reads there),
    the executor's logical reads in the compiled one."""
    for k, v in ref_res.stats.items():
        if k in skip:
            continue
        assert port_res.stats[k] == v, f"{label}: stats[{k}]"


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TEXTS))
def test_parsed_udf_prints_the_same(name):
    ref, port = ref_parse(TEXTS[name]), port_parse(TEXTS[name])
    assert _norm_explain(repr(port)) == _norm_explain(repr(ref))
    assert port.statement_count() == ref.statement_count()


BAD_TEXTS = {
    "unknown_cursor": "create function dbo.f(@x int) returns float as\n"
                      "begin\n  open c;\n  return 1.0;\nend\n",
    "fetch_status_compare": "create function dbo.f(@x int) returns float as\n"
                            "begin\n  while @@fetch_status < 1\n    set @x = 1;\n"
                            "  return 1.0;\nend\n",
    "no_priming_fetch": "create function dbo.f(@x int) returns float as\nbegin\n"
                        "  declare c cursor for select val from facts;\n  open c;\n"
                        "  while @@fetch_status = 0\n    set @x = 1;\n  return 1.0;\nend\n",
    "no_trailing_fetch": "create function dbo.f(@x int) returns float as\nbegin\n"
                         "  declare @v float;\n"
                         "  declare c cursor for select val from facts;\n"
                         "  fetch next from c into @v;\n  while @@fetch_status = 0\n"
                         "  begin\n    set @v = @v + 1.0;\n  end\n  return 1.0;\nend\n",
    "fetch_arity": "create function dbo.f(@x int) returns float as\nbegin\n"
                   "  declare @v float;\n"
                   "  declare c cursor for select val, qty from facts;\n"
                   "  fetch next from c into @v;\n  return 1.0;\nend\n",
    "cursor_select_expr": "create function dbo.f(@x int) returns float as\nbegin\n"
                          "  declare c cursor for select val + 1 from facts;\n"
                          "  return 1.0;\nend\n",
    "statement": "create function dbo.f(@x int) returns float as\nbegin\n"
                 "  print @x;\n  return 1.0;\nend\n",
    "token": "create function dbo.f(@x int) returns float as\nbegin\n"
             "  set @x = #;\n  return 1.0;\nend\n",
    "type": "create function dbo.f(@x text) returns float as\nbegin return 1.0; end\n",
    "example_missing_cursor": EXAMPLE["CURSOR_TOTAL"].replace("open c;", "open missing;"),
}


@pytest.mark.parametrize("name", list(BAD_TEXTS))
def test_unsupported_construct_same_location(name):
    with pytest.raises(RC.UnsupportedConstructError) as ref:
        ref_parse(BAD_TEXTS[name])
    with pytest.raises(PC.UnsupportedConstructError) as port:
        port_parse(BAD_TEXTS[name])
    r, p = ref.value, port.value
    assert (p.construct, p.line, p.col) == (r.construct, r.line, r.col)
    assert str(p) == str(r)


# ---------------------------------------------------------------------------
# T-SQL UDFs under every policy, both packages
# ---------------------------------------------------------------------------


def _orders_tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"customer": dict(c_custkey=np.arange(30)),
            "orders": dict(o_custkey=rng.integers(0, 30, 200),
                           o_totalprice=rng.uniform(10, 200, 200).astype(np.float32))}


def _facts_tables(n_rows=23, seed=0):
    return {"facts": facts_data(seed, n_rows), "keys": dict(k=np.arange(7))}


def _keys_query(M, fname, shift=True):
    arg = M.col("k") * 1.0 + M.param("shift") if shift else M.col("k") * 1.0
    return (M.scan("keys").filter(M.col("k") < M.param("cut"))
            .compute(out=M.udf(fname, arg)).project("k", "out"))


CUT = {"cut": 5, "shift": 0.5}
# name -> (text, tables, query builder (module -> query), params)
UDF_CASES = {
    "GETVAL": (GETVAL, _orders_tables,
               lambda M: M.scan("customer").compute(
                   v=M.udf("getval", M.col("c_custkey") * 100)), None),
    "TOTAL": (TOTAL, _orders_tables,
              lambda M: M.scan("customer").compute(
                  t=M.udf("total_price", M.col("c_custkey"))), None),
    "BRACKET": (BRACKET, _orders_tables,
                lambda M: M.scan("customer").compute(
                    b=M.udf("rptbracket", M.col("c_custkey"), 7)), None),
    "CURSOR_SUM": (CURSOR_SUM, _facts_tables,
                   lambda M: _keys_query(M, "cursor_total"), CUT),
    "CURSOR_GUARD_BREAK": (CURSOR_GUARD_BREAK, _facts_tables,
                           lambda M: _keys_query(M, "cursor_capped"), CUT),
    "PLAIN_WHILE": (PLAIN_WHILE, _facts_tables, lambda M: _keys_query(M, "wsum"), CUT),
    "CURSOR_TOTAL": (EXAMPLE["CURSOR_TOTAL"], _facts_tables,
                     lambda M: _keys_query(M, "cursor_total", shift=False), {"cut": 4}),
    "PLAIN": (EXAMPLE["PLAIN"], _facts_tables,
              lambda M: _keys_query(M, "countdown", shift=False), {"cut": 6}),
    "CURSOR_SUM_EMPTY": (CURSOR_SUM, lambda: _facts_tables(n_rows=0),
                         lambda M: _keys_query(M, "cursor_total"), CUT),
}


def _pair(text, tables):
    """A reference and a port session over the same tables and UDF."""
    ref, port = RC.Session(), PC.Session(device="cpu")
    for name, arrays in tables().items():
        ref.create_table(name, **arrays)
        port.create_table(name, **arrays)
    ref.create_function(ref_parse(text))
    port.create_function(port_parse(text))
    return ref, port


@pytest.mark.parametrize("policy", ITERATIVE)
@pytest.mark.parametrize("case", list(UDF_CASES))
def test_tsql_udf_matches_reference(case, policy):
    text, tables, query, params = UDF_CASES[case]
    ref, port = _pair(text, tables)
    want = ref.execute(query(RC), _policy(RC, policy), params=params)
    got = port.execute(query(PC), _policy(PC, policy), params=params)
    label = f"{case} {policy}"
    assert_rows(want, got, label)
    assert_stats(want, got, label)
    froid = port.execute(query(PC), PC.FROID, params=params)
    assert_rows(froid, got, f"{label} vs port FROID", across_policies=True)


@pytest.mark.parametrize("case", ["CURSOR_SUM", "PLAIN_WHILE", "CURSOR_TOTAL"])
def test_loop_udf_froid_keeps_the_call_and_matches_reference(case):
    """FROID rewrites a cursor loop to a LoopScan inside the calling plan,
    as the reference does: no UdfCall is left and no row goes through the
    scan-mode hook.  A plain WHILE has no driving relation: the call stays
    in the plan and the hook runs it on every row of ``keys``.  Same rows
    as the reference either way."""
    text, tables, query, params = UDF_CASES[case]
    ref, port = _pair(text, tables)
    stmt = port.prepare(query(PC), PC.FROID)
    calls = any(isinstance(e, PS.UdfCall) for n in PR.walk_plan_deep(stmt.plan)
                for ex in n.exprs() for e in PS.walk(ex))
    loops = [n for n in PR.walk_plan_deep(stmt.plan) if isinstance(n, PR.LoopScan)]
    got = stmt.execute(params=params)
    if case == "PLAIN_WHILE":
        assert calls and not loops
        assert got.stats["udf_rows"] == 7  # scan mode: every row of ``keys``
    else:
        assert loops and not calls
        assert "udf_rows" not in got.stats
    assert_rows(ref.execute(query(RC), RC.FROID, params=params), got, case)


# ---------------------------------------------------------------------------
# TPC-H's six UDF queries on a cut catalog
# ---------------------------------------------------------------------------

CUT_ROWS = 40


def _cut_rows(cat: dict) -> np.ndarray:
    """40 ``lineitem`` rows, in order: the first ten, then rows that the
    predicates of Q3, Q5 and Q12 select (written out in numpy over the
    generator's dense keys), so that every query returns rows."""
    def col(t, c):
        return np.asarray(cat[t][c][0])

    def code(t, c, word):
        return list(cat[t][c][2]).index(word)

    order, supp = col("lineitem", "l_orderkey"), col("lineitem", "l_suppkey")
    odate, cust = col("orders", "o_orderdate")[order], col("orders", "o_custkey")[order]
    ship, commit, receipt = (col("lineitem", c) for c in
                             ("l_shipdate", "l_commitdate", "l_receiptdate"))
    d3, d94, d95 = D["1995-03-15"], D["1994-01-01"], D["1995-01-01"]
    q3 = ((col("customer", "c_mktsegment")[cust]
           == code("customer", "c_mktsegment", "BUILDING"))
          & (odate < d3) & (ship > d3) & (ship <= d3 + 122))
    snat = col("supplier", "s_nationkey")[supp]
    q5 = ((col("region", "r_name")[col("nation", "n_regionkey")[snat]]
           == code("region", "r_name", "ASIA"))
          & (col("customer", "c_nationkey")[cust] == snat)
          & (odate >= d94) & (odate < d95))
    mode = col("lineitem", "l_shipmode")
    q12 = (np.isin(mode, [code("lineitem", "l_shipmode", w) for w in ("MAIL", "SHIP")])
           & (receipt >= d94) & (commit < receipt) & (ship < commit)
           & (receipt < D["1995-09-01"] + 30))
    rows = set(range(10))
    for hit in (q3, q5, q12):
        rows.update(np.flatnonzero(hit)[:10].tolist())
    rows.update(i for i in range(len(order)) if len(rows) < CUT_ROWS)
    return np.array(sorted(rows)[:CUT_ROWS])


@pytest.fixture(scope="module")
def tpch_cut():
    full = RC.Session()
    ref_generate(full, sf=0.001)
    keep = jnp.asarray(_cut_rows(export_catalog(full)))
    ref = RC.Session()
    for name, t in full.catalog.items():
        if name == "lineitem":
            t = RT.Table({n: RT.Column(c.data[keep],
                                       None if c.valid is None else c.valid[keep],
                                       c.dictionary)
                          for n, c in t.columns.items()})
        ref.create_table(name, t)
    ref_register(ref)
    port = PC.Session(device="cpu")
    port.load_catalog(export_catalog(ref))
    port_register(port)
    return ref, port


def _pallas(M, name):
    return dataclasses.replace(_policy(M, name), name=name + "+agg", pallas_agg=True)


@pytest.mark.parametrize("policy", ITERATIVE)
@pytest.mark.parametrize("name", NAMES)
def test_tpch_udf_query_matches_reference(tpch_cut, name, policy):
    ref, port = tpch_cut
    rq, pq = REF_QUERIES[name][0](), PORT_QUERIES[name][0]()
    rp, pp = _pallas(RC, policy), _pallas(PC, policy)
    assert _norm_explain(ref.explain(rq, rp)) == _norm_explain(port.explain(pq, pp))
    want = ref.execute(rq, rp)
    got = port.execute(pq, pp)
    label = f"{name} {policy}"
    assert got.table.num_rows > 0, label
    if name == "Q12":
        # the reference's 'low' repeats 'high' (its cache defect, above),
        # and its 'low' calls take the 'high' calls' branches, which counts
        # other statements; the port's 'low' is held to FROID's below
        assert_rows(want, got, label, skip=("low",))
        assert_stats(want, got, label, skip=("statements_executed",))
    else:
        assert_rows(want, got, label)
        assert_stats(want, got, label)
    assert_rows(port.execute(pq, PC.FROID), got, f"{label} vs port FROID",
                across_policies=True)


# ---------------------------------------------------------------------------
# the reference defect: a string argument's dictionary
# ---------------------------------------------------------------------------


def _line_count_pair():
    ref, port = RC.Session(), PC.Session(device="cpu")
    prios = np.array(["1-URGENT", "3-MEDIUM", "2-HIGH", "5-LOW", "1-URGENT"])
    for s in (ref, port):
        s.create_table("o", prio=prios)
    ref_register(ref)
    port_register(port)
    return ref, port


def _hi_lo(M):
    return M.scan("o").compute(
        high=M.udf("line_count", M.col("prio"), M.lit("high")),
        low=M.udf("line_count", M.col("prio"), M.lit("low"))).project("high", "low")


@pytest.mark.parametrize("policy", ITERATIVE)
def test_string_argument_keeps_its_dictionary(policy):
    ref, port = _line_count_pair()
    got = port.execute(_hi_lo(PC), _policy(PC, policy)).table
    want = port.execute(_hi_lo(PC), PC.FROID).table
    np.testing.assert_array_equal(got.columns["high"].data.numpy(), [1, 0, 1, 0, 1])
    np.testing.assert_array_equal(got.columns["low"].data.numpy(), [0, 1, 0, 1, 0])
    for c in ("high", "low"):
        np.testing.assert_array_equal(got.columns[c].data.numpy(),
                                      want.columns[c].data.numpy().astype(np.float32))
    # the reference's FROID agrees; its iterative policies reuse the first
    # call's dictionary, so its 'low' column repeats 'high'
    rf = ref.execute(_hi_lo(RC), RC.FROID).table
    np.testing.assert_array_equal(np.asarray(rf.columns["low"].data), [0, 1, 0, 1, 0])
    ri = ref.execute(_hi_lo(RC), _policy(RC, policy)).table
    np.testing.assert_array_equal(np.asarray(ri.columns["low"].data),
                                  np.asarray(ri.columns["high"].data))


# ---------------------------------------------------------------------------
# edge cases, on the interpreter and through the session
# ---------------------------------------------------------------------------


def _builder_pair(build):
    """The same UDF authored with each package's builder."""
    return build(RC), build(PC)


def _null_if(M):
    u = M.UdfBuilder("nullif", [("x", "float32")], "float32")
    with u.if_(M.param("x") > 1.0):
        u.return_(M.lit(10.0))
    with u.else_():
        u.return_(M.lit(20.0))
    return u.build()


def _nested(M):
    u = M.UdfBuilder("inner", [("x", "float32")], "float32")
    with u.if_(M.param("x") > 2.0):
        u.return_(M.param("x") * 2.0)
    u.return_(M.param("x"))
    inner = u.build()
    u = M.UdfBuilder("outer", [("x", "float32")], "float32")
    u.declare("y", "float32", M.udf("inner", M.param("x") + 1.0))
    u.return_(M.udf("inner", M.var("y")) + 0.5)
    return [inner, u.build()]


def _fact(M):
    u = M.UdfBuilder("fact", [("n", "int32")], "int32")
    with u.if_(M.param("n") <= 1):
        u.return_(M.lit(1))
    u.return_(M.param("n") * M.udf("fact", M.param("n") - 1))
    return u.build()


def _table_pair(**arrays):
    ref, port = RC.Session(), PC.Session(device="cpu")
    for s in (ref, port):
        s.create_table("t", **arrays)
    return ref, port


@pytest.mark.parametrize("policy", ITERATIVE)
def test_null_predicate_takes_else(policy):
    ref, port = _table_pair(x=np.array([0.0, 2.0, 3.0, 5.0], np.float32),
                            d=np.array([1.0, 0.0, 1.0, 1.0], np.float32))
    r_udf, p_udf = _builder_pair(_null_if)
    ref.create_function(r_udf)
    port.create_function(p_udf)
    # x / 0 is NULL: the row takes ELSE (20), not THEN
    q = lambda M: M.scan("t").compute(v=M.udf("nullif", M.col("x") / M.col("d")))
    got = port.execute(q(PC), _policy(PC, policy))
    np.testing.assert_array_equal(got.table.columns["v"].data.numpy(), [20, 20, 10, 10])
    assert_rows(ref.execute(q(RC), _policy(RC, policy)), got, policy)


@pytest.mark.parametrize("policy", ITERATIVE)
def test_nested_calls(policy):
    ref, port = _table_pair(x=np.array([0.0, 1.5, 2.5, 4.0], np.float32))
    for s, M in ((ref, RC), (port, PC)):
        for f in _nested(M):
            s.create_function(f)
    q = lambda M: M.scan("t").compute(v=M.udf("outer", M.col("x")))
    want = ref.execute(q(RC), _policy(RC, policy))
    got = port.execute(q(PC), _policy(PC, policy))
    assert_rows(want, got, policy)
    assert_stats(want, got, policy)
    assert_rows(port.execute(q(PC), PC.FROID), got, "vs FROID", across_policies=True)


def test_masked_out_rows_are_not_invoked():
    ref, port = _table_pair(x=np.arange(12, dtype=np.float32))
    r_udf, p_udf = _builder_pair(_null_if)
    ref.create_function(r_udf)
    port.create_function(p_udf)
    q = lambda M: (M.scan("t").filter(M.col("x") < M.param("cut"))
                   .compute(v=M.udf("nullif", M.col("x"))))
    got = port.execute(q(PC), PC.INTERPRETED, params={"cut": 5})
    assert got.stats["invocations"] == 5 == got.stats["udf_rows"]
    assert_stats(ref.execute(q(RC), RC.INTERPRETED, params={"cut": 5}), got, "masked")
    # scan mode drives every row, as lax.scan does
    assert port.execute(q(PC), PC.HEKATON, params={"cut": 5}).stats["udf_rows"] == 12


def _interpreters(M, session, mode, **kw):
    return M.Interpreter(session.catalog, session.registry, mode=mode, **kw)


def _value(M, v):
    """A 0-d parameter value of either package (int32 or float32)."""
    if M is PC:
        dtype = torch.int32 if isinstance(v, int) else torch.float32
        return PS.Value(torch.tensor(v, dtype=dtype))
    return RS.Value(jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32))


ERRORS = {RC: RI.InterpreterError, PC: PI.InterpreterError}


def test_recursion_limit():
    ref, port = _table_pair(n=np.array([1, 3, 5, 6], np.int32))
    r_udf, p_udf = _builder_pair(_fact)
    ref.create_function(r_udf)
    port.create_function(p_udf)
    q = lambda M: M.scan("t").compute(v=M.udf("fact", M.col("n")))
    got = port.execute(q(PC), PC.INTERPRETED)
    np.testing.assert_array_equal(got.table.columns["v"].data.numpy(), [1, 6, 120, 720])
    assert_stats(ref.execute(q(RC), RC.INTERPRETED), got, "fact")
    for M, s, udf in ((RC, ref, r_udf), (PC, port, p_udf)):
        deep = _interpreters(M, s, "python", max_recursion=4)
        five = deep.call_udf(udf, {"n": _value(M, 5)})
        assert np.asarray(five.data).reshape(-1).tolist() == [120]
        with pytest.raises(ERRORS[M], match="recursion limit"):
            deep.call_udf(udf, {"n": _value(M, 6)})
        # scan mode inlines every nested call, whatever the data
        with pytest.raises(ERRORS[M], match="recursion limit"):
            _interpreters(M, s, "scan").traced_call(udf, {"n": _value(M, 2)})


def test_while_past_max_loop_iters():
    """``python`` mode raises; ``scan`` mode stops silently after the
    limit, with the sums of the iterations it ran."""
    ref, port = _table_pair(x=np.array([1.0], np.float32))
    r_udf, p_udf = ref_parse(PLAIN_WHILE), port_parse(PLAIN_WHILE)
    for M, s, udf in ((RC, ref, r_udf), (PC, port, p_udf)):
        interp = _interpreters(M, s, "python", max_loop_iters=5)
        assert float(np.asarray(interp.call_udf(udf, {"x": _value(M, 5.0)}).data)) == 15
        with pytest.raises(ERRORS[M], match="WHILE exceeded 5 iterations"):
            interp.call_udf(udf, {"x": _value(M, 9.0)})
    outs = []
    for M, s, udf in ((RC, ref, r_udf), (PC, port, p_udf)):
        out = _interpreters(M, s, "scan", max_loop_iters=5).traced_call(
            udf, {"x": _value(M, 9.0)})
        outs.append((float(np.asarray(out.data)), bool(np.asarray(out.validity()))))
    assert outs[0] == outs[1] == (15.0, True)  # 1 + 2 + 3 + 4 + 5


def _break_loop(M):
    u = M.UdfBuilder("firstover", [("x", "float32")], "float32")
    u.declare("i", "float32", M.lit(0.0))
    with u.while_(M.var("i") < 100.0):
        u.set("i", M.var("i") + 1.0)
        with u.if_(M.var("i") * M.var("i") > M.param("x")):
            u.break_()
    u.return_(M.var("i"))
    return u.build()


@pytest.mark.parametrize("policy", ITERATIVE)
def test_break_in_while(policy):
    ref, port = _table_pair(x=np.array([0.0, 3.0, 10.0, 50.0, 99.0], np.float32))
    r_udf, p_udf = _builder_pair(_break_loop)
    ref.create_function(r_udf)
    port.create_function(p_udf)
    q = lambda M: M.scan("t").compute(v=M.udf("firstover", M.col("x")))
    got = port.execute(q(PC), _policy(PC, policy))
    np.testing.assert_array_equal(got.table.columns["v"].data.numpy(), [1, 2, 4, 8, 10])
    want = ref.execute(q(RC), _policy(RC, policy))
    assert_rows(want, got, policy)
    assert_stats(want, got, policy)


def test_scan_mode_drives_one_row_at_a_time_in_order(monkeypatch):
    port = PC.Session(device="cpu")
    port.create_table("t", x=np.array([4.0, 1.0, 3.0, 2.0], np.float32))
    port.create_function(_null_if(PC))
    seen = []
    traced = PI.Interpreter.traced_call

    def recording(self, udf, params, depth=0):
        seen.append({k: (tuple(v.data.shape), float(v.data)) for k, v in params.items()})
        return traced(self, udf, params, depth)

    monkeypatch.setattr(PI.Interpreter, "traced_call", recording)
    r = port.execute(PC.scan("t").compute(v=PC.udf("nullif", PC.col("x"))), PC.HEKATON)
    assert seen == [{"x": ((), x)} for x in (4.0, 1.0, 3.0, 2.0)]
    assert r.stats["udf_rows"] == 4
    np.testing.assert_array_equal(r.table.columns["v"].data.numpy(), [10, 20, 10, 10])


def test_interpreter_runs_on_its_catalog_s_device(monkeypatch):
    port = PC.Session(device="cpu")
    port.create_table("t", x=np.arange(3, dtype=np.float32))
    assert PC.Interpreter(port.catalog, port.registry).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PC.Interpreter({}, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        PC.Database()


# ---------------------------------------------------------------------------
# the Database shim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [dict(froid=True), dict(froid=False, mode="python"),
                                    dict(froid=False, mode="scan")],
                         ids=["froid", "python", "scan"])
def test_database_run_matches_reference(kwargs):
    tables = _orders_tables()
    ref, port = RC.Database(), PC.Database(device="cpu")
    for db, parse in ((ref, ref_parse), (port, port_parse)):
        for name, arrays in tables.items():
            db.create_table(name, **arrays)
        db.create_function(parse(TOTAL))
    q = lambda M: M.scan("customer").compute(t=M.udf("total_price", M.col("c_custkey")))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = port.run(q(PC), **kwargs)
    assert isinstance(got, PC.RunResult) and PC.RunResult is PC.QueryResult
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref.run(q(RC), **kwargs)
    assert_rows(want, got, str(kwargs))
    assert_stats(want, got, str(kwargs))


def test_database_run_compiled_and_forwarding():
    port = PC.Database(device="cpu")
    port.create_table("t", x=np.arange(4, dtype=np.float32))
    port.create_function(_null_if(PC))
    q = PC.scan("t").compute(v=PC.udf("nullif", PC.col("x")))
    with pytest.warns(DeprecationWarning):
        ps, plan = port.run_compiled(q, froid=False)
    assert ps.policy.udf_mode == "scan" and ps.plan is plan
    np.testing.assert_array_equal(ps.execute().table.columns["v"].data.numpy(),
                                  [20, 20, 10, 10])
    assert port.catalog is port.session.catalog
    assert port.registry is port.session.registry
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        port.run(q)  # no legacy kwarg passed: no warning
    plan = port.plan_for(q, froid=False)
    assert any(isinstance(e, PS.UdfCall) for n in PR.walk_plan(plan)
               for ex in n.exprs() for e in PS.walk(ex))
    assert "Scan t" in port.explain(q)


# ---------------------------------------------------------------------------
# the mode oracle and the loop oracle (tests/conformance_util.py:210, :444)
# on the port, beside the reference
# ---------------------------------------------------------------------------

#: ``conformance_util.FIXED_PROGRAMS`` written against either package's
#: builders (its ops hold the reference's expression objects)
PROGRAMS = {
    "correlated_min_null_guard": lambda M: [
        ("declare", "v0", M.lit(1.5)),
        ("select_agg", "v0", "min", True, 0),
        ("ifelse", M.var("v0").is_null(), "v0", M.param("p") * 2.0, None, None, True),
        ("return", M.var("v0") + M.param("p")),
    ],
    "uncorrelated_sum_case": lambda M: [
        ("declare", "v0", M.param("p") * 1.0),
        ("select_agg", "v0", "sum", False, 4),
        ("set", "v0", M.case([(M.var("v0") > M.param("p"), M.var("v0"))], M.lit(0.5))),
        ("return", M.coalesce(M.var("v0"), M.lit(0.0))),
    ],
    "avg_ifelse_branches": lambda M: [
        ("declare", "v0", None),
        ("select_agg", "v0", "avg", True, 0),
        ("ifelse", M.var("v0") > M.lit(0.0), "v0", M.var("v0") / 2.0,
         "v0", M.param("p") - 3.0, False),
        ("return", M.var("v0") * 2.0 - 1.0),
    ],
    "count_max_division": lambda M: [
        ("declare", "v0", M.lit(2.0)),
        ("declare", "v1", None),
        ("select_agg", "v1", "count", False, 7),
        ("set", "v0", M.param("p") / M.var("v0")),
        ("select_agg", "v1", "max", False, 7),
        ("return", M.coalesce(M.var("v1"), M.var("v0"), M.lit(-1.0))),
    ],
}
AGGS = {"sum": "sum_", "min": "min_", "max": "max_", "avg": "avg_", "count": "count_"}


def _program_udf(M, ops):
    """``conformance_util.build_udf`` on either package's builder."""
    u = M.UdfBuilder("f", [("p", "float32")], "float32")
    for op in ops:
        if op[0] == "declare":
            u.declare(op[1], "float32", op[2])
        elif op[0] == "set":
            u.set(op[1], op[2])
        elif op[0] == "select_agg":
            _, tgt, agg, corr, thresh = op
            pred = (M.col("fk") == M.param("p") if corr
                    else M.col("qty") >= M.lit(thresh))
            u.select({tgt: getattr(M, AGGS[agg])(M.col("val"))},
                     frm=M.scan("facts"), where=pred)
        elif op[0] == "ifelse":
            _, pred, t_tgt, t_expr, e_tgt, e_expr, ret_in_then = op
            with u.if_(pred):
                u.set(t_tgt, t_expr)
                if ret_in_then:
                    u.return_(M.var(t_tgt) + 1.0)
            if e_tgt is not None:
                with u.else_():
                    u.set(e_tgt, e_expr)
        else:
            u.return_(op[1])
    return u.build()


def _loop_udf(M, body, guard_cap=None, break_cap=None):
    """``conformance_util.build_loop_udf`` on either package's builder."""
    u = M.UdfBuilder("floop", [("x", "float32")], "float32")
    u.declare("t", "float32", M.lit(0.0))
    if body == "plain_while":
        u.declare("i", "float32", M.lit(0.0))
        with u.while_(M.var("i") < M.param("x")):
            u.set("i", M.var("i") + 1.0)
            u.set("t", M.var("t") + M.var("i"))
        u.return_(M.var("t"))
        return u.build()
    u.declare("v", "float32", None)
    u.declare("q", "float32", None)
    guard = None if guard_cap is None else M.var("t") < M.lit(float(guard_cap))
    with u.cursor_loop({"v": "val", "q": "qty"}, M.scan("facts"),
                       where=M.col("fk") <= M.param("x"), guard=guard):
        if body == "sum":
            u.set("t", M.var("t") + M.var("v"))
        elif body == "sum_if":
            with u.if_(M.var("q") > M.lit(2.0)):
                u.set("t", M.var("t") + M.var("v"))
        else:
            u.set("t", M.var("t") * 0.5 + M.var("v"))
        if break_cap is not None:
            with u.if_(M.var("t") > M.lit(float(break_cap))):
                u.break_()
    u.return_(M.var("t"))
    return u.build()


def _oracle(build_udf, fname, seed, n_rows, params_list):
    """The port's FROID == INTERPRETED == HEKATON, and each iterative
    policy == the reference's (rows and counters)."""
    ref, port = RC.Session(), PC.Session(device="cpu")
    for name, arrays in _facts_tables(n_rows, seed).items():
        ref.create_table(name, **arrays)
        port.create_table(name, **arrays)
    ref.create_function(build_udf(RC))
    port.create_function(build_udf(PC))
    q = lambda M: _keys_query(M, fname)
    froid = [port.execute(q(PC), PC.FROID, params=p) for p in params_list]
    for i, p in enumerate(params_list):
        assert_rows(ref.execute(q(RC), RC.FROID, params=p), froid[i], f"FROID[{i}]")
    for policy in ITERATIVE:
        pstmt, rstmt = port.prepare(q(PC), _policy(PC, policy)), ref.prepare(
            q(RC), _policy(RC, policy))
        for i, p in enumerate(params_list):
            got = pstmt.execute(params=p)
            assert_rows(froid[i], got, f"FROID vs {policy}[{i}]", across_policies=True)
            want = rstmt.execute(params=p)
            assert_rows(want, got, f"reference {policy}[{i}]")
            assert_stats(want, got, f"reference {policy}[{i}]")


PARAMS = [{"cut": 5, "shift": 0.5}, {"cut": 7, "shift": -1.0}]


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_mode_oracle_fixed_programs(name):
    _oracle(lambda M: _program_udf(M, PROGRAMS[name](M)), "f", 0, 23, PARAMS)


LOOP_SPECS = [("sum", None, None), ("sum_if", None, None), ("running", None, None),
              ("running", 10.0, 75.0), ("sum", 40.0, None), ("sum", None, 15.0),
              ("plain_while", None, None)]


@pytest.mark.parametrize("spec", LOOP_SPECS, ids=lambda s: "-".join(map(str, s)))
def test_loop_oracle(spec):
    _oracle(lambda M: _loop_udf(M, *spec), "floop", 1, 23, PARAMS)
