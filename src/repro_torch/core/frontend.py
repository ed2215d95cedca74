"""Port of ``src/repro/core/frontend.py:1-352`` (a copy).

Authoring frontends: a Python-embedded UDF builder and a fluent query
builder.

The paper's framework is language-agnostic (§7.3): each imperative construct
is a pluggable class.  Here the "language" is a Python builder — the
constructs (DECLARE/SET/SELECT-assign/IF-ELSE/RETURN) map 1:1 onto
:mod:`repro_torch.core.ir` statements; adding another surface syntax is a parser
plus calls into this module.
"""
from __future__ import annotations

import contextlib
from typing import Any, Sequence

from repro_torch.core import ir as IR
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S

# ---------------------------------------------------------------------------
# expression helpers (public API)
# ---------------------------------------------------------------------------


def col(name: str) -> S.ColRef:
    """Reference to a table column (inside queries / subqueries)."""
    return S.ColRef(name)


def var(name: str) -> S.Var:
    """Reference to a UDF local variable."""
    return S.Var(name)


def param(name: str) -> S.Param:
    """Reference to a UDF formal parameter."""
    return S.Param(name)


def lit(value: Any) -> S.Const:
    return S.Const(value)


def case(whens: Sequence[tuple], else_=None) -> S.Case:
    return S.Case(whens, S.Const(None) if else_ is None else else_)


def isnull(expr, fallback) -> S.Coalesce:
    """T-SQL ISNULL(a, b)."""
    return S.Coalesce([expr, fallback])


def coalesce(*args) -> S.Coalesce:
    return S.Coalesce(list(args))


def cast(expr, dtype) -> S.Cast:
    return S.Cast(expr, dtype)


def func(name: str, *args) -> S.Func:
    return S.Func(name, list(args))


def dateadd(part: str, n, d) -> S.Func:
    return S.Func("dateadd", [S.Const(part), S.wrap(n), S.wrap(d)])


def datepart(part: str, d) -> S.Func:
    return S.Func("datepart", [S.Const(part), S.wrap(d)])


def like(expr, pattern: str) -> S.Like:
    return S.Like(expr, pattern)


def in_list(expr, options) -> S.InList:
    return S.InList(expr, options)


def between(expr, lo, hi) -> S.Between:
    return S.Between(expr, lo, hi)


def udf(name: str, *args) -> S.UdfCall:
    return S.UdfCall(name, [S.wrap(a) for a in args])


def exists(plan) -> S.Exists:
    plan = plan.node if isinstance(plan, Q) else plan
    return S.Exists(plan)


def not_exists(plan) -> S.Exists:
    plan = plan.node if isinstance(plan, Q) else plan
    return S.Exists(plan, negated=True)


def scalar_subquery(plan, column=None) -> S.ScalarSubquery:
    plan = plan.node if isinstance(plan, Q) else plan
    return S.ScalarSubquery(plan, column)


# aggregate markers, legal only inside UdfBuilder.select / Q.agg ------------


class _Agg:
    def __init__(self, fn: str, expr):
        self.fn = fn
        self.expr = None if expr is None else S.wrap(expr)


def sum_(expr) -> _Agg:
    return _Agg("sum", expr)


def avg_(expr) -> _Agg:
    return _Agg("avg", expr)


def min_(expr) -> _Agg:
    return _Agg("min", expr)


def max_(expr) -> _Agg:
    return _Agg("max", expr)


def count_(expr=None) -> _Agg:
    return _Agg("count" if expr is not None else "count_star", expr)


# ---------------------------------------------------------------------------
# Fluent query builder
# ---------------------------------------------------------------------------


class Q:
    """Thin fluent wrapper over relalg nodes."""

    def __init__(self, node: R.RelNode):
        self.node = node

    def filter(self, pred) -> "Q":
        return Q(R.Filter(self.node, pred))

    def compute(self, **exprs) -> "Q":
        return Q(R.Compute(self.node, exprs))

    def project(self, *cols, **renames) -> "Q":
        mapping = {c: c for c in cols}
        mapping.update({new: old for new, old in renames.items()})
        return Q(R.Project(self.node, mapping))

    def join(self, other, on, kind="inner") -> "Q":
        other = other.node if isinstance(other, Q) else other
        if isinstance(on, tuple):
            on = [on]
        return Q(R.Join(self.node, other, on, kind))

    def group_by(self, *keys, capacity=None, **aggs) -> "Q":
        specs = {}
        for name, a in aggs.items():
            if isinstance(a, _Agg):
                specs[name] = R.AggSpec(a.fn, a.expr)
            else:
                raise TypeError(f"{name}: use sum_/count_/min_/max_/avg_")
        return Q(R.GroupAgg(self.node, list(keys), specs, capacity))

    def agg(self, **aggs) -> "Q":
        return self.group_by(**aggs)

    def sort(self, *keys, limit=None) -> "Q":
        norm = [(k, True) if isinstance(k, str) else k for k in keys]
        return Q(R.Sort(self.node, norm, limit))


def scan(table: str) -> Q:
    return Q(R.Scan(table))


# ---------------------------------------------------------------------------
# UDF builder
# ---------------------------------------------------------------------------


class UdfBuilder:
    """Builds a :class:`repro_torch.core.ir.UdfDef`.

    Example (the paper's Figure 1 ``total_price``)::

        u = UdfBuilder("total_price", [("key", "int32")], "float32")
        u.declare("price", "float32")
        u.declare("rate", "float32")
        u.declare("pref_currency", "str")
        u.declare("default_currency", "str", lit("USD"))
        u.select({"price": sum_(col("o_totalprice"))},
                 frm=scan("orders").filter(col("o_custkey") == param("key")))
        u.select({"pref_currency": col("currency")},
                 frm=scan("customer_prefs").filter(col("custkey") == param("key")))
        with u.if_(var("pref_currency") != var("default_currency")):
            u.set("rate", udf("xchg_rate", var("default_currency"),
                              var("pref_currency")))
            u.set("price", var("price") * var("rate"))
        u.return_(var("price"))
        f = u.build()
    """

    def __init__(self, name: str, params: list[tuple[str, str]], returns: str):
        self.name = name
        self.params = params
        self.returns = returns
        self._stack: list[list[IR.Statement]] = [[]]
        self._last_if: list[IR.IfElse | None] = [None]

    # -- statements ----------------------------------------------------------
    def declare(self, name: str, dtype: str = "float32", init=None) -> "UdfBuilder":
        init = None if init is None else S.wrap(init)
        self._stack[-1].append(IR.Declare(name, dtype, init))
        self._last_if[-1] = None
        return self

    def set(self, name: str, expr) -> "UdfBuilder":
        self._stack[-1].append(IR.Assign(name, S.wrap(expr)))
        self._last_if[-1] = None
        return self

    def select(self, assigns: dict[str, Any], frm: Q | R.RelNode | None = None,
               where=None) -> "UdfBuilder":
        """SELECT @v1 = e1, @v2 = e2 [FROM plan [WHERE pred]].

        Lowered to one Assign per variable whose RHS is a ScalarSubquery
        sharing the same plan node (the shared node is what lets CSE remove
        the duplication — paper §4.2.1)."""
        plan = None
        if frm is not None:
            plan = frm.node if isinstance(frm, Q) else frm
            if where is not None:
                plan = R.Filter(plan, where)
        for vname, expr in assigns.items():
            if plan is None:
                assert not isinstance(expr, _Agg)
                self.set(vname, expr)
                continue
            if isinstance(expr, _Agg):
                sub = R.GroupAgg(plan, [], {vname: R.AggSpec(expr.fn, expr.expr)})
                rhs = S.ScalarSubquery(sub, vname)
            else:
                sub = R.Compute(plan, {f"__{vname}_prj": S.wrap(expr)})
                rhs = S.ScalarSubquery(sub, f"__{vname}_prj")
            self.set(vname, rhs)
        return self

    @contextlib.contextmanager
    def if_(self, pred):
        self._stack.append([])
        self._last_if.append(None)
        try:
            yield self
        finally:
            body = self._stack.pop()
            self._last_if.pop()
            node = IR.IfElse(S.wrap(pred), body, [])
            self._stack[-1].append(node)
            self._last_if[-1] = node

    @contextlib.contextmanager
    def else_(self):
        node = self._last_if[-1]
        if node is None:
            raise SyntaxError("else_() without a preceding if_()")
        self._stack.append([])
        self._last_if.append(None)
        try:
            yield self
        finally:
            node.else_body = self._stack.pop()
            self._last_if.pop()
            self._last_if[-1] = None

    def return_(self, expr) -> "UdfBuilder":
        self._stack[-1].append(IR.Return(S.wrap(expr)))
        self._last_if[-1] = None
        return self

    # -- loops ----------------------------------------------------------------
    def break_(self) -> "UdfBuilder":
        self._stack[-1].append(IR.Break())
        self._last_if[-1] = None
        return self

    def fetch_(self, cursor: str, targets: list[tuple[str, str]]) -> "UdfBuilder":
        """FETCH NEXT marker (parser-internal; see :class:`ir.Fetch`)."""
        self._stack[-1].append(IR.Fetch(cursor, list(targets)))
        self._last_if[-1] = None
        return self

    @contextlib.contextmanager
    def _capture(self):
        """Collect statements into a fresh list without emitting a node —
        the parser uses this to parse loop bodies before deciding the loop
        shape."""
        self._stack.append([])
        self._last_if.append(None)
        holder: list[IR.Statement] = []
        try:
            yield holder
        finally:
            holder.extend(self._stack.pop())
            self._last_if.pop()
            self._last_if[-1] = None

    @contextlib.contextmanager
    def while_(self, pred):
        """WHILE pred BEGIN ... END."""
        self._stack.append([])
        self._last_if.append(None)
        try:
            yield self
        finally:
            body = self._stack.pop()
            self._last_if.pop()
            self._stack[-1].append(IR.While(S.wrap(pred), body))
            self._last_if[-1] = None

    @contextlib.contextmanager
    def cursor_loop(self, fetch: dict[str, str], frm, where=None, guard=None,
                    cursor: str = "c"):
        """Cursor loop over ``frm``'s rows in order.

        ``fetch`` maps loop variables to cursor columns (FETCH ... INTO);
        ``guard`` is an optional extra termination conjunct evaluated after
        each fetch (loop stops when it is not true)."""
        plan = frm.node if isinstance(frm, Q) else frm
        if where is not None:
            plan = R.Filter(plan, S.wrap(where))
        self._stack.append([])
        self._last_if.append(None)
        try:
            yield self
        finally:
            body = self._stack.pop()
            self._last_if.pop()
            targets = [(v, c) for v, c in fetch.items()]
            g = None if guard is None else S.wrap(guard)
            self._stack[-1].append(
                IR.CursorLoop(cursor, plan, targets, body, g))
            self._last_if[-1] = None

    # -- finish ---------------------------------------------------------------
    def build(self) -> IR.UdfDef:
        assert len(self._stack) == 1, "unclosed if_/else_ block"
        return IR.UdfDef(self.name, self.params, self.returns, self._stack[0])
