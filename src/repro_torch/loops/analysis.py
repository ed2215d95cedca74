"""Port of ``src/repro/loops/analysis.py:1-167`` (a copy on the port's plan
layer; device-free).

Loop classification (Aggify §3: which loops become aggregates).

``classify`` inspects one :class:`~repro_torch.core.ir.While` or
:class:`~repro_torch.core.ir.CursorLoop` and returns a :class:`LoopVerdict`:

* ``rewritable=False`` — the loop has no driving relation (plain WHILE)
  or its body uses constructs the rewrite cannot express (nested loops,
  RETURN, subqueries, UDF calls, non-determinism).  FROID inlining then
  falls back to the per-row interpreter, which carries these natively.
* ``kind="reduce"`` — every statement is an unconditional or
  single-IF-guarded commutative accumulator update (``@a = @a + t`` /
  ``@a = @a * t``) whose term and guard are loop-invariant apart from the
  fetch variables.  Lowered as masked ``sum``/``prod`` reductions — no
  sequential dependence at all.
* ``kind="scan"`` — anything else expressible: order-dependent updates,
  BREAK, extra termination guards, loop-local declares.  Lowered as an
  ordered fold with predicated early exit (the reference's ``lax.scan``;
  the port's executor steps the rows in order on the host).

The verdict strings are the reference's, word for word (the parity tests
compare them).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import ir as IR
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S


@dataclasses.dataclass(frozen=True)
class LoopVerdict:
    rewritable: bool
    kind: str  # "reduce" | "scan" | "" when non-rewritable
    reason: str
    written: tuple[str, ...] = ()  # live-out assigned variables
    locals: tuple[str, ...] = ()  # loop-local declares (not live-out)

    def __str__(self):
        head = f"rewritable ({self.kind})" if self.rewritable else "non-rewritable"
        return f"{head}: {self.reason}"


def _body_statements(stmts):
    for st in stmts:
        yield st
        if isinstance(st, IR.IfElse):
            yield from _body_statements(st.then_body)
            yield from _body_statements(st.else_body)
        elif isinstance(st, (IR.While, IR.CursorLoop)):
            yield from _body_statements(st.body)


def _body_exprs(loop: IR.CursorLoop):
    if loop.guard is not None:
        yield loop.guard
    yield from IR.walk_stmt_exprs(loop.body)


def classify(loop: IR.Statement) -> LoopVerdict:
    if isinstance(loop, IR.While):
        return LoopVerdict(
            False, "", "WHILE without a cursor relation — no driving "
            "relation to fold over")
    assert isinstance(loop, IR.CursorLoop), loop

    assigned: set[str] = set()
    local_decls: set[str] = set()
    has_break = False
    for st in _body_statements(loop.body):
        if isinstance(st, (IR.While, IR.CursorLoop)):
            return LoopVerdict(False, "", "nested loop in cursor loop body")
        if isinstance(st, IR.Return):
            return LoopVerdict(False, "", "RETURN inside cursor loop body")
        if isinstance(st, IR.Fetch):
            return LoopVerdict(False, "", "FETCH inside cursor loop body")
        if isinstance(st, IR.Assign):
            assigned.add(st.name)
        elif isinstance(st, IR.Declare):
            local_decls.add(st.name)
        elif isinstance(st, IR.Break):
            has_break = True

    for e in _body_exprs(loop):
        for n in S.walk(e):
            if isinstance(n, (S.ScalarSubquery, S.Exists)):
                return LoopVerdict(
                    False, "", "subquery inside cursor loop body")
            if isinstance(n, S.UdfCall):
                return LoopVerdict(
                    False, "", "nested UDF call inside cursor loop body")
            if isinstance(n, S.Func) and n.name in S.Func.NON_DETERMINISTIC:
                return LoopVerdict(
                    False, "", f"non-deterministic {n.name}() in loop body")
    for n in R.walk_plan_deep(loop.plan):
        for e in n.exprs():
            for x in S.walk(e):
                if isinstance(x, S.UdfCall):
                    return LoopVerdict(
                        False, "", "UDF call inside cursor-defining query")

    written = tuple(sorted(assigned - local_decls))
    locals_ = tuple(sorted(local_decls))
    if reduce_info(loop, assigned, local_decls) is not None and not has_break:
        return LoopVerdict(
            True, "reduce",
            "commutative accumulator fold — lowered as masked reductions",
            written, locals_)
    return LoopVerdict(
        True, "scan",
        "order-dependent fold — lowered as a predicated lax.scan",
        written, locals_)


def reduce_info(loop: IR.CursorLoop, assigned=None, locals_=None):
    """``{acc: (op, term, pred|None)}`` when the loop is a commutative
    fold, else None.  ``term``/``pred`` still contain raw Var refs (the
    rewrite pass substitutes fetch targets with cursor columns)."""
    if assigned is None or locals_ is None:
        assigned, locals_ = set(), set()
        for st in _body_statements(loop.body):
            if isinstance(st, IR.Assign):
                assigned.add(st.name)
            elif isinstance(st, IR.Declare):
                locals_.add(st.name)
    if loop.guard is not None:
        return None
    fetch_vars = {v for v, _ in loop.targets}
    if assigned & fetch_vars or locals_:
        return None

    def invariant(e):
        # terms/guards may read fetch variables, params, and enclosing
        # scope — but not any variable written in the loop
        return not any(
            isinstance(n, S.Var) and n.name in assigned for n in S.walk(e)
        )

    reds: dict[str, tuple] = {}

    def match(st: IR.Assign, pred):
        e = st.expr
        if not (isinstance(e, S.BinOp) and e.op in ("+", "*")):
            return False
        if isinstance(e.l, S.Var) and e.l.name == st.name:
            term = e.r
        elif isinstance(e.r, S.Var) and e.r.name == st.name:
            term = e.l
        else:
            return False
        if st.name in reds or not invariant(term):
            return False
        reds[st.name] = (e.op, term, pred)
        return True

    for st in loop.body:
        if isinstance(st, IR.Assign):
            if not match(st, None):
                return None
        elif isinstance(st, IR.IfElse):
            if st.else_body or not invariant(st.pred):
                return None
            for inner in st.then_body:
                if not (isinstance(inner, IR.Assign) and match(inner, st.pred)):
                    return None
        elif isinstance(st, IR.Break):
            return None
        else:
            return None
    return reds
