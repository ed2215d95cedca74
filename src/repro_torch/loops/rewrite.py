"""Port of ``src/repro/loops/rewrite.py:1-150`` (a copy on the port's plan
layer; device-free).

Cursor-loop → :class:`~repro_torch.core.relalg.LoopScan` compilation (Aggify
§4: the loop becomes a custom aggregate over the cursor's query).

``compile_loop`` turns a rewritable :class:`~repro_torch.core.ir.CursorLoop`
into the relational operator.  The caller (the algebrizer) supplies the
scope glue:

* ``fix_free(expr, carried)`` — resolve every ``Var`` whose name is NOT
  in ``carried`` to ``Outer``/``Param`` per the enclosing scope (raising
  on undeclared names);
* ``null_for(dtype)`` — a typed NULL constant for loop-local declares.

Scan-kind lowering compiles the body to an *ordered predicated step
list*: every assignment is guarded by its control context (a boolean
expression over the reserved ``__live`` flag and per-branch snapshot
temps), so BREAK and failed guards become sticky ``__done`` state rather
than control flow — the same predication discipline the algebrizer uses
for early RETURNs, applied per cursor row.
"""
from __future__ import annotations

from repro_torch.core import ir as IR
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.loops.analysis import LoopVerdict, reduce_info

#: reserved carried flag: row has permanently exited the loop
DONE = "__done"
#: reserved per-row pseudo-variable: row is active this iteration
LIVE = "__live"


def _and(a: S.Scalar, b: S.Scalar) -> S.Scalar:
    return S.BoolOp("and", [a, b])


def _not(a: S.Scalar) -> S.Scalar:
    return S.BoolOp("not", [a])


def compile_loop(loop: IR.CursorLoop, verdict: LoopVerdict, fix_free,
                 null_for) -> R.LoopScan:
    assert verdict.rewritable, verdict
    fetch_vars = [v for v, _ in loop.targets]
    fetch_cols = dict(loop.targets)
    outputs = sorted(set(verdict.written) | set(fetch_vars))
    carried = set(outputs) | set(verdict.locals) | {DONE, LIVE}

    def fix(e: S.Scalar) -> S.Scalar:
        return fix_free(e, carried)

    # loop-entry state: every live-out variable starts at its enclosing-
    # scope value; loop-locals start NULL; __done starts False
    carry: dict[str, S.Scalar] = {
        name: fix_free(S.Var(name), set()) for name in outputs
    }
    local_dtypes = {
        st.name: st.dtype
        for st in loop.body
        if isinstance(st, IR.Declare)
    }
    for name in verdict.locals:
        carry[name] = null_for(local_dtypes.get(name, "float32"))
    carry[DONE] = S.Const(False)

    if verdict.kind == "reduce":
        reds = reduce_info(loop)
        assert reds is not None

        def to_cols(e: S.Scalar) -> S.Scalar:
            def f(x):
                if isinstance(x, S.Var) and x.name in fetch_cols:
                    return S.ColRef(fetch_cols[x.name])
                return None

            return fix(S.transform(e, f))

        reductions: dict[str, tuple] = {}
        for acc, (op, term, pred) in reds.items():
            reductions[acc] = ("fold", op, to_cols(term),
                               None if pred is None else to_cols(pred))
        for v in fetch_vars:
            if v not in reductions:
                reductions[v] = ("last", fetch_cols[v], None, None)
        return R.LoopScan(loop.plan, carry, [], "reduce", reductions,
                          outputs)

    # ---- scan kind: ordered predicated steps --------------------------
    steps: list[tuple[str, S.Scalar]] = []
    temp_n = [0]

    def temp(base: str) -> str:
        temp_n[0] += 1
        return f"__{base}{temp_n[0]}"

    # 1. fetch binds: active rows take the cursor row's columns
    for v, c in loop.targets:
        steps.append((v, S.Case([(S.Var(LIVE), S.ColRef(c))], S.Var(v))))

    # 2. extra termination guard: a live row whose guard is not TRUE exits
    #    the loop *before* the body (matching WHILE's re-check position)
    if loop.guard is not None:
        gok = temp("gok")
        steps.append((gok, S.Case([(_and(S.Var(LIVE), fix(loop.guard)),
                                    S.Const(True))], S.Const(False))))
        steps.append((DONE, S.Case([(_and(S.Var(LIVE), _not(S.Var(gok))),
                                     S.Const(True))], S.Var(DONE))))
        steps.append((LIVE, S.Case([(_not(S.Var(gok)), S.Const(False))],
                                   S.Var(LIVE))))

    # 3. body statements, each guarded by its control context; branch
    #    predicates snapshot into temps *before* the branch body runs, so
    #    a branch that mutates variables its own predicate read cannot
    #    flip lanes mid-branch
    def ctx_expr(flag: str | None) -> S.Scalar:
        if flag is None:
            return S.Var(LIVE)
        return _and(S.Var(flag), S.Var(LIVE))

    def emit(stmts, flag):
        for st in stmts:
            sc = ctx_expr(flag)
            if isinstance(st, IR.Assign):
                steps.append((st.name,
                              S.Case([(sc, fix(st.expr))], S.Var(st.name))))
            elif isinstance(st, IR.Declare):
                init = (null_for(st.dtype) if st.init is None
                        else fix(st.init))
                steps.append((st.name, S.Case([(sc, init)], S.Var(st.name))))
            elif isinstance(st, IR.IfElse):
                pc, ec = temp("p"), temp("e")
                steps.append((pc, S.Case([(_and(sc, fix(st.pred)),
                                           S.Const(True))], S.Const(False))))
                steps.append((ec, S.Case([(_and(sc, _not(S.Var(pc))),
                                           S.Const(True))], S.Const(False))))
                emit(st.then_body, pc)
                emit(st.else_body, ec)
            elif isinstance(st, IR.Break):
                # DONE first: its guard reads __live, which the second step
                # clears — the reverse order would never stick
                steps.append((DONE, S.Case([(sc, S.Const(True))],
                                           S.Var(DONE))))
                steps.append((LIVE, S.Case([(sc, S.Const(False))],
                                           S.Var(LIVE))))
            else:  # pragma: no cover — classify() rejects everything else
                raise AssertionError(
                    f"unloweredable statement {type(st).__name__}")

    emit(loop.body, None)
    return R.LoopScan(loop.plan, carry, steps, "scan", None, outputs)
