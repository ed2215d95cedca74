"""Port of ``src/repro/core/ir.py:1-235`` (a copy).

Imperative UDF IR: statements, regions, and function definitions.

Mirrors the paper's supported constructs (§3.4, Table 1):
DECLARE / SET / SELECT-assign / IF-ELSE (arbitrary nesting) / RETURN
(single or multiple) / nested UDF calls / EXISTS / ISNULL — plus the loop
forms the paper disabled (§4.2.1): WHILE and cursor loops.  Cursor loops
go through the Aggify-style rewrite in :mod:`repro_torch.loops`; loops the
rewrite rejects fall back to the per-row interpreter.

Region construction (§4.1): a statement list splits into a hierarchy of
*sequential* regions (maximal runs of straight-line statements) and
*conditional* regions (IF-ELSE), each of which the algebrizer turns into one
single-row derived table.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import scalar as S


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


class Statement:
    pass


@dataclasses.dataclass
class Declare(Statement):
    name: str
    dtype: str = "float32"  # float32 | int32 | bool | str | date
    init: S.Scalar | None = None  # None => NULL (paper §4.2.1)


@dataclasses.dataclass
class Assign(Statement):
    """SET @name = expr  (also models single-variable SELECT-assign; the
    frontend lowers multi-assign SELECTs to several Assigns — paper §4.2.1
    notes Froid does exactly this and relies on CSE for the duplication)."""

    name: str
    expr: S.Scalar


@dataclasses.dataclass
class IfElse(Statement):
    pred: S.Scalar
    then_body: list[Statement]
    else_body: list[Statement]


@dataclasses.dataclass
class Return(Statement):
    expr: S.Scalar


@dataclasses.dataclass
class Break(Statement):
    """BREAK — exits the innermost enclosing loop."""


@dataclasses.dataclass
class While(Statement):
    """WHILE pred BEGIN body END — a general (non-cursor) loop.

    Never algebrizable (no driving relation): FROID falls back to the
    interpreter; the scan-mode interpreter runs it as a host loop that reads
    its condition each iteration (the reference's ``lax.while_loop``)."""

    pred: S.Scalar
    body: list[Statement]


@dataclasses.dataclass
class Fetch(Statement):
    """FETCH NEXT FROM cursor INTO @a, @b — a frontend marker.

    The parser folds the priming FETCH plus the trailing in-loop FETCH into
    the enclosing :class:`CursorLoop`; a Fetch that survives into a UDF body
    (fetch outside a recognised loop shape) is rejected downstream."""

    cursor: str
    targets: list[tuple[str, str]]  # (variable, cursor column)


@dataclasses.dataclass
class CursorLoop(Statement):
    """A cursor-driven loop: iterate ``plan``'s rows in order, binding each
    row's columns to ``targets`` variables, then running ``body``.

    ``guard`` is an optional extra termination conjunct (beyond the implicit
    ``@@fetch_status = 0``): per row the semantics are *bind fetch vars,
    evaluate guard, stop the loop if not true, else run body*."""

    cursor: str
    plan: "object"  # R.RelNode — typed loosely to keep ir free of relalg
    targets: list[tuple[str, str]]  # (variable, cursor column)
    body: list[Statement]
    guard: S.Scalar | None = None


# ---------------------------------------------------------------------------
# Regions (paper §4.1)
# ---------------------------------------------------------------------------


class Region:
    pass


@dataclasses.dataclass
class SeqRegion(Region):
    """A maximal straight-line run of Declare/Assign/Return statements."""

    statements: list[Statement]


@dataclasses.dataclass
class CondRegion(Region):
    pred: S.Scalar
    then_regions: list[Region]
    else_regions: list[Region]


def build_regions(body: Sequence[Statement]) -> list[Region]:
    """Single pass over the UDF body (paper: 'Regions can be constructed in
    a single pass')."""
    out: list[Region] = []
    run: list[Statement] = []

    def flush():
        nonlocal run
        if run:
            out.append(SeqRegion(run))
            run = []

    for st in body:
        if isinstance(st, IfElse):
            flush()
            out.append(
                CondRegion(
                    st.pred, build_regions(st.then_body), build_regions(st.else_body)
                )
            )
        else:
            run.append(st)
            if isinstance(st, Return):
                # statements after an unconditional RETURN are unreachable —
                # drop them (dead-code elimination at region construction)
                flush()
                return out
    flush()
    return out


# ---------------------------------------------------------------------------
# Function definition
# ---------------------------------------------------------------------------

_DTYPES = {"float32", "int32", "bool", "str", "date"}


@dataclasses.dataclass
class UdfDef:
    name: str
    params: list[tuple[str, str]]  # (name, dtype)
    return_dtype: str
    body: list[Statement]

    def __post_init__(self):
        for _, dt in self.params:
            assert dt in _DTYPES, dt
        assert self.return_dtype in _DTYPES

    def regions(self) -> list[Region]:
        return build_regions(self.body)

    # -- analyses ------------------------------------------------------------
    def all_exprs(self):
        yield from walk_stmt_exprs(self.body)

    def is_deterministic(self) -> bool:
        return all(S.is_deterministic(e) for e in self.all_exprs())

    def called_udfs(self) -> set[str]:
        out = set()
        for e in self.all_exprs():
            for node in S.walk(e):
                if isinstance(node, S.UdfCall):
                    out.add(node.name)
        return out

    def statement_count(self) -> int:
        def count(stmts):
            n = 0
            for st in stmts:
                n += 1
                if isinstance(st, IfElse):
                    n += count(st.then_body) + count(st.else_body)
                elif isinstance(st, (While, CursorLoop)):
                    n += count(st.body)
            return n

        return count(self.body)


def walk_stmt_exprs(stmts: Sequence[Statement]):
    """Every scalar expression reachable from ``stmts``, including those
    embedded in cursor-defining plans (so determinism / called-UDF analyses
    see through loops)."""
    from repro_torch.core import relalg as R

    for st in stmts:
        if isinstance(st, Declare) and st.init is not None:
            yield st.init
        elif isinstance(st, Assign):
            yield st.expr
        elif isinstance(st, Return):
            yield st.expr
        elif isinstance(st, IfElse):
            yield st.pred
            yield from walk_stmt_exprs(st.then_body)
            yield from walk_stmt_exprs(st.else_body)
        elif isinstance(st, While):
            yield st.pred
            yield from walk_stmt_exprs(st.body)
        elif isinstance(st, CursorLoop):
            if st.guard is not None:
                yield st.guard
            for n in R.walk_plan_deep(st.plan):
                yield from n.exprs()
            yield from walk_stmt_exprs(st.body)
