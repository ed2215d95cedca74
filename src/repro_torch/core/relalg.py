"""Port of ``src/repro/core/relalg.py:1-435`` (a copy).

Relational algebra plan nodes.

Execution is mask-based ("selection vectors"): filters never compact rows,
they AND into a row mask — the TPU adaptation that keeps every operator
static-shaped and therefore jit/pjit-compilable.  The Apply operator
(Galindo-Legaria & Joshi; paper §3.2) is a first-class node:

    R  A⊗  E  =  ⋃_{r∈R} ({r} ⊗ E(r))

with join types cross / outer / semi / anti, plus the probe/pass-through
variant used for early RETURNs (paper §4.2.1).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

from repro_torch.core import scalar as S

_ids = itertools.count()


class RelNode:
    """Base plan node."""

    def __init__(self):
        self.node_id = next(_ids)

    def children(self) -> list["RelNode"]:
        return []

    def with_children(self, kids: list["RelNode"]) -> "RelNode":
        assert not kids
        return self

    def exprs(self) -> list[S.Scalar]:
        return []


class Scan(RelNode):
    """Scan of a named base table in the catalog."""

    def __init__(self, table: str, alias: str | None = None):
        super().__init__()
        self.table = table
        self.alias = alias or table

    def __repr__(self):
        return f"Scan({self.table})"


class ConstantScan(RelNode):
    """One row, no columns (paper §4.2.1)."""

    def __repr__(self):
        return "ConstantScan"


class Compute(RelNode):
    """ComputeScalar: add/overwrite computed columns on each row."""

    def __init__(self, child: RelNode, exprs: dict[str, S.Scalar]):
        super().__init__()
        self.child = child
        self.computed = {k: S.wrap(v) for k, v in exprs.items()}

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Compute(kids[0], self.computed)

    def exprs(self):
        return list(self.computed.values())

    def __repr__(self):
        return f"Compute({self.child!r}, {list(self.computed)})"


class Project(RelNode):
    """Keep only ``cols`` (optionally renaming via ``{new: old}``)."""

    def __init__(self, child: RelNode, cols: Sequence[str] | dict[str, str]):
        super().__init__()
        self.child = child
        if isinstance(cols, dict):
            self.cols = dict(cols)
        else:
            self.cols = {c: c for c in cols}

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Project(kids[0], self.cols)

    def __repr__(self):
        return f"Project({self.child!r}, {list(self.cols)})"


class Filter(RelNode):
    def __init__(self, child: RelNode, pred: S.Scalar):
        super().__init__()
        self.child = child
        self.pred = S.wrap(pred)

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Filter(kids[0], self.pred)

    def exprs(self):
        return [self.pred]

    def __repr__(self):
        return f"Filter({self.child!r}, {self.pred!r})"


class Join(RelNode):
    """Equi-join on key column pairs.  ``kind`` in inner|left|semi|anti.

    The build (right) side must be key-unique for inner/left joins — the
    engine verifies this at execution.  Lowered to a dense-key gather when
    the build keys form a dense integer range (FK join), else to
    sort + searchsorted (sort-merge; TPU-friendly, no hash tables).
    """

    def __init__(
        self,
        left: RelNode,
        right: RelNode,
        on: Sequence[tuple[str, str]],
        kind: str = "inner",
    ):
        super().__init__()
        assert kind in ("inner", "left", "semi", "anti"), kind
        self.left, self.right, self.on, self.kind = left, right, list(on), kind

    def children(self):
        return [self.left, self.right]

    def with_children(self, kids):
        return Join(kids[0], kids[1], self.on, self.kind)

    def __repr__(self):
        return f"Join[{self.kind}]({self.left!r}, {self.right!r}, on={self.on})"


class Apply(RelNode):
    """Correlated apply.  ``right`` may contain Outer(col) references to the
    current left row.  kinds: cross | outer | semi | anti.

    probe/pass-through (paper §4.2.1): when ``passthrough`` is set (a scalar
    predicate over left columns), rows where it evaluates TRUE bypass the
    right side entirely (their right-side columns are NULL); used to stop
    evaluation after an early RETURN."""

    def __init__(
        self,
        left: RelNode,
        right: RelNode,
        kind: str = "outer",
        passthrough: S.Scalar | None = None,
    ):
        super().__init__()
        assert kind in ("cross", "outer", "semi", "anti"), kind
        self.left, self.right, self.kind = left, right, kind
        self.passthrough = passthrough

    def children(self):
        return [self.left, self.right]

    def with_children(self, kids):
        return Apply(kids[0], kids[1], self.kind, self.passthrough)

    def exprs(self):
        return [self.passthrough] if self.passthrough is not None else []

    def __repr__(self):
        return f"Apply[{self.kind}]({self.left!r}, {self.right!r})"


@dataclasses.dataclass
class AggSpec:
    fn: str  # sum | count | count_star | min | max | avg
    expr: S.Scalar | None  # None for count_star


class GroupAgg(RelNode):
    """Grouped aggregation.  keys == [] is a full-table aggregate (1 row).

    ``capacity``: static upper bound on group count for jit paths; the
    eager executor computes exact groups host-side when unset."""

    def __init__(
        self,
        child: RelNode,
        keys: Sequence[str],
        aggs: dict[str, AggSpec | tuple],
        capacity: int | None = None,
        dense_range: tuple[int, int] | None = None,
    ):
        super().__init__()
        self.child = child
        self.keys = list(keys)
        self.aggs: dict[str, AggSpec] = {}
        for name, spec in aggs.items():
            if isinstance(spec, tuple):
                fn, expr = spec
                spec = AggSpec(fn, None if expr is None else S.wrap(expr))
            self.aggs[name] = spec
        self.capacity = capacity
        # stats-derived: key values densely cover [lo, hi] -> the executor
        # uses direct gid = key - lo segmenting (no sort)
        self.dense_range = dense_range

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return GroupAgg(kids[0], self.keys, dict(self.aggs), self.capacity,
                        self.dense_range)

    def exprs(self):
        return [a.expr for a in self.aggs.values() if a.expr is not None]

    def __repr__(self):
        return f"GroupAgg({self.child!r}, keys={self.keys}, aggs={list(self.aggs)})"


class Sort(RelNode):
    def __init__(
        self,
        child: RelNode,
        keys: Sequence[tuple[str, bool]],  # (col, ascending)
        limit: int | None = None,
    ):
        super().__init__()
        self.child = child
        self.keys = list(keys)
        self.limit = limit

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Sort(kids[0], self.keys, self.limit)

    def __repr__(self):
        return f"Sort({self.child!r}, {self.keys}, limit={self.limit})"


class LoopScan(RelNode):
    """A rewritten cursor loop (Aggify): fold the child relation's rows, in
    order, into a single-row output — the relational operator the loop
    rewrite pass (the reference's ``repro/loops/rewrite.py``) produces.

    ``carry`` maps state names to their loop-entry init expressions
    (evaluated once per execution, referencing only Outer/Param/Const).
    Two lowerings, chosen by ``kind``:

    * ``"scan"``: ``steps`` is an ordered list of ``(name, expr)`` updates
      evaluated per row under ``lax.scan``; exprs reference carried state
      via ``Var(name)`` and the current cursor row via ``ColRef(col)``.
      The reserved carried flag ``__done`` (sticky loop exit: BREAK or a
      failed guard) and the per-row ``__live`` pseudo-variable implement
      predicated early exit.
    * ``"reduce"``: the fold is commutative — ``reductions`` maps each
      output to ``(mode, op_or_col, term, pred)``: ``("fold", "+"|"*",
      term, pred|None)`` lowers to a masked ``sum``/``prod`` over the
      relation, ``("last", col, None, None)`` to a last-active-row gather
      (the final fetch-variable value).

    Output: one row, columns ``outputs`` (the loop's live-out variables).
    Attribute order keeps the child first — fingerprinting (``_norm``) and
    rewrites rely on children-before-exprs ordering."""

    def __init__(
        self,
        child: RelNode,
        carry: dict[str, S.Scalar],
        steps: Sequence[tuple[str, S.Scalar]],
        kind: str = "scan",
        reductions: dict[str, tuple] | None = None,
        outputs: Sequence[str] = (),
    ):
        super().__init__()
        assert kind in ("scan", "reduce"), kind
        self.child = child
        self.carry = {k: S.wrap(v) for k, v in carry.items()}
        self.steps = [(n, S.wrap(e)) for n, e in steps]
        self.kind = kind
        self.reductions = dict(reductions or {})
        self.outputs = list(outputs)

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return LoopScan(kids[0], self.carry, self.steps, self.kind,
                        self.reductions, self.outputs)

    def exprs(self):
        out = list(self.carry.values()) + [e for _, e in self.steps]
        for mode, _, term, pred in self.reductions.values():
            if term is not None:
                out.append(term)
            if pred is not None:
                out.append(pred)
        return out

    def map_exprs(self, fn) -> "LoopScan":
        """Rebuild with every scalar expression passed through ``fn`` — the
        generic hook plan-rewriters (binder substitution, optimizer
        expression passes) use instead of per-node cases."""
        carry = {k: fn(v) for k, v in self.carry.items()}
        steps = [(n, fn(e)) for n, e in self.steps]
        reds = {
            k: (mode, op,
                None if term is None else fn(term),
                None if pred is None else fn(pred))
            for k, (mode, op, term, pred) in self.reductions.items()
        }
        return LoopScan(self.child, carry, steps, self.kind, reds,
                        self.outputs)

    def __repr__(self):
        return (f"LoopScan[{self.kind}]({self.child!r}, "
                f"outputs={self.outputs})")


# ---------------------------------------------------------------------------
# Traversal / rewrite helpers
# ---------------------------------------------------------------------------


def walk_plan(node: RelNode):
    yield node
    for c in node.children():
        yield from walk_plan(c)


def embedded_plans(node: RelNode):
    """The relational plans embedded in ``node``'s own scalar expressions
    (``ScalarSubquery`` / ``Exists``), each yielded once.  The scalar
    traversal stays shallow — plans nested *inside* an embedded plan are
    that plan's business; recurse at the plan level (as
    :func:`walk_plan_deep` does) to reach them.  The single source of
    truth for expression→plan descent: the merge pass's marking and the
    session's occurrence planning both reuse it, so candidate discovery
    and answering can never disagree on what counts as an embedded plan."""
    for e in node.exprs():
        stack = [e]
        while stack:
            x = stack.pop()
            if isinstance(x, (S.ScalarSubquery, S.Exists)):
                yield x.plan
            stack.extend(x.children())


def walk_plan_deep(node: RelNode):
    """Like :func:`walk_plan`, but also descends into the relational plans
    embedded in scalar expressions (:func:`embedded_plans`) — the full set
    of plan nodes an execution of ``node`` may run."""
    yield node
    for p in embedded_plans(node):
        yield from walk_plan_deep(p)
    for c in node.children():
        yield from walk_plan_deep(c)


def node_exprs(node: RelNode) -> list[S.Scalar]:
    return node.exprs()


def transform_plan(node: RelNode, fn) -> RelNode:
    """Bottom-up plan rewrite; ``fn(node) -> node|None`` (identity compare)."""
    old = node.children()
    kids = [transform_plan(c, fn) for c in old]
    if any(a is not b for a, b in zip(kids, old)):
        node = node.with_children(kids)
    out = fn(node)
    return node if out is None else out


def plan_size(node: RelNode) -> int:
    """Operator count including scalar expression nodes — the paper's
    'size of algebrized tree' constraint (§7.2)."""
    total = 0
    for n in walk_plan(node):
        total += 1
        for e in n.exprs():
            total += sum(1 for _ in S.walk(e))
        if isinstance(n, Compute):
            for e in n.computed.values():
                for sub in S.walk(e):
                    if isinstance(sub, (S.ScalarSubquery, S.Exists)):
                        total += plan_size(sub.plan)
    return total


def output_columns(node: RelNode, catalog) -> list[str]:
    """Static schema inference (column names only)."""
    if isinstance(node, Scan):
        return list(catalog[node.table].names())
    if isinstance(node, ConstantScan):
        return []
    if isinstance(node, Compute):
        base = output_columns(node.child, catalog)
        return base + [c for c in node.computed if c not in base]
    if isinstance(node, Project):
        return list(node.cols.keys())
    if isinstance(node, Filter):
        return output_columns(node.child, catalog)
    if isinstance(node, Join):
        l = output_columns(node.left, catalog)
        if node.kind in ("semi", "anti"):
            return l
        r = output_columns(node.right, catalog)
        return l + [c for c in r if c not in l]
    if isinstance(node, Apply):
        l = output_columns(node.left, catalog)
        if node.kind in ("semi", "anti"):
            return l
        r = output_columns(node.right, catalog)
        return l + [c for c in r if c not in l]
    if isinstance(node, GroupAgg):
        return list(node.keys) + list(node.aggs.keys())
    if isinstance(node, Sort):
        return output_columns(node.child, catalog)
    if isinstance(node, LoopScan):
        return list(node.outputs)
    raise TypeError(type(node))
