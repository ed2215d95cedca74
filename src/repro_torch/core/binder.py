"""Port of ``src/repro/core/binder.py:1-280`` (a copy with numpy dtype tags).

Binding-time UDF substitution (paper §5, §7.1, §7.2).

Froid performs inlining during *binding*, not cost-based optimization: when a
``UdfCall`` is encountered, the UDF body is algebrized (cached per UDF) and
substituted as a correlated scalar subquery, with formal parameters replaced
by actual-argument expressions (rewritten into the subquery's outer scope)
plus explicit type casts (§7.4).  The process repeats for nested calls until
a fixpoint — bounded by ``max_depth`` and ``max_plan_size`` (§7.2): when the
budget is exhausted, remaining ``UdfCall``s are left for the iterative
interpreter (hybrid execution, exactly the paper's fallback).
"""
from __future__ import annotations

import numpy as np

import dataclasses
import re


from repro_torch.core import algebrizer as A
from repro_torch.core import ir as IR
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S

_SSA = re.compile(r".*__\d+$")

_CAST_DTYPES = {
    "float32": np.float32,
    "int32": np.int32,
    "date": np.int32,
    "bool": np.bool_,
}


@dataclasses.dataclass
class InlineConstraints:
    """§7.2 knobs: bound the algebrized tree."""

    max_depth: int = 8
    max_plan_size: int = 50_000
    enabled: bool = True


class Binder:
    def __init__(self, registry: dict[str, IR.UdfDef],
                 constraints: InlineConstraints | None = None):
        self.registry = registry
        self.constraints = constraints or InlineConstraints()
        self._algebrized: dict[str, R.RelNode | None] = {}
        self._inline_id = 0
        self.stats = {"inlined": 0, "skipped": 0}

    # ------------------------------------------------------------------
    def algebrized(self, name: str) -> R.RelNode | None:
        """Algebrize (and cache) a UDF; None if not inlineable."""
        if name not in self._algebrized:
            udf = self.registry.get(name)
            if udf is None:
                self._algebrized[name] = None
            else:
                try:
                    self._algebrized[name] = A.algebrize(udf)
                except A.AlgebrizeError:
                    self._algebrized[name] = None
        return self._algebrized[name]

    # ------------------------------------------------------------------
    def bind(self, plan: R.RelNode) -> R.RelNode:
        """Normalize UdfCalls into Compute columns, then inline to fixpoint."""
        if not self.constraints.enabled:
            return plan
        plan = _normalize_udf_calls(plan)
        for _ in range(self.constraints.max_depth):
            plan, changed = self._inline_pass(plan)
            if not changed:
                break
            plan = _normalize_udf_calls(plan)
        return plan

    # ------------------------------------------------------------------
    def _inline_pass(self, plan: R.RelNode):
        changed = [False]
        budget = self.constraints.max_plan_size - R.plan_size(plan)

        def fix_expr(e: S.Scalar) -> S.Scalar:
            def f(x):
                nonlocal budget
                if isinstance(x, S.ScalarSubquery):
                    p2, ch = self._inline_in_plan(x.plan, fix_expr)
                    if ch:
                        changed[0] = True
                        return S.ScalarSubquery(p2, x.column, x.agg_default)
                    return None
                if isinstance(x, S.Exists):
                    p2, ch = self._inline_in_plan(x.plan, fix_expr)
                    if ch:
                        changed[0] = True
                        return S.Exists(p2, x.negated)
                    return None
                if not isinstance(x, S.UdfCall):
                    return None
                body = self.algebrized(x.name)
                if body is None:
                    self.stats["skipped"] += 1
                    return None
                size = R.plan_size(body)
                if size > budget:
                    self.stats["skipped"] += 1
                    return None  # §7.2: tree-size constraint hit
                budget -= size
                changed[0] = True
                self.stats["inlined"] += 1
                return self._substitute(x)
            return S.transform(e, f)

        plan, _ = self._inline_in_plan(plan, fix_expr)
        return plan, changed[0]

    def _inline_in_plan(self, plan: R.RelNode, fix_expr):
        before = [False]

        def node_fn(node: R.RelNode):
            if isinstance(node, R.Compute):
                new = {k: fix_expr(v) for k, v in node.computed.items()}
                if any(new[k] is not node.computed[k] for k in new):
                    before[0] = True
                    return R.Compute(node.child, new)
            if isinstance(node, R.Filter):
                p2 = fix_expr(node.pred)
                if p2 is not node.pred:
                    before[0] = True
                    return R.Filter(node.child, p2)
            if isinstance(node, R.GroupAgg):
                aggs = {
                    k: R.AggSpec(a.fn, None if a.expr is None else fix_expr(a.expr))
                    for k, a in node.aggs.items()
                }
                if any(
                    aggs[k].expr is not node.aggs[k].expr for k in aggs
                ):
                    before[0] = True
                    return R.GroupAgg(node.child, node.keys, aggs, node.capacity,
                                  node.dense_range)
            return None

        return R.transform_plan(plan, node_fn), before[0]

    # ------------------------------------------------------------------
    def _substitute(self, call: S.UdfCall) -> S.ScalarSubquery:
        """Replace a UdfCall with its algebrized body: rename SSA columns
        (one inline site == one fresh namespace), bind actual parameters
        (rewritten into Outer scope, with explicit casts — §7.4)."""
        udf = self.registry[call.name]
        body = self.algebrized(call.name)
        self._inline_id += 1
        suffix = f"_i{self._inline_id}"

        def rn(name: str) -> str:
            if _SSA.match(name) or name == "returnVal":
                return name + suffix
            return name

        # actual parameters, rewritten into the subquery's outer scope
        args: dict[str, S.Scalar] = {}
        for (pname, pdtype), arg in zip(udf.params, call.args):
            a = S.transform(
                arg,
                lambda x: S.Outer(x.name) if isinstance(x, S.ColRef) else None,
            )
            if pdtype in _CAST_DTYPES and not isinstance(a, S.Const):
                a = S.Cast(a, _CAST_DTYPES[pdtype])
            args[pname] = a

        def fix_scalar(e: S.Scalar) -> S.Scalar:
            def f(x):
                if isinstance(x, S.ColRef):
                    return S.ColRef(rn(x.name))
                if isinstance(x, S.Outer):
                    return S.Outer(rn(x.name))
                if isinstance(x, S.Param):
                    if x.name not in args:
                        return None  # outer query's own params
                    return args[x.name]
                if isinstance(x, S.ScalarSubquery):
                    return S.ScalarSubquery(fix_plan(x.plan), x.column, x.agg_default)
                if isinstance(x, S.Exists):
                    return S.Exists(fix_plan(x.plan), x.negated)
                return None

            return S.transform(e, f)

        def fix_plan(p: R.RelNode) -> R.RelNode:
            def nf(node: R.RelNode):
                if isinstance(node, R.Compute):
                    return R.Compute(
                        node.child,
                        {rn(k): fix_scalar(v) for k, v in node.computed.items()},
                    )
                if isinstance(node, R.Filter):
                    return R.Filter(node.child, fix_scalar(node.pred))
                if isinstance(node, R.Project):
                    return R.Project(
                        node.child, {rn(k): rn(v) for k, v in node.cols.items()}
                    )
                if isinstance(node, R.GroupAgg):
                    aggs = {
                        rn(k): R.AggSpec(
                            a.fn, None if a.expr is None else fix_scalar(a.expr)
                        )
                        for k, a in node.aggs.items()
                    }
                    return R.GroupAgg(node.child, node.keys, aggs, node.capacity,
                                  node.dense_range)
                if isinstance(node, R.Apply) and node.passthrough is not None:
                    return R.Apply(
                        node.left, node.right, node.kind,
                        fix_scalar(node.passthrough),
                    )
                if hasattr(node, "map_exprs"):  # LoopScan & friends
                    return node.map_exprs(fix_scalar)
                return None

            return R.transform_plan(p, nf)

        new_plan = fix_plan(body)
        sq = S.ScalarSubquery(new_plan, "returnVal" + suffix)
        if udf.return_dtype in _CAST_DTYPES:
            return S.Cast(sq, _CAST_DTYPES[udf.return_dtype])
        return sq


# ---------------------------------------------------------------------------
# normalization: pull UdfCalls out of Filter preds / agg exprs into Computes
# so substitution always happens inside a Compute (clean splice target).
# ---------------------------------------------------------------------------


def _has_udf_call(e: S.Scalar) -> bool:
    return any(isinstance(x, S.UdfCall) for x in S.walk(e))


def _normalize_udf_calls(plan: R.RelNode) -> R.RelNode:
    ctr = [0]

    def extract(e: S.Scalar, pre: dict[str, S.Scalar]) -> S.Scalar:
        """Replace top-level-reachable UdfCalls in e with ColRefs to new
        computed columns collected in ``pre``."""

        def f(x):
            if isinstance(x, S.UdfCall):
                ctr[0] += 1
                name = f"__udf{ctr[0]}"
                pre[name] = x
                return S.ColRef(name)
            return None

        return S.transform(e, f)

    def rule(node: R.RelNode):
        if isinstance(node, R.Filter) and _has_udf_call(node.pred):
            pre: dict[str, S.Scalar] = {}
            pred = extract(node.pred, pre)
            return R.Filter(R.Compute(node.child, pre), pred)
        if isinstance(node, R.GroupAgg) and any(
            a.expr is not None and _has_udf_call(a.expr)
            for a in node.aggs.values()
        ):
            pre = {}
            aggs = {}
            for k, a in node.aggs.items():
                if a.expr is not None and _has_udf_call(a.expr):
                    aggs[k] = R.AggSpec(a.fn, extract(a.expr, pre))
                else:
                    aggs[k] = a
            return R.GroupAgg(
                R.Compute(node.child, pre), node.keys, aggs, node.capacity,
                node.dense_range,
            )
        return None

    return R.transform_plan(plan, rule)
