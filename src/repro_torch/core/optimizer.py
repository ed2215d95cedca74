"""Port of ``src/repro/core/optimizer.py:1-1169``:
a copy; constant folding evaluates on the CPU.

Relational rewrite engine (paper §5 substitution + §6 compiler opts).

Rules (each is a semantics-preserving plan rewrite, unit-tested):

* ``remove_applies``      — Apply(L, single-row derived table) → Compute(L)
                            (apply removal / decorrelation of region DTs)
* ``splice_subqueries``   — ScalarSubquery over a pure single-row region
                            chain inside a Compute → splice its columns into
                            the outer Compute (the paper's *substitution*)
* ``fuse_computes``       — Compute(Compute(X)) → Compute(X)
* ``fold_constants``      — constant folding + CASE pruning (= constant
                            propagation + dynamic slicing, §6.1/§6.2)
* ``propagate_constants`` — within a Compute chain, replace refs to columns
                            that folded to constants
* ``prune_columns``       — projection pushdown == dead-code elimination
                            (§6.3: the @t example)
* ``decorrelate_scalar_agg`` / ``decorrelate_lookup`` / ``decorrelate_exists``
                          — correlated scalar subqueries → GroupAgg + left
                            join / semi-join (the "optimizer infers the
                            joins and group-bys" step that makes plans
                            set-oriented, §5)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.core.fingerprint import _norm as _fp_norm
from repro_torch.core.fingerprint import plan_fingerprint

# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

_fresh_counter = [0]


def _fresh(base: str) -> str:
    _fresh_counter[0] += 1
    return f"{base}_x{_fresh_counter[0]}"


def _is_region_chain(plan: R.RelNode) -> bool:
    node = plan
    while isinstance(node, (R.Compute, R.Project)):
        node = node.child
    return isinstance(node, R.ConstantScan)


def _rewrite_exprs(node: R.RelNode, fn) -> R.RelNode:
    """Rebuild ``node`` with every scalar expression passed through ``fn``
    (a Scalar -> Scalar transform)."""
    if isinstance(node, R.Compute):
        return R.Compute(node.child, {k: fn(v) for k, v in node.computed.items()})
    if isinstance(node, R.Filter):
        return R.Filter(node.child, fn(node.pred))
    if isinstance(node, R.GroupAgg):
        aggs = {
            k: R.AggSpec(a.fn, None if a.expr is None else fn(a.expr))
            for k, a in node.aggs.items()
        }
        return R.GroupAgg(node.child, node.keys, aggs, node.capacity,
                                  node.dense_range)
    if isinstance(node, R.Apply) and node.passthrough is not None:
        return R.Apply(node.left, node.right, node.kind, fn(node.passthrough))
    if hasattr(node, "map_exprs"):  # LoopScan & friends
        return node.map_exprs(fn)
    return node


def _expr_outer_refs(e: S.Scalar) -> set[str]:
    """Outer refs of e, including those of embedded subquery plans."""
    out = S.free_outer(e)
    for sub in S.walk(e):
        if isinstance(sub, (S.ScalarSubquery, S.Exists)):
            from repro_torch.core.executor import _plan_outer_refs

            out |= _plan_outer_refs(sub.plan)
    return out


def _expr_col_refs(e: S.Scalar) -> set[str]:
    return S.free_cols(e)


# ---------------------------------------------------------------------------
# rule: apply removal
# ---------------------------------------------------------------------------


def remove_applies(plan: R.RelNode, catalog=None):
    """Apply(L, region-DT) with outer/cross kind → Compute(L, region cols),
    rewriting the region's Outer(c) refs to ColRef(c) (same row now).
    Outer refs *inside* nested subquery plans are left intact — they still
    refer to the (now wider) current row."""
    changed = [False]

    def fix_expr(e: S.Scalar) -> S.Scalar:
        def f(x):
            if isinstance(x, S.Outer):
                return S.ColRef(x.name)
            return None

        return S.transform(e, f)

    def rule(node: R.RelNode):
        if not isinstance(node, R.Apply) or node.kind not in ("outer", "cross"):
            return None
        if node.passthrough is not None:
            return None
        if not _is_region_chain(node.right):
            return None
        # collect the chain bottom-up
        chain = []
        cur = node.right
        while isinstance(cur, (R.Compute, R.Project)):
            chain.append(cur)
            cur = cur.child
        out = node.left
        for nd in reversed(chain):
            if isinstance(nd, R.Compute):
                out = R.Compute(
                    out, {k: fix_expr(v) for k, v in nd.computed.items()}
                )
            else:  # Project inside a region chain: narrow to region cols +
                # everything the left side already had is kept implicitly —
                # skip the narrowing here; prune_columns recovers it.
                continue
        changed[0] = True
        return out

    return R.transform_plan(plan, rule), changed[0]


# ---------------------------------------------------------------------------
# rule: splice single-row subqueries into the enclosing Compute
# ---------------------------------------------------------------------------


def splice_subqueries(plan: R.RelNode, catalog=None):
    """Compute(X, {c: f(ScalarSubquery(region-chain))}) — the shape produced
    by inlining a UDF — becomes Compute(X, {region cols..., c: f(ColRef)}).
    This is the paper's *substitution* step made explicit."""
    changed = [False]

    def rule(node: R.RelNode):
        if not isinstance(node, R.Compute):
            return None
        new_computed: dict[str, S.Scalar] = {}
        did = False
        for name, expr in node.computed.items():

            def fix(e: S.Scalar):
                nonlocal did
                if not isinstance(e, S.ScalarSubquery):
                    return None
                sub = e.plan
                # unwrap Project(Compute(ConstantScan, {...}), [col])
                rename = None
                if isinstance(sub, R.Project) and len(sub.cols) == 1:
                    (out_name, src_name), = sub.cols.items()
                    rename = (e.column or out_name, src_name)
                    sub = sub.child
                if not isinstance(sub, R.Compute) or not isinstance(
                    sub.child, R.ConstantScan
                ):
                    return None
                # splice: region-local columns become outer-row columns
                def o2c(x):
                    if isinstance(x, S.Outer):
                        return S.ColRef(x.name)
                    return None

                for cname, cexpr in sub.computed.items():
                    new_computed[cname] = S.transform(cexpr, o2c)
                did = True
                target = rename[1] if rename else e.column
                if target is None:
                    names = list(sub.computed)
                    target = names[-1]
                return S.ColRef(target)

            new_computed[name] = S.transform(expr, fix)
        if not did:
            return None
        changed[0] = True
        return R.Compute(node.child, new_computed)

    return R.transform_plan(plan, rule), changed[0]


# ---------------------------------------------------------------------------
# rule: fuse consecutive Computes
# ---------------------------------------------------------------------------


def fuse_computes(plan: R.RelNode, catalog=None):
    changed = [False]

    def rule(node: R.RelNode):
        if isinstance(node, R.Compute) and isinstance(node.child, R.Compute):
            inner = node.child
            merged = dict(inner.computed)
            merged.update(node.computed)
            if len(merged) != len(inner.computed) + len(node.computed):
                # name shadowing — only safe when SSA; bail out
                overlap = set(inner.computed) & set(node.computed)
                if overlap:
                    return None
            changed[0] = True
            return R.Compute(inner.child, merged)
        return None

    return R.transform_plan(plan, rule), changed[0]


# ---------------------------------------------------------------------------
# rule: constant folding (+ CASE pruning == dynamic slicing)
# ---------------------------------------------------------------------------


def _try_const(e: S.Scalar):
    """Return python constant if e is Const, else None-marker."""
    if isinstance(e, S.Const):
        return True, e.value
    return False, None


def _fold_expr(e: S.Scalar, changed) -> S.Scalar:
    def f(x: S.Scalar):
        if isinstance(x, (S.BinOp, S.Cmp)):
            lk, lv = _try_const(x.l)
            rk, rv = _try_const(x.r)
            if lk and rk and lv is not None and rv is not None:
                try:
                    out = _eval_const_binop(x, lv, rv)
                except Exception:
                    return None
                changed[0] = True
                return S.Const(out)
            if (lk and lv is None) or (rk and rv is None):
                changed[0] = True
                return S.Const(None)  # NULL propagates through arith/cmp
            return None
        if isinstance(x, S.BoolOp):
            vals = [(_try_const(a)) for a in x.args]
            if x.op == "not" and vals[0][0]:
                changed[0] = True
                v = vals[0][1]
                return S.Const(None if v is None else (not bool(v)))
            if x.op == "and":
                if any(k and v is not None and not v for k, v in vals):
                    changed[0] = True
                    return S.Const(False)
                rest = [a for a, (k, v) in zip(x.args, vals) if not (k and v)]
                if len(rest) < len(x.args):
                    changed[0] = True
                    if not rest:
                        return S.Const(True)
                    return rest[0] if len(rest) == 1 else S.BoolOp("and", rest)
            if x.op == "or":
                if any(k and v is not None and v for k, v in vals):
                    changed[0] = True
                    return S.Const(True)
                rest = [
                    a
                    for a, (k, v) in zip(x.args, vals)
                    if not (k and (v is not None and not v))
                ]
                if len(rest) < len(x.args):
                    changed[0] = True
                    if not rest:
                        return S.Const(False)
                    return rest[0] if len(rest) == 1 else S.BoolOp("or", rest)
            return None
        if isinstance(x, S.Case):
            # dynamic slicing: constant predicates select their branch
            new_whens = []
            for p, v in x.whens:
                k, pv = _try_const(p)
                if k:
                    if pv is not None and bool(pv):
                        changed[0] = True
                        if not new_whens:
                            return v
                        return S.Case(new_whens, v)
                    changed[0] = True  # false/NULL arm: drop it
                    continue
                new_whens.append((p, v))
            if len(new_whens) != len(x.whens):
                changed[0] = True
                if not new_whens:
                    return x.else_
                return S.Case(new_whens, x.else_)
            return None
        if isinstance(x, S.Coalesce):
            args = []
            for a in x.args:
                k, v = _try_const(a)
                if k and v is None:
                    changed[0] = True
                    continue  # NULL constant: drop
                args.append(a)
                if k:  # non-null constant: later args unreachable
                    break
            if len(args) != len(x.args):
                changed[0] = True
                if not args:
                    return S.Const(None)
                return args[0] if len(args) == 1 else S.Coalesce(args)
            return None
        if isinstance(x, S.IsNull):
            k, v = _try_const(x.expr)
            if k:
                changed[0] = True
                return S.Const(v is None)
            return None
        if isinstance(x, S.Cast):
            k, v = _try_const(x.expr)
            if k:
                changed[0] = True
                if v is None:
                    return S.Const(None)
                return S.Const(np.asarray(v).astype(x.dtype).item())
            return None
        if isinstance(x, S.Between):
            ks = [_try_const(a) for a in (x.expr, x.lo, x.hi)]
            if all(k for k, _ in ks):
                vs = [v for _, v in ks]
                if any(v is None for v in vs):
                    changed[0] = True
                    return S.Const(None)
                changed[0] = True
                return S.Const(vs[1] <= vs[0] <= vs[2])
            return None
        if isinstance(x, S.InList):
            k, v = _try_const(x.expr)
            if k:
                changed[0] = True
                return S.Const(None if v is None else v in x.options)
            return None
        if isinstance(x, S.Func) and x.name not in S.Func.NON_DETERMINISTIC:
            consts = [_try_const(a) for a in x.args]
            if all(k for k, _ in consts) and x.args:
                try:
                    vals = {}
                    out = S.eval_scalar(x, vals, S.EvalContext())
                    data = np.asarray(out.data)
                    ok = bool(np.asarray(out.validity()))
                    changed[0] = True
                    return S.Const(data.item() if ok else None)
                except Exception:
                    return None
        return None

    return S.transform(e, f)


def _eval_const_binop(x, lv, rv):
    if isinstance(x, S.Cmp):
        if isinstance(lv, str) or isinstance(rv, str):
            ops = {"==": lv == rv, "!=": lv != rv, "<": lv < rv,
                   "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv}
            return ops[x.op]
        a, b = np.asarray(lv), np.asarray(rv)
        return bool({"==": a == b, "!=": a != b, "<": a < b,
                     "<=": a <= b, ">": a > b, ">=": a >= b}[x.op])
    if isinstance(lv, str) or isinstance(rv, str):
        raise TypeError("no constant string arithmetic")
    a, b = lv, rv
    out = {"+": a + b, "-": a - b, "*": a * b,
           "/": (a / b if b != 0 else None),
           "//": (a // b if b != 0 else None),
           "%": (a % b if b != 0 else None)}[x.op]
    return out


def fold_constants(plan: R.RelNode, catalog=None):
    changed = [False]

    def rule(node: R.RelNode):
        out = _rewrite_exprs(node, lambda e: _fold_expr(e, changed))
        return out if changed[0] else None

    # run expr folding everywhere (including inside subquery plans)
    def deep(node: R.RelNode):
        node2 = _rewrite_exprs(node, lambda e: _fold_and_recurse(e, changed))
        return node2

    def _fold_and_recurse(e, changed):
        def f(x):
            if isinstance(x, S.ScalarSubquery):
                sub, ch = fold_constants(x.plan, catalog)
                if ch:
                    changed[0] = True
                    return S.ScalarSubquery(sub, x.column, x.agg_default)
            if isinstance(x, S.Exists):
                sub, ch = fold_constants(x.plan, catalog)
                if ch:
                    changed[0] = True
                    return S.Exists(sub, x.negated)
            return None

        e = S.transform(e, f)
        return _fold_expr(e, changed)

    return R.transform_plan(plan, deep), changed[0]


# ---------------------------------------------------------------------------
# rule: constant propagation within a Compute
# ---------------------------------------------------------------------------


def propagate_constants(plan: R.RelNode, catalog=None):
    changed = [False]

    def rule(node: R.RelNode):
        if not isinstance(node, R.Compute):
            return None
        consts: dict[str, S.Const] = {}
        new: dict[str, S.Scalar] = {}
        did = False

        def subst(e: S.Scalar) -> S.Scalar:
            def f(x):
                nonlocal did
                if isinstance(x, (S.ColRef, S.Outer)) and x.name in consts:
                    did = True
                    return S.Const(consts[x.name].value)
                if isinstance(x, S.ScalarSubquery):
                    p2 = _subst_plan(x.plan)
                    if p2 is not x.plan:
                        return S.ScalarSubquery(p2, x.column, x.agg_default)
                if isinstance(x, S.Exists):
                    p2 = _subst_plan(x.plan)
                    if p2 is not x.plan:
                        return S.Exists(p2, x.negated)
                return None

            return S.transform(e, f)

        def _subst_plan(p: R.RelNode) -> R.RelNode:
            def fn(nd):
                out = _rewrite_exprs(nd, subst)
                return out

            return R.transform_plan(p, fn)

        for name, expr in node.computed.items():
            e2 = subst(expr)
            new[name] = e2
            if isinstance(e2, S.Const):
                consts[name] = e2
        if not did:
            return None
        changed[0] = True
        return R.Compute(node.child, new)

    return R.transform_plan(plan, rule), changed[0]


# ---------------------------------------------------------------------------
# rule: projection pushdown / dead column elimination
# ---------------------------------------------------------------------------


def prune_columns(plan: R.RelNode, catalog=None, required: set[str] | None = None):
    """Top-down DCE: drop computed columns nothing references (§6.3)."""
    changed = [False]

    def needed_of_expr(e: S.Scalar) -> set[str]:
        return _expr_col_refs(e) | _expr_outer_refs(e)

    def rec(node: R.RelNode, req: set[str] | None) -> R.RelNode:
        # req == None means "keep everything" (unknown consumer)
        if isinstance(node, R.Project):
            child_req = set(node.cols.values())
            return R.Project(rec(node.child, child_req), node.cols)
        if isinstance(node, R.Compute):
            if req is None:
                return R.Compute(rec(node.child, None), node.computed)
            keep: dict[str, S.Scalar] = {}
            needed = set(req)
            for name in reversed(list(node.computed)):
                expr = node.computed[name]
                if name in needed:
                    keep[name] = expr
                    needed |= needed_of_expr(expr)
            if len(keep) != len(node.computed):
                changed[0] = True
            keep = {k: keep[k] for k in node.computed if k in keep}
            child_req = (needed - set(keep)) | {
                r for r in needed if r not in node.computed
            }
            return R.Compute(rec(node.child, child_req), keep)
        if isinstance(node, R.Filter):
            child_req = None if req is None else req | needed_of_expr(node.pred)
            return R.Filter(rec(node.child, child_req), node.pred)
        if isinstance(node, R.Sort):
            child_req = None if req is None else req | {k for k, _ in node.keys}
            return R.Sort(rec(node.child, child_req), node.keys, node.limit)
        if isinstance(node, R.GroupAgg):
            child_req = set(node.keys)
            for a in node.aggs.values():
                if a.expr is not None:
                    child_req |= needed_of_expr(a.expr)
            return R.GroupAgg(
                rec(node.child, child_req), node.keys, dict(node.aggs),
                node.capacity, node.dense_range,
            )
        if isinstance(node, R.Join):
            lk = {l for l, _ in node.on}
            rk = {r for _, r in node.on}
            # redundant-join elimination: a left join against a key-unique
            # build whose columns nothing references preserves left rows
            # exactly — drop it (this is how a dead decorrelated subquery
            # disappears entirely, §6.3)
            if node.kind == "left" and req is not None and catalog is not None:
                try:
                    rcols = set(R.output_columns(node.right, catalog))
                except Exception:
                    rcols = None
                if rcols is not None and not (req & rcols):
                    changed[0] = True
                    return rec(node.left, req)
            lreq = None if req is None else (req | lk)
            rreq = None if req is None else (req | rk)
            return R.Join(
                rec(node.left, lreq), rec(node.right, rreq), node.on, node.kind
            )
        if isinstance(node, R.Apply):
            # conservative: right side's outer refs must stay available
            from repro_torch.core.executor import _plan_outer_refs

            lreq = None if req is None else req | _plan_outer_refs(node.right)
            if node.passthrough is not None and lreq is not None:
                lreq |= needed_of_expr(node.passthrough)
            return R.Apply(
                rec(node.left, lreq), rec(node.right, None), node.kind,
                node.passthrough,
            )
        return node

    return rec(plan, required), changed[0]


# ---------------------------------------------------------------------------
# decorrelation rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _CorrPattern:
    table_plan: R.RelNode  # the uncorrelated (residual) chain, rebuilt
    keys: list  # [(inner key column, outer-row key expression), ...]


def _split_conjuncts(pred: S.Scalar) -> list[S.Scalar]:
    if isinstance(pred, S.BoolOp) and pred.op == "and":
        out = []
        for a in pred.args:
            out += _split_conjuncts(a)
        return out
    return [pred]


def _is_outer_key_expr(e: S.Scalar) -> bool:
    """True if e is an expression over the outer row only (>=1 Outer ref,
    no ColRefs/subqueries) — usable as a join key computed on the left."""
    if not S.free_outer(e):
        return False
    for x in S.walk(e):
        if isinstance(x, (S.ColRef, S.ScalarSubquery, S.Exists, S.UdfCall, S.Var)):
            return False
    return True


def _corr_digest(*parts) -> str:
    """Six-hex-digit content digest naming decorrelated plumbing columns.
    Content-derived (unlike ``_fresh``'s process-global counter), so the
    same query rewrites to byte-identical column names in every process —
    the rewritten plan fingerprints stably into all cache tiers and the
    persistent store."""
    import hashlib

    return hashlib.sha1(repr(parts).encode()).hexdigest()[:6]


def _match_corr_filter(plan: R.RelNode) -> _CorrPattern | None:
    """Match a ``[Filter|Compute|Project]*`` chain over an uncorrelated base
    whose filter conjuncts contain one or more ``ColRef(k) == g(Outer…)``
    equi-correlations (g any pure outer-row expression, e.g. a Cast the
    binder inserted) and whose every other conjunct / interposed
    computation is uncorrelated.

    Returns the chain rebuilt with the correlated conjuncts removed plus
    the (key column, outer expression) pairs.  A correlation key column
    must survive to the chain's output unchanged — not overwritten by a
    Compute nor dropped/renamed by a Project sitting above its Filter —
    else the pattern does not apply (caller keeps the per-row apply)."""
    spine: list[tuple[str, object]] = []  # top-down rebuild recipe
    corr: list[tuple[str, S.Scalar, int]] = []  # (key col, outer expr, depth)
    node = plan
    while True:
        if isinstance(node, R.Filter):
            residual = []
            for p in _split_conjuncts(node.pred):
                if isinstance(p, S.Cmp) and p.op == "==":
                    if isinstance(p.l, S.ColRef) and _is_outer_key_expr(p.r):
                        corr.append((p.l.name, p.r, len(spine)))
                        continue
                    if isinstance(p.r, S.ColRef) and _is_outer_key_expr(p.l):
                        corr.append((p.r.name, p.l, len(spine)))
                        continue
                if _expr_outer_refs(p):
                    return None
                residual.append(p)
            spine.append(("filter", residual))
            node = node.child
            continue
        if isinstance(node, R.Compute):
            if any(_expr_outer_refs(e) for e in node.computed.values()):
                return None
            spine.append(("node", node))
            node = node.child
            continue
        if isinstance(node, R.Project):
            spine.append(("node", node))
            node = node.child
            continue
        break
    from repro_torch.core.executor import _plan_outer_refs

    if not corr or _plan_outer_refs(node):
        return None
    for key, _, depth in corr:
        for kind, nd in spine[:depth]:
            if kind != "node":
                continue
            if isinstance(nd, R.Compute) and key in nd.computed:
                return None
            if isinstance(nd, R.Project) and nd.cols.get(key) != key:
                return None
    inner = node
    for kind, payload in reversed(spine):
        if kind == "filter":
            for p in payload:
                inner = R.Filter(inner, p)
        else:
            inner = payload.with_children([inner])
    # dedupe repeated conjuncts, keeping first-seen (deterministic) order
    keys, seen = [], set()
    for key, expr, _ in corr:
        sig = (key, _fp_norm(expr))
        if sig not in seen:
            seen.add(sig)
            keys.append((key, expr))
    return _CorrPattern(inner, keys)


def _left_key_cols(pat: _CorrPattern, child: R.RelNode, tag: str):
    """Return (child', [key col names]) for joining ``child`` on the
    pattern's outer-key expressions: plain ``Outer(c)`` keys join on the
    column directly, expression keys get computed under a content-derived
    ``__dck`` name."""
    cols: list[str] = []
    computed: dict[str, S.Scalar] = {}
    for j, (_, e) in enumerate(pat.keys):
        if isinstance(e, S.Outer):
            cols.append(e.name)
            continue
        kc = f"__dck{tag}_{j}"
        computed[kc] = S.transform(
            e, lambda x: S.ColRef(x.name) if isinstance(x, S.Outer) else None
        )
        cols.append(kc)
    if computed:
        child = R.Compute(child, computed)
    return child, cols


def _outer_keys_available(pat: _CorrPattern, child: R.RelNode, catalog) -> bool:
    """The correlation may reference a scope further out than ``child``
    (e.g. inside a not-yet-spliced region chain) — only decorrelate when
    every Outer ref resolves to a column ``child`` produces."""
    names: set[str] = set()
    for _, e in pat.keys:
        names |= S.free_outer(e)
    if not names:
        return False
    try:
        cols = set(R.output_columns(child, catalog or {}))
    except Exception:
        return False
    return names <= cols


def _group_key(kind: str, pat: _CorrPattern) -> tuple:
    """Shared-build identity: two occurrences with the same (uncorrelated
    body, key columns, outer key expressions) materialize ONE build joined
    back once — the shared-scan materialization step."""
    return (
        kind,
        plan_fingerprint(pat.table_plan),
        tuple(k for k, _ in pat.keys),
        tuple(_fp_norm(e) for _, e in pat.keys),
    )


def decorrelate_in_computes(plan: R.RelNode, catalog=None):
    """Rewrite correlated ScalarSubquery/Exists inside Compute exprs into
    left joins against grouped/keyed builds — the step that turns iterative
    nested evaluation into set-oriented joins (paper §5, Figure 5).

    The inner scan then runs once per *distinct binding* instead of once
    per outer row.  Handled shapes: multi-aggregate ``GroupAgg`` bodies,
    multi-key equi-correlations, pure Compute/Project chains between the
    correlated filter and the aggregate, correlations on columns computed
    in the *same* Compute (substituted into the join key), EXISTS (as a
    ``count_star`` build), and projection lookups.  Occurrences sharing a
    body+key identity share one materialized build (aggregates merge into
    one keyed GroupAgg); anything that doesn't match keeps today's per-row
    apply — never an error."""
    changed = [False]

    def rule(node: R.RelNode):
        if not isinstance(node, R.Compute):
            return None
        child = node.child

        groups: dict[tuple, dict] = {}
        order: list[tuple] = []
        repl: dict[int, tuple] = {}  # id(expr node) -> (group key, member)
        defined_before: set[str] = set()
        subst: dict[str, S.Scalar] = {}

        def shallow(e: S.Scalar):
            """Walk e without descending into subquery plans (mirrors what
            ``S.transform`` visits, so collection and replacement agree)."""
            stack = [e]
            while stack:
                v = stack.pop()
                yield v
                if not isinstance(v, (S.ScalarSubquery, S.Exists)):
                    stack.extend(v.children())

        def resolve_keys(pat: _CorrPattern) -> _CorrPattern | None:
            """Outer refs naming columns computed earlier in this same
            Compute shadow the child's columns — substitute their (pure)
            definitions into the key expressions, to fixpoint, so the join
            key computes over ``child``.  None when a shadowed name has no
            substitutable definition."""
            out = []
            for key, e in pat.keys:
                for _ in range(8):
                    names = S.free_outer(e) & defined_before
                    if not names:
                        break
                    if not names <= set(subst):
                        return None
                    e = S.transform(
                        e,
                        lambda x: subst[x.name]
                        if isinstance(x, S.Outer) and x.name in subst
                        else None,
                    )
                else:
                    return None
                if not _is_outer_key_expr(e):
                    return None
                out.append((key, e))
            return _CorrPattern(pat.table_plan, out)

        def group_for(kind: str, pat: _CorrPattern) -> dict:
            gk = _group_key(kind, pat)
            g = groups.get(gk)
            if g is None:
                g = groups[gk] = {
                    "key": gk, "pat": pat, "kind": kind,
                    "slots": {}, "sigs": {},
                }
                order.append(gk)
            return g

        def slot_for(g: dict, sig: tuple, payload) -> str:
            """Content-deduped output slot within a shared build (two
            identical aggregates over one body yield one column)."""
            name = g["sigs"].get(sig)
            if name is None:
                name = f"a{len(g['slots'])}"
                g["sigs"][sig] = name
                g["slots"][name] = payload
            return name

        def register(x) -> None:
            if isinstance(x, S.Exists):
                pat = _match_corr_filter(x.plan)
                if pat is not None:
                    pat = resolve_keys(pat)
                if pat is None or not _outer_keys_available(pat, child, catalog):
                    return
                g = group_for("agg", pat)
                name = slot_for(g, ("count_star", None),
                                R.AggSpec("count_star", None))
                repl[id(x)] = (g["key"], ("exists", name, x.negated))
                return
            sub = x.plan
            if isinstance(sub, R.GroupAgg) and not sub.keys and sub.aggs:
                want = x.column
                if want is None and len(sub.aggs) == 1:
                    want = next(iter(sub.aggs))
                if want is None or want not in sub.aggs:
                    return
                if any(_expr_outer_refs_safe(a.expr) for a in sub.aggs.values()):
                    return
                pat = _match_corr_filter(sub.child)
                if pat is not None:
                    pat = resolve_keys(pat)
                if pat is None or not _outer_keys_available(pat, child, catalog):
                    return
                g = group_for("agg", pat)
                spec = sub.aggs[want]
                sig = (spec.fn,
                       None if spec.expr is None else _fp_norm(spec.expr))
                name = slot_for(g, sig, spec)
                repl[id(x)] = (g["key"], ("agg", name, spec.fn))
                return
            if isinstance(sub, R.Compute) and len(sub.computed) == 1:
                (pname, pexpr), = sub.computed.items()
                if (x.column or pname) != pname or _expr_outer_refs_safe(pexpr):
                    return
                pat = _match_corr_filter(sub.child)
                if pat is not None:
                    pat = resolve_keys(pat)
                if pat is None or not _outer_keys_available(pat, child, catalog):
                    return
                g = group_for("lkp", pat)
                name = slot_for(g, (_fp_norm(pexpr),), pexpr)
                repl[id(x)] = (g["key"], ("lkp", name))

        # -- phase 1: collect occurrences, grouped by shared-build identity
        for cname, e in node.computed.items():
            for v in shallow(e):
                if isinstance(v, (S.ScalarSubquery, S.Exists)) and id(v) not in repl:
                    register(v)
            pure = not any(
                isinstance(w, (S.ScalarSubquery, S.Exists, S.UdfCall,
                               S.Var, S.Outer))
                for w in shallow(e)
            )
            if pure:
                subst[cname] = S.transform(
                    e,
                    lambda x: S.Outer(x.name) if isinstance(x, S.ColRef)
                    else None,
                )
            defined_before.add(cname)

        if not repl:
            return None

        # -- phase 2: one materialized build + left join per group
        for gk in order:
            g = groups[gk]
            pat = g["pat"]
            try:
                existing = set(R.output_columns(child, catalog or {}))
            except Exception:
                existing = set()
            salt = 0
            while True:
                tag = _corr_digest(gk) if not salt else _corr_digest(gk, salt)
                named = [f"__dc{tag}_{s}" for s in g["slots"]]
                named += [f"__dgk{tag}_{j}" for j in range(len(pat.keys))]
                named += [f"__dck{tag}_{j}" for j in range(len(pat.keys))]
                if not any(c in existing for c in named):
                    break
                salt += 1
            g["tag"] = tag
            kf = [f"__dgk{tag}_{j}" for j in range(len(pat.keys))]
            proj = {kf[j]: pat.keys[j][0] for j in range(len(pat.keys))}
            if g["kind"] == "agg":
                aggs = {f"__dc{tag}_{s}": spec for s, spec in g["slots"].items()}
                build: R.RelNode = R.GroupAgg(
                    pat.table_plan, [k for k, _ in pat.keys], aggs
                )
                proj.update({c: c for c in aggs})
            else:
                projs = {f"__dc{tag}_{s}": ex for s, ex in g["slots"].items()}
                build = R.Compute(pat.table_plan, projs)
                proj.update({c: c for c in projs})
            rt = R.Project(build, proj)
            child, lks = _left_key_cols(pat, child, tag)
            child = R.Join(child, rt, list(zip(lks, kf)), "left")

        # -- phase 3: swap each occurrence for its build-output reference
        def fix(x):
            hit = repl.get(id(x))
            if hit is None:
                return None
            gk, m = hit
            tag = groups[gk]["tag"]
            if m[0] == "agg":
                _, sname, fn = m
                ref: S.Scalar = S.ColRef(f"__dc{tag}_{sname}")
                if fn in ("count", "count_star"):
                    ref = S.Coalesce([ref, S.Const(0)])
                return ref
            if m[0] == "exists":
                _, sname, negated = m
                has = S.Coalesce(
                    [S.ColRef(f"__dc{tag}_{sname}"), S.Const(0)]
                ) > S.Const(0)
                return S.BoolOp("not", [has]) if negated else has
            return S.ColRef(f"__dc{tag}_{m[1]}")

        changed[0] = True
        return R.Compute(
            child, {k: S.transform(e, fix) for k, e in node.computed.items()}
        )

    return R.transform_plan(plan, rule), changed[0]


def _expr_outer_refs_safe(e: S.Scalar | None) -> set[str]:
    if e is None:
        return set()
    return _expr_outer_refs(e)


def decorrelate_filters(plan: R.RelNode, catalog=None):
    """Filter(X, Exists(corr)) → semi-join; NOT Exists → anti-join."""
    changed = [False]

    def rule(node: R.RelNode):
        if not isinstance(node, R.Filter):
            return None
        pred = node.pred
        if isinstance(pred, S.Exists):
            pat = _match_corr_filter(pred.plan)
            if pat is None or not _outer_keys_available(pat, node.child, catalog):
                return None
            tag = _corr_digest(_group_key("semi", pat))
            kf = [f"__dgk{tag}_{j}" for j in range(len(pat.keys))]
            rt = R.Project(
                pat.table_plan,
                {kf[j]: pat.keys[j][0] for j in range(len(pat.keys))},
            )
            changed[0] = True
            kind = "anti" if pred.negated else "semi"
            child, lks = _left_key_cols(pat, node.child, tag)
            return R.Join(child, rt, list(zip(lks, kf)), kind)
        return None

    return R.transform_plan(plan, rule), changed[0]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def annotate_group_stats(plan: R.RelNode, catalog=None):
    """§Perf (Froid engine): statistics-driven group-by planning.

    For a single-int-key GroupAgg whose key column traces to a base-table
    scan through Filter/Compute (key untouched), attach the table's
    (distinct, min, max) stats: ``capacity`` bounds the segment arrays and
    a dense key range switches the executor to direct ``gid = key - lo``
    segmenting — no sort.  This is what a cost-based optimizer gets from
    histograms; UDFs used to hide it (paper §2.3 'lack of costing')."""
    if not catalog:
        return plan, False
    changed = [False]

    def source_stats(node: R.RelNode, col: str):
        while isinstance(node, (R.Filter, R.Compute, R.Project)):
            if isinstance(node, R.Compute) and col in node.computed:
                return None
            if isinstance(node, R.Project):
                if col not in node.cols:
                    return None
                col = node.cols[col]
            node = node.child
        if isinstance(node, R.Scan):
            t = catalog.get(node.table)
            if t is not None and col in getattr(t, "stats", {}):
                return t.stats[col]
        return None

    def rule(node: R.RelNode):
        if (
            not isinstance(node, R.GroupAgg)
            or len(node.keys) != 1
            or node.dense_range is not None
        ):
            return None
        st = source_stats(node.child, node.keys[0])
        if st is None:
            return None
        distinct, lo, hi = st
        span = hi - lo + 1
        if span <= 0 or span > 4 * distinct or span > 1_000_000:
            cap = node.capacity or distinct
            if node.capacity is None:
                changed[0] = True
                return R.GroupAgg(node.child, node.keys, dict(node.aggs),
                                  distinct, None)
            return None
        changed[0] = True
        return R.GroupAgg(node.child, node.keys, dict(node.aggs),
                          node.capacity or span, (lo, hi))

    return R.transform_plan(plan, rule), changed[0]


DEFAULT_RULES = (
    remove_applies,
    splice_subqueries,
    fuse_computes,
    fold_constants,
    propagate_constants,
    decorrelate_in_computes,
    decorrelate_filters,
    annotate_group_stats,
)


def _deep(rule):
    """Lift a plan rule so it also rewrites subquery plans embedded in
    scalar expressions (ScalarSubquery / Exists), recursively."""

    def run(plan: R.RelNode, catalog=None):
        changed = [False]

        def fix_expr(e: S.Scalar) -> S.Scalar:
            def f(x):
                if isinstance(x, S.ScalarSubquery):
                    p2, ch = run(x.plan, catalog)
                    if ch:
                        changed[0] = True
                        return S.ScalarSubquery(p2, x.column, x.agg_default)
                if isinstance(x, S.Exists):
                    p2, ch = run(x.plan, catalog)
                    if ch:
                        changed[0] = True
                        return S.Exists(p2, x.negated)
                return None

            return S.transform(e, f)

        def node_fn(node: R.RelNode):
            out = _rewrite_exprs(node, fix_expr)
            return out

        plan = R.transform_plan(plan, node_fn)
        plan, ch = rule(plan, catalog)
        return plan, changed[0] or ch

    return run


def deep_prune(plan: R.RelNode, catalog=None, required: set[str] | None = None):
    """prune_columns, recursing into subquery plans with their own
    required-sets (a ScalarSubquery needs only its output column; an Exists
    needs none)."""
    changed = [False]

    def fix_expr(e: S.Scalar) -> S.Scalar:
        def f(x):
            if isinstance(x, S.ScalarSubquery):
                req = {x.column} if x.column else None
                p2, ch = deep_prune(x.plan, catalog, req)
                if ch:
                    changed[0] = True
                    return S.ScalarSubquery(p2, x.column, x.agg_default)
            if isinstance(x, S.Exists):
                p2, ch = deep_prune(x.plan, catalog, set())
                if ch:
                    changed[0] = True
                    return S.Exists(p2, x.negated)
            return None

        return S.transform(e, f)

    plan = R.transform_plan(plan, lambda nd: _rewrite_exprs(nd, fix_expr))
    plan, ch = prune_columns(plan, catalog, required)
    return plan, changed[0] or ch


def optimize(
    plan: R.RelNode,
    catalog=None,
    required: set[str] | None = None,
    rules=DEFAULT_RULES,
    max_passes: int = 12,
) -> R.RelNode:
    """Run the rewrite rules to fixpoint (recursing into subquery plans),
    pruning dead columns first in every pass so dead subqueries disappear
    before decorrelation turns them into joins (§6.3)."""
    deep_rules = [_deep(r) for r in rules]

    def prune_rule(p, c):
        return deep_prune(p, c, required)

    all_rules = [prune_rule] + deep_rules
    for _ in range(max_passes):
        any_change = False
        for rule in all_rules:
            plan, ch = rule(plan, catalog)
            any_change = any_change or ch
        if not any_change:
            break
    plan, _ = deep_prune(plan, catalog, required)
    return plan


# ---------------------------------------------------------------------------
# plan pretty-printer (EXPLAIN)
# ---------------------------------------------------------------------------


def explain(plan: R.RelNode, indent: int = 0) -> str:
    pad = "  " * indent
    out = []
    n = plan
    if isinstance(n, R.Scan):
        out.append(f"{pad}Scan {n.table}")
    elif isinstance(n, R.ConstantScan):
        out.append(f"{pad}ConstantScan")
    elif isinstance(n, R.Compute):
        out.append(f"{pad}Compute {list(n.computed)}")
        for name, e in n.computed.items():
            for sub in S.walk(e):
                if isinstance(sub, (S.ScalarSubquery, S.Exists)):
                    out.append(f"{pad}  [subquery of {name}]")
                    out.append(explain(sub.plan, indent + 2))
        out.append(explain(n.child, indent + 1))
    elif isinstance(n, R.Project):
        out.append(f"{pad}Project {list(n.cols)}")
        out.append(explain(n.child, indent + 1))
    elif isinstance(n, R.Filter):
        out.append(f"{pad}Filter {n.pred!r}")
        out.append(explain(n.child, indent + 1))
    elif isinstance(n, R.Join):
        out.append(f"{pad}Join[{n.kind}] on {n.on}")
        out.append(explain(n.left, indent + 1))
        out.append(explain(n.right, indent + 1))
    elif isinstance(n, R.Apply):
        out.append(f"{pad}Apply[{n.kind}]")
        out.append(explain(n.left, indent + 1))
        out.append(explain(n.right, indent + 1))
    elif isinstance(n, R.GroupAgg):
        out.append(f"{pad}GroupAgg keys={n.keys} aggs={list(n.aggs)}")
        out.append(explain(n.child, indent + 1))
    elif isinstance(n, R.Sort):
        out.append(f"{pad}Sort {n.keys} limit={n.limit}")
        out.append(explain(n.child, indent + 1))
    elif isinstance(n, R.LoopScan):
        out.append(f"{pad}LoopScan[{n.kind}] outputs={n.outputs} "
                   f"carry={list(n.carry)} steps={len(n.steps)}")
        out.append(explain(n.child, indent + 1))
    else:
        out.append(f"{pad}{type(n).__name__}")
    return "\n".join(out)
