"""Port of ``src/repro/core/algebrizer.py:1-296``:
a copy with numpy dtype tags.  Rewritable cursor loops become a
``LoopScan`` through ``repro_torch.loops`` (reference ``:190-227``).

UDF algebrization (paper §4): imperative body -> single relational expr.

Each region becomes a single-row *derived table* (``Compute`` over
``ConstantScan``) whose schema is the region's write-set (§4.2.2); region
DTs are chained with the ``Apply`` operator (§4.3); variable def-use is
preserved by SSA column naming (``price__3``), with ``ColRef`` for
region-local uses and ``Outer`` for uses of prior regions' columns.

Early RETURNs (§4.2.1): the *probe bit* is an explicit ``__retset`` column;
*pass-through* is expressed in predicated form — every later write to
``__ret`` and every branch merge is guarded by
``CASE WHEN __retset THEN <old> ELSE <new>``.  On a tensor machine all
lanes execute and are masked (there is no divergent control flow to skip),
so the probe/pass-through pair lowers to exactly these guards; the end
result (returnVal) is identical to the paper's construction.  See
DESIGN.md §2.

Conditional regions (Table 1 row 4): the predicate is evaluated **once**
into an implicit column (``__pred__k``) and branch write-sets merge through
``CASE WHEN __pred__k THEN <then-col> ELSE <else-col>``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ir as IR
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S

_NULL_DTYPES = {
    "float32": np.float32,
    "int32": np.int32,
    "date": np.int32,
    "bool": np.bool_,
    "str": np.int32,
}

RET = "__ret"
RETSET = "__retset"


def typed_null(dtype: str) -> S.Scalar:
    return S.Const(None, _NULL_DTYPES.get(dtype, np.float32))


class AlgebrizeError(Exception):
    pass


class Algebrizer:
    """One instance per UDF algebrization (fresh-name counter is local)."""

    def __init__(self, udf: IR.UdfDef):
        self.udf = udf
        self._n = 0
        self._param_names = {p for p, _ in udf.params}

    # ------------------------------------------------------------------ util
    def fresh(self, base: str) -> str:
        self._n += 1
        return f"{base}__{self._n}"

    def resolve(self, expr: S.Scalar, env: dict[str, str], local: dict[str, str]) -> S.Scalar:
        """Rewrite Var refs into column refs.  Region-local -> ColRef,
        prior-region -> Outer.  Inside subquery plans every variable becomes
        an Outer (the subquery's outer scope is the current row)."""

        def fix(e: S.Scalar) -> S.Scalar | None:
            if isinstance(e, S.Var):
                if e.name in local:
                    return S.ColRef(local[e.name])
                if e.name in env:
                    return S.Outer(env[e.name])
                if e.name in self._param_names:  # @params share the namespace
                    return S.Param(e.name)
                raise AlgebrizeError(
                    f"{self.udf.name}: undeclared variable @{e.name}"
                )
            if isinstance(e, (S.ScalarSubquery, S.Exists)):
                plan = self._resolve_plan(e.plan, env, local)
                if isinstance(e, S.ScalarSubquery):
                    return S.ScalarSubquery(plan, e.column, e.agg_default)
                return S.Exists(plan, e.negated)
            return None

        return S.transform(expr, fix)

    def _resolve_plan(self, plan: R.RelNode, env, local) -> R.RelNode:
        """Vars inside a subquery plan resolve to Outer(column) —
        region-local and prior-region columns are both visible as the
        subquery's outer row (executor scoping rule)."""

        def fix_expr(e: S.Scalar) -> S.Scalar | None:
            if isinstance(e, S.Var):
                if e.name in local:
                    return S.Outer(local[e.name])
                if e.name in env:
                    return S.Outer(env[e.name])
                if e.name in self._param_names:
                    return S.Param(e.name)
                raise AlgebrizeError(
                    f"{self.udf.name}: undeclared variable @{e.name} in subquery"
                )
            if isinstance(e, (S.ScalarSubquery, S.Exists)):
                sub = self._resolve_plan(e.plan, env, local)
                if isinstance(e, S.ScalarSubquery):
                    return S.ScalarSubquery(sub, e.column, e.agg_default)
                return S.Exists(sub, e.negated)
            return None

        def fix_node(node: R.RelNode) -> R.RelNode | None:
            if isinstance(node, R.Filter):
                return R.Filter(node.child, S.transform(node.pred, fix_expr))
            if isinstance(node, R.Compute):
                return R.Compute(
                    node.child,
                    {k: S.transform(v, fix_expr) for k, v in node.computed.items()},
                )
            if isinstance(node, R.GroupAgg):
                aggs = {
                    k: R.AggSpec(
                        a.fn,
                        None if a.expr is None else S.transform(a.expr, fix_expr),
                    )
                    for k, a in node.aggs.items()
                }
                return R.GroupAgg(node.child, node.keys, aggs, node.capacity,
                                  node.dense_range)
            return None

        return R.transform_plan(plan, fix_node)

    # ------------------------------------------------------------- combining
    @staticmethod
    def combine(plan: R.RelNode, dt: R.RelNode) -> R.RelNode:
        """E(R0) = (E(R1) Aᵒ E(R2)) Aᵒ E(R3) — §4.3."""
        if isinstance(plan, R.ConstantScan):
            return dt
        return R.Apply(plan, dt, kind="outer")

    # ------------------------------------------------------------ region emit
    def emit_regions(self, plan, env, regions):
        for reg in regions:
            if isinstance(reg, IR.SeqRegion):
                plan, env = self.emit_seq(plan, env, reg)
            else:
                plan, env = self.emit_cond(plan, env, reg)
        return plan, env

    def emit_seq(self, plan, env, reg: IR.SeqRegion):
        computed: dict[str, S.Scalar] = {}
        local: dict[str, str] = {}
        for st in reg.statements:
            if isinstance(st, IR.Declare):
                c = self.fresh(st.name)
                computed[c] = (
                    typed_null(st.dtype)
                    if st.init is None
                    else self.resolve(st.init, env, local)
                )
                local[st.name] = c
            elif isinstance(st, IR.Assign):
                c = self.fresh(st.name)
                computed[c] = self.resolve(st.expr, env, local)
                local[st.name] = c
            elif isinstance(st, IR.Return):
                e = self.resolve(st.expr, env, local)
                prev_ret = RET in local or RET in env
                if prev_ret:
                    # probe/pass-through guard: keep the first assigned value
                    pset = self.resolve(S.Var(RETSET), env, local)
                    pval = self.resolve(S.Var(RET), env, local)
                    e = S.Case([(pset, pval)], e)
                rc = self.fresh(RET)
                rs = self.fresh(RETSET)
                computed[rc] = e
                computed[rs] = S.Const(True)
                local[RET] = rc
                local[RETSET] = rs
            elif isinstance(st, (IR.While, IR.CursorLoop)):
                self.emit_loop(st, computed, local, env)
            else:
                raise AlgebrizeError(f"unsupported statement {type(st).__name__}")
        if not computed:
            return plan, env
        dt = R.Compute(R.ConstantScan(), computed)
        env = {**env, **local}
        return self.combine(plan, dt), env

    def emit_loop(self, st, computed: dict, local: dict, env: dict):
        """Cursor-loop rewrite (Aggify / ``repro_torch.loops``): classify the
        loop, compile it to a LoopScan over the cursor's defining query, and bind
        each live-out variable to a ScalarSubquery over the shared node.
        Non-rewritable loops raise AlgebrizeError — the binder then leaves
        the UdfCall in place and execution falls back to the per-row
        interpreter (explicit verdict, not a parse error)."""
        from repro_torch.loops import classify, compile_loop

        verdict = classify(st)
        if not verdict.rewritable:
            raise AlgebrizeError(
                f"{self.udf.name}: non-rewritable loop — {verdict.reason}")

        plan = self._resolve_plan(st.plan, env, local)
        loop = IR.CursorLoop(st.cursor, plan, st.targets, st.body, st.guard)

        def fix_free(e: S.Scalar, carried: set) -> S.Scalar:
            def fx(x):
                if isinstance(x, S.Var) and x.name not in carried:
                    if x.name in local:
                        return S.Outer(local[x.name])
                    if x.name in env:
                        return S.Outer(env[x.name])
                    if x.name in self._param_names:
                        return S.Param(x.name)
                    raise AlgebrizeError(
                        f"{self.udf.name}: undeclared variable @{x.name} "
                        "in loop")
                return None

            return S.transform(e, fx)

        node = compile_loop(loop, verdict, fix_free, typed_null)
        for w in node.outputs:
            c = self.fresh(w)
            computed[c] = S.ScalarSubquery(node, w)
            local[w] = c

    def emit_cond(self, plan, env, reg: IR.CondRegion):
        # 1. evaluate the predicate ONCE into an implicit column (§4.2.1:
        #    "assigning the value of the predicate evaluation to an implicit
        #    boolean variable")
        pc = self.fresh("__pred")
        dtp = R.Compute(
            R.ConstantScan(), {pc: self.resolve(reg.pred, env, {})}
        )
        plan = self.combine(plan, dtp)
        env = {**env, pc: pc}  # make the pred column addressable

        # 2. emit both branches (columns accumulate on the same row; branch
        #    visibility is enforced by separate env maps)
        env_t = dict(env)
        plan, env_t = self.emit_regions(plan, env_t, reg.then_regions)
        env_e = dict(env)
        plan, env_e = self.emit_regions(plan, env_e, reg.else_regions)

        # 3. merge write-sets: CASE WHEN pred THEN then-col ELSE else-col
        written = {
            v
            for v in (set(env_t) | set(env_e))
            if env_t.get(v) != env.get(v) or env_e.get(v) != env.get(v)
        }
        written.discard(pc)
        merged: dict[str, S.Scalar] = {}
        local: dict[str, str] = {}
        prev_set = (
            S.Outer(env[RETSET]) if RETSET in env else None
        )
        for v in sorted(written):
            t_ref = S.Outer(env_t[v]) if v in env_t else typed_null("float32")
            e_ref = S.Outer(env_e[v]) if v in env_e else typed_null("float32")
            body = S.Case([(S.Outer(env[pc]), t_ref)], e_ref)
            if v in (RET, RETSET) and prev_set is not None:
                # pass-through: a row that already returned keeps its value
                prev = S.Outer(env[RET]) if v == RET else S.Const(True)
                body = S.Case([(prev_set, prev)], body)
            c = self.fresh(v)
            merged[c] = body
            local[v] = c
        if not merged:
            return plan, env
        dt = R.Compute(R.ConstantScan(), merged)
        env = {**env, **local}
        return self.combine(plan, dt), env

    # ---------------------------------------------------------------- driver
    def run(self) -> R.RelNode:
        regions = self.udf.regions()
        plan, env = self.emit_regions(R.ConstantScan(), {}, regions)
        ret = (
            S.Outer(env[RET]) if RET in env else typed_null(self.udf.return_dtype)
        )
        # final region: SELECT <ret> AS returnVal (Table 1 row 5)
        dt = R.Compute(R.ConstantScan(), {"returnVal": ret})
        out = self.combine(plan, dt)
        return R.Project(out, ["returnVal"])


def algebrize(udf: IR.UdfDef) -> R.RelNode:
    """Algebrize ``udf`` into a relational expression producing a single
    one-row, one-column (``returnVal``) table, parameterized by Param refs."""
    if not udf.is_deterministic():
        raise AlgebrizeError(
            f"{udf.name}: non-deterministic intrinsics — not inlined (paper §7.4)"
        )
    return Algebrizer(udf).run()
