"""Port of ``src/repro/core/interpreter.py:1-669``: iterative UDF
evaluation, the baseline Froid replaces (paper §2.2/§2.3).

Two modes, mirroring the paper's Table 5 quadrants:

* ``python`` ("interpreted T-SQL"): the UDF is evaluated **once per
  qualifying tuple**, statement by statement.  Each statement's evaluator
  is cached on first use (SQL Server's per-statement plan cache); control
  flow (IF/ELSE, early RETURN) is interpreted on the host between
  statements, which reads every predicate back from the device.  Queries
  inside the body re-execute per invocation — the O(N·M) behaviour the
  paper measures.

* ``scan`` ("natively compiled UDF", Hekaton analogue §8.2.7): the whole
  UDF body is one predicated row function (branches become predication,
  an early RETURN a ``(ret, retset)`` pair, nested calls inline), built
  once per UDF and driven over the rows **one invocation per row, in
  order**, as the reference's ``lax.scan`` drives it.  A loop-free row
  body queues on the device without a host sync; a WHILE reads its
  condition on the host each iteration, as ``lax.while_loop`` would on
  the device (under a statement's ``execute_many`` once for the whole
  batch of invocations, as ``lax.while_loop`` batches).  Rows are never
  batched: native compilation removes
  interpretation overhead but not the iterative execution model, which is
  exactly the paper's point.

Every tensor the interpreter makes lies on its catalog's device.  Where the
reference jit-compiles a statement (``jit_statements``) or the row
function, the port caches the evaluator and runs it eagerly; PyTorch needs
no trace.  One departure: a cached evaluator is keyed by the dictionaries
of the string values it reads as well, so a UDF called with another
string argument (TPC-H Q12's ``line_count(..., 'low')`` after
``line_count(..., 'high')``) does not reuse the first call's dictionary.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import algebrizer as A
from repro_torch.core import ir as IR
from repro_torch.core import scalar as S
from repro_torch.core.executor import Executor
from repro_torch.tables.table import resolve_device


class InterpreterError(Exception):
    pass


class _Break(Exception):
    """Internal control-flow sentinel for BREAK (python mode)."""


class _Flow:
    """Mutable per-iteration control state for a loop body in scan mode:
    rows with ``broken`` set have hit BREAK and skip the rest of the
    body."""

    def __init__(self, broken):
        self.broken = broken


def _vocab(value: S.Value):
    return None if value.dictionary is None else value.dictionary.key


def _catalog_device(catalog) -> torch.device:
    """The device of the catalog's columns; an empty catalog means the
    card, as every entry point does."""
    for table in catalog.values():
        for dev in table.devices():
            return dev
    return resolve_device(None)


class Interpreter:
    def __init__(self, catalog, registry, mode: str = "python",
                 jit_statements: bool = True, max_recursion: int = 32,
                 max_loop_iters: int = 10_000, device=None):
        assert mode in ("python", "scan")
        self.catalog = catalog
        self.registry = registry
        self.mode = mode
        self.jit_statements = jit_statements
        self.max_recursion = max_recursion
        self.max_loop_iters = max_loop_iters
        self.device = (_catalog_device(catalog) if device is None
                       else resolve_device(device))
        self._stmt_cache: dict[tuple, tuple] = {}
        self._scan_cache: dict[tuple, callable] = {}
        self.stats = {
            "invocations": 0,
            "statements_executed": 0,
            "bytes_scanned": 0,  # logical reads by per-invocation queries
            "rows_scanned": 0,
        }
        #: rows the hook was driven over (python mode: the qualifying
        #: rows; scan mode: every row, one row-function call each) — the
        #: port's own count, beside the reference's ``stats``, which scan
        #: mode leaves at zero
        self.rows_driven = 0
        self._flags: dict[bool, torch.Tensor] = {}
        # scan mode's literals, made once (see EvalContext.consts)
        self._consts: dict = {}

    def _flag(self, value: bool) -> torch.Tensor:
        """A 0-d bool constant on the device, made once (never written in
        place)."""
        t = self._flags.get(value)
        if t is None:
            t = self._flags[value] = torch.full((), value, dtype=torch.bool,
                                                device=self.device)
        return t

    def _null(self, dtype=np.float32) -> S.Value:
        return S.null_value(dtype, device=self.device)

    def _executor(self, evaluator=None) -> Executor:
        return Executor(self.catalog, udf_column_evaluator=evaluator,
                        device=self.device)

    # ------------------------------------------------------------------
    # hook wired into Executor.udf_column_evaluator
    # ------------------------------------------------------------------
    def eval_udf_call(self, expr: S.UdfCall, env, ctx) -> S.Value:
        udf = self.registry.get(expr.name)
        if udf is None:
            raise InterpreterError(f"unknown UDF {expr.name!r}")
        n = ctx.num_rows
        args = [S.eval_scalar(a, env, ctx).broadcast(n) for a in expr.args]
        if self.mode == "scan":
            self.rows_driven += n
            return self._eval_scan(udf, args, n)
        # the UDF is invoked once per *qualifying* tuple (paper §2.2):
        # skip masked-out rows (also required so recursion terminates)
        mask = getattr(ctx, "row_mask", None)
        host_mask = None if mask is None else mask.cpu().numpy()
        self.rows_driven += n if host_mask is None else int(host_mask.sum())
        return self._eval_python(udf, args, n, host_mask)

    # ------------------------------------------------------------------
    # 'python' mode: per-tuple, statement-at-a-time
    # ------------------------------------------------------------------
    def _row_value(self, data: np.ndarray, valid: np.ndarray, i: int,
                   dictionary) -> S.Value:
        """Row ``i`` of host columns as 0-d tensors on the device."""
        return S.Value(torch.as_tensor(data[i]).to(self.device),
                       torch.as_tensor(valid[i]).to(self.device), dictionary)

    def _eval_python(self, udf: IR.UdfDef, args: list[S.Value], n: int,
                     mask: np.ndarray | None = None) -> S.Value:
        host_args = [
            (a.data.cpu().numpy(), a.validity().cpu().numpy(), a.dictionary)
            for a in args
        ]
        outs = np.zeros((n,), np.float32)
        valids = np.zeros((n,), bool)
        for i in range(n):
            if mask is not None and not mask[i]:
                continue  # non-qualifying tuple: UDF is never invoked
            params = {
                pname: self._row_value(d, v, i, dic)
                for (pname, _), (d, v, dic) in zip(udf.params, host_args)
            }
            val = self.call_udf(udf, params)
            # nested-call results can carry a (1,)-shaped value
            arr = val.data.to(torch.float32).reshape(-1).cpu().numpy()
            outs[i] = arr[0] if arr.size else 0.0
            v = val.validity().reshape(-1).cpu().numpy()
            valids[i] = bool(v[0]) if v.size else False
        return S.Value(torch.from_numpy(outs).to(self.device),
                       torch.from_numpy(valids).to(self.device))

    def call_udf(self, udf: IR.UdfDef, params: dict[str, S.Value],
                 depth: int = 0) -> S.Value:
        """One UDF invocation: interpret the statement list."""
        if depth > self.max_recursion:
            raise InterpreterError(f"{udf.name}: recursion limit")
        self.stats["invocations"] += 1
        vars: dict[str, S.Value] = {}
        ret = self._run_block(udf, udf.body, vars, params, depth)
        if ret is None:
            return self._null()
        return ret

    def _run_block(self, udf, stmts, vars, params, depth):
        for st in stmts:
            self.stats["statements_executed"] += 1
            if isinstance(st, IR.Declare):
                if st.init is None:
                    vars[st.name] = self._null(A._NULL_DTYPES.get(st.dtype))
                else:
                    vars[st.name] = self._eval_stmt_expr(
                        udf, st, st.init, vars, params, depth
                    )
            elif isinstance(st, IR.Assign):
                vars[st.name] = self._eval_stmt_expr(
                    udf, st, st.expr, vars, params, depth
                )
            elif isinstance(st, IR.IfElse):
                p = self._eval_stmt_expr(udf, st, st.pred, vars, params, depth)
                body = st.then_body if self._truthy(p) else st.else_body
                ret = self._run_block(udf, body, vars, params, depth)
                if ret is not None:
                    return ret
            elif isinstance(st, IR.Return):
                return self._eval_stmt_expr(udf, st, st.expr, vars, params, depth)
            elif isinstance(st, IR.Break):
                raise _Break()
            elif isinstance(st, IR.While):
                ret = self._run_while(udf, st, vars, params, depth)
                if ret is not None:
                    return ret
            elif isinstance(st, IR.CursorLoop):
                ret = self._run_cursor_loop(udf, st, vars, params, depth)
                if ret is not None:
                    return ret
            elif isinstance(st, IR.Fetch):
                raise InterpreterError(
                    "FETCH outside a recognised cursor WHILE loop")
            else:
                raise InterpreterError(type(st).__name__)
        return None

    @staticmethod
    def _truthy(v: S.Value) -> bool:
        """Data and validity both true (NULL takes the ELSE branch); reads
        the device back."""
        return bool(v.data) and bool(v.validity())

    def _run_while(self, udf, st: IR.While, vars, params, depth):
        """Reference WHILE semantics: host-interpreted, per statement."""
        iters = 0
        try:
            while True:
                p = self._eval_stmt_expr(udf, st, st.pred, vars, params, depth)
                if not self._truthy(p):
                    return None
                iters += 1
                if iters > self.max_loop_iters:
                    raise InterpreterError(
                        f"{udf.name}: WHILE exceeded {self.max_loop_iters} "
                        "iterations")
                ret = self._run_block(udf, st.body, vars, params, depth)
                if ret is not None:
                    return ret
        except _Break:
            return None

    def _add_reads(self, executor: Executor) -> tuple[int, int]:
        ex_stats = executor.stats
        self.stats["bytes_scanned"] += ex_stats["bytes_scanned"]
        self.stats["rows_scanned"] += ex_stats["rows_scanned"]
        return ex_stats["bytes_scanned"], ex_stats["rows_scanned"]

    def _run_cursor_loop(self, udf, st: IR.CursorLoop, vars, params, depth):
        """Reference cursor-loop semantics (the correctness oracle): run
        the defining query once, then iterate its qualifying rows in order
        — bind fetch variables, check the guard, run the body."""
        executor = self._executor(functools.partial(self._nested_udf, depth))
        res = executor.execute(st.plan, params=params, vars=vars)
        self._add_reads(executor)
        mask = res.mask.cpu().numpy()
        cols = {
            c: (col.data.cpu().numpy(), col.validity().cpu().numpy(),
                col.dictionary)
            for c, col in res.table.columns.items()
        }
        try:
            for i in range(mask.shape[0]):
                if not mask[i]:
                    continue  # masked-out row: not a cursor row
                for v, c in st.targets:
                    d, valid, dic = cols[c]
                    vars[v] = self._row_value(d, valid, i, dic)
                if st.guard is not None:
                    g = self._eval_stmt_expr(
                        udf, st, st.guard, vars, params, depth)
                    if not self._truthy(g):
                        return None
                ret = self._run_block(udf, st.body, vars, params, depth)
                if ret is not None:
                    return ret
        except _Break:
            pass
        return None

    def _eval_stmt_expr(self, udf, st, expr, vars, params, depth) -> S.Value:
        """Evaluate one statement's expression.  With ``jit_statements`` the
        evaluator is built once per (statement, frame layout) and cached —
        the per-statement plan cache — keyed by the statement's identity."""
        executor = self._executor(functools.partial(self._nested_udf, depth))
        ctx = S.EvalContext(executor=executor, num_rows=1, params=params,
                            vars=vars, device=self.device)
        has_udf = any(isinstance(x, S.UdfCall) for x in S.walk(expr))
        if not self.jit_statements or has_udf:
            # nested UDF calls interpret on the host — not cached
            out = S.eval_scalar(expr, {}, ctx)
            self._add_reads(executor)
            return out
        var_names = sorted(vars)
        par_names = sorted(params)
        # plan-cache key: one evaluator per (statement, frame layout, and
        # the dictionaries of the frame's strings)
        key = (id(st), tuple(var_names), tuple(par_names),
               tuple(_vocab(vars[k]) for k in var_names),
               tuple(_vocab(params[k]) for k in par_names))
        cached = self._stmt_cache.get(key)
        if cached is None:
            # first invocation: run un-staged to learn the result's string
            # dictionary (host-side metadata), then cache the evaluator
            first = S.eval_scalar(expr, {}, ctx)
            stmt_bytes, stmt_rows = self._add_reads(executor)
            dicts = {k: vars[k].dictionary for k in var_names}
            pdicts = {k: params[k].dictionary for k in par_names}

            def raw(var_leaves, par_leaves):
                vv = {
                    k: S.Value(d, v, dicts[k])
                    for k, (d, v) in zip(var_names, var_leaves)
                }
                pp = {
                    k: S.Value(d, v, pdicts[k])
                    for k, (d, v) in zip(par_names, par_leaves)
                }
                c = S.EvalContext(executor=self._executor(), num_rows=1,
                                  params=pp, vars=vv, device=self.device)
                out = S.eval_scalar(expr, {}, c)
                return out.data, out.validity()

            self._stmt_cache[key] = (raw, first.dictionary, stmt_bytes, stmt_rows)
            return first
        fn, dic, stmt_bytes, stmt_rows = cached
        # each invocation logically re-reads the statement's inner tables
        self.stats["bytes_scanned"] += stmt_bytes
        self.stats["rows_scanned"] += stmt_rows
        var_leaves = [(vars[k].data, vars[k].validity()) for k in var_names]
        par_leaves = [(params[k].data, params[k].validity()) for k in par_names]
        data, valid = fn(var_leaves, par_leaves)
        return S.Value(data, valid, dic)

    def _nested_udf(self, depth, expr: S.UdfCall, env, ctx) -> S.Value:
        udf = self.registry.get(expr.name)
        if udf is None:
            raise InterpreterError(f"unknown UDF {expr.name!r}")
        n = ctx.num_rows
        args = [S.eval_scalar(a, env, ctx).broadcast(n) for a in expr.args]
        if n == 1 or all(a.data.dim() == 0 for a in args):
            params = {
                pname: a for (pname, _), a in zip(udf.params, args)
            }
            return self.call_udf(udf, params, depth + 1)
        return self._eval_python(udf, args, n)

    # ------------------------------------------------------------------
    # 'scan' mode: one predicated row function, driven row by row
    # ------------------------------------------------------------------
    def _eval_scan(self, udf: IR.UdfDef, args: list[S.Value], n: int) -> S.Value:
        dicts = [a.dictionary for a in args]
        key = (udf.name, tuple(_vocab(a) for a in args))
        fn = self._scan_cache.get(key)
        if fn is None:
            def row_fn(arg_scalars):
                params = {
                    pname: S.Value(d, v, dic)
                    for (pname, _), (d, v), dic in zip(
                        udf.params, arg_scalars, dicts
                    )
                }
                out = self.traced_call(udf, params)
                return out.data.to(torch.float32), out.validity()

            fn = self._scan_cache[key] = row_fn
        arg_arrays = [(a.data, a.validity()) for a in args]
        datas, valids = [], []
        for i in range(n):  # one invocation per row, in order
            data, valid = fn([(d[i], v[i]) for d, v in arg_arrays])
            datas.append(data.reshape(()))
            valids.append(valid.reshape(()))
        if not datas:
            return S.Value(torch.zeros((0,), dtype=torch.float32, device=self.device),
                           torch.zeros((0,), dtype=torch.bool, device=self.device))
        return S.Value(torch.stack(datas), torch.stack(valids))

    def traced_call(self, udf: IR.UdfDef, params: dict[str, S.Value],
                    depth: int = 0) -> S.Value:
        """The whole UDF body as one predicated function of one row:
        IF/ELSE evaluates both branches and merges them by the predicate,
        and early RETURNs thread a (ret, retset) pair — the value-level
        equivalent of the algebrizer's probe/pass-through columns."""
        if depth > self.max_recursion:
            raise InterpreterError(f"{udf.name}: recursion limit")

        executor = self._executor(functools.partial(self._traced_nested, depth))
        true, false = self._flag(True), self._flag(False)

        def ev(expr, vars):
            ctx = S.EvalContext(executor=executor, num_rows=1, params=params,
                                vars=vars, device=self.device,
                                consts=self._consts)
            return S.eval_scalar(expr, {}, ctx)

        def guard_of(live, flow):
            """The combined write-guard at this point: the enclosing branch
            predicate ANDed with not-yet-BROKEN.  None means unguarded (the
            straight-line top-level path)."""
            g = live
            if flow is not None:
                nb = ~flow.broken
                g = nb if g is None else g & nb
            return g

        def write(vars, name, v, g):
            if g is None:
                vars[name] = v
            else:
                old = vars.get(name) or self._null(v.data.dtype)
                vars[name] = _merge(g, v, old)

        def run(stmts, vars, ret, retset, live=None, flow=None):
            for st in stmts:
                g = guard_of(live, flow)
                if isinstance(st, IR.Declare):
                    v = (
                        self._null(A._NULL_DTYPES.get(st.dtype))
                        if st.init is None
                        else ev(st.init, vars)
                    )
                    write(vars, st.name, v, g)
                elif isinstance(st, IR.Assign):
                    write(vars, st.name, ev(st.expr, vars), g)
                elif isinstance(st, IR.Return):
                    v = ev(st.expr, vars)
                    if ret is None:
                        ret, retset = v, (true if g is None else g.reshape(()))
                    else:
                        take = (~retset if g is None
                                else g.reshape(()) & ~retset)
                        ret = S.Value(
                            torch.where(take, v.data.to(ret.data.dtype),
                                        ret.data),
                            _where_valid(take, v, ret),
                            ret.dictionary or v.dictionary,
                        )
                        retset = retset | take
                elif isinstance(st, IR.IfElse):
                    p = ev(st.pred, vars)
                    taken = p.data.to(torch.bool) & p.validity()
                    tlive = None if g is None else g & taken
                    elive = None if g is None else g & ~taken
                    tvars = dict(vars)
                    tret, tretset = run(st.then_body, tvars, ret, retset,
                                        tlive, flow)
                    evars = dict(vars)
                    eret, eretset = run(st.else_body, evars, ret, retset,
                                        elive, flow)
                    for k in sorted(set(tvars) | set(evars)):
                        tv = tvars.get(k, vars.get(k))
                        evv = evars.get(k, vars.get(k))
                        if tv is not None and tv is evv:
                            # written in neither branch: the merge is the
                            # value itself, as a compiler folds it
                            vars[k] = tv
                            continue
                        if tv is None:
                            tv = self._null()
                        if evv is None:
                            evv = self._null()
                        vars[k] = _merge(taken, tv, evv)
                    ret, retset = _merge_ret(taken, tret, tretset, eret,
                                             eretset, self._null, false)
                elif isinstance(st, IR.Break):
                    if flow is None:
                        raise InterpreterError("BREAK outside a loop")
                    b = true if g is None else g
                    flow.broken = flow.broken | b.reshape(())
                elif isinstance(st, IR.While):
                    ret, retset = traced_while(st, vars, ret, retset, g)
                elif isinstance(st, IR.CursorLoop):
                    ret, retset = traced_cursor(st, vars, ret, retset, g)
                elif isinstance(st, IR.Fetch):
                    raise InterpreterError(
                        "FETCH outside a recognised cursor WHILE loop")
            return ret, retset

        def seed_frame(st, vars, ret, retset, extra_nulls=()):
            """Close the loop's carry structure: every name the body may
            write must exist in the frame before the loop starts."""
            for name, dtype in _loop_declares(st.body):
                if name not in vars:
                    vars[name] = self._null(A._NULL_DTYPES.get(dtype))
            for name in _loop_assigned([st]):
                if name not in vars:
                    vars[name] = (params[name] if name in params
                                  else self._null())
            for name, dtype in extra_nulls:
                if name not in vars:
                    vars[name] = self._null(dtype)
            has_ret = _has_return(st.body)
            if has_ret and ret is None:
                ret = self._null()
                retset = false
            return ret, retset, has_ret

        def carry(vars, names, dtypes):
            return tuple((_sc(vars[k].data).to(dtypes[k]), _sc(vars[k].validity()))
                         for k in names)

        def ret_leaf(r, rleaf):
            return ((_sc(r.data).to(rleaf[0].dtype), _sc(r.validity()))
                    if r is not None else rleaf)

        def frame(vars, ret, live):
            names = sorted(vars)
            dtypes = {k: vars[k].data.dtype for k in names}
            dicts = {k: vars[k].dictionary for k in names}
            rdict = ret.dictionary if ret is not None else None
            base_live = true if live is None else _sc(live)

            def unpack(leaves):
                return {k: S.Value(d, v, dicts[k])
                        for k, (d, v) in zip(names, leaves)}

            leaves = tuple((_sc(vars[k].data), _sc(vars[k].validity()))
                           for k in names)
            rleaf = ((_sc(ret.data), _sc(ret.validity())) if ret is not None
                     else (torch.zeros((), dtype=torch.float32,
                                       device=self.device), false))
            return names, dtypes, rdict, base_live, unpack, leaves, rleaf

        def traced_while(st: IR.While, vars, ret, retset, live):
            """``lax.while_loop``'s port: the condition (with
            ``it < max_loop_iters``; past it the loop stops silently) is
            read on the host each iteration.  Under ``torch.func.vmap`` (a
            statement's ``execute_many``) the condition is batched, and the
            loop takes ``lax.while_loop``'s batching rule: it runs while any
            item's condition holds (one host read for the whole batch), and
            the body's writes are predicated on each item's own condition,
            which stays false once it is (BREAK and RETURN are sticky)."""
            ret, retset, has_ret = seed_frame(st, vars, ret, retset)
            names, dtypes, rdict, base_live, unpack, leaves, rleaf = frame(
                vars, ret, live)
            rs, brk = _sc(retset), false
            it = 0
            while True:
                p = ev(st.pred, unpack(leaves))
                ok = (_sc(p.data).to(torch.bool) & _sc(p.validity())
                      & base_live & ~brk)
                if has_ret:
                    ok = ok & ~rs
                batched = torch._C._functorch.is_batchedtensor(ok)
                go = _any_item(ok) if batched else bool(ok)
                if not (it < self.max_loop_iters and go):
                    break
                vv = unpack(leaves)
                r = (S.Value(rleaf[0], rleaf[1], rdict)
                     if ret is not None else None)
                flow = _Flow(false)
                r2, rs2 = run(st.body, vv, r, rs, live=ok if batched else None,
                              flow=flow)
                leaves = carry(vv, names, dtypes)
                rleaf = ret_leaf(r2, rleaf)
                rs = _sc(rs2)
                brk = _sc(brk | flow.broken) if batched else _sc(flow.broken)
                it += 1
            for k, v in unpack(leaves).items():
                vars[k] = v
            if ret is not None:
                ret = S.Value(rleaf[0], rleaf[1], rdict)
            return ret, rs

        def traced_cursor(st: IR.CursorLoop, vars, ret, retset, live):
            """``lax.scan`` over the cursor query's rows, in order, each
            one predicated by its mask bit, the guard and BREAK."""
            res = executor.execute(st.plan, params=params, vars=vars)
            cols = res.table.columns
            extra = [(v, cols[c].data.dtype) for v, c in st.targets]
            ret, retset, has_ret = seed_frame(st, vars, ret, retset, extra)
            names, dtypes, rdict, base_live, unpack, leaves, rleaf = frame(
                vars, ret, live)
            cdicts = {c: col.dictionary for c, col in cols.items()}
            xs = {c: (col.data, col.validity()) for c, col in cols.items()}
            done, rs = false, _sc(retset)
            for i in range(res.num_rows):
                vv = unpack(leaves)
                live_row = res.mask[i] & ~done & base_live
                if has_ret:
                    live_row = live_row & ~rs
                for v, c in st.targets:
                    new = S.Value(xs[c][0][i], xs[c][1][i], cdicts[c])
                    vv[v] = _merge(live_row, new, vv[v])
                done2 = done
                if st.guard is not None:
                    gv = ev(st.guard, vv)
                    gok = _sc(gv.data).to(torch.bool) & _sc(gv.validity())
                    done2 = done2 | (live_row & ~gok)
                    live_row = live_row & gok
                flow = _Flow(false)
                r = (S.Value(rleaf[0], rleaf[1], rdict)
                     if ret is not None else None)
                r2, rs2 = run(st.body, vv, r, rs, live=live_row, flow=flow)
                done2 = done2 | flow.broken
                leaves = carry(vv, names, dtypes)
                done, rleaf, rs = _sc(done2), ret_leaf(r2, rleaf), _sc(rs2)
            for k, v in unpack(leaves).items():
                vars[k] = v
            if ret is not None:
                ret = S.Value(rleaf[0], rleaf[1], rdict)
            return ret, rs

        vars: dict[str, S.Value] = {}
        ret, retset = run(udf.body, vars, None, false)
        if ret is None:
            return self._null()
        return S.Value(ret.data, ret.validity() & retset, ret.dictionary)

    def _traced_nested(self, depth, expr: S.UdfCall, env, ctx) -> S.Value:
        udf = self.registry.get(expr.name)
        if udf is None:
            raise InterpreterError(f"unknown UDF {expr.name!r}")
        args = [S.eval_scalar(a, env, ctx) for a in expr.args]
        params = {pname: a for (pname, _), a in zip(udf.params, args)}
        return self.traced_call(udf, params, depth + 1)


def _sc(x: torch.Tensor) -> torch.Tensor:
    """Rank 0 (a loop carry is one row's scalar)."""
    return x.reshape(())


def _any_item(x: torch.Tensor) -> bool:
    """Whether any item of a bool tensor batched under ``torch.func.vmap``
    is true, read on the host from its physical tensor (every vmap level
    unwrapped)."""
    while torch._C._functorch.is_batchedtensor(x):
        x = torch._C._functorch.get_unwrapped(x)
    return bool(x.any())


def _loop_declares(stmts):
    """(name, dtype) of every Declare reachable in ``stmts``."""
    for st in stmts:
        if isinstance(st, IR.Declare):
            yield st.name, st.dtype
        elif isinstance(st, IR.IfElse):
            yield from _loop_declares(st.then_body)
            yield from _loop_declares(st.else_body)
        elif isinstance(st, (IR.While, IR.CursorLoop)):
            yield from _loop_declares(st.body)


def _loop_assigned(stmts):
    """Every variable name written (Assign or FETCH target) in ``stmts``."""
    for st in stmts:
        if isinstance(st, IR.Assign):
            yield st.name
        elif isinstance(st, IR.IfElse):
            yield from _loop_assigned(st.then_body)
            yield from _loop_assigned(st.else_body)
        elif isinstance(st, (IR.While, IR.CursorLoop)):
            if isinstance(st, IR.CursorLoop):
                for v, _ in st.targets:
                    yield v
            yield from _loop_assigned(st.body)
        elif isinstance(st, IR.Fetch):
            for v, _ in st.targets:
                yield v


def _has_return(stmts) -> bool:
    for st in stmts:
        if isinstance(st, IR.Return):
            return True
        if isinstance(st, IR.IfElse):
            if _has_return(st.then_body) or _has_return(st.else_body):
                return True
        elif isinstance(st, (IR.While, IR.CursorLoop)):
            if _has_return(st.body):
                return True
    return False


def _where_valid(pred, tv: S.Value, ev: S.Value):
    """``where(pred, tv.validity(), ev.validity())``, left None (all
    valid) where both sides are."""
    if tv.valid is None and ev.valid is None:
        return None
    return torch.where(pred, tv.validity(), ev.validity())


def _merge(pred, tv: S.Value, ev: S.Value) -> S.Value:
    td, ed = tv.data, ev.data
    if td.dtype != ed.dtype:
        common = torch.promote_types(td.dtype, ed.dtype)
        td, ed = td.to(common), ed.to(common)
    return S.Value(
        torch.where(pred, td, ed),
        _where_valid(pred, tv, ev),
        tv.dictionary or ev.dictionary,
    )


def _merge_ret(pred, tret, tretset, eret, eretset, null, false):
    if tret is None and eret is None:
        return None, false
    if tret is eret and tretset is eretset:
        return tret, tretset
    if tret is None:
        tret, tretset = null(eret.data.dtype), false
    if eret is None:
        eret, eretset = null(tret.data.dtype), false
    ret = _merge(pred, tret, eret)
    retset = torch.where(pred, tretset, eretset)
    return ret, retset
