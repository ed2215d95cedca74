"""Port of ``src/repro/core/scalar.py:1-738``: scalar expression IR with
SQL NULL semantics, vectorized over columns.

The IR classes and traversal helpers (reference ``:74-467``) are a copy.
:class:`Value`, :class:`EvalContext` and :func:`eval_scalar` (reference
``:30-66`` and ``:469-738``) are written on torch: every expression
evaluates to a whole column on the session's device, once per column, not
once per row.  Three-valued (Kleene) logic for AND/OR/NOT; WHERE treats
NULL as false, exactly as in SQL.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.tables.table import (
    DictEncoding,
    date_add,
    date_part,
)

#: 64-bit tags map to 32 bits, as ``jnp`` canonicalizes them with 64-bit
#: types off (the reference's setting)
_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a plan-layer dtype tag (a numpy dtype, scalar
    type or name; a torch dtype passes through) — the one place the
    evaluator maps numpy tags to torch."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


# ---------------------------------------------------------------------------
# Runtime value
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Value:
    """A vectorized scalar value: data + validity (+ dictionary for strings).

    ``data`` has shape ``()`` (a not-yet-broadcast constant) or ``(n,)``.
    ``valid`` is None (all valid), or a bool tensor broadcastable to data.
    """

    data: torch.Tensor
    valid: torch.Tensor | None = None
    dictionary: DictEncoding | None = None

    def validity(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.data.shape, dtype=torch.bool,
                              device=self.data.device)
        return torch.broadcast_to(self.valid, self.data.shape)

    def broadcast(self, n: int) -> "Value":
        shape = (n,) if self.data.dim() == 0 else tuple(self.data.shape)
        data = torch.broadcast_to(self.data, shape)
        valid = None
        if self.valid is not None:
            valid = torch.broadcast_to(self.valid, data.shape)
        return Value(data, valid, self.dictionary)


def null_value(dtype=np.float32, device="cpu") -> Value:
    return Value(torch.zeros((), dtype=torch_dtype(dtype), device=device),
                 torch.zeros((), dtype=torch.bool, device=device))


def _and_valid(*vals: Value) -> torch.Tensor | None:
    masks = [v.valid for v in vals if v.valid is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


class Scalar:
    """Base class.  Operator overloads build the IR fluently."""

    def __add__(self, o):
        return BinOp("+", self, wrap(o))

    def __radd__(self, o):
        return BinOp("+", wrap(o), self)

    def __sub__(self, o):
        return BinOp("-", self, wrap(o))

    def __rsub__(self, o):
        return BinOp("-", wrap(o), self)

    def __mul__(self, o):
        return BinOp("*", self, wrap(o))

    def __rmul__(self, o):
        return BinOp("*", wrap(o), self)

    def __truediv__(self, o):
        return BinOp("/", self, wrap(o))

    def __rtruediv__(self, o):
        return BinOp("/", wrap(o), self)

    def __floordiv__(self, o):
        return BinOp("//", self, wrap(o))

    def __mod__(self, o):
        return BinOp("%", self, wrap(o))

    def __neg__(self):
        return BinOp("-", Const(0), self)

    def __eq__(self, o):  # type: ignore[override]
        return Cmp("==", self, wrap(o))

    def __ne__(self, o):  # type: ignore[override]
        return Cmp("!=", self, wrap(o))

    def __lt__(self, o):
        return Cmp("<", self, wrap(o))

    def __le__(self, o):
        return Cmp("<=", self, wrap(o))

    def __gt__(self, o):
        return Cmp(">", self, wrap(o))

    def __ge__(self, o):
        return Cmp(">=", self, wrap(o))

    def __and__(self, o):
        return BoolOp("and", [self, wrap(o)])

    def __or__(self, o):
        return BoolOp("or", [self, wrap(o)])

    def __invert__(self):
        return BoolOp("not", [self])

    def __hash__(self):  # nodes are identity-hashed (needed since __eq__ builds IR)
        return id(self)

    def is_null(self):
        return IsNull(self)

    def children(self) -> list["Scalar"]:
        return []

    def with_children(self, kids: list["Scalar"]) -> "Scalar":
        assert not kids
        return self


def wrap(x) -> Scalar:
    if isinstance(x, Scalar):
        return x
    return Const(x)


class Const(Scalar):
    def __init__(self, value: Any, dtype=None):
        self.value = value
        self.dtype = dtype

    def __repr__(self):
        return f"Const({self.value!r})"


class ColRef(Scalar):
    """Reference to a column of the current row environment."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Col({self.name})"


class Outer(Scalar):
    """Correlated reference: a column of the *outer* row inside an Apply /
    correlated subquery (the paper's correlating parameter)."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Outer({self.name})"


class Param(Scalar):
    """UDF formal parameter; replaced by actual argument at substitution."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Param({self.name})"


class Var(Scalar):
    """UDF local variable reference (imperative scope).  The algebrizer
    rewrites these into ColRef/Outer column references; the iterative
    interpreter binds them from its variable environment."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"Var({self.name})"


class BinOp(Scalar):
    def __init__(self, op: str, l: Scalar, r: Scalar):
        self.op, self.l, self.r = op, l, r

    def children(self):
        return [self.l, self.r]

    def with_children(self, kids):
        return BinOp(self.op, *kids)

    def __repr__(self):
        return f"({self.l!r} {self.op} {self.r!r})"


class Cmp(Scalar):
    def __init__(self, op: str, l: Scalar, r: Scalar):
        self.op, self.l, self.r = op, l, r

    def children(self):
        return [self.l, self.r]

    def with_children(self, kids):
        return Cmp(self.op, *kids)

    def __repr__(self):
        return f"({self.l!r} {self.op} {self.r!r})"


class BoolOp(Scalar):
    def __init__(self, op: str, args: Sequence[Scalar]):
        self.op = op
        self.args = list(args)

    def children(self):
        return list(self.args)

    def with_children(self, kids):
        return BoolOp(self.op, kids)

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.args))})"


class Case(Scalar):
    """CASE WHEN p1 THEN v1 [WHEN p2 THEN v2 ...] ELSE e END."""

    def __init__(self, whens: Sequence[tuple[Scalar, Scalar]], else_: Scalar):
        self.whens = [(wrap(p), wrap(v)) for p, v in whens]
        self.else_ = wrap(else_)

    def children(self):
        out = []
        for p, v in self.whens:
            out += [p, v]
        out.append(self.else_)
        return out

    def with_children(self, kids):
        n = len(self.whens)
        whens = [(kids[2 * i], kids[2 * i + 1]) for i in range(n)]
        return Case(whens, kids[-1])

    def __repr__(self):
        w = "; ".join(f"{p!r}->{v!r}" for p, v in self.whens)
        return f"Case({w}; else {self.else_!r})"


class Cast(Scalar):
    def __init__(self, expr: Scalar, dtype):
        self.expr, self.dtype = wrap(expr), dtype

    def children(self):
        return [self.expr]

    def with_children(self, kids):
        return Cast(kids[0], self.dtype)

    def __repr__(self):
        name = getattr(self.dtype, "__name__", None) or getattr(
            self.dtype, "name", str(self.dtype))
        return f"Cast({self.expr!r} as {name})"


class Func(Scalar):
    """Intrinsic function call (deterministic unless listed otherwise)."""

    NON_DETERMINISTIC = {"rand", "getdate", "newid"}

    def __init__(self, name: str, args: Sequence[Scalar]):
        self.name = name.lower()
        self.args = [wrap(a) for a in args]

    def children(self):
        return list(self.args)

    def with_children(self, kids):
        return Func(self.name, kids)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


class IsNull(Scalar):
    def __init__(self, expr: Scalar):
        self.expr = wrap(expr)

    def children(self):
        return [self.expr]

    def with_children(self, kids):
        return IsNull(kids[0])


class Coalesce(Scalar):
    def __init__(self, args: Sequence[Scalar]):
        self.args = [wrap(a) for a in args]

    def children(self):
        return list(self.args)

    def with_children(self, kids):
        return Coalesce(kids)


class Like(Scalar):
    def __init__(self, expr: Scalar, pattern: str):
        self.expr, self.pattern = wrap(expr), pattern

    def children(self):
        return [self.expr]

    def with_children(self, kids):
        return Like(kids[0], self.pattern)


class InList(Scalar):
    def __init__(self, expr: Scalar, options: Sequence[Any]):
        self.expr = wrap(expr)
        self.options = list(options)

    def children(self):
        return [self.expr]

    def with_children(self, kids):
        return InList(kids[0], self.options)


class Between(Scalar):
    def __init__(self, expr: Scalar, lo, hi):
        self.expr, self.lo, self.hi = wrap(expr), wrap(lo), wrap(hi)

    def children(self):
        return [self.expr, self.lo, self.hi]

    def with_children(self, kids):
        return Between(*kids)


class ScalarSubquery(Scalar):
    """A relational plan producing a single column; evaluated to one scalar
    per outer row (correlated via Outer refs) or once (uncorrelated)."""

    def __init__(self, plan, column: str | None = None, agg_default=None):
        self.plan = plan
        self.column = column  # None: the plan's single output column
        # value when the subquery yields zero rows (SQL: NULL)
        self.agg_default = agg_default

    def children(self):
        return []

    def with_children(self, kids):
        return self

    def __repr__(self):
        return f"ScalarSubquery({self.plan!r})"


class Exists(Scalar):
    def __init__(self, plan, negated: bool = False):
        self.plan = plan
        self.negated = negated

    def children(self):
        return []

    def with_children(self, kids):
        return self

    def __repr__(self):
        return f"{'Not' if self.negated else ''}Exists({self.plan!r})"


class UdfCall(Scalar):
    """Call of a registered scalar UDF.  The binder (froid ON) replaces this
    with the algebrized body; the iterative interpreter (froid OFF)
    evaluates it row by row."""

    def __init__(self, name: str, args: Sequence[Scalar]):
        self.name = name
        self.args = [wrap(a) for a in args]

    def children(self):
        return list(self.args)

    def with_children(self, kids):
        return UdfCall(self.name, kids)

    def __repr__(self):
        return f"UdfCall({self.name}, {self.args!r})"


# ---------------------------------------------------------------------------
# Traversal helpers
# ---------------------------------------------------------------------------


def walk(expr: Scalar):
    yield expr
    for c in expr.children():
        yield from walk(c)
    if isinstance(expr, (ScalarSubquery, Exists)):
        # walk into subquery scalar expressions too
        from repro_torch.core import relalg

        for node in relalg.walk_plan(expr.plan):
            for e in relalg.node_exprs(node):
                yield from walk(e)


def transform(expr: Scalar, fn: Callable[[Scalar], Scalar | None]) -> Scalar:
    """Bottom-up rewrite: fn returns replacement or None to keep.

    NB: comparison must be by identity — ``Scalar.__eq__`` builds IR."""
    old = expr.children()
    kids = [transform(c, fn) for c in old]
    if any(a is not b for a, b in zip(kids, old)):
        expr = expr.with_children(kids)
    out = fn(expr)
    return expr if out is None else out


def free_cols(expr: Scalar) -> set[str]:
    return {e.name for e in walk(expr) if isinstance(e, ColRef)}


def free_outer(expr: Scalar) -> set[str]:
    return {e.name for e in walk(expr) if isinstance(e, Outer)}


def contains_subquery(expr: Scalar) -> bool:
    return any(isinstance(e, (ScalarSubquery, Exists)) for e in walk(expr))


def is_deterministic(expr: Scalar) -> bool:
    return not any(
        isinstance(e, Func) and e.name in Func.NON_DETERMINISTIC for e in walk(expr)
    )
# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

_ARITH = {
    "+": torch.add,
    "-": torch.sub,
    "*": torch.mul,
}

_CMPS = {
    "==": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def host_tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` (a Python scalar, list or numpy array) as a ``dtype``
    tensor on ``device``, queued without waiting for the copy, so that no
    path syncs the host for a constant.  A pageable host buffer is staged
    by the CUDA driver before a non-blocking copy returns, so the host
    value may go right away."""
    return torch.as_tensor(value, dtype=dtype).to(device, non_blocking=True)


def _take_clipped(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, mode="clip")``: torch raises on an
    out-of-range index where the reference clamps it."""
    return table[idx.clamp(0, max(int(table.shape[0]) - 1, 0))]


def _encode_const_for(dictionary: DictEncoding | None, value, device):
    if dictionary is not None and isinstance(value, str):
        return host_tensor(dictionary.lookup(value), torch.int32, device)
    return None


def _const_tensor(value, device) -> torch.Tensor:
    """A 0-d tensor for a Python literal at the reference's dtype
    (``jnp.asarray`` with 64-bit types off): bool, int32 or float32.
    A bare ``torch.tensor(5)`` would be int64 and widen every column it
    touches."""
    if isinstance(value, (bool, np.bool_)):
        return host_tensor(bool(value), torch.bool, device)
    if isinstance(value, (int, np.integer)):
        return host_tensor(int(value), torch.int32, device)
    return host_tensor(float(value), torch.float32, device)


def _harmonize(values: list[Value]) -> list[Value]:
    """Give string Values a shared dictionary (union + remap)."""
    dicts = [v.dictionary for v in values if v.dictionary is not None]
    if not dicts:
        return values
    union = DictEncoding()
    for d in dicts:
        for i in range(len(d)):
            union.code(d.decode(i))
    out = []
    for v in values:
        if v.dictionary is None or v.dictionary is union:
            out.append(Value(v.data, v.valid, union))
            continue
        remap = host_tensor(
            [union.code(v.dictionary.decode(i)) for i in range(len(v.dictionary))],
            torch.int32, v.data.device,
        )
        out.append(Value(_take_clipped(remap, v.data), v.valid, union))
    return out


class EvalContext:
    """Everything scalar evaluation needs from the engine.  ``device`` is
    where constants and intermediate columns are made; the default is the
    CPU (plan-time constant folding).  ``consts``, where given, keeps each
    literal's Value across evaluations (``id`` of the :class:`Const` ->
    (the node, its Value)): the interpreter's ``scan`` mode makes a row
    function's literals once, as a compiled function holds them."""

    def __init__(
        self, executor=None, num_rows: int = 1, params=None, outer=None,
        vars=None, device=None, consts: dict | None = None,
    ):
        self.executor = executor  # repro_torch.core.executor.Executor
        self.num_rows = num_rows
        self.params = params or {}  # name -> Value (scalar)
        self.outer = outer or {}  # name -> Value (for correlated refs)
        self.vars = vars or {}  # name -> Value (interpreter variable frame)
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.consts = consts


def _const_value(e: "Const", dev) -> Value:
    if e.value is None:
        return null_value(device=dev)
    if isinstance(e.value, str):
        enc = DictEncoding([e.value])
        return Value(host_tensor(0, torch.int32, dev), None, enc)
    if isinstance(e.value, bool):
        return Value(host_tensor(e.value, torch.bool, dev))
    if isinstance(e.value, int):
        return Value(host_tensor(e.value, torch.int32, dev))
    return Value(host_tensor(np.asarray(e.value),
                             torch_dtype(e.dtype or np.float32), dev))


def eval_scalar(expr: Scalar, env: dict[str, Value], ctx: EvalContext) -> Value:
    """Vectorized evaluation of ``expr`` over the row environment ``env``."""
    memo: dict[int, Value] = {}
    dev = ctx.device

    def ev(e: Scalar) -> Value:
        key = id(e)
        if key in memo:
            return memo[key]
        out = _eval(e)
        memo[key] = out
        return out

    def _eval(e: Scalar) -> Value:
        if isinstance(e, Const):
            if ctx.consts is None:
                return _const_value(e, dev)
            hit = ctx.consts.get(id(e))
            if hit is None or hit[0] is not e:
                hit = ctx.consts[id(e)] = (e, _const_value(e, dev))
            return hit[1]
        if isinstance(e, ColRef):
            if e.name not in env:
                raise KeyError(f"unbound column {e.name!r}; have {sorted(env)}")
            return env[e.name]
        if isinstance(e, Outer):
            if e.name not in ctx.outer:
                raise KeyError(f"unbound outer ref {e.name!r}")
            return ctx.outer[e.name]
        if isinstance(e, Param):
            if e.name not in ctx.params:
                raise KeyError(f"unbound parameter {e.name!r}")
            return ctx.params[e.name]
        if isinstance(e, Var):
            if e.name in ctx.vars:
                return ctx.vars[e.name]
            if e.name in ctx.params:  # T-SQL: @params share the namespace
                return ctx.params[e.name]
            raise KeyError(f"unbound variable {e.name!r}")
        if isinstance(e, BinOp):
            l, r = ev(e.l), ev(e.r)
            if e.op == "+" and (l.dictionary is not None or r.dictionary is not None):
                raise NotImplementedError(
                    "dynamic string concatenation is not supported on device; "
                    "return components separately"
                )
            if e.op == "/":
                # SQL: x / 0 yields NULL (divide-by-zero folds into validity)
                ld = l.data.to(torch.float32)
                rd = r.data.to(torch.float32)
                zero = rd == 0
                data = ld / torch.where(zero, 1.0, rd)
                zero = torch.broadcast_to(zero, data.shape)
                valid = _and_valid(l, r)
                base = (
                    torch.ones(data.shape, dtype=torch.bool, device=dev)
                    if valid is None
                    else torch.broadcast_to(valid, data.shape)
                )
                return Value(data, base & ~zero)
            if e.op in ("//", "%"):
                # the reference's guard (``:594``): an integer divisor of 0
                # divides by 1, so x // 0 == x and x % 0 == 0 as in jnp
                rd = torch.where(r.data == 0, 1, r.data)
                if e.op == "//":
                    return Value(l.data // rd, _and_valid(l, r))
                if l.data.is_floating_point() or r.data.is_floating_point():
                    rd = r.data  # float x % 0 is NaN, as jnp.mod gives
                return Value(torch.remainder(l.data, rd), _and_valid(l, r))
            fn = _ARITH[e.op]
            return Value(fn(l.data, r.data), _and_valid(l, r))
        if isinstance(e, Cmp):
            l, r = _harmonize([ev(e.l), ev(e.r)])
            return Value(_CMPS[e.op](l.data, r.data), _and_valid(l, r))
        if isinstance(e, BoolOp):
            vals = [ev(a) for a in e.args]
            if e.op == "not":
                (v,) = vals
                return Value(~v.data.to(torch.bool), v.valid)
            datas = [v.data.to(torch.bool) for v in vals]
            valids = [v.validity() for v in vals]
            all_known = valids[0]
            for m in valids[1:]:
                all_known = all_known & m
            if e.op == "and":
                known_false = valids[0] & ~datas[0]
                res = datas[0]
                for d, m in zip(datas[1:], valids[1:]):
                    known_false = known_false | (m & ~d)
                    res = res & d
                return Value(res & ~known_false, all_known | known_false)
            if e.op == "or":
                known_true = valids[0] & datas[0]
                res = datas[0]
                for d, m in zip(datas[1:], valids[1:]):
                    known_true = known_true | (m & d)
                    res = res | d
                return Value(res | known_true, all_known | known_true)
            raise ValueError(e.op)
        if isinstance(e, Case):
            vals = [ev(v) for _, v in e.whens] + [ev(e.else_)]
            vals = _harmonize(vals)
            preds = [ev(p) for p, _ in e.whens]
            out = vals[-1]
            # fold right-to-left so earlier WHENs win
            for p, v in zip(reversed(preds), reversed(vals[:-1])):
                hit = p.data.to(torch.bool) & p.validity()  # NULL pred == false
                data = torch.where(hit, v.data, out.data)
                valid = torch.where(hit, v.validity(), out.validity())
                out = Value(data, valid, vals[-1].dictionary)
            return out
        if isinstance(e, Cast):
            v = ev(e.expr)
            return Value(v.data.to(torch_dtype(e.dtype)), v.valid, None)
        if isinstance(e, IsNull):
            v = ev(e.expr)
            return Value(~v.validity(), None)
        if isinstance(e, Coalesce):
            vals = _harmonize([ev(a) for a in e.args])
            out = vals[-1]
            for v in reversed(vals[:-1]):
                ok = v.validity()
                out = Value(
                    torch.where(ok, v.data, out.data),
                    ok | out.validity(),
                    vals[-1].dictionary,
                )
            return out
        if isinstance(e, Like):
            v = ev(e.expr)
            if v.dictionary is None:
                raise TypeError("LIKE requires a string (dictionary) column")
            mask = host_tensor(v.dictionary.like_mask(e.pattern), torch.bool,
                               v.data.device)
            return Value(_take_clipped(mask, v.data), v.valid)
        if isinstance(e, InList):
            v = ev(e.expr)
            acc = None
            for opt in e.options:
                enc = _encode_const_for(v.dictionary, opt, v.data.device)
                c = enc if enc is not None else _const_tensor(opt, v.data.device)
                hit = v.data == c
                acc = hit if acc is None else (acc | hit)
            return Value(acc, v.valid)
        if isinstance(e, Between):
            v, lo, hi = ev(e.expr), ev(e.lo), ev(e.hi)
            return Value(
                (v.data >= lo.data) & (v.data <= hi.data), _and_valid(v, lo, hi)
            )
        if isinstance(e, Func):
            return _eval_func(e)
        if isinstance(e, ScalarSubquery):
            if ctx.executor is None:
                raise RuntimeError("subquery evaluation requires an executor")
            return ctx.executor.eval_scalar_subquery(e, env, ctx)
        if isinstance(e, Exists):
            if ctx.executor is None:
                raise RuntimeError("subquery evaluation requires an executor")
            return ctx.executor.eval_exists(e, env, ctx)
        if isinstance(e, UdfCall):
            if ctx.executor is None:
                raise RuntimeError(
                    f"UDF {e.name!r} reached the vectorized executor without "
                    "being inlined; run the binder (froid)"
                )
            return ctx.executor.eval_udf_call(e, env, ctx)
        raise TypeError(f"unknown scalar node {type(e).__name__}")

    def _eval_func(e: Func) -> Value:
        args = [ev(a) for a in e.args]
        n = e.name
        x = args[0].data if args else None
        if n == "abs":
            return Value(torch.abs(x), args[0].valid)
        if n == "floor":
            return Value(torch.floor(x), args[0].valid)
        if n == "ceiling":
            return Value(torch.ceil(x), args[0].valid)
        if n == "round":
            return Value(torch.round(x), args[0].valid)
        if n == "sqrt":
            return Value(torch.sqrt(torch.clamp(x, min=0)), args[0].valid)
        if n == "exp":
            return Value(torch.exp(x), args[0].valid)
        if n == "log":
            tiny = host_tensor(1e-30, torch.float32, x.device)
            return Value(torch.log(torch.maximum(x, tiny)), args[0].valid)
        if n == "power":
            return Value(torch.pow(x, args[1].data), _and_valid(*args))
        if n == "sign":
            return Value(torch.sign(x), args[0].valid)
        if n in ("min2", "least"):
            return Value(torch.minimum(x, args[1].data), _and_valid(*args))
        if n in ("max2", "greatest"):
            return Value(torch.maximum(x, args[1].data), _and_valid(*args))
        if n == "dateadd":
            part = e.args[0].value  # must be a literal part
            return Value(date_add(part, args[1].data, args[2].data),
                         _and_valid(args[1], args[2]))
        if n == "datepart":
            part = e.args[0].value
            return Value(date_part(part, args[1].data), args[1].valid)
        if n == "datediff_days":
            return Value(
                args[2].data.to(torch.int32) - args[1].data.to(torch.int32),
                _and_valid(args[1], args[2]),
            )
        raise NotImplementedError(f"intrinsic {n!r}")

    return ev(expr)
