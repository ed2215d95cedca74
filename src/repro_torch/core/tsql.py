"""Port of ``src/repro/core/tsql.py:1-553`` (a copy on the port's plan layer).

A T-SQL-subset parser frontend (paper §7.3: the framework is
language-agnostic — adding a surface language is a parser plus calls into
the construct classes).

Supported grammar (enough for the paper's §9 example shapes)::

    CREATE FUNCTION name(@p TYPE, ...) RETURNS TYPE AS
    BEGIN
        DECLARE @v TYPE [= expr];
        SET @v = expr;
        SELECT @v = AGG(col) FROM table WHERE pred;
        IF (pred) BEGIN ... END [ELSE BEGIN ... END]
        RETURN expr;
    END

Expressions: numbers, 'strings', @vars, identifiers (columns), + - * /,
comparisons (= <> < <= > >=), AND/OR/NOT, parentheses, CASE WHEN ... THEN
... ELSE ... END, and function calls (intrinsics).  Types: INT, FLOAT,
BIT, DATE, VARCHAR/CHAR(n).

Loops (the Aggify surface — see :mod:`repro_torch.loops`)::

    WHILE (pred) BEGIN ... END                       [BREAK inside]
    DECLARE c CURSOR FOR SELECT col, ... FROM t [WHERE pred];
    OPEN c;
    FETCH NEXT FROM c INTO @a, @b;
    WHILE @@fetch_status = 0 [AND guard] BEGIN
        ...body...
        FETCH NEXT FROM c INTO @a, @b;
    END
    CLOSE c; DEALLOCATE c;

The priming FETCH / trailing FETCH pair is folded into one
:class:`repro_torch.core.ir.CursorLoop`; anything off that shape raises
:class:`UnsupportedConstructError` with the offending line/column.
"""
from __future__ import annotations

import re

from repro_torch.core import frontend as F
from repro_torch.core import ir as IR
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.core.ir import UdfDef

#: the parsed name of the T-SQL ``@@fetch_status`` builtin (``@`` stripped
#: like every other variable token)
FETCH_STATUS = "@fetch_status"

_TOKEN = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\d+)|(?P<str>'[^']*')|(?P<var>@@?\w+)"
    r"|(?P<id>[A-Za-z_][\w.]*)|(?P<op><=|>=|<>|!=|[=<>+\-*/(),;]))"
)


class UnsupportedConstructError(SyntaxError):
    """A construct outside the supported T-SQL subset, with location.

    Carries ``construct`` (short name of the offending construct),
    ``line`` and ``col`` (1-based) so frontends can point at the source."""

    def __init__(self, construct: str, detail: str, line: int = 0, col: int = 0):
        self.construct = construct
        self.line = line
        self.col = col
        super().__init__(
            f"unsupported construct {construct!r} at line {line}, col {col}: "
            f"{detail}")

_TYPES = {
    "int": "int32", "bigint": "int32", "bit": "bool", "float": "float32",
    "real": "float32", "decimal": "float32", "money": "float32",
    "date": "date", "datetime": "date", "varchar": "str", "char": "str",
    "nvarchar": "str",
}

_AGGS = {"sum": F.sum_, "count": F.count_, "min": F.min_, "max": F.max_,
         "avg": F.avg_}


def _line_col(src: str, offset: int) -> tuple[int, int]:
    line = src.count("\n", 0, offset) + 1
    col = offset - src.rfind("\n", 0, offset)
    return line, col


def _tokenize(src: str):
    """Returns (tokens, positions): parallel lists, positions[i] = (line,
    col) of tokens[i].  Comments are blanked (not stripped) so offsets stay
    true to the original source."""
    out, positions, pos = [], [], 0
    src = re.sub(r"--[^\n]*", lambda m: " " * len(m.group(0)), src)
    while pos < len(src):
        m = _TOKEN.match(src, pos)
        if not m:
            if src[pos:].strip() == "":
                break
            line, col = _line_col(src, pos + len(src[pos:]) - len(src[pos:].lstrip()))
            raise UnsupportedConstructError(
                "token", f"cannot tokenize {src[pos:pos+40].strip()!r}",
                line, col)
        pos = m.end()
        for kind in ("num", "str", "var", "id", "op"):
            v = m.group(kind)
            if v is not None:
                out.append((kind, v.lower() if kind == "id" else v))
                positions.append(_line_col(src, m.start(kind)))
                break
    out.append(("eof", ""))
    positions.append(_line_col(src, len(src)))
    return out, positions


class _Parser:
    def __init__(self, tokens, positions=None):
        self.toks = tokens
        self.positions = positions or [(0, 0)] * len(tokens)
        self.i = 0
        self._cursors: dict[str, tuple[R.RelNode, list[str]]] = {}

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def err(self, construct: str, detail: str, at: int | None = None):
        """Raise an UnsupportedConstructError at token ``at`` (default: the
        last consumed token)."""
        idx = self.i - 1 if at is None else at
        idx = max(0, min(idx, len(self.positions) - 1))
        line, col = self.positions[idx]
        raise UnsupportedConstructError(construct, detail, line, col)

    def expect(self, value=None, kind=None):
        k, v = self.next()
        if value is not None and v.lower() != value.lower():
            self.err("syntax", f"expected {value!r}, got {v!r}")
        if kind is not None and k != kind:
            self.err("syntax", f"expected a {kind} token, got {k}:{v!r}")
        return v

    def accept(self, value):
        if self.peek()[1].lower() == value.lower():
            self.next()
            return True
        return False

    # ---------------------------------------------------------------- types
    def parse_type(self) -> str:
        name = self.expect(kind="id")
        if self.accept("("):  # char(50), decimal(12,2)
            while not self.accept(")"):
                self.next()
        if name not in _TYPES:
            self.err("type", f"type {name!r} is outside the supported subset")
        return _TYPES[name]

    # ----------------------------------------------------------- expressions
    def parse_expr(self) -> S.Scalar:
        return self._or()

    def _or(self):
        left = self._and()
        while self.peek()[1].lower() == "or":
            self.next()
            left = S.BoolOp("or", [left, self._and()])
        return left

    def _and(self):
        left = self._not()
        while self.peek()[1].lower() == "and":
            self.next()
            left = S.BoolOp("and", [left, self._not()])
        return left

    def _not(self):
        if self.peek()[1].lower() == "not":
            self.next()
            return S.BoolOp("not", [self._not()])
        return self._cmp()

    def _cmp(self):
        left = self._add()
        k, v = self.peek()
        ops = {"=": "==", "<>": "!=", "!=": "!=", "<": "<", "<=": "<=",
               ">": ">", ">=": ">="}
        if v in ops:
            self.next()
            return S.Cmp(ops[v], left, self._add())
        if v.lower() == "is":
            self.next()
            neg = self.accept("not")
            self.expect("null")
            e = S.IsNull(left)
            return S.BoolOp("not", [e]) if neg else e
        if v.lower() == "between":
            self.next()
            lo = self._add()
            self.expect("and")
            return S.Between(left, lo, self._add())
        if v.lower() == "in":
            self.next()
            self.expect("(")
            opts = [self._literal_value()]
            while self.accept(","):
                opts.append(self._literal_value())
            self.expect(")")
            return S.InList(left, opts)
        if v.lower() == "like":
            self.next()
            pat = self.expect(kind="str")
            return S.Like(left, pat.strip("'"))
        return left

    def _literal_value(self):
        k, v = self.next()
        if k == "num":
            return float(v) if "." in v else int(v)
        if k == "str":
            return v.strip("'")
        self.err("literal", f"expected a literal, got {v!r}")

    def _add(self):
        left = self._mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            left = S.BinOp(op, left, self._mul())
        return left

    def _mul(self):
        left = self._unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            left = S.BinOp(op, left, self._unary())
        return left

    def _unary(self):
        if self.peek()[1] == "-":
            self.next()
            return S.BinOp("-", S.Const(0), self._unary())
        return self._atom()

    def _atom(self) -> S.Scalar:
        k, v = self.next()
        if k == "num":
            return S.Const(float(v) if "." in v else int(v))
        if k == "str":
            return S.Const(v.strip("'"))
        if k == "var":
            return S.Var(v[1:])
        if v == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if k == "id":
            name = v
            if name == "null":
                return S.Const(None)
            if name == "case":
                return self._case()
            if self.peek()[1] == "(":  # function call
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.parse_expr())
                    while self.accept(","):
                        args.append(self.parse_expr())
                self.expect(")")
                base = name.split(".")[-1]
                if base in ("dateadd", "datepart"):
                    # first arg is a part keyword parsed as ColRef
                    part = args[0]
                    pname = part.name if isinstance(part, S.ColRef) else part.value
                    return S.Func(base, [S.Const(pname)] + args[1:])
                if "." in name:  # dbo.func -> UDF call
                    return S.UdfCall(base, args)
                return S.Func(base, args)
            return S.ColRef(name)
        self.err("expression", f"unexpected token {v!r}")

    def _case(self) -> S.Scalar:
        whens = []
        while self.accept("when"):
            p = self.parse_expr()
            self.expect("then")
            whens.append((p, self.parse_expr()))
        else_ = S.Const(None)
        if self.accept("else"):
            else_ = self.parse_expr()
        self.expect("end")
        return S.Case(whens, else_)

    # ------------------------------------------------------------ statements
    def parse_block(self, u: F.UdfBuilder):
        self.expect("begin")
        while not self.accept("end"):
            self.parse_statement(u)

    def parse_statement(self, u: F.UdfBuilder):
        k, v = self.peek()
        word = v.lower()
        if word == "declare":
            self.next()
            if self.peek()[0] == "id":  # DECLARE c CURSOR FOR ...
                self._parse_cursor_decl()
                return
            name = self.expect(kind="var")[1:]
            dtype = self.parse_type()
            init = None
            if self.accept("="):
                init = self.parse_expr()
            self.accept(";")
            u.declare(name, dtype, init)
        elif word == "set":
            self.next()
            name = self.expect(kind="var")[1:]
            self.expect("=")
            u.set(name, self.parse_expr())
            self.accept(";")
        elif word == "select":
            self.next()
            name = self.expect(kind="var")[1:]
            self.expect("=")
            expr = self.parse_expr()
            frm = None
            where = None
            if self.accept("from"):
                table = self.expect(kind="id").split(".")[-1]
                frm = F.scan(table)
                if self.accept("where"):
                    where = self.parse_expr()
            self.accept(";")
            if frm is None:
                u.set(name, expr)
            else:
                agg = self._as_agg(expr)
                u.select({name: agg}, frm=frm, where=where)
        elif word == "if":
            self.next()
            pred = self.parse_expr()
            with u.if_(pred):
                if self.peek()[1].lower() == "begin":
                    self.parse_block(u)
                else:
                    self.parse_statement(u)
            if self.accept("else"):
                with u.else_():
                    if self.peek()[1].lower() == "begin":
                        self.parse_block(u)
                    else:
                        self.parse_statement(u)
        elif word == "while":
            self.next()
            at = self.i
            pred = self.parse_expr()
            if self._uses_fetch_status(pred):
                self._parse_cursor_while(u, pred, at)
            else:
                with u.while_(pred):
                    self._parse_body(u)
        elif word == "break":
            self.next()
            self.accept(";")
            u.break_()
        elif word == "fetch":
            self._parse_fetch(u)
        elif word in ("open", "close", "deallocate"):
            # cursor lifecycle is implicit in the rewrite — consume as no-ops
            self.next()
            cname = self.expect(kind="id")
            if cname not in self._cursors:
                self.err("cursor", f"unknown cursor {cname!r}")
            self.accept(";")
        elif word == "return":
            self.next()
            u.return_(self.parse_expr())
            self.accept(";")
        elif v == ";":
            self.next()
        else:
            self.err("statement",
                     f"statement starting at {v!r} is outside the supported "
                     "subset", at=self.i)

    def _parse_body(self, u: F.UdfBuilder):
        if self.peek()[1].lower() == "begin":
            self.parse_block(u)
        else:
            self.parse_statement(u)

    # ------------------------------------------------------------- cursors
    def _parse_cursor_decl(self):
        name = self.expect(kind="id")
        self.expect("cursor")
        self.expect("for")
        self.expect("select")
        cols = []
        while True:
            if self.peek()[0] != "id":
                self.err("cursor-select",
                         "cursor SELECT list must be plain column names",
                         at=self.i)
            cols.append(self.next()[1])
            if not self.accept(","):
                break
        if self.peek()[1].lower() != "from":
            self.err("cursor-select",
                     "cursor SELECT list must be plain column names",
                     at=self.i)
        self.expect("from")
        table = self.expect(kind="id").split(".")[-1]
        plan: R.RelNode = R.Scan(table)
        if self.accept("where"):
            plan = R.Filter(plan, self.parse_expr())
        self.accept(";")
        self._cursors[name] = (plan, cols)

    def _parse_fetch(self, u: F.UdfBuilder):
        self.next()  # fetch
        self.expect("next")
        self.expect("from")
        cname = self.expect(kind="id")
        if cname not in self._cursors:
            self.err("fetch", f"unknown cursor {cname!r}")
        self.expect("into")
        tvars = [self.expect(kind="var")[1:]]
        while self.accept(","):
            tvars.append(self.expect(kind="var")[1:])
        self.accept(";")
        _, cols = self._cursors[cname]
        if len(tvars) != len(cols):
            self.err("fetch", f"FETCH INTO binds {len(tvars)} variables but "
                              f"cursor {cname!r} selects {len(cols)} columns")
        u.fetch_(cname, list(zip(tvars, cols)))

    @staticmethod
    def _uses_fetch_status(expr: S.Scalar) -> bool:
        return any(isinstance(n, S.Var) and n.name == FETCH_STATUS
                   for n in S.walk(expr))

    def _parse_cursor_while(self, u: F.UdfBuilder, pred: S.Scalar, at: int):
        """WHILE @@fetch_status = 0 [AND guard] over a primed cursor: fold
        the priming FETCH + trailing FETCH + body into one CursorLoop."""

        def conjuncts(e):
            if isinstance(e, S.BoolOp) and e.op == "and":
                out = []
                for a in e.args:
                    out.extend(conjuncts(a))
                return out
            return [e]

        def is_status_check(c):
            if not (isinstance(c, S.Cmp) and c.op == "=="):
                return False
            sides = (c.l, c.r)
            return any(isinstance(s, S.Var) and s.name == FETCH_STATUS
                       for s in sides) and any(
                isinstance(s, S.Const) and s.value == 0 for s in sides)

        rest, found = [], False
        for c in conjuncts(pred):
            if is_status_check(c):
                found = True
            elif self._uses_fetch_status(c):
                self.err("fetch-status",
                         "@@fetch_status may only appear as the conjunct "
                         "@@fetch_status = 0", at=at)
            else:
                rest.append(c)
        if not found:
            self.err("fetch-status",
                     "@@fetch_status must appear as the conjunct "
                     "@@fetch_status = 0", at=at)
        guard = None
        for c in rest:
            guard = c if guard is None else S.BoolOp("and", [guard, c])

        stmts = u._stack[-1]
        if not stmts or not isinstance(stmts[-1], IR.Fetch):
            self.err("cursor-while",
                     "WHILE @@fetch_status = 0 requires an immediately "
                     "preceding FETCH NEXT (the priming fetch)", at=at)
        prime = stmts.pop()

        with u._capture() as body:
            self._parse_body(u)
        if not body or not isinstance(body[-1], IR.Fetch):
            self.err("cursor-while",
                     "cursor WHILE body must end with FETCH NEXT", at=at)
        trailing = body.pop()
        if trailing.cursor != prime.cursor or trailing.targets != prime.targets:
            self.err("cursor-while",
                     "trailing FETCH NEXT must match the priming fetch "
                     "(same cursor, same INTO variables)", at=at)

        def has_fetch(stmts):
            for st in stmts:
                if isinstance(st, IR.Fetch):
                    return True
                if isinstance(st, IR.IfElse):
                    if has_fetch(st.then_body) or has_fetch(st.else_body):
                        return True
                if isinstance(st, (IR.While, IR.CursorLoop)):
                    if has_fetch(st.body):
                        return True
            return False

        if has_fetch(body):
            self.err("fetch",
                     "FETCH NEXT is only supported as the final statement "
                     "of a cursor WHILE body", at=at)

        plan, _ = self._cursors[prime.cursor]
        u._stack[-1].append(
            IR.CursorLoop(prime.cursor, plan, prime.targets, body, guard))
        u._last_if[-1] = None

    def _as_agg(self, expr: S.Scalar):
        if isinstance(expr, S.Func) and expr.name in _AGGS:
            arg = expr.args[0] if expr.args else None
            if expr.name == "count":
                return F.count_(arg)
            return _AGGS[expr.name](arg)
        return expr


def parse_udf(src: str) -> UdfDef:
    """Parse a CREATE FUNCTION statement into a UdfDef.

    In the UDF body, bare identifiers inside FROM/WHERE are table columns;
    @names are variables/parameters — matching T-SQL scoping."""
    p = _Parser(*_tokenize(src))
    p.expect("create")
    p.expect("function")
    name = p.expect(kind="id").split(".")[-1]
    p.expect("(")
    params = []
    while not p.accept(")"):
        pname = p.expect(kind="var")[1:]
        ptype = p.parse_type()
        params.append((pname, ptype))
        p.accept(",")
    p.expect("returns")
    rtype = p.parse_type()
    p.accept("as")
    u = F.UdfBuilder(name, params, rtype)
    p.parse_block(u)
    return u.build()
