"""Port of ``src/repro/core/__init__.py``: the Froid engine's public API,
for the modules this package has ported."""
from repro_torch.core.algebrizer import AlgebrizeError, algebrize
from repro_torch.core.binder import Binder, InlineConstraints
from repro_torch.core.database import Database
from repro_torch.core.executor import Executor, MaskedTable
from repro_torch.core.frontend import (
    Q,
    UdfBuilder,
    avg_,
    between,
    case,
    cast,
    coalesce,
    col,
    count_,
    dateadd,
    datepart,
    exists,
    func,
    in_list,
    isnull,
    like,
    lit,
    max_,
    min_,
    not_exists,
    param,
    scalar_subquery,
    scan,
    sum_,
    udf,
    var,
)
from repro_torch.core.interpreter import Interpreter, InterpreterError
from repro_torch.core.ir import (
    Assign,
    Break,
    CursorLoop,
    Declare,
    Fetch,
    IfElse,
    Return,
    UdfDef,
    While,
)
from repro_torch.core.optimizer import explain, optimize
from repro_torch.core.policy import (
    FROID,
    HEKATON,
    INTERPRETED,
    PRESETS,
    ROUTED,
    ExecutionPolicy,
    resolve_policy,
)
from repro_torch.core.session import (
    AsyncResult,
    PreparedStatement,
    QueryResult,
    RunResult,
    Session,
    batch_bucket,
    param_signature,
    plan_fingerprint,
)
from repro_torch.core.tsql import FETCH_STATUS, UnsupportedConstructError, parse_udf

__all__ = [
    "AlgebrizeError", "algebrize", "Binder", "InlineConstraints", "Database",
    "RunResult", "Executor", "MaskedTable", "Q", "UdfBuilder", "avg_",
    "between", "case", "cast", "coalesce", "col", "count_", "dateadd",
    "datepart", "exists", "func", "in_list", "isnull", "like", "lit", "max_",
    "min_", "not_exists", "param", "scalar_subquery", "scan", "sum_", "udf",
    "var", "Interpreter", "InterpreterError", "Assign", "Declare", "IfElse", "Return", "UdfDef",
    "Break", "While", "Fetch", "CursorLoop",
    "FETCH_STATUS", "UnsupportedConstructError", "parse_udf",
    "explain", "optimize",
    "Session", "PreparedStatement", "QueryResult", "AsyncResult", "batch_bucket",
    "ExecutionPolicy", "FROID", "INTERPRETED", "HEKATON", "ROUTED", "PRESETS",
    "resolve_policy", "plan_fingerprint", "param_signature",
]
