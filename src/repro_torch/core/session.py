"""Port of ``src/repro/core/session.py:1-2106``, the serial path:
Session / PreparedStatement, the engine's prepare-once-execute-many API.

* :class:`Session` owns the catalog (on its device) + UDF registry and two
  caches — a **plan cache** (bound + optimized plans, keyed by query
  fingerprint x policy x catalog/registry state) and an **executable
  cache** (the plan's ``raw`` closure, additionally keyed by the parameter
  signature), with the reference's cache keys.
* :class:`PreparedStatement` is the client handle: ``prepare`` plans and
  binds (cold); ``execute(params=…)`` runs warm off the cached executable.
  Where the reference jit-compiles ``raw``, the port runs it eagerly on the
  device: PyTorch needs no trace, and the plan's operators queue without a
  host sync until the one ``torch.cuda.synchronize`` at the end.
* :class:`QueryResult` reports rows lazily plus the plan, explain text,
  engine stats and whether the call was served from cache.

Entry points run on the card: ``Session(device=None)`` means ``"cuda"`` and
raises where CUDA is absent; only an explicit ``device="cpu"`` runs on the
host.  Not in this slice: ``execute_many``, ``execute_async``, fusion,
persistence, cost routing and fault injection, and the interpreter — a
plan that still holds a ``UdfCall``, and the INTERPRETED and HEKATON
policies, raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch.core import optimizer as O
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.core.binder import Binder, InlineConstraints
from repro_torch.core.executor import Executor, MaskedTable
from repro_torch.core.fingerprint import _norm, plan_fingerprint
from repro_torch.core.frontend import Q
from repro_torch.core.ir import UdfDef
from repro_torch.core.policy import FROID, ExecutionPolicy, resolve_policy
from repro_torch.tables.table import (Column, DictEncoding, Table, catalog_from_numpy,
                                      resolve_device)

# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


class QueryResult:
    """Result of one execution.  ``table`` (compacted host-visible rows)
    materializes lazily; ``masked`` is the device form."""

    def __init__(self, masked: MaskedTable, plan: R.RelNode,
                 elapsed_s: float, stats: dict,
                 policy: ExecutionPolicy | None = None,
                 cache_hit: bool = False):
        self.masked = masked
        self.plan = plan
        self.elapsed_s = elapsed_s
        self.stats = stats
        self.policy = policy
        self.cache_hit = cache_hit
        self._table: Table | None = None

    @property
    def table(self) -> Table:
        if self._table is None:
            self._table = self.masked.compact()
        return self._table

    @property
    def explain(self) -> str:
        return O.explain(self.plan)

    def __repr__(self):
        pol = self.policy.name if self.policy else "?"
        return (f"QueryResult(rows={self.masked.num_rows}, policy={pol}, "
                f"cache_hit={self.cache_hit}, elapsed_s={self.elapsed_s:.4f})")


# monotonic stamps for cache tokens: attached to catalog/registry objects
# the first time the session sees them, so a *new* object always gets a new
# stamp even if the allocator reuses a dead object's address
_stamps = itertools.count(1)


def _stamp(obj) -> int:
    s = getattr(obj, "_session_stamp", None)
    if s is None:
        s = next(_stamps)
        try:
            obj._session_stamp = s
        except AttributeError:  # frozen dataclass
            object.__setattr__(obj, "_session_stamp", s)
    return s


class _BoundedCache(OrderedDict):
    """Insertion-ordered dict evicting the least-recently-used entry past
    ``cap``."""

    def __init__(self, cap: int):
        super().__init__()
        self.cap = cap

    def get(self, key, default=None):
        v = super().get(key, default)
        if key in self:
            self.move_to_end(key)
        return v

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.cap:
            self.popitem(last=False)


# ---------------------------------------------------------------------------
# parameter handling
# ---------------------------------------------------------------------------

_ARRAY_CASTS = {torch.float64: torch.float32, torch.int64: torch.int32}


def _param_value(v, device) -> S.Value:
    """A parameter as a Value on ``device``, at the reference's dtypes
    (int -> int32, float -> float32, strings as one-entry dictionaries)."""
    if isinstance(v, S.Value):
        return v
    if isinstance(v, str):
        return S.Value(torch.tensor(0, dtype=torch.int32, device=device), None,
                       DictEncoding([v]))
    if isinstance(v, bool):
        return S.Value(torch.tensor(v, dtype=torch.bool, device=device))
    if isinstance(v, (int, np.integer)):
        return S.Value(torch.tensor(int(v), dtype=torch.int32, device=device))
    if isinstance(v, (float, np.floating)):
        return S.Value(torch.tensor(float(v), dtype=torch.float32, device=device))
    arr = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    arr = arr.to(device=device, dtype=_ARRAY_CASTS.get(arr.dtype, arr.dtype))
    return S.Value(arr)


_SIG_DTYPES = {"float64": "float32", "int64": "int32",
               "torch.float64": "float32", "torch.int64": "int32"}


def param_signature(params: dict | None) -> tuple:
    """The shape of a parameter set: names, dtypes, shapes — and for
    strings the value itself (the dictionary is host-side metadata baked
    into the executable).  Value changes within a signature never re-plan.
    Computed host-side: no device tensors are created here."""
    if not params:
        return ()
    out = []
    for name in sorted(params):
        v = params[name]
        if isinstance(v, str):
            out.append((name, "str", v))
        elif isinstance(v, S.Value):
            out.append((name, str(v.data.dtype), tuple(v.data.shape),
                        _vocab(v.dictionary)))
        elif isinstance(v, bool):
            out.append((name, "bool", ()))
        elif isinstance(v, (int, np.integer)):
            out.append((name, "int32", ()))
        elif isinstance(v, (float, np.floating)):
            out.append((name, "float32", ()))
        elif hasattr(v, "dtype") and hasattr(v, "shape"):
            dt = str(v.dtype)
            out.append((name, _SIG_DTYPES.get(dt, dt), tuple(v.shape)))
        else:
            arr = np.asarray(v)
            dt = str(arr.dtype)
            out.append((name, _SIG_DTYPES.get(dt, dt), tuple(arr.shape)))
    return tuple(out)


def _vocab(dictionary) -> tuple | None:
    """Host tuple of a DictEncoding's contents."""
    if dictionary is None:
        return None
    return dictionary.vocab


def _has_udf_calls(plan: R.RelNode) -> bool:
    return any(
        isinstance(e, S.UdfCall)
        for n in R.walk_plan_deep(plan)
        for ex in n.exprs()
        for e in S.walk(ex)
    )


def _check_supported(policy: ExecutionPolicy) -> None:
    if not policy.inline_udfs:
        raise NotImplementedError(
            f"policy {policy.name!r} interprets UDFs per row; the interpreter "
            "is not ported yet (ROADMAP A4)")
    if policy.route:
        raise NotImplementedError(
            "cost routing is not ported yet (ROADMAP A8)")


def _require_inlined(plan: R.RelNode) -> None:
    if _has_udf_calls(plan):
        raise NotImplementedError(
            "the plan still holds a UDF call the binder could not inline; "
            "the per-row interpreter is not ported yet (ROADMAP A4)")


# ---------------------------------------------------------------------------
# executables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Executable:
    fn: Any  # (param_values, catalog_token) -> (mask, cols), see _executable
    plan: R.RelNode
    out_dicts: dict  # column name -> DictEncoding | None
    stats: dict  # logical reads of one execution


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------


class Session:
    """Catalog + registry + plan/executable caches; the engine's public
    entry point.  ``prepare`` returns a :class:`PreparedStatement`;
    ``execute`` is prepare-and-run (sharing the same caches)."""

    #: bound on each cache (plans / executables / prepared handles)
    CACHE_CAP = 256

    def __init__(self, constraints: InlineConstraints | None = None,
                 cache_cap: int | None = None, device=None):
        self.device = resolve_device(device)
        self.catalog: dict[str, Table] = {}
        self.registry: dict[str, UdfDef] = {}
        self.constraints = constraints or InlineConstraints()
        cap = self.CACHE_CAP if cache_cap is None else cache_cap
        self._plans: _BoundedCache = _BoundedCache(cap)
        self._execs: _BoundedCache = _BoundedCache(cap)
        self._prepared: _BoundedCache = _BoundedCache(cap)
        self.cache_stats = {
            "plan_hits": 0, "plan_misses": 0,
            "exec_hits": 0, "exec_misses": 0,
        }

    # -- DDL ---------------------------------------------------------------
    # name/table are positional-only so columns may be called "name"/"table"
    def create_table(self, name: str, table: Table | None = None, /, **arrays):
        t = table if table is not None else Table.from_arrays(self.device, **arrays)
        wrong = t.devices() - {self.device}
        if wrong:
            raise ValueError(
                f"table {name!r} has columns on {sorted(map(str, wrong))} but the "
                f"session runs on {self.device}; build it with "
                f"Table.from_arrays({str(self.device)!r}, ...) or pass the arrays "
                "to create_table")
        t.compute_stats()  # histograms for the optimizer
        self.catalog[name] = t
        return t

    def load_catalog(self, tables) -> dict[str, Table]:
        """Load ``{table: {column: (data, valid_or_None, vocab_or_None)}}``
        host arrays onto the session's device, keeping dictionary codes
        exactly (see :func:`~repro_torch.tables.table.catalog_from_numpy`)."""
        built = catalog_from_numpy(tables, self.device)
        for name, t in built.items():
            self.create_table(name, t)
        return built

    def create_function(self, udf: UdfDef):
        self.registry[udf.name] = udf
        return udf

    # -- public API --------------------------------------------------------
    def prepare(self, query, policy: ExecutionPolicy | str = FROID
                ) -> "PreparedStatement":
        policy = resolve_policy(policy)
        _check_supported(policy)
        node = query.node if isinstance(query, Q) else query
        # the handle cache additionally keys on the non-identity knobs, so
        # two prepares with different knobs do not alias
        key = (plan_fingerprint(node), policy.fingerprint(),
               policy.max_batch, policy.coalesce_window_s, policy.allow_async,
               policy.max_inflight, policy.fuse, policy.max_fused_statements)
        ps = self._prepared.get(key)
        if ps is None:
            ps = PreparedStatement(self, node, policy)
            self._prepared[key] = ps
        ps._ensure_plan()  # cold: bind + optimize now
        return ps

    def execute(self, query, policy: ExecutionPolicy | str = FROID,
                params: dict | None = None) -> QueryResult:
        return self.prepare(query, policy).execute(params=params)

    def explain(self, query, policy: ExecutionPolicy | str = FROID) -> str:
        policy = resolve_policy(policy)
        node = query.node if isinstance(query, Q) else query
        plan, _ = self._cached_plan(node, plan_fingerprint(node), policy)
        return O.explain(plan)

    # -- cache-state tokens ------------------------------------------------
    def _catalog_token(self) -> tuple:
        return tuple(
            (name, _stamp(t), t.num_rows, tuple(t.columns))
            for name, t in sorted(self.catalog.items())
        )

    def _registry_token(self) -> tuple:
        return tuple(
            (name, _stamp(u)) for name, u in sorted(self.registry.items())
        )

    def _constraints_token(self) -> tuple:
        return _norm(self.constraints)

    def _env_token(self) -> tuple:
        return (self._catalog_token(), self._registry_token(),
                self._constraints_token())

    # -- planning ----------------------------------------------------------
    def _build_plan(self, node: R.RelNode, policy: ExecutionPolicy) -> R.RelNode:
        plan = node
        # the query's intended output schema (before inlining widens rows)
        try:
            wanted = R.output_columns(plan, self.catalog)
        except Exception:
            wanted = None
        if policy.inline_udfs:
            binder = Binder(self.registry, self.constraints)
            plan = binder.bind(plan)
        if policy.optimize:
            plan = O.optimize(
                plan, self.catalog, required=set(wanted) if wanted else None
            )
        if wanted is not None:
            try:
                have = R.output_columns(plan, self.catalog)
            except Exception:
                have = None
            if have is not None and have != wanted:
                plan = R.Project(plan, wanted)
        return plan

    def _cached_plan(self, node: R.RelNode, query_fp: tuple,
                     policy: ExecutionPolicy) -> tuple[R.RelNode, bool]:
        """(plan, came-from-cache).  Keyed only on the plan-relevant policy
        axes."""
        key = (query_fp, policy.inline_udfs, policy.optimize, self._env_token())
        plan = self._plans.get(key)
        if plan is not None:
            self.cache_stats["plan_hits"] += 1
            return plan, True
        self.cache_stats["plan_misses"] += 1
        plan = self._build_plan(node, policy)
        self._plans[key] = plan
        return plan, False

    # -- executables -------------------------------------------------------
    def _catalog_args(self, token: tuple | None = None):
        """Catalog tensors as ``raw``'s argument structure, cached per
        catalog token — rebuilding per call would allocate a validity mask
        per column inside every warm execute."""
        if token is None:
            token = self._catalog_token()
        cached = getattr(self, "_args_cache", None)
        if cached is not None and cached[0] == token:
            return cached[1]
        args = {
            tname: {c: (col.data, col.validity()) for c, col in t.columns.items()}
            for tname, t in self.catalog.items()
        }
        self._args_cache = (token, args)
        return args

    def _executable(self, node: R.RelNode, query_fp: tuple,
                    policy: ExecutionPolicy, params: dict | None,
                    env_token: tuple | None = None
                    ) -> tuple[_Executable, bool, bool]:
        """(executable, exec-cache-hit, plan-cache-hit)."""
        sig = param_signature(params)
        if env_token is None:
            env_token = self._env_token()
        key = (query_fp, policy.fingerprint(), env_token, sig)
        entry = self._execs.get(key)
        if entry is not None:
            self.cache_stats["exec_hits"] += 1
            return entry, True, True
        self.cache_stats["exec_misses"] += 1
        plan, plan_hit = self._cached_plan(node, query_fp, policy)
        _require_inlined(plan)

        # host-side metadata (dictionaries) is captured; data goes by
        # argument, so a catalog reload with the same shape reuses nothing
        # stale
        meta = {
            tname: {c: col.dictionary for c, col in t.columns.items()}
            for tname, t in self.catalog.items()
        }
        pdicts = {
            name: _param_value(v, self.device).dictionary
            for name, v in (params or {}).items()
        }
        out_dicts: dict = {}
        run_stats: dict = {}
        device = self.device

        def raw(table_args, param_args):
            catalog = {
                tname: Table(
                    {
                        c: Column(data, valid, meta[tname][c])
                        for c, (data, valid) in cols.items()
                    }
                )
                for tname, cols in table_args.items()
            }
            pvals = {
                name: S.Value(data, valid, pdicts[name])
                for name, (data, valid) in param_args.items()
            }
            ex = Executor(catalog, use_pallas_agg=policy.pallas_agg,
                          device=device)
            out = ex.execute(plan, params=pvals)
            for n, c in out.table.columns.items():
                out_dicts[n] = c.dictionary
            run_stats.update(ex.stats)
            cols = {n: (c.data, c.validity()) for n, c in out.table.columns.items()}
            return out.mask, cols

        def fn(param_values: dict | None = None,
               catalog_token: tuple | None = None):
            pargs = {}
            for pname, x in (param_values or {}).items():
                v = _param_value(x, device)
                pargs[pname] = (v.data, v.validity())
            return raw(self._catalog_args(catalog_token), pargs)

        entry = _Executable(fn, plan, out_dicts, run_stats)
        self._execs[key] = entry
        return entry, False, plan_hit

    def synchronize(self) -> None:
        """Wait for the session's device (the reference's
        ``jax.block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# ---------------------------------------------------------------------------
# PreparedStatement
# ---------------------------------------------------------------------------


class PreparedStatement:
    """A query bound to a session + policy.

    ``execute(params=…) -> QueryResult`` is the client path: the cold
    call plans + binds; warm calls reuse the session caches and set
    ``QueryResult.cache_hit``.
    """

    def __init__(self, session: Session, node: R.RelNode,
                 policy: ExecutionPolicy):
        self.session = session
        self.node = node
        self.policy = policy
        self._query_fp = plan_fingerprint(node)
        # stamp of the last plan this statement executed eagerly — a
        # plan-cache hit only counts as warm once *this statement* has run
        # that plan before
        self._executed_plan: int | None = None

    def _ensure_plan(self) -> R.RelNode:
        plan, _ = self.session._cached_plan(self.node, self._query_fp, self.policy)
        return plan

    @property
    def plan(self) -> R.RelNode:
        return self._ensure_plan()

    def explain(self) -> str:
        return O.explain(self._ensure_plan())

    def execute(self, params: dict | None = None) -> QueryResult:
        if self.policy.compile_plan:
            return self._execute_compiled(params)
        return self._execute_eager(params)

    def _execute_compiled(self, params) -> QueryResult:
        env_token = self.session._env_token()
        entry, exec_hit, plan_hit = self.session._executable(
            self.node, self._query_fp, self.policy, params, env_token
        )
        t0 = time.perf_counter()
        mask, cols = entry.fn(params, env_token[0])
        self.session.synchronize()
        elapsed = time.perf_counter() - t0
        table = Table(
            {n: Column(data, valid, entry.out_dicts.get(n))
             for n, (data, valid) in cols.items()}
        )
        stats = {**entry.stats, "compiled": True}
        return QueryResult(MaskedTable(table, mask), entry.plan, elapsed, stats,
                           policy=self.policy,
                           cache_hit=exec_hit and plan_hit)

    def _execute_eager(self, params) -> QueryResult:
        plan, plan_hit = self.session._cached_plan(
            self.node, self._query_fp, self.policy
        )
        _require_inlined(plan)
        warm = plan_hit and self._executed_plan == _stamp(plan)
        self._executed_plan = _stamp(plan)
        device = self.session.device
        executor = Executor(self.session.catalog,
                            use_pallas_agg=self.policy.pallas_agg, device=device)
        pvals = {n: _param_value(v, device) for n, v in (params or {}).items()}
        t0 = time.perf_counter()
        masked = executor.execute(plan, params=pvals)
        self.session.synchronize()
        elapsed = time.perf_counter() - t0
        return QueryResult(masked, plan, elapsed, executor.stats,
                           policy=self.policy, cache_hit=warm)
