"""Port of ``src/repro/core/database.py:1-134``: the backward-compatible
facade over :class:`repro_torch.core.session.Session`.

``Database`` was the original entry point, exposing the paper's experiment
axes as boolean kwargs (``froid=…, mode=…, optimize=…``) and re-planning on
every ``run()``.  It is now a thin shim: every call maps its kwargs onto an
:class:`ExecutionPolicy` and routes through the session's plan/executable
caches.  New code should use ``Session.prepare(…).execute(…)`` with the
policy presets (``FROID`` / ``INTERPRETED`` / ``HEKATON``) directly.  The
one addition is ``device``, passed to the session.
"""
from __future__ import annotations

import warnings

from repro_torch.core import relalg as R
from repro_torch.core.binder import InlineConstraints
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.core.session import QueryResult, RunResult, Session
from repro_torch.tables.table import Table

_UNSET = object()


def _warn_legacy_kwargs(method: str, **kwargs) -> dict:
    """DeprecationWarning for explicitly-passed legacy kwarg spellings and
    the resolved (default-filled) kwarg dict.  The kwargs themselves keep
    working — this is the migration nudge toward Session/ExecutionPolicy."""
    passed = sorted(k for k, v in kwargs.items() if v is not _UNSET)
    if passed:
        warnings.warn(
            f"Database.{method}({', '.join(passed)}=…) kwarg spellings are "
            "deprecated; use Session.prepare/execute with an ExecutionPolicy "
            "preset (FROID / INTERPRETED / HEKATON) — see ROADMAP.md "
            "§Public API",
            DeprecationWarning,
            stacklevel=3,
        )
    return kwargs


class Database:
    """The legacy entry point over a :class:`Session` on ``device`` (the
    card unless ``device="cpu"``)."""

    def __init__(self, constraints: InlineConstraints | None = None,
                 device=None):
        self.session = Session(constraints=constraints, device=device)

    # the session owns catalog/registry/constraints; the shim forwards both
    # reads and (legacy benchmark-style) whole-attribute assignment
    @property
    def catalog(self) -> dict[str, Table]:
        return self.session.catalog

    @catalog.setter
    def catalog(self, value):
        self.session.catalog = value

    @property
    def registry(self):
        return self.session.registry

    @registry.setter
    def registry(self, value):
        self.session.registry = value

    @property
    def constraints(self) -> InlineConstraints:
        return self.session.constraints

    @constraints.setter
    def constraints(self, value):
        self.session.constraints = value

    # -- DDL ---------------------------------------------------------------
    # name/table positional-only: columns may be called "name"/"table"
    def create_table(self, name: str, table: Table | None = None, /, **arrays):
        return self.session.create_table(name, table, **arrays)

    def create_function(self, udf):
        return self.session.create_function(udf)

    # -- planning ----------------------------------------------------------
    def plan_for(self, query, froid: bool = True, optimize: bool = True) -> R.RelNode:
        policy = ExecutionPolicy.from_kwargs(froid=froid, optimize=optimize)
        return self.session.prepare(query, policy).plan

    def explain(self, query, froid: bool = True, optimize: bool = True) -> str:
        policy = ExecutionPolicy.from_kwargs(froid=froid, optimize=optimize)
        return self.session.explain(query, policy)

    # -- execution ---------------------------------------------------------
    def run(
        self,
        query,
        froid=_UNSET,
        mode=_UNSET,
        optimize=_UNSET,
        params: dict | None = None,
        jit_statements=_UNSET,
        pallas_agg=_UNSET,
    ) -> QueryResult:
        """Eager execution with the legacy kwarg axes (deprecated spelling
        of ``session.execute(query, policy, params)``)."""
        kw = _warn_legacy_kwargs(
            "run", froid=froid, mode=mode, optimize=optimize,
            jit_statements=jit_statements, pallas_agg=pallas_agg,
        )
        policy = ExecutionPolicy.from_kwargs(
            froid=kw["froid"] if kw["froid"] is not _UNSET else True,
            mode=kw["mode"] if kw["mode"] is not _UNSET else "python",
            optimize=kw["optimize"] if kw["optimize"] is not _UNSET else True,
            jit_statements=(kw["jit_statements"]
                            if kw["jit_statements"] is not _UNSET else True),
            pallas_agg=(kw["pallas_agg"]
                        if kw["pallas_agg"] is not _UNSET else False),
            compiled=False,
        )
        return self.session.execute(query, policy, params=params)

    def run_compiled(self, query, froid=_UNSET, mode=_UNSET, optimize=_UNSET):
        """Deprecated spelling of ``session.prepare(…)``: returns the raw
        compiled callable plus the plan (the old warm-cache benchmark
        interface).  ``PreparedStatement`` itself is the replacement."""
        kw = _warn_legacy_kwargs(
            "run_compiled", froid=froid, mode=mode, optimize=optimize,
        )
        policy = ExecutionPolicy.from_kwargs(
            froid=kw["froid"] if kw["froid"] is not _UNSET else True,
            mode=kw["mode"] if kw["mode"] is not _UNSET else "scan",
            optimize=kw["optimize"] if kw["optimize"] is not _UNSET else True,
            compiled=True,
        )
        ps = self.session.prepare(query, policy)
        return ps, ps.plan


__all__ = ["Database", "QueryResult", "RunResult"]
