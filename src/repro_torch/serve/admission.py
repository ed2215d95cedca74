"""Request admission rules as Froid-compiled UDFs: a port of
``src/repro/serve/admission.py``.

The paper's technique inside the serving scheduler: each tick evaluates
imperative per-request business rules (token budgeting, tier routing,
temperature selection) over the whole queued-request table as one
set-oriented plan.  The rules are authored imperatively (``UdfBuilder``)
and inlined by the port's binder like any other UDF.  The queue table is
re-created every tick on the session's device, and the tick path runs the
policy eagerly.

The per-request path (``request_statement``, ``submit``, ``verdict``,
``evaluate_coalesced``) prepares the same rules as one parameterized
statement over a ``ConstantScan``, under the closest compiling policy,
and coalesces concurrent submits on a
:class:`~repro_torch.serve.scheduler.CoalescingScheduler` into
``execute_many`` batches, each one ``torch.func.vmap`` on the device
(``fuse=True`` drains mixed-statement waves as one fused wave).  Under
INTERPRETED and HEKATON the rules run on the port's per-row interpreter,
on the same device.  ``store`` (a ``PlanStore`` or a directory) is
shared by the tick session and the request session, so the request
statement warm-starts from it across engine restarts.  ``mesh`` shards the
per-request batches' stacked request axis over the mesh's data axes (the
tick path is eager and unaffected).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import (FROID, INTERPRETED, ExecutionPolicy, Q, Session,
                              UdfBuilder, case, col, lit, param, resolve_policy,
                              scan, udf, var)
from repro_torch.core import relalg as R
from repro_torch.serve.scheduler import CoalescingScheduler, Ticket


def default_rules(db) -> None:
    """The built-in admission rules (users register their own the same way).

    token_budget(tier, prompt_len, requested) -> granted max_new_tokens
    temp_for(tier, requested_temp)            -> effective temperature
    admit(prompt_len, queue_depth)            -> bool
    """
    u = UdfBuilder("token_budget",
                   [("tier", "int32"), ("plen", "int32"), ("req", "int32")],
                   "int32")
    u.declare("cap", "int32")
    with u.if_(param("tier") >= 2):
        u.set("cap", lit(4096))
    with u.else_():
        with u.if_(param("tier") == 1):
            u.set("cap", lit(1024))
        with u.else_():
            u.set("cap", lit(256))
    # long prompts eat into the budget
    with u.if_(param("plen") > 2048):
        u.set("cap", var("cap") // 2)
    with u.if_(param("req") < var("cap")):
        u.return_(param("req"))
    u.return_(var("cap"))
    db.create_function(u.build())

    u = UdfBuilder("temp_for", [("tier", "int32"), ("t", "float32")], "float32")
    with u.if_((param("t") < 0.0) | (param("t") > 2.0)):
        u.return_(lit(0.7))  # out-of-range -> default
    with u.if_(param("tier") == 0):
        # free tier is clamped
        u.return_(case([(param("t") > 1.0, lit(1.0))], param("t")))
    u.return_(param("t"))
    db.create_function(u.build())

    u = UdfBuilder("admit", [("plen", "int32"), ("depth", "int32")], "bool")
    with u.if_(param("plen") > 32768):
        u.return_(lit(False))
    with u.if_((param("depth") > 512) & (param("plen") > 8192)):
        u.return_(lit(False))  # shed long prompts under pressure
    u.return_(lit(True))
    db.create_function(u.build())


def _tick_query():
    return (
        scan("queue")
        .compute(
            admit=udf("admit", col("plen"), col("depth")),
            granted=udf("token_budget", col("tier"), col("plen"), col("req")),
            temp_eff=udf("temp_for", col("tier"), col("temp")),
        )
        .project("admit", "granted", "temp_eff")
    )


def _request_query():
    """The same rules as a *parameterized* one-row statement: each request's
    fields arrive as params over a ConstantScan, so many individual
    requests ride one prepared plan and coalesce into ``execute_many``
    batches — no per-tick table reload, no plan-cache churn."""
    return (
        Q(R.ConstantScan())
        .compute(
            admit=udf("admit", param("plen"), param("depth")),
            granted=udf("token_budget", param("tier"), param("plen"),
                        param("req")),
            temp_eff=udf("temp_for", param("tier"), param("temp")),
        )
        .project("admit", "granted", "temp_eff")
    )


def _compiled_variant(policy: ExecutionPolicy) -> ExecutionPolicy:
    """The closest whole-plan policy: batched per-request admission needs a
    device program to vmap.  Python-mode interpretation cannot live inside
    the vmapped plan, so non-inlined python policies hop to the 'scan'
    interpreter (same results, batchable)."""
    if policy.compile_plan:
        return policy
    udf_mode = policy.udf_mode
    if not policy.inline_udfs and udf_mode == "python":
        udf_mode = "scan"
    return dataclasses.replace(
        policy, name=policy.name + "+compiled", compile_plan=True,
        udf_mode=udf_mode,
    )


class AdmissionPolicy:
    """Evaluates the rules over the queued-request table, set-oriented, on
    ``device`` (the card unless ``device="cpu"``).

    ``policy`` is an :class:`ExecutionPolicy` or preset name; the legacy
    ``froid`` flag maps True -> FROID, False -> INTERPRETED.
    ``scheduler``, ``fuse``, ``adaptive`` and ``timeout_s`` configure the
    per-request coalescing path (``fuse``: mixed-statement waves, e.g.
    custom rule statements sharing the request session, drain as one fused
    wave; ``timeout_s``: the default per-ticket deadline; an expired ticket
    sheds with a typed ``DeadlineExceeded``; ``mesh``: the device mesh the
    per-request batches shard over).  ``store``: the persistent plan store
    (a ``PlanStore`` or a path) both sessions share.
    """

    def __init__(self, froid: bool = True,
                 policy: ExecutionPolicy | str | None = None, *, device=None,
                 scheduler: CoalescingScheduler | None = None, mesh=None,
                 fuse: bool = False, adaptive: bool = False,
                 timeout_s: float | None = None, store=None):
        self.session = Session(device=device, store=store)
        default_rules(self.session)
        if policy is None:
            policy = FROID if froid else INTERPRETED
        # the queue table is re-loaded every tick: run the policy eagerly
        self.policy = resolve_policy(policy).eager()
        self.mesh = mesh
        self._query = _tick_query()
        # per-request path: a second session sharing the rule registry but
        # with an empty catalog, so the request statement's cache key is
        # immune to the tick path's queue-table reloads
        self._request_session = Session(device=self.session.device,
                                        store=self.session.store)
        self._request_session.registry = self.session.registry
        self._request_stmt = None
        self.timeout_s = timeout_s
        self.scheduler = scheduler or CoalescingScheduler(
            fuse=fuse, adaptive=adaptive, default_timeout_s=timeout_s,
        )

    def evaluate(self, requests: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """requests: columns tier, prompt_len, max_new_tokens, temperature.
        Returns host columns: admit (bool), granted (int32), temp (float32)."""
        n = len(requests["tier"])
        self.session.create_table(
            "queue",
            tier=np.asarray(requests["tier"]).astype(np.int32),
            plen=np.asarray(requests["prompt_len"]).astype(np.int32),
            req=np.asarray(requests["max_new_tokens"]).astype(np.int32),
            temp=np.asarray(requests["temperature"]).astype(np.float32),
            depth=np.full(n, n, np.int32),
        )
        cols = self.session.execute(self._query, self.policy).table.columns
        return {
            "admit": cols["admit"].data.cpu().numpy().astype(bool),
            "granted": cols["granted"].data.cpu().numpy().astype(np.int32),
            "temp": cols["temp_eff"].data.cpu().numpy().astype(np.float32),
        }

    # -- per-request coalescing path ----------------------------------------
    def request_statement(self):
        """The rules as one prepared parameterized statement (lazy)."""
        if self._request_stmt is None:
            policy = _compiled_variant(self.policy)
            if self.mesh is not None:
                policy = policy.sharded(self.mesh)
            self._request_stmt = self._request_session.prepare(
                _request_query(), policy
            )
        return self._request_stmt

    def submit(self, *, tier: int, prompt_len: int, max_new_tokens: int,
               temperature: float, depth: int = 0,
               timeout_s: float | None = None) -> Ticket:
        """Queue one request's admission evaluation; concurrent submits for
        the same statement coalesce into ``execute_many`` batches.
        ``timeout_s`` overrides the policy-wide ticket deadline."""
        return self.scheduler.submit(
            self.request_statement(),
            {"tier": int(tier), "plen": int(prompt_len),
             "req": int(max_new_tokens), "temp": float(temperature),
             "depth": int(depth)},
            timeout_s=timeout_s,
        )

    @staticmethod
    def verdict(result) -> dict:
        """Decode one per-request QueryResult into the evaluate() schema."""
        cols = result.table.columns
        return {
            "admit": bool(cols["admit"].data.cpu().numpy()[0]),
            "granted": int(cols["granted"].data.cpu().numpy()[0]),
            "temp": float(cols["temp_eff"].data.cpu().numpy()[0]),
        }

    def evaluate_coalesced(self, requests: dict[str, np.ndarray]) -> dict:
        """``evaluate``, but through per-request submits + one scheduler
        drain — the serving path's shape, returning the tick-path schema."""
        n = len(requests["tier"])
        tickets = [
            self.submit(
                tier=int(requests["tier"][i]),
                prompt_len=int(requests["prompt_len"][i]),
                max_new_tokens=int(requests["max_new_tokens"][i]),
                temperature=float(requests["temperature"][i]),
                depth=n,
            )
            for i in range(n)
        ]
        self.scheduler.flush()
        out = [self.verdict(t.result()) for t in tickets]
        return {
            "admit": np.array([v["admit"] for v in out], bool),
            "granted": np.array([v["granted"] for v in out], np.int32),
            "temp": np.array([v["temp"] for v in out], np.float32),
        }
