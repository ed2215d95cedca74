"""Request admission rules as Froid-compiled UDFs: a port of
``src/repro/serve/admission.py`` (``default_rules``, ``_tick_query`` and
``AdmissionPolicy.evaluate``, ``:42-193``).

The paper's technique inside the serving scheduler: each tick evaluates
imperative per-request business rules (token budgeting, tier routing,
temperature selection) over the whole queued-request table as one
set-oriented plan.  The rules are authored imperatively (``UdfBuilder``)
and inlined by the port's binder like any other UDF.  The queue table is
re-created every tick on the session's device, and the policy runs
eagerly.

Not in this slice: the per-request coalescing path (``request_statement``,
``submit``, ``verdict``, ``evaluate_coalesced`` and the ``scheduler``,
``mesh``, ``fuse``, ``adaptive`` and ``timeout_s`` arguments) waits for
``execute_many`` and the scheduler (ROADMAP A6), ``store`` for
persistence (A9).  Under INTERPRETED and HEKATON the rules run on the
port's per-row interpreter (``python`` and ``scan`` mode), on the same
device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (FROID, INTERPRETED, ExecutionPolicy, Session,
                              UdfBuilder, case, col, lit, param, resolve_policy,
                              scan, udf, var)


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


def _waits(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


class AdmissionPolicy:
    """Evaluates the rules over the queued-request table, set-oriented, on
    ``device`` (the card unless ``device="cpu"``).

    ``policy`` is an :class:`ExecutionPolicy` or preset name; the legacy
    ``froid`` flag maps True -> FROID, False -> INTERPRETED.
    """

    def __init__(self, froid: bool = True,
                 policy: ExecutionPolicy | str | None = None, *, device=None,
                 scheduler=None, mesh=None, fuse: bool = False,
                 adaptive: bool = False, timeout_s: float | None = None,
                 store=None):
        if scheduler is not None or mesh is not None or fuse or adaptive \
                or timeout_s is not None:
            _waits("the per-request admission path (scheduler, mesh, fuse, "
                   "adaptive, timeout_s)", "A6")
        if store is not None:
            _waits("the persistent plan store", "A9")
        self.session = Session(device=device)
        default_rules(self.session)
        if policy is None:
            policy = FROID if froid else INTERPRETED
        # the queue table is re-loaded every tick: run the policy eagerly
        self.policy = resolve_policy(policy).eager()
        self._query = _tick_query()

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

    def request_statement(self):
        _waits("the per-request admission statement", "A6")

    def submit(self, **kwargs):
        _waits("per-request admission (submit)", "A6")

    def evaluate_coalesced(self, requests):
        _waits("coalesced admission", "A6")
