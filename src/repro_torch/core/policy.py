"""Port of ``src/repro/core/policy.py:1-264``:
a copy without the mesh/sharding members.

Execution policies: the paper's experiment axes as one value object.

The engine historically exposed its modes as a soup of boolean kwargs
(``froid=…, mode=…, optimize=…, jit_statements=…, pallas_agg=…``) spread
over ``Database.run`` / ``Database.run_compiled``.  ``ExecutionPolicy``
packages one point of that space; the named presets are the paper's
Table 5 quadrants:

* ``FROID``       — bind-time UDF inlining + rewrite rules + set-oriented
  plan, whole-plan compilation (the paper's contribution).
* ``INTERPRETED`` — iterative per-tuple UDF interpretation, statement at a
  time with per-statement plan caching (classic T-SQL, §2.2).  The host
  drives control flow, so plans execute eagerly (no whole-plan jit).
* ``HEKATON``     — natively-compiled-but-still-iterative UDFs (§8.2.7):
  the UDF body traces to one compiled function driven per row inside the
  compiled plan.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """One point in the engine's execution-mode space.

    ``name`` is a display label only — two policies with the same knobs
    compare (and cache) equal regardless of name.
    """

    name: str = dataclasses.field(default="custom", compare=False)
    #: bind-time UDF inlining (the paper's Froid pass)
    inline_udfs: bool = True
    #: iterative evaluation mode for non-inlined UDFs: "python" (statement
    #: at a time, host control flow) | "scan" (whole-body native trace)
    udf_mode: str = "python"
    #: run the rewrite-rule optimizer over the bound plan
    optimize: bool = True
    #: cache + jit per-statement plans inside the "python" interpreter
    jit_statements: bool = True
    #: hand-written Hopper relagg kernel for eligible group-bys (batch
    #: mode); the name is the reference's, so policies read the same
    pallas_agg: bool = False
    #: compile the whole plan to one jitted callable (prepared-statement
    #: hot path); False = eager op-by-op execution
    compile_plan: bool = True

    # -- batch-execution knobs (tuning, not identity: two policies that
    # differ only here compare equal and share plan/executable caches; the
    # knobs shape how `execute_many` buckets work and how the serving
    # scheduler coalesces, not what the compiled plan computes) -------------
    #: largest single device batch `execute_many` will dispatch; larger
    #: request lists split into chunks of at most this size
    max_batch: int = dataclasses.field(default=1024, compare=False)
    #: how long the coalescing scheduler holds a partial microbatch open
    #: waiting for more same-statement arrivals (seconds)
    coalesce_window_s: float = dataclasses.field(default=0.002, compare=False)
    #: whether `execute_async` may defer device sync to result access;
    #: False degrades it to eager synchronous execution (still correct)
    allow_async: bool = dataclasses.field(default=True, compare=False)
    #: bound on dispatched-but-unsynced `execute_async` calls per session;
    #: at the bound a new dispatch first blocks on the oldest in-flight one
    #: (backpressure — a runaway producer cannot queue unbounded device work)
    max_inflight: int = dataclasses.field(default=64, compare=False)

    # -- multi-statement fusion knobs (tuning like the batch/shard knobs:
    # never part of plan/executable identity — the fused-executable cache
    # tier keys on the member set separately, so policies that differ only
    # here still share plans and per-statement executables) ----------------
    #: allow this statement to be coalesced with *other* statements into one
    #: fused device program (shared scans, tagged outputs); False always
    #: takes the per-statement path
    fuse: bool = dataclasses.field(default=True, compare=False)
    #: most distinct statements one fused program may carry; larger mixed
    #: queues split into multiple fused programs (singleton remainders fall
    #: back to the per-statement path)
    max_fused_statements: int = dataclasses.field(default=8, compare=False)

    # -- cost-routing knob (tuning like the rest: never part of plan or
    # executable identity — the router may *re-prepare* a statement under a
    # differently-fingerprinted policy, but a routed and an unrouted FROID
    # statement share every cache tier) ------------------------------------
    #: let the session's CostRouter steer this statement: FROID/HEKATON
    #: choice per statement, batch-bucket riding, fuse-or-not per drain
    #: wave.  Decisions are visible in ``Session.cost_stats``; results are
    #: guaranteed unchanged (``check_routing_oracle``)
    route: bool = dataclasses.field(default=False, compare=False)

    # -- persistence knob (tuning like the rest: never part of plan or
    # executable identity — the persistent tier keys on the same identity
    # tuples the in-memory tiers use, so opting out only skips the store
    # round-trip, never changes what executes) -----------------------------
    #: let this statement use the session's persistent plan store (when one
    #: is attached): executables load from / save to disk across processes.
    #: False pins the statement to in-process caches only
    persist: bool = dataclasses.field(default=True, compare=False)

    def __post_init__(self):
        if self.udf_mode not in ("python", "scan"):
            raise ValueError(f"udf_mode must be python|scan, got {self.udf_mode!r}")
        if self.compile_plan and not self.inline_udfs and self.udf_mode == "python":
            raise ValueError(
                "python-mode UDF interpretation drives control flow on the "
                "host and cannot live inside a compiled plan; use "
                "udf_mode='scan' or compile_plan=False"
            )

    def fingerprint(self) -> tuple:
        """Hashable identity for plan/executable cache keys (name excluded).

        Cached on the (frozen) instance: the router compares fingerprints
        on every routed call, and rebuilding the tuple each time showed up
        in the cache-resident overhead budget."""
        fp = self.__dict__.get("_fp")
        if fp is None:
            fp = (
                self.inline_udfs, self.udf_mode, self.optimize,
                self.jit_statements, self.pallas_agg, self.compile_plan,
            )
            object.__setattr__(self, "_fp", fp)
        return fp

    def eager(self) -> "ExecutionPolicy":
        """The same policy with whole-plan compilation off."""
        if not self.compile_plan:
            return self
        return dataclasses.replace(self, name=self.name, compile_plan=False)

    def batched(self, max_batch: int | None = None,
                coalesce_window_s: float | None = None,
                allow_async: bool | None = None,
                max_inflight: int | None = None) -> "ExecutionPolicy":
        """The same policy with different batch-execution knobs."""
        return dataclasses.replace(
            self,
            name=self.name,
            max_batch=self.max_batch if max_batch is None else max_batch,
            coalesce_window_s=(self.coalesce_window_s
                               if coalesce_window_s is None
                               else coalesce_window_s),
            allow_async=self.allow_async if allow_async is None else allow_async,
            max_inflight=(self.max_inflight if max_inflight is None
                          else max_inflight),
        )

    def fused(self, fuse: bool | None = None,
              max_fused_statements: int | None = None) -> "ExecutionPolicy":
        """The same policy with different multi-statement fusion knobs."""
        return dataclasses.replace(
            self,
            name=self.name,
            fuse=self.fuse if fuse is None else fuse,
            max_fused_statements=(self.max_fused_statements
                                  if max_fused_statements is None
                                  else max_fused_statements),
        )

    def routed(self, route: bool = True) -> "ExecutionPolicy":
        """The same policy with cost-based routing toggled."""
        if route == self.route:
            return self
        return dataclasses.replace(self, name=self.name, route=route)

    def persisted(self, persist: bool = True) -> "ExecutionPolicy":
        """The same policy with the persistent plan tier toggled."""
        if persist == self.persist:
            return self
        return dataclasses.replace(self, name=self.name, persist=persist)

    @classmethod
    def from_kwargs(
        cls,
        froid: bool = True,
        mode: str = "python",
        optimize: bool = True,
        jit_statements: bool = True,
        pallas_agg: bool = False,
        compiled: bool = False,
    ) -> "ExecutionPolicy":
        """Map the legacy ``Database.run``/``run_compiled`` kwargs onto a
        policy (the deprecation path for the boolean-kwarg API)."""
        return cls(
            name="legacy",
            inline_udfs=froid,
            udf_mode=mode,
            optimize=optimize,
            jit_statements=jit_statements,
            pallas_agg=pallas_agg,
            compile_plan=compiled,
        )


#: paper Table 5 presets
FROID = ExecutionPolicy(name="froid")
INTERPRETED = ExecutionPolicy(
    name="interpreted", inline_udfs=False, udf_mode="python", compile_plan=False,
    # eager host-driven control flow: no device program to batch or overlap,
    # so execute_many degrades to a serial loop and async to sync
    max_batch=64, allow_async=False,
)
HEKATON = ExecutionPolicy(name="hekaton", inline_udfs=False, udf_mode="scan")
#: FROID knobs + cost-based routing: the session's CostRouter may move the
#: statement to a cheaper configuration (measured + estimated costs) without
#: changing results
ROUTED = dataclasses.replace(FROID, name="routed", route=True)

PRESETS = {p.name: p for p in (FROID, INTERPRETED, HEKATON, ROUTED)}


def resolve_policy(policy) -> ExecutionPolicy:
    """Accept an ExecutionPolicy or a preset name."""
    if isinstance(policy, ExecutionPolicy):
        return policy
    if isinstance(policy, str):
        try:
            return PRESETS[policy.lower()]
        except KeyError:
            raise KeyError(
                f"unknown policy preset {policy!r}; have {sorted(PRESETS)}"
            ) from None
    raise TypeError(f"policy must be ExecutionPolicy or str, got {type(policy)}")
