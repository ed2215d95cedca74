"""Port of ``src/repro/cost/router.py``: a copy (host only, no device
work) over the port's policy and :mod:`repro_torch.cost.model` (the H100's
peaks).  A sharded configuration's keys carry the policy's shard token in
the reference's position, and its estimates spread a bucket over the
mesh's data-axis devices.

Online cost router: measured wave costs + static estimates → the
cheapest configuration per statement and per drain wave.

One :class:`CostRouter` attaches lazily to a :class:`~repro_torch.core.
session.Session` (``Session._ensure_router``; statements opt in with
``policy.routed`` / the ``ROUTED`` preset).  It learns from the stats
seams the engine already has:

* ``execute_many`` chunk finalization → per-wave ``many`` samples keyed
  by (statement, policy, signature, shard layout, bucket);
* serial compiled ``execute`` → ``serial`` samples per statement;
* fused drains → ``fused`` samples keyed by the wave's canonical member
  statement set (plus the wave's CSE meta: bindings, ticket refs).

Samples taken while the resilience ladder is degrading a wave or a
breaker is open are **excluded** (:meth:`CostRouter.suppress` — the
ladder wraps retries/demoted tiers in it), so faults never poison the
model; ``stats['samples_excluded']`` counts what was dropped.

Routing axes (each decision is appended to a bounded log and surfaced via
``Session.cost_stats``):

* **policy** (:meth:`choose_policy`) — FROID vs HEKATON identity for a
  routed statement.  Measured costs win when both candidates have been
  observed on the same kind of path; otherwise the static estimates
  decide, and an unmeasured alternative is only *explored* when its
  estimate beats the incumbent's by a clear margin (exploring a
  same-or-worse-estimate alternative would pay a compile for nothing).
* **bucket** (:meth:`choose_bucket`) — ride an already-measured larger
  batch bucket instead of cold-compiling the natural power-of-two one,
  whenever the measured wave cost of the warm bucket undercuts the
  estimated compile + run cost of the cold one.
* **fuse** (:meth:`choose_fuse`) — fused wave vs per-statement drains.
  Both arms are explored once (fused first — the engine's static
  default), then the measured per-wave totals decide.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
from collections import deque

from repro_torch.core.policy import ExecutionPolicy
from repro_torch.cost.model import (
    estimate_compile_s,
    estimate_plan,
    estimate_statement_s,
)

#: EMA smoothing for measured per-wave costs
EMA_ALPHA = 0.4

#: explore an unmeasured policy alternative only when its static estimate
#: beats the incumbent's by at least this factor (strictly below 1.0:
#: an equal-estimate alternative never justifies a fresh compile)
EXPLORE_MARGIN = 0.9

#: once both fuse arms are measured, flip away from the incumbent only
#: when the alternative is at least this much cheaper — near-tie arms
#: would otherwise flip-flop on measurement noise every wave
FUSE_MARGIN = 0.9

#: bounded decision log length
DECISION_LOG = 256


def _digest(obj) -> str:
    """Stable short digest of a structural key (fingerprints are large
    nested tuples; ``cost_stats`` readers want something printable)."""
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:10]


def _fused_key(member_fps) -> tuple:
    """Canonical measured-config key for a fused wave: the *distinct*
    member statement fingerprints, sorted.  Deduped because the observe
    seam sees one fp per (statement, signature) member while the routing
    seam sees one per statement — the same wave must hit the same key."""
    return ("fused", tuple(sorted(set(member_fps), key=repr)))


@dataclasses.dataclass
class _Ema:
    """One measured-configuration record: EMA of per-wave seconds."""

    wave_s: float
    n: int = 1
    last_s: float = 0.0

    def update(self, s: float) -> None:
        self.wave_s = EMA_ALPHA * s + (1.0 - EMA_ALPHA) * self.wave_s
        self.n += 1
        self.last_s = s


class CostRouter:
    """See module docstring.  All state is host-side and per-session."""

    def __init__(self, session):
        self.session = session
        #: measured-config EMAs: key -> _Ema.  Keys:
        #:   ("many", query_fp, pol_fp, sig, shard_token, bucket)
        #:   ("serial", query_fp, pol_fp)
        #:   ("fused", member_fps_sorted)
        self.measured: dict[tuple, _Ema] = {}
        #: coarse per-ticket EMAs for cross-configuration comparisons:
        #:   (kind, query_fp, pol_fp) -> _Ema of seconds *per ticket*
        self.per_ticket: dict[tuple, _Ema] = {}
        self.estimates: dict[tuple, float] = {}  # estimate memo
        #: warm-bucket index for :meth:`choose_bucket`: the "many" keys of
        #: ``measured`` grouped by prefix -> {bucket: shared _Ema}, so the
        #: per-chunk lookup is one dict get instead of a full-table scan
        self._warm_many: dict[tuple, dict[int, _Ema]] = {}
        #: policy-candidate memo: id(base policy) -> (base, [(cand, fp)])
        self._cand_memo: dict[int, tuple] = {}
        #: estimate-verdict memo: (query_fp, base_fp, catalog_token) ->
        #: chosen policy (estimates are static per catalog version)
        self._verdicts: dict[tuple, ExecutionPolicy] = {}
        #: last measured fuse verdict per fused key (hysteresis state)
        self._fuse_last: dict[tuple, bool] = {}
        #: bumped when a *new* coarse per-ticket key appears — the only
        #: evidence event that can change a not-yet-measured-both policy
        #: verdict, so it (plus the catalog token) validates the fast path
        self._pt_new = 0
        #: steady-state verdict fast path: id(stmt) -> (stmt, chosen,
        #: pt_new, catalog_token); skipped for value-dependent verdicts
        #: (both candidates measured — EMA updates may flip those)
        self._policy_fast: dict[int, tuple] = {}
        self.decisions: deque = deque(maxlen=DECISION_LOG)
        self.stats = {
            "samples": 0, "samples_excluded": 0, "decisions": 0,
            "policy_reroutes": 0, "bucket_rides": 0,
            "waves_fused": 0, "waves_unfused": 0,
        }
        self._suppress_depth = 0

    # -- fault-window exclusion ---------------------------------------------
    @contextlib.contextmanager
    def suppress(self):
        """Samples observed inside this context are counted but dropped —
        the resilience ladder wraps retries, demoted tiers and
        breaker-open windows in it so fault-time costs never train the
        model.  Re-entrant."""
        self._suppress_depth += 1
        try:
            yield self
        finally:
            self._suppress_depth -= 1

    @property
    def suppressed(self) -> bool:
        return self._suppress_depth > 0

    # -- sample intake -------------------------------------------------------
    def _observe(self, key: tuple, wave_s: float, *, coarse: tuple | None,
                 tickets: int) -> None:
        if self.suppressed:
            self.stats["samples_excluded"] += 1
            return
        self.stats["samples"] += 1
        ent = self.measured.get(key)
        if ent is None:
            ent = self.measured[key] = _Ema(wave_s, last_s=wave_s)
            if key[0] == "many":
                self._warm_many.setdefault(key[:-1], {})[key[-1]] = ent
        else:
            ent.update(wave_s)
        if coarse is not None and tickets > 0:
            per = wave_s / tickets
            c = self.per_ticket.get(coarse)
            if c is None:
                self.per_ticket[coarse] = _Ema(per, last_s=per)
                self._pt_new += 1
            else:
                c.update(per)

    def observe_many(self, query_fp, policy: ExecutionPolicy, sig, bucket: int,
                     wave_s: float, tickets: int, *, shard: bool) -> None:
        pol_fp = policy.fingerprint()
        shard_token = policy.shard_token() if shard else ()
        self._observe(
            ("many", query_fp, pol_fp, sig, shard_token, bucket), wave_s,
            coarse=("many", query_fp, pol_fp), tickets=tickets,
        )

    def observe_serial(self, query_fp, policy: ExecutionPolicy,
                       wave_s: float) -> None:
        pol_fp = policy.fingerprint()
        self._observe(("serial", query_fp, pol_fp), wave_s,
                      coarse=("serial", query_fp, pol_fp), tickets=1)

    def observe_fused(self, member_fps, wave_s: float, tickets: int,
                      meta: dict | None = None) -> None:
        key = _fused_key(member_fps)
        self._observe(key, wave_s, coarse=None, tickets=tickets)
        if meta and not self.suppressed:
            self.measured[key].meta = dict(meta)  # type: ignore[attr-defined]

    # -- static estimates ----------------------------------------------------
    def _plan_for(self, stmt, policy: ExecutionPolicy):
        return self.session._cached_plan(stmt.node, stmt._query_fp, policy)[0]

    def estimate_policy_s(self, stmt, policy: ExecutionPolicy) -> float:
        """Memoized per-call estimate of ``stmt`` under ``policy`` (each
        candidate is estimated on its *own* bound plan — inlining changes
        the tree, which is the whole point of the comparison)."""
        key = ("policy", stmt._query_fp, policy.fingerprint(),
               self.session._catalog_token())
        est = self.estimates.get(key)
        if est is None:
            plan = self._plan_for(stmt, policy)
            est = estimate_plan(plan, self.session.catalog).seconds()
            self.estimates[key] = est
        return est

    # -- decision log --------------------------------------------------------
    def _decide(self, axis: str, choice, why: str, **detail) -> None:
        self.stats["decisions"] += 1
        self.decisions.append({"axis": axis, "choice": choice, "why": why,
                               **detail})

    # -- axis: FROID vs HEKATON policy --------------------------------------
    def _policy_candidates(self, stmt) -> list[tuple]:
        """``[(candidate_policy, fingerprint), ...]`` for ``stmt``, memoized
        per base-policy *instance* (policies are frozen; id is pinned by
        keeping the base in the memo value, so reuse cannot alias)."""
        base = stmt.policy
        hit = self._cand_memo.get(id(base))
        if hit is not None and hit[0] is base:
            return hit[1]
        froid_like = dataclasses.replace(
            base, name=f"{base.name}[froid]", inline_udfs=True,
            udf_mode="python")
        hek_like = dataclasses.replace(
            base, name=f"{base.name}[hekaton]", inline_udfs=False,
            udf_mode="scan")
        out, seen = [], set()
        for c in (base, froid_like, hek_like):
            fp = c.fingerprint()
            if fp not in seen:
                seen.add(fp)
                out.append((c, fp))
        self._cand_memo[id(base)] = (base, out)
        return out

    def choose_policy(self, stmt) -> ExecutionPolicy:
        """The execution policy ``stmt`` should run under right now."""
        base = stmt.policy
        if not base.compile_plan:
            return base
        cat = self.session._catalog_token()
        hit = self._policy_fast.get(id(stmt))
        if (hit is not None and hit[0] is stmt and hit[2] == self._pt_new
                and hit[3] == cat):
            return hit[1]
        chosen, value_dependent = self._choose_policy_slow(stmt, base, cat)
        if not value_dependent:
            self._policy_fast[id(stmt)] = (stmt, chosen, self._pt_new, cat)
        return chosen

    def _choose_policy_slow(self, stmt, base, cat) -> tuple:
        """``(chosen, value_dependent)``; value-dependent verdicts (both
        candidates measured) must be re-evaluated every call because EMA
        updates can flip them."""
        cands = self._policy_candidates(stmt)
        if len(cands) == 1:
            return base, False
        fp0 = stmt._query_fp
        base_fp = base.fingerprint()

        def measured_per_ticket(pol_fp):
            for kind in ("many", "serial"):
                e = self.per_ticket.get((kind, fp0, pol_fp))
                if e is not None:
                    return kind, e.wave_s
            return None, None

        ms = [measured_per_ticket(fp) for _, fp in cands]
        kinds = {k for k, _ in ms if k is not None}
        for kind in ("many", "serial"):
            if kind in kinds and all(
                    k == kind for k, _ in ms if k is not None):
                both = [(c, fp, v) for (c, fp), (k, v) in zip(cands, ms)
                        if k == kind]
                if len(both) >= 2:
                    # measured evidence on a comparable path wins outright
                    best, best_fp, _ = min(both, key=lambda cfv: cfv[2])
                    if best_fp != base_fp:
                        self.stats["policy_reroutes"] += 1
                        self._decide("policy", best.name, "measured",
                                     stmt=_digest(fp0), kind=kind)
                    return best, True
                break
        # estimates decide; an unmeasured alternative is explored only on
        # a clear estimated win (compiles are not free).  The verdict is
        # memoized — estimates are static per catalog version, so the
        # cache-resident path pays the comparison once, not per call.
        vkey = (fp0, base_fp, cat)
        verdict = self._verdicts.get(vkey)
        if verdict is not None:
            return verdict, False
        ests = [(c, fp, self.estimate_policy_s(stmt, c))
                for c, fp in cands]
        inc_est = next(e for _, fp, e in ests if fp == base_fp)
        best, best_fp, best_est = min(ests, key=lambda cfe: cfe[2])
        chosen = base
        if best_fp != base_fp and best_est < inc_est * EXPLORE_MARGIN:
            self.stats["policy_reroutes"] += 1
            self._decide("policy", best.name, "estimate", stmt=_digest(fp0),
                         est_s=best_est, incumbent_s=inc_est)
            chosen = best
        self._verdicts[vkey] = chosen
        return chosen, False

    # -- axis: batch bucket --------------------------------------------------
    def choose_bucket(self, stmt, sig, k: int, natural: int, cap: int,
                      *, shard: bool) -> int:
        """Bucket for ``k`` same-signature tickets: the natural power-of-
        two bucket, or a larger already-measured one when riding it is
        estimated cheaper than cold-compiling the natural bucket."""
        pol = stmt.policy
        pol_fp = pol.fingerprint()
        shard_token = pol.shard_token() if shard else ()
        prefix = ("many", stmt._query_fp, pol_fp, sig, shard_token)
        warm = self._warm_many.get(prefix)
        if not warm or natural in warm:
            return natural
        rides = {b: e for b, e in warm.items() if natural < b <= cap}
        if not rides:
            return natural
        plan = self._plan_for(stmt, pol)
        devices = pol.shard_devices() if shard else 1
        cold_s = (estimate_compile_s(plan)
                  + estimate_statement_s(plan, self.session.catalog,
                                         bucket=natural, devices=devices))
        ride_bucket, ride_ema = min(rides.items(),
                                    key=lambda be: be[1].wave_s)
        if ride_ema.wave_s < cold_s:
            self.stats["bucket_rides"] += 1
            self._decide("bucket", ride_bucket, "ride-warm",
                         stmt=_digest(stmt._query_fp), natural=natural,
                         warm_wave_s=ride_ema.wave_s, cold_est_s=cold_s)
            return ride_bucket
        return natural

    # -- axis: fuse or not ---------------------------------------------------
    def choose_fuse(self, wave) -> bool:
        """``wave`` is ``[(stmt, n_tickets), ...]`` for one mixed drain.
        Returns whether to run it as one fused program.  Exploration:
        fused first (the static default), per-statement once the fused arm
        is measured but the unfused arm is not; after both, cheaper wins."""
        fused_key = _fused_key(s._query_fp for s, _ in wave)
        fused = self.measured.get(fused_key)
        if fused is None:
            self._decide("fuse", True, "explore-fused",
                         wave=_digest(fused_key[1]))
            self.stats["waves_fused"] += 1
            return True
        unfused_s, have_all = 0.0, True
        for stmt, n in wave:
            # parameter-free members run the serial path inside an unfused
            # drain, so their per-ticket evidence lands under "serial"
            e = next((self.per_ticket[k] for k in (
                ("many", stmt._query_fp, stmt.policy.fingerprint()),
                ("serial", stmt._query_fp, stmt.policy.fingerprint()),
            ) if k in self.per_ticket), None)
            if e is None:
                have_all = False
                break
            unfused_s += e.wave_s * n
        if not have_all:
            self._decide("fuse", False, "explore-unfused",
                         wave=_digest(fused_key[1]))
            self.stats["waves_unfused"] += 1
            return False
        prev = self._fuse_last.get(fused_key)
        if prev is None:
            take_fused = fused.wave_s <= unfused_s
        elif prev:
            # sticky: leave the fused incumbent only on a clear unfused win
            take_fused = not (unfused_s < fused.wave_s * FUSE_MARGIN)
        else:
            take_fused = fused.wave_s < unfused_s * FUSE_MARGIN
        self._fuse_last[fused_key] = take_fused
        self._decide("fuse", take_fused, "measured",
                     wave=_digest(fused_key[1]), fused_s=fused.wave_s,
                     unfused_s=unfused_s)
        self.stats["waves_fused" if take_fused else "waves_unfused"] += 1
        return take_fused

    # -- persistence ---------------------------------------------------------
    def export_state(self) -> dict:
        """JSON-safe snapshot of the measured cost model for the persistent
        tier (``repro_torch/persist/costs.py``).  Fault-window samples were
        already excluded at intake — :meth:`suppress` drops them before
        they can reach ``measured``/``per_ticket`` — so a save can never
        leak degraded-wave costs into a fresh worker's warm start."""

        def rows(table):
            out = []
            for key, ema in table.items():
                meta = getattr(ema, "meta", None)
                if meta is not None:
                    try:
                        json.dumps(meta)
                    except (TypeError, ValueError):
                        meta = None
                out.append([repr(key), ema.wave_s, ema.n, ema.last_s, meta])
            return out

        return {"measured": rows(self.measured),
                "per_ticket": rows(self.per_ticket)}

    def import_state(self, state: dict, *, replace: bool = False) -> int:
        """Warm-start the measured model from :meth:`export_state` output.

        Locally-observed evidence wins over imported records unless
        ``replace`` (a live EMA reflects *this* process's actual costs).
        Returns the number of records adopted.  Malformed rows are skipped
        — a cost table can only ever steer routing, never break results.
        """
        from repro_torch.persist.keys import parse_key

        adopted = 0
        for attr in ("measured", "per_ticket"):
            table = getattr(self, attr)
            for row in state.get(attr, ()):
                try:
                    key = parse_key(row[0])
                    wave_s, n, last_s = float(row[1]), int(row[2]), float(row[3])
                except (ValueError, SyntaxError, TypeError, IndexError):
                    continue
                if not replace and key in table:
                    continue
                ema = _Ema(wave_s, n=n, last_s=last_s)
                meta = row[4] if len(row) > 4 else None
                if meta and attr == "measured":
                    ema.meta = dict(meta)  # type: ignore[attr-defined]
                table[key] = ema
                adopted += 1
                if attr == "measured" and key and key[0] == "many":
                    self._warm_many.setdefault(key[:-1], {})[key[-1]] = ema
                elif attr == "per_ticket":
                    # imported coarse evidence can change a policy verdict,
                    # exactly like a freshly-observed key would
                    self._pt_new += 1
        return adopted

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        """``Session.cost_stats`` payload: counters, measured configs (keys
        digested for printability), and the recent decision log."""
        measured = {}
        for key, ema in self.measured.items():
            kind = key[0]
            label = f"{kind}:{_digest(key[1])}"
            if kind == "many":
                label += f":b{key[-1]}" + (":sharded" if key[4] else "")
            rec = {"wave_s": ema.wave_s, "last_s": ema.last_s, "n": ema.n}
            meta = getattr(ema, "meta", None)
            if meta:
                rec["meta"] = meta
            measured[label] = rec
        return {
            "enabled": True,
            **self.stats,  # "decisions" stays the cumulative counter
            "measured": measured,
            "decision_log": list(self.decisions),
        }


__all__ = ["CostRouter", "EMA_ALPHA", "EXPLORE_MARGIN"]
