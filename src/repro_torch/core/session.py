"""Port of ``src/repro/core/session.py:1-2106``: Session /
PreparedStatement, the engine's prepare-once-execute-many API, with its
batched and async paths.

* :class:`Session` owns the catalog (on its device) + UDF registry and its
  caches — a **plan cache** (bound + optimized plans, keyed by query
  fingerprint x policy x catalog/registry state), an **executable cache**
  (the plan's ``raw`` closure, additionally keyed by the parameter
  signature) and a **batch cache** (``torch.func.vmap`` of ``raw`` over
  the parameter axis, additionally keyed by the batch bucket), with the
  reference's cache keys.
* :class:`PreparedStatement` is the client handle: ``prepare`` plans and
  binds (cold); ``execute(params=…)`` runs warm off the cached executable.
  Where the reference jit-compiles ``raw``, the port runs it eagerly on the
  device: PyTorch needs no trace, and the plan's operators queue without a
  host sync until the one ``torch.cuda.synchronize`` at the end.
  ``execute_many`` stacks N same-signature parameter sets into one
  vmapped program (``jax.vmap(raw, in_axes=(None, 0))`` in the reference),
  chunked at ``policy.max_batch`` and pipelined; ``execute_async``
  dispatches and returns an :class:`AsyncResult` whose marker is a
  ``torch.cuda.Event`` recorded after the dispatch.
* A policy carrying a mesh (``policy.sharded(mesh)``,
  :mod:`repro_torch.launch.mesh`) shards the stacked parameter axis of
  ``execute_many`` and of a fused wave over the mesh's data axes: each
  block runs the same vmapped plan on its position's device, against a
  catalog replica kept there, on that device's current stream, and the
  host waits on one event per device (the **shard cache**, keyed as the
  reference's).
* ``execute_fused`` runs a mixed queue of *different* prepared statements
  as one fused wave (:mod:`repro_torch.fuse`): the subtrees they share run
  once, each member's plan is one ``torch.func.vmap`` over its tickets,
  and the host waits on one event for the whole wave.
* :class:`QueryResult` reports rows lazily plus the plan, explain text,
  engine stats and whether the call was served from cache.

Entry points run on the card: ``Session(device=None)`` means ``"cuda"`` and
raises where CUDA is absent; only an explicit ``device="cpu"`` runs on the
host.  A plan that still holds a ``UdfCall`` (INTERPRETED, HEKATON, or
FROID past its inlining budget) runs it on the per-row interpreter: the
compiled path with a ``scan``-mode hook, the eager path with the policy's
``udf_mode``.  ``Session._fault`` is the reference's fault-injection seam
at its compile, dispatch, sync and interp sites.  A ``ROUTED`` statement
(``policy.route``) attaches the session's cost router
(:mod:`repro_torch.cost.router`), which picks its policy, its batch
bucket and, through the scheduler, fuse-or-not from wave times sampled
here (host clock around work already waited on).

``Session(store=...)`` attaches the persistent plan tier
(:mod:`repro_torch.persist`): an executable-tier miss looks its key up in
the store before building, and a built executable writes its entry behind
its first run (when the run has filled its output dictionaries and
stats).  The keys are the reference's, content-derived
(:meth:`Session._content_env_token`); the blob is the optimized plan,
pickled, and a hit runs the loaded plan.  Every store failure degrades to
a rebuild, as in the reference.  The cost router warm-starts from the
store (``_load_costs``) and ``save_costs`` writes its measured tables.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import time
import warnings
from collections import OrderedDict, deque
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
from repro_torch.core.interpreter import Interpreter
from repro_torch.core.ir import UdfDef
from repro_torch.core.policy import FROID, ExecutionPolicy, resolve_policy
from repro_torch.tables.table import (Column, DictEncoding, Table, catalog_from_numpy,
                                      resolve_device)

# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


class QueryResult:
    """Result of one execution.  ``table`` (compacted host-visible rows)
    materializes lazily; ``masked`` is the device form.

    Batched and async executions defer even the masked form: they pass
    ``materialize`` instead of ``masked``, and the first ``masked`` access
    slices this call's rows out of the shared device batch (or waits for
    the in-flight dispatch).

    ``stats`` holds the reference's counters and, where the per-row
    interpreter ran, the port's ``udf_rows``: the rows it was driven over
    for this execution.  On a batched result that is the rows each
    invocation drives (the vmapped row loop runs once for the whole
    batch), not the batch size times them."""

    def __init__(self, masked: MaskedTable | None, plan: R.RelNode,
                 elapsed_s: float, stats: dict,
                 policy: ExecutionPolicy | None = None,
                 cache_hit: bool = False, materialize=None):
        if masked is None and materialize is None:
            raise ValueError("QueryResult needs masked or materialize")
        self._masked = masked
        self._materialize = materialize
        self.plan = plan
        self.elapsed_s = elapsed_s
        self.stats = stats
        self.policy = policy
        self.cache_hit = cache_hit
        self._table: Table | None = None

    @property
    def masked(self) -> MaskedTable:
        if self._masked is None:
            self._masked = self._materialize()
            self._materialize = None
        return self._masked

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


class AsyncResult:
    """Future returned by :meth:`PreparedStatement.execute_async`.

    The device work is already queued; ``result()`` waits for it and
    returns the :class:`QueryResult`.  The marker is a ``torch.cuda.Event``
    recorded on the current stream right after the dispatch: ``done()``
    polls it (``Event.query``) and ``result()`` waits on it alone, never on
    the whole device.  A CPU session has no marker, and its results are
    done when returned.

    A truly async result occupies one of the session's bounded in-flight
    slots (``policy.max_inflight``) until ``result()`` releases it.
    Degraded (synchronous) results never hold a slot.
    """

    def __init__(self, result: QueryResult, marker=None, session=None):
        self._result = result
        self._marker = marker  # torch.cuda.Event | None
        self._session = session
        self._released = session is None

    def done(self) -> bool:
        m = self._marker
        if m is None:
            return True
        return m.query()

    def _release(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            self._session._inflight.remove(self)
        except ValueError:
            pass  # already reaped by a later dispatch's admission pass

    def result(self) -> QueryResult:
        _ = self._result.masked  # waits for the marker + materializes
        self._release()
        return self._result

    def __repr__(self):
        return f"AsyncResult(done={self.done()})"


#: backward-compatible alias — the old Database.run result type
RunResult = QueryResult


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


def _table_content_digest(t: Table) -> str:
    """Value digest of one table: per-column name/dtype/shape/vocab plus the
    raw data and validity bytes.  Cached on the table object — the same
    invalidation model as :func:`_stamp` (replace the Table, get a fresh
    digest), but the digest is *content-derived*, so two processes loading
    identical data agree on it, and it hashes the reference's bytes in the
    reference's order: equal data gives the reference's digest.  A column
    on the card is copied to the host once, here."""
    d = getattr(t, "_content_digest", None)
    if d is None:
        h = hashlib.sha1()
        for name, col in sorted(t.columns.items()):
            arr = col.data.cpu().numpy()
            h.update(repr((name, str(arr.dtype), arr.shape,
                           _vocab(col.dictionary))).encode())
            h.update(arr.tobytes())
            valid = (np.ones(arr.shape, bool) if col.valid is None
                     else col.valid.cpu().numpy())
            h.update(valid.tobytes())
        d = h.hexdigest()
        t._content_digest = d
    return d


def _udf_content_digest(u: UdfDef) -> str:
    """Structural digest of a UDF definition (via :func:`_norm`), cached on
    the object; the registry half of the content-derived env token."""
    d = getattr(u, "_content_digest", None)
    if d is None:
        d = hashlib.sha1(repr(_norm(u)).encode()).hexdigest()
        try:
            u._content_digest = d
        except AttributeError:
            object.__setattr__(u, "_content_digest", d)
    return d


def _save_after_first_run(run, save):
    """``run``, calling ``save()`` once, behind its first successful call:
    the port's executables fill their output dictionaries and stats when
    they first run (the reference's, at trace), and an entry saved before
    that would decode a warm hit's string columns without them."""
    pending = [save]

    def first_run_saves(*args):
        out = run(*args)
        if pending:
            pending.pop()()
        return out

    return first_run_saves


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
    # every copy is queued non-blocking (S.host_tensor): a dispatch never
    # waits for the device
    if isinstance(v, str):
        return S.Value(S.host_tensor(0, torch.int32, device), None,
                       DictEncoding([v]))
    if isinstance(v, bool):
        return S.Value(S.host_tensor(v, torch.bool, device))
    if isinstance(v, (int, np.integer)):
        return S.Value(S.host_tensor(int(v), torch.int32, device))
    if isinstance(v, (float, np.floating)):
        return S.Value(S.host_tensor(float(v), torch.float32, device))
    arr = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    arr = arr.to(device=device, dtype=_ARRAY_CASTS.get(arr.dtype, arr.dtype),
                 non_blocking=True)
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


def batch_bucket(n: int, max_batch: int) -> int:
    """Device batch size for ``n`` same-signature param sets: the next
    power of two, capped at ``max_batch``.  Bucketing means a statement
    executed at N = 5, 6, 7 … shares one vmapped executable (padded to 8)
    instead of one per distinct N."""
    if n <= 0:
        raise ValueError("batch of zero parameter sets")
    b = 1
    while b < n:
        b <<= 1
    return max(1, min(b, max_batch))


def _stack_params(params_list: list[dict], device) -> dict:
    """Stack same-signature param dicts into one batched argument
    structure: name -> (data (B, …), valid (B, …)).  A scalar parameter is
    one numpy array at the reference's dtype, copied to ``device`` once
    and non-blocking (not B device scalars)."""
    first = params_list[0]
    out = {}
    for name in sorted(first):
        vs = [p[name] for p in params_list]
        v0 = vs[0]
        if isinstance(v0, bool):
            data = S.host_tensor(np.asarray(vs, dtype=bool), torch.bool, device)
        elif isinstance(v0, (int, np.integer)):
            data = S.host_tensor(np.asarray(vs), torch.int32, device)
        elif isinstance(v0, (float, np.floating)):
            data = S.host_tensor(np.asarray(vs), torch.float32, device)
        else:
            vals = [_param_value(v, device) for v in vs]
            out[name] = (
                torch.stack([v.data for v in vals]),
                torch.stack([v.validity() for v in vals]),
            )
            continue
        out[name] = (data, torch.ones((len(vs),), dtype=torch.bool, device=device))
    return out


def _on_device(device):
    """The context a shard's work runs in: its card current (so its
    operators queue on that device's current stream); nothing on the
    host."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _row_of(parts: list, bucket: int, j: int) -> tuple:
    """``(part, row)`` of stacked row ``j`` of a bucket split into
    ``len(parts)`` contiguous blocks, one a shard position (one block on
    an unsharded path)."""
    b = bucket // len(parts)
    return parts[j // b], j % b


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


def _param_dictionary(v) -> DictEncoding | None:
    """The dictionary ``_param_value(v, device)`` would carry, without
    making a device tensor (host-side planning)."""
    if isinstance(v, S.Value):
        return v.dictionary
    if isinstance(v, str):
        return DictEncoding([v])
    return None


#: distinct-binding counts at or below this threshold keep exact template
#: pools; above it the pool pads to the next power of two.  Small pools
#: re-specialize rarely and padding them is pure waste; large growing
#: binding populations would otherwise re-specialize the fused program once
#: per distinct d — bucketing bounds that to O(log d).  Tests monkeypatch
#: this to measure both arms.
CSE_EXACT_D = 8


def _pool_pad(d: int) -> int:
    """Template-pool slot count for ``d`` distinct bindings: exact at or
    below :data:`CSE_EXACT_D`, the next power of two above it.  Padded
    slots repeat the last real binding and are computed-then-ignored,
    exactly like batch-bucket padding rows — no ticket's slot index ever
    references one."""
    if d <= CSE_EXACT_D:
        return d
    b = 1
    while b < d:
        b <<= 1
    return b


def _value_bytes(v: S.Value) -> bytes:
    """A Value's data bytes, then its validity's, read to the host in one
    copy."""
    data = v.data.contiguous()
    parts = [data.reshape(-1).view(torch.uint8)]
    if v.valid is not None:
        parts.append(torch.broadcast_to(v.valid, data.shape).reshape(-1)
                     .to(torch.uint8))
    return torch.cat(parts).cpu().numpy().tobytes()


def _binding_key(v) -> tuple:
    """Hashable identity of one parameter value — the dedup key of the
    template binding pools (value-level, unlike :func:`param_signature`
    which deliberately erases values for numeric params).  ``S.Value``
    bindings cost a device→host read, so their key is memoized on the
    instance — repeated tickets carrying the same Value object read it
    once, not once per ticket."""
    if isinstance(v, S.Value):
        cached = getattr(v, "_binding_key_cache", None)
        if cached is not None:
            return cached
        key = ("value", str(v.data.dtype), tuple(v.data.shape), _value_bytes(v),
               v.valid is not None, _vocab(v.dictionary))
        v._binding_key_cache = key
        return key
    if isinstance(v, str):
        return ("str", v)
    if isinstance(v, bool):
        return ("bool", v)
    if isinstance(v, (int, np.integer)):
        return ("int", int(v))
    if isinstance(v, (float, np.floating)):
        # bit-pattern identity at the executed precision: -0.0 must not
        # dedup against 0.0 (sign-sensitive templates would answer with
        # the wrong sign of infinity), and NaN must dedup against itself
        # (value equality would mint a fresh pool slot per NaN ticket)
        return ("float", np.float32(float(v)).tobytes())
    arr = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return ("array", str(arr.dtype), arr.shape, arr.tobytes())


def _maximal_cse_occurrences(merged, plan) -> list:
    """Template occurrences of ``plan`` that actually execute in a member's
    run: top-down, stopping at the first marked node (a shared-constant
    or template mark) — everything beneath it is answered from a pool and
    never runs, so nested occurrences must not open pool groups of their
    own.  Memoized on the (cached, immutable) FusedPlan per member plan —
    warm drains must not re-walk plans they have already planned."""
    cache = getattr(merged, "_occ_cache", None)
    if cache is None:
        cache = merged._occ_cache = {}
    # entries hold the plan itself, so a hit is identity-verified — an
    # id() recycled onto a different plan object can never match
    hit = cache.get(id(plan))
    if hit is not None and hit[0] is plan:
        return hit[1]
    out = []

    def visit(n):
        nid = n.node_id
        if nid in merged.template_ids:
            out.append(n)
            return
        if nid in merged.shared_ids:
            return  # answered from the constant pool; nothing below runs
        for p in R.embedded_plans(n):
            visit(p)
        for c in n.children():
            visit(c)

    visit(plan)
    cache[id(plan)] = (plan, out)
    return out


def _plan_template_groups(merged, members, params_by_member):
    """Host-side binding planning for a fused wave.

    For every maximal template occurrence of every member, group by
    (template fingerprint, binding signature) into a :class:`_PoolGroup`,
    dedup the tickets' hole-value tuples into the group's distinct-binding
    list, and record each ticket's pool slot.  Returns ``(groups,
    member_tmaps, slot_maps, slot_names, template_token)`` where
    ``member_tmaps[i]`` maps occurrence ``node_id -> group index`` for
    member ``i``, ``slot_maps[i]`` maps ``node_id -> [slot per ticket]``,
    ``slot_names[i]`` maps ``node_id -> reserved slot-parameter name``
    (the occurrence's *ordinal* within this walk — deterministic from the
    plan structure), and ``template_token`` — ``((fp, sig, pool_pad(d)),
    ...)`` in group order — is the template identity the fused cache key
    incorporates (members arrive canonically sorted, so the token is
    arrival-order independent; ``d`` is bucketed by :func:`_pool_pad` so a
    growing distinct-binding population re-specializes O(log d) times, not
    per distinct d)."""
    from repro_torch.fuse.merge import CONST_BIND, slot_param

    def hole_value(bind_h, pdict):
        """``(supplied, value)`` of one hole: const-bind markers carry the
        literal value; param binds look up the ticket's params."""
        if isinstance(bind_h, tuple) and bind_h[0] == CONST_BIND:
            return True, bind_h[1]
        if bind_h not in pdict:
            return False, None
        return True, pdict[bind_h]

    by_fp = {t.fp: t for t in merged.templates}
    groups: list[_PoolGroup] = []
    gindex: dict[tuple, int] = {}
    member_tmaps: list[dict] = []
    slot_maps: list[dict] = []
    slot_names: list[dict] = []
    for m, plist in zip(members, params_by_member):
        tmap: dict[int, int] = {}
        smap: dict[int, list] = {}
        names: dict[int, str] = {}
        # parameter-free members still pool occurrences whose holes are all
        # const-bound (lifted templates) — their slot rides as an unbatched
        # reserved parameter
        if plist:
            pdict0 = plist[0] or {}
            for n in _maximal_cse_occurrences(merged, m.plan):
                fp = merged.template_ids[n.node_id]
                bind = merged.template_binds[n.node_id]
                tmpl = by_fp[fp]
                # an occurrence whose actual parameters are not all
                # supplied cannot be pooled; the member run will raise
                # (or not reach it) exactly as the per-statement path would
                vals0 = {}
                for h in tmpl.holes:
                    ok, v = hole_value(bind[h], pdict0)
                    if not ok:
                        vals0 = None
                        break
                    vals0[h] = v
                if vals0 is None:
                    continue
                sig = param_signature(vals0)
                gk = (fp, sig)
                gi = gindex.get(gk)
                if gi is None:
                    gi = gindex[gk] = len(groups)
                    groups.append(_PoolGroup(
                        fp, sig, tmpl.node, tmpl.holes,
                        {h: _param_dictionary(vals0[h]) for h in tmpl.holes},
                        [], {},
                    ))
                g = groups[gi]
                slots = []
                for p in plist:
                    pd = p or {}
                    b = {h: hole_value(bind[h], pd)[1] for h in tmpl.holes}
                    key = tuple(_binding_key(b[h]) for h in tmpl.holes)
                    slot = g.index.get(key)
                    if slot is None:
                        slot = g.index[key] = len(g.bindings)
                        g.bindings.append(b)
                    slots.append(slot)
                tmap[n.node_id] = gi
                smap[n.node_id] = slots
                # canonical spelling: the ordinal among this member's
                # pooled occurrences
                names[n.node_id] = slot_param(len(names))
        member_tmaps.append(tmap)
        slot_maps.append(smap)
        slot_names.append(names)
    # the cache token carries the *padded* pool size: binding counts that
    # land in the same d-bucket share one fused specialization (the exact
    # count still rides per-wave as cse_bindings in the stats)
    token = tuple((g.fp, g.sig, _pool_pad(len(g.bindings))) for g in groups)
    return groups, member_tmaps, slot_maps, slot_names, token


# ---------------------------------------------------------------------------
# executables
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Executable:
    fn: Any  # (param_values, catalog_token) -> (mask, cols), see _executable
    plan: R.RelNode
    out_dicts: dict  # column name -> DictEncoding | None
    stats: dict  # logical reads of one execution
    interp: Interpreter | None = None  # the scan-mode hook, if the plan calls UDFs
    raw: Any = None  # (table_args, param_args) closure (the vmap source)
    raw_of: Any = None  # (plan, device) -> such a closure (a loaded plan, a shard)
    interps: dict | None = None  # device -> its scan-mode hook, if the plan calls UDFs


@dataclasses.dataclass
class _BatchedExecutable:
    fn: Any  # (batched_pargs, catalog_token) -> (mask (B, n), cols)
    plan: R.RelNode
    out_dicts: dict  # shared with the unbatched executable's capture
    stats: dict
    bucket: int
    interp: Interpreter | None = None  # shared with the unbatched executable


@dataclasses.dataclass
class _ShardedExecutable:
    fn: Any  # (batched_pargs, catalog_token) -> [(mask (B/n, n), cols)] a position
    plan: R.RelNode
    out_dicts: dict  # shared with the unbatched executable's capture
    stats: dict
    bucket: int
    positions: list  # the device of each block, in mesh order
    interp: Interpreter | None = None  # the session device's scan-mode hook
    interps: dict | None = None  # device -> scan-mode hook (rows counted over all)


@dataclasses.dataclass
class _FuseMember:
    """One member of a fused program: a (statement plan, parameter
    signature) pair stacked over its own batch bucket."""

    plan: R.RelNode
    sig: tuple
    bucket: int
    pdicts: dict  # param name -> DictEncoding | None (host metadata)
    key: tuple  # (query fingerprint, signature, bucket) — cache identity


@dataclasses.dataclass
class _FusedExecutable:
    fn: Any  # (pargs_tuple, targs_tuple, catalog_token) -> ((mask, cols), ...)
    plans: list  # member plans, fusion order
    out_dicts: list  # per-member {column -> DictEncoding | None} capture
    stats: dict  # the last run's scan stats + merge stats (shared_subtrees, cse_*, ...)
    members: list  # _FuseMember descriptors, fusion order
    merged: Any = None  # repro_torch.fuse.merge.FusedPlan (sharing maps + explain)
    eval_counts: dict | None = None  # pool key -> the last run's evaluations
    positions: list | None = None  # a sharded wave's device a position, else None


@dataclasses.dataclass
class _PoolGroup:
    """One template pool of a fused program: a parameter-unified shared
    subtree × one binding signature, evaluated once per distinct binding.
    Two members binding the same template with the same value *signature*
    land in the same group and share its distinct-binding pool — the
    cross-statement unification the CSE engine exists for."""

    fp: tuple  # canonical parametric fingerprint (template identity)
    sig: tuple  # binding signature (param_signature over hole values)
    node: R.RelNode  # canonical template subtree (holes as params)
    holes: tuple  # canonical hole parameter names, slot order
    hole_dicts: dict  # hole -> DictEncoding | None (host metadata)
    bindings: list  # [{hole: value}] distinct, slot order
    index: dict  # binding key -> slot

    def spec(self) -> "_PoolGroup":
        """Structure-only copy for the fused closure: it reads
        fp/sig/node/holes/hole_dicts; holding a wave's binding values (and
        their byte keys) in a long-lived cache entry would pin them for
        the entry's lifetime."""
        return dataclasses.replace(self, bindings=[], index={})


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
                 cache_cap: int | None = None, device=None, store=None):
        self.device = resolve_device(device)
        self.catalog: dict[str, Table] = {}
        self.registry: dict[str, UdfDef] = {}
        self.constraints = constraints or InlineConstraints()
        cap = self.CACHE_CAP if cache_cap is None else cache_cap
        self._plans: _BoundedCache = _BoundedCache(cap)
        self._execs: _BoundedCache = _BoundedCache(cap)
        self._batch_execs: _BoundedCache = _BoundedCache(cap)
        self._shard_execs: _BoundedCache = _BoundedCache(cap)
        self._fuse_execs: _BoundedCache = _BoundedCache(cap)
        self._merge_cache: _BoundedCache = _BoundedCache(64)
        self._prepared: _BoundedCache = _BoundedCache(cap)
        # persistent plan tier: a repro_torch.persist.PlanStore (or a
        # directory path — made into one, stamped for this session's
        # device).  None = in-process caches only.  The store is consulted
        # on in-memory misses and written behind an executable's first
        # run; every store failure degrades to a rebuild (_persist_load)
        if store is not None and not hasattr(store, "get"):
            from repro_torch.persist.store import PlanStore

            store = PlanStore(store, device=self.device)
        self.store = store
        self._persist_extra = {
            "saves": 0, "save_errors": 0, "costs_loaded": 0, "costs_saved": 0,
        }
        self.cache_stats = {
            "plan_hits": 0, "plan_misses": 0,
            "exec_hits": 0, "exec_misses": 0,
            "batch_hits": 0, "batch_misses": 0,
            "shard_hits": 0, "shard_misses": 0,
            "fuse_hits": 0, "fuse_misses": 0,
            # cross-statement CSE: evaluations avoided by sharing (constant
            # refs beyond the first + template ticket-refs beyond their
            # distinct bindings), and total plan nodes covered by a shared
            # evaluation, both accumulated per fused wave
            "cse_hits": 0, "cse_shared_nodes": 0,
            # persistent tier: hits (loaded a plan from the store), misses
            # (no entry), rejects (entry present but stale/corrupt/
            # unloadable — rebuilt).  Monotone like every other tier's
            # counters
            "persist_hits": 0, "persist_misses": 0, "persist_rejects": 0,
        }
        # dispatched-but-unsynced AsyncResults, oldest first (backpressure)
        self._inflight: deque = deque()
        self.async_stats = {"inflight_waits": 0, "inflight_peak": 0}
        # resilience seam: a repro_torch.resilience.faults.FaultInjector (or
        # any object with .check(site, statements)) installed by chaos
        # tests; None in production — the seams below are no-ops then
        self.fault_injector = None
        # cost-routing seam: a repro_torch.cost.CostRouter, created lazily
        # the first time a routed statement is prepared (None until then —
        # the sampling seams below are no-ops and unrouted sessions pay
        # nothing)
        self.cost_router = None

    def _ensure_router(self):
        """The session's cost router, made on first use and warm-started
        from the store's cost table when a store is attached."""
        if self.cost_router is None:
            from repro_torch.cost.router import CostRouter

            self.cost_router = CostRouter(self)
            if self.store is not None:
                self._load_costs()
        return self.cost_router

    def _load_costs(self) -> int:
        """Warm-start the router's measured cost model from the store (no-op
        on a clean miss; stale/corrupt tables degrade to an empty model)."""
        from repro_torch.persist import costs as _costs
        from repro_torch.persist.store import PlanCacheError

        try:
            n = _costs.load_costs(self.store, self._content_env_token(),
                                  self.cost_router)
        except PlanCacheError:
            self.cache_stats["persist_rejects"] += 1
            return 0
        if n:
            self._persist_extra["costs_loaded"] += n
        return n

    def save_costs(self) -> bool:
        """Persist the cost router's measured wave-cost EMAs so a fresh
        worker routes warm.  Fault-window samples were excluded at intake
        (``CostRouter.suppress``), so the saved table is clean by
        construction.  Returns True when a table was written."""
        if self.store is None or self.cost_router is None:
            return False
        from repro_torch.persist import costs as _costs

        try:
            ok = _costs.save_costs(self.store, self._content_env_token(),
                                   self.cost_router)
        except Exception:
            self._persist_extra["save_errors"] += 1
            return False
        if ok:
            self._persist_extra["costs_saved"] += 1
        return ok

    @property
    def persist_stats(self) -> dict:
        """The persistent tier's view: hit/miss/reject counters, write
        counts, cost-table traffic, and the store's on-disk footprint.
        ``{"enabled": False}`` when no store is attached."""
        if self.store is None:
            return {"enabled": False}
        return {
            "enabled": True,
            "hits": self.cache_stats["persist_hits"],
            "misses": self.cache_stats["persist_misses"],
            "rejects": self.cache_stats["persist_rejects"],
            **self._persist_extra,
            "store": self.store.stats(),
        }

    @property
    def cost_stats(self) -> dict:
        """The cost router's view: counters, measured per-configuration
        wave costs (EMA), and the recent decision log.  ``{"enabled":
        False}`` until a routed statement has been prepared."""
        if self.cost_router is None:
            return {"enabled": False}
        return self.cost_router.snapshot()

    def _fault(self, site: str, statements: tuple = ()) -> None:
        """Fault-injection seam: named executor sites call this with the
        statement fingerprints they serve; an installed injector may raise
        :class:`~repro_torch.resilience.faults.InjectedFault` here."""
        fi = self.fault_injector
        if fi is not None:
            fi.check(site, statements)

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
        node = query.node if isinstance(query, Q) else query
        # the handle cache additionally keys on the non-identity knobs, so
        # two prepares with different knobs do not alias (a routed and an
        # unrouted FROID, or a sharded and an unsharded one, share plans and
        # executables, not handles)
        key = (plan_fingerprint(node), policy.fingerprint(),
               policy.max_batch, policy.coalesce_window_s, policy.allow_async,
               policy.max_inflight, policy.shard_batches, policy.shard_token(),
               policy.fuse, policy.max_fused_statements, policy.route)
        ps = self._prepared.get(key)
        if ps is None:
            ps = PreparedStatement(self, node, policy)
            self._prepared[key] = ps
        if policy.route:
            self._ensure_router()
        ps._ensure_plan()  # cold: bind + optimize now
        return ps

    def execute(self, query, policy: ExecutionPolicy | str = FROID,
                params: dict | None = None) -> QueryResult:
        return self.prepare(query, policy).execute(params=params)

    def execute_many(self, query, policy: ExecutionPolicy | str = FROID,
                     params_list=()) -> list[QueryResult]:
        return self.prepare(query, policy).execute_many(params_list)

    def execute_async(self, query, policy: ExecutionPolicy | str = FROID,
                      params: dict | None = None) -> "AsyncResult":
        return self.prepare(query, policy).execute_async(params=params)

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

    def _content_env_token(self) -> tuple:
        """The cross-process rendering of :meth:`_env_token`: stamps (valid
        only in this process) are replaced by content digests, so two
        workers that loaded identical catalogs/registries produce identical
        persistent cache keys (and the reference's, for the same data).
        Memoized against the stamp-based token — the digests are recomputed
        only when DDL actually changed something, not per lookup."""
        env = self._env_token()
        cached = getattr(self, "_content_env_cache", None)
        if cached is not None and cached[0] == env:
            return cached[1]
        token = (
            tuple((name, t.num_rows, tuple(t.columns),
                   _table_content_digest(t))
                  for name, t in sorted(self.catalog.items())),
            tuple((name, _udf_content_digest(u))
                  for name, u in sorted(self.registry.items())),
            self._constraints_token(),
        )
        self._content_env_cache = (env, token)
        return token

    # -- persistent plan tier ----------------------------------------------
    def _persist_store(self, policy: ExecutionPolicy):
        """The store an executable-tier miss should consult, or None (no
        store attached / the policy opted out via ``persist=False``)."""
        s = self.store
        return s if (s is not None and policy.persist) else None

    def _persist_key(self, kind: str, query_fp, policy: ExecutionPolicy,
                     sig: tuple = (), bucket: int = 0,
                     shard_token: tuple = (), template: tuple = ()) -> tuple:
        """The cache identity as one self-describing stable tuple, the
        reference's: plan fingerprint x policy fingerprint x param
        signature x batch bucket x shard token x fused/CSE template
        tuple, plus the content env token.
        ``assert_stable_key`` is the enforcement point — any process-local
        value (an ``id()``, a stamp, a live object) smuggled into a
        component raises here instead of silently degrading the
        cross-worker hit rate."""
        from repro_torch.persist.keys import assert_stable_key

        key = ("plan", kind, query_fp, policy.fingerprint(), sig, bucket,
               shard_token, template, self._content_env_token())
        assert_stable_key(key)
        return key

    def _persist_load(self, store, key: tuple):
        """``(loaded_plan, meta) | None`` — the reference's typed
        degradation ladder: a version-stamp mismatch and a load failure
        count as rejects, a damaged entry additionally warns
        (:class:`~repro_torch.persist.PlanCacheWarning`) and is evicted.
        Every failure path returns None: the caller rebuilds, and results
        are never wrong."""
        from repro_torch.persist import codec
        from repro_torch.persist.store import (
            PlanCacheCorruptError,
            PlanCacheVersionError,
            PlanCacheWarning,
        )

        try:
            got = store.get(key)
        except PlanCacheVersionError:
            self.cache_stats["persist_rejects"] += 1
            return None
        except PlanCacheCorruptError as e:
            self.cache_stats["persist_rejects"] += 1
            warnings.warn(
                f"dropping damaged persistent plan entry ({e}); rebuilding",
                PlanCacheWarning, stacklevel=3)
            store.delete(key)
            return None
        if got is None:
            self.cache_stats["persist_misses"] += 1
            return None
        meta, blob = got
        try:
            loaded = codec.load_plan(blob)
        except Exception as e:  # unpickling: anything can surface
            self.cache_stats["persist_rejects"] += 1
            warnings.warn(
                f"persistent plan entry failed to load "
                f"({type(e).__name__}: {e}); rebuilding",
                PlanCacheWarning, stacklevel=3)
            store.delete(key)
            return None
        self.cache_stats["persist_hits"] += 1
        return loaded, meta

    def _persist_save(self, store, key: tuple, plan, *, out_dicts,
                      stats, extra: dict | None = None) -> bool:
        """Write-behind save of a freshly-run executable's plan; failures
        are counted, never raised (persistence is an optimization, not a
        correctness dependency)."""
        from repro_torch.persist import codec

        try:
            blob = codec.pack_plan(plan)
            meta = {
                "out_dicts": codec.encode_dicts(out_dicts),
                "stats": codec.jsonable_stats(stats),
            }
            if extra:
                meta.update(extra)
            store.put(key, meta, blob)
        except Exception:
            self._persist_extra["save_errors"] += 1
            return False
        self._persist_extra["saves"] += 1
        return True

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

    def _catalog_on(self, device, token: tuple | None = None) -> tuple:
        """``(args, tables)`` of the catalog on ``device``: the session's
        own on its device; on another, a replica copied once per catalog
        token and device (a small LRU) — the catalog every shard on that
        device reads, and its scan-mode hook's tables."""
        if token is None:
            token = self._catalog_token()
        args = self._catalog_args(token)
        if device == self.device:
            return args, self.catalog
        cache = getattr(self, "_replicas", None)
        if cache is None:
            cache = self._replicas = _BoundedCache(8)
        key = (token, device)
        hit = cache.get(key)
        if hit is None:
            from repro_torch.dist.sharding import to_device

            rargs = to_device(args, device)
            tables = {
                tname: Table({c: Column(data, valid,
                                        self.catalog[tname].columns[c].dictionary)
                              for c, (data, valid) in cols.items()})
                for tname, cols in rargs.items()
            }
            hit = cache[key] = (rargs, tables)
        return hit

    def _catalog_args_replicated(self, mesh, token: tuple) -> dict:
        """The catalog's argument structure on every distinct device of
        ``mesh`` (``device -> args``), one replica a device: replication
        is a real cross-device copy, made once per catalog state, not once
        per sharded dispatch, and never twice for a device the mesh names
        twice."""
        return {d: self._catalog_on(d, token)[0]
                for d in dict.fromkeys(mesh.devices.flat)}

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
        self._fault("compile", (query_fp,))
        plan, plan_hit = self._cached_plan(node, query_fp, policy)

        # iterative hook for UDF calls left in the plan (froid OFF, or
        # hybrid plans where the inlining budget ran out).  'scan' mode is
        # the reference's only jit-traceable interpreter, so the compiled
        # path always uses it regardless of policy.udf_mode.
        interp = None
        interps: dict = {}
        if _has_udf_calls(plan):
            interp = Interpreter(self.catalog, self.registry, mode="scan",
                                 device=self.device)
            interps[self.device] = interp

        def hook_on(dev):
            """The scan-mode hook on ``dev``: an interpreter over the
            catalog replica there (a shard's), made once a device."""
            if interp is None:
                return None
            it = interps.get(dev)
            if it is None:
                it = interps[dev] = Interpreter(
                    self._catalog_on(dev, env_token[0])[1], self.registry,
                    mode="scan", device=dev)
            return it.eval_udf_call

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

        def raw_of(run_plan: R.RelNode, dev=device):
            """The closure that runs ``run_plan`` on ``dev``: the session's
            own plan or one loaded from the store, on the session's device
            or a shard's."""
            hook = hook_on(dev)

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
                ex = Executor(catalog, udf_column_evaluator=hook,
                              use_pallas_agg=policy.pallas_agg, device=dev)
                out = ex.execute(run_plan, params=pvals)
                for n, c in out.table.columns.items():
                    out_dicts[n] = c.dictionary
                run_stats.update(ex.stats)
                cols = {n: (c.data, c.validity())
                        for n, c in out.table.columns.items()}
                return out.mask, cols

            return raw

        # persistent tier: on an in-memory miss, try the store before
        # building; a hit runs the loaded plan (the entry's dictionaries
        # and stats stand until its first run refreshes them), a miss
        # writes its entry behind the first run.  Either way ``raw`` takes
        # the same arguments — content-env-token keying guarantees the
        # catalog matches
        from repro_torch.persist import codec as _codec

        raw = raw_of(plan)
        store = self._persist_store(policy)
        if store is not None:
            pkey = self._persist_key("exec", query_fp, policy, sig=sig)
            loaded = self._persist_load(store, pkey)
            if loaded is not None:
                loaded_plan, pmeta = loaded
                out_dicts.update(_codec.decode_dicts(pmeta.get("out_dicts")) or {})
                run_stats.update(pmeta.get("stats") or {})
                raw = raw_of(loaded_plan)
            else:
                raw = _save_after_first_run(raw, lambda: self._persist_save(
                    store, pkey, plan, out_dicts=out_dicts, stats=run_stats))

        def fn(param_values: dict | None = None,
               catalog_token: tuple | None = None):
            pargs = {}
            for pname, x in (param_values or {}).items():
                v = _param_value(x, device)
                pargs[pname] = (v.data, v.validity())
            return raw(self._catalog_args(catalog_token), pargs)

        entry = _Executable(fn, plan, out_dicts, run_stats, interp, raw, raw_of,
                            interps)
        self._execs[key] = entry
        return entry, False, plan_hit

    def _batched_executable(self, node: R.RelNode, query_fp: tuple,
                            policy: ExecutionPolicy, params0: dict,
                            sig: tuple, bucket: int,
                            env_token: tuple | None = None
                            ) -> tuple[_BatchedExecutable, bool]:
        """(vmapped executable, batch-cache-hit).  The batched program is
        ``torch.func.vmap`` of the unbatched ``raw`` closure over the
        parameter axis (catalog arguments shared, not batched), cached per
        (plan, policy, signature, batch bucket) as the reference caches its
        jitted ``jax.vmap``."""
        if env_token is None:
            env_token = self._env_token()
        key = (query_fp, policy.fingerprint(), env_token, sig, bucket)
        entry = self._batch_execs.get(key)
        if entry is not None:
            self.cache_stats["batch_hits"] += 1
            return entry, True
        self.cache_stats["batch_misses"] += 1
        self._fault("compile", (query_fp,))
        # share the unbatched executable's raw closure and capture dicts so
        # execute() and execute_many() agree on output dictionaries/stats
        base, _, _ = self._executable(node, query_fp, policy, params0, env_token)

        # persistent tier: the batched program persists independently of the
        # base executable (its own bucket-keyed entry); a hit vmaps the
        # loaded plan's closure, a miss writes its entry behind its first
        # batched run
        raw = base.raw
        store = self._persist_store(policy)
        if store is not None:
            pkey = self._persist_key("batch", query_fp, policy, sig=sig,
                                     bucket=bucket)
            loaded = self._persist_load(store, pkey)
            if loaded is not None:
                raw = base.raw_of(loaded[0])
        target = torch.func.vmap(raw, in_dims=(None, 0))
        if store is not None and raw is base.raw:
            target = _save_after_first_run(target, lambda: self._persist_save(
                store, pkey, base.plan, out_dicts=base.out_dicts,
                stats=base.stats))

        def fn(batched_pargs: dict, catalog_token: tuple | None = None):
            return target(self._catalog_args(catalog_token), batched_pargs)

        entry = _BatchedExecutable(fn, base.plan, base.out_dicts, base.stats,
                                   bucket, base.interp)
        self._batch_execs[key] = entry
        return entry, False

    def _sharded_executable(self, node: R.RelNode, query_fp: tuple,
                            policy: ExecutionPolicy, params0: dict,
                            sig: tuple, bucket: int,
                            env_token: tuple | None = None
                            ) -> tuple[_ShardedExecutable, bool]:
        """(mesh-sharded executable, shard-cache-hit).  The same vmapped
        program as :meth:`_batched_executable`, with the stacked parameter
        axis split into one contiguous block per data-axis position of the
        mesh (``repro_torch.dist.sharding.place``): each block runs on its
        position's device, with that device's catalog replica, executor
        and scan-mode hook (one vmapped closure per distinct device).
        Keyed as the reference keys its sharded jit, ``(query_fp, policy,
        env token, sig, bucket, shard_token)``.  Callers gate on
        divisibility: a bucket the data axes don't divide never reaches
        here (it runs on the replicated single-device path instead — rows
        are never padded onto a mesh that doesn't fit them).  With a
        store, the entry is the reference's ``"shard"`` key with the shard
        token (one entry a placement): a hit runs the loaded plan on every
        shard, a miss writes its entry behind its first run."""
        from repro_torch.dist.sharding import batch_sharding, place, positions

        if env_token is None:
            env_token = self._env_token()
        shard_token = policy.shard_token()
        key = (query_fp, policy.fingerprint(), env_token, sig, bucket,
               shard_token)
        entry = self._shard_execs.get(key)
        if entry is not None:
            self.cache_stats["shard_hits"] += 1
            return entry, True
        self.cache_stats["shard_misses"] += 1
        self._fault("compile", (query_fp,))
        base, _, _ = self._executable(node, query_fp, policy, params0, env_token)
        mesh = policy.mesh
        parg_sharding = batch_sharding(mesh, bucket)
        if parg_sharding is None:  # callers gate; keep the invariant loud
            raise ValueError(
                f"bucket {bucket} is not divisible by the mesh data axes"
            )
        devs = positions(parg_sharding)
        store = self._persist_store(policy)
        loaded = None
        if store is not None:
            pkey = self._persist_key("shard", query_fp, policy, sig=sig,
                                     bucket=bucket, shard_token=shard_token)
            loaded = self._persist_load(store, pkey)
        run_plan = base.plan if loaded is None else loaded[0]
        targets = {
            d: torch.func.vmap(
                base.raw if (d == self.device and loaded is None)
                else base.raw_of(run_plan, d), in_dims=(None, 0))
            for d in dict.fromkeys(devs)
        }

        def fn(batched_pargs: dict, catalog_token: tuple | None = None):
            cats = self._catalog_args_replicated(
                mesh, catalog_token if catalog_token is not None
                else self._catalog_token())
            outs = []
            for d, block in zip(devs, place(batched_pargs, parg_sharding)):
                with _on_device(d):
                    outs.append(targets[d](cats[d], block))
            return outs

        if store is not None and loaded is None:
            fn = _save_after_first_run(fn, lambda: self._persist_save(
                store, pkey, base.plan, out_dicts=base.out_dicts,
                stats=base.stats))
        entry = _ShardedExecutable(fn, base.plan, base.out_dicts, base.stats,
                                   bucket, devs, base.interp, base.interps)
        self._shard_execs[key] = entry
        return entry, False

    def synchronize(self) -> None:
        """Wait for the session's device (the reference's
        ``jax.block_until_ready``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _marker(self):
        """A ``torch.cuda.Event`` recorded on the current stream after the
        work queued so far (None on the CPU, where the work is done)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _markers(self, devices) -> list:
        """One ``torch.cuda.Event`` a distinct card among ``devices``,
        recorded on its current stream after the work queued so far (the
        host's wait for a sharded dispatch); none for host devices."""
        out = []
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(d))
                out.append(ev)
        return out

    # -- multi-statement fusion ----------------------------------------------
    def _merged_for(self, members: list, env_token: tuple):
        """The merge pass's :class:`~repro_torch.fuse.merge.FusedPlan` for
        this member set, cached — the host consults the sharing maps on
        every wave (warm or cold) to plan template bindings, and the walk
        must not re-run per drain.

        The key includes the member plans' identities: the sharing maps
        are ``node_id``-keyed, so a plan rebuilt after a ``_plans``-cache
        eviction (same env token, fresh node ids) must get a fresh merge,
        not a stale FusedPlan whose marks match nothing.  Plan identity is
        the session stamp (monotonic, never recycled)."""
        key = (tuple(m.key for m in members), env_token,
               tuple(_stamp(m.plan) for m in members))
        merged = self._merge_cache.get(key)
        if merged is None:
            from repro_torch.fuse.merge import merge_plans

            merged = merge_plans([m.plan for m in members])
            self._merge_cache[key] = merged
        return merged

    def _fused_executable(self, members: list, policy: ExecutionPolicy,
                          shard: bool, env_token: tuple, merged, groups: list,
                          member_tmaps: list, slot_names: list,
                          template_token: tuple
                          ) -> tuple[_FusedExecutable, bool]:
        """(fused executable, fuse-cache-hit).  One closure carrying every
        member: the merge pass's shared subtrees execute once, each
        template pool once per distinct binding, then each member's plan
        vmaps over its own stacked parameter axis (see
        ``repro_torch.fuse.program``).  Keyed as the reference keys its
        jitted program: the member tuple in canonical (sorted) order ×
        the plans' stamps × policy × env token × **template identity**
        (``(fingerprint, binding signature, padded distinct-binding
        count)`` per pool group), so a mixed queue arriving in any order
        warm-hits, a changed distinct-binding count re-specializes, and
        any DDL/catalog poke invalidates every member at once via the env
        token.  With a store, a miss first looks the wave up there (its key
        is the reference's: member keys x template token, no stamps, no
        ids); a hit runs the loaded member plans (:meth:`_loaded_fused`),
        and the compile fault seam fires only on a store miss, as in the
        reference.

        A sharded wave (``shard``) runs the program once a data-axis
        position of the policy's mesh, on that position's device: each
        batched member's stacked axis is split into contiguous blocks,
        while parameter-free members, template pools and the shared
        subtrees are computed on every shard (replicated, as XLA's SPMD
        partitioner would).  Its key adds the shard token, and it is not
        persisted (the reference's members fall back to their shard-tier
        entries instead)."""
        shard_token = policy.shard_token() if shard else ()
        key = (tuple(m.key for m in members),
               tuple(_stamp(m.plan) for m in members), policy.fingerprint(),
               env_token, shard, shard_token, template_token)
        entry = self._fuse_execs.get(key)
        if entry is not None:
            self.cache_stats["fuse_hits"] += 1
            return entry, True
        self.cache_stats["fuse_misses"] += 1
        from repro_torch.fuse.program import build_fused_raw
        from repro_torch.persist import codec as _codec

        if shard:
            return self._sharded_fused(key, members, policy, merged, groups,
                                       member_tmaps, slot_names)
        store = self._persist_store(policy)
        loaded = None
        if store is not None:
            pkey = self._persist_key(
                "fused", tuple(m.key for m in members), policy,
                template=template_token)
            loaded = self._persist_load(store, pkey)
        if loaded is not None:
            plans, pmeta = loaded
            lmembers, lmerged, lgroups, ltmaps, lnames = self._loaded_fused(
                members, plans, groups, member_tmaps, slot_names)
            raw, out_dicts, run_stats, _, eval_counts = build_fused_raw(
                self, lmembers, policy, lmerged, lgroups, ltmaps, lnames)
            for d, enc in zip(out_dicts, pmeta.get("out_dicts_list") or ()):
                d.update(_codec.decode_dicts(enc) or {})
            run_stats.update(pmeta.get("stats") or {})
        else:
            self._fault("compile", tuple(m.key[0] for m in members))
            raw, out_dicts, run_stats, merged, eval_counts = build_fused_raw(
                self, members, policy, merged, [g.spec() for g in groups],
                member_tmaps, slot_names)
            if store is not None:
                raw = _save_after_first_run(raw, lambda: self._persist_save(
                    store, pkey, tuple(m.plan for m in members), out_dicts=None,
                    stats=run_stats,
                    extra={"out_dicts_list":
                           [_codec.encode_dicts(d) for d in out_dicts]}))

        def fn(pargs_tuple, targs_tuple, catalog_token: tuple | None = None):
            return raw(self._catalog_args(catalog_token), pargs_tuple,
                       targs_tuple)

        entry = _FusedExecutable(fn, [m.plan for m in members], out_dicts,
                                 run_stats, members, merged, eval_counts)
        self._fuse_execs[key] = entry
        return entry, False

    def _sharded_fused(self, key: tuple, members: list, policy: ExecutionPolicy,
                       merged, groups: list, member_tmaps: list,
                       slot_names: list) -> tuple[_FusedExecutable, bool]:
        """The sharded fused executable (see :meth:`_fused_executable`):
        one fused closure per distinct device of the mesh's data-axis
        positions; ``fn`` returns one member tuple a position.  The entry's
        dictionaries, stats and pool counts are the first position's (the
        shards run the same program)."""
        from repro_torch.dist.sharding import (batch_sharding, data_axis_size,
                                               place, positions,
                                               replicated_sharding)
        from repro_torch.fuse.program import build_fused_raw

        self._fault("compile", tuple(m.key[0] for m in members))
        mesh = policy.mesh
        split = batch_sharding(mesh, data_axis_size(mesh))
        rep = replicated_sharding(mesh)
        devs = positions(split)
        specs = [g.spec() for g in groups]
        built = {d: build_fused_raw(self, members, policy, merged, specs,
                                    member_tmaps, slot_names, device=d)
                 for d in dict.fromkeys(devs)}

        def replicated(tree) -> dict:
            return dict(zip(positions(rep), place(tree, rep)))

        def fn(pargs_tuple, targs_tuple, catalog_token: tuple | None = None):
            cats = self._catalog_args_replicated(
                mesh, catalog_token if catalog_token is not None
                else self._catalog_token())
            targs = replicated(targs_tuple)
            blocks = [place(p, split) if m.sig else replicated(p)
                      for p, m in zip(pargs_tuple, members)]
            outs = []
            for i, d in enumerate(devs):
                pargs = tuple(b[i] if m.sig else b[d]
                              for b, m in zip(blocks, members))
                with _on_device(d):
                    outs.append(built[d][0](cats[d], pargs, targs[d]))
            return outs

        _, out_dicts, run_stats, merged, eval_counts = built[devs[0]]
        entry = _FusedExecutable(fn, [m.plan for m in members], out_dicts,
                                 run_stats, members, merged, eval_counts,
                                 positions=devs)
        self._fuse_execs[key] = entry
        return entry, False

    @staticmethod
    def _loaded_fused(members: list, plans: tuple, groups: list,
                      member_tmaps: list, slot_names: list) -> tuple:
        """``build_fused_raw``'s structure over member plans loaded from the
        store: the members with their loaded plans, the merge pass over
        those, the pool groups' canonical nodes from it, and the wave's
        occurrence maps carried across to the loaded nodes' ids.  The
        loaded plans are copies of the members' (a walk of one pairs node
        for node with a walk of the other), and the merge pass is a
        function of plan structure, so the fused program is the one the
        session's own plans make; only its node ids are this load's."""
        from repro_torch.fuse.merge import merge_plans

        loaded = [dataclasses.replace(m, plan=p) for m, p in zip(members, plans)]
        ids = {a.node_id: b.node_id
               for m, p in zip(members, plans)
               for a, b in zip(R.walk_plan_deep(m.plan), R.walk_plan_deep(p))}
        merged = merge_plans(list(plans))
        nodes = {t.fp: t.node for t in merged.templates}
        specs = [dataclasses.replace(g.spec(), node=nodes[g.fp]) for g in groups]
        tmaps = [{ids[n]: gi for n, gi in t.items()} for t in member_tmaps]
        names = [{ids[n]: name for n, name in t.items()} for t in slot_names]
        return loaded, merged, specs, tmaps, names

    def execute_fused(self, calls) -> list[QueryResult]:
        """Execute a mixed-statement call list — ``[(stmt, params), ...]``
        — through as few fused device programs as fusability allows.

        Calls whose statements may share a program (same session and
        policy fingerprint; ``policy.fuse`` on; pure plans — see
        ``repro_torch.fuse.analysis``) coalesce into fused programs of at
        most ``policy.max_fused_statements`` distinct statements;
        everything else (eager policies, foreign sessions, singleton
        groups) falls back to the per-statement ``execute_many`` path.

        Returns one :class:`QueryResult` per call, in input order,
        element-wise equal to the per-statement serial loop.  Fused
        results carry ``stats['fused'] / fused_statements /
        fused_programs / shared_subtrees`` — the shared-scan evidence."""
        from repro_torch.fuse.analysis import partition_calls

        calls = [(stmt, dict(p) if p else {}) for stmt, p in calls]
        if not calls:
            return []
        results: list[QueryResult | None] = [None] * len(calls)
        groups, fallbacks = partition_calls(self, calls)
        for stmt, items in fallbacks:
            rs = stmt.execute_many([p for _, p in items])
            for (i, _), r in zip(items, rs):
                results[i] = r
        for group in groups:
            self._run_fused(group, results)
        return results  # type: ignore[return-value]

    def _run_fused(self, group: list, results: list) -> None:
        """Run one fused group — ``[(index, stmt, params), ...]`` with ≥ 2
        distinct statements and compatible policies — and scatter its
        QueryResults into ``results``: the dispatch, then the wait on its
        event."""
        self._finalize_fused(self._dispatch_fused(group, results), results)

    def _dispatch_fused(self, group: list, results: list) -> dict:
        """Plan and dispatch one fused wave without waiting for it (no host
        sync past the tickets that spill to the per-statement path, which
        are filled into ``results`` here); returns the wave's record, with
        the event recorded after the dispatch, for
        :meth:`_finalize_fused`."""
        env_token = self._env_token()
        policy = group[0][1].policy  # fingerprint-equal across the group
        # member = one (statement, signature) pair stacked over its tickets
        order: list[tuple] = []
        by_key: dict[tuple, dict] = {}
        for idx, stmt, params in group:
            sig = param_signature(params)
            k = (stmt._query_fp, sig)
            ent = by_key.get(k)
            if ent is None:
                ent = by_key[k] = {"stmt": stmt, "sig": sig,
                                   "idxs": [], "params": []}
                order.append(k)
            ent["idxs"].append(idx)
            ent["params"].append(params)
        # one fused wave per drain: tickets beyond the mesh-scaled batch
        # bound ride the per-statement path (already batched + pipelined).
        # max_batch is a non-identity knob, so fingerprint-equal members
        # may disagree — honor the strictest bound (and keep the cap, and
        # therefore the buckets and cache keys, arrival-order independent)
        cap = max(1, min(s.policy.max_batch for _, s, _ in group)
                  * policy.shard_devices())
        for k in order:
            ent = by_key[k]
            if len(ent["params"]) > cap:
                extra_i, extra_p = ent["idxs"][cap:], ent["params"][cap:]
                ent["idxs"], ent["params"] = ent["idxs"][:cap], ent["params"][:cap]
                for i, r in zip(extra_i, ent["stmt"].execute_many(extra_p)):
                    results[i] = r
        # canonical member order: fused cache keys are insensitive to the
        # queue's arrival order (repr: fingerprints are not comparable)
        order.sort(key=repr)
        members: list[_FuseMember] = []
        for k in order:
            ent = by_key[k]
            stmt = ent["stmt"]
            plan, _ = self._cached_plan(stmt.node, stmt._query_fp, stmt.policy)
            # parameter-free members execute once, unbatched — every ticket
            # shares the single result (mirrors execute_many's group path)
            bucket = 1 if not ent["sig"] else batch_bucket(len(ent["params"]), cap)
            pdicts = {name: _param_dictionary(v)
                      for name, v in ent["params"][0].items()}
            members.append(_FuseMember(plan, ent["sig"], bucket, pdicts,
                                       (stmt._query_fp, ent["sig"], bucket)))
        devices = policy.shard_devices()
        shard = False
        if devices > 1:
            from repro_torch.dist.sharding import data_axis_size, pick_data_axes

            # one program, one placement: shard whenever ANY batched
            # member's bucket divides the data axes.  A non-dividing
            # batched member pads its bucket up to the next multiple of the
            # data-axis product (padding repeats the last ticket, exactly
            # like power-of-two bucket padding), so every batched member
            # splits over the same positions.  The cap is max_batch ×
            # devices — itself a multiple of the product — so a padded
            # bucket never exceeds it.  Only when NO batched member divides
            # (or none is batched) does the wave replicate; parameter-free
            # members are unbatched and always replicate.  (On a pod mesh,
            # a bucket that divides ``data`` alone pads too: the reference
            # splits it over ``data`` and replicates it over ``pod``.)
            mesh = policy.mesh
            n = data_axis_size(mesh)
            full = pick_data_axes(mesh, n)
            batched = [m for m in members if m.sig]
            shard = any(pick_data_axes(mesh, m.bucket) is not None
                        for m in batched)
            if shard:
                for m in batched:
                    if pick_data_axes(mesh, m.bucket) != full:
                        m.bucket += (-m.bucket) % n
                        m.key = (m.key[0], m.key[1], m.bucket)
        # cross-statement CSE: plan the template binding pools from the
        # wave's actual ticket values (the merge maps are cached; only the
        # binding dedup runs per wave)
        merged = self._merged_for(members, env_token)
        groups, member_tmaps, slot_maps, slot_names, template_token = \
            _plan_template_groups(merged, members,
                                  [by_key[k]["params"] for k in order])
        device = self.device
        pargs_tuple = []
        t0 = time.perf_counter()
        for m, k, smap, names in zip(members, order, slot_maps, slot_names):
            plist = by_key[k]["params"]
            if m.sig:
                padded = plist + [plist[-1]] * (m.bucket - len(plist))
                pargs = _stack_params(padded, device)
                for nid, slots in smap.items():
                    # each occurrence's pool-slot index rides the stacked
                    # axis as a reserved parameter (padding repeats the
                    # last ticket's slot, matching the padded params)
                    s = slots + [slots[-1]] * (m.bucket - len(slots))
                    pargs[names[nid]] = (
                        S.host_tensor(np.asarray(s, np.int32), torch.int32, device),
                        torch.ones((m.bucket,), dtype=torch.bool, device=device),
                    )
                pargs_tuple.append(pargs)
            else:
                # parameter-free member: unbatched, no stacked args — but
                # const-bound template occurrences (lifted templates) still
                # gather their pool slot through the reserved parameter
                pargs = {}
                for nid, slots in smap.items():
                    pargs[names[nid]] = (
                        S.host_tensor(slots[0], torch.int32, device),
                        torch.ones((), dtype=torch.bool, device=device))
                pargs_tuple.append(pargs)
        # binding pools pad to their d-bucket (repeat the last binding):
        # the stacked leading axis is what the fused closure specializes
        # on; padded slots are evaluated and never referenced by any
        # ticket's slot
        targs_tuple = tuple(
            _stack_params(
                g.bindings
                + [g.bindings[-1]] * (_pool_pad(len(g.bindings))
                                      - len(g.bindings)), device)
            for g in groups)
        stack_s = time.perf_counter() - t0
        entry, hit = self._fused_executable(
            members, policy, shard, env_token, merged, groups, member_tmaps,
            slot_names, template_token)
        t0 = time.perf_counter() - stack_s
        wave_fps = tuple(m.key[0] for m in members)
        self._fault("dispatch", wave_fps)
        outs = entry.fn(tuple(pargs_tuple), targs_tuple, env_token[0])
        if shard:
            events = self._markers(entry.positions)
        else:
            outs = [outs]
            events = [ev for ev in (self._marker(),) if ev is not None]
        return {"members": members, "order": order, "by_key": by_key,
                "merged": merged, "groups": groups, "slot_maps": slot_maps,
                "entry": entry, "hit": hit, "outs": outs, "events": events,
                "shard": shard, "devices": devices,
                "t0": t0, "dispatch_s": time.perf_counter() - t0,
                "wave_fps": wave_fps}

    def _finalize_fused(self, rec: dict, results: list) -> None:
        """Wait for a dispatched fused wave's event (never the whole
        device) and build its QueryResults."""
        members, order, by_key = rec["members"], rec["order"], rec["by_key"]
        merged, groups, entry = rec["merged"], rec["groups"], rec["entry"]
        self._fault("sync", rec["wave_fps"])
        for ev in rec["events"]:
            ev.synchronize()
        elapsed = time.perf_counter() - rec["t0"]
        t_dispatch = rec["dispatch_s"]
        n_stmts = len({m.key[0] for m in members})
        # sharing evidence: evaluations avoided this wave (constant refs
        # beyond the first evaluation + template ticket-refs beyond their
        # distinct bindings) and the covered-node total
        t_refs = sum(len(s) for smap in rec["slot_maps"] for s in smap.values())
        t_evals = sum(len(g.bindings) for g in groups)
        t_slots = sum(_pool_pad(len(g.bindings)) for g in groups)
        m_stats = merged.stats
        # subtrahend is the distinct *maximal* fingerprint count — the pool
        # also holds nested entries, which are not separate evaluations the
        # per-statement path would have paid.  Template savings subtract
        # the *padded* slot count: padded pool slots are real device
        # evaluations, so counting them as avoided would overstate sharing
        self.cache_stats["cse_hits"] += (
            max(0, m_stats["shared_refs"] - m_stats["shared_maximal_subtrees"])
            + max(0, t_refs - t_slots)
        )
        self.cache_stats["cse_shared_nodes"] += m_stats["cse_shared_nodes"]
        n_tickets = sum(len(by_key[k]["idxs"]) for k in order)
        router = self.cost_router
        if router is not None:
            router.observe_fused(
                rec["wave_fps"], elapsed, n_tickets,
                meta={"cse_bindings": t_evals, "cse_pool_slots": t_slots,
                      "cse_ticket_refs": t_refs})
        fused_explain = merged.explain()
        for j, (m, k) in enumerate(zip(members, order)):
            ent = by_key[k]
            # one member tuple a shard position (one on an unsharded wave)
            parts = [out[j] for out in rec["outs"]]
            stats = {
                **entry.stats, "compiled": True, "batched": True,
                "fused": True, "fused_programs": 1,
                "fused_statements": n_stmts, "fused_members": len(members),
                "batch_size": len(ent["params"]), "batch_bucket": m.bucket,
                "dispatch_s": t_dispatch, "sync_s": elapsed - t_dispatch,
                # this wave's template pooling (the merge-level cse_*
                # counters ride in from entry.stats)
                "cse_template_groups": len(groups),
                "cse_bindings": t_evals,
                "cse_pool_slots": t_slots,
                "cse_template_ticket_refs": t_refs,
                # wave-level figures (dispatch_s/sync_s/cse_*) are COPIED
                # into every ticket's result in this wave; aggregators
                # summing across results must divide by wave_tickets or
                # they double-count the wave
                "wave_tickets": n_tickets,
                "fused_explain": fused_explain,
            }
            if rec["shard"]:
                stats["sharded"] = True
                stats["shard_devices"] = rec["devices"]
            out_dicts = entry.out_dicts[j]

            if not m.sig:
                # unbatched member: one shared materialization serves
                # every ticket (distinct QueryResult shells, like
                # execute_many's parameter-free group); every shard
                # computed it, and the first position's answers
                mask, cols = parts[0]
                cell: dict = {}

                def mat_shared(mask=mask, cols=cols, out_dicts=out_dicts,
                               cell=cell):
                    if "v" not in cell:
                        cell["v"] = MaskedTable(
                            Table({n: Column(data, valid, out_dicts.get(n))
                                   for n, (data, valid) in cols.items()}),
                            mask,
                        )
                    return cell["v"]

                for i in ent["idxs"]:
                    results[i] = QueryResult(
                        None, m.plan, elapsed, dict(stats),
                        policy=ent["stmt"].policy, cache_hit=rec["hit"],
                        materialize=mat_shared,
                    )
                continue

            def materialize(j, parts=parts, bucket=m.bucket, out_dicts=out_dicts):
                (mask, cols), row = _row_of(parts, bucket, j)
                table = Table(
                    {n: Column(data[row], valid[row], out_dicts.get(n))
                     for n, (data, valid) in cols.items()}
                )
                return MaskedTable(table, mask[row])

            for row, i in enumerate(ent["idxs"]):
                results[i] = QueryResult(
                    None, m.plan, elapsed, dict(stats),
                    policy=ent["stmt"].policy, cache_hit=rec["hit"],
                    materialize=(lambda row=row, mat=materialize: mat(row)),
                )

    # -- async backpressure --------------------------------------------------
    @property
    def inflight(self) -> int:
        """Dispatched-but-unsynced ``execute_async`` calls right now."""
        return len(self._inflight)

    def _admit_async(self, bound: int) -> None:
        """Make room for one more in-flight dispatch: reap already-done
        results for free, then wait on the oldest in-flight dispatch's
        event while the session is at the bound (the producer stalls
        here)."""
        dq = self._inflight
        while dq and dq[0].done():
            dq.popleft()._released = True
        while len(dq) >= max(1, bound):
            self.async_stats["inflight_waits"] += 1
            oldest = dq.popleft()
            oldest._released = True
            if oldest._marker is not None:
                oldest._marker.synchronize()


# ---------------------------------------------------------------------------
# PreparedStatement
# ---------------------------------------------------------------------------


class PreparedStatement:
    """A query bound to a session + policy.  Calling conventions:

    * ``execute(params=…) -> QueryResult`` — the client path.  The cold
      call plans + binds; warm calls reuse the session caches and set
      ``QueryResult.cache_hit``.
    * ``stmt(params=…)`` — the raw device-level call of the compiled
      executable (mask + columns, nothing materialized).
    * ``execute_many(params_list)`` and ``execute_async(params)`` — the
      batched and async paths.
    """

    def __init__(self, session: Session, node: R.RelNode,
                 policy: ExecutionPolicy):
        self.session = session
        self.node = node
        self.policy = policy
        self._query_fp = plan_fingerprint(node)
        self._interp: Interpreter | None = None
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

    def _eager_interp(self) -> Interpreter:
        # kept across executes so the per-statement plan cache stays warm —
        # but rebuilt if the session's catalog/registry dicts were rebound
        # wholesale; the identity check is on live objects
        interp = self._interp
        if (interp is None
                or interp.catalog is not self.session.catalog
                or interp.registry is not self.session.registry):
            interp = self._interp = Interpreter(
                self.session.catalog, self.session.registry,
                mode=self.policy.udf_mode,
                jit_statements=self.policy.jit_statements,
                device=self.session.device,
            )
        return interp

    # -- cost routing ------------------------------------------------------
    def _route_target(self) -> "PreparedStatement":
        """The statement the cost router currently picks for this routed
        statement — ``self`` when the incumbent policy wins, else a
        delegate prepared under the chosen policy on the same session (so
        on its device).  The delegate's policy has ``route=False`` (one
        routing decision per call, never a chain), but its samples still
        train the router — it is the session's router, keyed by policy
        fingerprint."""
        router = self.session._ensure_router()
        pol = router.choose_policy(self)
        if pol.fingerprint() == self.policy.fingerprint():
            return self
        return self.session.prepare(self.node, pol.routed(False))

    # -- execution ---------------------------------------------------------
    def __call__(self, params: dict | None = None):
        """Raw call: the device outputs ``(mask, {col: (data, valid)})``,
        nothing materialized and no wait (an eager policy returns its
        result's mask)."""
        if not self.policy.compile_plan:
            return self.execute(params=params).masked.mask
        env_token = self.session._env_token()
        entry, _, _ = self.session._executable(
            self.node, self._query_fp, self.policy, params, env_token
        )
        return entry.fn(params, env_token[0])

    def execute(self, params: dict | None = None) -> QueryResult:
        if self.policy.route and self.policy.compile_plan:
            target = self._route_target()
            if target is not self:
                return target.execute(params=params)
        if self.policy.compile_plan:
            return self._execute_compiled(params)
        return self._execute_eager(params)

    # -- batched execution -------------------------------------------------
    def execute_many(self, params_list) -> list[QueryResult]:
        """Execute once per parameter set, set-oriented: same-signature
        sets are stacked into one device program (``torch.func.vmap`` of
        the plan over the parameter axis; tables shared) instead of N
        dispatch+sync round trips.  Mixed-signature lists split into
        per-signature sub-batches; batches larger than ``policy.max_batch``
        split into chunks.  Returns one :class:`QueryResult` per input, in
        input order, element-wise equal to the serial ``execute`` loop.

        A policy carrying a mesh (``policy.sharded(mesh)``) shards the
        stacked parameter axis over the mesh's data axes: ``max_batch``
        bounds the *per-device* batch, so one mesh dispatch carries up to
        ``max_batch × shard_devices()`` parameter sets, and each position's
        block runs on its device (``stats['sharded']``,
        ``stats['shard_devices']``).  Sharding is divisibility-gated per
        bucket — buckets the data axes don't divide (small remainders,
        tiny batches) run on the replicated single-device path, re-chunked
        to ``max_batch``, never padded onto a mesh that doesn't fit.

        Chunked dispatches are **pipelined**: every chunk is dispatched
        before any chunk is waited for (bounded by ``policy.max_inflight``
        unsynced dispatches — past the bound a new dispatch first waits for
        the oldest chunk's event), then one barrier at the end collects
        them all.  ``stats['pipelined_chunks']`` reports how many chunks
        the call dispatched before that barrier.

        A compiled policy whose plan cannot run under vmap raises: it never
        turns into a loop over the tickets.  Only an eager policy (no
        device program to batch) runs the serial loop, as the reference's
        does.  Results materialize lazily from the shared device batch."""
        params_list = [dict(p) if p else {} for p in params_list]
        if not params_list:
            return []
        if self.policy.route and self.policy.compile_plan:
            target = self._route_target()
            if target is not self:
                return target.execute_many(params_list)
        if not self.policy.compile_plan:
            # eager policies have no device program to batch; stay serial
            return [self.execute(params=p) for p in params_list]
        env_token = self.session._env_token()
        groups: dict[tuple, list[int]] = {}
        for i, p in enumerate(params_list):
            groups.setdefault(param_signature(p), []).append(i)
        results: list[QueryResult | None] = [None] * len(params_list)
        pending: list[dict] = []  # dispatched-but-unsynced chunk records
        # mesh capacity: max_batch bounds the per-device batch
        cap = max(1, self.policy.max_batch * self.policy.shard_devices())
        for sig, idxs in groups.items():
            if not sig:
                # parameter-free: every invocation is the same program run —
                # one execution serves the whole group, surfaced as distinct
                # QueryResult shells (per-result stats stay independent)
                r = self._execute_compiled(None)
                for i in idxs:
                    results[i] = QueryResult(
                        r.masked, r.plan, r.elapsed_s, dict(r.stats),
                        policy=r.policy, cache_hit=r.cache_hit,
                    )
                continue
            for s in range(0, len(idxs), cap):
                chunk = idxs[s:s + cap]
                self._dispatch_batch(chunk, [params_list[i] for i in chunk],
                                     sig, env_token, pending, cap)
        # the barrier: all chunks are in flight; wait in dispatch order
        npend = len(pending)
        for rec in pending:
            self._finalize_batch(rec, results, npend)
        return results  # type: ignore[return-value]

    def _dispatch_batch(self, idxs: list[int], plist: list[dict], sig: tuple,
                        env_token: tuple, pending: list, cap: int) -> None:
        """Dispatch one chunk (no wait) and append its record, with the
        event recorded after it, to ``pending`` for the caller's
        end-of-call barrier."""
        k = len(plist)
        bucket = batch_bucket(k, cap)
        router = self.session.cost_router
        if router is not None and self.policy.route:
            # bucket routing: ride an already-measured larger bucket when
            # that beats the natural one's estimated first-run cost (bucket
            # >= k always holds — rides only go up, and padding repeats the
            # last set); the bucket picks the executable
            bucket = router.choose_bucket(
                self, sig, k, bucket, cap,
                shard=self.policy.shard_devices() > 1)
        devices = self.policy.shard_devices()
        shard = False
        if devices > 1:
            from repro_torch.dist.sharding import pick_data_axes

            shard = pick_data_axes(self.policy.mesh, bucket) is not None
            if not shard:
                # replicated fallback: the mesh-capacity bucket would land
                # whole on one device, so re-chunk to the per-device bound
                # (max_batch is a single-device promise, not just a knob)
                mb = max(1, self.policy.max_batch)
                if k > mb:
                    for s in range(0, k, mb):
                        self._dispatch_batch(idxs[s:s + mb], plist[s:s + mb],
                                             sig, env_token, pending, mb)
                    return
                bucket = batch_bucket(k, mb)
        make = (self.session._sharded_executable if shard
                else self.session._batched_executable)
        entry, hit = make(self.node, self._query_fp, self.policy, plist[0],
                          sig, bucket, env_token)
        # runahead bound: past max_inflight unsynced chunks, wait for the
        # oldest before issuing another dispatch (the same backpressure rule
        # as execute_async — the host cannot queue unbounded device work)
        bound = max(1, self.policy.max_inflight)
        unsynced = [r for r in pending if not r["synced"]]
        while len(unsynced) >= bound:
            oldest = unsynced.pop(0)
            for ev in oldest["events"]:
                ev.synchronize()
            oldest["synced"] = True
        # pad to the bucket by repeating the last param set; padding rows
        # are computed and discarded (never surfaced in results)
        padded = plist + [plist[-1]] * (bucket - k)
        # a sharded plan's row loop runs once a shard, on its device's hook
        interps = ([] if entry.interp is None
                   else list(entry.interps.values()) if shard else [entry.interp])
        rows_before = sum(it.rows_driven for it in interps)
        t0 = time.perf_counter()
        pargs = _stack_params(padded, self.session.device)
        self.session._fault("dispatch", (self._query_fp,))
        if shard:
            parts = entry.fn(pargs, env_token[0])
            events = self.session._markers(entry.positions)
        else:
            parts = [entry.fn(pargs, env_token[0])]
            events = [ev for ev in (self.session._marker(),) if ev is not None]
        t_dispatch = time.perf_counter() - t0
        pending.append({
            "idxs": idxs, "entry": entry, "hit": hit, "parts": parts,
            "k": k, "bucket": bucket, "shard": shard, "devices": devices,
            "t0": t0, "dispatch_s": t_dispatch, "events": events,
            "synced": False, "sig": sig,
            "udf_rows": ((sum(it.rows_driven for it in interps) - rows_before)
                         // len(parts) if interps else None),
        })

    def _finalize_batch(self, rec: dict, results: list,
                        pipelined: int) -> None:
        """Wait for one dispatched chunk's event and build its
        QueryResults.  ``sync_s`` is the wait from dispatch end to this
        chunk's barrier arrival — under pipelining that wait overlaps the
        later chunks' host-side stacking, which is the point."""
        entry, parts = rec["entry"], rec["parts"]
        self.session._fault("sync", (self._query_fp,))
        for ev in rec["events"]:
            ev.synchronize()
        rec["synced"] = True
        elapsed = time.perf_counter() - rec["t0"]
        stats = {
            **entry.stats, "compiled": True, "batched": True,
            "batch_size": rec["k"], "batch_bucket": rec["bucket"],
            "dispatch_s": rec["dispatch_s"],
            "sync_s": elapsed - rec["dispatch_s"],
            "pipelined_chunks": pipelined,
            # chunk-level timings are copied into every ticket's result in
            # this chunk; aggregators summing across results must divide
            # by wave_tickets or they double-count the chunk
            "wave_tickets": rec["k"],
        }
        if rec["shard"]:
            stats["sharded"] = True
            stats["shard_devices"] = rec["devices"]
        if rec["udf_rows"] is not None:
            stats["udf_rows"] = rec["udf_rows"]
        router = self.session.cost_router
        if router is not None:
            router.observe_many(self._query_fp, self.policy, rec["sig"],
                                rec["bucket"], elapsed, rec["k"],
                                shard=rec["shard"])

        def materialize(j: int) -> MaskedTable:
            (mask, cols), r = _row_of(parts, rec["bucket"], j)
            table = Table(
                {n: Column(data[r], valid[r], entry.out_dicts.get(n))
                 for n, (data, valid) in cols.items()}
            )
            return MaskedTable(table, mask[r])

        for j, i in enumerate(rec["idxs"]):
            results[i] = QueryResult(
                None, entry.plan, elapsed, dict(stats), policy=self.policy,
                cache_hit=rec["hit"],
                materialize=(lambda j=j: materialize(j)),
            )

    # -- async execution ---------------------------------------------------
    def execute_async(self, params: dict | None = None) -> AsyncResult:
        """Dispatch without waiting: the device work is queued, an event
        recorded after it, and a future returned at once; the wait is
        deferred to result access.  Policies with ``allow_async=False`` (or
        no compiled plan) degrade to synchronous execution behind the same
        interface.

        In-flight dispatches are bounded per session by
        ``policy.max_inflight``: at the bound, a new dispatch first waits
        for the oldest unsynced one (and ``AsyncResult.result()`` releases
        its slot), so a producer outrunning the device stalls instead of
        queueing unbounded work."""
        if self.policy.route and self.policy.compile_plan:
            target = self._route_target()
            if target is not self:
                return target.execute_async(params=params)
        if not (self.policy.compile_plan and self.policy.allow_async):
            return AsyncResult(self.execute(params=params))
        self.session._admit_async(self.policy.max_inflight)
        env_token = self.session._env_token()
        entry, exec_hit, plan_hit = self.session._executable(
            self.node, self._query_fp, self.policy, params, env_token
        )
        rows_before = entry.interp.rows_driven if entry.interp else 0
        t0 = time.perf_counter()
        self.session._fault("dispatch", (self._query_fp,))
        mask, cols = entry.fn(params, env_token[0])
        marker = self.session._marker()
        dispatch_s = time.perf_counter() - t0
        stats = {**entry.stats, "compiled": True, "async": True,
                 "dispatch_s": dispatch_s}
        if entry.interp is not None:
            stats["udf_rows"] = entry.interp.rows_driven - rows_before
        result: QueryResult

        def materialize() -> MaskedTable:
            t1 = time.perf_counter()
            if marker is not None:
                marker.synchronize()
            sync_s = time.perf_counter() - t1
            result.stats["sync_s"] = sync_s
            result.elapsed_s = dispatch_s + sync_s
            table = Table(
                {n: Column(data, valid, entry.out_dicts.get(n))
                 for n, (data, valid) in cols.items()}
            )
            return MaskedTable(table, mask)

        result = QueryResult(None, entry.plan, dispatch_s, stats,
                             policy=self.policy,
                             cache_hit=exec_hit and plan_hit,
                             materialize=materialize)
        ar = AsyncResult(result, marker=marker, session=self.session)
        self.session._inflight.append(ar)
        self.session.async_stats["inflight_peak"] = max(
            self.session.async_stats["inflight_peak"],
            len(self.session._inflight),
        )
        return ar

    def _execute_compiled(self, params) -> QueryResult:
        env_token = self.session._env_token()
        entry, exec_hit, plan_hit = self.session._executable(
            self.node, self._query_fp, self.policy, params, env_token
        )
        rows_before = entry.interp.rows_driven if entry.interp else 0
        t0 = time.perf_counter()
        self.session._fault("dispatch", (self._query_fp,))
        mask, cols = entry.fn(params, env_token[0])
        self.session._fault("sync", (self._query_fp,))
        self.session.synchronize()
        elapsed = time.perf_counter() - t0
        router = self.session.cost_router
        if router is not None:
            router.observe_serial(self._query_fp, self.policy, elapsed)
        table = Table(
            {n: Column(data, valid, entry.out_dicts.get(n))
             for n, (data, valid) in cols.items()}
        )
        stats = {**entry.stats, "compiled": True}
        if entry.interp is not None:
            stats["udf_rows"] = entry.interp.rows_driven - rows_before
        return QueryResult(MaskedTable(table, mask), entry.plan, elapsed, stats,
                           policy=self.policy,
                           cache_hit=exec_hit and plan_hit)

    def _execute_eager(self, params) -> QueryResult:
        plan, plan_hit = self.session._cached_plan(
            self.node, self._query_fp, self.policy
        )
        warm = plan_hit and self._executed_plan == _stamp(plan)
        self._executed_plan = _stamp(plan)
        device = self.session.device
        interp = self._eager_interp()
        executor = Executor(self.session.catalog,
                            udf_column_evaluator=interp.eval_udf_call,
                            use_pallas_agg=self.policy.pallas_agg, device=device)
        pvals = {n: _param_value(v, device) for n, v in (params or {}).items()}
        before, rows_before = dict(interp.stats), interp.rows_driven
        t0 = time.perf_counter()
        self.session._fault("interp", (self._query_fp,))
        masked = executor.execute(plan, params=pvals)
        self.session.synchronize()
        elapsed = time.perf_counter() - t0
        # interpreter stats are cumulative over the statement's lifetime;
        # report this execution's delta (which, as in the reference, also
        # stands for the executor's own logical reads)
        delta = {k: interp.stats[k] - before.get(k, 0) for k in interp.stats}
        stats = {**executor.stats, **delta,
                 "udf_rows": interp.rows_driven - rows_before}
        return QueryResult(masked, plan, elapsed, stats,
                           policy=self.policy, cache_hit=warm)
