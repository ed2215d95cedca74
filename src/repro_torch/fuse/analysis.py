"""Port of ``src/repro/fuse/analysis.py``: a copy (host only).

Fusability analysis: which calls of a mixed-statement queue may share
one fused device program, and which must fall back.

A call ``(stmt, params)`` is **fusable** when:

* the statement belongs to the session doing the fusing (a foreign
  session has its own catalog/registry state — its calls fall back to
  that session's own per-statement path);
* its policy compiles whole plans (eager policies have no device program
  to merge) and has ``fuse`` enabled;
* its bound plan is side-effect free (:func:`repro_torch.fuse.merge.plan_is_pure`
  — true of every operator the executor knows today; the gate exists so a
  future effectful node degrades to the per-statement path instead of
  silently re-ordering effects across statements).

Fusable calls group by **compatible policy**: equal identity fingerprints
(the plans must agree on inlining/optimization/compilation) and equal
sharding placement (one fused program has one mesh layout).  Groups wider
than ``policy.max_fused_statements`` distinct statements split — and the
split considers **template overlap**: statements are chunked greedily so
that those sharing subtree/template fingerprints (the CSE engine's
sharing currency, :func:`shareable_fingerprints`) land in the same fused
program, instead of whatever first-appearance order the queue happened to
arrive in.  A split remainder (or a group) holding a single distinct
statement gains nothing from fusion and falls back to ``execute_many``.
"""
from __future__ import annotations

from repro_torch.core import relalg as R
from repro_torch.core.fingerprint import parametric_fingerprint
from repro_torch.fuse.merge import plan_is_pure, subtree_shape


def fusion_group_key(stmt) -> tuple:
    """Compatibility key: calls fuse only within one of these."""
    p = stmt.policy
    return (p.fingerprint(), p.shard_devices(), p.shard_token())


def _plan_pure_cached(stmt) -> bool:
    """Purity of the statement's *current* plan, memoized per plan object
    (the plan changes identity on DDL, refreshing the verdict; the walk
    itself must not run once per ticket on the drain hot path)."""
    plan = stmt._ensure_plan()
    cached = getattr(stmt, "_fuse_pure", None)
    if cached is not None and cached[0] is plan:
        return cached[1]
    ok = plan_is_pure(plan)
    stmt._fuse_pure = (plan, ok)
    return ok


def is_fusable(session, stmt) -> bool:
    """Per-statement gate (see module docstring)."""
    if stmt.session is not session:
        return False
    p = stmt.policy
    if not (p.compile_plan and p.fuse):
        return False
    return _plan_pure_cached(stmt)


def shareable_fingerprints(stmt) -> frozenset:
    """Canonical fingerprints of every shareable subtree of the statement's
    current plan — constant subtrees, parameter-unified templates and
    correlated templates alike (the things the merge pass can dedup when
    another member brings a matching one).  Memoized per plan object, like
    the purity verdict — the classification deliberately repeats what
    merge_plans will do (only on the cold path, and only when a group is
    wide enough to split); sharing a per-node memo with the merge pass is
    not worth coupling the two layers yet."""
    plan = stmt._ensure_plan()
    cached = getattr(stmt, "_fuse_fps", None)
    if cached is not None and cached[0] is plan:
        return cached[1]
    fps = set()
    for n in R.walk_plan_deep(plan):
        if subtree_shape(n) is not None:
            fps.add(parametric_fingerprint(n)[0])
    out = frozenset(fps)
    stmt._fuse_fps = (plan, out)
    return out


def shareable_fingerprint_costs(session, stmt) -> dict:
    """``fp -> estimated per-execution seconds`` of each shareable subtree
    of the statement's plan — the cost model's chunking weight: sharing an
    aggregate over a big scan saves real work, sharing a literal filter
    saves almost none, and the greedy splitter should know the
    difference.  Memoized per plan object like the fingerprint set."""
    plan = stmt._ensure_plan()
    cached = getattr(stmt, "_fuse_fpw", None)
    if cached is not None and cached[0] is plan:
        return cached[1]
    from repro_torch.cost.model import estimate_node_s

    weights: dict = {}
    for n in R.walk_plan_deep(plan):
        if subtree_shape(n) is not None:
            fp = parametric_fingerprint(n)[0]
            if fp not in weights:
                weights[fp] = estimate_node_s(n, session.catalog)
    stmt._fuse_fpw = (plan, weights)
    return weights


def _overlap_order(order: list, fp_sets: dict, cap: int,
                   weights: dict | None = None) -> list:
    """Reorder distinct-statement fingerprints so overlap-sharing
    statements chunk together: greedy — seed each chunk with the earliest
    unplaced statement, then repeatedly pull the unplaced statement with
    the largest fingerprint overlap against the chunk's accumulated set
    (earliest arrival breaks ties, keeping the result deterministic).
    With ``weights`` (fp → estimated seconds), overlap is scored by the
    estimated work the sharing avoids instead of a bare fingerprint
    count — two statements sharing one expensive aggregate chunk together
    ahead of two sharing three trivial literals."""
    remaining = list(order)
    out: list = []
    while remaining:
        chunk = [remaining.pop(0)]
        acc = set(fp_sets.get(chunk[0], ()))
        while len(chunk) < cap and remaining:
            best_i, best_n = 0, -1.0
            for i, fp in enumerate(remaining):
                shared = acc & fp_sets.get(fp, frozenset())
                if weights is not None:
                    n = sum(weights.get(f, 0.0) for f in shared)
                else:
                    n = len(shared)
                if n > best_n:
                    best_i, best_n = i, n
            pick = remaining.pop(best_i)
            chunk.append(pick)
            acc |= fp_sets.get(pick, frozenset())
        out.extend(chunk)
    return out


def partition_calls(session, calls):
    """Split an indexed call list into fused groups and fallbacks.

    ``calls`` is ``[(stmt, params), ...]``; returns ``(groups, fallbacks)``
    where each group is ``[(index, stmt, params), ...]`` destined for one
    fused program, and ``fallbacks`` is ``[(stmt, [(index, params), ...])]``
    in first-appearance order for the per-statement path.  Input order is
    carried by the indices; callers scatter results back through them.
    """
    fallback_by_stmt: dict[int, tuple] = {}  # id(stmt) -> (stmt, items)
    grouped: dict[tuple, list] = {}
    verdicts: dict[int, tuple | None] = {}  # id(stmt) -> group key | fallback

    def fall_back(idx, stmt, params):
        ent = fallback_by_stmt.get(id(stmt))
        if ent is None:
            ent = fallback_by_stmt[id(stmt)] = (stmt, [])
        ent[1].append((idx, params))

    for idx, (stmt, params) in enumerate(calls):
        # one fusability verdict + group key per distinct statement, not
        # per ticket (queues repeat statements thousands of times)
        v = verdicts.get(id(stmt), "unseen")
        if v == "unseen":
            v = (fusion_group_key(stmt) if is_fusable(session, stmt)
                 else None)
            verdicts[id(stmt)] = v
        if v is not None:
            grouped.setdefault(v, []).append((idx, stmt, params))
        else:
            fall_back(idx, stmt, params)

    groups = []
    for items in grouped.values():
        # distinct statements in first-appearance order
        order: list[tuple] = []
        by_fp: dict[tuple, list] = {}
        for idx, stmt, params in items:
            fp = stmt._query_fp
            if fp not in by_fp:
                by_fp[fp] = []
                order.append(fp)
            by_fp[fp].append((idx, stmt, params))
        cap = max(1, min(s.policy.max_fused_statements for _, s, _ in items))
        if len(order) > cap:
            # the group must split: chunk overlap-sharing statements
            # together so the CSE engine has something to dedup per
            # program, weighing each shared fingerprint by its estimated
            # cost (cost-aware chunking — see shareable_fingerprint_costs)
            fp_sets = {fp: shareable_fingerprints(by_fp[fp][0][1])
                       for fp in order}
            weights: dict = {}
            for fp in order:
                for f, w in shareable_fingerprint_costs(
                        session, by_fp[fp][0][1]).items():
                    if f not in weights:
                        weights[f] = w
            order = _overlap_order(order, fp_sets, cap, weights)
        for s in range(0, len(order), cap):
            chunk_fps = order[s:s + cap]
            chunk = [it for fp in chunk_fps for it in by_fp[fp]]
            if len(chunk_fps) < 2:
                # fusing one statement is the per-statement path with extra
                # steps — route it there directly
                for idx, stmt, params in chunk:
                    fall_back(idx, stmt, params)
            else:
                groups.append(chunk)
    return groups, list(fallback_by_stmt.values())
