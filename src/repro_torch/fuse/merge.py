"""Port of ``src/repro/fuse/merge.py``: a copy (host only).

Plan-merge pass: cross-statement CSE over the members of a fused program.

The fusion engine's front half.  Given the bound+optimized plans of the
statements a fused program will carry, this pass finds the work they have
in common so the back half (:mod:`repro_torch.fuse.program`) computes it once.
Three sharing tiers, all keyed by canonical structural fingerprints:

* **Constant subtrees** — no ``Param``/``Outer``/``Var`` references and no
  non-deterministic intrinsics anywhere below (including inside nested
  subquery plans).  Their result depends only on catalog state, which every
  member sees identically, so each distinct fingerprint executes **once**
  into the shared pool.  *Every* shared occurrence is marked, not only
  maximal ones: the pool is built innermost-first, so a shared sub-subtree
  beneath two distinct shared roots evaluates once and both roots' pool
  builds answer it from the pool (nested sharing).
* **Parameter-unified templates** — subtrees equal *modulo parameter
  slots* (:func:`repro_torch.core.fingerprint.parametric_fingerprint`) unify into one
  templated subtree with canonical holes.  The fused program evaluates a
  template once per **distinct binding** of its holes across all tickets of
  all members (a binding → pool-slot map, built host-side in
  ``Session._run_fused``), and each member's trace answers its occurrence
  by gathering its ticket's slot.  Const-vs-param unification rides the
  same tier: when a *lifted* fingerprint group (liftable literal constants
  also canonicalized to holes) mixes a param-shaped and a const-shaped
  occurrence, the whole group promotes to one lifted template and ``a < 5``
  joins the ``a < Param(x)`` pool as one more distinct binding — when a
  ticket binds ``x = 5`` they dedup to a single evaluation.
* **Correlated templates** — subtrees whose only extra references are
  ``Outer`` slots (correlated-subquery bodies differing in their outer
  binding) unify through the same template path: one canonical identity in
  the merge stats, cache keys and explain output.  Their *evaluation* stays
  per member (outer bindings are whole columns, not host-enumerable
  values), but constant/param-unified subtrees *inside* them dedup via the
  tiers above — the sub-executor propagation in ``repro_torch.fuse.program``
  carries the pool into nested subquery evaluation.

The output is a :class:`FusedPlan`; ``explain()`` renders which subtrees
were shared and under which template.  Still out of scope (ROADMAP):
binding-pooled evaluation of templates nested inside other templates.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import optimizer as O
from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.core.fingerprint import (
    const_hole_key,
    liftable_const,
    parametric_fingerprint,
    plan_fingerprint,
)
from repro_torch.core.optimizer import _rewrite_exprs

#: every relalg node the executor can run is side-effect free; anything
#: else (a future effectful node, a foreign plan object) blocks fusion.
#: LoopScan qualifies: its child scan, carry inits, and step/reduction
#: expressions are all pure (the loop rewrite pass rejects everything else)
PURE_NODES = (
    R.Scan, R.ConstantScan, R.Compute, R.Project, R.Filter,
    R.Join, R.Apply, R.GroupAgg, R.Sort, R.LoopScan,
)

#: template_binds marker for a hole bound by a lifted literal constant
#: rather than an actual parameter name: ``(CONST_BIND, value)``
CONST_BIND = "__const__"

#: canonical spelling of template hole ``i`` — the parameter name the
#: canonical template subtree is evaluated under in the binding pool
CSE_HOLE = "__cse_s{}"

#: reserved per-ticket parameter carrying a template occurrence's pool-slot
#: index through the stacked parameter axis (one per occurrence).  Spelled
#: by the occurrence's *ordinal* within its member's canonical occurrence
#: walk — a content-derived name, identical in every process, so fused
#: programs carrying slot parameters round-trip through the persistent
#: plan tier.
SLOT_PARAM = "__cse_slot_o{}"


def hole_name(i: int) -> str:
    return CSE_HOLE.format(i)


def slot_param(ordinal: int) -> str:
    """Reserved slot-parameter name of occurrence ``ordinal`` (its index
    in the member's deterministic maximal-occurrence walk)."""
    return SLOT_PARAM.format(ordinal)


def plan_is_pure(plan: R.RelNode) -> bool:
    """True when every node of ``plan`` — including nodes of nested
    subquery plans — is a known side-effect-free operator; the fusability
    analysis's safety gate."""
    return all(isinstance(n, PURE_NODES) for n in R.walk_plan_deep(plan))


def subtree_shape(node: R.RelNode) -> str | None:
    """Shareability class of the subtree: ``"const"`` (no external
    references at all), ``"param"`` (query parameters only — pool-eligible
    after unification), ``"corr"`` (outer-row references, possibly plus
    parameters — template identity only), or ``None`` (unbound UDF locals
    or non-deterministic intrinsics like ``rand()``, which must evaluate
    per statement, never once per pool)."""
    has_param = has_outer = False
    for n in R.walk_plan_deep(node):
        for e in n.exprs():
            for s in S.walk(e):
                if isinstance(s, S.Var):
                    return None
                if isinstance(s, S.Func) and s.name in S.Func.NON_DETERMINISTIC:
                    return None
                if isinstance(s, S.Param):
                    has_param = True
                elif isinstance(s, S.Outer):
                    has_outer = True
    if has_outer:
        return "corr"
    return "param" if has_param else "const"


def subtree_is_constant(node: R.RelNode) -> bool:
    """True when the subtree's result depends only on catalog state (see
    :func:`subtree_shape`)."""
    return subtree_shape(node) == "const"


def rewrite_params(plan: R.RelNode, mapping: dict[str, str]) -> R.RelNode:
    """Deep-rename ``Param`` references per ``mapping`` (actual name →
    canonical hole name), descending into nested subquery plans.  Identity
    is preserved for untouched subtrees, so constant shared descendants of
    a rewritten template keep their ``node_id`` marks."""

    def fix_scalar(x):
        if isinstance(x, S.Param) and x.name in mapping:
            return S.Param(mapping[x.name])
        if isinstance(x, S.ScalarSubquery):
            p2 = rewrite_params(x.plan, mapping)
            if p2 is not x.plan:
                return S.ScalarSubquery(p2, x.column, x.agg_default)
        if isinstance(x, S.Exists):
            p2 = rewrite_params(x.plan, mapping)
            if p2 is not x.plan:
                return S.Exists(p2, x.negated)
        return None

    def fix_node(n):
        changed = False

        def fe(e):
            nonlocal changed
            e2 = S.transform(e, fix_scalar)
            changed = changed or (e2 is not e)
            return e2

        n2 = _rewrite_exprs(n, fe)
        return n2 if changed else None

    return R.transform_plan(plan, fix_node)


def rewrite_lifted(plan: R.RelNode, holes: tuple) -> R.RelNode:
    """Rewrite one occurrence into the canonical *lifted*-template subtree:
    ``Param`` references **and** liftable literal constants both become
    canonical hole ``Param``s, per the occurrence's lifted hole signature
    (``(kind, name_or_key)`` tuples from ``parametric_fingerprint(...,
    lift_consts=True)``)."""
    pmap: dict[str, str] = {}
    cmap: dict[tuple, str] = {}
    for i, (kind, key) in enumerate(holes):
        if kind == "param":
            pmap[key] = hole_name(i)
        else:
            cmap[key] = hole_name(i)

    def fix_scalar(x):
        if isinstance(x, S.Param) and x.name in pmap:
            return S.Param(pmap[x.name])
        if liftable_const(x):
            h = cmap.get(const_hole_key(x.value))
            if h is not None:
                return S.Param(h)
        if isinstance(x, S.ScalarSubquery):
            p2 = rewrite_lifted(x.plan, holes)
            if p2 is not x.plan:
                return S.ScalarSubquery(p2, x.column, x.agg_default)
        if isinstance(x, S.Exists):
            p2 = rewrite_lifted(x.plan, holes)
            if p2 is not x.plan:
                return S.Exists(p2, x.negated)
        return None

    def fix_node(n):
        changed = False

        def fe(e):
            nonlocal changed
            e2 = S.transform(e, fix_scalar)
            changed = changed or (e2 is not e)
            return e2

        n2 = _rewrite_exprs(n, fe)
        return n2 if changed else None

    return R.transform_plan(plan, fix_node)


@dataclasses.dataclass
class SharedTemplate:
    """One parameter-unified shared subtree (pool-eligible: param holes
    only).  ``node`` is the canonical subtree with its parameters renamed
    to the canonical hole spelling; evaluating it under
    ``params={holes[i]: binding[i]}`` reproduces any occurrence."""

    fp: tuple  # canonical parametric fingerprint (unification key)
    node: R.RelNode  # canonical subtree, params renamed to hole names
    holes: tuple  # canonical hole parameter names, slot order
    refs: int  # occurrences across all members


@dataclasses.dataclass
class FusedPlan:
    """The merge pass's product (see module docstring)."""

    members: list  # member plans, fusion order
    shared: list  # [(fp, canonical subtree)] const pool, innermost-first
    shared_ids: dict  # node_id -> fp, every shared-const occurrence
    templates: list  # [SharedTemplate], first-appearance order
    template_ids: dict  # node_id -> template fp, every occurrence
    template_binds: dict  # node_id -> {hole name -> actual param name}
    corr_ids: dict  # node_id -> template fp, correlated occurrences
    stats: dict  # merge-level counters (shared_subtrees, cse_*, ...)

    def explain(self) -> str:
        """Human-readable sharing report: every shared subtree / template,
        its reference count, and the subtree itself.  Memoized — the
        serving drain path attaches it to every warm wave's stats, and a
        FusedPlan is immutable once built."""
        cached = getattr(self, "_explain_cache", None)
        if cached is not None:
            return cached
        text = self._explain_cache = self._explain()
        return text

    def _explain(self) -> str:
        out = [f"fused members: {len(self.members)}"]
        refs: dict[tuple, int] = {}
        for fp in self.shared_ids.values():
            refs[fp] = refs.get(fp, 0) + 1
        out.append(f"shared constant subtrees ({len(self.shared)}, "
                   "evaluate once into the pool):")
        for i, (fp, node) in enumerate(self.shared):
            out.append(f"  [S{i}] x{refs.get(fp, 0)} refs")
            out.append(_indent(O.explain(node), 2))
        out.append(f"parameter-unified templates ({len(self.templates)}, "
                   "evaluate once per distinct binding):")
        for i, t in enumerate(self.templates):
            # key=repr: const-bind markers are tuples, param binds are
            # strings — not mutually comparable
            binds = sorted(
                (tuple(sorted(b.items()))
                 for nid, b in self.template_binds.items()
                 if self.template_ids[nid] == t.fp),
                key=repr,
            )
            out.append(f"  [T{i}] holes={list(t.holes)} x{t.refs} refs; "
                       f"bindings {binds}")
            out.append(_indent(O.explain(t.node), 2))
        corr: dict[tuple, int] = {}
        for fp in self.corr_ids.values():
            corr[fp] = corr.get(fp, 0) + 1
        if corr:
            out.append(f"correlated templates ({len(corr)}, unified "
                       "identity; evaluated per member):")
            for i, (fp, n) in enumerate(sorted(corr.items(), key=repr)):
                out.append(f"  [C{i}] x{n} refs")
        return "\n".join(out)


def _indent(text: str, by: int) -> str:
    pad = "  " * by
    return "\n".join(pad + line for line in text.splitlines())


def _deep_size(node: R.RelNode, memo: dict) -> int:
    s = memo.get(node.node_id)
    if s is None:
        s = sum(1 for _ in R.walk_plan_deep(node))
        memo[node.node_id] = s
    return s


def merge_plans(plans: list) -> FusedPlan:
    """Merge ``plans`` into one fused-program description.

    Two passes: classify and count every shareable subtree fingerprint
    across all members (a fingerprint occurring twice — in two members, or
    twice within one — is worth computing once), then mark occurrences and
    compute coverage stats top-down (a marked node's descendants execute
    inside its one shared evaluation, so only maximal marks count toward
    ``cse_shared_nodes``)."""
    info: dict[int, tuple | None] = {}  # node_id -> (shape, fp, holes)|None
    linfo: dict[int, tuple] = {}  # node_id -> (lifted fp, lifted holes)
    occurrences: dict[tuple, int] = {}
    loccur: dict[tuple, int] = {}  # lifted fp -> occurrence count
    lshapes: dict[tuple, set] = {}  # lifted fp -> shapes seen in the group
    canonical: dict[tuple, R.RelNode] = {}  # plain AND lifted fps (disjoint)
    appearance: dict[tuple, int] = {}  # fp -> first-appearance index

    for plan in plans:
        for n in R.walk_plan_deep(plan):
            ent = info.get(n.node_id, "unseen")
            if ent == "unseen":
                shape = subtree_shape(n)
                if shape is None:
                    ent = None
                else:
                    fp, holes = parametric_fingerprint(n)
                    ent = (shape, fp, holes)
                    if shape in ("param", "const"):
                        lfp, lholes = parametric_fingerprint(
                            n, lift_consts=True)
                        if lholes:
                            linfo[n.node_id] = (lfp, lholes)
                info[n.node_id] = ent
            if ent is not None:
                fp = ent[1]
                occurrences[fp] = occurrences.get(fp, 0) + 1
                canonical.setdefault(fp, n)
                appearance.setdefault(fp, len(appearance))
                lent = linfo.get(n.node_id)
                if lent is not None:
                    lfp = lent[0]
                    loccur[lfp] = loccur.get(lfp, 0) + 1
                    lshapes.setdefault(lfp, set()).add(ent[0])
                    canonical.setdefault(lfp, n)
                    appearance.setdefault(lfp, len(appearance))

    shared_fps = {fp for fp, c in occurrences.items() if c >= 2}
    # const-vs-param promotion: a lifted group earns a template only when
    # it actually unifies across the const/param divide — all-param groups
    # are already plain-unified, and all-const groups are better served by
    # the constant pool (per-value, no binding machinery)
    promoted = {
        lfp for lfp, c in loccur.items()
        if c >= 2 and "param" in lshapes[lfp] and "const" in lshapes[lfp]
    }

    # occurrence maps (every shared occurrence — the pool build answers
    # nested ones; member traces are intercepted at the topmost mark)
    shared_ids: dict[int, tuple] = {}
    template_ids: dict[int, tuple] = {}
    template_binds: dict[int, dict] = {}
    corr_ids: dict[int, tuple] = {}
    for nid, ent in info.items():
        if ent is None:
            continue
        shape, fp, holes = ent
        lent = linfo.get(nid)
        if lent is not None and lent[0] in promoted:
            lfp, lholes = lent
            template_ids[nid] = lfp
            template_binds[nid] = {
                hole_name(i): (name if kind == "param"
                               else (CONST_BIND, name[1]))
                for i, (kind, name) in enumerate(lholes)
            }
            continue
        if fp not in shared_fps:
            continue
        if shape == "const":
            shared_ids[nid] = fp
        elif shape == "param":
            template_ids[nid] = fp
            template_binds[nid] = {
                hole_name(i): name for i, (_, name) in enumerate(holes)
            }
        else:  # corr — unified identity only
            corr_ids[nid] = fp

    size_memo: dict[int, int] = {}
    # const pool, innermost-first: a proper subtree is strictly smaller
    # than its parent, so ascending size puts shared children before the
    # shared roots whose pool build answers them
    const_fps = sorted(
        {fp for fp in shared_ids.values()},
        key=lambda fp: (_deep_size(canonical[fp], size_memo), appearance[fp]),
    )
    shared = [(fp, canonical[fp]) for fp in const_fps]

    templates: list[SharedTemplate] = []
    for fp in sorted({fp for fp in template_ids.values()},
                     key=lambda fp: appearance[fp]):
        occ = canonical[fp]
        if fp in promoted:  # lifted template: consts become holes too
            _, lholes = linfo[occ.node_id]
            node = rewrite_lifted(occ, lholes)
            nholes = len(lholes)
        else:
            _, _, holes = info[occ.node_id]
            mapping = {name: hole_name(i) for i, (_, name) in enumerate(holes)}
            node = rewrite_params(occ, mapping)
            nholes = len(holes)
        templates.append(SharedTemplate(
            fp,
            node,
            tuple(hole_name(i) for i in range(nholes)),
            sum(1 for f in template_ids.values() if f == fp),
        ))

    # coverage stats: maximal marks only — descendants of a marked node
    # execute inside its one shared evaluation
    counters = {"const_refs": 0, "template_refs": 0, "covered": 0}

    maximal_const_fps: set = set()

    def mark(n: R.RelNode) -> None:
        nid = n.node_id
        if nid in shared_ids:
            counters["const_refs"] += 1
            maximal_const_fps.add(shared_ids[nid])
            counters["covered"] += _deep_size(n, size_memo)
            return
        if nid in template_ids:
            counters["template_refs"] += 1
            counters["covered"] += _deep_size(n, size_memo)
            return
        for p in R.embedded_plans(n):
            mark(p)
        for c in n.children():
            mark(c)

    for plan in plans:
        mark(plan)

    pool_nodes = [n for _, n in shared] + [t.node for t in templates]
    total_scans = sum(
        1 for p in plans for n in R.walk_plan_deep(p) if isinstance(n, R.Scan)
    )
    shared_scan_nodes = sum(
        1 for sub in pool_nodes for n in R.walk_plan_deep(sub)
        if isinstance(n, R.Scan)
    )
    stats = {
        "fused_members": len(plans),
        "shared_subtrees": len(shared),
        # maximal marked references across members; refs minus the count
        # of *distinct maximal* fingerprints = evaluations the fused
        # program skips vs the per-statement path (shared_subtrees counts
        # every pooled fingerprint, nested ones included, so it is the
        # wrong subtrahend for that arithmetic)
        "shared_refs": counters["const_refs"],
        "shared_maximal_subtrees": len(maximal_const_fps),
        "cse_templates": len(templates),
        "cse_template_refs": counters["template_refs"],
        # lifted (const-vs-param unified) templates among cse_templates
        "cse_lifted_templates": sum(1 for t in templates
                                    if t.fp in promoted),
        "cse_corr_templates": len({fp for fp in corr_ids.values()}),
        "cse_corr_refs": len(corr_ids),
        # plan nodes (deep) covered by a shared evaluation — the engine's
        # sharing coverage; adding an overlapping member never decreases it
        "cse_shared_nodes": counters["covered"],
        "total_scans": total_scans,
        "shared_scan_nodes": shared_scan_nodes,
    }
    return FusedPlan(list(plans), shared, shared_ids, templates,
                     template_ids, template_binds, corr_ids, stats)


__all__ = [
    "CONST_BIND",
    "CSE_HOLE",
    "FusedPlan",
    "PURE_NODES",
    "SLOT_PARAM",
    "SharedTemplate",
    "hole_name",
    "merge_plans",
    "plan_fingerprint",
    "plan_is_pure",
    "rewrite_lifted",
    "rewrite_params",
    "slot_param",
    "subtree_is_constant",
    "subtree_shape",
]
