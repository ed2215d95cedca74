"""Port of ``src/repro/fuse/program.py``: fused device programs — N
statements, one closure, shared scans + pooled parameter-unified
templates.

The fusion engine's back half.  Given the member descriptors the session
assembled (plan, parameter signature, batch bucket per member) plus the
merge pass's sharing maps, this module builds the single **raw closure**
the session runs for a fused wave.  Where the reference jits the closure
once and replays it, the port runs it eagerly on the device every wave:
its operators queue without a host sync.

1. rebuild the catalog from the table arguments — exactly as the
   per-statement closure in ``Session._executable`` does;
2. execute every shared **constant** subtree once, innermost-first, into a
   ``fingerprint -> MaskedTable`` pool — the pool build itself answers
   already-built entries, so a shared sub-subtree beneath two distinct
   shared roots evaluates once, not once per root (nested sharing);
3. execute every **parameter-unified template** once per distinct binding:
   the session passes, per pool group, a ``(d, ...)``-stacked binding
   argument for each canonical hole; the canonical template subtree runs
   ``d`` times in a Python loop (and only ``d`` — the eval counter asserts
   it) and the results stack into a slot-indexed pool;
4. ``torch.func.vmap`` each member's plan over its own stacked parameter
   axis, with a :class:`SharedScanExecutor` that answers marked constant
   subtrees from the pool and marked template occurrences by gathering
   the ticket's pool slot (a reserved ordinal-spelled slot parameter — see
   ``repro_torch.fuse.merge.slot_param`` — rides the stacked axis, so the
   gather's index is a batched 0-d tensor); the executor propagates itself
   into subquery/apply sub-evaluation (``Executor._vmap_outer_rows``), so
   sharing reaches *inside* correlated bodies;
5. return one ``(mask, columns)`` pair per member — the tagged fused
   result the session slices per-ticket.

Members with an empty parameter signature skip the batch axis entirely
(their tickets are all the same execution): the plan runs once, unbatched,
and every ticket shares the single result — mirroring ``execute_many``'s
parameter-free group handling.

The reference counts pool evaluations and scan statistics once, when it
traces the closure.  The port's closure runs every wave, so it clears the
evaluation counter and rebuilds the stats at the start of each run: after
any wave they read as the reference's trace-time figures.
"""
from __future__ import annotations

import torch

from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.core.executor import Executor, MaskedTable, _take
from repro_torch.core.interpreter import Interpreter
from repro_torch.fuse.merge import merge_plans
from repro_torch.tables.table import Column, Table

#: reserved stacked-parameter name (filtered out before the executor binds
#: params) — kept for callers that need a dummy batch axis; the leading
#: underscores keep it out of any legal identifier's way
FUSE_PAD = "__fuse_pad__"


class SharedScanExecutor(Executor):
    """An :class:`Executor` that serves marked subtrees from the fused
    program's shared pools instead of re-executing them.

    ``shared_ids`` is the merge pass's ``node_id -> fingerprint`` map and
    ``shared_results`` the constant pool built in step 2 of the fused
    closure (passed by reference: during the pool build itself it is
    partially filled, which is what makes nested sharing work).
    ``template_ids`` maps occurrence ``node_id -> pool-group index``,
    ``template_results`` holds the slot-stacked template pools, and
    ``slot_names`` maps occurrence ``node_id -> reserved slot-parameter
    name``; the occurrence's slot index arrives through that reserved
    parameter.  Any unmarked node executes normally — including
    everything *inside* a shared subtree, which only ever runs under the
    pool build.

    ``eval_counts`` (shared with every sub-executor) counts pool
    evaluations per key — the instrumentation behind the CSE metamorphic
    tests: a template with ``d`` distinct bindings must log exactly ``d``.
    """

    def __init__(self, catalog, shared_ids, shared_results,
                 template_ids=None, template_results=None,
                 slot_names=None, eval_counts=None, **kwargs):
        super().__init__(catalog, **kwargs)
        self._shared_ids = shared_ids
        self._shared_results = shared_results
        self._template_ids = template_ids or {}
        self._template_results = template_results if template_results is not None else {}
        self._slot_names = slot_names or {}
        self.eval_counts = eval_counts if eval_counts is not None else {}

    def execute_pooled(self, key, node, params=None) -> MaskedTable:
        """One pool evaluation (a constant subtree, or a template under one
        distinct binding), logged in ``eval_counts``."""
        self.eval_counts[key] = self.eval_counts.get(key, 0) + 1
        return self.execute(node, params=params)

    def _sub_executor(self):
        # subquery / correlated-apply sub-evaluation keeps answering from
        # the pools: sharing reaches inside nested plan bodies
        return SharedScanExecutor(
            self.catalog, self._shared_ids, self._shared_results,
            template_ids=self._template_ids,
            template_results=self._template_results,
            slot_names=self._slot_names,
            eval_counts=self.eval_counts,
            udf_column_evaluator=self.udf_column_evaluator,
            use_pallas_agg=self.use_pallas_agg,
            device=self.device,
        )

    def _exec(self, node, ctx, memo):
        gi = self._template_ids.get(node.node_id)
        if gi is not None:
            hit = self._template_results.get(gi)
            name = self._slot_names.get(node.node_id)
            slot = ctx.params.get(name) if name is not None else None
            if hit is not None and slot is not None:
                mask_stack, col_stacks, dicts = hit
                # a 0-d slot index, batched under the member's vmap:
                # index_select has a batching rule for it (no per-example
                # fallback, no host read of the index)
                idx = slot.data
                cols = {
                    c: Column(_take(data, idx), _take(valid, idx), dicts.get(c))
                    for c, (data, valid) in col_stacks.items()
                }
                return MaskedTable(Table(cols), _take(mask_stack, idx))
        fp = self._shared_ids.get(node.node_id)
        if fp is not None:
            hit = self._shared_results.get(fp)
            if hit is not None:
                return hit
        return super()._exec(node, ctx, memo)


def _plans_have_udf_calls(plans) -> bool:
    return any(
        isinstance(e, S.UdfCall)
        for p in plans
        for n in R.walk_plan_deep(p)
        for ex in n.exprs()
        for e in S.walk(ex)
    )


def build_fused_raw(session, members, policy, merged=None, groups=(),
                    member_tmaps=(), slot_names=(), device=None):
    """Build the fused raw closure for ``members`` (see module docstring),
    running on ``device`` (default: the session's; a shard's otherwise,
    reading the session's catalog replica there).

    ``groups`` are the session's template pool groups (canonical node,
    hole names/dictionaries, one per (template, binding-signature)),
    ``member_tmaps`` maps each member's occurrence ``node_id`` to its
    group index, and ``slot_names`` maps it to its canonical reserved
    slot-parameter name — all computed host-side in
    ``Session._run_fused`` from the actual ticket bindings, so the
    closure only holds structure, never values (the stacked binding
    tensors arrive as arguments).

    Returns ``(raw, out_dicts, run_stats, merged, eval_counts)``: the
    closure, the per-member output-dictionary captures, the stats dict
    (both filled by each run), the :class:`~repro_torch.fuse.merge.FusedPlan`,
    and the pool-evaluation counter dict (this run's evaluations).
    """
    plans = [m.plan for m in members]
    if merged is None:
        merged = merge_plans(plans)

    # iterative hook for UDF calls left in the plans (froid OFF / hybrid);
    # 'scan' mode is the only interpreter that runs inside a vmapped plan
    # (see Session._executable)
    hook = None
    device = session.device if device is None else device
    if _plans_have_udf_calls(plans):
        interp = Interpreter(session._catalog_on(device)[1], session.registry,
                             mode="scan", device=device)
        hook = interp.eval_udf_call

    meta = {
        tname: {c: col.dictionary for c, col in t.columns.items()}
        for tname, t in session.catalog.items()
    }
    out_dicts: list[dict] = [{} for _ in members]
    run_stats: dict = {}
    eval_counts: dict = {}

    def raw(table_args, pargs_tuple, targs_tuple):
        eval_counts.clear()  # this run's pool evaluations only
        catalog = {
            tname: Table(
                {
                    c: Column(data, valid, meta[tname][c])
                    for c, (data, valid) in cols.items()
                }
            )
            for tname, cols in table_args.items()
        }
        # step 2: the constant pool — each distinct cross-statement subtree
        # executes once, outside every member's vmap.  The pool dict is
        # shared by reference with the pool executor, and entries are built
        # innermost-first, so outer shared subtrees answer their shared
        # descendants from the pool instead of re-evaluating them.
        shared_results: dict = {}
        pool_ex = SharedScanExecutor(
            catalog, merged.shared_ids, shared_results,
            eval_counts=eval_counts,
            udf_column_evaluator=hook, use_pallas_agg=policy.pallas_agg,
            device=device,
        )
        for fp, sub in merged.shared:
            shared_results[fp] = pool_ex.execute_pooled(fp, sub)
        # step 3: template pools — the canonical subtree evaluates once per
        # distinct binding (d is the stacked binding tensors' leading axis)
        template_results: dict = {}
        for gi, g in enumerate(groups):
            targ = targs_tuple[gi]
            d = next(iter(targ.values()))[0].shape[0]
            entries = []
            for j in range(d):
                pv = {
                    h: S.Value(data[j], valid[j], g.hole_dicts.get(h))
                    for h, (data, valid) in targ.items()
                }
                entries.append(pool_ex.execute_pooled((g.fp, g.sig), g.node,
                                                      params=pv))
            cols0 = entries[0].table.columns
            template_results[gi] = (
                torch.stack([e.mask for e in entries]),
                {
                    c: (torch.stack([e.table.columns[c].data for e in entries]),
                        torch.stack([e.table.columns[c].validity()
                                     for e in entries]))
                    for c in cols0
                },
                {c: col.dictionary for c, col in cols0.items()},
            )
        scanned = pool_ex.stats
        outs = []
        for i, (m, pargs) in enumerate(zip(members, pargs_tuple)):
            # hoisted out of the vmapped per-ticket closure (executor state
            # is batch-independent)
            ex = SharedScanExecutor(
                catalog, merged.shared_ids, shared_results,
                template_ids=member_tmaps[i] if member_tmaps else {},
                template_results=template_results,
                slot_names=slot_names[i] if slot_names else {},
                eval_counts=eval_counts,
                udf_column_evaluator=hook, use_pallas_agg=policy.pallas_agg,
                device=device,
            )

            def one(pa, i=i, m=m, ex=ex):
                pvals = {
                    name: S.Value(data, valid, m.pdicts.get(name))
                    for name, (data, valid) in pa.items()
                    if name != FUSE_PAD
                }
                out = ex.execute(m.plan, params=pvals)
                for cname, c in out.table.columns.items():
                    out_dicts[i][cname] = c.dictionary  # host metadata
                cols = {
                    cname: (c.data, c.validity())
                    for cname, c in out.table.columns.items()
                }
                return out.mask, cols

            if m.sig:
                outs.append(torch.func.vmap(one)(pargs))
            else:
                # parameter-free member: one unbatched execution serves
                # every ticket (no per-ticket slicing at delivery); pargs
                # carries only reserved slot params for const-bound
                # template occurrences, if any
                outs.append(one(pargs))
            for k, v in ex.stats.items():
                scanned[k] = scanned.get(k, 0) + v
        run_stats.clear()
        run_stats.update(scanned)
        run_stats.update(merged.stats)
        run_stats["cse_pool_evals"] = sum(eval_counts.values())
        return tuple(outs)

    return raw, out_dicts, run_stats, merged, eval_counts
