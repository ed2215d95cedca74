"""Port of ``src/repro/cost/model.py``: a copy (host only, no device
work) with the H100's peaks in place of ``repro.launch.roofline``'s TPU
ones — 989e12 FLOP/s (dense bf16 on the tensor cores) and 3.35e12 B/s of
HBM3, the figures ``chip_smoke.py``'s bounds use.

Static cost estimates per (plan, configuration).

The estimator walks a bound plan bottom-up carrying textbook cardinality
rules (catalog row counts at the leaves, fixed selectivities at the
predicates) and accumulates a roofline-style work profile — scalar flops
and bytes touched — which :class:`PlanProfile.seconds` turns into a time
estimate using :data:`PEAK_FLOPS` and :data:`HBM_BW`.  Absolute numbers
are nominal for the card, not this host; callers only ever compare
estimates against each other, so the *ratios* are what matter:

* a per-row interpreted UDF call costs a large per-row penalty relative
  to inlined arithmetic — the FROID-vs-HEKATON axis;
* a cold configuration pays an estimated compile cost proportional to
  plan size, dwarfing one wave of padded compute — the ride-a-warm-bucket
  axis;
* every dispatched program pays a fixed launch overhead — the
  fuse-or-not axis (one fused program saves per-statement dispatches).

Estimates are intentionally cheap (one plan walk, no device work).  Their
users in the port are the fusion splitter
(:func:`repro_torch.fuse.analysis.shareable_fingerprint_costs`) and the
cost router (:mod:`repro_torch.cost.router`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import relalg as R
from repro_torch.core import scalar as S
from repro_torch.core.executor import _plan_outer_refs

#: the H100 SXM's dense bf16 tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12

#: the H100 SXM's HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12

#: fixed launch cost of one device program dispatch (host → runtime →
#: device round trip); the term fusion amortizes
DISPATCH_OVERHEAD_S = 50e-6

#: estimated jit/compile seconds per plan node — the cold-configuration
#: penalty (riding an already-compiled larger bucket beats compiling a
#: fresh one unless the padded compute is enormous)
COMPILE_S_PER_NODE = 3e-3

#: flops charged per surviving row for a UDF call the plan interprets
#: per-row (HEKATON-style scan-mode evaluation) instead of inlining
UDF_CALL_ROW_FLOPS = 256.0

#: filter selectivity when no statistics apply (System-R's 1/3)
FILTER_SELECTIVITY = 0.33

#: join output selectivity over the cross product
JOIN_SELECTIVITY = 0.1

#: distinct-group guess for aggregations without key statistics
GROUP_CARDINALITY = 64.0

#: fallback table cardinality when the scanned name is not in the catalog
DEFAULT_TABLE_ROWS = 1024.0

_BYTES_PER_CELL = 4.0  # engine dtypes are int32/float32/bool


@dataclasses.dataclass(frozen=True)
class PlanProfile:
    """Estimated work of one plan execution: output cardinality plus the
    roofline terms accumulated over the whole tree."""

    rows: float
    flops: float
    bytes: float
    nodes: int

    def seconds(self, devices: int = 1) -> float:
        d = max(1, devices)
        return max(self.flops / (d * PEAK_FLOPS),
                   self.bytes / (d * HBM_BW)) + DISPATCH_OVERHEAD_S


def _expr_ops(e: S.Scalar) -> tuple[float, int]:
    """(scalar ops per row, UDF calls per row) of one expression tree."""
    ops, udfs = 0.0, 0
    for sub in S.walk(e):
        ops += 1.0
        if isinstance(sub, S.UdfCall):
            udfs += 1
    return ops, udfs


def _node_exprs_cost(node: R.RelNode, rows: float) -> float:
    """Flops this node's own expressions add at cardinality ``rows``."""
    flops = 0.0
    for e in node.exprs():
        ops, udfs = _expr_ops(e)
        flops += rows * (ops + udfs * UDF_CALL_ROW_FLOPS)
    return flops


def estimate_plan(plan: R.RelNode, catalog) -> PlanProfile:
    """Bottom-up work profile of ``plan`` against ``catalog`` (a name →
    Table mapping; only ``num_rows``/column counts are read).  Unknown
    node types pass their child cardinality through and charge one op per
    row, so a new operator degrades the estimate, never the walk."""
    kids = [estimate_plan(c, catalog) for c in plan.children()]
    embedded = [(p, estimate_plan(p, catalog)) for p in R.embedded_plans(plan)]
    flops = sum(k.flops for k in kids)
    bytes_ = sum(k.bytes for k in kids)
    nodes = 1 + sum(k.nodes for k in kids) + sum(e.nodes for _, e in embedded)
    in_rows = kids[0].rows if kids else 1.0
    for p, e in embedded:
        if _plan_outer_refs(p):
            # correlated subquery the optimizer left in place: the per-row
            # apply re-runs the body once per consuming row (vmap), so work
            # and reads scale with this node's input cardinality — the
            # honest price the decorrelated alternative (one keyed build of
            # ~distinct-binding rows + a join) is compared against
            flops += in_rows * max(1.0, e.flops)
            bytes_ += in_rows * e.bytes
        else:
            flops += e.flops
            bytes_ += e.bytes

    name = type(plan).__name__
    if name == "Scan":
        t = catalog.get(getattr(plan, "table", None)) if catalog else None
        rows = float(t.num_rows) if t is not None else DEFAULT_TABLE_ROWS
        ncols = len(t.columns) if t is not None else 4
        bytes_ += rows * ncols * _BYTES_PER_CELL
    elif name == "ConstantScan":
        rows = 1.0
    elif name == "Filter":
        flops += _node_exprs_cost(plan, in_rows)
        rows = max(1.0, in_rows * FILTER_SELECTIVITY)
    elif name == "Compute":
        flops += _node_exprs_cost(plan, in_rows)
        rows = in_rows
        bytes_ += in_rows * len(getattr(plan, "computed", ())) * _BYTES_PER_CELL
    elif name == "Project":
        rows = in_rows
    elif name == "Join":
        l = kids[0].rows if kids else 1.0
        r = kids[1].rows if len(kids) > 1 else 1.0
        # the executor lowers to gather / sort-merge, not a cross product:
        # charge sort-ish work on both sides, not l*r
        flops += (l + r) * 8.0
        rows = max(1.0, l * max(1.0, r * JOIN_SELECTIVITY / max(r, 1.0)))
        if plan.kind in ("inner", "left"):
            rows = l if plan.kind == "left" else max(1.0, l * JOIN_SELECTIVITY)
    elif name == "GroupAgg":
        naggs = max(1, len(getattr(plan, "aggs", ()) or ()))
        flops += in_rows * naggs * 2.0 + _node_exprs_cost(plan, in_rows)
        if getattr(plan, "keys", None):
            # distinct-binding cardinality: statistics-derived capacity
            # (annotate_group_stats) when present, else the System-R guess.
            # This is what prices a decorrelated build: d distinct bindings
            # flow into the join, so per-row wins only when d ≈ N and the
            # body is tiny.
            cap = getattr(plan, "capacity", None)
            rows = min(in_rows, float(cap) if cap else GROUP_CARDINALITY)
        else:
            rows = 1.0
    elif name == "Sort":
        flops += in_rows * 16.0
        rows = in_rows
    elif name == "LoopScan":
        # a rewritten cursor loop folds/scans the driving relation once
        flops += in_rows * 8.0 + _node_exprs_cost(plan, in_rows)
        rows = 1.0
    elif name == "Apply":
        # correlated apply re-evaluates the inner side per outer row in
        # the relational semantics; the vectorized executor batches it,
        # but the work still scales with the outer cardinality
        inner = kids[1] if len(kids) > 1 else (
            embedded[0][1] if embedded else None)
        if inner is not None:
            flops += in_rows * max(1.0, inner.flops / max(inner.rows, 1.0))
        rows = in_rows
    else:
        flops += _node_exprs_cost(plan, in_rows) + in_rows
        rows = max(1.0, in_rows)
    return PlanProfile(rows, flops, bytes_, nodes)


def estimate_node_s(node: R.RelNode, catalog) -> float:
    """Per-execution seconds of one subtree — the chunking weight the
    cost-aware fusion splitter uses (a shared aggregate over a big scan is
    worth more overlap than a shared literal filter)."""
    return estimate_plan(node, catalog).seconds()


def estimate_statement_s(plan: R.RelNode, catalog, *, bucket: int = 1,
                         devices: int = 1) -> float:
    """Per-wave seconds for ``bucket`` stacked executions of ``plan``
    spread over ``devices`` data-parallel shards."""
    p = estimate_plan(plan, catalog)
    return PlanProfile(p.rows, p.flops * bucket, p.bytes * bucket,
                       p.nodes).seconds(devices)


def estimate_compile_s(plan: R.RelNode) -> float:
    """Estimated one-time jit cost of specializing ``plan`` for a new
    configuration (bucket/signature/shard layout)."""
    return R.plan_size(plan) * COMPILE_S_PER_NODE
