"""Port of ``src/repro/fuse/``: the multi-statement fusion engine.

The paper's set-oriented argument, applied one level beyond ``execute_many``'s
batching: a serving queue holding N *different* prepared statements over
the same tables still pays N device dispatches and N redundant evaluations
of whatever catalog-only work the statements share.  This package merges
the members of such a queue into **one fused device program** — shared
scans/subtrees execute once, per-statement outputs come back tagged — with
a fusability analysis that routes anything unsafe back to the
per-statement path.

Layers (front to back):

* :mod:`repro_torch.fuse.analysis` — which calls may fuse, grouped by
  compatible policy; everything else falls back.
* :mod:`repro_torch.fuse.merge` — the plan-merge pass: dedup common param-free
  subtrees across member plans by structural fingerprint.
* :mod:`repro_torch.fuse.program` — the fused raw closure: shared-subtree
  pool plus one ``torch.func.vmap`` per member, run eagerly on the device.

Entry points: :meth:`repro_torch.core.Session.execute_fused` runs a mixed call
list; ``CoalescingScheduler(fuse=True)`` drains mixed-statement queues
through it; fused executables live in the session's ``fuse_hits`` /
``fuse_misses`` cache tier.
"""
from repro_torch.fuse.analysis import (
    fusion_group_key,
    is_fusable,
    partition_calls,
    shareable_fingerprint_costs,
    shareable_fingerprints,
)
from repro_torch.fuse.merge import (
    CONST_BIND,
    FusedPlan,
    SharedTemplate,
    hole_name,
    merge_plans,
    plan_is_pure,
    rewrite_lifted,
    rewrite_params,
    slot_param,
    subtree_is_constant,
    subtree_shape,
)
from repro_torch.fuse.program import FUSE_PAD, SharedScanExecutor, build_fused_raw

__all__ = [
    "CONST_BIND",
    "FusedPlan",
    "FUSE_PAD",
    "rewrite_lifted",
    "SharedScanExecutor",
    "SharedTemplate",
    "build_fused_raw",
    "fusion_group_key",
    "hole_name",
    "is_fusable",
    "merge_plans",
    "partition_calls",
    "plan_is_pure",
    "rewrite_params",
    "shareable_fingerprint_costs",
    "shareable_fingerprints",
    "slot_param",
    "subtree_is_constant",
    "subtree_shape",
]
