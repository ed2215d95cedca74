"""Port of ``src/repro/cost/``: the static cost model
(:mod:`repro_torch.cost.model`, at the H100's peaks), which the fusion
splitter and the router read, and the online router
(:mod:`repro_torch.cost.router`), which steers ``ROUTED`` statements and
drain waves through the cheapest configuration — FROID/HEKATON choice,
fuse-or-not, batch bucket — without changing results.
"""
from repro_torch.cost.model import (
    COMPILE_S_PER_NODE,
    DISPATCH_OVERHEAD_S,
    HBM_BW,
    PEAK_FLOPS,
    PlanProfile,
    estimate_compile_s,
    estimate_node_s,
    estimate_plan,
    estimate_statement_s,
)
from repro_torch.cost.router import CostRouter

__all__ = [
    "COMPILE_S_PER_NODE",
    "DISPATCH_OVERHEAD_S",
    "CostRouter",
    "HBM_BW",
    "PEAK_FLOPS",
    "PlanProfile",
    "estimate_compile_s",
    "estimate_node_s",
    "estimate_plan",
    "estimate_statement_s",
]
