"""Port of ``src/repro/cost/``: the static cost model
(:mod:`repro_torch.cost.model`), which the fusion splitter reads.  The
online router (``cost/router.py``) and the ``ROUTED`` preset are ROADMAP
A8.
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

__all__ = [
    "COMPILE_S_PER_NODE",
    "DISPATCH_OVERHEAD_S",
    "HBM_BW",
    "PEAK_FLOPS",
    "PlanProfile",
    "estimate_compile_s",
    "estimate_node_s",
    "estimate_plan",
    "estimate_statement_s",
]
