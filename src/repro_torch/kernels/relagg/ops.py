"""Public wrapper of the relagg kernel: fused filter + grouped sum/count.

A port of ``src/repro/kernels/relagg/ops.py::grouped_aggregate``.  A tensor
on the CPU takes the plain torch version; a CUDA tensor launches the
hand-written kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.relagg.ref import grouped_aggregate_ref

#: kernel launches made by :func:`grouped_aggregate` (a plain count, read
#: by ``chip_smoke.py`` to show the main path went through the kernel)
LAUNCHES = 0


def grouped_aggregate(gid: torch.Tensor, mask: torch.Tensor,
                      vals: torch.Tensor, num_groups: int):
    """(sums (G, n_aggs), counts (G,)) over rows with ``mask`` and a gid in
    [0, G)."""
    global LAUNCHES
    if gid.device.type == "cpu":
        return grouped_aggregate_ref(gid, mask, vals, num_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"grouped_aggregate: no kernel for {gid.device}")
    from repro_torch.kernels.relagg.relagg import relagg_cuda

    out = relagg_cuda(gid, mask, vals, num_groups)
    LAUNCHES += 1
    return out
