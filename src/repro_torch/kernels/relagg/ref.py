"""Plain torch version of the relagg kernel: a port of
``src/repro/kernels/relagg/ref.py::grouped_aggregate_ref``."""
from __future__ import annotations

import torch


def grouped_aggregate_ref(gid: torch.Tensor, mask: torch.Tensor,
                          vals: torch.Tensor, num_groups: int):
    """sums: (G, n_aggs); counts: (G,) — filtered rows excluded.  A row
    whose gid lies outside [0, G) adds nothing (the reference's segment sum
    drops it; the TPU kernel's one-hot has no column for it)."""
    sel = mask & (gid >= 0) & (gid < num_groups)
    safe_gid = torch.where(sel, gid, num_groups).to(torch.int64)
    v = torch.where(sel[:, None], vals.to(torch.float32), 0.0)
    sums = torch.zeros((num_groups + 1, vals.shape[1]), dtype=torch.float32,
                       device=vals.device).index_add_(0, safe_gid, v)
    counts = torch.zeros((num_groups + 1,), dtype=torch.float32,
                         device=vals.device).index_add_(
        0, safe_gid, sel.to(torch.float32))
    return sums[:num_groups], counts[:num_groups]
