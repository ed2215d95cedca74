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


#: blocks whose float64 partials one block sums before the groups' sums
#: are added (``kGroup`` in ``csrc/relagg.cu``)
BLOCK_GROUP = 12


def rows_per_block(n: int, blocks: int) -> int:
    """Rows each block owns in a fixed partition of ``n`` rows into
    ``blocks`` contiguous ranges: a multiple of 16 (one 16-byte mask word),
    so that the ranges of a 16-byte aligned mask start on whole words."""
    rows = -(-n // blocks)
    return -(-rows // 16) * 16


def grouped_aggregate_blocked(gid: torch.Tensor, mask: torch.Tensor,
                              vals: torch.Tensor, num_groups: int, blocks: int):
    """The CUDA kernel's scheme in plain torch: block b sums the selected
    rows of its range [b * p, (b+1) * p), p = :func:`rows_per_block`, in
    float64; the blocks' partials are added in block order, in groups of
    :data:`BLOCK_GROUP` consecutive blocks whose sums are then added in
    group order, and rounded once to float32.  Same result as
    :func:`grouped_aggregate_ref` up to float32 rounding; counts exact."""
    n, k = vals.shape
    sel = mask & (gid >= 0) & (gid < num_groups)
    safe_gid = torch.where(sel, gid, num_groups).to(torch.int64)
    v = torch.cat([torch.where(sel[:, None], vals.to(torch.float64), 0.0),
                   sel[:, None].to(torch.float64)], 1)
    per = rows_per_block(n, blocks)
    partials = []
    for b in range(blocks):
        rows = slice(min(n, b * per), min(n, (b + 1) * per))
        partials.append(torch.zeros((num_groups + 1, k + 1), dtype=torch.float64,
                                    device=vals.device).index_add_(0, safe_gid[rows], v[rows]))
    total = torch.zeros_like(partials[0])
    for g0 in range(0, blocks, BLOCK_GROUP):
        group = torch.zeros_like(total)
        for partial in partials[g0:g0 + BLOCK_GROUP]:
            group = group + partial
        total = total + group
    out = total[:num_groups].to(torch.float32)
    return out[:, :k], out[:, k]
