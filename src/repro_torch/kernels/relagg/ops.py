"""Public wrapper of the relagg kernel: fused filter + grouped sum/count.

A port of ``src/repro/kernels/relagg/ops.py::grouped_aggregate``.  A tensor
on the CPU takes the plain torch version; a CUDA tensor launches the
hand-written kernel or raises.

Under ``torch.func.vmap`` (a GroupAgg inside a correlated subquery), as
the reference's ``pallas_call`` gains a grid axis under ``jax.vmap``, the
call goes through the op ``repro_torch::relagg``, whose batching rule hands
every input with a leading batch axis to ``repro_torch::relagg_batched``:
an unbatched input as a stride-0 expansion, never copied per item.  That
op launches the batched kernel once on a CUDA tensor and takes the plain
batched version on the CPU; it never loops over the batch.  A nested vmap
folds its extra batch level into the batch axis.  An unbatched call keeps
the direct path, with no dispatcher op in its way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.relagg.ref import (
    grouped_aggregate_batched_ref,
    grouped_aggregate_ref,
)

#: kernel launches made by :func:`grouped_aggregate`, a batched launch
#: counted once (a plain count, read by ``chip_smoke.py`` to show the main
#: path went through the kernel)
LAUNCHES = 0
#: the batched launches among them (correlated subqueries)
BATCHED_LAUNCHES = 0


def grouped_aggregate(gid: torch.Tensor, mask: torch.Tensor,
                      vals: torch.Tensor, num_groups: int):
    """(sums (G, n_aggs), counts (G,)) over rows with ``mask`` and a gid in
    [0, G)."""
    global LAUNCHES
    if any(torch._C._functorch.is_batchedtensor(t) for t in (gid, mask, vals)):
        out = torch.ops.repro_torch.relagg(gid, mask, vals, num_groups)
        k = vals.shape[-1]
        return out.narrow(-1, 0, k), out.select(-1, k)
    if gid.device.type == "cpu":
        return grouped_aggregate_ref(gid, mask, vals, num_groups)
    if gid.device.type != "cuda":
        raise ValueError(f"grouped_aggregate: no kernel for {gid.device}")
    from repro_torch.kernels.relagg.relagg import relagg_cuda

    out = relagg_cuda(gid, mask, vals, num_groups)
    LAUNCHES += 1
    return out


def _batched(gid: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor,
             num_groups: int) -> torch.Tensor:
    """(B, G, k+1): each item's sums, then its count, from gid and mask
    (B, n) and vals (B, n, k)."""
    global LAUNCHES, BATCHED_LAUNCHES
    if gid.device.type == "cpu":
        sums, counts = grouped_aggregate_batched_ref(gid, mask, vals, num_groups)
        return torch.cat([sums, counts[..., None]], -1)
    if gid.device.type != "cuda":
        raise ValueError(f"grouped_aggregate: no kernel for {gid.device}")
    from repro_torch.kernels.relagg.relagg import relagg_cuda_batched

    out = relagg_cuda_batched(gid, mask, vals, num_groups)
    LAUNCHES += 1
    BATCHED_LAUNCHES += 1
    return out


@torch.library.custom_op("repro_torch::relagg_batched", mutates_args=())
def _relagg_batched(gid: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    return _batched(gid, mask, vals, num_groups)


@torch.library.custom_op("repro_torch::relagg", mutates_args=())
def _relagg(gid: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor,
            num_groups: int) -> torch.Tensor:
    """(G, k+1) of one item; reached under vmap only through its rule."""
    return _batched(gid[None], mask[None], vals[None], num_groups)[0]


def _leading(info, in_dims, tensors):
    """Each tensor with the vmap level's batch axis first: moved there, or
    expanded with stride 0 where the tensor has none."""
    return [t.movedim(d, 0) if d is not None else t.expand(info.batch_size, *t.shape)
            for t, d in zip(tensors, in_dims)]


@torch.library.register_vmap("repro_torch::relagg")
def _relagg_vmap(info, in_dims, gid, mask, vals, num_groups):
    gid, mask, vals = _leading(info, in_dims[:3], (gid, mask, vals))
    return torch.ops.repro_torch.relagg_batched(gid, mask, vals, num_groups), 0


@torch.library.register_vmap("repro_torch::relagg_batched")
def _relagg_batched_vmap(info, in_dims, gid, mask, vals, num_groups):
    # a vmap outside a vmap: fold the outer level into the batch axis (an
    # input batched at one level only is copied by the reshape)
    outer, inner = info.batch_size, vals.shape[-3]
    flat = [t.reshape(outer * inner, *t.shape[2:])
            for t in _leading(info, in_dims[:3], (gid, mask, vals))]
    out = torch.ops.repro_torch.relagg_batched(*flat, num_groups)
    return out.reshape(outer, inner, *out.shape[1:]), 0
