"""ctypes binding of the Hopper relagg kernel (``csrc/relagg.cu``), which
replaces ``src/repro/kernels/relagg/relagg.py::_relagg_kernel``.

Where a block's warps' float64 slots fit the shared memory a block may opt
in to (:func:`uses_shared`), one launch scans a fixed partition of the rows
(:func:`launch_plan`), pre-aggregates each warp's rows in its own slots in
a fixed order, sums the blocks' float64 partials in block order (in groups
of :data:`BLOCK_GROUP` blocks, then the groups in order) and rounds once
to float32: the sums are the same bits every call.  Otherwise
(high-cardinality keys) the rows add into a float64 accumulator in device
memory with atomics, and a second launch rounds it once; the last bit of a
sum may then differ between calls.  See the source's header for the bound
and the design.

:func:`relagg_cuda_batched` launches the same kernels over ``B`` items at
once (a GroupAgg inside a correlated subquery): each item is a ``gridDim.y``
index with its own inputs at a batch stride (0 for an input every item
shares), the unbatched launch's row partition, scratch and tickets, in
chunks of at most :data:`MAX_BATCH_CHUNK` items whose scratch stays within
:data:`SCRATCH_BUDGET`; that scratch is the call's own, allocated with
the output, and only the tickets are kept per device and stream.

Host work a call is what the call needs: the device's SM count and
shared-memory budget are read once per device, the shared-memory opt-in
is set once per device and larger size, and the float64 scratch and the
tickets of the cross-block sum are kept per device and stream, the scratch
grown when a larger ``G * (k+1)`` comes.  The output is allocated with
``torch.empty``: the kernel writes every slot.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.relagg.ref import BLOCK_GROUP, rows_per_block

#: threads a block and warps a block, as ``kThreads`` in the source
THREADS = 512
WARPS = THREADS // 32
#: candidate rows a warp lists in shared memory, as ``kList``
LIST = 512
#: rows for which the grid takes one more block: a 16-byte mask word a
#: thread
MIN_ROWS_PER_BLOCK = THREADS * 16

#: items a launch at most: ``gridDim.y``'s limit
MAX_BATCH_CHUNK = 65_535
#: float64 scratch slots a batched launch's chunk may take (256 MiB); a
#: chunk holds one item at least
SCRATCH_BUDGET = 1 << 25

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call launches: the path, the grid, the rows each block owns,
    the dynamic shared memory a block takes and the float64 scratch slots
    (the blocks' partials and their groups' sums on the shared path, the
    accumulator on the global one)."""
    shared: bool
    grid: int
    per_block: int
    smem: int
    scratch_slots: int


def shared_bytes(num_groups: int, n_aggs: int) -> int:
    """Dynamic shared memory of the shared-memory path: every warp's
    ``G * (k+1)`` float64 slots, its list of candidate rows, the groups of
    its 32 rows in hand (an id and a lane mask each) and their staged
    float32 vals."""
    return WARPS * (num_groups * (n_aggs + 1) * 8 + LIST * 4 + 32 * 8 + 32 * n_aggs * 4)


#: dynamic shared memory of the global path: the warps' lists
GLOBAL_SMEM = WARPS * LIST * 4


def groups_of(blocks: int) -> int:
    """Groups of :data:`BLOCK_GROUP` consecutive blocks, the last one
    short."""
    return -(-blocks // BLOCK_GROUP)


@functools.lru_cache(maxsize=1024)
def launch_plan(sm_count: int, smem_budget: int, n: int, num_groups: int,
                n_aggs: int) -> LaunchPlan:
    """The launch of a call on ``n`` rows, ``G`` groups and ``k`` values, on
    a device with ``sm_count`` SMs and ``smem_budget`` bytes of opt-in
    shared memory a block: one block for every :data:`MIN_ROWS_PER_BLOCK`
    rows or part of them, and one block an SM at most."""
    grid = max(1, min(sm_count, -(-n // MIN_ROWS_PER_BLOCK)))
    per_block = rows_per_block(n, grid)
    slots = num_groups * (n_aggs + 1)
    smem = shared_bytes(num_groups, n_aggs)
    if smem <= smem_budget:
        return LaunchPlan(True, grid, per_block, smem, (grid + groups_of(grid)) * slots)
    return LaunchPlan(False, grid, per_block, GLOBAL_SMEM, slots)


def _lib() -> ctypes.CDLL:
    lib = _build.load("relagg")
    if not getattr(lib, "_typed", False):
        for fn, args in ((lib.relagg_shared, [_P] * 6 + [_L, _L, _I, _I, _I, _I] + [_L] * 5
                          + [_P]),
                         (lib.relagg_global, [_P] * 5 + [_L, _L, _I, _I, _I, _I] + [_L] * 5
                          + [_P]),
                         (lib.relagg_device_info, [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]),
                         (lib.relagg_reserve_smem, [_I])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.relagg_error_string.argtypes = [ctypes.c_int]
        lib.relagg_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _raise(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"relagg {what} failed: " + lib.relagg_error_string(err).decode())


class _Device:
    """What the binding keeps per device: its SM count and the dynamic
    shared memory the shared-memory kernel may opt in to there, what it
    has opted in to so far, and the scratch and ticket of each stream."""

    def __init__(self, lib: ctypes.CDLL, index: int):
        sms, smem = _I(), _I()
        _raise(lib, lib.relagg_device_info(index, ctypes.byref(sms), ctypes.byref(smem)),
               "device query")
        self.index, self.sm_count, self.smem_budget = index, sms.value, smem.value
        self.reserved = 0
        self.scratch: dict[tuple[int, bool], torch.Tensor] = {}
        self.tickets: dict[int, torch.Tensor] = {}

    def reserve(self, lib: ctypes.CDLL, smem: int) -> None:
        if smem > self.reserved:
            _raise(lib, lib.relagg_reserve_smem(smem), "shared-memory opt-in")
            self.reserved = smem

    def scratch_for(self, stream: int, shared: bool, slots: int) -> torch.Tensor:
        """float64 scratch of at least ``slots``; the global path's is zero
        between calls (its second launch zeroes it again)."""
        buf = self.scratch.get((stream, shared))
        if buf is None or buf.numel() < slots:
            buf = torch.zeros(slots, dtype=torch.float64, device=f"cuda:{self.index}")
            self.scratch[stream, shared] = buf
        return buf

    def ticket_for(self, stream: int, items: int = 1) -> torch.Tensor:
        """The shared path's tickets for ``items`` batch items, 0 between
        calls: each item's one for the groups of blocks and one for each
        group."""
        count = items * (1 + groups_of(self.sm_count))
        ticket = self.tickets.get(stream)
        if ticket is None or ticket.numel() < count:
            ticket = self.tickets[stream] = torch.zeros(
                count, dtype=torch.int32, device=f"cuda:{self.index}")
        return ticket


_devices: dict[int, _Device] = {}


def _device(lib: ctypes.CDLL, index: int) -> _Device:
    dev = _devices.get(index)
    if dev is None:
        dev = _devices[index] = _Device(lib, index)
    return dev


def uses_shared(num_groups: int, n_aggs: int) -> bool:
    """Whether the shared-memory kernel takes ``(G, k)``: its warps' slots
    fit the budget a block may opt in to on the current device."""
    lib = _lib()
    return shared_bytes(num_groups, n_aggs) <= _device(
        lib, torch.cuda.current_device()).smem_budget


def relagg_cuda(gid: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor,
                num_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: (sums (G, k), counts (G,)).
    Does not synchronise."""
    if not (gid.is_cuda and mask.is_cuda and vals.is_cuda):
        raise ValueError("relagg_cuda takes CUDA tensors")
    if gid.dtype != torch.int32 or mask.dtype != torch.bool \
            or vals.dtype != torch.float32:
        raise TypeError(f"relagg_cuda takes int32 gid, bool mask, float32 vals; "
                        f"got {gid.dtype}, {mask.dtype}, {vals.dtype}")
    if vals.dim() != 2 or gid.shape != (vals.shape[0],) \
            or mask.shape != gid.shape or vals.shape[1] < 1:
        raise ValueError(f"shapes gid {tuple(gid.shape)}, mask "
                         f"{tuple(mask.shape)}, vals {tuple(vals.shape)}")
    if num_groups < 1:
        raise ValueError(f"num_groups must be positive, got {num_groups}")
    n, k = vals.shape
    gid, mask, vals = gid.contiguous(), mask.contiguous(), vals.contiguous()
    index = vals.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return relagg_cuda(gid, mask, vals, num_groups)
    lib = _lib()
    dev = _device(lib, index)
    plan = launch_plan(dev.sm_count, dev.smem_budget, n, num_groups, k)
    stream = torch._C._cuda_getCurrentRawStream(index)
    out = torch.empty((num_groups, k + 1), dtype=torch.float32, device=vals.device)
    scratch = dev.scratch_for(stream, plan.shared, plan.scratch_slots)
    if plan.shared:
        dev.reserve(lib, plan.smem)
        err = lib.relagg_shared(gid.data_ptr(), mask.data_ptr(), vals.data_ptr(),
                                out.data_ptr(), scratch.data_ptr(),
                                dev.ticket_for(stream).data_ptr(), n, plan.per_block, k,
                                num_groups, plan.grid, plan.smem, 1, 1, 0, 0, 0, stream)
    else:
        err = lib.relagg_global(gid.data_ptr(), mask.data_ptr(), vals.data_ptr(),
                                out.data_ptr(), scratch.data_ptr(), n, plan.per_block, k,
                                num_groups, plan.grid, plan.smem, 1, 1, 0, 0, 0, stream)
    _raise(lib, err, "launch")
    return out.narrow(1, 0, k), out.select(1, k)


def batch_chunk(batch: int, plan: LaunchPlan) -> int:
    """Items a launch of a batched call takes: at most
    :data:`MAX_BATCH_CHUNK`, and as many as keep the chunk's float64
    scratch within :data:`SCRATCH_BUDGET` (one at least)."""
    return max(1, min(batch, MAX_BATCH_CHUNK, SCRATCH_BUDGET // plan.scratch_slots))


def _item_major(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``t`` with each item (``t[b]``) contiguous, copied only where an
    item is not, and its batch stride in elements (0 where every item is
    the same storage, as a stride-0 expansion)."""
    if t.shape[0] and not t[0].is_contiguous():
        t = t.contiguous()
    return t, t.stride(0) if t.shape[0] > 1 else 0


def relagg_cuda_batched(gid: torch.Tensor, mask: torch.Tensor, vals: torch.Tensor,
                        num_groups: int) -> torch.Tensor:
    """Launch the kernel over ``B`` items on the current stream: gid and
    mask (B, n), vals (B, n, k), each possibly a stride-0 expansion of one
    item, to (B, G, k+1), each item's sums and then its count.  Item b's
    result is :func:`relagg_cuda` of ``(gid[b], mask[b], vals[b])``, the
    same bits on the shared path.  ``B = 0`` launches nothing.  Does not
    synchronise."""
    if not (gid.is_cuda and mask.is_cuda and vals.is_cuda):
        raise ValueError("relagg_cuda_batched takes CUDA tensors")
    if gid.dtype != torch.int32 or mask.dtype != torch.bool \
            or vals.dtype != torch.float32:
        raise TypeError(f"relagg_cuda_batched takes int32 gid, bool mask, float32 vals; "
                        f"got {gid.dtype}, {mask.dtype}, {vals.dtype}")
    if vals.dim() != 3 or gid.shape != vals.shape[:2] \
            or mask.shape != gid.shape or vals.shape[2] < 1:
        raise ValueError(f"shapes gid {tuple(gid.shape)}, mask "
                         f"{tuple(mask.shape)}, vals {tuple(vals.shape)}")
    if num_groups < 1:
        raise ValueError(f"num_groups must be positive, got {num_groups}")
    batch, n, k = vals.shape
    out = torch.empty((batch, num_groups, k + 1), dtype=torch.float32, device=vals.device)
    if batch == 0:
        return out
    index = vals.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return relagg_cuda_batched(gid, mask, vals, num_groups)
    (gid, gid_bs), (mask, mask_bs), (vals, vals_bs) = map(_item_major, (gid, mask, vals))
    lib = _lib()
    dev = _device(lib, index)
    plan = launch_plan(dev.sm_count, dev.smem_budget, n, num_groups, k)
    chunk = batch_chunk(batch, plan)
    stream = torch._C._cuda_getCurrentRawStream(index)
    # the call's own scratch, not the device's kept one: a chunk's may
    # reach SCRATCH_BUDGET; the global path's accumulator starts at 0
    scratch = (torch.empty if plan.shared else torch.zeros)(
        chunk * plan.scratch_slots, dtype=torch.float64, device=vals.device)
    if plan.shared:
        dev.reserve(lib, plan.smem)
        err = lib.relagg_shared(gid.data_ptr(), mask.data_ptr(), vals.data_ptr(),
                                out.data_ptr(), scratch.data_ptr(),
                                dev.ticket_for(stream, chunk).data_ptr(), n, plan.per_block,
                                k, num_groups, plan.grid, plan.smem, batch, chunk, gid_bs,
                                mask_bs, vals_bs, stream)
    else:
        err = lib.relagg_global(gid.data_ptr(), mask.data_ptr(), vals.data_ptr(),
                                out.data_ptr(), scratch.data_ptr(), n, plan.per_block, k,
                                num_groups, plan.grid, plan.smem, batch, chunk, gid_bs,
                                mask_bs, vals_bs, stream)
    _raise(lib, err, "batched launch")
    return out
