"""ctypes binding of the Hopper relagg kernel (``csrc/relagg.cu``), which
replaces ``src/repro/kernels/relagg/relagg.py::_relagg_kernel``.

The kernel accumulates a group's k sums and its count in shared memory per
block when ``G * (k+1) * 4`` bytes fit the block's shared-memory budget
(:func:`uses_shared`), else straight into the output with global atomics.
See the source's header for the bound and the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("relagg")
    if not getattr(lib, "_typed", False):
        for fn in (lib.relagg_shared, lib.relagg_global):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.relagg_smem_budget.argtypes = []
        lib.relagg_smem_budget.restype = ctypes.c_int
        lib.relagg_error_string.argtypes = [ctypes.c_int]
        lib.relagg_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def uses_shared(num_groups: int, n_aggs: int) -> bool:
    """Whether the shared-memory kernel takes ``(G, k)``: its accumulator
    fits the budget a block may opt in to on the current device."""
    return num_groups * (n_aggs + 1) * 4 <= _lib().relagg_smem_budget()


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
    out = torch.zeros((num_groups, k + 1), dtype=torch.float32, device=vals.device)
    lib = _lib()
    launch = lib.relagg_shared if uses_shared(num_groups, k) else lib.relagg_global
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(gid.data_ptr(), mask.data_ptr(), vals.data_ptr(),
                     out.data_ptr(), n, k, num_groups, stream)
    if err:
        raise RuntimeError("relagg launch failed: "
                           + lib.relagg_error_string(err).decode())
    return out[:, :k], out[:, k]
