"""ctypes binding of the Hopper SSD scan kernel (``csrc/ssd_scan.cu``),
which replaces ``src/repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel``.

One block per head walks its chunks in order with the (N, P) float32
state in shared memory, chunk by chunk at the kernel's own chunk length
of 64 (:func:`chunk`).  See the source's header for the bound and the
design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.ssd_scan_fwd.restype = ctypes.c_int
        lib.ssd_scan_chunk.argtypes = []
        lib.ssd_scan_chunk.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_size_t
        lib.ssd_scan_smem_optin.argtypes = []
        lib.ssd_scan_smem_optin.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def chunk() -> int:
    """The chunk length the kernel takes."""
    return _lib().ssd_scan_chunk()


def ssd_scan_cuda(xdt: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Launch the kernel on the current stream: y (BH, L, P) float32.
    xdt (BH, L, P), dtA (BH, L), B and C (BG, L, N) with BH == BG * n_rep.
    Does not synchronise."""
    ts = (xdt, dtA, B, C)
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssd_scan_cuda takes CUDA tensors")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"ssd_scan_cuda takes float32 inputs; got "
                        f"{[t.dtype for t in ts]}")
    if xdt.dim() != 3 or dtA.shape != xdt.shape[:2] or B.dim() != 3 \
            or C.shape != B.shape or B.shape[1] != xdt.shape[1] \
            or n_rep < 1 or B.shape[0] * n_rep != xdt.shape[0]:
        raise ValueError(f"shapes xdt {tuple(xdt.shape)}, dtA {tuple(dtA.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}, n_rep {n_rep}")
    BH, L, P = xdt.shape
    N = B.shape[2]
    lib = _lib()
    xdt, dtA, B, C = (t.contiguous() for t in ts)
    y = torch.empty_like(xdt)
    with torch.cuda.device(xdt.device):
        need, have = lib.ssd_scan_smem_bytes(P, N), lib.ssd_scan_smem_optin()
        if need > have:
            raise ValueError(f"ssd_scan_cuda: P={P}, N={N} at chunk {lib.ssd_scan_chunk()} "
                             f"need {need} bytes of shared memory a block; the device "
                             f"allows {have}")
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(xdt.data_ptr(), dtA.data_ptr(), B.data_ptr(),
                               C.data_ptr(), y.data_ptr(), BH, L, P, N, n_rep,
                               stream)
    if err:
        raise RuntimeError("ssd_scan launch failed: "
                           + lib.ssd_scan_error_string(err).decode())
    return y
