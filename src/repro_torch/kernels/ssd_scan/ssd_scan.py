"""ctypes binding of the Hopper SSD scan kernels (``csrc/ssd_scan.cu``),
which replace ``src/repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel``.

Mamba-2's chunk-parallel SSD algorithm at the kernels' chunk of 64
(:func:`chunk`), in four launches on the current stream (:data:`PASSES`):
C B^T once per group and chunk, each chunk's own end state, the states
passed from chunk to chunk, and the outputs.  The wrapper allocates the
scratch those passes hand on (:class:`Plan`).  See the source's
header for the bound and the design.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import _build

#: the kernels, in launch order; the middle two run only when L spans more
#: than one chunk
PASSES = ("ssd_chunk_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")

_ARGTYPES = {
    "ssd_chunk_cb_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
    "ssd_chunk_state_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
    "ssd_state_pass_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4,
    "ssd_chunk_out_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        for name, args in _ARGTYPES.items():
            getattr(lib, name).argtypes = args + [ctypes.c_void_p]  # the stream
            getattr(lib, name).restype = ctypes.c_int
        lib.ssd_scan_chunk.argtypes = []
        lib.ssd_scan_chunk.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def chunk() -> int:
    """The chunk length the kernels take."""
    return _lib().ssd_scan_chunk()


def _n_chunks(L: int, Q: int) -> int:
    return -(-L // Q)


class Plan(NamedTuple):
    """A call's output, the scratch its passes hand on, and its launches in
    order.  cbt (BG, n_chunks, Q, Q): C B^T, transposed, lower tiles only;
    states (BH, n_chunks - 1, N, P): each chunk's own end state, and after
    the state pass the state entering each chunk past the first; decay
    (BH, n_chunks - 1): exp of each chunk's dtA sum."""
    y: torch.Tensor
    cbt: torch.Tensor
    states: torch.Tensor
    decay: torch.Tensor
    passes: list[tuple[str, Callable[[], None]]]

    def scratch_bytes(self) -> int:
        return self.cbt.nbytes + self.states.nbytes + self.decay.nbytes


def _check(xdt, dtA, B, C, n_rep) -> None:
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
    P, N = xdt.shape[2], B.shape[2]
    if P % 4 or N % 4:
        raise ValueError(f"ssd_scan_cuda takes P and N multiples of 4 (float4 loads); "
                         f"got P={P}, N={N}")


def plan(xdt: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
         n_rep: int) -> Plan:
    """Check the inputs and allocate the output and the scratch; launch
    nothing.  xdt (BH, L, P), dtA (BH, L), B and C (BG, L, N), float32, with
    BH == BG * n_rep."""
    _check(xdt, dtA, B, C, n_rep)
    BH, L, P = xdt.shape
    BG, N = B.shape[0], B.shape[2]
    lib = _lib()
    Q = lib.ssd_scan_chunk()
    xdt, dtA, B, C = (t.contiguous() for t in (xdt, dtA, B, C))
    if any(t.data_ptr() % 16 for t in (xdt, B, C)):
        raise ValueError("ssd_scan_cuda takes 16-byte aligned xdt, B and C")
    nc = _n_chunks(L, Q)
    y = torch.empty_like(xdt)
    cbt = torch.empty((BG, nc, Q, Q), dtype=torch.float32, device=xdt.device)
    states = torch.empty((BH, max(nc - 1, 0), N, P), dtype=torch.float32,
                         device=xdt.device)
    decay = torch.empty((BH, max(nc - 1, 0)), dtype=torch.float32, device=xdt.device)
    device = xdt.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
    # tensors, not their pointers: the launches hold them alive
    args = {
        "ssd_chunk_cb": (B, C, cbt, BG, L, N),
        "ssd_chunk_state": (xdt, dtA, B, states, decay, BH, L, P, N, n_rep),
        "ssd_state_pass": (states, decay, BH, L, P, N),
        "ssd_chunk_out": (xdt, dtA, C, cbt, states, y, BH, L, P, N, n_rep),
    }

    def launcher(name: str) -> Callable[[], None]:
        fn = getattr(lib, f"{name}_launch")

        def launch() -> None:
            with torch.cuda.device(device):
                err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                           for a in args[name]), stream)
            if err:
                raise RuntimeError(f"{name} launch failed: "
                                   + lib.ssd_scan_error_string(err).decode())
        return launch

    names = PASSES if nc > 1 else ("ssd_chunk_cb", "ssd_chunk_out")
    return Plan(y, cbt, states, decay, [(name, launcher(name)) for name in names])


def ssd_scan_cuda(xdt: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Launch the kernels on the current stream: y (BH, L, P) float32.
    xdt (BH, L, P), dtA (BH, L), B and C (BG, L, N) with BH == BG * n_rep.
    Does not synchronise."""
    call = plan(xdt, dtA, B, C, n_rep)
    for _, launch in call.passes:
        launch()
    return call.y
