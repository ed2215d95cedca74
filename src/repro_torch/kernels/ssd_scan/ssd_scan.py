"""ctypes binding of the Hopper SSD scan kernels (``csrc/ssd_scan.cu``),
which replace ``src/repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel``.

Mamba-2's chunk-parallel SSD algorithm at the kernels' chunk of 64
(:func:`chunk`), in four launches on the current stream (:data:`PASSES`):
C B^T once per group and chunk, each chunk's own end state, the states
passed from chunk to chunk, and the outputs.  The wrapper allocates the
scratch those passes hand on (:class:`Plan`).  Its backward
(:data:`BACKWARD_PASSES`, :func:`backward_plan`) takes the forward's
scratch, its output y and dy and gives dxdt, ddtA, dB and dC in six more
launches: the state gradients entering and leaving each chunk (and ddtA
at each chunk's first row), dxdt with ddtA's row terms and dB and dC on
the tensor cores (3xTF32), dB and dC summed over slices of each group's
heads in order, and ddtA as a reverse cumsum of the row terms within each
chunk.  See the source's header for the bound and the design.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import _build

#: the kernels, in launch order; the middle two run only when L spans more
#: than one chunk
PASSES = ("ssd_chunk_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
#: the backward's kernels, in launch order; the first two run only when L
#: spans more than one chunk
BACKWARD_PASSES = ("ssd_bwd_dstate", "ssd_bwd_state_pass", "ssd_bwd_chunk_dx",
                   "ssd_bwd_chunk_dbc", "ssd_bwd_dbc_sum", "ssd_bwd_ddtA")
#: the largest state size the backward takes: the largest its checks on the
#: card cover (its kernels walk N in tiles of 64)
MAX_BACKWARD_N = 256

_ARGTYPES = {
    "ssd_chunk_cb_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
    "ssd_chunk_state_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5,
    "ssd_state_pass_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4,
    "ssd_chunk_out_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5,
    "ssd_bwd_dstate_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5,
    "ssd_bwd_state_pass_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4,
    "ssd_bwd_chunk_dx_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5,
    "ssd_bwd_chunk_dbc_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5,
    "ssd_bwd_dbc_sum_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
    "ssd_bwd_ddtA_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        for name, args in _ARGTYPES.items():
            getattr(lib, name).argtypes = args + [ctypes.c_void_p]  # the stream
            getattr(lib, name).restype = ctypes.c_int
        lib.ssd_scan_chunk.argtypes = []
        lib.ssd_scan_chunk.restype = ctypes.c_int
        lib.ssd_bwd_slices.argtypes = [ctypes.c_int]
        lib.ssd_bwd_slices.restype = ctypes.c_int
        lib.ssd_bwd_parts.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ssd_bwd_parts.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def chunk() -> int:
    """The chunk length the kernels take, read from the library."""
    return _lib().ssd_scan_chunk()


#: Python copies of the library's sizes, for the fake versions in
#: ``ops.py`` (which run without the library); ``chip_smoke.py`` holds each
#: to the library's value on the card.  The chunk (``ssd_scan_chunk()``,
#: ``kChunk``) and the heads a ``ssd_bwd_chunk_dbc`` block sums over
#: (``kSliceHeads``)
CHUNK = 64
SLICE_HEADS = 8
#: threads a block of ``ssd_bwd_state_pass`` (``kThreads``)
_STATE_PASS_THREADS = 256


def bwd_slices(n_rep: int) -> int:
    """The library's ``ssd_bwd_slices(n_rep)``: the slices of a group's
    heads that ``ssd_bwd_chunk_dbc`` sums apart."""
    return -(-n_rep // SLICE_HEADS)


def bwd_parts(P: int, N: int) -> int:
    """The library's ``ssd_bwd_parts(P, N)``: the partial sums of <g_c,
    S_in[c + 1]> a (head, chunk) that ``ssd_bwd_state_pass`` writes, one
    a warp of its blocks (4 state elements a thread)."""
    return -(-(N * P // 4) // _STATE_PASS_THREADS) * (_STATE_PASS_THREADS // 32)


def n_chunks(L: int, Q: int) -> int:
    return -(-L // Q)


def forward_buffers(xdt: torch.Tensor, B: torch.Tensor, Q: int) -> tuple:
    """The forward's output and scratch on xdt's device, at chunk ``Q``:
    (y, cbt, states, decay) as :class:`Plan` lays them out.  :func:`plan`
    allocates them at the library's chunk, the fake version in ``ops.py``
    at :data:`CHUNK` on ``meta``."""
    BH, L, P = xdt.shape
    BG, N = B.shape[0], B.shape[2]
    nc = n_chunks(L, Q)
    f32 = dict(dtype=torch.float32)
    return (xdt.new_empty((BH, L, P)), xdt.new_empty((BG, nc, Q, Q), **f32),
            xdt.new_empty((BH, max(nc - 1, 0), N, P), **f32),
            xdt.new_empty((BH, max(nc - 1, 0)), **f32))


def backward_buffers(xdt: torch.Tensor, B: torch.Tensor, Q: int, n_parts: int,
                     n_slices: int) -> tuple:
    """The backward's gradients and scratch on xdt's device, at chunk
    ``Q`` with ``n_parts`` partial sums a (head, chunk) and ``n_slices``
    slices a group: (dxdt, ddtA, dB, dC, gstates, ddp, rowterm, parts) as
    :class:`BackwardPlan` lays them out.  :func:`backward_plan` allocates
    them at the library's sizes; the fake version in ``ops.py`` and the dry
    run's count of the scratch at the Python copies on ``meta``."""
    BH, L, P = xdt.shape
    BG, N = B.shape[0], B.shape[2]
    nc = n_chunks(L, Q)
    f32 = dict(dtype=torch.float32)
    return (xdt.new_empty((BH, L, P)), xdt.new_empty((BH, L)), B.new_empty((BG, L, N)),
            B.new_empty((BG, L, N)), xdt.new_empty((BH, max(nc - 1, 0), N, P), **f32),
            xdt.new_empty((BH, max(nc - 1, 0), n_parts), **f32),
            xdt.new_empty((-(-P // Q), BH, L), **f32),
            xdt.new_empty((2, BG, n_slices, L, N), **f32))


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
    if not all(t.is_cuda for t in (xdt, dtA, B, C)):
        raise ValueError("ssd_scan_cuda takes CUDA tensors")
    check_inputs(xdt, dtA, B, C, n_rep)


def check_inputs(xdt, dtA, B, C, n_rep) -> None:
    """The forward's checks that need no device: dtypes and shapes (the
    fake versions in ``ops.py`` take them too)."""
    ts = (xdt, dtA, B, C)
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
    nc = n_chunks(L, Q)
    y, cbt, states, decay = forward_buffers(xdt, B, Q)
    # tensors, not their pointers: the launches hold them alive
    args = {
        "ssd_chunk_cb": (B, C, cbt, BG, L, N),
        "ssd_chunk_state": (xdt, dtA, B, states, decay, BH, L, P, N, n_rep),
        "ssd_state_pass": (states, decay, BH, L, P, N),
        "ssd_chunk_out": (xdt, dtA, C, cbt, states, y, BH, L, P, N, n_rep),
    }
    names = PASSES if nc > 1 else ("ssd_chunk_cb", "ssd_chunk_out")
    return Plan(y, cbt, states, decay, _launchers(lib, xdt.device, args, names))


def _launchers(lib, device, args: dict, names) -> list[tuple[str, Callable[[], None]]]:
    """(name, launch) for each kernel of ``names``, each launching on the
    device's current stream with ``args[name]`` (tensors by their data
    pointers) and raising on a failed launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream

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

    return [(name, launcher(name)) for name in names]


def ssd_scan_cuda(xdt: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Launch the kernels on the current stream: y (BH, L, P) float32.
    xdt (BH, L, P), dtA (BH, L), B and C (BG, L, N) with BH == BG * n_rep.
    Does not synchronise."""
    call = plan(xdt, dtA, B, C, n_rep)
    for _, launch in call.passes:
        launch()
    return call.y


class BackwardPlan(NamedTuple):
    """A backward call's gradients, its scratch and its launches in order.
    gstates (BH, n_chunks - 1, N, P): dS_in of each chunk past the first,
    then after the state pass g_c, the gradient of chunk c's end state;
    ddp (BH, n_chunks - 1, parts): the state pass's partial sums of <g_c,
    S_in[c + 1]>, ddtA at chunk c + 1's first row; rowterm (ceil(P / 64),
    BH, L): each row's dy . y - xdt . dxdt over a P tile; parts (2, BG,
    slices, L, N): each slice of a group's heads' share of dC (at 0) and dB
    (at 1)."""
    dxdt: torch.Tensor
    ddtA: torch.Tensor
    dB: torch.Tensor
    dC: torch.Tensor
    gstates: torch.Tensor
    ddp: torch.Tensor
    rowterm: torch.Tensor
    parts: torch.Tensor
    passes: list[tuple[str, Callable[[], None]]]

    def scratch_bytes(self) -> int:
        return (self.gstates.nbytes + self.ddp.nbytes + self.rowterm.nbytes
                + self.parts.nbytes)


def check_backward_inputs(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy, Q: int) -> None:
    """The backward's checks that need no device, at chunk ``Q``: the
    forward's inputs, y and dy, N, and the forward's scratch."""
    check_inputs(xdt, dtA, B, C, n_rep)
    BH, L, P = xdt.shape
    BG, N = B.shape[0], B.shape[2]
    for name, t in (("y", y), ("dy", dy)):
        if t.shape != xdt.shape or t.dtype != torch.float32:
            raise ValueError(f"ssd_scan backward: {name} {tuple(t.shape)} {t.dtype}, expected "
                             f"{tuple(xdt.shape)} float32")
    if N > MAX_BACKWARD_N:
        raise ValueError(f"ssd_scan backward takes N up to {MAX_BACKWARD_N}; got N={N}")
    nc = n_chunks(L, Q)
    if states.shape != (BH, max(nc - 1, 0), N, P) or decay.shape != (BH, max(nc - 1, 0)) \
            or cbt.shape != (BG, nc, Q, Q):
        raise ValueError(f"ssd_scan backward: the forward's scratch states "
                         f"{tuple(states.shape)}, decay {tuple(decay.shape)}, cbt "
                         f"{tuple(cbt.shape)} do not fit these inputs")


def backward_plan(xdt: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  n_rep: int, states: torch.Tensor, decay: torch.Tensor, cbt: torch.Tensor,
                  y: torch.Tensor, dy: torch.Tensor) -> BackwardPlan:
    """Check the inputs and allocate the gradients and the scratch; launch
    nothing.  ``states``, ``decay``, ``cbt`` and ``y`` are a forward
    :class:`Plan`'s after its launches (the states entering each chunk past
    the first, and the output), from the same xdt, dtA, B and C; dy (BH,
    L, P) float32."""
    _check(xdt, dtA, B, C, n_rep)
    if not (y.is_cuda and dy.is_cuda):
        raise ValueError("ssd_scan backward takes y and dy on the card")
    lib = _lib()
    Q = lib.ssd_scan_chunk()
    check_backward_inputs(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy, Q)
    BH, L, P = xdt.shape
    BG, N = B.shape[0], B.shape[2]
    nc = n_chunks(L, Q)
    xdt, dtA, B, C, y, dy, states, decay, cbt = (
        t.contiguous() for t in (xdt, dtA, B, C, y, dy, states, decay, cbt))
    if any(t.data_ptr() % 16 for t in (xdt, B, C, y, dy, states, cbt)):
        raise ValueError("ssd_scan backward takes 16-byte aligned xdt, B, C, y, dy and scratch")
    dxdt, ddtA, dB, dC, gstates, ddp, rowterm, parts = backward_buffers(
        xdt, B, Q, lib.ssd_bwd_parts(P, N), lib.ssd_bwd_slices(n_rep))
    args = {
        "ssd_bwd_dstate": (dy, dtA, C, gstates, BH, L, P, N, n_rep),
        "ssd_bwd_state_pass": (gstates, decay, states, ddp, BH, L, P, N),
        "ssd_bwd_chunk_dx": (dy, xdt, y, dtA, B, cbt, gstates, dxdt, rowterm, BH, L, P, N,
                             n_rep),
        "ssd_bwd_chunk_dbc": (xdt, dy, dtA, B, C, states, gstates, parts, BG, L, P, N, n_rep),
        "ssd_bwd_dbc_sum": (parts, dB, dC, BG, L, N, n_rep),
        "ssd_bwd_ddtA": (rowterm, ddp, ddtA, BH, L, P, N),
    }
    names = BACKWARD_PASSES if nc > 1 else BACKWARD_PASSES[2:]
    return BackwardPlan(dxdt, ddtA, dB, dC, gstates, ddp, rowterm, parts,
                        _launchers(lib, xdt.device, args, names))


def ssd_scan_bwd_cuda(xdt: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, n_rep: int, states: torch.Tensor,
                      decay: torch.Tensor, cbt: torch.Tensor, y: torch.Tensor,
                      dy: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the current stream: (dxdt, ddtA, dB,
    dC), dB and dC summed over each group's heads.  Does not
    synchronise."""
    call = backward_plan(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy)
    for _, launch in call.passes:
        launch()
    return call.dxdt, call.ddtA, call.dB, call.dC
