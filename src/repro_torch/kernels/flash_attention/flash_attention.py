"""ctypes binding of the Hopper flash_attention kernels
(``csrc/flash_attention.cu``).  The forward replaces
``src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel``;
the backward replaces no TPU kernel (the reference differentiates its
plain attention) and exists so that training through the forward kernel
has a gradient on the card.

Forward: one block per (64-row query tile, query head, batch), K/V tiles
of 64 keys, the online-softmax state in float32 registers, key tiles that
the causal or window mask covers wholly never visited.  Head dims 16, 64,
96, 128 and 256 (:data:`HEAD_DIMS`: the smoke configs take 16,
granite-3-2b 64, phi3-mini-3.8b 96, as MLA will once ported, its v padded
to its qk head dim of 96; gemma3-12b 256); any other raises.  bf16 runs on
the tensor cores: one warpgroup per block (two at D = 256, each with its
own 64 rows of a 128-row query tile), S = Q K^T and O += P V as ``wgmma``
products (P from registers, rounded to bf16 only there), K and V through
a two-stage ring of ``cp.async`` copies.  Its bound is the operations, at
989 TFLOP/s.  Not done yet: warp specialisation, a persistent grid, fp8.
float32 runs on the CUDA cores, as first ported, to keep its 2e-5
agreement with the plain version.  With ``return_lse`` the forward also
writes each row's float32 log-sum-exp, which the backward reads.

Backward (:func:`flash_attention_bwd_cuda`), three launches in order:
``flash_bwd_preprocess`` (delta = rowsum(dO o O)), then dK/dV (a block
owns a 64-key tile of one KV head and loops over its group's query heads
and their query tiles) and dQ (a block owns a 64-row query tile and loops
over the key tiles it sees): no atomics, the same bits every run.  bf16
runs on the tensor cores (``flash_bwd_dkdv_bf16``, ``flash_bwd_dq_bf16``):
one warpgroup a block (two for dK/dV at D = 256, each half of D),
S^T = K Q^T and dP^T = V dO^T as ``wgmma`` products so that P^T and dS^T
land in the A-operand layout of dV += P^T dO and dK += dS^T Q, both
rounded to bf16 only there (``ref.flash_attention_bwd_ref(...,
round_to_bf16=True)`` is that arithmetic in plain torch), Q/dO or K/V
tiles through a two-stage ``cp.async`` ring.  float32 runs on the CUDA
cores (``flash_bwd_dkdv``, ``flash_bwd_dq``).  The bound is 5 products at
989 TFLOP/s; the kernels compute 7 (S and dP in both passes).  See the
source's header.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims ``csrc/flash_attention.cu`` instantiates, in both dtypes
HEAD_DIMS = (16, 64, 96, 128, 256)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(q, k, v, window):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    check_inputs(q, k, v, window)


def check_inputs(q, k, v, window):
    """The launch's checks that need no device: dtypes, shapes, a compiled
    head dim, the window (the fake versions in ``ops.py`` take them too)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes bf16 or float32 q, k, v of "
                        f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hk < 1 or Hq % Hk:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.flash_attention_error_string(err).decode())


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         q_offset: int = 0, sm_scale: float | None = None,
                         return_lse: bool = False):
    """Launch the kernel on the current stream: o (B, Hq, Sq, D) in q's
    dtype, and with ``return_lse`` also (o, lse) with lse (B, Hq, Sq)
    float32, each row's log-sum-exp of its scaled scores (-inf where no key
    is valid).  Does not synchronise."""
    _check(q, k, v, window)
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: bf16 q, k, v must start at a "
                         "16-byte boundary (the kernel copies 16 bytes at a time)")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hk, Sq, Sk, D, _DTYPES[q.dtype], int(causal),
            int(window is not None), int(window or 0), int(q_offset),
            float(sm_scale), lse.data_ptr() if return_lse else None, stream)
    _raise_on(lib, err, "flash_attention")
    return (out, lse) if return_lse else out


#: the backward's launches in order, with their bit in the C entry's mask
BACKWARD_PASSES = (("flash_bwd_preprocess", 1), ("flash_bwd_dkdv", 2), ("flash_bwd_dq", 4))


@dataclasses.dataclass
class BackwardPlan:
    """A backward call's gradients, its delta scratch (B, Hq, Sq) float32,
    and its launches in order (``passes``: (name, launch)), which hand
    delta on from the first to the other two."""
    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    delta: torch.Tensor
    passes: list[tuple[str, Callable[[], None]]]


def backward_plan(q, k, v, o, lse, do, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0, sm_scale: float | None = None) -> BackwardPlan:
    """Check the inputs and allocate the gradients and the scratch; launch
    nothing.  ``o`` and ``lse`` are the forward's
    (:func:`flash_attention_cuda` with ``return_lse``), ``do`` the
    output's gradient."""
    _check(q, k, v, window)
    B, Hq, Sq, D = q.shape
    _, Hk, Sk, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do {tuple(do.shape)} "
                         f"must be q's shape and dtype {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, Hq, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if sm_scale is None:
        sm_scale = D ** -0.5
    q, k, v, o, lse = (t.contiguous() for t in (q, k, v, o, lse))
    do = do.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()

    def launch(bits: int) -> None:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), B, Hq, Hk, Sq, Sk, D, _DTYPES[q.dtype], int(causal),
                int(window is not None), int(window or 0), int(q_offset),
                float(sm_scale), bits, stream)
        _raise_on(lib, err, "flash_attention backward")

    return BackwardPlan(dq, dk, dv, delta,
                        [(name, lambda bits=bits: launch(bits))
                         for name, bits in BACKWARD_PASSES])


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int | None = None, q_offset: int = 0,
                             sm_scale: float | None = None):
    """Launch the three backward kernels on the current stream: (dq, dk,
    dv) in q's dtype, shaped as q, k and v (see :func:`backward_plan`).
    Does not synchronise."""
    call = backward_plan(q, k, v, o, lse, do, causal=causal, window=window,
                         q_offset=q_offset, sm_scale=sm_scale)
    for _, launch in call.passes:
        launch()
    return call.dq, call.dk, call.dv
