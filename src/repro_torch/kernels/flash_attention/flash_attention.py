"""ctypes binding of the Hopper flash_attention kernel
(``csrc/flash_attention.cu``), which replaces
``src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel``.

One block per (64-row query tile, query head, batch), K/V tiles of 64
keys, the online-softmax state in float32 registers, key tiles that the
causal or window mask covers wholly never visited.  Head dims 16, 64, 96,
128 and 256 (:data:`HEAD_DIMS`: the smoke configs take 16, granite-3-2b
64, phi3-mini-3.8b 96, as MLA will once ported, its v padded to its qk
head dim of 96; gemma3-12b 256); any other raises.

bf16 runs on the tensor cores: one warpgroup per block (two at D = 256,
each with its own 64 rows of a 128-row query tile), S = Q K^T and
O += P V as ``wgmma`` products (P from registers, rounded to bf16 only
there), K and V through a two-stage ring of ``cp.async`` copies.  Its bound
is the operations, at 989 TFLOP/s.  Not done yet: warp specialisation, a
persistent grid, fp8.  float32 runs on the CUDA cores, as first ported, to
keep its 2e-5 agreement with the plain version.  See the source's header
for the design.
"""
from __future__ import annotations

import ctypes

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
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         q_offset: int = 0,
                         sm_scale: float | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream: o (B, Hq, Sq, D) in q's
    dtype.  Does not synchronise."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
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
    if sm_scale is None:
        sm_scale = D ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: bf16 q, k, v must start at a "
                         "16-byte boundary (the kernel copies 16 bytes at a time)")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hk, Sq, Sk, D, _DTYPES[q.dtype], int(causal),
            int(window is not None), int(window or 0), int(q_offset),
            float(sm_scale), stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    return out
