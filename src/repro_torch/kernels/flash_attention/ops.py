"""Public wrapper of flash_attention: a port of
``src/repro/kernels/flash_attention/ops.py::flash_attention``.

A tensor on the CPU takes the plain torch version, picked by the
reference's own threshold (``ops.py:14, 39``): the dense form up to
512 x 512 score elements per (batch, head), the chunked online-softmax
form above.  A CUDA tensor launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import (flash_attention_chunked,
                                                     flash_attention_ref)

# above this many score elements per (batch, head), the plain version is
# the chunked online-softmax form
_CHUNKED_THRESHOLD = 512 * 512

#: kernel launches made by :func:`flash_attention` (a plain count, read by
#: ``chip_smoke.py`` to show the serving path went through the kernel)
LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, sm_scale: float | None = None,
                    bk: int = 128) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hk, Sk, D): causal,
    sliding-window (``kpos > qpos - window``), GQA and ``q_offset``."""
    global LAUNCHES
    if q.device.type == "cpu":
        if q.shape[2] * k.shape[2] > _CHUNKED_THRESHOLD:
            return flash_attention_chunked(q, k, v, causal=causal, window=window,
                                           q_offset=q_offset, sm_scale=sm_scale,
                                           bk=max(bk, 512))
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, sm_scale=sm_scale)
    LAUNCHES += 1
    return out
