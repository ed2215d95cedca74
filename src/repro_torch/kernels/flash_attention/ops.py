"""Public wrapper of flash_attention: a port of
``src/repro/kernels/flash_attention/ops.py::flash_attention``.

A tensor on the CPU takes the plain torch version, picked by the
reference's own threshold (``ops.py:14, 39``): the dense form up to
512 x 512 score elements per (batch, head), the chunked online-softmax
form above.  A CUDA tensor launches the hand-written Hopper kernel
(``csrc/flash_attention.cu``) or raises: a head dim between its compiled
instances is zero-padded to the next one (the output sliced back), and
one above the largest raises.
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
    from repro_torch.kernels.flash_attention.flash_attention import (HEAD_DIMS,
                                                                     flash_attention_cuda)

    out = pad_head_dim(flash_attention_cuda, q, k, v,
                       padded_head_dim(q.shape[-1], HEAD_DIMS), sm_scale,
                       causal=causal, window=window, q_offset=q_offset)
    LAUNCHES += 1
    return out


def padded_head_dim(D: int, instances) -> int:
    """The smallest compiled head dim at least ``D`` (``D`` itself where it
    is one); raises, naming the instances, above the largest."""
    fits = [d for d in instances if d >= D]
    if not fits:
        raise ValueError(f"flash_attention: head dim {D} is above every compiled "
                         f"instance {tuple(instances)}")
    return min(fits)


def pad_head_dim(attend, q, k, v, Dp: int, sm_scale: float | None, **kw):
    """``attend(q, k, v, sm_scale=..., **kw)`` at head dim ``Dp`` >= q's
    D: q, k and v zero-padded on the last axis (zero columns add nothing
    to q.k, and v's give output columns the slice drops), the scale kept at
    D's (``D ** -0.5`` unless the caller gave one)."""
    D = q.shape[-1]
    if Dp == D:
        return attend(q, k, v, sm_scale=sm_scale, **kw)
    q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
    out = attend(q, k, v, sm_scale=D ** -0.5 if sm_scale is None else sm_scale, **kw)
    return out[..., :D].contiguous()
