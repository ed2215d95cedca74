"""Public wrapper of flash_attention: a port of
``src/repro/kernels/flash_attention/ops.py::flash_attention``.

A tensor on the CPU takes the plain torch version, picked by the
reference's own threshold (``ops.py:14, 39``): the dense form up to
512 x 512 score elements per (batch, head), the chunked online-softmax
form above; autograd differentiates it there.  A CUDA tensor launches the
hand-written Hopper kernel (``csrc/flash_attention.cu``) or raises: a head
dim between its compiled instances is zero-padded to the next one (the
output sliced back; autograd goes through the pad and the slice), and one
above the largest raises.  When grad is enabled and q, k or v requires it,
the launch goes through :class:`FlashAttention`, whose backward launches
the backward kernels or raises: it never falls back to the plain version.

The launches are the operators ``repro_torch::flash_attention_fwd`` and
``repro_torch::flash_attention_bwd``, each with a fake version that
returns what its launch returns (shapes, dtypes and strides: o and lse;
dq, dk and dv) without the library, and a flop formula
(``launch/roofline.py``'s counts).  A ``meta`` tensor takes the card's
path up to the launch, where the fake stands in for the kernel: the dry
run (:mod:`repro_torch.launch.dryrun`) traces the card's path that way.
Any other device raises.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.ref import (flash_attention_chunked,
                                                     flash_attention_ref)
from repro_torch.launch.roofline import flash_bwd_ops, flash_ops

# above this many score elements per (batch, head), the plain version is
# the chunked online-softmax form
_CHUNKED_THRESHOLD = 512 * 512

#: forward kernel launches made by :func:`flash_attention` (a plain count,
#: read by ``chip_smoke.py`` to show the serving and training paths went
#: through the kernel)
LAUNCHES = 0
#: backward launches (each the three backward kernels) made by
#: :class:`FlashAttention`'s backward
BACKWARD_LAUNCHES = 0


#: the launches' operators: a ``torch.library`` fragment (schema, CUDA
#: kernel, fake, flop formula), whose call costs the host less than a
#: ``torch.library.custom_op``'s (no Python autograd layer)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, int? window, "
            "int q_offset, float? sm_scale, bool return_lse) -> (Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
            "Tensor do, bool causal, int? window, int q_offset, float? sm_scale) "
            "-> (Tensor, Tensor, Tensor)")


def _fwd(q, k, v, causal, window, q_offset, sm_scale, return_lse):
    """The forward kernel's launch: (o, lse), lse empty without
    ``return_lse``."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

    out = flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               sm_scale=sm_scale, return_lse=return_lse)
    return out if return_lse else (out, q.new_empty((0,), dtype=torch.float32))


_LIB.impl("flash_attention_fwd", _fwd, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_fwd", lib=_LIB)
def _fwd_fake(q, k, v, causal, window, q_offset, sm_scale, return_lse):
    from repro_torch.kernels.flash_attention.flash_attention import check_inputs

    check_inputs(q, k, v, window)
    B, Hq, Sq, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((B, Hq, Sq) if return_lse else (0,), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q, k, v, causal, window, q_offset, *args, **kwargs) -> int:
    B, Hq, Sq, D = q
    return flash_ops(B, Hq, Sq, k[2], D, causal, window, q_offset)


def _bwd(q, k, v, o, lse, do, causal, window, q_offset, sm_scale):
    """The three backward kernels' launches: (dq, dk, dv); their delta
    scratch (B, Hq, Sq) float32 lives and dies inside."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bwd_cuda

    return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window,
                                    q_offset=q_offset, sm_scale=sm_scale)


_LIB.impl("flash_attention_bwd", _bwd, "CUDA")


@torch.library.register_fake("repro_torch::flash_attention_bwd", lib=_LIB)
def _bwd_fake(q, k, v, o, lse, do, causal, window, q_offset, sm_scale):
    from repro_torch.kernels.flash_attention.flash_attention import check_inputs

    check_inputs(q, k, v, window)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, v, o, lse, do, causal, window, q_offset, *args, **kwargs) -> int:
    B, Hq, Sq, D = q
    return flash_bwd_ops(B, Hq, Sq, k[2], D, causal, window, q_offset)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting at a 16-byte boundary (the bf16
    forward copies 16 bytes at a time): a copy where it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp kept, and the backward
    kernels as its gradient (CUDA tensors, or their fakes on ``meta``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, sm_scale):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, window,
                                                             q_offset, sm_scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = (causal, window, q_offset, sm_scale)
        return out

    @staticmethod
    def backward(ctx, do):
        global BACKWARD_LAUNCHES
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, do,
                                                               *ctx.kw)
        if q.is_cuda:
            BACKWARD_LAUNCHES += 1
        return dq, dk, dv, None, None, None, None


def _flash_fn(q, k, v, *, sm_scale, causal, window, q_offset):
    return FlashAttention.apply(q, k, v, causal, window, q_offset, sm_scale)


def _forward(q, k, v, *, sm_scale, causal, window, q_offset):
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, window, q_offset,
                                                     sm_scale, False)[0]


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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

    differentiable = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    out = pad_head_dim(_flash_fn if differentiable else _forward, q, k, v,
                       padded_head_dim(q.shape[-1], HEAD_DIMS), sm_scale,
                       causal=causal, window=window, q_offset=q_offset)
    if q.is_cuda:
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
