"""Public wrapper of the SSD scan: a port of
``src/repro/kernels/ssd_scan/ops.py`` (``ssd_scan`` with its pre-fusion
of dt into x and A and its model-to-kernel layout reshapes, ``:32-35, 49``;
``ssd_decode_step``, ``:52-68``, plain torch).

A tensor on the CPU takes the plain torch version (the chunked form above
64 steps, the per-step recurrence below, as the reference picks off the
TPU), which autograd differentiates; a CUDA tensor launches the
hand-written Hopper kernels (``csrc/ssd_scan.cu``) or raises.  When grad
is enabled and an input requires it, the launch goes through
:class:`SSDScan`, whose backward launches the backward kernels or raises:
it never falls back to the plain version.  The pre-fusion of dt into x and
A and the layout reshapes stay outside it, so autograd carries x, dt, A, B
and C through them.

The launches are the operators ``repro_torch::ssd_scan_fwd`` (y and the
forward's scratch, which the backward reads) and
``repro_torch::ssd_scan_bwd`` (the four gradients), each with a fake
version that returns what its launches return (shapes, dtypes and
strides, from the binding's Python copies of the library's sizes)
without the library, and a flop formula (``launch/roofline.py``'s counts
at the kernels' chunk).  A ``meta`` tensor takes the card's path up to
the launch, where the fake stands in for the kernels: the dry run traces
the card's path that way.  Any other device raises.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked, ssd_scan_ref
from repro_torch.launch.roofline import ssd_bwd_kernel_ops, ssd_ops_needed

#: calls of :func:`ssd_scan` that launched the CUDA kernels (a plain count,
#: read by ``chip_smoke.py`` to show the serving and training paths went
#: through them)
LAUNCHES = 0
#: backward calls (each the backward kernels) made by :class:`SSDScan`
BACKWARD_LAUNCHES = 0


#: the launches' operators: a ``torch.library`` fragment (schema, CUDA
#: kernel, fake, flop formula), as flash_attention's
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan_fwd(Tensor xdt, Tensor dtA, Tensor B, Tensor C, int n_rep) "
            "-> (Tensor, Tensor, Tensor, Tensor)")
_LIB.define("ssd_scan_bwd(Tensor xdt, Tensor dtA, Tensor B, Tensor C, int n_rep, "
            "Tensor states, Tensor decay, Tensor cbt, Tensor y, Tensor dy) "
            "-> (Tensor, Tensor, Tensor, Tensor)")


def _fwd(xdt, dtA, B, C, n_rep):
    """The four forward kernels' launches: (y, cbt, states, decay), the
    output and the scratch the backward reads (:class:`ssd_scan.Plan`)."""
    from repro_torch.kernels.ssd_scan.ssd_scan import plan

    call = plan(xdt, dtA, B, C, n_rep)
    for _, launch in call.passes:
        launch()
    return call.y, call.cbt, call.states, call.decay


_LIB.impl("ssd_scan_fwd", _fwd, "CUDA")


@torch.library.register_fake("repro_torch::ssd_scan_fwd", lib=_LIB)
def _fwd_fake(xdt, dtA, B, C, n_rep):
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK, check_inputs, forward_buffers

    check_inputs(xdt, dtA, B, C, n_rep)
    return forward_buffers(xdt, B, CHUNK)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _fwd_flops(xdt, dtA, B, C, n_rep, *args, **kwargs) -> int:
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK

    BH, L, P = xdt
    return ssd_ops_needed(BH, B[0], L, P, B[2], CHUNK)


def _bwd(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy):
    """The backward kernels' launches: (dxdt, ddtA, dB, dC); their scratch
    (:class:`ssd_scan.BackwardPlan`'s gstates, ddp, rowterm and parts)
    lives and dies inside."""
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_bwd_cuda

    return ssd_scan_bwd_cuda(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy)


_LIB.impl("ssd_scan_bwd", _bwd, "CUDA")


@torch.library.register_fake("repro_torch::ssd_scan_bwd", lib=_LIB)
def _bwd_fake(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy):
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK, check_backward_inputs

    check_backward_inputs(xdt, dtA, B, C, n_rep, states, decay, cbt, y, dy, CHUNK)
    return fake_backward_buffers(xdt, B, n_rep)[:4]


def fake_backward_buffers(xdt, B, n_rep: int) -> tuple:
    """What the backward's launches allocate, gradients and scratch
    (``ssd_scan.backward_buffers``), on xdt's device at the Python copies
    of the library's sizes: the fake's outputs, and the scratch the dry run
    counts while the launch runs."""
    from repro_torch.kernels.ssd_scan.ssd_scan import (CHUNK, backward_buffers, bwd_parts,
                                                       bwd_slices)

    return backward_buffers(xdt, B, CHUNK, bwd_parts(xdt.shape[2], B.shape[2]),
                            bwd_slices(n_rep))


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _bwd_flops(xdt, dtA, B, C, n_rep, *args, **kwargs) -> int:
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNK, bwd_slices

    BH, L, P = xdt
    return ssd_bwd_kernel_ops(BH, B[0], L, P, B[2], CHUNK, bwd_slices(n_rep))


class SSDScan(torch.autograd.Function):
    """The forward kernels on the kernel layout (xdt, dtA, B, C), their
    scratch and output y kept for the backward kernels (CUDA tensors, or
    their fakes on ``meta``; ddtA's row terms are dy . y - xdt . dxdt).
    Everything is saved with ``save_for_backward``, so a non-reentrant
    checkpoint drops it and recomputes it."""

    @staticmethod
    def forward(ctx, xdt, dtA, B, C, n_rep):
        xdt, dtA, B, C = (t.contiguous() for t in (xdt, dtA, B, C))
        y, cbt, states, decay = torch.ops.repro_torch.ssd_scan_fwd(xdt, dtA, B, C, n_rep)
        ctx.save_for_backward(xdt, dtA, B, C, states, decay, cbt, y)
        ctx.n_rep = n_rep
        return y

    @staticmethod
    def backward(ctx, dy):
        global BACKWARD_LAUNCHES
        xdt, dtA, B, C, states, decay, cbt, y = ctx.saved_tensors
        grads = torch.ops.repro_torch.ssd_scan_bwd(xdt, dtA, B, C, ctx.n_rep, states, decay,
                                                   cbt, y, dy.contiguous())
        if xdt.is_cuda:
            BACKWARD_LAUNCHES += 1
        return (*grads, None)


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """Mamba-2 SSD selective scan.

    x: (B, L, H, P); dt: (B, L, H) positive step sizes; A: (H,) negative
    decay rates; B, C: (B, L, G, N), each group shared by H // G heads.
    Returns y (B, L, H, P).  ``chunk`` is the plain chunked form's chunk;
    the kernels take their own (the function is the same up to rounding)."""
    global LAUNCHES
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
    Bb, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    n_rep = H // G
    xdt = (x * dt[..., None]).transpose(1, 2).reshape(Bb * H, L, P)
    dtA = (dt * A[None, None, :]).transpose(1, 2).reshape(Bb * H, L)
    Bk = B.transpose(1, 2).reshape(Bb * G, L, N)
    Ck = C.transpose(1, 2).reshape(Bb * G, L, N)
    if x.device.type == "cpu":
        if L > 64:
            y = ssd_scan_chunked(xdt, dtA, Bk, Ck, n_rep, chunk=chunk)
        else:
            y = ssd_scan_ref(xdt, dtA, Bk, Ck, n_rep)
    else:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
            y = SSDScan.apply(xdt, dtA, Bk, Ck, n_rep)
        else:
            y = torch.ops.repro_torch.ssd_scan_fwd(xdt, dtA, Bk, Ck, n_rep)[0]
        if x.is_cuda:
            LAUNCHES += 1
    return y.reshape(Bb, H, L, P).transpose(1, 2)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token SSD update for serving.

    state: (B, H, N, P); x_t: (B, H, P); dt_t: (B, H); A: (H,);
    B_t, C_t: (B, G, N).  Returns (new_state, y_t (B, H, P))."""
    H = state.shape[1]
    n_rep = H // B_t.shape[1]
    Bx = B_t.repeat_interleave(n_rep, dim=1)
    Cx = C_t.repeat_interleave(n_rep, dim=1)
    decay = torch.exp(A[None, :] * dt_t)
    xdt = x_t * dt_t[..., None]
    new_state = decay[..., None, None] * state + Bx[..., :, None] * xdt[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", Cx, new_state)
    return new_state, y
