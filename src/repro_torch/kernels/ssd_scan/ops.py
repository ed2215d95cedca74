"""Public wrapper of the SSD scan: a port of
``src/repro/kernels/ssd_scan/ops.py`` (``ssd_scan`` with its pre-fusion
of dt into x and A and its model-to-kernel layout reshapes, ``:32-35, 49``;
``ssd_decode_step``, ``:52-68``, plain torch).

A tensor on the CPU takes the plain torch version (the chunked form above
64 steps, the per-step recurrence below, as the reference picks off the
TPU), which autograd differentiates; a CUDA tensor launches the
hand-written Hopper kernels (``csrc/ssd_scan.cu``) or raises.  The kernels
have no backward yet: on a CUDA tensor that requires grad (grad enabled)
:func:`ssd_scan` raises ``NotImplementedError`` naming ROADMAP A16.2
rather than return a result with no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked, ssd_scan_ref

#: calls of :func:`ssd_scan` that launched the CUDA kernels (a plain count,
#: read by ``chip_smoke.py`` to show the serving path went through them)
LAUNCHES = 0


def ssd_scan(x, dt, A, B, C, chunk: int = 128):
    """Mamba-2 SSD selective scan.

    x: (B, L, H, P); dt: (B, L, H) positive step sizes; A: (H,) negative
    decay rates; B, C: (B, L, G, N), each group shared by H // G heads.
    Returns y (B, L, H, P).  ``chunk`` is the plain chunked form's chunk;
    the kernels take their own (the function is the same up to rounding)."""
    global LAUNCHES
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
    elif x.device.type == "cuda":
        from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda

        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C)):
            raise NotImplementedError(
                "ssd_scan's backward kernels are not ported yet (Mamba-2 training "
                "on the card): ROADMAP A16.2")

        y = ssd_scan_cuda(xdt, dtA, Bk, Ck, n_rep)
        LAUNCHES += 1
    else:
        raise ValueError(f"ssd_scan: no kernel for {x.device}")
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
